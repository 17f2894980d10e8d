"""The mLSTM backward's ``wgmma`` route, its algorithm on the CPU.

``ref.mlstm_chunkwise_bwd_split_ref`` is what the card's ``wgmma``
backward kernels compute: the forward's gate and state passes (C_k split
hi + lo), Y = dh C_k^T with its row dots q . Y, the chunk's own products S
and W with the per-step factors, G and Sd / Dv split hi + lo, the reverse
walk of the state's gradient G_k (handed over split hi + lo), dq / dk / dv
with the f32 row and column sums, and the gates' gradients.  Here it is
held, fed the same numpy inputs, against ``jax.vjp`` of the reference's
XLA chunkwise mLSTM (``repro.backends.xla_backend.mlstm_chunkwise``) and
against the closed form ``ref.mlstm_chunkwise_bwd_ref``: chunks of 128
(the route's), S a multiple of 128 and ragged, the gradient of h alone and
with the final (C, n)'s, and inputs where some rows take den's lower
branch.

Limits, each gradient's largest error over its largest entry:
- f32 inputs, ``LIMIT_F32`` = 5e-5 for all five: the only roundings are
  the hi + lo splits of the f32 sides (~16 mantissa bits, 2^-17 ~ 7.6e-6
  each), which read up to ~1.2e-5 here; the sides sum the same f32 terms
  in other orders besides (~3e-6).
- bf16 inputs, ``LIMIT_BF16`` = 4e-3 for dq, dk, dv: they are returned in
  bf16, whose rounding alone is up to 2^-9 ~ 2e-3 of the largest entry;
  the gates' gradients, returned in f32, at ``LIMIT_F32``.
Each planted fault of the kernels' controls (``ref.BWD_PLANT_*``) moves
some gradient past the card's limit (``MLSTM_BWD_LIMIT`` of
``chip_smoke.py``, 1e-2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backends import xla_backend
from repro_torch.kernels import ref

LIMIT_F32 = 5e-5
LIMIT_BF16 = 4e-3
#: chip_smoke.py's MLSTM_BWD_LIMIT.
CARD_LIMIT = 1e-2
CHUNK = 128
#: (B, H, S, D): S a multiple of the chunk (3 chunks) and ragged.
SHAPES = [(2, 2, 384, 64), (1, 2, 300, 64)]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _inputs(b, h, s, d, seed, *, low=False):
    """q, k, v, dh normals (q and k times 0.7 with ``low``: |den| < 1 in
    some rows); the model's forget gates (log_sigmoid(N + 2)); input gates
    N / 2; dC, dn normals; all float32 numpy."""
    rng = np.random.RandomState(seed)
    shrink = 0.7 if low else 1.0
    q, k = (rng.randn(b, h, s, d).astype(np.float32) * shrink
            for _ in range(2))
    v, dh = (rng.randn(b, h, s, d).astype(np.float32) for _ in range(2))
    lf = -np.logaddexp(0.0, -(rng.randn(b, h, s) + 2.0)).astype(np.float32)
    li = (rng.randn(b, h, s) * 0.5).astype(np.float32)
    dc = rng.randn(b, h, d, d).astype(np.float32)
    dn = rng.randn(b, h, d).astype(np.float32)
    return [q, k, v, lf, li, dh], dc, dn


def _torch_args(arrays, dt):
    """q, k, v, dh in ``dt``, the gates in f32; and the same values as
    f32 numpy (what JAX is fed: bf16 values are exact in f32)."""
    out = [torch.from_numpy(x) for x in arrays]
    for i in (0, 1, 2, 5):
        out[i] = out[i].to(dt)
    return out, [t.float().numpy() for t in out]


def _errors(got, want):
    """Per gradient, max |err| / max |want|."""
    out = []
    for g, w in zip(got, want):
        w = torch.as_tensor(np.array(w, np.float32))
        out.append(float((g.float() - w).abs().max() / w.abs().max()))
    return out


def _limits(dt):
    first = LIMIT_F32 if dt == torch.float32 else LIMIT_BF16
    return [first] * 3 + [LIMIT_F32] * 2


def _split(args, dc, dn, plant=0):
    state = (torch.from_numpy(dc), torch.from_numpy(dn)) \
        if dc is not None else (None, None)
    return ref.mlstm_chunkwise_bwd_split_ref(*args, *state, chunk=CHUNK,
                                             plant=plant)


def _jax_vjp(arrays, dc, dn):
    q, k, v, lf, li, dh = arrays
    b, h, _, d = q.shape

    def fn(*xs):
        out, (c, n, m) = xla_backend.mlstm_chunkwise(
            *xs, chunk=CHUNK, return_state=True)
        return out, c, n, m
    _, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v, lf, li)))
    return vjp((jnp.asarray(dh),
                jnp.asarray(dc if dc is not None
                            else np.zeros((b, h, d, d), np.float32)),
                jnp.asarray(dn if dn is not None
                            else np.zeros((b, h, d), np.float32)),
                jnp.zeros((b, h), jnp.float32)))


@pytest.mark.parametrize("state", [False, True], ids=["dh", "dh+dC+dn"])
@pytest.mark.parametrize("b,h,s,d", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_split_matches_jax_vjp(dtype, b, h, s, d, state):
    dt = DTYPES[dtype]
    arrays, dc, dn = _inputs(b, h, s, d, s + d + len(dtype))
    if not state:
        dc = dn = None
    args, exact = _torch_args(arrays, dt)
    got = _split(args, dc, dn)
    assert [g.dtype for g in got] == [dt] * 3 + [torch.float32] * 2
    assert [tuple(g.shape) for g in got] == [(b, h, s, d)] * 3 + [(b, h, s)] * 2
    errs = _errors(got, _jax_vjp(exact, dc, dn))
    assert all(e <= lim for e, lim in zip(errs, _limits(dt))), errs


@pytest.mark.parametrize("state", [False, True], ids=["dh", "dh+dC+dn"])
@pytest.mark.parametrize("b,h,s,d", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_split_matches_closed_form(dtype, b, h, s, d, state):
    """The card's plain version, the closed form over the whole (S, S)
    matrix, fed the same tensors."""
    dt = DTYPES[dtype]
    arrays, dc, dn = _inputs(b, h, s, d, 3 * s + d + len(dtype))
    if not state:
        dc = dn = None
    args, _ = _torch_args(arrays, dt)
    st = (torch.from_numpy(dc), torch.from_numpy(dn)) if state \
        else (None, None)
    want = ref.mlstm_chunkwise_bwd_ref(*args, *st, chunk=CHUNK)
    errs = _errors(_split(args, dc, dn), [w.float().numpy() for w in want])
    assert all(e <= lim for e, lim in zip(errs, _limits(dt))), errs


@pytest.mark.parametrize("state", [False, True], ids=["dh", "dh+dC+dn"])
def test_split_lower_branch(state):
    """Rows with |den| < 1 (h = num) beside rows above it, in bf16: the
    split route gives them no dden, as JAX's maximum does."""
    b, h, s, d = 1, 2, 300, 64
    arrays, dc, dn = _inputs(b, h, s, d, 11, low=True)
    args, exact = _torch_args(arrays, torch.bfloat16)
    q, k, _, lf, li, _ = (torch.from_numpy(x) for x in exact)
    fc = lf.cumsum(-1)
    causal = torch.ones((s, s), dtype=torch.bool).tril()
    weights = torch.where(causal, torch.exp(fc[..., :, None] - fc[..., None, :]
                                            + li[..., None, :]), 0.0)
    den = (weights * (q @ k.transpose(-1, -2)) * d ** -0.5).sum(-1)
    low = den.abs() < 1
    assert 0 < int(low.sum()) < low.numel()
    if not state:
        dc = dn = None
    errs = _errors(_split(args, dc, dn), _jax_vjp(exact, dc, dn))
    assert all(e <= lim for e, lim in zip(errs, _limits(torch.bfloat16))), \
        errs


@pytest.mark.parametrize("plant", [ref.BWD_PLANT_RESET,
                                   ref.BWD_PLANT_DQ_INTER,
                                   ref.BWD_PLANT_SHIFT],
                         ids=["reset", "dq-inter", "shift"])
def test_planted_faults_move_a_gradient_past_the_card_limit(plant):
    """The kernels' controls in the plain version: the state gradient
    reset at chunk nc // 2, dq's inter-chunk terms dropped, dlog_f's
    reverse cumsum one step short; each moves some gradient past the
    card's limit at 3 chunks of bf16, with the gradient of h alone (the
    trainer's call)."""
    arrays, _, _ = _inputs(2, 2, 384, 64, 21)
    args, _ = _torch_args(arrays, torch.bfloat16)
    want = _split(args, None, None)
    bad = _split(args, None, None, plant)
    assert max(_errors(bad, [w.float().numpy() for w in want])) > CARD_LIMIT
