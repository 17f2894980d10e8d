"""The mLSTM backward's closed form (``ref.mlstm_chunkwise_bwd_ref``, the
``mlstm_chunkwise_bwd`` kernel's plain version) on the CPU in float32.

It is held against autograd of the plain forward
(``ref.mlstm_chunkwise_ref``) and against ``jax.vjp`` of the reference's
XLA chunkwise mLSTM (``repro.backends.xla_backend.mlstm_chunkwise``), fed
the same numpy inputs: S a multiple of the chunk and ragged, the gradient
of h alone and with the final (C, n)'s, head dims 16 and 64, and inputs
where the denominator's lower branch (|den| < 1, h = num) is taken in some
rows.  Tolerance: every output within 2e-5 of its largest entry; the two
sides sum the same f32 terms in other orders (the closed form over the
whole (S, S) matrix, the others chunk by chunk through the state), which
moves them by up to ~3e-6 here.  Also: ``ops.mlstm_chunkwise`` with grad
mode on goes through ``autograd.MlstmChunkwise`` and calls the backward
wrapper once, with the gradients autograd of the plain forward gives, bit
for bit; and the backward's operation count (its bound's) at the training
shape.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backends import xla_backend
from repro_torch.kernels import autograd as kautograd
from repro_torch.kernels import mlstm as kmlstm
from repro_torch.kernels import ops, ref

LIMIT = 2e-5
#: (B, H, S, D, chunk): a multiple of the chunk and ragged S.
CASES = [(2, 2, 48, 16, 16), (2, 2, 64, 64, 16), (2, 2, 50, 16, 16),
         (1, 3, 37, 16, 8)]


def _inputs(b, h, s, d, seed, *, low=False):
    """q, k, v, dh normals (q and k times 0.7 with ``low``, which puts
    |den| < 1 in about 60 % of the rows against a third at 1.0); the
    model's forget gates (log_sigmoid(N + 2)); input gates N / 2; dC, dn
    normals."""
    rng = np.random.RandomState(seed)
    shrink = 0.7 if low else 1.0
    q, k = (rng.randn(b, h, s, d).astype(np.float32) * shrink
            for _ in range(2))
    v, dh = (rng.randn(b, h, s, d).astype(np.float32) for _ in range(2))
    lf = -np.logaddexp(0.0, -(rng.randn(b, h, s) + 2.0)).astype(np.float32)
    li = (rng.randn(b, h, s) * 0.5).astype(np.float32)
    dc = rng.randn(b, h, d, d).astype(np.float32)
    dn = rng.randn(b, h, d).astype(np.float32)
    return (q, k, v, lf, li), dh, dc, dn


def _worst(got, want):
    pairs = [(torch.as_tensor(np.array(g)), torch.as_tensor(np.array(w)))
             for g, w in zip(got, want)]
    return max(float((g - w).abs().max() / w.abs().max()) for g, w in pairs)


def _autograd(ins, dh, dc, dn, chunk):
    live = [torch.from_numpy(x).requires_grad_() for x in ins]
    h, (c, n, _) = ref.mlstm_chunkwise_ref(*live, chunk=chunk,
                                           return_state=True)
    outs, grads = [h], [torch.from_numpy(dh)]
    if dc is not None:
        outs += [c, n]
        grads += [torch.from_numpy(dc), torch.from_numpy(dn)]
    return torch.autograd.grad(outs, live, grads)


def _closed(ins, dh, dc, dn, chunk):
    t = [torch.from_numpy(x) for x in ins]
    state = (torch.from_numpy(dc), torch.from_numpy(dn)) \
        if dc is not None else (None, None)
    return ref.mlstm_chunkwise_bwd_ref(*t, torch.from_numpy(dh), *state,
                                       chunk=chunk)


def _jax_vjp(ins, dh, dc, dn, chunk):
    b, h, _, d = ins[0].shape

    def fn(*xs):
        out, (c, n, m) = xla_backend.mlstm_chunkwise(
            *xs, chunk=chunk, return_state=True)
        return out, c, n, m
    _, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in ins))
    zc = np.zeros((b, h, d, d), np.float32)
    zn = np.zeros((b, h, d), np.float32)
    return vjp((jnp.asarray(dh),
                jnp.asarray(dc if dc is not None else zc),
                jnp.asarray(dn if dn is not None else zn),
                jnp.zeros((b, h), jnp.float32)))


@pytest.mark.parametrize("state", [False, True], ids=["dh", "dh+dC+dn"])
@pytest.mark.parametrize("b,h,s,d,chunk", CASES)
def test_closed_form_matches_autograd_of_plain(b, h, s, d, chunk, state):
    ins, dh, dc, dn = _inputs(b, h, s, d, s + d)
    if not state:
        dc = dn = None
    got = _closed(ins, dh, dc, dn, chunk)
    assert [g.dtype for g in got] == [torch.float32] * 5
    assert _worst(got, _autograd(ins, dh, dc, dn, chunk)) <= LIMIT


@pytest.mark.parametrize("state", [False, True], ids=["dh", "dh+dC+dn"])
@pytest.mark.parametrize("b,h,s,d,chunk", CASES[:3])
def test_closed_form_matches_jax_vjp(b, h, s, d, chunk, state):
    ins, dh, dc, dn = _inputs(b, h, s, d, 7 * s + d)
    if not state:
        dc = dn = None
    got = _closed(ins, dh, dc, dn, chunk)
    assert _worst(got, _jax_vjp(ins, dh, dc, dn, chunk)) <= LIMIT


@pytest.mark.parametrize("state", [False, True], ids=["dh", "dh+dC+dn"])
def test_closed_form_lower_branch(state):
    """Rows with |den| < 1 (h = num) beside rows above it: the closed form
    gives them no dden, as autograd's and JAX's maximum do."""
    b, h, s, d, chunk = 2, 2, 64, 16, 16
    ins, dh, dc, dn = _inputs(b, h, s, d, 11, low=True)
    q, k, _, lf, li = (torch.from_numpy(x) for x in ins)
    fc = lf.cumsum(-1)
    causal = torch.ones((s, s), dtype=torch.bool).tril()
    weights = torch.where(causal, torch.exp(fc[..., :, None] - fc[..., None, :]
                                            + li[..., None, :]), 0.0)
    den = (weights * (q @ k.transpose(-1, -2)) * d ** -0.5).sum(-1)
    low = den.abs() < 1
    assert 0 < int(low.sum()) < low.numel()
    if not state:
        dc = dn = None
    got = _closed(ins, dh, dc, dn, chunk)
    assert _worst(got, _autograd(ins, dh, dc, dn, chunk)) <= LIMIT
    assert _worst(got, _jax_vjp(ins, dh, dc, dn, chunk)) <= LIMIT


def test_ops_gradient_goes_through_mlstm_function(monkeypatch):
    """Grad mode on: ``ops.mlstm_chunkwise`` is ``MlstmChunkwise``, whose
    backward calls ``mlstm_chunkwise_bwd`` once (on the CPU, autograd of
    the plain forward: the gradients equal the plain forward's own)."""
    calls = []
    orig = kmlstm.mlstm_chunkwise_bwd

    def spy(*a, **k):
        calls.append(k["chunk"])
        return orig(*a, **k)
    monkeypatch.setattr(kmlstm, "mlstm_chunkwise_bwd", spy)
    ins, dh, _, _ = _inputs(1, 2, 40, 16, 3)
    live = [torch.from_numpy(x).requires_grad_() for x in ins]
    h = ops.mlstm_chunkwise(*live, chunk=16)
    assert type(h.grad_fn).__name__ == "MlstmChunkwiseBackward"
    got = torch.autograd.grad(h, live, torch.from_numpy(dh))
    assert calls == [16]
    want = _autograd(ins, dh, None, None, 16)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with torch.no_grad():
        assert ops.mlstm_chunkwise(*live, chunk=16).grad_fn is None


def test_backward_entry_takes_the_state_gradients():
    """``autograd.mlstm_chunkwise_backward`` with the gradients of (h, C,
    n, m) on the CPU: autograd of the plain forward, m's included."""
    ins, dh, dc, dn = _inputs(1, 1, 33, 16, 5)
    t = [torch.from_numpy(x) for x in ins]
    dm = torch.ones((1, 1))
    got = kautograd.mlstm_chunkwise_backward(
        t, 16, (torch.from_numpy(dh), torch.from_numpy(dc),
                torch.from_numpy(dn), dm))
    want = ref.mlstm_chunkwise_autograd_ref(
        t, 16, (torch.from_numpy(dh), torch.from_numpy(dc),
                torch.from_numpy(dn), dm))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_bwd_flops_at_the_training_shape():
    """The backward's products at B 4, H 4, S 2048, D 1024, chunk 128
    (``kernels/mlstm.py``): 343.8 GFLOP, 0.348 ms at 989 TFLOP/s."""
    flops = kmlstm.bwd_flops(4, 4, 2048, 1024, 128)
    assert flops == 2 * 16 * (5 * 16 * 8256 * 1024 + 1024 ** 2 * 5 * 1920)
    assert round(flops / 1e9, 1) == 343.8
    # One chunk: only the causal products; a ragged one as many pairs.
    assert kmlstm.bwd_flops(1, 1, 64, 16, 128) == 2 * 5 * (64 * 65 // 2) * 16
    assert kmlstm.bwd_flops(1, 1, 130, 16, 128) == 2 * (
        5 * (128 * 129 // 2 + 3) * 16 + 16 * 16 * (2 * 2 + 3 * 128))
