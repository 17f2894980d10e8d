"""The mLSTM ``wgmma`` route's algorithm, on the CPU.

``ref.mlstm_chunkwise_two_pass_ref`` is what the card's ``wgmma`` kernels
compute: a gate pre-scan, S . D stored once per chunk, the C_k chain, and
every product with an f32 side split into hi + lo 16-bit halves (the other
side, q, k or v, exact in bf16).  Here it is held against the JAX package:
h against the Pallas kernel under the interpreter, the final (C, n, m)
against the XLA chunkwise path (``repro.backends.xla_backend.
mlstm_chunkwise``, ``return_state=True``), on bf16-exact q, k, v.

Limits, as ``chip_smoke.py`` holds the kernels: h per element within
``MLSTM_TOL`` (2e-3 + 2^-7 |want|, one rounding flip of a bf16 h); each
state leaf within ``MLSTM_STATE_LIMIT`` (1e-5) of its largest entry.  With
the lo half of the state update dropped the state misses that limit: the
split is what the limit needs.  The planted faults of the kernels'
controls move h far past its limit in the plain version too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backends import xla_backend
from repro.kernels.mlstm import mlstm_chunkwise as j_mlstm_chunkwise
from repro_torch.kernels import ref

#: chip_smoke.py's MLSTM_TOL for a bf16 h and its MLSTM_STATE_LIMIT.
H_ATOL, H_RTOL = 2e-3, 2.0 ** -7
STATE_LIMIT = 1e-5
#: (B, H, S, D, chunk): S ragged (100) and whole (128) against the chunk.
SHAPES = [(2, 2, s, 64, chunk) for s in (100, 128) for chunk in (16, 32)]


def inputs(b, h, s, d, seed):
    """q, k, v unit normals rounded to bf16 (so exact on both sides);
    log_f = log_sigmoid(N + 3), log_i = 0.5 N (float32 numpy)."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, s, d))
                                .astype(np.float32)).bfloat16()
               for _ in range(3))
    lf = (-np.logaddexp(0.0, -(rng.standard_normal((b, h, s)) + 3.0))
          ).astype(np.float32)
    li = (rng.standard_normal((b, h, s)) * 0.5).astype(np.float32)
    return q, k, v, torch.from_numpy(lf), torch.from_numpy(li)


def jax_args(ins):
    return [jnp.asarray(t.float().numpy()) for t in ins]


def h_multiple(got: torch.Tensor, want) -> float:
    """Largest |err| / (H_ATOL + H_RTOL |want|): above 1 fails."""
    want = torch.from_numpy(np.array(want, np.float32))
    return ((got.float() - want).abs()
            / (H_ATOL + H_RTOL * want.abs())).max().item()


def state_errors(got, want) -> list:
    """max |err| / max |want| of C, n and m."""
    out = []
    for g, w in zip(got, want):
        w = torch.from_numpy(np.array(w, np.float32))
        out.append(((g - w).abs().max() / w.abs().max()).item())
    return out


@pytest.mark.parametrize("b,h,s,d,chunk", SHAPES)
def test_two_pass_h_matches_pallas_interpret(b, h, s, d, chunk):
    ins = inputs(b, h, s, d, s + chunk)
    want = j_mlstm_chunkwise(*jax_args(ins), chunk=chunk, interpret=True)
    got = ref.mlstm_chunkwise_two_pass_ref(*ins, chunk=chunk)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, h, s, d)
    assert h_multiple(got, want) <= 1


@pytest.mark.parametrize("b,h,s,d,chunk", SHAPES)
def test_two_pass_state_matches_xla_backend(b, h, s, d, chunk):
    ins = inputs(b, h, s, d, 3 * s + chunk)
    want_h, want_state = xla_backend.mlstm_chunkwise(
        *jax_args(ins), chunk=chunk, return_state=True)
    got_h, state = ref.mlstm_chunkwise_two_pass_ref(
        *ins, chunk=chunk, return_state=True)
    assert h_multiple(got_h, want_h) <= 1
    for g, shape in zip(state, ((b, h, d, d), (b, h, d), (b, h))):
        assert g.dtype == torch.float32 and tuple(g.shape) == shape
    assert max(state_errors(state, want_state)) <= STATE_LIMIT


@pytest.mark.parametrize("b,h,s,d,chunk", SHAPES[:2])
def test_state_misses_its_limit_without_the_lo_half(b, h, s, d, chunk):
    """w k rounded once to bf16 (lo dropped) puts C ~1e-3 off: the hi + lo
    split is what the 1e-5 state limit needs.  n and m do not use it."""
    ins = inputs(b, h, s, d, 5 * s + chunk)
    _, want_state = xla_backend.mlstm_chunkwise(
        *jax_args(ins), chunk=chunk, return_state=True)
    _, state = ref.mlstm_chunkwise_two_pass_ref(
        *ins, chunk=chunk, return_state=True, plant=ref.PLANT_LO)
    c_err, n_err, m_err = state_errors(state, want_state)
    assert c_err > 10 * STATE_LIMIT
    assert max(n_err, m_err) <= STATE_LIMIT


@pytest.mark.parametrize("plant", [ref.PLANT_LATE, ref.PLANT_ROWSUM])
def test_planted_faults_move_h_in_their_chunk_only(plant):
    """C_k handed one chunk late, or one chunk's S . D row sums dropped,
    changes the outputs of chunk nc // 2 only, far past the h limit."""
    b, h, s, d, chunk = 2, 2, 128, 64, 16
    ins = inputs(b, h, s, d, 11)
    want = ref.mlstm_chunkwise_two_pass_ref(*ins, chunk=chunk)
    got = ref.mlstm_chunkwise_two_pass_ref(*ins, chunk=chunk, plant=plant)
    cf = (s // chunk) // 2
    moved = (got.float() - want.float()).abs().amax((0, 1, 3)) > 0
    assert moved.nonzero().flatten().tolist() == list(
        range(cf * chunk, (cf + 1) * chunk))
    assert h_multiple(got, want.float().numpy()) > 10


@pytest.mark.parametrize("b,h,s,d,chunk", SHAPES[2:])
def test_h_misses_its_limit_with_c_k_handed_as_hi_alone(b, h, s, d, chunk):
    """C_k rounded once to bf16 for the q C_k products (its lo half
    dropped, which would halve the hand-off's bytes) puts h past
    MLSTM_TOL: the outputs need both halves too."""
    ins = inputs(b, h, s, d, 13 * s + chunk)
    want = j_mlstm_chunkwise(*jax_args(ins), chunk=chunk, interpret=True)
    got = ref.mlstm_chunkwise_two_pass_ref(*ins, chunk=chunk,
                                           plant=ref.PLANT_CK_HI)
    assert h_multiple(got, want) > 1


def test_two_pass_matches_the_plain_version_in_f32():
    """Fed f32 inputs, the split is bf16's; h stays within the f32 plain
    version's rounding of the split halves."""
    ins = list(inputs(2, 2, 100, 64, 9))
    ins[:3] = [t.float() for t in ins[:3]]
    want, want_state = ref.mlstm_chunkwise_ref(*ins, chunk=32,
                                               return_state=True)
    got, state = ref.mlstm_chunkwise_two_pass_ref(*ins, chunk=32,
                                                  return_state=True)
    assert got.dtype == torch.float32
    assert h_multiple(got, want.numpy()) <= 1
    assert max(state_errors(state, [w.numpy() for w in want_state])) \
        <= STATE_LIMIT
