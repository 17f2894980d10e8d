"""The flash backward's two passes at head_dim 256, in plain PyTorch
(``ref.flash_attention_bwd256_split_ref``), against the plain backward
written out (``ref.flash_attention_bwd_ref``) and against ``jax.vjp`` of
the JAX package's differentiable attention; the banded dS scratch's
layout against a brute-force count of the visible tiles; the planted
faults the card checks feed the kernels.

Tolerances: f32 inputs at 1e-5 of each gradient's largest value (the two
sides differ only in summation order); bf16 within 2e-2 of it, the card
check's FLASH_GRAD_LIMIT (the split rounds P and dS to bf16 for its
products, as the kernels do; the plain backward keeps them f32); against
``jax.vjp`` f32 at 1e-4, as ``tests/test_torch_kernels.py`` holds the
flash gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backends.xla_backend import chunked_mha
from repro_torch.kernels import ref

GRAD_LIMIT = 2e-2  # chip_smoke.py FLASH_GRAD_LIMIT

# (B, Hq, Hkv, Sq, Skv, causal, window), all at head_dim 256: MQA 10/1
# windowed (RecurrentGemma's attention), GQA 4/2 causal with a ragged S,
# Sq < Skv across a key tile's edge with a window, non-causal Sq < Skv,
# and Sq > Skv (the first rows see no key).
CASES = [
    (1, 10, 1, 192, 192, True, 64),
    (1, 4, 2, 200, 200, True, None),
    (1, 4, 2, 100, 230, True, 90),
    (1, 2, 1, 70, 150, False, None),
    (2, 4, 2, 150, 60, True, None),
]


def _inputs(b, hq, hkv, sq, skv, dtype, seed=0):
    rng = np.random.default_rng(seed)

    def rn(*shape):
        return rng.standard_normal(shape, np.float32)
    q, k, v, do = (rn(b, hq, sq, 256), rn(b, hkv, skv, 256),
                   rn(b, hkv, skv, 256), rn(b, hq, sq, 256))
    return (q, k, v, do), [torch.from_numpy(x).to(dtype)
                           for x in (q, k, v, do)]


def _rel(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def _both(case, dtype, plant=0):
    b, hq, hkv, sq, skv, causal, window = case
    _, (q, k, v, do) = _inputs(b, hq, hkv, sq, skv, dtype)
    out, lse = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    kw = dict(causal=causal, window=window)
    return (ref.flash_attention_bwd256_split_ref(q, k, v, out, lse, do,
                                                 plant=plant, **kw),
            ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw))


@pytest.mark.parametrize("dtype,limit", [(torch.float32, 1e-5),
                                         (torch.bfloat16, GRAD_LIMIT)])
@pytest.mark.parametrize("case", CASES)
def test_split_matches_the_plain_backward(case, dtype, limit):
    got, want = _both(case, dtype)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert torch.isfinite(g).all()
        assert _rel(g, w) <= limit


@pytest.mark.parametrize("case", CASES[:-1])
def test_split_matches_jax_vjp(case):
    """Against jax.vjp of the XLA backend's chunked online softmax (chunk
    64), f32, at 1e-4: out and lse from the port's plain forward.  Not at
    Sq > Skv: the XLA path gives a row that sees no key a uniform average
    (its mask is finite), where the kernels give 0."""
    b, hq, hkv, sq, skv, causal, window = case
    (q, k, v, do), (tq, tk, tv, tdo) = _inputs(b, hq, hkv, sq, skv,
                                               torch.float32, seed=1)

    def fn(q_, k_, v_):
        return chunked_mha(q_, k_, v_, causal=causal, window=window,
                           scale=None, chunk=64)
    _, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    out, lse = ref.flash_attention_ref(tq, tk, tv, causal=causal,
                                       window=window)
    got = ref.flash_attention_bwd256_split_ref(tq, tk, tv, out, lse, tdo,
                                               causal=causal, window=window)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_rows_that_see_no_key_get_zero_gradients():
    """Sq > Skv: the first Sq - Skv rows sit before every key; their dq is
    exactly 0 (their query tiles' bands hold no key tile or only masked
    pairs), never NaN."""
    got, _ = _both(CASES[-1], torch.float32)
    dead = CASES[-1][3] - CASES[-1][4]
    assert (got[0][:, :, :dead] == 0).all()
    assert all(torch.isfinite(g).all() for g in got)


@pytest.mark.parametrize("sq,skv,causal,window", [
    (1, 1, True, None), (64, 64, True, None), (65, 65, True, None),
    (300, 300, True, None), (300, 300, False, None), (300, 300, True, 1),
    (300, 300, True, 64), (300, 300, True, 65), (257, 600, True, 130),
    (100, 300, False, 50), (150, 60, True, None), (150, 60, True, 20),
    (4096, 4096, True, 2048)])
def test_scratch_layout_counts_the_visible_tiles(sq, skv, causal, window):
    """Each query tile's band holds exactly the key tiles with a visible
    (query, key) pair, its slots start where the tiles before it end, and
    the scratch holds one slot a visible pair of tiles."""
    t = ref.BWD256_TILE
    bands, bases, slots = ref.bwd256_scratch_layout(sq, skv, causal=causal,
                                                    window=window)
    mask = ref.flash_mask(sq, skv, causal=causal, window=window,
                          device=torch.device("cpu"))
    nq, nk = -(-sq // t), -(-skv // t)
    pad = torch.zeros((nq * t, nk * t), dtype=torch.bool)
    pad[:sq, :skv] = mask
    seen = pad.reshape(nq, t, nk, t).any(3).any(1)   # (query tile, key tile)
    assert len(bands) == nq
    base = 0
    for it, (kt0, kt1) in enumerate(bands):
        visible = seen[it].nonzero().flatten().tolist()
        assert visible == list(range(kt0, kt1))
        assert bases[it] == base
        base += kt1 - kt0
    assert slots == base == int(seen.sum())


def test_recurrentgemma_scratch_size():
    """B 2, Hq 10, S 4096, window 2048: 31,680 visible (query tile, key
    tile) pairs, 8 KB of bf16 dS each."""
    slots = ref.bwd256_scratch_layout(4096, 4096, causal=True,
                                      window=2048)[2]
    assert 2 * 10 * slots == 31_680
    assert 2 * 10 * slots * 64 * 64 * 2 == 259_522_560


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_planted_dq_tile_moves_dq_only(dtype):
    """plant 2 (pass 2 leaves the last key tile out of every query tile's
    sum) moves dq past the limit and leaves dk and dv exactly as they
    were."""
    case = CASES[0]
    good, want = _both(case, dtype)
    bad, _ = _both(case, dtype, plant=ref.FLASH_PLANT_DQ_TILE)
    assert _rel(bad[0], want[0]) > GRAD_LIMIT
    assert torch.equal(bad[1], good[1]) and torch.equal(bad[2], good[2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_planted_key_tile_moves_every_gradient(dtype):
    """plant 1 (pass 1 skips the middle key tile: its dK, dV zeros, its dS
    slots zeros) moves dq, dk and dv each past the limit."""
    case = CASES[0]
    _, want = _both(case, dtype)
    bad, _ = _both(case, dtype, plant=ref.FLASH_PLANT_KEY_TILE)
    for g, w in zip(bad, want):
        assert _rel(g, w) > GRAD_LIMIT
