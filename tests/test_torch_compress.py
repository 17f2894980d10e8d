"""The port's int8 gradient compression (``repro_torch.optim.compress``):
held to ``repro.optim.compress`` exactly on the same float32 inputs
(payloads, scales, errors, the error-feedback carry over steps), and the
reference's single-device cases (``tests/test_compress.py``) mirrored on
torch trees.  ``compressed_psum`` is a collective and waits for the
distributed slice."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compress as jcomp
from repro_torch.optim.compress import (compress_grads, compression_ratio,
                                        decompress, init_error, roundtrip)
from repro_torch.tree import leaves, tree_map


def _np_grads(seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (scale * rng.standard_normal((32, 16))).astype(np.float32),
            "b": (scale * rng.standard_normal((16,))).astype(np.float32),
            "blocks": ({"k": (scale * rng.standard_normal((3, 4, 5)))
                        .astype(np.float32)},)}


def _torch(tree):
    return tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def _jax(tree):
    if isinstance(tree, dict):
        return {k: _jax(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_jax(v) for v in tree)
    return jnp.asarray(tree)


def _equal(got_tree, want_tree):
    got, want = leaves(got_tree), jax.tree.leaves(want_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)
        np.testing.assert_array_equal(g.numpy(), w)


# ===========================================================================
# Against the JAX functions, exactly
# ===========================================================================
@pytest.mark.parametrize("seed,err_scale", [(0, 0.0), (1, 0.01), (2, 0.3)])
def test_compress_grads_equals_jax(seed, err_scale):
    g = _np_grads(seed)
    e = tree_map(lambda x: (err_scale * np.random.default_rng(seed + 7)
                            .standard_normal(x.shape)).astype(np.float32), g)
    (q, s), ne = compress_grads(_torch(g), _torch(e))
    (jq, js), jne = jcomp.compress_grads(_jax(g), _jax(e))
    _equal(q, jq)
    _equal(s, js)
    _equal(ne, jne)
    _equal(decompress((q, s)), jcomp.decompress((jq, js)))


def test_rounds_half_to_even_as_jnp_round():
    """scale 1: the halves go to the even neighbour, as jnp.round does."""
    g = {"x": np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.49],
                       np.float32)}
    (q, _), _ = compress_grads(_torch(g), init_error(_torch(g)))
    (jq, _), _ = jcomp.compress_grads(_jax(g), jcomp.init_error(_jax(g)))
    assert q["x"].tolist() == [127, 0, 2, 2, 0, -2, -2, 3]
    np.testing.assert_array_equal(q["x"].numpy(), np.asarray(jq["x"]))


def test_error_feedback_carry_equals_jax_over_steps():
    g, err = _torch(_np_grads()), init_error(_torch(_np_grads()))
    jg, jerr = _jax(_np_grads()), jcomp.init_error(_jax(_np_grads()))
    for step in range(6):
        g = tree_map(lambda x: x * (1.0 + 0.1 * step), g)
        jg = jax.tree.map(lambda x: x * (1.0 + 0.1 * step), jg)
        deq, err = roundtrip(g, err)
        jdeq, jerr = jcomp.roundtrip(jg, jerr)
        _equal(deq, jdeq)
        _equal(err, jerr)


def test_init_error_and_ratio_equal_jax():
    g = _np_grads()
    _equal(init_error(_torch(g)), jcomp.init_error(_jax(g)))
    assert compression_ratio(_torch(g)) == jcomp.compression_ratio(_jax(g))


# ===========================================================================
# Mirrors of tests/test_compress.py
# ===========================================================================
def test_error_bounded_by_half_step():
    """Per-tensor int8: |deq - x| <= scale / 2 = max|x| / 254, and the
    new error is that quantization error."""
    g = _torch(_np_grads())
    (q, s), new_err = compress_grads(g, init_error(g))
    deq = decompress((q, s))
    for x, d, e in zip(leaves(g), leaves(deq), leaves(new_err)):
        bound = x.abs().max().item() / 127.0 / 2.0
        assert (d - x).abs().max().item() <= bound + 1e-7
        torch.testing.assert_close(e, x - d, rtol=0, atol=1e-7)


def test_int8_payload():
    g = _torch(_np_grads())
    (q, s), _ = compress_grads(g, init_error(g))
    assert {t.dtype for t in leaves(q)} == {torch.int8}
    assert {t.dtype for t in leaves(s)} == {torch.float32}
    assert all(t.ndim == 0 for t in leaves(s))


def test_error_feedback_invariant():
    """deq + new_err == g + old_err: nothing is lost, only delayed."""
    g = _torch(_np_grads())
    old = tree_map(lambda x: torch.full_like(x, 0.01), g)
    (q, s), new_err = compress_grads(g, old)
    for d, e, x in zip(leaves(decompress((q, s))), leaves(new_err),
                       leaves(g)):
        torch.testing.assert_close(d + e, x + 0.01, rtol=1e-5, atol=1e-6)


def test_roundtrip_matches_compress_then_decompress():
    g = _torch(_np_grads())
    err = init_error(g)
    deq_rt, err_rt = roundtrip(g, err)
    compressed, err2 = compress_grads(g, err)
    for a, b in zip(leaves((deq_rt, err_rt)),
                    leaves((decompress(compressed), err2))):
        assert torch.equal(a, b)


def test_residual_stays_bounded_over_steps():
    g = _torch(_np_grads())
    err = init_error(g)
    bounds = [x.abs().max().item() / 127.0 for x in leaves(g)]
    for _ in range(16):
        _, err = roundtrip(g, err)
        for e, b in zip(leaves(err), bounds):
            assert e.abs().max().item() <= 2.0 * b + 1e-6


def test_mean_gradient_preserved_over_steps():
    g = _torch(_np_grads(scale=0.05))
    err = init_error(g)
    acc = [torch.zeros_like(x) for x in leaves(g)]
    steps = 8
    for _ in range(steps):
        deq, err = roundtrip(g, err)
        acc = [a + d for a, d in zip(acc, leaves(deq))]
    for a, x in zip(acc, leaves(g)):
        total = (a - steps * x).abs().max().item()
        assert total <= x.abs().max().item() / 127.0 + 1e-6


def test_compression_ratio_formula():
    g = _torch(_np_grads())
    n = sum(x.numel() for x in leaves(g))
    t = len(leaves(g))
    assert compression_ratio(g) == pytest.approx(4.0 * n / (n + 4.0 * t))
    assert 3.5 < compression_ratio(g) < 4.0
