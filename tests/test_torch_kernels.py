"""repro_torch.kernels: each plain version against its JAX kernel.

The JAX kernels run under the Pallas interpreter (``interpret=True``), as
``tests/test_kernels.py`` runs them on the CPU; the port's wrappers take
their plain PyTorch versions because the tensors lie on the CPU.  Inputs
are drawn with numpy and handed to both.  Tolerances are the reference's
own ``tol_for``: 3e-2 for bf16 (one bf16 rounding of the output, taken at
different points by the two frameworks) and 2e-4 for f32 (summation
order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backends.pallas_backend import INTERPRET
from repro.backends.xla_backend import chunked_mha
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as j_decode
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.norm_gemm import rmsnorm_gemm as j_rmsnorm_gemm
from repro.kernels.sma_gemm import sma_gemm as j_sma_gemm
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.norm_gemm import rmsnorm_gemm
from repro_torch.kernels.sma_gemm import sma_gemm

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
EPILOGUES = ("none", "relu", "gelu", "silu", "tanh")


def tol_for(dtype_name):
    return 3e-2 if dtype_name == "bfloat16" else 2e-4


def both(x, dtype_name):
    """One numpy array as a JAX array and a torch tensor of one dtype
    (both round f32 to bf16 to nearest even, so the bits agree)."""
    jdt, tdt = DTYPES[dtype_name]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def assert_close(got, want, dtype_name):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol_for(dtype_name),
                               atol=tol_for(dtype_name))


# ---------------------------------------------------------------- sma_gemm
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("with_bias", [False, True])
def test_sma_gemm_plain_matches_jax_ragged(dtype, epilogue, with_bias):
    """Ragged M/N/K (none a multiple of the blocks): the JAX kernel pads,
    the port masks."""
    rng = np.random.default_rng(0)
    m, k, n = 37, 70, 50
    a, ta = both(rng.standard_normal((m, k), np.float32), dtype)
    b, tb = both(rng.standard_normal((k, n), np.float32), dtype)
    bias, tbias = (both(rng.standard_normal((n,), np.float32), dtype)
                   if with_bias else (None, None))
    want = j_sma_gemm(a, b, bias=bias, epilogue=epilogue, interpret=True,
                      block_m=16, block_n=128, block_k=128)
    got = sma_gemm(ta, tb, bias=tbias, epilogue=epilogue)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (m, n)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_sma_gemm_plain_matches_jax_multi_k_leading_dims(dtype):
    """Several K steps and leading dims collapsed into M."""
    rng = np.random.default_rng(1)
    a, ta = both(rng.standard_normal((2, 3, 24, 256), np.float32), dtype)
    b, tb = both(rng.standard_normal((256, 192), np.float32), dtype)
    want = j_sma_gemm(a, b, epilogue="silu", interpret=True,
                      block_m=32, block_n=128, block_k=128)
    got = sma_gemm(ta, tb, epilogue="silu")
    assert got.shape == (2, 3, 24, 192)
    assert_close(got, want, dtype)


# ------------------------------------------------------------ rmsnorm_gemm
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("m,k,n,epilogue", [
    (8, 128, 256, "none"),       # the head's shape class (M <= 8)
    (19, 70, 45, "gelu"),        # ragged
])
def test_rmsnorm_gemm_plain_matches_jax(dtype, m, k, n, epilogue):
    rng = np.random.default_rng(2)
    x, tx = both(rng.standard_normal((m, k), np.float32) * 3, dtype)
    scale = rng.uniform(0.5, 1.5, (k,)).astype(np.float32)
    w, tw = both(rng.standard_normal((k, n), np.float32) / np.sqrt(k), dtype)
    want = j_rmsnorm_gemm(x, jnp.asarray(scale), w, epilogue=epilogue,
                          interpret=True, block_m=8, block_n=128,
                          block_k=128)
    got = rmsnorm_gemm(tx, torch.from_numpy(scale), tw, epilogue=epilogue)
    assert_close(got, want, dtype)


# -------------------------------------------------------------- attention
HQ, HKV, D, BS, MB = 8, 2, 16, 4, 4
# kv_len: empty (batch padding), one token, a page boundary, the full table
KV_LENS = np.array([0, 1, BS, MB * BS], np.int32)


def _paged_inputs(dtype, seed=3):
    """Four requests over a shuffled pool; table slots past each request's
    pages hold the sentinel NB (the kv_len 0 row holds one unread page)."""
    rng = np.random.default_rng(seed)
    b = len(KV_LENS)
    nb = b * MB + 2
    perm = rng.permutation(nb)
    table = np.full((b, MB), nb, np.int32)
    used = 0
    for r, n in enumerate(KV_LENS):
        pages = max(1, -(-int(n) // BS))
        table[r, :pages] = perm[used:used + pages]
        used += pages
    q = rng.standard_normal((b, 1, HQ, D), np.float32)
    k = rng.standard_normal((nb, HKV, BS, D), np.float32)
    v = rng.standard_normal((nb, HKV, BS, D), np.float32)
    return [both(x, dtype) for x in (q, k, v)], table


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_paged_decode_plain_matches_jax_kernel_path(dtype):
    """C = 1, no window: the port's kernel site (CPU -> plain version)
    against the JAX kernel path (the interpret backend's page gather + the
    Pallas decode kernel), GQA 8/2, with sentinels and kv_len 0 giving 0.

    The op is taken from the backend directly: through
    ``repro.kernels.ops`` the int32 block table fails the backend's dtype
    check and the site resolves to the XLA oracle instead."""
    ((q, tq), (k, tk), (v, tv)), table = _paged_inputs(dtype)
    q_pos = np.maximum(KV_LENS - 1, 0)[:, None]
    want = INTERPRET.op("paged_decode_attention")(
        q, k, v, jnp.asarray(table), jnp.asarray(q_pos),
        jnp.asarray(KV_LENS), block_s=8)
    ops.reset_counts()
    got = ops.paged_decode_attention(
        tq, tk, tv, torch.from_numpy(table), torch.from_numpy(q_pos),
        torch.from_numpy(KV_LENS))
    assert got.shape == (len(KV_LENS), 1, HQ, D)
    assert not ops.ROUTED
    assert ops.launch_counts()["paged_decode_attention"] == 0  # CPU: plain
    np.testing.assert_array_equal(got[0].float().numpy(), 0.0)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("c,window", [(4, None), (1, 3), (3, 2)])
def test_routed_sites_match_jax_paged_ref(c, window):
    """Chunked (C > 1) and windowed sites are routed to the plain paged
    oracle, with the reason recorded, and match the JAX oracle."""
    ((q, tq), (k, tk), (v, tv)), table = _paged_inputs("float32", seed=4)
    rng = np.random.default_rng(5)
    q5 = rng.standard_normal((len(KV_LENS), c, HQ, D), np.float32)
    q_pos = np.maximum(KV_LENS[:, None] - c + np.arange(c)[None, :], 0)
    want = jref.paged_attention_ref(
        jnp.asarray(q5), k, v, jnp.asarray(table), jnp.asarray(q_pos),
        jnp.asarray(KV_LENS), window=window)
    ops.reset_counts()
    got = ops.paged_decode_attention(
        torch.from_numpy(q5), tk, tv, torch.from_numpy(table),
        torch.from_numpy(q_pos), torch.from_numpy(KV_LENS), window=window)
    assert sum(ops.ROUTED.values()) == 1
    reason = next(iter(ops.ROUTED))
    assert reason.startswith("shape:" if c > 1 else "param:")
    assert_close(got, want, "float32")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_attention_plain_matches_jax(dtype):
    rng = np.random.default_rng(6)
    b, smax = len(KV_LENS), MB * BS
    q, tq = both(rng.standard_normal((b, HQ, D), np.float32), dtype)
    kc, tkc = both(rng.standard_normal((b, HKV, smax, D), np.float32), dtype)
    vc, tvc = both(rng.standard_normal((b, HKV, smax, D), np.float32), dtype)
    want = j_decode(q, kc, vc, jnp.asarray(KV_LENS), block_s=8,
                    interpret=True)
    got = decode_attention(tq, tkc, tvc, torch.from_numpy(KV_LENS))
    assert_close(got, want, dtype)


# ---------------------------------------------------------------- wrappers
def test_wrappers_refuse_devices_they_do_not_run_on():
    """Only CPU tensors take the plain version; any other non-CUDA device
    raises instead of computing somewhere else."""
    a = torch.empty((4, 8), device="meta")
    b = torch.empty((8, 4), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        sma_gemm(a, b)
    with pytest.raises(ValueError, match="cuda or cpu"):
        rmsnorm_gemm(a, torch.empty((8,), device="meta"), b)
    with pytest.raises(ValueError, match="cuda or cpu"):
        decode_attention(torch.empty((1, 2, 8), device="meta"),
                         torch.empty((1, 2, 4, 8), device="meta"),
                         torch.empty((1, 2, 4, 8), device="meta"),
                         torch.ones((1,), dtype=torch.int32))


def test_plain_references_agree_with_each_other():
    """The paged decode oracle over a one-block-per-request table is the
    contiguous decode oracle."""
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((3, 4, 8), np.float32))
    kc = torch.from_numpy(rng.standard_normal((3, 2, 5, 8), np.float32))
    vc = torch.from_numpy(rng.standard_normal((3, 2, 5, 8), np.float32))
    lens = torch.tensor([0, 2, 5], dtype=torch.int32)
    table = torch.arange(3, dtype=torch.int32)[:, None]
    torch.testing.assert_close(
        ref.paged_decode_attention_ref(q, kc, vc, table, lens),
        ref.decode_attention_ref(q, kc, vc, lens))


# -------------------------------------------------------- flash attention
# The cases of tests/test_kernels.py's flash sweep: GQA, MQA + window,
# padding (S not a multiple of the blocks), non-causal, Sq < Skv; and
# head_dim 256 (RecurrentGemma's MQA with a window).
FLASH_CASES = [
    (2, 4, 4, 256, 256, 64, True, None),
    (1, 8, 2, 256, 256, 64, True, None),
    (1, 4, 1, 192, 192, 32, True, 64),
    (2, 2, 2, 100, 100, 64, True, None),
    (1, 2, 2, 128, 128, 64, False, None),
    (1, 4, 4, 64, 256, 64, True, None),
    (1, 4, 1, 192, 192, 256, True, 64),
]


def _qkv(b, hq, hkv, sq, skv, d, seed=8):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, d), np.float32),
            rng.standard_normal((b, hkv, skv, d), np.float32),
            rng.standard_normal((b, hkv, skv, d), np.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", FLASH_CASES)
def test_flash_plain_matches_jax_kernel(b, hq, hkv, sq, skv, d, causal,
                                        window, dtype):
    """The port's flash site on CPU tensors (the plain version) against
    the Pallas kernel under the interpreter, at tol_for."""
    (q, tq), (k, tk), (v, tv) = (both(x, dtype)
                                 for x in _qkv(b, hq, hkv, sq, skv, d))
    want = j_flash(q, k, v, causal=causal, window=window, block_q=64,
                   block_kv=64, interpret=True)
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (b, hq, sq, d)
    assert_close(got, want, dtype)


def _jax_vjp(fn, args, dout):
    """(out, *input gradients) of ``fn`` through jax.vjp."""
    out, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in args))
    return (out, *vjp(jnp.asarray(dout)))


@pytest.mark.parametrize("oracle", ["chunked_mha", "mha_ref"])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", FLASH_CASES)
def test_flash_autograd_matches_jax_grad(b, hq, hkv, sq, skv, d, causal,
                                         window, oracle):
    """The flash Function on the CPU (plain forward, plain backward written
    out) against jax.vjp of the JAX package's differentiable attention:
    the XLA backend's chunked online softmax (chunk 64, so several chunks
    and a padded one) and the full-softmax oracle.  f32, 1e-4: the two
    sides differ only in summation order."""
    q, k, v = _qkv(b, hq, hkv, sq, skv, d)
    dout = np.random.default_rng(9).standard_normal(q.shape, np.float32)
    if oracle == "chunked_mha":
        def fn(q_, k_, v_):
            return chunked_mha(q_, k_, v_, causal=causal, window=window,
                               scale=None, chunk=64)
    else:
        def fn(q_, k_, v_):
            return jref.mha_ref(q_, k_, v_, causal=causal, window=window)
    want = _jax_vjp(fn, (q, k, v), dout)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.backward(torch.from_numpy(dout))
    for got, w in zip((out.detach(), tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_flash_rows_that_see_no_key_give_zero():
    """Sq > Skv: the first Sq - Skv rows sit before every key.  They give
    0, lse +inf and zero gradients, never NaN; the other rows match the
    JAX oracle."""
    q, k, v = _qkv(1, 4, 2, 96, 40, 16)
    dout = np.random.default_rng(10).standard_normal(q.shape, np.float32)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal=True)
    out.backward(torch.from_numpy(dout))
    _, lse = ref.flash_attention_ref(tq.detach(), tk.detach(), tv.detach())
    dead = 96 - 40
    assert torch.isinf(lse[:, :, :dead]).all()
    assert torch.isfinite(lse[:, :, dead:]).all()
    for t in (out, tq.grad, tk.grad, tv.grad):
        assert torch.isfinite(t).all()
    assert (out[:, :, :dead] == 0).all() and (tq.grad[:, :, :dead] == 0).all()
    want = jref.mha_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(out[:, :, dead:].detach().numpy(),
                               np.asarray(want)[:, :, dead:], rtol=1e-4,
                               atol=1e-4)


# ----------------------------------------------------- gradients of GEMMs
def _assert_grads(got, want, tol=2e-4):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("with_bias", [False, True])
def test_sma_gemm_autograd_matches_jax_grad(epilogue, with_bias):
    """The sma_gemm Function's backward (dZ = dC * epilogue'(Z), dA, dB
    and dbias through the wrapper, here its plain version) against
    jax.vjp of repro.kernels.ref.gemm_ref, f32 at tol_for; leading dims
    collapse into M."""
    rng = np.random.default_rng(11)
    a = rng.standard_normal((2, 19, 40), np.float32)
    b = rng.standard_normal((40, 33), np.float32) / np.sqrt(40)
    bias = rng.standard_normal((33,), np.float32)
    dout = rng.standard_normal((2, 19, 33), np.float32)
    args = (a, b, bias) if with_bias else (a, b)
    want = _jax_vjp(lambda a_, b_, *bb: jref.gemm_ref(
        a_, b_, bias=bb[0] if bb else None, epilogue=epilogue), args, dout)
    targs = [torch.from_numpy(x).requires_grad_() for x in args]
    out = ops.sma_gemm(targs[0], targs[1],
                       bias=targs[2] if with_bias else None,
                       epilogue=epilogue)
    assert type(out.grad_fn).__name__ == "SmaGemmBackward"
    out.backward(torch.from_numpy(dout))
    _assert_grads([out] + [t.grad for t in targs], want)


@pytest.mark.parametrize("epilogue", ["none", "gelu"])
def test_rmsnorm_gemm_autograd_matches_jax_grad(epilogue):
    """The rmsnorm_gemm Function's backward (dW and dnormed through
    sma_gemm, the rmsnorm backward elementwise) against jax.vjp of
    repro.kernels.ref.rmsnorm_gemm_ref, f32 at tol_for."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((3, 7, 48), np.float32) * 3
    scale = rng.uniform(0.5, 1.5, (48,)).astype(np.float32)
    w = rng.standard_normal((48, 36), np.float32) / np.sqrt(48)
    dout = rng.standard_normal((3, 7, 36), np.float32)
    want = _jax_vjp(lambda x_, s_, w_: jref.rmsnorm_gemm_ref(
        x_, s_, w_, epilogue=epilogue), (x, scale, w), dout)
    targs = [torch.from_numpy(t).requires_grad_() for t in (x, scale, w)]
    out = ops.rmsnorm_gemm(*targs, epilogue=epilogue)
    assert type(out.grad_fn).__name__ == "RmsnormGemmBackward"
    out.backward(torch.from_numpy(dout))
    _assert_grads([out] + [t.grad for t in targs], want)


def test_entry_points_skip_autograd_without_grad():
    """Without a gradient to take (inference, or grad mode off) the entry
    points call the wrappers directly: no graph, no Function."""
    x = torch.randn(4, 8, requires_grad=True)
    w = torch.randn(8, 8)
    with torch.no_grad():
        assert ops.sma_gemm(x, w).grad_fn is None
    assert ops.sma_gemm(x.detach(), w).grad_fn is None
    assert ops.sma_gemm(x, w).grad_fn is not None
