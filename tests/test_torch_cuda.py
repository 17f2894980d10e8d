"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (with its reason) where no NVIDIA card is
visible, and runs on one with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

These cover what ``chip_smoke.py`` does not: every dtype route (the f32
CUDA-core path, f16), ragged M/N/K and unaligned operands (the masked
element-by-element loads), every epilogue with bias, GQA and head_dim 128
in the decode kernel, and the serving steps on the card against the same
steps on the CPU.  Tolerances: the reference's ``tol_for`` (3e-2 for
16-bit outputs, one rounding flip; 2e-4 for f32, summation order), with
TF32 off in the plain versions.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  paged_decode_attention)
from repro_torch.kernels.norm_gemm import rmsnorm_gemm
from repro_torch.kernels.sma_gemm import sma_gemm
from repro_torch.models import lm
from repro_torch.serving import CacheConfig, PagedKVCache
from repro_torch.serving import model as smodel

pytestmark = pytest.mark.cuda

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def tol(dtype):
    return 2e-4 if dtype == torch.float32 else 3e-2


def close(got, want, dtype):
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol(dtype),
                               atol=tol(dtype))


def randn(shape, dtype, dev, seed, scale=1.0, offset=0):
    """Seeded normal values; ``offset`` > 0 places the tensor that many
    elements into a buffer, so its address is not 16-byte aligned."""
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    flat = torch.zeros(x.size + offset, dtype=dtype, device=dev)
    flat[offset:] = torch.from_numpy(x.reshape(-1)).to(dev, dtype)
    return flat[offset:].view(shape)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("m,k,n", [(37, 70, 50), (1, 2048, 130),
                                   (300, 513, 257), (16, 64, 64),
                                   (17, 2048, 2048), (129, 40, 8)])
def test_sma_gemm_matches_plain(dev, dtype, m, k, n):
    dt = DTYPES[dtype]
    a = randn((m, k), dt, dev, 0)
    b = randn((k, n), dt, dev, 1, scale=k ** -0.5)
    bias = randn((n,), torch.float32, dev, 2)
    for ep in ("none", "relu", "gelu", "silu", "tanh"):
        close(sma_gemm(a, b, bias=bias, epilogue=ep),
              ref.gemm_ref(a, b, bias=bias, epilogue=ep), dt)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_sma_gemm_unaligned_operands(dev, dtype):
    """Operands whose addresses are not 16-byte aligned take the masked
    element loads instead of cp.async."""
    dt = DTYPES[dtype]
    a = randn((20, 72), dt, dev, 3, offset=1)
    b = randn((72, 40), dt, dev, 4, scale=72 ** -0.5, offset=3)
    assert a.data_ptr() % 16 and b.data_ptr() % 16
    close(sma_gemm(a, b), ref.gemm_ref(a, b), dt)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("m,k,n", [(8, 2048, 1000), (19, 70, 45),
                                   (64, 256, 384)])
def test_rmsnorm_gemm_matches_plain(dev, dtype, m, k, n):
    dt = DTYPES[dtype]
    x = randn((m, k), dt, dev, 5, scale=3.0)
    scale = randn((k,), torch.float32, dev, 6).abs() + 0.5
    w = randn((k, n), dt, dev, 7, scale=k ** -0.5)
    for ep in ("none", "silu"):
        close(rmsnorm_gemm(x, scale, w, epilogue=ep),
              ref.rmsnorm_gemm_ref(x, scale, w, epilogue=ep), dt)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("hq,hkv,d", [(8, 2, 64), (4, 4, 128), (16, 1, 64)])
def test_paged_decode_matches_plain(dev, dtype, hq, hkv, d):
    dt = DTYPES[dtype]
    bs, mb = 16, 6
    lens = [0, 1, bs, bs + 1, mb * bs, 37]
    b, nb = len(lens), len(lens) * mb + 3
    perm = np.random.default_rng(8).permutation(nb)
    table = np.full((b, mb), nb, np.int32)
    used = 0
    for r, n in enumerate(lens):
        pages = -(-n // bs)
        table[r, :pages] = perm[used:used + pages]
        used += pages
    table = torch.from_numpy(table).to(dev)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = randn((b, hq, d), dt, dev, 9)
    kp = randn((nb, hkv, bs, d), dt, dev, 10)
    vp = randn((nb, hkv, bs, d), dt, dev, 11)
    got = paged_decode_attention(q, kp, vp, table, kv_len)
    close(got, ref.paged_decode_attention_ref(q, kp, vp, table, kv_len), dt)
    assert got[0].abs().max().item() == 0.0
    kc = randn((b, hkv, mb * bs, d), dt, dev, 12)
    vc = randn((b, hkv, mb * bs, d), dt, dev, 13)
    close(decode_attention(q, kc, vc, kv_len),
          ref.decode_attention_ref(q, kc, vc, kv_len), dt)


def test_paged_decode_poisons_reads_outside_the_table(dev):
    """A sentinel entry below kv_len, or kv_len past the table, is not
    clamped into another request's page: that request's output is NaN and
    the other requests' outputs are unchanged."""
    dt = torch.bfloat16
    bs, mb, nb = 16, 4, 12
    table = torch.arange(3 * mb, dtype=torch.int32, device=dev).reshape(3, mb)
    table[1, 1] = nb                                 # sentinel at page 1
    kv_len = torch.tensor([40, 40, mb * bs + 1], dtype=torch.int32,
                          device=dev)
    q = randn((3, 4, 64), dt, dev, 15)
    kp = randn((nb, 4, bs, 64), dt, dev, 16)
    vp = randn((nb, 4, bs, 64), dt, dev, 17)
    got = paged_decode_attention(q, kp, vp, table, kv_len)
    torch.cuda.synchronize()
    assert torch.isnan(got[1:]).all()
    close(got[:1], ref.paged_decode_attention_ref(q[:1], kp, vp, table[:1],
                                                  kv_len[:1]), dt)


def test_serving_steps_on_card_match_cpu(dev):
    """The reduced model (f32) through a ragged prefill and 2 decode steps:
    the kernels on the card against the plain versions on the CPU, fed
    the same tokens, at the f32 tolerance."""
    cfg = reduced(get_config("stablelm-1.6b"))
    cc = CacheConfig(block_size=4, num_blocks=32, max_seq_len=64)
    kv = PagedKVCache(cc, 3)
    for r in range(3):
        assert kv.admit(r, 8, 3)
    table = torch.from_numpy(kv.table_rows([0, 1, 2]))
    toks = torch.from_numpy(np.random.default_rng(14).integers(
        0, cfg.vocab_size, (3, 8)))
    n_tok = torch.tensor([8, 3, 6])

    def run(where, feed=None):
        params = _to(lm.init(cfg, seed=0, device="cpu"), where)
        state = smodel.init_state(cfg, cc, device=where)
        logits, state, cl = smodel.paged_prefill_step(
            params, state, table.to(where),
            torch.zeros(3, dtype=torch.int32, device=where),
            n_tok.to(where), cfg, {"tokens": toks.to(where)})
        outs, fed = [logits.cpu()], []
        for i in range(2):
            nxt = feed[i] if feed else logits.argmax(-1, keepdim=True).cpu()
            fed.append(nxt)
            logits, state, cl = smodel.paged_decode_step(
                params, state, table.to(where), cl, cfg,
                {"tokens": nxt.to(where)})
            outs.append(logits.cpu())
        return outs, fed

    want, fed = run(torch.device("cpu"))
    got, _ = run(dev, fed)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-4)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to(v, device) for v in tree)
    return tree.to(device)
