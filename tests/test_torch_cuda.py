"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (with its reason) where no NVIDIA card is
visible, and runs on one with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

These cover what ``chip_smoke.py`` does not: every dtype route (the f32
CUDA-core path, f16), ragged M/N/K and unaligned operands (the masked
element-by-element loads), every epilogue with bias, GQA and head_dim 128
in the decode and flash kernels, flash rows that see no key, gradients
reaching weights through every kernel entry point, the serving steps and a
few training steps on the card against the same on the CPU, the serving
engine's compiled ticks against the direct steps (bit for bit), and the
recurrentgemma kernels and steps: the RG-LRU scan (bit for bit against its
plain version, on both routes, at the edges of the tma kernel's ring and
boxes), the flash forward and the contiguous decode at MQA with
head_dim 256, and ``lm.prefill`` / ``lm.decode_step`` of a small recurrent
model; and the xLSTM ones: the chunkwise mLSTM (h and its final state, at
small and full head dim, ragged S, every dtype; its wgmma route against
its simt route and the plain version; its backward kernel against the
closed form ``ref.mlstm_chunkwise_bwd_ref`` on both routes, and on its
wgmma route against its algorithm ``ref.mlstm_chunkwise_bwd_split_ref``)
and the serving steps of a small
xLSTM; the head's rmsnorm_gemm on its wgmma route against the tile route
and the plain version.
Tolerances: the reference's ``tol_for`` (3e-2 for 16-bit outputs, one
rounding flip; 2e-4 for f32, summation order), with TF32 off in the plain
versions.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import DataConfig, DataPipeline
from repro_torch.kernels import decode_attention as kdecode
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import mlstm as kmlstm
from repro_torch.kernels import norm_gemm as knorm
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rglru as krglru
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  paged_decode_attention)
from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                 flash_attention_fwd)
from repro_torch.kernels.mlstm import mlstm_chunkwise
from repro_torch.kernels.norm_gemm import rmsnorm_gemm
from repro_torch.kernels.rglru import rglru_scan
from repro_torch.kernels import sma_gemm as kgemm
from repro_torch.kernels.sma_gemm import sma_gemm
from repro_torch.launch.train import TrainLoopConfig, train
from repro_torch.models import lm
from repro_torch.serving import CacheConfig, PagedKVCache, ServeEngine
from repro_torch.serving import model as smodel
from repro_torch.tree import leaves

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


def _routes_of(fn):
    """``sma_gemm.routes`` gained by ``fn()``."""
    before = dict(sma_gemm.routes)
    fn()
    return {r: n - before[r] for r, n in sma_gemm.routes.items()
            if n != before[r]}


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("m,k,n", [(65, 72, 136), (200, 2056, 392),
                                   (8192, 2048, 5632), (129, 40, 8),
                                   (17, 64, 200)])
def test_sma_gemm_wgmma_route_ragged(dev, dtype, m, k, n):
    """TMA + wgmma: ragged M, N and K past the 128 x 128 x 64 tiles (N over
    several 64-column boxes with a ragged last one), every epilogue with
    bias."""
    dt = DTYPES[dtype]
    a = randn((m, k), dt, dev, 20)
    b = randn((k, n), dt, dev, 21, scale=k ** -0.5)
    bias = randn((n,), torch.float32, dev, 22)
    for ep in ("none", "relu", "gelu", "silu", "tanh"):
        routes = _routes_of(lambda: close(
            sma_gemm(a, b, bias=bias, epilogue=ep),
            ref.gemm_ref(a, b, bias=bias, epilogue=ep), dt))
        assert routes == {"wgmma": 1}


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("m", [1, 8, 16])
@pytest.mark.parametrize("k", [64, 2048, 5632])
@pytest.mark.parametrize("n", [72, 2048])
def test_sma_gemm_splitk_route(dev, dtype, m, k, n):
    """Split-K at decode sizes: K slices summed in fixed order, bias and an
    epilogue after the sum."""
    dt = DTYPES[dtype]
    a = randn((m, k), dt, dev, 23)
    b = randn((k, n), dt, dev, 24, scale=k ** -0.5)
    bias = randn((n,), torch.float32, dev, 25)
    for ep in ("none", "silu"):
        routes = _routes_of(lambda: close(
            sma_gemm(a, b, bias=bias, epilogue=ep),
            ref.gemm_ref(a, b, bias=bias, epilogue=ep), dt))
        assert routes == {"splitk": 1}
    got = sma_gemm(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, sma_gemm(a, b))   # no atomics: bit for bit


@pytest.mark.parametrize("dtype,m,k,n,offset,route", [
    ("float32", 300, 64, 64, 0, "f32"), ("float32", 4, 64, 64, 0, "f32"),
    ("bfloat16", 37, 70, 50, 0, "tile"), ("bfloat16", 8, 72, 50, 0, "tile"),
    ("float16", 20, 72, 40, 1, "tile"), ("bfloat16", 16, 64, 64, 0, "splitk"),
    ("bfloat16", 17, 64, 64, 0, "wgmma")])
def test_sma_gemm_routes_on_card(dev, dtype, m, k, n, offset, route):
    """Each route, read from ``sma_gemm.routes``: f32 on the CUDA cores,
    what TMA cannot take (K or N not a multiple of 8, an offset base) on the
    tile kernel, split-K at M <= 16, wgmma above."""
    dt = DTYPES[dtype]
    a = randn((m, k), dt, dev, 26, offset=offset)
    b = randn((k, n), dt, dev, 27, scale=k ** -0.5)
    assert _routes_of(lambda: close(sma_gemm(a, b), ref.gemm_ref(a, b),
                                    dt)) == {route: 1}


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


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("m,k,n", [(17, 2048, 100352), (2048, 2048, 100352),
                                   (8192, 2048, 100352), (300, 2048, 1000),
                                   (100, 136, 200)])
def test_rmsnorm_gemm_wgmma_route(dev, dtype, m, k, n):
    """The wgmma route (the norm applied in the kernel to each resident A
    stage) against the plain version at ``tol`` and against the tile route
    on the same inputs: both round x * r * scale to the dtype and sum f32
    products, so they agree to one rounding flip; N = 1000 is ragged
    against the 128-column tiles, K = 136 against the 64-deep stages.  The
    route is read from ``rmsnorm_gemm.routes``."""
    dt = DTYPES[dtype]
    x = randn((m, k), dt, dev, 28, scale=3.0)
    scale = randn((k,), torch.float32, dev, 29).abs() + 0.5
    w = randn((k, n), dt, dev, 30, scale=k ** -0.5)
    ops.reset_counts()
    got = rmsnorm_gemm(x, scale, w)
    assert knorm.ROUTES == {"wgmma": 1, "tile": 0, "f32": 0}
    r = ref.rms_inverse(x).reshape(m)
    tile, route = knorm._launch(x, r, scale, w, route="tile")
    assert route == "tile"
    close(got, ref.rmsnorm_gemm_ref(x, scale, w), dt)
    close(got, tile, dt)


def test_rmsnorm_gemm_routes_on_card(dev):
    """Decode heads (M <= 16) on the tile kernel, the training head on
    wgmma, f32 on the CUDA-core kernel."""
    k, n = 2048, 1024
    scale = randn((k,), torch.float32, dev, 31).abs() + 0.5
    for m, dt, route in ((8, torch.bfloat16, "tile"),
                         (16, torch.float16, "tile"),
                         (8192, torch.bfloat16, "wgmma"),
                         (64, torch.float32, "f32")):
        x = randn((m, k), dt, dev, 32, scale=3.0)
        w = randn((k, n), dt, dev, 33, scale=k ** -0.5)
        ops.reset_counts()
        close(rmsnorm_gemm(x, scale, w), ref.rmsnorm_gemm_ref(x, scale, w),
              dt)
        assert {r: c for r, c in knorm.ROUTES.items() if c} == {route: 1}


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


def _split_lens(cap, splits):
    """0, 1, a split boundary and one either side, fewer positions than
    splits, into the last split, the full cache."""
    chunk = -(-cap // splits)
    return [0, 1, chunk - 1, chunk, chunk + 1, splits - 1,
            (splits - 1) * chunk + 1, cap]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("hq,hkv,d", [(10, 1, 256), (8, 2, 64),
                                      (32, 32, 64)])
def test_split_kv_decode_at_split_lengths(dev, dtype, hq, hkv, d):
    """Both entries at the lengths where a split can go wrong, against the
    plain versions and against the split-then-merge reference."""
    dt = DTYPES[dtype]
    bs, mb = 16, 32
    cap = bs * mb
    lens = _split_lens(cap, kdecode._splits(8, hkv, cap))
    b = len(lens)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = randn((b, hq, d), dt, dev, 60)
    kc = randn((b, hkv, cap, d), dt, dev, 61)
    vc = randn((b, hkv, cap, d), dt, dev, 62)
    got = decode_attention(q, kc, vc, kv_len)
    close(got, ref.decode_attention_ref(q, kc, vc, kv_len), dt)
    close(got, ref.decode_attention_split_ref(
        q, kc, vc, kv_len, kdecode._splits(b, hkv, cap)), dt)
    assert got[0].abs().max().item() == 0.0
    # The same caches as a shuffled paged pool: request r's page p is block
    # perm[r * mb + p].
    perm = torch.from_numpy(np.random.default_rng(63).permutation(b * mb))
    table = perm.reshape(b, mb).to(dev, torch.int32)
    pool = torch.empty((b * mb, hkv, bs, d), dtype=dt, device=dev)
    vpool = torch.empty_like(pool)
    pages = kc.reshape(b, hkv, mb, bs, d).transpose(1, 2)
    pool[table.long().reshape(-1)] = pages.reshape(b * mb, hkv, bs, d)
    vpool[table.long().reshape(-1)] = vc.reshape(b, hkv, mb, bs, d) \
        .transpose(1, 2).reshape(b * mb, hkv, bs, d)
    paged = paged_decode_attention(q, pool, vpool, table, kv_len)
    close(paged, ref.paged_decode_attention_ref(q, pool, vpool, table,
                                                kv_len), dt)
    close(paged, got, dt)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("hq,hkv,d", [(10, 1, 256), (4, 2, 64)])
def test_decode_lse_route_matches_plain(dev, dtype, hq, hkv, d):
    """``decode_attention(return_lse=True)`` launches the kernel (its
    ``lse`` route counted) and gives the plain version's f32 output and
    log-sum-exp at the split lengths, -inf and 0 at length 0; two halves
    merged (``context_parallel.fold``) give the whole cache's."""
    from repro_torch.distributed import context_parallel as cpar
    dt = DTYPES[dtype]
    cap = 512
    lens = _split_lens(cap, kdecode._splits(8, hkv, cap))
    b = len(lens)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = randn((b, hq, d), dt, dev, 70)
    kc = randn((b, hkv, cap, d), dt, dev, 71)
    vc = randn((b, hkv, cap, d), dt, dev, 72)
    before = dict(kdecode.ROUTES)
    out, lse = decode_attention(q, kc, vc, kv_len, return_lse=True)
    assert kdecode.ROUTES["lse"] == before["lse"] + 1
    want, want_lse = ref.decode_attention_ref(q, kc, vc, kv_len,
                                              return_lse=True)
    assert out.dtype == lse.dtype == torch.float32
    close(out, want, dt)
    torch.cuda.synchronize()
    assert torch.all(lse[0] == -float("inf")) and torch.all(out[0] == 0)
    torch.testing.assert_close(lse[1:], want_lse[1:], rtol=1e-5, atol=1e-4)
    half = cap // 2
    parts = cpar.local_lengths(kv_len - 1, cap, None, 2).to(torch.int32)
    pairs = [decode_attention(q, kc[:, :, r * half:(r + 1) * half]
                              .contiguous(),
                              vc[:, :, r * half:(r + 1) * half].contiguous(),
                              parts[r], return_lse=True) for r in range(2)]
    merged = cpar.fold([o for o, _ in pairs], [l for _, l in pairs])
    close(merged, out, dt)


def test_split_kv_decode_poisons_in_any_split(dev):
    """A sentinel entry below kv_len in the last split (not the first) still
    makes that request's output NaN after the merge; ragged neighbours are
    unchanged."""
    dt = torch.bfloat16
    bs, mb = 16, 64
    b, hkv, nb = 4, 2, 4 * 64
    splits = kdecode._splits(b, hkv, bs * mb)
    assert splits > 2
    table = torch.arange(b * mb, dtype=torch.int32, device=dev).reshape(b, mb)
    table[1, mb - 1] = nb                          # the last page
    table[2, mb // 2] = -1                         # a middle page
    kv_len = torch.tensor([300, mb * bs, mb * bs, 17], dtype=torch.int32,
                          device=dev)
    q = randn((b, 8, 64), dt, dev, 64)
    kp = randn((nb, hkv, bs, 64), dt, dev, 65)
    vp = randn((nb, hkv, bs, 64), dt, dev, 66)
    got = paged_decode_attention(q, kp, vp, table, kv_len)
    torch.cuda.synchronize()
    assert torch.isnan(got[1:3]).all()
    keep = torch.tensor([0, 3], device=dev)
    close(got[keep], ref.paged_decode_attention_ref(
        q[keep], kp, vp, table[keep], kv_len[keep]), dt)


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
        state = smodel.init_state(cfg, 3, cc, device=where)
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


def test_compiled_serving_ticks_equal_direct_on_card(dev):
    """A 2-layer model at StableLM-2-1.6B's full width in bf16: the
    engine's compiled prefill tick (4 ragged rows, chunk 64) and two decode
    ticks, against the direct steps on the same inputs: logits, returned
    lengths and the pools' real blocks ``torch.equal``, each tick with the
    same launches, ``sma_gemm`` / ``rmsnorm_gemm`` routes and routed
    calls."""
    cfg = dataclasses.replace(get_config("stablelm-1.6b"), num_groups=2)
    cc = CacheConfig(block_size=16, num_blocks=64, max_seq_len=256)
    kv = PagedKVCache(cc, 4)
    for r, n in enumerate((64, 17, 40, 1)):
        assert kv.admit(r, n, 4)
    table = torch.from_numpy(kv.table_rows([0, 1, 2, 3])).to(dev)
    toks = torch.from_numpy(np.random.default_rng(21).integers(
        0, cfg.vocab_size, (4, 64)).astype(np.int32)).to(dev)
    n_tok = torch.tensor([64, 17, 40, 1], dtype=torch.int32, device=dev)

    def counted(fn, *args):
        ops.reset_counts()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, ({k: n for k, n in ops.launch_counts().items() if n},
                     dict(kgemm.ROUTES), dict(knorm.ROUTES), dict(ops.ROUTED))

    def run(prefill, decode):
        state = smodel.init_state(cfg, 4, cc, device=dev)
        zero = torch.zeros(4, dtype=torch.int32, device=dev)
        (logits, _, cl), seen = counted(prefill, params, state, table, zero,
                                        n_tok, {"tokens": toks})
        outs = [(logits.clone(), cl.clone(), seen,
                 [p[:, :cc.num_blocks].clone() for e in state
                  for p in e.values()])]
        for _ in range(2):
            nxt = logits.argmax(-1, keepdim=True).to(torch.int32)
            (logits, _, cl), seen = counted(decode, params, state, table,
                                            cl.to(torch.int32),
                                            {"tokens": nxt})
            outs.append((logits.clone(), cl.clone(), seen,
                         [p[:, :cc.num_blocks].clone() for e in state
                          for p in e.values()]))
        return outs

    with torch.inference_mode():
        params = lm.init(cfg, seed=0, device=dev)
        eng = ServeEngine(cfg, params, cache=cc, max_batch=4, device=dev)
        got = run(eng.engines["prefill"], eng.engines["decode"])
        want = run(lambda p, s, bt, cl, nt, b: smodel.paged_prefill_step(
                       p, s, bt, cl, nt, cfg, b),
                   lambda p, s, bt, cl, b: smodel.paged_decode_step(
                       p, s, bt, cl, cfg, b))
    assert [e.stats.misses for e in eng.engines.values()] == [1, 1]
    for (gl, gc, gseen, gp), (wl, wc, wseen, wp) in zip(got, want):
        assert torch.isfinite(gl.float()).all()
        assert torch.equal(gl, wl) and torch.equal(gc, wc)
        assert all(torch.equal(g, w) for g, w in zip(gp, wp))
        assert gseen == wseen
    assert got[0][2][0] == {"sma_gemm": 14, "rmsnorm_gemm": 1}
    assert sum(got[0][2][3].values()) == 2          # chunked prefill routed
    assert got[1][2][0] == {"sma_gemm": 14, "rmsnorm_gemm": 1,
                            "paged_decode_attention": 2}


def _to(tree, device, clone=False):
    if isinstance(tree, dict):
        return {k: _to(v, device, clone) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to(v, device, clone) for v in tree)
    return tree.detach().clone().to(device) if clone else tree.to(device)


# ------------------------------------------------------- flash attention
FLASH_CASES = [
    (2, 4, 4, 256, 256, 64, True, None),
    (1, 8, 2, 200, 200, 64, True, None),     # GQA, ragged S
    (1, 4, 1, 192, 192, 128, True, 64),      # MQA, head_dim 128, window
    (1, 2, 2, 130, 130, 64, False, None),    # non-causal, ragged
    (1, 4, 4, 64, 256, 64, True, None),      # Sq < Skv, end-aligned
    (1, 2, 2, 100, 40, 64, True, None),      # Sq > Skv: rows see no key
    # the wgmma kernels' tile edges: 128 query rows and 128 keys a forward
    # block (64 keys at D 256), 128 keys and 64-row query tiles backward
    (1, 2, 2, 1, 1, 64, True, None),         # S 1
    (1, 2, 2, 127, 127, 64, True, None),     # one short of a tile
    (1, 2, 2, 129, 129, 128, True, None),    # one past it
    (1, 2, 1, 257, 257, 64, True, None),     # one past two
    (1, 4, 4, 100, 300, 64, True, None),     # Sq < Skv across a key edge
    (1, 2, 2, 300, 300, 64, True, 16),       # window 16
    (1, 2, 2, 600, 600, 128, True, 200),     # window starts mid-tile
    (1, 8, 2, 300, 300, 128, True, None),    # GQA group 4 at D 128
]


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", FLASH_CASES)
def test_flash_matches_plain(dev, dtype, b, hq, hkv, sq, skv, d, causal,
                             window):
    """Forward (out, lse) and backward (dq, dk, dv) kernels against the
    plain versions on the same inputs, at the 16-bit tol_for (P is rounded
    to the input dtype for the tensor-core products; dQ is summed with
    reduce-adds in no fixed order)."""
    dt = DTYPES[dtype]
    q = randn((b, hq, sq, d), dt, dev, 20)
    k = randn((b, hkv, skv, d), dt, dev, 21)
    v = randn((b, hkv, skv, d), dt, dev, 22)
    dout = randn((b, hq, sq, d), dt, dev, 23)
    kw = dict(causal=causal, window=window)
    out, lse = flash_attention_fwd(q, k, v, **kw)
    want, want_lse = ref.flash_attention_ref(q, k, v, **kw)
    close(out, want, dt)
    torch.testing.assert_close(lse, want_lse, rtol=1e-3, atol=1e-3)
    grads = flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    wants = ref.flash_attention_bwd_ref(q, k, v, want, want_lse, dout, **kw)
    for got, w in zip(grads, wants):
        close(got, w, dt)
    if sq > skv:
        torch.testing.assert_close(out[:, :, :sq - skv].float(),
                                   torch.zeros_like(out[:, :, :sq - skv],
                                                    dtype=torch.float32))


def test_flash_routes_as_recorded(dev):
    """Each launch counts into its route (:func:`_route`): a forward at
    every head_dim and a backward at 64 and 128 all take ``wgmma``; the
    library sizes each kernel's shared memory (the D 256 backward's two
    passes each) as ``smem_bytes`` says."""
    ops.reset_counts()
    for d in kflash.FWD_HEAD_DIMS:
        q = randn((1, 2, 130, d), torch.bfloat16, dev, 24)
        out, lse = flash_attention_fwd(q, q, q)
        if d in kflash.BWD_HEAD_DIMS:
            flash_attention_bwd(q, q, q, out, lse, q)
    torch.cuda.synchronize()
    assert kflash.FWD_ROUTES == {"wgmma": len(kflash.FWD_HEAD_DIMS)}
    assert kflash.BWD_ROUTES == {"wgmma": len(kflash.BWD_HEAD_DIMS)}
    assert ops.launch_counts()["flash_attention"] == 3
    lib = kflash._lib()
    for d in kflash.FWD_HEAD_DIMS:
        assert lib.flash_attention_smem(d, 0) == kflash.smem_bytes(d)
    for d in kflash.BWD_HEAD_DIMS:
        assert lib.flash_attention_smem(d, 1) == kflash.smem_bytes(d, True)
    assert lib.flash_attention_smem(256, 2) == kflash.smem_bytes(
        256, True, dq_pass=True)


def test_flash_refuses_what_it_does_not_take(dev):
    q = torch.zeros((1, 2, 8, 64), dtype=torch.float32, device=dev)
    with pytest.raises(ValueError, match="bf16/f16"):
        flash_attention_fwd(q, q, q)
    q = torch.zeros((1, 2, 8, 32), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_fwd(q, q, q)


# ------------------------------------------- gradients through the wrappers
def _grads(fn, leaves_):
    for t in leaves_:
        t.grad = None
    fn().float().square().sum().backward()
    return [t.grad.clone() for t in leaves_]


def test_weights_get_gradients_through_cuda_wrappers(dev):
    """A weight that requires grad gets a .grad through each kernel entry
    point on the card (the wrappers write through ctypes and would cut the
    graph without their autograd Functions), equal to the gradient through
    the plain versions within the 16-bit tolerance."""
    dt = torch.bfloat16
    x = randn((3, 70, 128), dt, dev, 30).requires_grad_()
    w32 = randn((128, 96), torch.float32, dev, 31, scale=128 ** -0.5)
    w32.requires_grad_()
    bias = randn((96,), torch.float32, dev, 32).requires_grad_()
    scale = (randn((128,), torch.float32, dev, 33).abs() + 0.5)
    scale.requires_grad_()
    cases = {
        "sma_gemm": (lambda: ops.sma_gemm(x, w32.to(dt), bias=bias,
                                          epilogue="silu"),
                     lambda: ref.gemm_ref(x, w32.to(dt), bias=bias,
                                          epilogue="silu"),
                     [x, w32, bias]),
        "rmsnorm_gemm": (lambda: ops.rmsnorm_gemm(x, scale, w32.to(dt)),
                         lambda: ref.rmsnorm_gemm_ref(x, scale, w32.to(dt)),
                         [x, scale, w32]),
    }
    q = randn((2, 4, 128, 64), dt, dev, 34).requires_grad_()
    kv = randn((2, 2, 128, 64), dt, dev, 35).requires_grad_()
    cases["flash_attention"] = (
        lambda: ops.flash_attention(q, kv, kv * 0.5),
        lambda: ref.flash_attention_ref(q, kv, kv * 0.5)[0], [q, kv])
    # Launches of one forward and backward: sma_gemm with silu runs the
    # forward, Z again, dA and dB; rmsnorm_gemm's dW and dnormed are
    # sma_gemm launches.
    launches = {"sma_gemm": {"sma_gemm": 4},
                "rmsnorm_gemm": {"rmsnorm_gemm": 1, "sma_gemm": 2},
                "flash_attention": {"flash_attention": 1,
                                    "flash_attention_bwd": 1}}
    for name, (kernel, plain, ins) in cases.items():
        ops.reset_counts()
        got = _grads(kernel, ins)
        counts = {k: n for k, n in ops.launch_counts().items() if n}
        assert counts == launches[name], (name, counts)
        want = _grads(plain, ins)
        for g, w in zip(got, want):
            assert g is not None and g.abs().sum() > 0, name
            scale_ = w.float().abs().max().item()
            torch.testing.assert_close(g.float() / scale_,
                                       w.float() / scale_, rtol=3e-2,
                                       atol=3e-2)


def test_train_steps_on_card_match_cpu(dev):
    """A small bf16 model with head_dim 64 (the flash kernel's), on the
    card (kernels) and on the CPU (plain versions) from the same masters:
    one step's loss within 1e-3 and every weight's gradient within 3e-2
    relative (Frobenius), one step's launches as predicted, and the losses
    of 3 trained steps within 2e-2 relative (bf16 outputs of every product,
    rounded in other orders)."""
    cfg = dataclasses.replace(reduced(get_config("stablelm-1.6b")),
                              d_model=128, num_heads=2, num_kv_heads=2,
                              head_dim=64, d_ff=256, dtype="bfloat16")
    loop = TrainLoopConfig(steps=3, seq_len=96, global_batch=2,
                           log_every=1, remat=True)
    masters = lm.init(cfg, seed=0, device="cpu",
                      dtype=cfg.parameter_dtype)

    def copy(where):
        return _to(masters, where, clone=True)

    def step_grads(where):
        params = copy(where)
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        batch = next(DataPipeline(DataConfig(
            cfg.vocab_size, loop.seq_len, loop.global_batch,
            seed=loop.seed), device=where))
        loss, _ = lm.loss_fn(params, cfg, batch, remat=True)
        grads = torch.autograd.grad(loss, flat)
        return loss.item(), [g.float().cpu() for g in grads]

    want_loss, want_grads = step_grads(torch.device("cpu"))
    got_loss, got_grads = step_grads(dev)
    assert abs(got_loss - want_loss) <= 1e-3 * abs(want_loss)
    for i, (g, w) in enumerate(zip(got_grads, want_grads)):
        assert w.norm() > 0 and g.norm() > 0, i
        assert ((g - w).norm() / w.norm()).item() <= 3e-2, i

    want = train(cfg, loop, device="cpu", params=copy("cpu"))
    ops.reset_counts()
    train(cfg, dataclasses.replace(loop, steps=1), device=dev,
          params=copy(dev))
    layers = cfg.num_layers
    # train() runs the compiled step: the direct step's 29 sma_gemm a
    # layer but each remat group's recomputed MLP wo, which nothing reads.
    assert ops.launch_counts() == {
        "sma_gemm": 28 * layers + 2, "rmsnorm_gemm": 1,
        "flash_attention": 2 * layers, "flash_attention_bwd": layers,
        "paged_decode_attention": 0, "decode_attention": 0,
        "rglru_scan": 0, "rglru_scan_bwd": 0, "mlstm_chunkwise": 0,
        "mlstm_chunkwise_bwd": 0}
    assert not ops.ROUTED
    got = train(cfg, loop, device=dev, params=copy(dev))
    np.testing.assert_allclose([h["loss"] for h in got["history"]],
                               [h["loss"] for h in want["history"]],
                               rtol=2e-2)


def _names(tree, prefix=""):
    """Leaf names in :func:`leaves` order (``blocks.0.mixer.wq``)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _names(tree[k],
                                                        f"{prefix}{k}.")]
    if isinstance(tree, (tuple, list)):
        return [x for i, t in enumerate(tree)
                for x in _names(t, f"{prefix}{i}.")]
    return [prefix[:-1]]


def _pieces(names, grads):
    """Each gradient by name, the stacked block leaves a layer at a time
    (``blocks.0.mixer.wq[1]``)."""
    out = {}
    for name, g in zip(names, grads):
        if name.startswith("blocks."):
            out.update({f"{name}[{i}]": x for i, x in enumerate(g)})
        else:
            out[name] = g
    return out


def _rel(got, want):
    return ((got.float() - want.float()).norm()
            / want.float().norm().clamp_min(1e-30)).item()


def test_compiled_train_step_matches_direct_on_card(dev):
    """The loss and gradients of a step compiled through sma_jit against
    the direct step, two full-width StableLM layers, S 2048 x B 4, remat:
    the loss torch.equal, the head's and the top layer's MLP gradients
    torch.equal (no flash dQ upstream of them), every other gradient
    within max(2 x the direct step's own run-to-run spread, 1e-2) relative
    (Frobenius, a layer at a time: the flash backward sums dQ in no fixed
    order); the same launches and routes but each remat group's
    recomputed MLP wo, which nothing reads."""
    from repro_torch import sma_jit
    from repro_torch.tree import tree_map
    n = 2
    cfg = dataclasses.replace(get_config("stablelm-1.6b"), num_groups=n)
    params = lm.init(cfg, seed=0, device=dev, dtype=cfg.parameter_dtype)
    names = _names(params)
    batch = next(DataPipeline(DataConfig(cfg.vocab_size, 2048, 4, seed=0),
                              device=dev))

    def loss_and_grads(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, _ = lm.loss_fn(live, cfg, batch, remat=True)
        return loss.detach(), torch.autograd.grad(loss, leaves(live))

    def run(fn):
        ops.reset_counts()
        loss, grads = fn(params, batch)
        torch.cuda.synchronize()
        routes = (dict(kgemm.ROUTES), dict(knorm.ROUTES),
                  dict(kflash.FWD_ROUTES), dict(kflash.BWD_ROUTES))
        return loss, _pieces(names, grads), ops.launch_counts(), routes

    eng = sma_jit(loss_and_grads)
    eng(params, batch)
    want, again, got = run(loss_and_grads), run(loss_and_grads), run(eng)
    assert torch.equal(got[0], want[0])
    assert want[2]["sma_gemm"] == 29 * n + 2
    assert got[2] == dict(want[2], sma_gemm=28 * n + 2)
    assert not ops.ROUTED
    assert got[3][0] == {**want[3][0], "wgmma": 28 * n + 2}
    assert got[3][1:] == want[3][1:]
    for name in ["head.w"] + [f"blocks.0.ffn.{k}[{n - 1}]"
                              for k in ("wg", "wi", "wo")]:
        assert torch.equal(got[1][name], want[1][name]), name
    multiples = {name: _rel(got[1][name], w)
                 / max(2 * _rel(again[1][name], w), 1e-2)
                 for name, w in want[1].items()}
    assert max(multiples.values()) <= 1.0, multiples


# ------------------------------------------------------------ recurrentgemma
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,s,d,h0", [(2, 100, 96, True), (1, 257, 130, False),
                                      (3, 33, 2568, True), (1, 1, 7, False)])
def test_rglru_scan_matches_plain_bit_for_bit(dev, dtype, b, s, d, h0,
                                              record_property):
    """The kernel rounds a product and a sum to f32 at each step, as the
    plain version's separate tensor ops do: h_seq and h_last are equal,
    not only close.  Ragged S (past the 32-step chunks) and D; each case
    records its route, the one ``_route`` picks (D 7 and 130 in 16 bits
    and f32 are strides TMA refuses: ``simt``; the rest ``tma``)."""
    dt = DTYPES[dtype]
    a = torch.sigmoid(randn((b, s, d), torch.float32, dev, 40)).to(dt)
    u = randn((b, s, d), dt, dev, 41, scale=0.1)
    h = randn((b, d), dt, dev, 42) if h0 else None
    ops.reset_counts()
    got = rglru_scan(a, u, h)
    torch.cuda.synchronize()
    assert ops.launch_counts()["rglru_scan"] == 1
    route = krglru._route(b, s, d, dt, True)
    record_property("route", route)
    assert _rglru_routes() == {route: 1}
    want = ref.rglru_scan_ref(a, u, h)
    for g, w in zip(got, want):
        assert g.dtype == dt
        assert torch.equal(g, w), (g.float() - w.float()).abs().max()


def _rglru_routes():
    return {r: n for r, n in krglru.ROUTES.items() if n}


def _scan_inputs(b, s, d, dt, dev, h0, offset=0):
    a = torch.sigmoid(randn((b, s, d), torch.float32, dev, s + d)).to(dt)
    if offset:
        a = randn((b, s, d), dt, dev, 0, offset=offset).copy_(a)
    u = randn((b, s, d), dt, dev, s + d + 1, scale=0.1, offset=offset)
    h = randn((b, d), dt, dev, s + d + 2) if h0 else None
    return a, u, h


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("h0", [True, False])
@pytest.mark.parametrize("b,s,d", [(2, 20, 2560),    # S below one stage
                                   (1, 1, 2560),     # one step
                                   (1, 4097, 2560),  # S past the stages
                                   (2, 300, 2568),   # D ragged to the block
                                   (2, 300, 2536),
                                   (4, 4096, 2560)])  # the prefill's shape
def test_rglru_scan_tma_route_bit_for_bit(dev, dtype, h0, b, s, d):
    """The tma kernel, on the edges of its ring and its boxes: the ragged
    S (zero-filled past S, the chain stopping at S - 1), D not a multiple
    of the 128-channel block (zero-filled, stores clipped), S = 1 and S
    below one stage; equal to the plain version, not only close."""
    dt = DTYPES[dtype]
    a, u, h = _scan_inputs(b, s, d, dt, dev, h0)
    ops.reset_counts()
    got = rglru_scan(a, u, h)
    torch.cuda.synchronize()
    assert _rglru_routes() == {"tma": 1}
    want = ref.rglru_scan_ref(a, u, h)
    for g, w in zip(got, want):
        assert g.dtype == dt and g.shape == w.shape
        assert torch.equal(g, w), (g.float() - w.float()).abs().max()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rglru_scan_offset_base_routes_to_simt(dev, dtype):
    """a and u one element into their buffers: TMA refuses the base, the
    simt kernel takes it, bit for bit."""
    dt = DTYPES[dtype]
    a, u, h = _scan_inputs(2, 100, 2560, dt, dev, True, offset=1)
    assert a.data_ptr() % 16 and u.data_ptr() % 16
    assert krglru._route(2, 100, 2560, dt, False) == "simt"
    ops.reset_counts()
    got = rglru_scan(a, u, h)
    torch.cuda.synchronize()
    assert _rglru_routes() == {"simt": 1}
    for g, w in zip(got, ref.rglru_scan_ref(a, u, h)):
        assert torch.equal(g, w)


def test_rglru_scan_routes_on_card(dev):
    """Over a run of calls, the route counts are _route's choices."""
    cases = [((4, 64, 2560), torch.bfloat16), ((1, 33, 7), torch.bfloat16),
             ((1, 33, 130), torch.float16), ((2, 9, 96), torch.float32),
             ((2, 9, 130), torch.float32), ((1, 70, 2568), torch.float16)]
    ops.reset_counts()
    want = {"tma": 0, "simt": 0}
    for (b, s, d), dt in cases:
        a, u, h = _scan_inputs(b, s, d, dt, dev, False)
        rglru_scan(a, u, h)
        want[krglru._route(b, s, d, dt, True)] += 1
    torch.cuda.synchronize()
    assert krglru.rglru_scan.routes == want == {"tma": 3, "simt": 3}
    assert ops.launch_counts()["rglru_scan"] == len(cases)


def test_rglru_scan_tma_shared_memory_fits_a_block(dev):
    """The built tma kernel's dynamic shared memory, within the 227 KB a
    block may use, and its ring deep enough for the planted faults."""
    for dt in DTYPES.values():
        tile = krglru.tma_tile(dt)
        assert 0 < tile["smem_bytes"] <= 232448
        assert tile["rows"] >= 16 and tile["stages"] >= 2


def test_rglru_scan_refuses_a_gradient_on_card(dev):
    """The scans refused a gradient on the card until their backward
    kernels; now a gradient through ``ops.rglru_scan`` launches
    ``rglru_scan_bwd`` once, and one through ``ops.mlstm_chunkwise``
    ``mlstm_chunkwise_bwd`` once."""
    a = torch.full((1, 4, 8), 0.5, device=dev, requires_grad=True)
    u = torch.ones((1, 4, 8), device=dev)
    ops.reset_counts()
    h_seq, _ = ops.rglru_scan(a, u)
    (da,) = torch.autograd.grad(h_seq.sum(), [a])
    torch.cuda.synchronize()
    assert ops.launch_counts()["rglru_scan_bwd"] == 1
    want = ref.rglru_scan_bwd_ref(a.detach(), h_seq.detach(),
                                  torch.ones_like(h_seq))[0]
    assert torch.equal(da, want)
    q = torch.zeros((1, 1, 4, 8), device=dev, requires_grad=True)
    f = torch.zeros((1, 1, 4), device=dev)
    (dq,) = torch.autograd.grad(
        ops.mlstm_chunkwise(q, q, q, f, f, chunk=4).sum(), [q])
    torch.cuda.synchronize()
    assert ops.launch_counts()["mlstm_chunkwise_bwd"] == 1
    assert torch.isfinite(dq).all()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,s,d,h0,last", [
    (2, 4096, 2560, False, False),   # RecurrentGemma's training call
    (2, 100, 256, True, True), (1, 1, 128, True, False),
    (3, 77, 130, True, True), (1, 257, 7, False, True)])
def test_rglru_scan_bwd_matches_plain_bit_for_bit(dev, dtype, b, s, d, h0,
                                                  last):
    """The reverse-scan kernel rounds each product and sum to f32 as the
    plain version's tensor ops do: da, du and dh0 equal, on the route
    ``_route`` picks and on ``simt``."""
    dt = DTYPES[dtype]
    a = torch.rand((b, s, d), device=dev).to(dt)
    u = randn((b, s, d), dt, dev, 1)
    hh0 = randn((b, d), dt, dev, 2) if h0 else None
    dh = randn((b, s, d), dt, dev, 3)
    dl = randn((b, d), dt, dev, 4) if last else None
    hs = rglru_scan(a, u, hh0)[0]
    want = ref.rglru_scan_bwd_ref(a, hs, dh, hh0, dl)
    before = dict(krglru.BWD_ROUTES)
    got = krglru.rglru_scan_bwd(a, hs, dh, hh0, dl)
    simt = krglru._run_bwd(a, hs, dh, hh0, dl, "simt")
    torch.cuda.synchronize()
    route = krglru._route(b, s, d, dt, True)
    assert krglru.BWD_ROUTES[route] == before[route] + 1
    for g, sm, w in zip(got, simt, want):
        if w is None:
            assert g is None and sm is None
            continue
        assert torch.equal(g, w) and torch.equal(sm, w)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,causal,window", [
    (2, 10, 1, 1024, 1024, True, 256),     # RecurrentGemma's MQA, windowed
    (1, 4, 2, 300, 300, True, None),       # GQA, ragged S
    (1, 2, 2, 200, 260, False, None),      # Sq < Skv, no mask
    (2, 4, 1, 130, 130, True, 64),
    (1, 4, 2, 130, 333, True, 100)])       # Sq < Skv, windowed
def test_flash_backward_head_dim_256(dev, dtype, b, hq, hkv, sq, skv,
                                     causal, window):
    """The D 256 backward (two passes: dK, dV and the banded dS scratch,
    then dQ summed over key tiles in ascending order) against
    ``flash_attention_bwd_ref`` fed the kernel's out and lse: max |err|
    within 2e-2 of each gradient's largest value (``chip_smoke.py``'s
    FLASH_GRAD_LIMIT; dropping one key tile reads ~0.03 on dv at
    RecurrentGemma's shape); against its algorithm
    ``ref.flash_attention_bwd256_split_ref`` (the same passes, sums and
    roundings) within one ulp of the dtype (``torch.finfo(dtype).eps``:
    2^-7 bf16, 2^-10 f16) of each gradient's largest value, as both round
    to the dtype f32 sums that differ only in their order inside a
    product, a flip of at most one ulp of a value no larger than the
    largest; and with no unordered add, a second call gives the same
    bits."""
    dt = DTYPES[dtype]
    q = randn((b, hq, sq, 256), dt, dev, 5)
    k = randn((b, hkv, skv, 256), dt, dev, 6)
    v = randn((b, hkv, skv, 256), dt, dev, 7)
    do = randn((b, hq, sq, 256), dt, dev, 8)
    kw = dict(causal=causal, window=window)
    out, lse = flash_attention_fwd(q, k, v, **kw)
    got = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    again = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
    split = ref.flash_attention_bwd256_split_ref(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    ulp = torch.finfo(dt).eps
    for g, a, w, sp in zip(got, again, want, split):
        assert g.shape == w.shape and torch.isfinite(g.float()).all()
        assert torch.equal(g, a)
        scale = w.float().abs().max().item()
        assert (g.float() - w.float()).abs().max().item() <= 2e-2 * scale
        assert (g.float() - sp.float()).abs().max().item() \
            <= ulp * sp.float().abs().max().item()


def test_flash_bwd256_slots_as_the_reference_counts(dev):
    """The library's slot count of the D 256 dS scratch, which the wrapper
    sizes the scratch with, is the plain layout's
    (``ref.bwd256_scratch_layout``, itself held against a brute-force count
    on the CPU) over ragged, Sq < Skv, Sq > Skv, causal, windowed and
    unmasked shapes."""
    lib = kflash._lib()
    for sq in (1, 63, 64, 65, 130, 333, 1000, 4096):
        for skv in (1, 64, 100, 130, 333, 1024, 4096):
            for causal in (False, True):
                for window in (None, 1, 64, 100, 2048):
                    want = ref.bwd256_scratch_layout(
                        sq, skv, causal=causal, window=window)[2]
                    assert lib.flash_attention_bwd256_slots(
                        sq, skv, int(causal), window or 0) == want, (
                            sq, skv, causal, window)


def test_qwen3_two_backward_passes_on_card(dev):
    """Two backward passes of a full-width 2-layer Qwen3-30B-A3B (S 512 x
    B 2, remat): the loss and every gradient no flash dQ feeds (the head,
    the final norm, the top layer's MoE FFN and norm2: the routing
    backward's gathers and the expert products included) torch.equal;
    the rest within 1e-2 relative (the flash backward's dQ order)."""
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b"), num_groups=2)
    params = lm.init(cfg, seed=0, device=dev, dtype=cfg.parameter_dtype)
    names = _names(params)
    batch = next(DataPipeline(DataConfig(cfg.vocab_size, 512, 2, seed=0),
                              device=dev))

    def run():
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, _ = lm.loss_fn(live, cfg, batch, remat=True)
        grads = torch.autograd.grad(loss, leaves(live))
        torch.cuda.synchronize()
        return loss.detach(), _pieces(names, grads)

    (l1, g1), (l2, g2) = run(), run()
    assert torch.equal(l1, l2)
    exact = ["head.w", "final_norm.scale", "blocks.0.norm2.scale[1]"] + [
        f"blocks.0.ffn.{k}[1]" for k in ("router", "wg", "wi", "wo")]
    for name in exact:
        assert torch.equal(g1[name], g2[name]), name
    assert max(_rel(g2[n], g1[n]) for n in g1) <= 1e-2


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("b,hq,sq,window", [(1, 10, 300, 128),
                                            (2, 4, 256, None),
                                            (1, 10, 64, 2048),
                                            (1, 10, 4096, 2048)])
def test_flash_forward_head_dim_256(dev, dtype, b, hq, sq, window):
    """recurrentgemma's attention: MQA (Hkv = 1), head_dim 256, windowed or
    not, ragged S; the backward at head_dim 256, which was refused until
    its own tiling, now matches its plain version."""
    dt = DTYPES[dtype]
    q = randn((b, hq, sq, 256), dt, dev, 50)
    k = randn((b, 1, sq, 256), dt, dev, 51)
    v = randn((b, 1, sq, 256), dt, dev, 52)
    out, lse = flash_attention_fwd(q, k, v, window=window)
    want, want_lse = ref.flash_attention_ref(q, k, v, window=window)
    close(out, want, dt)
    torch.testing.assert_close(lse, want_lse, rtol=1e-3, atol=1e-3)
    got = flash_attention_bwd(q, k, v, out, lse, q, window=window)
    wants = ref.flash_attention_bwd_ref(q, k, v, out, lse, q, window=window)
    torch.cuda.synchronize()
    for g, w in zip(got, wants):
        scale = w.float().abs().max().item()
        assert (g.float() - w.float()).abs().max().item() <= 2e-2 * scale


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_contiguous_decode_mqa_head_dim_256(dev, dtype):
    """g = 10 query heads on one KV head of 256 (shared memory past 48 KB,
    so the launch opts in); lengths 0, 1, a partial tile, full, and past
    Smax (clamped: every position valid, as in the plain version)."""
    dt = DTYPES[dtype]
    lens = [0, 1, 77, 300, 301]
    q = randn((len(lens), 10, 256), dt, dev, 53)
    kc = randn((len(lens), 1, 300, 256), dt, dev, 54)
    vc = randn((len(lens), 1, 300, 256), dt, dev, 55)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    got = decode_attention(q, kc, vc, kv_len)
    close(got, ref.decode_attention_ref(q, kc, vc, kv_len), dt)
    assert got[0].abs().max().item() == 0.0


# Relative (Frobenius) error of the 26-layer logits, card bf16 against CPU
# f32: on an H100 the noise reads 0.026-0.031 and the planted fault 0.071
# (CHANGES.md); the limit lies between them.
RG_CARD_LIMIT = 0.05


def test_recurrent_serving_on_card_matches_cpu(dev, monkeypatch):
    """A small recurrentgemma at the pattern's full depth (two groups, 26
    layers; head_dim 256 so the flash kernel takes it; bf16) through
    ``lm.prefill`` of 64 tokens and 2 ``lm.decode_step``s: the kernels on
    the card against the plain versions on the CPU in float32 (the same
    bf16 weights, widened), fed the same tokens, each call's logits within
    RG_CARD_LIMIT relative (Frobenius), and each call's launches as
    predicted.  The limit lies between the noise and a planted fault: bf16
    against f32 reads 0.026-0.031 (every product's output rounded to bf16,
    compounding over the layers), and the prefill with every local layer's
    window one key too narrow (its oldest key dropped) 0.071, which must
    read above it."""
    cfg = dataclasses.replace(reduced(get_config("recurrentgemma-2b")),
                              num_groups=2, d_model=128, num_heads=2,
                              head_dim=256, d_ff=256, dtype="bfloat16")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = lm.init(cfg, seed=0, device="cpu")
    params32 = _widen(params)
    toks = torch.from_numpy(np.random.default_rng(56).integers(
        0, cfg.vocab_size, (2, 64)))
    n_rglru = cfg.num_groups * cfg.block_pattern.count("rglru")
    n_local = cfg.num_groups * cfg.block_pattern.count("local")
    gemms = 8 * n_rglru + 7 * n_local
    launches = {"prefill": {"rglru_scan": n_rglru, "flash_attention": n_local,
                            "sma_gemm": gemms, "rmsnorm_gemm": 1},
                "decode": {"decode_attention": n_local, "sma_gemm": gemms,
                           "rmsnorm_gemm": 1}}

    def run(where, p, c, feed=None):
        p = _to(p, where)
        ops.reset_counts()
        logits, state, cl = lm.prefill(p, c, {"tokens": toks.to(where)},
                                       cache_size=72)
        counts = [{k: n for k, n in ops.launch_counts().items() if n}]
        outs, fed = [logits.float().cpu()], []
        for i in range(2):
            nxt = feed[i] if feed else logits.argmax(-1, keepdim=True).cpu()
            fed.append(nxt)
            ops.reset_counts()
            logits, state, cl = lm.decode_step(p, state, cl, c,
                                               {"tokens": nxt.to(where)})
            counts.append({k: n for k, n in ops.launch_counts().items()
                           if n})
            outs.append(logits.float().cpu())
        return outs, fed, counts

    want, fed, _ = run(torch.device("cpu"), params32, cfg32)
    got, _, counts = run(dev, params, cfg, fed)
    assert counts == [launches["prefill"]] + [launches["decode"]] * 2
    assert not ops.ROUTED
    errs = [((g - w).norm() / w.norm()).item() for g, w in zip(got, want)]
    fwd = kflash.flash_attention_fwd

    def narrow(q, k, v, window=None, **kw):
        return fwd(q, k, v, window=window - 1, **kw)

    # The wrapper counts on its module-level name, which now holds the
    # stand-in: give it a counter (this run's counts are not read).
    narrow.launches = 0
    monkeypatch.setattr(kflash, "flash_attention_fwd", narrow)
    bad = run(dev, params, cfg, fed)[0][0]
    fault = ((bad - want[0]).norm() / want[0].norm()).item()
    print(f"26-layer logits, card bf16 vs CPU f32, relative: {errs}; "
          f"planted fault (window one key too narrow): {fault}")
    for g, e in zip(got, errs):
        assert torch.isfinite(g).all()
        assert e <= RG_CARD_LIMIT
    assert fault > RG_CARD_LIMIT


def _widen(tree):
    """The tree with every 16-bit float tensor widened to float32."""
    if isinstance(tree, dict):
        return {k: _widen(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_widen(v) for v in tree)
    if tree.dtype in (torch.bfloat16, torch.float16):
        return tree.float()
    return tree


# -------------------------------------------------------------------- xLSTM
def mlstm_inputs(b, h, s, d, dtype, dev, seed):
    """q, k, v unit normals in ``dtype``; float32 gates with forget gates
    near the model's (log_sigmoid(N + 4)) and input gates 0.5 N."""
    q, k, v = (randn((b, h, s, d), dtype, dev, seed + i) for i in range(3))
    lf = torch.nn.functional.logsigmoid(
        randn((b, h, s), torch.float32, dev, seed + 3) + 4.0)
    li = randn((b, h, s), torch.float32, dev, seed + 4, scale=0.5)
    return q, k, v, lf, li


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,h,s,d,chunk", [
    (1, 2, 128, 32, 32), (2, 1, 100, 64, 32),   # ragged S
    (2, 2, 257, 200, 16),                       # D not a multiple of 128
    (1, 1, 300, 1024, 128)])                    # xLSTM's head dim
def test_mlstm_chunkwise_matches_plain(dev, dtype, b, h, s, d, chunk):
    """h against the plain version at ``tol`` and, with ``return_state``,
    the final (C, n, m) in float32: both sum the same f32 terms in other
    orders, so the state is held at 2e-4 of its largest entry.  Without
    ``return_state`` only h comes back, the same h."""
    dt = DTYPES[dtype]
    ins = mlstm_inputs(b, h, s, d, dt, dev, s + d)
    ops.reset_counts()
    got, state = mlstm_chunkwise(*ins, chunk=chunk, return_state=True)
    only = mlstm_chunkwise(*ins, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.launch_counts()["mlstm_chunkwise"] == 2
    want, want_state = ref.mlstm_chunkwise_ref(*ins, chunk=chunk,
                                               return_state=True)
    assert got.dtype == dt and torch.equal(got, only)
    close(got, want, dt)
    for g, w in zip(state, want_state):
        assert g.dtype == torch.float32 and g.shape == w.shape
        lim = 2e-4 * w.abs().max().item()
        torch.testing.assert_close(g, w, rtol=2e-4, atol=lim)


#: chip_smoke.py's MLSTM_TOL and MLSTM_STATE_LIMIT.
MLSTM_TOL = {torch.bfloat16: (2e-3, 2.0 ** -7),
             torch.float16: (2e-3, 2.0 ** -10)}
MLSTM_STATE_LIMIT = 1e-5


def _mlstm_h_multiple(got, want, dtype):
    atol, rtol = MLSTM_TOL[dtype]
    return ((got.float() - want.float()).abs()
            / (atol + rtol * want.float().abs())).max().item()


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("b,h,s,d", [(4, 4, 2048, 1024),  # xLSTM prefill
                                     (4, 4, 2000, 1024),  # ragged S
                                     (2, 2, 300, 64), (1, 3, 512, 128),
                                     (1, 2, 128, 64),     # one chunk
                                     (2, 1, 130, 128)])   # a 2-step chunk
def test_mlstm_wgmma_route_matches_simt_and_plain(dev, dtype, b, h, s, d):
    """The wgmma route (chunk 128) against the plain version at
    ``chip_smoke.py``'s limits -- h per element within MLSTM_TOL (one
    rounding flip of h; f16's at its own 10-bit rtol), each of C, n, m
    within MLSTM_STATE_LIMIT of its largest entry -- and against the simt
    route on the same inputs at the same limits; one launch a call, on the
    route ``mlstm_chunkwise.routes`` reports."""
    dt = DTYPES[dtype]
    ins = mlstm_inputs(b, h, s, d, dt, dev, 7 * s + d)
    ops.reset_counts()
    got, state = mlstm_chunkwise(*ins, chunk=128, return_state=True)
    torch.cuda.synchronize()
    assert kmlstm.ROUTES == {"wgmma": 1, "simt": 0}
    assert ops.launch_counts()["mlstm_chunkwise"] == 1
    want, want_state = ref.mlstm_chunkwise_ref(*ins, chunk=128,
                                               return_state=True)
    simt = kmlstm._run(*(t.contiguous() for t in ins[:3]), ins[3], ins[4],
                       128, "simt")
    for other_h, other_state in ((want, want_state), (simt[0], simt[1:])):
        assert _mlstm_h_multiple(got, other_h, dt) <= 1
        for g, w in zip(state, other_state):
            assert g.dtype == torch.float32 and g.shape == w.shape
            assert ((g - w).abs().max() / w.abs().max()).item() \
                <= MLSTM_STATE_LIMIT


def test_mlstm_routes_on_card(dev):
    """bf16 chunks of 128 on wgmma; f32, another chunk or S < 128 on simt."""
    cases = [((1, 2, 256, 64), torch.bfloat16, 128, "wgmma"),
             ((1, 2, 256, 64), torch.float32, 128, "simt"),
             ((1, 2, 256, 64), torch.bfloat16, 64, "simt"),
             ((1, 2, 100, 64), torch.bfloat16, 128, "simt")]
    for (b, h, s, d), dt, chunk, route in cases:
        ins = mlstm_inputs(b, h, s, d, dt, dev, s + chunk)
        ops.reset_counts()
        got = mlstm_chunkwise(*ins, chunk=chunk)
        assert {r: c for r, c in kmlstm.ROUTES.items() if c} == {route: 1}
        close(got, ref.mlstm_chunkwise_ref(*ins, chunk=chunk), dt)


def test_mlstm_wgmma_shared_memory_fits_a_block(dev):
    """The built wgmma kernels' dynamic shared memory, each within the
    227 KB a block may use."""
    smem = kmlstm.wgmma_smem()
    assert set(smem) == {"intra", "state", "output"}
    assert 0 < min(smem.values()) and max(smem.values()) <= 232448


def test_mlstm_bwd_wgmma_shared_memory_fits_a_block(dev):
    """The backward's built wgmma kernels' dynamic shared memory, each
    within the 227 KB a block may use."""
    smem = kmlstm.bwd_smem()
    assert set(smem) == {"y", "intra", "walk", "grads"}
    assert 0 < min(smem.values()) and max(smem.values()) <= 232448


def test_mlstm_chunkwise_refuses_what_it_does_not_take(dev):
    """A gradient of the final m (the backward kernel takes none), a chunk
    past 128, mixed dtypes."""
    q, k, v, lf, li = mlstm_inputs(1, 1, 16, 8, torch.float32, dev, 60)
    q.requires_grad_()
    _, (_, _, m) = ops.mlstm_chunkwise(q, k, v, lf, li, chunk=16,
                                       return_state=True)
    with pytest.raises(NotImplementedError, match="final m"):
        torch.autograd.grad(m.sum(), [q])
    with torch.no_grad():
        assert torch.isfinite(ops.mlstm_chunkwise(q, k, v, lf, li,
                                                  chunk=16)).all()
    q = q.detach()
    long_ins = mlstm_inputs(1, 1, 300, 8, torch.float32, dev, 61)
    with pytest.raises(ValueError, match="chunks of 1..128"):
        mlstm_chunkwise(*long_ins, chunk=256)
    with pytest.raises(ValueError, match="share one of"):
        mlstm_chunkwise(q, k.bfloat16(), v, lf, li, chunk=16)


#: The backward kernel against its closed form, each output's largest
#: error over its largest entry; the gate gradients' over the largest
#: term dlog_f sums: dlog_f is the difference of the row and column sums
#: dlog_i is made of, plus E = <C, dC> + <n, dn> where the final state has
#: a gradient, and cancels to 0 at S 1.  f32 sums the same terms in other
#: orders; a 16-bit output adds its own rounding (2^-9 of bf16).
MLSTM_BWD_LIMIT = {torch.float32: 1e-4, torch.bfloat16: 1e-2,
                   torch.float16: 1e-2}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,h,s,d,chunk,state", [
    (1, 2, 128, 32, 32, False), (2, 1, 100, 64, 32, True),   # ragged S
    (2, 2, 257, 200, 16, True),                # D not a multiple of 128
    (1, 1, 300, 1024, 128, False),             # xLSTM's head dim
    (2, 1, 256, 128, 128, True),               # 16-bit: wgmma with dC, dn
    (1, 2, 1, 16, 128, True)])                 # one step
def test_mlstm_chunkwise_bwd_matches_closed_form(dev, dtype, b, h, s, d,
                                                 chunk, state):
    """(dq, dk, dv, dlog_f, dlog_i) of the backward kernel against
    ``ref.mlstm_chunkwise_bwd_ref`` on the same inputs, with the gradient of
    h alone or with the final (C, n)'s, within MLSTM_BWD_LIMIT; one launch,
    its recompute on the forward's route."""
    dt = DTYPES[dtype]
    ins = mlstm_inputs(b, h, s, d, dt, dev, 3 * s + d)
    dh = randn((b, h, s, d), dt, dev, 9)
    dc = randn((b, h, d, d), torch.float32, dev, 10) if state else None
    dn = randn((b, h, d), torch.float32, dev, 11) if state else None
    ops.reset_counts()
    got = kmlstm.mlstm_chunkwise_bwd(*ins, dh, dc, dn, chunk=chunk)
    torch.cuda.synchronize()
    fwd = kmlstm._route_of(*ins[:3], chunk)
    assert kmlstm.BWD_ROUTES == {"wgmma": int(fwd == "wgmma"),
                                 "simt": int(fwd == "simt")}
    want = ref.mlstm_chunkwise_bwd_ref(*ins, dh, dc, dn, chunk=chunk)
    gates = max(w.abs().max().item() for w in want[3:])
    if state:
        _, (c, n, _) = ref.mlstm_chunkwise_ref(*ins, chunk=chunk,
                                               return_state=True)
        e = (c * dc).sum((-1, -2)) + (n * dn).sum(-1)
        gates = max(gates, e.abs().max().item())
    for i, (g, w, x) in enumerate(zip(got, want, ins)):
        assert g.dtype == x.dtype and g.shape == x.shape
        scale = w.float().abs().max().item() if i < 3 else gates
        err = (g.float() - w.float()).abs().max().item() / scale
        assert err <= MLSTM_BWD_LIMIT[dt], (i, err)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("b,h,s,d,state", [(1, 2, 300, 128, True),
                                           (2, 1, 128, 64, False)])
def test_mlstm_bwd_wgmma_matches_its_algorithm(dev, dtype, b, h, s, d,
                                               state):
    """The backward's wgmma route against its algorithm in plain PyTorch
    (``ref.mlstm_chunkwise_bwd_split_ref``: the same passes and hi + lo
    roundings) on the same inputs: dq, dk, dv within 4e-3 of their largest
    entry (both round f32 values that differ in summation order to 16
    bits: up to a flip of 2^-8 of the largest), dlog_f and dlog_i within
    5e-5 of the larger of their largest and <C, dC> + <n, dn>."""
    dt = DTYPES[dtype]
    ins = mlstm_inputs(b, h, s, d, dt, dev, 5 * s + d)
    dh = randn((b, h, s, d), dt, dev, 12)
    dc = randn((b, h, d, d), torch.float32, dev, 13) if state else None
    dn = randn((b, h, d), torch.float32, dev, 14) if state else None
    ops.reset_counts()
    got = kmlstm.mlstm_chunkwise_bwd(*ins, dh, dc, dn, chunk=128)
    torch.cuda.synchronize()
    assert kmlstm.BWD_ROUTES == {"wgmma": 1, "simt": 0}
    want = ref.mlstm_chunkwise_bwd_split_ref(*ins, dh, dc, dn, chunk=128)
    gates = max(w.abs().max().item() for w in want[3:])
    if state:
        _, (c, n, _) = ref.mlstm_chunkwise_ref(*ins, chunk=128,
                                               return_state=True)
        e = (c * dc).sum((-1, -2)) + (n * dn).sum(-1)
        gates = max(gates, e.abs().max().item())
    for i, (g, w) in enumerate(zip(got, want)):
        scale = w.float().abs().max().item() if i < 3 else gates
        err = (g.float() - w.float()).abs().max().item() / scale
        assert err <= (4e-3 if i < 3 else 5e-5), (i, err)


def test_mlstm_gradient_reaches_weights_on_card(dev):
    """``ops.mlstm_chunkwise`` under autograd on the card: the gradients
    of q, k, v and the gates equal one ``mlstm_chunkwise_bwd`` call's."""
    ins = mlstm_inputs(2, 2, 200, 64, torch.bfloat16, dev, 77)
    live = [t.detach().requires_grad_() for t in ins]
    dh = randn((2, 2, 200, 64), torch.bfloat16, dev, 78)
    ops.reset_counts()
    got = torch.autograd.grad(ops.mlstm_chunkwise(*live, chunk=128), live,
                              dh)
    want = kmlstm.mlstm_chunkwise_bwd(*ins, dh, chunk=128)
    torch.cuda.synchronize()
    assert ops.launch_counts()["mlstm_chunkwise_bwd"] == 2
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_xlstm_serving_on_card_matches_cpu(dev):
    """A small xLSTM (one group of the pattern: 7 mLSTM + 1 sLSTM, d_model
    128, 2 heads so the mLSTM head dim is 128, chunk 16, bf16) through
    ``lm.prefill`` of 40 tokens (ragged against the chunk) and 2
    ``lm.decode_step``s: the kernels on the card against the plain
    versions on the CPU, fed the same tokens, each call's logits within
    3e-2 relative (Frobenius), and each call's launches as predicted (6
    products an mLSTM layer, 3 an sLSTM one; one mlstm_chunkwise an mLSTM
    layer at prefill)."""
    cfg = dataclasses.replace(reduced(get_config("xlstm-1.3b")),
                              num_groups=1, d_model=128, num_heads=2,
                              dtype="bfloat16")
    params = lm.init(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(62).integers(
        0, cfg.vocab_size, (2, 40)))
    n_m = cfg.num_groups * cfg.block_pattern.count("mlstm")
    n_s = cfg.num_groups * cfg.block_pattern.count("slstm")
    gemms = {"sma_gemm": 6 * n_m + 3 * n_s, "rmsnorm_gemm": 1}
    launches = [dict(gemms, mlstm_chunkwise=n_m), gemms, gemms]

    def run(where, feed=None):
        p = _to(params, where)
        ops.reset_counts()
        logits, state, cl = lm.prefill(p, cfg, {"tokens": toks.to(where)},
                                       cache_size=48)
        counts = [{k: n for k, n in ops.launch_counts().items() if n}]
        outs, fed = [logits.float().cpu()], []
        for i in range(2):
            nxt = feed[i] if feed else logits.argmax(-1, keepdim=True).cpu()
            fed.append(nxt)
            ops.reset_counts()
            logits, state, cl = lm.decode_step(p, state, cl, cfg,
                                               {"tokens": nxt.to(where)})
            counts.append({k: n for k, n in ops.launch_counts().items()
                           if n})
            outs.append(logits.float().cpu())
        return outs, fed, counts

    want, fed, _ = run(torch.device("cpu"))
    got, _, counts = run(dev, fed)
    assert counts == launches
    assert not ops.ROUTED
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert ((g - w).norm() / w.norm()).item() <= 3e-2


# ------------------------------------------------------ the sma_jit front door
def _launches_and_routes():
    from repro_torch.kernels import sma_gemm as kgemm
    counts = {k: n for k, n in ops.launch_counts().items() if n}
    routes = {name: {r: n for r, n in table.items() if n}
              for name, table in (("sma_gemm", kgemm.ROUTES),
                                  ("rmsnorm_gemm", knorm.ROUTES),
                                  ("flash", kflash.FWD_ROUTES))}
    return counts, routes


def test_sma_jit_forward_is_the_direct_forward(dev):
    """Full-width StableLM-2-1.6B cut to 2 layers, bf16, 2 x 256 tokens:
    ``sma_jit(lm.forward)`` launches what the direct ``lm.forward`` launches
    (7 sma_gemm a layer, one rmsnorm_gemm, one flash a layer, on the same
    routes, nothing routed) and its logits are bit for bit the direct
    ones: the same kernels on the same operands."""
    import functools

    from repro_torch import sma_jit
    cfg = dataclasses.replace(get_config("stablelm-1.6b"), num_groups=2)
    params = lm.init(cfg, seed=0, device=dev)
    toks = torch.from_numpy(np.random.default_rng(70).integers(
        0, cfg.vocab_size, (2, 256))).to(dev)
    eng = sma_jit(functools.partial(lm.forward, cfg=cfg))
    with torch.no_grad():
        ops.reset_counts()
        want = lm.forward(params, cfg, {"tokens": toks})
        torch.cuda.synchronize()
        direct = _launches_and_routes()
        eng(params, batch={"tokens": toks})        # compiles
        ops.reset_counts()
        got = eng(params, batch={"tokens": toks})
        torch.cuda.synchronize()
        compiled = _launches_and_routes()
    assert direct[0] == {"sma_gemm": 14, "rmsnorm_gemm": 1,
                         "flash_attention": 2}
    assert compiled == direct
    assert not ops.ROUTED
    assert torch.equal(got, want)
    assert (eng.stats.misses, eng.stats.hits) == (1, 1)


# ---------------------------------------------------------------------------
# Resilience on the card: full-width Mistral-NeMo-12B cut to 2 layers
# ---------------------------------------------------------------------------
def _nemo_engine(dev, **kw):
    from repro_torch.serving import SchedulerConfig
    cfg = dataclasses.replace(get_config("mistral-nemo-12b"), num_groups=2)
    params = lm.init(cfg, seed=0, device=dev)
    eng = ServeEngine(cfg, params, device=dev, max_batch=4,
                      cache=CacheConfig(block_size=16, num_blocks=64,
                                        max_seq_len=256),
                      sched=SchedulerConfig(prefill_chunk=64), **kw)
    return cfg, eng


def _nemo_requests(cfg):
    from repro_torch.serving import Request
    rng = np.random.default_rng(90)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, (n,))
                    .astype(np.int32), max_new_tokens=6)
            for i, n in enumerate((40, 100, 17))]


def _serve_nemo(eng, reqs, on_tick=None):
    import warnings
    for r in reqs:
        eng.submit(r)
    ticks = 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        while eng.queue or eng.active:
            eng.step()
            ticks += 1
            if on_tick is not None:
                on_tick(ticks)
            assert ticks < 200
    return {r.rid: list(r.out_tokens or []) for r in reqs}


@pytest.mark.parametrize("case", ["tick fault", "poisoned row",
                                  "kernel fault mid-tick"])
def test_nemo_serving_chaos_on_card(dev, case):
    """The chaos cases of ``chip_smoke.py`` at 2 full-width layers (q width
    4096 against d_model 5120, GQA 32/8 at head_dim 128), through the
    compiled engine: (a) a ``serve.tick`` fault is retried whole and the
    tokens are the unfaulted pass's; (b) a request whose blocks go NaN
    after its first decode tick is evicted after its retries, the others'
    tokens unchanged; (c) an ``sma_gemm@cuda`` fault inside a decode tick,
    after layer 0 wrote the pools, is retried whole, tokens unchanged."""
    from repro_torch.obs import metrics
    from repro_torch.resilience import faults, guard
    guard.reset()
    cfg, eng = _nemo_engine(dev, retry=guard.RetryPolicy(max_retries=2))
    seen = []
    with faults.inject_faults("sma_gemm:runtime_error:times=0") as (count,):
        want = _serve_nemo(eng, _nemo_requests(cfg),
                           on_tick=lambda t: seen.append(count._seen))
    assert all(len(t) == 6 for t in want.values())
    # the second decode tick, layer 1's 4th product (layer 0 has written)
    second = [i for i, (p, _, _) in enumerate(eng.tick_log)
              if p == "decode"][1]
    after = seen[second - 1] + 7 + 3
    eng.reset()
    failures = metrics.get("serve.tick_failures")
    reqs = _nemo_requests(cfg)
    if case == "tick fault":
        with faults.inject_faults("serve.tick:runtime_error:times=1"):
            got = _serve_nemo(eng, reqs)
        assert metrics.get("serve.tick_failures") == failures + 1
        assert got == want
    elif case == "poisoned row":
        victim, hit = reqs[1], []

        def poison(tick):
            if not hit and victim.out_tokens and len(victim.out_tokens) == 2:
                hit.append(tick)
                for pool in eng.state[0].values():
                    pool[:, eng.kv.blocks_of(victim.slot)] = float("nan")
        got = _serve_nemo(eng, reqs, on_tick=poison)
        assert victim.status == "failed"
        assert victim.retries == eng.retry.max_retries + 1
        for r in reqs:
            if r is not victim:
                assert r.status == "done" and got[r.rid] == want[r.rid]
    else:
        spec = f"sma_gemm@cuda:runtime_error:times=1,after={after}"
        with faults.inject_faults(spec) as (fault,):
            got = _serve_nemo(eng, reqs)
        assert fault._fired == 1
        assert metrics.get("serve.tick_failures") == failures + 1
        assert got == want
    assert all(r.status == "done" for r in reqs
               if case != "poisoned row" or r is not reqs[1])


def test_real_out_of_memory_is_retried_and_launch_errors_are_not(dev):
    """The allocator's ``torch.cuda.OutOfMemoryError`` is runtime-class; a
    kernel launch error as ``_build.check`` raises it (its text here reads
    "out of memory") is not, and a serving tick lets it propagate."""
    from repro_torch.kernels import _build
    from repro_torch.resilience import guard
    with pytest.raises(torch.cuda.OutOfMemoryError) as oom:
        torch.empty(1 << 48, dtype=torch.uint8, device=dev)
    assert guard.is_runtime_failure(oom.value)
    lib = kgemm._lib()
    with pytest.raises(RuntimeError, match="out of memory") as launch:
        _build.check(lib, 2, "sma_gemm")
    assert not guard.is_runtime_failure(launch.value)


# ---------------------------------------------------------------------------
# The mixture of experts (qwen3-moe-30b-a3b)
# ---------------------------------------------------------------------------
def _moe_cfg(**kw):
    cfg = get_config("qwen3-moe-30b-a3b")
    return dataclasses.replace(cfg, **kw)


def test_moe_apply_on_card_is_deterministic(dev):
    """One MoE layer of a reduced Qwen3 widened to 16 experts, bf16, on
    the card: finite, the router one ``sma_gemm`` launch, and a second
    run ``torch.equal`` to the first (top-k and the combine have no
    unordered step); against the same layer on the CPU in float32 at the
    bf16 tolerance on every token whose choices agree."""
    from repro_torch.models import moe
    red = reduced(get_config("qwen3-moe-30b-a3b"))
    cfg = dataclasses.replace(red, dtype="bfloat16", d_model=256,
                              moe=dataclasses.replace(red.moe,
                                                      num_experts=16,
                                                      top_k=4))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = moe.moe_init(gen, cfg, torch.bfloat16)
    x = torch.randn((4, 64, 256), generator=gen, device=dev).to(
        torch.bfloat16)
    with torch.inference_mode():
        ops.reset_counts()
        y1, r1 = moe.moe_ffn(params, x, cfg)
        assert ops.launch_counts()["sma_gemm"] == 1
        y2, r2 = moe.moe_ffn(params, x, cfg)
        torch.cuda.synchronize()
        assert torch.isfinite(y1.float()).all() and y1.shape == x.shape
        assert torch.equal(y1, y2) and torch.equal(r1.keep, r2.keep)
        f32 = dataclasses.replace(cfg, dtype="float32")
        cpu = {k: v.float().cpu() for k, v in params.items()}
        y3, r3 = moe.moe_ffn(cpu, x.float().cpu(), f32)
    same = (r1.onehot.cpu() == r3.onehot).all(-1).all(-1)       # (B, S)
    assert same.float().mean() > 0.9
    torch.testing.assert_close(y1.float().cpu()[same], y3[same],
                               rtol=3e-2, atol=3e-2)


def test_moe_route_ties_on_card(dev):
    """Equal probabilities route to the lower expert id on the card as on
    the CPU (``jax.lax.top_k``'s order)."""
    from repro_torch.models import moe
    mcfg = _moe_cfg().moe
    logits = torch.zeros((64, 128))
    logits[:, ::3] = 1.0                  # 43 tied leaders a row
    logits[1::2, 5] = 2.0
    want = moe.route(logits, mcfg)[2]
    got = moe.route(logits.to(dev), mcfg)[2]
    assert torch.equal(got.cpu(), want)
    assert want[0].tolist() == [0, 3, 6, 9, 12, 15, 18, 21]


def test_moe_compiled_ticks_equal_direct_on_card(dev):
    """Qwen3-30B-A3B at full width, 2 layers, bf16: the engine's compiled
    prefill tick (4 ragged rows, chunk 64) and two decode ticks against
    the direct steps, each run twice: logits, lengths and pools
    ``torch.equal``, the same launches (5 ``sma_gemm`` a layer: q, k, v,
    o and the router)."""
    cfg = _moe_cfg(num_groups=2)
    cc = CacheConfig(block_size=16, num_blocks=64, max_seq_len=256)
    kv = PagedKVCache(cc, 4)
    for r, n in enumerate((64, 17, 40, 1)):
        assert kv.admit(r, n, 4)
    table = torch.from_numpy(kv.table_rows([0, 1, 2, 3])).to(dev)
    toks = torch.from_numpy(np.random.default_rng(21).integers(
        0, cfg.vocab_size, (4, 64)).astype(np.int32)).to(dev)
    n_tok = torch.tensor([64, 17, 40, 1], dtype=torch.int32, device=dev)

    def run(prefill, decode):
        state = smodel.init_state(cfg, 4, cc, device=dev)
        ops.reset_counts()
        logits, _, cl = prefill(params, state, table,
                                torch.zeros(4, dtype=torch.int32,
                                            device=dev), n_tok,
                                {"tokens": toks})
        outs = [logits.clone(), cl.clone()]
        for _ in range(2):
            nxt = logits.argmax(-1, keepdim=True).to(torch.int32)
            logits, _, cl = decode(params, state, table, cl.to(torch.int32),
                                   {"tokens": nxt})
            outs += [logits.clone(), cl.clone()]
        torch.cuda.synchronize()
        counts = {k: n for k, n in ops.launch_counts().items() if n}
        return outs, [p[:, :cc.num_blocks].clone() for e in state
                      for p in e.values()], counts

    with torch.inference_mode():
        params = lm.init(cfg, seed=0, device=dev)
        eng = ServeEngine(cfg, params, cache=cc, max_batch=4, device=dev)
        compiled = (eng.engines["prefill"], eng.engines["decode"])
        direct = (lambda p, s, bt, cl, nt, b: smodel.paged_prefill_step(
                      p, s, bt, cl, nt, cfg, b),
                  lambda p, s, bt, cl, b: smodel.paged_decode_step(
                      p, s, bt, cl, cfg, b))
        runs = [run(*compiled), run(*direct), run(*compiled), run(*direct)]
    for outs, pools, counts in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outs, runs[0][0]))
        assert all(torch.equal(a, b) for a, b in zip(pools, runs[0][1]))
        assert counts == runs[0][2]
    assert runs[0][2] == {"sma_gemm": 3 * 5 * 2, "rmsnorm_gemm": 3,
                          "paged_decode_attention": 2 * 2}
    assert all(torch.isfinite(o.float()).all() for o in runs[0][0][::2])


def test_summa_two_ranks_on_one_card(dev, tmp_path):
    """Two ranks spawned on the one card (gloo, staged through host): the
    SUMMA sharded GEMM at a small bf16 shape against one rank's
    ``ops.sma_gemm`` of the whole product, within the GEMM limits;
    overlapped and serial schedules ``torch.equal``; one local launch a
    step on each rank."""
    import sys
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    import torch_dist_workers as workers
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import spawn
    _build.build()              # the ranks load the libraries, never build
    results = spawn(workers.summa_card_case, 2, backend="gloo",
                    device="cuda:0", timeout=300, workdir=str(tmp_path))
    for res in results:
        assert res["backend"] == "gloo"
        assert res["multiples"] <= 1 and res["equal"], res
        assert res["launches"] == 2, res


def test_tensor_parallel_step_two_ranks_on_one_card(dev, tmp_path):
    """Two ranks on the one card (gloo, staged through host): 2 steps of
    a small bf16 StableLM through ``train(mesh=)`` on a 1 x 2 mesh
    against the unmeshed ``train()`` on the card (step 1 from the same
    masters: loss within 1e-3 relative, grad norm within 1e-2, the
    partial sums rounded to bf16 in another order; step 2 within 5e-3 /
    5e-2), the replicated leaves bit for bit on both ranks, every kernel
    of the path launched; and the vocab-parallel loss and embedding on
    CUDA tensors against the plain ones."""
    import sys
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    import torch_dist_workers as workers
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import spawn
    _build.build()
    results = spawn(workers.tp_card_case, 2, backend="gloo",
                    device="cuda:0", timeout=600, workdir=str(tmp_path))
    for res in results:
        for step, (got, want) in enumerate(zip(res["meshed"],
                                               res["unmeshed"])):
            limit = (1e-3, 1e-2) if step == 0 else (5e-3, 5e-2)
            for key, lim in zip(("loss", "grad_norm"), limit):
                assert abs(got[key] - want[key]) <= lim * abs(want[key]), \
                    (step, key, got, want)
        assert all(res["launches"][k] for k in (
            "sma_gemm", "rmsnorm_gemm", "flash_attention",
            "flash_attention_bwd")), res["launches"]
        v = res["vocab"]
        np.testing.assert_allclose(v["ce"], v["want_ce"], rtol=1e-5,
                                   atol=1e-4)
        assert np.array_equal(v["hit"], v["want_hit"])
        np.testing.assert_allclose(v["dlogits"], v["want_dlogits"],
                                   rtol=1e-5, atol=1e-6)
        assert np.array_equal(v["rows"], v["want_rows"])
        assert np.array_equal(v["dtable"], v["want_dtable"])
    assert results[0]["replicated"] == results[1]["replicated"]
    assert results[0]["meshed"] == results[1]["meshed"]
