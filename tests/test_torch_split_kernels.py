"""The split kernels' plain parts: route and split choices, and the
split-KV merge, against the JAX package.

``sma_gemm`` picks its kernel (``_route``) and split-K's slices
(``_slices``), the decode kernels their position ranges (``_splits``), the
flash kernels their route and shared memory (``_route``, ``smem_bytes``),
and ``rmsnorm_gemm`` and ``mlstm_chunkwise`` their routes (``_route``), in
plain Python: those choices are tested here, on the CPU.  The split-KV
decode is one partial (m, l, acc) per range, folded in split order;
``ref.decode_attention_split_ref`` is that merge in plain PyTorch, held
against the JAX kernel (``interpret=True``) and the JAX oracle at the
reference's f32 ``tol_for``, 2e-4, at the lengths where a split can go
wrong: 0, 1, a split boundary and one either side, fewer positions than
splits, and the full cache.
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as j_decode
from repro_torch.kernels import _build, ref
from repro_torch.kernels import decode_attention as kdecode
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import mlstm as kmlstm
from repro_torch.kernels import norm_gemm as knorm
from repro_torch.kernels import sma_gemm as kgemm

F32_TOL = 2e-4
BLOCKS = 264   # two blocks per SM of an H100's 132


# ------------------------------------------------------------- sma_gemm
@pytest.mark.parametrize("m", [1, 8, 16, 17, 300, 8192])
def test_route_f32_takes_the_cuda_core_kernel(m):
    assert kgemm._route(m, 2048, 2048, torch.float32, True) == "f32"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("m,route", [(1, "splitk"), (8, "splitk"),
                                     (16, "splitk"), (17, "wgmma"),
                                     (65, "wgmma"), (8192, "wgmma")])
def test_route_aligned_16_bit_operands(dtype, m, route):
    """TMA takes them: split-K at decode sizes, wgmma above."""
    for k, n in ((2048, 5632), (136, 72), (40, 8)):
        assert kgemm._route(m, n, k, dtype, True) == route


@pytest.mark.parametrize("m", [1, 16, 37, 300])
@pytest.mark.parametrize("k,n,aligned", [(70, 48, True), (72, 50, True),
                                         (513, 257, True), (72, 40, False),
                                         (0, 64, True)])
def test_route_what_tma_cannot_take_goes_to_the_tile_kernel(m, k, n,
                                                            aligned):
    """K or N not a multiple of 8, an offset base, or K = 0."""
    assert kgemm._route(m, n, k, torch.bfloat16, aligned) == "tile"


@pytest.mark.parametrize("n,k", [(2048, 2048), (5632, 2048), (2048, 5632),
                                 (72, 5632), (100352, 2048), (256, 7680),
                                 (64, 64), (8, 40), (130, 1)])
def test_splitk_slices_fill_the_card(n, k):
    """Column blocks x slices >= 264 where slices of one 32-row pass allow;
    the slices cover K, every row once."""
    slices, kslice = kgemm._slices(n, k)
    blocks = -(-n // kgemm._SPLITK_BN)
    assert slices >= 1 and kslice >= 1 and slices * kslice >= k
    if k // kgemm._SPLITK_ROWS >= -(-BLOCKS // blocks):
        assert blocks * slices >= BLOCKS
    if k >= kgemm._SPLITK_ROWS:
        assert kslice >= kgemm._SPLITK_ROWS


# ------------------------------------------------------- decode splits
@pytest.mark.parametrize("b,hkv,max_len", [(8, 1, 2048), (8, 32, 1024),
                                           (4, 1, 4160), (1, 1, 16),
                                           (6, 2, 96), (2, 4, 5000),
                                           (300, 1, 64)])
def test_splits_fill_the_card(b, hkv, max_len):
    """At least one split; at least 264 partial blocks where ranges of one
    tile allow; every range at least one tile."""
    splits = kdecode._splits(b, hkv, max_len)
    chunk = -(-max_len // splits)
    assert 1 <= splits <= kdecode._MAX_SPLITS
    if max_len // kdecode._TILE >= -(-BLOCKS // (b * hkv)):
        assert b * hkv * splits >= BLOCKS
    if max_len >= kdecode._TILE:
        assert chunk >= kdecode._TILE


class _Recorder:
    """Stands in for the compiled library: records what the wrapper would
    launch, launches nothing."""

    def __init__(self):
        self.calls = []

    def paged_decode_attention_launch(self, *args):
        self.calls.append(args)
        return 0


def test_launch_shape_does_not_read_kv_len(monkeypatch):
    """Two calls of one shape with other kv_len values pass the kernels the
    same splits and the same scratch size: the launch shape is fixed by
    the call shape."""
    lib = _Recorder()
    monkeypatch.setattr(kdecode, "_lib", lambda: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    b, hq, hkv, d, bs, mb = 3, 8, 2, 64, 16, 8
    q = torch.zeros((b, hq, d), dtype=torch.bfloat16)
    pool = torch.zeros((b * mb, hkv, bs, d), dtype=torch.bfloat16)
    table = torch.arange(b * mb, dtype=torch.int32).reshape(b, mb)
    parts, real = [], torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **kw: parts.append(
        (a, kw)) or real(*a, **kw))
    for lens in ([0, 1, 128], [128, 128, 128], [17, 0, 33]):
        kdecode._launch(q, pool, pool, table, torch.tensor(lens), None)
    splits = {call[14] for call in lib.calls}
    want = kdecode._splits(b, hkv, mb * bs)
    assert splits == {want}
    assert {a[0][0] for a in parts if a[1].get("dtype") == torch.float32} \
        == {b * hq * want * (d + 2)}
    # The contiguous entry: no table, one block of Smax positions a request.
    lib.calls.clear()
    cache = torch.zeros((b, hkv, mb * bs, d), dtype=torch.bfloat16)
    for lens in ([0, 1, 128], [128, 128, 128]):
        kdecode._launch(q, cache, cache, None, torch.tensor(lens), None)
    assert {(c[3], c[11], c[12], c[13], c[14]) for c in lib.calls} == {
        (None, b, mb * bs, 1, want)}


# -------------------------------------------- split-then-merge reference
def _case(hq, hkv, d, smax, splits, seed):
    """Inputs and lengths around the ranges of ``ceil(smax / splits)``:
    0, 1, a boundary and one either side, fewer positions than splits,
    the full cache."""
    chunk = -(-smax // splits)
    lens = [0, 1, chunk - 1, chunk, chunk + 1, min(splits - 1, smax),
            (splits - 1) * chunk + 1, smax]
    rng = np.random.default_rng(seed)
    b = len(lens)
    q = rng.standard_normal((b, hq, d), np.float32)
    k = rng.standard_normal((b, hkv, smax, d), np.float32)
    v = rng.standard_normal((b, hkv, smax, d), np.float32)
    return q, k, v, np.array(lens, np.int32)


SPLIT_CASES = [
    # hq, hkv, d, smax, splits
    (8, 2, 16, 64, 8),
    (4, 4, 64, 100, 7),
    (10, 1, 256, 96, 6),     # recurrentgemma's MQA, Smax reduced
    (1, 1, 32, 40, 40),      # one position per split
]


@pytest.mark.parametrize("hq,hkv,d,smax,splits", SPLIT_CASES)
def test_split_ref_matches_jax_kernel(hq, hkv, d, smax, splits):
    q, k, v, lens = _case(hq, hkv, d, smax, splits, seed=11)
    got = ref.decode_attention_split_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lens), splits)
    want = j_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(lens), block_s=16, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=F32_TOL, atol=F32_TOL)
    assert got[0].abs().max().item() == 0.0   # kv_len 0 gives 0, not NaN


@pytest.mark.parametrize("hq,hkv,d,smax,splits", SPLIT_CASES)
def test_split_ref_matches_jax_oracle(hq, hkv, d, smax, splits):
    """Against ``repro.kernels.ref.decode_attention_ref`` (rows with keys;
    the oracle's softmax over no key is NaN)."""
    q, k, v, lens = _case(hq, hkv, d, smax, splits, seed=12)
    got = ref.decode_attention_split_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lens), splits)
    want = np.asarray(jref.decode_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens)))
    rows = lens > 0
    np.testing.assert_allclose(got.numpy()[rows], want[rows], rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,d,smax", [(8, 2, 16, 64), (10, 1, 256, 96),
                                           (32, 32, 64, 1024)])
def test_split_ref_at_the_wrappers_splits_matches_plain(dtype, hq, hkv, d,
                                                        smax):
    """With the splits the wrapper picks, the split-then-merge equals the
    one-pass plain version the kernel is held against on the card."""
    splits = kdecode._splits(8, hkv, smax)
    q, k, v, lens = _case(hq, hkv, d, smax, splits, seed=13)
    args = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
    lens = torch.from_numpy(lens)
    got = ref.decode_attention_split_ref(*args, lens, splits)
    want = ref.decode_attention_ref(*args, lens)
    tol = F32_TOL if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_split_ref_merge_sees_every_split():
    """A key changed in the last split only, and the first position of
    every split dropped, each move the merged output: the merge folds
    every range."""
    hq, hkv, d, smax, splits = 4, 1, 32, 64, 8
    q, k, v, _ = _case(hq, hkv, d, smax, splits, seed=14)
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    lens = torch.full((q.shape[0],), smax, dtype=torch.int32)
    base = ref.decode_attention_split_ref(q, k, v, lens, splits)
    k_last = k.clone()
    k_last[:, :, -1] = 4 * q.reshape(-1, hkv, hq, d).sum(2)
    moved = ref.decode_attention_split_ref(q, k_last, v, lens, splits)
    assert ((moved - base).abs().amax(-1) > 10 * F32_TOL).all()
    chunk = smax // splits
    keep = [p for p in range(smax) if p % chunk]
    dropped = ref.decode_attention_split_ref(
        q, k[:, :, keep].contiguous(), v[:, :, keep].contiguous(),
        lens - splits, splits)
    assert ((dropped - base).abs().amax(-1) > 10 * F32_TOL).all()


def test_routes_count_in_one_dict_that_reset_clears():
    """``sma_gemm.routes`` is the module's ``ROUTES``, zeroed by
    ``ops.reset_counts`` with the launch counters."""
    from repro_torch.kernels import ops
    assert kgemm.sma_gemm.routes is kgemm.ROUTES
    assert set(kgemm.ROUTES) == {"wgmma", "splitk", "tile", "f32"}
    kgemm.ROUTES["wgmma"] += 3
    ops.reset_counts()
    assert set(kgemm.sma_gemm.routes.values()) == {0}


# ------------------------------------------------------- flash attention
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d,backward", [(64, False), (128, False),
                                        (256, False), (64, True),
                                        (128, True), (256, True)])
def test_flash_route_is_wgmma_for_what_the_kernels_take(dtype, d, backward):
    assert kflash._route(d, dtype, backward) == "wgmma"


@pytest.mark.parametrize("dtype,d,backward", [
    (torch.float32, 64, False), (torch.bfloat16, 32, False),
    (torch.bfloat16, 192, False), (torch.bfloat16, 192, True),
    (torch.float16, 512, False)])
def test_flash_route_refuses_what_the_kernels_do_not_take(dtype, d,
                                                          backward):
    with pytest.raises(ValueError, match="no flash route"):
        kflash._route(d, dtype, backward)


@pytest.mark.parametrize("d,backward", [(64, False), (128, False),
                                        (256, False), (64, True),
                                        (128, True), (256, True)])
def test_flash_shared_memory_fits_a_block(d, backward):
    """Every (head_dim, direction) the kernels take fits the 227 KB a
    block may use, with the tiles the kernel's header states."""
    got = kflash.smem_bytes(d, backward)
    assert got <= kflash.SMEM_LIMIT
    kb = 1 << 10
    if backward and d == 256:   # K + V of 64 keys, 2 stages of (Q, dO of
        #            64 rows, dS^T 64 x 64), their lse / delta, 1 + 2
        #            mbarriers; no dQ tiles (added from registers)
        assert got == 64 * kb + 2 * (64 * kb + 8 * kb) + kb + kb + 8 * 3
        assert got == 215_064
    elif backward:   # K + V, a ring of (Q, dO, dS^T, lse / delta: 3 at
        #            D 64, 2 at D 128), two dQ tiles, 1 + 3 x stages
        #            mbarriers
        kv = {64: 32 * kb, 128: 64 * kb}[d]
        stages = {64: 3, 128: 2}[d]
        assert got == (kv + stages * (kv // 2 + 16 * kb + kb // 2)
                       + 2 * 64 * d * 4 + kb + 8 * (1 + 3 * stages))
    else:          # Q, a ring of K + V (3 of 128 keys, 2 of 64 at D 256)
        q = {64: 16 * kb, 128: 32 * kb, 256: 64 * kb}[d]
        stages, kv = {64: (3, 32 * kb), 128: (3, 64 * kb),
                      256: (2, 64 * kb)}[d]
        assert got == q + stages * kv + kb + 8 * (1 + 2 * stages)


def test_flash_routes_count_in_dicts_that_reset_clears():
    from repro_torch.kernels import ops
    assert kflash.flash_attention_fwd.routes is kflash.FWD_ROUTES
    assert kflash.flash_attention_bwd.routes is kflash.BWD_ROUTES
    kflash.FWD_ROUTES["wgmma"] += 2
    kflash.BWD_ROUTES["wgmma"] += 1
    ops.reset_counts()
    assert kflash.FWD_ROUTES == {"wgmma": 0}
    assert kflash.BWD_ROUTES == {"wgmma": 0}


# ------------------------------------------------------------ rmsnorm_gemm
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("m,route", [(1, "tile"), (8, "tile"), (16, "tile"),
                                     (17, "wgmma"), (2048, "wgmma"),
                                     (8192, "wgmma")])
def test_norm_route_aligned_16_bit_operands(dtype, m, route):
    """The head: decode sizes (M <= 16) stay on the tile kernel, the
    training head (M 8192) goes to wgmma."""
    for k, n in ((2048, 100352), (2048, 50432), (64, 392)):
        assert knorm._route(m, n, k, dtype, True) == route


@pytest.mark.parametrize("m", [1, 17, 8192])
@pytest.mark.parametrize("k,n,aligned", [(2048, 1000, True),
                                         (2050, 1024, True),
                                         (2048, 1024, False)])
def test_norm_route_what_tma_cannot_take_goes_to_the_tile_kernel(m, k, n,
                                                                 aligned):
    """N = 1000 is a multiple of 8 and goes where sma_gemm's would; K or N
    not a multiple of 8, or an offset base, take the tile kernel."""
    want = "wgmma" if m > 16 and n % 8 == 0 and k % 8 == 0 and aligned \
        else "tile"
    assert knorm._route(m, n, k, torch.bfloat16, aligned) == want
    assert knorm._route(m, n, k, torch.float32, aligned) == "f32"


# --------------------------------------------------------- mlstm_chunkwise
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("s,d,chunk", [(2048, 1024, 128), (2000, 1024, 128),
                                       (128, 64, 128), (300, 128, 128),
                                       (1000, 192, 128)])
def test_mlstm_route_wgmma_for_16_bit_chunks_of_128(dtype, s, d, chunk):
    """L = min(chunk, S) = 128 and D a multiple of 64: the wgmma kernels
    and any S of at least 128."""
    assert kmlstm._route(s, d, chunk, dtype, True) == "wgmma"


@pytest.mark.parametrize("s,d,chunk,dtype,aligned", [
    (1000, 64, 128, torch.float32, True),     # f32
    (2048, 1024, 64, torch.bfloat16, True),   # another chunk
    (100, 64, 128, torch.bfloat16, True),     # S < 128: L = S
    (2048, 200, 128, torch.bfloat16, True),   # D not a multiple of 64
    (2048, 1024, 128, torch.bfloat16, False)])  # an offset base
def test_mlstm_route_simt_for_the_rest(s, d, chunk, dtype, aligned):
    assert kmlstm._route(s, d, chunk, dtype, aligned) == "simt"


def test_norm_and_mlstm_routes_count_in_dicts_that_reset_clears():
    from repro_torch.kernels import ops
    assert knorm.rmsnorm_gemm.routes is knorm.ROUTES
    assert kmlstm.mlstm_chunkwise.routes is kmlstm.ROUTES
    assert set(knorm.ROUTES) == {"wgmma", "tile", "f32"}
    assert set(kmlstm.ROUTES) == {"wgmma", "simt"}
    knorm.ROUTES["wgmma"] += 2
    kmlstm.ROUTES["simt"] += 1
    ops.reset_counts()
    assert set(knorm.ROUTES.values()) == {0}
    assert set(kmlstm.ROUTES.values()) == {0}
