"""The RG-LRU scan's route choice and its planted faults' plain version.

``repro_torch.kernels.rglru._route`` picks the ``tma`` kernel where TMA can
take the strides (a row of D elements a multiple of 16 bytes, 16-byte
aligned bases) and the ``simt`` kernel otherwise, in plain Python: that
choice is tested here, on the CPU.  So is
``ref.rglru_scan_planted_ref``, the output ``chip_smoke.py`` holds the
``tma`` kernel's planted faults to.  The kernels themselves run on the
card (``tests/test_torch_cuda.py``, marker ``cuda``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import rglru as krglru

DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s", [(4, 4096), (1, 1), (1, 4097), (3, 33)])
def test_route_main_path_shapes_take_tma(dtype, b, s):
    """RecurrentGemma-2B's lru width (2560) at its prefill, and the ragged
    widths of the card tests, in every dtype."""
    for d in (2560, 2568, 2536, 96, 64, 16):
        assert krglru._route(b, s, d, dtype, True) == "tma"


@pytest.mark.parametrize("d,dtype", [
    (7, torch.bfloat16), (130, torch.bfloat16), (4, torch.bfloat16),
    (2564, torch.float16), (7, torch.float32), (130, torch.float32),
    (2562, torch.float32), (1, torch.float32)])
def test_route_rows_tma_cannot_stride_go_to_simt(d, dtype):
    """A row of D elements that is not a multiple of 16 bytes."""
    assert d * torch.finfo(dtype).bits // 8 % 16
    assert krglru._route(4, 4096, d, dtype, True) == "simt"


@pytest.mark.parametrize("dtype", DTYPES)
def test_route_unaligned_bases_go_to_simt(dtype):
    assert krglru._route(4, 4096, 2560, dtype, False) == "simt"


def test_route_of_offset_views():
    """The wrapper's alignment test on a view one element into a buffer:
    such a base is never 16-byte aligned, a fresh tensor always is."""
    buf = torch.zeros(1 + 2 * 64 * 2560, dtype=torch.bfloat16)
    off = buf[1:].view(2, 64, 2560)
    fresh = torch.zeros((2, 64, 2560), dtype=torch.bfloat16)
    assert off.data_ptr() % 16 and fresh.data_ptr() % 16 == 0
    assert krglru._route(2, 64, 2560, off.dtype,
                         off.data_ptr() % 16 == 0) == "simt"
    assert krglru._route(2, 64, 2560, fresh.dtype,
                         fresh.data_ptr() % 16 == 0) == "tma"


def test_cpu_tensors_run_the_plain_version_and_count_nothing():
    ops.reset_counts()
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.uniform(0.1, 0.9, (2, 9, 16))).float()
    u = torch.from_numpy(rng.standard_normal((2, 9, 16))).float()
    got = krglru.rglru_scan(a, u)
    want = ref.rglru_scan_ref(a, u)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ops.launch_counts()["rglru_scan"] == 0
    assert krglru.rglru_scan.routes == {"tma": 0, "simt": 0}


def test_reset_counts_clears_the_routes():
    krglru.ROUTES["tma"] = 3
    krglru.ROUTES["simt"] = 1
    ops.reset_counts()
    assert krglru.rglru_scan.routes == {"tma": 0, "simt": 0}


def _scan_inputs(b, s, d, seed):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.uniform(0.05, 0.95, (b, s, d))).float()
    u = torch.from_numpy(rng.standard_normal((b, s, d)) * 0.1).float()
    h0 = torch.from_numpy(rng.standard_normal((b, d))).float()
    return a, u, h0


@pytest.mark.parametrize("s", [64 * 7, 64 * 7 + 5])
def test_planted_ref_without_a_fault_is_the_plain_version(s):
    a, u, h0 = _scan_inputs(2, s, 8, 1)
    got = ref.rglru_scan_planted_ref(a, u, h0, 0, rows=64, stages=3)
    want = ref.rglru_scan_ref(a, u, h0)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("s,moves", [(64 * 9, True), (64 * 9 + 1, True),
                                     (64 * 5, False)])
def test_planted_early_stage_reads_the_slot_a_ring_before(s, moves):
    """Stage nst // 2 reads the rows ``stages`` stages back (only where that
    stage exists): h_seq is the plain scan of those inputs."""
    rows, stages = 64, 3
    a, u, h0 = _scan_inputs(2, s, 8, 2)
    got_seq, got_last = ref.rglru_scan_planted_ref(
        a, u, h0, ref.SCAN_PLANT_EARLY, rows=rows, stages=stages)
    kp = -(-s // rows) // 2
    want_seq, _ = ref.rglru_scan_ref(a, u, h0)
    if not moves:
        assert kp < stages and torch.equal(got_seq, want_seq)
        return
    lo, back = kp * rows, stages * rows
    a2, u2 = a.clone(), u.clone()
    a2[:, lo:lo + rows] = a[:, lo - back:lo - back + rows]
    u2[:, lo:lo + rows] = u[:, lo - back:lo - back + rows]
    want2 = ref.rglru_scan_ref(a2, u2, h0)
    assert torch.equal(got_seq, want2[0]) and torch.equal(got_last, want2[1])
    assert torch.equal(got_seq[:, :lo], want_seq[:, :lo])
    assert not torch.equal(got_seq[:, lo:lo + rows], want_seq[:, lo:lo + rows])


@pytest.mark.parametrize("s", [32 * 4 + 1, 32 * 4 + 31, 32 * 4])
def test_planted_tail_zeroes_h_last_only_past_a_ragged_s(s):
    """The carry run through the zero-filled rows past S is 0; h_seq (the
    store clips those rows) is unchanged; with S a multiple of the stage
    there is no padded row and nothing moves."""
    a, u, h0 = _scan_inputs(2, s, 8, 3)
    got_seq, got_last = ref.rglru_scan_planted_ref(
        a, u, h0, ref.SCAN_PLANT_TAIL, rows=32, stages=3)
    want_seq, want_last = ref.rglru_scan_ref(a, u, h0)
    assert torch.equal(got_seq, want_seq)
    if s % 32:
        assert torch.equal(got_last, torch.zeros_like(want_last))
    else:
        assert torch.equal(got_last, want_last)


@pytest.mark.parametrize("s", [64 * 6, 64 * 3 + 7, 40])
def test_planted_store_drop_zeroes_one_stage_of_h_seq(s):
    a, u, h0 = _scan_inputs(1, s, 8, 4)
    got_seq, got_last = ref.rglru_scan_planted_ref(
        a, u, h0, ref.SCAN_PLANT_STORE, rows=64, stages=3)
    want_seq, want_last = ref.rglru_scan_ref(a, u, h0)
    kp = -(-s // 64) // 2
    lo, hi = kp * 64, min((kp + 1) * 64, s)
    assert torch.equal(got_last, want_last)
    assert torch.equal(got_seq[:, lo:hi], torch.zeros_like(got_seq[:, lo:hi]))
    keep = torch.ones(s, dtype=torch.bool)
    keep[lo:hi] = False
    assert torch.equal(got_seq[:, keep], want_seq[:, keep])
