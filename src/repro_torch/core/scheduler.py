"""Temporal multi-stream scheduler — the paper's autonomous-driving study.

Reproduces Sec. V-C / Fig. 9: an end-to-end driving pipeline with three
algorithms — DET(ection) = DeepLab, TRA(cking) = GOTURN, LOC(alization) =
ORB-SLAM — on three platforms:

* ``GPU``  — baseline Volta running everything back-to-back (frame latency is
  the sum of the three; the paper anchors this above the 100 ms target),
* ``TC``   — spatial integration: DET+TRA sequential on the TensorCores, LOC
  in parallel on the CUDA cores,
* ``SMA``  — temporal integration: every algorithm gets the *whole* substrate
  in the mode it wants (systolic for the CNNs, SIMD for ORB-SLAM).

Anchors and factors: per-algorithm GPU-baseline latencies are the paper's
measured Fig. 9 values (constants below); platform speedups are **derived from
the dataflow model** (`core.dataflow`), not hard-coded — the iso-area CNN
speedup comes from `network_time` on the DeepLab/GOTURN GEMM lists, and the
SIMD-mode speedup from the lane-scaling model.  The dynamic-N experiment
(detection every N frames, tracking every frame) then shows SMA's
mode-reallocation win.

A copy of ``repro.core.scheduler``, which imports no JAX: the port keeps its own
and is held to the reference's values exactly (``tests/test_torch_core.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.core import dataflow as df

# Per-algorithm single-frame latency on the baseline GPU (ms), read from the
# paper's Fig. 9 left plane (GPU bar ~= 105 ms total, over the 100 ms target).
# DET = DeepLab at 513 px dominates; TRA = GOTURN is a 100-fps tracker by
# construction (~10 ms class); LOC = ORB-SLAM tracking thread.
GPU_BASELINE_MS = {"DET": 65.0, "TRA": 12.0, "LOC": 28.0}
#: CNN (GEMM-mode) share of each algorithm's time on the baseline; remainder
#: is SIMD-mode work (CRF for DeepLab-DET; box regression glue for GOTURN-TRA;
#: ORB-SLAM is entirely non-CNN).
CNN_SHARE = {"DET": 0.82, "TRA": 0.88, "LOC": 0.0}
LATENCY_TARGET_MS = 100.0


def goturn_gemms(batch: int = 2) -> List[df.GemmShape]:
    """GOTURN: two AlexNet-style conv towers (227 px crops) + 3 FC layers."""
    towers = df.alexnet_gemms(batch=batch)[:5]  # conv1..conv5, both crops
    fcs = [df.GemmShape(1, 4096, 2 * 256 * 6 * 6, "fc1"),
           df.GemmShape(1, 4096, 4096, "fc2"),
           df.GemmShape(1, 4, 4096, "fc3")]
    return towers + fcs


def _cnn_speedup(net_gemms: List[df.GemmShape], eng: df.EngineConfig) -> float:
    """Model-derived speedup of `eng` over the 4-TC baseline for a GEMM list."""
    base = sum(df.gemm_time_us(g, df.TC_4) for g in net_gemms)
    new = sum(df.gemm_time_us(g, eng) for g in net_gemms)
    return base / new


def _simd_speedup(lanes_new: int, lanes_base: int = 64,
                  alu_fraction: float = 0.6) -> float:
    """SIMD-mode speedup from lane scaling; memory-bound share doesn't scale."""
    return 1.0 / (alu_fraction * lanes_base / lanes_new + (1 - alu_fraction))


@dataclasses.dataclass
class AlgTimes:
    """Per-algorithm latency (ms) on one platform."""

    det: float
    tra: float
    loc: float


def platform_times(platform: str) -> AlgTimes:
    """Per-algorithm latencies, anchored to GPU baseline x model factors."""
    if platform == "GPU":
        f_det = f_tra = f_simd = 1.0
    elif platform == "TC":
        # Spatial: CNNs stay at TC speed, SIMD ops at 64 CUDA lanes.
        f_det = f_tra = f_simd = 1.0
    elif platform == "SMA":
        f_det = _cnn_speedup(df.deeplab_gemms(), df.SMA_3)
        f_tra = _cnn_speedup(goturn_gemms(), df.SMA_3)
        f_simd = _simd_speedup(192)  # 3 SMA units reconfigured to SIMD lanes
    else:
        raise ValueError(platform)

    def t(alg: str, f_cnn: float) -> float:
        base = GPU_BASELINE_MS[alg]
        cnn = base * CNN_SHARE[alg]
        simd = base - cnn
        return cnn / f_cnn + simd / f_simd

    return AlgTimes(det=t("DET", f_det), tra=t("TRA", f_tra),
                    loc=t("LOC", 1.0))


def frame_latency_ms(platform: str, det_every_n: int = 1) -> float:
    """Average per-frame latency with detection every N frames.

    GPU/SMA run temporally (one stream at a time, whole chip each);
    TC runs DET+TRA on the tensor cores with LOC hidden on the CUDA cores.
    """
    t = platform_times(platform)
    det_amortized = t.det / det_every_n
    if platform == "TC":
        # Spatial overlap: LOC runs on the CUDA cores in parallel with the
        # CNN GEMMs on the TensorCores — but the CNNs' own SIMD-mode portions
        # (CRF, glue) also need the CUDA cores and serialize with LOC.
        cnn_det = GPU_BASELINE_MS["DET"] * CNN_SHARE["DET"] / det_every_n
        cnn_tra = GPU_BASELINE_MS["TRA"] * CNN_SHARE["TRA"]
        simd_det = GPU_BASELINE_MS["DET"] * (1 - CNN_SHARE["DET"]) / det_every_n
        simd_tra = GPU_BASELINE_MS["TRA"] * (1 - CNN_SHARE["TRA"])
        return max(cnn_det + cnn_tra, t.loc + simd_det + simd_tra)
    return det_amortized + t.tra + t.loc


def fig9_table() -> Dict[str, Dict[str, float]]:
    """All Fig. 9 numbers: left plane (N=1) and right plane (N=4 on SMA)."""
    out: Dict[str, Dict[str, float]] = {}
    for p in ("GPU", "TC", "SMA"):
        t = platform_times(p)
        out[p] = {
            "det_ms": t.det, "tra_ms": t.tra, "loc_ms": t.loc,
            "frame_ms_n1": frame_latency_ms(p, 1),
            "frame_ms_n4": frame_latency_ms(p, 4),
            "meets_target_n1": frame_latency_ms(p, 1) <= LATENCY_TARGET_MS,
        }
    sma = out["SMA"]
    sma["latency_reduction_n4"] = 1.0 - sma["frame_ms_n4"] / sma["frame_ms_n1"]
    return out
