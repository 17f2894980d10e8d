"""Core SMA library: the paper's contribution as composable pieces
(``repro.core``).

* :mod:`modes`     -- the two execution modes and the op taxonomy;
* :mod:`dataflow`  -- the analytical model of the three GEMM dataflows
  (Figs. 1, 7 and 8);
* :mod:`sma`       -- the SMA execution policy (mode planning + fusion) and
  the named epilogues;
* :mod:`scheduler` -- temporal multi-stream scheduling (Fig. 9);
* :mod:`roofline`  -- the 3-term roofline, with an H100 entry.
"""
from repro_torch.core.modes import (ExecMode, Op, OpKind, classify_op,
                                    mode_histogram)
from repro_torch.core.sma import (EPILOGUE_CODES, EPILOGUES, FusionGroup,
                                  PlanSummary, SMAPolicy)

__all__ = ["EPILOGUE_CODES", "EPILOGUES", "ExecMode", "FusionGroup", "Op",
           "OpKind", "PlanSummary", "SMAPolicy", "classify_op",
           "mode_histogram"]
