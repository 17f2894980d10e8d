"""The port stands alone: it imports neither JAX nor the JAX package."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any "import jax" now raises
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
loaded = sorted(m for m in sys.modules
                if m == "repro" or m.startswith("repro."))
assert not loaded, loaded
assert "jaxlib" not in sys.modules
assert "triton" not in sys.modules
print(" ".join(names))
"""

#: Modules each slice of the port added; every one must be among those
#: imported above.
MODULES = (
    "repro_torch.kernels.sma_gemm", "repro_torch.kernels.norm_gemm",
    "repro_torch.kernels.decode_attention", "repro_torch.serving.engine",
    "repro_torch.kernels.flash_attention", "repro_torch.kernels.autograd",
    "repro_torch.launch.train", "repro_torch.optim.adamw",
    "repro_torch.kernels.rglru", "repro_torch.models.recurrent",
    "repro_torch.configs.recurrentgemma_2b", "repro_torch.convert",
    "repro_torch.kernels.mlstm", "repro_torch.configs.xlstm_1_3b",
    "repro_torch.core.modes", "repro_torch.core.dataflow",
    "repro_torch.core.scheduler", "repro_torch.core.roofline",
    "repro_torch.compiler", "repro_torch.compiler.trace",
    "repro_torch.compiler.lower", "repro_torch.compiler.fuse",
    "repro_torch.compiler.rewrite", "repro_torch.compiler.report",
    "repro_torch.compiler.dispatch", "repro_torch.api",
    "repro_torch.api.options", "repro_torch.api.engine",
    "repro_torch.backends", "repro_torch.backends.base",
    "repro_torch.backends.registry", "repro_torch.obs",
    "repro_torch.obs.trace", "repro_torch.obs.metrics",
    "repro_torch.obs.timing", "repro_torch.obs.export",
    "repro_torch.checkpoint", "repro_torch.checkpoint.manager",
    "repro_torch.optim.compress", "repro_torch.resilience",
    "repro_torch.resilience.faults", "repro_torch.resilience.guard",
    "repro_torch._deprecation", "repro_torch.launch.serve",
    "repro_torch.configs.mistral_nemo_12b", "repro_torch.configs.deepseek_67b",
    "repro_torch.configs.deepseek_coder_33b",
    "repro_torch.configs.musicgen_large", "repro_torch.configs.internvl2_2b",
    "repro_torch.models.moe", "repro_torch.configs.qwen3_moe_30b_a3b",
    "repro_torch.configs.dbrx_132b", "repro_torch.data.pipeline",
    "repro_torch.kernels.ops", "repro_torch.kernels.ref",
    "repro_torch.compiler.loop", "repro_torch.launch.mesh",
    "repro_torch.distributed", "repro_torch.distributed.collectives",
    "repro_torch.distributed.sharding", "repro_torch.distributed.summa",
    "repro_torch.distributed.pipeline",
    "repro_torch.distributed.tensor_parallel",
)


def test_port_and_chip_smoke_import_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.strip().splitlines()[-1].split())
    assert len(names) >= 18
    assert not set(MODULES) - names, set(MODULES) - names


def test_the_scans_gradients_are_entries_of_the_port():
    """What the fifteenth slice added is reachable where the trainer and
    the compiler look for it: the RG-LRU backward wrapper with its own
    counter and routes, its plain version and autograd Function, the
    scans' backward custom ops, the flash backward at head_dim 256, and
    the data pipeline's input modes."""
    import dataclasses

    from repro_torch.compiler import trace
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import autograd, flash_attention, ops, ref, rglru

    assert ops.WRAPPERS["rglru_scan_bwd"] is rglru.rglru_scan_bwd
    assert rglru.rglru_scan_bwd.routes is rglru.BWD_ROUTES
    assert callable(ref.rglru_scan_bwd_ref)
    assert issubclass(autograd.RgluScan, __import__("torch").autograd.Function)
    names = {getattr(op, "_schema").name for op in trace.GRADIENT_OPS}
    assert {"repro_torch::rglru_scan_bwd",
            "repro_torch::mlstm_chunkwise_bwd"} <= names
    assert 256 in flash_attention.BWD_HEAD_DIMS
    fields = {f.name for f in dataclasses.fields(DataConfig)}
    assert {"input_mode", "d_model", "num_vision_tokens"} <= fields
