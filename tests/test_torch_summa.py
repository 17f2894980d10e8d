"""The port's SUMMA sharded GEMM and its cost model against the JAX
package's (``repro.distributed.summa``).

The cost model (``summa_grid``, ``summa_schedule``, ``summa_comm_stats``,
``comm_coster_for``) is held exactly in this process.  The sharded GEMM
runs on 1, 2 and 4 ``gloo`` ranks spawned here (CPU, plain versions; one
world a size, several cases in it); the JAX side runs in a subprocess on
fake devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``, as
``tests/test_summa.py`` does) and hands its outputs back as ``.npz``.  The
reference's mesh is built with ``AxisType.Auto`` axes: JAX 0.9.0's
default explicit axes refuse the reference's final ``out[:m, :n]`` slice
of a sharded array.
"""
import itertools
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

import torch_dist_workers as workers
from repro.distributed import summa as jsumma
from repro_torch import SMAOptions, sma_jit
from repro_torch.distributed import summa
from repro_torch.launch.mesh import fake_mesh, spawn

#: The reference's shapes (tests/test_summa.py): divisible, edge tiles in
#: M, N and K, and non-square.
_SHAPES = [(16, 32, 8), (6, 96, 10), (7, 33, 5), (1, 17, 3), (64, 8, 64)]


def _grid_mesh(sizes, names):
    """A mesh stand-in with the reference's ``shape`` / ``axis_names``
    surface (the cost model reads no more)."""
    return types.SimpleNamespace(axis_names=tuple(names),
                                 shape=dict(zip(names, sizes)),
                                 size=int(np.prod(sizes)))


def _jax_mesh(sizes, names):
    import jax
    try:
        return jax.sharding.AbstractMesh(tuple(sizes), tuple(names))
    except TypeError:
        return jax.sharding.AbstractMesh(tuple(zip(names, sizes)))


# --------------------------------------------------------------- cost model
@pytest.mark.parametrize("sizes,names,axes", [
    ((16, 16), ("data", "model"), None),
    ((2, 16, 16), ("pod", "data", "model"), None),
    ((2, 16, 16), ("pod", "data", "model"), ("data", "model")),
    ((2, 2), ("data", "model"), ("model", "data")),
    ((1, 4), ("data", "model"), None),
    ((4,), ("data",), None),
    ((4,), ("data",), ("data", "model")),
    ((2, 2), ("x", "y"), ("data",)),
])
def test_summa_grid_matches_reference(sizes, names, axes):
    assert summa.summa_grid(_grid_mesh(sizes, names), axes) == \
        jsumma.summa_grid(_jax_mesh(sizes, names), axes)
    coster = summa.comm_coster_for(_grid_mesh(sizes, names), axes)
    jcoster = jsumma.comm_coster_for(_jax_mesh(sizes, names), axes)
    assert (coster is None) == (jcoster is None)
    if coster is not None:
        for m, n, k in ((8192, 5632, 2048), (7, 33, 5)):
            assert coster(m, n, k, 2, 2) == jcoster(m, n, k, 2, 2)


_SWEEP = list(itertools.product((1, 7, 64, 8192), (3, 16, 5632),
                                (5, 2048), (1, 2, 3, 4), (1, 2, 4, 16)))


@pytest.mark.parametrize("part", range(4))
def test_summa_cost_model_matches_reference(part):
    """summa_schedule and summa_comm_stats equal the reference's over a
    sweep of (m, n, k, pr, pc), item sizes, overlap and axis names."""
    for m, n, k, pr, pc in _SWEEP[part::4]:
        for isz in ((4, 4), (2, 2), (2, 4)):
            assert summa.summa_schedule(
                m, n, k, pr=pr, pc=pc, itemsize_a=isz[0],
                itemsize_b=isz[1]) == jsumma.summa_schedule(
                m, n, k, pr=pr, pc=pc, itemsize_a=isz[0], itemsize_b=isz[1])
            for overlap in (True, False):
                kw = dict(pr=pr, pc=pc, itemsize_a=isz[0], itemsize_b=isz[1],
                          overlap=overlap, row_axis="data",
                          col_axis="model")
                assert summa.summa_comm_stats(m, n, k, **kw) == \
                    jsumma.summa_comm_stats(m, n, k, **kw)


def test_single_rank_is_local_and_validates_shapes():
    mesh = fake_mesh(1)
    assert summa.comm_coster_for(mesh) is None
    rng = np.random.default_rng(1)
    a = torch.tensor(rng.standard_normal((2, 3, 8)), dtype=torch.float32)
    b = torch.tensor(rng.standard_normal((8, 5)), dtype=torch.float32)
    from repro_torch.kernels import ops
    assert torch.equal(summa.sma_gemm_sharded(a, b, mesh=mesh),
                       ops.sma_gemm(a, b, mesh=False))
    with pytest.raises(ValueError, match="2-D stationary"):
        summa.sma_gemm_sharded(torch.zeros(4, 8), torch.zeros(2, 8, 3),
                               mesh=mesh)
    with pytest.raises(ValueError, match="contraction mismatch"):
        summa.sma_gemm_sharded(torch.zeros(4, 8), torch.zeros(9, 3),
                               mesh=mesh)


# ------------------------------------------------------- engine cache key
def test_mesh_change_misses_same_mesh_hits():
    eng = sma_jit(lambda x, w: x @ w)
    x, w = torch.ones(4, 8), torch.ones(8, 4)
    import repro_torch
    with repro_torch.options(mesh=fake_mesh(1)):
        eng(x, w)
        eng(x, w)                               # same mesh: hit
        assert eng.cache_size == 1 and eng.stats.hits == 1
    with repro_torch.options(mesh=fake_mesh(1, axes=("x", "y"))):
        eng(x, w)                               # another mesh: miss
        assert eng.cache_size == 2
    eng(x, w)                                   # no mesh: a third entry
    assert eng.cache_size == 3


def test_equal_meshes_share_entry_and_asdict():
    eng = sma_jit(lambda x, w: x @ w)
    x, w = torch.ones(4, 8), torch.ones(8, 4)
    import repro_torch
    with repro_torch.options(mesh=fake_mesh(1)):
        eng(x, w)
    with repro_torch.options(mesh=fake_mesh(1)):   # a fresh, equal mesh
        eng(x, w)
    assert eng.cache_size == 1 and eng.stats.hits == 1
    assert SMAOptions(mesh=fake_mesh(1)).asdict()["mesh"] == \
        {"axes": {"data": 1, "model": 1}, "devices": 1}
    from repro.distributed.sharding import MeshRules as JRules
    from repro_torch.distributed import MeshRules
    assert SMAOptions(mesh_rules=MeshRules()).asdict()["mesh_rules"] == \
        type(JRules()).__name__
    assert SMAOptions().asdict()["mesh"] is None


# ---------------------------------------------- multi-rank, against JAX
_JAX_CODE = """
    import jax, jax.numpy as jnp, numpy as np
    from repro.distributed import sma_gemm_sharded
    from repro.distributed.summa import summa_comm_stats
    from repro.launch.mesh import _balanced_grid
    data = dict(np.load({inputs!r}))
    out = {{}}
    for n in (1, 2, 4):
        r, c = _balanced_grid(n)
        mesh = jax.make_mesh((r, c), ("data", "model"),
                             devices=jax.devices()[:n],
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
        for case in sorted({{k.rsplit("_", 1)[0] for k in data}}):
            if case.startswith("bf16") and n != 4:
                continue
            a, b, bias = (jnp.asarray(data[f"{{case}}_{{x}}"])
                          for x in ("a", "b", "bias"))
            if case.startswith("bf16"):
                a, b, bias = (x.view(jnp.bfloat16) for x in (a, b, bias))
            y = sma_gemm_sharded(a, b, mesh=mesh, bias=bias, epilogue="relu")
            out[f"{{n}}_{{case}}"] = np.asarray(y.astype(jnp.float32))
    np.savez({result!r}, **out)
"""


def _run_jax(code: str, devices: int = 4) -> None:
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]


@pytest.fixture(scope="module")
def summa_runs(tmp_path_factory):
    """Inputs, the JAX package's outputs and each world's port results."""
    tmp = tmp_path_factory.mktemp("summa")
    rng = np.random.default_rng(0)
    inputs = {}
    for i, (m, k, n) in enumerate(_SHAPES):
        for name, shape in (("a", (m, k)), ("b", (k, n)), ("bias", (n,))):
            x = rng.standard_normal(shape).astype(np.float32)
            inputs[f"f32s{i}_{name}"] = x
            if i < 3:
                bits = torch.from_numpy(x).to(torch.bfloat16).view(
                    torch.int16).numpy().view(np.uint16)
                inputs[f"bf16s{i}_{name}"] = bits
    path = str(tmp / "inputs.npz")
    np.savez(path, **inputs)
    result = str(tmp / "jax.npz")
    _run_jax(_JAX_CODE.format(inputs=path, result=result))
    with np.load(result) as data:
        want = {k: data[k] for k in data.files}
    worlds = {n: spawn(workers.summa_world, n, path, timeout=240)
              for n in (1, 2, 4)}
    port = {n: [r["summa"] for r in res] for n, res in worlds.items()}
    return want, port, [r["comm"] for r in worlds[4]]


@pytest.mark.parametrize("world", [1, 2, 4])
def test_sharded_matches_reference_f32(summa_runs, world):
    """f32 within the reference's rtol/atol 1e-5 on every rank; overlap and
    serial schedules give the same bits."""
    want, port, _ = summa_runs
    for rank, res in enumerate(port[world]):
        for i in range(len(_SHAPES)):
            got = res[f"f32s{i}"]
            assert got["dtype"] == "torch.float32" and got["equal"], (rank, i)
            np.testing.assert_allclose(got["out"], want[f"{world}_f32s{i}"],
                                       rtol=1e-5, atol=1e-5)


def test_sharded_matches_reference_bf16(summa_runs):
    """bf16 on 4 ranks within the reference's 0.06."""
    want, port, _ = summa_runs
    for res in port[4]:
        for i in range(3):
            got = res[f"bf16s{i}"]
            assert got["dtype"] == "torch.bfloat16" and got["equal"]
            np.testing.assert_allclose(got["out"], want[f"4_bf16s{i}"],
                                       rtol=0.06, atol=0.06)


@pytest.mark.parametrize("world", [2, 4])
def test_ops_entry_routes_by_mesh(summa_runs, world):
    """ops.sma_gemm(mesh=) takes the sharded GEMM (counted in ROUTED) on a
    grid of more than one rank; mesh=False stays local."""
    _, port, _ = summa_runs
    for res in port[world]:
        route = res["route"]
        assert route["sharded_calls"] == 1 and route["equal"]
        assert route["local_err"] < 1e-4


def test_comm_report_reconciles_with_schedule(summa_runs):
    """The report's comm section against the plan's per-op comm bytes on a
    scan-free model at 4 ranks: both equal the reference's own
    summa_comm_stats sum; a single-rank engine reports none."""
    _, _, comm_runs = summa_runs
    want = sum(jsumma.summa_comm_stats(8, n, k, pr=2, pc=2)["bytes_total"]
               for (k, n) in ((32, 64), (64, 16)))
    for res in comm_runs:
        comm = res["comm"]
        assert comm["enabled"] and comm["grid"] == [2, 2], comm
        assert comm["num_gemm_sites"] == 2
        assert comm["bytes_total"] == want
        assert comm["plan_comm_bytes"] == want
        assert comm["predicted_overlap_fraction"] == 0.5
        assert comm["collectives_per_axis"] == {"data": 4, "model": 4}
        assert not res["comm0"]["enabled"]
        assert res["comm0"]["bytes_total"] == 0.0
        assert res["same"]


def test_comm_lane_in_trace(summa_runs):
    """Each broadcast is a comm.bcast_* span on the obs comm lane; one
    distributed.sma_gemm_sharded span with the grid."""
    _, _, comm_runs = summa_runs
    for res in comm_runs:
        assert "comm mode" in res["lanes"]
        assert res["bcast_tids"] == [res["comm_lane"]]
        assert res["bcast_bytes"] and all(b > 0 for b in res["bcast_bytes"])
        assert res["outer_grids"] == [[2, 2]]
