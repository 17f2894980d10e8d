"""The port's analytical core against ``repro.core``, on the same inputs.

``repro_torch.core`` keeps its own copies of ``dataflow``, ``scheduler``,
``roofline`` and ``modes`` (the port imports nothing of ``repro``) and its
own ``SMAPolicy``.  Every value here must equal the reference's exactly:
the same float arithmetic in the same order.  Inputs: every engine
configuration and network GEMM list the reference's dataflow module
defines, a hypothesis sweep of GEMM shapes, the HLO strings of
``tests/test_core.py``, every ``OpKind``, and op lists drawn by hypothesis
for every planner option the reference's own tests exercise.
"""
import dataclasses
import enum

import pytest

try:  # hypothesis is optional: property-based cases skip without it
    from hypothesis import given, settings, strategies as st
except ImportError:  # pragma: no cover
    given = settings = st = None

from repro.core import dataflow as jdf
from repro.core import modes as jmodes
from repro.core import roofline as jrl
from repro.core import scheduler as jsched
from repro.core import sma as jsma
from repro_torch.core import dataflow as df
from repro_torch.core import modes
from repro_torch.core import roofline as rl
from repro_torch.core import scheduler
from repro_torch.core.sma import SMAPolicy

ENGINES = [name for name, v in vars(jdf).items()
           if isinstance(v, jdf.EngineConfig)]
NETWORK_FNS = ["alexnet_gemms", "vgg_a_gemms", "googlenet_gemms",
               "mask_rcnn_gemms", "deeplab_gemms"]


def plain(x):
    """Dataclasses and enums as dicts and values, for comparing objects of
    the two packages' (distinct) classes."""
    if dataclasses.is_dataclass(x):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    return x


def port_shape(g):
    return df.GemmShape(g.m, g.n, g.k, g.name)


def gemm_values(mod, g, eng):
    return (plain(mod.gemm_cycles(g, eng)), mod.gemm_cycles(g, eng).total,
            mod.gemm_cycles(g, eng).bound, plain(mod.gemm_traffic(g, eng)),
            mod.gemm_traffic(g, eng).energy_pj(mod.V100),
            mod.gemm_time_us(g, eng),
            mod.gemm_flops_efficiency(g, eng),
            mod.gemm_flops_efficiency(g, eng, measured=True),
            mod.gemm_energy_mj(g, eng))


def same_gemm(g, name):
    want = gemm_values(jdf, g, getattr(jdf, name))
    got = gemm_values(df, port_shape(g), getattr(df, name))
    assert got == want, (name, g)


# ---------------------------------------------------------------- dataflow
def test_engine_configs_and_constants_match():
    assert ENGINES and sorted(ENGINES) == sorted(
        n for n, v in vars(df).items() if isinstance(v, df.EngineConfig))
    for name in ENGINES:
        assert plain(getattr(df, name)) == plain(getattr(jdf, name))
    assert plain(df.V100) == plain(jdf.V100)
    assert (df.TILE_M, df.TILE_N, df.DTYPE_BYTES) == \
        (jdf.TILE_M, jdf.TILE_N, jdf.DTYPE_BYTES)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("net", NETWORK_FNS)
def test_dataflow_matches_reference_on_network_gemms(engine, net):
    for batch in (1, 16):
        gemms = getattr(jdf, net)(batch)
        assert plain(getattr(df, net)(batch)) == plain(gemms)
        for g in gemms:
            same_gemm(g, engine)


@pytest.mark.parametrize("engine", ENGINES)
def test_network_time_matches_reference(engine):
    assert sorted(df.NETWORKS) == sorted(jdf.NETWORKS)
    for name in jdf.NETWORKS:
        for lanes in (64, 128, 192):
            want = jdf.network_time(name, getattr(jdf, engine),
                                    simd_lanes_when_general=lanes)
            got = df.network_time(name, getattr(df, engine),
                                  simd_lanes_when_general=lanes)
            assert plain(got) == plain(want)
            assert got.total_us == want.total_us


def test_dataflow_fixed_grid_matches_reference():
    """Deterministic slice of the sweep below (runs without hypothesis)."""
    for m, n, k in [(1, 1, 1), (64, 64, 64), (100, 70, 50),
                    (3000, 1000, 500), (8192, 8192, 8192)]:
        for name in ENGINES:
            same_gemm(jdf.GemmShape(m, n, k), name)


if st is not None:
    @settings(max_examples=40, deadline=None)
    @given(m=st.integers(1, 20000), n=st.integers(1, 20000),
           k=st.integers(1, 20000))
    def test_dataflow_sweep_matches_reference(m, n, k):
        for name in ENGINES:
            same_gemm(jdf.GemmShape(m, n, k), name)
else:
    def test_dataflow_sweep_matches_reference():
        pytest.importorskip("hypothesis")


# --------------------------------------------------------------- scheduler
def test_fig9_table_matches_reference():
    assert scheduler.fig9_table() == jsched.fig9_table()
    for platform in ("GPU", "TC", "SMA"):
        for n in (1, 2, 4, 8):
            assert scheduler.frame_latency_ms(platform, n) == \
                jsched.frame_latency_ms(platform, n)


# ---------------------------------------------------------------- roofline
HLOS = [
    """
  %ag = f32[4096,8192]{0,1} all-gather(%a), replica_groups={{0,1,2,3}}, dimensions={0}
  %ar = bf16[256,1024]{1,0} all-reduce(%b), replica_groups=[16,16]<=[256]
  %rs = bf16[64,128]{1,0} reduce-scatter(%c), replica_groups=[32,16]<=[512], dimensions={0}
  %cp = u32[8]{0} collective-permute(%d), source_target_pairs={{0,1}}
""",
    """
  %s = bf16[128]{0} all-reduce-start(%x), replica_groups={{0,1}}
  %d = bf16[128]{0} all-reduce-done(%s)
""",
    "",
]


@pytest.mark.parametrize("hlo", HLOS)
def test_collective_parse_matches_reference(hlo):
    assert rl.collective_bytes_from_hlo(hlo) == \
        jrl.collective_bytes_from_hlo(hlo)


@pytest.mark.parametrize("hlo", HLOS)
def test_from_compiled_matches_reference(hlo):
    cost = {"flops": 197e12, "bytes accessed": 819e9 * 2}
    for chips in (1, 4):
        got = rl.from_compiled(cost, hlo, chips=chips, model_flops=98.5e12,
                               bytes_per_device=1e9)
        want = jrl.from_compiled(cost, hlo, chips=chips,
                                 model_flops=98.5e12, bytes_per_device=1e9)
        assert got.summary() == want.summary()
        assert plain(got.hw) == plain(want.hw) == plain(rl.V5E)


def test_h100_entry_is_the_data_sheet():
    """The port's card, from NVIDIA's H100 SXM data sheet (not a
    measurement): 989 TFLOP/s bf16 dense, 3.35 TB/s, 80 GB, NVLink 900
    GB/s; the roofline's terms follow from it."""
    assert (rl.H100.peak_flops, rl.H100.hbm_bw, rl.H100.hbm_bytes,
            rl.H100.ici_bw) == (989e12, 3.35e12, 80e9, 900e9)
    t = rl.RooflineTerms(flops=989e12, hbm_bytes=3.35e12 * 2,
                         collective_bytes=900e9 * 0.5, chips=1,
                         model_flops=494.5e12, hw=rl.H100)
    assert t.compute_s == pytest.approx(1.0)
    assert t.memory_s == pytest.approx(2.0)
    assert t.collective_s == pytest.approx(0.5)
    assert t.dominant == "memory"
    assert t.roofline_fraction == pytest.approx(0.25)
    assert rl.V5E.name == "tpu-v5e" and rl.H100.name == "h100-sxm"


# ------------------------------------------------------------ modes, policy
@pytest.mark.parametrize("kind", list(jmodes.OpKind))
def test_classify_op_matches_reference(kind):
    port_kind = modes.OpKind(kind.value)
    assert modes.classify_op(port_kind).value == \
        jmodes.classify_op(kind).value
    assert (port_kind in modes.FUSABLE_INTO_SYSTOLIC) == \
        (kind in jmodes.FUSABLE_INTO_SYSTOLIC)


def test_route_table_is_static_and_by_device():
    from repro_torch.backends import BACKENDS
    assert modes.BACKEND_ROUTE == {"cuda": "cuda", "cpu": "plain"}
    assert BACKENDS["cuda"].mode == modes.ExecMode.SYSTOLIC
    assert BACKENDS["plain"].mode == modes.ExecMode.SIMD


def ref_ops(ops):
    return [jmodes.Op(o.name, jmodes.OpKind(o.kind.value), flops=o.flops,
                      bytes_in=o.bytes_in, bytes_out=o.bytes_out,
                      tile_local=o.tile_local, comm_bytes=o.comm_bytes)
            for o in ops]


#: Every policy option the reference's test_core / test_compiler exercise.
POLICIES = [{}, {"max_epilogue_ops": 4}, {"max_epilogue_ops": 1},
            {"max_epilogue_ops": 0}, {"fuse_epilogues": False}]


def same_plan(ops, kw):
    got_p, want_p = SMAPolicy(**kw), jsma.SMAPolicy(**kw)
    jops = ref_ops(ops)
    got, want = got_p.plan(ops), want_p.plan(jops)
    assert [([o.name for o in g.ops], g.mode.value, g.fused_simd_ops,
             g.bytes_kept_in_vmem,
             g.anchor.name if g.anchor is not None else None)
            for g in got] == \
        [([o.name for o in g.ops], g.mode.value, g.fused_simd_ops,
          g.bytes_kept_in_vmem,
          g.anchor.name if g.anchor is not None else None) for g in want]
    assert plain(got_p.summarize(ops)) == plain(want_p.summarize(jops))
    got_h, want_h = modes.mode_histogram(ops), jmodes.mode_histogram(jops)
    assert {m.value: v for m, v in got_h.items()} == \
        {m.value: v for m, v in want_h.items()}


K = modes.OpKind
#: The reference tests' own op lists: epilogue budget, a tile_local=False
#: reduction, a leading SIMD program, consecutive anchors, the mixed
#: attention + MoE plan.
CASES = {
    "budget": [modes.Op("gemm", K.MATMUL, flops=1e9)] + [
        modes.Op(f"ew{i}", K.ELEMENTWISE, flops=1e3, bytes_in=1e3)
        for i in range(6)],
    "cross_tile": [modes.Op("gemm", K.MATMUL, flops=1e9),
                   modes.Op("softmax_full", K.REDUCTION, flops=1e4,
                            bytes_in=1e4, tile_local=False),
                   modes.Op("scale", K.ELEMENTWISE, flops=1e3)],
    "leading_simd": [modes.Op("embed", K.GATHER_SCATTER, tile_local=False),
                     modes.Op("scale", K.ELEMENTWISE, flops=1e3),
                     modes.Op("gemm", K.MATMUL, flops=1e9)],
    "anchors": [modes.Op("a", K.MATMUL, flops=1e9),
                modes.Op("b", K.MATMUL, flops=1e9),
                modes.Op("c", K.ATTENTION_MATMUL, flops=1e9)],
    "mixed": [
        modes.Op("qkv_proj", K.MATMUL, flops=1e9, bytes_in=1e6),
        modes.Op("rope", K.ELEMENTWISE, flops=1e6, bytes_in=1e6),
        modes.Op("attn_scores", K.ATTENTION_MATMUL, flops=1e9),
        modes.Op("softmax", K.REDUCTION, flops=1e7, bytes_in=4e6),
        modes.Op("attn_out", K.ATTENTION_MATMUL, flops=1e9),
        modes.Op("out_proj", K.MATMUL, flops=1e9),
        modes.Op("residual", K.ELEMENTWISE, flops=1e6, bytes_in=2e6),
        modes.Op("router_topk", K.TOPK, flops=1e5, tile_local=False),
        modes.Op("dispatch", K.GATHER_SCATTER, flops=0, tile_local=False),
        modes.Op("expert_ffn", K.MATMUL, flops=4e9),
        modes.Op("combine", K.GATHER_SCATTER, flops=0, tile_local=False)],
    "empty": [],
}


@pytest.mark.parametrize("kw", POLICIES, ids=str)
@pytest.mark.parametrize("case", sorted(CASES))
def test_policy_matches_reference_on_its_test_cases(case, kw):
    same_plan(CASES[case], kw)


if st is not None:
    _op = st.builds(
        lambda i, kind, flops, bin_, bout, local: modes.Op(
            f"op{i}", kind, flops=flops, bytes_in=bin_, bytes_out=bout,
            tile_local=local),
        st.integers(0, 10**6), st.sampled_from(list(modes.OpKind)),
        st.floats(0, 1e12), st.floats(0, 1e9), st.floats(0, 1e9),
        st.booleans())

    @settings(max_examples=60, deadline=None)
    @given(ops=st.lists(_op, max_size=40),
           kw=st.sampled_from(POLICIES))
    def test_policy_matches_reference_on_drawn_programs(ops, kw):
        same_plan(ops, kw)
else:
    def test_policy_matches_reference_on_drawn_programs():
        pytest.importorskip("hypothesis")
