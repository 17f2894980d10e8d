"""The port's front door (``repro_torch.compiler`` / ``repro_torch.api``) on
the CPU, held to the reference's rules.

``repro.compiler`` does not import on this JAX (ROADMAP.md §3), so the
port is held to the rules its ``lower.py`` / ``rewrite.py`` docstrings and
README §"Runtime fusion" state, case by case as ``tests/test_compiler.py``
and ``tests/test_api.py`` check them; compiled models are held to the
port's direct ``lm.forward`` (bit for bit: the same plain versions on the
same operands) and to the JAX ``lm.forward`` at 2e-4 in f32 (the
tolerance of the other parity tests).
"""
import functools

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import repro.configs as C
from repro.models import lm as jlm
from repro.models.layers import Runtime
import repro_torch
from repro_torch import SMAOptions, convert, options, sma_jit
from repro_torch.api import current_options
from repro_torch.backends import OpSite, select_backend
from repro_torch.compiler import (TensorSpec, compile_with_options,
                                  lower_graph, render_text, rewrite_program,
                                  sma_eligible, trace_model)
from repro_torch.compiler import dispatch as cdispatch
from repro_torch.configs import get_config, reduced
from repro_torch.core.modes import OpKind
from repro_torch.core.sma import SMAPolicy
from repro_torch.kernels import ops
from repro_torch.models import layers, lm

TOL = dict(rtol=2e-4, atol=2e-4)
ACTS = {"relu": torch.relu, "tanh": torch.tanh,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "silu": lambda x: x * torch.sigmoid(x)}


def randn(*shape, dtype=torch.float32, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape)
    return torch.from_numpy(x).to(dtype)


def lowered(fn, *args):
    program = lower_graph(trace_model(fn, *args).graph)
    return program, {op.kind for op in program.ops}


@pytest.fixture
def counted(monkeypatch):
    """Calls of the GEMM entries, counted by wrapping ``ops``."""
    calls = {"sma_gemm": 0, "rmsnorm_gemm": 0}
    for name in calls:
        orig = getattr(ops, name)

        def wrapped(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(ops, name, wrapped)
    return calls


# ===========================================================================
# Lowering: one case per OpKind mapping
# ===========================================================================
class TestLowering:
    def test_matmul_kind_flops_and_bytes(self):
        program, kinds = lowered(lambda x, y: x @ y, randn(8, 32),
                                 randn(32, 16))
        assert kinds == {OpKind.MATMUL}
        (op,) = program.ops
        assert op.flops == 2 * 8 * 16 * 32
        assert op.bytes_in == (8 * 32 + 32 * 16) * 4
        assert op.bytes_out == 8 * 16 * 4

    def test_batched_product_is_attention_matmul(self):
        q, k = randn(2, 4, 16, 8), randn(2, 4, 16, 8, seed=1)
        program, kinds = lowered(
            lambda q, k: torch.einsum("bhqd,bhkd->bhqk", q, k), q, k)
        assert OpKind.ATTENTION_MATMUL in kinds
        (op,) = [o for o in program.ops
                 if o.kind == OpKind.ATTENTION_MATMUL]
        assert op.flops == 2 * (2 * 4) * 16 * 16 * 8

    def test_softmax_lowers_to_reduction_and_elementwise(self):
        program, kinds = lowered(lambda x: torch.softmax(x, -1),
                                 randn(4, 64))
        assert kinds == {OpKind.REDUCTION, OpKind.ELEMENTWISE}
        assert all(op.tile_local for op in program.ops
                   if op.kind == OpKind.REDUCTION)

    def test_non_trailing_reduction_not_tile_local(self):
        program, _ = lowered(lambda x: x.sum(0), randn(4, 64))
        (op,) = [o for o in program.ops if o.kind == OpKind.REDUCTION]
        assert not op.tile_local
        program, _ = lowered(lambda x: x.mean(-1), randn(4, 64))
        (op,) = [o for o in program.ops if o.kind == OpKind.REDUCTION]
        assert op.tile_local

    def test_gather_and_scatter(self):
        table, idx = randn(100, 16), torch.tensor([1, 5, 7, 2])
        for fn in (lambda t, i: t[i], lambda t, i: F.embedding(i, t),
                   lambda t, i: t.index_select(0, i),
                   lambda t, i: torch.zeros(10, 16).index_add(0, i % 10,
                                                              t[:4])):
            program, kinds = lowered(fn, table, idx)
            assert OpKind.GATHER_SCATTER in kinds
            assert all(not op.tile_local for op in program.ops
                       if op.kind == OpKind.GATHER_SCATTER)

    def test_topk(self):
        program, kinds = lowered(lambda x: torch.topk(x, 4), randn(4, 64))
        assert kinds == {OpKind.TOPK}
        assert all(not op.tile_local for op in program.ops)

    def test_cast(self):
        _, kinds = lowered(lambda x: x.to(torch.bfloat16), randn(8, 8))
        assert kinds == {OpKind.CAST}

    def test_elementwise_and_layout_elision(self):
        program, kinds = lowered(
            lambda x: torch.tanh(x).reshape(-1)[None, :].transpose(0, 1)
            .contiguous(), randn(4, 4))
        assert kinds == {OpKind.ELEMENTWISE}
        assert program.stats.layout_ops_elided >= 3
        (op,) = program.ops                 # transcendental weighting
        assert op.flops == 4.0 * 16

    def test_kernel_entries_are_one_op_each(self):
        b, h, s, d = 2, 2, 8, 16
        q, k, v = (randn(b, h, s, d, seed=i) for i in range(3))

        def attn(q, k, v):
            return ops.flash_attention(q, k, v, causal=True)

        program, kinds = lowered(attn, q, k, v)
        assert kinds == {OpKind.ATTENTION_MATMUL}
        (op,) = program.ops
        assert op.flops == 4.0 * b * h * (s * (s + 1) // 2) * d
        assert program.stats.kernel_entries == 1

        a, u = torch.rand(b, s, d), randn(b, s, d)
        program, kinds = lowered(lambda a, u: ops.rglru_scan(a, u)[0], a, u)
        assert kinds == {OpKind.RECURRENCE}
        lf, li = -torch.rand(b, h, s), randn(b, h, s)
        program, kinds = lowered(
            lambda *t: ops.mlstm_chunkwise(*t, chunk=4, return_state=True),
            q, k, v, lf, li)
        assert kinds == {OpKind.RECURRENCE}
        assert not program.ops[0].tile_local

    def test_sma_eligible(self):
        def nodes(fn, *args):
            graph = trace_model(fn, *args).graph
            return [n for n in graph.nodes if n.op == "call_function"]

        (mm,) = nodes(lambda x, w: x @ w, randn(4, 8), randn(8, 3))
        assert sma_eligible(mm)
        assert not any(sma_eligible(n) for n in nodes(
            torch.bmm, randn(2, 4, 8), randn(2, 8, 3)))
        addmm = [n for n in nodes(torch.addmm, randn(3), randn(4, 8),
                                  randn(8, 3)) if "addmm" in str(n.target)]
        assert sma_eligible(addmm[0])
        assert not any(sma_eligible(n) for n in nodes(
            torch.addmm, randn(4, 3), randn(4, 8), randn(8, 3)))


# ===========================================================================
# Rewrite: the reference's patterns and fallbacks
# ===========================================================================
def compiled(fn, *args, **opts):
    cm = compile_with_options(fn, *args, options=SMAOptions(**opts))
    return cm, cm.rewritten.stats


class TestRewrite:
    @pytest.mark.parametrize("bias", [False, True])
    @pytest.mark.parametrize("act", sorted(ACTS))
    def test_each_epilogue_fuses(self, act, bias):
        x, w, b = randn(2, 5, 16), randn(16, 8, seed=1), randn(8, seed=2)

        def fn(x, w, b):
            y = x @ w
            return ACTS[act]((y + b) if bias else y) * 1.0

        cm, st = compiled(fn, x, w, b)
        assert st.realized_epilogue_sites == st.realized_fused_sites == 1
        (site,) = st.sites
        assert (site["epilogue"], site["bias"]) == (act, bias)
        assert site["hbm_bytes_avoided"] > 0
        assert torch.equal(cm(x, w, b), fn(x, w, b))

    def test_silu_op_and_bias_only_chains(self):
        x, w, b = randn(6, 16), randn(16, 8, seed=1), randn(8, seed=2)
        cm, st = compiled(lambda x, w: F.silu(x @ w) + 1.0, x, w)
        assert st.sites[0]["epilogue"] == "silu"
        # the erf gelu is not the kernels' gelu: only the bias fuses
        fn = lambda x, w, b: F.gelu(x @ w + b)          # noqa: E731
        cm, st = compiled(fn, x, w, b)
        assert (st.sites[0]["epilogue"], st.sites[0]["bias"]) == \
            ("none", True)
        torch.testing.assert_close(cm(x, w, b), fn(x, w, b), **TOL)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("epilogue", ["none", "silu", "gelu"])
    def test_kernel_entry_chains_come_back_as_their_calls(self, dtype,
                                                          epilogue, counted):
        """ops.sma_gemm traces as its plain chain (casts included) and is
        rewritten to one call on the same operands."""
        x, w = randn(2, 5, 16, dtype=dtype), randn(16, 8, dtype=dtype,
                                                   seed=1)
        b = randn(8, seed=2)

        def fn(x, w, b):
            return ops.sma_gemm(x, w, bias=b, epilogue=epilogue)

        cm, st = compiled(fn, x, w, b)
        (site,) = cm.rewritten.sites
        assert site.site["folded_casts"] == (dtype == torch.bfloat16)
        assert [n.op for n in site.inputs] == ["placeholder"] * 3
        counted["sma_gemm"] = 0
        assert torch.equal(cm(x, w, b), fn(x, w, b))
        assert counted["sma_gemm"] == 2

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("act", [None, "silu"])
    def test_rmsnorm_prologue_fuses(self, dtype, act, counted):
        x = randn(2, 5, 16, dtype=dtype)
        scale, w = randn(16, seed=1), randn(16, 8, dtype=dtype, seed=2)

        def fn(x, scale, w):
            h = layers.rmsnorm_apply({"scale": scale}, x)
            y = ops.sma_gemm(h, w, epilogue=act or "none")
            return y * 2.0

        cm, st = compiled(fn, x, scale, w)
        assert st.realized_prologue_sites == st.realized_fused_sites == 1
        (site,) = st.sites
        assert site["kind"] == "prologue"
        assert site["epilogue"] == (act or "none")
        counted["sma_gemm"] = counted["rmsnorm_gemm"] = 0
        got = cm(x, scale, w)
        assert counted == {"sma_gemm": 0, "rmsnorm_gemm": 1}
        torch.testing.assert_close(got.float(), fn(x, scale, w).float(),
                                   **(TOL if dtype == torch.float32 else
                                      dict(rtol=3e-2, atol=3e-2)))

    def test_multi_consumer_falls_back(self):
        x, w = randn(6, 16), randn(16, 8, seed=1)
        fn = lambda x, w: (lambda y: torch.relu(y) + y)(x @ w)  # noqa: E731
        cm, st = compiled(fn, x, w)
        assert st.realized_fused_sites == 0
        assert st.fallback_reasons == {"multi_consumer": 1}
        assert torch.equal(cm(x, w), fn(x, w))

    def test_norm_with_several_consumers_does_not_fuse(self):
        x, scale = randn(6, 16), randn(16, seed=1)
        w1, w2 = randn(16, 8, seed=2), randn(16, 8, seed=3)

        def fn(x, scale, w1, w2):
            h = layers.rmsnorm_apply({"scale": scale}, x)
            return torch.tanh(h @ w1) + torch.tanh(h @ w2)

        cm, st = compiled(fn, x, scale, w1, w2)
        assert st.realized_prologue_sites == 0
        assert st.realized_epilogue_sites == 2
        assert torch.equal(cm(x, scale, w1, w2), fn(x, scale, w1, w2))

    def test_graph_output_falls_back(self):
        x, w = randn(2, 3, 16), randn(16, 8, seed=1)
        cm, st = compiled(lambda x, w: x @ w, x, w)
        assert st.fallback_reasons == {"graph_output": 1}
        assert [s.kind for s in cm.rewritten.sites] == ["bare"]
        assert torch.equal(cm(x, w), x @ w)

    def test_no_fusable_consumer_falls_back(self):
        x, w = randn(6, 16), randn(16, 8, seed=1)
        cm, st = compiled(lambda x, w: (x @ w).sum(-1), x, w)
        assert st.fallback_reasons == {"no_fusable_consumer": 1}

    def test_unsupported_dtype_stays_native(self, counted):
        x, w = randn(6, 16, dtype=torch.float64), randn(16, 8, seed=1,
                                                        dtype=torch.float64)
        cm, st = compiled(lambda x, w: torch.relu(x @ w), x, w)
        assert st.fallback_reasons == {"unsupported_dtype": 1}
        assert cm.rewritten.sites == []
        assert cm.report_data["dispatch"]["systolic_dispatch_sites"] == 0
        assert torch.equal(cm(x, w), torch.relu(x @ w))
        assert counted["sma_gemm"] == 0

    def test_fuse_runtime_off_dispatches_bare(self, counted):
        x, w, b = randn(6, 16), randn(16, 8, seed=1), randn(8, seed=2)
        fn = lambda x, w, b: torch.tanh(x @ w + b)     # noqa: E731
        cm, st = compiled(fn, x, w, b, fuse_runtime=False)
        assert st.realized_fused_sites == 0 and not st.fallback_reasons
        assert cm.report_data["fusion"]["realized_fused_sites"] == 0
        assert [s.kind for s in cm.rewritten.sites] == ["bare"]
        assert torch.equal(cm(x, w, b), fn(x, w, b))
        assert counted["sma_gemm"] == 1

    def test_addmm_is_a_bias_site(self):
        x, w, b = randn(6, 16), randn(8, 16, seed=1), randn(8, seed=2)
        fn = lambda x, w, b: torch.relu(F.linear(x, w, b))  # noqa: E731
        cm, st = compiled(fn, x, w, b)
        (site,) = st.sites
        assert (site["bias"], site["epilogue"]) == (True, "relu")
        torch.testing.assert_close(cm(x, w, b), fn(x, w, b), **TOL)

    def test_rewrite_leaves_the_traced_graph_alone(self):
        traced = trace_model(lambda x, w: torch.relu(x @ w), randn(4, 8),
                             randn(8, 3))
        before = [str(n) for n in traced.graph.nodes]
        rewrite_program(traced.graph)
        assert [str(n) for n in traced.graph.nodes] == before


# ===========================================================================
# Models through sma_jit
# ===========================================================================
def port_model(arch, dtype="float32", seed=0):
    import dataclasses
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype=dtype)
    return cfg, lm.init(cfg, seed=seed, device="cpu")


def tokens(cfg, shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stablelm_forward_equals_direct_with_the_same_sites(dtype, counted):
    cfg, params = port_model("stablelm-1.6b", dtype)
    batch = {"tokens": tokens(cfg, (2, 24))}
    eng = sma_jit(functools.partial(lm.forward, cfg=cfg))
    with torch.no_grad():
        want = lm.forward(params, cfg, batch)
        direct = dict(counted)
        counted.update(sma_gemm=0, rmsnorm_gemm=0)
        got = eng(params, batch=batch)
    assert torch.equal(got, want)
    assert counted == direct == {"sma_gemm": 7 * cfg.num_layers,
                                 "rmsnorm_gemm": 1}
    rep = eng.compile(params, batch=batch).report
    n = cfg.num_layers
    assert rep["dispatch"]["systolic_dispatch_sites"] == 7 * n + 1
    assert rep["dispatch"]["kernel_entry_sites"] == n
    assert rep["dispatch"]["native_dot_sites"] == 0
    fus = rep["fusion"]
    assert (fus["realized_prologue_sites"], fus["realized_epilogue_sites"]) \
        == (1, n)
    assert {s["epilogue"] for s in fus["sites"]} == {"none", "silu"}
    assert fus["fallback_reasons"] == {"no_fusable_consumer": 6 * n}
    assert rep["backends"]["chosen"] == {"plain": 8 * n + 1}
    assert "runtime fusion" in render_text(rep)


def test_stablelm_forward_matches_jax():
    jcfg = C.reduced(C.get_config("stablelm-1.6b"))
    jparams = jlm.init(jax.random.PRNGKey(0), jcfg)[0]
    tcfg = reduced(get_config("stablelm-1.6b"))
    params = convert.from_jax_params(jax.tree.map(np.asarray, jparams),
                                     tcfg, device="cpu")
    toks = tokens(tcfg, (2, 24), seed=3)
    want, _ = jlm.forward(jparams, jcfg, Runtime(remat=False),
                          {"tokens": jax.numpy.asarray(toks.numpy())})
    eng = sma_jit(functools.partial(lm.forward, cfg=tcfg))
    with torch.no_grad():
        got = eng(params, batch={"tokens": toks})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "xlstm-1.3b"])
def test_recurrent_forward_equals_direct(arch):
    """Python loops unroll in the trace; the scans stay one node each.
    The rewriter fuses norm -> projection chains the direct path runs as
    two calls (xLSTM), which changes nothing on the CPU."""
    cfg, params = port_model(arch)
    batch = {"tokens": tokens(cfg, (2, 32))}
    eng = sma_jit(functools.partial(lm.forward, cfg=cfg))
    with torch.no_grad():
        want = lm.forward(params, cfg, batch)
        got = eng(params, batch=batch)
    assert torch.equal(got, want)
    disp = eng.compile(params, batch=batch).report["dispatch"]
    assert disp["kernel_entry_sites"] > 0


def test_entries_restored_after_trace_and_direct_path_untouched():
    saved = {n: getattr(ops, n) for n in ("sma_gemm", "rmsnorm_gemm",
                                          "flash_attention", "rglru_scan",
                                          "mlstm_chunkwise")}
    cfg, params = port_model("stablelm-1.6b")
    sma_jit(functools.partial(lm.forward, cfg=cfg)).compile(
        params, batch={"tokens": tokens(cfg, (1, 8))})
    assert {n: getattr(ops, n) for n in saved} == saved


def test_card_signature_compiles_shape_only_on_the_host():
    """A CUDA signature traces with fake CUDA tensors and no card: factory
    calls land on cuda, the sites route to the kernels, and the report
    names each one's kernel route.  (One MLP and the head: a CPU-only
    torch cannot fake a Python-level tensor index on cuda.)"""
    from repro_torch.tree import tree_map
    cfg, params = port_model("stablelm-1.6b", "bfloat16")
    cuda = torch.device("cuda", 0)

    def layer_and_head(params, x):
        p = lm.unstack(params["blocks"][0], cfg.num_groups)[0]
        return lm.head(params, lm.mlp_residual(p, x, cfg.d_ff))

    spec = lambda t: TensorSpec(t.shape, t.dtype, cuda)  # noqa: E731
    cm = sma_jit(layer_and_head).compile(
        tree_map(spec, params),
        TensorSpec((2, 32, cfg.d_model), torch.bfloat16, cuda))
    devices = {n.meta["val"].device for n in cm.traced.graph.nodes
               if isinstance(n.meta.get("val"), torch.Tensor)}
    assert devices == {cuda}
    bks = cm.report["backends"]
    assert bks["chosen"] == {"cuda": 4}
    assert bks["routes"] == {"sma_gemm.wgmma": 3, "rmsnorm_gemm.wgmma": 1}
    assert cm.report["fusion"]["realized_fused_sites"] == 2


def test_select_backend_is_static():
    t = torch.zeros(4, 8)
    backend, why = select_backend(OpSite.from_args("sma_gemm", (t, t.T)))
    assert backend.name == "plain" and why.category == "platform"
    site = OpSite("paged_decode_attention", ((2, 3, 4, 8),), ("bfloat16",),
                  "cuda", (("c", 3), ("window", None)))
    backend, why = select_backend(site)
    assert backend.name == "plain" and why.category == "shape"
    site = OpSite("sma_gemm", ((4096, 2048), (2048, 5632)),
                  ("bfloat16", "bfloat16"), "cuda")
    assert select_backend(site) == (select_backend(site)[0], None)
    assert select_backend(site)[0].name == "cuda"


# ===========================================================================
# Engine cache (mirrors tests/test_api.py where it means something here)
# ===========================================================================
def mlp(x, w1, b1, w2):
    return torch.tanh(x @ w1 + b1) @ w2


def mlp_args(batch=8, dtype=torch.float32):
    return (randn(batch, 16, dtype=dtype), randn(16, 32, dtype=dtype,
                                                 seed=1),
            randn(32, dtype=dtype, seed=2), randn(32, 4, dtype=dtype,
                                                  seed=3))


class TestEngine:
    def test_compiled_mlp_equals_eager(self):
        args = mlp_args()
        eng = sma_jit(mlp)
        assert torch.equal(eng(*args), mlp(*args))
        assert eng.compile(*args).report["fusion"][
            "realized_epilogue_sites"] == 1

    def test_second_call_is_cache_hit_with_zero_retrace(self, monkeypatch):
        traces = []
        orig = cdispatch.trace_model
        monkeypatch.setattr(cdispatch, "trace_model",
                            lambda *a, **k: traces.append(1) or orig(*a, **k))
        eng = sma_jit(mlp)
        args = mlp_args()
        eng(*args)
        eng(*args)
        assert len(traces) == 1
        assert (eng.stats.hits, eng.stats.misses) == (1, 1)

    def test_new_shape_compiles_once(self):
        eng = sma_jit(mlp)
        for b in (8, 8, 16, 16, 8):
            eng(*mlp_args(b))
        assert (eng.stats.misses, eng.stats.hits, eng.cache_size) == (2, 3, 2)

    def test_dtype_and_device_are_in_the_key(self):
        eng = sma_jit(mlp)
        eng(*mlp_args())
        eng(*mlp_args(dtype=torch.float64))
        assert eng.stats.misses == 2
        cuda = tuple(TensorSpec(a.shape, a.dtype, "cuda") for a in mlp_args())
        eng.compile(*cuda)
        assert eng.stats.misses == 3

    def test_strides_are_in_the_key(self):
        eng = sma_jit(mlp)
        x, w1, b1, w2 = mlp_args()
        eng(x, w1, b1, w2)
        eng(x, w1.T.contiguous().T, b1, w2)
        assert eng.stats.misses == 2

    def test_pytree_structure_is_in_the_key(self):
        eng = sma_jit(lambda p, x: x @ p["w"] + p["b"])
        x, w, b = randn(4, 8), randn(8, 3, seed=1), randn(3, seed=2)
        eng({"w": w, "b": b}, x)
        eng({"w": w, "b": b}, x)
        eng({"w": w, "b": b, "c": b}, x)
        assert (eng.stats.misses, eng.stats.hits) == (2, 1)
        with pytest.raises(TypeError, match="argument structure"):
            eng.compile({"w": w, "b": b}, x)(x, {"w": w, "b": b})

    def test_static_kwargs_key_and_control_flow(self):
        def fn(x, w, *, act):
            y = x @ w
            return torch.relu(y) if act == "relu" else torch.tanh(y)

        eng = sma_jit(fn, static_argnames="act")
        x, w = randn(4, 8), randn(8, 3, seed=1)
        assert torch.equal(eng(x, w, act="relu"), torch.relu(x @ w))
        assert torch.equal(eng(x, w, act="tanh"), torch.tanh(x @ w))
        eng(x, w, act="relu")
        assert (eng.stats.misses, eng.stats.hits) == (2, 1)
        with pytest.raises(TypeError, match="hashable"):
            eng(x, w, act=["relu"])

    def test_non_tensor_leaf_without_static_marker_raises(self):
        eng = sma_jit(lambda x, scale: x * scale)
        with pytest.raises(TypeError, match="static_argnames"):
            eng(randn(4), scale=2.0)

    def test_resolved_options_are_in_the_key(self):
        eng = sma_jit(mlp)
        args = mlp_args()
        eng(*args)
        with options(fuse_runtime=False):
            eng(*args)
        with options(fuse_runtime=False):
            eng(*args)
        eng(*args)
        assert (eng.stats.misses, eng.stats.hits) == (2, 2)

    def test_policy_objects_never_alias_in_the_cache_key(self):
        eng = sma_jit(mlp)
        args = mlp_args()
        for _ in range(2):
            with options(policy=SMAPolicy(max_epilogue_ops=1)):
                eng(*args)
        assert eng.stats.misses == 2

    def test_context_nesting_inner_wins_outer_survives(self):
        with options(max_epilogue_ops=2, fuse_runtime=False):
            with options(fuse_runtime=True) as inner:
                assert (inner.fuse_runtime, inner.max_epilogue_ops) == \
                    (True, 2)
            assert current_options().fuse_runtime is False
        assert current_options().max_epilogue_ops == 4

    def test_explicit_options_beat_ambient_context(self):
        eng = sma_jit(mlp, options=SMAOptions(fuse_runtime=False))
        with options(fuse_runtime=True):
            cm = eng.compile(*mlp_args())
        assert cm.options.fuse_runtime is False
        with pytest.raises(TypeError):
            with options(SMAOptions(), fuse_runtime=True):
                pass

    def test_compile_accepts_shape_specs_then_real_call_hits(self):
        eng = sma_jit(mlp)
        args = mlp_args()
        cm = eng.compile(*(TensorSpec(a.shape, a.dtype, "cpu")
                           for a in args))
        assert cm.summary.groups > 0
        eng(*args)
        assert (eng.stats.misses, eng.stats.hits) == (1, 1)

    def test_lru_eviction(self):
        eng = sma_jit(mlp, options=SMAOptions(max_cache_entries=1))
        for b in (8, 16, 8):
            eng(*mlp_args(b))
        assert (eng.stats.misses, eng.stats.evictions, eng.cache_size) == \
            (3, 2, 1)

    def test_engine_report_and_plan_report_carry_cache_stats(self):
        eng = sma_jit(mlp, name="mlp")
        args = mlp_args()
        for _ in range(3):
            eng(*args)
        rep = eng.compile(*args).report
        assert rep["engine"]["cache_hits"] == 3
        assert set(rep["compile"]) == {"trace_s", "lower_s", "plan_s",
                                       "rewrite_s", "dispatch_s"}
        summary = eng.report
        assert summary["engine"] == "mlp"
        assert summary["entries"][0]["fused_sites"] == 1
        # the reference's plan-report keys (repro/compiler/report.py)
        assert {"model", "num_ops", "groups", "systolic_groups",
                "simd_groups", "mode_switches", "fused_simd_ops",
                "hbm_bytes_avoided", "systolic_flop_share", "total_flops",
                "total_bytes", "mode_flop_histogram", "opkind_flops",
                "opkind_counts", "largest_groups", "lowering", "options",
                "dispatch", "fusion", "backends"} <= set(rep)
        assert {"planned_fused_sites", "planned_fused_simd_ops",
                "planned_hbm_bytes_avoided", "realized_fused_sites",
                "realized_epilogue_sites", "realized_prologue_sites",
                "realized_hbm_bytes_avoided", "eqns_elided",
                "fallback_reasons", "sites"} == set(rep["fusion"])

    def test_grad_mode(self):
        eng = sma_jit(mlp)
        x, w1, b1, w2 = mlp_args()
        w1.requires_grad_(True)
        with pytest.raises(RuntimeError, match="no_grad"):
            eng(x, w1, b1, w2)
        with torch.no_grad():
            out = eng(x, w1, b1, w2)
        assert not out.requires_grad
        with torch.inference_mode():
            inf = tuple(t.clone() for t in mlp_args())
        assert torch.equal(eng(*inf), mlp(*inf))

    def test_top_level_reexports(self):
        assert repro_torch.sma_jit is repro_torch.api.sma_jit
        assert repro_torch.SMAOptions is repro_torch.api.SMAOptions
        assert repro_torch.options is repro_torch.api.options
