"""The port's train step through ``sma_jit``, on the CPU, at the reduced
StableLM in float32.

* The compiled step (``launch.train.make_step``: forward, backward and
  AdamW traced as one program) against the direct step
  (``launch.train.direct_step``) bit for bit over two steps: the same
  plain versions run on the same operands in the same order, so
  parameters, moments, step, error-feedback state and metrics must be
  equal.
* The joint graph: one gradient-site node per kernel call of the direct
  step (29n + 2 ``sma_gemm``, 1 ``rmsnorm_gemm``, 2n flash forwards and n
  flash backwards at n layers with remat), every parameter and moment
  written in place after dispatch (a dropped write is seen), and the
  forward and serving graphs traced node for node as before.
* Five compiled ``train()`` steps with ``grad_compression`` against a JAX
  loop that applies ``repro.optim.compress.roundtrip`` (1e-4 relative, as
  ``tests/test_torch_train.py`` holds the plain loop).
"""
import collections
import copy
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree
from torch.fx.experimental.proxy_tensor import make_fx

import repro.configs as C
from repro.data import pipeline as jpipe
from repro.models import lm as jlm
from repro.models.layers import Runtime
from repro.optim import adamw as jadamw
from repro.optim import compress as jcomp
from repro_torch import convert
from repro_torch.api import Engine
from repro_torch.compiler import dispatch as cdispatch
from repro_torch.compiler import trace_model
from repro_torch.compiler.lower import op_name
from repro_torch.compiler.trace import GRADIENT_OPS, kernel_entries_as_ops
from repro_torch.configs import get_config, reduced
from repro_torch.core.modes import OpKind
from repro_torch.data.pipeline import DataConfig, DataPipeline
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import norm_gemm as knorm
from repro_torch.kernels import sma_gemm as kgemm
from repro_torch.launch.train import (TrainLoopConfig, direct_step,
                                      make_step, train)
from repro_torch.models import lm
from repro_torch.optim import adamw, compress
from repro_torch.serving import CacheConfig, PagedKVCache
from repro_torch.serving import model as smodel
from repro_torch.tree import leaves

ARCH = "stablelm-1.6b"
OCFG = adamw.AdamWConfig(peak_lr=1e-2, warmup_steps=1, total_steps=4)
#: Kernel wrappers, by the name of the gradient-site op that calls each.
WRAPPERS = {"sma_gemm": (kgemm, "sma_gemm"),
            "rmsnorm_gemm": (knorm, "rmsnorm_gemm"),
            "flash_attention_fwd": (kflash, "flash_attention_fwd"),
            "flash_attention_bwd": (kflash, "flash_attention_bwd")}


def _cfg(layers=2):
    return dataclasses.replace(reduced(get_config(ARCH)), num_groups=layers)


def _state(cfg, compression=False, seed=0):
    params = lm.init(cfg, seed=seed, device="cpu", dtype=cfg.parameter_dtype)
    ef = compress.init_error(params) if compression else {}
    return params, adamw.init(params), ef


def _batches(cfg, n, seq=32, batch=2):
    pipe = DataPipeline(DataConfig(cfg.vocab_size, seq, batch), device="cpu")
    return [next(pipe) for _ in range(n)]


def _step_fns(cfg, remat=True, compression=False):
    kw = dict(cfg=cfg, ocfg=OCFG, remat=remat, grad_compression=compression)
    return (functools.partial(direct_step, **kw),
            make_step(cfg, OCFG, remat=remat, grad_compression=compression))


@pytest.fixture
def calls(monkeypatch):
    """Calls of each kernel wrapper (the launches on the card)."""
    seen = collections.Counter()
    for name, (mod, attr) in WRAPPERS.items():
        orig = getattr(mod, attr)

        def spy(*a, _orig=orig, _name=name, **k):
            seen[_name] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(mod, attr, spy)
    return seen


def _gradient_nodes(graph):
    return collections.Counter(op_name(n) for n in graph.nodes
                               if n.op == "call_function"
                               and n.target in GRADIENT_OPS)


# ===========================================================================
# The compiled step equals the direct step
# ===========================================================================
@pytest.mark.parametrize("remat,compression", [(True, False), (False, False),
                                               (True, True)])
def test_compiled_step_equals_direct(remat, compression):
    """Two steps: parameters, moments, step, error feedback and metrics
    torch.equal; the compiled step writes the caller's tensors."""
    cfg = _cfg()
    direct, compiled = _step_fns(cfg, remat, compression)
    want = _state(cfg, compression)
    got = copy.deepcopy(want)

    def written(s):
        return leaves((s[0], s[1]["m"], s[1]["v"]))

    for batch in _batches(cfg, 2):
        before = written(got)
        *want, wm = direct(*want, batch)
        *got, gm = compiled(*got, batch)
        assert all(a is b for a, b in zip(before, written(got)))
        assert sorted(gm) == sorted(wm)
        for k in wm:
            assert torch.equal(gm[k], wm[k]), k
        for g, w in zip(leaves(got), leaves(want)):
            assert g.dtype == w.dtype and torch.equal(g, w)
    assert int(got[1]["step"]) == 2
    assert compiled.stats.misses == 1 and compiled.stats.hits == 1


def test_make_step_is_a_named_engine():
    cfg = _cfg()
    eng = make_step(cfg, OCFG, remat=True, grad_compression=False)
    assert isinstance(eng, Engine)
    assert eng.name == f"{cfg.name}.train_step"


def test_steps_hit_the_cache_and_a_new_seq_len_compiles_once():
    cfg = _cfg()
    _, compiled = _step_fns(cfg)
    state = _state(cfg)
    for batch in _batches(cfg, 3):
        *state, _ = compiled(*state, batch)
    assert (compiled.stats.misses, compiled.stats.hits) == (1, 2)
    for batch in _batches(cfg, 2, seq=16):
        *state, _ = compiled(*state, batch)
    assert (compiled.stats.misses, compiled.stats.hits) == (2, 3)


# ===========================================================================
# The joint graph
# ===========================================================================
@pytest.mark.parametrize("remat", [True, False])
def test_one_gradient_node_per_direct_launch(remat, calls):
    """The traced step holds one gradient-site node per kernel call of the
    direct step (29n + 2 / 1 / 2n / n with remat, 22n + 2 / 1 / n / n
    without); the dispatched module calls each kernel once per node it
    keeps.  It keeps all but the remat group's recomputed last projection
    (wo of the MLP), whose output nothing reads: the eager recomputation
    runs up to it, since its input is the last saved tensor."""
    n = 2
    cfg = _cfg(n)
    direct, compiled = _step_fns(cfg, remat)
    state, batch = _state(cfg), _batches(cfg, 1)[0]
    direct(*copy.deepcopy(state), batch)
    direct_calls = dict(calls)
    fwd = 2 * n if remat else n
    assert direct_calls == {"sma_gemm": (29 if remat else 22) * n + 2,
                            "rmsnorm_gemm": 1, "flash_attention_fwd": fwd,
                            "flash_attention_bwd": n}
    cm = compiled.compile(*state, batch)
    assert dict(_gradient_nodes(cm.traced.graph)) == direct_calls
    kept = dict(direct_calls, sma_gemm=direct_calls["sma_gemm"]
                - (n if remat else 0))
    calls.clear()
    compiled(*state, batch)
    assert dict(calls) == kept
    sites = collections.Counter(
        n.target for n in cm.module.graph.nodes if n.op == "call_function")
    assert sites[cdispatch.sma_gemm_site] == kept["sma_gemm"]
    assert sites[cdispatch.rmsnorm_gemm_site] == 1
    assert not any(t in GRADIENT_OPS for t in sites)
    # The report counts every GEMM gradient site and flash node.
    rep = cm.report
    assert rep["dispatch"]["systolic_dispatch_sites"] == \
        direct_calls["sma_gemm"] + 1
    assert rep["dispatch"]["kernel_entry_sites"] == fwd + n
    assert rep["dispatch"]["native_dot_sites"] == 0
    # The gate's silu in each forward (and recomputation), and the head.
    assert rep["fusion"]["realized_fused_sites"] == fwd + 1
    assert rep["fusion"]["realized_prologue_sites"] == 1
    assert rep["backends"]["num_sites"] == kept["sma_gemm"] + 1 + fwd + n


def _placeholders(cm, *args):
    """Placeholder node of each tensor argument, by id of the tensor."""
    flat, _ = pytree.tree_flatten((args, {}))
    nodes = [n for n in cm.module.graph.nodes if n.op == "placeholder"]
    return {id(t): node for t, node in zip(flat, nodes)}


def _mutates(node):
    schema = getattr(node.target, "_schema", None)
    return schema is not None and schema.is_mutable


def test_every_parameter_and_moment_is_written_in_place():
    cfg = _cfg()
    _, compiled = _step_fns(cfg)
    state, batch = _state(cfg), _batches(cfg, 1)[0]
    cm = compiled.compile(*state, batch)
    ph = _placeholders(cm, *state, batch)
    written = {n.args[0] for n in cm.module.graph.nodes
               if n.op == "call_function" and _mutates(n)}
    for t in leaves((state[0], state[1]["m"], state[1]["v"])):
        assert ph[id(t)] in written
    names = collections.Counter(op_name(n) for n in cm.module.graph.nodes
                                if n.op == "call_function" and _mutates(n))
    k = len(leaves(state[0]))
    assert names["copy_"] == k and names["mul_"] >= 2 * k


def test_a_dropped_parameter_write_is_seen():
    """The head's copy_ removed from the dispatched module: the head comes
    back unchanged while the direct step moves it; every other leaf still
    equals the direct step's."""
    cfg = _cfg()
    direct, compiled = _step_fns(cfg)
    state, batch = _state(cfg), _batches(cfg, 1)[0]
    cm = compiled.compile(*state, batch)
    head = state[0]["head"]["w"]
    before = head.clone()
    node = next(n for n in cm.module.graph.nodes
                if op_name(n) == "copy_"
                and n.args[0] is _placeholders(cm, *state, batch)[id(head)])
    node.replace_all_uses_with(node.args[0])
    cm.module.graph.erase_node(node)
    cm.module.recompile()
    want = direct(*copy.deepcopy(state), batch)
    got = compiled(*state, batch)
    assert torch.equal(got[0]["head"]["w"], before)
    assert not torch.equal(want[0]["head"]["w"], before)
    same = [torch.equal(g, w) for g, w in zip(leaves(got[0]),
                                              leaves(want[0]))]
    assert same.count(False) == 1


def _no_grad_graph(fn, *args):
    """``fn`` traced as the front door traced it before gradients: under
    ``torch.no_grad()``."""
    flat, spec = pytree.tree_flatten((args, {}))

    def flat_fn(*xs):
        a, k = pytree.tree_unflatten(list(xs), spec)
        return pytree.tree_leaves(fn(*a, **k))

    with torch.no_grad(), kernel_entries_as_ops():
        return make_fx(flat_fn, tracing_mode="fake")(*flat).graph


def _serving_args(cfg, phase):
    cc = CacheConfig(block_size=4, num_blocks=16, max_seq_len=32)
    kv = PagedKVCache(cc, 2)
    for r in range(2):
        assert kv.admit(r, 5, 3)
    table = torch.from_numpy(kv.table_rows([0, 1]))
    state = smodel.init_state(cfg, 2, cc, device="cpu")
    params = lm.init(cfg, seed=0, device="cpu")
    zero = torch.zeros(2, dtype=torch.int32)
    if phase == "prefill":
        toks = torch.zeros((2, 4), dtype=torch.int32)
        return (lambda p, s, bt, cl, nt, b: smodel.paged_prefill_step(
            p, s, bt, cl, nt, cfg, b),
            (params, state, table, zero, zero + 4, {"tokens": toks}))
    toks = torch.zeros((2, 1), dtype=torch.int32)
    return (lambda p, s, bt, cl, b: smodel.paged_decode_step(
        p, s, bt, cl, cfg, b),
        (params, state, table, zero + 5, {"tokens": toks}))


@pytest.mark.parametrize("what", ["forward", "prefill", "decode"])
def test_forward_and_serving_graphs_trace_as_before(what):
    """Grad mode on while tracing changes nothing for a function whose
    leaves do not require grad: the same aten ops in the same order, no
    gradient-site node."""
    cfg = _cfg()
    if what == "forward":
        params = lm.init(cfg, seed=0, device="cpu")
        def fn(p, b):
            return lm.forward(p, cfg, b)
        args = (params, {"tokens": torch.zeros((2, 16), dtype=torch.int32)})
    else:
        fn, args = _serving_args(cfg, what)
    got = trace_model(fn, *args).graph
    want = _no_grad_graph(fn, *args)
    assert [str(n.target) for n in got.nodes] == \
        [str(n.target) for n in want.nodes]
    assert not _gradient_nodes(got)


def test_forward_only_graph_still_refuses_inputs_that_require_grad():
    from repro_torch import sma_jit
    cfg = _cfg()
    params = lm.init(cfg, seed=0, device="cpu")
    eng = sma_jit(functools.partial(lm.forward, cfg=cfg))
    batch = {"tokens": torch.zeros((2, 16), dtype=torch.int32)}
    with torch.no_grad():
        want = eng(params, batch=batch)
    assert eng.compile(params, batch=batch).fused_sites
    params["head"]["w"].requires_grad_(True)
    with pytest.raises(RuntimeError, match="inside the compiled function"):
        eng(params, batch=batch)
    with torch.no_grad():
        assert torch.equal(eng(params, batch=batch), want)


def test_lowering_costs_gradient_sites():
    """A gradient GEMM site lowers as MATMUL then its fused SIMD work; the
    flash backward as ATTENTION_MATMUL at 2.5x the forward's FLOPs."""
    cfg = _cfg(1)
    _, compiled = _step_fns(cfg)
    state, batch = _state(cfg), _batches(cfg, 1)[0]
    cm = compiled.compile(*state, batch)
    ops = cm.plan.ops
    fwd = [op for op in ops if op.name.startswith("flash_attention_fwd#")]
    bwd = [op for op in ops if op.name.startswith("flash_attention_bwd#")]
    assert len(fwd) == 2 and len(bwd) == 1
    assert {op.kind for op in fwd + bwd} == {OpKind.ATTENTION_MATMUL}
    assert bwd[0].flops == 2.5 * fwd[0].flops
    names = [op.name.split("#")[0] for op in ops]
    head = names.index("rmsnorm_gemm")
    assert names[head + 1] == "rmsnorm_gemm.rmsnorm"
    assert ops[head].kind is OpKind.MATMUL
    assert names.count("sma_gemm.silu") == 2
    d, t = cfg.d_model, 2 * 32
    gemms = [op for op in ops if op.name.split("#")[0] == "sma_gemm"]
    assert len(gemms) == 29 + 2
    assert gemms[0].flops == 2.0 * t * d * cfg.num_heads \
        * cfg.resolved_head_dim
    groups = cm.plan.groups
    head_group = next(g for g in groups if g.anchor is ops[head])
    assert head_group.fused_simd_ops >= 1


# ===========================================================================
# train() with gradient compression against the JAX loop
# ===========================================================================
def _jax_compressed_losses(jcfg, jparams, loop):
    ocfg = jadamw.AdamWConfig(peak_lr=loop.peak_lr,
                              warmup_steps=max(loop.steps // 10, 1),
                              total_steps=loop.steps)
    rt = Runtime(remat=loop.remat)

    @jax.jit
    def step(params, opt, ef, batch):
        (loss, _), grads = jax.value_and_grad(
            lambda p: jlm.loss_fn(p, jcfg, rt, batch), has_aux=True)(params)
        grads, ef = jcomp.roundtrip(grads, ef)
        params, opt, om = jadamw.update(grads, opt, params, ocfg)
        return params, opt, ef, loss, om["grad_norm"]

    pipe = jpipe.DataPipeline(jpipe.DataConfig(
        vocab_size=jcfg.vocab_size, seq_len=loop.seq_len,
        global_batch=loop.global_batch, seed=loop.seed))
    opt, ef = jadamw.init(jparams), jcomp.init_error(jparams)
    losses, norms, params = [], [], jparams
    for _ in range(loop.steps):
        params, opt, ef, loss, gnorm = step(params, opt, ef, next(pipe))
        losses.append(float(loss))
        norms.append(float(gnorm))
    return losses, norms, params


def test_compiled_train_with_compression_matches_jax_loop():
    """Five compiled train() steps with grad_compression from the JAX
    package's f32 masters: every step's loss and grad norm within 1e-4
    relative, the final parameters within 2e-4; one compile, four hits."""
    jcfg = C.reduced(C.get_config(ARCH))
    jparams = jlm.init(jax.random.PRNGKey(0), jcfg)[0]
    tcfg = reduced(get_config(ARCH))
    loop = TrainLoopConfig(steps=5, seq_len=32, global_batch=2, log_every=1,
                           seed=0, peak_lr=3e-3, remat=True,
                           grad_compression=True)
    want_loss, want_norm, want_params = _jax_compressed_losses(
        jcfg, jparams, loop)
    params = convert.from_jax_params(jax.tree.map(np.asarray, jparams),
                                     tcfg, device="cpu",
                                     dtype=tcfg.parameter_dtype)
    out = train(tcfg, loop, device="cpu", params=params)
    hist = out["history"]
    np.testing.assert_allclose([h["loss"] for h in hist], want_loss,
                               rtol=1e-4)
    np.testing.assert_allclose([h["grad_norm"] for h in hist], want_norm,
                               rtol=1e-4)
    assert want_loss[-1] < want_loss[0]
    for got, want in zip(leaves(out["params"]),
                         jax.tree.leaves(want_params)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-4)
    assert (out["engine"]["misses"], out["engine"]["hits"]) == (1, 4)
    assert not any(p.requires_grad for p in leaves(out["params"]))
