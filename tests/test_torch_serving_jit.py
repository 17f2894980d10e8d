"""The port's ``ServeEngine`` through ``sma_jit``, on the CPU, at the
reduced StableLM in float32.

* The compiled paged steps (the engine's own ``engines``) against the
  direct steps, bit for bit: the same plain versions run on the same
  operands, so logits, the returned ``cache_len`` and the pools' real
  blocks must be equal; and against the JAX steps under
  ``repro.options(backend="interpret")`` at rtol = atol = 2e-4 (the other
  parity tests' tolerance: summation order inside the products).
* The traced graphs: no data-dependent shape and no host sync, one
  paged-attention kernel-entry node a layer, the pool writes kept by the
  dispatcher (a removed write is seen), the routing counted at run time.
* Mirrors of the reference engine's tests (``tests/test_serving.py``):
  one compile per (phase, bucket), the ``serving.*`` metrics, and the
  measured mode switches under ``repro_torch.profile``.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro.configs as C
from repro.models import lm as jlm
from repro.models.layers import Runtime
from repro.serving import kv_cache as jkv
from repro.serving import model as jmodel
from repro_torch import convert, obs, sma_jit
from repro_torch.compiler import lower_graph
from repro_torch.compiler.trace import KERNEL_ENTRY_OPS, paged_entry
from repro_torch.configs import get_config, reduced
from repro_torch.core.modes import OpKind
from repro_torch.kernels import ops
from repro_torch.serving import (CacheConfig, PagedKVCache, Request,
                                 SchedulerConfig, ServeEngine)
from repro_torch.serving import model as tmodel

TOL = dict(rtol=2e-4, atol=2e-4)
ARCH = "stablelm-1.6b"
CC = CacheConfig(block_size=4, num_blocks=32, max_seq_len=64)
PAGED_OP = torch.ops.repro_torch.paged_decode_attention.default


@pytest.fixture(scope="module")
def models():
    """(JAX cfg, JAX params, port cfg, port params) of the reduced model."""
    jcfg = C.reduced(C.get_config(ARCH))
    jparams = jlm.init(jax.random.PRNGKey(0), jcfg)[0]
    tcfg = reduced(get_config(ARCH))
    tparams = convert.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _engine(tcfg, tparams, **kw):
    kw.setdefault("cache", CC)
    kw.setdefault("max_batch", 4)
    kw.setdefault("sched", SchedulerConfig(prefill_chunk=4))
    return ServeEngine(tcfg, tparams, device="cpu", **kw)


def _inputs(tcfg, b=3, c=8, seed=0):
    """A ragged first chunk for b rows (one of them all padding past its
    prompt's end), and the table that holds them."""
    kv = PagedKVCache(CC, b)
    for r, n in enumerate((7, 5, 8)[:b]):
        assert kv.admit(r, n, 3)
    table = torch.from_numpy(kv.table_rows(list(range(b))))
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, tcfg.vocab_size, (b, c)).astype(np.int32))
    n_tok = torch.tensor([7, 5, 8][:b], dtype=torch.int32)
    return table, toks, n_tok


def _steps(tcfg, tparams, prefill, decode, n_decode=3):
    """A prefill chunk then ``n_decode`` greedy decode steps through the
    given step callables; every step's (logits, cache_len, pools)."""
    table, toks, n_tok = _inputs(tcfg)
    state = tmodel.init_state(tcfg, 3, CC, device="cpu")
    zero = torch.zeros(3, dtype=torch.int32)
    logits, _, cl = prefill(tparams, state, table, zero, n_tok,
                            {"tokens": toks})
    out = [(logits, cl, [p.clone() for e in state for p in e.values()])]
    for _ in range(n_decode):
        nxt = logits.argmax(-1, keepdim=True).to(torch.int32)
        logits, _, cl = decode(tparams, state, table, cl.to(torch.int32),
                               {"tokens": nxt})
        out.append((logits, cl, [p.clone() for e in state
                                 for p in e.values()]))
    return out


def _direct(tcfg):
    return (lambda p, s, bt, cl, nt, b: tmodel.paged_prefill_step(
                p, s, bt, cl, nt, tcfg, b),
            lambda p, s, bt, cl, b: tmodel.paged_decode_step(
                p, s, bt, cl, tcfg, b))


def _compiled_modules(eng):
    """Every cached (phase, compiled step) of an engine."""
    return [(phase, entry.compiled) for phase, e in eng.engines.items()
            for entry in e._cache.values()]


# ===========================================================================
# Compiled steps: bit for bit the direct steps, 2e-4 the JAX steps
# ===========================================================================
def test_compiled_steps_equal_direct_bit_for_bit(models):
    _, _, tcfg, tparams = models
    eng = _engine(tcfg, tparams)
    with torch.inference_mode():
        got = _steps(tcfg, tparams, eng.engines["prefill"],
                     eng.engines["decode"])
        want = _steps(tcfg, tparams, *_direct(tcfg))
    assert (eng.engines["prefill"].stats.misses,
            eng.engines["decode"].stats.misses) == (1, 1)
    assert eng.engines["decode"].stats.hits == 2
    for (gl, gc, gp), (wl, wc, wp) in zip(got, want):
        assert torch.equal(gl, wl)
        assert torch.equal(gc, wc)
        for g, w in zip(gp, wp):
            assert g.shape[1] == CC.num_blocks + 1
            assert torch.equal(g[:, :CC.num_blocks], w[:, :CC.num_blocks])


def test_compiled_steps_match_jax(models):
    jcfg, jparams, tcfg, tparams = models
    eng = _engine(tcfg, tparams)
    table, toks, n_tok = _inputs(tcfg)
    rt = Runtime()
    jstate = jmodel.init_state(jcfg, 3, jkv.CacheConfig(4, 32, 64))
    tstate = tmodel.init_state(tcfg, 3, CC, device="cpu")

    def check(jl, tl):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(
                tstate[0][name][:, :CC.num_blocks].numpy(),
                np.asarray(jstate[0][name]), **TOL)

    with repro.options(backend="interpret"), torch.inference_mode():
        jl, jstate, jlen = jmodel.paged_prefill_step(
            jparams, jstate, jnp.asarray(table.numpy()),
            jnp.zeros((3,), jnp.int32), jnp.asarray(n_tok.numpy()), jcfg,
            rt, {"tokens": jnp.asarray(toks.numpy())})
        tl, _, tlen = eng.engines["prefill"](
            tparams, tstate, table, torch.zeros(3, dtype=torch.int32),
            n_tok, {"tokens": toks})
        check(jl, tl)
        for _ in range(3):
            nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
            jl, jstate, jlen = jmodel.paged_decode_step(
                jparams, jstate, jnp.asarray(table.numpy()), jlen, jcfg, rt,
                {"tokens": jnp.asarray(nxt)})
            tl, _, tlen = eng.engines["decode"](
                tparams, tstate, table, tlen.to(torch.int32),
                {"tokens": torch.from_numpy(nxt)})
            check(jl, tl)
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))


# ===========================================================================
# The traced graphs
# ===========================================================================
@pytest.fixture(scope="module")
def served(models):
    """An engine after a ragged workload: it holds a compiled step per
    (phase, bucket) it met."""
    _, _, tcfg, tparams = models
    eng = _engine(tcfg, tparams)
    for r in _requests(tcfg, (6, 9, 3), (3, 2, 4)):
        eng.submit(r)
    eng.run()
    return eng


def _requests(cfg, lens, max_new, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, (n,))
                    .astype(np.int32), max_new_tokens=m)
            for i, (n, m) in enumerate(zip(lens, max_new))]


def test_traced_steps_hold_no_data_dependent_op_or_host_sync(served):
    compiled = _compiled_modules(served)
    assert {p for p, _ in compiled} == {"prefill", "decode"}
    for _, cm in compiled:
        for graph in (cm.traced.graph, cm.module.graph):
            names = {str(n.target) for n in graph.nodes
                     if n.op == "call_function"}
            assert not any(w in name for name in names
                           for w in ("nonzero", "_local_scalar_dense",
                                     "masked_select", "unique"))


def test_one_paged_attention_node_per_layer(served):
    layers = served.cfg.num_layers
    for phase, cm in _compiled_modules(served):
        traced = [n for n in cm.traced.graph.nodes if n.target is PAGED_OP]
        assert len(traced) == layers
        assert sum(n.target is paged_entry
                   for n in cm.module.graph.nodes) == layers
        rep = cm.report
        assert rep["dispatch"]["kernel_entry_sites"] == layers
        assert rep["dispatch"]["native_dot_sites"] == 0
        assert rep["dispatch"]["systolic_dispatch_sites"] == 7 * layers + 1
        sites = [s for s in rep["backends"]["sites"]
                 if s["op"] == "paged_decode_attention"]
        assert len(sites) == layers
        assert all(s["backend"] == "plain" for s in sites)   # CPU tensors
        program = lower_graph(cm.traced.graph)
        attn = [op for op in program.ops
                if op.name.startswith("paged_decode_attention#")]
        assert len(attn) == layers
        assert all(op.kind is OpKind.ATTENTION_MATMUL for op in attn)
        b, c = cm.traced.graph_module.graph.find_nodes(
            op="call_function", target=PAGED_OP)[0].args[0].meta[
                "val"].shape[:2]
        cfg = served.cfg
        keys = CC.max_blocks_per_req * CC.block_size
        assert attn[0].flops == 4.0 * b * cfg.num_heads * c * keys \
            * cfg.resolved_head_dim
        assert c == (1 if phase == "decode" else 4)


def test_pool_writes_survive_dispatch_and_a_lost_one_is_seen(models):
    """Every layer's two pool writes are in the dispatched module; with one
    layer's writes removed from a compiled decode graph the pools and the
    logits part from the direct step's."""
    _, _, tcfg, tparams = models
    eng = _engine(tcfg, tparams)
    with torch.inference_mode():
        _steps(tcfg, tparams, eng.engines["prefill"], eng.engines["decode"],
               n_decode=1)
        (_, cm), = [(p, c) for p, c in _compiled_modules(eng)
                    if p == "decode"]
        puts = [n for n in cm.module.graph.nodes
                if n.target is torch.ops.aten.index_put_.default]
        assert len(puts) == 2 * tcfg.num_layers
        faulty = copy.copy(cm)
        faulty.module = copy.deepcopy(cm.module)
        for n in [n for n in faulty.module.graph.nodes
                  if n.target is torch.ops.aten.index_put_.default][-2:]:
            n.replace_all_uses_with(n.args[0])     # the last layer's k, v
            faulty.module.graph.erase_node(n)
        faulty.module.recompile()

        def decode_faulty(p, s, bt, cl, b):
            return faulty(p, s, bt, cl, b)

        got = _steps(tcfg, tparams, eng.engines["prefill"], decode_faulty,
                     n_decode=2)
        want = _steps(tcfg, tparams, *_direct(tcfg), n_decode=2)
    assert torch.equal(got[0][0], want[0][0])         # prefill untouched
    assert not torch.equal(got[1][2][-1], want[1][2][-1])   # last v pool
    assert (got[1][0] - want[1][0]).abs().max() > 1e-3
    assert (got[2][0] - want[2][0]).abs().max() > 1e-3


def test_routing_is_counted_at_run_time(models):
    """A compiled chunked-prefill tick counts one routed call per layer on
    every call, as the direct step does; a decode tick routes nothing."""
    _, _, tcfg, tparams = models
    eng = _engine(tcfg, tparams)
    table, toks, n_tok = _inputs(tcfg)
    zero = torch.zeros(3, dtype=torch.int32)
    with torch.inference_mode():
        for call in range(1, 4):
            state = tmodel.init_state(tcfg, 3, CC, device="cpu")
            ops.reset_counts()
            _, _, cl = eng.engines["prefill"](tparams, state, table, zero,
                                              n_tok, {"tokens": toks})
            assert sum(ops.ROUTED.values()) == tcfg.num_layers, call
        (reason,) = ops.ROUTED
        assert reason.startswith("shape:chunked prefill tile (C=8)")
        ops.reset_counts()
        eng.engines["decode"](tparams, state, table, cl.to(torch.int32),
                              {"tokens": toks[:, :1]})
        assert not ops.ROUTED
        ops.reset_counts()
        tmodel.paged_prefill_step(tparams, state, table, zero, n_tok, tcfg,
                                  {"tokens": toks})
        assert sum(ops.ROUTED.values()) == tcfg.num_layers


def test_contiguous_decode_entry_is_one_node():
    rng = np.random.default_rng(3)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).float()

    args = (t(2, 4, 16), t(2, 2, 8, 16), t(2, 2, 8, 16),
            torch.tensor([3, 8]))
    eng = sma_jit(lambda q, k, v, n: ops.decode_attention(q, k, v, n) * 2.0)
    assert torch.equal(eng(*args), ops.decode_attention(*args) * 2.0)
    cm = eng.compile(*args)
    op = torch.ops.repro_torch.decode_attention.default
    assert op in KERNEL_ENTRY_OPS
    assert sum(n.target is op for n in cm.traced.graph.nodes) == 1
    (attn,) = [o for o in lower_graph(cm.traced.graph).ops
               if o.kind is OpKind.ATTENTION_MATMUL]
    assert attn.flops == 4.0 * 2 * 4 * 8 * 16
    assert cm.report["dispatch"]["kernel_entry_sites"] == 1


# ===========================================================================
# Mirrors of the reference engine's tests
# ===========================================================================
def test_one_compile_per_phase_and_bucket(models):
    _, _, tcfg, tparams = models
    eng = _engine(tcfg, tparams, cache=CacheConfig(block_size=4,
                                                   num_blocks=48,
                                                   max_seq_len=64))
    for r in _requests(tcfg, (6,) * 4, (4,) * 4):
        eng.submit(r)
    eng.run()
    for phase in ("prefill", "decode"):
        st = eng.engines[phase].stats
        assert st.misses == eng.engines[phase].cache_size
        assert st.hits > 0, f"{phase} ticks after the first must hit"
    assert eng.stats()["engines"]["decode"]["misses"] == \
        eng.engines["decode"].stats.misses
    eng.reset()
    misses = {p: eng.engines[p].stats.misses for p in eng.engines}
    for r in _requests(tcfg, (6,) * 4, (4,) * 4):
        eng.submit(r)
    eng.run()
    for p in eng.engines:
        assert eng.engines[p].stats.misses == misses[p]


def test_latency_histograms_in_snapshot(models):
    _, _, tcfg, tparams = models
    obs.reset()
    eng = _engine(tcfg, tparams, max_batch=2)
    for r in _requests(tcfg, (5,) * 3, (3,) * 3):
        eng.submit(r)
    eng.run()
    snap = obs.snapshot()
    for name in ("serving.queue_wait_s", "serving.ttft_s", "serving.itl_s"):
        assert name in snap["histograms"], f"missing {name}"
        h = snap["histograms"][name]
        assert h["count"] > 0
        assert 0 <= h["p50"] <= h["p99"] <= h["max"]
    counters = snap["counters"]
    assert counters["serving.tokens"] == 9
    assert counters["serving.admitted"] == 3
    assert counters["serving.ticks"] == eng.sched.ticks
    assert counters["serving.mode_switches"] == eng.sched.switches
    assert counters["engine.cache_misses"] == sum(
        e.stats.misses for e in eng.engines.values())


def test_failure_paths_feed_serve_counters(models):
    _, _, tcfg, tparams = models
    obs.reset()
    eng = _engine(tcfg, tparams, max_batch=2)
    r0, r1 = _requests(tcfg, (6, 6), (6, 6))
    eng.submit(r0)
    eng.submit(r1)
    while not (r0.out_tokens and r1.out_tokens):
        eng.step()
    for pool in eng.state[0].values():
        pool[:, eng.kv.blocks_of(r1.slot)] = float("nan")
    eng.run()
    assert r1.status == "failed" and r0.status == "done"
    counters = obs.snapshot()["counters"]
    assert counters["serve.retries"] == 2
    assert counters["serve.evictions"] == 1
    assert counters["serve.requests_failed"] == 1


def _staggered_run(eng, cfg):
    """A trickle of arrivals while decode is in flight (the reference's
    ``TestSMASwitchReduction`` workload)."""
    reqs = _requests(cfg, (4,) * 8, (12,) * 8)
    for r in reqs[:2]:
        eng.submit(r)
    arrivals = {3: 2, 6: 3, 9: 4, 12: 5, 15: 6, 18: 7}
    tick = 0
    while eng.queue or eng.active:
        nxt = arrivals.get(tick)
        if nxt is not None:
            eng.submit(reqs[nxt])
        eng.step()
        tick += 1
        assert tick < 500
    assert all(r.status == "done" for r in reqs)
    return sum(len(r.out_tokens) for r in reqs)


def test_measured_mode_switches_equal_scheduler_and_sma_beats_fcfs(models):
    """Under ``repro_torch.profile`` the tick spans' timeline counts the
    scheduler's own switches; mode batching switches less per token than
    FCFS.  The whole window also holds the compiled steps' kernel and
    dispatch spans, whose alternation inside each tick counts more."""
    _, _, tcfg, tparams = models
    results = {}
    for policy in ("sma", "fcfs"):
        eng = _engine(tcfg, tparams,
                      cache=CacheConfig(block_size=4, num_blocks=64,
                                        max_seq_len=32),
                      sched=SchedulerConfig(policy=policy, prefill_chunk=4,
                                            max_prefill_batch=4,
                                            mode_min_run=8))
        _staggered_run(eng, tcfg)           # warm every signature
        eng.reset()
        with obs.profile() as prof:
            tokens = _staggered_run(eng, tcfg)
        ticks = [e for e in prof.events if e["cat"] == "serve"]
        assert len(ticks) == eng.sched.ticks
        assert {e["mode"] for e in ticks} == {"systolic", "simd"}
        sec = obs.runtime_section(ticks)
        whole = prof.runtime_section()
        assert not any(e["name"] == "engine.compile" for e in prof.events)
        assert whole["kernel_spans"] > 0
        assert whole["mode_switches"] > sec["mode_switches"]
        results[policy] = {"obs": sec["mode_switches"],
                           "sched": eng.sched.switches,
                           "per_token": sec["mode_switches"] / tokens}
        assert sec["mode_switches"] == eng.sched.switches, results
    sma, fcfs = results["sma"], results["fcfs"]
    assert sma["obs"] > 0
    assert sma["per_token"] < fcfs["per_token"], results
