"""The port's mixture of experts (``repro_torch.models.moe``) against the
JAX package's, on the CPU, at the reduced ``qwen3-moe-30b-a3b`` (4
experts, top 2, ``d_ff_expert`` 64) in float32.

* ``moe_apply``'s output and auxiliary values (load-balance loss, z loss,
  dropped fraction) against ``repro.models.moe.moe_apply``, with
  variants replaced in both packages' configs: capacity factor 0.5 (so
  choices are dropped into the spill column), ``norm_topk_prob=False``,
  top 1, and dbrx's reduced config; top-k ties broken to the lower expert
  id, as ``jax.lax.top_k`` breaks them.
* ``lm.forward``, ``loss_fn`` (the aux losses included) and every
  gradient against ``jax.grad``; ``lm.prefill`` + 4 ``decode_step``s; the
  paged steps against ``repro.serving.model``'s under
  ``repro.options(backend="interpret")``; the engine's greedy tokens
  against a JAX loop over the same tables and chunks.
* ``sma_jit(lm.forward)`` and the engine's compiled ticks equal their
  direct paths bit for bit; the lowering makes the router one
  ``sma_gemm`` site a layer and plans routing and combine in SIMD mode,
  the router and expert products in systolic mode.
* ``variance_scaling_init`` draws a stacked leaf a slice at a time: init
  never holds a float32 tensor of a whole stacked leaf.

Parameters come from ``repro.models.lm.init`` through ``convert``.
Tolerance: rtol = atol = 2e-4, the other parity tests' (the same float32
arithmetic in another summation order).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro
import repro.configs as C
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models.layers import Runtime
from repro.serving import kv_cache as jkv
from repro.serving import model as jmodel
from repro_torch import convert, obs, sma_jit
from repro_torch.compiler import lower_graph
from repro_torch.configs import get_config, reduced
from repro_torch.core.modes import ExecMode, OpKind
from repro_torch.core.sma import SMAPolicy
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import layers, lm, moe
from repro_torch.serving import (CacheConfig, PagedKVCache, Request,
                                 SchedulerConfig, ServeEngine)
from repro_torch.serving import model as tmodel
from repro_torch.tree import leaves

TOL = dict(rtol=2e-4, atol=2e-4)
QWEN3, DBRX = "qwen3-moe-30b-a3b", "dbrx-132b"
#: (arch, MoEConfig fields replaced in both packages' reduced config)
VARIANTS = {
    "qwen3": (QWEN3, {}),
    "capacity0.5": (QWEN3, {"capacity_factor": 0.5}),
    "unnormalized": (QWEN3, {"norm_topk_prob": False}),
    "top1": (QWEN3, {"top_k": 1}),
    "dbrx": (DBRX, {}),
}
CC = CacheConfig(block_size=4, num_blocks=40, max_seq_len=32)


def _configs(name):
    arch, repl = VARIANTS[name]
    jcfg, tcfg = C.reduced(C.get_config(arch)), reduced(get_config(arch))
    return (dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                              **repl)),
            dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe,
                                                              **repl)))


@functools.lru_cache(maxsize=None)
def models(name):
    """(JAX cfg, JAX params, port cfg, numpy params) of a variant."""
    jcfg, tcfg = _configs(name)
    jparams = jlm.init(jax.random.PRNGKey(0), jcfg)[0]
    return jcfg, jparams, tcfg, jax.tree.map(np.asarray, jparams)


def _port(np_tree, tcfg, grad=False):
    params = convert.from_jax_params(np_tree, tcfg, device="cpu")
    for p in leaves(params):
        p.requires_grad_(grad)
    return params


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _x(b=2, s=12, d=64, seed=0):
    return np.random.default_rng(seed).standard_normal((b, s, d)) \
        .astype(np.float32)


def _tokens(cfg, b=2, s=12, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


# ===========================================================================
# moe_apply
# ===========================================================================
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_moe_apply_matches_jax(name):
    """One layer's ``ffn`` leaves of the JAX init, the same x: y and each
    auxiliary value at 2e-4."""
    jcfg, jparams, tcfg, np_tree = models(name)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"][0]["ffn"])
    tp = _port(jax.tree.map(np.asarray, jp), tcfg)
    x = _x()
    want, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    got, taux = moe.moe_apply(tp, torch.from_numpy(x), tcfg)
    assert got.shape == want.shape and got.dtype == torch.float32
    close(got, want)
    assert sorted(taux) == sorted(jaux) == sorted(lm.AUX_KEYS)
    for k in jaux:
        close(taux[k], jaux[k])


def test_capacity_drops_use_the_spill_column():
    """At capacity factor 0.5 an expert takes 3 of a row's 24 choices at
    most: half are dropped, as in the reference; at 1.25 few are."""
    assert moe.capacity(12, _configs("capacity0.5")[1].moe) == 3
    for name, dropped in (("capacity0.5", 0.5), ("qwen3", None)):
        _, _, tcfg, np_tree = models(name)
        tp = _port(jax.tree.map(lambda a: a[0],
                                np_tree["blocks"][0]["ffn"]), tcfg)
        _, aux = moe.moe_apply(tp, torch.from_numpy(_x()), tcfg)
        if dropped is None:
            assert 0.0 <= aux["moe_drop_frac"].item() < 0.25
        else:
            assert aux["moe_drop_frac"].item() == dropped


@pytest.mark.parametrize("s,k,e,cf", [(12, 2, 4, 1.25), (1, 8, 128, 1.25),
                                      (256, 8, 128, 1.25), (12, 2, 4, 0.5),
                                      (5, 4, 16, 1.0)])
def test_capacity_is_the_reference_formula(s, k, e, cf):
    cfg = C.MoEConfig(num_experts=e, top_k=k, d_ff_expert=8,
                      capacity_factor=cf)
    want = min(s, int(max(1, -(-s * k // e) * cf)))
    assert moe.capacity(s, cfg) == want


def test_top_k_ties_break_to_the_lower_expert():
    """Equal probabilities: the lower expert id comes first, as
    ``jax.lax.top_k`` orders them; and a whole layer whose router has
    equal columns routes as the reference's does."""
    mcfg = reduced(get_config(QWEN3)).moe
    logits = torch.tensor([[1.0, 2.0, 2.0, 2.0]]).log()
    _, gate, expert = moe.route(logits, mcfg)
    want = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits.numpy())), 2)[1]
    assert expert.tolist() == np.asarray(want).tolist() == [[1, 2]]
    assert torch.allclose(gate, torch.tensor([[0.5, 0.5]]))

    jcfg, jparams, tcfg, np_tree = models("qwen3")
    jp = dict(jax.tree.map(lambda a: a[0], jparams["blocks"][0]["ffn"]))
    col = jp["router"][:, :1]
    jp["router"] = jnp.concatenate([col, col, jp["router"][:, 2:3], col],
                                   axis=1)
    tp = _port(jax.tree.map(np.asarray, jp), tcfg)
    x = _x(seed=3)
    want, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    got, taux = moe.moe_apply(tp, torch.from_numpy(x), tcfg)
    close(got, want)
    close(taux["moe_lb_loss"], jaux["moe_lb_loss"])


def test_combine_adds_in_ascending_expert_order():
    """Each token's k slots are summed in ascending expert order from 0.0
    in float32: the same bits as a sequential sum in that order, whatever
    order top-k gave the choices."""
    _, _, tcfg, np_tree = models("qwen3")
    tp = _port(jax.tree.map(lambda a: a[0], np_tree["blocks"][0]["ffn"]),
               tcfg)
    x = torch.from_numpy(_x())
    y, r = moe.moe_ffn(tp, x, tcfg)
    _, gate, expert = moe.route(r.logits32, tcfg.moe)
    ffn = {k: v for k, v in tp.items() if k != "router"}
    want = torch.zeros(x.shape, dtype=torch.float32)
    for b in range(x.shape[0]):
        for t in range(x.shape[1]):
            acc = torch.zeros(x.shape[-1])
            for j in torch.argsort(expert[b, t]).tolist():
                if not r.keep[b, t, j]:
                    continue
                e = expert[b, t, j]
                h = x[b, t] @ ffn["wi"][e]
                g = x[b, t] @ ffn["wg"][e]
                out = (torch.nn.functional.silu(g) * h) @ ffn["wo"][e]
                acc = acc + out * gate[b, t, j]
            want[b, t] = acc
    torch.testing.assert_close(y, want, rtol=1e-6, atol=1e-6)


def test_moe_ffn_needs_no_host_sync():
    """Routing, dispatch and combine trace without a data-dependent op:
    no ``nonzero``, ``_local_scalar_dense``, masked select or ``unique``
    in the compiled forward's graph."""
    _, _, tcfg, np_tree = models("qwen3")
    eng = sma_jit(functools.partial(lm.forward, cfg=tcfg))
    with torch.no_grad():
        eng(_port(np_tree, tcfg), batch={
            "tokens": torch.from_numpy(_tokens(tcfg))})
    (entry,) = eng._cache.values()
    names = {str(n.target) for n in entry.compiled.traced.graph.nodes
             if n.op == "call_function"}
    assert not any(w in name for name in names
                   for w in ("nonzero", "_local_scalar_dense",
                             "masked_select", "unique", "index_add"))


# ===========================================================================
# The model: forward, loss and gradients, contiguous serving steps
# ===========================================================================
@pytest.mark.parametrize("name", ["qwen3", "dbrx", "capacity0.5"])
def test_forward_matches_jax(name):
    jcfg, jparams, tcfg, np_tree = models(name)
    toks = _tokens(tcfg)
    want, jaux = jlm.forward(jparams, jcfg, Runtime(),
                             {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got, taux = lm.forward_aux(_port(np_tree, tcfg), tcfg,
                                   {"tokens": torch.from_numpy(toks)})
        plain = lm.forward(_port(np_tree, tcfg), tcfg,
                           {"tokens": torch.from_numpy(toks)})
    assert got.shape == want.shape
    close(got, want)
    assert torch.equal(plain, got)
    for k in jaux:
        close(taux[k], jaux[k])


@pytest.mark.parametrize("name", ["qwen3", "dbrx", "capacity0.5"])
def test_loss_and_gradients_match_jax(name):
    """``loss_fn``: ce + lb + z and every metric, and the gradient of
    every leaf (the router's through the gate values and both aux
    losses)."""
    jcfg, jparams, tcfg, np_tree = models(name)
    toks, labels = _tokens(tcfg, seed=1), _tokens(tcfg, seed=2)
    labels[0, :3] = -1
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks),
          "labels": torch.from_numpy(labels)}
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jcfg, Runtime(), jb), has_aux=True)(jparams)
    params = _port(np_tree, tcfg, grad=True)
    loss, metrics = lm.loss_fn(params, tcfg, tb)
    grads = torch.autograd.grad(loss, leaves(params))
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    assert sorted(metrics) == sorted(jm)
    for key in jm:
        np.testing.assert_allclose(metrics[key].item(), float(jm[key]),
                                   **TOL)
    assert metrics["loss"].item() > metrics["ce_loss"].item()
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(grads)
    for g, w in zip(grads, jleaves):
        assert g.shape == w.shape
        close(g, w)


def test_remat_gives_the_same_loss_and_gradients():
    _, _, tcfg, np_tree = models("qwen3")
    tb = {"tokens": torch.from_numpy(_tokens(tcfg, seed=1)),
          "labels": torch.from_numpy(_tokens(tcfg, seed=2))}
    out = []
    for remat in (False, True):
        params = _port(np_tree, tcfg, grad=True)
        loss, metrics = lm.loss_fn(params, tcfg, tb, remat=remat)
        out.append((loss, metrics,
                    torch.autograd.grad(loss, leaves(params))))
    (l0, m0, g0), (l1, m1, g1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


@pytest.mark.parametrize("name", ["qwen3", "dbrx"])
def test_prefill_and_decode_steps_match_jax(name):
    """``lm.prefill`` then 4 ``lm.decode_step``s: logits, every cache leaf
    and cache_len."""
    jcfg, jparams, tcfg, np_tree = models(name)
    tparams = _port(np_tree, tcfg)
    toks = _tokens(tcfg, s=10)
    rt = Runtime()
    with repro.options(backend="interpret"):
        jl, jst, jcl = jlm.prefill(jparams, jcfg, rt,
                                   {"tokens": jnp.asarray(toks)},
                                   cache_size=32)
        tl, tst, tcl = lm.prefill(tparams, tcfg,
                                  {"tokens": torch.from_numpy(toks)},
                                  cache_size=32)
        for i in range(5):
            close(tl, jl)
            for g, w in zip(tst, jst):
                for k in w:
                    close(g[k], w[k])
            np.testing.assert_array_equal(tcl.numpy(), np.asarray(jcl))
            if i == 4:
                break
            step = _tokens(tcfg, s=1, seed=10 + i)
            jl, jst, jcl = jlm.decode_step(jparams, jst, jcl, jcfg, rt,
                                           {"tokens": jnp.asarray(step)})
            tl, tst, tcl = lm.decode_step(tparams, tst, tcl, tcfg,
                                          {"tokens": torch.from_numpy(step)})


# ===========================================================================
# The paged steps and the engine
# ===========================================================================
def _table(b=3):
    kv = PagedKVCache(CC, b)
    for r, n in enumerate((7, 5, 8)[:b]):
        assert kv.admit(r, n, 3)
    return kv.table_rows(list(range(b)))


@pytest.mark.parametrize("name", ["qwen3", "capacity0.5"])
def test_paged_steps_match_jax(name):
    """A ragged prefill chunk (C 8, rows of 7, 5 and 8 tokens: each row
    routed on its own, capacity from the chunk) then 3 decode steps:
    logits and the pools' real blocks."""
    jcfg, jparams, tcfg, np_tree = models(name)
    tparams = _port(np_tree, tcfg)
    b, c = 3, 8
    table = _table(b)
    n_tok = np.array([7, 5, 8], np.int32)
    rt = Runtime()
    jstate = jmodel.init_state(jcfg, b, jkv.CacheConfig(4, 40, 32))
    tstate = tmodel.init_state(tcfg, b, CC, device="cpu")

    def check(jl, tl):
        close(tl, jl)
        for k in ("k", "v"):
            close(tstate[0][k][:, :CC.num_blocks], jstate[0][k])

    with repro.options(backend="interpret"):
        toks = _tokens(tcfg, b=b, s=c)
        jl, jstate, jlen = jmodel.paged_prefill_step(
            jparams, jstate, jnp.asarray(table), jnp.zeros((b,), jnp.int32),
            jnp.asarray(n_tok), jcfg, rt, {"tokens": jnp.asarray(toks)})
        tl, tstate, tlen = tmodel.paged_prefill_step(
            tparams, tstate, torch.from_numpy(table),
            torch.zeros(b, dtype=torch.int32), torch.from_numpy(n_tok), tcfg,
            {"tokens": torch.from_numpy(toks)})
        check(jl, tl)
        for i in range(3):
            step = _tokens(tcfg, b=b, s=1, seed=20 + i)
            jl, jstate, jlen = jmodel.paged_decode_step(
                jparams, jstate, jnp.asarray(table), jlen, jcfg, rt,
                {"tokens": jnp.asarray(step)})
            tl, tstate, tlen = tmodel.paged_decode_step(
                tparams, tstate, torch.from_numpy(table), tlen, tcfg,
                {"tokens": torch.from_numpy(step)})
            check(jl, tl)
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))


def test_padding_never_takes_a_real_tokens_slot():
    """A row's real tokens come first in every expert's queue, so its
    padding past ``n_tokens`` cannot change their outputs: the logits at
    the last valid position are the same whatever the padding holds."""
    _, _, tcfg, np_tree = models("capacity0.5")
    tparams = _port(np_tree, tcfg)
    table = torch.from_numpy(_table())
    n_tok = torch.tensor([7, 5, 8], dtype=torch.int32)
    toks = torch.from_numpy(_tokens(tcfg, b=3, s=8))
    other = toks.clone()
    other[0, 7:], other[1, 5:] = 3, 200
    out = []
    for t in (toks, other):
        state = tmodel.init_state(tcfg, 3, CC, device="cpu")
        out.append(tmodel.paged_prefill_step(
            tparams, state, table, torch.zeros(3, dtype=torch.int32), n_tok,
            tcfg, {"tokens": t})[0])
    assert torch.equal(out[0], out[1])


def _record(eng):
    """Log every tick's rows (as request ids) and the compiled step's
    inputs."""
    log = []
    for phase in ("prefill", "decode"):
        tick_fn, step_fn = getattr(eng, f"_{phase}_tick"), eng.engines[phase]

        def tick(rows, phase=phase, tick_fn=tick_fn):
            by_row = eng._by_row()
            log.append({"phase": phase,
                        "rids": [by_row[r].rid for r in rows]})
            return tick_fn(rows)

        def step(*args, step_fn=step_fn):
            log[-1]["args"] = [a.numpy().copy() for a in args[2:-1]]
            log[-1]["tokens"] = args[-1]["tokens"].numpy().copy()
            return step_fn(*args)

        setattr(eng, f"_{phase}_tick", tick)
        eng.engines[phase] = step
    return log


def _jax_greedy(jcfg, jparams, reqs, log, max_batch):
    """A greedy loop over the JAX paged steps on the engine's tables,
    lengths and chunks, feeding back its own tokens."""
    rt = Runtime()
    state = jmodel.init_state(jcfg, max_batch, jkv.CacheConfig(
        CC.block_size, CC.num_blocks, CC.max_seq_len))
    decode = jax.jit(lambda p, s, bt, cl, b: jmodel.paged_decode_step(
        p, s, bt, cl, jcfg, rt, b))
    prefill = jax.jit(lambda p, s, bt, cl, nt, b: jmodel.paged_prefill_step(
        p, s, bt, cl, nt, jcfg, rt, b))
    out = {r.rid: [] for r in reqs}
    fed = {r.rid: 0 for r in reqs}
    with repro.options(backend="interpret"):
        for entry in log:
            rids, toks = entry["rids"], entry["tokens"].copy()
            if entry["phase"] == "prefill":
                bt, cl, nt = entry["args"]
                logits, state, _ = prefill(jparams, state, bt, cl, nt,
                                           {"tokens": toks})
            else:
                bt, cl = entry["args"]
                for i, rid in enumerate(rids):
                    toks[i, 0] = out[rid][-1]
                logits, state, _ = decode(jparams, state, bt, cl,
                                          {"tokens": toks})
            best = np.asarray(jnp.argmax(logits, -1))
            for i, rid in enumerate(rids):
                if entry["phase"] == "prefill":
                    fed[rid] += int(nt[i])
                    if fed[rid] < len(reqs[rid].prompt):
                        continue
                out[rid].append(int(best[i]))
    return out


def _requests(cfg, lens, max_new, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, (n,))
                    .astype(np.int32), max_new_tokens=m)
            for i, (n, m) in enumerate(zip(lens, max_new))]


def test_engine_greedy_tokens_equal_jax_loop():
    """Staggered requests through the compiled engine (chunk 4, so long
    prompts take several chunks) give the tokens of a greedy loop over the
    JAX paged steps on the same tables and chunks."""
    jcfg, jparams, tcfg, np_tree = models("qwen3")
    eng = ServeEngine(tcfg, _port(np_tree, tcfg), cache=CC, max_batch=4,
                      sched=SchedulerConfig(policy="sma", prefill_chunk=4,
                                            mode_min_run=2),
                      device="cpu")
    reqs = _requests(tcfg, lens=(6, 9, 3, 7), max_new=(5, 3, 6, 4))
    log = _record(eng)
    tick = 0
    while tick <= 3 or eng.queue or eng.active:
        for i, at in enumerate((0, 0, 2, 3)):
            if at == tick:
                eng.submit(reqs[i])
        eng.step()
        tick += 1
        assert tick < 200
    assert all(r.status == "done" for r in reqs)
    assert {e["phase"] for e in log} == {"prefill", "decode"}
    want = _jax_greedy(jcfg, jparams, reqs, log, 4)
    for r in reqs:
        assert r.out_tokens == want[r.rid], r.rid


# ===========================================================================
# The compiled paths
# ===========================================================================
def test_compiled_forward_equals_direct():
    _, _, tcfg, np_tree = models("qwen3")
    params = _port(np_tree, tcfg)
    tb = {"tokens": torch.from_numpy(_tokens(tcfg))}
    eng = sma_jit(functools.partial(lm.forward, cfg=tcfg))
    with torch.no_grad():
        got = eng(params, batch=tb)
        want = lm.forward(params, tcfg, tb)
    assert torch.equal(got, want)
    assert eng.stats.misses == 1


@pytest.fixture(scope="module")
def served():
    """A reduced Qwen3 engine after a pass of 3 requests (chunk 8)."""
    _, _, tcfg, np_tree = models("qwen3")
    eng = ServeEngine(tcfg, _port(np_tree, tcfg), cache=CC, max_batch=4,
                      sched=SchedulerConfig(prefill_chunk=8), device="cpu")
    for r in _requests(tcfg, lens=(6, 11, 3), max_new=(4, 4, 4)):
        eng.submit(r)
    eng.run()
    return eng


def _steps(tcfg, tparams, prefill, decode, n_decode=3):
    table = torch.from_numpy(_table())
    toks = torch.from_numpy(_tokens(tcfg, b=3, s=8))
    n_tok = torch.tensor([7, 5, 8], dtype=torch.int32)
    state = tmodel.init_state(tcfg, 3, CC, device="cpu")
    logits, _, cl = prefill(tparams, state, table,
                            torch.zeros(3, dtype=torch.int32), n_tok,
                            {"tokens": toks})
    out = [(logits, cl)]
    for _ in range(n_decode):
        nxt = logits.argmax(-1, keepdim=True).to(torch.int32)
        logits, _, cl = decode(tparams, state, table, cl.to(torch.int32),
                               {"tokens": nxt})
        out.append((logits, cl))
    return out, [p[:, :CC.num_blocks] for e in state for p in e.values()]


def test_compiled_ticks_equal_direct_bit_for_bit(served):
    tcfg, tparams = served.cfg, served.params
    with torch.inference_mode():
        got, gpools = _steps(tcfg, tparams, served.engines["prefill"],
                             served.engines["decode"])
        want, wpools = _steps(
            tcfg, tparams,
            lambda p, s, bt, cl, nt, b: tmodel.paged_prefill_step(
                p, s, bt, cl, nt, tcfg, b),
            lambda p, s, bt, cl, b: tmodel.paged_decode_step(
                p, s, bt, cl, tcfg, b))
    for (gl, gc), (wl, wc) in zip(got, want):
        assert torch.equal(gl, wl) and torch.equal(gc, wc)
    assert all(torch.equal(g, w) for g, w in zip(gpools, wpools))


def _compiled(eng):
    return [(phase, entry.compiled) for phase, e in eng.engines.items()
            for entry in e._cache.values()]


def test_router_is_one_sma_gemm_site_a_layer(served):
    """A compiled tick dispatches 5 ``sma_gemm`` sites a layer (q, k, v,
    o, the router) and the head; the three expert products stay native
    ``bmm``s; every site's route is in the report."""
    cfg = served.cfg
    layers, router = cfg.num_layers, [cfg.d_model, cfg.moe.num_experts]
    for _, cm in _compiled(served):
        rep = cm.report
        assert rep["dispatch"]["systolic_dispatch_sites"] == 5 * layers + 1
        assert rep["dispatch"]["native_dot_sites"] == 3 * layers
        routers = [s for s in rep["backends"]["sites"]
                   if s["op"] == "sma_gemm" and s["shapes"][1] == router]
        assert len(routers) == layers
        for s in routers:      # CPU tensors: the plain version, and why
            assert (s["backend"], s["route"]) == ("plain", None)
            assert s["fallback_reason"].startswith("platform")


def test_lowering_plans_routing_simd_and_products_systolic(served):
    """The traced tick lowers ``sort`` to TOPK, the dispatch and combine
    to GATHER_SCATTER and the expert products to batched matmuls; the
    plan puts the first two in SIMD groups and the products, the router
    among them, in systolic ones."""
    layers = served.cfg.num_layers
    for phase, cm in _compiled(served):
        program = lower_graph(cm.traced.graph)
        by_name = {}
        for op in program.ops:
            by_name.setdefault(op.name.split("#")[0], set()).add(op.kind)
        assert by_name["sort"] == {OpKind.TOPK}
        for name in ("scatter", "gather", "index"):
            assert by_name[name] == {OpKind.GATHER_SCATTER}, name
        assert by_name["bmm"] == {OpKind.ATTENTION_MATMUL}
        assert by_name["mm"] == {OpKind.MATMUL}
        assert sum(op.name.startswith("bmm#") for op in program.ops) \
            == 3 * layers
        # two sorts a layer: top-k and the combine's expert order
        assert sum(op.name.startswith("sort#") for op in program.ops) \
            == 2 * layers
        for group in SMAPolicy().plan(program.ops):
            kinds = {op.kind for op in group.ops}
            if kinds & {OpKind.TOPK, OpKind.GATHER_SCATTER}:
                assert group.mode is ExecMode.SIMD
            if kinds & {OpKind.MATMUL, OpKind.ATTENTION_MATMUL}:
                assert group.mode is ExecMode.SYSTOLIC


def test_engine_measured_mode_switches_equal_the_scheduler(served):
    """Staggered requests through the compiled MoE engine under
    ``repro_torch.profile``: every request finishes, nothing launches on
    CPU tensors, the tick spans count the scheduler's own mode switches,
    and the whole window (the dispatched sites' spans inside each tick)
    counts more."""
    reqs = _requests(served.cfg, lens=(6, 11, 3, 9), max_new=(4, 6, 4, 3),
                     seed=5)
    served.reset()
    ops.reset_counts()
    with obs.profile() as prof:
        tick = 0
        while tick <= 4 or served.queue or served.active:
            for i, at in enumerate((0, 0, 2, 4)):
                if at == tick:
                    served.submit(reqs[i])
            served.step()
            tick += 1
            assert tick < 200
    assert all(r.status == "done" for r in reqs)
    assert [len(r.out_tokens) for r in reqs] == [4, 6, 4, 3]
    assert sum(ops.launch_counts().values()) == 0
    ticks = [e for e in prof.events if e["cat"] == "serve"]
    assert len(ticks) == served.sched.ticks
    sec = obs.runtime_section(ticks)
    assert sec["mode_switches"] == served.sched.switches >= 1
    assert prof.runtime_section()["mode_switches"] > sec["mode_switches"]


def test_launch_serve_main_serves_an_moe_config(capsys):
    serve.main(["--arch", QWEN3, "--reduced", "--device", "cpu",
                "--requests", "3", "--slots", "2", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "[serve] 3 done / 0 failed of 3 requests" in out


# ===========================================================================
# Init: a stacked leaf a slice at a time
# ===========================================================================
def test_variance_scaling_init_draws_slices():
    gen = torch.Generator().manual_seed(0)
    w = layers.variance_scaling_init(gen, (6, 8, 256, 32), torch.bfloat16,
                                     fan_in=256)
    assert w.shape == (6, 8, 256, 32) and w.dtype == torch.bfloat16
    std = w.float().std().item()
    assert abs(std - 256 ** -0.5) < 0.05 * 256 ** -0.5
    assert abs(w.float().mean().item()) < 0.01 * 256 ** -0.5
    # slices are independent draws, not copies
    assert not torch.equal(w[0], w[1])
    flat = layers.variance_scaling_init(gen, (256, 64), torch.float32)
    assert abs(flat.std().item() - 256 ** -0.5) < 0.05 * 256 ** -0.5


class _PeakF32(TorchDispatchMode):
    """The largest float32 tensor any op makes."""

    def __init__(self):
        super().__init__()
        self.peak = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.dtype == torch.float32:
                self.peak = max(self.peak, t.numel())
        return out


def test_init_holds_no_f32_tensor_of_a_whole_stacked_leaf():
    """bf16 init of a 4-group MoE: the largest float32 tensor is one
    group's slice of an expert leaf (4 x 64 x 96, larger than the
    embedding table or the head), a quarter of the leaf."""
    cfg = reduced(get_config(QWEN3))
    cfg = dataclasses.replace(cfg, num_groups=4, dtype="bfloat16",
                              vocab_size=64, moe=dataclasses.replace(
                                  cfg.moe, d_ff_expert=96))
    with _PeakF32() as mode:
        params = lm.init(cfg, seed=0, device="cpu")
    wi = params["blocks"][0]["ffn"]["wi"]
    assert wi.dtype == torch.bfloat16 and wi.shape == (4, 4, 64, 96)
    assert mode.peak == wi[0].numel() == wi.numel() // 4
