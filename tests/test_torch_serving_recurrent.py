"""The port's ``ServeEngine`` on the recurrent families (reduced
recurrentgemma-2b, window 32, and xlstm-1.3b), and the loop node that
carries a prefill chunk's token loop through ``sma_jit``, on the CPU.

* The paged steps against ``repro.serving.model``'s under
  ``repro.options(backend="interpret")``, in float32: logits at rtol =
  atol = 2e-4, the pools' real blocks likewise, and every recurrent state
  leaf at rtol = 2e-4 with atol = 2e-4 x max(1, the leaf's largest
  magnitude).  Both sides run the same float32 arithmetic in another
  summation order; the mLSTM's matrix memory C sums k v^T over every
  token (|C| reaches ~10 here), and its entries near zero carry the
  absolute rounding of the largest, about 2e-5 of them after 40 tokens.
* The engine's greedy tokens against a greedy loop over the JAX steps,
  with the reference engine's row gather, scatter and zeroing.
* Compiled ticks against the direct steps, bit for bit; the prefill
  graph's size against the chunk length; the loop node's lowering,
  rewrite and dispatch census against the reference's rules
  (``repro.compiler.lower._lower_scan``, ``rewrite._recurse``); and the
  engine's containment, zeroing on admit and whole-tick retry.
"""
import dataclasses
import functools
import warnings

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
from repro_torch import SMAOptions, convert, obs, sma_jit
from repro_torch.compiler import count_dispatch_sites, lower_graph, loop
from repro_torch.configs import get_config, reduced
from repro_torch.core.modes import OpKind
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.obs import metrics
from repro_torch.resilience import faults
from repro_torch.serving import (CacheConfig, PagedKVCache, Request,
                                 RetryPolicy, SchedulerConfig, ServeEngine)
from repro_torch.serving import model as tmodel

TOL = dict(rtol=2e-4, atol=2e-4)
RG, XL = "recurrentgemma-2b", "xlstm-1.3b"
ARCHS = [RG, XL]
CC = CacheConfig(block_size=4, num_blocks=64, max_seq_len=64)
JCC = jkv.CacheConfig(4, 64, 64)
RECURRENT = ("rglru", "mlstm", "slstm")


@functools.lru_cache(maxsize=None)
def models(arch):
    """(JAX cfg, JAX params, port cfg, port params): reduced, float32, the
    reference's ``lm.init`` with key 0."""
    jcfg = C.reduced(C.get_config(arch))
    jparams = jlm.init(jax.random.PRNGKey(0), jcfg)[0]
    tcfg = reduced(get_config(arch))
    tparams = convert.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


@functools.lru_cache(maxsize=None)
def jax_steps(arch):
    jcfg = models(arch)[0]
    rt = Runtime()
    return (jax.jit(lambda p, s, bt, cl, nt, b: jmodel.paged_prefill_step(
                p, s, bt, cl, nt, jcfg, rt, b)),
            jax.jit(lambda p, s, bt, cl, b: jmodel.paged_decode_step(
                p, s, bt, cl, jcfg, rt, b)))


def _state_close(tstate, jstate, rows=slice(None)):
    """Every leaf: the pools' real blocks, the recurrent entries' ``rows``
    (module docstring's tolerances)."""
    for tentry, jentry in zip(tstate, jstate):
        assert set(tentry) == set(jentry)
        for k, jv in jentry.items():
            want = np.asarray(jv, np.float32)
            got = tentry[k].float().numpy()
            if k in ("k", "v"):
                np.testing.assert_allclose(got[:, :CC.num_blocks], want,
                                           **TOL)
                continue
            want, got = want[:, rows], got[:, rows]
            scale = max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(got, want, rtol=2e-4,
                                       atol=2e-4 * scale, err_msg=k)


def _rows(tcfg, lens, seed):
    """A table for ``len(lens)`` admitted rows and one padding row (all
    sentinel), and each row's prompt (the padding row's is empty)."""
    kv = PagedKVCache(CC, len(lens))
    for r, n in enumerate(lens):
        assert kv.admit(r, n, 3)
    table = np.vstack([kv.table_rows(list(range(len(lens)))),
                       kv.sentinel_rows(1)])
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, tcfg.vocab_size, (n,)).astype(np.int32)
               for n in lens] + [np.zeros((0,), np.int32)]
    return table, prompts


def _chunks(prompts, c):
    """Each prefill chunk's (tokens (B, c), n_tokens (B,)) until every
    prompt is fed; rows already done (and the padding row) get 0."""
    out, done = [], 0
    while done < max(len(p) for p in prompts):
        toks = np.zeros((len(prompts), c), np.int32)
        n_tok = np.zeros((len(prompts),), np.int32)
        for i, p in enumerate(prompts):
            part = p[done:done + c]
            toks[i, :len(part)] = part
            n_tok[i] = len(part)
        out.append((toks, n_tok))
        done += c
    return out


# ===========================================================================
# The paged steps against repro.serving.model
# ===========================================================================
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_steps_match_jax(arch):
    """A 40-token prompt (longer than RecurrentGemma's window of 32), a
    13-token one (a chunk of 5 < C), a 5-token one and a padding row, fed
    in chunks of 8, then 3 greedy decode steps: logits, every pool and
    every recurrent leaf after each call.  Rows past their prompt (n_tokens
    0) keep their state: the masked merge."""
    jcfg, jparams, tcfg, tparams = models(arch)
    table, prompts = _rows(tcfg, (40, 13, 5), seed=1)
    b = len(prompts)
    jprefill, jdecode = jax_steps(arch)
    jstate = jmodel.init_state(jcfg, b, JCC)
    tstate = tmodel.init_state(tcfg, b, CC, device="cpu")
    jcl, tcl = jnp.zeros((b,), jnp.int32), torch.zeros(b, dtype=torch.int32)
    bt = torch.from_numpy(table)
    with repro.options(backend="interpret"):
        for toks, n_tok in _chunks(prompts, 8):
            jl, jstate, jcl = jprefill(jparams, jstate, jnp.asarray(table),
                                       jcl, jnp.asarray(n_tok),
                                       {"tokens": jnp.asarray(toks)})
            tl, tstate, tcl = tmodel.paged_prefill_step(
                tparams, tstate, bt, tcl, torch.from_numpy(n_tok), tcfg,
                {"tokens": torch.from_numpy(toks)})
            tcl = tcl.to(torch.int32)
            live = n_tok > 0
            np.testing.assert_allclose(tl.numpy()[live],
                                       np.asarray(jl)[live], **TOL)
            _state_close(tstate, jstate)
            np.testing.assert_array_equal(tcl.numpy(), np.asarray(jcl))
        for _ in range(3):
            nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
            jl, jstate, jcl = jdecode(jparams, jstate, jnp.asarray(table),
                                      jcl, {"tokens": jnp.asarray(nxt)})
            tl, tstate, tcl = tmodel.paged_decode_step(
                tparams, tstate, bt, tcl, tcfg,
                {"tokens": torch.from_numpy(nxt)})
            tcl = tcl.to(torch.int32)
            # the padding row attends over nothing in the port and over a
            # clamped block in the reference (serving.model's docstring)
            np.testing.assert_allclose(tl.numpy()[:3], np.asarray(jl)[:3],
                                       **TOL)
            _state_close(tstate, jstate, rows=slice(0, 3))


@pytest.mark.parametrize("arch", ARCHS)
def test_steps_leave_the_given_recurrent_state_as_it_was(arch):
    """A step returns new recurrent tensors; the entries it was given keep
    their values (the pools alone are written in place)."""
    _, _, tcfg, tparams = models(arch)
    table, prompts = _rows(tcfg, (6, 3), seed=2)
    state = tmodel.init_state(tcfg, 3, CC, device="cpu")
    for entry in state:
        for v in entry.values():
            v.normal_(generator=torch.Generator().manual_seed(0))
    before = [{k: v.clone() for k, v in e.items()} for e in state]
    (toks, n_tok), = _chunks(prompts, 8)
    _, new, _ = tmodel.paged_prefill_step(
        tparams, state, torch.from_numpy(table), torch.zeros(3).int(),
        torch.from_numpy(n_tok), tcfg, {"tokens": torch.from_numpy(toks)})
    for p, btype in enumerate(tcfg.block_pattern):
        if btype in RECURRENT:
            for k, v in state[p].items():
                assert torch.equal(v, before[p][k]), (btype, k)
                assert new[p][k] is not v
                assert not torch.equal(new[p][k][:, 0], v[:, 0])
                assert torch.equal(new[p][k][:, 2], v[:, 2])  # n_tokens 0
        else:
            assert new[p] is state[p]


# ===========================================================================
# The engine
# ===========================================================================
def _engine(tcfg, tparams, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("cache", CC)
    kw.setdefault("sched", SchedulerConfig(policy="sma", prefill_chunk=8,
                                           mode_min_run=2))
    return ServeEngine(tcfg, tparams, device="cpu", **kw)


def _requests(tcfg, lens, max_new, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, tcfg.vocab_size, (n,))
                    .astype(np.int32), max_new_tokens=m)
            for i, (n, m) in enumerate(zip(lens, max_new))]


def _staggered(eng, reqs, arrivals, on_tick=None):
    """Submit reqs[i] at tick arrivals[i]; run until everything drains."""
    tick = 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        while tick <= max(arrivals) or eng.queue or eng.active:
            for i, at in enumerate(arrivals):
                if at == tick:
                    eng.submit(reqs[i])
            eng.step()
            tick += 1
            if on_tick is not None:
                on_tick(tick)
            assert tick < 500
    return {r.rid: list(r.out_tokens or []) for r in reqs}


def _record(eng):
    """Log every tick's rows (engine rows and request ids) and the inputs
    of the compiled step it runs."""
    log = []
    for phase in ("prefill", "decode"):
        tick_fn, step_fn = getattr(eng, f"_{phase}_tick"), eng.engines[phase]

        def tick(rows, phase=phase, tick_fn=tick_fn):
            by_row = eng._by_row()
            log.append({"phase": phase, "rows": list(rows),
                        "rids": [by_row[r].rid for r in rows]})
            return tick_fn(rows)

        def step(*args, step_fn=step_fn):
            log[-1]["args"] = [a.numpy().copy() for a in args[2:-1]]
            log[-1]["tokens"] = args[-1]["tokens"].numpy().copy()
            return step_fn(*args)

        setattr(eng, f"_{phase}_tick", tick)
        eng.engines[phase] = step
    return log


def _jax_greedy(arch, max_batch, reqs, log):
    """Greedy loop over the JAX steps on the engine's tables and lengths,
    with the reference engine's per-row state handling: each tick gathers
    its rows (padding repeats the first), scatters them back, and a row is
    zeroed before its request's first chunk (``_zero_row`` on admit)."""
    jcfg, jparams, _, _ = models(arch)
    prefill, decode = jax_steps(arch)
    pooled = set(jmodel.pooled_positions(jcfg))
    state = list(jmodel.init_state(jcfg, max_batch, JCC))
    out = {r.rid: [] for r in reqs}
    fed = {r.rid: 0 for r in reqs}
    prompt = {r.rid: len(r.prompt) for r in reqs}
    with repro.options(backend="interpret"):
        for entry in log:
            if "args" not in entry:
                continue
            rows, rids = entry["rows"], entry["rids"]
            toks = entry["tokens"].copy()
            for row, rid in zip(rows, rids):
                if entry["phase"] == "prefill" and fed[rid] == 0:
                    for p in range(len(state)):
                        if p not in pooled:
                            state[p] = jax.tree.map(
                                lambda s: s.at[:, row].set(0), state[p])
            padded = np.asarray(
                rows + [rows[0]] * (len(toks) - len(rows)), np.int32)
            gathered = tuple(e if p in pooled else
                             jax.tree.map(lambda s: s[:, padded], e)
                             for p, e in enumerate(state))
            if entry["phase"] == "prefill":
                bt, cl, nt = entry["args"]
                logits, new, _ = prefill(jparams, gathered, bt, cl, nt,
                                         {"tokens": toks})
            else:
                bt, cl = entry["args"]
                for i, rid in enumerate(rids):
                    toks[i, 0] = out[rid][-1]
                logits, new, _ = decode(jparams, gathered, bt, cl,
                                        {"tokens": toks})
            n = len(rows)
            for p, e in enumerate(new):
                state[p] = e if p in pooled else jax.tree.map(
                    lambda old, s: old.at[:, np.asarray(rows)].set(s[:, :n]),
                    state[p], e)
            best = np.asarray(jnp.argmax(logits, -1))
            for i, rid in enumerate(rids):
                if entry["phase"] == "prefill":
                    fed[rid] += int(nt[i])
                    if fed[rid] < prompt[rid]:
                        continue
                out[rid].append(int(best[i]))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_tokens_equal_jax_loop(arch):
    """Staggered requests served to completion by the port's engine (both
    phases compiled by ``sma_jit``) give, request by request, the tokens of
    a greedy loop over the JAX steps: ragged buckets, a prompt past the
    window, rows reused after a request finishes."""
    _, _, tcfg, tparams = models(arch)
    eng = _engine(tcfg, tparams)
    reqs = _requests(tcfg, lens=(40, 9, 3, 14, 6), max_new=(4, 3, 5, 3, 4))
    engines = dict(eng.engines)
    log = _record(eng)
    ops.reset_counts()
    _staggered(eng, reqs, arrivals=(0, 0, 2, 3, 6))
    assert all(r.status == "done" for r in reqs)
    assert {e["phase"] for e in log} == {"prefill", "decode"}
    assert len({len(e["rids"]) for e in log}) > 1       # ragged batches
    assert sum(ops.launch_counts().values()) == 0       # CPU: plain versions
    for phase, engine in engines.items():
        assert engine.stats.calls == sum(e["phase"] == phase for e in log)
    want = _jax_greedy(arch, 4, reqs, log)
    for r in reqs:
        assert r.out_tokens == want[r.rid], r.rid


def _direct(tcfg):
    return (lambda p, s, bt, cl, nt, b: tmodel.paged_prefill_step(
                p, s, bt, cl, nt, tcfg, b),
            lambda p, s, bt, cl, b: tmodel.paged_decode_step(
                p, s, bt, cl, tcfg, b))


def _steps(tcfg, tparams, prefill, decode):
    """Two prefill chunks then 3 greedy decode steps through the given
    step callables; every call's (logits, cache_len, every state leaf)."""
    table, prompts = _rows(tcfg, (13, 5, 9), seed=4)
    bt = torch.from_numpy(table)
    state = tmodel.init_state(tcfg, 4, CC, device="cpu")
    cl = torch.zeros(4, dtype=torch.int32)
    out = []
    for toks, n_tok in _chunks(prompts, 8):
        logits, state, cl = prefill(tparams, state, bt, cl,
                                    torch.from_numpy(n_tok),
                                    {"tokens": torch.from_numpy(toks)})
        cl = cl.to(torch.int32)
        out.append((logits, cl, [v.clone() for e in state
                                 for v in e.values()]))
    for _ in range(3):
        nxt = logits.argmax(-1, keepdim=True).to(torch.int32)
        logits, state, cl = decode(tparams, state, bt, cl, {"tokens": nxt})
        cl = cl.to(torch.int32)
        out.append((logits, cl, [v.clone() for e in state
                                 for v in e.values()]))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_compiled_steps_equal_direct_bit_for_bit(arch):
    _, _, tcfg, tparams = models(arch)
    eng = _engine(tcfg, tparams)
    with torch.inference_mode():
        got = _steps(tcfg, tparams, eng.engines["prefill"],
                     eng.engines["decode"])
        want = _steps(tcfg, tparams, *_direct(tcfg))
    assert eng.engines["prefill"].stats.misses == 1
    assert eng.engines["decode"].stats.misses == 1
    for (gl, gc, gs), (wl, wc, ws) in zip(got, want):
        assert torch.equal(gl, wl)
        assert torch.equal(gc, wc)
        for g, w in zip(gs, ws):
            assert torch.equal(g, w)


def _prefill_compiled(tcfg, tparams, c):
    eng = sma_jit(lambda p, s, bt, cl, nt, b: tmodel.paged_prefill_step(
        p, s, bt, cl, nt, tcfg, b))
    state = tmodel.init_state(tcfg, 2, CC, device="cpu")
    table = torch.zeros((2, CC.max_blocks_per_req), dtype=torch.int32)
    zero = torch.zeros(2, dtype=torch.int32)
    with torch.inference_mode():
        return eng.compile(tparams, state, table, zero, zero + c,
                           {"tokens": torch.zeros((2, c), dtype=torch.int32)})


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_graph_does_not_grow_with_the_chunk(arch):
    """The compiled prefill graph has one loop node per recurrent layer and
    one body per block type, and its node count at C = 4 equals that at
    C = 16: the token loop is not unrolled."""
    _, _, tcfg, tparams = models(arch)
    small = _prefill_compiled(tcfg, tparams, 4)
    large = _prefill_compiled(tcfg, tparams, 16)
    assert small.traced.num_nodes == large.traced.num_nodes
    recurrent = [b for b in tcfg.block_pattern if b in RECURRENT]
    for cm, c in ((small, 4), (large, 16)):
        nodes = [n for n in cm.traced.graph.nodes
                 if n.target is loop.LOOP_OP]
        assert len(nodes) == len(recurrent) * tcfg.num_groups
        disp = cm.report["dispatch"]
        assert disp["loop_nodes"] == len(nodes)
        bodies = disp["loop_bodies"]
        assert set(bodies) == {f"{b}_block_decode" for b in recurrent}
        for btype in set(recurrent):
            body = bodies[f"{btype}_block_decode"]
            assert body["loops"] == recurrent.count(btype) * tcfg.num_groups
            assert body["trip_counts"] == [c]
            assert body["systolic_dispatch_sites"] > 0
        low = cm.report["lowering"]
        assert (low["unrolled_scans"], low["coarsened_scans"]) == (
            (len(nodes), 0) if c <= 8 else (0, len(nodes)))


# ===========================================================================
# The loop node: lowering, rewrite, dispatch
# ===========================================================================
def _body(carry, x, consts):
    """h' = relu(h @ w + b) + x: one epilogue chain a step."""
    w, b = consts
    h = torch.relu(carry["h"] @ w + b) + x
    return {"h": h}, h.sum(-1)


def _loop_fn(h, xs, w, b):
    carry, ys = loop.scan(_body, {"h": h}, xs, (w, b))
    return carry["h"] * 2.0, ys


def _loop_args(length, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(3, 8, generator=g),
            torch.randn(length, 3, 8, generator=g),
            torch.randn(8, 8, generator=g) / 4, torch.randn(8, generator=g))


def _compiled_loop(length, max_scan_unroll=8):
    eng = sma_jit(_loop_fn, options=SMAOptions(
        max_scan_unroll=max_scan_unroll))
    return eng, eng.compile(*_loop_args(length))


def test_loop_runs_as_the_eager_loop_bit_for_bit():
    eng, cm = _compiled_loop(5)
    args = _loop_args(5, seed=1)
    got, want = eng(*args), _loop_fn(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert want[1].shape == (5, 3)
    (node,) = [n for n in cm.traced.graph.nodes if n.target is loop.LOOP_OP]
    assert loop.body_of(node.args[0]).name == "_body"


@pytest.mark.parametrize("length,max_scan_unroll",
                         [(4, 8), (8, 8), (9, 8), (16, 8), (4, 0)])
def test_loop_lowering_follows_the_reference_rule(length, max_scan_unroll):
    """``repro.compiler.lower._lower_scan``: L <= max_scan_unroll walks the
    body L times; otherwise one ``scan_carry(len=L)`` RECURRENCE op on the
    carry (L x its elements in FLOPs, its bytes in and out), then the body
    once with every cost x L."""
    _, cm = _compiled_loop(length, max_scan_unroll)
    program = lower_graph(cm.traced.graph, max_scan_unroll=max_scan_unroll)
    step = [op for op in lower_graph(cm.traced.graph,
                                     max_scan_unroll=length).ops
            if op.name.startswith("scan[0]/")]        # one step's ops
    assert step
    st = program.stats
    carry = [op for op in program.ops if op.name.startswith("scan_carry")]
    body = [op for op in program.ops
            if op.name.startswith("scan") and op not in carry]
    outside = [op for op in program.ops if not op.name.startswith("scan")]
    assert len(outside) == 1                    # the carry's "* 2.0"
    if length <= max_scan_unroll:
        assert (st.unrolled_scans, st.coarsened_scans) == (1, 0)
        assert not carry
        assert len(body) == length * len(step)
        for i in range(length):
            ops_i = [op for op in body if op.name.startswith(f"scan[{i}]/")]
            assert [(op.kind, op.flops, op.bytes_in) for op in ops_i] == \
                [(op.kind, op.flops, op.bytes_in) for op in step]
    else:
        assert (st.unrolled_scans, st.coarsened_scans) == (0, 1)
        (marker,) = carry
        assert marker.name.startswith(f"scan_carry(len={length})#")
        assert marker.kind is OpKind.RECURRENCE and not marker.tile_local
        assert marker.flops == 3 * 8 * length
        assert marker.bytes_in == marker.bytes_out == 3 * 8 * 4
        assert program.ops.index(marker) < program.ops.index(body[0])
        assert all(op.name.startswith(f"scan(x{length})/") for op in body)
        assert len(body) == len(step)
        for op, one in zip(body, step):
            assert op.kind is one.kind
            assert op.flops == pytest.approx(one.flops * length)
            assert op.bytes_in == pytest.approx(one.bytes_in * length)
            assert op.bytes_out == pytest.approx(one.bytes_out * length)


def test_loop_body_is_rewritten_once_and_counted_per_trip():
    """The body's ``mm -> add bias -> relu`` chain fuses into one site;
    the loop node counts it with its avoided bytes x L (``mult`` L), and
    the dispatch census counts the body's sites once, beside its trip
    count."""
    _, short = _compiled_loop(4)
    _, long = _compiled_loop(12)
    fus_s, fus_l = short.report["fusion"], long.report["fusion"]
    assert fus_s["realized_fused_sites"] == fus_l["realized_fused_sites"] == 1
    (site_s,), (site_l,) = fus_s["sites"], fus_l["sites"]
    assert (site_s["mult"], site_l["mult"]) == (4, 12)
    assert site_l["hbm_bytes_avoided"] == pytest.approx(
        site_s["hbm_bytes_avoided"] * 3)
    assert fus_l["realized_hbm_bytes_avoided"] == site_l["hbm_bytes_avoided"]
    census = count_dispatch_sites(long.traced.graph)
    assert census["loop_nodes"] == 1
    assert census["systolic_dispatch_sites"] == 0      # none outside
    (body,) = census["loop_bodies"].values()
    assert body["systolic_dispatch_sites"] == 1
    assert (body["loops"], body["trip_counts"]) == (1, [12])
    assert sum(n.op == "call_module" for n in long.module.graph.nodes) == 1


def test_loop_shares_one_body_per_block_and_shape():
    """Two loops over the same body at the same shapes share one body
    graph; another shape traces its own."""
    def two(h, xs, w, b):
        (c1, _), (c2, _) = (loop.scan(_body, {"h": h}, xs, (w, b)),
                            loop.scan(_body, {"h": h * 2}, xs, (w, b)))
        return c1["h"] + c2["h"]

    cm = sma_jit(two).compile(*_loop_args(3))
    ids = [n.args[0] for n in cm.traced.graph.nodes
           if n.target is loop.LOOP_OP]
    assert len(ids) == 2 and ids[0] == ids[1]
    (body,) = cm.report["dispatch"]["loop_bodies"].values()
    assert body["loops"] == 2
    h = torch.zeros(5, 8)
    wider = sma_jit(two).compile(h, torch.zeros(3, 5, 8),
                                 *_loop_args(3)[2:])
    (wid,) = {n.args[0] for n in wider.traced.graph.nodes
              if n.target is loop.LOOP_OP}
    assert wid != ids[0]


def test_loop_body_closing_over_a_tensor_raises():
    def leaky(h, xs, w):
        return loop.scan(lambda c, x, k: (c * w + x, c), h, xs, ())[0]

    with pytest.raises(TypeError, match="closes over a tensor"):
        sma_jit(leaky).compile(torch.zeros(3, 8), torch.zeros(2, 3, 8),
                               torch.zeros(8))
    grow = lambda c, x, k: (torch.cat([c, x], -1), c)     # noqa: E731
    with pytest.raises(TypeError, match="changes a carry leaf"):
        sma_jit(lambda h, xs: loop.scan(grow, h, xs, ())[0]).compile(
            torch.zeros(3, 8), torch.zeros(2, 3, 8))


# ===========================================================================
# Containment, zeroing on admit, the whole-tick retry
# ===========================================================================
def _recurrent(eng, row):
    """Every recurrent leaf's ``row`` (a copy)."""
    return [v[:, row].clone() for p, e in enumerate(eng.state)
            if p not in eng._pooled for v in e.values()]


@pytest.mark.parametrize("arch", ARCHS)
def test_poisoned_row_keeps_its_pre_tick_state(arch):
    """A request whose row goes non-finite (its pool blocks for
    RecurrentGemma, its recurrent state for xLSTM) is not scattered back:
    after each failing tick its recurrent state is what it was before the
    tick, its neighbour advances and finishes with the unpoisoned tokens;
    once its retries are spent it is evicted and its row zeroed."""
    _, _, tcfg, tparams = models(arch)
    lens, new = (6, 6), (6, 6)
    eng = _engine(tcfg, tparams, max_batch=2,
                  retry=RetryPolicy(max_retries=2))
    want = _staggered(eng, _requests(tcfg, lens, new), (0, 0))
    eng.reset()
    reqs = _requests(tcfg, lens, new)
    victim, other = reqs
    for r in reqs:
        eng.submit(r)
    while len(victim.out_tokens or []) < 2:
        eng.step()
    if arch == RG:
        for p in eng._pooled:
            for pool in eng.state[p].values():
                pool[:, eng.kv.blocks_of(victim.slot)] = float("nan")
    else:
        eng.state[0]["c"][:, victim.slot] = float("nan")
    slot = victim.slot
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        while victim.status == "active":
            before = _recurrent(eng, slot)
            neighbour = _recurrent(eng, other.slot)
            eng.step()
            if victim.status == "active":
                for a, b in zip(_recurrent(eng, slot), before):
                    assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
                assert any(not torch.equal(a, b) for a, b in
                           zip(_recurrent(eng, other.slot), neighbour))
        assert victim.status == "failed" and "non-finite" in victim.error
        assert all(not v.any() for v in _recurrent(eng, slot))
        eng.run()
    assert other.status == "done" and other.out_tokens == want[other.rid]


@pytest.mark.parametrize("arch", ARCHS)
def test_row_is_zeroed_on_admit(arch):
    """A row a finished request leaves with a live state is zeroed when the
    next request is admitted to it, so that request's tokens equal a fresh
    engine's."""
    _, _, tcfg, tparams = models(arch)
    first, second = _requests(tcfg, (9, 7), (3, 4), seed=5)
    eng = _engine(tcfg, tparams, max_batch=1)
    eng.submit(first)
    eng.run()
    assert any(v.any() for v in _recurrent(eng, 0))
    eng.submit(second)
    eng._admit_from_queue()
    assert second.slot == 0
    assert all(not v.any() for v in _recurrent(eng, 0))
    eng.run()
    fresh = _engine(tcfg, tparams, max_batch=1)
    again = _requests(tcfg, (9, 7), (3, 4), seed=5)[1]
    fresh.submit(again)
    fresh.run()
    assert second.out_tokens == again.out_tokens


@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_fault_mid_prefill_retries_exactly(arch):
    """``sma_gemm:runtime_error`` fires inside a compiled prefill tick, in
    the token loop of a recurrent layer, after earlier layers have run:
    the whole tick is retried from the untouched recurrent state and every
    token equals the unfaulted pass's."""
    _, _, tcfg, tparams = models(arch)
    lens, new, arrivals = (14, 9, 5), (3, 3, 3), (0, 1, 1)
    eng = _engine(tcfg, tparams)
    seen = [0]              # the entry's probes before each logged tick
    with faults.inject_faults("sma_gemm:runtime_error:times=0") as (count,):
        want = _staggered(
            eng, _requests(tcfg, lens, new), arrivals,
            on_tick=lambda t: seen.append(count._seen)
            if len(eng.tick_log) == len(seen) else None)
    tick = [i for i, (p, rows, _) in enumerate(eng.tick_log)
            if p == "prefill" and rows > 1][0]
    after = (seen[tick] + seen[tick + 1]) // 2
    eng.reset()
    misses = {p: e.stats.misses for p, e in eng.engines.items()}
    before = metrics.get("serve.tick_failures")
    spec = f"sma_gemm:runtime_error:times=1,after={after}"
    with faults.inject_faults(spec) as (fault,):
        got = _staggered(eng, _requests(tcfg, lens, new), arrivals)
    assert fault._fired == 1
    assert metrics.get("serve.tick_failures") == before + 1
    assert {p: e.stats.misses for p, e in eng.engines.items()} == misses
    assert got == want


def test_profiled_loop_records_one_span_per_loop_node():
    """Under ``repro_torch.profile`` a compiled loop runs as one
    ``dispatch.loop`` span (its body and trip count) and gives the
    unprofiled result."""
    eng, _ = _compiled_loop(6)
    args = _loop_args(6, seed=2)
    want = eng(*args)
    with obs.profile() as prof:
        got = eng(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    (span,) = [e for e in prof.events if e["name"] == "dispatch.loop"]
    assert (span["args"]["body"], span["args"]["len"]) == ("_body", 6)


def test_gemm_plain_chain_runs_as_traced():
    """``ref.gemm_ref`` on a strided 3-D operand (an mLSTM ``x_m`` slice)
    runs the same ``mm`` eagerly and in a traced graph, so compiled and
    direct steps agree bit for bit; the traced product is a GEMM site."""
    g = torch.Generator().manual_seed(3)
    up = torch.randn(4, 1, 256, generator=g)
    w = torch.randn(128, 128, generator=g)
    eng = sma_jit(lambda u, w: ops.sma_gemm(u[..., :128], w))
    assert torch.equal(eng(up, w), ops.sma_gemm(up[..., :128], w))
    rep = eng.compile(up, w).report["dispatch"]
    assert (rep["systolic_dispatch_sites"], rep["native_dot_sites"]) == (1, 0)


def test_dropped_prologue_keeps_the_bias_in_the_epilogue():
    """``rmsnorm -> mm -> add(bias) -> downcast`` in bf16 (an sLSTM's
    ``norm1 -> w_gates``): the prologue cannot fuse (``rmsnorm_gemm``
    returns bf16 before the f32 bias add), so the product is an epilogue
    site with its bias on the bf16 operands, as the direct call is."""
    from repro_torch.models.layers import rmsnorm_apply
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 1, 64, generator=g).bfloat16()
    scale = torch.rand(64, generator=g) + 0.5
    w = torch.randn(64, 256, generator=g).bfloat16()
    b = torch.randn(256, generator=g).bfloat16()

    def fn(x, scale, w, b):
        h = rmsnorm_apply({"scale": scale}, x)
        return ops.sma_gemm(h, w, bias=b).float() * 2.0

    cm = sma_jit(fn).compile(x, scale, w, b)
    (site,) = cm.rewritten.sites
    assert (site.kind, site.site["bias"], site.site["dtype"],
            site.site["folded_casts"]) == ("epilogue", True, "bfloat16", True)
    assert torch.equal(sma_jit(fn)(x, scale, w, b), fn(x, scale, w, b))


def test_xlstm_decode_fuses_each_mlstm_norm_into_its_up_projection():
    """By the reference's prologue rule an mLSTM layer's ``norm1`` feeds
    only ``w_up``, so a compiled bf16 decode step runs it as one
    ``rmsnorm_gemm`` (besides the head); an sLSTM's ``w_gates`` keeps its
    bias epilogue, every site on the bf16 operands; in a prefill step the
    norm's output enters the loop."""
    tcfg = dataclasses.replace(models(XL)[2], dtype="bfloat16")
    tparams = lm.init(tcfg, seed=0, device="cpu")
    n_mlstm = tcfg.num_groups * tcfg.block_pattern.count("mlstm")
    eng = _engine(tcfg, tparams)
    with torch.inference_mode():
        _steps(tcfg, tparams, eng.engines["prefill"], eng.engines["decode"])
    for phase, want in (("prefill", 1), ("decode", 1 + n_mlstm)):
        (entry,) = eng.engines[phase]._cache.values()
        fus = entry.compiled.report_data["fusion"]
        assert fus["realized_prologue_sites"] == want, phase
        assert not any(s["dtype"] == "float32" for s in fus["sites"])
