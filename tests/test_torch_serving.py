"""repro_torch.serving against repro.serving, on the CPU.

The JAX serving steps are called directly (the JAX ``ServeEngine`` runs
through ``sma_jit``, whose ``repro.compiler`` does not import on this JAX
version) under ``repro.options(backend="interpret")``.  Parameters come
from ``repro.models.lm.init`` and are loaded into the port with
``convert.from_jax_params``; the reduced config computes in float32.

Tolerance for logits and pools: rtol = atol = 2e-4.  Both sides compute the
same float32 arithmetic; they differ only in summation order inside the
matrix products (XLA's CPU kernels against PyTorch's), which moves the
reduced model's logits (|logit| < 10) by about 1e-6.
"""
import random

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
from repro.serving import scheduler as jsched
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops
from repro_torch.serving import (CacheConfig, ModeScheduler, PagedKVCache,
                                 Request, SchedulerConfig, ServeEngine)
from repro_torch.serving import model as tmodel

TOL = dict(rtol=2e-4, atol=2e-4)
ARCH = "stablelm-1.6b"


@pytest.fixture(scope="module")
def models():
    """(JAX cfg, JAX params, port cfg, port params) of the reduced model."""
    jcfg = C.reduced(C.get_config(ARCH))
    jparams = jlm.init(jax.random.PRNGKey(0), jcfg)[0]
    tcfg = reduced(get_config(ARCH))
    tparams = convert.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def test_config_mirrors_jax():
    for jc, tc in ((C.get_config(ARCH), get_config(ARCH)),
                   (C.reduced(C.get_config(ARCH)), reduced(get_config(ARCH)))):
        for field in ("num_groups", "d_model", "num_heads", "num_kv_heads",
                      "d_ff", "vocab_size", "resolved_head_dim",
                      "rope_theta", "dtype"):
            assert getattr(jc, field) == getattr(tc, field), field


def test_converted_params_mirror_the_jax_tree(models):
    jcfg, jparams, tcfg, tparams = models
    jleaves = jax.tree_util.tree_leaves_with_path(jparams)
    for path, leaf in jleaves:
        node = tparams
        for key in path:
            node = node[getattr(key, "key", getattr(key, "idx", None))]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_paged_prefill_then_decode_match_jax(models):
    """One chunked prefill (ragged n_tokens) then 3 decode steps: logits and
    both pools agree with repro.serving.model at every step (the pools'
    real blocks; the port's last block is the spare that dropped writes
    land in)."""
    jcfg, jparams, tcfg, tparams = models
    cc = CacheConfig(block_size=4, num_blocks=32, max_seq_len=64)
    b, c = 3, 8
    kv = PagedKVCache(cc, b)
    for r, n in enumerate((7, 5, 8)):
        assert kv.admit(r, n, 3)
    table = kv.table_rows([0, 1, 2])
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, (b, c)).astype(np.int32)
    n_tok = np.array([7, 5, 8], np.int32)
    rt = Runtime()
    jstate = jmodel.init_state(jcfg, b, jkv.CacheConfig(4, 32, 64))
    tstate = tmodel.init_state(tcfg, b, cc, device="cpu")

    def check(jl, tl):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        for name in ("k", "v"):
            assert tstate[0][name].shape[1] == cc.num_blocks + 1
            np.testing.assert_allclose(tstate[0][name][:, :cc.num_blocks]
                                       .numpy(),
                                       np.asarray(jstate[0][name]), **TOL)

    with repro.options(backend="interpret"):
        jl, jstate, jlen = jmodel.paged_prefill_step(
            jparams, jstate, jnp.asarray(table), jnp.zeros((b,), jnp.int32),
            jnp.asarray(n_tok), jcfg, rt, {"tokens": jnp.asarray(toks)})
        tl, tstate, tlen = tmodel.paged_prefill_step(
            tparams, tstate, torch.from_numpy(table),
            torch.zeros(b, dtype=torch.int32), torch.from_numpy(n_tok), tcfg,
            {"tokens": torch.from_numpy(toks)})
        check(jl, tl)
        for _ in range(3):
            nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
            jl, jstate, jlen = jmodel.paged_decode_step(
                jparams, jstate, jnp.asarray(table), jlen, jcfg, rt,
                {"tokens": jnp.asarray(nxt)})
            tl, tstate, tlen = tmodel.paged_decode_step(
                tparams, tstate, torch.from_numpy(table), tlen, tcfg,
                {"tokens": torch.from_numpy(nxt)})
            check(jl, tl)
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))


def test_sentinel_and_padding_writes_are_masked():
    """Padding positions, sentinel entries and positions past the table
    write nowhere in the real blocks (the JAX scatter's mode="drop"): they
    land in the spare block at the sentinel id."""
    table = torch.tensor([[3, 5], [6, 6]], dtype=torch.int32)   # NB = 6
    pos = torch.tensor([[0, 5, 9], [1, 2, 3]])
    valid = torch.tensor([[True, False, True], [True, True, True]])
    w = tmodel.write_index(table, pos, num_blocks=6, block_size=4,
                           valid=valid)
    assert w.keep.tolist() == [[True, False, False], [False] * 3]
    # row 0 pos 0 -> block 3 slot 0; every other write -> the spare block 6
    assert w.blocks.tolist() == [3, 6, 6, 6, 6, 6]
    assert w.offsets.tolist() == [0, 1, 1, 1, 2, 3]
    pool = torch.zeros(7, 1, 4, 2)
    val = torch.arange(1.0, 7.0)[:, None, None].expand(6, 1, 2)
    tmodel._pool_write(pool, w, val.reshape(2, 3, 1, 2))
    want = torch.zeros(6, 1, 4, 2)
    want[3, :, 0] = 1.0
    assert torch.equal(pool[:6], want)


def test_decode_padding_rows_attend_over_nothing(models, monkeypatch):
    """A batch-padding row (all-sentinel table) reaches attention with
    kv_len 0, so no kernel reads a sentinel entry, and the live row's
    logits are those it gets in a batch of its own."""
    _, _, tcfg, tparams = models
    cc = CacheConfig(block_size=4, num_blocks=8, max_seq_len=16)
    kv = PagedKVCache(cc, 1)
    assert kv.admit(0, 3, 2)
    table = torch.from_numpy(np.vstack([kv.table_rows([0]),
                                        kv.sentinel_rows(1)]))
    seen = []
    attend = ops.paged_decode_attention

    def spy(q, k_pool, v_pool, block_table, q_pos, kv_len, **kw):
        seen.append(kv_len.tolist())
        return attend(q, k_pool, v_pool, block_table, q_pos, kv_len, **kw)

    monkeypatch.setattr(ops, "paged_decode_attention", spy)
    toks = {"tokens": torch.tensor([[5], [5]])}
    state = tmodel.init_state(tcfg, 2, cc, device="cpu")
    both, _, cl = tmodel.paged_decode_step(
        tparams, state, table, torch.tensor([3, 0]), tcfg, toks)
    assert seen == [[4, 0]] * tcfg.num_layers
    assert cl.tolist() == [4, 1]
    state = tmodel.init_state(tcfg, 1, cc, device="cpu")
    alone, _, _ = tmodel.paged_decode_step(
        tparams, state, table[:1], torch.tensor([3]), tcfg,
        {"tokens": toks["tokens"][:1]})
    torch.testing.assert_close(both[:1], alone, **TOL)


# ---------------------------------------------------------------------------
# The copied bookkeeping behaves as the JAX modules
# ---------------------------------------------------------------------------
def test_paged_kv_cache_matches_jax_on_random_ops():
    rnd = random.Random(0)
    cfg = dict(block_size=4, num_blocks=12, max_seq_len=32)
    mine = PagedKVCache(CacheConfig(**cfg), 4)
    theirs = jkv.PagedKVCache(jkv.CacheConfig(**cfg), 4)
    for _ in range(300):
        row = rnd.randrange(4)
        if rnd.random() < 0.6:
            p, n = rnd.randrange(1, 30), rnd.randrange(0, 12)
            assert (mine.admission_error(p, n)
                    == theirs.admission_error(p, n))
            assert mine.can_admit(p, n) == theirs.can_admit(p, n)
            if mine.admission_error(p, n) is None \
                    and not mine.blocks_of(row):
                assert mine.admit(row, p, n) == theirs.admit(row, p, n)
        else:
            assert mine.release(row) == theirs.release(row)
        np.testing.assert_array_equal(mine.table_rows([0, 1, 2, 3]),
                                      theirs.table_rows([0, 1, 2, 3]))
        assert mine.stats() == theirs.stats()


@pytest.mark.parametrize("policy", ["sma", "fcfs"])
def test_mode_scheduler_matches_jax_on_random_ticks(policy):
    rnd = random.Random(1)
    kw = dict(policy=policy, prefill_chunk=4, max_prefill_batch=3,
              mode_min_run=3)
    mine = ModeScheduler(SchedulerConfig(**kw))
    theirs = jsched.ModeScheduler(jsched.SchedulerConfig(**kw))
    for _ in range(200):
        pre = rnd.sample(range(8), rnd.randrange(0, 4))
        dec = sorted(rnd.sample(range(8), rnd.randrange(0, 5)))
        a, b = mine.plan(pre, dec), theirs.plan(pre, dec)
        assert (a.phase, a.rows, a.switched, a.mode) \
            == (b.phase, b.rows, b.switched, b.mode)
    assert mine.stats() == theirs.stats()


# ---------------------------------------------------------------------------
# ServeEngine
# ---------------------------------------------------------------------------
def _requests(cfg, lens, max_new, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, (n,))
                    .astype(np.int32), max_new_tokens=m)
            for i, (n, m) in enumerate(zip(lens, max_new))]


def _staggered(eng, reqs, arrivals):
    """Submit reqs[i] at tick arrivals[i]; run until everything drains."""
    tick = 0
    while tick <= max(arrivals) or eng.queue or eng.active:
        for i, at in enumerate(arrivals):
            if at == tick:
                eng.submit(reqs[i])
        eng.step()
        tick += 1
        assert tick < 500


def _record(eng):
    """Log every tick's rows (as request ids) and the inputs of the
    compiled step it runs."""
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


def _jax_greedy(jcfg, jparams, cc, max_batch, reqs, log):
    """Greedy loop over the JAX step functions on the engine's tables and
    cache lengths, feeding back its own tokens."""
    rt = Runtime()
    state = jmodel.init_state(jcfg, max_batch, jkv.CacheConfig(
        cc.block_size, cc.num_blocks, cc.max_seq_len))
    decode = jax.jit(lambda p, s, bt, cl, b: jmodel.paged_decode_step(
        p, s, bt, cl, jcfg, rt, b))
    prefill = jax.jit(lambda p, s, bt, cl, nt, b: jmodel.paged_prefill_step(
        p, s, bt, cl, nt, jcfg, rt, b))
    out = {r.rid: [] for r in reqs}
    fed = {r.rid: 0 for r in reqs}
    prompt = {r.rid: len(r.prompt) for r in reqs}
    with repro.options(backend="interpret"):
        for entry in log:
            if "args" not in entry:
                continue
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
                    if fed[rid] < prompt[rid]:
                        continue
                out[rid].append(int(best[i]))
    return out


def test_engine_greedy_tokens_equal_jax_loop(models):
    """Staggered requests served to completion by the port's engine (both
    phases compiled by sma_jit) give, request by request, the tokens of a
    greedy loop over the JAX step functions on the same block tables."""
    jcfg, jparams, tcfg, tparams = models
    cc = CacheConfig(block_size=4, num_blocks=40, max_seq_len=32)
    eng = ServeEngine(tcfg, tparams, cache=cc, max_batch=4,
                      sched=SchedulerConfig(policy="sma", prefill_chunk=4,
                                            mode_min_run=2),
                      device="cpu")
    reqs = _requests(tcfg, lens=(6, 9, 3, 7, 5), max_new=(5, 3, 6, 4, 4))
    engines = dict(eng.engines)
    log = _record(eng)
    ops.reset_counts()
    _staggered(eng, reqs, arrivals=(0, 0, 2, 3, 6))
    assert all(r.status == "done" for r in reqs)
    assert [len(r.out_tokens) for r in reqs] == [5, 3, 6, 4, 4]
    assert {e["phase"] for e in log} == {"prefill", "decode"}
    assert len({len(e["rids"]) for e in log}) > 1       # ragged batches
    assert eng.kv.stats()["blocks_used"] == 0
    # CPU tensors: every wrapper took its plain version, none launched
    assert sum(ops.launch_counts().values()) == 0
    for phase, engine in engines.items():
        ticks = sum(e["phase"] == phase for e in log)
        assert engine.stats.calls == ticks and engine.stats.misses >= 1
    want = _jax_greedy(jcfg, jparams, cc, 4, reqs, log)
    for r in reqs:
        assert r.out_tokens == want[r.rid], r.rid


def test_engine_sma_switches_no_more_than_fcfs(models):
    """Mode batching: a trickle of arrivals during decode makes fcfs switch
    on every arrival; sma pools them and switches less."""
    _, _, tcfg, tparams = models
    switches = {}
    for policy in ("sma", "fcfs"):
        eng = ServeEngine(
            tcfg, tparams,
            cache=CacheConfig(block_size=4, num_blocks=64, max_seq_len=32),
            max_batch=4, device="cpu",
            sched=SchedulerConfig(policy=policy, prefill_chunk=4,
                                  max_prefill_batch=4, mode_min_run=8))
        reqs = _requests(tcfg, lens=(4,) * 8, max_new=(12,) * 8)
        _staggered(eng, reqs, arrivals=(0, 0, 3, 6, 9, 12, 15, 18))
        assert all(r.status == "done" for r in reqs)
        switches[policy] = eng.sched.switches
    assert 0 < switches["sma"] < switches["fcfs"], switches


def test_engine_contains_non_finite_rows(models):
    """A request whose pool blocks are poisoned is evicted after its retry
    budget, its blocks are scrubbed and freed, and its neighbour finishes."""
    _, _, tcfg, tparams = models
    eng = ServeEngine(tcfg, tparams, max_batch=2, device="cpu",
                      cache=CacheConfig(block_size=4, num_blocks=48,
                                        max_seq_len=64),
                      sched=SchedulerConfig(prefill_chunk=4))
    r0, r1 = _requests(tcfg, lens=(6, 6), max_new=(6, 6))
    eng.submit(r0)
    eng.submit(r1)
    while not (r0.out_tokens and r1.out_tokens):
        eng.step()
    victim = eng.kv.blocks_of(r1.slot)
    for pool in eng.state[0].values():
        pool[:, victim] = float("nan")
    eng.run()
    assert r1.status == "failed" and "non-finite" in r1.error
    assert r0.status == "done" and len(r0.out_tokens) == 6
    assert eng.kv.stats()["blocks_used"] == 0
    assert not torch.isnan(eng.state[0]["k"]).any()


def test_entry_points_refuse_to_default_to_cpu(models, monkeypatch):
    """With no card the entry points raise instead of running on the CPU
    unless the caller asks for it."""
    _, _, tcfg, tparams = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.models import lm
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init(tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(tcfg, tparams)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmodel.init_state(tcfg, 1, CacheConfig())
    assert lm.init(tcfg, device="cpu")["head"]["w"].shape == (64, 256)
