"""repro_torch.resilience against repro.resilience, and the port's
failure-isolated serving, on the CPU.

* Fault specs and injectors: the port's ``parse_faults`` gives the specs
  ``repro.resilience.faults.parse_faults`` gives and refuses the same bad
  ones; a seeded probabilistic schedule fires on the same probes in both
  packages; ``times`` / ``after``, ``latency``, ``compile_error`` and the
  backend qualifier behave as the reference's tests say.
* ``is_runtime_failure``: the port's narrower set (a CUDA launch error is
  never retried; ``guard.py``'s docstring says why).
* ``check_numerics`` under ``off`` / ``log`` / ``raise``; ``"fallback"``
  refused.  The report's ``resilience`` section has the reference's keys.
* The engine's compile probe, and a kernel-site probe firing inside a
  compiled serving tick.
* The reference's ``TestServeChaos`` scenarios (``tests/test_resilience.py``,
  which cannot run here: ``repro.compiler`` does not import on this JAX
  version) on the port's ``Server`` with the same assertions; the
  surviving requests' tokens equal a greedy JAX loop over
  ``repro.serving.model``'s paged steps under ``backend="interpret"``.
* A kernel fault in the middle of a compiled decode tick: the whole-tick
  retry gives the unfaulted run's tokens bit for bit (the pools are
  written in place, and the retry rewrites the same slots).
"""
import time
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
from repro.resilience import faults as jfaults
from repro.resilience import guard as jguard
from repro.serving import kv_cache as jkv
from repro.serving import model as jmodel
import repro_torch
import repro_torch.resilience as res
from repro_torch import SMAOptions, convert, sma_jit
from repro_torch.configs import get_config, reduced
from repro_torch.launch.serve import Server
from repro_torch.obs import metrics
from repro_torch.resilience import faults, guard
from repro_torch.resilience.guard import RetryPolicy
from repro_torch.serving import (CacheConfig, Request, SchedulerConfig,
                                 ServeEngine)

ARCH = "stablelm-1.6b"


@pytest.fixture(autouse=True)
def _reset_resilience():
    res.reset()
    yield
    res.reset()
    faults.reinstall_env_faults()


@pytest.fixture(scope="module")
def models():
    """(JAX cfg, JAX params, port cfg, port params) of the reduced model."""
    jcfg = C.reduced(C.get_config(ARCH))
    jparams = jlm.init(jax.random.PRNGKey(0), jcfg)[0]
    tcfg = reduced(get_config(ARCH))
    tparams = convert.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _fields(spec):
    return (spec.site, spec.kind, spec.backend, spec.times, spec.after,
            spec.p, spec.latency_s)


# ---------------------------------------------------------------------------
# Fault specs and injectors, against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("text", [
    "sma_gemm@interpret:runtime_error:times=2,after=1;"
    "serve.tick:latency:latency_s=0.005,p=0.5;*:nan:times=none",
    "sma_gemm@cuda:runtime_error:times=1,after=40",
    "engine.compile:compile_error:times=1",
    "  serve.tick:runtime_error ; ;paged_decode_attention@plain:inf:p=0.25",
    "s:latency:times=none,after=3,latency_s=0.002",
])
def test_parse_faults_matches_reference(text):
    ours, theirs = faults.parse_faults(text), jfaults.parse_faults(text)
    assert [_fields(s) for s in ours] == [_fields(s) for s in theirs]


@pytest.mark.parametrize("text,match", [
    ("just-a-site", "needs site:kind"), ("x:explode", "unknown fault kind"),
    ("x:nan:bogus=1", "unknown fault param"), ("x:nan:times=two", "two"),
])
def test_parse_faults_rejects_as_reference(text, match):
    for parse in (faults.parse_faults, jfaults.parse_faults):
        with pytest.raises(ValueError, match=match):
            parse(text)


def _firing(module, spec_text, seed, probes=40):
    fired = []
    with module.inject_faults(spec_text, seed=seed):
        for i in range(probes):
            try:
                module.maybe_raise("s", "cuda" if i % 3 else "plain")
                fired.append(False)
            except module.InjectedFault:
                fired.append(True)
    return fired


@pytest.mark.parametrize("spec_text", [
    "s:runtime_error:times=none,p=0.3",
    "s@cuda:runtime_error:times=5,after=2,p=0.5",
    "s:runtime_error:times=3,after=7",
])
@pytest.mark.parametrize("seed", [0, 7, 11])
def test_seeded_schedule_fires_as_reference(spec_text, seed):
    ours = _firing(faults, spec_text, seed)
    assert ours == _firing(jfaults, spec_text, seed)
    assert ours == _firing(faults, spec_text, seed)     # replays
    assert any(ours) and not all(ours)


def test_times_and_after_budget():
    spec = faults.FaultSpec(site="s", kind="runtime_error", times=2,
                            after=1)
    with faults.inject_faults(spec):
        faults.maybe_raise("s")           # after=1: skipped
        for _ in range(2):                # times=2: fires twice
            with pytest.raises(faults.InjectedFault):
                faults.maybe_raise("s")
        faults.maybe_raise("s")           # budget spent
    faults.maybe_raise("s")               # out of scope: inert


def test_backend_qualifier_scopes_the_fault():
    with faults.inject_faults("s@cuda:runtime_error:times=none"):
        faults.maybe_raise("s", "plain")
        with pytest.raises(faults.InjectedFault, match="s@cuda"):
            faults.maybe_raise("s", "cuda")


def test_latency_kind_sleeps():
    with faults.inject_faults("s:latency:latency_s=0.05"):
        t0 = time.perf_counter()
        faults.maybe_raise("s")
        assert time.perf_counter() - t0 >= 0.04


def test_compile_error_gated_on_compile_scope():
    with faults.inject_faults("s:compile_error:times=none"):
        faults.maybe_raise("s")
        with faults.compile_scope():
            assert faults.in_compile_scope()
            with pytest.raises(faults.InjectedFault):
                faults.maybe_raise("s")
    assert not faults.in_compile_scope()


def test_env_schedule_reinstall(monkeypatch):
    monkeypatch.setenv("REPRO_FAULTS", "envsite:runtime_error:times=1")
    faults.reinstall_env_faults()
    assert not faults.QUIET
    with pytest.raises(faults.InjectedFault):
        faults.maybe_raise("envsite")
    faults.maybe_raise("envsite")         # times=1 consumed
    assert not faults.QUIET               # the env schedule stays armed
    monkeypatch.delenv("REPRO_FAULTS")
    faults.reinstall_env_faults()
    faults.maybe_raise("envsite")
    assert faults.QUIET                   # nothing can fire: one read


def test_corrupt_poisons_float_tensors_only():
    value = {"x": torch.ones(3), "h": torch.ones(2, dtype=torch.bfloat16),
             "i": torch.arange(3), "t": (torch.zeros(2), None)}
    with faults.inject_faults("s:nan"):
        out = faults.corrupt("s", None, value)
    assert torch.isnan(out["x"]).all() and torch.isnan(out["h"]).all()
    assert out["h"].dtype == torch.bfloat16
    assert torch.isnan(out["t"][0]).all() and out["t"][1] is None
    assert torch.equal(out["i"], torch.arange(3))
    with faults.inject_faults("s:inf"):
        assert torch.isinf(faults.corrupt("s", "cuda", torch.ones(2))).all()


def test_kernel_entry_probes_fire_by_route():
    from repro_torch.kernels import ops
    a, b = torch.randn(4, 8), torch.randn(8, 3)
    with faults.inject_faults("sma_gemm@cuda:runtime_error:times=none"):
        ops.sma_gemm(a, b)                # a CPU tensor: route "plain"
    with faults.inject_faults("sma_gemm@plain:runtime_error:times=1"):
        with pytest.raises(faults.InjectedFault, match="sma_gemm@plain"):
            ops.sma_gemm(a, b)
        assert torch.isfinite(ops.sma_gemm(a, b)).all()
    with faults.inject_faults("rmsnorm_gemm:nan:times=1"):
        out = ops.rmsnorm_gemm(a, torch.ones(8), b)
    assert torch.isnan(out).all()


# ---------------------------------------------------------------------------
# Classification, numeric guards, the report section
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("exc", [
    faults.InjectedFault("s", None, "runtime_error"),
    faults.InjectedFault("engine.compile", "x", "compile_error"),
    torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate"),
    MemoryError(),
])
def test_runtime_failures_are_retried(exc):
    assert guard.is_runtime_failure(exc)


@pytest.mark.parametrize("exc", [
    NotImplementedError("rglru_scan has no backward kernel on the card"),
    RuntimeError("sma_gemm: CUDA error 2 at launch (out of memory)"),
    RuntimeError("RESOURCE_EXHAUSTED: OOM"),
    RuntimeError("INTERNAL: plain failure"),
    ValueError("x"), TypeError("x"), FloatingPointError("non-finite"),
])
def test_other_failures_propagate(exc):
    """Deliberate divergence from the reference: a launch error (its text
    may read "out of memory") and a refused site are not retried."""
    assert not guard.is_runtime_failure(exc)


def test_check_numerics_value_policies():
    good, bad = torch.ones(3), {"a": torch.ones(2), "b": torch.full(
        (2,), float("nan")), "i": torch.arange(2)}
    for policy in (None, "off", "log", "raise"):
        assert guard.check_numerics_value("op", "cuda", good, None,
                                          policy) is good
    assert guard.check_numerics_value("op", "cuda", bad, None, "off") is bad
    assert guard.resilience_section()["numeric_events"] == 0
    with pytest.warns(RuntimeWarning, match="non-finite"):
        assert guard.check_numerics_value("op", "cuda", bad, None,
                                          "log") is bad
    with pytest.raises(FloatingPointError, match=r"\['b'\]"):
        guard.check_numerics_value("op", "cuda", bad, None, "raise")
    section = guard.resilience_section()
    assert section["numeric_events"] == 2 and section["enabled"]
    assert [e["policy"] for e in section["events"]] == ["log", "raise"]
    with pytest.raises(ValueError, match="check_numerics"):
        guard.check_numerics_value("op", "cuda", bad, None, "sometimes")


@pytest.mark.parametrize("policy", ["fallback", "sometimes"])
def test_options_refuse_fallback_and_unknown_policies(policy):
    with pytest.raises(ValueError, match="check_numerics"):
        SMAOptions(check_numerics=policy)
    if policy == "fallback":
        with pytest.raises(ValueError, match="falls back"):
            SMAOptions(check_numerics=policy)


def test_kernel_sites_check_numerics_in_an_options_context():
    from repro_torch.kernels import ops
    a, b = torch.randn(4, 8), torch.randn(8, 3)
    with repro_torch.options(check_numerics="raise"):
        with faults.inject_faults("sma_gemm@plain:inf:times=1"):
            with pytest.raises(FloatingPointError, match="sma_gemm"):
                ops.sma_gemm(a, b)
    with faults.inject_faults("sma_gemm@plain:inf:times=1"):
        assert torch.isinf(ops.sma_gemm(a, b)).all()    # off: silent


def test_resilience_section_keys_equal_the_reference():
    jguard.reset()
    ours, theirs = guard.resilience_section(), jguard.resilience_section()
    assert set(ours) == set(theirs)
    assert {k: type(v) for k, v in ours.items()} == \
        {k: type(v) for k, v in theirs.items()}
    with faults.inject_faults("s:runtime_error"):
        with pytest.raises(faults.InjectedFault):
            faults.maybe_raise("s")
    section = guard.resilience_section()
    assert section["injected_faults"]["runtime_error"] >= 1
    assert section["runtime_fallbacks"] == section["failover_attempts"] \
        == section["numeric_fallbacks"] == section["quarantine_skips"] == 0
    assert section["quarantine"] == []


# ---------------------------------------------------------------------------
# The engine: compile probe, boundary guard, report
# ---------------------------------------------------------------------------
def test_engine_compile_probe_and_report():
    from repro_torch.compiler import render_text
    w = torch.randn(32, 8)
    engine = sma_jit(lambda x, w: x @ w, name="cfault")
    with faults.inject_faults("engine.compile:compile_error:times=1"):
        with pytest.raises(faults.InjectedFault, match="engine.compile"):
            engine(torch.ones(4, 32), w)
    assert engine.cache_size == 0 and engine.stats.misses == 0
    with faults.inject_faults("engine.compile@other:runtime_error"):
        out = engine(torch.ones(4, 32), w)       # another engine's spec
    assert out.shape == (4, 8) and engine.stats.misses == 1
    with faults.inject_faults("engine.compile:compile_error:times=1"):
        engine(torch.ones(4, 32), w)             # a hit compiles nothing
    rep = engine.compile(torch.ones(4, 32), w).report
    assert set(rep["resilience"]) == set(jguard.resilience_section())
    assert rep["resilience"]["injected_faults"]["compile_error"] >= 1
    assert "injected faults" in render_text(rep)


def test_engine_boundary_numeric_guard():
    """With ``check_numerics`` on, an engine checks its outputs (and its
    call's kernel entries check theirs); there is no recompute."""
    w = torch.randn(32, 8)
    x = torch.ones(4, 32)
    x[0, 0] = float("nan")
    raising = sma_jit(lambda x: (x + 1, x.sum()), name="guard_raise",
                      options=SMAOptions(check_numerics="raise"))
    with pytest.raises(FloatingPointError, match="engine.guard_raise"):
        raising(x)
    gemm = sma_jit(lambda x, w: x @ w, name="guard_gemm",
                   options=SMAOptions(check_numerics="raise"))
    with pytest.raises(FloatingPointError, match="sma_gemm"):
        gemm(x, w)                        # the kernel entry's own check
    logging = sma_jit(lambda x, w: x @ w, name="guard_log",
                      options=SMAOptions(check_numerics="log"))
    with pytest.warns(RuntimeWarning, match="engine.guard_log"):
        out = logging(x, w)
    assert torch.isnan(out[0]).all()
    assert sma_jit(lambda x, w: x @ w)(x, w).isnan().any()   # off
    assert guard.resilience_section()["numeric_events"] >= 3


# ---------------------------------------------------------------------------
# Serving under chaos
# ---------------------------------------------------------------------------
def _server(tparams, tcfg, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("cache_size", 64)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return Server(tcfg, tparams, device="cpu", **kw)


def jax_slot_tokens(jcfg, jparams, prompt, max_new):
    """The slot API's tokens from the JAX paged steps, one request alone:
    the whole prompt in one prefill chunk (no token emitted), then greedy
    decode steps that re-feed the last prompt token at position
    len(prompt) and then their own tokens."""
    bs, n = 16, len(prompt)
    nb = -(-(n + max_new + 1) // bs)
    cc = jkv.CacheConfig(bs, nb, nb * bs)
    state = jmodel.init_state(jcfg, 1, cc)
    table = jnp.arange(nb, dtype=jnp.int32)[None]
    rt = Runtime()
    out = []
    with repro.options(backend="interpret"):
        _, state, cl = jmodel.paged_prefill_step(
            jparams, state, table, jnp.zeros((1,), jnp.int32),
            jnp.full((1,), n, jnp.int32), jcfg, rt,
            {"tokens": jnp.asarray(prompt, jnp.int32)[None]})
        tok = int(prompt[-1])
        for _ in range(max_new):
            logits, state, cl = jmodel.paged_decode_step(
                jparams, state, table, cl, jcfg, rt,
                {"tokens": jnp.full((1, 1), tok, jnp.int32)})
            tok = int(jnp.argmax(logits[0]))
            out.append(tok)
    return out


def test_poisoned_request_evicted_others_complete(models):
    """One slot's pool blocks go NaN: that request is retried then evicted
    while the other finishes its full budget; the freed slot serves a
    fresh request (the reference's acceptance scenario)."""
    jcfg, jparams, tcfg, tparams = models
    server = _server(tparams, tcfg, retry=RetryPolicy(max_retries=1))
    r0 = Request(rid=0, prompt=np.array([1, 2, 3], np.int32),
                 max_new_tokens=4)
    r1 = Request(rid=1, prompt=np.array([4, 5, 6], np.int32),
                 max_new_tokens=4)
    assert server.admit(r0) and server.admit(r1)
    server.tick()
    core = server.core
    blocks = core.kv.blocks_of(r1.slot)
    for p in core._pooled:
        for pool in core.state[p].values():
            pool[:, blocks] = float("nan")
    evictions_before = metrics.get("serve.evictions")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for _ in range(12):
            if not server.active:
                break
            server.tick()
    assert r0.status == "done"
    assert len(r0.out_tokens) == 4
    assert all(0 <= t < tcfg.vocab_size for t in r0.out_tokens)
    assert r1.status == "failed"
    assert "non-finite" in r1.error
    assert r1.retries == 2  # one retry granted, second strike evicts
    assert metrics.get("serve.evictions") == evictions_before + 1
    assert server.failed == {1: r1} and 0 in server.done
    assert any(e["kind"] == "serve_evicted" and e["rid"] == 1
               for e in guard.EVENTS)
    r2 = Request(rid=2, prompt=np.array([7, 8], np.int32), max_new_tokens=3)
    assert server.admit(r2)
    while server.active:
        server.tick()
    assert r2.status == "done" and len(r2.out_tokens) == 3
    for r in (r0, r2):
        assert r.out_tokens == jax_slot_tokens(jcfg, jparams, r.prompt,
                                               r.max_new_tokens), r.rid


def test_tick_runtime_fault_retries_whole_batch(models):
    jcfg, jparams, tcfg, tparams = models
    server = _server(tparams, tcfg, retry=RetryPolicy(max_retries=2))
    req = Request(rid=0, prompt=np.array([1, 2], np.int32), max_new_tokens=3)
    assert server.admit(req)
    before = metrics.get("serve.tick_failures")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with repro_torch.inject_faults("serve.tick:runtime_error:times=1"):
            out = server.tick()     # injected failure: no tokens
            assert out == {}
            assert req.retries == 1
            while server.active:
                server.tick()
    assert req.status == "done" and len(req.out_tokens) == 3
    assert metrics.get("serve.tick_failures") == before + 1
    assert req.out_tokens == jax_slot_tokens(jcfg, jparams, req.prompt, 3)


def test_watchdog_counts_deadline_overrun(models):
    _, _, tcfg, tparams = models
    server = _server(tparams, tcfg, retry=RetryPolicy(deadline_s=0.01))
    req = Request(rid=0, prompt=np.array([1, 2], np.int32), max_new_tokens=1)
    before = metrics.get("serve.watchdog_exceeded")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", RuntimeWarning)
        assert server.admit(req)
        for _ in range(2):
            with repro_torch.inject_faults(
                    "serve.tick:latency:times=1,latency_s=0.05"):
                server.core.decode_tick()
    assert metrics.get("serve.watchdog_exceeded") >= before + 2
    # warned once per site, however often the deadline is missed
    assert sum("serve.tick took" in str(w.message) for w in caught) == 1


def test_admit_fault_evicts_and_frees_the_slot(models):
    _, _, tcfg, tparams = models
    server = _server(tparams, tcfg)
    req = Request(rid=0, prompt=np.array([1, 2, 3], np.int32),
                  max_new_tokens=2)
    with repro_torch.inject_faults("serve.admit:runtime_error:times=1"):
        assert server.admit(req)
    assert req.status == "failed" and "warmup failed" in req.error
    assert server.free_slots() == [0, 1]
    with repro_torch.inject_faults("serve.admit:compile_error"):
        ok = Request(rid=1, prompt=np.array([1, 2], np.int32),
                     max_new_tokens=2)
        assert server.admit(ok)           # not compiling: inert
    assert ok.status == "active"


def _engine(tcfg, tparams, **kw):
    kw.setdefault("max_batch", 4)
    return ServeEngine(tcfg, tparams, device="cpu",
                       cache=CacheConfig(block_size=4, num_blocks=48,
                                         max_seq_len=32),
                       sched=SchedulerConfig(prefill_chunk=8), **kw)


def _requests(tcfg, seed=3):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, tcfg.vocab_size, (n,))
                    .astype(np.int32), max_new_tokens=5)
            for i, n in enumerate((9, 5, 12))]


def _serve(eng, reqs, on_tick=None):
    for r in reqs:
        eng.submit(r)
    ticks = 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        while eng.queue or eng.active:
            eng.step()
            ticks += 1
            if on_tick is not None:
                on_tick(ticks)
            assert ticks < 200
    return {r.rid: list(r.out_tokens or []) for r in reqs}


def test_kernel_fault_inside_a_compiled_tick_retries_exactly(models):
    """``sma_gemm@plain:runtime_error`` fires in the compiled module's own
    call of the entry (the signature is cached: no trace runs), in the
    middle of a decode tick after some layers wrote the pools; the whole
    tick is retried and every token equals the unfaulted pass's."""
    _, _, tcfg, tparams = models
    eng = _engine(tcfg, tparams)
    seen = []
    with faults.inject_faults("sma_gemm:runtime_error:times=0") as (count,):
        want = _serve(eng, _requests(tcfg),
                      on_tick=lambda t: seen.append(count._seen))
    # the second decode tick, layer 1's 4th product (layer 0 has written)
    second = [i for i, (p, _, _) in enumerate(eng.tick_log)
              if p == "decode"][1]
    after = seen[second - 1] + 7 + 3
    eng.reset()
    misses = {p: e.stats.misses for p, e in eng.engines.items()}
    before = metrics.get("serve.tick_failures")
    spec = f"sma_gemm@plain:runtime_error:times=1,after={after}"
    with faults.inject_faults(spec) as (fault,):
        got = _serve(eng, _requests(tcfg))
    assert fault._fired == 1
    assert metrics.get("serve.tick_failures") == before + 1
    assert {p: e.stats.misses for p, e in eng.engines.items()} == misses
    assert got == want
    assert all(r.status == "done" for r in eng.done.values())


def test_poisoned_row_in_compiled_engine_keeps_neighbours_exact(models):
    _, _, tcfg, tparams = models
    eng = _engine(tcfg, tparams, retry=RetryPolicy(max_retries=2))
    want = _serve(eng, _requests(tcfg))
    eng.reset()
    reqs = _requests(tcfg)
    victim = reqs[1]
    poisoned = []

    def poison(tick):
        if victim.status == "active" and len(victim.out_tokens) == 2 \
                and not poisoned:
            poisoned.append(tick)
            for pool in eng.state[0].values():
                pool[:, eng.kv.blocks_of(victim.slot)] = float("nan")

    got = _serve(eng, reqs, on_tick=poison)
    assert victim.status == "failed" and "non-finite" in victim.error
    assert victim.retries == eng.retry.max_retries + 1
    for r in reqs:
        if r is not victim:
            assert r.status == "done" and got[r.rid] == want[r.rid]
    assert not torch.isnan(eng.state[0]["k"]).any()


def test_check_numerics_raise_propagates_from_a_compiled_tick(models):
    _, _, tcfg, tparams = models
    eng = _engine(tcfg, tparams,
                  options=SMAOptions(check_numerics="raise"))
    _serve(eng, _requests(tcfg))                # clean: compiles, passes
    eng.reset()
    for r in _requests(tcfg):
        eng.submit(r)
    with faults.inject_faults("sma_gemm@plain:nan:times=1"):
        with pytest.raises(FloatingPointError, match="sma_gemm"):
            eng.step()
    assert guard.resilience_section()["numeric_events"] >= 1


def test_launch_errors_propagate_from_a_tick(models, monkeypatch):
    """A kernel launch error (``_build.check``'s RuntimeError, whose text
    can read "out of memory") is not retried: the tick raises, nothing is
    charged or evicted."""
    from repro_torch.kernels import sma_gemm as kgemm
    _, _, tcfg, tparams = models
    eng = _engine(tcfg, tparams)
    reqs = _requests(tcfg)
    for r in reqs:
        eng.submit(r)
    eng.step()

    def launch_error(*args, **kwargs):
        raise RuntimeError("sma_gemm: CUDA error 2 at launch (out of memory)")
    monkeypatch.setattr(kgemm, "sma_gemm", launch_error)
    failures = metrics.get("serve.tick_failures")
    with pytest.raises(RuntimeError, match="CUDA error 2"):
        eng.step()
    assert metrics.get("serve.tick_failures") == failures
    assert all(r.retries == 0 and r.status == "active" for r in reqs)


def test_emit_first_false_suppresses_the_prefill_token(models):
    _, _, tcfg, tparams = models
    eng = _engine(tcfg, tparams)
    a, b = (Request(rid=i, prompt=np.arange(3, 8 + i, dtype=np.int32),
                    max_new_tokens=3) for i in range(2))
    assert eng.try_admit(a) and eng.try_admit(b, emit_first=False)
    eng.step()                                  # both prompts in one chunk
    assert len(a.out_tokens) == 1 and b.out_tokens == []
    assert a.emit_first and not b.emit_first
    out = eng.decode_tick()
    assert set(out) == {a.rid, b.rid} and len(b.out_tokens) == 1
    # b's first decode fed its last prompt token at position len(prompt)
    assert eng.cache_len[b.slot] == len(b.prompt) + 1


def test_probes_cost_nothing_without_a_scope():
    """No scope open and REPRO_FAULTS empty: ``QUIET`` (one attribute read)
    is all a kernel entry consults; a fault scope and a check_numerics
    context each clear it while open, an "off" context does not."""
    faults.maybe_raise("anything")
    assert faults.QUIET
    with faults.inject_faults("x:nan"):
        assert not faults.QUIET
        with faults.inject_faults("y:nan"):
            pass
        assert not faults.QUIET
    assert faults.QUIET
    with repro_torch.options(check_numerics="log"):
        assert not faults.QUIET
        with repro_torch.options(check_numerics="off"):
            assert not faults.QUIET
    assert faults.QUIET
    with repro_torch.options(check_numerics="off"):
        assert faults.QUIET
