"""``repro_torch.obs`` against ``repro.obs``, and the port's spans, on the
CPU.

The export and metrics logic is a copy of the reference's: the same event
lists and the same registry operations must give the same snapshots,
Chrome traces, ``runtime`` sections and timelines, exactly (the one
difference is the label of a synchronized section's wall basis, which names
``torch.cuda.synchronize``).  The tracing rules are the reference's
``tests/test_obs.py``: spans nest engine -> dispatch -> kernel, nothing is
recorded outside a profile, and a profile is never part of a compile-cache
key.  The port's engines run the plain versions here (CPU tensors), so a
kernel span's route reads ``plain``.
"""
import json
import random

import numpy as np
import pytest
import torch

import repro_torch
from repro.obs import export as jexport
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro_torch import obs, sma_jit
from repro_torch.compiler import render_text
from repro_torch.obs import export as texport
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import timing as ttiming
from repro_torch.obs import trace as ttrace


def _sandwich_engine():
    """x @ w1 -> softmax over the rows (SIMD: a reduction across tiles,
    which no GEMM epilogue can take) -> @ w2: statically 2 mode
    switches."""
    rng = np.random.default_rng(0)
    w1 = torch.from_numpy(rng.standard_normal((16, 16)) * 0.25).float()
    w2 = torch.from_numpy(rng.standard_normal((16, 16)) * 0.25).float()
    engine = sma_jit(lambda x, w1, w2: torch.softmax(x @ w1, 0) @ w2,
                     name="sandwich")
    return engine, (torch.ones(8, 16), w1, w2)


def _random_events(seed, n=40):
    """Nested and overlapping mode-tagged spans, untagged host spans,
    zero-length slices and instants, as a tracer records them."""
    rnd = random.Random(seed)
    events, t = [], 0.0
    for i in range(n):
        t += rnd.choice([0.0, 0.5, 1.0, 3.0])
        mode = rnd.choice(["systolic", "simd", "comm", None])
        dur = rnd.choice([0.0, 1.0, 2.5, 10.0])
        ev = {"name": f"e{i}", "cat": rnd.choice(["kernel", "dispatch",
                                                    "engine", "serve"]),
              "ts": t, "dur": dur, "mode": mode,
              "args": {"i": i, "synced": False}}
        if rnd.random() < 0.1:
            ev.update(ph="i", dur=0.0, mode=None)
        if ev["cat"] == "engine" and rnd.random() < 0.5:
            ev["name"] = "engine.compile"
        events.append(ev)
    return events


# ===========================================================================
# The copied logic gives the reference's results, exactly
# ===========================================================================
@pytest.mark.parametrize("seed", range(4))
def test_metrics_snapshot_and_percentiles_equal_reference(seed):
    rnd = random.Random(seed)
    mine, theirs = tmetrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    for _ in range(3000):              # past SAMPLE_CAP: the window slides
        name = rnd.choice(["a", "b", "lat", "ttft"])
        if rnd.random() < 0.4:
            n = rnd.choice([1, 2, 0.5])
            mine.inc(name, n)
            theirs.inc(name, n)
        else:
            v = rnd.expovariate(1.0)
            mine.observe(name, v)
            theirs.observe(name, v)
        assert mine.get(name) == theirs.get(name)
    assert mine.snapshot() == theirs.snapshot()
    assert tmetrics.SAMPLE_CAP == jmetrics.SAMPLE_CAP
    vals = sorted(rnd.random() for _ in range(101))
    for q in (0.0, 0.5, 0.99, 1.0):
        assert tmetrics._percentile(vals, q) == jmetrics._percentile(vals, q)
    mine.reset()
    theirs.reset()
    assert mine.snapshot() == theirs.snapshot() == {"counters": {},
                                                   "histograms": {}}


@pytest.mark.parametrize("seed", range(4))
def test_chrome_trace_equals_reference(seed):
    events = _random_events(seed)
    assert texport.chrome_trace(events) == jexport.chrome_trace(events)
    assert texport.LANES == jexport.LANES


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("sync", [False, True])
def test_runtime_section_and_timeline_equal_reference(seed, sync):
    events = _random_events(seed)
    mine = texport.runtime_section(events, sync=sync, max_segments=7)
    theirs = jexport.runtime_section(events, sync=sync, max_segments=7)
    if sync:
        assert mine.pop("wall_basis") == \
            "device (torch.cuda.synchronize at span boundaries)"
        assert "device" in theirs.pop("wall_basis")
    assert mine == theirs
    sec = jexport.runtime_section(events, sync=sync)
    assert texport.render_mode_timeline(sec, width=48) == \
        jexport.render_mode_timeline(sec, width=48)


def test_tracer_records_what_the_reference_records():
    """The same calls on both tracers give the same events (timestamps
    aside)."""
    def drive(mod):
        t = mod.Tracer()
        with t.span("outer", cat="serve", mode="simd", rows=2) as sp:
            sp.annotate(cache="hit")
            t.add_event("region", cat="dispatch", ts=1.0, dur=2.0,
                        mode="simd", nodes=3)
            t.instant("mark", cat="host", k=1)
        return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
                for e in t.events]

    assert drive(ttrace) == drive(jtrace)


# ===========================================================================
# Span tracing through the port's engine
# ===========================================================================
def test_spans_nest_engine_dispatch_kernel():
    engine, x = _sandwich_engine()
    with obs.profile() as prof:
        engine(*x)
    names = {e["name"] for e in prof.events}
    assert {"engine.call", "engine.compile", "compile.trace",
            "compile.lower", "compile.plan", "compile.rewrite",
            "dispatch.sma_gemm", "kernel.sma_gemm",
            "dispatch.simd_region"} <= names
    call = next(e for e in prof.events if e["name"] == "engine.call")
    for e in prof.events:
        if e["name"].startswith(("kernel.", "dispatch.", "compile.")):
            assert e["ts"] >= call["ts"] - 1e-6
            assert e["ts"] + e["dur"] <= call["ts"] + call["dur"] + 1e-6
    kernels = [e for e in prof.events if e["name"] == "kernel.sma_gemm"]
    assert len(kernels) == 2
    for kernel in kernels:
        assert kernel["mode"] == "systolic" and kernel["cat"] == "kernel"
        assert kernel["args"]["route"] == "plain"      # CPU tensors
        site = next(e for e in prof.events
                    if e["name"] == "dispatch.sma_gemm"
                    and e["ts"] <= kernel["ts"]
                    and kernel["ts"] + kernel["dur"]
                    <= e["ts"] + e["dur"] + 1e-6)
        assert site["args"]["lhs"] == [8, 16]
    region = next(e for e in prof.events
                  if e["name"] == "dispatch.simd_region")
    assert region["mode"] == "simd" and region["args"]["nodes"] >= 1
    assert call["args"]["cache"] == "miss"


def test_second_call_is_traced_as_cache_hit():
    engine, x = _sandwich_engine()
    engine(*x)
    with obs.profile() as prof:
        engine(*x)
    call = next(e for e in prof.events if e["name"] == "engine.call")
    assert call["args"]["cache"] == "hit"
    assert not any(e["name"] == "engine.compile" for e in prof.events)


def test_traced_run_gives_the_generated_code_s_outputs():
    engine, x = _sandwich_engine()
    plain = engine(*x)
    with obs.profile():
        traced = engine(*x)
    assert torch.equal(plain, traced)


def test_sync_mode_marks_spans_synced():
    engine, x = _sandwich_engine()
    engine(*x)
    with obs.profile(sync=True) as prof:
        engine(*x)
    call = next(e for e in prof.events if e["name"] == "engine.call")
    assert call["args"]["synced"] is True
    assert all(e["args"]["synced"] for e in prof.events
               if e["name"].startswith("kernel."))
    sec = prof.runtime_section()
    assert sec["sync"] is True and "device" in sec["wall_basis"]


def test_block_marks_a_fake_value_unsynced():
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fake = torch.empty(3)
    with obs.profile(sync=True) as prof:
        with obs.span("fake") as sp:
            sp.block(fake)
    assert prof.events[0]["args"]["synced"] is False


def test_fused_sites_record_fused_gemm_spans():
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((16, 8))).float()
    b = torch.from_numpy(rng.standard_normal(8)).float()
    engine = sma_jit(lambda x, w, b: torch.relu(x @ w + b))
    x = (torch.ones(4, 16), w, b)
    engine(*x)
    with obs.profile() as prof:
        engine(*x)
    fused = [e for e in prof.events if e["name"] == "dispatch.fused_gemm"]
    assert len(fused) == 1
    assert fused[0]["args"]["kind"] == "epilogue"
    assert fused[0]["args"]["epilogue"] == "relu"


def test_kernel_spans_of_every_entry_carry_mode_and_route():
    from repro_torch.kernels import ops
    rng = np.random.default_rng(2)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).float()

    q, k, v = t(1, 2, 8, 16), t(1, 2, 8, 16), t(1, 2, 8, 16)
    with torch.no_grad(), obs.profile() as prof:
        ops.rmsnorm_gemm(t(4, 16), t(16), t(16, 8))
        ops.flash_attention(q, k, v)
        ops.decode_attention(t(2, 2, 16), t(2, 2, 8, 16), t(2, 2, 8, 16),
                             torch.tensor([3, 8]))
        ops.rglru_scan(t(1, 8, 4).sigmoid(), t(1, 8, 4))
        ops.mlstm_chunkwise(q, k, v, -t(1, 2, 8).abs(), t(1, 2, 8),
                            chunk=4)
        table = torch.tensor([[0, 1]], dtype=torch.int32)
        ops.paged_decode_attention(t(1, 2, 2, 16), t(2, 2, 4, 16),
                                   t(2, 2, 4, 16), table,
                                   torch.tensor([[3, 4]]),
                                   torch.tensor([5]))
    spans = {e["name"]: e for e in prof.events}
    assert {n: spans[n]["mode"] for n in spans} == {
        "kernel.rmsnorm_gemm": "systolic", "kernel.flash_attention":
        "systolic", "kernel.decode_attention": "systolic",
        "kernel.rglru_scan": "simd", "kernel.mlstm_chunkwise": "simd",
        "kernel.paged_decode_attention": "systolic"}
    assert all(e["args"]["route"] == "plain" for e in prof.events)
    assert spans["kernel.paged_decode_attention"]["args"]["reason"] \
        .startswith("shape:chunked prefill tile (C=2)")


# ===========================================================================
# Disabled tracing: zero events, zero cache fragmentation
# ===========================================================================
def test_no_tracer_outside_profile_scope():
    assert obs.current_tracer() is None
    with obs.profile() as prof:
        assert obs.current_tracer() is prof
    assert obs.current_tracer() is None
    assert obs.last_tracer() is prof


def test_disabled_records_no_events():
    engine, x = _sandwich_engine()
    with obs.profile() as prof:
        pass
    engine(*x)
    engine(*x)
    assert obs.current_tracer() is None
    assert prof.events == []


def test_profile_does_not_fragment_compile_cache():
    engine, x = _sandwich_engine()
    engine(*x)
    assert engine.cache_size == 1
    with obs.profile():
        engine(*x)
    with obs.profile(sync=True):
        engine(*x)
    engine(*x)
    assert engine.cache_size == 1
    assert engine.stats.misses == 1 and engine.stats.hits == 3


def test_tracing_absent_from_options_cache_key():
    key_fields = repro_torch.SMAOptions().cache_key()
    assert not any("trace" in str(f) or "profile" in str(f)
                   for f in key_fields)
    assert repro_torch.profile is obs.profile


# ===========================================================================
# Chrome-trace export
# ===========================================================================
def test_chrome_trace_schema_and_roundtrip(tmp_path):
    engine, x = _sandwich_engine()
    path = tmp_path / "trace.json"
    with obs.profile(path=str(path)):
        engine(*x)
    doc = json.loads(path.read_text())
    assert doc["displayTimeUnit"] == "ms"
    for ev in doc["traceEvents"]:
        assert ev["ph"] in ("X", "M", "i")
        assert isinstance(ev["pid"], int) and isinstance(ev["tid"], int)
        if ev["ph"] == "X":
            assert isinstance(ev["ts"], float)
            assert isinstance(ev["dur"], float) and ev["dur"] >= 0.0


def test_systolic_and_simd_lanes_present():
    engine, x = _sandwich_engine()
    with obs.profile() as prof:
        engine(*x)
    events = prof.chrome_trace()["traceEvents"]
    lanes = {ev["args"]["name"] for ev in events
             if ev["ph"] == "M" and ev["name"] == "thread_name"}
    assert lanes == {"host", "systolic mode", "simd mode", "comm mode"}
    tids = {ev["tid"] for ev in events if ev["ph"] == "X"}
    assert {obs.LANES["systolic"], obs.LANES["simd"],
            obs.LANES["host"]} <= tids


# ===========================================================================
# The runtime plan-report section
# ===========================================================================
def test_runtime_switches_match_static_plan():
    """On a cache-hit call the measured mode-switch count equals the static
    plan's."""
    engine, x = _sandwich_engine()
    engine(*x)
    engine(*x)
    with obs.profile(sync=True) as prof:
        engine(*x)
    compiled = engine.compile(*x)
    static = compiled.summary.mode_switches
    assert static == 2
    assert prof.runtime_section()["mode_switches"] == static
    rep = compiled.report
    assert rep["runtime"]["mode_switches"] == static
    assert rep["runtime"]["kernel_spans"] == 2
    json.dumps(rep)


def test_render_text_includes_runtime_timeline():
    engine, x = _sandwich_engine()
    engine(*x)
    with obs.profile(sync=True):
        engine(*x)
    text = render_text(engine.compile(*x).report)
    assert "runtime (measured)" in text
    assert "runtime mode timeline" in text
    assert "engine cache" in text


def test_timeline_text_renders_two_lanes():
    engine, x = _sandwich_engine()
    with obs.profile() as prof:
        engine(*x)
    text = prof.timeline_text()
    assert "systolic" in text and "simd" in text
    assert "mode switches (runtime)" in text


# ===========================================================================
# Metrics and timing
# ===========================================================================
def test_engine_feeds_global_metrics():
    obs.reset()
    engine, x = _sandwich_engine()
    engine(*x)
    engine(*x)
    snap = obs.snapshot()
    assert snap["counters"]["engine.cache_misses"] == 1
    assert snap["counters"]["engine.cache_hits"] == 1
    assert snap["histograms"]["engine.compile_s"]["count"] == 1


def test_engine_evictions_are_counted():
    obs.reset()
    engine = sma_jit(lambda x: x @ x.T,
                     options=repro_torch.SMAOptions(max_cache_entries=1))
    for n in (2, 3, 2):
        engine(torch.ones(n, 4))
    assert obs.snapshot()["counters"]["engine.cache_evictions"] == 2


def test_snapshot_is_a_copy():
    reg = obs.MetricsRegistry()
    reg.inc("x")
    snap = reg.snapshot()
    snap["counters"]["x"] = 999
    assert reg.snapshot()["counters"]["x"] == 1


def test_timeit_semantics():
    calls = []

    def fn(v):
        calls.append(v)
        return torch.tensor(v)

    assert ttiming.timeit(fn, 1.0, iters=3, warmup=2) >= 0.0
    assert len(calls) == 5
    ttiming.timeit_us(fn, 1.0, iters=1, warmup=0, sync_each=True)
    assert len(calls) == 6
    with pytest.raises(ValueError):
        ttiming.timeit(lambda: None, iters=0)
