"""``repro_torch.launch.serve``: the deprecated slot ``Server`` and the
serving entry point, on the CPU, at the reduced StableLM in float32.

The ``Server``'s greedy tokens are held against a JAX loop over
``repro.serving.model.paged_prefill_step`` / ``paged_decode_step`` (under
``repro.options(backend="interpret")``) with the slot API's semantics: the
whole prompt prefilled with no token emitted, then decode steps that
re-feed the last prompt token at position len(prompt) (so the cache holds
it twice) and then their own tokens.  Token ids compare exactly: both
sides compute float32 logits that differ by ~1e-6 (the parity tests'
2e-4 tolerance), far below the gaps between a random model's top logits.
"""
import json
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
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve
from repro_torch.launch.serve import Request, Server

ARCH = "stablelm-1.6b"


@pytest.fixture(scope="module")
def models():
    jcfg = C.reduced(C.get_config(ARCH))
    jparams = jlm.init(jax.random.PRNGKey(0), jcfg)[0]
    tcfg = reduced(get_config(ARCH))
    tparams = convert.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _server(tcfg, tparams, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return Server(tcfg, tparams, device="cpu", **kw)


def jax_slot_tokens(jcfg, jparams, prompt, max_new):
    """One request alone through the JAX paged steps with the slot API's
    semantics (module docstring)."""
    bs, n = 16, len(prompt)
    nb = -(-(n + max_new + 1) // bs)
    state = jmodel.init_state(jcfg, 1, jkv.CacheConfig(bs, nb, nb * bs))
    table = jnp.arange(nb, dtype=jnp.int32)[None]
    rt = Runtime()
    out = []
    with repro.options(backend="interpret"):
        _, state, cl = jmodel.paged_prefill_step(
            jparams, state, table, jnp.zeros((1,), jnp.int32),
            jnp.full((1,), n, jnp.int32), jcfg, rt,
            {"tokens": jnp.asarray(prompt, jnp.int32)[None]})
        assert int(cl[0]) == n
        tok = int(prompt[-1])                   # the re-feed
        for _ in range(max_new):
            logits, state, cl = jmodel.paged_decode_step(
                jparams, state, table, cl, jcfg, rt,
                {"tokens": jnp.full((1, 1), tok, jnp.int32)})
            tok = int(jnp.argmax(logits[0]))
            out.append(tok)
    return out


def test_server_warns_once_at_the_caller(models):
    _, _, tcfg, tparams = models
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        server = Server(tcfg, tparams, slots=2, cache_size=64, device="cpu")
    dep = [w for w in caught if issubclass(w.category, DeprecationWarning)]
    assert len(dep) == 1
    assert "ServeEngine" in str(dep[0].message)
    assert dep[0].filename == __file__
    assert server.core.cache.block_size == 16
    assert server.core.cache.num_blocks == 2 * 4
    assert server.core.cache.max_seq_len == 64


@pytest.mark.parametrize("slots,lens,max_new", [
    (4, (3, 7, 12, 5), (6, 4, 5, 7)),
    (2, (20, 1), (3, 9)),
])
def test_server_tokens_equal_jax_refeed_loop(models, slots, lens, max_new):
    jcfg, jparams, tcfg, tparams = models
    server = _server(tcfg, tparams, slots=slots, cache_size=48)
    rng = np.random.default_rng(len(lens))
    reqs = [Request(rid=i, prompt=rng.integers(0, tcfg.vocab_size, (n,))
                    .astype(np.int32), max_new_tokens=m)
            for i, (n, m) in enumerate(zip(lens, max_new))]
    for r in reqs:
        assert server.admit(r)
        assert r.status == "active" and r.out_tokens == []
        assert server.cache_len[r.slot] == len(r.prompt)
    ticks = 0
    while server.active:
        out = server.tick()
        assert out and all(rid in {r.rid for r in reqs} for rid in out)
        ticks += 1
    assert ticks == max(max_new)
    assert server.tick() == {}
    for r in reqs:
        assert r.status == "done"
        assert r.out_tokens == jax_slot_tokens(jcfg, jparams, r.prompt,
                                               r.max_new_tokens), r.rid


def test_admit_is_false_only_without_capacity(models):
    _, _, tcfg, tparams = models
    server = _server(tcfg, tparams, slots=2, cache_size=32)
    a, b, c = (Request(rid=i, prompt=np.arange(1, 5, dtype=np.int32),
                       max_new_tokens=4) for i in range(3))
    assert server.admit(a) and server.admit(b)
    assert server.free_slots() == []
    assert not server.admit(c)                   # no slot: transient
    assert c.status == "pending"
    empty = Request(rid=3, prompt=np.zeros((0,), np.int32))
    too_long = Request(rid=4, prompt=np.ones((30,), np.int32),
                       max_new_tokens=8)
    trivial = Request(rid=5, prompt=np.ones((3,), np.int32),
                      max_new_tokens=0)
    for r in (empty, too_long, trivial):
        assert server.admit(r)                   # consumed, even when full
    assert empty.status == too_long.status == "failed"
    assert trivial.status == "done" and trivial.out_tokens == []
    assert set(server.failed) == {3, 4}
    while server.active:
        server.tick()
    assert server.admit(c) and c.status == "active"


def test_main_serves_on_the_cpu(capsys, tmp_path):
    trace = tmp_path / "serve.json"
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                "--requests", "3", "--slots", "2", "--max-new", "4",
                "--trace-out", str(trace)])
    out = capsys.readouterr().out
    assert "[serve] 3 done / 0 failed of 3 requests" in out
    assert "decode engine cache" in out and "prefill engine cache" in out
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e["name"].startswith("serving.tick.") for e in events)


def test_main_raises_without_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", ARCH, "--reduced"])
