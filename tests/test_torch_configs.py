"""The dense ``attn`` configs, the input modes and the logits softcap
against the JAX package, on the CPU.

* Every config of the reference is registered in the port and equals
  ``repro.configs``' field for field (an MoE config's ``moe`` too), with
  the same ``param_count()`` and ``active_param_count()``, and
  ``reduced()`` gives the reference's reduced config.
* Reduced ``mistral-nemo-12b`` (tokens), ``musicgen-large`` (``embeds``:
  frame embeddings, no table) and ``internvl2-2b`` (``tokens+vision``:
  patch embeddings ahead of the tokens), a softcap variant
  (``logits_softcap=30``) and variants whose query width is not d_model
  (``head_dim`` 8 and 32 at d_model 64): ``lm.forward`` and ``loss_fn``
  values and every gradient, ``lm.prefill`` + 4 ``lm.decode_step``s, and
  the paged serving steps, against ``repro.models.lm`` /
  ``repro.serving.model`` with parameters from ``repro.models.lm.init``.

Tolerance: rtol = atol = 2e-4, the other parity tests' (the same float32
arithmetic in another summation order).  The compiled paths
(``sma_jit(lm.forward)`` with a vision prefix, the engine on ``embeds``)
equal their direct paths bit for bit.
"""
import dataclasses
import functools

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
from repro_torch import convert, sma_jit
from repro_torch.configs import REGISTRY, get_config, reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.serving import (CacheConfig, PagedKVCache, Request,
                                 SchedulerConfig, ServeEngine)
from repro_torch.serving import model as tmodel
from repro_torch.tree import leaves

TOL = dict(rtol=2e-4, atol=2e-4)
PORTED = ("stablelm-1.6b", "mistral-nemo-12b", "deepseek-67b",
          "deepseek-coder-33b", "musicgen-large", "internvl2-2b",
          "recurrentgemma-2b", "xlstm-1.3b", "qwen3-moe-30b-a3b",
          "dbrx-132b")
NEMO, MUSICGEN, INTERNVL = "mistral-nemo-12b", "musicgen-large", \
    "internvl2-2b"
#: (arch, fields replaced in both packages' reduced config)
VARIANTS = {
    "nemo": (NEMO, {}),
    "musicgen": (MUSICGEN, {}),
    "internvl": (INTERNVL, {}),
    "softcap": (NEMO, {"logits_softcap": 30.0}),
    "hd8": (NEMO, {"head_dim": 8}),
    "hd32": (NEMO, {"head_dim": 32}),
}


def _fields(cfg: ModelConfig):
    return [f.name for f in dataclasses.fields(cfg)]


def _value(cfg, name):
    """A field's value; an ``MoEConfig`` as the dict of its fields (the
    two packages' classes never compare equal)."""
    v = getattr(cfg, name)
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


def test_every_config_is_registered():
    assert sorted(REGISTRY) == sorted(PORTED) == sorted(C.ARCH_IDS)


@pytest.mark.parametrize("arch", PORTED)
def test_config_equals_the_reference(arch):
    tc, jc = get_config(arch), C.get_config(arch)
    for name in _fields(tc):
        assert _value(tc, name) == _value(jc, name), name
    assert set(_fields(tc)) <= set(_fields(jc))
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()
    assert tc.resolved_head_dim == jc.resolved_head_dim
    assert tc.num_layers == jc.num_layers


@pytest.mark.parametrize("arch", PORTED)
@pytest.mark.parametrize("seq_len", [64, 40])
def test_reduced_equals_the_reference(arch, seq_len):
    tc = reduced(get_config(arch), seq_len=seq_len)
    jc = C.reduced(C.get_config(arch), seq_len=seq_len)
    for name in _fields(tc):
        assert _value(tc, name) == _value(jc, name), name
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()


def test_nemo_full_width_sizes():
    """The shapes the card path runs: q width 4096 against d_model 5120,
    GQA 4 query heads a KV head at head_dim 128, 12.25 B parameters."""
    cfg = get_config(NEMO)
    assert cfg.num_heads * cfg.resolved_head_dim == 4096 != cfg.d_model
    assert cfg.num_heads // cfg.num_kv_heads == 4
    assert cfg.param_count() == 12_247_777_280
    assert lm.padded_vocab(cfg) == 131072


def test_qwen3_full_width_sizes():
    """The shapes the card serves: 128 experts of 768, top 8, 32 query
    heads on 4 KV heads of 128; 30.53 B parameters (3.35 B active), 61.06
    GB in bf16; the vocabulary padded to 152,064."""
    cfg = get_config("qwen3-moe-30b-a3b")
    assert (cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.d_ff_expert) \
        == (128, 8, 768)
    assert cfg.num_heads * cfg.resolved_head_dim == 4096 != cfg.d_model
    assert cfg.param_count() == 30_532_108_288
    assert cfg.active_param_count() == 3_353_018_368
    assert lm.padded_vocab(cfg) == 152_064


@functools.lru_cache(maxsize=None)
def models(name):
    arch, repl = VARIANTS[name]
    jcfg = dataclasses.replace(C.reduced(C.get_config(arch)), **repl)
    tcfg = dataclasses.replace(reduced(get_config(arch)), **repl)
    jparams = jlm.init(jax.random.PRNGKey(0), jcfg)[0]
    return jcfg, jparams, tcfg, jax.tree.map(np.asarray, jparams)


def _port(np_tree, tcfg, grad=False):
    params = convert.from_jax_params(np_tree, tcfg, device="cpu")
    for p in leaves(params):
        p.requires_grad_(grad)
    return params


def _inputs(cfg, b=2, s=12, seed=0, labels=True):
    """A batch in the config's input mode (numpy), with labels over every
    position the logits cover (the vision prefix ignored)."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.input_mode == "embeds":
        out["embeds"] = rng.standard_normal((b, s, cfg.d_model)) \
            .astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)) \
            .astype(np.int32)
    sv = cfg.num_vision_tokens if cfg.input_mode == "tokens+vision" else 0
    if sv:
        out["vision_embeds"] = rng.standard_normal(
            (b, sv, cfg.d_model)).astype(np.float32)
    if labels:
        lab = rng.integers(0, cfg.vocab_size, (b, sv + s)).astype(np.int32)
        lab[:, :sv] = -1
        lab[0, sv:sv + 3] = -1
        out["labels"] = lab
    return out


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_forward_matches_jax(name):
    jcfg, jparams, tcfg, np_tree = models(name)
    jb, tb = _both(_inputs(tcfg))
    want, _ = jlm.forward(jparams, jcfg, Runtime(), jb)
    with torch.no_grad():
        got = lm.forward(_port(np_tree, tcfg), tcfg, tb)
    assert got.shape == want.shape
    close(got, want)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_loss_and_gradients_match_jax(name):
    jcfg, jparams, tcfg, np_tree = models(name)
    jb, tb = _both(_inputs(tcfg, seed=1))
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jcfg, Runtime(), jb), has_aux=True)(jparams)
    params = _port(np_tree, tcfg, grad=True)
    loss, metrics = lm.loss_fn(params, tcfg, tb)
    grads = torch.autograd.grad(loss, leaves(params))
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    for key in ("ce_loss", "loss", "accuracy"):
        np.testing.assert_allclose(metrics[key].item(), float(jm[key]),
                                   **TOL)
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(grads)
    for g, w in zip(grads, jleaves):
        assert g.shape == w.shape
        close(g, w)


def test_softcap_changes_the_loss():
    """The softcap is applied: at c = 30 (above the reduced model's
    logits) the loss moves a little from the uncapped one, at c = 0.5 a
    lot."""
    _, _, tcfg, np_tree = models("softcap")
    params = _port(np_tree, tcfg)
    tb = _both(_inputs(tcfg, seed=1))[1]
    with torch.no_grad():
        capped = lm.loss_fn(params, tcfg, tb)[0]
        plain = lm.loss_fn(params, dataclasses.replace(
            tcfg, logits_softcap=None), tb)[0]
        tight = lm.loss_fn(params, dataclasses.replace(
            tcfg, logits_softcap=0.5), tb)[0]
    assert capped.item() != plain.item()
    np.testing.assert_allclose(capped.item(), plain.item(), rtol=1e-2)
    assert abs(tight.item() - plain.item()) > 10 * abs(capped.item()
                                                       - plain.item())


def test_embeds_mode_has_no_table():
    jcfg, jparams, tcfg, np_tree = models("musicgen")
    assert "embed" not in jparams
    params = lm.init(tcfg, seed=0, device="cpu")
    assert "embed" not in params
    assert sorted(params) == sorted(_port(np_tree, tcfg))
    assert "embed" in lm.init(models("internvl")[2], seed=0, device="cpu")


def _state_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in w:
            close(g[k], w[k])


@pytest.mark.parametrize("name", ["hd8", "hd32", "musicgen", "internvl"])
def test_prefill_and_decode_steps_match_jax(name):
    """``lm.prefill`` (a vision prefix included, for internvl) then 4
    ``lm.decode_step``s: logits, every cache leaf and cache_len."""
    jcfg, jparams, tcfg, np_tree = models(name)
    tparams = _port(np_tree, tcfg)
    batch = _inputs(tcfg, s=10, labels=False)
    cache = 32
    jb, tb = _both(batch)
    with repro.options(backend="interpret"):
        jl, jst, jcl = jlm.prefill(jparams, jcfg, Runtime(), jb,
                                   cache_size=cache)
        tl, tst, tcl = lm.prefill(tparams, tcfg, tb, cache_size=cache)
        close(tl, jl)
        _state_close(tst, jst)
        np.testing.assert_array_equal(tcl.numpy(), np.asarray(jcl))
        for i in range(4):
            step = _inputs(tcfg, s=1, seed=10 + i, labels=False)
            step.pop("vision_embeds", None)
            jb, tb = _both(step)
            jl, jst, jcl = jlm.decode_step(jparams, jst, jcl, jcfg,
                                           Runtime(), jb)
            tl, tst, tcl = lm.decode_step(tparams, tst, tcl, tcfg, tb)
            close(tl, jl)
            _state_close(tst, jst)
            np.testing.assert_array_equal(tcl.numpy(), np.asarray(jcl))


@pytest.mark.parametrize("name", ["hd8", "hd32", "musicgen", "internvl"])
def test_paged_steps_match_jax(name):
    """A ragged prefill chunk then 3 decode steps through the paged steps:
    logits and the pools' real blocks (musicgen on ``embeds``, internvl
    served as tokens, as the reference serves it)."""
    jcfg, jparams, tcfg, np_tree = models(name)
    tparams = _port(np_tree, tcfg)
    cc = CacheConfig(block_size=4, num_blocks=32, max_seq_len=64)
    b, c = 3, 8
    kv = PagedKVCache(cc, b)
    for r, n in enumerate((7, 5, 8)):
        assert kv.admit(r, n, 3)
    table = kv.table_rows([0, 1, 2])
    n_tok = np.array([7, 5, 8], np.int32)
    rt = Runtime()
    jstate = jmodel.init_state(jcfg, b, jkv.CacheConfig(4, 32, 64))
    tstate = tmodel.init_state(tcfg, b, cc, device="cpu")

    def inputs(s, seed):
        batch = _inputs(tcfg, b=b, s=s, seed=seed, labels=False)
        batch.pop("vision_embeds", None)
        return _both(batch)

    def check(jl, tl):
        close(tl, jl)
        for k in ("k", "v"):
            close(tstate[0][k][:, :cc.num_blocks], jstate[0][k])

    with repro.options(backend="interpret"):
        jb, tb = inputs(c, 0)
        jl, jstate, jlen = jmodel.paged_prefill_step(
            jparams, jstate, jnp.asarray(table), jnp.zeros((b,), jnp.int32),
            jnp.asarray(n_tok), jcfg, rt, jb)
        tl, tstate, tlen = tmodel.paged_prefill_step(
            tparams, tstate, torch.from_numpy(table),
            torch.zeros(b, dtype=torch.int32), torch.from_numpy(n_tok), tcfg,
            tb)
        check(jl, tl)
        for i in range(3):
            jb, tb = inputs(1, 20 + i)
            jl, jstate, jlen = jmodel.paged_decode_step(
                jparams, jstate, jnp.asarray(table), jlen, jcfg, rt, jb)
            tl, tstate, tlen = tmodel.paged_decode_step(
                tparams, tstate, torch.from_numpy(table), tlen, tcfg, tb)
            check(jl, tl)
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))


@pytest.mark.parametrize("with_table", [False, True])
def test_token_embeds_match_jax(with_table):
    name = "internvl" if with_table else "musicgen"
    jcfg, jparams, tcfg, np_tree = models(name)
    high = tcfg.vocab_size if with_table else 300     # ids past d_model
    toks = np.random.default_rng(4).integers(0, high, (3, 5)) \
        .astype(np.int32)
    want = jmodel.token_embeds(jparams, jcfg, jnp.asarray(toks))
    got = tmodel.token_embeds(_port(np_tree, tcfg), tcfg,
                              torch.from_numpy(toks))
    assert got.dtype == tcfg.activation_dtype
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_compiled_forward_with_a_vision_prefix_equals_direct():
    _, _, tcfg, np_tree = models("internvl")
    params = _port(np_tree, tcfg)
    tb = _both(_inputs(tcfg, labels=False))[1]
    eng = sma_jit(functools.partial(lm.forward, cfg=tcfg))
    with torch.no_grad():
        got = eng(params, batch=tb)
        want = lm.forward(params, tcfg, tb)
    assert got.shape[1] == tcfg.num_vision_tokens + 12
    assert torch.equal(got, want)
    assert eng.stats.misses == 1


def test_engine_on_embeds_equals_direct_steps():
    """musicgen through the compiled engine: every tick's logits equal the
    direct paged steps' on the same inputs, and requests finish."""
    _, _, tcfg, np_tree = models("musicgen")
    params = _port(np_tree, tcfg)
    eng = ServeEngine(tcfg, params, device="cpu", max_batch=2,
                      cache=CacheConfig(block_size=4, num_blocks=24,
                                        max_seq_len=32),
                      sched=SchedulerConfig(prefill_chunk=8))
    seen = []
    for phase, direct in (("prefill", tmodel.paged_prefill_step),
                          ("decode", tmodel.paged_decode_step)):
        compiled = eng.engines[phase]

        def run(*args, compiled=compiled, direct=direct):
            saved = [{k: v.clone() for k, v in e.items()} for e in args[1]]
            out = compiled(*args)
            want = direct(args[0], saved, *args[2:-1], tcfg, args[-1])
            seen.append(torch.equal(out[0], want[0]) and all(
                torch.equal(args[1][p][k][:, :-1], saved[p][k][:, :-1])
                for p in range(len(saved)) for k in saved[p]))
            assert "embeds" in args[-1]
            return out
        eng.engines[phase] = run
    rng = np.random.default_rng(2)
    reqs = [Request(rid=i, prompt=rng.integers(0, 2048, (n,))
                    .astype(np.int32), max_new_tokens=3)
            for i, n in enumerate((6, 11))]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.status == "done" and len(r.out_tokens) == 3 for r in reqs)
    assert seen and all(seen)
