"""repro_torch's recurrentgemma serving path against repro's, on the CPU.

The port's kernel sites run their plain versions here (CPU tensors).  The
JAX side runs under ``repro.options(backend="interpret")``, so its
``rglru_scan``, flash and decode-attention sites reach the Pallas kernels
under the interpreter, as the JAX package's own kernel tests run them.
Inputs and parameters are made with numpy seeds or by
``repro.models.lm.init`` and handed to both packages.

Tolerances: the scan against the Pallas kernel at ``tests/test_kernels.py``'s
``tol_for`` (3e-2 for bf16, one rounding flip of an output; 2e-4 for f32);
blocks, logits and state leaves at rtol = atol = 2e-4 (the same float32
arithmetic in another summation order, which moves the reduced model's
logits by about 1e-5).
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
from repro.kernels.rglru import rglru_scan as j_rglru_scan
from repro.models import lm as jlm
from repro.models import recurrent as jrec
from repro.models.layers import Runtime
from repro.serving import kv_cache as jkv
from repro.serving import model as jsmodel
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops, ref
from repro_torch.models import lm, recurrent
from repro_torch.serving import CacheConfig
from repro_torch.serving import model as smodel
from repro_torch.tree import leaves

TOL = dict(rtol=2e-4, atol=2e-4)
RG, SLM = "recurrentgemma-2b", "stablelm-1.6b"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol_for(dtype: str) -> float:
    return 3e-2 if dtype == "bfloat16" else 2e-4


def close(got: torch.Tensor, want, **tol) -> None:
    np.testing.assert_allclose(got.float().numpy(), np.float32(want),
                               **(tol or TOL))


@functools.lru_cache(maxsize=None)
def models(arch: str):
    """(JAX cfg, JAX f32 params, port cfg, port params) of the reduced
    model; built once per architecture."""
    jcfg = C.reduced(C.get_config(arch))
    jparams = jlm.init(jax.random.PRNGKey(0), jcfg)[0]
    tcfg = reduced(get_config(arch))
    tparams = convert.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def tokens(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, shape) \
        .astype(np.int32)


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("seq_len", [64, 128])
def test_configs_mirror_jax(seq_len):
    full_j, full_t = C.get_config(RG), get_config(RG)
    for jc, tc in ((full_j, full_t),
                   (C.reduced(full_j, seq_len=seq_len),
                    reduced(full_t, seq_len=seq_len))):
        for field in ("name", "block_pattern", "num_groups", "d_model",
                      "num_heads", "num_kv_heads", "resolved_head_dim",
                      "d_ff", "vocab_size", "window", "rope_theta", "dtype",
                      "param_dtype", "source"):
            assert getattr(jc, field) == getattr(tc, field), field
    assert reduced(full_t, seq_len=seq_len).window == seq_len // 2
    assert reduced(get_config(SLM)).window is None


# -------------------------------------------------------------- the kernel
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,s,d,bs,bd,h0", [
    (2, 128, 256, 64, 128, True),
    (1, 100, 96, 32, 64, False),    # padding both dims
    (1, 257, 130, 64, 128, True),   # awkward pads
])
def test_rglru_scan_matches_pallas_interpret(b, s, d, bs, bd, h0, dtype):
    """The port's entry (plain version on the CPU) against the Pallas
    kernel under the interpreter, at ``tests/test_kernels.py``'s shapes:
    h_seq and h_last, both in a's dtype."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(s + d)
    a = 1 / (1 + np.exp(-rng.standard_normal((b, s, d))))
    u = rng.standard_normal((b, s, d)) * 0.1
    h = rng.standard_normal((b, d)) if h0 else None
    ja, ju = jnp.asarray(a, jdt), jnp.asarray(u, jdt)
    jh = jnp.asarray(h, jdt) if h0 else None
    want_seq, want_last = j_rglru_scan(ja, ju, jh, block_s=bs, block_d=bd,
                                       interpret=True)
    ops.reset_counts()
    ta = torch.from_numpy(a).to(tdt)
    got_seq, got_last = ops.rglru_scan(
        ta, torch.from_numpy(u).to(tdt),
        torch.from_numpy(h).to(tdt) if h0 else None)
    assert got_seq.dtype == got_last.dtype == tdt
    assert ops.launch_counts()["rglru_scan"] == 0      # CPU: plain version
    tol = tol_for(dtype)
    close(got_seq, want_seq, rtol=tol, atol=tol)
    close(got_last, want_last, rtol=tol, atol=tol)


def test_rglru_scan_plain_version_is_a_sequential_f32_scan():
    """h_last is the final f32 carry rounded once to a's dtype, h0 = None
    is a zero carry, and on the CPU the plain version carries a gradient
    (the card has no backward kernel yet)."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 9, 5)).astype(np.float32))
    u = torch.from_numpy(rng.standard_normal((2, 9, 5)).astype(np.float32))
    h = torch.zeros(2, 5)
    for t in range(9):
        h = a[:, t] * h + u[:, t]
    seq, last = ref.rglru_scan_ref(a.bfloat16(), u.bfloat16())
    want = ref.rglru_scan_ref(a.bfloat16(), u.bfloat16(),
                              torch.zeros(2, 5, dtype=torch.bfloat16))
    assert torch.equal(seq, want[0]) and torch.equal(last, want[1])
    assert last.dtype == torch.bfloat16
    seq32, last32 = ref.rglru_scan_ref(a, u)
    assert torch.equal(last32, h) and torch.equal(seq32[:, -1], h)
    a.requires_grad_()
    ops.rglru_scan(a, u)[0].sum().backward()
    assert a.grad is not None and a.grad.abs().sum() > 0


# -------------------------------------------------------------- the block
def _block_inputs(jcfg, seed=4):
    key = jax.random.PRNGKey(seed)
    jp = jrec.rglru_block_init(key, jcfg)[0]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    st = {"h": rng.standard_normal((2, jcfg.d_model)).astype(np.float32),
          "conv_tail": rng.standard_normal((2, 3, jcfg.d_model))
          .astype(np.float32)}
    return jp, x, st


@pytest.mark.parametrize("step", ["apply", "decode"])
def test_rglru_block_matches_jax(step):
    """``rglru_block_apply`` over a sequence and ``rglru_block_decode`` from
    a random state, against ``repro.models.recurrent`` (f32)."""
    jcfg, _, tcfg, _ = models(RG)
    jp, x, st = _block_inputs(jcfg)
    tp = convert.from_jax_params(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    assert tp["lambda_raw"].dtype == torch.float32
    with repro.options(backend="interpret"):
        if step == "apply":
            want = jrec.rglru_block_apply(jp, jnp.asarray(x), jcfg,
                                          Runtime())
            got = recurrent.rglru_block_apply(tp, torch.from_numpy(x), tcfg)
            close(got, want)
            return
        x1 = jnp.asarray(x[:, :1])
        want, want_st = jrec.rglru_block_decode(
            jp, x1, {k: jnp.asarray(v) for k, v in st.items()}, jcfg,
            Runtime())
    got, got_st = recurrent.rglru_block_decode(
        tp, torch.from_numpy(x[:, :1]),
        {k: torch.from_numpy(v) for k, v in st.items()}, tcfg)
    close(got, want)
    for k in ("h", "conv_tail"):
        assert got_st[k].shape == want_st[k].shape, k
        close(got_st[k], want_st[k])


# --------------------------------------------------------- the whole model
@pytest.mark.parametrize("remat", [False, True])
def test_forward_matches_jax(remat):
    jcfg, jparams, tcfg, tparams = models(RG)
    toks = tokens((2, 40), 5)
    with repro.options(backend="interpret"):
        want, _ = jlm.forward(jparams, jcfg, Runtime(remat=remat),
                              {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got = lm.forward(tparams, tcfg, {"tokens": torch.from_numpy(toks)},
                         remat=remat)
    assert got.shape == want.shape
    close(got, want)


def _state_close(got, want) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert tuple(g[k].shape) == tuple(w[k].shape), k
            close(g[k], w[k])


@pytest.mark.parametrize("arch,s", [(RG, 32), (RG, 40), (RG, 64),
                                    (SLM, 32), (SLM, 40), (SLM, 64)])
def test_prefill_and_decode_steps_match_jax(arch, s):
    """``lm.prefill`` of an s-token prompt, then 4 ``lm.decode_step``s:
    logits, every state leaf and cache_len after each call.  With window
    32, s = 40 reproduces the reference's ring-buffer layout after a
    prompt longer than the window (ROADMAP.md, faults of the reference),
    and the port matches it."""
    jcfg, jparams, tcfg, tparams = models(arch)
    toks = tokens((2, s), s)
    cache = s + 8
    with repro.options(backend="interpret"):
        jl, jst, jcl = jlm.prefill(jparams, jcfg, Runtime(),
                                   {"tokens": jnp.asarray(toks)},
                                   cache_size=cache)
        ops.reset_counts()
        tl, tst, tcl = lm.prefill(tparams, tcfg,
                                  {"tokens": torch.from_numpy(toks)},
                                  cache_size=cache)
        assert sum(ops.launch_counts().values()) == 0  # CPU: plain versions
        close(tl, jl)
        _state_close(tst, jst)
        dec = jax.jit(functools.partial(jlm.decode_step, cfg=jcfg,
                                        rt=Runtime()))
        for i in range(4):
            nxt = tokens((2, 1), 100 + i)
            jl, jst, jcl = dec(jparams, jst, jcl,
                               batch={"tokens": jnp.asarray(nxt)})
            tl, tst, tcl = lm.decode_step(tparams, tst, tcl, tcfg,
                                          {"tokens": torch.from_numpy(nxt)})
            close(tl, jl)
            _state_close(tst, jst)
            np.testing.assert_array_equal(tcl.numpy(), np.asarray(jcl))


@pytest.mark.parametrize("s", [32, 40, 64])
def test_ring_slots_follow_the_reference(s):
    """The reference's windowed layers keep the prompt's last ``window``
    positions in order at prefill but write position p at slot p % window
    at decode: the two agree only for prompts a multiple of the window.
    The port keeps that arithmetic, so after a 40-token prompt (window 32)
    its decode steps leave ``lm.forward`` as the reference's do, and after
    32 or 64 tokens they follow it.  Prints the largest |logit error| per
    step."""
    _, _, tcfg, tparams = models(RG)
    toks = torch.from_numpy(tokens((2, s + 4), 200 + s)).long()
    with torch.no_grad():
        want = lm.forward(tparams, tcfg, {"tokens": toks})
    logits, state, cl = lm.prefill(tparams, tcfg, {"tokens": toks[:, :s]},
                                   cache_size=s + 8)
    errs = [(logits - want[:, s - 1]).abs().max().item()]
    for i in range(4):
        logits, state, cl = lm.decode_step(
            tparams, state, cl, tcfg, {"tokens": toks[:, s + i:s + i + 1]})
        errs.append((logits - want[:, s + i]).abs().max().item())
    print(f"prompt {s}, window {tcfg.window}: max |logit error| per step "
          f"{[float(f'{e:.2g}') for e in errs]}")
    if s % tcfg.window:
        assert errs[0] < 2e-4 and max(errs[1:]) > 0.1, errs
    else:
        assert max(errs) < 2e-4, errs


def test_decode_from_the_jax_prefill_state():
    """The port's decode step started from the reference's prefill state
    (``convert.from_jax_state``) gives the reference's next logits."""
    jcfg, jparams, tcfg, tparams = models(RG)
    toks = tokens((2, 40), 6)
    nxt = tokens((2, 1), 7)
    with repro.options(backend="interpret"):
        _, jst, jcl = jlm.prefill(jparams, jcfg, Runtime(),
                                  {"tokens": jnp.asarray(toks)},
                                  cache_size=48)
        tst = convert.from_jax_state(jax.tree.map(np.asarray, jst), tcfg,
                                     device="cpu")
        want, want_st, _ = jlm.decode_step(jparams, jst, jcl, jcfg, Runtime(),
                                           {"tokens": jnp.asarray(nxt)})
    got, got_st, _ = lm.decode_step(tparams, tst,
                                    torch.from_numpy(np.array(jcl)), tcfg,
                                    {"tokens": torch.from_numpy(nxt)})
    close(got, want)
    _state_close(got_st, want_st)


@pytest.mark.parametrize("what", ["params", "state"])
def test_from_jax_round_trips(what):
    """JAX tree -> port -> numpy gives the JAX arrays back (f32), with the
    same structure; in bf16 the float32 leaves stay float32."""
    jcfg, jparams, tcfg, _ = models(RG)
    if what == "params":
        tree = jax.tree.map(np.asarray, jparams)
        conv = functools.partial(convert.from_jax_params, tree, tcfg,
                                 device="cpu")
        f32 = {"scale", "lambda_raw"}
    else:
        tree = jax.tree.map(np.asarray, jlm.init_state(jcfg, 2, 48))
        tree = jax.tree.map(lambda z: np.random.default_rng(z.size)
                            .standard_normal(z.shape).astype(np.float32),
                            tree)
        conv = functools.partial(convert.from_jax_state, tree, tcfg,
                                 device="cpu")
        f32 = {"h"}
    got = conv()
    assert jax.tree.structure(jax.tree.map(lambda t: 0, got)) \
        == jax.tree.structure(jax.tree.map(lambda t: 0, tree))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(g.numpy(), w)
    half = conv(dtype=torch.bfloat16)

    def named(node, name=""):
        if isinstance(node, dict):
            return [x for k, v in node.items() for x in named(v, k)]
        if isinstance(node, (tuple, list)):
            return [x for v in node for x in named(v, name)]
        return [(name, node)]

    for name, t in named(half):
        assert t.dtype == (torch.float32 if name in f32
                           else torch.bfloat16), name


def test_init_state_mirrors_jax():
    """Shapes and dtypes of every leaf of ``lm.init_state`` (a ``local``
    layer holds min(window, cache_size) slots)."""
    for arch in (RG, SLM):
        jcfg, _, tcfg, _ = models(arch)
        for cache in (16, 48):
            want = jlm.init_state(jcfg, 3, cache)
            got = lm.init_state(tcfg, 3, cache, device="cpu")
            for g, w in zip(got, want):
                assert set(g) == set(w)
                for k in w:
                    assert tuple(g[k].shape) == w[k].shape, (arch, k)
                    assert str(g[k].dtype).split(".")[-1] == str(w[k].dtype)
                    assert not g[k].any()


def test_port_init_draws_the_jax_tree():
    """``lm.init`` for the recurrent model: the JAX tree's structure and
    shapes, ``lambda_raw`` in [0.744, 0.999) and float32."""
    jcfg, jparams, tcfg, _ = models(RG)
    got = lm.init(tcfg, seed=0, device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda t: 0, got)) \
        == jax.tree.structure(jax.tree.map(lambda t: 0, jparams))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(jparams)):
        assert tuple(g.shape) == w.shape
    lam = [b["mixer"]["lambda_raw"] for b in got["blocks"]
           if "lambda_raw" in b["mixer"]]
    assert len(lam) == 9
    for t in lam:
        assert t.dtype == torch.float32
        assert 0.744 <= t.min().item() and t.max().item() <= 0.999


def test_paged_serving_state_refuses_an_unknown_block_type():
    """The paged serving state takes the five block types and raises
    ``ValueError`` for any other, as ``repro.serving.model.init_state``
    does."""
    cfg = dataclasses.replace(reduced(get_config(RG)),
                              block_pattern=("rglru", "moe_ffn"))
    jcfg = dataclasses.replace(C.reduced(C.get_config(RG)),
                               block_pattern=("rglru", "moe_ffn"))
    with pytest.raises(ValueError, match="unknown block type moe_ffn"):
        smodel.init_state(cfg, 2, CacheConfig(block_size=4, num_blocks=8,
                                              max_seq_len=32), device="cpu")
    with pytest.raises(ValueError, match="unknown block type moe_ffn"):
        jsmodel.init_state(jcfg, 2, jkv.CacheConfig(4, 8, 32))


def test_prefill_and_decode_run_the_serving_dtype():
    """The reduced model in bf16 through prefill and two decode steps:
    finite logits of the padded vocabulary, state leaves in their dtypes
    (``h`` float32, the rest bf16)."""
    tcfg = dataclasses.replace(reduced(get_config(RG)), dtype="bfloat16")
    params = lm.init(tcfg, seed=1, device="cpu")
    logits, state, cl = lm.prefill(
        params, tcfg, {"tokens": torch.from_numpy(tokens((2, 32), 8))},
        cache_size=40)
    for _ in range(2):
        logits, state, cl = lm.decode_step(
            params, state, cl, tcfg,
            {"tokens": logits.argmax(-1, keepdim=True)})
    assert logits.shape == (2, lm.padded_vocab(tcfg))
    assert torch.isfinite(logits.float()).all()
    assert cl.tolist() == [34, 34]
    for entry, btype in zip(state, tcfg.block_pattern):
        for k, t in entry.items():
            assert t.dtype == (torch.float32 if k == "h"
                               else torch.bfloat16), (btype, k)
    assert all(t.dtype in (torch.float32, torch.bfloat16)
               for t in leaves(params))
