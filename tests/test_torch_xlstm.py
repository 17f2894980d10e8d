"""repro_torch's xLSTM serving path against repro's, on the CPU.

The port's kernel sites run their plain versions here (CPU tensors).  The
JAX side runs under ``repro.options(backend="interpret")``: its
``lm.forward`` reaches the Pallas mLSTM kernel under the interpreter
(asserted with ``repro.backends.registry.record_sites``), and its
``lm.prefill``, whose sites must return the state, the reference's XLA
chunkwise path (``repro.backends.xla_backend.mlstm_chunkwise``), as the
JAX package routes them.  Inputs and parameters are made with numpy seeds
or by ``repro.models.lm.init`` and handed to both packages.

Tolerances: the chunkwise mLSTM against the Pallas kernel at
``tests/test_kernels.py``'s ``tol_for`` (3e-2 for bf16, one rounding flip
of an output; 2e-4 for f32); its state, the blocks, logits and state
leaves at rtol = atol = 2e-4 (the same float32 arithmetic in another
summation order).
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
from repro.backends import xla_backend
from repro.backends.registry import record_sites
from repro.kernels import ref as jref
from repro.kernels.mlstm import mlstm_chunkwise as j_mlstm_chunkwise
from repro.models import lm as jlm
from repro.models import recurrent as jrec
from repro.models.layers import Runtime
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops, ref
from repro_torch.models import lm, recurrent
from repro_torch.tree import leaves

TOL = dict(rtol=2e-4, atol=2e-4)
XL = "xlstm-1.3b"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
#: tests/test_kernels.py's mLSTM kernel shapes: (B, H, S, D, chunk).
KERNEL_SHAPES = [(1, 2, 128, 32, 32), (2, 1, 96, 64, 32),
                 (1, 1, 100, 32, 64)]   # the last one pads


def tol_for(dtype: str) -> float:
    return 3e-2 if dtype == "bfloat16" else 2e-4


def close(got: torch.Tensor, want, **tol) -> None:
    np.testing.assert_allclose(got.float().numpy(), np.float32(want),
                               **(tol or TOL))


@functools.lru_cache(maxsize=None)
def models():
    """(JAX cfg, JAX f32 params, port cfg, port params) of reduced
    xlstm-1.3b (2 groups of 7 mLSTM + 1 sLSTM, d_model 64, 4 heads, chunk
    16); built once."""
    jcfg = C.reduced(C.get_config(XL))
    jparams = jlm.init(jax.random.PRNGKey(0), jcfg)[0]
    tcfg = reduced(get_config(XL))
    tparams = convert.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def tokens(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, shape) \
        .astype(np.int32)


def mlstm_inputs(b, h, s, d, seed):
    """q, k, v unit normals; log_f = log_sigmoid(N + 2), log_i = 0.5 N, as
    the reference's kernel test draws them (float32 numpy)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32)
               for _ in range(3))
    lf = -np.logaddexp(0.0, -(rng.standard_normal((b, h, s)) + 2.0))
    li = rng.standard_normal((b, h, s)) * 0.5
    return q, k, v, lf.astype(np.float32), li.astype(np.float32)


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("seq_len", [64, 128])
def test_configs_mirror_jax(seq_len):
    full_j, full_t = C.get_config(XL), get_config(XL)
    for jc, tc in ((full_j, full_t),
                   (C.reduced(full_j, seq_len=seq_len),
                    reduced(full_t, seq_len=seq_len))):
        for field in ("name", "family", "block_pattern", "num_groups",
                      "d_model", "num_heads", "num_kv_heads", "d_ff",
                      "vocab_size", "mlstm_proj_factor", "mlstm_chunk",
                      "dtype", "param_dtype", "source"):
            assert getattr(jc, field) == getattr(tc, field), field
    assert reduced(full_t).mlstm_chunk == 16


def test_full_width_parameter_count():
    """The repo's xlstm-1.3b has 3.575 B parameters (the JAX package's
    ``lm.init`` traced abstractly): 48 layers of d_model 2048, 4 heads, so
    the mLSTM head dim is 1024, and a vocab of 50304 padded to 50432."""
    jcfg = C.get_config(XL)
    shapes = jax.eval_shape(
        lambda k: jlm.init(k, jcfg)[0], jax.random.PRNGKey(0))
    n = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert round(n / 1e9, 3) == 3.575
    tcfg = get_config(XL)
    assert recurrent._mlstm_dims(tcfg) == (4096, 1024)
    assert lm.padded_vocab(tcfg) == 50432


# -------------------------------------------------------------- the kernel
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,h,s,d,chunk", KERNEL_SHAPES)
def test_mlstm_chunkwise_matches_pallas_interpret(b, h, s, d, chunk, dtype):
    """The port's entry (plain version on the CPU) against the Pallas
    kernel under the interpreter, at ``tests/test_kernels.py``'s shapes:
    h in q's dtype, including a ragged S padded to the chunk."""
    jdt, tdt = DTYPES[dtype]
    ins = mlstm_inputs(b, h, s, d, s + d)
    want = j_mlstm_chunkwise(*(jnp.asarray(x, jdt) for x in ins),
                             chunk=chunk, interpret=True)
    ops.reset_counts()
    got = ops.mlstm_chunkwise(*(torch.from_numpy(x).to(tdt) for x in ins),
                              chunk=chunk)
    assert got.dtype == tdt and tuple(got.shape) == (b, h, s, d)
    assert ops.launch_counts()["mlstm_chunkwise"] == 0  # CPU: plain version
    tol = tol_for(dtype)
    close(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("b,h,s,d,chunk", KERNEL_SHAPES)
def test_mlstm_state_matches_xla_backend(b, h, s, d, chunk):
    """With ``return_state`` the plain version's h and final (C, n, m), in
    float32, against the reference's XLA chunkwise path (f32)."""
    ins = mlstm_inputs(b, h, s, d, 7 * s + d)
    want, want_state = xla_backend.mlstm_chunkwise(
        *(jnp.asarray(x) for x in ins), chunk=chunk, return_state=True)
    got, got_state = ops.mlstm_chunkwise(
        *(torch.from_numpy(x) for x in ins), chunk=chunk, return_state=True)
    close(got, want)
    for g, w, shape in zip(got_state, want_state,
                           ((b, h, d, d), (b, h, d), (b, h))):
        assert g.dtype == torch.float32 and tuple(g.shape) == shape
        close(g, w)


@pytest.mark.parametrize("chunk", [1, 5, 16, 64])
def test_mlstm_chunks_agree_with_the_sequential_oracle(chunk):
    """Chunk invariance: at any chunk (one step, one that does not divide
    S, one larger than S) h equals the port's sequential oracle, and the
    final state is the same as at chunk 16."""
    ins = [torch.from_numpy(x) for x in mlstm_inputs(2, 2, 37, 8, chunk)]
    want = ref.mlstm_ref(*ins)
    got, state = ref.mlstm_chunkwise_ref(*ins, chunk=chunk,
                                         return_state=True)
    close(got, want.numpy())
    _, base = ref.mlstm_chunkwise_ref(*ins, chunk=16, return_state=True)
    for g, w in zip(state, base):
        close(g, w.numpy())


def test_mlstm_sequential_oracle_matches_jax():
    """The port's sequential oracle against ``repro.kernels.ref.mlstm_ref``
    (f32)."""
    ins = mlstm_inputs(1, 2, 40, 16, 3)
    want = jref.mlstm_ref(*(jnp.asarray(x) for x in ins))
    close(ref.mlstm_ref(*(torch.from_numpy(x) for x in ins)), want)


# ------------------------------------------------------------- the blocks
def _block_inputs(kind: str, jcfg, seed=4):
    key = jax.random.PRNGKey(seed)
    init = jrec.mlstm_block_init if kind == "mlstm" else jrec.slstm_block_init
    jp = init(key, jcfg)[0]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 40, jcfg.d_model)).astype(np.float32)
    zero = jax.tree.map(np.asarray, (
        jrec.mlstm_block_init_state if kind == "mlstm"
        else jrec.slstm_block_init_state)(jcfg, 2, jnp.float32))
    st = {k: (rng.standard_normal(v.shape) * 0.5).astype(np.float32)
          for k, v in zero.items()}
    if kind == "slstm":
        st["n"] = np.abs(st["n"]) + 0.5       # a normalizer is positive
    return jp, x, st


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("step", ["apply", "prefill", "decode"])
def test_xlstm_block_matches_jax(kind, step):
    """Each xLSTM block over a 40-token sequence (ragged against the chunk
    of 16), with its final state, and one decode step from a random state,
    against ``repro.models.recurrent`` (f32)."""
    jcfg, _, tcfg, _ = models()
    jp, x, st = _block_inputs(kind, jcfg)
    tp = convert.from_jax_params(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    fn = {"apply": "block_apply", "prefill": "block_prefill",
          "decode": "block_decode"}[step]
    jfn = getattr(jrec, f"{kind}_{fn}")
    tfn = getattr(recurrent, f"{kind}_{fn}")
    with repro.options(backend="interpret"):
        if step == "apply":
            close(tfn(tp, tx, tcfg), jfn(jp, jx, jcfg, Runtime()))
            return
        if step == "prefill":
            want, want_st = jfn(jp, jx, jcfg, Runtime())
            got, got_st = tfn(tp, tx, tcfg)
        else:
            want, want_st = jfn(jp, jx[:, :1], {k: jnp.asarray(v)
                                                for k, v in st.items()},
                                jcfg, Runtime())
            got, got_st = tfn(tp, tx[:, :1],
                              {k: torch.from_numpy(v) for k, v in st.items()},
                              tcfg)
    close(got, want)
    assert set(got_st) == set(want_st)
    for k in want_st:
        assert tuple(got_st[k].shape) == want_st[k].shape, k
        close(got_st[k], want_st[k])


# --------------------------------------------------------- the whole model
def test_forward_matches_jax_and_reaches_the_pallas_kernel():
    """``lm.forward`` of a 40-token prompt against the reference, whose
    every mLSTM site resolved to the Pallas kernel under the
    interpreter."""
    jcfg, jparams, tcfg, tparams = models()
    toks = tokens((2, 40), 5)
    with repro.options(backend="interpret"), record_sites() as sites:
        want, _ = jlm.forward(jparams, jcfg, Runtime(),
                              {"tokens": jnp.asarray(toks)})
    mlstm_sites = [x for x in sites if x["op"] == "mlstm_chunkwise"]
    assert len(mlstm_sites) >= 1
    assert all(x["backend"] == "interpret" for x in mlstm_sites), mlstm_sites
    with torch.no_grad():
        got = lm.forward(tparams, tcfg, {"tokens": torch.from_numpy(toks)})
    assert got.shape == want.shape
    close(got, want)


def _state_close(got, want) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert tuple(g[k].shape) == tuple(w[k].shape), k
            close(g[k], w[k])


@pytest.mark.parametrize("s", [32, 40, 64])
def test_prefill_and_decode_steps_match_jax(s):
    """``lm.prefill`` of an s-token prompt (40 is ragged against the chunk
    of 16), then 4 ``lm.decode_step``s: logits, every state leaf and
    cache_len after each call."""
    jcfg, jparams, tcfg, tparams = models()
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
        assert not ops.ROUTED
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


def test_decode_steps_follow_the_forward():
    """The port alone: a 40-token prefill then 4 decode steps give the
    logits ``lm.forward`` gives at those positions (the chunkwise state
    after a ragged prompt is the state after 40 steps)."""
    _, _, tcfg, tparams = models()
    toks = torch.from_numpy(tokens((2, 44), 9)).long()
    with torch.no_grad():
        want = lm.forward(tparams, tcfg, {"tokens": toks})
    logits, state, cl = lm.prefill(tparams, tcfg, {"tokens": toks[:, :40]},
                                   cache_size=48)
    close(logits, want[:, 39].numpy())
    for i in range(4):
        logits, state, cl = lm.decode_step(
            tparams, state, cl, tcfg, {"tokens": toks[:, 40 + i:41 + i]})
        close(logits, want[:, 40 + i].numpy())


def test_decode_from_the_jax_prefill_state():
    """The port's decode step started from the reference's prefill state
    (``convert.from_jax_state``) gives the reference's next logits and
    state."""
    jcfg, jparams, tcfg, tparams = models()
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


def _named(node, name=""):
    if isinstance(node, dict):
        return [x for k, v in node.items() for x in _named(v, k)]
    if isinstance(node, (tuple, list)):
        return [x for v in node for x in _named(v, name)]
    return [(name, node)]


@pytest.mark.parametrize("what", ["params", "state"])
def test_from_jax_round_trips(what):
    """JAX tree -> port -> numpy gives the JAX arrays back (f32), with the
    same structure; in bf16 the leaves the reference reads in float32 stay
    float32."""
    jcfg, jparams, tcfg, _ = models()
    if what == "params":
        tree = jax.tree.map(np.asarray, jparams)
        conv = functools.partial(convert.from_jax_params, tree, tcfg,
                                 device="cpu")
        f32 = {"scale", "b_if", "gn_scale", "r_gates"}
    else:
        tree = jax.tree.map(np.asarray, jlm.init_state(jcfg, 2, 48))
        tree = jax.tree.map(lambda z: np.random.default_rng(z.size)
                            .standard_normal(z.shape).astype(np.float32),
                            tree)
        conv = functools.partial(convert.from_jax_state, tree, tcfg,
                                 device="cpu")
        f32 = {"c", "n", "m", "h"}
    got = conv()
    assert jax.tree.structure(jax.tree.map(lambda t: 0, got)) \
        == jax.tree.structure(jax.tree.map(lambda t: 0, tree))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(g.numpy(), w)
    names = {name for name, _ in _named(got)}
    assert f32 <= names, f32 - names
    for name, t in _named(conv(dtype=torch.bfloat16)):
        assert t.dtype == (torch.float32 if name in f32
                           else torch.bfloat16), name


def test_init_state_mirrors_jax():
    """Shapes and dtypes of every leaf of ``lm.init_state``; the sLSTM's n
    starts at 1e-6, every other leaf at 0."""
    jcfg, _, tcfg, _ = models()
    want = jlm.init_state(jcfg, 3, 16)
    got = lm.init_state(tcfg, 3, 16, device="cpu")
    for g, w, btype in zip(got, want, tcfg.block_pattern):
        assert set(g) == set(w)
        for k in w:
            assert tuple(g[k].shape) == w[k].shape, (btype, k)
            assert str(g[k].dtype).split(".")[-1] == str(w[k].dtype)
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))


def test_port_init_draws_the_jax_tree():
    """``lm.init`` for xLSTM: the JAX tree's structure and shapes (an
    xLSTM block is norm1 + mixer), ``b_if`` = (0, linspace(3, 6)) in
    float32."""
    jcfg, jparams, tcfg, _ = models()
    got = lm.init(tcfg, seed=0, device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda t: 0, got)) \
        == jax.tree.structure(jax.tree.map(lambda t: 0, jparams))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(jparams)):
        assert tuple(g.shape) == w.shape
    b_if = got["blocks"][0]["mixer"]["b_if"]
    assert b_if.dtype == torch.float32
    np.testing.assert_allclose(
        b_if.numpy(), np.asarray(jparams["blocks"][0]["mixer"]["b_if"]),
        rtol=1e-6)


def test_prefill_and_decode_run_the_serving_dtype():
    """The reduced model in bf16 through a ragged prefill and two decode
    steps: finite logits of the padded vocabulary, state leaves in their
    dtypes (the recurrent states float32, conv tails bf16)."""
    tcfg = dataclasses.replace(reduced(get_config(XL)), dtype="bfloat16")
    params = lm.init(tcfg, seed=1, device="cpu")
    logits, state, cl = lm.prefill(
        params, tcfg, {"tokens": torch.from_numpy(tokens((2, 35), 8))},
        cache_size=40)
    for _ in range(2):
        logits, state, cl = lm.decode_step(
            params, state, cl, tcfg,
            {"tokens": logits.argmax(-1, keepdim=True)})
    assert logits.shape == (2, lm.padded_vocab(tcfg))
    assert torch.isfinite(logits.float()).all()
    assert cl.tolist() == [37, 37]
    for entry, btype in zip(state, tcfg.block_pattern):
        for k, t in entry.items():
            assert t.dtype == (torch.bfloat16 if k == "conv_tail"
                               else torch.float32), (btype, k)
    assert all(t.dtype in (torch.float32, torch.bfloat16)
               for t in leaves(params))
