"""repro_torch's train path against repro's, on the CPU.

The JAX reference step is built from its parts -- ``jax.value_and_grad(
lm.loss_fn)`` and ``adamw.update`` -- since ``repro.launch.train`` builds
its step on ``sma_jit``, whose compiler does not import on this JAX
version.  On the CPU the JAX attention site resolves to the XLA backend's
chunked online softmax (the Pallas flash kernel has no gradient), and the
port's kernel sites run their plain versions inside the same
``torch.autograd.Function``s the card uses.  Parameters come from
``repro.models.lm.init`` as float32 masters; the reduced config computes
in float32.

Tolerances: logits, loss and gradients 2e-4 (rtol = atol; the same f32
arithmetic in another summation order); the optimizer 1e-6 (elementwise
f32 in the same order); five training steps 1e-4 relative on the loss.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as C
from repro.data import pipeline as jpipe
from repro.models import lm as jlm
from repro.models.layers import Runtime
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import ops
from repro_torch.launch.train import TrainLoopConfig, train
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.tree import leaves, tree_map

ARCH = "stablelm-1.6b"
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def models():
    """(JAX cfg, JAX f32 params, port cfg, numpy leaves of the params)."""
    jcfg = C.reduced(C.get_config(ARCH))
    jparams = jlm.init(jax.random.PRNGKey(0), jcfg)[0]
    return jcfg, jparams, reduced(get_config(ARCH)), \
        jax.tree.map(np.asarray, jparams)


def _port_params(np_tree, tcfg, grad=False):
    params = convert.from_jax_params(np_tree, tcfg, device="cpu",
                                     dtype=tcfg.parameter_dtype)
    for p in leaves(params):
        p.requires_grad_(grad)
    return params


def _batch(cfg, seq_len=24, batch=2, step=0, seed=3):
    b = jpipe.make_batch(jpipe.DataConfig(cfg.vocab_size, seq_len, batch,
                                          seed=seed), step)
    b["labels"][0, :5] = -1          # ignored positions
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def test_config_parameter_dtype_mirrors_jax():
    for jc, tc in ((C.get_config(ARCH), get_config(ARCH)),
                   (C.reduced(C.get_config(ARCH)), reduced(get_config(ARCH)))):
        assert jc.param_dtype == tc.param_dtype == "float32"
        assert tc.parameter_dtype == torch.float32


@pytest.mark.parametrize("remat", [False, True])
def test_forward_logits_match_jax(models, remat):
    jcfg, jparams, tcfg, np_tree = models
    jb, tb = _batch(tcfg)
    want, _ = jlm.forward(jparams, jcfg, Runtime(remat=remat), jb)
    with torch.no_grad():
        got = lm.forward(_port_params(np_tree, tcfg), tcfg, tb, remat=remat)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_gradients_match_jax(models, remat):
    """loss_fn's value, metrics and the gradient of every leaf, through
    the port's autograd Functions (remat reruns each group's forward in
    the backward) against jax.value_and_grad of repro's loss_fn."""
    jcfg, jparams, tcfg, np_tree = models
    jb, tb = _batch(tcfg)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jcfg, Runtime(remat=remat), jb),
        has_aux=True)(jparams)
    params = _port_params(np_tree, tcfg, grad=True)
    loss, metrics = lm.loss_fn(params, tcfg, tb, remat=remat)
    grads = torch.autograd.grad(loss, leaves(params))
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    for name in ("ce_loss", "loss", "accuracy"):
        np.testing.assert_allclose(metrics[name].item(), float(jm[name]),
                                   **TOL)
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(grads)
    for g, w in zip(grads, jleaves):
        assert g.shape == w.shape
        assert g.abs().sum() > 0          # every weight gets a gradient
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_loss_goes_through_the_kernel_functions(models, monkeypatch):
    """Every projection, the head and every attention of the train step go
    through the autograd Functions (on the card their forward and backward
    are kernel launches); nothing is routed."""
    _, _, tcfg, np_tree = models
    seen = []
    for name in ("SmaGemm", "RmsnormGemm", "FlashAttention"):
        fn = getattr(ops._autograd, name)
        orig = fn.apply

        def spy(*args, _orig=orig, _name=name):
            seen.append(_name)
            return _orig(*args)
        monkeypatch.setattr(fn, "apply", spy)
    ops.reset_counts()
    loss, _ = lm.loss_fn(_port_params(np_tree, tcfg, grad=True), tcfg,
                         _batch(tcfg)[1])
    loss.backward()
    layers = tcfg.num_layers
    assert seen.count("SmaGemm") == 7 * layers
    assert seen.count("FlashAttention") == layers
    assert seen.count("RmsnormGemm") == 1
    assert not ops.ROUTED
    assert sum(ops.launch_counts().values()) == 0   # CPU: plain versions


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_at_matches_jax(schedule):
    jc = jadamw.AdamWConfig(peak_lr=3e-3, warmup_steps=7, total_steps=50,
                            schedule=schedule)
    tc = adamw.AdamWConfig(peak_lr=3e-3, warmup_steps=7, total_steps=50,
                           schedule=schedule)
    for step in (0, 1, 6, 7, 8, 30, 50, 60):
        want = jadamw.lr_at(jc, jnp.asarray(step, jnp.int32))
        got = adamw.lr_at(tc, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("clip_norm", [1.0, 100.0, None])
def test_adamw_update_matches_jax(clip_norm):
    """Three steps on a random tree, clipping active (1.0), inactive
    (100.0) and off: parameters, moments, step and metrics."""
    rng = np.random.default_rng(13)
    tree = {"a": rng.standard_normal((5, 3), np.float32),
            "b": (rng.standard_normal((4,), np.float32),
                  {"c": rng.standard_normal((2, 2, 3), np.float32)})}
    kw = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10,
              clip_norm=clip_norm)
    jc, tc = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = tree_map(torch.from_numpy, jax.tree.map(np.copy, tree))
    js, ts = jadamw.init(jp), adamw.init(tp)
    for i in range(3):
        grads = jax.tree.map(
            lambda x: rng.standard_normal(x.shape, np.float32), tree)
        jp, js, jm = jadamw.update(jax.tree.map(jnp.asarray, grads), js, jp,
                                   jc)
        tp, ts, tm = adamw.update(tree_map(torch.from_numpy, grads), ts, tp,
                                  tc)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(tm[key].item(), float(jm[key]),
                                       rtol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 3
    for t, j in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
        for got, want in zip(leaves(t), jax.tree.leaves(j)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("vocab,seq,batch,seed", [
    (256, 32, 2, 0), (100352, 64, 3, 1234), (50, 7, 5, 9)])
def test_make_batch_is_bit_identical(vocab, seq, batch, seed):
    jc = jpipe.DataConfig(vocab, seq, batch, seed=seed)
    tc = tpipe.DataConfig(vocab, seq, batch, seed=seed)
    for step in (0, 1, 17):
        want, got = jpipe.make_batch(jc, step), tpipe.make_batch(tc, step)
        assert sorted(got) == ["labels", "tokens"]
        for key in got:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
    pipe = tpipe.DataPipeline(tc, device="cpu")
    first = next(pipe)
    assert pipe.state.next_step == 1
    np.testing.assert_array_equal(first["tokens"].numpy(),
                                  jpipe.make_batch(jc, 0)["tokens"])


def _jax_train_losses(jcfg, jparams, loop):
    """The JAX loop: value_and_grad(lm.loss_fn) + adamw.update on the JAX
    pipeline's batches, with train()'s schedule wiring."""
    ocfg = jadamw.AdamWConfig(peak_lr=loop.peak_lr,
                              warmup_steps=max(loop.steps // 10, 1),
                              total_steps=loop.steps)
    rt = Runtime(remat=loop.remat)

    @jax.jit
    def step(params, opt, batch):
        (loss, _), grads = jax.value_and_grad(
            lambda p: jlm.loss_fn(p, jcfg, rt, batch), has_aux=True)(params)
        params, opt, om = jadamw.update(grads, opt, params, ocfg)
        return params, opt, loss, om["grad_norm"]

    pipe = jpipe.DataPipeline(jpipe.DataConfig(
        vocab_size=jcfg.vocab_size, seq_len=loop.seq_len,
        global_batch=loop.global_batch, seed=loop.seed))
    opt = jadamw.init(jparams)
    losses, norms = [], []
    params = jparams
    for _ in range(loop.steps):
        params, opt, loss, gnorm = step(params, opt, next(pipe))
        losses.append(float(loss))
        norms.append(float(gnorm))
    return losses, norms, params


def test_train_matches_jax_loop(models):
    """Five reduced steps of train() against the JAX loop from the same
    f32 masters: every step's loss and grad norm within 1e-4 relative,
    and the final parameters within 2e-4."""
    jcfg, jparams, tcfg, np_tree = models
    loop = TrainLoopConfig(steps=5, seq_len=32, global_batch=2, log_every=1,
                           seed=0, peak_lr=3e-3, remat=True)
    want_loss, want_norm, want_params = _jax_train_losses(jcfg, jparams,
                                                          loop)
    out = train(tcfg, loop, device="cpu",
                params=_port_params(np_tree, tcfg))
    hist = out["history"]
    assert [h["step"] for h in hist] == [1, 2, 3, 4, 5]
    np.testing.assert_allclose([h["loss"] for h in hist], want_loss,
                               rtol=1e-4)
    np.testing.assert_allclose([h["grad_norm"] for h in hist], want_norm,
                               rtol=1e-4)
    assert want_loss[-1] < want_loss[0]
    for got, want in zip(leaves(out["params"]),
                         jax.tree.leaves(want_params)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TOL)


def test_train_needs_a_card_unless_asked(monkeypatch):
    """Without a card, train() and the pipeline raise instead of running
    on the CPU, unless the caller passes device='cpu'."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config(ARCH))
    loop = TrainLoopConfig(steps=1, seq_len=8, global_batch=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(cfg, loop)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpipe.DataPipeline(tpipe.DataConfig(256, 8, 1))
    hist = train(cfg, loop, device="cpu")["history"]
    assert np.isfinite(hist[0]["loss"])


def test_init_holds_masters_in_the_dtype_asked():
    cfg = reduced(get_config(ARCH))
    bf = dict(cfg.__dict__, name="bf16", dtype="bfloat16")
    cfg16 = type(cfg)(**bf)
    serving = lm.init(cfg16, device="cpu")
    masters = lm.init(cfg16, device="cpu", dtype=cfg16.parameter_dtype)
    assert serving["head"]["w"].dtype == torch.bfloat16
    assert masters["head"]["w"].dtype == torch.float32
    assert masters["blocks"][0]["norm1"]["scale"].dtype == torch.float32
    torch.testing.assert_close(serving["head"]["w"],
                               masters["head"]["w"].to(torch.bfloat16))
