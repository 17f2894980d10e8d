"""``train()`` beyond the dense family, on the CPU, against the JAX loop.

Five steps of the port's ``train()`` (the step compiled by ``sma_jit``)
and of a loop of ``launch.train.direct_step`` run on each reduced family
-- the mixtures of experts (qwen3-moe-30b-a3b, dbrx-132b), the recurrent
models (recurrentgemma-2b: ``rglru`` and ``local``; xlstm-1.3b:
``mlstm`` and ``slstm``) and the input modes (musicgen-large on
``embeds``, internvl2-2b on ``tokens+vision``) -- from the JAX package's
f32 masters, against ``jax.value_and_grad(lm.loss_fn)`` + ``adamw.update``
fed the JAX pipeline's batches in the config's input mode.  The JAX
gradients come from its XLA paths (``assoc_rglru``, ``chunked_mha``, the
XLA chunkwise mLSTM).  The recurrent configs run one group of a shorter
pattern that keeps every block type, (rglru, rglru, local) and (mlstm,
slstm), to keep the trace short.

Tolerances: ``test_train_matches_jax_loop``'s -- every step's loss and
grad norm 1e-4 relative, the final parameters rtol = atol = 2e-4 -- with
two rules built in, for two findings of this slice.  (1) The reduced
xLSTM's gradient is ill-conditioned in f32 at its 8-block pattern: the
reference's own gradients move by up to 1.4e-4 of a leaf's largest when
every master moves by one ulp, and its five-step loss by more than 1e-4
(at the 2-block pattern run here its gradients move by 7.5e-6).  So the
losses and grad norms are held within max(1e-4, twice the reference's
own spread from masters moved by one f32 ulp at random), the rule the
card checks use against the direct step's own spread.  (2) A parameter
whose gradient sits at the noise floor at some step (at RecurrentGemma's
13-block pattern ~1e-8 against a leaf's largest of ~0.05, with opposite
signs in the two packages, whose gradients agree to ~4e-6 of a leaf's
largest: the XLA associative scan against the sequential one) gets an
AdamW update of about the rate either way.  So for RecurrentGemma at
most :data:`OFF_SHARE` of the parameter elements (or twice as many as
the reference's own one-ulp run puts off, where that is more) may miss
2e-4; every other family's parameters are all held within 2e-4.

Also: ``make_batch`` bit-identical to the reference's in the ``embeds``
and ``tokens+vision`` modes, and the joint graph's gradient nodes for an
MoE and for RecurrentGemma, one per kernel call of the direct step.
"""
import collections
import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as C
from repro.data import pipeline as jpipe
from repro.models import lm as jlm
from repro.models.layers import Runtime
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.compiler.lower import op_name
from repro_torch.compiler.trace import KERNEL_ENTRY_OPS
from repro_torch.configs import get_config, reduced
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import mlstm as kmlstm
from repro_torch.kernels import norm_gemm as knorm
from repro_torch.kernels import rglru as krglru
from repro_torch.kernels import sma_gemm as kgemm
from repro_torch.launch.train import (TrainLoopConfig, direct_step,
                                      make_step, train)
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.tree import leaves

TOL = dict(rtol=2e-4, atol=2e-4)
#: arch -> the fields its reduced config replaces here (both packages').
FAMILIES = {"qwen3-moe-30b-a3b": {}, "dbrx-132b": {},
            "recurrentgemma-2b": dict(block_pattern=("rglru", "rglru",
                                                     "local"), num_groups=1),
            "xlstm-1.3b": dict(block_pattern=("mlstm", "slstm"),
                               num_groups=1),
            "musicgen-large": {}, "internvl2-2b": {}}
LOOP = TrainLoopConfig(steps=5, seq_len=32, global_batch=2, log_every=1,
                       seed=0, peak_lr=3e-3, remat=True)
#: The largest share of RecurrentGemma's parameter elements that may
#: differ by more than TOL (module docstring); 0 for the other families.
OFF_SHARE = {"recurrentgemma-2b": 1e-4}


def _configs(arch):
    jcfg, tcfg = C.reduced(C.get_config(arch)), reduced(get_config(arch))
    return (dataclasses.replace(jcfg, **FAMILIES[arch]),
            dataclasses.replace(tcfg, **FAMILIES[arch]))


def _port_params(np_tree, tcfg):
    params = convert.from_jax_params(np_tree, tcfg, device="cpu",
                                     dtype=tcfg.parameter_dtype)
    for p in leaves(params):
        p.requires_grad_(False)
    return params


def _data_config(mod, cfg, loop):
    return mod.DataConfig(vocab_size=cfg.vocab_size, seq_len=loop.seq_len,
                          global_batch=loop.global_batch, seed=loop.seed,
                          input_mode=cfg.input_mode, d_model=cfg.d_model,
                          num_vision_tokens=cfg.num_vision_tokens)


def _jax_loops(jcfg, jparams, loop, n=2):
    """The JAX loop of ``tests/test_torch_train.py`` with the pipeline in
    the config's input mode, from ``jparams`` and then from ``n - 1``
    copies with every element moved by one f32 ulp at random (seed 1):
    for each, (losses, grad norms, final parameter leaves)."""
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

    rng = np.random.RandomState(1)
    starts = [jparams] + [
        jax.tree.map(lambda x: x * (1 + 2.0 ** -24 * rng.choice(
            [-1, 1], size=x.shape)).astype(np.float32), jparams)
        for _ in range(n - 1)]
    runs = []
    for params in starts:
        pipe = jpipe.DataPipeline(_data_config(jpipe, jcfg, loop))
        opt = jadamw.init(params)
        losses, norms = [], []
        for _ in range(loop.steps):
            params, opt, loss, gnorm = step(params, opt, next(pipe))
            losses.append(float(loss))
            norms.append(float(gnorm))
        runs.append((np.array(losses), np.array(norms),
                     [np.asarray(p) for p in jax.tree.leaves(params)]))
    return runs


def _direct_loop(tcfg, params, loop):
    """``direct_step`` over ``train()``'s batches and schedule."""
    ocfg = adamw.AdamWConfig(peak_lr=loop.peak_lr,
                             warmup_steps=max(loop.steps // 10, 1),
                             total_steps=loop.steps)
    pipe = tpipe.DataPipeline(_data_config(tpipe, tcfg, loop), device="cpu")
    opt, hist = adamw.init(params), []
    for _ in range(loop.steps):
        params, opt, _, m = direct_step(params, opt, {}, next(pipe),
                                        cfg=tcfg, ocfg=ocfg,
                                        remat=loop.remat,
                                        grad_compression=False)
        hist.append({k: float(v) for k, v in m.items()})
    return hist, params


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_train_matches_jax_loop_by_family(arch):
    """Compiled ``train()`` and the direct loop, each against the JAX
    loop: losses and grad norms 1e-4 relative, final parameters 2e-4."""
    jcfg, tcfg = _configs(arch)
    jparams = jlm.init(jax.random.PRNGKey(0), jcfg)[0]
    np_tree = jax.tree.map(np.asarray, jparams)
    (want_loss, want_norm, want_leaves), (ulp_loss, ulp_norm, ulp_leaves) = \
        _jax_loops(jcfg, jparams, LOOP)
    assert np.all(np.isfinite(want_loss)) and want_loss[-1] < want_loss[0]
    # max(1e-4, twice the reference's own spread under a one-ulp move)
    loss_tol = max(1e-4, 2 * np.max(np.abs(ulp_loss / want_loss - 1)))
    norm_tol = max(1e-4, 2 * np.max(np.abs(ulp_norm / want_norm - 1)))
    total = sum(w.size for w in want_leaves)
    ulp_off = sum(int((np.abs(u - w) > TOL["atol"] + TOL["rtol"]
                       * np.abs(w)).sum())
                  for u, w in zip(ulp_leaves, want_leaves))

    out = train(tcfg, LOOP, device="cpu", params=_port_params(np_tree, tcfg))
    assert out["engine"]["misses"] == 1 and out["engine"]["hits"] == 4
    direct_hist, direct_params = _direct_loop(
        tcfg, _port_params(np_tree, tcfg), LOOP)
    for hist, params in ((out["history"], out["params"]),
                         (direct_hist, direct_params)):
        np.testing.assert_allclose([h["loss"] for h in hist], want_loss,
                                   rtol=loss_tol)
        np.testing.assert_allclose([h["grad_norm"] for h in hist], want_norm,
                                   rtol=norm_tol)
        off = sum(int((np.abs(got.numpy() - want) > TOL["atol"]
                       + TOL["rtol"] * np.abs(want)).sum())
                  for got, want in zip(leaves(params), want_leaves))
        limit = (max(OFF_SHARE[arch] * total, 2 * ulp_off)
                 if arch in OFF_SHARE else 0)
        assert off <= limit, (arch, off, ulp_off)


@pytest.mark.parametrize("mode,arch", [("embeds", "musicgen-large"),
                                       ("tokens+vision", "internvl2-2b")])
def test_make_batch_input_modes_bit_identical(mode, arch):
    cfg = reduced(get_config(arch))
    assert cfg.input_mode == mode
    for seed, seq, batch in ((0, 32, 2), (1234, 48, 3)):
        loop = TrainLoopConfig(seq_len=seq, global_batch=batch, seed=seed)
        jc, tc = _data_config(jpipe, cfg, loop), _data_config(tpipe, cfg,
                                                              loop)
        for step in (0, 1, 9):
            want, got = jpipe.make_batch(jc, step), tpipe.make_batch(tc, step)
            assert sorted(got) == sorted(want)
            for key in got:
                assert got[key].dtype == want[key].dtype, key
                np.testing.assert_array_equal(got[key], want[key])
    first = next(tpipe.DataPipeline(tc, device="cpu"))
    for key, value in first.items():
        assert value.dtype == (torch.float32 if "embeds" in key
                               else torch.int32)


# ===========================================================================
# The joint graph: one gradient node per kernel call of the direct step
# ===========================================================================
#: Kernel wrappers by the name of the graph node that calls each.
WRAPPERS = {"sma_gemm": (kgemm, "sma_gemm"),
            "rmsnorm_gemm": (knorm, "rmsnorm_gemm"),
            "flash_attention_fwd": (kflash, "flash_attention_fwd"),
            "flash_attention_bwd": (kflash, "flash_attention_bwd"),
            "rglru_scan": (krglru, "rglru_scan"),
            "rglru_scan_bwd": (krglru, "rglru_scan_bwd"),
            "mlstm_chunkwise": (kmlstm, "mlstm_chunkwise"),
            "mlstm_chunkwise_bwd": (kmlstm, "mlstm_chunkwise_bwd")}


@pytest.fixture
def calls(monkeypatch):
    seen = collections.Counter()
    for name, (mod, attr) in WRAPPERS.items():
        orig = getattr(mod, attr)

        def spy(*a, _orig=orig, _name=name, **k):
            seen[_name] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(mod, attr, spy)
    return seen


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "recurrentgemma-2b",
                                  "xlstm-1.3b"])
def test_one_gradient_node_per_direct_launch_by_family(arch, calls):
    """The traced step of an MoE (the router an ``sma_gemm`` site, counted
    forward and backward), of RecurrentGemma (the scans and their
    reverse-scan backward, the windowed flash) and of xLSTM (the chunkwise
    mLSTM, forward and recomputed, and its backward; the sLSTM's loop
    nodes launch no kernel) holds one node per kernel call of the direct
    step; the compiled step calls each kernel once per node but the remat
    groups' recomputed last products, which nothing reads
    (``tests/test_torch_train_jit.py``)."""
    cfg = _configs(arch)[1]
    ocfg = adamw.AdamWConfig(peak_lr=1e-2, warmup_steps=1, total_steps=4)
    kw = dict(cfg=cfg, ocfg=ocfg, remat=True, grad_compression=False)
    params = lm.init(cfg, seed=0, device="cpu", dtype=cfg.parameter_dtype)
    state = (params, adamw.init(params), {})
    batch = next(tpipe.DataPipeline(tpipe.DataConfig(cfg.vocab_size, 32, 2),
                                    device="cpu"))
    direct_step(*copy.deepcopy(state), batch, **kw)
    direct_calls = dict(calls)
    layers = cfg.num_groups * len(cfg.block_pattern)
    if cfg.moe is not None:
        # q, k, v, o and the router, each forward, recomputed, dA and dB;
        # the head's dW through sma_gemm; its forward and dnormed fused.
        assert direct_calls["sma_gemm"] == 5 * 4 * layers + 2
    elif "rglru" in cfg.block_pattern:
        rg = sum(b == "rglru" for b in cfg.block_pattern) * cfg.num_groups
        assert direct_calls["rglru_scan"] == 2 * rg
        assert direct_calls["rglru_scan_bwd"] == rg
    else:
        ml = sum(b == "mlstm" for b in cfg.block_pattern) * cfg.num_groups
        assert direct_calls["mlstm_chunkwise"] == 2 * ml
        assert direct_calls["mlstm_chunkwise_bwd"] == ml
    cm = make_step(cfg, ocfg, remat=True,
                   grad_compression=False).compile(*state, batch)
    nodes = collections.Counter(
        op_name(n) for n in cm.traced.graph.nodes
        if n.op == "call_function" and n.target in KERNEL_ENTRY_OPS)
    assert dict(nodes) == direct_calls
    calls.clear()
    cm(*state, batch)
    assert set(calls) == set(direct_calls)
    for name, n in calls.items():
        assert n <= direct_calls[name], name
    for name in ("rglru_scan_bwd", "mlstm_chunkwise_bwd",
                 "flash_attention_bwd", "rmsnorm_gemm"):
        assert calls.get(name) == direct_calls.get(name), name
