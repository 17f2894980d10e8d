"""Tensor parallelism by the rules: ``train(mesh=)`` with a ``model`` axis
(:mod:`repro_torch.distributed.tensor_parallel`) against the unmeshed
``train()`` and the JAX package's unmeshed loop.

Ranks are spawned here (CPU, ``gloo``, plain versions; one world a size,
its cases in ``tests/torch_dist_workers.py``).  Every reduced family --
StableLM (MHA), Mistral-NeMo (GQA), Qwen3 (experts), RecurrentGemma
(RG-LRU and MQA attention), xLSTM (mLSTM and sLSTM), musicgen
(``embeds``), InternVL (``tokens+vision``); the recurrent ones at the
family test's short patterns -- trains 3 steps on a 1 x 2 mesh (tensor
parallel) and on a 2 x 1 mesh (data parallel), from the JAX package's f32
masters.  The JAX side is the unmeshed JAX loop: ``repro.compiler`` does
not import on this JAX, so the reference's own ``train()`` cannot run.

Tolerances: losses and grad norms within rtol 1e-4 of the unmeshed
``train()`` and of the JAX loop (xLSTM's against the JAX loop within
max(1e-4, twice the reference's own spread under a one-ulp move of the
masters), the rule of ``tests/test_torch_train_families.py``); the
gathered masters within 2e-4 of the unmeshed run's, but for at most
:data:`OFF_SHARE` of their elements (that test's noise-floor finding).  Bit for bit: every
replicated leaf across the ``model`` ranks at every step (a partial
gradient left unsummed parts them), every rank's collectives in one order.
Also StableLM on a 2 x 2 mesh, the whole-attention route on a 1 x 4 mesh
(6 query heads, 1 KV head), the vocab-parallel loss and embedding alone,
the report's comm bytes against the collectives' stats and spans, and a
checkpoint saved on 1 x 2 resumed on 2 x 1 and on one rank.
"""
import copy
import dataclasses
import shutil
import threading

import jax
import numpy as np
import pytest
import torch

import repro.configs as C
import torch_dist_workers as workers
from repro.data import pipeline as jpipe
from repro.models import lm as jlm
from repro.models.layers import Runtime
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.distributed.tensor_parallel import WHOLE_ATTENTION_REASON
from repro_torch.launch.train import train
from repro_torch.models import lm
from repro_torch.tree import leaves

FAMILIES = list(workers.TP_FAMILIES)
TOL = dict(rtol=2e-4, atol=2e-4)
#: The largest share of a run's master elements that may miss TOL: a
#: parameter whose gradient sits at the noise floor takes an AdamW update
#: of about the rate either way (``tests/test_torch_train_families.py``'s
#: finding; here one Qwen3 expert element of 32,768 moves 2.1e-4).
OFF_SHARE = 1e-4


def _hold_masters(got, want):
    """Every master within TOL but at most OFF_SHARE of the elements."""
    off = total = 0
    for g, w in zip(got, want):
        off += int((np.abs(g - w) > TOL["atol"] + TOL["rtol"]
                    * np.abs(w)).sum())
        total += w.size
    assert off <= OFF_SHARE * total, (off, total)


def _jax_config(arch):
    return dataclasses.replace(C.reduced(C.get_config(arch)),
                               **workers.TP_FAMILIES[arch])


def _jax_loop(jcfg, jparams, loop):
    """The JAX package's unmeshed loop in the config's input mode:
    (losses, grad norms)."""
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
        global_batch=loop.global_batch, seed=loop.seed,
        input_mode=jcfg.input_mode, d_model=jcfg.d_model,
        num_vision_tokens=jcfg.num_vision_tokens))
    opt = jadamw.init(jparams)
    losses, norms, params = [], [], jparams
    for _ in range(loop.steps):
        params, opt, loss, gnorm = step(params, opt, next(pipe))
        losses.append(float(loss))
        norms.append(float(gnorm))
    return np.array(losses), np.array(norms)


def _save(params, path):
    np.savez(path, **{f"p{i}": p.numpy() for i, p in enumerate(leaves(params))})


def _spawn_in_thread(out, name, *args, **kwargs):
    from repro_torch.launch import mesh as tmesh

    def run():
        try:
            out[name] = tmesh.spawn(*args, **kwargs)
        except BaseException as exc:        # re-raised by the fixture
            out[name] = exc
    t = threading.Thread(target=run)
    t.start()
    return t


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """Both spawned worlds (in threads), and meanwhile here: the JAX loop
    and the unmeshed ``train()`` of every family, the xLSTM reference's
    one-ulp spread, the whole-attention config's unmeshed run, and after
    the worlds the one-rank resume."""
    tmp = tmp_path_factory.mktemp("tp")
    loop = workers.tp_loop()
    inputs, jax_params = {}, {}
    for arch in FAMILIES:
        jcfg = _jax_config(arch)
        jparams = jlm.init(jax.random.PRNGKey(0), jcfg)[0]
        tcfg = workers.tp_config(arch)
        params = convert.from_jax_params(jax.tree.map(np.asarray, jparams),
                                         tcfg, device="cpu",
                                         dtype=tcfg.parameter_dtype)
        inputs[arch] = str(tmp / f"{arch}.npz")
        _save(params, inputs[arch])
        jax_params[arch] = (jcfg, jparams)
    hcfg = workers.tp_config("stablelm-1.6b", workers.TP_HEADS)
    heads_path = str(tmp / "heads.npz")
    _save(lm.init(hcfg, seed=0, device="cpu", dtype=hcfg.parameter_dtype),
          heads_path)
    ck = str(tmp / "ck")
    worlds = {}
    threads = [_spawn_in_thread(worlds, 2, workers.tp_world, 2, inputs, ck,
                                timeout=900),
               _spawn_in_thread(worlds, 4, workers.tp_world4, 4,
                                inputs["stablelm-1.6b"], heads_path,
                                timeout=900)]
    out = {"jax": {}, "unmeshed": {}}
    try:
        for arch in FAMILIES:
            jcfg, jparams = jax_params[arch]
            out["jax"][arch] = _jax_loop(jcfg, jparams, loop)
            tcfg = workers.tp_config(arch)
            res = train(tcfg, loop, device="cpu",
                        params=workers.tp_params(tcfg, inputs[arch]))
            out["unmeshed"][arch] = {"history": res["history"], "params": [
                p.numpy() for p in leaves(res["params"])]}
        jcfg, jparams = jax_params["xlstm-1.3b"]
        rng = np.random.RandomState(1)
        moved = jax.tree.map(lambda x: x * (1 + 2.0 ** -24 * rng.choice(
            [-1, 1], size=x.shape)).astype(np.float32), jparams)
        out["xlstm_ulp"] = _jax_loop(jcfg, moved, loop)
        res = train(hcfg, loop, device="cpu",
                    params=workers.tp_params(hcfg, heads_path))
        out["heads_unmeshed"] = {"history": res["history"], "params": [
            p.numpy() for p in leaves(res["params"])]}
    finally:
        for t in threads:
            t.join()
    for w in worlds.values():
        if isinstance(w, BaseException):
            raise w
    out["two"], out["four"] = worlds[2], worlds[4]
    scfg = workers.tp_config("stablelm-1.6b")
    from repro_torch.launch.mesh import smoke_mesh
    res = train(scfg, workers.tp_loop(ckdir=ck + "_one"), device="cpu",
                params=workers.tp_params(scfg, inputs["stablelm-1.6b"]),
                mesh=smoke_mesh())
    out["resumed1"] = {"history": res["history"], "params": [
        p.numpy() for p in leaves(res["params"])]}
    return out


def _metrics(history, key):
    return np.array([h[key] for h in history])


def _hold(got, want, rtol=1e-4):
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(_metrics(got, key), want[key], rtol=rtol)


def _references(tp_runs, arch):
    """(unmeshed train(), JAX loop, the JAX loop's rtol) as
    ``{"loss", "grad_norm"}`` arrays."""
    un = tp_runs["unmeshed"][arch]["history"]
    jl, jn = tp_runs["jax"][arch]
    rtol = 1e-4
    if arch == "xlstm-1.3b":
        ul, un_ = tp_runs["xlstm_ulp"]
        spread = max(np.max(np.abs(ul - jl) / np.abs(jl)),
                     np.max(np.abs(un_ - jn) / np.abs(jn)))
        rtol = max(1e-4, 2 * spread)
    return ({"loss": _metrics(un, "loss"), "grad_norm": _metrics(un,
                                                                 "grad_norm")},
            {"loss": jl, "grad_norm": jn}, rtol)


@pytest.mark.parametrize("arch", FAMILIES)
def test_tp_family_matches_unmeshed_and_jax(tp_runs, arch):
    """1 x 2 (tensor parallel): every rank's losses and grad norms within
    rtol 1e-4 of the unmeshed train() and of the JAX loop (xLSTM's JAX
    bound by its family rule); the gathered masters within 2e-4 of the
    unmeshed run's, but at most OFF_SHARE of their elements."""
    unmeshed, jax_loop, jax_rtol = _references(tp_runs, arch)
    for rank in tp_runs["two"]:
        run = rank[arch]["tp"]
        _hold(run["history"], unmeshed)
        _hold(run["history"], jax_loop, jax_rtol)
        _hold_masters(run["params"], tp_runs["unmeshed"][arch]["params"])


@pytest.mark.parametrize("arch", FAMILIES)
def test_dp_family_matches_unmeshed_and_jax(tp_runs, arch):
    """2 x 1 (data parallel, ZeRO-1 moments): the same bounds, and the
    masters equal on both ranks."""
    unmeshed, jax_loop, jax_rtol = _references(tp_runs, arch)
    a, b = (rank[arch]["dp"] for rank in tp_runs["two"])
    assert a["history"] == b["history"]
    _hold(a["history"], unmeshed)
    _hold(a["history"], jax_loop, jax_rtol)
    for x, y, want in zip(a["params"], b["params"],
                          tp_runs["unmeshed"][arch]["params"]):
        assert np.array_equal(x, y)
        np.testing.assert_allclose(x, want, **TOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_tp_replicas_blocks_and_order(tp_runs, arch):
    """1 x 2: every replicated leaf bit for bit on both ranks at every
    step; each rank holds only its model block of each split leaf (its
    moments too); both ranks dispatch the same collectives in the same
    order, one compile."""
    a, b = (rank[arch]["tp"] for rank in tp_runs["two"])
    assert a["replicated_digest"] == b["replicated_digest"]
    assert len(a["replicated_digest"]) == 3
    for key in ("loss", "grad_norm", "accuracy"):
        assert _metrics(a["history"], key).tolist() == \
            _metrics(b["history"], key).tolist()
    assert any(a["split"]) and not all(a["split"])
    for sp, local, whole in zip(a["split"], a["local_shapes"],
                                a["whole_shapes"]):
        n_local, n_whole = int(np.prod(local)), int(np.prod(whole))
        assert n_local * (2 if sp else 1) == n_whole, (local, whole)
    assert a["moment_shapes"] == [tuple(s) for s in a["moment_want"]]
    assert a["collectives"] == b["collectives"] and a["collectives"][0]
    assert a["engine"]["misses"] == 1 and a["engine"]["hits"] == 2
    assert a["routed"] == 0


def test_tp_two_by_two(tp_runs):
    """StableLM on 2 x 2 (data x tensor parallel, FSDP over data) against
    the unmeshed run; the replicated leaves equal on all four ranks, the
    split ones on each data pair; each rank's masters and moments its
    ``data`` block of some ``model`` blocks."""
    unmeshed, jax_loop, _ = _references(tp_runs, "stablelm-1.6b")
    runs = [rank["2x2"] for rank in tp_runs["four"]]
    for run in runs:
        _hold(run["history"], unmeshed)
        _hold(run["history"], jax_loop)
        for got, want in zip(run["params"],
                             tp_runs["unmeshed"]["stablelm-1.6b"]["params"]):
            np.testing.assert_allclose(got, want, **TOL)
    assert all(r["replicated_digest"] == runs[0]["replicated_digest"]
               for r in runs)
    by_model = {}
    for r in runs:
        by_model.setdefault(r["coords"]["model"], []).append(r)
    for pair in by_model.values():
        assert pair[0]["history"] == pair[1]["history"]
    assert all(r["collectives"] == runs[0]["collectives"] for r in runs)
    assert runs[0]["moment_shapes"] == runs[0]["local_shapes"] == \
        [tuple(s) for s in runs[0]["moment_want"]]
    assert any(s != w for s, w in zip(runs[0]["local_shapes"],
                                      runs[0]["model_shapes"]))


def test_whole_attention_route(tp_runs):
    """6 query heads and 1 KV head on a 1 x 4 mesh: neither head count
    divides the axis, so the attention weights stay whole and attention
    runs whole on every rank, counted in ops.ROUTED (each layer, forward
    and its remat recomputation, as traced); MLP and vocab still split;
    the run matches the unmeshed one."""
    un = tp_runs["heads_unmeshed"]
    want = {k: _metrics(un["history"], k) for k in ("loss", "grad_norm")}
    cfg = workers.tp_config("stablelm-1.6b", workers.TP_HEADS)
    for rank in tp_runs["four"]:
        run = rank["heads"]
        _hold(run["history"], want)
        for got, w in zip(run["params"], un["params"]):
            np.testing.assert_allclose(got, w, **TOL)
        assert run["routed"] == 2 * cfg.num_layers
        names = [n for n, _ in _named(lm.param_specs(cfg))]
        split = dict(zip(names, run["split"]))
        assert not any(split[n] for n in names if ".mixer." in n)
        assert split["head.w"] and split["blocks[0].ffn.wi"]
    assert WHOLE_ATTENTION_REASON.startswith("tensor parallel")


def _named(tree, prefix=""):
    """(path, leaf) pairs in the port's leaf order, a spec tuple a leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named(tree[k], f"{prefix}{'.' if prefix else ''}{k}")
    elif isinstance(tree, tuple) and tree and isinstance(tree[0], dict):
        for i, v in enumerate(tree):
            yield from _named(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def test_vocab_parallel_loss_and_embedding(tp_runs):
    """The vocab-parallel cross entropy (a padded vocab, labels of -1, a
    tie for the argmax across the blocks) and embedding on 2 ranks against
    the plain ones: values and each block's gradient."""
    for rank in tp_runs["two"]:
        v = rank["vocab"]
        np.testing.assert_allclose(v["ce"], v["want_ce"], rtol=1e-6,
                                   atol=1e-5)
        assert np.array_equal(v["hit"], v["want_hit"])
        np.testing.assert_allclose(v["dlogits"], v["want_dlogits"],
                                   rtol=1e-5, atol=1e-6)
        assert np.array_equal(v["rows"], v["want_rows"])
        assert np.array_equal(v["dtable"], v["want_dtable"])


def test_collectives_carry_gradients_as_traced_nodes(tp_runs):
    """The traced StableLM step on 1 x 2: f is a ``tp_enter`` node forward
    (each layer's two, and again in its remat recomputation; the head's
    input and scale) and an ``all_reduce`` node backward; g an
    ``all_reduce`` node, the recomputation repeating the attention's (the
    recomputed MLP output is read by nothing, so its g is not traced); the
    embedding's g, the loss's max and sums and the norm's sum over the
    model line."""
    cfg = workers.tp_config("stablelm-1.6b")
    n = cfg.num_layers
    for rank in tp_runs["two"]:
        traced = rank["traced"]
        assert traced[("tp_enter", "comm.tp_enter")] == 2 * n * 2 + 2
        assert traced[("all_reduce", "comm.tp_enter")] == 2 * n + 2
        assert traced[("all_reduce", "comm.tp_exit")] == 3 * n
        assert traced[("all_reduce", "comm.tp_embed")] == 1
        assert traced[("all_reduce", "comm.tp_max")] == 3
        assert traced[("all_reduce", "comm.tp_loss")] == 2
        assert traced[("all_reduce", "comm.tp_norm")] == 1


def test_remat_recomputation_keeps_the_rules_on_another_thread(tp_runs):
    """Autograd runs a CUDA tensor's backward on a thread of its own; the
    remat recomputation there must run on the rank's blocks as the forward
    did: gradients taken on another thread equal this thread's."""
    assert all(rank["thread"]["same"] for rank in tp_runs["two"])


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "qwen3-moe-30b-a3b",
                                  "recurrentgemma-2b", "xlstm-1.3b"])
def test_comm_report_equals_stats_and_spans(tp_runs, arch):
    """The report's ``comm`` collectives (the dispatched step's nodes) a
    step times the steps equal ``collectives.BYTES`` and the ``comm.*``
    spans of the run, span name by span name."""
    for rank in tp_runs["two"]:
        run = rank[arch]["tp"]
        report = run["comm"][0]["bytes"]
        steps = len(run["history"])
        assert report and {k: v * steps for k, v in report.items()} == \
            run["bytes"] == run["span_bytes"]
        assert run["comm"][0]["bytes_total"] * steps == \
            sum(run["bytes"].values())


def test_tp_checkpoint_resumes_elastically(tp_runs):
    """Saved on 1 x 2 at step 2 (halted), resumed on 2 x 1 and on one
    rank: step 3 within the tolerances of the unbroken 1 x 2 run."""
    unbroken = tp_runs["two"][0]["stablelm-1.6b"]["tp"]
    halted = tp_runs["two"][0]["halted"]
    assert halted["history"] == unbroken["history"][:2]
    for resumed in ([r["resumed"] for r in tp_runs["two"]]
                    + [tp_runs["resumed1"]]):
        assert len(resumed["history"]) == 1
        np.testing.assert_allclose(
            [h["loss"] for h in resumed["history"]],
            [h["loss"] for h in unbroken["history"][2:]], rtol=1e-4)
        for got, want in zip(resumed["params"], unbroken["params"]):
            np.testing.assert_allclose(got, want, **TOL)
