"""FSDP by the rules' ``embed -> data``: ``train(mesh=)`` keeps each rank's
``data`` block of every master, moment and gradient, gathers one group's
weights at a time in the compute dtype inside the group's body, and
reduce-scatters their gradients (:mod:`repro_torch.distributed.fsdp`).

The layout tests run in this process on stand-in meshes (a layout reads
only a mesh's shape and this rank's coordinates): for the seven families
of ``tests/test_torch_tensor_parallel.py``, on 2 x 1 and 2 x 2, every
rank's ``lm.init_blocks`` equals ``convert.model_blocks(lm.init(...))``
bit for bit.  The rest spawn one 2-rank world (CPU, ``gloo``, plain
versions; its cases in ``tests/torch_dist_workers.py``) while the JAX
loop and the unmeshed ``train()`` run here:

* the reduced StableLM on 2 x 1 from ``lm.init_blocks``: each rank's
  masters, moments and gradients hold half of every leaf whose ``embed``
  divides; the dispatched step's collectives in order (one bucketed
  gather a group in the forward and again in the remat recomputation,
  one reduce-scatter a group in the backward, no master all-gather); the report's comm bytes against ``collectives.BYTES`` and
  the ``comm.*`` spans; losses and grad norms within rtol 1e-4 of the
  unmeshed ``train()`` and of the JAX loop from the same masters, the
  gathered masters within 2e-4;
* ``reduce_scatter`` and ``gather_param`` against the plain sums of the
  ranks' tensors, values and gradients, direct and host-staged; a
  bucket of three leaves in one ``gather_tree`` call against
  ``gather_param`` a leaf;
* a save gathers one leaf at a time; a run saved on 2 x 1 at step 2
  resumes on 1 x 2 and on one rank within the tolerances above.
"""
import dataclasses
import itertools
import threading
import types

import jax
import jax.numpy as jnp
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
from repro_torch.distributed import collectives
from repro_torch.launch.train import MeshPlan, train
from repro_torch.models import lm
from repro_torch.tree import leaves

FAMILIES = list(workers.TP_FAMILIES)
ARCH = "stablelm-1.6b"
TOL = dict(rtol=2e-4, atol=2e-4)
GATHER, SCATTER = "comm.fsdp_gather", collectives.PARAM_GRAD_SPAN


def _stand_in_mesh(sizes, coords):
    """A mesh's shape and this rank's coordinates, with no process group
    (all a layout reads)."""
    axes = ("data", "model")
    return types.SimpleNamespace(shape=dict(zip(axes, sizes)),
                                 coords=dict(zip(axes, coords)),
                                 axis_names=axes,
                                 group_key=lambda a: f"stand-in.{a}")


@pytest.mark.parametrize("sizes", [(2, 1), (2, 2)])
@pytest.mark.parametrize("arch", FAMILIES)
def test_init_blocks_equals_model_blocks(arch, sizes):
    """Every rank's directly drawn blocks equal its blocks of ``lm.init``'s
    whole masters bit for bit; the ``data`` axis splits some leaf (of
    every family), and every split leaf's block is its share."""
    cfg = workers.tp_config(arch)
    whole = lm.init(cfg, seed=3, device="cpu", dtype=cfg.parameter_dtype)
    for coords in itertools.product(*(range(n) for n in sizes)):
        plan = MeshPlan(cfg, workers.tp_loop(), _stand_in_mesh(sizes, coords),
                        whole)
        got = lm.init_blocks(cfg, plan.layout, seed=3, device="cpu",
                             dtype=cfg.parameter_dtype)
        want = convert.model_blocks(whole, plan.layout)
        for g, w, sh, p in zip(leaves(got), leaves(want),
                               leaves(plan.layout), leaves(whole)):
            assert g.dtype == w.dtype and torch.equal(g, w)
            parts = int(np.prod([s[2] for s in sh.splits]))
            assert g.numel() * parts == p.numel()
        assert any("data" in sh.axes() for sh in leaves(plan.layout))


def test_init_blocks_in_the_activation_dtype():
    """In bf16 too (the casts of a stacked leaf's slices), xLSTM's grouped
    ``w_up`` among the leaves, on 2 x 2."""
    cfg = workers.tp_config("xlstm-1.3b")
    whole = lm.init(cfg, seed=1, device="cpu", dtype=torch.bfloat16)
    for coords in itertools.product(range(2), range(2)):
        plan = MeshPlan(cfg, workers.tp_loop(), _stand_in_mesh((2, 2), coords),
                        whole)
        got = lm.init_blocks(cfg, plan.layout, seed=1, device="cpu",
                             dtype=torch.bfloat16)
        for g, w in zip(leaves(got),
                        leaves(convert.model_blocks(whole, plan.layout))):
            assert g.dtype == w.dtype and torch.equal(g, w)


def _jax_loop(jcfg, jparams, loop):
    """The JAX package's unmeshed loop: (losses, grad norms, masters)."""
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
    losses, norms, params = [], [], jparams
    for _ in range(loop.steps):
        params, opt, loss, gnorm = step(params, opt, next(pipe))
        losses.append(float(loss))
        norms.append(float(gnorm))
    return (np.array(losses), np.array(norms),
            [np.asarray(x) for x in jax.tree.leaves(params)])


@pytest.fixture(scope="module")
def fsdp_runs(tmp_path_factory):
    """The 2-rank world (in a thread), and meanwhile here the unmeshed
    ``train()`` and the JAX loop from ``lm.init``'s masters (those the
    ranks draw their blocks of); after the world, the one-rank resume."""
    from repro_torch.launch import mesh as tmesh
    tmp = tmp_path_factory.mktemp("fsdp")
    cfg, loop = workers.tp_config(ARCH), workers.tp_loop()
    ck = str(tmp / "ck")
    out = {}

    def world():
        try:
            out["two"] = tmesh.spawn(workers.fsdp_world, 2, ck, timeout=600)
        except BaseException as exc:        # re-raised below
            out["two"] = exc

    t = threading.Thread(target=world)
    t.start()
    try:
        res = train(cfg, loop, device="cpu")
        out["unmeshed"] = {"history": res["history"], "params": [
            p.numpy() for p in leaves(res["params"])]}
        for name, change in (("compressed", {"grad_compression": True}),
                             ("one_row", {"global_batch": 1})):
            res = train(cfg, dataclasses.replace(loop, **change),
                        device="cpu")
            out[name] = {"history": res["history"], "params": [
                p.numpy() for p in leaves(res["params"])]}
        jcfg = C.reduced(C.get_config(ARCH))
        like = jax.tree.structure(jlm.init(jax.random.PRNGKey(0), jcfg)[0])
        init = lm.init(cfg, seed=loop.seed, device="cpu",
                       dtype=cfg.parameter_dtype)
        out["jax"] = _jax_loop(jcfg, jax.tree.unflatten(
            like, [jnp.asarray(p.numpy()) for p in leaves(init)]), loop)
    finally:
        t.join()
    if isinstance(out["two"], BaseException):
        raise out["two"]
    from repro_torch.launch.mesh import smoke_mesh
    res = train(cfg, workers.tp_loop(ckdir=ck + "_one"), device="cpu",
                mesh=smoke_mesh())
    out["resumed1"] = {"history": res["history"], "params": [
        p.numpy() for p in leaves(res["params"])]}
    return out


def _hold(history, losses, norms, rtol=1e-4):
    np.testing.assert_allclose([h["loss"] for h in history], losses,
                               rtol=rtol)
    np.testing.assert_allclose([h["grad_norm"] for h in history], norms,
                               rtol=rtol)


def test_fsdp_blocks_on_two_by_one(fsdp_runs):
    """2 x 1: each rank's masters, moments and gradients hold half the
    elements of every leaf whose ``embed`` dim divides (the ``data``
    block), the whole of every other; both ranks alike, one compile."""
    cfg = workers.tp_config(ARCH)
    specs = [s for _, s in _named(lm.param_specs(cfg))]
    for run in (rank["drawn"] for rank in fsdp_runs["two"]):
        assert run["engine"]["misses"] == 1
        for spec, whole, local, m, g, axes in zip(
                specs, run["whole_shapes"], run["local_shapes"],
                run["moment_shapes"], run["grad_shapes"], run["split"]):
            split = "embed" in spec and cfg.d_model % 2 == 0
            assert axes == (("data",) if split else ())
            assert int(np.prod(whole)) == int(np.prod(local)) * (
                2 if split else 1), (spec, whole, local)
            assert local == tuple(m) == tuple(g)
    assert any(a for a in fsdp_runs["two"][0]["drawn"]["split"])


def _named(tree, prefix=""):
    """(path, spec) pairs of a spec tree in the port's leaf order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named(tree[k], f"{prefix}.{k}")
    elif isinstance(tree, tuple) and tree and isinstance(tree[0], dict):
        for i, v in enumerate(tree):
            yield from _named(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def test_fsdp_collectives_in_order(fsdp_runs):
    """The dispatched step, both ranks alike: the table's gather, each
    group's split leaves gathered as one bucket (one gather a group, of
    all their elements), the head's; in the backward the head's
    reduce-scatter, then group by group from the last, the remat
    recomputation's gather of the group and its one reduce-scatter; the
    table's last.  No master all-gather, no other all-gather."""
    n = workers.tp_config(ARCH).num_groups
    want = ([GATHER] * (1 + n + 1) + [SCATTER]
            + [GATHER, SCATTER] * n + [SCATTER])
    a, b = (rank["drawn"]["collectives"] for rank in fsdp_runs["two"])
    assert a == b and len(a) == 1
    spans = [args[-1] for _, args in a[0]]
    assert [s for s in spans if s in (GATHER, SCATTER)] == want
    ops_ = {op for op, _ in a[0]}
    assert "_all_gather_impl" not in ops_
    assert "comm.master_all_gather" not in spans
    for op, args in a[0]:
        if args[-1] == GATHER:
            assert op == "_param_gather_impl" and args[2] is torch.float32 \
                and args[3] is True
        if args[-1] == SCATTER:
            assert op == "_reduce_scatter_impl"


def test_fsdp_matches_unmeshed_and_jax(fsdp_runs):
    """2 x 1 from ``lm.init_blocks``: losses and grad norms within rtol
    1e-4 of the unmeshed train() and of the JAX loop from the same
    masters, the gathered masters within 2e-4 of both, equal on the two
    ranks."""
    un = fsdp_runs["unmeshed"]
    jl, jn, jp = fsdp_runs["jax"]
    a, b = (rank["drawn"] for rank in fsdp_runs["two"])
    assert a["history"] == b["history"]
    _hold(a["history"], [h["loss"] for h in un["history"]],
          [h["grad_norm"] for h in un["history"]])
    _hold(a["history"], jl, jn)
    for x, y, u, j in zip(a["params"], b["params"], un["params"], jp):
        assert np.array_equal(x, y)
        np.testing.assert_allclose(x, u, **TOL)
        np.testing.assert_allclose(x, j, **TOL)


def test_fsdp_compressed_matches_unmeshed(fsdp_runs):
    """With int8 gradient compression each block is quantized against its
    whole leaf's scale (the largest over the blocks), so 2 x 1 FSDP keeps
    the unmeshed compressed run's losses and grad norms within rtol 1e-4
    and its masters within 2e-4."""
    un = fsdp_runs["compressed"]
    for rank in fsdp_runs["two"]:
        run = rank["compressed"]
        _hold(run["history"], [h["loss"] for h in un["history"]],
              [h["grad_norm"] for h in un["history"]])
        for x, u in zip(run["params"], un["params"]):
            np.testing.assert_allclose(x, u, **TOL)
        assert run["bytes"]["comm.compress_max"] > 0


def test_fsdp_when_the_batch_is_not_split(fsdp_runs):
    """A global batch of one row: ``data`` is no batch axis, both ranks
    compute the whole gradient, and each block's is its part of it, with
    no reduce-scatter (the masters are still split and gathered); the run
    keeps the unmeshed one's losses, grad norms and masters."""
    un = fsdp_runs["one_row"]
    for rank in fsdp_runs["two"]:
        run = rank["one_row"]
        _hold(run["history"], [h["loss"] for h in un["history"]],
              [h["grad_norm"] for h in un["history"]])
        for x, u in zip(run["params"], un["params"]):
            np.testing.assert_allclose(x, u, **TOL)
        spans = [args[-1] for _, args in run["collectives"][0]]
        assert GATHER in spans and SCATTER not in spans
        assert all(args[3] is False for op, args in run["collectives"][0]
                   if op == "_param_gather_impl")


def test_fsdp_comm_report_equals_stats_and_spans(fsdp_runs):
    """The report's comm collectives a step times the steps equal the
    run's ``collectives.BYTES`` and ``comm.*`` spans but the digests'
    all-reduce, which runs outside the step; the gathers carry the
    compute dtype's bytes to the other rank, the reduce-scatters their
    float32 input once."""
    cfg = workers.tp_config(ARCH)
    for rank in fsdp_runs["two"]:
        run = rank["drawn"]
        report, steps = run["report"]["bytes"], len(run["history"])
        step_bytes = {k: v for k, v in run["bytes"].items()
                      if k != "comm.digest"}
        step_spans = {k: v for k, v in run["span_bytes"].items()
                      if k != "comm.digest"}
        assert {k: v * steps for k, v in report.items()} == step_bytes \
            == step_spans
        assert run["bytes"]["comm.digest"] == run["span_bytes"][
            "comm.digest"] > 0
        split = sum(int(np.prod(s)) for s, ax in zip(run["whole_shapes"],
                                                     run["split"]) if ax)
        per_group = sum(
            int(np.prod(s)) for (path, _), s, ax in zip(
                _named(lm.param_specs(cfg)), run["whole_shapes"], run["split"])
            if ax and path.startswith(".blocks"))
        itemsize = cfg.activation_dtype.itemsize
        assert report[GATHER] == (split + per_group) // 2 * itemsize
        assert report[SCATTER] == split * 4


def test_reduce_scatter_and_gather_param(fsdp_runs):
    """``reduce_scatter`` is this rank's block of the ranks' sum, its
    gradient the upstream blocks gathered; ``gather_param`` is the ranks'
    blocks in bf16, whole (a grouped dim back in its order), its gradient
    this rank's block of the sum of the ranks' upstream gradients in
    float32; the host-staged route gives the same bits."""
    ranks = [rank["collectives"] for rank in fsdp_runs["two"]]
    world = len(ranks)
    total = sum(r["x"] for r in ranks)
    grad_sum = sum(r["up_g"] for r in ranks).astype(np.float32)
    w = [r["w"] for r in ranks]
    for i, r in enumerate(ranks):
        for route in ("direct", "staged"):
            got = r[route]
            np.testing.assert_allclose(got["rs"], total[:, 4 * i:4 * i + 4],
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_array_equal(
                got["rs_grad"], np.concatenate([q["up_rs"] for q in ranks],
                                               axis=1))
            plain = np.concatenate(w, axis=1)
            halves = [np.split(b, 2, axis=1) for b in w]
            grouped = np.concatenate([h[0] for h in halves]
                                     + [h[1] for h in halves], axis=1)
            for name, whole in (("plain", plain), ("grouped", grouped)):
                g = got[name]
                assert g["dtype"] == "torch.bfloat16"
                assert g["grad_dtype"] == "torch.float32"
                np.testing.assert_array_equal(
                    g["whole"], torch.from_numpy(whole).to(
                        torch.bfloat16).float().numpy())
                if name == "plain":
                    want = grad_sum[:, 8 * i:8 * i + 8]
                else:
                    parts = np.split(grad_sum, 2, axis=1)
                    want = np.concatenate([p[:, 4 * i:4 * i + 4]
                                           for p in parts], axis=1)
                np.testing.assert_allclose(g["grad"], want, rtol=1e-6,
                                           atol=1e-6)
        for name in ("rs", "rs_grad"):
            assert np.array_equal(r["direct"][name], r["staged"][name])
        assert r["stats"]["calls"]["reduce_scatter"] == 3
        assert r["stats"]["staged_bytes"]["reduce_scatter"] > 0
        assert r["gather_bytes"] == 5 * 8 * 2 * (world - 1) * 2


def test_gather_tree_is_one_bucket(fsdp_runs):
    """``gather_tree`` gathers three split leaves (split along two dims,
    one grouped) in one call, and gives the wholes and the float32
    gradients that ``gather_param`` gives each leaf alone."""
    for rank in fsdp_runs["two"]:
        one, tree = (rank["collectives"]["bucket"][k] for k in ("one",
                                                                "tree"))
        assert one["calls"] == 3 and tree["calls"] == 1
        for k in one["whole"]:
            np.testing.assert_array_equal(tree["whole"][k], one["whole"][k])
            np.testing.assert_allclose(tree["grad"][k], one["grad"][k],
                                       rtol=1e-6, atol=1e-6)


def test_fsdp_save_gathers_one_leaf_at_a_time(fsdp_runs):
    """The halted run's save gathers each split leaf (masters and both
    moments) once, and no earlier gathered leaf is alive when the next
    gather returns: a rank never holds more than one whole leaf."""
    for rank in fsdp_runs["two"]:
        run = rank["halted"]
        split = [int(np.prod(s)) for s, ax in zip(run["whole_shapes"],
                                                  run["split"]) if ax]
        assert sorted(n for n, _ in run["saves"]) == sorted(split * 3)
        assert all(alive == 0 for _, alive in run["saves"])


def test_fsdp_checkpoint_resumes_elastically(fsdp_runs):
    """Saved on 2 x 1 (FSDP) at step 2, resumed on 1 x 2 and on one rank:
    step 3 within the tolerances of the unbroken 2 x 1 run."""
    unbroken = fsdp_runs["two"][0]["drawn"]
    assert fsdp_runs["two"][0]["halted"]["history"] == \
        unbroken["history"][:2]
    for resumed in ([r["resumed"] for r in fsdp_runs["two"]]
                    + [fsdp_runs["resumed1"]]):
        assert len(resumed["history"]) == 1
        np.testing.assert_allclose(
            [h["loss"] for h in resumed["history"]],
            [h["loss"] for h in unbroken["history"][2:]], rtol=1e-4)
        for got, want in zip(resumed["params"], unbroken["params"]):
            np.testing.assert_allclose(got, want, **TOL)
