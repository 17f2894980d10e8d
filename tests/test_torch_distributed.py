"""The port's distribution layer against the JAX package's
(``repro.distributed``, ``repro.launch.mesh``, ``repro.optim.compress``,
the specs of ``repro.models.lm`` / ``repro.optim.adamw``).

Exact in this process: ``rules_for`` for every config over the
production and small meshes, ``MeshRules``, the spec trees,
``_balanced_grid`` and ``bubble_fraction``.  Multi-rank: ``gloo`` ranks
spawned here (CPU, plain versions; one world a size, several cases in
it); the JAX side of the pipeline and of ``compressed_psum`` runs in a
subprocess on fake devices and hands its outputs back as ``.npz``.  The
trainer: ``train(mesh=)`` of the reduced StableLM on 2 ranks against the
unmeshed ``train()`` and the JAX loop, and a checkpoint saved on 2 ranks
resumed on 1 and on 4 (tensor parallelism: ``test_torch_tensor_parallel``).
"""
import dataclasses
import os
import shutil
import subprocess
import sys
import textwrap
import types

import jax
import numpy as np
import pytest
import torch

import repro.configs as C
import torch_dist_workers as workers
from repro.data import pipeline as jpipe
from repro.distributed import pipeline as jpipeline
from repro.distributed import sharding as jsharding
from repro.launch import mesh as jmesh
from repro.launch.common import param_specs as jparam_specs
from repro.models import lm as jlm
from repro.models.layers import Runtime
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.configs.base import get_config, reduced
from repro_torch.distributed import pipeline as tpipeline
from repro_torch.distributed import sharding as tsharding
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.train import TrainLoopConfig, train
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.tree import leaves

ARCH = "stablelm-1.6b"
_MESHES = [((16, 16), ("data", "model")),
           ((2, 16, 16), ("pod", "data", "model")),
           ((2, 2), ("data", "model")),
           ((1, 4), ("data", "model"))]


def _jax_mesh(sizes, names):
    try:
        return jax.sharding.AbstractMesh(tuple(sizes), tuple(names))
    except TypeError:       # jax<=0.4.x takes ((name, size), ...) pairs
        return jax.sharding.AbstractMesh(tuple(zip(names, sizes)))


def _port_mesh(sizes, names):
    """The ``shape`` / ``axis_names`` surface ``rules_for`` reads."""
    return types.SimpleNamespace(axis_names=tuple(names),
                                 shape=dict(zip(names, sizes)))


# ----------------------------------------------------------- exact, 1 rank
@pytest.mark.parametrize("arch", C.ARCH_IDS)
def test_rules_for_matches_reference(arch):
    """Every config x mesh x kind, with and without a batch size (one
    that divides the DP degree, one that does not, and 1)."""
    jcfg, tcfg = C.get_config(arch), get_config(arch)
    for sizes, names in _MESHES:
        for kind in ("train", "decode"):
            for bs in (None, 256, 6, 1):
                for sp in (False, True):
                    want = jsharding.rules_for(
                        jcfg, _jax_mesh(sizes, names), batch_size=bs,
                        kind=kind, sequence_parallel=sp)
                    got = tsharding.rules_for(
                        tcfg, _port_mesh(sizes, names), batch_size=bs,
                        kind=kind, sequence_parallel=sp)
                    assert dataclasses.asdict(got) == \
                        dataclasses.asdict(want), (sizes, kind, bs)


def test_mesh_rules_resolve_and_spec_match_reference():
    fields = [f.name for f in dataclasses.fields(jsharding.MeshRules)]
    assert fields == [f.name for f in dataclasses.fields(
        tsharding.MeshRules)]
    tables = [tsharding.MeshRules(),
              tsharding.MeshRules(batch=None, embed=None, heads=None,
                                  head_dim="model", kv_seq="data")]
    for axes in (("data", "model"), ("pod", "data", "model"), ("data",),
                 ()):
        for table in tables:
            jtable = jsharding.MeshRules(**dataclasses.asdict(table))
            for name in fields + [None]:
                assert table.resolve(name, axes) == \
                    jtable.resolve(name, axes)
            logical = ("batch", "seq", "embed", "heads", "kv_seq", None)
            assert table.spec(*logical, mesh_axes=axes) == tuple(
                jtable.spec(*logical, mesh_axes=axes))


def test_ambient_rules_and_shard():
    x = torch.ones(2, 3)
    assert tsharding.logical_spec("batch") is None
    with tsharding.use_rules(tsharding.MeshRules(), ("data", "model")):
        assert tsharding.current_rules() == tsharding.MeshRules()
        assert tsharding.logical_spec("batch", "embed_act", "mlp") == \
            ("data", None, "model")
        assert tsharding.shard(x, "batch", "mlp") is x
    assert tsharding.current_rules() is None


def _specs_equal(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want)
        for k in want:
            _specs_equal(got[k], want[k])
    elif isinstance(want, (tuple, list)) and want and \
            isinstance(want[0], dict):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _specs_equal(g, w)
    else:
        assert tuple(got) == tuple(want), (got, want)


def _spec_leaves(tree):
    """Spec leaves in :func:`repro_torch.tree.leaves` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    if isinstance(tree, tuple) and tree and isinstance(tree[0], dict):
        return [x for node in tree for x in _spec_leaves(node)]
    return [tree]


@pytest.mark.parametrize("arch", C.ARCH_IDS)
def test_spec_trees_match_reference(arch):
    """lm.param_specs (the tree lm.init returns beside the parameters),
    lm.state_specs and adamw.state_specs, for every family; the parameter
    specs in the structure of the port's parameters."""
    jcfg, tcfg = C.get_config(arch), get_config(arch)
    specs = lm.param_specs(tcfg)
    _specs_equal(specs, jparam_specs(jcfg))
    _specs_equal(lm.state_specs(tcfg), jlm.state_specs(jcfg))
    _specs_equal(adamw.state_specs(specs),
                 jadamw.state_specs(jparam_specs(jcfg)))
    params = lm.init(reduced(tcfg), seed=0, device="cpu")
    flat = _spec_leaves(lm.param_specs(reduced(tcfg)))
    assert len(flat) == len(leaves(params))
    for spec, p in zip(flat, leaves(params)):
        assert len(spec) == p.dim()


def test_balanced_grid_and_bubble_fraction_match_reference():
    for n in range(1, 130):
        assert tmesh._balanced_grid(n) == jmesh._balanced_grid(n)
    for p in range(1, 9):
        for m in range(1, 17):
            assert tpipeline.bubble_fraction(p, m) == \
                jpipeline.bubble_fraction(p, m)


def test_shardings_of_a_spec_tree():
    """spec_tree_to_shardings on a one-rank mesh splits nothing; on a
    stand-in 2 x 1 mesh each leaf is split along its data dims where
    they divide."""
    specs = {"w": ("data", "model"), "b": (None,), "v": ("data",)}
    one = tsharding.spec_tree_to_shardings(tmesh.fake_mesh(1), specs)
    assert all(not s.splits for s in one.values())
    two = types.SimpleNamespace(shape={"data": 2, "model": 1},
                                coords={"data": 1, "model": 0},
                                axis_names=("data", "model"))
    like = {"w": torch.zeros(4, 3), "b": torch.zeros(3),
            "v": torch.arange(5.0)}
    sh = tsharding.spec_tree_to_shardings(two, specs, like=like)
    assert sh["w"].splits == ((0, ("data",), 2, 1),)
    assert sh["w"].local_shape((4, 3)) == (2, 3)
    assert torch.equal(sh["w"].local(torch.arange(12.).view(4, 3)),
                       torch.arange(6., 12.).view(2, 3))
    assert np.array_equal(sh["w"].local(np.arange(12.).reshape(4, 3)),
                          np.arange(6., 12.).reshape(2, 3))
    assert not sh["b"].splits and not sh["v"].splits   # 5 does not divide


def test_grouped_split_and_regroup():
    """A grouped dim (mLSTM's ``w_up``: the cell input's columns, then the
    gate's) splits into each part's block side by side, a tensor and a
    numpy array alike, and ``regroup`` puts the ranks' blocks, concatenated
    in rank order, back in the whole order; ``lm.param_groups`` groups
    only ``w_up``."""
    model2 = [types.SimpleNamespace(shape={"data": 1, "model": 2},
                                    coords={"data": 0, "model": r},
                                    axis_names=("data", "model"))
              for r in range(2)]
    specs = {"w_up": (None, "model"), "w": (None, "model")}
    like = {"w_up": torch.zeros(3, 8), "w": torch.zeros(3, 8)}
    x = torch.arange(24.).view(3, 8)
    blocks = []
    for mesh in model2:
        sh = tsharding.spec_tree_to_shardings(
            mesh, specs, like=like, groups={"w_up": 2, "w": 1})
        assert sh["w_up"].groups == ((1, 2),) and sh["w"].groups == ()
        cols = [c + 2 * mesh.coords["model"] for c in (0, 1, 4, 5)]
        assert torch.equal(sh["w_up"].local(x), x[:, cols])
        assert np.array_equal(sh["w_up"].local(x.numpy()), x[:, cols].numpy())
        assert torch.equal(sh["w"].local(x),
                           x[:, 4 * mesh.coords["model"]:][:, :4])
        blocks.append(sh["w_up"].local(x))
    assert torch.equal(tsharding.regroup(torch.cat(blocks, 1), 1, 2, 2), x)
    cfg = reduced(get_config("xlstm-1.3b"))
    groups = [(n, g) for n, g in zip(
        [p for p, _ in _spec_paths(lm.param_specs(cfg))],
        leaves(lm.param_groups(cfg))) if g != 1]
    assert groups and all(n.endswith("w_up") and g == 2 for n, g in groups)
    assert all(g == 1 for g in leaves(lm.param_groups(reduced(get_config(
        "stablelm-1.6b")))))


def _spec_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_paths(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, tuple) and tree and isinstance(tree[0], dict):
        for i, v in enumerate(tree):
            yield from _spec_paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


# ------------------------------------------------------------------ errors
def test_meshes_refuse_a_wrong_world():
    with pytest.raises(ValueError, match="needs 256 ranks"):
        tmesh.make_production_mesh()
    with pytest.raises(ValueError, match="needs 512 ranks"):
        tmesh.make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match=r"fake_mesh\(4\) needs a process "
                                         r"group of 4 ranks.*spawn"):
        tmesh.fake_mesh(4)
    with pytest.raises(ValueError, match="exactly 2 axis names"):
        tmesh.fake_mesh(1, axes=("data",))
    mesh = tmesh.smoke_mesh()
    assert (mesh.shape, mesh.size, mesh.coords, mesh.backend) == \
        ({"data": 1}, 1, {"data": 0}, None)
    assert tmesh.fake_mesh(1) == tmesh.fake_mesh(1)
    assert hash(tmesh.fake_mesh(1)) == hash(tmesh.fake_mesh(1))
    assert tmesh.fake_mesh(1) != tmesh.fake_mesh(1, axes=("x", "y"))


# ---------------------------------------------------- multi-rank, vs JAX
_JAX_CODE = """
    import jax, jax.numpy as jnp, numpy as np
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    import repro.configs as C
    from repro.distributed.pipeline import pipeline_apply
    from repro.models import lm
    from repro.models.layers import Runtime
    from repro.optim.compress import compressed_psum
    data = dict(np.load({inputs!r}))
    out = {{}}
    for n in (2, 4):
        mesh = Mesh(np.array(jax.devices()[:n]), ("pipe",))
        sp = {{"w": jnp.asarray(data[f"affine{{n}}_w"]),
              "b": jnp.asarray(data[f"affine{{n}}_b"])}}
        y = pipeline_apply(lambda p, t: t * p["w"] + p["b"], mesh, "pipe",
                           sp, jnp.asarray(data[f"affine{{n}}_x"]))
        out[f"affine{{n}}"] = np.asarray(y)
    cfg = C.reduced(C.get_config("stablelm-1.6b"))
    rt = Runtime()
    params = lm.init(jax.random.PRNGKey(0), cfg)[0]
    blocks = params["blocks"][0]
    per = cfg.num_groups // 2
    staged = jax.tree.map(lambda t: t.reshape((2, per) + t.shape[1:]),
                          blocks)

    def stage_fn(p, h):
        for g in range(per):
            h, _ = lm._apply_block(jax.tree.map(lambda t: t[g], p), "attn",
                                   h, cfg, rt, {{}})
        return h

    mesh = Mesh(np.array(jax.devices()[:2]), ("pipe",))
    y = pipeline_apply(stage_fn, mesh, "pipe", staged,
                       jnp.asarray(data["model_x"]))
    out["model"] = np.asarray(y)
    for i, leaf in enumerate(jax.tree.leaves(params)):
        out[f"param_{{i}}"] = np.asarray(leaf)
    mesh = Mesh(np.array(jax.devices()[:4]), ("dp",))
    f = shard_map(lambda t: compressed_psum(t[0], "dp")[None], mesh=mesh,
                  in_specs=P("dp"), out_specs=P("dp"), check_rep=False)
    out["psum"] = np.asarray(f(jnp.asarray(data["g"])))
    np.savez({result!r}, **out)
"""


def _run_jax(code: str, devices: int = 4) -> None:
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]


@pytest.fixture(scope="module")
def pipe_runs(tmp_path_factory):
    """Inputs, the JAX package's pipeline and compressed psum outputs on
    fake devices, and the port's on 2 and 4 ranks."""
    tmp = tmp_path_factory.mktemp("pipe")
    rng = np.random.default_rng(0)
    cfg = reduced(get_config(ARCH))
    inputs = {
        "affine2_w": np.array([3., .5], np.float32).reshape(2, 1),
        "affine2_b": np.array([-1., 2.], np.float32).reshape(2, 1),
        "affine2_x": np.arange(12, dtype=np.float32).reshape(4, 3),
        "affine4_w": np.array([2., 3., .5, 4.], np.float32).reshape(4, 1),
        "affine4_b": np.array([1., 0., 2., -1.], np.float32).reshape(4, 1),
        "affine4_x": np.arange(24, dtype=np.float32).reshape(6, 4),
        "model_x": rng.standard_normal((4, 1, 16, cfg.d_model)).astype(
            np.float32),
        "g": rng.standard_normal((4, 64)).astype(np.float32),
    }
    path = str(tmp / "inputs.npz")
    np.savez(path, **inputs)
    result = str(tmp / "jax.npz")
    _run_jax(_JAX_CODE.format(inputs=path, result=result))
    with np.load(result) as data:
        want = {k: data[k] for k in data.files}
    params = {f"model_{k.split('_')[1]}": v for k, v in want.items()
              if k.startswith("param_")}
    np.savez(path, **inputs, **params)
    worlds = {n: tmesh.spawn(workers.pipeline_world, n, path, timeout=240)
              for n in (2, 4)}
    port = {n: [r["pipeline"] for r in res] for n, res in worlds.items()}
    psum = [r["psum"] for r in worlds[4]]
    staged = [r["staged"] for r in worlds[2]]
    return inputs, want, port, psum, staged


@pytest.mark.parametrize("stages", [2, 4])
def test_pipeline_affine_matches_reference(pipe_runs, stages):
    inputs, want, port, _, _ = pipe_runs
    x = inputs[f"affine{stages}_x"]
    w, b = inputs[f"affine{stages}_w"], inputs[f"affine{stages}_b"]
    for s in range(stages):
        x = x * w[s] + b[s]
    for res in port[stages]:
        np.testing.assert_allclose(res["affine"], want[f"affine{stages}"],
                                   rtol=1e-6)
        np.testing.assert_allclose(res["affine"], x, rtol=1e-6)


def test_pipeline_model_matches_reference(pipe_runs):
    """A reduced StableLM split in two stages, 4 microbatches, f32."""
    _, want, port, _, _ = pipe_runs
    for res in port[2]:
        np.testing.assert_allclose(res["model"], want["model"], rtol=1e-5,
                                   atol=1e-5)


def test_compressed_psum_matches_reference(pipe_runs):
    inputs, want, _, psum, _ = pipe_runs
    mean = inputs["g"].mean(0)
    for rank, res in enumerate(psum):
        np.testing.assert_allclose(res["out"], want["psum"][rank],
                                   rtol=1e-6, atol=1e-7)
        scales = np.abs(inputs["g"]).max(1) / 127.0
        assert np.abs(res["out"] - mean).max() <= scales.mean()


def test_staged_route_matches_direct(pipe_runs):
    """The host-staged route (small pieces over the lanes) gives the
    direct route's bits and counts itself as a staged, routed call."""
    for res in pipe_runs[4]:
        assert res["equal"] == [True] * 5
        assert res["routes"] == {"host": 5}
        assert res["routed"] == {
            "collective: gloo stages through host": 5}
        assert res["staged_bytes"] == {"all_reduce": 148000,
                                       "broadcast": 2 * 148000,
                                       "all_gather": 148000,
                                       "sendrecv": 148000}


# ------------------------------------------------------------- the trainer
def _jax_losses(jcfg, jparams, loop):
    """The JAX package's loop, unmeshed: losses, grad norms, masters."""
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
    return losses, norms, [np.asarray(x) for x in jax.tree.leaves(params)]


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    """The JAX loop, the unmeshed train(), train(mesh=) on 2 ranks
    unbroken and halted at step 3, and its checkpoint resumed on 4 ranks
    and on 1 (this process, a one-rank mesh)."""
    tmp = tmp_path_factory.mktemp("train")
    jcfg = C.reduced(C.get_config(ARCH))
    jparams = jlm.init(jax.random.PRNGKey(0), jcfg)[0]
    path = str(tmp / "params.npz")
    np.savez(path, **{f"p{i}": np.asarray(x)
                      for i, x in enumerate(jax.tree.leaves(jparams))})
    tcfg = reduced(get_config(ARCH))
    loop = TrainLoopConfig(steps=5, seq_len=32, global_batch=4, log_every=1,
                           seed=0, peak_lr=3e-3, remat=True)
    jax_run = _jax_losses(jcfg, jparams, loop)
    params = convert.from_jax_params(jax.tree.map(np.asarray, jparams),
                                     tcfg, device="cpu",
                                     dtype=tcfg.parameter_dtype)
    unmeshed = train(tcfg, loop, device="cpu", params=params)
    ck = str(tmp / "ck")
    pairs = tmesh.spawn(workers.train_pair, 2, path, ck, timeout=300)
    two, halted = [p[0] for p in pairs], [p[1] for p in pairs]
    shutil.copytree(ck, ck + "1")       # each resume writes step 5
    resumed4 = tmesh.spawn(workers.train_case, 4, path, 5, ck, timeout=300)
    one = workers.train_case(0, 1, path, 5, ck + "1")
    return {"jax": jax_run, "unmeshed": unmeshed, "two": two,
            "halted": halted, "resumed4": resumed4, "resumed1": one}


def test_train_mesh_replicas_are_equal(train_runs):
    """train(mesh=) on 2 ranks: the same metrics and gathered masters bit
    for bit on both ranks (each step's master digests, of the gathered
    masters, in the history among them), one compile, every rank's masters
    and moments its ``data`` block (FSDP)."""
    a, b = train_runs["two"]
    assert a["history"] == b["history"]
    assert [len(h["masters_digest"]) for h in a["history"]] == \
        [len(a["params"])] * 5
    assert a["history"][-1]["masters_digest"] == [
        int(np.asarray(p).view(np.int32).sum(dtype=np.int64))
        for p in a["params"]]
    for x, y in zip(a["params"], b["params"]):
        assert np.array_equal(x, y)
    assert a["engine"]["misses"] == 1 and a["engine"]["hits"] == 4
    assert a["local_shapes"] == a["m_shapes"] == b["local_shapes"]
    full = [p.shape for p in a["params"]]
    halved = [s for s, f in zip(a["m_shapes"], full) if s != f]
    assert halved and all(s[-1] * 2 == f[-1] or s[-2] * 2 == f[-2]
                          for s, f in zip(a["m_shapes"], full) if s != f)


def test_masters_digest_sees_one_element():
    """One checksum a master, of its bits: a copy digests the same, one
    element one ulp off changes its own leaf's digest only."""
    from repro_torch.launch.train import masters_digest
    gen = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(8, 5, generator=gen),
              "b": torch.randn(7, generator=gen).to(torch.bfloat16)}
    want = masters_digest(params)
    copy = {k: v.clone() for k, v in params.items()}
    assert masters_digest(copy) == want
    copy["b"].view(torch.int16)[3] += 1         # one ulp
    assert copy["b"][3] != params["b"][3]
    got = masters_digest(copy)
    assert got[0] == want[0] and got[1] != want[1]


def test_train_mesh_collectives_in_order(train_runs):
    """Every rank's dispatched step issues the same collectives in the
    same order, each of them kept from the traced graph: every gradient
    summed (an all-reduce, or the reduce-scatter of an FSDP gather's
    backward), the split masters gathered."""
    a, b = train_runs["two"]
    assert a["collectives"] == b["collectives"] and a["collectives"][0]
    assert [len(c) for c in a["collectives"]] == a["traced_collectives"]
    ops_ = [op for op, _ in a["collectives"][0]]
    assert ops_.count("_all_reduce_impl") + \
        ops_.count("_reduce_scatter_impl") >= len(a["params"])
    assert "_param_gather_impl" in ops_


def test_train_mesh_matches_unmeshed_and_jax(train_runs):
    """Losses and grad norms within rtol 1e-4 of the unmeshed train() and
    of the JAX loop; masters within 2e-4."""
    hist = train_runs["two"][0]["history"]
    want_loss, want_norm, want_params = train_runs["jax"]
    un = train_runs["unmeshed"]["history"]
    for ref_loss, ref_norm in (([h["loss"] for h in un],
                                [h["grad_norm"] for h in un]),
                               (want_loss, want_norm)):
        np.testing.assert_allclose([h["loss"] for h in hist], ref_loss,
                                   rtol=1e-4)
        np.testing.assert_allclose([h["grad_norm"] for h in hist], ref_norm,
                                   rtol=1e-4)
    for got, un_p, want in zip(train_runs["two"][0]["params"],
                               leaves(train_runs["unmeshed"]["params"]),
                               want_params):
        np.testing.assert_allclose(got, un_p.numpy(), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_checkpoint_resumes_elastically(train_runs):
    """Saved on 2 ranks at step 3 (halted), resumed on 4 ranks and on 1:
    steps 4-5 within the tolerances above of the unbroken 2-rank run,
    the 4 ranks' masters equal among themselves."""
    unbroken = train_runs["two"][0]
    halted = train_runs["halted"][0]
    assert halted["history"] == unbroken["history"][:3]
    for resumed in (train_runs["resumed4"][0], train_runs["resumed1"]):
        assert len(resumed["history"]) == 2
        np.testing.assert_allclose(
            [h["loss"] for h in resumed["history"]],
            [h["loss"] for h in unbroken["history"][3:]], rtol=1e-4)
        for got, want in zip(resumed["params"], unbroken["params"]):
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    for other in train_runs["resumed4"][1:]:
        for x, y in zip(other["params"], train_runs["resumed4"][0]["params"]):
            assert np.array_equal(x, y)


def test_init_mesh_chooses_its_backend_once(monkeypatch):
    """nccl when every rank on the host has a card of its own, gloo when
    ranks share one or run on the CPU."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cuda = torch.device("cuda", 0)
    assert tmesh._choose_backend(torch.device("cpu"), 1) == "gloo"
    assert tmesh._choose_backend(cuda, 1) == "nccl"
    assert tmesh._choose_backend(cuda, 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tmesh._choose_backend(cuda, 4) == "nccl"
