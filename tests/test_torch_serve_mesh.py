"""Serving on a mesh: ``launch.common``'s prefill and decode cells under
the rules (:mod:`repro_torch.launch.common`), with decode context
parallelism (:mod:`repro_torch.distributed.context_parallel`), against the
port's unmeshed ``lm.prefill`` / ``lm.decode_step`` and the JAX package's.

Ranks are spawned here (CPU, ``gloo``, plain versions; the rank functions
are ``serve_*`` in ``tests/torch_dist_workers.py``), in threads, while the
references run in this process:

* every reduced family -- StableLM, Mistral-NeMo, Qwen3, RecurrentGemma,
  xLSTM, musicgen, InternVL, the recurrent ones at the tensor-parallel
  test's short patterns -- prefills 16 positions and decodes 4 tokens on 2
  x 1 (data parallel) and 1 x 2 (tensor parallel; RecurrentGemma's one KV
  head puts its ring's slots over ``model``: context parallelism);
* RecurrentGemma on 1 x 2 with a ring that wraps, with a prompt that
  leaves rank 1 empty, and with a ring the line does not divide;
* the reference's own context-parallel case, the reduced Nemo (4 heads, 2
  KV heads) on 1 x 4, also against the JAX ``build_cell(kind="decode")``
  run in a subprocess on 4 fake CPU devices; StableLM on 2 x 2.

Tolerance: logits and states within rtol = atol = 2e-4 (the float32
parity tests' ``TOL``, ``tests/test_torch_tensor_parallel.py``): the
meshed runs differ from the unmeshed only in the order of float32 partial
sums (they read ~2e-6).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as C
import repro.configs.base as jbase
import torch_dist_workers as workers
from repro.models import lm as jlm
from repro.models.layers import Runtime
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import context_parallel as cp
from repro_torch.distributed.sharding import spec_tree_to_shardings
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as kdecode
from repro_torch.kernels import ref
from repro_torch.launch import common
from repro_torch.models import lm
from repro_torch.models.attention import WHOLE_CACHE_REASON
from repro_torch.tree import leaves

TOL = dict(rtol=2e-4, atol=2e-4)
FAMILIES = list(workers.TP_FAMILIES)
MESHES = [(2, 1), (1, 2)]


def _jax_config(arch):
    return dataclasses.replace(C.reduced(C.get_config(arch)),
                               **workers.TP_FAMILIES.get(arch, {}))


def _jax_serve(jcfg, jparams, data, cache_size):
    """The JAX package's prefill and decode steps: logits a step."""
    first = {k: jnp.asarray(v) for k, v in data.items()
             if not k.startswith("step_")}
    key = "embeds" if "step_embeds" in data else "tokens"
    prefill = jax.jit(lambda p, b: jlm.prefill(p, jcfg, Runtime(), b,
                                               cache_size=cache_size))
    decode = jax.jit(lambda p, s, c, b: jlm.decode_step(p, s, c, jcfg,
                                                        Runtime(), b))
    logits, state, clen = prefill(jparams, first)
    out = [np.asarray(logits)]
    for x in data["step_" + key]:
        logits, state, clen = decode(jparams, state, clen,
                                     {key: jnp.asarray(x)})
        out.append(np.asarray(logits))
    return out


_JAX_CELL = """
import dataclasses
import jax, jax.numpy as jnp, numpy as np
import repro.configs as C
from repro.configs.base import ShapeConfig
from repro.launch.common import DECODE_MARGIN, build_cell
from repro.models import lm
from repro.models.layers import Runtime

cfg = C.reduced(C.get_config("mistral-nemo-12b"))
params = lm.init(jax.random.PRNGKey(0), cfg)[0]
with np.load({data!r}) as f:
    data = {{k: f[k] for k in f.files}}
shape = ShapeConfig("nemo_decode", {seq_len}, 2, "decode")
mesh = jax.make_mesh((1, 4), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
fn, _ = build_cell(cfg, shape, mesh)
logits, state, clen = lm.prefill(params, cfg, Runtime(),
                                 {{"tokens": jnp.asarray(data["tokens"])}},
                                 cache_size={seq_len} + DECODE_MARGIN)
out = [np.asarray(logits)]
with mesh:
    for tok in data["step_tokens"]:
        logits, state, clen = fn(params, state, clen,
                                 {{"tokens": jnp.asarray(tok)}})
        out.append(np.asarray(logits))
np.savez({result!r}, *out)
"""


def _start_jax_cell(data_path, result):
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    code = _JAX_CELL.format(data=data_path, result=result,
                            seq_len=workers.NEMO_CP["seq_len"])
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


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


def _cases():
    """name -> (arch, prompt, decode steps)."""
    out = {arch: (arch, workers.SERVE_PROMPT, workers.SERVE_STEPS)
           for arch in FAMILIES}
    for case, (prompt, steps) in workers.RG_CP_CASES.items():
        out[f"rg {case}"] = ("recurrentgemma-2b", prompt, steps)
    return out


@pytest.fixture(scope="module")
def serve_runs(tmp_path_factory):
    """Both spawned worlds and the JAX cell's subprocess, and meanwhile
    here the JAX package's and the port's unmeshed runs of every case."""
    tmp = tmp_path_factory.mktemp("serve")
    inputs, refs = {}, {}
    for name, (arch, prompt, steps) in _cases().items():
        jcfg = _jax_config(arch)
        tcfg = workers.tp_config(arch)
        jparams = jlm.init(jax.random.PRNGKey(0), jcfg)[0]
        params = convert.from_jax_params(jax.tree.map(np.asarray, jparams),
                                         tcfg, device="cpu",
                                         dtype=tcfg.parameter_dtype)
        ppath, dpath = str(tmp / f"{arch}.npz"), str(tmp / f"{name}.d.npz")
        np.savez(ppath, **{f"p{i}": p.numpy()
                           for i, p in enumerate(leaves(params))})
        data = workers.serve_inputs(tcfg, prompt, steps)
        np.savez(dpath, **data)
        inputs[name] = (ppath, dpath)
        refs[name] = (jcfg, jparams, tcfg, params, data,
                      prompt + common.DECODE_MARGIN)
    nemo = workers.tp_config("mistral-nemo-12b")
    ndata = workers.serve_inputs(nemo, workers.NEMO_CP["prompt"],
                                 workers.NEMO_CP["steps"])
    npath = str(tmp / "nemo_cp.d.npz")
    np.savez(npath, **ndata)
    cell_out = str(tmp / "jax_cell.npz")
    proc = _start_jax_cell(npath, cell_out)
    worlds = {}
    threads = [
        _spawn_in_thread(worlds, 2, workers.serve_world, 2, inputs,
                         timeout=600),
        _spawn_in_thread(worlds, 4, workers.serve_world4, 4,
                         inputs["mistral-nemo-12b"][0], npath,
                         inputs["stablelm-1.6b"][0], timeout=600)]
    out = {"jax": {}, "unmeshed": {}}
    try:
        for name, (jcfg, jparams, tcfg, params, data, cache) in refs.items():
            out["jax"][name] = _jax_serve(jcfg, jparams, data, cache)
            out["unmeshed"][name] = [x.numpy() for x in workers.serve_unmeshed(
                tcfg, params, data, cache)[0]]
        _, nj, _, nparams, _, _ = refs["mistral-nemo-12b"]
        cache = workers.NEMO_CP["seq_len"] + common.DECODE_MARGIN
        out["jax"]["nemo cp"] = _jax_serve(_jax_config("mistral-nemo-12b"),
                                           nj, ndata, cache)
        out["unmeshed"]["nemo cp"] = [x.numpy() for x in
                                      workers.serve_unmeshed(
                                          nemo, nparams, ndata, cache)[0]]
        stable = refs["stablelm-1.6b"][3]
        scfg = workers.tp_config("stablelm-1.6b")
        sdata = workers.serve_inputs(scfg, workers.SERVE_PROMPT,
                                     workers.SERVE_STEPS)
        out["unmeshed"]["stablelm 2x2"] = [
            x.numpy() for x in workers.serve_unmeshed(
                scfg, stable, sdata,
                workers.SERVE_PROMPT + common.DECODE_MARGIN)[0]]
        _, err = proc.communicate(timeout=300)
    finally:
        for t in threads:
            t.join()
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err[-3000:]
    for w in worlds.values():
        if isinstance(w, BaseException):
            raise w
    with np.load(cell_out) as f:
        out["jax cell"] = [f[k] for k in sorted(f.files,
                                                key=lambda k: int(k[4:]))]
    out["two"], out["four"] = worlds[2], worlds[4]
    return out


def _rows(run, sizes, x):
    """The rows of a global (B, ...) array a rank of a ``sizes`` mesh
    holds."""
    b = x.shape[0] // sizes[0]
    r = run["coords"]["data"]
    return x[r * b:(r + 1) * b]


def _hold(run, sizes, refs):
    for ref_logits in refs:
        assert len(run["logits"]) == len(ref_logits)
        for got, want in zip(run["logits"], ref_logits):
            np.testing.assert_allclose(got, _rows(run, sizes,
                                                  np.asarray(want)), **TOL)
    for got, want in zip(run["state"], run["unmeshed_state"]):
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("sizes", MESHES, ids=["2x1", "1x2"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_matches_unmeshed_and_jax(serve_runs, arch, sizes):
    """Every rank's logits rows after the prefill and each decode step,
    against the port's unmeshed run and the JAX package's; every rank's
    final state against the unmeshed state's blocks; the parameters laid
    out alike under the prefill and decode rules."""
    for rank in serve_runs["two"]:
        run = rank[(arch, sizes)]
        _hold(run, sizes, [serve_runs["unmeshed"][arch],
                           serve_runs["jax"][arch]])
        assert run["same_params"]
        assert not run["routed"]
        np.testing.assert_array_equal(
            run["cache_len"], workers.SERVE_PROMPT + workers.SERVE_STEPS
            + workers.tp_config(arch).num_vision_tokens)


@pytest.mark.parametrize("case", list(workers.RG_CP_CASES))
def test_recurrentgemma_context_parallel(serve_runs, case):
    """RecurrentGemma on 1 x 2 (4 heads over model, 1 KV head: its ring's
    slots over model): a ring that wraps, rank 1 empty at first, and a ring
    of 31 slots that the line leaves whole (counted under
    WHOLE_CACHE_REASON)."""
    name = f"rg {case}"
    for rank in serve_runs["two"]:
        run = rank[(name, (1, 2))]
        _hold(run, (1, 2), [serve_runs["unmeshed"][name],
                            serve_runs["jax"][name]])
        routed = run["routed"].get(WHOLE_CACHE_REASON, 0)
        steps = workers.RG_CP_CASES[case][1]
        assert routed == (steps if case == "odd" else 0)


def test_each_rank_holds_its_slots(serve_runs):
    """Under context parallelism each rank's ring holds its Smax/model
    slots, split along the cache's sequence over model, and the ranks'
    slices side by side are the unmeshed ring: each slot written by its
    owner alone (a rank that wrote another's slot would hold it at its own
    local slot)."""
    ranks = serve_runs["two"]
    for case, (prompt, _) in workers.RG_CP_CASES.items():
        if case == "odd":
            continue
        runs = [r[(f"rg {case}", (1, 2))] for r in ranks]
        slots = min(32, prompt + common.DECODE_MARGIN)
        k = 4           # the local layer's "k" (after two RG-LRU states)
        assert runs[0]["state_split"][k] == [(3, ("model",))]
        assert [r["state"][k].shape[3] for r in runs] == [slots // 2] * 2
        whole = np.concatenate([r["unmeshed_state"][k] for r in runs], 3)
        got = np.concatenate([r["state"][k] for r in runs], 3)
        np.testing.assert_allclose(got, whole, **TOL)
        assert np.abs(whole).sum() > 0


def test_recurrent_states_equal_the_unmeshed(serve_runs):
    """The RG-LRU's h and conv_tail are each rank's channel block; the
    xLSTM's mLSTM (C, n, m) and sLSTM states are whole on every rank and
    equal the unmeshed ones."""
    for rank in serve_runs["two"]:
        rg = rank[("recurrentgemma-2b", (1, 2))]
        # conv_tail, h of each RG-LRU layer; the local layer's k, v
        assert rg["state_split"] == [[(3, ("model",))], [(2, ("model",))]] \
            * 2 + [[(3, ("model",))]] * 2
        xl = rank[("xlstm-1.3b", (1, 2))]
        # mlstm c, conv_tail, m, n; slstm c, h, m, n
        assert [bool(s) for s in xl["state_split"]] == [
            False, True, False, False, False, False, False, False]
        for got, want in zip(xl["state"], xl["unmeshed_state"]):
            np.testing.assert_allclose(got, want, **TOL)


def test_moe_steps_reach_the_expert_split(serve_runs):
    """Qwen3's prefill and decode steps run ``moe_ffn`` on 2 of its 4
    experts a rank on 1 x 2 (all 4 on 2 x 1), the router whole."""
    for rank in serve_runs["two"]:
        assert rank[("qwen3-moe-30b-a3b", (1, 2))]["experts"] == [
            ((2, 64, 64), (64, 4))]
        assert rank[("qwen3-moe-30b-a3b", (2, 1))]["experts"] == [
            ((4, 64, 64), (64, 4))]


def test_nemo_context_parallel_matches_the_jax_cell(serve_runs):
    """The reference's context-parallel case: the reduced Nemo's decode on
    1 x 4 (4 heads over model, 2 KV heads, so each rank holds 8 of the 32
    slots), against the JAX ``build_cell`` decode cell on 4 fake devices,
    the JAX package's unmeshed steps and the port's."""
    cell = serve_runs["jax cell"]
    for rank in serve_runs["four"]:
        run = rank["nemo"]
        assert run["state_split"] == [[(3, ("model",))]] * 2
        _hold(run, (1, 4), [serve_runs["unmeshed"]["nemo cp"],
                            serve_runs["jax"]["nemo cp"]])
        for got, want in zip(run["logits"][1:], cell[1:]):
            np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(run["logits"][0], cell[0], **TOL)


def test_stablelm_on_2x2(serve_runs):
    """Batch over data, heads and KV heads over model."""
    for rank in serve_runs["four"]:
        run = rank["stablelm 2x2"]
        assert run["state_split"] == [[(1, ("data",)), (2, ("model",))]] * 2
        _hold(run, (2, 2), [serve_runs["unmeshed"]["stablelm 2x2"]])


class _FakeMesh:
    """What the layouts read of a mesh, for one rank of a grid."""

    def __init__(self, sizes, rank):
        self.axis_names = ("data", "model")
        self.shape = dict(zip(self.axis_names, sizes))
        self.coords = {"data": rank // sizes[1], "model": rank % sizes[1]}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_build_cell_abstract_shapes(serve_runs, kind):
    """``build_cell(abstract=True)`` on 2 x 2: every argument a ``meta``
    tensor of this rank's shape under the cell's layouts."""
    cfg = workers.tp_config("stablelm-1.6b")
    shape = ShapeConfig(kind, 32, 4, kind)
    for r, rank in enumerate(serve_runs["four"]):
        mesh = _FakeMesh((2, 2), r)
        rules = common.cell_rules(cfg, shape, mesh)
        if kind == "train":
            layout = _train_layout(cfg, mesh, rules)
        else:
            layout = common.param_layout(cfg, rules, mesh)
        aparams = common.abstract_params(cfg)
        want = [sh.local_shape(p.shape) for p, sh in zip(
            leaves(aparams), leaves(layout))]
        if kind == "train":
            want = want + want + [()] + want    # masters; m, step, v
        if kind == "decode":
            st = common.decode_state_abstract(cfg, shape)
            want += [sh.local_shape(t.shape) for t, sh in zip(
                leaves(st), leaves(common.state_layout(cfg, shape, rules,
                                                       mesh)))]
            want += [(2,)]
        batch = common.batch_abstract(cfg, shape)[0]
        want += [(2,) + tuple(t.shape[1:]) for t in leaves(batch)]
        got = rank["cells"][kind]
        assert {d for _, d in got} == {"meta"}
        assert [s for s, _ in got] == want


def _train_layout(cfg, mesh, rules):
    """``MeshPlan.layout`` of a 2 x 2 mesh, from the same rules."""
    from repro_torch.distributed.sharding import logical_to_spec
    from repro_torch.tree import tree_map
    specs = logical_to_spec(lm.param_specs(cfg), rules, mesh.axis_names)
    aparams = common.abstract_params(cfg)
    laid = spec_tree_to_shardings(mesh, specs, like=aparams,
                                  groups=lm.param_groups(cfg))
    tpl = tree_map(lambda sh: sh.only(("model",)), laid)
    local = tree_map(lambda p, sh: torch.empty(sh.local_shape(p.shape),
                                               device="meta"), aparams, tpl)
    data = tree_map(lambda sh: sh.only(("data",)), spec_tree_to_shardings(
        mesh, specs, like=local))
    return tree_map(lambda a, b: a.with_splits(b), tpl, data)


def test_decode_cell_draws_this_ranks_blocks(serve_runs):
    """A drawn decode cell on 1 x 4: its parameters are bit for bit the
    blocks of ``lm.init``'s whole ones, its state zero and its blocks'
    shapes, cache_len 0, one token a row."""
    for rank in serve_runs["four"]:
        drawn = rank["drawn"]
        assert drawn["equal"] and drawn["split"] > 0
        assert all(total == 0.0 for _, total in drawn["state"])
        assert [s for s, _ in drawn["state"]][:2] == [(1, 4, 3, 16),
                                                      (1, 4, 16)]
        np.testing.assert_array_equal(drawn["cache_len"], 0)
        assert drawn["batch"].shape == (4, 1)


# --------------------------------------------------------------------------
# The pieces, without ranks
# --------------------------------------------------------------------------
def _cache_case(b=3, hq=4, hkv=2, d=16, smax=24, seed=0):
    rng = np.random.default_rng(seed)

    def rn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return rn(b, hq, d), rn(b, hkv, smax, d), rn(b, hkv, smax, d)


@pytest.mark.parametrize("lens", [[0, 1, 24], [5, 13, 0], [24, 24, 7]])
def test_decode_attention_lse_closed_form(lens):
    """``decode_attention_ref(return_lse=True)``: out (unrounded) and lse
    against the closed form in float64; lse = -inf and out = 0 at length
    0; out equals the rounded entry's."""
    q, k, v = _cache_case()
    cache_len = torch.tensor(lens)
    out, lse = ref.decode_attention_ref(q, k, v, cache_len, return_lse=True)
    assert out.dtype == lse.dtype == torch.float32
    g = q.shape[1] // k.shape[1]
    for b, n in enumerate(lens):
        for h in range(q.shape[1]):
            kk = k[b, h // g, :n].double()
            s = (kk @ q[b, h].double()) * q.shape[-1] ** -0.5
            if n == 0:
                assert lse[b, h] == -np.inf
                assert torch.all(out[b, h] == 0)
                continue
            want_lse = torch.logsumexp(s, 0)
            want = torch.softmax(s, 0) @ v[b, h // g, :n].double()
            np.testing.assert_allclose(lse[b, h].item(), want_lse.item(),
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(out[b, h].numpy(), want.numpy(),
                                       rtol=1e-5, atol=1e-6)
    plain = ref.decode_attention_ref(q, k, v, cache_len)
    torch.testing.assert_close(out, plain, rtol=0, atol=0)


@pytest.mark.parametrize("parts", [2, 3, 4])
@pytest.mark.parametrize("window", [None, 24])
def test_merge_of_the_slices_equals_the_whole(parts, window):
    """Each rank's slice of the slots through ``return_lse`` with its
    ``local_lengths``, then ``fold`` in rank order: the whole cache's
    attention, rows with no key in a slice included."""
    q, k, v = _cache_case()
    pos = torch.tensor([0, 9, 40])          # rank 1.. empty; a full ring
    smax = k.shape[2]
    valid = (pos + 1).clamp(max=smax) if window else pos + 1
    lens = cp.local_lengths(pos, smax, window, parts)
    local = smax // parts
    assert torch.equal(lens.sum(0), valid.clamp(max=smax))
    assert int(lens.max()) <= local
    pairs = [ref.decode_attention_ref(q, k[:, :, r * local:(r + 1) * local],
                                      v[:, :, r * local:(r + 1) * local],
                                      lens[r], return_lse=True)
             for r in range(parts)]
    got = cp.fold([o for o, _ in pairs], [l for _, l in pairs])
    want, _ = ref.decode_attention_ref(q, k, v, valid, return_lse=True)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_slot_owner_gives_each_slot_one_rank():
    """Every global slot has one owner and one local slot, and the owners'
    blocks in rank order are the slots in order."""
    slot = torch.arange(32)
    owner, at = cp.slot_owner(slot, 8)
    assert torch.equal(owner * 8 + at, slot)
    assert torch.equal(torch.bincount(owner), torch.full((4,), 8))


def test_lse_wrapper_on_a_card_tensor_launches(monkeypatch):
    """``decode_attention(return_lse=True)`` on a tensor the wrapper takes
    for a card's launches the C entry with the f32 output and the lse in
    place of the rounded output, counts the ``lse`` route, and never runs
    the plain version."""
    calls = []

    class Lib:
        def paged_decode_attention_launch(self, *args):
            calls.append(args)
            return 0

    def plain(*a, **kw):
        raise AssertionError("the plain version ran for a card tensor")

    monkeypatch.setattr(kdecode, "_lib", lambda: Lib())
    monkeypatch.setattr(kdecode, "decode_attention_ref", plain)
    monkeypatch.setattr(_build, "on_card", lambda name, t: True)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: __import__("contextlib").nullcontext())
    q, k, v = (t.to(torch.bfloat16) for t in _cache_case(d=64, smax=64))
    before = dict(kdecode.ROUTES)
    out, lse = kdecode.decode_attention(q, k, v, torch.tensor([0, 3, 64]),
                                        return_lse=True)
    assert out.dtype == lse.dtype == torch.float32
    assert out.shape == q.shape and lse.shape == q.shape[:2]
    (args,) = calls
    assert args[6] is None                  # no rounded output
    assert args[-2] == out.data_ptr() and args[-1] == lse.data_ptr()
    assert kdecode.ROUTES["lse"] == before["lse"] + 1
    kdecode.decode_attention(q, k, v, torch.tensor([0, 3, 64]))
    assert calls[-1][-2:] == (None, None) and calls[-1][6] is not None
    assert kdecode.ROUTES["out"] == before["out"] + 1


def test_shape_configs_equal_the_reference():
    """``ShapeConfig``, ``SHAPES``, ``ARCH_IDS`` and ``applicable_shapes``
    as the JAX package's."""
    assert set(tconfigs.SHAPES) == set(jbase.SHAPES)
    for name, shape in jbase.SHAPES.items():
        assert dataclasses.asdict(tconfigs.SHAPES[name]) == \
            dataclasses.asdict(shape)
    assert tconfigs.ARCH_IDS == jbase.ARCH_IDS
    for arch in jbase.ARCH_IDS:
        assert tconfigs.applicable_shapes(tconfigs.get_config(arch)) == \
            jbase.applicable_shapes(C.get_config(arch))


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "xlstm-1.3b",
                                  "mistral-nemo-12b"])
def test_state_layouts(arch):
    """On a 2 x 2 grid's rank 3: ``init_state(layout=)`` is the blocks of
    the whole zero state (the sLSTM's n at 1e-6 included);
    ``relayout_state`` from the prefill rules' layout to the decode rules'
    is the decode layout's blocks of the whole state, and refuses a split
    the target lacks."""
    cfg = workers.tp_config(arch)
    mesh = _FakeMesh((2, 2), 3)
    pshape, dshape = (ShapeConfig(kind, 16, 4, kind)
                      for kind in ("prefill", "decode"))
    src = common.state_layout(cfg, pshape, common.cell_rules(
        cfg, pshape, mesh), mesh)
    dst = common.state_layout(cfg, dshape, common.cell_rules(
        cfg, dshape, mesh), mesh)
    cache = 16 + common.DECODE_MARGIN
    whole = lm.init_state(cfg, 4, cache, device="cpu")
    for t in leaves(whole):
        t.copy_(torch.randn(t.shape))
    for layout in (src, dst):
        zero = lm.init_state(cfg, 4, cache, device="cpu", layout=layout)
        want = convert.state_blocks(lm.init_state(cfg, 4, cache,
                                                  device="cpu"), layout)
        for a, b in zip(leaves(zero), leaves(want)):
            assert torch.equal(a, b)
    moved = convert.relayout_state(convert.state_blocks(whole, src), src,
                                   dst)
    for a, b in zip(leaves(moved), leaves(convert.state_blocks(whole, dst))):
        assert torch.equal(a, b)
    if any(sh.splits != sd.splits for sh, sd in zip(leaves(src),
                                                     leaves(dst))):
        with pytest.raises(ValueError, match="needs a gather"):
            convert.relayout_state(convert.state_blocks(whole, dst), dst,
                                   src)
