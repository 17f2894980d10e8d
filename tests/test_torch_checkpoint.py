"""The port's checkpointing (``repro_torch.checkpoint``), data cursor and
resume, on the CPU.

* Mirrors of the reference manager's cases (``tests/test_checkpoint.py``)
  on torch trees; the reference's sharded restore becomes a restore onto
  the ``like`` tree's devices and dtypes.
* One format: a checkpoint written by either package is read by the
  other (``arrays.npz`` + ``manifest.json``, JAX's path keys).
* ``PipelineState`` round trips, and ``DataPipeline(state=...)`` resumes
  at its cursor.
* ``train()`` halted at step 10 and resumed equals an unbroken 20-step
  run ``torch.equal`` (the reference's ``test_resume_is_bit_exact`` asks
  1e-6; the plain versions on the CPU are deterministic).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JaxManager
from repro.data import pipeline as jpipe
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import (DataConfig, DataPipeline,
                                       PipelineState, make_batch)
from repro_torch.launch.train import TrainLoopConfig, train
from repro_torch.tree import leaves


def _tree(step=0):
    return {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4) + step,
            "stats": {"count": torch.tensor(step, dtype=torch.int32),
                      "scale": torch.tensor(1.5 + step)}}


def _assert_tree_equal(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ===========================================================================
# Mirrors of tests/test_checkpoint.py
# ===========================================================================
@pytest.mark.parametrize("async_save", [False, True])
def test_save_restore(tmp_path, async_save):
    mgr = CheckpointManager(tmp_path, async_save=async_save)
    tree = _tree(step=7)
    mgr.save(7, tree)
    mgr.wait()
    step, restored = mgr.restore(_tree())
    assert step == 7
    _assert_tree_equal(restored, tree)


def test_restore_specific_step(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=5, async_save=False)
    for s in (1, 2, 3):
        mgr.save(s, _tree(step=s))
    step, restored = mgr.restore(_tree(), step=2)
    assert step == 2
    _assert_tree_equal(restored, _tree(step=2))


@pytest.mark.parametrize("host", ["tensor", "numpy"])
def test_async_save_snapshots_before_mutation(tmp_path, host):
    """The host copy is taken before save() returns: overwriting the
    tensor in place right after (as the trainer's step does) must not
    reach the checkpoint."""
    mgr = CheckpointManager(tmp_path, async_save=True)
    w = torch.ones(4) if host == "tensor" else np.ones((4,), np.float32)
    mgr.save(1, {"w": w})
    w[:] = -1.0
    mgr.wait()
    _, restored = mgr.restore({"w": torch.zeros(4)})
    assert torch.equal(restored["w"], torch.ones(4))


def test_restore_onto_the_like_trees_devices_and_dtypes(tmp_path):
    """The counterpart of the reference's sharded restore: each tensor leaf
    comes back on its ``like`` leaf's device and in its dtype; a leaf that
    is no tensor (the data cursor) as a numpy array."""
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(3, {**_tree(step=3), "data": {"next_step": 5}})
    like = {**_tree(), "data": {"next_step": 0}}
    like["w"] = like["w"].to(torch.float64)
    _, restored = mgr.restore(like)
    assert restored["w"].dtype == torch.float64
    assert restored["w"].device == like["w"].device
    assert torch.equal(restored["w"], _tree(3)["w"].double())
    assert isinstance(restored["data"]["next_step"], np.ndarray)
    assert PipelineState.from_dict(restored["data"]).next_step == 5
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({**like, "w": torch.zeros(4, 3)})


def test_rename_is_atomic_no_tmp_left(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=True)
    for s in range(3):
        mgr.save(s, _tree(step=s))
    mgr.wait()
    assert [p for p in os.listdir(tmp_path) if p.startswith("tmp.")] == []
    assert sorted(os.listdir(tmp_path)) == ["step_0", "step_1", "step_2"]


def test_gc_keeps_last_n(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=False)
    for s in range(5):
        mgr.save(s, _tree(step=s))
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_latest_survives_manager_restart(tmp_path):
    CheckpointManager(tmp_path, async_save=False).save(11, _tree(11))
    fresh = CheckpointManager(tmp_path, async_save=False)
    step, restored = fresh.restore(_tree())
    assert step == 11
    _assert_tree_equal(restored, _tree(11))


def test_restore_empty_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path, async_save=False).restore(_tree())


def test_restore_missing_leaf_raises_keyerror(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(1, {"w": torch.ones(2)})
    with pytest.raises(KeyError):
        mgr.restore({"w": torch.zeros(2), "extra": torch.zeros(2)})


def test_corrupt_tmp_does_not_break_restore(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(7, {"w": torch.ones(4)})
    os.makedirs(tmp_path / "tmp.8")          # a crash mid-save
    (tmp_path / "tmp.8" / "garbage").write_text("x")
    assert mgr.latest_step() == 7
    assert mgr.restore({"w": torch.zeros(4)})[0] == 7


# ===========================================================================
# One format for both packages
# ===========================================================================
def _np_state(seed=0):
    """A trainer-shaped state: nested dicts, a tuple of blocks, an int32
    step and the data cursor."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"params": {"blocks": ({"wq": f(2, 4, 4), "norm": f(2, 4)},
                                  {"wq": f(2, 4, 4), "norm": f(2, 4)}),
                       "head": {"w": f(4, 8)}},
            "opt": {"m": {"head": {"w": f(4, 8)}},
                    "step": np.array(3, np.int32)},
            "data": {"next_step": 9}}


def _as(tree, fn):
    if isinstance(tree, dict):
        return {k: _as(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_as(v, fn) for v in tree)
    return fn(tree)


def _numpy_leaves(tree):
    return [np.asarray(x) for x in leaves(_as(tree, np.asarray))]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_either_package_reads_the_others_checkpoint(tmp_path, writer):
    state = _np_state()
    port_tree = _as(state, lambda x: torch.from_numpy(np.array(x))
                    if isinstance(x, np.ndarray) else x)
    jax_tree = _as(state, lambda x: jnp.asarray(x)
                   if isinstance(x, np.ndarray) else x)
    port, ref = (CheckpointManager(tmp_path, async_save=False),
                 JaxManager(str(tmp_path), async_save=False))
    if writer == "port":
        port.save(4, port_tree)
        step, got = ref.restore(_as(jax_tree, lambda x: x))
        got_leaves = [np.asarray(x) for x in jax.tree.leaves(got)]
    else:
        ref.save(4, jax_tree)
        zeros = _as(port_tree, lambda x: torch.zeros_like(x)
                    if isinstance(x, torch.Tensor) else 0)
        step, got = port.restore(zeros)
        got_leaves = [x.numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x) for x in leaves(got)]
    assert step == 4
    want = _numpy_leaves(state)
    assert len(got_leaves) == len(want)
    for g, w in zip(got_leaves, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    with open(tmp_path / "step_4" / "manifest.json") as fh:
        keys = sorted(json.load(fh)["leaves"])
    assert "params/blocks/1/wq" in keys and "data/next_step" in keys


# ===========================================================================
# The data cursor
# ===========================================================================
def test_pipeline_state_round_trips_as_the_jax_one():
    st = PipelineState(next_step=17)
    assert st.to_dict() == jpipe.PipelineState(next_step=17).to_dict()
    assert PipelineState.from_dict(st.to_dict()) == st
    assert PipelineState.from_dict({"next_step": np.int64(4)}).next_step == 4


def test_pipeline_resumes_at_its_cursor():
    cfg = DataConfig(256, 16, 2, seed=3)
    pipe = DataPipeline(cfg, device="cpu", state=PipelineState(5))
    for step in (5, 6):
        got = next(pipe)
        np.testing.assert_array_equal(got["tokens"].numpy(),
                                      make_batch(cfg, step)["tokens"])
    assert pipe.state.next_step == 7


# ===========================================================================
# train(): checkpoints, halt and resume
# ===========================================================================
@pytest.mark.parametrize("grad_compression", [False, True])
def test_resume_is_bit_exact(tmp_path, grad_compression):
    """20 straight steps == halt at 10 + restore + 10, torch.equal; both
    runs have the same 20-step configuration (the schedule and the data
    keyed off the global step)."""
    cfg = reduced(get_config("stablelm-1.6b"))
    base = dict(steps=20, seq_len=32, global_batch=4, log_every=1,
                checkpoint_every=100, grad_compression=grad_compression)
    out_a = train(cfg, TrainLoopConfig(checkpoint_dir=str(tmp_path / "a"),
                                       **base), device="cpu")
    d = str(tmp_path / "b")
    halted = train(cfg, TrainLoopConfig(checkpoint_dir=d, halt_at_step=10,
                                        **base), device="cpu")
    assert [h["step"] for h in halted["history"]] == list(range(1, 11))
    assert CheckpointManager(d).all_steps() == [10]
    out_b = train(cfg, TrainLoopConfig(checkpoint_dir=d, **base),
                  device="cpu")
    assert [h["step"] for h in out_b["history"]] == list(range(11, 21))
    assert (out_b["engine"]["misses"], out_b["engine"]["hits"]) == (1, 9)
    for a, b in zip(out_a["history"][10:], out_b["history"]):
        assert {k: a[k] for k in a if k != "wall_s"} == \
            {k: b[k] for k in b if k != "wall_s"}
    for a, b in zip(leaves(out_a["params"]), leaves(out_b["params"])):
        assert torch.equal(a, b)
    assert CheckpointManager(d).all_steps() == [10, 20]


def test_checkpoint_every_and_keep(tmp_path):
    cfg = reduced(get_config("stablelm-1.6b"))
    out = train(cfg, TrainLoopConfig(steps=8, seq_len=16, global_batch=2,
                                     log_every=4, checkpoint_every=2,
                                     checkpoint_dir=str(tmp_path)),
                device="cpu")
    assert CheckpointManager(tmp_path).all_steps() == [4, 6, 8]
    step, state = CheckpointManager(tmp_path).restore(
        {"params": out["params"], "data": {"next_step": 0}})
    assert step == 8 and int(state["data"]["next_step"]) == 8
    for a, b in zip(leaves(state["params"]), leaves(out["params"])):
        assert torch.equal(a, b)
