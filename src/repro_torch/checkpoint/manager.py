"""Checkpointing: atomic, resumable, readable by either package
(counterpart of ``repro.checkpoint.manager``).

* **Atomic commit** -- a checkpoint is written to ``<dir>/tmp.<step>`` and
  renamed to ``<dir>/step_<n>`` only after every array and the manifest
  are on disk; a crash mid-save leaves the last restore point intact.
* **The reference's format** -- ``arrays.npz`` (``a0``, ``a1``, ...) and
  ``manifest.json`` (``{"leaves": {path: {"idx", "shape", "dtype"}},
  "step", "treedef"}``), with JAX's path keys: dict keys and sequence
  indices joined by ``/`` (``params/blocks/0/ffn/wi``), leaves in JAX's
  order (:mod:`repro_torch.tree`).  So either package restores the
  other's checkpoint of a tree of the same structure.
* **Async save** -- :meth:`CheckpointManager.save` copies every leaf to
  host numpy before it returns (the trainer overwrites its tensors in
  place right after), then a background thread serializes; a second save
  waits for the first.
* **Restore onto the caller's devices** -- :meth:`CheckpointManager.restore`
  gives each tensor leaf of ``like`` a tensor of its device and dtype, and
  each other leaf (a data cursor's int) a numpy array.

Leaves are tensors, numpy arrays or Python numbers; a tensor numpy cannot
hold (bfloat16) is not taken.

* **Elastic restore** -- checkpoints are unsharded (``train(mesh=)``,
  whose masters, moments and error-feedback state are each rank's blocks
  over ``model`` and ``data``, gathers one leaf at a time to host before
  it saves, and only the first rank writes).  ``restore(...,
  shardings=)`` lays each stored array out for this rank
  (:class:`repro_torch.distributed.sharding.LeafSharding`: this rank's
  block of a split leaf, a grouped dim's block of each part), so a run
  saved on a 1 x 2 or a 2 x 1 mesh resumes on the other, on 4 ranks or
  on 1.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_map, unflatten

_STEP_RE = re.compile(r"^step_(\d+)$")


def _flatten_with_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in :func:`repro_torch.tree.leaves` order, the
    path as ``jax.tree_util.tree_flatten_with_path`` keys join it."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flatten_with_paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (tuple, list)):
        return [x for i, node in enumerate(tree)
                for x in _flatten_with_paths(node, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def _to_host(leaf: Any) -> np.ndarray:
    """A host copy the caller cannot mutate."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = True) -> None:
        self.directory = str(directory)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(self.directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Dict[str, Any]) -> None:
        """Snapshot ``tree`` to host numpy now; serialize it (in the
        background with ``async_save``) to ``step_<step>``."""
        host = tree_map(_to_host, tree)
        self.wait()
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._thread.start()
        else:
            self._write(step, host)

    def wait(self) -> None:
        """Block until the background save, if any, is committed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host_tree: Any) -> None:
        tmp = os.path.join(self.directory, f"tmp.{step}")
        final = os.path.join(self.directory, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest, arrays = {}, {}
        for i, (key, arr) in enumerate(_flatten_with_paths(host_tree)):
            arrays[f"a{i}"] = arr
            manifest[key] = {"idx": i, "shape": list(arr.shape),
                             "dtype": str(arr.dtype)}
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        structure = tree_map(lambda _: "*", host_tree)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"leaves": manifest, "step": step,
                       "treedef": repr(structure)}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        """Committed steps, ascending."""
        out = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.directory, name,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Dict[str, Any], *, step: Optional[int] = None,
                shardings: Optional[Dict[str, Any]] = None
                ) -> Tuple[int, Dict[str, Any]]:
        """``(step, tree)``: the checkpoint of ``step`` (default the
        latest) in the structure of ``like``, each tensor leaf on its
        ``like`` leaf's device and in its dtype.  ``shardings``: a tree
        of ``like``'s structure whose leaves are ``LeafSharding`` or None
        (a missing key is None); a leaf with a sharding takes this rank's
        block of the stored array (``like`` holds the block's shape)."""
        layout = dict(_flatten_with_paths(shardings)) \
            if shardings is not None else {}
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(self.directory, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)["leaves"]
        out = []
        with np.load(os.path.join(path, "arrays.npz")) as data:
            for key, leaf in _flatten_with_paths(like):
                if key not in manifest:
                    raise KeyError(f"checkpoint missing leaf {key!r}")
                arr = data[f"a{manifest[key]['idx']}"]
                if layout.get(key) is not None:
                    arr = np.ascontiguousarray(layout[key].local(arr))
                if isinstance(leaf, torch.Tensor):
                    if tuple(arr.shape) != tuple(leaf.shape):
                        raise ValueError(
                            f"checkpoint leaf {key!r} has shape "
                            f"{arr.shape}, the tree {tuple(leaf.shape)}")
                    arr = torch.from_numpy(arr).to(device=leaf.device,
                                                   dtype=leaf.dtype)
                out.append(arr)
        return step, unflatten(like, out)
