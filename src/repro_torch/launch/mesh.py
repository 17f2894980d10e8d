"""Production, smoke and fake meshes over a ``torch.distributed`` group
(counterpart of ``repro.launch.mesh``).

A :class:`Mesh` names the axes of the process grid (``("data",
"model")``, ``("pod", "data", "model")``) and lays the world's ranks on
it row-major, as ``jax.make_mesh`` lays its devices.  It holds one
sub-group per line of each axis: :func:`torch.distributed.new_group` is
called by every rank for every line, in the same order, once, when the
mesh is made (a rank outside a line still has to call it).  The
collectives of :mod:`repro_torch.distributed.collectives` find those
groups by the key :meth:`Mesh.group_key` gives them.

A mesh is hashable and compares by its axes, their sizes and this rank's
place, so two equal meshes key one engine cache entry
(``SMAOptions.mesh``); building an equal mesh again re-registers its
groups under the same keys.  Without an initialized process group a mesh
is one rank, whose collectives are the identity.

:func:`init_mesh` brings the group up (from the environment or explicit
arguments, with a ``timeout``) and picks its backend once, when the
group is made: ``nccl`` when every rank has a card of its own, ``gloo``
when ranks share a card or run on the CPU.  The choice is stored on the
mesh (``Mesh.backend``) and printed; it is never a retry after a failure.
Under ``gloo`` a collective on CUDA tensors stages through pinned host
memory (:mod:`repro_torch.distributed.collectives`).

:func:`spawn` runs a function on ``n`` ranks spawned with
``torch.multiprocessing`` over a ``file://`` store, each rank's result
returned to the caller through a file: the CPU tests' and the card
smoke's substrate for several ranks on one host.
"""
from __future__ import annotations

import datetime
import itertools
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["Mesh", "fake_mesh", "init_mesh", "make_production_mesh",
           "smoke_mesh", "spawn", "world_size"]

#: The production grids (``repro.launch.mesh.make_production_mesh``).
_PRODUCTION = {False: ((16, 16), ("data", "model")),
               True: ((2, 16, 16), ("pod", "data", "model"))}


def world_size() -> int:
    """Ranks of the default process group (1 when none is initialized)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


class Mesh:
    """Named axes over the world's ranks, with a sub-group per axis line.

    ``shape`` maps each axis name to its size (in axis order); ``size`` is
    their product and must equal the world size; ``coords`` is this
    rank's index along each axis.  ``backend`` is the group's backend
    (``"gloo"``, ``"nccl"``, or ``None`` for one rank without a group).
    """

    def __init__(self, sizes: Sequence[int], axes: Sequence[str]) -> None:
        sizes, axes = tuple(int(s) for s in sizes), tuple(axes)
        if len(sizes) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh axes {axes} and sizes {sizes} do not "
                             f"match one to one")
        n = 1
        for s in sizes:
            n *= s
        have = world_size()
        if n != have:
            raise ValueError(f"mesh {dict(zip(axes, sizes))} has {n} ranks "
                             f"but the world has {have}")
        self.axis_names: Tuple[str, ...] = axes
        self.shape: Dict[str, int] = dict(zip(axes, sizes))
        self.size = n
        self.rank = _rank()
        strides, acc = [], 1
        for s in reversed(sizes):
            strides.append(acc)
            acc *= s
        self._strides = tuple(reversed(strides))
        self.coords: Dict[str, int] = {
            a: (self.rank // st) % s
            for a, s, st in zip(axes, sizes, self._strides)}
        self.backend: Optional[str] = (dist.get_backend()
                                       if dist.is_initialized() else None)
        self._make_groups()

    # ------------------------------------------------------------ layout
    def rank_at(self, coords: Dict[str, int]) -> int:
        """The global rank at ``coords`` (axis -> index)."""
        return sum(coords[a] * st for a, st in zip(self.axis_names,
                                                   self._strides))

    def group_key(self, axis: str) -> str:
        """The key the collectives find this rank's ``axis`` group by."""
        grid = "x".join(f"{a}{s}" for a, s in self.shape.items())
        return f"{grid}:{axis}"

    def _make_groups(self) -> None:
        """One group a line of each axis (``collectives.GLOO_LANES`` under
        ``gloo``: staged pieces go over them together), made by every rank
        in the same order."""
        from repro_torch.distributed import collectives
        lanes = collectives.GLOO_LANES if self.backend == "gloo" else 1
        for axis in self.axis_names:
            others = [a for a in self.axis_names if a != axis]
            mine = None
            for fixed in itertools.product(
                    *(range(self.shape[a]) for a in others)):
                where = dict(zip(others, fixed))
                ranks = [self.rank_at({**where, axis: i})
                         for i in range(self.shape[axis])]
                groups = ([dist.new_group(ranks=ranks) for _ in range(lanes)]
                          if dist.is_initialized() else None)
                if self.rank in ranks:
                    mine = (ranks, groups)
            collectives.register(self.group_key(axis), mine[1], mine[0],
                                 self.backend)

    # ---------------------------------------------------------- identity
    def _key(self) -> Tuple[Any, ...]:
        return (self.axis_names, tuple(self.shape.values()), self.rank,
                self.backend)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"backend={self.backend})")


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The target deployment mesh: (16, 16) ``("data", "model")``, 256
    ranks; multi-pod (2, 16, 16) ``("pod", "data", "model")``, 512."""
    shape, axes = _PRODUCTION[multi_pod]
    need = 1
    for s in shape:
        need *= s
    have = world_size()
    if have < need:
        raise ValueError(
            f"production mesh {dict(zip(axes, shape))} needs {need} ranks "
            f"but this process group has {have}. For local/CI development "
            f"use fake_mesh(n) on n ranks (spawn(fn, n) starts them) or "
            f"smoke_mesh() for whatever ranks exist.")
    return Mesh(shape, axes)


def smoke_mesh() -> Mesh:
    """Every rank of the world as a 1-D ``"data"`` mesh."""
    return Mesh((world_size(),), ("data",))


def _balanced_grid(n: int) -> Tuple[int, int]:
    """``n`` as the most-square ``(rows, cols)`` factorization, rows <=
    cols: 1 -> (1, 1), 2 -> (1, 2), 4 -> (2, 2), 8 -> (2, 4)."""
    best = (1, n)
    r = 1
    while r * r <= n:
        if n % r == 0:
            best = (r, n // r)
        r += 1
    return best


def fake_mesh(n: int, axes: Sequence[str] = ("data", "model")) -> Mesh:
    """The balanced 2-D grid over an ``n``-rank group: the CPU tests'
    substrate (``gloo`` ranks from :func:`spawn`).  Raises when the world
    is not ``n`` ranks: a mesh is over the whole world."""
    axes = tuple(axes)
    if len(axes) != 2:
        raise ValueError(f"fake_mesh needs exactly 2 axis names, got {axes}")
    have = world_size()
    if have != n:
        raise ValueError(
            f"fake_mesh({n}) needs a process group of {n} ranks but the "
            f"world has {have}. Start the ranks with "
            f"repro_torch.launch.mesh.spawn(fn, {n}) (gloo, CPU or one "
            f"card) or init_mesh(rank=..., world={n}, ...) in each of "
            f"{n} processes.")
    return Mesh(_balanced_grid(n), axes)


def _choose_backend(device: torch.device, local_ranks: int) -> str:
    """``nccl`` when each local rank has a card of its own, else
    ``gloo``."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if local_ranks <= torch.cuda.device_count() else "gloo"


def init_mesh(sizes: Optional[Sequence[int]] = None,
              axes: Sequence[str] = ("data",), *,
              rank: Optional[int] = None, world: Optional[int] = None,
              init_method: Optional[str] = None,
              device: Optional[torch.device] = None,
              local_ranks: Optional[int] = None,
              backend: Optional[str] = None,
              timeout: float = 600.0, verbose: bool = True) -> Mesh:
    """Initialize the default process group and return a mesh over it.

    ``rank``, ``world`` and ``init_method`` default to the environment
    (``RANK``, ``WORLD_SIZE``, ``env://``).  The backend is chosen once,
    here: ``backend`` if given, else ``nccl`` when ``device`` is a card and
    each of the ``local_ranks`` ranks on this host (``LOCAL_WORLD_SIZE``,
    else ``world``) has one of its own, else ``gloo``.  ``sizes`` defaults
    to ``(world,)``."""
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world = int(os.environ.get("WORLD_SIZE", 1)) if world is None else world
    device = torch.device(device or ("cuda" if torch.cuda.is_available()
                                     else "cpu"))
    if local_ranks is None:
        local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    chosen = backend or _choose_backend(device, local_ranks)
    if device.type == "cuda":
        torch.cuda.set_device(device.index if device.index is not None
                              else (rank % torch.cuda.device_count()
                                    if chosen == "nccl" else 0))
    dist.init_process_group(chosen, init_method=init_method or "env://",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))
    mesh = Mesh(tuple(sizes) if sizes is not None else (world,), axes)
    if verbose and rank == 0:
        print(f"[mesh] {mesh.shape} over {world} ranks, backend {chosen} "
              f"({local_ranks} ranks on {device.type})", flush=True)
    return mesh


# --------------------------------------------------------------------------
# Spawning ranks on one host
# --------------------------------------------------------------------------
def _rank_main(rank: int, fn: Callable, world: int, workdir: str,
               backend: str, device: str, timeout: float,
               args: Tuple[Any, ...]) -> None:
    out = os.path.join(workdir, f"rank{rank}.pkl")
    try:
        dev = torch.device(device)
        if dev.type == "cpu":       # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        init_mesh((world,), ("data",), rank=rank, world=world,
                  init_method=f"file://{os.path.join(workdir, 'store')}",
                  device=dev, backend=backend, timeout=timeout,
                  verbose=False)
        result = ("ok", fn(rank, world, *args))
    except BaseException as exc:    # reported to the parent, then re-raised
        result = ("error", f"rank {rank}: {exc!r}\n"
                           f"{traceback.format_exc()}")
        with open(out + ".tmp", "wb") as f:
            pickle.dump(result, f)
        os.replace(out + ".tmp", out)
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(out + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(out + ".tmp", out)


def spawn(fn: Callable, world: int, *args: Any, backend: str = "gloo",
          device: str = "cpu", timeout: float = 300.0,
          workdir: Optional[str] = None) -> List[Any]:
    """Run ``fn(rank, world, *args)`` on ``world`` spawned ranks, each in
    a ``(world,)`` ``"data"`` group of ``backend`` (build other meshes
    over it inside ``fn``), and return each rank's result in rank order.

    The store is a file under ``workdir`` (a fresh temporary directory by
    default).  A rank that raises, dies or is still running after
    ``timeout`` seconds makes this raise (the others are terminated).
    ``fn`` must be importable by name (a module-level function)."""
    import torch.multiprocessing as mp
    own = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="repro_torch_ranks_")
    os.makedirs(workdir, exist_ok=True)
    for name in os.listdir(workdir):
        if name.startswith("rank") or name == "store":
            os.remove(os.path.join(workdir, name))
    ctx = mp.start_processes(_rank_main, args=(fn, world, workdir, backend,
                                               device, timeout, args),
                             nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks did not finish in "
                                   f"{timeout} s")
    except Exception as exc:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        errors = []
        for r in range(world):
            path = os.path.join(workdir, f"rank{r}.pkl")
            if os.path.exists(path):
                with open(path, "rb") as f:
                    status, value = pickle.load(f)
                if status == "error":
                    errors.append(value)
        raise RuntimeError(f"spawned ranks failed: {exc}\n"
                           + "\n".join(errors)) from None
    results = []
    for r in range(world):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            status, value = pickle.load(f)
        if status != "ok":
            raise RuntimeError(value)
        results.append(value)
    if own:
        shutil.rmtree(workdir, ignore_errors=True)
    return results
