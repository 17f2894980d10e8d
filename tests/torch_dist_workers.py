"""What each spawned rank runs in the port's multi-rank CPU tests
(``test_torch_distributed.py``, ``test_torch_summa.py``).

The ranks are started by :func:`repro_torch.launch.mesh.spawn` (``gloo``
on the CPU, plain versions); each function here runs on one rank and
returns numpy arrays and plain values to the test.  Inputs come from an
``.npz`` the test wrote, so the JAX package's run (a subprocess on fake
devices) and the port's see the same numbers.  Imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import leaves


def _load(path: str) -> dict:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _t(x: np.ndarray) -> torch.Tensor:
    if x.dtype.name == "bfloat16" or x.dtype == np.uint16:
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().numpy()


# --------------------------------------------------------------------------
# SUMMA
# --------------------------------------------------------------------------
def summa_case(rank: int, world: int, inputs: str) -> dict:
    """``sma_gemm_sharded`` on the balanced grid of ``world`` ranks at every
    case of ``inputs`` (``{case}_a``, ``_b``, ``_bias``; bf16 arrays held
    as uint16 bits), overlapped and serial; ``ops.sma_gemm(mesh=)``'s
    route on the first case."""
    from repro_torch.distributed import sma_gemm_sharded
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import fake_mesh
    mesh = fake_mesh(world)
    data = _load(inputs)
    cases = sorted({k.rsplit("_", 1)[0] for k in data})
    out = {}
    for case in cases:
        a, b, bias = (_t(data[f"{case}_{x}"]) for x in ("a", "b", "bias"))
        over = sma_gemm_sharded(a, b, mesh=mesh, bias=bias, epilogue="relu")
        serial = sma_gemm_sharded(a, b, mesh=mesh, bias=bias,
                                  epilogue="relu", overlap=False)
        out[case] = {"out": _np(over), "dtype": str(over.dtype),
                     "equal": torch.equal(over, serial)}
    a, b = _t(data["f32s0_a"]), _t(data["f32s0_b"])
    ops.reset_counts()
    routed = ops.sma_gemm(a, b, mesh=mesh)
    local = ops.sma_gemm(a, b, mesh=False)
    out["route"] = {"sharded_calls": ops.ROUTED.get(ops.SHARDED_REASON, 0),
                    "equal": torch.equal(routed,
                                         sma_gemm_sharded(a, b, mesh=mesh)),
                    "local_err": float((routed - local).abs().max())}
    return out


def summa_world(rank: int, world: int, inputs: str) -> dict:
    """One world's SUMMA cases, and on 4 ranks the comm cases."""
    out = {"summa": summa_case(rank, world, inputs)}
    if world == 4:
        out["comm"] = comm_case(rank, world)
    return out


def comm_case(rank: int, world: int) -> dict:
    """The reference's comm tests on the port: the plan report's ``comm``
    section of a two-GEMM model on ``fake_mesh(world)``, and the ``comm``
    lane of a profiled ``sma_gemm_sharded``."""
    import repro_torch
    from repro_torch.distributed import sma_gemm_sharded
    from repro_torch.launch.mesh import fake_mesh
    from repro_torch.obs.export import LANES
    mesh = fake_mesh(world)

    def model(x, w1, w2):
        return torch.relu(x @ w1) @ w2

    x = torch.ones(8, 32)
    w1 = torch.ones(32, 64)
    w2 = torch.ones(64, 16)
    eng = repro_torch.sma_jit(model,
                              options=repro_torch.SMAOptions(mesh=mesh))
    comm = eng.compile(x, w1, w2).report["comm"]
    sharded = eng(x, w1, w2)
    single = repro_torch.sma_jit(model)
    comm0 = single.compile(x, w1, w2).report["comm"]
    same = torch.allclose(sharded, single(x, w1, w2), rtol=1e-6)
    a, b = torch.ones(8, 32), torch.ones(32, 16)
    with repro_torch.profile() as prof:
        sma_gemm_sharded(a, b, mesh=mesh)
    events = prof.chrome_trace()["traceEvents"]
    lanes = {ev["args"]["name"] for ev in events
             if ev["ph"] == "M" and ev["name"] == "thread_name"}
    bcasts = [e for e in events if e.get("ph") == "X"
              and e["name"].startswith("comm.bcast")]
    outer = [e for e in events
             if e["name"] == "distributed.sma_gemm_sharded"]
    return {"comm": comm, "comm0": comm0, "same": same,
            "lanes": sorted(lanes),
            "bcast_tids": sorted({e["tid"] for e in bcasts}),
            "bcast_bytes": [e["args"]["bytes"] for e in bcasts],
            "outer_grids": [e["args"]["grid"] for e in outer],
            "comm_lane": LANES["comm"]}


def summa_card_case(rank: int, world: int) -> dict:
    """Two ranks on one card: ``sma_gemm_sharded`` at a small bf16 shape
    against one rank's ``ops.sma_gemm``, overlapped and serial."""
    from repro_torch.distributed import sma_gemm_sharded
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import fake_mesh
    mesh = fake_mesh(world)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(512, 256, generator=gen, device=dev).to(torch.bfloat16)
    b = (torch.randn(256, 384, generator=gen, device=dev) / 16).to(
        torch.bfloat16)
    want = ops.sma_gemm(a, b, epilogue="silu", mesh=False)
    ops.reset_counts()
    got = sma_gemm_sharded(a, b, mesh=mesh, epilogue="silu")
    torch.cuda.synchronize()
    launches = ops.launch_counts()["sma_gemm"]
    serial = sma_gemm_sharded(a, b, mesh=mesh, epilogue="silu",
                              overlap=False)
    err = ((got.float() - want.float()).abs()
           / (3e-2 + 3e-2 * want.float().abs())).max().item()
    return {"multiples": err, "equal": torch.equal(got, serial),
            "launches": launches, "backend": mesh.backend}


# --------------------------------------------------------------------------
# Pipeline and compressed psum
# --------------------------------------------------------------------------
def pipeline_case(rank: int, world: int, inputs: str) -> dict:
    """``pipeline_apply`` over ``world`` stages on the affine stages of
    ``inputs`` (``affine{world}_w``, ``_b``, ``_x``), and with 2 ranks on
    a reduced StableLM split in two (``model_*`` leaves, ``model_x``)."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import lm
    from repro_torch.tree import tree_map, unflatten
    data = _load(inputs)
    mesh = Mesh((world,), ("pipe",))
    sp = {"w": _t(data[f"affine{world}_w"]), "b": _t(data[f"affine{world}_b"])}
    y = pipeline_apply(lambda p, t: t * p["w"] + p["b"], mesh, "pipe", sp,
                       _t(data[f"affine{world}_x"]))
    out = {"affine": _np(y)}
    if world == 2:
        cfg = reduced(get_config("stablelm-1.6b"))
        like = lm.init(cfg, seed=0, device="cpu", dtype=torch.float32)
        flat = [data[f"model_{i}"] for i in range(len(leaves(like)))]
        params = unflatten(like, [_t(x) for x in flat])
        blocks = params["blocks"][0]
        per = cfg.num_groups // world
        staged = tree_map(lambda t: t.reshape((world, per) + t.shape[1:]),
                          blocks)

        def stage_fn(p, h):
            for g in range(per):
                h = lm._block(tree_map(lambda t: t[g], p), "attn", h, cfg)
            return h

        with torch.no_grad():
            y = pipeline_apply(stage_fn, mesh, "pipe", staged,
                               _t(data["model_x"]))
        out["model"] = _np(y)
    return out


def pipeline_world(rank: int, world: int, inputs: str) -> dict:
    """One world's multi-rank cases: the pipeline, and on 4 ranks the
    compressed psum, on 2 the staged route."""
    out = {"pipeline": pipeline_case(rank, world, inputs)}
    if world == 4:
        out["psum"] = psum_case(rank, world, inputs)
    if world == 2:
        out["staged"] = staged_case(rank, world)
    return out


def train_pair(rank: int, world: int, inputs: str, ckdir: str) -> tuple:
    """An unbroken 5-step run, then one halted at step 3 into ``ckdir``."""
    return (train_case(rank, world, inputs, 5),
            train_case(rank, world, inputs, 5, ckdir, 3))


def psum_case(rank: int, world: int, inputs: str) -> dict:
    """``compressed_psum`` of row ``rank`` of ``inputs["g"]`` over the
    ``data`` axis."""
    from repro_torch.launch.mesh import smoke_mesh
    from repro_torch.optim.compress import compressed_psum
    g = _t(_load(inputs)["g"])
    return {"out": _np(compressed_psum(g[rank], smoke_mesh(), "data"))}


# --------------------------------------------------------------------------
# The trainer
# --------------------------------------------------------------------------
def train_case(rank: int, world: int, inputs: str, steps: int,
               ckdir: str = None, halt: int = None,
               global_batch: int = 4) -> dict:
    """``train(mesh=smoke_mesh())`` of the reduced StableLM from the
    masters in ``inputs`` (``p{i}``, the JAX package's init): history,
    masters, this rank's moments, the traced step's collective nodes and
    the dispatched step's collectives in order."""
    from repro_torch.compiler import dispatch as cdispatch
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.distributed.collectives import COLLECTIVE_OPS, IMPLS
    from repro_torch.launch.mesh import smoke_mesh
    from repro_torch.launch.train import TrainLoopConfig, train
    from repro_torch.models import lm
    from repro_torch.tree import unflatten
    cfg = reduced(get_config("stablelm-1.6b"))
    data = _load(inputs)
    like = lm.init(cfg, seed=0, device="cpu", dtype=cfg.parameter_dtype)
    params = unflatten(like, [_t(data[f"p{i}"].copy())
                              for i in range(len(leaves(like)))])
    loop = TrainLoopConfig(steps=steps, seq_len=32, global_batch=global_batch,
                           log_every=1, seed=0, peak_lr=3e-3, remat=True,
                           checkpoint_dir=ckdir, halt_at_step=halt,
                           checkpoint_every=1000)
    built = []
    orig = cdispatch.compile_with_options

    def spy(*args, **kwargs):
        built.append(orig(*args, **kwargs))
        return built[-1]

    cdispatch.compile_with_options = spy
    try:
        result = train(cfg, loop, device="cpu", params=params,
                       mesh=smoke_mesh())
    finally:
        cdispatch.compile_with_options = orig
    ops, impls = set(COLLECTIVE_OPS.values()), set(IMPLS.values())
    order = []
    for cm in built:
        order.append([(n.target.__name__, tuple(n.args[1:]))
                      for n in cm.module.graph.nodes
                      if n.op == "call_function" and n.target in impls])
    traced = [sum(1 for n in cm.traced.graph.nodes
                  if n.op == "call_function" and n.target in ops)
              for cm in built]
    return {"history": [{k: v for k, v in h.items() if k != "wall_s"}
                        for h in result["history"]],
            "params": [_np(p) for p in leaves(result["params"])],
            "m_shapes": [tuple(m.shape) for m in leaves(result["opt"]["m"])],
            "collectives": order, "traced_collectives": traced,
            "engine": result["engine"]}


def staged_case(rank: int, world: int) -> dict:
    """The host-staged route (a ``gloo`` group's route for CUDA tensors)
    forced on CPU tensors, with small pieces over the lanes: each
    collective (the async broadcast and the send/receive among them)
    against the direct ``gloo`` route."""
    from repro_torch.distributed import collectives
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import smoke_mesh
    key = smoke_mesh().group_key("data")
    gen = torch.Generator().manual_seed(rank)
    x = torch.randn(1000, 37, generator=gen)
    nxt, prev = (rank + 1) % world, (rank - 1) % world

    def run():
        return [collectives.all_reduce(x, key),
                collectives.broadcast(x, key, 1),
                collectives.all_gather(x, key, dim=1),
                collectives.broadcast_async(x, key, 0).wait(),
                collectives.sendrecv(x, key, nxt, prev)]

    direct = run()
    route, pinned, bucket = (collectives._route, collectives._pinned,
                             collectives.BUCKET_BYTES)
    collectives._route = lambda t, backend: "host"
    collectives._pinned = lambda slot, nbytes: torch.empty(
        nbytes, dtype=torch.uint8)
    collectives.BUCKET_BYTES = 4096
    collectives.reset_counts()
    ops.reset_counts()
    try:
        staged = run()
    finally:
        collectives._route, collectives._pinned = route, pinned
        collectives.BUCKET_BYTES = bucket
    return {"equal": [torch.equal(a, b) for a, b in zip(direct, staged)],
            "routes": dict(collectives.ROUTES),
            "staged_bytes": dict(collectives.STAGED_BYTES),
            "routed": dict(ops.ROUTED)}
