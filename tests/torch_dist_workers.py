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
    return x.detach().float().cpu().numpy()


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
    the gathered masters and this rank's masters' and moments' shapes, the
    traced step's collective nodes and the dispatched step's collectives
    in order."""
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
            "params": [_np(p) for p in
                       leaves(result["plan"].whole(result["params"]))],
            "local_shapes": [tuple(p.shape)
                             for p in leaves(result["params"])],
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


# --------------------------------------------------------------------------
# Tensor parallelism (test_torch_tensor_parallel.py)
# --------------------------------------------------------------------------
#: arch -> the fields its reduced config replaces (the family test's short
#: patterns that keep every block type; 6 query heads on one KV head for
#: the whole-attention route).
TP_FAMILIES = {"stablelm-1.6b": {}, "mistral-nemo-12b": {},
               "qwen3-moe-30b-a3b": {},
               "recurrentgemma-2b": dict(block_pattern=("rglru", "rglru",
                                                        "local"),
                                         num_groups=1),
               "xlstm-1.3b": dict(block_pattern=("mlstm", "slstm"),
                                  num_groups=1),
               "musicgen-large": {}, "internvl2-2b": {}}
TP_HEADS = dict(num_heads=6, num_kv_heads=1)


def tp_config(arch: str, extra=None):
    """The reduced config of ``arch`` with :data:`TP_FAMILIES`' fields
    (and ``extra``)."""
    import dataclasses
    from repro_torch.configs.base import get_config, reduced
    return dataclasses.replace(reduced(get_config(arch)),
                               **TP_FAMILIES.get(arch, {}), **(extra or {}))


def tp_loop(steps: int = 3, ckdir: str = None, halt: int = None):
    from repro_torch.launch.train import TrainLoopConfig
    return TrainLoopConfig(steps=steps, seq_len=32, global_batch=2,
                           log_every=1, seed=0, peak_lr=3e-3, remat=True,
                           checkpoint_dir=ckdir, halt_at_step=halt,
                           checkpoint_every=1000)


def tp_params(cfg, inputs: str):
    """The whole f32 masters of ``cfg`` from ``inputs`` (``p{i}``, the
    port's leaves of the JAX package's init)."""
    from repro_torch.models import lm
    from repro_torch.tree import unflatten
    data = _load(inputs)
    like = lm.init(cfg, seed=0, device="cpu", dtype=cfg.parameter_dtype)
    return unflatten(like, [_t(data[f"p{i}"].copy())
                            for i in range(len(leaves(like)))])


def tp_train(cfg, inputs: str, sizes, loop) -> dict:
    """``train(mesh=)`` of ``cfg`` on a ``sizes`` ``(data, model)`` mesh:
    history, the gathered masters, which leaves are split over ``model``
    (each rank's masters and moments their blocks), the replicated
    leaves' digests by step, the dispatched step's collectives in order,
    the report's ``comm`` collectives against ``collectives.BYTES`` a
    step, and the whole-attention route's count."""
    import repro_torch
    from repro_torch.compiler import dispatch as cdispatch
    from repro_torch.distributed import collectives
    from repro_torch.distributed.collectives import IMPLS
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.train import masters_digest, train
    from repro_torch.distributed.tensor_parallel import \
        WHOLE_ATTENTION_REASON
    params = tp_params(cfg, inputs)
    whole_shapes = [tuple(p.shape) for p in leaves(params)]
    mesh = Mesh(sizes, ("data", "model"))
    built = []
    orig = cdispatch.compile_with_options

    def spy(*args, **kwargs):
        built.append(orig(*args, **kwargs))
        return built[-1]

    cdispatch.compile_with_options = spy
    ops.reset_counts()
    collectives.reset_counts()
    try:
        with repro_torch.profile() as prof:
            result = train(cfg, loop, device="cpu", params=params,
                           mesh=mesh)
    finally:
        cdispatch.compile_with_options = orig
    nbytes = dict(collectives.BYTES)
    spans = {}
    for e in prof.events:
        if e.get("cat") == "comm":
            spans[e["name"]] = spans.get(e["name"], 0) + e["args"]["bytes"]
    routed = ops.ROUTED.get(WHOLE_ATTENTION_REASON, 0)
    plan = result["plan"]
    split = [bool(sh.splits) for sh in leaves(plan.tp)]
    impls = set(IMPLS.values())
    order = [[(n.target.__name__, tuple(n.args[1:]))
              for n in cm.module.graph.nodes
              if n.op == "call_function" and n.target in impls]
             for cm in built]
    comm = [cm.report["comm"]["collectives"] for cm in built]
    local = [tuple(p.shape) for p in leaves(result["params"])]
    moments = [tuple(m.shape) for m in leaves(result["opt"]["m"])]
    whole = plan.whole(result["params"])
    return {"history": [{k: v for k, v in h.items() if k != "wall_s"}
                        for h in result["history"]],
            "params": [_np(p) for p in leaves(whole)],
            "split": split, "local_shapes": local, "whole_shapes":
            whole_shapes, "moment_shapes": moments,
            "moment_want": [sh.local_shape(s) for sh, s in zip(
                leaves(plan.layout), whole_shapes)],
            "model_shapes": [sh.local_shape(s) for sh, s in zip(
                leaves(plan.tp), whole_shapes)],
            "replicated_digest": [
                [d for d, sp in zip(h["masters_digest"], split) if not sp]
                for h in result["history"]],
            "collectives": order, "comm": comm, "bytes": nbytes,
            "span_bytes": spans, "routed": routed,
            "engine": result["engine"], "coords": dict(mesh.coords)}


def tp_traced_spans(rank: int, world: int, arch: str, inputs: str) -> dict:
    """The traced step's collective nodes by (op, span) on a 1 x ``world``
    mesh (the joint graph: forward, remat recomputation and backward)."""
    import collections
    from repro_torch.compiler import dispatch as cdispatch
    from repro_torch.distributed.collectives import COLLECTIVE_OPS
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.train import train
    cfg = tp_config(arch)
    built = []
    orig = cdispatch.compile_with_options

    def spy(*args, **kwargs):
        built.append(orig(*args, **kwargs))
        return built[-1]

    cdispatch.compile_with_options = spy
    try:
        train(cfg, tp_loop(1), device="cpu", params=tp_params(cfg, inputs),
              mesh=Mesh((1, world), ("data", "model")))
    finally:
        cdispatch.compile_with_options = orig
    names = {op: name for name, op in COLLECTIVE_OPS.items()}
    return dict(collections.Counter(
        (names[n.target], n.args[-1]) for n in built[0].traced.graph.nodes
        if n.op == "call_function" and n.target in names))


def vocab_case(rank: int, world: int, device: str = "cpu") -> dict:
    """The vocab-parallel cross entropy and embedding on a 1 x ``world``
    mesh against the plain ones, values and gradients: logits of a padded
    vocab (200 of 256 columns, the pad at -1e30, a tie for the argmax),
    labels with -1 among them; a table of 256 rows.  On ``device``."""
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.launch.mesh import Mesh
    gen = torch.Generator().manual_seed(0)
    v, vocab = 256, 200
    logits = torch.randn(2, 8, v, generator=gen)
    logits[..., vocab:] = -1e30
    logits[0, 0, 3] = logits[0, 0, 130] = 50.0        # a tie across blocks
    labels = torch.randint(0, vocab, (2, 8), generator=gen)
    labels[0, 0] = 130
    labels[1, ::3] = -1
    table = torch.randn(v, 16, generator=gen)
    tokens = torch.randint(0, v, (2, 8), generator=gen)
    logits, labels, table, tokens = (t.to(device) for t in (
        logits, labels, table, tokens))
    weights = torch.arange(16.0, device=device)

    valid = labels >= 0
    want_l = logits.clone().requires_grad_()
    lse = torch.logsumexp(want_l, -1)
    picked = want_l.gather(-1, torch.where(valid, labels, 0)[..., None])[..., 0]
    want_ce = torch.where(valid, lse - picked, 0.0)
    want_ce.sum().backward()
    want_hit = (logits.argmax(-1) == labels) & valid
    want_t = table.clone().requires_grad_()
    rows = want_t[tokens]
    (rows * weights).sum().backward()

    mesh = Mesh((1, world), ("data", "model"))
    with use_rules(None, mesh.axis_names, mesh=mesh):
        ax = tp.model_axis()
        n = v // world
        block = logits[..., ax.block(n)].clone().requires_grad_()
        ce, hit = tp.vocab_cross_entropy(ax, block, labels)
        ce.sum().backward()
        tblock = table[ax.block(n)].clone().requires_grad_()
        got_rows = tp.vocab_embed(ax, tblock, tokens, torch.float32)
        (got_rows * weights).sum().backward()
    return {"ce": _np(ce), "want_ce": _np(want_ce),
            "hit": hit.cpu().numpy(), "want_hit": want_hit.cpu().numpy(),
            "dlogits": _np(block.grad),
            "want_dlogits": _np(want_l.grad[..., ax.block(n)]),
            "rows": _np(got_rows), "want_rows": _np(rows),
            "dtable": _np(tblock.grad),
            "want_dtable": _np(want_t.grad[ax.block(n)])}


def remat_thread_case(rank: int, world: int, inputs: str) -> dict:
    """The reduced StableLM's loss under the rules of a 1 x ``world`` mesh
    (remat on), its gradient taken on this thread and, as autograd runs a
    CUDA tensor's backward, on another thread that holds no rules: the
    remat recomputation must run tensor parallel there too."""
    import threading
    from repro_torch import convert
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.train import MeshPlan
    from repro_torch.models import lm
    from repro_torch.tree import tree_map
    cfg = tp_config("stablelm-1.6b")
    mesh = Mesh((1, world), ("data", "model"))
    whole = tp_params(cfg, inputs)
    plan = MeshPlan(cfg, tp_loop(), mesh, whole)
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
    batch = {"tokens": toks, "labels": toks}
    grads = []
    for other in (False, True):
        live = tree_map(lambda p: p.detach().requires_grad_(),
                        convert.model_blocks(whole, plan.tp))
        with use_rules(plan.rules, mesh.axis_names, mesh=mesh):
            loss, _ = lm.loss_fn(live, cfg, batch, remat=True)
        out = []

        def backward():
            out.append(torch.autograd.grad(loss, leaves(live)))
        if other:
            t = threading.Thread(target=backward)
            t.start()
            t.join()
        else:
            with use_rules(plan.rules, mesh.axis_names, mesh=mesh):
                backward()
        grads.append(out[0] if out else None)
    return {"same": grads[1] is not None and all(
        torch.equal(a, b) for a, b in zip(*grads))}


def tp_world(rank: int, world: int, inputs: dict, ckdir: str) -> dict:
    """The 2-rank cases: each family of ``inputs`` (arch -> its masters'
    ``.npz``) on a 1 x 2 mesh (tensor parallel) and on a 2 x 1 mesh (data
    parallel), 3 steps; the vocab-parallel loss and embedding alone; the
    traced StableLM step's collective nodes; StableLM halted at step 2 on
    1 x 2 into ``ckdir`` (copied to ``ckdir + "_one"`` for a one-rank
    resume) and resumed on 2 x 1."""
    import shutil
    import torch.distributed as dist
    out = {}
    for arch, path in inputs.items():
        cfg = tp_config(arch)
        out[arch] = {"tp": tp_train(cfg, path, (1, world), tp_loop()),
                     "dp": tp_train(cfg, path, (world, 1), tp_loop())}
    out["vocab"] = vocab_case(rank, world)
    lm_path = inputs["stablelm-1.6b"]
    out["thread"] = remat_thread_case(rank, world, lm_path)
    out["traced"] = tp_traced_spans(rank, world, "stablelm-1.6b", lm_path)
    cfg = tp_config("stablelm-1.6b")
    out["halted"] = tp_train(cfg, lm_path, (1, world),
                             tp_loop(ckdir=ckdir, halt=2))
    if rank == 0:
        shutil.copytree(ckdir, ckdir + "_one")
    dist.barrier()
    out["resumed"] = tp_train(cfg, lm_path, (world, 1), tp_loop(ckdir=ckdir))
    return out


def tp_world4(rank: int, world: int, lm_path: str, heads_path: str) -> dict:
    """The 4-rank cases: StableLM on a 2 x 2 mesh; the config of 6 query
    heads on one KV head on a 1 x 4 mesh (attention whole on each
    rank)."""
    return {"2x2": tp_train(tp_config("stablelm-1.6b"), lm_path, (2, 2),
                            tp_loop()),
            "heads": tp_train(tp_config("stablelm-1.6b", TP_HEADS),
                              heads_path, (1, 4), tp_loop())}


def tp_card_case(rank: int, world: int) -> dict:
    """Two ranks on one card: 2 steps of a small bf16 StableLM (d_model
    128, 2 heads of 64, d_ff 256) through ``train(mesh=)`` on a 1 x 2 mesh
    and, on each rank, unmeshed; the kernels each launched; the
    vocab-parallel loss and embedding on CUDA tensors."""
    import dataclasses
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.train import train
    from repro_torch.models import lm
    cfg = dataclasses.replace(reduced(get_config("stablelm-1.6b")),
                              d_model=128, num_heads=2, num_kv_heads=2,
                              head_dim=64, d_ff=256, dtype="bfloat16")
    dev = torch.device("cuda", 0)
    loop = tp_loop(2)
    params = lm.init(cfg, seed=0, device=dev, dtype=cfg.parameter_dtype)
    unmeshed = train(cfg, loop, device=dev,
                     params=_clone(params))
    ops.reset_counts()
    meshed = train(cfg, loop, device=dev, params=_clone(params),
                   mesh=Mesh((1, world), ("data", "model")))
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    split = [bool(sh.splits) for sh in leaves(meshed["plan"].tp)]
    return {"unmeshed": [{k: h[k] for k in ("loss", "grad_norm")}
                         for h in unmeshed["history"]],
            "meshed": [{k: h[k] for k in ("loss", "grad_norm")}
                       for h in meshed["history"]],
            "replicated": [[d for d, sp in zip(h["masters_digest"], split)
                            if not sp] for h in meshed["history"]],
            "launches": launches, "vocab": vocab_case(rank, world, "cuda")}


def _clone(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.clone(), tree)


# --------------------------------------------------------------------------
# FSDP (test_torch_fsdp.py)
# --------------------------------------------------------------------------
def fsdp_collectives_case(rank: int, world: int) -> dict:
    """``reduce_scatter`` and ``gather_param`` on this rank's seeded
    tensors, values and gradients, over the direct ``gloo`` route and the
    host-staged one forced on CPU tensors (small pieces over the lanes):
    this rank's inputs and upstream gradients go back beside the results
    for the test's plain sums."""
    from repro_torch.distributed import collectives
    from repro_torch.distributed.fsdp import gather_param, gather_tree
    from repro_torch.distributed.sharding import (LeafSharding, MeshRules,
                                                  use_rules)
    from repro_torch.launch.mesh import smoke_mesh
    mesh = smoke_mesh()
    key = mesh.group_key("data")
    gen = torch.Generator().manual_seed(10 + rank)
    x = torch.randn(6, 4 * world, 3, generator=gen)
    up_rs = torch.randn(6, 4, 3, generator=gen)
    w = torch.randn(5, 8, generator=gen)             # a block, split dim 1
    up_g = torch.randn(5, 8 * world, generator=gen).to(torch.bfloat16)
    v = torch.randn(3, 5, generator=gen)             # a block, split dim 0
    up_v = torch.randn(3 * world, 5, generator=gen).to(torch.bfloat16)
    split = ((1, ("data",), world, rank),)
    layouts = {"plain": LeafSharding((None, "data"), split),
               "grouped": LeafSharding((None, "data"), split, ((1, 2),))}
    rules = MeshRules(batch=("data",))
    # A bucket: three leaves, two dims, one grouped, each against its own
    # gather_param.
    trio = {"a": (w, layouts["plain"], up_g),
              "b": (v, LeafSharding(("data", None),
                                    ((0, ("data",), world, rank),)), up_v),
              "c": (w * 2, layouts["grouped"], up_g * 3)}

    def gathered(one_by_one: bool) -> dict:
        blocks = {k: b.clone().requires_grad_()
                  for k, (b, _, _) in trio.items()}
        lay = {k: sh for k, (_, sh, _) in trio.items()}
        calls = collectives.CALLS["param_gather"]
        whole = ({k: gather_param(blocks[k], lay[k], torch.bfloat16)
                  for k in blocks} if one_by_one
                 else gather_tree(blocks, lay, torch.bfloat16))
        calls = collectives.CALLS["param_gather"] - calls
        torch.autograd.backward([whole[k] for k in sorted(whole)],
                                [trio[k][2] for k in sorted(whole)])
        return {"calls": calls, "whole": {k: _np(x) for k, x in
                                          whole.items()},
                "grad": {k: _np(b.grad) for k, b in blocks.items()}}

    def run() -> dict:
        xs = x.clone().requires_grad_()
        rs = collectives.reduce_scatter(xs, key, dim=1)
        rs.backward(up_rs)
        out = {"rs": _np(rs), "rs_grad": _np(xs.grad)}
        with use_rules(rules, mesh.axis_names, mesh=mesh):
            for name, sh in layouts.items():
                ws = w.clone().requires_grad_()
                whole = gather_param(ws, sh, torch.bfloat16)
                whole.backward(up_g)
                out[name] = {"whole": _np(whole), "dtype": str(whole.dtype),
                             "grad": _np(ws.grad),
                             "grad_dtype": str(ws.grad.dtype)}
        return out

    collectives.reset_counts()
    direct = run()
    gather_bytes = collectives.BYTES["comm.fsdp_gather"]
    route, pinned, bucket = (collectives._route, collectives._pinned,
                             collectives.BUCKET_BYTES)
    collectives._route = lambda t, backend: "host"
    collectives._pinned = lambda slot, nbytes: torch.empty(
        nbytes, dtype=torch.uint8)
    collectives.BUCKET_BYTES = 64
    collectives.reset_counts()
    try:
        staged = run()
        stats = {"calls": dict(collectives.CALLS),
                 "staged_bytes": dict(collectives.STAGED_BYTES)}
    finally:
        collectives._route, collectives._pinned = route, pinned
        collectives.BUCKET_BYTES = bucket
    with use_rules(rules, mesh.axis_names, mesh=mesh):
        buckets = {"one": gathered(True), "tree": gathered(False)}
    return {"x": x.numpy(), "up_rs": up_rs.numpy(), "w": w.numpy(),
            "up_g": _np(up_g), "direct": direct, "staged": staged,
            "stats": stats, "gather_bytes": gather_bytes,
            "bucket": buckets}


def fsdp_train(cfg, sizes, loop, params=None) -> dict:
    """``train(mesh=)`` of ``cfg`` on a ``sizes`` (data, model) mesh from
    ``params`` (None: each rank's blocks drawn by ``lm.init_blocks``):
    history, the gathered masters, the whole, local, moment and gradient
    shapes (the gradients' as the traced step saw them), the dispatched
    step's collectives in order, the report's comm collectives against
    ``collectives.BYTES`` and the ``comm.*`` spans of the run, and every
    gather a save made (its size, and how many earlier gathered tensors
    were still alive)."""
    import weakref
    import repro_torch
    from repro_torch.compiler import dispatch as cdispatch
    from repro_torch.distributed import collectives
    from repro_torch.distributed.collectives import IMPLS
    from repro_torch.launch import train as ltrain
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    whole_shapes = [tuple(p.shape) for p in
                    leaves(lm.abstract_params(cfg, cfg.parameter_dtype))]
    mesh = Mesh(sizes, ("data", "model"))
    built, grads, saves, alive = [], [], [], []
    orig_compile, orig_update = cdispatch.compile_with_options, adamw.update
    orig_gather = ltrain.MeshPlan.gather

    def spy(*args, **kwargs):
        built.append(orig_compile(*args, **kwargs))
        return built[-1]

    def update(g, *args, **kwargs):
        grads.append([tuple(x.shape) for x in leaves(g)])
        return orig_update(g, *args, **kwargs)

    def gather(self, x, sharding, *args, **kwargs):
        out = orig_gather(self, x, sharding, *args, **kwargs)
        saves.append((out.numel(), sum(r() is not None for r in alive)))
        alive.append(weakref.ref(out))
        return out

    cdispatch.compile_with_options = spy
    adamw.update = update
    ltrain.MeshPlan.gather = gather
    collectives.reset_counts()
    try:
        with repro_torch.profile() as prof:
            result = ltrain.train(cfg, loop, device="cpu", params=params,
                                  mesh=mesh)
    finally:
        cdispatch.compile_with_options = orig_compile
        adamw.update = orig_update
        ltrain.MeshPlan.gather = orig_gather
    nbytes = dict(collectives.BYTES)
    spans = {}
    for e in prof.events:
        if e.get("cat") == "comm":
            spans[e["name"]] = spans.get(e["name"], 0) + e["args"]["bytes"]
    plan = result["plan"]
    impls = set(IMPLS.values())
    order = [[(n.target.__name__, tuple(n.args[1:]))
              for n in cm.module.graph.nodes
              if n.op == "call_function" and n.target in impls]
             for cm in built]
    return {"history": [{k: v for k, v in h.items() if k != "wall_s"}
                        for h in result["history"]],
            "bytes": nbytes, "span_bytes": spans,
            "report": built[0].report["comm"]["collectives"],
            "params": [_np(p) for p in leaves(plan.whole(result["params"]))],
            "whole_shapes": whole_shapes,
            "local_shapes": [tuple(p.shape)
                             for p in leaves(result["params"])],
            "moment_shapes": [tuple(m.shape)
                              for m in leaves(result["opt"]["m"])],
            "grad_shapes": grads[0] if grads else None,
            "split": [sh.axes() for sh in leaves(plan.layout)],
            "collectives": order, "saves": saves,
            "engine": result["engine"], "coords": dict(mesh.coords)}


def fsdp_world(rank: int, world: int, ckdir: str) -> dict:
    """The 2-rank FSDP cases: the collectives alone; the reduced StableLM
    on 2 x 1 from ``lm.init_blocks``, 3 steps (and with int8 gradient
    compression; and with a global batch of one row, which the data axis
    does not divide), and halted at step 2 into
    ``ckdir`` (copied to ``ckdir + "_one"`` for a one-rank resume), then
    resumed on 1 x 2."""
    import shutil
    import torch.distributed as dist
    cfg = tp_config("stablelm-1.6b")
    import dataclasses
    out = {"collectives": fsdp_collectives_case(rank, world),
           "drawn": fsdp_train(cfg, (world, 1), tp_loop()),
           "compressed": fsdp_train(cfg, (world, 1), dataclasses.replace(
               tp_loop(), grad_compression=True)),
           "one_row": fsdp_train(cfg, (world, 1), dataclasses.replace(
               tp_loop(), global_batch=1)),
           "halted": fsdp_train(cfg, (world, 1), tp_loop(ckdir=ckdir,
                                                         halt=2))}
    if rank == 0:
        shutil.copytree(ckdir, ckdir + "_one")
    dist.barrier()
    out["resumed"] = fsdp_train(cfg, (1, world), tp_loop(ckdir=ckdir))
    return out


# --------------------------------------------------------------------------
# Serving on a mesh (test_torch_serve_mesh.py)
# --------------------------------------------------------------------------
#: The families' prompt and decode steps, and the batch.
SERVE_PROMPT, SERVE_STEPS, SERVE_BATCH = 16, 4, 2
#: RecurrentGemma's context-parallel cases on 1 x 2, (prompt, decode
#: steps): a ring of 32 slots (16 a rank) that wraps and whose decode
#: crosses into rank 1's slots; a prompt below rank 1's first slot (a ring
#: of 24, 12 a rank), so rank 1 starts empty; a ring of 31 slots, which the
#: line does not divide (the cache whole on each rank).
RG_CP_CASES = {"wrap": (32, 20), "rank 1 empty": (8, 12), "odd": (15, 3)}
#: Nemo's own context-parallel case on 1 x 4 (the reference's decode cell,
#: ``seq_len`` 16, caches of 32 slots, 8 a rank).
NEMO_CP = dict(seq_len=16, prompt=12, steps=6)


def serve_inputs(cfg, prompt: int, steps: int, seed: int = 0) -> dict:
    """Numpy inputs of a prefill of ``prompt`` positions (a vision prefix
    ahead of them in ``tokens+vision`` mode) and ``steps`` decode steps."""
    rng = np.random.default_rng(seed)
    b, d = SERVE_BATCH, cfg.d_model
    out = {}
    if cfg.input_mode == "embeds":
        out["embeds"] = rng.standard_normal((b, prompt, d)).astype(np.float32)
        out["step_embeds"] = rng.standard_normal(
            (steps, b, 1, d)).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size,
                                     (b, prompt)).astype(np.int32)
        out["step_tokens"] = rng.integers(0, cfg.vocab_size,
                                          (steps, b, 1)).astype(np.int32)
    if cfg.input_mode == "tokens+vision":
        out["vision_embeds"] = rng.standard_normal(
            (b, cfg.num_vision_tokens, d)).astype(np.float32)
    return out


def serve_batches(data: dict):
    """(the prefill batch, one batch a decode step) as tensors."""
    first = {k: _t(v) for k, v in data.items() if not k.startswith("step_")}
    key = "embeds" if "step_embeds" in data else "tokens"
    steps = [{key: _t(x)} for x in data["step_" + key]]
    return first, steps


def serve_unmeshed(cfg, params, data: dict, cache_size: int):
    """``lm.prefill`` then ``lm.decode_step``s on whole parameters: (logits
    a step, the final state)."""
    from repro_torch.models import lm
    first, steps = serve_batches(data)
    logits, state, clen = lm.prefill(params, cfg, first,
                                     cache_size=cache_size)
    out = [logits]
    for batch in steps:
        logits, state, clen = lm.decode_step(params, state, clen, cfg, batch)
        out.append(logits)
    return out, state


def serve_meshed(cfg, params, data: dict, mesh, seq_len: int) -> dict:
    """``launch.common``'s prefill cell of ``seq_len`` (caches of
    ``seq_len + DECODE_MARGIN``), the state relaid out for the decode
    cell, then its decode steps, on this rank's blocks and rows; beside
    it the unmeshed run's final state as this rank's blocks."""
    from repro_torch import convert
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import common
    from repro_torch.models import moe
    cache = seq_len + common.DECODE_MARGIN
    pshape, dshape = (ShapeConfig(kind, seq_len, SERVE_BATCH, kind)
                      for kind in ("prefill", "decode"))
    prules = common.cell_rules(cfg, pshape, mesh)
    drules = common.cell_rules(cfg, dshape, mesh)
    layout = common.param_layout(cfg, prules, mesh)
    same = [a.splits == b.splits for a, b in zip(
        leaves(layout), leaves(common.param_layout(cfg, drules, mesh)))]
    local = convert.model_blocks(params, layout)
    first, steps = serve_batches(data)
    experts = []
    orig = moe.moe_ffn

    def spy(p, x, c):
        experts.append((tuple(p["wi"].shape), tuple(p["router"].shape)))
        return orig(p, x, c)

    moe.moe_ffn = spy
    ops.reset_counts()
    try:
        logits, state, clen = common.make_prefill_step(
            cfg, cache, prules, mesh)(local, common.batch_rows(
                first, prules, mesh))
        src = common.state_layout(cfg, pshape, prules, mesh)
        dst = common.state_layout(cfg, dshape, drules, mesh)
        state = convert.relayout_state(state, src, dst)
        step = common.make_decode_step(cfg, cache, drules, mesh)
        out = [logits]
        for batch in steps:
            logits, state, clen = step(local, state, clen, common.batch_rows(
                batch, drules, mesh))
            out.append(logits)
    finally:
        moe.moe_ffn = orig
    routed = dict(ops.ROUTED)
    _, want = serve_unmeshed(cfg, params, data, cache)
    fresh = convert.state_blocks(want, dst)
    return {"logits": [_np(x) for x in out],
            "state": [_np(x) for x in leaves(state)],
            "unmeshed_state": [_np(x) for x in leaves(fresh)],
            "state_split": [[(sp[0], sp[1]) for sp in sh.splits]
                            for sh in leaves(dst)],
            "same_params": all(same), "experts": sorted(set(experts)),
            "routed": routed, "coords": dict(mesh.coords),
            "cache_len": _np(clen)}


def serve_world(rank: int, world: int, inputs: dict) -> dict:
    """The 2-rank serving cases: every family on 2 x 1 and 1 x 2, and
    RecurrentGemma's context-parallel cases on 1 x 2.  ``inputs``: arch
    (or ``"rg <case>"``) -> (params npz, data npz)."""
    from repro_torch.launch.mesh import Mesh
    out = {}
    for name, (ppath, dpath) in inputs.items():
        arch = "recurrentgemma-2b" if name.startswith("rg ") else name
        cfg = tp_config(arch)
        params = tp_params(cfg, ppath)
        data = _load(dpath)
        prompt = data[next(k for k in data if not k.startswith(
            "step_") and k != "vision_embeds")].shape[1]
        meshes = ((1, world),) if name.startswith("rg ") else (
            (world, 1), (1, world))
        for sizes in meshes:
            out[(name, sizes)] = serve_meshed(
                cfg, params, data, Mesh(sizes, ("data", "model")), prompt)
    return out


def serve_world4(rank: int, world: int, ppath: str, dpath: str,
                 lm_path: str) -> dict:
    """The 4-rank serving cases: the reduced Nemo's context-parallel decode
    on 1 x 4 (the reference's decode cell), StableLM on 2 x 2, every cell
    of ``build_cell`` with ``abstract`` (local shapes only), and a decode
    cell's drawn arguments."""
    import dataclasses
    from repro_torch import convert
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import common
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import lm
    line = Mesh((1, 4), ("data", "model"))
    nemo = tp_config("mistral-nemo-12b")
    out = {"nemo": serve_meshed(nemo, tp_params(nemo, ppath), _load(dpath),
                                line, NEMO_CP["seq_len"])}
    cfg = tp_config("stablelm-1.6b")
    grid = Mesh((2, 2), ("data", "model"))
    data = serve_inputs(cfg, SERVE_PROMPT, SERVE_STEPS)
    out["stablelm 2x2"] = serve_meshed(cfg, tp_params(cfg, lm_path), data,
                                       grid, SERVE_PROMPT)
    cells = {}
    for kind in ("train", "prefill", "decode"):
        _, args = common.build_cell(cfg, ShapeConfig(kind, 32, 4, kind),
                                    grid, abstract=True)
        cells[kind] = [(tuple(t.shape), str(t.device))
                       for t in leaves(args)]
    out["cells"] = cells
    rg = dataclasses.replace(tp_config("recurrentgemma-2b"),
                             dtype="bfloat16")
    shape = ShapeConfig("decode", 16, 4, "decode")
    _, args = common.build_cell(rg, shape, line, device="cpu")
    layout = common.param_layout(rg, common.cell_rules(rg, shape, line),
                                 line)
    want = convert.model_blocks(lm.init(rg, seed=0, device="cpu"), layout)
    out["drawn"] = {
        "equal": all(torch.equal(a, b) for a, b in zip(leaves(args[0]),
                                                       leaves(want))),
        "split": sum(bool(sh.splits) for sh in leaves(layout)),
        "state": [(tuple(t.shape), float(t.float().abs().sum()))
                  for t in leaves(args[1])],
        "cache_len": _np(args[2]), "batch": _np(args[3]["tokens"])}
    return out
