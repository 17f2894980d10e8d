#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port on one NVIDIA card, and check it.

    python3 chip_smoke.py

1. Prints the card's name and power limit (``nvidia-smi``).  Without a card
   it exits non-zero and prints no result.
2. Builds every kernel from ``src/repro_torch/kernels/csrc/`` with ``nvcc``
   for ``sm_90a`` into ``build/kernels/`` (one ``nvcc`` per source, all at
   once).
3. Holds each kernel entry against its plain PyTorch version in bf16 at the
   main paths' own shapes, and times kernel, plain version, the one
   PyTorch call that computes the same function where there is one
   (``library_ms``, a yardstick the port never calls), and the bound.  The
   flash kernels (forward and backward) are also fed planted faults (a
   skipped KV tile, the diagonal key dropped, the last visible tile of a
   diagonal block skipped, the ragged-S mask off by one, the second
   64-column box of K at D 128 read one row late, the backward's D term
   dropped, one query tile's dQ dropped), which their checks must catch,
   and every flash launch must take the ``wgmma`` route.  The head's
   ``rmsnorm_gemm`` runs its ``tile`` route at M 1 and 8 and its ``wgmma``
   route at M 2048 and 8192, the latter timed beside the ``tile`` kernel
   and ``torch.matmul`` of the pre-normalized x; planted faults on the
   ``wgmma`` route (one row's r read as 1, the scale one K column late,
   one K stage skipped) must be caught.
4. Serving path: full-width StableLM-2-1.6B (random weights from a seed)
   through ``repro_torch.serving.ServeEngine``, both phases compiled by
   ``sma_jit`` (one compile per phase and row bucket), 8 requests with
   prompts of 64-512 tokens and 32 new tokens each, greedy.  A warm-up
   pass of the same requests compiles every signature (compile seconds
   and graph nodes printed per phase and bucket); the timed pass must
   compile nothing.  Checks that every request finishes with 32 tokens,
   that every kernel of the path was launched in that run as many times
   as predicted and on the predicted routes, and that the same pass under
   ``repro_torch.profile`` counts, in its tick spans, the scheduler's own
   mode switches.  Holds the compiled prefill tick and two decode ticks
   against the direct steps (logits, lengths, pools ``torch.equal``, the
   same launches and routes) and plants a lost pool write in a compiled
   decode graph, which the next tick's logits must show; times a compiled
   decode tick's host time against the direct step's (A B B A) and the
   device time of each.  Then one decode step's logits through the
   kernels against the same step through the plain versions, and a
   decode step with the GEMM entries through their autograd Functions
   and through the bare wrappers.
   Dense configs and resilience: full-width Mistral-NeMo-12B (20 of its
   40 layers, NEMO_SERVE_LAYERS; d_model 5120, GQA 32/8 at head_dim 128:
   the query width 4096 is not d_model; vocab 131,072) served the same
   way (compiled ticks against the direct steps with the planted lost
   write, host and device time),
   its kernels held and timed at its own shapes (the products, the decode
   head 5120 -> 131072, paged decode at GQA 4); no pass without faults may
   fail a tick, evict or fail a request.  Chaos on its compiled engine,
   each against the unfaulted pass: (a) a ``serve.tick`` fault retried
   whole, (b) a request's pool blocks poisoned after its first decode
   tick and evicted after its retries, the others unchanged, (c) an
   ``sma_gemm@cuda`` fault in the middle of a decode tick, after layers
   wrote the pools in place, retried whole into the same tokens, (d) a
   late tick counted by the watchdog, (e) ``check_numerics="raise"`` with
   a NaN raising ``FloatingPointError``, (f) an ``engine.compile`` fault
   on a fresh signature, the next call compiling; the report's
   ``resilience`` section.  The deprecated slot ``Server`` (4 slots,
   ``cache_size`` 1024) against a direct loop that re-feeds the last
   prompt token; ``repro_torch.launch.serve.main`` at full width; a
   3-layer model's decode logits against the plain versions with planted
   faults (one of them every query head on KV head 0).  The input modes
   at full width: musicgen-large on ``embeds`` through the compiled engine
   (compiled ticks equal direct), internvl2-2b's ``lm.forward`` with 256
   vision embeddings ahead of 256 tokens through ``sma_jit`` (launches and
   logits equal direct); their kernels held and timed at their own shapes
   (the products at M 4 and 1024, both heads, internvl's flash at GQA 16/8
   and head_dim 128), and 3-layer full-width models of each against the
   plain versions with planted faults (musicgen's decode logits,
   internvl's forward logits).  With ``--parent DIR`` (another checkout), first
   times the compiled StableLM decode tick's host time of both trees A B
   B A (``host_times.py``, one process a reading).
5. Training path: one step of a 4-layer full-width model through the
   kernels against the same step through the plain versions (loss, grad
   norm, every weight's gradient a layer at a time), and the same step with
   planted backward faults, which the limits must catch.  The train step
   through ``sma_jit`` against the direct step at 4 full-width layers: the
   loss and the gradients upstream of every flash dQ bit for bit, every
   other gradient, and each parameter's update and moment after one step,
   within twice the direct step's own run-to-run spread (the flash
   backward at head_dim 64 sums dQ in no fixed order) or a stated floor;
   the same
   launches and routes but the recomputations nothing reads; a zeroed
   weight-gradient site and a dropped AdamW write planted in the compiled
   modules, which must be caught.  ``train()`` with ``grad_compression``
   for 2 steps, and a run halted at step 2 and resumed, against unbroken
   runs.  Then ``repro_torch.launch.train.train`` on full-width,
   full-depth StableLM-2-1.6B, sequence 2048, batch 4, remat, 5 steps,
   its step compiled once by ``sma_jit`` (compile stages and graph nodes
   printed; 1 miss, 4 hits): finite losses that fall, launch counts as
   predicted, all ``wgmma``, nothing routed, step time, tokens/s, MFU and
   peak memory; the compiled step timed against the direct step A B B A
   (event and host ms, peak memory of each); a profile of one more
   compiled step.
   Front door: ``repro_torch.sma_jit(lm.forward)`` on full-width
   StableLM-2-1.6B at the trainer's B 4 x S 2048 under ``torch.no_grad``:
   the compile's stage times and plan summary; a second call is a cache
   hit and S 1024 compiles once more; one compiled forward launches what
   the direct forward launches (168 ``sma_gemm``, 1 ``rmsnorm_gemm``, 24
   flash, all ``wgmma``, nothing routed), its profile holds no cuBLAS or
   CUTLASS GEMM, and its logits equal the direct forward's bit for bit; a
   planted fault edited into the compiled module (one fused silu dropped)
   must fail that check; the fused, unfused (``fuse_runtime=False``) and
   direct forwards are timed, device and host-paced.
6. Recurrent path: the RG-LRU scan kernel against its plain version at
   the prefill's shape, bit for bit on its ``tma`` route (with planted
   faults: the carry reset mid-sequence, h_last one step early, a read one
   step late; inside the ``tma`` kernel a ring stage consumed one phase
   early, one stage's store dropped, the carry run past S into the
   zero-filled tail), timed beside the ``simt`` kernel (the earlier
   design) on the same inputs, the flash forward and the
   contiguous decode kernel at recurrentgemma's MQA head_dim 256, and its
   ``return_lse`` route (decode context parallelism) at a rank's slice of
   the ring (B 2, Hq 10, D 256, 1,024 slots, lengths 0, 1, 513, 1,024:
   ``lse = -inf`` and ``out = 0`` at 0), the merge of two halves against
   the whole ring; then
   full-width, full-depth RecurrentGemma-2B (random bf16 weights from a
   seed) through ``lm.prefill`` of 4 x 4,096 tokens and 32 greedy
   ``lm.decode_step``s, with launch counts as predicted and nothing
   routed, every scan on ``tma``; a 3-layer full-width model's prefill and
   decode logits through
   the kernels against the plain versions, with planted faults; and a
   profile of one prefill and a few decode steps.
7. xLSTM path: the chunkwise mLSTM kernels against their plain version (h
   and the final state) at the prefill's shape and at a ragged S (route
   ``wgmma``) and at a small head dim in f32 (route ``simt``), with
   planted faults (the state dropped at a chunk boundary, one key dropped,
   the input gate one step late; inside the ``wgmma`` kernels the lo half
   of the state update dropped, C_k handed to a chunk's outputs one chunk
   late, one chunk's S . D row sums dropped, C_k handed as its hi half
   alone), timed beside the ``simt``
   kernel on the same inputs; then full-width,
   full-depth xlstm-1.3b (random bf16 weights from a seed) through
   ``lm.prefill`` of 4 x 2,048 tokens and 32 greedy ``lm.decode_step``s,
   with launch counts as predicted, nothing routed, every mLSTM launch on
   ``wgmma`` and every head on ``tile``; a 3-layer
   full-width model's logits through the kernels against the plain
   versions, with planted faults; at XL_CUT_GROUPS groups a profile of
   one prefill and a few decode steps, and the host time of one sLSTM
   block's step loop.
   Every path checks the routes of ``rmsnorm_gemm`` (the training head on
   ``wgmma``, decode heads on ``tile``), ``mlstm_chunkwise`` and
   ``rglru_scan``.
   Both recurrent models also through the compiled ``ServeEngine`` at
   full width (xLSTM at 8 of its 48 layers, XL_CUT_GROUPS): 4 requests
   of 64-256-token prompts arriving one a tick, chunk 64, 16 new tokens,
   greedy, 4 rows; each prefill chunk of a recurrent layer runs token by
   token as one loop node.  A warm-up pass
   under ``repro_torch.profile`` compiles every (phase, bucket)
   (compile s, graph nodes, loop nodes and body nodes printed) and its
   tick spans must count the scheduler's switches; the timed pass
   compiles nothing, every tick launches as predicted, RecurrentGemma's
   windowed sites are routed once a tick; prefill and decode tick ms,
   TTFT, tokens/s and peak memory printed.  The compiled ticks against
   the direct steps (``torch.equal``, the same launches); an
   ``sma_gemm@cuda`` fault in the middle of a RecurrentGemma prefill tick
   retried into the same tokens; a 3-layer model served in chunks against
   the plain versions, with planted K-tile faults.
8. MoE path: the kernels at Qwen3-30B-A3B's shapes (its products and
   router, the decode head 2048 -> 152064, paged decode at GQA 32/4 of
   128), each with a planted fault, and its expert products (library
   ``bmm``s) timed with their bounds.  Then, on a clean card (at most 1
   GiB left allocated), full-width, full-depth Qwen3-30B-A3B (48 layers,
   128 experts top 8; 56.9 GiB of random bf16 weights from a seed, the
   init's peak printed) through the compiled ``ServeEngine``, the serve
   run of item 4: compiles, launches (5 ``sma_gemm`` a layer: q, k, v, o,
   the router), routes, mode switches and peak memory checked, and the
   mean ``moe_drop_frac`` of its prefill ticks read from the direct steps
   serving the same tokens.  The compiled ticks against the direct steps
   with the planted lost write, each run twice ``torch.equal`` (top-k and
   the combine are deterministic), host and device time of a decode tick
   and its device time by kind of kernel; the decode tick's bytes bound
   with every expert and with the experts the rows choose; a 3-layer
   model's decode logits against the plain versions pinned to the
   kernels' expert choices, the routing flips counted, with planted
   faults (the router's K tile dropped among them).
9. Training beyond the dense family.  The RG-LRU backward kernel against
   its plain version at the training shape (B 2, S 4096, D 2560), bit for
   bit on its ``tma`` route and on ``simt`` (timed beside it), with and
   without h0 and a gradient of h_last, fed two planted faults (the
   reverse carry reset at S/2, a shifted by one step); the flash forward
   and backward at Qwen3's call (GQA 32/4, D 128) and at head_dim 256 at
   RecurrentGemma's (MQA 10/1, window 2048) and a GQA one, each D 256
   backward called twice (``torch.equal``) and fed two planted faults (the
   middle key tile dropped in pass 1; one key tile left out of every dQ
   sum in pass 2, which must fail dq alone), RecurrentGemma's backward
   timed against scaled_dot_product_attention's, with each pass's device
   ms, ptxas report, shared memory and dS scratch; ``sma_gemm`` at
   both cells' training shapes (every product forward, its dA and dB, the
   head's dW and dnormed) and the head ``rmsnorm_gemm`` at 8,192 tokens,
   each with a planted K-tile fault.  The MoE layer's routing backward at
   Qwen3's full width, twice, which must be bit for bit, with the kernels
   autograd makes of its gathers.  The mLSTM backward kernel against its
   plain version (the closed form) at xLSTM's training shape (B 4, H 4, S
   2048, D 1024, bf16), with the gradient of h alone and with the final
   state's, fed three planted faults (the reverse state gradient reset at
   chunk nc/2, dq's inter-chunk terms dropped, dlog_f's reverse cumsum one
   step short); ``sma_gemm`` at xLSTM's training shapes too.  Then, each
   on a clean card, ``train()`` of full-width Qwen3-30B-A3B at 2 layers (B
   4 x S 2048), of full-width RecurrentGemma-2B at one group (13 layers, B
   2 x S 4096) and of full-width xlstm-1.3b at one group (8 layers, B 4 x
   S 2048; the sLSTM loop one loop node and one reverse loop node): 5
   compiled steps, finite losses, 1 miss and 4 hits, every kernel of the
   path launched on its route (every scan and its backward on ``tma``,
   the mLSTM forward on ``wgmma`` twice a layer a step, its backward on
   ``simt`` once), step time, tokens/s, MFU over the parameters in a
   token's products, ``moe_drop_frac``, peak memory; the compiled step
   against the direct one (event time A B B A, peak memory; the direct
   step's run-to-run spread a gradient printed; the loss and the
   gradients upstream of every flash dQ bit for bit, every gradient where
   that spread reads 0 for all of them (without attention, or with it
   only at head_dim 256), the rest within max(2 x the direct step's
   spread, JIT_TRAIN_FLOOR)); a profile of one compiled step.
10. Distribution (the "distributed" phase): ranks spawned with
   ``torch.multiprocessing`` on this one card over ``gloo`` (a
   ``file://`` store under ``build/dist``; NCCL refuses two ranks of one
   communicator on one device), each rank's collectives on CUDA tensors
   staged through pinned host memory over four gloo lanes, so nothing
   here measures NVLink.  The ranks report through files; only this
   process prints.  (a) ``sma_gemm_sharded`` at StableLM's MLP product
   (M 8192, 2048 -> 5632, bf16, silu) on a 1 x 2 and a 2 x 2 grid against
   one rank's ``ops.sma_gemm``: overlapped == serial, one ``wgmma`` launch
   a step, step 1's A-panel left unbroadcast caught; (b) ``pipeline_apply``
   over 2 stages of 2 full-width layers, 4 microbatches of (1, 2048),
   ``torch.equal`` to the layers run unpipelined, a dropped hand-off
   caught; (c) ``train(mesh=smoke_mesh())`` of full-width StableLM at
   ``DIST_TRAIN_LAYERS`` of its 24 layers on 2 ranks (B 2 a rank x S
   2048, the trainer phase's loop), FSDP over them (each rank's blocks
   drawn directly, each group's weights gathered in bf16 inside its
   body as one bucket, their gradients reduce-scattered): every step's
   master digests (in the history) equal across the ranks and the
   replicated masters ``torch.equal`` at the end, the gathered masters
   within the masters limit of (f) of each rank's unmeshed run, each
   rank's masters and moments its blocks, each step's loss and grad norm within ``dist_limits`` of two
   unmeshed runs at the same depth (one a rank, at once; their spread
   printed), step time, peak memory after initialisation (at most its
   blocks and one whole leaf, plus 10 %) and in the steps, the
   collectives' bytes a step by span, and the bytes and milliseconds
   staged through host; a run as long with two planted faults: every
   FSDP gather's gradient not summed over data, which keeps the replicas
   equal, read at every step against the limits (above them at step 2)
   and by its gathered masters (above the masters limit), and at the
   last step rank 1 keeping its local gradient at one
   all-reduce, caught by the replicas' digests; (d)
   ``compressed_psum`` on 4 ranks of (2048, 5632) f32 within one scale
   step a rank of the f32 mean, and a world-1 ``nccl`` group in this
   process running each ``repro_torch::`` collective once; (e)
   ``sma_jit(lm.forward)`` with ``SMAOptions(mesh=)`` on the 1 x 2 grid, 2
   full-width layers, B 4 x S 2048: logits within ``LOGIT_ATOL`` of the
   single-rank compiled forward, the report's comm bytes equal to
   ``summa_comm_stats`` over its sites and to the ``comm.bcast_*`` spans
   of a profiled call.  Tensor parallelism by the rules
   (``train(mesh=)`` with a ``model`` axis; every run full width, held
   against unmeshed ``train()`` runs of the same depth and loop under
   ``dist_limits``, the replicated leaves' digests equal across the
   ``model`` ranks every step, one compile, every kernel of the path
   launched on its route on the rank's local shapes, the report's comm
   bytes a step against ``collectives.BYTES``): (f) StableLM at
   ``DIST_TRAIN_LAYERS`` on a 1 x 2 mesh against (c)'s unmeshed runs, its
   gathered masters against theirs (each leaf's gap over its update, beside
   the two unmeshed runs' gap); (g) Qwen3-30B-A3B at
   ``QWEN3_TRAIN_LAYERS`` on 1 x 2, B 4 x S 2048, 64 experts a rank, the
   padded vocab's last 128 columns on rank 1, against the "train qwen3"
   phase's run (in ``--only-distributed`` one made here); (h)
   RecurrentGemma-2B on 1 x 2, one group cut to ``TP_RG_PATTERN`` (3
   layers), B 2 x S 4096: the RG-LRU scans on 1,280 channels a rank, the
   MQA KV head whole, flash at D 256, against an unmeshed run of its own;
   (i) StableLM at ``TP_MESH_LAYERS`` on a 2 x 2 mesh (4 ranks: data x
   tensor parallel, FSDP over data) against two unmeshed runs of its own;
   every run's memory after initialisation and in the steps, and its
   collectives' bytes by span.
   Planted faults, each a 2-step run: layer 0's MLP *g* skipped (StableLM,
   1 x 2), and the gate values' gradient (so the router's) not summed over
   ``model`` (Qwen3): each must read above the limits or part the
   replicas' digests; and a run of (f)'s length in which each rank updates
   its vocab block of the head with the other rank's gradient block (the
   replicas stay equal): its gathered masters must read above (f)'s
   masters limit.  Serving on a mesh (``launch.common``'s prefill and
   decode cells, full width and depth, each rank's blocks drawn
   directly): (j) RecurrentGemma-2B on 1 x 2, 5 query heads a rank, its
   MQA ring of 2,048 slots held as 1,024 a rank (decode context
   parallelism), a 2 x 4,096 prefill and 16 decode steps, and a 1,020-token
   prompt that leaves rank 1 empty until step 5; (k) StableLM on 2 x 2, a
   4 x 512 prefill and 16 decode steps; each rank's logits within
   SERVE_MESH_LIMIT of the unmeshed ``lm.prefill`` / ``lm.decode_step`` on
   rank 0, (j)'s key caches within SERVE_MESH_CACHE_LIMIT of the unmeshed
   caches' blocks, every local layer's decode on the kernel's ``lse``
   route; three planted faults in (j) (the merge dropping the other
   rank's partial, every rank writing the slot, the owner computed from
   the local slot) must read above a limit.  A rank that raises, or is
   not done in ``DIST_TIMEOUT``, fails the smoke.
11. Prints the kernel table as one JSON line (the redesigned kernels' rows
   with their route, the earlier design's time in the same call, and the
   ``-Xptxas -v`` registers, spills and shared memory), then the result line
   ``{"ok": true, "device": {...}}`` last.

Imports nothing of JAX or of the JAX package.  Any failed check raises and
the script exits non-zero before the result line.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import functools
import gc
import io
import json
import math
import re
import shutil
import subprocess
import sys
import time
import types
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
import torch.utils._pytree as pytree  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, DataPipeline  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import autograd as kautograd  # noqa: E402
from repro_torch.kernels import decode_attention as kdecode  # noqa: E402
from repro_torch.kernels import flash_attention as kflash  # noqa: E402
from repro_torch.kernels import mlstm as kmlstm  # noqa: E402
from repro_torch.kernels import norm_gemm as knorm  # noqa: E402
from repro_torch.kernels import rglru as krglru  # noqa: E402
from repro_torch.kernels import sma_gemm as kgemm  # noqa: E402
from repro_torch.launch.train import (TrainLoopConfig,  # noqa: E402
                                      direct_step, make_step, train)
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import lm, moe, recurrent  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402
from repro_torch.resilience import faults, guard  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402
from repro_torch.serving import (CacheConfig, PagedKVCache,  # noqa: E402
                                 Request, SchedulerConfig, ServeEngine)
from repro_torch.serving import model as smodel  # noqa: E402

ARCH = "stablelm-1.6b"
# H100 SXM data sheet, dense: bf16 tensor cores, f32 CUDA cores, HBM3.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# GEMM kernels vs plain versions, bf16 outputs: the reference's own tol_for
# (tests/test_kernels.py), |err| <= ATOL + RTOL * |plain| elementwise.  It
# covers one bf16 rounding flip of an output computed in another order.
RTOL = ATOL = 3e-2
# Decode attention vs its plain version, |err| <= ATTN_ATOL + ATTN_RTOL *
# |plain|.  Rows of 256-1024 keys average that many unit normals, so their
# outputs are only 0.03-0.08: RTOL passes one bf16 rounding flip (2^-7
# relative) and ATOL one flip of an output near 0.25.  The planted faults
# of attn_controls (a 64-token tile skipped, a page misindexed) must fail
# it on every such row.
ATTN_ATOL, ATTN_RTOL = 2e-3, 1e-2
# Logits, kernels vs plain versions, max |err| (hold_logits): every GEMM
# output is rounded to bf16 on both sides from sums taken in another order,
# and the flips compound through the layers.  On an H100 StableLM's decode
# step (24 layers) reads 0.078 and its smallest planted fault 0.172; at 3
# full-width layers Nemo's, musicgen's decode and internvl's forward over
# 1,024 positions read 0.031 / 0.023 / 0.047 and their weakest faults
# 0.27 / 0.45 / 0.48 (PERF.md); the limit lies between them.
LOGIT_ATOL = 0.12
COLD_BYTES = 160 << 20        # > 50 MB L2: rotate inputs so reads are cold
# time_ms's device-side sleep, ~20 ms at the H100's 1.755 GHz boost
# clock: longer than the host takes to queue 20 calls of any checked entry.
QUEUE_CYCLES = 35_000_000
# Flash forward vs its plain version, bf16 outputs, per element
# |err| <= FLASH_ATOL + FLASH_RTOL * |plain|: twice the decode attention's
# limit, since the kernel rounds P to bf16 before the PV product (the
# plain version keeps it f32).  Rows of few keys average values up to ~4,
# so P's rounding moves them by up to 2 bf16 ulps; at the decode limit
# the first run read 1.19 limits (PERF.md).
FLASH_ATOL, FLASH_RTOL = 4e-3, 2e-2
# Flash backward vs its plain version (fed the same out and lse): max |err|
# over a gradient tensor, relative to that tensor's max |plain|.  At head_dim
# 64 and 128 dq is summed by reduce-adds in the L2 in no fixed order, so its
# low bits vary by run; at 256 two calls give the same bits.
FLASH_GRAD_LIMIT = 2e-2
# A planted fault must fail the check on every row it moves by more than
# this many limits (measured on the plain version of the faulty inputs).
FAULT_MARGIN = 3.0
# One training step, 4 full-width layers, kernels vs plain versions (both
# bf16 compute, f32 masters): relative error of the loss, of the global
# grad norm, and of every weight's gradient a layer at a time (Frobenius).
# Every product's output is rounded to bf16 on both sides from sums taken
# in another order, and the flips compound through the layers and the
# backward.  On an H100 the loss and grad norm read 7e-6 and 8.7e-5, and
# wq of layer 0, the last MLP's wo and the head 0.007-0.013; the planted
# faults of STEP_FAULTS must read above these limits (PERF.md).
STEP_LIMITS = {"loss": 1e-4, "grad_norm": 1e-3, "grad": 3e-2}
TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH = 5, 2048, 4
# RecurrentGemma trains at full width, one group of its pattern (9 rglru + 4
# local layers), B 2 x S 4096: the window (2048) bites in the backward.
RG_TRAIN_BATCH, RG_TRAIN_SEQ, RG_TRAIN_GROUPS = 2, 4096, 1
# Qwen3-30B-A3B at full width, 2 layers (1.87 B parameters, 0.74 B active).
QWEN3_TRAIN_BATCH, QWEN3_TRAIN_SEQ, QWEN3_TRAIN_LAYERS = 4, 2048, 2
# xLSTM-1.3b at full width, one group of its pattern (7 mLSTM + 1 sLSTM
# layers, XL_CUT_GROUPS; 0.756 B parameters), B 4 x S 2048: 16 chunks of
# 128 a sequence, 2,048 sLSTM steps.
XL_TRAIN_BATCH, XL_TRAIN_SEQ = 4, 2048
# The trainer's peak rate (1 warmup step, cosine to 0 at step 5).  At the
# reference's default 3e-3 the full-width loss rises again after step 2,
# and by 0.4 nats more or less from dQ's summation order alone (PERF.md);
# at this rate it must fall from step 1 to step 5.
TRAIN_LR = 1e-3
H100_BF16 = 989e12            # dense bf16 tensor-core peak, for the MFU
# The compiled train step against the direct one (check_compiled_train_step,
# check_train_options): the relative error (Frobenius, a layer at a time)
# of every gradient, and of every parameter's update and moment after one
# step, must stay within max(2 x the direct step's own run-to-run spread,
# JIT_TRAIN_FLOOR).  The flash backward at head_dim 64 and 128 sums dQ with
# reduce-adds in no fixed order, so nothing downstream of such a dQ is
# bit-reproducible (at head_dim 256 it sums in a fixed order): on an
# H100 the direct-vs-direct spread of a gradient reads up to 8e-7, of an
# update from a stepped state up to 5.3e-3 (from zero moments, where
# Adam's update is about sign(g), 4.8e-2; PERF.md).  The planted faults of
# check_compiled_train_step (one weight gradient zeroed, one parameter
# write dropped) read ~1.0, fifty times this floor.
JIT_TRAIN_FLOOR = 2e-2
# A resumed run's loss at the step after the restore against the unbroken
# runs', relative: the floor of its limit (max(2 x their spread, this)).
# A restore onto the wrong batch moves it by ~1e-2 (other tokens).
RESUME_LOSS_FLOOR = 1e-4
# Steps queued back to back for each reading of the step timing (A B B A).
TIME_STEPS = 2

# The recurrent path: recurrentgemma-2b at full width.  The prompts are a
# multiple of the window (2048): the reference's cache layout after a
# longer prompt only matches its decode's ring slots then (ROADMAP.md).
RG_ARCH = "recurrentgemma-2b"
RG_BATCH, RG_PROMPT, RG_NEW = 4, 4096, 32
# RG-LRU kernel vs its plain version, per element |err| <= RGLRU_ATOL +
# RGLRU_RTOL * |plain|: both round the same f32 product and sum at every
# step, so they should agree exactly; the limit passes one rounding of a
# bf16 output and no more.  Each planted fault of check_rglru must fail it
# on every element it moves by more than FAULT_MARGIN limits.
RGLRU_ATOL, RGLRU_RTOL = 1e-6, 2.0 ** -8
# Logits of the 3-layer recurrent model (prefill's last position, then one
# decode step), kernels vs plain versions, max |err|.  On an H100 the noise
# reads 0.031 (one bf16 step of a logit near 4) and the faults of RG_FAULTS
# marked must 1.93 and 3.10 (PERF.md); the limit lies between them.
RG_LOGIT_ATOL = 0.1

# The xLSTM path: xlstm-1.3b at full width and depth.  2,048-token prompts
# are 16 chunks of 128, so the mLSTM state crosses 15 chunk boundaries.
XL_ARCH = "xlstm-1.3b"
XL_BATCH, XL_PROMPT, XL_NEW = 4, 2048, 32
# Its engine runs the first XL_CUT_GROUPS of its 6 groups (8 of 48 layers,
# full width), so that the training phases fit the script's time limit.
XL_CUT_GROUPS = 1
# mLSTM kernel vs its plain version.  h, per element, |err| <= atol + rtol
# * |plain|, (atol, rtol) by h's dtype: both sum the same f32 terms in
# other orders, so for bf16 rtol passes one rounding flip of h (2^-7) and
# atol the f32 noise of outputs near 0; f32 h is held at the reference's
# own tol_for (tests/test_kernels.py), 2e-4.  The state (f32), per tensor,
# max |err| <= MLSTM_STATE_LIMIT * max |plain|: on an H100 it reads ~4e-7
# (PERF.md).  Each planted fault of mlstm_controls must fail the h check
# on every element it moves by more than FAULT_MARGIN limits.
MLSTM_TOL = {torch.bfloat16: (2e-3, 2.0 ** -7), torch.float32: (2e-4, 2e-4)}
MLSTM_STATE_LIMIT = 1e-5
# check_mlstm's cases (B, H, S, D, dtype): the prefill's shape, a ragged
# S, a small head dim; chunk 128, xlstm-1.3b's.
MLSTM_CASES = [(XL_BATCH, 4, XL_PROMPT, 1024, torch.bfloat16),
               (XL_BATCH, 4, 2000, 1024, torch.bfloat16),
               (2, 4, 1000, 64, torch.float32)]
MLSTM_CHUNK = 128
# mLSTM backward kernel vs its plain version (the f32 closed form), per
# gradient max |err| / max |plain|: dq, dk and dv are rounded to bf16 (2^-9
# of the largest), and the kernel sums the same f32 terms in another
# order (by chunk, through the state; its wgmma route with every f32
# operand in hi + lo halves).  On an H100 the noise reads at most 0.0046
# (dk; dlog_f, dlog_i 1.1e-5, 1.7e-5; the wgmma route 0.00368, 1.3e-5,
# 2.4e-5) and the weakest planted fault of check_mlstm_bwd 0.243 (dlog_f's
# cumsum one step short; PERF.md).
MLSTM_BWD_LIMIT = 1e-2
# The backward's simt route at an f32 shape (B, H, S, D, chunk; S ragged,
# D not a multiple of 64), per gradient max |err| / max |plain|: both sides
# sum the same f32 terms in other orders, as the card tests' f32 limit
# (tests/test_torch_cuda.py MLSTM_BWD_LIMIT); on an H100 it reads at most
# 1.8e-5 (PERF.md).
MLSTM_BWD_SIMT_CASE = (2, 4, 1000, 200, 128)
MLSTM_BWD_F32_LIMIT = 1e-4
# Logits of the 3-layer xLSTM model (prefill's last position, then one
# decode step), kernels vs plain versions, max |err|; the faults of
# XL_FAULTS marked must lie above it (PERF.md).
XL_LOGIT_ATOL = 0.1

KERNEL_SOURCES = {
    "sma_gemm": ("src/repro_torch/kernels/csrc/sma_gemm.cu",
                 "src/repro/kernels/sma_gemm.py:83"),
    "rmsnorm_gemm": ("src/repro_torch/kernels/csrc/norm_gemm.cu",
                     "src/repro/kernels/norm_gemm.py:62"),
    "paged_decode_attention": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:78"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:78"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:101"),
    # The TPU kernel has no backward (no transpose rule for pallas_call);
    # this kernel is the gradient of the one it replaces.
    "flash_attention_bwd": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:101"),
    "rglru_scan": ("src/repro_torch/kernels/csrc/rglru_scan.cu",
                   "src/repro/kernels/rglru.py:55"),
    # The TPU kernel has no backward either (the reference's gradient comes
    # from its XLA associative scan); this kernel is the gradient of the one
    # it replaces.
    "rglru_scan_bwd": ("src/repro_torch/kernels/csrc/rglru_scan.cu",
                       "src/repro/kernels/rglru.py:55"),
    "mlstm_chunkwise": ("src/repro_torch/kernels/csrc/mlstm_chunkwise.cu",
                        "src/repro/kernels/mlstm.py:108"),
    # The TPU kernel has no backward (the reference's gradient comes from
    # JAX differentiating its XLA chunkwise path); this kernel is the
    # gradient of the one it replaces.
    "mlstm_chunkwise_bwd": ("src/repro_torch/kernels/csrc/mlstm_chunkwise.cu",
                            "src/repro/kernels/mlstm.py:108"),
}


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, args_list, iters: int = 20, paced: bool = False) -> float:
    """Mean device time of ``fn(*args)`` in ms over ``iters`` launches,
    cycling through ``args_list`` (copies that together exceed L2).

    The calls are queued behind a device-side sleep of QUEUE_CYCLES, so
    the card runs them back to back: a small kernel's host-side call (tens
    of us on the machines measured) would otherwise pace the card and be
    read as its time.  ``paced=True`` times them without the sleep: the
    host's pace where it is the slower."""
    for args in args_list[:3]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if not paced:
        torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def copies(nbytes: int) -> int:
    return max(1, min(16, math.ceil(COLD_BYTES / max(nbytes, 1))))


# Leading-axis rows compared at a time: the f32 temporaries of a training
# head's (8192, 256000) output stay ~1 GB each.
CHECK_ROWS = 1024


def limit_multiples(got: torch.Tensor, want: torch.Tensor, atol: float,
                    rtol: float) -> torch.Tensor:
    """Per leading-axis row, the largest |err| / (atol + rtol * |want|):
    above 1 where the row fails the tolerance."""
    out = []
    for g, w in zip(got.split(CHECK_ROWS), want.split(CHECK_ROWS)):
        g, w = g.float(), w.float()
        ratio = (g - w).abs() / (atol + rtol * w.abs())
        out.append(ratio.reshape(ratio.shape[0], -1).amax(1))
    return torch.cat(out)


def compare(got: torch.Tensor, want: torch.Tensor, what: str,
            atol: float = ATOL, rtol: float = RTOL) -> float:
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"{what}: shape {tuple(got.shape)} vs {tuple(want.shape)} or "
             f"non-finite output")
    err = max((g.float() - w.float()).abs().max().item()
              for g, w in zip(got.split(CHECK_ROWS), want.split(CHECK_ROWS)))
    if limit_multiples(got, want, atol, rtol).max().item() > 1:
        fail(f"{what}: kernel disagrees with its plain version "
             f"(max |err| {err:.4g})")
    return err


def bound(nbytes: float, flops: float, dtype: torch.dtype):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def entry(name, shape, err, ms, plain_ms, bound_pair, library_ms):
    source, replaces = KERNEL_SOURCES[name]
    return {"name": name, "shape": shape, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_pair[0],
            "bound_by": bound_pair[1], "library_ms": library_ms}


# ---------------------------------------------------------------------------
# Kernel checks at the serving path's shapes
# ---------------------------------------------------------------------------
# (M, K, N, epilogue).  Serving: decode (M 1, 8) and prefill ticks (M
# 1024, 2048).  Training, B*S = 8192 tokens: forward and dA products (M
# 8192), the dB products (K 8192; the head's dW and the MLP wo's dB are the
# largest) and the head's dnormed (K 100352).
SERVE_GEMMS = [(m, k, n, ep) for m in (1, 8, 1024, 2048)
               for k, n, ep in ((2048, 2048, "none"), (2048, 5632, "none"),
                                (2048, 5632, "silu"), (5632, 2048, "none"))]
TRAIN_GEMMS = [(8192, 2048, 2048, "none"), (8192, 2048, 5632, "none"),
               (8192, 2048, 5632, "silu"), (8192, 5632, 2048, "none"),
               (2048, 8192, 5632, "none"), (5632, 8192, 2048, "none"),
               (2048, 8192, 100352, "none"), (8192, 100352, 2048, "none")]


def check_sma_gemm(gen, dev, shapes, tag=""):
    out = []
    dt = torch.bfloat16
    for m, k, n, ep in shapes:
        a = torch.randn((m, k), generator=gen, device=dev).to(dt)
        ws = [(torch.randn((k, n), generator=gen, device=dev)
               * k ** -0.5).to(dt)
              for _ in range(copies(k * n * 2))]
        before = dict(kgemm.ROUTES)
        got = kgemm.sma_gemm(a, ws[0], epilogue=ep)
        route = kernel_route(kgemm.ROUTES, before, "sma_gemm")
        err = compare(got, ref.gemm_ref(a, ws[0], epilogue=ep),
                      f"sma_gemm M={m} {k}->{n} {ep}")
        args = [(a, w) for w in ws]
        big = 2 * m * n * k > 1e11
        ms = time_ms(lambda a_, w_: kgemm.sma_gemm(a_, w_, epilogue=ep),
                     args, 5 if big else 20)
        paced_ms = time_ms(
            lambda a_, w_: kgemm.sma_gemm(a_, w_, epilogue=ep), args,
            5 if big else 20, paced=True)
        plain_ms = time_ms(
            lambda a_, w_: ref.gemm_ref(a_, w_, epilogue=ep), args,
            3 if big else 20)
        lib_ms = (time_ms(torch.matmul, args, 5 if big else 20)
                  if ep == "none" else None)
        b = bound(2 * (m * k + k * n + m * n), 2 * m * n * k, dt)
        out.append(entry("sma_gemm", f"M={m} K={k} N={n} {ep} bf16{tag}",
                         err, ms, plain_ms, b, lib_ms))
        out[-1].update(gemm_route=route, paced_ms=paced_ms)
        del a, ws, got, args
    return out


def kernel_route(routes: dict, before: dict, what: str) -> str:
    """The one route of ``routes`` (a wrapper's ``.routes``) launched
    since ``before`` (a copy of it)."""
    moved = {r for r, n in routes.items() if n != before[r]}
    if len(moved) != 1:
        fail(f"{what}: routes {moved} since the last reading, expected one")
    return moved.pop()


def gemm_multiples(got, want):
    """Per element |err| / (ATOL + RTOL |plain|): above 1 where the GEMM
    check fails."""
    return ((got.float() - want.float()).abs()
            / (ATOL + RTOL * want.float().abs()))


def gemm_controls(gen, dev):
    """Planted faults fed to ``sma_gemm``, each held against the plain
    version of the right inputs: on the split-K route (M 8, 2048->5632) the
    last K slice of B zeroed; on the wgmma route (M 200, 2056->392: K one
    8-row step past the 64-deep tiles, N three boxes and a ragged fourth)
    the last, ragged K tile of B zeroed, and one 64-column box of B
    (columns 64-127, the second box of the first tile) negated.  Each
    must fail the check on every element it moves by more than
    FAULT_MARGIN limits (measured on the plain version of the faulty
    inputs)."""
    dt = torch.bfloat16
    cases = []
    m, k, n = 8, 2048, 5632
    slices, kslice = kgemm._slices(n, k)
    a = torch.randn((m, k), generator=gen, device=dev).to(dt)
    w = (torch.randn((k, n), generator=gen, device=dev) * k ** -0.5).to(dt)
    bad = w.clone()
    bad[(slices - 1) * kslice:] = 0
    cases.append((f"split-K, last K slice (rows {(slices - 1) * kslice}-"
                  f"{k - 1} of {slices}) zeroed", "splitk", a, w, bad))
    m, k, n = 200, 2056, 392
    a = torch.randn((m, k), generator=gen, device=dev).to(dt)
    w = (torch.randn((k, n), generator=gen, device=dev) * k ** -0.5).to(dt)
    bad = w.clone()
    bad[k // 64 * 64:] = 0
    cases.append((f"wgmma, last ragged K tile (rows {k // 64 * 64}-{k - 1}) "
                  f"zeroed", "wgmma", a, w, bad))
    bad = w.clone()
    bad[:, 64:128] = -bad[:, 64:128]
    cases.append(("wgmma, one 64-column box of B (columns 64-127) negated",
                  "wgmma", a, w, bad))
    for name, route, a, w, bad in cases:
        want = ref.gemm_ref(a, w)
        effect = gemm_multiples(ref.gemm_ref(a, bad), want)
        before = dict(kgemm.ROUTES)
        got = gemm_multiples(kgemm.sma_gemm(a, bad), want)
        if kernel_route(kgemm.ROUTES, before, "sma_gemm") != route:
            fail(f"sma_gemm control '{name}' did not take the {route} route")
        must = effect > FAULT_MARGIN
        n_must, n_caught = int(must.sum()), int((got[must] > 1).sum())
        print(f"sma_gemm control, {name}: moves {n_must} of {must.numel()} "
              f"elements by > {FAULT_MARGIN} limits; the check fails "
              f"{n_caught} of them (min multiple "
              f"{got[must].min().item() if n_must else 0:.3g})")
        if n_must == 0 or n_caught < n_must:
            fail(f"sma_gemm control '{name}' passes the check where it "
                 f"moves the output")


# rmsnorm_gemm at the head's shapes, M tokens: the decode heads (1, 8; the
# ``tile`` route), a prefill-sized one and the training head (2048, 8192;
# ``wgmma``).
NORM_MS = (1, 8, 2048, TRAIN_SEQ * TRAIN_BATCH)


def norm_gemm_plain(x, r, scale, w):
    """The head's plain version with its row inverse RMS ``r`` given:
    round(x * r * scale) to x's dtype, then the f32 product, rounded
    (``ref.rmsnorm_gemm_ref``'s arithmetic)."""
    normed = (x.float() * r[:, None] * scale.float()).to(x.dtype)
    return torch.matmul(normed.float(), w.float()).to(x.dtype)


def ptxas_entries(name: str, part: str) -> dict:
    """Registers, spills and static shared memory that ``-Xptxas -v``
    reported for each kernel of ``build/kernels/<name>.ptxas`` whose
    mangled name holds ``part`` (the name cut before its parameters)."""
    out, fn = {}, ""
    log = _build.BUILD_DIR / f"{name}.ptxas"
    for line in log.read_text().splitlines() if log.exists() else ():
        if "Compiling entry function" in line:
            fn = line.split("'")[1].split("EEv")[0][:72]
        elif part in fn and ("registers" in line or "spill" in line):
            out.setdefault(fn, []).append(line.split(":", 1)[-1].strip())
    return {k: "; ".join(v) for k, v in out.items()}


def check_rmsnorm_gemm(gen, dev):
    """rmsnorm_gemm against its plain version at NORM_MS, 2048 -> 100352
    (the head), each on its route; the wgmma route (M 8192) also timed as
    the tile kernel on the same inputs, and the product of the
    pre-normalized x by ``torch.matmul`` (a yardstick of the GEMM alone,
    never called by the port); planted faults at M 2048."""
    out = []
    dt = torch.bfloat16
    k, n = 2048, lm.padded_vocab(get_config(ARCH))
    w = (torch.randn((k, n), generator=gen, device=dev) * k ** -0.5).to(dt)
    scale = torch.rand((k,), generator=gen, device=dev) + 0.5
    for m in NORM_MS:
        x = (torch.randn((m, k), generator=gen, device=dev) * 3).to(dt)
        before = dict(knorm.ROUTES)
        got = knorm.rmsnorm_gemm(x, scale, w)
        route = kernel_route(knorm.ROUTES, before, f"rmsnorm_gemm M={m}")
        if route != ("tile" if m <= 16 else "wgmma"):
            fail(f"rmsnorm_gemm M={m} took the {route} route")
        err = compare(got, ref.rmsnorm_gemm_ref(x, scale, w),
                      f"rmsnorm_gemm M={m} {k}->{n}")
        args = [(x, scale, w)]
        iters = 20 if m <= 8 else 3
        ms = time_ms(knorm.rmsnorm_gemm, args, iters)
        plain_ms = time_ms(ref.rmsnorm_gemm_ref, args, iters)
        b = bound(2 * (m * k + k * n + m * n) + 4 * k, 2 * m * n * k, dt)
        row = entry("rmsnorm_gemm", f"M={m} K={k} N={n} none bf16", err,
                    ms, plain_ms, b, None)
        row["kernel_route"] = route
        if route == "wgmma":
            r = ref.rms_inverse(x).reshape(m)
            sc = scale.float()
            if m == 2048:
                norm_controls(x, r, sc, w)
            if m == NORM_MS[-1]:
                row["earlier_ms"] = time_ms(
                    lambda *a: knorm._launch(*a, route="tile"),
                    [(x, r, sc, w)], iters)
                normed = (x.float() * r[:, None] * sc).to(dt)
                row["matmul_ms"] = time_ms(torch.matmul, [(normed, w)],
                                           iters)
                row["ptxas"] = ptxas_entries("norm_gemm", "gemm_wgmma")
                row["smem_bytes"] = knorm._lib().norm_gemm_wgmma_smem()
                del normed
        out.append(row)
    return out


def norm_controls(x, r, scale, w):
    """Planted faults fed to rmsnorm_gemm's wgmma route (``knorm._launch``
    with the row inverse RMS given) at M 2048, 2048 -> 100352, each held
    against the plain version of the right inputs: one row's r read as 1
    (row 77), the scale read one K column late (column k scaled by
    scale[k - 1]), one K stage skipped (W's rows 1024-1087, the 17th
    64-deep stage, zeroed).  Each must fail the GEMM check on every element
    it moves by more than FAULT_MARGIN limits (measured on the plain
    version of the faulty inputs)."""
    want = norm_gemm_plain(x, r, scale, w)
    r_one = r.clone()
    r_one[77] = 1.0
    w_skip = w.clone()
    w_skip[1024:1088] = 0
    faults = {"one row's r read as 1 (row 77)": (r_one, scale, w),
              "the scale read one K column late": (
                  r, torch.cat([scale[:1], scale[:-1]]), w),
              "one K stage skipped (W rows 1024-1087)": (r, scale, w_skip)}
    for name, (rr, ss, ww) in faults.items():
        effect = gemm_multiples(norm_gemm_plain(x, rr, ss, ww), want)
        got, route = knorm._launch(x, rr, ss, ww)
        if route != "wgmma":
            fail(f"rmsnorm_gemm control '{name}' took the {route} route")
        bad = gemm_multiples(got, want)
        must = effect > FAULT_MARGIN
        n_must, n_caught = int(must.sum()), int((bad[must] > 1).sum())
        print(f"rmsnorm_gemm control, {name}: moves {n_must} of "
              f"{must.numel()} elements by > {FAULT_MARGIN} limits; the "
              f"check fails {n_caught} of them (min multiple "
              f"{bad[must].min().item() if n_must else 0:.3g})")
        if n_must == 0 or n_caught < n_must:
            fail(f"rmsnorm_gemm control '{name}' passes the check where it "
                 f"moves the output")
        del effect, got, bad, must
    del want, w_skip


#: rmsnorm_gemm's, mlstm_chunkwise's and rglru_scan's routes each path's
#: run launched, filled as the paths run.
ROUTES_BY_PATH = {}


def check_kernel_routes(where: str, counts: dict, norm: str,
                        mlstm: str = "wgmma", scan: str = "tma") -> dict:
    """Every rmsnorm_gemm launch in ``counts`` (``ops.launch_counts``
    since the last ``ops.reset_counts``) went the ``norm`` route, every
    mlstm_chunkwise launch the ``mlstm`` route and every rglru_scan launch
    the ``scan`` route; returns the launches by route."""
    got = {"rmsnorm_gemm": nonzero(knorm.ROUTES),
           "mlstm_chunkwise": nonzero(kmlstm.ROUTES),
           "rglru_scan": nonzero(krglru.ROUTES)}
    for name, route in (("rmsnorm_gemm", norm), ("mlstm_chunkwise", mlstm),
                        ("rglru_scan", scan)):
        want = {route: counts[name]} if counts.get(name) else {}
        if got[name] != want:
            fail(f"{where}: {name} routes {got[name]}, expected {want}")
    return got


KV_LENS = (0, 1, 17, 100, 256, 511, 777, 1024)


def by_len(multiples: torch.Tensor) -> dict:
    return {n: round(x, 4) for n, x in zip(KV_LENS, multiples.tolist())}


def attn_controls(q, k_pool, v_pool, table, lens, want, bs):
    """Planted faults fed to the paged kernel, each held against the plain
    version of the right inputs: a skipped last 64-token tile and one
    misindexed full page must fail the attention tolerance on every row of
    256 keys or more, and the newest key dropped on every non-empty row."""
    long = [r for r, n in enumerate(KV_LENS) if n >= 256]
    skipped = lens.clone()
    skipped[long] -= 64
    misindexed = table.clone()
    for r in long:
        misindexed[r, KV_LENS[r] // bs - 2] = table[(r + 1) % len(KV_LENS), 0]
    faults = {"last 64-token tile skipped": (table, skipped, long),
              "one full page misindexed": (misindexed, lens, long),
              "newest key dropped": (table, (lens - 1).clamp(min=0),
                                     [r for r, n in enumerate(KV_LENS) if n])}
    for name, (tbl, lns, rows) in faults.items():
        bad = kdecode.paged_decode_attention(q, k_pool, v_pool, tbl, lns)
        mult = limit_multiples(bad, want, ATTN_ATOL, ATTN_RTOL)
        print(f"paged decode control, {name}: limit multiple by kv_len "
              f"{by_len(mult)}")
        if (mult[rows] <= 1).any():
            fail(f"paged decode control '{name}' passes the attention "
                 f"tolerance on a row it changes")


def paged_table(dev, nb: int, bs: int, smax: int) -> torch.Tensor:
    """Block tables of 8 rows of KV_LENS tokens over randomly permuted
    pages of a pool of ``nb`` blocks; unused entries hold the sentinel."""
    perm = np.random.default_rng(0).permutation(nb)
    table = np.full((len(KV_LENS), smax // bs), nb, np.int32)
    used = 0
    for r, n in enumerate(KV_LENS):
        pages = max(1, -(-n // bs))
        table[r, :pages] = perm[used:used + pages]
        used += pages
    return torch.from_numpy(table).to(dev)


def check_decode(gen, dev):
    """Paged entry at the engine's pool geometry, then the contiguous
    entry: B=8, Hq=Hkv=32, D=64, BS=16, ragged kv_len including 0."""
    dt = torch.bfloat16
    b, h, d, bs, nb, smax = 8, 32, 64, 16, 512, 1024
    mb = smax // bs
    lens = torch.tensor(KV_LENS, dtype=torch.int32, device=dev)
    table = paged_table(dev, nb, bs, smax)
    q = torch.randn((b, h, d), generator=gen, device=dev).to(dt)
    pools = [tuple(torch.randn((nb, h, bs, d), generator=gen,
                               device=dev).to(dt) for _ in range(2))
             for _ in range(2)]
    total = sum(KV_LENS)
    nbytes = 2 * 2 * b * h * d + 2 * 2 * total * h * d + 4 * (b * mb + b)
    flops = 4 * total * h * d
    out = []

    got = kdecode.paged_decode_attention(q, *pools[0], table, lens)
    want = ref.paged_decode_attention_ref(q, *pools[0], table, lens)
    if got[0].abs().max().item() != 0.0:
        fail("paged decode: kv_len 0 row is not 0")
    err = compare(got, want, "paged_decode_attention", ATTN_ATOL, ATTN_RTOL)
    print(f"paged decode, kernel vs plain: limit multiple by kv_len "
          f"{by_len(limit_multiples(got, want, ATTN_ATOL, ATTN_RTOL))}")
    attn_controls(q, *pools[0], table, lens, want, bs)
    args = [(q, kp, vp, table, lens) for kp, vp in pools]
    out.append(entry(
        "paged_decode_attention",
        f"B={b} Hq=Hkv={h} D={d} BS={bs} NB={nb} kv_len={list(KV_LENS)} bf16",
        err, time_ms(kdecode.paged_decode_attention, args),
        time_ms(ref.paged_decode_attention_ref, args),
        bound(nbytes, flops, dt), None))
    out[-1]["paced_ms"] = time_ms(kdecode.paged_decode_attention, args,
                                  paced=True)

    caches = [tuple(torch.randn((b, h, smax, d), generator=gen,
                                device=dev).to(dt) for _ in range(2))
              for _ in range(2)]
    got = kdecode.decode_attention(q, *caches[0], lens)
    err = compare(got, ref.decode_attention_ref(q, *caches[0], lens),
                  "decode_attention", ATTN_ATOL, ATTN_RTOL)
    args = [(q, kc, vc, lens) for kc, vc in caches]
    mask = (torch.arange(smax, device=dev)[None, :]
            < lens[:, None])[:, None, None, :]

    def sdpa(q_, k_, v_, _lens):
        return F.scaled_dot_product_attention(q_[:, :, None], k_, v_,
                                              attn_mask=mask)

    out.append(entry(
        "decode_attention",
        f"B={b} Hq=Hkv={h} D={d} Smax={smax} kv_len={list(KV_LENS)} bf16",
        err, time_ms(kdecode.decode_attention, args),
        time_ms(ref.decode_attention_ref, args),
        bound(nbytes - 4 * b * mb, flops, dt), time_ms(sdpa, args)))
    out[-1]["paced_ms"] = time_ms(kdecode.decode_attention, args,
                                  paced=True)
    return out


# ---------------------------------------------------------------------------
# Flash attention, forward and backward, at the trainer's shapes
# ---------------------------------------------------------------------------
FLASH_CASES = {   # bf16, causal: (B, S, Hq, Hkv, window, D)
    "causal": (TRAIN_BATCH, TRAIN_SEQ, 32, 32, None, 64),
    "GQA 32/8": (TRAIN_BATCH, TRAIN_SEQ, 32, 8, None, 64),
    "window 512": (TRAIN_BATCH, TRAIN_SEQ, 32, 32, 512, 64),
    "GQA 32/8 D 128": (TRAIN_BATCH, TRAIN_SEQ, 32, 8, None, 128),
    # Qwen3-30B-A3B's training call
    "GQA 32/4 D 128": (QWEN3_TRAIN_BATCH, QWEN3_TRAIN_SEQ, 32, 4, None, 128),
    # RecurrentGemma-2B's training call, and a GQA one at D 256
    "MQA 10/1 D 256 window 2048": (RG_TRAIN_BATCH, RG_TRAIN_SEQ, 10, 1, 2048,
                                   256),
    "GQA 4/2 D 256 window 64": (2, 512, 4, 2, 64, 256),
}
#: The cases timed: in which directions (the D 256 forward is timed at
#: RecurrentGemma's prefill shape, check_flash_mqa), and the launches timed
#: of the kernel, its plain version and the library call.
FLASH_TIMED = {"causal": (("fwd", "bwd"), (20, 3, 20)),
               "MQA 10/1 D 256 window 2048": (("bwd",), (5, 1, 3))}
# The wgmma kernels' tiles (csrc/flash_attention.cu): 128 query rows and
# 128 keys a forward block (64 keys at D 256), 64 query rows a backward tile.
FLASH_BQ, FLASH_TK, FLASH_BWD_BQ = 128, 128, 64


def flash_inputs(gen, dev, hq, hkv, seq=TRAIN_SEQ, b=TRAIN_BATCH, d=64):
    def rn(h):
        return torch.randn((b, h, seq, d), generator=gen,
                           device=dev).to(torch.bfloat16)
    return rn(hq), rn(hkv), rn(hkv), rn(hq)


def visible_pairs(sq, skv, window, dev) -> int:
    """(query, key) pairs the kernel must score, per (batch, head)."""
    return int(ref.flash_mask(sq, skv, causal=True, window=window,
                              device=dev).sum())


def row_multiples(got, want, atol=FLASH_ATOL, rtol=FLASH_RTOL):
    """Per (batch, head, query row), the largest |err| / (atol + rtol *
    |want|) over the row's head_dim: above 1 where the row fails."""
    ratio = (got.float() - want.float()).abs() / (atol + rtol
                                                  * want.float().abs())
    return ratio.amax(-1)


def grad_error(got, want) -> float:
    """max |err| of a gradient relative to its max |plain|."""
    if not torch.isfinite(got.float()).all():
        return math.inf
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def fault_caught(name, effect, bad):
    """A planted forward fault: ``effect`` and ``bad`` are the row limit
    multiples of the plain version and of the kernel on the faulty inputs.
    The check must fail every row the fault moves by > FAULT_MARGIN."""
    must = effect > FAULT_MARGIN
    n_must, n_caught = int(must.sum()), int((bad[must] > 1).sum())
    print(f"flash control, {name}: moves {n_must} of {must.numel()} rows by "
          f"> {FAULT_MARGIN} limits (largest {effect.max().item():.3g}); "
          f"the check fails {n_caught} of them (min multiple "
          f"{bad[must].min().item() if n_must else 0:.3g}) and "
          f"{(bad > 1).float().mean():.3f} of all rows")
    if n_must == 0 or n_caught < n_must:
        fail(f"flash control '{name}' passes the check on a row it changes")


def flash_controls(q, k, v, dout, out, lse):
    """Planted faults fed to the kernels at B 4, H 32, S 2048, D 64,
    causal, each held against the plain version of the right inputs.

    Forward: the 64 newest keys of every query dropped (row i + 64 run with
    keys 0..i); the diagonal key dropped (row i + 1 run with keys 0..i);
    the last visible KV tile of a diagonal block skipped (the block's 128
    rows run with the keys before its diagonal tile, unmasked), for blocks
    1, 4 and 15; the ragged-S mask off by one (non-causal, Skv 9 and 128,
    run with one key more).  Each must fail the forward check on every row
    it moves by more than FAULT_MARGIN limits.  Backward: the D =
    rowsum(dO * O) term dropped (O fed as zeros) must fail the dq and dk
    checks; one query tile's dQ dropped (dO of rows 64-127, or 1024-1087,
    of one head zeroed, which zeroes those rows' dS and so every dQ
    reduce-add they get) must fail the dq check."""
    want = ref.flash_attention_ref(q, k, v)[0]
    for name, drop in (("KV tile skipped (64 newest keys)", 64),
                       ("diagonal key dropped", 1)):
        args = (q[:, :, drop:], k[:, :, :-drop], v[:, :, :-drop])
        fault_caught(name,
                     row_multiples(ref.flash_attention_ref(*args)[0],
                                   want[:, :, drop:]),
                     row_multiples(kflash.flash_attention_fwd(*args)[0],
                                   want[:, :, drop:]))
    for blk in (1, 4, 15):
        rows = slice(blk * FLASH_BQ, (blk + 1) * FLASH_BQ)
        keys = slice(0, blk * FLASH_BQ)
        args = (q[:, :, rows], k[:, :, keys], v[:, :, keys])
        fault_caught(f"last visible KV tile of diagonal block {blk} "
                     f"skipped",
                     row_multiples(ref.flash_attention_ref(
                         *args, causal=False)[0], want[:, :, rows]),
                     row_multiples(kflash.flash_attention_fwd(
                         *args, causal=False)[0], want[:, :, rows]))
    for skv in (9, FLASH_TK):
        qs = q[:, :, :256]
        good = ref.flash_attention_ref(qs, k[:, :, :skv], v[:, :, :skv],
                                       causal=False)[0]
        args = (qs, k[:, :, :skv + 1], v[:, :, :skv + 1])
        fault_caught(f"ragged-S mask off by one (Skv {skv} read as "
                     f"{skv + 1})",
                     row_multiples(ref.flash_attention_ref(
                         *args, causal=False)[0], good),
                     row_multiples(kflash.flash_attention_fwd(
                         *args, causal=False)[0], good))
    wants = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout)
    bad = kflash.flash_attention_bwd(q, k, v, torch.zeros_like(out), lse,
                                     dout)
    errs = [grad_error(g, w) for g, w in zip(bad, wants)]
    print(f"flash control, backward D term dropped: dq {errs[0]:.4g}, dk "
          f"{errs[1]:.4g}, dv {errs[2]:.4g} (limit {FLASH_GRAD_LIMIT}): "
          f"{errs[0] / FLASH_GRAD_LIMIT:.3g} and "
          f"{errs[1] / FLASH_GRAD_LIMIT:.3g} limits")
    if min(errs[:2]) <= FLASH_GRAD_LIMIT:
        fail("flash control 'D term dropped' passes the dq or dk check")
    for tile in (1, 16):
        rows = slice(tile * FLASH_BWD_BQ, (tile + 1) * FLASH_BWD_BQ)
        hole = dout.clone()
        hole[0, 0, rows] = 0
        dq_bad = kflash.flash_attention_bwd(q, k, v, out, lse, hole)[0]
        err = grad_error(dq_bad, wants[0])
        print(f"flash control, dQ of query tile {tile} (rows {rows.start}-"
              f"{rows.stop - 1}, batch 0, head 0) dropped: dq {err:.4g} = "
              f"{err / FLASH_GRAD_LIMIT:.3g} limits")
        if err <= FLASH_GRAD_LIMIT:
            fail(f"flash control 'dQ of query tile {tile} dropped' passes "
                 f"the dq check")


def flash_box_control(q, k, v, want):
    """Planted fault at D 128, causal: the second 64-column box of K read
    one row late (K's columns 64-127 taken from the next key).  It must
    fail the forward check on every row it moves by more than FAULT_MARGIN
    limits."""
    bad_k = k.clone()
    bad_k[..., :-1, 64:] = k[..., 1:, 64:]
    fault_caught("second 64-column box of K at D 128 read one row late",
                 row_multiples(ref.flash_attention_ref(q, bad_k, v)[0],
                               want),
                 row_multiples(kflash.flash_attention_fwd(q, bad_k, v)[0],
                               want))


#: The flash routes each path's run launched, filled as the paths run.
FLASH_ROUTES_BY_PATH = {}


def check_flash_routes(where: str, counts: dict) -> dict:
    """Every flash launch in ``counts`` (``ops.launch_counts`` since the
    last ``ops.reset_counts``) went the ``wgmma`` route; returns the
    launches by route."""
    got = {"flash_attention": nonzero(kflash.FWD_ROUTES),
           "flash_attention_bwd": nonzero(kflash.BWD_ROUTES)}
    for name in got:
        want = {"wgmma": counts[name]} if counts.get(name) else {}
        if got[name] != want:
            fail(f"{where}: {name} routes {got[name]}, expected {want}")
    return got


def check_flash(gen, dev):
    """Each case: forward (out, lse) and backward (dq, dk, dv, fed the
    kernel's out and lse) against the plain versions; the causal case also
    feeds the planted faults of :func:`flash_controls`, each D 128 case
    :func:`flash_box_control`, and each D 256 case
    :func:`flash_bwd256_controls`.  The cases of FLASH_TIMED are timed."""
    rows = []
    ops.reset_counts()
    for case, (b, s, hq, hkv, window, d) in FLASH_CASES.items():
        q, k, v, dout = flash_inputs(gen, dev, hq, hkv, seq=s, b=b, d=d)
        out, lse = kflash.flash_attention_fwd(q, k, v, window=window)
        want, want_lse = ref.flash_attention_ref(q, k, v, window=window)
        mult = row_multiples(out, want)
        err = (out.float() - want.float()).abs().max().item()
        lse_err = (lse - want_lse).abs().max().item()
        del want_lse
        grads = kflash.flash_attention_bwd(q, k, v, out, lse, dout,
                                           window=window)
        wants = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                            window=window)
        gerr = {n: grad_error(g, w)
                for n, g, w in zip(("dq", "dk", "dv"), grads, wants)}
        gabs = {n: (g.float() - w.float()).abs().max().item()
                for n, g, w in zip(("dq", "dk", "dv"), grads, wants)}
        print(f"flash {case} (B {b}, S {s}): out max |err| {err:.4g} (max "
              f"limit multiple {mult.max().item():.3g} of {FLASH_ATOL} + "
              f"{FLASH_RTOL}|plain|), lse {lse_err:.3g}; grads max |err| "
              f"{json.dumps({n: round(x, 5) for n, x in gabs.items()})}, "
              f"relative to max |plain| "
              f"{json.dumps({n: round(x, 5) for n, x in gerr.items()})} "
              f"(limit {FLASH_GRAD_LIMIT})")
        if not torch.isfinite(out.float()).all() or mult.max() > 1:
            fail(f"flash forward {case}: kernel disagrees with its plain "
                 f"version")
        if lse_err > 1e-2:
            fail(f"flash forward {case}: lse off by {lse_err:.3g}")
        if max(gerr.values()) > FLASH_GRAD_LIMIT:
            fail(f"flash backward {case}: {gerr} over {FLASH_GRAD_LIMIT}")
        if d == 128:
            flash_box_control(q, k, v, want)
        del want
        if d == 256:
            flash_bwd256_controls(case, (q, k, v, out, lse, dout), window,
                                  grads, wants)
        del grads
        if case == "causal":
            routes = check_flash_routes("flash checks", ops.launch_counts())
            print(f"flash routes of the checks so far: {json.dumps(routes)}")
            flash_controls(q, k, v, dout, out, lse)
        if case in FLASH_TIMED:
            rows += flash_rows(gen, dev, (q, k, v, dout), window, gabs,
                               err, *FLASH_TIMED[case])
        del q, k, v, dout, out, lse, wants
        torch.cuda.empty_cache()
    check_flash_routes("flash checks", ops.launch_counts())
    return rows


def flash_bwd256_controls(case, args, window, grads, wants):
    """The D 256 backward sums in a fixed order: a second call gives the
    same dq, dk and dv (``torch.equal``).  Its planted faults: the middle
    key tile dropped in pass 1 (``plant`` 1) must fail the dq, dk and dv
    checks; one key tile left out of every query tile's dQ sum in pass 2
    (``plant`` 2) must fail dq while dk and dv pass."""
    again = kflash.flash_attention_bwd(*args, window=window)
    equal = {n: torch.equal(g, a)
             for n, g, a in zip(("dq", "dk", "dv"), grads, again)}
    print(f"flash {case}: a second backward call torch.equal "
          f"{json.dumps(equal)}")
    if not all(equal.values()):
        fail(f"flash backward {case}: two calls differ: {equal}")
    del again
    for plant, what, must in (
            (ref.FLASH_PLANT_KEY_TILE, "the middle key tile dropped",
             ("dq", "dk", "dv")),
            (ref.FLASH_PLANT_DQ_TILE, "one key tile left out of each dQ sum",
             ("dq",))):
        bad = kflash._run_bwd(*args, True, window, None, plant=plant)
        berr = {n: grad_error(g, w)
                for n, g, w in zip(("dq", "dk", "dv"), bad, wants)}
        print(f"flash control, {case}, {what} (plant {plant}): "
              f"{json.dumps({n: round(x, 5) for n, x in berr.items()})} "
              f"(must fail {list(must)}, the rest pass)")
        if any(berr[n] <= FLASH_GRAD_LIMIT for n in must) or any(
                berr[n] > FLASH_GRAD_LIMIT for n in berr if n not in must):
            fail(f"flash control '{case}: {what}' reads {berr}")
        del bad


def flash_rows(gen, dev, first, window, gabs, err, directions, iters):
    """The kernel rows of one flash case, timed on ``first`` (q, k, v, dO)
    and cold copies of it, beside the plain versions and
    scaled_dot_product_attention (with the window as a mask; an MQA's
    K and V expanded over the query heads), each over its ``iters``."""
    kernel_iters, plain_iters, library_iters = iters
    dt = torch.bfloat16
    q, k = first[:2]
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    pairs = visible_pairs(s, s, window, dev) * b * hq
    sets = [first] + [flash_inputs(gen, dev, hq, hkv, seq=s, b=b, d=d)
                      for _ in range(copies(sum(2 * t.numel()
                                                for t in first)) - 1)]
    fwd_args = [x[:3] for x in sets]
    outs = [kflash.flash_attention_fwd(*a, window=window) for a in fwd_args]
    bwd_args = [(*a[:3], o, l, a[3]) for a, (o, l) in zip(sets, outs)]
    io = 2 * (q.numel() + k.numel())         # bytes of one q- and k-sized
    shape = (f"B={b} Hq={hq} Hkv={hkv} S={s} D={d} causal"
             f"{f' window={window}' if window else ''} bf16")
    mask = (None if window is None else
            ref.flash_mask(s, s, causal=True, window=window, device=dev))

    def sdpa(q_, k_, v_):
        if hkv != hq:
            k_, v_ = k_.expand(-1, hq, -1, -1), v_.expand(-1, hq, -1, -1)
        return F.scaled_dot_product_attention(q_, k_, v_, attn_mask=mask,
                                              is_causal=mask is None)

    def sdpa_bwd(o_, leaves_, do_):
        return torch.autograd.grad(o_, leaves_, do_, retain_graph=True)

    rows = []
    if "fwd" in directions:
        rows.append(entry(
            "flash_attention", shape, err,
            time_ms(lambda *a: kflash.flash_attention_fwd(
                *a, window=window), fwd_args, kernel_iters),
            time_ms(lambda *a: ref.flash_attention_ref(*a, window=window),
                    fwd_args, plain_iters),
            bound(2 * io + 4 * b * hq * s, 4 * d * pairs, dt),
            time_ms(sdpa, fwd_args, library_iters)))
    if "bwd" in directions:
        lib_sets = []
        for q_, k_, v_, do_ in sets:
            leaves_ = [t.detach().clone().requires_grad_() for t in
                       (q_, k_, v_)]
            lib_sets.append((sdpa(*leaves_), leaves_, do_))
        rows.append(entry(
            "flash_attention_bwd", shape, max(gabs.values()),
            time_ms(lambda *a: kflash.flash_attention_bwd(
                *a, window=window), bwd_args, kernel_iters),
            time_ms(lambda *a: ref.flash_attention_bwd_ref(
                *a, window=window), bwd_args, plain_iters),
            bound(4 * io + 4 * b * hq * s, 10 * d * pairs, dt),
            time_ms(sdpa_bwd, lib_sets, library_iters)))
        if d == 256:  # the scratch as this call allocated it; the shared
            #           memory the library launches each pass with
            kflash.flash_attention_bwd.scratch_bytes = 0
            passes = device_ms_by_kernel(
                lambda *a: kflash.flash_attention_bwd(*a, window=window),
                bwd_args[0])
            lib = kflash._lib()
            rows[-1].update(
                kernel_route="wgmma", passes_ms=passes,
                ptxas=ptxas_entries("flash_attention", "bwd256"),
                scratch_bytes=kflash.flash_attention_bwd.scratch_bytes,
                smem_bytes={"dkv": lib.flash_attention_smem(d, 1),
                            "dq": lib.flash_attention_smem(d, 2)})
            if not rows[-1]["scratch_bytes"]:
                fail(f"flash_attention_bwd {shape}: no dS scratch recorded")
            print(f"flash_attention_bwd {shape}: device ms by pass "
                  f"{json.dumps(rows[-1]['passes_ms'])}; dS scratch "
                  f"{rows[-1]['scratch_bytes']} bytes; shared memory "
                  f"{json.dumps(rows[-1]['smem_bytes'])}; ptxas "
                  f"{json.dumps(rows[-1]['ptxas'])}")
        del lib_sets
    return rows


# ---------------------------------------------------------------------------
# The main path: ServeEngine at full width, both phases through sma_jit
# ---------------------------------------------------------------------------
SERVE_CACHE = CacheConfig(block_size=16, num_blocks=512, max_seq_len=1024)
SERVE_CHUNK, SERVE_NEW = 256, 32
# Host time of a compiled decode tick against the direct step: rounds of
# A B B A, HOST_STEPS steps each; device time over HOST_STEPS steps.
HOST_ROUNDS, HOST_STEPS = 4, 5


def serve_requests(cfg, n: int = 8):
    """The serve run's ``n`` requests (prompts of 64-512 tokens, seed 0)."""
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 513, size=n)
    return lens, [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                                     size=n).astype(np.int32),
                          max_new_tokens=SERVE_NEW)
                  for i, n in enumerate(lens)]


def serve_pass(eng, reqs) -> float:
    """Submit ``reqs`` at once and run the engine until they drain; the
    host wall to the card's last work."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def compile_table(eng) -> list:
    """(phase, row bucket, compile s, graph nodes) of every cached
    signature (the bucket is the tokens leaf's rows, the last leaf)."""
    return sorted((phase, key[1][-1][0][0], entry.compile_time_s,
                   entry.compiled.traced.num_nodes)
                  for phase, e in eng.engines.items()
                  for key, entry in e._cache.items())


def counters() -> dict:
    """The serving engine's failure-path counters."""
    return {k: metrics.get(k) for k in (
        "serve.tick_failures", "serve.evictions", "serve.retries",
        "serve.watchdog_exceeded", "serve.requests_failed")}


def moved_since(before: dict) -> dict:
    return {k: metrics.get(k) - v for k, v in before.items()}


def clean_serving(where: str, before: dict, reqs) -> None:
    """A pass without injected faults: no tick failed, no retry, nothing
    evicted or late, no request failed (``before``: :func:`counters`
    read before it)."""
    moved = moved_since(before)
    failed = [r.rid for r in reqs if r.status == "failed"]
    if any(moved.values()) or failed:
        fail(f"{where}: a pass without faults counted {moved}, failed "
             f"requests {failed}")


def gemms_per_layer(cfg) -> int:
    """``sma_gemm`` launches of an ``attn`` layer a step: q, k, v, the
    out projection, then the MLP's three products or an MoE's router."""
    return 4 + (1 if cfg.moe is not None else 3)


def serve(cfg, params, dev, path: str = "serve", n_requests: int = 8):
    """The serve run through the compiled engine: a warm-up pass of the
    same requests compiles every (phase, bucket) signature, ``reset()``
    keeps them, and the timed pass must compile nothing.  Then the same
    pass once more under ``repro_torch.profile``, whose tick spans must
    count the scheduler's mode switches.  No pass may fail a tick, evict
    or fail a request.  For an MoE model, the same requests once more
    through the direct steps (:func:`served_drop_fraction`).  Returns the
    timed pass's launches and ``sma_gemm`` routes, and the engine."""
    sched = SchedulerConfig(policy="sma", prefill_chunk=SERVE_CHUNK)
    eng = ServeEngine(cfg, params, cache=SERVE_CACHE, max_batch=8,
                      sched=sched, device=dev)
    torch.cuda.reset_peak_memory_stats()
    before = counters()
    warm_reqs = serve_requests(cfg, n_requests)[1]
    warm = serve_pass(eng, warm_reqs)
    clean_serving(f"{path} warm-up pass", before, warm_reqs)
    table = compile_table(eng)
    print(f"{path} warm-up pass (compiles included): {warm:.3f} s; "
          f"compile s and graph nodes per (phase, bucket): " + ", ".join(
              f"{p} {b}: {t:.3f} s {n}" for p, b, t, n in table))
    eng.reset()
    misses = {p: e.stats.misses for p, e in eng.engines.items()}

    lens, reqs = serve_requests(cfg, n_requests)
    before = counters()
    ops.reset_counts()
    wall = serve_pass(eng, reqs)
    counts, routed = ops.launch_counts(), dict(ops.ROUTED)
    routes = dict(kgemm.ROUTES)
    clean_serving(f"{path} timed pass", before, reqs)
    ROUTES_BY_PATH[path] = check_kernel_routes(path, counts, "tile")
    new = {p: e.stats.misses - misses[p] for p, e in eng.engines.items()}
    if any(new.values()):
        fail(f"{path}: the timed pass compiled {new} signatures after the "
             f"warm-up pass")

    for r in reqs:
        if r.status != "done" or len(r.out_tokens) != SERVE_NEW:
            fail(f"request {r.rid}: {r.status} with "
                 f"{len(r.out_tokens or [])} tokens ({r.error})")
        if not all(0 <= t < lm.padded_vocab(cfg) for t in r.out_tokens):
            fail(f"request {r.rid}: token out of range")
    for name in ("sma_gemm", "rmsnorm_gemm", "paged_decode_attention"):
        if counts[name] == 0:
            fail(f"kernel {name} was not launched on the main path")
    ticks = {p: [s for ph, _, s in eng.tick_log if ph == p]
             for p in ("prefill", "decode")}
    n_ticks = len(eng.tick_log)
    per_layer = gemms_per_layer(cfg) * cfg.num_layers
    expect = {"sma_gemm": per_layer * n_ticks, "rmsnorm_gemm": n_ticks,
              "paged_decode_attention": cfg.num_layers * len(ticks["decode"])}
    for name, n in expect.items():
        if counts[name] != n:
            fail(f"{name}: {counts[name]} launches, expected {n}")
    if sum(routed.values()) != cfg.num_layers * len(ticks["prefill"]):
        fail(f"{path}: routed {routed}, expected one chunked-prefill call "
             f"a layer a prefill tick")
    # Decode ticks (M = batch <= 8) on split-K; prefill ticks on wgmma,
    # or split-K where a tick holds 16 tokens or fewer.
    if routes["tile"] or routes["f32"] \
            or routes["splitk"] < per_layer * len(ticks["decode"]):
        fail(f"{path}: sma_gemm routes {routes}, expected wgmma and split-K "
             f"only, split-K on every decode tick")
    ttft = [r.t_first - r.t_submit for r in reqs]
    tokens = sum(len(r.out_tokens) for r in reqs)
    print(f"{path} (compiled): {len(reqs)} requests, prompts "
          f"{lens.tolist()}, {tokens} tokens in {wall:.3f} s: "
          f"{tokens / wall:.1f} tokens/s (wall clock, bf16, {cfg.name} full "
          f"width, random weights)")
    print(f"{path}: TTFT mean {1e3 * np.mean(ttft):.1f} ms, max "
          f"{1e3 * max(ttft):.1f} ms; decode tick mean "
          f"{1e3 * np.mean(ticks['decode']):.2f} ms over "
          f"{len(ticks['decode'])} ticks; prefill tick mean "
          f"{1e3 * np.mean(ticks['prefill']):.2f} ms over "
          f"{len(ticks['prefill'])} ticks; switches {eng.sched.switches}; "
          f"cache {json.dumps(eng.stats()['engines'])}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"{path}: launches {json.dumps(counts)}; per decode tick "
          f"{per_layer} sma_gemm, 1 rmsnorm_gemm, {cfg.num_layers} paged "
          f"decode; routed to plain by design {json.dumps(routed)}; "
          f"sma_gemm routes {json.dumps(routes)}")

    # The same pass under a profile: the tick spans' timeline must count
    # the scheduler's own switches.  The compiled steps run through the
    # span-recording interpreter here, so this pass is not timed.
    eng.reset()
    before = counters()
    prof_reqs = serve_requests(cfg, n_requests)[1]
    with obs.profile(sync=False) as prof:
        serve_pass(eng, prof_reqs)
    clean_serving(f"{path} profiled pass", before, prof_reqs)
    tick_spans = [e for e in prof.events if e["cat"] == "serve"]
    sec = obs.runtime_section(tick_spans)
    whole = prof.runtime_section()
    print(f"{path} runtime_section (profile, sync=False), tick spans: "
          f"{len(tick_spans)} ticks, mode_switches {sec['mode_switches']} "
          f"(scheduler {eng.sched.switches}), per mode ms "
          f"{json.dumps({m: round(us / 1e3, 3) for m, us in sec['per_mode_us'].items()})}"
          f"; whole window: {whole['kernel_spans']} kernel spans, "
          f"{whole['mode_switches']} mode switches inside and between "
          f"ticks, {len(prof.events)} events")
    for line in obs.render_mode_timeline(sec).splitlines():
        print(f"{path} {line}")
    if sec["mode_switches"] != eng.sched.switches \
            or len(tick_spans) != eng.sched.ticks:
        fail(f"{path}: the tick spans count {sec['mode_switches']} mode "
             f"switches over {len(tick_spans)} ticks, the scheduler "
             f"{eng.sched.switches} over {eng.sched.ticks}")
    if any(e["name"] == "engine.compile" for e in prof.events):
        fail(f"{path}: the profiled pass compiled a signature")
    eng.reset()
    if cfg.moe is not None:
        served_drop_fraction(eng, cfg, n_requests,
                             {r.rid: r.out_tokens for r in reqs}, path)
    return counts, routes, eng


def serve_step_inputs(cfg, dev, b: int = 8):
    """A ragged first chunk (``b`` rows, chunk 256) through its own block
    tables, as the serve run's first prefill tick has it."""
    mb = SERVE_CACHE.max_blocks_per_req
    table = torch.arange(b * mb, dtype=torch.int32,
                         device=dev).reshape(b, mb) % SERVE_CACHE.num_blocks
    gen = torch.Generator(device=dev).manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (b, SERVE_CHUNK), generator=gen,
                         device=dev, dtype=torch.int32)
    n_tok = torch.tensor([256, 1, 17, 100, 256, 200, 8, 150][:b],
                         dtype=torch.int32, device=dev)
    return table, toks, n_tok


def lost_write(compiled, layer: int, layers: int):
    """A copy of a compiled decode step with ``layer``'s two pool writes
    (K and V) removed from its graph."""
    faulty = copy.copy(compiled)
    faulty.module = copy.deepcopy(compiled.module)
    puts = [n for n in faulty.module.graph.nodes
            if n.target is torch.ops.aten.index_put_.default]
    if len(puts) != 2 * layers:
        fail(f"compiled decode step: {len(puts)} pool writes, expected "
             f"{2 * layers}")
    for n in puts[2 * layer:2 * layer + 2]:
        n.replace_all_uses_with(n.args[0])
        faulty.module.graph.erase_node(n)
    faulty.module.recompile()
    return faulty


def step_batch(cfg, params, toks):
    """A paged step's batch from token ids: the ids, or their
    ``token_embeds`` for an ``embeds``-mode model (as the engine feeds
    it)."""
    if cfg.input_mode == "embeds":
        return {"embeds": smodel.token_embeds(params, cfg, toks)}
    return {"tokens": toks}


def check_compiled_serving(cfg, params, dev, eng, plant: bool = True,
                           timing: bool = True, rows: int = 8):
    """The engine's compiled prefill tick (bucket ``rows``, chunk 256) and
    two decode ticks against the direct steps on the same inputs: logits, the
    returned lengths and every pool's real blocks ``torch.equal``, each
    tick's launches, routes and routed calls equal.  The direct and the
    compiled ticks each run once more on the same inputs and must
    ``torch.equal`` their first runs (no step sums in an unfixed order;
    an MoE's top-k and combine included).  Then (``plant``) the
    same with the first decode tick's graph missing layer 0's pool
    writes: the next tick's logits must not be equal.  Then (``timing``)
    the host time of a compiled decode tick against the direct step (A B
    B A) and the device time of each (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile
    table, toks, n_tok = serve_step_inputs(cfg, dev, rows)
    zero = torch.zeros(rows, dtype=torch.int32, device=dev)
    nb = SERVE_CACHE.num_blocks
    direct = (lambda p, s, bt, cl, nt, b: smodel.paged_prefill_step(
                  p, s, bt, cl, nt, cfg, b),
              lambda p, s, bt, cl, b: smodel.paged_decode_step(
                  p, s, bt, cl, cfg, b))
    compiled = (eng.engines["prefill"], eng.engines["decode"])

    def run(prefill, decode, first=None, feed=None):
        """Prefill, two decode ticks (the first through ``first`` when
        given); each tick's (logits, lengths, launches, routes, routed),
        the tokens fed, and the pools."""
        state = smodel.init_state(cfg, rows, SERVE_CACHE, device=dev)
        out, fed = [], []
        (logits, _, cl), *seen = counted_run(lambda: prefill(
            params, state, table, zero, n_tok, step_batch(cfg, params,
                                                          toks)))
        out.append((logits, cl, seen))
        for i, step in enumerate((first or decode, decode)):
            nxt = feed[i] if feed else \
                logits.argmax(-1, keepdim=True).to(torch.int32)
            fed.append(nxt)
            (logits, _, cl), *seen = counted_run(lambda: step(
                params, state, table, cl.to(torch.int32),
                step_batch(cfg, params, nxt)))
            out.append((logits, cl, seen))
        return out, fed, [p[:, :nb] for e in state for p in e.values()]

    misses = [e.stats.misses for e in compiled]
    want, fed, want_pools = run(*direct)
    got, _, got_pools = run(*compiled, feed=fed)
    if [e.stats.misses for e in compiled] != misses:
        fail("compiled serving check: the serve run's signatures missed")
    for i, ((gl, gc, gseen), (wl, wc, wseen)) in enumerate(zip(got, want)):
        what = "prefill tick" if i == 0 else f"decode tick {i}"
        if not torch.isfinite(gl.float()).all():
            fail(f"compiled {what}: non-finite logits")
        if not (torch.equal(gl, wl) and torch.equal(gc, wc)):
            fail(f"compiled {what}: logits or lengths differ from the "
                 f"direct step's (max |err| "
                 f"{(gl.float() - wl.float()).abs().max().item():.4g})")
        if gseen != wseen:
            fail(f"compiled {what}: launches, routes, routed {gseen}, "
                 f"direct {wseen}")
    if not all(torch.equal(g, w) for g, w in zip(got_pools, want_pools)):
        fail("compiled ticks: the pools differ from the direct steps'")
    print(f"{cfg.name}: compiled ticks vs direct steps (prefill bucket "
          f"{rows} x chunk 256, two decode ticks): logits, lengths and "
          f"{len(got_pools)} pools torch.equal; launches, routes, routed "
          f"equal: {json.dumps([s[0] for _, _, s in got])}")
    for steps, first, first_pools in ((direct, want, want_pools),
                                      (compiled, got, got_pools)):
        again, _, again_pools = run(*steps, feed=fed)
        for i, (a, f) in enumerate(zip(again, first)):
            if not (torch.equal(a[0], f[0]) and torch.equal(a[1], f[1])):
                err = (a[0].float() - f[0].float()).abs().max().item()
                fail(f"{cfg.name}: tick {i} run twice gives other logits "
                     f"(max |err| {err:.4g})")
        if not all(torch.equal(a, f)
                   for a, f in zip(again_pools, first_pools)):
            fail(f"{cfg.name}: the ticks run twice write other pools")
        del again_pools
    print(f"{cfg.name}: the direct and the compiled ticks each run twice: "
          f"logits, lengths and pools torch.equal")
    del got_pools, want_pools
    if not plant:
        return None

    (decode_sig,) = [entry.compiled for key, entry in
                     eng.engines["decode"]._cache.items()
                     if key[1][-1][0][0] == 8]
    bad, _, _ = run(*compiled, feed=fed,
                    first=lost_write(decode_sig, 0, cfg.num_layers))
    err = [(b[0].float() - w[0].float()).abs().max().item()
           for b, w in zip(bad, want)]
    print(f"planted fault, layer 0's pool writes removed from the first "
          f"compiled decode tick: max |err| of the logits against the "
          f"direct steps, prefill / tick 1 / tick 2: "
          f"{', '.join(f'{e:.4g}' for e in err)}")
    if err[2] == 0.0:
        fail("planted lost write: the next tick's logits equal the direct "
             "step's")
    torch.cuda.empty_cache()
    if not timing:
        return None

    state = smodel.init_state(cfg, rows, SERVE_CACHE, device=dev)
    logits, _, cl = direct[0](params, state, table, zero, n_tok,
                              {"tokens": toks})
    cl = cl.to(torch.int32)
    nxt = logits.argmax(-1, keepdim=True).to(torch.int32)
    steps = {"direct": lambda: direct[1](params, state, table, cl,
                                         {"tokens": nxt}),
             "compiled": lambda: compiled[1](params, state, table, cl,
                                             {"tokens": nxt})}
    walls = {k: [] for k in steps}
    for k in steps:
        steps[k]()
    for _ in range(HOST_ROUNDS):
        for k in ("direct", "compiled", "compiled", "direct"):
            walls[k].append(host_ms(
                lambda: [steps[k]() for _ in range(HOST_STEPS)])
                / HOST_STEPS)
    med = {k: float(np.median(w)) for k, w in walls.items()}
    print(f"{cfg.name}: decode tick host time to return (8 rows, median of "
          f"{len(walls['direct'])} rounds of {HOST_STEPS} steps, A B B A): "
          f"direct {med['direct']:.3f} ms, compiled {med['compiled']:.3f} "
          f"ms ({100 * (med['compiled'] / med['direct'] - 1):+.1f} %); "
          f"rounds {json.dumps({k: [round(x, 3) for x in w] for k, w in walls.items()})}")
    busy = {}
    for k in ("direct", "compiled"):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(HOST_STEPS):
                steps[k]()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy[k] = report_profile(prof, wall, HOST_STEPS,
                                 f"{k} decode tick")
        if cfg.moe is not None:
            profile_groups(prof, HOST_STEPS, f"{k} decode tick")
    print(f"{cfg.name}: decode tick device time (busy / step): " + ", ".join(
        f"{k} {'not measured' if b is None else f'{1e3 * b / HOST_STEPS:.3f} ms'}"
        for k, b in busy.items()))
    return med, busy


@contextlib.contextmanager
def plain_kernels():
    """Swap every kernel wrapper for its plain version, where the entry
    points and the autograd Functions look them up, to run the same step
    (forward and backward) without the kernels."""
    swaps = {(kgemm, "sma_gemm"): ref.gemm_ref,
             (knorm, "rmsnorm_gemm"): ref.rmsnorm_gemm_ref,
             (kdecode, "paged_decode_attention"):
                 ref.paged_decode_attention_ref,
             (kdecode, "decode_attention"): ref.decode_attention_ref,
             (krglru, "rglru_scan"): ref.rglru_scan_ref,
             (krglru, "rglru_scan_bwd"): ref.rglru_scan_bwd_ref,
             (kmlstm, "mlstm_chunkwise"): ref.mlstm_chunkwise_ref,
             (kflash, "flash_attention_fwd"): ref.flash_attention_ref,
             (kflash, "flash_attention_bwd"): ref.flash_attention_bwd_ref}
    saved = {key: getattr(*key) for key in swaps}
    for (mod, name), fn in swaps.items():
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def prefilled(cfg, params, dev):
    """Pools after a ragged 64-token prefill of 8 rows, and the next
    decode step's inputs (table, cache_len, tokens)."""
    cache = CacheConfig(block_size=16, num_blocks=512, max_seq_len=1024)
    b, c = 8, 64
    state = smodel.init_state(cfg, b, cache, device=dev)
    mb = cache.max_blocks_per_req
    table = torch.arange(b * mb, dtype=torch.int32,
                         device=dev).reshape(b, mb) % cache.num_blocks
    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (b, c), generator=gen,
                         device=dev)
    n_tok = torch.tensor([64, 1, 17, 33, 64, 50, 8, 40], device=dev)
    zero = torch.zeros(b, dtype=torch.int32, device=dev)
    _, state, cl = smodel.paged_prefill_step(params, state, table, zero,
                                             n_tok, cfg,
                                             step_batch(cfg, params, toks))
    nxt = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen, device=dev)
    return state, table, cl, nxt


@contextlib.contextmanager
def planted(fault: str, layer: int, per_layer: int):
    """One wrong launch in ``layer`` of a decode step or a forward, made by
    feeding a kernel wrong inputs: the attention out projection with its
    last 64-wide K tile skipped, the paged attention with the newest key
    dropped, or (GQA) every query head attending to KV head 0 (the paged
    or the flash attention).  ``per_layer`` is the layer's ``sma_gemm``
    launches (:func:`gemms_per_layer`).  An MoE's "router K tile dropped"
    skips the router's last 64-wide K tile on every call, in every
    layer."""
    gemm, attn, flash = (ops.sma_gemm, ops.paged_decode_attention,
                         ops.flash_attention)
    calls = {"gemm": 0, "attn": 0, "flash": 0}

    def wrong_gemm(a, w, **kw):
        calls["gemm"] += 1
        if (fault == "wo K tile skipped"
                and calls["gemm"] == per_layer * layer + 4) or (
                fault == "router K tile dropped"
                and calls["gemm"] % per_layer == 0):
            k = w.shape[0] - 64
            return gemm(a[..., :k].contiguous(), w[:k], **kw)
        return gemm(a, w, **kw)

    def wrong_attn(q, k_pool, v_pool, table, q_pos, kv_len, **kw):
        calls["attn"] += 1
        if fault == "newest key dropped" and calls["attn"] == layer + 1:
            kv_len = (kv_len - 1).clamp(min=0)
        if fault == "every query head on KV head 0" \
                and calls["attn"] == layer + 1:
            k_pool, v_pool = (p[:, :1].expand_as(p).contiguous()
                              for p in (k_pool, v_pool))
        return attn(q, k_pool, v_pool, table, q_pos, kv_len, **kw)

    def wrong_flash(q, k, v, **kw):
        calls["flash"] += 1
        if fault == "every query head on KV head 0" \
                and calls["flash"] == layer + 1:
            k, v = (t[:, :1].expand_as(t).contiguous() for t in (k, v))
        return flash(q, k, v, **kw)

    ops.sma_gemm, ops.paged_decode_attention, ops.flash_attention = (
        wrong_gemm, wrong_attn, wrong_flash)
    try:
        yield
    finally:
        ops.sma_gemm, ops.paged_decode_attention, ops.flash_attention = (
            gemm, attn, flash)


DECODE_FAULTS = ("wo K tile skipped", "newest key dropped")
# Faults that :func:`planted` puts in every layer at once.
EVERY_LAYER_FAULTS = ("router K tile dropped",)


def check_decode_logits(cfg, params, dev, faults_=DECODE_FAULTS):
    """One decode step after a ragged prefill, through the kernels and
    through the plain versions, on the same pools; then the same step with
    one planted fault (each of ``faults_``) in one layer, which the limit
    must catch (:func:`hold_logits`)."""
    state, table, cl, nxt = prefilled(cfg, params, dev)
    saved = [{k: v.clone() for k, v in e.items()} for e in state]
    batch = step_batch(cfg, params, nxt)

    def step():
        for e, s in zip(state, saved):
            for k in e:
                e[k].copy_(s[k])
        return smodel.paged_decode_step(params, state, table, cl, cfg,
                                        batch)[0].float()

    hold_logits(cfg, "decode logits", step, (nxt.shape[0], cfg.vocab_size),
                faults_)


def hold_logits(cfg, what: str, step, shape, faults_, plain_step=None):
    """``step()`` (logits, float) through the kernels against the same
    call through the plain versions (``plain_step()`` there, when given):
    max |err| within LOGIT_ATOL, every
    top-1 disagreement between two logits within LOGIT_ATOL of each other
    in the plain ones; then ``step()`` with each planted fault of
    ``faults_`` in the first, a middle and the last layer (once, for a
    fault of EVERY_LAYER_FAULTS), each of which must read above
    LOGIT_ATOL.  Prints the margins: the limit over the error, and the
    weakest fault's reading over the limit."""
    limit = LOGIT_ATOL
    got = step()
    with plain_kernels():
        want = (plain_step or step)()
    if not torch.isfinite(got).all() or got.shape != shape:
        fail(f"{cfg.name} {what}: shape {tuple(got.shape)} or non-finite")

    def reading(x):
        d = x - want
        return d.abs().max().item(), (d.norm() / want.norm()).item()

    err, rel = reading(got)
    rows_k = got.reshape(-1, shape[-1])
    rows_p = want.reshape(-1, shape[-1])
    top_k, top_p = rows_k.argmax(-1), rows_p.argmax(-1)
    print(f"{what}, kernels vs plain versions: max |err| {err:.4g}, "
          f"relative RMS {rel:.4g} (|logit| max "
          f"{want.abs().max().item():.3g}), top-1 agree on "
          f"{int((top_k == top_p).sum())}/{rows_p.shape[0]} rows")
    controls = []
    for fault in faults_:
        every = fault in EVERY_LAYER_FAULTS
        for layer in ((0,) if every else
                      (0, cfg.num_layers // 2, cfg.num_layers - 1)):
            with planted(fault, layer, gemms_per_layer(cfg)):
                c_err, c_rel = reading(step())
            controls.append(c_err)
            print(f"{what} control, {fault} in "
                  f"{'every layer' if every else f'layer {layer}'}: "
                  f"max |err| {c_err:.4g}, relative RMS {c_rel:.4g}")
    for i, r in enumerate((top_k != top_p).nonzero()[:, 0].tolist()):
        gap = (rows_p[r, top_p[r]] - rows_p[r, top_k[r]]).item()
        if i < 8:
            print(f"{what} row {r}: top-1 {top_k[r].item()} vs "
                  f"{top_p[r].item()}, {gap:.4g} apart in the plain logits")
        if gap > limit:
            fail(f"{cfg.name} {what} row {r}: top-1 {top_k[r].item()} vs "
                 f"{top_p[r].item()}, {gap:.4g} apart in the plain logits")
    if err > limit:
        fail(f"{cfg.name} {what}: max |err| {err:.4g} > {limit}")
    print(f"{cfg.name}: {what} margins: limit {limit} against the error "
          f"{err:.4g}" + (f" ({limit / err:.2f}x)" if err else "")
          + f"; the weakest planted fault reads "
          f"{min(controls) / limit:.2f}x the limit")
    if min(controls) <= limit:
        fail(f"{cfg.name} {what}: a planted fault reads "
             f"{min(controls):.4g}, within the limit {limit}")


def profile_decode(cfg, params, dev, steps: int = 5):
    """torch.profiler over a few decode steps (batch 8, kv_len up to 65):
    device busy share of the window and device time by kernel.  The window
    is host time under the profiler, which slows the host side."""
    from torch.profiler import ProfilerActivity, profile
    state, table, cl, nxt = prefilled(cfg, params, dev)
    tokens = {"tokens": nxt}
    smodel.paged_decode_step(params, state, table, cl, cfg, tokens)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            smodel.paged_decode_step(params, state, table, cl, cfg, tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report_profile(prof, wall, steps, "decode step")


@contextlib.contextmanager
def gemm_entries(how: str):
    """The GEMM entry points calling the kernel wrappers directly
    (``"wrapper"``, what ``ops`` does with grad mode off) or through their
    autograd Functions whatever the grad mode (``"Function.apply"``)."""
    saved = ops.sma_gemm, ops.rmsnorm_gemm
    if how == "wrapper":
        ops.sma_gemm, ops.rmsnorm_gemm = kgemm.sma_gemm, knorm.rmsnorm_gemm
    else:
        def sma_gemm(a, b, *, bias=None, epilogue="none"):
            return kautograd.SmaGemm.apply(a, b, bias, epilogue)

        def rmsnorm_gemm(x, scale, w, *, epilogue="none", eps=1e-6):
            return kautograd.RmsnormGemm.apply(x, scale, w, epilogue, eps)
        ops.sma_gemm, ops.rmsnorm_gemm = sma_gemm, rmsnorm_gemm
    try:
        yield
    finally:
        ops.sma_gemm, ops.rmsnorm_gemm = saved


def entry_overhead(cfg, params, dev, rounds: int = 4, steps: int = 5):
    """Host wall of one decode step (batch 8, synchronized at its end, under
    the caller's inference_mode) with the 169 GEMM entry calls a step going
    through their autograd Functions against calling the wrappers
    directly; the two alternate (A B B A) ``rounds`` times, ``steps`` steps
    each.  Medians in ms."""
    state, table, cl, nxt = prefilled(cfg, params, dev)
    tokens = {"tokens": nxt}
    walls = {"Function.apply": [], "wrapper": []}

    def run(how, keep=True):
        with gemm_entries(how):
            for _ in range(steps):
                t = time.perf_counter()
                smodel.paged_decode_step(params, state, table, cl, cfg,
                                         tokens)
                torch.cuda.synchronize()
                if keep:
                    walls[how].append(time.perf_counter() - t)

    run("Function.apply", keep=False)
    run("wrapper", keep=False)
    for _ in range(rounds):
        for how in ("Function.apply", "wrapper", "wrapper", "Function.apply"):
            run(how)
    med = {how: 1e3 * float(np.median(w)) for how, w in walls.items()}
    extra = med["Function.apply"] - med["wrapper"]
    print(f"decode step host wall, median of {len(walls['wrapper'])}: GEMM "
          f"entries through Function.apply {med['Function.apply']:.3f} ms, "
          f"wrappers called directly {med['wrapper']:.3f} ms; difference "
          f"{extra:.3f} ms ({100 * extra / med['wrapper']:.2f} %, "
          f"{1e3 * extra / (7 * cfg.num_layers + 1):.2f} us a call)")
    return med


# ---------------------------------------------------------------------------
# Mistral-NeMo-12B: the dense configs' full-width path, resilience, the
# slot Server, and the input modes (musicgen-large, internvl2-2b)
# ---------------------------------------------------------------------------
NEMO_ARCH = "mistral-nemo-12b"
MUSICGEN_ARCH, INTERNVL_ARCH = "musicgen-large", "internvl2-2b"
# Nemo's serve runs at full width and half its 40 layers, so that the
# training phases fit the script's time limit (launch.serve's main() still
# serves Nemo at full depth).
NEMO_SERVE_LAYERS = 20
# Nemo's products (q 5120 -> 4096, k / v -> 1024, the attention out 4096 ->
# 5120, the MLP's silu gate 5120 -> 14336 and its 14336 -> 5120) at a
# decode tick (M 8) and a prefill tick (M 2048).
NEMO_GEMMS = [(m, k, n, ep) for m in (8, 2048)
              for k, n, ep in ((5120, 4096, "none"), (5120, 1024, "none"),
                               (4096, 5120, "none"), (5120, 14336, "silu"),
                               (14336, 5120, "none"))]
NEMO_LOGIT_LAYERS = 3
NEMO_FAULTS = DECODE_FAULTS + ("every query head on KV head 0",)
# The watchdog case: one tick delayed past the deadline.
CHAOS_LATENCY_S, CHAOS_DEADLINE_S = 1.0, 0.5
# The slot Server's requests: each prompt fits its one prefill chunk
# (SchedulerConfig's default, 32), so admission prefills it whole.
SHIM_LENS, SHIM_NEW = (5, 17, 32, 9), 16
INTERNVL_BATCH, INTERNVL_TOKENS = 2, 256
# musicgen-large's and internvl2-2b's products that SERVE_GEMMS lacks, at
# musicgen's decode tick (M 4: its 4 rows; q, k, v, o 2048 -> 2048, MHA 32
# x 64) and both prefill shapes (M 1024: musicgen's 4 rows x chunk 256,
# internvl's B 2 x 512): internvl's k and v 2048 -> 1024 (GQA 16/8 of 128),
# the MLPs' 2048 -> 8192 (the up product and the silu gate) and 8192 ->
# 2048.  internvl's q and o at M 1024 are SERVE_GEMMS' 2048 -> 2048.
INPUT_MODE_GEMMS = [(4, 2048, 2048, "none"), (4, 2048, 8192, "none"),
                    (4, 2048, 8192, "silu"), (4, 8192, 2048, "none"),
                    (1024, 2048, 1024, "none"), (1024, 2048, 8192, "none"),
                    (1024, 2048, 8192, "silu"), (1024, 8192, 2048, "none")]
# The input modes' logits against the plain versions at 3 full-width
# layers: musicgen's decode step (check_decode_logits, LOGIT_ATOL) and
# internvl's forward over 2 x 512 positions, whose faults are the out
# projection's skipped K tile and (GQA) every query head on KV head 0 in
# the flash attention.
INPUT_MODE_LOGIT_LAYERS = 3
FORWARD_FAULTS = ("wo K tile skipped", "every query head on KV head 0")


def check_nemo_kernels(gen, dev):
    """The kernels at Mistral-NeMo-12B's shapes against their plain
    versions, timed with their bounds: ``sma_gemm`` at NEMO_GEMMS, the
    decode head ``rmsnorm_gemm`` 5120 -> 131072 at M 8 (route ``tile``;
    ``torch.matmul`` of the pre-normalized x beside it), and paged decode
    at GQA 32/8, head_dim 128 (:func:`check_paged_gqa`)."""
    cfg = get_config(NEMO_ARCH)
    rows = check_sma_gemm(gen, dev, NEMO_GEMMS, " (nemo)")
    rows.append(check_head(gen, dev, 8, cfg.d_model, lm.padded_vocab(cfg),
                           "tile", "nemo decode head"))
    rows.append(check_paged_gqa(gen, dev, cfg, "nemo"))
    return rows


def check_paged_gqa(gen, dev, cfg, tag: str):
    """Paged decode at ``cfg``'s heads (B 8 of KV_LENS, block 16, 512
    blocks) against its plain version with the planted faults of
    :func:`attn_controls`, timed with its bound; its row."""
    dt = torch.bfloat16
    b, bs, nb, smax = len(KV_LENS), 16, 512, 1024
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    lens = torch.tensor(KV_LENS, dtype=torch.int32, device=dev)
    table = paged_table(dev, nb, bs, smax)
    q = torch.randn((b, hq, d), generator=gen, device=dev).to(dt)
    pools = [tuple(torch.randn((nb, hkv, bs, d), generator=gen,
                               device=dev).to(dt) for _ in range(2))
             for _ in range(2)]
    got = kdecode.paged_decode_attention(q, *pools[0], table, lens)
    want = ref.paged_decode_attention_ref(q, *pools[0], table, lens)
    err = compare(got, want, f"paged_decode_attention ({tag} GQA)",
                  ATTN_ATOL, ATTN_RTOL)
    attn_controls(q, *pools[0], table, lens, want, bs)
    total = sum(KV_LENS)
    args = [(q, kp, vp, table, lens) for kp, vp in pools]
    row = entry(
        "paged_decode_attention",
        f"B={b} Hq={hq} Hkv={hkv} D={d} BS={bs} NB={nb} "
        f"kv_len={list(KV_LENS)} bf16 ({tag})", err,
        time_ms(kdecode.paged_decode_attention, args),
        time_ms(ref.paged_decode_attention_ref, args),
        bound(2 * 2 * b * hq * d + 2 * 2 * total * hkv * d
              + 4 * (b * smax // bs + b), 4 * total * hq * d, dt), None)
    row["paced_ms"] = time_ms(kdecode.paged_decode_attention, args,
                              paced=True)
    return row


def check_head(gen, dev, m: int, k: int, n: int, want_route: str,
               tag: str):
    """``rmsnorm_gemm`` at one head's shape (M ``m``, ``k`` -> ``n``)
    against its plain version, on ``want_route``, timed with its bound and
    ``torch.matmul`` of the pre-normalized x beside it (the GEMM alone);
    its row."""
    dt = torch.bfloat16
    ws = [(torch.randn((k, n), generator=gen, device=dev)
           * k ** -0.5).to(dt) for _ in range(copies(k * n * 2))]
    scale = torch.rand((k,), generator=gen, device=dev) + 0.5
    x = (torch.randn((m, k), generator=gen, device=dev) * 3).to(dt)
    before = dict(knorm.ROUTES)
    got = knorm.rmsnorm_gemm(x, scale, ws[0])
    route = kernel_route(knorm.ROUTES, before, f"rmsnorm_gemm ({tag})")
    if route != want_route:
        fail(f"rmsnorm_gemm M={m} {k}->{n} ({tag}) took the {route} route")
    err = compare(got, ref.rmsnorm_gemm_ref(x, scale, ws[0]),
                  f"rmsnorm_gemm M={m} {k}->{n} ({tag})")
    args = [(x, scale, w) for w in ws]
    iters = 20 if m <= 16 else 5
    row = entry("rmsnorm_gemm", f"M={m} K={k} N={n} none bf16 ({tag})", err,
                time_ms(knorm.rmsnorm_gemm, args, iters),
                time_ms(ref.rmsnorm_gemm_ref, args, 5),
                bound(2 * (m * k + k * n + m * n) + 4 * k, 2 * m * n * k, dt),
                None)
    normed = (x.float() * ref.rms_inverse(x).reshape(m)[:, None]
              * scale.float()).to(dt)
    row.update(kernel_route=route,
               paced_ms=time_ms(knorm.rmsnorm_gemm, args, iters, paced=True),
               matmul_ms=time_ms(torch.matmul, [(normed, w) for w in ws],
                                 iters))
    return row


def check_input_mode_kernels(gen, dev):
    """The kernels at musicgen-large's and internvl2-2b's shapes against
    their plain versions, timed with their bounds: ``sma_gemm`` at
    INPUT_MODE_GEMMS, the heads (musicgen 2048 -> 2048 at M 4 on ``tile``,
    internvl 2048 -> 92672 at M 1024 on ``wgmma``) and internvl's flash
    forward (:func:`check_flash_internvl`).  musicgen's paged decode (MHA
    32 x 64) is the shape ``check_decode`` holds."""
    mg, iv = get_config(MUSICGEN_ARCH), get_config(INTERNVL_ARCH)
    rows = check_sma_gemm(gen, dev, INPUT_MODE_GEMMS, " (musicgen, internvl)")
    rows.append(check_head(gen, dev, 4, mg.d_model, lm.padded_vocab(mg),
                           "tile", "musicgen head"))
    rows.append(check_head(gen, dev, INTERNVL_BATCH * (
        iv.num_vision_tokens + INTERNVL_TOKENS), iv.d_model,
        lm.padded_vocab(iv), "wgmma", "internvl head"))
    rows.append(check_flash_internvl(gen, dev, iv))
    return rows


def check_flash_internvl(gen, dev, cfg):
    """The flash forward at internvl2-2b's prefill shape (B 2, GQA 16/8, S
    512 = 256 vision + 256 tokens, head_dim 128, causal) against its plain
    version, on the ``wgmma`` route, with the flash checks' limits; timed
    beside ``scaled_dot_product_attention`` on the same inputs."""
    dt = torch.bfloat16
    b, hq, hkv = INTERNVL_BATCH, cfg.num_heads, cfg.num_kv_heads
    s, d = cfg.num_vision_tokens + INTERNVL_TOKENS, cfg.resolved_head_dim
    sets = [flash_inputs(gen, dev, hq, hkv, seq=s, b=b, d=d)[:3]
            for _ in range(copies(2 * b * (hq + 2 * hkv) * s * d))]
    before = dict(kflash.FWD_ROUTES)
    out, lse = kflash.flash_attention_fwd(*sets[0])
    route = kernel_route(kflash.FWD_ROUTES, before, "flash (internvl)")
    if route != "wgmma":
        fail(f"flash (internvl) took the {route} route")
    want, want_lse = ref.flash_attention_ref(*sets[0])
    mult = row_multiples(out, want)
    err = (out.float() - want.float()).abs().max().item()
    lse_err = (lse - want_lse).abs().max().item()
    print(f"flash internvl B {b} GQA {hq}/{hkv} S {s} D {d}: out max |err| "
          f"{err:.4g} (max limit multiple {mult.max().item():.3g} of "
          f"{FLASH_ATOL} + {FLASH_RTOL}|plain|), lse {lse_err:.3g}")
    if not torch.isfinite(out.float()).all() or mult.max() > 1:
        fail("flash forward (internvl): kernel disagrees with its plain "
             "version")
    if lse_err > 1e-2:
        fail(f"flash forward (internvl): lse off by {lse_err:.3g}")
    pairs = visible_pairs(s, s, None, dev) * b * hq
    nbytes = 2 * (2 * b * hq * s * d + 2 * b * hkv * s * d) + 4 * b * hq * s

    def sdpa(q_, k_, v_):
        return F.scaled_dot_product_attention(q_, k_, v_, is_causal=True,
                                              enable_gqa=True)

    row = entry("flash_attention",
                f"B={b} Hq={hq} Hkv={hkv} S={s} D={d} causal bf16 (internvl)",
                err, time_ms(lambda *a: kflash.flash_attention_fwd(*a), sets),
                time_ms(ref.flash_attention_ref, sets, 3),
                bound(nbytes, 4 * d * pairs, dt), time_ms(sdpa, sets))
    row["kernel_route"] = route
    return row


def check_forward_logits(cfg, params, dev):
    """internvl2-2b's ``lm.forward`` (256 vision embeddings ahead of 256
    tokens, B 2) through the kernels against the plain versions, with
    planted faults (:func:`hold_logits`)."""
    batch = internvl_batch(cfg, dev)
    s = cfg.num_vision_tokens + INTERNVL_TOKENS

    def step():
        return lm.forward(params, cfg, batch)[..., :cfg.vocab_size].float()

    hold_logits(cfg, "forward logits", step,
                (INTERNVL_BATCH, s, cfg.vocab_size), FORWARD_FAULTS)


def internvl_batch(cfg, dev) -> dict:
    """B 2 of 256 random vision embeddings and 256 tokens (seed 3)."""
    gen = torch.Generator(device=dev).manual_seed(3)
    return {"tokens": torch.randint(0, cfg.vocab_size,
                                    (INTERNVL_BATCH, INTERNVL_TOKENS),
                                    generator=gen, device=dev),
            "vision_embeds": torch.randn(
                (INTERNVL_BATCH, cfg.num_vision_tokens, cfg.d_model),
                generator=gen, device=dev).to(cfg.activation_dtype)}


def init_full_width(cfg, dev):
    """``lm.init`` of ``cfg`` (random weights from seed 0) on the card, with
    its shape, time, the memory it took and its peak printed."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"init: {cfg.name} full width ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
          f"{cfg.resolved_head_dim}, vocab {lm.padded_vocab(cfg)}, "
          f"{cfg.param_count() / 1e9:.3f} B parameters, input "
          f"{cfg.input_mode}) in {time.perf_counter() - t0:.3f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card, "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return params


def chaos_pass(eng, reqs, on_tick=None) -> dict:
    """Submit ``reqs`` at once and step the engine until they drain, with
    ``on_tick(ticks)`` after each step; each request's tokens."""
    for r in reqs:
        eng.submit(r)
    ticks = 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        while eng.queue or eng.active:
            eng.step()
            ticks += 1
            if on_tick is not None:
                on_tick(ticks)
            if ticks > 2000:
                fail("chaos pass: the engine did not drain")
    torch.cuda.synchronize()
    return {r.rid: list(r.out_tokens or []) for r in reqs}


def serve_chaos(cfg, params, dev, eng):
    """The chaos cases on the compiled Nemo engine (greedy, the serve run's
    8 requests), each against the unfaulted pass's tokens:
    (a) ``serve.tick:runtime_error:times=1``: one tick failure, every
        request done, the same tokens;
    (b) one request's pool blocks set to NaN after its first decode tick:
        evicted with ``retries == max_retries + 1``, the others' tokens
        unchanged, the pools scrubbed;
    (c) ``sma_gemm@cuda:runtime_error:times=1,after=N``, N inside the
        second decode tick after layer 0 wrote the pools in place: one
        tick failure, the whole tick retried, the same tokens;
    (d) ``serve.tick:latency`` past ``RetryPolicy.deadline_s``: the
        watchdog counts it;
    (e) ``check_numerics="raise"`` with ``sma_gemm@cuda:nan:times=1``: the
        tick raises ``FloatingPointError`` (not a runtime-class failure);
    (f) ``engine.compile:compile_error:times=1`` on a fresh signature (the
        decode step at 2 rows): the compile raises ``InjectedFault`` and
        caches nothing, the next call compiles and equals the direct step.
    Prints the report's ``resilience`` section."""
    RetryPolicy = guard.RetryPolicy
    guard.reset()
    eng.reset()
    seen = []
    with faults.inject_faults("sma_gemm:runtime_error:times=0") as (count,):
        want = chaos_pass(eng, serve_requests(cfg)[1],
                          on_tick=lambda t: seen.append(count._seen))
    decode_ticks = [i for i, (p, _, _) in enumerate(eng.tick_log)
                    if p == "decode"]
    print(f"serve chaos: unfaulted pass {len(eng.tick_log)} ticks, "
          f"{count._seen} sma_gemm entry calls, tokens "
          f"{[len(t) for t in want.values()]}")

    def run(case, spec, retry=RetryPolicy(), on_tick=None):
        eng.reset()
        eng.retry = retry
        reqs = serve_requests(cfg)[1]
        before = counters()
        with faults.inject_faults(spec) as specs:
            got = chaos_pass(eng, reqs, on_tick and (
                lambda t: on_tick(t, reqs)))
        moved = moved_since(before)
        fired = sum(s._fired for s in specs)
        same = [r.rid for r in reqs if got[r.rid] == want[r.rid]]
        print(f"serve chaos ({case}) {spec}: fired {fired}; "
              f"{json.dumps(moved)}; statuses "
              f"{[r.status for r in reqs]}; tokens equal the unfaulted "
              f"pass's for requests {same}")
        return reqs, got, moved, fired

    reqs, got, moved, fired = run("a", "serve.tick:runtime_error:times=1")
    if fired != 1 or moved["serve.tick_failures"] != 1 \
            or any(r.status != "done" for r in reqs) or got != want:
        fail("serve chaos (a): a serve.tick fault was not retried into the "
             "unfaulted tokens")

    victim, hit = 3, []

    def poison(tick, reqs):
        r = reqs[victim]
        if not hit and r.status == "active" and len(r.out_tokens) == 2:
            hit.append(tick)
            blocks = eng.kv.blocks_of(r.slot)
            for e in eng.state:
                for pool in e.values():
                    pool[:, blocks] = float("nan")

    reqs, got, moved, _ = run("b", "", RetryPolicy(max_retries=1), poison)
    v = reqs[victim]
    print(f"serve chaos (b): request {victim} poisoned after tick {hit}: "
          f"{v.status}, retries {v.retries}, error {v.error!r}")
    if not hit or v.status != "failed" or v.retries != 2 \
            or moved["serve.evictions"] != 1:
        fail("serve chaos (b): the poisoned request was not evicted after "
             "its retries")
    if any(r.status != "done" or got[r.rid] != want[r.rid]
           for r in reqs if r is not v):
        fail("serve chaos (b): a neighbour of the poisoned request changed")
    if any(torch.isnan(p).any().item() for e in eng.state
           for p in e.values()):
        fail("serve chaos (b): NaN left in the pools after the eviction")

    after = seen[decode_ticks[1] - 1] + 7 + 3
    reqs, got, moved, fired = run(
        "c", f"sma_gemm@cuda:runtime_error:times=1,after={after}")
    if fired != 1 or moved["serve.tick_failures"] != 1 \
            or any(r.status != "done" for r in reqs) or got != want:
        fail("serve chaos (c): a kernel fault mid-tick was not retried "
             "into the unfaulted tokens")

    reqs, got, moved, fired = run(
        "d", f"serve.tick:latency:times=1,latency_s={CHAOS_LATENCY_S}",
        RetryPolicy(deadline_s=CHAOS_DEADLINE_S))
    if fired != 1 or moved["serve.watchdog_exceeded"] < 1 or got != want:
        fail("serve chaos (d): the watchdog did not count a late tick")

    eng.reset()
    eng.retry = RetryPolicy()
    for r in serve_requests(cfg)[1]:
        eng.submit(r)
    raised = None
    with repro_torch.options(check_numerics="raise"), \
            faults.inject_faults("sma_gemm@cuda:nan:times=1") as (spec,):
        try:
            eng.step()
        except FloatingPointError as exc:
            raised = exc
    print(f"serve chaos (e) check_numerics='raise', sma_gemm@cuda:nan: "
          f"fired {spec._fired}, raised {type(raised).__name__}: {raised}")
    if raised is None or spec._fired != 1:
        fail("serve chaos (e): a NaN under check_numerics='raise' did not "
             "raise FloatingPointError")

    eng.reset()
    dec = eng.engines["decode"]
    mb = SERVE_CACHE.max_blocks_per_req
    table = torch.arange(2 * mb, dtype=torch.int32,
                         device=dev).reshape(2, mb) % SERVE_CACHE.num_blocks
    cl = torch.tensor([5, 9], dtype=torch.int32, device=dev)
    toks = torch.tensor([[11], [12]], dtype=torch.int32, device=dev)
    misses, raised = dec.stats.misses, None
    with faults.inject_faults("engine.compile:compile_error:times=1"):
        try:
            dec(params, eng.state, table, cl, {"tokens": toks})
        except faults.InjectedFault as exc:
            raised = exc
    if raised is None or dec.stats.misses != misses:
        fail("serve chaos (f): an engine.compile fault did not raise, or "
             "it cached a signature")
    got = dec(params, eng.state, table, cl, {"tokens": toks})[0]
    want_logits = smodel.paged_decode_step(params, eng.state, table, cl, cfg,
                                           {"tokens": toks})[0]
    print(f"serve chaos (f) engine.compile:compile_error on the 2-row "
          f"decode signature: raised {type(raised).__name__}; the next call "
          f"compiled (misses {misses} -> {dec.stats.misses}), logits "
          f"torch.equal the direct step: {torch.equal(got, want_logits)}")
    if dec.stats.misses != misses + 1 or not torch.equal(got, want_logits):
        fail("serve chaos (f): the call after the compile fault did not "
             "compile, or disagrees with the direct step")
    section = guard.resilience_section(max_events=6)
    print(f"serve chaos: resilience section "
          f"{json.dumps(section, default=str)}")
    eng.reset()
    eng.retry = RetryPolicy()


def server_shim(cfg, params, dev):
    """``repro_torch.launch.serve.Server`` (the deprecated slot facade) on
    the full-width params: 4 slots, ``cache_size`` 1024, 4 requests whose
    prompts fit one prefill chunk.  Its greedy tokens must ``torch.equal``
    a hand-driven direct loop: each whole prompt through
    ``paged_prefill_step`` (one row, the engine's chunk width), then
    ``paged_decode_step`` over the 4 rows re-feeding each prompt's last
    token at position len(prompt), then their own tokens."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", DeprecationWarning)
        server = launch_serve.Server(cfg, params, slots=4, cache_size=1024,
                                     device=dev)
    if sum(issubclass(w.category, DeprecationWarning) for w in caught) != 1:
        fail("server shim: the construction did not warn exactly once")
    chunk = server.core.sched.config.prefill_chunk
    if max(SHIM_LENS) > chunk:
        fail(f"server shim: a prompt exceeds the prefill chunk {chunk}")
    rng = np.random.default_rng(5)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=n)
                    .astype(np.int32), max_new_tokens=SHIM_NEW)
            for i, n in enumerate(SHIM_LENS)]
    before = counters()
    t0 = time.perf_counter()
    for r in reqs:
        if not server.admit(r) or r.status != "active":
            fail(f"server shim: request {r.rid} not admitted ({r.error})")
    ticks = 0
    while server.active:
        server.tick()
        ticks += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    clean_serving("server shim", before, reqs)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.int32), device=dev)

    kv = PagedKVCache(server.core.cache, len(reqs))
    state = smodel.init_state(cfg, len(reqs), server.core.cache,
                                   device=dev)
    for i, r in enumerate(reqs):
        kv.admit(i, len(r.prompt), r.max_new_tokens)
        toks = np.zeros((1, chunk), np.int32)
        toks[0, :len(r.prompt)] = r.prompt
        smodel.paged_prefill_step(params, state, t(kv.table_rows([i])),
                                  t([0]), t([len(r.prompt)]), cfg,
                                  {"tokens": t(toks)})
    table = t(kv.table_rows(list(range(len(reqs)))))
    cl = t([len(r.prompt) for r in reqs])
    nxt = t([[r.prompt[-1]] for r in reqs])
    out = []
    for _ in range(SHIM_NEW):
        logits, _, cl = smodel.paged_decode_step(params, state, table,
                                                 cl.to(torch.int32), cfg,
                                                 {"tokens": nxt})
        nxt = logits.argmax(-1, keepdim=True).to(torch.int32)
        out.append(nxt[:, 0])
    want = torch.stack(out, 1).cpu()
    got = torch.tensor([r.out_tokens for r in reqs], dtype=torch.int32)
    print(f"server shim: {len(reqs)} requests (prompts {list(SHIM_LENS)}), "
          f"{SHIM_NEW} tokens each in {ticks} ticks, {wall:.3f} s; tokens "
          f"torch.equal the direct re-feed loop: {torch.equal(got, want)}")
    if not torch.equal(got, want):
        fail("server shim: tokens differ from the direct re-feed loop")


def serve_main():
    """``python -m repro_torch.launch.serve --arch mistral-nemo-12b`` in
    this process: full-width random weights, 4 requests on 4 slots."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch_serve.main(["--arch", NEMO_ARCH, "--requests", "4",
                           "--slots", "4", "--max-new", "8"])
    for line in buf.getvalue().splitlines():
        print(f"launch.serve main: {line}")
    if "4 done / 0 failed of 4 requests" not in buf.getvalue():
        fail("launch.serve main did not serve its 4 requests")


def serve_musicgen(dev):
    """musicgen-large at full width on ``embeds`` (no embedding table; the
    engine feeds ``token_embeds``, a one-hot of each id) through the
    compiled engine: 4 requests, then the compiled ticks against the
    direct steps.  Returns the timed pass's launches."""
    cfg = get_config(MUSICGEN_ARCH)
    params = init_full_width(cfg, dev)
    if "embed" in params:
        fail("musicgen-large: an embeds-mode model holds an embedding table")
    counts, _, eng = serve(cfg, params, dev, path="musicgen", n_requests=4)
    check_compiled_serving(cfg, params, dev, eng, plant=False, timing=False,
                           rows=4)
    return counts


def check_internvl(dev):
    """internvl2-2b's ``lm.forward`` at full width with 256 vision
    embeddings ahead of 256 tokens, B 2, through ``sma_jit``: the compiled
    forward launches what the direct one launches (7 ``sma_gemm`` a layer,
    the head, one flash a layer at head_dim 128, GQA 16/8) on the same
    routes, and its logits equal the direct forward's bit for bit.
    Returns the compiled forward's launches."""
    cfg = get_config(INTERNVL_ARCH)
    params = init_full_width(cfg, dev)
    batch = internvl_batch(cfg, dev)
    eng = repro_torch.sma_jit(functools.partial(lm.forward, cfg=cfg),
                              name=f"{cfg.name}.forward")
    want, *direct = counted_run(lambda: lm.forward(params, cfg, batch))
    t0 = time.perf_counter()
    eng(params, batch=batch)
    compile_s = time.perf_counter() - t0
    got, *compiled = counted_run(lambda: eng(params, batch=batch))
    s = cfg.num_vision_tokens + INTERNVL_TOKENS
    print(f"internvl2-2b lm.forward through sma_jit (B {INTERNVL_BATCH}, "
          f"{cfg.num_vision_tokens} vision + {INTERNVL_TOKENS} tokens): "
          f"first call {compile_s:.3f} s; launches, routes, routed "
          f"{json.dumps(compiled)}; logits {tuple(got.shape)} torch.equal "
          f"the direct forward: {torch.equal(got, want)}")
    if got.shape != (INTERNVL_BATCH, s, lm.padded_vocab(cfg)) \
            or not torch.isfinite(got[..., :cfg.vocab_size].float()).all():
        fail("internvl2-2b: compiled logits of the wrong shape or "
             "non-finite")
    if compiled != direct or direct[0] != jit_launches(cfg) or direct[2]:
        fail(f"internvl2-2b: compiled launches {compiled}, direct {direct}, "
             f"expected {jit_launches(cfg)} with nothing routed")
    if not torch.equal(got, want):
        fail("internvl2-2b: compiled logits differ from the direct forward")
    return compiled[0]


def host_time_vs_parent(parent: Path) -> None:
    """``host_times.py`` for ``parent`` (another checkout) and this one, A
    B B A, each reading in its own process: the compiled StableLM decode
    tick's host time of both trees on one card.  Prints both medians."""
    readings = {"parent": [], "this": []}
    for who in ("parent", "this", "this", "parent"):
        root = parent if who == "parent" else ROOT
        out = subprocess.run(
            [sys.executable, str(ROOT / "host_times.py"), "--root",
             str(root)], check=True, capture_output=True, text=True,
            timeout=900).stdout
        res = json.loads(out.strip().splitlines()[-1])
        readings[who] += res["host_ms"]
        print(f"host time ({who}, {root}): {json.dumps(res)}")
    med = {k: float(np.median(v)) for k, v in readings.items()}
    spread = {k: max(v) - min(v) for k, v in readings.items()}
    print(f"compiled decode tick host time, A B B A against {parent}: "
          f"parent median {med['parent']:.3f} ms (spread "
          f"{spread['parent']:.3f}), this tree {med['this']:.3f} ms "
          f"(spread {spread['this']:.3f}); change "
          f"{med['this'] - med['parent']:+.3f} ms")


# ---------------------------------------------------------------------------
# The training path
# ---------------------------------------------------------------------------
def step_launches(cfg) -> dict:
    """Kernel launches of one training step with remat (PERF.md): per
    layer, 7 projections forward, 7 again in the recomputation and 15 in
    the backward (dA and dB of each, and the gate's Z once more); 2 for
    the head's dW and dnormed; the flash forward twice and its backward
    once."""
    n = cfg.num_layers
    return {"sma_gemm": 29 * n + 2, "rmsnorm_gemm": 1,
            "flash_attention": 2 * n, "flash_attention_bwd": n}


def compiled_step_launches(cfg) -> dict:
    """Launches of one compiled training step: the direct step's but each
    remat group's recomputed MLP wo, whose output nothing reads (the eager
    recomputation runs up to it, since its input is the last tensor the
    group saved; the compiled program's dead-code pass drops it)."""
    out = step_launches(cfg)
    out["sma_gemm"] -= cfg.num_layers
    return out


def layer_products(cfg, block: str) -> list:
    """(K, N, epilogue) of each ``sma_gemm`` product of one ``block``
    layer of ``cfg`` in the forward: the mixer's (attention: q, k, v, o;
    RG-LRU: w_in, w_gate, w_a, w_x, w_out; mLSTM: w_up, w_q, w_k, w_v,
    w_if, w_down; sLSTM: w_gates, w_ff1, w_ff2), then the FFN's (the gated
    MLP; an MoE's router, whose experts are library ``bmm``s; none in the
    xLSTM blocks)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    q, kv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    if block in ("attn", "local"):
        out = [(d, q, "none"), (d, kv, "none"), (d, kv, "none"),
               (q, d, "none")]
    elif block == "rglru":
        out = [(d, d, "none"), (d, d, "gelu")] + [(d, d, "none")] * 3
    elif block == "mlstm":     # no FFN: the block is its mixer
        inner = int(d * cfg.mlstm_proj_factor)
        return ([(d, 2 * inner, "none")] + [(inner, inner, "none")] * 3
                + [(inner, 2 * cfg.num_heads, "none"), (inner, d, "none")])
    elif block == "slstm":     # w_gates (with its bias), the post-FF
        ff = -(-math.ceil(4 * d / 3) // 128) * 128
        return [(d, 4 * d, "none"), (d, ff, "gelu"), (ff, d, "none")]
    else:
        raise ValueError(f"no training products listed for {block!r}")
    if cfg.moe is not None:
        return out + [(d, cfg.moe.num_experts, "none")]
    return out + [(d, cfg.d_ff, "silu"), (d, cfg.d_ff, "none"),
                  (cfg.d_ff, d, "none")]


def matmul_params(cfg) -> int:
    """Parameters that enter a matrix product for one token, the MFU's N:
    every layer's products (:func:`layer_products`), an sLSTM step's
    recurrent ``r_gates`` (H x dh x 4 dh), the experts an MoE token
    chooses, and the head; the embedding gather does not count."""
    n = cfg.d_model * lm.padded_vocab(cfg)
    for block in cfg.block_pattern * cfg.num_groups:
        n += sum(k * m for k, m, _ in layer_products(cfg, block))
        if block == "slstm":
            n += cfg.d_model * 4 * cfg.d_model // cfg.num_heads
        if cfg.moe is not None:
            n += cfg.moe.top_k * 3 * cfg.d_model * cfg.moe.d_ff_expert
    return n


def train_gemms(cfg, tokens: int) -> list:
    """The distinct (M, K, N, epilogue) of a training step's ``sma_gemm``
    launches at ``tokens`` a step: each product K -> N forward (M tokens),
    its dA (tokens, N -> K) and dB (K, tokens -> N), and the head's dW and
    dnormed (its forward is ``rmsnorm_gemm``)."""
    out = []
    for block in dict.fromkeys(cfg.block_pattern):
        for k, n, ep in layer_products(cfg, block):
            out += [(tokens, k, n, ep), (tokens, n, k, "none"),
                    (k, tokens, n, "none")]
    d, vocab = cfg.d_model, lm.padded_vocab(cfg)
    out += [(d, tokens, vocab, "none"), (tokens, vocab, d, "none")]
    return list(dict.fromkeys(out))


def train_batch(cfg, dev, seq=TRAIN_SEQ, batch=TRAIN_BATCH):
    return next(DataPipeline(DataConfig(cfg.vocab_size, seq, batch, seed=0),
                             device=dev))


def named_leaves(tree, prefix: str = "") -> list:
    """(name, leaf) pairs in :func:`repro_torch.tree.leaves` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in named_leaves(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (tuple, list)):
        return [x for i, node in enumerate(tree)
                for x in named_leaves(node, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def grad_pieces(names, grads) -> dict:
    """Each gradient by name, the block leaves (stacked over layers) split
    into one piece a layer: ``blocks.0.mixer.wq[2]`` is layer 2's wq."""
    out = {}
    for name, g in zip(names, grads):
        if name.startswith("blocks."):
            out.update({f"{name}[{i}]": x for i, x in enumerate(g)})
        else:
            out[name] = g
    return out


# Planted faults in the backward of one training step: each is one wrong
# launch in one layer, made by feeding a kernel wrong inputs.  The first
# two must fail STEP_LIMITS; the third, 64 of the 8,192 tokens left out of
# one weight gradient, is the smallest we plant, and its reading says what
# the limits resolve.
STEP_FAULTS = {"flash backward, D term dropped": True,
               "dB, last 64-column N tile skipped": True,
               "dB, last 64-token K tile skipped": False}


@contextlib.contextmanager
def planted_backward(fault: str, layer: int, layers: int, tokens: int):
    """One wrong backward launch in ``layer``: the flash backward fed O as
    zeros (its D = rowsum(dO * O) term dropped), or one weight gradient
    dB = A^T dZ (the one product with K = tokens) computed without its last
    64 columns or without its last 64 tokens.  The backward runs the layers
    last to first; the head's dW is the first dB product, then 7 a layer.
    Yields the call counts, to show the fault found its launch."""
    bwd, gemm = kflash.flash_attention_bwd, kgemm.sma_gemm
    calls = {"flash": 0, "dB": 0}
    flash_at = layers - 1 - layer
    db_at = 1 + 7 * (layers - 1 - layer) + 3

    def wrong_bwd(q, k, v, out, lse, dout, **kw):
        if fault.startswith("flash") and calls["flash"] == flash_at:
            out = torch.zeros_like(out)
        calls["flash"] += 1
        return bwd(q, k, v, out, lse, dout, **kw)

    def wrong_gemm(a, b, **kw):
        if a.shape[-1] != tokens:
            return gemm(a, b, **kw)
        hit = fault.startswith("dB") and calls["dB"] == db_at
        calls["dB"] += 1
        if hit and "K tile" in fault:
            return gemm(a[:, :tokens - 64].contiguous(), b[:tokens - 64], **kw)
        if hit:
            n = b.shape[1] - 64
            part = gemm(a, b[:, :n].contiguous(), **kw)
            return torch.cat([part, part.new_zeros(a.shape[0], 64)], 1)
        return gemm(a, b, **kw)

    # The wrappers count their launches on their module-level names, which
    # now hold the stand-ins: give those a counter (the step's counts are
    # not read in these runs).
    wrong_bwd.launches = wrong_gemm.launches = 0
    kflash.flash_attention_bwd, kgemm.sma_gemm = wrong_bwd, wrong_gemm
    try:
        yield calls
    finally:
        kflash.flash_attention_bwd, kgemm.sma_gemm = bwd, gemm


def check_train_step(cfg, dev, layers: int = 4):
    """One step's loss and gradients, 4 full-width layers, through the
    kernels and through the plain versions, on the same f32 masters and
    batch (remat on in both, so the plain attention's S x S scores live
    for one layer at a time): the loss, the global grad norm and every
    weight's gradient, a layer at a time, within STEP_LIMITS.  Then the
    same step with each of STEP_FAULTS planted in layer 2."""
    cfg_n = dataclasses.replace(cfg, num_groups=layers)
    params = lm.init(cfg_n, seed=0, device=dev, dtype=cfg_n.parameter_dtype)
    names, flat = zip(*named_leaves(params))
    for p in flat:
        p.requires_grad_(True)
    batch = train_batch(cfg_n, dev)
    tokens = batch["tokens"].numel()

    def run():
        loss, _ = lm.loss_fn(params, cfg_n, batch, remat=True)
        grads = torch.autograd.grad(loss, flat)
        return (loss.item(), adamw.global_norm(grads).item(),
                grad_pieces(names, grads))

    with plain_kernels():
        want = run()

    def errors(got) -> dict:
        rel = {"loss": abs(got[0] - want[0]) / abs(want[0]),
               "grad_norm": abs(got[1] - want[1]) / want[1]}
        for name, w in want[2].items():
            d = got[2][name].float() - w.float()
            rel[name] = (d.norm() / w.float().norm().clamp_min(1e-30)).item()
        return rel

    ops.reset_counts()
    got = run()
    counts = ops.launch_counts()
    check_kernel_routes("train step", counts, "wgmma")
    rel = errors(got)
    limits = {k: STEP_LIMITS.get(k, STEP_LIMITS["grad"]) for k in rel}
    picks = ("blocks.0.mixer.wq[0]", f"blocks.0.ffn.wo[{layers - 1}]",
             "head.w")
    grads_rel = {k: x for k, x in rel.items() if k not in STEP_LIMITS}
    worst = max(grads_rel, key=grads_rel.get)
    shown = {k: float(f"{rel[k]:.4g}")
             for k in ("loss", "grad_norm") + picks}
    print(f"train step, {layers} layers, kernels vs plain: loss "
          f"{got[0]:.6f} vs {want[0]:.6f}, grad norm {got[1]:.5f} vs "
          f"{want[1]:.5f}; relative errors {json.dumps(shown)}; over all "
          f"{len(grads_rel)} gradient pieces max {rel[worst]:.4g} "
          f"({worst}), median {np.median(list(grads_rel.values())):.4g}")
    del got
    expect = step_launches(cfg_n)
    if {k: counts[k] for k in expect} != expect:
        fail(f"train step launches {counts}, expected {expect}")
    over = {k: x for k, x in rel.items() if not x <= limits[k]}
    if over:
        fail(f"train step, kernels vs plain: {over} over {limits}")

    layer = layers // 2
    for fault, must in STEP_FAULTS.items():
        with planted_backward(fault, layer, layers, tokens) as calls:
            frel = errors(run())
        if calls != {"flash": layers, "dB": 1 + 7 * layers}:
            fail(f"train step control '{fault}': the backward made {calls} "
                 f"launches, so the fault may have missed its target")
        mult = {k: x / limits[k] for k, x in frel.items()}
        top = sorted(mult, key=mult.get, reverse=True)
        largest = {k: round(mult[k], 3) for k in top[:3]}
        print(f"train step control, {fault} in layer {layer}: largest limit "
              f"multiples {json.dumps(largest)}, loss {mult['loss']:.3g}, "
              f"grad norm {mult['grad_norm']:.3g}; "
              f"{sum(x > 1 for x in mult.values())} of {len(mult)} readings "
              f"over their limits")
        if must and mult[top[0]] <= 1:
            fail(f"train step control '{fault}' passes every limit")


@contextlib.contextmanager
def captured_compiles():
    """The ``CompiledModel``s the engines build in the ``with`` scope
    (``train()`` returns its engine's statistics only)."""
    from repro_torch.compiler import dispatch as cdispatch
    orig, built = cdispatch.compile_with_options, []

    def spy(*args, **kwargs):
        built.append(orig(*args, **kwargs))
        return built[-1]

    cdispatch.compile_with_options = spy
    try:
        yield built
    finally:
        cdispatch.compile_with_options = orig


def print_compile(what: str, cm) -> None:
    # report_data: .report would first restamp its runtime section from
    # every span of the last profile window, minutes late in the script.
    rep = cm.report_data
    fus, bks = rep["fusion"], rep["backends"]
    print(f"{what}: compile "
          + ", ".join(f"{k.removesuffix('_s')} {v:.3f} s"
                      for k, v in rep["compile"].items())
          + f"; graph {cm.traced.num_nodes} nodes traced, "
          f"{len(cm.module.graph.nodes)} dispatched; plan {rep['num_ops']} "
          f"ops, {rep['groups']} groups, {rep['mode_switches']} mode "
          f"switches, systolic FLOP share "
          f"{rep['systolic_flop_share']:.4f}; fused sites planned "
          f"{fus['planned_fused_sites']}, realized "
          f"{fus['realized_fused_sites']} ({fus['realized_epilogue_sites']} "
          f"epilogue, {fus['realized_prologue_sites']} prologue); dispatch "
          f"{json.dumps(rep['dispatch'])}; routes {json.dumps(bks['routes'])}")


def run_trainer(cfg, dev):
    """train() at full width and depth, at TRAIN_LR, through its compiled
    step; returns the launch counts of the run (5 steps), the sma_gemm
    routes, the trained parameters and the compiled step."""
    loop = TrainLoopConfig(steps=TRAIN_STEPS, seq_len=TRAIN_SEQ,
                           global_batch=TRAIN_BATCH, log_every=1, seed=0,
                           peak_lr=TRAIN_LR, remat=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    torch.cuda.synchronize()
    with captured_compiles() as built:
        result = train(cfg, loop, device=dev)
    torch.cuda.synchronize()
    counts, routed = ops.launch_counts(), dict(ops.ROUTED)
    routes = nonzero(kgemm.ROUTES)
    peak = torch.cuda.max_memory_allocated()
    engine = result["engine"]
    if (engine["misses"], engine["hits"], len(built)) != \
            (1, TRAIN_STEPS - 1, 1):
        fail(f"trainer: the step engine compiled {len(built)} times, "
             f"{engine}; expected 1 miss and {TRAIN_STEPS - 1} hits")
    cm = built[0]
    hist = result["history"]
    for h in hist:
        if not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                and h["grad_norm"] > 0):
            fail(f"train step {h['step']}: loss {h['loss']}, grad norm "
                 f"{h['grad_norm']}")
    losses = [h["loss"] for h in hist]
    if not losses[-1] < losses[0]:
        fail(f"trainer: the loss did not fall over {TRAIN_STEPS} steps at "
             f"peak_lr {TRAIN_LR}: {losses}")
    per_step = compiled_step_launches(cfg)
    expect = {k: TRAIN_STEPS * n for k, n in per_step.items()}
    if {k: counts[k] for k in expect} != expect:
        fail(f"trainer launches {counts}, expected {expect} "
             f"({per_step} a step)")
    if routed:
        fail(f"trainer routed calls to plain versions: {routed}")
    if routes != {"wgmma": counts["sma_gemm"]}:
        fail(f"trainer: sma_gemm routes {routes}, expected every launch on "
             f"wgmma")
    FLASH_ROUTES_BY_PATH["train"] = check_flash_routes("trainer", counts)
    ROUTES_BY_PATH["train"] = check_kernel_routes("trainer", counts,
                                                  "wgmma")
    walls = [h["wall_s"] for h in hist]
    steps = [b - a for a, b in zip(walls, walls[1:])]
    step_s = float(np.median(steps))
    tokens = TRAIN_SEQ * TRAIN_BATCH
    n_mm = matmul_params(cfg)
    print_compile(f"train: {cfg.name}.train_step", cm)
    print(f"train: {ARCH} full width, {cfg.num_layers} layers, seq "
          f"{TRAIN_SEQ}, batch {TRAIN_BATCH}, remat, f32 masters + AdamW, "
          f"peak_lr {TRAIN_LR}, bf16 compute, the step compiled by sma_jit "
          f"(engine {json.dumps(engine)}); losses "
          f"{[round(x, 4) for x in losses]} (fell "
          f"{losses[0] - losses[-1]:.4f}), grad norms "
          f"{[round(h['grad_norm'], 4) for h in hist]}")
    print(f"train: step 1 {walls[0]:.3f} s (compile and first launches), "
          f"steps 2-5 {[round(x, 4) for x in steps]} s, median "
          f"{step_s:.4f} s: {tokens / step_s:.1f} tokens/s, MFU "
          f"{100 * 6 * n_mm * tokens / step_s / H100_BF16:.2f}% (6 N tokens "
          f"/ step / 989 TFLOP/s, N = {n_mm} matmul parameters); peak "
          f"memory {peak / 2**30:.2f} GiB (max_memory_allocated)")
    print(f"train: launches over {TRAIN_STEPS} steps {json.dumps(counts)}; "
          f"a step {json.dumps(per_step)} (the direct step "
          f"{json.dumps(step_launches(cfg))}); routed {routed}; sma_gemm "
          f"routes {json.dumps(routes)}; flash routes "
          f"{json.dumps(FLASH_ROUTES_BY_PATH['train'])}")
    return counts, routes, result["params"], cm


def step_ocfg():
    """train()'s optimizer configuration at TRAIN_STEPS, TRAIN_LR."""
    return adamw.AdamWConfig(peak_lr=TRAIN_LR,
                             warmup_steps=max(TRAIN_STEPS // 10, 1),
                             total_steps=TRAIN_STEPS)


def time_train_step(cfg, params, cm, dev, card: str, seq=TRAIN_SEQ,
                    batch_size=TRAIN_BATCH, steps: int = TIME_STEPS):
    """The compiled step (train()'s) against the direct step at full width,
    on the trained parameters and a fresh optimizer state: each one's peak
    memory (each after a collection, with the memory held before it
    printed: a step may leave tensors in reference cycles), compiled,
    direct, compiled, untimed, so that every reading below is of a warm
    path; then A B B A: CUDA-event ms a step over ``steps`` steps queued
    back to back behind a device-side sleep, and the host's wall until one
    step returns.  With ``steps`` 1 (a step of seconds, host-bound) a
    reading is one step after a collection: CUDA events around it and the
    host's wall until it returns."""
    direct = functools.partial(direct_step, cfg=cfg, ocfg=step_ocfg(),
                               remat=True, grad_compression=False)
    opt = adamw.init(params)
    batch = train_batch(cfg, dev, seq, batch_size)
    calls = {"direct": lambda: direct(params, opt, {}, batch),
             "compiled": lambda: cm(params, opt, {}, batch)}
    peaks, held = {}, {}
    for name in ("compiled", "direct", "compiled"):
        gc.collect()      # what an earlier step left in reference cycles
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held[name] = torch.cuda.memory_allocated() / 2**30
        calls[name]()
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() / 2**30
    times = {}
    for name in ("direct", "compiled", "compiled", "direct"):
        if steps == 1:
            gc.collect()
            reading = one_step_ms(calls[name])
        else:
            reading = (time_ms(calls[name], [()], iters=steps),
                       host_ms(calls[name]))
        times.setdefault(name, []).append(reading)
    for name, runs in times.items():
        print(f"train step timing, {name}, {cfg.num_layers} layers, S "
              f"{seq} x B {batch_size} ({card}): event ms a step "
              f"{[round(r[0], 3) for r in runs]}, host ms to return "
              f"{[round(r[1], 3) for r in runs]}; peak memory "
              f"{peaks[name]:.3f} GiB, {held[name]:.3f} of it held before "
              f"the step (parameters, moments, batch)")
    ev = {k: float(np.mean([r[0] for r in v])) for k, v in times.items()}
    print(f"train step timing: compiled / direct event ms "
          f"{ev['compiled'] / ev['direct']:.4f}, peak memory "
          f"{peaks['compiled'] / peaks['direct']:.4f}")
    return ev, peaks


def one_step_ms(fn) -> tuple:
    """(CUDA-event ms, host ms until it returns) of one call, the card idle
    before it."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    start.record()
    fn()
    end.record()
    wall = time.perf_counter() - t
    end.synchronize()
    return start.elapsed_time(end), 1e3 * wall


def profile_train_step(cfg, params, dev, cm, seq=TRAIN_SEQ,
                       batch_size=TRAIN_BATCH):
    """torch.profiler over one more compiled training step (fresh AdamW
    state): device busy share and device time by kernel.  Device activity
    only, as ``profile_serving``'s prefill: the report reads device rows
    only, and a CPU-side trace of xLSTM's ~450,000 host ops a step takes
    minutes to reduce (148 s against 65 on an H100; PERF.md)."""
    from torch.profiler import ProfilerActivity, profile
    opt = adamw.init(params)
    batch = train_batch(cfg, dev, seq, batch_size)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cm(params, opt, {}, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report_profile(prof, wall, 1, "compiled train step")


def relative_errors(got: dict, want: dict) -> dict:
    """Per piece, ||got - want|| / ||want|| (Frobenius)."""
    return {k: ((got[k].float() - w.float()).norm()
                / w.float().norm().clamp_min(1e-30)).item()
            for k, w in want.items()}


def state_pieces(names, params, opt, start) -> dict:
    """After a step: each parameter's update (params - start) and each
    moment, a layer at a time."""
    upd = [p - p0 for p, p0 in zip(leaves(params), leaves(start))]
    out = {}
    for tag, flat in (("update", upd), ("m", leaves(opt["m"])),
                      ("v", leaves(opt["v"]))):
        out.update({f"{tag} {k}": x
                    for k, x in grad_pieces(names, flat).items()})
    return out


def spread_multiples(rel: dict, spread: dict) -> dict:
    """Each reading over its limit, max(2 x spread, JIT_TRAIN_FLOOR)."""
    return {k: x / max(2 * spread[k], JIT_TRAIN_FLOOR)
            for k, x in rel.items()}


def kernel_counts() -> tuple:
    """(launches, routes of the GEMM and flash kernels, ROUTED) since the
    last reset."""
    return (nonzero(ops.launch_counts()),
            {"sma_gemm": nonzero(kgemm.ROUTES),
             "rmsnorm_gemm": nonzero(knorm.ROUTES),
             "flash": nonzero(kflash.FWD_ROUTES),
             "flash_bwd": nonzero(kflash.BWD_ROUTES)},
            dict(ops.ROUTED))


def less_gemm(counts: tuple, n: int) -> tuple:
    """``counts`` with ``n`` fewer ``sma_gemm`` launches on ``wgmma``."""
    launches, routes, routed = copy.deepcopy(counts)
    launches["sma_gemm"] -= n
    routes["sma_gemm"]["wgmma"] -= n
    return launches, routes, routed


def grad_output_site(cm, index: int, layer: int):
    """The dispatched ``sma_gemm`` site that makes layer ``layer``'s piece
    of output ``index``: the stack of a block leaf's per-layer gradients,
    walked back through its casts and views."""
    from repro_torch.compiler import dispatch as cdispatch
    out = next(n for n in cm.module.graph.nodes if n.op == "output")
    node = out.args[0][index]
    node = node.args[0][layer]                      # stack([...])[layer]
    while node.target is not cdispatch.sma_gemm_site:
        node = node.all_input_nodes[0]
    return node


def zero_site(a, b, bias, *, epilogue, shape, mesh=False):
    """A planted fault: the GEMM site returns zeros and launches nothing."""
    out = a.new_zeros(tuple(a.shape[:-1]) + (b.shape[1],))
    return out if shape is None else out.view(shape)


def skip_copy(dst, src):
    """A planted fault: the parameter write is dropped."""
    return dst


def check_compiled_train_step(cfg, dev, layers: int = 4):
    """The train step through sma_jit against the direct step, 4 full-width
    layers, on the same f32 masters, moments and batch.

    1. The loss and gradients (``lm.loss_fn`` + ``torch.autograd.grad``,
       compiled and direct): the direct part run twice for its own
       spread; the compiled loss and the gradients upstream of every dQ
       (the head, the top layer's MLP) torch.equal the direct ones, every
       other gradient within max(2 x spread, JIT_TRAIN_FLOOR); launches
       and routes the direct ones but the ``layers`` dead recomputations.
    2. The whole step (``make_step``), from the state one direct step
       left, on the next batch: each parameter's update and each moment
       within the same kind of limit (``clip_norm`` scales every gradient
       by the global norm, which sums the nondeterministic ones too), the
       loss torch.equal.
    3. Planted faults edited into the compiled modules, which must fail
       those limits: layer 2's wq dB site returning zeros, and one AdamW
       parameter write (the stacked wq's) dropped."""
    from repro_torch import sma_jit
    from repro_torch.compiler import dispatch as cdispatch
    cfg_n = dataclasses.replace(cfg, num_groups=layers)
    params = lm.init(cfg_n, seed=0, device=dev, dtype=cfg_n.parameter_dtype)
    names = [n for n, _ in named_leaves(params)]
    batch = train_batch(cfg_n, dev)
    layer = layers // 2

    def loss_and_grads(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, _ = lm.loss_fn(live, cfg_n, batch, remat=True)
        return loss.detach(), torch.autograd.grad(loss, leaves(live))

    def grads_run(fn):
        ops.reset_counts()
        loss, grads = fn(params, batch)
        torch.cuda.synchronize()
        return loss, grad_pieces(names, grads), kernel_counts()

    grad_eng = sma_jit(loss_and_grads, name=f"{cfg_n.name}.loss_and_grads")
    t0 = time.perf_counter()
    grad_cm = grad_eng.compile(params, batch)
    print_compile(f"train check, {layers} layers, loss and gradients "
                  f"({time.perf_counter() - t0:.3f} s)", grad_cm)
    want = grads_run(loss_and_grads)
    again = grads_run(loss_and_grads)
    spread = relative_errors(again[1], want[1])
    del again
    got = grads_run(grad_eng)
    if not torch.equal(got[0], want[0]):
        fail(f"compiled loss {got[0].item()} differs from the direct "
             f"{want[0].item()}")
    exact = ["head.w", "final_norm.scale"] + [
        f"blocks.0.{k}[{layers - 1}]"
        for k in ("ffn.wg", "ffn.wi", "ffn.wo", "norm2.scale")]
    unequal = [k for k in exact if not torch.equal(got[1][k], want[1][k])]
    if unequal:
        fail(f"compiled gradients upstream of every dQ differ from the "
             f"direct ones: {unequal}")
    expect = less_gemm(want[2], layers)
    if got[2] != expect:
        fail(f"compiled loss and gradients: launches, routes, routed "
             f"{got[2]}, expected {expect} (direct {want[2]})")
    mult = spread_multiples(relative_errors(got[1], want[1]), spread)
    worst = max(mult, key=mult.get)
    zero_spread = sum(x == 0 for x in spread.values())
    print(f"train check, {layers} layers, loss and gradients compiled vs "
          f"direct: loss {got[0].item():.6f} torch.equal; {len(exact)} "
          f"gradients upstream of every dQ torch.equal; direct-vs-direct "
          f"spread max {max(spread.values()):.4g}, median "
          f"{np.median(list(spread.values())):.4g} ({zero_spread} of "
          f"{len(spread)} pieces 0); largest limit multiple "
          f"{mult[worst]:.4g} ({worst}); launches {json.dumps(got[2][0])} "
          f"(direct {json.dumps(want[2][0])}); routes "
          f"{json.dumps(got[2][1])}")
    if mult[worst] > 1:
        fail(f"compiled gradient {worst} over its limit: {mult[worst]:.4g} "
             f"x max(2 x spread {spread[worst]:.4g}, {JIT_TRAIN_FLOOR})")
    del got
    # Planted: layer `layer`'s wq dB returns zeros.
    wq = 1 + names.index("blocks.0.mixer.wq")        # outputs: loss, grads
    node = grad_output_site(grad_cm, wq, layer)
    node.target = zero_site
    grad_cm.module.recompile()
    try:
        bad = grads_run(grad_eng)
    finally:
        node.target = cdispatch.sma_gemm_site
        grad_cm.module.recompile()
    bmult = spread_multiples(relative_errors(bad[1], want[1]), spread)
    key = f"blocks.0.mixer.wq[{layer}]"
    print(f"train check control, layer {layer}'s wq dB zeroed in the "
          f"compiled module: its limit multiple {bmult[key]:.4g}; "
          f"{sum(x > 1 for x in bmult.values())} of {len(bmult)} readings "
          f"over their limits; sma_gemm launches {bad[2][0]['sma_gemm']}")
    if bmult[key] <= 1 or bad[2][0]["sma_gemm"] != expect[0]["sma_gemm"] - 1:
        fail("planted fault (wq dB zeroed) not caught by the gradient "
             "check")
    del bad, want

    # 2. The whole step, on the next batch, from the state one direct step
    # left: Adam's first update is about sign(g) a element, which flips
    # wherever the dQ order moves a gradient near 0 (a few % of a lower
    # layer's update); with the moments of a step before, it does not.
    ocfg = step_ocfg()
    direct = functools.partial(direct_step, cfg=cfg_n, ocfg=ocfg,
                               remat=True, grad_compression=False)
    step_eng = make_step(cfg_n, ocfg, remat=True, grad_compression=False)
    pipe = DataPipeline(DataConfig(cfg_n.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                                   seed=0), device=dev)
    first, batch = next(pipe), next(pipe)
    start = copy.deepcopy(params), adamw.init(params)
    start = tuple(direct(*start, {}, first)[:2])
    step_cm = step_eng.compile(*start, {}, batch)

    def step_run(fn):
        p, o = copy.deepcopy(start)
        ops.reset_counts()
        p, o, _, m = fn(p, o, {}, batch)
        torch.cuda.synchronize()
        return state_pieces(names, p, o, start[0]), m, kernel_counts()

    want = step_run(direct)
    again = step_run(direct)
    spread = relative_errors(again[0], want[0])
    del again
    got = step_run(step_eng)
    if not torch.equal(got[1]["loss"], want[1]["loss"]):
        fail("compiled step's loss differs from the direct step's")
    if got[2] != less_gemm(want[2], layers):
        fail(f"compiled step: launches, routes, routed {got[2]}, expected "
             f"{less_gemm(want[2], layers)}")
    mult = spread_multiples(relative_errors(got[0], want[0]), spread)
    worst = max(mult, key=mult.get)
    print(f"train check, {layers} layers, one step compiled vs direct: loss "
          f"torch.equal, grad norm {got[1]['grad_norm'].item():.6f} vs "
          f"{want[1]['grad_norm'].item():.6f}; parameter updates and "
          f"moments: direct-vs-direct spread max "
          f"{max(spread.values()):.4g}, median "
          f"{np.median(list(spread.values())):.4g}; largest limit multiple "
          f"{mult[worst]:.4g} ({worst}); launches {json.dumps(got[2][0])}")
    if mult[worst] > 1:
        fail(f"compiled step: {worst} over its limit ({mult[worst]:.4g})")
    del got
    # Planted: the stacked wq's parameter write dropped.
    flat, _ = pytree.tree_flatten(((*start, {}, batch), {}))
    wq = start[0]["blocks"][0]["mixer"]["wq"]
    target = [n for n in step_cm.module.graph.nodes
              if n.op == "placeholder"][next(i for i, t in enumerate(flat)
                                             if t is wq)]
    node = next(n for n in target.users if n.target is
                torch.ops.aten.copy_.default)
    node.target = skip_copy
    step_cm.module.recompile()
    try:
        bad = step_run(step_eng)
    finally:
        node.target = torch.ops.aten.copy_.default
        step_cm.module.recompile()
    bmult = spread_multiples(relative_errors(bad[0], want[0]), spread)
    keys = [k for k in bmult if k.startswith("update blocks.0.mixer.wq[")]
    others = sorted((k for k in bmult if k not in keys and bmult[k] > 1),
                    key=bmult.get, reverse=True)
    print(f"train check control, the stacked wq's AdamW write dropped in "
          f"the compiled step: its update's limit multiples "
          f"{[round(bmult[k], 3) for k in keys]}; "
          f"{sum(x > 1 for x in bmult.values())} of {len(bmult)} readings "
          f"over their limits; the others over "
          f"{json.dumps({k: round(bmult[k], 3) for k in others[:8]})}")
    if len(keys) != layers or min(bmult[k] for k in keys) <= 1:
        fail("planted fault (a parameter write dropped) not caught")


def check_train_options(cfg, dev):
    """train() with ``grad_compression`` (2 steps, 4 full-width layers:
    finite, one compile and a hit), and a run halted at step 2 and resumed
    to step 3 against unbroken 3-step runs (a 2-layer bf16 model of d 128,
    head_dim 64, full vocabulary, so its checkpoints stay small): the
    resumed parameters within max(2 x the two unbroken runs' spread,
    JIT_TRAIN_FLOOR) of the first unbroken run's, a layer at a time, and
    its step-3 loss within max(2 x theirs apart, RESUME_LOSS_FLOOR)."""
    cfg4 = dataclasses.replace(cfg, num_groups=4)
    loop = TrainLoopConfig(steps=2, seq_len=TRAIN_SEQ,
                           global_batch=TRAIN_BATCH, log_every=1,
                           peak_lr=TRAIN_LR, grad_compression=True)
    out = train(cfg4, loop, device=dev)
    hist = out["history"]
    if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
               for h in hist) or (out["engine"]["misses"],
                                  out["engine"]["hits"]) != (1, 1):
        fail(f"train with grad_compression: {hist}, {out['engine']}")
    print(f"train options: grad_compression, 4 layers, 2 steps: losses "
          f"{[round(h['loss'], 4) for h in hist]}, grad norms "
          f"{[round(h['grad_norm'], 4) for h in hist]}; engine "
          f"{json.dumps(out['engine'])}")
    del out
    small = dataclasses.replace(cfg, num_groups=2, d_model=128, num_heads=2,
                                num_kv_heads=2, head_dim=64, d_ff=256)
    ckpt = ROOT / "build" / "chip_smoke_checkpoints"
    shutil.rmtree(ckpt, ignore_errors=True)
    base = dict(steps=3, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                log_every=1, peak_lr=TRAIN_LR, checkpoint_every=100)
    names = [n for n, _ in named_leaves(lm.init(small, seed=0, device=dev))]
    runs = [train(small, TrainLoopConfig(**base), device=dev)
            for _ in range(2)]
    halted = train(small, TrainLoopConfig(checkpoint_dir=str(ckpt),
                                          halt_at_step=2, **base),
                   device=dev)
    resumed = train(small, TrainLoopConfig(checkpoint_dir=str(ckpt), **base),
                    device=dev)
    shutil.rmtree(ckpt, ignore_errors=True)
    if [h["step"] for h in halted["history"]] != [1, 2] or \
            [h["step"] for h in resumed["history"]] != [3]:
        fail(f"halt/resume steps: {halted['history']}, "
             f"{resumed['history']}")

    def pieces(out):
        return grad_pieces(names, leaves(out["params"]))

    spread = relative_errors(pieces(runs[1]), pieces(runs[0]))
    mult = spread_multiples(relative_errors(pieces(resumed),
                                            pieces(runs[0])), spread)
    worst = max(mult, key=mult.get)
    losses = [[h["loss"] for h in r["history"]]
              for r in runs + [halted, resumed]]
    last = [r[-1] for r in losses]
    loss_limit = max(2 * abs(last[1] - last[0]),
                     RESUME_LOSS_FLOOR * abs(last[0]))
    print(f"train options: halted at step 2 and resumed to 3 (d 128, 2 "
          f"layers): losses unbroken {losses[0]}, {losses[1]}, halted "
          f"{losses[2]}, resumed {losses[3]}; step 3's loss resumed vs "
          f"unbroken {abs(last[3] - last[0]):.4g} (limit {loss_limit:.4g});"
          f" parameters against the unbroken run: spread max "
          f"{max(spread.values()):.4g}, largest limit multiple "
          f"{mult[worst]:.4g} ({worst})")
    if not all(math.isfinite(x) for r in losses for x in r) or \
            mult[worst] > 1 or abs(last[3] - last[0]) > loss_limit:
        fail(f"resumed run: {worst} over its limit ({mult[worst]:.4g}) or "
             f"step 3's loss {last[3]} against {last[0]}")


def kernel_times(prof) -> dict:
    """{name: [device us, launches]} of a finished ``torch.profiler`` trace,
    summed from the trace's raw device events: kernels, copies and fills,
    no host op and no ``record_function`` range's device span.  It builds
    none of ``key_averages``'s per-event Python objects, whose cost grows
    with the events (xLSTM's train step: most of a minute; PERF.md)."""
    out = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CPU \
                or ev.is_user_annotation() \
                or getattr(ev, "is_hidden_event", lambda: False)():
            continue
        row = out.setdefault(ev.name(), [0.0, 0])
        row[0] += ev.duration_ns() / 1e3
        row[1] += 1
    return out


def same_as_key_averages(prof) -> None:
    """Fails unless :func:`kernel_times` of a device-only trace gives the
    kernels, launches and device time (to 1e-6) that ``key_averages``
    gives: the check of the reduction on the card's own torch."""
    want = {ev.key: (ev.self_device_time_total, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and ev.self_device_time_total > 0}
    got = {k: v for k, v in kernel_times(prof).items() if v[0] > 0}
    if set(got) != set(want) or any(
            got[k][1] != n or abs(got[k][0] - us) > 1e-6 * us
            for k, (us, n) in want.items()):
        fail(f"kernel_times {got} differs from key_averages {want}")


def report_profile(prof, wall: float, steps: int, what: str):
    """Print the device busy share of the window and the kernels by device
    time; returns the busy seconds (None when the trace has none)."""
    rows = [(us, n, key) for key, (us, n) in kernel_times(prof).items()
            if us > 0]
    if not rows:
        print(f"profile {what}: no device time in the trace (not measured)")
        return None
    busy = sum(r[0] for r in rows) / 1e6
    print(f"profile: {steps} {what}(s) in {1e3 * wall:.2f} ms host wall, "
          f"device busy {1e3 * busy:.2f} ms ({100 * busy / wall:.1f}% of "
          f"the window, idle {100 * (1 - busy / wall):.1f}%)")
    for dev_us, count, key in sorted(rows, reverse=True)[:16]:
        print(f"profile: {dev_us / steps / 1e3:8.3f} ms/step "
              f"{count // steps:5d}/step  {key[:90]}")
    return busy


# ---------------------------------------------------------------------------
# The front door: full-width StableLM-2-1.6B lm.forward through sma_jit
# ---------------------------------------------------------------------------
JIT_BATCH, JIT_SEQ = TRAIN_BATCH, TRAIN_SEQ      # the trainer's shape
JIT_SHORT_SEQ = 1024                             # a second signature
JIT_TIME_ITERS = 5
# Words of library GEMM kernels' names (cuBLAS, CUTLASS) in a profile, and
# the port's own GEMM kernels, some of whose names share them.
LIBRARY_GEMM_WORDS = ("gemm", "cutlass", "cublas", "xmma", "nvjet")
OWN_GEMM_KERNELS = ("gemm_wgmma_kernel", "gemm_tc_kernel", "gemm_f32_kernel",
                    "splitk_partial_kernel", "splitk_reduce_kernel")


def jit_launches(cfg) -> dict:
    """Launches of one forward, direct or compiled: 7 projections a layer,
    the head, one flash a layer."""
    n = cfg.num_layers
    return {"sma_gemm": 7 * n, "rmsnorm_gemm": 1, "flash_attention": n}


def counted_run(fn):
    """``fn()`` between a reset and a read of the launch counters: (out,
    launches, routes of the GEMM and flash kernels, ROUTED)."""
    ops.reset_counts()
    torch.cuda.synchronize()
    out = fn()
    torch.cuda.synchronize()
    routes = {"sma_gemm": nonzero(kgemm.ROUTES),
              "rmsnorm_gemm": nonzero(knorm.ROUTES),
              "flash": nonzero(kflash.FWD_ROUTES)}
    return out, nonzero(ops.launch_counts()), routes, dict(ops.ROUTED)


def library_gemm_kernels(prof) -> list:
    names = set(kernel_times(prof))
    return sorted(n for n in names
                  if any(w in n.lower() for w in LIBRARY_GEMM_WORDS)
                  and not any(k in n for k in OWN_GEMM_KERNELS))


def host_ms(fn) -> float:
    """Host wall of one call until it returns (the enqueue), the card idle
    before it; the card is drained after."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    wall = time.perf_counter() - t
    torch.cuda.synchronize()
    return 1e3 * wall


def front_door(cfg, params, dev, card: str):
    """``sma_jit(lm.forward)`` at full width, B x S = JIT_BATCH x JIT_SEQ:
    compile (stage times, plan summary), cache (a hit, then a second
    signature), launches and routes equal to the direct forward's, no
    library GEMM in its profile, logits bit for bit the direct ones, a
    planted fault in the compiled module caught, and the fused / unfused /
    direct forwards timed.  Returns the compiled call's launches."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import SMAOptions, sma_jit
    from repro_torch.compiler import dispatch as cdispatch
    gen = torch.Generator(device=dev).manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (JIT_BATCH, JIT_SEQ),
                         generator=gen, device=dev, dtype=torch.int32)
    batch = {"tokens": toks}
    fwd = functools.partial(lm.forward, cfg=cfg)
    eng = sma_jit(fwd)

    # 1. Compile.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng(params, batch=batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    # 2. Cache.
    hit_ms = host_ms(lambda: eng(params, batch=batch))
    if (eng.stats.misses, eng.stats.hits) != (1, 1):
        fail(f"front door: second call at the same shapes was not a cache "
             f"hit: {eng.stats}")
    eng(params, batch={"tokens": toks[:, :JIT_SHORT_SEQ]})
    if (eng.stats.misses, eng.stats.hits) != (2, 1):
        fail(f"front door: S {JIT_SHORT_SEQ} did not compile once: "
             f"{eng.stats}")
    cm = eng.compile(params, batch=batch)
    rep = cm.report_data        # compile-time sections (see print_compile)
    fus, disp, bks = rep["fusion"], rep["dispatch"], rep["backends"]
    print(f"jit: compile of lm.forward ({ARCH} full width, {cfg.num_layers} "
          f"layers, B {JIT_BATCH} x S {JIT_SEQ}, bf16): "
          + ", ".join(f"{k.removesuffix('_s')} {v:.3f} s"
                      for k, v in rep["compile"].items())
          + f"; first call {first_s:.3f} s (compile + run); graph "
          f"{cm.traced.num_nodes} nodes")
    print(f"jit: plan: {rep['num_ops']} ops, {rep['groups']} groups "
          f"({rep['systolic_groups']} systolic, {rep['simd_groups']} simd),"
          f" {rep['mode_switches']} mode switches, systolic FLOP share "
          f"{rep['systolic_flop_share']:.4f}; fused sites planned "
          f"{fus['planned_fused_sites']}, realized "
          f"{fus['realized_fused_sites']} ({fus['realized_epilogue_sites']} "
          f"epilogue, {fus['realized_prologue_sites']} prologue); HBM bytes "
          f"avoided planned {fus['planned_hbm_bytes_avoided']:.6g}, realized"
          f" {fus['realized_hbm_bytes_avoided']:.6g}; fallbacks "
          f"{json.dumps(fus['fallback_reasons'])}")
    print(f"jit: dispatch {json.dumps(disp)}; routes "
          f"{json.dumps(bks['routes'])}; backends "
          f"{json.dumps(bks['chosen'])}")
    print(f"jit: cache {json.dumps(eng.stats.asdict())}; a cached call's "
          f"host wall to return {hit_ms:.3f} ms")
    # 3. Launches and routes, compiled against direct.
    direct, d_counts, d_routes, d_routed = counted_run(
        lambda: fwd(params, batch=batch))
    got, j_counts, j_routes, j_routed = counted_run(
        lambda: eng(params, batch=batch))
    expect = jit_launches(cfg)
    want_routes = {"sma_gemm": {"wgmma": expect["sma_gemm"]},
                   "rmsnorm_gemm": {"wgmma": 1},
                   "flash": {"wgmma": expect["flash_attention"]}}
    if d_counts != expect or d_routes != want_routes or d_routed:
        fail(f"direct forward launches {d_counts}, routes {d_routes}, "
             f"routed {d_routed}; expected {expect}, {want_routes}")
    if (j_counts, j_routes, j_routed) != (d_counts, d_routes, d_routed):
        fail(f"compiled forward launches {j_counts}, routes {j_routes}, "
             f"routed {j_routed}; the direct forward {d_counts}, "
             f"{d_routes}")
    print(f"jit: launches of one forward, compiled {json.dumps(j_counts)} "
          f"= direct; routes {json.dumps(j_routes)}")
    # ... and no library GEMM in a profile of one compiled call.
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng(params, batch=batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    lib = library_gemm_kernels(prof)
    if lib:
        fail(f"compiled forward ran library GEMM kernels: {lib}")
    report_profile(prof, wall, 1, "compiled forward")
    # 4. Logits.
    if not torch.equal(got, direct):
        err = (got.float() - direct.float()).abs().max().item()
        fail(f"compiled logits differ from the direct forward's (max |err| "
             f"{err:.4g})")
    print(f"jit: logits {tuple(got.shape)} {got.dtype} bit for bit the "
          f"direct forward's")
    # 5. A planted fault in the compiled module: one fused silu dropped.
    gm = cm.module
    node = next(n for n in gm.graph.nodes
                if n.target is cdispatch.sma_gemm_site
                and n.kwargs["epilogue"] == "silu")
    saved = dict(node.kwargs)
    node.kwargs = {**saved, "epilogue": "none"}
    gm.recompile()
    try:
        bad = eng(params, batch=batch)
    finally:
        node.kwargs = saved
        gm.recompile()
    if torch.equal(bad, direct):
        fail("planted fault (one fused silu dropped) not caught by the "
             "logits check")
    print(f"jit: planted fault (layer 0's fused silu dropped) caught: max "
          f"|err| {(bad.float() - direct.float()).abs().max().item():.4g}")
    del bad
    if not torch.equal(eng(params, batch=batch), direct):
        fail("compiled logits differ after the planted fault was removed")
    # 6. The A/B: fused, unfused (every GEMM bare, epilogues as their own
    # kernels), direct.
    unfused = sma_jit(fwd, options=SMAOptions(fuse_runtime=False))
    unfused(params, batch=batch)
    u_out, u_counts, u_routes, _ = counted_run(
        lambda: unfused(params, batch=batch))
    u_err = (u_out.float() - direct.float()).abs().max().item()
    del u_out
    print(f"jit: unfused forward launches {json.dumps(u_counts)}, routes "
          f"{json.dumps(u_routes)}; logits max |err| against the direct "
          f"forward {u_err:.4g} (a reading: its gate products run in f32)")
    calls = {"direct": lambda: fwd(params, batch=batch),
             "fused": lambda: eng(params, batch=batch),
             "unfused": lambda: unfused(params, batch=batch)}
    times = {}
    for name in ("direct", "fused", "unfused", "unfused", "fused", "direct"):
        dev_ms = time_ms(calls[name], [()], iters=JIT_TIME_ITERS)
        paced = time_ms(calls[name], [()], iters=JIT_TIME_ITERS, paced=True)
        times.setdefault(name, []).append((dev_ms, paced,
                                           host_ms(calls[name])))
    for name, runs in times.items():
        print(f"jit: {name} forward, B {JIT_BATCH} x S {JIT_SEQ} ({card}): "
              f"device ms {[round(r[0], 3) for r in runs]}, host-paced ms "
              f"{[round(r[1], 3) for r in runs]}, host wall to return ms "
              f"{[round(r[2], 3) for r in runs]}")
    return j_counts


# ---------------------------------------------------------------------------
# The recurrent path: recurrentgemma-2b through lm.prefill / lm.decode_step
# ---------------------------------------------------------------------------
def scan_inputs(gen, dev, b, s, d, dt):
    """Decays in (0, 1) and inputs of 0.1 scale, as the reference's kernel
    test draws them; h0 of unit scale."""
    a = torch.sigmoid(torch.randn((b, s, d), generator=gen, device=dev))
    u = torch.randn((b, s, d), generator=gen, device=dev) * 0.1
    h0 = torch.randn((b, d), generator=gen, device=dev)
    return a.to(dt), u.to(dt), h0.to(dt)


def rglru_multiples(got, want):
    return ((got.float() - want.float()).abs()
            / (RGLRU_ATOL + RGLRU_RTOL * want.float().abs()))


def rglru_controls(a, u, h0, want_seq, want_last):
    """Planted faults fed to the kernel, each held against the plain
    version of the right inputs: the carry reset to h0 at t = S/2 (the
    sequence run as two halves), h_last taken one step early (the last
    step left out) and a read one step late (a_t replaced by a_{t-1}).
    Each must fail the check on every element it moves by more than
    FAULT_MARGIN limits (measured on the plain version of the faulty
    inputs)."""
    half = a.shape[1] // 2
    late = torch.cat([a[:, :1], a[:, :-1]], 1)

    def reset(fn):
        s1, _ = fn(a[:, :half], u[:, :half], h0)
        s2, last = fn(a[:, half:], u[:, half:], h0)
        return torch.cat([s1, s2], 1), last

    faults = {
        f"carry reset to h0 at t={half}": (reset, 0),
        "h_last one step early": (
            lambda fn: fn(a[:, :-1], u[:, :-1], h0), 1),
        "a read at t-1": (lambda fn: fn(late, u, h0), 0),
    }
    for name, (run, which) in faults.items():
        want = (want_seq, want_last)[which]
        effect = rglru_multiples(run(ref.rglru_scan_ref)[which], want)
        bad = rglru_multiples(run(krglru.rglru_scan)[which], want)
        must = effect > FAULT_MARGIN
        n_must = int(must.sum())
        n_caught = int((bad[must] > 1).sum())
        print(f"rglru control, {name}: moves {n_must} of {must.numel()} "
              f"{'h_seq' if which == 0 else 'h_last'} elements by > "
              f"{FAULT_MARGIN} limits; the check fails {n_caught} of them")
        if n_must == 0 or n_caught < n_must:
            fail(f"rglru control '{name}' passes the check where it moves "
                 f"the output")


def rglru_plant_controls(a, u, h0, want, faults):
    """Planted faults inside the tma kernel (``krglru._run`` with a
    ``ref.SCAN_PLANT_*`` mask), each held against the plain version of the
    right inputs: each must fail the check on every element it moves by
    more than FAULT_MARGIN limits (measured on
    ``ref.rglru_scan_planted_ref``, the same fault in plain PyTorch, for
    the kernel's ring stage and depth).  The planted run must also be that
    plain version bit for bit: the fault is the one named, and no other."""
    tile = krglru.tma_tile(a.dtype)
    for name, (plant, which) in faults.items():
        got = krglru._run(a, u, h0, "tma", plant=plant)
        emulated = ref.rglru_scan_planted_ref(a, u, h0, plant, tile["rows"],
                                              tile["stages"])
        effect = rglru_multiples(emulated[which], want[which])
        bad = rglru_multiples(got[which], want[which])
        must = effect > FAULT_MARGIN
        n_must = int(must.sum())
        n_caught = int((bad[must] > 1).sum())
        same = all(torch.equal(g, e) for g, e in zip(got, emulated))
        print(f"rglru tma control, {name}: moves {n_must} of {must.numel()} "
              f"{'h_seq' if which == 0 else 'h_last'} elements by > "
              f"{FAULT_MARGIN} limits; the check fails {n_caught} of them; "
              f"the kernel's output is its plain version's: {same}")
        if n_must == 0 or n_caught < n_must or not same:
            fail(f"rglru tma control '{name}' passes the check where it "
                 f"moves the output, or is not the fault named")
        del got, emulated, effect, bad, must


def check_rglru(gen, dev):
    """The scan kernel against its plain version at the prefill's shape
    (B 4, S 4096, D 2560, bf16) with and without h0, and at a ragged
    (1, 4097, 2568) in f32: within the limit, and on the tma route bit for
    bit; the planted faults on the first (and the tail fault of the tma
    kernel on the last, whose S is past its stages); the prefill's call
    (no h0) timed beside the simt kernel (the earlier design) and
    ``torch.add(a, u)`` on the same inputs."""
    rows = []
    cases = [(RG_BATCH, RG_PROMPT, 2560, torch.bfloat16, True),
             (RG_BATCH, RG_PROMPT, 2560, torch.bfloat16, False),
             (1, RG_PROMPT + 1, 2568, torch.float32, True)]
    for i, (b, s, d, dt, with_h0) in enumerate(cases):
        a, u, h0 = scan_inputs(gen, dev, b, s, d, dt)
        h0 = h0 if with_h0 else None
        before = dict(krglru.ROUTES)
        got = krglru.rglru_scan(a, u, h0)
        route = kernel_route(krglru.ROUTES, before, "rglru_scan")
        want = ref.rglru_scan_ref(a, u, h0)
        mult = max(rglru_multiples(g, w).max().item()
                   for g, w in zip(got, want))
        err = max((g.float() - w.float()).abs().max().item()
                  for g, w in zip(got, want))
        equal = all(torch.equal(g, w) for g, w in zip(got, want))
        shape = (f"B={b} S={s} D={d} {str(dt)[6:]}"
                 f"{' h0' if with_h0 else ''}")
        print(f"rglru {shape} ({route}): max |err| {err:.4g}, max limit "
              f"multiple {mult:.3g} of {RGLRU_ATOL} + {RGLRU_RTOL:.4g}|plain|;"
              f" bit for bit: {equal}")
        if route != "tma":
            fail(f"rglru_scan {shape} took the {route} route")
        if not all(torch.isfinite(g.float()).all() for g in got) \
                or mult > 1 or not equal:
            fail(f"rglru_scan {shape}: kernel disagrees with its plain "
                 f"version")
        if i == 0:
            rglru_controls(a, u, h0, *want)
            rglru_plant_controls(a, u, h0, want, {
                "a ring stage consumed one phase early":
                    (ref.SCAN_PLANT_EARLY, 0),
                "one stage's store dropped": (ref.SCAN_PLANT_STORE, 0)})
        if i == 1:
            nbytes = 3 * a.numel() * a.element_size() \
                + b * d * a.element_size()
            row = entry(
                "rglru_scan", shape, err,
                time_ms(krglru.rglru_scan, [(a, u)]),
                time_ms(ref.rglru_scan_ref, [(a, u)], 2),
                bound(nbytes, 2 * a.numel(), torch.float32), None)
            row.update(
                kernel_route=route,
                earlier_ms=time_ms(
                    lambda *x: krglru._run(*x, None, "simt"), [(a, u)]),
                # One elementwise pass over the same bytes: a yardstick of
                # the bytes alone (no PyTorch call computes the recurrence).
                add_ms=time_ms(torch.add, [(a, u)]),
                ptxas=ptxas_entries("rglru_scan", "scan_tma"),
                smem_bytes=krglru.tma_tile(dt)["smem_bytes"])
            rows.append(row)
        if i == 2:
            rglru_plant_controls(a, u, h0, want, {
                "the carry run past S into the zero-filled tail":
                    (ref.SCAN_PLANT_TAIL, 1)})
        del a, u, h0, got, want
    return rows


def check_flash_mqa(gen, dev):
    """The flash forward at recurrentgemma's prefill shape: B 4, Hq 10,
    Hkv 1, S 4096, D 256, window 2048, bf16; timed against the plain
    version and scaled_dot_product_attention with the windowed mask.  One
    key more in a window of 2048 moves a row by about 1/2048 of its
    values, under the tolerance, so the planted fault 'the window one key
    too wide' is fed at window 8 (S 512) as well, where it must be
    caught."""
    dt = torch.bfloat16
    b, hq, s, d, window = RG_BATCH, 10, RG_PROMPT, 256, 2048
    rows = []
    for seq, win, timed in ((s, window, True), (512, 8, False)):
        q, k, v, _ = flash_inputs(gen, dev, hq, 1, seq=seq, b=b, d=d)
        out, lse = kflash.flash_attention_fwd(q, k, v, window=win)
        want, want_lse = ref.flash_attention_ref(q, k, v, window=win)
        mult = row_multiples(out, want)
        err = (out.float() - want.float()).abs().max().item()
        lse_err = (lse - want_lse).abs().max().item()
        wide_plain = ref.flash_attention_ref(q, k, v, window=win + 1)[0]
        effect = row_multiples(wide_plain, want)
        bad = row_multiples(
            kflash.flash_attention_fwd(q, k, v, window=win + 1)[0], want)
        must = effect > FAULT_MARGIN
        n_must, n_caught = int(must.sum()), int((bad[must] > 1).sum())
        print(f"flash MQA D={d} S={seq} window {win}: out max |err| "
              f"{err:.4g} (max limit multiple {mult.max().item():.3g}), lse "
              f"{lse_err:.3g}; control, window one key too wide: moves "
              f"{n_must} of {must.numel()} rows by > {FAULT_MARGIN} limits "
              f"(largest {effect.max().item():.3g}), the check fails "
              f"{n_caught} of them")
        del wide_plain, want_lse
        if not torch.isfinite(out.float()).all() or mult.max() > 1:
            fail(f"flash forward MQA D={d} window {win}: kernel disagrees "
                 f"with its plain version")
        if lse_err > 1e-2:
            fail(f"flash forward MQA D={d}: lse off by {lse_err:.3g}")
        if not timed and (n_must == 0 or n_caught < n_must):
            fail(f"flash control 'window one key too wide' at window {win} "
                 f"passes the check on a row it changes")
        if not timed:
            continue
        args = [(q, k, v)]
        mask = ref.flash_mask(seq, seq, causal=True, window=win, device=dev)

        def sdpa(q_, k_, v_):
            return F.scaled_dot_product_attention(
                q_, k_.expand(-1, hq, -1, -1), v_.expand(-1, hq, -1, -1),
                attn_mask=mask)

        pairs = visible_pairs(seq, seq, win, dev) * b * hq
        io = 2 * (2 * q.numel() + 2 * k.numel()) + 4 * b * hq * seq
        rows.append(entry(
            "flash_attention",
            f"B={b} Hq={hq} Hkv=1 S={seq} D={d} causal window={win} bf16",
            err, time_ms(lambda *a_: kflash.flash_attention_fwd(
                *a_, window=win), args),
            time_ms(lambda *a_: ref.flash_attention_ref(*a_, window=win),
                    args, 2),
            bound(io, 4 * d * pairs, dt), time_ms(sdpa, args, 5)))
        del out, want, args, mask
        torch.cuda.empty_cache()
    return rows


RG_KV_LENS = (1, 17, 100, 256, 511, 1024, 1777, 2048)


def split_controls(q, kc, vc, lens, want):
    """Planted faults fed to the split-KV decode over a full cache (every
    length Smax), each held against the plain version of the right
    inputs: one key changed in the last split only (position Smax - 1
    set to the sum of the g query rows, so every row weighs it heavily),
    and the first position of each split dropped (those positions cut out
    of the cache).  Each must fail the attention check on every (request,
    query head) row it moves by more than FAULT_MARGIN limits (measured on
    the plain version of the faulty inputs)."""
    b, hq, d = q.shape
    hkv, smax = kc.shape[1], kc.shape[2]
    splits = kdecode._splits(b, hkv, smax)
    chunk = -(-smax // splits)
    last = kc.clone()
    last[:, :, -1] = q.float().reshape(b, hkv, hq // hkv, d).sum(2).to(
        kc.dtype)
    keep = torch.tensor([p for p in range(smax) if p % chunk],
                        device=q.device)
    firsts = (lens[:, None] > torch.arange(0, smax, chunk,
                                           device=q.device)).sum(1)
    faults = {
        f"key at {smax - 1} (last of {splits} splits) changed":
            (q, last, vc, lens),
        f"first position of each of {splits} splits dropped":
            (q, kc[:, :, keep].contiguous(), vc[:, :, keep].contiguous(),
             (lens - firsts).to(lens.dtype)),
    }
    for name, args in faults.items():
        effect = limit_multiples(ref.decode_attention_ref(*args)
                                 .reshape(b * hq, d), want.reshape(b * hq, d),
                                 ATTN_ATOL, ATTN_RTOL)
        bad = limit_multiples(kdecode.decode_attention(*args)
                              .reshape(b * hq, d), want.reshape(b * hq, d),
                              ATTN_ATOL, ATTN_RTOL)
        must = effect > FAULT_MARGIN
        n_must, n_caught = int(must.sum()), int((bad[must] > 1).sum())
        print(f"decode MQA control, {name}: moves {n_must} of {b * hq} rows "
              f"by > {FAULT_MARGIN} limits; the check fails {n_caught} of "
              f"them (min multiple "
              f"{bad[must].min().item() if n_must else 0:.3g})")
        if n_must == 0 or n_caught < n_must:
            fail(f"decode MQA control '{name}' passes the attention "
                 f"tolerance on a row it moves")


def check_decode_mqa(gen, dev):
    """The contiguous decode kernel at recurrentgemma's decode shape: B 8,
    Hq 10, Hkv 1, D 256, Smax 2048 (the ring of a local layer), bf16,
    lengths 1..2048 checked; timed with every length 2048, as a decode
    step past the window reads it."""
    dt = torch.bfloat16
    b, hq, d, smax = 8, 10, 256, 2048
    q = torch.randn((b, hq, d), generator=gen, device=dev).to(dt)
    caches = [tuple(torch.randn((b, 1, smax, d), generator=gen,
                                device=dev).to(dt) for _ in range(2))
              for _ in range(copies(2 * b * smax * d * 2))]
    ragged = torch.tensor(RG_KV_LENS, dtype=torch.int32, device=dev)
    full = torch.full((b,), smax, dtype=torch.int32, device=dev)
    errs = []
    for lens in (ragged, full):
        got = kdecode.decode_attention(q, *caches[0], lens)
        want = ref.decode_attention_ref(q, *caches[0], lens)
        errs.append(compare(got, want, f"decode_attention MQA D={d}",
                            ATTN_ATOL, ATTN_RTOL))
        mult = limit_multiples(got, want, ATTN_ATOL, ATTN_RTOL)
        print(f"decode MQA D={d}, kernel vs plain: limit multiple by "
              f"kv_len {lens.tolist()}: {[round(x, 4) for x in mult.tolist()]}")
    split_controls(q, *caches[0], full, want)   # want: the full lengths
    args = [(q, kc, vc, full) for kc, vc in caches]
    mask = (torch.arange(smax, device=dev)[None, :]
            < full[:, None])[:, None, None, :]

    def sdpa(q_, k_, v_, _lens):
        return F.scaled_dot_product_attention(
            q_[:, :, None], k_.expand(-1, hq, -1, -1),
            v_.expand(-1, hq, -1, -1), attn_mask=mask)

    nbytes = 2 * 2 * b * hq * d + 2 * 2 * b * smax * d + 4 * b
    row = entry(
        "decode_attention",
        f"B={b} Hq={hq} Hkv=1 D={d} Smax={smax} kv_len={smax} bf16 "
        f"(checked also at {list(RG_KV_LENS)})",
        max(errs), time_ms(kdecode.decode_attention, args),
        time_ms(ref.decode_attention_ref, args),
        bound(nbytes, 4 * b * hq * smax * d, dt), time_ms(sdpa, args))
    row["paced_ms"] = time_ms(kdecode.decode_attention, args, paced=True)
    return [row]


#: (j)'s slice of the ring: B 2, Hq 10, Hkv 1, D 256, 1,024 slots a rank;
#: the lengths checked (0: a rank whose slice holds no position yet).
LSE_SLICE = (2, 10, 256, 1024)
LSE_LENS = ((0, 1), (513, 1024))
#: |lse - plain| of a row with a position (the kernel's __expf against
#: float32 exp, summed over up to 1,024 keys).
LSE_ATOL = 1e-4


def check_decode_lse(gen, dev):
    """The contiguous decode kernel's ``return_lse`` route at (j)'s slice
    (LSE_SLICE, bf16): the f32 output and the log-sum-exp against the plain
    version at the lengths of LSE_LENS, ``lse = -inf`` and ``out = 0`` at
    length 0; the merge (``context_parallel.fold``) of two 1,024-slot
    halves, each through the kernel at its rank's lengths, against the
    kernel over all 2,048 slots.  Timed at every length 1,024 beside the
    plain version and scaled_dot_product_attention on the same slice."""
    from repro_torch.distributed import context_parallel as cpar
    dt = torch.bfloat16
    b, hq, d, smax = LSE_SLICE
    q = torch.randn((b, hq, d), generator=gen, device=dev).to(dt)
    caches = [tuple(torch.randn((b, 1, smax, d), generator=gen,
                                device=dev).to(dt) for _ in range(2))
              for _ in range(copies(2 * b * smax * d * 2))]
    errs = []
    for lens in LSE_LENS:
        lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        out, lse = kdecode.decode_attention(q, *caches[0], lens,
                                            return_lse=True)
        want, want_lse = ref.decode_attention_ref(q, *caches[0], lens,
                                                  return_lse=True)
        empty = lens == 0
        if out.dtype != torch.float32 or lse.dtype != torch.float32 or \
                not torch.equal(torch.isinf(lse), empty[:, None].expand(
                    -1, hq)) or (lse[empty] != -math.inf).any() or \
                (out[empty] != 0).any():
            fail(f"decode lse: an empty row is not out 0, lse -inf, or a "
                 f"dtype is not f32 (lengths {lens.tolist()})")
        full = ~empty
        lse_err = (lse[full] - want_lse[full]).abs().max().item()
        if lse_err > LSE_ATOL:
            fail(f"decode lse: |lse - plain| {lse_err:.3g} > {LSE_ATOL}")
        errs.append(compare(out, want, "decode_attention lse", ATTN_ATOL,
                            ATTN_RTOL))
        print(f"decode lse at {tuple(LSE_SLICE)}, lengths {lens.tolist()}: "
              f"out max|err| {errs[-1]:.3g}, lse max|err| {lse_err:.3g}")
    # Two ranks' halves of a 2,048-slot ring against the whole.
    halves = (caches[0], caches[-1])
    whole = [torch.cat([h[i] for h in halves], 2) for i in range(2)]
    pos = torch.tensor([700, 3000], device=dev)
    valid = (pos + 1).clamp(max=2 * smax)
    lens = cpar.local_lengths(pos, 2 * smax, 2 * smax, 2).to(torch.int32)
    parts = [kdecode.decode_attention(q, *h, lens[r], return_lse=True)
             for r, h in enumerate(halves)]
    merged = cpar.fold([o for o, _ in parts], [l for _, l in parts])
    want, _ = kdecode.decode_attention(q, *whole, valid.to(torch.int32),
                                       return_lse=True)
    merge_err = compare(merged, want, "decode lse merge of two halves",
                        ATTN_ATOL, ATTN_RTOL)
    print(f"decode lse: the merge of two {smax}-slot halves against the "
          f"kernel over {2 * smax} slots at positions {pos.tolist()}: "
          f"max|err| {merge_err:.3g}")
    full = torch.full((b,), smax, dtype=torch.int32, device=dev)
    args = [(q, kc, vc, full) for kc, vc in caches]

    def lse_kernel(q_, k_, v_, lens_):
        return kdecode.decode_attention(q_, k_, v_, lens_, return_lse=True)

    def lse_plain(q_, k_, v_, lens_):
        return ref.decode_attention_ref(q_, k_, v_, lens_, return_lse=True)

    def sdpa(q_, k_, v_, _lens):
        return F.scaled_dot_product_attention(
            q_[:, :, None], k_.expand(-1, hq, -1, -1),
            v_.expand(-1, hq, -1, -1))

    nbytes = 2 * b * hq * d + 2 * 2 * b * smax * d + 4 * b * hq * (d + 1) \
        + 4 * b
    row = entry(
        "decode_attention",
        f"return_lse: B={b} Hq={hq} Hkv=1 D={d} Smax={smax} (a rank's slice "
        f"of a 2,048-slot ring) kv_len={smax} bf16 -> f32 out and lse "
        f"(checked also at {list(LSE_LENS)} and the merge of two halves)",
        max(errs + [merge_err]), time_ms(lse_kernel, args),
        time_ms(lse_plain, args),
        bound(nbytes, 4 * b * hq * smax * d, dt), time_ms(sdpa, args))
    row["kernel_route"] = "lse"
    row["paced_ms"] = time_ms(lse_kernel, args, paced=True)
    return [row]


def rg_launches(cfg, phase: str) -> dict:
    """Launches of one call: an rglru block makes 8 projections (w_in,
    w_gate, w_a, w_x, w_out and the MLP's 3), a local block 7; prefill
    runs one scan per rglru block and one flash forward per local block,
    a decode step one contiguous decode per local block; the head is one
    rmsnorm_gemm."""
    n_rglru = cfg.num_groups * cfg.block_pattern.count("rglru")
    n_local = cfg.num_groups * cfg.block_pattern.count("local")
    out = {"sma_gemm": 8 * n_rglru + 7 * n_local, "rmsnorm_gemm": 1}
    if phase == "prefill":
        out.update(rglru_scan=n_rglru, flash_attention=n_local)
    else:
        out["decode_attention"] = n_local
    return out


def rg_tokens(cfg, dev, shape, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, shape, generator=gen, device=dev)


def nonzero(counts: dict) -> dict:
    return {k: n for k, n in counts.items() if n}


def serve_recurrent(cfg, params, dev, launches, batch, prompt, new):
    """lm.prefill of ``batch`` x ``prompt`` tokens, then ``new`` greedy
    lm.decode_steps, at full width and depth.  Checks finite logits, the
    launches of every call (``launches(cfg, phase)``) and that nothing was
    routed; prints prefill ms, the median decode step, tokens/s and peak
    memory.  Returns the run's launch counts."""
    cache = prompt + 64
    toks = rg_tokens(cfg, dev, (batch, prompt), 0)
    # Warm-up (first launches, allocator): a short prompt and one step.
    logits, state, cl = lm.prefill(params, cfg, {"tokens": toks[:, :256]},
                                   cache_size=cache)
    lm.decode_step(params, state, cl, cfg,
                   {"tokens": logits.argmax(-1, keepdim=True)})
    del logits, state, cl
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    total = collections.Counter()
    ops.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state, cl = lm.prefill(params, cfg, {"tokens": toks},
                                   cache_size=cache)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    calls = [("prefill", ops.launch_counts(), dict(ops.ROUTED),
              nonzero(kgemm.ROUTES), logits)]
    flash_r = check_flash_routes(f"{cfg.name} prefill", calls[0][1])
    FLASH_ROUTES_BY_PATH[cfg.name] = flash_r
    # The heads (M = batch) on the tile kernel, every mLSTM on wgmma.
    kernel_routes = collections.defaultdict(collections.Counter)
    for name, got in check_kernel_routes(f"{cfg.name} prefill", calls[0][1],
                                         "tile").items():
        kernel_routes[name].update(got)
    steps, out_tokens = [], []
    for _ in range(new):
        nxt = logits.argmax(-1, keepdim=True)
        out_tokens.append(nxt)
        ops.reset_counts()
        t = time.perf_counter()
        logits, state, cl = lm.decode_step(params, state, cl, cfg,
                                           {"tokens": nxt})
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t)
        calls.append(("decode", ops.launch_counts(), dict(ops.ROUTED),
                      nonzero(kgemm.ROUTES), logits))
        for name, got in check_kernel_routes(
                f"{cfg.name} decode", calls[-1][1], "tile").items():
            kernel_routes[name].update(got)
    ROUTES_BY_PATH[cfg.name] = {k: dict(v) for k, v in kernel_routes.items()}
    peak = torch.cuda.max_memory_allocated()
    vpad = lm.padded_vocab(cfg)
    routes = collections.Counter()
    for i, (phase, counts, routed, gemm_routes, lg) in enumerate(calls):
        if lg.shape != (batch, vpad) or not torch.isfinite(lg).all():
            fail(f"{cfg.name} call {i} ({phase}): logits "
                 f"{tuple(lg.shape)} or non-finite")
        if nonzero(counts) != launches(cfg, phase) or routed:
            fail(f"{cfg.name} call {i} ({phase}): launches "
                 f"{nonzero(counts)}, expected {launches(cfg, phase)}; "
                 f"routed {routed}")
        want = {"prefill": "wgmma", "decode": "splitk"}[phase]
        if gemm_routes != {want: counts["sma_gemm"]}:
            fail(f"{cfg.name} call {i} ({phase}): sma_gemm routes "
                 f"{gemm_routes}, expected every launch on {want}")
        total.update(counts)
        routes.update(gemm_routes)
    if cl.tolist() != [prompt + new] * batch:
        fail(f"{cfg.name}: cache_len {cl.tolist()} after the run")
    toks_out = torch.cat(out_tokens, 1)
    step_ms = 1e3 * float(np.median(steps))
    n_params = sum(t.numel() for t in leaves(params))
    print(f"{cfg.name}: full width ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, vocab {vpad}, {n_params / 1e9:.3f} B "
          f"parameters), bf16, random weights; prefill {batch} x {prompt} "
          f"tokens in {1e3 * prefill_s:.2f} ms "
          f"({batch * prompt / prefill_s:.1f} tokens/s); {new} decode "
          f"steps, median {step_ms:.3f} ms (min {1e3 * min(steps):.3f}, "
          f"max {1e3 * max(steps):.3f}): {batch * new / sum(steps):.1f} "
          f"tokens/s; peak memory {peak / 2**30:.2f} GiB "
          f"(max_memory_allocated)")
    print(f"{cfg.name}: launches a prefill "
          f"{json.dumps(launches(cfg, 'prefill'))}, a decode step "
          f"{json.dumps(launches(cfg, 'decode'))}, as predicted; nothing "
          f"routed; sma_gemm routes {json.dumps(dict(routes))} (prefill "
          f"wgmma, decode split-K); the prefill's flash routes "
          f"{json.dumps(flash_r)}; rmsnorm_gemm, mlstm_chunkwise and "
          f"rglru_scan routes "
          f"{json.dumps(ROUTES_BY_PATH[cfg.name])}; row 0 tokens "
          f"{toks_out[0, :8].tolist()}")
    return dict(total), dict(routes)


# Planted faults of check_recurrent_logits, each one wrong launch: must
# the logit limit catch it?  A carry reset mid-sequence is forgotten
# within a few steps (a = exp(-8 softplus(lambda) r) is ~e^-4.8 with these
# weights) and one ring slot is 1 of 2048 keys: both are readings.
RG_FAULTS = {"rglru: carry reset at t = S/2": False,
             "rglru: h_seq one step late": True,
             "decode: oldest ring slot skipped": False,
             "decode: eff_len taken mod the window (1 slot read)": True}


@contextlib.contextmanager
def planted_recurrent(fault: str, pos: int, smax: int):
    """One wrong launch, made by feeding a kernel wrong inputs: the second
    scan of the prefill (the rglru layer just before the local layer) with
    its carry reset at S/2 or its h_seq shifted one step late, or the
    decode step's attention (which writes position ``pos`` into a full
    ring of ``smax`` slots) without the oldest slot or over
    ``(pos + 1) % smax`` slots.  Yields the call counts."""
    scan, attn = ops.rglru_scan, ops.decode_attention
    calls = {"scan": 0, "attn": 0}

    def wrong_scan(a, u, h0=None):
        calls["scan"] += 1
        if calls["scan"] != 2 or not fault.startswith("rglru"):
            return scan(a, u, h0)
        if "reset" in fault:
            half = a.shape[1] // 2
            s1, _ = scan(a[:, :half], u[:, :half], h0)
            s2, last = scan(a[:, half:], u[:, half:])
            return torch.cat([s1, s2], 1), last
        seq, last = scan(a, u, h0)
        return torch.cat([torch.zeros_like(seq[:, :1]), seq[:, :-1]], 1), last

    def wrong_attn(q, k_cache, v_cache, lens, **kw):
        calls["attn"] += 1
        if "oldest" in fault:
            keep = torch.tensor([i for i in range(smax)
                                 if i != (pos + 1) % smax], device=q.device)
            return attn(q, k_cache[:, :, keep], v_cache[:, :, keep],
                        lens - 1, **kw)
        if "mod the window" in fault:
            lens = torch.full_like(lens, (pos + 1) % smax)
        return attn(q, k_cache, v_cache, lens, **kw)

    ops.rglru_scan, ops.decode_attention = wrong_scan, wrong_attn
    try:
        yield calls
    finally:
        ops.rglru_scan, ops.decode_attention = scan, attn


def check_logits(cfg3, dev, prompt, launches, faults, planted, calls,
                 limit):
    """A 3-layer full-width model ``cfg3``: the prefill's last-position
    logits (B 2, ``prompt`` tokens) and one decode step's, through the
    kernels and through the plain versions; then each fault of ``faults``
    (name -> must it be caught) planted by ``planted(name)``, a context
    that yields its call counts, which must equal ``calls``.  The noise
    must lie under ``limit`` and the faults marked must above it."""
    params = lm.init(cfg3, seed=0, device=dev)
    b = 2
    toks = rg_tokens(cfg3, dev, (b, prompt), 1)
    nxt = rg_tokens(cfg3, dev, (b, 1), 2)
    tag = f"{cfg3.name} 3-layer logits"

    def run():
        logits, state, cl = lm.prefill(params, cfg3, {"tokens": toks},
                                       cache_size=prompt + 64)
        step = lm.decode_step(params, state, cl, cfg3, {"tokens": nxt})[0]
        return logits.float(), step.float()

    ops.reset_counts()
    got = run()
    counts = nonzero(ops.launch_counts())
    expect = collections.Counter(launches(cfg3, "prefill"))
    expect.update(launches(cfg3, "decode"))
    if counts != dict(expect):
        fail(f"{tag}: launches {counts}, expected {dict(expect)}")
    with plain_kernels():
        want = run()
    for name, g in zip(("prefill", "decode step"), got):
        if g.shape != (b, lm.padded_vocab(cfg3)) \
                or not torch.isfinite(g).all():
            fail(f"{tag}, {name}: shape {tuple(g.shape)} or non-finite")

    def readings(outs) -> list:
        return [(g - w).abs().max().item() for g, w in zip(outs, want)]

    noise = max(readings(got))
    agree = [int((g.argmax(-1) == w.argmax(-1)).sum())
             for g, w in zip(got, want)]
    print(f"{tag}, kernels vs plain versions: max |err| prefill "
          f"{readings(got)[0]:.4g}, decode step {readings(got)[1]:.4g} "
          f"(|logit| max {want[0].abs().max().item():.3g}); top-1 agree on "
          f"{agree} of {b} rows; limit {limit}")
    missed = []
    for fault, must in faults.items():
        with planted(fault) as made:
            r = readings(run())
        if made != calls:
            fail(f"{tag} control '{fault}': {made} launches, so the fault "
                 f"may have missed its target")
        print(f"{tag} control, {fault}: max |err| prefill {r[0]:.4g}, "
              f"decode step {r[1]:.4g} ({max(r) / limit:.3g} limits; "
              f"{'must be caught' if must else 'a reading'})")
        if must and max(r) <= limit:
            missed.append(fault)
    if noise > limit:
        fail(f"{tag}: max |err| {noise:.4g} > {limit}")
    if missed:
        fail(f"{tag}: planted faults within the limit: {missed}")


def check_recurrent_logits(cfg, dev):
    """check_logits for pattern (rglru, rglru, local) x 1 group, with
    RG_FAULTS."""
    cfg3 = dataclasses.replace(cfg, block_pattern=("rglru", "rglru", "local"),
                               num_groups=1)
    check_logits(cfg3, dev, RG_PROMPT, rg_launches, RG_FAULTS,
                 lambda f: planted_recurrent(f, RG_PROMPT, cfg3.window),
                 {"scan": 2, "attn": 1}, RG_LOGIT_ATOL)


def profile_serving(cfg, params, dev, batch, prompt, steps: int = 5):
    """torch.profiler over one full-width prefill of ``batch`` x ``prompt``
    tokens (device activity only: a CPU-side trace of xLSTM's ~270,000
    launches takes minutes to reduce, and the report reads device rows
    only) and over a few decode steps after it: device busy share and
    device time by kernel of each."""
    from torch.profiler import ProfilerActivity, profile
    toks = rg_tokens(cfg, dev, (batch, prompt), 3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        logits, state, cl = lm.prefill(params, cfg, {"tokens": toks},
                                       cache_size=prompt + 64)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report_profile(prof, wall, 1, f"{cfg.name} prefill")
    del prof
    nxt = {"tokens": logits.argmax(-1, keepdim=True)}
    lm.decode_step(params, state, cl, cfg, nxt)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            lm.decode_step(params, state, cl, cfg, nxt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report_profile(prof, wall, steps, f"{cfg.name} decode step")


# ---------------------------------------------------------------------------
# The xLSTM path: xlstm-1.3b through lm.prefill / lm.decode_step
# ---------------------------------------------------------------------------
def mlstm_inputs(gen, dev, b, h, s, d, dt):
    """q, k, v unit normals in ``dt`` (the projections' scale); the gates
    as the model makes them: log_i ~ N(0, 0.5), log_f = log_sigmoid(N(0,
    0.5) + the reference's forget bias linspace(3, 6) over the heads), so
    f is 0.95-0.998 and the state is remembered across chunks."""
    q, k, v = (torch.randn((b, h, s, d), generator=gen, device=dev).to(dt)
               for _ in range(3))
    bias = torch.linspace(3.0, 6.0, h, device=dev)[None, :, None]
    lf = F.logsigmoid(0.5 * torch.randn((b, h, s), generator=gen,
                                        device=dev) + bias)
    li = 0.5 * torch.randn((b, h, s), generator=gen, device=dev)
    return q, k, v, lf, li


def mlstm_multiples(got, want):
    atol, rtol = MLSTM_TOL[want.dtype]
    return ((got.float() - want.float()).abs()
            / (atol + rtol * want.float().abs()))


def state_errors(got, want) -> list:
    """max |err| / max |plain| of C, n and m."""
    return [((g - w).abs().max() / w.abs().max().clamp(min=1e-30)).item()
            for g, w in zip(got, want)]


def mlstm_flops(b, h, s, d, chunk) -> float:
    """Operations of the chunkwise function on this run's chunks: per
    chunk of l steps and (b, h), 2 d for each of the l (l + 1) / 2 causal
    (query, key) pairs in S = q k^T and again in (S . D) v; 2 l d^2 for q
    C0 (not on the first chunk, where C0 is zero) and for the state
    update."""
    L = min(chunk, s)
    lens = [min(L, s - t0) for t0 in range(0, s, L)]
    return b * h * (sum(2 * (l * l + l) * d + 4 * l * d * d for l in lens)
                    - 2 * lens[0] * d * d)


def mlstm_controls(ins, chunk, want, want_state):
    """Planted faults fed to the kernel, each held against the plain
    version of the right inputs: the state dropped at the chunk boundary
    nearest S/2 (the second half run on its own), one key dropped (a zero
    k row at the first chunk's last position, so the fault reaches every
    later chunk through the state) and the input gate one step late
    (log_i shifted by one).  Each must fail the h check on every element it
    moves by more than FAULT_MARGIN limits (measured on the plain version
    of the faulty inputs); the state readings are printed."""
    q, k, v, lf, li = ins
    s = q.shape[2]
    cut = (s // 2) // chunk * chunk

    def halves(fn):
        h1 = fn(q[:, :, :cut], k[:, :, :cut], v[:, :, :cut], lf[..., :cut],
                li[..., :cut], chunk=chunk)
        h2, st = fn(q[:, :, cut:], k[:, :, cut:], v[:, :, cut:],
                    lf[..., cut:], li[..., cut:], chunk=chunk,
                    return_state=True)
        return torch.cat([h1, h2], 2), st

    k_drop = k.clone()
    k_drop[:, :, chunk - 1] = 0
    late = torch.cat([li[..., :1], li[..., :-1]], -1)
    faults = {
        f"state dropped at t={cut}": halves,
        f"key at t={chunk - 1} dropped": lambda fn: fn(
            q, k_drop, v, lf, li, chunk=chunk, return_state=True),
        "input gate one step late": lambda fn: fn(
            q, k, v, lf, late, chunk=chunk, return_state=True),
    }
    for name, run in faults.items():
        effect_h = run(ref.mlstm_chunkwise_ref)[0]
        bad_h, bad_state = run(kmlstm.mlstm_chunkwise)
        effect = mlstm_multiples(effect_h, want)
        bad = mlstm_multiples(bad_h, want)
        must = effect > FAULT_MARGIN
        n_must, n_caught = int(must.sum()), int((bad[must] > 1).sum())
        st = state_errors(bad_state, want_state)
        print(f"mlstm control, {name}: moves {n_must} of {must.numel()} h "
              f"elements by > {FAULT_MARGIN} limits; the check fails "
              f"{n_caught} of them; state C, n, m off by "
              f"{[float(f'{x:.3g}') for x in st]} of max |plain| (limit "
              f"{MLSTM_STATE_LIMIT})")
        if n_must == 0 or n_caught < n_must:
            fail(f"mlstm control '{name}' passes the check where it moves "
                 f"the output")
        del effect_h, bad_h, bad_state, effect, bad, must


def mlstm_plant_controls(ins, chunk, want, want_state):
    """Planted faults inside the wgmma kernels (``kmlstm._run`` with a
    ``ref.PLANT_*`` mask), each held against the plain version of the
    right inputs: the lo half of the state update dropped must fail the
    state check; C_k handed to the outputs of chunk nc // 2 one chunk late,
    and that chunk's S . D row sums dropped, must fail the h check on
    every element they move by more than FAULT_MARGIN limits (measured on
    ``ref.mlstm_chunkwise_two_pass_ref`` with the same fault).  C_k handed
    to the outputs as its hi half alone (what would halve the hand-off's
    bytes) must fail the h check: a design question more than a fault, and
    its effect is rounding-sensitive where a row's denominator cancels, so
    it is held as a whole, with its count printed."""
    q, k, v, lf, li = ins
    s = q.shape[2]
    L = min(chunk, s)
    cf = -(-s // L) // 2
    faults = {"lo half of the state update dropped": ref.PLANT_LO,
              f"C_k handed to chunk {cf}'s outputs one chunk late":
                  ref.PLANT_LATE,
              f"chunk {cf}'s S . D row sums dropped": ref.PLANT_ROWSUM,
              "C_k handed to the outputs as its hi half alone":
                  ref.PLANT_CK_HI}
    for name, plant in faults.items():
        bad_h, *bad_state = kmlstm._run(q, k, v, lf.float(), li.float(), L,
                                        "wgmma", plant=plant)
        st = state_errors(bad_state, want_state)
        bad = mlstm_multiples(bad_h, want)
        if plant == ref.PLANT_LO:
            print(f"mlstm control, {name}: state C, n, m off by "
                  f"{[float(f'{x:.3g}') for x in st]} of max |plain| "
                  f"({st[0] / MLSTM_STATE_LIMIT:.3g} limits); h max limit "
                  f"multiple {bad.max().item():.3g}")
            if st[0] <= MLSTM_STATE_LIMIT:
                fail(f"mlstm control '{name}' passes the state check")
            continue
        if plant == ref.PLANT_CK_HI:
            over = int((bad > 1).sum())
            print(f"mlstm control, {name}: the h check fails {over} of "
                  f"{bad.numel()} elements (max limit multiple "
                  f"{bad.max().item():.3g})")
            if over == 0:
                fail(f"mlstm control '{name}' passes the h check")
            continue
        effect = mlstm_multiples(ref.mlstm_chunkwise_two_pass_ref(
            *ins, chunk=chunk, plant=plant), want)
        must = effect > FAULT_MARGIN
        n_must, n_caught = int(must.sum()), int((bad[must] > 1).sum())
        print(f"mlstm control, {name}: moves {n_must} of {must.numel()} h "
              f"elements by > {FAULT_MARGIN} limits; the check fails "
              f"{n_caught} of them (min multiple "
              f"{bad[must].min().item() if n_must else 0:.3g})")
        if n_must == 0 or n_caught < n_must:
            fail(f"mlstm control '{name}' passes the check where it moves "
                 f"the output")
        del effect, must
    del bad_h, bad_state, bad


def check_mlstm(gen, dev):
    """The chunkwise mLSTM kernels against their plain version, h and the
    final (C, n, m): at the prefill's shape (B 4, H 4, S 2048, D 1024,
    chunk 128, bf16) and at a ragged S 2000 on the wgmma route, and at a
    small head dim (B 2, H 4, S 1000, D 64, f32) on the simt route; the
    planted faults on the first, which is timed with its bound, beside the
    simt kernel on the same inputs (the earlier design)."""
    rows = []
    chunk = MLSTM_CHUNK
    for i, (b, h, s, d, dt) in enumerate(MLSTM_CASES):
        ins = mlstm_inputs(gen, dev, b, h, s, d, dt)
        before = dict(kmlstm.ROUTES)
        got, state = kmlstm.mlstm_chunkwise(*ins, chunk=chunk,
                                            return_state=True)
        route = kernel_route(kmlstm.ROUTES, before, "mlstm_chunkwise")
        want, want_state = ref.mlstm_chunkwise_ref(*ins, chunk=chunk,
                                                   return_state=True)
        mult = mlstm_multiples(got, want).max().item()
        err = (got.float() - want.float()).abs().max().item()
        st = state_errors(state, want_state)
        shape = f"B={b} H={h} S={s} D={d} chunk={chunk} {str(dt)[6:]}"
        print(f"mlstm {shape} ({route}): h max |err| {err:.4g} (max limit "
              f"multiple {mult:.3g} of {MLSTM_TOL[dt][0]} + "
              f"{MLSTM_TOL[dt][1]:.4g}|plain|); "
              f"state C, n, m off by {[float(f'{x:.3g}') for x in st]} of "
              f"max |plain| (limit {MLSTM_STATE_LIMIT})")
        if route != ("simt" if dt == torch.float32 else "wgmma"):
            fail(f"mlstm_chunkwise {shape} took the {route} route")
        if not torch.isfinite(got.float()).all() or mult > 1 \
                or max(st) > MLSTM_STATE_LIMIT:
            fail(f"mlstm_chunkwise {shape}: kernel disagrees with its plain "
                 f"version")
        if i == 0:
            mlstm_controls(ins, chunk, want, want_state)
            mlstm_plant_controls(ins, chunk, want, want_state)
            q = ins[0]
            nbytes = (4 * q.numel() * q.element_size() + 2 * 4 * b * h * s
                      + 4 * b * h * (d * d + d + 1))

            def run(*a):
                return kmlstm.mlstm_chunkwise(*a, chunk=chunk,
                                              return_state=True)

            def simt(q_, k_, v_, lf_, li_):
                return kmlstm._run(q_, k_, v_, lf_, li_, chunk, "simt")

            def plain(*a):
                return ref.mlstm_chunkwise_ref(*a, chunk=chunk,
                                               return_state=True)

            row = entry("mlstm_chunkwise", shape + " with state", err,
                        time_ms(run, [ins], 10), time_ms(plain, [ins], 3),
                        bound(nbytes, mlstm_flops(b, h, s, d, chunk), dt),
                        None)
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            run(*ins)
            row.update(kernel_route=route,
                       earlier_ms=time_ms(simt, [ins], 3),
                       scratch_peak_bytes=torch.cuda.max_memory_allocated()
                       - base,
                       ptxas=ptxas_entries("mlstm_chunkwise", "mlstm_wg"),
                       smem_bytes=kmlstm.wgmma_smem())
            rows.append(row)
        del ins, got, state, want, want_state
        torch.cuda.empty_cache()
    return rows


def xl_launches(cfg, phase: str) -> dict:
    """Launches of one call: an mLSTM layer makes 6 products (w_up, w_q,
    w_k, w_v, w_if, w_down), an sLSTM layer 3 (w_gates, w_ff1, w_ff2);
    prefill runs one chunkwise kernel per mLSTM layer, a decode step none
    (its one-step recurrence is plain tensor ops, as in the reference); the
    head is one rmsnorm_gemm."""
    n_m = cfg.num_groups * cfg.block_pattern.count("mlstm")
    n_s = cfg.num_groups * cfg.block_pattern.count("slstm")
    out = {"sma_gemm": 6 * n_m + 3 * n_s, "rmsnorm_gemm": 1}
    if phase == "prefill":
        out["mlstm_chunkwise"] = n_m
    return out


# Planted faults of check_xlstm_logits, each one wrong launch (the first
# mLSTM layer's prefill): must the logit limit catch it?  With forget
# gates of 0.95-0.998 a state dropped 128 steps before the end is still
# mostly remembered; one dropped 1,024 steps before has decayed to a few
# per cent in the slowest head, so that one is a reading.
XL_FAULTS = {"mlstm: state dropped at the last chunk boundary": True,
             "mlstm: state dropped at S/2": False,
             "mlstm: input gate one step late": True,
             "mlstm: final state one chunk early": True}


@contextlib.contextmanager
def planted_xlstm(fault: str):
    """One wrong launch, made by feeding the kernel wrong inputs: the first
    mLSTM layer's prefill with its state dropped at the last chunk
    boundary or at S/2 (the rest run on its own), with log_i one step
    late, or returning the state of one chunk before the end as its final
    state.  Yields the call count."""
    mlstm = ops.mlstm_chunkwise
    calls = {"mlstm": 0}

    def wrong(q, k, v, lf, li, *, chunk, return_state=False):
        calls["mlstm"] += 1
        if calls["mlstm"] != 1:
            return mlstm(q, k, v, lf, li, chunk=chunk,
                         return_state=return_state)
        s = q.shape[2]
        cut = s // 2 if "S/2" in fault else s - chunk

        def part(lo, hi, state):
            return mlstm(q[:, :, lo:hi], k[:, :, lo:hi], v[:, :, lo:hi],
                         lf[..., lo:hi], li[..., lo:hi], chunk=chunk,
                         return_state=state)

        if "late" in fault:
            li = torch.cat([li[..., :1], li[..., :-1]], -1)
            h, st = mlstm(q, k, v, lf, li, chunk=chunk, return_state=True)
        elif "dropped" in fault:
            h2, st = part(cut, s, True)
            h = torch.cat([part(0, cut, False), h2], 2)
        else:
            h = mlstm(q, k, v, lf, li, chunk=chunk)
            st = part(0, cut, True)[1]
        return (h, st) if return_state else h

    ops.mlstm_chunkwise = wrong
    try:
        yield calls
    finally:
        ops.mlstm_chunkwise = mlstm


def check_xlstm_logits(cfg, dev):
    """check_logits for pattern (mlstm, mlstm, slstm) x 1 group, with
    XL_FAULTS."""
    cfg3 = dataclasses.replace(cfg, block_pattern=("mlstm", "mlstm",
                                                   "slstm"), num_groups=1)
    check_logits(cfg3, dev, XL_PROMPT, xl_launches, XL_FAULTS, planted_xlstm,
                 {"mlstm": 2}, XL_LOGIT_ATOL)


def profile_xlstm(cfg, params, dev):
    """The host time of one sLSTM block over the prompt (its step loop is
    2,048 steps of small launches) against a whole prefill, then
    profile_serving."""
    toks = rg_tokens(cfg, dev, (XL_BATCH, XL_PROMPT), 3)
    p = cfg.block_pattern.index("slstm")
    mixer = lm.unstack(params["blocks"][p]["mixer"], cfg.num_groups)[0]
    x = torch.randn((XL_BATCH, XL_PROMPT, cfg.d_model), device=dev).to(
        cfg.activation_dtype)
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recurrent.slstm_block_prefill(mixer, x, cfg)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    n_s = cfg.num_groups * cfg.block_pattern.count("slstm")
    t0 = time.perf_counter()
    lm.prefill(params, cfg, {"tokens": toks}, cache_size=XL_PROMPT + 64)
    torch.cuda.synchronize()
    whole = time.perf_counter() - t0
    print(f"xlstm: one sLSTM block over {XL_BATCH} x {XL_PROMPT} tokens "
          f"{1e3 * walls[-1]:.2f} ms host wall; x {n_s} layers = "
          f"{1e3 * n_s * walls[-1]:.1f} ms of a {1e3 * whole:.1f} ms prefill "
          f"({100 * n_s * walls[-1] / whole:.1f}%)")
    del x
    profile_serving(cfg, params, dev, XL_BATCH, XL_PROMPT)


# ---------------------------------------------------------------------------
# The recurrent families through the compiled ServeEngine
# ---------------------------------------------------------------------------
# Each prefill chunk of a recurrent layer runs token by token through the
# layer's decode step, as one loop node of the compiled graph.  4 requests
# of 64-256-token prompts arrive one a tick; chunk 64, 16 new tokens each,
# greedy, 4 rows.
RECURRENT_BLOCKS = ("rglru", "mlstm", "slstm")
ENGINE_ROWS, ENGINE_CHUNK, ENGINE_NEW = 4, 64, 16
ENGINE_ARRIVALS = (0, 1, 2, 3)
ENGINE_CACHE = CacheConfig(block_size=16, num_blocks=128, max_seq_len=512)
# The 3-layer served-logits check: B 2, a 256-token prompt in chunks of 64,
# then one decode step.
ENGINE_LOGIT_PROMPT = 256
# Planted faults of check_served_logits, each a product that skips its
# last 64-wide K tile on every call with one weight (the named block
# type's first layer): must the logit limit catch it?  One K tile of the
# local layer's wo (1 of 40, the 3-layer model's last layer) moves the
# logits by 0.074 on an H100 (PERF.md): a reading.
RG_ENGINE_FAULTS = {("rglru", "w_out"): True, ("rglru", "w_in"): True,
                    ("rglru", "w_x"): True, ("local", "wo"): False}
XL_ENGINE_FAULTS = {("mlstm", "w_down"): True, ("mlstm", "w_k"): True,
                    ("slstm", "w_ff2"): True}
PLANT_K_TILE = 64


def engine_requests(cfg):
    """The engine runs' requests (prompts of 64-256 tokens, seed 0)."""
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 257, size=ENGINE_ROWS)
    return lens, [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                                     size=n).astype(np.int32),
                          max_new_tokens=ENGINE_NEW)
                  for i, n in enumerate(lens)]


def engine_pass(eng, reqs, on_tick=None) -> float:
    """Submit ``reqs[i]`` at tick ``ENGINE_ARRIVALS[i]`` and step the engine
    until they drain, with ``on_tick()`` after each step; the host wall to
    the card's last work."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tick = 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        while tick <= max(ENGINE_ARRIVALS) or eng.queue or eng.active:
            for r, at in zip(reqs, ENGINE_ARRIVALS):
                if at == tick:
                    eng.submit(r)
            eng.step()
            tick += 1
            if on_tick is not None:
                on_tick()
            if tick > 2000:
                fail("engine pass: the engine did not drain")
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def recurrent_layers(cfg) -> dict:
    """Layers by block type."""
    return {b: cfg.num_groups * cfg.block_pattern.count(b)
            for b in set(cfg.block_pattern)}


def engine_tick_launches(cfg, phase: str) -> dict:
    """Launches of one engine tick.  An rglru layer makes 5 products a
    token in its loop (w_in, w_gate, w_a, w_x, w_out) and the MLP's 3 once,
    a local layer 7, an mLSTM layer 6 a token (w_up, w_q, w_k, w_v, w_if,
    w_down), an sLSTM layer 3 a token (w_gates, w_ff1, w_ff2); a prefill
    tick runs ENGINE_CHUNK tokens, a decode tick 1; the head is one
    rmsnorm_gemm.  A decode tick's mLSTM ``norm1 -> w_up`` is one
    rmsnorm_gemm (:func:`fused_prologues`), compiled and direct.  Every paged attention site is
    routed to its plain version (windowed, or a chunk), so none launches
    its kernel."""
    n = collections.Counter(recurrent_layers(cfg))
    t = ENGINE_CHUNK if phase == "prefill" else 1
    gemm = (n["rglru"] * (5 * t + 3) + n["local"] * 7
            + n["mlstm"] * 6 * t + n["slstm"] * 3 * t)
    fused = fused_prologues(cfg, phase)
    return {"sma_gemm": gemm - fused, "rmsnorm_gemm": 1 + fused}


def fused_prologues(cfg, phase: str) -> int:
    """Prologue sites the rewrite makes besides the head, by the
    reference's rule (a norm whose output feeds one product alone), and
    the direct paged decode step runs as such: in a decode tick each mLSTM
    layer's norm1 feeds only w_up; an sLSTM's w_gates takes a bias, an
    rglru's norm1 feeds two products, an attention layer's three, and in a
    prefill tick the norm's output enters the token loop."""
    return (cfg.num_groups * cfg.block_pattern.count("mlstm")
            if phase == "decode" else 0)


def engine_reports(eng) -> list:
    """(phase, bucket, plan report) of every cached signature, as compiled
    (``report_data``: reading ``report`` would restamp its ``runtime``
    section from the whole profile window, quadratic in its spans)."""
    return sorted(((phase, key[1][-1][0][0], entry.compiled.report_data)
                   for phase, e in eng.engines.items()
                   for key, entry in e._cache.items()), key=lambda r: r[:2])


def serve_recurrent_engine(cfg, params, dev, path: str):
    """The engine run: a warm-up pass under ``repro_torch.profile``
    compiles every (phase, bucket) signature (compile s, graph nodes, loop
    nodes and body nodes printed) and its tick spans must count the
    scheduler's mode switches; ``reset()`` keeps the signatures and the
    timed pass compiles nothing.  No pass may fail a tick, evict or fail a
    request.  Checks every request's tokens, the launches of every tick
    (``engine_tick_launches``) and the routes, and that the routed calls
    are the windowed sites' once a tick.  Returns (launches, sma_gemm
    routes, the engine, the timed pass's tokens, sma_gemm launches before
    each tick)."""
    sched = SchedulerConfig(policy="sma", prefill_chunk=ENGINE_CHUNK)
    eng = ServeEngine(cfg, params, cache=ENGINE_CACHE,
                      max_batch=ENGINE_ROWS, sched=sched, device=dev)
    layers = recurrent_layers(cfg)
    n_loops = sum(n for b, n in layers.items() if b in RECURRENT_BLOCKS)
    before = counters()
    warm_reqs = engine_requests(cfg)[1]
    with obs.profile(sync=False) as prof:
        warm = engine_pass(eng, warm_reqs)
    clean_serving(f"{path} warm-up pass", before, warm_reqs)
    tick_spans = [e for e in prof.events if e["cat"] == "serve"]
    sec = obs.runtime_section(tick_spans)
    print(f"{path} warm-up pass (compiles included, under "
          f"repro_torch.profile): {warm:.3f} s; tick spans: "
          f"{len(tick_spans)} ticks, mode_switches {sec['mode_switches']} "
          f"(scheduler {eng.sched.switches}); "
          f"{sum(e['name'] == 'dispatch.loop' for e in prof.events)} loop "
          f"spans")
    if sec["mode_switches"] != eng.sched.switches \
            or len(tick_spans) != eng.sched.ticks:
        fail(f"{path}: the tick spans count {sec['mode_switches']} mode "
             f"switches over {len(tick_spans)} ticks, the scheduler "
             f"{eng.sched.switches} over {eng.sched.ticks}")
    print(f"{path}: compile s and graph nodes per (phase, bucket): "
          + ", ".join(f"{p} {b}: {t:.3f} s {n}"
                      for p, b, t, n in compile_table(eng)))
    for phase, bucket, rep in engine_reports(eng):
        disp, low = rep["dispatch"], rep["lowering"]
        bodies = {name: (b["nodes"], b["loops"], b["trip_counts"],
                         b["systolic_dispatch_sites"])
                  for name, b in disp["loop_bodies"].items()}
        print(f"{path} {phase} {bucket}: {disp['loop_nodes']} loop nodes, "
              f"bodies (nodes, loop nodes, trip counts, GEMM sites) "
              f"{json.dumps(bodies)}; lowering {low['unrolled_scans']} "
              f"unrolled, {low['coarsened_scans']} coarsened; compile "
              f"{json.dumps({k: round(v, 3) for k, v in rep['compile'].items()})}")
        want = n_loops if phase == "prefill" else 0
        kinds = {f"{b}_block_decode" for b in layers
                 if b in RECURRENT_BLOCKS} if phase == "prefill" else set()
        if disp["loop_nodes"] != want or set(bodies) != kinds \
                or low["coarsened_scans"] != want:
            fail(f"{path} {phase} {bucket}: {disp['loop_nodes']} loop nodes "
                 f"over bodies {sorted(bodies)}, {low['coarsened_scans']} "
                 f"coarsened; expected {want} over {sorted(kinds)}")
        prologues = rep["fusion"]["realized_prologue_sites"]
        if prologues != 1 + fused_prologues(cfg, phase):
            fail(f"{path} {phase} {bucket}: {prologues} prologue sites, "
                 f"expected the head and {fused_prologues(cfg, phase)}")
    eng.reset()
    misses = {p: e.stats.misses for p, e in eng.engines.items()}

    lens, reqs = engine_requests(cfg)
    before = counters()
    marks = []                       # sma_gemm launches before each tick

    def mark():
        if len(eng.tick_log) > len(marks) - 1:
            marks.append(ops.launch_counts()["sma_gemm"])

    ops.reset_counts()
    marks.append(0)
    torch.cuda.reset_peak_memory_stats()
    wall = engine_pass(eng, reqs, on_tick=mark)
    peak = torch.cuda.max_memory_allocated()
    counts, routed = nonzero(ops.launch_counts()), dict(ops.ROUTED)
    routes = nonzero(kgemm.ROUTES)
    clean_serving(f"{path} timed pass", before, reqs)
    ROUTES_BY_PATH[path] = check_kernel_routes(path, counts, "tile")
    new = {p: e.stats.misses - misses[p] for p, e in eng.engines.items()}
    if any(new.values()):
        fail(f"{path}: the timed pass compiled {new} signatures after the "
             f"warm-up pass")
    for r in reqs:
        if r.status != "done" or len(r.out_tokens) != ENGINE_NEW:
            fail(f"{path} request {r.rid}: {r.status} with "
                 f"{len(r.out_tokens or [])} tokens ({r.error})")
        if not all(0 <= t < lm.padded_vocab(cfg) for t in r.out_tokens):
            fail(f"{path} request {r.rid}: token out of range")
    per_tick = [b - a for a, b in zip(marks, marks[1:])]
    expect = collections.Counter()
    for (phase, _, _), got in zip(eng.tick_log, per_tick):
        one = engine_tick_launches(cfg, phase)
        if got != one["sma_gemm"]:
            fail(f"{path} {phase} tick: {got} sma_gemm launches, expected "
                 f"{one['sma_gemm']}")
        expect.update(one)
    if counts != dict(expect):
        fail(f"{path}: launches {counts}, expected {dict(expect)}")
    windowed = layers.get("local", 0) + layers.get("attn", 0)
    if sum(routed.values()) != windowed * len(eng.tick_log):
        fail(f"{path}: routed {routed}, expected {windowed} windowed or "
             f"chunked paged sites x {len(eng.tick_log)} ticks")
    if routes.get("tile") or routes.get("f32"):
        fail(f"{path}: sma_gemm routes {routes}, expected wgmma and split-K "
             f"only")
    ticks = {p: [s for ph, _, s in eng.tick_log if ph == p]
             for p in ("prefill", "decode")}
    ttft = [r.t_first - r.t_submit for r in reqs]
    tokens = sum(len(r.out_tokens) for r in reqs)
    print(f"{path} (compiled): {len(reqs)} requests, prompts "
          f"{lens.tolist()} arriving at ticks {list(ENGINE_ARRIVALS)}, "
          f"{tokens} tokens in {wall:.3f} s: {tokens / wall:.2f} tokens/s "
          f"(wall clock, bf16, {cfg.name} full width and depth, random "
          f"weights); peak memory {peak / 2**30:.2f} GiB "
          f"(max_memory_allocated)")
    print(f"{path}: TTFT mean {np.mean(ttft):.3f} s, max {max(ttft):.3f} s; "
          f"prefill tick mean {1e3 * np.mean(ticks['prefill']):.1f} ms over "
          f"{len(ticks['prefill'])} ticks (rows "
          f"{[n for p, n, _ in eng.tick_log if p == 'prefill']}); decode "
          f"tick mean {1e3 * np.mean(ticks['decode']):.2f} ms, median "
          f"{1e3 * np.median(ticks['decode']):.2f} ms over "
          f"{len(ticks['decode'])} ticks; switches {eng.sched.switches}")
    print(f"{path}: launches {json.dumps(counts)}; a prefill tick "
          f"{json.dumps(engine_tick_launches(cfg, 'prefill'))}, a decode "
          f"tick {json.dumps(engine_tick_launches(cfg, 'decode'))}, as "
          f"predicted; routed to plain by design {json.dumps(routed)} "
          f"({windowed} sites x {len(eng.tick_log)} ticks); sma_gemm routes "
          f"{json.dumps(routes)}; rmsnorm_gemm routes "
          f"{json.dumps(ROUTES_BY_PATH[path]['rmsnorm_gemm'])}")
    want = {r.rid: list(r.out_tokens) for r in reqs}
    return counts, routes, eng, want, marks


def engine_retry(cfg, eng, want: dict, marks: list, path: str):
    """``sma_gemm@cuda:runtime_error:times=1,after=N``, N halfway through
    the first prefill tick with more than one row (inside a recurrent
    layer's token loop): one tick failure, the tick retried whole from the
    untouched recurrent state, the timed pass's tokens."""
    tick = next(i for i, (p, rows, _) in enumerate(eng.tick_log)
                if p == "prefill" and rows > 1)
    after = (marks[tick] + marks[tick + 1]) // 2
    eng.reset()
    misses = {p: e.stats.misses for p, e in eng.engines.items()}
    before = counters()
    reqs = engine_requests(cfg)[1]
    spec = f"sma_gemm@cuda:runtime_error:times=1,after={after}"
    with faults.inject_faults(spec) as (fault,):
        wall = engine_pass(eng, reqs)
    moved = moved_since(before)
    got = {r.rid: list(r.out_tokens or []) for r in reqs}
    print(f"{path} retry: {spec} (prefill tick {tick}, "
          f"{eng.tick_log[tick][1]} rows: launches {marks[tick]} to "
          f"{marks[tick + 1]}): fired {fault._fired}, counters "
          f"{json.dumps(moved)}, tokens equal the timed pass's: "
          f"{got == want}; {wall:.3f} s")
    if fault._fired != 1 or moved["serve.tick_failures"] != 1 \
            or moved["serve.evictions"] or moved["serve.requests_failed"]:
        fail(f"{path} retry: fired {fault._fired}, counters {moved}")
    if got != want:
        fail(f"{path} retry: the retried tokens differ from the unfaulted "
             f"pass's")
    if {p: e.stats.misses for p, e in eng.engines.items()} != misses:
        fail(f"{path} retry: a signature compiled")
    eng.reset()


def check_compiled_recurrent(cfg, params, dev, eng, path: str):
    """The engine's compiled prefill tick (4 rows, ragged chunks) and two
    decode ticks against the direct steps on the same inputs: logits,
    lengths and every state leaf (the pools' real blocks, the recurrent
    entries) ``torch.equal``, each tick's launches, routes and routed calls
    equal.  Then, as a reading, the direct steps through the plain
    versions: how far the same calls move the logits when every product
    rounds differently (a full-width xLSTM's move by units, so only the
    same launches can agree, PERF.md)."""
    kv = PagedKVCache(ENGINE_CACHE, ENGINE_ROWS)
    c = ENGINE_CHUNK
    n_tok = [c, c * 5 // 8, c // 4 + 1, 1]
    for r in range(ENGINE_ROWS):
        kv.admit(r, 200, ENGINE_NEW)
    table = torch.as_tensor(kv.table_rows(list(range(ENGINE_ROWS))),
                            device=dev)
    toks = rg_tokens(cfg, dev, (ENGINE_ROWS, c), 5).to(torch.int32)
    n_tok = torch.tensor(n_tok, dtype=torch.int32, device=dev)
    zero = torch.zeros(ENGINE_ROWS, dtype=torch.int32, device=dev)
    direct = (lambda p, s, bt, cl, nt, b: smodel.paged_prefill_step(
                  p, s, bt, cl, nt, cfg, b),
              lambda p, s, bt, cl, b: smodel.paged_decode_step(
                  p, s, bt, cl, cfg, b))
    nb = ENGINE_CACHE.num_blocks

    def snapshot(state):
        return [(v[:, :nb] if k in ("k", "v") else v).clone()
                for e in state for k, v in e.items()]

    def run(prefill, decode):
        state = smodel.init_state(cfg, ENGINE_ROWS, ENGINE_CACHE, device=dev)
        out = []
        (logits, state, cl), *seen = counted_run(lambda: prefill(
            params, state, table, zero, n_tok, {"tokens": toks}))
        out.append((logits, cl, seen, snapshot(state)))
        for _ in range(2):
            nxt = logits.argmax(-1, keepdim=True).to(torch.int32)
            cl = cl.to(torch.int32)
            (logits, state, cl), *seen = counted_run(
                lambda: decode(params, state, table, cl, {"tokens": nxt}))
            out.append((logits, cl, seen, snapshot(state)))
        return out

    t0 = time.perf_counter()
    got = run(eng.engines["prefill"], eng.engines["decode"])
    t1 = time.perf_counter()
    want = run(*direct)
    t2 = time.perf_counter()
    with plain_kernels():
        plain = run(*direct)
    moved = [(w[0].float() - p[0].float()).abs().max().item()
             for w, p in zip(want, plain)]
    for i, ((gl, gc, gs, gst), (wl, wc, ws, wst)) in enumerate(
            zip(got, want)):
        bad = [j for j, (g, w) in enumerate(zip(gst, wst))
               if not torch.equal(g, w)]
        if not (torch.equal(gl, wl) and torch.equal(gc, wc)) or bad:
            fail(f"{path} compiled call {i}: logits (max |err| "
                 f"{(gl.float() - wl.float()).abs().max().item():.4g}), "
                 f"lengths or state leaves {bad} differ from the direct "
                 f"step's")
        if gs != ws:
            fail(f"{path} compiled call {i}: launches, routes, routed "
                 f"{gs}; direct {ws}")
    print(f"{path}: compiled prefill (4 rows, n_tokens {n_tok.tolist()}, "
          f"chunk {c}) and 2 decode ticks torch.equal the direct steps: "
          f"logits, lengths and {len(got[0][3])} state leaves; launches a "
          f"call {json.dumps([s[0] for _, _, s, _ in got])}, as direct; "
          f"{t1 - t0:.3f} s compiled, {t2 - t1:.3f} s direct")
    print(f"{path}: the direct steps through the plain versions move the "
          f"logits by max |err| {[round(m, 4) for m in moved]} (prefill, "
          f"decode, decode; |logit| max "
          f"{want[0][0].float().abs().max().item():.3g}): a reading")


@contextlib.contextmanager
def planted_served(params, cfg, fault):
    """``fault`` = (block type, weight): every ``sma_gemm`` call with that
    weight of the block type's first layer skips its last ``PLANT_K_TILE``
    rows of K (a 64-wide K tile).
    Yields the call count."""
    p = cfg.block_pattern.index(fault[0])
    target = params["blocks"][p]["mixer"][fault[1]][0].data_ptr()
    gemm = ops.sma_gemm
    calls = {"gemm": 0}

    def wrong(a, w, **kw):
        if w.data_ptr() != target:
            return gemm(a, w, **kw)
        calls["gemm"] += 1
        k = w.shape[0] - PLANT_K_TILE
        return gemm(a[..., :k].contiguous(), w[:k], **kw)

    ops.sma_gemm = wrong
    try:
        yield calls
    finally:
        ops.sma_gemm = gemm


def check_served_logits(cfg, dev, pattern, faults_, limit, path: str):
    """A 3-layer full-width model (``pattern`` x 1 group) served through
    the paged steps: a B 2 x ENGINE_LOGIT_PROMPT prompt in chunks of
    ENGINE_CHUNK (the token loop) and one decode step, the logits through
    the kernels against the plain versions; then each planted fault of
    ``faults_`` (:func:`planted_served`; fault -> must it be caught),
    each marked one of which must read above ``limit``."""
    cfg3 = dataclasses.replace(cfg, block_pattern=pattern, num_groups=1)
    params = lm.init(cfg3, seed=0, device=dev)
    b, c = 2, ENGINE_CHUNK
    toks = rg_tokens(cfg3, dev, (b, ENGINE_LOGIT_PROMPT), 1).to(torch.int32)
    nxt = rg_tokens(cfg3, dev, (b, 1), 2).to(torch.int32)
    kv = PagedKVCache(ENGINE_CACHE, b)
    for r in range(b):
        kv.admit(r, ENGINE_LOGIT_PROMPT, 1)
    table = torch.as_tensor(kv.table_rows(list(range(b))), device=dev)
    n_tok = torch.full((b,), c, dtype=torch.int32, device=dev)
    tag = f"{cfg3.name} 3-layer served logits"

    def run():
        state = smodel.init_state(cfg3, b, ENGINE_CACHE, device=dev)
        cl = torch.zeros(b, dtype=torch.int32, device=dev)
        for i in range(0, ENGINE_LOGIT_PROMPT, c):
            logits, state, cl = smodel.paged_prefill_step(
                params, state, table, cl.to(torch.int32), n_tok, cfg3,
                {"tokens": toks[:, i:i + c]})
        step = smodel.paged_decode_step(params, state, table,
                                        cl.to(torch.int32), cfg3,
                                        {"tokens": nxt})[0]
        return logits.float(), step.float()

    got = run()
    with plain_kernels():
        want = run()
    for name, g in zip(("prefill", "decode step"), got):
        if g.shape != (b, lm.padded_vocab(cfg3)) \
                or not torch.isfinite(g).all():
            fail(f"{tag}, {name}: shape {tuple(g.shape)} or non-finite")

    def readings(outs) -> list:
        return [(g - w).abs().max().item() for g, w in zip(outs, want)]

    noise = readings(got)
    print(f"{tag}, kernels vs plain versions: max |err| prefill "
          f"{noise[0]:.4g}, decode step {noise[1]:.4g} (|logit| max "
          f"{want[0].abs().max().item():.3g}); limit {limit}")
    missed = []
    for fault, must in faults_.items():
        with planted_served(params, cfg3, fault) as made:
            r = readings(run())
        if not made["gemm"]:
            fail(f"{tag} control {fault}: the planted product never ran")
        print(f"{tag} control, {fault[0]} {fault[1]} last K tile skipped "
              f"({made['gemm']} calls): max |err| prefill {r[0]:.4g}, "
              f"decode step {r[1]:.4g} ({max(r) / limit:.3g} limits; "
              f"{'must be caught' if must else 'a reading'})")
        if must and max(r) <= limit:
            missed.append(fault)
    if max(noise) > limit:
        fail(f"{tag}: max |err| {max(noise):.4g} > {limit}")
    if missed:
        fail(f"{tag}: planted faults within the limit: {missed}")
    del params


# ---------------------------------------------------------------------------
# Qwen3-30B-A3B: the MoE path at full width and depth
# ---------------------------------------------------------------------------
QWEN3_ARCH = "qwen3-moe-30b-a3b"
# Qwen3's sma_gemm products: q 2048 -> 4096, k / v 2048 -> 512, the
# attention out 4096 -> 2048 and the router 2048 -> 128, at a decode tick
# (M 8) and a prefill tick (M 2048: 8 rows x chunk 256).
QWEN3_GEMMS = [(m, k, n, "none") for m in (8, 2048)
               for k, n in ((2048, 4096), (2048, 512), (4096, 2048),
                            (2048, 128))]
QWEN3_LOGIT_LAYERS = 3
QWEN3_FAULTS = NEMO_FAULTS + ("router K tile dropped",)
# Kernel names in a decode tick's profile, by what they compute (the first
# group whose words a name holds); the rest is elementwise work.
QWEN3_PROFILE_GROUPS = (
    ("sma_gemm (split-K)", ("splitk",)),
    ("head (rmsnorm_gemm, tile)", ("gemm_tc_kernel",)),
    ("decode attention", ("decode_",)),
    ("expert bmm (cuBLAS)", LIBRARY_GEMM_WORDS),
    ("sort, scan, scatter, gather, index (routing, dispatch, combine; the "
     "pool writes and the embedding)",
     ("sort", "Sort", "scan", "Scan", "scatter", "gather", "index")),
)


def clean_card(what: str) -> None:
    """After every earlier model is gone: the card's free memory printed,
    and no more than 1 GiB may still be allocated."""
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    held = torch.cuda.memory_allocated()
    print(f"{what}: card memory free {free / 2**30:.2f} of "
          f"{total / 2**30:.2f} GiB, {held / 2**30:.3f} GiB allocated")
    if held > 2**30:
        fail(f"{what}: {held / 2**30:.2f} GiB still allocated before it")


def fault_control(what: str, bad, plain_bad, want, multiples) -> None:
    """A planted fault: ``bad`` is the kernel's output on the faulty
    inputs, ``plain_bad`` its plain version's, ``want`` the plain version
    of the right inputs.  The check (``multiples`` above 1) must fail on
    every element the fault moves by more than FAULT_MARGIN limits.
    Tensors are compared CHECK_ROWS leading rows at a time."""
    parts = [(bad, plain_bad, want)] if isinstance(want, tuple) else zip(
        *(t.split(CHECK_ROWS) for t in (bad, plain_bad, want)))
    n_must = n_caught = total = 0
    for bad_, plain_, want_ in parts:
        must = multiples(plain_, want_) > FAULT_MARGIN
        n_must += int(must.sum())
        n_caught += int((multiples(bad_, want_)[must] > 1).sum())
        total += must.numel()
    print(f"{what}: moves {n_must} of {total} elements by > "
          f"{FAULT_MARGIN} limits; the check fails {n_caught} of them")
    if n_must == 0 or n_caught < n_must:
        fail(f"{what}: passes the check where it moves the output")


def check_qwen3_kernels(gen, dev):
    """The kernels at Qwen3-30B-A3B's shapes against their plain versions,
    timed with their bounds, each with a planted fault the check must
    catch: ``sma_gemm`` at QWEN3_GEMMS (B's last 64-row K tile zeroed),
    the decode head ``rmsnorm_gemm`` 2048 -> 152064 at M 8 (route
    ``tile``; W's last K tile zeroed) and paged decode at GQA 32/4,
    head_dim 128 (``attn_controls``).  Then the expert products, library
    ``bmm``s the port calls as the reference calls ``einsum``
    (:func:`time_expert_bmms`)."""
    cfg = get_config(QWEN3_ARCH)
    rows = check_sma_gemm(gen, dev, QWEN3_GEMMS, " (qwen3)")
    gemm_k_tile_controls(gen, dev, QWEN3_GEMMS, "qwen3")
    rows.append(check_head(gen, dev, 8, cfg.d_model, lm.padded_vocab(cfg),
                           "tile", "qwen3 decode head"))
    head_k_tile_control(gen, dev, 8, cfg, "qwen3 decode head")
    rows.append(check_paged_gqa(gen, dev, cfg, "qwen3"))
    time_expert_bmms(gen, dev, cfg)
    return rows


def gemm_k_tile_controls(gen, dev, shapes, tag: str) -> None:
    """At each (M, K, N, epilogue) of ``shapes``, a planted fault fed to
    ``sma_gemm`` (epilogue none): B's last K // 4096 64-row K tiles (at
    least one) zeroed.  One tile of a head's dnormed (K 256,000: 4,000
    tiles) moves no output by FAULT_MARGIN limits, so a longer K drops
    more tiles."""
    dt = torch.bfloat16
    for m, k, n, _ in shapes:
        a = torch.randn((m, k), generator=gen, device=dev).to(dt)
        w = (torch.randn((k, n), generator=gen, device=dev)
             * k ** -0.5).to(dt)
        tiles = max(1, k // 4096)
        bad = w.clone()
        bad[-64 * tiles:] = 0
        fault_control(f"sma_gemm control ({tag}) M={m} {k}->{n}, last "
                      f"{tiles} K tile(s) of B zeroed",
                      kgemm.sma_gemm(a, bad),
                      ref.gemm_ref(a, bad), ref.gemm_ref(a, w),
                      gemm_multiples)
        del a, w, bad


def head_k_tile_control(gen, dev, m: int, cfg, tag: str) -> None:
    """A planted fault fed to ``rmsnorm_gemm`` at ``cfg``'s head with M
    ``m``: W's last 64-row K tile zeroed."""
    dt, k, n = torch.bfloat16, cfg.d_model, lm.padded_vocab(cfg)
    x = (torch.randn((m, k), generator=gen, device=dev) * 3).to(dt)
    scale = torch.rand((k,), generator=gen, device=dev) + 0.5
    w = (torch.randn((k, n), generator=gen, device=dev) * k ** -0.5).to(dt)
    bad = w.clone()
    bad[-64:] = 0
    fault_control(f"rmsnorm_gemm control ({tag}), last K tile of W zeroed",
                  knorm.rmsnorm_gemm(x, scale, bad),
                  ref.rmsnorm_gemm_ref(x, scale, bad),
                  ref.rmsnorm_gemm_ref(x, scale, w), gemm_multiples)


def check_train_kernels(gen, dev):
    """The GEMM kernels at the shapes of the three training cells below
    (Qwen3-30B-A3B at B 4 x S 2048, RecurrentGemma-2B at B 2 x S 4096,
    xLSTM-1.3b at B 4 x S 2048: 8,192 tokens each) against their plain
    versions, timed with their bounds, each with a planted fault the check
    must catch: ``sma_gemm`` at :func:`train_gemms` (every product
    forward, its dA and its dB, the head's dW and dnormed; B's last K
    tiles zeroed; every one on ``wgmma``, xLSTM's w_if at N 8 and its dA
    at K 8 among them) and the head ``rmsnorm_gemm`` at M 8,192 on
    ``wgmma`` (W's last K tile zeroed).  Their flash calls are cases of
    FLASH_CASES."""
    rows = []
    for arch, tokens in ((QWEN3_ARCH, QWEN3_TRAIN_BATCH * QWEN3_TRAIN_SEQ),
                         (RG_ARCH, RG_TRAIN_BATCH * RG_TRAIN_SEQ),
                         (XL_ARCH, XL_TRAIN_BATCH * XL_TRAIN_SEQ)):
        cfg, tag = get_config(arch), arch.split("-")[0]
        shapes = train_gemms(cfg, tokens)
        checked = check_sma_gemm(gen, dev, shapes, f" ({tag} train)")
        off = [r["shape"] for r in checked if r["gemm_route"] != "wgmma"]
        if off:
            fail(f"{tag} train: sma_gemm off the wgmma route at {off}")
        rows += checked
        gemm_k_tile_controls(gen, dev, shapes, f"{tag} train")
        rows.append(check_head(gen, dev, tokens, cfg.d_model,
                               lm.padded_vocab(cfg), "wgmma",
                               f"{tag} train head"))
        head_k_tile_control(gen, dev, tokens, cfg, f"{tag} train head")
        torch.cuda.empty_cache()
    return rows


def time_expert_bmms(gen, dev, cfg) -> None:
    """The expert products as ``moe_ffn`` runs them, ``torch.bmm`` over E
    on (E, B·C, d) operands (cuBLAS; the port writes no kernel for them,
    as the reference's are plain ``einsum``s): the up and gate products d
    -> f and the down product f -> d of one layer, at a decode tick (8
    rows x capacity 1) and a prefill tick (8 rows x capacity(256)), each
    timed with the bound of its bytes (every expert's weights) and
    operations; printed, with one tick's 48 layers."""
    dt = torch.bfloat16
    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
    w_up = (torch.randn((e, d, f), generator=gen, device=dev)
            * d ** -0.5).to(dt)
    w_down = (torch.randn((e, f, d), generator=gen, device=dev)
              * f ** -0.5).to(dt)
    for tick, s in (("decode", 1), ("prefill", SERVE_CHUNK)):
        m = 8 * moe.capacity(s, cfg.moe)
        x = torch.randn((e, m, d), generator=gen, device=dev).to(dt)
        h = torch.randn((e, m, f), generator=gen, device=dev).to(dt)
        up = time_ms(torch.bmm, [(x, w_up)])
        down = time_ms(torch.bmm, [(h, w_down)])
        b_up = bound(2 * (e * m * d + e * d * f + e * m * f),
                     2 * e * m * d * f, dt)
        b_down = bound(2 * (e * m * f + e * f * d + e * m * d),
                       2 * e * m * d * f, dt)
        layer, layer_bound = 2 * up + down, 2 * b_up[0] + b_down[0]
        print(f"qwen3 expert bmm (library, {tick} tick, E={e} M={m} "
              f"(8 rows x capacity {m // 8}) d={d} f={f}): up/gate "
              f"{up:.4f} ms (bound {b_up[0]:.4f}, {b_up[1]}), down "
              f"{down:.4f} ms (bound {b_down[0]:.4f}, {b_down[1]}); a layer "
              f"{layer:.4f} ms (bound {layer_bound:.4f}), "
              f"{cfg.num_layers} layers {layer * cfg.num_layers:.3f} ms "
              f"(bound {layer_bound * cfg.num_layers:.3f})")
        del x, h


def served_drop_fraction(eng, cfg, n_requests: int, tokens: dict,
                         path: str) -> None:
    """The serve run's requests once more through the same engine with
    its ticks run by the direct steps, each MoE layer's routing recorded
    (``moe.moe_ffn``'s, outside any compiled tick): the fraction of
    choices dropped (the reference's ``moe_drop_frac``, over every
    position of the chunk) of every layer of every prefill tick, and
    their mean; and the same over the rows' real tokens alone.  The
    tokens must be the compiled pass's (``tokens``: request id ->
    tokens)."""
    fracs, real, ffn, n_tok = [], [], moe.moe_ffn, []

    def recorded(params, x, cfg_):
        y, r = ffn(params, x, cfg_)
        if x.shape[1] > 1:                       # a prefill chunk
            fracs.append(1.0 - r.keep.float().mean())
            valid = torch.arange(x.shape[1], device=x.device) < n_tok[-1]
            real.append(1.0 - r.keep[valid].float().mean())
        return y, r

    def prefill(p, s, bt, cl, nt, b):
        n_tok.append(nt.long()[:, None])
        return smodel.paged_prefill_step(p, s, bt, cl, nt, cfg, b)

    compiled = dict(eng.engines)
    eng.engines.update(
        prefill=prefill,
        decode=lambda p, s, bt, cl, b: smodel.paged_decode_step(
            p, s, bt, cl, cfg, b))
    moe.moe_ffn = recorded
    try:
        reqs = serve_requests(cfg, n_requests)[1]
        serve_pass(eng, reqs)
    finally:
        moe.moe_ffn = ffn
        eng.engines.update(compiled)
    eng.reset()
    if any(r.out_tokens != tokens[r.rid] for r in reqs):
        fail(f"{path}: the direct steps served other tokens than the "
             f"compiled ticks")
    table = torch.stack(fracs).reshape(-1, cfg.num_layers)
    by_layer = table.mean(0).tolist()
    real = torch.stack(real).reshape(-1, cfg.num_layers)
    print(f"{path}: moe_drop_frac of the prefill ticks (direct steps, "
          f"capacity {moe.capacity(SERVE_CHUNK, cfg.moe)} of a 256-token "
          f"chunk; tokens equal the compiled pass's): mean "
          f"{table.mean().item():.4f}, by tick "
          f"{[round(x, 4) for x in table.mean(1).tolist()]}, by layer "
          f"(every 8th) {[round(x, 4) for x in by_layer[::8]]}; over the "
          f"rows' real tokens alone: mean {real.mean().item():.4f}, by "
          f"layer (every 8th) "
          f"{[round(x, 4) for x in real.mean(0).tolist()[::8]]}")


@contextlib.contextmanager
def routes_seen(pin=None):
    """Every ``moe.route`` call inside the block, as (router logits,
    the choices top-k of them gives).  With ``pin`` (expert ids, one
    tensor a call) each call routes to the pinned choices instead, its
    gate values its own probabilities at them."""
    seen, route = [], moe.route

    def wrapped(logits32, mcfg):
        probs, gate, expert = route(logits32, mcfg)
        seen.append((logits32, expert))
        if pin is not None:
            expert = pin[len(seen) - 1]
            gate = probs.gather(-1, expert)
            if mcfg.norm_topk_prob:
                gate = gate / gate.sum(-1, keepdim=True)
        return probs, gate, expert

    moe.route = wrapped
    try:
        yield seen
    finally:
        moe.route = route


def check_moe_logits(cfg, params, dev):
    """One decode step of a 3-layer full-width MoE model after a ragged
    prefill, through the kernels against the plain versions, with the
    planted faults of QWEN3_FAULTS (:func:`hold_logits`).

    Routing is discontinuous: a rounding difference in a router logit can
    swap one of a token's k experts at a near tie, which moves that
    token's logits by far more than rounding.  So the plain run is pinned
    to the kernels' choices (its gate values its own), and the logits are
    held to LOGIT_ATOL as elsewhere.  The flips are counted: the (token,
    layer) pairs where top-k of the plain run's own router logits chooses
    other experts than the kernels.  A flip is told from a fault by the
    router logits: they must agree within LOGIT_ATOL (a rounding reading;
    the router's dropped K tile moves them by far more), and the experts
    a flip swaps must lie within 2 LOGIT_ATOL of each other in the plain
    logits (the most two readings within LOGIT_ATOL can reorder)."""
    state, table, cl, nxt = prefilled(cfg, params, dev)
    saved = [{k: v.clone() for k, v in e.items()} for e in state]
    batch = step_batch(cfg, params, nxt)

    def step():
        for e, s in zip(state, saved):
            for k in e:
                e[k].copy_(s[k])
        return smodel.paged_decode_step(params, state, table, cl, cfg,
                                        batch)[0][:, :cfg.vocab_size].float()

    with routes_seen() as kern:
        step()
    plain = []

    def plain_step():
        with routes_seen(pin=[e for _, e in kern]) as seen:
            out = step()
        plain[:] = seen
        return out

    with plain_kernels():
        plain_step()
    k = cfg.moe.top_k
    flips, worst = [], 0.0
    for layer, ((lk, ek), (lp, ep)) in enumerate(zip(kern, plain)):
        lk, lp = lk.reshape(-1, lk.shape[-1]), lp.reshape(-1, lp.shape[-1])
        worst = max(worst, (lk - lp).abs().max().item())
        ek, ep = ek.reshape(-1, k), ep.reshape(-1, k)
        for t in range(ek.shape[0]):
            gone = sorted(set(ek[t].tolist()) - set(ep[t].tolist()))
            came = sorted(set(ep[t].tolist()) - set(ek[t].tolist()))
            if gone:
                gap = max(abs(lp[t, a] - lp[t, b]).item()
                          for a in gone for b in came)
                flips.append((t, layer, gone, came, gap))
    print(f"qwen3 decode logits: router logits, kernels vs the pinned "
          f"plain run, max |err| {worst:.4g} over {len(kern)} layers x "
          f"{kern[0][1].numel() // k} tokens; {len(flips)} (token, layer) "
          f"choices differ from the plain run's own top-{k}")
    for t, layer, gone, came, gap in flips:
        print(f"qwen3 flip: token {t} layer {layer}: kernels chose "
              f"{gone}, plain {came}, {gap:.4g} apart in the plain router "
              f"logits")
    if worst > LOGIT_ATOL:
        fail(f"qwen3 decode logits: router logits off by {worst:.4g} > "
             f"{LOGIT_ATOL}")
    if any(gap > 2 * LOGIT_ATOL for *_, gap in flips):
        fail("qwen3 decode logits: a choice differs between experts "
             "further apart than rounding can reorder")
    hold_logits(cfg, "qwen3 decode logits", step,
                (nxt.shape[0], cfg.vocab_size), QWEN3_FAULTS, plain_step)


def profile_groups(prof, steps: int, what: str) -> None:
    """A decode tick's device time by QWEN3_PROFILE_GROUPS (ms a step),
    the rest as elementwise work."""
    sums = collections.Counter()
    for key, (dev_us, _) in kernel_times(prof).items():
        group = next((g for g, words in QWEN3_PROFILE_GROUPS
                      if any(w in key for w in words)),
                     "elementwise and other")
        sums[group] += dev_us
    print(f"profile {what} by kind (ms a step): " + ", ".join(
        f"{g} {us / steps / 1e3:.3f}" for g, us in sums.most_common()))


def moe_decode_bounds(cfg, params, dev) -> None:
    """A decode tick's bytes bound at 3.35 TB/s two ways: every expert's
    weights (the dense dispatch gives each expert a slot, so a tick reads
    them all), and only the experts this tick's 8 rows choose (counted from
    the routing of one direct decode step after the ragged prefill)."""
    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
    hd, layers = cfg.resolved_head_dim, cfg.num_layers
    expert = 3 * d * f * 2
    attn = (d * hd * (cfg.num_heads + 2 * cfg.num_kv_heads)
            + cfg.num_heads * hd * d) * 2
    head_b = d * lm.padded_vocab(cfg) * 2
    router = d * e * 2
    state, table, cl, nxt = prefilled(cfg, params, dev)
    with routes_seen() as seen:
        smodel.paged_decode_step(params, state, table, cl, cfg,
                                 {"tokens": nxt})
    used = [int(torch.unique(ex).numel()) for _, ex in seen]
    rest = layers * (attn + router) + head_b
    dense = layers * e * expert + rest
    active = sum(used) * expert + rest
    print(f"qwen3 decode tick bytes (weights, bf16): experts "
          f"{layers * e * expert / 1e9:.2f} GB, attention "
          f"{layers * attn / 1e9:.2f} GB, head {head_b / 1e9:.2f} GB, router "
          f"{layers * router / 1e9:.3f} GB; every expert {dense / 1e9:.2f} GB "
          f"= {1e3 * dense / PEAK_BYTES:.2f} ms at 3.35 TB/s; the experts "
          f"this tick's 8 rows choose (mean {np.mean(used):.1f} of {e} a "
          f"layer) {active / 1e9:.2f} GB = {1e3 * active / PEAK_BYTES:.2f} "
          f"ms")


# ---------------------------------------------------------------------------
# Training beyond the dense family: the RG-LRU backward, the flash backward
# at head_dim 256, Qwen3-30B-A3B (an MoE) and RecurrentGemma-2B
# ---------------------------------------------------------------------------
RG_LRU_WIDTH = 2560


def bwd_multiples(got, want):
    """Per element of (da, du), the RG-LRU limit multiples."""
    return torch.cat([rglru_multiples(g, w).reshape(-1)
                      for g, w in zip(got[:2], want[:2])])


def check_rglru_bwd(gen, dev):
    """The RG-LRU backward kernel against its plain version
    (``ref.rglru_scan_bwd_ref``) at the training shape, B 2, S 4096, D 2560
    bf16, without h0 (the trainer's call) and with h0 and a gradient of
    h_last: bit for bit on its ``tma`` route, and on ``simt``; planted
    faults fed to it, each held against the plain version of the right
    inputs: the reverse carry reset at t = S/2 (the sequence run as two
    halves) and a shifted by one step (a_{t+1} read as a_t).  Timed beside
    the ``simt`` kernel; no PyTorch call computes the reverse recurrence."""
    b, s, d, dt = RG_TRAIN_BATCH, RG_TRAIN_SEQ, RG_LRU_WIDTH, torch.bfloat16
    a, u, h0 = scan_inputs(gen, dev, b, s, d, dt)
    dh = torch.randn((b, s, d), generator=gen, device=dev).to(dt)
    dl = torch.randn((b, d), generator=gen, device=dev).to(dt)
    rows = []
    for with_h0 in (False, True):
        h0_, dl_ = (h0, dl) if with_h0 else (None, None)
        hs = krglru.rglru_scan(a, u, h0_)[0]
        before = dict(krglru.BWD_ROUTES)
        got = krglru.rglru_scan_bwd(a, hs, dh, h0_, dl_)
        route = kernel_route(krglru.BWD_ROUTES, before, "rglru_scan_bwd")
        want = ref.rglru_scan_bwd_ref(a, hs, dh, h0_, dl_)
        simt = krglru._run_bwd(a, hs, dh, h0_, dl_, "simt")
        pairs = [(g, w) for g, w in zip(got, want) if w is not None]
        equal = all(torch.equal(g, w) for g, w in pairs)
        simt_equal = all(torch.equal(g, w) for g, w in zip(simt, want)
                         if w is not None)
        err = max((g.float() - w.float()).abs().max().item()
                  for g, w in pairs)
        shape = f"B={b} S={s} D={d} bf16{' h0 dh_last' if with_h0 else ''}"
        print(f"rglru backward {shape} ({route}): max |err| {err:.4g}; bit "
              f"for bit: {equal}; simt bit for bit: {simt_equal}")
        if route != "tma" or not equal or not simt_equal or not all(
                torch.isfinite(g.float()).all() for g, _ in pairs):
            fail(f"rglru_scan_bwd {shape}: kernel disagrees with its plain "
                 f"version (route {route})")
        if with_h0:
            continue
        half = s // 2
        shifted = torch.cat([a[:, 1:], a[:, -1:]], 1)

        def reset(fn):
            lo = fn(a[:, :half], hs[:, :half], dh[:, :half], None, None)
            hi = fn(a[:, half:], hs[:, half:], dh[:, half:],
                    hs[:, half - 1].contiguous(), None)
            return tuple(torch.cat([x, y], 1) for x, y in zip(lo[:2], hi[:2]))

        faults = {f"reverse carry reset at t={half}": reset,
                  "a shifted by one step": lambda fn: fn(shifted, hs, dh,
                                                         None, None)}
        for name, run in faults.items():
            fault_control(f"rglru backward control, {name}",
                          run(krglru.rglru_scan_bwd),
                          run(ref.rglru_scan_bwd_ref), want, bwd_multiples)
        nbytes = 5 * a.numel() * a.element_size()
        row = entry("rglru_scan_bwd", shape, err,
                    time_ms(krglru.rglru_scan_bwd, [(a, hs, dh)]),
                    time_ms(ref.rglru_scan_bwd_ref, [(a, hs, dh)], 1),
                    bound(nbytes, 4 * a.numel(), torch.float32), None)
        row.update(kernel_route=route,
                   simt_ms=time_ms(lambda *x: krglru._run_bwd(
                       *x, None, None, "simt"), [(a, hs, dh)]),
                   ptxas=ptxas_entries("rglru_scan", "scan_bwd"))
        rows.append(row)
        del got, want, simt
    return rows


def mlstm_bwd_errors(got, want) -> list:
    """Per gradient (dq, dk, dv, dlog_f, dlog_i), max |err| / max |plain|."""
    return [((g.float() - w.float()).abs().max()
             / w.float().abs().max().clamp(min=1e-30)).item()
            for g, w in zip(got, want)]


def device_ms_by_kernel(fn, args) -> dict:
    """Device ms of each kernel in one call of ``fn(*args)``
    (``torch.profiler``, device activity only), largest first, keyed by
    the kernel's name cut before its template and parameters."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    same_as_key_averages(prof)
    out = {}
    for key, (us, _) in kernel_times(prof).items():
        if us > 0:
            name = key.split("<")[0].split("(")[0].split("::")[-1]
            out[name] = out.get(name, 0.0) + us / 1e3
    return dict(sorted(((k, round(v, 4)) for k, v in out.items()),
                       key=lambda kv: -kv[1]))


def no_spills(ptxas: dict, what: str) -> None:
    """Fail where ``-Xptxas -v`` reported spill stores for a kernel of
    ``ptxas`` (:func:`ptxas_entries`)."""
    spilled = {fn: rep for fn, rep in ptxas.items()
               if re.search(r"[1-9]\d* bytes spill stores", rep)}
    if spilled:
        fail(f"{what}: ptxas spills registers in {spilled}")


def check_mlstm_bwd(gen, dev):
    """The mLSTM backward kernel against its plain version, the closed form
    ``ref.mlstm_chunkwise_bwd_ref`` (f32, over the whole causal matrix), at
    the training shape (B 4, H 4, S 2048, D 1024, chunk 128, bf16): with
    the gradient of h alone (the trainer's call) and with the final (C,
    n)'s; every gradient within MLSTM_BWD_LIMIT of its largest entry, on
    the backward's own ``wgmma`` route (its products on the tensor cores).
    Planted faults fed to that route, each of which must move some
    gradient past the limit: the reverse state gradient reset at chunk nc
    / 2, dq's inter-chunk terms dropped, dlog_f's reverse cumulative sum
    shifted by one step.  Timed with its bound and beside route ``simt``
    on the same inputs (the CUDA-core design, ``simt_ms``); the ``wgmma``
    kernels' ptxas report (no spills) and dynamic shared memory (each
    within a block's 232,448 bytes).  No PyTorch call computes it."""
    cfg = get_config(XL_ARCH)
    b, h, s, dt = XL_TRAIN_BATCH, cfg.num_heads, XL_TRAIN_SEQ, torch.bfloat16
    d = int(cfg.d_model * cfg.mlstm_proj_factor) // h
    chunk = cfg.mlstm_chunk
    ins = mlstm_inputs(gen, dev, b, h, s, d, dt)
    dh = torch.randn((b, h, s, d), generator=gen, device=dev).to(dt)
    dc = torch.randn((b, h, d, d), generator=gen, device=dev)
    dn = torch.randn((b, h, d), generator=gen, device=dev)
    rows = []
    for state in (False, True):
        grads = (dh, dc, dn) if state else (dh, None, None)
        before = dict(kmlstm.BWD_ROUTES)
        got = kmlstm.mlstm_chunkwise_bwd(*ins, *grads, chunk=chunk)
        route = kernel_route(kmlstm.BWD_ROUTES, before,
                             "mlstm_chunkwise_bwd")
        want = ref.mlstm_chunkwise_bwd_ref(*ins, *grads, chunk=chunk)
        errs = mlstm_bwd_errors(got, want)
        shape = (f"B={b} H={h} S={s} D={d} chunk={chunk} bf16"
                 + (" dC dn" if state else ""))
        print(f"mlstm backward {shape} ({route}): max |err| / max |plain| "
              f"of dq, dk, dv, dlog_f, dlog_i "
              f"{[float(f'{x:.3g}') for x in errs]} (limit "
              f"{MLSTM_BWD_LIMIT})")
        if route != "wgmma" or max(errs) > MLSTM_BWD_LIMIT or not all(
                torch.isfinite(g.float()).all() for g in got):
            fail(f"mlstm_chunkwise_bwd {shape}: kernel disagrees with its "
                 f"plain version")
        if state:
            continue
        smem = kmlstm.bwd_smem()
        if max(smem.values()) > 232448:
            fail(f"mlstm backward wgmma kernels: dynamic shared memory "
                 f"{smem} past a block's 232,448 bytes")
        ptxas = {k: v for k, v in ptxas_entries(
            "mlstm_chunkwise", "mlstm_bwd").items()
            if "wg_kernel" in k and "__half" not in k}
        no_spills(ptxas, "mlstm backward wgmma kernels")
        lf32, li32 = ins[3].float().contiguous(), ins[4].float().contiguous()
        for name, plant in (("reverse state gradient reset at chunk nc/2",
                             kmlstm.BWD_PLANT_RESET),
                            ("dq's inter-chunk terms dropped",
                             kmlstm.BWD_PLANT_DQ_INTER),
                            ("dlog_f's reverse cumsum one step short",
                             kmlstm.BWD_PLANT_SHIFT)):
            bad = kmlstm._run_bwd(*ins[:3], lf32, li32, dh, None, None,
                                  chunk, plant)
            worst = max(mlstm_bwd_errors(bad, want))
            print(f"mlstm backward control, {name}: max |err| / max |plain| "
                  f"{worst:.4g} ({worst / MLSTM_BWD_LIMIT:.3g} limits)")
            if not worst > MLSTM_BWD_LIMIT:
                fail(f"mlstm backward control, {name}: passes the check")
            del bad

        def run(*a):
            return kmlstm.mlstm_chunkwise_bwd(*a, chunk=chunk)

        def plain(*a):
            return ref.mlstm_chunkwise_bwd_ref(*a, chunk=chunk)

        # Bytes: q, k, v, dh read and dq, dk, dv written in bf16, the f32
        # gates read and their gradients written, each once.
        args = [(*ins, dh)]
        nbytes = 7 * dh.numel() * dh.element_size() + 4 * 4 * b * h * s
        row = entry("mlstm_chunkwise_bwd", shape, max(
            (g.float() - w.float()).abs().max().item()
            for g, w in zip(got, want)),
            time_ms(run, args, 5), time_ms(plain, args, 2),
            bound(nbytes, kmlstm.bwd_flops(b, h, s, d, chunk), dt), None)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        run(*args[0])
        peak = torch.cuda.max_memory_allocated() - base
        row["passes_ms"] = device_ms_by_kernel(run, args[0])
        print(f"mlstm backward {shape}: device ms of one call by kernel "
              f"{json.dumps(row['passes_ms'])}")
        row.update(kernel_route=route, relative_errors=errs,
                   scratch_peak_bytes=peak, ptxas=ptxas, smem_bytes=smem)
        del got, want
        torch.cuda.empty_cache()
        row["simt_ms"] = time_ms(lambda *a: kmlstm._run_bwd(
            *a, None, None, chunk, route="simt"),
            [(*ins[:3], lf32, li32, dh)], 2)
        rows.append(row)
        torch.cuda.empty_cache()
    del ins, dh, dc, dn
    torch.cuda.empty_cache()
    return rows


def check_mlstm_bwd_simt(gen, dev):
    """The backward's ``simt`` route (f32 on the CUDA cores: f32 inputs, D
    not a multiple of 64, chunks under 128) against the closed form at
    MLSTM_BWD_SIMT_CASE (f32, ragged S, with the final (C, n)'s
    gradients): every gradient within MLSTM_BWD_F32_LIMIT of its largest
    entry; timed with its bound (f32 operations on the CUDA cores) and its
    ptxas report."""
    b, h, s, d, chunk = MLSTM_BWD_SIMT_CASE
    dt = torch.float32
    ins = mlstm_inputs(gen, dev, b, h, s, d, dt)
    dh = torch.randn((b, h, s, d), generator=gen, device=dev)
    dc = torch.randn((b, h, d, d), generator=gen, device=dev)
    dn = torch.randn((b, h, d), generator=gen, device=dev)
    before = dict(kmlstm.BWD_ROUTES)
    got = kmlstm.mlstm_chunkwise_bwd(*ins, dh, dc, dn, chunk=chunk)
    route = kernel_route(kmlstm.BWD_ROUTES, before, "mlstm_chunkwise_bwd")
    want = ref.mlstm_chunkwise_bwd_ref(*ins, dh, dc, dn, chunk=chunk)
    errs = mlstm_bwd_errors(got, want)
    shape = f"B={b} H={h} S={s} D={d} chunk={chunk} f32 dC dn"
    print(f"mlstm backward {shape} ({route}): max |err| / max |plain| of "
          f"dq, dk, dv, dlog_f, dlog_i {[float(f'{x:.3g}') for x in errs]} "
          f"(limit {MLSTM_BWD_F32_LIMIT})")
    if route != "simt" or max(errs) > MLSTM_BWD_F32_LIMIT or not all(
            torch.isfinite(g).all() for g in got):
        fail(f"mlstm_chunkwise_bwd {shape}: the simt route disagrees with "
             f"its plain version")

    def run(*a):
        return kmlstm.mlstm_chunkwise_bwd(*a, dc, dn, chunk=chunk)

    def plain(*a):
        return ref.mlstm_chunkwise_bwd_ref(*a, dc, dn, chunk=chunk)

    args = [(*ins, dh)]
    nbytes = 4 * (7 * dh.numel() + 4 * b * h * s + dc.numel() + dn.numel())
    row = entry("mlstm_chunkwise_bwd", shape, max(
        (g - w).abs().max().item() for g, w in zip(got, want)),
        time_ms(run, args, 3), time_ms(plain, args, 2),
        bound(nbytes, kmlstm.bwd_flops(b, h, s, d, chunk), dt), None)
    row.update(kernel_route=route, relative_errors=errs,
               ptxas={k: v for k, v in ptxas_entries(
                   "mlstm_chunkwise", "mlstm_bwd").items()
                   if "wg_kernel" not in k and "kernelIf" in k})
    del got, want, ins, dh, dc, dn
    torch.cuda.empty_cache()
    return [row]


def check_moe_backward(cfg, dev):
    """The MoE layer's routing backward, at Qwen3's full width and the
    training shape (B 4 x S 2048, 128 experts top 8): which kernels
    autograd makes of the dispatch gather ``x_pad[rows]`` and the combine
    gather ``ye[slot]`` (their backward adds k = 8 slot gradients into
    each token row and every empty slot's into the sentinel row), and
    whether two backward passes give the same bits.  Printed: the kernel
    names of the backward by device time, and which gradients equal; fails
    unless every gradient of the two passes is ``torch.equal``."""
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device=dev).manual_seed(5)
    dt = torch.bfloat16
    params = lm.init(dataclasses.replace(cfg, num_groups=1), seed=0,
                     device=dev)["blocks"][0]["ffn"]
    params = {k: v[0].detach().requires_grad_() for k, v in params.items()}
    x = (torch.randn((QWEN3_TRAIN_BATCH, QWEN3_TRAIN_SEQ, cfg.d_model),
                     generator=gen, device=dev)).to(dt).requires_grad_()
    dy = torch.randn(x.shape, generator=gen, device=dev).to(dt)
    leaves_ = [x] + [params[k] for k in sorted(params)]

    def backward():
        y, _ = moe.moe_ffn(params, x, cfg)
        return torch.autograd.grad(y, leaves_, dy)

    first = backward()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        second = backward()
        torch.cuda.synchronize()
    names = ["x"] + sorted(params)
    same = {n: torch.equal(a, b) for n, a, b in zip(names, first, second)}
    kernels = sorted(((us, key)
                      for key, (us, _) in kernel_times(prof).items()
                      if us > 0 and any(w in key.lower() for w in (
                          "index", "scatter", "gather", "sort", "put",
                          "atomic"))), reverse=True)
    print(f"moe backward (qwen3, B {QWEN3_TRAIN_BATCH} x S "
          f"{QWEN3_TRAIN_SEQ}, one layer): two passes bit for bit "
          f"{json.dumps(same)}; routing kernels of a pass (device us, "
          f"name): {[(round(t, 1), k[:90]) for t, k in kernels[:10]]}")
    del first, second, params, x
    torch.cuda.empty_cache()
    if not all(same.values()):
        fail(f"moe backward: two passes differ: {same}")


@contextlib.contextmanager
def young_heap(seconds: list):
    """For the block, every object alive at its start out of the
    collector's sight (``gc.freeze``: late in the script a full collection
    walks everything the earlier phases keep, the compiled graphs among
    them), so the block's ``gc.collect`` calls walk what the block made;
    the seconds its collections took are appended to ``seconds``."""
    began, spent = [0.0], [0.0]

    def on_gc(phase, info):
        if phase == "start":
            began[0] = time.perf_counter()
        else:
            spent[0] += time.perf_counter() - began[0]
    gc.freeze()
    gc.callbacks.append(on_gc)
    try:
        yield
    finally:
        gc.callbacks.remove(on_gc)
        gc.unfreeze()
        seconds.append(spent[0])


#: Each train cell's history by path (the distributed phase's (g) reads
#: "train qwen3"'s as its unmeshed reference).
TRAIN_HISTORY = {}


def train_family(cfg, dev, card: str, path: str, seq: int, batch: int,
                 timing_steps: int = TIME_STEPS):
    """:func:`family_run` on a clean card, the earlier phases' objects
    frozen out of the collector (:func:`young_heap`)."""
    clean_card(path)
    spent = []
    with young_heap(spent):
        counts = family_run(cfg, dev, card, path, seq, batch, timing_steps)
    print(f"{path}: {spent[0]:.1f} s in the garbage collector")
    return counts


def family_run(cfg, dev, card: str, path: str, seq: int, batch: int,
               timing_steps: int):
    """``train()`` on ``cfg`` at full width for TRAIN_STEPS compiled steps
    (B ``batch`` x S ``seq``, remat, f32 masters + AdamW at TRAIN_LR, bf16
    compute): finite losses, 1 miss and 4 hits, every kernel of the path
    launched and on its route, nothing routed; step time (median of steps
    2-5), tokens/s, MFU = 6 N tokens / step / 989 TFLOP/s with N the
    parameters that enter a token's products (:func:`matmul_params`, as
    the StableLM trainer's), the MoE's
    ``moe_drop_frac`` each step, peak memory.  Then the compiled step
    against the direct one on the trained parameters: the direct step's
    run-to-run spread a gradient printed; the loss and the gradients
    upstream of every flash dQ bit for bit (all of them where that spread
    reads 0 for every gradient: without attention, or with attention only
    at head_dim 256), every other gradient within max(2 x the direct
    step's own spread, JIT_TRAIN_FLOOR); their event time A B B A over
    ``timing_steps`` steps a reading and peak memory; a profile of one
    compiled step; the seconds each part took.  Returns the launches of the
    5 steps."""
    from repro_torch import sma_jit
    loop = TrainLoopConfig(steps=TRAIN_STEPS, seq_len=seq,
                           global_batch=batch, log_every=1, seed=0,
                           peak_lr=TRAIN_LR, remat=True)
    marks = [("start", time.perf_counter())]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    torch.cuda.synchronize()
    with captured_compiles() as built:
        result = train(cfg, loop, device=dev)
    torch.cuda.synchronize()
    marks.append(("train()", time.perf_counter()))
    counts, routed = ops.launch_counts(), dict(ops.ROUTED)
    routes = nonzero(kgemm.ROUTES)
    peak = torch.cuda.max_memory_allocated()
    engine, hist = result["engine"], result["history"]
    TRAIN_HISTORY[path] = hist
    if (engine["misses"], engine["hits"], len(built)) != \
            (1, TRAIN_STEPS - 1, 1):
        fail(f"{path}: the step engine compiled {len(built)} times, "
             f"{engine}; expected 1 miss and {TRAIN_STEPS - 1} hits")
    for h in hist:
        if not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                and h["grad_norm"] > 0):
            fail(f"{path} step {h['step']}: loss {h['loss']}, grad norm "
                 f"{h['grad_norm']}")
    need = ["sma_gemm", "rmsnorm_gemm"]
    if any(bt in ("attn", "local") for bt in cfg.block_pattern):
        need += ["flash_attention", "flash_attention_bwd"]
    if "mlstm" in cfg.block_pattern:
        need += ["mlstm_chunkwise", "mlstm_chunkwise_bwd"]
        ml = cfg.block_pattern.count("mlstm") * cfg.num_groups
        want = {"mlstm_chunkwise": 2 * ml * TRAIN_STEPS,
                "mlstm_chunkwise_bwd": ml * TRAIN_STEPS}
        if {k: counts[k] for k in want} != want:
            fail(f"{path}: mLSTM launches {counts}, expected {want}")
        if nonzero(kmlstm.BWD_ROUTES) != {
                "wgmma": want["mlstm_chunkwise_bwd"]}:
            fail(f"{path}: mlstm_chunkwise_bwd routes {kmlstm.BWD_ROUTES}, "
                 f"expected every launch's recompute on wgmma")
    if "rglru" in cfg.block_pattern:
        need += ["rglru_scan", "rglru_scan_bwd"]
        rg = cfg.block_pattern.count("rglru") * cfg.num_groups
        want = {"rglru_scan": 2 * rg * TRAIN_STEPS,
                "rglru_scan_bwd": rg * TRAIN_STEPS}
        if {k: counts[k] for k in want} != want:
            fail(f"{path}: scan launches {counts}, expected {want}")
        if nonzero(krglru.ROUTES) != {"tma": want["rglru_scan"]} or \
                nonzero(krglru.BWD_ROUTES) != {"tma": want["rglru_scan_bwd"]}:
            fail(f"{path}: scan routes {krglru.ROUTES} / "
                 f"{krglru.BWD_ROUTES}, expected every launch on tma")
    attn = sum(bt in ("attn", "local") for bt in cfg.block_pattern) \
        * cfg.num_groups
    want = {"flash_attention": 2 * attn * TRAIN_STEPS,
            "flash_attention_bwd": attn * TRAIN_STEPS,
            "rmsnorm_gemm": TRAIN_STEPS}
    if {k: counts[k] for k in want} != want:
        fail(f"{path}: launches {counts}, expected {want}")
    missing = [k for k in need if not counts[k]]
    if missing or routed:
        fail(f"{path}: kernels not launched {missing}; routed {routed}")
    if routes != {"wgmma": counts["sma_gemm"]}:
        fail(f"{path}: sma_gemm routes {routes}, expected every launch on "
             f"wgmma")
    FLASH_ROUTES_BY_PATH[path] = check_flash_routes(path, counts)
    ROUTES_BY_PATH[path] = check_kernel_routes(path, counts, "wgmma")
    walls = [h["wall_s"] for h in hist]
    steps = [y - x for x, y in zip(walls, walls[1:])]
    step_s = float(np.median(steps))
    tokens = seq * batch
    n_mm = matmul_params(cfg)
    losses = [h["loss"] for h in hist]
    drops = [round(h["moe_drop_frac"], 4) for h in hist
             if "moe_drop_frac" in h]
    print_compile(f"{path}: {cfg.name}.train_step", built[0])
    print(f"{path}: {cfg.name} full width, {cfg.num_layers} layers, seq "
          f"{seq}, batch {batch}, remat, f32 masters + AdamW, peak_lr "
          f"{TRAIN_LR}, bf16 compute ({cfg.param_count()} parameters, "
          f"{cfg.active_param_count()} a token touches, {n_mm} in its "
          f"products; engine {json.dumps(engine)}); losses "
          f"{[round(x, 4) for x in losses]} (fell "
          f"{losses[0] - losses[-1]:.4f}), grad norms "
          f"{[round(h['grad_norm'], 4) for h in hist]}"
          + (f", moe_drop_frac {drops}" if drops else ""))
    print(f"{path}: step 1 {walls[0]:.3f} s (compile and first launches), "
          f"steps 2-5 {[round(x, 4) for x in steps]} s, median "
          f"{step_s:.4f} s: {tokens / step_s:.1f} tokens/s, MFU "
          f"{100 * 6 * n_mm * tokens / step_s / H100_BF16:.2f}% (6 N tokens "
          f"/ step / 989 TFLOP/s, N = {n_mm}; bound "
          f"{6 * n_mm * tokens / H100_BF16:.4f} s); peak memory "
          f"{peak / 2**30:.2f} GiB (max_memory_allocated)")
    print(f"{path}: launches over {TRAIN_STEPS} steps "
          f"{json.dumps(nonzero(counts))}; sma_gemm routes "
          f"{json.dumps(routes)}; flash routes "
          f"{json.dumps(FLASH_ROUTES_BY_PATH[path])}; rmsnorm_gemm, mlstm, "
          f"rglru routes {json.dumps(ROUTES_BY_PATH[path])}; "
          f"mlstm_chunkwise_bwd routes "
          f"{json.dumps(nonzero(kmlstm.BWD_ROUTES))}")
    params, cm = result["params"], built[0]
    del result, built
    gc.collect()
    torch.cuda.empty_cache()
    time_train_step(cfg, params, cm, dev, card, seq, batch, timing_steps)
    marks.append(("step timing", time.perf_counter()))
    profile_train_step(cfg, params, dev, cm, seq, batch)
    marks.append(("profile", time.perf_counter()))
    del cm
    gc.collect()
    torch.cuda.empty_cache()

    # The compiled loss and gradients against the direct ones.
    names = [n for n, _ in named_leaves(params)]
    tbatch = train_batch(cfg, dev, seq, batch)

    def loss_and_grads(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, _ = lm.loss_fn(live, cfg, batch, remat=True)
        return loss.detach(), torch.autograd.grad(loss, leaves(live))

    def grads_run(fn):
        ops.reset_counts()
        loss, grads = fn(params, tbatch)
        torch.cuda.synchronize()
        return loss, grad_pieces(names, grads)

    grad_eng = sma_jit(loss_and_grads, name=f"{cfg.name}.loss_and_grads")
    grad_eng.compile(params, tbatch)
    want = grads_run(loss_and_grads)
    again = grads_run(loss_and_grads)
    spread = relative_errors(again[1], want[1])
    del again
    print(f"{path}: the direct step's run-to-run spread, a gradient: "
          f"{json.dumps({k: float(f'{x:.3g}') for k, x in spread.items()})}")
    got = grads_run(grad_eng)
    # Where the direct step reads the same bits twice (no attention, as
    # xLSTM; or attention only at head_dim 256, whose backward sums in a
    # fixed order, as RecurrentGemma), every gradient is held bit for bit;
    # else those upstream of every flash dQ summed in no fixed order.
    last = max((i for i, bt in enumerate(cfg.block_pattern)
                if bt in ("attn", "local")), default=-1)
    top = cfg.num_groups - 1
    exact = [k for k in got[1] if not any(spread.values())
             or k in ("head.w", "final_norm.scale") or any(
        k.startswith(f"blocks.{p}.") and k.endswith(f"[{top}]")
        and (p > last or p == last and k.split(".")[2] in ("ffn", "norm2"))
        for p in range(len(cfg.block_pattern)))]
    unequal = [k for k in exact if not torch.equal(got[1][k], want[1][k])]
    mult = spread_multiples(relative_errors(got[1], want[1]), spread)
    worst = max(mult, key=mult.get)
    print(f"{path}: loss and gradients compiled vs direct: loss "
          f"{got[0].item():.6f} vs {want[0].item():.6f} (torch.equal "
          f"{torch.equal(got[0], want[0])}); {len(exact)} of {len(got[1])} "
          f"gradients held bit for bit, unequal {unequal}; direct-vs-direct "
          f"spread max {max(spread.values()):.4g}, median "
          f"{np.median(list(spread.values())):.4g}; largest limit multiple "
          f"{mult[worst]:.4g} ({worst})")
    if not torch.equal(got[0], want[0]) or unequal or mult[worst] > 1:
        fail(f"{path}: the compiled loss and gradients part from the "
             f"direct ones beyond the rule")
    marks.append(("compiled vs direct", time.perf_counter()))
    print(f"{path}: seconds by part " + json.dumps(
        {name: round(t - marks[i][1], 1)
         for i, (name, t) in enumerate(marks[1:])}))
    del got, want, params, grad_eng
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def train_qwen3(dev, card: str):
    """The MoE's routing backward, bit for bit (:func:`check_moe_backward`),
    then Qwen3-30B-A3B at full width, QWEN3_TRAIN_LAYERS layers, through
    :func:`train_family`."""
    cfg = dataclasses.replace(get_config(QWEN3_ARCH),
                              num_groups=QWEN3_TRAIN_LAYERS)
    check_moe_backward(cfg, dev)
    return train_family(cfg, dev, card, "train qwen3", QWEN3_TRAIN_SEQ,
                        QWEN3_TRAIN_BATCH)


def train_recurrentgemma(dev, card: str):
    cfg = dataclasses.replace(get_config(RG_ARCH),
                              num_groups=RG_TRAIN_GROUPS)
    return train_family(cfg, dev, card, "train recurrentgemma",
                        RG_TRAIN_SEQ, RG_TRAIN_BATCH)


def train_xlstm(dev, card: str):
    """xLSTM-1.3b at full width, XL_CUT_GROUPS group(s) (7 mLSTM and 1
    sLSTM layers), B 4 x S 2048, through :func:`train_family`: the mLSTM
    forward kernel twice a layer a step (the remat recomputation), its
    backward kernel once; the sLSTM step loop one loop node forward and
    one reverse loop node backward.  Its step takes seconds on the host
    (the sLSTM loop), so the A B B A timing reads one step a reading."""
    cfg = dataclasses.replace(get_config(XL_ARCH), num_groups=XL_CUT_GROUPS)
    return train_family(cfg, dev, card, "train xlstm", XL_TRAIN_SEQ,
                        XL_TRAIN_BATCH, timing_steps=1)


# --------------------------------------------------------------------------
# The distributed phase: ranks spawned on the one card over gloo
# --------------------------------------------------------------------------
DIST_DIR = ROOT / "build" / "dist"
DIST_TIMEOUT = 900                 # a world's deadline, s
DIST_SUMMA = (TRAIN_BATCH * TRAIN_SEQ, 2048, 5632, "silu")  # M, K, N, ep.
DIST_PIPE_LAYERS, DIST_MICRO = 4, 4          # 2 stages of 2 layers
DIST_JIT_LAYERS = 2
DIST_PSUM_SHAPE = (2048, 5632)
#: (c)'s and (f)'s depth: half of StableLM's 24 layers, so that the
#: phase, with its unmeshed references and its planted-fault runs at the
#: same depth, fits the script's time limit beside full-depth serving.
DIST_TRAIN_LAYERS = 12
DIST_FAULT_STEPS = 2
#: (c)'s planted-fault run, as long as the unmeshed references it is read
#: against: the FSDP gather whose gradient skips the sum over data, read at
#: every step; the replicated norm scale's all-reduce skipped on rank 1 at
#: its last step (after the last reading).
DIST_FSDP_FAULT_STEPS = TRAIN_STEPS
#: train(mesh=)'s loss and grad norm against the unmeshed runs' at the
#: same depth, each relative, by step (step 1, from the same masters:
#: STEP_LIMITS).  On the H100 (12 layers, ZeRO-1 before FSDP): at step 2
#: the unmeshed pair differ by 1.3e-5 / 1.3e-3 and the meshed run read
#: 2.3e-5 / 1.7e-3 from the farther (full depth, earlier: up to 3.5e-5 /
#: 4.7e-3); a planted wrong block in the ZeRO-1 update, which kept the
#: replicas equal, read 1.04e-3 / 4.7e-2 there.  Later steps follow every
#: earlier update and spread more (the flash backward at D 64 adds dQ in
#: no fixed order): up to 2.2e-4 / 1.2e-2 at 12 layers, 4.7e-4 / 3.5e-2 at
#: full depth.
DIST_STEP2_LIMITS = {"loss": 3e-4, "grad_norm": 1.5e-2}
DIST_TRAIN_LIMITS = {"loss": 2e-3, "grad_norm": 0.1}
#: (h)'s RecurrentGemma: one group of its pattern cut to these layers
#: (RG-LRU, and MQA attention at head_dim 256), and (i)'s StableLM depth.
TP_RG_PATTERN = ("rglru", "rglru", "local")
TP_MESH_LAYERS = 4
#: (c)'s and (f)'s gathered masters against the unmeshed runs': each
#: leaf's ||meshed - unmeshed|| / ||unmeshed - init||, the largest over the
#: leaves, at most max(TP_MASTERS_SPREAD x the two unmeshed runs' own, the
#: floor), the pair's gap read in (c).
#: The floor: a CPU rehearsal at 2 bf16 layers, where the unmeshed runs
#: are bit for bit, reads 0.07 from the bf16 partial sums alone; on the
#: H100 (f) reads 0.1142 beside the unmeshed pair's 0.0538-0.0552.  The
#: planted swap of the head's vocab blocks in the update ("head blocks
#: swapped", replicas equal) and (c)'s planted gather with no sum over
#: data must read above the limit.
TP_MASTERS_SPREAD, TP_MASTERS_FLOOR = 3.0, 0.25


def dist_limits(step: int) -> dict:
    """The limits of train(mesh=)'s metrics at ``step`` (from 1)."""
    return {1: STEP_LIMITS, 2: DIST_STEP2_LIMITS}.get(step,
                                                      DIST_TRAIN_LIMITS)


def dist_drift(hist: list, refs: list) -> list:
    """Each step's largest relative |loss| and |grad norm| from the
    histories ``refs``, as multiples of that step's limits."""
    return [{k: max(abs(h[k] - ref[i][k]) / abs(ref[i][k]) for ref in refs)
             / dist_limits(i + 1)[k] for k in ("loss", "grad_norm")}
            for i, h in enumerate(hist)]


def dist_run(steps: int = TRAIN_STEPS):
    """(c)'s model and loop: StableLM at full width, DIST_TRAIN_LAYERS
    layers, the trainer phase's loop."""
    cfg = dataclasses.replace(get_config(ARCH), num_groups=DIST_TRAIN_LAYERS)
    return cfg, TrainLoopConfig(steps=steps, seq_len=TRAIN_SEQ,
                                global_batch=TRAIN_BATCH, log_every=1,
                                seed=0, peak_lr=TRAIN_LR, remat=True)


def metrics_of(history: list) -> list:
    """A train history without its host clock."""
    return [{k: v for k, v in h.items() if k != "wall_s"} for h in history]


def dist_summa(mesh, dev) -> dict:
    """(a): sma_gemm_sharded at StableLM's MLP product against one rank's
    ops.sma_gemm of the whole product; overlap and serial equal; the local
    products on wgmma, one a step; step 1's A-panel not broadcast caught."""
    from repro_torch.distributed import summa
    m, k, n, ep = DIST_SUMMA
    marks = [time.perf_counter()]
    gen = torch.Generator(device=dev).manual_seed(7)      # every rank alike
    a = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
    b = (torch.randn(k, n, generator=gen, device=dev)
         / math.sqrt(k)).to(torch.bfloat16)
    bias = (0.1 * torch.randn(n, generator=gen, device=dev)).to(
        torch.bfloat16)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    want = ops.sma_gemm(a, b, bias=bias, epilogue=ep, mesh=False)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    ops.reset_counts()
    got = summa.sma_gemm_sharded(a, b, mesh=mesh, bias=bias, epilogue=ep)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    launches = ops.launch_counts()["sma_gemm"]
    routes = nonzero(kgemm.ROUTES)
    serial = summa.sma_gemm_sharded(a, b, mesh=mesh, bias=bias, epilogue=ep,
                                    overlap=False)
    bad = summa._summa(a, b, mesh=mesh, axes=None, bias=bias, epilogue=ep,
                       overlap=True, skip_a_step=1)
    _, _, pr, pc = summa.summa_grid(mesh)

    def ms(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / reps

    first = dict(zip(("inputs", "first local product", "first sharded"),
                     np.diff(marks).round(2).tolist()))
    return {"grid": [pr, pc], "launches": launches, "routes": routes,
            "first_s": first,
            "steps": math.lcm(pr, pc),
            "mult": gemm_multiples(got, want).max().item(),
            "err": (got.float() - want.float()).abs().max().item(),
            "equal": torch.equal(got, serial),
            "fault_mult": gemm_multiples(bad, want).max().item(),
            "ms_overlap": ms(lambda: summa.sma_gemm_sharded(
                a, b, mesh=mesh, bias=bias, epilogue=ep)),
            "ms_serial": ms(lambda: summa.sma_gemm_sharded(
                a, b, mesh=mesh, bias=bias, epilogue=ep, overlap=False)),
            "ms_local": ms(lambda: ops.sma_gemm(a, b, bias=bias,
                                                epilogue=ep, mesh=False))}


def dist_pipeline(dev, world: int) -> dict:
    """(b): pipeline_apply over 2 stages of full-width StableLM layers, 4
    microbatches of (1, TRAIN_SEQ), against the same layers run unpipelined
    on one rank; one tick's send dropped (zeros sent) caught."""
    from repro_torch.distributed import collectives
    from repro_torch.distributed import pipeline as dpipe
    from repro_torch.launch.mesh import Mesh
    cfg = dataclasses.replace(get_config(ARCH), num_groups=DIST_PIPE_LAYERS)
    params = lm.init(cfg, seed=0, device=dev)
    blocks = params["blocks"][0]
    per = DIST_PIPE_LAYERS // world
    staged = tree_map(lambda t: t.reshape((world, per) + t.shape[1:]),
                      blocks)
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(DIST_MICRO, 1, TRAIN_SEQ, cfg.d_model, generator=gen,
                    device=dev).to(torch.bfloat16)

    def stage_fn(p, h):
        for g in range(per):
            h = lm._block(tree_map(lambda t: t[g], p), "attn", h, cfg)
        return h

    mesh = Mesh((world,), ("stage",))
    with torch.no_grad():
        ops.reset_counts()
        collectives.reset_counts()
        got = dpipe.pipeline_apply(stage_fn, mesh, "stage", staged, x)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        calls = collectives.CALLS["sendrecv"]
        want = torch.stack([_unpiped(stage_fn, staged, xi, world)
                            for xi in x])
        orig, ticks = dpipe.collectives.sendrecv, [0]

        def dropped(y, key, dst, src, span="comm.sendrecv"):
            ticks[0] += 1
            if ticks[0] == 2:              # the second tick's hand-off
                y = torch.zeros_like(y)
            return orig(y, key, dst, src, span=span)

        dpipe.collectives.sendrecv = dropped
        try:
            bad = dpipe.pipeline_apply(stage_fn, mesh, "stage", staged, x)
        finally:
            dpipe.collectives.sendrecv = orig
    return {"equal": torch.equal(got, want), "sendrecv_calls": calls,
            "launches": launches,
            "err": (got.float() - want.float()).abs().max().item(),
            "fault_err": (bad.float() - want.float()).abs().max().item(),
            "finite": bool(torch.isfinite(got).all())}


def _unpiped(stage_fn, staged, xi, world):
    """The pipeline's stages run in turn on one rank."""
    for s in range(world):
        xi = stage_fn(tree_map(lambda t: t[s], staged), xi)
    return xi


def dist_unmeshed(dev) -> dict:
    """(c)'s reference: train() of :func:`dist_run` unmeshed, the global
    batch on this rank alone (both ranks run one at once, so the two
    histories also read the run-to-run noise)."""
    cfg, loop = dist_run()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    result = train(cfg, loop, device=dev)
    torch.cuda.synchronize()
    _KEPT["unmeshed masters"] = result["params"]     # for (f)
    return {"history": result["history"], "engine": result["engine"],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


#: What a rank keeps from one sub-check for a later one (never returned).
_KEPT = {}


class measured_init:
    """Within it, ``train(mesh=)``'s ``lm.init_blocks`` records this
    process's device memory: ``peak`` (peak allocated from the window's
    start to the blocks' return, less what was allocated at its start),
    ``blocks`` (what the blocks added) and ``leaf`` (the largest whole
    leaf's bytes at the masters' dtype), then resets the peak, so the
    peak read after ``train`` is the steps'."""

    def __enter__(self):
        self.orig, self.out = lm.init_blocks, {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()

        def measured(cfg, layout, **kw):
            blocks = self.orig(cfg, layout, **kw)
            torch.cuda.synchronize()
            shapes = leaves(lm.abstract_params(cfg, kw.get("dtype")))
            self.out.update(
                base_gib=base / 2**30,
                peak_gib=(torch.cuda.max_memory_allocated() - base) / 2**30,
                blocks_gib=(torch.cuda.memory_allocated() - base) / 2**30,
                leaf_gib=max(p.numel() * p.element_size()
                             for p in shapes) / 2**30)
            torch.cuda.reset_peak_memory_stats()
            return blocks

        lm.init_blocks = measured
        return self.out

    def __exit__(self, *exc):
        lm.init_blocks = self.orig


def dist_train(mesh, dev, fault: bool = False) -> dict:
    """(c): train(mesh=) of :func:`dist_run` for TRAIN_STEPS steps (FSDP
    over the 2 ranks' data axis, each rank's blocks drawn directly): the
    history (with each step's master digests), the masters' and moments'
    local shapes, launches, step times, peak memory after initialisation
    and in the steps (:class:`measured_init`), the collectives' bytes by
    span and those staged through host; the gathered masters' largest
    leaf gap from this rank's unmeshed run (:func:`gap`), the replicated
    leaves against rank 0's bit for bit, and on rank 0 the two unmeshed
    runs' own gap (rank 1's masters broadcast).  ``fault``:
    DIST_FSDP_FAULT_STEPS steps with two planted faults.  Every FSDP
    gather's gradient is this rank's block of its own partial gradient,
    with no sum over data (the reduce-scatter returns its input's block;
    the replicas stay equal, each block being one rank's), read at every
    step against the limits.  At the last step rank 1 keeps its local
    gradient of the first norm scale (it still joins the all-reduce; the
    scales are not split), so the replicas part there; its gathered
    masters' gap is read too."""
    from repro_torch.distributed import collectives
    steps = DIST_FSDP_FAULT_STEPS if fault else TRAIN_STEPS
    cfg, loop = dist_run(steps)
    shapes = lm.abstract_params(cfg, cfg.parameter_dtype)
    norm_grad = (cfg.num_groups, cfg.d_model)     # a stacked norm scale's
    per_step = sum(tuple(p.shape) == norm_grad for p in leaves(shapes))
    orig_reduce, orig_scatter, count = (collectives._run_all_reduce,
                                        collectives._run_reduce_scatter, [0])

    def kept_local(x, key, op, span):
        out = orig_reduce(x, key, op, span)
        if tuple(x.shape) == norm_grad:
            count[0] += 1
            if count[0] == per_step * (steps - 1) + 1 and mesh.rank == 1:
                return x.contiguous().clone()   # the local gradient
        return out

    def no_sum(x, key, dim, span):
        n = x.shape[dim] // collectives.size_of(key)
        return x.narrow(dim, collectives.index_of(key) * n,
                        n).contiguous()

    if fault:
        collectives._run_all_reduce = kept_local
        collectives._run_reduce_scatter = no_sum
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_counts()
    collectives.reset_counts()
    try:
        with measured_init() as init:
            result = train(cfg, loop, device=dev, mesh=mesh)
    finally:
        collectives._run_all_reduce = orig_reduce
        collectives._run_reduce_scatter = orig_scatter
    torch.cuda.synchronize()
    out = {"history": result["history"], "init": init,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": ops.launch_counts(), "engine": result["engine"],
           "bytes": dict(collectives.BYTES),
           "staged_bytes": dict(collectives.STAGED_BYTES),
           "staged_ms": dict(collectives.STAGED_MS),
           "calls": dict(collectives.CALLS),
           "routes": dict(collectives.ROUTES), "layers": cfg.num_layers}
    dp = result["plan"]
    # The gathered masters against this rank's unmeshed run, one whole
    # leaf at a time; the replicated leaves (a split leaf's blocks each
    # live on one rank) bit for bit against rank 0's.
    init = leaves(lm.init(cfg, seed=loop.seed, device=dev,
                          dtype=cfg.parameter_dtype))
    key = mesh.group_key("data")
    gaps, same = [], True
    for p, sh, u, i in zip(leaves(result["params"]), leaves(dp.layout),
                           leaves(_KEPT["unmeshed masters"]), init):
        if sh.splits:
            whole = dp.gather(p, sh, span="comm.masters_check")
            gaps.append(gap(whole, u, i))
            del whole
        else:
            gaps.append(gap(p, u, i))
            same &= torch.equal(p, collectives.broadcast(
                p, key, 0, span="comm.masters_check"))
    out["masters_gap"] = max(gaps)
    if fault:
        return out
    out["replicated_equal"] = same
    # The two unmeshed runs' own gap: rank 1's masters to rank 0.
    out["pair_gap"] = max(
        gap(u, collectives.broadcast(u, key, 1, span="comm.masters_check"),
            i) for u, i in zip(leaves(_KEPT["unmeshed masters"]), init))
    del init
    # Each rank's masters and moments: its blocks of every split leaf.
    split = wrong = 0
    for p, m, sh, w in zip(leaves(result["params"]),
                           leaves(result["opt"]["m"]), leaves(dp.layout),
                           leaves(shapes)):
        split += "data" in sh.axes()
        want = sh.local_shape(w.shape)
        if tuple(p.shape) != want or tuple(m.shape) != want:
            wrong += 1
    out["blocks"] = {"split": split, "leaves": len(leaves(dp.layout)),
                     "wrong_shape": wrong}
    return out


def dist_front_door(mesh, dev) -> dict:
    """(e): sma_jit(lm.forward) with SMAOptions(mesh=) at full width and
    DIST_JIT_LAYERS layers, B x S = TRAIN_BATCH x TRAIN_SEQ, against the
    single-rank compiled forward; the report's comm bytes against
    summa_comm_stats over its sites and against the comm.bcast_* spans of
    a profiled call."""
    from repro_torch import SMAOptions, sma_jit
    from repro_torch.compiler.dispatch import collect_comm_sites
    from repro_torch.distributed.summa import summa_comm_stats, summa_grid
    cfg = dataclasses.replace(get_config(ARCH), num_groups=DIST_JIT_LAYERS)
    params = lm.init(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                         generator=gen, device=dev, dtype=torch.int32)
    batch = {"tokens": toks}
    fwd = functools.partial(lm.forward, cfg=cfg)
    with torch.no_grad():
        want = sma_jit(fwd)(params, batch=batch)
        eng = sma_jit(fwd, options=SMAOptions(mesh=mesh))
        ops.reset_counts()
        got = eng(params, batch=batch)
        torch.cuda.synchronize()
        sharded = ops.ROUTED.get(ops.SHARDED_REASON, 0)
        launches = ops.launch_counts()
        cm = eng.compile(params, batch=batch)
        comm = cm.report["comm"]
        _, _, pr, pc = summa_grid(mesh)
        sites = collect_comm_sites(cm.rewritten)
        want_bytes = sum(summa_comm_stats(
            s["m"], s["n"], s["k"], pr=pr, pc=pc, itemsize_a=s["itemsize_a"],
            itemsize_b=s["itemsize_b"])["bytes_total"] for s in sites)
        with repro_torch.profile() as prof:
            eng(params, batch=batch)
        span_bytes = sum(e["args"]["bytes"] for e in prof.events
                         if e["name"].startswith("comm.bcast_"))
    err = max((g.float() - w.float()).abs().max().item()
              for g, w in zip(got.split(1), want.split(1)))
    return {"err": err, "finite": bool(torch.isfinite(got).all()),
            "sharded_calls": sharded, "sites": len(sites),
            "report_bytes": comm["bytes_total"], "want_bytes": want_bytes,
            "span_bytes": span_bytes, "plan_bytes": comm["plan_comm_bytes"],
            "launches": launches, "grid": comm["grid"]}


def dist_psum(mesh, dev, world: int) -> dict:
    """(d): compressed_psum of CUDA f32 tensors of a full-width gradient's
    size against the f32 mean, within one scale step a rank."""
    from repro_torch.optim.compress import compressed_psum
    xs = []
    for r in range(world):
        gen = torch.Generator(device=dev).manual_seed(100 + r)
        xs.append(torch.randn(*DIST_PSUM_SHAPE, generator=gen, device=dev)
                  * (r + 1))
    got = compressed_psum(xs[mesh.rank], mesh, "data")
    want = torch.stack(xs).mean(0)
    limit = sum(x.abs().max().item() / 127.0 for x in xs) / world
    return {"err": (got - want).abs().max().item(), "limit": limit,
            "finite": bool(torch.isfinite(got).all())}


# ---- (f)-(i): tensor parallelism by the rules ------------------------------
def tp_run(kind: str, steps: int = TRAIN_STEPS):
    """The model and loop of a tensor-parallel run and of its unmeshed
    reference: "stablelm" (c)'s; "qwen3" the "train qwen3" phase's;
    "recurrentgemma" one group cut to TP_RG_PATTERN at the "train
    recurrentgemma" phase's B x S; "stablelm 2x2" TP_MESH_LAYERS layers at
    the trainer's B x S."""
    if kind == "stablelm":
        return dist_run(steps)
    if kind == "qwen3":
        cfg = dataclasses.replace(get_config(QWEN3_ARCH),
                                  num_groups=QWEN3_TRAIN_LAYERS)
        seq, batch = QWEN3_TRAIN_SEQ, QWEN3_TRAIN_BATCH
    elif kind == "recurrentgemma":
        cfg = dataclasses.replace(get_config(RG_ARCH),
                                  block_pattern=TP_RG_PATTERN, num_groups=1)
        seq, batch = RG_TRAIN_SEQ, RG_TRAIN_BATCH
    else:
        cfg = dataclasses.replace(get_config(ARCH),
                                  num_groups=TP_MESH_LAYERS)
        seq, batch = TRAIN_SEQ, TRAIN_BATCH
    return cfg, TrainLoopConfig(steps=steps, seq_len=seq,
                                global_batch=batch, log_every=1, seed=0,
                                peak_lr=TRAIN_LR, remat=True)


def tp_unmeshed(dev, kind: str) -> dict:
    """An unmeshed reference of :func:`tp_run`'s ``kind`` on this rank."""
    cfg, loop = tp_run(kind)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    result = train(cfg, loop, device=dev)
    torch.cuda.synchronize()
    return {"history": result["history"],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def plant_tp_fault(fault, cfg, mesh):
    """Plant a fault in the step the next ``train(mesh=)`` traces; returns
    the undo.  "mlp g skipped": layer 0's MLP output is this rank's partial
    sum (its *g* left out); "router not summed": the gate values the
    combine reads skip *f*, so the router's gradient keeps only this rank's
    experts' part; "head blocks swapped": every step's update of the head
    takes the other rank's block of its gradient (2 ranks: each rank's
    vocab columns move as the other's should, the replicas stay equal)."""
    from repro_torch.distributed import collectives
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.models import moe
    from repro_torch.optim import adamw
    if fault == "head blocks swapped":
        orig_update = adamw.update

        def swapped(grads, state, params, ocfg, **kw):
            w = grads["head"]["w"]              # this rank's vocab columns
            ax = tp.ModelAxis(mesh.group_key("model"), mesh.shape["model"],
                              mesh.coords["model"])
            n = w.shape[-1]
            both = collectives.all_gather(w, ax.key, dim=-1,
                                          span="comm.fault")
            other = both.narrow(-1, (ax.index + 1) % ax.size * n, n)
            grads = {**grads, "head": {**grads["head"], "w": other}}
            return orig_update(grads, state, params, ocfg, **kw)

        adamw.update = swapped
        return lambda: setattr(adamw, "update", orig_update)
    if fault == "mlp g skipped":
        orig, calls = lm.gated_mlp_apply, [0]

        def skipped(params, x, d_ff):
            calls[0] += 1
            if calls[0] > 1:
                return orig(params, x, d_ff)
            exit_ = tp.ModelAxis.exit
            tp.ModelAxis.exit = lambda self, y, span="comm.tp_exit": y
            try:
                return orig(params, x, d_ff)
            finally:
                tp.ModelAxis.exit = exit_

        lm.gated_mlp_apply = skipped
        return lambda: setattr(lm, "gated_mlp_apply", orig)
    if fault == "router not summed":
        orig_tp = moe.tp

        class NoGateEnter(tp.ModelAxis):
            def enter(self, x, span="comm.tp_enter"):
                if x.dtype == torch.float32 and \
                        x.shape[-1] == cfg.moe.top_k:      # the gates
                    return x
                return super().enter(x, span)

        def split_of(local, whole):
            ax = orig_tp.split_of(local, whole)
            return ax and NoGateEnter(ax.key, ax.size, ax.index)

        moe.tp = types.SimpleNamespace(split_of=split_of)
        return lambda: setattr(moe, "tp", orig_tp)
    return lambda: None


def kernel_shapes(cm) -> dict:
    """The compiled step's kernel sites a step by entry and local shape
    (``M x K -> N`` a product; the query's (B, H, S, D) for flash; (B, S,
    D) for a scan)."""
    from repro_torch.compiler.dispatch import _module_sites
    from repro_torch.compiler.lower import op_name, val
    from repro_torch.compiler.rewrite import FusedGemm
    out = collections.Counter()
    for item in _module_sites(cm.module):
        if isinstance(item, FusedGemm):
            a = val(item.inputs[0])
            w = val(item.inputs[2 if item.kind == "prologue" else 1])
            m = int(np.prod(a.shape[:-1]))
            out[f"{item.entry} {m}x{w.shape[0]}->{w.shape[1]}"] += 1
        else:
            x = val(item.args[0])
            out[f"{op_name(item)} {tuple(x.shape)}"] += 1
    return dict(out)


def gap(a, b, init) -> float:
    """||a - b|| / ||b - init|| of one leaf (the gap over the update)."""
    return ((a.float() - b.float()).norm()
            / (b.float() - init.float()).norm().clamp(min=1e-30)).item()


def dist_tp(mesh, dev, kind: str, fault=None) -> dict:
    """(f)-(i): train(mesh=) of :func:`tp_run`'s ``kind`` on ``mesh`` for
    TRAIN_STEPS steps, each rank's blocks drawn directly (``fault``:
    :func:`plant_tp_fault`'s fault, for DIST_FAULT_STEPS steps but "head
    blocks swapped"): the history, the replicated leaves' digests by
    step, launches, routes and local shapes, the bytes and milliseconds
    staged, the report's comm bytes a step against ``collectives.BYTES``,
    peak memory after initialisation and in the steps.  For (f) and its
    "head blocks swapped" run also the gathered masters against the
    unmeshed run this rank made in (c)."""
    from repro_torch.distributed import collectives
    short = fault in ("mlp g skipped", "router not summed")
    cfg, loop = tp_run(kind, DIST_FAULT_STEPS if short else TRAIN_STEPS)
    undo = plant_tp_fault(fault, cfg, mesh)
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_counts()
    collectives.reset_counts()
    try:
        with captured_compiles() as built, measured_init() as init:
            result = train(cfg, loop, device=dev, mesh=mesh)
    finally:
        undo()
    torch.cuda.synchronize()
    plan = result["plan"]
    split = [bool(sh.splits) for sh in leaves(plan.tp)]
    out = {"history": result["history"], "layers": cfg.num_layers,
           "init": init,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": ops.launch_counts(),
           "gemm_routes": nonzero(kgemm.ROUTES),
           "flash_routes": {"fwd": nonzero(kflash.FWD_ROUTES),
                            "bwd": nonzero(kflash.BWD_ROUTES)},
           "norm_routes": nonzero(knorm.ROUTES),
           "scan_routes": {"fwd": nonzero(krglru.ROUTES),
                           "bwd": nonzero(krglru.BWD_ROUTES)},
           "routed": dict(ops.ROUTED),
           "staged_bytes": dict(collectives.STAGED_BYTES),
           "staged_ms": dict(collectives.STAGED_MS),
           "calls": dict(collectives.CALLS),
           "routes": dict(collectives.ROUTES),
           "bytes": dict(collectives.BYTES),
           "report": built[0].report_data["comm"]["collectives"],
           "engine": result["engine"], "compiles": len(built),
           "shapes": kernel_shapes(built[0]),
           "split": [sum(split), len(split)],
           "replicated": [[d for d, sp in zip(h["masters_digest"], split)
                           if not sp] for h in result["history"]],
           "coords": dict(mesh.coords)}
    if kind != "stablelm" or short:
        return out
    # The gathered masters against the unmeshed runs' of (c) (the last
    # run to read them lets them go).
    opt = result.pop("opt")
    del opt, built
    gc.collect()
    whole = leaves(plan.whole(result["params"]))
    del result
    init = leaves(lm.init(cfg, seed=loop.seed, device=dev,
                          dtype=cfg.parameter_dtype))
    mine = leaves(_KEPT["unmeshed masters"] if fault is None
                  else _KEPT.pop("unmeshed masters"))
    out["masters_gap"] = max(gap(w, u, i)
                             for w, u, i in zip(whole, mine, init))
    return out


def dist_tp_refs(dev, rank: int, plan: dict) -> dict:
    """The unmeshed references of (g) and (h), one run at a time on the
    card (each near half of it): Qwen3's on rank 0 unless the "train
    qwen3" phase's came in ``plan`` (``--only-distributed`` runs no such
    phase), then RecurrentGemma's on rank 1."""
    import torch.distributed as tdist
    out = {}
    if rank == 0 and "qwen3" not in plan["refs"]:
        out["qwen3"] = tp_unmeshed(dev, "qwen3")
    gc.collect()
    torch.cuda.empty_cache()        # the other rank's run needs the card
    tdist.barrier()
    if rank == 1:
        out["recurrentgemma"] = tp_unmeshed(dev, "recurrentgemma")
    gc.collect()
    torch.cuda.empty_cache()
    tdist.barrier()
    return out


def dist_tp_refs4(dev, rank: int) -> dict:
    """(i)'s unmeshed references: ranks 0 and 1 at once."""
    import torch.distributed as tdist
    out = tp_unmeshed(dev, "stablelm 2x2") if rank < 2 else {}
    gc.collect()
    torch.cuda.empty_cache()
    tdist.barrier()
    return out


# ---------------------------------------------------------------------------
# Serving on a mesh: (j) RecurrentGemma-2B on 1 x 2, context parallelism;
# (k) StableLM-2-1.6B on 2 x 2
# ---------------------------------------------------------------------------
#: Each cell at full width and depth, random bf16 weights from seed 0:
#: ``launch.common``'s prefill cell of ``seq`` (caches of seq +
#: DECODE_MARGIN), then SERVE_MESH_STEPS decode steps, for each prompt.
#: (j)'s ring of 2,048 slots is 1,024 a rank; its 4,096-token prompt is a
#: multiple of the window (the ring wraps), and its 1,020-token prompt lies
#: below rank 1's first slot, so rank 1 starts empty and its decode crosses
#: into rank 1's slots at step 5.
SERVE_MESH = {"rg": {"arch": RG_ARCH, "mesh": (1, 2), "batch": 2,
                     "seq": 4096, "prompts": {"long": 4096, "short": 1020}},
              "stablelm": {"arch": ARCH, "mesh": (2, 2), "batch": 4,
                           "seq": 512, "prompts": {"prompt": 512}}}
SERVE_MESH_STEPS = 16
#: max |logits - the unmeshed run's| of a meshed prefill or decode step,
#: same card and seed (the row-parallel partial sums are rounded to bf16
#: before their all-reduce).
SERVE_MESH_LIMIT = 0.25
#: (j)'s KV caches after the decode steps against the unmeshed run's
#: blocks: the largest ||meshed - unmeshed|| / ||unmeshed|| of one slot's
#: key (a row's head), over every slot of every local layer (a slot the
#: unmeshed cache holds as zeros and the meshed one does not reads as
#: 1e6).  Each planted fault (a SERVE_MESH_FAULT_STEPS-step run from the
#: same relaid-out state) must read above this limit or SERVE_MESH_LIMIT:
#: a dropped merge moves the logits, a slot written by the wrong rank the
#: cache (one key in a window of 2,048 barely moves the logits).
SERVE_MESH_CACHE_LIMIT = 0.25
SERVE_MESH_FAULT_STEPS = 8
#: (j)'s planted faults and the prompt whose state each runs from.
SERVE_MESH_FAULTS = {"merge drops the other rank's partial": "long",
                     "every rank writes the slot": "long",
                     "owner computed from the local slot": "short"}


def serve_mesh_tokens(cfg, batch: int, prompt: int, dev):
    """A prompt and one token a decode step, from seed 0."""
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=g)
    nxt = torch.randint(0, cfg.vocab_size, (SERVE_MESH_STEPS, batch, 1),
                        generator=g)
    return toks.to(dev, torch.int32), nxt.to(dev, torch.int32)


def kv_keys(state) -> list:
    """The key caches of a state's attention positions, on the host."""
    return [entry["k"].cpu() for entry in state if "k" in entry]


def serve_mesh_ref(cfg, dev, spec: dict) -> dict:
    """The unmeshed ``lm.prefill`` and decode steps of each prompt of a
    (j) / (k) cell on whole parameters: logits a step (float32, host), and
    (j)'s key caches after the last step and after
    SERVE_MESH_FAULT_STEPS steps."""
    from repro_torch.launch.common import DECODE_MARGIN
    params = lm.init(cfg, seed=0, device=dev)
    out = {}
    for name, prompt in spec["prompts"].items():
        toks, nxt = serve_mesh_tokens(cfg, spec["batch"], prompt, dev)
        logits, state, clen = lm.prefill(params, cfg, {"tokens": toks},
                                         cache_size=spec["seq"]
                                         + DECODE_MARGIN)
        got, mid = [logits.float().cpu()], None
        for i, tok in enumerate(nxt):
            logits, state, clen = lm.decode_step(params, state, clen, cfg,
                                                 {"tokens": tok})
            got.append(logits.float().cpu())
            if i + 1 == SERVE_MESH_FAULT_STEPS and spec["arch"] == RG_ARCH:
                mid = kv_keys(state)
        out[name] = {"logits": got, "fault_keys": mid,
                     "keys": kv_keys(state) if spec["arch"] == RG_ARCH
                     else None}
        del state
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def plant_cp_fault(fault: str, mesh):
    """Plant one of SERVE_MESH_FAULTS in the context-parallel decode;
    returns the undo.  "merge drops the other rank's partial": each rank
    keeps its own slice's attention; "every rank writes the slot": each
    rank takes itself for every slot's owner, so it writes the new key at
    its own local slot too; "owner computed from the local slot": the owner
    read from ``slot % local``, so rank 0 owns every slot."""
    from repro_torch.distributed import context_parallel as cpar
    if fault == "merge drops the other rank's partial":
        orig = cpar.merge
        cpar.merge = lambda out, lse, ax: out
        return lambda: setattr(cpar, "merge", orig)
    orig = cpar.slot_owner
    if fault == "every rank writes the slot":
        me = mesh.coords["model"]
        cpar.slot_owner = lambda slot, local: (torch.full_like(slot, me),
                                               slot % local)
    else:
        cpar.slot_owner = lambda slot, local: ((slot % local) // local,
                                               slot % local)
    return lambda: setattr(cpar, "slot_owner", orig)


def serve_mesh_counts() -> dict:
    """The launches, routes and collectives since the last reset."""
    from repro_torch.distributed import collectives
    return {"launches": nonzero(ops.launch_counts()),
            "decode_routes": nonzero(kdecode.ROUTES),
            "gemm_routes": nonzero(kgemm.ROUTES),
            "norm_routes": nonzero(knorm.ROUTES),
            "flash_routes": nonzero(kflash.FWD_ROUTES),
            "scan_routes": nonzero(krglru.ROUTES),
            "routed": dict(ops.ROUTED),
            "bytes": dict(collectives.BYTES),
            "staged_bytes": dict(collectives.STAGED_BYTES),
            "staged_ms": dict(collectives.STAGED_MS)}


def dist_serve(mesh, dev, kind: str) -> dict:
    """(j) / (k) on this rank (SERVE_MESH[kind]): the unmeshed reference on
    rank 0 while the others wait; this rank's blocks drawn directly
    (``lm.init_blocks``, bit for bit the whole init's blocks); for each
    prompt the prefill cell, the state relaid out from the prefill rules'
    layout to the decode rules', SERVE_MESH_STEPS decode steps (each timed,
    host clock to a synchronize), their logits, launches, routes and
    collectives; (j)'s planted faults, each from a copy of the relaid-out
    state; peak memory."""
    import torch.distributed as tdist
    from repro_torch import convert
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import collectives
    from repro_torch.launch import common
    spec = SERVE_MESH[kind]
    cfg = get_config(spec["arch"])
    out = {"coords": dict(mesh.coords), "layers": cfg.num_layers,
           "local_layers": cfg.num_groups * cfg.block_pattern.count("local")}
    t = time.perf_counter()
    if mesh.rank == 0:
        out["ref"] = serve_mesh_ref(cfg, dev, spec)
    out["ref_s"] = time.perf_counter() - t
    tdist.barrier()
    shapes = {k: ShapeConfig(k, spec["seq"], spec["batch"], k)
              for k in ("prefill", "decode")}
    rules = {k: common.cell_rules(cfg, s, mesh) for k, s in shapes.items()}
    cache = spec["seq"] + common.DECODE_MARGIN
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = lm.init_blocks(cfg, common.param_layout(cfg, rules["prefill"],
                                                     mesh), seed=0,
                            device=dev)
    torch.cuda.synchronize()
    out["blocks_gib"] = (torch.cuda.memory_allocated() - base) / 2**30
    prefill = common.make_prefill_step(cfg, cache, rules["prefill"], mesh)
    decode = common.make_decode_step(cfg, cache, rules["decode"], mesh)
    src = common.state_layout(cfg, shapes["prefill"], rules["prefill"], mesh)
    dst = common.state_layout(cfg, shapes["decode"], rules["decode"], mesh)
    kv = next(entry["k"] for entry in dst if "k" in entry)
    out["cache_split"] = [[sp[0], list(sp[1]), sp[2]] for sp in kv.splits]
    out["key_layouts"] = [entry["k"] for entry in dst if "k" in entry]
    runs = {}
    for name, prompt in spec["prompts"].items():
        toks, nxt = serve_mesh_tokens(cfg, spec["batch"], prompt, dev)
        run = {}
        ops.reset_counts()
        collectives.reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, state, clen = prefill(params, common.batch_rows(
            {"tokens": toks}, rules["prefill"], mesh))
        torch.cuda.synchronize()
        run["prefill_s"] = time.perf_counter() - t
        run["prefill"] = serve_mesh_counts()
        state = convert.relayout_state(state, src, dst)
        start = (tree_map(torch.clone, state), clen.clone())

        def steps(state, clen, n=SERVE_MESH_STEPS):
            got, times = [], []
            for tok in nxt[:n]:
                t = time.perf_counter()
                logits, state, clen = decode(params, state, clen,
                                             common.batch_rows(
                                                 {"tokens": tok},
                                                 rules["decode"], mesh))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
                got.append(logits.float().cpu())
            return got, times, (kv_keys(state) if kind == "rg" else None)

        ops.reset_counts()
        collectives.reset_counts()
        got, run["step_s"], run["keys"] = steps(
            tree_map(torch.clone, start[0]), start[1].clone())
        run["decode"] = serve_mesh_counts()
        run["logits"] = [logits.float().cpu()] + got
        run["faults"] = {}
        for fault, on in SERVE_MESH_FAULTS.items():
            if kind != "rg" or on != name:
                continue
            undo = plant_cp_fault(fault, mesh)
            try:
                run["faults"][fault] = steps(tree_map(torch.clone, start[0]),
                                             start[1].clone(),
                                             SERVE_MESH_FAULT_STEPS)
            finally:
                undo()
        runs[name] = run
        del state, start
    out["runs"] = runs
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dist_rank(rank: int, world: int, plan: dict) -> dict:
    """One spawned rank of the distributed phase (its results go back to
    the parent through a file)."""
    dev = torch.device(plan["device"])
    torch.backends.cuda.matmul.allow_tf32 = False
    out, times = {"backend": torch.distributed.get_backend(),
                  "started": time.time()}, {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out[name] = fn(*args)
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t

    log = DIST_DIR / f"world{world}" / f"rank{rank}.log"
    with open(log, "w") as f, contextlib.redirect_stdout(f):
        dist_checks(world, plan, dev, timed)
    out["seconds"] = times
    return out


def dist_checks(world: int, plan: dict, dev, timed) -> None:
    """The sub-checks one rank of a ``world``-rank group runs."""
    import torch.distributed as tdist
    from repro_torch.launch.mesh import Mesh, fake_mesh, smoke_mesh
    grid = fake_mesh(world)
    rank = tdist.get_rank()
    timed("summa", dist_summa, grid, dev)
    if world == 4:
        timed("psum", dist_psum, smoke_mesh(), dev, world)
        gc.collect()
        torch.cuda.empty_cache()
        timed("tp_refs", dist_tp_refs4, dev, rank)
        timed("tp 2x2", dist_tp, Mesh((2, 2), ("data", "model")), dev,
              "stablelm 2x2")
        gc.collect()
        torch.cuda.empty_cache()
        timed("serve stablelm", dist_serve, Mesh((2, 2), ("data", "model")),
              dev, "stablelm")
    if world == 2:
        timed("pipeline", dist_pipeline, dev, world)
        timed("front_door", dist_front_door, grid, dev)
        gc.collect()
        torch.cuda.empty_cache()
        timed("unmeshed", dist_unmeshed, dev)
        gc.collect()
        torch.cuda.empty_cache()
        timed("train", dist_train, smoke_mesh(), dev)
        gc.collect()
        torch.cuda.empty_cache()
        timed("train_fault", dist_train, smoke_mesh(), dev, True)
        tp_mesh = Mesh((1, 2), ("data", "model"))
        for name, kind, fault in (
                ("tp stablelm", "stablelm", None),
                ("tp fault masters", "stablelm", "head blocks swapped"),
                ("tp fault mlp", "stablelm", "mlp g skipped"),
                ("tp_refs", None, None),
                ("tp qwen3", "qwen3", None),
                ("tp fault router", "qwen3", "router not summed"),
                ("tp recurrentgemma", "recurrentgemma", None)):
            gc.collect()
            torch.cuda.empty_cache()
            if kind is None:
                timed(name, dist_tp_refs, dev, rank, plan)
            else:
                timed(name, dist_tp, tp_mesh, dev, kind, fault)
        gc.collect()
        torch.cuda.empty_cache()
        timed("serve rg", dist_serve, tp_mesh, dev, "rg")


def nccl_world_one(dev) -> dict:
    """(d): a world-1 nccl group runs each repro_torch:: collective once."""
    import torch.distributed as tdist
    from repro_torch.distributed import collectives
    from repro_torch.launch.mesh import init_mesh
    DIST_DIR.mkdir(parents=True, exist_ok=True)
    store = DIST_DIR / "nccl_store"
    if store.exists():
        store.unlink()
    mesh = init_mesh((1,), ("data",), rank=0, world=1,
                     init_method=f"file://{store}", device=dev,
                     backend="nccl", timeout=120, verbose=False)
    try:
        key = mesh.group_key("data")
        collectives.reset_counts()
        x = torch.arange(12.0, device=dev).reshape(3, 4)
        op = collectives.COLLECTIVE_OPS        # the custom ops themselves
        outs = [op["all_reduce"](x, key, "sum", "comm.all_reduce"),
                op["broadcast"](x, key, 0, "comm.broadcast"),
                op["all_gather"](x, key, 0, "comm.all_gather"),
                op["sendrecv"](x, key, -1, -1, "comm.sendrecv")]
        torch.cuda.synchronize()
        ok = (torch.equal(outs[0], x) and torch.equal(outs[1], x)
              and torch.equal(outs[2], x) and not outs[3].any())
        return {"backend": mesh.backend, "routes": dict(collectives.ROUTES),
                "calls": dict(collectives.CALLS), "ok": ok}
    finally:
        tdist.destroy_process_group()


def mem_line(run: dict) -> str:
    """A meshed run's memory: the peak after initialisation against its
    blocks plus its largest whole leaf, and the steps' peak."""
    i = run["init"]
    return (f"init peak {i['peak_gib']:.2f} GiB above the {i['base_gib']:.2f}"
            f" held before (blocks {i['blocks_gib']:.2f} + largest whole leaf "
            f"{i['leaf_gib']:.2f}), steps' peak {run['peak_gib']:.2f} GiB")


def check_init_peak(name: str, run: dict) -> None:
    """Initialisation held no more than the rank's blocks and one whole
    leaf, plus 10 %."""
    i = run["init"]
    if i["peak_gib"] > 1.1 * (i["blocks_gib"] + i["leaf_gib"]):
        fail(f"distributed {name}: initialisation peaked at "
             f"{i['peak_gib']:.2f} GiB, past 1.1 x (blocks "
             f"{i['blocks_gib']:.2f} + one whole leaf {i['leaf_gib']:.2f})")


def span_bytes(run: dict) -> str:
    """The collectives' bytes a step by span (GB)."""
    n = len(run["history"])
    return json.dumps({k: round(v / n / 1e9, 4)
                       for k, v in sorted(run["bytes"].items())})


def check_dist_train(ranks: list, card: str, launches) -> None:
    """(c)'s checks on the results of the 2-rank world (``ranks``, in rank
    order); adds the main-path run's launches to ``launches``."""
    trs = [res["train"] for res in ranks]
    hist = trs[0]["history"]
    refs = [res["unmeshed"]["history"] for res in ranks]
    if any(len(ref) != len(hist) for ref in refs):
        fail(f"distributed (c): {len(hist)} logged steps against "
             f"{[len(ref) for ref in refs]} unmeshed")
    for r, tr in enumerate(trs):
        walls = [h["wall_s"] for h in tr["history"]]
        steps = [b - a for a, b in zip(walls, walls[1:])]
        staged = sum(tr["staged_bytes"].values())
        nsteps = len(tr["history"])
        print(f"distributed (c): rank {r}: {ARCH} full width, "
              f"{tr['layers']} layers, FSDP over 2 ranks, B {TRAIN_BATCH} "
              f"global ({TRAIN_BATCH // 2} a rank) x S {TRAIN_SEQ}: losses "
              f"{[h['loss'] for h in tr['history']]}, grad norms "
              f"{[h['grad_norm'] for h in tr['history']]}; step 1 "
              f"{walls[0]:.2f} s (compile), steps 2-{nsteps} "
              f"{[round(x, 3) for x in steps]} s; {mem_line(tr)}; "
              f"collectives' GB a step by span {span_bytes(tr)}; staged "
              f"through host {staged / nsteps / 1e9:.3f} GB a "
              f"step in {sum(tr['staged_ms'].values()) / nsteps:.1f} ms a "
              f"step ({json.dumps(tr['calls'])} calls, routes "
              f"{json.dumps(tr['routes'])}); launches sma_gemm "
              f"{tr['launches']['sma_gemm']}, rmsnorm_gemm "
              f"{tr['launches']['rmsnorm_gemm']}, flash "
              f"{tr['launches']['flash_attention']} / "
              f"{tr['launches']['flash_attention_bwd']}; engine "
              f"{json.dumps(tr['engine'])}; blocks {tr['blocks']} "
              f"({card})")
        # The master digests ride in the history: equal histories are
        # replicas equal at every step.
        if metrics_of(tr["history"]) != metrics_of(hist):
            fail(f"distributed (c): rank {r}'s metrics or master digests "
                 f"differ from rank 0's")
        if not tr["replicated_equal"]:
            fail("distributed (c): the ranks' final replicated masters "
                 "differ")
        bl = tr["blocks"]
        if bl["wrong_shape"] or not bl["split"]:
            fail(f"distributed (c): the masters and moments are not each "
                 f"rank's blocks: {bl}")
        if not (tr["bytes"].get("comm.fsdp_gather")
                and tr["bytes"].get("comm.fsdp_reduce_scatter")) or \
                "comm.master_all_gather" in tr["bytes"]:
            fail(f"distributed (c): not FSDP's collectives: {tr['bytes']}")
        check_init_peak("(c)", tr)
        if tr["engine"]["misses"] != 1:
            fail(f"distributed (c): the step compiled {tr['engine']}")
        for name in ("sma_gemm", "rmsnorm_gemm", "flash_attention",
                     "flash_attention_bwd"):
            launches[name] += tr["launches"][name]
    for r, res in enumerate(ranks):
        un = res["unmeshed"]
        print(f"distributed (c): rank {r}'s unmeshed reference, "
              f"{DIST_TRAIN_LAYERS} layers, B {TRAIN_BATCH} (both ranks at "
              f"once on the card): losses {[h['loss'] for h in un['history']]}"
              f", grad norms {[h['grad_norm'] for h in un['history']]}; peak "
              f"{un['peak_gib']:.2f} GiB; engine {json.dumps(un['engine'])}")

    def limits(drift):
        return "; ".join(f"{i + 1}: {d['loss']:.3g} / {d['grad_norm']:.3g}"
                         for i, d in enumerate(drift))

    drift = dist_drift(hist, refs)
    print(f"distributed (c): relative |loss| / |grad norm| by step in "
          f"multiples of the step's limits (step 1 "
          f"{ {k: STEP_LIMITS[k] for k in DIST_STEP2_LIMITS} }, step 2 "
          f"{DIST_STEP2_LIMITS}, later {DIST_TRAIN_LIMITS}): the two "
          f"unmeshed runs apart {limits(dist_drift(refs[0], refs[1:]))}; "
          f"train(mesh=) from the farther {limits(drift)}")
    if any(v > 1 for d in drift for v in d.values()):
        fail(f"distributed (c): train(mesh=) left the unmeshed history "
             f"(multiples of the limits by step): {drift}")
    fl = [res["train_fault"] for res in ranks]
    same = [a["masters_digest"] == b["masters_digest"]
            for a, b in zip(fl[0]["history"], fl[1]["history"])]
    fdrift = dist_drift(fl[0]["history"], refs)
    print(f"distributed (c): planted faults, {DIST_FSDP_FAULT_STEPS} steps "
          f"at {DIST_TRAIN_LAYERS} layers: (1) every FSDP gather's gradient "
          f"is this rank's block of its own partial gradient, not summed "
          f"over data: rank 0's relative |loss| / |grad norm| in multiples "
          f"of each step's limits {limits(fdrift)}; losses "
          f"{[h['loss'] for h in fl[0]['history']]}, grad norms "
          f"{[h['grad_norm'] for h in fl[0]['history']]}; (2) rank 1 keeps "
          f"its local gradient of the first norm scale at step "
          f"{DIST_FSDP_FAULT_STEPS}: master digests equal across the ranks "
          f"by step {same}")
    if not all(same[:-1]):
        fail("distributed (c): the planted no-sum gather parted the "
             "replicas (it must keep them equal)")
    if max(fdrift[1].values()) <= 1:
        fail(f"distributed (c): a gather whose gradient is not summed over "
             f"data stayed within the limits at step 2 ({fdrift[1]})")
    if same[-1]:
        fail("distributed (c): the planted all-reduce fault was not caught")
    gaps = [tr["masters_gap"] for tr in trs]
    fault_gaps = [f["masters_gap"] for f in fl]
    pair = trs[0]["pair_gap"]
    limit = max(TP_MASTERS_SPREAD * pair, TP_MASTERS_FLOOR)
    print(f"distributed (c): gathered masters against each rank's unmeshed "
          f"run, the largest leaf's ||fsdp - unmeshed|| / ||unmeshed - "
          f"init||: {[round(g, 4) for g in gaps]}; the two unmeshed runs "
          f"apart {pair:.4f}; limit {limit:.4f}; the planted no-sum gather "
          f"{[round(g, 4) for g in fault_gaps]} "
          f"({min(fault_gaps) / limit:.3g} of the limit)")
    if max(gaps) > limit:
        fail(f"distributed (c): the gathered masters part from the unmeshed "
             f"ones: {gaps} > {limit}")
    if min(fault_gaps) <= limit:
        fail(f"distributed (c): the planted no-sum gather's masters read "
             f"{fault_gaps}, within the limit {limit}")


def tp_limits_read(hist: list, refs: list) -> str:
    return "; ".join(f"{i + 1}: {d['loss']:.3g} / {d['grad_norm']:.3g}"
                     for i, d in enumerate(dist_drift(hist, refs)))


def check_tp_run(name: str, runs: list, refs: list, card: str,
                 launches) -> None:
    """One tensor-parallel run's checks on its ranks' results ``runs``
    against the unmeshed histories ``refs``; adds its launches."""
    first = runs[0]
    hist = first["history"]
    cfg_layers, n = first["layers"], len(hist)
    for r, run in enumerate(runs):
        walls = [h["wall_s"] for h in run["history"]]
        steps = [b - a for a, b in zip(walls, walls[1:])]
        staged = sum(run["staged_bytes"].values())
        shapes = sorted(run["shapes"].items(), key=lambda kv: -kv[1])
        print(f"distributed {name}: rank {r} {run['coords']}: "
              f"{cfg_layers} layers; losses "
              f"{[h['loss'] for h in run['history']]}, grad norms "
              f"{[h['grad_norm'] for h in run['history']]}; step 1 "
              f"{walls[0]:.2f} s (compile), steps 2-{n} "
              f"{[round(x, 3) for x in steps]} s; {mem_line(run)}; "
              f"collectives' GB a step by span {span_bytes(run)}; staged "
              f"through host {staged / n / 1e9:.3f} GB a step in "
              f"{sum(run['staged_ms'].values()) / n:.1f} ms a step; calls "
              f"{json.dumps(run['calls'])}; comm bytes a step: report "
              f"{run['report']['bytes_total']}, collectives.BYTES "
              f"{sum(run['bytes'].values()) / n:.0f}; split leaves "
              f"{run['split'][0]} of {run['split'][1]}; launches "
              f"{json.dumps(nonzero(run['launches']))}, sma_gemm "
              f"{run['gemm_routes']}, flash {run['flash_routes']}, head "
              f"{run['norm_routes']}, scan {run['scan_routes']}; local "
              f"shapes a step {json.dumps(dict(shapes))} ({card})")
        if [{k: h[k] for k in ("loss", "grad_norm", "accuracy")}
                for h in run["history"]] != \
                [{k: h[k] for k in ("loss", "grad_norm", "accuracy")}
                 for h in hist]:
            fail(f"distributed {name}: rank {r}'s metrics differ from "
                 f"rank 0's")
        if run["replicated"] != first["replicated"]:
            fail(f"distributed {name}: the replicated leaves part on rank "
                 f"{r}")
        if run["engine"]["misses"] != 1 or run["compiles"] != 1:
            fail(f"distributed {name}: the step compiled {run['engine']}")
        check_init_peak(name, run)
        # The digests' all-reduce (a logged step's, outside the step).
        in_steps = {k: v for k, v in run["bytes"].items()
                    if k != "comm.digest"}
        if {k: v * n for k, v in run["report"]["bytes"].items()} != \
                in_steps:
            fail(f"distributed {name}: the report's comm bytes a step "
                 f"{run['report']['bytes']} do not make the run's "
                 f"{in_steps}")
        counts = run["launches"]
        need = ["sma_gemm", "rmsnorm_gemm", "flash_attention",
                "flash_attention_bwd"]
        if counts.get("rglru_scan_bwd") or "recurrentgemma" in name:
            need += ["rglru_scan", "rglru_scan_bwd"]
        if any(not counts[k] for k in need) or \
                run["gemm_routes"] != {"wgmma": counts["sma_gemm"]} or \
                run["norm_routes"] != {"wgmma": counts["rmsnorm_gemm"]} or \
                run["flash_routes"] != {
                    "fwd": {"wgmma": counts["flash_attention"]},
                    "bwd": {"wgmma": counts["flash_attention_bwd"]}} or \
                run["scan_routes"]["fwd"] != (
                    {"tma": counts["rglru_scan"]}
                    if counts["rglru_scan"] else {}) or \
                run["scan_routes"]["bwd"] != (
                    {"tma": counts["rglru_scan_bwd"]}
                    if counts["rglru_scan_bwd"] else {}):
            fail(f"distributed {name}: kernels {counts} on routes "
                 f"{run['gemm_routes']} {run['flash_routes']} "
                 f"{run['norm_routes']} {run['scan_routes']}")
        other = {k: v for k, v in run["routed"].items()
                 if "gloo stages" not in k}
        if other:
            fail(f"distributed {name}: routed {other}")
        for k in need:
            launches[k] += counts[k]
    drift = dist_drift(hist, refs)
    spread = (f"; the unmeshed runs apart {tp_limits_read(refs[0], refs[1:])}"
              if len(refs) > 1 else "")
    print(f"distributed {name}: relative |loss| / |grad norm| by step in "
          f"multiples of (c)'s limits, from the farther of "
          f"{len(refs)} unmeshed run(s): {tp_limits_read(hist, refs)}"
          f"{spread}")
    if any(v > 1 for d in drift for v in d.values()):
        fail(f"distributed {name}: train(mesh=) left the unmeshed history "
             f"(multiples of the limits by step): {drift}")


def check_tp_fault(name: str, runs: list, refs: list) -> None:
    """A planted fault's 2-step run must read above the limits or part the
    replicas' digests (or the ranks' metrics)."""
    hist = runs[0]["history"]
    drift = dist_drift(hist, refs)
    read = max(v for d in drift for v in d.values())
    parted = [a != b for a, b in zip(runs[0]["replicated"],
                                     runs[1]["replicated"])]
    metrics_part = [a["loss"] != b["loss"] or a["grad_norm"] != b["grad_norm"]
                    for a, b in zip(hist, runs[1]["history"])]
    print(f"distributed planted fault {name}: {tp_limits_read(hist, refs)} "
          f"limits by step (largest {read:.3g}); replicated leaves parted by "
          f"step {parted}; the ranks' loss / grad norm parted by step "
          f"{metrics_part}")
    if read <= 1 and not any(parted) and not any(metrics_part):
        fail(f"distributed: the planted fault {name!r} was not caught")


def check_dist_tp(results: dict, plan: dict, card: str, launches) -> None:
    """(f)-(i) on the ranks' results (module docstring, step 10)."""
    two, four = results[2], results[4]
    refs_c = [res["unmeshed"]["history"] for res in two]
    check_tp_run("(f) stablelm 1x2", [r["tp stablelm"] for r in two],
                 refs_c, card, launches)
    gaps = [r["tp stablelm"]["masters_gap"] for r in two]
    pair = two[0]["train"]["pair_gap"]
    limit = max(TP_MASTERS_SPREAD * pair, TP_MASTERS_FLOOR)
    print(f"distributed (f): gathered masters against each rank's unmeshed "
          f"run, the largest leaf's ||tp - unmeshed|| / ||unmeshed - "
          f"init||: {[round(g, 4) for g in gaps]}; the two unmeshed runs "
          f"apart {pair:.4f}; limit {limit:.4f}")
    if max(gaps) > limit:
        fail(f"distributed (f): the gathered masters part from the unmeshed "
             f"ones: {gaps} > {limit}")
    swapped = [r["tp fault masters"] for r in two]
    fault_gaps = [r["masters_gap"] for r in swapped]
    print(f"distributed planted fault (f) the head's vocab blocks swapped "
          f"in every update: gathered masters "
          f"{[round(g, 4) for g in fault_gaps]} "
          f"({min(fault_gaps) / limit:.3g} of the limit {limit:.4f}); "
          f"{tp_limits_read(swapped[0]['history'], refs_c)} limits by step; "
          f"replicated leaves parted by step "
          f"{[a != b for a, b in zip(*(r['replicated'] for r in swapped))]}")
    if min(fault_gaps) <= limit:
        fail(f"distributed (f): the planted swap of the head's blocks reads "
             f"{fault_gaps}, within the masters limit {limit}")
    q_refs = ([plan["refs"]["qwen3"]] if "qwen3" in plan["refs"]
              else [two[0]["tp_refs"]["qwen3"]["history"]])
    rg_refs = [two[1]["tp_refs"]["recurrentgemma"]["history"]]
    check_tp_run("(g) qwen3 1x2", [r["tp qwen3"] for r in two], q_refs,
                 card, launches)
    check_tp_run("(h) recurrentgemma 1x2",
                 [r["tp recurrentgemma"] for r in two], rg_refs, card,
                 launches)
    refs_i = [r["tp_refs"]["history"] for r in four[:2]]
    check_tp_run("(i) stablelm 2x2", [r["tp 2x2"] for r in four], refs_i,
                 card, launches)
    for r, kind in enumerate(("qwen3", "recurrentgemma")):
        made = two[r]["tp_refs"].get(kind)
        print(f"distributed {'(g)' if r == 0 else '(h)'}: the unmeshed "
              f"reference: " + (f"made here, peak {made['peak_gib']:.2f} "
                                f"GiB" if made else "the train qwen3 "
                                                    "phase's"))
    check_tp_fault("(f) layer 0's MLP g skipped",
                   [r["tp fault mlp"] for r in two], refs_c)
    check_tp_fault("(g) the router's gradient not summed over model",
                   [r["tp fault router"] for r in two], q_refs)


def key_gap(got: list, ref: list, layouts: list) -> float:
    """The largest slot's ||got - ref's block|| / ||ref's block|| over a
    rank's key caches ``got`` (its blocks under ``layouts``) and the whole
    unmeshed ones ``ref``; 1e6 where the unmeshed slot is zero and the
    meshed one is not."""
    worst = 0.0
    for g, w, sh in zip(got, ref, layouts):
        w = sh.local(w).float()
        num = (g.float() - w).norm(dim=-1)
        den = w.norm(dim=-1)
        gap = torch.where(den > 0, num / den.clamp(min=1e-30),
                          torch.where(num > 0, 1e6, 0.0))
        worst = max(worst, gap.max().item())
    return worst


def serve_mesh_errs(got: list, ref: list, rows: slice) -> list:
    """Each step's max |logits - the unmeshed run's| over this rank's
    rows."""
    return [(g - r[rows]).abs().max().item() for g, r in zip(got, ref)]


def check_dist_serve(results: dict, card: str, launches) -> None:
    """(j) and (k) on the ranks' results: every rank's logits of every step
    within SERVE_MESH_LIMIT of the unmeshed run's and (j)'s key caches
    within SERVE_MESH_CACHE_LIMIT of its blocks, each planted fault above
    one of them on some rank; the kernels of the path launched on their routes (the decode
    kernel's ``lse`` route in every local layer of (j), its plain output
    in (k)); adds the main-path runs' launches (the clean meshed runs)."""
    from repro_torch.distributed import collectives
    for kind, world, key in (("rg", 2, "serve rg"),
                             ("stablelm", 4, "serve stablelm")):
        spec = SERVE_MESH[kind]
        ranks = [res[key] for res in results[world]]
        reads = collections.defaultdict(list)
        ref = {k: v["logits"] for k, v in ranks[0]["ref"].items()}
        keys = {k: v["keys"] for k, v in ranks[0]["ref"].items()}
        fault_keys = {k: v["fault_keys"] for k, v in ranks[0]["ref"].items()}
        tag = "(j)" if kind == "rg" else "(k)"
        rows_a_rank = spec["batch"] // spec["mesh"][0]
        for r, res in enumerate(ranks):
            rows = slice(res["coords"]["data"] * rows_a_rank,
                         (res["coords"]["data"] + 1) * rows_a_rank)
            for name, run in res["runs"].items():
                errs = serve_mesh_errs(run["logits"], ref[name], rows)
                gap = (key_gap(run["keys"], keys[name], res["key_layouts"])
                       if kind == "rg" else None)
                d = run["decode"]
                n = SERVE_MESH_STEPS
                print(f"distributed {tag} {spec['arch']} {spec['mesh'][0]} x "
                      f"{spec['mesh'][1]}, {res['layers']} layers, prompt "
                      f"{spec['prompts'][name]} of B {spec['batch']}: rank "
                      f"{r} {res['coords']}: max|logits - unmeshed| prefill "
                      f"{errs[0]:.4g}, decode steps "
                      f"{[round(e, 4) for e in errs[1:]]} (limit "
                      f"{SERVE_MESH_LIMIT}); key caches after the steps "
                      f"{gap if gap is None else round(gap, 4)} of the "
                      f"unmeshed slots (limit {SERVE_MESH_CACHE_LIMIT}); "
                      f"prefill {run['prefill_s']:.3f} "
                      f"s, decode steps (s) "
                      f"{[round(x, 4) for x in run['step_s']]} (median "
                      f"{float(np.median(run['step_s'])):.4f}); collectives' "
                      f"MB a decode step by span "
                      f"{json.dumps({k: round(v / n / 1e6, 4) for k, v in sorted(d['bytes'].items())})}"
                      f", staged {sum(d['staged_bytes'].values()) / n / 1e6:.4f}"
                      f" MB in {sum(d['staged_ms'].values()) / n:.2f} ms; "
                      f"prefill's GB by span "
                      f"{json.dumps({k: round(v / 1e9, 4) for k, v in sorted(run['prefill']['bytes'].items())})}"
                      f"; launches prefill "
                      f"{json.dumps(run['prefill']['launches'])} decode "
                      f"{json.dumps(d['launches'])}, decode routes "
                      f"{d['decode_routes']}, sma_gemm "
                      f"{run['prefill']['gemm_routes']} / {d['gemm_routes']}"
                      f", routed {d['routed']} ({card})")
                if max(errs) > SERVE_MESH_LIMIT or \
                        not all(map(math.isfinite, errs)) or \
                        (gap is not None and gap > SERVE_MESH_CACHE_LIMIT):
                    fail(f"distributed {tag}: rank {r}'s {name} logits or "
                         f"key caches part from the unmeshed run's: {errs}, "
                         f"{gap}")
                steps_local = res["local_layers"] * n
                if kind == "rg":
                    want = {"lse": steps_local}
                    if run["prefill"]["scan_routes"] != {
                            "tma": run["prefill"]["launches"].get(
                                "rglru_scan", 0)} or \
                            not run["prefill"]["launches"].get("rglru_scan"):
                        fail(f"distributed {tag}: the prefill's scans "
                             f"{run['prefill']['scan_routes']}")
                else:
                    want = {"out": res["layers"] * n}
                routed = [{k: v for k, v in c["routed"].items()
                           if k != collectives.STAGED_REASON}
                          for c in (d, run["prefill"])]
                if d["decode_routes"] != want or any(routed):
                    fail(f"distributed {tag}: decode routes "
                         f"{d['decode_routes']} (want {want}), routed "
                         f"{d['routed']} / {run['prefill']['routed']}")
                if set(d["gemm_routes"]) != {"splitk"} or \
                        set(run["prefill"]["gemm_routes"]) != {"wgmma"} or \
                        run["prefill"]["flash_routes"] != {
                            "wgmma": run["prefill"]["launches"].get(
                                "flash_attention", 0)}:
                    fail(f"distributed {tag}: routes prefill "
                         f"{run['prefill']['gemm_routes']} "
                         f"{run['prefill']['flash_routes']}, decode "
                         f"{d['gemm_routes']}")
                for counts in (run["prefill"]["launches"], d["launches"]):
                    for k, v in counts.items():
                        launches[k] += v
                launches["decode_attention lse"] += d["decode_routes"].get(
                    "lse", 0)
                for fault, (got, _, fkeys) in run["faults"].items():
                    ferrs = serve_mesh_errs(got, ref[name][1:], rows)
                    fgap = key_gap(fkeys, fault_keys[name],
                                   res["key_layouts"])
                    read = max(max(ferrs) / SERVE_MESH_LIMIT,
                               fgap / SERVE_MESH_CACHE_LIMIT)
                    reads[fault].append(read)
                    print(f"distributed planted fault {tag} {fault}: rank "
                          f"{r}, max|logits - unmeshed| by step "
                          f"{[round(e, 4) for e in ferrs]}, key caches "
                          f"{fgap:.4g} ({read:.3g} limits)")
            print(f"distributed {tag}: rank {r}: blocks "
                  f"{res['blocks_gib']:.2f} GiB, peak "
                  f"{res['peak_gib']:.2f} GiB; the cache's split "
                  f"{res['cache_split']}; the unmeshed reference "
                  f"{res['ref_s']:.1f} s")
        # A fault is caught where any rank reads it: a slot written by the
        # wrong rank shows in that rank's slice of the cache.
        for fault, got in reads.items():
            if not max(got) > 1:
                fail(f"distributed {tag}: the planted fault {fault!r} was "
                     f"not caught on any rank ({got} limits)")
        if kind == "rg" and ranks[0]["cache_split"] != [[3, ["model"], 2]]:
            fail(f"distributed (j): the local layers' cache is split "
                 f"{ranks[0]['cache_split']}, not by its slots over model")


def distributed(dev, card: str) -> dict:
    """The "distributed" phase (module docstring, step 10): returns the
    phase's launches by kernel, summed over its ranks (the main-path run
    of (c) and the SUMMA, pipeline and front-door calls)."""
    from repro_torch.launch.mesh import spawn
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"distributed: card memory free {free / 2**30:.2f} of "
          f"{total / 2**30:.2f} GiB before the ranks are spawned ({card})")
    seconds = {}
    t = time.perf_counter()
    nccl = nccl_world_one(dev)
    seconds["nccl world 1"] = time.perf_counter() - t
    print(f"distributed (d): world-1 group, backend {nccl['backend']}: "
          f"calls {nccl['calls']}, routes {nccl['routes']}")
    if not nccl["ok"] or nccl["routes"].get("nccl", 0) < 4:
        fail(f"distributed: the world-1 nccl group's collectives: {nccl}")
    plan = {"device": "cuda:0" if dev.type == "cuda" else "cpu",
            "refs": {}}
    if "train qwen3" in TRAIN_HISTORY:
        plan["refs"]["qwen3"] = TRAIN_HISTORY["train qwen3"]
    results = {}
    for world in (2, 4):
        t, wall = time.perf_counter(), time.time()
        results[world] = spawn(dist_rank, world, plan, backend="gloo",
                               device=plan["device"], timeout=DIST_TIMEOUT,
                               workdir=str(DIST_DIR / f"world{world}"))
        seconds[f"world {world}"] = time.perf_counter() - t
        for r, res in enumerate(results[world]):
            print(f"distributed: world {world} rank {r} backend "
                  f"{res['backend']}, running {res['started'] - wall:.1f} s "
                  f"after the spawn, sub-checks (s) "
                  f"{json.dumps({k: round(v, 1) for k, v in res['seconds'].items()})}")
    launches = collections.Counter()
    # (a) SUMMA.
    for world, rs in results.items():
        for r, res in enumerate(rs):
            s = res["summa"]
            print(f"distributed (a): world {world} rank {r} grid {s['grid']}"
                  f": max|err| {s['err']:.4g} ({s['mult']:.3f} limits), "
                  f"overlap == serial {s['equal']}, local launches "
                  f"{s['launches']} {s['routes']}, planted A-panel fault "
                  f"{s['fault_mult']:.1f} limits; {s['ms_overlap']:.3f} ms "
                  f"overlapped, {s['ms_serial']:.3f} serial, one rank's "
                  f"whole product {s['ms_local']:.3f} ({card}); first "
                  f"calls (s) {s['first_s']}")
            if s["mult"] > 1 or not s["equal"]:
                fail(f"distributed (a): SUMMA on {s['grid']} disagrees: {s}")
            if s["launches"] != s["steps"] or \
                    s["routes"] != {"wgmma": s["steps"]}:
                fail(f"distributed (a): the local products {s['routes']}, "
                     f"expected {s['steps']} on wgmma")
            if s["fault_mult"] <= FAULT_MARGIN and r > 0:
                fail(f"distributed (a): a skipped A-panel broadcast was not "
                     f"caught on rank {r} ({s['fault_mult']:.2f} limits)")
            launches["sma_gemm"] += s["launches"]
    # (b) Pipeline.
    for r, res in enumerate(results[2]):
        p = res["pipeline"]
        print(f"distributed (b): rank {r}: pipelined == unpipelined "
              f"{p['equal']} (max|err| {p['err']:.3g}), sendrecv calls "
              f"{p['sendrecv_calls']}, a dropped send moves the output by "
              f"{p['fault_err']:.3g}")
        if not (p["equal"] and p["finite"]) or p["fault_err"] <= LOGIT_ATOL:
            fail(f"distributed (b): pipeline {p}")
        for name in ("sma_gemm", "flash_attention"):
            launches[name] += p["launches"][name]
    # (c) train(mesh=).
    check_dist_train(results[2], card, launches)
    # (d) compressed_psum.
    for r, res in enumerate(results[4]):
        ps = res["psum"]
        print(f"distributed (d): rank {r}: compressed_psum of "
              f"{DIST_PSUM_SHAPE} f32 on 4 ranks: max|err| {ps['err']:.4g} "
              f"against the f32 mean (limit {ps['limit']:.4g})")
        if not ps["finite"] or ps["err"] > ps["limit"]:
            fail(f"distributed (d): compressed_psum {ps}")
    # (e) The front door with a mesh.
    for r, res in enumerate(results[2]):
        fd = res["front_door"]
        print(f"distributed (e): rank {r}: sma_jit(lm.forward) on the "
              f"{fd['grid']} mesh, {DIST_JIT_LAYERS} layers: logits max|err| "
              f"{fd['err']:.4g} against the single-rank compiled forward "
              f"(limit {LOGIT_ATOL}); {fd['sharded_calls']} sharded calls of "
              f"{fd['sites']} sites; comm bytes: report {fd['report_bytes']}"
              f", summa_comm_stats {fd['want_bytes']}, comm.bcast_* spans "
              f"{fd['span_bytes']}, plan {fd['plan_bytes']}")
        if not fd["finite"] or fd["err"] > LOGIT_ATOL:
            fail(f"distributed (e): the meshed forward's logits {fd}")
        if not (fd["report_bytes"] == fd["want_bytes"] == fd["span_bytes"]
                and fd["sharded_calls"] == fd["sites"] > 0):
            fail(f"distributed (e): comm bytes do not reconcile: {fd}")
        for name in ("sma_gemm", "rmsnorm_gemm", "flash_attention"):
            launches[name] += fd["launches"][name]
    # (f)-(i) Tensor parallelism.
    check_dist_tp(results, plan, card, launches)
    # (j), (k) Serving on a mesh.
    check_dist_serve(results, card, launches)
    staged = sum(sum(res["train"]["staged_bytes"].values())
                 for res in results[2])
    print(f"distributed: seconds {json.dumps({k: round(v, 1) for k, v in seconds.items()})}; "
          f"host-staged collectives in (c) {sum(res['train']['routes'].get('host', 0) for res in results[2])} calls, "
          f"{staged / 1e9:.2f} GB over both ranks")
    return dict(launches)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None, metavar="DIR",
                    help="another checkout (e.g. the parent commit unpacked "
                         "into build/parent): time the compiled StableLM "
                         "decode tick's host time of both, A B B A, first")
    ap.add_argument("--only-distributed", action="store_true",
                    help="build and run the distributed phase only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    card = smi_line()
    print(f"card: {card}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {built} in {time.perf_counter() - t0:.1f} s "
          f"into {_build.BUILD_DIR.relative_to(ROOT)}")
    for name in _build.SOURCES:
        for fn, report in ptxas_entries(name, "").items():
            print(f"ptxas {name} {fn}: {report}")

    phases = {"build": time.perf_counter() - t0}
    if args.parent:
        t = time.perf_counter()
        host_time_vs_parent(Path(args.parent).resolve())
        phases["host time vs parent"] = time.perf_counter() - t
    else:
        print("host time against the parent tree: not measured (run with "
              "--parent DIR)")

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        phases[name] = time.perf_counter() - t
        print(f"phase {name}: {phases[name]:.1f} s", flush=True)
        return out

    if args.only_distributed:
        counts = phase("distributed", distributed, dev, card)
        print(f"distributed launches {json.dumps(counts)}")
        print(f"phases (s): "
              f"{json.dumps({k: round(x, 1) for k, x in phases.items()})}")
        return 0

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = phase("kernel checks", lambda: check_sma_gemm(gen, dev,
                                                         SERVE_GEMMS)
                 + check_sma_gemm(gen, dev, TRAIN_GEMMS, " (train)")
                 + check_rmsnorm_gemm(gen, dev) + check_decode(gen, dev)
                 + check_flash(gen, dev))
    torch.cuda.empty_cache()
    rows += phase("mistral-nemo kernel checks", check_nemo_kernels, gen, dev)
    rows += phase("input mode kernel checks", check_input_mode_kernels, gen,
                  dev)
    rows += phase("qwen3 kernel checks", check_qwen3_kernels, gen, dev)
    torch.cuda.empty_cache()
    phase("sma_gemm controls", gemm_controls, gen, dev)
    torch.cuda.empty_cache()
    rows += phase("recurrent kernel checks",
                  lambda: check_rglru(gen, dev) + check_flash_mqa(gen, dev)
                  + check_decode_mqa(gen, dev) + check_decode_lse(gen, dev))
    torch.cuda.empty_cache()
    rows += phase("mlstm kernel checks", check_mlstm, gen, dev)
    torch.cuda.empty_cache()
    rows += phase("rglru backward kernel checks", check_rglru_bwd, gen, dev)
    rows += phase("mlstm backward kernel checks",
                  lambda: check_mlstm_bwd(gen, dev)
                  + check_mlstm_bwd_simt(gen, dev))
    torch.cuda.empty_cache()
    rows += phase("train kernel checks", check_train_kernels, gen, dev)
    torch.cuda.empty_cache()
    for row in rows:
        route = row.get("gemm_route", row.get("kernel_route"))
        route = f" {route}" if route else ""
        extra = "".join(
            f", {key} {row[key]:.4f}" for key in ("paced_ms", "earlier_ms",
                                                  "simt_ms", "matmul_ms",
                                                  "add_ms")
            if key in row)
        print(f"kernel {row['name']}{route} [{row['shape']}]: max|err| "
              f"{row['max_abs_err']:.3g}, {row['ms']:.4f} ms{extra}, plain "
              f"{row['plain_ms']:.4f} ms, library {row['library_ms']}, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        for fn, report in row.get("ptxas", {}).items():
            print(f"  ptxas {fn}: {report}")
        if "smem_bytes" in row:
            print(f"  dynamic shared memory {json.dumps(row['smem_bytes'])} "
                  f"bytes" + (f"; scratch and outputs of one call "
                              f"{row['scratch_peak_bytes'] / 2**30:.3f} GiB"
                              if "scratch_peak_bytes" in row else ""))
    torch.cuda.empty_cache()

    # The serving path, without autograd.
    cfg = get_config(ARCH)
    with torch.inference_mode():
        params = init_full_width(cfg, dev)
        serve_counts, serve_routes, eng = phase("serve", serve, cfg, params,
                                                dev)
        phase("compiled serving", check_compiled_serving, cfg, params, dev,
              eng)
        del eng
        phase("decode logits", check_decode_logits, cfg, params, dev)
        phase("decode profile", profile_decode, cfg, params, dev)
        phase("entry overhead", entry_overhead, cfg, params, dev)
    del params
    torch.cuda.empty_cache()

    # Mistral-NeMo-12B: the dense configs' full-width serving path, under
    # chaos, through the slot Server, and its logits against the plain
    # versions; then launch/serve.py's main(); then the input modes.
    nemo_cfg = dataclasses.replace(get_config(NEMO_ARCH),
                                   num_groups=NEMO_SERVE_LAYERS)
    with torch.inference_mode():
        params = init_full_width(nemo_cfg, dev)
        nemo_counts, nemo_routes, eng = phase(
            "serve mistral-nemo", serve, nemo_cfg, params, dev, "nemo")
        phase("compiled serving mistral-nemo", check_compiled_serving,
              nemo_cfg, params, dev, eng)
        phase("serve chaos", serve_chaos, nemo_cfg, params, dev, eng)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        phase("server shim", server_shim, nemo_cfg, params, dev)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        cfg3 = dataclasses.replace(nemo_cfg, num_groups=NEMO_LOGIT_LAYERS)
        params = lm.init(cfg3, seed=0, device=dev)
        phase("mistral-nemo decode logits", check_decode_logits, cfg3, params,
              dev, NEMO_FAULTS)
        del params
    gc.collect()
    torch.cuda.empty_cache()
    phase("launch.serve main", serve_main)
    gc.collect()
    torch.cuda.empty_cache()
    with torch.inference_mode():
        musicgen_counts = phase("input modes: musicgen", serve_musicgen, dev)
        gc.collect()
        torch.cuda.empty_cache()
        cfg3 = dataclasses.replace(get_config(MUSICGEN_ARCH),
                                   num_groups=INPUT_MODE_LOGIT_LAYERS)
        params = lm.init(cfg3, seed=0, device=dev)
        phase("musicgen decode logits", check_decode_logits, cfg3, params,
              dev)
        del params
    gc.collect()
    torch.cuda.empty_cache()
    with torch.no_grad():
        internvl_counts = phase("input modes: internvl", check_internvl, dev)
        gc.collect()
        torch.cuda.empty_cache()
        cfg3 = dataclasses.replace(get_config(INTERNVL_ARCH),
                                   num_groups=INPUT_MODE_LOGIT_LAYERS)
        params = lm.init(cfg3, seed=0, device=dev)
        phase("internvl forward logits", check_forward_logits, cfg3, params,
              dev)
        del params
    gc.collect()
    torch.cuda.empty_cache()

    # The training path.
    phase("train step vs plain", check_train_step, cfg, dev)
    torch.cuda.empty_cache()
    phase("compiled train step", check_compiled_train_step, cfg, dev)
    torch.cuda.empty_cache()
    phase("train options", check_train_options, cfg, dev)
    torch.cuda.empty_cache()
    train_counts, train_routes, tparams, train_cm = phase(
        "trainer", run_trainer, cfg, dev)
    phase("train step timing", time_train_step, cfg, tparams, train_cm, dev,
          card)
    phase("train profile", profile_train_step, cfg, tparams, dev, train_cm)
    del tparams, train_cm
    torch.cuda.empty_cache()

    # The front door: lm.forward through sma_jit, without autograd.
    with torch.no_grad():
        params = lm.init(cfg, seed=0, device=dev)
        jit_counts = phase("front door", front_door, cfg, params, dev, card)
    del params
    torch.cuda.empty_cache()

    # The recurrent path, without autograd.
    rg_cfg = get_config(RG_ARCH)
    with torch.inference_mode():
        params = init_full_width(rg_cfg, dev)
        rg_counts, rg_routes = phase(
            "serve recurrentgemma", serve_recurrent, rg_cfg, params, dev,
            rg_launches, RG_BATCH, RG_PROMPT, RG_NEW)
        phase("recurrent profile", profile_serving, rg_cfg, params, dev,
              RG_BATCH, RG_PROMPT)
        torch.cuda.empty_cache()
        (rg_eng_counts, rg_eng_routes, eng, want,
         marks) = phase("serve recurrentgemma engine",
                        serve_recurrent_engine, rg_cfg, params, dev,
                        "recurrentgemma engine")
        phase("recurrentgemma engine retry", engine_retry, rg_cfg, eng, want,
              marks, "recurrentgemma engine")
        phase("compiled serving recurrentgemma", check_compiled_recurrent,
              rg_cfg, params, dev, eng, "recurrentgemma engine")
        del params, eng
        gc.collect()
        torch.cuda.empty_cache()
        phase("recurrent logits", check_recurrent_logits, rg_cfg, dev)
        phase("recurrentgemma served logits", check_served_logits, rg_cfg,
              dev, ("rglru", "rglru", "local"), RG_ENGINE_FAULTS,
              RG_LOGIT_ATOL, "recurrentgemma engine")

    # The xLSTM path, without autograd: served at full depth, then
    # profiled and served through its engine at XL_CUT_GROUPS groups (the
    # profile's 6 sLSTM blocks cost ~60 s of the script's time limit,
    # which "train xlstm" needs).
    xl_cfg = get_config(XL_ARCH)
    with torch.inference_mode():
        params = init_full_width(xl_cfg, dev)
        xl_counts, xl_routes = phase("serve xlstm", serve_recurrent, xl_cfg,
                                     params, dev, xl_launches, XL_BATCH,
                                     XL_PROMPT, XL_NEW)
        xl_cfg = dataclasses.replace(xl_cfg, num_groups=XL_CUT_GROUPS)
        params = {**params, "blocks": [tree_map(lambda x: x[:XL_CUT_GROUPS],
                                                b) for b in params["blocks"]]}
        phase("xlstm profile", profile_xlstm, xl_cfg, params, dev)
        torch.cuda.empty_cache()
        xl_eng_counts, xl_eng_routes, eng, _, _ = phase(
            "serve xlstm engine", serve_recurrent_engine, xl_cfg, params,
            dev, "xlstm engine")
        phase("compiled serving xlstm", check_compiled_recurrent, xl_cfg,
              params, dev, eng, "xlstm engine")
        del params, eng
        gc.collect()
        torch.cuda.empty_cache()
        phase("xlstm logits", check_xlstm_logits, xl_cfg, dev)
        phase("xlstm served logits", check_served_logits, xl_cfg, dev,
              ("mlstm", "mlstm", "slstm"), XL_ENGINE_FAULTS, XL_LOGIT_ATOL,
              "xlstm engine")

    # Qwen3-30B-A3B, the MoE path, on a clean card: full width and depth
    # through the compiled engine, then a 3-layer model's logits.
    clean_card("qwen3")
    q_cfg = get_config(QWEN3_ARCH)
    with torch.inference_mode():
        params = phase("init qwen3", init_full_width, q_cfg, dev)
        q_counts, q_routes, eng = phase("serve qwen3", serve, q_cfg, params,
                                        dev, "qwen3")
        phase("compiled serving qwen3", check_compiled_serving, q_cfg,
              params, dev, eng)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        phase("qwen3 decode bounds", moe_decode_bounds, q_cfg, params, dev)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        cfg3 = dataclasses.replace(q_cfg, num_groups=QWEN3_LOGIT_LAYERS)
        params = lm.init(cfg3, seed=0, device=dev)
        phase("qwen3 decode logits", check_moe_logits, cfg3, params, dev)
        del params
    gc.collect()
    torch.cuda.empty_cache()

    # Training beyond the dense family, on a clean card each.
    q_train_counts = phase("train qwen3", train_qwen3, dev, card)
    rg_train_counts = phase("train recurrentgemma", train_recurrentgemma,
                            dev, card)
    xl_train_counts = phase("train xlstm", train_xlstm, dev, card)
    # Distribution: ranks spawned on this card over gloo.
    dist_counts = phase("distributed", distributed, dev, card)
    print(f"phases (s): "
          f"{json.dumps({k: round(x, 1) for k, x in phases.items()})}")

    for row in rows:
        if row.get("kernel_route") == "lse":    # (j)'s route alone
            row["launches_by_path"] = {"distributed": dist_counts.get(
                "decode_attention lse", 0)}
            row["launches"] = row["launches_by_path"]["distributed"]
            if row["launches"] == 0:
                fail("the decode kernel's lse route was not launched on "
                     "(j)'s main path")
            continue
        by_path = {"serve": serve_counts[row["name"]],
                   "train": train_counts[row["name"]],
                   "jit": jit_counts.get(row["name"], 0),
                   "nemo": nemo_counts[row["name"]],
                   "musicgen": musicgen_counts[row["name"]],
                   "internvl": internvl_counts.get(row["name"], 0),
                   "recurrentgemma": rg_counts.get(row["name"], 0),
                   "xlstm": xl_counts.get(row["name"], 0),
                   "recurrentgemma engine": rg_eng_counts.get(row["name"],
                                                              0),
                   "xlstm engine": xl_eng_counts.get(row["name"], 0),
                   "qwen3": q_counts[row["name"]],
                   "train qwen3": q_train_counts[row["name"]],
                   "train recurrentgemma": rg_train_counts[row["name"]],
                   "train xlstm": xl_train_counts[row["name"]],
                   "distributed": dist_counts.get(row["name"], 0)}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
        if row["launches"] == 0:
            fail(f"kernel {row['name']} was not launched on a main path")
    print(f"sma_gemm routes by path: " + json.dumps(
        {"serve": serve_routes, "train": train_routes, "nemo": nemo_routes,
         "recurrentgemma": rg_routes, "xlstm": xl_routes,
         "recurrentgemma engine": rg_eng_routes,
         "xlstm engine": xl_eng_routes, "qwen3": q_routes}))
    print(f"flash routes by path: {json.dumps(FLASH_ROUTES_BY_PATH)}")
    print(f"rmsnorm_gemm, mlstm_chunkwise and rglru_scan routes by path: "
          f"{json.dumps(ROUTES_BY_PATH)}")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
