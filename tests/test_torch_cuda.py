"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (with its reason) where no NVIDIA card is
visible, and runs on one with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

These cover what ``chip_smoke.py`` does not: every dtype route (the f32
CUDA-core path, f16), ragged M/N/K and unaligned operands (the masked
element-by-element loads), every epilogue with bias, GQA and head_dim 128
in the decode and flash kernels, flash rows that see no key, gradients
reaching weights through every kernel entry point, and the serving steps
and a few training steps on the card against the same on the CPU.
Tolerances: the reference's ``tol_for`` (3e-2 for 16-bit outputs, one
rounding flip; 2e-4 for f32, summation order), with TF32 off in the plain
versions.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import DataConfig, DataPipeline
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  paged_decode_attention)
from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                 flash_attention_fwd)
from repro_torch.kernels.norm_gemm import rmsnorm_gemm
from repro_torch.kernels.sma_gemm import sma_gemm
from repro_torch.launch.train import TrainLoopConfig, train
from repro_torch.models import lm
from repro_torch.serving import CacheConfig, PagedKVCache
from repro_torch.serving import model as smodel
from repro_torch.tree import leaves

pytestmark = pytest.mark.cuda

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def tol(dtype):
    return 2e-4 if dtype == torch.float32 else 3e-2


def close(got, want, dtype):
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol(dtype),
                               atol=tol(dtype))


def randn(shape, dtype, dev, seed, scale=1.0, offset=0):
    """Seeded normal values; ``offset`` > 0 places the tensor that many
    elements into a buffer, so its address is not 16-byte aligned."""
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    flat = torch.zeros(x.size + offset, dtype=dtype, device=dev)
    flat[offset:] = torch.from_numpy(x.reshape(-1)).to(dev, dtype)
    return flat[offset:].view(shape)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("m,k,n", [(37, 70, 50), (1, 2048, 130),
                                   (300, 513, 257), (16, 64, 64),
                                   (17, 2048, 2048), (129, 40, 8)])
def test_sma_gemm_matches_plain(dev, dtype, m, k, n):
    dt = DTYPES[dtype]
    a = randn((m, k), dt, dev, 0)
    b = randn((k, n), dt, dev, 1, scale=k ** -0.5)
    bias = randn((n,), torch.float32, dev, 2)
    for ep in ("none", "relu", "gelu", "silu", "tanh"):
        close(sma_gemm(a, b, bias=bias, epilogue=ep),
              ref.gemm_ref(a, b, bias=bias, epilogue=ep), dt)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_sma_gemm_unaligned_operands(dev, dtype):
    """Operands whose addresses are not 16-byte aligned take the masked
    element loads instead of cp.async."""
    dt = DTYPES[dtype]
    a = randn((20, 72), dt, dev, 3, offset=1)
    b = randn((72, 40), dt, dev, 4, scale=72 ** -0.5, offset=3)
    assert a.data_ptr() % 16 and b.data_ptr() % 16
    close(sma_gemm(a, b), ref.gemm_ref(a, b), dt)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("m,k,n", [(8, 2048, 1000), (19, 70, 45),
                                   (64, 256, 384)])
def test_rmsnorm_gemm_matches_plain(dev, dtype, m, k, n):
    dt = DTYPES[dtype]
    x = randn((m, k), dt, dev, 5, scale=3.0)
    scale = randn((k,), torch.float32, dev, 6).abs() + 0.5
    w = randn((k, n), dt, dev, 7, scale=k ** -0.5)
    for ep in ("none", "silu"):
        close(rmsnorm_gemm(x, scale, w, epilogue=ep),
              ref.rmsnorm_gemm_ref(x, scale, w, epilogue=ep), dt)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("hq,hkv,d", [(8, 2, 64), (4, 4, 128), (16, 1, 64)])
def test_paged_decode_matches_plain(dev, dtype, hq, hkv, d):
    dt = DTYPES[dtype]
    bs, mb = 16, 6
    lens = [0, 1, bs, bs + 1, mb * bs, 37]
    b, nb = len(lens), len(lens) * mb + 3
    perm = np.random.default_rng(8).permutation(nb)
    table = np.full((b, mb), nb, np.int32)
    used = 0
    for r, n in enumerate(lens):
        pages = -(-n // bs)
        table[r, :pages] = perm[used:used + pages]
        used += pages
    table = torch.from_numpy(table).to(dev)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = randn((b, hq, d), dt, dev, 9)
    kp = randn((nb, hkv, bs, d), dt, dev, 10)
    vp = randn((nb, hkv, bs, d), dt, dev, 11)
    got = paged_decode_attention(q, kp, vp, table, kv_len)
    close(got, ref.paged_decode_attention_ref(q, kp, vp, table, kv_len), dt)
    assert got[0].abs().max().item() == 0.0
    kc = randn((b, hkv, mb * bs, d), dt, dev, 12)
    vc = randn((b, hkv, mb * bs, d), dt, dev, 13)
    close(decode_attention(q, kc, vc, kv_len),
          ref.decode_attention_ref(q, kc, vc, kv_len), dt)


def test_paged_decode_poisons_reads_outside_the_table(dev):
    """A sentinel entry below kv_len, or kv_len past the table, is not
    clamped into another request's page: that request's output is NaN and
    the other requests' outputs are unchanged."""
    dt = torch.bfloat16
    bs, mb, nb = 16, 4, 12
    table = torch.arange(3 * mb, dtype=torch.int32, device=dev).reshape(3, mb)
    table[1, 1] = nb                                 # sentinel at page 1
    kv_len = torch.tensor([40, 40, mb * bs + 1], dtype=torch.int32,
                          device=dev)
    q = randn((3, 4, 64), dt, dev, 15)
    kp = randn((nb, 4, bs, 64), dt, dev, 16)
    vp = randn((nb, 4, bs, 64), dt, dev, 17)
    got = paged_decode_attention(q, kp, vp, table, kv_len)
    torch.cuda.synchronize()
    assert torch.isnan(got[1:]).all()
    close(got[:1], ref.paged_decode_attention_ref(q[:1], kp, vp, table[:1],
                                                  kv_len[:1]), dt)


def test_serving_steps_on_card_match_cpu(dev):
    """The reduced model (f32) through a ragged prefill and 2 decode steps:
    the kernels on the card against the plain versions on the CPU, fed
    the same tokens, at the f32 tolerance."""
    cfg = reduced(get_config("stablelm-1.6b"))
    cc = CacheConfig(block_size=4, num_blocks=32, max_seq_len=64)
    kv = PagedKVCache(cc, 3)
    for r in range(3):
        assert kv.admit(r, 8, 3)
    table = torch.from_numpy(kv.table_rows([0, 1, 2]))
    toks = torch.from_numpy(np.random.default_rng(14).integers(
        0, cfg.vocab_size, (3, 8)))
    n_tok = torch.tensor([8, 3, 6])

    def run(where, feed=None):
        params = _to(lm.init(cfg, seed=0, device="cpu"), where)
        state = smodel.init_state(cfg, cc, device=where)
        logits, state, cl = smodel.paged_prefill_step(
            params, state, table.to(where),
            torch.zeros(3, dtype=torch.int32, device=where),
            n_tok.to(where), cfg, {"tokens": toks.to(where)})
        outs, fed = [logits.cpu()], []
        for i in range(2):
            nxt = feed[i] if feed else logits.argmax(-1, keepdim=True).cpu()
            fed.append(nxt)
            logits, state, cl = smodel.paged_decode_step(
                params, state, table.to(where), cl, cfg,
                {"tokens": nxt.to(where)})
            outs.append(logits.cpu())
        return outs, fed

    want, fed = run(torch.device("cpu"))
    got, _ = run(dev, fed)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-4)


def _to(tree, device, clone=False):
    if isinstance(tree, dict):
        return {k: _to(v, device, clone) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to(v, device, clone) for v in tree)
    return tree.detach().clone().to(device) if clone else tree.to(device)


# ------------------------------------------------------- flash attention
FLASH_CASES = [
    (2, 4, 4, 256, 256, 64, True, None),
    (1, 8, 2, 200, 200, 64, True, None),     # GQA, ragged S
    (1, 4, 1, 192, 192, 128, True, 64),      # MQA, head_dim 128, window
    (1, 2, 2, 130, 130, 64, False, None),    # non-causal, ragged
    (1, 4, 4, 64, 256, 64, True, None),      # Sq < Skv, end-aligned
    (1, 2, 2, 100, 40, 64, True, None),      # Sq > Skv: rows see no key
]


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", FLASH_CASES)
def test_flash_matches_plain(dev, dtype, b, hq, hkv, sq, skv, d, causal,
                             window):
    """Forward (out, lse) and backward (dq, dk, dv) kernels against the
    plain versions on the same inputs, at the 16-bit tol_for (P is rounded
    to the input dtype for the tensor-core products; dQ is summed with
    atomics in no fixed order)."""
    dt = DTYPES[dtype]
    q = randn((b, hq, sq, d), dt, dev, 20)
    k = randn((b, hkv, skv, d), dt, dev, 21)
    v = randn((b, hkv, skv, d), dt, dev, 22)
    dout = randn((b, hq, sq, d), dt, dev, 23)
    kw = dict(causal=causal, window=window)
    out, lse = flash_attention_fwd(q, k, v, **kw)
    want, want_lse = ref.flash_attention_ref(q, k, v, **kw)
    close(out, want, dt)
    torch.testing.assert_close(lse, want_lse, rtol=1e-3, atol=1e-3)
    grads = flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    wants = ref.flash_attention_bwd_ref(q, k, v, want, want_lse, dout, **kw)
    for got, w in zip(grads, wants):
        close(got, w, dt)
    if sq > skv:
        torch.testing.assert_close(out[:, :, :sq - skv].float(),
                                   torch.zeros_like(out[:, :, :sq - skv],
                                                    dtype=torch.float32))


def test_flash_refuses_what_it_does_not_take(dev):
    q = torch.zeros((1, 2, 8, 64), dtype=torch.float32, device=dev)
    with pytest.raises(ValueError, match="bf16/f16"):
        flash_attention_fwd(q, q, q)
    q = torch.zeros((1, 2, 8, 32), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_fwd(q, q, q)


# ------------------------------------------- gradients through the wrappers
def _grads(fn, leaves_):
    for t in leaves_:
        t.grad = None
    fn().float().square().sum().backward()
    return [t.grad.clone() for t in leaves_]


def test_weights_get_gradients_through_cuda_wrappers(dev):
    """A weight that requires grad gets a .grad through each kernel entry
    point on the card (the wrappers write through ctypes and would cut the
    graph without their autograd Functions), equal to the gradient through
    the plain versions within the 16-bit tolerance."""
    dt = torch.bfloat16
    x = randn((3, 70, 128), dt, dev, 30).requires_grad_()
    w32 = randn((128, 96), torch.float32, dev, 31, scale=128 ** -0.5)
    w32.requires_grad_()
    bias = randn((96,), torch.float32, dev, 32).requires_grad_()
    scale = (randn((128,), torch.float32, dev, 33).abs() + 0.5)
    scale.requires_grad_()
    cases = {
        "sma_gemm": (lambda: ops.sma_gemm(x, w32.to(dt), bias=bias,
                                          epilogue="silu"),
                     lambda: ref.gemm_ref(x, w32.to(dt), bias=bias,
                                          epilogue="silu"),
                     [x, w32, bias]),
        "rmsnorm_gemm": (lambda: ops.rmsnorm_gemm(x, scale, w32.to(dt)),
                         lambda: ref.rmsnorm_gemm_ref(x, scale, w32.to(dt)),
                         [x, scale, w32]),
    }
    q = randn((2, 4, 128, 64), dt, dev, 34).requires_grad_()
    kv = randn((2, 2, 128, 64), dt, dev, 35).requires_grad_()
    cases["flash_attention"] = (
        lambda: ops.flash_attention(q, kv, kv * 0.5),
        lambda: ref.flash_attention_ref(q, kv, kv * 0.5)[0], [q, kv])
    # Launches of one forward and backward: sma_gemm with silu runs the
    # forward, Z again, dA and dB; rmsnorm_gemm's dW and dnormed are
    # sma_gemm launches.
    launches = {"sma_gemm": {"sma_gemm": 4},
                "rmsnorm_gemm": {"rmsnorm_gemm": 1, "sma_gemm": 2},
                "flash_attention": {"flash_attention": 1,
                                    "flash_attention_bwd": 1}}
    for name, (kernel, plain, ins) in cases.items():
        ops.reset_counts()
        got = _grads(kernel, ins)
        counts = {k: n for k, n in ops.launch_counts().items() if n}
        assert counts == launches[name], (name, counts)
        want = _grads(plain, ins)
        for g, w in zip(got, want):
            assert g is not None and g.abs().sum() > 0, name
            scale_ = w.float().abs().max().item()
            torch.testing.assert_close(g.float() / scale_,
                                       w.float() / scale_, rtol=3e-2,
                                       atol=3e-2)


def test_train_steps_on_card_match_cpu(dev):
    """A small bf16 model with head_dim 64 (the flash kernel's), on the
    card (kernels) and on the CPU (plain versions) from the same masters:
    one step's loss within 1e-3 and every weight's gradient within 3e-2
    relative (Frobenius), one step's launches as predicted, and the losses
    of 3 trained steps within 2e-2 relative (bf16 outputs of every product,
    rounded in other orders)."""
    cfg = dataclasses.replace(reduced(get_config("stablelm-1.6b")),
                              d_model=128, num_heads=2, num_kv_heads=2,
                              head_dim=64, d_ff=256, dtype="bfloat16")
    loop = TrainLoopConfig(steps=3, seq_len=96, global_batch=2,
                           log_every=1, remat=True)
    masters = lm.init(cfg, seed=0, device="cpu",
                      dtype=cfg.parameter_dtype)

    def copy(where):
        return _to(masters, where, clone=True)

    def step_grads(where):
        params = copy(where)
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        batch = next(DataPipeline(DataConfig(
            cfg.vocab_size, loop.seq_len, loop.global_batch,
            seed=loop.seed), device=where))
        loss, _ = lm.loss_fn(params, cfg, batch, remat=True)
        grads = torch.autograd.grad(loss, flat)
        return loss.item(), [g.float().cpu() for g in grads]

    want_loss, want_grads = step_grads(torch.device("cpu"))
    got_loss, got_grads = step_grads(dev)
    assert abs(got_loss - want_loss) <= 1e-3 * abs(want_loss)
    for i, (g, w) in enumerate(zip(got_grads, want_grads)):
        assert w.norm() > 0 and g.norm() > 0, i
        assert ((g - w).norm() / w.norm()).item() <= 3e-2, i

    want = train(cfg, loop, device="cpu", params=copy("cpu"))
    ops.reset_counts()
    train(cfg, dataclasses.replace(loop, steps=1), device=dev,
          params=copy(dev))
    layers = cfg.num_layers
    assert ops.launch_counts() == {
        "sma_gemm": 29 * layers + 2, "rmsnorm_gemm": 1,
        "flash_attention": 2 * layers, "flash_attention_bwd": layers,
        "paged_decode_attention": 0, "decode_attention": 0}
    assert not ops.ROUTED
    got = train(cfg, loop, device=dev, params=copy(dev))
    np.testing.assert_allclose([h["loss"] for h in got["history"]],
                               [h["loss"] for h in want["history"]],
                               rtol=2e-2)
