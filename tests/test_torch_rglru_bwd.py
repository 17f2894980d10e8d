"""The RG-LRU scan's gradient, on the CPU.

The TPU kernel has no backward; the reference's gradient comes from its
XLA associative scan (``repro.backends.xla_backend.assoc_rglru``).  The
port's is the reverse recurrence of ``ref.rglru_scan_bwd_ref``, which the
``rglru_scan_bwd`` kernel computes on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py`` hold the kernel to it bit for bit).  Here:

* ``ref.rglru_scan_bwd_ref`` equals ``torch.autograd`` of
  ``ref.rglru_scan_ref`` exactly in float32 (the same products and sums,
  each rounded once), with and without h0 and a gradient of h_last;
* it matches ``jax.vjp`` of ``assoc_rglru`` at rtol = atol = 2e-5: the
  associative scan multiplies the decays in another order, and a
  gradient sums up to S such products (S 64);
* ``ops.rglru_scan`` under grad mode goes through
  ``autograd.RgluScan`` (one wrapper call forward, one backward), whose
  gradient is the same; the wrapper runs the plain version for CPU
  tensors and counts no launch;
* inside ``sma_jit`` the scan's backward is one
  ``repro_torch::rglru_scan_bwd`` node, and the mLSTM's one
  ``repro_torch::mlstm_chunkwise_bwd`` node, with the plain versions'
  gradients on the CPU.
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backends.xla_backend import assoc_rglru
from repro_torch import sma_jit
from repro_torch.compiler.lower import op_name
from repro_torch.kernels import autograd, ops, ref
from repro_torch.kernels import rglru as krglru


def _inputs(b=2, s=64, d=24, seed=0, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    a = rng.uniform(0.5, 1.0, (b, s, d)).astype(np.float32)
    u = rng.randn(b, s, d).astype(np.float32)
    h0 = rng.randn(b, d).astype(np.float32)
    dh = rng.randn(b, s, d).astype(np.float32)
    dl = rng.randn(b, d).astype(np.float32)
    return [torch.from_numpy(x).to(dtype) for x in (a, u, h0, dh, dl)]


@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("with_last", [True, False])
def test_bwd_ref_equals_autograd_of_the_plain_scan(with_h0, with_last):
    a, u, h0, dh, dl = _inputs()
    h0 = h0 if with_h0 else None
    dl = dl if with_last else None
    leaves = [t.clone().requires_grad_() for t in (a, u) +
              ((h0,) if with_h0 else ())]
    h_seq, h_last = ref.rglru_scan_ref(*leaves[:2],
                                       leaves[2] if with_h0 else None)
    outs = [(h_seq, dh)] + ([(h_last, dl)] if with_last else [])
    want = torch.autograd.grad([o for o, _ in outs], leaves,
                               [g for _, g in outs])
    da, du, dh0 = ref.rglru_scan_bwd_ref(a, h_seq.detach(), dh, h0, dl)
    assert torch.equal(da, want[0]) and torch.equal(du, want[1])
    if with_h0:
        assert torch.equal(dh0, want[2])
    else:
        assert dh0 is None


@pytest.mark.parametrize("with_h0", [True, False])
def test_bwd_ref_matches_jax_vjp_of_assoc_rglru(with_h0):
    a, u, h0, dh, dl = _inputs(seed=1)
    h0 = h0 if with_h0 else None
    h_seq, _ = ref.rglru_scan_ref(a, u, h0)
    da, du, dh0 = ref.rglru_scan_bwd_ref(a, h_seq, dh, h0, dl)
    args = [jnp.asarray(t.numpy()) for t in (a, u)]
    if with_h0:
        _, vjp = jax.vjp(lambda a_, u_, h_: assoc_rglru(a_, u_, h_),
                         *args, jnp.asarray(h0.numpy()))
    else:
        _, vjp = jax.vjp(lambda a_, u_: assoc_rglru(a_, u_, None), *args)
    want = vjp((jnp.asarray(dh.numpy()), jnp.asarray(dl.numpy())))
    tol = dict(rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(da.numpy(), np.asarray(want[0]), **tol)
    np.testing.assert_allclose(du.numpy(), np.asarray(want[1]), **tol)
    if with_h0:
        np.testing.assert_allclose(dh0.numpy(), np.asarray(want[2]), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_ref_rounds_once_to_the_inputs_dtype(dtype):
    """In a 16-bit dtype the outputs are the f32 results rounded once, and
    h_{t-1} is read from the 16-bit h_seq."""
    a, u, h0, dh, dl = _inputs(dtype=dtype, s=9)
    h_seq, _ = ref.rglru_scan_ref(a, u, h0)
    da, du, dh0 = ref.rglru_scan_bwd_ref(a, h_seq, dh, h0, dl)
    assert da.dtype == du.dtype == dh0.dtype == dtype
    f32 = ref.rglru_scan_bwd_ref(a.float(), h_seq.float(), dh.float(),
                                 h0.float(), dl.float())
    for got, want in zip((da, du, dh0), f32):
        assert torch.equal(got, want.to(dtype))


def test_ops_entry_goes_through_the_function_and_counts_no_cpu_launch(
        monkeypatch):
    a, u, h0, dh, _ = _inputs(s=16)
    seen = collections.Counter()
    for name in ("rglru_scan", "rglru_scan_bwd"):
        orig = getattr(krglru, name)

        def spy(*args, _orig=orig, _name=name, **kw):
            seen[_name] += 1
            return _orig(*args, **kw)
        monkeypatch.setattr(krglru, name, spy)
    ops.reset_counts()
    leaves = [t.clone().requires_grad_() for t in (a, u, h0)]
    h_seq, h_last = ops.rglru_scan(*leaves)
    assert h_seq.grad_fn.name().startswith("RgluScan")
    grads = torch.autograd.grad(h_seq, leaves, dh)
    assert dict(seen) == {"rglru_scan": 1, "rglru_scan_bwd": 1}
    want = ref.rglru_scan_bwd_ref(a, h_seq.detach(), dh, h0)
    for got, w in zip(grads, want):
        assert torch.equal(got, w)
    assert ops.launch_counts()["rglru_scan_bwd"] == 0
    assert krglru.BWD_ROUTES == {"tma": 0, "simt": 0}
    with torch.no_grad():
        out = ops.rglru_scan(a, u, h0)
    assert torch.equal(out[0], h_seq.detach())


def test_bwd_routes_follow_the_forward_rule_and_reset_clears():
    for d, dtype in ((2560, torch.bfloat16), (64, torch.float32)):
        assert krglru._route(2, 4096, d, dtype, True) == "tma"
    assert krglru._route(2, 4096, 130, torch.bfloat16, True) == "simt"
    krglru.BWD_ROUTES["tma"] += 3
    krglru.rglru_scan_bwd.launches += 3
    ops.reset_counts()
    assert krglru.BWD_ROUTES == {"tma": 0, "simt": 0}
    assert krglru.rglru_scan_bwd.launches == 0


def _grad_nodes(eng, *args):
    cm = eng.compile(*args)
    return collections.Counter(op_name(n) for n in cm.traced.graph.nodes
                               if n.op == "call_function"), cm


def test_scan_backward_is_one_node_and_equals_the_direct_gradient():
    a, u, h0, dh, _ = _inputs(s=20)

    def fn(a, u, h0, dh):
        leaves = [t.detach().requires_grad_() for t in (a, u, h0)]
        h_seq, h_last = ops.rglru_scan(*leaves)
        loss = (h_seq * dh).sum() + h_last.float().square().sum()
        return torch.autograd.grad(loss, leaves)

    eng = sma_jit(fn)
    nodes, cm = _grad_nodes(eng, a, u, h0, dh)
    assert nodes["rglru_scan"] == 1 and nodes["rglru_scan_bwd"] == 1
    got = eng(a, u, h0, dh)
    want = fn(a, u, h0, dh)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("state", [False, True])
def test_mlstm_backward_is_one_node_with_the_plain_gradient(state):
    rng = np.random.RandomState(2)
    b, h, s, d = 1, 2, 32, 8
    q, k, v = (torch.from_numpy(rng.randn(b, h, s, d).astype(np.float32))
               for _ in range(3))
    lf = torch.from_numpy(-np.abs(rng.randn(b, h, s)).astype(np.float32))
    li = torch.from_numpy(rng.randn(b, h, s).astype(np.float32))

    def fn(q, k, v, lf, li):
        leaves = [t.detach().requires_grad_() for t in (q, k, v, lf, li)]
        if state:
            out, (c, n, m) = ops.mlstm_chunkwise(*leaves, chunk=16,
                                                 return_state=True)
            loss = out.square().sum() + c.sum() + n.sum()
        else:
            loss = ops.mlstm_chunkwise(*leaves, chunk=16).square().sum()
        return torch.autograd.grad(loss, leaves)

    eng = sma_jit(fn)
    nodes, _ = _grad_nodes(eng, q, k, v, lf, li)
    assert nodes["mlstm_chunkwise_bwd"] == 1
    got = eng(q, k, v, lf, li)
    want = fn(q, k, v, lf, li)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
    direct = autograd.mlstm_chunkwise_backward(
        (q, k, v, lf, li), 16, (2 * ref.mlstm_chunkwise_ref(
            q, k, v, lf, li, chunk=16), None, None, None))
    if not state:
        for g, w in zip(got, direct):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
