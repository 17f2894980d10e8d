"""The loop node's gradient (``repro_torch::scan_loop`` with its reverse
loop node), on the CPU.

``loop.scan`` traced with a gradient (``trace_model`` of a function that
calls ``torch.autograd.grad``) records one forward loop node that saves
its input carries and one reverse loop node whose body is the forward
body's VJP.  Running the traced graph gives the eager Python loop's
gradients bit for bit, for a toy body and for the sLSTM step: the reverse
loop sums the consts' gradients from the last step down, as autograd's
engine does for the eager loop, and runs the same aten ops.  Eagerly the
sLSTM block is the Python loop it was, bit for bit; and the compiled
train step of a reduced xLSTM has as many nodes at S 32 as at S 16, with
per sLSTM block one reverse loop node and two forward ones (the forward
and the remat group's recomputation), each longer than
``max_scan_unroll`` and so costed once x L, not unrolled.
"""
import dataclasses
import functools

import pytest
import torch

from repro_torch.compiler import loop
from repro_torch.compiler.lower import lower_graph
from repro_torch.compiler.trace import trace_model
from repro_torch.configs import get_config, reduced
from repro_torch.data import pipeline as tpipe
from repro_torch.launch.train import make_step
from repro_torch.models import lm
from repro_torch.models import recurrent as R
from repro_torch.optim import adamw


def _toy_body(carry, x, w):
    a, u = x
    new = torch.tanh(carry @ w) * a + u
    return new, new * new


def _toy_eager(h0, a, u, w):
    h, ys = h0, []
    for t in range(a.shape[0]):
        h, y = _toy_body(h, (a[t], u[t]), w)
        ys.append(y)
    return h, torch.stack(ys)


def _grads(run, *args):
    """Gradients of sum(final carry) + sum(ys ** 2) w.r.t. ``args``."""
    live = [t.detach().requires_grad_() for t in args]
    h, ys = run(*live)
    flat_h = torch.cat([t.reshape(-1) for t in
                        (h.values() if isinstance(h, dict) else [h])])
    return torch.autograd.grad(flat_h.sum() + (ys ** 2).sum(), live)


def _traced(run, *args):
    tm = trace_model(lambda *a: _grads(run, *a), *args)
    targets = [n.args[4:] for n in tm.graph.nodes
               if n.target is loop.LOOP_OP]
    return tm, targets


def test_toy_scan_gradient_equals_eager_loop():
    g = torch.Generator().manual_seed(0)
    h0, w = torch.randn(3, 5, generator=g), torch.randn(5, 5, generator=g)
    a, u = torch.rand(7, 3, 5, generator=g), torch.randn(7, 3, 5, generator=g)

    def scanned(h0, a, u, w):
        return loop.scan(_toy_body, h0, (a, u), w)
    tm, nodes = _traced(scanned, h0, a, u, w)
    assert nodes == [(False, True), (True,)]
    got = tm.graph_module(h0, a, u, w)
    want = _grads(_toy_eager, h0, a, u, w)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def _slstm_state(b, h, dh):
    z = torch.zeros((b, h, dh))
    return {"c": z, "n": z + 1e-6, "m": z.clone(), "h": z.clone()}


@pytest.mark.parametrize("steps", [1, 9])
def test_slstm_scan_gradient_equals_eager_loop(steps):
    b, h, dh = 2, 2, 4
    g = torch.Generator().manual_seed(steps)
    r = torch.randn(h, dh, 4 * dh, generator=g)
    wx = torch.randn(b, steps, 4 * h * dh, generator=g)

    def scanned(r, wx):
        return loop.scan(functools.partial(R._slstm_body, h),
                         _slstm_state(b, h, dh), wx.transpose(0, 1), r)

    def eager(r, wx):
        state, hs = _slstm_state(b, h, dh), []
        for t in range(steps):
            state = R._slstm_step(r, wx[:, t], state, h)
            hs.append(state["h"])
        return state, torch.stack(hs)
    tm, nodes = _traced(scanned, r, wx)
    assert nodes == [(False, True), (True,)]
    got = tm.graph_module(r, wx)
    want = _grads(eager, r, wx)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_slstm_block_eager_scan_is_the_python_loop():
    cfg = reduced(get_config("xlstm-1.3b"))
    b, s, d = 2, 11, cfg.d_model
    params = lm.init(cfg, seed=0, device="cpu", dtype=torch.float32)
    slstm = cfg.block_pattern.index("slstm")
    p = params["blocks"][slstm]["mixer"]
    p = {k: v[0] for k, v in p.items()}
    x = torch.randn(b, s, d, generator=torch.Generator().manual_seed(1))
    y, state = R.slstm_block_prefill(p, x, cfg)
    wx = R._slstm_gates(p, x).float()
    want = R.slstm_block_init_state(cfg, b, x.dtype, x.device)
    hs = []
    for t in range(s):
        want = R._slstm_step(p["r_gates"].float(), wx[:, t], want,
                             cfg.num_heads)
        hs.append(want["h"])
    hs = torch.stack(hs, 1).reshape(b, s, d).to(x.dtype)
    assert torch.equal(y, R._slstm_out(p, hs, cfg.num_heads))
    assert all(torch.equal(state[k], want[k]) for k in want)


def test_compiled_xlstm_step_does_not_grow_with_seq():
    cfg = dataclasses.replace(reduced(get_config("xlstm-1.3b")),
                              block_pattern=("mlstm", "slstm"), num_groups=1)
    ocfg = adamw.AdamWConfig(peak_lr=1e-2, warmup_steps=1, total_steps=4)
    params = lm.init(cfg, seed=0, device="cpu", dtype=cfg.parameter_dtype)
    state = (params, adamw.init(params), {})
    counts = []
    for s in (16, 32):
        batch = next(tpipe.DataPipeline(
            tpipe.DataConfig(cfg.vocab_size, s, 2), device="cpu"))
        cm = make_step(cfg, ocfg, remat=True,
                       grad_compression=False).compile(*state, batch)
        loops = [(loop.body_of(n.args[0]).name, n.args[4:])
                 for n in cm.traced.graph.nodes if n.target is loop.LOOP_OP]
        assert sorted(loops) == [("slstm_step", (False, True))] * 2 + [
            ("slstm_step_vjp", (True,))]
        stats = lower_graph(cm.traced.graph, max_scan_unroll=8).stats
        assert (stats.coarsened_scans, stats.unrolled_scans) == (3, 0)
        counts.append(cm.traced.num_nodes)
    assert counts[0] == counts[1]
