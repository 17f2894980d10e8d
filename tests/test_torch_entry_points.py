"""Two entry points against the reference's, on the CPU.

* ``launch.train.main(argv)`` with ``--out`` writes ``result["history"]``
  as JSON, as ``repro.launch.train.main`` does (an entry every
  ``TrainLoopConfig.log_every`` = 10 steps and at the last), and still
  prints the step engine's stats.
* ``attention.attn_apply(..., positions=...)`` ropes at the positions it is
  given (default ``arange(S)``), as ``repro.models.attention.attn_apply``
  does: positions offset and strided per batch row against the
  reference's at 1e-5 (f32, the same products summed in another order),
  and the default against arange.  (A uniform shift alone would not show:
  rope's scores depend on position differences only.)
"""
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as C
from repro.models import attention as jattention
from repro.models.layers import Runtime
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.launch import train as launch_train
from repro_torch.models import attention


def test_train_main_writes_history_json(tmp_path, capsys):
    out = tmp_path / "history.json"
    launch_train.main(["--arch", "stablelm-1.6b", "--reduced", "--steps", "11",
                       "--seq-len", "16", "--batch", "2", "--device", "cpu",
                       "--out", str(out)])
    hist = json.loads(out.read_text())
    assert [h["step"] for h in hist] == [10, 11]
    assert all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
               for h in hist)
    assert "[train] engine" in capsys.readouterr().out


@pytest.mark.parametrize("offset", [0, 5, 37])
def test_attn_apply_positions_match_reference(offset):
    jcfg = C.reduced(C.get_config("stablelm-1.6b"))
    tcfg = reduced(get_config("stablelm-1.6b"))
    jparams = jattention.attn_init(jax.random.PRNGKey(3), jcfg)[0]
    tparams = convert.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      tcfg, device="cpu",
                                      dtype=torch.float32)
    b, s = 2, 12
    x = np.random.RandomState(offset).randn(
        b, s, jcfg.d_model).astype(np.float32)
    stride = np.arange(1, b + 1)[:, None] if offset else 1
    pos = (np.arange(s)[None, :] * stride + offset).astype(np.int32)
    want = jattention.attn_apply(jparams, jnp.asarray(x), jcfg, Runtime(),
                                 positions=jnp.asarray(pos))
    got = attention.attn_apply(tparams, torch.from_numpy(x), tcfg,
                               positions=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    plain = attention.attn_apply(tparams, torch.from_numpy(x), tcfg)
    if offset == 0:
        assert torch.equal(plain, got)
    else:
        assert not torch.allclose(plain, got, atol=1e-4)
