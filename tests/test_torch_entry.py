"""The port's flagship step (``svin_tpu_torch.entry``) against the JAX
package's (``__graft_entry__.entry``), in float64 on the CPU.

The JAX entry's window and factors (its builder draws from ``jax.random``)
are converted to the port and stepped by both packages: positions and cost
within 1e-7 relative plus 1e-9 of the largest entry, the LM loop's bound in
``tests/test_torch_estimator.py`` (the Schur solves round differently and
five LM iterations carry it forward).
"""
import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import entry as jax_entry
from svin_tpu_torch.convert import from_numpy_tree
from svin_tpu_torch.entry import entry
from svin_tpu_torch.estimator import WindowConfig, rig_params
from svin_tpu_torch.estimator.gauss_newton import total_cost
from svin_tpu_torch.problems import IMU_PARAMS, euroc_like_rig
from torch_parity import assert_close

torch.set_num_threads(1)

CFG = WindowConfig(num_states=8, num_landmarks=512, num_obs=4096, max_iterations=5)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a) if isinstance(a, jax.Array) else a, tree)


def test_entry_step_matches_jax():
    jstep, (jw, jf) = jax_entry()
    want_r, want_cost = jax.jit(jstep)(jw, jf)
    step, (window, factors) = entry(device="cpu")
    r, cost = step(from_numpy_tree(_np(jw)), from_numpy_tree(_np(jf)))
    assert r.dtype == torch.float64 and r.shape == (8, 3)
    assert_close(r, want_r, rtol=1e-7, atol_rel=1e-9, name="r")
    assert_close(cost, want_cost, rtol=1e-7, name="cost")
    # the port's own inputs: the shipped shapes, 256 live landmarks, a step
    # that lowers the cost
    assert window.hp_W.shape == (512, 4) and int(window.lm_valid.sum()) == 256
    assert factors.reproj.uv.shape == (4096, 2)
    rig_p = rig_params(euroc_like_rig())
    cost0 = total_cost(window, factors, rig_p, IMU_PARAMS, CFG)
    r2, cost2 = step(window, factors)
    assert torch.isfinite(r2).all() and float(cost2) < float(cost0)


def test_entry_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        assert entry()[1][0].r.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()
