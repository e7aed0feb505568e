"""The flagship step of the port: the sliding-window LM + Schur optimizer at
the engine's shipped window shapes (S = 8 states, 512 landmark slots of
which 256 are live, 4096 observation slots, 5 LM iterations), as
``VioEngine`` builds them (``pipeline/vio.py``).

Counterpart of the JAX package's ``__graft_entry__.py::entry``; the window
comes from ``problems.build_window_problem`` seeded from numpy (the JAX
builder draws from ``jax.random``).

    step, (window, factors) = entry()
    r, cost = step(window, factors)
"""
from __future__ import annotations

import numpy as np
import torch

from .estimator import WindowConfig, optimize
from .problems import IMU_PARAMS, build_window_problem


def entry(device=None):
    """(step, (window, factors)): ``step(window, factors)`` runs the LM loop
    and returns (window.r, cost). On ``cuda`` unless another device is named
    (raises without a card); float32 on the card, float64 elsewhere."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("entry: no CUDA device; pass device='cpu'")
    cfg = WindowConfig(num_states=8, num_landmarks=512, num_obs=4096, max_iterations=5)
    window, factors, rig_p, _ = build_window_problem(
        np.random.default_rng(0), cfg, n_landmarks=256,
        dtype=torch.float32 if dev.type == "cuda" else torch.float64, device=dev)

    def step(window, factors):
        res = optimize(window, factors, rig_p, IMU_PARAMS, cfg)
        return res.window.r, res.cost

    return step, (window, factors)
