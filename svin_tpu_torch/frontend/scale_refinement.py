"""Stereo scale refinement: visual/inertial metric-scale consistency check.

A copy of the JAX package's ``frontend/scale_refinement.py`` (numpy only).

Re-derivation of the reference's one-shot scale estimator
(``okvis_frontend/src/Frontend.cpp:469-614`` "Scale Refinement: Added by
Sharmin", fed by ``runRansac2d2dToRefineScale`` :680-829 and the SVIn
``ImuError::propagation`` overload returning ``acc_doubleintegral /
acc_integral / Δt``): over the first few keyframes it solves one small
linear system relating up-to-scale visual camera positions to IMU
preintegrals, for per-state velocities, gravity, and a global scale ``s``.
In the reference the estimated scale is printed as a diagnostic and
``isScaleRefined_`` is latched (the state is never rescaled) — mirrored
here: `ScaleRefiner.result` carries the estimate, the engine logs it.

Derivation in this codebase's conventions (imu/preintegration.py::propagate):

  p_{i+1} = p_i + v_i Δt − ½ g_W Δt² + C_i Δp_i      (world-frame v, g)
  v_{i+1} = v_i − g_W Δt + C_i Δv_i

with the visual positions entering as p_i = s·p̂_C,i − C_i r_SC (rotation
trusted, translation up to scale). Unknowns x = [v_0..v_{n-1}, g_W, s].
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class ScaleEstimate:
    scale: float
    gravity: np.ndarray  # (3,) estimated world gravity vector
    velocities: np.ndarray  # (n,3) world-frame velocities
    n_states: int

    @property
    def gravity_norm(self) -> float:
        return float(np.linalg.norm(self.gravity))


@dataclass
class ScaleRefiner:
    """Accumulates per-keyframe (vision pose, IMU preintegral) samples and
    solves once enough are present (reference: > 5 states)."""

    min_states: int = 6
    r_SC: np.ndarray = field(default_factory=lambda: np.zeros(3))
    C_WS: List[np.ndarray] = field(default_factory=list)  # (3,3) per state
    p_C: List[np.ndarray] = field(default_factory=list)  # visual cam position
    delta_p: List[np.ndarray] = field(default_factory=list)  # between states
    delta_v: List[np.ndarray] = field(default_factory=list)
    dt: List[float] = field(default_factory=list)
    result: Optional[ScaleEstimate] = None

    @property
    def refined(self) -> bool:
        return self.result is not None

    def add_state(self, C_WS, p_C, delta_p=None, delta_v=None, dt=None) -> None:
        """First state: pose only. Later states: pose + preintegral from the
        previous accumulated state (Δp, Δv in body_i frame, Δt seconds)."""
        if self.refined:
            return
        if self.C_WS and (delta_p is None or dt is None or dt <= 0):
            return  # no usable preintegral bridge — skip this keyframe
        self.C_WS.append(np.asarray(C_WS, float))
        self.p_C.append(np.asarray(p_C, float))
        if len(self.C_WS) > 1:
            self.delta_p.append(np.asarray(delta_p, float))
            self.delta_v.append(np.asarray(delta_v, float))
            self.dt.append(float(dt))
        if len(self.C_WS) >= self.min_states:
            self.result = solve_scale(
                self.C_WS, self.p_C, self.delta_p, self.delta_v, self.dt,
                self.r_SC,
            )

    def reset(self) -> None:
        self.C_WS.clear()
        self.p_C.clear()
        self.delta_p.clear()
        self.delta_v.clear()
        self.dt.clear()


def solve_scale(
    C_WS, p_C, delta_p, delta_v, dt, r_SC
) -> ScaleEstimate:
    """Least-squares solve of the visual-inertial alignment system
    (the reference's LDLT on the 3n+4 block system, Frontend.cpp:524-588;
    the s column is scaled by 1/100 there for conditioning — same here)."""
    n = len(C_WS)
    m = n * 3 + 4  # [v_0..v_{n-1}, g_W, s]
    rows = 6 * (n - 1)
    A = np.zeros((rows, m))
    b = np.zeros(rows)
    S_COL = 1e-2  # column scaling for s (reference divides by 100)
    for i in range(n - 1):
        Ci, Cj = C_WS[i], C_WS[i + 1]
        dti = dt[i]
        rp, rv = 6 * i, 6 * i + 3
        # position rows, from s·p̂_j − C_j r_SC = s·p̂_i − C_i r_SC
        #                       + v_i Δt − ½ g Δt² + C_i Δp_i:
        #   Δt v_i − ½Δt² g − (p̂_j − p̂_i) s = −C_i Δp_i + (C_i − C_j) r_SC
        A[rp:rp + 3, 3 * i:3 * i + 3] = dti * np.eye(3)
        A[rp:rp + 3, 3 * n:3 * n + 3] = -0.5 * dti * dti * np.eye(3)
        A[rp:rp + 3, 3 * n + 3] = -(p_C[i + 1] - p_C[i]) * S_COL
        b[rp:rp + 3] = -Ci @ delta_p[i] + (Ci - Cj) @ r_SC
        # velocity rows: v_i − v_{i+1} − Δt g = −C_i Δv_i
        A[rv:rv + 3, 3 * i:3 * i + 3] = np.eye(3)
        A[rv:rv + 3, 3 * (i + 1):3 * (i + 1) + 3] = -np.eye(3)
        A[rv:rv + 3, 3 * n:3 * n + 3] = -dti * np.eye(3)
        b[rv:rv + 3] = -Ci @ delta_v[i]
    x, *_ = np.linalg.lstsq(A, b, rcond=None)
    return ScaleEstimate(
        scale=float(x[3 * n + 3] * S_COL),
        gravity=x[3 * n:3 * n + 3].copy(),
        velocities=x[: 3 * n].reshape(n, 3).copy(),
        n_states=n,
    )
