"""Published peaks of one NVIDIA H100 SXM and the least time of a kernel.

A copy of ``chip_smoke.py``'s roofline arithmetic, kept with the benchmark
so that a change to the program cannot move it. Peaks: NVIDIA's data sheet,
dense rates, at the full 700 W power limit.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores


def bound(n_bytes: float, n_ops: float, ops_per_s: float = F32_OPS_PER_S) -> tuple:
    """(least time in ms, what bounds it): the larger of the bytes over the
    memory rate and the operations over their rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def spd_solve_bound(D: int) -> tuple:
    """The dense SPD solve of a D x D float32 system: its lower triangle and
    b read and x written once; a Cholesky factorization (D^3 / 3) and two
    triangular solves (2 D^2)."""
    return bound((D * (D + 1) // 2 + 2 * D) * 4, D ** 3 / 3 + 2 * D * D)
