"""The plain reference that decides ``correct``: NumPy, against the
generator's truth (``gen.py``) and against float64 re-computations.

It judges what the timed path returned, once the window has closed; it
imports nothing of the program and takes nothing the program made but the
outputs it judges (and, for the pose graph, the graph the closer built). A
cell compares the numbers its ``limits/<cell>.json`` names; the run prints
the others beside them.

- Engine (the window solve, B1, through the poses ``add_frame`` returns):
  ``ate_m``, the RMS position error of the window's frames after an SE(3)
  alignment to the truth; ``rpe_m``, the RMS error of the relative
  translation over ``RPE_S`` seconds, in the first frame's body axes (free of
  the gauge, so no alignment).
- Window solve (B1), fused matcher (B2) and 4-DoF pose graph, each on calls
  kept from the window (``record.py``): ``solve_berr``, the backward error
  of B1's answers to their own systems in float64, and ``solve_bad``, its
  non-finite answers to systems that float32 can factor; ``match_diff``, the rows
  where the matcher's answer differs from a NumPy popcount matcher's on the
  same descriptors and masks (exact); ``pg_dp_m``, the pose graph's
  positions against a float64 NumPy Gauss-Newton on the same graph (the
  program's own state: the graph the closer built from the keyframes' VIO
  poses and its verified loops).
- Loop closer (``laps``): every loop accepted in the window, its relative
  translation and yaw against the truth (``loop_t_m``, ``loop_yaw_deg``, the
  worst loop); the loop-corrected keyframe positions of the session from
  its first loop on (in the warm-up, as a rule), as the window leaves them,
  against the truth in the prior map's frame (``kf_m``, RMS); the share of
  the window's keyframes that closed a loop (``loop_share``). On a
  transect, ``loops`` counts accepted loops (none is right: no place is
  seen twice).
"""
from __future__ import annotations

import math

import numpy as np

from . import gen

RPE_S = 1.0  # s between the frames of a relative-pose pair


def quat_to_R(q: np.ndarray) -> np.ndarray:
    """Rotation matrices of unit quaternions (..., 4) as (x, y, z, w)."""
    x, y, z, w = (q[..., i] for i in range(4))
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def align_se3(est: np.ndarray, ref: np.ndarray):
    """(R, t) minimizing sum |R est + t - ref|^2 (Umeyama without scale)."""
    me, mr = est.mean(0), ref.mean(0)
    U, _, Vt = np.linalg.svd((ref - mr).T @ (est - me))
    S = np.eye(3)
    S[2, 2] = np.sign(np.linalg.det(U @ Vt))
    R = U @ S @ Vt
    return R, mr - R @ me


def wrap(a):
    return (np.asarray(a) + np.pi) % (2 * np.pi) - np.pi


def engine_numbers(seq: gen.Sequence, t: np.ndarray, p: np.ndarray, q: np.ndarray) -> dict:
    """``ate_m`` and ``rpe_m`` of the frames (t, p_WS, q_WS) the window returned."""
    R_t, p_t = seq.truth(t)
    R, tr = align_se3(p, p_t)
    ate = float(np.sqrt(np.mean(np.sum((p @ R.T + tr - p_t) ** 2, 1))))
    k = int(round(RPE_S * seq.rig.cam_rate))
    if len(t) <= k:
        return {"ate_m": ate, "rpe_m": float("inf")}
    R_e = quat_to_R(q)
    d_e = np.einsum("nji,nj->ni", R_e[:-k], p[k:] - p[:-k])
    d_t = np.einsum("nji,nj->ni", R_t[:-k], p_t[k:] - p_t[:-k])
    rpe = float(np.sqrt(np.mean(np.sum((d_e - d_t) ** 2, 1))))
    return {"ate_m": ate, "rpe_m": rpe}


BIG = 1 << 20  # the matcher's distance for a pair the masks rule out
YAW_WEIGHT, HUBER_DELTA = 0.3, 0.1  # the 4-DoF pose graph's yaw scale and loop-edge Huber
POP8 = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def solve_numbers(solves: list) -> dict:
    """Of the window solves (H, b, x) kept from the window (B1 reads H's
    lower triangle, so H is taken from it), in float64: ``solve_berr``, the
    worst normwise backward error ||b - H x|| / (||H|| ||x|| + ||b||) of the
    finite answers; ``solve_bad``, the answers that are not finite although
    H is positive definite past float32's resolution (smallest eigenvalue
    over D 2^-23 of the largest; exact, 0); ``solve_nan``, the non-finite
    answers to systems below it, as B1 answers a pivot it cannot take."""
    worst, bad, nan_ok, finite = 0.0, 0, 0, 0
    for H, b, x in solves:
        H = np.tril(np.asarray(H, np.float64))
        H = H + np.swapaxes(np.tril(H, -1), -1, -2)
        b, x = np.asarray(b, np.float64), np.asarray(x, np.float64)
        for Hk, bk, xk in zip(H.reshape(-1, *H.shape[-2:]), b.reshape(-1, b.shape[-1]),
                              x.reshape(-1, x.shape[-1])):
            if not np.all(np.isfinite(xk)):
                ev = np.linalg.eigvalsh(Hk) if np.all(np.isfinite(Hk)) else np.array([-1.0, 1.0])
                if ev[0] <= Hk.shape[-1] * 2.0 ** -23 * max(ev[-1], 0.0):
                    nan_ok += 1
                else:
                    bad += 1
                continue
            finite += 1
            r = np.linalg.norm(bk - Hk @ xk)
            den = np.linalg.norm(Hk, 2) * np.linalg.norm(xk) + np.linalg.norm(bk)
            worst = max(worst, float(r / den) if den > 0 else 0.0)
    return {"solve_berr": worst if finite else float("inf"), "solve_bad": float(bad),
            "solve_nan": float(nan_ok)}


def _hamming(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(Na, Nb) Hamming distances of int32 word rows a (Na, W), b (Nb, W)."""
    x = np.ascontiguousarray(a[:, None, :] ^ b[None, :, :]).view(np.uint8)
    return POP8[x].sum(axis=-1, dtype=np.int64)


def match_rows(desc_a, desc_b, valid_a, valid_b, mask, max_distance, ratio, mutual):
    """The matcher's answer (idx_b, dist, valid), one (Na,) row each per
    system: best column by distance under the masks (ties to the lowest
    index), at most ``max_distance``, optionally under the best/second
    ``ratio``, and optionally mutual."""
    a = np.asarray(desc_a).reshape(-1, *np.shape(desc_a)[-2:])
    B = a.shape[0]
    b = np.broadcast_to(desc_b, (B,) + np.shape(desc_b)[-2:])
    va = np.asarray(valid_a).reshape(B, -1)
    vb = np.broadcast_to(valid_b, (B, b.shape[1]))
    out = []
    for k in range(B):
        allowed = va[k][:, None] & vb[k][None, :]
        if mask is not None:
            allowed = allowed & np.asarray(mask).reshape(B, *allowed.shape)[k]
        d = np.where(allowed, _hamming(a[k], b[k]), BIG)
        best = np.argmin(d, axis=1)
        best_d = d[np.arange(d.shape[0]), best]
        ok = best_d <= max_distance
        if ratio > 0.0:
            d2 = d.copy()
            d2[np.arange(d.shape[0]), best] = BIG
            second = d2.min(axis=1)
            ok &= best_d.astype(np.float32) <= np.float32(ratio) * second.astype(np.float32)
        if mutual:
            ok &= np.argmin(d, axis=0)[best] == np.arange(d.shape[0])
        out.append((np.where(ok, best, -1), best_d, ok))
    return out


def match_numbers(matches: list) -> dict:
    """``match_diff``: the rows, over the kept matcher calls, whose answer
    (matched column, validity, and distance where matched) differs from the
    popcount reference's on the same descriptors and masks; exact, 0."""
    bad = 0
    for (da, db, va, vb, mask), (max_d, ratio, mutual), (idx, dist, valid) in matches:
        ref = match_rows(da, db, va, vb, mask, max_d, ratio, mutual)
        idx = np.asarray(idx).reshape(len(ref), -1)
        dist = np.asarray(dist).reshape(len(ref), -1)
        valid = np.asarray(valid).reshape(len(ref), -1)
        for k, (ri, rd, rv) in enumerate(ref):
            diff = (idx[k] != ri) | (valid[k] != rv) | (rv & (dist[k] != rd))
            bad += int(diff.sum())
    return {"match_diff": float(bad)}


def _ypr_to_R(yaw, pitch, roll):
    cy, sy, cp, sp, cr, sr = (np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch),
                              np.cos(roll), np.sin(roll))
    return np.stack([
        np.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], -1),
        np.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], -1),
        np.stack([-sp, cp * sr, cp * cr], -1),
    ], -2)


def _pg4_residual(p, yaw, pitch, roll, ei, ej, t_ij, yaw_ij):
    """(R_i^T per edge, p_j - p_i, the 4-DoF residual (E, 4)) at (p, yaw):
    R_i^T (p_j - p_i) - t_ij and YAW_WEIGHT (yaw_j - yaw_i - yaw_ij) wrapped."""
    Rt = np.swapaxes(_ypr_to_R(yaw[ei], pitch[ei], roll[ei]), -1, -2)
    dp = p[ej] - p[ei]
    r_t = np.einsum("eab,eb->ea", Rt, dp) - t_ij
    r_y = np.arctan2(np.sin(yaw[ej] - yaw[ei] - yaw_ij), np.cos(yaw[ej] - yaw[ei] - yaw_ij))
    return Rt, dp, np.concatenate([r_t, YAW_WEIGHT * r_y[:, None]], axis=1)


def _pg4_graph(nodes: dict, edges: dict):
    """The graph's arrays in float64: (p, yaw, pitch, roll, valid, ei, ej,
    t_ij, yaw_ij, weight, is_loop, e_valid)."""
    return (np.asarray(nodes["p"], np.float64).copy(), np.asarray(nodes["yaw"], np.float64).copy(),
            *(np.asarray(nodes[k], np.float64) for k in ("pitch", "roll")),
            np.asarray(nodes["valid"], bool),
            *(np.asarray(edges[k], np.int64) for k in ("i", "j")),
            np.asarray(edges["t_ij"], np.float64), np.asarray(edges["yaw_ij"], np.float64),
            np.asarray(edges["weight"], np.float64), np.asarray(edges["is_loop"], bool),
            np.asarray(edges["valid"], bool))


def pose_graph_4dof(nodes: dict, edges: dict, fix_before: int, iters: int, sparse: bool = False):
    """(p, yaw) after ``iters`` Gauss-Newton steps on the 4-DoF pose graph
    (position and yaw per node, pitch and roll held; nodes below
    ``fix_before`` and invalid ones fixed), in float64: residual per edge
    R_i^T (p_j - p_i) - t_ij and YAW_WEIGHT (yaw_j - yaw_i - yaw_ij)
    wrapped; loop edges under Huber(HUBER_DELTA) by IRLS; the normal
    equations damped by 1e-6 max(diag, 1), Jacobi-scaled and solved: dense
    by NumPy, or with ``sparse`` (graphs past the dense solve's 512 nodes,
    where a dense step takes seconds) over the free coordinates alone by
    SciPy's sparse LU, the same equations."""
    p, yaw, pitch, roll, valid, ei, ej, t_ij, yaw_ij, weight, is_loop, e_valid = _pg4_graph(
        nodes, edges)
    N = p.shape[0]
    free = valid & (np.arange(N) >= fix_before)
    freed = np.repeat(free, 4).astype(np.float64)
    fixed = 1.0 - freed
    E = ei.shape[0]
    for _ in range(iters):
        Rt, dp, r = _pg4_residual(p, yaw, pitch, roll, ei, ej, t_ij, yaw_ij)
        kd = np.stack([dp[:, 1], -dp[:, 0], np.zeros(E)], axis=-1)
        J = np.zeros((E, 4, 8))
        J[:, :3, :3], J[:, :3, 3], J[:, :3, 4:7] = -Rt, np.einsum("eab,eb->ea", Rt, kd), Rt
        J[:, 3, 3], J[:, 3, 7] = -YAW_WEIGHT, YAW_WEIGHT
        n = np.linalg.norm(r, axis=1)
        hub = np.sqrt(HUBER_DELTA / np.maximum(n, 1e-12))
        w = np.where(e_valid, weight * np.where(is_loop & (n > HUBER_DELTA), hub, 1.0), 0.0)
        J, r = w[:, None, None] * J, w[:, None] * r
        rows = (ei[:, None] * 4 + np.arange(4), ej[:, None] * 4 + np.arange(4))
        if sparse:
            dx = _sparse_step(J, r, rows, freed > 0).reshape(N, 4)
        else:
            H, g = np.zeros((4 * N, 4 * N)), np.zeros(4 * N)
            for a in range(2):
                np.add.at(g, rows[a], np.einsum("era,er->ea", J[..., 4 * a:4 * a + 4], r))
                for c in range(2):
                    blk = np.einsum("era,erb->eab", J[..., 4 * a:4 * a + 4],
                                    J[..., 4 * c:4 * c + 4])
                    np.add.at(H, (rows[a][:, :, None], rows[c][:, None, :]), blk)
            H = H + np.diag(1e-6 * np.maximum(np.diag(H), 1.0) + fixed)
            H = H * freed[:, None] * freed[None, :] + np.diag(fixed)
            g = g * freed
            s = 1.0 / np.sqrt(np.maximum(np.diag(H), 1e-20))
            dx = -(s * np.linalg.solve(H * (s[:, None] * s[None, :]), s * g)).reshape(N, 4)
        p, yaw = p + dx[:, :3], yaw + dx[:, 3]
    return p, yaw


def _sparse_step(J, r, rows, free):
    """The Gauss-Newton update (4N,) of the weighted edge terms J (E, 4, 8),
    r (E, 4) on coordinates ``rows`` (both ends' (E, 4)), over the ``free``
    coordinates (the others 0): the dense step's damping and Jacobi scaling,
    solved by sparse LU."""
    import scipy.sparse
    import scipy.sparse.linalg

    at = np.full(free.shape[0], -1)
    at[free] = np.arange(int(free.sum()))
    g = np.zeros(free.shape[0])
    ii, jj, vv = [], [], []
    for a in range(2):
        np.add.at(g, rows[a], np.einsum("era,er->ea", J[..., 4 * a:4 * a + 4], r))
        for c in range(2):
            blk = np.einsum("era,erb->eab", J[..., 4 * a:4 * a + 4], J[..., 4 * c:4 * c + 4])
            ri = np.broadcast_to(at[rows[a]][:, :, None], blk.shape)
            ci = np.broadcast_to(at[rows[c]][:, None, :], blk.shape)
            keep = (ri >= 0) & (ci >= 0)
            ii.append(ri[keep])
            jj.append(ci[keep])
            vv.append(blk[keep])
    nf = int(free.sum())
    H = scipy.sparse.coo_matrix((np.concatenate(vv), (np.concatenate(ii), np.concatenate(jj))),
                                shape=(nf, nf)).tocsr()
    d = H.diagonal()
    H = H + scipy.sparse.diags(1e-6 * np.maximum(d, 1.0))
    s = 1.0 / np.sqrt(np.maximum(H.diagonal(), 1e-20))
    S = scipy.sparse.diags(s)
    dx = np.zeros(free.shape[0])
    dx[free] = -(s * scipy.sparse.linalg.spsolve((S @ H @ S).tocsc(), s * g[free]))
    return dx


def pose_graph_cost(p, yaw, nodes: dict, edges: dict) -> float:
    """The float64 4-DoF cost at (p, yaw) of the graph (pitch and roll from
    ``nodes``): over valid edges, weight^2 rho(|r|), rho(n) = n^2 on
    sequential edges and Huber on loop edges (n^2 to HUBER_DELTA, 2 delta n -
    delta^2 beyond), the cost whose stationary point the IRLS Gauss-Newton
    seeks."""
    _, _, pitch, roll, _, ei, ej, t_ij, yaw_ij, weight, is_loop, e_valid = _pg4_graph(
        nodes, edges)
    _, _, r = _pg4_residual(np.asarray(p, np.float64), np.asarray(yaw, np.float64), pitch, roll,
                            ei, ej, t_ij, yaw_ij)
    n = np.linalg.norm(r, axis=1)
    rho = np.where(is_loop & (n > HUBER_DELTA), 2 * HUBER_DELTA * n - HUBER_DELTA ** 2, n * n)
    return float(np.sum(np.where(e_valid, weight * weight * rho, 0.0)))


def pose_graph_floor(p, yaw, nodes: dict, edges: dict) -> float:
    """F: what storing (p, yaw) in float32 adds to the cost at a minimum,
    sum over valid edges of weight^2 h |r(float32 p, yaw) - r(p, yaw)|^2, h
    the IRLS weight of ``pose_graph_4dof`` (1, or HUBER_DELTA / |r| on a
    loop edge past it); never negative."""
    _, _, pitch, roll, _, ei, ej, t_ij, yaw_ij, weight, is_loop, e_valid = _pg4_graph(
        nodes, edges)
    p, yaw = np.asarray(p, np.float64), np.asarray(yaw, np.float64)
    _, _, r = _pg4_residual(p, yaw, pitch, roll, ei, ej, t_ij, yaw_ij)
    _, _, r32 = _pg4_residual(p.astype(np.float32).astype(np.float64),
                              yaw.astype(np.float32).astype(np.float64), pitch, roll, ei, ej,
                              t_ij, yaw_ij)
    n = np.linalg.norm(r, axis=1)
    h = np.where(is_loop & (n > HUBER_DELTA), HUBER_DELTA / np.maximum(n, 1e-12), 1.0)
    return float(np.sum(np.where(e_valid, weight * weight * h * np.sum((r32 - r) ** 2, 1), 0.0)))


def pose_graph_numbers(graphs: list) -> dict:
    """``pg_dp_m``: the worst distance, over the window's 4-DoF pose-graph
    solves and their valid nodes, between the position the program's solve
    gave and the float64 reference's from the same graph."""
    worst = 0.0
    for nodes, edges, fix, iters, (p_out, _) in graphs:
        p_ref, _ = pose_graph_4dof(nodes, edges, fix, iters)
        ok = np.asarray(nodes["valid"], bool)
        d = np.linalg.norm(np.asarray(p_out, np.float64)[ok] - p_ref[ok], axis=1)
        worst = max(worst, float(d.max()) if d.size else 0.0)
        if not np.all(np.isfinite(d)):
            return {"pg_dp_m": float("inf")}
    return {"pg_dp_m": worst}


def pcg_numbers(graphs: list) -> dict:
    """Of the window's scalable (PCG) pose-graph solves, each against the
    float64 Gauss-Newton of ``pose_graph_4dof`` on the same graph at the
    same GN count (``ref``), C the float64 cost of ``pose_graph_cost``:

    - ``pg_pcg_excess``: the worst (C(program) - C(ref)) / F, F the cost
      of storing ref's answer in float32 (``pose_graph_floor``), the least
      excess a float32 answer can have: a sound solve ends within a few F,
      one that stops short or drifts ends thousands of F up. (A share of the solve's
      descent, C(input) - C(ref), would not do: a session's first loop
      leaves a graph its alignment already made consistent, whose descent
      is about F.) The cost is blind to a move of the whole graph, the next
      number is not;
    - ``pg_pcg_fixed_m``: the farthest a held node (below ``fix_before``,
      or invalid) moved, which the solve never moves (0);
    - ``pg_pcg_dp_m`` (printed): the worst distance of a valid node to the
      reference's position; a truncated CG is chaotic in its input's last
      bits, so this reads the truncation, not a fault;
    - ``pg_pcg_solves`` (printed): the solves judged."""
    excess, fixed_m, dp_m = 0.0, 0.0, 0.0
    for nodes, edges, fix, iters, (p_out, yaw_out), _cg, _group in graphs:
        if not (np.all(np.isfinite(p_out)) and np.all(np.isfinite(yaw_out))):
            excess = fixed_m = dp_m = math.inf
            break
        p_ref, yaw_ref = pose_graph_4dof(nodes, edges, fix, iters, sparse=True)
        c_ref = pose_graph_cost(p_ref, yaw_ref, nodes, edges)
        floor = pose_graph_floor(p_ref, yaw_ref, nodes, edges)
        c_out = pose_graph_cost(p_out, yaw_out, nodes, edges)
        excess = max(excess, (c_out - c_ref) / max(floor, np.finfo(np.float64).tiny))
        p_in, p_out = (np.asarray(a, np.float64) for a in (nodes["p"], p_out))
        valid = np.asarray(nodes["valid"], bool)
        held = ~(valid & (np.arange(len(valid)) >= fix))
        fixed_m = max(fixed_m, float(np.linalg.norm(p_out[held] - p_in[held], axis=1).max(
            initial=0.0)))
        dp_m = max(dp_m, float(np.linalg.norm(p_out[valid] - p_ref[valid], axis=1).max(
            initial=0.0)))
    return {"pg_pcg_excess": excess, "pg_pcg_fixed_m": fixed_m, "pg_pcg_dp_m": dp_m,
            "pg_pcg_solves": float(len(graphs))}


def loop_numbers(seq: gen.Sequence, loops: list, kf_times: dict, corrected: dict,
                 n_prior: int, window_kfs: int, first_loop: list) -> dict:
    """Loops (query, match, rel_t, rel_yaw) accepted in the window, the
    closer's keyframe timestamps and corrected (r, q) of T_WC by index as
    the window left them, the window's keyframes, and the query keyframe of
    the session's first loop (``[]`` if none)."""

    def true_cam(idx):
        if idx < n_prior:
            return seq.prior_T_WC[idx]
        R_WS, p_WS = seq.truth(np.array([kf_times[idx]]))
        R, p = gen.camera_poses(seq.rig, R_WS, p_WS, 0)
        return R[0], p[0]

    t_err, y_err = [0.0], [0.0]
    for qi, mi, rel_t, rel_yaw in loops:
        Rq, pq = true_cam(qi)
        Rm, pm = true_cam(mi)
        t_err.append(float(np.linalg.norm(np.asarray(rel_t) - Rm.T @ (pq - pm))))
        y_err.append(abs(math.degrees(float(wrap(rel_yaw - wrap(gen.yaw_of(Rq) - gen.yaw_of(Rm)))))))
    kf_sq = [np.sum((np.asarray(corrected[i][0]) - true_cam(i)[1]) ** 2)
             for i in sorted(corrected) if first_loop and i >= first_loop[0]]
    return {
        "loop_t_m": max(t_err), "loop_yaw_deg": max(y_err),
        "kf_m": float(np.sqrt(np.mean(kf_sq))) if kf_sq else float("inf"),
        "loop_share": len(loops) / max(window_kfs, 1),
    }


def judge(numbers: dict, limits: dict):
    """(correct, checks): each number against its limit (``max`` or
    ``min``); a number that is not finite fails."""
    checks, ok = {}, True
    for name, lim in limits.items():
        v = numbers.get(name, float("nan"))
        shown = v if math.isfinite(v) else None  # JSON has no inf or nan
        if "max" in lim:
            good = math.isfinite(v) and v <= lim["max"]
            checks[name] = [shown, "<=", lim["max"]]
        else:
            good = math.isfinite(v) and v >= lim["min"]
            checks[name] = [shown, ">=", lim["min"]]
        ok &= good
    return ok, checks
