"""Taps on the timed path: what its window solve, its descriptor matchers and
its pose graph were given and gave back, kept in the window for the
reference (``reference.py``) to judge once the window has closed.

- The window solve (B1): ``engine.solve(H, b)``, the Jacobi-scaled system of
  every LM iteration; a sample of the calls, drawn from the seed.
- The fused matcher (B2): ``engine.matcher`` (stereo, temporal and map
  matching; a sample drawn from the seed) and ``closer.matcher`` (the loop
  verification's match; every call).
- The 4-DoF pose graph: ``loop_closure.optimize_4dof``, the dense solve
  to 512 nodes, and ``parallel.pcg.optimize_4dof_pcg``, the scalable one
  past them (every solve of each; the closer imports the scalable solver
  at each call, so a patch of its module is seen).

A kept call's tensors are cloned on the device as the call returns (no
host sync in the window); ``collect`` copies them to the host afterwards.
"""
from __future__ import annotations

import random

SOLVE_EVERY = 16  # one window solve in this many is kept, on average
MATCH_EVERY = 16  # one engine matcher call in this many


def _np(t):
    return t.detach().cpu().numpy()


class Tap:
    """Which calls to keep (the seed's draw, only while ``on``) and the kept
    calls."""

    def __init__(self, seed: int, every: int):
        self.rng = random.Random(seed)
        self.every = every
        self.on = False
        self.kept = []

    def want(self) -> bool:
        return self.on and (self.every <= 1 or self.rng.random() * self.every < 1.0)


class Taps:
    def __init__(self, engine, closer, seed: int):
        from svin_tpu_torch.loopclosure import loop_closure
        from svin_tpu_torch.parallel import pcg

        self._lc, self._pcg = loop_closure, pcg
        self.solve = Tap(seed * 3 + 1, SOLVE_EVERY)
        self.match = Tap(seed * 3 + 2, MATCH_EVERY)
        self.verify = Tap(0, 1)
        self.pose_graph = Tap(0, 1)
        self.pose_graph_pcg = Tap(0, 1)
        self._saved = loop_closure.optimize_4dof
        self._saved_pcg = pcg.optimize_4dof_pcg
        engine.solve = self._solve(engine.solve)
        engine.matcher = self._matcher(engine.matcher, self.match)
        closer.matcher = self._matcher(closer.matcher, self.verify)
        loop_closure.optimize_4dof = self._pose_graph(self._saved)
        pcg.optimize_4dof_pcg = self._pose_graph_pcg(self._saved_pcg)

    @property
    def on(self):
        return self.solve.on

    @on.setter
    def on(self, value: bool):
        for t in (self.solve, self.match, self.verify, self.pose_graph, self.pose_graph_pcg):
            t.on = value

    def remove(self):
        """Put the pose-graph solvers back (the engine and closer go with the run)."""
        self._lc.optimize_4dof = self._saved
        self._pcg.optimize_4dof_pcg = self._saved_pcg

    def _solve(self, solve):
        tap = self.solve

        def solve_tapped(H, b):
            x = solve(H, b)
            if tap.want():
                tap.kept.append((H.detach().clone(), b.detach().clone(), x.detach().clone()))
            return x

        return solve_tapped

    @staticmethod
    def _matcher(matcher, tap):
        def matcher_tapped(desc_a, desc_b, valid_a, valid_b, mask=None, max_distance=60,
                           ratio=0.0, mutual=True):
            res = matcher(desc_a, desc_b, valid_a, valid_b, mask=mask,
                          max_distance=max_distance, ratio=ratio, mutual=mutual)
            if tap.want():
                c = lambda t: None if t is None else t.detach().clone()  # noqa: E731
                tap.kept.append(((c(desc_a), c(desc_b), c(valid_a), c(valid_b), c(mask)),
                                 (int(max_distance), float(ratio), bool(mutual)),
                                 (c(res.idx_b), c(res.dist), c(res.valid))))
            return res

        return matcher_tapped

    def _pose_graph(self, optimize):
        tap = self.pose_graph

        def optimize_tapped(nodes, edges, fix_before, iters=10):
            # the closer writes the answer back into its tables, which a CPU
            # run's input tensors share: keep copies taken before the solve
            keep = tap.want()
            if keep:
                ins = tuple(type(t)(*(a.detach().clone() for a in t)) for t in (nodes, edges))
            out = optimize(nodes, edges, fix_before, iters=iters)
            if keep:
                tap.kept.append(ins + (int(fix_before), int(iters),
                                       type(out)(*(a.detach().clone() for a in out))))
            return out

        return optimize_tapped

    def _pose_graph_pcg(self, optimize):
        tap = self.pose_graph_pcg

        def optimize_pcg_tapped(nodes, edges, fix_before, iters=10, cg_iters=64, coarse_group=16):
            keep = tap.want()
            if keep:  # copies taken before the solve, as for the dense one
                ins = tuple(type(t)(*(a.detach().clone() for a in t)) for t in (nodes, edges))
            out = optimize(nodes, edges, fix_before, iters=iters, cg_iters=cg_iters,
                           coarse_group=coarse_group)
            if keep:
                tap.kept.append(ins + (int(fix_before), int(iters),
                                       type(out)(*(a.detach().clone() for a in out)),
                                       int(cg_iters), int(coarse_group)))
            return out

        return optimize_pcg_tapped

    def collect(self) -> dict:
        """The kept calls as host arrays: ``solves`` [(H, b, x)], ``matches``
        [(inputs, (max_distance, ratio, mutual), (idx_b, dist, valid))] of
        the engine and of the closer, and ``pose_graphs`` [(nodes dict, edges
        dict, fix_before, iters, (p, yaw) out)] of the dense solve and
        ``pose_graphs_pcg`` [(the same, cg_iters, coarse_group)] of the
        scalable one."""
        def match_np(kept):
            return [(tuple(None if t is None else _np(t) for t in ins), opts,
                     tuple(_np(t) for t in res)) for ins, opts, res in kept]

        def graphs_np(kept):
            return [({k: _np(v) for k, v in nodes._asdict().items()},
                     {k: _np(v) for k, v in edges._asdict().items()},
                     fix, iters, (_np(out.p), _np(out.yaw))) + tuple(rest)
                    for nodes, edges, fix, iters, out, *rest in kept]

        return {"solves": [tuple(_np(t) for t in s) for s in self.solve.kept],
                "matches": match_np(self.match.kept), "verify_matches": match_np(self.verify.kept),
                "pose_graphs": graphs_np(self.pose_graph.kept),
                "pose_graphs_pcg": graphs_np(self.pose_graph_pcg.kept)}
