"""The controls and planted faults of the correctness check, run through the
harness at a cell's own size.

  python3 -m portbench.control --workload <cell> --seconds <s> --seeds <n> [<n> ...]
      --variant <name> [--variant <name> ...]

Each (variant, seed) is one run of ``run.main`` in this process, the
variant applied to the engine and the closer between their build and the
first frame; a line per run on standard error gives the checks, and one
JSON line at the end gives every run's numbers. The benchmark's own runs
never apply a variant.

Variants:
- ``sound``: the program as it is.
- ``tf32``: the control, at the next precision below the program's (float32
  with TF32 off): the program's own TF32 path switched on (TF32 matmuls in
  the engine, the closer and the scalable pose graph, whose own guard is
  bypassed), and the window solve's and both pose-graph solves' float
  inputs rounded to TF32's 10-bit mantissa before their float32
  computation, the operand rounding a TF32 factorization puts on them.
- ``frozen``: the window solve returns a zero step, so the LM leaves the
  state as the IMU predicted it (a step that returns its state unchanged).
- ``match_shift``: the engine's matcher answers each keypoint with its
  neighbour's match (an answer altered where it is produced).
- ``pg_shift``: the pose graph's solve, dense or scalable, returns its
  positions 5 cm off (an answer altered where it is produced).
- ``pg_frozen``: the pose graph's solve, dense or scalable, returns the
  nodes it was given (a step that returns its state unchanged).
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import sys

from . import run as bench


def round_tf32(x):
    """x with its mantissa rounded to TF32's 10 bits (float32 or float64)."""
    import torch

    if x.dtype == torch.float64:
        i = x.contiguous().view(torch.int64)
        return ((i + (1 << 41)) & ~((1 << 42) - 1)).view(torch.float64)
    i = x.contiguous().view(torch.int32)
    return ((i + (1 << 12)) & ~((1 << 13) - 1)).view(torch.float32)


def _tf32(engine, closer):
    import torch
    from svin_tpu_torch.loopclosure import loop_closure
    from svin_tpu_torch.parallel import pcg
    from svin_tpu_torch.pipeline import vio

    @contextlib.contextmanager
    def tf32_matmuls():
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        yield

    vio._float32_matmuls = tf32_matmuls
    loop_closure._float32_matmuls = tf32_matmuls
    solve = engine.solve
    engine.solve = lambda H, b: solve(round_tf32(H), round_tf32(b))
    optimize = loop_closure.optimize_4dof

    def optimize_tf32(nodes, edges, fix_before, iters=10):
        r = lambda t: round_tf32(t) if t.is_floating_point() else t  # noqa: E731
        return optimize(type(nodes)(*map(r, nodes)), type(edges)(*map(r, edges)), fix_before,
                        iters=iters)

    loop_closure.optimize_4dof = optimize_tf32
    optimize_pcg = pcg.optimize_4dof_pcg
    unguarded = getattr(optimize_pcg, "__wrapped__", optimize_pcg)  # without its TF32-off block

    def optimize_pcg_tf32(nodes, edges, fix_before, **kw):
        r = lambda t: round_tf32(t) if t.is_floating_point() else t  # noqa: E731
        with tf32_matmuls():
            return unguarded(type(nodes)(*map(r, nodes)), type(edges)(*map(r, edges)), fix_before,
                             **kw)

    pcg.optimize_4dof_pcg = optimize_pcg_tf32


def _frozen(engine, closer):
    import torch

    engine.solve = lambda H, b: torch.zeros_like(b)


def _match_shift(engine, closer):
    import torch

    match = engine.matcher

    def shifted(*a, **k):
        res = match(*a, **k)
        return res._replace(idx_b=torch.roll(res.idx_b, 1, dims=-1))

    engine.matcher = shifted


def _pg_shift(engine, closer):
    from svin_tpu_torch.loopclosure import loop_closure
    from svin_tpu_torch.parallel import pcg

    def shift(optimize):
        def shifted(nodes, edges, fix_before, **kw):
            out = optimize(nodes, edges, fix_before, **kw)
            return out._replace(p=out.p + 0.05)

        return shifted

    loop_closure.optimize_4dof = shift(loop_closure.optimize_4dof)
    pcg.optimize_4dof_pcg = shift(pcg.optimize_4dof_pcg)


def _pg_frozen(engine, closer):
    from svin_tpu_torch.loopclosure import loop_closure
    from svin_tpu_torch.parallel import pcg

    def frozen(nodes, edges, fix_before, **kw):
        return nodes

    loop_closure.optimize_4dof = pcg.optimize_4dof_pcg = frozen


VARIANTS = {"sound": None, "tf32": _tf32, "frozen": _frozen, "match_shift": _match_shift,
            "pg_shift": _pg_shift, "pg_frozen": _pg_frozen}


def run_variant(workload, seed, seconds, variant, root=".", device=None, trace=0):
    """(rc, result dict or None) of one run under ``variant``; the program's
    patched names and the TF32 flags are put back afterwards."""
    import torch
    from svin_tpu_torch.loopclosure import loop_closure
    from svin_tpu_torch.parallel import pcg
    from svin_tpu_torch.pipeline import vio

    saved = (vio._float32_matmuls, loop_closure._float32_matmuls, loop_closure.optimize_4dof,
             pcg.optimize_4dof_pcg)
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = bench.main(["--workload", workload, "--seed", str(seed), "--seconds",
                             str(seconds), "--trace", str(trace)], root=root, device=device,
                            patch=VARIANTS[variant])
    finally:
        (vio._float32_matmuls, loop_closure._float32_matmuls, loop_closure.optimize_4dof,
         pcg.optimize_4dof_pcg) = saved
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 and lines else None)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--variant", action="append", choices=sorted(VARIANTS), required=True)
    a = p.parse_args(argv)
    rows = []
    for variant in a.variant:
        for seed in a.seeds:
            try:
                rc, res = run_variant(a.workload, seed, a.seconds, variant)
            except Exception as e:  # a control that crashes has failed; record it and go on
                rc, res = -1, {"error": repr(e)}
            rows.append({"variant": variant, "seed": seed, "rc": rc, "result": res})
            checks = (res or {}).get("checks")
            print(f"control {a.workload} {variant} seed {seed}: rc {rc} "
                  f"correct {(res or {}).get('correct')} {checks}", file=sys.stderr, flush=True)
            gc.collect()
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
