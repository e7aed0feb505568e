#!/usr/bin/env python3
"""The cluster solve and the fused matcher of one checkout, timed on the
card. To compare two checkouts in one call, run it on each in turns
(A, B, B, A) and compare within the call.

    python3 tools/compare_kernels.py [--root DIR] [--tag NAME]

Imports ``svin_tpu_torch`` from DIR (default: this checkout), which builds
its kernels there at first use, and times with ``chip_smoke.py``'s
``in_turns`` (back-to-back launches between CUDA events, the median of
three rounds):

- ``ops/solve.py::spd_solve_cluster`` in turns with ``cholesky_ex`` +
  ``cholesky_solve`` at ``chip_smoke.LARGE_DS`` on equilibrated SPD
  systems, and its device ms summed over ``LAUNCHES_BY_D``, the launches
  per D that ``chip_smoke.py``'s paths make (70 at D=330 on the S=22
  engine; 20 at D=384 and 10 each at D=768 and 1020 in global BA);
- ``ops/hamming.py::match_descriptors_cuda`` at the engine's three matcher
  shapes (``problems.matcher_inputs``), mutual on.

Prints the card's name and power limit, then one JSON line. Needs one CUDA
card and ``nvcc``; exits nonzero without them.
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LAUNCHES_BY_D = {330: 70, 384: 20, 768: 10, 1020: 10}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE, help="the checkout whose svin_tpu_torch is timed")
    ap.add_argument("--tag", default="this checkout", help="the name printed beside its numbers")
    args = ap.parse_args(argv)
    # the timed checkout's package; chip_smoke.py's helpers from this checkout
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from svin_tpu_torch import problems
    from svin_tpu_torch.ops import hamming, solve

    if not os.path.samefile(os.path.dirname(os.path.dirname(os.path.dirname(solve.__file__))), args.root):
        raise RuntimeError(f"svin_tpu_torch came from {solve.__file__}, not from {args.root}")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    rng = np.random.default_rng(0)
    out = {"tag": args.tag, "root": args.root, "solve_ms": {}, "library_ms": {}, "solve_host_us": {},
           "match_ms": {}, "match_host_us": {}}
    for D in cs.LARGE_DS:
        H, b = cs.equilibrated_spd(rng, D, dev)
        x = solve.spd_solve_cluster(H, b)
        res = float((H @ x - b).norm() / b.norm())
        if not res <= 1e-4:
            raise AssertionError(f"D={D}: relative residual {res:.3e}")
        t = cs.in_turns({"kernel": lambda H=H, b=b: solve.spd_solve_cluster(H, b),
                         "library": lambda H=H, b=b: cs.cholesky_library(H, b)})
        out["solve_ms"][D], out["solve_host_us"][D] = t["kernel"]
        out["library_ms"][D] = t["library"][0]
    out["solve_path_ms"] = sum(n * out["solve_ms"][D] for D, n in LAUNCHES_BY_D.items())
    out["library_path_ms"] = sum(n * out["library_ms"][D] for D, n in LAUNCHES_BY_D.items())
    for kind in problems.MATCHER_SHAPES:
        m = problems.matcher_inputs(kind, rng, dev)
        got, want = hamming.match_descriptors_cuda(*m), hamming.match_descriptors_plain(*m)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"fused matcher != plain at {kind}")
        t = cs.in_turns({"kernel": lambda m=m: hamming.match_descriptors_cuda(*m)})
        out["match_ms"][kind], out["match_host_us"][kind] = t["kernel"]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
