#!/usr/bin/env python3
"""Which phase takes the time of B1's cluster kernel, on the card.

    python3 tools/profile_cluster_solve.py [D ...]     # default 330 1024

Compiles ``svin_tpu_torch/csrc/spd_solve_cluster.cu`` a second time with
``-DSVIN_PHASE_TIMES`` into ``svin_tpu_torch/_build/libspd_cluster_phases.so``
(the package's own library is not touched): the leader CTA's thread 0
then sums SM cycles (``clock64``) per phase of the factorization. For each
D it solves a Jacobi-equilibrated SPD system 20 times and prints the median
cycles of each phase with its share, beside the launch's device time from
CUDA events (the instrumented build; the phases' sum over that time gives
the SM clock the cycles ran at). The cycles are those of the CTA of rank 0
(with ``ops/solve.py::cluster_plan``'s assignment, the CTA holding the last
block row: the most trailing work). The phases: staging H into its shared
memory, the diagonal block (factor and inverse, where it owns the row),
the panel solve (Linv and y_k fetched through DSMEM, L_ik = A_ik Linv^T),
the cluster barriers (the wait there includes the other CTAs' imbalance),
the panel tiles pulled from other CTAs through DSMEM, the trailing tiles,
the back substitution.

Needs one CUDA card and ``nvcc``; exits nonzero without them.
"""
import ctypes
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from svin_tpu_torch.ops import cuda_lib, solve  # noqa: E402

PHASES = ("staging", "diagonal block", "panel solve", "cluster barriers", "panel pulls",
          "trailing tiles", "back substitution")
LIB = os.path.join(cuda_lib.BUILD_DIR, "libspd_cluster_phases.so")


def build() -> ctypes.CDLL:
    os.makedirs(cuda_lib.BUILD_DIR, exist_ok=True)
    src = os.path.join(cuda_lib.CSRC_DIR, "spd_solve_cluster.cu")
    cmd = [cuda_lib._nvcc(), *cuda_lib.COMPILE_FLAGS, "-DSVIN_PHASE_TIMES", "-shared", "-o", LIB,
           src]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(LIB)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.spd_solve_cluster.restype = ci
    lib.spd_solve_cluster.argtypes = [vp, vp, vp, ci, ci, ctypes.POINTER(ci), vp]
    lib.spd_solve_cluster_phase_cycles.restype = ci
    lib.spd_solve_cluster_phase_cycles.argtypes = [vp]
    return lib


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("profile_cluster_solve: no CUDA device", file=sys.stderr)
        return 1
    Ds = [int(a) for a in argv] or [330, 1024]
    dev = torch.device("cuda")
    lib = build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    rng = np.random.default_rng(0)
    for D in Ds:
        A = rng.standard_normal((D, D))
        H = A @ A.T + D * np.eye(D)
        s = 1.0 / np.sqrt(np.diag(H))
        H = torch.as_tensor(H * np.outer(s, s), dtype=torch.float32, device=dev)
        b = torch.as_tensor(rng.standard_normal(D) * s, dtype=torch.float32, device=dev)
        x = torch.empty_like(b)
        plan = solve.cluster_plan(D)
        plan_ints = (ctypes.c_int * len(plan.as_ints()))(*plan.as_ints())
        stream = torch.cuda.current_stream().cuda_stream
        cycles, ms = [], []
        for _ in range(20):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            err = lib.spd_solve_cluster(H.data_ptr(), b.data_ptr(), x.data_ptr(), 1, D, plan_ints,
                                        stream)
            e1.record()
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f"spd_solve_cluster: CUDA error {err}")
            out = (ctypes.c_ulonglong * 8)()
            if lib.spd_solve_cluster_phase_cycles(out):
                raise RuntimeError("cudaMemcpyFromSymbol failed")
            cycles.append(list(out)[:len(PHASES)])
            ms.append(e0.elapsed_time(e1))
        res = float(torch.linalg.norm(H @ x - b) / torch.linalg.norm(b))
        med = [statistics.median(c[k] for c in cycles) for k in range(len(PHASES))]
        total = sum(med)
        t_ms = statistics.median(ms)
        print(f"D={D}: {t_ms:.4f} ms per launch (events), {total:.0f} cycles in the phases "
              f"({total / (t_ms * 1e6):.3f} GHz), {plan.nt} panels, cluster {plan.cluster}, "
              f"{plan.ntiles} tiles and {plan.ring} ring slots per CTA, residual {res:.2e}")
        for name, c in zip(PHASES, med):
            print(f"  {name:18s} {c:10.0f} cycles {100 * c / total:5.1f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
