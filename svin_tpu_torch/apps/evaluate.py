"""ATE evaluation CLI: Sim(3)/SE(3)-aligned trajectory error vs ground truth.

Usage:
  python -m svin_tpu_torch.apps.evaluate <est_tum.txt> <gt_tum.txt> [--se3] [--max-dt S]

Trajectories in TUM format are associated by timestamp (within --max-dt,
default 0.02 s), aligned (Sim(3) by default, for ground truth known up to
scale; --se3 for metric ground truth) and compared; the RPE over 1 s is
taken on the scale-corrected estimate. Prints one JSON line.
"""
from __future__ import annotations

import json
import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print(__doc__)
        return 2
    est, gt = argv[0], argv[1]
    with_scale = "--se3" not in argv
    max_dt = 0.02
    if "--max-dt" in argv:
        max_dt = float(argv[argv.index("--max-dt") + 1])

    from ..evaluation import associate, ate_rmse, load_tum, rpe

    t_e, p_e, q_e = load_tum(est)
    t_g, p_g, q_g = load_tum(gt)
    ie, ig = associate(t_e, t_g, max_dt)
    rmse, a = ate_rmse(p_e[ie], p_g[ig], with_scale=with_scale)
    out = {
        "ate_rmse": rmse,
        "n_pairs": int(len(ie)),
        "scale": a.scale,
        "alignment": "sim3" if with_scale else "se3",
    }
    out.update(rpe(t_e[ie], a.scale * p_e[ie], q_e[ie], p_g[ig], q_g[ig], delta_s=1.0))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
