"""A shrunken copy of the benchmark for the CPU tests: the tiny rig and mixes
of ``tiny/`` under the cells' own names, in a root of their own."""
from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
PORTBENCH = os.path.dirname(HERE)
REPO = os.path.dirname(PORTBENCH)

# the tiny cells' limits: the tracks wide, for runs that only have to get
# through; the CPU runs in float64, so the solve and the pose graph tight
LIMITS = {"ate_m": {"max": 0.5}, "rpe_m": {"max": 0.5}, "solve_berr": {"max": 1e-8},
          "solve_bad": {"max": 0}, "match_diff": {"max": 0}}


def make_root(tmp_path, cell="tiny.transect", traffic="transect", limits=None) -> str:
    """A checkout-shaped root holding BENCHMARK.json with one tiny cell, its
    configuration, mix and limits, and the real metric readers."""
    root = str(tmp_path)
    pb = os.path.join(root, "portbench")
    for d in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(pb, d), exist_ok=True)
    shutil.copytree(os.path.join(PORTBENCH, "metrics"), os.path.join(pb, "metrics"))
    shutil.copy(os.path.join(HERE, "tiny", "tiny_stereorig.json"), os.path.join(pb, "configs"))
    shutil.copy(os.path.join(HERE, "tiny", f"tiny_{traffic}.json"),
                os.path.join(pb, "traffic", f"{traffic}.json"))
    lim = dict(LIMITS if limits is None else limits)
    if limits is None:
        lim.update({"loops": {"max": 0}} if traffic == "transect" else
                   {"pg_dp_m": {"max": 1e-6}, "loop_share": {"min": 0.0}})
    with open(os.path.join(pb, "limits", cell + ".json"), "w") as f:
        json.dump(lim, f)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] = [{"name": "tiny_stereorig", "source": "tests", "reduced": [],
                         "file": "portbench/configs/tiny_stereorig.json", "why": "tests"}]
    bench["workloads"] = [{"name": cell, "config": "tiny_stereorig", "traffic": traffic,
                           "chips": 1, "why": "tests"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [cell]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


def last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])
