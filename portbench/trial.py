"""A checkout-shaped root that holds one cell more than ``BENCHMARK.json``:
a cell on trial, run by the harness before a later change adds its entry.

  python3 -m portbench.trial --out <dir> --cell <name> --config <config>
      --traffic <mix> --like <cell> [<cell> ...] [--limits <file>]

``<dir>`` gets ``BENCHMARK.json`` with the cell appended, reporting every
metric that the ``--like`` cells report, and a copy of ``portbench/`` whose
``limits/<name>.json`` is ``--limits`` (default: the one ``portbench/limits/``
holds, else none, so that the run only prints its numbers). Run the harness
from there, with the repository on ``PYTHONPATH`` for the program:

  cd <dir> && PYTHONPATH=<repo> python3 -m portbench.run --workload <name> ...
"""
from __future__ import annotations

import argparse
import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def make(out, cell, config, traffic, like, limits=None, why="a cell on trial") -> str:
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": cell, "config": config, "traffic": traffic, "chips": 1,
                               "why": why})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and set(m["workloads"]) & set(like):
            m["workloads"].append(cell)
    pb = os.path.join(out, "portbench")
    shutil.rmtree(pb, ignore_errors=True)
    shutil.copytree(HERE, pb, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    dst = os.path.join(pb, "limits", cell + ".json")
    if limits is not None:
        shutil.copy(limits, dst)
    elif not os.path.exists(dst):
        with open(dst, "w") as f:
            json.dump({}, f)
    with open(os.path.join(out, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f, indent=1)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.trial")
    p.add_argument("--out", required=True)
    p.add_argument("--cell", required=True)
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", required=True)
    p.add_argument("--like", nargs="+", required=True)
    p.add_argument("--limits")
    a = p.parse_args(argv)
    make(a.out, a.cell, a.config, a.traffic, a.like, a.limits)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
