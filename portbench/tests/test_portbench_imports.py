"""What a run loads: no JAX and no JAX package in the harness, and nothing of
the program in the reference (top-level names compared whole: the port's
name begins with the JAX package's)."""
from __future__ import annotations

import json
import subprocess
import sys

import portbench_tiny as tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "svin_tpu"}


def _top_level(code: str) -> set:
    p = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                       cwd=tiny.REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_neither_jax_nor_the_jax_package():
    names = _top_level(
        "import glob, importlib.util, os\n"
        "import portbench.run, portbench.control, portbench.reference, portbench.tracing\n"
        "from svin_tpu_torch.apps.run_synchronous import build\n"
        "from svin_tpu_torch.pipeline import load_config, run_events\n"
        "from svin_tpu_torch.loopclosure import GlobalMap\n"
        "for f in glob.glob('portbench/metrics/*.py'):\n"
        "    s = importlib.util.spec_from_file_location(os.path.basename(f)[:-3], f)\n"
        "    importlib.util.module_from_spec(s).__loader__.exec_module(importlib.util.module_from_spec(s))\n")
    assert "svin_tpu_torch" in names
    assert not names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    names = _top_level("import portbench.reference, portbench.gen, portbench.roofline")
    assert not names & (FORBIDDEN | {"svin_tpu_torch"})
