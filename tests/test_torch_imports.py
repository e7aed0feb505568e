"""The port never imports JAX or the JAX package: every module of
``svin_tpu_torch`` and ``chip_smoke.py``, imported in a fresh interpreter,
leave ``jax`` and ``svin_tpu`` out of ``sys.modules``."""
import os
import subprocess
import sys

import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CODE = """
import importlib, pkgutil, sys
import svin_tpu_torch
names = [m.name for m in pkgutil.walk_packages(svin_tpu_torch.__path__, "svin_tpu_torch.")]
for name in names + ["chip_smoke"]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "svin_tpu"))
assert not bad, bad
print(len(names))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", CODE], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert int(r.stdout.split()[-1]) >= 40  # every module was found and imported
