"""The port never imports JAX, and imports OpenCV and Pillow only inside
the functions that need them (the card's machine has neither): every
module of nrslam_tpu_torch (and chip_smoke.py) is imported in a fresh
interpreter, which must end with no ``jax``, ``nrslam_tpu``, ``cv2`` or
``PIL`` in ``sys.modules``. Importing ``nrslam_tpu_torch.parallel``'s
modules starts no process group and no process."""

import os
import subprocess
import sys

import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys
import nrslam_tpu_torch
names = [m.name for m in pkgutil.walk_packages(nrslam_tpu_torch.__path__,
                                               "nrslam_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert len(names) >= 20, names
parallel = {"nrslam_tpu_torch.parallel." + m for m in (
    "sharding", "ba_shard", "multihost", "tracking_shard", "dryrun",
    "solve_shard", "ba_points")}
assert parallel <= set(names), sorted(parallel - set(names))
import multiprocessing
import torch.distributed as dist
assert not dist.is_initialized(), "an import started a process group"
assert not multiprocessing.active_children(), "an import started a process"
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "nrslam_tpu", "cv2", "PIL"))
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
