"""The no-JAX check and the reference's import boundary."""

import ast
import subprocess
import sys
from pathlib import Path

from slambench import run

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_compares_whole_top_level_names(monkeypatch):
    fake = type(sys)("fake")
    for name in ("nrslam_tpu_torch", "nrslam_tpu_torch.slam",
                 "jaxtyping", "flaxen", "jax_free"):
        monkeypatch.setitem(sys.modules, name, fake)
    assert run.no_jax() == []
    for name in ("nrslam_tpu.slam.system", "jax", "jaxlib.xla_client",
                 "flax.linen"):
        monkeypatch.setitem(sys.modules, name, fake)
    assert run.no_jax() == sorted(["nrslam_tpu.slam.system", "jax",
                                   "jaxlib.xla_client", "flax.linen"])


def test_harness_never_imports_jax_or_the_jax_package():
    banned = {"jax", "jaxlib", "flax", "nrslam_tpu"}
    for path in HERE.rglob("*.py"):
        for mod in _imports(path):
            assert mod.split(".", 1)[0] not in banned, (path, mod)


def test_reference_imports_nothing_of_the_port():
    allowed = {"torch", "typing", "math", "__future__", "slambench",
               "numpy"}
    for path in (HERE / "reference").rglob("*.py"):
        for mod in _imports(path):
            assert mod.split(".", 1)[0] in allowed, (path, mod)


def test_reference_runs_without_the_port():
    """A process in which the port cannot be imported builds a reference
    state and runs one frame step of it."""
    code = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('nrslam_tpu_torch', 'nrslam_tpu', 'jax'):
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
import torch
from slambench.reference.slam import state, system
from slambench.reference.geometry import cameras
cfg = state.Config(max_points=32, max_new_keypoints=16)
st = state.empty_state(cfg, (48, 64), 'cpu')
cam = cameras.pinhole(60., 60., 31.5, 23.5, device='cpu')
gray = torch.rand(48, 64) * 255
st, res = system.frame_step(st, gray, torch.ones(48, 64, dtype=torch.bool),
                            cam, cfg, True)
print('ok', bool(res.lost), sorted(m for m in sys.modules
      if m.split('.')[0] in ('nrslam_tpu_torch', 'nrslam_tpu', 'jax')))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "ok True []"
