"""The port's CLI (``python -m nrslam_tpu_torch.apps.run_slam``) in
process, on the CPU, over tiny Hamlyn and Simulation folders that the JAX
package's exporters wrote: the JAX CLI's flags (less its TPU backend
switch, plus ``--device``) and summary keys, TRACKING, and the files it
writes (stereo-RMSE / RMSE file, PLY, checkpoint, viz dumps).

The scene is 120x160 with relief 1.0 and 0.02 per frame of motion, and the
initializer runs at 256 features (the CLI has no flag for the initializer's
sizes, so the test sets them), where the port's own RANSAC draws
initialise at frame 9.
"""

import ast
import functools
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from nrslam_tpu.datasets import synthetic as jsyn
from nrslam_tpu_torch.apps import run_slam
from nrslam_tpu_torch.datasets import png
from nrslam_tpu_torch.slam import initializer
from nrslam_tpu_torch.utils import checkpoint, tree

torch.set_num_threads(1)

JAX_CLI = Path(__file__).resolve().parent.parent / "apps" / "run_slam.py"
SCENE = dict(height=120, width=160, fx=125.0, fy=125.0, relief=1.0,
             motion_translation=0.02, deform_amp=0.02)
N_FRAMES = 16


def _jax_cli():
    """(flags, summary keys) of apps/run_slam.py, read from its source."""
    flags, keys = set(), None
    for node in ast.walk(ast.parse(JAX_CLI.read_text())):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "add_argument"):
            flags.add(node.args[0].value)
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", "") == "summary"
                        for t in node.targets)):
            keys = [k.value for k in node.value.keys]
    return flags, keys


@pytest.fixture
def small_init(monkeypatch):
    monkeypatch.setattr(initializer, "InitializerConfig", functools.partial(
        initializer.InitializerConfig, max_features=256, min_matches=30,
        min_triangulated=25, n_hypotheses=48))


def _run(capsys, argv):
    summary, slam = run_slam.main(argv + ["--end_frame", str(N_FRAMES),
                                          "--max_points", "256",
                                          "--init_check_every", "1",
                                          "--device", "cpu"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == summary
    assert list(summary) == _jax_cli()[1]
    assert summary["status"] == "TRACKING", summary
    assert slam.device.type == "cpu"
    return summary, slam


def test_cli_flags_are_the_jax_clis():
    flags, keys = _jax_cli()
    parser_flags = set()
    src = ast.parse(Path(run_slam.__file__).read_text())
    for node in ast.walk(src):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "add_argument"):
            parser_flags.add(node.args[0].value)
    assert parser_flags == (flags - {"--solver_backend"}) | {"--device"}
    assert keys == ["frames_tracked", "status", "mean_frame_ms", "fps",
                    "steady_fps", "median_rmse", "median_stereo_rmse"]
    args = run_slam.parse_args([])
    assert args.device == "cuda" and args.init_check_every == 4


def test_cli_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="cpu"):
        run_slam.main(["--dataset", "synthetic", "--end_frame", "1"])


def test_cli_hamlyn_stereo(tmp_path, capsys, small_init):
    from nrslam_tpu.datasets.hamlyn_export import export_hamlyn_stereo_dataset

    root = export_hamlyn_stereo_dataset(
        tmp_path / "hamlyn", jsyn.SceneConfig(**SCENE), n_frames=N_FRAMES,
        filters=())
    summary, slam = _run(capsys, [
        "--dataset", "hamlyn", "--dataset_path", str(root),
        "--settings_path", str(root / "settings.yaml"),
        "--save_rmse", str(tmp_path / "stereo_rmse.txt"),
        "--save_ply", str(tmp_path / "map.ply"),
        "--checkpoint_dir", str(tmp_path / "ck")])
    assert summary["frames_tracked"] >= 4 and summary["median_rmse"] is None
    assert 0 < summary["median_stereo_rmse"] < 0.5, summary
    vals = [float(v) for v in
            (tmp_path / "stereo_rmse.txt").read_text().split()]
    assert len(vals) == summary["frames_tracked"]
    assert all(math.isfinite(v) for v in vals)
    assert np.median(vals) == pytest.approx(summary["median_stereo_rmse"])
    head = (tmp_path / "map.ply").read_text().split("end_header")[0]
    n_vertices = int(head.split("element vertex ")[1].split()[0])
    assert n_vertices > 20
    back = checkpoint.restore(str(tmp_path / "ck"), slam.state)
    same = tree.tree_map(torch.equal, back, slam.state)
    assert all(_leaves(same)) and len(_leaves(same)) > 40


def _leaves(t):
    if isinstance(t, tuple):
        return [x for v in t for x in _leaves(v)]
    return [t]


def test_cli_simulation_kb8(tmp_path, capsys, small_init):
    from nrslam_tpu.datasets.simulation_export import \
        export_simulation_dataset

    root = export_simulation_dataset(
        tmp_path / "sim", jsyn.SceneConfig(camera_kind="kb8", **SCENE),
        n_frames=N_FRAMES, filters=("BorderFilter 2 2",))
    summary, slam = _run(capsys, [
        "--dataset", "simulation", "--dataset_path", str(root),
        "--settings_path", str(root / "settings.yaml"),
        "--save_rmse", str(tmp_path / "rmse.txt"),
        "--save_viz", str(tmp_path / "viz")])
    assert slam.cam.kind == "kb8" and slam.masker is not None
    assert summary["frames_tracked"] >= 4 and summary["median_stereo_rmse"] \
        is None
    assert 0 < summary["median_rmse"] < 0.15, summary
    vals = [float(v) for v in (tmp_path / "rmse.txt").read_text().split()]
    assert np.median(vals) == pytest.approx(summary["median_rmse"], rel=1e-6)
    dumps = sorted(p.name for p in (tmp_path / "viz").glob("*.png"))
    assert dumps == ["features_00010.png", "flow_00010.png",
                     "graph_00010.png"]
    for name in dumps:
        img = png.read(tmp_path / "viz" / name)
        assert img.shape == (120, 160, 3) and img.max() > 0
    assert (tmp_path / "viz" / "flow_trails.ply").stat().st_size > 0
