"""Export the synthetic sequence to the reference's Simulation layout
(counterpart of nrslam_tpu/datasets/simulation_export.py), the directory
convention modules/datasets/simulation.cc reads:

- ``rgb/image_%04d.png``        colour PNGs (the gray render on 3 channels);
- ``depth/aov_image_%04d.png``  16-bit PNGs of metric depth scaled by the
  far clip (``uint16 = depth / 4.0 * 65535``, ~6e-5 of depth resolution),
  the fallback the JAX exporter writes where OpenCV has no EXR codec; the
  port writes no EXR (it writes through ``datasets/png.py``);
- ``trajectory.csv``            rows ``tX;tY;tZ;qX;qY;qZ;qW;time`` of Twc;
- ``settings.yaml``             the reference's key schema, PinHole or
  KannalaBrandt8 with ``Camera.k0..k3``;
- ``filters.txt``               the masker's filter lines.

Frames are rendered on ``device`` (the card unless it says otherwise) and
written on the host.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from nrslam_tpu_torch.datasets import png, synthetic
from nrslam_tpu_torch.datasets.loaders import Simulation
from nrslam_tpu_torch.geometry import se3


def _settings_lines(scene: synthetic.SceneConfig,
                    evaluation_save_path: str) -> list:
    """settings.yaml of the scene, as the JAX exporter writes it."""
    fx = float(scene.fx)
    lines = [
        "%YAML:1.0",
        "",
        'Camera.model: "PinHole"',
        f"Camera.fx: {fx}",
        f"Camera.fy: {float(scene.fy)}",
        f"Camera.cx: {(scene.width - 1) / 2.0}",
        f"Camera.cy: {(scene.height - 1) / 2.0}",
        "",
        f"Camera.radiansPerPixel: {1.0 / fx}",
        "",
        'Masking.filterFile: "./filters.txt"',
        "",
        "System.autoplay: 1",
        f'Evaluation.save_path: "{evaluation_save_path}"',
        'MapVisualizer.save_path: ""',
        'ImageVisualizer.save_path: ""',
    ]
    if scene.camera_kind == "kb8":
        k = scene.kb_coeffs
        lines[2] = 'Camera.model: "KannalaBrandt8"'
        lines[7:7] = [f"Camera.k{j}: {k[j]}" for j in range(4)]
    return lines


def export_simulation_dataset(out_dir, scene: synthetic.SceneConfig,
                              n_frames: int = 40,
                              filters=("BorderFilter 4 4",),
                              evaluation_save_path: str = "",
                              device=None) -> Path:
    """Render ``n_frames`` of the synthetic scene into a Simulation-layout
    directory. Returns the dataset root."""
    root = Path(out_dir)
    (root / "rgb").mkdir(parents=True, exist_ok=True)
    (root / "depth").mkdir(parents=True, exist_ok=True)

    rows = []
    for i in range(n_frames):
        gray, depth, Tcw = synthetic.render_frame(i, scene, device)
        g = gray.cpu().numpy().astype(np.uint8)
        png.write(root / "rgb" / f"image_{i:04d}.png",
                  np.repeat(g[..., None], 3, axis=-1))
        q = np.clip(depth.cpu().numpy() / Simulation.FAR_CLIP, 0.0, 1.0)
        png.write(root / "depth" / f"aov_image_{i:04d}.png",
                  np.round(q * 65535.0).astype(np.uint16))
        Twc = se3.inverse(Tcw)
        q, t = Twc.q.cpu().numpy(), Twc.t.cpu().numpy()  # q = [qw, qx, qy, qz]
        rows.append(f"{t[0]};{t[1]};{t[2]};{q[1]};{q[2]};{q[3]};{q[0]};{i}")

    (root / "trajectory.csv").write_text(
        "tX;tY;tZ;rX;rY;rZ;rW;time\n" + "\n".join(rows) + "\n")
    (root / "settings.yaml").write_text(
        "\n".join(_settings_lines(scene, evaluation_save_path)) + "\n")
    (root / "filters.txt").write_text("\n".join(filters) + "\n")
    return root
