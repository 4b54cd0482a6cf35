"""Export the synthetic scene as a Hamlyn-layout stereo dataset
(counterpart of nrslam_tpu/datasets/hamlyn_export.py; reference
modules/datasets/hamlyn.cc:100-249):

    <root>/images/%06d.png          left (rectified) frames
    <root>/images_right/%06d.png    right frames, baseline along +x
    <root>/settings.yaml            PinHole calibration + Stereo.bf
    <root>/filters.txt              masker spec
    <root>/names.txt                also readable as an Endomapper cache

The rig is ideal-rectified by construction (identical pinhole intrinsics, a
pure x-baseline), which is what hamlyn.cc's stereoRectify output
guarantees. Frames are rendered on ``device`` (the card unless it says
otherwise) and written with ``datasets/png.py``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from nrslam_tpu_torch.datasets import png, synthetic
from nrslam_tpu_torch.geometry import se3
from nrslam_tpu_torch.utils.device import resolve


def _gray_u8(gray) -> np.ndarray:
    return np.clip(gray.cpu().numpy(), 0, 255).astype(np.uint8)


def export_hamlyn_stereo_dataset(out_dir, scene: synthetic.SceneConfig,
                                 n_frames: int = 36,
                                 baseline: float = 0.12,
                                 filters=("BorderFilter 4 4",),
                                 device=None) -> Path:
    """Render ``n_frames`` stereo pairs into a Hamlyn cache layout; returns
    the dataset root. ``Stereo.bf`` = fx x baseline (the rectified
    projection convention, P2[0, 3] = -fx b, hamlyn.cc:195-199)."""
    device = resolve(device)
    root = Path(out_dir)
    left_dir = root / "images"
    right_dir = root / "images_right"
    left_dir.mkdir(parents=True, exist_ok=True)
    right_dir.mkdir(parents=True, exist_ok=True)

    # The right camera: the left pose composed with a pure x-baseline
    # offset (a point at camera-frame x is at x - b in the right camera).
    T_rl = se3.SE3(torch.tensor([1.0, 0.0, 0.0, 0.0], device=device),
                   torch.tensor([-baseline, 0.0, 0.0], device=device))

    names = []
    for i in range(n_frames):
        Tcw_l = synthetic.camera_pose(i, scene, device)
        gray_l, _, _ = synthetic.render_frame_at(Tcw_l, i, scene)
        gray_r, _, _ = synthetic.render_frame_at(se3.compose(T_rl, Tcw_l),
                                                 i, scene)
        name = f"{i:06d}.png"
        png.write(left_dir / name, _gray_u8(gray_l))
        png.write(right_dir / name, _gray_u8(gray_r))
        names.append(f"images/{name}")

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
        f"Stereo.bf: {fx * baseline}",
        "",
        'Masking.filterFile: "./filters.txt"',
        "",
        "System.autoplay: 1",
        'Evaluation.save_path: ""',
        'MapVisualizer.save_path: ""',
        'ImageVisualizer.save_path: ""',
    ]
    (root / "settings.yaml").write_text("\n".join(lines) + "\n")
    (root / "filters.txt").write_text("\n".join(filters) + "\n")
    (root / "names.txt").write_text("\n".join(names) + "\n")
    return root
