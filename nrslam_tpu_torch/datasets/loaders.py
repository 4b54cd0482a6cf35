"""Dataset loaders: Simulation, Hamlyn, Endomapper (counterpart of
nrslam_tpu/datasets/loaders.py; reference modules/datasets/).

Decoding is host work, as in the JAX package: frames come back as float32
numpy arrays and ``System`` moves them to its device. PNG files are read by
``datasets/png.py``. OpenCV is imported only where its codec is the whole
job, and a clear error says so where it is missing: video splitting
(``Hamlyn.prepare``) and the EXR depth buffer.

Directory conventions of the reference:
- Simulation (simulation.cc): ``rgb/image_%04d.png``, depth as
  ``depth/aov_image_%04d.exr`` (nonlinear, linearised with the near / far
  clips 0.01 / 4.0, :117-137) or the 16-bit PNG metric fallback that the
  exporters write (``uint16 = depth / 4.0 * 65535``), ``trajectory.csv``
  rows ``tX;tY;tZ;rX;rY;rZ;rW;time`` of Twc, inverted to Tcw.
- Hamlyn (hamlyn.cc): rectified PNG caches ``images/`` (left) and
  optionally ``images_right/``.
- Endomapper (endomapper.cc): a PNG cache listed in ``names.txt``.
"""

from __future__ import annotations

import csv
import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from nrslam_tpu_torch.datasets import png
from nrslam_tpu_torch.geometry import se3


def _cv2(what: str):
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(f"{what} requires OpenCV (cv2), which is not "
                           "installed") from e
    return cv2


class Simulation:
    """Simulated colonoscopy with ground-truth depth and poses
    (datasets/simulation.cc). Poses are Tcw on the CPU."""

    NEAR_CLIP = 0.01   # simulation.h:50
    FAR_CLIP = 4.0     # simulation.h:51

    def __init__(self, dataset_path: str):
        self.root = Path(dataset_path)
        self.rgb_names = sorted((self.root / "rgb").glob("image_*.png"))
        self.depth_names = sorted((self.root / "depth").glob("aov_image_*.exr"))
        self.depth_png_names = sorted(
            (self.root / "depth").glob("aov_image_*.png"))
        self.poses = self._load_trajectory(self.root / "trajectory.csv")

    @staticmethod
    def _load_trajectory(path: Path):
        poses = []
        if not path.exists():
            return poses
        with open(path) as f:
            reader = csv.reader(f, delimiter=";")
            next(reader, None)  # header
            for row in reader:
                if len(row) < 7:
                    continue
                vx, vy, vz, qx, qy, qz, qw = map(float, row[:7])
                Twc = se3.SE3(q=torch.tensor([qw, qx, qy, qz]),
                              t=torch.tensor([vx, vy, vz]))
                poses.append(se3.inverse(Twc))
        return poses

    def __len__(self):
        return len(self.rgb_names)

    def get_image(self, idx: int) -> np.ndarray:
        return png.imread_color(self.rgb_names[idx])

    def get_depth_image(self, idx: int) -> np.ndarray:
        """Metric depth: the EXR buffer linearised (simulation.cc:117-137),
        else the 16-bit PNG fallback."""
        if not self.depth_names:
            if self.depth_png_names:
                arr = png.read(self.depth_png_names[idx]).astype(np.float32)
                return arr / 65535.0 * self.FAR_CLIP
            raise FileNotFoundError(
                f"no depth images under {self.root / 'depth'}")
        cv2 = _cv2("EXR depth decode")
        os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
        raw = cv2.imread(str(self.depth_names[idx]),
                         cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
        if raw.ndim == 3:
            raw = raw[..., 2]
        x = 1.0 - self.FAR_CLIP / self.NEAR_CLIP
        y = self.FAR_CLIP / self.NEAR_CLIP
        z = x / self.FAR_CLIP
        w = y / self.FAR_CLIP
        return (1.0 / (z * (1.0 - raw) + w)).astype(np.float32)

    def get_camera_pose(self, idx: int):
        return self.poses[idx]


class FrameDirectory:
    """A directory of cached PNG frames, read as gray (the Hamlyn /
    Endomapper core)."""

    def __init__(self, images_dir: Path, pattern: str = "*.png"):
        self.names = sorted(Path(images_dir).glob(pattern))

    def __len__(self):
        return len(self.names)

    def get_image(self, idx: int) -> np.ndarray:
        return png.imread_gray(self.names[idx])


class Hamlyn:
    """Hamlyn sequences (datasets/hamlyn.cc): ``images/`` (left,
    rectified) or a flat directory of PNGs, and optionally
    ``images_right/``."""

    def __init__(self, dataset_path: str):
        self.root = Path(dataset_path)
        left = self.root / "images"
        if not left.exists():
            left = self.root
        self.left = FrameDirectory(left)
        right_dir = self.root / "images_right"
        self.right = FrameDirectory(right_dir) if right_dir.exists() else None

    def __len__(self):
        return len(self.left)

    def get_image(self, idx: int) -> np.ndarray:
        return self.left.get_image(idx)

    def get_right_image(self, idx: int) -> Optional[np.ndarray]:
        return None if self.right is None else self.right.get_image(idx)

    @staticmethod
    def prepare(video_path: str, out_dir: str) -> int:
        """Split a video into cached PNGs (hamlyn.cc:100-149). Needs
        OpenCV's video decoder."""
        cv2 = _cv2("video split")
        cap = cv2.VideoCapture(video_path)
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        n = 0
        try:
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                cv2.imwrite(str(out / f"{n:06d}.png"), frame)
                n += 1
        finally:
            cap.release()
        return n


class Endomapper:
    """Endomapper colonoscopy video (datasets/endomapper.cc): split once to
    a PNG cache tracked by ``names.txt``, then read by index as RGB."""

    def __init__(self, dataset_path: str, video_name: Optional[str] = None):
        self.root = Path(dataset_path)
        names_file = self.root / "names.txt"
        if not names_file.exists() and video_name is not None:
            n = Hamlyn.prepare(str(self.root / video_name),
                               str(self.root / "images"))
            names_file.write_text("".join(f"images/{i:06d}.png\n"
                                          for i in range(n)))
        if names_file.exists():
            self.names = [self.root / line.strip() for line in
                          names_file.read_text().splitlines() if line.strip()]
        else:
            self.names = sorted((self.root / "images").glob("*.png"))

    def __len__(self):
        return len(self.names)

    def get_image(self, idx: int) -> np.ndarray:
        return png.imread_color(self.names[idx])
