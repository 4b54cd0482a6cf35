"""Settings: the per-sequence ``settings.yaml`` of the reference
(counterpart of nrslam_tpu/config.py; reference SLAM/settings.{h,cc}).

Reads the OpenCV FileStorage YAML dialect ("%YAML:1.0", flat ``key:
value`` entries; the ``!!opencv-matrix`` blocks only feed the reference's
GUI views and are skipped) without OpenCV: camera model and intrinsics
(PinHole or KannalaBrandt8), radians per pixel, the stereo ``bf``, the
evaluation / visualiser save paths, and the masker from the filter file
(masker.cc:99-136), whose PredefinedFilter image is read with
``datasets/png.py``. The camera and every mask live on one device: the
card unless ``device`` says otherwise (``utils/device.py``).
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Optional

import torch

from nrslam_tpu_torch.datasets import png
from nrslam_tpu_torch.geometry import cameras
from nrslam_tpu_torch.ops import masking
from nrslam_tpu_torch.slam.state import Config
from nrslam_tpu_torch.utils.device import resolve


def _parse_opencv_yaml(text: str) -> dict:
    """The flat ``key: value`` entries of an OpenCV YAML file: quoted
    strings unquoted, numbers as int or float, ``!!`` blocks skipped."""
    out = {}
    for line in text.splitlines():
        line = line.split("#", 1)[0].rstrip()
        m = re.match(r"^([A-Za-z0-9_.]+):\s*(.+)$", line)
        if not m:
            continue
        key, val = m.group(1), m.group(2).strip()
        if val.startswith("!!"):
            continue
        if val.startswith('"') and val.endswith('"'):
            out[key] = val[1:-1]
            continue
        try:
            out[key] = int(val)
        except ValueError:
            try:
                out[key] = float(val)
            except ValueError:
                out[key] = val
    return out


class Settings:
    """Parsed settings (Settings::Settings, settings.cc:82-174)."""

    def __init__(self, settings_path: str, device=None):
        self.path = Path(settings_path)
        self.device = resolve(device)
        raw = _parse_opencv_yaml(self.path.read_text())
        self.raw = raw

        model = raw.get("Camera.model", "PinHole")
        fx, fy = raw["Camera.fx"], raw["Camera.fy"]
        cx, cy = raw["Camera.cx"], raw["Camera.cy"]
        if model == "PinHole":
            self.calibration = cameras.pinhole(fx, fy, cx, cy,
                                               device=self.device)
        elif model in ("KannalaBrandt8", "KannalaBrandt"):
            self.calibration = cameras.kannala_brandt8(
                fx, fy, cx, cy, raw["Camera.k0"], raw["Camera.k1"],
                raw["Camera.k2"], raw["Camera.k3"], device=self.device)
        else:
            raise ValueError(f"unknown camera model {model}")

        self.rad_per_pixel = float(raw.get("Camera.radiansPerPixel", 0.002))
        self.bf = float(raw.get("Stereo.bf", 0.0))
        self.autoplay = bool(raw.get("System.autoplay", 1))
        self.evaluation_path = raw.get("Evaluation.save_path", "")
        self.image_visualizer_path = raw.get("ImageVisualizer.save_path", "")
        self.map_visualizer_path = raw.get("MapVisualizer.save_path", "")

        self.masker = self._load_masker(raw.get("Masking.filterFile"))

    def _load_masker(self, filter_file: Optional[str]):
        """Masker::LoadFromText (masker.cc:99-136): one filter per line,
        ``BorderFilter rows cols``, ``BrightFilter [threshold]``,
        ``PredefinedFilter mask.png`` (read beside the settings file, moved
        to the settings' device)."""
        if not filter_file:
            return None
        path = Path(filter_file)
        if not path.is_absolute():
            path = self.path.parent / path.name
        if not path.exists():
            return None
        specs = []
        for line in path.read_text().splitlines():
            parts = line.split()
            if not parts:
                continue
            name = parts[0]
            if name == "BorderFilter" and len(parts) >= 3:
                specs.append((name, int(parts[1]), int(parts[2])))
            elif name == "BrightFilter":
                thr = float(parts[1]) if len(parts) > 1 else 220.0
                specs.append((name, thr))
            elif name == "PredefinedFilter" and len(parts) > 1:
                mask_img = png.imread_gray(self.path.parent / parts[1])
                specs.append((name, torch.from_numpy(mask_img)
                              .to(self.device)))
        return masking.Masker(specs) if specs else None

    def slam_config(self, **overrides) -> Config:
        base = Config(rad_per_pixel=self.rad_per_pixel)
        return base._replace(**overrides) if overrides else base
