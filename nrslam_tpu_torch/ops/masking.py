"""Image masking filters: border, brightness and predefined masks, and the
Masker that combines them (counterpart of nrslam_tpu/ops/masking.py).

Each filter gives a bool [H, W] validity mask; the Masker ANDs the
configured filters and erodes the result into the "Global" mask that
tracking consumes (masker.cc:161-182).
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch

from nrslam_tpu_torch.ops import image as image_ops


def border_filter(gray, rows: int = 0, cols: int = 0, erode_size: int = 21):
    """Crop ``rows``/``cols`` from each side, drop zero pixels, erode
    (border_filter.cc:24-38)."""
    h, w = gray.shape
    mask = torch.ones((h, w), dtype=torch.bool, device=gray.device)
    if rows > 0:
        mask[:rows] = False
        mask[-rows:] = False
    if cols > 0:
        mask[:, :cols] = False
        mask[:, -cols:] = False
    return image_ops.erode(mask & (gray > 0), erode_size)


def bright_filter(gray, threshold: float = 220.0, erode_size: int = 11,
                  blur_size: int = 11):
    """Mask out over-exposed regions: blur, pixels above ``threshold``
    invalid, square erosion (bright_filter.cc:24-39)."""
    blurred = image_ops.gaussian_blur(gray, blur_size)
    return image_ops.erode(blurred < threshold, erode_size)


def predefined_filter(static_mask, erode_size: int = 20) -> Callable:
    """Fixed mask (e.g. endoscope borders) + erosion
    (predefined_filter.cc:27-35). Returns a filter closure."""
    eroded = image_ops.erode(static_mask > 0, erode_size)

    def apply(gray):
        return eroded

    return apply


class Masker:
    """Named filters combined into per-filter masks + the eroded Global AND
    (masker.cc:99-182). Specs follow the reference's filters.txt lines:
    ("BorderFilter", rows, cols), ("BrightFilter", thr),
    ("PredefinedFilter", mask_tensor)."""

    FINAL_ERODE = 10  # masker.cc:176

    def __init__(self, filter_specs: Sequence[tuple] = ()):
        self.filters: Dict[str, Callable] = {}
        for spec in filter_specs:
            name = spec[0]
            if name == "BorderFilter":
                rows, cols = (spec[1], spec[2]) if len(spec) > 2 else (0, 0)
                self.filters[name] = \
                    lambda g, r=rows, c=cols: border_filter(g, r, c)
            elif name == "BrightFilter":
                thr = spec[1] if len(spec) > 1 else 220.0
                self.filters[name] = lambda g, t=thr: bright_filter(g, t)
            elif name == "PredefinedFilter":
                self.filters[name] = predefined_filter(spec[1])
            else:
                raise ValueError(f"unknown filter {name}")

    def get_all_masks(self, gray) -> Dict[str, torch.Tensor]:
        masks = {name: f(gray) for name, f in self.filters.items()}
        combined = torch.ones(gray.shape, dtype=torch.bool,
                              device=gray.device)
        for m in masks.values():
            combined = combined & m
        masks["Global"] = image_ops.erode(combined, self.FINAL_ERODE)
        return masks

    def __call__(self, gray):
        return self.get_all_masks(gray)["Global"]
