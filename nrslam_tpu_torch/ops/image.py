"""Image pyramid, Scharr gradients and dilation (main-path subset of
nrslam_tpu/ops/image.py).

Float32 images in [0, 255], shape [H, W]; borders replicate (edge padding)
exactly as the JAX package's shifted-slice stencils do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_PYRDOWN_K = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _edge_pad(img, pad: int):
    return F.pad(img[None, None], (pad, pad, pad, pad), mode="replicate")[0, 0]


def pyr_down(img):
    """[1,4,6,4,1]/16 separable blur then 2x decimation (cv::pyrDown)."""
    k = _PYRDOWN_K
    x = _edge_pad(img, 2)
    r = (k[0] * x[:-4] + k[1] * x[1:-3] + k[2] * x[2:-2]
         + k[3] * x[3:-1] + k[4] * x[4:])
    r = r[::2]
    b = (k[0] * r[:, :-4] + k[1] * r[:, 1:-3] + k[2] * r[:, 2:-2]
         + k[3] * r[:, 3:-1] + k[4] * r[:, 4:])
    return b[:, ::2].contiguous()


def scharr_gradients(img):
    """Unnormalized Scharr x/y derivatives stacked [H, W, 2]."""
    x = _edge_pad(img, 1)
    dx = x[:, 2:] - x[:, :-2]
    gx = 3.0 * dx[:-2] + 10.0 * dx[1:-1] + 3.0 * dx[2:]
    dy = x[2:, :] - x[:-2, :]
    gy = 3.0 * dy[:, :-2] + 10.0 * dy[:, 1:-1] + 3.0 * dy[:, 2:]
    return torch.stack([gx, gy], dim=-1)


def build_pyramid(img, num_levels: int):
    """List of (image, gradients) per level, level 0 = full resolution."""
    levels = []
    cur = img
    for _ in range(num_levels):
        levels.append((cur, scharr_gradients(cur)))
        cur = pyr_down(cur)
    return levels


def dilate(mask, ksize: int):
    """Binary dilation with a ksize x ksize box (out-of-image is False)."""
    pad = ksize // 2
    x = F.pad(mask.to(torch.float32)[None, None],
              (pad, ksize - 1 - pad, pad, ksize - 1 - pad))
    x = F.max_pool2d(x, (ksize, 1), stride=1)
    x = F.max_pool2d(x, (1, ksize), stride=1)
    return x[0, 0] > 0.5
