"""Shi-Tomasi corner detection (counterpart of nrslam_tpu/ops/shi_tomasi.py).

Sobel gradients -> 3x3-averaged structure tensor -> min-eigenvalue score ->
two-radius NMS (threshold 80, outer radius 15) -> fixed-capacity selection
with the same two-stage (per-tile, then global) ranking as the JAX package,
so the same keypoint set comes out in the same order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from slambench.reference.ops import image as image_ops

SCORE_THRESHOLD = 80.0
OUTER_RADIUS = 15


def _tap3(x, k0: float, k1: float, k2: float, axis: int):
    """3-tap correlation along one axis with edge padding."""
    if axis == 0:
        xp = F.pad(x[None, None], (0, 0, 1, 1), mode="replicate")[0, 0]
        return k0 * xp[:-2, :] + k1 * xp[1:-1, :] + k2 * xp[2:, :]
    xp = F.pad(x[None, None], (1, 1, 0, 0), mode="replicate")[0, 0]
    return k0 * xp[:, :-2] + k1 * xp[:, 1:-1] + k2 * xp[:, 2:]


def score_map(img):
    """Min-eigenvalue score of the 3x3-box-averaged structure tensor."""
    gx = _tap3(_tap3(img, 1.0, 2.0, 1.0, 0), -1.0, 0.0, 1.0, 1)
    gy = _tap3(_tap3(img, 1.0, 2.0, 1.0, 1), -1.0, 0.0, 1.0, 0)

    def box(x):
        return _tap3(_tap3(x, 1.0, 1.0, 1.0, 0), 1.0, 1.0, 1.0, 1)

    g11 = box(gx * gx) / 9.0
    g12 = box(gx * gy) / 9.0
    g22 = box(gy * gy) / 9.0
    tr = g11 + g22
    det = g11 * g22 - g12 * g12
    root = torch.sqrt(torch.clamp(tr * tr - 4.0 * det, min=0.0))
    return (tr - root) * 0.5


def _max_pool(x, radius: int):
    """(2r+1)^2 max filter with -inf outside the image ("SAME")."""
    k = 2 * radius + 1
    y = F.max_pool2d(x[None, None], (k, 1), stride=1, padding=(radius, 0))
    return F.max_pool2d(y, (1, k), stride=1, padding=(0, radius))[0, 0]


def _top_k(x, k: int):
    """Largest k, ties lowest index first (jax.lax.top_k's order)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def detect(img, max_keypoints: int, nms_radius: int = 7, mask=None,
           occupied=None):
    """Detect up to ``max_keypoints`` corners.

    Returns xy [N, 2] (x, y) float32, valid [N] bool, scores [N].
    """
    h, w = img.shape
    s = score_map(img)
    interior = torch.zeros_like(s, dtype=torch.bool)
    interior[2:-2, 2:-2] = True

    is_max = (s >= _max_pool(s, nms_radius)) & (s >= SCORE_THRESHOLD) \
        & interior
    if occupied is not None:
        near_occupied = image_ops.dilate(occupied, 2 * OUTER_RADIUS + 1)
        is_max = is_max & ~near_occupied
    if mask is not None:
        is_max = is_max & mask

    B = max(2, min(8, nms_radius + 1))
    Hp = -(-h // B) * B
    Wp = -(-w // B) * B
    neg_inf = float("-inf")
    sm = torch.where(is_max, s, torch.full_like(s, neg_inf))
    sm = F.pad(sm, (0, Wp - w, 0, Hp - h), value=neg_inf)
    tiles = sm.reshape(Hp // B, B, Wp // B, B).permute(0, 2, 1, 3)
    tiles = tiles.reshape(-1, B * B)
    bmax, barg = torch.max(tiles, dim=-1)
    k_sel = min(max_keypoints, bmax.shape[0])
    top_scores, bidx = _top_k(bmax, k_sel)
    if k_sel < max_keypoints:
        pad = max_keypoints - k_sel
        top_scores = torch.cat([top_scores, torch.full(
            (pad,), neg_inf, dtype=top_scores.dtype, device=img.device)])
        bidx = torch.cat([bidx, torch.zeros(pad, dtype=bidx.dtype,
                                            device=img.device)])
    within = barg[bidx]
    nbx = Wp // B
    yy = ((bidx // nbx) * B + within // B).to(torch.float32)
    xx = ((bidx % nbx) * B + within % B).to(torch.float32)
    valid = torch.isfinite(top_scores)
    xy = torch.stack([xx, yy], dim=-1)
    return xy, valid, torch.where(valid, top_scores,
                                  torch.zeros_like(top_scores))
