"""Batched pyramidal Lucas-Kanade tracking with illumination invariance.

Counterpart of nrslam_tpu/ops/klt.py (see its docstring for the reference
semantics: ival units, gain/bias model, min-eig check, drift clamp,
oscillation back-off, SSIM gate). Windows are sampled by gather with the
same border clamping as the JAX package's ``_extract_patches``; the
per-point tile of the JAX tracker is reproduced by clamping each iteration's
window offset to the 48-pixel tile anchored at the level start.

``track`` dispatches on the device of its inputs: CUDA tensors go to the
hand-written kernel (``klt_cuda``, csrc/klt.cu: one launch a call, which
raises if it cannot build or launch, and counts the LK iterations it ran as
``profiler.device_count("klt.iterations")``); CPU tensors run
``track_plain``, the kernel's oracle. There the per-level iteration runs a
fixed ``max_iters`` trips: updates are masked by the per-point ``done``
flag exactly as in the JAX while-loop, so the result is identical and no
host synchronisation is needed for early exit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nrslam_tpu_torch.ops import image as image_ops
from nrslam_tpu_torch.utils import profiler

# LandmarkStatus codes (landmark_status.h:23-30).
TRACKED_WITH_3D = 0
TRACKED = 1
JUST_TRIANGULATED = 2
BAD = 3
OUT_IMAGE_BOUNDARIES = 4
BAD_FEATURE = 5

FLT_SCALE = 1.0 / (1 << 20)
IVAL_SCALE = 32.0
TILE = 48  # the JAX tracker's per-point tile (22 window + 2*13 margin)


def is_usable(status):
    """Tracked-with-3d / tracked / just-triangulated."""
    return status <= JUST_TRIANGULATED


class KLTConfig(NamedTuple):
    win: int = 21
    max_level: int = 4
    max_iters: int = 10
    epsilon: float = 1e-4
    min_eig_threshold: float = 1e-4


class KLTRefs(NamedTuple):
    """Per-point reference windows ("photometric information")."""

    points: torch.Tensor      # [P, 2]
    patch: torch.Tensor       # [P, L, W, W]
    patch_grad: torch.Tensor  # [P, L, W, W, 2]
    mean_i: torch.Tensor      # [P, L]
    mean_i2: torch.Tensor     # [P, L]
    valid: torch.Tensor       # [P, L]

    def level_slice(self, n_levels: int) -> "KLTRefs":
        """First ``n_levels`` pyramid levels of every per-level field."""
        return self._replace(
            patch=self.patch[:, :n_levels],
            patch_grad=self.patch_grad[:, :n_levels],
            mean_i=self.mean_i[:, :n_levels],
            mean_i2=self.mean_i2[:, :n_levels],
            valid=self.valid[:, :n_levels])


def build_pyramid(img, config: KLTConfig):
    return image_ops.build_pyramid(img, config.max_level + 1)


def _extract_patches(img, y0, x0, size: int):
    """Integer-aligned [P, size, size(, C)] windows, rows/cols clamped to
    the image border."""
    H, W = img.shape[0], img.shape[1]
    ar = torch.arange(size, device=img.device, dtype=torch.int64)
    rows = torch.clamp(y0.to(torch.int64)[:, None] + ar, 0, H - 1)
    cols = torch.clamp(x0.to(torch.int64)[:, None] + ar, 0, W - 1)
    return img[rows[:, :, None], cols[:, None, :]]


def _bilinear_from_int(win_plus1, fx, fy):
    """Bilinear interpolation of an (S+1) integer window down to S."""
    w00 = (1 - fx) * (1 - fy)
    w01 = fx * (1 - fy)
    w10 = (1 - fx) * fy
    w11 = fx * fy
    shape = (-1,) + (1,) * (win_plus1.dim() - 1)
    w00, w01, w10, w11 = (w.reshape(shape) for w in (w00, w01, w10, w11))
    return (w00 * win_plus1[:, :-1, :-1] + w01 * win_plus1[:, :-1, 1:]
            + w10 * win_plus1[:, 1:, :-1] + w11 * win_plus1[:, 1:, 1:])


def _sample_image_windows(img, pts, win: int):
    """Bilinear window centred at continuous pts: [P, win, win(, C)]."""
    half = (win - 1) * 0.5
    base_x = torch.floor(pts[:, 0] - half)
    base_y = torch.floor(pts[:, 1] - half)
    fx = pts[:, 0] - half - base_x
    fy = pts[:, 1] - half - base_y
    iw = _extract_patches(img, base_y, base_x, win + 1)
    return _bilinear_from_int(iw, fx, fy)


def _window_sums(x):
    return torch.sum(x, dim=(-2, -1))


def set_reference(pyramid, points, point_valid, config: KLTConfig,
                  mask=None) -> KLTRefs:
    """Precompute per-point per-level reference windows (a level is invalid
    when the window leaves the image or touches a masked pixel)."""
    win = config.win
    n_levels = len(pyramid)
    border_gap = round(win / 2)

    mask_pyramid = []
    if mask is not None:
        m = mask.to(torch.float32)
        for _ in range(n_levels):
            mask_pyramid.append(m)
            h2, w2 = m.shape[0] // 2, m.shape[1] // 2
            m = torch.minimum(
                torch.minimum(m[0:2 * h2:2, 0:2 * w2:2],
                              m[1:2 * h2:2, 0:2 * w2:2]),
                torch.minimum(m[0:2 * h2:2, 1:2 * w2:2],
                              m[1:2 * h2:2, 1:2 * w2:2]))

    patches, grads, means, means2, valids = [], [], [], [], []
    area = win * win
    for level, (img, grad) in enumerate(pyramid):
        pts_l = points * (1.0 / (1 << level))
        iw = _sample_image_windows(img, pts_l, win) * IVAL_SCALE
        gw = _sample_image_windows(grad, pts_l, win)

        h, w = img.shape
        ip = torch.floor(pts_l - (win - 1) * 0.5)
        in_bounds = ((ip[:, 0] >= -border_gap) & (ip[:, 0] < w - border_gap)
                     & (ip[:, 1] >= -border_gap) & (ip[:, 1] < h - border_gap))
        ok = in_bounds & point_valid
        if mask is not None:
            mw = _extract_patches(
                mask_pyramid[level],
                torch.floor(pts_l[:, 1] - (win - 1) * 0.5),
                torch.floor(pts_l[:, 0] - (win - 1) * 0.5), win + 1)
            ok = ok & (torch.amin(mw.reshape(mw.shape[0], -1), dim=-1) > 0.99)

        means.append(_window_sums(iw) * FLT_SCALE / area)
        means2.append(_window_sums(iw * iw) * FLT_SCALE / area)
        patches.append(iw)
        grads.append(gw)
        valids.append(ok)

    return KLTRefs(
        points=points,
        patch=torch.stack(patches, dim=1),
        patch_grad=torch.stack(grads, dim=1),
        mean_i=torch.stack(means, dim=1),
        mean_i2=torch.stack(means2, dim=1),
        valid=torch.stack(valids, dim=1),
    )


def _ssim_gate(img0, refs: KLTRefs, pts, statuses, min_ssim,
               config: KLTConfig):
    """Final SSIM outlier check vs the level-0 reference window."""
    win = config.win
    h, w = img0.shape
    border_gap = round(win / 2) + 1

    jw = _sample_image_windows(img0, pts, win) * IVAL_SCALE
    ip = torch.floor(pts - (win - 1) * 0.5)
    in_bounds = ((ip[:, 0] >= -border_gap) & (ip[:, 0] < w - border_gap * 2)
                 & (ip[:, 1] >= -border_gap) & (ip[:, 1] < h - border_gap * 2))

    cur = jw / 32.0
    ref = refs.patch[:, 0] / 32.0
    n = win * win
    n_inv = 1.0 / n
    n_inv_1 = 1.0 / (n - 1)
    mu_x = _window_sums(ref) * n_inv
    mu_y = _window_sums(cur) * n_inv
    xn = ref - mu_x[:, None, None]
    yn = cur - mu_y[:, None, None]
    sx2 = _window_sums(xn * xn) * n_inv_1
    sy2 = _window_sums(yn * yn) * n_inv_1
    sxy = _window_sums(xn * yn) * n_inv_1

    c1 = (0.01 * 255.0) ** 2
    c2 = (0.03 * 255.0) ** 2
    ssim = ((2 * mu_x * mu_y + c1) * (2 * sxy + c2)) / (
        (mu_x * mu_x + mu_y * mu_y + c1) * (sx2 + sy2 + c2))

    usable = is_usable(statuses)
    nan_pt = torch.any(torch.isnan(pts), dim=-1)
    statuses = torch.where(usable & (nan_pt | ~in_bounds),
                           OUT_IMAGE_BOUNDARIES, statuses)
    usable = is_usable(statuses)
    statuses = torch.where(usable & (ssim < min_ssim), BAD_FEATURE, statuses)
    return statuses, ssim


def track(pyramid, refs: KLTRefs, seeds, statuses, config: KLTConfig,
          min_ssim: float, use_initial_flow: bool = True):
    """Track all points into a new pyramid. Returns (points [P, 2],
    statuses [P])."""
    if seeds.device.type == "cpu":
        return track_plain(pyramid, refs, seeds, statuses, config, min_ssim,
                           use_initial_flow)
    from nrslam_tpu_torch.ops import klt_cuda
    pts, statuses, iters = klt_cuda.track(pyramid, refs, seeds, statuses,
                                          config, min_ssim, use_initial_flow)
    profiler.device_count("klt.iterations", iters)
    return pts, statuses


def track_plain(pyramid, refs: KLTRefs, seeds, statuses, config: KLTConfig,
                min_ssim: float, use_initial_flow: bool = True):
    """Plain PyTorch tracking (the CPU path and the kernel's oracle)."""
    win = config.win
    max_level = len(pyramid) - 1
    area = win * win
    eps = config.epsilon
    half = (win - 1) * 0.5
    margin = (TILE - (win + 1)) // 2
    border_gap = round(win / 2) + 1
    tiny = torch.finfo(torch.float32).tiny

    pts = seeds if use_initial_flow else refs.points.expand_as(seeds)
    pts = pts / (1 << max_level)

    for level in range(max_level, -1, -1):
        img, grad = pyramid[level]
        h, w = img.shape
        prev_pts_l = refs.points / (1 << level)

        ref_patch = refs.patch[:, level]
        ref_grad = refs.patch_grad[:, level]
        mean_i = refs.mean_i[:, level]
        mean_i2 = refs.mean_i2[:, level]
        ref_ok = refs.valid[:, level]

        ipp = torch.floor(prev_pts_l - half)
        prev_in = ((ipp[:, 0] >= -border_gap) & (ipp[:, 0] < w - border_gap)
                   & (ipp[:, 1] >= -border_gap) & (ipp[:, 1] < h - border_gap))
        track_this_level = is_usable(statuses) & prev_in & ref_ok
        if level == 0:
            statuses = torch.where(is_usable(statuses) & ~(prev_in & ref_ok),
                                   OUT_IMAGE_BOUNDARIES, statuses)

        start = pts
        tile_x0 = torch.floor(start[:, 0] - half).to(torch.int64) - margin
        tile_y0 = torch.floor(start[:, 1] - half).to(torch.int64) - margin

        prev_delta = torch.zeros_like(pts)
        done = ~track_this_level
        for j in range(config.max_iters):
            active = track_this_level & ~done

            base_x = torch.floor(pts[:, 0] - half)
            base_y = torch.floor(pts[:, 1] - half)
            fx = pts[:, 0] - half - base_x
            fy = pts[:, 1] - half - base_y
            dx_t = torch.clamp(base_x.to(torch.int64) - tile_x0, 0,
                               TILE - win - 1)
            dy_t = torch.clamp(base_y.to(torch.int64) - tile_y0, 0,
                               TILE - win - 1)
            jw = _bilinear_from_int(
                _extract_patches(img, tile_y0 + dy_t, tile_x0 + dx_t,
                                 win + 1), fx, fy) * IVAL_SCALE
            gw = _bilinear_from_int(
                _extract_patches(grad, tile_y0 + dy_t, tile_x0 + dx_t,
                                 win + 1), fx, fy)

            ipt = torch.floor(pts - half)
            cur_in = ((ipt[:, 0] >= -border_gap) & (ipt[:, 0] < w - border_gap)
                      & (ipt[:, 1] >= -border_gap)
                      & (ipt[:, 1] < h - border_gap))
            oob = active & ~cur_in
            if level == 0:
                statuses = torch.where(oob, OUT_IMAGE_BOUNDARIES, statuses)
            done = done | oob
            active = active & ~oob

            mean_j = _window_sums(jw) * FLT_SCALE / area
            mean_j2 = _window_sums(jw * jw) * FLT_SCALE / area
            alpha = torch.sqrt(mean_i2 / torch.clamp(mean_j2, min=1e-20))
            beta = mean_i - alpha * mean_j

            diff = jw * alpha[:, None, None] - ref_patch - beta[:, None, None]
            d = ref_grad + gw * alpha[:, None, None, None]
            ddx, ddy = d[..., 0], d[..., 1]

            b1 = _window_sums(diff * ddx) * FLT_SCALE
            b2 = _window_sums(diff * ddy) * FLT_SCALE
            a11 = _window_sums(ddx * ddx) * FLT_SCALE
            a12 = _window_sums(ddx * ddy) * FLT_SCALE
            a22 = _window_sums(ddy * ddy) * FLT_SCALE

            det = a11 * a22 - a12 * a12
            min_eig = (a22 + a11 - torch.sqrt((a11 - a22) ** 2
                                              + 4 * a12 * a12)) / (2.0 * area)
            degenerate = active & ((min_eig < config.min_eig_threshold)
                                   | (det < tiny))
            if level == 0:
                statuses = torch.where(degenerate, BAD_FEATURE, statuses)
            solve = active & ~degenerate

            safe_det = torch.where(torch.abs(det) > 0, det,
                                   torch.ones_like(det))
            delta = torch.stack([(a12 * b2 - a22 * b1) / safe_det,
                                 (a12 * b1 - a11 * b2) / safe_det], dim=-1)
            delta = torch.where(solve[:, None], delta, torch.zeros_like(delta))
            new_pts = pts + delta

            out_post = solve & ((new_pts[:, 0] < border_gap + 1)
                                | (new_pts[:, 0] >= w - 1 - border_gap)
                                | (new_pts[:, 1] < border_gap + 1)
                                | (new_pts[:, 1] >= h - 1 - border_gap))
            if level == 0:
                statuses = torch.where(out_post, OUT_IMAGE_BOUNDARIES,
                                       statuses)

            drift = torch.linalg.norm(new_pts - start, dim=-1)
            drifted = solve & ~out_post & (drift > 10.0)
            if level == 0:
                statuses = torch.where(drifted, BAD, statuses)
            new_pts = torch.where(drifted[:, None], start, new_pts)

            live = solve & ~out_post & ~drifted
            converged = live & (torch.sum(delta * delta, dim=-1) <= eps)
            oscillating = live & (j > 0) \
                & (torch.abs(delta[:, 0] + prev_delta[:, 0]) < 0.01) \
                & (torch.abs(delta[:, 1] + prev_delta[:, 1]) < 0.01)
            new_pts = torch.where((oscillating & ~converged)[:, None],
                                  new_pts - delta * 0.5, new_pts)

            done = done | out_post | drifted | converged | oscillating
            pts = torch.where(solve[:, None], new_pts, pts)
            prev_delta = delta

        if level > 0:
            pts = pts * 2.0

    statuses, _ = _ssim_gate(pyramid[0][0], refs, pts, statuses, min_ssim,
                             config)
    return pts, statuses
