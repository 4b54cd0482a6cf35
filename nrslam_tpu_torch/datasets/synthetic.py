"""Procedural deformable scene with exact ground truth (counterpart of
nrslam_tpu/datasets/synthetic.py: same surface, texture, trajectory and
per-pixel fixed-point ray/surface intersection)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from nrslam_tpu_torch.geometry import cameras, se3
from nrslam_tpu_torch.utils.device import resolve


class SceneConfig(NamedTuple):
    height: int = 240
    width: int = 320
    fx: float = 250.0
    fy: float = 250.0
    base_depth: float = 3.0
    relief: float = 0.25
    deform_amp: float = 0.0
    deform_freq: float = 0.35
    texture_scale: float = 3.0
    motion_translation: float = 0.012
    motion_rotation: float = 0.003
    camera_kind: str = cameras.PINHOLE
    kb_coeffs: tuple = (-0.01, 0.02, -0.01, 0.002)


def camera(config: SceneConfig, device=None) -> cameras.Camera:
    """On the card unless ``device`` says otherwise (``utils.device``)."""
    device = resolve(device)
    cx = (config.width - 1) / 2.0
    cy = (config.height - 1) / 2.0
    if config.camera_kind == cameras.KB8:
        k0, k1, k2, k3 = config.kb_coeffs
        return cameras.kannala_brandt8(config.fx, config.fy, cx, cy,
                                       k0, k1, k2, k3, device=device)
    return cameras.pinhole(config.fx, config.fy, cx, cy, device=device)


def surface_height(x, y, t, config: SceneConfig):
    static = (config.base_depth
              + config.relief * (torch.sin(1.3 * x) * torch.cos(1.1 * y)
                                 + 0.5 * torch.sin(2.9 * x + 1.7 * y)))
    phase = config.deform_freq * t
    deform = config.deform_amp * (
        torch.sin(1.9 * x + phase) * torch.cos(1.4 * y + 0.7 * phase)
        + 0.6 * torch.sin(0.9 * y + 1.3 * phase))
    return static + deform


def texture(x, y, config: SceneConfig):
    s = config.texture_scale
    v = (torch.sin(s * 3.1 * x) * torch.cos(s * 2.7 * y)
         + 0.7 * torch.sin(s * 7.3 * x + s * 5.1 * y)
         + 0.5 * torch.cos(s * 11.7 * x - s * 8.3 * y)
         + 0.35 * torch.sin(s * 17.9 * x + s * 13.1 * y)
         + 0.25 * torch.cos(s * 29.0 * x + s * 23.0 * y))
    return 128.0 + 45.0 * v


def camera_pose(frame_idx, config: SceneConfig, device=None) -> se3.SE3:
    """Smooth sweeping trajectory (Tcw), on the card unless ``device``
    says otherwise."""
    device = resolve(device)
    t = torch.tensor(float(frame_idx), dtype=torch.float32, device=device)
    tw = torch.stack([
        config.motion_rotation * torch.sin(0.1 * t) * t,
        config.motion_rotation * 0.6 * t,
        config.motion_rotation * 0.3 * torch.sin(0.05 * t) * t,
        config.motion_translation * t,
        config.motion_translation * 0.4 * torch.sin(0.2 * t) * t,
        config.motion_translation * 0.25 * t,
    ])
    return se3.exp(tw)


def render_frame(frame_idx, config: SceneConfig, device=None):
    """Render (gray [H, W], depth [H, W], Tcw) for a frame index, on the
    card unless ``device`` says otherwise."""
    return render_frame_at(camera_pose(frame_idx, config, device), frame_idx,
                           config)


def render_frame_at(Tcw: se3.SE3, frame_time, config: SceneConfig):
    """Render (gray, depth, Tcw) from an explicit camera pose at the scene
    clock ``frame_time``, on the pose's device: a stereo pair is the left
    pose and the left pose composed with a baseline offset
    (datasets/hamlyn_export.py)."""
    device = Tcw.q.device
    H, W = config.height, config.width
    cam = camera(config, device)
    Twc = se3.inverse(Tcw)

    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=device),
        torch.arange(W, dtype=torch.float32, device=device), indexing="ij")
    uv = torch.stack([xs, ys], dim=-1).reshape(-1, 2)
    rays_cam = cameras.unproject(cam, uv)
    rays_world = se3.quat_rotate(Twc.q[None], rays_cam)
    origin = Twc.t
    t_f = torch.tensor(float(frame_time), dtype=torch.float32, device=device)

    s = torch.full((H * W,), config.base_depth, dtype=torch.float32,
                   device=device)
    for _ in range(8):
        p = origin[None] + s[:, None] * rays_world
        f = surface_height(p[:, 0], p[:, 1], t_f, config)
        s = (f - origin[2]) / rays_world[:, 2]

    p = origin[None] + s[:, None] * rays_world
    gray = texture(p[:, 0], p[:, 1], config).reshape(H, W)
    depth = (s * rays_cam[:, 2]).reshape(H, W)
    return torch.clamp(gray, 0.0, 255.0), depth, Tcw


class SyntheticSequence:
    """Dataset-style wrapper: get_image / get_depth_image / get_camera_pose
    (simulation.h:34-38), rendered on ``device`` (the card unless it says
    otherwise)."""

    def __init__(self, config: SceneConfig = SceneConfig(),
                 n_frames: int = 100, device=None):
        self.config = config
        self.n_frames = n_frames
        self.device = resolve(device)

    def __len__(self):
        return self.n_frames

    def get_frame(self, idx):
        """(gray [H, W], depth [H, W], Tcw)."""
        return render_frame(idx, self.config, self.device)

    def get_image(self, idx):
        return self.get_frame(idx)[0]

    def get_depth_image(self, idx):
        return self.get_frame(idx)[1]

    def get_camera_pose(self, idx):
        return self.get_frame(idx)[2]
