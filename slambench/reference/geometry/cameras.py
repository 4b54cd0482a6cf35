"""Pinhole and Kannala-Brandt-8 cameras (counterpart of
nrslam_tpu/geometry/cameras.py).

Parameters: pinhole ``[fx, fy, cx, cy]``; kb8 ``[fx, fy, cx, cy, k0..k3]``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slambench.reference.utils.device import resolve

PINHOLE = "pinhole"
KB8 = "kb8"


class Camera(NamedTuple):
    params: torch.Tensor
    kind: str = PINHOLE

    @property
    def fx(self):
        return self.params[..., 0]

    @property
    def fy(self):
        return self.params[..., 1]

    @property
    def cx(self):
        return self.params[..., 2]

    @property
    def cy(self):
        return self.params[..., 3]


def pinhole(fx, fy, cx, cy, device=None) -> Camera:
    """On the card unless ``device`` says otherwise (``utils.device``)."""
    return Camera(torch.tensor([fx, fy, cx, cy], dtype=torch.float32,
                               device=resolve(device)), PINHOLE)


def kannala_brandt8(fx, fy, cx, cy, k0, k1, k2, k3, device=None) -> Camera:
    """On the card unless ``device`` says otherwise (``utils.device``)."""
    return Camera(torch.tensor([fx, fy, cx, cy, k0, k1, k2, k3],
                               dtype=torch.float32, device=resolve(device)),
                  KB8)


def project(cam: Camera, X):
    """Camera-frame points [..., 3] -> pixels [..., 2]."""
    p = cam.params
    if cam.kind == PINHOLE:
        fx, fy, cx, cy = p[0], p[1], p[2], p[3]
        z = X[..., 2]
        return torch.stack([fx * X[..., 0] / z + cx,
                            fy * X[..., 1] / z + cy], dim=-1)
    if cam.kind == KB8:
        fx, fy, cx, cy, k0, k1, k2, k3 = p.unbind(0)
        x, y, z = X[..., 0], X[..., 1], X[..., 2]
        r2 = x * x + y * y
        theta = torch.atan2(torch.sqrt(r2), z)
        psi = torch.atan2(y, x)
        t2 = theta * theta
        r = theta * (1.0 + t2 * (k0 + t2 * (k1 + t2 * (k2 + t2 * k3))))
        return torch.stack([fx * r * torch.cos(psi) + cx,
                            fy * r * torch.sin(psi) + cy], dim=-1)
    raise ValueError(f"unknown camera kind {cam.kind}")


def unproject(cam: Camera, uv):
    """Pixels [..., 2] -> rays [..., 3] (pinhole z=1; KB8 after 10 fixed
    Newton steps on the distortion polynomial)."""
    p = cam.params
    if cam.kind == PINHOLE:
        fx, fy, cx, cy = p[0], p[1], p[2], p[3]
        x = (uv[..., 0] - cx) / fx
        y = (uv[..., 1] - cy) / fy
        return torch.stack([x, y, torch.ones_like(x)], dim=-1)
    if cam.kind == KB8:
        fx, fy, cx, cy, k0, k1, k2, k3 = p.unbind(0)
        pwx = (uv[..., 0] - cx) / fx
        pwy = (uv[..., 1] - cy) / fy
        theta_d = torch.sqrt(pwx * pwx + pwy * pwy)
        safe_td = torch.clamp(theta_d, min=1e-12)
        theta = theta_d
        for _ in range(10):
            t2 = theta * theta
            t4 = t2 * t2
            t6 = t4 * t2
            t8 = t4 * t4
            num = theta * (1 + k0 * t2 + k1 * t4 + k2 * t6 + k3 * t8) - theta_d
            den = 1 + 3 * k0 * t2 + 5 * k1 * t4 + 7 * k2 * t6 + 9 * k3 * t8
            theta = theta - num / den
        small = theta_d <= 1e-8
        theta = torch.where(small, torch.zeros_like(theta), theta)
        s = torch.where(small, torch.ones_like(theta),
                        torch.sin(theta) / safe_td)
        return torch.stack([s * pwx, s * pwy, torch.cos(theta)], dim=-1)
    raise ValueError(f"unknown camera kind {cam.kind}")


def projection_jacobian(cam: Camera, X):
    """Analytic d(project)/dX, shape [..., 2, 3]."""
    p = cam.params
    x, y, z = X[..., 0], X[..., 1], X[..., 2]
    if cam.kind == PINHOLE:
        fx, fy = p[0], p[1]
        zero = torch.zeros_like(x)
        inv_z = 1.0 / z
        inv_z2 = inv_z * inv_z
        row0 = torch.stack([fx * inv_z, zero, -fx * x * inv_z2], dim=-1)
        row1 = torch.stack([zero, fy * inv_z, -fy * y * inv_z2], dim=-1)
        return torch.stack([row0, row1], dim=-2)
    if cam.kind == KB8:
        fx, fy, cx, cy, k0, k1, k2, k3 = p.unbind(0)
        x2, y2, z2 = x * x, y * y, z * z
        r2 = x2 + y2
        r = torch.sqrt(r2)
        r3 = r2 * r
        theta = torch.atan2(r, z)
        t2 = theta * theta
        t4 = t2 * t2
        t6 = t4 * t2
        t8 = t4 * t4
        f = theta * (1 + k0 * t2 + k1 * t4 + k2 * t6 + k3 * t8)
        fd = 1 + 3 * k0 * t2 + 5 * k1 * t4 + 7 * k2 * t6 + 9 * k3 * t8
        denom = r2 * (r2 + z2)
        j00 = fx * (fd * z * x2 / denom + f * y2 / r3)
        j01 = fx * (fd * z * x * y / denom - f * x * y / r3)
        j02 = -fx * fd * x / (r2 + z2)
        j10 = fy * (fd * z * x * y / denom - f * x * y / r3)
        j11 = fy * (fd * z * y2 / denom + f * x2 / r3)
        j12 = -fy * fd * y / (r2 + z2)
        row0 = torch.stack([j00, j01, j02], dim=-1)
        row1 = torch.stack([j10, j11, j12], dim=-1)
        return torch.stack([row0, row1], dim=-2)
    raise ValueError(f"unknown camera kind {cam.kind}")


def unit_rays(cam: Camera, uv):
    """Unproject and L2-normalize."""
    r = unproject(cam, uv)
    return r / torch.linalg.norm(r, dim=-1, keepdim=True)
