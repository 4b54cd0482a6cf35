"""Two-view midpoint triangulation and parallax (counterpart of
nrslam_tpu/geometry/triangulation.py)."""

from __future__ import annotations

import torch

from slambench.reference.geometry import se3


def rays_parallax_cosine(ray1, ray2):
    num = torch.sum(ray1 * ray2, dim=-1)
    den = torch.linalg.norm(ray1, dim=-1) * torch.linalg.norm(ray2, dim=-1)
    return num / den


def rays_parallax(ray1, ray2):
    """Angle (radians) between two bundles of rays [..., 3]."""
    return torch.arccos(torch.clamp(rays_parallax_cosine(ray1, ray2),
                                    max=1.0))


def triangulate_midpoint(ray1, ray2, T1w: se3.SE3, T2w: se3.SE3):
    """Inverse-depth-weighted midpoint triangulation (Lee & Civera).

    Degenerate configurations yield non-finite values the caller masks.
    """
    f0 = ray1 / torch.linalg.norm(ray1, dim=-1, keepdim=True)
    f1 = ray2 / torch.linalg.norm(ray2, dim=-1, keepdim=True)

    T10 = se3.compose(T2w, se3.inverse(T1w))
    t = T10.t
    Rf0 = se3.quat_rotate(T10.q, f0)

    p = se3.cross(Rf0, f1)
    q = se3.cross(Rf0, torch.broadcast_to(t, Rf0.shape))
    r = se3.cross(f1, torch.broadcast_to(t, f1.shape))

    qn = torch.linalg.norm(q, dim=-1, keepdim=True)
    rn = torch.linalg.norm(r, dim=-1, keepdim=True)
    pn = torch.linalg.norm(p, dim=-1, keepdim=True)

    x1 = qn / (qn + rn) * (t + rn / pn * (Rf0 + f1))
    return se3.apply(se3.inverse(T2w), x1)


def squared_reprojection_error(uv1, uv2):
    d = uv1 - uv2
    return torch.sum(d * d, dim=-1)
