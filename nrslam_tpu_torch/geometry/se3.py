"""Batched SE(3) on (quaternion wxyz, translation) pairs.

Counterpart of nrslam_tpu/geometry/se3.py: same conventions (Hamilton
quaternions ``[w, x, y, z]``, twists ``[omega, v]`` rotation first,
left-multiplicative retraction ``exp(twist) * T``), broadcasting over leading
batch dimensions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SE3(NamedTuple):
    """Rigid transform X -> R X + t as unit quaternion [..., 4] + t [..., 3]."""

    q: torch.Tensor
    t: torch.Tensor


def identity(batch_shape=(), dtype=torch.float32, device=None) -> SE3:
    q = torch.zeros(tuple(batch_shape) + (4,), dtype=dtype, device=device)
    q[..., 0].fill_(1.0)  # a fill, which a CUDA graph's capture can take
    t = torch.zeros(tuple(batch_shape) + (3,), dtype=dtype, device=device)
    return SE3(q, t)


def cross(a, b):
    """Cross product over the last axis, broadcasting (jnp.cross order)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1,
                        a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def quat_multiply(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_conjugate(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_normalize(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_rotate(q, v):
    """v + 2*w*(u x v) + 2*(u x (u x v))."""
    u = q[..., 1:]
    w = q[..., :1]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_to_matrix(q):
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m):
    """Rotation matrix [..., 3, 3] -> wxyz quaternion, branch-free
    (Shepperd): the best-conditioned of four constructions, w >= 0."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    qw = torch.stack([1 + m00 + m11 + m22, m21 - m12, m02 - m20, m10 - m01],
                     -1)
    qx = torch.stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20],
                     -1)
    qy = torch.stack([m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21],
                     -1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22],
                     -1)
    traces = torch.stack([1 + m00 + m11 + m22, 1 + m00 - m11 - m22,
                          1 - m00 + m11 - m22, 1 - m00 - m11 + m22], -1)
    best = torch.argmax(traces, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = quat_normalize(torch.gather(cands, -2, idx)[..., 0, :])
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quat_slerp(q0, q1, u):
    """Spherical interpolation between unit quaternions (shortest arc),
    falling back to lerp where they are nearly parallel."""
    u = torch.as_tensor(u, dtype=q0.dtype, device=q0.device)[..., None]
    d = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(d < 0, -q1, q1)
    theta = torch.arccos(torch.clamp(torch.abs(d), -1.0, 1.0))
    sin_theta = torch.sin(theta)
    near = sin_theta < 1e-6
    safe = torch.where(near, torch.ones_like(sin_theta), sin_theta)
    w0 = torch.where(near, 1.0 - u, torch.sin((1.0 - u) * theta) / safe)
    w1 = torch.where(near, u, torch.sin(u * theta) / safe)
    return quat_normalize(w0 * q0 + w1 * q1)


def compose(a: SE3, b: SE3) -> SE3:
    """a * b (apply b first, then a)."""
    return SE3(quat_normalize(quat_multiply(a.q, b.q)),
               quat_rotate(a.q, b.t) + a.t)


def inverse(T: SE3) -> SE3:
    qinv = quat_conjugate(T.q)
    return SE3(qinv, -quat_rotate(qinv, T.t))


def apply(T: SE3, X):
    """Transform points X [..., 3]."""
    return quat_rotate(T.q, X) + T.t


def to_matrix(T: SE3):
    """Homogeneous [..., 4, 4] matrix of T."""
    R = quat_to_matrix(T.q)
    top = torch.cat([R, T.t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                          device=R.device).expand(T.t.shape[:-1] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def from_matrix(M) -> SE3:
    return SE3(matrix_to_quat(M[..., :3, :3]), M[..., :3, 3])


def hat(omega):
    ox, oy, oz = omega.unbind(-1)
    zero = torch.zeros_like(ox)
    m = torch.stack([zero, -oz, oy, oz, zero, -ox, -oy, ox, zero], dim=-1)
    return m.reshape(omega.shape[:-1] + (3, 3))


def exp(twist) -> SE3:
    """SE(3) exponential of [..., 6] = [omega, v], Taylor-guarded at 0."""
    omega, v = twist[..., :3], twist[..., 3:]
    theta2 = torch.sum(omega * omega, dim=-1, keepdim=True)
    small = theta2 < 1e-12
    safe_theta2 = torch.where(small, torch.ones_like(theta2), theta2)
    safe_theta = torch.sqrt(safe_theta2)
    theta = torch.where(small, torch.zeros_like(safe_theta), safe_theta)

    half = 0.5 * safe_theta
    sinc_half = torch.where(small, 0.5 - theta2 / 48.0,
                            torch.sin(half) / safe_theta)
    qw = torch.cos(0.5 * theta)
    q = torch.cat([qw, omega * sinc_half], dim=-1)

    A = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(safe_theta)) / safe_theta2)
    B = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (safe_theta - torch.sin(safe_theta))
                    / (safe_theta2 * safe_theta))
    wx = hat(omega)
    wx2 = wx @ wx
    eye = torch.eye(3, dtype=twist.dtype, device=twist.device)
    Vm = eye + A[..., None] * wx + B[..., None] * wx2
    t = torch.einsum("...ij,...j->...i", Vm, v)
    return SE3(quat_normalize(q), t)


def log(T: SE3):
    """SE(3) logarithm -> twist [..., 6] = [omega, v]."""
    q = quat_normalize(T.q)
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    u = q[..., 1:]
    un2 = torch.sum(u * u, dim=-1, keepdim=True)
    small = un2 < 1e-14
    un = torch.sqrt(torch.where(small, torch.ones_like(un2), un2))
    theta_full = 2.0 * torch.atan2(
        torch.where(small, torch.zeros_like(un), un), w)
    scale = torch.where(small, 2.0 / torch.clamp(w, min=1e-12),
                        theta_full / un)
    omega = u * scale

    theta2 = torch.sum(omega * omega, dim=-1, keepdim=True)
    small_t = theta2 < 1e-12
    safe_th2 = torch.where(small_t, torch.ones_like(theta2), theta2)
    safe_th = torch.sqrt(safe_th2)
    half = 0.5 * safe_th
    cot_term = torch.where(
        small_t, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.sin(half)) / safe_th2)
    wx = hat(omega)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    Vinv = eye - 0.5 * wx + cot_term[..., None] * (wx @ wx)
    v = torch.einsum("...ij,...j->...i", Vinv, T.t)
    return torch.cat([omega, v], dim=-1)


def retract(T: SE3, twist) -> SE3:
    """Left-multiplicative update exp(twist) * T (g2o expmap oplus)."""
    return compose(exp(twist), T)


def slerp(T0: SE3, T1: SE3, u) -> SE3:
    """Slerp of the rotation and lerp of the translation (the reference's
    trajectory interpolation in the init refinement)."""
    u = torch.as_tensor(u, dtype=T0.t.dtype, device=T0.t.device)
    return SE3(quat_slerp(T0.q, T1.q, u), T0.t + (T1.t - T0.t) * u[..., None])


def stack(transforms, dim: int = 0) -> SE3:
    return SE3(torch.stack([T.q for T in transforms], dim=dim),
               torch.stack([T.t for T in transforms], dim=dim))


def index(T: SE3, idx) -> SE3:
    return SE3(T.q[idx], T.t[idx])

