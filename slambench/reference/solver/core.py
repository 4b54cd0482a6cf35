"""Huber IRLS + Levenberg-Marquardt pieces and small dense solves
(counterpart of nrslam_tpu/solver/core.py).

LM schedule follows g2o's Levenberg: lambda0 = 1e-5 * max diag(H); on a
positive gain ratio ``lambda *= max(1/3, 1 - (2 rho - 1)^3)``, else
``lambda *= nu; nu *= 2``.
"""

from __future__ import annotations

import torch

LM_TAU = 1e-5


def inv3x3(A):
    """Closed-form batched 3x3 inverse (adjugate / determinant)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    inv_det = 1.0 / torch.where(torch.abs(det) > 0, det, torch.ones_like(det))
    adj = torch.stack([
        torch.stack([A11, A12, A13], dim=-1),
        torch.stack([A21, A22, A23], dim=-1),
        torch.stack([A31, A32, A33], dim=-1),
    ], dim=-2)
    return adj * inv_det[..., None, None]


def huber_weight(chi2, delta2: float):
    """IRLS weight of the Huber kernel (g2o RobustKernelHuber)."""
    safe = torch.clamp(chi2, min=1e-20)
    return torch.where(chi2 <= delta2, torch.ones_like(chi2),
                       torch.sqrt(delta2 / safe))


def huber_rho(chi2, delta2: float):
    """Robustified chi2 contribution rho(e2)."""
    delta = delta2 ** 0.5
    return torch.where(chi2 <= delta2, chi2,
                       2.0 * delta * torch.sqrt(torch.clamp(chi2, min=1e-20))
                       - delta2)


def lm_lambda_init(h_diag):
    return LM_TAU * torch.amax(h_diag)


def lm_lambda_update(lam, nu, rho_gain):
    """(new_lambda, new_nu, accepted) from the gain ratio."""
    accepted = rho_gain > 0
    shrink = torch.clamp(1.0 - (2.0 * rho_gain - 1.0) ** 3, min=1.0 / 3.0)
    new_lam = torch.where(accepted, lam * shrink, lam * nu)
    new_nu = torch.where(accepted, torch.full_like(nu, 2.0), nu * 2.0)
    return new_lam, new_nu, accepted


def gain_ratio(chi2_old, chi2_new, dx, lam, g):
    """g2o gain ratio (chi2_old - chi2_new) / (dx . (lam dx - g))."""
    denom = torch.dot(dx, lam * dx - g)
    return (chi2_old - chi2_new) / torch.where(torch.abs(denom) > 0, denom,
                                               torch.ones_like(denom))


def pcg(hvp, b, m_inv, iters: int, tol: float = 1e-8):
    """Fixed-trip preconditioned CG for H x = b with a done mask.

    ``hvp`` includes any LM damping; ``m_inv`` applies the preconditioner.
    """
    x = torch.zeros_like(b)
    r = b
    z = m_inv(r)
    p = z
    rz = torch.dot(r, z)
    b2 = torch.dot(b, b)
    done = torch.zeros((), dtype=torch.bool, device=b.device)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    for _ in range(iters):
        hp = hvp(p)
        denom = torch.dot(p, hp)
        alpha = torch.where(torch.abs(denom) > 0, rz / denom, zero)
        alpha = torch.where(done, zero, alpha)
        x = x + alpha * p
        r = r - alpha * hp
        z = m_inv(r)
        rz_new = torch.dot(r, z)
        beta = torch.where(torch.abs(rz) > 0, rz_new / rz, zero)
        p = z + beta * p
        done = done | (torch.dot(r, r) <= tol * tol * b2)
        rz = torch.where(done, rz, rz_new)
    return x


def solve_spd6(H, g):
    """Solve the SPD 6x6 system H y = g via a 3x3-block Schur complement."""
    A = H[..., :3, :3]
    B = H[..., :3, 3:]
    C = H[..., 3:, 3:]
    g1 = g[..., :3]
    g2 = g[..., 3:]
    Ainv = inv3x3(A)
    AinvB = Ainv @ B
    S = C - B.transpose(-1, -2) @ AinvB
    Sinv = inv3x3(S)
    Ainv_g1 = torch.einsum("...ij,...j->...i", Ainv, g1)
    rhs2 = g2 - torch.einsum("...ji,...j->...i", B, Ainv_g1)
    y2 = torch.einsum("...ij,...j->...i", Sinv, rhs2)
    y1 = Ainv_g1 - torch.einsum("...ij,...j->...i", AinvB, y2)
    return torch.cat([y1, y2], dim=-1)


def inv_spd6(H):
    """Closed-form SPD 6x6 inverse via the 3x3 block Schur complement."""
    A = H[..., :3, :3]
    B = H[..., :3, 3:]
    C = H[..., 3:, 3:]
    Ainv = inv3x3(A)
    AinvB = Ainv @ B
    S = C - B.transpose(-1, -2) @ AinvB
    Sinv = inv3x3(S)
    TR = -AinvB @ Sinv
    TL = Ainv + AinvB @ Sinv @ AinvB.transpose(-1, -2)
    top = torch.cat([TL, TR], dim=-1)
    bottom = torch.cat([TR.transpose(-1, -2), Sinv], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def solve_dense(H, g, lam):
    """Solve (H + lam I) dx = -g for the 6x6 pose system."""
    n = H.shape[-1]
    Hd = H + lam * torch.eye(n, dtype=H.dtype, device=H.device)
    return -solve_spd6(Hd, g)


def inv_small(H):
    """Batched dense inverse without the host-synchronising error check."""
    return torch.linalg.inv_ex(H)[0]
