"""Port parity: SE(3), cameras, triangulation and stats against the JAX
package on the CPU (float32). Inputs come from numpy seeds and go to both.

Tolerance: max-abs 1e-5 (scaled by magnitude for pixel outputs): both sides
evaluate the same float32 formulas; only libm rounding (sin, atan2, sqrt)
and operation fusion differ, at a few ulp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrslam_tpu.geometry import cameras as jcam
from nrslam_tpu.geometry import se3 as jse3
from nrslam_tpu.geometry import triangulation as jtri
from nrslam_tpu.utils import stats as jstats
from nrslam_tpu_torch.geometry import cameras as tcam
from nrslam_tpu_torch.geometry import se3 as tse3
from nrslam_tpu_torch.geometry import triangulation as ttri
from nrslam_tpu_torch.utils import stats as tstats

torch.set_num_threads(1)

TOL = 1e-5


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _close(a, b, tol=TOL, rel=False):
    a = np.asarray(a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                   else a, np.float64)
    b = np.asarray(b, np.float64)
    scale = max(1.0, np.max(np.abs(b))) if rel else 1.0
    same = (a == b) | (np.isnan(a) & np.isnan(b))  # inf/NaN on both sides
    with np.errstate(invalid="ignore"):
        err = np.max(np.where(same, 0.0, np.abs(a - b))) / scale
    assert err <= tol, err


def _twists(rng, n, rot=0.5, trans=0.3):
    tw = np.concatenate([rng.uniform(-rot, rot, (n, 3)),
                         rng.uniform(-trans, trans, (n, 3))], -1)
    tw[0, :3] = 0.0           # exact zero rotation (small-angle branch)
    tw[1, :3] = 1e-8
    return tw.astype(np.float32)


def test_se3_exp_log_compose_inverse_apply_retract():
    rng = np.random.default_rng(0)
    tw = _twists(rng, 64)
    tw2 = _twists(rng, 64)
    X = rng.normal(size=(64, 3)).astype(np.float32)

    Tj, Tt = jse3.exp(jnp.asarray(tw)), tse3.exp(_t(tw))
    _close(Tt.q, Tj.q)
    _close(Tt.t, Tj.t)
    _close(tse3.log(Tt), jse3.log(Tj))

    T2j, T2t = jse3.exp(jnp.asarray(tw2)), tse3.exp(_t(tw2))
    Cj, Ct = jse3.compose(Tj, T2j), tse3.compose(Tt, T2t)
    _close(Ct.q, Cj.q)
    _close(Ct.t, Cj.t)
    Ij, It = jse3.inverse(Tj), tse3.inverse(Tt)
    _close(It.q, Ij.q)
    _close(It.t, Ij.t)
    _close(tse3.apply(Tt, _t(X)), jse3.apply(Tj, jnp.asarray(X)))
    Rj, Rt = jse3.retract(Tj, jnp.asarray(tw2)), tse3.retract(Tt, _t(tw2))
    _close(Rt.q, Rj.q)
    _close(Rt.t, Rj.t)
    _close(tse3.quat_to_matrix(Tt.q), jse3.quat_to_matrix(Tj.q))
    idx = np.array([3, 1, 7])
    _close(tse3.index(Tt, _t(idx)).q, jse3.index(Tj, jnp.asarray(idx)).q)


def test_matrix_to_quat():
    """Random rotations plus rotations by ~pi about each axis, so every one
    of the four Shepperd constructions is picked; w >= 0 on both sides."""
    rng = np.random.default_rng(1)
    rv = rng.normal(size=(64, 3))
    rv *= rng.uniform(0, np.pi, (64, 1)) / np.linalg.norm(rv, axis=-1,
                                                          keepdims=True)
    rv[:3] = 3.1 * np.eye(3)
    tw = np.concatenate([rv, np.zeros_like(rv)], -1).astype(np.float32)
    m = jse3.quat_to_matrix(jse3.exp(jnp.asarray(tw)).q)
    qj, qt = jse3.matrix_to_quat(m), tse3.matrix_to_quat(_t(m))
    _close(qt, qj)
    _close(tse3.quat_to_matrix(qt), m)
    assert (qt[:, 0] >= 0).all()


CAMS = {
    "pinhole": ((300.0, 310.0, 160.0, 120.0), ()),
    "kb8": ((300.0, 310.0, 160.0, 120.0), (0.05, -0.01, 0.004, -0.001)),
}


def _cams(kind):
    f, k = CAMS[kind]
    if kind == "pinhole":
        return jcam.pinhole(*f), tcam.pinhole(*f, device="cpu")
    return (jcam.kannala_brandt8(*f, *k),
            tcam.kannala_brandt8(*f, *k, device="cpu"))


@pytest.mark.parametrize("kind", ["pinhole", "kb8"])
def test_camera_project_unproject_jacobian(kind):
    rng = np.random.default_rng(1)
    cj, ct = _cams(kind)
    X = np.stack([rng.uniform(-1, 1, 200), rng.uniform(-1, 1, 200),
                  rng.uniform(1.5, 4.0, 200)], -1).astype(np.float32)
    uv = np.stack([rng.uniform(0, 320, 200), rng.uniform(0, 240, 200)],
                  -1).astype(np.float32)
    # Pixels: relative tolerance against the ~300 px magnitude.
    _close(tcam.project(ct, _t(X)), jcam.project(cj, jnp.asarray(X)),
           rel=True)
    _close(tcam.unproject(ct, _t(uv)), jcam.unproject(cj, jnp.asarray(uv)))
    _close(tcam.unit_rays(ct, _t(uv)), jcam.unit_rays(cj, jnp.asarray(uv)))
    _close(tcam.projection_jacobian(ct, _t(X)),
           jcam.projection_jacobian(cj, jnp.asarray(X)), rel=True)


def test_triangulation_midpoint_and_parallax():
    rng = np.random.default_rng(2)
    n = 100
    T1 = tse3.exp(_t(_twists(rng, n, 0.05, 0.1)))
    T2 = tse3.exp(_t(_twists(rng, n, 0.05, 0.1)))
    T1j = jse3.SE3(jnp.asarray(T1.q.numpy()), jnp.asarray(T1.t.numpy()))
    T2j = jse3.SE3(jnp.asarray(T2.q.numpy()), jnp.asarray(T2.t.numpy()))
    r1 = np.concatenate([rng.uniform(-0.3, 0.3, (n, 2)), np.ones((n, 1))],
                        -1).astype(np.float32)
    r2 = np.concatenate([rng.uniform(-0.3, 0.3, (n, 2)), np.ones((n, 1))],
                        -1).astype(np.float32)
    Xj = jtri.triangulate_midpoint(jnp.asarray(r1), jnp.asarray(r2), T1j, T2j)
    Xt = ttri.triangulate_midpoint(_t(r1), _t(r2), T1, T2)
    # Midpoints of near-parallel rays are ill-conditioned: compare relative
    # to the point's magnitude.
    ok = np.isfinite(np.asarray(Xj)).all(-1)
    err = np.abs(Xt.numpy()[ok] - np.asarray(Xj)[ok]) \
        / np.maximum(1.0, np.abs(np.asarray(Xj)[ok]))
    assert np.median(err) < 1e-5 and np.max(err) < 1e-2, np.max(err)
    _close(ttri.rays_parallax(_t(r1), _t(r2)),
           jtri.rays_parallax(jnp.asarray(r1), jnp.asarray(r2)), tol=1e-4)
    _close(ttri.squared_reprojection_error(_t(r1[:, :2]), _t(r2[:, :2])),
           jtri.squared_reprojection_error(jnp.asarray(r1[:, :2]),
                                           jnp.asarray(r2[:, :2])))


@pytest.mark.parametrize("n_valid", [0, 1, 7, 100])
def test_stats(n_valid):
    rng = np.random.default_rng(3 + n_valid)
    x = rng.exponential(size=128).astype(np.float32)
    mask = np.zeros(128, bool)
    mask[rng.permutation(128)[:n_valid]] = True
    xj, mj = jnp.asarray(x), jnp.asarray(mask)
    xt, mt = _t(x), _t(mask)
    _close(tstats.masked_mean(xt, mt), jstats.masked_mean(xj, mj))
    _close(tstats.masked_sigma(xt, mt), jstats.masked_sigma(xj, mj))
    _close(tstats.masked_median(xt, mt), jstats.masked_median(xj, mj))
    _close(tstats.iqr_upper_threshold(xt, mt),
           jstats.iqr_upper_threshold(xj, mj))
