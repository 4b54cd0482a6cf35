"""Port parity of the monocular initializer (nrslam_tpu/slam/initializer.py)
on the fixtures of tests/test_initializer.py and on rendered frames, with
the JAX package's own RANSAC draws fed to the port (``jax_ransac_draws``).

Tolerances: E is compared up to its sign (the SVD null vector's sign is
LAPACK's choice). An 8-point E is the null vector of an 8x9 float32 system
whose error grows with the sample's condition number c = s_1 / s_8: each of
16 draws is held to 1e-5 c (~100 float32 ulps times c); the refit E
(smallest eigenvector of a 9x9 normal matrix summed over ~270 inliers) to
1e-3 (measured 1.5e-4). Poses within 1e-4 for one decomposition and
1e-3 after the refinement's three pose-only solves; inlier and point masks
may differ on at most 1% of entries (a ray on the 0.005 rad epipolar or the
5.991 px^2 reprojection gate can flip on a last-bit difference); landmarks
within 1e-3 relative to their depth.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrslam_tpu.datasets import synthetic as jsyn
from nrslam_tpu.geometry import cameras as jcam
from nrslam_tpu.ops import klt as jklt
from nrslam_tpu.slam import initializer as ji
from nrslam_tpu.slam.state import Config
from nrslam_tpu_torch.slam import initializer as ti
from nrslam_tpu_torch.utils import profiler

from test_initializer import CAM, CFG, make_state, synthetic_correspondences
from torch_parity import jax_ransac_draws, np_of, quat_err, to_port

torch.set_num_threads(1)


def _rays(ref_uv, cur_uv):
    return jcam.unit_rays(CAM, ref_uv), jcam.unit_rays(CAM, cur_uv)


def _sign_free(Ea, Eb):
    Ea, Eb = np_of(Ea), np_of(Eb)
    return min(np.abs(Ea - Eb).max(), np.abs(Ea + Eb).max())


def _agree(a, b, frac=0.99):
    assert (np_of(a) == np_of(b)).mean() >= frac


def _assert_pose(Tj, Tt, tol):
    assert quat_err(Tj.q, Tt.q) < tol
    assert np.abs(np_of(Tj.t) - np_of(Tt.t)).max() < tol


def test_kmeans():
    pts = jnp.concatenate([
        jax.random.normal(jax.random.PRNGKey(0), (50, 2)) + jnp.array([10.0, 0]),
        jax.random.normal(jax.random.PRNGKey(1), (50, 2)) - jnp.array([10.0, 0]),
        jax.random.normal(jax.random.PRNGKey(3), (60, 2)) * 4.0])
    valid = jnp.arange(160) % 7 != 3
    key = jax.random.PRNGKey(2)
    lj = ji._kmeans(pts, valid, 5, 10, key)
    perm, _ = jax_ransac_draws(key, 160, 1)
    lt = ti._kmeans(to_port(pts), to_port(valid), 5, 10, perm)
    assert np.array_equal(np_of(lj), np_of(lt))


def test_eight_point_and_epipolar_inliers():
    _, _, ref_uv, cur_uv = synthetic_correspondences(outlier_frac=0.0)
    rr, cr = _rays(ref_uv, cur_uv)
    idx = np.random.default_rng(0).integers(0, 300, (16, 8))
    Ej = ji._eight_point(rr[idx], cr[idx])
    Et = ti._eight_point(to_port(rr)[idx], to_port(cr)[idx])
    A = np.concatenate([np_of(rr)[idx] * np_of(cr)[idx][..., c:c + 1]
                        for c in range(3)], -1).astype(np.float64)
    sv = np.linalg.svd(A, compute_uv=False)                  # [16, 8]
    for h in range(16):
        cond = sv[h, 0] / sv[h, 7]
        assert _sign_free(Ej[h], Et[h]) < 1e-5 * cond, (h, cond)
    _, _, ref_o, cur_o = synthetic_correspondences(outlier_frac=0.2, seed=1)
    rr_o, cr_o = _rays(ref_o, cur_o)
    inl_j = ji._epipolar_inliers(Ej, rr_o, cr_o, CFG.epipolar_threshold)
    inl_t = ti._epipolar_inliers(to_port(Ej), to_port(rr_o), to_port(cr_o),
                                 CFG.epipolar_threshold)
    _agree(inl_j, inl_t)
    assert 0.5 < np_of(inl_t).mean() < 0.95


def test_ransac_and_reconstruction():
    _, _, ref_uv, cur_uv = synthetic_correspondences()
    state = make_state(ref_uv, cur_uv)
    tracked = state.valid & (state.status == ji.klt.TRACKED)
    rr, cr = jcam.unit_rays(CAM, state.ref_keypoints), \
        jcam.unit_rays(CAM, state.cur_keypoints)
    key = jax.random.PRNGKey(0)
    Ej, inl_j = ji.find_essential_ransac(rr, cr, tracked, CFG, key)
    perm, gumbel = jax_ransac_draws(key, CFG.max_features, CFG.n_hypotheses)
    Et, inl_t = ti.find_essential_ransac(to_port(rr), to_port(cr),
                                         to_port(tracked), to_port(CFG), perm,
                                         gumbel)
    assert _sign_free(Ej, Et) < 1e-3
    _agree(inl_j, inl_t)

    # Decomposition and triangulation from the JAX E / inliers.
    Tj = ji.reconstruct_cameras(Ej, rr, cr, inl_j)
    Tt = ti.reconstruct_cameras(to_port(Ej), to_port(rr), to_port(cr),
                                to_port(inl_j))
    _assert_pose(Tj, Tt, 1e-4)
    # ... and from -E (the null vector's other sign): the same pose.
    _assert_pose(Tj, ti.reconstruct_cameras(-to_port(Ej), to_port(rr),
                                            to_port(cr), to_port(inl_j)),
                 1e-4)
    Xj, okj, lowj = ji.reconstruct_points(CAM, Tj, state.ref_keypoints,
                                          state.cur_keypoints, inl_j, CFG)
    Xt, okt, lowt = ti.reconstruct_points(
        to_port(CAM), to_port(Tj), to_port(state.ref_keypoints),
        to_port(state.cur_keypoints), to_port(inl_j), to_port(CFG))
    _agree(okj, okt)
    _agree(lowj, lowt)
    ok = np_of(okj) & np_of(okt)
    assert ok.sum() >= 80
    err = np.linalg.norm(np_of(Xj)[ok] - np_of(Xt)[ok], axis=-1) \
        / np_of(Xj)[ok, 2]
    assert err.max() < 1e-3


@pytest.mark.parametrize("motion", ["general", "pure_rotation"])
def test_try_initialize(motion):
    """The whole attempt, refinement included on success; a pure rotation
    fails the parallax gate in both packages."""
    if motion == "general":
        _, _, ref_uv, cur_uv = synthetic_correspondences()
    else:
        ks = jax.random.split(jax.random.PRNGKey(1), 3)
        X = jnp.stack([
            jax.random.uniform(ks[0], (300,), minval=-1.2, maxval=1.2),
            jax.random.uniform(ks[1], (300,), minval=-0.9, maxval=0.9),
            jax.random.uniform(ks[2], (300,), minval=2.0, maxval=5.0)], -1)
        T_rot = ji.se3.exp(jnp.array([0.0, 0.05, 0.02, 0.0, 0.0, 0.0]))
        ref_uv = jcam.project(CAM, X)
        cur_uv = jcam.project(CAM, ji.se3.apply(T_rot, X))
    state = make_state(ref_uv, cur_uv)
    key = jax.random.PRNGKey(0)
    rj = ji.try_initialize(CAM, state, CFG, key)
    perm, gumbel = jax_ransac_draws(key, CFG.max_features, CFG.n_hypotheses)
    before = profiler.tallies().get("initializer.refines", 0)
    rt = ti.try_initialize(to_port(CAM), to_port(state), to_port(CFG), perm,
                           gumbel)
    assert bool(rj.success) == bool(rt.success) == (motion == "general")
    assert profiler.tallies().get("initializer.refines", 0) \
        == before + (motion == "general")
    if motion == "general":
        _assert_pose(rj.Tcw, rt.Tcw, 1e-3)
        _agree(rj.point_ok, rt.point_ok)
        ok = np_of(rj.point_ok) & np_of(rt.point_ok)
        assert ok.sum() >= 80
        err = np.linalg.norm(np_of(rj.landmarks)[ok] - np_of(rt.landmarks)[ok],
                             axis=-1) / np_of(rj.landmarks)[ok, 2]
        assert err.max() < 1e-3


def test_reset_track_and_init_step_on_rendered_frames():
    """reset + the per-frame init_step of the System from a rendered
    sequence (120x160), the JAX draws of each attempt fed to the port; the
    success flag of every frame agrees and the success frame's result
    matches."""
    scene = jsyn.SceneConfig(height=120, width=160, fx=125.0, fy=125.0)
    cam = jsyn.camera(scene)
    kcfg = Config(max_points=128).klt_config
    icfg = ji.InitializerConfig(max_features=192, min_matches=30,
                                min_triangulated=25, rad_per_pixel=1 / 125.0,
                                n_hypotheses=48)
    tcam, tkcfg, ticfg = to_port(cam), to_port(kcfg), to_port(icfg)
    pyr = jklt.build_pyramid(jsyn.render_frame(0, scene)[0], kcfg)
    mask = jnp.ones((120, 160), bool)
    sj = ji.reset(pyr, mask, jnp.int32(0), kcfg, icfg)
    st = ti.reset(to_port(pyr), to_port(mask), 0, tkcfg, ticfg)
    for f in ("ref_keypoints", "valid", "track_id", "status",
              "next_track_id"):
        assert np.array_equal(np_of(getattr(sj, f)), np_of(getattr(st, f))), f
    for f in sj.refs._fields:
        assert np.abs(np_of(getattr(sj.refs, f)).astype(np.float64)
                      - np_of(getattr(st.refs, f))).max() < 1e-3, f

    key = jax.random.PRNGKey(4)
    successes = []
    for i in range(1, 8):
        pyr = jklt.build_pyramid(jsyn.render_frame(i, scene)[0], kcfg)
        tj, _ = ji.track_frame(sj, pyr, kcfg, icfg)
        tt, _ = ti.track_frame(st, to_port(pyr), tkcfg, ticfg)
        assert np.array_equal(np_of(tj.status), np_of(tt.status)), i
        assert np.abs(np_of(tj.cur_keypoints)
                      - np_of(tt.cur_keypoints)).max() < 1e-2, i
        sub = jax.random.fold_in(key, i - 1)
        sj, rj = ji.init_step(sj, pyr, mask, sub, cam.params, cam.kind, kcfg,
                              icfg)
        perm, gumbel = jax_ransac_draws(sub, icfg.max_features,
                                        icfg.n_hypotheses)
        st_next, rt = ti.init_step(st, to_port(pyr), to_port(mask), perm,
                                   gumbel, tcam, tkcfg, ticfg)
        assert bool(rj.success) == bool(rt.success), i
        successes.append(bool(rj.success))
        if bool(rj.success):
            _assert_pose(rj.Tcw, rt.Tcw, 1e-3)
            _agree(rj.point_ok, rt.point_ok)
            break
        assert np.array_equal(np_of(sj.valid), np_of(st_next.valid)), i
        st = to_port(sj)  # carry on from the reference's state
    assert successes[-1], successes
