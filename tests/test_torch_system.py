"""Port parity of the system facade's parts against the JAX package:
``bootstrap_map`` from one converted InitializationResult, the depth-RMSE
evaluator, the trajectory metrics and the synthetic sequence. The whole
entry path from frame 0 is tests/test_torch_system_entry.py.

Tolerances: bootstrap_map's selections are equal and its floats within
1e-5 (one scale division); evaluator and metrics within 1e-5 relative
(float32 reductions in another order, float64 numpy).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from nrslam_tpu.datasets import synthetic as jsyn
from nrslam_tpu.eval import evaluator as jev
from nrslam_tpu.eval import metrics as jmet
from nrslam_tpu.geometry import se3 as jse3
from nrslam_tpu.ops import klt as jklt
from nrslam_tpu.slam import initializer as ji
from nrslam_tpu.slam import state as jstate
from nrslam_tpu.slam import system as jsys
from nrslam_tpu.slam.state import Config
from nrslam_tpu_torch.datasets import synthetic as tsyn
from nrslam_tpu_torch.eval import evaluator as tev
from nrslam_tpu_torch.eval import metrics as tmet
from nrslam_tpu_torch.slam import state as tstate
from nrslam_tpu_torch.slam import system as tsys

from torch_parity import entry_setting, np_of, to_port

torch.set_num_threads(1)


def _close(a, b, tol):
    a, b = np_of(a).astype(np.float64), np_of(b).astype(np.float64)
    assert np.max(np.abs(a - b)) <= tol, np.max(np.abs(a - b))


def test_bootstrap_map():
    """From the JAX init result on the entry test's scene."""
    scene, cam, config, init_config = entry_setting()
    H, W = scene.height, scene.width
    kcfg = config.klt_config
    key = jax.random.PRNGKey(4)
    mask = jnp.ones((H, W), bool)
    sj = ji.reset(jklt.build_pyramid(jsyn.render_frame(0, scene)[0], kcfg),
                  mask, jnp.int32(0), kcfg, init_config)
    for i in range(1, 12):
        pyr = jklt.build_pyramid(jsyn.render_frame(i, scene)[0], kcfg)
        sj, res = ji.init_step(sj, pyr, mask, jax.random.fold_in(key, i - 1),
                               cam.params, cam.kind, kcfg, init_config)
        if bool(res.success):
            break
    assert bool(res.success)
    bj = jsys.bootstrap_map(jstate.empty_state(config, (H, W)), res, pyr,
                            config)
    bt = tsys.bootstrap_map(tstate.empty_state(config, (H, W), device="cpu"), to_port(res),
                            to_port(pyr), config)
    for f in ("slot_used", "track_id", "has_3d", "status", "next_track_id",
              "kf_valid", "kf_obs", "kf_id", "tb_valid", "frame_id"):
        assert np.array_equal(np_of(getattr(bj, f)), np_of(getattr(bt, f))), f
    for f in ("positions", "keypoints", "scale", "kf_positions",
              "kf_keypoints", "tb_positions"):
        _close(getattr(bj, f), getattr(bt, f), 1e-5)
    _close(bj.Tcw.t, bt.Tcw.t, 1e-5)
    _close(bj.kf_pose.q, bt.kf_pose.q, 1e-6)
    for f in ("exists", "bad"):
        assert np.array_equal(np_of(getattr(bj.graph, f)),
                              np_of(getattr(bt.graph, f)))
    for f in ("first_distance", "weight", "sigma"):
        _close(getattr(bj.graph, f), getattr(bt.graph, f), 1e-5)
    for f in bj.refs._fields:
        _close(getattr(bj.refs, f), getattr(bt.refs, f), 1e-3)
    assert int(np_of(bt.slot_used).sum()) >= init_config.min_triangulated


def test_evaluator_and_metrics():
    rng = np.random.default_rng(0)
    scene = jsyn.SceneConfig(height=60, width=80)
    _, depth, Tcw = jsyn.render_frame(3, scene)
    cam = jsyn.camera(scene)
    P = 96
    kp = np.stack([rng.uniform(-2, 82, P), rng.uniform(-2, 62, P)],
                  -1).astype(np.float32)
    est_depth = np.asarray(jsyn.cameras.unproject(cam, jnp.asarray(kp)))
    Xc = est_depth * (1.7 * np.asarray(jev.image_ops.bilinear_sample(
        depth, jnp.asarray(kp)))[:, None])
    Xc += rng.normal(0, 0.02, Xc.shape)
    Xc[:5] += 1.0                                          # outliers
    pos = np.array(jse3.apply(jse3.inverse(Tcw), jnp.asarray(Xc,
                                                               jnp.float32)))
    valid = rng.uniform(size=P) < 0.9
    rj, sj = jev._depth_rmse_impl(jnp.asarray(kp), jnp.asarray(pos),
                                  jnp.asarray(valid), Tcw, depth, cam.params,
                                  cam.kind)
    rt, st = tev._depth_rmse_impl(torch.as_tensor(kp), torch.as_tensor(pos),
                                  torch.as_tensor(valid), to_port(Tcw),
                                  to_port(depth), to_port(cam))
    assert 0.0 < float(rj) < 0.5 and abs(float(sj) - 1 / 1.7) < 0.05
    _close(rj, rt, 1e-5)
    _close(sj, st, 1e-5)
    e = rng.uniform(1, 4, P).astype(np.float32)
    g = (e * 1.3 + rng.normal(0, 0.05, P)).astype(np.float32)
    g[:4] += 3.0
    for iqr, frac in ((False, 0.95), (True, 0.9)):
        _close(jev._scale_aligned_rmse(jnp.asarray(e), jnp.asarray(g),
                                       jnp.asarray(valid), frac, iqr),
               tev._scale_aligned_rmse(torch.as_tensor(e), torch.as_tensor(g),
                                       torch.as_tensor(valid), frac, iqr),
               1e-5)

    # FrameEvaluator: lost frames are recorded as NaN and dropped.
    ej, et = jev.FrameEvaluator(flush_every=2), tev.FrameEvaluator(
        flush_every=2)
    base = jstate.empty_state(Config(max_points=P), (60, 80))
    for lost in (False, False, True, False):
        s = base._replace(keypoints=jnp.asarray(kp), positions=jnp.asarray(
            pos), Tcw=Tcw, slot_used=jnp.asarray(valid),
            status=jnp.zeros(P, jnp.int32), lost=jnp.asarray(lost))
        ej.evaluate(s, cam, depth)
        et.evaluate(to_port(s), to_port(cam), to_port(depth))
    assert len(et.rmse_history) == len(ej.rmse_history) == 3
    _close(np.array(ej.rmse_history), np.array(et.rmse_history), 1e-5)
    _close(np.array(ej.scale_history), np.array(et.scale_history), 1e-5)

    # Trajectory metrics on a noisy copy of a random trajectory.
    tw = rng.normal(0, 0.2, (20, 6)).astype(np.float32)
    gt = [jse3.exp(jnp.asarray(t)) for t in tw]
    est = [jse3.exp(jnp.asarray(t + rng.normal(0, 0.01, 6).astype(
        np.float32))) for t in tw]
    est_t = [to_port(T) for T in est]
    gt_t = [to_port(T) for T in gt]
    _close(jmet.camera_centers(est), tmet.camera_centers(est_t), 1e-6)
    for with_scale in (True, False):
        for a, b in ((jmet.ate_rmse(est, gt, with_scale),
                      tmet.ate_rmse(est_t, gt_t, with_scale)),
                     (jmet.rpe_trans_rmse(est, gt, 3, with_scale),
                      tmet.rpe_trans_rmse(est_t, gt_t, 3, with_scale))):
            assert abs(a - b) <= 1e-5 * max(1.0, abs(a)), (a, b)
    s1, R1, t1 = jmet.umeyama(tmet.camera_centers(est_t),
                              tmet.camera_centers(gt_t))
    s2, R2, t2 = tmet.umeyama(tmet.camera_centers(est_t),
                              tmet.camera_centers(gt_t))
    assert s1 == s2 and np.array_equal(R1, R2) and np.array_equal(t1, t2)


def test_synthetic_sequence():
    scene_j = jsyn.SceneConfig(height=48, width=64, deform_amp=0.02)
    scene_t = tsyn.SceneConfig(height=48, width=64, deform_amp=0.02)
    sj = jsyn.SyntheticSequence(scene_j, n_frames=5)
    st = tsyn.SyntheticSequence(scene_t, n_frames=5, device="cpu")
    assert len(sj) == len(st) == 5
    gj, dj, Tj = sj.get_frame(4)
    _close(gj, st.get_image(4), 0.05)   # see test_torch_slice.test_render_frame
    _close(dj, st.get_depth_image(4), 1e-4)
    _close(Tj.t, st.get_camera_pose(4).t, 1e-6)
