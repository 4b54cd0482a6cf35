"""Port parity of the system's whole entry path: the JAX ``System`` and the
port's ``System`` stepped side by side from frame 0 on the same rendered
frames (the 120x160 scene of ``torch_parity.entry_setting``), the JAX
package's RANSAC draws injected into the port's ``System._draws``:
monocular init, bootstrap, tracking and the keyframe whose local BA runs
over a 3-keyframe window (the JAX side runs its BA in the Pallas
configuration the port's BA follows on windows with invalid slots, through
the kernel's plain reference: ``jax_pallas_ba``). Once per frame, with
the init success flags read in batches of 4 (``init_check_every=4``), and
through ``track_image_with_stereo`` on stereo pairs of the same scene (the
three tests share the JAX System's traces in this file).

Tolerances: the init frame and every frame's status must be equal; tracked
frames use the slice tolerances of tests/test_torch_slice.py (statuses equal
on >= 98% of slots, pose <= 1e-3, median position / keypoint <= 1e-3) and
depth RMSE within 1e-3; the stereo RMSE within STEREO_RMSE_TOL.
"""

import jax
import numpy as np
import torch

from nrslam_tpu.datasets import synthetic as jsyn
from nrslam_tpu.slam import system as jsys
from nrslam_tpu_torch.slam import system as tsys

from torch_parity import (STEREO_BASELINE, entry_setting, jax_ransac_draws,
                          np_of, quat_err, stereo_pair, to_port)
from torch_parity import pallas_ba_reference  # noqa: F401 (a fixture)

torch.set_num_threads(1)

# The stereo RMSE, port against JAX: about 10x the largest difference
# measured over the stereo test's tracked frames (1.47e-5).
STEREO_RMSE_TOL = 2e-4


def _systems(monkeypatch, **kwargs):
    """A JAX System and a port System on the entry scene, the port drawing
    the JAX System's RANSAC samples. Returns (scene, sj, st)."""
    scene, cam, config, init_config = entry_setting()
    sj = jsys.System(cam, config, init_config, **kwargs)
    st = tsys.System(to_port(cam), to_port(config), to_port(init_config),
                     **kwargs)
    key = jax.random.PRNGKey(sj_seed := 4)
    assert st.seed == sj_seed
    monkeypatch.setattr(st, "_draws", lambda count: jax_ransac_draws(
        jax.random.fold_in(key, count), init_config.max_features,
        init_config.n_hypotheses))
    return scene, sj, st


def _step_both(scene, sj, st, n_frames):
    """Step both Systems over frames 0..n_frames-1 and hold every frame to
    the tolerances above. Returns the first TRACKING frame."""
    init_frame = None
    for i in range(n_frames):
        gray, depth, _ = jsyn.render_frame(i, scene)
        oj = sj.track_image_with_depth(gray, depth)
        ot = st.track_image_with_depth(to_port(gray), to_port(depth))
        assert sj.status == st.status, i
        if sj.status != jsys.TRACKING:
            continue
        init_frame = i if init_frame is None else init_frame
        js, ts = sj.state, st.state
        agree = np_of(js.status) == np_of(ts.status)
        assert agree.mean() >= 0.98, (i, agree.mean())
        assert quat_err(js.Tcw.q, ts.Tcw.q) <= 1e-3, i
        assert np.linalg.norm(np_of(js.Tcw.t) - np_of(ts.Tcw.t)) <= 1e-3, i
        m = agree & np_of(js.slot_used)
        for f in ("positions", "keypoints"):
            d = np.linalg.norm(np_of(getattr(js, f)) - np_of(getattr(ts, f)),
                               axis=-1)[m]
            assert np.median(d) <= 1e-3, (i, f, np.median(d))
        assert np.array_equal(np_of(js.kf_valid), np_of(ts.kf_valid)), i
        assert abs(float(oj["depth_rmse"]) - float(ot["depth_rmse"])) <= 1e-3
        if "n_tracked_3d" in oj:
            assert int(oj["n_tracked_3d"]) == int(ot["n_tracked_3d"]), i
            assert oj["keyframe"] == ot["keyframe"], i
    return init_frame


def test_system_matches_jax_from_frame_0(pallas_ba_reference, monkeypatch):
    """Both Systems from frame 0 through the init success, bootstrap_map
    and the keyframe whose BA window holds three keyframes."""
    scene, sj, st = _systems(monkeypatch)
    init_frame = _step_both(scene, sj, st, 13)
    assert init_frame is not None and init_frame <= 8, init_frame
    assert int(np_of(st.state.kf_valid).sum()) == 3  # a 3-keyframe BA ran
    assert st.map_points().shape[1] == 3
    t_j, t_t = np_of(sj.trajectory_pose().t), np_of(st.trajectory_pose().t)
    assert np.max(np.abs(t_j - t_t)) <= 1e-3


def test_system_batched_init_check_matches_jax(pallas_ba_reference,
                                               monkeypatch):
    """init_check_every=4: both Systems read the success flags of four init
    frames at once and bootstrap from the first success's own pyramid and
    result, so TRACKING starts at the end of a batch (frame 4 or 8) and
    tracking resumes from the success frame's map (on this scene: success
    at frame 6, as in the test above, handoff at frame 8). Stepped through
    two tracked frames after the handoff."""
    scene, sj, st = _systems(monkeypatch, init_check_every=4)
    init_frame = _step_both(scene, sj, st, 11)
    assert init_frame in (4, 8), init_frame
    assert not st._init_ring and st.init_state is None


def test_track_image_with_stereo_matches_jax(pallas_ba_reference,
                                             monkeypatch):
    """Both Systems from frame 0 on the scene's stereo pairs through the
    init, bootstrap and the first keyframe: equal statuses and keyframe
    flags every frame, a stereo RMSE on the same frames, each within
    STEREO_RMSE_TOL of JAX's (NCC ground truth on the TRACKED_WITH_3D slots,
    1.5 IQR pre-filter, 0.9 inliers)."""
    scene, sj, st = _systems(monkeypatch)
    bf = scene.fx * STEREO_BASELINE
    diffs = []
    for i in range(13):
        left, right = stereo_pair(scene, i)
        oj = sj.track_image_with_stereo(left, right, bf=bf)
        ot = st.track_image_with_stereo(to_port(left), to_port(right), bf=bf)
        assert sj.status == st.status, i
        assert oj.get("keyframe") == ot.get("keyframe"), i
        assert ("stereo_rmse" in oj) == ("stereo_rmse" in ot), i
        if "stereo_rmse" in oj:
            assert np.isfinite(ot["stereo_rmse"]), i
            diffs.append(abs(oj["stereo_rmse"] - ot["stereo_rmse"]))
    assert st.status == tsys.TRACKING and len(diffs) >= 6, diffs
    assert int(np_of(st.state.kf_valid).sum()) >= 2
    print("stereo RMSE differences", diffs)
    assert max(diffs) <= STEREO_RMSE_TOL, diffs
