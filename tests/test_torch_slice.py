"""Port parity of the whole steady-state frame: ``system.frame_step`` of the
JAX package and of the port, stepped side by side from one start state
(the bench problem at 120x160, P=128, 64 new keypoints per keyframe) over
4 frames with keyframes on frames 1 and 3 — the second keyframe runs the
local BA over a 3-keyframe window. The JAX side runs its BA in the Pallas
configuration, whose handling of the window's two invalid slots the port
follows (through the kernel's plain reference inside the Pallas wrapper's
sanitising, ``torch_parity.jax_pallas_ba``); its op-level driver leaves
such a window unchanged (see nrslam_tpu_torch/solver/bundle_adjustment.py).
Also the synthetic renderer and the state conversion.

Slice tolerances: statuses equal on >= 98% of slots (a point on a KLT or
chi2 gate may flip on a last-bit difference), pose |dt| and |dq| (up to
sign) <= 1e-3, positions and keypoints of status-agreeing slots within a
median of 1e-3. Tracking, pose, deformation, triangulation and BA run the
same float32 math; the differences are summation order and libm rounding.
"""

import jax
import numpy as np
import pytest
import torch

from nrslam_tpu.datasets import synthetic as jsyn
from nrslam_tpu.slam import state as jstate
from nrslam_tpu.slam import system as jsys
from nrslam_tpu_torch import convert
from nrslam_tpu_torch.datasets import synthetic as tsyn
from nrslam_tpu_torch.slam import state as tstate
from nrslam_tpu_torch.slam import system as tsys

from torch_parity import (jax_bench_problem, np_of,  # noqa: F401
                          pallas_ba_reference, quat_err, to_port)

torch.set_num_threads(1)


@pytest.mark.parametrize("n_used", [128, 80], ids=["bench", "free_slots"])
def test_frame_step_matches_jax(n_used, pallas_ba_reference):
    js, raw, mask, cam, cfg = jax_bench_problem(128, 120, 160, 64,
                                                n_used=n_used)
    ts = to_port(js)
    traw = [to_port(f) for f in raw]
    tmask, tcam, tcfg = to_port(mask), to_port(cam), to_port(cfg)
    for i, kf in enumerate([False, True, False, True]):
        js, jr = jsys.frame_step(js, raw[i], mask, cam, cfg, kf)
        ts, tr = tsys.frame_step(ts, traw[i], tmask, tcam, tcfg, kf)
        sj, st = np_of(js.status), np_of(ts.status)
        agree = sj == st
        assert agree.mean() >= 0.98, (i, agree.mean())
        assert quat_err(js.Tcw.q, ts.Tcw.q) <= 1e-3, i
        assert np.linalg.norm(np_of(js.Tcw.t) - np_of(ts.Tcw.t)) <= 1e-3, i
        m = agree & np_of(js.slot_used)
        for f in ("positions", "keypoints"):
            d = np.linalg.norm(np_of(getattr(js, f)) - np_of(getattr(ts, f)),
                               axis=-1)[m]
            assert np.median(d) <= 1e-3, (i, f, np.median(d))
        assert int(jr.n_tracked_3d) == int(tr.n_tracked_3d)
        assert bool(jr.lost) == bool(tr.lost)
        assert np.array_equal(np_of(js.slot_used), np_of(ts.slot_used))
        assert np.array_equal(np_of(js.kf_valid), np_of(ts.kf_valid))
    # The second keyframe ran BA over three keyframes (kf_valid count).
    assert np_of(ts.kf_valid).sum() == 3
    if n_used < 128:
        assert np_of(ts.slot_used).sum() > n_used  # keyframes placed features


@pytest.mark.parametrize("kind", ["pinhole", "kb8"])
def test_render_frame(kind):
    """Gray levels in [0, 255] within 0.05: the texture is a sum of sines of
    arguments up to ~100 rad, where one float32 ulp of the argument is
    ~1e-5 rad, times amplitudes of ~45 levels per radian of phase."""
    cfg_j = jsyn.SceneConfig(height=48, width=64, deform_amp=0.02,
                             camera_kind=kind)
    cfg_t = tsyn.SceneConfig(height=48, width=64, deform_amp=0.02,
                             camera_kind=kind)
    gj, dj, Tj = jsyn.render_frame(3, cfg_j)
    gt, dt, Tt = tsyn.render_frame(3, cfg_t, device="cpu")
    assert np.max(np.abs(np_of(gt) - np_of(gj))) < 0.05
    assert np.max(np.abs(np_of(dt) - np_of(dj))) < 1e-4
    assert np.max(np.abs(np_of(Tt.t) - np_of(Tj.t))) < 1e-6
    assert quat_err(Tj.q, Tt.q) < 1e-6


def test_convert_round_trip():
    js, raw, _, cam, cfg = jax_bench_problem(32, 64, 80, 16, n_used=24)
    ref = jax.device_get(js)
    ts = convert.from_numpy(ref, "cpu")
    back = convert.to_numpy(ts)
    leaves_ref = jax.tree_util.tree_leaves(ref)
    leaves_back = jax.tree_util.tree_leaves(
        back, is_leaf=lambda x: isinstance(x, np.ndarray))
    assert len(leaves_ref) == len(leaves_back)
    for a, b in zip(leaves_ref, leaves_back):
        a = np.asarray(a)
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.array_equal(a, b)
    assert type(ts).__module__ == "nrslam_tpu_torch.slam.state"
    assert convert.from_numpy(jax.device_get(cam), "cpu").kind == cam.kind
    assert convert.from_numpy(cfg, "cpu") == to_port(cfg)
    pyr = convert.from_numpy(jax.device_get([(raw[0], raw[0])]), "cpu")
    assert isinstance(pyr[0][1], torch.Tensor)


def test_state_ring_helpers():
    """Temporal/keyframe ring writes wrap at their capacity, the
    chronological order and slot allocation rank ties like JAX."""
    js, _, _, _, _ = jax_bench_problem(32, 64, 80, 16, n_used=20)
    ts = to_port(js)
    for _ in range(23):  # wraps the 20-slot temporal and 8-slot kf rings
        js = jstate.insert_keyframe(jstate.insert_temporal_snapshot(js))
        ts = tstate.insert_keyframe(tstate.insert_temporal_snapshot(ts))
    for f in ("tb_valid", "tb_frame_id", "tb_keypoints", "tb_tracked",
              "kf_valid", "kf_id", "kf_positions", "frame_id", "kf_next"):
        assert np.array_equal(np_of(getattr(js, f)), np_of(getattr(ts, f))), f
    assert np.array_equal(np_of(jstate.chronological_temporal_order(js)),
                          np_of(tstate.chronological_temporal_order(ts)))
    for a, b in zip(jstate.allocate_slots(js, 16),
                    tstate.allocate_slots(ts, 16)):
        assert np.array_equal(np_of(a), np_of(b))
