"""Port parity of the collapse path: the JAX ``System`` and the port's
``System`` stepped side by side on the entry scene of
``torch_parity.entry_setting`` (the JAX package's RANSAC draws injected
into the port, its BA in the Pallas configuration, as in
tests/test_torch_system_entry.py), through monocular init and tracking,
then a blackout of black frames until the device LOST latch fires, then
the scene again from its start.

With ``auto_reinitialize=True`` both Systems go LOST -> NOT_INITIALIZED,
re-initialise on the same frame and track again; with it off, LOST sticks
in both. Both flags share the frames before the blackout (one warm-up for
the module, copied per test). Tolerances: statuses, keyframe flags and
n_tracked_3d equal on every frame; tracked frames within the slice
tolerances of tests/test_torch_slice.py.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from nrslam_tpu.datasets import synthetic as jsyn
from nrslam_tpu.slam import system as jsys
from nrslam_tpu_torch.slam import system as tsys

from torch_parity import (entry_setting, jax_ransac_draws, np_of, quat_err,
                          to_port)
from torch_parity import pallas_ba_reference  # noqa: F401 (a fixture)

torch.set_num_threads(1)

# The first black frame: the init succeeds at frame 6 and the first
# keyframe after it falls on frame 12, so every frame stepped here is a
# non-keyframe (the keyframe specialisation is compiled in other files).
BLACKOUT = 10
N_BLACK = 4


def _frame(scene, i):
    """Frame i of the run: the scene, N_BLACK black frames from BLACKOUT,
    then the scene again from its first frame (where the camera moves fast
    enough for the monocular init)."""
    after = i - BLACKOUT - N_BLACK
    gray, _, _ = jsyn.render_frame(i if after < 0 else after, scene)
    if BLACKOUT <= i < BLACKOUT + N_BLACK:
        gray = gray * 0.0
    return gray


def _step(scene, sj, st, i):
    """One frame on both Systems; the frame's (status, keyframe) pair,
    after holding the two to each other."""
    gray = _frame(scene, i)
    oj = sj.track_image(gray)
    ot = st.track_image(to_port(gray))
    assert sj.status == st.status, (i, sj.status, st.status)
    assert oj.get("keyframe") == ot.get("keyframe"), i
    if "n_tracked_3d" in oj:
        assert int(oj["n_tracked_3d"]) == int(ot["n_tracked_3d"]), i
    if sj.status == jsys.TRACKING:
        js, ts = sj.state, st.state
        agree = np_of(js.status) == np_of(ts.status)
        assert agree.mean() >= 0.98, (i, agree.mean())
        assert quat_err(js.Tcw.q, ts.Tcw.q) <= 1e-3, i
        assert np.linalg.norm(np_of(js.Tcw.t) - np_of(ts.Tcw.t)) <= 1e-3, i
        m = agree & np_of(js.slot_used)
        d = np.linalg.norm(np_of(js.positions) - np_of(ts.positions),
                           axis=-1)[m]
        assert np.median(d) <= 1e-3, (i, np.median(d))
    return sj.status, oj.get("keyframe")


@pytest.fixture(scope="module")
def tracked(pallas_ba_reference):
    """Both Systems (auto_reinitialize off, lost_check_every=1) stepped
    from frame 0 to the frame before the blackout: (scene, sj, st,
    statuses)."""
    scene, cam, config, init_config = entry_setting()
    sj = jsys.System(cam, config, init_config)
    st = tsys.System(to_port(cam), to_port(config), to_port(init_config))
    key = jax.random.PRNGKey(st.seed)
    st._draws = lambda count: jax_ransac_draws(
        jax.random.fold_in(key, count), init_config.max_features,
        init_config.n_hypotheses)
    statuses = [_step(scene, sj, st, i)[0] for i in range(BLACKOUT)]
    assert statuses[-1] == jsys.TRACKING, statuses
    return scene, sj, st, statuses


@pytest.mark.parametrize("auto_reinitialize", [True, False])
def test_collapse_matches_jax(tracked, auto_reinitialize):
    scene, sj0, st0, statuses = tracked
    sj, st = copy.copy(sj0), copy.copy(st0)
    sj.auto_reinitialize = st.auto_reinitialize = auto_reinitialize
    statuses = list(statuses)
    i = BLACKOUT
    while i < BLACKOUT + N_BLACK and statuses[-1] == jsys.TRACKING:
        statuses.append(_step(scene, sj, st, i)[0])
        i += 1
    lost_frame = i - 1
    assert statuses[-1] != jsys.TRACKING, "LOST did not latch in the blackout"
    if not auto_reinitialize:
        assert statuses[-1] == jsys.LOST
        assert _step(scene, sj, st, i)[0] == jsys.LOST, i
        return
    assert statuses[-1] == jsys.NOT_INITIALIZED
    assert st.state is None and sj.state is None
    reinit = None
    for i in range(i, lost_frame + 16):
        status, _ = _step(scene, sj, st, i)
        if status == jsys.TRACKING and reinit is None:
            reinit = i
        if reinit is not None and i >= reinit + 2:
            break
    assert reinit is not None, "no re-initialisation"
    assert st.status == tsys.TRACKING
    assert int(np_of(st.state.slot_used).sum()) >= 10
    assert np.isfinite(np_of(st.state.positions)).all()
    print(f"blackout from frame {BLACKOUT}: LOST latched at {lost_frame}, "
          f"re-initialised at {reinit}")
