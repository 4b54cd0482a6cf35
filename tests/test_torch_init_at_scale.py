"""Port parity of the monocular initializer at the reference's feature
budget (max_features=4000, tracking.cc:46-61) on 640x480 rendered frames:
``InitializerConfig(max_features=4000)`` at its other defaults, the scene
of ``nrslam_tpu_torch.profile_scale.init_scene`` (the camera moves fast
enough that the init succeeds within a few frames), the JAX package's own
RANSAC draws of every attempt fed to the port (``jax_ransac_draws``).

Tolerances, those of tests/test_torch_initializer.py: ``reset`` identical
on every integer field; statuses equal on every frame and success on the
same frame; the success frame's pose within 1e-3 (after the refinement's
three pose-only solves), its point mask differing on at most 1% of the
4,000 slots.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from nrslam_tpu.datasets import synthetic as jsyn
from nrslam_tpu.ops import klt as jklt
from nrslam_tpu.slam import initializer as ji
from nrslam_tpu.slam.state import Config
from nrslam_tpu_torch import profile_scale
from nrslam_tpu_torch.slam import initializer as ti

from torch_parity import jax_ransac_draws, np_of, quat_err, to_port

torch.set_num_threads(1)

# Frames after the reset frame: the init succeeds at the second (both
# packages); each costs ~10 s of JAX on the CPU at this size.
N_FRAMES = 3


def test_init_at_4000_features_640x480():
    scene = jsyn.SceneConfig(**profile_scale.init_scene(480, 640))
    cam = jsyn.camera(scene)
    kcfg = Config(rad_per_pixel=1.0 / scene.fx).klt_config
    icfg = ji.InitializerConfig(max_features=4000,
                                rad_per_pixel=1.0 / scene.fx)
    tcam, tkcfg, ticfg = to_port(cam), to_port(kcfg), to_port(icfg)
    assert ticfg.max_features == 4000

    pyr = jklt.build_pyramid(jsyn.render_frame(0, scene)[0], kcfg)
    mask = jnp.ones((480, 640), bool)
    sj = ji.reset(pyr, mask, jnp.int32(0), kcfg, icfg)
    st = ti.reset(to_port(pyr), to_port(mask), 0, tkcfg, ticfg)
    for f in ("ref_keypoints", "valid", "track_id", "status",
              "next_track_id"):
        assert np.array_equal(np_of(getattr(sj, f)), np_of(getattr(st, f))), f
    assert np_of(st.valid).sum() >= 900  # of 4000 slots: 991 detected

    key = jax.random.PRNGKey(4)
    successes = []
    for i in range(1, N_FRAMES + 1):
        pyr = jklt.build_pyramid(jsyn.render_frame(i, scene)[0], kcfg)
        sub = jax.random.fold_in(key, i - 1)
        sj, rj = ji.init_step(sj, pyr, mask, sub, cam.params, cam.kind, kcfg,
                              icfg)
        perm, gumbel = jax_ransac_draws(sub, icfg.max_features,
                                        icfg.n_hypotheses)
        st, rt = ti.init_step(st, to_port(pyr), to_port(mask), perm, gumbel,
                              tcam, tkcfg, ticfg)
        assert np.array_equal(np_of(sj.status), np_of(st.status)), i
        assert bool(rj.success) == bool(rt.success), i
        successes.append(bool(rj.success))
        if successes[-1]:
            assert quat_err(rj.Tcw.q, rt.Tcw.q) < 1e-3
            assert np.abs(np_of(rj.Tcw.t) - np_of(rt.Tcw.t)).max() < 1e-3
            assert (np_of(rj.point_ok) == np_of(rt.point_ok)).mean() >= 0.99
            assert np_of(rj.point_ok).sum() >= icfg.min_triangulated
            break
        st = to_port(sj)  # carry on from the reference's state
    assert successes[-1], successes
