"""Port parity of the keyframe BA against the JAX package's Pallas BA kernel.

On the card the port's ``local_deformable_ba`` runs the CUDA kernel
(csrc/bundle_adjustment.cu), the counterpart of ``_ba_kernel``; on CPU
tensors it runs the plain driver, which these tests hold against
``local_deformable_ba_pallas(..., interpret=True)`` on the fixtures of
tests/test_bundle_adjustment_pallas.py (noisy seeds, masked keyframes,
partial observations) and on a window built by the mapping pipeline whose
two oldest slots are still invalid. The card's kernel is held against the
plain driver by chip_smoke.py.

Tolerance 1e-3 on pose and on every observed landmark copy (the Pallas
test's own); unobserved copies are returned exactly.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrslam_tpu.geometry import cameras as jcam
from nrslam_tpu.geometry import se3 as jse3
from nrslam_tpu.slam import mapping as jmap
from nrslam_tpu.slam import state as jstate
from nrslam_tpu.solver.bundle_adjustment_pallas import (
    local_deformable_ba_pallas)
from nrslam_tpu_torch.slam import mapping as tmap
from nrslam_tpu_torch.solver import bundle_adjustment as tba
from nrslam_tpu_torch.solver import bundle_adjustment_cuda as tbac

from test_bundle_adjustment import CAM, make_window
from test_bundle_adjustment_pallas import _noisy_seeds
from torch_parity import jax_bench_problem, jax_pallas_ba, np_of, to_port

torch.set_num_threads(1)

TOL = 1e-3

_pallas = jax.jit(local_deformable_ba_pallas,
                  static_argnames=("n_iters", "cg_iters", "interpret",
                                   "stream"))


def _port_ba(poses0, L0, problem):
    return tba.local_deformable_ba(to_port(CAM), to_port(poses0), to_port(L0),
                                   to_port(problem), n_iters=5, cg_iters=16)


def _assert_parity(p_j, L_j, p_t, L_t, live):
    qj, qt = np_of(p_j.q)[live], np_of(p_t.q)[live]
    dq = np.max(np.minimum(np.linalg.norm(qj - qt, axis=-1),
                           np.linalg.norm(qj + qt, axis=-1)))
    dt = np.max(np.linalg.norm(np_of(p_j.t)[live] - np_of(p_t.t)[live],
                               axis=-1))
    dL = np.max(np.linalg.norm(np_of(L_j)[live] - np_of(L_t)[live], axis=-1))
    assert dq < TOL and dt < TOL and dL < TOL, (dq, dt, dL)


@pytest.mark.parametrize("stream", [False, True],
                         ids=["resident", "streaming"])
def test_ba_matches_pallas_kernel(stream):
    poses_true, L_true, _, problem = make_window(K=4, P=96)
    poses0, L0 = _noisy_seeds(poses_true, L_true)
    p_j, L_j = _pallas(CAM, poses0, L0, problem, n_iters=5, cg_iters=16,
                       interpret=True, stream=stream)
    p_t, L_t = _port_ba(poses0, L0, problem)
    _assert_parity(p_j, L_j, p_t, L_t, slice(None))
    assert np.max(np.abs(np_of(L_t) - np_of(L0))) > 10 * TOL  # it moved


def test_ba_masked_keyframes():
    """Two invalid keyframe slots (NaN observations): the rest of the window
    agrees and the unobserved copies pass through exactly."""
    poses_true, L_true, _, problem = make_window(K=5, P=96)
    kf_valid = jnp.array([True, True, True, False, False])
    problem = problem._replace(
        kf_valid=kf_valid,
        obs=jnp.where(kf_valid[:, None, None], problem.obs, jnp.nan))
    L0 = jnp.where(kf_valid[:, None, None], L_true, 1.0)
    poses0, _ = _noisy_seeds(poses_true, L_true)
    p_j, L_j = _pallas(CAM, poses0, L0, problem, n_iters=5, cg_iters=16,
                       interpret=True, stream=False)
    p_t, L_t = _port_ba(poses0, L0, problem)
    assert np.isfinite(np_of(L_t)).all()
    _assert_parity(p_j, L_j, p_t, L_t, slice(0, 3))
    np.testing.assert_array_equal(np_of(L_t)[3:], np_of(L0)[3:])


def test_ba_partial_observations():
    poses_true, L_true, _, problem = make_window(K=4, P=96, seed=3)
    obs_valid = jax.random.uniform(jax.random.PRNGKey(7),
                                   problem.obs_valid.shape) > 0.25
    problem = problem._replace(obs_valid=obs_valid)
    poses0, L0 = _noisy_seeds(poses_true, L_true)
    p_j, L_j = _pallas(CAM, poses0, L0, problem, n_iters=5, cg_iters=16,
                       interpret=True, stream=True)
    p_t, L_t = _port_ba(poses0, L0, problem)
    _assert_parity(p_j, L_j, p_t, L_t, slice(None))
    unobs = ~np_of(obs_valid)
    np.testing.assert_array_equal(np_of(L_t)[unobs], np_of(L0)[unobs])


def _three_keyframe_state():
    """The bench start state (one keyframe at the identity) plus two
    keyframes of a sideways move over a slightly deformed map: the keyframe
    window then holds three valid and two invalid (zero) slots, as after
    bootstrap_map."""
    js, _, _, cam, cfg = jax_bench_problem(96, 120, 160, 32)
    rng = np.random.default_rng(1)
    pos0 = np_of(js.positions)
    for k in (1, 2):
        Tk = jse3.exp(jnp.asarray([0.0, 0.004 * k, 0.0, -0.03 * k, 0.0, 0.0],
                                  jnp.float32))
        pos = pos0 + rng.normal(0, 0.01, pos0.shape).astype(np.float32)
        kp = np.asarray(jcam.project(cam, jse3.apply(
            Tk, jnp.asarray(pos))))
        kp = kp + rng.normal(0, 0.3, kp.shape).astype(np.float32)
        js = jstate.insert_keyframe(js._replace(
            Tcw=Tk, keypoints=jnp.asarray(kp, jnp.float32),
            positions=jnp.asarray(pos)))
    return js, cam, cfg


def test_ba_pipeline_window_with_invalid_slots():
    """keyframe_mapping on a 3-of-5 window: the port (plain driver) solves
    it as the JAX package's Pallas configuration does (here through the
    kernel's plain reference inside the Pallas wrapper, which the tests
    above hold to the kernel); the JAX op-level driver leaves it unchanged
    (every LM step meets 0 * NaN from the zero copies of the invalid slots
    and is rejected)."""
    js, cam, cfg = _three_keyframe_state()
    assert int(np_of(js.kf_valid).sum()) == 3
    out_t = tmap.keyframe_mapping(to_port(js), to_port(cam), to_port(cfg))
    with jax_pallas_ba():
        out_j = jax.jit(partial(jmap.keyframe_mapping, config=cfg))(js, cam)
    live = np_of(js.kf_valid)
    _assert_parity(out_j.kf_pose, out_j.kf_positions, out_t.kf_pose,
                   out_t.kf_positions, live)
    moved = np.abs(np_of(out_t.kf_positions) - np_of(js.kf_positions))
    assert moved[live].max() > 10 * TOL
    np.testing.assert_array_equal(np_of(out_t.kf_positions)[~live],
                                  np_of(js.kf_positions)[~live])
    assert np.linalg.norm(np_of(out_t.Tcw.t) - np_of(out_j.Tcw.t)) < TOL

    out_x = jax.jit(partial(jmap.keyframe_mapping, config=cfg))(js, cam)
    np.testing.assert_array_equal(np_of(out_x.kf_positions),
                                  np_of(js.kf_positions))


def test_cuda_wrapper_rejects_cpu_tensors():
    poses_true, L_true, _, problem = make_window(K=4, P=96)
    with pytest.raises(ValueError, match="CUDA"):
        tbac.local_deformable_ba_cuda(to_port(CAM), to_port(poses_true),
                                      to_port(L_true), to_port(problem))
