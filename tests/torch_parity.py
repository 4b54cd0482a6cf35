"""Shared helpers for the JAX-vs-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; JAX
results come back through ``jax.device_get`` and port results through
``convert.to_numpy``.
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrslam_tpu_torch import convert
from nrslam_tpu_torch.bench_problem import initial_keypoints


def to_port(tree):
    """JAX pytree -> port pytree on the CPU."""
    return convert.from_numpy(jax.device_get(tree), "cpu")


def np_of(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(jax.device_get(x))


def quat_err(qa, qb):
    """Quaternion distance up to sign."""
    qa, qb = np_of(qa), np_of(qb)
    return min(np.linalg.norm(qa - qb), np.linalg.norm(qa + qb))


def jax_ransac_draws(key, n_features: int, n_hypotheses: int):
    """The draws the JAX initializer makes from ``key``: the kmeans
    permutation [N] and the per-hypothesis Gumbel noise [H, N]
    (initializer.py:115-121, 173-182), as port tensors."""
    perm = jax.random.permutation(key, n_features)
    keys = jax.random.split(jax.random.fold_in(key, 1), n_hypotheses)
    gumbel = jax.vmap(lambda k: jax.random.gumbel(k, (n_features,)))(keys)
    return to_port(perm), to_port(gumbel)


@contextlib.contextmanager
def jax_pallas_ba():
    """Run the JAX package's keyframe BA in its ``set_backend("pallas")``
    configuration, whose semantics the port's BA follows on windows with
    invalid keyframe slots: the kernel's plain reference, the op-level
    driver, inside the Pallas wrapper's own sanitising of unobserved copies
    (bundle_adjustment_pallas.py:580-584, 662). It compiles several times
    faster than the kernel in interpret mode, which
    tests/test_torch_bundle_adjustment_kernel.py holds the port against
    directly. Every jit trace is dropped on entry and on exit, so no
    program traced with the other BA is reused."""
    from nrslam_tpu.solver import bundle_adjustment as jba

    original = jba.local_deformable_ba

    def pallas_ba(cam, poses0, L0, problem, n_iters=5, cg_iters=32):
        obs_ok = (problem.obs_valid & problem.kf_valid[:, None])[..., None]
        benign = jnp.array([0.1, 0.1, 1.0], L0.dtype)
        poses, L = original(
            cam, poses0, jnp.where(obs_ok, L0, benign),
            problem._replace(obs=jnp.where(obs_ok, problem.obs, 0.0)),
            n_iters, cg_iters)
        return poses, jnp.where(obs_ok, L, L0)

    jax.clear_caches()
    jba.local_deformable_ba = pallas_ba
    try:
        yield
    finally:
        jba.local_deformable_ba = original
        jax.clear_caches()


@pytest.fixture(scope="module")
def pallas_ba_reference():
    """``jax_pallas_ba`` for a whole test module (one trace per shape)."""
    with jax_pallas_ba():
        yield


def entry_setting():
    """The System entry tests' scene, the smallest at which the JAX System
    initialises within a few frames (120x160, fx 125), and its
    configurations: (scene, JAX camera, Config, InitializerConfig)."""
    from nrslam_tpu.datasets import synthetic
    from nrslam_tpu.slam import initializer
    from nrslam_tpu.slam.state import Config

    fx = 125.0
    scene = synthetic.SceneConfig(height=120, width=160, fx=fx, fy=fx)
    config = Config(max_points=128, max_new_keypoints=48,
                    rad_per_pixel=1.0 / fx)
    init_config = initializer.InitializerConfig(
        max_features=192, min_matches=30, min_triangulated=25,
        rad_per_pixel=1.0 / fx, n_hypotheses=48)
    return scene, synthetic.camera(scene), config, init_config


STEREO_BASELINE = 0.12


def stereo_pair(scene, frame: int):
    """(left, right) gray renders of ``frame`` from a rig with an
    x-baseline of ``STEREO_BASELINE``, as datasets/hamlyn_export.py makes
    them (JAX arrays)."""
    from nrslam_tpu.datasets import synthetic
    from nrslam_tpu.geometry import se3

    T_l = synthetic.camera_pose(frame, scene)
    T_rl = se3.SE3(jnp.array([1.0, 0.0, 0.0, 0.0]),
                   jnp.array([-STEREO_BASELINE, 0.0, 0.0]))
    left = synthetic.render_frame_at(T_l, frame, scene)[0]
    right = synthetic.render_frame_at(se3.compose(T_rl, T_l), frame, scene)[0]
    return left, right


def jax_bench_problem(max_points, height, width, max_new_kp, seed=0,
                      n_used=None):
    """bench.build_bench_problem at a chosen size, with the initial
    keypoints drawn by numpy (``bench_problem.initial_keypoints``) instead of
    JAX's PRNG. ``n_used`` < max_points leaves the remaining slots free, so
    keyframes place new features and tracks without 3D appear.
    Returns (state, raw_frames, mask, cam, config)."""
    from nrslam_tpu.datasets import synthetic
    from nrslam_tpu.geometry import cameras as cam_mod
    from nrslam_tpu.ops import klt
    from nrslam_tpu.slam import graph as graph_mod
    from nrslam_tpu.slam import state as state_mod
    from nrslam_tpu.slam.state import Config

    scene = synthetic.SceneConfig(height=height, width=width,
                                  deform_amp=0.02)
    cam = synthetic.camera(scene)
    config = Config(max_points=max_points, max_new_keypoints=max_new_kp,
                    rad_per_pixel=1.0 / scene.fx)
    gray0, _, _ = synthetic.render_frame(0, scene)
    pyr0 = klt.build_pyramid(gray0, config.klt_config)
    state = state_mod.empty_state(config, gray0.shape)
    uv = jnp.asarray(initial_keypoints(max_points, height, width, seed))
    positions = cam_mod.unproject(cam, uv) * 3.0
    n_used = max_points if n_used is None else n_used
    valid = jnp.arange(max_points) < n_used
    refs = klt.set_reference(pyr0, uv, valid, config.klt_config)
    state = state._replace(
        slot_used=valid,
        track_id=jnp.where(valid, jnp.arange(max_points, dtype=jnp.int32),
                           -1),
        has_3d=valid,
        positions=positions,  # free slots keep stale (finite) data
        keypoints=uv,
        status=jnp.where(valid, 0, state_mod.NOT_IN_FRAME).astype(jnp.int32),
        refs=refs,
        graph=graph_mod.initialize(state.graph, positions, valid, 3.0),
        next_track_id=jnp.int32(n_used),
    )
    state = state_mod.insert_temporal_snapshot(state)
    state = state_mod.insert_keyframe(state)
    raw = [synthetic.render_frame(i, scene)[0] for i in range(1, 7)]
    return state, raw, jnp.ones(gray0.shape, bool), cam, config


# The partitioned solves' byte models: what one call's collectives carry on
# n ranks, counted from their schedules (parallel/solve_shard.py,
# parallel/ba_points.py). Both the plain and the kernel route make them.

def solve_floats(P, n, pose_rounds=(10, 10, 10), rounds=(10, 10),
                 cg_iters=10):
    """(collectives, float32 elements) of one frame's sharded pose-only
    and joint solves, whose sums travel as rows of c = ceil(P / 64) chunks:
    28 a chunk per pose-only evaluation; the joint's rest / mask gather
    [P, 4], each round's first system with the ranks' diagonals (28 c + n),
    per LM step the PCG start and each CG trip's z or trial flows with two
    sums a chunk (3P + 2c) and the trips' 7 c and the trial system's 28 c,
    and the final chi2 gather [P]."""
    c = -(-P // 64)
    evals = sum(pose_rounds) + len(pose_rounds)
    steps = sum(rounds)
    count = evals + 1 + len(rounds) + steps * (2 + 2 * cg_iters) + 1
    floats = (28 * c * evals + 4 * P + len(rounds) * (28 * c + n)
              + steps * ((cg_iters + 1) * (3 * P + 2 * c) + 7 * c * cg_iters
                         + 28 * c)
              + P)
    return count, floats


def ba_floats(W, P, n, n_iters=5, cg_iters=16):
    """(collectives, float32 elements) of one partitioned window BA call,
    whose sums travel as rows of c = ceil(P / 64) chunks: the first
    linearisation's S = 28 W + 1 a chunk with the ranks' diagonals (S c +
    n); per LM step the PCG start and each CG trip's z with two sums a
    chunk (3 W P + 2 c; after the last trip the trial copies with one, 3 W
    P + c), the trips' (6 W + 1) c and the trial system's S c."""
    c = -(-P // 64)
    S = 28 * W + 1
    count = 1 + n_iters * (2 + 2 * cg_iters)
    floats = (S * c + n + n_iters * (
        cg_iters * (3 * W * P + 2 * c) + (3 * W * P + c)
        + cg_iters * (6 * W + 1) * c + S * c))
    return count, floats


@contextlib.contextmanager
def cuda_calls():
    """The block traced with ``sys.setprofile``: yields the list that
    collects every call into ``torch.cuda`` it makes (Python functions
    under torch/cuda/ and C functions of ``torch.cuda`` or
    ``torch._C._cuda*``)."""
    import sys

    calls = []

    def watch(frame, event, arg):
        if event == "call":
            where = frame.f_code.co_filename.replace("\\", "/")
        elif event == "c_call":
            where = getattr(arg, "__module__", None) or ""
        else:
            return
        if "torch/cuda/" in where or where.startswith(("torch.cuda",
                                                        "torch._C._cuda")):
            calls.append(where)

    sys.setprofile(watch)
    try:
        yield calls
    finally:
        sys.setprofile(None)
