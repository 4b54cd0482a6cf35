"""Port parity: the pose-only LM (plain PyTorch driver, the CPU path and
kernel 1's oracle) against the JAX XLA driver and the interpret-mode Pallas
kernel, on the problems of tests/test_pose_only_pallas.py rebuilt from numpy
seeds (P=200 with 10% gross outliers and every 7th point masked, pinhole
and KB8; P=131).

Tolerance |dq|, |dt| < 1e-4: both run the same 3 x 10 LM schedule in float32
and differ only in summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrslam_tpu.geometry import cameras as jcam
from nrslam_tpu.geometry import se3 as jse3
from nrslam_tpu.solver import pose_only as jpo
from nrslam_tpu.solver.pose_only_pallas import camera_pose_optimization_pallas
from nrslam_tpu_torch.geometry import cameras as tcam
from nrslam_tpu_torch.geometry import se3 as tse3
from nrslam_tpu_torch.solver import pose_only as tpo

torch.set_num_threads(1)

TOL = 1e-4
F = (300.0, 300.0, 160.0, 120.0)
K = (0.05, -0.01, 0.004, -0.001)


def _problem(kind, seed, P=200):
    """Numpy rebuild of test_pose_only_pallas._problem."""
    rng = np.random.default_rng(seed)
    if kind == "pinhole":
        cj, ct = jcam.pinhole(*F), tcam.pinhole(*F, device="cpu")
    else:
        cj = jcam.kannala_brandt8(*F, *K)
        ct = tcam.kannala_brandt8(*F, *K, device="cpu")
    X = (rng.uniform(-1, 1, (P, 3)) + [0.0, 0.0, 3.0]).astype(np.float32)
    q = np.array([1.0, 0.02, -0.03, 0.01], np.float32)
    T_true = jse3.SE3(jnp.asarray(q / np.linalg.norm(q)),
                      jnp.asarray([0.05, -0.02, 0.1], jnp.float32))
    obs = np.array(jcam.project(cj, jse3.apply(T_true, jnp.asarray(X))))
    obs = obs + 0.3 * rng.normal(size=(P, 2)).astype(np.float32)
    outlier = rng.uniform(size=P) < 0.1
    obs[outlier] += 20.0
    valid = np.arange(P) % 7 != 3
    return cj, ct, X, obs.astype(np.float32), valid, T_true


def _run_both(cj, ct, X, obs, valid, pallas=False):
    args_j = (jse3.identity(), jnp.asarray(X), jnp.asarray(obs),
              jnp.asarray(valid))
    if pallas:
        Tj = camera_pose_optimization_pallas(cj, *args_j, interpret=True)
    else:
        Tj = jpo.camera_pose_optimization(cj, *args_j)
    Tt = tpo.camera_pose_optimization(
        ct, tse3.identity(), torch.as_tensor(X), torch.as_tensor(obs),
        torch.as_tensor(valid))
    return Tj, Tt


def _assert_close(Tj, Tt):
    qj, qt = np.asarray(Tj.q), Tt.q.numpy()
    assert min(np.linalg.norm(qj - qt), np.linalg.norm(qj + qt)) < TOL
    assert np.linalg.norm(np.asarray(Tj.t) - Tt.t.numpy()) < TOL


@pytest.mark.parametrize("kind", ["pinhole", "kb8"])
def test_plain_matches_xla_driver(kind):
    cj, ct, X, obs, valid, T_true = _problem(kind, 0)
    Tj, Tt = _run_both(cj, ct, X, obs, valid)
    _assert_close(Tj, Tt)
    assert np.linalg.norm(Tt.t.numpy() - np.asarray(T_true.t)) < 0.01


def test_plain_matches_xla_driver_odd_count():
    cj, ct, X, obs, valid, _ = _problem("pinhole", 3, P=131)
    _assert_close(*_run_both(cj, ct, X, obs, valid))


def test_plain_matches_pallas_interpret():
    cj, ct, X, obs, valid, _ = _problem("kb8", 5, P=131)
    _assert_close(*_run_both(cj, ct, X, obs, valid, pallas=True))


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    """Dispatch is by device: CPU tensors never reach the kernel wrapper."""
    from nrslam_tpu_torch.solver import pose_only_cuda

    def fail(*a, **k):
        raise AssertionError("kernel wrapper called for CPU tensors")

    monkeypatch.setattr(pose_only_cuda, "camera_pose_optimization_cuda", fail)
    cj, ct, X, obs, valid, _ = _problem("pinhole", 1, P=40)
    _run_both(cj, ct, X, obs, valid)


def test_kernel_wrapper_rejects_cpu_tensors():
    from nrslam_tpu_torch.solver import pose_only_cuda

    _, ct, X, obs, valid, _ = _problem("pinhole", 1, P=40)
    with pytest.raises(ValueError, match="CUDA"):
        pose_only_cuda.camera_pose_optimization_cuda(
            ct, tse3.identity(), torch.as_tensor(X), torch.as_tensor(obs),
            torch.as_tensor(valid))


@pytest.mark.parametrize("kind", ["pinhole", "kb8"])
def test_plain_matches_xla_driver_five_rounds(kind):
    """Any number of rounds, as the JAX drivers take (the kernel wrapper
    used to refuse more than 4)."""
    cj, ct, X, obs, valid, _ = _problem(kind, 2)
    rounds = (3, 5, 2, 4, 6)
    Tj = jpo.camera_pose_optimization(cj, jse3.identity(), jnp.asarray(X),
                                      jnp.asarray(obs), jnp.asarray(valid),
                                      rounds)
    Tt = tpo.camera_pose_optimization(
        ct, tse3.identity(), torch.as_tensor(X), torch.as_tensor(obs),
        torch.as_tensor(valid), rounds)
    _assert_close(Tj, Tt)


@pytest.mark.parametrize("kind", ["pinhole", "kb8"])
def test_plain_permutation_invariant(kind):
    """The solve does not depend on the order of the points: a permutation
    changes only the order of the float sums, within 1e-5 (the kernel's
    same-device gate; its readings on the card are in PERF.md)."""
    _, ct, X, obs, valid, _ = _problem(kind, 4)
    perm = np.random.default_rng(7).permutation(X.shape[0])

    def solve(idx):
        return tpo.camera_pose_optimization(
            ct, tse3.identity(), torch.as_tensor(X[idx]),
            torch.as_tensor(obs[idx]), torch.as_tensor(valid[idx]))

    Ta, Tb = solve(np.arange(X.shape[0])), solve(perm)
    qa, qb = Ta.q.numpy(), Tb.q.numpy()
    assert min(np.linalg.norm(qa - qb), np.linalg.norm(qa + qb)) < 1e-5
    assert np.linalg.norm(Ta.t.numpy() - Tb.t.numpy()) < 1e-5


@pytest.mark.parametrize("rounds", [(10,), (10, 10, 10), (3, 5, 2, 4, 6),
                                    (1,) * 9])
def test_kernel_wrapper_rejects_cpu_tensors_any_rounds(rounds):
    """The wrapper raises for CPU tensors whatever the schedule: no round
    count is refused before the device check."""
    from nrslam_tpu_torch.solver import pose_only_cuda

    _, ct, X, obs, valid, _ = _problem("kb8", 1, P=40)
    with pytest.raises(ValueError, match="CUDA"):
        pose_only_cuda.camera_pose_optimization_cuda(
            ct, tse3.identity(), torch.as_tensor(X), torch.as_tensor(obs),
            torch.as_tensor(valid), rounds)


# The kernel's limits on an H100 (what ``pose_only_cuda.limits`` reads from
# the library): the 227 KB shared-memory opt-in (232,448 bytes; the kernel
# has no static shared memory), at most 256 threads a block, 4 points a
# thread in registers.
OPTIN, MAX_THREADS, REG_PTS = 232448, 256, 4

# (P, threads, in registers, in shared memory, in global memory, dynamic
# shared bytes) under those limits: about 3 points a thread, at least 64
# threads; two reduction buffers of 32 floats a warp plus 21 bytes a shared
# point.
PLANS = [
    (1, 64, 1, 0, 0, 512),
    (131, 64, 131, 0, 0, 512),
    (768, 256, 768, 0, 0, 2048),
    (1024, 256, 1024, 0, 0, 2048),
    (9000, 256, 1024, 7976, 0, 2048 + 21 * 7976),
    (16384, 256, 1024, 10971, 4389, 2048 + 21 * 10971),
]


@pytest.mark.parametrize("P,threads,n_reg,n_sh,n_gl,smem", PLANS)
def test_residency_plan(P, threads, n_reg, n_sh, n_gl, smem):
    from nrslam_tpu_torch.solver import pose_only_cuda

    plan = pose_only_cuda.plan(P, OPTIN, MAX_THREADS, REG_PTS)
    assert plan == (threads, n_reg, n_sh, n_gl, smem)
    assert plan.n_reg + plan.n_sh + plan.n_gl == P
    assert plan.smem_bytes <= OPTIN
    # Shared memory is full before any point is left in global memory.
    assert plan.n_gl == 0 or OPTIN - plan.smem_bytes < 21
    assert plan.n_reg <= REG_PTS * plan.threads


def test_residency_plan_given_threads():
    """A thread count given by the caller (``prepare(..., threads=)``, to
    force a plan) is kept, and one outside the kernel's limit refused."""
    from nrslam_tpu_torch.solver import pose_only_cuda

    assert pose_only_cuda.plan(768, OPTIN, MAX_THREADS, REG_PTS,
                               threads=64) == (64, 256, 512, 0, 512 + 21 * 512)
    with pytest.raises(ValueError, match="threads"):
        pose_only_cuda.plan(768, OPTIN, MAX_THREADS, REG_PTS, threads=512)
    with pytest.raises(ValueError, match="threads"):
        pose_only_cuda.plan(768, OPTIN, MAX_THREADS, REG_PTS, threads=100)


@pytest.mark.parametrize("max_threads,reg_pts,smem_avail,expect", [
    (1024, 2, OPTIN, (864, 1728, 832, 0, 6912 + 21 * 832)),
    (128, 4, OPTIN, (128, 512, 2048, 0, 1024 + 21 * 2048)),
    (256, 4, 2048 + 21 * 100, (256, 1024, 100, 1436, 2048 + 21 * 100)),
])
def test_residency_plan_follows_limits(max_threads, reg_pts, smem_avail,
                                       expect):
    """The plan takes its limits from its caller, not from constants of
    its own: P=2560 under other thread, register and shared-memory limits."""
    from nrslam_tpu_torch.solver import pose_only_cuda

    plan = pose_only_cuda.plan(2560, smem_avail, max_threads, reg_pts)
    assert plan == expect
    assert plan.n_reg + plan.n_sh + plan.n_gl == 2560
