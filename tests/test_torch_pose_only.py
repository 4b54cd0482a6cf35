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
