"""Port parity: the joint pose+deformation LM (plain PyTorch driver, the CPU
path and kernel 2's oracle), its edge tables and the lost-point drag,
against the JAX package on the problems of
tests/test_pose_deformation_pallas.py rebuilt from numpy seeds.

Tolerances are those of that file's ``_assert_parity``: pose 2e-3, median
flow difference 5e-3 (scaled by the flow magnitude), inlier flips < 3% —
the two-round LM with inexact PCG steps amplifies float32 summation-order
differences. Edge tables are integer/selection outputs and must be equal;
the drag is a closed-form IRLS mean, held to 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrslam_tpu.geometry import cameras as jcam
from nrslam_tpu.geometry import se3 as jse3
from nrslam_tpu.solver import pose_deformation as jpd
from nrslam_tpu.solver import pose_only as jpo
from nrslam_tpu.solver.pose_deformation_pallas import (
    pose_deformation_optimization_pallas)
from nrslam_tpu_torch.geometry import cameras as tcam
from nrslam_tpu_torch.geometry import se3 as tse3
from nrslam_tpu_torch.solver import pose_deformation as tpd

torch.set_num_threads(1)

PIN = (472.65, 472.65, 479.5, 359.5)
KB8 = ((400.0, 400.0, 479.5, 359.5), (0.05, -0.01, 0.004, -0.001))


def _cams(kind):
    if kind == "pinhole":
        return jcam.pinhole(*PIN), tcam.pinhole(*PIN, device="cpu")
    return (jcam.kannala_brandt8(*KB8[0], *KB8[1]),
            tcam.kannala_brandt8(*KB8[0], *KB8[1], device="cpu"))


def knn_table(X, k):
    d = np.linalg.norm(X[:, None] - X[None], axis=-1)
    np.fill_diagonal(d, np.inf)
    idx = np.argsort(d, axis=-1, kind="stable")[:, :k].astype(np.int32)
    dist = np.take_along_axis(d, idx, axis=-1).astype(np.float32)
    sigma = np.median(dist) * 3
    w = np.exp(-(dist ** 2) / (2 * sigma ** 2)).astype(np.float32)
    return idx, w, dist, np.ones_like(w, bool)


def _problem(kind="pinhole", n=150, seed=0, deform_amp=0.05, n_outliers=0,
             masked=0, k=10, knock_out=True):
    """Numpy rebuild of test_pose_deformation_pallas._problem."""
    rng = np.random.default_rng(seed)
    cj, ct = _cams(kind)
    X = np.stack([rng.uniform(-1.2, 1.2, n), rng.uniform(-0.9, 0.9, n),
                  rng.uniform(2.5, 4.0, n)], -1).astype(np.float32)
    flow = deform_amp * np.stack([np.sin(2.0 * X[:, 0]),
                                  np.cos(1.5 * X[:, 1]),
                                  np.sin(X[:, 0] + X[:, 1])], -1)
    T_true = jse3.exp(jnp.array([0.02, -0.01, 0.015, 0.06, -0.04, 0.05]))
    obs = np.array(jcam.project(cj, jse3.apply(
        T_true, jnp.asarray((X + flow).astype(np.float32)))))
    obs[:n_outliers] += 40.0 * rng.normal(size=(n_outliers, 2))
    obs = obs.astype(np.float32)
    valid = np.ones(n, bool)
    if masked:
        valid[-masked:] = False
    T_seed = jpo.camera_pose_optimization(cj, jse3.identity(),
                                          jnp.asarray(X), jnp.asarray(obs),
                                          jnp.asarray(valid))
    nbr = knn_table(X, k)
    if knock_out:
        nbr[3][10:20, ::2] = False
    return cj, ct, X, obs, valid, nbr, T_seed


def _pairs_both(nbr):
    pj = jpd.pairs_from_neighbors(*(jnp.asarray(a) for a in nbr))
    pt = tpd.pairs_from_neighbors(*(torch.as_tensor(a) for a in nbr))
    return pj, pt


def _run_both(prob):
    cj, ct, X, obs, valid, nbr, T_seed = prob
    pj, pt = _pairs_both(nbr)
    rj = jpd.pose_deformation_optimization(
        cj, T_seed, jnp.asarray(X), jnp.asarray(obs), jnp.asarray(valid), pj,
        scale=1.0)
    Ts = tse3.SE3(torch.as_tensor(np.array(T_seed.q)),
                  torch.as_tensor(np.array(T_seed.t)))
    rt = tpd.pose_deformation_optimization(
        ct, Ts, torch.as_tensor(X), torch.as_tensor(obs),
        torch.as_tensor(valid), pt, scale=1.0)
    return rj, rt


def _assert_parity(qj, tj, flows_j, inl_j, qt, tt, flows_t, inl_t, valid,
                   flow_tol=5e-3, pose_tol=2e-3):
    qj, qt = np.asarray(qj), np.asarray(qt)
    assert min(np.linalg.norm(qj - qt), np.linalg.norm(qj + qt)) < pose_tol
    assert np.linalg.norm(np.asarray(tj) - np.asarray(tt)) < pose_tol
    fj, ft = np.asarray(flows_j), np.asarray(flows_t)
    dflow = np.linalg.norm(fj - ft, axis=-1)[valid]
    fmag = max(float(np.median(np.linalg.norm(fj, axis=-1))), 0.01)
    assert np.median(dflow) < flow_tol * max(fmag / 0.01, 1.0), \
        (np.median(dflow), fmag)
    assert (np.asarray(inl_j) != np.asarray(inl_t)).mean() < 0.03


CASES = {
    "pinhole": dict(kind="pinhole", n_outliers=8),
    "kb8": dict(kind="kb8", n_outliers=8),
    "masked": dict(deform_amp=0.03, n_outliers=5, masked=23),
    "odd_p131": dict(n=131, deform_amp=0.04),
    "tiny_p40_k6": dict(n=40, seed=5, deform_amp=0.02, k=6,
                        knock_out=False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_xla_driver(case):
    prob = _problem(**CASES[case])
    valid = prob[4]
    rj, rt = _run_both(prob)
    _assert_parity(rj.Tcw.q, rj.Tcw.t, rj.flows, rj.reproj_inlier,
                   rt.Tcw.q, rt.Tcw.t, rt.flows, rt.reproj_inlier, valid)
    assert (np.asarray(rj.deform_ok) != rt.deform_ok.numpy()).mean() < 0.03
    assert abs(float(rj.median_deformation)
               - float(rt.median_deformation)) < 5e-3
    if not valid.all():
        assert float(torch.max(torch.abs(rt.flows[~torch.as_tensor(valid)]))) \
            == 0.0


def test_plain_matches_pallas_interpret():
    cj, ct, X, obs, valid, nbr, T_seed = _problem(**CASES["tiny_p40_k6"])
    pj, pt = _pairs_both(nbr)
    Tj, fj, cj2 = pose_deformation_optimization_pallas(
        cj, T_seed, jnp.asarray(X), jnp.asarray(obs), jnp.asarray(valid),
        jpd.compact_pairs(pj, 40, jnp.asarray(valid)), 1.0, interpret=True)
    Ts = tse3.SE3(torch.as_tensor(np.array(T_seed.q)),
                  torch.as_tensor(np.array(T_seed.t)))
    Tt, ft, ct2 = tpd.pose_deformation_plain(
        ct, Ts, torch.as_tensor(X), torch.as_tensor(obs),
        torch.as_tensor(valid),
        tpd.compact_pairs(pt, 40, torch.as_tensor(valid)), 1.0)
    _assert_parity(Tj.q, Tj.t, fj, np.asarray(cj2) <= 5.99, Tt.q.numpy(),
                   Tt.t.numpy(), ft.numpy(), ct2.numpy() <= 5.99, valid)


def test_pairs_and_compaction_identical():
    _, _, X, _, valid, nbr, _ = _problem(n=150, masked=11)
    pj, pt = _pairs_both(nbr)
    for f in pj._fields:
        assert np.array_equal(np.asarray(getattr(pj, f)),
                              getattr(pt, f).numpy()), f
    cj = jpd.compact_pairs(pj, 150, jnp.asarray(valid))
    ct = tpd.compact_pairs(pt, 150, torch.as_tensor(valid))
    assert ct.i.shape[0] == cj.i.shape[0] == 1024 < pj.i.shape[0]
    for f in cj._fields:
        assert np.array_equal(np.asarray(getattr(cj, f)),
                              getattr(ct, f).numpy()), f
    assert tpd.edge_budget(768, 768 * 11) == jpd.edge_budget(768, 768 * 11) \
        == 5376


def test_lost_point_drag():
    rng = np.random.default_rng(7)
    flows = rng.normal(0, 0.05, (60, 3)).astype(np.float32)
    flows[:5] += 3.0  # gross neighbours the Huber weights must discount
    idx = rng.integers(0, 60, (25, 11)).astype(np.int32)
    w = rng.uniform(0.3, 1.0, (25, 11)).astype(np.float32)
    v = rng.uniform(size=(25, 11)) < 0.8
    v[0] = False  # a lost point with no usable neighbour keeps zero drag
    dj = jpd.lost_point_drag(jnp.asarray(flows), jnp.asarray(idx),
                             jnp.asarray(w), jnp.asarray(v), 1.0)
    dt = tpd.lost_point_drag(torch.as_tensor(flows),
                             torch.as_tensor(idx).long(), torch.as_tensor(w),
                             torch.as_tensor(v), 1.0)
    assert np.max(np.abs(np.asarray(dj) - dt.numpy())) < 1e-5
    assert float(torch.max(torch.abs(dt[0]))) == 0.0
