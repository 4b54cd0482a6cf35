"""Port parity: deformation-graph ops, deformable triangulation, the op-level
local deformable BA (fixtures of tests/test_bundle_adjustment.py rebuilt from
numpy seeds) and the dual-path landmark triangulation, against the JAX
package on the CPU.

Tolerances: graph ops are elementwise float32 (1e-6) or selections (equal);
the LM solvers (10 x 12-trip triangulation, 5 x 16-trip BA) differ only in
summation order, held to 1e-4 (relative to the point's magnitude for
landmarks); triangulation decisions (inserted slots, statuses) must agree.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrslam_tpu.geometry import cameras as jcam
from nrslam_tpu.geometry import se3 as jse3
from nrslam_tpu.slam import graph as jgraph
from nrslam_tpu.slam import mapping as jmap
from nrslam_tpu.slam import state as jstate
from nrslam_tpu.solver import bundle_adjustment as jba
from nrslam_tpu.solver import deformable_triangulation as jdt
from nrslam_tpu.solver import pose_deformation as jpd
from nrslam_tpu_torch.geometry import cameras as tcam
from nrslam_tpu_torch.geometry import se3 as tse3
from nrslam_tpu_torch.slam import graph as tgraph
from nrslam_tpu_torch.slam import mapping as tmap
from nrslam_tpu_torch.solver import bundle_adjustment as tba
from nrslam_tpu_torch.solver import deformable_triangulation as tdt
from nrslam_tpu_torch.solver import pose_deformation as tpd

from torch_parity import np_of, to_port

torch.set_num_threads(1)

PIN = (472.65, 472.65, 479.5, 359.5)


def _eq(a, b, tol=0.0):
    a, b = np_of(a), np_of(b)
    if tol == 0.0:
        assert np.array_equal(a, b)
    else:
        assert np.max(np.abs(a.astype(np.float64) - b)) <= tol


def test_graph_ops():
    rng = np.random.default_rng(0)
    P = 60
    pos = rng.normal(0, 1.0, (P, 3)).astype(np.float32)
    valid = rng.uniform(size=P) < 0.8
    gj = jgraph.initialize(jgraph.empty(P), jnp.asarray(pos),
                           jnp.asarray(valid), 3.0)
    gt = tgraph.initialize(tgraph.empty(P, device="cpu"), torch.as_tensor(pos),
                           torch.as_tensor(valid), 3.0)
    for f in gj._fields:
        _eq(getattr(gt, f), getattr(gj, f), 1e-6 if f != "exists" else 0.0)

    new = ~valid & (rng.uniform(size=P) < 0.7)
    pos2 = pos + rng.normal(0, 0.3, (P, 3)).astype(np.float32)
    gj2 = jgraph.add_edges(gj, jnp.asarray(pos2), jnp.asarray(new),
                           jnp.asarray(valid))
    gt2 = tgraph.add_edges(to_port(gj), torch.as_tensor(pos2),
                           torch.as_tensor(new), torch.as_tensor(valid))
    for f in gj2._fields:
        _eq(getattr(gt2, f), getattr(gj2, f), 1e-6)

    upd = rng.uniform(size=P) < 0.5
    gj3, goodj = jgraph.update_vertices(gj2, jnp.asarray(pos2 * 1.3),
                                        jnp.asarray(upd))
    gt3, goodt = tgraph.update_vertices(to_port(gj2),
                                        torch.as_tensor(pos2 * 1.3),
                                        torch.as_tensor(upd))
    for f in gj3._fields:
        _eq(getattr(gt3, f), getattr(gj3, f), 1e-6)
    _eq(goodt, goodj)

    elig = rng.uniform(size=P) < 0.9
    out_j = jgraph.top_k_neighbors(gj3, jnp.asarray(elig), 11)
    out_t = tgraph.top_k_neighbors(to_port(gj3), torch.as_tensor(elig), 11)
    for a, b in zip(out_t, out_j):
        _eq(a, b)

    rem = rng.uniform(size=P) < 0.2
    gj4 = jgraph.remove_landmarks(gj3, jnp.asarray(rem))
    gt4 = tgraph.remove_landmarks(to_port(gj3), torch.as_tensor(rem))
    _eq(gt4.exists, gj4.exists)
    _eq(gt4.bad, gj4.bad)


def _tri_inputs(n_cand=8, n_frames=10, nb=6, deform_amp=0.0, seed=0):
    """Numpy rebuild of test_deformable_triangulation.make_inputs."""
    rng = np.random.default_rng(seed)
    ts = np.linspace(0, 0.4, n_frames, dtype=np.float32)
    q = np.tile(np.array([1.0, 0, 0, 0], np.float32), (n_frames, 1))
    t = np.stack([ts, np.zeros_like(ts), np.zeros_like(ts)], -1)

    def sample(n):
        return np.stack([rng.uniform(-0.8, 0.8, n), rng.uniform(-0.6, 0.6, n),
                         rng.uniform(2.5, 3.5, n)], -1).astype(np.float32)

    cand = sample(n_cand)
    nbr = sample(n_cand * nb).reshape(n_cand, nb, 3)
    phase = np.linspace(0, 2 * np.pi, n_frames)

    def deform(X, k):
        return X + deform_amp * np.stack([
            np.sin(X[..., 0] + phase[k]), np.cos(X[..., 1] + phase[k]),
            0.3 * np.sin(phase[k]) * np.ones_like(X[..., 0])], -1)

    cj = jcam.pinhole(*PIN)
    obs = np.stack([np.asarray(jcam.project(cj, jnp.asarray(
        (deform(cand, k) + t[k]).astype(np.float32)))) for k in range(n_frames)],
        axis=1)
    nbr_pos = np.stack([deform(nbr, k) for k in range(n_frames)], axis=2)
    arrays = dict(obs=obs.astype(np.float32),
                  track_valid=np.ones((n_cand, n_frames), bool),
                  nbr_pos=nbr_pos.astype(np.float32),
                  nbr_valid=np.ones((n_cand, nb, n_frames), bool),
                  cand_valid=np.ones(n_cand, bool))
    arrays["track_valid"][1, 6:] = False   # a shorter track
    arrays["nbr_valid"][2, :3, 4] = False  # a few missing neighbours
    return arrays, q, t


@pytest.mark.parametrize("deform_amp", [0.0, 0.03])
def test_deformable_triangulate(deform_amp):
    arrays, q, t = _tri_inputs(deform_amp=deform_amp, seed=int(deform_amp
                                                               * 100))
    ij = jdt.TriangulationInputs(**{k: jnp.asarray(v)
                                    for k, v in arrays.items()})
    it = tdt.TriangulationInputs(**{k: torch.as_tensor(v)
                                    for k, v in arrays.items()})
    Xj, okj = jdt.deformable_triangulate(
        jcam.pinhole(*PIN), ij, jse3.SE3(jnp.asarray(q), jnp.asarray(t)),
        0.002)
    Xt, okt = tdt.deformable_triangulate(
        tcam.pinhole(*PIN, device="cpu"), it,
        tse3.SE3(torch.as_tensor(q), torch.as_tensor(t)), 0.002)
    _eq(okt, okj)
    ok = np_of(okj)
    assert ok.sum() >= 4
    err = np.abs(np_of(Xt)[ok] - np_of(Xj)[ok]) \
        / np.maximum(1.0, np.abs(np_of(Xj)[ok]))
    assert err.max() < 1e-4, err.max()


def _ba_window(K=5, P=120, deform_amp=0.02, seed=0):
    """Numpy rebuild of test_bundle_adjustment.make_window (+ noisy seeds)."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-1.2, 1.2, P), rng.uniform(-0.9, 0.9, P),
                  rng.uniform(2.5, 3.8, P)], -1).astype(np.float32)
    cj = jcam.pinhole(*PIN)
    tw = np.array([[0.01 * k, -0.005 * k, 0.008 * k, 0.06 * k, 0.0, 0.02 * k]
                   for k in range(K)], np.float32)
    poses = jse3.exp(jnp.asarray(tw))
    L = np.stack([X + deform_amp * np.stack([
        np.sin(X[:, 0] * 2 + k), np.cos(X[:, 1] + 0.5 * k),
        np.sin(X[:, 0] + X[:, 1] + k)], -1) for k in range(K)]
    ).astype(np.float32)
    obs = np.array(jcam.project(cj, jse3.apply(
        jax.tree.map(lambda a: a[:, None], poses), jnp.asarray(L))))
    d = np.linalg.norm(L[0][:, None] - L[0][None], axis=-1)
    np.fill_diagonal(d, np.inf)
    idx = np.argsort(d, axis=-1, kind="stable")[:, :8].astype(np.int32)
    dist = np.take_along_axis(d, idx, axis=-1).astype(np.float32)
    w = np.exp(-(dist ** 2) / (2 * (np.median(dist) * 3) ** 2)) \
        .astype(np.float32)
    t0 = np.array(poses.t) + rng.normal(0, 0.01, (K, 3)).astype(np.float32)
    L0 = L + rng.normal(0, 0.03, L.shape).astype(np.float32)
    return (np.array(poses.q), t0, L0, obs.astype(np.float32), idx, w, dist)


@pytest.mark.parametrize("masked_kfs", [False, True])
def test_local_deformable_ba(masked_kfs):
    q0, t0, L0, obs, idx, w, dist = _ba_window(seed=3)
    K, P = L0.shape[:2]
    kf_valid = np.ones(K, bool)
    if masked_kfs:
        kf_valid[3:] = False
        obs[3:] = np.nan
        L0[3:] = 1.0
    nbr = (idx, w, dist, np.ones_like(w, bool))
    pj = jpd.pairs_from_neighbors(*(jnp.asarray(a) for a in nbr))
    pt = tpd.pairs_from_neighbors(*(torch.as_tensor(a) for a in nbr))
    prob_j = jba.BAProblem(jnp.asarray(obs), jnp.ones((K, P), bool),
                           jnp.asarray(kf_valid), pj, jnp.float32(1.0))
    prob_t = tba.BAProblem(torch.as_tensor(obs), torch.ones((K, P),
                                                            dtype=torch.bool),
                           torch.as_tensor(kf_valid), pt, torch.tensor(1.0))
    Pj, Lj = jba.local_deformable_ba(
        jcam.pinhole(*PIN), jse3.SE3(jnp.asarray(q0), jnp.asarray(t0)),
        jnp.asarray(L0), prob_j, cg_iters=16)
    Pt, Lt = tba.local_deformable_ba(
        tcam.pinhole(*PIN, device="cpu"),
        tse3.SE3(torch.as_tensor(q0), torch.as_tensor(t0)),
        torch.as_tensor(L0), prob_t, cg_iters=16)
    live = kf_valid
    assert np.isfinite(np_of(Lt)[live]).all()
    _eq(Pt.q[live], np_of(Pj.q)[live], 1e-4)
    _eq(Pt.t[live], np_of(Pj.t)[live], 1e-4)
    _eq(Lt[live], np_of(Lj)[live], 1e-4)


def _mapping_state(def_mag, seed=0):
    """A JAX SlamState with an 8-frame temporal buffer of a sideways-moving
    camera: 40 mapped landmarks (graph-connected) and 20 tracked feature
    tracks without 3D, the triangulation candidates. ``def_mag`` is the
    recorded deformation magnitude of every buffered frame."""
    rng = np.random.default_rng(seed)
    P, n_map, n_cand, T = 64, 40, 20, 8
    H, W, f = 240, 320, 250.0
    cfg = jstate.Config(max_points=P, rad_per_pixel=1.0 / f)
    cj = jcam.pinhole(f, f, (W - 1) / 2, (H - 1) / 2)
    X = np.stack([rng.uniform(-1.3, 1.3, P), rng.uniform(-1.0, 1.0, P),
                  rng.uniform(2.6, 3.4, P)], -1).astype(np.float32)
    used = np.arange(P) < n_map + n_cand
    with3d = np.arange(P) < n_map
    s = jstate.empty_state(cfg, (H, W))
    s = s._replace(
        slot_used=jnp.asarray(used), has_3d=jnp.asarray(with3d),
        track_id=jnp.arange(P, dtype=jnp.int32),
        positions=jnp.asarray(np.where(with3d[:, None], X, 0.0)),
        graph=jgraph.initialize(s.graph, jnp.asarray(X), jnp.asarray(with3d),
                                3.0))
    for k in range(T):
        Tk = jse3.exp(jnp.asarray([0.0, 0.004 * k, 0.0, -0.025 * k, 0.0, 0.0],
                                  jnp.float32))
        kp = np.array(jcam.project(cj, jse3.apply(Tk, jnp.asarray(X))))
        kp += rng.normal(0, 0.2, kp.shape)
        status = np.where(with3d, 0, np.where(used, 1, 6)).astype(np.int32)
        s = s._replace(Tcw=Tk, keypoints=jnp.asarray(kp, jnp.float32),
                       status=jnp.asarray(status),
                       deformation_mag=jnp.float32(def_mag))
        s = jstate.insert_temporal_snapshot(s)
    return s, cj, cfg


@pytest.mark.parametrize("def_mag,min_inserted", [(0.001, 0), (0.01, 5)],
                         ids=["rigid_tie", "deforming"])
def test_landmark_triangulation(def_mag, min_inserted):
    """Rigid buffer: both paths triangulate the same candidates, so the 1.5x
    vote inserts none. Deforming buffer (above the 0.004 rigidity
    threshold): only the deformable path succeeds and its points go in."""
    sj, cj, cfg = _mapping_state(def_mag)
    out_j = jax.jit(partial(jmap.landmark_triangulation, config=cfg))(sj, cj)
    out_t = tmap.landmark_triangulation(to_port(sj), to_port(cj),
                                        to_port(cfg))
    _eq(out_t.status, out_j.status)
    _eq(out_t.has_3d, out_j.has_3d)
    inserted = np_of(out_j.has_3d) & ~np_of(sj.has_3d)
    assert inserted.sum() >= min_inserted
    err = np.abs(np_of(out_t.positions) - np_of(out_j.positions)) \
        / np.maximum(1.0, np.abs(np_of(out_j.positions)))
    assert err.max() < 1e-4, err.max()
    _eq(out_t.graph.exists, out_j.graph.exists)
    _eq(out_t.graph.first_distance, out_j.graph.first_distance, 1e-4)
