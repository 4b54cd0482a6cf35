"""The steady-state benchmark problem (counterpart of
``bench.build_bench_problem``): a synthetic deforming scene, P landmark slots
seeded at uniformly drawn keypoints at depth 3, an all-pairs deformation
graph, one keyframe and one temporal snapshot, plus six rendered frames.

The initial keypoints come from ``numpy.random.default_rng(seed)``, so the
same problem can be built on any device (and handed to the JAX package).
"""

from __future__ import annotations

import numpy as np
import torch

from nrslam_tpu_torch.datasets import synthetic
from nrslam_tpu_torch.geometry import cameras, se3
from nrslam_tpu_torch.ops import klt
from nrslam_tpu_torch.slam import graph as graph_mod
from nrslam_tpu_torch.slam import state as state_mod
from nrslam_tpu_torch.slam.state import Config
from nrslam_tpu_torch.utils.device import resolve


def initial_keypoints(max_points: int, height: int, width: int,
                      seed: int = 0) -> np.ndarray:
    """[P, 2] float32 keypoints uniform in the image minus a 25 px border."""
    rng = np.random.default_rng(seed)
    u = 25 + (width - 50) * rng.random(max_points)
    v = 25 + (height - 50) * rng.random(max_points)
    return np.stack([u, v], -1).astype(np.float32)


def build_bench_problem(max_points: int = 768, height: int = 480,
                        width: int = 640, max_new_kp: int = 256,
                        device=None, seed: int = 0,
                        rows: graph_mod.Rows = graph_mod.ALL):
    """Returns (state, raw_frames [6 x [H, W]], mask, cam, config), on
    the card unless ``device`` says otherwise. The graph holds ``rows``
    (all by default; a rank of a sharded run builds only its own); the
    rest of the state is whole either way."""
    device = resolve(device)
    scene = synthetic.SceneConfig(height=height, width=width,
                                  deform_amp=0.02)
    cam = synthetic.camera(scene, device)
    config = Config(max_points=max_points, max_new_keypoints=max_new_kp,
                    rad_per_pixel=1.0 / scene.fx)

    gray0, _, _ = synthetic.render_frame(0, scene, device)
    pyr0 = klt.build_pyramid(gray0, config.klt_config)

    state = state_mod.empty_state(config, gray0.shape, device, rows)
    uv = torch.as_tensor(initial_keypoints(max_points, height, width, seed),
                         device=device)
    positions = cameras.unproject(cam, uv) * 3.0
    valid = torch.ones(max_points, dtype=torch.bool, device=device)
    refs = klt.set_reference(pyr0, uv, valid, config.klt_config)
    state = state._replace(
        slot_used=valid,
        track_id=torch.arange(max_points, dtype=torch.int32, device=device),
        has_3d=valid,
        positions=positions,
        keypoints=uv,
        status=torch.zeros(max_points, dtype=torch.int32, device=device),
        refs=refs,
        graph=graph_mod.initialize(state.graph, positions, valid, 3.0,
                                   rows),
    )
    state = state_mod.insert_temporal_snapshot(state)
    state = state_mod.insert_keyframe(state)

    raw_frames = [synthetic.render_frame(i, scene, device)[0]
                  for i in range(1, 7)]
    mask = torch.ones(gray0.shape, dtype=torch.bool, device=device)
    return state, raw_frames, mask, cam, config


def _knn(X, K: int, rows: int = 1024):
    """Each point's K nearest other points (stable order) and distances,
    [P, K] each, in blocks of rows so that large P stays small in memory."""
    idx, dist = [], []
    for a in range(0, X.shape[0], rows):
        d = np.linalg.norm(X[a:a + rows, None] - X[None], axis=-1)
        d[np.arange(d.shape[0]), a + np.arange(d.shape[0])] = np.inf
        i = np.argsort(d, axis=-1, kind="stable")[:, :K]
        idx.append(i)
        dist.append(np.take_along_axis(d, i, axis=-1).astype(np.float32))
    return np.concatenate(idx), np.concatenate(dist)


def solver_problem(kind: str = cameras.PINHOLE, device=None,
                   P: int = 768, with_pairs: bool = True,
                   deform_amp: float = 0.05):
    """A seeded tracking-solver problem at the frame's shapes: P=768 (or
    the 320x240 slice's 384) landmarks in a 2.4 x 1.8 x 1.5 box ~3 units
    ahead, a smooth deformation (amplitude ``deform_amp``, 0.05; 0 gives a
    rigid scene), observations from a known
    pose with 0.3 px noise, 5% gross outliers and 10% masked points, and a
    K=11 nearest-neighbour pair table with RBF weights (P*K directed
    entries; after ``compact_pairs`` E = (ceil(K/2)+1) P, 5376 at P=768).

    Returns (cam, T_seed (identity), X [P,3], obs [P,2], valid [P],
    pairs (raw, before compaction; None when ``with_pairs`` is False, which
    skips the kNN)), on the card unless ``device`` says otherwise.
    """
    from nrslam_tpu_torch.solver import pose_deformation as pd

    device = resolve(device)
    K = 11
    rng = np.random.default_rng(0)
    X = np.stack([rng.uniform(-1.2, 1.2, P), rng.uniform(-0.9, 0.9, P),
                  rng.uniform(2.5, 4.0, P)], -1).astype(np.float32)
    flow = deform_amp * np.stack([np.sin(2.0 * X[:, 0]),
                                  np.cos(1.5 * X[:, 1]),
                                  np.sin(X[:, 0] + X[:, 1])], -1)
    if kind == cameras.PINHOLE:
        cam = cameras.pinhole(472.65, 472.65, 479.5, 359.5, device=device)
    else:
        cam = cameras.kannala_brandt8(400.0, 400.0, 479.5, 359.5,
                                      0.05, -0.01, 0.004, -0.001,
                                      device=device)
    T_true = se3.exp(torch.tensor([0.02, -0.01, 0.015, 0.06, -0.04, 0.05],
                                  dtype=torch.float32, device=device))
    Xt = torch.as_tensor(X + flow.astype(np.float32), device=device)
    obs = cameras.project(cam, se3.apply(T_true, Xt))
    noise = rng.normal(0.0, 0.3, (P, 2)).astype(np.float32)
    outlier = rng.random(P) < 0.05
    noise[outlier] += rng.normal(0.0, 40.0, (int(outlier.sum()), 2))
    obs = obs + torch.as_tensor(noise, device=device)
    valid = torch.as_tensor(rng.random(P) >= 0.1, device=device)
    T0, X_dev = se3.identity(device=device), torch.as_tensor(X, device=device)
    if not with_pairs:
        return cam, T0, X_dev, obs, valid, None

    idx, dist = _knn(X, K)
    sigma = np.median(dist) * 3
    w = np.exp(-(dist ** 2) / (2 * sigma ** 2)).astype(np.float32)
    pairs = pd.pairs_from_neighbors(
        torch.as_tensor(idx, device=device), torch.as_tensor(w, device=device),
        torch.as_tensor(dist, device=device),
        torch.ones((P, K), dtype=torch.bool, device=device))
    return cam, T0, X_dev, obs, valid, pairs


def ba_problem(kind: str = cameras.PINHOLE, n_valid: int = 5, device=None,
               seed: int = 0, K: int = 5, P: int = 768):
    """A seeded keyframe-BA window at the keyframe's shapes: K=5 keyframes
    (K <= 8) of a sideways sweep over P=768 landmarks that deform between
    keyframes
    (amplitude 0.02), exact observations of which ~25% per keyframe are
    masked, noisy seeds (poses +N(0, 0.01), landmarks +N(0, 0.03)) and a
    K=11 nearest-neighbour pair table (E = 5376 after ``compact_pairs``).
    With ``n_valid`` < K the oldest slots are invalid as the pipeline leaves
    them after ``bootstrap_map``: zero landmarks at the identity pose, no
    observations.

    Returns (cam, poses0 [K], L0 [K, P, 3], BAProblem), on the card unless
    ``device`` says otherwise."""
    from nrslam_tpu_torch.solver import bundle_adjustment as ba
    from nrslam_tpu_torch.solver import pose_deformation as pd

    device = resolve(device)
    NB = 11
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-1.2, 1.2, P), rng.uniform(-0.9, 0.9, P),
                  rng.uniform(2.5, 3.8, P)], -1).astype(np.float32)
    L = np.stack([X + 0.02 * np.stack([
        np.sin(X[:, 0] * 2 + k), np.cos(X[:, 1] + 0.5 * k),
        np.sin(X[:, 0] + X[:, 1] + k)], -1) for k in range(K)]
    ).astype(np.float32)
    tw = np.array([[0.01 * k, -0.005 * k, 0.008 * k, 0.06 * k, 0.0, 0.02 * k]
                   for k in range(K)], np.float32)
    if kind == cameras.PINHOLE:
        cam = cameras.pinhole(472.65, 472.65, 479.5, 359.5, device=device)
    else:
        cam = cameras.kannala_brandt8(400.0, 400.0, 479.5, 359.5,
                                      0.05, -0.01, 0.004, -0.001,
                                      device=device)
    poses = se3.exp(torch.as_tensor(tw, device=device))
    L_t = torch.as_tensor(L, device=device)
    obs = cameras.project(cam, se3.apply(se3.SE3(poses.q[:, None],
                                                 poses.t[:, None]), L_t))
    obs_valid = rng.random((K, P)) >= 0.25

    idx, dist = _knn(L[0], NB)
    w = np.exp(-(dist ** 2) / (2 * (np.median(dist) * 3) ** 2)) \
        .astype(np.float32)
    pairs = pd.pairs_from_neighbors(
        torch.as_tensor(idx, device=device), torch.as_tensor(w, device=device),
        torch.as_tensor(dist, device=device),
        torch.ones((P, NB), dtype=torch.bool, device=device))
    pairs = pd.compact_pairs(pairs, P)

    t0 = poses.t + torch.as_tensor(
        rng.normal(0, 0.01, (K, 3)).astype(np.float32), device=device)
    L0 = L_t + torch.as_tensor(rng.normal(0, 0.03, L.shape)
                               .astype(np.float32), device=device)
    kf_valid = torch.arange(K, device=device) >= K - n_valid
    ident = se3.identity((K,), device=device)
    q0 = torch.where(kf_valid[:, None], poses.q, ident.q)
    t0 = torch.where(kf_valid[:, None], t0, ident.t)
    L0 = torch.where(kf_valid[:, None, None], L0, torch.zeros_like(L0))
    obs = torch.where(kf_valid[:, None, None], obs, torch.zeros_like(obs))
    obs_valid = torch.as_tensor(obs_valid, device=device) & kf_valid[:, None]
    problem = ba.BAProblem(obs=obs, obs_valid=obs_valid, kf_valid=kf_valid,
                           pairs=pairs,
                           scale=torch.tensor(1.0, device=device))
    return cam, se3.SE3(q0, t0), L0, problem
