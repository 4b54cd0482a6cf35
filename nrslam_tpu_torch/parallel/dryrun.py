"""Spawned ranks for sharded runs, and the multi-rank dry run (the
counterpart of ``__graft_entry__.dryrun_multichip``).

``World(n, device, backend=...)`` spawns n rank processes (the ``spawn``
start method; they import the port and torch, nothing else of the repo) on
``device`` (the card unless the caller passes another, ``utils.device``),
joined in one process group through a ``FileStore`` in a fresh directory,
each with one CPU thread: gloo, every rank on ``device``; or NCCL, rank r
on card r (NCCL refuses several ranks on one card). It keeps them for as
many ``run`` calls as the caller makes:
``run(task, *args)`` runs ``TASKS[task](mesh, *args)`` on every rank and
returns each rank's result. Arguments and results are numpy
trees (``convert.to_numpy`` of port structures). A rank that fails ends
the world and its traceback is raised in the caller.

``dryrun_multichip(n, device)`` spawns n ranks and runs, on each, the
sharded non-keyframe (tracking and mapping), a keyframe with its
partitioned window BA, the sharded pose normal equations and the
keyframe-sharded BA at K = n.
"""

from __future__ import annotations

import contextlib
import os
import queue
import statistics
import sys
import tempfile
import time
import traceback
import warnings

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from nrslam_tpu_torch import bench_problem, convert
from nrslam_tpu_torch.geometry import cameras, se3
from nrslam_tpu_torch.parallel import (ba_points, ba_shard, multihost,
                                       sharding, solve_shard, tracking_shard)
from nrslam_tpu_torch.parallel.tracking_shard import frame_step_sharded
from nrslam_tpu_torch.utils.device import resolve
from nrslam_tpu_torch.utils.tree import tree_map

TASKS = {}

# Seconds ``World.run`` waits for every rank's answer before it ends the
# world (a rank stuck in a collective whose peer failed never answers).
TIMEOUT_S = 300.0


def task(fn):
    TASKS[fn.__name__] = fn
    return fn


def to_device(tree, device):
    """A numpy tree (``convert.to_numpy``) as tensors on ``device``."""
    return tree_map(lambda x: torch.as_tensor(np.array(x)).to(device)
                    if isinstance(x, (np.ndarray, np.generic)) else x, tree)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _launch_counts():
    """The kernel wrappers' launch counts: the whole-solver kernels by
    name, the sharded routes' calls and phase launches as ``route.phase``."""
    from nrslam_tpu_torch.solver import bundle_adjustment_cuda as bac
    from nrslam_tpu_torch.solver import pose_deformation_cuda as pdc
    from nrslam_tpu_torch.solver import pose_only_cuda

    out = {"pose_only": pose_only_cuda.launches,
           "pose_deformation": pdc.launches,
           "bundle_adjustment": bac.launches}
    for route, mod in (("pose_only_shard", pose_only_cuda),
                       ("pose_deformation_shard", pdc),
                       ("bundle_adjustment_shard", bac)):
        out[f"{route}.calls"] = mod.shard_calls
        out.update({f"{route}.{k}": v for k, v in mod.shard_launches.items()})
    return out


def frame_launches(keyframes) -> dict:
    """``_launch_counts`` that ``len(keyframes)`` sharded frames make on
    each rank: one partitioned pose-only and one partitioned joint call a
    frame and one partitioned window BA a keyframe, with their phase
    launches; no whole-solver pose-only, joint or BA launch."""
    from nrslam_tpu_torch.solver import bundle_adjustment_cuda as bac
    from nrslam_tpu_torch.solver import pose_deformation_cuda as pdc
    from nrslam_tpu_torch.solver import pose_only_cuda

    n, n_kf = len(keyframes), sum(map(bool, keyframes))
    want = {"pose_only": 0, "pose_deformation": 0, "bundle_adjustment": 0,
            "pose_only_shard.calls": n, "pose_deformation_shard.calls": n,
            "bundle_adjustment_shard.calls": n_kf}
    for route, calls, launches in (
            ("pose_only_shard", n, pose_only_cuda.shard_phase_launches()),
            ("pose_deformation_shard", n, pdc.shard_phase_launches()),
            ("bundle_adjustment_shard", n_kf, bac.shard_phase_launches())):
        want.update({f"{route}.{k}": calls * v for k, v in launches.items()})
    return want


# ---------------------------------------------------------------------------
# Rank tasks: fn(mesh, *numpy args) -> numpy tree
# ---------------------------------------------------------------------------

@task
def pose_system(mesh, cam, q, t, X, obs, w):
    """The sharded pose normal equations over the rank's block of the
    points (H, g, chi2), the inputs whole on every rank."""
    cam = to_device(cam, mesh.device)
    X, obs, w = sharding.shard_state(to_device((X, obs, w), mesh.device),
                                     mesh, X.shape[0])
    H, g, chi2 = sharding.pose_system_sharded(mesh, cam)(
        *to_device((q, t), mesh.device), X, obs, w)
    return convert.to_numpy((H, g, chi2))


@task
def sharded_solves(mesh, cam, T0, X, obs, valid, pairs, scale):
    """The pose-only and joint solves partitioned over the ranks
    (``solve_shard``) on the rank's block of whole numpy inputs: the
    pose-only solve from ``T0``, then the joint from its pose. Returns
    (pose-only SE3, the joint's PoseDeformationResult, the collectives'
    count and bytes, the phase-kernel launches, (pose-only ms, joint
    ms))."""
    cam, T0, X, obs, valid, pairs = to_device(
        (cam, T0, X, obs, valid, pairs), mesh.device)
    solves = solve_shard.mesh_solves(mesh)
    before = _launch_counts()
    _sync(mesh.device)
    sharding.traffic.reset()
    t0 = time.perf_counter()
    T = solves.pose_only(cam, T0, X, obs, valid)
    _sync(mesh.device)
    t1 = time.perf_counter()
    res = solves.joint(cam, T, X, obs, valid, pairs, scale)
    _sync(mesh.device)
    ms = (1e3 * (t1 - t0), 1e3 * (time.perf_counter() - t1))
    launches = {k: v - before[k] for k, v in _launch_counts().items()}
    return (convert.to_numpy((T, res)) + (sharding.traffic.count,
                                          sharding.traffic.bytes, launches,
                                          ms))


@task
def points_ba(mesh, cam, poses0, L0, problem, n_iters=5, cg_iters=32):
    """The window BA partitioned over the ranks' point blocks
    (``ba_points``) from a whole numpy window: the rank takes its block of
    the observations. Returns (poses, the whole solved copies, the
    collectives' count and bytes, the phase-kernel launches, ms)."""
    cam, poses0, L0, problem = to_device((cam, poses0, L0, problem),
                                         mesh.device)
    problem = problem._replace(obs=sharding.local_block(mesh, problem.obs,
                                                        1))
    before = _launch_counts()
    _sync(mesh.device)
    sharding.traffic.reset()
    t0 = time.perf_counter()
    poses, L = ba_points.local_deformable_ba_sharded(
        mesh, cam, poses0, L0, problem, n_iters, cg_iters)
    _sync(mesh.device)
    ms = 1e3 * (time.perf_counter() - t0)
    launches = {k: v - before[k] for k, v in _launch_counts().items()}
    return convert.to_numpy((poses, L)) + (
        sharding.traffic.count, sharding.traffic.bytes, launches, ms)


@task
def kf_sharded_ba(mesh, cam, poses0, L0, problem, n_iters=5, cg_iters=32):
    """The keyframe-sharded BA of a whole window; returns (poses, L, ms)."""
    cam, poses0, L0, problem = to_device((cam, poses0, L0, problem),
                                         mesh.device)
    _sync(mesh.device)
    t0 = time.perf_counter()
    poses, L = ba_shard.local_deformable_ba_kf_sharded(
        mesh, cam, poses0, L0, problem, n_iters, cg_iters)
    _sync(mesh.device)
    ms = 1e3 * (time.perf_counter() - t0)
    return convert.to_numpy((poses, L)) + (ms,)


def _run_frames(mesh, local, frames, mask, cam, config, keyframes,
                gather_graph: bool):
    """``frame_step_sharded`` from the rank's shard ``local`` over the numpy
    ``frames`` (``keyframes`` flags them). Per frame: n_tracked_3d, the
    LOST flag, ms, the bytes, payloads and largest payload (elements) of
    its collectives (``sharding.traffic``; feeding the frame is not part
    of it) and the shapes of the rank's graph leaves after it. Also the
    kernel launches and, on the card, the rank's peak allocated bytes over
    the frames (``max_memory_allocated`` from the resident state,
    ``resident``). Rank 0 returns the whole final state (a gather after
    the frames; without the KLT references, and with the graph only when
    ``gather_graph``)."""
    from nrslam_tpu_torch.parallel.tracking_shard import state_axes

    mask = multihost.replicate_frame(mesh, mask)
    cuda = torch.device(mesh.device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(mesh.device)
        torch.cuda.reset_peak_memory_stats(mesh.device)
        resident = torch.cuda.memory_allocated(mesh.device)
    before = _launch_counts()
    out = {k: [] for k in ("n_tracked_3d", "lost", "ms", "bytes",
                           "payloads", "max_payload", "graph_shapes",
                           "solve_bytes", "solve_payloads", "gather_bytes")}
    for frame, kf in zip(frames, keyframes):
        gray = multihost.replicate_frame(mesh, frame)
        _sync(mesh.device)
        sharding.traffic.reset()
        solve_shard.traffic.reset()
        tracking_shard.traffic.reset()
        t0 = time.perf_counter()
        local, res = frame_step_sharded(mesh, local, gray, mask, cam, config,
                                        bool(kf))
        _sync(mesh.device)
        out["ms"].append(1e3 * (time.perf_counter() - t0))
        out["bytes"].append(sharding.traffic.bytes)
        out["payloads"].append(sharding.traffic.count)
        out["max_payload"].append(sharding.traffic.max_elements)
        out["solve_bytes"].append(solve_shard.traffic.bytes)
        out["solve_payloads"].append(solve_shard.traffic.count)
        out["gather_bytes"].append(tracking_shard.traffic.bytes)
        out["graph_shapes"].append(sorted({tuple(x.shape)
                                           for x in local.graph[:-1]}))
        out["n_tracked_3d"].append(int(res.n_tracked_3d))
        out["lost"].append(bool(res.lost))
    out["launches"] = {k: v - before[k] for k, v in _launch_counts().items()}
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(mesh.device)
                         if cuda else None)
    out["resident_bytes"] = resident if cuda else None
    axes = state_axes(config, tuple(mask.shape))._replace(refs=None)
    local = local._replace(refs=None)
    if not gather_graph:
        axes, local = axes._replace(graph=None), local._replace(graph=None)
    full = sharding.unshard_state(local, mesh, axes)
    out["state"] = convert.to_numpy(full) if mesh.rank == 0 else None
    return out


@task
def sharded_frames(mesh, state, frames, mask, cam, config, keyframes,
                   gather_graph=True):
    """``frame_step_sharded`` over ``frames`` from the whole ``state``
    (each rank feeds every frame and takes its slots and graph rows of the
    state). Returns ``_run_frames``'s record."""
    cam = to_device(cam, mesh.device)
    local = tracking_shard.shard_state(to_device(state, mesh.device), mesh,
                                       config)
    return _run_frames(mesh, local, frames, mask, cam, config, keyframes,
                       gather_graph)


@task
def frame_placement_round_trip(mesh, state, config, image_shape):
    """The whole numpy ``state`` placed as the sharded frame holds it
    (``tracking_shard.shard_state``) and gathered back
    (``sharding.unshard_state`` with ``tracking_shard.state_axes``).
    Returns (the gathered state, the rank's shapes of a few leaves)."""
    local = tracking_shard.shard_state(to_device(state, mesh.device), mesh,
                                       config)
    shapes = {"positions": local.positions.shape,
              "graph.weight": local.graph.weight.shape,
              "kf_positions": local.kf_positions.shape,
              "kf_obs": local.kf_obs.shape,
              "tb_positions": local.tb_positions.shape,
              "tb_tracked": local.tb_tracked.shape,
              "refs.patch": local.refs.patch.shape}
    whole = sharding.unshard_state(
        local, mesh, tracking_shard.state_axes(config, tuple(image_shape)))
    return convert.to_numpy(whole), {k: tuple(v) for k, v in shapes.items()}


@task
def bench_frames(mesh, max_points, keyframes, gather_graph=False):
    """``bench_problem.build_bench_problem`` (the main path's 640x480 and
    256 new keypoints, seed 0) at ``max_points`` built on the rank, with
    only the rank's rows of the graph (nothing of size [P, P] travels or
    is built), then ``frame_step_sharded`` over its first
    ``len(keyframes)`` frames. Returns ``_run_frames``'s record."""
    state, frames, mask, cam, config = bench_problem.build_bench_problem(
        max_points, device=mesh.device,
        rows=sharding.MeshRows(mesh, max_points))
    local = tracking_shard.shard_state(state._replace(graph=None), mesh,
                                       config)._replace(graph=state.graph)
    frames = [f.cpu().numpy() for f in frames[:len(keyframes)]]
    del state
    return _run_frames(mesh, local, frames, mask.cpu().numpy(), cam, config,
                       keyframes, gather_graph)


@task
def multihost_round_trip(mesh, frame, points):
    """replicate_frame / shard_points on agreeing inputs, then a frame that
    differs on one rank, which every rank must refuse; and the state
    checksum compared across ranks: equal trees, then one bit flipped on
    rank 1, then two rows swapped on rank 1."""
    got = multihost.replicate_frame(mesh, frame)
    n = points.shape[0] // mesh.world_size
    mine = multihost.shard_points(
        mesh, points[mesh.rank * n:(mesh.rank + 1) * n])
    refused = False
    try:
        multihost.replicate_frame(mesh, frame + (mesh.rank == 1))
    except ValueError:
        refused = True
    tree = (torch.as_tensor(points, device=mesh.device),
            torch.ones(5, dtype=torch.bool, device=mesh.device))
    flipped = tree[0].clone()
    flipped.view(torch.int32)[3, 1] ^= 1
    swapped = tree[0][[1, 0] + list(range(2, points.shape[0]))]
    digest_same = [sharding.same_on_ranks(mesh, sharding.digest(
        (x, tree[1]) if mesh.rank == 1 else tree))
        for x in (tree[0], flipped, swapped)]
    return {"frame": got.cpu().numpy(), "shard": mine.cpu().numpy(),
            "refused": refused, "digest_same": digest_same}


def small_problem(max_points: int = 64, device=None, seed: int = 0):
    """The dry run's tracking problem (``__graft_entry__._small_problem``
    with the keypoints drawn by numpy): a 96x128 scene, P landmarks at depth
    3 in front of seeded keypoints, an all-pairs graph and one snapshot.
    Returns (state, gray1, mask, cam, config)."""
    from nrslam_tpu_torch.datasets import synthetic
    from nrslam_tpu_torch.ops import klt
    from nrslam_tpu_torch.slam import graph as graph_mod
    from nrslam_tpu_torch.slam import state as state_mod
    from nrslam_tpu_torch.slam.state import Config

    scene = synthetic.SceneConfig(height=96, width=128, fx=100.0, fy=100.0)
    cam = synthetic.camera(scene, device)
    config = Config(max_points=max_points, max_new_keypoints=32,
                    rad_per_pixel=0.01)
    gray0, _, _ = synthetic.render_frame(0, scene, device)
    gray1, _, _ = synthetic.render_frame(1, scene, device)
    rng = np.random.default_rng(seed)
    uv = torch.as_tensor(np.stack([20 + 88 * rng.random(max_points),
                                   20 + 56 * rng.random(max_points)], -1)
                         .astype(np.float32), device=gray0.device)
    positions = cameras.unproject(cam, uv) * 3.0
    valid = torch.ones(max_points, dtype=torch.bool, device=gray0.device)
    refs = klt.set_reference(klt.build_pyramid(gray0, config.klt_config),
                             uv, valid, config.klt_config)
    state = state_mod.empty_state(config, gray0.shape, gray0.device)
    state = state._replace(
        slot_used=valid,
        track_id=torch.arange(max_points, dtype=torch.int32,
                              device=gray0.device),
        has_3d=valid, positions=positions, keypoints=uv,
        status=torch.zeros(max_points, dtype=torch.int32,
                           device=gray0.device),
        refs=refs,
        graph=graph_mod.initialize(state.graph, positions, valid, 3.0))
    state = state_mod.insert_temporal_snapshot(state)
    mask = torch.ones(gray0.shape, dtype=torch.bool, device=gray0.device)
    return state, gray1, mask, cam, config


def ba_window(cam, K: int, P: int = 32, seed: int = 3, device=None):
    """The dry run's BA window: K keyframes of a slow sweep over P points,
    exact observations, a 4-nearest-neighbour pair table, every slot valid
    (``__graft_entry__.dryrun_multichip``'s, drawn by numpy)."""
    from nrslam_tpu_torch.solver import bundle_adjustment as ba
    from nrslam_tpu_torch.solver import pose_deformation as pd

    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-0.8, 0.8, P), rng.uniform(-0.6, 0.6, P),
                  rng.uniform(2.5, 3.5, P)], -1).astype(np.float32)
    tw = np.array([[0.01 * k, 0.0, 0.005 * k, 0.02 * k, 0.0, 0.01 * k]
                   for k in range(K)], np.float32)
    poses = se3.exp(torch.as_tensor(tw, device=device))
    L = torch.as_tensor(X, device=device).expand(K, P, 3).contiguous()
    obs = cameras.project(cam, se3.apply(se3.SE3(poses.q[:, None],
                                                 poses.t[:, None]), L))
    d = np.linalg.norm(X[:, None] - X[None], axis=-1)
    nbr = np.argsort(d, axis=-1, kind="stable")[:, 1:5]
    d0 = torch.as_tensor(np.take_along_axis(d, nbr, -1).astype(np.float32),
                         device=device)
    pairs = pd.pairs_from_neighbors(
        torch.as_tensor(nbr, device=device), torch.ones_like(d0), d0,
        torch.ones(d0.shape, dtype=torch.bool, device=device))
    problem = ba.BAProblem(
        obs=obs, obs_valid=torch.ones((K, P), dtype=torch.bool,
                                      device=device),
        kf_valid=torch.ones(K, dtype=torch.bool, device=device), pairs=pairs,
        scale=torch.tensor(1.0, device=device))
    return poses, L, problem


@task
def dryrun(mesh):
    """The dry-run sequence on this rank; returns what it checked."""
    n = mesh.world_size
    P = max(64, n * 8)
    state, gray, mask, cam, config = small_problem(P, mesh.device)
    local = tracking_shard.shard_state(state, mesh, config)
    mapped, res = frame_step_sharded(mesh, local, gray, mask, cam, config,
                                     False)
    kf_state, kf_res = frame_step_sharded(mesh, mapped, gray, mask, cam,
                                          config, True)
    mine = sharding.shard_state(state, mesh, P)
    H, g, _ = sharding.pose_system_sharded(mesh, cam)(
        state.Tcw.q, state.Tcw.t, mine.positions, mine.keypoints,
        mine.slot_used.to(torch.float32))
    poses, L, problem = ba_window(cam, n, device=mesh.device)
    poses_out, L_out = ba_shard.local_deformable_ba_kf_sharded(
        mesh, cam, poses, L, problem, n_iters=2, cg_iters=8)
    out = {"n_tracked_3d": [int(res.n_tracked_3d),
                            int(kf_res.n_tracked_3d)],
           "kf_valid": int(kf_state.kf_valid.sum()),
           "H_shape": tuple(H.shape), "L_shape": tuple(L_out.shape),
           "finite": bool(torch.isfinite(kf_state.positions).all()
                          & torch.isfinite(H).all()
                          & torch.isfinite(L_out).all()
                          & torch.isfinite(poses_out.t).all())}
    assert out["H_shape"] == (6, 6) and out["L_shape"] == (n, 32, 3), out
    assert out["finite"], out
    return out


# ---------------------------------------------------------------------------
# Sharded runs held to one process (chip_smoke.py [parallel], multicard)
# ---------------------------------------------------------------------------

def solves_against_whole(world, device, deform: float) -> dict:
    """``sharded_solves`` on the world's ranks on the pinhole P=768 solver
    problem (``bench_problem.solver_problem``, deformation ``deform``)
    against the whole-solver kernels in this process: the largest pose
    difference (pose-only and joint), the largest per-point flow difference
    over valid points, whether every rank holds the same bits, rank 0's
    collectives, bytes, launches and ms of each solve beside the
    whole-solver kernels' (host clock, synchronised)."""
    from nrslam_tpu_torch.solver import pose_deformation as pd
    from nrslam_tpu_torch.solver import pose_only_cuda

    device = torch.device(device)
    cam, T0, X, obs, valid, pairs = bench_problem.solver_problem(
        device=device, deform_amp=deform)
    outs = world.run("sharded_solves", *convert.to_numpy(
        (cam, T0, X, obs, valid, pairs)), 1.0)
    _sync(device)
    t0 = time.perf_counter()
    T_w = pose_only_cuda.camera_pose_optimization_cuda(cam, T0, X, obs,
                                                       valid)
    _sync(device)
    t1 = time.perf_counter()
    r_w = pd.pose_deformation_optimization(cam, T_w, X, obs, valid, pairs,
                                           1.0)
    _sync(device)
    ms_w = (1e3 * (t1 - t0), 1e3 * (time.perf_counter() - t1))
    T, r, count, nb, launches, ms = outs[0]

    def d_pose(a, b):
        q, q_ref = a.q, b.q.cpu().numpy()
        return max(min(float(np.linalg.norm(q - q_ref)),
                       float(np.linalg.norm(q + q_ref))),
                   float(np.linalg.norm(a.t - b.t.cpu().numpy())))

    return {"d_pose": max(d_pose(T, T_w), d_pose(r.Tcw, r_w.Tcw)),
            "d_flow": float(np.max(np.linalg.norm(
                r.flows - r_w.flows.cpu().numpy(), axis=-1)[
                    valid.cpu().numpy()])),
            "same": all(np.array_equal(o[1].flows, r.flows)
                        and np.array_equal(o[0].t, T.t) for o in outs),
            "count": count, "bytes": nb, "launches": launches, "ms": ms,
            "whole_ms": ms_w, "P": X.shape[0], "deform": deform}


def report_solves(tag: str, r: dict, n: int, tol_pose: float,
                  tol_flow: float):
    """Prints ``solves_against_whole``'s readings ``r`` for n ranks as a
    ``tag`` line, and raises AssertionError unless every rank holds the
    same bits and the differences are below the tolerances."""
    label = "rigid" if r["deform"] == 0 else "deformed"
    print(f"{tag} sharded pose-only + joint pinhole P={r['P']} {label} over "
          f"{n} ranks against the whole-solver kernels: pose "
          f"{r['d_pose']:.3e} (tol {tol_pose:.3e}) max|dflow| "
          f"{r['d_flow']:.3e} (tol {tol_flow:.3e}); every rank the same "
          f"bits: {r['same']}; rank 0: {r['count']} collectives, "
          f"{r['bytes']} bytes, pose-only {r['ms'][0]:.2f} ms, joint "
          f"{r['ms'][1]:.2f} ms (the whole-solver kernels in this process "
          f"{r['whole_ms'][0]:.2f} / {r['whole_ms'][1]:.2f} ms); launches "
          f"{r['launches']}")
    if not (r["same"] and r["d_pose"] < tol_pose and r["d_flow"] < tol_flow):
        raise AssertionError(f"{tag} sharded solves {label} outside the "
                             "gates")


def points_ba_against_whole(world, device, n_valid: int = 5,
                            P: int = 768) -> dict:
    """``points_ba`` on the world's ranks on the keyframe's window
    (``bench_problem.ba_problem``: pinhole, W=5, ``P`` points, ``n_valid``
    of 5 slots valid, Config().ba_cg_iters) against the
    whole-solver BA (the BA kernel on the card, the plain BA elsewhere),
    the plain BA and the partitioned BA run in this process as one rank
    (bit for bit: P / n is whole chunks of 64 points). Returns the largest
    pose and observed-copy differences, whether every rank holds the one
    process's bits, rank 0's collectives, bytes, launches and ms beside the
    whole-solver's (host clock, synchronised)."""
    from nrslam_tpu_torch.slam.state import Config
    from nrslam_tpu_torch.solver import bundle_adjustment as ba

    device = torch.device(device)
    cg = Config().ba_cg_iters
    cam, poses0, L0, prob = bench_problem.ba_problem(n_valid=n_valid,
                                                     device=device, P=P)
    outs = world.run("points_ba", *convert.to_numpy((cam, poses0, L0, prob)),
                     5, cg)
    one = ba_points.local_deformable_ba_sharded(
        sharding.Mesh(0, 1, None, device), cam, poses0, L0, prob, 5, cg)
    _sync(device)
    t0 = time.perf_counter()
    whole = ba.local_deformable_ba(cam, poses0, L0, prob, 5, cg)
    _sync(device)
    ms_w = 1e3 * (time.perf_counter() - t0)
    plain = ba.local_deformable_ba_plain(cam, poses0, L0, prob, 5, cg)
    live = prob.kf_valid.cpu().numpy()
    seen = (prob.obs_valid & prob.kf_valid[:, None]).cpu().numpy()
    poses, L, count, nb, launches, ms = outs[0]

    def diff(ref):
        q, q_ref = poses.q[live], ref[0].q.cpu().numpy()[live]
        d_q = np.minimum(np.linalg.norm(q - q_ref, axis=-1),
                         np.linalg.norm(q + q_ref, axis=-1)).max()
        d_t = np.linalg.norm(poses.t - ref[0].t.cpu().numpy(),
                             axis=-1)[live].max()
        d_L = np.linalg.norm(L - ref[1].cpu().numpy(), axis=-1)[seen].max()
        return max(float(d_q), float(d_t)), float(d_L)

    one_np = convert.to_numpy(one)
    return {"whole": diff(whole), "plain": diff(plain),
            "same": all(np.array_equal(o[1], one_np[1])
                        and np.array_equal(o[0].t, one_np[0].t)
                        and np.array_equal(o[0].q, one_np[0].q)
                        for o in outs),
            "count": count, "bytes": nb, "launches": launches, "ms": ms,
            "whole_ms": ms_w, "W": L0.shape[0], "P": L0.shape[1],
            "n_valid": n_valid, "cuda": device.type == "cuda"}


def report_points_ba(tag: str, r: dict, n: int, tol: float):
    """Prints ``points_ba_against_whole``'s readings ``r`` for n ranks as a
    ``tag`` line, and raises AssertionError unless every rank holds the one
    process's bits, the differences from the whole-solver and plain BA
    are below ``tol``, rank 0 made exactly the phase launches of one call
    on the card (``shard_phase_launches``) and none elsewhere, and no
    whole-solver BA launch."""
    from nrslam_tpu_torch.solver import bundle_adjustment_cuda as bac

    got = {k.split(".")[1]: v for k, v in r["launches"].items()
           if k.startswith("bundle_adjustment_shard.")
           and not k.endswith(".calls")}
    want = (bac.shard_phase_launches() if r["cuda"]
            else dict.fromkeys(got, 0))
    print(f"{tag} window BA partitioned over {n} ranks' point blocks, "
          f"pinhole W={r['W']} P={r['P']} {r['n_valid']}/{r['W']} valid: "
          f"against the whole-solver BA pose "
          f"{r['whole'][0]:.3e} copies {r['whole'][1]:.3e}, against plain "
          f"pose {r['plain'][0]:.3e} copies {r['plain'][1]:.3e} (tol "
          f"{tol:.1e}); every rank the bits of one process: {r['same']}; "
          f"rank 0: {r['count']} collectives, {r['bytes']} bytes, "
          f"{r['ms']:.2f} ms (the whole-solver BA in this process "
          f"{r['whole_ms']:.2f} ms); phase launches {got}")
    if not (r["same"] and max(r["whole"] + r["plain"]) < tol
            and got == want and r["launches"]["bundle_adjustment"] == 0):
        raise AssertionError(f"{tag} partitioned window BA outside the "
                             "gates")


# The JAX tests' gates of a sharded frame against one process.
FRAME_GATES = {"dt": 1e-4, "dpos": 1e-3, "agree": 0.98, "dgraph": 1e-3}

# The sharded frame's runs on the card (``chip_smoke.py [parallel]``,
# ``multicard``): P and the keyframe flags of the bench problem's frames.
# The problem starts with one keyframe, so at P=768 the second keyframe
# has a window of 3 valid keyframes and its BA's result is applied. (At
# P=4096 with keyframes at frames 2 and 3 the partitioned solves flip one
# slot's status at frame 3 against the plain drivers, a summation-order
# difference: ``structure_against_one_process`` holds that run's own work
# bit for bit instead, PERF.md §6.)
FRAME_RUNS = ((768, (False, False, True, False, True, False)),
              (4096, (False, False, True)))

# Predicted before the first sharded-frame run on the card (PERF.md §6),
# for 4 ranks, and gated exactly (``report_frames``): rank 0's collective
# payload bytes per frame (non-keyframe, keyframe), the frame's gathers
# plus the partitioned solves' share (``solve_bytes``, ``solve_payloads``:
# their schedule's payloads, tests/torch_parity.py ``solve_floats`` and
# ``ba_floats``). A non-keyframe gathers no ring: the design that gathered
# both rings every frame moved 2,937,696 / 15,658,144 B, 608 P more (the
# rings, K (8 + 1 + 12) + T (8 + 1 + 1 + 12) B a slot) and 48 more (three
# checksum leaves). Peak: each rank's and the single process's
# max_memory_allocated over the frames at P = 4096, MB (printed beside
# the readings, not gated).
PREDICTED = {768: {"bytes": (2_470_704, 6_671_696),
                   "solve_bytes": (2_205_152, 6_289_536),
                   "solve_payloads": (477, 648)},
             4096: {"bytes": (13_167_728, 35_580_160),
                    "solve_bytes": (11_760_672, 33_543_984),
                    "solve_payloads": (477, 648),
                    "rank_peak_mb": (485, 510),
                    "single_peak_mb": (1245, 1260)}}


def _single_frames(device, max_points: int, keyframes):
    """``system.frame_step`` on the seeded problem in this process: (final
    state, n_tracked_3d per frame, ms per frame, on the card (peak
    allocated bytes over the frames, allocated bytes with the problem
    built) else (None, None))."""
    from nrslam_tpu_torch.slam import system

    s, frames, mask, cam, config = bench_problem.build_bench_problem(
        max_points, device=device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        resident = torch.cuda.memory_allocated(device)
    n3d, ms = [], []
    for f, kf in zip(frames, keyframes):
        _sync(device)
        t0 = time.perf_counter()
        s, res = system.frame_step(s, f, mask, cam, config, bool(kf))
        _sync(device)
        ms.append(1e3 * (time.perf_counter() - t0))
        n3d.append(int(res.n_tracked_3d))
    memory = ((torch.cuda.max_memory_allocated(device), resident) if cuda
              else (None, None))
    return s, n3d, ms, memory


@contextlib.contextmanager
def _deterministic():
    """``torch.use_deterministic_algorithms`` on (warnings only where an op
    has no deterministic version), restored afterwards."""
    mode = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*deterministic")
            yield
    finally:
        torch.use_deterministic_algorithms(mode[0], warn_only=mode[1])


@contextlib.contextmanager
def _plain_solves():
    """The pose-only and joint solves and the window BA of this process's
    frames run by their plain drivers (on the card too) instead of the
    whole-solver kernels, ``_deterministic``: on the card the plain
    drivers' ``index_add_`` sums in a different order on every call, which
    moves a point whose chi2 sits at a gate's threshold from one run to the
    next (P=4096: 2 of 3 runs flipped one point, PERF.md §6)."""
    from nrslam_tpu_torch.solver import bundle_adjustment as ba
    from nrslam_tpu_torch.solver import bundle_adjustment_cuda as bac
    from nrslam_tpu_torch.solver import pose_deformation as pd
    from nrslam_tpu_torch.solver import pose_deformation_cuda as pdc
    from nrslam_tpu_torch.solver import pose_only, pose_only_cuda

    swaps = ((pose_only_cuda, "camera_pose_optimization_cuda",
              pose_only.camera_pose_optimization_plain),
             (pdc, "pose_deformation_cuda", pd.pose_deformation_plain),
             (bac, "local_deformable_ba_cuda", ba.local_deformable_ba_plain))
    saved = [getattr(m, name) for m, name, _ in swaps]
    for m, name, plain in swaps:
        setattr(m, name, plain)
    try:
        with _deterministic():
            yield
    finally:
        for (m, name, _), fn in zip(swaps, saved):
            setattr(m, name, fn)


def _differences(got, ref) -> dict:
    """FRAME_GATES' readings of the gathered state ``got`` (numpy) against
    the state ``ref``: the pose, the positions and statuses, and the
    keyframe ring that the window BA writes (validity equal; over the valid
    keyframes the largest pose difference, q up to sign or t, and copy
    difference); and the points whose positions differ by > 1e-3."""
    pos = ref.positions.cpu().numpy()
    live = ref.kf_valid.cpu().numpy()
    q, q_ref = got.kf_pose.q[live], ref.kf_pose.q.cpu().numpy()[live]
    d_q = np.minimum(np.linalg.norm(q - q_ref, axis=-1),
                     np.linalg.norm(q + q_ref, axis=-1))
    d_t = abs(got.kf_pose.t - ref.kf_pose.t.cpu().numpy())[live]
    d_L = abs(got.kf_positions - ref.kf_positions.cpu().numpy())[live]
    return {"dt": float(abs(got.Tcw.t - ref.Tcw.t.cpu().numpy()).max()),
            "dpos": float(abs(got.positions - pos).max()),
            "agree": float(np.mean(got.status == ref.status.cpu().numpy())),
            "kf_valid_equal": bool(np.array_equal(got.kf_valid, live)),
            "dkf_pose": float(max(d_q.max(initial=0.0),
                                  d_t.max(initial=0.0))),
            "dkf_pos": float(d_L.max(initial=0.0)),
            "moved": int(np.sum(np.linalg.norm(got.positions - pos, axis=-1)
                                > 1e-3))}


def frames_against_single(world, device, max_points: int, keyframes,
                          gather_graph: bool) -> dict:
    """``bench_frames`` on the world's ranks against one process on the
    same seeded problem on ``device``: ``system.frame_step`` with the
    pose-only and joint solves and the window BA by the plain drivers
    (every kernel's oracle, ``_plain_solves``; the gates), with the
    whole-solver kernels (``system.frame_step`` as it runs; readings), and
    ``frame_step_sharded`` as one rank (bit for bit).
    Returns the readings (n_tracked_3d, |dTcw.t|, max|dpos|, the share of
    equal statuses, the keyframe ring's validity, poses and copies
    (``_differences``) and the points moved by > 1e-3 against each, the
    number of valid keyframes at the end (the window BA's result is used
    from 3 on: ``ba_applied``), with
    ``gather_graph`` the largest graph difference, launches per rank, ms
    per frame, collective bytes per frame, the partitioned solves' share of
    them and the state gather's, peak allocated bytes per rank and of the
    single process with the kernels) and ``ok``: against the plain drivers
    every gate of ``FRAME_GATES`` (the keyframe ring's poses under "dt",
    its copies under "dpos", its validity equal) and n_tracked_3d equal;
    launches as the
    frames dictate (``frame_launches``: the partitioned pose-only and joint
    phase kernels once a frame and the window BA's once a keyframe, no
    whole-solver kernel) on every rank, equal collective bytes on every
    rank, no payload of ``P * P / n`` elements or more, the ranks'
    frames bit for bit those of the one-rank run
    (``_against_one_process``), and the sharded frame's own work bit for
    bit that of one process (``structure_against_one_process``). The
    partitioned solves sum in another order than one process, so against
    it the gates are tolerances, not bit equality; a point whose chi2 or
    flow sits at a gate's threshold can flip between any two summation
    orders (PERF.md §6: at P=4096 the whole-solver frame flips one point
    against the deterministic plain drivers, which the sharded frame
    matches on ``FRAME_RUNS``' frames)."""
    device = torch.device(device)
    outs = world.run("bench_frames", max_points, keyframes, gather_graph)
    whole, whole_n3d, ms, (peak, resident) = _single_frames(
        device, max_points, keyframes)
    with _plain_solves():
        s, n3d, _, _ = _single_frames(device, max_points, keyframes)
    same = _against_one_process(outs[0], device, max_points, keyframes)
    structure = structure_against_one_process(device, max_points,
                                              keyframes)
    got = outs[0]["state"]
    r = {"n_tracked_3d": outs[0]["n_tracked_3d"], "single_n_tracked_3d": n3d,
         "whole_n_tracked_3d": whole_n3d, "same_as_one_process": same,
         "ba_applied": int(got.kf_valid.sum()) >= 3,
         "structure_exact": structure["exact"],
         **_differences(got, s),
         "whole": _differences(got, whole),
         "launches": [o["launches"] for o in outs],
         "ms": outs[0]["ms"], "single_ms": ms,
         "bytes": [o["bytes"] for o in outs],
         "payloads": outs[0]["payloads"],
         "solve_bytes": outs[0]["solve_bytes"],
         "solve_payloads": outs[0]["solve_payloads"],
         "gather_bytes": outs[0]["gather_bytes"],
         "max_payload": max(max(o["max_payload"]) for o in outs),
         "graph_shapes": outs[0]["graph_shapes"],
         "peak_bytes": [o["peak_bytes"] for o in outs],
         "resident_bytes": [o["resident_bytes"] for o in outs],
         "single_peak_bytes": peak, "single_resident_bytes": resident}
    want = frame_launches(keyframes)
    r["want_launches"] = want
    g = FRAME_GATES
    r["ok"] = (same and structure["exact"] and r["n_tracked_3d"] == n3d
               and r["dt"] <= g["dt"]
               and r["dpos"] <= g["dpos"] and r["agree"] >= g["agree"]
               and r["kf_valid_equal"] and r["dkf_pose"] <= g["dt"]
               and r["dkf_pos"] <= g["dpos"]
               and all(x == want for x in r["launches"])
               and all(b == r["bytes"][0] for b in r["bytes"])
               and r["max_payload"] < max_points * max_points // world.n)
    if gather_graph:
        equal = all(np.array_equal(getattr(got.graph, f),
                                   getattr(s.graph, f).cpu().numpy())
                    for f in ("exists", "bad"))
        r["dgraph"] = max(float(abs(getattr(got.graph, f)
                                    - getattr(s.graph, f).cpu().numpy()
                                    ).max())
                          for f in ("first_distance", "max_distance",
                                    "min_distance", "weight"))
        r["ok"] = r["ok"] and equal and r["dgraph"] <= g["dgraph"]
    return r


def one_rank_frames(device, max_points: int, keyframes):
    """``frame_step_sharded`` on the seeded problem in this process as a
    world of one rank (no process group): (final state as numpy,
    n_tracked_3d and LOST flag per frame)."""
    s, frames, mask, cam, config = bench_problem.build_bench_problem(
        max_points, device=device)
    mesh = sharding.Mesh(0, 1, None, s.positions.device)
    n3d, lost = [], []
    for f, kf in zip(frames, keyframes):
        s, res = frame_step_sharded(mesh, s, f, mask, cam, config, bool(kf))
        n3d.append(int(res.n_tracked_3d))
        lost.append(bool(res.lost))
    return convert.to_numpy(s), n3d, lost


def _same_leaves(got, mine) -> bool:
    """Whether every leaf of the numpy tree ``got`` equals ``mine``'s bit
    for bit."""
    leaves = []

    def pair(a, b):
        leaves.append(np.array_equal(a, b))
        return a

    tree_map(pair, got, mine)
    return all(leaves)


def _against_one_process(out, device, max_points: int, keyframes) -> bool:
    """Whether the ranks' record ``out`` (rank 0's ``_run_frames``) equals,
    bit for bit, ``one_rank_frames``: the same n_tracked_3d and LOST
    flags, and every leaf of the final state that ``out`` holds. The
    partitioned solves sum by chunk of points, so the number of ranks does
    not change a bit."""
    mine, n3d, lost = one_rank_frames(device, max_points, keyframes)
    got = out["state"]
    mine = mine._replace(refs=None)
    if got.graph is None:
        mine = mine._replace(graph=None)
    return (n3d == out["n_tracked_3d"] and lost == out["lost"]
            and _same_leaves(got, mine))


@contextlib.contextmanager
def _whole_solves_in_sharded_frame():
    """``frame_step_sharded`` with ``tracking.WHOLE``'s solves in place of
    the partitioned ones (``solve_shard.mesh_solves``); right on one rank
    only, whose ring columns are all the slots."""
    from nrslam_tpu_torch.slam import tracking

    saved = solve_shard.mesh_solves
    solve_shard.mesh_solves = lambda mesh: tracking.WHOLE
    try:
        yield
    finally:
        solve_shard.mesh_solves = saved


def structure_against_one_process(device, max_points: int,
                                  keyframes) -> dict:
    """The sharded frame's own work (placement, gathers, keyframe ring
    columns, the window BA's write-back and the map refresh) apart from
    its solves: ``frame_step_sharded`` as one rank with the solves of one
    process (``_whole_solves_in_sharded_frame``: the whole-solver kernels
    on the card) against ``system.frame_step``, both ``_deterministic``.
    Returns ``exact`` (every leaf of the final state and n_tracked_3d of
    every frame bit for bit), n_tracked_3d and ``ba_applied`` (a window of
    3 valid keyframes or more at the end)."""
    device = torch.device(device)
    with _deterministic():
        whole, n3d, _, _ = _single_frames(device, max_points, keyframes)
        with _whole_solves_in_sharded_frame():
            mine, mine_n3d, _ = one_rank_frames(device, max_points,
                                                keyframes)
    return {"exact": (mine_n3d == n3d
                      and _same_leaves(mine, convert.to_numpy(whole))),
            "n_tracked_3d": n3d,
            "ba_applied": int(mine.kf_valid.sum()) >= 3, "P": max_points,
            "keyframes": [i + 1 for i, k in enumerate(keyframes) if k]}


def report_structure(tag: str, r: dict):
    """Prints ``structure_against_one_process``'s readings ``r`` as a ``tag``
    line, and raises AssertionError unless the frames are bit for bit
    those of one process and a window BA was applied."""
    print(f"{tag} sharded frame P={r['P']} (keyframes at frames "
          f"{r['keyframes']}) as one rank with one process's solves, "
          f"against system.frame_step: every leaf of the "
          f"state and n_tracked_3d {r['n_tracked_3d']} bit for bit: "
          f"{r['exact']}; window BA applied: {r['ba_applied']}")
    if not (r["exact"] and r["ba_applied"]):
        raise AssertionError(f"{tag} sharded frame P={r['P']}: its own work "
                             "differs from one process")


def ba_against_plain(outs, cam, poses0, L0, prob, plain) -> dict:
    """The keyframe-sharded BA's per-rank results (``kf_sharded_ba``)
    against the plain single-process BA ``plain`` = (poses, L): |dpose|,
    |dL|, the reprojection RMSE over the observed copies before and after,
    ms, and ``ok``: poses <= 2e-4, landmark copies <= 2e-3, RMSE < 0.2x
    its start."""
    poses, L, ms = outs[0]
    t_ref, L_ref = plain[0].t.cpu().numpy(), plain[1].cpu().numpy()
    q, q_ref = poses.q, plain[0].q.cpu().numpy()
    d_q = min(float(np.linalg.norm(q - q_ref)),
              float(np.linalg.norm(q + q_ref)))
    d_pose = max(float(abs(poses.t - t_ref).max()), d_q)
    d_land = float(abs(L - L_ref).max())
    obs_ok = (prob.obs_valid & prob.kf_valid[:, None]).cpu()

    def rmse(q, t, LL):
        dev = cam.params.device
        pred = cameras.project(cam, se3.apply(se3.SE3(
            torch.as_tensor(q, device=dev)[:, None],
            torch.as_tensor(t, device=dev)[:, None]),
            torch.as_tensor(LL, device=dev))).cpu()
        r2 = torch.sum((pred - prob.obs.cpu()) ** 2, -1)[obs_ok]
        return float(torch.sqrt(torch.mean(r2)))

    r0 = rmse(poses0.q.cpu().numpy(), poses0.t.cpu().numpy(),
              L0.cpu().numpy())
    r1 = rmse(poses.q, poses.t, L)
    return {"d_pose": d_pose, "d_land": d_land, "rmse0": r0, "rmse1": r1,
            "ms": ms, "ok": d_pose <= 2e-4 and d_land <= 2e-3
            and r1 < 0.2 * r0}


def report_ba(tag: str, label: str, r: dict, n: int, L0, prob):
    """Prints ``ba_against_plain``'s readings ``r`` for n ranks as a
    ``tag`` line, and raises AssertionError outside its gates."""
    K, P = L0.shape[:2]
    print(f"{tag} {label}: K={K} P={P} E={int(prob.pairs.valid.sum())} "
          f"over {n} ranks: |dpose|={r['d_pose']:.2e} (gate 2e-4) "
          f"|dL|={r['d_land']:.2e} (gate 2e-3) against the plain BA; RMSE "
          f"{r['rmse0']:.4f} -> {r['rmse1']:.4f} px; {r['ms']:.2f} ms")
    if not r["ok"]:
        raise AssertionError(f"{tag} {label} outside the gates")


def _leaf_bytes(tree, axes) -> int:
    """The payload bytes of gathering every leaf of ``tree`` whose ``axes``
    entry is not None (bool travels as uint8)."""
    sizes = []

    def count(x, d):
        if d is not None:
            sizes.append(x.numel() * (1 if x.dtype == torch.bool
                                      else x.element_size()))
        return x

    tree_map(count, tree, axes)
    return sum(sizes)


def whole_gather_frame_bytes(config, image_shape) -> int:
    """Each rank's collective payload bytes for one frame of the sharded
    frame that gathers the whole state (the design before the graph was
    row-sharded), worked out from its gathers: every point-axis leaf of
    the state but the KLT references (``sharding.point_axes``), the six
    [P, P] graph leaves and both rings included, once; then the keypoints
    and statuses after point reuse; then the checksum compare ([2, leaves]
    int64)."""
    from nrslam_tpu_torch.slam import state as state_mod

    full = state_mod.empty_state(config, image_shape, "meta")._replace(
        refs=None)
    leaves = []
    tree_map(lambda x: leaves.append(x), full)
    P = config.max_points
    return (_leaf_bytes(full, sharding.point_axes(full, P))
            + P * (2 * 4 + 4) + 2 * len(leaves) * 8)


def frame_gather_bytes(config, image_shape) -> int:
    """Each rank's payload bytes of the sharded frame's gather of its state
    at the start of every frame (``tracking_shard.gather_axes``: the [P]
    arrays; no ring, graph row or KLT reference): 30 bytes a slot."""
    from nrslam_tpu_torch.slam import state as state_mod

    full = state_mod.empty_state(config, image_shape, "meta")
    return _leaf_bytes(full._replace(refs=None, graph=None),
                       tracking_shard.gather_axes(config, image_shape))


def report_frames(tag: str, card: str, r: dict, max_points: int, keyframes,
                  predicted=None):
    """Prints ``frames_against_single``'s readings ``r`` as ``tag`` lines
    (the frames, the collective bytes beside the whole-state gather's and
    ``predicted``'s, the peak memory on the card), and raises
    AssertionError outside its gates, where a run with two keyframes or
    more did not apply a window BA (the bench problem starts with one
    keyframe, so its second keyframe's window holds 3), or where
    ``predicted`` (a ``PREDICTED`` entry) is given and rank 0's collective
    bytes, or the partitioned solves' bytes or collectives, of a frame
    differ from it."""
    from nrslam_tpu_torch.slam.state import Config

    P, n, mb = max_points, len(r["launches"]), 1e6
    same = r["launches"].count(r["launches"][0]) == n
    pred = predicted or {}
    off = []
    for key, got in (("bytes", r["bytes"][0]),
                     ("solve_bytes", r["solve_bytes"]),
                     ("solve_payloads", r["solve_payloads"])):
        if key in pred:
            want = [pred[key][int(bool(kf))] for kf in keyframes]
            print(f"{tag} P={P} {key} per frame {got}, predicted {want}")
            if list(got) != want:
                off.append(key)
    kf_at = [i + 1 for i, k in enumerate(keyframes) if k]
    graph = (f", graph gathered once at the end: edges and bad flags "
             f"equal, max|d| distances and weights {r['dgraph']:.2e} (gate "
             f"1e-3)" if "dgraph" in r else "")
    w = r["whole"]
    print(f"{tag} sharded frame 640x480 P={P}/256 on {card}, "
          f"{len(keyframes)} frames (keyframe at frame {kf_at}) over {n} "
          f"ranks, against one process with the plain drivers: "
          f"n_tracked_3d {r['n_tracked_3d']} (single process "
          f"{r['single_n_tracked_3d']}), |dTcw.t| {r['dt']:.2e} (gate 1e-4), "
          f"max|dpos| {r['dpos']:.2e} (gate 1e-3), statuses equal on "
          f"{r['agree']:.4f} (gate 0.98){graph}, the keyframe ring: "
          f"validity equal {r['kf_valid_equal']}, poses "
          f"{r['dkf_pose']:.2e} (gate 1e-4), copies {r['dkf_pos']:.2e} "
          f"(gate 1e-3), window BA applied {r['ba_applied']}; positions "
          f"moved by more than 1e-3: {r['moved']}; against one process "
          f"with the "
          f"whole-solver kernels (a reading): n_tracked_3d "
          f"{r['whole_n_tracked_3d']}, |dTcw.t| {w['dt']:.2e}, max|dpos| "
          f"{w['dpos']:.2e}, statuses equal on {w['agree']:.4f}, positions "
          f"moved by more than 1e-3: {w['moved']}; every rank's state "
          f"checksum "
          f"equal to the others' on every frame; the same bits as this "
          f"process running the sharded frame as one rank: "
          f"{r['same_as_one_process']}; its own work with one process's "
          f"solves bit for bit one process's: {r['structure_exact']}; "
          f"launches per rank "
          f"{r['launches'][0]} (all ranks "
          f"{'equal' if same else r['launches']}; wanted "
          f"{r['want_launches']}"
          f"); graph leaves per rank {r['graph_shapes'][-1]}; "
          f"ms/frame sharded {statistics.median(r['ms']):.2f} (frames "
          f"{[round(x, 2) for x in r["ms"]]}), single process with the "
          f"kernels "
          f"{statistics.median(r['single_ms']):.2f} (frames "
          f"{[round(x, 2) for x in r['single_ms']]})")
    whole = whole_gather_frame_bytes(
        Config(max_points=P, max_new_keypoints=256), (480, 640))
    print(f"{tag} P={P} collective payload bytes per frame per rank "
          f"(sharding.traffic): {r['bytes'][0]} ({r['payloads']} payloads, "
          f"largest {r['max_payload']} elements, P*P/n = {P * P // n}); all "
          f"ranks equal: {r['bytes'].count(r['bytes'][0]) == n}; gathering "
          f"the whole state, graph included: {whole} per frame "
          f"({whole / max(r['bytes'][0]):.1f}x)"
          + (f"; predicted (non-keyframe, keyframe) {pred['bytes']}"
             if "bytes" in pred else ""))
    print(f"{tag} P={P} the partitioned solves' share per frame per rank "
          f"(pose-only, joint; window BA on keyframes): collectives "
          f"{r['solve_payloads']}, bytes {r['solve_bytes']}"
          + (f"; predicted (non-keyframe, keyframe) {pred['solve_payloads']}"
             f" collectives, {pred['solve_bytes']} bytes"
             if "solve_bytes" in pred else "")
          + f"; the state gather's {r['gather_bytes'][0]} bytes a frame (no "
          f"ring)")
    if r["peak_bytes"][0] is not None:
        print(f"{tag} P={P} peak allocated over the frames "
              f"(max_memory_allocated) per rank "
              f"{[round(x / mb, 2) for x in r['peak_bytes']]} MB (resident "
              f"state {[round(x / mb, 2) for x in r['resident_bytes']]}), "
              f"single process {r['single_peak_bytes'] / mb:.2f} MB "
              f"(resident {r['single_resident_bytes'] / mb:.2f})"
              + (f"; predicted rank {pred['rank_peak_mb']}, single "
                 f"{pred['single_peak_mb']} MB" if "rank_peak_mb" in pred
                 else ""))
    if off:
        raise AssertionError(f"{tag} P={P} {off} differ from the prediction")
    if sum(map(bool, keyframes)) >= 2 and not r["ba_applied"]:
        raise AssertionError(f"{tag} P={P}: no window BA was applied")
    if not r["ok"]:
        raise AssertionError(f"{tag} sharded frame P={P} outside the gates")


# ---------------------------------------------------------------------------
# The world of spawned ranks
# ---------------------------------------------------------------------------

def _loaded_jax() -> bool:
    return any(m.split(".")[0] in ("jax", "nrslam_tpu") for m in sys.modules)


def rank_device(device, rank: int, backend: str) -> torch.device:
    """Rank r's device: card r on NCCL, else ``device`` as asked."""
    return (torch.device("cuda", rank) if backend == "nccl"
            else torch.device(device))


def _rank_main(rank, n, device, backend, store_path, inbox, outbox):
    torch.set_num_threads(1)
    device = rank_device(device, rank, backend)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    multihost.initialize(backend, n, rank,
                         store=dist.FileStore(store_path, n))
    mesh = sharding.make_mesh(device)
    try:
        while True:
            msg = inbox.get()
            if msg is None:
                break
            name, args = msg
            try:
                out = TASKS[name](mesh, *args)
            except BaseException:
                outbox.put((rank, False, traceback.format_exc(), None))
                break
            outbox.put((rank, True, out, _loaded_jax()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class World:
    """n spawned ranks in one process group (see the module's doc)."""

    def __init__(self, n: int, device=None, store_dir=None,
                 backend: str = "gloo"):
        if n < 2:
            raise ValueError("a World spawns at least two ranks")
        device = resolve(device)
        if backend == "nccl" and torch.cuda.device_count() < n:
            raise ValueError(f"NCCL needs a card per rank: {n} ranks, "
                             f"{torch.cuda.device_count()} cards visible")
        ctx = mp.get_context("spawn")
        self.n = n
        self._tmp = tempfile.TemporaryDirectory(dir=store_dir)
        store_path = os.path.join(self._tmp.name, "store")
        self._outbox = ctx.Queue()
        self._inboxes = [ctx.Queue() for _ in range(n)]
        self._procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(r, n, str(device), backend, store_path, self._inboxes[r],
                  self._outbox)) for r in range(n)]
        for p in self._procs:
            p.start()
        self.loaded_jax = False

    def run(self, name: str, *args):
        """``TASKS[name](mesh, *args)`` on every rank; their results in rank
        order."""
        for q in self._inboxes:
            q.put((name, args))
        results = {}
        while len(results) < self.n:
            try:
                rank, ok, out, jax_seen = self._outbox.get(
                    timeout=TIMEOUT_S)
            except queue.Empty:
                self.close()
                raise TimeoutError(f"{name}: no answer from every rank in "
                                   f"{TIMEOUT_S} s")
            if not ok:
                self.close()
                raise RuntimeError(f"{name} failed on rank {rank}:\n{out}")
            results[rank] = out
            self.loaded_jax |= jax_seen
        return [results[r] for r in range(self.n)]

    def close(self):
        for q, p in zip(self._inboxes, self._procs):
            if p.is_alive():
                q.put(None)
        for p in self._procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        self._tmp.cleanup()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def dryrun_multichip(n: int, device=None) -> dict:
    """Spawn n ranks on ``device`` (the card unless told otherwise) and run
    ``dryrun`` on each. Returns rank 0's record; raises if any rank
    failed."""
    with World(n, device) as world:
        out = world.run("dryrun")
    if world.loaded_jax:
        raise AssertionError("a rank imported JAX")
    return out[0]
