"""Spawned ranks for sharded runs, and the multi-rank dry run (the
counterpart of ``__graft_entry__.dryrun_multichip``).

``World(n, device)`` spawns n rank processes (the ``spawn`` start method;
they import the port and torch, nothing else of the repo) on one device
(the card unless the caller passes another, ``utils.device``),
joined in one gloo process group (NCCL refuses several ranks on one card)
through a ``FileStore`` in a fresh directory, each with one CPU thread,
and keeps them for as many ``run`` calls as the caller makes:
``run(task, *args)`` runs ``TASKS[task](mesh, *args)`` on every rank and
returns each rank's result. Arguments and results are numpy
trees (``convert.to_numpy`` of port structures). A rank that fails ends
the world and its traceback is raised in the caller.

``dryrun_multichip(n, device)`` spawns n ranks and runs, on each, the
sharded non-keyframe (tracking and mapping), a keyframe with its BA, the
sharded pose normal equations and the keyframe-sharded BA at K = n.
"""

from __future__ import annotations

import os
import queue
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from nrslam_tpu_torch import convert
from nrslam_tpu_torch.geometry import cameras, se3
from nrslam_tpu_torch.parallel import ba_shard, multihost, sharding
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
    from nrslam_tpu_torch.solver import bundle_adjustment_cuda as bac
    from nrslam_tpu_torch.solver import pose_deformation_cuda as pdc
    from nrslam_tpu_torch.solver import pose_only_cuda

    return {"pose_only": pose_only_cuda.launches,
            "pose_deformation": pdc.launches,
            "bundle_adjustment": bac.launches}


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


@task
def sharded_frames(mesh, state, frames, mask, cam, config, keyframes):
    """``frame_step_sharded`` over ``frames`` from the whole ``state``
    (each rank feeds every frame; ``keyframes`` flags them). Returns the
    whole final state as this rank holds it after a gather, the frames'
    n_tracked_3d and LOST flags, ms per frame and the kernel launches."""
    from nrslam_tpu_torch.parallel.tracking_shard import state_axes

    cam = to_device(cam, mesh.device)
    mask = multihost.replicate_frame(mesh, mask)
    local = sharding.shard_state(to_device(state, mesh.device), mesh,
                                 config.max_points)
    before = _launch_counts()
    n3d, lost, ms = [], [], []
    for frame, kf in zip(frames, keyframes):
        gray = multihost.replicate_frame(mesh, frame)
        _sync(mesh.device)
        t0 = time.perf_counter()
        local, res = frame_step_sharded(mesh, local, gray, mask, cam, config,
                                        bool(kf))
        _sync(mesh.device)
        ms.append(1e3 * (time.perf_counter() - t0))
        n3d.append(int(res.n_tracked_3d))
        lost.append(bool(res.lost))
    launches = {k: v - before[k] for k, v in _launch_counts().items()}
    full = sharding.unshard_state(local, mesh,
                                  state_axes(config, tuple(mask.shape)))
    return {"state": convert.to_numpy(full), "n_tracked_3d": n3d,
            "lost": lost, "ms": ms, "launches": launches}


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
    local = sharding.shard_state(state, mesh, P)
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
# The world of spawned ranks
# ---------------------------------------------------------------------------

def _loaded_jax() -> bool:
    return any(m.split(".")[0] in ("jax", "nrslam_tpu") for m in sys.modules)


def _rank_main(rank, n, device, store_path, inbox, outbox):
    torch.set_num_threads(1)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    multihost.initialize("gloo", n, rank, store=dist.FileStore(store_path, n))
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

    def __init__(self, n: int, device=None, store_dir=None):
        if n < 2:
            raise ValueError("a World spawns at least two ranks")
        device = resolve(device)
        ctx = mp.get_context("spawn")
        self.n = n
        self._tmp = tempfile.TemporaryDirectory(dir=store_dir)
        store_path = os.path.join(self._tmp.name, "store")
        self._outbox = ctx.Queue()
        self._inboxes = [ctx.Queue() for _ in range(n)]
        self._procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(r, n, str(device), store_path, self._inboxes[r],
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
