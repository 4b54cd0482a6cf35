"""The pose-only and joint solves partitioned over ranks
(``nrslam_tpu_torch.parallel.solve_shard``), on the CPU: their plain route
on 1 (one process, no group), 2 and 4 gloo ranks (``dryrun.World``, spawned
once each for the module) against

- the JAX package's solves on one device (``pose_only.camera_pose_
  optimization`` at ``test_torch_pose_only.TOL`` = 1e-4; ``pose_
  deformation.pose_deformation_optimization`` at ``test_torch_pose_
  deformation._assert_parity``'s pose 2e-3, median flow 5e-3, inlier flips
  < 3%);
- the same JAX solves partitioned by XLA over a ``pt`` mesh of n virtual
  CPU devices (the points placed with ``NamedSharding(mesh, P("pt"))``, as
  ``nrslam_tpu.parallel.sharding.shard_state`` places a state), at the
  same tolerances;
- the port's single-process plain drivers on the rigid scene, at the
  card's same-device gates (pose 1e-5, per-point flow 2e-4): the same
  float32 math summed in another order.

Also: a rank whose block holds no valid point, an edge table whose edges
cross every rank boundary, and the rank's restriction of the incidence CSR
(``sharding.rank_ends``). The ranks never import JAX (checked). The phase
kernels of the card route are held to these drivers by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec

from nrslam_tpu.geometry import cameras as jcam
from nrslam_tpu.geometry import se3 as jse3
from nrslam_tpu.solver import pose_deformation as jpd
from nrslam_tpu.solver import pose_only as jpo
from nrslam_tpu_torch import bench_problem, convert
from nrslam_tpu_torch.parallel import dryrun, sharding, solve_shard
from nrslam_tpu_torch.solver import pose_deformation as tpd
from nrslam_tpu_torch.solver import pose_only as tpo

from test_torch_pose_deformation import _assert_parity
from test_torch_pose_only import TOL
from torch_parity import quat_err

torch.set_num_threads(1)

P_PTS = 96
SAME_POSE, SAME_FLOW = 1e-5, 2e-4
KINDS = ("pinhole", "kb8")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = {}
    try:
        for n in (2, 4):
            out[n] = dryrun.World(n, "cpu",
                                  store_dir=tmp_path_factory.mktemp("store"))
        yield out
    finally:
        for w in out.values():
            w.close()
    assert not any(w.loaded_jax for w in out.values())


def _problem(kind, deform_amp=0.05, P=P_PTS):
    """``bench_problem.solver_problem`` on the CPU (K=11 neighbours, 5%
    outliers, 10% masked) as numpy."""
    cam, T0, X, obs, valid, pairs = bench_problem.solver_problem(
        kind, device="cpu", P=P, deform_amp=deform_amp)
    return convert.to_numpy((cam, T0, X, obs, valid, pairs))


def _jax_cam(cam):
    p = [float(x) for x in cam.params]
    return jcam.pinhole(*p) if cam.kind == "pinhole" \
        else jcam.kannala_brandt8(*p)


def _jax_pairs(pairs):
    return jpd.PairEdges(jnp.asarray(pairs.i, jnp.int32),
                         jnp.asarray(pairs.j, jnp.int32),
                         jnp.asarray(pairs.w), jnp.asarray(pairs.d0),
                         jnp.asarray(pairs.valid))


_JAX_POSE = jax.jit(jpo.camera_pose_optimization)
_JAX_JOINT = jax.jit(jpd.pose_deformation_optimization)


def _jax_solves(prob, n_devices=None):
    """(pose-only SE3, the joint's result from that pose) of the JAX
    package, on one device or partitioned over a ``pt`` mesh of
    ``n_devices`` virtual CPU devices."""
    cam, T0, X, obs, valid, pairs = prob
    put = jnp.asarray
    if n_devices is not None:
        mesh = JMesh(np.array(jax.devices("cpu")[:n_devices]), ("pt",))

        def put(x):
            return jax.device_put(jnp.asarray(x),
                                  NamedSharding(mesh, PartitionSpec("pt")))
    jc = _jax_cam(cam)
    Xj, oj, vj = put(X), put(obs), put(valid)
    T = _JAX_POSE(jc, jse3.SE3(jnp.asarray(T0.q), jnp.asarray(T0.t)), Xj,
                  oj, vj)
    res = _JAX_JOINT(jc, T, Xj, oj, vj, _jax_pairs(pairs), 1.0)
    return jax.device_get(T), jax.device_get(res)


def _sharded(worlds, n, prob):
    """The port's sharded solves on n ranks (n = 1: this process, no
    group); rank 0's (pose SE3, joint result, collectives, bytes), after
    checking every rank returned the same bits."""
    if n == 1:
        cam, T0, X, obs, valid, pairs = dryrun.to_device(prob, "cpu")
        solves = solve_shard.mesh_solves(sharding.make_mesh("cpu"))
        T = solves.pose_only(cam, T0, X, obs, valid)
        res = solves.joint(cam, T, X, obs, valid, pairs, 1.0)
        return convert.to_numpy((T, res)) + (0, 0)
    outs = worlds[n].run("sharded_solves", *prob, 1.0)
    for o in outs[1:]:
        for a, b in zip(convert.to_numpy(o[:2]), outs[0][:2]):
            jax.tree_util.tree_map(np.testing.assert_array_equal, a, b)
    return outs[0][:4]


def _single(prob):
    """The port's single-process plain drivers: (pose, joint result)."""
    cam, T0, X, obs, valid, pairs = dryrun.to_device(prob, "cpu")
    T = tpo.camera_pose_optimization_plain(cam, T0, X, obs, valid)
    return T, tpd.pose_deformation_optimization(cam, T, X, obs, valid, pairs,
                                                1.0)


def _assert_pose(T, ref, tol):
    assert quat_err(np.asarray(T.q), np.asarray(ref.q)) < tol
    assert np.linalg.norm(np.asarray(T.t) - np.asarray(ref.t)) < tol


def _assert_same_device(T, res, T_ref, res_ref, valid):
    """The same-device gates: pose 1e-5, every valid point's flow 2e-4."""
    _assert_pose(T, T_ref, SAME_POSE)
    _assert_pose(res.Tcw, res_ref.Tcw, SAME_POSE)
    d = np.linalg.norm(np.asarray(res.flows) - np.asarray(res_ref.flows),
                       axis=-1)[valid]
    assert d.max() < SAME_FLOW, d.max()
    np.testing.assert_array_equal(np.asarray(res.reproj_inlier),
                                  np.asarray(res_ref.reproj_inlier))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", (1, 2, 4))
def test_sharded_solves_match_jax(worlds, n, kind):
    """Against the JAX solves on one device and partitioned over n virtual
    devices; the joint from the JAX pose-only's pose on both sides."""
    prob = _problem(kind)
    valid = prob[4]
    refs = [_jax_solves(prob)]
    if n > 1:
        refs.append(_jax_solves(prob, n))
    T, res, count, _ = _sharded(worlds, n, prob)
    for T_j, res_j in refs:
        _assert_pose(T, T_j, TOL)
        _assert_parity(res_j.Tcw.q, res_j.Tcw.t, res_j.flows,
                       res_j.reproj_inlier, res.Tcw.q, res.Tcw.t, res.flows,
                       res.reproj_inlier, valid)
        assert np.mean(np.asarray(res_j.deform_ok) != res.deform_ok) < 0.03
    assert count == (0 if n == 1 else 477)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", (1, 2, 4))
def test_sharded_solves_match_single_process_rigid(worlds, n, kind):
    """On the rigid scene, the same-device gates against the port's
    single-process plain drivers."""
    prob = _problem(kind, deform_amp=0.0)
    T_ref, res_ref = _single(prob)
    T, res, _, _ = _sharded(worlds, n, prob)
    _assert_same_device(T, res, T_ref, res_ref, prob[4])


def test_rank_without_valid_points(worlds):
    """Rank 1 of 4 owns no valid point (its block masked): its partial sums
    are zeros, its edges dead; the ranks still agree with one process."""
    cam, T0, X, obs, valid, pairs = _problem("pinhole", deform_amp=0.0)
    b = sharding.rank_block(sharding.Mesh(1, 4, None, "cpu"), P_PTS)
    valid = valid.copy()
    valid[b] = False
    prob = (cam, T0, X, obs, valid, pairs)
    T_ref, res_ref = _single(prob)
    T, res, _, _ = _sharded(worlds, 4, prob)
    _assert_same_device(T, res, T_ref, res_ref, valid)
    assert not res.reproj_inlier[b].any()
    assert np.all(np.isfinite(res.flows))


def test_edges_cross_every_rank_boundary(worlds):
    """An edge table of a chain through every slot (p, p + 1), edges to the
    mirrored slot (p, P - 1 - p) and to the next rank's slot (p, p + m):
    every pair of neighbouring blocks is joined, so every rank reads flows
    and search directions of the others; against one process."""
    cam, T0, X, obs, valid, _ = _problem("kb8", deform_amp=0.0)
    P, m = P_PTS, P_PTS // 4
    p = np.arange(P)
    nbr = np.stack([(p + 1) % P, P - 1 - p, (p + m) % P], -1)
    d0 = np.linalg.norm(X[:, None] - X[nbr], axis=-1).astype(np.float32)
    w = np.exp(-d0 ** 2 / (2 * (3 * np.median(d0)) ** 2)).astype(np.float32)
    pairs = convert.to_numpy(tpd.pairs_from_neighbors(
        torch.as_tensor(nbr), torch.as_tensor(w), torch.as_tensor(d0),
        torch.ones(nbr.shape, dtype=torch.bool)))
    live = pairs.valid & valid[pairs.i] & valid[pairs.j]
    blk_i, blk_j = pairs.i[live] // m, pairs.j[live] // m
    crossing = {(min(a, b), max(a, b)) for a, b in zip(blk_i, blk_j) if a != b}
    assert {(r, r + 1) for r in range(3)} <= crossing
    prob = (cam, T0, X, obs, valid, pairs)
    T_ref, res_ref = _single(prob)
    T, res, _, _ = _sharded(worlds, 4, prob)
    _assert_same_device(T, res, T_ref, res_ref, valid)


@pytest.mark.parametrize("n", (1, 2, 3, 4))
def test_rank_ends_restrict_the_csr(n):
    """``sharding.rank_ends``: rank r's positions [ptr[0], ptr[m]) list, for
    each of its points in order, that point's live incident edges in edge
    order with sign +1 at the edge's i and -1 at its j; over the ranks
    every live edge appears exactly twice (once at each end) and no dead
    edge appears (P = 96, or 93 edges' worth of slots for 3 ranks)."""
    _, _, _, _, valid, pairs = bench_problem.solver_problem(device="cpu",
                                                            P=P_PTS)
    pairs = tpd.compact_pairs(pairs, P_PTS, valid)
    P = P_PTS - P_PTS % n
    i, j = pairs.i.long(), pairs.j.long()
    keep = (i < P) & (j < P)
    i, j = i[keep], j[keep]
    live = (pairs.valid & valid[pairs.i] & valid[pairs.j])[keep]
    seen = torch.zeros(i.shape[0], dtype=torch.int64)
    for r in range(n):
        mesh = sharding.Mesh(r, n, None, "cpu")
        b = sharding.rank_block(mesh, P)
        ptr, edge, sign = sharding.rank_ends(mesh, i, j, live, P)
        assert ptr.shape[0] == b.stop - b.start + 1
        for lp, p in enumerate(range(b.start, b.stop)):
            k0, k1 = int(ptr[lp]), int(ptr[lp + 1])
            e = edge[k0:k1].long()
            assert torch.equal(e, torch.nonzero(live & ((i == p) | (j == p)))
                               [:, 0])
            assert torch.equal(sign[k0:k1],
                               torch.where(i[e] == p, 1.0, -1.0))
            seen[e] += 1
    assert torch.equal(seen, 2 * live.to(torch.int64))


def test_phase_launch_schedule():
    """The card route's launches per call, as the frame's launch gate
    (``dryrun.frame_launches``) counts them: pose-only one partials and one
    step launch per evaluation (3 rounds x (1 + 10)), a re-level between
    rounds; the joint one init, per round a first linearisation and step,
    per LM step a trial linearisation and step and per CG trip one hv and
    one cg launch (2 x 10 x 10)."""
    from nrslam_tpu_torch.solver import pose_deformation_cuda as pdc
    from nrslam_tpu_torch.solver import pose_only_cuda as poc

    assert poc.shard_phase_launches() == {"partials": 33, "step": 33,
                                          "relevel": 2}
    assert pdc.shard_phase_launches() == {"init": 1, "lin": 22, "step": 22,
                                          "hv": 200, "cg": 200}
    want = dryrun.frame_launches([False, True])
    assert want["pose_only"] == want["pose_deformation"] == 0
    assert want["bundle_adjustment"] == 1
    assert want["pose_deformation_shard.cg"] == 400
    assert want["pose_only_shard.calls"] == 2
