"""The keyframe window BA partitioned over ranks' point blocks
(``nrslam_tpu_torch.parallel.ba_points``), on the CPU: its plain route on 1
(one process, no group), 2 and 4 gloo ranks (``dryrun.World``, spawned once
each for the module; the ranks never import JAX, checked) against

- the JAX package's ``bundle_adjustment.local_deformable_ba`` on one
  device and on a window partitioned by XLA over a ``pt`` mesh of n
  virtual CPU devices (the ``[W, P, ...]`` copies and observations placed
  with ``NamedSharding(mesh, P(None, "pt", ...))``, as
  ``nrslam_tpu.parallel.sharding.shard_state`` places the keyframe ring),
  at tests/test_torch_bundle_adjustment_kernel.py's tolerance: 1e-3 on
  pose and every observed copy; on a window with invalid keyframe slots in
  the Pallas configuration the port follows (``torch_parity.jax_pallas_
  ba``);
- the port's single-process plain BA at the card's same-device gate (3e-5):
  the same float32 math summed in another order;
- itself on 1, 2 and 4 ranks, bit for bit (sums by chunk of 64 points, so
  at P = 256 every rank's block is whole chunks).

Also a rank that owns no observed copy, an edge table whose edges cross
every rank boundary, and the phase-launch schedule and collectives of the
card route (held to these drivers by chip_smoke.py). Windows are W = 5 of
P = 64 points (P = 256 for the bit check).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec

from nrslam_tpu.geometry import cameras as jcam
from nrslam_tpu.geometry import se3 as jse3
from nrslam_tpu.solver import bundle_adjustment as jba
from nrslam_tpu.solver import pose_deformation as jpd
from nrslam_tpu_torch import bench_problem, convert
from nrslam_tpu_torch.parallel import ba_points, dryrun, sharding
from nrslam_tpu_torch.solver import bundle_adjustment as tba
from nrslam_tpu_torch.solver import pose_deformation as tpd

from torch_parity import ba_floats, jax_pallas_ba, quat_err

torch.set_num_threads(1)

P_PTS, W = 64, 5
CG = 16
TOL, SAME = 1e-3, 3e-5
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


def _problem(kind="pinhole", n_valid=W, P=P_PTS):
    """``bench_problem.ba_problem`` on the CPU (a sideways sweep over a
    deforming map, ~25% of copies unobserved, noisy seeds, a K=11 kNN pair
    table) as numpy: (cam, poses0, L0, problem)."""
    return convert.to_numpy(bench_problem.ba_problem(
        kind, n_valid, device="cpu", K=W, P=P))


def _jax_cam(cam):
    p = [float(x) for x in cam.params]
    return jcam.pinhole(*p) if cam.kind == "pinhole" \
        else jcam.kannala_brandt8(*p)


@functools.lru_cache(maxsize=None)
def _jit(fn):
    return jax.jit(fn, static_argnames=("n_iters", "cg_iters"))


def _jax_ba(prob, n_devices=None):
    """The JAX package's BA on one device, or partitioned over a ``pt``
    mesh of ``n_devices`` virtual CPU devices."""
    cam, poses0, L0, p = prob

    def put(x, spec=None):
        x = jnp.asarray(x)
        if n_devices is None or spec is None:
            return x
        mesh = JMesh(np.array(jax.devices("cpu")[:n_devices]), ("pt",))
        return jax.device_put(x, NamedSharding(mesh, spec))

    pt3 = PartitionSpec(None, "pt", None)
    problem = jba.BAProblem(
        obs=put(p.obs, pt3), obs_valid=put(p.obs_valid,
                                           PartitionSpec(None, "pt")),
        kf_valid=put(p.kf_valid),
        pairs=jpd.PairEdges(put(p.pairs.i.astype(np.int32)),
                            put(p.pairs.j.astype(np.int32)),
                            put(p.pairs.w), put(p.pairs.d0),
                            put(p.pairs.valid)),
        scale=put(p.scale))
    out = _jit(jba.local_deformable_ba)(
        _jax_cam(cam), jse3.SE3(put(poses0.q), put(poses0.t)), put(L0, pt3),
        problem, n_iters=5, cg_iters=CG)
    return jax.device_get(out)


def _sharded(worlds, n, prob):
    """The port's partitioned BA on n ranks (n = 1: this process, no
    group); rank 0's (poses, copies, collectives, bytes, launches), after
    checking every rank returned the same bits."""
    if n == 1:
        cam, poses0, L0, p = dryrun.to_device(prob, "cpu")
        poses, L = ba_points.local_deformable_ba_sharded(
            sharding.make_mesh("cpu"), cam, poses0, L0, p, 5, CG)
        return convert.to_numpy((poses, L)) + (0, 0, {})
    outs = worlds[n].run("points_ba", *prob, 5, CG)
    for o in outs[1:]:
        for a, b in zip(o[:2], outs[0][:2]):
            jax.tree_util.tree_map(np.testing.assert_array_equal, a, b)
    return outs[0][:5]


def _single(prob):
    """The port's single-process plain BA: (poses, copies)."""
    cam, poses0, L0, p = dryrun.to_device(prob, "cpu")
    return convert.to_numpy(tba.local_deformable_ba_plain(cam, poses0, L0, p,
                                                          5, CG))


def _diff(poses, L, ref_poses, ref_L, prob):
    """max(|dq|, |dt|) over the valid keyframes and max |dL| over the
    observed copies."""
    p = prob[3]
    live = np.asarray(p.kf_valid)
    seen = np.asarray(p.obs_valid) & live[:, None]
    dq = max(quat_err(np.asarray(poses.q)[k], np.asarray(ref_poses.q)[k])
             for k in np.nonzero(live)[0])
    dt = np.linalg.norm(np.asarray(poses.t) - np.asarray(ref_poses.t),
                        axis=-1)[live].max()
    dL = np.linalg.norm(np.asarray(L) - np.asarray(ref_L), axis=-1)[seen]
    return max(float(dq), float(dt)), float(dL.max())


def _assert_unobserved_unchanged(L, prob):
    p = prob[3]
    unseen = ~(np.asarray(p.obs_valid) & np.asarray(p.kf_valid)[:, None])
    np.testing.assert_array_equal(np.asarray(L)[unseen], prob[2][unseen])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", (1, 2, 4))
def test_points_ba_matches_jax(worlds, n, kind):
    """Against the JAX BA on one device and partitioned over n virtual
    devices, 1e-3; it moved the copies by far more than that."""
    prob = _problem(kind)
    refs = [_jax_ba(prob)]
    if n > 1:
        refs.append(_jax_ba(prob, n))
    poses, L, _, _, _ = _sharded(worlds, n, prob)
    for ref_poses, ref_L in refs:
        d_pose, d_L = _diff(poses, L, ref_poses, ref_L, prob)
        assert d_pose < TOL and d_L < TOL, (d_pose, d_L)
    assert np.abs(L - prob[2]).max() > 10 * TOL
    _assert_unobserved_unchanged(L, prob)


@pytest.mark.parametrize("n", (1, 2, 4))
def test_points_ba_matches_single_process(worlds, n):
    """The same-device gate against the port's single-process plain BA."""
    prob = _problem("kb8")
    ref_poses, ref_L = _single(prob)
    poses, L, _, _, _ = _sharded(worlds, n, prob)
    d_pose, d_L = _diff(poses, L, ref_poses, ref_L, prob)
    assert d_pose < SAME and d_L < SAME, (d_pose, d_L)


def test_points_ba_same_bits_on_1_2_4_ranks(worlds):
    """At P = 256 every rank's block is whole chunks of 64 points: 2 and 4
    ranks give the bits of one process."""
    prob = _problem("pinhole", P=256)
    one = _sharded(worlds, 1, prob)
    for n in (2, 4):
        got = _sharded(worlds, n, prob)
        np.testing.assert_array_equal(got[1], one[1])
        np.testing.assert_array_equal(got[0].q, one[0].q)
        np.testing.assert_array_equal(got[0].t, one[0].t)


@pytest.mark.parametrize("n", (1, 4))
def test_points_ba_invalid_keyframe_slots(worlds, n):
    """Two of five slots invalid (zero copies at the identity pose, as
    after ``bootstrap_map``): against the JAX BA in its Pallas
    configuration, which the port follows there, and the single-process
    plain BA; the invalid slots come back unchanged."""
    prob = _problem("pinhole", n_valid=3)
    with jax_pallas_ba():
        ref_poses, ref_L = _jax_ba(prob)
    poses, L, _, _, _ = _sharded(worlds, n, prob)
    d_pose, d_L = _diff(poses, L, ref_poses, ref_L, prob)
    assert d_pose < TOL and d_L < TOL, (d_pose, d_L)
    d_pose, d_L = _diff(poses, L, *_single(prob), prob)
    assert d_pose < SAME and d_L < SAME, (d_pose, d_L)
    assert np.all(np.isfinite(L))
    np.testing.assert_array_equal(L[:2], prob[2][:2])


def test_rank_without_observed_copy(worlds):
    """Rank 1 of 4 owns no observed copy (its block masked in every
    keyframe): its partial sums are zeros, its edges dead; the ranks still
    agree with one process and its copies come back unchanged."""
    cam, poses0, L0, p = _problem("pinhole")
    b = sharding.rank_block(sharding.Mesh(1, 4, None, "cpu"), P_PTS)
    obs_valid = p.obs_valid.copy()
    obs_valid[:, b] = False
    prob = (cam, poses0, L0, p._replace(obs_valid=obs_valid))
    poses, L, _, _, _ = _sharded(worlds, 4, prob)
    d_pose, d_L = _diff(poses, L, *_single(prob), prob)
    assert d_pose < SAME and d_L < SAME, (d_pose, d_L)
    np.testing.assert_array_equal(L[:, b], L0[:, b])
    assert np.all(np.isfinite(L))


def test_edges_cross_every_rank_boundary(worlds):
    """A pair table of a chain through every slot (p, p + 1), edges to the
    mirrored slot (p, P - 1 - p) and to the next rank's slot (p, p + m):
    every pair of neighbouring blocks is joined, so every rank reads copies
    and search directions of the others and holds ends of edges whose
    other end is elsewhere; against one process."""
    cam, poses0, L0, p = _problem("kb8")
    P, m = P_PTS, P_PTS // 4
    q = np.arange(P)
    nbr = np.stack([(q + 1) % P, P - 1 - q, (q + m) % P], -1)
    d0 = np.linalg.norm(L0[0][:, None] - L0[0][nbr], axis=-1).astype(
        np.float32)
    w = np.exp(-d0 ** 2 / (2 * (3 * np.median(d0)) ** 2)).astype(np.float32)
    pairs = convert.to_numpy(tpd.pairs_from_neighbors(
        torch.as_tensor(nbr), torch.as_tensor(w), torch.as_tensor(d0),
        torch.ones(nbr.shape, dtype=torch.bool)))
    blk_i, blk_j = pairs.i[pairs.valid] // m, pairs.j[pairs.valid] // m
    crossing = {(min(a, b), max(a, b)) for a, b in zip(blk_i, blk_j)
                if a != b}
    assert {(r, r + 1) for r in range(3)} <= crossing
    prob = (cam, poses0, L0, p._replace(pairs=pairs))
    poses, L, _, _, _ = _sharded(worlds, 4, prob)
    d_pose, d_L = _diff(poses, L, *_single(prob), prob)
    assert d_pose < SAME and d_L < SAME, (d_pose, d_L)


def test_phase_launch_schedule_and_collectives(worlds):
    """The card route's launches per call (one init; a first and, per LM
    step, a trial linearisation and step; one hv and one cg launch per CG
    trip: 5 x 16), as the frame's launch gate counts them a keyframe; and
    the collectives and payload bytes of a call on 2 and 4 ranks, which
    both routes make alike."""
    from nrslam_tpu_torch.solver import bundle_adjustment_cuda as bac

    assert bac.shard_phase_launches() == {"init": 1, "lin": 6, "step": 6,
                                          "hv": 80, "cg": 80}
    want = dryrun.frame_launches([False, True])
    assert want["bundle_adjustment"] == 0
    assert want["bundle_adjustment_shard.calls"] == 1
    assert want["bundle_adjustment_shard.hv"] == 80
    prob = _problem("pinhole")
    for n in (2, 4):
        _, _, count, nbytes, launches = _sharded(worlds, n, prob)
        want_count, floats = ba_floats(W, P_PTS, n, cg_iters=CG)
        assert (count, nbytes) == (want_count, 4 * floats)
        assert not any(launches.values())   # CPU tensors: the plain route
    assert ba_floats(W, 768, 4, cg_iters=CG)[0] == 171


def test_kernel_route_raises_on_cpu_tensors():
    """The phase kernels take CUDA tensors only."""
    from nrslam_tpu_torch.solver import bundle_adjustment_cuda as bac

    cam, poses0, L0, p = dryrun.to_device(_problem("pinhole"), "cpu")
    obs_ok, spring, damper = tba._masks(p._replace(pairs=p.pairs._replace(
        i=p.pairs.i.long(), j=p.pairs.j.long())))
    with pytest.raises(ValueError, match="CUDA"):
        bac.shard(cam, poses0, L0, p.obs, obs_ok, p.pairs, spring, damper,
                  1.0, 5, CG, slice(0, P_PTS), 0, 1,
                  functools.partial(sharding.all_reduce_,
                                    sharding.make_mesh("cpu")))


def test_report_gates_the_launches_by_device():
    """``dryrun.report_points_ba`` decides from the device, not from the
    launches it checks, whether the phase kernels had to run: a run on the
    card that launched nothing (the plain route taken silently) fails, as
    does one with a phase launch too many; on the CPU none may launch."""
    from nrslam_tpu_torch.solver import bundle_adjustment_cuda as bac

    none = dict.fromkeys(dryrun._launch_counts(), 0)
    card = dict(none, **{f"bundle_adjustment_shard.{k}": v
                         for k, v in bac.shard_phase_launches().items()})
    r = {"whole": (1e-6, 1e-6), "plain": (1e-6, 1e-6), "same": True,
         "count": 171, "bytes": 0, "ms": 1.0, "whole_ms": 1.0, "W": W,
         "P": P_PTS, "n_valid": W}
    dryrun.report_points_ba("[t]", dict(r, cuda=False, launches=none), 4,
                            SAME)
    dryrun.report_points_ba("[t]", dict(r, cuda=True, launches=card), 4,
                            SAME)
    extra = dict(card, **{"bundle_adjustment_shard.hv":
                          card["bundle_adjustment_shard.hv"] + 1})
    for cuda, launches in ((True, none), (False, card), (True, extra)):
        with pytest.raises(AssertionError):
            dryrun.report_points_ba("[t]", dict(r, cuda=cuda,
                                                launches=launches), 4, SAME)
