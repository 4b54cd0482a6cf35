"""Port parity of ``nrslam_tpu_torch.parallel`` against the JAX package's
``nrslam_tpu.parallel`` (the five tests of tests/test_parallel.py), on the
CPU: four ranks spawned once for the module (``dryrun.World``: gloo over a
``FileStore`` in a temporary directory, the spawn start method, one thread
each) run the port's sharded code on numpy inputs; the JAX references are
computed here, in the process that has the 8 virtual devices, and the ranks
never import JAX (checked).

The JAX package's keyframe BA runs in its Pallas configuration for the
whole module (``torch_parity.pallas_ba_reference``), which the port
follows on windows with invalid keyframe slots and which is the op-level
BA's math on a window without them.

Tolerances are the JAX tests': the sharded frame against the JAX
single-device frame n_tracked_3d equal, Tcw.t 1e-4, positions 1e-3 and
statuses equal on >= 98% of slots, also over a keyframe with its BA (and
there against the port's single-process frame as well, and the graph
gathered from the ranks' rows: edges and bad flags equal, distances and
weights 1e-3, the positions' tolerance); the pose system
1e-5 x max|H|; the
keyframe-sharded BA poses 2e-4 and landmarks 2e-3 against both the JAX
single-device BA and the JAX keyframe-sharded BA on 4 virtual devices,
with the RMSE below 0.2x its start. Sums reduced over ranks are added in
another order than one einsum, so nothing is held to bit equality with
one process. The sharded frame raises on every rank unless every rank
computed the same state from the gathered arrays (a checksum compared
across ranks before the rank keeps its rows), so a frame that returns has
passed that check. The graph stays row-sharded: every rank's graph leaves
are ``[P / n, P]`` after every frame, and no collective of a frame carries
a payload of ``P * P / n`` elements (the host tally's
``collectives.largest``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from nrslam_tpu_torch import convert
from nrslam_tpu_torch.parallel import dryrun, multihost, sharding
from nrslam_tpu_torch.slam import state as tstate
from nrslam_tpu_torch.slam import system as tsystem
from nrslam_tpu_torch.utils.tree import tree_map

from torch_parity import (ba_floats, np_of,  # noqa: F401
                          pallas_ba_reference, quat_err, solve_floats,
                          to_port)

torch.set_num_threads(1)

N_RANKS = 4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    with dryrun.World(N_RANKS, "cpu",
                      store_dir=tmp_path_factory.mktemp("store")) as w:
        yield w
    assert not w.loaded_jax


def _np(tree):
    """A JAX pytree as the port's structure with numpy leaves."""
    return convert.to_numpy(to_port(tree))


def _jax_problem(max_points=64):
    import __graft_entry__ as ge
    return ge._small_problem(max_points=max_points)


def test_sharded_frame_matches_jax(world, pallas_ba_reference):
    """The sharded non-keyframe (tracking and the mapping's triangulation)
    on ``__graft_entry__._small_problem(64)`` against the JAX package's
    single-device frame (``_fused_frame_impl``: pyramid,
    ``_process_frame_impl``, ``_mapping_impl``)."""
    from nrslam_tpu.slam import system as jsystem

    state, pyr1, cam, config, shape = _jax_problem()
    gray1 = pyr1[0][0]
    mask = jnp.ones(shape, bool)
    ref, ref_res = jsystem._fused_frame_impl(state, gray1, mask, cam.params,
                                             cam.kind, config, False)
    outs = world.run("sharded_frames", _np(state), [np.asarray(gray1)],
                     np.asarray(mask), _np(cam), to_port(config), [False])
    out = outs[0]
    assert out["n_tracked_3d"] == [int(ref_res.n_tracked_3d)]
    np.testing.assert_allclose(out["state"].Tcw.t, np_of(ref.Tcw.t),
                               atol=1e-4)
    np.testing.assert_allclose(out["state"].positions, np_of(ref.positions),
                               atol=1e-3)
    assert np.mean(out["state"].status == np_of(ref.status)) >= 0.98


def _freed_keyframe_problem():
    """``_small_problem(64)`` with 16 of its slots freed and a first
    keyframe inserted, its next three frames and the config: (JAX state,
    raw frames, mask, cam, config)."""
    from nrslam_tpu.datasets import synthetic as jsynthetic
    from nrslam_tpu.slam import state as jstate

    js, _, cam, config, shape = _jax_problem()
    free = jnp.arange(64) >= 48
    js = jstate.insert_keyframe(js._replace(
        slot_used=~free, has_3d=~free,
        track_id=jnp.where(free, -1, js.track_id),
        status=jnp.where(free, jstate.NOT_IN_FRAME, js.status),
        next_track_id=jnp.int32(48)))
    scene = jsynthetic.SceneConfig(height=96, width=128, fx=100.0, fy=100.0)
    raw = [jsynthetic.render_frame(i, scene)[0] for i in (1, 2, 3)]
    return js, raw, jnp.ones(shape, bool), cam, config


def _frames_against_jax(world, kfs):
    """The sharded frames over ``_freed_keyframe_problem`` against the JAX
    package's single-device ``frame_step`` (``_fused_frame_impl``, its BA
    in the Pallas configuration the port follows) and the port's
    single-process ``frame_step``: n_tracked_3d equal, Tcw.t 1e-4,
    positions 1e-3, statuses on >= 98% of slots, track ids and the
    keyframe ring's validity equal. Returns (rank 0's record, the final
    JAX state, the port's)."""
    from nrslam_tpu.slam import system as jsystem

    js, raw, mask, cam, config = _freed_keyframe_problem()
    outs = world.run("sharded_frames", _np(js),
                     [np.asarray(f) for f in raw], np.asarray(mask),
                     _np(cam), to_port(config), kfs)
    got = outs[0]["state"]
    for out in outs:
        assert out["graph_shapes"] == [[(16, 64)]] * len(kfs)
    ts, tcam, tmask, tconfig = to_port(js), to_port(cam), to_port(mask), \
        to_port(config)
    jn3d, tn3d = [], []
    for f, kf in zip(raw, kfs):
        js, jres = jsystem.frame_step(js, f, mask, cam, config, kf)
        ts, tres = tsystem.frame_step(ts, to_port(f), tmask, tcam, tconfig,
                                      kf)
        jn3d.append(int(jres.n_tracked_3d))
        tn3d.append(int(tres.n_tracked_3d))
    assert outs[0]["n_tracked_3d"] == jn3d == tn3d
    for ref in (jax.device_get(js), convert.to_numpy(ts)):
        np.testing.assert_allclose(got.Tcw.t, np.asarray(ref.Tcw.t),
                                   atol=1e-4)
        np.testing.assert_allclose(got.positions, np.asarray(ref.positions),
                                   atol=1e-3)
        assert np.mean(got.status == np.asarray(ref.status)) >= 0.98
        np.testing.assert_array_equal(got.track_id,
                                      np.asarray(ref.track_id))
        np.testing.assert_array_equal(got.kf_valid,
                                      np.asarray(ref.kf_valid))
    return outs[0], js, ts


def test_sharded_keyframes_match_jax(world, pallas_ba_reference):
    """Three frames (non-keyframe, keyframe with new features and its BA,
    non-keyframe) on ``_small_problem(64)`` with 16 of its slots freed and
    a first keyframe inserted, sharded, against the JAX package's
    single-device ``frame_step`` and against the port's single-process
    ``frame_step`` (``_frames_against_jax``); the graph gathered from the
    ranks' rows against the JAX graph."""
    out, js, _ = _frames_against_jax(world, [False, True, False])
    got = out["state"]
    assert int(got.kf_valid.sum()) == 2 and int(got.slot_used.sum()) > 48
    jg = jax.device_get(js.graph)
    for f in ("exists", "bad"):
        np.testing.assert_array_equal(getattr(got.graph, f),
                                      np.asarray(getattr(jg, f)))
    for f in ("first_distance", "max_distance", "min_distance", "weight"):
        np.testing.assert_allclose(getattr(got.graph, f),
                                   np.asarray(getattr(jg, f)), atol=1e-3)


def test_sharded_window_ba_keyframes_match_jax(world, pallas_ba_reference):
    """Three keyframes in a row on the same problem: the second and third
    run the window BA on 3 and 4 valid keyframes (below 3 its result is
    not used), partitioned over the 4 ranks' point blocks; as
    ``_frames_against_jax``, and the keyframe ring's poses (1e-4) and
    landmark copies (1e-3), which the BA wrote, against both references."""
    out, js, ts = _frames_against_jax(world, [True, True, True])
    got = out["state"]
    assert int(got.kf_valid.sum()) == 4
    assert not np.array_equal(got.kf_positions[got.kf_valid][-2],
                              got.kf_positions[got.kf_valid][-1])
    for ref in (jax.device_get(js), convert.to_numpy(ts)):
        np.testing.assert_allclose(got.kf_pose.t, np.asarray(ref.kf_pose.t),
                                   atol=1e-4)
        assert quat_err(got.kf_pose.q, np.asarray(ref.kf_pose.q)) <= 1e-4
        np.testing.assert_allclose(got.kf_positions,
                                   np.asarray(ref.kf_positions), atol=1e-3)


def test_plain_oracle_is_deterministic():
    """``dryrun._plain_solves`` (the one process that ``[parallel]`` holds
    the sharded frame to) swaps all three solves to their plain drivers and
    runs with deterministic algorithms, restoring both afterwards."""
    from nrslam_tpu_torch.solver import bundle_adjustment as tba
    from nrslam_tpu_torch.solver import bundle_adjustment_cuda as tbac

    kernel = tbac.local_deformable_ba_cuda
    assert not torch.are_deterministic_algorithms_enabled()
    with dryrun._plain_solves():
        assert torch.are_deterministic_algorithms_enabled()
        assert tbac.local_deformable_ba_cuda is tba.local_deformable_ba_plain
    assert not torch.are_deterministic_algorithms_enabled()
    assert tbac.local_deformable_ba_cuda is kernel


def test_frame_placement_round_trips(world):
    """``tracking_shard.shard_state`` on every rank, then
    ``sharding.unshard_state`` with ``state_axes``: the whole state back,
    leaf for leaf; a rank holds its [16] slots, [16, 64] graph rows and
    [K, 16] keyframe-ring columns, and the whole [T, 64] temporal ring."""
    js, _, mask, _, config = _freed_keyframe_problem()
    state = _np(js)
    outs = world.run("frame_placement_round_trip", state, to_port(config),
                     mask.shape)
    for whole, shapes in outs:
        tree_map(np.testing.assert_array_equal, whole, state)
        assert shapes == {"positions": (16, 3), "graph.weight": (16, 64),
                          "kf_positions": (8, 16, 3), "kf_obs": (8, 16),
                          "tb_positions": (20, 64, 3), "tb_tracked": (20, 64),
                          "refs.patch": (16, 5, 21, 21)}


def test_sharded_frames_keep_graph_rows(world):
    """At P = 768 (the main path's slots, where a ``[P, P]`` payload would
    stand out from the ``[P]``, ``[P, k]`` and window gathers), a
    non-keyframe and a keyframe on ``dryrun.small_problem``: every rank
    holds ``[192, 768]`` graph leaves after each frame, no collective
    payload reaches ``P * P / 4`` elements, and a frame's collectives other
    than the partitioned solves' carry less than one ``[P, P]`` float32
    matrix; the solves' share is exactly their schedule's (O(P) a CG trip,
    no ``[P, P]`` term; on the keyframe the window BA's too); each frame
    gathers the state's [P] arrays only, ``dryrun.frame_gather_bytes``
    (no ring: the keyframe ring's columns stay on their rank, the temporal
    ring is replicated); the ranks agree with each other."""
    from nrslam_tpu_torch.parallel import tracking_shard

    P = 768
    state, gray, mask, cam, config = dryrun.small_problem(P, "cpu")
    outs = world.run("sharded_frames", convert.to_numpy(state),
                     [gray.numpy()] * 2, mask.numpy(), convert.to_numpy(cam),
                     config, [False, True], False)
    axes = tracking_shard.gather_axes(config, tuple(gray.shape))
    rings = tracking_shard.KF_RING + tracking_shard.TEMPORAL_RING
    assert all(getattr(axes, f) is None for f in rings)
    gathered = dryrun.frame_gather_bytes(config, tuple(gray.shape))
    assert gathered == 30 * P
    count, floats = solve_floats(P, N_RANKS)
    ba_count, ba_nf = ba_floats(config.ba_window, P, N_RANKS,
                                 cg_iters=config.ba_cg_iters)
    for out in outs:
        assert out["graph_shapes"] == [[(P // N_RANKS, P)]] * 2
        assert max(out["max_payload"]) < P * P // N_RANKS
        assert out["solve_payloads"] == [count, count + ba_count]
        assert out["solve_bytes"] == [4 * floats, 4 * (floats + ba_nf)]
        assert out["gather_bytes"] == [gathered] * 2
        assert max(b - s for b, s in zip(out["bytes"],
                                         out["solve_bytes"])) < 4 * P * P
        assert out["n_tracked_3d"] == outs[0]["n_tracked_3d"]
    assert min(outs[0]["n_tracked_3d"]) >= 100
    assert outs[0]["state"].graph is None


def test_sharded_pose_system_matches(world):
    from nrslam_tpu.solver import core, residuals

    state, _, cam, _, _ = _jax_problem()
    w = state.slot_used.astype(jnp.float32)
    e, J, _ = residuals.reprojection(cam, state.Tcw, state.positions,
                                     state.keypoints)
    chi2 = jnp.sum(e * e, axis=-1)
    wh = core.huber_weight(chi2, 5.99) * w
    H_ref = np_of(jnp.einsum("pri,p,prj->ij", J, wh, J))
    g_ref = np_of(jnp.einsum("pri,p,pr->i", J, wh, e))
    outs = world.run("pose_system", _np(cam), np_of(state.Tcw.q),
                     np_of(state.Tcw.t), np_of(state.positions),
                     np_of(state.keypoints), np_of(w))
    H, g, _ = outs[0]
    scale = np.abs(H_ref).max()
    np.testing.assert_allclose(H, H_ref, atol=1e-5 * scale)
    np.testing.assert_allclose(g, g_ref,
                               atol=1e-5 * max(1.0, np.abs(g_ref).max()))


def _window():
    from tests.test_bundle_adjustment import CAM, make_window
    from nrslam_tpu.geometry import se3 as jse3

    poses_true, L_true, obs, problem = make_window(K=8, P=64)
    key = jax.random.PRNGKey(7)
    poses0 = jse3.SE3(poses_true.q, poses_true.t + 0.01 * jax.random.normal(
        key, poses_true.t.shape))
    L0 = L_true + 0.03 * jax.random.normal(jax.random.fold_in(key, 1),
                                           L_true.shape)
    return CAM, poses_true, L_true, obs, problem, poses0, L0


def _rmse(cam, q, t, L, obs):
    from nrslam_tpu_torch.geometry import cameras, se3

    pred = cameras.project(cam, se3.apply(
        se3.SE3(torch.tensor(q)[:, None], torch.tensor(t)[:, None]),
        torch.tensor(L)))
    return float(torch.sqrt(torch.mean(torch.sum(
        (pred - torch.tensor(obs)) ** 2, -1))))


def test_kf_sharded_ba_matches_jax(world):
    """The keyframe-sharded BA at K=8 over 4 ranks (two keyframes each,
    halo dampers between blocks) against the JAX single-device BA and the
    JAX keyframe-sharded BA on 4 virtual devices, and it solves."""
    from nrslam_tpu.parallel import ba_shard as jba_shard
    from nrslam_tpu.solver import bundle_adjustment as jba

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    CAM, _, _, obs, problem, poses0, L0 = _window()
    poses_ref, L_ref = jba.local_deformable_ba(CAM, poses0, L0, problem)
    kf_mesh = JMesh(np.array(jax.devices()[:4]), ("kf",))
    poses_jsh, L_jsh = jba_shard.local_deformable_ba_kf_sharded(
        kf_mesh, CAM, poses0, L0, problem)
    outs = world.run("kf_sharded_ba", _np(CAM), _np(poses0), np_of(L0),
                     _np(problem), 5, 32)
    poses, L, _ = outs[0]
    for ref_poses, ref_L in ((poses_ref, L_ref), (poses_jsh, L_jsh)):
        np.testing.assert_allclose(poses.t, np_of(ref_poses.t), atol=2e-4)
        assert quat_err(poses.q, ref_poses.q) <= 2e-4
        np.testing.assert_allclose(L, np_of(ref_L), atol=2e-3)
    cam = to_port(CAM)
    rmse0 = _rmse(cam, np_of(poses0.q), np_of(poses0.t), np_of(L0),
                  np_of(obs))
    rmse = _rmse(cam, poses.q, poses.t, L, np_of(obs))
    assert rmse < 0.2 * rmse0, (rmse0, rmse)


def test_kf_sharded_ba_masked_keyframes(world, pallas_ba_reference):
    """Invalid keyframe slots (the ring not yet full: 5 of 8 valid, their
    observations NaN) stay inert when sharded: the valid window is finite
    and agrees with the JAX package's BA on the same window in the Pallas
    configuration (which sanitises the unobserved copies, as the port
    does), and with the port's single-process BA."""
    from nrslam_tpu.solver import bundle_adjustment as jba
    from nrslam_tpu_torch.solver import bundle_adjustment as tba

    CAM, poses_true, L_true, _, problem, _, _ = _window()
    kf_valid = jnp.arange(8) < 5
    problem = problem._replace(
        kf_valid=kf_valid,
        obs=jnp.where(kf_valid[:, None, None], problem.obs, jnp.nan))
    L0 = jnp.where(kf_valid[:, None, None], L_true, 1.0)
    outs = world.run("kf_sharded_ba", _np(CAM), _np(poses_true), np_of(L0),
                     _np(problem), 5, 32)
    poses, L, _ = outs[0]
    assert np.isfinite(L[:5]).all() and np.isfinite(poses.t[:5]).all()
    jax_poses, jax_L = jba.local_deformable_ba(CAM, poses_true, L0, problem)
    port_poses, port_L = tba.local_deformable_ba(
        to_port(CAM), to_port(poses_true), to_port(L0), to_port(problem))
    for ref_poses, ref_L in ((jax_poses, jax_L), (port_poses, port_L)):
        np.testing.assert_allclose(poses.t[:5], np_of(ref_poses.t)[:5],
                                   atol=2e-4)
        assert quat_err(poses.q[:5], np_of(ref_poses.q)[:5]) <= 2e-4
        np.testing.assert_allclose(L[:5], np_of(ref_L)[:5], atol=2e-3)


def test_multihost_round_trips(world):
    """Each rank feeds the same frame and its own block of points: every
    rank holds the frame and its block; a frame that differs on one rank
    is refused by every rank."""
    frame = np.random.default_rng(0).random((12, 16)).astype(np.float32)
    points = np.arange(64 * 3, dtype=np.float32).reshape(64, 3)
    outs = world.run("multihost_round_trip", frame, points)
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["frame"], frame)
        np.testing.assert_array_equal(out["shard"],
                                      points[16 * r:16 * (r + 1)])
        assert out["refused"], r
        assert out["digest_same"] == [True, False, False], r


def test_single_process_mesh():
    """Without a process group: initialize is a no-op, the mesh has one
    rank, every collective is the identity and shard / unshard round-trip
    the whole state (whose [K] ring has the extent of a P / n block)."""
    assert not multihost.initialize("gloo", world_size=1, rank=0)
    assert not multihost.initialize()
    with pytest.raises(ValueError):
        multihost.initialize("mpi", world_size=2, rank=0)
    mesh = multihost.global_mesh("cpu")
    assert (mesh.rank, mesh.world_size, mesh.group) == (0, 1, None)
    x = torch.arange(6.0)
    assert torch.equal(sharding.replicate(np.arange(6.0, dtype=np.float32),
                                          mesh), x)
    assert torch.equal(sharding.all_reduce_sum(mesh, x)[0], x)
    assert torch.equal(sharding.recv_next(mesh, x), torch.zeros(6))
    assert torch.equal(sharding.send_next(mesh, x), torch.zeros(6))
    config = tstate.Config(max_points=32)
    s = tstate.empty_state(config, (48, 64), "cpu")
    s = s._replace(positions=torch.randn(32, 3))
    local = sharding.shard_state(s, mesh, 32)
    axes = sharding.point_axes(s, 32)
    back = sharding.unshard_state(local, mesh, axes)
    eq = []
    tree_map(lambda a, b: eq.append(torch.equal(a, b)), back, s)
    assert all(eq) and axes.kf_valid is None and axes.graph.weight == 0
    assert axes.kf_positions == 1 and axes.refs.patch == 0


def test_dryrun_multichip():
    """The port's dry run on 4 spawned ranks: the sharded non-keyframe with
    mapping, a keyframe with its BA, the pose system and the
    keyframe-sharded BA at K=4."""
    out = dryrun.dryrun_multichip(N_RANKS, "cpu")
    assert out["H_shape"] == (6, 6) and out["L_shape"] == (N_RANKS, 32, 3)
    assert out["finite"] and min(out["n_tracked_3d"]) >= 10
    assert out["kf_valid"] == 1
