"""The captured point-sharded frame
(nrslam_tpu_torch/parallel/frame_graph_shard.py) on the CPU.

A CUDA graph captures and replays only on the card, and gloo's collectives
cannot be captured at all, so here the graphs of ``ShardFrameGraph`` are
replaced by what a replay runs, the captured body on the static buffers
(``EagerShardFrameGraph``: its build records what the body counts, as a
capture does), and ``step``'s contract is held on 2 gloo ranks
(``dryrun.World(2, "cpu")``, the ranks import this module for their task
and never JAX) on the bench problem at P=128, 120x160 with 64 new
keypoints and 96 slots used, over a non-keyframe and a keyframe (new
features in the free slots): every step bit for bit the eager
``frame_step_sharded`` on the same ranks (shard, result, collectives'
payloads and bytes), a snapshot unchanged by later steps, the build
leaving the host tally as it found it and each step adding what its
capture recorded, and the host-side checksum raising on every rank
when one rank's replicated leaf differs. The gathered state after the two
frames is held to the JAX package's ``_fused_frame_impl`` on the same
state sharded over ``pt`` on 8 virtual devices under
``dryrun.FRAME_GATES``. The constructor refuses CPU tensors, a gloo
group and a mesh with no group.
"""

import numpy as np
import pytest
import torch

from nrslam_tpu_torch import convert
from nrslam_tpu_torch.parallel import (dryrun, frame_graph_shard, sharding,
                                       tracking_shard)
from nrslam_tpu_torch.utils import profiler, tree

torch.set_num_threads(1)

N_RANKS = 2
P, H, W, NEW_KP, USED = 128, 120, 160, 64, 96
KEYFRAMES = (False, True)


class _Replay:
    """What a replay of the graph of kind ``kf`` runs: the captured body
    on the static buffers, the host tally untouched (a replay runs no
    Python)."""

    def __init__(self, fg, kf):
        self.fg, self.kf = fg, kf

    def replay(self):
        profiler.record(lambda: self.fg._body(self.fg.views, self.kf))


class EagerShardFrameGraph(frame_graph_shard.ShardFrameGraph):
    """``ShardFrameGraph`` with its two graphs replaced by ``_Replay``: the
    build runs each kind once on a scratch copy under ``profiler.record``
    (what a capture records) and no check of the device or the backend."""

    def _build(self):
        for kf in (False, True):
            scratch = tree.unpack(self.buf.clone(), self.packing)
            _, self.recorded[kf] = profiler.record(
                lambda: self._body(scratch, kf))
            self._graphs[kf] = _Replay(self, kf)
            self.capture_s[kf] = self.pool_bytes[kf] = 0


def _clone(t):
    return tree.tree_map(torch.clone, t)


def rank_replays(mesh, state, frames, mask, cam, config, keyframes):
    """On each rank: the real constructor's refusal, then an
    ``EagerShardFrameGraph`` stepped over ``frames`` beside the eager
    ``frame_step_sharded`` (module ``__doc__``); returns the readings and,
    on rank 0, the gathered final state."""
    cam = dryrun.to_device(cam, "cpu")
    mask = torch.as_tensor(mask)
    frames = [torch.as_tensor(f) for f in frames]
    local = tracking_shard.shard_state(dryrun.to_device(state, "cpu"), mesh,
                                       config)
    out = {}
    try:
        frame_graph_shard.ShardFrameGraph(local, frames[0], mask, cam,
                                          config, mesh)
    except ValueError as e:
        out["refused"] = str(e)

    # Tallies that are not zero, so "as found" is not "empty".
    profiler.tally("pose_only_shard.step", 5)
    profiler.tally("pose_deformation_shard.calls", 2)
    profiler.tally("collectives.gather.bytes", 56)
    profiler.tally_max("collectives.largest", 3)
    handle = torch.zeros(1)
    profiler.keep("pose_only_shard.last_lm_steps", handle)
    found = profiler.tallies()
    fg = EagerShardFrameGraph(local, frames[0], mask, cam, config, mesh)
    out["build_kept"] = (profiler.tallies() == found and profiler.kept(
        "pose_only_shard.last_lm_steps") is handle)
    out["recorded"] = {kf: (fg.recorded[kf].counts, fg.recorded[kf].largest)
                       for kf in (False, True)}
    for k in ("same", "adds_recorded", "eager_moved", "snapshot_kept",
              "not_the_buffer", "n_tracked_3d", "states"):
        out[k] = []
    axes = tracking_shard.state_axes(config, tuple(mask.shape))._replace(
        refs=None)
    eager, stepped, snap = local, (local, None), None
    for f, kf in zip(frames, keyframes):
        (e, er), rec = profiler.record(
            lambda: tracking_shard.frame_step_sharded(mesh, eager, f, mask,
                                                      cam, config, kf))
        profiler.replay(rec)
        before = profiler.tallies()
        last = stepped
        stepped = fg.step(last[0], f, mask, kf)
        after = profiler.tallies()
        out["eager_moved"].append((rec.counts, rec.largest))
        # The eager frame set the largest payload already: only the
        # counts move.
        added = {k: v - before.get(k, 0) for k, v in after.items()
                 if v != before.get(k, 0)}
        out["adds_recorded"].append(
            added == fg.recorded[kf].counts
            and all(profiler.kept(k) is x
                    for k, x in fg.recorded[kf].kept.items()))
        out["same"].append(dryrun._bits_equal(stepped, (e, er)))
        if snap is not None:
            out["snapshot_kept"].append(dryrun._bits_equal(last, snap))
        snap = _clone(stepped)
        out["not_the_buffer"].append(all(
            x.untyped_storage().data_ptr()
            != fg.buf.untyped_storage().data_ptr()
            for x in tree.leaves(stepped)))
        out["n_tracked_3d"].append(int(stepped[1].n_tracked_3d))
        full = sharding.unshard_state(stepped[0]._replace(refs=None), mesh,
                                      axes)
        out["states"].append(convert.to_numpy(full) if mesh.rank == 0
                             else None)
        eager = e
    out["replays"] = fg.replays
    g = stepped[0]

    # One bit of a replicated leaf flipped on rank 1: every rank's replay
    # must refuse the frame after it.
    if mesh.rank == 1:
        t = g.Tcw.t.clone()
        t.view(torch.int32)[0] ^= 1
        g = g._replace(Tcw=g.Tcw._replace(t=t))
    try:
        fg.step(g, frames[0], mask, False)
        out["flip_raised"] = False
    except RuntimeError as err:
        out["flip_raised"] = "different states" in str(err)
    return out


@pytest.fixture(scope="module")
def problem():
    """The JAX bench problem (state, raw frames, mask, cam, config)."""
    from torch_parity import jax_bench_problem
    return jax_bench_problem(P, H, W, NEW_KP, n_used=USED)


@pytest.fixture(scope="module")
def replays(problem, tmp_path_factory):
    """Both ranks' ``rank_replays`` on the problem."""
    from torch_parity import to_port

    js, raw, jmask, jcam, jcfg = problem
    with dryrun.World(N_RANKS, "cpu",
                      store_dir=tmp_path_factory.mktemp("store")) as w:
        outs = w.run(f"{__name__}:rank_replays",
                     convert.to_numpy(to_port(js)),
                     [np.asarray(f) for f in raw[:len(KEYFRAMES)]],
                     np.asarray(jmask), convert.to_numpy(to_port(jcam)),
                     to_port(jcfg), KEYFRAMES)
    assert not w.loaded_jax
    return outs


def test_record_and_add_recorded():
    """``profiler.record`` runs a function from an empty host tally and
    sets the tally back as it was, also when the function raises;
    ``profiler.replay`` adds its counts, takes its largest values where
    larger and keeps its tensors."""
    profiler.tally("pose_only_shard.partials", 2)
    profiler.tally_max("collectives.largest", 4)
    handle = torch.zeros(1)
    profiler.keep("pose_only_shard.last_lm_steps", handle)
    found = profiler.tallies()

    def run():
        empty = (profiler.tallies() == {}
                 and profiler.kept("pose_only_shard.last_lm_steps") is None)
        profiler.tally("pose_only_shard.partials", 3)
        profiler.tally("pose_only_shard.calls")
        profiler.tally_max("collectives.largest", found[
            "collectives.largest"] + 5)
        profiler.tally_max("collectives.largest", 1)
        profiler.keep("pose_only_shard.last_lm_steps", torch.ones(1))
        return empty

    empty, rec = profiler.record(run)
    assert empty and profiler.tallies() == found
    assert profiler.kept("pose_only_shard.last_lm_steps") is handle
    assert rec.counts == {"pose_only_shard.partials": 3,
                          "pose_only_shard.calls": 1}
    assert rec.largest == {"collectives.largest":
                           found["collectives.largest"] + 5}
    for _ in range(2):
        profiler.replay(rec)
    after = profiler.tallies()
    assert {k: v - found.get(k, 0) for k, v in after.items()
            if v != found.get(k, 0)} == {
        "pose_only_shard.partials": 6, "pose_only_shard.calls": 2,
        "collectives.largest": 5}
    assert profiler.kept("pose_only_shard.last_lm_steps") is rec.kept[
        "pose_only_shard.last_lm_steps"]

    def fail():
        profiler.tally("pose_only_shard.calls")
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        profiler.record(fail)
    assert profiler.tallies() == after


def test_constructor_raises_without_nccl(replays):
    """A gloo group and CPU tensors (each rank) and a mesh with no group
    (here) are refused, naming every reason."""
    for out in replays:
        assert "gloo group" in out["refused"] and "cpu" in out["refused"]
    state, frames, mask, cam, config = dryrun.small_problem(16, "cpu")
    with pytest.raises(ValueError, match="no process group") as e:
        frame_graph_shard.ShardFrameGraph(
            state, frames, mask, cam, config,
            sharding.Mesh(0, 1, None, torch.device("cpu")))
    assert "CUDA" in str(e.value)


def test_replays_match_eager_bit_for_bit(replays):
    """Every step (non-keyframe, keyframe) equals the eager
    sharded frame on the same ranks bit for bit, shard and result, and the
    eager frame's collectives carried what the capture recorded."""
    for out in replays:
        assert out["same"] == [True] * len(KEYFRAMES)
        assert out["replays"] == len(KEYFRAMES)
        for kf, moved in zip(KEYFRAMES, out["eager_moved"]):
            assert moved == out["recorded"][kf]
    assert min(replays[0]["n_tracked_3d"]) > 0


def test_build_keeps_counts_and_steps_add_recorded(replays):
    """The build leaves the host tally as it found it (not empty), each
    step adds what its kind's capture recorded and keeps its tensors, and
    the record holds the frame's collectives (the state gather's and the
    partitioned solves' payloads; the window BA's on the keyframe)."""
    for out in replays:
        assert out["build_kept"]
        assert out["adds_recorded"] == [True] * len(KEYFRAMES)
        counts = {kf: out["recorded"][kf][0] for kf in (False, True)}
        for kf in (False, True):
            for name in ("collectives", "collectives.gather",
                         "collectives.solve"):
                assert counts[kf][f"{name}.payloads"] > 0, (kf, name)
        assert (counts[True]["collectives.solve.payloads"]
                > counts[False]["collectives.solve.payloads"])


def test_snapshots_are_independent(replays):
    """A step's snapshot is not the static buffer, and no later step
    writes into it."""
    for out in replays:
        assert out["not_the_buffer"] == [True] * len(KEYFRAMES)
        assert out["snapshot_kept"] == [True] * (len(KEYFRAMES) - 1)


def test_checksum_raises_on_every_rank(replays):
    """One bit of rank 1's pose flipped: the host-side comparison after
    the replay raises on both ranks."""
    assert [out["flip_raised"] for out in replays] == [True] * N_RANKS


def test_replayed_state_matches_jax_sharded(problem, replays):
    """The ranks' gathered state after the replayed non-keyframe and
    keyframe against the JAX package's ``_fused_frame_impl`` on the state
    sharded over ``pt`` on 8 virtual devices, under ``dryrun.FRAME_GATES``
    (pose, positions, statuses, the graph; n_tracked_3d and the keyframe
    ring's validity equal)."""
    import jax
    from jax.sharding import Mesh as JMesh

    from nrslam_tpu.parallel import sharding as jsharding
    from nrslam_tpu.slam import system as jsystem
    from torch_parity import to_port

    js, raw, jmask, jcam, jcfg = problem
    mesh = JMesh(np.array(jax.devices("cpu")[:8]), ("pt",))
    s = jsharding.shard_state(js, mesh, P)
    mask = jsharding.replicate(jmask, mesh)
    n3d = []
    for i, kf in enumerate(KEYFRAMES):
        s, res = jsystem._fused_frame_impl(
            s, jsharding.replicate(raw[i], mesh), mask, jcam.params,
            jcam.kind, jcfg, kf)
        n3d.append(int(res.n_tracked_3d))
    got = replays[0]["states"][-1]
    ref = to_port(s)
    g = dryrun.FRAME_GATES
    d = dryrun._differences(got, ref)
    assert replays[0]["n_tracked_3d"] == n3d
    assert d["dt"] <= g["dt"] and d["dpos"] <= g["dpos"], d
    assert d["agree"] >= g["agree"] and d["kf_valid_equal"], d
    assert d["dkf_pose"] <= g["dt"] and d["dkf_pos"] <= g["dpos"], d
    for f in ("exists", "bad"):
        np.testing.assert_array_equal(getattr(got.graph, f),
                                      getattr(ref.graph, f).numpy())
    for f in ("first_distance", "max_distance", "min_distance", "weight"):
        np.testing.assert_allclose(getattr(got.graph, f),
                                   getattr(ref.graph, f).numpy(),
                                   atol=g["dgraph"])
