"""The captured frame (nrslam_tpu_torch/slam/frame_graph.py) on the CPU.

A CUDA graph captures and replays only on the card, so here the graphs of
``FrameGraph`` are replaced by what a replay runs, the captured body on the
static buffers (``EagerFrameGraph``), and ``step``'s contract is held on
CPU buffers: the packed state of the bench problem (P=128, 120x160)
round-trips leaf for leaf; a snapshot is independent of the buffer it was
copied from and of later steps; the body over 4 frames with keyframes on
frames 1 and 3 (the second runs the local BA over a 3-keyframe window)
matches the JAX package's ``frame_step`` within tests/test_torch_slice.py's
tolerances and the port's eager ``frame_step`` bit for bit; a state that
is not the last snapshot is copied in; a LOST state comes out unchanged in
both kinds with n_tracked_3d 0. ``FrameGraph`` raises on CPU tensors, and
a CPU ``System`` builds no graph and calls nothing of ``torch.cuda``.
"""

import numpy as np
import pytest
import torch

from nrslam_tpu.slam import system as jsys
from nrslam_tpu_torch import bench_problem
from nrslam_tpu_torch.slam import frame_graph
from nrslam_tpu_torch.slam import system as tsys
from nrslam_tpu_torch.utils import profiler, tree

from torch_parity import (cuda_calls, jax_bench_problem, np_of, quat_err,
                          to_port)
from torch_parity import pallas_ba_reference  # noqa: F401 (a fixture)

torch.set_num_threads(1)

KEYFRAMES = (False, True, False, True)


class _Replay:
    """What a replay of the graph of kind ``kf`` runs: the captured body on
    the frame graph's static buffers."""

    def __init__(self, fg, kf):
        self.fg, self.kf = fg, kf

    def replay(self):
        fg = self.fg
        frame_graph.body(fg.views[0], fg.gray, fg.mask, fg.cam, fg.config,
                         self.kf, fg.views)


class EagerFrameGraph(frame_graph.FrameGraph):
    """``FrameGraph`` with its two graphs replaced by ``_Replay``: no
    capture, no launch recorded."""

    def _build(self):
        for kf in (False, True):
            self._graphs[kf] = _Replay(self, kf)
            self.recorded[kf] = profiler.Record({}, {}, {})


def _bench(P=128):
    return bench_problem.build_bench_problem(P, 120, 160, 64, device="cpu")


def _bits(x):
    return x.detach().contiguous().reshape(-1).view(torch.uint8)


def _assert_same(a, b, label=""):
    """Every leaf of two trees of the same dtype, shape and bits."""
    la, lb = tree.leaves(a), tree.leaves(b)
    assert len(la) == len(lb) > 0, label
    for k, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and x.shape == y.shape, (label, k)
        assert torch.equal(_bits(x), _bits(y)), (label, k)


def _clone(t):
    return tree.tree_map(torch.clone, t)


def test_packed_state_round_trips():
    state, *_ = _bench()
    frame = (state, frame_graph.result_like(state))
    p = tree.packing(frame)
    buf = tree.pack(frame, p)
    assert buf.dtype == torch.uint8 and buf.shape == (p.nbytes,)
    views = tree.unpack(buf, p)
    _assert_same(views, frame)
    assert type(views[0]) is type(state) and type(views[0].graph) is type(
        state.graph)
    assert len(p.specs) == len(tree.leaves(frame)) == 47
    ends = 0
    for (at, n, dtype, shape), v in zip(p.specs, tree.leaves(views)):
        assert at % tree.ALIGN == 0 and at >= ends
        ends = at + n
        assert v.untyped_storage().data_ptr() == buf.untyped_storage(
        ).data_ptr()
        assert v.data_ptr() == buf.data_ptr() + at
    assert ends <= p.nbytes < ends + tree.ALIGN
    # Writing through the views writes the buffer, and back.
    views[0].positions.add_(1.0)
    _assert_same(tree.unpack(buf, p)[0].positions, state.positions + 1.0)
    with pytest.raises(ValueError, match="leaf"):
        tree.copy_(views[0], state._replace(scale=state.scale.double()))
    with pytest.raises(ValueError, match="leaf"):
        tree.copy_(views[0], state._replace(kf_valid=state.kf_valid[:1]))


def test_snapshot_is_independent():
    state, frames, mask, cam, config = _bench()
    fg = EagerFrameGraph(state, frames[0], mask, cam, config)
    s1, r1 = fg.step(state, frames[0], mask, False)
    kept = _clone((s1, r1))
    for leaf in tree.leaves((s1, r1)):
        assert leaf.untyped_storage().data_ptr() != fg.buf.untyped_storage(
        ).data_ptr()
    s2, r2 = fg.step(s1, frames[1], mask, True)
    _assert_same((s1, r1), kept, "snapshot k after step k+1")
    kept2 = _clone((s2, r2))
    fg.buf.fill_(255)
    _assert_same((s2, r2), kept2, "snapshot after the buffer changed")
    assert fg.replays == 2


def test_captured_body_matches_jax_and_eager(pallas_ba_reference):
    js, raw, jmask, jcam, jcfg = jax_bench_problem(128, 120, 160, 64)
    start = to_port(js)
    frames = [to_port(f) for f in raw]
    mask, cam, config = to_port(jmask), to_port(jcam), to_port(jcfg)
    fg = EagerFrameGraph(start, frames[0], mask, cam, config)
    es, gs = start, start
    for i, kf in enumerate(KEYFRAMES):
        js, jr = jsys.frame_step(js, raw[i], jmask, jcam, jcfg, kf)
        es, er = tsys.frame_step(es, frames[i], mask, cam, config, kf)
        gs, gr = fg.step(gs, frames[i], mask, kf)
        _assert_same((gs, gr), (es, er), f"frame {i}")
        # The JAX frame, within the slice tolerances.
        agree = np_of(js.status) == np_of(gs.status)
        assert agree.mean() >= 0.98, (i, agree.mean())
        assert quat_err(js.Tcw.q, gs.Tcw.q) <= 1e-3, i
        assert np.linalg.norm(np_of(js.Tcw.t) - np_of(gs.Tcw.t)) <= 1e-3, i
        m = agree & np_of(js.slot_used)
        for f in ("positions", "keypoints"):
            d = np.linalg.norm(np_of(getattr(js, f)) - np_of(getattr(gs, f)),
                               axis=-1)[m]
            assert np.median(d) <= 1e-3, (i, f, np.median(d))
        assert int(jr.n_tracked_3d) == int(gr.n_tracked_3d), i
        assert bool(jr.lost) == bool(gr.lost), i
        assert np.array_equal(np_of(js.kf_valid), np_of(gs.kf_valid)), i
    assert int(gs.kf_valid.sum()) == 3
    assert fg.replays == len(KEYFRAMES)


def test_step_copies_in_only_a_state_it_did_not_return(monkeypatch):
    state, frames, mask, cam, config = _bench()
    fg = EagerFrameGraph(state, frames[0], mask, cam, config)
    copies = []
    copy_ = tree.copy_

    def spy(dst, src):
        if dst is fg.views[0]:
            copies.append(src)
        copy_(dst, src)

    monkeypatch.setattr(frame_graph.tree, "copy_", spy)
    s1, _ = fg.step(state, frames[0], mask, False)
    assert len(copies) == 1 and copies[0] is state
    s2, _ = fg.step(s1, frames[1], mask, False)
    assert len(copies) == 1
    # A state the graph did not return (a re-init, an assignment) is
    # picked up: here the first frame's result, stepped again.
    other = s1._replace(Tcw=s1.Tcw)
    s3, r3 = fg.step(other, frames[2], mask, True)
    assert len(copies) == 2 and copies[1] is other
    _assert_same((s3, r3), tsys.frame_step(s1, frames[2], mask, cam, config,
                                           True))
    assert not torch.equal(s3.positions, s2.positions)


@pytest.mark.parametrize("kf", [False, True], ids=["non_keyframe",
                                                   "keyframe"])
def test_lost_state_comes_out_unchanged(kf):
    state, frames, mask, cam, config = _bench()
    lost = state._replace(lost=torch.ones((), dtype=torch.bool))
    out = _clone((lost, frame_graph.result_like(lost)))
    frame_graph.body(lost, frames[0], mask, cam, config, kf, out)
    _assert_same(out[0], lost, "body")
    assert int(out[1].n_tracked_3d) == 0 and bool(out[1].lost)
    fg = EagerFrameGraph(lost, frames[0], mask, cam, config)
    s, r = fg.step(lost, frames[1], mask, kf)
    _assert_same(s, lost, "step")
    assert int(r.n_tracked_3d) == 0 and bool(r.lost)


class _NoGraph:
    """A graph whose replay runs nothing (a replay runs no Python)."""

    def replay(self):
        pass


class _TallyingGraphs(frame_graph.KindGraphs):
    """``KindGraphs`` over one CPU vector whose body tallies under names no
    module lists anywhere; the "capture" runs the body under
    ``profiler.record``, as ``KindGraphs._build`` records a capture."""

    def _check(self):
        pass

    def _body(self, views, kf):
        views[0].add_(1.0)
        profiler.tally("unlisted_kernel.launches", 2 if kf else 1)
        profiler.tally_max("unlisted_kernel.largest", 7)
        profiler.keep("unlisted_kernel.last_work", views[0][:1].clone())

    def _build(self):
        for kf in (False, True):
            _, self.recorded[kf] = profiler.record(
                lambda: self._body(self.views, kf))
            self._graphs[kf] = _NoGraph()


def test_replay_adds_any_tally_its_capture_recorded():
    """A tally name that nothing declares ahead, counted inside a capture,
    is recorded there (the tally left as found) and added by each replay,
    its kept tensor set: a new kernel's counts need no entry in
    slam/frame_graph.py."""
    gray = torch.zeros((4, 4))
    mask = torch.ones((4, 4), dtype=torch.bool)
    found = profiler.tallies()
    fg = _TallyingGraphs((torch.zeros(3),), gray, mask)
    assert profiler.tallies() == found
    assert profiler.kept("unlisted_kernel.last_work") is None
    assert fg.recorded[False].counts == {"unlisted_kernel.launches": 1}
    assert fg.recorded[True].counts == {"unlisted_kernel.launches": 2}
    state = torch.zeros(3)
    for kf in (False, True, True):
        state = fg._replay(state, gray, mask, kf)[0]
    after = profiler.tallies()
    assert {k: v - found.get(k, 0) for k, v in after.items()
            if v != found.get(k, 0)} == {"unlisted_kernel.launches": 5,
                                         "unlisted_kernel.largest": 7}
    assert fg.replays == 3
    assert profiler.kept("unlisted_kernel.last_work") is \
        fg.recorded[True].kept["unlisted_kernel.last_work"]


def test_frame_graph_raises_on_cpu_tensors():
    state, frames, mask, cam, config = _bench(64)
    with pytest.raises(ValueError, match="CUDA"):
        frame_graph.FrameGraph(state, frames[0], mask, cam, config)


def test_cpu_system_never_captures():
    """A CPU System in its steady state steps frame_step, builds no
    FrameGraph and calls no function of torch.cuda (``cuda_calls``)."""
    state, frames, mask, cam, config = _bench()
    sysm = tsys.System(cam, config)
    sysm.state, sysm.status = state, tsys.TRACKING
    sysm._image_shape = tuple(frames[0].shape)
    ref, outs = state, []
    with cuda_calls() as calls:
        for i in range(3):
            outs.append(sysm.track_image(frames[i]))
        seen = list(calls)
        torch.cuda.is_available()  # the watch sees such a call
    assert sysm.frame_graph is None and seen == [] and calls
    for i in range(3):
        ref, r = tsys.frame_step(ref, frames[i], mask, cam, config, False)
        assert int(outs[i]["n_tracked_3d"]) == int(r.n_tracked_3d)
    _assert_same(sysm.state, ref)
