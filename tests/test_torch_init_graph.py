"""The captured init (nrslam_tpu_torch/slam/init_graph.py) on the CPU.

A CUDA graph captures and replays only on the card, so here each segment's
graph is replaced by what its replay runs, the captured body on the static
buffers (``EagerInitGraphs``), and each "capture" records the body's host
tally once, as a capture does; a replay runs the body with its own tally
dropped and adds the recorded one. Over one recovery of the relost cell's
scene (320x240 KB8, 640 features: a reset on a seen frame, black frames
that reset, a seen frame that resets, attempts, the success frame and its
refinement), a ``System`` on these graphs is held to the eager ``System``
bit for bit: every frame's init state, every result its ring keeps (flags,
pose, landmarks, point_ok), the success frame and the bootstrapped map;
the host tally is the same but for the graphs' own replay counts, one
attempt replayed an attempt frame; a result the ring keeps is a copy that
later replays leave alone. The merged host round trips give what one
round trip per decomposition gives. ``InitGraphs`` raises on CPU tensors,
and a CPU ``System`` builds no init graph and calls nothing of
``torch.cuda``.
"""

import numpy as np
import pytest
import torch

from nrslam_tpu_torch.ops import klt
from nrslam_tpu_torch.slam import init_graph
from nrslam_tpu_torch.slam import initializer as ti
from nrslam_tpu_torch.slam import system as tsys
from nrslam_tpu_torch.utils import profiler, tree
from slambench import check, scene
from slambench import run as bench_run

from torch_parity import cuda_calls

torch.set_num_threads(1)

CELL = "kb8-320-p384.relost"
# Loop frames of the recovery (None: black): the first reset, two black
# frames, then the scene until the init succeeds (at the 5th attempt).
FRAMES = (0, None, None, 4, 5, 6, 7, 8, 9, 10)


class _Replay:
    """What a replay of segment ``seg`` runs: its body on the buffers, its
    own tally dropped (``InitGraphs._launch`` adds the recorded one)."""

    def __init__(self, g, seg):
        self.g, self.seg = g, seg

    def replay(self):
        profiler.record(lambda: self.g._body(self.g.views, self.seg))


class EagerInitGraphs(init_graph.InitGraphs):
    """``InitGraphs`` with each graph replaced by ``_Replay``; its capture
    records the body's tally once on a scratch copy of the buffers, in
    segment order, as the warm-up and capture run the bodies."""

    def _build(self):
        scratch = tree.unpack(self.buf.clone(), self.packing)
        for seg in self.kinds:
            _, self.recorded[seg] = profiler.record(
                lambda: self._body(scratch, seg))
            self._graphs[seg] = _Replay(self, seg)


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


def _config():
    _, _, cfg, _, _ = bench_run.load_cell(CELL)
    cfg["InitializerConfig"]["max_features"] = 640
    # Two attempts a flag read: the ring keeps a result while the next
    # frame's segments replay.
    cfg["System"]["init_check_every"] = 2
    return cfg


@pytest.fixture(scope="module")
def frames():
    _, _, _, mix, _ = bench_run.load_cell(CELL)
    cam, _, _ = check.reference_setup(_config(), torch.device("cpu"))
    out = []
    for i in FRAMES:
        if i is None:
            out.append(np.zeros((240, 320), np.uint8))
        else:
            g, _ = scene.render(i, cam, 240, 320, mix)
            out.append(torch.round(g).to(torch.uint8).numpy())
    return out


def _drive(sysm, frames, watch_ring=False):
    """The system over ``frames`` until it tracks: per frame its status,
    init state and ring (copies), the map it bootstrapped, the host tally
    it added and the frames with an init state before them. With
    ``watch_ring``, the results the ring held after a frame are held,
    after the next frame, to the copies taken then: that frame's replays
    and flag read left them alone."""
    before = profiler.tallies()
    out = {"status": [], "init_state": [], "ring": [], "attempts": 0}
    kept = []
    for fr in frames:
        out["attempts"] += sysm.init_state is not None
        o = sysm.track_image(fr)
        out["status"].append(o["status"])
        out["init_state"].append(None if sysm.init_state is None
                                 else _clone(sysm.init_state))
        ring = [r for r, _ in sysm._init_ring]
        out["ring"].append(_clone(ring))
        if watch_ring:
            for r, copy in kept:
                _assert_same(r, copy, "a kept result after the next frame")
            out["watched"] = out.get("watched", 0) + len(kept)
            kept = [(r, _clone(r)) for r in ring]
        if o["status"] == tsys.TRACKING:
            break
    after = profiler.tallies()
    out["tally"] = {k: v - before.get(k, 0) for k, v in after.items()
                    if v != before.get(k, 0)}
    out["state"] = sysm.state
    return out


@pytest.fixture(scope="module")
def runs(frames):
    """The eager System (watched for torch.cuda calls) and the System on
    ``EagerInitGraphs``, over the recovery."""
    cfg = _config()
    eager = bench_run.program_setup(cfg, torch.device("cpu"))
    with cuda_calls() as calls:
        e = _drive(eager, frames)
        seen = list(calls)
        torch.cuda.is_available()  # the watch sees such a call
    e["cuda_calls"], e["watched"] = seen, list(calls)
    e["init_graphs"] = eager.init_graphs
    graph = bench_run.program_setup(cfg, torch.device("cpu"))

    def build(gray, mask):
        if graph.init_graphs is None:
            graph.init_graphs = EagerInitGraphs(
                gray, mask, graph.cam, graph.config.klt_config,
                graph.init_config)
        return graph.init_graphs

    graph._init_graphs = build
    g = _drive(graph, frames, watch_ring=True)
    g["graphs"] = graph.init_graphs
    return e, g


def test_replayed_init_equals_eager_system(runs):
    e, g = runs
    assert e["status"] == g["status"]
    assert e["status"][-1] == tsys.TRACKING
    assert tsys.TRACKING not in e["status"][:-1]
    for k, (a, b) in enumerate(zip(e["init_state"], g["init_state"])):
        assert (a is None) == (b is None), k
        if a is not None:
            _assert_same(a, b, f"init state, frame {k}")
    results = 0
    for k, (a, b) in enumerate(zip(e["ring"], g["ring"])):
        assert len(a) == len(b), k
        for r, s in zip(a, b):
            _assert_same(r, s, f"ring result, frame {k}")
            results += 1
    assert results >= 3
    # The bootstrapped map: pose, landmarks, slots, graph, KLT references.
    _assert_same(e["state"], g["state"], "bootstrapped state")


def test_recovery_exercises_every_segment(runs):
    _, g = runs
    t = g["tally"]
    attempts = g["attempts"]
    assert attempts == len(g["status"]) - 1
    assert t["init_graph.replays.pyramid"] == len(g["status"])
    assert t["init_graph.replays.attempt_a"] == attempts
    for seg in ("attempt_b", "attempt_c", "attempt_d"):
        assert t[f"init_graph.replays.{seg}"] == attempts, seg
    # The first reset, the black frames' and the reset on the first frame
    # seen after them.
    assert t["init_graph.replays.reset"] >= 4
    assert t["init_graph.replays.refine"] >= 1


def test_tally_is_the_eager_tally(runs):
    e, g = runs
    own = {k: v for k, v in g["tally"].items()
           if k.startswith("init_graph.")}
    rest = {k: v for k, v in g["tally"].items() if k not in own}
    assert rest == e["tally"]
    assert e["tally"]["initializer.tracked_frames"] == e["attempts"]
    assert e["tally"]["initializer.refines"] >= 1
    assert {k for k in g["graphs"].recorded["attempt_a"].counts} \
        == {"initializer.tracked_frames"}
    assert g["graphs"].recorded["refine"].counts == {
        "initializer.refines": 1}


def test_ring_keeps_copies(runs, frames):
    """A step's result and pyramid share no storage with the buffers, and
    the ring's entries held still through later replays (``_drive``)."""
    _, g = runs
    assert g["watched"] >= 2
    graphs = g["graphs"]
    base = graphs.buf.untyped_storage().data_ptr()
    gray = torch.as_tensor(frames[3], dtype=torch.float32)
    mask = torch.ones(gray.shape, dtype=torch.bool)
    graphs.pyramid(gray, mask)
    state = graphs.reset()
    assert state is graphs.views.state
    graphs.pyramid(torch.as_tensor(frames[4], dtype=torch.float32), mask)
    perm, gumbel = tsys.ransac_draws(graphs.config, 4, 0, "cpu")
    st, result, pyramid = graphs.step(state, perm, gumbel)
    assert st is graphs.views.state
    for leaf in tree.leaves((result, pyramid)):
        assert leaf.untyped_storage().data_ptr() != base
    kept = _clone((result, pyramid))
    graphs.buf.fill_(255)
    _assert_same((result, pyramid), kept, "after the buffer changed")


def test_merged_round_trips_equal_separate_ones(frames):
    """The 8-point and refit host steps each make one round trip where the
    eager init made two: the E they hand back is the one two round trips,
    one per decomposition, give."""
    cfg = _config()
    sysm = bench_run.program_setup(cfg, torch.device("cpu"))
    icfg, kcfg = sysm.init_config, sysm.config.klt_config
    pyr = [klt.build_pyramid(torch.as_tensor(frames[i], dtype=torch.float32),
                             kcfg) for i in (4, 5)]
    mask = torch.ones((240, 320), dtype=torch.bool)
    state, _ = ti.track_frame(ti.reset(pyr[0], mask, 0, kcfg, icfg), pyr[1],
                              kcfg, icfg)
    perm, gumbel = tsys.ransac_draws(icfg, 4, 0, "cpu")
    sample = ti._sample(sysm.cam, state, icfg, perm, gumbel)
    c = ti.constants("cpu")

    def separate(null_vectors):
        """The two round trips: the SVD on the host, the null vector taken
        on the device, then the null vector's SVD on the host."""
        E = null_vectors()
        u, _, vt = ti._on_host(torch.linalg.svd, E)
        return -(u @ (torch.tensor([1.0, 1.0, 0.0])[:, None] * vt))

    def eight_point_null_vectors():
        _, _, vt = ti._on_host(torch.linalg.svd, sample.A)
        return vt[..., 8, :].reshape(vt.shape[:-2] + (3, 3))

    E = ti._project(*ti._on_host(ti._eight_point_host, sample.A), c)
    _assert_same(E, separate(eight_point_null_vectors), "8-point E")
    scored = ti._score(*ti._on_host(ti._eight_point_host, sample.A), sample,
                       icfg, c)

    def refit_null_vector():
        _, vecs = ti._on_host(torch.linalg.eigh, scored.M)
        return vecs[:, 0].reshape(3, 3)

    Er = ti._project(*ti._on_host(ti._refit_host, scored.M), c)
    _assert_same(Er, separate(refit_null_vector), "refit E")
    assert int(sample.tracked.sum()) >= 100


def test_cpu_system_builds_no_init_graph(runs):
    """The eager System's recovery called nothing of torch.cuda (the watch
    saw the call made after it) and built no InitGraphs."""
    e, _ = runs
    assert e["init_graphs"] is None
    assert e["cuda_calls"] == [] and e["watched"]


def test_init_graphs_raise_on_cpu_tensors(frames):
    cfg = _config()
    sysm = bench_run.program_setup(cfg, torch.device("cpu"))
    gray = torch.as_tensor(frames[0], dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        init_graph.InitGraphs(gray, torch.ones(gray.shape, dtype=torch.bool),
                              sysm.cam, sysm.config.klt_config,
                              sysm.init_config)
