"""The program's own spans, stage stamps and counters
(nrslam_tpu_torch/utils/profiler.py) on the CPU.

With no tracer on, ``span``, ``stage`` and ``device_count`` record nothing
and open no ``record_function``. With one, spans nest with their parents
and self times, and mirror into a ``torch.profiler`` session. A capture's
``Stamps`` (here with a host mark in place of the card's
``nrslam_trace_mark``) takes the stages of both frame kinds in order and
the same counters the eager frame counts. Each counter equals a recount
made from the states around its step, and a CPU ``System`` from frame 0
gives one record per ``track_image`` call, with the init's stage spans,
and counters that agree with the states before and after each frame.
"""

import itertools
import math

import pytest
import torch

from nrslam_tpu_torch import bench_problem
from nrslam_tpu_torch.datasets import synthetic
from nrslam_tpu_torch.geometry import cameras, se3
from nrslam_tpu_torch.ops import klt
from nrslam_tpu_torch.slam import initializer, mapping, system, tracking
from nrslam_tpu_torch.slam import state as state_mod
from nrslam_tpu_torch.slam.state import Config
from nrslam_tpu_torch.utils import profiler

torch.set_num_threads(1)

STEADY_NONKF = ["frame.pyramid", "tracking.klt", "tracking.solve",
                "tracking.reuse", "tracking.bookkeeping",
                "mapping.triangulation", "frame.writeback"]
STEADY_KF = ["frame.pyramid", "tracking.klt", "tracking.solve",
             "tracking.reuse", "tracking.keyframe", "tracking.bookkeeping",
             "mapping.ba", "frame.writeback"]


def _bench():
    return bench_problem.build_bench_problem(128, 120, 160, 64, device="cpu")


def _names(events):
    return {e.name for e in events}


def test_off_records_nothing():
    assert profiler.span("nrslam.a") is profiler.span("nrslam.b") \
        is profiler.NO_SPAN
    flags = torch.tensor([True, False, True])
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiler.span(profiler.FRAME), profiler.span("nrslam.inner"):
            profiler.stage("tracking.klt")
            profiler.device_count("tracking.reused", flags)
            profiler.note(kind="nonkf")
            torch.ones(4).sum()
    names = _names(prof.events())
    assert "aten::sum" in names
    assert not any(n.startswith("nrslam") for n in names)
    assert profiler.frames() == []
    # A tracer made but not turned on records no span either.
    t = profiler.TimeProfiler()
    with profiler.span("nrslam.x"):
        pass
    assert t.frames() == [] and t.statistics() == {}


def test_spans_nest_with_parents_and_self_times():
    with profiler.tracing() as t:
        assert profiler.span("nrslam.on") is not profiler.NO_SPAN
        with pytest.raises(RuntimeError, match="already on"):
            with profiler.tracing():
                pass
        with profiler.span("nrslam.loose"):
            pass
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with profiler.span(profiler.FRAME):
                profiler.note(kind="kf")
                with profiler.span("nrslam.a"):
                    with profiler.span("nrslam.b"):
                        sum(range(20000))
                    sum(range(20000))
                with profiler.span("nrslam.c"):
                    sum(range(20000))
                profiler.device_count("map.slots_used",
                                      torch.tensor([True, True, False]))
                profiler.device_count("map.slots_used",
                                      torch.tensor([True]))
        with profiler.span(profiler.FRAME):
            pass
        recs = t.frames()
        assert t.frames() == []
    assert profiler.span("nrslam.off") is profiler.NO_SPAN
    assert {"nrslam.a", "nrslam.b", "nrslam.c",
            profiler.FRAME} <= _names(prof.events())

    assert [r["frame"] for r in recs] == [0, 1]
    r = recs[0]
    assert r["kind"] == "kf" and r["counters"] == {"map.slots_used": 3}
    names = [s[0] for s in r["spans"]]
    assert names == [profiler.FRAME, "nrslam.a", "nrslam.b", "nrslam.c"]
    parents = [s[3] for s in r["spans"]]
    assert parents == [None, 0, 1, 0]
    assert all(s[4] == 0 for s in r["spans"])
    for name, start, end, parent, _ in r["spans"]:
        assert start <= end
        if parent is not None:
            p = r["spans"][parent]
            assert p[1] <= start and end <= p[2]
    dur = {s[0]: s[2] - s[1] for s in r["spans"]}
    st = t.statistics()
    want = {profiler.FRAME: (dur[profiler.FRAME] - dur["nrslam.a"]
                             - dur["nrslam.c"]),
            "nrslam.a": dur["nrslam.a"] - dur["nrslam.b"],
            "nrslam.b": dur["nrslam.b"], "nrslam.c": dur["nrslam.c"]}
    for name in ("nrslam.a", "nrslam.b", "nrslam.c"):
        assert st[name]["count"] == 1
        assert math.isclose(st[name]["self_ms"], want[name] / 1e6,
                            rel_tol=1e-9)
    assert st[profiler.FRAME]["count"] == 2
    assert st["nrslam.loose"]["count"] == 1
    assert 0 < st["nrslam.a"]["self_ms"] < st["nrslam.a"]["mean_ms"]


class _HostMark:
    """A capture's mark and node count on the host: stamps from a counter
    that only increases, nodes as if every mark added three."""

    def __init__(self):
        self.clock = itertools.count(1000, 7)
        self.n = 0

    def mark(self, buf, slot):
        buf[slot] = next(self.clock)

    def nodes(self, device):
        self.n += 3
        return self.n


@pytest.mark.parametrize("kf", [False, True])
def test_stamps_take_stages_in_order_and_the_eager_counts(kf):
    state, frames, mask, cam, config = _bench()
    host = _HostMark()
    stamps = profiler.Stamps("cpu", host.mark, host.nodes)
    with profiler.recording(stamps):
        cap = system.frame_step(state, frames[0], mask, cam, config, kf)
        stamps.end()
    assert stamps.stages == (STEADY_KF if kf else STEADY_NONKF)
    assert stamps.marks[-1][0] == profiler.END
    reading = stamps.read()
    assert [s[0] for s in reading["stages"]] == stamps.stages
    assert all(a < b for _, a, b in reading["stages"])
    assert reading["nodes"] == 3 * len(stamps.marks)
    assert reading["stage_nodes"] == dict.fromkeys(stamps.stages, 3)

    with profiler.tracing() as t:
        with profiler.span(profiler.FRAME):
            eager = system.frame_step(state, frames[0], mask, cam, config,
                                      kf)
        (rec,) = t.frames()
    assert reading["counters"] == rec["counters"]
    assert set(rec["counters"]) == (
        {"tracking.rejected", "tracking.reuse_candidates", "tracking.reused",
         "map.slots_used", "map.slots_3d"}
        | ({"keyframe.new_features"} if kf else
           {"mapping.tri_candidates", "mapping.triangulated"}))
    assert torch.equal(cap[0].positions, eager[0].positions)
    # A quiet recording drops every mark and count, eager ones too.
    with profiler.tracing() as t:
        with profiler.span(profiler.FRAME), \
                profiler.recording(profiler.QUIET):
            system.frame_step(state, frames[0], mask, cam, config, kf)
        assert t.frames()[0]["counters"] == {}


def _counted(fn):
    """``fn()`` under a tracer, in one frame: (its result, the counters)."""
    with profiler.tracing() as t:
        with profiler.span(profiler.FRAME):
            out = fn()
        return out, t.frames()[0]["counters"]


def _n(x) -> int:
    return int(torch.sum(x.to(torch.int64)))


@pytest.fixture(scope="module")
def system_run():
    """A CPU System from frame 0 under a tracer, a keyframe every 2 steady
    frames: its outputs, the states before and after each call, the
    records, the frames, camera and config."""
    fx = 125.0
    scene = synthetic.SceneConfig(height=120, width=160, fx=fx, fy=fx,
                                  relief=1.0, motion_translation=0.05)
    cam = synthetic.camera(scene, device="cpu")
    config = Config(max_points=128, max_new_keypoints=48,
                    rad_per_pixel=1.0 / fx, keyframe_every=2)
    init_config = initializer.InitializerConfig(
        max_features=192, min_matches=30, min_triangulated=25,
        rad_per_pixel=1.0 / fx, n_hypotheses=48)
    s = system.System(cam, config, init_config)
    run = {"outs": [], "states": [], "grays": [], "cam": cam,
           "config": config}
    with profiler.tracing() as t:
        for i in range(10):
            gray = synthetic.render_frame(i, scene, device="cpu")[0]
            before = s.state
            run["outs"].append(s.track_image(gray))
            run["states"].append((before, s.state))
            run["grays"].append(gray)
        run["recs"] = t.frames()
    return run


def _kind(out):
    if "keyframe" not in out:
        return "init"
    return "kf" if out["keyframe"] else "nonkf"


def _spans(rec):
    return [sp[0] for sp in rec["spans"]]


def test_system_records_one_frame_per_call(system_run):
    outs, recs = system_run["outs"], system_run["recs"]
    assert len(recs) == len(outs)
    assert [r["frame"] for r in recs] == list(range(len(outs)))
    assert [r["kind"] for r in recs] == [_kind(o) for o in outs]
    kinds = [r["kind"] for r in recs]
    assert "init" in kinds and "kf" in kinds and "nonkf" in kinds
    for r in recs:
        names = _spans(r)
        assert names[0] == profiler.FRAME and r["spans"][0][3] is None
        assert {"nrslam.system.preprocess", "nrslam.system.mask"} <= set(
            names)
        if r["kind"] == "init":
            assert "nrslam.system.init" in names
        else:
            # The CPU steps frame_step eagerly: no replay, no stamps.
            assert {"nrslam.system.frame_step",
                    "nrslam.system.lost_read"} <= set(names)
            assert "device" not in r


def test_system_records_the_init_stages(system_run):
    outs, recs = system_run["outs"], system_run["recs"]
    inits = [r for r in recs if r["kind"] == "init"]
    assert "nrslam.init.reset" in _spans(inits[0])
    attempt = {"nrslam.init.klt", "nrslam.init.kmeans", "nrslam.init.ransac",
               "nrslam.init.reconstruct", "nrslam.init.lapack",
               "nrslam.init.sync"}
    for r in inits[1:]:
        assert attempt <= set(_spans(r))
    last = inits[-1]
    assert outs[len(inits) - 1]["status"] == system.TRACKING
    assert {"nrslam.init.refine", "nrslam.system.bootstrap_map"} <= set(
        _spans(last))
    # Every sync and LAPACK span lies inside the frame's init span.
    for r in inits[1:]:
        sp = r["spans"]
        (init_i,) = [i for i, s in enumerate(sp)
                     if s[0] == "nrslam.system.init"]
        for s in sp:
            if s[0] in ("nrslam.init.sync", "nrslam.init.lapack"):
                p = s[3]
                while p is not None and p != init_i:
                    p = sp[p][3]
                assert p == init_i


def test_system_counters_equal_a_recount(system_run):
    outs, states, recs = (system_run[k] for k in ("outs", "states", "recs"))
    steady = 0
    for out, (before, after), r in zip(outs, states, recs):
        if r["kind"] == "init" or bool(after.lost):
            continue
        steady += 1
        c = r["counters"]
        assert c["map.slots_used"] == _n(after.slot_used)
        assert c["map.slots_3d"] == _n(after.slot_used & after.has_3d)
        if r["kind"] == "kf":
            assert c["keyframe.new_features"] == int(
                after.next_track_id - before.next_track_id)
        else:
            assert c["mapping.triangulated"] == _n(
                after.slot_used & (after.status == klt.JUST_TRIANGULATED))
            assert c["mapping.triangulated"] == _n(
                after.has_3d & ~before.has_3d)
        assert 0 <= c["tracking.reused"] <= c["tracking.reuse_candidates"]
    assert steady >= 3


def test_counters_equal_a_recount_at_each_step(system_run):
    """Each counter against a recount from the states around its step,
    from the System's steady states."""
    cam, config = system_run["cam"], system_run["config"]
    totals = 0
    for out, (state, after), gray in zip(system_run["outs"],
                                         system_run["states"],
                                         system_run["grays"]):
        if "keyframe" not in out or bool(after.lost):
            continue
        kf = out["keyframe"]
        mask = torch.ones(gray.shape, dtype=torch.bool)
        pyramid = klt.build_pyramid(gray, config.klt_config)
        s = tracking.data_association(
            tracking.update_triangulated_points(state), pyramid, config)

        seen = {}

        def joint(*args, **kw):
            seen["res"] = tracking.WHOLE.joint(*args, **kw)
            return seen["res"]

        solves = tracking.WHOLE._replace(joint=joint)
        s2, c = _counted(lambda: tracking.track_camera_and_deformation(
            s, cam, config, solves=solves))
        res = seen["res"]
        with3d = state_mod.tracked_with_3d(s)
        assert c == {"tracking.rejected": _n(
            with3d & ~(res.reproj_inlier & res.deform_ok))}

        s3, c = _counted(lambda: tracking.point_reuse(s2, pyramid, cam,
                                                      config))
        # Reacquired: a slot not usable before that reuse tracks with 3D.
        reused = (s3.status == klt.TRACKED_WITH_3D) \
            & (s2.status != klt.TRACKED_WITH_3D)
        usable = klt.is_usable(s2.status) & s2.slot_used
        h, w = pyramid[0][0].shape
        Xc = se3.apply(s2.Tcw, s2.positions)
        uv = cameras.project(cam, Xc)
        inside = ((Xc[:, 2] > 0) & (uv[:, 0] >= 0) & (uv[:, 0] < w)
                  & (uv[:, 1] >= 0) & (uv[:, 1] < h)
                  & torch.isfinite(uv).all(dim=-1))
        cand = s2.slot_used & s2.has_3d & ~usable & inside
        assert c == {"tracking.reuse_candidates": _n(cand),
                     "tracking.reused": _n(reused)}
        assert _n(reused & ~cand) == 0

        if kf:
            s4, c = _counted(lambda: tracking.add_keyframe_features(
                s3, pyramid, mask, config))
            assert c == {"keyframe.new_features":
                         int(s4.next_track_id - s3.next_track_id)}
        else:
            s4 = state_mod.insert_temporal_snapshot(s3)
            cand = mapping.assemble_triangulation_inputs(s4, config)[0]
            s5, c = _counted(lambda: mapping.landmark_triangulation(
                s4, cam, config))
            new = s5.has_3d & ~s4.has_3d
            assert _n(new ^ (s5.slot_used
                             & (s5.status == klt.JUST_TRIANGULATED))) == 0
            assert c == {"mapping.tri_candidates": _n(cand),
                         "mapping.triangulated": _n(new)}
        totals += sum(c.values())
    assert totals > 0
