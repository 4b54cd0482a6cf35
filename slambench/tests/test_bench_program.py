"""The readers of the program's own records (slambench/metrics/_program.py
and the readers that use it) on hand-made records; slambench/program.py's
windows on a stub system that records into the real tracer, and its
attribution of device idle to the program's spans."""

import math

import pytest
import torch

from slambench import program, run
from slambench.metrics import _program
from slambench.window import Frame

MS = 1_000_000   # ns


def _span(name, a, b, parent):
    return (name, int(a * MS), int(b * MS), parent, 0)


def _steady(kind, launch, stages, counters, nodes, root=40.0):
    """A replayed frame: the root span, the replay span in it and the
    launch span in that; stages as (name, start ms, end ms)."""
    spans = [_span(_program.ROOT, 0.0, root, None),
             _span("nrslam.system.replay", 1.0, root - 1.0, 0),
             _span("nrslam.frame_graph.launch", *launch, 1)]
    return {"frame": 0, "kind": kind, "spans": spans, "counters": counters,
            "device": {"stages": [(n, int(a * MS), int(b * MS))
                                  for n, a, b in stages],
                       "nodes": nodes,
                       "stage_nodes": {n: 10 for n, _, _ in stages}}}


def _records():
    a = _steady("nonkf", (5.0, 6.0),
                [("tracking.klt", 6.5, 20.0), ("tracking.solve", 20.0, 23.0),
                 ("tracking.reuse", 23.0, 30.0),
                 ("mapping.triangulation", 30.0, 39.0)],
                {"tracking.reused": 2, "tracking.reuse_candidates": 4,
                 "mapping.tri_candidates": 10, "mapping.triangulated": 5,
                 "map.slots_3d": 300, "tracking.rejected": 3}, 20000)
    b = _steady("nonkf", (4.0, 7.0),
                [("tracking.klt", 8.0, 18.0), ("tracking.solve", 18.0, 22.0),
                 ("tracking.reuse", 22.0, 27.0),
                 ("mapping.triangulation", 27.0, 36.0)],
                {"tracking.reused": 0, "tracking.reuse_candidates": 4,
                 "mapping.tri_candidates": 0, "mapping.triangulated": 0,
                 "map.slots_3d": 200, "tracking.rejected": 1}, 20000)
    c = _steady("kf", (3.0, 4.0),
                [("tracking.klt", 5.0, 17.0), ("tracking.solve", 17.0, 20.0),
                 ("tracking.reuse", 20.0, 26.0), ("mapping.ba", 26.0, 30.0)],
                {"tracking.reused": 1, "tracking.reuse_candidates": 2,
                 "map.slots_3d": 250, "tracking.rejected": 2}, 15000,
                root=32.0)
    d = {"frame": 3, "kind": "init", "counters": {}, "spans": [
        _span(_program.ROOT, 0.0, 102.0, None),
        _span("nrslam.system.init", 1.0, 101.0, 0),
        _span("nrslam.init.ransac", 2.0, 50.0, 1),
        _span("nrslam.init.sync", 3.0, 9.0, 2),
        _span("nrslam.init.lapack", 10.0, 15.0, 2),
        _span("nrslam.init.sync", 60.0, 64.0, 1)]}
    # A black init frame whose init span holds no attempt.
    e = {"frame": 4, "kind": "init", "counters": {}, "spans": [
        _span(_program.ROOT, 0.0, 11.0, None),
        _span("nrslam.system.init", 0.5, 10.5, 0)]}
    return [a, b, c, d, e]


def _rec(program=True):
    # The window: 3 non-keyframes, 1 keyframe, 2 init frames.
    kinds = ["nonkf", "nonkf", "nonkf", "kf", "init", "init"]
    window = [Frame(i, k, False, float(i), i + 0.03, "TRACKING")
              for i, k in enumerate(kinds)]
    rec = {"window": window, "profiled": [], "P": 400,
           "peak": {"flops": 67e12, "bytes": 3.35e12}}
    if program:
        rec["program"] = _records()
    return rec


def _read(name, rec):
    return run.metric_reader(name)(rec)


def _kinds(nonkf, kf):
    """The window's weighting: 3 non-keyframes, 1 keyframe."""
    return (3 * nonkf + kf) / 4


@pytest.mark.parametrize("program_field", [None, []])
def test_no_program_records_read_none(program_field):
    rec = _rec(program=False)
    if program_field is not None:
        rec["program"] = program_field
    for name in program.PROGRAM_METRICS:
        assert _read(name, rec) is None, name
    assert _program.summary(rec) == []


EXPECTED = {
    "frame_graph.launch_ms": _kinds((1.0 + 3.0) / 2, 1.0),
    "system.replay_idle_ms": _kinds(((40 - 32.5) + (40 - 28.0)) / 2,
                                    32 - 25.0),
    "frame_graph.nodes_per_frame": _kinds(20000, 15000),
    "frame_graph.lead_ms": _kinds((1.5 + 4.0) / 2, 2.0),
    "tracking.klt_device_ms": _kinds((13.5 + 10.0) / 2, 12.0),
    "tracking.solve_device_ms": _kinds((3.0 + 4.0) / 2, 3.0),
    "tracking.reuse_device_ms": _kinds((7.0 + 5.0) / 2, 6.0),
    "mapping.triangulation_device_ms": (9.0 + 9.0) / 2,
    "mapping.ba_device_ms": 4.0,
    # The black frame's init span (10 ms) holds no sync or LAPACK.
    "init.issue_ms": ((100.0 - 10.0 - 5.0) + 10.0) / 2,
    "init.sync_ms": 10.0 / 2,
    "init.lapack_ms": 5.0 / 2,
    "tracking.reuse_yield": 3 / 10,
    "mapping.triangulation_yield": 5 / 10,
    "map.recyclable_frac": (100 / 400 + 200 / 400 + 150 / 400) / 3,
    "tracking.rejected": 2.0,
}


def test_readers_on_hand_made_records():
    assert set(EXPECTED) == set(program.PROGRAM_METRICS)
    rec = _rec()
    for name, want in EXPECTED.items():
        got = _read(name, rec)
        assert got is not None and math.isclose(got, want, rel_tol=1e-9), \
            (name, got, want)


def test_yields_without_candidates_read_none():
    rec = _rec()
    for r in rec["program"]:
        for k in ("tracking.reuse_candidates", "mapping.tri_candidates"):
            if k in r["counters"]:
                r["counters"][k] = 0
    assert _read("tracking.reuse_yield", rec) is None
    assert _read("mapping.triangulation_yield", rec) is None


def test_self_times_and_summary():
    d = _records()[3]
    own = _program.self_ms(d)
    assert math.isclose(own["nrslam.system.init"], 100.0 - 48.0 - 4.0)
    assert math.isclose(own["nrslam.init.ransac"], 48.0 - 6.0 - 5.0)
    assert math.isclose(own["nrslam.init.sync"], 6.0 + 4.0)
    assert math.isclose(own[_program.ROOT], 2.0)
    lines = _program.summary(_rec())
    assert [ln.split(" (")[0] for ln in lines] == [
        "[trace] init", "[trace] nonkf", "[trace] kf"]
    assert "tracking.klt 11.750 / 10" in lines[1]
    assert "counters a frame" in lines[1] and "20000 nodes" in lines[1]


def test_program_refuses_a_bad_window_list():
    assert program.main(["--workload", "kb8-320-p384.relost", "--seed", "1",
                         "--seconds", "1", "--windows", "sideways"]) == 2


class _Stub:
    """A system whose frames are the real tracer's spans and counts: two
    init frames, then keyframes and non-keyframes in turn."""

    def __init__(self):
        self.status, self.state, self.n = "NOT_INITIALIZED", None, 0

    def trajectory_pose(self):
        return None

    def track_image(self, img):
        from nrslam_tpu_torch.utils import profiler as tracer

        with tracer.span(tracer.FRAME):
            self.n += 1
            if self.n <= 2:
                tracer.note(kind="init")
                with tracer.span("nrslam.system.init"), \
                        tracer.span("nrslam.init.sync"):
                    pass
                self.status = "TRACKING" if self.n == 2 else self.status
                return {"status": self.status}
            kf = self.n % 2 == 0
            tracer.note(kind="kf" if kf else "nonkf")
            tracer.device_count("map.slots_3d", torch.arange(40) < 10)
            return {"status": "TRACKING", "keyframe": kf}


class _Stream:
    def frame(self, f):
        return None

    def is_black(self, f):
        return False


def test_windows_read_the_traced_one():
    from nrslam_tpu_torch.utils import profiler as tracer

    base = {"profiled": [], "P": 40,
            "peak": {"flops": 67e12, "bytes": 3.35e12}}
    lines = []
    on, off = program.windows(_Stub(), _Stream(), 0, 0.05,
                              torch.device("cpu"), [tracer.tracing, None],
                              base, (), lines.append)
    assert on["tracer"] and not off["tracer"] and "metrics" not in off
    m = on["metrics"]
    assert math.isclose(m["map.recyclable_frac"], 0.75)
    assert m["init.sync_ms"] is not None and m["init.lapack_ms"] == 0.0
    assert m["frame_graph.launch_ms"] is None
    assert m["tracking.rejected"] is None
    assert on["means"]["init.frame_ms"] is not None
    assert off["means"]["init.frame_ms"] is None
    assert [ln.split(" (")[0] for ln in lines if ln.startswith("[trace]")
            ] == ["[trace] init", "[trace] nonkf", "[trace] kf"]
    assert tracer.span("nrslam.off") is tracer.NO_SPAN


def test_span_gaps_put_idle_under_the_innermost_span():
    frames = [Frame(0, "init", False, 0.0, 1.0, "NOT_INITIALIZED"),
              Frame(1, "nonkf", False, 1.0, 2.0, "TRACKING")]
    ev = [("slambench.frame.0", 0, 100, False),
          ("slambench.frame.0", 0, 100, True),
          ("nrslam.system.init", 5, 95, False),
          ("nrslam.system.init", 5, 95, True),
          ("nrslam.init.sync", 40, 60, False),
          ("aten::mul", 10, 12, False),
          ("kernel_a", 0, 30, True), ("kernel_b", 20, 45, True),
          ("kernel_c", 55, 90, True),
          ("slambench.frame.1", 100, 200, False),
          ("nrslam.system.replay", 101, 185, False),
          ("nrslam.frame_graph.launch", 101, 115, False),
          ("void nrslam::trace_mark_kernel(long long*)", 112, 113, True),
          ("kernel_d", 114, 150, True), ("kernel_e", 160, 175, True),
          ("void nrslam::trace_mark_kernel(long long*)", 178, 179, True)]
    got = program.span_gaps(ev, frames)
    # Frame 0: idle 45-55 (inside sync), 90-100 (middle 95: init's end);
    # frame 1: 100-112 and 113-114 (launch), 150-160 and 175-178
    # (replay), 179-200 (middle 189.5: after the replay).
    want = {"init: nrslam.init.sync": 10, "init: nrslam.system.init": 10,
            "nonkf: nrslam.frame_graph.launch": 13,
            "nonkf: nrslam.system.replay": 13,
            "nonkf: outside the program": 21}
    idle = dict(got["idle_by_span"])
    assert set(idle) == set(want)
    for k, us in want.items():
        assert math.isclose(idle[k], us / 1e6), k
    g = got["graph"]
    assert list(g) == ["nonkf"] and g["nonkf"]["frames"] == 1
    assert math.isclose(g["nonkf"]["marks_ms"], 67 / 1e3)
    assert math.isclose(g["nonkf"]["busy_ms"], 53 / 1e3)
