"""The end-to-end arithmetic of slambench/window.py."""

import math
import statistics

from slambench.window import (Frame, failed, frames_per_s, p95_ms,
                              recover_ms, recoveries_ms)

T = "TRACKING"
N = "NOT_INITIALIZED"


def _frames(spec, ms=10.0):
    """spec: (kind, black, status, ms or None) per frame, back to back."""
    out, t = [], 100.0
    for f, (kind, black, status, dur) in enumerate(spec):
        d = (dur if dur is not None else ms) / 1e3
        out.append(Frame(f, kind, black, t, t + d, status))
        t += d + 0.001     # 1 ms of harness between frames
    return out


def test_rate_is_all_frames_over_all_time():
    fr = _frames([("nonkf", False, T, None)] * 9 + [("kf", False, T, 50.0)])
    span = fr[-1].t1 - fr[0].t0
    assert math.isclose(frames_per_s(fr), 10 / span)
    assert math.isclose(span, 0.09 + 0.05 + 0.009)


def test_p95_is_over_every_frame():
    ms = [float(i) for i in range(1, 101)]
    fr = _frames([("nonkf", False, T, m) for m in ms])
    assert math.isclose(p95_ms(fr), statistics.quantiles(ms, n=20)[-1],
                        rel_tol=1e-9)
    assert 95.0 <= p95_ms(fr) <= 96.0


def _cycle(rec_after, visible=16, black=4, first_kind="nonkf"):
    """One blackout cycle: latch, black init frames, visible frames of
    which the first ``rec_after`` are init frames (the last of them
    returns TRACKING) and the rest steady; ``rec_after`` None: never
    recovers."""
    spec = [(first_kind, True, N, None)] + [("init", True, N, None)] * (
        black - 1)
    for i in range(visible):
        if rec_after is None:
            spec.append(("init", False, N, None))
        elif i < rec_after - 1:
            spec.append(("init", False, N, 100.0))
        elif i == rec_after - 1:
            spec.append(("init", False, T, 100.0))
        else:
            spec.append(("nonkf", False, T, None))
    return spec


def test_recover_ms_is_a_sum_over_a_count():
    lead = [("nonkf", False, T, None)] * 3
    fr = _frames(lead + _cycle(4) + _cycle(2))
    rec = recoveries_ms(fr)
    assert len(rec) == 2
    # 4 init frames of 100 ms + 3 ms of harness; 2 + 1
    assert math.isclose(rec[0], 403.0, rel_tol=1e-6)
    assert math.isclose(rec[1], 201.0, rel_tol=1e-6)
    assert math.isclose(recover_ms(fr), (403.0 + 201.0) / 2, rel_tol=1e-6)
    assert failed(fr, relost=True) == 0


def test_incomplete_recovery_fails_its_stretch():
    lead = [("nonkf", False, T, None)] * 3
    fr = _frames(lead + _cycle(None) + _cycle(3))
    assert len(recoveries_ms(fr)) == 1
    # the never-recovered stretch's 16 frames failed, nothing else
    assert failed(fr, relost=True) == 16
    # a stretch still open at the window's close has not failed
    fr = _frames(lead + _cycle(3) + [("nonkf", True, N, None)]
                 + [("init", False, N, None)] * 5)
    assert failed(fr, relost=True) == 0
    assert recover_ms(_frames(lead)) is None


def test_steady_cell_fails_frames_not_tracking():
    fr = _frames([("nonkf", False, T, None)] * 5
                 + [("nonkf", False, "LOST", None)] * 2)
    assert failed(fr, relost=False) == 2
    raised = fr[:3] + [fr[3]._replace(raised=True, status="RAISED")]
    assert failed(raised, relost=False) == 1
