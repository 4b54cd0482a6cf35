"""device.idle_pct: 100 x (1 - busy / wall) over the kinds of frame that
the profiled session holds (keyframe, non-keyframe, init): busy is a
profiled frame's device-busy ms, wall an untraced window frame's ms (the
profiler slows the host), each the mean of its kind, weighted by the
window's frames of that kind."""

from slambench.metrics._common import mean, profiled, window_ms


def read(rec):
    busy = wall = 0.0
    for k in ("kf", "nonkf", "init"):
        b, w = mean(r["busy_ms"] for r in profiled(rec, k)), \
            window_ms(rec, k)
        if b is None or not w:
            continue
        busy += len(w) * b
        wall += sum(w)
    return 100.0 * (1.0 - busy / wall) if wall > 0 else None
