"""tracking.reuse_yield: points point reuse re-acquired over the points it
tried (counters tracking.reused / tracking.reuse_candidates, summed over
the window's steady frames; the program's tracer; None without it or
without a candidate)."""

from slambench.metrics._program import ratio


def read(rec):
    return ratio(rec, "tracking.reused", "tracking.reuse_candidates")
