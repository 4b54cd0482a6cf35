"""tracking.rejected: points with 3D that the joint rejects (counter
tracking.rejected), the mean over the window's steady frames (the
program's tracer; None without it)."""

from slambench.metrics._common import mean
from slambench.metrics._program import records


def read(rec):
    return mean(r["counters"]["tracking.rejected"]
                for r in records(rec, ("kf", "nonkf"))
                if "tracking.rejected" in r["counters"])
