"""map.recyclable_frac: the mean over the window's steady frames of
(P - map.slots_3d) / P, the share of the map's P slots that hold no 3D
point at the frame's end, which add_keyframe_features may still fill (the
starvation gauge; the program's tracer; None without it)."""

from slambench.metrics._common import mean
from slambench.metrics._program import records


def read(rec):
    P = rec["P"]
    return mean((P - r["counters"]["map.slots_3d"]) / P
                for r in records(rec, ("kf", "nonkf"))
                if "map.slots_3d" in r["counters"])
