"""frame_graph.lead_ms: from the start of a replayed frame's
nrslam.frame_graph.launch span to its first device stage stamp, on the
host's clock (the device's timer calibrated against it): how long the
device takes to begin a launched graph. The mean per kind weighted by the
window's frames of that kind (the program's tracer; None without it)."""

from slambench.metrics._program import by_kind, stamped


def _lead(r):
    st = stamped(r)
    starts = [s for n, s, _, _, _ in r["spans"]
              if n == "nrslam.frame_graph.launch"]
    if st is None or not starts:
        return None
    return (st[0] - starts[0]) / 1e6


def read(rec):
    return by_kind(rec, _lead)
