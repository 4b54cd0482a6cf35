"""system.replay_idle_ms: a replayed frame's nrslam.system.track_image
span less the stretch from its first device stage stamp to its last, both
on the host's clock: the host's share of a steady frame that the device
does not cover. The mean per kind weighted by the window's frames of that
kind (the program's tracer; None without it)."""

from slambench.metrics._program import ROOT, by_kind, span_ms, stamped


def _idle(r):
    st = stamped(r)
    if st is None:
        return None
    return span_ms(r, ROOT) - (st[1] - st[0]) / 1e6


def read(rec):
    return by_kind(rec, _idle)
