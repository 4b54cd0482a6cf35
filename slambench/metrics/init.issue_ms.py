"""init.issue_ms: an init frame's nrslam.system.init span less its
nrslam.init.sync and nrslam.init.lapack spans: the host's Python and
launches. The mean over the window's init frames (the program's tracer;
None without it)."""

from slambench.metrics._common import mean
from slambench.metrics._program import records, span_ms


def _issue(r):
    init = span_ms(r, "nrslam.system.init")
    if init is None:
        return None
    return init - (span_ms(r, "nrslam.init.sync") or 0.0) \
        - (span_ms(r, "nrslam.init.lapack") or 0.0)


def read(rec):
    return mean(v for v in map(_issue, records(rec, ("init",)))
                if v is not None)
