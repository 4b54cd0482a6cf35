"""init.lapack_ms: the summed nrslam.init.lapack spans of an init frame,
the host's LAPACK calls (the small SVDs and the refit's eigh); the mean
over the window's init frames that ran the init (the program's tracer;
None without it)."""

from slambench.metrics._common import mean
from slambench.metrics._program import records, span_ms


def read(rec):
    return mean(span_ms(r, "nrslam.init.lapack") or 0.0
                for r in records(rec, ("init",))
                if span_ms(r, "nrslam.system.init") is not None)
