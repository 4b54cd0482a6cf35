"""init.sync_ms: the summed nrslam.init.sync spans of an init frame, the
host's waits on the device (copies to the host, flags read); the mean
over the window's init frames that ran the init (the program's tracer;
None without it)."""

from slambench.metrics._common import mean
from slambench.metrics._program import records, span_ms


def read(rec):
    return mean(span_ms(r, "nrslam.init.sync") or 0.0
                for r in records(rec, ("init",))
                if span_ms(r, "nrslam.system.init") is not None)
