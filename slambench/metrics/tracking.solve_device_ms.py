"""tracking.solve_device_ms: device ms of the stage tracking.solve in a
replayed frame, from its stamp (the device's timer, written by a
one-thread mark the graph carries) to the next stage's: its nodes and the
device's idle between them. The mean per kind weighted by the window's
frames of that kind (the program's tracer; None without it)."""

from slambench.metrics._program import stage_device_ms


def read(rec):
    return stage_device_ms(rec, "tracking.solve")
