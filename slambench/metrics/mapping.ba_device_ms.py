"""mapping.ba_device_ms: device ms of the stage mapping.ba (keyframes
only: the window BA and the map refresh) in a replayed frame, from its
stamp to the next stage's, the mean over the window's keyframes (the
program's tracer; None without it)."""

from slambench.metrics._program import stage_device_ms


def read(rec):
    return stage_device_ms(rec, "mapping.ba", ("kf",))
