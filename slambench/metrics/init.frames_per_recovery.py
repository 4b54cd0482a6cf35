"""init.frames_per_recovery: the frames handed over while the system was not
initialised in each recovery completed in the traced run's untraced window
(from the frame after the LOST latch to the first that is TRACKING again,
slambench/window.py), the mean over those recoveries."""

from slambench import window
from slambench.metrics._common import mean


def read(rec):
    return mean(window.recovery_init_frames(rec["window"]))
