"""init.frame_ms: the mean ms of the traced run's untraced window frames
handed over while the system was not initialised (slam/initializer.py
through System._initialize), each until its device work has finished."""

from slambench.metrics._common import mean, window_ms


def read(rec):
    return mean(window_ms(rec, "init"))
