"""system.nonkf_ms: the mean ms of the traced run's untraced window frames
that returned keyframe=False, from handing the image to System.track_image
until the pose is on the host (the harness's spans)."""

from slambench.metrics._common import mean, window_ms


def read(rec):
    return mean(window_ms(rec, "nonkf"))
