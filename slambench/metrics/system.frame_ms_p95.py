"""system.frame_ms_p95: the 95th percentile of the ms of every frame of the
traced run's untraced window, init frames with the rest (each from handing
its image to System.track_image until its pose is on the host;
slambench/window.py)."""

from slambench import window


def read(rec):
    return window.p95_ms(rec["window"]) if rec["window"] else None
