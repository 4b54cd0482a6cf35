"""frame_graph.device_ms: device-busy ms of a replayed frame (the union of
its device operations' intervals in the profiled session), the mean per
kind weighted by the window's frames of that kind."""

from slambench.metrics._common import weighted_by_kind


def read(rec):
    return weighted_by_kind(rec, "busy_ms")
