"""frame_graph.kernels_per_frame: device kernels (copies and fills left
out) of a replayed frame in the profiled session, the mean per kind
weighted by the window's frames of that kind. The profiler can lose
events, so this is a lower bound."""

from slambench.metrics._common import weighted_by_kind


def read(rec):
    return weighted_by_kind(rec, "kernels")
