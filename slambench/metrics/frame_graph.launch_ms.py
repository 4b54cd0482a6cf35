"""frame_graph.launch_ms: host ms of the span nrslam.frame_graph.launch
(the replay call, cudaGraphLaunch) a replayed frame of the window, the
mean per kind weighted by the window's frames of that kind (the program's
tracer; None without it)."""

from slambench.metrics._program import by_kind, span_ms


def read(rec):
    return by_kind(rec, lambda r: span_ms(r, "nrslam.frame_graph.launch"))
