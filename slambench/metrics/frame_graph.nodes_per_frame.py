"""frame_graph.nodes_per_frame: the nodes of the captured graph of a
replayed frame's kind, counted at capture (cudaGraphGetNodes at the end
mark: exact, no profiler), the mean per kind weighted by the window's
frames of that kind (the program's tracer; None without it)."""

from slambench.metrics._program import by_kind


def read(rec):
    return by_kind(rec, lambda r: r.get("device", {}).get("nodes"))
