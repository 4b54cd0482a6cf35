"""mapping.triangulation_yield: points triangulated over the candidates
(counters mapping.triangulated / mapping.tri_candidates, summed over the
window's non-keyframes; the program's tracer; None without it or
without a candidate)."""

from slambench.metrics._program import ratio


def read(rec):
    return ratio(rec, "mapping.triangulated", "mapping.tri_candidates",
                 ("nonkf",))
