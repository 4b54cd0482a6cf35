"""What the per-layer readers share: the window's frames and the profiled
frames by kind. A reader returns None where it finds nothing to read."""

from __future__ import annotations

import math


def mean(xs):
    xs = list(xs)
    return math.fsum(xs) / len(xs) if xs else None


def window_ms(rec, kind):
    """ms of the window's frames of ``kind`` (the harness's spans)."""
    return [fr.ms for fr in rec["window"] if fr.kind == kind]


def profiled(rec, kind):
    return [r for r in rec["profiled"] if r["kind"] == kind]


def weighted_by_kind(rec, field, kinds=("kf", "nonkf")):
    """The mean of a profiled frame's ``field`` per kind, weighted by the
    window's count of frames of that kind."""
    num = den = 0.0
    for k in kinds:
        m = mean(r[field] for r in profiled(rec, k))
        n = len(window_ms(rec, k))
        if m is None or n == 0:
            continue
        num += n * m
        den += n
    return num / den if den else None
