"""What the readers of the program's own records share: the frame records
that nrslam_tpu_torch's tracer kept over the window
(``utils.profiler.frames``, passed as ``rec["program"]``), one per
``System.track_image`` call, with its kind (``init``, ``kf``, ``nonkf``),
its spans (name, start ns, end ns, parent, frame) on the host's clock,
its counters and, for a replayed frame, its device stage stamps on the
same clock. A reader returns None where it finds nothing to read: a
program without a tracer leaves ``rec["program"]`` out."""

from __future__ import annotations

import math
from collections import defaultdict

from slambench.metrics._common import mean, window_ms

ROOT = "nrslam.system.track_image"
STEADY = ("kf", "nonkf")


def records(rec, kinds=None) -> list:
    """The program's frame records (of ``kinds``, if given)."""
    out = rec.get("program") or []
    return [r for r in out if kinds is None or r.get("kind") in kinds]


def span_ms(r, name):
    """Summed ms of a record's spans named ``name``; None where it has
    none."""
    ds = [e - s for n, s, e, _, _ in r["spans"] if n == name]
    return math.fsum(ds) / 1e6 if ds else None


def self_ms(r) -> dict:
    """Span name -> summed self ms in a record (a span's duration less
    what its child spans cover)."""
    spans = r["spans"]
    own = [e - s for _, s, e, _, _ in spans]
    for _, s, e, parent, _ in spans:
        if parent is not None:
            own[parent] -= e - s
    out = defaultdict(float)
    for (name, *_), ns in zip(spans, own):
        out[name] += ns / 1e6
    return dict(out)


def stage_ms(r) -> dict:
    """Stage name -> device ms from its stamp to the next in a replayed
    record; empty where the record has no device reading."""
    out = defaultdict(float)
    for name, s, e in r.get("device", {}).get("stages", []):
        out[name] += (e - s) / 1e6
    return dict(out)


def stamped(r):
    """(first stamp, last stamp) in ns on the host's clock, or None."""
    st = r.get("device", {}).get("stages")
    return (st[0][1], st[-1][2]) if st else None


def by_kind(rec, value, kinds=STEADY):
    """The mean of ``value(record)`` (None: left out) per kind, weighted by
    the window's count of frames of that kind, as
    ``_common.weighted_by_kind`` weighs the profiled frames."""
    num = den = 0.0
    for k in kinds:
        m = mean(v for v in (value(r) for r in records(rec, (k,)))
                 if v is not None)
        n = len(window_ms(rec, k))
        if m is None or n == 0:
            continue
        num += n * m
        den += n
    return num / den if den else None


def stage_device_ms(rec, stage, kinds=STEADY):
    """A stage's device ms a replayed frame, by kind (``by_kind``)."""
    return by_kind(rec, lambda r: stage_ms(r).get(stage), kinds)


def ratio(rec, num, den, kinds=STEADY):
    """Sum of counter ``num`` over sum of counter ``den`` over the records
    of ``kinds``; None where the denominator sums to 0."""
    a = b = 0
    for r in records(rec, kinds):
        c = r["counters"]
        if num in c and den in c:
            a += c[num]
            b += c[den]
    return a / b if b else None


def summary(rec) -> list:
    """The ``[trace]`` lines, one per kind: self ms a frame by span, device
    ms and graph nodes by stage, and the counters' means."""
    lines = []
    for k in ("init", "nonkf", "kf"):
        rs = records(rec, (k,))
        if not rs:
            continue
        own = defaultdict(float)
        for r in rs:
            for name, ms in self_ms(r).items():
                own[name] += ms / len(rs)
        parts = [f"{k} ({len(rs)} frames): self ms a frame "
                 + ", ".join(f"{n} {ms:.3f}" for n, ms in
                             sorted(own.items(), key=lambda kv: -kv[1]))]
        dev = [r for r in rs if "device" in r]
        if dev:
            ms = defaultdict(float)
            for r in dev:
                for name, v in stage_ms(r).items():
                    ms[name] += v / len(dev)
            nodes = dev[-1]["device"]["stage_nodes"]
            parts.append(f"device ms / nodes by stage ({len(dev)} frames, "
                         f"{dev[-1]['device']['nodes']} nodes) " + ", ".join(
                             f"{n} {v:.3f} / {nodes.get(n)}"
                             for n, v in ms.items()))
        names = sorted({n for r in rs for n in r["counters"]})
        if names:
            parts.append("counters a frame " + ", ".join(
                f"{n} {mean(r['counters'].get(n, 0) for r in rs):.2f}"
                for n in names))
        lines.append("[trace] " + "; ".join(parts))
    return lines
