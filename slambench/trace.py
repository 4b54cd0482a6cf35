"""The traced run's device readings: frames stepped under
``torch.profiler`` (CPU and CUDA activity), each inside a
``record_function`` span of the harness, and reduced to per-frame records.

A frame ends with its pose on the host, so every device operation of a
frame starts inside its span: a device event belongs to the span it
starts in. Per frame: device-busy ms (the union of its device operations'
intervals), kernels (device operations other than copies and fills), and
the device ms of each call of the joint and BA kernels, told apart by
name. Per session: busy and window seconds, the device operations that
took most time, and the idle gaps by what the host was doing (the
innermost host event that covers a gap's middle).

The profiler on an H100 has lost device events in processes a minute old
or more: counts are lower bounds, so of several sessions the one with the
most kernels is kept (as ``nrslam_tpu_torch/utils/profiler.py``'s
``device_reading`` does), and sessions are taken right after set-up.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict

import torch

from slambench import window as window_mod

SPAN = "slambench.frame."
JOINT = re.compile(r"\bpose_deformation_kernel\b")
BA = re.compile(r"\bba_kernel\b")


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def _union(intervals):
    """Merged [start, end) intervals of a list, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _short(name: str) -> str:
    return name.split("(", 1)[0][:100]


def profile_frames(system, stream, f0: int, count: int, device,
                   until=None, observe=None):
    """Step ``count`` frames from stream index ``f0`` under the profiler,
    or fewer where ``until(frames)`` says to stop. Returns (frames,
    session), where ``session`` is ``reduce``'s reading."""
    from torch.profiler import ProfilerActivity, profile, record_function

    frames = []
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        for k in range(count):
            with record_function(f"{SPAN}{k}"):
                frames.append(window_mod.one_frame(system, stream, f0 + k,
                                                   device, observe))
            if until is not None and until(frames):
                break
    return frames, reduce(list(prof.events()), frames)


def reduce(events, frames) -> dict:
    """Per-frame records and the session's totals from the profiler's
    events of a session whose frames are ``frames``."""
    spans = {}
    cpu, dev = [], []
    for e in events:
        tr = e.time_range
        if e.name.startswith(SPAN):
            # The span's own mark on the device timeline is no operation.
            if e.device_type != torch.autograd.DeviceType.CUDA:
                spans[int(e.name[len(SPAN):])] = (tr.start, tr.end)
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((tr.start, tr.end, e.name))
        else:
            cpu.append((tr.start, tr.end, e.name))
    dev.sort()
    cpu.sort()
    cpu_starts = [c[0] for c in cpu]
    starts = [d[0] for d in dev]

    per_frame = []
    ops = defaultdict(float)
    gaps = defaultdict(float)
    busy_us = 0.0
    for k, fr in enumerate(frames):
        if k not in spans:
            continue
        s0, s1 = spans[k]
        lo, hi = bisect.bisect_left(starts, s0), bisect.bisect_right(starts,
                                                                     s1)
        mine = dev[lo:hi]
        merged = _union([(a, b) for a, b, _ in mine])
        busy = sum(b - a for a, b in merged)
        busy_us += busy
        for a, b, name in mine:
            ops[_short(name)] += b - a
        edges = [s0] + [x for iv in merged for x in iv] + [s1]
        for g0, g1 in zip(edges[0::2], edges[1::2]):
            if g1 > g0:
                gaps[f"{fr.kind}: {_host_at(cpu, cpu_starts, (g0 + g1) / 2)}"
                     ] += g1 - g0
        per_frame.append({
            "kind": fr.kind, "f": fr.f, "black": fr.black,
            "busy_ms": busy / 1e3,
            "kernels": sum(1 for _, _, n in mine if not _is_copy(n)),
            "joint_ms": [(b - a) / 1e3 for a, b, n in mine if JOINT.search(n)],
            "ba_ms": [(b - a) / 1e3 for a, b, n in mine if BA.search(n)]})
    window_us = (max(s[1] for s in spans.values())
                 - min(s[0] for s in spans.values())) if spans else 0.0
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"frames": per_frame, "busy_s": busy_us / 1e6,
            "window_s": window_us / 1e6,
            "kernels": sum(r["kernels"] for r in per_frame),
            "device_ops": [[n, us / 1e6] for n, us in top],
            "idle_gaps": [[n, us / 1e6] for n, us in idle]}


def _host_at(cpu, cpu_starts, t: float) -> str:
    """The innermost host event that covers time ``t`` (the shortest one
    of those that started within the 400 before it), or "host python"."""
    i = bisect.bisect_right(cpu_starts, t)
    best = None
    for j in range(i - 1, max(-1, i - 401), -1):
        s, e, name = cpu[j]
        if e >= t and (best is None or e - s < best[0]):
            best = (e - s, name)
    return best[1] if best else "host python"
