"""The program's own spans, stage stamps and counters over a cell's
window, read by the per-layer readers of ``slambench/metrics/`` that take
them (``rec["program"]``):

    python3 -m slambench.program --workload <cell> --seed <n> \
        --seconds <s> [--windows on,off]

from the root of a checkout, on a machine with the cell's cards. Set-up
is ``slambench/run.py``'s (the same functions), then its ``--trace 1``
profiled session (the tracer off: on, the profiler would record the
device side of the program's spans, which ``slambench/trace.py`` would
count as device work), then a second profiled session like it with
nrslam_tpu_torch's tracer on (``utils.profiler.tracing``), whose device
idle gaps are each put down to the innermost program span around them
(``span_gaps``), then one window of ``--seconds`` for each entry of
``--windows``, the tracer on or off.
Each window reports its frames and the per-kind frame means; a traced one
also every per-layer metric of the cell (on this window and the first
session) and of ``PROGRAM_METRICS``, and the ``[trace]`` lines on
standard error. Nothing is checked against the reference: this reads
layers and claims nothing. The last line of standard output is one JSON
object. A program without a tracer (an older nrslam_tpu_torch) skips the
second session, runs every window untraced and reads no program metric.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

from slambench import run

# The per-layer readers of the program's records.
PROGRAM_METRICS = (
    "frame_graph.launch_ms", "system.replay_idle_ms",
    "frame_graph.nodes_per_frame", "tracking.klt_device_ms",
    "tracking.solve_device_ms", "tracking.reuse_device_ms",
    "mapping.triangulation_device_ms", "mapping.ba_device_ms",
    "init.issue_ms", "init.sync_ms", "init.lapack_ms",
    "tracking.reuse_yield", "mapping.triangulation_yield",
    "map.recyclable_frac", "tracking.rejected", "frame_graph.lead_ms")
# Per-kind frame means, read in every window.
FRAME_MEANS = ("system.nonkf_ms", "system.kf_ms", "init.frame_ms")


def read_metrics(rec: dict, names) -> dict:
    """Each named reader's value on ``rec`` (None where it read nothing)."""
    return {n: run.metric_reader(n)(rec) for n in names}


def windows(system, stream, f: int, seconds: float, device, tracers,
            base: dict, cell_metrics, log) -> list:
    """One window of ``seconds`` a tracer switch (``tracing`` or None for
    untraced) from stream index ``f``, the traced ones read."""
    from slambench import window
    from slambench.metrics import _program

    out = []
    for tracing in tracers:
        with (tracing() if tracing else contextlib.nullcontext()) as t:
            frames = window.drive(system, stream, f, seconds, device)
            program = t.frames() if t is not None else None
        f = frames[-1].f + 1
        rec = dict(base, window=frames)
        res = {"tracer": tracing is not None, "frames": len(frames),
               "frames_per_s": window.frames_per_s(frames),
               "means": read_metrics(rec, FRAME_MEANS)}
        if program is not None:
            rec["program"] = program
            res["clock"] = t.clock
            res["metrics"] = read_metrics(rec, cell_metrics
                                          + PROGRAM_METRICS)
            for line in _program.summary(rec):
                log(line)
        log(f"[window] tracer {'on' if res['tracer'] else 'off'}: "
            f"{res['frames']} frames, {res['frames_per_s']:.4f} frames/s, "
            + ", ".join(f"{k} {v}" for k, v in res["means"].items()))
        out.append(res)
    return out


# A stage mark of the captured frame, as the profiler names its kernel.
MARK = "trace_mark_kernel"


def span_gaps(events, frames) -> dict:
    """Device idle in profiled frames by the program span around it, and
    the captured graph's busy time between its first and last stage mark.
    ``events`` are (name, start us, end us, on_device) of one profiler
    session in which frame k of ``frames`` ran inside the harness's span
    ``slambench.frame.k``; the device-side ranges of ``record_function``
    (the harness's and the program's spans) are no device work.

    ``idle_by_span``: each gap in the union of a frame's device intervals,
    within its span, goes to the innermost (shortest) ``nrslam.`` span
    that covers the gap's middle, else to "outside the program";
    [("<kind>: <span>", seconds)], the largest first. ``graph``: by kind,
    the mean ms a replayed frame from its first mark's start to its last
    mark's end (``marks_ms``: what the stage stamps span) and the busy
    union of the device work in between (``busy_ms``), over ``frames``
    replays; the difference is the idle between the graph's nodes."""
    from slambench import trace

    frame_spans, spans, dev = {}, [], []
    for name, a, b, on_device in events:
        if on_device:
            if not name.startswith((trace.SPAN, "nrslam.")):
                dev.append((a, b, name))
        elif name.startswith(trace.SPAN):
            frame_spans[int(name[len(trace.SPAN):])] = (a, b)
        elif name.startswith("nrslam."):
            spans.append((a, b, name))
    idle, graph = {}, {}
    for k, fr in enumerate(frames):
        if k not in frame_spans:
            continue
        s0, s1 = frame_spans[k]
        mine_dev = [d for d in dev if s0 <= d[0] <= s1]
        busy = trace._union([(a, b) for a, b, _ in mine_dev])
        edges = [s0] + [x for iv in busy for x in iv] + [s1]
        mine = [sp for sp in spans if sp[0] < s1 and sp[1] > s0]
        for g0, g1 in zip(edges[0::2], edges[1::2]):
            if g1 <= g0:
                continue
            t = (g0 + g1) / 2
            around = [sp for sp in mine if sp[0] <= t <= sp[1]]
            name = (min(around, key=lambda sp: sp[1] - sp[0])[2]
                    if around else "outside the program")
            key = f"{fr.kind}: {name}"
            idle[key] = idle.get(key, 0.0) + (g1 - g0) / 1e6
        marks = sorted(d for d in mine_dev if MARK in d[2])
        if len(marks) >= 2:
            m0, m1 = marks[0][0], marks[-1][1]
            inner = trace._union([(a, b) for a, b, _ in mine_dev
                                  if m0 <= a and b <= m1])
            g = graph.setdefault(fr.kind, [0, 0.0, 0.0])
            g[0] += 1
            g[1] += (m1 - m0) / 1e3
            g[2] += sum(b - a for a, b in inner) / 1e3
    return {"idle_by_span": sorted(idle.items(), key=lambda kv: -kv[1]),
            "graph": {kind: {"frames": n, "marks_ms": span / n,
                             "busy_ms": busy / n}
                      for kind, (n, span, busy) in graph.items()}}


def gap_session(system, stream, f: int, relost: bool, device, tracing):
    """A profiled session of the frames ``run.traced_sessions`` profiles
    (from the next blackout to eight frames after its recovery; 6 frames
    in a steady cell), the tracer on. Returns (``span_gaps`` of it, the
    next stream index)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from slambench import trace, window

    if relost:
        while not stream.is_black(f):
            window.one_frame(system, stream, f, device)
            f += 1
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    frames = []
    with tracing(), profile(activities=activities) as prof:
        while len(frames) < 60:
            with record_function(f"{trace.SPAN}{len(frames)}"):
                frames.append(window.one_frame(system, stream,
                                               f + len(frames), device))
            back = next((i for i, fr in enumerate(frames)
                         if fr.kind == "init"
                         and fr.status == window.TRACKING), None)
            if (not relost and len(frames) >= 6) or (
                    back is not None and len(frames) >= back + 8):
                break
    cuda = torch.autograd.DeviceType.CUDA
    events = [(e.name, e.time_range.start, e.time_range.end,
               e.device_type == cuda) for e in prof.events()]
    return span_gaps(events, frames), f + len(frames)


def trace_cell(bench: dict, workload: str, cfg: dict, mix, seed: int,
               seconds: float, modes, device, log) -> dict:
    """Set-up, the profiled session and the windows (``modes``: "on" or
    "off" each) of one cell on ``device``; returns the result's fields."""
    import torch

    from nrslam_tpu_torch import kernels
    from nrslam_tpu_torch.utils import profiler

    from slambench import check, roofline, scene

    tracing = getattr(profiler, "tracing", None)
    relost = mix.blackout > 0
    system = run.program_setup(cfg, device)
    if device.type == "cuda":
        kernels.library()
    c = cfg["camera"]
    ref_cam, _, _ = check.reference_setup(cfg, device)
    stream = scene.Stream(scene.render_loop(ref_cam, c["height"],
                                            c["width"], mix),
                          mix, scene.start_frame(mix, seed))
    f, _ = run.warm_up(system, stream, relost, device, None)
    traced, f = run.traced_sessions(system, stream, f, relost, cfg, device)
    log("[session] idle gaps: " + ", ".join(
        f"{n} {s:.4f} s" for n, s in traced["idle_gaps"]))
    gaps = None
    if tracing is not None:
        gaps, f = gap_session(system, stream, f, relost, device, tracing)
        log("[session] idle by program span: " + ", ".join(
            f"{n} {s:.4f} s" for n, s in gaps["idle_by_span"][:12]))
        log("[session] the graph from its first mark to its last: "
            + ", ".join(f"{k} {g['marks_ms']:.3f} ms, busy "
                        f"{g['busy_ms']:.3f}"
                        for k, g in gaps["graph"].items()))
    cell_metrics = tuple(m["name"] for m in bench["per_layer"]
                         if workload in m.get("workloads", [workload]))
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    base = {"profiled": traced["frames"], "P": cfg["Config"]["max_points"],
            "peak": roofline.peak(name)}
    res = windows(system, stream, f, seconds, device,
                  [tracing if m == "on" else None for m in modes], base,
                  cell_metrics, log)
    session = {k: traced[k] for k in ("busy_s", "window_s", "device_ops",
                                      "idle_gaps")}
    session["tracer"] = gaps
    return {"workload": workload, "seed": seed, "session": session,
            "windows": res}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--windows", default="on",
                   help="comma-separated on / off, one window each")
    args = p.parse_args(argv)
    modes = args.windows.split(",")
    if not set(modes) <= {"on", "off"}:
        print(f"slambench.program: --windows {args.windows}",
              file=sys.stderr)
        return 2
    bench, cell, cfg, mix, _ = run.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("slambench.program: needs a CUDA device", file=sys.stderr)
        return 2
    from nrslam_tpu_torch.utils import profiler

    torch.set_num_threads(2)
    out = trace_cell(bench, args.workload, cfg, mix, args.seed,
                     args.seconds, modes, torch.device("cuda", 0),
                     lambda s: print(s, file=sys.stderr, flush=True))
    out["card"] = profiler.gpu_header()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
