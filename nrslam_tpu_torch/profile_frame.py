"""Where the time of one steady-state frame goes, on one GPU, eager and
replayed.

    python -m nrslam_tpu_torch.profile_frame [--points 768 --height 480
        --width 640 --new-kp 256]

Builds the bench problem on the card and warms up both frame
specializations. For a non-keyframe and a keyframe it then times three
unprofiled eager frames of that kind (median host wall, ending in a
synchronize), runs one more under ``torch.profiler`` and prints the top
operators by device time. Then it builds a ``frame_graph.FrameGraph`` from
the state reached and does the same for the replayed frame of each kind
(``frame_graph.profile_step``), whose host side is one graph launch. The
summary lines (``== ... frame ...``) come last: device busy time and
kernel count from the profiled frame, both walls (and a replay's host
enqueue), and the device idle share estimated as 1 - busy / unprofiled
wall. The estimate mixes two runs of the same kind in one process: the
profiler itself slows the host, so its own wall is not used. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch
from torch.profiler import ProfilerActivity, profile

from nrslam_tpu_torch import bench_problem
from nrslam_tpu_torch.slam import frame_graph, system


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", type=int, default=768)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--new-kp", type=int, default=256)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_frame: needs a CUDA device")
    dev = torch.device("cuda", 0)
    state, frames, mask, cam, config = bench_problem.build_bench_problem(
        args.points, args.height, args.width, args.new_kp, device=dev)
    s = state
    for i, kf in enumerate([False, True, False, True]):
        s, _ = system.frame_step(s, frames[i], mask, cam, config, kf)
    torch.cuda.synchronize()

    def step(i, kf):
        nonlocal s
        t0 = time.perf_counter()
        s, _ = system.frame_step(s, frames[i % len(frames)], mask, cam,
                                 config, kf)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    where = f"{args.width}x{args.height} P={args.points}"
    summary = []
    for label, kf in (("non-keyframe", False), ("keyframe", True)):
        wall = statistics.median(step(4 + k, kf) for k in range(3))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall_prof = step(4, kf)
        events = prof.key_averages()
        kernels = [e for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.device_time_total for e in kernels) / 1e3
        n_launch = sum(e.count for e in kernels)
        print(f"-- {label} frame: top operators by device time")
        print(events.table(sort_by="device_time_total", row_limit=30,
                           max_name_column_width=60))
        summary.append(
            f"== {label} frame, {where}: "
            f"device busy {busy_ms:.2f} ms in {n_launch} kernel launches "
            f"(profiled frame, host wall {1e3 * wall_prof:.2f} ms); "
            f"unprofiled host wall {1e3 * wall:.2f} ms (median of 3); "
            f"estimated device idle {1 - busy_ms / (1e3 * wall):.3f} ==")

    fg = frame_graph.FrameGraph(s, frames[0], mask, cam, config)

    def replay(i, kf):
        nonlocal s
        t0 = time.perf_counter()
        s, _ = fg.step(s, frames[i % len(frames)], mask, kf)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, t1 - t0

    for label, kf in (("non-keyframe", False), ("keyframe", True)):
        walls = [replay(4 + k, kf) for k in range(3)]
        wall = statistics.median(w for w, _ in walls)
        enqueue = statistics.median(e for _, e in walls)
        s, _, rd = frame_graph.profile_step(fg, s, frames[4], mask, kf)
        summary.append(
            f"== {label} frame replayed, {where}: device busy "
            f"{rd['busy_ms']:.2f} ms in {rd['kernels']} kernels and "
            f"{rd['copies']} copies (profiled replay, host wall "
            f"{rd['wall_ms']:.2f} ms; host launch calls {rd['host']}); "
            f"unprofiled host wall {1e3 * wall:.2f} ms, enqueue "
            f"{1e3 * enqueue:.3f} ms (medians of 3); estimated device idle "
            f"{1 - rd['busy_ms'] / (1e3 * wall):.3f}; graphs built in "
            f"{fg.build_s:.2f} s, pool {fg.pool_bytes[kf]} B ==")
    print("\n".join(summary))


if __name__ == "__main__":
    main()
