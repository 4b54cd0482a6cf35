"""One run of one cell of ``BENCHMARK.json``:

    python3 -m slambench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cell's cards. The run
is one process: set-up (import, the kernels' build or load, the traffic's
loop rendered on the card, ``System`` from frame 0 through its init, the
capture of both frame kinds and a replay of each, and in a
re-initialising cell one blackout and one recovery), then the window of
``--seconds``, then the correctness check against the plain reference
(``slambench/check.py``). The last line of standard output is the result
(one JSON object); the last lines of standard error are the numbers
compared, each beside its limit.

``--trace 0`` reports the cell's end-to-end metrics; ``--trace 1`` steps
a few frames under ``torch.profiler`` right after set-up, then runs the
same window untraced, and reports the cell's per-layer metrics (each read
by ``slambench/metrics/<name>.py``), the device's busy and window seconds
and a breakdown.

A configuration is ``slambench/configs/<config>.json``, a traffic mix
``slambench/traffic/<mix>.json`` (read by ``slambench/scene.py``), a
per-layer metric ``slambench/metrics/<name>.py``, the limits of a cell's
check ``slambench/limits/<cell>.json``: a new cell needs only new files
and its entries in ``BENCHMARK.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
CACHE = ROOT / ".slambench_cache"

# Frames kept for the check: steady frames, re-inits and LOST latches.
K_STEPS, K_INITS, K_LOST = 6, 2, 2
# Traced sessions of a steady cell and the frames in each.
STEADY_SESSIONS, STEADY_SESSION_FRAMES = 2, 6
# Frames the set-up may take before it gives up.
SETUP_LOOPS = 4


def process_age() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    ticks = os.sysconf("SC_CLK_TCK")
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19]) / ticks
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start


def load_cell(name: str) -> tuple:
    """(benchmark, cell, configuration dict, mix, limits) of a cell."""
    from slambench import check, scene

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((ROOT / conf["file"]).read_text())
    return bench, cell, cfg, scene.load_mix(cell["traffic"]), \
        check.load_limits(name)


def metric_reader(name: str):
    """``read(records)`` of ``slambench/metrics/<name>.py``."""
    import importlib.util

    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "slambench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def program_setup(cfg: dict, device):
    """The program's camera and ``System``, from the configuration."""
    from nrslam_tpu_torch.geometry import cameras
    from nrslam_tpu_torch.slam import initializer, system
    from nrslam_tpu_torch.slam.state import Config

    c = cfg["camera"]
    if c["model"] == "PinHole":
        cam = cameras.pinhole(c["fx"], c["fy"], c["cx"], c["cy"],
                              device=device)
    else:
        cam = cameras.kannala_brandt8(c["fx"], c["fy"], c["cx"], c["cy"],
                                      c["k0"], c["k1"], c["k2"], c["k3"],
                                      device=device)
    config = Config(**cfg["Config"])
    icfg = initializer.InitializerConfig(**{
        "rad_per_pixel": config.rad_per_pixel,
        "nms_radius": config.nms_radius,
        "klt_min_ssim": config.klt_min_ssim_init,
        **cfg.get("InitializerConfig", {})})
    return system.System(cam, config, icfg, **cfg["System"])


def warm_up(system, stream, relost: bool, device, observe):
    """Frames from 0 until the system tracks with both frame kinds
    replayed (on the card: captured) and, in a re-initialising cell, has
    recovered from one blackout. Returns (the next stream index, the
    frames)."""
    from slambench import window

    kinds, recovered, lost_once = set(), False, False
    limit = SETUP_LOOPS * stream.mix.loop_frames
    frames = []
    for f in range(limit):
        fr = window.one_frame(system, stream, f, device, observe)
        frames.append(fr)
        if fr.raised:
            raise RuntimeError(f"set-up: frame {f} raised")
        if fr.kind in ("kf", "nonkf"):
            kinds.add(fr.kind)
        if fr.status != window.TRACKING and fr.kind != "init":
            lost_once = True
            kinds.clear()
        if lost_once and fr.kind == "init" and fr.status == window.TRACKING:
            recovered = True
        if len(kinds) == 2 and fr.status == window.TRACKING \
                and (recovered or not relost):
            return f + 1, frames
    raise RuntimeError(f"set-up: no steady state within {limit} frames")


def run_cell(cell: dict, cfg: dict, mix, limits: dict, seed: int,
             seconds: float, trace: bool, device, metrics=(),
             log=print, control: bool = False) -> dict:
    """Set-up, window and check of one run on ``device``; returns the
    result's fields (``metrics`` lists the per-layer metrics to read when
    ``trace``). With ``control`` (``slambench/control.py``; never in a
    benchmark run) the reference in TF32 is judged too, in the program's
    place, as ``control_checks``."""
    import torch

    from slambench import check, scene, window

    relost = mix.blackout > 0
    marks = [("start", process_age())]
    system = program_setup(cfg, device)
    marks.append(("import", process_age()))
    if device.type == "cuda":
        from nrslam_tpu_torch import kernels
        kernels.library()
    marks.append(("kernels", process_age()))

    c = cfg["camera"]
    ref_cam, _, _ = check.reference_setup(cfg, device)
    loop = scene.render_loop(ref_cam, c["height"], c["width"], mix)
    stream = scene.Stream(loop, mix, scene.start_frame(mix, seed))
    marks.append(("render", process_age()))

    sampler = check.Sampler(system, seed, K_STEPS, K_INITS if relost else 0,
                            K_LOST if relost else 0)
    f, warm = warm_up(system, stream, relost, device, sampler.observe)
    marks.append(("warm_up", process_age()))
    if device.type == "cuda":
        # Room in the allocator's cache for the snapshots the check keeps
        # (a step's two states, a re-init's or a latch's one) and the two
        # in flight, so that no window frame waits on a fresh allocation.
        k = sampler.k
        spare = [torch.empty_like(system.frame_graph.buf) for _ in range(
            2 * k["steps"] + k["inits"] + k["lost"] + 2)]
        del spare
        torch.cuda.synchronize(device)
    setup_s = process_age()
    split = {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}
    fg = getattr(system, "frame_graph", None)
    split["capture"] = fg.build_s if fg is not None else 0.0
    split["init_frames"] = sum(fr.t1 - fr.t0 for fr in warm
                               if fr.kind == "init")
    log(f"[setup] {cell['name']} seed {seed}: {setup_s:.3f} s, "
        f"window from stream frame {f}; before this process's first "
        f"line {marks[0][1]:.3f} s, then "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f" s (warm-up: {f} frames; capture and init frames within "
        f"it)")

    traced = None
    if trace:
        traced, f = traced_sessions(system, stream, f, relost, cfg, device)

    sampler.active = True
    frames = window.drive(system, stream, f, seconds, device,
                          sampler.observe)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    out = {"attempted": len(frames),
           "failed": window.failed(frames, relost),
           "memory_peak_bytes": int(peak)}
    if trace:
        from slambench import roofline
        name = (torch.cuda.get_device_name(device)
                if device.type == "cuda" else "cpu")
        rec = {"window": frames, "profiled": traced["frames"],
               "P": cfg["Config"]["max_points"],
               "peak": roofline.peak(name)}
        vals = {}
        for m in metrics:
            v = metric_reader(m["name"])(rec)
            if v is not None:
                vals[m["name"]] = {"value": v, "unit": m["unit"]}
        out["metrics"] = vals
        out["busy_s"], out["window_s"] = traced["busy_s"], traced["window_s"]
        out["breakdown"] = {"device_ops": traced["device_ops"],
                            "idle_gaps": traced["idle_gaps"]}
    else:
        vals = {"frames_per_s": (window.frames_per_s(frames), "frames/s"),
                "setup_s": (setup_s, "s")}
        out["metrics"] = {k: {"value": v, "unit": u}
                          for k, (v, u) in vals.items()}
    st = system.state
    n3d = (int((st.slot_used & (st.status == 0)).sum())
           if st is not None else 0)
    log(f"[window] {len(frames)} frames, {out['failed']} failed, "
        f"{len(window.recoveries_ms(frames))} recoveries, "
        f"{frames[-1].t1 - frames[0].t0:.3f} s; last frame {frames[-1].f}: "
        f"{frames[-1].status}, {n3d} slots tracked with 3D")

    # The check: the program's System is dropped first (the samples keep
    # the states they need), then the reference runs.
    steps, inits = sampler.samples()
    del system, sampler
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = check.run_reference(steps, inits, stream, cfg, device)
    nums = check.compare(check.program_outputs(steps, inits), ref)
    log(f"[check] {len(steps)} steps, {len(inits)} inits "
        f"({sum(it.next_lost is not None for it in inits)} with the frame "
        f"after), {nums['compared']} states compared in "
        f"{time.perf_counter() - t0:.3f} s; largest map_gap_max, pose_gap: "
        + ", ".join(f"{lab} {m:.3e} {p:.3e}" for lab, m, p in sorted(
            nums["by_state"], key=lambda x: -x[1])[:3]))
    out["correct"] = check.verdict(nums, limits)
    out["checks"] = {n: {"value": nums[n], "limit": lim}
                     for n, lim in limits.items()}
    out["readings"] = {n: nums[n] for n in check.NUMBERS if n not in limits}
    if control:
        tf32 = check.run_reference(steps, inits, stream, cfg, device,
                                   tf32=True)
        cn = check.compare(tf32, ref)
        log("[control] largest map_gap_max, pose_gap: " + ", ".join(
            f"{lab} {m:.3e} {p:.3e}" for lab, m, p in sorted(
                cn["by_state"], key=lambda x: -x[1])[:3]))
        out["control_correct"] = check.verdict(cn, limits)
        out["control_checks"] = {n: {"value": cn[n], "limit": lim}
                                 for n, lim in limits.items()}
        out["control_readings"] = {n: cn[n] for n in check.NUMBERS
                                   if n not in limits}
    return out


def traced_sessions(system, stream, f: int, relost: bool, cfg: dict,
                    device):
    """The profiled frames right after set-up. A steady cell: two sessions
    of 6 frames (one keyframe each), the one with the most kernels kept. A
    re-initialising cell: one session from the next blackout's first frame
    until eight frames after the recovery (a keyframe among them). Each profiled frame's record gets
    the live edges and BA window that its states give."""
    from slambench import trace, window, work

    config = cfg["Config"]
    regs = config.get("regularizers_per_point", 11)
    bw = config.get("ba_window", 5)
    states = {}

    def keep(fi, before, out):
        states[fi] = (before, system.state)

    if relost:
        while not stream.is_black(f):
            window.one_frame(system, stream, f, device)
            f += 1

        def until(frs):
            rec = next((i for i, fr in enumerate(frs) if fr.kind == "init"
                        and fr.status == window.TRACKING), None)
            return rec is not None and len(frs) >= rec + 8

        _, best = trace.profile_frames(system, stream, f, 60, device,
                                       until, keep)
        f += len(best["frames"])
    else:
        best = None
        for _ in range(STEADY_SESSIONS):
            _, s = trace.profile_frames(system, stream, f,
                                        STEADY_SESSION_FRAMES, device,
                                        observe=keep)
            f += STEADY_SESSION_FRAMES
            if best is None or s["kernels"] > best["kernels"]:
                best = s
    for r in best["frames"]:
        before, after = states.get(r["f"], (None, None))
        if r["kind"] in ("kf", "nonkf") and before is not None:
            r["E_joint"] = work.joint_live_edges(before, regs)
            if r["kind"] == "kf" and after is not None:
                r["K_ba"], r["E_ba"] = work.ba_window(after, bw, regs)
    return best, f


def no_jax() -> list:
    """Loaded modules whose whole top-level name is JAX's, jaxlib's,
    flax's or the JAX package's."""
    banned = {"jax", "jaxlib", "flax", "nrslam_tpu"}
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in banned)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE / sub)
    try:
        bench, cell, cfg, mix, limits = load_cell(args.workload)
    except (OSError, KeyError, ValueError, StopIteration) as e:
        print(f"slambench: {e}", file=sys.stderr)
        return 2
    import torch

    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"slambench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import nrslam_tpu_torch  # noqa: F401  (the program under test)
    except ImportError as e:
        print(f"slambench: the program is not here: {e}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    device = torch.device("cuda", 0)
    metrics = [m for m in bench["per_layer"]
               if args.workload in m.get("workloads", [args.workload])]
    res = run_cell(cell, cfg, mix, limits, args.seed, args.seconds,
                   bool(args.trace), device, metrics,
                   log=lambda s: print(s, file=sys.stderr, flush=True))

    found = no_jax()
    if found:
        print(f"slambench: JAX loaded in the measuring process: {found}",
              file=sys.stderr)
        return 3
    from nrslam_tpu_torch.utils import profiler
    try:
        print(f"[card] {profiler.gpu_header()}", file=sys.stderr)
    except (OSError, RuntimeError) as e:  # nvidia-smi missing or failing
        print(f"[card] nvidia-smi: {e}", file=sys.stderr)
    device_rec = {"platform": "gpu",
                  "kind": torch.cuda.get_device_name(device),
                  "count": chips,
                  "memory_peak_bytes": res["memory_peak_bytes"]}
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": device_rec}
    if args.trace:
        device_rec["busy_s"] = res["busy_s"]
        device_rec["window_s"] = res["window_s"]
        line["breakdown"] = res["breakdown"]
    line["checks"] = res["checks"]
    print("[check] not compared: " + ", ".join(
        f"{n} {v!r}" for n, v in res["readings"].items()), file=sys.stderr)
    for n, c in res["checks"].items():
        print(f"{n} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
