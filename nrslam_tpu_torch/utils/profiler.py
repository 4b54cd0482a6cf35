"""Stage timing (counterpart of nrslam_tpu/utils/profiler.py).

``TimeProfiler`` times named host sections (tic / toc, mean / median /
sigma, a statistics file), as the reference's TimeProfiler
(utilities/time_profiler.{h,cc}) would have if it were called.
``chained_timeit`` times calls as the host issues them, ``device_timeit``
a chain of calls captured in one CUDA graph (``Chain``), both with CUDA
events ending in a synchronize; ``device_reading`` reads one call's
kernels under ``torch.profiler``; ``device_trace`` records a
``torch.profiler`` trace of a block and writes it as a Chrome trace;
``gpu_header`` names the card, its power limit and its SM clock. The
device timers need a CUDA device and raise without one: they never time
the CPU under a device's name.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import numpy as np
import torch


class TimeProfiler:
    def __init__(self):
        self._open = {}
        self._samples = defaultdict(list)

    def tic(self, name: str):
        self._open[name] = time.perf_counter()

    def toc(self, name: str) -> float:
        dt = time.perf_counter() - self._open.pop(name)
        self._samples[name].append(dt)
        return dt

    @contextlib.contextmanager
    def section(self, name: str):
        self.tic(name)
        try:
            yield
        finally:
            self.toc(name)

    def statistics(self):
        """Per section: mean_ms, median_ms (the steady-state measure: the
        first samples carry one-off costs such as the kernels' build),
        sigma_ms, count."""
        return {name: dict(mean_ms=float(np.mean(s) * 1e3),
                           median_ms=float(np.median(s) * 1e3),
                           sigma_ms=float(np.std(s) * 1e3),
                           count=len(s))
                for name, s in self._samples.items()}

    def save_statistics_to_file(self, path: str):
        with open(path, "w") as f:
            for name, st in sorted(self.statistics().items()):
                f.write(f"{name}: mean {st['mean_ms']:.3f} ms "
                        f"sigma {st['sigma_ms']:.3f} ms n={st['count']}\n")


def _require_cuda(what: str):
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} times the card and needs a CUDA device")


def _first_tensor(out) -> torch.Tensor:
    while isinstance(out, (tuple, list)):
        out = out[0]
    return out


def chained_timeit(fn, perturb, n: int = 20, warmup: int = 2) -> float:
    """Mean ms per call of ``fn(perturb(eps))`` over ``n`` calls, each
    input perturbed by a scalar derived from the previous output (a data
    chain, so no call overlaps the next unfairly); CUDA events around the
    chain, ending in a synchronize."""
    _require_cuda("chained_timeit")
    carry = torch.zeros((), dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn(perturb(carry))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        out = fn(perturb(carry * 1e-12))
        carry = torch.sum(_first_tensor(out)).to(torch.float32)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


class Chain:
    """``k`` chained calls of ``step`` (each takes the previous one's
    output) captured in one ``torch.cuda.CUDAGraph`` over a static carry:
    the counterpart of the JAX package's jitted ``fori_loop`` of k calls.

    ``carry0`` is a tensor or a tree of tensors (``utils.tree``: a
    ``SlamState`` too) on one CUDA device; ``step`` maps such a tree to one
    of the same structure, dtypes and shapes. The carry lives packed in one
    buffer (``tree.packing``, 512-byte offsets, so a kernel that picks its
    vector width by alignment sees what it sees eagerly); ``carry`` is the
    tree of views into it. ``step`` is warmed up once on a side stream (on
    a copy of the carry), then the k calls are captured; the graph writes
    the k-th output back into the carry, so each ``replay`` continues the
    chain where the last one ended, and the first replay leaves in
    ``carry`` what k eager calls from ``carry0`` return.

    The wrappers' launch counts (and handles) are Python statements that
    run at capture only: the capture leaves them as it found them, and a
    replay adds nothing (a timing replays many times). A step that cannot
    be captured (it synchronises the host, or reads a device value)
    raises, naming the step; nothing falls back to eager calls."""

    def __init__(self, step, carry0, k: int = 8, name: str = None):
        _require_cuda("device_timeit")
        from nrslam_tpu_torch.slam import frame_graph
        from nrslam_tpu_torch.utils import tree

        self.name = name or getattr(step, "__name__", repr(step))
        self.k = k
        packing = tree.packing(carry0)
        devices = {x.device for x in tree.leaves(carry0)}
        dev = devices.pop()
        if devices or dev.type != "cuda":
            raise ValueError(f"device_timeit: {self.name}: the carry must "
                             f"lie on one CUDA device, got {dev}")
        self.buf = tree.pack(carry0, packing)
        self.carry = tree.unpack(self.buf, packing)
        saved = frame_graph.wrapper_globals()
        try:
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                scratch = tree.unpack(self.buf.clone(), packing)
                tree.copy_(scratch, step(scratch))
            torch.cuda.current_stream(dev).wait_stream(side)
            del scratch
            torch.cuda.synchronize(dev)
            self.graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(self.graph):
                    c = self.carry
                    for _ in range(k):
                        c = step(c)
                    tree.copy_(self.carry, c)
            except RuntimeError as e:
                raise RuntimeError(
                    f"device_timeit: step {self.name!r} cannot be captured "
                    f"in a CUDA graph (does it synchronise the host?): {e}"
                ) from e
        finally:
            frame_graph.set_wrapper_globals(saved)

    def replay(self) -> None:
        self.graph.replay()

    def ms(self, reps: int = 3) -> float:
        """The best of ``reps`` replays between CUDA events, in ms a call
        (over k)."""
        best = float("inf")
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            self.replay()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end))
        return best / self.k


def device_timeit(step, carry0, k: int = 8, reps: int = 3,
                  name: str = None) -> float:
    """Device ms per call of ``step`` chained ``k`` times: the k calls
    captured in one CUDA graph (``Chain``), replayed once to warm up, then
    ``reps`` times between CUDA events; the best replay over k. The host
    enqueues one graph launch a replay, so this is the device's time for
    the chain (the counterpart of the JAX package's one-program chain);
    ``chained_timeit`` is the per-call figure with the host's enqueue."""
    chain = Chain(step, carry0, k, name)
    chain.replay()
    return chain.ms(reps)


# Profiler sessions a device_reading takes (see there).
READ_SESSIONS = 3


def device_reading(fn) -> dict:
    """One call of ``fn()`` under ``torch.profiler``: its device kernels
    (``kernels``), copies and fills (``copies``) and the kernels' summed
    device time in ms (``device_ms``), ending in a synchronize. On an H100
    the profiler lost a few device events of each session once a process
    was a minute or more old (more the older it was; all of a 2-kernel
    call at times), whatever waited around the call; a loss only ever
    lowers the count, so of ``READ_SESSIONS`` sessions the reading with
    the most kernels is returned, and a count is a lower bound."""
    from torch.profiler import ProfilerActivity, profile

    _require_cuda("device_reading")
    readings = []
    for _ in range(READ_SESSIONS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        device = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        kernels = [e for e in device
                   if not e.key.startswith(("Memcpy", "Memset"))]
        n_kernels = sum(e.count for e in kernels)
        readings.append({
            "kernels": n_kernels,
            "copies": sum(e.count for e in device) - n_kernels,
            "device_ms": sum(e.device_time_total for e in kernels) / 1e3})
    return max(readings, key=lambda r: r["kernels"])


GPU_FIELDS = "name,power.limit,clocks.sm,clocks.max.sm"


def gpu_header(busy=None) -> str:
    """The card's ``name, power.limit, clocks.sm, clocks.max.sm`` as
    ``nvidia-smi --query-gpu=... --format=csv,noheader`` gives them. With
    ``busy`` (a callable that enqueues device work and does not wait for
    it), the reading is taken while that work runs, so ``clocks.sm`` is the
    clock under load; then the work is waited for."""
    import subprocess

    if busy is not None:
        busy()
    out = subprocess.run(["nvidia-smi", f"--query-gpu={GPU_FIELDS}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    if busy is not None:
        torch.cuda.synchronize()
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def device_trace(logdir: str):
    """A torch.profiler trace (CPU and CUDA activity) of the block, written
    to ``logdir/trace.json`` (Chrome trace format)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
