"""Stage timing (counterpart of nrslam_tpu/utils/profiler.py).

``TimeProfiler`` times named host sections (tic / toc, mean / median /
sigma, a statistics file), as the reference's TimeProfiler
(utilities/time_profiler.{h,cc}) would have if it were called.
``chained_timeit`` and ``device_timeit`` time device work on the card with
CUDA events and end in a synchronize; ``device_trace`` records a
``torch.profiler`` trace of a block and writes it as a Chrome trace. The
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


def device_timeit(step, carry0, k: int = 8, reps: int = 3) -> float:
    """Device ms per call of ``step`` chained ``k`` times (each call takes
    the previous one's output), CUDA events around each chain; the best of
    ``reps`` chains after one warm-up chain."""
    _require_cuda("device_timeit")
    c = carry0
    for _ in range(k):
        c = step(c)
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(k):
            c = step(c)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best / k


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
