"""Stage timing and the program's own spans, stage stamps and counters
(counterpart of nrslam_tpu/utils/profiler.py).

``TimeProfiler`` times named host sections (tic / toc, mean / median /
sigma, a statistics file), as the reference's TimeProfiler
(utilities/time_profiler.{h,cc}) would have if it were called; as the
tracer that ``tracing`` turns on it also records the program's spans
(``span``), one record per ``System.track_image`` call (``frames``), the
device stage times of a replayed frame (``stage``, ``Stamps``) and the
per-frame counters (``device_count``). The host tally (``tally``,
``tally_max``, ``keep``; read by ``tallies`` and ``kept``) is what the
host counts as it enqueues device work, always on: kernel launches,
solver calls, collective payloads; a captured graph ``record``s it and
each replay ``replay``s the record. ``chained_timeit`` times calls as
the host issues them, ``device_timeit`` a chain of calls captured in one
CUDA graph (``Chain``), both with CUDA events ending in a synchronize;
``device_reading`` reads one call's kernels under ``torch.profiler``;
``device_trace`` records a ``torch.profiler`` trace of a block and writes
it as a Chrome trace; ``gpu_header`` names the card, its power limit and
its SM clock. The device timers need a CUDA device and raise without one:
they never time the CPU under a device's name.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import time
from collections import defaultdict
from typing import NamedTuple

import numpy as np
import torch


# The root span of a frame record: one ``System.track_image`` call.
FRAME = "nrslam.system.track_image"
# The name of the mark that ends a captured frame's last stage.
END = "end"
# Slots of a kind's stamp buffer (marks and counters together).
SLOTS = 64


class TimeProfiler:
    """Named host sections (``tic`` / ``toc`` / ``section``) and, while it
    is the active tracer (``tracing``), the program's spans: each ``(name,
    start_ns, end_ns, parent, frame)`` on ``time.perf_counter_ns``, where
    ``parent`` is the index of the enclosing span in the same list (None
    at a root) and ``frame`` the index of the frame record. A root span
    named ``FRAME`` opens a frame record; ``frames`` hands the finished
    records over. A span outside a frame record counts in ``statistics``
    only."""

    def __init__(self):
        self._open = {}
        self._samples = defaultdict(list)
        self._self = defaultdict(list)
        self._stack = []
        self._frame = None
        self._records = []
        self._n_frames = 0
        # Device clock against the host's (``calibrate``), once read.
        self.clock = None

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
        """Per section and span name: mean_ms, median_ms (the steady-state
        measure: the first samples carry one-off costs such as the kernels'
        build), sigma_ms, count; a span also self_ms, its mean duration
        less what its child spans cover."""
        out = {name: dict(mean_ms=float(np.mean(s) * 1e3),
                          median_ms=float(np.median(s) * 1e3),
                          sigma_ms=float(np.std(s) * 1e3),
                          count=len(s))
               for name, s in self._samples.items()}
        for name, s in self._self.items():
            out[name]["self_ms"] = float(np.mean(s) * 1e3)
        return out

    def save_statistics_to_file(self, path: str):
        with open(path, "w") as f:
            for name, st in sorted(self.statistics().items()):
                f.write(f"{name}: mean {st['mean_ms']:.3f} ms "
                        f"sigma {st['sigma_ms']:.3f} ms n={st['count']}\n")

    # -- spans and frame records ----------------------------------------

    def span(self, name: str) -> "_Span":
        return _Span(self, name)

    def _enter(self, sp: "_Span") -> None:
        parent = self._stack[-1] if self._stack else None
        if parent is None and sp.name == FRAME:
            self._frame = {"frame": self._n_frames, "spans": [],
                           "counters": {}}
            self._n_frames += 1
        if self._frame is not None:
            sp.into = self._frame["spans"]
            sp.index = len(sp.into)
            sp.parent = parent.index if parent is not None else None
            sp.into.append(None)
        self._stack.append(sp)
        if torch.autograd._profiler_enabled():
            sp.rf = torch.profiler.record_function(sp.name)
            sp.rf.__enter__()
        sp.start = time.perf_counter_ns()

    def _exit(self, sp: "_Span") -> None:
        end = time.perf_counter_ns()
        if sp.rf is not None:
            sp.rf.__exit__(None, None, None)
        self._stack.pop()
        dur = end - sp.start
        if self._stack:
            self._stack[-1].child_ns += dur
        if sp.into is not None:
            sp.into[sp.index] = (sp.name, sp.start, end, sp.parent,
                                 self._frame["frame"])
        self._samples[sp.name].append(dur / 1e9)
        self._self[sp.name].append((dur - sp.child_ns) / 1e9)
        if not self._stack and self._frame is not None:
            self._records.append(self._frame)
            self._frame = None

    def note(self, **fields) -> None:
        """Set fields of the frame record in flight (none: nothing)."""
        if self._frame is not None:
            self._frame.update(fields)

    def count(self, name: str, total) -> None:
        """Add a counter's total (an int or a 0-d tensor, read when the
        records are taken) to the frame record in flight."""
        if self._frame is not None:
            c = self._frame["counters"]
            c[name] = c[name] + total if name in c else total

    def add_device(self, stamps: "Stamps") -> None:
        """The device reading of the frame in flight: one copy of
        ``stamps``' buffer (``Stamps.read``), its stages put on the host
        spans' clock (``calibrate``)."""
        if self._frame is None:
            return
        if self.clock is None:
            self.clock = calibrate(stamps.buf.device)
        r = stamps.read()
        off = self.clock["offset_ns"]
        self._frame["device"] = {
            "stages": [(n, a - off, b - off) for n, a, b in r["stages"]],
            "nodes": r["nodes"], "stage_nodes": r["stage_nodes"]}
        for name, v in r["counters"].items():
            self.count(name, v)

    def frames(self) -> list:
        """The finished frame records, handed over (the tracer keeps none):
        each a dict of ``frame`` (its index), ``kind`` (``init``, ``kf`` or
        ``nonkf``, as ``System`` notes it), ``spans``, ``counters`` (name
        -> int) and, for a replayed frame read by ``add_device``,
        ``device``: ``stages`` ((name, start_ns, end_ns) on the spans'
        clock, in capture order), ``nodes`` (the captured graph's) and
        ``stage_nodes`` (name -> nodes from its mark to the next)."""
        out, self._records = self._records, []
        for r in out:
            r["counters"] = {k: int(v) for k, v in r["counters"].items()}
        return out


class _Span:
    """One span of a tracer: a context manager (``TimeProfiler.span``)."""

    __slots__ = ("tracer", "name", "start", "child_ns", "parent", "index",
                 "into", "rf")

    def __init__(self, tracer: TimeProfiler, name: str):
        self.tracer, self.name = tracer, name
        self.child_ns, self.rf, self.into = 0, None, None

    def __enter__(self):
        self.tracer._enter(self)
        return self

    def __exit__(self, *exc):
        self.tracer._exit(self)
        return False


class _NoSpan:
    """What ``span`` returns while no tracer is on: nothing happens."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()

# The active tracer (``tracing``) and the stamps a capture writes
# (``recording``).
_tracer = None
_recording = None


@contextlib.contextmanager
def tracing(tracer: TimeProfiler = None):
    """Turn the tracer on for the block (``tracer``, else a new
    ``TimeProfiler``), and yield it. Where CUDA is already in use, its
    clock is read against the host's first (``calibrate``); else at the
    first device reading. One tracer at a time."""
    global _tracer
    if _tracer is not None:
        raise RuntimeError("a tracer is already on")
    t = tracer if tracer is not None else TimeProfiler()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        t.clock = calibrate()
    _tracer = t
    try:
        yield t
    finally:
        _tracer = None


def span(name: str):
    """A span of the active tracer, or the shared no-op ``NO_SPAN``."""
    t = _tracer
    return NO_SPAN if t is None else _Span(t, name)


def note(**fields) -> None:
    """``TimeProfiler.note`` on the active tracer, if any."""
    t = _tracer
    if t is not None:
        t.note(**fields)


def frames() -> list:
    """The active tracer's finished frame records (``TimeProfiler.frames``;
    none while no tracer is on)."""
    return _tracer.frames() if _tracer is not None else []


def read_stamps(stamps: "Stamps") -> None:
    """``TimeProfiler.add_device`` on the active tracer, if any: one
    synchronising copy of the stamp buffer."""
    t = _tracer
    if t is not None:
        t.add_device(stamps)


def stage(name: str) -> None:
    """The boundary before stage ``name`` of a frame: while a capture
    records into ``Stamps`` (``recording``), a mark of the device's
    timer into its next slot; else nothing."""
    r = _recording
    if r is not None:
        r.stage(name)


def device_count(name: str, x: torch.Tensor) -> None:
    """Counter ``name`` += the number of true elements of ``x`` (its sum):
    while a capture records, a reduction into the next slot of its
    ``Stamps``, inside the graph; else, while a tracer is on and no
    stream captures, into the frame record in flight (read when the
    records are taken); else nothing."""
    r = _recording
    if r is not None:
        r.count(name, x)
        return
    t = _tracer
    if t is not None and not (x.is_cuda
                              and torch.cuda.is_current_stream_capturing()):
        t.count(name, torch.sum(x, dtype=torch.int64))


@contextlib.contextmanager
def recording(stamps):
    """``stage`` and ``device_count`` write into ``stamps`` in the block
    (a capture's; ``QUIET`` drops them, eager counts included)."""
    global _recording
    saved, _recording = _recording, stamps
    try:
        yield stamps
    finally:
        _recording = saved


class _Quiet:
    """A recording that drops every mark and count."""

    def stage(self, name: str) -> None:
        pass

    def count(self, name: str, x) -> None:
        pass


QUIET = _Quiet()


# ---------------------------------------------------------------------------
# The host tally
# ---------------------------------------------------------------------------

class Record(NamedTuple):
    """Host tallies by name: ``counts`` (``tally``), ``largest``
    (``tally_max``) and ``kept`` tensors (``keep``)."""

    counts: dict
    largest: dict
    kept: dict


# The host tally: what the host counted as it enqueued device work, under
# dotted names written where the counting happens (``pose_only.launches``,
# ``collectives.bytes``). Python runs while a graph is captured, never
# while it replays: a capture ``record``s its tallies, a replay
# ``replay``s them.
_tally = Record({}, {}, {})


def tally(name: str, n: int = 1) -> None:
    """Count ``n`` more under ``name``."""
    c = _tally.counts
    c[name] = c.get(name, 0) + n


def tally_max(name: str, v: int) -> None:
    """Keep the largest ``v`` under ``name``."""
    m = _tally.largest
    m[name] = max(m.get(name, v), v)


def keep(name: str, x: torch.Tensor) -> None:
    """Keep ``x`` under ``name``: a launch's device header, which the next
    launch of its kind replaces."""
    _tally.kept[name] = x


def tallies() -> dict:
    """A copy of the counts and the largest values, name -> int."""
    return {**_tally.counts, **_tally.largest}


def kept(name: str):
    """The tensor last kept under ``name`` (None if none)."""
    return _tally.kept.get(name)


def record(run):
    """``run()`` from an empty tally, the tally set back as it was after
    it. Returns (run's result, the ``Record`` of what it tallied and
    kept)."""
    global _tally
    saved, _tally = _tally, Record({}, {}, {})
    try:
        return run(), _tally
    finally:
        _tally = saved


def replay(rec: Record) -> None:
    """Add a ``record``'s counts, take its largest values where larger,
    and keep its tensors."""
    for name, n in rec.counts.items():
        tally(name, n)
    for name, v in rec.largest.items():
        tally_max(name, v)
    _tally.kept.update(rec.kept)


class Stamps:
    """The stage stamps and counters of one captured frame kind: ``buf``, a
    static int64 buffer of ``SLOTS`` on the device (no part of the packed
    state), into which the capture's marks (``stage``: the device's
    ``%globaltimer`` in ns, ``csrc/trace_mark.cu``) and counts
    (``device_count``: a sum) each take the next slot. ``marks`` holds
    (stage name, slot, the graph's nodes at the mark) in capture order,
    ending with ``END``; ``counters`` (name, slot). ``mark(buf, slot)``
    and ``nodes(device)`` default to the card's (``trace_mark.cu``); the
    CPU tests pass their own."""

    def __init__(self, device, mark=None, nodes=None):
        self.buf = torch.zeros(SLOTS, dtype=torch.int64, device=device)
        self.marks, self.counters = [], []
        self._mark = mark or card_mark
        self._nodes = nodes or capture_nodes

    def _slot(self) -> int:
        n = len(self.marks) + len(self.counters)
        if n >= SLOTS:
            raise RuntimeError(f"Stamps: more than {SLOTS} marks and "
                               "counts in one frame")
        return n

    def stage(self, name: str) -> None:
        slot = self._slot()
        self._mark(self.buf, slot)
        self.marks.append((name, slot, self._nodes(self.buf.device)))

    def count(self, name: str, x: torch.Tensor) -> None:
        slot = self._slot()
        torch.sum(x.reshape(-1), 0, dtype=torch.int64, out=self.buf[slot])
        self.counters.append((name, slot))

    def end(self) -> None:
        """The mark after the frame's last stage."""
        self.stage(END)

    @property
    def stages(self) -> list:
        """Stage names in capture order."""
        return [n for n, _, _ in self.marks[:-1]]

    @property
    def nodes(self) -> int:
        """The graph's nodes at the end mark: the frame's."""
        return self.marks[-1][2]

    def stage_nodes(self) -> dict:
        """Stage name -> graph nodes from its mark to the next."""
        out = defaultdict(int)
        for (n, _, a), (_, _, b) in zip(self.marks, self.marks[1:]):
            out[n] += b - a
        return dict(out)

    def read(self) -> dict:
        """One copy of the buffer to the host (it waits for the device):
        ``stages`` [(name, start, end)] on the device's clock, in capture
        order, ``counters`` (name -> summed int), ``nodes`` and
        ``stage_nodes``."""
        host = self.buf.tolist()
        counters = defaultdict(int)
        for n, slot in self.counters:
            counters[n] += host[slot]
        return {"stages": [(n, host[a], host[b]) for (n, a, _), (_, b, _)
                           in zip(self.marks, self.marks[1:])],
                "counters": dict(counters), "nodes": self.nodes,
                "stage_nodes": self.stage_nodes()}


def card_mark(buf: torch.Tensor, slot: int) -> None:
    """Enqueue ``nrslam_trace_mark``: the device's timer into ``buf[slot]``
    (an int64 CUDA buffer) on the current stream."""
    from nrslam_tpu_torch import kernels

    kernels.check_launch("nrslam_trace_mark", kernels.library()
                         .nrslam_trace_mark(buf.data_ptr() + 8 * slot,
                                            kernels.stream_of(buf.device)))


def capture_nodes(device) -> int:
    """Nodes of the graph the current stream of ``device`` is capturing
    (``cudaStreamGetCaptureInfo``, ``cudaGraphGetNodes``); -1 where it
    captures none."""
    from nrslam_tpu_torch import kernels

    n = ctypes.c_long(0)
    kernels.check_launch("nrslam_capture_nodes", kernels.library()
                         .nrslam_capture_nodes(kernels.stream_of(device),
                                               ctypes.addressof(n)))
    return n.value


def calibrate(device=None, rounds: int = 8) -> dict:
    """The device's ``%globaltimer`` against ``time.perf_counter_ns``:
    ``rounds`` marks, each between two host readings with a synchronize
    after it, the tightest kept. ``offset_ns``: device ns minus host ns at
    the bracket's middle (a device stamp ``s`` is at ``s - offset_ns`` on
    the host's clock, within half the bracket); ``bracket_ns``: its
    width."""
    _require_cuda("calibrate")
    device = torch.device("cuda", torch.cuda.current_device()) \
        if device is None else torch.device(device)
    buf = torch.zeros(rounds, dtype=torch.int64, device=device)
    torch.cuda.synchronize(device)
    brackets = []
    for i in range(rounds):
        t0 = time.perf_counter_ns()
        card_mark(buf, i)
        torch.cuda.synchronize(device)
        brackets.append((t0, time.perf_counter_ns()))
    stamps = buf.tolist()
    i = min(range(rounds), key=lambda k: brackets[k][1] - brackets[k][0])
    t0, t1 = brackets[i]
    return {"offset_ns": stamps[i] - (t0 + t1) // 2, "bracket_ns": t1 - t0}


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

    The host tally (``tally``, ``keep``) is Python that runs at capture
    only: the capture leaves it as it found it (``record``), and a replay
    adds nothing (a timing replays many times). A step that cannot
    be captured (it synchronises the host, or reads a device value)
    raises, naming the step; nothing falls back to eager calls."""

    def __init__(self, step, carry0, k: int = 8, name: str = None):
        _require_cuda("device_timeit")
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

        def capture():
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

        record(capture)

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
