"""The steady-state frame captured as one CUDA graph per frame kind: the
counterpart of nrslam_tpu/slam/system.py::_fused_frame_impl ("Pyramid +
tracking + mapping as ONE XLA program", in its non-keyframe and keyframe
specialisations).

``FrameGraph`` captures ``system.frame_step`` once with ``make_keyframe``
False and once with it True, each in a ``torch.cuda.CUDAGraph`` with its
own memory pool, over static buffers: the packed state (every leaf of the
``SlamState`` and of the ``FrameResult`` as a view into one flat device
buffer, ``utils.tree.packing``), ``gray [H, W]`` and ``mask [H, W]``. The
captured body (``body``) runs ``frame_step`` on the state's views and
writes the new state and result back into them. ``step`` has
``frame_step``'s contract: it copies a state in only when it is not the
snapshot its last step returned, copies the frame in, replays the graph of
the frame's kind, and returns a snapshot (one copy of the packed buffer
into a fresh allocation), so no later replay writes into anything a step
returned.

The host tally (``utils.profiler.tally``: kernel launches, solver calls,
collective payloads, the last launch's device headers) is Python that runs
while a graph is captured, never while it replays: the build leaves it as
it found it, and every replay adds what its capture recorded
(``profiler.record`` / ``profiler.replay``). ``KindGraphs`` is what this
graph and the sharded frame's
(``parallel.frame_graph_shard.ShardFrameGraph``) share: the packing, the
warm-up on a scratch copy on a side stream, one capture per kind with its
own pool, and the replay with its snapshot.

Each kind's capture also takes the frame's stage stamps
(``utils.profiler.Stamps``): a mark of the device's timer at every stage
boundary that ``profiler.stage`` names in ``frame_step`` (and an end
mark), and the counters ``profiler.device_count`` names, each into a slot
of a small int64 buffer the kind owns; the graph's nodes are counted at
each mark. Both kinds always carry them, so the graph that runs untraced
is the one a tracer reads (``profiler.read_stamps``, after the frame).

CUDA tensors only; on a CPU tensor the constructor raises (the CPU runs
``system.frame_step``). A capture or a replay that fails raises: nothing
falls back to the eager frame.
"""

from __future__ import annotations

import time

import torch

from nrslam_tpu_torch.geometry import cameras
from nrslam_tpu_torch.slam import system as system_mod
from nrslam_tpu_torch.slam import tracking
from nrslam_tpu_torch.slam.state import Config
from nrslam_tpu_torch.utils import profiler, tree


def result_like(state) -> tracking.FrameResult:
    """A zero ``FrameResult`` on the state's device (its static slot)."""
    dev = state.lost.device
    return tracking.FrameResult(
        n_tracked_3d=torch.zeros((), dtype=torch.int32, device=dev),
        lost=torch.zeros((), dtype=torch.bool, device=dev))


def body(state, gray, mask, cam: cameras.Camera, config: Config,
         make_keyframe: bool, out) -> None:
    """The captured frame: ``system.frame_step`` on ``state``, its new
    state and result written into ``out`` = (state views, result views)
    (``out[0]`` may be ``state`` itself: every leaf of the new state is a
    new tensor, so all reads come before the writes). Runs on any device:
    the tests call it on CPU buffers."""
    new_state, result = system_mod.frame_step(state, gray, mask, cam, config,
                                              make_keyframe)
    tree.copy_(out, (new_state, result))


class KindGraphs:
    """The kinds of a frame (``kinds``: ``make_keyframe`` False and True)
    captured over static buffers on one card: ``outputs`` (a tree whose
    first element is the state) packed into one buffer (``views`` into
    it), ``gray`` and ``mask``. A subclass gives ``_body(views, kf)``,
    which writes the frame of kind ``kf`` from ``views[0]`` into ``views``,
    and ``_check()``, which raises where the inputs cannot be captured.
    Each kind's capture has a memory pool of its own, or with
    ``shared_pool`` all share one: for kinds that replay one at a time in
    any order, and whose bodies write every result into ``views``, so that
    what a capture leaves in the pool is only what its body freed.

    ``replays`` counts replays; ``recorded[kf]`` the host tally the
    capture of kind ``kf`` recorded (``profiler.record``: what each replay
    adds);
    ``pool_bytes[kf]`` the device memory its capture reserved;
    ``stamps[kf]`` its ``profiler.Stamps`` (the stage names in capture
    order, the graph's nodes at each mark, the counters, and the buffer a
    replay writes them into); ``build_s`` / ``capture_s`` the seconds of
    the whole build and of each capture."""

    # torch.cuda.graph's capture_error_mode.
    capture_mode = "global"
    # The kinds, in the order the warm-up runs them.
    kinds = (False, True)
    shared_pool = False

    def __init__(self, outputs, gray, mask):
        self.device = gray.device
        self.packing = tree.packing(outputs)
        self.buf = tree.pack(outputs, self.packing)
        self.views = tree.unpack(self.buf, self.packing)
        self.gray = gray.contiguous().clone()
        self.mask = mask.contiguous().clone()
        self.replays = 0
        self.recorded, self.pool_bytes, self.stamps = {}, {}, {}
        self.capture_s = {}
        self._graphs, self._last = {}, None
        t0 = time.perf_counter()
        self._build()
        self.build_s = time.perf_counter() - t0

    def _body(self, views, kf: bool) -> None:
        raise NotImplementedError

    def _check(self) -> None:
        raise NotImplementedError

    def _build(self) -> None:
        """Warm up each kind in turn on a scratch copy of the state on a
        side stream (the kernel library, cached device constants, the
        cuBLAS handles, a process group's communicator; no mark or count
        is taken, ``profiler.QUIET``), then capture each kind; the static
        state does not advance, and the host tally ends as it began."""
        self._check()
        dev = self.device

        def warm_up():
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side), profiler.recording(profiler.QUIET):
                scratch = tree.unpack(self.buf.clone(), self.packing)
                for kf in self.kinds:
                    self._body(scratch, kf)
            torch.cuda.current_stream(dev).wait_stream(side)
            torch.cuda.synchronize(dev)

        profiler.record(warm_up)
        self._pool = torch.cuda.graph_pool_handle() if self.shared_pool \
            else None
        for kf in self.kinds:
            self.stamps[kf] = profiler.Stamps(dev)
        for kf in self.kinds:
            # The capture empties the allocator's cache first too: what is
            # reserved after it beyond this is the graph's pool.
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            t0 = time.perf_counter()
            graph, self.recorded[kf] = profiler.record(
                lambda: self._capture(kf))
            self.capture_s[kf] = time.perf_counter() - t0
            self.pool_bytes[kf] = torch.cuda.memory_reserved(dev) - reserved
            self._graphs[kf] = graph

    def _capture(self, kf: bool):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool,
                              capture_error_mode=self.capture_mode), \
                profiler.recording(self.stamps[kf]) as stamps:
            self._body(self.views, kf)
            stamps.end()
        torch.cuda.synchronize(self.device)
        return graph

    def _replay(self, state, gray, mask, make_keyframe: bool):
        """Copy ``state`` in unless it is the last snapshot, copy the frame
        in, replay the graph of its kind, add what its capture recorded.
        Returns a snapshot of the outputs (one copy of the packed buffer)
        that no later replay writes into."""
        kf = bool(make_keyframe)
        if gray.shape != self.gray.shape or mask.shape != self.mask.shape:
            raise ValueError(f"{type(self).__name__}: frame "
                             f"{list(gray.shape)}, mask {list(mask.shape)}; "
                             f"captured for {list(self.gray.shape)}")
        with profiler.span("nrslam.frame_graph.copy_in"):
            if state is not self._last:
                tree.copy_(self.views[0], state)
            self.gray.copy_(gray)
            self.mask.copy_(mask)
        with profiler.span("nrslam.frame_graph.launch"):
            self._graphs[kf].replay()
        with profiler.span("nrslam.frame_graph.count"):
            self.replays += 1
            profiler.replay(self.recorded[kf])
        with profiler.span("nrslam.frame_graph.snapshot"):
            out = tree.unpack(self.buf.clone(), self.packing)
        self._last = out[0]
        return out


class FrameGraph(KindGraphs):
    """Both kinds of the steady frame captured over static buffers on the
    card; ``step`` replays one. Built from a state of the shapes it will
    step (the first steady state after ``bootstrap_map``), the frame's
    ``gray`` and ``mask``, the camera and the config, which the graphs keep
    (``KindGraphs`` holds the readings)."""

    def __init__(self, state, gray, mask, cam: cameras.Camera,
                 config: Config):
        self.cam, self.config = cam, config
        super().__init__((state, result_like(state)), gray, mask)

    def _check(self) -> None:
        for x in (self.buf, self.gray, self.mask, self.cam.params):
            if x.device.type != "cuda" or x.device != self.device:
                raise ValueError("FrameGraph: expected tensors on one CUDA "
                                 f"device, got {x.device} (the CPU runs "
                                 "system.frame_step)")

    def _body(self, views, kf: bool) -> None:
        body(views[0], self.gray, self.mask, self.cam, self.config, kf, views)

    def step(self, state, gray, mask, make_keyframe: bool):
        """``system.frame_step(state, gray, mask, cam, config,
        make_keyframe)`` by replay. Returns (state, FrameResult), a snapshot
        that no later step writes into."""
        new_state, result = self._replay(state, gray, mask, make_keyframe)
        return new_state, result


# The host-side CUDA runtime calls that launch device work, as the
# profiler names them.
_HOST_LAUNCHES = ("cudaGraphLaunch", "cudaLaunchKernel", "cudaLaunchKernelExC",
                  "cuLaunchKernel", "cuLaunchKernelEx", "cudaMemcpyAsync",
                  "cudaMemsetAsync")


def profile_step(fg: KindGraphs, state, gray, mask, make_keyframe: bool):
    """``fg.step`` under ``torch.profiler``. Returns (state, result,
    reading): the device kernels of the replay, their summed device time
    in ms (``busy_ms``), the step's host-side launch calls by runtime API
    name (``host``), its host wall in ms to the end of its enqueue
    (``enqueue_ms``) and to the end of the device work (``wall_ms``), the
    port's own kernels in the order they ran (``ours``: (name, device ms)
    of each kernel whose name holds ``nrslam``), and NCCL's kernels
    (``nccl``: device ms, count)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(fg.device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fg.step(state, gray, mask, make_keyframe)
        t1 = time.perf_counter()
        torch.cuda.synchronize(fg.device)
        t2 = time.perf_counter()
    events = prof.key_averages()
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in device if not e.key.startswith("Memcpy")
               and not e.key.startswith("Memset")]
    reading = {
        "kernels": sum(e.count for e in kernels),
        "copies": sum(e.count for e in device) - sum(e.count for e in kernels),
        "busy_ms": sum(e.device_time_total for e in device) / 1e3,
        "host": {e.key: e.count for e in events
                 if e.device_type == torch.autograd.DeviceType.CPU
                 and e.key in _HOST_LAUNCHES},
        "enqueue_ms": 1e3 * (t1 - t0), "wall_ms": 1e3 * (t2 - t0)}
    ours = sorted((e.time_range.start, e.name, e.time_range.elapsed_us())
                  for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "nrslam" in e.name)
    reading["ours"] = [(name, us / 1e3) for _, name, us in ours]
    nccl = [e for e in kernels if "nccl" in e.key.lower()]
    reading["nccl"] = (sum(e.device_time_total for e in nccl) / 1e3,
                       sum(e.count for e in nccl))
    return out[0], out[1], reading
