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

The wrappers' launch counts (``pose_only_cuda.launches`` and the joint's
and BA's) are Python statements that run while a graph is captured, never
while it replays: the build leaves them as it found them, and every replay
adds what its capture recorded. The same holds for their ``last_*``
handles of the device work header.

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
from nrslam_tpu_torch.utils import tree

# The wrappers' module globals that a capture sets: launch counts (added to
# on every replay) and handles of the last launch's device header.
_COUNTS = ("launches",)
_HANDLES = {"pose_only_cuda": ("last_lm_steps",),
            "pose_deformation_cuda": ("last_work",),
            "bundle_adjustment_cuda": ("last_work",)}


def _wrappers():
    from nrslam_tpu_torch.solver import (bundle_adjustment_cuda,
                                         pose_deformation_cuda,
                                         pose_only_cuda)
    return {"pose_only_cuda": pose_only_cuda,
            "pose_deformation_cuda": pose_deformation_cuda,
            "bundle_adjustment_cuda": bundle_adjustment_cuda}


def wrapper_globals() -> dict:
    """(module name, attribute) -> value of every counted or handle global."""
    return {(m, a): getattr(mod, a) for m, mod in _wrappers().items()
            for a in _COUNTS + _HANDLES[m]}


def set_wrapper_globals(values: dict) -> None:
    """Set the globals ``values`` names (as ``wrapper_globals`` keys them)."""
    mods = _wrappers()
    for (m, a), v in values.items():
        setattr(mods[m], a, v)


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


class FrameGraph:
    """Both kinds of the steady frame captured over static buffers on the
    card; ``step`` replays one. Built from a state of the shapes it will
    step (the first steady state after ``bootstrap_map``), the frame's
    ``gray`` and ``mask``, the camera and the config, which the graphs keep.

    ``replays`` counts replays; ``launches[kf]`` the wrapper launches the
    capture of kind ``kf`` recorded (what each replay adds);
    ``pool_bytes[kf]`` the device memory its capture reserved;
    ``kernels[kf]`` the device kernels of one replay of that kind, once
    ``profile_step`` has read them; ``build_s`` / ``capture_s`` the
    seconds of the whole build and of each capture."""

    def __init__(self, state, gray, mask, cam: cameras.Camera,
                 config: Config):
        self.device = gray.device
        self.cam, self.config = cam, config
        frame = (state, result_like(state))
        self.packing = tree.packing(frame)
        self.buf = tree.pack(frame, self.packing)
        self.views = tree.unpack(self.buf, self.packing)
        self.gray = gray.contiguous().clone()
        self.mask = mask.contiguous().clone()
        self.replays = 0
        self.launches, self.pool_bytes, self.kernels = {}, {}, {}
        self.capture_s = {}
        self._handles, self._graphs, self._last = {}, {}, None
        t0 = time.perf_counter()
        self._build()
        self.build_s = time.perf_counter() - t0

    def _build(self) -> None:
        """Warm up one frame of each kind on a scratch copy of the state on
        a side stream (the kernel library, cached device constants, the
        cuBLAS handles), then capture both kinds; the static state does
        not advance, and the wrappers' globals end as they began."""
        dev = self.device
        for x in (self.buf, self.gray, self.mask, self.cam.params):
            if x.device.type != "cuda" or x.device != dev:
                raise ValueError("FrameGraph: expected tensors on one CUDA "
                                 f"device, got {x.device} (the CPU runs "
                                 "system.frame_step)")
        saved = wrapper_globals()
        try:
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                scratch = tree.unpack(self.buf.clone(), self.packing)
                for kf in (False, True):
                    body(scratch[0], self.gray, self.mask, self.cam,
                         self.config, kf, scratch)
            torch.cuda.current_stream(dev).wait_stream(side)
            del scratch
            torch.cuda.synchronize(dev)
            for kf in (False, True):
                before = wrapper_globals()
                # The capture empties the allocator's cache first too: what
                # is reserved after it beyond this is the graph's pool.
                torch.cuda.empty_cache()
                reserved = torch.cuda.memory_reserved(dev)
                t0 = time.perf_counter()
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    body(self.views[0], self.gray, self.mask, self.cam,
                         self.config, kf, self.views)
                torch.cuda.synchronize(dev)
                self.capture_s[kf] = time.perf_counter() - t0
                self.pool_bytes[kf] = (torch.cuda.memory_reserved(dev)
                                       - reserved)
                after = wrapper_globals()
                self.launches[kf] = {k: after[k] - before[k] for k in after
                                     if k[1] in _COUNTS}
                self._handles[kf] = {k: v for k, v in after.items()
                                     if k[1] not in _COUNTS
                                     and v is not before[k]}
                self._graphs[kf] = graph
        finally:
            set_wrapper_globals(saved)

    def step(self, state, gray, mask, make_keyframe: bool):
        """``system.frame_step(state, gray, mask, cam, config,
        make_keyframe)`` by replay. Returns (state, FrameResult), a snapshot
        that no later step writes into."""
        kf = bool(make_keyframe)
        if gray.shape != self.gray.shape or mask.shape != self.mask.shape:
            raise ValueError(f"FrameGraph: frame {list(gray.shape)}, mask "
                             f"{list(mask.shape)}; captured for "
                             f"{list(self.gray.shape)}")
        if state is not self._last:
            tree.copy_(self.views[0], state)
        self.gray.copy_(gray)
        self.mask.copy_(mask)
        self._graphs[kf].replay()
        self.replays += 1
        counts = wrapper_globals()
        set_wrapper_globals({k: counts[k] + n
                             for k, n in self.launches[kf].items()})
        set_wrapper_globals(self._handles[kf])
        new_state, result = tree.unpack(self.buf.clone(), self.packing)
        self._last = new_state
        return new_state, result


# The host-side CUDA runtime calls that launch device work, as the
# profiler names them.
_HOST_LAUNCHES = ("cudaGraphLaunch", "cudaLaunchKernel", "cudaLaunchKernelExC",
                  "cuLaunchKernel", "cuLaunchKernelEx", "cudaMemcpyAsync",
                  "cudaMemsetAsync")


def profile_step(fg: FrameGraph, state, gray, mask, make_keyframe: bool):
    """``fg.step`` under ``torch.profiler``. Returns (state, result,
    reading): the device kernels of the replay (also kept as
    ``fg.kernels[kf]``), their summed device time in ms (``busy_ms``), the
    step's host-side launch calls by runtime API name (``host``) and its
    host wall in ms to the end of its enqueue (``enqueue_ms``) and to the
    end of the device work (``wall_ms``)."""
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
    fg.kernels[bool(make_keyframe)] = reading["kernels"]
    return out[0], out[1], reading
