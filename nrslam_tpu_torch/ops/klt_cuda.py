"""Wrapper of the KLT kernel (csrc/klt.cu): one launch per ``klt.track``
call on CUDA tensors, every level, iteration and the SSIM gate inside.

``prepare`` checks the inputs, casts or copies only where the kernel could
not read a tensor where it lies (the main path's tensors are float32 / int32
/ bool with contiguous windows, and ``KLTRefs.level_slice`` views are read
through their strides, uncopied), allocates the outputs and fills
``Params``, the mirror of the kernel's parameter struct: each level's image
and gradient pointers and sizes, the reference fields' pointers and
strides. It runs on any device, so the CPU tests hold it. ``launch`` is the
one kernel launch and raises unless every tensor lies on one CUDA device;
``track`` does both. There is no fallback: the plain version is
``klt.track_plain``, which ``klt.track`` runs for CPU tensors.

A launch tallies ``klt.launches`` and keeps ``klt.last_iterations``, the
device tensor [P] int32 of the LK iterations each point ran, summed over
levels (``utils.profiler``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from nrslam_tpu_torch import kernels
from nrslam_tpu_torch.utils import profiler

MAX_LEVELS = 8  # csrc/klt.cu kMaxLevels
WIN = 21        # csrc/klt.cu kWin
_INT_MAX = 2 ** 31 - 1


class Level(ctypes.Structure):
    _fields_ = [("img", ctypes.c_void_p), ("grad", ctypes.c_void_p),
                ("h", ctypes.c_int), ("w", ctypes.c_int)]


class Params(ctypes.Structure):
    """csrc/klt.cu::KltParams, field for field."""

    _fields_ = (
        [("level", Level * MAX_LEVELS)]
        + [(n, ctypes.c_void_p) for n in (
            "ref_points", "patch", "patch_grad", "mean_i", "mean_i2",
            "valid", "seeds", "status_in", "pts_out", "status_out",
            "iters_out")]
        + [(n, ctypes.c_longlong) for n in (
            "patch_sp", "patch_sl", "grad_sp", "grad_sl")]
        + [(n, ctypes.c_int) for n in (
            "ref_points_sp", "mean_i_sp", "mean_i_sl", "mean_i2_sp",
            "mean_i2_sl", "valid_sp", "valid_sl", "n_levels", "P",
            "max_iters", "use_initial_flow")]
        + [(n, ctypes.c_float) for n in (
            "epsilon", "min_eig_threshold", "min_ssim")])


class Prepared(NamedTuple):
    """One launch: its ``params``, the tensors they point into (held until
    the launch), and the outputs pts [P, 2], status [P] int32 and iters
    [P] int32; ``status_dtype`` is the caller's."""

    params: Params
    tensors: tuple
    pts: torch.Tensor
    status: torch.Tensor
    iters: torch.Tensor
    status_dtype: torch.dtype


def _f32(t):
    return t if t.dtype == torch.float32 else t.to(torch.float32)


def _aligned(t, inner: tuple, align: int = 4):
    """``t`` if its trailing dims have the ``inner`` strides and its data
    pointer and leading strides keep ``align``-byte alignment; else a
    contiguous copy (a fresh allocation, so aligned)."""
    n = len(inner)
    lead = t.stride()[:-n] if n else t.stride()
    ok = (tuple(t.stride()[t.dim() - n:]) == inner
          and t.data_ptr() % align == 0
          and all(s * t.element_size() % align == 0 for s in lead))
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def prepare(pyramid, refs, seeds, statuses, config, min_ssim: float,
            use_initial_flow: bool = True) -> Prepared:
    """Checks, casts or copies where needed and allocates one launch for
    ``klt.track``'s arguments, on whatever device they lie."""
    L = len(pyramid)
    P = seeds.shape[0]
    if config.win != WIN:
        raise ValueError(f"klt_cuda: the kernel's window is {WIN}, not "
                         f"{config.win}")
    if not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"klt_cuda: {L} pyramid levels, at most "
                         f"{MAX_LEVELS}")
    Lr = refs.patch.shape[1]
    if seeds.shape != (P, 2) or statuses.shape != (P,) \
            or refs.points.shape != (P, 2) \
            or refs.patch.shape != (P, Lr, WIN, WIN) \
            or refs.patch_grad.shape != (P, Lr, WIN, WIN, 2) \
            or refs.mean_i.shape != (P, Lr) \
            or refs.mean_i2.shape != (P, Lr) \
            or refs.valid.shape != (P, Lr) or Lr < L:
        raise ValueError("klt_cuda: expected seeds [P,2], statuses [P] and "
                         f"refs of >= {L} levels of {WIN}x{WIN} windows")

    levels = []
    for img, grad in pyramid:
        h, w = img.shape
        if grad.shape != (h, w, 2):
            raise ValueError("klt_cuda: a level's gradient is not [h, w, 2]")
        levels.append((_aligned(_f32(img), (w, 1)),
                       _aligned(_f32(grad), (2 * w, 2, 1), 8), h, w))
    points = _aligned(_f32(refs.points), (1,))
    patch = _aligned(_f32(refs.patch), (WIN, 1))
    patch_grad = _aligned(_f32(refs.patch_grad), (2 * WIN, 2, 1), 8)
    mean_i, mean_i2 = _f32(refs.mean_i), _f32(refs.mean_i2)
    valid = refs.valid.to(torch.bool).view(torch.uint8)
    seeds_c = _f32(seeds).contiguous()
    status_in = statuses.to(torch.int32).contiguous()

    dev = seeds.device
    pts = torch.empty((P, 2), dtype=torch.float32, device=dev)
    status = torch.empty((P,), dtype=torch.int32, device=dev)
    iters = torch.empty((P,), dtype=torch.int32, device=dev)

    ints = (points.stride(0), *mean_i.stride(), *mean_i2.stride(),
            *valid.stride())
    if any(abs(s) > _INT_MAX for s in ints) or P > _INT_MAX:
        raise ValueError("klt_cuda: strides beyond 32 bits")

    prm = Params()
    for k, (img, grad, h, w) in enumerate(levels):
        prm.level[k] = Level(img.data_ptr(), grad.data_ptr(), h, w)
    for name, t in (("ref_points", points), ("patch", patch),
                    ("patch_grad", patch_grad), ("mean_i", mean_i),
                    ("mean_i2", mean_i2), ("valid", valid),
                    ("seeds", seeds_c), ("status_in", status_in),
                    ("pts_out", pts), ("status_out", status),
                    ("iters_out", iters)):
        setattr(prm, name, t.data_ptr())
    prm.patch_sp, prm.patch_sl = patch.stride(0), patch.stride(1)
    prm.grad_sp, prm.grad_sl = patch_grad.stride(0), patch_grad.stride(1)
    prm.ref_points_sp = points.stride(0)
    prm.mean_i_sp, prm.mean_i_sl = mean_i.stride()
    prm.mean_i2_sp, prm.mean_i2_sl = mean_i2.stride()
    prm.valid_sp, prm.valid_sl = valid.stride()
    prm.n_levels, prm.P = L, P
    prm.max_iters = config.max_iters
    prm.use_initial_flow = int(bool(use_initial_flow))
    prm.epsilon = config.epsilon
    prm.min_eig_threshold = config.min_eig_threshold
    prm.min_ssim = min_ssim

    tensors = tuple(t for lv in levels for t in lv[:2]) + (
        points, patch, patch_grad, mean_i, mean_i2, valid, seeds_c,
        status_in, pts, status, iters)
    return Prepared(prm, tensors, pts, status, iters, statuses.dtype)


@functools.lru_cache(maxsize=None)
def layout(lib: ctypes.CDLL) -> tuple:
    """(bytes of KltParams, most levels, window side, points a block) of
    the built kernel; raises unless ``Params`` mirrors it."""
    out = (ctypes.c_int * 4)()
    kernels.check_launch("klt layout",
                         lib.nrslam_klt_layout(ctypes.addressof(out)))
    got = tuple(out)
    if got[:3] != (ctypes.sizeof(Params), MAX_LEVELS, WIN):
        raise RuntimeError(f"klt_cuda: the kernel's layout {got} does not "
                           f"match Params ({ctypes.sizeof(Params)} bytes, "
                           f"{MAX_LEVELS} levels, window {WIN})")
    return got


def launch(prep: Prepared):
    """Run the kernel on a prepared launch; returns (pts [P, 2], status [P]
    in the caller's dtype, iters [P] int32). Raises unless every tensor
    lies on one CUDA device, and on a launch error."""
    dev = prep.pts.device
    for t in prep.tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError("klt_cuda: expected tensors on one CUDA device, "
                             f"got {t.device}")
    if prep.params.P:  # no points: nothing to launch
        lib = kernels.library()
        layout(lib)
        kernels.check_launch("klt", lib.nrslam_klt(
            ctypes.addressof(prep.params), kernels.stream_of(dev)))
        profiler.tally("klt.launches")
    profiler.keep("klt.last_iterations", prep.iters)
    status = prep.status
    if status.dtype != prep.status_dtype:
        status = status.to(prep.status_dtype)
    return prep.pts, status, prep.iters


def track(pyramid, refs, seeds, statuses, config, min_ssim: float,
          use_initial_flow: bool = True):
    """``klt.track`` on CUDA tensors in one launch: (points [P, 2],
    statuses [P], LK iterations [P] int32)."""
    return launch(prepare(pyramid, refs, seeds, statuses, config, min_ssim,
                          use_initial_flow))
