"""Wrapper of the deformable triangulation kernel
(csrc/deformable_triangulation.cu): one launch per ``deformable_triangulate``
call on CUDA tensors, every candidate's pre-gates, seeds, LM solve, gates
and landmark inside.

``prepare`` checks the inputs, casts only where the kernel could not read a
tensor (the main path's tensors are float32 / bool, and the permuted views
``mapping._deformable_inputs`` builds are read through their strides,
uncopied), allocates the outputs and fills ``Params``, the mirror of the
kernel's parameter struct. It runs on any device, so the CPU tests hold
it. ``launch`` is the one kernel launch and raises unless every tensor lies
on one CUDA device; ``triangulate`` does both. There is no fallback: the
plain version is ``deformable_triangulation.deformable_triangulate_plain``,
which ``deformable_triangulate`` runs for CPU tensors.

A launch tallies ``deformable_triangulation.launches`` and keeps
``deformable_triangulation.last_accepted``, the device tensor [C] int32 of
the LM steps each candidate accepted (``utils.profiler``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from nrslam_tpu_torch import kernels
from nrslam_tpu_torch.utils import profiler

MAX_T = 32    # csrc/deformable_triangulation.cu kMaxT
MAX_NB = 32   # csrc/deformable_triangulation.cu kMaxNb


class Params(ctypes.Structure):
    """csrc/deformable_triangulation.cu::TriParams, field for field."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in (
            "cam", "obs", "track", "nbr_pos", "nbr_valid", "cand_valid",
            "pose_q", "pose_t", "landmark_out", "ok_out", "accepted_out")]
        + [(n, ctypes.c_longlong) for n in (
            "obs_sc", "obs_st", "obs_sk", "track_sc", "track_st", "nbr_sc",
            "nbr_sn", "nbr_st", "nbr_sk", "nv_sc", "nv_sn", "nv_st",
            "cand_s")]
        + [(n, ctypes.c_int) for n in (
            "C", "T", "NB", "kind", "min_track", "n_iters", "cg_iters")]
        + [("parallax_min", ctypes.c_float)])


class Prepared(NamedTuple):
    """One launch: its ``params``, the tensors they point into (held until
    the launch), and the outputs landmark [C, 3], ok [C] bool and accepted
    [C] int32."""

    params: Params
    tensors: tuple
    landmark: torch.Tensor
    ok: torch.Tensor
    accepted: torch.Tensor


def _f32(t):
    return t if t.dtype == torch.float32 else t.to(torch.float32)


def _u8(t):
    """A bool tensor's bytes, read where they lie."""
    return t.to(torch.bool).view(torch.uint8)


def prepare(cam, inputs, Tcw, rad_per_pixel: float, min_track: int = 5,
            n_iters: int = 10, cg_iters: int = 12) -> Prepared:
    """Checks, casts where needed and allocates one launch for
    ``deformable_triangulate``'s arguments, on whatever device they lie."""
    C, T, _ = inputs.obs.shape
    NB = inputs.nbr_pos.shape[1]
    if inputs.obs.shape != (C, T, 2) or inputs.track_valid.shape != (C, T) \
            or inputs.nbr_pos.shape != (C, NB, T, 3) \
            or inputs.nbr_valid.shape != (C, NB, T) \
            or inputs.cand_valid.shape != (C,) \
            or Tcw.q.shape != (T, 4) or Tcw.t.shape != (T, 3):
        raise ValueError("deformable_triangulation_cuda: expected obs "
                         "[C,T,2], track_valid [C,T], nbr_pos [C,NB,T,3], "
                         "nbr_valid [C,NB,T], cand_valid [C], poses [T]")
    if not 1 <= T <= MAX_T or not 1 <= NB <= MAX_NB:
        raise ValueError(f"deformable_triangulation_cuda: T={T}, NB={NB}; "
                         f"the kernel takes 1..{MAX_T} frames and 1.."
                         f"{MAX_NB} neighbours")
    if cam.kind not in kernels.CAMERA_KINDS \
            or cam.params.shape != (kernels.CAMERA_PARAMS[cam.kind],):
        raise ValueError(f"deformable_triangulation_cuda: camera "
                         f"{cam.kind} with {tuple(cam.params.shape)} "
                         "parameters")
    if n_iters < 0 or cg_iters < 0:
        raise ValueError("deformable_triangulation_cuda: negative schedule")

    cam_p = _f32(cam.params).contiguous()
    obs = _f32(inputs.obs)
    track = _u8(inputs.track_valid)
    nbr_pos = _f32(inputs.nbr_pos)
    nbr_valid = _u8(inputs.nbr_valid)
    cand = _u8(inputs.cand_valid)
    q = _f32(Tcw.q).contiguous()
    t = _f32(Tcw.t).contiguous()

    dev = obs.device
    landmark = torch.empty((C, 3), dtype=torch.float32, device=dev)
    ok = torch.empty((C,), dtype=torch.bool, device=dev)
    accepted = torch.empty((C,), dtype=torch.int32, device=dev)

    prm = Params()
    for name, x in (("cam", cam_p), ("obs", obs), ("track", track),
                    ("nbr_pos", nbr_pos), ("nbr_valid", nbr_valid),
                    ("cand_valid", cand), ("pose_q", q), ("pose_t", t),
                    ("landmark_out", landmark), ("ok_out", ok),
                    ("accepted_out", accepted)):
        setattr(prm, name, x.data_ptr())
    prm.obs_sc, prm.obs_st, prm.obs_sk = obs.stride()
    prm.track_sc, prm.track_st = track.stride()
    prm.nbr_sc, prm.nbr_sn, prm.nbr_st, prm.nbr_sk = nbr_pos.stride()
    prm.nv_sc, prm.nv_sn, prm.nv_st = nbr_valid.stride()
    (prm.cand_s,) = cand.stride()
    prm.C, prm.T, prm.NB = C, T, NB
    prm.kind = kernels.CAMERA_KINDS[cam.kind]
    prm.min_track, prm.n_iters, prm.cg_iters = min_track, n_iters, cg_iters
    # rigid_pregate's threshold: the product in double, then the float32
    # the comparison with a float32 tensor reads.
    prm.parallax_min = rad_per_pixel * 5.0

    tensors = (cam_p, obs, track, nbr_pos, nbr_valid, cand, q, t, landmark,
               ok, accepted)
    return Prepared(prm, tensors, landmark, ok, accepted)


@functools.lru_cache(maxsize=None)
def layout(lib: ctypes.CDLL) -> tuple:
    """(bytes of TriParams, most frames, most neighbours, threads a block)
    of the built kernel; raises unless ``Params`` mirrors it."""
    out = (ctypes.c_int * 4)()
    kernels.check_launch(
        "deformable triangulation layout",
        lib.nrslam_deformable_triangulation_layout(ctypes.addressof(out)))
    got = tuple(out)
    if got[:3] != (ctypes.sizeof(Params), MAX_T, MAX_NB):
        raise RuntimeError(
            f"deformable_triangulation_cuda: the kernel's layout {got} does "
            f"not match Params ({ctypes.sizeof(Params)} bytes, {MAX_T} "
            f"frames, {MAX_NB} neighbours)")
    return got


def launch(prep: Prepared):
    """Run the kernel on a prepared launch; returns (landmark [C, 3], ok
    [C], accepted [C] int32). Raises unless every tensor lies on one CUDA
    device, and on a launch error."""
    dev = prep.landmark.device
    for x in prep.tensors:
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError("deformable_triangulation_cuda: expected "
                             f"tensors on one CUDA device, got {x.device}")
    if prep.params.C:  # no candidates: nothing to launch
        lib = kernels.library()
        layout(lib)
        kernels.check_launch("deformable triangulation",
                             lib.nrslam_deformable_triangulation(
                                 ctypes.addressof(prep.params),
                                 kernels.stream_of(dev)))
        profiler.tally("deformable_triangulation.launches")
    profiler.keep("deformable_triangulation.last_accepted", prep.accepted)
    return prep.landmark, prep.ok, prep.accepted


def triangulate(cam, inputs, Tcw, rad_per_pixel: float, min_track: int = 5,
                n_iters: int = 10, cg_iters: int = 12):
    """``deformable_triangulate`` on CUDA tensors in one launch: (landmarks
    [C, 3], ok [C], LM steps accepted [C] int32)."""
    return launch(prepare(cam, inputs, Tcw, rad_per_pixel, min_track,
                          n_iters, cg_iters))
