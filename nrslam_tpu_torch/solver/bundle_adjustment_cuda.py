"""Wrapper of the local deformable BA kernel (csrc/bundle_adjustment.cu), the
counterpart of nrslam_tpu/solver/bundle_adjustment_pallas.py.

The wrapper forms the factor masks as ``bundle_adjustment._masks`` does
(observed copies [K, P], springs [K, E], dampers [K-1, E] padded with a zero
row to [K, E]), clamps rest distances to >= 1e-12 and builds, once per call,
the kernel's per-block layout (``pose_deformation_cuda.cluster_layout``) over
the edges any keyframe uses; one edge table serves all K keyframes. It reads
nothing back to the host: sizes come from tensor shapes. Unlike the Pallas
wrapper it does not sanitise unobserved copies: the kernel skips every
masked term and returns those copies unchanged.

``prepare`` builds a launch's inputs and layout, ``launch`` runs the kernel
on them (``local_deformable_ba_cuda`` does both). Takes CUDA tensors only
and raises otherwise, or when the card refuses the cluster; the plain
version is ``bundle_adjustment.local_deformable_ba_plain``. ``launches``
counts launches; ``last_work`` is the device header of the last launch
(``pose_deformation_cuda.WORK_FIELDS``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from nrslam_tpu_torch import kernels
from nrslam_tpu_torch.geometry import cameras, se3
from nrslam_tpu_torch.solver.pose_deformation_cuda import (
    WORK_FIELDS, Prepared, cluster_layout)

launches = 0
last_work = None

MAX_K = 8
_KINDS = {cameras.PINHOLE: 0, cameras.KB8: 1}


def prepare(cam: cameras.Camera, poses0: se3.SE3, L0, problem,
            n_iters: int = 5, cg_iters: int = 32) -> Prepared:
    """Inputs, layout, scratch and outputs of one launch (device ops)."""
    from nrslam_tpu_torch.solver.bundle_adjustment import _masks

    K, P, _ = L0.shape
    if not 1 <= K <= MAX_K:
        raise ValueError(f"bundle_adjustment: 1 <= K <= {MAX_K}, got {K}")
    if problem.obs.shape != (K, P, 2) or problem.obs_valid.shape != (K, P) \
            or poses0.q.shape != (K, 4):
        raise ValueError("bundle_adjustment: expected poses0 [K], L0 [K,P,3], "
                         "obs [K,P,2], obs_valid [K,P]")
    pairs = problem.pairs
    i = pairs.i.to(torch.int64)
    j = pairs.j.to(torch.int64)
    E = i.shape[0]
    obs_ok, spring, damper = _masks(problem._replace(
        pairs=pairs._replace(i=i, j=j)))
    dmask = torch.cat([damper, torch.zeros_like(spring[:1])])

    sigma_s = 0.1 * torch.as_tensor(problem.scale, dtype=torch.float32,
                                    device=L0.device)
    params = torch.cat([
        F.pad(cam.params.to(torch.float32), (0, 8 - cam.params.shape[0])),
        torch.cat([poses0.q.to(torch.float32), poses0.t.to(torch.float32),
                   torch.zeros((K, 1), dtype=torch.float32,
                               device=L0.device)], dim=-1).reshape(-1),
        (1.0 / (sigma_s * sigma_s)).reshape(1)]).contiguous()

    tensors = (params, L0.to(torch.float32).contiguous(),
               problem.obs.to(torch.float32).contiguous(),
               obs_ok.to(torch.float32).contiguous(),
               i.to(torch.int32).contiguous(), j.to(torch.int32).contiguous(),
               pairs.w.to(torch.float32).contiguous(),
               torch.clamp(pairs.d0.to(torch.float32), min=1e-12).contiguous(),
               spring.to(torch.float32).contiguous(),
               dmask.to(torch.float32).contiguous())
    dev = kernels.require_cuda("bundle_adjustment", *tensors)
    lib = kernels.library()
    tensors += cluster_layout(i, j, torch.any(spring, 0), P,
                              lib.nrslam_ba_blocks())
    n_ends = 2 * E
    scratch = torch.empty(lib.nrslam_ba_scratch(K, P, n_ends),
                          dtype=torch.float32, device=dev)
    out = (torch.empty((K, 8), dtype=torch.float32, device=dev),
           torch.empty((K, P, 3), dtype=torch.float32, device=dev))
    sizes = (K, P, E, n_ends, _KINDS[cam.kind], n_iters, cg_iters)
    return Prepared(tensors, sizes, scratch, out)


def launch(prep: Prepared):
    """Run the kernel on a prepared launch; returns (poses [K, 8],
    landmarks [K, P, 3]), the tensors of ``prep.out``."""
    global launches, last_work
    dev = prep.scratch.device
    rc = kernels.library().nrslam_ba(
        *(t.data_ptr() for t in (*prep.tensors, prep.scratch, *prep.out)),
        *prep.sizes, kernels.stream_of(dev))
    kernels.check_launch("bundle_adjustment", rc)
    launches += 1
    last_work = prep.scratch[:len(WORK_FIELDS)].view(torch.int32)
    return prep.out


def local_deformable_ba_cuda(cam: cameras.Camera, poses0: se3.SE3, L0,
                             problem, n_iters: int = 5, cg_iters: int = 32):
    """Drop-in for the plain driver on CUDA tensors: poses0 [K], L0 [K, P, 3],
    ``problem`` a ``bundle_adjustment.BAProblem``. Returns (poses [K],
    landmarks [K, P, 3])."""
    out_pose, out_L = launch(prepare(cam, poses0, L0, problem, n_iters,
                                     cg_iters))
    q = out_pose[:, :4]
    return se3.SE3(q / torch.linalg.norm(q, dim=-1, keepdim=True),
                   out_pose[:, 4:7]), out_L
