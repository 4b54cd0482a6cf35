"""Wrapper of the pose-only LM kernel (csrc/pose_only.cu), the counterpart
of nrslam_tpu/solver/pose_only_pallas.py.

Takes CUDA tensors only and raises otherwise; the plain PyTorch version is
``pose_only.camera_pose_optimization_plain``. ``launches`` counts the
kernel launches this wrapper made; ``last_lm_steps`` is a device tensor [1]
holding the LM steps the last launch ran.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from nrslam_tpu_torch import kernels
from nrslam_tpu_torch.geometry import cameras, se3

launches = 0
last_lm_steps = None

_KINDS = {cameras.PINHOLE: 0, cameras.KB8: 1}


def camera_pose_optimization_cuda(cam: cameras.Camera, Tcw0: se3.SE3,
                                  landmarks, obs, valid,
                                  rounds=(10, 10, 10)) -> se3.SE3:
    """Drop-in for the plain driver on CUDA tensors: landmarks [P, 3],
    obs [P, 2], valid [P] bool."""
    global launches, last_lm_steps
    P = landmarks.shape[0]
    if landmarks.shape != (P, 3) or obs.shape != (P, 2) \
            or valid.shape != (P,):
        raise ValueError("pose_only: expected landmarks [P,3], obs [P,2], "
                         "valid [P]")
    if len(rounds) > 4:
        raise ValueError("pose_only: at most 4 rounds")
    X = landmarks.to(torch.float32).contiguous()
    ob = obs.to(torch.float32).contiguous()
    vm = valid.to(torch.float32).contiguous()
    params = torch.cat([F.pad(cam.params.to(torch.float32),
                              (0, 8 - cam.params.shape[0])),
                        Tcw0.q.to(torch.float32), Tcw0.t.to(torch.float32),
                        torch.zeros(1, dtype=torch.float32,
                                    device=X.device)]).contiguous()
    dev = kernels.require_cuda("pose_only", X, ob, vm, params)
    level_mask = torch.empty(P, dtype=torch.float32, device=dev)
    out = torch.empty(8, dtype=torch.float32, device=dev)
    it = list(rounds) + [0] * (4 - len(rounds))
    lib = kernels.library()
    rc = lib.nrslam_pose_only(
        *(t.data_ptr() for t in (params, X, ob, vm, level_mask, out)),
        P, _KINDS[cam.kind], len(rounds), *it, kernels.stream_of(dev))
    kernels.check_launch("pose_only", rc)
    launches += 1
    last_lm_steps = out[7:]
    q = out[:4]
    return se3.SE3(q / torch.linalg.norm(q), out[4:7])
