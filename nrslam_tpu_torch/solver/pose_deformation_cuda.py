"""Wrapper of the joint pose+deformation LM kernel
(csrc/pose_deformation.cu), the counterpart of
nrslam_tpu/solver/pose_deformation_pallas.py.

The wrapper keeps the Pallas wrapper's edge handling: the (already
compacted) edge table is padded to a multiple of 128 with masked edges, the
base pair mask ``valid & point_valid[i] & point_valid[j]`` is formed here and
rest distances are clamped to >= 1e-12. It also builds, once per call, the
CSR of each point's incident live edges (stable sort on the endpoints) that
the kernel walks to scatter edge terms back to points. Post-gates stay in
``pose_deformation.pose_deformation_optimization``.

Takes CUDA tensors only and raises otherwise; the plain version is
``pose_deformation.pose_deformation_plain``. ``launches`` counts launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from nrslam_tpu_torch import kernels
from nrslam_tpu_torch.geometry import cameras, se3

launches = 0

_KINDS = {cameras.PINHOLE: 0, cameras.KB8: 1}


def incidence_csr(i, j, live, P: int):
    """(ptr [P+1], edge [2E], sign [2E]) listing, for every point, its live
    incident edges in edge order (+1 where it is the edge's i, -1 for j)."""
    E = i.shape[0]
    dev = i.device
    keys = torch.cat([torch.where(live, i, P), torch.where(live, j, P)])
    eid = torch.arange(E, dtype=torch.int32, device=dev).repeat(2)
    sign = torch.cat([torch.ones(E, dtype=torch.float32, device=dev),
                      -torch.ones(E, dtype=torch.float32, device=dev)])
    sorted_keys, perm = torch.sort(keys, stable=True)
    ptr = torch.searchsorted(sorted_keys,
                             torch.arange(P + 1, device=dev, dtype=keys.dtype))
    return (ptr.to(torch.int32).contiguous(), eid[perm].contiguous(),
            sign[perm].contiguous())


def pose_deformation_cuda(cam: cameras.Camera, Tcw0: se3.SE3, rest, obs,
                          point_valid, pairs, scale, rounds=(10, 10),
                          cg_iters: int = 10):
    """Run the whole joint schedule in one launch. rest [P, 3], obs [P, 2],
    point_valid [P] bool, pairs a compacted PairEdges. Returns
    (Tcw, flows [P, 3], chi2_r [P])."""
    global launches
    from nrslam_tpu_torch.solver.pose_deformation import infos_for

    P = rest.shape[0]
    if rest.shape != (P, 3) or obs.shape != (P, 2) \
            or point_valid.shape != (P,):
        raise ValueError("pose_deformation: expected rest [P,3], obs [P,2], "
                         "point_valid [P]")
    if len(rounds) > 4:
        raise ValueError("pose_deformation: at most 4 rounds")
    i = pairs.i.to(torch.int64)
    j = pairs.j.to(torch.int64)
    E_raw = i.shape[0]
    E = ((E_raw + 127) // 128) * 128
    pad = E - E_raw
    base = pairs.valid & point_valid[i] & point_valid[j]
    i = F.pad(i, (0, pad))
    j = F.pad(j, (0, pad))
    w = F.pad(pairs.w.to(torch.float32), (0, pad))
    d0 = torch.clamp(F.pad(pairs.d0.to(torch.float32), (0, pad), value=1.0),
                     min=1e-12)
    base = F.pad(base, (0, pad))
    inc_ptr, inc_edge, inc_sign = incidence_csr(i, j, base, P)

    info_r, info_s, info_p = infos_for(torch.as_tensor(
        scale, dtype=torch.float32, device=rest.device))
    params = torch.cat([
        F.pad(cam.params.to(torch.float32), (0, 8 - cam.params.shape[0])),
        Tcw0.q.to(torch.float32), Tcw0.t.to(torch.float32),
        torch.stack([torch.full_like(info_s, info_r), info_s,
                     torch.full_like(info_s, info_p)])]).contiguous()

    rest_c = rest.to(torch.float32).contiguous()
    obs_c = obs.to(torch.float32).contiguous()
    pmask = point_valid.to(torch.float32).contiguous()
    ei = i.to(torch.int32).contiguous()
    ej = j.to(torch.int32).contiguous()
    ebase = base.to(torch.float32).contiguous()
    dev = kernels.require_cuda("pose_deformation", rest_c, obs_c, pmask, ei,
                               ej, w, d0, ebase, inc_ptr, inc_edge, inc_sign,
                               params)
    lib = kernels.library()
    scratch = torch.empty(lib.nrslam_pose_deformation_scratch(P, E),
                          dtype=torch.float32, device=dev)
    out_pose = torch.empty(8, dtype=torch.float32, device=dev)
    out_flows = torch.empty((P, 3), dtype=torch.float32, device=dev)
    out_chi2 = torch.empty(P, dtype=torch.float32, device=dev)
    it = list(rounds) + [0] * (4 - len(rounds))
    rc = lib.nrslam_pose_deformation(
        *(t.data_ptr() for t in (params, rest_c, obs_c, pmask, ei, ej, w,
                                   d0, ebase, inc_ptr, inc_edge, inc_sign,
                                   scratch, out_pose, out_flows, out_chi2)),
        P, E, _KINDS[cam.kind], len(rounds), *it, cg_iters,
        kernels.stream_of(dev))
    kernels.check_launch("pose_deformation", rc)
    launches += 1
    q = out_pose[:4]
    return se3.SE3(q / torch.linalg.norm(q), out_pose[4:7]), out_flows, \
        out_chi2
