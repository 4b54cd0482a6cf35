"""Wrapper of the joint pose+deformation LM kernel
(csrc/pose_deformation.cu), the counterpart of
nrslam_tpu/solver/pose_deformation_pallas.py.

The wrapper keeps the Pallas wrapper's edge handling: the (already
compacted) edge table is padded to a multiple of 128 with masked edges, the
base pair mask ``valid & point_valid[i] & point_valid[j]`` is formed here and
rest distances are clamped to >= 1e-12. It also builds, once per call and
with device ops only, the kernel's per-block layout (``cluster_layout``):
which points each block of the cluster owns and, through the CSR of each
point's incident live edges, which edge-ends. Post-gates stay in
``pose_deformation.pose_deformation_optimization``.

``prepare`` builds a launch's inputs and layout, ``launch`` runs the kernel
on them (``pose_deformation_cuda`` does both). Takes CUDA tensors only and
raises otherwise, or when the card refuses the cluster; the plain version is
``pose_deformation.pose_deformation_plain``. ``launches`` counts launches;
``last_work`` is the device header of the last launch (``WORK_FIELDS``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from nrslam_tpu_torch import kernels
from nrslam_tpu_torch.geometry import cameras, se3

launches = 0
last_work = None

# The int32 header the kernels write at the start of their scratch.
WORK_FIELDS = ("lm_steps", "cg_trips", "linearizations", "blocks",
               "edge_ends_in_smem", "full_vectors_in_smem", "smem_bytes",
               "owned_state_in_smem")

_KINDS = {cameras.PINHOLE: 0, cameras.KB8: 1}


def incidence_csr(i, j, live, P: int):
    """(ptr [P+1], edge [2E], sign [2E]) listing, for every point, its live
    incident edges in edge order (+1 where it is the edge's i, -1 for j).
    Dead edges' entries sort to the end, past ptr[P]."""
    E = i.shape[0]
    dev = i.device
    # Both ends of edge e at positions 2e, 2e + 1: a stable sort by point
    # keeps each point's edges in edge order.
    keys = torch.stack([torch.where(live, i, P), torch.where(live, j, P)],
                       dim=1).reshape(-1)
    eid = torch.arange(E, dtype=torch.int32,
                       device=dev).repeat_interleave(2)
    sign = 1.0 - 2.0 * (torch.arange(2 * E, device=dev) % 2).to(
        torch.float32)
    sorted_keys, perm = torch.sort(keys, stable=True)
    ptr = torch.searchsorted(sorted_keys,
                             torch.arange(P + 1, device=dev, dtype=keys.dtype))
    return (ptr.to(torch.int32).contiguous(), eid[perm].contiguous(),
            sign[perm].contiguous())


class Layout(NamedTuple):
    """Per-block layout of a cluster launch. Block r owns the points
    [pt_off[r], pt_off[r+1]) (ceil(P / blocks) rounded up to a multiple of
    4 each, the last ones fewer) and the edge-ends at CSR positions
    [inc_ptr[pt_off[r]], inc_ptr[pt_off[r+1]]): its points' incident live
    edges, each point's in edge order."""

    pt_off: torch.Tensor    # [blocks + 1] int32
    inc_ptr: torch.Tensor   # [P + 1] int32
    inc_edge: torch.Tensor  # [2E] int32
    inc_sign: torch.Tensor  # [2E] float32, +1 at the edge's i, -1 at j


def cluster_layout(i, j, live, P: int, blocks: int) -> Layout:
    """The layout for ``blocks`` blocks, from device ops (no host sync)."""
    step = (-(-P // blocks) + 3) // 4 * 4
    pt_off = torch.clamp(torch.arange(blocks + 1, dtype=torch.int32,
                                      device=i.device) * step, max=P)
    return Layout(pt_off.contiguous(), *incidence_csr(i, j, live, P))


class Prepared(NamedTuple):
    """One launch's device arguments in the C entry point's order, sizes,
    and the outputs each launch overwrites."""

    tensors: tuple
    sizes: tuple
    scratch: torch.Tensor
    out: tuple  # (pose [8], flows [P, 3], chi2 [P])


def prepare(cam: cameras.Camera, Tcw0: se3.SE3, rest, obs, point_valid,
            pairs, scale, rounds=(10, 10), cg_iters: int = 10) -> Prepared:
    """Inputs, layout, scratch and outputs of one launch (device ops)."""
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

    info_r, info_s, info_p = infos_for(torch.as_tensor(
        scale, dtype=torch.float32, device=rest.device))
    params = torch.cat([
        F.pad(cam.params.to(torch.float32), (0, 8 - cam.params.shape[0])),
        Tcw0.q.to(torch.float32), Tcw0.t.to(torch.float32),
        torch.stack([torch.full_like(info_s, info_r), info_s,
                     torch.full_like(info_s, info_p)])]).contiguous()

    tensors = (params, rest.to(torch.float32).contiguous(),
               obs.to(torch.float32).contiguous(),
               point_valid.to(torch.float32).contiguous(),
               i.to(torch.int32).contiguous(), j.to(torch.int32).contiguous(),
               w, d0, base.to(torch.float32).contiguous())
    dev = kernels.require_cuda("pose_deformation", *tensors)
    lib = kernels.library()
    tensors += cluster_layout(i, j, base, P,
                              lib.nrslam_pose_deformation_blocks())
    n_ends = 2 * E
    scratch = torch.empty(lib.nrslam_pose_deformation_scratch(P, n_ends),
                          dtype=torch.float32, device=dev)
    out = (torch.empty(8, dtype=torch.float32, device=dev),
           torch.empty((P, 3), dtype=torch.float32, device=dev),
           torch.empty(P, dtype=torch.float32, device=dev))
    it = list(rounds) + [0] * (4 - len(rounds))
    sizes = (P, E, n_ends, _KINDS[cam.kind], len(rounds), *it, cg_iters)
    return Prepared(tensors, sizes, scratch, out)


def launch(prep: Prepared):
    """Run the kernel on a prepared launch; returns (pose [8], flows [P, 3],
    chi2 [P]), the tensors of ``prep.out``."""
    global launches, last_work
    dev = prep.scratch.device
    rc = kernels.library().nrslam_pose_deformation(
        *(t.data_ptr() for t in (*prep.tensors, prep.scratch, *prep.out)),
        *prep.sizes, kernels.stream_of(dev))
    kernels.check_launch("pose_deformation", rc)
    launches += 1
    last_work = prep.scratch[:len(WORK_FIELDS)].view(torch.int32)
    return prep.out


def pose_deformation_cuda(cam: cameras.Camera, Tcw0: se3.SE3, rest, obs,
                          point_valid, pairs, scale, rounds=(10, 10),
                          cg_iters: int = 10):
    """Run the whole joint schedule in one launch. rest [P, 3], obs [P, 2],
    point_valid [P] bool, pairs a compacted PairEdges. Returns
    (Tcw, flows [P, 3], chi2_r [P])."""
    out_pose, out_flows, out_chi2 = launch(prepare(
        cam, Tcw0, rest, obs, point_valid, pairs, scale, rounds, cg_iters))
    q = out_pose[:4]
    return se3.SE3(q / torch.linalg.norm(q), out_pose[4:7]), out_flows, \
        out_chi2
