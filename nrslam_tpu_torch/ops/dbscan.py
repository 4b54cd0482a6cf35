"""DBSCAN over dense pairwise distances (counterpart of
nrslam_tpu/ops/dbscan.py; reference utilities/dbscan.cc):

- 2D: eps 0.2 on coordinates divided by their largest norm, min_pts 3
  (dbscan.cc:30-46);
- 3D: eps 2.5, min_pts 5 (dbscan.cc:49-96);
- ND: eps 0.1 x dim, min_pts 10 (dbscan.cc:99-131), used on optical-flow
  tracks.

Labels are 0.. for clusters, ordered by descending size (ties by the
lowest label, stable as ``jnp.argsort``), and -1 for noise and invalid
points.

The JAX package propagates labels in a ``lax.while_loop`` until nothing
changes. Here the loop is on the host: it runs ``CHECK_EVERY`` trips on the
device between reads of one "changed" flag, so it reads the device once per
batch of trips; trips after the fixed point leave the labels as they are,
so the result is the JAX package's. DBSCAN is off the frame path: the viz
dumps cluster feature-flow tracks with it.
"""

from __future__ import annotations

import torch

CHECK_EVERY = 8


def _dbscan_dense(X, valid, eps: float, min_pts: int):
    """Core points are valid points with >= min_pts neighbours within eps
    (self included, the mlpack convention); clusters are the connected
    components of the core-core graph, found by propagating the lowest
    index; border points take the lowest label of a core neighbour."""
    N = X.shape[0]
    d2 = torch.sum((X[:, None] - X[None]) ** 2, dim=-1)
    adj = (d2 <= eps * eps) & valid[:, None] & valid[None, :]
    core = valid & (torch.sum(adj, dim=1) >= min_pts)
    core_adj = adj & core[:, None] & core[None, :]
    idx = torch.arange(N, device=X.device)
    none = torch.full((N, N), N, dtype=idx.dtype, device=X.device)
    labels = torch.where(core, idx, torch.full_like(idx, N))

    while True:
        before = labels
        for _ in range(CHECK_EVERY):
            new = torch.amin(torch.where(core_adj, labels[None, :], none),
                             dim=1)
            labels = torch.minimum(labels, new)
        if not bool(torch.any(labels != before)):
            break

    border = torch.amin(torch.where(adj & core[None, :], labels[None, :],
                                    none), dim=1)
    labels = torch.where(core, labels, border)
    is_noise = labels >= N

    sizes = torch.sum((labels[None, :] == idx[:, None]) & ~is_noise[None, :],
                      dim=1)
    order = torch.sort(-sizes, stable=True).indices
    rank = torch.zeros(N, dtype=torch.int64, device=X.device)
    rank[order] = idx
    out = torch.where(is_noise | ~valid, torch.full_like(idx, -1),
                      rank[torch.clamp(labels, 0, N - 1)])
    return out.to(torch.int32)


def _valid_or_all(points, valid):
    if valid is None:
        return torch.ones(points.shape[0], dtype=torch.bool,
                          device=points.device)
    return valid


def dbscan_2d(points, valid=None):
    """Dbscan2D (dbscan.cc:30-46): coordinates divided by their max norm."""
    valid = _valid_or_all(points, valid)
    norms = torch.linalg.norm(points, dim=-1)
    scale = torch.clamp(torch.amax(torch.where(valid, norms,
                                               torch.zeros_like(norms))),
                        min=1e-12)
    return _dbscan_dense(points / scale, valid, eps=0.2, min_pts=3)


def dbscan_3d(points, valid=None, eps: float = 2.5):
    """Dbscan3D (dbscan.cc:49-96); eps is per-sequence in the reference."""
    return _dbscan_dense(points, _valid_or_all(points, valid), eps=eps,
                         min_pts=5)


def dbscan_nd(tracks, valid=None):
    """DbscanND (dbscan.cc:99-131): eps = 0.1 x dim, min_pts 10."""
    return _dbscan_dense(tracks, _valid_or_all(tracks, valid),
                         eps=0.1 * tracks.shape[-1], min_pts=10)
