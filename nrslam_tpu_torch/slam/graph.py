"""Dynamic deformation graph as dense masked [P, P] edge-state matrices
(counterpart of nrslam_tpu/slam/graph.py; same layout, for parity).

Edge state: first/max/min distance, RBF weight of the max distance, ``bad``
when the relative stretch exceeds 1.1; usable edges need weight >=
exp(-1.125) (the 1.5-sigma cutoff).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from nrslam_tpu_torch.utils.device import resolve

STRETCH_THRESHOLD = 1.1
MIN_WEIGHT = math.exp(-1.125)


def rbf_weight(distance, sigma):
    return torch.exp(-(distance * distance) / (2.0 * sigma * sigma))


class GraphState(NamedTuple):
    exists: torch.Tensor          # [P, P] bool (symmetric)
    bad: torch.Tensor             # [P, P] bool
    first_distance: torch.Tensor  # [P, P]
    max_distance: torch.Tensor    # [P, P]
    min_distance: torch.Tensor    # [P, P]
    weight: torch.Tensor          # [P, P]
    sigma: torch.Tensor           # scalar


def empty(capacity: int, sigma: float = 10.5, device=None) -> GraphState:
    """On the card unless ``device`` says otherwise (``utils.device``)."""
    device = resolve(device)
    z = torch.zeros((capacity, capacity), dtype=torch.float32, device=device)
    f = torch.zeros((capacity, capacity), dtype=torch.bool, device=device)
    return GraphState(exists=f, bad=f.clone(), first_distance=z,
                      max_distance=z.clone(), min_distance=z.clone(),
                      weight=z.clone(),
                      sigma=torch.tensor(sigma, dtype=torch.float32,
                                         device=device))


def _pair_distances(positions):
    d = positions[:, None, :] - positions[None, :, :]
    return torch.sqrt(torch.clamp(torch.sum(d * d, dim=-1), min=1e-20))


def _eye(P, device):
    return torch.eye(P, dtype=torch.bool, device=device)


def initialize(graph: GraphState, positions, valid, sigma) -> GraphState:
    """All-pairs graph over the valid slots (map.cc:139-167)."""
    P = positions.shape[0]
    dist = _pair_distances(positions)
    pair = valid[:, None] & valid[None, :] & ~_eye(P, positions.device)
    sigma = torch.as_tensor(sigma, dtype=torch.float32,
                            device=positions.device)
    zero = torch.zeros_like(dist)
    return GraphState(
        exists=pair,
        bad=torch.zeros_like(pair),
        first_distance=torch.where(pair, dist, zero),
        max_distance=torch.where(pair, dist, zero),
        min_distance=torch.where(pair, dist, zero),
        weight=torch.where(pair, rbf_weight(dist, sigma), zero),
        sigma=sigma,
    )


def add_edges(graph: GraphState, positions, new_mask,
              existing_mask) -> GraphState:
    """Star edges from every new landmark to every existing one."""
    P = positions.shape[0]
    dist = _pair_distances(positions)
    pair_new = ((new_mask[:, None] & existing_mask[None, :])
                | (existing_mask[:, None] & new_mask[None, :])
                | (new_mask[:, None] & new_mask[None, :]))
    pair_new = pair_new & ~_eye(P, positions.device) & ~graph.exists
    w = rbf_weight(dist, graph.sigma)
    return graph._replace(
        exists=graph.exists | pair_new,
        bad=graph.bad & ~pair_new,
        first_distance=torch.where(pair_new, dist, graph.first_distance),
        max_distance=torch.where(pair_new, dist, graph.max_distance),
        min_distance=torch.where(pair_new, dist, graph.min_distance),
        weight=torch.where(pair_new, w, graph.weight),
    )


def update_vertices(graph: GraphState, positions, update_mask):
    """Refresh distance extremes / weights / stretch pruning of every edge
    touching ``update_mask``. Returns (graph, good_connections [P])."""
    dist = _pair_distances(positions)
    touched = (update_mask[:, None] | update_mask[None, :]) & graph.exists
    max_d = torch.where(touched, torch.maximum(graph.max_distance, dist),
                        graph.max_distance)
    min_d = torch.where(touched, torch.minimum(graph.min_distance, dist),
                        graph.min_distance)
    weight = torch.where(touched, rbf_weight(max_d, graph.sigma),
                         graph.weight)
    stretch_bad = torch.abs((max_d - min_d) / torch.clamp(min_d, min=1e-12)) \
        > STRETCH_THRESHOLD
    bad = graph.bad | (touched & stretch_bad)
    good = torch.sum((touched & ~stretch_bad).to(torch.int32), dim=1,
                     dtype=torch.int32)
    return graph._replace(max_distance=max_d, min_distance=min_d,
                          weight=weight, bad=bad), good


def top_k_neighbors(graph: GraphState, eligible, k: int):
    """Per-landmark top-k usable neighbours by weight (ties lowest index
    first). Returns (idx [P, k] int64, weight, first_distance, valid)."""
    usable = graph.exists & ~graph.bad & (graph.weight >= MIN_WEIGHT) \
        & eligible[None, :]
    scores = torch.where(usable, graph.weight,
                         torch.full_like(graph.weight, -1.0))
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    top_w, top_idx = vals[:, :k], idx[:, :k]
    valid = top_w > 0.0
    d0 = torch.gather(graph.first_distance, 1, top_idx)
    return top_idx, torch.clamp(top_w, min=0.0), d0, valid


def neighborhood_rings(graph: GraphState, seed_mask, k: int):
    """0th/1st/2nd-order neighbourhood rings of a seed landmark set
    (GetOptimizationNeighbours, regularization_graph.cc:159-232): ring1 =
    the top-k usable neighbours of the seeds outside the seeds, ring2 = the
    top-k usable neighbours of ring1 outside rings 0 and 1. Returns
    (ring0, ring1, ring2), bool [P] each."""
    usable = graph.exists & ~graph.bad & (graph.weight >= MIN_WEIGHT)

    def expand(frontier, excluded):
        scores = torch.where(usable & frontier[:, None], graph.weight,
                             torch.full_like(graph.weight, -1.0))
        top_w, top_idx = torch.sort(scores, dim=1, descending=True,
                                    stable=True)
        hit = torch.zeros(frontier.shape[0], dtype=torch.int32,
                          device=frontier.device)
        hit.index_add_(0, top_idx[:, :k].reshape(-1),
                       (top_w[:, :k] > 0).reshape(-1).to(torch.int32))
        return (hit > 0) & ~excluded

    ring1 = expand(seed_mask, seed_mask)
    ring2 = expand(ring1, seed_mask | ring1)
    return seed_mask, ring1, ring2


def remove_landmarks(graph: GraphState, remove_mask) -> GraphState:
    """Drop all edges incident to removed slots (slot recycling)."""
    keep = ~remove_mask
    pair = keep[:, None] & keep[None, :]
    return graph._replace(exists=graph.exists & pair, bad=graph.bad & pair)
