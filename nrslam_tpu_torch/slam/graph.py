"""Dynamic deformation graph as dense masked [P, P] edge-state matrices
(counterpart of nrslam_tpu/slam/graph.py; same layout, for parity).

Edge state: first/max/min distance, RBF weight of the max distance, ``bad``
when the relative stretch exceeds 1.1; usable edges need weight >=
exp(-1.125) (the 1.5-sigma cutoff).

Every function works on a block of rows, ``rows.block`` (a ``Rows``):
the leaves of ``GraphState`` are ``[R, P]``, those rows of the whole
matrices (the columns stay whole), while positions and masks are whole
``[P]`` arrays; row outputs are ``[R]`` or ``[R, k]``. A single process
holds every row (``ALL``); a rank of a point-sharded frame holds its
``P / n`` (``parallel.sharding.MeshRows``). ``Rows`` is also how the
callers (tracking, mapping) make row results whole.
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
    exists: torch.Tensor          # [R, P] bool (symmetric when R = P)
    bad: torch.Tensor             # [R, P] bool
    first_distance: torch.Tensor  # [R, P]
    max_distance: torch.Tensor    # [R, P]
    min_distance: torch.Tensor    # [R, P]
    weight: torch.Tensor          # [R, P]
    sigma: torch.Tensor           # scalar


class Rows:
    """The block of the graph's rows this process holds (``block``, a slice
    of the slots), and how its row results become whole. A single process
    holds them all: this class with its default block, whose methods are
    the identity (``ALL``). ``parallel.sharding.MeshRows`` holds one
    rank's block and gathers over the ranks."""

    def __init__(self, block: slice = slice(0, None)):
        self.block = block

    def count(self, P: int) -> int:
        """R: the block's number of rows in a graph of P slots."""
        return len(range(P)[self.block])

    def gather(self, *blocks):
        """Every process's ``[m, ...]`` block of each tensor, concatenated
        in process order (row results ``[R, ...]`` become ``[P, ...]``)."""
        return blocks

    def gather_columns(self, *blocks):
        """Every process's columns ``[W, m, ...]`` of each tensor (the
        keyframe ring's columns of ``block``), concatenated in process order
        along axis 1: ``[W, P, ...]``."""
        return blocks

    def reduce_max(self, x):
        """``x``'s elementwise maximum over the processes."""
        return x

    def share(self, x):
        """This process's contiguous share of ``x``'s leading axis; the
        ``gather`` of the shares starts with ``x`` (the last share is padded
        with copies of ``x``'s last item when the processes do not divide
        it)."""
        return x


ALL = Rows()


def empty(capacity: int, sigma: float = 10.5, device=None,
          rows: Rows = ALL) -> GraphState:
    """The edge state of ``rows`` (all ``capacity`` by default), on the
    card unless ``device`` says otherwise (``utils.device``)."""
    device = resolve(device)
    R = rows.count(capacity)
    z = torch.zeros((R, capacity), dtype=torch.float32, device=device)
    f = torch.zeros((R, capacity), dtype=torch.bool, device=device)
    return GraphState(exists=f, bad=f.clone(), first_distance=z,
                      max_distance=z.clone(), min_distance=z.clone(),
                      weight=z.clone(),
                      sigma=torch.tensor(sigma, dtype=torch.float32,
                                         device=device))


def _pair_distances(positions, rows: Rows):
    """[R, P]: distances from the block's rows to every position."""
    d = positions[rows.block, None, :] - positions[None, :, :]
    return torch.sqrt(torch.clamp(torch.sum(d * d, dim=-1), min=1e-20))


def off_diagonal(rows: Rows, P: int, device):
    """[R, P] bool: False where the block's global row index equals the
    column."""
    idx = torch.arange(P, device=device)
    return idx[rows.block, None] != idx[None, :]


def initialize(graph: GraphState, positions, valid, sigma,
               rows: Rows = ALL) -> GraphState:
    """All-pairs graph over the valid slots (map.cc:139-167), on
    ``rows``."""
    dist = _pair_distances(positions, rows)
    pair = valid[rows.block, None] & valid[None, :] \
        & off_diagonal(rows, valid.shape[0], positions.device)
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


def add_edges(graph: GraphState, positions, new_mask, existing_mask,
              rows: Rows = ALL) -> GraphState:
    """Star edges from every new landmark to every existing one."""
    dist = _pair_distances(positions, rows)
    new_r = new_mask[rows.block]
    pair_new = ((new_r[:, None] & existing_mask[None, :])
                | (existing_mask[rows.block, None] & new_mask[None, :])
                | (new_r[:, None] & new_mask[None, :]))
    pair_new = pair_new & off_diagonal(rows, new_mask.shape[0],
                                       positions.device) & ~graph.exists
    w = rbf_weight(dist, graph.sigma)
    return graph._replace(
        exists=graph.exists | pair_new,
        bad=graph.bad & ~pair_new,
        first_distance=torch.where(pair_new, dist, graph.first_distance),
        max_distance=torch.where(pair_new, dist, graph.max_distance),
        min_distance=torch.where(pair_new, dist, graph.min_distance),
        weight=torch.where(pair_new, w, graph.weight),
    )


def update_vertices(graph: GraphState, positions, update_mask,
                    rows: Rows = ALL):
    """Refresh distance extremes / weights / stretch pruning of every edge
    touching ``update_mask``. Returns (graph, good_connections [R])."""
    dist = _pair_distances(positions, rows)
    touched = ((update_mask[rows.block, None] | update_mask[None, :])
               & graph.exists)
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
    first; the columns are whole, so the indices are global). Returns
    (idx [R, k] int64, weight, first_distance, valid)."""
    usable = graph.exists & ~graph.bad & (graph.weight >= MIN_WEIGHT) \
        & eligible[None, :]
    scores = torch.where(usable, graph.weight,
                         torch.full_like(graph.weight, -1.0))
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    top_w, top_idx = vals[:, :k], idx[:, :k]
    valid = top_w > 0.0
    d0 = torch.gather(graph.first_distance, 1, top_idx)
    return top_idx, torch.clamp(top_w, min=0.0), d0, valid


def neighborhood_rings(graph: GraphState, seed_mask, k: int,
                       rows: Rows = ALL):
    """0th/1st/2nd-order neighbourhood rings of a seed landmark set
    (GetOptimizationNeighbours, regularization_graph.cc:159-232): ring1 =
    the top-k usable neighbours of the seeds outside the seeds, ring2 = the
    top-k usable neighbours of ring1 outside rings 0 and 1. Each process
    expands the frontier rows it holds; the [P] hit counts cross rows, so
    ``rows.reduce_max`` combines them. Returns (ring0, ring1, ring2), bool
    [P] each."""
    usable = graph.exists & ~graph.bad & (graph.weight >= MIN_WEIGHT)

    def expand(frontier, excluded):
        mine = frontier[rows.block]
        scores = torch.where(usable & mine[:, None], graph.weight,
                             torch.full_like(graph.weight, -1.0))
        top_w, top_idx = torch.sort(scores, dim=1, descending=True,
                                    stable=True)
        hit = torch.zeros(frontier.shape[0], dtype=torch.int32,
                          device=frontier.device)
        hit.index_add_(0, top_idx[:, :k].reshape(-1),
                       (top_w[:, :k] > 0).reshape(-1).to(torch.int32))
        return (rows.reduce_max(hit) > 0) & ~excluded

    ring1 = expand(seed_mask, seed_mask)
    ring2 = expand(ring1, seed_mask | ring1)
    return seed_mask, ring1, ring2


def remove_landmarks(graph: GraphState, remove_mask,
                     rows: Rows = ALL) -> GraphState:
    """Drop all edges incident to removed slots (slot recycling)."""
    keep = ~remove_mask
    pair = keep[rows.block, None] & keep[None, :]
    return graph._replace(exists=graph.exists & pair, bad=graph.bad & pair)
