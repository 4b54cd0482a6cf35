"""The row-block graph and mapping functions of the port against the rows
of the JAX package's whole functions, on the CPU.

For n in {1, 2, 4} blocks of rows and every block b (rows ``[b P / n,
(b + 1) P / n)``), each of ``graph.initialize``, ``add_edges``,
``update_vertices``, ``top_k_neighbors``, ``remove_landmarks`` and
``mapping._closest_mapped_neighbors`` run on the block (``[P / n, P]``
graph leaves, whole ``[P]`` positions and masks) must give the block's rows
of the JAX function on the same whole inputs, made with numpy from a seed.
``neighborhood_rings`` and ``landmark_triangulation``, whose row results
cross blocks, run on the n blocks at once in n threads whose collectives
meet at a barrier (``_Lockstep``, the in-process stand-in for
``parallel.sharding.MeshRows``) and must give the JAX package's whole
result on every block.

Tolerances: bool and index outputs exact; float32 outputs 1e-6 (one
elementwise formula on both sides); the triangulation as in
tests/test_torch_mapping.py (positions 1e-4 relative, decisions equal).
"""

import threading
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrslam_tpu.slam import graph as jgraph
from nrslam_tpu.slam import mapping as jmap
from nrslam_tpu_torch.slam import graph as tgraph
from nrslam_tpu_torch.slam import mapping as tmap

from test_torch_mapping import _mapping_state
from torch_parity import np_of, to_port

torch.set_num_threads(1)

P = 48
BLOCKS = [(n, b) for n in (1, 2, 4) for b in range(n)]
F32_TOL = 1e-6


def _eq(got, want, tol=0.0):
    got, want = np_of(got), np_of(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if tol == 0.0:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.max(np.abs(got.astype(np.float64) - want)) <= tol


def _graphs_eq(got, want_rows):
    for f in ("exists", "bad"):
        _eq(getattr(got, f), getattr(want_rows, f))
    for f in ("first_distance", "max_distance", "min_distance", "weight"):
        _eq(getattr(got, f), getattr(want_rows, f), F32_TOL)


def _of(n, b, Pn=P):
    """Block b of n of the rows of a Pn-slot graph."""
    return tgraph.Rows(slice(b * Pn // n, (b + 1) * Pn // n))


def _rows(graph, rows):
    """The rows ``rows.block`` of a whole JAX graph (numpy leaves)."""
    return graph._replace(**{f: np_of(getattr(graph, f))[rows.block]
                             for f in graph._fields if f != "sigma"})


def _block(graph, rows):
    """The port graph of the rows ``rows.block`` of a whole JAX graph."""
    return to_port(_rows(graph, rows))


def _inputs(seed=0):
    """Whole positions and masks and the JAX graph after init, new edges
    and an update (the sequence of tests/test_torch_mapping.py)."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(0, 1.0, (P, 3)).astype(np.float32)
    valid = rng.uniform(size=P) < 0.8
    new = ~valid & (rng.uniform(size=P) < 0.7)
    pos2 = pos + rng.normal(0, 0.3, (P, 3)).astype(np.float32)
    upd = rng.uniform(size=P) < 0.5
    elig = rng.uniform(size=P) < 0.9
    rem = rng.uniform(size=P) < 0.2
    g1 = jgraph.initialize(jgraph.empty(P), jnp.asarray(pos),
                           jnp.asarray(valid), 3.0)
    g2 = jgraph.add_edges(g1, jnp.asarray(pos2), jnp.asarray(new),
                          jnp.asarray(valid))
    g3, good = jgraph.update_vertices(g2, jnp.asarray(pos2 * 1.3),
                                      jnp.asarray(upd))
    return dict(pos=pos, valid=valid, new=new, pos2=pos2, upd=upd,
                elig=elig, rem=rem, g1=g1, g2=g2, g3=g3, good=good)


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("n,b", BLOCKS)
def test_initialize_rows(inputs, n, b):
    rows = _of(n, b)
    got = tgraph.initialize(tgraph.empty(P, device="cpu", rows=rows),
                            _t(inputs["pos"]), _t(inputs["valid"]), 3.0,
                            rows)
    _graphs_eq(got, _rows(inputs["g1"], rows))
    assert float(got.sigma) == 3.0


@pytest.mark.parametrize("n,b", BLOCKS)
def test_add_edges_rows(inputs, n, b):
    rows = _of(n, b)
    got = tgraph.add_edges(_block(inputs["g1"], rows),
                           _t(inputs["pos2"]), _t(inputs["new"]),
                           _t(inputs["valid"]), rows)
    _graphs_eq(got, _rows(inputs["g2"], rows))


@pytest.mark.parametrize("n,b", BLOCKS)
def test_update_vertices_rows(inputs, n, b):
    rows = _of(n, b)
    got, good = tgraph.update_vertices(_block(inputs["g2"], rows),
                                       _t(inputs["pos2"] * 1.3),
                                       _t(inputs["upd"]), rows)
    _graphs_eq(got, _rows(inputs["g3"], rows))
    _eq(good, np_of(inputs["good"])[rows.block])


@pytest.mark.parametrize("n,b", BLOCKS)
def test_top_k_neighbors_rows(inputs, n, b):
    rows = _of(n, b)
    want = jgraph.top_k_neighbors(inputs["g3"], jnp.asarray(inputs["elig"]),
                                  11)
    got = tgraph.top_k_neighbors(_block(inputs["g3"], rows),
                                 _t(inputs["elig"]), 11)
    for g, w, tol in zip(got, want, (0.0, F32_TOL, F32_TOL, 0.0)):
        _eq(g, np_of(w)[rows.block], tol)


@pytest.mark.parametrize("n,b", BLOCKS)
def test_remove_landmarks_rows(inputs, n, b):
    rows = _of(n, b)
    want = jgraph.remove_landmarks(inputs["g3"], jnp.asarray(inputs["rem"]))
    got = tgraph.remove_landmarks(_block(inputs["g3"], rows),
                                  _t(inputs["rem"]), rows)
    _graphs_eq(got, _rows(want, rows))


@pytest.fixture(scope="module")
def mapping_state():
    return _mapping_state(0.01)


@pytest.mark.parametrize("n,b", BLOCKS)
def test_closest_mapped_neighbors_rows(mapping_state, n, b):
    sj, _, cfg = mapping_state
    Pm = cfg.max_points
    rows = _of(n, b, Pm)
    want = jmap._closest_mapped_neighbors(sj, cfg)
    ts = to_port(sj)
    ts = ts._replace(graph=tgraph.empty(Pm, device="cpu", rows=rows))
    got = tmap._closest_mapped_neighbors(ts, to_port(cfg), rows)
    for g, w in zip(got, want):
        _eq(g, np_of(w)[rows.block])
    assert np_of(want[2]).any() and not np_of(want[2]).all()


class _Lockstep(tgraph.Rows):
    """Block b of n, run in a thread beside the other blocks: each
    collective publishes the block's tensors, waits for every block's and
    combines them as ``parallel.sharding.MeshRows`` does across ranks."""

    def __init__(self, b, n, Pn, slots, barrier):
        super().__init__(_of(n, b, Pn).block)
        self.b, self.n = b, n
        self.slots, self.barrier = slots, barrier

    def _exchange(self, x):
        self.slots[self.b] = x
        self.barrier.wait()
        got = list(self.slots)
        self.barrier.wait()
        return got

    def gather(self, *blocks):
        parts = self._exchange(blocks)
        return tuple(torch.cat([p[k] for p in parts])
                     for k in range(len(blocks)))

    def reduce_max(self, x):
        return torch.stack(self._exchange(x)).amax(0)

    def share(self, x):
        size = -(-x.shape[0] // self.n)
        idx = torch.arange(self.b * size, (self.b + 1) * size)
        return x[torch.clamp(idx, max=x.shape[0] - 1)]


def _lockstep(n, Pn, fn):
    """``fn(b, rows)`` for the n blocks at once, one thread each; the
    results in block order."""
    slots, barrier = [None] * n, threading.Barrier(n, timeout=120)
    out, errors = [None] * n, []

    def run(b):
        try:
            out[b] = fn(b, _Lockstep(b, n, Pn, slots, barrier))
        except BaseException as e:  # re-raised below, in the test's thread
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=run, args=(b,)) for b in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    return out


@pytest.mark.parametrize("n", [1, 2, 4])
def test_neighborhood_rings_rows(n):
    """The rings of seeds on a 48-point cloud at k = 3: every block's
    rings equal the JAX package's whole rings (hits MAX-reduced across the
    blocks)."""
    rng = np.random.default_rng(1)
    pos = rng.normal(0, 1.0, (P, 3)).astype(np.float32)
    seeds = rng.uniform(size=P) < 0.1
    jg = jgraph.initialize(jgraph.empty(P), jnp.asarray(pos),
                           jnp.ones(P, bool), 0.6)
    want = [np_of(r) for r in jgraph.neighborhood_rings(
        jg, jnp.asarray(seeds), k=3)]
    assert want[1].any() and want[2].any()

    def fn(b, rows):
        return tgraph.neighborhood_rings(_block(jg, rows), _t(seeds), 3,
                                         rows)

    for rings in _lockstep(n, P, fn):
        for g, w in zip(rings, want):
            _eq(g, w)


@pytest.mark.parametrize("n", [2, 4])
def test_landmark_triangulation_rows(n):
    """The deforming triangulation case of tests/test_torch_mapping.py on n
    row blocks at once (the neighbour search and the rigid path on the
    block's slots, the deformable path on its share of the candidates, the
    new edges on its rows): every block's result equals the JAX package's
    whole one, and its graph rows are the JAX graph's rows."""
    sj, cj, cfg = _mapping_state(0.01)
    Pm = cfg.max_points
    want = jax.jit(partial(jmap.landmark_triangulation, config=cfg))(sj, cj)
    ts, tcam, tcfg = to_port(sj), to_port(cj), to_port(cfg)

    def fn(b, rows):
        mine = ts._replace(graph=_block(sj.graph, rows))
        return tmap.landmark_triangulation(mine, tcam, tcfg, rows)

    inserted = np_of(want.has_3d) & ~np_of(sj.has_3d)
    assert inserted.sum() >= 5
    for b, got in enumerate(_lockstep(n, Pm, fn)):
        block = _of(n, b, Pm).block
        _eq(got.status, want.status)
        _eq(got.has_3d, want.has_3d)
        err = np.abs(np_of(got.positions) - np_of(want.positions)) \
            / np.maximum(1.0, np.abs(np_of(want.positions)))
        assert err.max() < 1e-4, err.max()
        _eq(got.graph.exists, np_of(want.graph.exists)[block])
        _eq(got.graph.first_distance,
            np_of(want.graph.first_distance)[block], 1e-4)
