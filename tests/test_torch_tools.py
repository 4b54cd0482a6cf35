"""Port parity of the tools around the system: the stage profiler, the
checkpoint (its own layout and the JAX package's npz layout) and the viz
dumps, each against the JAX package on one state.

Tolerances: checkpoints restore every field exactly; every dump image
equal pixel for pixel; PLY files equal in structure and colours, vertices
within 1e-5 (keyframe centres go through each package's float32 SE(3)
inverse).
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrslam_tpu.slam import graph as jgraph
from nrslam_tpu.slam import state as jstate
from nrslam_tpu.slam.state import Config
from nrslam_tpu_torch import convert
from nrslam_tpu_torch.datasets import png
from nrslam_tpu_torch.slam import state as tstate
from nrslam_tpu_torch.utils import checkpoint
from nrslam_tpu_torch.utils.profiler import TimeProfiler
from nrslam_tpu_torch.viz import dumps as tdumps

from torch_parity import to_port

torch.set_num_threads(1)


def test_time_profiler(tmp_path):
    p = TimeProfiler()
    for _ in range(3):
        with p.section("frame"):
            sum(range(1000))
    p.tic("init")
    assert p.toc("init") >= 0.0
    st = p.statistics()
    assert st["frame"]["count"] == 3 and st["init"]["count"] == 1
    assert st["frame"]["median_ms"] >= 0.0 and st["frame"]["sigma_ms"] >= 0.0
    p.save_statistics_to_file(str(tmp_path / "stats.txt"))
    lines = (tmp_path / "stats.txt").read_text().splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["frame", "init"]


def test_device_timers_refuse_the_cpu():
    """The device timers time the card and raise without one."""
    from nrslam_tpu_torch.utils import profiler

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        profiler.chained_timeit(lambda x: x, lambda e: e)
    with pytest.raises(RuntimeError, match="CUDA"):
        profiler.device_timeit(lambda c: c, torch.zeros(()))


def test_device_trace_writes_a_chrome_trace(tmp_path):
    """device_trace records the block's torch ops and writes them as a
    Chrome trace (CPU activity only where there is no card)."""
    import json

    from nrslam_tpu_torch.utils import profiler

    with profiler.device_trace(str(tmp_path / "trace")):
        torch.matmul(torch.ones(16, 16), torch.ones(16, 16))
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any(e.get("name") == "aten::matmul"
               for e in events["traceEvents"])


CONFIG = Config(max_points=28, max_keyframes=3, temporal_window=4,
                klt_levels=2, klt_win=5)


@pytest.fixture(scope="module")
def jax_state():
    """A JAX SlamState with 24 landmarks (4 slots free), a deformation
    graph, two keyframes and three temporal snapshots of drifting
    keypoints (numpy seed 0)."""
    rng = np.random.RandomState(0)
    P = CONFIG.max_points
    config = CONFIG
    used = np.arange(P) < 24
    status = np.where(used, rng.choice([0, 0, 1, 2], P), 6).astype(np.int32)
    positions = rng.randn(P, 3).astype(np.float32) + [0, 0, 3]
    state = jstate.empty_state(config, (40, 56))._replace(
        slot_used=jnp.asarray(used), has_3d=jnp.asarray(used & (status != 1)),
        track_id=jnp.asarray(np.where(used, np.arange(P), -1), jnp.int32),
        positions=jnp.asarray(positions),
        keypoints=jnp.asarray(rng.uniform(3, 50, (P, 2)), jnp.float32),
        status=jnp.asarray(status), scale=jnp.float32(1.7))
    state = state._replace(graph=jgraph.initialize(
        state.graph, state.positions, state.slot_used, 2.0))
    state = jstate.insert_keyframe(state)
    for k in range(3):
        state = jstate.insert_temporal_snapshot(state)
        state = state._replace(keypoints=state.keypoints + 1.5,
                               positions=state.positions + 0.05,
                               Tcw=state.Tcw._replace(
                                   t=state.Tcw.t + jnp.float32(0.1 * k)))
    return jstate.insert_keyframe(state)


def _assert_states_equal(a, b):
    fa, fb = convert.to_numpy(a), convert.to_numpy(b)
    for name, x, y in _pairs(fa, fb):
        assert x.dtype == y.dtype and np.array_equal(x, y), name


def _pairs(a, b, name="state"):
    if hasattr(a, "_fields"):
        for f in a._fields:
            yield from _pairs(getattr(a, f), getattr(b, f), f"{name}.{f}")
    elif isinstance(a, (list, tuple)):
        for k, (x, y) in enumerate(zip(a, b)):
            yield from _pairs(x, y, f"{name}[{k}]")
    else:
        yield name, a, b


def test_checkpoint_roundtrip(jax_state, tmp_path):
    """save / restore gives every tensor back bit for bit, on the example's
    device; a state of another shape is refused."""
    state = to_port(jax_state)
    checkpoint.save(str(tmp_path / "ck"), state, step=3)
    blank = tstate.empty_state(to_port(CONFIG), (40, 56), "cpu")
    back = checkpoint.restore(str(tmp_path / "ck"), blank, step=3)
    _assert_states_equal(back, state)
    other = tstate.empty_state(tstate.Config(max_points=16), (40, 56), "cpu")
    with pytest.raises(ValueError):
        checkpoint.restore(str(tmp_path / "ck"), other, step=3)


def test_checkpoint_resumes_a_jax_npz_checkpoint(jax_state, tmp_path,
                                                 monkeypatch):
    """A state the JAX package saved in its npz layout (orbax made
    unavailable) restores in the port equal to convert.from_numpy of the
    same state."""
    from nrslam_tpu.utils import checkpoint as jcheckpoint

    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    jcheckpoint.save(str(tmp_path / "jck"), jax_state)
    assert (tmp_path / "jck" / "step_0.npz").exists()
    example = tstate.empty_state(to_port(CONFIG), (40, 56), "cpu")
    back = checkpoint.restore(str(tmp_path / "jck"), example)
    _assert_states_equal(back, to_port(jax_state))


def test_checkpoint_resumes_a_jax_orbax_checkpoint(jax_state, tmp_path):
    """A state the JAX package saved with its default ``save`` (through
    orbax, which this machine has) restores in the port equal to
    convert.from_numpy of the same state, field by field."""
    pytest.importorskip("orbax.checkpoint")
    from nrslam_tpu.utils import checkpoint as jcheckpoint

    jcheckpoint.save(str(tmp_path / "jck"), jax_state, step=2)
    assert (tmp_path / "jck" / "step_2").is_dir()
    assert not (tmp_path / "jck" / "step_2.npz").exists()
    example = tstate.empty_state(to_port(CONFIG), (40, 56), "cpu")
    back = checkpoint.restore(str(tmp_path / "jck"), example, step=2)
    _assert_states_equal(back, to_port(jax_state))
    other = tstate.empty_state(tstate.Config(max_points=16), (40, 56), "cpu")
    with pytest.raises(ValueError):
        checkpoint.restore(str(tmp_path / "jck"), other, step=2)


def test_checkpoint_orbax_directory_without_orbax(tmp_path, monkeypatch):
    """Without orbax, an orbax directory is refused by name."""
    (tmp_path / "ck" / "step_0").mkdir(parents=True)
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    example = tstate.empty_state(to_port(CONFIG), (40, 56), "cpu")
    with pytest.raises(RuntimeError, match="step_0.*orbax"):
        checkpoint.restore(str(tmp_path / "ck"), example)


def test_viz_dumps_match_jax(jax_state, tmp_path):
    """Every overlay equal pixel for pixel to the JAX dump of the same
    state; save_png writes what Pillow reads back."""
    from nrslam_tpu.viz import dumps as jdumps

    Image = pytest.importorskip("PIL.Image")
    js, ts = jax_state, to_port(jax_state)
    gray = (np.random.RandomState(1).rand(40, 56) * 255).astype(np.float32)
    pairs = {
        "frame": (jdumps.draw_frame(gray, js.keypoints, js.status,
                                    js.slot_used),
                  tdumps.draw_frame(gray, ts.keypoints, ts.status,
                                    ts.slot_used)),
        "graph": (jdumps.draw_graph(gray, js.keypoints, js.status,
                                    js.slot_used, js.graph, max_edges=40),
                  tdumps.draw_graph(torch.from_numpy(gray), ts.keypoints,
                                    ts.status, ts.slot_used, ts.graph,
                                    max_edges=40)),
        "flow": (jdumps.draw_optical_flow(gray, js),
                 tdumps.draw_optical_flow(gray, ts)),
    }
    # Feature flow between the first and last snapshots, two motions.
    ref = js.tb_keypoints[0]
    cur = ref + jnp.where((jnp.arange(28) < 14)[:, None],
                          jnp.array([3.0, 0.0]), jnp.array([-3.0, 2.0]))
    valid = np.ones(28, bool)
    valid[-3:] = False
    lj = jdumps.cluster_flow_tracks(ref, cur, jnp.asarray(valid))
    lt = tdumps.cluster_flow_tracks(to_port(ref), to_port(cur),
                                    torch.from_numpy(valid))
    np.testing.assert_array_equal(lt, lj)
    assert len(set(lt[valid].tolist())) >= 2 and (lt[~valid] == -1).all()
    pairs["clustered"] = (
        jdumps.draw_clustered_flow(gray, ref, cur, valid, lj),
        tdumps.draw_clustered_flow(gray, to_port(ref), to_port(cur), valid))
    inl = np.arange(28) % 2 == 0
    pairs["inliers"] = (
        jdumps.draw_essential_inliers(gray, cur, inl, valid),
        tdumps.draw_essential_inliers(gray, to_port(cur), inl, valid))
    for name, (a, b) in pairs.items():
        assert b.dtype == np.uint8 and b.shape == (40, 56, 3), name
        assert b.max() > 0 and np.array_equal(b, a), name
        tdumps.save_png(tmp_path / f"{name}.png", b)
        assert np.array_equal(np.asarray(Image.open(tmp_path / f"{name}.png")),
                              b), name
        assert np.array_equal(png.read(tmp_path / f"{name}.png"), b), name


def _read_ply(path):
    head, _, body = path.read_text().partition("end_header\n")
    return head, [ln.split() for ln in body.splitlines()]


def test_ply_exports_match_jax(jax_state, tmp_path):
    from nrslam_tpu.viz import dumps as jdumps

    ts = to_port(jax_state)
    for fn in ("export_ply", "export_flow_trails_ply"):
        getattr(jdumps, fn)(str(tmp_path / "j.ply"), jax_state)
        getattr(tdumps, fn)(str(tmp_path / "t.ply"), ts)
        hj, rj = _read_ply(tmp_path / "j.ply")
        ht, rt = _read_ply(tmp_path / "t.ply")
        assert ht == hj and len(rt) == len(rj) > 20, fn
        for a, b in zip(rj, rt):
            assert len(a) == len(b)
            if len(a) in (3, 6):  # vertex: x y z [r g b]
                np.testing.assert_allclose(np.float32(b[:3]),
                                           np.float32(a[:3]), atol=1e-5)
                assert a[3:] == b[3:]
            else:
                assert a == b
