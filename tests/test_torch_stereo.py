"""Port parity of the stereo half: ``image.gather_windows``, the two stereo
matchers, DBSCAN and ``bootstrap_map_stereo``, each against the JAX package
on the same inputs (numpy seeds, or frames the JAX renderer made).
``System.track_image_with_stereo`` is held against the JAX System in
tests/test_torch_system_entry.py, which already pays for the JAX System's
traces.

Tolerances: gather_windows 1e-5 absolute; the matchers' ``ok`` equal on
>= 98% of slots and the depths of the slots both accept within 1e-4
relative (a flip of the NCC argmax between two near-equal disparities
moves one slot's depth by a whole pixel of disparity, which the
ok-agreement bound absorbs); DBSCAN labels equal; the stereo bootstrap
equal slot for slot (floats within 1e-6 of each field's largest
magnitude).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrslam_tpu.ops import dbscan as jdbscan
from nrslam_tpu.ops import image as jimage
from nrslam_tpu.ops import klt as jklt
from nrslam_tpu.ops import stereo as jstereo
from nrslam_tpu.slam import state as jstate
from nrslam_tpu.slam import system as jsys
from nrslam_tpu_torch.ops import dbscan as tdbscan
from nrslam_tpu_torch.ops import image as timage
from nrslam_tpu_torch.ops import klt as tklt
from nrslam_tpu_torch.ops import stereo as tstereo
from nrslam_tpu_torch.slam import state as tstate
from nrslam_tpu_torch.slam import system as tsys

from torch_parity import (STEREO_BASELINE, entry_setting, np_of, stereo_pair,
                          to_port)

torch.set_num_threads(1)

@pytest.fixture(scope="module")
def pair():
    """The 120x160 entry scene's stereo pair at frame 3, 96 keypoints
    (numpy seed 0) and a validity mask with 8 slots off."""
    scene, cam, _, _ = entry_setting()
    left, right = stereo_pair(scene, 3)
    rng = np.random.RandomState(0)
    kps = np.stack([rng.uniform(20, scene.width - 20, 96),
                    rng.uniform(20, scene.height - 20, 96)],
                   -1).astype(np.float32)
    valid = np.ones(96, bool)
    valid[::12] = False
    return scene, cam, left, right, kps, valid


def test_gather_windows_matches_jax():
    rng = np.random.RandomState(1)
    img = (rng.rand(40, 50) * 255).astype(np.float32)
    centers = np.stack([rng.uniform(-3, 53, 30), rng.uniform(-3, 43, 30)],
                       -1).astype(np.float32)
    for win in (5, 11):
        j = jimage.gather_windows(jnp.asarray(img), jnp.asarray(centers), win)
        t = timage.gather_windows(torch.from_numpy(img),
                                  torch.from_numpy(centers), win)
        assert t.shape == (30, win, win)
        np.testing.assert_allclose(np_of(t), np_of(j), atol=1e-5)
    # [D, P, 2] centers, as the NCC search batches them.
    batched = timage.gather_windows(torch.from_numpy(img),
                                    torch.from_numpy(centers).reshape(3, 10, 2),
                                    11)
    j = jimage.gather_windows(jnp.asarray(img), jnp.asarray(centers), 11)
    np.testing.assert_allclose(np_of(batched).reshape(30, 11, 11), np_of(j),
                               atol=1e-5)


def _agree(j_out, t_out, tag):
    (Xj, okj), (Xt, okt) = j_out, t_out
    okj, okt = np_of(okj), np_of(okt)
    assert (okj == okt).mean() >= 0.98, (tag, (okj == okt).mean())
    both = okj & okt
    assert both.sum() >= 0.5 * okj.sum() > 0, tag
    zj, zt = np_of(Xj)[both, 2], np_of(Xt)[both, 2]
    rel = np.abs(zj - zt) / np.abs(zj)
    assert rel.max() <= 1e-4, (tag, rel.max())


def test_stereo_pattern_matching_matches_jax(pair):
    scene, cam, left, right, kps, valid = pair
    bf = scene.fx * STEREO_BASELINE
    j = jax.jit(jstereo.stereo_pattern_matching, static_argnums=1)(
        cam, bf, left, right, jnp.asarray(kps), jnp.asarray(valid))
    t = tstereo.stereo_pattern_matching(to_port(cam), bf, to_port(left),
                                        to_port(right), torch.from_numpy(kps),
                                        torch.from_numpy(valid))
    _agree(j, t, "ncc")


def test_stereo_lucas_kanade_matches_jax(pair):
    scene, cam, left, right, kps, valid = pair
    bf = scene.fx * STEREO_BASELINE
    cfg = jklt.KLTConfig(win=15, max_level=2)
    j = jax.jit(jstereo.stereo_lucas_kanade, static_argnums=(1, 6))(
        cam, bf, left, right, jnp.asarray(kps), jnp.asarray(valid), cfg)
    t = tstereo.stereo_lucas_kanade(to_port(cam), bf, to_port(left),
                                    to_port(right), torch.from_numpy(kps),
                                    torch.from_numpy(valid),
                                    tklt.KLTConfig(**cfg._asdict()))
    _agree(j, t, "klt")


def _clusters(rng, dim, sizes, spread, gap, noise):
    """Gaussian clusters centred at gap x (k, k, ...), then isolated noise
    points."""
    pts = [rng.randn(n, dim) * spread + gap * k for k, n in enumerate(sizes)]
    pts.append(np.asarray(noise, np.float64).reshape(-1, dim))
    return np.concatenate(pts).astype(np.float32)


@pytest.mark.parametrize("variant", ["2d", "3d", "nd"])
def test_dbscan_matches_jax(variant):
    """Labels equal to JAX's, noise and invalid slots -1, ids ordered by
    descending cluster size (two clusters of equal size keep the JAX
    tie order)."""
    rng = np.random.RandomState({"2d": 0, "3d": 1, "nd": 2}[variant])
    if variant == "2d":
        X = _clusters(rng, 2, (12, 20, 12), 0.3, 6.0,
                      [[-8, -8], [-8, 8], [20, -8], [20, 8]])
        fj, ft = jdbscan.dbscan_2d, tdbscan.dbscan_2d
    elif variant == "3d":
        X = _clusters(rng, 3, (10, 25, 10, 6), 0.4, 20.0,
                      rng.uniform(-50, 50, (4, 3)) + 200.0)
        fj, ft = jdbscan.dbscan_3d, tdbscan.dbscan_3d
    else:
        X = _clusters(rng, 4, (15, 30, 15), 0.05, 3.0,
                      rng.uniform(-5, 5, (4, 4)) + 20.0)
        fj, ft = jdbscan.dbscan_nd, tdbscan.dbscan_nd
    valid = np.ones(X.shape[0], bool)
    valid[rng.choice(X.shape[0], 5, replace=False)] = False
    for v in (None, valid):
        lj = np_of(jax.jit(fj)(jnp.asarray(X),
                               None if v is None else jnp.asarray(v)))
        lt = np_of(ft(torch.from_numpy(X),
                      None if v is None else torch.from_numpy(v)))
        np.testing.assert_array_equal(lt, lj)
        assert lt.max() >= 1 and (lt == -1).any()
        sizes = np.bincount(lt[lt >= 0])
        assert (np.diff(sizes) <= 0).all()
        if v is not None:
            assert (lt[~v] == -1).all()


def test_bootstrap_map_stereo_matches_jax():
    """The mirror of tests/test_system_extras.py::test_stereo_bootstrap,
    the port against JAX slot for slot, with 64 of 80 candidates valid (so
    the stable top-k decides which slots are taken)."""
    from nrslam_tpu.datasets import synthetic
    from nrslam_tpu.geometry import cameras
    from nrslam_tpu.slam.state import Config

    scene = synthetic.SceneConfig(height=96, width=128, fx=100.0, fy=100.0)
    cam = synthetic.camera(scene)
    config = Config(max_points=64, max_keyframes=3, temporal_window=4,
                    klt_levels=3, klt_win=11)
    gray, depth, _ = synthetic.render_frame(0, scene)
    pyr = jklt.build_pyramid(gray, config.klt_config)
    rng = np.random.RandomState(0)
    n = 80
    kps = np.stack([15 + 98 * rng.rand(n), 15 + 66 * rng.rand(n)],
                   -1).astype(np.float32)
    depths = jimage.bilinear_sample(depth, jnp.asarray(kps))
    landmarks = cameras.unproject(cam, jnp.asarray(kps)) * depths[:, None]
    ok = np.ones(n, bool)
    ok[rng.choice(n, 16, replace=False)] = False
    ids = np.arange(100, 100 + n, dtype=np.int32)

    js = jax.jit(jsys.bootstrap_map_stereo, static_argnums=6)(
        jstate.empty_state(config, gray.shape), jnp.asarray(kps), landmarks,
        jnp.asarray(ok), jnp.asarray(ids), pyr, config)
    ts = tsys.bootstrap_map_stereo(
        tstate.empty_state(to_port(config), tuple(gray.shape), "cpu"),
        torch.from_numpy(kps), to_port(landmarks), torch.from_numpy(ok),
        torch.from_numpy(ids), to_port(pyr), to_port(config))
    assert int(np_of(ts.slot_used).sum()) == 64
    assert int(np_of(ts.kf_valid).sum()) == 1 and float(ts.scale) == 1.0
    _assert_same_tree(jax.device_get(js), ts, "state")


def _assert_same_tree(j, t, name):
    """JAX and port trees equal field by field (by name): floats within
    1e-6, everything else exactly."""
    if hasattr(t, "_fields"):
        for f in t._fields:
            _assert_same_tree(getattr(j, f), getattr(t, f), f"{name}.{f}")
        return
    if isinstance(t, (list, tuple)):
        for k, (a, b) in enumerate(zip(j, t)):
            _assert_same_tree(a, b, f"{name}[{k}]")
        return
    a, b = np.asarray(j), np_of(t)
    assert a.shape == b.shape, name
    if a.dtype == np.float32:
        scale = max(1.0, float(np.abs(a).max(initial=0.0)))
        np.testing.assert_allclose(b, a, atol=1e-6 * scale, rtol=0,
                                   err_msg=name)
    else:
        np.testing.assert_array_equal(b, a, err_msg=name)
