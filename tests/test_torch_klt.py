"""Port parity: image pyramid, KLT reference/tracking, Shi-Tomasi and dilation
against the JAX package on the CPU.

Tolerances: pyramids and reference windows 1e-4 relative (same float32
stencils; sums over 21x21 windows are reduced in another order); tracked
points within 1e-3 px and statuses identical on >= 99% of slots (a point at
a gate boundary may flip on a last-bit difference); detection and dilation
exactly equal (integer/boolean outputs of identical comparisons).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrslam_tpu.datasets import synthetic as jsyn
from nrslam_tpu.ops import image as jimg
from nrslam_tpu.ops import klt as jklt
from nrslam_tpu.ops import shi_tomasi as jst
from nrslam_tpu_torch.ops import image as timg
from nrslam_tpu_torch.ops import klt as tklt
from nrslam_tpu_torch.ops import shi_tomasi as tst

torch.set_num_threads(1)

H, W = 120, 160
CFG_J = jklt.KLTConfig()
CFG_T = tklt.KLTConfig()


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return np.max(np.abs(a - b)) / max(1.0, np.max(np.abs(b)))


def _frames():
    scene = jsyn.SceneConfig(height=H, width=W, deform_amp=0.02)
    return [np.array(jsyn.render_frame(i, scene)[0]) for i in (0, 1)]


def _points(n=96, seed=0):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-5, W + 5, n), rng.uniform(-5, H + 5, n)],
                   -1).astype(np.float32)
    status = rng.choice([0, 1, 2, 3, 6], n, p=[0.5, 0.3, 0.1, 0.05, 0.05])
    mask = np.ones((H, W), bool)
    mask[:30, :40] = False
    return pts, status.astype(np.int32), mask


def _refs(img, pts, valid, mask=None, levels=5):
    cfg_j = CFG_J._replace(max_level=levels - 1)
    cfg_t = CFG_T._replace(max_level=levels - 1)
    pj = jklt.build_pyramid(jnp.asarray(img), cfg_j)
    pt = tklt.build_pyramid(torch.as_tensor(img), cfg_t)
    rj = jklt.set_reference(pj, jnp.asarray(pts), jnp.asarray(valid), cfg_j,
                            mask=None if mask is None else jnp.asarray(mask))
    rt = tklt.set_reference(pt, torch.as_tensor(pts), torch.as_tensor(valid),
                            cfg_t,
                            mask=None if mask is None else torch.as_tensor(mask))
    return pj, pt, rj, rt


def test_build_pyramid():
    img = _frames()[0]
    pj = jimg.build_pyramid(jnp.asarray(img), 5)
    pt = timg.build_pyramid(torch.as_tensor(img), 5)
    for (ij, gj), (it, gt) in zip(pj, pt):
        assert it.shape == ij.shape
        assert _rel(it, ij) < 1e-4
        assert _rel(gt, gj) < 1e-4


@pytest.mark.parametrize("masked", [False, True])
def test_set_reference(masked):
    img = _frames()[0]
    pts, status, mask = _points()
    valid = status <= 2
    _, _, rj, rt = _refs(img, pts, valid, mask if masked else None)
    for f in ("patch", "patch_grad", "mean_i", "mean_i2"):
        assert _rel(getattr(rt, f), getattr(rj, f)) < 1e-4, f
    assert np.array_equal(_np(rt.valid), _np(rj.valid))


@pytest.mark.parametrize("levels", [5, 2], ids=["track", "point_reuse"])
def test_track(levels):
    f0, f1 = _frames()
    pts, status, _ = _points(seed=1)
    valid = status <= 2
    _, _, rj, rt = _refs(f0, pts, valid, levels=5)
    cfg_j = CFG_J._replace(max_level=levels - 1)
    cfg_t = CFG_T._replace(max_level=levels - 1)
    pj = jklt.build_pyramid(jnp.asarray(f1), cfg_j)
    pt = tklt.build_pyramid(torch.as_tensor(f1), cfg_t)
    rng = np.random.default_rng(2)
    seeds = pts + rng.normal(0, 1.0, pts.shape).astype(np.float32)
    min_ssim = 0.7 if levels == 5 else 0.75
    if levels == 2:
        rj, rt = rj.level_slice(2), rt.level_slice(2)
    xj, sj = jklt.track(pj, rj, jnp.asarray(seeds), jnp.asarray(status),
                        cfg_j, min_ssim=min_ssim)
    xt, st = tklt.track(pt, rt, torch.as_tensor(seeds),
                        torch.as_tensor(status), cfg_t, min_ssim=min_ssim)
    sj, st = _np(sj), _np(st)
    assert (sj == st).mean() >= 0.99
    ok = (sj == st) & (sj <= 2)
    assert ok.sum() > 20
    d = np.linalg.norm(_np(xt)[ok] - _np(xj)[ok], axis=-1)
    assert d.max() < 1e-3, d.max()


def test_shi_tomasi_detect_and_dilate():
    img = _frames()[0]
    rng = np.random.default_rng(3)
    occ = np.zeros((H, W), bool)
    occ[rng.integers(0, H, 12), rng.integers(0, W, 12)] = True
    mask = np.ones((H, W), bool)
    mask[:, :20] = False
    for kw in ({}, {"mask": mask, "occupied": occ}):
        xj, vj, _ = jst.detect(jnp.asarray(img), 64, nms_radius=7,
                               **{k: jnp.asarray(v) for k, v in kw.items()})
        xt, vt, _ = tst.detect(torch.as_tensor(img), 64, nms_radius=7,
                               **{k: torch.as_tensor(v)
                                  for k, v in kw.items()})
        assert np.array_equal(_np(vt), _np(vj))
        assert np.array_equal(_np(xt)[_np(vt)], _np(xj)[_np(vj)])
    assert np.array_equal(_np(timg.dilate(torch.as_tensor(occ), 31)),
                          _np(jimg.dilate(jnp.asarray(occ), 31)))
