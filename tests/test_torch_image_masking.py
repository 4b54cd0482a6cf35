"""Port parity of the preprocessing image ops and the masking filters
(nrslam_tpu/ops/image.py, nrslam_tpu/ops/masking.py) on seeded images.

Tolerances: grayscale, bilinear sampling and the Gaussian blur are float32
elementwise arithmetic in the same order (1e-4 on [0, 255] levels); CLAHE
outputs rounded LUT levels interpolated bilinearly (1e-3); erosion and the
mask filters are boolean and must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrslam_tpu.ops import image as jimg
from nrslam_tpu.ops import masking as jmask
from nrslam_tpu_torch.ops import image as timg
from nrslam_tpu_torch.ops import masking as tmask

from torch_parity import np_of

torch.set_num_threads(1)


def _image(seed=0, H=64, W=96):
    """Smooth texture + noise in [0, 255], with a dark border band and a
    bright blob so the border and bright filters have work to do."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    img = 120 + 60 * np.sin(x / 7.0) * np.cos(y / 5.0) \
        + rng.normal(0, 8.0, (H, W))
    img += 140 * np.exp(-((x - 60) ** 2 + (y - 30) ** 2) / 60.0)
    img[:, :3] = 0.0
    return np.clip(img, 0, 255).astype(np.float32)


def _close(a, b, tol):
    assert np.max(np.abs(np_of(a).astype(np.float64) - np_of(b))) <= tol


def test_rgb_to_gray():
    rgb = np.random.default_rng(1).integers(0, 256, (24, 32, 3),
                                            dtype=np.uint8)
    _close(timg.rgb_to_gray(torch.as_tensor(rgb)),
           jimg.rgb_to_gray(jnp.asarray(rgb)), 1e-4)


@pytest.mark.parametrize("clip_limit", [3.0, 1.5])
def test_clahe(clip_limit):
    img = _image(2, 64, 96)
    _close(timg.clahe(torch.as_tensor(img), clip_limit),
           jimg.clahe(jnp.asarray(img), clip_limit), 1e-3)


def test_bilinear_sample():
    rng = np.random.default_rng(3)
    img = _image(3)
    depth = np.stack([img, img * 0.5 + 3.0], -1)
    uv = np.stack([rng.uniform(-5, 100, 200), rng.uniform(-5, 70, 200)],
                  -1).astype(np.float32)
    for im in (img, depth):
        _close(timg.bilinear_sample(torch.as_tensor(im), torch.as_tensor(uv)),
               jimg.bilinear_sample(jnp.asarray(im), jnp.asarray(uv)), 1e-4)


@pytest.mark.parametrize("ksize", [3, 10, 21])
def test_erode(ksize):
    m = np.random.default_rng(ksize).uniform(size=(40, 56)) < 0.93
    assert np.array_equal(np_of(timg.erode(torch.as_tensor(m), ksize)),
                          np_of(jimg.erode(jnp.asarray(m), ksize)))


@pytest.mark.parametrize("ksize,sigma", [(11, 0.0), (5, 1.7)])
def test_gaussian_blur(ksize, sigma):
    img = _image(4)
    _close(timg.gaussian_blur(torch.as_tensor(img), ksize, sigma),
           jimg.gaussian_blur(jnp.asarray(img), ksize, sigma), 1e-4)


def test_mask_filters_and_masker():
    img = _image(5, 120, 160)
    ti, ji = torch.as_tensor(img), jnp.asarray(img)
    static = np.ones(img.shape, np.uint8)
    static[:, -12:] = 0

    def eq(a, b):
        assert np.array_equal(np_of(a), np_of(b))

    eq(tmask.border_filter(ti, 4, 6), jmask.border_filter(ji, 4, 6))
    eq(tmask.bright_filter(ti, 200.0), jmask.bright_filter(ji, 200.0))
    eq(tmask.predefined_filter(torch.as_tensor(static))(ti),
       jmask.predefined_filter(jnp.asarray(static))(ji))
    specs = [("BorderFilter", 4, 6), ("BrightFilter", 200.0)]
    mt = tmask.Masker(specs + [("PredefinedFilter", torch.as_tensor(static))])
    mj = jmask.Masker(specs + [("PredefinedFilter", jnp.asarray(static))])
    all_t, all_j = mt.get_all_masks(ti), mj.get_all_masks(ji)
    assert set(all_t) == set(all_j)
    for name in all_j:
        eq(all_t[name], all_j[name])
    g = np_of(mt(ti))
    assert 0.1 < g.mean() < 0.9  # the filters removed part of the image
