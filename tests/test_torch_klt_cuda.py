"""The KLT kernel's wrapper (ops/klt_cuda.py) on the CPU: the argument
preparation as a plain function (each level's pointers and sizes, the
reference fields' pointers and strides, ``level_slice`` views read where
they lie, copies only of what the kernel could not read), its parameter
struct against the kernel source's, the launch refusing CPU tensors, and
``klt.track`` on CPU tensors taking the plain path without touching the
kernel library. The kernel itself runs only on a card (chip_smoke.py
[klt])."""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from nrslam_tpu_torch import kernels
from nrslam_tpu_torch.datasets import synthetic
from nrslam_tpu_torch.ops import klt, klt_cuda
from nrslam_tpu_torch.utils import profiler

torch.set_num_threads(1)

H, W = 60, 80
SOURCE = Path(kernels.SOURCE_DIR) / "klt.cu"


def _problem(n=24, seed=0):
    scene = synthetic.SceneConfig(height=H, width=W, deform_amp=0.02)
    f0 = synthetic.render_frame(0, scene, device="cpu")[0]
    f1 = synthetic.render_frame(1, scene, device="cpu")[0]
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(0, W, n), rng.uniform(0, H, n)],
                   -1).astype(np.float32)
    status = rng.choice([0, 1, 3, 6], n).astype(np.int32)
    cfg = klt.KLTConfig()
    refs = klt.set_reference(klt.build_pyramid(f0, cfg),
                             torch.as_tensor(pts),
                             torch.as_tensor(status <= 2), cfg)
    seeds = torch.as_tensor(pts + rng.normal(0, 1, pts.shape)
                            .astype(np.float32))
    return klt.build_pyramid(f1, cfg), refs, seeds, \
        torch.as_tensor(status), cfg


@pytest.mark.parametrize("levels", [5, 2], ids=["track", "point_reuse"])
def test_prepare_reads_levels_and_refs_where_they_lie(levels):
    pyr, refs, seeds, status, cfg = _problem()
    full = refs
    if levels == 2:
        refs, pyr = refs.level_slice(2), pyr[:2]
    c = cfg._replace(max_level=levels - 1)
    prep = klt_cuda.prepare(pyr, refs, seeds, status, c, 0.75,
                            use_initial_flow=False)
    p = prep.params
    assert (p.n_levels, p.P) == (levels, seeds.shape[0])
    for k, (img, grad) in enumerate(pyr):
        lv = p.level[k]
        assert (lv.img, lv.grad) == (img.data_ptr(), grad.data_ptr())
        assert (lv.h, lv.w) == tuple(img.shape)
    # The sliced views are the full refs' storage, read through strides.
    L = full.patch.shape[1]
    assert p.patch == full.patch.data_ptr()
    assert (p.patch_sp, p.patch_sl) == (L * 21 * 21, 21 * 21)
    assert p.patch_grad == full.patch_grad.data_ptr()
    assert (p.grad_sp, p.grad_sl) == (L * 21 * 21 * 2, 21 * 21 * 2)
    for name in ("mean_i", "mean_i2", "valid"):
        assert getattr(p, name) == getattr(full, name).data_ptr()
        assert (getattr(p, name + "_sp"), getattr(p, name + "_sl")) == (L, 1)
    assert p.ref_points == full.points.data_ptr() and p.ref_points_sp == 2
    assert p.seeds == seeds.data_ptr() and p.status_in == status.data_ptr()
    assert (p.max_iters, p.use_initial_flow) == (c.max_iters, 0)
    assert p.epsilon == pytest.approx(c.epsilon)
    assert p.min_eig_threshold == pytest.approx(c.min_eig_threshold)
    assert p.min_ssim == pytest.approx(0.75)
    assert prep.pts.shape == (seeds.shape[0], 2)
    assert prep.status.dtype == prep.iters.dtype == torch.int32
    assert {p.pts_out, p.status_out, p.iters_out} == {
        prep.pts.data_ptr(), prep.status.data_ptr(), prep.iters.data_ptr()}


def test_prepare_copies_only_what_the_kernel_cannot_read():
    """A window whose pixels are not contiguous, a gradient off its 8-byte
    alignment and int64 statuses are copied or cast; the rest is not."""
    pyr, refs, seeds, status, cfg = _problem()
    patch = refs.patch.transpose(2, 3)  # same shape, columns strided
    grad = torch.empty(pyr[1][1].numel() + 1)[1:].view(pyr[1][1].shape)
    grad.copy_(pyr[1][1])
    pyr = [pyr[0], (pyr[1][0], grad)] + pyr[2:]
    prep = klt_cuda.prepare(pyr, refs._replace(patch=patch), seeds,
                            status.to(torch.int64), cfg, 0.7)
    p = prep.params
    assert p.patch != refs.patch.data_ptr() and p.patch % 4 == 0
    assert (p.patch_sp, p.patch_sl) == (5 * 21 * 21, 21 * 21)
    assert p.level[1].grad != grad.data_ptr() and p.level[1].grad % 8 == 0
    assert p.level[0].grad == pyr[0][1].data_ptr()
    assert p.patch_grad == refs.patch_grad.data_ptr()
    assert p.status_in != status.data_ptr()
    assert prep.status_dtype == torch.int64


@pytest.mark.parametrize("bad", ["window", "levels", "refs", "seeds"])
def test_prepare_refuses_what_the_kernel_cannot_run(bad):
    pyr, refs, seeds, status, cfg = _problem()
    if bad == "window":
        cfg = cfg._replace(win=15)
    elif bad == "levels":
        pyr = pyr + pyr[:4]
    elif bad == "refs":
        refs = refs.level_slice(2)
    else:
        seeds = seeds[:-1]
    with pytest.raises(ValueError):
        klt_cuda.prepare(pyr, refs, seeds, status, cfg, 0.7)


def test_params_mirror_the_kernel_struct():
    """``Params`` names KltParams' fields in the source's order, with the
    source's constants (the card checks the size too, ``layout``)."""
    src = SOURCE.read_text()
    body = re.search(r"struct KltParams \{(.*?)\n\};", src, re.S).group(1)
    names = []
    for decl in re.findall(r"^\s*([^/\n][^;]*);", body, re.M):
        names += [n.strip().split("[")[0]
                  for n in decl.split(None, 1)[1].replace("*", " ").split(",")
                  if n.strip()]
    want = [n.split()[-1] for n in names]
    assert [f for f, _ in klt_cuda.Params._fields_] == want
    assert f"kMaxLevels = {klt_cuda.MAX_LEVELS};" in src
    assert f"kWin = {klt_cuda.WIN};" in src
    assert ctypes.sizeof(klt_cuda.Level) == 24


def test_launch_raises_on_cpu_tensors(monkeypatch):
    """The wrapper never falls back: CPU tensors raise before the library is
    built or loaded, and nothing is counted."""
    def fail():
        raise AssertionError("the kernel library was touched")

    monkeypatch.setattr(kernels, "library", fail)
    pyr, refs, seeds, status, cfg = _problem()
    before = profiler.tallies()
    with pytest.raises(ValueError, match="CUDA"):
        klt_cuda.track(pyr, refs, seeds, status, cfg, 0.7)
    assert profiler.tallies() == before


@pytest.mark.parametrize("levels", [5, 2], ids=["track", "point_reuse"])
def test_cpu_tensors_take_the_plain_path(monkeypatch, levels):
    """``klt.track`` on CPU tensors is ``track_plain``, bit for bit, and
    never reaches the wrapper or the kernel library."""
    def fail(*a, **k):
        raise AssertionError("the kernel route was taken")

    pyr, refs, seeds, status, cfg = _problem(seed=1)
    c = cfg._replace(max_level=levels - 1)
    if levels == 2:
        refs, pyr = refs.level_slice(2), pyr[:2]
    want = klt.track_plain(pyr, refs, seeds, status, c, 0.7)
    monkeypatch.setattr(kernels, "library", fail)
    monkeypatch.setattr(klt_cuda, "track", fail)
    got = klt.track(pyr, refs, seeds, status, c, 0.7)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
