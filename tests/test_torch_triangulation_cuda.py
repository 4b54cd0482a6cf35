"""The deformable triangulation kernel's wrapper
(solver/deformable_triangulation_cuda.py) on the CPU: the argument
preparation as a plain function (pointers, strides, sizes and the camera
kind; the permuted views the mapping builds read where they lie, casts or
copies only of what the kernel could not read), its parameter struct
against the kernel source's, the launch refusing CPU tensors and shapes
beyond the kernel's limits, and ``deformable_triangulate`` on CPU tensors
taking the plain path without touching the kernel library. The kernel
itself runs only on a card (chip_smoke.py [tri])."""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from nrslam_tpu_torch import kernels
from nrslam_tpu_torch.geometry import cameras, se3
from nrslam_tpu_torch.solver import deformable_triangulation as dt
from nrslam_tpu_torch.solver import deformable_triangulation_cuda as dtc
from nrslam_tpu_torch.utils import profiler

torch.set_num_threads(1)

SOURCE = Path(kernels.SOURCE_DIR) / "deformable_triangulation.cu"


def _camera(kind):
    if kind == cameras.KB8:
        return cameras.kannala_brandt8(250.0, 250.0, 159.5, 119.5, -0.01,
                                       0.02, -0.01, 0.002, device="cpu")
    return cameras.pinhole(250.0, 250.0, 159.5, 119.5, device="cpu")


def _problem(kind=cameras.PINHOLE, C=6, T=8, NB=5, seed=0):
    """A seeded triangulation problem, its inputs laid out as
    ``mapping._deformable_inputs`` leaves them: obs and track transposed
    views of [T, C] rings, nbr_pos a permuted view of a [T, C, NB, 3]
    gather."""
    rng = np.random.default_rng(seed)
    cam = _camera(kind)
    ang = np.linspace(0.0, 0.08, T)
    q = np.stack([np.cos(ang / 2), np.zeros(T), np.sin(ang / 2),
                  np.zeros(T)], -1).astype(np.float32)
    t = np.stack([np.linspace(0.0, 0.3, T), np.zeros(T), np.zeros(T)],
                 -1).astype(np.float32)
    poses = se3.SE3(torch.as_tensor(q), torch.as_tensor(t))

    def sample(*shape):
        return np.stack([rng.uniform(-0.8, 0.8, shape),
                         rng.uniform(-0.6, 0.6, shape),
                         rng.uniform(2.5, 3.5, shape)], -1).astype(np.float32)

    X = torch.as_tensor(sample(C))
    obs_tc = torch.stack([cameras.project(cam, se3.apply(
        se3.index(poses, torch.tensor(k)), X)) for k in range(T)])
    obs_tc = obs_tc + torch.as_tensor(
        rng.normal(0.0, 0.3, obs_tc.shape).astype(np.float32))
    track_tc = torch.as_tensor(rng.uniform(size=(T, C)) > 0.1)
    nbr_tcn = torch.as_tensor(np.repeat(sample(C, NB)[None], T, 0))
    nv = torch.as_tensor(rng.uniform(size=(T, C, NB)) > 0.1)
    inputs = dt.TriangulationInputs(
        obs=obs_tc.transpose(0, 1), track_valid=track_tc.T,
        nbr_pos=nbr_tcn.permute(1, 2, 0, 3), nbr_valid=nv.permute(1, 2, 0),
        cand_valid=torch.as_tensor(rng.uniform(size=C) > 0.2))
    return cam, inputs, poses


@pytest.mark.parametrize("kind", [cameras.PINHOLE, cameras.KB8])
def test_prepare_reads_the_inputs_where_they_lie(kind):
    cam, inputs, poses = _problem(kind)
    C, T, _ = inputs.obs.shape
    NB = inputs.nbr_pos.shape[1]
    prep = dtc.prepare(cam, inputs, poses, 0.004, min_track=4, n_iters=7,
                       cg_iters=9)
    p = prep.params
    # The permuted views are their rings' storage, read through strides.
    assert p.obs == inputs.obs.data_ptr()
    assert (p.obs_sc, p.obs_st, p.obs_sk) == (2, 2 * C, 1)
    assert p.track == inputs.track_valid.data_ptr()
    assert (p.track_sc, p.track_st) == (1, C)
    assert p.nbr_pos == inputs.nbr_pos.data_ptr()
    assert (p.nbr_sc, p.nbr_sn, p.nbr_st, p.nbr_sk) == (
        3 * NB, 3, 3 * NB * C, 1)
    assert p.nbr_valid == inputs.nbr_valid.data_ptr()
    assert (p.nv_sc, p.nv_sn, p.nv_st) == (NB, 1, NB * C)
    assert p.cand_valid == inputs.cand_valid.data_ptr() and p.cand_s == 1
    assert (p.pose_q, p.pose_t) == (poses.q.data_ptr(), poses.t.data_ptr())
    assert p.cam == cam.params.data_ptr()
    assert (p.C, p.T, p.NB) == (C, T, NB)
    assert p.kind == (1 if kind == cameras.KB8 else 0)
    assert (p.min_track, p.n_iters, p.cg_iters) == (4, 7, 9)
    assert p.parallax_min == pytest.approx(0.004 * 5.0)
    assert prep.landmark.shape == (C, 3) and prep.ok.shape == (C,)
    assert prep.ok.dtype == torch.bool
    assert prep.accepted.dtype == torch.int32
    assert {p.landmark_out, p.ok_out, p.accepted_out} == {
        prep.landmark.data_ptr(), prep.ok.data_ptr(),
        prep.accepted.data_ptr()}


def test_prepare_casts_only_what_the_kernel_cannot_read():
    """float64 observations are cast, poses that are not contiguous are
    copied; every other input is read where it lies."""
    cam, inputs, poses = _problem()
    obs64 = inputs.obs.double()
    q = torch.cat([poses.q, poses.q], 1)[:, ::2]  # strided [T, 4]
    prep = dtc.prepare(cam, inputs._replace(obs=obs64),
                       se3.SE3(q, poses.t), 0.004)
    p = prep.params
    assert p.obs != obs64.data_ptr()
    assert p.pose_q != q.data_ptr() and p.pose_t == poses.t.data_ptr()
    assert p.nbr_pos == inputs.nbr_pos.data_ptr()
    assert p.track == inputs.track_valid.data_ptr()


@pytest.mark.parametrize("bad", ["frames", "neighbours", "obs", "poses",
                                 "camera", "schedule"])
def test_prepare_refuses_what_the_kernel_cannot_run(bad):
    cam, inputs, poses = _problem()
    if bad == "frames":
        cam, inputs, poses = _problem(T=dtc.MAX_T + 1)
    elif bad == "neighbours":
        cam, inputs, poses = _problem(NB=dtc.MAX_NB + 1)
    elif bad == "obs":
        inputs = inputs._replace(obs=inputs.obs[:, :-1])
    elif bad == "poses":
        poses = se3.SE3(poses.q[:-1], poses.t[:-1])
    elif bad == "camera":
        cam = cameras.Camera(cam.params[:3], cam.kind)
    with pytest.raises(ValueError):
        dtc.prepare(cam, inputs, poses, 0.004,
                    n_iters=-1 if bad == "schedule" else 10)


def test_params_mirror_the_kernel_struct():
    """``Params`` names TriParams' fields in the source's order, with the
    source's limits (the card checks the size too, ``layout``)."""
    src = SOURCE.read_text()
    body = re.search(r"struct TriParams \{(.*?)\n\};", src, re.S).group(1)
    names = []
    for decl in re.findall(r"^\s*([^/\n][^;]*);", body, re.M):
        names += [part.replace("*", " ").split()[-1]
                  for part in decl.split(",")]
    assert [f for f, _ in dtc.Params._fields_] == names
    assert f"kMaxT = {dtc.MAX_T};" in src
    assert f"kMaxNb = {dtc.MAX_NB};" in src
    assert ctypes.sizeof(dtc.Params) == 11 * 8 + 13 * 8 + 7 * 4 + 4


def test_launch_raises_on_cpu_tensors(monkeypatch):
    """The wrapper never falls back: CPU tensors raise before the library is
    built or loaded, and nothing is counted."""
    def fail():
        raise AssertionError("the kernel library was touched")

    monkeypatch.setattr(kernels, "library", fail)
    cam, inputs, poses = _problem()
    before = profiler.tallies()
    with pytest.raises(ValueError, match="CUDA"):
        dtc.triangulate(cam, inputs, poses, 0.004)
    assert profiler.tallies() == before


@pytest.mark.parametrize("kind", [cameras.PINHOLE, cameras.KB8])
def test_cpu_tensors_take_the_plain_path(monkeypatch, kind):
    """``deformable_triangulate`` on CPU tensors is
    ``deformable_triangulate_plain``, bit for bit, and never reaches the
    wrapper or the kernel library."""
    def fail(*a, **k):
        raise AssertionError("the kernel route was taken")

    cam, inputs, poses = _problem(kind, seed=1)
    want = dt.deformable_triangulate_plain(cam, inputs, poses, 0.004)
    monkeypatch.setattr(kernels, "library", fail)
    monkeypatch.setattr(dtc, "triangulate", fail)
    got = dt.deformable_triangulate(cam, inputs, poses, 0.004)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
