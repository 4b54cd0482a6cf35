"""The cluster kernels' layout and their fused Hessian-vector products, on
the CPU, and the port's rule that constructors build on the card.

The joint (csrc/pose_deformation.cu) and BA (csrc/bundle_adjustment.cu)
kernels run as one thread block cluster; block r owns a range of points and
their incident edge-ends (``pose_deformation_cuda.cluster_layout``), and
computes H v by having the owner of each point (each landmark copy in the
BA) recompute every incident edge's term from the stored per-edge terms and
sum them in the layout's order. CUDA has no CPU mode, so these tests check
the layout the wrappers build and a torch-op emulation of that fused
product against the plain drivers' Hv (float64, 1e-6; the two differ only
in summation order). The kernels themselves are held to the plain drivers
by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from nrslam_tpu_torch import bench_problem
from nrslam_tpu_torch.datasets import synthetic
from nrslam_tpu_torch.geometry import cameras, se3
from nrslam_tpu_torch.slam import graph, state
from nrslam_tpu_torch.slam.state import Config
from nrslam_tpu_torch.solver import bundle_adjustment as ba
from nrslam_tpu_torch.solver import core, residuals
from nrslam_tpu_torch.solver import pose_deformation as pd
from nrslam_tpu_torch.solver.pose_deformation_cuda import cluster_layout

torch.set_num_threads(1)

SCENE = synthetic.SceneConfig(height=24, width=32)
CONSTRUCTORS = {
    "pinhole": lambda device: cameras.pinhole(1.0, 1.0, 0.0, 0.0,
                                              device=device),
    "kannala_brandt8": lambda device: cameras.kannala_brandt8(
        1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, device=device),
    "synthetic.camera": lambda device: synthetic.camera(SCENE, device),
    "synthetic.camera_pose": lambda device: synthetic.camera_pose(
        1, SCENE, device),
    "synthetic.render_frame": lambda device: synthetic.render_frame(
        1, SCENE, device),
    "SyntheticSequence": lambda device: synthetic.SyntheticSequence(
        SCENE, n_frames=2, device=device).get_frame(0),
    "graph.empty": lambda device: graph.empty(8, device=device),
    "state.empty_state": lambda device: state.empty_state(
        Config(max_points=8), (24, 32), device),
    "build_bench_problem": lambda device: bench_problem.build_bench_problem(
        16, 64, 80, 8, device=device),
    "solver_problem": lambda device: bench_problem.solver_problem(
        device=device, P=48),
    "ba_problem": lambda device: bench_problem.ba_problem(device=device),
}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _tensors(x)
    elif hasattr(tree, "__dict__"):
        yield from _tensors(list(vars(tree).values()))


@pytest.mark.parametrize("name", list(CONSTRUCTORS))
def test_constructors_default_to_the_card(name):
    """device=None means the card: without one it raises, never a CPU
    fallback; device="cpu" still builds on the CPU."""
    make = CONSTRUCTORS[name]
    if torch.cuda.is_available():
        devices = {t.device.type for t in _tensors(make(None))}
        assert devices == {"cuda"}, devices
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make(None)
    devices = {t.device.type for t in _tensors(make("cpu"))}
    assert devices == {"cpu"}, devices


def _joint_edges(P):
    """The frame's edge table at P points, padded as the joint wrapper pads
    it, with its base mask."""
    cam, T0, X, obs, valid, pairs = bench_problem.solver_problem(
        device="cpu", P=P)
    cp = pd.compact_pairs(pairs, P, valid)
    E = ((cp.i.shape[0] + 127) // 128) * 128
    pad = E - cp.i.shape[0]
    base = cp.valid & valid[cp.i] & valid[cp.j]
    i = torch.nn.functional.pad(cp.i.to(torch.int64), (0, pad))
    j = torch.nn.functional.pad(cp.j.to(torch.int64), (0, pad))
    return i, j, torch.nn.functional.pad(base, (0, pad))


def _ba_edges():
    """The 3-of-5 keyframe window's edges and the mask the BA wrapper uses
    (edges any keyframe's spring uses)."""
    _, _, L0, prob = bench_problem.ba_problem(n_valid=3, device="cpu")
    _, spring, _ = ba._masks(prob)
    return (prob.pairs.i.to(torch.int64), prob.pairs.j.to(torch.int64),
            torch.any(spring, 0), L0.shape[1])


def _check_layout(i, j, live, P, blocks):
    lay = cluster_layout(i, j, live, P, blocks)
    off = lay.pt_off.tolist()
    ptr = lay.inc_ptr.tolist()
    step = (-(-P // blocks) + 3) // 4 * 4
    assert len(off) == blocks + 1 and off[0] == 0 and off[-1] == P
    assert all(0 <= b - a <= step for a, b in zip(off, off[1:]))
    # Block r's edge-ends are one contiguous run of the CSR; the runs tile
    # the live entries.
    runs = [(ptr[off[r]], ptr[off[r + 1]]) for r in range(blocks)]
    assert runs[0][0] == 0 and runs[-1][1] == ptr[P]
    assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
    edge, sign = lay.inc_edge.tolist(), lay.inc_sign.tolist()
    seen = []
    for r in range(blocks):
        for p in range(off[r], off[r + 1]):
            mine = edge[ptr[p]:ptr[p + 1]]
            assert mine == sorted(mine) and len(set(mine)) == len(mine)
            for e, s in zip(mine, sign[ptr[p]:ptr[p + 1]]):
                assert live[e] and (i[e] if s > 0 else j[e]) == p
                seen.append((e, s))
    # Every live edge-end exactly once.
    want = sorted([(e, 1.0) for e in torch.nonzero(live).flatten().tolist()]
                  + [(e, -1.0) for e in
                     torch.nonzero(live).flatten().tolist()])
    assert sorted(seen) == want
    return lay


@pytest.mark.parametrize("blocks", [8, 16])
@pytest.mark.parametrize("P", [384, 768])
def test_joint_layout_covers_every_live_edge_end(P, blocks):
    i, j, live = _joint_edges(P)
    _check_layout(i, j, live, P, blocks)


@pytest.mark.parametrize("blocks", [8, 16])
def test_ba_layout_covers_every_live_edge_end(blocks):
    i, j, live, P = _ba_edges()
    _check_layout(i, j, live, P, blocks)


def _segments(lay, P):
    """The point each CSR entry belongs to."""
    counts = lay.inc_ptr[1:] - lay.inc_ptr[:-1]
    return torch.repeat_interleave(torch.arange(P), counts.to(torch.int64))


def _owned_sum(lay, P, terms):
    """Each block sums, for each owned point, its edge-ends' terms [n, ...]
    in layout order (index_add_ on the CPU adds in index order)."""
    seg = _segments(lay, P)
    out = torch.zeros((P,) + terms.shape[1:], dtype=terms.dtype)
    off = lay.pt_off.tolist()
    for r in range(len(off) - 1):
        a, b = int(lay.inc_ptr[off[r]]), int(lay.inc_ptr[off[r + 1]])
        out.index_add_(0, seg[a:b], terms[a:b])
    return out


@pytest.mark.parametrize("P", [384, 768])
def test_joint_fused_hv_matches_plain(P):
    cam, T0, X, obs, valid, pairs = bench_problem.solver_problem(
        device="cpu", P=P)
    cam = cameras.Camera(cam.params.double(), cam.kind)
    X, obs = X.double(), obs.double()
    T0 = se3.SE3(T0.q.double(), T0.t.double())
    cp = pd.compact_pairs(pairs, P, valid)
    cp = pd.PairEdges(cp.i.to(torch.int64), cp.j.to(torch.int64),
                      cp.w.double(), cp.d0.double(), cp.valid)
    base = (cp.valid & valid[cp.i] & valid[cp.j]).double()
    pm = valid.double()
    rng = np.random.default_rng(3)
    flows = torch.as_tensor(rng.normal(0, 0.02, (P, 3)))
    lin = pd._system(cam, T0, X, obs, flows, cp, (pm, base, base),
                     pd.infos_for(1.0))
    v = torch.as_tensor(rng.normal(0, 1.0, 6 + 3 * P))
    lam = 0.37
    want = pd._make_hvp(lin, cp)(v, lam)

    lay = cluster_layout(cp.i, cp.j, base > 0, P, 8)
    e = lay.inc_edge.to(torch.int64)[:int(lay.inc_ptr[-1])]
    sg = lay.inc_sign.double()[:e.shape[0]]
    vp, vf = v[:6], v[6:].reshape(P, 3)
    dv = vf[cp.i[e]] - vf[cp.j[e]]
    a = lin.a[e]
    terms = sg[:, None] * (lin.ws[e][:, None] * dv
                           + (lin.w_p[e] * torch.sum(a * dv, -1))[:, None]
                           * a)
    r_lin = (torch.einsum("pri,i->pr", lin.J_pose, vp)
             + torch.einsum("prk,pk->pr", lin.J_flow, vf))
    h_pose = torch.einsum("pri,p,pr->i", lin.J_pose, lin.w_r, r_lin)
    h_flow = (torch.einsum("prk,p,pr->pk", lin.J_flow, lin.w_r, r_lin)
              + _owned_sum(lay, P, terms))
    got = torch.cat([h_pose, h_flow.reshape(-1)]) + lam * v
    assert float(torch.max(torch.abs(got - want))) < 1e-6


@pytest.mark.parametrize("n_valid", [5, 3])
def test_ba_fused_hv_matches_plain(n_valid):
    cam, poses, L, prob = bench_problem.ba_problem(n_valid=n_valid,
                                                   device="cpu")
    cam = cameras.Camera(cam.params.double(), cam.kind)
    poses = se3.SE3(poses.q.double(), poses.t.double())
    L = L.double()
    pairs = prob.pairs
    prob = prob._replace(obs=prob.obs.double(), scale=prob.scale.double(),
                         pairs=pd.PairEdges(
                             pairs.i.to(torch.int64), pairs.j.to(torch.int64),
                             pairs.w.double(), pairs.d0.double(),
                             pairs.valid))
    K, P, _ = L.shape
    obs_ok, spring, damper = (m.double() for m in ba._masks(prob))
    info_s = 1.0 / (0.1 * prob.scale) ** 2
    _, _, hvp, _ = ba._system(cam, poses, L, prob, obs_ok, spring, damper,
                              info_s)
    rng = np.random.default_rng(4)
    v = torch.as_tensor(rng.normal(0, 1.0, 6 * K + 3 * K * P))
    lam = 0.21
    want = hvp(v, lam)

    # Per-edge terms as the kernel stores them: springs (a, w_p) at every
    # keyframe, dampers wd2 from keyframe k to k + 1.
    i, j, w = prob.pairs.i, prob.pairs.j, prob.pairs.w
    dl = L[:, i] - L[:, j]
    dist = torch.linalg.norm(dl, dim=-1)
    a = (ba.SPRING_K / torch.clamp(prob.pairs.d0, min=1e-12))[None, :, None] \
        * dl / torch.clamp(dist, min=1e-12)[..., None]
    w_p = ba.INFO_POSITION * spring
    dd = dl[1:] - dl[:-1]
    chi2_d = info_s * w[None] ** 2 * torch.sum(dd * dd, -1)
    wd2 = info_s * core.huber_weight(chi2_d, ba.TH_3DOF) * damper * w[None] ** 2
    wd2 = torch.cat([wd2, torch.zeros_like(wd2[:1])])

    lay = cluster_layout(i, j, torch.any(spring > 0, 0), P, 16)
    e = lay.inc_edge.to(torch.int64)[:int(lay.inc_ptr[-1])]
    sg = lay.inc_sign.double()[:e.shape[0]]
    vp, vl = v[:6 * K].reshape(K, 6), v[6 * K:].reshape(K, P, 3)
    dv = (vl[:, i[e]] - vl[:, j[e]]) * (w_p[:, e] != 0)[..., None]
    sv = wd2[:, e, None] * (torch.cat([dv[1:], torch.zeros_like(dv[:1])])
                            - dv)
    prev = torch.cat([torch.zeros_like(sv[:1]), sv[:-1]])
    ae = a[:, e]
    terms = sg[None, :, None] * (
        (w_p[:, e] * torch.sum(ae * dv, -1))[..., None] * ae - sv + prev)

    obs_c = torch.where(obs_ok[..., None] > 0, prob.obs, torch.zeros_like(
        prob.obs))
    e_r, J_pose, J_land = residuals.reprojection(
        cam, se3.SE3(poses.q[:, None], poses.t[:, None]), L, obs_c)
    live = obs_ok > 0
    J_pose = torch.where(live[..., None, None], J_pose,
                         torch.zeros_like(J_pose))
    J_land = torch.where(live[..., None, None], J_land,
                         torch.zeros_like(J_land))
    e_r = torch.where(live[..., None], e_r, torch.zeros_like(e_r))
    chi2_r = ba.INFO_REPROJECTION * torch.sum(e_r * e_r, -1)
    w_r = ba.INFO_REPROJECTION * core.huber_weight(chi2_r, ba.TH_2DOF) \
        * obs_ok
    r_lin = (torch.einsum("kpri,ki->kpr", J_pose, vp)
             + torch.einsum("kprl,kpl->kpr", J_land, vl))
    h_pose = torch.einsum("kpri,kp,kpr->ki", J_pose, w_r, r_lin)
    h_land = torch.einsum("kprl,kp,kpr->kpl", J_land, w_r, r_lin) + torch.stack(
        [_owned_sum(lay, P, terms[k]) for k in range(K)])
    got = torch.cat([h_pose.reshape(-1), h_land.reshape(-1)]) + lam * v
    assert float(torch.max(torch.abs(got - want))) < 1e-6
