"""The partitioned routes' plans and the fixed summation order of their
phase kernels, on the CPU.

Each phase of csrc/pose_deformation_shard.cu (joint) and
csrc/bundle_adjustment_shard.cu (BA) is one thread block cluster whose
blocks own whole chunks of 64 of the rank's points; the wrappers build the
blocks and a per-end table (i, j, far end, sign at every position of the
incidence CSR) with device ops (``pose_deformation_cuda.shard_plan``,
``bundle_adjustment_cuda.shard_tables``). A chunk's row of partial sums is
taken in a fixed order: each edge-end's (or (edge-end, keyframe) pair's)
term, a point copy's terms in CSR order, its own terms, its keyframes in
order, then a tree over the chunk's 64 point slots (csrc/shard_phase.cuh).

CUDA has no CPU mode, so these tests check the plans the wrappers build (on
1, 2 and 4 ranks) and a torch-op emulation of that order against the plain
partitioned drivers' Hessian-vector products (``solve_shard._hv``,
``ba_points._hv_land``) in float64 to 1e-6: the two differ only in
summation order. The kernels themselves are held to the plain drivers by
chip_smoke.py.
"""

import functools

import numpy as np
import pytest
import torch

from nrslam_tpu_torch import bench_problem
from nrslam_tpu_torch.geometry import cameras, se3
from nrslam_tpu_torch.parallel import ba_points, sharding, solve_shard
from nrslam_tpu_torch.solver import bundle_adjustment as ba
from nrslam_tpu_torch.solver import bundle_adjustment_cuda as bac
from nrslam_tpu_torch.solver import pose_deformation as pd
from nrslam_tpu_torch.solver import pose_deformation_cuda as pdc

torch.set_num_threads(1)

CHUNK = 64
# Most blocks a phase's cluster takes: the kernels' kMaxBlocks.
MAX_BLOCKS = {"joint": 8, "ba": 16}


@functools.lru_cache(maxsize=None)
def _joint(P):
    """The joint solve's problem at P points in float64, its compacted
    edges (int64 i, j) and their live mask."""
    cam, T0, X, obs, valid, pairs = bench_problem.solver_problem(
        device="cpu", P=P)
    cp = pd.compact_pairs(pairs, P, valid)
    cp = pd.PairEdges(cp.i.to(torch.int64), cp.j.to(torch.int64),
                      cp.w.double(), cp.d0.double(), cp.valid)
    base = cp.valid & valid[cp.i] & valid[cp.j]
    return (cameras.Camera(cam.params.double(), cam.kind),
            se3.SE3(T0.q.double(), T0.t.double()), X.double(), obs.double(),
            valid, cp, base)


@functools.lru_cache(maxsize=None)
def _ba(P, n_valid=5):
    """The window BA's problem (W = 5) in float64 with its masks."""
    cam, poses, L, prob = bench_problem.ba_problem(n_valid=n_valid,
                                                   device="cpu", P=P)
    pairs = prob.pairs
    prob = prob._replace(obs=prob.obs.double(), scale=prob.scale.double(),
                         pairs=pd.PairEdges(
                             pairs.i.to(torch.int64), pairs.j.to(torch.int64),
                             pairs.w.double(), pairs.d0.double(),
                             pairs.valid))
    obs_ok, spring, damper = ba._masks(prob)
    return (cameras.Camera(cam.params.double(), cam.kind),
            se3.SE3(poses.q.double(), poses.t.double()), L.double(), prob,
            obs_ok, spring, damper)


def _plan(route, P, blk):
    """The route's plan for the rank owning ``blk`` and the edges' (i, j,
    live)."""
    if route == "joint":
        cp, base = _joint(P)[5:7]
        return pdc.shard_plan(cp.i, cp.j, base, P, blk,
                              MAX_BLOCKS[route]), (cp.i, cp.j, base)
    _, _, _, prob, _, spring, damper = _ba(P)
    plan, econ = bac.shard_tables(prob.pairs, spring, damper, P, blk,
                                  MAX_BLOCKS[route])
    bits = econ[:, 2].view(torch.int32)
    k = torch.arange(spring.shape[0])[:, None]
    assert torch.equal(bits, ((spring.long() << k).sum(0) + (
        damper.long() << (8 + k[:-1])).sum(0)).to(torch.int32)[plan.edge])
    return plan, (prob.pairs.i, prob.pairs.j, torch.any(spring, 0))


def _blocks(P, n):
    return [sharding.rank_block(sharding.Mesh(r, n, None, "cpu"), P)
            for r in range(n)]


@pytest.mark.parametrize("n", (1, 2, 4))
@pytest.mark.parametrize("P", (384, 768))
@pytest.mark.parametrize("route", ("joint", "ba"))
def test_plan_gives_every_chunk_to_one_block(route, P, n):
    """The rank's chunks (64 global points each, a rank's block cutting a
    chunk at P = 384 on 4 ranks) are shared out over min(most blocks,
    chunks) blocks, each a non-empty run of whole chunks."""
    for blk in _blocks(P, n):
        off = _plan(route, P, blk)[0].chunk_off.tolist()
        g0, g1 = blk.start // CHUNK, (blk.stop - 1) // CHUNK
        assert off[0] == g0 and off[-1] == g1 + 1
        assert len(off) - 1 == min(MAX_BLOCKS[route], g1 - g0 + 1)
        assert all(b > a for a, b in zip(off, off[1:]))
        # Every block owns some of the rank's points.
        assert all(max(blk.start, CHUNK * a) < min(blk.stop, CHUNK * b)
                   for a, b in zip(off, off[1:]))


@pytest.mark.parametrize("n", (1, 2, 4))
@pytest.mark.parametrize("route", ("joint", "ba"))
def test_plan_table_lists_every_live_end_once(route, n):
    """The rank's positions [inc_ptr[p0], inc_ptr[p0 + m]) of the table
    list every live edge-end of its points exactly once, each point's in
    edge order: (i, j) the edge's, the point at the end the sign names,
    the far end the other."""
    P = 768
    for blk in _blocks(P, n):
        plan, (i, j, live) = _plan(route, P, blk)
        ptr = plan.inc_ptr.tolist()
        seen = []
        for p in range(blk.start, blk.stop):
            rows = plan.ends[ptr[p]:ptr[p + 1]].long()
            e = plan.edge[ptr[p]:ptr[p + 1]]
            assert torch.equal(e, torch.sort(e).values)
            assert bool(torch.all(live[e]))
            assert torch.equal(rows[:, 0], i[e]) and torch.equal(rows[:, 1],
                                                                 j[e])
            s = rows[:, 3]
            assert torch.equal(torch.where(s > 0, rows[:, 0], rows[:, 1]),
                               torch.full_like(s, p))
            assert torch.equal(rows[:, 2], torch.where(s > 0, rows[:, 1],
                                                       rows[:, 0]))
            seen += list(zip(e.tolist(), s.tolist()))
        mine = lambda x: (x >= blk.start) & (x < blk.stop)  # noqa: E731
        want = ([(e, 1) for e in torch.nonzero(live & mine(i))[:, 0].tolist()]
                + [(e, -1) for e in
                   torch.nonzero(live & mine(j))[:, 0].tolist()])
        assert sorted(seen) == sorted(want)


@pytest.mark.parametrize("n", (2, 4))
@pytest.mark.parametrize("route", ("joint", "ba"))
def test_plan_table_is_the_one_rank_table(route, n):
    """Every rank builds the one-rank table, and the ranks' sections of it
    tile the one-rank live section in order."""
    P = 768
    one = _plan(route, P, slice(0, P))[0]
    sections = []
    for blk in _blocks(P, n):
        plan = _plan(route, P, blk)[0]
        assert torch.equal(plan.ends, one.ends)
        assert torch.equal(plan.inc_ptr, one.inc_ptr)
        sections.append(plan.ends[int(plan.inc_ptr[blk.start]):
                                  int(plan.inc_ptr[blk.stop])])
    assert torch.equal(torch.cat(sections),
                       one.ends[:int(one.inc_ptr[P])])


def _tree(v):
    """A chunk's row from its 64 point slots [64, S]: slot q + slot q + 32,
    then the shuffle-down tree 16, 8, 4, 2, 1 (shard_phase.cuh
    chunk_rows)."""
    s = v[:32] + v[32:]
    for off in (16, 8, 4, 2, 1):
        s = s[:off] + s[off:2 * off]
    return s[0]


def _rows(per_point, blk, P):
    """The rank's per-point sums [m, S] as chunk rows [nc, S], zero outside
    its chunks."""
    nc = -(-P // CHUNK)
    slots = per_point.new_zeros((nc * CHUNK, per_point.shape[1]))
    slots[blk] = per_point
    return torch.stack([_tree(slots[g * CHUNK:(g + 1) * CHUNK])
                        for g in range(nc)])


def _section(plan, blk):
    """The rank's table rows, their owners' local indices and signs."""
    k0, k1 = int(plan.inc_ptr[blk.start]), int(plan.inc_ptr[blk.stop])
    rows = plan.ends[k0:k1].long()
    counts = plan.inc_ptr[blk.start + 1:blk.stop + 1] \
        - plan.inc_ptr[blk.start:blk.stop]
    lp = torch.repeat_interleave(torch.arange(blk.stop - blk.start),
                                 counts.long())
    return rows, lp, rows[:, 3].double()


@pytest.mark.parametrize("P", (384, 768))
def test_joint_fixed_order_matches_plain_hv(P):
    """The joint's hv phase in its fixed order (per-end terms from the
    table, each point's ends in CSR order, its reprojection term, the
    chunk trees) against ``solve_shard._hv`` on 1 and 4 ranks: H p per
    point and the reduced pose part and p.Hp to 1e-6; the reduced rows of
    4 ranks bit for bit one rank's where the ranks' blocks are whole
    chunks (P = 768)."""
    cam, T0, X, obs, valid, cp, base = _joint(P)
    rng = np.random.default_rng(5)
    flows = torch.as_tensor(rng.normal(0, 0.02, (P, 3)))
    p_full = torch.as_tensor(rng.normal(0, 1.0, (P, 3)))
    p_p = torch.as_tensor(rng.normal(0, 1.0, 6))
    lam = 0.37
    infos = tuple(torch.as_tensor(x, dtype=torch.float64)
                  for x in pd.infos_for(1.0))
    rows_by_n = {}
    for n in (1, 4):
        rows, plain = 0.0, 0.0
        for r, blk in enumerate(_blocks(P, n)):
            mesh = sharding.Mesh(r, n, None, "cpu")
            ends = solve_shard._Ends(mesh, cp, base, X, P)
            pm = valid[blk].double()
            lin = solve_shard._linearize(cam, T0, X[blk], obs[blk], flows,
                                         blk, ends, (pm, ends.base,
                                                     ends.base), infos)
            hp_want, terms = solve_shard._hv(lin, ends, p_full, p_p, lam,
                                             blk, blk.stop - blk.start)
            plain = plain + solve_shard._rows(terms, blk, P)

            plan = pdc.shard_plan(cp.i, cp.j, base, P, blk, 8)
            ends_t, lp, sg = _section(plan, blk)
            dv = p_full[ends_t[:, 0]] - p_full[ends_t[:, 1]]
            term = sg[:, None] * (
                lin.ws[:, None] * dv
                + (lin.w_p * torch.sum(lin.a * dv, -1))[:, None] * lin.a)
            esum = torch.zeros_like(p_full[blk]).index_add_(0, lp, term)
            pf = p_full[blk]
            r_lin = (torch.einsum("prk,pk->pr", lin.J_flow, pf)
                     + torch.einsum("pri,i->pr", lin.J_pose, p_p))
            hd = (torch.einsum("prk,p,pr->pk", lin.J_flow, lin.w_r, r_lin)
                  + esum + lam * pf)
            assert float(torch.max(torch.abs(hd - hp_want))) < 1e-6
            part = torch.cat([
                torch.einsum("pri,p,pr->pi", lin.J_pose, lin.w_r, r_lin),
                torch.sum(pf * hd, -1, keepdim=True)], 1)
            rows = rows + _rows(part, blk, P)
        rows_by_n[n] = rows
        got, want = torch.sum(rows, 0), torch.sum(plain, 0)
        assert float(torch.max(torch.abs(got - want))) < 1e-6
    if (P // 4) % CHUNK == 0:  # the ranks' blocks are whole chunks
        assert torch.equal(rows_by_n[1], rows_by_n[4])


@pytest.mark.parametrize("n_valid", (5, 3))
def test_ba_fixed_order_matches_plain_hv(n_valid):
    """The BA's hv phase in its fixed order (per (edge-end, keyframe) pair
    terms from the table, each copy's pairs in CSR order, its reprojection
    term, a point's keyframes in order, the chunk trees) against
    ``ba_points._hv_land`` on 1 and 4 ranks at P = 768: H p per copy and
    the reduced pose parts and p.Hp to 1e-6; the reduced rows of 4 ranks
    bit for bit one rank's."""
    P = 768
    cam, poses, L, prob, obs_ok, spring, damper = _ba(P, n_valid)
    W = L.shape[0]
    info_s = 1.0 / (0.1 * prob.scale) ** 2
    rng = np.random.default_rng(6)
    p_full = torch.as_tensor(rng.normal(0, 1.0, (W, P, 3)))
    p_pose = torch.as_tensor(rng.normal(0, 1.0, (W, 6)))
    lam = 0.21
    rows_by_n = {}
    for n in (1, 4):
        rows, plain = 0.0, 0.0
        for r, blk in enumerate(_blocks(P, n)):
            m = blk.stop - blk.start
            mesh = sharding.Mesh(r, n, None, "cpu")
            ends = ba_points._Ends(mesh, prob.pairs, spring, damper, P)
            lin = ba_points._linearize(cam, poses, L, prob.obs[:, blk],
                                       obs_ok[:, blk], blk, ends, info_s)
            hp_want, terms = ba_points._hv_land(lin, ends, p_full, p_pose,
                                                lam, blk, m)
            plain = plain + solve_shard._rows(terms, blk, P)

            plan, _ = bac.shard_tables(prob.pairs, spring, damper, P, blk, 16)
            ends_t, lp, sg = _section(plan, blk)
            dv = p_full[:, ends_t[:, 0]] - p_full[:, ends_t[:, 1]]
            zero = torch.zeros_like(dv[:1])
            wd2 = torch.cat([lin.wd2, torch.zeros_like(lin.wd2[:1])])
            wm = torch.cat([torch.zeros_like(lin.wd2[:1]), lin.wd2])
            v = ((lin.w_p * torch.sum(lin.a * dv, -1))[..., None] * lin.a
                 - wd2[..., None] * (torch.cat([dv[1:], zero]) - dv)
                 + wm[..., None] * (dv - torch.cat([zero, dv[:-1]])))
            term = sg[None, :, None] * v
            esum = torch.zeros((W, m, 3), dtype=torch.float64).index_add_(
                1, lp, term)
            pf = p_full[:, blk]
            r_lin = (torch.einsum("kprl,kpl->kpr", lin.J_land, pf)
                     + torch.einsum("kpri,ki->kpr", lin.J_pose, p_pose))
            hd = (torch.einsum("kprl,kp,kpr->kpl", lin.J_land, lin.w_r,
                               r_lin) + esum + lam * pf)
            assert float(torch.max(torch.abs(hd - hp_want))) < 1e-6
            pose = torch.einsum("kpri,kp,kpr->kpi", lin.J_pose, lin.w_r,
                                r_lin)
            php = torch.sum(pf * hd, -1)
            point = php[0]
            for k in range(1, W):
                point = point + php[k]
            part = torch.cat([pose.permute(1, 0, 2).reshape(m, 6 * W),
                              point[:, None]], 1)
            rows = rows + _rows(part, blk, P)
        rows_by_n[n] = rows
        got, want = torch.sum(rows, 0), torch.sum(plain, 0)
        assert float(torch.max(torch.abs(got - want))) < 1e-6
    assert torch.equal(rows_by_n[1], rows_by_n[4])


def _key(name, args="nrslam::(anonymous namespace)::Ctx, int, int"):
    """A device kernel's name as torch.profiler reports it."""
    return f"nrslam::(anonymous namespace)::{name}({args})"


@pytest.mark.parametrize("make_keyframe", (False, True))
def test_replay_split_by_kernel_name(make_keyframe):
    """``dryrun.shard_routes_in_replay`` tells the routes' phase kernels
    apart by name (``joint_*``, ``ba_*``, the pose-only route's three), in
    any launch order, with the whole-solver kernels and others left out;
    ``complete`` holds only for a replay with every launch of the frame's
    schedule."""
    from nrslam_tpu_torch.parallel import dryrun
    from nrslam_tpu_torch.solver import pose_only_cuda as poc

    routes = {"pose_only_shard": poc.shard_phase_launches(),
              "pose_deformation_shard": pdc.shard_phase_launches()}
    if make_keyframe:
        routes["bundle_adjustment_shard"] = bac.shard_phase_launches()
    prefix = {"pose_only_shard": "", "pose_deformation_shard": "joint_",
              "bundle_adjustment_shard": "ba_"}
    ours = [(_key("pose_deformation_kernel"), 5.0), (_key("ba_kernel"), 7.0),
            ("void at::native::vectorized_elementwise_kernel", 9.0)]
    for route, launches in routes.items():
        for phase, n in launches.items():
            name = (f"{phase}_kernel" if route == "pose_only_shard"
                    else f"{prefix[route]}{phase}")
            ours += [(_key(name), 0.25)] * n
    ours = ours[::-1]  # order does not matter
    out = dryrun.shard_routes_in_replay(ours, make_keyframe)
    for route, launches in routes.items():
        n = sum(launches.values())
        assert out[route] == (0.25 * n, n)
        assert {p: v[1] for p, v in out["phases"][route].items()} == launches
    assert ("bundle_adjustment_shard" in out) == make_keyframe
    assert out["complete"]
    short = [x for x in ours if "joint_hv(" not in x[0]] + [
        (_key("joint_hv"), 0.25)]
    assert not dryrun.shard_routes_in_replay(short, make_keyframe)["complete"]


def test_shard_kernel_names():
    """Each phase kernel's name maps to its route and phase; the
    whole-solver kernels and kernels of no route map to none."""
    from nrslam_tpu_torch.parallel import dryrun

    for route, phases in dryrun.SHARD_KERNELS.items():
        for phase in phases:
            name = {"pose_only_shard": f"{phase}_kernel",
                    "pose_deformation_shard": f"joint_{phase}",
                    "bundle_adjustment_shard": f"ba_{phase}"}[route]
            assert dryrun.shard_kernel_of(_key(name)) == (route, phase)
    for name in ("pose_deformation_kernel", "ba_kernel", "pose_only_kernel"):
        assert dryrun.shard_kernel_of(_key(name)) is None
    assert dryrun.shard_kernel_of("joint_hv(float)") is None  # not ours
