// Joint pose + deformation LM partitioned over the ranks' point blocks:
// phase kernels, each one thread block cluster, whose partial sums are
// all-reduced between launches.
//
// Partitions: nrslam_tpu/solver/pose_deformation_pallas.py::_joint_kernel
// (the whole-solver kernel is csrc/pose_deformation.cu). Same schedule and
// terms as the plain sharded driver (parallel/solve_shard.py,
// pose_deformation_sharded) and the whole-solver kernel: rounds of LM steps
// from the seed with zero flows, each step a block-Jacobi PCG (tolerance
// 1e-8) over one SE(3) twist + per-point 3D flows; reprojection (info_r,
// Huber 5.99), spatial dampers (info_s, Huber 0.584) and springs (info_p,
// Huber 0.584); points and dampers re-level between rounds, springs never.
//
// What bounds it on an H100: the chain of ~445 launches a call, each a few
// dependent global loads deep (an edge-end's record, then the far point's
// vector), not bytes or FLOPs (a call moves < 1 MB and does ~0.2 GFLOP at
// P = 768). Tensor cores, wgmma and TMA have no tile here: the blocks are
// float32 3x3 / 6x6 solves and the walks are gathers, and TF32 would break
// the 1e-5 pose gate.
//
// A rank owns the points [p0, p0 + m) and their edge-ends: positions
// [inc_ptr[p0], inc_ptr[p0 + m]) of the whole incidence CSR (each point's
// live incident edges in edge order). It computes an edge's terms at each
// end it owns, in the edge's (i, j) orientation, so the two ranks of an
// edge that crosses ranks agree bit for bit; an edge's robust chi2 is
// counted at its i end. The wrapper's table gives each CSR position the
// edge's (i, j, far end, sign) and (w, d0, base mask), so an end's walk is
// one load deep before the far point's vector.
//
// Every launch is one cluster of C <= 8 blocks of 256 threads
// (shard_phase.cuh): block b owns whole chunks of the rank's points and
// their edge-ends; within a block the threads spread over the edge-ends
// (end_pass), then one thread a point finishes its point. What every rank
// must hold the same (pose, LM and CG scalars, the pose part of every CG
// vector) every block computes from the reduced sums into its copy of the
// device row st (the 6x6 work by a warp); block 0 writes it to the other
// slot. Per point: the current and the trial linearisation (lin[cur],
// lin[1 - cur]), the block-Jacobi inverses and the CG vectors of the rank's
// points, all structure of arrays; per owned edge-end its (ws, w_p, a) of
// both linearisations and its damper mask; the flows (accepted and trial)
// and the search direction p (two slots, one a CG trip) are whole [P] of
// float4 on every rank, so a neighbour is one 16-byte load. Where a block
// reads what other blocks write in the same launch, a cluster barrier
// orders the two: hv's blocks each form their share of p = z + beta p_old
// (from red and the previous trip's slot) before any block reads a
// neighbour's p, and the trial linearisation's blocks each copy their
// share of the trial flows out of red before any block reads them; the
// accept of an LM step flips `cur` in every block's copy of st. The kernel
// issues few load instructions for that reason: the per-end records are
// float4 too, and the loads an edge-end needs are independent.
//
// Sums go by chunk of kChunk consecutive global points, each chunk's row in
// shard_phase.cuh's fixed order (an edge-end's term, a point's ends in CSR
// order, then its reprojection term, then the chunk's tree over its 64
// point slots) into a buffer that is zero outside the rank's chunks; the
// all_reduce adds the ranks' rows and the next phase adds the rows in chunk
// order. So two calls give the same bits, and where the ranks' blocks are
// whole chunks n ranks give the bits of one process, with any number of
// blocks.
//
// Collectives: `red` [3P + 2 nc] carries this rank's block of a [P, 3]
// vector (z, or the trial flows) zero-filled elsewhere, then two sums a
// chunk; `reds` [28 nc + n] the pose system's 28 sums a chunk (and at a
// round's start each rank's largest flow-block diagonal at its slot, for
// lambda0), or the 7 sums a chunk of a Hessian-vector product. Per LM
// step: start the PCG (z), then per CG trip hv (reds[:7 nc]) and cg (red:
// z, or after the last trip the trial flows), then the trial
// linearisation (reds[:28 nc]).

#include "shard_phase.cuh"

namespace nrslam {
namespace {

using shard::Batch;
using shard::Block;
using shard::kChunk;
using shard::kThreads;
using shard::kTile;

constexpr int kMaxBlocks = 8;
constexpr int kHvTile = 2048;   // edge-ends a tile of hv's end pass holds
constexpr int kBatch = kThreads / kChunk;  // chunks a batch: a thread a point
constexpr float kTh2Dof = 5.99f;
constexpr float kTh3Dof = 0.584f;
constexpr float kSpringK = 1.1f;
constexpr float kLmTau = 1e-5f;
constexpr float kCgTol = 1e-8f;
constexpr int kLinFloats = 28;  // per point: Jp 12, Jf 6, wr, gf 3, D 6
constexpr int kEndTerm = 10;    // an end's share of its point: g 3, D 6, rho
constexpr int kSys = 28;        // 21 upper H_pose, 6 g_pose, chi2
constexpr int kHv = 7;          // 6 pose parts of H p, p.Hp

enum Mode { kStart = 0, kTrial = 1 };
enum Next { kNextCg = 0, kNextRelevel = 1, kNextFinal = 2 };

// The device row st (floats; poses are q [4], t [3]).
enum : int {
  sT0 = 0,      // seed
  sT = 7,       // accepted
  sTn = 14,     // trial
  sH = 21,      // [36] H_pose of lin[cur]
  sG = 57,      // [6]
  sChi2 = 63,
  sLam = 64, sNu = 65, sLmDone = 66, sCur = 67,
  sInfo = 68,   // info_r, info_s, info_p
  sHinv = 71,   // [36] (H_pose + lam I)^-1
  sXp = 107, sRp = 113, sZp = 119, sPp = 125,  // [6] each
  sRz = 131, sB2 = 132, sCgDone = 133,
  sDenomF = 134, sDx2F = 135,  // the trial step's flow partials, reduced
  sWork = 136,  // LM steps, CG trips, linearisations (counts run)
  sFloats = 140
};

struct Ctx {
  const float* cam;      // [8]
  int kind;
  const float4* rest;    // [P] every point (x, y, z, 0)
  const float* pv;       // [P] point mask (TRACKED_WITH_3D)
  const float* obs;      // [m, 2] the rank's points
  const int4* ends;      // [n_ends] i, j, far end, sign (+1 at i) a position
  const float4* econ;    // [n_ends] w, d0 (clamped >= 1e-12), base mask, 0
  const int* inc_ptr;    // [P + 1]
  const int* chunk_off;  // [C + 1] the blocks' chunks
  const float* st_in;    // [sFloats] the launch's input slot of st
  float* st_out;         // the other slot
  float* lin[2];         // [kLinFloats][m]
  float4* es[2];         // [n_ends] (a0, a1, a2, w_p), at the rank's
  float* ws[2];          // [n_ends] ws                     positions
  float* smask;          // [n_ends] damper mask of the round
  float* pmask;          // [m] point mask of the round
  float* minv;           // [9][m]
  float* x;              // [3][m] CG vectors of the rank's points
  float* r;
  float* hp;
  float4* flows[2];      // [P] (x, y, z, 0)
  float4* p[2];          // [P] (x, y, z, 0), one slot a CG trip
  float* red;            // [3P + 2 nc]
  float* reds;           // [28 nc + n]
  float* out_pose;       // [8]
  float* out_flows;      // [P][3]
  int P, m, p0, rank, n, n_ends;
  int nc, g0, g1;        // chunks of P; the rank's first and last chunk
};

// The shared memory of a phase: the end pass's tile (lin's is the larger:
// kEndTerm kTile > 3 kHvTile), then the point slots' contributions to the
// chunk rows [kBatch][kSys][kChunk].
constexpr long kSmemFloats = static_cast<long>(kEndTerm) * kTile
                             + static_cast<long>(kBatch) * kSys * kChunk;

__device__ inline float* tile_of(float4* dyn) {
  return reinterpret_cast<float*>(dyn);
}
__device__ inline float* con_of(float4* dyn) {
  return reinterpret_cast<float*>(dyn) + kEndTerm * kTile;
}

// The rotation and translation of the pose at st[at] into sRt [12].
__device__ inline void pose_rt(const float* sst, int at, float* sRt) {
  if (threadIdx.x == 0) {
    quat_to_matrix(sst + at, sRt);
    for (int d = 0; d < 3; ++d) sRt[9 + d] = sst[at + 4 + d];
  }
  __syncthreads();
}

// One point's reprojection at pose sRt and position rest + f: its camera
// point, the projection Jacobian and the residual; returns chi2_r.
__device__ inline float reproject(const Ctx& c, int p, int lp,
                                  const float* sRt, float4 f, float info_r,
                                  float* Xc, float* J, float* eu, float* ev) {
  const float4 r = __ldg(c.rest + p);
  const float x = r.x + f.x;
  const float y = r.y + f.y;
  const float z = r.z + f.z;
  Xc[0] = sRt[0] * x + sRt[1] * y + sRt[2] * z + sRt[9];
  Xc[1] = sRt[3] * x + sRt[4] * y + sRt[5] * z + sRt[10];
  Xc[2] = sRt[6] * x + sRt[7] * y + sRt[8] * z + sRt[11];
  float pu, pv;
  project_with_jacobian(c.kind, c.cam, Xc[0], Xc[1], Xc[2], &pu, &pv, J);
  *eu = c.obs[2 * lp] - pu;
  *ev = c.obs[2 * lp + 1] - pv;
  return info_r * (*eu * *eu + *ev * *ev);
}

// Point p's flow of F (nullptr: zero). F may have been written by another
// block of this launch before a cluster barrier: the load bypasses L1.
__device__ inline float4 flow_of(const float4* F, int p) {
  return F != nullptr ? __ldcg(F + p) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// What the edge-end at CSR position k reads: its table rows, both points'
// flows of F (nullptr: zero) and rest positions, its damper mask.
struct LinEnd {
  int4 e;
  float4 q, fi, fj, ri, rj;
  float sm;
  int k;
};

__device__ inline LinEnd load_lin_end(const Ctx& c, int k, const float4* F) {
  LinEnd x;
  x.k = k;
  x.e = __ldg(c.ends + k);
  x.q = __ldg(c.econ + k);
  x.fi = flow_of(F, x.e.x);
  x.fj = flow_of(F, x.e.y);
  x.ri = __ldg(c.rest + x.e.x);
  x.rj = __ldg(c.rest + x.e.y);
  x.sm = c.smask[k];
  return x;
}

// The edge-end x: its term [kEndTerm] (its point's share of g, D and the
// robust chi2, counted at the i end) into out[d * kTile], (a, w_p) into
// es4 and ws into ws1. Springs always use the base mask.
__device__ inline void lin_end(const LinEnd& x, float info_s, float info_p,
                               float4* es4, float* ws1, float* out) {
  const bool iend = x.e.w > 0;
  const float sm = x.sm;
  const float df0 = x.fi.x - x.fj.x, df1 = x.fi.y - x.fj.y,
              df2 = x.fi.z - x.fj.z;
  const float w = x.q.x, d0 = x.q.y, pm = x.q.z;
  const float chi2_s = info_s * (w * w) * (df0 * df0 + df1 * df1 + df2 * df2);
  const float w_s = info_s * huber_w(chi2_s, kTh3Dof) * sm;
  const float diff0 = (x.ri.x - x.rj.x) + df0;
  const float diff1 = (x.ri.y - x.rj.y) + df1;
  const float diff2 = (x.ri.z - x.rj.z) + df2;
  const float dist = sqrtf(diff0 * diff0 + diff1 * diff1 + diff2 * diff2);
  const float e_p = kSpringK * (dist - d0) / d0;
  const float chi2_p = info_p * e_p * e_p;
  const float w_p = info_p * huber_w(chi2_p, kTh3Dof) * pm;
  const float ws = w * w * w_s;
  const float kd = kSpringK / d0;
  const float inv_dist = 1.0f / fmaxf(dist, 1e-12f);
  const float a0 = kd * diff0 * inv_dist;
  const float a1 = kd * diff1 * inv_dist;
  const float a2 = kd * diff2 * inv_dist;
  const float wpe = w_p * e_p;
  const float sg = iend ? 1.0f : -1.0f;
  out[0] = sg * (ws * df0 + wpe * a0);
  out[kTile] = sg * (ws * df1 + wpe * a1);
  out[2 * kTile] = sg * (ws * df2 + wpe * a2);
  out[3 * kTile] = ws + w_p * a0 * a0;
  out[4 * kTile] = w_p * a0 * a1;
  out[5 * kTile] = w_p * a0 * a2;
  out[6 * kTile] = ws + w_p * a1 * a1;
  out[7 * kTile] = w_p * a1 * a2;
  out[8 * kTile] = ws + w_p * a2 * a2;
  out[9 * kTile] = iend ? huber_rho(chi2_s, kTh3Dof) * sm
                              + huber_rho(chi2_p, kTh3Dof) * pm
                        : 0.0f;
  es4[x.k] = make_float4(a0, a1, a2, w_p);
  ws1[x.k] = ws;
}

// The point of local index lp at pose sRt and flows F (nullptr: zero), its
// edge-ends' summed terms acc [kEndTerm]: its linearisation into L and its
// contributions to the 28 sums at con[col * kChunk]; returns its flow
// block's largest diagonal.
__device__ inline float lin_point(const Ctx& c, int lp, const float* sRt,
                                  const float4* F, float info_r,
                                  const float (&acc)[kEndTerm], float* L,
                                  float* con) {
  const int p = c.p0 + lp;
  float Xc[3], J[6], eu, ev;
  const float chi2_r = reproject(c, p, lp, sRt, flow_of(F, p), info_r, Xc,
                                 J, &eu, &ev);
  const float mk = c.pmask[lp];
  float Ju[6], Jv[6], Jfu[3], Jfv[3], w_r = 0.0f, rho = acc[9];
  if (mk != 0.0f) {
    w_r = info_r * huber_w(chi2_r, kTh2Dof) * mk;
    pose_jacobian(J, Xc[0], Xc[1], Xc[2], Ju, Jv);
    for (int d = 0; d < 3; ++d) {
      Jfu[d] = -(J[0] * sRt[d] + J[1] * sRt[3 + d] + J[2] * sRt[6 + d]);
      Jfv[d] = -(J[3] * sRt[d] + J[4] * sRt[3 + d] + J[5] * sRt[6 + d]);
    }
    rho += huber_rho(chi2_r, kTh2Dof) * mk;
  } else {
    for (int d = 0; d < 6; ++d) Ju[d] = Jv[d] = 0.0f;
    for (int d = 0; d < 3; ++d) Jfu[d] = Jfv[d] = 0.0f;
  }
  const long s = c.m;
  for (int d = 0; d < 6; ++d) {
    L[d * s + lp] = Ju[d];
    L[(6 + d) * s + lp] = Jv[d];
  }
  for (int d = 0; d < 3; ++d) {
    L[(12 + d) * s + lp] = Jfu[d];
    L[(15 + d) * s + lp] = Jfv[d];
  }
  L[18 * s + lp] = w_r;
  for (int d = 0; d < 3; ++d)
    L[(19 + d) * s + lp] = w_r * (Jfu[d] * eu + Jfv[d] * ev) + acc[d];
  const int ia[6] = {0, 0, 0, 1, 1, 2}, ib[6] = {0, 1, 2, 1, 2, 2};
  float D[6];
  for (int d = 0; d < 6; ++d) {
    D[d] = w_r * (Jfu[ia[d]] * Jfu[ib[d]] + Jfv[ia[d]] * Jfv[ib[d]])
           + acc[3 + d];
    L[(22 + d) * s + lp] = D[d];
  }
  int n = 0;
  for (int a = 0; a < 6; ++a)
    for (int b = a; b < 6; ++b)
      con[(n++) * kChunk] = w_r * (Ju[a] * Ju[b] + Jv[a] * Jv[b]);
  for (int a = 0; a < 6; ++a)
    con[(21 + a) * kChunk] = w_r * (Ju[a] * eu + Jv[a] * ev);
  con[27 * kChunk] = rho;
  return fmaxf(D[0], fmaxf(D[3], D[5]));
}

// The call's start: the seed pose and infos from params (cam 8, q 4, t 3,
// info_r, info_s, info_p) into st, the first round's point mask (pv of the
// rank's points) and damper mask (the base mask at each owned end).
__global__ void __launch_bounds__(kThreads, 1)
joint_init(Ctx c) {
  const Block B = shard::block_of(c.chunk_off);
  const int tid = threadIdx.x;
  if (B.b == 0)
    for (int k = tid; k < sFloats; k += kThreads)
      c.st_out[k] = k < sT0 + 7 ? c.cam[8 + k]
                    : (k >= sInfo && k < sInfo + 3 ? c.cam[15 + k - sInfo]
                                                   : 0.0f);
  const int a = max(c.p0, kChunk * B.g_lo);
  const int b = min(c.p0 + c.m, kChunk * B.g_hi);
  for (int p = a + tid; p < b; p += kThreads) c.pmask[p - c.p0] = c.pv[p];
  for (int k = c.inc_ptr[a] + tid; k < c.inc_ptr[b]; k += kThreads)
    c.smask[k] = c.econ[k].z;
}

// kStart: the round's first linearisation at the seed with zero flows into
// lin[cur], its sums by chunk into reds [nc][28] and the rank's largest
// flow-block diagonal at slot rank of a zero-filled [n] after them.
// kTrial: the trial flows (red, whole after the trial step's collective)
// copied into flows[1 - cur] (each block its share, then a cluster
// barrier), the step's flow partials summed into st, then the
// linearisation at the trial pose and flows into lin[1 - cur] and its sums
// into reds [nc][28].
__global__ void __launch_bounds__(kThreads, 1)
joint_lin(Ctx c, int mode) {
  extern __shared__ float4 dyn[];
  __shared__ float sst[sFloats];
  __shared__ float sRt[12];
  __shared__ float col[2];
  __shared__ Reducer<1> R;
  float* tile = tile_of(dyn);
  float* con = con_of(dyn);
  const Block B = shard::block_of(c.chunk_off);
  // The first batch's CSR ranges need no scalar of st: loaded before the
  // first barrier.
  Batch t = shard::batch_of(B.g_lo, min(B.g_hi, B.g_lo + kBatch), c.p0,
                            c.m);
  shard::Ends<1> r = shard::ends_of<1>(c.inc_ptr, 1, t);
  shard::load_row<sFloats>(c.st_in, sst, c.red + 3L * c.P, c.nc, 2,
                           mode == kTrial ? 2 : 0, col);
  const int tid = threadIdx.x;
  const int cur = sst[sCur] != 0.0f ? 1 : 0;
  const int tgt = mode == kStart ? cur : 1 - cur;
  const float4* F = mode == kStart ? nullptr : c.flows[tgt];
  const float info_r = sst[sInfo], info_s = sst[sInfo + 1],
              info_p = sst[sInfo + 2];
  {
    long lo, hi;
    shard::share(c.P, B, &lo, &hi);
    for (long k = lo + tid; k < hi; k += kThreads)
      c.flows[tgt][k] = mode == kStart
          ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
          : make_float4(c.red[3 * k], c.red[3 * k + 1], c.red[3 * k + 2],
                        0.0f);
  }
  if (mode == kTrial) cg::this_cluster().sync();  // every block's share
  pose_rt(sst, mode == kStart ? sT0 : sTn, sRt);
  __syncthreads();  // every thread read st before it changes below
  if (mode == kTrial && tid < 2) sst[sDenomF + tid] = col[tid];
  if (tid == 0) sst[sWork + 2] += 1.0f;
  float dmax = -INFINITY;
  float4* es4 = c.es[tgt];
  float* ws1 = c.ws[tgt];
  for (int gb = B.g_lo; gb < B.g_hi; gb += kBatch) {
    if (gb != B.g_lo) {
      t = shard::batch_of(gb, min(B.g_hi, gb + kBatch), c.p0, c.m);
      r = shard::ends_of<1>(c.inc_ptr, 1, t);
    }
    float acc[1][kEndTerm];
    shard::end_pass<kEndTerm, 1, kTile>(
        r, 1, tile, [&](int k, int) { return load_lin_end(c, k, F); },
        [&](const LinEnd& x, float* out) {
          lin_end(x, info_s, info_p, es4, ws1, out);
        },
        acc);
    const int p = kChunk * gb + tid;
    if (tid < kChunk * (t.ge - t.gb)) {
      float* mine = con + (tid >> 6) * kSys * kChunk + (tid & 63);
      if (p >= t.pa && p < t.pb) {
        dmax = fmaxf(dmax, lin_point(c, p - c.p0, sRt, F, info_r, acc[0],
                                     c.lin[tgt], mine));
      } else {
        for (int k = 0; k < kSys; ++k) mine[k * kChunk] = 0.0f;
      }
    }
    __syncthreads();
    shard::chunk_rows(con, t.ge - t.gb, kSys, c.reds, t.gb, kSys);
    __syncthreads();
  }
  shard::zero_rows(c.reds, c.nc, kSys, c.g0, c.g1, B);
  if (mode == kStart) {
    int slot = 0;
    dmax = cluster_max(R, dmax, slot);
    if (B.b == 0)
      for (int q = tid; q < c.n; q += kThreads)
        c.reds[static_cast<long>(kSys) * c.nc + q] = q == c.rank ? dmax : 0.0f;
    cg::this_cluster().sync();  // no block leaves while others read its smem
  }
  shard::store_row(c.st_out, sst, sFloats, B);
}

// The pose part of starting a PCG, by warp 0: Hinv = (H + lam I)^-1, x = 0,
// r = -g, z = Hinv r, into the block's copy of st.
__device__ inline void pcg_start_pose(float* sst, float lam) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  if (lane == 0) inv6(sst + sH, lam, sst + sHinv);
  __syncwarp();
  if (lane < 6) {
    float s = 0.0f;
    for (int j = 0; j < 6; ++j) s += sst[sHinv + lane * 6 + j] * (-sst[sG + j]);
    sst[sZp + lane] = s;
    sst[sXp + lane] = 0.0f;
  }
  __syncwarp();
  if (lane < 6) sst[sRp + lane] = -sst[sG + lane];
}

// finish 0: reds holds a round's first linearisation (kStart): the LM
// state of the round (lambda0 from the largest diagonal). finish 1: reds
// holds the trial's: gain ratio, lambda / nu, accept (flip cur), done.
// Then `next`: start the PCG of the next LM step (z of the rank's points
// into red, zero elsewhere, with the r.z and r.r partials by chunk); or
// re-level the round's masks at the accepted state; or the final
// linearisation (each point's chi2 into red, the outputs).
__global__ void __launch_bounds__(kThreads, 1)
joint_step(Ctx c, int finish, int next) {
  extern __shared__ float4 dyn[];
  __shared__ float sst[sFloats];
  __shared__ float col[kSys];
  __shared__ float sRt[12];
  float* con = con_of(dyn);
  const Block B = shard::block_of(c.chunk_off);
  shard::load_row<sFloats>(c.st_in, sst, c.reds, c.nc, kSys, kSys, col);
  const int tid = threadIdx.x;
  if (tid == 0) {
    float* st = sst;
    float H[36], g[6];
    int k = 0;
    for (int a = 0; a < 6; ++a)
      for (int b = a; b < 6; ++b, ++k) {
        H[a * 6 + b] = col[k];
        H[b * 6 + a] = col[k];
      }
    for (int a = 0; a < 6; ++a) g[a] = col[21 + a];
    const float chi2 = col[27];
    if (finish == 0) {
      for (int u = 0; u < 36; ++u) st[sH + u] = H[u];
      for (int u = 0; u < 6; ++u) st[sG + u] = g[u];
      st[sChi2] = chi2;
      float dmax = -INFINITY;
      for (int a = 0; a < 6; ++a) dmax = fmaxf(dmax, H[a * 6 + a]);
      for (int r = 0; r < c.n; ++r)
        dmax = fmaxf(dmax, c.reds[static_cast<long>(kSys) * c.nc + r]);
      st[sLam] = kLmTau * dmax;
      st[sNu] = 2.0f;
      st[sLmDone] = 0.0f;
      for (int u = 0; u < 7; ++u) st[sT + u] = st[sT0 + u];
    } else {
      const float lam = st[sLam], nu = st[sNu];
      float denom = st[sDenomF], dx2 = st[sDx2F];
      for (int d = 0; d < 6; ++d) {
        const float xd = st[sXp + d];
        denom += xd * (lam * xd - st[sG + d]);
        dx2 += xd * xd;
      }
      const float rho = (st[sChi2] - chi2)
                        / (fabsf(denom) > 0.0f ? denom : 1.0f);
      const bool accepted = rho > 0.0f;
      const float c3 = 2.0f * rho - 1.0f;
      const float shrink = fmaxf(1.0f / 3.0f, 1.0f - c3 * c3 * c3);
      if (st[sLmDone] == 0.0f) {
        st[sLam] = accepted ? lam * shrink : lam * nu;
        st[sNu] = accepted ? 2.0f : nu * 2.0f;
        st[sWork] += 1.0f;
        if (accepted) {
          for (int u = 0; u < 7; ++u) st[sT + u] = st[sTn + u];
          for (int u = 0; u < 36; ++u) st[sH + u] = H[u];
          for (int u = 0; u < 6; ++u) st[sG + u] = g[u];
          st[sChi2] = chi2;
          st[sCur] = st[sCur] != 0.0f ? 0.0f : 1.0f;
          if (dx2 < 1e-12f) st[sLmDone] = 1.0f;
        }
      }
    }
  }
  __syncthreads();
  const int cur = sst[sCur] != 0.0f ? 1 : 0;
  const float4* F = c.flows[cur];
  const int a = max(c.p0, kChunk * B.g_lo);
  const int b = min(c.p0 + c.m, kChunk * B.g_hi);
  if (next == kNextRelevel || next == kNextFinal) {
    if (tid == 0) sst[sWork + 2] += 1.0f;
    pose_rt(sst, sT, sRt);
    const float info_r = sst[sInfo], info_s = sst[sInfo + 1];
    for (int p = a + tid; p < b; p += kThreads) {
      float Xc[3], J[6], eu, ev;
      const float chi2_r = reproject(c, p, p - c.p0, sRt, flow_of(F, p),
                                     info_r, Xc, J, &eu, &ev);
      if (next == kNextRelevel)
        c.pmask[p - c.p0] = chi2_r <= kTh2Dof ? c.pv[p] : 0.0f;
      else
        c.red[p] = chi2_r;
    }
    if (next == kNextRelevel) {
      for (int k = c.inc_ptr[a] + tid; k < c.inc_ptr[b]; k += kThreads) {
        const int4 e = __ldg(c.ends + k);
        const float4 q = __ldg(c.econ + k);
        const float4 fi = flow_of(F, e.x), fj = flow_of(F, e.y);
        const float df0 = fi.x - fj.x, df1 = fi.y - fj.y, df2 = fi.z - fj.z;
        const float chi2_s =
            info_s * (q.x * q.x) * (df0 * df0 + df1 * df1 + df2 * df2);
        c.smask[k] = chi2_s <= kTh3Dof ? q.z : 0.0f;
      }
    } else {
      shard::zero_outside(c.red, c.P, c.p0, c.p0 + c.m, B);
      long lo, hi;
      shard::share(c.P, B, &lo, &hi);
      for (long k = lo + tid; k < hi; k += kThreads) {
        const float4 f = F[k];
        c.out_flows[3 * k] = f.x;
        c.out_flows[3 * k + 1] = f.y;
        c.out_flows[3 * k + 2] = f.z;
      }
      if (B.b == 0 && tid == 0) {
        const float* q = sst + sT;
        const float nq = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2]
                               + q[3] * q[3]);
        for (int k = 0; k < 4; ++k) c.out_pose[k] = q[k] / nq;
        for (int k = 0; k < 3; ++k) c.out_pose[4 + k] = sst[sT + 4 + k];
        c.out_pose[7] = 0.0f;
      }
    }
    shard::store_row(c.st_out, sst, sFloats, B);
    return;
  }

  // Start the PCG: x = 0, r = -g, z = M^-1 r, at the current lambda.
  const float lam = sst[sLam];
  pcg_start_pose(sst, lam);
  const float* L = c.lin[cur];
  const long s = c.m;
  float* rows = c.red + 3L * c.P;
  for (int gb = B.g_lo; gb < B.g_hi; gb += kBatch) {
    const Batch t = shard::batch_of(gb, min(B.g_hi, gb + kBatch), c.p0, c.m);
    const int p = kChunk * gb + tid;
    if (tid < kChunk * (t.ge - t.gb)) {
      float* mine = con + (tid >> 6) * 2 * kChunk + (tid & 63);
      float rz = 0.0f, rr = 0.0f;
      if (p >= t.pa && p < t.pb) {
        const int lp = p - c.p0;
        const float* D = L + 22 * s + lp;
        const float m9[9] = {D[0] + lam, D[s], D[2 * s], D[s], D[3 * s] + lam,
                             D[4 * s], D[2 * s], D[4 * s], D[5 * s] + lam};
        float mi[9];
        inv3(m9, mi);
        for (int u = 0; u < 9; ++u) c.minv[u * s + lp] = mi[u];
        float r[3], z[3];
        for (int d = 0; d < 3; ++d) {
          r[d] = -L[(19 + d) * s + lp];
          c.x[d * s + lp] = 0.0f;
          c.r[d * s + lp] = r[d];
        }
        for (int i = 0; i < 3; ++i)
          z[i] = mi[3 * i] * r[0] + mi[3 * i + 1] * r[1] + mi[3 * i + 2] * r[2];
        for (int d = 0; d < 3; ++d) {
          c.red[3 * p + d] = z[d];
          rz += r[d] * z[d];
          rr += r[d] * r[d];
        }
      }
      mine[0] = rz;
      mine[kChunk] = rr;
    }
    __syncthreads();
    shard::chunk_rows(con, t.ge - t.gb, 2, rows, t.gb, 2);
    __syncthreads();
  }
  shard::zero_outside(c.red, 3L * c.P, 3L * c.p0, 3L * (c.p0 + c.m), B);
  shard::zero_rows(rows, c.nc, 2, c.g0, c.g1, B);
  shard::store_row(c.st_out, sst, sFloats, B);
}

// What hv's end pass reads of an edge-end: both points' p, its record.
struct HvEnd {
  float4 pi, pj, q;
  float ws, sg;
};

// One CG trip's first half: from red (z whole and the r.z, r.r partials by
// chunk, reduced) every block forms the pose part of p = z + beta p and
// its share of p over all P (into slot `slot`, from the previous trip's
// slot), then a cluster barrier; then H p of the block's points
// (reprojection and its edge-ends' damper and spring terms, + lambda p)
// and the 7 partials (pose part of H p, p.Hp) by chunk into reds [nc][7].
__global__ void __launch_bounds__(kThreads, 1)
joint_hv(Ctx c, int first, int slot) {
  extern __shared__ float4 dyn[];
  __shared__ float sst[sFloats];
  __shared__ float col[2];
  float* tile = tile_of(dyn);
  float* con = con_of(dyn);
  const Block B = shard::block_of(c.chunk_off);
  const int tid = threadIdx.x;
  // Loads that need no scalar of st, before the first barrier: the first
  // batch's CSR ranges and the first element of this thread's share of p.
  Batch t = shard::batch_of(B.g_lo, min(B.g_hi, B.g_lo + kBatch), c.p0,
                            c.m);
  shard::Ends<1> r = shard::ends_of<1>(c.inc_ptr, 1, t);
  const float4* pold = c.p[slot ^ 1];
  float4* pnew = c.p[slot];
  long lo, hi;
  shard::share(c.P, B, &lo, &hi);
  const long k0 = lo + tid;
  float z0 = 0.0f, z1 = 0.0f, z2 = 0.0f;
  float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (k0 < hi) {
    z0 = c.red[3 * k0];
    z1 = c.red[3 * k0 + 1];
    z2 = c.red[3 * k0 + 2];
    if (!first) o = pold[k0];
  }
  shard::load_row<sFloats>(c.st_in, sst, c.red + 3L * c.P, c.nc, 2, 2,
                           col);
  float rz_new = col[0], rr = col[1];
  for (int d = 0; d < 6; ++d) {
    rz_new += sst[sRp + d] * sst[sZp + d];
    rr += sst[sRp + d] * sst[sRp + d];
  }
  const float rz = sst[sRz];
  const float beta = first ? 0.0f : (fabsf(rz) > 0.0f ? rz_new / rz : 0.0f);
  for (long k = k0; k < hi; k += kThreads) {
    if (k != k0) {
      z0 = c.red[3 * k];
      z1 = c.red[3 * k + 1];
      z2 = c.red[3 * k + 2];
      if (!first) o = pold[k];
    }
    pnew[k] = first ? make_float4(z0, z1, z2, 0.0f)
                    : make_float4(fmaf(beta, o.x, z0), fmaf(beta, o.y, z1),
                                  fmaf(beta, o.z, z2), 0.0f);
  }
  __syncthreads();  // every thread read st's rz before it changes
  if (tid < 6)
    sst[sPp + tid] = first ? sst[sZp + tid]
                           : sst[sZp + tid] + beta * sst[sPp + tid];
  if (tid == 0) {
    if (first) {
      sst[sRz] = rz_new;
      sst[sB2] = rr;
      sst[sCgDone] = 0.0f;
    } else {
      const bool done =
          sst[sCgDone] != 0.0f || rr <= kCgTol * kCgTol * sst[sB2];
      sst[sCgDone] = done ? 1.0f : 0.0f;
      if (!done) sst[sRz] = rz_new;
    }
    sst[sWork + 1] += 1.0f;
  }
  __syncthreads();
  const float lam = sst[sLam];
  float pp[6];
  for (int d = 0; d < 6; ++d) pp[d] = sst[sPp + d];
  const int cur = sst[sCur] != 0.0f ? 1 : 0;
  const float* L = c.lin[cur];
  const float4* E4 = c.es[cur];
  const float* E1 = c.ws[cur];
  const long s = c.m;
  cg::this_cluster().sync();  // every block's share of p written
  for (int gb = B.g_lo; gb < B.g_hi; gb += kBatch) {
    if (gb != B.g_lo) {
      t = shard::batch_of(gb, min(B.g_hi, gb + kBatch), c.p0, c.m);
      r = shard::ends_of<1>(c.inc_ptr, 1, t);
    }
    float acc[1][3];
    shard::end_pass<3, 1, kHvTile>(
        r, 1, tile,
        [&](int k, int) {
          const int4 e = __ldg(c.ends + k);
          HvEnd x;
          x.pi = __ldcg(pnew + e.x);
          x.pj = __ldcg(pnew + e.y);
          x.q = __ldg(E4 + k);
          x.ws = __ldg(E1 + k);
          x.sg = e.w > 0 ? 1.0f : -1.0f;
          return x;
        },
        [&](const HvEnd& x, float* out) {
          const float dv0 = x.pi.x - x.pj.x, dv1 = x.pi.y - x.pj.y,
                      dv2 = x.pi.z - x.pj.z;
          const float ws = x.ws, wp = x.q.w;
          const float a0 = x.q.x, a1 = x.q.y, a2 = x.q.z;
          const float wad = wp * (a0 * dv0 + a1 * dv1 + a2 * dv2);
          const float sg = x.sg;
          out[0] = sg * (ws * dv0 + wad * a0);
          out[kHvTile] = sg * (ws * dv1 + wad * a1);
          out[2 * kHvTile] = sg * (ws * dv2 + wad * a2);
        },
        acc);
    const int p = kChunk * gb + tid;
    if (tid < kChunk * (t.ge - t.gb)) {
      float* mine = con + (tid >> 6) * kHv * kChunk + (tid & 63);
      float part[kHv] = {0, 0, 0, 0, 0, 0, 0};
      if (p >= t.pa && p < t.pb) {
        const int lp = p - c.p0;
        const float4 p4 = __ldcg(pnew + p);
        const float pf[3] = {p4.x, p4.y, p4.z};
        float ru = L[12 * s + lp] * pf[0] + L[13 * s + lp] * pf[1]
                   + L[14 * s + lp] * pf[2];
        float rv = L[15 * s + lp] * pf[0] + L[16 * s + lp] * pf[1]
                   + L[17 * s + lp] * pf[2];
        for (int d = 0; d < 6; ++d) {
          ru += L[d * s + lp] * pp[d];
          rv += L[(6 + d) * s + lp] * pp[d];
        }
        const float w = L[18 * s + lp];
        for (int d = 0; d < 3; ++d) {
          const float hd = w * (L[(12 + d) * s + lp] * ru
                                + L[(15 + d) * s + lp] * rv)
                           + acc[0][d] + lam * pf[d];
          c.hp[d * s + lp] = hd;
          part[6] += pf[d] * hd;
        }
        for (int d = 0; d < 6; ++d)
          part[d] = w * (L[d * s + lp] * ru + L[(6 + d) * s + lp] * rv);
      }
      for (int k = 0; k < kHv; ++k) mine[k * kChunk] = part[k];
    }
    __syncthreads();
    shard::chunk_rows(con, t.ge - t.gb, kHv, c.reds, t.gb, kHv);
    __syncthreads();
  }
  shard::zero_rows(c.reds, c.nc, kHv, c.g0, c.g1, B);
  shard::store_row(c.st_out, sst, sFloats, B);
}

// A point's CG state as cg reads it.
struct CgPoint {
  float x[3], r[3], hp[3], mi[9];
  float4 p;
};

__device__ inline void load_cg(const Ctx& c, const float4* pv, int p,
                               CgPoint& q) {
  const long s = c.m, lp = p - c.p0;
  for (int d = 0; d < 3; ++d) {
    q.x[d] = c.x[d * s + lp];
    q.r[d] = c.r[d * s + lp];
    q.hp[d] = c.hp[d * s + lp];
  }
  for (int u = 0; u < 9; ++u) q.mi[u] = c.minv[u * s + lp];
  q.p = pv[p];
}

// One CG trip's second half: alpha from reds [nc][7] (reduced, summed in
// chunk order), x, r, z of the pose part (warp 0, into st) and of the
// rank's points; then z of the rank's points into red with the r.z, r.r
// partials by chunk, or after the last trip the trial step: the trial
// pose, the trial flows of the rank's points into red with the gain
// ratio's flow partials x.(lam x - g) and x.x by chunk.
__global__ void __launch_bounds__(kThreads, 1)
joint_cg(Ctx c, int last, int slot) {
  extern __shared__ float4 dyn[];
  __shared__ float sst[sFloats];
  __shared__ float col[kHv];
  __shared__ float srv[6];
  float* con = con_of(dyn);
  const Block B = shard::block_of(c.chunk_off);
  const int tid = threadIdx.x;
  // The first batch's point state needs no scalar of st: loaded before the
  // first barrier.
  const float4* pv = c.p[slot];
  Batch t = shard::batch_of(B.g_lo, min(B.g_hi, B.g_lo + kBatch), c.p0,
                            c.m);
  CgPoint q;
  int p = kChunk * t.gb + tid;
  bool on = tid < kChunk * (t.ge - t.gb) && p >= t.pa && p < t.pb;
  if (on) load_cg(c, pv, p, q);
  shard::load_row<sFloats>(c.st_in, sst, c.reds, c.nc, kHv, kHv, col);
  const float lam = sst[sLam];
  float denom = 0.0f;
  for (int d = 0; d < 6; ++d)
    denom += sst[sPp + d] * (col[d] + lam * sst[sPp + d]);
  denom += col[6];
  const float alpha = sst[sCgDone] != 0.0f ? 0.0f
                      : (fabsf(denom) > 0.0f ? sst[sRz] / denom : 0.0f);
  __syncthreads();  // every thread read st before warp 0 changes it
  if (tid < 6) {
    const float hpp = col[tid] + lam * sst[sPp + tid];
    sst[sXp + tid] += alpha * sst[sPp + tid];
    srv[tid] = sst[sRp + tid] - alpha * hpp;
  }
  __syncthreads();
  if (tid < 6) {
    float z = 0.0f;
    for (int j = 0; j < 6; ++j) z += sst[sHinv + tid * 6 + j] * srv[j];
    sst[sZp + tid] = z;
    sst[sRp + tid] = srv[tid];
  }
  __syncthreads();
  if (last && tid == 0)
    se3_retract(sst + sT, sst + sT + 4, sst + sXp, sst + sTn, sst + sTn + 4);
  const int cur = sst[sCur] != 0.0f ? 1 : 0;
  const float* L = c.lin[cur];
  const float4* F = c.flows[cur];
  const long s = c.m;
  float* rows = c.red + 3L * c.P;
  for (int gb = B.g_lo; gb < B.g_hi; gb += kBatch) {
    if (gb != B.g_lo) {
      t = shard::batch_of(gb, min(B.g_hi, gb + kBatch), c.p0, c.m);
      p = kChunk * gb + tid;
      on = tid < kChunk * (t.ge - t.gb) && p >= t.pa && p < t.pb;
      if (on) load_cg(c, pv, p, q);
    }
    if (tid < kChunk * (t.ge - t.gb)) {
      float* mine = con + (tid >> 6) * 2 * kChunk + (tid & 63);
      float s0 = 0.0f, s1 = 0.0f;
      if (on) {
        const int lp = p - c.p0;
        const float pp3[3] = {q.p.x, q.p.y, q.p.z};
        float r[3];
        for (int d = 0; d < 3; ++d) {
          c.x[d * s + lp] = q.x[d] + alpha * pp3[d];
          r[d] = q.r[d] - alpha * q.hp[d];
          c.r[d * s + lp] = r[d];
        }
        if (!last) {
          float z[3];
          for (int i = 0; i < 3; ++i)
            z[i] = q.mi[3 * i] * r[0] + q.mi[3 * i + 1] * r[1]
                   + q.mi[3 * i + 2] * r[2];
          for (int d = 0; d < 3; ++d) {
            c.red[3 * p + d] = z[d];
            s0 += r[d] * z[d];
            s1 += r[d] * r[d];
          }
        } else {
          const float4 f4 = F[p];
          const float f3[3] = {f4.x, f4.y, f4.z};
          for (int d = 0; d < 3; ++d) {
            const float dx = q.x[d] + alpha * pp3[d];
            c.red[3 * p + d] = f3[d] + dx;
            s0 += dx * (lam * dx - L[(19 + d) * s + lp]);
            s1 += dx * dx;
          }
        }
      }
      mine[0] = s0;
      mine[kChunk] = s1;
    }
    __syncthreads();
    shard::chunk_rows(con, t.ge - t.gb, 2, rows, t.gb, 2);
    __syncthreads();
  }
  shard::zero_outside(c.red, 3L * c.P, 3L * c.p0, 3L * (c.p0 + c.m), B);
  shard::zero_rows(rows, c.nc, 2, c.g0, c.g1, B);
  shard::store_row(c.st_out, sst, sFloats, B);
}

}  // namespace
}  // namespace nrslam

namespace {

// The scratch of a call, in floats: st (two slots), then the per-point and
// per-end state, the whole flows (2) and p (2), red and reds; each part's
// offset.
struct Carve {
  long st, lin0, lin1, es0, es1, ws0, ws1, smask, pmask, minv, x, r, hp, f0,
      f1, p0, p1, red, reds, total;
};

Carve carve(int m, int P, int n_ends, int n) {
  Carve o;
  long at = 0;
  // Every part 16-byte aligned (the float4 parts need it).
  auto take = [&at](long size) {
    const long here = nrslam::pad4(at);
    at = here + size;
    return here;
  };
  const long M = m, K = n_ends;
  o.st = take(2L * nrslam::sFloats);
  o.lin0 = take(nrslam::kLinFloats * M);
  o.lin1 = take(nrslam::kLinFloats * M);
  o.es0 = take(4 * K);
  o.es1 = take(4 * K);
  o.ws0 = take(K);
  o.ws1 = take(K);
  o.smask = take(K);
  o.pmask = take(M);
  o.minv = take(9 * M);
  o.x = take(3 * M);
  o.r = take(3 * M);
  o.hp = take(3 * M);
  o.f0 = take(4L * P);
  o.f1 = take(4L * P);
  o.p0 = take(4L * P);
  o.p1 = take(4L * P);
  const long nc = (P + nrslam::kChunk - 1) / nrslam::kChunk;
  o.red = take(3L * P + 2 * nc);
  o.reds = take(28 * nc + n);
  o.total = at;
  return o;
}

}  // namespace

// The scratch of a call for m points of P, n_ends CSR positions and n
// ranks, in floats: out = (total, offset of red [3P + 2 nc], offset of
// reds [28 nc + n], offset of st's first slot, floats a slot (the second
// follows), offset of the work counters in a slot (LM steps, CG trips,
// linearisations), points a chunk of the partial sums covers, most blocks
// a phase's cluster takes), nc = ceil(P / chunk).
extern "C" int nrslam_joint_shard_layout(int m, int P, int n_ends, int n,
                                         long* out) {
  const Carve o = carve(m, P, n_ends, n);
  out[0] = o.total;
  out[1] = o.red;
  out[2] = o.reds;
  out[3] = o.st;
  out[4] = nrslam::sFloats;
  out[5] = nrslam::sWork;
  out[6] = nrslam::kChunk;
  out[7] = nrslam::kMaxBlocks;
  return 0;
}

// C entry point of every phase. Pointers are device pointers: params (cam
// 8, pinhole using 4; seed q 4, t 3; info_r, info_s, info_p), rest [P, 4]
// (x, y, z, 0) and pv [P] of every point, obs [m, 2] of the rank's points
// [p0, p0 + m), the per-end table ends (int4: i, j, far end, sign) and
// econ (float4: w, d0 clamped >= 1e-12, base mask, 0) [n_ends] at every
// position of the whole incidence CSR inc_ptr [P + 1], chunk_off [C + 1] (block b of the
// cluster owns the rank's chunks [chunk_off[b], chunk_off[b + 1])); scratch
// (nrslam_joint_shard_layout floats, zeroed before the first phase);
// outputs out_pose [8] (q normalised, t) and out_flows [P, 3], written by
// the final step. slot: the launch's index in the call, mod 2 (it reads
// st's slot `slot`, writes the other). phase: 0 joint_init, 1
// joint_lin(arg), 2 joint_step(arg >> 2, arg & 3), 3 joint_hv(arg & 1, arg
// >> 1), 4 joint_cg(arg & 1, arg >> 1) (arg >> 1: the CG trip's p slot).
// Returns cudaErrorInvalidValue for sizes it cannot run,
// cudaErrorInvalidConfiguration when the card cannot hold the cluster, else
// cudaGetLastError() after the launch.
extern "C" int nrslam_joint_shard(
    int phase, int arg, int slot, int C, const void* params, int kind,
    const void* rest, const void* pv, const void* obs, const void* ends,
    const void* econ, const void* inc_ptr, const void* chunk_off,
    void* scratch, void* out_pose, void* out_flows, int P, int m, int p0,
    int n_ends, int rank, int n, void* stream) {
  if (P < 1 || m < 1 || p0 < 0 || p0 + m > P || n < 1 || rank < 0 ||
      rank >= n || C < 1 || C > nrslam::kMaxBlocks || (slot & ~1) != 0 ||
      (kind != nrslam::kPinhole && kind != nrslam::kKB8))
    return static_cast<int>(cudaErrorInvalidValue);
  const Carve o = carve(m, P, n_ends, n);
  float* s = static_cast<float*>(scratch);
  nrslam::Ctx c;
  c.cam = static_cast<const float*>(params);
  c.kind = kind;
  c.rest = static_cast<const float4*>(rest);
  c.pv = static_cast<const float*>(pv);
  c.obs = static_cast<const float*>(obs);
  c.ends = static_cast<const int4*>(ends);
  c.econ = static_cast<const float4*>(econ);
  c.inc_ptr = static_cast<const int*>(inc_ptr);
  c.chunk_off = static_cast<const int*>(chunk_off);
  c.st_in = s + o.st + slot * nrslam::sFloats;
  c.st_out = s + o.st + (slot ^ 1) * nrslam::sFloats;
  c.lin[0] = s + o.lin0;
  c.lin[1] = s + o.lin1;
  c.es[0] = reinterpret_cast<float4*>(s + o.es0);
  c.es[1] = reinterpret_cast<float4*>(s + o.es1);
  c.ws[0] = s + o.ws0;
  c.ws[1] = s + o.ws1;
  c.smask = s + o.smask;
  c.pmask = s + o.pmask;
  c.minv = s + o.minv;
  c.x = s + o.x;
  c.r = s + o.r;
  c.hp = s + o.hp;
  c.flows[0] = reinterpret_cast<float4*>(s + o.f0);
  c.flows[1] = reinterpret_cast<float4*>(s + o.f1);
  c.p[0] = reinterpret_cast<float4*>(s + o.p0);
  c.p[1] = reinterpret_cast<float4*>(s + o.p1);
  c.red = s + o.red;
  c.reds = s + o.reds;
  c.out_pose = static_cast<float*>(out_pose);
  c.out_flows = static_cast<float*>(out_flows);
  c.P = P;
  c.m = m;
  c.p0 = p0;
  c.rank = rank;
  c.n = n;
  c.n_ends = n_ends;
  c.nc = (P + nrslam::kChunk - 1) / nrslam::kChunk;
  c.g0 = p0 / nrslam::kChunk;
  c.g1 = (p0 + m - 1) / nrslam::kChunk;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long smem = 4 * nrslam::kSmemFloats;
  cudaError_t err;
  switch (phase) {
    case 0:
      err = nrslam::launch_cluster(nrslam::joint_init, C, nrslam::kThreads,
                                   0, st, c);
      break;
    case 1:
      err = nrslam::launch_cluster(nrslam::joint_lin, C, nrslam::kThreads,
                                   smem, st, c, arg);
      break;
    case 2:
      err = nrslam::launch_cluster(nrslam::joint_step, C, nrslam::kThreads,
                                   smem, st, c, arg >> 2, arg & 3);
      break;
    case 3:
      err = nrslam::launch_cluster(nrslam::joint_hv, C, nrslam::kThreads,
                                   smem, st, c, arg & 1, arg >> 1);
      break;
    case 4:
      err = nrslam::launch_cluster(nrslam::joint_cg, C, nrslam::kThreads,
                                   smem, st, c, arg & 1, arg >> 1);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
