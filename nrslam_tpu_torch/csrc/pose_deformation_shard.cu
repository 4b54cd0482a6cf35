// Joint pose + deformation LM partitioned over the ranks' point blocks:
// phase kernels whose partial sums are all-reduced between launches.
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
// A rank owns the points [p0, p0 + m) and their edge-ends: positions
// [inc_ptr[p0], inc_ptr[p0 + m]) of the whole incidence CSR (each point's
// live incident edges in edge order). It computes an edge's terms at each
// end it owns, in the edge's (i, j) orientation, so the two ranks of an
// edge that crosses ranks agree bit for bit; an edge's robust chi2 is
// counted at its i end.
//
// Every launch is one block that does the work between two all_reduces
// (the host, pose_deformation_cuda.shard, enqueues them and the
// collectives on one stream), so a barrier orders a phase's steps. What
// every rank must hold the same (pose, LM and CG scalars, the pose part of
// every CG vector) thread 0 computes from the reduced sums into the device
// row `st`; every rank computes the same bits. Per point: the current and
// the trial linearisation (lin[cur], lin[1 - cur]), the block-Jacobi
// inverses and the CG vectors of the rank's points; per owned edge-end its
// (ws, w_p, a) of both linearisations and its damper mask; the flows
// (accepted and trial) and the search direction p are whole [P, 3] on
// every rank. The accept of an LM step flips `cur` in st, so nothing is
// copied and nothing is read back to the host.
//
// Sums go by chunk of kChunk consecutive global points: a warp sums a
// chunk in a fixed order (common.cuh warp_reduce_scatter32) into the
// chunk's row of a buffer that is zero outside the rank's chunks, the
// all_reduce adds the ranks' rows, and the next phase adds the rows in
// chunk order. So two calls give the same bits, and where the ranks'
// blocks are whole chunks n ranks give the bits of one process.
//
// Collectives: `red` [3P + 2 nc] carries this rank's block of a [P, 3]
// vector (z, or the trial flows) zero-filled elsewhere, then two sums a
// chunk; `reds` [28 nc + n] the pose system's 28 sums a chunk (and at a
// round's start each rank's largest flow-block diagonal at its slot, for
// lambda0), or the 7 sums a chunk of a Hessian-vector product. Per LM
// step: start the PCG (z), then per CG trip hv (reds[:7 nc]) and cg (red:
// z, or after the last trip the trial flows), then the trial
// linearisation (reds[:28 nc]).

#include "common.cuh"

namespace nrslam {
namespace {

constexpr int kThreads = 512;
constexpr float kTh2Dof = 5.99f;
constexpr float kTh3Dof = 0.584f;
constexpr float kSpringK = 1.1f;
constexpr float kLmTau = 1e-5f;
constexpr float kCgTol = 1e-8f;
constexpr int kLinFloats = 28;  // per point: Jp 12, Jf 6, wr, gf 3, D 6
constexpr int kEndFloats = 5;   // per edge-end: ws, w_p, a (3)
constexpr int kChunk = 64;      // points a chunk's partial sums cover

enum Mode { kStart = 0, kTrial = 1, kRelevel = 2, kFinal = 3 };
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
  const float* rest;     // [P, 3] every point
  const float* pv;       // [P] point mask (TRACKED_WITH_3D)
  const float* obs;      // [m, 2] the rank's points
  const int* ei;         // [E]
  const int* ej;
  const float* ew;       // RBF weight
  const float* ed0;      // rest distance, clamped >= 1e-12
  const float* ebase;    // base pair mask
  const int* inc_ptr;    // [P + 1]
  const int* inc_edge;   // [2E]
  const float* inc_sign; // [2E]
  float* st;             // [sFloats]
  float* lin[2];         // [m][kLinFloats]
  float* es[2];          // [2E][kEndFloats], at the rank's CSR positions
  float* smask;          // [2E] damper mask of the round
  float* pmask;          // [m] point mask of the round
  float* minv;           // [m][9]
  float* x;              // [m][3] CG vectors of the rank's points
  float* r;
  float* hp;
  float* flows[2];       // [P][3]
  float* p;              // [P][3]
  float* red;            // [3P + 2]
  float* reds;           // [28 + n]
  float* out_pose;       // [8]
  float* out_flows;      // [P][3]
  int P, m, p0, rank, n;
  int nc, g0, g1;        // chunks of P; the rank's first and last chunk
};

__device__ inline int cur_of(const Ctx& c) {
  return c.st[sCur] != 0.0f ? 1 : 0;
}

// red[0, w P) zero outside this rank's rows [w p0, w (p0 + m)), which the
// caller writes.
__device__ inline void zero_others(const Ctx& c, int w) {
  const int a = w * c.p0, b = w * (c.p0 + c.m);
  for (int k = threadIdx.x; k < w * c.P; k += blockDim.x)
    if (k < a || k >= b) c.red[k] = 0.0f;
}

__device__ inline float block_max(float v, float* sh) {
  for (int s = 16; s > 0; s >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, s));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  float out = sh[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) out = fmaxf(out, sh[w]);
  return out;
}

// Rows [nc][S] of partial sums: zero outside the rank's chunks [g0, g1],
// which store_row writes.
__device__ inline void zero_rows(const Ctx& c, float* rows, int S) {
  for (int k = threadIdx.x; k < c.nc * S; k += blockDim.x)
    if (k / S < c.g0 || k / S > c.g1) rows[k] = 0.0f;
}

// A warp's acc summed over its lanes in a fixed order into row g of rows
// [nc][S] (the warp must be converged).
__device__ inline void store_row(float (&acc)[32], float* rows, int g,
                                 int S) {
  warp_reduce_scatter32(acc);
  const int lane = threadIdx.x & 31;
  if (lane < S) rows[g * S + lane] = acc[0];
}

// Column k of rows [nc][S] summed in chunk order.
__device__ inline float chunk_sum(const Ctx& c, const float* rows, int S,
                                  int k) {
  float s = 0.0f;
  for (int g = 0; g < c.nc; ++g) s += rows[g * S + k];
  return s;
}

__device__ inline void apply3(const float* M, const float* v, float* o) {
  for (int i = 0; i < 3; ++i)
    o[i] = M[3 * i] * v[0] + M[3 * i + 1] * v[1] + M[3 * i + 2] * v[2];
}

// One point's terms (local index lp) at rotation Rm, translation t and
// flows F [P, 3]: kStart / kTrial with the round's point and damper masks
// into lin `L` and ends `E` and its share of the 28 sums into acc; kRelevel
// with the full masks re-levels the round's masks; kFinal with the full
// masks writes its chi2 to red[p]. Springs always use the base mask.
__device__ void lin_point(const Ctx& c, int mode, int lp, const float* Rm,
                          const float* t, const float* F, float* L, float* E,
                          float (&acc)[32]) {
  const float info_r = c.st[sInfo], info_s = c.st[sInfo + 1],
              info_p = c.st[sInfo + 2];
  const bool round_masks = mode == kStart || mode == kTrial;
  const int p = c.p0 + lp;
  float gsum[3] = {0.0f, 0.0f, 0.0f}, dsum[6] = {0, 0, 0, 0, 0, 0};
  for (int k = c.inc_ptr[p]; k < c.inc_ptr[p + 1]; ++k) {
    const int e = c.inc_edge[k];
    const bool iend = c.inc_sign[k] > 0.0f;
    const int i = c.ei[e], j = c.ej[e];
    const float df0 = F[3 * i] - F[3 * j];
    const float df1 = F[3 * i + 1] - F[3 * j + 1];
    const float df2 = F[3 * i + 2] - F[3 * j + 2];
    const float w = c.ew[e], d0 = c.ed0[e], pm = c.ebase[e];
    const float sm = round_masks ? c.smask[k] : pm;
    const float chi2_s =
        info_s * (w * w) * (df0 * df0 + df1 * df1 + df2 * df2);
    const float w_s = info_s * huber_w(chi2_s, kTh3Dof) * sm;
    const float diff0 = (c.rest[3 * i] - c.rest[3 * j]) + df0;
    const float diff1 = (c.rest[3 * i + 1] - c.rest[3 * j + 1]) + df1;
    const float diff2 = (c.rest[3 * i + 2] - c.rest[3 * j + 2]) + df2;
    const float dist = sqrtf(diff0 * diff0 + diff1 * diff1 + diff2 * diff2);
    const float e_p = kSpringK * (dist - d0) / d0;
    const float chi2_p = info_p * e_p * e_p;
    const float w_p = info_p * huber_w(chi2_p, kTh3Dof) * pm;
    if (iend)
      acc[27] += huber_rho(chi2_s, kTh3Dof) * sm
                 + huber_rho(chi2_p, kTh3Dof) * pm;
    const float ws = w * w * w_s;
    const float kd = kSpringK / d0;
    const float inv_dist = 1.0f / fmaxf(dist, 1e-12f);
    const float a0 = kd * diff0 * inv_dist;
    const float a1 = kd * diff1 * inv_dist;
    const float a2 = kd * diff2 * inv_dist;
    const float wpe = w_p * e_p;
    const float sg = iend ? 1.0f : -1.0f;
    gsum[0] += sg * (ws * df0 + wpe * a0);
    gsum[1] += sg * (ws * df1 + wpe * a1);
    gsum[2] += sg * (ws * df2 + wpe * a2);
    dsum[0] += ws + w_p * a0 * a0;
    dsum[1] += w_p * a0 * a1;
    dsum[2] += w_p * a0 * a2;
    dsum[3] += ws + w_p * a1 * a1;
    dsum[4] += w_p * a1 * a2;
    dsum[5] += ws + w_p * a2 * a2;
    if (E != nullptr) {
      float* es = E + kEndFloats * k;
      es[0] = ws; es[1] = w_p; es[2] = a0; es[3] = a1; es[4] = a2;
    }
    if (mode == kRelevel) c.smask[k] = chi2_s <= kTh3Dof ? pm : 0.0f;
  }

  const float x = c.rest[3 * p] + F[3 * p];
  const float y = c.rest[3 * p + 1] + F[3 * p + 1];
  const float z = c.rest[3 * p + 2] + F[3 * p + 2];
  const float xc = Rm[0] * x + Rm[1] * y + Rm[2] * z + t[0];
  const float yc = Rm[3] * x + Rm[4] * y + Rm[5] * z + t[1];
  const float zc = Rm[6] * x + Rm[7] * y + Rm[8] * z + t[2];
  float pu, pv, J[6];
  project_with_jacobian(c.kind, c.cam, xc, yc, zc, &pu, &pv, J);
  const float eu = c.obs[2 * lp] - pu, ev = c.obs[2 * lp + 1] - pv;
  const float chi2_r = info_r * (eu * eu + ev * ev);
  if (mode == kRelevel) {
    c.pmask[lp] = chi2_r <= kTh2Dof ? c.pv[p] : 0.0f;
    return;
  }
  if (mode == kFinal) {
    c.red[p] = chi2_r;
    return;
  }
  const float mk = c.pmask[lp];
  float Ju[6], Jv[6], Jfu[3], Jfv[3], w_r = 0.0f;
  if (mk != 0.0f) {
    w_r = info_r * huber_w(chi2_r, kTh2Dof) * mk;
    pose_jacobian(J, xc, yc, zc, Ju, Jv);
    for (int d = 0; d < 3; ++d) {
      Jfu[d] = -(J[0] * Rm[d] + J[1] * Rm[3 + d] + J[2] * Rm[6 + d]);
      Jfv[d] = -(J[3] * Rm[d] + J[4] * Rm[3 + d] + J[5] * Rm[6 + d]);
    }
    acc[27] += huber_rho(chi2_r, kTh2Dof) * mk;
  } else {
    for (int d = 0; d < 6; ++d) Ju[d] = Jv[d] = 0.0f;
    for (int d = 0; d < 3; ++d) Jfu[d] = Jfv[d] = 0.0f;
  }
  float* l = L + kLinFloats * lp;
  for (int d = 0; d < 6; ++d) { l[d] = Ju[d]; l[6 + d] = Jv[d]; }
  for (int d = 0; d < 3; ++d) { l[12 + d] = Jfu[d]; l[15 + d] = Jfv[d]; }
  l[18] = w_r;
  for (int d = 0; d < 3; ++d)
    l[19 + d] = w_r * (Jfu[d] * eu + Jfv[d] * ev) + gsum[d];
  const int ia[6] = {0, 0, 0, 1, 1, 2}, ib[6] = {0, 1, 2, 1, 2, 2};
  for (int d = 0; d < 6; ++d)
    l[22 + d] = w_r * (Jfu[ia[d]] * Jfu[ib[d]] + Jfv[ia[d]] * Jfv[ib[d]])
                + dsum[d];
  int n = 0;
  for (int a = 0; a < 6; ++a)
    for (int b = a; b < 6; ++b) acc[n++] += w_r * (Ju[a] * Ju[b] + Jv[a] * Jv[b]);
  for (int a = 0; a < 6; ++a) acc[21 + a] += w_r * (Ju[a] * eu + Jv[a] * ev);
}

// The rank's terms at pose (q, t) and flows F (lin_point for each of its
// points), chunk by chunk; with `rows`, each chunk's 28 sums into its row
// of rows [nc][28] (zero outside the rank's chunks).
__device__ void linearize(const Ctx& c, int mode, const float* q,
                          const float* t, const float* F, float* L, float* E,
                          float* rows) {
  float Rm[9];
  quat_to_matrix(q, Rm);
  if (rows != nullptr) zero_rows(c, rows, 28);
  const int lane = threadIdx.x & 31;
  for (int g = c.g0 + (threadIdx.x >> 5); g <= c.g1;
       g += blockDim.x >> 5) {
    float acc[32];
    for (int k = 0; k < 32; ++k) acc[k] = 0.0f;
    for (int h = 0; h < kChunk; h += 32) {
      const int lp = g * kChunk + h + lane - c.p0;
      if (lp >= 0 && lp < c.m) lin_point(c, mode, lp, Rm, t, F, L, E, acc);
    }
    if (rows != nullptr) store_row(acc, rows, g, 28);
  }
}

// kStart: the round's first linearisation at the seed with zero flows into
// lin[cur], its sums by chunk into reds [nc][28] and the rank's largest
// flow-block diagonal at slot rank of a zero-filled [n] after them.
// kTrial: the trial flows from red (whole, after the trial step's
// collective) into flows[1 - cur], the step's flow partials summed into st,
// then the linearisation at the trial pose into lin[1 - cur] and its sums
// into reds [nc][28].
__global__ void __launch_bounds__(kThreads, 1)
lin_kernel(Ctx c, int mode) {
  __shared__ float smax[kThreads / 32];
  const int cur = cur_of(c), tid = threadIdx.x, nt = blockDim.x;
  const int tgt = mode == kStart ? cur : 1 - cur;
  float* F = c.flows[tgt];
  if (mode == kStart) {
    for (int k = tid; k < 3 * c.P; k += nt) F[k] = 0.0f;
  } else {
    for (int k = tid; k < 3 * c.P; k += nt) F[k] = c.red[k];
    if (tid == 0) {
      c.st[sDenomF] = chunk_sum(c, c.red + 3 * c.P, 2, 0);
      c.st[sDx2F] = chunk_sum(c, c.red + 3 * c.P, 2, 1);
    }
  }
  __syncthreads();
  const float* pose = c.st + (mode == kStart ? sT0 : sTn);
  linearize(c, mode, pose, pose + 4, F, c.lin[tgt], c.es[tgt], c.reds);
  if (tid == 0) c.st[sWork + 2] += 1.0f;
  if (mode == kStart) {
    __syncthreads();  // lin written before the reads below
    float dmax = -INFINITY;
    for (int lp = tid; lp < c.m; lp += nt) {
      const float* D = c.lin[tgt] + kLinFloats * lp + 22;
      dmax = fmaxf(dmax, fmaxf(D[0], fmaxf(D[3], D[5])));
    }
    dmax = block_max(dmax, smax);
    float* slots = c.reds + 28 * c.nc;
    for (int r = tid; r < c.n; r += nt) slots[r] = r == c.rank ? dmax : 0.0f;
  }
}

// The call's start: the seed pose and infos from params (cam 8, q 4, t 3,
// info_r, info_s, info_p) into st, the first round's point mask (pv of the
// rank's points) and damper mask (the base mask at each owned end).
__global__ void __launch_bounds__(kThreads, 1)
init_kernel(Ctx c, const float* __restrict__ params) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (tid < 7) c.st[sT0 + tid] = params[8 + tid];
  if (tid < 3) c.st[sInfo + tid] = params[15 + tid];
  for (int lp = tid; lp < c.m; lp += nt) c.pmask[lp] = c.pv[c.p0 + lp];
  const int k0 = c.inc_ptr[c.p0], k1 = c.inc_ptr[c.p0 + c.m];
  for (int k = k0 + tid; k < k1; k += nt) c.smask[k] = c.ebase[c.inc_edge[k]];
}

// (H [36], g [6], chi2) from reds [nc][28], each summed in chunk order.
__device__ inline float reduced_sys(const Ctx& c, float* H, float* g) {
  float s[28];
  for (int k = 0; k < 28; ++k) s[k] = chunk_sum(c, c.reds, 28, k);
  int k = 0;
  for (int a = 0; a < 6; ++a)
    for (int b = a; b < 6; ++b, ++k) {
      H[a * 6 + b] = s[k];
      H[b * 6 + a] = s[k];
    }
  for (int a = 0; a < 6; ++a) g[a] = s[21 + a];
  return s[27];
}

// finish 0: reds holds a round's first linearisation (kStart): the LM
// state of the round (lambda0 from the largest diagonal). finish 1: reds
// holds the trial's: gain ratio, lambda / nu, accept (flip cur), done.
// Then `next`: start the PCG of the next LM step (z of the rank's points
// into red, zero elsewhere, with the r.z and b.b partials by chunk); or
// re-level the round's masks at the accepted state; or the final
// linearisation (each point's chi2 into red, the outputs).
__global__ void __launch_bounds__(kThreads, 1)
step_kernel(Ctx c, int finish, int next) {
  const int tid = threadIdx.x, nt = blockDim.x;
  float* st = c.st;
  if (tid == 0) {
    float H[36], g[6];
    const float chi2 = reduced_sys(c, H, g);
    if (finish == 0) {
      for (int k = 0; k < 36; ++k) st[sH + k] = H[k];
      for (int k = 0; k < 6; ++k) st[sG + k] = g[k];
      st[sChi2] = chi2;
      float dmax = -INFINITY;
      for (int a = 0; a < 6; ++a) dmax = fmaxf(dmax, H[a * 6 + a]);
      for (int r = 0; r < c.n; ++r) dmax = fmaxf(dmax, c.reds[28 * c.nc + r]);
      st[sLam] = kLmTau * dmax;
      st[sNu] = 2.0f;
      st[sLmDone] = 0.0f;
      for (int k = 0; k < 7; ++k) st[sT + k] = st[sT0 + k];
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
          for (int k = 0; k < 7; ++k) st[sT + k] = st[sTn + k];
          for (int k = 0; k < 36; ++k) st[sH + k] = H[k];
          for (int k = 0; k < 6; ++k) st[sG + k] = g[k];
          st[sChi2] = chi2;
          st[sCur] = st[sCur] != 0.0f ? 0.0f : 1.0f;
          if (dx2 < 1e-12f) st[sLmDone] = 1.0f;
        }
      }
    }
  }
  __syncthreads();
  const int cur = cur_of(c);
  const float* F = c.flows[cur];
  if (next == kNextRelevel || next == kNextFinal) {
    if (tid == 0) st[sWork + 2] += 1.0f;
    linearize(c, next == kNextRelevel ? kRelevel : kFinal, st + sT,
              st + sT + 4, F, nullptr, nullptr, nullptr);
    if (next == kNextFinal) {
      for (int k = tid; k < c.P; k += nt)
        if (k < c.p0 || k >= c.p0 + c.m) c.red[k] = 0.0f;
      for (int k = tid; k < 3 * c.P; k += nt) c.out_flows[k] = F[k];
      if (tid == 0) {
        const float* q = st + sT;
        const float n = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2]
                              + q[3] * q[3]);
        for (int k = 0; k < 4; ++k) c.out_pose[k] = q[k] / n;
        for (int k = 0; k < 3; ++k) c.out_pose[4 + k] = st[sT + 4 + k];
        c.out_pose[7] = 0.0f;
      }
    }
    return;
  }

  // Start the PCG: x = 0, r = -g, z = M^-1 r, at the current lambda.
  const float lam = st[sLam];
  if (tid == 0) {
    float Hinv[36];
    inv6(st + sH, lam, Hinv);
    for (int k = 0; k < 36; ++k) st[sHinv + k] = Hinv[k];
    for (int d = 0; d < 6; ++d) {
      float s = 0.0f;
      for (int j = 0; j < 6; ++j) s += Hinv[d * 6 + j] * (-st[sG + j]);
      st[sRp + d] = -st[sG + d];
      st[sZp + d] = s;
      st[sXp + d] = 0.0f;
    }
  }
  const float* L = c.lin[cur];
  float* rows = c.red + 3 * c.P;
  zero_others(c, 3);
  zero_rows(c, rows, 2);
  const int lane = tid & 31;
  for (int g = c.g0 + (tid >> 5); g <= c.g1; g += nt >> 5) {
    float acc[32];
    for (int k = 0; k < 32; ++k) acc[k] = 0.0f;
    for (int h = 0; h < kChunk; h += 32) {
      const int lp = g * kChunk + h + lane - c.p0;
      if (lp < 0 || lp >= c.m) continue;
      const float* D = L + kLinFloats * lp + 22;
      const float m9[9] = {D[0] + lam, D[1], D[2], D[1], D[3] + lam, D[4],
                           D[2], D[4], D[5] + lam};
      float* mi = c.minv + 9 * lp;
      inv3(m9, mi);
      float r[3], z[3];
      for (int d = 0; d < 3; ++d) {
        r[d] = -L[kLinFloats * lp + 19 + d];
        c.x[3 * lp + d] = 0.0f;
        c.r[3 * lp + d] = r[d];
      }
      apply3(mi, r, z);
      for (int d = 0; d < 3; ++d) {
        c.red[3 * (c.p0 + lp) + d] = z[d];
        acc[0] += r[d] * z[d];
        acc[1] += r[d] * r[d];
      }
    }
    store_row(acc, rows, g, 2);
  }
}

// One CG trip's first half: from red (z whole and the r.z, r.r partials by
// chunk, reduced) every rank forms p = z + beta p over all P (first trip:
// p = z) and the pose part; then H p of the rank's points (reprojection and
// its edge-ends' damper and spring terms, + lambda p) and the 7 partials
// (pose part of H p, p.Hp) by chunk into reds [nc][7].
__global__ void __launch_bounds__(kThreads, 1)
hv_kernel(Ctx c, int first) {
  const int tid = threadIdx.x, nt = blockDim.x;
  float* st = c.st;
  const float* zp = st + sZp;
  const float* rp = st + sRp;
  float rz_new = chunk_sum(c, c.red + 3 * c.P, 2, 0);
  float rr = chunk_sum(c, c.red + 3 * c.P, 2, 1);
  for (int d = 0; d < 6; ++d) {
    rz_new += rp[d] * zp[d];
    rr += rp[d] * rp[d];
  }
  const float rz = st[sRz];
  const float beta = first ? 0.0f : (fabsf(rz) > 0.0f ? rz_new / rz : 0.0f);
  for (int k = tid; k < 3 * c.P; k += nt)
    c.p[k] = first ? c.red[k] : c.red[k] + beta * c.p[k];
  __syncthreads();  // every thread read st's rz before thread 0 writes it
  if (tid == 0) {
    for (int d = 0; d < 6; ++d)
      st[sPp + d] = first ? zp[d] : zp[d] + beta * st[sPp + d];
    if (first) {
      st[sRz] = rz_new;
      st[sB2] = rr;
      st[sCgDone] = 0.0f;
    } else {
      const bool done = st[sCgDone] != 0.0f || rr <= kCgTol * kCgTol * st[sB2];
      st[sCgDone] = done ? 1.0f : 0.0f;
      if (!done) st[sRz] = rz_new;
    }
  }
  zero_rows(c, c.reds, 7);
  __syncthreads();
  const float lam = st[sLam];
  float pp[6];
  for (int d = 0; d < 6; ++d) pp[d] = st[sPp + d];
  const float* L = c.lin[cur_of(c)];
  const float* E = c.es[cur_of(c)];
  const int lane = tid & 31;
  for (int g = c.g0 + (tid >> 5); g <= c.g1; g += nt >> 5) {
    float acc[32];
    for (int k = 0; k < 32; ++k) acc[k] = 0.0f;
    for (int h = 0; h < kChunk; h += 32) {
      const int lp = g * kChunk + h + lane - c.p0;
      if (lp < 0 || lp >= c.m) continue;
      const int p = c.p0 + lp;
      float esum[3] = {0.0f, 0.0f, 0.0f};
      for (int k = c.inc_ptr[p]; k < c.inc_ptr[p + 1]; ++k) {
        const int e = c.inc_edge[k];
        const int i = c.ei[e], j = c.ej[e];
        const float* es = E + kEndFloats * k;
        const float dv0 = c.p[3 * i] - c.p[3 * j];
        const float dv1 = c.p[3 * i + 1] - c.p[3 * j + 1];
        const float dv2 = c.p[3 * i + 2] - c.p[3 * j + 2];
        const float wad = es[1] * (es[2] * dv0 + es[3] * dv1 + es[4] * dv2);
        const float sg = c.inc_sign[k] > 0.0f ? 1.0f : -1.0f;
        esum[0] += sg * (es[0] * dv0 + wad * es[2]);
        esum[1] += sg * (es[0] * dv1 + wad * es[3]);
        esum[2] += sg * (es[0] * dv2 + wad * es[4]);
      }
      const float* l = L + kLinFloats * lp;
      const float pf[3] = {c.p[3 * p], c.p[3 * p + 1], c.p[3 * p + 2]};
      float ru = l[12] * pf[0] + l[13] * pf[1] + l[14] * pf[2];
      float rv = l[15] * pf[0] + l[16] * pf[1] + l[17] * pf[2];
      for (int d = 0; d < 6; ++d) {
        ru += l[d] * pp[d];
        rv += l[6 + d] * pp[d];
      }
      const float w = l[18];
      for (int d = 0; d < 3; ++d) {
        const float hd = w * (l[12 + d] * ru + l[15 + d] * rv) + esum[d]
                         + lam * pf[d];
        c.hp[3 * lp + d] = hd;
        acc[6] += pf[d] * hd;
      }
      for (int d = 0; d < 6; ++d) acc[d] += w * (l[d] * ru + l[6 + d] * rv);
    }
    store_row(acc, c.reds, g, 7);
  }
  if (tid == 0) st[sWork + 1] += 1.0f;
}

// One CG trip's second half: alpha from reds [nc][7] (reduced, summed in
// chunk order), x, r, z of the pose part (thread 0, into st) and of the
// rank's points; then z of the rank's points into red with the r.z, r.r
// partials by chunk, or after the last trip the trial step: the trial
// pose, the trial flows of the rank's points into red with the gain
// ratio's flow partials x.(lam x - g) and x.x by chunk.
__global__ void __launch_bounds__(kThreads, 1)
cg_kernel(Ctx c, int last) {
  const int tid = threadIdx.x, nt = blockDim.x;
  float* st = c.st;
  const float lam = st[sLam];
  float hpp[6], denom = 0.0f;
  for (int d = 0; d < 6; ++d) {
    hpp[d] = chunk_sum(c, c.reds, 7, d) + lam * st[sPp + d];
    denom += st[sPp + d] * hpp[d];
  }
  denom += chunk_sum(c, c.reds, 7, 6);
  const float alpha = st[sCgDone] != 0.0f ? 0.0f
                      : (fabsf(denom) > 0.0f ? st[sRz] / denom : 0.0f);
  __syncthreads();  // every thread read st before thread 0 writes it
  if (tid == 0) {
    float rv[6];
    for (int d = 0; d < 6; ++d) {
      st[sXp + d] += alpha * st[sPp + d];
      rv[d] = st[sRp + d] - alpha * hpp[d];
    }
    for (int d = 0; d < 6; ++d) {
      float s = 0.0f;
      for (int j = 0; j < 6; ++j) s += st[sHinv + d * 6 + j] * rv[j];
      st[sZp + d] = s;
      st[sRp + d] = rv[d];
    }
    if (last) se3_retract(st + sT, st + sT + 4, st + sXp, st + sTn,
                          st + sTn + 4);
  }
  const int cur = cur_of(c);
  const float* L = c.lin[cur];
  const float* F = c.flows[cur];
  float* rows = c.red + 3 * c.P;
  zero_others(c, 3);
  zero_rows(c, rows, 2);
  const int lane = tid & 31;
  for (int g = c.g0 + (tid >> 5); g <= c.g1; g += nt >> 5) {
    float acc[32];
    for (int k = 0; k < 32; ++k) acc[k] = 0.0f;
    for (int h = 0; h < kChunk; h += 32) {
      const int lp = g * kChunk + h + lane - c.p0;
      if (lp < 0 || lp >= c.m) continue;
      const int p = c.p0 + lp;
      float r[3], z[3];
      for (int d = 0; d < 3; ++d) {
        c.x[3 * lp + d] += alpha * c.p[3 * p + d];
        r[d] = c.r[3 * lp + d] - alpha * c.hp[3 * lp + d];
        c.r[3 * lp + d] = r[d];
      }
      if (!last) {
        apply3(c.minv + 9 * lp, r, z);
        for (int d = 0; d < 3; ++d) {
          c.red[3 * p + d] = z[d];
          acc[0] += r[d] * z[d];
          acc[1] += r[d] * r[d];
        }
      } else {
        for (int d = 0; d < 3; ++d) {
          const float dx = c.x[3 * lp + d];
          c.red[3 * p + d] = F[3 * p + d] + dx;
          acc[0] += dx * (lam * dx - L[kLinFloats * lp + 19 + d]);
          acc[1] += dx * dx;
        }
      }
    }
    store_row(acc, rows, g, 2);
  }
}

}  // namespace
}  // namespace nrslam

namespace {

// The scratch of a call, in floats: st, then the per-point and per-end
// state, the whole flows (2) and p, red and reds; each part's offset.
struct Carve {
  long st, lin0, lin1, es0, es1, smask, pmask, minv, x, r, hp, f0, f1, p,
      red, reds, total;
};

Carve carve(int m, int P, int n_ends, int n) {
  Carve o;
  long at = 0;
  auto take = [&at](long size) { const long here = at; at += size; return here; };
  const long M = m, K = n_ends;
  o.st = take(nrslam::sFloats);
  o.lin0 = take(nrslam::kLinFloats * M);
  o.lin1 = take(nrslam::kLinFloats * M);
  o.es0 = take(nrslam::kEndFloats * K);
  o.es1 = take(nrslam::kEndFloats * K);
  o.smask = take(K);
  o.pmask = take(M);
  o.minv = take(9 * M);
  o.x = take(3 * M);
  o.r = take(3 * M);
  o.hp = take(3 * M);
  o.f0 = take(3L * P);
  o.f1 = take(3L * P);
  o.p = take(3L * P);
  const long nc = (P + nrslam::kChunk - 1) / nrslam::kChunk;
  o.red = take(3L * P + 2 * nc);
  o.reds = take(28 * nc + n);
  o.total = at;
  return o;
}

}  // namespace

// The scratch of a call for m points of P, n_ends CSR positions and n
// ranks, in floats: out = (total, offset of red [3P + 2 nc], offset of
// reds [28 nc + n], offset of the work counters in st: LM steps, CG trips,
// linearisations; points a chunk of the partial sums covers), nc =
// ceil(P / chunk).
extern "C" int nrslam_joint_shard_layout(int m, int P, int n_ends, int n,
                                         long* out) {
  const Carve o = carve(m, P, n_ends, n);
  out[0] = o.total;
  out[1] = o.red;
  out[2] = o.reds;
  out[3] = o.st + nrslam::sWork;
  out[4] = nrslam::kChunk;
  return 0;
}

// C entry point of every phase. Pointers are device pointers: params (cam
// 8, pinhole using 4; seed q 4, t 3; info_r, info_s, info_p), rest [P, 3]
// and pv [P] of every point, obs [m, 2] of the rank's points [p0, p0 + m),
// the edge table ei, ej, ew, ed0 (clamped >= 1e-12), ebase [E], the whole
// incidence CSR inc_ptr [P + 1], inc_edge and inc_sign [n_ends]; scratch
// (nrslam_joint_shard_layout floats, zeroed before the first phase);
// outputs out_pose [8] (q normalised, t) and out_flows [P, 3], written by
// the final step. phase: 0 init_kernel, 1 lin_kernel(arg), 2
// step_kernel(arg >> 2, arg & 3), 3 hv_kernel(arg), 4 cg_kernel(arg).
// Returns cudaErrorInvalidValue for sizes it cannot run, else
// cudaGetLastError() after the launch.
extern "C" int nrslam_joint_shard(
    int phase, int arg, const void* params, int kind, const void* rest,
    const void* pv, const void* obs, const void* ei, const void* ej,
    const void* ew, const void* ed0, const void* ebase, const void* inc_ptr,
    const void* inc_edge, const void* inc_sign, void* scratch,
    void* out_pose, void* out_flows, int P, int m, int p0, int n_ends,
    int rank, int n, void* stream) {
  if (P < 1 || m < 1 || p0 < 0 || p0 + m > P || n < 1 || rank < 0 ||
      rank >= n || (kind != nrslam::kPinhole && kind != nrslam::kKB8))
    return static_cast<int>(cudaErrorInvalidValue);
  const Carve o = carve(m, P, n_ends, n);
  float* s = static_cast<float*>(scratch);
  nrslam::Ctx c;
  c.cam = static_cast<const float*>(params);
  c.kind = kind;
  c.rest = static_cast<const float*>(rest);
  c.pv = static_cast<const float*>(pv);
  c.obs = static_cast<const float*>(obs);
  c.ei = static_cast<const int*>(ei);
  c.ej = static_cast<const int*>(ej);
  c.ew = static_cast<const float*>(ew);
  c.ed0 = static_cast<const float*>(ed0);
  c.ebase = static_cast<const float*>(ebase);
  c.inc_ptr = static_cast<const int*>(inc_ptr);
  c.inc_edge = static_cast<const int*>(inc_edge);
  c.inc_sign = static_cast<const float*>(inc_sign);
  c.st = s + o.st;
  c.lin[0] = s + o.lin0;
  c.lin[1] = s + o.lin1;
  c.es[0] = s + o.es0;
  c.es[1] = s + o.es1;
  c.smask = s + o.smask;
  c.pmask = s + o.pmask;
  c.minv = s + o.minv;
  c.x = s + o.x;
  c.r = s + o.r;
  c.hp = s + o.hp;
  c.flows[0] = s + o.f0;
  c.flows[1] = s + o.f1;
  c.p = s + o.p;
  c.red = s + o.red;
  c.reds = s + o.reds;
  c.out_pose = static_cast<float*>(out_pose);
  c.out_flows = static_cast<float*>(out_flows);
  c.P = P;
  c.m = m;
  c.p0 = p0;
  c.rank = rank;
  c.n = n;
  c.nc = (P + nrslam::kChunk - 1) / nrslam::kChunk;
  c.g0 = p0 / nrslam::kChunk;
  c.g1 = (p0 + m - 1) / nrslam::kChunk;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int T = nrslam::kThreads;
  switch (phase) {
    case 0: nrslam::init_kernel<<<1, T, 0, st>>>(c, c.cam); break;
    case 1: nrslam::lin_kernel<<<1, T, 0, st>>>(c, arg); break;
    case 2: nrslam::step_kernel<<<1, T, 0, st>>>(c, arg >> 2, arg & 3); break;
    case 3: nrslam::hv_kernel<<<1, T, 0, st>>>(c, arg); break;
    case 4: nrslam::cg_kernel<<<1, T, 0, st>>>(c, arg); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
