// Whole-schedule joint pose + deformation LM in one cluster launch.
//
// Replaces: nrslam_tpu/solver/pose_deformation_pallas.py::_joint_kernel
// (wrapper pose_deformation_optimization_pallas). Same schedule and terms
// as the Pallas kernel and the plain driver (solver/pose_deformation.py):
// rounds of <= 10 LM steps from the seed with zero flows, each step a
// 10-trip block-Jacobi PCG (tolerance 1e-8) over one SE(3) twist + per-point
// 3D flows; reprojection (info_r, Huber 5.99), spatial dampers
// w (f_i - f_j) (info_s, Huber 0.584) and springs 1.1 (|dX| - d0) / d0
// (info_p, Huber 0.584); points and dampers re-level by chi2 between rounds,
// springs never do. Outputs the pose, the flows and the final per-point chi2.
//
// What bounds it on an H100: the serial LM / CG chain (~200 Hessian-vector
// products per call, each followed by two cluster-wide dot products), not
// bytes or FLOPs: at P = 768 and E = 5376 a trip is ~0.3 MFLOP and the whole
// state < 1 MB. The TPU kernel's one-hot selector matmuls exist only because
// TPU gathers are slow; here edges gather flows directly, all in float32.
//
// Design (cluster_pcg.cuh): one thread block cluster of kBlocks = 8 blocks
// of 256 threads. Block r owns a contiguous range of points and their
// incident edge-ends; the current linearisation of those (pose and flow
// Jacobians, IRLS weights, per-edge-end damper/spring terms next to each
// edge's constants), the block's CG vectors and full copies of the search
// direction, of z and of the flows live in shared memory (up to P ~ 8.7k
// at the H100's 227 KB; beyond, what does not fit lives in the block's
// global region, SmemPlan). The Hessian-vector product is fused: the two
// threads owning point p each recompute half of its incident edges' terms
// from the stored (ws, w_p, a) and p_i - p_j, in the CSR's order, and add
// the halves, so no per-edge buffer or barrier is needed. Where the full
// copies are in shared memory, owners push their z slice into every
// block's copy before the reduction that yields beta, else every block
// pulls all slices after it; either way every block forms p = z + beta p
// itself. Dot products are cluster reductions in rank order (no atomics:
// every block computes the same alpha, beta and 6x6 pose update, and every
// call gives the same bits). The trial linearisation of an LM step goes to
// global memory and is copied into the current one when the step is
// accepted.

#include "cluster_pcg.cuh"

namespace nrslam {
namespace {

constexpr int kThreads = 256;
constexpr int kBlocks = 8;     // blocks of the cluster
constexpr float kTh2Dof = 5.99f;
constexpr float kTh3Dof = 0.584f;
constexpr float kSpringK = 1.1f;
constexpr float kLmTau = 1e-5f;
constexpr float kCgTol = 1e-8f;
constexpr int kSysSums = 28;   // 21 upper H_pose, 6 g_pose, 1 chi2
constexpr int kHvSums = 7;     // 6 pose Hv parts + p . Hp
constexpr int kOwnFloats = 53; // per owned point: lin 28, CG 21, flows 3, mask 1
constexpr int kRecFloats = 13; // per edge-end, see Own
constexpr int kHdr = 16;       // scratch header (ints): work counters

enum Mode { kStep = 0, kRelevel = 1, kFinal = 2 };

// One linearisation of a block's points and edge-ends. Point arrays are
// indexed by the local point lp; es.at(kl)[0..5) = (ws, w_p, a0, a1, a2).
struct Lin {
  float* Jp;  // [own][12] pose Jacobian rows u (0..5) and v (6..11)
  float* Jf;  // [own][6]  flow Jacobian rows u (0..2) and v (3..5)
  float* wr;  // [own]     IRLS reprojection weight (info * huber * mask)
  float* gf;  // [own][3]  flow gradient
  float* D;   // [own][6]  flow diagonal blocks (00 01 02 11 12 22)
  EndRecs es;
};

// Shared state of the owned points. cur.es records also hold the edge's
// constants: [5] the re-levelled damper mask, [6] the other endpoint as int
// bits (o when this point is the edge's i, -o - 1 when it is j), [7] w,
// [8] d0, [9] the base mask, [10..13) rest_i - rest_j.
struct Own {
  Lin cur;
  float* minv;   // [own][9] inverted flow blocks
  float* x;      // [own][3] CG vectors
  float* r;
  float* hp;
  float* z;      // [own][3] preconditioned residual, pushed to every block
  float* fo;     // [own][3] trial flows, pulled by every block
  float* pmask;  // [own] point mask of the round
  float* p;      // [P][3] full copy of the search direction
  float* zf;     // [P][3] full copy of z, written by the owners' pushes
                 // (used only when the full copies are in shared memory)
  float* fl[2];  // [P][3] full copies of the flows (accepted / trial)
};

struct Inputs {
  const float* cam;  // [8]
  const float* rest; // [P][3]
  const float* obs;  // [P][2]
  const float* pmask;// [P] TRACKED_WITH_3D mask
  const int* ei;     // [E]
  const int* ej;     // [E]
  const float* ew;   // [E] RBF weight
  const float* ed0;  // [E] rest distance (clamped >= 1e-12)
  const float* ebase;// [E] base pair mask
  const int* pt_off;    // [kBlocks + 1] owned point ranges
  const int* inc_ptr;   // [P + 1]
  const int* inc_edge;  // incident live edges of each point, edge order
  const float* inc_sign;// +1 when the point is the edge's i, -1 for j
  int P, E, n_ends, kind;
  float info_r, info_s, info_p;  // params[15..17], loaded in the kernel
};

struct SharedLin {
  float H[36];
  float g[6];
  float chi2;
};

struct PoseCG {  // written by threads 0..5 only
  float Hinv[36];
  float xp[6], rp[6], zp[6], pp[6];
};

// Global scratch: header, the blocks' regions for owned state that does not
// fit in shared memory, the trial linearisation, edge-end records beyond
// the shared capacity, the blocks' full copies that do not fit.
__host__ __device__ inline long scratch_floats(int P, int n_ends) {
  return kHdr + static_cast<long>(kBlocks) * kOwnFloats * own_max(P, kBlocks)
         + 28L * P + 5L * n_ends + kRecFloats * n_ends
         + kBlocks * 4L * pad4(3L * P);
}

__device__ inline void carve(float* sm, float* scratch, const Inputs& in,
                             const Part& c, const SmemPlan& pl, Own& o,
                             Lin& trial) {
  const long P = in.P, n = in.n_ends, own = pl.own;
  float* gs = scratch + kHdr;
  float* gown = gs; gs += kBlocks * kOwnFloats * own;
  float* s = pl.own_sh ? sm : gown + c.rank * kOwnFloats * own;
  o.cur.Jp = s; s += 12 * own;
  o.cur.Jf = s; s += 6 * own;
  o.cur.wr = s; s += own;
  o.cur.gf = s; s += 3 * own;
  o.cur.D = s; s += 6 * own;
  o.minv = s; s += 9 * own;
  o.x = s; s += 3 * own;
  o.r = s; s += 3 * own;
  o.hp = s; s += 3 * own;
  o.z = s; s += 3 * own;
  o.fo = s; s += 3 * own;
  o.pmask = s; s += own;
  float* sh = pl.own_sh ? s : sm;  // shared memory after the owned state
  float* tJp = gs; gs += 12 * P;
  float* tJf = gs; gs += 6 * P;
  float* twr = gs; gs += P;
  float* tgf = gs; gs += 3 * P;
  float* tD = gs; gs += 6 * P;
  float* tes = gs; gs += 5 * n;
  float* ovf = gs; gs += kRecFloats * n;
  const long P3 = pad4(3 * P);  // keeps every copy 16-byte aligned
  float* full = pl.full_sh ? sh : gs + c.rank * 4 * P3;
  o.p = full;
  o.zf = full + P3;
  o.fl[0] = full + 2 * P3;
  o.fl[1] = full + 3 * P3;
  sh += pl.full_sh ? 4 * P3 : 0;
  o.cur.es = EndRecs{sh, ovf + static_cast<long>(kRecFloats) * c.k0, pl.cap,
                     kRecFloats};
  trial.Jp = tJp + 12L * c.p0;
  trial.Jf = tJf + 6L * c.p0;
  trial.wr = twr + c.p0;
  trial.gf = tgf + 3L * c.p0;
  trial.D = tD + 6L * c.p0;
  trial.es = EndRecs{nullptr, tes + 5L * c.k0, 0, 5};
}

// Linearise at (q, t, flows) into `out` and slin. kStep uses the round's
// point and damper masks; kRelevel and kFinal the full base masks, and
// kRelevel then re-levels the masks from the chi2s, kFinal writes the
// per-point chi2 to out_chi2. Springs always use the base mask.
__device__ void linearize(const Inputs& in, const Part& c, Own& o,
                          const Lin& out, const float* q, const float* t,
                          const float* flows, int mode, SharedLin* slin,
                          Reducer<kSysSums>& R, int& slot, float* out_chi2) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int own = c.p1 - c.p0;
  float acc[kSysSums];
#pragma unroll
  for (int k = 0; k < kSysSums; ++k) acc[k] = 0.0f;
  float Rm[9];
  quat_to_matrix(q, Rm);
  for (int base = 0; base < own; base += nt / 2) {
    const int lp = base + (tid >> 1), half = tid & 1;
    const bool active = lp < own;
    const int p = c.p0 + (active ? lp : 0);
    // Incident edges in edge order, the first half summed by the even
    // thread of the pair and the second by the odd one, the halves added in
    // that order. Each edge's terms are formed in its (i, j) orientation at
    // both endpoints, so both ends agree bit for bit.
    float gsum[3] = {0.0f, 0.0f, 0.0f}, dsum[6] = {0, 0, 0, 0, 0, 0};
    if (active) {
      const int kb = in.inc_ptr[p] - c.k0, ke = in.inc_ptr[p + 1] - c.k0;
      const int mid = kb + (ke - kb + 1) / 2;
      for (int kl = half ? mid : kb; kl < (half ? ke : mid); ++kl) {
        float* rec = o.cur.es.at(kl);
        const int code = __float_as_int(rec[6]);
        const bool iend = code >= 0;
        const int other = iend ? code : -code - 1;
        const int i = iend ? p : other, j = iend ? other : p;
        const float sg = iend ? 1.0f : -1.0f;
        const float df0 = flows[3 * i] - flows[3 * j];
        const float df1 = flows[3 * i + 1] - flows[3 * j + 1];
        const float df2 = flows[3 * i + 2] - flows[3 * j + 2];
        const float w = rec[7], d0 = rec[8], pm = rec[9];
        const float sm = mode == kStep ? rec[5] : pm;
        const float chi2_s = in.info_s * (w * w) * (df0 * df0 + df1 * df1 + df2 * df2);
        const float w_s = in.info_s * huber_w(chi2_s, kTh3Dof) * sm;
        const float diff0 = rec[10] + df0;
        const float diff1 = rec[11] + df1;
        const float diff2 = rec[12] + df2;
        const float dist = sqrtf(diff0 * diff0 + diff1 * diff1 + diff2 * diff2);
        const float e_p = kSpringK * (dist - d0) / d0;
        const float chi2_p = in.info_p * e_p * e_p;
        const float w_p = in.info_p * huber_w(chi2_p, kTh3Dof) * pm;
        if (iend)
          acc[27] += huber_rho(chi2_s, kTh3Dof) * sm + huber_rho(chi2_p, kTh3Dof) * pm;
        const float ws = w * w * w_s;
        const float kd = kSpringK / d0;
        const float inv_dist = 1.0f / fmaxf(dist, 1e-12f);
        const float a0 = kd * diff0 * inv_dist;
        const float a1 = kd * diff1 * inv_dist;
        const float a2 = kd * diff2 * inv_dist;
        const float wpe = w_p * e_p;
        gsum[0] += sg * (ws * df0 + wpe * a0);
        gsum[1] += sg * (ws * df1 + wpe * a1);
        gsum[2] += sg * (ws * df2 + wpe * a2);
        dsum[0] += ws + w_p * a0 * a0;
        dsum[1] += w_p * a0 * a1;
        dsum[2] += w_p * a0 * a2;
        dsum[3] += ws + w_p * a1 * a1;
        dsum[4] += w_p * a1 * a2;
        dsum[5] += ws + w_p * a2 * a2;
        float* es = out.es.at(kl);
        es[0] = ws; es[1] = w_p; es[2] = a0; es[3] = a1; es[4] = a2;
        if (mode == kRelevel) rec[5] = chi2_s <= kTh3Dof ? pm : 0.0f;
      }
    }
    for (int d = 0; d < 3; ++d) gsum[d] = pair_sum(gsum[d]);
    for (int d = 0; d < 6; ++d) dsum[d] = pair_sum(dsum[d]);
    if (!active || half) continue;

    const float x = in.rest[3 * p] + flows[3 * p];
    const float y = in.rest[3 * p + 1] + flows[3 * p + 1];
    const float z = in.rest[3 * p + 2] + flows[3 * p + 2];
    const float xc = Rm[0] * x + Rm[1] * y + Rm[2] * z + t[0];
    const float yc = Rm[3] * x + Rm[4] * y + Rm[5] * z + t[1];
    const float zc = Rm[6] * x + Rm[7] * y + Rm[8] * z + t[2];
    float pu, pv, J[6];
    project_with_jacobian(in.kind, in.cam, xc, yc, zc, &pu, &pv, J);
    const float eu = in.obs[2 * p] - pu, ev = in.obs[2 * p + 1] - pv;
    const float chi2_r = in.info_r * (eu * eu + ev * ev);
    const float m = mode == kStep ? o.pmask[lp] : in.pmask[p];
    float Ju[6], Jv[6], Jfu[3], Jfv[3], w_r = 0.0f;
    if (m != 0.0f) {
      w_r = in.info_r * huber_w(chi2_r, kTh2Dof) * m;
      pose_jacobian(J, xc, yc, zc, Ju, Jv);
      for (int d = 0; d < 3; ++d) {
        Jfu[d] = -(J[0] * Rm[d] + J[1] * Rm[3 + d] + J[2] * Rm[6 + d]);
        Jfv[d] = -(J[3] * Rm[d] + J[4] * Rm[3 + d] + J[5] * Rm[6 + d]);
      }
      acc[27] += huber_rho(chi2_r, kTh2Dof) * m;
    } else {
      for (int d = 0; d < 6; ++d) Ju[d] = Jv[d] = 0.0f;
      for (int d = 0; d < 3; ++d) Jfu[d] = Jfv[d] = 0.0f;
    }

    float* Jp = out.Jp + 12L * lp;
    float* Jf = out.Jf + 6L * lp;
    for (int d = 0; d < 6; ++d) { Jp[d] = Ju[d]; Jp[6 + d] = Jv[d]; }
    for (int d = 0; d < 3; ++d) { Jf[d] = Jfu[d]; Jf[3 + d] = Jfv[d]; }
    out.wr[lp] = w_r;
    for (int d = 0; d < 3; ++d)
      out.gf[3 * lp + d] = w_r * (Jfu[d] * eu + Jfv[d] * ev) + gsum[d];
    const int ia[6] = {0, 0, 0, 1, 1, 2}, ib[6] = {0, 1, 2, 1, 2, 2};
    for (int d = 0; d < 6; ++d)
      out.D[6 * lp + d] = w_r * (Jfu[ia[d]] * Jfu[ib[d]] + Jfv[ia[d]] * Jfv[ib[d]])
                          + dsum[d];
    if (mode == kRelevel) o.pmask[lp] = chi2_r <= kTh2Dof ? in.pmask[p] : 0.0f;
    if (mode == kFinal) out_chi2[p] = chi2_r;
    int n = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a)
#pragma unroll
      for (int b = a; b < 6; ++b) acc[n++] += w_r * (Ju[a] * Ju[b] + Jv[a] * Jv[b]);
#pragma unroll
    for (int a = 0; a < 6; ++a) acc[21 + a] += w_r * (Ju[a] * eu + Jv[a] * ev);
  }
  warp_store(acc, warp_row(R));
  cluster_total(R, kSysSums, slot);
  if (tid == 0) {
    int n = 0;
    for (int a = 0; a < 6; ++a)
      for (int b = a; b < 6; ++b) {
        slin->H[a * 6 + b] = R.tot[n];
        slin->H[b * 6 + a] = R.tot[n];
        ++n;
      }
    for (int a = 0; a < 6; ++a) slin->g[a] = R.tot[21 + a];
    slin->chi2 = R.tot[27];
  }
  __syncthreads();
}

__device__ inline void apply_minv(const float* M, const float* r, float* z) {
  for (int i = 0; i < 3; ++i)
    z[i] = M[3 * i] * r[0] + M[3 * i + 1] * r[1] + M[3 * i + 2] * r[2];
}

// Fixed-trip block-Jacobi PCG for (H + lam I) dx = -g at the current
// linearisation; the result is pose.xp (pose) and o.x (own flows). Exits once
// converged (x no longer changes). Returns through `trips` the Hessian-
// vector products it ran. z reaches every block by push when the full
// copies are in shared memory (`full_sh`), else by gather.
__device__ void pcg(const Inputs& in, const Part& c, Own& o,
                    const SharedLin* slin, float lam, int iters, PoseCG* pc,
                    Reducer<kSysSums>& R, int& slot, int& trips,
                    const Slices& sl, bool full_sh) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int own = c.p1 - c.p0, P = in.P;
  if (tid == 0) inv6(slin->H, lam, pc->Hinv);
  float acc2[2] = {0.0f, 0.0f};
  for (int lp = tid; lp < own; lp += nt) {
    const float* D = o.cur.D + 6 * lp;
    const float m[9] = {D[0] + lam, D[1], D[2], D[1], D[3] + lam, D[4],
                        D[2], D[4], D[5] + lam};
    float* mi = o.minv + 9 * lp;
    inv3(m, mi);
    float r[3], z[3];
    for (int d = 0; d < 3; ++d) {
      r[d] = -o.cur.gf[3 * lp + d];
      o.x[3 * lp + d] = 0.0f;
      o.r[3 * lp + d] = r[d];
    }
    apply_minv(mi, r, z);
    for (int d = 0; d < 3; ++d) {
      o.z[3 * lp + d] = z[d];
      acc2[0] += r[d] * z[d];
      acc2[1] += r[d] * r[d];
    }
  }
  warp_store(acc2, warp_row(R));
  cluster_total(R, 2, slot);
  const float rz0 = R.tot[0], b20 = R.tot[1];
  gather(o.p, o.z, c, sl, false, 0.0f);  // p = z
  if (tid < 6) {
    float s = 0.0f;
    for (int j = 0; j < 6; ++j) s += pc->Hinv[tid * 6 + j] * (-slin->g[j]);
    pc->rp[tid] = -slin->g[tid];
    pc->zp[tid] = s;
    pc->xp[tid] = 0.0f;
    pc->pp[tid] = s;
  }
  __syncthreads();
  float rz = 0.0f, b2 = 0.0f;
  for (int d = 0; d < 6; ++d) {
    rz += pc->rp[d] * pc->zp[d];
    b2 += pc->rp[d] * pc->rp[d];
  }
  rz = rz + rz0;
  b2 = b2 + b20;

  for (int it = 0; it < iters; ++it) {
    ++trips;
    // Fused Hv: reprojection part, incident edge terms
    // ws dv + w_p (a . dv) a with dv = p_i - p_j, pose partials, p . Hp.
    float acc7[kHvSums];
#pragma unroll
    for (int d = 0; d < kHvSums; ++d) acc7[d] = 0.0f;
    const float* pf_all = o.p;
    for (int base = 0; base < own; base += nt / 2) {
      const int lp = base + (tid >> 1), half = tid & 1;
      const bool active = lp < own;
      const int p = c.p0 + (active ? lp : 0);
      // Incident edge terms, the halves of the point's edge-ends summed by
      // the two threads of a pair, as in linearize.
      float esum[3] = {0.0f, 0.0f, 0.0f};
      if (active) {
        const int kb = in.inc_ptr[p] - c.k0, ke = in.inc_ptr[p + 1] - c.k0;
        const int mid = kb + (ke - kb + 1) / 2;
        for (int kl = half ? mid : kb; kl < (half ? ke : mid); ++kl) {
          const float* es = o.cur.es.at(kl);
          const int code = __float_as_int(es[6]);
          const bool iend = code >= 0;
          const int other = iend ? code : -code - 1;
          const int i = iend ? p : other, j = iend ? other : p;
          const float dv0 = pf_all[3 * i] - pf_all[3 * j];
          const float dv1 = pf_all[3 * i + 1] - pf_all[3 * j + 1];
          const float dv2 = pf_all[3 * i + 2] - pf_all[3 * j + 2];
          const float wad = es[1] * (es[2] * dv0 + es[3] * dv1 + es[4] * dv2);
          const float sg = iend ? 1.0f : -1.0f;
          esum[0] += sg * (es[0] * dv0 + wad * es[2]);
          esum[1] += sg * (es[0] * dv1 + wad * es[3]);
          esum[2] += sg * (es[0] * dv2 + wad * es[4]);
        }
      }
      for (int d = 0; d < 3; ++d) esum[d] = pair_sum(esum[d]);
      if (!active || half) continue;
      const float* Jp = o.cur.Jp + 12 * lp;
      const float* Jf = o.cur.Jf + 6 * lp;
      const float pf[3] = {pf_all[3 * p], pf_all[3 * p + 1], pf_all[3 * p + 2]};
      float ru = Jf[0] * pf[0] + Jf[1] * pf[1] + Jf[2] * pf[2];
      float rv = Jf[3] * pf[0] + Jf[4] * pf[1] + Jf[5] * pf[2];
      for (int d = 0; d < 6; ++d) {
        ru += Jp[d] * pc->pp[d];
        rv += Jp[6 + d] * pc->pp[d];
      }
      const float w = o.cur.wr[lp];
      for (int d = 0; d < 3; ++d) {
        const float h = w * (Jf[d] * ru + Jf[3 + d] * rv) + esum[d] + lam * pf[d];
        o.hp[3 * lp + d] = h;
        acc7[6] += pf[d] * h;
      }
      for (int d = 0; d < 6; ++d) acc7[d] += w * (Jp[d] * ru + Jp[6 + d] * rv);
    }
    warp_store(acc7, warp_row(R));
    cluster_total(R, kHvSums, slot);

    // alpha and the pose update, the same bits in every thread and block.
    float hpp[6], denom = 0.0f;
    for (int d = 0; d < 6; ++d) {
      hpp[d] = R.tot[d] + lam * pc->pp[d];
      denom += pc->pp[d] * hpp[d];
    }
    denom += R.tot[6];
    const float alpha = fabsf(denom) > 0.0f ? rz / denom : 0.0f;
    float xn = 0.0f, rn = 0.0f, zn = 0.0f;
    if (tid < 6) {
      float rv6[6];
      for (int d = 0; d < 6; ++d) rv6[d] = pc->rp[d] - alpha * hpp[d];
      for (int j = 0; j < 6; ++j) zn += pc->Hinv[tid * 6 + j] * rv6[j];
      xn = pc->xp[tid] + alpha * pc->pp[tid];
      rn = rv6[tid];
    }
    __syncthreads();
    if (tid < 6) {
      pc->xp[tid] = xn;
      pc->rp[tid] = rn;
      pc->zp[tid] = zn;
    }

    acc2[0] = acc2[1] = 0.0f;
    for (int lp = tid; lp < own; lp += nt) {
      const int p = c.p0 + lp;
      float r[3], z[3];
      for (int d = 0; d < 3; ++d) {
        o.x[3 * lp + d] += alpha * pf_all[3 * p + d];
        r[d] = o.r[3 * lp + d] - alpha * o.hp[3 * lp + d];
        o.r[3 * lp + d] = r[d];
      }
      apply_minv(o.minv + 9 * lp, r, z);
      for (int d = 0; d < 3; ++d) {
        o.z[3 * lp + d] = z[d];
        acc2[0] += r[d] * z[d];
        acc2[1] += r[d] * r[d];
      }
    }
    warp_store(acc2, warp_row(R));
    if (full_sh) {
      __syncthreads();
      push(o.zf, o.z, c);  // complete after the reduction's barrier
    }
    cluster_total(R, 2, slot);
    float rz_new = R.tot[0], rr = R.tot[1];
    for (int d = 0; d < 6; ++d) {
      rz_new += pc->rp[d] * pc->zp[d];
      rr += pc->rp[d] * pc->rp[d];
    }
    const float beta = fabsf(rz) > 0.0f ? rz_new / rz : 0.0f;
    const bool done = rr <= kCgTol * kCgTol * b2;
    if (!done) rz = rz_new;
    if (tid < 6) pc->pp[tid] = pc->zp[tid] + beta * pc->pp[tid];
    if (done) break;  // x is final once converged
    if (full_sh) {
      for (long k = tid; k < 3L * P; k += nt) o.p[k] = o.zf[k] + beta * o.p[k];
    } else {
      gather(o.p, o.z, c, sl, true, beta);  // p = z + beta p
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads, 1)
pose_deformation_kernel(Inputs in, const float* __restrict__ params,
                        float* scratch, float* out_pose, float* out_flows,
                        float* out_chi2, SmemPlan plan, int n_rounds, int it0,
                        int it1, int it2, int it3, int cg_iters) {
  extern __shared__ __align__(16) float smem[];
  __shared__ Reducer<kSysSums> R;
  __shared__ SharedLin slin[2];
  __shared__ PoseCG pose;
  __shared__ float s_q[4], s_t[3], s_qn[4], s_tn[3];
  __shared__ int s_off[kBlocks + 1];

  const int tid = threadIdx.x, nt = blockDim.x;
  in.info_r = params[15];
  in.info_s = params[16];
  in.info_p = params[17];
  const Part c = part_of(in.pt_off, in.inc_ptr, plan.own);
  Own o;
  Lin trial;  // in global memory; copied to o.cur on acceptance
  carve(smem, scratch, in, c, plan, o, trial);
  const int own = c.p1 - c.p0;
  const Slices sl{s_off, 1, in.P, plan.own,
                  plan.own_sh ? 0L : static_cast<long>(kOwnFloats) * plan.own};
  const int iters[4] = {it0, it1, it2, it3};
  int slot = 0, n_lm = 0, n_trips = 0, n_lin = 0;

  // Static fields of the edge-end records and the initial masks.
  for (int kl = tid; kl < c.k1 - c.k0; kl += nt) {
    const int kg = c.k0 + kl;
    const int e = in.inc_edge[kg];
    const bool iend = in.inc_sign[kg] > 0.0f;
    const int i = in.ei[e], j = in.ej[e];
    float* rec = o.cur.es.at(kl);
    rec[5] = in.ebase[e];
    rec[6] = __int_as_float(iend ? j : -i - 1);
    rec[7] = in.ew[e];
    rec[8] = in.ed0[e];
    rec[9] = in.ebase[e];
    for (int d = 0; d < 3; ++d)
      rec[10 + d] = in.rest[3 * i + d] - in.rest[3 * j + d];
  }
  for (int lp = tid; lp < own; lp += nt) o.pmask[lp] = in.pmask[c.p0 + lp];
  if (tid <= c.C) s_off[tid] = in.pt_off[tid];
  int fcur = 0;

  for (int r = 0; r < n_rounds; ++r) {
    if (tid == 0) {
      for (int k = 0; k < 4; ++k) s_q[k] = params[8 + k];
      for (int k = 0; k < 3; ++k) s_t[k] = params[12 + k];
    }
    float* f = o.fl[fcur];
    for (long k = tid; k < 3L * in.P; k += nt) f[k] = 0.0f;
    __syncthreads();
    int cur = 0;
    linearize(in, c, o, o.cur, s_q, s_t, f, kStep, &slin[cur], R, slot,
              nullptr);
    ++n_lin;
    // lambda0 = tau * max(diag H_pose, max_p diag D_p).
    float dmax = -INFINITY;
    for (int lp = tid; lp < own; lp += nt) {
      const float* D = o.cur.D + 6 * lp;
      dmax = fmaxf(dmax, fmaxf(D[0], fmaxf(D[3], D[5])));
    }
    dmax = cluster_max(R, dmax, slot);
    for (int a = 0; a < 6; ++a) dmax = fmaxf(dmax, slin[cur].H[a * 6 + a]);
    float lam = kLmTau * dmax, nu = 2.0f;
    bool done = false;

    for (int j = 0; j < iters[r]; ++j) {
      if (done) break;  // uniform: every thread of every block agrees
      ++n_lm;
      pcg(in, c, o, &slin[cur], lam, cg_iters, &pose, R, slot, n_trips, sl,
          plan.full_sh != 0);
      if (tid == 0) se3_retract(s_q, s_t, pose.xp, s_qn, s_tn);
      // Trial flows + the flow parts of the gain-ratio denominator and |dx|^2.
      float acc[2] = {0.0f, 0.0f};
      const float* fc = o.fl[fcur];
      float* fn = o.fl[1 - fcur];
      for (int lp = tid; lp < own; lp += nt) {
        const int p = c.p0 + lp;
        for (int d = 0; d < 3; ++d) {
          const float dx = o.x[3 * lp + d];
          o.fo[3 * lp + d] = fc[3 * p + d] + dx;
          acc[0] += dx * (lam * dx - o.cur.gf[3 * lp + d]);
          acc[1] += dx * dx;
        }
      }
      warp_store(acc, warp_row(R));
      cluster_total(R, 2, slot);  // also publishes every block's trial flows
      const float denom_f = R.tot[0], dx2_f = R.tot[1];
      gather(fn, o.fo, c, sl, false, 0.0f);
      __syncthreads();
      linearize(in, c, o, trial, s_qn, s_tn, fn, kStep, &slin[1 - cur], R,
                slot, nullptr);
      ++n_lin;
      float denom = denom_f, dx2 = dx2_f;
      for (int d = 0; d < 6; ++d) {
        const float xd = pose.xp[d];
        denom += xd * (lam * xd - slin[cur].g[d]);
        dx2 += xd * xd;
      }
      const float rho = (slin[cur].chi2 - slin[1 - cur].chi2)
                        / (fabsf(denom) > 0.0f ? denom : 1.0f);
      const bool accepted = rho > 0.0f;
      const float c3 = 2.0f * rho - 1.0f;
      const float shrink = fmaxf(1.0f / 3.0f, 1.0f - c3 * c3 * c3);
      lam = accepted ? lam * shrink : lam * nu;
      nu = accepted ? 2.0f : nu * 2.0f;
      if (accepted) {
        cur = 1 - cur;
        fcur = 1 - fcur;
        for (int lp = tid; lp < own; lp += nt) {
          for (int d = 0; d < 12; ++d) o.cur.Jp[12 * lp + d] = trial.Jp[12 * lp + d];
          for (int d = 0; d < 6; ++d) o.cur.Jf[6 * lp + d] = trial.Jf[6 * lp + d];
          o.cur.wr[lp] = trial.wr[lp];
          for (int d = 0; d < 3; ++d) o.cur.gf[3 * lp + d] = trial.gf[3 * lp + d];
          for (int d = 0; d < 6; ++d) o.cur.D[6 * lp + d] = trial.D[6 * lp + d];
        }
        for (int kl = tid; kl < c.k1 - c.k0; kl += nt) {
          float* dst = o.cur.es.at(kl);
          const float* src = trial.es.at(kl);
          for (int d = 0; d < 5; ++d) dst[d] = src[d];
        }
        if (tid == 0) {
          for (int k = 0; k < 4; ++k) s_q[k] = s_qn[k];
          for (int k = 0; k < 3; ++k) s_t[k] = s_tn[k];
        }
        done = dx2 < 1e-12f;
      }
      __syncthreads();
    }

    // Re-level at the round optimum with the full base masks.
    linearize(in, c, o, trial, s_q, s_t, o.fl[fcur], kRelevel,
              &slin[1 - cur], R, slot, nullptr);
    ++n_lin;
  }

  // Final linearisation (full masks) for the per-point chi2 output.
  linearize(in, c, o, trial, s_q, s_t, o.fl[fcur], kFinal, &slin[0], R,
            slot, out_chi2);
  ++n_lin;
  const float* f = o.fl[fcur];
  for (int lp = tid; lp < own; lp += nt)
    for (int d = 0; d < 3; ++d)
      out_flows[3 * (c.p0 + lp) + d] = f[3 * (c.p0 + lp) + d];
  if (c.rank == 0 && tid == 0) {
    for (int k = 0; k < 4; ++k) out_pose[k] = s_q[k];
    for (int k = 0; k < 3; ++k) out_pose[4 + k] = s_t[k];
    out_pose[7] = 0.0f;
    int* hdr = reinterpret_cast<int*>(scratch);
    hdr[0] = n_lm;
    hdr[1] = n_trips;
    hdr[2] = n_lin;
    hdr[3] = c.C;
    hdr[4] = plan.cap;
    hdr[5] = plan.full_sh;
    hdr[6] = static_cast<int>(plan.bytes);
    hdr[7] = plan.own_sh;
  }
  cg::this_cluster().sync();  // no block leaves while others read its smem
}

}  // namespace
}  // namespace nrslam

// Blocks of the kernel's cluster: the wrapper's layout has this many owner
// ranges.
extern "C" int nrslam_pose_deformation_blocks() { return nrslam::kBlocks; }

// Scratch size in floats for P points and a CSR of n_ends entries. The
// first 16 floats are a header of ints: LM steps, CG trips,
// linearisations, blocks, edge-end records in shared memory, full vectors
// in shared memory (0/1), dynamic shared bytes per block, owned state in
// shared memory (0/1).
extern "C" long nrslam_pose_deformation_scratch(int P, int n_ends) {
  return nrslam::scratch_floats(P, n_ends);
}

// C entry point. Pointers are device pointers; params = (fx, fy, cx, cy,
// k0..k3, q (4), t (3), info_r, info_s, info_p). pt_off [kBlocks + 1] and
// the CSR (inc_ptr [P + 1], inc_edge / inc_sign [n_ends]) are the wrapper's
// layout. Returns a CUDA error code: cudaErrorInvalidValue for P < 1,
// cudaErrorInvalidConfiguration when the card cannot hold the cluster,
// else cudaGetLastError() after the launch.
extern "C" int nrslam_pose_deformation(
    const void* params, const void* rest, const void* obs, const void* pmask,
    const void* ei, const void* ej, const void* ew, const void* ed0,
    const void* ebase, const void* pt_off, const void* inc_ptr,
    const void* inc_edge, const void* inc_sign, void* scratch,
    void* out_pose, void* out_flows, void* out_chi2, int P, int E,
    int n_ends, int kind, int n_rounds, int it0, int it1, int it2,
    int it3, int cg_iters, void* stream) {
  if (P < 1) return static_cast<int>(cudaErrorInvalidValue);
  long avail = 0;
  cudaError_t err = nrslam::smem_available(nrslam::pose_deformation_kernel,
                                           &avail);
  if (err != cudaSuccess) return static_cast<int>(err);
  const nrslam::SmemPlan plan = nrslam::plan_smem(
      P, nrslam::kBlocks, nrslam::kOwnFloats, 4 * nrslam::pad4(3L * P),
      nrslam::kRecFloats, n_ends, avail);
  nrslam::Inputs in;
  in.cam = static_cast<const float*>(params);
  in.rest = static_cast<const float*>(rest);
  in.obs = static_cast<const float*>(obs);
  in.pmask = static_cast<const float*>(pmask);
  in.ei = static_cast<const int*>(ei);
  in.ej = static_cast<const int*>(ej);
  in.ew = static_cast<const float*>(ew);
  in.ed0 = static_cast<const float*>(ed0);
  in.ebase = static_cast<const float*>(ebase);
  in.pt_off = static_cast<const int*>(pt_off);
  in.inc_ptr = static_cast<const int*>(inc_ptr);
  in.inc_edge = static_cast<const int*>(inc_edge);
  in.inc_sign = static_cast<const float*>(inc_sign);
  in.P = P;
  in.E = E;
  in.n_ends = n_ends;
  in.kind = kind;
  in.info_r = in.info_s = in.info_p = 0.0f;  // read from params on device
  return static_cast<int>(nrslam::launch_cluster(
      nrslam::pose_deformation_kernel, nrslam::kBlocks, nrslam::kThreads,
      plan.bytes,
      static_cast<cudaStream_t>(stream), in,
      static_cast<const float*>(params), static_cast<float*>(scratch),
      static_cast<float*>(out_pose), static_cast<float*>(out_flows),
      static_cast<float*>(out_chi2), plan, n_rounds, it0, it1, it2, it3,
      cg_iters));
}
