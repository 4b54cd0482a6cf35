// Whole-schedule local deformable bundle adjustment in one cluster launch.
//
// Replaces: nrslam_tpu/solver/bundle_adjustment_pallas.py::_ba_kernel
// (wrapper local_deformable_ba_pallas). Same schedule and terms as the
// Pallas kernel and the plain driver (solver/bundle_adjustment.py): K
// keyframe SE(3) twists + one landmark copy per (keyframe, point);
// reprojection (info 4, Huber 5.99) per observed copy, unrobust springs
// 1.1 (|L_i - L_j| - d0) / d0 (info 100) per (keyframe, pair) and 4-ary
// temporal dampers w ((L'_i - L_i) - (L'_j - L_j)) (info_s, Huber 0.584)
// per (consecutive keyframe pair, pair); n_iters LM steps, each
// re-linearised at the accepted point and solved by a cg_iters block-Jacobi
// PCG (6x6 pose blocks, 3x3 landmark blocks), no re-levelling.
//
// What bounds it on an H100: the serial LM / CG chain (n_iters x cg_iters
// Hessian-vector products, each followed by two cluster-wide dot products),
// not bytes or FLOPs (~1.3 MFLOP a trip and ~3 MB of state at K = 5,
// P = 768, E = 5376).
//
// Design (cluster_pcg.cuh): one cluster of kBlocks = 16 blocks of 256
// threads.
// The points are partitioned across the cluster and a block owns all K
// copies of its points, so the dampers, which couple copies (k, p) and
// (k + 1, p) across an edge, stay block-local. The current linearisation
// of the owned copies (Jacobians, IRLS weights), the per-(keyframe,
// edge-end) spring and damper terms, the CG vectors and full copies of the
// search direction and of the landmarks being linearised ([K][P][3] each)
// live in shared memory (what does not fit, e.g. from K = 8 and P ~ 1.9k
// at the H100's 227 KB, lives in the block's global region instead,
// SmemPlan). The Hessian-vector product is
// fused: the thread of copy (k, p) recomputes each incident edge's spring
// term at k and damper terms to k - 1 and k + 1 from the stored terms and
// the search direction, in the CSR's fixed order. The K pose blocks'
// partials reduce over the cluster in one pass per reduction, in rank
// order (no atomics). Masked reprojection, spring and damper terms are
// skipped, never multiplied by zero, so unobserved copies (invalid keyframe
// slots hold zeros that project to 0/0) cannot poison the sums, and they
// are returned bit-for-bit unchanged. The trial linearisation stays in
// global memory (used once per LM step); an accepted step's linearisation
// is copied into shared memory.

#include "cluster_pcg.cuh"

namespace nrslam {
namespace {

constexpr int kThreads = 256;
constexpr int kBlocks = 16;  // blocks of the cluster (non-portable size)
constexpr int kMaxK = 8;
constexpr float kTh2Dof = 5.99f;
constexpr float kTh3Dof = 0.584f;
constexpr float kInfoR = 4.0f;    // 1 / 0.5^2
constexpr float kInfoP = 100.0f;  // 1 / 0.1^2
constexpr float kSpringK = 1.1f;
constexpr float kLmTau = 1e-5f;
constexpr float kCgTol = 1e-8f;
constexpr int kLinSums = 28;               // per keyframe: 21 upper H, 6 g, chi2
constexpr int kSums = kMaxK * kLinSums + 1;  // + the edge chi2
constexpr int kOwnFloats = 55;  // per owned copy: lin 28, CG 21, landmarks 6
constexpr int kHdr = 16;        // scratch header (ints): work counters
constexpr int kPull = 12;       // float4 of z a thread pulls per CG trip

// One linearisation of a block's copies (row-major [K][row] with local
// point lp) and edge-ends: es.at(kl)[5 k + (0..5)] = a0, a1, a2, w_p, wd2
// (damper to keyframe k + 1).
struct Lin {
  float* Jp;  // [K][row][12] pose Jacobian rows u (0..5) and v (6..11)
  float* Jl;  // [K][row][6]  landmark Jacobian rows u (0..2) and v (3..5)
  float* wr;  // [K][row]     IRLS reprojection weight (0 when unobserved)
  float* gl;  // [K][row][3]  landmark gradient
  float* D;   // [K][row][6]  landmark diagonal blocks (00 01 02 11 12 22)
  long row;
  EndRecs es;
};

// Shared state of the owned copies; cur.es records end with the edge's
// constants: [5 K] the other endpoint as int bits (o when this point is the
// edge's i, -o - 1 when it is j), [5 K + 1] the spring (bit k) and damper
// (bit 8 + k) masks as int bits, [5 K + 2] w, [5 K + 3] d0.
struct Own {
  Lin cur;
  float* minv;  // [K][own][9] inverted landmark blocks
  float* x;     // [K][own][3] CG vectors
  float* r;
  float* hp;
  float* z;     // [K][own][3] preconditioned residual, pulled by every block
  float* Lc;    // [K][own][3] accepted landmarks
  float* Ln;    // [K][own][3] trial landmarks, pulled by every block
  float* p;     // [K][P][3] full copy of the search direction
  float* Lf;    // [K][P][3] full copy of the landmarks being linearised,
                // in this block's global region (read by linearisations)
};

struct Inputs {
  const float* cam;       // [8]
  const float* L0;        // [K][P][3]
  const float* obs;       // [K][P][2]
  const float* omask;     // [K][P] observed copy (obs_valid & kf_valid)
  const int* ei;          // [E]
  const int* ej;          // [E]
  const float* ew;        // [E] RBF weight
  const float* ed0;       // [E] rest distance (clamped >= 1e-12)
  const float* smask;     // [K][E] spring mask
  const float* dmask;     // [K][E] damper mask (k, k + 1); row K - 1 is 0
  const int* pt_off;      // [kBlocks + 1] owned point ranges
  const int* inc_ptr;     // [P + 1]
  const int* inc_edge;    // incident live edges of each point, edge order
  const float* inc_sign;  // +1 when the point is the edge's i, -1 for j
  int K, P, E, n_ends, kind;
  float info_s;           // params[8 + 8 K], loaded in the kernel
};

struct SharedLin {
  float H[kMaxK][36];
  float g[kMaxK][6];
  float chi2;
};

struct PoseCG {  // written by threads < 6 K only
  float Hinv[kMaxK][36];
  float xp[kMaxK][6], rp[kMaxK][6], zp[kMaxK][6], pp[kMaxK][6];
};

// Global scratch: header, the blocks' regions for owned state that does not
// fit in shared memory, the trial linearisation, edge-end records beyond
// the shared capacity, the blocks' full copies.
__host__ __device__ inline long scratch_floats(int K, int P, int n_ends) {
  const long KP = static_cast<long>(K) * P;
  return kHdr + static_cast<long>(kBlocks) * kOwnFloats * K
                    * own_max(P, kBlocks)
         + 28L * KP + 5L * K * n_ends + (5L * K + 4) * n_ends
         + 6L * kBlocks * KP;
}

__device__ inline void carve(float* sm, float* scratch, const Inputs& in,
                             const Part& c, const SmemPlan& pl, Own& o,
                             Lin& trial) {
  const long K = in.K, P = in.P, KP = K * P, n = in.n_ends;
  const long own = pl.own, Kown = K * own, W = 5 * K + 4;
  float* gs = scratch + kHdr;
  float* gown = gs; gs += kBlocks * kOwnFloats * Kown;
  float* s = pl.own_sh ? sm : gown + c.rank * kOwnFloats * Kown;
  o.cur.Jp = s; s += 12 * Kown;
  o.cur.Jl = s; s += 6 * Kown;
  o.cur.wr = s; s += Kown;
  o.cur.gl = s; s += 3 * Kown;
  o.cur.D = s; s += 6 * Kown;
  o.cur.row = own;
  o.minv = s; s += 9 * Kown;
  o.x = s; s += 3 * Kown;
  o.r = s; s += 3 * Kown;
  o.hp = s; s += 3 * Kown;
  o.z = s; s += 3 * Kown;
  o.Lc = s; s += 3 * Kown;
  o.Ln = s; s += 3 * Kown;
  float* sh = pl.own_sh ? s : sm;  // shared memory after the owned state
  float* tJp = gs; gs += 12 * KP;
  float* tJl = gs; gs += 6 * KP;
  float* twr = gs; gs += KP;
  float* tgl = gs; gs += 3 * KP;
  float* tD = gs; gs += 6 * KP;
  float* tes = gs; gs += 5 * K * n;
  float* ovf = gs; gs += W * n;
  float* gfull = gs + c.rank * 6 * KP;
  o.p = pl.full_sh ? sh : gfull;
  o.Lf = gfull + 3 * KP;
  sh += pl.full_sh ? 3 * KP : 0;
  o.cur.es = EndRecs{sh, ovf + W * c.k0, pl.cap, static_cast<int>(W)};
  trial.Jp = tJp + 12L * c.p0;
  trial.Jl = tJl + 6L * c.p0;
  trial.wr = twr + c.p0;
  trial.gl = tgl + 3L * c.p0;
  trial.D = tD + 6L * c.p0;
  trial.row = P;
  trial.es = EndRecs{nullptr, tes + 5 * K * c.k0, 0,
                       static_cast<int>(5 * K)};
}

__device__ inline int end_other(const float* rec, int K, int p, int* i,
                                int* j) {
  const int code = __float_as_int(rec[5 * K]);
  const bool iend = code >= 0;
  const int other = iend ? code : -code - 1;
  *i = iend ? p : other;
  *j = iend ? other : p;
  return iend ? 1 : -1;
}

// Linearise at (q, t, L) into `out` and slin.
__device__ void linearize(const Inputs& in, const Part& c, Own& o,
                          const Lin& out, float (*q)[4], float (*t)[3],
                          const float* L, SharedLin* slin,
                          Reducer<kSums>& R, int& slot) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int K = in.K, P = in.P;
  const int own = c.p1 - c.p0;
  const int N = K * kLinSums + 1;
  float* row = warp_row(R);
  for (int k = threadIdx.x & 31; k < N; k += 32) row[k] = 0.0f;
  __syncwarp();

  // Edge pass, one thread per owned point: springs of every keyframe and
  // dampers between consecutive keyframes of its incident edges, in edge
  // order, into the copies' gradient and diagonal blocks.
  float chi2_e = 0.0f;
  for (int lp = tid; lp < own; lp += nt) {
    const int p = c.p0 + lp;
    float gs[kMaxK][3], ds[kMaxK][6];
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      for (int d = 0; d < 3; ++d) gs[k][d] = 0.0f;
      for (int d = 0; d < 6; ++d) ds[k][d] = 0.0f;
    }
    const int kb = in.inc_ptr[p] - c.k0, ke = in.inc_ptr[p + 1] - c.k0;
    for (int kl = kb; kl < ke; ++kl) {
      const float* rec = o.cur.es.at(kl);
      int i, j;
      const float sg = static_cast<float>(end_other(rec, K, p, &i, &j));
      const int mbits = __float_as_int(rec[5 * K + 1]);
      const float w = rec[5 * K + 2], d0 = rec[5 * K + 3];
      const float kd = kSpringK / d0;
      float sm[kMaxK], dl[kMaxK][3], wd2[kMaxK], dd[kMaxK][3];
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        sm[k] = 0.0f;
        wd2[k] = 0.0f;
        for (int d = 0; d < 3; ++d) dl[k][d] = dd[k][d] = 0.0f;
        if (k < K) {
          sm[k] = (mbits >> k) & 1 ? 1.0f : 0.0f;
          if (sm[k] != 0.0f) {
            const float* Li = L + 3L * (static_cast<long>(k) * P + i);
            const float* Lj = L + 3L * (static_cast<long>(k) * P + j);
            for (int d = 0; d < 3; ++d) dl[k][d] = Li[d] - Lj[d];
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kMaxK - 1; ++k) {
        if (k + 1 < K) {
          const float dm = (mbits >> (8 + k)) & 1 ? 1.0f : 0.0f;
          if (dm != 0.0f) {
            for (int d = 0; d < 3; ++d) dd[k][d] = dl[k + 1][d] - dl[k][d];
            const float chi2_d = in.info_s * (w * w) *
                (dd[k][0] * dd[k][0] + dd[k][1] * dd[k][1] + dd[k][2] * dd[k][2]);
            if (sg > 0.0f) chi2_e += huber_rho(chi2_d, kTh3Dof) * dm;
            wd2[k] = in.info_s * huber_w(chi2_d, kTh3Dof) * dm * (w * w);
          }
        }
      }
      float* es = out.es.at(kl);
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        if (k < K) {
          float a[3] = {0.0f, 0.0f, 0.0f}, g[3] = {0.0f, 0.0f, 0.0f}, wp = 0.0f;
          if (sm[k] != 0.0f) {
            const float dist = sqrtf(dl[k][0] * dl[k][0] + dl[k][1] * dl[k][1] +
                                     dl[k][2] * dl[k][2]);
            const float e_p = kSpringK * (dist - d0) / d0;
            if (sg > 0.0f) chi2_e += kInfoP * e_p * e_p * sm[k];
            const float inv_dist = 1.0f / fmaxf(dist, 1e-12f);
            wp = kInfoP * sm[k];
            for (int d = 0; d < 3; ++d) {
              a[d] = kd * dl[k][d] * inv_dist;
              g[d] = wp * e_p * a[d];
            }
          }
          float extra = wd2[k];
          for (int d = 0; d < 3; ++d) g[d] -= wd2[k] * dd[k][d];
          if (k > 0) {
            extra += wd2[k - 1];
            for (int d = 0; d < 3; ++d) g[d] += wd2[k - 1] * dd[k - 1][d];
          }
          for (int d = 0; d < 3; ++d) gs[k][d] += sg * g[d];
          ds[k][0] += wp * a[0] * a[0] + extra;
          ds[k][1] += wp * a[0] * a[1];
          ds[k][2] += wp * a[0] * a[2];
          ds[k][3] += wp * a[1] * a[1] + extra;
          ds[k][4] += wp * a[1] * a[2];
          ds[k][5] += wp * a[2] * a[2] + extra;
          float* ek = es + 5 * k;
          ek[0] = a[0]; ek[1] = a[1]; ek[2] = a[2]; ek[3] = wp; ek[4] = wd2[k];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      if (k < K) {
        const long cidx = k * out.row + lp;
        for (int d = 0; d < 3; ++d) out.gl[3 * cidx + d] = gs[k][d];
        for (int d = 0; d < 6; ++d) out.D[6 * cidx + d] = ds[k][d];
      }
    }
  }
  {
    float v[1] = {chi2_e};
    float last[1];
    for (int off = 16; off > 0; off >>= 1)
      v[0] += __shfl_down_sync(0xffffffffu, v[0], off);
    last[0] = v[0];
    if ((threadIdx.x & 31) == 0) row[N - 1] = last[0];
  }
  __syncthreads();  // edge parts of gl / D written by other threads

  // Copy pass, one thread per (keyframe, point); each warp holds a single
  // keyframe, whose 28 sums it adds to its row of partials.
  const int own_pad = ((c.p1 - c.p0) + 31) / 32 * 32;
  for (int base = 0; base < K * own_pad; base += nt) {
    const int cid = base + tid;
    const int k = cid / own_pad, lp = cid - k * own_pad;
    float acc[kLinSums];
#pragma unroll
    for (int n = 0; n < kLinSums; ++n) acc[n] = 0.0f;
    if (k < K && lp < own) {
      const int p = c.p0 + lp;
      const long gc = static_cast<long>(k) * P + p;
      const long cidx = k * out.row + lp;
      float R9[9];
      quat_to_matrix(q[k], R9);
      const float m = in.omask[gc];
      float Ju[6], Jv[6], Jlu[3], Jlv[3], w_r = 0.0f, eu = 0.0f, ev = 0.0f;
      if (m != 0.0f) {
        const float X0 = L[3 * gc], X1 = L[3 * gc + 1], X2 = L[3 * gc + 2];
        const float xc = R9[0] * X0 + R9[1] * X1 + R9[2] * X2 + t[k][0];
        const float yc = R9[3] * X0 + R9[4] * X1 + R9[5] * X2 + t[k][1];
        const float zc = R9[6] * X0 + R9[7] * X1 + R9[8] * X2 + t[k][2];
        float pu, pv, J[6];
        project_with_jacobian(in.kind, in.cam, xc, yc, zc, &pu, &pv, J);
        eu = in.obs[2 * gc] - pu;
        ev = in.obs[2 * gc + 1] - pv;
        const float chi2_r = kInfoR * (eu * eu + ev * ev);
        w_r = kInfoR * huber_w(chi2_r, kTh2Dof) * m;
        acc[27] += huber_rho(chi2_r, kTh2Dof) * m;
        pose_jacobian(J, xc, yc, zc, Ju, Jv);
        for (int d = 0; d < 3; ++d) {
          Jlu[d] = -(J[0] * R9[d] + J[1] * R9[3 + d] + J[2] * R9[6 + d]);
          Jlv[d] = -(J[3] * R9[d] + J[4] * R9[3 + d] + J[5] * R9[6 + d]);
        }
      } else {
        for (int d = 0; d < 6; ++d) Ju[d] = Jv[d] = 0.0f;
        for (int d = 0; d < 3; ++d) Jlu[d] = Jlv[d] = 0.0f;
      }
      float* Jp = out.Jp + 12 * cidx;
      float* Jl = out.Jl + 6 * cidx;
      for (int d = 0; d < 6; ++d) { Jp[d] = Ju[d]; Jp[6 + d] = Jv[d]; }
      for (int d = 0; d < 3; ++d) { Jl[d] = Jlu[d]; Jl[3 + d] = Jlv[d]; }
      out.wr[cidx] = w_r;
      for (int d = 0; d < 3; ++d)
        out.gl[3 * cidx + d] = w_r * (Jlu[d] * eu + Jlv[d] * ev) + out.gl[3 * cidx + d];
      const int ia[6] = {0, 0, 0, 1, 1, 2}, ib[6] = {0, 1, 2, 1, 2, 2};
      for (int d = 0; d < 6; ++d)
        out.D[6 * cidx + d] =
            w_r * (Jlu[ia[d]] * Jlu[ib[d]] + Jlv[ia[d]] * Jlv[ib[d]]) + out.D[6 * cidx + d];
      int n = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a)
#pragma unroll
        for (int b = a; b < 6; ++b)
          acc[n++] += w_r * (Ju[a] * Ju[b] + Jv[a] * Jv[b]);
#pragma unroll
      for (int a = 0; a < 6; ++a) acc[21 + a] += w_r * (Ju[a] * eu + Jv[a] * ev);
    }
#pragma unroll
    for (int n = 0; n < kLinSums; ++n)
      for (int off = 16; off > 0; off >>= 1)
        acc[n] += __shfl_down_sync(0xffffffffu, acc[n], off);
    if ((threadIdx.x & 31) == 0 && k < K)
      for (int n = 0; n < kLinSums; ++n) row[k * kLinSums + n] += acc[n];
  }
  cluster_total(R, N, slot);
  for (int u = tid; u < K * 21; u += nt) {
    const int k = u / 21, m = u - k * 21;
    int a = 0, rem = m;
    while (rem >= 6 - a) { rem -= 6 - a; ++a; }
    const int b = a + rem;
    slin->H[k][a * 6 + b] = R.tot[k * kLinSums + m];
    slin->H[k][b * 6 + a] = R.tot[k * kLinSums + m];
  }
  for (int u = tid; u < K * 6; u += nt)
    slin->g[u / 6][u % 6] = R.tot[(u / 6) * kLinSums + 21 + u % 6];
  if (tid == 0) {
    float chi2 = R.tot[N - 1];
    for (int k = 0; k < K; ++k) chi2 += R.tot[k * kLinSums + 27];
    slin->chi2 = chi2;
  }
  __syncthreads();
}

__device__ inline void apply_minv(const float* M, const float* r, float* z) {
  for (int i = 0; i < 3; ++i)
    z[i] = M[3 * i] * r[0] + M[3 * i + 1] * r[1] + M[3 * i + 2] * r[2];
}

// Search-direction difference of copy k across edge (i, j), zero where the
// keyframe's spring is masked.
__device__ inline void edge_dv(const float* pf, const float* es, int k,
                               int P, int i, int j, float dv[3]) {
  if (es[5 * k + 3] != 0.0f) {
    const float* pi = pf + 3L * (static_cast<long>(k) * P + i);
    const float* pj = pf + 3L * (static_cast<long>(k) * P + j);
    for (int d = 0; d < 3; ++d) dv[d] = pi[d] - pj[d];
  } else {
    dv[0] = dv[1] = dv[2] = 0.0f;
  }
}

// Fixed-trip block-Jacobi PCG for (H + lam I) dx = -g at the current
// linearisation; the result is pose.xp and o.x. Exits once converged.
__device__ void pcg(const Inputs& in, const Part& c, Own& o,
                    const SharedLin* slin, float lam, int iters, PoseCG* pc,
                    Reducer<kSums>& R, int& slot, int& trips,
                    const Slices& sl) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int K = in.K, P = in.P, own = c.p1 - c.p0;
  const long row = o.cur.row;
  if (tid < K) inv6(slin->H[tid], lam, pc->Hinv[tid]);
  float acc2[2] = {0.0f, 0.0f};
  for (int cid = tid; cid < K * own; cid += nt) {
    const int k = cid / own, lp = cid - k * own;
    const long ci = k * row + lp;
    const float* D = o.cur.D + 6 * ci;
    const float m[9] = {D[0] + lam, D[1], D[2], D[1], D[3] + lam, D[4],
                        D[2], D[4], D[5] + lam};
    float* mi = o.minv + 9 * ci;
    inv3(m, mi);
    float r[3], z[3];
    for (int d = 0; d < 3; ++d) {
      r[d] = -o.cur.gl[3 * ci + d];
      o.x[3 * ci + d] = 0.0f;
      o.r[3 * ci + d] = r[d];
    }
    apply_minv(mi, r, z);
    for (int d = 0; d < 3; ++d) {
      o.z[3 * ci + d] = z[d];
      acc2[0] += r[d] * z[d];
      acc2[1] += r[d] * r[d];
    }
  }
  warp_store(acc2, warp_row(R));
  cluster_total(R, 2, slot);
  const float rz0 = R.tot[0], b20 = R.tot[1];
  gather(o.p, o.z, c, sl, false, 0.0f);  // p = z
  if (tid < 6 * K) {
    const int k = tid / 6, d = tid - 6 * (tid / 6);
    float s = 0.0f;
    for (int j = 0; j < 6; ++j) s += pc->Hinv[k][d * 6 + j] * (-slin->g[k][j]);
    pc->rp[k][d] = -slin->g[k][d];
    pc->zp[k][d] = s;
    pc->xp[k][d] = 0.0f;
    pc->pp[k][d] = s;
  }
  __syncthreads();
  float rz = 0.0f, b2 = 0.0f;
  for (int k = 0; k < K; ++k)
    for (int d = 0; d < 6; ++d) {
      rz += pc->rp[k][d] * pc->zp[k][d];
      b2 += pc->rp[k][d] * pc->rp[k][d];
    }
  rz = rz + rz0;
  b2 = b2 + b20;

  const int own_pad = (own + 31) / 32 * 32;
  const int NH = 6 * K + 1;
  for (int it = 0; it < iters; ++it) {
    ++trips;
    // Fused Hv, one thread per copy (k, p): reprojection part, spring term
    // at k and the dampers to k - 1 and k + 1 of every incident edge; each
    // warp holds one keyframe and adds its pose partials to its row.
    float* wrow = warp_row(R);
    for (int u = threadIdx.x & 31; u < NH; u += 32) wrow[u] = 0.0f;
    __syncwarp();
    const float* pf_all = o.p;
    for (int base = 0; base < K * own_pad; base += nt) {
      const int cid = base + tid;
      const int k = cid / own_pad, lp = cid - k * own_pad;
      float a7[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (k < K && lp < own) {
        const int p = c.p0 + lp;
        const long ci = k * row + lp;
        const long gc = static_cast<long>(k) * P + p;
        const float pf[3] = {pf_all[3 * gc], pf_all[3 * gc + 1],
                             pf_all[3 * gc + 2]};
        float esum[3] = {0.0f, 0.0f, 0.0f};
        const int kb = in.inc_ptr[p] - c.k0, ke = in.inc_ptr[p + 1] - c.k0;
        for (int kl = kb; kl < ke; ++kl) {
          const float* es = o.cur.es.at(kl);
          int i, j;
          const float sg = static_cast<float>(end_other(es, K, p, &i, &j));
          float dv[3], dvm[3], dvp[3], sv[3] = {0.0f, 0.0f, 0.0f},
                svm[3] = {0.0f, 0.0f, 0.0f};
          edge_dv(pf_all, es, k, P, i, j, dv);
          if (k + 1 < K) {
            const float wd2 = es[5 * k + 4];
            if (wd2 != 0.0f) {
              edge_dv(pf_all, es, k + 1, P, i, j, dvp);
              for (int d = 0; d < 3; ++d) sv[d] = wd2 * (dvp[d] - dv[d]);
            }
          }
          if (k > 0) {
            const float wd2 = es[5 * (k - 1) + 4];
            if (wd2 != 0.0f) {
              edge_dv(pf_all, es, k - 1, P, i, j, dvm);
              for (int d = 0; d < 3; ++d) svm[d] = wd2 * (dv[d] - dvm[d]);
            }
          }
          const float* ek = es + 5 * k;
          const float wad = ek[3] * (ek[0] * dv[0] + ek[1] * dv[1] + ek[2] * dv[2]);
          for (int d = 0; d < 3; ++d) {
            float v = wad * ek[d] - sv[d];
            if (k > 0) v += svm[d];
            esum[d] += sg * v;
          }
        }
        float h[3];
        const float w = o.cur.wr[ci];
        if (w != 0.0f) {
          const float* Jp = o.cur.Jp + 12 * ci;
          const float* Jl = o.cur.Jl + 6 * ci;
          float ru = Jl[0] * pf[0] + Jl[1] * pf[1] + Jl[2] * pf[2];
          float rv = Jl[3] * pf[0] + Jl[4] * pf[1] + Jl[5] * pf[2];
          for (int d = 0; d < 6; ++d) {
            ru += Jp[d] * pc->pp[k][d];
            rv += Jp[6 + d] * pc->pp[k][d];
          }
          for (int d = 0; d < 3; ++d) h[d] = w * (Jl[d] * ru + Jl[3 + d] * rv);
          for (int d = 0; d < 6; ++d) a7[d] = w * (Jp[d] * ru + Jp[6 + d] * rv);
        } else {
          h[0] = h[1] = h[2] = 0.0f;
        }
        for (int d = 0; d < 3; ++d) {
          const float hd = h[d] + esum[d] + lam * pf[d];
          o.hp[3 * ci + d] = hd;
          a7[6] += pf[d] * hd;
        }
      }
#pragma unroll
      for (int n = 0; n < 7; ++n)
        for (int off = 16; off > 0; off >>= 1)
          a7[n] += __shfl_down_sync(0xffffffffu, a7[n], off);
      if ((threadIdx.x & 31) == 0 && k < K) {
        for (int d = 0; d < 6; ++d) wrow[6 * k + d] += a7[d];
        wrow[6 * K] += a7[6];
      }
    }
    cluster_total(R, NH, slot);

    // alpha and the pose updates, the same bits in every thread and block.
    float denom = R.tot[6 * K];
    for (int k = 0; k < K; ++k)
      for (int d = 0; d < 6; ++d)
        denom += pc->pp[k][d] * (R.tot[6 * k + d] + lam * pc->pp[k][d]);
    const float alpha = fabsf(denom) > 0.0f ? rz / denom : 0.0f;
    float xn = 0.0f, rn = 0.0f, zn = 0.0f;
    if (tid < 6 * K) {
      const int k = tid / 6, d = tid - 6 * (tid / 6);
      float rv6[6];
      for (int u = 0; u < 6; ++u)
        rv6[u] = pc->rp[k][u] - alpha * (R.tot[6 * k + u] + lam * pc->pp[k][u]);
      for (int u = 0; u < 6; ++u) zn += pc->Hinv[k][d * 6 + u] * rv6[u];
      xn = pc->xp[k][d] + alpha * pc->pp[k][d];
      rn = rv6[d];
    }
    __syncthreads();
    if (tid < 6 * K) {
      const int k = tid / 6, d = tid - 6 * (tid / 6);
      pc->xp[k][d] = xn;
      pc->rp[k][d] = rn;
      pc->zp[k][d] = zn;
    }

    acc2[0] = acc2[1] = 0.0f;
    for (int cid = tid; cid < K * own; cid += nt) {
      const int k = cid / own, lp = cid - k * own;
      const long ci = k * row + lp;
      const long gc = static_cast<long>(k) * P + c.p0 + lp;
      float r[3], z[3];
      for (int d = 0; d < 3; ++d) {
        o.x[3 * ci + d] += alpha * pf_all[3 * gc + d];
        r[d] = o.r[3 * ci + d] - alpha * o.hp[3 * ci + d];
        o.r[3 * ci + d] = r[d];
      }
      apply_minv(o.minv + 9 * ci, r, z);
      for (int d = 0; d < 3; ++d) {
        o.z[3 * ci + d] = z[d];
        acc2[0] += r[d] * z[d];
        acc2[1] += r[d] * r[d];
      }
    }
    warp_store(acc2, warp_row(R));
    cluster_total_begin(R, 2, slot);
    Pulled<kPull> zv;  // every block's z, loaded while the totals are read
    pull_start(zv, o.z, c, sl);
    cluster_total_end(R, 2, slot);
    float rz_new = R.tot[0], rr = R.tot[1];
    for (int k = 0; k < K; ++k)
      for (int d = 0; d < 6; ++d) {
        rz_new += pc->rp[k][d] * pc->zp[k][d];
        rr += pc->rp[k][d] * pc->rp[k][d];
      }
    const float beta = fabsf(rz) > 0.0f ? rz_new / rz : 0.0f;
    const bool done = rr <= kCgTol * kCgTol * b2;
    if (!done) rz = rz_new;
    if (tid < 6 * K) {
      const int k = tid / 6, d = tid - 6 * (tid / 6);
      pc->pp[k][d] = pc->zp[k][d] + beta * pc->pp[k][d];
    }
    if (done) break;  // x is final once converged
    pull_finish(zv, o.p, o.z, c, sl, true, beta);  // p = z + beta p
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads, 1)
ba_kernel(Inputs in, const float* __restrict__ params, float* scratch,
          float* out_pose, float* out_L, SmemPlan plan, int n_iters,
          int cg_iters) {
  extern __shared__ __align__(16) float smem[];
  __shared__ Reducer<kSums> R;
  __shared__ SharedLin slin[2];
  __shared__ PoseCG pose;
  __shared__ float s_q[kMaxK][4], s_t[kMaxK][3], s_qn[kMaxK][4],
      s_tn[kMaxK][3];
  __shared__ int s_off[kBlocks + 1];

  const int tid = threadIdx.x, nt = blockDim.x;
  const int K = in.K, P = in.P;
  in.info_s = params[8 + 8 * K];
  const Part c = part_of(in.pt_off, in.inc_ptr, plan.own);
  Own o;
  Lin trial;  // in global memory; copied to o.cur on acceptance
  carve(smem, scratch, in, c, plan, o, trial);
  const int own = c.p1 - c.p0;
  const long row = o.cur.row;
  const Slices sl{s_off, K, P, plan.own,
                  plan.own_sh ? 0L
                              : static_cast<long>(kOwnFloats) * K * plan.own};
  int slot = 0, n_lm = 0, n_trips = 0, n_lin = 0;

  for (int kl = tid; kl < c.k1 - c.k0; kl += nt) {
    const int kg = c.k0 + kl;
    const int e = in.inc_edge[kg];
    const bool iend = in.inc_sign[kg] > 0.0f;
    const int other = iend ? in.ej[e] : in.ei[e];
    float* rec = o.cur.es.at(kl);
    int mbits = 0;
    for (int k = 0; k < K; ++k) {
      if (in.smask[k * in.E + e] != 0.0f) mbits |= 1 << k;
      if (in.dmask[k * in.E + e] != 0.0f) mbits |= 1 << (8 + k);
    }
    rec[5 * K] = __int_as_float(iend ? other : -other - 1);
    rec[5 * K + 1] = __int_as_float(mbits);
    rec[5 * K + 2] = in.ew[e];
    rec[5 * K + 3] = in.ed0[e];
  }
  for (int cid = tid; cid < K * own; cid += nt) {
    const int k = cid / own, lp = cid - k * own;
    const long gc = static_cast<long>(k) * P + c.p0 + lp;
    for (int d = 0; d < 3; ++d) o.Lc[3 * (k * row + lp) + d] = in.L0[3 * gc + d];
  }
  for (long u = tid; u < 3L * K * P; u += nt) o.Lf[u] = in.L0[u];
  if (tid <= c.C) s_off[tid] = in.pt_off[tid];
  if (tid < K) {
    for (int d = 0; d < 4; ++d) s_q[tid][d] = params[8 + 8 * tid + d];
    for (int d = 0; d < 3; ++d) s_t[tid][d] = params[12 + 8 * tid + d];
  }
  __syncthreads();

  int cur = 0;
  linearize(in, c, o, o.cur, s_q, s_t, o.Lf, &slin[cur], R, slot);
  ++n_lin;
  // lambda0 = tau * max(diag of every H_pose and every landmark block).
  float dmax = -INFINITY;
  for (int cid = tid; cid < K * own; cid += nt) {
    const int k = cid / own, lp = cid - k * own;
    const float* D = o.cur.D + 6 * (k * row + lp);
    dmax = fmaxf(dmax, fmaxf(D[0], fmaxf(D[3], D[5])));
  }
  dmax = cluster_max(R, dmax, slot);
  for (int k = 0; k < K; ++k)
    for (int a = 0; a < 6; ++a) dmax = fmaxf(dmax, slin[cur].H[k][a * 6 + a]);
  float lam = kLmTau * dmax, nu = 2.0f;

  for (int it = 0; it < n_iters; ++it) {
    ++n_lm;
    pcg(in, c, o, &slin[cur], lam, cg_iters, &pose, R, slot, n_trips, sl);
    if (tid < K)
      se3_retract(s_q[tid], s_t[tid], pose.xp[tid], s_qn[tid], s_tn[tid]);
    // Trial landmarks + the landmark part of the gain-ratio denominator.
    float acc[1] = {0.0f};
    for (int cid = tid; cid < K * own; cid += nt) {
      const int k = cid / own, lp = cid - k * own;
      const long ci = k * row + lp;
      for (int d = 0; d < 3; ++d) {
        const float dx = o.x[3 * ci + d];
        o.Ln[3 * ci + d] = o.Lc[3 * ci + d] + dx;
        acc[0] += dx * (lam * dx - o.cur.gl[3 * ci + d]);
      }
    }
    warp_store(acc, warp_row(R));
    cluster_total(R, 1, slot);  // also publishes every block's trial copies
    const float denom_l = R.tot[0];
    gather(o.Lf, o.Ln, c, sl, false, 0.0f);
    __syncthreads();
    linearize(in, c, o, trial, s_qn, s_tn, o.Lf, &slin[1 - cur], R, slot);
    ++n_lin;
    float denom = denom_l;
    for (int k = 0; k < K; ++k)
      for (int d = 0; d < 6; ++d) {
        const float x = pose.xp[k][d];
        denom += x * (lam * x - slin[cur].g[k][d]);
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
      for (int cid = tid; cid < K * own; cid += nt) {
        const int k = cid / own, lp = cid - k * own;
        const long ci = k * row + lp, ti = k * trial.row + lp;
        for (int d = 0; d < 3; ++d) o.Lc[3 * ci + d] = o.Ln[3 * ci + d];
        for (int d = 0; d < 12; ++d) o.cur.Jp[12 * ci + d] = trial.Jp[12 * ti + d];
        for (int d = 0; d < 6; ++d) o.cur.Jl[6 * ci + d] = trial.Jl[6 * ti + d];
        o.cur.wr[ci] = trial.wr[ti];
        for (int d = 0; d < 3; ++d) o.cur.gl[3 * ci + d] = trial.gl[3 * ti + d];
        for (int d = 0; d < 6; ++d) o.cur.D[6 * ci + d] = trial.D[6 * ti + d];
      }
      for (int kl = tid; kl < c.k1 - c.k0; kl += nt) {
        float* dst = o.cur.es.at(kl);
        const float* src = trial.es.at(kl);
        for (int d = 0; d < 5 * K; ++d) dst[d] = src[d];
      }
      if (tid < K) {
        for (int d = 0; d < 4; ++d) s_q[tid][d] = s_qn[tid][d];
        for (int d = 0; d < 3; ++d) s_t[tid][d] = s_tn[tid][d];
      }
    }
    __syncthreads();
  }

  for (int cid = tid; cid < K * own; cid += nt) {
    const int k = cid / own, lp = cid - k * own;
    const long gc = static_cast<long>(k) * P + c.p0 + lp;
    const bool obs = in.omask[gc] != 0.0f;
    for (int d = 0; d < 3; ++d)
      out_L[3 * gc + d] = obs ? o.Lc[3 * (k * row + lp) + d] : in.L0[3 * gc + d];
  }
  if (c.rank == 0 && tid < K) {
    for (int d = 0; d < 4; ++d) out_pose[8 * tid + d] = s_q[tid][d];
    for (int d = 0; d < 3; ++d) out_pose[8 * tid + 4 + d] = s_t[tid][d];
    out_pose[8 * tid + 7] = 0.0f;
  }
  if (c.rank == 0 && tid == 0) {
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
extern "C" int nrslam_ba_blocks() { return nrslam::kBlocks; }

// Scratch size in floats for K keyframes, P points and a CSR of n_ends
// entries. The first 16 floats are a header of ints: LM steps, CG trips,
// linearisations, blocks, edge-end records in shared memory, full vectors
// in shared memory (0/1), dynamic shared bytes per block, owned state in
// shared memory (0/1).
extern "C" long nrslam_ba_scratch(int K, int P, int n_ends) {
  return nrslam::scratch_floats(K, P, n_ends);
}

// C entry point. Pointers are device pointers; params = (fx, fy, cx, cy,
// k0..k3, K x (q (4), t (3), 0), info_s). K <= 8. pt_off [kBlocks + 1] and
// the CSR (inc_ptr [P + 1], inc_edge / inc_sign [n_ends]) are the wrapper's
// layout. Returns a CUDA error code: cudaErrorInvalidValue for a bad K or
// P, cudaErrorInvalidConfiguration when the card cannot hold the cluster,
// else cudaGetLastError() after the launch.
extern "C" int nrslam_ba(
    const void* params, const void* L0, const void* obs, const void* omask,
    const void* ei, const void* ej, const void* ew, const void* ed0,
    const void* smask, const void* dmask, const void* pt_off,
    const void* inc_ptr, const void* inc_edge, const void* inc_sign,
    void* scratch, void* out_pose, void* out_L, int K, int P, int E,
    int n_ends, int kind, int n_iters, int cg_iters, void* stream) {
  if (K < 1 || K > nrslam::kMaxK || P < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  long avail = 0;
  cudaError_t err = nrslam::smem_available(nrslam::ba_kernel, &avail);
  if (err != cudaSuccess) return static_cast<int>(err);
  const nrslam::SmemPlan plan = nrslam::plan_smem(
      P, nrslam::kBlocks, nrslam::kOwnFloats * static_cast<long>(K),
      3L * K * P, 5L * K + 4, n_ends, avail);
  nrslam::Inputs in;
  in.cam = static_cast<const float*>(params);
  in.L0 = static_cast<const float*>(L0);
  in.obs = static_cast<const float*>(obs);
  in.omask = static_cast<const float*>(omask);
  in.ei = static_cast<const int*>(ei);
  in.ej = static_cast<const int*>(ej);
  in.ew = static_cast<const float*>(ew);
  in.ed0 = static_cast<const float*>(ed0);
  in.smask = static_cast<const float*>(smask);
  in.dmask = static_cast<const float*>(dmask);
  in.pt_off = static_cast<const int*>(pt_off);
  in.inc_ptr = static_cast<const int*>(inc_ptr);
  in.inc_edge = static_cast<const int*>(inc_edge);
  in.inc_sign = static_cast<const float*>(inc_sign);
  in.K = K;
  in.P = P;
  in.E = E;
  in.n_ends = n_ends;
  in.kind = kind;
  in.info_s = 0.0f;  // read from params on device
  return static_cast<int>(nrslam::launch_cluster(
      nrslam::ba_kernel, nrslam::kBlocks, nrslam::kThreads, plan.bytes,
      static_cast<cudaStream_t>(stream), in,
      static_cast<const float*>(params), static_cast<float*>(scratch),
      static_cast<float*>(out_pose), static_cast<float*>(out_L), plan,
      n_iters, cg_iters));
}
