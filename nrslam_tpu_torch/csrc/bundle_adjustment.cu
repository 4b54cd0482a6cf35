// Whole-schedule local deformable bundle adjustment in one launch.
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
// Hessian-vector products, each followed by block-wide dot products), not
// bytes: at K = 5, P = 768, E = 5376 the per-copy and per-edge state is
// ~3 MB and stays in L2. The TPU kernel's one-hot selector matmuls (bf16
// resident or int8 streamed) exist only because TPU gathers are slow; here
// each edge gathers L[k][i] and L[k][j] directly, in float32.
//
// Design: one block of 512 threads runs the whole schedule with no host
// round trip. Per-copy and per-edge linearisation state lives in a global
// scratch buffer the wrapper allocates (two copies, accepted and trial,
// swapped by index on acceptance, as are the landmark arrays). Edge terms
// are evaluated per edge for all K keyframes at once (the dampers couple
// consecutive keyframes); the scatter back to copies walks one CSR of each
// point's incident edges (built by the wrapper with a stable sort and shared
// by all keyframes), so every copy sums its edges in a fixed order:
// deterministic, no atomics. Masked reprojection, spring and damper terms
// are skipped, never multiplied by zero, so unobserved copies (invalid
// keyframe slots hold zeros that project to 0/0) cannot poison the sums, and
// they are returned bit-for-bit unchanged. Dot products are block
// reductions; the K 6x6 pose blocks (inverse, retraction, lambda control)
// are done by thread 0.

#include "common.cuh"

namespace nrslam {
namespace {

constexpr int kThreads = 512;
constexpr int kMaxK = 8;
constexpr float kTh2Dof = 5.99f;
constexpr float kTh3Dof = 0.584f;
constexpr float kInfoR = 4.0f;    // 1 / 0.5^2
constexpr float kInfoP = 100.0f;  // 1 / 0.1^2
constexpr float kSpringK = 1.1f;
constexpr float kLmTau = 1e-5f;
constexpr float kCgTol = 1e-8f;
constexpr int kLinSums = 28;               // 21 upper H_pose, 6 g_pose, chi2
constexpr int kHvSums = kMaxK * 6 + 1;     // K pose Hv parts + p . Hp

// One linearisation copy inside the scratch buffer (c = k * P + p indexes a
// landmark copy, ke = k * E + e a per-keyframe edge term).
struct Lin {
  float* Jp;  // [KP][12] pose Jacobian rows u (0..5) and v (6..11)
  float* Jl;  // [KP][6]  landmark Jacobian rows u (0..2) and v (3..5)
  float* wr;  // [KP]     IRLS reprojection weight (0 when unobserved)
  float* gl;  // [KP][3]  landmark gradient
  float* D;   // [KP][6]  landmark diagonal blocks (00 01 02 11 12 22)
  float* es;  // [KE][5]  a0, a1, a2, w_p, wd2 (damper to keyframe k + 1)
};

struct Scratch {
  Lin lin[2];
  float* eg;    // [KE][9] per-edge gradient (3) + D pack (6), or Hv (3)
  float* L[2];  // [KP][3] accepted / trial landmarks
  float* x;     // [KP][3] CG vectors
  float* r;
  float* p;
  float* z;
  float* hp;
  float* minv;  // [KP][9] inverted landmark blocks
};

__host__ __device__ inline long scratch_floats(int K, int P, int E) {
  const long KP = static_cast<long>(K) * P, KE = static_cast<long>(K) * E;
  return 2L * (28L * KP + 5L * KE) + 9L * KE + 6L * KP + 15L * KP + 9L * KP;
}

__device__ inline Scratch carve(float* base, int K, int P, int E) {
  const long KP = static_cast<long>(K) * P, KE = static_cast<long>(K) * E;
  Scratch s;
  float* c = base;
  for (int k = 0; k < 2; ++k) {
    s.lin[k].Jp = c; c += 12L * KP;
    s.lin[k].Jl = c; c += 6L * KP;
    s.lin[k].wr = c; c += KP;
    s.lin[k].gl = c; c += 3L * KP;
    s.lin[k].D = c; c += 6L * KP;
    s.lin[k].es = c; c += 5L * KE;
  }
  s.eg = c; c += 9L * KE;
  s.L[0] = c; c += 3L * KP;
  s.L[1] = c; c += 3L * KP;
  s.x = c; c += 3L * KP;
  s.r = c; c += 3L * KP;
  s.p = c; c += 3L * KP;
  s.z = c; c += 3L * KP;
  s.hp = c; c += 3L * KP;
  s.minv = c; c += 9L * KP;
  return s;
}

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
  const int* inc_ptr;     // [P + 1]
  const int* inc_edge;    // incident live edges of each point, fixed order
  const float* inc_sign;  // +1 when the point is the edge's i, -1 for j
  int K, P, E, kind;
  float info_s;           // params[8 + 8 K], loaded in the kernel
};

struct SharedLin {
  float H[kMaxK][36];
  float g[kMaxK][6];
  float chi2;
};

struct SharedCG {
  float Hinv[kMaxK][36];
  float xp[kMaxK][6], rp[kMaxK][6], zp[kMaxK][6], pp[kMaxK][6];
  float rz, b2, alpha, beta;
  int done;
};

__device__ inline void mat6_vec(const float M[36], const float v[6],
                                float o[6]) {
  for (int i = 0; i < 6; ++i) {
    float s = 0.0f;
    for (int j = 0; j < 6; ++j) s += M[i * 6 + j] * v[j];
    o[i] = s;
  }
}

__device__ inline void apply_minv(const float* M, const float* r, float* z) {
  for (int i = 0; i < 3; ++i)
    z[i] = M[3 * i] * r[0] + M[3 * i + 1] * r[1] + M[3 * i + 2] * r[2];
}

// Linearise at (q, t, L) into lin / slin.
__device__ void linearize(const Inputs& in, Scratch& s, float (*q)[4],
                          float (*t)[3], const float* L, const Lin& lin,
                          SharedLin* slin, float* red, float* tot) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int K = in.K, P = in.P, E = in.E;
  float chi2_e = 0.0f;

  // Edge phase: springs of every keyframe and dampers between consecutive
  // keyframes, combined per (keyframe, edge) before the scatter.
  for (int e = tid; e < E; e += nt) {
    const int i = in.ei[e], j = in.ej[e];
    const float w = in.ew[e], d0 = in.ed0[e];
    const float kd = kSpringK / d0;
    float sm[kMaxK], dl[kMaxK][3], wd2[kMaxK], dd[kMaxK][3];
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      sm[k] = 0.0f;
      wd2[k] = 0.0f;
      for (int c = 0; c < 3; ++c) dl[k][c] = dd[k][c] = 0.0f;
      if (k < K) {
        sm[k] = in.smask[k * E + e];
        if (sm[k] != 0.0f) {
          const float* Li = L + 3L * (static_cast<long>(k) * P + i);
          const float* Lj = L + 3L * (static_cast<long>(k) * P + j);
          for (int c = 0; c < 3; ++c) dl[k][c] = Li[c] - Lj[c];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxK - 1; ++k) {
      if (k + 1 < K) {
        const float dm = in.dmask[k * E + e];
        if (dm != 0.0f) {
          for (int c = 0; c < 3; ++c) dd[k][c] = dl[k + 1][c] - dl[k][c];
          const float chi2_d = in.info_s * (w * w) *
              (dd[k][0] * dd[k][0] + dd[k][1] * dd[k][1] + dd[k][2] * dd[k][2]);
          chi2_e += huber_rho(chi2_d, kTh3Dof) * dm;
          wd2[k] = in.info_s * huber_w(chi2_d, kTh3Dof) * dm * (w * w);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      if (k < K) {
        float a[3] = {0.0f, 0.0f, 0.0f}, g[3] = {0.0f, 0.0f, 0.0f}, wp = 0.0f;
        if (sm[k] != 0.0f) {
          const float dist = sqrtf(dl[k][0] * dl[k][0] + dl[k][1] * dl[k][1] +
                                   dl[k][2] * dl[k][2]);
          const float e_p = kSpringK * (dist - d0) / d0;
          chi2_e += kInfoP * e_p * e_p * sm[k];
          const float inv_dist = 1.0f / fmaxf(dist, 1e-12f);
          wp = kInfoP * sm[k];
          for (int c = 0; c < 3; ++c) {
            a[c] = kd * dl[k][c] * inv_dist;
            g[c] = wp * e_p * a[c];
          }
        }
        float extra = wd2[k];
        for (int c = 0; c < 3; ++c) g[c] -= wd2[k] * dd[k][c];
        if (k > 0) {
          extra += wd2[k - 1];
          for (int c = 0; c < 3; ++c) g[c] += wd2[k - 1] * dd[k - 1][c];
        }
        const long ke = static_cast<long>(k) * E + e;
        float* eg = s.eg + 9L * ke;
        eg[0] = g[0]; eg[1] = g[1]; eg[2] = g[2];
        eg[3] = wp * a[0] * a[0] + extra;
        eg[4] = wp * a[0] * a[1];
        eg[5] = wp * a[0] * a[2];
        eg[6] = wp * a[1] * a[1] + extra;
        eg[7] = wp * a[1] * a[2];
        eg[8] = wp * a[2] * a[2] + extra;
        float* es = lin.es + 5L * ke;
        es[0] = a[0]; es[1] = a[1]; es[2] = a[2]; es[3] = wp; es[4] = wd2[k];
      }
    }
  }
  if (tid == 0) slin->chi2 = 0.0f;
  __syncthreads();

  // Copy phase, one keyframe at a time (one block reduction each).
  for (int k = 0; k < K; ++k) {
    float acc[kLinSums];
#pragma unroll
    for (int c = 0; c < kLinSums; ++c) acc[c] = 0.0f;
    if (k == 0) acc[27] = chi2_e;
    float R[9];
    quat_to_matrix(q[k], R);
    const float t0 = t[k][0], t1 = t[k][1], t2 = t[k][2];
    for (int p = tid; p < P; p += nt) {
      const long c = static_cast<long>(k) * P + p;
      const float m = in.omask[c];
      float Ju[6], Jv[6], Jlu[3], Jlv[3], w_r = 0.0f, eu = 0.0f, ev = 0.0f;
      if (m != 0.0f) {
        const float* X = L + 3 * c;
        const float xc = R[0] * X[0] + R[1] * X[1] + R[2] * X[2] + t0;
        const float yc = R[3] * X[0] + R[4] * X[1] + R[5] * X[2] + t1;
        const float zc = R[6] * X[0] + R[7] * X[1] + R[8] * X[2] + t2;
        float pu, pv, J[6];
        project_with_jacobian(in.kind, in.cam, xc, yc, zc, &pu, &pv, J);
        eu = in.obs[2 * c] - pu;
        ev = in.obs[2 * c + 1] - pv;
        const float chi2_r = kInfoR * (eu * eu + ev * ev);
        w_r = kInfoR * huber_w(chi2_r, kTh2Dof) * m;
        acc[27] += huber_rho(chi2_r, kTh2Dof) * m;
        pose_jacobian(J, xc, yc, zc, Ju, Jv);
        for (int d = 0; d < 3; ++d) {
          Jlu[d] = -(J[0] * R[d] + J[1] * R[3 + d] + J[2] * R[6 + d]);
          Jlv[d] = -(J[3] * R[d] + J[4] * R[3 + d] + J[5] * R[6 + d]);
        }
      } else {
        for (int d = 0; d < 6; ++d) Ju[d] = Jv[d] = 0.0f;
        for (int d = 0; d < 3; ++d) Jlu[d] = Jlv[d] = 0.0f;
      }
      float gsum[3] = {0.0f, 0.0f, 0.0f}, dsum[6] = {0, 0, 0, 0, 0, 0};
      for (int n = in.inc_ptr[p]; n < in.inc_ptr[p + 1]; ++n) {
        const float* eg = s.eg + 9L * (static_cast<long>(k) * E + in.inc_edge[n]);
        const float sg = in.inc_sign[n];
        for (int d = 0; d < 3; ++d) gsum[d] += sg * eg[d];
        for (int d = 0; d < 6; ++d) dsum[d] += eg[3 + d];
      }
      float* Jp = lin.Jp + 12 * c;
      float* Jl = lin.Jl + 6 * c;
      for (int d = 0; d < 6; ++d) { Jp[d] = Ju[d]; Jp[6 + d] = Jv[d]; }
      for (int d = 0; d < 3; ++d) { Jl[d] = Jlu[d]; Jl[3 + d] = Jlv[d]; }
      lin.wr[c] = w_r;
      for (int d = 0; d < 3; ++d)
        lin.gl[3 * c + d] = w_r * (Jlu[d] * eu + Jlv[d] * ev) + gsum[d];
      const int ia[6] = {0, 0, 0, 1, 1, 2}, ib[6] = {0, 1, 2, 1, 2, 2};
      for (int d = 0; d < 6; ++d)
        lin.D[6 * c + d] =
            w_r * (Jlu[ia[d]] * Jlu[ib[d]] + Jlv[ia[d]] * Jlv[ib[d]]) + dsum[d];
      int n = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a)
#pragma unroll
        for (int b = a; b < 6; ++b)
          acc[n++] += w_r * (Ju[a] * Ju[b] + Jv[a] * Jv[b]);
#pragma unroll
      for (int a = 0; a < 6; ++a) acc[21 + a] += w_r * (Ju[a] * eu + Jv[a] * ev);
    }
    block_sum<kLinSums>(acc, red, tot);
    if (tid == 0) {
      int n = 0;
      for (int a = 0; a < 6; ++a)
        for (int b = a; b < 6; ++b) {
          slin->H[k][a * 6 + b] = tot[n];
          slin->H[k][b * 6 + a] = tot[n];
          ++n;
        }
      for (int a = 0; a < 6; ++a) slin->g[k][a] = tot[21 + a];
      slin->chi2 += tot[27];
    }
    __syncthreads();
  }
}

// Fixed-trip block-Jacobi PCG for (H + lam I) dx = -g at lin; the result is
// cg.xp (poses) and s.x (landmarks). Exits once converged (x no longer
// changes in the plain driver's fixed-trip loop either).
__device__ void pcg(const Inputs& in, Scratch& s, const Lin& lin,
                    const SharedLin* slin, float lam, int iters,
                    SharedCG* cg, float* red, float* tot) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int K = in.K, P = in.P, E = in.E;
  const long KP = static_cast<long>(K) * P;
  if (tid < K) inv6(slin->H[tid], lam, cg->Hinv[tid]);
  float acc2[2] = {0.0f, 0.0f};
  for (long c = tid; c < KP; c += nt) {
    const float* D = lin.D + 6 * c;
    const float m[9] = {D[0] + lam, D[1], D[2], D[1], D[3] + lam, D[4],
                        D[2], D[4], D[5] + lam};
    float* mi = s.minv + 9 * c;
    inv3(m, mi);
    float r[3], z[3];
    for (int d = 0; d < 3; ++d) {
      r[d] = -lin.gl[3 * c + d];
      s.x[3 * c + d] = 0.0f;
      s.r[3 * c + d] = r[d];
    }
    apply_minv(mi, r, z);
    for (int d = 0; d < 3; ++d) {
      s.z[3 * c + d] = z[d];
      s.p[3 * c + d] = z[d];
      acc2[0] += r[d] * z[d];
      acc2[1] += r[d] * r[d];
    }
  }
  block_sum<2>(acc2, red, tot);
  if (tid == 0) {
    float rz = 0.0f, b2 = 0.0f;
    for (int k = 0; k < K; ++k) {
      for (int d = 0; d < 6; ++d) cg->rp[k][d] = -slin->g[k][d];
      mat6_vec(cg->Hinv[k], cg->rp[k], cg->zp[k]);
      for (int d = 0; d < 6; ++d) {
        cg->xp[k][d] = 0.0f;
        cg->pp[k][d] = cg->zp[k][d];
        rz += cg->rp[k][d] * cg->zp[k][d];
        b2 += cg->rp[k][d] * cg->rp[k][d];
      }
    }
    cg->rz = rz + tot[0];
    cg->b2 = b2 + tot[1];
    cg->done = 0;
  }
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    // Hv, edge part: per keyframe w_p (a . dv) a, minus the damper to the
    // next keyframe, plus the damper from the previous one.
    for (int e = tid; e < E; e += nt) {
      const int i = in.ei[e], j = in.ej[e];
      float dv[kMaxK][3], sv[kMaxK][3];
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        for (int c = 0; c < 3; ++c) dv[k][c] = sv[k][c] = 0.0f;
        if (k < K && lin.es[5L * (static_cast<long>(k) * E + e) + 3] != 0.0f) {
          const float* pi = s.p + 3L * (static_cast<long>(k) * P + i);
          const float* pj = s.p + 3L * (static_cast<long>(k) * P + j);
          for (int c = 0; c < 3; ++c) dv[k][c] = pi[c] - pj[c];
        }
      }
#pragma unroll
      for (int k = 0; k < kMaxK - 1; ++k) {
        if (k + 1 < K) {
          const float wd2 = lin.es[5L * (static_cast<long>(k) * E + e) + 4];
          if (wd2 != 0.0f)
            for (int c = 0; c < 3; ++c) sv[k][c] = wd2 * (dv[k + 1][c] - dv[k][c]);
        }
      }
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        if (k < K) {
          const long ke = static_cast<long>(k) * E + e;
          const float* es = lin.es + 5L * ke;
          const float wad =
              es[3] * (es[0] * dv[k][0] + es[1] * dv[k][1] + es[2] * dv[k][2]);
          float* ev = s.eg + 9L * ke;
          for (int c = 0; c < 3; ++c) {
            float v = wad * es[c] - sv[k][c];
            if (k > 0) v += sv[k - 1][c];
            ev[c] = v;
          }
        }
      }
    }
    __syncthreads();
    // Hv, copy part + pose partials + p . Hp.
    float acc[kHvSums];
#pragma unroll
    for (int c = 0; c < kHvSums; ++c) acc[c] = 0.0f;
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      if (k < K) {
        float ppk[6];
        for (int d = 0; d < 6; ++d) ppk[d] = cg->pp[k][d];
        for (int p = tid; p < P; p += nt) {
          const long c = static_cast<long>(k) * P + p;
          const float w = lin.wr[c];
          const float pf0 = s.p[3 * c], pf1 = s.p[3 * c + 1], pf2 = s.p[3 * c + 2];
          float esum[3] = {0.0f, 0.0f, 0.0f};
          for (int n = in.inc_ptr[p]; n < in.inc_ptr[p + 1]; ++n) {
            const float* ev =
                s.eg + 9L * (static_cast<long>(k) * E + in.inc_edge[n]);
            const float sg = in.inc_sign[n];
            for (int d = 0; d < 3; ++d) esum[d] += sg * ev[d];
          }
          float h[3];
          if (w != 0.0f) {
            const float* Jp = lin.Jp + 12 * c;
            const float* Jl = lin.Jl + 6 * c;
            float ru = Jl[0] * pf0 + Jl[1] * pf1 + Jl[2] * pf2;
            float rv = Jl[3] * pf0 + Jl[4] * pf1 + Jl[5] * pf2;
            for (int d = 0; d < 6; ++d) {
              ru += Jp[d] * ppk[d];
              rv += Jp[6 + d] * ppk[d];
            }
            for (int d = 0; d < 3; ++d) h[d] = w * (Jl[d] * ru + Jl[3 + d] * rv);
            for (int d = 0; d < 6; ++d)
              acc[6 * k + d] += w * (Jp[d] * ru + Jp[6 + d] * rv);
          } else {
            h[0] = h[1] = h[2] = 0.0f;
          }
          const float pf[3] = {pf0, pf1, pf2};
          for (int d = 0; d < 3; ++d) {
            const float hd = h[d] + esum[d] + lam * pf[d];
            s.hp[3 * c + d] = hd;
            acc[kHvSums - 1] += pf[d] * hd;
          }
        }
      }
    }
    block_sum<kHvSums>(acc, red, tot);
    if (tid == 0) {
      float denom = tot[kHvSums - 1];
      float hpp[kMaxK][6];
      for (int k = 0; k < K; ++k)
        for (int d = 0; d < 6; ++d) {
          hpp[k][d] = tot[6 * k + d] + lam * cg->pp[k][d];
          denom += cg->pp[k][d] * hpp[k][d];
        }
      const float alpha = fabsf(denom) > 0.0f ? cg->rz / denom : 0.0f;
      cg->alpha = alpha;
      for (int k = 0; k < K; ++k) {
        for (int d = 0; d < 6; ++d) {
          cg->xp[k][d] += alpha * cg->pp[k][d];
          cg->rp[k][d] -= alpha * hpp[k][d];
        }
        mat6_vec(cg->Hinv[k], cg->rp[k], cg->zp[k]);
      }
    }
    __syncthreads();
    const float alpha = cg->alpha;
    acc2[0] = acc2[1] = 0.0f;
    for (long c = tid; c < KP; c += nt) {
      float r[3], z[3];
      for (int d = 0; d < 3; ++d) {
        s.x[3 * c + d] += alpha * s.p[3 * c + d];
        r[d] = s.r[3 * c + d] - alpha * s.hp[3 * c + d];
        s.r[3 * c + d] = r[d];
      }
      apply_minv(s.minv + 9 * c, r, z);
      for (int d = 0; d < 3; ++d) {
        s.z[3 * c + d] = z[d];
        acc2[0] += r[d] * z[d];
        acc2[1] += r[d] * r[d];
      }
    }
    block_sum<2>(acc2, red, tot);
    if (tid == 0) {
      float rz_new = tot[0], rr = tot[1];
      for (int k = 0; k < K; ++k)
        for (int d = 0; d < 6; ++d) {
          rz_new += cg->rp[k][d] * cg->zp[k][d];
          rr += cg->rp[k][d] * cg->rp[k][d];
        }
      const float beta = fabsf(cg->rz) > 0.0f ? rz_new / cg->rz : 0.0f;
      cg->beta = beta;
      for (int k = 0; k < K; ++k)
        for (int d = 0; d < 6; ++d)
          cg->pp[k][d] = cg->zp[k][d] + beta * cg->pp[k][d];
      cg->done = rr <= kCgTol * kCgTol * cg->b2;
      if (!cg->done) cg->rz = rz_new;
    }
    __syncthreads();
    if (cg->done) break;  // x is final once converged
    const float beta = cg->beta;
    for (long c = tid; c < KP; c += nt)
      for (int d = 0; d < 3; ++d)
        s.p[3 * c + d] = s.z[3 * c + d] + beta * s.p[3 * c + d];
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
ba_kernel(Inputs in, const float* __restrict__ params, float* scratch,
          float* out_pose, float* out_L, int n_iters, int cg_iters) {
  __shared__ float red[32 * kHvSums];
  __shared__ float tot[kHvSums];
  __shared__ SharedLin slin[2];
  __shared__ SharedCG cg;
  __shared__ float s_q[kMaxK][4], s_t[kMaxK][3], s_qn[kMaxK][4],
      s_tn[kMaxK][3];
  __shared__ float s_lam, s_nu;
  __shared__ int s_cur;

  const int tid = threadIdx.x, nt = blockDim.x;
  const int K = in.K, P = in.P;
  const long KP = static_cast<long>(K) * P;
  in.info_s = params[8 + 8 * K];
  Scratch s = carve(scratch, K, P, in.E);

  for (long c = tid; c < 3 * KP; c += nt) s.L[0][c] = in.L0[c];
  if (tid < K) {
    for (int d = 0; d < 4; ++d) s_q[tid][d] = params[8 + 8 * tid + d];
    for (int d = 0; d < 3; ++d) s_t[tid][d] = params[12 + 8 * tid + d];
  }
  if (tid == 0) s_cur = 0;
  __syncthreads();

  linearize(in, s, s_q, s_t, s.L[0], s.lin[0], &slin[0], red, tot);
  // lambda0 = tau * max(diag of every H_pose and every landmark block).
  float dmax = -INFINITY;
  for (long c = tid; c < KP; c += nt) {
    const float* D = s.lin[0].D + 6 * c;
    dmax = fmaxf(dmax, fmaxf(D[0], fmaxf(D[3], D[5])));
  }
  dmax = block_max(dmax, red);
  if (tid == 0) {
    for (int k = 0; k < K; ++k)
      for (int a = 0; a < 6; ++a) dmax = fmaxf(dmax, slin[0].H[k][a * 6 + a]);
    s_lam = kLmTau * dmax;
    s_nu = 2.0f;
  }
  __syncthreads();

  for (int it = 0; it < n_iters; ++it) {
    const int cur = s_cur;
    const float lam = s_lam;
    pcg(in, s, s.lin[cur], &slin[cur], lam, cg_iters, &cg, red, tot);
    if (tid < K) se3_retract(s_q[tid], s_t[tid], cg.xp[tid], s_qn[tid], s_tn[tid]);
    // Trial landmarks + the landmark part of the gain-ratio denominator.
    float acc[1] = {0.0f};
    const float* Lc = s.L[cur];
    float* Ln = s.L[1 - cur];
    const float* gl = s.lin[cur].gl;
    for (long c = tid; c < 3 * KP; c += nt) {
      const float dx = s.x[c];
      Ln[c] = Lc[c] + dx;
      acc[0] += dx * (lam * dx - gl[c]);
    }
    block_sum<1>(acc, red, tot);
    const float denom_l = tot[0];
    linearize(in, s, s_qn, s_tn, Ln, s.lin[1 - cur], &slin[1 - cur], red, tot);
    if (tid == 0) {
      float denom = denom_l;
      for (int k = 0; k < K; ++k)
        for (int d = 0; d < 6; ++d) {
          const float x = cg.xp[k][d];
          denom += x * (lam * x - slin[cur].g[k][d]);
        }
      const float rho = (slin[cur].chi2 - slin[1 - cur].chi2)
                        / (fabsf(denom) > 0.0f ? denom : 1.0f);
      const bool accepted = rho > 0.0f;
      const float c3 = 2.0f * rho - 1.0f;
      const float shrink = fmaxf(1.0f / 3.0f, 1.0f - c3 * c3 * c3);
      s_lam = accepted ? lam * shrink : lam * s_nu;
      s_nu = accepted ? 2.0f : s_nu * 2.0f;
      if (accepted) {
        s_cur = 1 - cur;
        for (int k = 0; k < K; ++k) {
          for (int d = 0; d < 4; ++d) s_q[k][d] = s_qn[k][d];
          for (int d = 0; d < 3; ++d) s_t[k][d] = s_tn[k][d];
        }
      }
    }
    __syncthreads();
  }

  const float* Lf = s.L[s_cur];
  for (long c = tid; c < KP; c += nt) {
    const bool obs = in.omask[c] != 0.0f;
    for (int d = 0; d < 3; ++d)
      out_L[3 * c + d] = obs ? Lf[3 * c + d] : in.L0[3 * c + d];
  }
  if (tid < K) {
    for (int d = 0; d < 4; ++d) out_pose[8 * tid + d] = s_q[tid][d];
    for (int d = 0; d < 3; ++d) out_pose[8 * tid + 4 + d] = s_t[tid][d];
    out_pose[8 * tid + 7] = 0.0f;
  }
}

}  // namespace
}  // namespace nrslam

// Scratch size in floats for K keyframes, P points and E edges.
extern "C" long nrslam_ba_scratch(int K, int P, int E) {
  return nrslam::scratch_floats(K, P, E);
}

// C entry point. Pointers are device pointers; params = (fx, fy, cx, cy,
// k0..k3, K x (q (4), t (3), 0), info_s). K <= 8. Returns
// cudaGetLastError().
extern "C" int nrslam_ba(
    const void* params, const void* L0, const void* obs, const void* omask,
    const void* ei, const void* ej, const void* ew, const void* ed0,
    const void* smask, const void* dmask, const void* inc_ptr,
    const void* inc_edge, const void* inc_sign, void* scratch,
    void* out_pose, void* out_L, int K, int P, int E, int kind, int n_iters,
    int cg_iters, void* stream) {
  if (K < 1 || K > nrslam::kMaxK) return static_cast<int>(cudaErrorInvalidValue);
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
  in.inc_ptr = static_cast<const int*>(inc_ptr);
  in.inc_edge = static_cast<const int*>(inc_edge);
  in.inc_sign = static_cast<const float*>(inc_sign);
  in.K = K;
  in.P = P;
  in.E = E;
  in.kind = kind;
  in.info_s = 0.0f;  // read from params on device
  nrslam::ba_kernel<<<1, nrslam::kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      in, static_cast<const float*>(params), static_cast<float*>(scratch),
      static_cast<float*>(out_pose), static_cast<float*>(out_L), n_iters,
      cg_iters);
  return static_cast<int>(cudaGetLastError());
}
