// Whole-schedule joint pose + deformation LM in one launch.
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
// products per call, each followed by block-wide dot products), not bytes:
// at P = 768 and E = 5376 the whole per-point and per-edge state is < 1 MB
// and stays in L2. The TPU kernel's one-hot selector matmuls (bf16 resident
// or int8 streamed, hi/lo split) exist only because TPU gathers are slow;
// here edges gather flows[i] and flows[j] directly, all in float32.
//
// Design: one block of 512 threads runs the whole schedule with no host
// round trip. Per-point and per-edge linearization state lives in a global
// scratch buffer the wrapper allocates (two copies, current and trial,
// swapped by index on acceptance instead of copied). Edge terms are
// evaluated per edge; the scatter back to points (gradient, Hv and the
// Jacobi diagonal) walks a CSR of each point's incident edges, built by the
// wrapper with a stable sort, so every point sums its edges in a fixed
// order: deterministic, no atomics. Dot products are block reductions; the
// 6x6 pose block (inverse, retraction, lambda control) is done by thread 0.

#include "common.cuh"

namespace nrslam {
namespace {

constexpr int kThreads = 512;
constexpr float kTh2Dof = 5.99f;
constexpr float kTh3Dof = 0.584f;
constexpr float kSpringK = 1.1f;
constexpr float kLmTau = 1e-5f;
constexpr float kCgTol = 1e-8f;

// Float offsets of one linearization copy inside the scratch buffer.
struct Lin {
  float* Jp;     // [P][12] pose Jacobian rows u (0..5) and v (6..11)
  float* Jf;     // [P][6]  flow Jacobian rows u (0..2) and v (3..5)
  float* wr;     // [P]     IRLS reprojection weight (info * huber * mask)
  float* chi2r;  // [P]     reprojection chi2
  float* gf;     // [P][3]  flow gradient
  float* D;      // [P][6]  flow diagonal blocks (00 01 02 11 12 22)
  float* es;     // [E][6]  ws, w_p, a0, a1, a2, chi2_s
};

struct Scratch {
  Lin lin[2];
  float* drest;  // [E][3] rest-position edge differences
  float* eg;     // [E][9] per-edge gradient (3) + D pack (6), or Hv (3)
  float* flows[2];
  float* x;      // [P][3] CG vectors
  float* r;
  float* p;
  float* z;
  float* hp;
  float* minv;   // [P][9] inverted flow blocks
  float* pmask;  // [P] live point mask of the round
  float* smask;  // [E] re-levelled spatial mask
};

__host__ __device__ inline long scratch_floats(int P, int E) {
  return 2L * (29L * P + 6L * E) + 3L * E + 9L * E + 6L * P + 15L * P +
         9L * P + P + E;
}

__device__ inline Scratch carve(float* base, int P, int E) {
  Scratch s;
  float* c = base;
  for (int k = 0; k < 2; ++k) {
    s.lin[k].Jp = c; c += 12L * P;
    s.lin[k].Jf = c; c += 6L * P;
    s.lin[k].wr = c; c += P;
    s.lin[k].chi2r = c; c += P;
    s.lin[k].gf = c; c += 3L * P;
    s.lin[k].D = c; c += 6L * P;
    s.lin[k].es = c; c += 6L * E;
  }
  s.drest = c; c += 3L * E;
  s.eg = c; c += 9L * E;
  s.flows[0] = c; c += 3L * P;
  s.flows[1] = c; c += 3L * P;
  s.x = c; c += 3L * P;
  s.r = c; c += 3L * P;
  s.p = c; c += 3L * P;
  s.z = c; c += 3L * P;
  s.hp = c; c += 3L * P;
  s.minv = c; c += 9L * P;
  s.pmask = c; c += P;
  s.smask = c; c += E;
  return s;
}

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
  const int* inc_ptr;   // [P + 1]
  const int* inc_edge;  // incident edges of each point, fixed order
  const float* inc_sign;// +1 when the point is the edge's i, -1 for j
  int P, E, kind;
  float info_r, info_s, info_p;  // params[15..17], loaded in the kernel
};

// Shared per-linearization scalars (two copies, indexed like Scratch::lin).
struct SharedLin {
  float H[36];
  float g[6];
  float chi2;
};

constexpr int kSysSums = 28;  // 21 upper H_pose, 6 g_pose, 1 chi2

// Linearize at (q, t, flows) into lin / slin. point_mask gates the
// reprojection terms, smask the dampers (springs always use the base mask).
__device__ void linearize(const Inputs& in, Scratch& s, const float* q,
                          const float* t, const float* flows,
                          const float* point_mask, const float* smask,
                          const Lin& lin, SharedLin* slin, float* red,
                          float* tot) {
  const int tid = threadIdx.x, nt = blockDim.x;
  float acc[kSysSums];
#pragma unroll
  for (int k = 0; k < kSysSums; ++k) acc[k] = 0.0f;

  // Edge phase.
  for (int e = tid; e < in.E; e += nt) {
    float* es = lin.es + 6L * e;
    float* eg = s.eg + 9L * e;
    const float pm = in.ebase[e];
    if (pm == 0.0f) {
      for (int k = 0; k < 6; ++k) es[k] = 0.0f;
      continue;
    }
    const int i = in.ei[e], j = in.ej[e];
    const float df0 = flows[3 * i] - flows[3 * j];
    const float df1 = flows[3 * i + 1] - flows[3 * j + 1];
    const float df2 = flows[3 * i + 2] - flows[3 * j + 2];
    const float w = in.ew[e], d0 = in.ed0[e], sm = smask[e];
    const float chi2_s = in.info_s * (w * w) * (df0 * df0 + df1 * df1 + df2 * df2);
    const float w_s = in.info_s * huber_w(chi2_s, kTh3Dof) * sm;
    const float diff0 = s.drest[3 * e] + df0;
    const float diff1 = s.drest[3 * e + 1] + df1;
    const float diff2 = s.drest[3 * e + 2] + df2;
    const float dist = sqrtf(diff0 * diff0 + diff1 * diff1 + diff2 * diff2);
    const float e_p = kSpringK * (dist - d0) / d0;
    const float chi2_p = in.info_p * e_p * e_p;
    const float w_p = in.info_p * huber_w(chi2_p, kTh3Dof) * pm;
    acc[27] += huber_rho(chi2_s, kTh3Dof) * sm + huber_rho(chi2_p, kTh3Dof) * pm;
    const float ws = w * w * w_s;
    const float kd = kSpringK / d0;
    const float inv_dist = 1.0f / fmaxf(dist, 1e-12f);
    const float a0 = kd * diff0 * inv_dist;
    const float a1 = kd * diff1 * inv_dist;
    const float a2 = kd * diff2 * inv_dist;
    const float wpe = w_p * e_p;
    eg[0] = ws * df0 + wpe * a0;
    eg[1] = ws * df1 + wpe * a1;
    eg[2] = ws * df2 + wpe * a2;
    eg[3] = ws + w_p * a0 * a0;
    eg[4] = w_p * a0 * a1;
    eg[5] = w_p * a0 * a2;
    eg[6] = ws + w_p * a1 * a1;
    eg[7] = w_p * a1 * a2;
    eg[8] = ws + w_p * a2 * a2;
    es[0] = ws; es[1] = w_p; es[2] = a0; es[3] = a1; es[4] = a2;
    es[5] = chi2_s;
  }
  __syncthreads();

  // Point phase.
  float R[9];
  quat_to_matrix(q, R);
  for (int p = tid; p < in.P; p += nt) {
    const float x = in.rest[3 * p] + flows[3 * p];
    const float y = in.rest[3 * p + 1] + flows[3 * p + 1];
    const float z = in.rest[3 * p + 2] + flows[3 * p + 2];
    const float xc = R[0] * x + R[1] * y + R[2] * z + t[0];
    const float yc = R[3] * x + R[4] * y + R[5] * z + t[1];
    const float zc = R[6] * x + R[7] * y + R[8] * z + t[2];
    float pu, pv, J[6];
    project_with_jacobian(in.kind, in.cam, xc, yc, zc, &pu, &pv, J);
    const float eu = in.obs[2 * p] - pu, ev = in.obs[2 * p + 1] - pv;
    const float chi2_r = in.info_r * (eu * eu + ev * ev);
    const float m = point_mask[p];
    float Ju[6], Jv[6], Jfu[3], Jfv[3], w_r = 0.0f;
    if (m != 0.0f) {
      w_r = in.info_r * huber_w(chi2_r, kTh2Dof) * m;
      pose_jacobian(J, xc, yc, zc, Ju, Jv);
      for (int c = 0; c < 3; ++c) {
        Jfu[c] = -(J[0] * R[c] + J[1] * R[3 + c] + J[2] * R[6 + c]);
        Jfv[c] = -(J[3] * R[c] + J[4] * R[3 + c] + J[5] * R[6 + c]);
      }
      acc[27] += huber_rho(chi2_r, kTh2Dof) * m;
    } else {
      for (int c = 0; c < 6; ++c) Ju[c] = Jv[c] = 0.0f;
      for (int c = 0; c < 3; ++c) Jfu[c] = Jfv[c] = 0.0f;
    }
    float gsum[3] = {0.0f, 0.0f, 0.0f}, dsum[6] = {0, 0, 0, 0, 0, 0};
    for (int k = in.inc_ptr[p]; k < in.inc_ptr[p + 1]; ++k) {
      const float* eg = s.eg + 9L * in.inc_edge[k];
      const float sg = in.inc_sign[k];
      for (int c = 0; c < 3; ++c) gsum[c] += sg * eg[c];
      for (int c = 0; c < 6; ++c) dsum[c] += eg[3 + c];
    }
    float* Jp = lin.Jp + 12L * p;
    float* Jf = lin.Jf + 6L * p;
    for (int c = 0; c < 6; ++c) { Jp[c] = Ju[c]; Jp[6 + c] = Jv[c]; }
    for (int c = 0; c < 3; ++c) { Jf[c] = Jfu[c]; Jf[3 + c] = Jfv[c]; }
    lin.wr[p] = w_r;
    lin.chi2r[p] = chi2_r;
    for (int c = 0; c < 3; ++c)
      lin.gf[3 * p + c] = w_r * (Jfu[c] * eu + Jfv[c] * ev) + gsum[c];
    const int ia[6] = {0, 0, 0, 1, 1, 2}, ib[6] = {0, 1, 2, 1, 2, 2};
    for (int c = 0; c < 6; ++c)
      lin.D[6 * p + c] = w_r * (Jfu[ia[c]] * Jfu[ib[c]] + Jfv[ia[c]] * Jfv[ib[c]])
                         + dsum[c];
    int k = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a)
#pragma unroll
      for (int b = a; b < 6; ++b) acc[k++] += w_r * (Ju[a] * Ju[b] + Jv[a] * Jv[b]);
#pragma unroll
    for (int a = 0; a < 6; ++a) acc[21 + a] += w_r * (Ju[a] * eu + Jv[a] * ev);
  }
  block_sum<kSysSums>(acc, red, tot);
  if (tid == 0) {
    int k = 0;
    for (int a = 0; a < 6; ++a)
      for (int b = a; b < 6; ++b) {
        slin->H[a * 6 + b] = tot[k];
        slin->H[b * 6 + a] = tot[k];
        ++k;
      }
    for (int a = 0; a < 6; ++a) slin->g[a] = tot[21 + a];
    slin->chi2 = tot[27];
  }
  __syncthreads();
}

// Shared state of the PCG's pose part (6-vectors) and scalars.
struct SharedCG {
  float Hinv[36];
  float xp[6], rp[6], zp[6], pp[6], hpp[6];
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

// Fixed-trip block-Jacobi PCG for (H + lam I) dx = -g at lin; the result is
// cg.xp (pose) and s.x (flows). Exits once converged (x no longer changes).
__device__ void pcg(const Inputs& in, Scratch& s, const Lin& lin,
                    const SharedLin* slin, float lam, int iters,
                    SharedCG* cg, float* red, float* tot) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (tid == 0) inv6(slin->H, lam, cg->Hinv);
  float acc2[2] = {0.0f, 0.0f}, acc7[7];
  for (int p = tid; p < in.P; p += nt) {
    const float* D = lin.D + 6 * p;
    const float m[9] = {D[0] + lam, D[1], D[2], D[1], D[3] + lam, D[4],
                        D[2], D[4], D[5] + lam};
    float* mi = s.minv + 9 * p;
    inv3(m, mi);
    float r[3], z[3];
    for (int c = 0; c < 3; ++c) {
      r[c] = -lin.gf[3 * p + c];
      s.x[3 * p + c] = 0.0f;
      s.r[3 * p + c] = r[c];
    }
    apply_minv(mi, r, z);
    for (int c = 0; c < 3; ++c) {
      s.z[3 * p + c] = z[c];
      s.p[3 * p + c] = z[c];
      acc2[0] += r[c] * z[c];
      acc2[1] += r[c] * r[c];
    }
  }
  block_sum<2>(acc2, red, tot);
  if (tid == 0) {
    float rz = 0.0f, b2 = 0.0f;
    for (int c = 0; c < 6; ++c) cg->rp[c] = -slin->g[c];
    mat6_vec(cg->Hinv, cg->rp, cg->zp);
    for (int c = 0; c < 6; ++c) {
      cg->xp[c] = 0.0f;
      cg->pp[c] = cg->zp[c];
      rz += cg->rp[c] * cg->zp[c];
      b2 += cg->rp[c] * cg->rp[c];
    }
    cg->rz = rz + tot[0];
    cg->b2 = b2 + tot[1];
    cg->done = 0;
  }
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    // Hv, edge part: ev = ws dv + w_p (a . dv) a with dv = p_i - p_j.
    for (int e = tid; e < in.E; e += nt) {
      if (in.ebase[e] == 0.0f) continue;
      const float* es = lin.es + 6L * e;
      const int i = in.ei[e], j = in.ej[e];
      const float dv0 = s.p[3 * i] - s.p[3 * j];
      const float dv1 = s.p[3 * i + 1] - s.p[3 * j + 1];
      const float dv2 = s.p[3 * i + 2] - s.p[3 * j + 2];
      const float wad = es[1] * (es[2] * dv0 + es[3] * dv1 + es[4] * dv2);
      float* ev = s.eg + 9L * e;
      ev[0] = es[0] * dv0 + wad * es[2];
      ev[1] = es[0] * dv1 + wad * es[3];
      ev[2] = es[0] * dv2 + wad * es[4];
    }
    __syncthreads();
    // Hv, point part + pose partials + p . Hp.
    for (int c = 0; c < 7; ++c) acc7[c] = 0.0f;
    for (int p = tid; p < in.P; p += nt) {
      const float* Jp = lin.Jp + 12L * p;
      const float* Jf = lin.Jf + 6L * p;
      const float pf0 = s.p[3 * p], pf1 = s.p[3 * p + 1], pf2 = s.p[3 * p + 2];
      float ru = Jf[0] * pf0 + Jf[1] * pf1 + Jf[2] * pf2;
      float rv = Jf[3] * pf0 + Jf[4] * pf1 + Jf[5] * pf2;
      for (int c = 0; c < 6; ++c) {
        ru += Jp[c] * cg->pp[c];
        rv += Jp[6 + c] * cg->pp[c];
      }
      const float w = lin.wr[p];
      float esum[3] = {0.0f, 0.0f, 0.0f};
      for (int k = in.inc_ptr[p]; k < in.inc_ptr[p + 1]; ++k) {
        const float* ev = s.eg + 9L * in.inc_edge[k];
        const float sg = in.inc_sign[k];
        for (int c = 0; c < 3; ++c) esum[c] += sg * ev[c];
      }
      const float pf[3] = {pf0, pf1, pf2};
      for (int c = 0; c < 3; ++c) {
        const float h = w * (Jf[c] * ru + Jf[3 + c] * rv) + esum[c] + lam * pf[c];
        s.hp[3 * p + c] = h;
        acc7[6] += pf[c] * h;
      }
      for (int c = 0; c < 6; ++c) acc7[c] += w * (Jp[c] * ru + Jp[6 + c] * rv);
    }
    block_sum<7>(acc7, red, tot);
    if (tid == 0) {
      float denom = 0.0f;
      for (int c = 0; c < 6; ++c) {
        cg->hpp[c] = tot[c] + lam * cg->pp[c];
        denom += cg->pp[c] * cg->hpp[c];
      }
      denom += tot[6];
      const float alpha = fabsf(denom) > 0.0f ? cg->rz / denom : 0.0f;
      cg->alpha = alpha;
      for (int c = 0; c < 6; ++c) {
        cg->xp[c] += alpha * cg->pp[c];
        cg->rp[c] -= alpha * cg->hpp[c];
      }
      mat6_vec(cg->Hinv, cg->rp, cg->zp);
    }
    __syncthreads();
    const float alpha = cg->alpha;
    acc2[0] = acc2[1] = 0.0f;
    for (int p = tid; p < in.P; p += nt) {
      float r[3], z[3];
      for (int c = 0; c < 3; ++c) {
        s.x[3 * p + c] += alpha * s.p[3 * p + c];
        r[c] = s.r[3 * p + c] - alpha * s.hp[3 * p + c];
        s.r[3 * p + c] = r[c];
      }
      apply_minv(s.minv + 9 * p, r, z);
      for (int c = 0; c < 3; ++c) {
        s.z[3 * p + c] = z[c];
        acc2[0] += r[c] * z[c];
        acc2[1] += r[c] * r[c];
      }
    }
    block_sum<2>(acc2, red, tot);
    if (tid == 0) {
      float rz_new = tot[0], rr = tot[1];
      for (int c = 0; c < 6; ++c) {
        rz_new += cg->rp[c] * cg->zp[c];
        rr += cg->rp[c] * cg->rp[c];
      }
      const float beta = fabsf(cg->rz) > 0.0f ? rz_new / cg->rz : 0.0f;
      cg->beta = beta;
      for (int c = 0; c < 6; ++c) cg->pp[c] = cg->zp[c] + beta * cg->pp[c];
      cg->done = rr <= kCgTol * kCgTol * cg->b2;
      if (!cg->done) cg->rz = rz_new;
    }
    __syncthreads();
    if (cg->done) break;  // x is final once converged
    const float beta = cg->beta;
    for (int p = tid; p < in.P; p += nt)
      for (int c = 0; c < 3; ++c)
        s.p[3 * p + c] = s.z[3 * p + c] + beta * s.p[3 * p + c];
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
pose_deformation_kernel(Inputs in, const float* __restrict__ params,
                        float* scratch, float* out_pose, float* out_flows,
                        float* out_chi2, int n_rounds, int it0, int it1,
                        int it2, int it3, int cg_iters) {
  __shared__ float red[32 * kSysSums];
  __shared__ float tot[kSysSums];
  __shared__ SharedLin slin[2];
  __shared__ SharedCG cg;
  __shared__ float s_q[4], s_t[3], s_qn[4], s_tn[3];
  __shared__ float s_lam, s_nu;
  __shared__ int s_cur, s_fcur, s_done;

  const int tid = threadIdx.x, nt = blockDim.x;
  const int P = in.P, E = in.E;
  in.info_r = params[15];
  in.info_s = params[16];
  in.info_p = params[17];
  Scratch s = carve(scratch, P, E);
  const int iters[4] = {it0, it1, it2, it3};

  // Cached rest differences and the initial masks.
  for (int e = tid; e < E; e += nt) {
    const int i = in.ei[e], j = in.ej[e];
    for (int c = 0; c < 3; ++c)
      s.drest[3 * e + c] = in.rest[3 * i + c] - in.rest[3 * j + c];
    s.smask[e] = in.ebase[e];
  }
  for (int p = tid; p < P; p += nt) s.pmask[p] = in.pmask[p];
  if (tid == 0) s_fcur = 0;
  __syncthreads();

  for (int r = 0; r < n_rounds; ++r) {
    const float* sm = r > 0 ? s.smask : in.ebase;
    if (tid == 0) {
      for (int k = 0; k < 4; ++k) s_q[k] = params[8 + k];
      for (int k = 0; k < 3; ++k) s_t[k] = params[12 + k];
      s_cur = 0;
    }
    {
      float* f = s.flows[s_fcur];
      for (int p = tid; p < P; p += nt)
        for (int c = 0; c < 3; ++c) f[3 * p + c] = 0.0f;
    }
    __syncthreads();
    linearize(in, s, s_q, s_t, s.flows[s_fcur], s.pmask, sm, s.lin[0],
              &slin[0], red, tot);
    // lambda0 = tau * max(diag H_pose, max_p diag D_p).
    float dmax = -INFINITY;
    for (int p = tid; p < P; p += nt) {
      const float* D = s.lin[0].D + 6 * p;
      dmax = fmaxf(dmax, fmaxf(D[0], fmaxf(D[3], D[5])));
    }
    dmax = block_max(dmax, red);
    if (tid == 0) {
      for (int a = 0; a < 6; ++a) dmax = fmaxf(dmax, slin[0].H[a * 6 + a]);
      s_lam = kLmTau * dmax;
      s_nu = 2.0f;
      s_done = 0;
    }
    __syncthreads();

    for (int j = 0; j < iters[r]; ++j) {
      if (s_done) break;  // uniform: written by thread 0 before a barrier
      const int cur = s_cur, fcur = s_fcur;
      const float lam = s_lam;
      pcg(in, s, s.lin[cur], &slin[cur], lam, cg_iters, &cg, red, tot);
      if (tid == 0) se3_retract(s_q, s_t, cg.xp, s_qn, s_tn);
      // Trial flows + the flow parts of the gain-ratio denominator and |dx|^2.
      float acc[2] = {0.0f, 0.0f};
      const float* f = s.flows[fcur];
      float* fn = s.flows[1 - fcur];
      const float* gf = s.lin[cur].gf;
      for (int p = tid; p < P; p += nt)
        for (int c = 0; c < 3; ++c) {
          const float dx = s.x[3 * p + c];
          fn[3 * p + c] = f[3 * p + c] + dx;
          acc[0] += dx * (lam * dx - gf[3 * p + c]);
          acc[1] += dx * dx;
        }
      block_sum<2>(acc, red, tot);
      const float denom_f = tot[0], dx2_f = tot[1];
      linearize(in, s, s_qn, s_tn, fn, s.pmask, sm, s.lin[1 - cur],
                &slin[1 - cur], red, tot);
      if (tid == 0) {
        float denom = denom_f, dx2 = dx2_f;
        for (int c = 0; c < 6; ++c) {
          const float d = cg.xp[c];
          denom += d * (lam * d - slin[cur].g[c]);
          dx2 += d * d;
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
          s_fcur = 1 - fcur;
          for (int k = 0; k < 4; ++k) s_q[k] = s_qn[k];
          for (int k = 0; k < 3; ++k) s_t[k] = s_tn[k];
          s_done = dx2 < 1e-12f;
        }
      }
      __syncthreads();
    }

    // Re-level at the round optimum with the full base masks.
    const int cur = s_cur;
    linearize(in, s, s_q, s_t, s.flows[s_fcur], in.pmask, in.ebase,
              s.lin[1 - cur], &slin[1 - cur], red, tot);
    const Lin& lr = s.lin[1 - cur];
    for (int p = tid; p < P; p += nt)
      s.pmask[p] = lr.chi2r[p] <= kTh2Dof ? in.pmask[p] : 0.0f;
    for (int e = tid; e < E; e += nt)
      s.smask[e] = lr.es[6L * e + 5] <= kTh3Dof ? in.ebase[e] : 0.0f;
    __syncthreads();
  }

  // Final linearization (full masks) for the per-point chi2 output.
  const int cur = s_cur;
  linearize(in, s, s_q, s_t, s.flows[s_fcur], in.pmask, in.ebase,
            s.lin[1 - cur], &slin[1 - cur], red, tot);
  const float* f = s.flows[s_fcur];
  for (int p = tid; p < P; p += nt) {
    for (int c = 0; c < 3; ++c) out_flows[3 * p + c] = f[3 * p + c];
    out_chi2[p] = s.lin[1 - cur].chi2r[p];
  }
  if (tid == 0) {
    for (int k = 0; k < 4; ++k) out_pose[k] = s_q[k];
    for (int k = 0; k < 3; ++k) out_pose[4 + k] = s_t[k];
    out_pose[7] = 0.0f;
  }
}

}  // namespace
}  // namespace nrslam

// Scratch size in floats for P points and E edges.
extern "C" long nrslam_pose_deformation_scratch(int P, int E) {
  return nrslam::scratch_floats(P, E);
}

// C entry point. Pointers are device pointers; params = (fx, fy, cx, cy,
// k0..k3, q (4), t (3), info_r, info_s, info_p). Returns cudaGetLastError().
extern "C" int nrslam_pose_deformation(
    const void* params, const void* rest, const void* obs, const void* pmask,
    const void* ei, const void* ej, const void* ew, const void* ed0,
    const void* ebase, const void* inc_ptr, const void* inc_edge,
    const void* inc_sign, void* scratch, void* out_pose, void* out_flows,
    void* out_chi2, int P, int E, int kind,
    int n_rounds, int it0, int it1, int it2, int it3, int cg_iters,
    void* stream) {
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
  in.inc_ptr = static_cast<const int*>(inc_ptr);
  in.inc_edge = static_cast<const int*>(inc_edge);
  in.inc_sign = static_cast<const float*>(inc_sign);
  in.P = P;
  in.E = E;
  in.kind = kind;
  in.info_r = in.info_s = in.info_p = 0.0f;  // read from params on device
  nrslam::pose_deformation_kernel<<<1, nrslam::kThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      in, static_cast<const float*>(params), static_cast<float*>(scratch),
      static_cast<float*>(out_pose), static_cast<float*>(out_flows),
      static_cast<float*>(out_chi2), n_rounds, it0, it1, it2, it3, cg_iters);
  return static_cast<int>(cudaGetLastError());
}
