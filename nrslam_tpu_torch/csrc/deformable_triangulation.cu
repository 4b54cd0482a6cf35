// Deformable landmark triangulation of every candidate in one launch: the
// rigid pre-gates, the neighbour-depth seeds, the LM solve (each step a
// block-Jacobi PCG on the structured Hessian), the rejection gates and the
// landmark at the last frame's depth along the last ray.
//
// Replaces no Pallas kernel: the JAX package's triangulation (nrslam_tpu/
// solver/deformable_triangulation.py::deformable_triangulate) is plain XLA
// ops. It replaces the port's plain-op version (nrslam_tpu_torch/solver/
// deformable_triangulation.py::deformable_triangulate_plain, kept as the
// CPU path and as this kernel's oracle), whose ~7,500 device kernels a call
// (3,450 of them in its ten PCG solves) were ~7,500 of a non-keyframe
// replay's ~9,700 graph nodes. The semantics are the plain function's: the
// same gates and thresholds (min_track, 5.991 and the parallax factor 5,
// TH_3DOF, REPROJ_REJECT, the half-of-terms votes), the same seeds and
// masks (a pair's neighbour present at both frames and at the first), the
// same fixed schedule (n_iters LM steps, cg_iters PCG trips, no early
// exit), lambda0 = LM_TAU max(diag(B) + diag_L), the same lambda rule and
// accept-or-keep of V, chi2, g, B, diag_L and W, non-finite steps zeroed,
// masks applied as products so a masked term reaches a sum as the plain
// path's does. Float32 throughout with precise sqrtf / sinf / cosf /
// atan2f, the KB8 unprojection's 10 fixed Newton steps, and common.cuh's
// projection with its Jacobian; the order of the sums differs.
//
// What bounds it on an H100: latency. Per candidate the work is ~2,100
// spring terms (190 frame pairs x 11 neighbours at T = 20) and 20
// reprojection terms an assembly, 12 assemblies, and 120 PCG trips on a
// 60-unknown system: ~1.2 MFLOP, ~0.16 GFLOP for C = 128, and ~4 KB of
// inputs, a few microseconds at the card's peaks. But each LM step needs the
// one before it, each PCG trip the trip before it, and each trip two dot
// products over the whole candidate. The design keeps that chain short:
//
// - One block of 256 threads a candidate (C = 128 fits one wave on 132
//   SMs). Everything the candidate needs is loaded into shared memory once
//   (observations, masks, neighbour tracks, poses), beside the solve's
//   state (~15 KB in all at T = 20, NB = 11); the flow of each neighbour is
//   formed from its track on the fly and never stored.
// - An assembly spreads the frame pairs over the block (one thread a pair,
//   its neighbours in order) and writes each pair's gradient share, spring
//   weight (both halves of the symmetric W) and robust cost to shared
//   memory; then warp 0, one lane a frame, forms the reprojection terms and
//   sums its frame's pair shares in a fixed order.
// - The PCG and the LM bookkeeping run in warp 0 alone: a lane owns its
//   frame's 3-vector and 3x3 blocks in registers, the matvec reads the
//   search direction from shared memory (double-buffered, one __syncwarp a
//   trip) and W by columns (W is symmetric, so lanes read consecutive
//   words), and every dot product is a butterfly of shuffles: IEEE
//   addition commutes, so every lane holds the same bits, takes the same
//   branch, and two launches give the same bits. No atomics.
// - Two barriers an LM step (trial vertices written; pair terms written).
//   The kernel allocates nothing and does not synchronise with the host, so
//   it is captured as one node of a CUDA graph.

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace nrslam {
namespace {

constexpr int kTriThreads = 256;
constexpr int kMaxT = 32;   // frames: one lane of warp 0 each
constexpr int kMaxNb = 32;  // neighbours a candidate
constexpr unsigned kAllLanes = 0xffffffffu;

constexpr float kInfoReproj = 4.0f;      // 1 / 0.5^2
constexpr float kInfoSpatial = 100.0f;   // 1 / 0.1^2
constexpr float kTh3Dof = 7.815f;
constexpr float kReprojReject = 59.9f;   // 5.99 * 10
constexpr float kRigidReproj = 5.991f;
constexpr float kLmTau = 1e-5f;

}  // namespace

// One launch (mirrored field for field by solver/
// deformable_triangulation_cuda.py::Params). The inputs are read through
// their strides, in elements, so the permuted views the mapping builds are
// read where they lie.
struct TriParams {
  const float* cam;                  // [4] pinhole or [8] KB8
  const float* obs;                  // [C, T, 2]
  const unsigned char* track;        // [C, T] bool
  const float* nbr_pos;              // [C, NB, T, 3]
  const unsigned char* nbr_valid;    // [C, NB, T] bool
  const unsigned char* cand_valid;   // [C] bool
  const float* pose_q;               // [T, 4] contiguous
  const float* pose_t;               // [T, 3] contiguous
  float* landmark_out;               // [C, 3]
  unsigned char* ok_out;             // [C] bool
  int* accepted_out;                 // [C] LM steps accepted
  long long obs_sc, obs_st, obs_sk;
  long long track_sc, track_st;
  long long nbr_sc, nbr_sn, nbr_st, nbr_sk;
  long long nv_sc, nv_sn, nv_st;
  long long cand_s;
  int C, T, NB, kind, min_track, n_iters, cg_iters;
  float parallax_min;                // rad_per_pixel * 5
};

namespace {

// A block's shared memory, in 4-byte words, from T and NB.
struct Layout {
  int cam, q, t, obs, fm, npos, nval, V, W, S, rho, bad, npm, ps, pairs,
      flags, total;
  __host__ __device__ Layout(int T, int NB) {
    const int NP = T * (T - 1) / 2;
    int o = 0;
    cam = o;   o += 8;
    q = o;     o += 4 * T;
    t = o;     o += 3 * T;
    obs = o;   o += 2 * T;
    fm = o;    o += T;            // frame mask (track), 0 / 1
    npos = o;  o += 3 * NB * T;   // [NB][T][3]
    nval = o;  o += NB * T;       // [NB][T], 0 / 1
    V = o;     o += 2 * 3 * T;    // two buffers [T][3]
    W = o;     o += 2 * T * T;    // two buffers, symmetric
    S = o;     o += 3 * NP;       // a pair's gradient share
    rho = o;   o += NP;           // a pair's robust cost
    bad = o;   o += NP;           // its terms over TH_3DOF (last assembly)
    npm = o;   o += NP;           // its live terms (last assembly)
    ps = o;    o += 2 * 3 * T;    // PCG direction, two buffers
    pairs = o; o += NP;           // (i, j), i < j, packed i | j << 8
    flags = o; o += 4;            // current buffer, first frame
    total = o;
  }
};

constexpr int kFlagCur = 0;
constexpr int kFlagFirst = 1;

__device__ __forceinline__ int pair_index(int i, int j, int T) {
  return i * T - i * (i + 1) / 2 + (j - i - 1);
}

// Sum over warp 0: a butterfly of shuffles, the same bits in every lane.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(kAllLanes, v, m);
  return v;
}

// Largest over the warp, NaN-propagating as torch.amax.
__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1)
    v = nan_max(v, __shfl_xor_sync(kAllLanes, v, m));
  return v;
}

// Pixels -> ray (cameras.unproject): pinhole z = 1; KB8 after 10 fixed
// Newton steps on the distortion polynomial.
template <int Kind>
__device__ void unproject(const float* cam, float u, float v, float r[3]) {
  const float pwx = (u - cam[2]) / cam[0];
  const float pwy = (v - cam[3]) / cam[1];
  if constexpr (Kind == kPinhole) {
    r[0] = pwx; r[1] = pwy; r[2] = 1.0f;
  } else {
    const float k0 = cam[4], k1 = cam[5], k2 = cam[6], k3 = cam[7];
    const float theta_d = sqrtf(pwx * pwx + pwy * pwy);
    const float safe_td = fmaxf(theta_d, 1e-12f);
    float theta = theta_d;
    for (int it = 0; it < 10; ++it) {
      const float t2 = theta * theta, t4 = t2 * t2, t6 = t4 * t2,
                  t8 = t4 * t4;
      const float num =
          theta * (1.0f + k0 * t2 + k1 * t4 + k2 * t6 + k3 * t8) - theta_d;
      const float den = 1.0f + 3.0f * k0 * t2 + 5.0f * k1 * t4 +
                        7.0f * k2 * t6 + 9.0f * k3 * t8;
      theta = theta - num / den;
    }
    const bool small = theta_d <= 1e-8f;
    theta = small ? 0.0f : theta;
    const float s = small ? 1.0f : sinf(theta) / safe_td;
    r[0] = s * pwx; r[1] = s * pwy; r[2] = cosf(theta);
  }
}

__device__ __forceinline__ float norm3(const float v[3]) {
  return sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
}

__device__ __forceinline__ void cross3(const float a[3], const float b[3],
                                       float o[3]) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ void conj(const float q[4], float o[4]) {
  o[0] = q[0]; o[1] = -q[1]; o[2] = -q[2]; o[3] = -q[3];
}

// se3.apply: quat_rotate(q, X) + t.
__device__ __forceinline__ void apply(const float q[4], const float t[3],
                                      const float X[3], float o[3]) {
  quat_rotate(q, X, o);
  for (int k = 0; k < 3; ++k) o[k] += t[k];
}

// se3.inverse(T).t = -quat_rotate(conj(q), t).
__device__ __forceinline__ void inverse_t(const float q[4], const float t[3],
                                          float o[3]) {
  float qc[4];
  conj(q, qc);
  quat_rotate(qc, t, o);
  for (int k = 0; k < 3; ++k) o[k] = -o[k];
}

// se3.apply(se3.inverse(T), X).
__device__ __forceinline__ void apply_inverse(const float q[4],
                                              const float t[3],
                                              const float X[3], float o[3]) {
  float qc[4], ti[3];
  conj(q, qc);
  inverse_t(q, t, ti);
  apply(qc, ti, X, o);
}

template <int Kind>
__device__ __forceinline__ float reproj_sq(const float* cam, float u, float v,
                                           const float X[3]) {
  float pu, pv, J[6];
  project_with_jacobian<Kind>(cam, X[0], X[1], X[2], &pu, &pv, J);
  const float du = u - pu, dv = v - pv;
  return du * du + dv * dv;
}

// deformable_triangulation.rigid_pregate's gates for frames f (first) and
// l (last): triangulation.triangulate_midpoint(ray_l, ray_f, T_l, T_f),
// both reprojections within 5.991, parallax at least parallax_min.
template <int Kind>
__device__ bool rigid_pregate(const float* cam, const float* obs,
                              const float* qs, const float* ts, int f, int l,
                              float parallax_min) {
  const float *qf = qs + 4 * f, *tf = ts + 3 * f;
  const float *ql = qs + 4 * l, *tl = ts + 3 * l;
  float ray_f[3], ray_l[3];
  unproject<Kind>(cam, obs[2 * f], obs[2 * f + 1], ray_f);
  unproject<Kind>(cam, obs[2 * l], obs[2 * l + 1], ray_l);
  const float nf = norm3(ray_f), nl = norm3(ray_l);
  for (int k = 0; k < 3; ++k) { ray_f[k] /= nf; ray_l[k] /= nl; }

  // triangulate_midpoint(ray1 = ray_l, ray2 = ray_f, T1w = T_l, T2w = T_f)
  float f0[3], f1[3];
  const float n0 = norm3(ray_l), n1 = norm3(ray_f);
  for (int k = 0; k < 3; ++k) { f0[k] = ray_l[k] / n0; f1[k] = ray_f[k] / n1; }
  float qlc[4], tli[3], q10[4], t10[3], rt[3];
  conj(ql, qlc);
  inverse_t(ql, tl, tli);
  quat_mul(qf, qlc, q10);
  quat_normalize(q10);
  quat_rotate(qf, tli, rt);
  for (int k = 0; k < 3; ++k) t10[k] = rt[k] + tf[k];
  float Rf0[3], pp[3], qq[3], rr[3];
  quat_rotate(q10, f0, Rf0);
  cross3(Rf0, f1, pp);
  cross3(Rf0, t10, qq);
  cross3(f1, t10, rr);
  const float qn = norm3(qq), rn = norm3(rr), pn = norm3(pp);
  float x1[3], X[3];
  for (int k = 0; k < 3; ++k)
    x1[k] = qn / (qn + rn) * (t10[k] + rn / pn * (Rf0[k] + f1[k]));
  apply_inverse(qf, tf, x1, X);

  float Xf[3], Xl[3];
  apply(qf, tf, X, Xf);
  apply(ql, tl, X, Xl);
  const float e_f = reproj_sq<Kind>(cam, obs[2 * f], obs[2 * f + 1], Xf);
  const float e_l = reproj_sq<Kind>(cam, obs[2 * l], obs[2 * l + 1], Xl);
  float cf[3], cl[3], a[3], b[3];
  inverse_t(qf, tf, cf);
  inverse_t(ql, tl, cl);
  for (int k = 0; k < 3; ++k) { a[k] = X[k] - cf[k]; b[k] = X[k] - cl[k]; }
  float cosv = (a[0] * b[0] + a[1] * b[1] + a[2] * b[2]) /
               (norm3(a) * norm3(b));
  cosv = cosv > 1.0f ? 1.0f : cosv;  // torch.clamp(max=1) keeps a NaN
  const float parallax = acosf(cosv);
  return isfinite(X[0]) && isfinite(X[1]) && isfinite(X[2]) &&
         e_f <= kRigidReproj && e_l <= kRigidReproj &&
         parallax >= parallax_min;
}

// The spring terms of every frame pair (i < j) at vertices Vb, one thread
// a pair, neighbours in order: its gradient share S (sum of w e), its
// weight in both halves of Wb, its robust cost and, on the last assembly,
// its terms over TH_3DOF and its live terms.
__device__ void pair_terms(const float* npos, const float* nval,
                           const float* fm, const int* pairs, const float* Vb,
                           float* Wb, float* S, float* rho, float* bad,
                           float* npm, int T, int NB, int first, bool last) {
  const int NP = T * (T - 1) / 2;
  for (int p = threadIdx.x; p < NP; p += blockDim.x) {
    const int i = pairs[p] & 255, j = pairs[p] >> 8;
    const float d0 = Vb[3 * j] - Vb[3 * i];
    const float d1 = Vb[3 * j + 1] - Vb[3 * i + 1];
    const float d2 = Vb[3 * j + 2] - Vb[3 * i + 2];
    const bool frames = fm[i] != 0.0f && fm[j] != 0.0f;
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, ws = 0.0f, r = 0.0f, nb_bad = 0.0f,
          n = 0.0f;
    for (int nb = 0; nb < NB; ++nb) {
      const float* a = npos + 3 * (nb * T + i);
      const float* b = npos + 3 * (nb * T + j);
      const float e0 = (b[0] - a[0]) - d0;
      const float e1 = (b[1] - a[1]) - d1;
      const float e2 = (b[2] - a[2]) - d2;
      const float chi2 = kInfoSpatial * (e0 * e0 + e1 * e1 + e2 * e2);
      const float* nv = nval + nb * T;
      const float pm = (frames && nv[i] != 0.0f && nv[j] != 0.0f &&
                        nv[first] != 0.0f) ? 1.0f : 0.0f;
      const float w = kInfoSpatial * huber_w(chi2, kTh3Dof) * pm;
      s0 += w * e0;
      s1 += w * e1;
      s2 += w * e2;
      ws += w;
      r += huber_rho(chi2, kTh3Dof) * pm;
      if (last) {
        nb_bad += (chi2 > kTh3Dof ? 1.0f : 0.0f) * pm;
        n += pm;
      }
    }
    S[3 * p] = s0;
    S[3 * p + 1] = s1;
    S[3 * p + 2] = s2;
    Wb[i * T + j] = ws;
    Wb[j * T + i] = ws;
    rho[p] = r;
    if (last) {
      bad[p] = nb_bad;
      npm[p] = n;
    }
  }
}

// A frame's terms (lane t of warp 0; lanes >= T give zeros).
struct FrameTerms {
  float B[9], g[3], dL, chi2_r;
};

template <int Kind>
__device__ void frame_terms(const float* cam, const float R[9],
                            const float tc[3], float u, float v, float fmt,
                            const float* Vb, const float* Wb, const float* S,
                            int t, int T, bool own, FrameTerms& o) {
  for (int k = 0; k < 9; ++k) o.B[k] = 0.0f;
  o.g[0] = o.g[1] = o.g[2] = 0.0f;
  o.dL = 0.0f;
  o.chi2_r = 0.0f;
  if (!own) return;
  const float V0 = Vb[3 * t], V1 = Vb[3 * t + 1], V2 = Vb[3 * t + 2];
  float Xc[3];
  for (int i = 0; i < 3; ++i)
    Xc[i] = R[3 * i] * V0 + R[3 * i + 1] * V1 + R[3 * i + 2] * V2 + tc[i];
  float pu, pv, J[6];
  project_with_jacobian<Kind>(cam, Xc[0], Xc[1], Xc[2], &pu, &pv, J);
  const float e[2] = {u - pu, v - pv};
  float Jr[6];  // -(dpi/dXc) R, rows u, v
  for (int r = 0; r < 2; ++r)
    for (int k = 0; k < 3; ++k)
      Jr[3 * r + k] = -(J[3 * r] * R[k] + J[3 * r + 1] * R[3 + k] +
                        J[3 * r + 2] * R[6 + k]);
  o.chi2_r = kInfoReproj * (e[0] * e[0] + e[1] * e[1]);
  const float wr = kInfoReproj * fmt;
  float g[3];
  for (int k = 0; k < 3; ++k)
    g[k] = Jr[k] * wr * e[0] + Jr[3 + k] * wr * e[1];
  for (int k = 0; k < 3; ++k)
    for (int l = 0; l < 3; ++l)
      o.B[3 * k + l] = Jr[k] * wr * Jr[l] + Jr[3 + k] * wr * Jr[3 + l];
  // g += sum_j S[t, j] - sum_i S[i, t]; the pair shares in order.
  float out[3] = {0.0f, 0.0f, 0.0f}, in[3] = {0.0f, 0.0f, 0.0f};
  for (int j = t + 1; j < T; ++j) {
    const float* s = S + 3 * pair_index(t, j, T);
    for (int k = 0; k < 3; ++k) out[k] += s[k];
  }
  for (int i = 0; i < t; ++i) {
    const float* s = S + 3 * pair_index(i, t, T);
    for (int k = 0; k < 3; ++k) in[k] += s[k];
  }
  for (int k = 0; k < 3; ++k) o.g[k] = (g[k] + out[k]) - in[k];
  float dL = 0.0f;
  for (int u2 = 0; u2 < T; ++u2) dL += Wb[u2 * T + t];
  o.dL = dL;
}

// Sum over lane t's pairs (t, j > t) of a per-pair array.
__device__ __forceinline__ float row_sum(const float* a, int t, int T,
                                         bool own) {
  float s = 0.0f;
  if (own)
    for (int j = t + 1; j < T; ++j) s += a[pair_index(t, j, T)];
  return s;
}

template <int Kind>
__global__ void __launch_bounds__(kTriThreads)
    tri_kernel(const __grid_constant__ TriParams p) {
  extern __shared__ __align__(16) float smem[];
  const int c = blockIdx.x, tid = threadIdx.x;
  const int T = p.T, NB = p.NB;
  const Layout Lo(T, NB);
  float* cam = smem + Lo.cam;
  float* qs = smem + Lo.q;
  float* ts = smem + Lo.t;
  float* obs = smem + Lo.obs;
  float* fm = smem + Lo.fm;
  float* npos = smem + Lo.npos;
  float* nval = smem + Lo.nval;
  float* Vs = smem + Lo.V;
  float* Ws = smem + Lo.W;
  float* S = smem + Lo.S;
  float* rho = smem + Lo.rho;
  float* bad = smem + Lo.bad;
  float* npm = smem + Lo.npm;
  float* ps = smem + Lo.ps;
  int* pairs = reinterpret_cast<int*>(smem + Lo.pairs);
  int* flags = reinterpret_cast<int*>(smem + Lo.flags);

  // Everything the candidate reads, once.
  const int n_cam = Kind == kKB8 ? 8 : 4;
  if (tid < n_cam) cam[tid] = p.cam[tid];
  for (int k = tid; k < 4 * T; k += blockDim.x) qs[k] = p.pose_q[k];
  for (int k = tid; k < 3 * T; k += blockDim.x) ts[k] = p.pose_t[k];
  for (int k = tid; k < 2 * T; k += blockDim.x)
    obs[k] = p.obs[c * p.obs_sc + (k >> 1) * p.obs_st + (k & 1) * p.obs_sk];
  for (int k = tid; k < T; k += blockDim.x)
    fm[k] = p.track[c * p.track_sc + k * p.track_st] ? 1.0f : 0.0f;
  for (int k = tid; k < 3 * NB * T; k += blockDim.x) {
    const int nb = k / (3 * T), r = k - nb * 3 * T, t = r / 3, d = r - 3 * t;
    npos[k] = p.nbr_pos[c * p.nbr_sc + nb * p.nbr_sn + t * p.nbr_st +
                        d * p.nbr_sk];
  }
  for (int k = tid; k < NB * T; k += blockDim.x) {
    const int nb = k / T, t = k - nb * T;
    nval[k] = p.nbr_valid[c * p.nv_sc + nb * p.nv_sn + t * p.nv_st] ? 1.0f
                                                                   : 0.0f;
  }
  for (int k = tid; k < T * T; k += blockDim.x) {
    const int i = k / T, j = k - i * T;
    if (i < j) pairs[pair_index(i, j, T)] = i | (j << 8);
    if (i == j) Ws[k] = Ws[T * T + k] = 0.0f;  // W's diagonal stays zero
  }
  __syncthreads();

  // Warp 0: lane t owns frame t for the whole solve.
  const bool w0 = tid < 32;
  const int t = tid;
  const bool own = w0 && t < T;
  float R[9] = {}, tc[3] = {}, ou = 0.0f, ov = 0.0f, fmt = 0.0f;
  bool pre_ok = false;
  int first = 0, last = 0;
  if (w0) {
    bool seed_ok = false;
    if (own) {
      quat_to_matrix(qs + 4 * t, R);
      for (int k = 0; k < 3; ++k) tc[k] = ts[3 * t + k];
      ou = obs[2 * t];
      ov = obs[2 * t + 1];
      fmt = fm[t];
      // Seed: the mean camera-frame depth of the neighbours present.
      float dsum = 0.0f, n = 0.0f;
      for (int nb = 0; nb < NB; ++nb) {
        float X[3];
        apply(qs + 4 * t, tc, npos + 3 * (nb * T + t), X);
        const float w = nval[nb * T + t];
        dsum += X[2] * w;
        n += w;
      }
      const float depth = dsum / fmaxf(n, 1.0f);
      seed_ok = n > 0.0f && depth > 0.0f;
      float ray[3], X0[3], V0[3];
      unproject<Kind>(cam, ou, ov, ray);
      for (int k = 0; k < 3; ++k) X0[k] = ray[k] * depth;
      apply_inverse(qs + 4 * t, tc, X0, V0);
      for (int k = 0; k < 3; ++k) Vs[3 * t + k] = fmt != 0.0f ? V0[k] : 1.0f;
    }
    const unsigned trk = __ballot_sync(kAllLanes, own && fmt != 0.0f);
    const unsigned seeds = __ballot_sync(
        kAllLanes, !own || seed_ok || fmt == 0.0f);
    first = trk ? __ffs(trk) - 1 : T - 1;
    last = trk ? 31 - __clz(trk) : 0;
    if (t == 0) {
      flags[kFlagCur] = 0;
      flags[kFlagFirst] = first;
      const bool cand = p.cand_valid[c * p.cand_s] != 0;
      pre_ok = cand && __popc(trk) >= p.min_track && seeds == kAllLanes &&
               rigid_pregate<Kind>(cam, obs, qs, ts, first, last,
                                   p.parallax_min);
    }
  }
  __syncthreads();
  first = flags[kFlagFirst];

  // The first assembly, into buffer 0.
  pair_terms(npos, nval, fm, pairs, Vs, Ws, S, rho, bad, npm, T, NB, first,
             false);
  __syncthreads();
  FrameTerms cur, nxt;
  float chi2 = 0.0f, lam = 0.0f, nu = 2.0f;
  int cb = 0, accepted = 0;
  if (w0) {
    frame_terms<Kind>(cam, R, tc, ou, ov, fmt, Vs, Ws, S, t, T, own, cur);
    chi2 = warp_sum(cur.chi2_r * fmt) + warp_sum(row_sum(rho, t, T, own));
    const float diag =
        own ? nan_max(nan_max(cur.B[0], cur.B[4]), cur.B[8]) + cur.dL
            : -INFINITY;
    lam = kLmTau * warp_max(diag);
  }

  for (int iter = 0; iter < p.n_iters; ++iter) {
    float den = 0.0f;
    if (w0) {
      // (blockdiag(B) + diag_L + lam - W) dx = -g, block-Jacobi PCG.
      const float* Wc = Ws + cb * T * T;
      const float dl = cur.dL + lam;
      float A[9], Mi[9];
      for (int k = 0; k < 9; ++k) A[k] = cur.B[k];
      A[0] += dl; A[4] += dl; A[8] += dl;
      inv3(A, Mi);
      float x[3] = {0.0f, 0.0f, 0.0f}, r[3], z[3], d[3];
      for (int k = 0; k < 3; ++k) r[k] = -cur.g[k];
      for (int k = 0; k < 3; ++k)
        z[k] = Mi[3 * k] * r[0] + Mi[3 * k + 1] * r[1] + Mi[3 * k + 2] * r[2];
      for (int k = 0; k < 3; ++k) d[k] = z[k];
      float rz = warp_sum(r[0] * z[0] + r[1] * z[1] + r[2] * z[2]);
      int pb = 0;
      if (own)
        for (int k = 0; k < 3; ++k) ps[3 * t + k] = d[k];
      __syncwarp();
      for (int it = 0; it < p.cg_iters; ++it) {
        const float* pd = ps + pb * 3 * T;
        float hp[3] = {0.0f, 0.0f, 0.0f};
        if (own) {
          float wv[3] = {0.0f, 0.0f, 0.0f};
          for (int u2 = 0; u2 < T; ++u2) {
            const float w = Wc[u2 * T + t];  // W[t][u2], read by column
            for (int k = 0; k < 3; ++k) wv[k] += w * pd[3 * u2 + k];
          }
          for (int k = 0; k < 3; ++k)
            hp[k] = (cur.B[3 * k] * d[0] + cur.B[3 * k + 1] * d[1] +
                     cur.B[3 * k + 2] * d[2] + dl * d[k]) - wv[k];
        }
        const float php = warp_sum(d[0] * hp[0] + d[1] * hp[1] + d[2] * hp[2]);
        const float alpha = php > 0.0f ? rz / fmaxf(php, 1e-30f) : 0.0f;
        for (int k = 0; k < 3; ++k) {
          x[k] += alpha * d[k];
          r[k] -= alpha * hp[k];
        }
        for (int k = 0; k < 3; ++k)
          z[k] = Mi[3 * k] * r[0] + Mi[3 * k + 1] * r[1] + Mi[3 * k + 2] * r[2];
        const float rz_new = warp_sum(r[0] * z[0] + r[1] * z[1] + r[2] * z[2]);
        const float beta = rz > 0.0f ? rz_new / fmaxf(rz, 1e-30f) : 0.0f;
        for (int k = 0; k < 3; ++k) d[k] = z[k] + beta * d[k];
        rz = rz_new;
        pb ^= 1;
        if (own)
          for (int k = 0; k < 3; ++k) ps[pb * 3 * T + 3 * t + k] = d[k];
        __syncwarp();
      }
      // The trial vertices, and the gain ratio's denominator.
      if (own)
        for (int k = 0; k < 3; ++k) {
          const float dx = isfinite(x[k]) ? x[k] : 0.0f;
          Vs[(1 - cb) * 3 * T + 3 * t + k] = Vs[cb * 3 * T + 3 * t + k] + dx;
          den += dx * (lam * dx - cur.g[k]);
        }
      den = warp_sum(den);
    }
    __syncthreads();  // trial vertices written
    const int tb = 1 - flags[kFlagCur];
    pair_terms(npos, nval, fm, pairs, Vs + tb * 3 * T, Ws + tb * T * T, S,
               rho, bad, npm, T, NB, first, false);
    __syncthreads();  // pair terms written
    if (w0) {
      frame_terms<Kind>(cam, R, tc, ou, ov, fmt, Vs + tb * 3 * T,
                        Ws + tb * T * T, S, t, T, own, nxt);
      const float chi2_new =
          warp_sum(nxt.chi2_r * fmt) + warp_sum(row_sum(rho, t, T, own));
      const float gain = (chi2 - chi2_new) / (fabsf(den) > 0.0f ? den : 1.0f);
      if (gain > 0.0f) {  // core.lm_lambda_update, then accept
        const float h = 2.0f * gain - 1.0f;
        lam *= fmaxf(1.0f - h * h * h, 1.0f / 3.0f);
        nu = 2.0f;
        cb = tb;
        chi2 = chi2_new;
        cur = nxt;
        ++accepted;
      } else {
        lam *= nu;
        nu *= 2.0f;
      }
      // Read by every thread after the next barrier.
      if (t == 0) flags[kFlagCur] = cb;
    }
  }

  // The last assembly at the solution, and the gates.
  __syncthreads();
  cb = flags[kFlagCur];
  pair_terms(npos, nval, fm, pairs, Vs + cb * 3 * T, Ws + (1 - cb) * T * T,
             S, rho, bad, npm, T, NB, first, true);
  __syncthreads();
  if (!w0) return;
  frame_terms<Kind>(cam, R, tc, ou, ov, fmt, Vs + cb * 3 * T,
                    Ws + (1 - cb) * T * T, S, t, T, own, nxt);
  const float n_pairs = warp_sum(row_sum(npm, t, T, own));
  const float bad_pairs = warp_sum(row_sum(bad, t, T, own));
  const float n_frames = warp_sum(fmt);
  const float bad_frames =
      warp_sum((nxt.chi2_r > kReprojReject ? 1.0f : 0.0f) * fmt);
  if (t != 0) return;
  const bool pairs_ok = bad_pairs <= 0.5f * fmaxf(n_pairs, 1.0f);
  const bool frames_ok = bad_frames <= 0.5f * fmaxf(n_frames, 1.0f);

  // The landmark: the last frame's depth along its ray.
  const float* Vl = Vs + cb * 3 * T + 3 * last;
  const float *ql = qs + 4 * last, *tl = ts + 3 * last;
  float X[3], ray[3], Y[3], lm[3];
  apply(ql, tl, Vl, X);
  unproject<Kind>(cam, obs[2 * last], obs[2 * last + 1], ray);
  const float rz = ray[2];
  for (int k = 0; k < 3; ++k) Y[k] = ray[k] / rz * X[2];
  apply_inverse(ql, tl, Y, lm);
  const bool finite = isfinite(lm[0]) && isfinite(lm[1]) && isfinite(lm[2]);
  for (int k = 0; k < 3; ++k) p.landmark_out[3 * c + k] = lm[k];
  p.ok_out[c] =
      (pre_ok && pairs_ok && frames_ok && n_pairs > 0.0f && finite) ? 1 : 0;
  p.accepted_out[c] = accepted;
}

}  // namespace
}  // namespace nrslam

// (sizeof(TriParams), most frames, most neighbours, threads a block): the
// wrapper checks its mirror of the parameters against the first.
extern "C" int nrslam_deformable_triangulation_layout(int* out) {
  out[0] = static_cast<int>(sizeof(nrslam::TriParams));
  out[1] = nrslam::kMaxT;
  out[2] = nrslam::kMaxNb;
  out[3] = nrslam::kTriThreads;
  return 0;
}

// C entry point: *params (host memory, copied into the launch) names device
// pointers only. Returns cudaErrorInvalidValue for sizes the kernel cannot
// run, else cudaGetLastError() after the launch.
extern "C" int nrslam_deformable_triangulation(const void* params,
                                               void* stream) {
  const nrslam::TriParams& p = *static_cast<const nrslam::TriParams*>(params);
  if (p.C <= 0 || p.T < 1 || p.T > nrslam::kMaxT || p.NB < 1 ||
      p.NB > nrslam::kMaxNb || p.n_iters < 0 || p.cg_iters < 0 ||
      (p.kind != nrslam::kPinhole && p.kind != nrslam::kKB8))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * nrslam::Layout(p.T, p.NB).total;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.kind == nrslam::kPinhole)
    nrslam::tri_kernel<nrslam::kPinhole>
        <<<p.C, nrslam::kTriThreads, smem, s>>>(p);
  else
    nrslam::tri_kernel<nrslam::kKB8><<<p.C, nrslam::kTriThreads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
