// Shared scalar device math for the LM kernels (whole-solver and sharded).
//
// Port of nrslam_tpu/solver/pallas_common.py: quaternion / SE(3) algebra,
// the 3x3 adjugate inverse, the damped 6x6 block-Schur solve and inverse,
// and pinhole / Kannala-Brandt-8 projection with its analytic 2x3 Jacobian.
// Everything is float32 with the same formulas (and operation order where it
// matters) as the Pallas kernels, so results match the plain PyTorch drivers
// to float tolerance. Also holds the unary reprojection edges of the
// pose-only kernels and the reductions of a warp and a block.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace nrslam {

constexpr int kPinhole = 0;
constexpr int kKB8 = 1;

// ---------------------------------------------------------------------------
// Quaternions (w, x, y, z) and SE(3)
// ---------------------------------------------------------------------------

__device__ inline void quat_mul(const float a[4], const float b[4],
                                float o[4]) {
  o[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  o[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  o[2] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  o[3] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}

__device__ inline void quat_normalize(float q[4]) {
  const float inv =
      1.0f / sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  for (int k = 0; k < 4; ++k) q[k] *= inv;
}

// v + 2 w (u x v) + 2 u x (u x v)
__device__ inline void quat_rotate(const float q[4], const float v[3],
                                   float o[3]) {
  const float w = q[0], ux = q[1], uy = q[2], uz = q[3];
  const float cx = uy * v[2] - uz * v[1];
  const float cy = uz * v[0] - ux * v[2];
  const float cz = ux * v[1] - uy * v[0];
  const float dx = uy * cz - uz * cy;
  const float dy = uz * cx - ux * cz;
  const float dz = ux * cy - uy * cx;
  o[0] = v[0] + 2.0f * (w * cx + dx);
  o[1] = v[1] + 2.0f * (w * cy + dy);
  o[2] = v[2] + 2.0f * (w * cz + dz);
}

// Row-major 3x3 rotation matrix.
__device__ inline void quat_to_matrix(const float q[4], float R[9]) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  R[0] = 1 - 2 * (yy + zz); R[1] = 2 * (xy - wz);     R[2] = 2 * (xz + wy);
  R[3] = 2 * (xy + wz);     R[4] = 1 - 2 * (xx + zz); R[5] = 2 * (yz - wx);
  R[6] = 2 * (xz - wy);     R[7] = 2 * (yz + wx);     R[8] = 1 - 2 * (xx + yy);
}

// SE(3) exp of the twist (omega, v), Taylor-guarded at theta^2 < 1e-12.
__device__ inline void se3_exp(const float w[3], const float v[3], float q[4],
                               float t[3]) {
  const float theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const bool small = theta2 < 1e-12f;
  const float safe_t2 = small ? 1.0f : theta2;
  const float safe_t = sqrtf(safe_t2);
  const float theta = small ? 0.0f : safe_t;
  const float half = 0.5f * safe_t;
  const float sinc_half = small ? 0.5f - theta2 / 48.0f : sinf(half) / safe_t;
  q[0] = cosf(0.5f * theta);
  q[1] = w[0] * sinc_half;
  q[2] = w[1] * sinc_half;
  q[3] = w[2] * sinc_half;
  const float A = small ? 0.5f - theta2 / 24.0f
                        : (1.0f - cosf(safe_t)) / safe_t2;
  const float B = small ? 1.0f / 6.0f - theta2 / 120.0f
                        : (safe_t - sinf(safe_t)) / (safe_t2 * safe_t);
  const float cx = w[1] * v[2] - w[2] * v[1];
  const float cy = w[2] * v[0] - w[0] * v[2];
  const float cz = w[0] * v[1] - w[1] * v[0];
  const float dx = w[1] * cz - w[2] * cy;
  const float dy = w[2] * cx - w[0] * cz;
  const float dz = w[0] * cy - w[1] * cx;
  t[0] = v[0] + A * cx + B * dx;
  t[1] = v[1] + A * cy + B * dy;
  t[2] = v[2] + A * cz + B * dz;
  quat_normalize(q);
}

// exp(dx) * (q, t): the g2o left-multiplicative update.
__device__ inline void se3_retract(const float q[4], const float t[3],
                                   const float dx[6], float qn[4],
                                   float tn[3]) {
  float qe[4], te[3], rt[3];
  se3_exp(dx, dx + 3, qe, te);
  quat_mul(qe, q, qn);
  quat_normalize(qn);
  quat_rotate(qe, t, rt);
  for (int k = 0; k < 3; ++k) tn[k] = rt[k] + te[k];
}

// ---------------------------------------------------------------------------
// Small dense solves (row-major)
// ---------------------------------------------------------------------------

__device__ inline void inv3(const float m[9], float o[9]) {
  const float a = m[0], b = m[1], c = m[2];
  const float d = m[3], e = m[4], f = m[5];
  const float g = m[6], h = m[7], i = m[8];
  const float A11 = e * i - f * h, A12 = c * h - b * i, A13 = b * f - c * e;
  const float A21 = f * g - d * i, A22 = a * i - c * g, A23 = c * d - a * f;
  const float A31 = d * h - e * g, A32 = b * g - a * h, A33 = a * e - b * d;
  const float det = a * A11 + b * A21 + c * A31;
  const float s = 1.0f / (fabsf(det) > 0.0f ? det : 1.0f);
  o[0] = A11 * s; o[1] = A12 * s; o[2] = A13 * s;
  o[3] = A21 * s; o[4] = A22 * s; o[5] = A23 * s;
  o[6] = A31 * s; o[7] = A32 * s; o[8] = A33 * s;
}

__device__ inline void mat3_mul(const float a[9], const float b[9],
                                float o[9]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      o[i * 3 + j] = a[i * 3] * b[j] + a[i * 3 + 1] * b[3 + j]
                     + a[i * 3 + 2] * b[6 + j];
}

// (H + lam I) blocks A (top-left, damped), B (top-right), C (damped), and
// the Schur pieces Ainv, AinvB, Sinv shared by solve6 and inv6.
__device__ inline void schur6(const float H[36], float lam, float Ainv[9],
                              float AinvB[9], float Sinv[9], float B[9]) {
  float A[9], C[9], BtAB[9], S[9], Bt[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      A[i * 3 + j] = H[i * 6 + j] + (i == j ? lam : 0.0f);
      B[i * 3 + j] = H[i * 6 + j + 3];
      C[i * 3 + j] = H[(i + 3) * 6 + j + 3] + (i == j ? lam : 0.0f);
    }
  inv3(A, Ainv);
  mat3_mul(Ainv, B, AinvB);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) Bt[i * 3 + j] = B[j * 3 + i];
  mat3_mul(Bt, AinvB, BtAB);
  for (int k = 0; k < 9; ++k) S[k] = C[k] - BtAB[k];
  inv3(S, Sinv);
}

// Solve (H + lam I) y = g via the 3x3-block Schur complement.
__device__ inline void solve6(const float H[36], const float g[6], float lam,
                              float y[6]) {
  float Ainv[9], AinvB[9], Sinv[9], B[9];
  schur6(H, lam, Ainv, AinvB, Sinv, B);
  float Ag1[3], rhs2[3];
  for (int i = 0; i < 3; ++i)
    Ag1[i] = Ainv[i * 3] * g[0] + Ainv[i * 3 + 1] * g[1]
             + Ainv[i * 3 + 2] * g[2];
  for (int i = 0; i < 3; ++i)
    rhs2[i] = g[3 + i] - (B[i] * Ag1[0] + B[3 + i] * Ag1[1]
                          + B[6 + i] * Ag1[2]);
  for (int i = 0; i < 3; ++i)
    y[3 + i] = Sinv[i * 3] * rhs2[0] + Sinv[i * 3 + 1] * rhs2[1]
               + Sinv[i * 3 + 2] * rhs2[2];
  for (int i = 0; i < 3; ++i)
    y[i] = Ag1[i] - (AinvB[i * 3] * y[3] + AinvB[i * 3 + 1] * y[4]
                     + AinvB[i * 3 + 2] * y[5]);
}

// Full inverse of (H + lam I) via the same Schur complement.
__device__ inline void inv6(const float H[36], float lam, float o[36]) {
  float Ainv[9], AinvB[9], Sinv[9], B[9], ABS[9], TR[9];
  schur6(H, lam, Ainv, AinvB, Sinv, B);
  mat3_mul(AinvB, Sinv, ABS);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      // TL = Ainv + (AinvB Sinv) AinvB^T
      const float tl = ABS[i * 3] * AinvB[j * 3] + ABS[i * 3 + 1] * AinvB[j * 3 + 1]
                       + ABS[i * 3 + 2] * AinvB[j * 3 + 2];
      o[i * 6 + j] = Ainv[i * 3 + j] + tl;
      TR[i * 3 + j] = -ABS[i * 3 + j];
    }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      o[i * 6 + j + 3] = TR[i * 3 + j];
      o[(i + 3) * 6 + j] = TR[j * 3 + i];
      o[(i + 3) * 6 + j + 3] = Sinv[i * 3 + j];
    }
}

// ---------------------------------------------------------------------------
// Camera projection with Jacobian. cam = (fx, fy, cx, cy, k0..k3).
// J = (d pu/dX, d pu/dY, d pu/dZ, d pv/dX, d pv/dY, d pv/dZ).
// ---------------------------------------------------------------------------

template <int Kind>
__device__ __forceinline__ void project_with_jacobian(const float cam[8],
                                                      float x, float y,
                                                      float z, float* pu,
                                                      float* pv, float J[6]) {
  const float fx = cam[0], fy = cam[1], cx = cam[2], cy = cam[3];
  if constexpr (Kind == kPinhole) {
    const float invz = 1.0f / z;
    *pu = fx * x * invz + cx;
    *pv = fy * y * invz + cy;
    const float invz2 = invz * invz;
    J[0] = fx * invz; J[1] = 0.0f; J[2] = -fx * x * invz2;
    J[3] = 0.0f; J[4] = fy * invz; J[5] = -fy * y * invz2;
  } else {
    const float k0 = cam[4], k1 = cam[5], k2 = cam[6], k3 = cam[7];
    const float x2 = x * x, y2 = y * y, z2 = z * z;
    const float r2 = x2 + y2;
    const float r = sqrtf(r2);
    const float r3 = r2 * r;
    const float theta = atan2f(r, z);
    const float t2 = theta * theta, t4 = t2 * t2, t6 = t4 * t2, t8 = t4 * t4;
    const float f = theta * (1 + k0 * t2 + k1 * t4 + k2 * t6 + k3 * t8);
    const float fd = 1 + 3 * k0 * t2 + 5 * k1 * t4 + 7 * k2 * t6 + 9 * k3 * t8;
    const float psi_c = x / fmaxf(r, 1e-12f);
    const float psi_s = y / fmaxf(r, 1e-12f);
    *pu = fx * f * psi_c + cx;
    *pv = fy * f * psi_s + cy;
    const float denom = r2 * (r2 + z2);
    J[0] = fx * (fd * z * x2 / denom + f * y2 / r3);
    J[1] = fx * (fd * z * x * y / denom - f * x * y / r3);
    J[2] = -fx * fd * x / (r2 + z2);
    J[3] = fy * (fd * z * x * y / denom - f * x * y / r3);
    J[4] = fy * (fd * z * y2 / denom + f * x2 / r3);
    J[5] = -fy * fd * y / (r2 + z2);
  }
}

// The camera kind chosen at run time (the cluster kernels).
__device__ inline void project_with_jacobian(int kind, const float cam[8],
                                             float x, float y, float z,
                                             float* pu, float* pv,
                                             float J[6]) {
  if (kind == kPinhole)
    project_with_jacobian<kPinhole>(cam, x, y, z, pu, pv, J);
  else
    project_with_jacobian<kKB8>(cam, x, y, z, pu, pv, J);
}

// Pose Jacobian rows of the reprojection residual e = obs - pi(Xc):
// J_pose = -dpi @ [-[Xc]x | I] (expmap columns, rotation first).
__device__ inline void pose_jacobian(const float J[6], float xc, float yc,
                                     float zc, float Ju[6], float Jv[6]) {
  const float d00 = -J[0], d01 = -J[1], d02 = -J[2];
  const float d10 = -J[3], d11 = -J[4], d12 = -J[5];
  Ju[0] = d01 * (-zc) + d02 * yc;
  Ju[1] = d00 * zc + d02 * (-xc);
  Ju[2] = d00 * (-yc) + d01 * xc;
  Ju[3] = d00; Ju[4] = d01; Ju[5] = d02;
  Jv[0] = d11 * (-zc) + d12 * yc;
  Jv[1] = d10 * zc + d12 * (-xc);
  Jv[2] = d10 * (-yc) + d11 * xc;
  Jv[3] = d10; Jv[4] = d11; Jv[5] = d12;
}

__device__ inline float huber_w(float chi2, float th) {
  return chi2 <= th ? 1.0f : sqrtf(th / fmaxf(chi2, 1e-20f));
}

__device__ inline float huber_rho(float chi2, float th) {
  return chi2 <= th ? chi2 : 2.0f * sqrtf(th) * sqrtf(fmaxf(chi2, 1e-20f)) - th;
}

// ---------------------------------------------------------------------------
// Unary reprojection edges of the pose-only solves (pose_only.cu,
// pose_only_shard.cu): Huber delta^2 = 5.99
// ---------------------------------------------------------------------------

constexpr float kPoseTh2Dof = 5.99f;

__device__ __forceinline__ void to_camera(const float R[9], const float t[3],
                                          float x, float y, float z,
                                          float c[3]) {
  c[0] = R[0] * x + R[1] * y + R[2] * z + t[0];
  c[1] = R[3] * x + R[4] * y + R[5] * z + t[1];
  c[2] = R[6] * x + R[7] * y + R[8] * z + t[2];
}

// Adds one point's normal-equation terms at pose (R, t) to acc when `on`;
// otherwise every sum keeps its value (a select: no term of a masked point,
// not even an inf or NaN one, reaches a sum). Branch-free, so the compiler
// can interleave a thread's points.
template <int Kind>
__device__ __forceinline__ void add_point(const float cam[8], const float R[9],
                                          const float t[3], float x, float y,
                                          float z, float u, float v, bool on,
                                          float (&acc)[32]) {
  float c[3], pu, pv, J[6], Ju[6], Jv[6];
  to_camera(R, t, x, y, z, c);
  project_with_jacobian<Kind>(cam, c[0], c[1], c[2], &pu, &pv, J);
  const float eu = u - pu, ev = v - pv;
  const float chi2 = eu * eu + ev * ev;
  const float w = huber_w(chi2, kPoseTh2Dof);
  pose_jacobian(J, c[0], c[1], c[2], Ju, Jv);
  int k = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int b = a; b < 6; ++b, ++k) {
      const float s = acc[k] + w * (Ju[a] * Ju[b] + Jv[a] * Jv[b]);
      acc[k] = on ? s : acc[k];
    }
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    const float s = acc[21 + a] + w * (Ju[a] * eu + Jv[a] * ev);
    acc[21 + a] = on ? s : acc[21 + a];
  }
  const float s = acc[27] + huber_rho(chi2, kPoseTh2Dof);
  acc[27] = on ? s : acc[27];
}

// Whether a point's chi2 at pose (R, t) is <= 5.99.
template <int Kind>
__device__ __forceinline__ bool inlier(const float cam[8], const float R[9],
                                       const float t[3], float x, float y,
                                       float z, float u, float v) {
  float c[3], pu, pv, J[6];
  to_camera(R, t, x, y, z, c);
  project_with_jacobian<Kind>(cam, c[0], c[1], c[2], &pu, &pv, J);
  const float eu = u - pu, ev = v - pv;
  return eu * eu + ev * ev <= kPoseTh2Dof;
}

// ---------------------------------------------------------------------------
// Reductions
// ---------------------------------------------------------------------------

// One step of warp_reduce_scatter32: each lane keeps the half of its first
// 2S values whose index has bit S equal to its own lane's and adds its
// partner's (lane ^ S) copy of that half; S is a compile-time constant, so
// every index is too and v stays in registers.
template <int S>
__device__ __forceinline__ void reduce_scatter_step(float (&v)[32],
                                                    int lane) {
  const bool upper = (lane & S) != 0;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const float send = upper ? v[j] : v[j + S];
    const float keep = upper ? v[j + S] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, S);
  }
}

// Reduce-scatter over a warp: on return lane l's v[0] holds the sum over
// the warp's lanes of their v[l], in a fixed order; 16 + 8 + 4 + 2 + 1 =
// 31 shuffles.
__device__ __forceinline__ void warp_reduce_scatter32(float (&v)[32]) {
  const int lane = threadIdx.x & 31;
  reduce_scatter_step<16>(v, lane);
  reduce_scatter_step<8>(v, lane);
  reduce_scatter_step<4>(v, lane);
  reduce_scatter_step<2>(v, lane);
  reduce_scatter_step<1>(v, lane);
}

// Every thread's v[0..32) summed over the block; on return every thread
// holds the same bits of the first N totals in tot. red is [warps][32]
// shared floats that no thread reads until after the next barrier of its
// caller (alternate two buffers between calls). One __syncthreads(): call
// from uniform control flow; blockDim.x a multiple of 32.
template <int N>
__device__ __forceinline__ void block_allreduce(float (&v)[32], float* red,
                                                float (&tot)[N]) {
  static_assert(N <= 32, "at most 32 sums");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_reduce_scatter32(v);
  red[warp * 32 + lane] = v[0];
  __syncthreads();
  float s = red[lane];
  const int nw = blockDim.x >> 5;
  for (int w = 1; w < nw; ++w) s += red[w * 32 + lane];
#pragma unroll
  for (int k = 0; k < N; ++k) tot[k] = __shfl_sync(0xffffffffu, s, k);
}

}  // namespace nrslam
