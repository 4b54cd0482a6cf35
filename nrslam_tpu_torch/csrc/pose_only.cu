// Whole-schedule pose-only LM (motion-only BA) in one launch.
//
// Replaces: nrslam_tpu/solver/pose_only_pallas.py::_pose_kernel (wrapper
// camera_pose_optimization_pallas). Same schedule as the Pallas kernel and
// the plain driver (solver/pose_only.py): rounds of <= 10 LM iterations,
// each round restarting from the seed over the chi2-re-levelled edge set,
// Huber IRLS (delta^2 = 5.99), g2o lambda control, exit on an accepted step
// with |dx|^2 < 1e-12.
//
// What bounds it on an H100: latency. Each call is ~30 dependent evaluations
// of the 6x6 normal equations, each a reduction of 28 sums over <= P points
// (P = 768 on the main path, a few KB), followed by a scalar 6x6 solve. The
// bytes and FLOPs are negligible; what costs is the serial chain.
//
// Design: one block of 256 threads runs the whole schedule with no host
// round trip. Threads stride over the points; each evaluation reduces the
// 21 upper-H, 6 g and 1 chi2 partial sums by warp shuffles and one
// shared-memory pass; thread 0 does the damped Schur solve, the retraction
// and the lambda update and publishes them through shared memory. The
// per-point re-level mask lives in a global scratch row the wrapper
// allocates; each thread only touches its own points.

#include "common.cuh"

namespace nrslam {
namespace {

constexpr int kThreads = 256;
constexpr float kTh2Dof = 5.99f;
constexpr int kSums = 28;  // 21 upper H, 6 g, 1 robust chi2

// Per-thread partial normal equations at pose (q, t) over the thread's
// points (mask 0 points contribute exactly nothing).
__device__ void pose_partials(int kind, const float cam[8], const float q[4],
                              const float t[3], const float* X,
                              const float* obs, const float* mask, int P,
                              float acc[kSums]) {
  float R[9];
  quat_to_matrix(q, R);
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.0f;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const float m = mask[i];
    if (m == 0.0f) continue;
    const float x = X[3 * i], y = X[3 * i + 1], z = X[3 * i + 2];
    const float xc = R[0] * x + R[1] * y + R[2] * z + t[0];
    const float yc = R[3] * x + R[4] * y + R[5] * z + t[1];
    const float zc = R[6] * x + R[7] * y + R[8] * z + t[2];
    float pu, pv, J[6], Ju[6], Jv[6];
    project_with_jacobian(kind, cam, xc, yc, zc, &pu, &pv, J);
    const float eu = obs[2 * i] - pu, ev = obs[2 * i + 1] - pv;
    const float chi2 = eu * eu + ev * ev;
    const float w = huber_w(chi2, kTh2Dof) * m;
    pose_jacobian(J, xc, yc, zc, Ju, Jv);
    int k = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a)
#pragma unroll
      for (int b = a; b < 6; ++b) acc[k++] += w * (Ju[a] * Ju[b] + Jv[a] * Jv[b]);
#pragma unroll
    for (int a = 0; a < 6; ++a) acc[21 + a] += w * (Ju[a] * eu + Jv[a] * ev);
    acc[27] += huber_rho(chi2, kTh2Dof) * m;
  }
}

__global__ void __launch_bounds__(kThreads)
pose_only_kernel(const float* __restrict__ params, const float* __restrict__ X,
                 const float* __restrict__ obs,
                 const float* __restrict__ valid, float* level_mask,
                 float* out, int P, int kind, int n_rounds, int it0, int it1,
                 int it2, int it3) {
  __shared__ float red[32 * kSums];
  __shared__ float tot[kSums];
  __shared__ float s_q[4], s_t[3], s_qn[4], s_tn[3];
  __shared__ float s_H[36], s_g[6], s_dx[6];
  __shared__ float s_lam, s_nu, s_chi2;
  __shared__ int s_done;

  float cam[8];
  for (int k = 0; k < 8; ++k) cam[k] = params[k];
  const int iters[4] = {it0, it1, it2, it3};

  for (int i = threadIdx.x; i < P; i += blockDim.x) level_mask[i] = valid[i];

  float acc[kSums];
  int n_lm = 0;  // LM steps run, the same in every thread
  for (int r = 0; r < n_rounds; ++r) {
    if (threadIdx.x == 0) {
      for (int k = 0; k < 4; ++k) s_q[k] = params[8 + k];
      for (int k = 0; k < 3; ++k) s_t[k] = params[12 + k];
    }
    __syncthreads();
    pose_partials(kind, cam, s_q, s_t, X, obs, level_mask, P, acc);
    block_sum<kSums>(acc, red, tot);
    if (threadIdx.x == 0) {
      int k = 0;
      for (int a = 0; a < 6; ++a)
        for (int b = a; b < 6; ++b) {
          s_H[a * 6 + b] = tot[k];
          s_H[b * 6 + a] = tot[k];
          ++k;
        }
      for (int a = 0; a < 6; ++a) s_g[a] = tot[21 + a];
      s_chi2 = tot[27];
      float dmax = s_H[0];
      for (int a = 1; a < 6; ++a) dmax = fmaxf(dmax, s_H[a * 6 + a]);
      s_lam = 1e-5f * dmax;
      s_nu = 2.0f;
      s_done = 0;
    }
    __syncthreads();

    for (int j = 0; j < iters[r]; ++j) {
      if (s_done) break;  // uniform: written by thread 0 before a barrier
      ++n_lm;
      if (threadIdx.x == 0) {
        float y[6];
        solve6(s_H, s_g, s_lam, y);
        for (int a = 0; a < 6; ++a) s_dx[a] = -y[a];
        se3_retract(s_q, s_t, s_dx, s_qn, s_tn);
      }
      __syncthreads();
      pose_partials(kind, cam, s_qn, s_tn, X, obs, level_mask, P, acc);
      block_sum<kSums>(acc, red, tot);
      if (threadIdx.x == 0) {
        const float lam = s_lam, nu = s_nu;
        float denom = 0.0f, dx2 = 0.0f;
        for (int a = 0; a < 6; ++a) {
          denom += s_dx[a] * (lam * s_dx[a] - s_g[a]);
          dx2 += s_dx[a] * s_dx[a];
        }
        const float chi2n = tot[27];
        const float rho = (s_chi2 - chi2n) / (fabsf(denom) > 0.0f ? denom : 1.0f);
        const bool accepted = rho > 0.0f;
        const float c = 2.0f * rho - 1.0f;
        const float shrink = fmaxf(1.0f / 3.0f, 1.0f - c * c * c);
        s_lam = accepted ? lam * shrink : lam * nu;
        s_nu = accepted ? 2.0f : nu * 2.0f;
        if (accepted) {
          for (int k = 0; k < 4; ++k) s_q[k] = s_qn[k];
          for (int k = 0; k < 3; ++k) s_t[k] = s_tn[k];
          int k = 0;
          for (int a = 0; a < 6; ++a)
            for (int b = a; b < 6; ++b) {
              s_H[a * 6 + b] = tot[k];
              s_H[b * 6 + a] = tot[k];
              ++k;
            }
          for (int a = 0; a < 6; ++a) s_g[a] = tot[21 + a];
          s_chi2 = chi2n;
          s_done = dx2 < 1e-12f;
        }
      }
      __syncthreads();
    }

    // Re-level by chi2 at the round optimum over the full valid set.
    float R[9];
    quat_to_matrix(s_q, R);
    for (int i = threadIdx.x; i < P; i += blockDim.x) {
      const float x = X[3 * i], y = X[3 * i + 1], z = X[3 * i + 2];
      const float xc = R[0] * x + R[1] * y + R[2] * z + s_t[0];
      const float yc = R[3] * x + R[4] * y + R[5] * z + s_t[1];
      const float zc = R[6] * x + R[7] * y + R[8] * z + s_t[2];
      float pu, pv, J[6];
      project_with_jacobian(kind, cam, xc, yc, zc, &pu, &pv, J);
      const float eu = obs[2 * i] - pu, ev = obs[2 * i + 1] - pv;
      level_mask[i] = (eu * eu + ev * ev <= kTh2Dof) ? valid[i] : 0.0f;
    }
    __syncthreads();
  }

  if (threadIdx.x == 0) {
    for (int k = 0; k < 4; ++k) out[k] = s_q[k];
    for (int k = 0; k < 3; ++k) out[4 + k] = s_t[k];
    out[7] = static_cast<float>(n_lm);
  }
}

}  // namespace
}  // namespace nrslam

// C entry point. Pointers are device pointers; out = (q (4), t (3), LM
// steps run). Returns cudaGetLastError().
extern "C" int nrslam_pose_only(const void* params, const void* X,
                                const void* obs, const void* valid,
                                void* level_mask, void* out, int P, int kind,
                                int n_rounds, int it0, int it1, int it2,
                                int it3, void* stream) {
  nrslam::pose_only_kernel<<<1, nrslam::kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(params), static_cast<const float*>(X),
      static_cast<const float*>(obs), static_cast<const float*>(valid),
      static_cast<float*>(level_mask), static_cast<float*>(out), P, kind,
      n_rounds, it0, it1, it2, it3);
  return static_cast<int>(cudaGetLastError());
}
