// Whole-schedule pose-only LM (motion-only BA) in one launch of one block.
//
// Replaces: nrslam_tpu/solver/pose_only_pallas.py::_pose_kernel (wrapper
// camera_pose_optimization_pallas). Same schedule and arithmetic as the
// Pallas kernel and the plain driver (solver/pose_only.py): each round
// restarts from the seed and runs <= rounds[r] LM steps over the points the
// previous round's optimum left at chi2 <= 5.99 (all valid points in the
// first), Huber IRLS (delta^2 = 5.99), lambda0 = 1e-5 max diag(H) then g2o's
// shrink / nu update, exit on an accepted step with |dx|^2 < 1e-12, float32
// throughout. Masked points are skipped, never multiplied by zero.
//
// What bounds it on an H100: latency. A call is ~30 dependent evaluations
// of the 6x6 normal equations (a reduction of 28 sums over <= P points, P =
// 768 on the main path), each followed by a 6x6 solve whose result the next
// one needs; ~4 MFLOP and ~20 KB in all. What costs is the chain of passes,
// so the design shortens each link:
//
// - One block, no cluster: a cluster reduction alone (~1.1-1.5 us on an
//   H100) costs more than a whole pass here. The thread count comes from P
//   (the wrapper's plan, pose_only_cuda.plan), at most kMaxThreads.
// - Points are read from global memory once. Thread tid keeps the points
//   i = r * threads + tid (r < kRegPts) in registers, the next n_sh points
//   in dynamic shared memory (SoA x, y, z, u, v and a state byte), and the
//   rest, where shared memory is full, stays in global memory with its state
//   byte in a global row. Each point's re-level state lives with it and only
//   its own thread touches it, so no barrier guards the points.
// - One barrier per evaluation. Each warp reduce-scatters its 28 partials
//   (padded to 32) in 31 shuffles, lane k ending with the warp's sum of
//   value k, into a per-warp slot of one of two buffers that alternate by
//   pass parity (a buffer is rewritten only after a later barrier); after
//   the barrier every warp sums the slots in warp order and broadcasts the
//   28 totals to its lanes (common.cuh block_allreduce).
// - No serial section: every thread runs the LM bookkeeping (6x6 Schur
//   solve, SE(3) retraction, gain ratio, lambda / nu, accept, done) on the
//   same totals with the same instructions, so all get the same bits and
//   take the same branches, and nothing is published through shared
//   memory. The fixed sum order makes two launches bit-identical.
// - A thread's register points run as straight-line code, so the compiler
//   interleaves their latency chains: the number of slots any thread uses
//   is a block-uniform case, and a masked point's terms are computed but
//   never added (a select keeps each sum). Division and square root stay
//   IEEE, as in the plain driver and the other kernels.
// - The camera model is a template parameter (no branch in the point loop)
//   and no local array is indexed at run time.
// - Re-levelling is fused: each thread re-levels its own points at the
//   round's optimum right after the round's last step, with no barrier, and
//   the next round's first evaluation follows. The last round's re-level
//   changes nothing returned and is not run.
// - q is written normalised, so the wrapper launches nothing but this.

#include "common.cuh"

namespace nrslam {
namespace {

constexpr int kMaxThreads = 256;
constexpr int kRegPts = 4;  // points a thread keeps in registers
constexpr int kSums = 28;  // 21 upper H, 6 g, 1 robust chi2
constexpr unsigned kValid = 1, kLevel = 2;  // state byte of a shared / global point
static_assert(kMaxThreads % 32 == 0 && kMaxThreads <= 1024, "block size");
static_assert(kRegPts >= 1 && kRegPts <= 16, "state bits of register points");

struct Args {
  const float* cam;              // fx, fy, cx, cy (, k0..k3 for KB8)
  const float* q0;               // [4]
  const float* t0;               // [3]
  const float* X;                // [P, 3]
  const float* obs;              // [P, 2]
  const unsigned char* valid;    // [P], 0 or 1
  const int* rounds;             // [n_rounds] LM steps of each round
  unsigned char* gl_state;       // [P - n_reg - n_sh] state of global points
  float* out;                    // q (4, normalised), t (3), LM steps run
  int P, n_rounds, n_reg, n_sh;
};

// A thread's register points; bits: r valid, 16 + r level.
struct RegPoints {
  float x[kRegPts], y[kRegPts], z[kRegPts], u[kRegPts], v[kRegPts];
  unsigned bits;
};

// The shared points, SoA, after the reduction buffers.
struct SharedPoints {
  float *x, *y, *z, *u, *v;
  unsigned char* state;
};

// The register points of the first N slots, in straight-line code (N the
// slots any thread of the block uses, so no slot is run for nothing).
template <int Kind, int N>
__device__ __forceinline__ void add_reg_points(int n_slots, const float cam[8],
                                               const float R[9],
                                               const float t[3],
                                               const RegPoints& rp,
                                               float (&acc)[32]) {
  if (n_slots == N) {
#pragma unroll
    for (int r = 0; r < N; ++r)
      add_point<Kind>(cam, R, t, rp.x[r], rp.y[r], rp.z[r], rp.u[r], rp.v[r],
                      (rp.bits >> (16 + r) & 1u) != 0, acc);
  } else if constexpr (N > 1) {
    add_reg_points<Kind, N - 1>(n_slots, cam, R, t, rp, acc);
  }
}

// This thread's partial sums over its points at the current level.
template <int Kind>
__device__ __forceinline__ void partials(const Args& a, const float cam[8],
                                         const RegPoints& rp,
                                         const SharedPoints& sp,
                                         const float q[4], const float t[3],
                                         float (&acc)[32]) {
  float R[9];
  quat_to_matrix(q, R);
#pragma unroll
  for (int k = 0; k < 32; ++k) acc[k] = 0.0f;
  const int T = blockDim.x;
  add_reg_points<Kind, kRegPts>((a.n_reg + T - 1) / T, cam, R, t, rp, acc);
  for (int s = threadIdx.x; s < a.n_sh; s += T)
    if (sp.state[s] & kLevel)
      add_point<Kind>(cam, R, t, sp.x[s], sp.y[s], sp.z[s], sp.u[s], sp.v[s],
                      true, acc);
  const int g0 = a.n_reg + a.n_sh;
  for (int g = threadIdx.x; g0 + g < a.P; g += T)
    if (a.gl_state[g] & kLevel) {
      const int i = g0 + g;
      add_point<Kind>(cam, R, t, a.X[3 * i], a.X[3 * i + 1], a.X[3 * i + 2],
                      a.obs[2 * i], a.obs[2 * i + 1], true, acc);
    }
}

// Re-level this thread's valid points by their chi2 at pose (q, t).
template <int Kind>
__device__ __forceinline__ void relevel(const Args& a, const float cam[8],
                                        RegPoints& rp, const SharedPoints& sp,
                                        const float q[4], const float t[3]) {
  float R[9];
  quat_to_matrix(q, R);
#pragma unroll
  for (int r = 0; r < kRegPts; ++r)
    if (rp.bits >> r & 1u) {
      const unsigned bit = 1u << (16 + r);
      rp.bits = inlier<Kind>(cam, R, t, rp.x[r], rp.y[r], rp.z[r], rp.u[r],
                             rp.v[r])
                    ? rp.bits | bit
                    : rp.bits & ~bit;
    }
  const int T = blockDim.x;
  for (int s = threadIdx.x; s < a.n_sh; s += T)
    if (sp.state[s] & kValid)
      sp.state[s] = inlier<Kind>(cam, R, t, sp.x[s], sp.y[s], sp.z[s],
                                 sp.u[s], sp.v[s])
                        ? kValid | kLevel
                        : kValid;
  const int g0 = a.n_reg + a.n_sh;
  for (int g = threadIdx.x; g0 + g < a.P; g += T)
    if (a.gl_state[g] & kValid) {
      const int i = g0 + g;
      a.gl_state[g] = inlier<Kind>(cam, R, t, a.X[3 * i], a.X[3 * i + 1],
                                   a.X[3 * i + 2], a.obs[2 * i],
                                   a.obs[2 * i + 1])
                          ? kValid | kLevel
                          : kValid;
    }
}

// Upper-triangle totals (row-major, a <= b) into the full symmetric 6x6.
__device__ __forceinline__ void unpack_h(const float (&Hu)[21], float H[36]) {
  int k = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int b = a; b < 6; ++b) {
      H[a * 6 + b] = Hu[k];
      H[b * 6 + a] = Hu[k];
      ++k;
    }
}

template <int Kind>
__global__ void __launch_bounds__(kMaxThreads, 1)
pose_only_kernel(const Args a) {
  extern __shared__ float smem[];
  const int T = blockDim.x, tid = threadIdx.x, nw = T >> 5;
  float* red = smem;  // [2][nw][32], alternating by pass parity
  SharedPoints sp;
  sp.x = smem + 64 * nw;
  sp.y = sp.x + a.n_sh;
  sp.z = sp.y + a.n_sh;
  sp.u = sp.z + a.n_sh;
  sp.v = sp.u + a.n_sh;
  sp.state = reinterpret_cast<unsigned char*>(sp.v + a.n_sh);

  float cam[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    cam[k] = (k < 4 || Kind == kKB8) ? a.cam[k] : 0.0f;
  float q0[4], t0[3];
#pragma unroll
  for (int k = 0; k < 4; ++k) q0[k] = a.q0[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) t0[k] = a.t0[k];

  // Each point read once, into the place it keeps for the whole call; each
  // thread writes only the shared and global state it reads later itself.
  RegPoints rp;
  rp.bits = 0;
#pragma unroll
  for (int r = 0; r < kRegPts; ++r) {
    const int i = r * T + tid;
    const bool in = i < a.n_reg;
    rp.x[r] = in ? a.X[3 * i] : 0.0f;
    rp.y[r] = in ? a.X[3 * i + 1] : 0.0f;
    rp.z[r] = in ? a.X[3 * i + 2] : 0.0f;
    rp.u[r] = in ? a.obs[2 * i] : 0.0f;
    rp.v[r] = in ? a.obs[2 * i + 1] : 0.0f;
    if (in && a.valid[i]) rp.bits |= (1u << r) | (1u << (16 + r));
  }
  for (int s = tid; s < a.n_sh; s += T) {
    const int i = a.n_reg + s;
    sp.x[s] = a.X[3 * i];
    sp.y[s] = a.X[3 * i + 1];
    sp.z[s] = a.X[3 * i + 2];
    sp.u[s] = a.obs[2 * i];
    sp.v[s] = a.obs[2 * i + 1];
    sp.state[s] = a.valid[i] ? kValid | kLevel : 0;
  }
  for (int g = tid, g0 = a.n_reg + a.n_sh; g0 + g < a.P; g += T)
    a.gl_state[g] = a.valid[g0 + g] ? kValid | kLevel : 0;

  // LM state: the same bits in every thread.
  float q[4], t[3], Hu[21], g[6], acc[32], tot[kSums];
  float chi2 = 0.0f, lam = 0.0f, nu = 2.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = q0[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = t0[k];
  int n_lm = 0, pass = 0;

  for (int r = 0; r < a.n_rounds; ++r) {
    const int iters = a.rounds[r];
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = q0[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) t[k] = t0[k];
    partials<Kind>(a, cam, rp, sp, q, t, acc);
    block_allreduce(acc, red + (pass++ & 1) * nw * 32, tot);
#pragma unroll
    for (int k = 0; k < 21; ++k) Hu[k] = tot[k];
#pragma unroll
    for (int k = 0; k < 6; ++k) g[k] = tot[21 + k];
    chi2 = tot[27];
    // Diagonal of the packed upper triangle: 0, 6, 11, 15, 18, 20.
    const float dmax = fmaxf(fmaxf(fmaxf(fmaxf(fmaxf(Hu[0], Hu[6]), Hu[11]),
                                         Hu[15]), Hu[18]), Hu[20]);
    lam = 1e-5f * dmax;
    nu = 2.0f;
    bool done = false;

    for (int j = 0; j < iters && !done; ++j) {
      ++n_lm;
      float H[36], y[6], dx[6], qn[4], tn[3];
      unpack_h(Hu, H);
      solve6(H, g, lam, y);
#pragma unroll
      for (int k = 0; k < 6; ++k) dx[k] = -y[k];
      se3_retract(q, t, dx, qn, tn);
      float denom = 0.0f, dx2 = 0.0f;
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        denom += dx[k] * (lam * dx[k] - g[k]);
        dx2 += dx[k] * dx[k];
      }
      partials<Kind>(a, cam, rp, sp, qn, tn, acc);
      block_allreduce(acc, red + (pass++ & 1) * nw * 32, tot);
      const float chi2n = tot[27];
      const float rho = (chi2 - chi2n) / (fabsf(denom) > 0.0f ? denom : 1.0f);
      const bool accepted = rho > 0.0f;
      const float c = 2.0f * rho - 1.0f;
      const float shrink = fmaxf(1.0f / 3.0f, 1.0f - c * c * c);
      lam = accepted ? lam * shrink : lam * nu;
      nu = accepted ? 2.0f : nu * 2.0f;
      if (accepted) {
#pragma unroll
        for (int k = 0; k < 4; ++k) q[k] = qn[k];
#pragma unroll
        for (int k = 0; k < 3; ++k) t[k] = tn[k];
#pragma unroll
        for (int k = 0; k < 21; ++k) Hu[k] = tot[k];
#pragma unroll
        for (int k = 0; k < 6; ++k) g[k] = tot[21 + k];
        chi2 = chi2n;
        done = dx2 < 1e-12f;
      }
    }
    if (r + 1 < a.n_rounds) relevel<Kind>(a, cam, rp, sp, q, t);
  }

  if (tid == 0) {
    const float n = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
#pragma unroll
    for (int k = 0; k < 4; ++k) a.out[k] = q[k] / n;
#pragma unroll
    for (int k = 0; k < 3; ++k) a.out[4 + k] = t[k];
    a.out[7] = static_cast<float>(n_lm);
  }
}

template <int Kind>
cudaError_t launch(const Args& a, int threads, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      pose_only_kernel<Kind>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  pose_only_kernel<Kind><<<1, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace nrslam

// The kernel's limits on `device`: out = (most threads a block may have,
// points a thread keeps in registers, dynamic shared bytes a block may use).
extern "C" int nrslam_pose_only_limits(int device, int* out) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  cudaFuncAttributes pin, kb8;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&pin, nrslam::pose_only_kernel<nrslam::kPinhole>);
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&kb8, nrslam::pose_only_kernel<nrslam::kKB8>);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t fixed = pin.sharedSizeBytes > kb8.sharedSizeBytes
                           ? pin.sharedSizeBytes
                           : kb8.sharedSizeBytes;
  out[0] = nrslam::kMaxThreads;
  out[1] = nrslam::kRegPts;
  out[2] = optin - static_cast<int>(fixed);
  return 0;
}

// C entry point. Pointers are device pointers: cam (4 floats pinhole, 8
// KB8), q0 [4], t0 [3], X [P, 3], obs [P, 2], valid [P] uint8, rounds
// [n_rounds] int32, gl_state [P - n_reg - n_sh] uint8 scratch (may be null
// when that is 0), out [8] = (q normalised, t, LM steps run). threads,
// n_reg, n_sh and smem are the wrapper's plan (pose_only_cuda.plan).
// Returns cudaErrorInvalidValue for a plan the kernel cannot run, else
// cudaGetLastError() after the launch.
extern "C" int nrslam_pose_only(const void* cam, const void* q0,
                                const void* t0, const void* X,
                                const void* obs, const void* valid,
                                const void* rounds, void* gl_state, void* out,
                                int P, int kind, int n_rounds, int threads,
                                int n_reg, int n_sh, int smem, void* stream) {
  const long reg_cap = static_cast<long>(nrslam::kRegPts) * threads;
  const long need = 4L * (64L * (threads / 32) + 5L * n_sh) + n_sh;
  const bool ok = P >= 0 && n_rounds >= 0 && (kind == nrslam::kPinhole ||
                                              kind == nrslam::kKB8) &&
                  threads >= 32 && threads <= nrslam::kMaxThreads &&
                  threads % 32 == 0 && n_reg == (P < reg_cap ? P : reg_cap) &&
                  n_sh >= 0 && n_sh <= P - n_reg && smem >= need &&
                  (n_reg + n_sh == P || gl_state != nullptr);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  nrslam::Args a;
  a.cam = static_cast<const float*>(cam);
  a.q0 = static_cast<const float*>(q0);
  a.t0 = static_cast<const float*>(t0);
  a.X = static_cast<const float*>(X);
  a.obs = static_cast<const float*>(obs);
  a.valid = static_cast<const unsigned char*>(valid);
  a.rounds = static_cast<const int*>(rounds);
  a.gl_state = static_cast<unsigned char*>(gl_state);
  a.out = static_cast<float*>(out);
  a.P = P;
  a.n_rounds = n_rounds;
  a.n_reg = n_reg;
  a.n_sh = n_sh;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(kind == nrslam::kKB8
                              ? nrslam::launch<nrslam::kKB8>(a, threads, smem, s)
                              : nrslam::launch<nrslam::kPinhole>(a, threads,
                                                                 smem, s));
}
