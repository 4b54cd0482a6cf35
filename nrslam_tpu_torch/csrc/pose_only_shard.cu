// Pose-only LM partitioned over the ranks' point blocks: phase kernels
// whose partial sums are all-reduced between launches.
//
// Partitions: nrslam_tpu/solver/pose_only_pallas.py::_pose_kernel (the
// whole-solver kernel is csrc/pose_only.cu). Same schedule and arithmetic
// as the plain sharded driver (parallel/solve_shard.py,
// camera_pose_optimization_sharded): each round restarts from the seed,
// runs its LM trips over the points the previous round's optimum left at
// chi2 <= 5.99, Huber IRLS (delta^2 = 5.99), lambda0 = 1e-5 max diag(H)
// then g2o's shrink / nu update, every update gated on `run = !done` for
// the fixed trip count.
//
// A whole-solver kernel cannot wait inside one launch for another
// process's partial sums, so the solve is cut at its reductions. The host
// (pose_only_cuda.shard) enqueues on one stream, per LM trip:
//   partials (one block over the rank's m points: the 28 sums of the 6x6
//   normal equations at the trial pose) -> all_reduce -> step (one thread:
//   gain ratio, lambda / nu, accept, then the next trial pose from solve6
//   and se3_retract);
// and between rounds `relevel` over the rank's own points (no collective).
// Every rank runs the step on the same reduced sums, so all hold the same
// pose bits. Nothing is read back to the host: the LM state (pose, trial,
// H, g, chi2, lambda, nu, done, dx) lives in a device row `st`, and a
// partials launch after `done` writes zeros, which the step ignores.
//
// The sums do not depend on how the points are split over ranks: a warp
// sums each chunk of kChunk consecutive global points in a fixed order
// (common.cuh warp_reduce_scatter32) into the chunk's row of a zero-filled
// [chunks, 28] buffer, the all_reduce adds the ranks' rows (each chunk
// from the one rank that owns it, when the blocks are whole chunks), and
// the step adds the chunks in order. So n ranks and one process give the
// same bits.

#include "common.cuh"

namespace nrslam {
namespace {

constexpr int kThreads = 256;
constexpr int kSums = 28;  // 21 upper H, 6 g, 1 robust chi2
constexpr int kChunk = 64;  // points a chunk's partial sums cover

// The device row st (floats): poses are (q [4], t [3]).
enum : int {
  kT0 = 0,      // seed
  kT = 7,       // accepted
  kTn = 14,     // trial, where the next partials launch evaluates
  kHu = 21,     // [21] upper H of the accepted pose
  kG = 42,      // [6]
  kChi2 = 48,
  kLam = 49,
  kNu = 50,
  kDone = 51,
  kDx = 52,     // [6] the step from kT to kTn
  kOut = 58,    // q normalised (4), t (3), LM steps run
  kStFloats = 66
};

// The partial sums of the rank's points [p0, p0 + m) of P at the pose at
// offset `pose` of st, by chunk: red [ceil(P / kChunk)][28], zero outside
// the rank's chunks.
template <int Kind>
__global__ void __launch_bounds__(kThreads, 1)
partials_kernel(const float* __restrict__ cam_in, const float* st, int pose,
                const float* __restrict__ X, const float* __restrict__ obs,
                const unsigned char* __restrict__ level, int m, int p0, int P,
                int gate, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int g0 = p0 / kChunk, g1 = (p0 + m - 1) / kChunk;
  const int nc = (P + kChunk - 1) / kChunk;
  for (int k = threadIdx.x; k < nc * kSums; k += blockDim.x)
    if (k / kSums < g0 || k / kSums > g1) red[k] = 0.0f;
  float cam[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    cam[k] = (k < 4 || Kind == kKB8) ? cam_in[k] : 0.0f;
  const bool skip = gate && st[kDone] != 0.0f;
  float q[4], t[3], R[9];
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = st[pose + k];
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = st[pose + 4 + k];
  quat_to_matrix(q, R);
  for (int g = g0 + warp; g <= g1; g += nw) {
    float acc[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) acc[k] = 0.0f;
    for (int h = 0; h < kChunk; h += 32) {
      const int i = g * kChunk + h + lane - p0;
      if (!skip && i >= 0 && i < m && level[i])
        add_point<Kind>(cam, R, t, X[3 * i], X[3 * i + 1], X[3 * i + 2],
                        obs[2 * i], obs[2 * i + 1], true, acc);
    }
    warp_reduce_scatter32(acc);
    if (lane < kSums) red[g * kSums + lane] = acc[0];
  }
}

template <int Kind>
__global__ void __launch_bounds__(kThreads, 1)
relevel_kernel(const float* __restrict__ cam_in, const float* st,
               const float* __restrict__ X, const float* __restrict__ obs,
               const unsigned char* __restrict__ valid, unsigned char* level,
               int m) {
  float cam[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    cam[k] = (k < 4 || Kind == kKB8) ? cam_in[k] : 0.0f;
  float q[4], t[3], R[9];
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = st[kT + k];
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = st[kT + 4 + k];
  quat_to_matrix(q, R);
  for (int i = threadIdx.x; i < m; i += blockDim.x)
    level[i] = valid[i] && inlier<Kind>(cam, R, t, X[3 * i], X[3 * i + 1],
                                        X[3 * i + 2], obs[2 * i],
                                        obs[2 * i + 1]);
}

__device__ inline void unpack_h(const float* Hu, float H[36]) {
  int k = 0;
  for (int a = 0; a < 6; ++a)
    for (int b = a; b < 6; ++b, ++k) {
      H[a * 6 + b] = Hu[k];
      H[b * 6 + a] = Hu[k];
    }
}

// One thread. The reduced chunk rows red [nc][28] summed in chunk order;
// init: they are the round's first evaluation at the seed: take them,
// lambda0, nu = 2, not done, pose = seed. Else they are the trial's: gain
// ratio, lambda / nu, accept, done. Then the next trial pose.
__global__ void step_kernel(float* st, const float* __restrict__ chunks,
                            int nc, int init) {
  if (threadIdx.x != 0) return;
  float red[kSums];
  for (int k = 0; k < kSums; ++k) red[k] = 0.0f;
  for (int g = 0; g < nc; ++g)
    for (int k = 0; k < kSums; ++k) red[k] += chunks[g * kSums + k];
  if (init) {
    for (int k = 0; k < kSums; ++k) st[kHu + k] = red[k];
    // Diagonal of the packed upper triangle: 0, 6, 11, 15, 18, 20.
    const float* Hu = red;
    const float dmax = fmaxf(fmaxf(fmaxf(fmaxf(fmaxf(Hu[0], Hu[6]), Hu[11]),
                                         Hu[15]), Hu[18]), Hu[20]);
    st[kLam] = 1e-5f * dmax;
    st[kNu] = 2.0f;
    st[kDone] = 0.0f;
    for (int k = 0; k < 7; ++k) st[kT + k] = st[kT0 + k];
  } else {
    const float lam = st[kLam], nu = st[kNu], chi2n = red[27];
    float denom = 0.0f, dx2 = 0.0f;
    for (int k = 0; k < 6; ++k) {
      const float dx = st[kDx + k];
      denom += dx * (lam * dx - st[kG + k]);
      dx2 += dx * dx;
    }
    const float rho = (st[kChi2] - chi2n) / (fabsf(denom) > 0.0f ? denom : 1.0f);
    const bool accepted = rho > 0.0f;
    const float c = 2.0f * rho - 1.0f;
    const float shrink = fmaxf(1.0f / 3.0f, 1.0f - c * c * c);
    const bool run = st[kDone] == 0.0f;
    if (run) {
      st[kLam] = accepted ? lam * shrink : lam * nu;
      st[kNu] = accepted ? 2.0f : nu * 2.0f;
      st[kOut + 7] += 1.0f;
      if (accepted) {
        for (int k = 0; k < 7; ++k) st[kT + k] = st[kTn + k];
        for (int k = 0; k < kSums; ++k) st[kHu + k] = red[k];
        if (dx2 < 1e-12f) st[kDone] = 1.0f;
      }
    }
  }
  float H[36], g[6], y[6], dx[6];
  unpack_h(st + kHu, H);
  for (int k = 0; k < 6; ++k) g[k] = st[kG + k];
  solve6(H, g, st[kLam], y);
  for (int k = 0; k < 6; ++k) dx[k] = -y[k];
  se3_retract(st + kT, st + kT + 4, dx, st + kTn, st + kTn + 4);
  for (int k = 0; k < 6; ++k) st[kDx + k] = dx[k];
  const float* q = st + kT;
  const float n = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  for (int k = 0; k < 4; ++k) st[kOut + k] = q[k] / n;
  for (int k = 0; k < 3; ++k) st[kOut + 4 + k] = st[kT + 4 + k];
}

}  // namespace
}  // namespace nrslam

// out = (floats of the device row st the host allocates, zeroed, offset of
// the result (q normalised, t, LM steps run), of the seed pose, of the
// trial pose, points a chunk of the partial sums covers).
extern "C" int nrslam_pose_shard_layout(int* out) {
  out[0] = nrslam::kStFloats;
  out[1] = nrslam::kOut;
  out[2] = nrslam::kT0;
  out[3] = nrslam::kTn;
  out[4] = nrslam::kChunk;
  return 0;
}

// The partial sums of the normal equations over the rank's points X [m, 3],
// obs [m, 2] with level [m] (uint8) set, global points [p0, p0 + m) of P,
// at the pose at offset `pose` of st (the seed or the trial), into red
// [ceil(P / chunk)][28] by chunk (zeros outside the rank's chunks). gate
// != 0: zeros once st says done. cam: 8 floats (pinhole uses 4).
extern "C" int nrslam_pose_shard_partials(const void* cam, const void* st,
                                          int pose, const void* X,
                                          const void* obs, const void* level,
                                          int m, int p0, int P, int kind,
                                          int gate, void* red, void* stream) {
  if (m < 1 || p0 < 0 || p0 + m > P ||
      (kind != nrslam::kPinhole && kind != nrslam::kKB8) ||
      (pose != nrslam::kT0 && pose != nrslam::kTn))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(cam);
  const float* sp = static_cast<const float*>(st);
  const float* x = static_cast<const float*>(X);
  const float* o = static_cast<const float*>(obs);
  const unsigned char* l = static_cast<const unsigned char*>(level);
  float* r = static_cast<float*>(red);
  if (kind == nrslam::kKB8)
    nrslam::partials_kernel<nrslam::kKB8><<<1, nrslam::kThreads, 0, s>>>(
        c, sp, pose, x, o, l, m, p0, P, gate, r);
  else
    nrslam::partials_kernel<nrslam::kPinhole><<<1, nrslam::kThreads, 0, s>>>(
        c, sp, pose, x, o, l, m, p0, P, gate, r);
  return static_cast<int>(cudaGetLastError());
}

// The LM step on the reduced chunk rows red [nc][28] (init != 0: a round's
// first evaluation), in st.
extern "C" int nrslam_pose_shard_step(void* st, const void* red, int nc,
                                      int init, void* stream) {
  nrslam::step_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(st), static_cast<const float*>(red), nc, init);
  return static_cast<int>(cudaGetLastError());
}

// Re-level: level[i] = valid[i] && chi2 <= 5.99 at st's accepted pose.
extern "C" int nrslam_pose_shard_relevel(const void* cam, const void* st,
                                         const void* X, const void* obs,
                                         const void* valid, void* level,
                                         int m, int kind, void* stream) {
  if (m < 0 || (kind != nrslam::kPinhole && kind != nrslam::kKB8))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(cam);
  const float* sp = static_cast<const float*>(st);
  const float* x = static_cast<const float*>(X);
  const float* o = static_cast<const float*>(obs);
  const unsigned char* v = static_cast<const unsigned char*>(valid);
  unsigned char* l = static_cast<unsigned char*>(level);
  if (kind == nrslam::kKB8)
    nrslam::relevel_kernel<nrslam::kKB8>
        <<<1, nrslam::kThreads, 0, s>>>(c, sp, x, o, v, l, m);
  else
    nrslam::relevel_kernel<nrslam::kPinhole>
        <<<1, nrslam::kThreads, 0, s>>>(c, sp, x, o, v, l, m);
  return static_cast<int>(cudaGetLastError());
}
