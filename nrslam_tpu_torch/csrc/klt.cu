// Pyramidal Lucas-Kanade tracking of every point in one launch: all pyramid
// levels from coarse to fine, every iteration, and the final SSIM gate.
//
// Replaces no Pallas kernel: the JAX package's KLT (nrslam_tpu/ops/klt.py::
// track) is plain XLA ops. It replaces the port's plain-op KLT
// (nrslam_tpu_torch/ops/klt.py::track_plain, kept as the CPU path and as
// this kernel's oracle), whose ~130 device kernels a level-iteration made
// ~9,700 nodes of a replayed frame's graph, ~4,000 more for point reuse's
// 2-level call, and ~6,500 eager launches in every init frame. The
// semantics are track_plain's, operation for operation: ival units, the
// gain / bias model (alpha, beta), the 48-pixel tile a point's window may
// move in (anchored at the level's start), border_gap, the min-eigenvalue
// and det < FLT_MIN test, the post-step bounds, the 10 px drift clamp, the
// oscillation back-off, epsilon, status codes written at level 0 only,
// use_initial_flow, then the SSIM gate. Every elementwise step rounds where
// the plain path's separate ops round (no contraction into FMA), and a
// division by a constant is a product with its float reciprocal, as
// PyTorch's CUDA division by a Python scalar computes it; only the order of
// the window sums differs.
//
// What bounds it on an H100: latency. Per point, level and iteration the
// work is one 22x22 window of image and gradient (5.8 KB, from L1 / L2:
// the whole 320x240 pyramid is ~1.2 MB), 441 bilinear samples of three
// channels and seven window sums, ~18 kFLOP; the reference windows (5.3 KB
// a point and level) are read once. At P = 384, 5 levels and <= 10
// iterations that is <= 0.35 GFLOP and ~10 MB, a few us at the card's
// float32 and memory peaks; at the init's F = 4,000, ~3.5 GFLOP and ~106 MB,
// ~50 us. But every iteration needs the one before it (window -> sums ->
// 2x2 solve -> next window), and at P = 384 there are ~3 points an SM, so
// nothing hides that chain. The design keeps the chain short and inside one
// warp:
//
// - One warp a point, for all levels; two points a block, so P = 384 spreads
//   over every SM. The lanes stride the 21x21 window (lane + 32 s, 14
//   slots a lane).
// - The level's reference window and gradient stay in registers for the
//   level; the current 22x22 integer window of image and gradient is staged
//   into the warp's shared memory (clamped to the border, one coalesced pass)
//   and each lane interpolates its slots from there.
// - The seven sums (mean_j, mean_j2, then b1, b2, a11, a12, a22) are each a
//   lane's slots in order, then a butterfly of warp shuffles: every lane
//   ends with the same bits, so the 2x2 solve, the tests and the status
//   logic run warp-uniform with no barrier and no broadcast, and two
//   launches give the same bits.
// - A point leaves a level as soon as it is done (converged, oscillating,
//   drifted, out of bounds or degenerate); the plain path runs every trip
//   masked. Nothing is written after done, so the result is the same. The
//   LK iterations each point ran, over all levels, go to iters_out.
// - The level table is a __grid_constant__ parameter (no local copy when
//   indexed at run time); the kernel allocates nothing and does not
//   synchronise, so it is captured as one node of a CUDA graph.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace nrslam {
namespace {

constexpr int kWin = 21;
constexpr int kArea = kWin * kWin;            // 441
constexpr int kWin1 = kWin + 1;               // integer window side
constexpr int kWin1Area = kWin1 * kWin1;      // 484
constexpr int kSlots = (kArea + 31) / 32;     // window slots a lane
constexpr int kStage = (kWin1Area + 31) / 32;  // staged pixels a lane
constexpr int kTile = 48;                     // the JAX tracker's tile
constexpr int kMargin = (kTile - kWin1) / 2;  // 13
constexpr int kMaxShift = kTile - kWin - 1;   // 26
constexpr int kGap = 11;                      // round(21 / 2) + 1
constexpr float kHalf = 10.0f;                // (win - 1) / 2
constexpr int kMaxLevels = 8;
constexpr int kWarps = 2;                     // points a block
constexpr unsigned kFull = 0xffffffffu;

constexpr float kFltScale = 1.0f / 1048576.0f;  // FLT_SCALE = 2^-20
constexpr float kIval = 32.0f;                  // IVAL_SCALE
constexpr float kInvArea = 1.0f / 441.0f;       // "/ area"
constexpr float kInvTwoArea = 1.0f / 882.0f;    // "/ (2.0 * area)"
constexpr float kNInv = static_cast<float>(1.0 / 441.0);    // n_inv
constexpr float kNInv1 = static_cast<float>(1.0 / 440.0);   // n_inv_1
constexpr float kC1 = static_cast<float>((0.01 * 255.0) * (0.01 * 255.0));
constexpr float kC2 = static_cast<float>((0.03 * 255.0) * (0.03 * 255.0));

// LandmarkStatus codes (ops/klt.py).
constexpr int kJustTriangulated = 2;  // usable: status <= this
constexpr int kBad = 3;
constexpr int kOutOfImage = 4;
constexpr int kBadFeature = 5;

}  // namespace

// One pyramid level: image [h, w] and Scharr gradients [h, w, 2], both
// contiguous float32 (the gradients 8-byte aligned).
struct KltLevel {
  const float* img;
  const float* grad;
  int h, w;
};

// One launch (mirrored field for field by ops/klt_cuda.py::Params). The
// reference fields are KLTRefs read through their strides (in elements; a
// point's 21x21 window, and its gradient's 21x21x2, contiguous), so a
// level_slice view is read where it lies.
struct KltParams {
  KltLevel level[kMaxLevels];
  const float* ref_points;          // [P, 2] (x, y) contiguous in a row
  const float* patch;               // [P, L', 21, 21]
  const float* patch_grad;          // [P, L', 21, 21, 2]
  const float* mean_i;              // [P, L']
  const float* mean_i2;             // [P, L']
  const unsigned char* valid;       // [P, L'] bool
  const float* seeds;               // [P, 2] contiguous
  const int* status_in;             // [P]
  float* pts_out;                   // [P, 2]
  int* status_out;                  // [P]
  int* iters_out;                   // [P] LK iterations, summed over levels
  long long patch_sp, patch_sl;     // patch strides: point, level
  long long grad_sp, grad_sl;       // patch_grad strides: point, level
  int ref_points_sp;
  int mean_i_sp, mean_i_sl, mean_i2_sp, mean_i2_sl;
  int valid_sp, valid_sl;
  int n_levels, P, max_iters, use_initial_flow;
  float epsilon, min_eig_threshold, min_ssim;
};

namespace {

// The warp's staged integer window: gradient first for its alignment.
struct Window {
  float2 grad[kWin1Area];
  float img[kWin1Area];
};

// Sums of N values over the warp: a butterfly of shuffles in a fixed
// order; IEEE addition commutes, so every lane ends with the same bits.
template <int N>
__device__ __forceinline__ void warp_sums(float (&v)[N]) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
#pragma unroll
    for (int k = 0; k < N; ++k)
      v[k] = __fadd_rn(v[k], __shfl_xor_sync(kFull, v[k], m));
  }
}

// ((w00 a + w01 b) + w10 c) + w11 d, each product and sum rounded, as
// ops/klt.py::_bilinear_from_int evaluates it.
__device__ __forceinline__ float bilerp(const float (&w)[4], float a, float b,
                                        float c, float d) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(w[0], a), __fmul_rn(w[1], b)),
                             __fmul_rn(w[2], c)),
                   __fmul_rn(w[3], d));
}

__device__ __forceinline__ void weights(float fx, float fy, float (&w)[4]) {
  const float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, fy);
  w[0] = __fmul_rn(gx, gy);
  w[1] = __fmul_rn(fx, gy);
  w[2] = __fmul_rn(gx, fy);
  w[3] = __fmul_rn(fx, fy);
}

// Window index of slot s of this lane (r * 22 + c for k = r * 21 + c).
__device__ __forceinline__ int slot_at(int lane, int s) {
  const int k = lane + 32 * s;
  return k + k / kWin;
}

__device__ __forceinline__ bool slot_live(int lane, int s) {
  return lane + 32 * s < kArea;
}

// Stage the 22x22 integer window at (x0, y0), rows and columns clamped to
// the level's border, into the warp's shared window.
__device__ __forceinline__ void stage(Window& win, const KltLevel& lv, int x0,
                                      int y0, int lane, bool with_grad) {
  __syncwarp();  // every lane is done reading the previous window
  const float2* grad = reinterpret_cast<const float2*>(lv.grad);
#pragma unroll
  for (int t = 0; t < kStage; ++t) {
    const int idx = lane + 32 * t;
    if (idx < kWin1Area) {
      const int r = idx / kWin1, c = idx - r * kWin1;
      const int y = min(max(y0 + r, 0), lv.h - 1);
      const int x = min(max(x0 + c, 0), lv.w - 1);
      const int at = y * lv.w + x;
      win.img[idx] = __ldg(lv.img + at);
      if (with_grad) win.grad[idx] = __ldg(grad + at);
    }
  }
  __syncwarp();
}

__device__ __forceinline__ bool inside(float bx, float by, int w, int h,
                                       int far) {
  return bx >= -static_cast<float>(kGap) &&
         bx < static_cast<float>(w - far) &&
         by >= -static_cast<float>(kGap) && by < static_cast<float>(h - far);
}

__global__ void __launch_bounds__(32 * kWarps)
    klt_kernel(const __grid_constant__ KltParams p) {
  __shared__ Window windows[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + warp;
  if (i >= p.P) return;  // the whole warp
  Window& win = windows[warp];

  const float rpx = p.ref_points[static_cast<long long>(i) * p.ref_points_sp];
  const float rpy =
      p.ref_points[static_cast<long long>(i) * p.ref_points_sp + 1];
  float px = p.use_initial_flow ? p.seeds[2 * i] : rpx;
  float py = p.use_initial_flow ? p.seeds[2 * i + 1] : rpy;
  int status = p.status_in[i];
  int iters = 0;
  {
    const float top = 1.0f / static_cast<float>(1 << (p.n_levels - 1));
    px = __fmul_rn(px, top);
    py = __fmul_rn(py, top);
  }

  for (int l = p.n_levels - 1; l >= 0; --l) {
    const KltLevel& lv = p.level[l];
    const float scale = 1.0f / static_cast<float>(1 << l);
    const bool prev_in =
        inside(floorf(__fsub_rn(__fmul_rn(rpx, scale), kHalf)),
               floorf(__fsub_rn(__fmul_rn(rpy, scale), kHalf)), lv.w, lv.h,
               kGap);
    const bool ref_ok = p.valid[i * p.valid_sp + l * p.valid_sl] != 0;
    const bool usable = status <= kJustTriangulated;
    if (l == 0 && usable && !(prev_in && ref_ok)) status = kOutOfImage;

    if (usable && prev_in && ref_ok) {
      const float* rp = p.patch + i * p.patch_sp + l * p.patch_sl;
      const float2* rg = reinterpret_cast<const float2*>(
          p.patch_grad + i * p.grad_sp + l * p.grad_sl);
      float ref[kSlots], rgx[kSlots], rgy[kSlots];
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int k = lane + 32 * s;
        if (slot_live(lane, s)) {
          ref[s] = __ldg(rp + k);
          const float2 g = __ldg(rg + k);
          rgx[s] = g.x;
          rgy[s] = g.y;
        } else {
          ref[s] = rgx[s] = rgy[s] = 0.0f;
        }
      }
      const float mean_i = p.mean_i[i * p.mean_i_sp + l * p.mean_i_sl];
      const float mean_i2 = p.mean_i2[i * p.mean_i2_sp + l * p.mean_i2_sl];

      const float sx = px, sy = py;  // the level's start
      const float tile_x = floorf(__fsub_rn(sx, kHalf));
      const float tile_y = floorf(__fsub_rn(sy, kHalf));
      float pdx = 0.0f, pdy = 0.0f;  // the previous step
      for (int j = 0; j < p.max_iters; ++j) {
        ++iters;
        const float bx = floorf(__fsub_rn(px, kHalf));
        const float by = floorf(__fsub_rn(py, kHalf));
        if (!inside(bx, by, lv.w, lv.h, kGap)) {
          if (l == 0) status = kOutOfImage;
          break;
        }
        // In bounds now and at the start (j = 0 tested it), so the
        // conversions below are of small integers.
        const int tx = static_cast<int>(tile_x) - kMargin;
        const int ty = static_cast<int>(tile_y) - kMargin;
        const int x0 = tx + min(max(static_cast<int>(bx) - tx, 0), kMaxShift);
        const int y0 = ty + min(max(static_cast<int>(by) - ty, 0), kMaxShift);
        stage(win, lv, x0, y0, lane, true);
        float w4[4];
        weights(__fsub_rn(__fsub_rn(px, kHalf), bx),
                __fsub_rn(__fsub_rn(py, kHalf), by), w4);

        float jw[kSlots], gx[kSlots], gy[kSlots];
        float m[2] = {0.0f, 0.0f};
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          jw[s] = gx[s] = gy[s] = 0.0f;
          if (slot_live(lane, s)) {
            const int o = slot_at(lane, s);
            jw[s] = __fmul_rn(bilerp(w4, win.img[o], win.img[o + 1],
                                     win.img[o + kWin1],
                                     win.img[o + kWin1 + 1]),
                              kIval);
            const float2 g00 = win.grad[o], g01 = win.grad[o + 1];
            const float2 g10 = win.grad[o + kWin1];
            const float2 g11 = win.grad[o + kWin1 + 1];
            gx[s] = bilerp(w4, g00.x, g01.x, g10.x, g11.x);
            gy[s] = bilerp(w4, g00.y, g01.y, g10.y, g11.y);
            m[0] = __fadd_rn(m[0], jw[s]);
            m[1] = __fadd_rn(m[1], __fmul_rn(jw[s], jw[s]));
          }
        }
        warp_sums(m);
        const float mean_j = __fmul_rn(__fmul_rn(m[0], kFltScale), kInvArea);
        const float mean_j2 = __fmul_rn(__fmul_rn(m[1], kFltScale), kInvArea);
        const float alpha = __fsqrt_rn(
            __fdiv_rn(mean_i2, mean_j2 < 1e-20f ? 1e-20f : mean_j2));
        const float beta = __fsub_rn(mean_i, __fmul_rn(alpha, mean_j));

        float t[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // b1 b2 a11 a12 a22
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          if (slot_live(lane, s)) {
            const float diff =
                __fsub_rn(__fsub_rn(__fmul_rn(jw[s], alpha), ref[s]), beta);
            const float dx = __fadd_rn(rgx[s], __fmul_rn(gx[s], alpha));
            const float dy = __fadd_rn(rgy[s], __fmul_rn(gy[s], alpha));
            t[0] = __fadd_rn(t[0], __fmul_rn(diff, dx));
            t[1] = __fadd_rn(t[1], __fmul_rn(diff, dy));
            t[2] = __fadd_rn(t[2], __fmul_rn(dx, dx));
            t[3] = __fadd_rn(t[3], __fmul_rn(dx, dy));
            t[4] = __fadd_rn(t[4], __fmul_rn(dy, dy));
          }
        }
        warp_sums(t);
        const float b1 = __fmul_rn(t[0], kFltScale);
        const float b2 = __fmul_rn(t[1], kFltScale);
        const float a11 = __fmul_rn(t[2], kFltScale);
        const float a12 = __fmul_rn(t[3], kFltScale);
        const float a22 = __fmul_rn(t[4], kFltScale);

        const float det = __fsub_rn(__fmul_rn(a11, a22), __fmul_rn(a12, a12));
        const float d = __fsub_rn(a11, a22);
        const float root = __fsqrt_rn(__fadd_rn(
            __fmul_rn(d, d), __fmul_rn(__fmul_rn(4.0f, a12), a12)));
        const float min_eig =
            __fmul_rn(__fsub_rn(__fadd_rn(a22, a11), root), kInvTwoArea);
        if (min_eig < p.min_eig_threshold || det < FLT_MIN) {
          if (l == 0) status = kBadFeature;
          break;
        }
        const float safe_det = fabsf(det) > 0.0f ? det : 1.0f;
        const float ddx = __fdiv_rn(
            __fsub_rn(__fmul_rn(a12, b2), __fmul_rn(a22, b1)), safe_det);
        const float ddy = __fdiv_rn(
            __fsub_rn(__fmul_rn(a12, b1), __fmul_rn(a11, b2)), safe_det);
        float nx = __fadd_rn(px, ddx), ny = __fadd_rn(py, ddy);

        bool stop;
        if (nx < static_cast<float>(kGap + 1) ||
            nx >= static_cast<float>(lv.w - 1 - kGap) ||
            ny < static_cast<float>(kGap + 1) ||
            ny >= static_cast<float>(lv.h - 1 - kGap)) {
          if (l == 0) status = kOutOfImage;
          stop = true;
        } else {
          const float ex = __fsub_rn(nx, sx), ey = __fsub_rn(ny, sy);
          const float drift =
              __fsqrt_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)));
          if (drift > 10.0f) {
            if (l == 0) status = kBad;
            nx = sx;
            ny = sy;
            stop = true;
          } else {
            const bool converged =
                __fadd_rn(__fmul_rn(ddx, ddx), __fmul_rn(ddy, ddy)) <=
                p.epsilon;
            const bool oscillating = j > 0 &&
                                     fabsf(__fadd_rn(ddx, pdx)) < 0.01f &&
                                     fabsf(__fadd_rn(ddy, pdy)) < 0.01f;
            if (oscillating && !converged) {
              nx = __fsub_rn(nx, __fmul_rn(ddx, 0.5f));
              ny = __fsub_rn(ny, __fmul_rn(ddy, 0.5f));
            }
            stop = converged || oscillating;
          }
        }
        px = nx;
        py = ny;
        pdx = ddx;
        pdy = ddy;
        if (stop) break;
      }
    }
    if (l > 0) {
      px = __fmul_rn(px, 2.0f);
      py = __fmul_rn(py, 2.0f);
    }
  }

  // The SSIM gate against the level-0 reference window.
  if (status <= kJustTriangulated) {
    const KltLevel& lv = p.level[0];
    const float bx = floorf(__fsub_rn(px, kHalf));
    const float by = floorf(__fsub_rn(py, kHalf));
    if (isnan(px) || isnan(py) || !inside(bx, by, lv.w, lv.h, 2 * kGap)) {
      status = kOutOfImage;
    } else {
      stage(win, lv, static_cast<int>(bx), static_cast<int>(by), lane, false);
      float w4[4];
      weights(__fsub_rn(__fsub_rn(px, kHalf), bx),
              __fsub_rn(__fsub_rn(py, kHalf), by), w4);
      const float* rp = p.patch + i * p.patch_sp;
      // cur = (32 x sample) / 32 and ref = patch / 32: both exact.
      float ref[kSlots], cur[kSlots];
      float mu[2] = {0.0f, 0.0f};
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        ref[s] = cur[s] = 0.0f;
        if (slot_live(lane, s)) {
          const int o = slot_at(lane, s);
          ref[s] = __fmul_rn(__ldg(rp + lane + 32 * s), 1.0f / kIval);
          cur[s] = bilerp(w4, win.img[o], win.img[o + 1], win.img[o + kWin1],
                          win.img[o + kWin1 + 1]);
          mu[0] = __fadd_rn(mu[0], ref[s]);
          mu[1] = __fadd_rn(mu[1], cur[s]);
        }
      }
      warp_sums(mu);
      const float mu_x = __fmul_rn(mu[0], kNInv);
      const float mu_y = __fmul_rn(mu[1], kNInv);
      float v[3] = {0.0f, 0.0f, 0.0f};  // xn xn, yn yn, xn yn
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        if (slot_live(lane, s)) {
          const float xn = __fsub_rn(ref[s], mu_x);
          const float yn = __fsub_rn(cur[s], mu_y);
          v[0] = __fadd_rn(v[0], __fmul_rn(xn, xn));
          v[1] = __fadd_rn(v[1], __fmul_rn(yn, yn));
          v[2] = __fadd_rn(v[2], __fmul_rn(xn, yn));
        }
      }
      warp_sums(v);
      const float sx2 = __fmul_rn(v[0], kNInv1);
      const float sy2 = __fmul_rn(v[1], kNInv1);
      const float sxy = __fmul_rn(v[2], kNInv1);
      const float num =
          __fmul_rn(__fadd_rn(__fmul_rn(__fmul_rn(2.0f, mu_x), mu_y), kC1),
                    __fadd_rn(__fmul_rn(2.0f, sxy), kC2));
      const float den = __fmul_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(mu_x, mu_x), __fmul_rn(mu_y, mu_y)),
                    kC1),
          __fadd_rn(__fadd_rn(sx2, sy2), kC2));
      if (__fdiv_rn(num, den) < p.min_ssim) status = kBadFeature;
    }
  }

  if (lane == 0) {
    p.pts_out[2 * i] = px;
    p.pts_out[2 * i + 1] = py;
    p.status_out[i] = status;
    p.iters_out[i] = iters;
  }
}

}  // namespace
}  // namespace nrslam

// (sizeof(KltParams), most levels, window side, points a block): the
// wrapper checks its mirror of the parameters against the first.
extern "C" int nrslam_klt_layout(int* out) {
  out[0] = static_cast<int>(sizeof(nrslam::KltParams));
  out[1] = nrslam::kMaxLevels;
  out[2] = nrslam::kWin;
  out[3] = nrslam::kWarps;
  return 0;
}

// C entry point: *params (host memory, copied into the launch) names device
// pointers only. Returns cudaErrorInvalidValue for sizes the kernel cannot
// run, else cudaGetLastError() after the launch.
extern "C" int nrslam_klt(const void* params, void* stream) {
  const nrslam::KltParams& p = *static_cast<const nrslam::KltParams*>(params);
  if (p.P <= 0 || p.n_levels < 1 || p.n_levels > nrslam::kMaxLevels ||
      p.max_iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (p.P + nrslam::kWarps - 1) / nrslam::kWarps;
  nrslam::klt_kernel<<<blocks, 32 * nrslam::kWarps, 0,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
