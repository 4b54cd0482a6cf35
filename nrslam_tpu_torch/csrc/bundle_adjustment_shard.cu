// Local deformable BA partitioned over the ranks' point blocks: phase
// kernels whose partial sums are all-reduced between launches.
//
// Partitions: nrslam_tpu/solver/bundle_adjustment_pallas.py::_ba_kernel
// (the whole-solver kernel is csrc/bundle_adjustment.cu). Same schedule and
// terms as the plain partitioned driver (parallel/ba_points.py) and the
// whole-solver kernel: W keyframe SE(3) twists + one landmark copy per
// (keyframe, point); reprojection (info 4, Huber 5.99) per observed copy,
// unrobust springs 1.1 (|L_i - L_j| - d0) / d0 (info 100) per (keyframe,
// pair) and 4-ary temporal dampers w ((L'_i - L_i) - (L'_j - L_j)) (info_s,
// Huber 0.584) per (consecutive keyframe pair, pair); n_iters LM steps, each
// a cg_iters block-Jacobi PCG (6x6 pose blocks, 3x3 landmark blocks,
// tolerance 1e-8), no re-levelling.
//
// A rank owns all W copies of the points [p0, p0 + m) and their edge-ends:
// positions [inc_ptr[p0], inc_ptr[p0 + m]) of the whole incidence CSR over
// the edges some keyframe's spring uses. The dampers couple copies (k, p)
// and (k + 1, p), so they stay with the point's owner. An edge's terms are
// computed at each end a rank owns, in the edge's (i, j) orientation, so
// the two ranks of an edge that crosses ranks agree bit for bit; an edge's
// chi2 is counted at its i end.
//
// Every launch is one block that does the work between two all_reduces
// (the host, bundle_adjustment_cuda.shard, enqueues them and the
// collectives on one stream). What every rank must hold the same (the W
// poses, the pose systems, chi2, lambda, nu, the CG scalars and the pose
// part of every CG vector) is computed from the reduced sums into the device
// row `st`, with the same bits on every rank. Per owned copy: the current
// and the trial linearisation (lin[cur], lin[1 - cur]), the block-Jacobi
// inverses and the CG vectors; per owned edge-end and keyframe its spring
// direction and weight and its damper weight to the next keyframe (es[cur],
// es[1 - cur]); the copies (accepted and trial) and the search direction p
// are whole, [P][W][3] point-major, on every rank. The accept of an LM step
// flips `cur` in st, so nothing is copied and nothing is read back to the
// host.
//
// Sums go by chunk of kChunk consecutive global points: a warp owns a chunk
// (a lane its points h + lane, h = 0, 32), sums it in a fixed order
// (common.cuh warp_reduce_scatter32) into the chunk's row of a buffer that
// is zero outside the rank's chunks, the all_reduce adds the ranks' rows,
// and the next phase adds the rows in chunk order. So two calls give the
// same bits, and where the ranks' blocks are whole chunks n ranks give the
// bits of one process.
//
// Collectives: `red` [3 W P + 2 nc] carries this rank's rows of a [P][W][3]
// vector (z, or the trial copies) zero-filled elsewhere, then two sums a
// chunk (r.z, r.r; or one: the gain ratio's landmark partial); `reds`
// [S nc + n], S = 28 W + 1, the pose systems' sums a chunk (per keyframe 21
// of the upper 6x6, 6 of g and its reprojection chi2, then the edge chi2;
// at the start each rank's largest landmark-block diagonal at its slot, for
// lambda0), or the 6 W + 1 sums a chunk of a Hessian-vector product (the
// pose part per keyframe, then p.Hp). Per LM step: start the PCG (red), per
// CG trip hv (reds) and cg (red), the trial linearisation (reds).

#include "common.cuh"

namespace nrslam {
namespace {

constexpr int kThreads = 256;
constexpr int kMaxW = 8;
constexpr float kTh2Dof = 5.99f;
constexpr float kTh3Dof = 0.584f;
constexpr float kInfoR = 4.0f;    // 1 / 0.5^2
constexpr float kInfoP = 100.0f;  // 1 / 0.1^2
constexpr float kSpringK = 1.1f;
constexpr float kLmTau = 1e-5f;
constexpr float kCgTol = 1e-8f;
constexpr int kChunk = 64;        // points a chunk's partial sums cover
// Per copy: pose Jacobian rows u, v (12), landmark Jacobian rows u, v (6),
// IRLS weight, landmark gradient (3), landmark block (00 01 02 11 12 22),
// residual u, v, robust chi2.
constexpr int kLin = 31;
constexpr int lJp = 0, lJl = 12, lWr = 18, lGl = 19, lD = 22, lE = 28,
              lRho = 30;
constexpr int kEnd = 5;           // per (edge-end, keyframe): a (3), w_p, wd2

enum Mode { kStart = 0, kTrial = 1 };
enum Next { kNextCg = 0, kNextFinal = 1 };

// The device row st (floats; a pose is q [4], t [3]).
enum : int {
  sT = 0,                   // [kMaxW][7] accepted poses
  sTn = sT + 7 * kMaxW,     // [kMaxW][7] trial poses
  sH = sTn + 7 * kMaxW,     // [kMaxW][36] pose blocks of lin[cur]
  sG = sH + 36 * kMaxW,     // [kMaxW][6]
  sHinv = sG + 6 * kMaxW,   // [kMaxW][36] (H_k + lam I)^-1
  sXp = sHinv + 36 * kMaxW, // [kMaxW][6] each: CG vectors of the poses
  sRp = sXp + 6 * kMaxW,
  sZp = sRp + 6 * kMaxW,
  sPp = sZp + 6 * kMaxW,
  sChi2 = sPp + 6 * kMaxW,
  sLam, sNu, sCur, sInfoS, sRz, sB2, sCgDone,
  sDenomL,                  // the trial step's landmark partial, reduced
  sWork,                    // LM steps, CG trips, linearisations (counts)
  sFloats = sWork + 4
};

struct Ctx {
  const float* cam;       // [8]
  int kind;
  const float* L0;        // [P][W][3] the window's copies, whole
  const float* obs;       // [m][W][2] the rank's observations
  const float* omask;     // [P][W] observed copies
  const int* ei;          // [E]
  const int* ej;
  const float* ew;        // RBF weight
  const float* ed0;       // rest distance, clamped >= 1e-12
  const int* emask;       // [E] spring bit k, damper (k, k + 1) bit 8 + k
  const int* inc_ptr;     // [P + 1]
  const int* inc_edge;    // [n_ends]
  const float* inc_sign;  // [n_ends]
  float* st;              // [sFloats]
  float* lin[2];          // [m][W][kLin]
  float* es[2];           // [n_ends][W][kEnd], at the rank's CSR positions
  float* minv;            // [m][W][9]
  float* x;               // [m][W][3] CG vectors of the rank's copies
  float* r;
  float* hp;
  float* L[2];            // [P][W][3] accepted and trial copies
  float* p;               // [P][W][3] search direction
  float* red;             // [3 W P + 2 nc]
  float* reds;            // [S nc + n]
  float* out_pose;        // [W][8]
  float* out_L;           // [P][W][3]
  int W, P, m, p0, rank, n, S;
  int nc, g0, g1;         // chunks of P; the rank's first and last chunk
};

__device__ inline int cur_of(const Ctx& c) {
  return c.st[sCur] != 0.0f ? 1 : 0;
}

// red[0, 3 W P) zero outside this rank's rows, which the caller writes.
__device__ inline void zero_others(const Ctx& c) {
  const long w = 3L * c.W;
  const long a = w * c.p0, b = w * (c.p0 + c.m);
  for (long k = threadIdx.x; k < w * c.P; k += blockDim.x)
    if (k < a || k >= b) c.red[k] = 0.0f;
}

// Rows [nc][S] of partial sums: zero outside the rank's chunks [g0, g1],
// which the warps write.
__device__ inline void zero_rows(const Ctx& c, float* rows, int S) {
  for (int k = threadIdx.x; k < c.nc * S; k += blockDim.x)
    if (k / S < c.g0 || k / S > c.g1) rows[k] = 0.0f;
}

// A warp's acc summed over its lanes in a fixed order; lanes < count write
// their sum to out[lane] (the warp must be converged).
__device__ inline void store_part(float (&acc)[32], float* out, int count) {
  warp_reduce_scatter32(acc);
  const int lane = threadIdx.x & 31;
  if (lane < count) out[lane] = acc[0];
}

// Column k of rows [nc][S] summed in chunk order.
__device__ inline float chunk_sum(const Ctx& c, const float* rows, int S,
                                  int k) {
  float s = 0.0f;
  for (int g = 0; g < c.nc; ++g) s += rows[g * S + k];
  return s;
}

// The first `count` column sums of rows [nc][S] into sh, one thread a
// column; the caller syncs before reading them.
__device__ inline void column_sums(const Ctx& c, const float* rows, int S,
                                   int count, float* sh) {
  for (int k = threadIdx.x; k < count; k += blockDim.x)
    sh[k] = chunk_sum(c, rows, S, k);
}

__device__ inline void apply3(const float* M, const float* v, float* o) {
  for (int i = 0; i < 3; ++i)
    o[i] = M[3 * i] * v[0] + M[3 * i + 1] * v[1] + M[3 * i + 2] * v[2];
}

__device__ inline float block_max(float v, float* sh) {
  for (int s = 16; s > 0; s >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, s));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  float out = sh[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) out = fmaxf(out, sh[w]);
  return out;
}

// The warp-per-chunk walk of a phase: warp w takes chunks g0 + w, g0 + w +
// warps, ...; its lane takes the rank's points g kChunk + h + lane.
#define FOR_CHUNKS(c, g)                                                   \
  for (int g = (c).g0 + (threadIdx.x >> 5); g <= (c).g1;                   \
       g += blockDim.x >> 5)
#define LOCAL_POINT(c, g, h) ((g) * kChunk + (h) + (threadIdx.x & 31) - (c).p0)

// One point's terms (local index lp) at the poses (Rm [W][9], t [W][3])
// and whole copies L: its edge-ends' springs at every keyframe and dampers
// between consecutive keyframes into es `E`, then each copy's reprojection,
// landmark gradient and block into lin `Lo`. Returns the point's edge chi2
// (the edges it is the i end of).
__device__ float lin_point(const Ctx& c, int lp, const float (*Rm)[9],
                           const float (*t)[3], const float* L, float* Lo,
                           float* E) {
  const int W = c.W, p = c.p0 + lp;
  const float info_s = c.st[sInfoS];
  float gs[kMaxW][3], ds[kMaxW][6], chi2_e = 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxW; ++k) {
    for (int d = 0; d < 3; ++d) gs[k][d] = 0.0f;
    for (int d = 0; d < 6; ++d) ds[k][d] = 0.0f;
  }
  for (int kk = c.inc_ptr[p]; kk < c.inc_ptr[p + 1]; ++kk) {
    const int e = c.inc_edge[kk];
    const float sg = c.inc_sign[kk] > 0.0f ? 1.0f : -1.0f;
    const int i = c.ei[e], j = c.ej[e], bits = c.emask[e];
    const float w = c.ew[e], d0 = c.ed0[e], kd = kSpringK / d0;
    float dl[kMaxW][3], dd[kMaxW][3], wd2[kMaxW];
#pragma unroll
    for (int k = 0; k < kMaxW; ++k) {
      wd2[k] = 0.0f;
      for (int d = 0; d < 3; ++d) dl[k][d] = dd[k][d] = 0.0f;
      if (k < W && ((bits >> k) & 1)) {
        const float* Li = L + 3L * (static_cast<long>(i) * W + k);
        const float* Lj = L + 3L * (static_cast<long>(j) * W + k);
        for (int d = 0; d < 3; ++d) dl[k][d] = Li[d] - Lj[d];
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxW - 1; ++k) {
      if (k + 1 < W && ((bits >> (8 + k)) & 1)) {
        for (int d = 0; d < 3; ++d) dd[k][d] = dl[k + 1][d] - dl[k][d];
        const float chi2_d = info_s * (w * w) *
            (dd[k][0] * dd[k][0] + dd[k][1] * dd[k][1] + dd[k][2] * dd[k][2]);
        if (sg > 0.0f) chi2_e += huber_rho(chi2_d, kTh3Dof);
        wd2[k] = info_s * huber_w(chi2_d, kTh3Dof) * (w * w);
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxW; ++k) {
      if (k < W) {
        float a[3] = {0.0f, 0.0f, 0.0f}, g[3] = {0.0f, 0.0f, 0.0f}, wp = 0.0f;
        if ((bits >> k) & 1) {
          const float dist = sqrtf(dl[k][0] * dl[k][0] + dl[k][1] * dl[k][1] +
                                   dl[k][2] * dl[k][2]);
          const float e_p = kSpringK * (dist - d0) / d0;
          if (sg > 0.0f) chi2_e += kInfoP * e_p * e_p;
          const float inv_dist = 1.0f / fmaxf(dist, 1e-12f);
          wp = kInfoP;
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
        float* ek = E + kEnd * (static_cast<long>(kk) * W + k);
        ek[0] = a[0]; ek[1] = a[1]; ek[2] = a[2]; ek[3] = wp; ek[4] = wd2[k];
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kMaxW; ++k) {
    if (k >= W) continue;
    float* l = Lo + kLin * (static_cast<long>(lp) * W + k);
    const long gc = static_cast<long>(p) * W + k;
    float Ju[6], Jv[6], Jlu[3], Jlv[3], w_r = 0.0f, eu = 0.0f, ev = 0.0f,
        rho = 0.0f;
    if (c.omask[gc] != 0.0f) {
      const float* X = L + 3 * gc;
      const float* R9 = Rm[k];
      const float xc = R9[0] * X[0] + R9[1] * X[1] + R9[2] * X[2] + t[k][0];
      const float yc = R9[3] * X[0] + R9[4] * X[1] + R9[5] * X[2] + t[k][1];
      const float zc = R9[6] * X[0] + R9[7] * X[1] + R9[8] * X[2] + t[k][2];
      float pu, pv, J[6];
      project_with_jacobian(c.kind, c.cam, xc, yc, zc, &pu, &pv, J);
      const float* o = c.obs + 2L * (static_cast<long>(lp) * W + k);
      eu = o[0] - pu;
      ev = o[1] - pv;
      const float chi2_r = kInfoR * (eu * eu + ev * ev);
      w_r = kInfoR * huber_w(chi2_r, kTh2Dof);
      rho = huber_rho(chi2_r, kTh2Dof);
      pose_jacobian(J, xc, yc, zc, Ju, Jv);
      for (int d = 0; d < 3; ++d) {
        Jlu[d] = -(J[0] * R9[d] + J[1] * R9[3 + d] + J[2] * R9[6 + d]);
        Jlv[d] = -(J[3] * R9[d] + J[4] * R9[3 + d] + J[5] * R9[6 + d]);
      }
    } else {
      for (int d = 0; d < 6; ++d) Ju[d] = Jv[d] = 0.0f;
      for (int d = 0; d < 3; ++d) Jlu[d] = Jlv[d] = 0.0f;
    }
    for (int d = 0; d < 6; ++d) { l[lJp + d] = Ju[d]; l[lJp + 6 + d] = Jv[d]; }
    for (int d = 0; d < 3; ++d) { l[lJl + d] = Jlu[d]; l[lJl + 3 + d] = Jlv[d]; }
    l[lWr] = w_r;
    for (int d = 0; d < 3; ++d)
      l[lGl + d] = w_r * (Jlu[d] * eu + Jlv[d] * ev) + gs[k][d];
    const int ia[6] = {0, 0, 0, 1, 1, 2}, ib[6] = {0, 1, 2, 1, 2, 2};
    for (int d = 0; d < 6; ++d)
      l[lD + d] = w_r * (Jlu[ia[d]] * Jlu[ib[d]] + Jlv[ia[d]] * Jlv[ib[d]])
                  + ds[k][d];
    l[lE] = eu;
    l[lE + 1] = ev;
    l[lRho] = rho;
  }
  return chi2_e;
}

// The rank's terms at the poses in st + pose and the whole copies L (a
// lin_point for each of its points, chunk by chunk), and each chunk's S sums
// into its row of rows [nc][S] (zero outside the rank's chunks): per
// keyframe the 21 upper entries of J^T w J, 6 of J^T w e and the robust
// reprojection chi2, then the edge chi2.
__device__ void linearize(const Ctx& c, const float* pose, const float* L,
                          float* Lo, float* E, float* rows) {
  __shared__ float sR[kMaxW][9], sTr[kMaxW][3];
  const int W = c.W;
  if (threadIdx.x < W) {
    quat_to_matrix(pose + 7 * threadIdx.x, sR[threadIdx.x]);
    for (int d = 0; d < 3; ++d)
      sTr[threadIdx.x][d] = pose[7 * threadIdx.x + 4 + d];
  }
  zero_rows(c, rows, c.S);
  __syncthreads();
  FOR_CHUNKS(c, g) {
    float echi = 0.0f;
    for (int h = 0; h < kChunk; h += 32) {
      const int lp = LOCAL_POINT(c, g, h);
      if (lp >= 0 && lp < c.m) echi += lin_point(c, lp, sR, sTr, L, Lo, E);
    }
    float* row = rows + static_cast<long>(g) * c.S;
    for (int k = 0; k < W; ++k) {
      float acc[32];
      for (int q = 0; q < 32; ++q) acc[q] = 0.0f;
      for (int h = 0; h < kChunk; h += 32) {
        const int lp = LOCAL_POINT(c, g, h);
        if (lp < 0 || lp >= c.m) continue;
        const float* l = Lo + kLin * (static_cast<long>(lp) * W + k);
        const float w = l[lWr], eu = l[lE], ev = l[lE + 1];
        int q = 0;
        for (int a = 0; a < 6; ++a)
          for (int b = a; b < 6; ++b, ++q)
            acc[q] += w * (l[lJp + a] * l[lJp + b]
                           + l[lJp + 6 + a] * l[lJp + 6 + b]);
        for (int a = 0; a < 6; ++a)
          acc[21 + a] += w * (l[lJp + a] * eu + l[lJp + 6 + a] * ev);
        acc[27] += l[lRho];
      }
      store_part(acc, row + 28 * k, 28);
    }
    float acc[32];
    acc[0] = echi;
    for (int q = 1; q < 32; ++q) acc[q] = 0.0f;
    store_part(acc, row + 28 * W, 1);
  }
}

// The call's start: the poses and info_s from params (cam 8, per keyframe
// q 4, t 3, 0; info_s) into st, the window's copies into L[0].
__global__ void __launch_bounds__(kThreads, 1)
init_kernel(Ctx c, const float* __restrict__ params) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int u = tid; u < 7 * c.W; u += nt)
    c.st[sT + u] = params[8 + 8 * (u / 7) + u % 7];
  if (tid == 0) {
    c.st[sInfoS] = params[8 + 8 * c.W];
    c.st[sCur] = 0.0f;
  }
  for (long u = tid; u < 3L * c.W * c.P; u += nt) c.L[0][u] = c.L0[u];
}

// kStart: the first linearisation at the accepted poses and copies into
// lin[cur], its sums by chunk into reds [nc][S] and the rank's largest
// landmark-block diagonal at slot rank of a zero-filled [n] after them.
// kTrial: the trial copies from red (whole, after the trial step's
// collective) into L[1 - cur], the step's landmark partial summed into st,
// then the linearisation at the trial poses into lin[1 - cur] and its sums
// into reds [nc][S].
__global__ void __launch_bounds__(kThreads, 1)
lin_kernel(Ctx c, int mode) {
  __shared__ float smax[kThreads / 32];
  const int cur = cur_of(c), tid = threadIdx.x, nt = blockDim.x;
  const int tgt = mode == kStart ? cur : 1 - cur;
  if (mode == kTrial) {
    for (long u = tid; u < 3L * c.W * c.P; u += nt) c.L[tgt][u] = c.red[u];
    if (tid == 0)
      c.st[sDenomL] = chunk_sum(c, c.red + 3L * c.W * c.P, 1, 0);
    __syncthreads();
  }
  linearize(c, c.st + (mode == kStart ? sT : sTn), c.L[tgt], c.lin[tgt],
            c.es[tgt], c.reds);
  if (tid == 0) c.st[sWork + 2] += 1.0f;
  if (mode == kStart) {
    __syncthreads();  // every thread's lin written before the reads below
    float dmax = -INFINITY;
    for (int u = tid; u < c.m * c.W; u += nt) {
      const float* D = c.lin[tgt] + kLin * static_cast<long>(u) + lD;
      dmax = fmaxf(dmax, fmaxf(D[0], fmaxf(D[3], D[5])));
    }
    dmax = block_max(dmax, smax);
    float* slots = c.reds + static_cast<long>(c.S) * c.nc;
    for (int r = tid; r < c.n; r += nt) slots[r] = r == c.rank ? dmax : 0.0f;
  }
}

// finish 0: reds holds the first linearisation (kStart): lambda0 from the
// largest diagonal. finish 1: reds holds the trial's: gain ratio, lambda /
// nu, accept (flip cur). Then `next`: start the PCG of the next LM step (z
// of the rank's copies into red, zero elsewhere, with the r.z and r.r
// partials by chunk), or write the outputs.
__global__ void __launch_bounds__(kThreads, 1)
step_kernel(Ctx c, int finish, int next) {
  __shared__ float col[28 * kMaxW + 1];
  const int tid = threadIdx.x, W = c.W;
  float* st = c.st;
  column_sums(c, c.reds, c.S, c.S, col);
  __syncthreads();
  if (tid == 0) {
    float chi2 = col[28 * W];
    for (int k = 0; k < W; ++k) chi2 += col[28 * k + 27];
    float H[kMaxW][36], g[kMaxW][6];
    for (int k = 0; k < W; ++k) {
      int q = 0;
      for (int a = 0; a < 6; ++a)
        for (int b = a; b < 6; ++b, ++q) {
          H[k][a * 6 + b] = col[28 * k + q];
          H[k][b * 6 + a] = col[28 * k + q];
        }
      for (int a = 0; a < 6; ++a) g[k][a] = col[28 * k + 21 + a];
    }
    bool take = true;
    if (finish == 0) {
      float dmax = -INFINITY;
      for (int k = 0; k < W; ++k)
        for (int a = 0; a < 6; ++a) dmax = fmaxf(dmax, H[k][a * 6 + a]);
      const float* slots = c.reds + static_cast<long>(c.S) * c.nc;
      for (int r = 0; r < c.n; ++r) dmax = fmaxf(dmax, slots[r]);
      st[sLam] = kLmTau * dmax;
      st[sNu] = 2.0f;
    } else {
      const float lam = st[sLam], nu = st[sNu];
      float denom = st[sDenomL];
      for (int k = 0; k < W; ++k)
        for (int d = 0; d < 6; ++d) {
          const float xd = st[sXp + 6 * k + d];
          denom += xd * (lam * xd - st[sG + 6 * k + d]);
        }
      const float rho = (st[sChi2] - chi2)
                        / (fabsf(denom) > 0.0f ? denom : 1.0f);
      const bool accepted = rho > 0.0f;
      const float c3 = 2.0f * rho - 1.0f;
      const float shrink = fmaxf(1.0f / 3.0f, 1.0f - c3 * c3 * c3);
      st[sLam] = accepted ? lam * shrink : lam * nu;
      st[sNu] = accepted ? 2.0f : nu * 2.0f;
      st[sWork] += 1.0f;
      take = accepted;
      if (accepted) {
        for (int u = 0; u < 7 * W; ++u) st[sT + u] = st[sTn + u];
        st[sCur] = st[sCur] != 0.0f ? 0.0f : 1.0f;
      }
    }
    if (take) {
      for (int k = 0; k < W; ++k) {
        for (int u = 0; u < 36; ++u) st[sH + 36 * k + u] = H[k][u];
        for (int u = 0; u < 6; ++u) st[sG + 6 * k + u] = g[k][u];
      }
      st[sChi2] = chi2;
    }
  }
  __syncthreads();
  const int cur = cur_of(c);
  if (next == kNextFinal) {
    for (long u = tid; u < 3L * W * c.P; u += blockDim.x)
      c.out_L[u] = c.L[cur][u];
    if (tid < W) {
      const float* q = st + sT + 7 * tid;
      const float nq = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2]
                             + q[3] * q[3]);
      float* o = c.out_pose + 8 * tid;
      for (int d = 0; d < 4; ++d) o[d] = q[d] / nq;
      for (int d = 0; d < 3; ++d) o[4 + d] = q[4 + d];
      o[7] = 0.0f;
    }
    return;
  }

  // Start the PCG: x = 0, r = -g, z = M^-1 r, at the current lambda.
  const float lam = st[sLam];
  if (tid < W) {
    float* Hinv = st + sHinv + 36 * tid;
    inv6(st + sH + 36 * tid, lam, Hinv);
    for (int d = 0; d < 6; ++d) {
      float s = 0.0f;
      for (int j = 0; j < 6; ++j) s += Hinv[d * 6 + j] * (-st[sG + 6 * tid + j]);
      st[sRp + 6 * tid + d] = -st[sG + 6 * tid + d];
      st[sZp + 6 * tid + d] = s;
      st[sXp + 6 * tid + d] = 0.0f;
    }
  }
  const float* Lc = c.lin[cur];
  float* rows = c.red + 3L * W * c.P;
  zero_others(c);
  zero_rows(c, rows, 2);
  FOR_CHUNKS(c, g) {
    float acc[32];
    for (int q = 0; q < 32; ++q) acc[q] = 0.0f;
    for (int h = 0; h < kChunk; h += 32) {
      const int lp = LOCAL_POINT(c, g, h);
      if (lp < 0 || lp >= c.m) continue;
      for (int k = 0; k < W; ++k) {
        const long ci = static_cast<long>(lp) * W + k;
        const float* D = Lc + kLin * ci + lD;
        const float m9[9] = {D[0] + lam, D[1], D[2], D[1], D[3] + lam, D[4],
                             D[2], D[4], D[5] + lam};
        float* mi = c.minv + 9 * ci;
        inv3(m9, mi);
        float r[3], z[3];
        for (int d = 0; d < 3; ++d) {
          r[d] = -Lc[kLin * ci + lGl + d];
          c.x[3 * ci + d] = 0.0f;
          c.r[3 * ci + d] = r[d];
        }
        apply3(mi, r, z);
        for (int d = 0; d < 3; ++d) {
          c.red[3 * (static_cast<long>(c.p0) * W + ci) + d] = z[d];
          acc[0] += r[d] * z[d];
          acc[1] += r[d] * r[d];
        }
      }
    }
    store_part(acc, rows + 2L * g, 2);
  }
}

// One CG trip's first half: from red (z whole and the r.z, r.r partials by
// chunk, reduced) every rank forms p = z + beta p over all P W copies
// (first trip: p = z) and the pose part; then H p of the rank's copies
// (reprojection, and at each of its edge-ends the spring term at the copy's
// keyframe and the dampers to k - 1 and k + 1, + lambda p) and the 6 W + 1
// partials (pose part of H p per keyframe, p.Hp) by chunk into reds.
__global__ void __launch_bounds__(kThreads, 1)
hv_kernel(Ctx c, int first) {
  const int tid = threadIdx.x, nt = blockDim.x, W = c.W;
  float* st = c.st;
  const long n3 = 3L * W * c.P;
  float rz_new = chunk_sum(c, c.red + n3, 2, 0);
  float rr = chunk_sum(c, c.red + n3, 2, 1);
  for (int u = 0; u < 6 * W; ++u) {
    rz_new += st[sRp + u] * st[sZp + u];
    rr += st[sRp + u] * st[sRp + u];
  }
  const float rz = st[sRz];
  const float beta = first ? 0.0f : (fabsf(rz) > 0.0f ? rz_new / rz : 0.0f);
  for (long u = tid; u < n3; u += nt)
    c.p[u] = first ? c.red[u] : c.red[u] + beta * c.p[u];
  __syncthreads();  // every thread read st's rz before thread 0 writes it
  if (tid == 0) {
    for (int u = 0; u < 6 * W; ++u)
      st[sPp + u] = first ? st[sZp + u] : st[sZp + u] + beta * st[sPp + u];
    if (first) {
      st[sRz] = rz_new;
      st[sB2] = rr;
      st[sCgDone] = 0.0f;
    } else {
      const bool done = st[sCgDone] != 0.0f || rr <= kCgTol * kCgTol * st[sB2];
      st[sCgDone] = done ? 1.0f : 0.0f;
      if (!done) st[sRz] = rz_new;
    }
  }
  const int S = 6 * W + 1;
  zero_rows(c, c.reds, S);
  __syncthreads();  // p and the pose part of p written
  const float lam = st[sLam];
  const int cur = cur_of(c);
  const float* Lc = c.lin[cur];
  const float* E = c.es[cur];
  FOR_CHUNKS(c, g) {
    float acc[64];
    for (int q = 0; q < 64; ++q) acc[q] = 0.0f;
    for (int h = 0; h < kChunk; h += 32) {
      const int lp = LOCAL_POINT(c, g, h);
      if (lp < 0 || lp >= c.m) continue;
      const int p = c.p0 + lp;
      float esum[kMaxW][3];
#pragma unroll
      for (int k = 0; k < kMaxW; ++k) esum[k][0] = esum[k][1] = esum[k][2] = 0.0f;
      for (int kk = c.inc_ptr[p]; kk < c.inc_ptr[p + 1]; ++kk) {
        const int e = c.inc_edge[kk];
        const int i = c.ei[e], j = c.ej[e];
        const float sg = c.inc_sign[kk] > 0.0f ? 1.0f : -1.0f;
        float dv[kMaxW][3];
#pragma unroll
        for (int k = 0; k < kMaxW; ++k) {
          for (int d = 0; d < 3; ++d) dv[k][d] = 0.0f;
          if (k < W) {
            const float* pi = c.p + 3L * (static_cast<long>(i) * W + k);
            const float* pj = c.p + 3L * (static_cast<long>(j) * W + k);
            for (int d = 0; d < 3; ++d) dv[k][d] = pi[d] - pj[d];
          }
        }
#pragma unroll
        for (int k = 0; k < kMaxW; ++k) {
          if (k >= W) continue;
          const float* ek = E + kEnd * (static_cast<long>(kk) * W + k);
          float v[3];
          const float wad = ek[3] * (ek[0] * dv[k][0] + ek[1] * dv[k][1]
                                     + ek[2] * dv[k][2]);
          for (int d = 0; d < 3; ++d) v[d] = wad * ek[d];
          if (k + 1 < W && ek[4] != 0.0f)
            for (int d = 0; d < 3; ++d) v[d] -= ek[4] * (dv[k + 1][d] - dv[k][d]);
          if (k > 0) {
            const float wm = E[kEnd * (static_cast<long>(kk) * W + k - 1) + 4];
            if (wm != 0.0f)
              for (int d = 0; d < 3; ++d) v[d] += wm * (dv[k][d] - dv[k - 1][d]);
          }
          for (int d = 0; d < 3; ++d) esum[k][d] += sg * v[d];
        }
      }
#pragma unroll
      for (int k = 0; k < kMaxW; ++k) {
        if (k >= W) continue;
        const long ci = static_cast<long>(lp) * W + k;
        const float* l = Lc + kLin * ci;
        const float* pf = c.p + 3L * (static_cast<long>(p) * W + k);
        const float* pp = st + sPp + 6 * k;
        float ru = l[lJl] * pf[0] + l[lJl + 1] * pf[1] + l[lJl + 2] * pf[2];
        float rv = l[lJl + 3] * pf[0] + l[lJl + 4] * pf[1] + l[lJl + 5] * pf[2];
        for (int d = 0; d < 6; ++d) {
          ru += l[lJp + d] * pp[d];
          rv += l[lJp + 6 + d] * pp[d];
        }
        const float w = l[lWr];
        for (int d = 0; d < 3; ++d) {
          const float hd = w * (l[lJl + d] * ru + l[lJl + 3 + d] * rv)
                           + esum[k][d] + lam * pf[d];
          c.hp[3 * ci + d] = hd;
          acc[6 * W] += pf[d] * hd;
        }
        for (int d = 0; d < 6; ++d)
          acc[6 * k + d] += w * (l[lJp + d] * ru + l[lJp + 6 + d] * rv);
      }
    }
    float* row = c.reds + static_cast<long>(g) * S;
    float lo[32], hi[32];
    for (int q = 0; q < 32; ++q) {
      lo[q] = acc[q];
      hi[q] = acc[32 + q];
    }
    store_part(lo, row, S < 32 ? S : 32);
    if (S > 32) store_part(hi, row + 32, S - 32);
  }
  if (tid == 0) st[sWork + 1] += 1.0f;
}

// One CG trip's second half: alpha from reds (reduced, summed in chunk
// order), x, r, z of the pose part (thread k for keyframe k, into st) and
// of the rank's copies; then z of the rank's copies into red with the r.z,
// r.r partials by chunk, or after the last trip the trial step: the trial
// poses, the trial copies of the rank's points into red with the gain
// ratio's landmark partial x.(lam x - g) by chunk.
__global__ void __launch_bounds__(kThreads, 1)
cg_kernel(Ctx c, int last) {
  __shared__ float col[6 * kMaxW + 1];
  const int tid = threadIdx.x, W = c.W, S = 6 * W + 1;
  float* st = c.st;
  const float lam = st[sLam];
  column_sums(c, c.reds, S, S, col);
  __syncthreads();
  float denom = 0.0f;
  for (int u = 0; u < 6 * W; ++u)
    denom += st[sPp + u] * (col[u] + lam * st[sPp + u]);
  denom += col[6 * W];
  const float alpha = st[sCgDone] != 0.0f ? 0.0f
                      : (fabsf(denom) > 0.0f ? st[sRz] / denom : 0.0f);
  __syncthreads();  // every thread read st before the threads below write it
  if (tid < W) {
    const int k = tid;
    float rv[6];
    for (int d = 0; d < 6; ++d) {
      st[sXp + 6 * k + d] += alpha * st[sPp + 6 * k + d];
      rv[d] = st[sRp + 6 * k + d]
              - alpha * (col[6 * k + d] + lam * st[sPp + 6 * k + d]);
    }
    for (int d = 0; d < 6; ++d) {
      float s = 0.0f;
      for (int j = 0; j < 6; ++j) s += st[sHinv + 36 * k + d * 6 + j] * rv[j];
      st[sZp + 6 * k + d] = s;
      st[sRp + 6 * k + d] = rv[d];
    }
    if (last)
      se3_retract(st + sT + 7 * k, st + sT + 7 * k + 4, st + sXp + 6 * k,
                  st + sTn + 7 * k, st + sTn + 7 * k + 4);
  }
  const int cur = cur_of(c);
  const float* Lc = c.lin[cur];
  const float* Lw = c.L[cur];
  float* rows = c.red + 3L * W * c.P;
  zero_others(c);
  zero_rows(c, rows, last ? 1 : 2);
  FOR_CHUNKS(c, g) {
    float acc[32];
    for (int q = 0; q < 32; ++q) acc[q] = 0.0f;
    for (int h = 0; h < kChunk; h += 32) {
      const int lp = LOCAL_POINT(c, g, h);
      if (lp < 0 || lp >= c.m) continue;
      for (int k = 0; k < W; ++k) {
        const long ci = static_cast<long>(lp) * W + k;
        const long gi = 3 * (static_cast<long>(c.p0) * W + ci);
        float r[3];
        for (int d = 0; d < 3; ++d) {
          c.x[3 * ci + d] += alpha * c.p[gi + d];
          r[d] = c.r[3 * ci + d] - alpha * c.hp[3 * ci + d];
          c.r[3 * ci + d] = r[d];
        }
        if (!last) {
          float z[3];
          apply3(c.minv + 9 * ci, r, z);
          for (int d = 0; d < 3; ++d) {
            c.red[gi + d] = z[d];
            acc[0] += r[d] * z[d];
            acc[1] += r[d] * r[d];
          }
        } else {
          for (int d = 0; d < 3; ++d) {
            const float dx = c.x[3 * ci + d];
            c.red[gi + d] = Lw[gi + d] + dx;
            acc[0] += dx * (lam * dx - Lc[kLin * ci + lGl + d]);
          }
        }
      }
    }
    const int S2 = last ? 1 : 2;
    store_part(acc, rows + static_cast<long>(S2) * g, S2);
  }
}

}  // namespace
}  // namespace nrslam

namespace {

// The scratch of a call, in floats: st, then the per-copy and per-end
// state, the whole copies (2) and p, red and reds; each part's offset.
struct Carve {
  long st, lin0, lin1, es0, es1, minv, x, r, hp, l0, l1, p, red, reds, total;
};

Carve carve(int W, int m, int P, int n_ends, int n) {
  Carve o;
  long at = 0;
  auto take = [&at](long size) { const long here = at; at += size; return here; };
  const long Wm = static_cast<long>(W) * m, WP = static_cast<long>(W) * P;
  const long nc = (P + nrslam::kChunk - 1) / nrslam::kChunk;
  o.st = take(nrslam::sFloats);
  o.lin0 = take(nrslam::kLin * Wm);
  o.lin1 = take(nrslam::kLin * Wm);
  o.es0 = take(static_cast<long>(nrslam::kEnd) * W * n_ends);
  o.es1 = take(static_cast<long>(nrslam::kEnd) * W * n_ends);
  o.minv = take(9 * Wm);
  o.x = take(3 * Wm);
  o.r = take(3 * Wm);
  o.hp = take(3 * Wm);
  o.l0 = take(3 * WP);
  o.l1 = take(3 * WP);
  o.p = take(3 * WP);
  o.red = take(3 * WP + 2 * nc);
  o.reds = take((28L * W + 1) * nc + n);
  o.total = at;
  return o;
}

}  // namespace

// The scratch of a call for W keyframes, m points of P, n_ends CSR
// positions and n ranks, in floats: out = (total, offset of red [3 W P +
// 2 nc], offset of reds [S nc + n], offset of the work counters in st: LM
// steps, CG trips, linearisations; points a chunk of the partial sums
// covers; S = 28 W + 1), nc = ceil(P / chunk).
extern "C" int nrslam_ba_shard_layout(int W, int m, int P, int n_ends, int n,
                                      long* out) {
  const Carve o = carve(W, m, P, n_ends, n);
  out[0] = o.total;
  out[1] = o.red;
  out[2] = o.reds;
  out[3] = o.st + nrslam::sWork;
  out[4] = nrslam::kChunk;
  out[5] = 28L * W + 1;
  return 0;
}

// C entry point of every phase. Pointers are device pointers: params (cam
// 8, pinhole using 4; per keyframe q 4, t 3, 0; info_s), L0 [P][W][3] and
// omask [P][W] of every point, obs [m][W][2] of the rank's points [p0, p0 +
// m), the edge table ei, ej, ew, ed0 (clamped >= 1e-12) and emask (spring
// bit k, damper bit 8 + k) [E], the whole incidence CSR inc_ptr [P + 1],
// inc_edge and inc_sign [n_ends]; scratch (nrslam_ba_shard_layout floats,
// zeroed before the first phase); outputs out_pose [W][8] (q normalised,
// t) and out_L [P][W][3], written by the final step. phase: 0 init_kernel,
// 1 lin_kernel(arg), 2 step_kernel(arg >> 2, arg & 3), 3 hv_kernel(arg), 4
// cg_kernel(arg). Returns cudaErrorInvalidValue for sizes it cannot run,
// else cudaGetLastError() after the launch.
extern "C" int nrslam_ba_shard(
    int phase, int arg, const void* params, int kind, const void* L0,
    const void* omask, const void* obs, const void* ei, const void* ej,
    const void* ew, const void* ed0, const void* emask, const void* inc_ptr,
    const void* inc_edge, const void* inc_sign, void* scratch,
    void* out_pose, void* out_L, int W, int P, int m, int p0, int n_ends,
    int rank, int n, void* stream) {
  if (W < 1 || W > nrslam::kMaxW || P < 1 || m < 1 || p0 < 0 || p0 + m > P
      || n < 1 || rank < 0 || rank >= n
      || (kind != nrslam::kPinhole && kind != nrslam::kKB8))
    return static_cast<int>(cudaErrorInvalidValue);
  const Carve o = carve(W, m, P, n_ends, n);
  float* s = static_cast<float*>(scratch);
  nrslam::Ctx c;
  c.cam = static_cast<const float*>(params);
  c.kind = kind;
  c.L0 = static_cast<const float*>(L0);
  c.obs = static_cast<const float*>(obs);
  c.omask = static_cast<const float*>(omask);
  c.ei = static_cast<const int*>(ei);
  c.ej = static_cast<const int*>(ej);
  c.ew = static_cast<const float*>(ew);
  c.ed0 = static_cast<const float*>(ed0);
  c.emask = static_cast<const int*>(emask);
  c.inc_ptr = static_cast<const int*>(inc_ptr);
  c.inc_edge = static_cast<const int*>(inc_edge);
  c.inc_sign = static_cast<const float*>(inc_sign);
  c.st = s + o.st;
  c.lin[0] = s + o.lin0;
  c.lin[1] = s + o.lin1;
  c.es[0] = s + o.es0;
  c.es[1] = s + o.es1;
  c.minv = s + o.minv;
  c.x = s + o.x;
  c.r = s + o.r;
  c.hp = s + o.hp;
  c.L[0] = s + o.l0;
  c.L[1] = s + o.l1;
  c.p = s + o.p;
  c.red = s + o.red;
  c.reds = s + o.reds;
  c.out_pose = static_cast<float*>(out_pose);
  c.out_L = static_cast<float*>(out_L);
  c.W = W;
  c.P = P;
  c.m = m;
  c.p0 = p0;
  c.rank = rank;
  c.n = n;
  c.S = 28 * W + 1;
  c.nc = (P + nrslam::kChunk - 1) / nrslam::kChunk;
  c.g0 = p0 / nrslam::kChunk;
  c.g1 = (p0 + m - 1) / nrslam::kChunk;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int T = nrslam::kThreads;
  switch (phase) {
    case 0: nrslam::init_kernel<<<1, T, 0, st>>>(c, c.cam); break;
    case 1: nrslam::lin_kernel<<<1, T, 0, st>>>(c, arg); break;
    case 2: nrslam::step_kernel<<<1, T, 0, st>>>(c, arg >> 2, arg & 3); break;
    case 3: nrslam::hv_kernel<<<1, T, 0, st>>>(c, arg); break;
    case 4: nrslam::cg_kernel<<<1, T, 0, st>>>(c, arg); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
