// Local deformable BA partitioned over the ranks' point blocks: phase
// kernels, each one thread block cluster, whose partial sums are
// all-reduced between launches.
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
// What bounds it on an H100: the chain of ~173 launches a call, each a few
// dependent global loads deep (an (edge-end, keyframe) pair's record, then
// the far copies' vectors), not bytes or FLOPs (a call moves a few MB and
// does ~0.4 GFLOP at W = 5, P = 768). Tensor cores, wgmma and TMA have no
// tile here: the blocks are float32 3x3 / 6x6 solves and the walks are
// gathers, and TF32 would break the 3e-5 BA gate.
//
// A rank owns all W copies of the points [p0, p0 + m) and their edge-ends:
// positions [inc_ptr[p0], inc_ptr[p0 + m]) of the whole incidence CSR over
// the edges some keyframe's spring uses. The dampers couple copies (k, p)
// and (k + 1, p), so they stay with the point's owner. An edge's terms are
// computed at each end a rank owns, in the edge's (i, j) orientation, so
// the two ranks of an edge that crosses ranks agree bit for bit; an edge's
// chi2 is counted at its i end. The wrapper's table gives each CSR
// position the edge's (i, j, far end, sign) and (w, d0, mask bits), so a
// pair's walk is one load deep before the copies' vectors.
//
// Every launch is one cluster of C <= 16 blocks of 256 threads
// (shard_phase.cuh): block b owns whole chunks of the rank's points; within
// a block the threads spread over (edge-end, keyframe) pairs (end_pass),
// then over the chunk's copies. What every rank must hold the same (the W
// poses, the pose systems, chi2, lambda, nu, the CG scalars and the pose
// part of every CG vector) every block computes from the reduced sums into
// its copy of the device row st (the 6x6 work by a warp); block 0 writes
// it to the other slot. Per owned copy: the current and the trial
// linearisation (lin[cur], lin[1 - cur]), the block-Jacobi inverses and the
// CG vectors, all structure of arrays; per owned (edge-end, keyframe) its
// spring direction and weight and its damper weight to the next keyframe
// (es[cur], es[1 - cur]); the copies (accepted and trial) and the search
// direction p (two slots, one a CG trip) are whole, [P][W] point-major of
// float4, on every rank, so a copy is one 16-byte load. Where a block reads
// what other blocks write in the same launch, a cluster barrier orders the
// two: hv's blocks each form their share of p = z + beta p_old (from red
// and the previous trip's slot) before any block reads a neighbour's p,
// and the trial linearisation's blocks each copy their share of the trial
// copies out of red before any block reads them; the accept of an LM step
// flips `cur` in every block's copy of st. The kernel issues few load
// instructions for that reason: the per-pair records are float4 too, and a
// pair's loads (its copies at k - 1, k, k + 1) are independent.
//
// Sums go by chunk of kChunk consecutive global points, each chunk's row in
// shard_phase.cuh's fixed order (a pair's term, a copy's pairs in CSR
// order, then its reprojection term; a point's W copies in keyframe order;
// then the chunk's tree over its 64 point slots) into a buffer that is
// zero outside the rank's chunks; the all_reduce adds the ranks' rows and
// the next phase adds the rows in chunk order. So two calls give the same
// bits, and where the ranks' blocks are whole chunks n ranks give the bits
// of one process, with any number of blocks.
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

#include "shard_phase.cuh"

namespace nrslam {
namespace {

using shard::Batch;
using shard::Block;
using shard::kChunk;
using shard::kThreads;
using shard::kTile;

constexpr int kMaxBlocks = 16;
constexpr int kHvTile = 2048;     // pairs a tile of hv's pass holds
constexpr int kMaxW = 8;
constexpr int kCopies = 2;        // copies a thread (64 kMaxW <= 2 kThreads)
constexpr float kTh2Dof = 5.99f;
constexpr float kTh3Dof = 0.584f;
constexpr float kInfoR = 4.0f;    // 1 / 0.5^2
constexpr float kInfoP = 100.0f;  // 1 / 0.1^2
constexpr float kSpringK = 1.1f;
constexpr float kLmTau = 1e-5f;
constexpr float kCgTol = 1e-8f;
// Per copy: pose Jacobian rows u, v (12), landmark Jacobian rows u, v (6),
// IRLS weight, landmark gradient (3), landmark block (00 01 02 11 12 22),
// residual u, v, robust chi2.
constexpr int kLin = 31;
constexpr int lJp = 0, lJl = 12, lWr = 18, lGl = 19, lD = 22, lE = 28,
              lRho = 30;
constexpr int kPairTerm = 10;     // a pair's share of its copy: g 3, D 6, chi2

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
  const int4* ends;       // [n_ends] i, j, far end, sign (+1 at i)
  const float4* econ;     // [n_ends] w, d0 (>= 1e-12), mask bits (int bits:
                          // spring bit k, damper (k, k + 1) bit 8 + k), 0
  const int* inc_ptr;     // [P + 1]
  const int* chunk_off;   // [C + 1] the blocks' chunks
  const float* st_in;     // [sFloats] the launch's input slot of st
  float* st_out;          // the other slot
  float* lin[2];          // [kLin][m W]
  float4* es[2];          // [n_ends W] (a0, a1, a2, w_p), at the rank's
  float* wd[2];           // [n_ends W] wd2                  positions
  float* minv;            // [9][m W]
  float* x;               // [3][m W] CG vectors of the rank's copies
  float* r;
  float* hp;
  float4* L[2];           // [P][W] (x, y, z, 0) accepted and trial copies
  float4* p[2];           // [P][W] (x, y, z, 0) search direction, a slot a
                          // CG trip
  float* red;             // [3 W P + 2 nc]
  float* reds;            // [S nc + n]
  float* out_pose;        // [W][8]
  float* out_L;           // [P][W][3]
  int W, P, m, p0, rank, n, S, n_ends;
  int nc, g0, g1;         // chunks of P; the rank's first and last chunk
};

// The shared memory of a phase at W keyframes: the end pass's tile (lin's
// kPairTerm kTile, or hv's 6 kHvTile), the chunk's point-slot
// contributions [S][kChunk] and per-copy partials [2][kChunk W].
constexpr long kTileFloats = kPairTerm * kTile > 6 * kHvTile
                                 ? kPairTerm * kTile : 6 * kHvTile;

__host__ __device__ constexpr long smem_floats(int W) {
  return kTileFloats + (28L * W + 1) * kChunk + 2L * kChunk * W;
}

struct Smem {
  float* tile;
  float* con;
  float* cp;  // [2][kChunk W]
};

__device__ inline Smem smem_of(float4* dyn, int W) {
  Smem s;
  s.tile = reinterpret_cast<float*>(dyn);
  s.con = s.tile + kTileFloats;
  s.cp = s.con + (28L * W + 1) * kChunk;
  return s;
}

// Copy cc = threadIdx.x + s kThreads of the chunk g: point slot, keyframe,
// whether the rank owns it, and its local index lp W + k.
struct Copy {
  int q, k, p;
  bool on;
  long ci;
};

__device__ inline Copy copy_of(const Ctx& c, const Batch& t, int s) {
  Copy o;
  const int cc = threadIdx.x + s * kThreads;
  o.q = cc / c.W;
  o.k = cc - o.q * c.W;
  o.p = kChunk * t.gb + o.q;
  o.on = cc < kChunk * c.W && o.p >= t.pa && o.p < t.pb;
  o.ci = static_cast<long>(o.p - c.p0) * c.W + o.k;
  return o;
}

// Each point slot's sum of its W copies' partials cp[q W + k] (keyframe
// order) into con[q]; syncs the block before and after.
__device__ inline void point_sums(const float* cp, int W, float* con) {
  __syncthreads();
  if (threadIdx.x < kChunk) {
    float s = 0.0f;
    for (int k = 0; k < W; ++k) s += cp[threadIdx.x * W + k];
    con[threadIdx.x] = s;
  }
  __syncthreads();
}

// The rotation and translation of the W poses at st[at] into sR, sTr.
__device__ inline void poses_rt(const float* sst, int at, int W,
                                float (*sR)[9], float (*sTr)[3]) {
  if (threadIdx.x < W) {
    quat_to_matrix(sst + at + 7 * threadIdx.x, sR[threadIdx.x]);
    for (int d = 0; d < 3; ++d)
      sTr[threadIdx.x][d] = sst[at + 7 * threadIdx.x + 4 + d];
  }
  __syncthreads();
}

// Copy (i, k') - copy (j, k') of the copies Lc [P][W] where the spring
// bit k' is set, else 0. Lc may have been written by another block of this
// launch before a cluster barrier: the loads bypass L1.
__device__ inline void spring_diff(const float4* Lc, int W, int i, int j,
                                   int k, int bits, float* o) {
  if (k >= 0 && k < W && ((bits >> k) & 1)) {
    const float4 a = __ldcg(Lc + static_cast<long>(i) * W + k);
    const float4 b = __ldcg(Lc + static_cast<long>(j) * W + k);
    o[0] = a.x - b.x;
    o[1] = a.y - b.y;
    o[2] = a.z - b.z;
  } else {
    o[0] = o[1] = o[2] = 0.0f;
  }
}

// The damper weight between keyframes k and k + 1 of an edge (0 where its
// bit is unset) and dd = dl(k + 1) - dl(k); adds its robust chi2 to *chi2
// at the i end.
__device__ inline float damper(float info_s, float w, bool set, bool iend,
                               const float* dk, const float* dk1, float* dd,
                               float* chi2) {
  for (int d = 0; d < 3; ++d) dd[d] = set ? dk1[d] - dk[d] : 0.0f;
  if (!set) return 0.0f;
  const float chi2_d =
      info_s * (w * w) * (dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2]);
  if (iend) *chi2 += huber_rho(chi2_d, kTh3Dof);
  return info_s * huber_w(chi2_d, kTh3Dof) * (w * w);
}

// The pair (CSR position e, keyframe k) at the copies Lc: its spring at k
// and its dampers to k + 1 (its chi2 counted here) and from k - 1; its term
// [kPairTerm] (its copy's share of g, D and the edge chi2 at the i end)
// into out[d * kTile], (a, w_p) into es4 and wd2 into wd.
__device__ inline void lin_pair(const Ctx& c, int e, int k, const float4* Lc,
                                float info_s, float4* es4, float* wd,
                                float* out) {
  const int W = c.W;
  const int4 r = __ldg(c.ends + e);
  const float4 q = __ldg(c.econ + e);
  const int bits = __float_as_int(q.z);
  const float w = q.x, d0 = q.y;
  const bool iend = r.w > 0;
  float dl[3], dn[3], dp[3], dd[3], ddm[3], chi2 = 0.0f;
  spring_diff(Lc, W, r.x, r.y, k, bits, dl);
  float wd2 = 0.0f, wd2m = 0.0f;
  const bool dn_set = k + 1 < W && ((bits >> (8 + k)) & 1);
  spring_diff(Lc, W, r.x, r.y, dn_set ? k + 1 : -1, bits, dn);
  wd2 = damper(info_s, w, dn_set, iend, dl, dn, dd, &chi2);
  const bool dp_set = k > 0 && ((bits >> (7 + k)) & 1);
  spring_diff(Lc, W, r.x, r.y, dp_set ? k - 1 : -1, bits, dp);
  float unused = 0.0f;
  wd2m = damper(info_s, w, dp_set, false, dp, dl, ddm, &unused);
  float a[3] = {0.0f, 0.0f, 0.0f}, g[3] = {0.0f, 0.0f, 0.0f}, wp = 0.0f;
  if ((bits >> k) & 1) {
    const float dist = sqrtf(dl[0] * dl[0] + dl[1] * dl[1] + dl[2] * dl[2]);
    const float e_p = kSpringK * (dist - d0) / d0;
    if (iend) chi2 += kInfoP * e_p * e_p;
    const float inv_dist = 1.0f / fmaxf(dist, 1e-12f);
    const float kd = kSpringK / d0;
    wp = kInfoP;
    for (int d = 0; d < 3; ++d) {
      a[d] = kd * dl[d] * inv_dist;
      g[d] = wp * e_p * a[d];
    }
  }
  const float extra = wd2 + wd2m;
  for (int d = 0; d < 3; ++d) g[d] = g[d] - wd2 * dd[d] + wd2m * ddm[d];
  const float sg = iend ? 1.0f : -1.0f;
  for (int d = 0; d < 3; ++d) out[d * kTile] = sg * g[d];
  out[3 * kTile] = wp * a[0] * a[0] + extra;
  out[4 * kTile] = wp * a[0] * a[1];
  out[5 * kTile] = wp * a[0] * a[2];
  out[6 * kTile] = wp * a[1] * a[1] + extra;
  out[7 * kTile] = wp * a[1] * a[2];
  out[8 * kTile] = wp * a[2] * a[2] + extra;
  out[9 * kTile] = chi2;
  const long u = static_cast<long>(e) * W + k;
  es4[u] = make_float4(a[0], a[1], a[2], wp);
  wd[u] = wd2;
}

// The copy o at its keyframe's pose (R9, t3) and the copies Lc, its
// pairs' summed terms acc: its linearisation into Lo, its keyframe's 28
// sums at con[(28 k + col) kChunk + q] and its edge chi2 at cp[q W + k];
// returns its landmark block's largest diagonal.
__device__ inline float lin_copy(const Ctx& c, const Copy& o,
                                 const float* R9, const float* t3,
                                 const float4* Lc,
                                 const float (&acc)[kPairTerm],
                                 float* Lo, float* con, float* cp) {
  const int W = c.W;
  const long gc = static_cast<long>(o.p) * W + o.k;
  float Ju[6], Jv[6], Jlu[3], Jlv[3], w_r = 0.0f, eu = 0.0f, ev = 0.0f,
      rho = 0.0f;
  if (c.omask[gc] != 0.0f) {
    const float4 X = __ldcg(Lc + gc);
    const float x0 = X.x, x1 = X.y, x2 = X.z;
    const float xc = R9[0] * x0 + R9[1] * x1 + R9[2] * x2 + t3[0];
    const float yc = R9[3] * x0 + R9[4] * x1 + R9[5] * x2 + t3[1];
    const float zc = R9[6] * x0 + R9[7] * x1 + R9[8] * x2 + t3[2];
    float pu, pv, J[6];
    project_with_jacobian(c.kind, c.cam, xc, yc, zc, &pu, &pv, J);
    const float* ob = c.obs + 2 * o.ci;
    eu = ob[0] - pu;
    ev = ob[1] - pv;
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
  const long s = static_cast<long>(c.m) * W, ci = o.ci;
  for (int d = 0; d < 6; ++d) {
    Lo[(lJp + d) * s + ci] = Ju[d];
    Lo[(lJp + 6 + d) * s + ci] = Jv[d];
  }
  for (int d = 0; d < 3; ++d) {
    Lo[(lJl + d) * s + ci] = Jlu[d];
    Lo[(lJl + 3 + d) * s + ci] = Jlv[d];
  }
  Lo[lWr * s + ci] = w_r;
  for (int d = 0; d < 3; ++d)
    Lo[(lGl + d) * s + ci] = w_r * (Jlu[d] * eu + Jlv[d] * ev) + acc[d];
  const int ia[6] = {0, 0, 0, 1, 1, 2}, ib[6] = {0, 1, 2, 1, 2, 2};
  float D[6];
  for (int d = 0; d < 6; ++d) {
    D[d] = w_r * (Jlu[ia[d]] * Jlu[ib[d]] + Jlv[ia[d]] * Jlv[ib[d]])
           + acc[3 + d];
    Lo[(lD + d) * s + ci] = D[d];
  }
  Lo[lE * s + ci] = eu;
  Lo[(lE + 1) * s + ci] = ev;
  Lo[lRho * s + ci] = rho;
  float* mine = con + 28L * o.k * kChunk + o.q;
  int n = 0;
  for (int a = 0; a < 6; ++a)
    for (int b = a; b < 6; ++b)
      mine[(n++) * kChunk] = w_r * (Ju[a] * Ju[b] + Jv[a] * Jv[b]);
  for (int a = 0; a < 6; ++a)
    mine[(21 + a) * kChunk] = w_r * (Ju[a] * eu + Jv[a] * ev);
  mine[27 * kChunk] = rho;
  cp[o.q * W + o.k] = acc[9];
  return fmaxf(D[0], fmaxf(D[3], D[5]));
}

// The call's start: the poses and info_s from params (cam 8, per keyframe
// q 4, t 3, 0; info_s) into st, the window's copies into L[0].
__global__ void __launch_bounds__(kThreads, 1)
ba_init(Ctx c) {
  const Block B = shard::block_of(c.chunk_off);
  const int tid = threadIdx.x;
  if (B.b == 0)
    for (int u = tid; u < sFloats; u += kThreads) {
      float v = 0.0f;
      if (u < sT + 7 * c.W) v = c.cam[8 + 8 * (u / 7) + u % 7];
      if (u == sInfoS) v = c.cam[8 + 8 * c.W];
      c.st_out[u] = v;
    }
  long lo, hi;
  shard::share(static_cast<long>(c.W) * c.P, B, &lo, &hi);
  for (long u = lo + tid; u < hi; u += kThreads)
    c.L[0][u] = make_float4(c.L0[3 * u], c.L0[3 * u + 1], c.L0[3 * u + 2],
                            0.0f);
}

// kStart: the first linearisation at the accepted poses and copies into
// lin[cur], its sums by chunk into reds [nc][S] and the rank's largest
// landmark-block diagonal at slot rank of a zero-filled [n] after them.
// kTrial: the trial copies (red, whole after the trial step's collective)
// copied into L[1 - cur] (each block its share, then a cluster barrier),
// the step's landmark partial summed into st, then the linearisation at the
// trial poses and copies into lin[1 - cur] and its sums into reds [nc][S].
__global__ void __launch_bounds__(kThreads, 1)
ba_lin(Ctx c, int mode) {
  extern __shared__ float4 dyn[];
  __shared__ float sst[sFloats];
  __shared__ float sR[kMaxW][9], sTr[kMaxW][3];
  __shared__ float col[1];
  __shared__ Reducer<1> R;
  const int W = c.W, tid = threadIdx.x;
  const Smem sm = smem_of(dyn, W);
  const Block B = shard::block_of(c.chunk_off);
  // The first chunk's CSR ranges need no scalar of st: loaded before the
  // first barrier.
  Batch t = shard::batch_of(B.g_lo, B.g_lo + 1, c.p0, c.m);
  shard::Ends<kCopies> ends = shard::ends_of<kCopies>(c.inc_ptr, W, t);
  shard::load_row<sFloats>(c.st_in, sst, c.red + 3L * W * c.P, c.nc, 1,
                           mode == kTrial ? 1 : 0, col);
  const int cur = sst[sCur] != 0.0f ? 1 : 0;
  const int tgt = mode == kStart ? cur : 1 - cur;
  const float4* Lc = c.L[tgt];
  const float info_s = sst[sInfoS];
  if (mode == kTrial) {
    long lo, hi;
    shard::share(static_cast<long>(W) * c.P, B, &lo, &hi);
    for (long u = lo + tid; u < hi; u += kThreads)
      c.L[tgt][u] = make_float4(c.red[3 * u], c.red[3 * u + 1],
                                c.red[3 * u + 2], 0.0f);
    cg::this_cluster().sync();  // every block's share
  }
  poses_rt(sst, mode == kStart ? sT : sTn, W, sR, sTr);
  __syncthreads();  // every thread read st before it changes below
  if (mode == kTrial && tid == 0) sst[sDenomL] = col[0];
  if (tid == 0) sst[sWork + 2] += 1.0f;
  float dmax = -INFINITY;
  float4* es4 = c.es[tgt];
  float* wd = c.wd[tgt];
  for (int g = B.g_lo; g < B.g_hi; ++g) {
    if (g != B.g_lo) {
      t = shard::batch_of(g, g + 1, c.p0, c.m);
      ends = shard::ends_of<kCopies>(c.inc_ptr, W, t);
    }
    float acc[kCopies][kPairTerm];
    shard::end_pass<kPairTerm, kCopies, kTile>(
        ends, W, sm.tile, [](int e, int k) { return make_int2(e, k); },
        [&](int2 ek, float* out) {
          lin_pair(c, ek.x, ek.y, Lc, info_s, es4, wd, out);
        },
        acc);
#pragma unroll
    for (int s = 0; s < kCopies; ++s) {
      const Copy o = copy_of(c, t, s);
      const int cc = tid + s * kThreads;
      if (o.on) {
        dmax = fmaxf(dmax, lin_copy(c, o, sR[o.k], sTr[o.k], Lc, acc[s],
                                    c.lin[tgt], sm.con, sm.cp));
      } else if (cc < kChunk * W) {
        float* mine = sm.con + 28L * o.k * kChunk + o.q;
        for (int u = 0; u < 28; ++u) mine[u * kChunk] = 0.0f;
        sm.cp[o.q * W + o.k] = 0.0f;
      }
    }
    point_sums(sm.cp, W, sm.con + 28L * W * kChunk);
    shard::chunk_rows(sm.con, 1, c.S, c.reds, g, c.S);
    __syncthreads();
  }
  shard::zero_rows(c.reds, c.nc, c.S, c.g0, c.g1, B);
  if (mode == kStart) {
    int slot = 0;
    dmax = cluster_max(R, dmax, slot);
    if (B.b == 0)
      for (int q = tid; q < c.n; q += kThreads)
        c.reds[static_cast<long>(c.S) * c.nc + q] = q == c.rank ? dmax : 0.0f;
    cg::this_cluster().sync();  // no block leaves while others read its smem
  }
  shard::store_row(c.st_out, sst, sFloats, B);
}

// Entry col of keyframe k's upper 6x6 (21 of them, row by row) for (a, b).
__device__ inline int triu6(int a, int b) {
  const int lo = min(a, b), hi = max(a, b);
  return lo * 6 - lo * (lo - 1) / 2 + (hi - lo);
}

// finish 0: reds holds the first linearisation (kStart): lambda0 from the
// largest diagonal. finish 1: reds holds the trial's: gain ratio, lambda /
// nu, accept (flip cur). Then `next`: start the PCG of the next LM step (z
// of the rank's copies into red, zero elsewhere, with the r.z and r.r
// partials by chunk), or write the outputs.
__global__ void __launch_bounds__(kThreads, 1)
ba_step(Ctx c, int finish, int next) {
  extern __shared__ float4 dyn[];
  __shared__ float sst[sFloats];
  __shared__ float col[28 * kMaxW + 1];
  __shared__ int take;
  const int W = c.W, tid = threadIdx.x;
  const Smem sm = smem_of(dyn, W);
  const Block B = shard::block_of(c.chunk_off);
  shard::load_row<sFloats>(c.st_in, sst, c.reds, c.nc, c.S, c.S, col);
  float chi2 = col[28 * W];
  for (int k = 0; k < W; ++k) chi2 += col[28 * k + 27];
  if (tid == 0) {
    float* st = sst;
    if (finish == 0) {
      float dmax = -INFINITY;
      for (int k = 0; k < W; ++k)
        for (int a = 0; a < 6; ++a)
          dmax = fmaxf(dmax, col[28 * k + triu6(a, a)]);
      const float* slots = c.reds + static_cast<long>(c.S) * c.nc;
      for (int r = 0; r < c.n; ++r) dmax = fmaxf(dmax, slots[r]);
      st[sLam] = kLmTau * dmax;
      st[sNu] = 2.0f;
      take = 1;
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
      take = accepted ? 1 : 0;
      if (accepted) {
        for (int u = 0; u < 7 * W; ++u) st[sT + u] = st[sTn + u];
        st[sCur] = st[sCur] != 0.0f ? 0.0f : 1.0f;
      }
    }
  }
  __syncthreads();
  if (take) {
    for (int u = tid; u < 36 * W; u += kThreads) {
      const int k = u / 36, ab = u - 36 * k;
      sst[sH + u] = col[28 * k + triu6(ab / 6, ab % 6)];
    }
    for (int u = tid; u < 6 * W; u += kThreads)
      sst[sG + u] = col[28 * (u / 6) + 21 + u % 6];
    if (tid == 0) sst[sChi2] = chi2;
  }
  __syncthreads();
  const int cur = sst[sCur] != 0.0f ? 1 : 0;
  if (next == kNextFinal) {
    long lo, hi;
    shard::share(static_cast<long>(W) * c.P, B, &lo, &hi);
    for (long u = lo + tid; u < hi; u += kThreads) {
      const float4 v = c.L[cur][u];
      c.out_L[3 * u] = v.x;
      c.out_L[3 * u + 1] = v.y;
      c.out_L[3 * u + 2] = v.z;
    }
    if (B.b == 0 && tid < W) {
      const float* q = sst + sT + 7 * tid;
      const float nq = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2]
                             + q[3] * q[3]);
      float* o = c.out_pose + 8 * tid;
      for (int d = 0; d < 4; ++d) o[d] = q[d] / nq;
      for (int d = 0; d < 3; ++d) o[4 + d] = q[4 + d];
      o[7] = 0.0f;
    }
    shard::store_row(c.st_out, sst, sFloats, B);
    return;
  }

  // Start the PCG: x = 0, r = -g, z = M^-1 r, at the current lambda; the
  // pose part by warp 0 (a lane a keyframe's inverse, then a lane an
  // entry).
  const float lam = sst[sLam];
  if (tid < 32) {
    if (tid < W) inv6(sst + sH + 36 * tid, lam, sst + sHinv + 36 * tid);
    __syncwarp();
    for (int u = tid; u < 6 * W; u += 32) {
      const int k = u / 6, d = u - 6 * k;
      float s = 0.0f;
      for (int j = 0; j < 6; ++j)
        s += sst[sHinv + 36 * k + d * 6 + j] * (-sst[sG + 6 * k + j]);
      sst[sZp + u] = s;
      sst[sXp + u] = 0.0f;
    }
    __syncwarp();
    for (int u = tid; u < 6 * W; u += 32) sst[sRp + u] = -sst[sG + u];
  }
  const float* Lc = c.lin[cur];
  const long s = static_cast<long>(c.m) * W;
  float* rows = c.red + 3L * W * c.P;
  for (int g = B.g_lo; g < B.g_hi; ++g) {
    const Batch t = shard::batch_of(g, g + 1, c.p0, c.m);
#pragma unroll
    for (int v = 0; v < kCopies; ++v) {
      const Copy o = copy_of(c, t, v);
      if (tid + v * kThreads >= kChunk * W) continue;
      float rz = 0.0f, rr = 0.0f;
      if (o.on) {
        const long ci = o.ci;
        const float* D = Lc + lD * s + ci;
        const float m9[9] = {D[0] + lam, D[s], D[2 * s], D[s], D[3 * s] + lam,
                             D[4 * s], D[2 * s], D[4 * s], D[5 * s] + lam};
        float mi[9];
        inv3(m9, mi);
        for (int u = 0; u < 9; ++u) c.minv[u * s + ci] = mi[u];
        float r[3], z[3];
        for (int d = 0; d < 3; ++d) {
          r[d] = -Lc[(lGl + d) * s + ci];
          c.x[d * s + ci] = 0.0f;
          c.r[d * s + ci] = r[d];
        }
        for (int i = 0; i < 3; ++i)
          z[i] = mi[3 * i] * r[0] + mi[3 * i + 1] * r[1] + mi[3 * i + 2] * r[2];
        const long gi = 3L * (static_cast<long>(o.p) * W + o.k);
        for (int d = 0; d < 3; ++d) {
          c.red[gi + d] = z[d];
          rz += r[d] * z[d];
          rr += r[d] * r[d];
        }
      }
      sm.cp[o.q * W + o.k] = rz;
      sm.cp[kChunk * W + o.q * W + o.k] = rr;
    }
    point_sums(sm.cp, W, sm.con);
    point_sums(sm.cp + kChunk * W, W, sm.con + kChunk);
    shard::chunk_rows(sm.con, 1, 2, rows, g, 2);
    __syncthreads();
  }
  shard::zero_outside(c.red, 3L * W * c.P, 3L * W * c.p0,
                      3L * W * (c.p0 + c.m), B);
  shard::zero_rows(rows, c.nc, 2, c.g0, c.g1, B);
  shard::store_row(c.st_out, sst, sFloats, B);
}

// One CG trip's first half: from red (z whole and the r.z, r.r partials by
// chunk, reduced) every block forms the pose part of p = z + beta p and
// its share of p over all P W copies (into slot `slot`, from the previous
// trip's slot), then a cluster barrier; then H p of the block's copies
// (reprojection, and at each of its edge-ends the spring term at the
// copy's keyframe and the dampers to k - 1 and k + 1, + lambda p) and the
// 6 W + 1 partials (pose part of H p per keyframe, p.Hp) by chunk into
// reds.
__global__ void __launch_bounds__(kThreads, 1)
ba_hv(Ctx c, int first, int slot) {
  extern __shared__ float4 dyn[];
  __shared__ float sst[sFloats];
  __shared__ float col[2];
  const int W = c.W, tid = threadIdx.x;
  const Smem sm = smem_of(dyn, W);
  const Block B = shard::block_of(c.chunk_off);
  // Loads that need no scalar of st, before the first barrier: the first
  // chunk's CSR ranges and the first copy of this thread's share of p.
  Batch t = shard::batch_of(B.g_lo, B.g_lo + 1, c.p0, c.m);
  shard::Ends<kCopies> ends = shard::ends_of<kCopies>(c.inc_ptr, W, t);
  const float4* pold = c.p[slot ^ 1];
  float4* pnew = c.p[slot];
  long lo, hi;
  shard::share(static_cast<long>(W) * c.P, B, &lo, &hi);
  const long u0 = lo + tid;
  float z0 = 0.0f, z1 = 0.0f, z2 = 0.0f;
  float4 po = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (u0 < hi) {
    z0 = c.red[3 * u0];
    z1 = c.red[3 * u0 + 1];
    z2 = c.red[3 * u0 + 2];
    if (!first) po = pold[u0];
  }
  const long n3 = 3L * W * c.P;
  shard::load_row<sFloats>(c.st_in, sst, c.red + n3, c.nc, 2, 2, col);
  float rz_new = col[0], rr = col[1];
  for (int u = 0; u < 6 * W; ++u) {
    rz_new += sst[sRp + u] * sst[sZp + u];
    rr += sst[sRp + u] * sst[sRp + u];
  }
  const float rz = sst[sRz];
  const float beta = first ? 0.0f : (fabsf(rz) > 0.0f ? rz_new / rz : 0.0f);
  for (long u = u0; u < hi; u += kThreads) {
    if (u != u0) {
      z0 = c.red[3 * u];
      z1 = c.red[3 * u + 1];
      z2 = c.red[3 * u + 2];
      if (!first) po = pold[u];
    }
    pnew[u] = first ? make_float4(z0, z1, z2, 0.0f)
                    : make_float4(fmaf(beta, po.x, z0), fmaf(beta, po.y, z1),
                                  fmaf(beta, po.z, z2), 0.0f);
  }
  __syncthreads();  // every thread read st's rz before it changes
  for (int u = tid; u < 6 * W; u += kThreads)
    sst[sPp + u] = first ? sst[sZp + u] : sst[sZp + u] + beta * sst[sPp + u];
  if (tid == 0) {
    if (first) {
      sst[sRz] = rz_new;
      sst[sB2] = rr;
      sst[sCgDone] = 0.0f;
    } else {
      const bool done =
          sst[sCgDone] != 0.0f || rr <= kCgTol * kCgTol * sst[sB2];
      sst[sCgDone] = done ? 1.0f : 0.0f;
      if (!done) sst[sRz] = rz_new;
    }
    sst[sWork + 1] += 1.0f;
  }
  __syncthreads();
  const float lam = sst[sLam];
  const int cur = sst[sCur] != 0.0f ? 1 : 0;
  const float* Lc = c.lin[cur];
  const float4* E4 = c.es[cur];
  const float* Ewd = c.wd[cur];
  const long s = static_cast<long>(c.m) * W;
  const int S = 6 * W + 1;
  float* out = sm.tile;                  // [3][kHvTile] the pairs' terms
  float* sdv = sm.tile + 3 * kHvTile;    // [3][kHvTile] their dv
  cg::this_cluster().sync();  // every block's share of p written
  for (int g = B.g_lo; g < B.g_hi; ++g) {
    if (g != B.g_lo) {
      t = shard::batch_of(g, g + 1, c.p0, c.m);
      ends = shard::ends_of<kCopies>(c.inc_ptr, W, t);
    }
    // The chunk's (edge-end, keyframe) pairs in tiles of whole edge-ends:
    // a thread a pair loads dv = p(i, k) - p(j, k) and its record, then,
    // after a barrier, forms its term from dv at k - 1, k and k + 1 (a
    // damper whose weight is 0, unset or past the window, adds 0); then
    // each copy adds its pairs in CSR order.
    float acc[kCopies][3] = {};
    constexpr int kPer = kHvTile / kThreads;
    const int step = kHvTile / W * W;
    for (int t0 = ends.u0; t0 < ends.u1; t0 += step) {
      const int t1 = min(ends.u1, t0 + step);
      float4 q[kPer], pa[kPer], pb[kPer];
      float wd2[kPer], wm[kPer], sg[kPer];
      // Every load of the tile's pairs first, then the stores.
#pragma unroll
      for (int v = 0; v < kPer; ++v) {
        const int u = min(t0 + tid + v * kThreads, t1 - 1);
        const int e = u / W, k = u - e * W;
        const int4 r = __ldg(c.ends + e);
        pa[v] = __ldcg(pnew + static_cast<long>(r.x) * W + k);
        pb[v] = __ldcg(pnew + static_cast<long>(r.y) * W + k);
        q[v] = __ldg(E4 + u);
        wd2[v] = __ldg(Ewd + u);
        wm[v] = k > 0 ? __ldg(Ewd + u - 1) : 0.0f;
        sg[v] = r.w > 0 ? 1.0f : -1.0f;
      }
#pragma unroll
      for (int v = 0; v < kPer; ++v) {
        const int ul = tid + v * kThreads;
        if (t0 + ul >= t1) continue;
        sdv[ul] = pa[v].x - pb[v].x;
        sdv[kHvTile + ul] = pa[v].y - pb[v].y;
        sdv[2 * kHvTile + ul] = pa[v].z - pb[v].z;
      }
      __syncthreads();
#pragma unroll
      for (int v = 0; v < kPer; ++v) {
        const int u = t0 + tid + v * kThreads;
        if (u >= t1) continue;
        const int k = u % W, ul = u - t0;
        float dk[3], dn[3] = {0.0f, 0.0f, 0.0f}, dp[3] = {0.0f, 0.0f, 0.0f};
        for (int d = 0; d < 3; ++d) {
          dk[d] = sdv[d * kHvTile + ul];
          if (k + 1 < W) dn[d] = sdv[d * kHvTile + ul + 1];
          if (k > 0) dp[d] = sdv[d * kHvTile + ul - 1];
        }
        const float wad = q[v].w * (q[v].x * dk[0] + q[v].y * dk[1]
                                    + q[v].z * dk[2]);
        const float a3[3] = {q[v].x, q[v].y, q[v].z};
        for (int d = 0; d < 3; ++d) {
          float x = wad * a3[d];
          x -= wd2[v] * (dn[d] - dk[d]);
          x += wm[v] * (dk[d] - dp[d]);
          out[d * kHvTile + ul] = sg[v] * x;
        }
      }
      __syncthreads();
      shard::add_items<3, kCopies, kHvTile>(ends, W, out, t0, t1, acc);
      __syncthreads();
    }
#pragma unroll
    for (int v = 0; v < kCopies; ++v) {
      const Copy o = copy_of(c, t, v);
      if (tid + v * kThreads >= kChunk * W) continue;
      float part[6] = {0, 0, 0, 0, 0, 0}, php = 0.0f;
      if (o.on) {
        const long ci = o.ci;
        const float4 p4 = __ldcg(pnew + static_cast<long>(o.p) * W + o.k);
        const float pf[3] = {p4.x, p4.y, p4.z};
        const float* pp = sst + sPp + 6 * o.k;
        float ru = Lc[lJl * s + ci] * pf[0] + Lc[(lJl + 1) * s + ci] * pf[1]
                   + Lc[(lJl + 2) * s + ci] * pf[2];
        float rv = Lc[(lJl + 3) * s + ci] * pf[0]
                   + Lc[(lJl + 4) * s + ci] * pf[1]
                   + Lc[(lJl + 5) * s + ci] * pf[2];
        for (int d = 0; d < 6; ++d) {
          ru += Lc[(lJp + d) * s + ci] * pp[d];
          rv += Lc[(lJp + 6 + d) * s + ci] * pp[d];
        }
        const float w = Lc[lWr * s + ci];
        for (int d = 0; d < 3; ++d) {
          const float hd = w * (Lc[(lJl + d) * s + ci] * ru
                                + Lc[(lJl + 3 + d) * s + ci] * rv)
                           + acc[v][d] + lam * pf[d];
          c.hp[d * s + ci] = hd;
          php += pf[d] * hd;
        }
        for (int d = 0; d < 6; ++d)
          part[d] = w * (Lc[(lJp + d) * s + ci] * ru
                         + Lc[(lJp + 6 + d) * s + ci] * rv);
      }
      float* mine = sm.con + 6L * o.k * kChunk + o.q;
      for (int d = 0; d < 6; ++d) mine[d * kChunk] = part[d];
      sm.cp[o.q * W + o.k] = php;
    }
    point_sums(sm.cp, W, sm.con + 6L * W * kChunk);
    shard::chunk_rows(sm.con, 1, S, c.reds, g, S);
    __syncthreads();
  }
  shard::zero_rows(c.reds, c.nc, S, c.g0, c.g1, B);
  shard::store_row(c.st_out, sst, sFloats, B);
}

// A copy's CG state as cg reads it.
struct CgCopy {
  float x[3], r[3], hp[3], mi[9];
  float4 p;
};

__device__ inline void load_cg(const Ctx& c, const float4* pv, const Copy& o,
                               CgCopy& q) {
  const long s = static_cast<long>(c.m) * c.W, ci = o.ci;
  for (int d = 0; d < 3; ++d) {
    q.x[d] = c.x[d * s + ci];
    q.r[d] = c.r[d * s + ci];
    q.hp[d] = c.hp[d * s + ci];
  }
  for (int u = 0; u < 9; ++u) q.mi[u] = c.minv[u * s + ci];
  q.p = pv[static_cast<long>(o.p) * c.W + o.k];
}

// One CG trip's second half: alpha from reds (reduced, summed in chunk
// order), x, r, z of the pose part (warp 0: a lane an entry, into st) and
// of the rank's copies; then z of the rank's copies into red with the r.z,
// r.r partials by chunk, or after the last trip the trial step: the trial
// poses, the trial copies of the rank's points into red with the gain
// ratio's landmark partial x.(lam x - g) by chunk.
__global__ void __launch_bounds__(kThreads, 1)
ba_cg(Ctx c, int last, int slot) {
  extern __shared__ float4 dyn[];
  __shared__ float sst[sFloats];
  __shared__ float col[6 * kMaxW + 1];
  __shared__ float srv[6 * kMaxW];
  const int W = c.W, tid = threadIdx.x, S = 6 * W + 1;
  const Smem sm = smem_of(dyn, W);
  const Block B = shard::block_of(c.chunk_off);
  // The first chunk's copies' state needs no scalar of st: loaded before
  // the first barrier.
  const float4* pv = c.p[slot];
  Batch t = shard::batch_of(B.g_lo, B.g_lo + 1, c.p0, c.m);
  Copy cops[kCopies];
  CgCopy q[kCopies];
#pragma unroll
  for (int v = 0; v < kCopies; ++v) {
    cops[v] = copy_of(c, t, v);
    if (cops[v].on) load_cg(c, pv, cops[v], q[v]);
  }
  shard::load_row<sFloats>(c.st_in, sst, c.reds, c.nc, S, S, col);
  const float lam = sst[sLam];
  float denom = 0.0f;
  for (int u = 0; u < 6 * W; ++u)
    denom += sst[sPp + u] * (col[u] + lam * sst[sPp + u]);
  denom += col[6 * W];
  const float alpha = sst[sCgDone] != 0.0f ? 0.0f
                      : (fabsf(denom) > 0.0f ? sst[sRz] / denom : 0.0f);
  __syncthreads();  // every thread read st before warp 0 changes it
  if (tid < 32) {
    for (int u = tid; u < 6 * W; u += 32) {
      sst[sXp + u] += alpha * sst[sPp + u];
      srv[u] = sst[sRp + u] - alpha * (col[u] + lam * sst[sPp + u]);
    }
    __syncwarp();
    for (int u = tid; u < 6 * W; u += 32) {
      const int k = u / 6, d = u - 6 * k;
      float z = 0.0f;
      for (int j = 0; j < 6; ++j)
        z += sst[sHinv + 36 * k + d * 6 + j] * srv[6 * k + j];
      sst[sZp + u] = z;
      sst[sRp + u] = srv[u];
    }
    __syncwarp();
    if (last && tid < W)
      se3_retract(sst + sT + 7 * tid, sst + sT + 7 * tid + 4,
                  sst + sXp + 6 * tid, sst + sTn + 7 * tid,
                  sst + sTn + 7 * tid + 4);
  }
  const int cur = sst[sCur] != 0.0f ? 1 : 0;
  const float* Lc = c.lin[cur];
  const float4* Lw = c.L[cur];
  const long s = static_cast<long>(c.m) * W;
  float* rows = c.red + 3L * W * c.P;
  const int S2 = last ? 1 : 2;
  for (int g = B.g_lo; g < B.g_hi; ++g) {
    if (g != B.g_lo) {
      t = shard::batch_of(g, g + 1, c.p0, c.m);
#pragma unroll
      for (int v = 0; v < kCopies; ++v) {
        cops[v] = copy_of(c, t, v);
        if (cops[v].on) load_cg(c, pv, cops[v], q[v]);
      }
    }
#pragma unroll
    for (int v = 0; v < kCopies; ++v) {
      const Copy& o = cops[v];
      if (tid + v * kThreads >= kChunk * W) continue;
      float s0 = 0.0f, s1 = 0.0f;
      if (o.on) {
        const long ci = o.ci;
        const long gc = static_cast<long>(o.p) * W + o.k, gi = 3 * gc;
        const float pp3[3] = {q[v].p.x, q[v].p.y, q[v].p.z};
        float r[3], xn[3];
        for (int d = 0; d < 3; ++d) {
          xn[d] = q[v].x[d] + alpha * pp3[d];
          c.x[d * s + ci] = xn[d];
          r[d] = q[v].r[d] - alpha * q[v].hp[d];
          c.r[d * s + ci] = r[d];
        }
        if (!last) {
          float z[3];
          const float* mi = q[v].mi;
          for (int i = 0; i < 3; ++i)
            z[i] = mi[3 * i] * r[0] + mi[3 * i + 1] * r[1]
                   + mi[3 * i + 2] * r[2];
          for (int d = 0; d < 3; ++d) {
            c.red[gi + d] = z[d];
            s0 += r[d] * z[d];
            s1 += r[d] * r[d];
          }
        } else {
          const float4 l4 = Lw[gc];
          const float l3[3] = {l4.x, l4.y, l4.z};
          for (int d = 0; d < 3; ++d) {
            const float dx = xn[d];
            c.red[gi + d] = l3[d] + dx;
            s0 += dx * (lam * dx - Lc[(lGl + d) * s + ci]);
          }
        }
      }
      sm.cp[o.q * W + o.k] = s0;
      sm.cp[kChunk * W + o.q * W + o.k] = s1;
    }
    point_sums(sm.cp, W, sm.con);
    if (!last) point_sums(sm.cp + kChunk * W, W, sm.con + kChunk);
    shard::chunk_rows(sm.con, 1, S2, rows, g, S2);
    __syncthreads();
  }
  shard::zero_outside(c.red, 3L * W * c.P, 3L * W * c.p0,
                      3L * W * (c.p0 + c.m), B);
  shard::zero_rows(rows, c.nc, S2, c.g0, c.g1, B);
  shard::store_row(c.st_out, sst, sFloats, B);
}

}  // namespace
}  // namespace nrslam

namespace {

// The scratch of a call, in floats: st (two slots), then the per-copy and
// per-end state, the whole copies (2) and p (2), red and reds; each part's
// offset.
struct Carve {
  long st, lin0, lin1, es0, es1, wd0, wd1, minv, x, r, hp, l0, l1, p0, p1,
      red, reds, total;
};

Carve carve(int W, int m, int P, int n_ends, int n) {
  Carve o;
  long at = 0;
  // Every part 16-byte aligned (the float4 parts need it).
  auto take = [&at](long size) {
    const long here = nrslam::pad4(at);
    at = here + size;
    return here;
  };
  const long Wm = static_cast<long>(W) * m, WP = static_cast<long>(W) * P;
  const long nc = (P + nrslam::kChunk - 1) / nrslam::kChunk;
  o.st = take(2L * nrslam::sFloats);
  o.lin0 = take(nrslam::kLin * Wm);
  o.lin1 = take(nrslam::kLin * Wm);
  o.es0 = take(4L * W * n_ends);
  o.es1 = take(4L * W * n_ends);
  o.wd0 = take(static_cast<long>(W) * n_ends);
  o.wd1 = take(static_cast<long>(W) * n_ends);
  o.minv = take(9 * Wm);
  o.x = take(3 * Wm);
  o.r = take(3 * Wm);
  o.hp = take(3 * Wm);
  o.l0 = take(4 * WP);
  o.l1 = take(4 * WP);
  o.p0 = take(4 * WP);
  o.p1 = take(4 * WP);
  o.red = take(3 * WP + 2 * nc);
  o.reds = take((28L * W + 1) * nc + n);
  o.total = at;
  return o;
}

}  // namespace

// The scratch of a call for W keyframes, m points of P, n_ends CSR
// positions and n ranks, in floats: out = (total, offset of red [3 W P +
// 2 nc], offset of reds [S nc + n], offset of st's first slot, floats a
// slot (the second follows), offset of the work counters in a slot (LM
// steps, CG trips, linearisations), points a chunk of the partial sums
// covers, S = 28 W + 1, most blocks a phase's cluster takes), nc = ceil(P
// / chunk).
extern "C" int nrslam_ba_shard_layout(int W, int m, int P, int n_ends, int n,
                                      long* out) {
  const Carve o = carve(W, m, P, n_ends, n);
  out[0] = o.total;
  out[1] = o.red;
  out[2] = o.reds;
  out[3] = o.st;
  out[4] = nrslam::sFloats;
  out[5] = nrslam::sWork;
  out[6] = nrslam::kChunk;
  out[7] = 28L * W + 1;
  out[8] = nrslam::kMaxBlocks;
  return 0;
}

// C entry point of every phase. Pointers are device pointers: params (cam
// 8, pinhole using 4; per keyframe q 4, t 3, 0; info_s), L0 [P][W][3] and
// omask [P][W] of every point, obs [m][W][2] of the rank's points [p0, p0 +
// m), the per-end table ends (int4: i, j, far end, sign) and econ (float4:
// w, d0 clamped >= 1e-12, the int bits of the masks (spring bit k, damper
// bit 8 + k), 0) [n_ends] at every position of the whole incidence CSR
// inc_ptr [P + 1], chunk_off [C + 1] (block b of the cluster owns the
// rank's chunks [chunk_off[b], chunk_off[b + 1])); scratch
// (nrslam_ba_shard_layout floats, zeroed before the first phase); outputs
// out_pose [W][8] (q normalised, t) and out_L [P][W][3], written by the
// final step. slot: the launch's index in the call, mod 2 (it reads st's
// slot `slot`, writes the other). phase: 0 ba_init, 1 ba_lin(arg), 2
// ba_step(arg >> 2, arg & 3), 3 ba_hv(arg & 1, arg >> 1), 4 ba_cg(arg & 1,
// arg >> 1) (arg >> 1: the CG trip's p slot). Returns cudaErrorInvalidValue
// for sizes it cannot run, cudaErrorInvalidConfiguration when the card
// cannot hold the cluster, else cudaGetLastError() after the launch.
extern "C" int nrslam_ba_shard(
    int phase, int arg, int slot, int C, const void* params, int kind,
    const void* L0, const void* omask, const void* obs, const void* ends,
    const void* econ, const void* inc_ptr, const void* chunk_off,
    void* scratch, void* out_pose, void* out_L, int W, int P, int m, int p0,
    int n_ends, int rank, int n, void* stream) {
  if (W < 1 || W > nrslam::kMaxW || P < 1 || m < 1 || p0 < 0 || p0 + m > P
      || n < 1 || rank < 0 || rank >= n || C < 1 || C > nrslam::kMaxBlocks
      || (slot & ~1) != 0
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
  c.ends = static_cast<const int4*>(ends);
  c.econ = static_cast<const float4*>(econ);
  c.inc_ptr = static_cast<const int*>(inc_ptr);
  c.chunk_off = static_cast<const int*>(chunk_off);
  c.st_in = s + o.st + slot * nrslam::sFloats;
  c.st_out = s + o.st + (slot ^ 1) * nrslam::sFloats;
  c.lin[0] = s + o.lin0;
  c.lin[1] = s + o.lin1;
  c.es[0] = reinterpret_cast<float4*>(s + o.es0);
  c.es[1] = reinterpret_cast<float4*>(s + o.es1);
  c.wd[0] = s + o.wd0;
  c.wd[1] = s + o.wd1;
  c.minv = s + o.minv;
  c.x = s + o.x;
  c.r = s + o.r;
  c.hp = s + o.hp;
  c.L[0] = reinterpret_cast<float4*>(s + o.l0);
  c.L[1] = reinterpret_cast<float4*>(s + o.l1);
  c.p[0] = reinterpret_cast<float4*>(s + o.p0);
  c.p[1] = reinterpret_cast<float4*>(s + o.p1);
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
  c.n_ends = n_ends;
  c.nc = (P + nrslam::kChunk - 1) / nrslam::kChunk;
  c.g0 = p0 / nrslam::kChunk;
  c.g1 = (p0 + m - 1) / nrslam::kChunk;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long smem = 4 * nrslam::smem_floats(W);
  const int T = nrslam::kThreads;
  cudaError_t err;
  switch (phase) {
    case 0:
      err = nrslam::launch_cluster(nrslam::ba_init, C, T, 0, st, c);
      break;
    case 1:
      err = nrslam::launch_cluster(nrslam::ba_lin, C, T, smem, st, c, arg);
      break;
    case 2:
      err = nrslam::launch_cluster(nrslam::ba_step, C, T, smem, st, c,
                                   arg >> 2, arg & 3);
      break;
    case 3:
      err = nrslam::launch_cluster(nrslam::ba_hv, C, T, smem, st, c, arg & 1,
                                   arg >> 1);
      break;
    case 4:
      err = nrslam::launch_cluster(nrslam::ba_cg, C, T, smem, st, c, arg & 1,
                                   arg >> 1);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
