// Pieces shared by the partitioned routes' phase kernels
// (pose_deformation_shard.cu, bundle_adjustment_shard.cu): every phase is
// one thread block cluster of C blocks over a rank's points.
//
// - Blocks on whole chunks. The rank's chunks of kChunk consecutive global
//   points are shared out over the blocks by the wrapper's plan
//   (chunk_off [C + 1]: block b owns chunks [chunk_off[b], chunk_off[b +
//   1])); a chunk's row of partial sums is written by its one block.
// - The fixed order of a chunk's row, the same for any C and any number of
//   ranks: (1) each item (an edge-end, or an (edge-end, keyframe) pair) has
//   its term computed on its own (end_pass: threads spread over the
//   items); (2) a point copy adds its items' terms in CSR order, one after
//   another from 0; (3) a point adds whatever else it has (reprojection,
//   its W copies in keyframe order) to that; (4) the chunk's row is the
//   tree over its 64 point slots (chunk_rows: slot q + slot q + 32, then a
//   warp's shuffle-down tree 16, 8, 4, 2, 1), absent slots 0.
// - Every block reads the device row st from the launch's input slot into
//   shared memory and applies the phase's scalar updates to its copy with
//   the same bits as every other block; only block 0 writes the updated row,
//   to the other slot (the host alternates the slots launch by launch), so
//   no launch writes what any of its blocks reads.
// - Work on a rank's whole vectors (forming p, copying flows) is shared out
//   over the blocks by equal ranges (share).
#pragma once

#include "cluster_pcg.cuh"

namespace nrslam {
namespace shard {

constexpr int kChunk = 64;     // points a chunk's partial sums cover
constexpr int kThreads = 256;  // threads a block (cluster_pcg's kMaxWarps)
constexpr int kTile = 1024;    // items an end pass holds in shared memory

// This block of the launch's cluster and the rank's chunks it owns.
struct Block {
  int b, C;        // block rank, blocks
  int g_lo, g_hi;  // owned chunks [g_lo, g_hi)
};

__device__ inline Block block_of(const int* chunk_off) {
  cg::cluster_group cl = cg::this_cluster();
  Block B;
  B.b = static_cast<int>(cl.block_rank());
  B.C = static_cast<int>(cl.num_blocks());
  B.g_lo = chunk_off[B.b];
  B.g_hi = chunk_off[B.b + 1];
  return B;
}

// This block's equal share [lo, hi) of [0, n).
__device__ inline void share(long n, const Block& B, long* lo, long* hi) {
  *lo = n * B.b / B.C;
  *hi = n * (B.b + 1) / B.C;
}

// st's N floats from the launch's input slot into sst, all the loads
// issued before the first store.
template <int N>
__device__ inline void copy_row(const float* in, float* sst) {
  constexpr int kPer = (N + kThreads - 1) / kThreads;
  float v[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int k = threadIdx.x + u * kThreads;
    v[u] = k < N ? __ldg(in + k) : 0.0f;
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int k = threadIdx.x + u * kThreads;
    if (k < N) sst[k] = v[u];
  }
}

// Block 0 writes its updated copy to the launch's output slot.
__device__ inline void store_row(float* out, const float* sst, int n,
                                 const Block& B) {
  __syncthreads();
  if (B.b == 0)
    for (int k = threadIdx.x; k < n; k += blockDim.x) out[k] = sst[k];
}

// Column col of rows [nc][S] summed in chunk order (the loads of 16 rows
// issued together, then added one after another).
__device__ inline float chunk_sum(const float* rows, int nc, int S, int col) {
  float s = 0.0f;
  for (int g = 0; g < nc; g += 16) {
    float v[16];
#pragma unroll
    for (int u = 0; u < 16; ++u)
      v[u] = g + u < nc ? __ldg(rows + static_cast<long>(g + u) * S + col)
                        : 0.0f;
#pragma unroll
    for (int u = 0; u < 16; ++u)
      if (g + u < nc) s += v[u];
  }
  return s;
}

// The launch's copy of st (N floats) into sst and the first `count`
// column sums of rows [nc][S] into col, behind one barrier.
template <int N>
__device__ inline void load_row(const float* in, float* sst,
                                const float* rows, int nc, int S, int count,
                                float* col) {
  copy_row<N>(in, sst);
  for (int k = threadIdx.x; k < count; k += blockDim.x)
    col[k] = chunk_sum(rows, nc, S, k);
  __syncthreads();
}

// vec [0, n) outside [a, b) zeroed: the two ranges shared out as one.
__device__ inline void zero_outside(float* vec, long n, long a, long b,
                                    const Block& B) {
  long lo, hi;
  share(a + n - b, B, &lo, &hi);
  for (long k = lo + threadIdx.x; k < hi; k += blockDim.x)
    vec[k < a ? k : k - a + b] = 0.0f;
}

// Rows [nc][S] outside the rank's chunks [g0, g1] zeroed, shared out.
__device__ inline void zero_rows(float* rows, int nc, int S, int g0, int g1,
                                 const Block& B) {
  zero_outside(rows, static_cast<long>(nc) * S, static_cast<long>(g0) * S,
               static_cast<long>(g1 + 1) * S, B);
}

// The rows of nb chunks from their point slots: con [nb][S][kChunk] in
// shared memory; rows[(g + u) * stride + col] = the tree of chunk u's
// column col. Warp-uniform; the caller syncs before and after.
__device__ inline void chunk_rows(const float* con, int nb, int S,
                                  float* rows, int g, int stride) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int u = threadIdx.x >> 5; u < nb * S; u += nw) {
    const int cs = u / S, col = u - cs * S;
    const float* v = con + static_cast<long>(u) * kChunk;
    float s = v[lane] + v[lane + 32];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) rows[static_cast<long>(g + cs) * stride + col] = s;
  }
}

// A batch of points: the chunks [gb, ge) of the block, its rank's points
// [pa, pb) among them; point slot q is global point 64 gb + q.
struct Batch {
  int gb, ge, pa, pb;
};

__device__ inline Batch batch_of(int gb, int ge, int p0, int m) {
  Batch t;
  t.gb = gb;
  t.ge = ge;
  t.pa = max(p0, kChunk * gb);
  t.pb = min(p0 + m, kChunk * ge);
  return t;
}

// A batch's CSR ranges for the end pass with W copies a point (the joint:
// W = 1): the items u = e W + k, e in [inc_ptr[pa], inc_ptr[pb]), and for
// the thread's copies cc = threadIdx.x + s blockDim.x (s < NS; point slot
// cc / W, keyframe kk = cc % W) their point's positions [lo, hi). Loads
// only: a kernel takes its first batch's before its first barrier.
template <int NS>
struct Ends {
  int lo[NS], hi[NS], kk[NS], u0, u1;
};

template <int NS>
__device__ inline Ends<NS> ends_of(const int* inc_ptr, int W,
                                   const Batch& t) {
  Ends<NS> r;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int cc = threadIdx.x + s * blockDim.x;
    const int p = kChunk * t.gb + cc / W;
    r.kk[s] = cc % W;
    const bool on = p >= t.pa && p < t.pb;
    r.lo[s] = on ? inc_ptr[p] : 0;
    r.hi[s] = on ? inc_ptr[p + 1] : 0;
  }
  r.u0 = inc_ptr[t.pa] * W;
  r.u1 = inc_ptr[t.pb] * W;
  return r;
}

// Each of the thread's copies adds its items of the tile [t0, t1) (item u
// at tile[d * TILE + u - t0]) in CSR order to acc[s].
template <int NT, int NS, int TILE>
__device__ inline void add_items(const Ends<NS>& r, int W, const float* tile,
                                 int t0, int t1, float (&acc)[NS][NT]) {
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    // CSR positions e with e W + kk in [t0, t1).
    const int e0 = max(r.lo[s], (t0 - r.kk[s] + W - 1) / W);
    const int e1 = min(r.hi[s], (t1 - r.kk[s] + W - 1) / W);
    for (int e = e0; e < e1; ++e) {
      const float* v = tile + (e * W + r.kk[s] - t0);
#pragma unroll
      for (int d = 0; d < NT; ++d) acc[s][d] += v[d * TILE];
    }
  }
}

// The end pass over r's items in tiles of TILE (a multiple of kThreads; a
// tile takes whole edge-ends, so an edge-end's W items share it), spread
// over the threads: load(e, k) returns what item u = e W + k reads from
// global memory (every load of a thread's items is issued before the
// first store), emit(that, out) writes its NT floats to out[d * TILE],
// d < NT; then the thread of each of its copies adds the copy's items in
// CSR order to acc[s]. Block-uniform; syncs the block.
template <int NT, int NS, int TILE, typename Load, typename Emit>
__device__ inline void end_pass(const Ends<NS>& r, int W, float* tile,
                                Load load, Emit emit,
                                float (&acc)[NS][NT]) {
  constexpr int kPer = TILE / kThreads;
  using Rec = decltype(load(0, 0));
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int d = 0; d < NT; ++d) acc[s][d] = 0.0f;
  const int step = TILE / W * W;
  for (int t0 = r.u0; t0 < r.u1; t0 += step) {
    const int t1 = min(r.u1, t0 + step);
    Rec rec[kPer];
#pragma unroll
    for (int v = 0; v < kPer; ++v) {
      const int u = min(t0 + static_cast<int>(threadIdx.x) + v * kThreads,
                        t1 - 1);
      rec[v] = load(u / W, u % W);
    }
#pragma unroll
    for (int v = 0; v < kPer; ++v) {
      const int ul = static_cast<int>(threadIdx.x) + v * kThreads;
      if (t0 + ul < t1) emit(rec[v], tile + ul);
    }
    __syncthreads();
    add_items<NT, NS, TILE>(r, W, tile, t0, t1, acc);
    __syncthreads();
  }
}

}  // namespace shard
}  // namespace nrslam
