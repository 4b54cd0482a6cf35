// Cluster skeleton shared by the joint pose+deformation and the keyframe BA
// kernels: one thread block cluster runs one whole LM schedule.
//
// - Partition. Block r of the cluster owns the points [pt_off[r],
//   pt_off[r + 1]) (all K copies of them in the BA), at most own_max of
//   them, own_max a multiple of 4, and the edge-ends [inc_ptr[p0],
//   inc_ptr[p1]) of the per-point incidence CSR, i.e. every live edge once
//   at each endpoint, each point's edges in edge order. The wrapper builds
//   pt_off and the CSR with device ops.
// - Residency (SmemPlan). The PCG's working set sits in dynamic shared
//   memory where it fits, in this order: the state of the owned points
//   (current linearisation, CG vectors, the slices other blocks pull), the
//   full copies of the vectors that edges gather (the search direction p,
//   and the flows or landmarks a linearisation reads), then as many
//   edge-end records as fit. What does not fit goes to this block's region
//   of the global scratch buffer instead; no shape is refused.
// - Exchange. A block writes the new values of its own points into an
//   owned array; after a cluster barrier every block pulls all blocks'
//   arrays into its full copy (gather, pull_start/pull_finish): float4
//   loads over distributed shared memory (map_shared_rank) when the owned
//   state is in shared memory, else from the owner's global region (the
//   barrier's release/acquire orders global memory too; the loads bypass
//   L1). Where the full copies are in shared memory, owners may instead
//   push their slice into every block's copy before the barrier (push).
//   Every block forms p = z + beta p for every point itself,
//   bit-identically in every block.
// - Reductions without atomics. Warp shuffles, one partial per warp in
//   shared memory, one partial per block, cluster.sync(), then every block
//   sums the C block partials in rank order over DSMEM: every block gets
//   the same bits, takes the same branches and reaches every cluster.sync().
//   Block partials alternate between two slots, so a slot is only rewritten
//   after another cluster barrier, when no block still reads it.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace nrslam {

namespace cg = cooperative_groups;

constexpr int kMaxWarps = 8;  // blocks of at most 256 threads

__host__ __device__ inline long pad4(long n) { return (n + 3) / 4 * 4; }

// Where this block sits in the cluster and what it owns.
struct Part {
  int rank, C;
  int p0, p1;  // owned points
  int k0, k1;  // owned edge-ends (CSR positions)
};

__device__ inline Part part_of(const int* pt_off, const int* inc_ptr,
                               int own_max) {
  cg::cluster_group cl = cg::this_cluster();
  Part s;
  s.rank = static_cast<int>(cl.block_rank());
  s.C = static_cast<int>(cl.num_blocks());
  s.p0 = pt_off[s.rank];
  s.p1 = pt_off[s.rank + 1];
  s.k0 = inc_ptr[s.p0];
  s.k1 = inc_ptr[s.p1];
  if (s.p1 - s.p0 > own_max || s.p1 < s.p0) __trap();  // malformed layout
  return s;
}

// Shared scratch of the cluster reductions of up to N values.
template <int N>
struct Reducer {
  float warp[kMaxWarps * N];
  float part[2][N];
  float tot[N];
};

// Warp-sum v[0..M) and store the warp's sums at row[0..M) (lane 0 writes;
// row points into Reducer::warp at this warp's slot plus an offset).
template <int M>
__device__ inline void warp_store(float (&v)[M], float* row) {
#pragma unroll
  for (int k = 0; k < M; ++k)
    for (int off = 16; off > 0; off >>= 1)
      v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int k = 0; k < M; ++k) row[k] = v[k];
}

// v + the partner's v for the two threads of an even/odd lane pair: the
// same bits in both (float addition commutes). Call from all 32 lanes.
__device__ inline float pair_sum(float v) {
  return v + __shfl_xor_sync(0xffffffffu, v, 1);
}

template <int N>
__device__ inline float* warp_row(Reducer<N>& R) {
  return R.warp + (threadIdx.x >> 5) * N;
}

// Cluster totals of the first n values stored by every warp with
// warp_store: afterwards R.tot[0..n) holds the same sums in every block.
// Contains __syncthreads and cluster.sync: call from uniform control flow
// (every thread of every block). `slot` alternates per call. The two
// halves may be split to overlap other DSMEM reads with the barrier's
// wake-up (cluster_total = cluster_total_begin + cluster_total_end).
template <int N>
__device__ inline void cluster_total_begin(Reducer<N>& R, int n, int slot) {
  __syncthreads();
  const int nw = blockDim.x >> 5;
  float* part = R.part[slot];
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    float s = 0.0f;
    for (int w = 0; w < nw; ++w) s += R.warp[w * N + t];
    part[t] = s;
  }
  cg::this_cluster().sync();
}

template <int N>
__device__ inline void cluster_total_end(Reducer<N>& R, int n, int& slot) {
  cg::cluster_group cl = cg::this_cluster();
  const float* part = R.part[slot];
  const int C = static_cast<int>(cl.num_blocks());
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    float s = 0.0f;
    for (int r = 0; r < C; ++r) s += cl.map_shared_rank(part, r)[t];
    R.tot[t] = s;
  }
  slot ^= 1;
  __syncthreads();
}

template <int N>
__device__ inline void cluster_total(Reducer<N>& R, int n, int& slot) {
  cluster_total_begin(R, n, slot);
  cluster_total_end(R, n, slot);
}

// Cluster-wide max of one value per thread, returned to every thread.
template <int N>
__device__ inline float cluster_max(Reducer<N>& R, float v, int& slot) {
  cg::cluster_group cl = cg::this_cluster();
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) R.warp[threadIdx.x >> 5] = v;
  __syncthreads();
  float* part = R.part[slot];
  if (threadIdx.x == 0) {
    float m = R.warp[0];
    const int nw = blockDim.x >> 5;
    for (int w = 1; w < nw; ++w) m = fmaxf(m, R.warp[w]);
    part[0] = m;
  }
  cl.sync();
  const int C = static_cast<int>(cl.num_blocks());
  float m = -INFINITY;
  for (int r = 0; r < C; ++r) m = fmaxf(m, cl.map_shared_rank(part, r)[0]);
  slot ^= 1;
  __syncthreads();  // R.warp is free again
  return m;
}

// Where every block's own slice of a [K][P][3] vector sits: in each
// block's array src[K][own][3] (16-byte aligned) at the same offset, in
// shared memory (stride 0) or in the blocks' global regions, `stride`
// floats apart. off is a shared copy of pt_off.
struct Slices {
  const int* off;
  int K, P, own;  // own = own_max
  long stride;
};

// Block r's copy of this block's array `src`, as a float4 at float u.
__device__ inline float4 peer4(const float* src, int r, const Part& c,
                               const Slices& s, long u) {
  if (s.stride == 0)
    return *reinterpret_cast<const float4*>(
        cg::this_cluster().map_shared_rank(src, r) + u);
  return __ldcg(reinterpret_cast<const float4*>(
      src + (r - c.rank) * s.stride + u));
}

// The f-th float4 of all blocks' slices: block r, keyframe k, first float
// base of the slice; len floats of it are live (<= 0: none).
__device__ inline void slice_pos(int f, const Slices& s, int* r, int* k,
                                 int* base, int* len) {
  const int L4 = 3 * s.own / 4;
  *r = f / (s.K * L4);
  const int rem = f - *r * s.K * L4;
  *k = rem / L4;
  *base = 4 * (rem - *k * L4);
  *len = 3 * (s.off[*r + 1] - s.off[*r]) - *base;
}

__device__ inline void store_slice(float* full, const Slices& s, int r,
                                   int k, int base, int len, float4 v,
                                   bool acc, float beta) {
  float* d = full + (static_cast<long>(k) * s.P + s.off[r]) * 3 + base;
  const float vv[4] = {v.x, v.y, v.z, v.w};
  for (int q = 0; q < 4 && q < len; ++q)
    d[q] = acc ? vv[q] + beta * d[q] : vv[q];
}

// Pull every block's own slice into this block's full copy:
// full[k][pt_off[r] + lp] = src_r[k][lp] (+ beta * full[...] when `acc`).
// The owners' writes of src must precede a cluster barrier; sync the block
// before reading `full`.
__device__ inline void gather(float* full, const float* src, const Part& c,
                              const Slices& s, bool acc, float beta) {
  const int n = c.C * s.K * (3 * s.own / 4);
  for (int f = threadIdx.x; f < n; f += blockDim.x) {
    int r, k, base, len;
    slice_pos(f, s, &r, &k, &base, &len);
    if (len <= 0) continue;
    store_slice(full, s, r, k, base, len,
                peer4(src, r, c, s, static_cast<long>(k) * 3 * s.own + base),
                acc, beta);
  }
}

// The mirror of gather() for K = 1 where the full copies are in shared
// memory: write this block's own slice src [own][3] into every block's full
// copy, full[p0 + lp] = src[lp], with float4 stores over DSMEM (full and
// src 16-byte aligned). Sync the block after writing src; the copies are
// complete after the next cluster barrier.
__device__ inline void push(float* full, const float* src, const Part& c) {
  cg::cluster_group cl = cg::this_cluster();
  const int n4 = (3 * (c.p1 - c.p0) + 3) / 4;
  for (int f = threadIdx.x; f < c.C * n4; f += blockDim.x) {
    const int r = f / n4, u = f - r * n4;
    const float4 v = reinterpret_cast<const float4*>(src)[u];
    float* d = cl.map_shared_rank(full, r) + 3L * c.p0 + 4 * u;
    if (4 * u + 4 <= 3 * (c.p1 - c.p0)) {
      *reinterpret_cast<float4*>(d) = v;
    } else {
      const float vv[4] = {v.x, v.y, v.z, v.w};
      for (int k = 0; 4 * u + k < 3 * (c.p1 - c.p0); ++k) d[k] = vv[k];
    }
  }
}

// gather() in two halves: pull_start loads this thread's share of every
// block's slice into registers (when it fits in M float4 a thread;
// `ok` says so), pull_finish writes full = v (+ beta * full). Lets the
// loads overlap a cluster reduction whose result gives beta.
template <int M>
struct Pulled {
  float4 v[M];
  bool ok;
};

template <int M>
__device__ inline void pull_start(Pulled<M>& pv, const float* src,
                                  const Part& c, const Slices& s) {
  const int n = c.C * s.K * (3 * s.own / 4);
  pv.ok = n <= M * static_cast<int>(blockDim.x);
  if (!pv.ok) return;
#pragma unroll
  for (int u = 0; u < M; ++u) {
    const int f = threadIdx.x + u * blockDim.x;
    if (f >= n) break;
    int r, k, base, len;
    slice_pos(f, s, &r, &k, &base, &len);
    if (len <= 0) continue;
    pv.v[u] = peer4(src, r, c, s, static_cast<long>(k) * 3 * s.own + base);
  }
}

template <int M>
__device__ inline void pull_finish(const Pulled<M>& pv, float* full,
                                   const float* src, const Part& c,
                                   const Slices& s, bool acc, float beta) {
  if (!pv.ok) {
    gather(full, src, c, s, acc, beta);
    return;
  }
  const int n = c.C * s.K * (3 * s.own / 4);
#pragma unroll
  for (int u = 0; u < M; ++u) {
    const int f = threadIdx.x + u * blockDim.x;
    if (f >= n) break;
    int r, k, base, len;
    slice_pos(f, s, &r, &k, &base, &len);
    if (len <= 0) continue;
    store_slice(full, s, r, k, base, len, pv.v[u], acc, beta);
  }
}

// Per-edge-end records of W floats: the first `cap` of a block's edge-ends
// in shared memory, the rest in a global region indexed by CSR position.
struct EndRecs {
  float* sh;  // [cap][W]
  float* gl;  // [n_ends][W], already offset by the block's first end
  int cap, W;

  __device__ inline float* at(int kl) const {
    return kl < cap ? sh + static_cast<long>(kl) * W
                    : gl + static_cast<long>(kl) * W;
  }
};

// ---------------------------------------------------------------------------
// Host side: how a launch's dynamic shared memory is split.
// ---------------------------------------------------------------------------

// How a block's dynamic shared memory is split.
struct SmemPlan {
  int own;      // max points per block: ceil(P / C) rounded up to 4
  int own_sh;   // 1 when the owned points' state is in shared memory
  int full_sh;  // 1 when the full copies are in shared memory
  int cap;      // edge-end records held in shared memory
  long bytes;   // total dynamic shared memory
};

__host__ __device__ inline int own_max(int P, int C) { return ((P + C - 1) / C + 3) / 4 * 4; }

// own_floats: per-owned-point floats; full_f: floats of the full copies;
// end_floats: floats per edge-end record; n_ends: the CSR's length. In
// shared memory, in this order and each only if it fits: the owned
// points' state, the full copies, then as many edge-end records as fit.
inline SmemPlan plan_smem(int P, int C, long own_floats, long full_f,
                          long end_floats, long n_ends, long avail_bytes) {
  SmemPlan s;
  s.own = own_max(P, C);
  const long own_f = own_floats * s.own;
  long left = avail_bytes / 4;
  s.own_sh = own_f <= left ? 1 : 0;
  if (s.own_sh) left -= own_f;
  s.full_sh = full_f <= left ? 1 : 0;
  if (s.full_sh) left -= full_f;
  long cap = left / end_floats;
  if (cap > n_ends) cap = n_ends;
  s.cap = static_cast<int>(cap);
  s.bytes = 4 * ((s.own_sh ? own_f : 0) + (s.full_sh ? full_f : 0)
                 + cap * end_floats);
  return s;
}

// Shared memory a block may use beside the kernel's static shared memory.
template <typename Kernel>
inline cudaError_t smem_available(Kernel kernel, long* bytes) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  *bytes = static_cast<long>(optin) - static_cast<long>(attr.sharedSizeBytes);
  return cudaSuccess;
}

// Launch `kernel` as one cluster of C blocks of `threads` threads with
// `smem` bytes of dynamic shared memory. Refuses (returns an error, never
// falls back) when the card cannot co-schedule such a cluster.
template <typename Kernel, typename... Args>
inline cudaError_t launch_cluster(Kernel kernel, int C, int threads,
                                  long smem, cudaStream_t stream,
                                  Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (C > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace nrslam
