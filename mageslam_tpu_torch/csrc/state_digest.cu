// The stream path's 24-bit state digest in one launch (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes the digest with XLA
// inside its scan body (mageslam_tpu/runtime/pipeline.py:1201-1217,
// `_scan_frame_body`). Torch has no XOR reduction, so the eager form halves
// the array about 17 times, one launch each; this kernel is one launch.
//
// The function, over the map after a frame (words = mp_pos (P, 3) then
// kf_pose.t (K, 3), float32 read as uint32 bits, i their flat index):
//   mixed_i = (w_i ^ (w_i >> 16)) * (2654435761 + i * 2246822519)   mod 2^32
//   h = XOR of every mixed_i
//   h ^= (#mp_valid) * 2654435769 ^ fsk * 40503 ^ (#kf_valid) * 668265263
//   digest = (h ^ (h >> 8)) & 0xFFFFFF, as float32 (exact below 2^24)
//
// Design: one thread-block cluster of 1, 2, 4 or 8 blocks of 512 threads
// (enough that a thread reads four 16-byte vectors of each array in one
// round, up to 8 blocks; the cluster size is set at launch: one block up to
// P = 2,730). Each array is read with 16-byte loads from its first 16-byte
// boundary, the few words or bytes before it and after the last whole
// vector read one by one by rank 0, every word keeping its flat index
// (kf_t's words continue from 3P). A thread issues all its loads of a
// round, fsk's too, before it uses any. The valid flags are counted 16
// bytes at a time (`__vsetne4`, a popcount). XOR and the two counts reduce
// by shuffle in a warp, then by warp 0 over the block's warps; each block
// writes its three words into rank 0's shared memory (distributed shared
// memory, cluster.cuh), and after one `cluster.sync()` rank 0 adds the
// scalar terms and writes the digest (one block skips the cluster barrier).
// XOR and integer sums are exact in any order, so the result does not
// depend on the schedule. No atomics, fence, ticket or scratch: nothing
// outlives the launch.
//
// Bound: bytes. It reads 4 (3P + 3K) + P + K + 4 bytes and writes 4; at
// P = 2048, K = 48 that is ~27 KB, ~0.008 us at 3.35 TB/s: the launch and
// the loads' latency set its time. Measured (NVIDIA H100 80GB HBM3,
// 700.00 W; chip_smoke.py phase 14, PERF.md §6), µs a launch from the
// profiler: the first design (up to 264 blocks, one atomicXor and
// two atomicAdds a block into scratch kept zero across calls, a fence and
// a ticket, the last block finishing) 3.68-3.97 at (2,048, 48) and
// (8,192, 256); this one 2.87-2.90 and 3.56-3.60, 1.70-1.72 at the floor
// (P = 1, K = 0), 6.12-6.18 at (65,536, 256); 2.93-2.99 on the stream
// window's own calls. In turns from CUDA events (tools/torch_kernel_ab.py)
// the first design is faster only at 65,536 points (4.26-4.27 against
// 6.33-6.38: one cluster reads through at most 8 SMs), a size no path
// calls.
//
// Plain C entry point for ctypes; the caller passes PyTorch's current
// stream. Returns the launch's error (cudaLaunchKernelEx), so a refused
// cluster is reported to the caller.

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRanks = 8;                              // the portable cluster size
constexpr int kVectors = 4;                               // a thread's loads of an array, a round
constexpr int kRankVectors = kVectors * kThreads;         // of the longest array, a block

struct Part {
  uint32_t hash, points, keyframes;
};

__device__ __forceinline__ uint32_t mix(uint32_t w, uint32_t i) {
  return (w ^ (w >> 16)) * (2654435761u + i * 2246822519u);
}

// Words (or bytes) before p's first 16-byte boundary, at most n.
__device__ __forceinline__ int head_of(const void* p, int n, int size) {
  const int to_edge = static_cast<int>((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15);
  return min(n, to_edge / size);
}

// XOR of the hashes and sums of the counts over a warp, in every lane.
__device__ __forceinline__ Part warp_reduce(Part p) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    p.hash ^= __shfl_xor_sync(0xffffffffu, p.hash, off);
    p.points += __shfl_xor_sync(0xffffffffu, p.points, off);
    p.keyframes += __shfl_xor_sync(0xffffffffu, p.keyframes, off);
  }
  return p;
}

__device__ __forceinline__ uint32_t mix4(uint4 w, uint32_t i) {
  return mix(w.x, i) ^ mix(w.y, i + 1) ^ mix(w.z, i + 2) ^ mix(w.w, i + 3);
}

__device__ __forceinline__ uint32_t set4(uint4 b) {
  return __popc(__vsetne4(b.x, 0u)) + __popc(__vsetne4(b.y, 0u)) + __popc(__vsetne4(b.z, 0u)) +
         __popc(__vsetne4(b.w, 0u));
}

// An array read as 16-byte vectors from its first 16-byte boundary: `head`
// elements before it, `n_vec` vectors, the rest from `tail` to n.
struct Span {
  int head, n_vec, tail, n;
};

__device__ __forceinline__ Span span_of(const void* p, int n, int size) {
  const int head = head_of(p, n, size);
  const int n_vec = (n - head) * size / 16;
  return Span{head, n_vec, head + n_vec * 16 / size, n};
}

__global__ void __launch_bounds__(kThreads)
state_digest_kernel(const uint32_t* __restrict__ pos, const uint32_t* __restrict__ kf_t,
                    const uint8_t* __restrict__ mp_valid, const uint8_t* __restrict__ kf_valid,
                    const int32_t* __restrict__ fsk, float* __restrict__ out, int n_points,
                    int n_keyframes) {
  __shared__ Part warp_part[kWarps];
  __shared__ Part rank_part[kMaxRanks];   // read on rank 0 only

  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());
  if (ranks > 1) cluster_merge::arrive_started();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = rank * kThreads + threadIdx.x, threads = ranks * kThreads;
  // every load is issued before any is used: the scalar term, the edges of
  // the four arrays, then each thread's vectors of all four together
  const uint32_t f = tid == 0 ? static_cast<uint32_t>(__ldg(fsk)) : 0u;
  const int n_pos = 3 * n_points;
  const Span sp = span_of(pos, n_pos, 4), st = span_of(kf_t, 3 * n_keyframes, 4);
  const Span sm = span_of(mp_valid, n_points, 1), sk = span_of(kf_valid, n_keyframes, 1);
  const int e = static_cast<int>(threadIdx.x);   // rank 0 reads the edges (< 16 each)
  const bool edges = rank == 0 && threadIdx.x < 16;
  const uint32_t w_ph = edges && e < sp.head ? __ldg(pos + e) : 0u;
  const uint32_t w_pt = edges && sp.tail + e < sp.n ? __ldg(pos + sp.tail + e) : 0u;
  const uint32_t w_th = edges && e < st.head ? __ldg(kf_t + e) : 0u;
  const uint32_t w_tt = edges && st.tail + e < st.n ? __ldg(kf_t + st.tail + e) : 0u;
  const uint8_t b_mh = edges && e < sm.head ? mp_valid[e] : 0;
  const uint8_t b_mt = edges && sm.tail + e < sm.n ? mp_valid[sm.tail + e] : 0;
  const uint8_t b_kh = edges && e < sk.head ? kf_valid[e] : 0;
  const uint8_t b_kt = edges && sk.tail + e < sk.n ? kf_valid[sk.tail + e] : 0;
  const uint4* vp = reinterpret_cast<const uint4*>(pos + sp.head);
  const uint4* vt = reinterpret_cast<const uint4*>(kf_t + st.head);
  const uint4* vm = reinterpret_cast<const uint4*>(mp_valid + sm.head);
  const uint4* vk = reinterpret_cast<const uint4*>(kf_valid + sk.head);
  const int n_iter = max(max(sp.n_vec, st.n_vec), max(sm.n_vec, sk.n_vec));
  const uint4 zero = make_uint4(0, 0, 0, 0);
  uint32_t h = 0, np = 0, nk = 0;
  for (int base = tid; base < n_iter; base += kVectors * threads) {
    uint4 wp[kVectors], wt[kVectors], bm[kVectors], bk[kVectors];
#pragma unroll
    for (int v = 0; v < kVectors; ++v) {   // a round's loads, all in flight together
      const int k = base + v * threads;
      wp[v] = k < sp.n_vec ? __ldg(vp + k) : zero;
      wt[v] = k < st.n_vec ? __ldg(vt + k) : zero;
      bm[v] = k < sm.n_vec ? __ldg(vm + k) : zero;
      bk[v] = k < sk.n_vec ? __ldg(vk + k) : zero;
    }
#pragma unroll
    for (int v = 0; v < kVectors; ++v) {
      const int k = base + v * threads;
      if (k < sp.n_vec) h ^= mix4(wp[v], sp.head + 4 * k);
      if (k < st.n_vec) h ^= mix4(wt[v], n_pos + st.head + 4 * k);
      np += set4(bm[v]);
      nk += set4(bk[v]);
    }
  }
  if (edges) {
    if (e < sp.head) h ^= mix(w_ph, e);
    if (sp.tail + e < sp.n) h ^= mix(w_pt, sp.tail + e);
    if (e < st.head) h ^= mix(w_th, n_pos + e);
    if (st.tail + e < st.n) h ^= mix(w_tt, n_pos + st.tail + e);
    np += (b_mh != 0) + (b_mt != 0);
    nk += (b_kh != 0) + (b_kt != 0);
  }
  Part b = warp_reduce(Part{h, np, nk});
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_part[warp] = b;
  __syncthreads();
  if (warp == 0) {                        // the block's warps, by warp 0
    b = warp_reduce(lane < kWarps ? warp_part[lane] : Part{0, 0, 0});
    if (lane == 0) rank_part[0] = b;      // one block: the whole answer
  }
  if (ranks > 1) {
    cluster_merge::wait_started();
    if (threadIdx.x == 0) *cluster.map_shared_rank(&rank_part[rank], 0) = b;
    cluster.sync();
  }
  if (rank != 0 || threadIdx.x != 0) return;
  uint32_t hash = 0, points = 0, keyframes = 0;
  for (int r = 0; r < ranks; ++r) {
    hash ^= rank_part[r].hash;
    points += rank_part[r].points;
    keyframes += rank_part[r].keyframes;
  }
  hash ^= points * 2654435769u;
  hash ^= f * 40503u;
  hash ^= keyframes * 668265263u;
  *out = static_cast<float>((hash ^ (hash >> 8)) & 0xFFFFFFu);
}

}  // namespace

extern "C" int mageslam_state_digest(const void* mp_pos, const void* kf_t, const void* mp_valid,
                                     const void* kf_valid, const void* fsk, void* out,
                                     int n_points, int n_keyframes, void* stream) {
  if (n_points < 0 || n_keyframes < 0 || n_points > (1 << 26) || n_keyframes > (1 << 26)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // one vector of each array a thread where 8 blocks are enough
  const int n_vec = (3 * (n_points > n_keyframes ? n_points : n_keyframes) + 3) / 4;
  int ranks = 1;
  while (ranks < kMaxRanks && ranks * kRankVectors < n_vec) ranks *= 2;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = ranks;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(ranks);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = 0;
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = &cluster;
  config.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(
      &config, state_digest_kernel, static_cast<const uint32_t*>(mp_pos),
      static_cast<const uint32_t*>(kf_t), static_cast<const uint8_t*>(mp_valid),
      static_cast<const uint8_t*>(kf_valid), static_cast<const int32_t*>(fsk),
      static_cast<float*>(out), n_points, n_keyframes);
  return static_cast<int>(rc != cudaSuccess ? rc : cudaGetLastError());
}
