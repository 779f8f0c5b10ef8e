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
// Design: a grid-stride loop mixes the words in registers and counts the
// valid flags; a warp XOR by shuffle, then a block XOR in shared memory,
// then one atomicXor and two atomicAdds a block into a scratch word set
// that is zero on entry. XOR and integer sums are exact in any order, so
// the result does not depend on the schedule. The last block to take the
// ticket (after a fence) adds the scalar terms, writes the digest and
// zeroes the scratch for the next call, so the digest never leaves the card.
//
// Bound: bytes. It reads 4 (3P + 3K) + P + K + 4 bytes and writes 4; at
// P = 2048, K = 48 that is ~27 KB, ~0.008 us at 3.35 TB/s: the launch and
// the fence-ticket chain set its time.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 264;   // two a streaming multiprocessor

struct DigestScratch {            // zero on entry and on exit
  uint32_t hash;
  uint32_t n_points;
  uint32_t n_keyframes;
  uint32_t ticket;
};

__global__ void __launch_bounds__(kThreads)
state_digest_kernel(const uint32_t* __restrict__ pos, const uint32_t* __restrict__ kf_t,
                    const uint8_t* __restrict__ mp_valid, const uint8_t* __restrict__ kf_valid,
                    const int32_t* __restrict__ fsk, float* __restrict__ out,
                    DigestScratch* scratch, int n_pos, int n_t, int n_points,
                    int n_keyframes) {
  const int tid = threadIdx.x;
  const int stride = gridDim.x * kThreads;
  const int n_words = n_pos + n_t;
  uint32_t h = 0, np = 0, nk = 0;
  for (int i = blockIdx.x * kThreads + tid; i < n_words; i += stride) {
    const uint32_t w = i < n_pos ? __ldg(pos + i) : __ldg(kf_t + (i - n_pos));
    h ^= (w ^ (w >> 16)) * (2654435761u + static_cast<uint32_t>(i) * 2246822519u);
  }
  for (int i = blockIdx.x * kThreads + tid; i < n_points; i += stride) np += mp_valid[i] != 0;
  for (int i = blockIdx.x * kThreads + tid; i < n_keyframes; i += stride) {
    nk += kf_valid[i] != 0;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    h ^= __shfl_xor_sync(0xffffffffu, h, off);
    np += __shfl_xor_sync(0xffffffffu, np, off);
    nk += __shfl_xor_sync(0xffffffffu, nk, off);
  }
  __shared__ uint32_t part[3][kThreads / 32];
  __shared__ bool last_s;
  const int warp = tid >> 5, lane = tid & 31;
  if (lane == 0) {
    part[0][warp] = h;
    part[1][warp] = np;
    part[2][warp] = nk;
  }
  __syncthreads();
  if (tid == 0) {
    uint32_t bh = 0, bp = 0, bk = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      bh ^= part[0][w];
      bp += part[1][w];
      bk += part[2][w];
    }
    if (bh) atomicXor(&scratch->hash, bh);
    if (bp) atomicAdd(&scratch->n_points, bp);
    if (bk) atomicAdd(&scratch->n_keyframes, bk);
    __threadfence();
    last_s = atomicAdd(&scratch->ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last_s || tid != 0) return;
  __threadfence();
  // the other blocks' atomics are visible after the ticket; read through
  // atomics so that no stale cached value is taken
  uint32_t hash = atomicExch(&scratch->hash, 0u);
  const uint32_t points = atomicExch(&scratch->n_points, 0u);
  const uint32_t keyframes = atomicExch(&scratch->n_keyframes, 0u);
  hash ^= points * 2654435769u;
  hash ^= static_cast<uint32_t>(*fsk) * 40503u;
  hash ^= keyframes * 668265263u;
  *out = static_cast<float>((hash ^ (hash >> 8)) & 0xFFFFFFu);
  scratch->ticket = 0;
}

}  // namespace

extern "C" int mageslam_state_digest(const void* mp_pos, const void* kf_t, const void* mp_valid,
                                     const void* kf_valid, const void* fsk, void* out,
                                     void* scratch, int n_points, int n_keyframes,
                                     void* stream) {
  if (n_points < 0 || n_keyframes < 0 || n_points > (1 << 26) || n_keyframes > (1 << 26)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_words = 3 * (n_points + n_keyframes);
  int blocks = (n_words + 4 * kThreads - 1) / (4 * kThreads);   // ~4 words a thread
  blocks = blocks < 1 ? 1 : (blocks > kMaxBlocks ? kMaxBlocks : blocks);
  state_digest_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(mp_pos), static_cast<const uint32_t*>(kf_t),
      static_cast<const uint8_t*>(mp_valid), static_cast<const uint8_t*>(kf_valid),
      static_cast<const int32_t*>(fsk), static_cast<float*>(out),
      static_cast<DigestScratch*>(scratch), 3 * n_points, 3 * n_keyframes, n_points,
      n_keyframes);
  return static_cast<int>(cudaGetLastError());
}
