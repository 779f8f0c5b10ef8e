// Bag-of-words word assignment and one k-medoid iteration of the
// vocabulary's training, each fused into one launch on the int8 tensor-core
// distance tile (hamming_tile.cuh), for Hopper (sm_90a). No (R, V) distance
// matrix is ever written.
//
// Replaces, on the bag-of-words path, the TPU kernel
// mageslam_tpu/ops/pallas_kernels.py:57 `hamming_matrix_pallas` together
// with the work that consumed its (R, V) output:
//   - bow_assign: mageslam_tpu/bow/index.py:58-61 `assign_words`, the
//     argmin over the vocabulary and the validity mask (port:
//     mageslam_tpu_torch/ops/bow_words.py, `assign_plain`);
//   - bow_vocab_step: one iteration of mageslam_tpu/bow/vocab.py:40-66
//     `train_vocabulary`'s `step`, with `_majority_descriptor` :27-37
//     (port: mageslam_tpu_torch/ops/bow_words.py, `vocab_step_plain`).
//
// Semantics, equal bit for bit to the plain versions:
//   word       the first minimum of the row's Hamming distances over the
//              V <= 64 anchors in index order (argmin: the lower index on a
//              tie), -1 where the row is invalid;
//   votes      per (word, bit) the number of the word's member rows with the
//              bit set, and per word its member count; an invalid row is in
//              no word;
//   majority   bit set where votes * 2 >= max(count, 1), packed into eight
//              32-bit words (bit b of word w is descriptor bit 32 w + b);
//              a word with no member keeps its anchor.
// Everything is an integer: the votes are integer atomics, exact in any
// order.
//
// What bounds them: the launch. bow_assign reads 33 bytes a row and writes
// 4 (R = 512, a keyframe's slots: 19 KB, 0.006 us at 3.35 TB/s; R = 24,576,
// every keyframe at the retrain: 0.9 MB, 0.27 us) and does 32 K int8
// operations a row on the tensor cores (0.008 us at R = 512). The path's
// composite was a 64 x 64-tile matrix writer, then an eager argmin and
// where: three launches, the (R, V) matrix through memory. The k-medoid
// iteration was the same matrix and ~20 eager launches (mask, argmin,
// one_hot, a float matmul of votes, pack_bits, keep-empty). Here:
//   - bow_assign: the V x 32-byte anchor set is staged once a block (2 KB
//     of shared memory), each lane holds its column tiles' words; a warp
//     expands 16 rows into the mma's A operand and runs 8 column tiles of 8
//     (64 anchors) against them. Each lane keeps the first minimum of its
//     16 distances per row in registers, the 4 lanes of a quad merge with
//     two shuffles (lower distance, then lower index), and lane t = 0
//     writes the row's word. The rows are read once, in 8-byte loads.
//   - bow_vocab_step: 128 rows a block (8 warps of 16), staged in shared
//     memory beside the anchors; the warps assign them as above, and a
//     counting sort copies the block's member rows into word order. Then
//     each of the 256 threads owns one descriptor bit and walks them,
//     summing its bit in a register, and adds each word's nonzero sum to
//     the (V, 256) global votes with one integer atomic. The votes are
//     complete only when every block has added its share: each block then
//     takes a ticket (__threadfence, atomicAdd), and the last block to
//     arrive takes the majority (each thread loads its bit's 64 votes at
//     once, coalesced across the warp, and a warp ballot packs 32 bits into
//     a descriptor word), writes the new anchors, and leaves the votes, the
//     counts and the ticket zero for the next call. One launch an
//     iteration, the 12 iterations a host loop over launches. At the
//     retrain's pool (7,680 rows) the grid is 60 blocks: one wave.
// Measured (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py, PERF.md): assign
// 2.5-2.7 us a launch, 4.4 at 24,576 rows; vocab_step 15.4-15.7 us at 128
// to 7,680 rows alike and 10.0 with none, so a fixed chain of latencies
// (the fences, the ticket, the last block's majority) sets most of it.
//
// Plain C entry points for ctypes; the caller passes PyTorch's current
// stream and, for bow_vocab_step, zeroed scratch it keeps for that stream
// (the kernel leaves it zero). Each returns cudaGetLastError() after the
// launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "hamming_tile.cuh"

namespace {

using hamming_tile::kWords;

constexpr int kMaxWords = 64;        // V: 8 column tiles of 8
constexpr int kColTiles = kMaxWords / 8;
constexpr int kBig = 1 << 20;
constexpr int kAssignWarps = 4;      // 16-row tiles in flight a block
constexpr int kStepWarps = 8;
constexpr int kStepRows = 16 * kStepWarps;      // 128 rows a block
constexpr int kStepThreads = 32 * kStepWarps;   // 256: one a descriptor bit

// The V anchors into shared memory, rows past V zero (their distances are
// masked), 16 bytes a thread.
__device__ __forceinline__ void stage_anchors(uint4* anchors_s, const uint4* anchors,
                                              int n_words) {
  for (int c = threadIdx.x; c < 2 * kMaxWords; c += blockDim.x) {
    anchors_s[c] = (c >> 1) < n_words ? anchors[c] : make_uint4(0, 0, 0, 0);
  }
}

// The words of 16 rows (g and g + 8 of this lane's quad) against the
// staged anchors: (word, distance) of rows g and g + 8, the first minimum,
// the same in all 4 lanes of the quad.
__device__ __forceinline__ void assign_tile(int& word_g, int& word_g8, uint2 row_g,
                                            uint2 row_g8, const uint2 (&cols)[kColTiles],
                                            int n_words, int lane) {
  hamming_tile::RowsA rows;
  hamming_tile::expand_rows(rows, row_g, row_g8);
  int d[kColTiles][4];
  hamming_tile::distances(d, rows, cols);
  const int t = lane & 3;
  int best0 = kBig, best1 = kBig, idx0 = 0, idx1 = 0;
#pragma unroll
  for (int n = 0; n < kColTiles; ++n) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {   // columns 8n + 2t + j, in index order
      const int c = 8 * n + 2 * t + j;
      const int v0 = c < n_words ? d[n][j] : kBig;
      const int v1 = c < n_words ? d[n][2 + j] : kBig;
      if (v0 < best0) { best0 = v0; idx0 = c; }
      if (v1 < best1) { best1 = v1; idx1 = c; }
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {   // the quad's 4 lanes: t ^ 1, t ^ 2
    const int ob0 = __shfl_xor_sync(0xffffffffu, best0, off);
    const int oi0 = __shfl_xor_sync(0xffffffffu, idx0, off);
    const int ob1 = __shfl_xor_sync(0xffffffffu, best1, off);
    const int oi1 = __shfl_xor_sync(0xffffffffu, idx1, off);
    if (ob0 < best0 || (ob0 == best0 && oi0 < idx0)) { best0 = ob0; idx0 = oi0; }
    if (ob1 < best1 || (ob1 == best1 && oi1 < idx1)) { best1 = ob1; idx1 = oi1; }
  }
  word_g = idx0;
  word_g8 = idx1;
}

__device__ __forceinline__ void lane_columns(uint2 (&cols)[kColTiles],
                                             const uint32_t* anchors_s, int lane) {
#pragma unroll
  for (int n = 0; n < kColTiles; ++n) {
    cols[n] = hamming_tile::lane_words(anchors_s, 8 * n + (lane >> 2), lane);
  }
}

__global__ void __launch_bounds__(32 * kAssignWarps)
bow_assign_kernel(const uint32_t* __restrict__ desc, const uint8_t* __restrict__ valid,
                  const uint4* __restrict__ anchors, int32_t* __restrict__ out, int n_rows,
                  int n_words) {
  __shared__ __align__(16) uint4 anchors_s[2 * kMaxWords];
  stage_anchors(anchors_s, anchors, n_words);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  uint2 cols[kColTiles];
  lane_columns(cols, reinterpret_cast<const uint32_t*>(anchors_s), lane);

  const int n_tiles = (n_rows + 15) / 16;
  for (int tile = blockIdx.x * kAssignWarps + (threadIdx.x >> 5); tile < n_tiles;
       tile += gridDim.x * kAssignWarps) {
    const int rg = 16 * tile + g, rg8 = rg + 8;
    const uint2 zero = make_uint2(0, 0);
    const uint2 a0 = rg < n_rows ? hamming_tile::lane_words(desc, rg, lane) : zero;
    const uint2 a1 = rg8 < n_rows ? hamming_tile::lane_words(desc, rg8, lane) : zero;
    int w0, w1;
    assign_tile(w0, w1, a0, a1, cols, n_words, lane);
    if ((lane & 3) == 0) {
      if (rg < n_rows) out[rg] = valid[rg] ? w0 : -1;
      if (rg8 < n_rows) out[rg8] = valid[rg8] ? w1 : -1;
    }
  }
}

struct VocabStepArgs {
  const uint4* desc;        // (N, 8) words as (N, 2) uint4
  const uint8_t* valid;     // (N,) bool
  const uint4* anchors;     // (V, 8) as (V, 2) uint4
  uint32_t* out;            // (V, 8) the new anchors
  int32_t* votes;           // (64, 256) scratch, zero on entry and exit
  int32_t* counts;          // (64,) scratch, zero on entry and exit
  uint32_t* ticket;         // (1,) scratch, zero on entry and exit
  int n_rows, n_words;
};

__global__ void __launch_bounds__(kStepThreads) bow_vocab_step_kernel(const VocabStepArgs args) {
  __shared__ __align__(16) uint4 anchors_s[2 * kMaxWords];
  __shared__ __align__(16) uint4 rows_s[2 * kStepRows];
  __shared__ int word_s[kStepRows];
  __shared__ bool valid_s[kStepRows];
  __shared__ int counts_s[kMaxWords];
  __shared__ int fill_s[kMaxWords];
  __shared__ int members_s;
  __shared__ __align__(16) uint4 sorted_s[2 * kStepRows];   // the member rows, by word
  __shared__ int sorted_w_s[kStepRows];                      // and their words
  __shared__ bool last_s;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kStepRows;
  stage_anchors(anchors_s, args.anchors, args.n_words);
  for (int c = tid; c < 2 * kStepRows; c += kStepThreads) {
    const int r = row0 + (c >> 1);
    rows_s[c] = r < args.n_rows ? args.desc[2 * static_cast<size_t>(row0) + c]
                                : make_uint4(0, 0, 0, 0);
  }
  if (tid < kStepRows) valid_s[tid] = row0 + tid < args.n_rows && args.valid[row0 + tid];
  if (tid < kMaxWords) counts_s[tid] = 0;
  __syncthreads();

  // assignment: warp w takes rows 16 w .. 16 w + 15 of the block
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2;
  {
    uint2 cols[kColTiles];
    lane_columns(cols, reinterpret_cast<const uint32_t*>(anchors_s), lane);
    const uint32_t* rows_w = reinterpret_cast<const uint32_t*>(rows_s);
    const int lg = 16 * warp + g, lg8 = lg + 8;
    int w0, w1;
    assign_tile(w0, w1, hamming_tile::lane_words(rows_w, lg, lane),
                hamming_tile::lane_words(rows_w, lg8, lane), cols, args.n_words, lane);
    if ((lane & 3) == 0) {
      const bool m0 = valid_s[lg];
      const bool m1 = valid_s[lg8];
      word_s[lg] = m0 ? w0 : -1;
      word_s[lg8] = m1 ? w1 : -1;
      if (m0) atomicAdd(&counts_s[w0], 1);
      if (m1) atomicAdd(&counts_s[w1], 1);
    }
  }
  __syncthreads();

  // the member rows sorted by word (a counting sort: the order within a
  // word does not matter to an integer sum)
  if (tid == 0) {
    int start = 0;
    for (int w = 0; w < kMaxWords; ++w) {
      fill_s[w] = start;
      start += counts_s[w];
    }
    members_s = start;
  }
  __syncthreads();
  if (tid < kStepRows && word_s[tid] >= 0) {
    const int pos = atomicAdd(&fill_s[word_s[tid]], 1);
    sorted_w_s[pos] = word_s[tid];
    sorted_s[2 * pos] = rows_s[2 * tid];
    sorted_s[2 * pos + 1] = rows_s[2 * tid + 1];
  }
  if (tid < args.n_words && counts_s[tid]) atomicAdd(&args.counts[tid], counts_s[tid]);
  __syncthreads();

  // votes: thread `tid` owns bit tid % 32 of descriptor word tid / 32 and
  // walks the sorted members, summing in a register and adding each word's
  // sum to the global votes once; a step's loads depend on no earlier step
  {
    const uint32_t* sorted_w = reinterpret_cast<const uint32_t*>(sorted_s);
    const int word = tid >> 5, bit = tid & 31;
    int acc = 0, cur = -1;
#pragma unroll 8
    for (int i = 0; i < members_s; ++i) {
      const int w = sorted_w_s[i];   // the same for every thread: no divergence
      const int b = (sorted_w[i * kWords + word] >> bit) & 1u;
      if (w != cur) {
        if (acc) atomicAdd(&args.votes[cur * kStepThreads + tid], acc);
        acc = 0;
        cur = w;
      }
      acc += b;
    }
    if (acc) atomicAdd(&args.votes[cur * kStepThreads + tid], acc);
  }

  // the last block to finish takes the majority over the complete votes
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(args.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  // every load first (one round trip, not one a word), then the majority
  int v[kMaxWords];
#pragma unroll
  for (int w = 0; w < kMaxWords; ++w) {
    v[w] = w < args.n_words ? __ldcg(&args.votes[w * kStepThreads + tid]) : 0;
  }
  if (tid < args.n_words) counts_s[tid] = __ldcg(&args.counts[tid]);
  __syncthreads();
  const uint32_t* old = reinterpret_cast<const uint32_t*>(anchors_s);
#pragma unroll
  for (int w = 0; w < kMaxWords; ++w) {
    if (w >= args.n_words) break;
    const int count = counts_s[w];
    const unsigned maj = __ballot_sync(0xffffffffu, 2 * v[w] >= max(count, 1));
    if (lane == 0) args.out[w * kWords + warp] = count > 0 ? maj : old[w * kWords + warp];
    if (v[w]) args.votes[w * kStepThreads + tid] = 0;
  }
  if (tid < args.n_words) args.counts[tid] = 0;
  if (tid == 0) *args.ticket = 0;
}

}  // namespace

extern "C" int mageslam_bow_assign(const void* desc, const void* valid, const void* anchors,
                                   void* out, int n_rows, int n_words, void* stream) {
  if (n_rows < 0 || n_words < 1 || n_words > kMaxWords) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows == 0) return 0;
  const int n_tiles = (n_rows + 15) / 16;
  const int wanted = (n_tiles + kAssignWarps - 1) / kAssignWarps;
  const int blocks = wanted < 4096 ? wanted : 4096;   // the rest by the grid-stride loop
  bow_assign_kernel<<<blocks, 32 * kAssignWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(desc), static_cast<const uint8_t*>(valid),
      static_cast<const uint4*>(anchors), static_cast<int32_t*>(out), n_rows, n_words);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mageslam_bow_vocab_step(const void* desc, const void* valid, const void* anchors,
                                       void* out, void* scratch, int n_rows, int n_words,
                                       void* stream) {
  if (n_rows < 0 || n_words < 1 || n_words > kMaxWords) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int32_t* s = static_cast<int32_t*>(scratch);
  const VocabStepArgs args{static_cast<const uint4*>(desc), static_cast<const uint8_t*>(valid),
                           static_cast<const uint4*>(anchors), static_cast<uint32_t*>(out),
                           s, s + kMaxWords * kStepThreads,
                           reinterpret_cast<uint32_t*>(s + kMaxWords * kStepThreads + kMaxWords),
                           n_rows, n_words};
  // no row: every word is empty and keeps its anchor; one block does that
  const int blocks = n_rows > 0 ? (n_rows + kStepRows - 1) / kStepRows : 1;
  bow_vocab_step_kernel<<<blocks, kStepThreads, 0, static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}
