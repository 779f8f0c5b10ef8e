// Two-way (mutual best) descriptor match, fused, batched, for Hopper (sm_90a).
// No (N, M) distance matrix is ever written.
//
// Replaces, on the keyframe-mapping path, the TPU kernel
// mageslam_tpu/ops/pallas_kernels.py:57 `hamming_matrix_pallas` together with
// the epilogue that consumed its (N, M) output in the JAX package's
// match_two_way, mageslam_tpu/ops/matching.py:80-105 (port:
// mageslam_tpu_torch/ops/matching.py, `match_two_way_plain`), once per
// covisible neighbour in create_new_map_points
// (mageslam_tpu/worldmap/new_points.py:133, vmapped at :190): one call here
// serves all B neighbours.
//
// Semantics, equal bit for bit to the plain version, per batch entry:
//   distance   popcount of the XOR of 8 words read as uint32; a pair reads
//              BIG when its row or its column is invalid or the distance is
//              above max_hamming;
//   forward    per row of A the first minimum over the columns in index
//              order (argmin: column 0 when the row has no candidate) and
//              the minimum of the others, so two equal bests give
//              second == best;
//   backward   the same per column of B over the rows of A;
//   side gate  best < BIG && (second >= BIG || second - best >= min_diff);
//   accept     forward gate of the row, backward gate of the row's column,
//              and that column's best row is this row; else (-1, -1).
//
// What bounds it: bytes, and before them the launch. It reads B * (N + M)
// descriptors of 32 bytes and validity bytes once and writes 8 bytes per
// row of A: about 0.18 MB at B = 5, N = M = 512, 0.05 us at 3.35 TB/s; the
// ±1 int8 product of the valid pairs is ~0.07 us of tensor-core time. A
// SIMT scan with one warp a query stages the other side once per 8 queries
// (10 MB of L2 traffic at B = 5, 512 x 512), scans invalid targets too, and
// spends ~21 M popcounts, a floor near 6 us. This design:
//
//   1. two_way_scan. blockIdx.y is the batch entry; the first ceil(N / 32)
//      blocks of an entry take 32 rows of A each against B, the others 32
//      rows of B against A (the distances are computed twice, stored
//      never). The 32 queries are expanded once into the tensor-core A
//      operand (hamming_tile.cuh). The other side streams through shared
//      memory in chunks of 256 descriptors, double-buffered with 16-byte
//      cp.async: each side is staged once a block. While staging, a ballot
//      and a prefix over the block's warps compact a chunk's valid targets
//      in index order, with their original indices beside them, so no mma
//      is spent on an invalid target. 8 warps: 2 groups of 16 query rows,
//      each split into 4 warps that take every fourth 8-column tile of the
//      chunk, two tiles at a time. 32 rows and 4 splits rather than 64 and
//      2: the scan is bound by the latency of its dependent instructions,
//      so it needs its blocks on many SMs (160 at B = 5, 512 x 512; 28 for
//      mono init's 440 x 440), and staging the other side once per 32
//      queries is still 2.6 MB of L2 reads at B = 5. Every lane keeps, for
//      its two rows, a running (best, index, second) over the columns it
//      sees, in index order, from the mma's accumulator fragments (a later
//      equal distance becomes the second, never the best); then the 4 lanes
//      of a quad merge with shuffles and the 4 warps of a group through
//      shared memory, by PR 2's rule: lower distance, then lower index,
//      second = min(winner's second, loser's best). One 16-byte record
//      (idx, best, second) a query goes to a (B, N + M) scratch buffer. A
//      block whose 32 rows are all invalid stages nothing.
//   2. two_way_gate. One thread per row of A: reads its record and the
//      record of its best column, applies both gates and the mutual check,
//      writes (match_b_idx, dist).
//   A kernel boundary, not a grid-wide counter, orders the scratch writes
//   before the gate's reads.
//
// Plain C entry point for ctypes; the caller passes PyTorch's current
// stream. Returns cudaGetLastError() after the launches.

#include <cstdint>
#include <cuda_runtime.h>

#include "hamming_tile.cuh"

namespace {

using hamming_tile::kWords;

constexpr int kBig = 1 << 20;         // a non-candidate's distance
constexpr int kQueries = 32;          // query rows per block
constexpr int kGroups = kQueries / 16;  // row groups of 16, one mma tile's rows
constexpr int kSplits = 4;            // warps a row group, each a quarter of the tiles
constexpr int kWarps = kGroups * kSplits;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = kThreads;      // targets per staged chunk, one a thread
constexpr int kGateThreads = 256;

struct TwoWayArgs {
  const uint32_t* desc_a;   // (B, N, 8), or (N, 8) with a_stride == 0
  const uint8_t* valid_a;   // (B, N) bool
  const uint32_t* desc_b;   // (B, M, 8)
  const uint8_t* valid_b;   // (B, M) bool
  int4* scratch;            // (B, N + M): idx, best, second, unused
  int32_t* out_idx;         // (B, N)
  int32_t* out_dist;        // (B, N)
  long long a_stride;       // descriptors between batch entries of desc_a
  int n_a, n_b, max_hamming, min_diff;
};

// Issues the copies of chunk [base, base + kChunk)'s valid targets, in index
// order, to desc_s / idx_s (one commit group a thread). Returns how many.
__device__ __forceinline__ int stage_chunk(const uint32_t* t_desc, const uint8_t* t_valid,
                                           int n_target, int base, uint32_t* desc_s,
                                           int* idx_s, int* warp_count) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = base + static_cast<int>(threadIdx.x);
  const bool v = j < n_target && t_valid[j] != 0;
  const unsigned ballot = __ballot_sync(0xffffffffu, v);
  if (lane == 0) warp_count[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = warp_count[w];
    before += w < warp ? c : 0;
    total += c;
  }
  if (v) {
    const int pos = before + __popc(ballot & ((1u << lane) - 1u));
    const uint32_t* src = t_desc + static_cast<size_t>(j) * kWords;
    hamming_tile::cp_async16(desc_s + pos * kWords, src, true);
    hamming_tile::cp_async16(desc_s + pos * kWords + 4, src + 4, true);
    idx_s[pos] = j;
  }
  hamming_tile::cp_async_commit();
  return total;
}

// One column in index order: a later equal distance becomes the second.
__device__ __forceinline__ void see(int& best, int& idx, int& second, int d, int j) {
  const bool better = d < best;
  second = better ? best : min(second, d);
  idx = better ? j : idx;
  best = better ? d : best;
}

// Two running results over disjoint columns: the lower distance wins, on
// equal distances the lower index; second = min(winner's second, loser's best).
__device__ __forceinline__ void merge(int& best, int& idx, int& second, int ob, int oi,
                                      int os) {
  const bool other = ob < best || (ob == best && oi < idx);
  const int loser_best = other ? best : ob;
  const int winner_second = other ? os : second;
  best = other ? ob : best;
  idx = other ? oi : idx;
  second = min(winner_second, loser_best);
}

__device__ __forceinline__ void merge_quad(int& best, int& idx, int& second) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const int ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
    const int os = __shfl_xor_sync(0xffffffffu, second, off);
    merge(best, idx, second, ob, oi, os);
  }
}

__global__ void __launch_bounds__(kThreads)
two_way_scan_kernel(const TwoWayArgs args) {
  __shared__ __align__(16) uint32_t desc_s[2][kChunk * kWords];
  __shared__ int idx_s[2][kChunk];
  __shared__ int warp_count[2][kWarps];
  __shared__ int3 split_s[kSplits - 1][kQueries];   // splits 1.. for split 0

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int group = warp % kGroups;     // 16 query rows
  const int split = warp / kGroups;     // column tiles split, split + kSplits, ...
  const int batch = blockIdx.y;
  const int blocks_a = (args.n_a + kQueries - 1) / kQueries;
  const bool forward = static_cast<int>(blockIdx.x) < blocks_a;
  const int row_block = forward ? blockIdx.x : blockIdx.x - blocks_a;

  const uint32_t* a = args.desc_a + static_cast<size_t>(batch) * args.a_stride * kWords;
  const uint32_t* b = args.desc_b + static_cast<size_t>(batch) * args.n_b * kWords;
  const uint8_t* va = args.valid_a + static_cast<size_t>(batch) * args.n_a;
  const uint8_t* vb = args.valid_b + static_cast<size_t>(batch) * args.n_b;

  // this block's queries and the side it scans
  const uint32_t* q_desc = forward ? a : b;
  const uint8_t* q_valid = forward ? va : vb;
  const int n_query = forward ? args.n_a : args.n_b;
  const uint32_t* t_desc = forward ? b : a;
  const uint8_t* t_valid = forward ? vb : va;
  const int n_target = forward ? args.n_b : args.n_a;

  // rows g and g + 8 of the warp's 16; an invalid row takes no candidate
  const int q_lo = row_block * kQueries + group * 16 + g;
  const int q_hi = q_lo + 8;
  const int qc_lo = min(q_lo, n_query - 1), qc_hi = min(q_hi, n_query - 1);
  const bool valid_lo = q_lo < n_query && q_valid[qc_lo] != 0;
  const bool valid_hi = q_hi < n_query && q_valid[qc_hi] != 0;
  const int limit_lo = valid_lo ? args.max_hamming : -1;
  const int limit_hi = valid_hi ? args.max_hamming : -1;
  hamming_tile::RowsA rows;
  hamming_tile::expand_rows(rows, hamming_tile::lane_words(q_desc, qc_lo, lane),
                            hamming_tile::lane_words(q_desc, qc_hi, lane));

  int best_lo = kBig, idx_lo = 0, second_lo = kBig;
  int best_hi = kBig, idx_hi = 0, second_hi = kBig;

  const int n_chunks = __syncthreads_or(valid_lo || valid_hi)
                           ? (n_target + kChunk - 1) / kChunk : 0;
  int count = n_chunks > 0 ? stage_chunk(t_desc, t_valid, n_target, 0, desc_s[0], idx_s[0],
                                         warp_count[0])
                           : 0;
  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1;
    int next = 0;
    if (c + 1 < n_chunks) {
      next = stage_chunk(t_desc, t_valid, n_target, (c + 1) * kChunk, desc_s[buf ^ 1],
                         idx_s[buf ^ 1], warp_count[buf ^ 1]);
      hamming_tile::cp_async_wait<1>();
    } else {
      hamming_tile::cp_async_wait<0>();
    }
    __syncthreads();

    const int tiles = (count + 7) / 8;
    // this warp's tiles: split, split + kSplits, ...; two at a time, two
    // independent mma chains (a second tile past the end is computed on
    // the last one and reads BIG)
    for (int tile = split; tile < tiles; tile += 2 * kSplits) {
      const bool second_tile = tile + kSplits < tiles;
      const int tiles_of[2] = {tile, min(tile + kSplits, tiles - 1)};
      const uint2 cols[2] = {hamming_tile::lane_words(desc_s[buf], 8 * tiles_of[0] + g, lane),
                             hamming_tile::lane_words(desc_s[buf], 8 * tiles_of[1] + g, lane)};
      int d[2][4];
      hamming_tile::distances(d, rows, cols);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int j = 8 * tiles_of[u] + 2 * t + i;
          const int o = idx_s[buf][j];
          const bool in = j < count && (u == 0 || second_tile);
          see(best_lo, idx_lo, second_lo, in && d[u][i] <= limit_lo ? d[u][i] : kBig, o);
          see(best_hi, idx_hi, second_hi, in && d[u][2 + i] <= limit_hi ? d[u][2 + i] : kBig, o);
        }
      }
    }
    __syncthreads();   // the chunk is read before the next one lands
    count = next;
  }

  merge_quad(best_lo, idx_lo, second_lo);
  merge_quad(best_hi, idx_hi, second_hi);
  const int r = group * 16 + g;
  if (split > 0 && t == 0) {
    split_s[split - 1][r] = make_int3(best_lo, idx_lo, second_lo);
    split_s[split - 1][r + 8] = make_int3(best_hi, idx_hi, second_hi);
  }
  __syncthreads();
  if (split == 0 && t == 0) {
#pragma unroll
    for (int k = 0; k < kSplits - 1; ++k) {
      const int3 lo = split_s[k][r], hi = split_s[k][r + 8];
      merge(best_lo, idx_lo, second_lo, lo.x, lo.y, lo.z);
      merge(best_hi, idx_hi, second_hi, hi.x, hi.y, hi.z);
    }
    int4* records = args.scratch + static_cast<size_t>(batch) * (args.n_a + args.n_b) +
                    (forward ? 0 : args.n_a);
    if (q_lo < n_query) records[q_lo] = make_int4(idx_lo, best_lo, second_lo, 0);
    if (q_hi < n_query) records[q_hi] = make_int4(idx_hi, best_hi, second_hi, 0);
  }
}

__device__ __forceinline__ bool side_ok(const int4 r, int min_diff) {
  return r.y < kBig && (r.z >= kBig || r.z - r.y >= min_diff);
}

__global__ void __launch_bounds__(kGateThreads)
two_way_gate_kernel(const TwoWayArgs args, int n_batch) {
  const long long i = static_cast<long long>(blockIdx.x) * kGateThreads + threadIdx.x;
  if (i >= static_cast<long long>(n_batch) * args.n_a) return;
  const int batch = static_cast<int>(i / args.n_a);
  const int row = static_cast<int>(i % args.n_a);
  const int4* records = args.scratch + static_cast<size_t>(batch) * (args.n_a + args.n_b);
  const int4 fwd = records[row];
  const int4 bwd = records[args.n_a + fwd.x];   // fwd.x is in [0, M): M > 0 here
  const bool ok = side_ok(fwd, args.min_diff) && side_ok(bwd, args.min_diff) && bwd.x == row;
  args.out_idx[i] = ok ? fwd.x : -1;
  args.out_dist[i] = ok ? fwd.y : -1;
}

}  // namespace

extern "C" int mageslam_two_way_match(
    const void* desc_a, const void* valid_a, const void* desc_b, const void* valid_b,
    void* scratch, void* out_idx, void* out_dist, long long a_stride, int n_batch,
    int n_a, int n_b, int max_hamming, int min_diff, void* stream) {
  if (n_batch < 1 || n_batch > 65535 || n_a < 1 || n_b < 1 || a_stride < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const TwoWayArgs args{
      static_cast<const uint32_t*>(desc_a), static_cast<const uint8_t*>(valid_a),
      static_cast<const uint32_t*>(desc_b), static_cast<const uint8_t*>(valid_b),
      static_cast<int4*>(scratch), static_cast<int32_t*>(out_idx),
      static_cast<int32_t*>(out_dist), a_stride, n_a, n_b, max_hamming, min_diff};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int row_blocks = (n_a + kQueries - 1) / kQueries + (n_b + kQueries - 1) / kQueries;
  two_way_scan_kernel<<<dim3(row_blocks, n_batch), kThreads, 0, st>>>(args);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(n_batch) * n_a;
  const unsigned gate_blocks = static_cast<unsigned>((rows + kGateThreads - 1) / kGateThreads);
  two_way_gate_kernel<<<gate_blocks, kGateThreads, 0, st>>>(args, n_batch);
  return static_cast<int>(cudaGetLastError());
}
