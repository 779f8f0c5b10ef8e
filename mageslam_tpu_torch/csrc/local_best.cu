// The sharded guided matcher's per-shard step in one launch, for Hopper
// (sm_90a), on the int8 tensor-core distance tile (hamming_tile.cuh): for
// every target (a frame's feature slot), the best and second-best gated
// Hamming distance over this shard's queries (map points) and the first
// query that reaches the best. No (P, N) distance matrix is ever written.
//
// Replaces, on the sharded matcher's path, the TPU kernel
// mageslam_tpu/ops/pallas_kernels.py:57 `hamming_matrix_pallas` together
// with the work that consumed its (P, N) output in
// mageslam_tpu/parallel/sharded_matching.py:25-39 `_local_best` (port:
// mageslam_tpu_torch/ops/local_best.py, `local_best_plain`).
//
// Semantics, equal bit for bit to the plain version:
//   d        Hamming distance of query p and target n where |dx| <= r and
//            |dy| <= r (float32, the Chebyshev box), both valid and
//            d <= max_hamming, else BIG = 2^20;
//   best     the column minimum of d;
//   best_q   the first row reaching it (argmin: the lower row on a tie);
//   second   the column minimum with row best_q set to BIG (equal to best
//            where two rows tie).
//
// Design. A cluster of 8 blocks (`__cluster_dims__`, the portable size)
// owns 16 targets (one 16-row A tile of the mma, its fragments the words
// themselves); its blocks split the query rows into 8 tile-aligned ranges,
// and a block's 8 warps take their range's 8-row B tiles in turn, two tiles
// a round. The grid is 32 clusters at the path's widths (512 targets), 256
// blocks of 73 registers a thread (ptxas; `__launch_bounds__` asks for 3
// blocks an SM), so all run in one wave.
//   - The distances come from 1-bit mmas (m16n8k256, BMMA.AND.POPC): two
//     a tile, popc(a & ~b) + popc(~a & b) = popc(a ^ b), the Hamming
//     distance, with no bit expansion and no popcount beside it. (ptxas
//     turns the single `.xor.popc` form into the same two behind a call;
//     the int8 tile of hamming_tile.cuh needs 8 mmas and the bits' ±1
//     expansion a tile.)
//   - Rounds are double-buffered in registers and taken in turn, so a
//     round's loads (one 8-byte load of words, two of positions, two
//     validity bytes a lane a tile) stay in flight over the other round's
//     work with no register copied; a row past the bank reads the last row
//     and is gated out where it is used, so no load is predicated.
//   - Validity folds into the positions once per row and once per target:
//     an invalid row's or target's x becomes NaN, so the box test, kept as
//     `fabsf(qx - tx) <= r` in float32 (bounds tx ± r would round
//     differently on the box's edge), fails for it as the plain version's
//     mask does. The tests combine with `&`, not `&&`: no branch a pair.
//   - A pair is one 32-bit key, (distance << 22) + row, the distance 257
//     where the pair is outside the box: the least key is the best and its
//     first row, and a lane's running (least, second-least) key takes a
//     pair in three min/max operations. Rows are distinct, so two equal
//     distances give two keys, and second == best on a tie as the
//     reference's. The quad's lanes, the block's warps and the cluster's
//     blocks merge by the same rule: least = min, second = min(the
//     seconds, max of the leasts). The max_hamming gate is applied to the
//     two final keys only: a pair in the box but over it sorts after every
//     pair under it, so the gated column's best, first row and second come
//     out of the box-only keys (and where no pair passes, BIG at row 0).
//     The key's 22 row bits limit P to 2^22 - 64 rows; the entry point
//     refuses more.
//   - Every block writes its partial keys into rank 0's shared memory
//     (distributed shared memory, `map_shared_rank`; cluster.cuh); after
//     one `cluster.sync()` rank 0 merges the 8 and writes the outputs.
//     Nothing is written to global memory but the outputs, and no state
//     outlives the launch: no partials, ticket or fence. A rank with no
//     rows (small P) still writes its empty partial and joins the barrier.
//
// What bounds it on this card: the work is 512 int8-equivalent operations
// a pair (2.1 G at (8192, 512), 1.09 us at 1,979 TOP/s; the 1-bit mma's
// rate is not published); bytes are 41 a query and a target read and 12 a
// target written (0.34 MB, 0.10 us). The per-pair epilogue on the CUDA
// cores (~9 instructions a pair a lane: two subtractions and two compares
// for the box, a select, the key, three min/max) and a round's loads and
// addresses are the larger cost: ~100 instructions a tile a warp, the
// issue slots of ~4.3 us at 8,192 rows.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py phase 3,
// PERF.md §6), µs a launch from the profiler at 1,024 / 2,048 / 4,096 /
// 8,192 rows and 32 (the floor): the first design (32 targets and a
// row range a block, 528 blocks of 4 warps, a warp's tiles one after
// another, partials in global memory merged by a ticketed last block)
// 6.71-6.75 / 7.41-7.54 / 10.14-10.20 / 15.11-15.49; this one 3.23-3.29 /
// 4.01-4.03 / 5.08-5.63 / 8.74-8.81 and 2.62-2.64. In turns from CUDA
// events (tools/torch_kernel_ab.py) the first design is 1.72-2.09x slower
// at 1,024-8,192 rows and faster at 32 (2.43-2.46 against 2.59-2.63): this
// design's fixed cost, the cluster's launch and barrier, is higher.
//
// Plain C entry point for ctypes; the caller passes PyTorch's current
// stream. Returns cudaGetLastError() after the launch, so a refused launch
// (a cluster the card cannot place, for one) is reported to the caller.

#include <climits>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster.cuh"
#include "hamming_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRanks = 8;          // blocks of a cluster (the portable size)
constexpr int kWarps = 8;
constexpr int kTiles = 2;          // 8-row B tiles a warp takes at a time
constexpr int kThreads = 32 * kWarps;
constexpr int kTargets = 16;       // a cluster's targets: one A tile
constexpr int kStep = 8 * kWarps;  // rows between a warp's tiles
constexpr int kGroup = kTiles * kStep;   // rows between a warp's rounds
constexpr int kRowBits = 22;
constexpr int kRowMask = (1 << kRowBits) - 1;
constexpr int kMaxRows = (1 << kRowBits) - 64;   // rows past the bank stay below 2^22
constexpr int kGated = 257;        // a gated pair's distance in a key
constexpr int kBig = 1 << 20;      // the reference's BIG
constexpr int kNoKey = INT_MAX;    // no row yet

struct Args {
  const uint32_t* q_desc;   // (P, 8)
  const float2* q_xy;       // (P,)
  const uint8_t* q_valid;   // (P,)
  const uint32_t* t_desc;   // (N, 8)
  const float2* t_xy;       // (N,)
  const uint8_t* t_valid;   // (N,)
  int32_t* best;            // (N,)
  int32_t* best_q;          // (N,)
  int32_t* second;          // (N,)
  float radius;
  int max_hamming, n_query, n_target, rank_rows;
};

// A set of keys' least and second-least; `take` adds one key, `merge` a
// disjoint set's pair.
__device__ __forceinline__ void take(int& least, int& second, int key) {
  second = min(second, max(key, least));
  least = min(least, key);
}

__device__ __forceinline__ int2 merge(int2 a, int2 b) {
  return make_int2(min(a.x, b.x), min(min(a.y, b.y), max(a.x, b.x)));
}

__device__ __forceinline__ int2 shfl_merge(int2 s, int off) {
  return merge(s, make_int2(__shfl_xor_sync(0xffffffffu, s.x, off),
                            __shfl_xor_sync(0xffffffffu, s.y, off)));
}

// Target tid / 4's merge of n (a multiple of 4) partials part[0..n)[target]:
// the quad's threads take n / 4 each, then merge by shuffle. Threads
// 0 .. 4 * kTargets - 1, whole warps.
template <int n>
__device__ __forceinline__ int2 quad_merge(const int2 (*part)[kTargets], int tid) {
  const int target = tid >> 2, sub = tid & 3;
  int2 s = part[sub][target];
#pragma unroll
  for (int r = sub + 4; r < n; r += 4) s = merge(s, part[r][target]);
  return shfl_merge(shfl_merge(s, 1), 2);
}

// A key's distance, BIG where it is gated out (by the box, or over max_h).
__device__ __forceinline__ int distance_of(int key, int max_h) {
  const int v = key >> kRowBits;
  return v > 256 || v > max_h ? kBig : v;
}

// popc(a & b) summed over a 16 x 8 tile's 256 bits into c, one mma of
// 1-bit operands (BMMA.168256.AND.POPC). Fragments as m16n8k32's with a
// 32-bit word for 4 bytes: a = words 2t, 2t + 1 of rows g and g + 8, b =
// those of column g, so both sides take word 2t for k in [32t, 32t + 32) and
// word 2t + 1 for k in [128 + 32t, 160 + 32t). Two of them, (a, ~b) and
// (~a, b), add up to popc(a ^ b): the Hamming distance. (ptxas expands the
// `.xor.popc` form into the same two, but behind a call.)
__device__ __forceinline__ void mma_b1_and(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                           uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A B tile as one lane holds it, as loaded: words 2t, 2t + 1 of row q0 + g
// (the mma's column g), and the positions and validity of rows q0 + 2t + j
// (its accumulator columns 2t + j). A row past the bank reads the bank's
// last row and is gated out where it is used, so the loads need no
// predicate. Nothing here is used before the tile's turn, so the loads of
// the next round stay in flight over the current one (a test of a loaded
// byte would wait for the load).
struct QueryTile {
  uint2 col;
  float2 xy[2];
  uint8_t valid[2];
};

__device__ __forceinline__ QueryTile load_tile(const uint32_t* q_desc, const float2* q_xy,
                                               const uint8_t* q_valid, int last, int q0,
                                               int lane) {
  const int g = lane >> 2, t = lane & 3;
  QueryTile q;
  q.col = hamming_tile::lane_words(q_desc, min(q0 + g, last), lane);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = min(q0 + 2 * t + j, last);
    q.xy[j] = q_xy[row];
    q.valid[j] = q_valid[row];
  }
  return q;
}

__global__ void __cluster_dims__(kRanks, 1, 1) __launch_bounds__(kThreads, 3)
    local_best_kernel(const Args a) {
  __shared__ int2 warp_part[kWarps][kTargets];
  __shared__ int2 rank_part[kRanks][kTargets];   // read on rank 0 only

  cluster_merge::arrive_started();
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int t0 = (blockIdx.x / kRanks) * kTargets;
  const float nan = __int_as_float(0x7fc00000);

  // targets t0 + g + 8 k, and this warp's first round of rows
  // (q_w + i * kStep), all loaded before any is used
  uint32_t rows[4], rows_not[4];   // the A fragments: the words
  float2 txy[2];
  uint8_t tv[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int n = t0 + g + 8 * k;
    const bool in = n < a.n_target;
    const uint2 w = in ? hamming_tile::lane_words(a.t_desc, n, lane) : make_uint2(0, 0);
    rows[k] = w.x;
    rows[2 + k] = w.y;
    txy[k] = in ? a.t_xy[n] : make_float2(nan, nan);
    tv[k] = in ? a.t_valid[n] : uint8_t{0};
  }
  const float radius = a.radius;
  const uint32_t* q_desc = a.q_desc;
  const float2* q_xy = a.q_xy;
  const uint8_t* q_valid = a.q_valid;
  const int n_query = a.n_query, last = n_query - 1;
  const int r_lo = rank * a.rank_rows;
  const int r_hi = min(r_lo + a.rank_rows, a.n_query);
  const int q_w = r_lo + 8 * warp;
  // two rounds in registers, taken in turn, so no register is copied and a
  // round's loads stay in flight over the other round's work
  QueryTile buf[2][kTiles];
#pragma unroll
  for (int i = 0; i < kTiles; ++i) {
    const int q0 = q_w + i * kStep;
    buf[0][i] = q0 < r_hi ? load_tile(q_desc, q_xy, q_valid, last, q0, lane) : QueryTile{};
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) rows_not[k] = ~rows[k];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (tv[k] == 0) txy[k].x = nan;   // an invalid target is outside every box
  }

  int least[2] = {kNoKey, kNoKey}, second[2] = {kNoKey, kNoKey};

  // the round at row q: its tiles' distances, the gates, the running keys
  auto take_round = [&](const QueryTile (&cur)[kTiles], int q) {
    int d[kTiles][4];
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
      const uint32_t c0 = cur[i].col.x, c1 = cur[i].col.y;
      d[i][0] = d[i][1] = d[i][2] = d[i][3] = 0;
      mma_b1_and(d[i], rows, ~c0, ~c1);
      mma_b1_and(d[i], rows_not, c0, c1);
    }
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
      const int q0 = q + i * kStep;
      if (q0 >= r_hi) continue;            // warp-uniform: past the range
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int row = q0 + 2 * t + j;
        const int gated = (kGated << kRowBits) + row;
        const bool valid = (cur[i].valid[j] != 0) & (row < n_query);
        const float px = valid ? cur[i].xy[j].x : nan, py = cur[i].xy[j].y;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          // accumulator c[2k + j]: A row g + 8k (a target), B column 2t + j;
          // `&`, not `&&`: no branch a pair
          const bool box = (fabsf(px - txy[k].x) <= radius) & (fabsf(py - txy[k].y) <= radius);
          take(least[k], second[k], box ? (d[i][2 * k + j] << kRowBits) + row : gated);
        }
      }
    }
  };
  auto load_round = [&](QueryTile (&dst)[kTiles], int q) {
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
      const int q0 = q + i * kStep;
      if (q0 < r_hi) dst[i] = load_tile(q_desc, q_xy, q_valid, last, q0, lane);
    }
  };
  for (int q = q_w; q < r_hi; q += 2 * kGroup) {
    load_round(buf[1], q + kGroup);
    take_round(buf[0], q);
    if (q + kGroup >= r_hi) break;
    load_round(buf[0], q + 2 * kGroup);
    take_round(buf[1], q + kGroup);
  }

  // the quad's lanes hold the same targets over other columns
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int2 s = shfl_merge(shfl_merge(make_int2(least[k], second[k]), 1), 2);
    if (t == 0) warp_part[warp][8 * k + g] = s;
  }
  __syncthreads();
  cluster_merge::wait_started();
  if (threadIdx.x < 4 * kTargets) {                // the block's warps, then rank 0's slot
    const int2 s = quad_merge<kWarps>(warp_part, threadIdx.x);
    if ((threadIdx.x & 3) == 0) {
      *cluster.map_shared_rank(&rank_part[rank][threadIdx.x >> 2], 0) = s;
    }
  }
  cluster.sync();
  if (rank != 0 || threadIdx.x >= 4 * kTargets) return;
  const int2 s = quad_merge<kRanks>(rank_part, threadIdx.x);
  const int n = t0 + (threadIdx.x >> 2);
  if ((threadIdx.x & 3) == 0 && n < a.n_target) {
    // the distance gate, applied to the two keys (a pair in the box but over
    // max_hamming sorts after every pair under it, so the least key over the
    // box alone has the gated column's minimum and first row where any pair
    // passes both; where none does, every entry is BIG and the first row 0)
    const int best = distance_of(s.x, a.max_hamming);
    a.best[n] = best;
    a.best_q[n] = best < kBig ? s.x & kRowMask : 0;
    a.second[n] = distance_of(s.y, a.max_hamming);   // one row only: no key, BIG
  }
}

}  // namespace

extern "C" int mageslam_local_best(const void* q_desc, const void* q_xy, const void* q_valid,
                                   const void* t_desc, const void* t_xy, const void* t_valid,
                                   void* best, void* best_q, void* second, float radius,
                                   int max_hamming, int n_query, int n_target, void* stream) {
  const long long groups = (static_cast<long long>(n_target) + kTargets - 1) / kTargets;
  if (n_query < 1 || n_query > kMaxRows || n_target < 1 || groups * kRanks > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // rows a block takes: an eighth of the bank, whole 8-row tiles
  const int rank_rows = (n_query + 8 * kRanks - 1) / (8 * kRanks) * 8;
  const Args args{static_cast<const uint32_t*>(q_desc), static_cast<const float2*>(q_xy),
                  static_cast<const uint8_t*>(q_valid), static_cast<const uint32_t*>(t_desc),
                  static_cast<const float2*>(t_xy), static_cast<const uint8_t*>(t_valid),
                  static_cast<int32_t*>(best), static_cast<int32_t*>(best_q),
                  static_cast<int32_t*>(second), radius, max_hamming, n_query, n_target,
                  rank_rows};
  local_best_kernel<<<static_cast<unsigned>(groups * kRanks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}
