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
// Design. A block owns 32 targets (two 16-row A tiles of the mma, expanded
// once into registers) and a contiguous range of query rows; its 4 warps
// take the range's 8-row B tiles in turn. Each lane keeps, for the 4
// targets its accumulators cover (rows g, g + 8 of both A tiles), a running
// (best, row, second) over the query columns it sees, in increasing row
// order, so a strict `<` keeps the first minimum. The quad's 4 lanes, then
// the block's 4 warps, merge by one rule: the lower best wins, the lower
// row wins a tie, and the winner's second becomes min(its second, the
// loser's best), which makes second == best on a tie. The query range is
// split over the grid's y dimension so that (8192, 512) runs 512 blocks;
// each block writes its partial to scratch and takes a ticket for its
// target group, and the last block of the group merges the partials with
// the same rule and writes the outputs, leaving the ticket zero.
//
// What bounds it on this card: the tensor-core operations are 512 int8
// operations a pair (2.1 G at (8192, 512), 1.09 us at 1,979 TOP/s); bytes
// are 41 a query and a target read and 12 a target written (0.34 MB,
// 0.10 us). The per-pair epilogue (the box gate and the running best, ~11
// integer and float instructions a pair a lane) runs on the CUDA cores and
// is the larger cost at these shapes; the popcount form alone would be 8
// POPC a pair, ~8 us at 16 a clock an SM. Measured (NVIDIA H100 80GB HBM3,
// 700 W; chip_smoke.py, PERF.md): 6.7 us a launch at 1,024 rows to 15.5 us
// at 8,192, far above the bound: a warp walks its 8 tiles one after
// another (a load, two chains of 8 mma, the epilogue's running best) with
// 16 warps an SM, and a fixed ~6 us (the launch, the targets' expansion,
// the ticket and the last block's merge). Staging the rows in shared
// memory by cp.async did not move it (17.0 us), so it was not kept.
//
// Plain C entry point for ctypes; the caller passes PyTorch's current
// stream, a zeroed ticket array it keeps for that stream (the kernel
// leaves it zero) and partial scratch. Returns cudaGetLastError() after
// the launch.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "hamming_tile.cuh"

namespace {

constexpr int kBig = 1 << 20;
constexpr int kNone = kBig + 1;      // no row yet: loses to every row
constexpr int kPad = kBig + 2;       // a row past the range: never taken
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTargets = 32;         // a block's targets: two A tiles of 16
constexpr int kMinRows = 128;        // the least query rows a split takes
constexpr int kMaxBlocks = 528;      // 4 blocks for each of 132 SMs

struct Best {
  int best, row, second;
};

__device__ __forceinline__ Best none() { return Best{kNone, INT_MAX, kNone}; }

// Row `row` with gated distance v, rows taken in increasing order.
__device__ __forceinline__ void take(Best& s, int v, int row) {
  s.second = min(s.second, max(v, s.best));
  if (v < s.best) {
    s.best = v;
    s.row = row;
  }
}

// Two partials over disjoint rows.
__device__ __forceinline__ Best merge(Best a, Best b) {
  const bool a_wins = a.best < b.best || (a.best == b.best && a.row < b.row);
  Best w = a_wins ? a : b;
  w.second = min(w.second, a_wins ? b.best : a.best);
  return w;
}

__device__ __forceinline__ Best shfl_merge(Best s, int off) {
  Best o;
  o.best = __shfl_xor_sync(0xffffffffu, s.best, off);
  o.row = __shfl_xor_sync(0xffffffffu, s.row, off);
  o.second = __shfl_xor_sync(0xffffffffu, s.second, off);
  return merge(s, o);
}

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
  int32_t* partials;        // (splits, 3, N)
  uint32_t* tickets;        // (groups,), zero on entry and exit
  float radius;
  int max_hamming, n_query, n_target, split_rows;
};

__device__ __forceinline__ void write_out(const Args& a, int target, Best s) {
  a.best[target] = s.best;
  a.best_q[target] = s.row;
  a.second[target] = min(s.second, kBig);   // one row only: the reference's BIG
}

__global__ void __launch_bounds__(kThreads) local_best_kernel(const Args a) {
  __shared__ Best warp_s[kWarps][kTargets];
  __shared__ bool last_s;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int t0 = blockIdx.x * kTargets;

  // targets t0 + 16 h + g + 8 k of A tile h: words, position, validity
  hamming_tile::RowsA rows[2];
  float2 txy[2][2];
  bool tval[2][2];
  const uint2 zero = make_uint2(0, 0);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint2 w[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int n = t0 + 16 * h + g + 8 * k;
      const bool in = n < a.n_target;
      w[k] = in ? hamming_tile::lane_words(a.t_desc, n, lane) : zero;
      txy[h][k] = in ? a.t_xy[n] : make_float2(0.f, 0.f);
      tval[h][k] = in && a.t_valid[n];
    }
    hamming_tile::expand_rows(rows[h], w[0], w[1]);
  }

  Best st[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h) st[h][0] = st[h][1] = none();

  const int r_lo = blockIdx.y * a.split_rows;
  const int r_hi = min(r_lo + a.split_rows, a.n_query);
  for (int q0 = r_lo + 8 * warp; q0 < r_hi; q0 += 8 * kWarps) {
    // B column g of the tile is row q0 + g; this lane's columns are 2t, 2t + 1
    const uint2 col =
        q0 + g < r_hi ? hamming_tile::lane_words(a.q_desc, q0 + g, lane) : zero;
    int d[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) d[h][0] = d[h][1] = d[h][2] = d[h][3] = 0;
#pragma unroll
    for (int s = 0; s < hamming_tile::kSteps; ++s) {
      const uint32_t b0 = hamming_tile::pm_bits(col.x, s);
      const uint32_t b1 = hamming_tile::pm_bits(col.y, s);
      hamming_tile::mma_s8(d[0], rows[0].r[s], b0, b1);
      hamming_tile::mma_s8(d[1], rows[1].r[s], b0, b1);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = q0 + 2 * t + j;
      const bool in = row < r_hi;
      const float2 qxy = in ? a.q_xy[row] : make_float2(0.f, 0.f);
      const bool qval = in && a.q_valid[row];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          // accumulator c[2k + j]: A row g + 8k, B column 2t + j
          const int dist = (256 - d[h][2 * k + j]) >> 1;
          const bool ok = qval && tval[h][k] && fabsf(qxy.x - txy[h][k].x) <= a.radius &&
                          fabsf(qxy.y - txy[h][k].y) <= a.radius && dist <= a.max_hamming;
          take(st[h][k], in ? (ok ? dist : kBig) : kPad, row);
        }
      }
    }
  }

  // the quad's lanes hold the same targets over other columns
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      st[h][k] = shfl_merge(st[h][k], 1);
      st[h][k] = shfl_merge(st[h][k], 2);
      if (t == 0) warp_s[warp][16 * h + 8 * k + g] = st[h][k];
    }
  }
  __syncthreads();

  if (threadIdx.x < kTargets) {
    Best s = warp_s[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s = merge(s, warp_s[w][threadIdx.x]);
    const int n = t0 + threadIdx.x;
    if (n < a.n_target) {
      if (gridDim.y == 1) {
        write_out(a, n, s);
      } else {
        int32_t* p = a.partials + static_cast<size_t>(blockIdx.y) * 3 * a.n_target;
        p[n] = s.best;
        p[a.n_target + n] = s.row;
        p[2 * a.n_target + n] = s.second;
      }
    }
  }
  if (gridDim.y == 1) return;

  // the last block of the target group merges every split's partial
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last_s = atomicAdd(&a.tickets[blockIdx.x], 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  {
    // thread (target i, part w) merges splits w, w + 4, ...; then the 4 parts
    const int i = threadIdx.x & (kTargets - 1), w = threadIdx.x / kTargets;
    const int n = t0 + i;
    Best s = none();
    if (n < a.n_target) {
      for (int sp = w; sp < gridDim.y; sp += kWarps) {
        const int32_t* p = a.partials + static_cast<size_t>(sp) * 3 * a.n_target;
        s = merge(s, Best{__ldcg(p + n), __ldcg(p + a.n_target + n),
                          __ldcg(p + 2 * a.n_target + n)});
      }
    }
    warp_s[w][i] = s;
  }
  __syncthreads();
  if (threadIdx.x < kTargets) {
    Best s = warp_s[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s = merge(s, warp_s[w][threadIdx.x]);
    if (t0 + static_cast<int>(threadIdx.x) < a.n_target) write_out(a, t0 + threadIdx.x, s);
  }
  if (threadIdx.x == 0) a.tickets[blockIdx.x] = 0;
}

}  // namespace

// The grid's y size (query splits) for n_query rows and n_target targets.
extern "C" int mageslam_local_best_splits(int n_query, int n_target) {
  const int groups = (n_target + kTargets - 1) / kTargets;
  const int by_rows = (n_query + kMinRows - 1) / kMinRows;
  const int by_grid = kMaxBlocks / (groups > 0 ? groups : 1);
  int splits = by_rows < by_grid ? by_rows : by_grid;
  return splits > 1 ? splits : 1;
}

extern "C" int mageslam_local_best(const void* q_desc, const void* q_xy, const void* q_valid,
                                   const void* t_desc, const void* t_xy, const void* t_valid,
                                   void* best, void* best_q, void* second, void* partials,
                                   void* tickets, float radius, int max_hamming, int n_query,
                                   int n_target, int n_splits, void* stream) {
  if (n_query < 1 || n_target < 1 || n_splits < 1 || n_splits > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // rows a split takes, a multiple of the block's 32-row step
  int split_rows = (n_query + n_splits - 1) / n_splits;
  split_rows = (split_rows + 8 * kWarps - 1) / (8 * kWarps) * (8 * kWarps);
  const int splits = (n_query + split_rows - 1) / split_rows;
  const Args args{static_cast<const uint32_t*>(q_desc), static_cast<const float2*>(q_xy),
                  static_cast<const uint8_t*>(q_valid), static_cast<const uint32_t*>(t_desc),
                  static_cast<const float2*>(t_xy), static_cast<const uint8_t*>(t_valid),
                  static_cast<int32_t*>(best), static_cast<int32_t*>(best_q),
                  static_cast<int32_t*>(second), static_cast<int32_t*>(partials),
                  static_cast<uint32_t*>(tickets), radius, max_hamming, n_query, n_target,
                  split_rows};
  const dim3 grid((n_target + kTargets - 1) / kTargets, splits);
  local_best_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}
