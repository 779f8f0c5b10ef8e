// All-pairs Hamming distances between two banks of 256-bit rBRIEF
// descriptors, for Hopper (sm_90a), on the int8 tensor cores.
//
// Replaces the TPU kernel mageslam_tpu/ops/pallas_kernels.py
// `hamming_matrix_pallas` (`_hamming_kernel`, `_popcount32`): per pair, XOR
// of 8 uint32 words, popcount, sum. Output (N, M) int32, values 0..256.
//
// What bounds it on this card: the int32 output. At (8192, 512), the map's
// point bank against a frame's feature slots, it writes 16.8 MB (5.0 us at
// 3.35 TB/s) and reads 0.28 MB. A SIMT design spends 8 __popc an output,
// and Hopper retires 16 __popc per SM per clock: ~9 us of popcounts there,
// above the bound. Here the distances come from the tensor cores (hamming_tile.cuh: the ±1 int8
// product, 256 - 2 * Hamming, IMMA m16n8k32), at about 1.5 integer
// operations an output for the bit expansion, so the write is left as the
// only limit:
//   - a block owns a 64 x 64 output tile, 8 warps of 16 rows x 32 columns,
//     so that (1024, 512) already spreads over 128 blocks; both operands
//     (64 + 64 rows of 32 bytes) are staged with 16-byte cp.async (rows
//     past the edge zero-filled);
//   - a warp expands its 16 A rows once (32 registers) and runs its 4
//     column tiles of 8 against them together: 4 independent chains of 8
//     mma;
//   - each lane trades two distances with its neighbour (one shuffle) so
//     that it holds 4 consecutive columns of a row, and stores them with
//     one 16-byte store: a quad writes 64 contiguous bytes of a row;
//   - the kernel masks the ragged edge itself (rows past N are not
//     written; a row whose width M is not a multiple of 4, or the last
//     columns, are written 4 bytes at a time).
//
// Plain C entry point for ctypes; the caller passes PyTorch's current
// stream. Returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "hamming_tile.cuh"

namespace {

using hamming_tile::kWords;

constexpr int kRows = 64;           // A rows (output rows) per block
constexpr int kCols = 64;           // B rows (output columns) per block
constexpr int kWarpCols = 32;       // columns per warp: 4 tiles of 8
constexpr int kTiles = kWarpCols / 8;
constexpr int kThreads = 32 * (kRows / 16) * (kCols / kWarpCols);   // 256

__device__ __forceinline__ void store4(int32_t* out, int n, int m, int row, int col,
                                       int4 v) {
  if (row >= n) return;
  int32_t* p = out + static_cast<size_t>(row) * m + col;
  if ((m & 3) == 0 && col + 3 < m) {
    *reinterpret_cast<int4*>(p) = v;
    return;
  }
  if (col < m) p[0] = v.x;
  if (col + 1 < m) p[1] = v.y;
  if (col + 2 < m) p[2] = v.z;
  if (col + 3 < m) p[3] = v.w;
}

__global__ void __launch_bounds__(kThreads)
hamming_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               int32_t* __restrict__ out, int n, int m) {
  __shared__ __align__(16) uint32_t a_s[kRows * kWords];
  __shared__ __align__(16) uint32_t b_s[kCols * kWords];

  const int row0 = blockIdx.y * kRows;
  const int col0 = blockIdx.x * kCols;
  // 16-byte chunks: 2 a descriptor; (64 + 64) * 2 = 256, one a thread
  for (int c = threadIdx.x; c < 2 * (kRows + kCols); c += kThreads) {
    const bool is_a = c < 2 * kRows;
    const int r = (is_a ? c : c - 2 * kRows) >> 1;
    const int limit = is_a ? n - row0 : m - col0;
    const uint32_t* src = is_a ? a + static_cast<size_t>(row0) * kWords
                               : b + static_cast<size_t>(col0) * kWords;
    uint32_t* dst = is_a ? a_s : b_s;
    const int rc = min(r, limit - 1);       // a valid address even when not read
    hamming_tile::cp_async16(dst + r * kWords + (c & 1) * 4,
                             src + static_cast<size_t>(rc) * kWords + (c & 1) * 4, r < limit);
  }
  hamming_tile::cp_async_commit();
  hamming_tile::cp_async_wait<0>();
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp >> 1) * 16;          // the warp's first row in the tile
  const int wc = (warp & 1) * kWarpCols;    // and its first column

  hamming_tile::RowsA rows;
  hamming_tile::expand_rows(rows, hamming_tile::lane_words(a_s, wr + g, lane),
                            hamming_tile::lane_words(a_s, wr + g + 8, lane));

  uint2 cols[kTiles];
#pragma unroll
  for (int j = 0; j < kTiles; ++j) cols[j] = hamming_tile::lane_words(b_s, wc + 8 * j + g, lane);
  int d[kTiles][4];
  hamming_tile::distances(d, rows, cols);

  const bool odd = t & 1;
#pragma unroll
  for (int j = 0; j < kTiles; j += 2) {   // two column tiles: 16 columns
    // even t keeps tile j's columns 2t, 2t + 1 and takes 2t + 2, 2t + 3 from
    // lane t + 1; odd t gives those away and takes tile j + 1's columns
    // 2t - 2, 2t - 1 from lane t - 1: each lane then holds 4 consecutive
    // columns of rows g and g + 8
    const int* d0 = d[j];
    const int* d1 = d[j + 1];
    const int s0 = odd ? d0[0] : d1[0], s1 = odd ? d0[1] : d1[1];
    const int s2 = odd ? d0[2] : d1[2], s3 = odd ? d0[3] : d1[3];
    const int r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
    const int r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
    const int r2 = __shfl_xor_sync(0xffffffffu, s2, 1);
    const int r3 = __shfl_xor_sync(0xffffffffu, s3, 1);
    const int4 top = odd ? make_int4(r0, r1, d1[0], d1[1]) : make_int4(d0[0], d0[1], r0, r1);
    const int4 bottom = odd ? make_int4(r2, r3, d1[2], d1[3]) : make_int4(d0[2], d0[3], r2, r3);
    const int col = col0 + wc + 8 * j + (odd ? 8 + 2 * (t - 1) : 2 * t);
    store4(out, n, m, row0 + wr + g, col, top);
    store4(out, n, m, row0 + wr + g + 8, col, bottom);
  }
}

}  // namespace

extern "C" int mageslam_hamming_matrix(const void* a, const void* b, void* out,
                                       int n, int m, void* stream) {
  if (n <= 0 || m <= 0) return 0;
  const dim3 grid((m + kCols - 1) / kCols, (n + kRows - 1) / kRows);
  hamming_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<int32_t*>(out), n, m);
  return static_cast<int>(cudaGetLastError());
}
