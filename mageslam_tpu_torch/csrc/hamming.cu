// All-pairs Hamming distances between two banks of 256-bit rBRIEF
// descriptors, for Hopper (sm_90a).
//
// Replaces the TPU kernel mageslam_tpu/ops/pallas_kernels.py
// `hamming_matrix_pallas` (`_hamming_kernel`, `_popcount32`): per pair, XOR
// of 8 uint32 words, popcount, sum. Output (N, M) int32, values 0..256.
//
// What bounds it on this card: at the tracking path's shapes, (1024, 512)
// and (2048, 512), the kernel reads at most 80 KB of descriptors and writes
// a 2-4 MB int32 matrix; the arithmetic (8 XOR + 8 __popc per output) is
// negligible next to the output write and the launch latency. So the design
// keeps the write coalesced and does nothing clever with the ALUs:
//   - each block stages a tile of 32 A rows and 32 B rows (32 bytes each) in
//     shared memory, padded to 9 words a row so the column reads are free of
//     bank conflicts;
//   - each thread owns one output column and walks 4 rows of the tile, so a
//     warp stores 32 consecutive int32 of one output row (128 bytes);
//   - the kernel masks the ragged edge itself: no host-side padding.
// Removing the write altogether (fusing the consumer's masked best/second-
// best reduction) is the follow-on.
//
// Plain C entry point for ctypes; the caller passes PyTorch's current
// stream. Returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 8;       // 256 bits
constexpr int kTileCols = 32;   // B rows (output columns) per block = blockDim.x
constexpr int kTileRows = 32;   // A rows (output rows) per block
constexpr int kThreadRows = 8;  // blockDim.y

__global__ void __launch_bounds__(kTileCols * kThreadRows)
hamming_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               int32_t* __restrict__ out, int n, int m) {
  __shared__ uint32_t a_s[kTileRows][kWords + 1];
  __shared__ uint32_t b_s[kTileCols][kWords + 1];

  const int row0 = blockIdx.y * kTileRows;
  const int col0 = blockIdx.x * kTileCols;
  // 256 threads stage 32 rows x 8 words of each operand, one word each
  const int t = threadIdx.y * kTileCols + threadIdx.x;
  const int r = t / kWords;
  const int w = t % kWords;
  a_s[r][w] = (row0 + r < n) ? a[static_cast<size_t>(row0 + r) * kWords + w] : 0u;
  b_s[r][w] = (col0 + r < m) ? b[static_cast<size_t>(col0 + r) * kWords + w] : 0u;
  __syncthreads();

  const int col = col0 + threadIdx.x;
  if (col >= m) return;
  uint32_t bw[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) bw[k] = b_s[threadIdx.x][k];

  for (int i = threadIdx.y; i < kTileRows; i += kThreadRows) {
    const int row = row0 + i;
    if (row >= n) break;
    int d = 0;
#pragma unroll
    for (int k = 0; k < kWords; ++k) d += __popc(a_s[i][k] ^ bw[k]);
    out[static_cast<size_t>(row) * m + col] = d;
  }
}

}  // namespace

extern "C" int mageslam_hamming_matrix(const void* a, const void* b, void* out,
                                       int n, int m, void* stream) {
  if (n <= 0 || m <= 0) return 0;
  const dim3 block(kTileCols, kThreadRows);
  const dim3 grid((m + kTileCols - 1) / kTileCols, (n + kTileRows - 1) / kTileRows);
  hamming_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<int32_t*>(out), n, m);
  return static_cast<int>(cudaGetLastError());
}
