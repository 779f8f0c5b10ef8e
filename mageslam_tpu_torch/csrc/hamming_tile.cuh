// The distance tile shared by the port's Hamming kernels (hamming.cu,
// two_way_match.cu): exact Hamming distances between 256-bit rBRIEF
// descriptors on Hopper's int8 tensor cores (sm_90a).
//
// Form: the ±1 int8 product. A descriptor's 256 bits become 256 int8 values,
// +1 for a set bit and -1 for a clear one, so the dot product of two
// descriptors is 256 - 2 * Hamming and Hamming = (256 - dot) / 2, exact in
// int32 (|dot| <= 256). One warp computes a 16 x 8 tile of dot products with
// eight `mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32` (K = 8 x 32 = 256),
// which compiles to IMMA.16832.S8.S8 on sm_90a: the int8 tensor cores,
// 1,979 TOP/s dense on an H100 SXM. This is the product `torch._int_mm`
// computes on the ±1 bits, without the 8x larger unpacked operands in
// device memory.
//
// Why not the b1 form (`mma ... m16n8k256 ... b1.b1.s32.and.popc`, one
// instruction a descriptor, Hamming = popc(a) + popc(b) - 2 popc(a & b)):
// ptxas takes it for sm_90a and emits BMMA.168256.AND.POPC (`.xor.popc`
// becomes two of them; tools/torch_kernel_sass.py), but Hopper publishes no
// rate for it, and it needs each row's popcount beside the product. The
// int8 form has a published rate, needs nothing beside the bits, and is the
// product the library yardstick computes. The choice moves no time here:
// `wgmma` is not needed either, because at the shapes the port calls (at
// most 8,192 x 512 pairs, 2.1 G int8 operations, ~1 us of tensor time) the
// kernels are bound by their output bytes or their launch, not by the
// tensor-core rate that only `wgmma` reaches.
//
// The bits are expanded in registers, never in memory. The K order is the
// tile's own: the Hamming distance does not depend on the order of the 256
// bits as long as both operands use the same one. Lane (group g = lane / 4,
// t = lane % 4) holds, for the mma's A rows g and g + 8 and its B column g,
// descriptor words 2t and 2t + 1 (one 8-byte load each). At k-step s
// (0..7), byte i (0..3) of the low register is bit 8i + s of word 2t and of
// the high register bit 8i + s of word 2t + 1: the mma's A bytes k = 4t + i
// and 16 + 4t + i meet the B bytes with the same k, and over the 8 k-steps
// and 4 lanes of a group every bit of the 8 words is taken once. So a
// k-step's operand register costs a shift, a mask and a multiply-add:
// ((w >> s) & 0x01010101) gives bytes 0 / 1, and 0xFFFFFFFF - 0xFE * x
// turns them into -1 / +1 with no borrow between bytes.
//
// The mma's accumulator layout (PTX ISA, m16n8k32 .s32): register c0 is row
// g, column 2t; c1 row g, column 2t + 1; c2 row g + 8, column 2t; c3 row
// g + 8, column 2t + 1.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace hamming_tile {

constexpr int kWords = 8;      // 256-bit descriptors
constexpr int kSteps = 8;      // k-steps of 32 bits

// Bytes 0 / 1 of bit 8i + s of w, as int8 -1 / +1.
__device__ __forceinline__ uint32_t pm_bits(uint32_t w, int s) {
  return 0xFFFFFFFFu - 0xFEu * ((w >> s) & 0x01010101u);
}

// The A operand of a 16-row tile, expanded for all 8 k-steps: rows g and
// g + 8, words 2t and 2t + 1 (each an 8-byte load of the row).
struct RowsA {
  uint32_t r[kSteps][4];
};

__device__ __forceinline__ void expand_rows(RowsA& a, uint2 row_g, uint2 row_g8) {
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    a.r[s][0] = pm_bits(row_g.x, s);    // row g,     k = 4t + i
    a.r[s][1] = pm_bits(row_g8.x, s);   // row g + 8, k = 4t + i
    a.r[s][2] = pm_bits(row_g.y, s);    // row g,     k = 16 + 4t + i
    a.r[s][3] = pm_bits(row_g8.y, s);   // row g + 8, k = 16 + 4t + i
  }
}

// Not volatile: the mma has no effect beyond its outputs, so the compiler
// may interleave independent accumulator chains.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Hamming distances of the 16 rows of `a` against N 8-column tiles; tile n's
// column g has words 2t, 2t + 1 in `cols[n]`; d[n][0..3] as c0..c3 above.
// The k-steps run outermost, so the N accumulator chains are independent
// and in flight together.
template <int N>
__device__ __forceinline__ void distances(int (&d)[N][4], const RowsA& a,
                                          const uint2 (&cols)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) d[n][0] = d[n][1] = d[n][2] = d[n][3] = 0;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      mma_s8(d[n], a.r[s], pm_bits(cols[n].x, s), pm_bits(cols[n].y, s));
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) d[n][i] = (256 - d[n][i]) >> 1;
  }
}

// Words 2t, 2t + 1 of descriptor `row` of a bank of packed 8-word rows
// (shared or global memory, 8-byte aligned).
__device__ __forceinline__ uint2 lane_words(const uint32_t* bank, int row, int lane) {
  return *reinterpret_cast<const uint2*>(bank + static_cast<size_t>(row) * kWords +
                                         2 * (lane & 3));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = fill ? 16 : 0;   // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

}  // namespace hamming_tile
