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
// Design: two kernels behind one C entry point, on the caller's stream.
//   1. two_way_scan. The grid covers both directions and the batch:
//      blockIdx.y is the batch entry; the first ceil(N / 8) blocks of a
//      batch entry scan rows of A against B, the others rows of B against A
//      (the distances are computed twice and stored never). One warp per
//      query row, eight rows a block. The query's 8 words sit in registers;
//      the other side is staged in shared memory, kTile descriptors at a
//      time, with 16-byte cp.async into two uint4 planes (a warp's 16-byte
//      reads are free of bank conflicts) and its validity bytes beside
//      them: 16,896 bytes of static shared memory. Lane l takes targets l,
//      l + 32, ... in index order, four in flight, keeps (best, idx, second)
//      in registers, and the 32 lanes merge with __shfl_xor_sync: the lower
//      distance wins, on equal distances the lower index, and second =
//      min(winner's second, loser's best). Lane 0 writes one 16-byte record
//      (idx, best, second) per query into a (B, N + M) scratch buffer. A
//      block whose eight rows are all invalid stages nothing.
//   2. two_way_gate. One thread per row of A: reads its record and the
//      record of its best column, applies both gates and the mutual check,
//      writes (match_b_idx, dist).
//   A kernel boundary, not a grid-wide counter, orders the scratch writes
//   before the gate's reads: that is exact by construction, and the second
//   launch costs less than the fence-and-counter would save.
//
// What bounds it: bytes. It reads B * (N + M) descriptors of 32 bytes and
// validity bytes once and writes 8 bytes per row of A: about 0.18 MB at
// B = 5, N = M = 512, 0.05 us at 3.35 TB/s. The 2 * B * N * M pairs cost 8
// XOR + 8 __popc each, 2.6 M pairs or 42 M integer operations, far under a
// microsecond on 132 SMs. So the two launches, the dependent global round
// trips (query, staging, scratch, output) and one warp's serial scan of the
// other side set its time. That is why __popc was kept over the b1
// tensor-core form (mma.sync m16n8k256 .and.popc): the product is not what
// takes the time, and the row and column reductions with their tie rules
// would still run per pair on the CUDA cores.
//
// Plain C entry point for ctypes; the caller passes PyTorch's current
// stream. Returns cudaGetLastError() after the launches.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 8;             // 256-bit descriptors
constexpr int kBig = 1 << 20;         // a non-candidate's distance
constexpr int kWarps = 8;             // query rows (one a warp) per block
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 512;            // descriptors staged per pass
constexpr int kUnroll = 4;            // targets in flight per lane
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
two_way_scan_kernel(const TwoWayArgs args) {
  __shared__ uint4 desc_s[2][kTile];   // words 0-3 and 4-7 of each target
  __shared__ uint8_t valid_s[kTile];

  const int lane = threadIdx.x & 31;
  const int batch = blockIdx.y;
  const int blocks_a = (args.n_a + kWarps - 1) / kWarps;
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
  const uint4* t_desc = reinterpret_cast<const uint4*>(forward ? b : a);
  const uint8_t* t_valid = forward ? vb : va;
  const int n_target = forward ? args.n_b : args.n_a;

  const int q = row_block * kWarps + (threadIdx.x >> 5);
  const int qc = min(q, n_query - 1);
  uint32_t qd[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) qd[k] = q_desc[static_cast<size_t>(qc) * kWords + k];
  const bool qv = q < n_query && q_valid[qc] != 0;

  int best = kBig, idx = 0, second = kBig;

  const bool block_live = __syncthreads_or(qv);
  for (int tile0 = 0; block_live && tile0 < n_target; tile0 += kTile) {
    const int n = min(kTile, n_target - tile0);
    for (int c = threadIdx.x; c < 2 * n; c += kThreads) {
      cp_async16(&desc_s[c & 1][c >> 1], t_desc + 2 * static_cast<size_t>(tile0) + c);
    }
    for (int j = threadIdx.x; j < n; j += kThreads) valid_s[j] = t_valid[tile0 + j];
    cp_async_wait_all();
    __syncthreads();

    // lane l takes targets l, l + 32, ... in index order, kUnroll at a time
    for (int base = 0; qv && base < n; base += 32 * kUnroll) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = base + 32 * u + lane;
        const int jc = min(j, n - 1);
        const uint4 lo = desc_s[0][jc];
        const uint4 hi = desc_s[1][jc];
        const int pop = __popc(lo.x ^ qd[0]) + __popc(lo.y ^ qd[1]) + __popc(lo.z ^ qd[2]) +
                        __popc(lo.w ^ qd[3]) + __popc(hi.x ^ qd[4]) + __popc(hi.y ^ qd[5]) +
                        __popc(hi.z ^ qd[6]) + __popc(hi.w ^ qd[7]);
        const bool cand = (j < n) & (valid_s[jc] != 0) & (pop <= args.max_hamming);
        const int d = cand ? pop : kBig;
        // this lane visits its targets in index order: a later equal
        // distance becomes the second, never the best. A target past the
        // end (j >= n) reads BIG and changes nothing.
        const bool better = d < best;
        const int seen = min(second, d);
        second = better ? best : seen;
        idx = better ? tile0 + j : idx;
        best = better ? d : best;
      }
    }
    __syncthreads();   // the tile is read before the next one lands
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
    const int os = __shfl_xor_sync(0xffffffffu, second, off);
    const bool other = ob < best || (ob == best && oi < idx);
    const int loser_best = other ? best : ob;
    const int winner_second = other ? os : second;
    best = other ? ob : best;
    idx = other ? oi : idx;
    second = min(winner_second, loser_best);
  }

  if (lane == 0 && q < n_query) {
    const size_t record = static_cast<size_t>(batch) * (args.n_a + args.n_b) +
                          (forward ? 0 : args.n_a) + q;
    args.scratch[record] = make_int4(idx, best, second, 0);
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
  const int row_blocks = (n_a + kWarps - 1) / kWarps + (n_b + kWarps - 1) / kWarps;
  two_way_scan_kernel<<<dim3(row_blocks, n_batch), kThreads, 0, st>>>(args);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(n_batch) * n_a;
  const unsigned gate_blocks = static_cast<unsigned>((rows + kGateThreads - 1) / kGateThreads);
  two_way_gate_kernel<<<gate_blocks, kGateThreads, 0, st>>>(args, n_batch);
  return static_cast<int>(cudaGetLastError());
}
