// Guided radius match, fused: per query and stage, the best and second-best
// Hamming distance over the targets inside the stage's search box, gated,
// for Hopper (sm_90a). No (Q, T) matrix is ever written.
//
// Replaces, on the tracking path, the TPU kernel
// mageslam_tpu/ops/pallas_kernels.py:57 `hamming_matrix_pallas` together
// with the epilogue that consumed its (Q, T) output:
//   - the JAX package's radius_match, mageslam_tpu/ops/matching.py:136-148
//     (port: mageslam_tpu_torch/ops/matching.py, `radius_match_stages_plain`);
//   - the guided cascade's three stages over one shared distance matrix,
//     mageslam_tpu/tracking/pose_estimation.py:151-166
//     (port: mageslam_tpu_torch/tracking/pose_estimation.py, one S = 3 call).
//
// Semantics, equal bit for bit to the plain version:
//   distance   popcount of the XOR of 8 words read as uint32;
//   candidate  |qx - tx| <= r && |qy - ty| <= r (f32 subtract, abs, compare:
//              nothing to contract into an FMA), |qo - to| <= octave_tol
//              (int32), query and target valid; a non-candidate reads BIG;
//   best       the first minimum in index order (argmin: index 0 when the
//              row has no candidate);
//   second     the minimum of the row with only the best index masked, so a
//              tie at the best distance gives second == best;
//   gate       T > 0 && best <= max_hamming
//              && (second >= BIG || second - best > min_diff),
//              else (idx, dist) = (-1, -1).
//
// Design:
//   - one warp per query row, eight rows per block, in query order. The
//     query's 8 words and its S (x, y, r) sit in registers. The callers put
//     their valid rows first (the cascade's and track-local-map's candidate
//     compaction), so a block whose rows are all invalid skips the staging
//     and the scan (__syncthreads_or) and only writes its rows' result for
//     a row without candidates;
//   - a live block stages the target bank in shared memory, kTile targets
//     at a time: descriptors with 16-byte cp.async, split into two uint4
//     planes so a warp's 16-byte reads are free of bank conflicts; x, y and
//     octave with 8- and 4-byte cp.async into one 16-byte record per target,
//     whose fourth word holds the valid byte (a plain load). 24,576 bytes of
//     static shared memory; a larger bank loops over tiles;
//   - lane l takes targets l, l + 32, ... in index order, four at a time:
//     the validity, octave and S box tests are branch-free, one warp vote
//     skips the distances of a group without any candidate, and each lane
//     keeps a running (best, idx, second) per stage in registers;
//   - the 32 lanes merge with __shfl_xor_sync: the lower distance wins, and
//     on equal distances the lower index; second = min(winner's second,
//     loser's best). Lane 0 applies the gate and writes (S, Q) idx and dist.
//   All S stages share each computed distance: one launch for the cascade.
//
// What bounds it: it reads the inputs once (about 0.1-0.2 MB at the
// tracking path's shapes, 0.04 us at 3.35 TB/s) and writes 8 bytes per
// query and stage; the per-pair work is the candidate test plus, for the
// candidate pairs only (about 1,700 of the cascade's 0.5 M pairs on the
// tracking path), 8 XOR + 8 __popc. So the launch, the dependent global
// round trips (query, staging, output) and one warp's serial scan of the
// bank set its time, not bytes or operations. That is why __popc was kept
// over the b1 tensor-core form (mma.sync m16n8k256 .and.popc): the tensor
// cores would compute every pair, the masking epilogue would still run per
// pair on the CUDA cores, and the distance work they would speed up is
// already cut to the candidate pairs.
// ptxas -v (sm_90a, CUDA 12.8): 51 / 58 / 62 / 74 registers for
// S = 1 / 2 / 3 / 4, 24,576 bytes of shared memory, no stack, no spills
// (chip_smoke.py's build phase prints it on every run).
//
// Plain C entry point for ctypes; the caller passes PyTorch's current
// stream. Returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 8;             // 256-bit descriptors
constexpr int kBig = 1 << 20;         // a non-candidate's distance
constexpr int kWarps = 8;             // query rows (one a warp) per block
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 512;            // targets staged per pass
constexpr int kUnroll = 4;            // targets in flight per lane
constexpr int kMaxStages = 4;

struct RadiusMatchArgs {
  const uint32_t* q_desc;   // (Q, 8)
  const int32_t* q_octave;  // (Q,)
  const uint8_t* q_valid;   // (Q,) bool
  const float* q_xy;        // (S, Q, 2)
  const float* radius;      // (S, Q)
  const uint4* t_desc;      // (T, 8) as (T, 2) uint4, 16-byte aligned
  const float2* t_xy;       // (T, 2), 8-byte aligned
  const int32_t* t_octave;  // (T,)
  const uint8_t* t_valid;   // (T,) bool
  int32_t* out_idx;         // (S, Q)
  int32_t* out_dist;        // (S, Q)
  int n_query, n_target, octave_tol, max_hamming, min_diff;
};

template <int kBytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem), "n"(kBytes));
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// |a - b| <= tol in int32 with wrap-around, as jnp.abs / torch.abs give it
__device__ __forceinline__ bool octave_ok(int a, int b, int tol) {
  const unsigned diff = static_cast<unsigned>(a) - static_cast<unsigned>(b);
  const unsigned mag = static_cast<int>(diff) < 0 ? 0u - diff : diff;
  return static_cast<int>(mag) <= tol;
}

template <int S>
__global__ void __launch_bounds__(kThreads)
radius_match_kernel(const RadiusMatchArgs args) {
  __shared__ uint4 desc_s[2][kTile];   // words 0-3 and 4-7 of each target
  __shared__ float4 meta_s[kTile];     // x, y, octave bits, valid (0 / 1) bits

  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int qc = min(q, args.n_query - 1);

  // the warp's query, loaded unconditionally (clamped) so that the loads
  // overlap each other and the first tile's copies
  uint32_t qd[kWords];
  float qx[S], qy[S], qr[S];
#pragma unroll
  for (int k = 0; k < kWords; ++k) qd[k] = args.q_desc[static_cast<size_t>(qc) * kWords + k];
  const int qo = args.q_octave[qc];
  const bool qv = q < args.n_query && args.q_valid[qc] != 0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const size_t sq = static_cast<size_t>(s) * args.n_query + qc;
    qx[s] = args.q_xy[2 * sq];
    qy[s] = args.q_xy[2 * sq + 1];
    qr[s] = args.radius[sq];
  }

  int best[S], idx[S], second[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    best[s] = kBig;
    idx[s] = 0;
    second[s] = kBig;
  }

  // a block without a valid row stages nothing (the callers put their
  // valid rows first, so on the tracking path most blocks stop here)
  const bool block_live = __syncthreads_or(qv);
  for (int tile0 = 0; block_live && tile0 < args.n_target; tile0 += kTile) {
    const int n = min(kTile, args.n_target - tile0);
    for (int c = threadIdx.x; c < 2 * n; c += kThreads) {
      cp_async<16>(&desc_s[c & 1][c >> 1], args.t_desc + 2 * static_cast<size_t>(tile0) + c);
    }
    for (int j = threadIdx.x; j < n; j += kThreads) {
      cp_async<8>(&meta_s[j], args.t_xy + tile0 + j);
      cp_async<4>(&meta_s[j].z, args.t_octave + tile0 + j);
      meta_s[j].w = __int_as_float(args.t_valid[tile0 + j] != 0);
    }
    cp_async_wait_all();
    __syncthreads();

    // lane l takes targets l, l + 32, ... in index order, kUnroll at a
    // time; the candidate tests are branch-free, and the distances are
    // computed only where some lane of the warp holds a candidate
    for (int base = 0; qv && base < n; base += 32 * kUnroll) {
      float4 m[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) m[u] = meta_s[min(base + 32 * u + lane, n - 1)];
      bool cand[kUnroll][S];
      bool any = false;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool ok = (base + 32 * u + lane < n) & (__float_as_int(m[u].w) != 0) &
                        octave_ok(qo, __float_as_int(m[u].z), args.octave_tol);
#pragma unroll
        for (int s = 0; s < S; ++s) {
          cand[u][s] = ok & (fabsf(__fsub_rn(qx[s], m[u].x)) <= qr[s]) &
                       (fabsf(__fsub_rn(qy[s], m[u].y)) <= qr[s]);
          any |= cand[u][s];
        }
      }
      if (!__any_sync(0xffffffffu, any)) continue;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = min(base + 32 * u + lane, n - 1);
        const uint4 lo = desc_s[0][j];
        const uint4 hi = desc_s[1][j];
        const int d = __popc(lo.x ^ qd[0]) + __popc(lo.y ^ qd[1]) + __popc(lo.z ^ qd[2]) +
                      __popc(lo.w ^ qd[3]) + __popc(hi.x ^ qd[4]) + __popc(hi.y ^ qd[5]) +
                      __popc(hi.z ^ qd[6]) + __popc(hi.w ^ qd[7]);
        const int t = tile0 + base + 32 * u + lane;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          // this lane visits its targets in index order: a later equal
          // distance becomes the second, never the best
          const bool better = cand[u][s] & (d < best[s]);
          const int seen = cand[u][s] ? min(second[s], d) : second[s];
          second[s] = better ? best[s] : seen;
          best[s] = better ? d : best[s];
          idx[s] = better ? t : idx[s];
        }
      }
    }
    __syncthreads();   // the tile is read before the next one lands
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int ob = __shfl_xor_sync(0xffffffffu, best[s], off);
      const int oi = __shfl_xor_sync(0xffffffffu, idx[s], off);
      const int os = __shfl_xor_sync(0xffffffffu, second[s], off);
      const bool other = ob < best[s] || (ob == best[s] && oi < idx[s]);
      const int loser_best = other ? best[s] : ob;
      const int winner_second = other ? os : second[s];
      best[s] = other ? ob : best[s];
      idx[s] = other ? oi : idx[s];
      second[s] = min(winner_second, loser_best);
    }
  }

  if (lane == 0 && q < args.n_query) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const bool ok = args.n_target > 0 && best[s] <= args.max_hamming &&
                      (second[s] >= kBig || second[s] - best[s] > args.min_diff);
      const size_t sq = static_cast<size_t>(s) * args.n_query + q;
      args.out_idx[sq] = ok ? idx[s] : -1;
      args.out_dist[sq] = ok ? best[s] : -1;
    }
  }
}

}  // namespace

extern "C" int mageslam_radius_match(
    const void* q_desc, const void* q_octave, const void* q_valid, const void* q_xy,
    const void* radius, const void* t_desc, const void* t_xy, const void* t_octave,
    const void* t_valid, void* out_idx, void* out_dist, int n_stages, int n_query,
    int n_target, int octave_tol, int max_hamming, int min_diff, void* stream) {
  if (n_stages < 1 || n_stages > kMaxStages || n_query < 0 || n_target < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_query == 0) return 0;
  const RadiusMatchArgs args{
      static_cast<const uint32_t*>(q_desc), static_cast<const int32_t*>(q_octave),
      static_cast<const uint8_t*>(q_valid), static_cast<const float*>(q_xy),
      static_cast<const float*>(radius), static_cast<const uint4*>(t_desc),
      static_cast<const float2*>(t_xy), static_cast<const int32_t*>(t_octave),
      static_cast<const uint8_t*>(t_valid), static_cast<int32_t*>(out_idx),
      static_cast<int32_t*>(out_dist), n_query, n_target, octave_tol, max_hamming,
      min_diff};
  const dim3 grid((n_query + kWarps - 1) / kWarps);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n_stages) {
    case 1: radius_match_kernel<1><<<grid, kThreads, 0, st>>>(args); break;
    case 2: radius_match_kernel<2><<<grid, kThreads, 0, st>>>(args); break;
    case 3: radius_match_kernel<3><<<grid, kThreads, 0, st>>>(args); break;
    default: radius_match_kernel<4><<<grid, kThreads, 0, st>>>(args); break;
  }
  return static_cast<int>(cudaGetLastError());
}
