// Guided radius match, fused with the target dedup: per query and stage,
// the best and second-best Hamming distance over the targets inside the
// stage's search box, gated, and then, across all query rows of the call,
// only the strictly best claim on each target kept, for Hopper (sm_90a).
// One launch a call; no (Q, T) matrix is ever written.
//
// Replaces, on the tracking and mapping paths, the TPU kernel
// mageslam_tpu/ops/pallas_kernels.py:57 `hamming_matrix_pallas` together
// with what consumed its (Q, T) output:
//   - the JAX package's radius_match, mageslam_tpu/ops/matching.py:109
//     (port: mageslam_tpu_torch/ops/matching.py, `radius_match_stages_plain`);
//   - its dedup_by_target, mageslam_tpu/ops/matching.py:151 (port:
//     `dedup_by_target`), which every caller runs on each stage's result;
//   - the guided cascade's three stages over one shared distance matrix,
//     mageslam_tpu/tracking/pose_estimation.py:151-166 (port:
//     mageslam_tpu_torch/tracking/pose_estimation.py, one S = 3 call).
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
//              else (idx, dist) = (-1, -1);
//   dedup      per stage, a claim (idx >= 0) on key
//              idx + (q / group) * group (relocalization stacks candidates'
//              rows in groups whose claims never meet; group = Q otherwise)
//              is kept when its dist is the least of the claims on the key
//              and no other claim has that least dist, else (-1, -1). The
//              reference's table has Q + 2 entries: a claim on a key past
//              it adds to no entry and reads the last one (its dropped
//              scatter and clamped gather), and so does the kernel.
//
// What bounds it: the launch and a chain of dependent round trips, not
// bytes or operations. It reads the inputs once (about 0.1-0.2 MB at the
// tracking path's shapes, 0.04 us at 3.35 TB/s) and writes 8 bytes per
// query and stage; the per-pair work is the candidate test plus, for the
// candidate pairs only (about 1,700 of the cascade's 0.5 M pairs), 8 XOR +
// 8 __popc. Before this design each call was this kernel's launch plus
// about 12 eager launches of the dedup for each stage; the kernel alone
// chained the query load, then per-thread cp.async staging of the bank,
// then the scan, then the output. Design:
//   - one warp per query row, eight rows per block, in query order. Thread 0
//     reads the block's 8 validity bytes and, when a row is valid, issues
//     the first target tile as bulk copies (cp.async.bulk, the TMA's linear
//     form, completing on an mbarrier) before the warps load their queries,
//     so the two round trips overlap. The callers put their valid rows
//     first, so most blocks of a call stage nothing and only write (-1, -1);
//   - a tile is kTile targets: descriptors (32 bytes each), x y, octave and
//     validity planes, 22.5 KB of static shared memory; a bank of more
//     targets loops over tiles. A plane whose address is not 16-byte
//     aligned, and the last < 16 bytes of each, are loaded by the threads;
//   - lane l takes targets l, l + 32, ... in index order, four at a time:
//     the validity, octave and S box tests are branch-free, one warp vote
//     skips the distances of a group without any candidate, and each lane
//     keeps a running (best, idx, second) per stage in registers; the 32
//     lanes merge with __shfl_xor_sync (lower distance, then lower index;
//     second = min(winner's second, loser's best)); lane 0 gates and writes.
//     All S stages share each computed distance;
//   - the dedup reduces over the whole call. A block appends its claims
//     (stage, row, key, dist) to a claim list (one atomic a block) and puts
//     each claim's dist into its stage's table of Q + 2 entries with an
//     integer atomicMax of BIG - dist (0 reads as BIG: the table needs no
//     fill). Then a ticket (__threadfence where the block claimed, and one
//     64-bit atomicAdd that also returns the call's claim total): the last
//     block to finish, unless nothing was claimed, walks the claim list
//     twice, counting the claims at each key's least dist (atomicAdd) and
//     then resetting the claims that lose, four claims a thread with their
//     loads in flight together, and leaves the entries it touched and the
//     count zero for the next call. Integer atomics make it exact in any
//     order. The other design, the whole call in one thread-block cluster with the
//     tables in distributed shared memory, was not taken: the calls span
//     128 to 1,024 blocks (Q = 1,024 to 8,192 at 8 rows a block) and a
//     cluster holds at most 16, so it would put the scan of 64 or more rows
//     on each of 16 SMs; the ticket keeps the grid as wide as the call.
// Measured (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py, PERF.md): the
// cascade's call 10.5-11.6 us a launch, 5.4-5.9 of it the match (6.2-6.5
// before the bulk-copy staging); the dedup adds ~0.5 us where nothing is
// claimed (the ticket alone; ~1.9 us before its claim total rode on the
// ticket) and ~5 us with the cascade's ~1,400 claims; the composite it
// replaces took 144 launches and ~239 us of device time.
//
// Plain C entry point for ctypes; the caller passes PyTorch's current
// stream and the dedup's scratch, which it keeps for that stream (zero on
// entry; the kernel leaves it zero). Returns cudaGetLastError() after the
// launch.

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
  int32_t* table;           // (S, 2, Q + 2) dedup scratch: BIG - least dist, count
  int4* claims;             // (S * Q,) dedup scratch: (stage * Q + row, key, dist, -)
  unsigned long long* state;   // dedup scratch: claims listed (low 32 bits), tickets (high)
  int n_query, n_target, octave_tol, max_hamming, min_diff, group;   // 1 <= group <= Q
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void bulk_copy(void* smem, const void* gmem, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(smem)), "l"(gmem), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// The bytes of a plane of `n` elements of `size` bytes at `src` that go by
// bulk copy: all but the last < 16, or none where `src` is not 16-byte
// aligned.
__device__ __forceinline__ unsigned bulk_bytes(const void* src, int n, int size) {
  return (reinterpret_cast<uintptr_t>(src) & 15) ? 0u : (static_cast<unsigned>(n * size) & ~15u);
}

struct Tile {
  uint4 desc[2 * kTile];    // 32 bytes a target
  float2 xy[kTile];
  int32_t octave[kTile];
  uint8_t valid[kTile];
};

// Thread 0: the bulk part of tile `tile0` (n targets) on its way.
__device__ __forceinline__ void issue_tile(Tile& s, const RadiusMatchArgs& a, int tile0, int n,
                                           uint64_t* bar) {
  const void* src[4] = {a.t_desc + 2 * static_cast<size_t>(tile0), a.t_xy + tile0,
                        a.t_octave + tile0, a.t_valid + tile0};
  void* dst[4] = {s.desc, s.xy, s.octave, s.valid};
  const int size[4] = {32, 8, 4, 1};
  unsigned bytes[4], total = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) total += bytes[i] = bulk_bytes(src[i], n, size[i]);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // after generic writes
  mbar_expect(bar, total);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (bytes[i]) bulk_copy(dst[i], src[i], bytes[i], bar);
  }
}

// All threads: the elements of tile `tile0` that the bulk copies leave out.
__device__ __forceinline__ void load_tile_rest(Tile& s, const RadiusMatchArgs& a, int tile0,
                                               int n) {
  const int d0 = bulk_bytes(a.t_desc + 2 * static_cast<size_t>(tile0), n, 32) / 16;
  for (int c = d0 + threadIdx.x; c < 2 * n; c += kThreads) {
    s.desc[c] = a.t_desc[2 * static_cast<size_t>(tile0) + c];
  }
  const int x0 = bulk_bytes(a.t_xy + tile0, n, 8) / 8;
  for (int j = x0 + threadIdx.x; j < n; j += kThreads) s.xy[j] = a.t_xy[tile0 + j];
  const int o0 = bulk_bytes(a.t_octave + tile0, n, 4) / 4;
  for (int j = o0 + threadIdx.x; j < n; j += kThreads) s.octave[j] = a.t_octave[tile0 + j];
  const int v0 = bulk_bytes(a.t_valid + tile0, n, 1);
  for (int j = v0 + threadIdx.x; j < n; j += kThreads) s.valid[j] = a.t_valid[tile0 + j];
}

// |a - b| <= tol in int32 with wrap-around, as jnp.abs / torch.abs give it
__device__ __forceinline__ bool octave_ok(int a, int b, int tol) {
  const unsigned diff = static_cast<unsigned>(a) - static_cast<unsigned>(b);
  const unsigned mag = static_cast<int>(diff) < 0 ? 0u - diff : diff;
  return static_cast<int>(mag) <= tol;
}

// The last block: the dedup over the whole call's claims, kBatch claims a
// thread at a time with their loads issued together (a handful of
// dependent round trips a pass, not a few a claim).
constexpr int kBatch = 4;

struct Claims {
  int4 c[kBatch];       // (stage * Q + row, key, dist, -)
  bool has[kBatch];
};

__device__ __forceinline__ void load_claims(Claims& b, const RadiusMatchArgs& a, int base,
                                            int n) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int i = base + u * kThreads + threadIdx.x;
    b.has[u] = i < n;
    b.c[u] = b.has[u] ? __ldcg(&a.claims[i]) : make_int4(0, 0, 0, 0);
  }
}

__device__ void dedup_claims(const RadiusMatchArgs& a, int n) {
  const int width = a.n_query + 2;   // the reference's table
  for (int pass = 0; pass < 3; ++pass) {
    for (int base = 0; base < n; base += kBatch * kThreads) {
      Claims b;
      load_claims(b, a, base, n);
      int least[kBatch], count[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        int32_t* t = a.table + static_cast<size_t>(b.c[u].x / a.n_query) * 2 * width;
        const int read = min(b.c[u].y, width - 1);    // the clamped gather
        least[u] = b.has[u] && pass < 2 ? __ldcg(&t[read]) : 0;
        count[u] = b.has[u] && pass == 1 ? __ldcg(&t[width + read]) : 0;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (!b.has[u]) continue;
        int32_t* t = a.table + static_cast<size_t>(b.c[u].x / a.n_query) * 2 * width;
        const bool in_table = b.c[u].y < width;     // the dropped scatter
        const bool is_best = least[u] == kBig - b.c[u].z;
        if (pass == 0) {
          if (is_best && in_table) atomicAdd(&t[width + b.c[u].y], 1);
        } else if (pass == 1) {
          if (!(is_best && count[u] == 1)) {
            a.out_idx[b.c[u].x] = -1;
            a.out_dist[b.c[u].x] = -1;
          }
        } else if (in_table) {                      // leave the scratch zero
          t[b.c[u].y] = t[width + b.c[u].y] = 0;
        }
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) *a.state = 0;
}

template <int S>
__global__ void __launch_bounds__(kThreads)
radius_match_kernel(const RadiusMatchArgs args) {
  __shared__ __align__(16) Tile tile_s;
  __shared__ __align__(8) uint64_t bar;
  __shared__ int live_s, claims_s, claim_base_s, total_s;
  __shared__ bool last_s;

  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kWarps;
  const int q = row0 + (threadIdx.x >> 5);
  const int qc = min(q, args.n_query - 1);

  // thread 0: is any row of the block valid? then the first tile's bulk
  // copies go out before the queries are loaded
  if (threadIdx.x == 0) {
    int live = 0;
    for (int r = row0; r < min(row0 + kWarps, args.n_query); ++r) live |= args.q_valid[r];
    live_s = live && args.n_target > 0;
    claims_s = 0;
    if (live_s) {
      mbar_init(&bar);
      issue_tile(tile_s, args, 0, min(kTile, args.n_target), &bar);
    }
  }

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

  __syncthreads();   // live_s, and the mbarrier's init
  const bool block_live = live_s != 0;
  for (int tile0 = 0, k = 0; block_live && tile0 < args.n_target; tile0 += kTile, ++k) {
    const int n = min(kTile, args.n_target - tile0);
    if (k > 0 && threadIdx.x == 0) issue_tile(tile_s, args, tile0, n, &bar);
    load_tile_rest(tile_s, args, tile0, n);
    mbar_wait(&bar, k & 1);
    __syncthreads();

    // lane l takes targets l, l + 32, ... in index order, kUnroll at a
    // time; the candidate tests are branch-free, and the distances are
    // computed only where some lane of the warp holds a candidate
    for (int base = 0; qv && base < n; base += 32 * kUnroll) {
      int jj[kUnroll];
      bool cand[kUnroll][S];
      bool any = false;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = min(base + 32 * u + lane, n - 1);
        jj[u] = j;
        const float2 xy = tile_s.xy[j];
        const bool ok = (base + 32 * u + lane < n) & (tile_s.valid[j] != 0) &
                        octave_ok(qo, tile_s.octave[j], args.octave_tol);
#pragma unroll
        for (int s = 0; s < S; ++s) {
          cand[u][s] = ok & (fabsf(__fsub_rn(qx[s], xy.x)) <= qr[s]) &
                       (fabsf(__fsub_rn(qy[s], xy.y)) <= qr[s]);
          any |= cand[u][s];
        }
      }
      if (!__any_sync(0xffffffffu, any)) continue;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const uint4 lo = tile_s.desc[2 * jj[u]];
        const uint4 hi = tile_s.desc[2 * jj[u] + 1];
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

  int mine = 0, slot = 0;   // this row's claims, and where the first goes
  if (lane == 0 && q < args.n_query) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const bool ok = args.n_target > 0 && best[s] <= args.max_hamming &&
                      (second[s] >= kBig || second[s] - best[s] > args.min_diff);
      const size_t sq = static_cast<size_t>(s) * args.n_query + q;
      args.out_idx[sq] = ok ? idx[s] : -1;
      args.out_dist[sq] = ok ? best[s] : -1;
      idx[s] = ok ? idx[s] : -1;
      mine += ok;
    }
    if (mine) slot = atomicAdd(&claims_s, mine);
  }

  // the dedup: list the block's claims, fold them into the tables, ticket.
  // One 64-bit word counts the claims (low half) and the tickets (high
  // half): a block reserves its claims' slots before its ticket, so the
  // last ticket reads the call's claim total with it.
  __syncthreads();
  if (threadIdx.x == 0 && claims_s) {
    claim_base_s = static_cast<int>(atomicAdd(args.state, static_cast<unsigned long long>(
                                                   claims_s)) & 0xffffffffu);
  }
  __syncthreads();
  if (lane == 0 && mine) {
    const int width = args.n_query + 2;
    const int key0 = (q / args.group) * args.group;
    slot += claim_base_s;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (idx[s] < 0) continue;
      const int key = idx[s] + key0;
      args.claims[slot++] = make_int4(s * args.n_query + q, key, best[s], 0);
      if (key < width) atomicMax(&args.table[static_cast<size_t>(s) * 2 * width + key],
                                 kBig - best[s]);
    }
  }
  // a block without claims wrote nothing the last block reads: no fence
  if (claims_s) __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned long long old = atomicAdd(args.state, 1ull << 32);
    last_s = (old >> 32) == gridDim.x - 1;
    total_s = static_cast<int>(old & 0xffffffffu);
  }
  __syncthreads();
  if (!last_s) return;
  if (total_s == 0) {   // nothing claimed: leave the state zero
    if (threadIdx.x == 0) *args.state = 0;
    return;
  }
  __threadfence();
  dedup_claims(args, total_s);
}

}  // namespace

extern "C" int mageslam_radius_match(
    const void* q_desc, const void* q_octave, const void* q_valid, const void* q_xy,
    const void* radius, const void* t_desc, const void* t_xy, const void* t_octave,
    const void* t_valid, void* out_idx, void* out_dist, void* zeroed, void* claims,
    int n_stages, int n_query, int n_target, int octave_tol, int max_hamming, int min_diff,
    int group, void* stream) {
  if (n_stages < 1 || n_stages > kMaxStages || n_query < 0 || n_target < 0 ||
      zeroed == nullptr || claims == nullptr || (n_query > 0 && (group < 1 || group > n_query))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_query == 0) return 0;
  // the dedup's scratch: `zeroed` holds the 64-bit claim and ticket count
  // (padded to 16 bytes) and then the tables (S * 2 * (Q + 2) int32), zero
  // on entry and on exit; `claims` holds S * Q int4
  unsigned long long* state = static_cast<unsigned long long*>(zeroed);
  const RadiusMatchArgs args{
      static_cast<const uint32_t*>(q_desc), static_cast<const int32_t*>(q_octave),
      static_cast<const uint8_t*>(q_valid), static_cast<const float*>(q_xy),
      static_cast<const float*>(radius), static_cast<const uint4*>(t_desc),
      static_cast<const float2*>(t_xy), static_cast<const int32_t*>(t_octave),
      static_cast<const uint8_t*>(t_valid), static_cast<int32_t*>(out_idx),
      static_cast<int32_t*>(out_dist), reinterpret_cast<int32_t*>(state + 2),
      static_cast<int4*>(claims), state, n_query, n_target, octave_tol, max_hamming,
      min_diff, group};
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
