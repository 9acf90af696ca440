// The resident walk (sm_90a): exact top-k selection by query tiles that walk
// an L2-resident key bank newest first, with a running k-th key per query.
// Two selections launch it and differ in their epilogue and in how a
// compaction cuts a buffer (kRows; item 4 below):
// memory_topk_resident.cu, the resident read's selection, stores raw
// scores and ids transposed, vals[k, N] and idx[k, N]; memory_topk_iter.cu,
// select_topk's default, stores [N, k] rows of softmax weights (or raw
// scores) and ids.  For every query n: the top_k tokens t < valid by (score
// desc, id asc); slots left over when valid < top_k hold (-1e30, id 0), and
// a weight of exactly 0.  1 <= top_k <= 256.
//
// What bounds it: not the device-memory bytes (15 MB of bf16 keys at fill
// 72, read once from HBM) nor the tensor cores (121 GFLOP at fill 72,
// N = 8,100: 0.12 ms), but the instructions the SMs issue per score and per
// admitted key, and the latency of the compactions that the block waits
// for.  scripts/torch_port_walk_breakdown.py splits it (PERF.md): at fill
// 72, N = 8,100 the staging, products and barriers take an eighth of the
// rows' walk, and the scores' compares and the admitted keys' appends most
// of the rest.
//
// Design.  The TPU kernels keep the whole bank in VMEM (_kernel_resident) or
// walk it block by block into a candidate buffer (_kernel_iter), with query
// tiles as the grid.  Here the bank stays in the 50 MB L2 (the chip_smoke.py
// measurements: PERF.md):
//
//  1. grid: (tiles of 64 queries, or 32 for top_k > 128) x (S segments of
//     the live bank, in 128-token steps).  The caller picks S
//     (memory_topk.py:resident_segments): one segment when the tiles fill
//     the card (N = 8,100: 127 tiles), more when they do not (N = 1,620:
//     five).  With one segment the block writes the outputs itself: the
//     transposed [k, N] as runs of its queries, or each warp its queries'
//     rows through topk_prune.cuh's write_row, softmax included.  With
//     several, each block writes its queries' sorted 64-bit keys
//     (topk_prune.cuh's key: score bits, then ~id) to part[N, S, k], and a
//     merge joins them: topk_prune.cuh's topk_merge_t_kernel (transposed)
//     or topk_rows_cut_kernel below (rows: a warp cuts a query's S k keys
//     to its k largest, as a wave cuts a buffer).
//  2. the bank loop: the block walks its segment newest first (the engine's
//     newest memory frames lie nearest to its queries, so the thresholds
//     rise early), 128 tokens a step, staged through a ring of pieces by
//     the Tensor Memory Accelerator: one thread issues each piece (128
//     tokens of at most 64 channels: a step is CKP / 64 pieces, or one of
//     CKP < 64) as one tensor load of up to 16 KB (128-, 64- or 32-byte
//     swizzle by the row's bytes, so that ldmatrix reads hit distinct
//     banks) that completes the slot's mbarrier (per-thread cp.async,
//     1,024 a step, stalled at issue).  Keys wider than 64 keep the
//     queries in shared memory (their A fragments would spill), read a
//     piece at a time, with a block barrier between a step's pieces before
//     a slot is reloaded; at CKP = 256 with 64-query tiles the ring holds
//     three pieces (kRingPieces), so that it fits the 227 KB.  bf16 keys are scored on
//     the tensor cores: the block's queries are MT m16 A tiles, each of the
//     16 warps holds two of them in registers for the whole walk and scores
//     them against 16 (MT = 4) or 8 (MT = 2) tokens of a step (mma.sync
//     m16n8k16), and |k|^2 is the diagonal of the Gram product of those
//     keys, on the tensor cores too.  The shared memory allows one block an
//     SM, so the block brings its own latency hiding (16 warps of at most
//     128 registers) and leaves L1 ~30 KB: nothing may spill, and no
//     register array may be indexed at run time.  fp32 keys are scored on
//     the FP32 units, exactly, as topk_common.cuh's score_block does (keys
//     read from L2 directly).
//  3. a running threshold per query: the k-th largest key that the query's
//     buffer kept at its last compaction (0 until then).  Scores are
//     compared with it in registers as x = 2 <q, k> - |k|^2 against 8
//     times its score (exact: a power of two) in the instance for bf16 keys
//     64 wide (kExact), the main path, whose step then holds no other
//     instruction; every other instance compares x / sqrt(ck), rounded as
//     the plain read rounds, with the score itself; a row's largest first,
//     so that
//     most rows of most steps cost one compare; the keys above the
//     thresholds go to the queries' candidate buffers in shared memory, a
//     lane's few keys of a row by one shared atomic.  Keys are distinct, so
//     "key > threshold" is exact in any order and at ties, and a threshold,
//     the k-th key of a subset of the tokens, never exceeds the query's true
//     k-th key: no winner is refused and no escalation exists.
//  4. compaction waves: after a step (not the last) that left some buffer
//     of the block with more than kCap - kStep keys, every buffer that
//     gained keys since its last compaction is cut to its k largest keys by
//     a warp, and its threshold set to the k-th; each warp compacts its own
//     queries, in parallel.  The transposed walk sorts the buffer (bitonic,
//     in registers, over as many keys as it holds) and keeps its first k;
//     the row walk (kRows) finds the k-th key by bisection in registers
//     (kth_key: on the score bits, then on the keys tied there; ~32
//     rounds of one count and one warp sum) and keeps the keys at or above
//     it, unsorted, and sorts only the k it keeps after the walk: about a
//     fifth of the sort's instructions on a 256-key buffer.  (The
//     transposed walk keeps the sort, so that its measured times hold.)  A buffer then holds at most kCap - kStep keys when a
//     step begins and never overflows.  The block waits at its barrier for
//     the slowest warp's sorts, so compacting each buffer only when it
//     filled cost a wait in every step where one did (198 of 912 steps of a
//     64-query block at fill 72, iid keys); waves make that 9.  After the
//     walk one last compaction leaves the answer.  `compactions`, when not
//     null, counts the compactions during the walk (not the last one),
//     summed over queries and segments: waves fall at step boundaries and a
//     step's admitted keys do not depend on timing, so the count is
//     deterministic.  memory_topk.py:resident_lists states the walk for the
//     tests, and resident_rows the row epilogue.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "topk_prune.cuh"

namespace walk {

using namespace prune;

constexpr int kStep = 128;                 // bank tokens a block scores a step
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;      // 512
constexpr int kSlotElems = kStep * 64;     // bf16 of a ring slot: 16 KB

// MT m16 tiles of queries a block: 4 (64 queries, 256-key buffers) for
// top_k <= 128, 2 (32 queries, 512-key buffers) above: 128 KB of buffers
// either way, so that top_k <= kCap - kStep (memory_topk.py's
// resident_geometry states it).  A warp scores one of the kPairs pairs of
// m16 tiles (32 queries) against kWarpToks tokens of each step.
template <int MT>
struct Tile {
  static constexpr int kQ = 16 * MT;
  static constexpr int kCap = MT == 4 ? 256 : 512;
  static constexpr int kStride = kCap + 1;   // u64 a buffer: spreads banks
  static constexpr int kMine = kQ / kWarps;  // buffers a warp compacts
  static constexpr int kPairs = MT / 2;
  static constexpr int kWarpToks = kStep * kPairs / kWarps;  // 16 or 8
};

static_assert(256 <= Tile<2>::kCap - kStep && 128 <= Tile<4>::kCap - kStep,
              "a compacted buffer leaves room for a step");

template <typename T>
constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;

// Ring slots (pieces) of bf16 keys CKP wide: four, but three at CKP = 256
// with 64-query tiles, whose queries take 32 KB.
template <int MT, int CKP>
constexpr int kRingPieces = CKP == 256 && MT == 4 ? 3 : 4;

// bf16 queries kept in shared memory (keys wider than 64): [kQ][CKP],
// 16-byte unit u of row r at u ^ (r mod 8).
template <int CKP>
constexpr bool kSharedQ = CKP > 64;

// fp32 query row (padded: rows 4 words apart in the banks)
template <int CKP>
constexpr int kQStride = CKP + 4;

// Shared memory (after rounding its base up to kRingAlign): the staging
// ring and the queries of wide keys (bf16) or the fp32 queries, then the
// candidate buffers, the thresholds (key, and its score: -inf for key 0),
// the buffers' key counts and the ring's mbarriers.
template <typename T, int MT, int CKP>
__host__ __device__ constexpr size_t head_bytes() {
  return kBf16<T> ? sizeof(__nv_bfloat16) *
                        (kRingPieces<MT, CKP> * kSlotElems +
                         (kSharedQ<CKP> ? Tile<MT>::kQ * CKP : 0))
                  : sizeof(float) * Tile<MT>::kQ * kQStride<CKP>;
}

constexpr size_t kRingAlign = 1024;  // the 128-byte swizzle's period

template <typename T, int MT, int CKP>
constexpr size_t smem_bytes() {
  using G = Tile<MT>;
  return kRingAlign + head_bytes<T, MT, CKP>() +
         sizeof(u64) * G::kQ * (G::kStride + 1) +
         (sizeof(float) + sizeof(int)) * G::kQ +
         sizeof(u64) * kRingPieces<MT, CKP>;
}

__device__ __forceinline__ void mbar_init(u64* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// One TMA load of a [128 token, kW channel] bf16 box (a Piece of keys CKP
// wide: 16-byte unit u of row r at Piece::at(u, r)) at token row `row` and
// channel `col` to dst (1,024-byte aligned); rows past the map's `valid`
// rows are zeros.  `bar` counts its `bytes`.
__device__ __forceinline__ void tma_load_piece(void* dst,
                                               const CUtensorMap* map,
                                               int col, int row, int bytes,
                                               u64* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(col), "r"(row),
      "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(u64* bar, unsigned phase) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_addr(bar)),
      "r"(phase)
      : "memory");
}

// The bits of row (0, 0) in a warp's admission mask over NT n8 tiles: bit
// (2 nt + m) * 4 + i is score i of m16 tile m in n8 tile nt, of the tile's
// row g + 8 (i >> 1) (the m16n8 accumulator layout); row (m, h)'s bits are
// these shifted left by 4 m + 2 h.
template <int NT>
__device__ __forceinline__ constexpr unsigned row_bits() {
  unsigned bits = 0;
  for (int nt = 0; nt < NT; ++nt) bits |= 3u << (8 * nt);
  return bits;
}

// s[b] of N registers by a tree of selects on b's bits: an array indexed at
// run time would live in local memory.
template <int N>
__device__ __forceinline__ float pick(const float* s, unsigned b) {
  if constexpr (N == 1) {
    return s[0];
  } else {
    const float lo = pick<N / 2>(s, b);
    const float hi = pick<N / 2>(s + N / 2, b);
    return (b & (N / 2)) ? hi : lo;
  }
}

// A buffer's `count` keys, sorted descending by the warp (bitonic, in
// registers: topk_prune.cuh's sort_candidates) over the fewest registers
// that hold max(count, top_k) keys (at most CAP), the first top_k written
// back in place, zeros past `count`.  A network of 32 R keys costs about
// R log^2(32 R).
template <int CAP>
__device__ __forceinline__ void sort_buffer(u64* buf, int count, int top_k) {
  const int most = max(count, top_k);
  if (most <= 64) {
    sort_candidates<2>(buf, count, top_k, buf);
  } else if (most <= 128) {
    sort_candidates<4>(buf, count, top_k, buf);
  } else if (CAP <= 256 || most <= 256) {
    sort_candidates<8>(buf, count, top_k, buf);
  } else {
    sort_candidates<CAP / 32>(buf, count, top_k, buf);
  }
  __syncwarp();
}

// The k-th largest key K of the warp's keys v (key e = 32 r + lane is v[r],
// 0 where there is none), of which more than k (>= 1) are live, by
// bisection in registers: first the high word (the score bits) t, the
// largest with at least k keys' high words >= t, between the live keys'
// least and largest high words (at most 32 rounds of one count and one
// warp sum each; fewer where the scores lie close together, as in a
// buffer above a threshold); then, where more than k keys are at or above
// t, K between t << 32 and (t + 1) << 32 likewise (keys that tie on their
// score, at most 32 rounds more).  Keys are distinct, so exactly k keys
// are >= K.  A live key's high word is at least 1, and below 2^32 - 1
// (finite scores).
template <int R>
__device__ __forceinline__ u64 kth_key(const u64* v, int live, int k) {
  unsigned least = 0xffffffffu, most = 0u;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const unsigned h = static_cast<unsigned>(v[r] >> 32);
    if (h != 0u) least = min(least, h);
    most = max(most, h);
  }
  // count(>= lo) >= k > count(>= hi)
  unsigned lo = __reduce_min_sync(kFull, least);
  unsigned hi = __reduce_max_sync(kFull, most) + 1u;
  int at_lo = live;  // count(>= lo)
  while (hi - lo > 1u) {
    const unsigned mid = lo + ((hi - lo) >> 1);
    int c = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) c += static_cast<unsigned>(v[r] >> 32) >= mid;
    c = __reduce_add_sync(kFull, c);
    if (c >= k) {
      lo = mid;
      at_lo = c;
    } else {
      hi = mid;
    }
  }
  if (at_lo == k) {  // K: the least key of high word lo
    unsigned low = 0xffffffffu;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (static_cast<unsigned>(v[r] >> 32) == lo) {
        low = min(low, static_cast<unsigned>(v[r]));
      }
    }
    return (static_cast<u64>(lo) << 32) | __reduce_min_sync(kFull, low);
  }
  u64 a = static_cast<u64>(lo) << 32;  // count(>= a) > k > count(>= b)
  u64 b = (static_cast<u64>(lo) + 1) << 32;
  while (b - a > 1ull) {
    const u64 mid = a + ((b - a) >> 1);
    int c = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) c += v[r] >= mid;
    c = __reduce_add_sync(kFull, c);
    if (c >= k) {
      a = mid;
    } else {
      b = mid;
    }
  }
  return a;
}

// A buffer's `count` keys, of which `live` > top_k are live (not 0), cut to
// its top_k largest, in no set order, in place; returns the k-th key.  The
// warp loads them into the fewest registers that hold `count` (at most
// CAP), finds the k-th key by kth_key and places the keys at or above it
// by ballot.  About 32 (2 R + 4) instructions where a sort (sort_buffer)
// costs R log^2(32 R) compare-exchanges.
template <int R>
__device__ __forceinline__ u64 cut_keys(u64* buf, int count, int live,
                                        int top_k) {
  const int lane = threadIdx.x & 31;
  u64 v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = 32 * r + lane;
    v[r] = e < count ? buf[e] : 0ull;
  }
  const u64 kth = kth_key<R>(v, live, top_k);
  __syncwarp();
  const unsigned below = (1u << lane) - 1u;
  int base = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool in = v[r] >= kth;
    const unsigned ballot = __ballot_sync(kFull, in);
    if (in) buf[base + __popc(ballot & below)] = v[r];
    base += __popc(ballot);
  }
  __syncwarp();
  return kth;
}

template <int CAP>
__device__ __forceinline__ u64 cut_buffer(u64* buf, int count, int live,
                                          int top_k) {
  if (count <= 64) return cut_keys<2>(buf, count, live, top_k);
  if (count <= 128) return cut_keys<4>(buf, count, live, top_k);
  if (CAP <= 256 || count <= 256) return cut_keys<8>(buf, count, live, top_k);
  return cut_keys<CAP / 32>(buf, count, live, top_k);
}

// The walk of one (query tile, bank segment), keys CKP wide (scaled for
// keys ck wide; kExact: ck = CKP = 64).  kRows: vals/idx are [N, k] rows,
// weights unless `raw`; else [k, N], raw scores (`raw` unread).
template <typename T, int MT, int CKP, bool kRows, bool kExact>
__global__ void __launch_bounds__(kThreads, 1)
topk_resident_kernel(const T* __restrict__ qk, const T* __restrict__ mk,
                     float* __restrict__ vals, int* __restrict__ idx,
                     u64* __restrict__ part, int n, int valid, int ck,
                     int top_k, int raw, int* __restrict__ compactions,
                     const __grid_constant__ CUtensorMap keys) {
  using G = Tile<MT>;
  using P = Piece<CKP>;
  constexpr int kRing = kRingPieces<MT, CKP>;
  extern __shared__ __align__(16) unsigned char res_smem[];
  unsigned char* head = res_smem + (kRingAlign - smem_addr(res_smem) %
                                                     kRingAlign) % kRingAlign;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(head);
  __nv_bfloat16* s_qb = ring + kRing * kSlotElems;  // kSharedQ<CKP>
  float* s_q = reinterpret_cast<float*>(head);
  u64* cand = reinterpret_cast<u64*>(head + head_bytes<T, MT, CKP>());
  u64* thr = cand + G::kQ * G::kStride;
  float* thr_v = reinterpret_cast<float*>(thr + G::kQ);
  int* cnt = reinterpret_cast<int*>(thr_v + G::kQ);
  u64* full = reinterpret_cast<u64*>(cnt + G::kQ);  // [kRing] mbarriers

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int quad = lane & 3;
  const int q0 = blockIdx.x * G::kQ;
  // the warp's 32 queries (m16 tiles 2 p, 2 p + 1) and its kWarpToks
  // tokens of each step (from token group tg on)
  const int pair = warp % G::kPairs;
  const int tg = warp / G::kPairs;
  // this block's steps [first, last) of the live bank, walked last first
  const int n_steps = (valid + kStep - 1) / kStep;
  const int first = static_cast<int>(
      static_cast<long long>(blockIdx.y) * n_steps / gridDim.y);
  const int last = static_cast<int>(
      static_cast<long long>(blockIdx.y + 1) * n_steps / gridDim.y);
  const int count = last - first;
  // kExact: scores are compared as x = 2 <q, k> - |k|^2 against 8 times
  // the threshold's score, and a kept key's score is x / 8; else as
  // x / sqrt(ck) against the score
  static_assert(!kExact || CKP == 64, "the exact instance takes ck = 64");
  const KeyScale sc(ck);
  constexpr float xs = kExact ? 8.f : 1.f;
  constexpr float ks = kExact ? 0.125f : 1.f;

  for (int r = threadIdx.x; r < G::kQ; r += kThreads) {
    thr[r] = 0ull;
    thr_v[r] = topk::neg_inf();
    cnt[r] = 0;
  }
  if (kBf16<T> && threadIdx.x == 0) {
    for (int i = 0; i < kRing; ++i) mbar_init(full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the lane's rows of the accumulator tiles: query 32 pair + 16 m + g + 8 h
  int rows[2][2];
  bool row_live[2][2];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rows[m][h] = 32 * pair + 16 * m + g + 8 * h;
      row_live[m][h] = q0 + rows[m][h] < n;
    }
  }
  // bf16: the warp's queries as A fragments, in registers up to CKP = 64
  constexpr int kRegSteps = kSharedQ<CKP> ? 1 : CKP / 16;
  unsigned a[2][kRegSteps][4];
  if constexpr (kBf16<T> && kSharedQ<CKP>) {
    constexpr int kUnits = CKP / 8;
    for (int e = threadIdx.x; e < G::kQ * kUnits; e += kThreads) {
      const int row = e / kUnits;
      const int unit = e % kUnits;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + row < n) {
        v = *reinterpret_cast<const uint4*>(
            qk + static_cast<size_t>(q0 + row) * CKP + 8 * unit);
      }
      *reinterpret_cast<uint4*>(s_qb + row * CKP +
                                8 * (unit ^ (row & 7))) = v;
    }
  } else if constexpr (kBf16<T>) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int kk = 0; kk < kRegSteps; ++kk) {
        const int c = 16 * kk + 2 * quad;
        const int q = q0 + rows[m][0];
        a[m][kk][0] = query_pair(qk, q, n, c, CKP);
        a[m][kk][1] = query_pair(qk, q + 8, n, c, CKP);
        a[m][kk][2] = query_pair(qk, q, n, c + 8, CKP);
        a[m][kk][3] = query_pair(qk, q + 8, n, c + 8, CKP);
      }
    }
  } else {
    for (int e = threadIdx.x; e < G::kQ * (CKP / 8); e += kThreads) {
      const int qq = e / (CKP / 8);
      const int c = (e % (CKP / 8)) * 8;
      float v[8];
      if (q0 + qq < n) {
        load8(qk + static_cast<size_t>(q0 + qq) * CKP + c, v);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) s_q[qq * kQStride<CKP> + c + i] = v[i];
    }
  }
  __syncthreads();

  // bf16: walked piece u (piece u % kPieces of step u / kPieces, bank step
  // last - 1 - u / kPieces) into ring slot u % kRing by one TMA load
  // (thread 0), which completes the slot's mbarrier
  auto issue = [&](int u) {
    if (kBf16<T> && threadIdx.x == 0 && u < count * P::kPieces) {
      // the slot's last readers passed a barrier: order their (generic)
      // reads before the (async) write
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      tma_load_piece(ring + (u % kRing) * kSlotElems, &keys,
                     (u % P::kPieces) * P::kW,
                     (last - 1 - u / P::kPieces) * kStep,
                     kStep * P::kW * 2, full + u % kRing);
    }
  };
#pragma unroll
  for (int u = 0; u < kRing - 1; ++u) issue(u);

  constexpr int kNT = G::kWarpToks / 8;  // the warp's n8 tiles of a step
  int compacted = 0;  // this warp's compactions during the walk
  bool over = false;  // one of this warp's buffers could overflow next step
#pragma unroll 1
  for (int j = 0; j < count; ++j) {
    const int u0 = j * P::kPieces;  // the step's first piece
    if constexpr (kBf16<T>) mbar_wait(full + u0 % kRing, (u0 / kRing) & 1);
    // step j's first piece is staged, and every warp is done with the
    // previous piece's slot and the previous step's appends.  A compaction
    // wave: when some buffer of the block holds more than kCap - kStep
    // keys, every buffer that gained keys since its last compaction is
    // compacted (warp w its buffers w, w + kWarps, ...), so that the block
    // waits for a warp's sorts in a few steps, not in every step where one
    // buffer fills.
    if (__syncthreads_or(over)) {
      const int c = lane < G::kMine ? cnt[warp + kWarps * lane] : 0;
      unsigned todo = __ballot_sync(kFull, c > top_k);
      while (todo) {
        const int row = warp + kWarps * (__ffs(todo) - 1);
        todo &= todo - 1;
        u64* buf = cand + row * G::kStride;
        u64 kth;  // more than top_k keys were there
        if constexpr (kRows) {
          kth = cut_buffer<G::kCap>(buf, cnt[row], cnt[row], top_k);
        } else {
          sort_buffer<G::kCap>(buf, cnt[row], top_k);
          kth = buf[top_k - 1];
        }
        if (lane == 0) {
          float tvk;
          int id;
          unpack(kth, tvk, id);
          thr[row] = kth;
          thr_v[row] = tvk;
          cnt[row] = top_k;
        }
        ++compacted;
      }
      __syncthreads();
    }
    issue(u0 + kRing - 1);
    const int tok0 = (last - 1 - j) * kStep + tg * G::kWarpToks;
    // the rows' thresholds as (x, id): a key is above its row's if its x is
    // greater, or equal with a lower id.  -inf: no threshold yet; +inf: a
    // row past the last query, which admits nothing.
    float tx[2][2];
    int tid[2][2];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        tx[m][h] = row_live[m][h] ? xs * thr_v[rows[m][h]]
                                  : __uint_as_float(0x7f800000u);
        tid[m][h] = static_cast<int>(~static_cast<unsigned>(thr[rows[m][h]]));
      }
    }

    // x[nt][m][i]: (query rows[m][i >> 1], token tok0 + 8 nt + 2 quad +
    // (i & 1)), the m16n8 accumulator layout; -inf for a token past valid
    float x[kNT][2][4];
    if constexpr (kBf16<T>) {
      const int row0 = tg * G::kWarpToks;  // the warp's first row of the step
      // |k|^2 on the tensor cores: the diagonal of K K^T, K the warp's 16
      // staged keys (8 twice over with one n8 tile) as an m16 A tile,
      // summed over the step's pieces as the products are
      float gram[kNT][4];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          gram[nt][e] = 0.f;
          x[nt][0][e] = 0.f;
          x[nt][1][e] = 0.f;
        }
      }
#pragma unroll
      for (int p = 0; p < P::kPieces; ++p) {
        const int u = u0 + p;
        if (p > 0) {  // every warp is done with piece u - 1's slot
          __syncthreads();
          issue(u + kRing - 1);
          mbar_wait(full + u % kRing, (u / kRing) & 1);
        }
        const __nv_bfloat16* stage = ring + (u % kRing) * kSlotElems;
        unsigned b[kNT][8];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const int r = row0 + 8 * nt + (lane & 7);
          const __nv_bfloat16* rowp = stage + r * P::kW;
          ldmatrix_x4(b[nt], rowp + (P::at((lane >> 3) % P::kUnits, r) << 3));
          if constexpr (P::kUnits == 8) {
            ldmatrix_x4(b[nt] + 4, rowp + (P::at((lane >> 3) + 4, r) << 3));
          }
        }
        constexpr int kSteps = P::kW / 16;  // k16 steps of a piece
        {
          const int r = row0 + (kNT == 2 ? (lane & 15) : (lane & 7));
          const __nv_bfloat16* rowp = stage + r * P::kW;
          unsigned ak[kSteps][4];
#pragma unroll
          for (int kk = 0; kk < kSteps; ++kk) {
            ldmatrix_x4(ak[kk], rowp + (P::at(2 * kk + (lane >> 4), r) << 3));
          }
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
            for (int kk = 0; kk < kSteps; ++kk) {
              mma_bf16(gram[nt], ak[kk], b[nt][2 * kk], b[nt][2 * kk + 1]);
            }
          }
        }
        // the piece's A fragments: the registers' (CKP <= 64), or k16 steps
        // kSteps p + kk of the queries in shared memory
        unsigned af[2][kSteps][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
#pragma unroll
          for (int kk = 0; kk < kSteps; ++kk) {
            if constexpr (kSharedQ<CKP>) {
              const int row =
                  32 * pair + 16 * m + (lane & 7) + 8 * ((lane >> 3) & 1);
              const int unit = 2 * (kSteps * p + kk) + (lane >> 4);
              ldmatrix_x4(af[m][kk],
                          s_qb + row * CKP + ((unit ^ (row & 7)) << 3));
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e) af[m][kk][e] = a[m][kk][e];
            }
          }
        }
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
          for (int m = 0; m < 2; ++m) {
#pragma unroll
            for (int kk = 0; kk < kSteps; ++kk) {
              mma_bf16(x[nt][m], af[m][kk], b[nt][2 * kk], b[nt][2 * kk + 1]);
            }
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        // token c of the tile: row 8 nt + c of K, held by lane 4 c + c / 2
        // as element 2 nt + (c & 1) of its gram[nt]
        const int tok = tok0 + 8 * nt + 2 * quad;
        float sq0 = __shfl_sync(kFull, gram[nt][2 * nt], 9 * quad);
        float sq1 = __shfl_sync(kFull, gram[nt][2 * nt + 1], 9 * quad + 4);
        if (tok >= valid) sq0 = __uint_as_float(0x7f800000u);
        if (tok + 1 >= valid) sq1 = __uint_as_float(0x7f800000u);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          x[nt][m][0] = 2.f * x[nt][m][0] - sq0;
          x[nt][m][1] = 2.f * x[nt][m][1] - sq1;
          x[nt][m][2] = 2.f * x[nt][m][2] - sq0;
          x[nt][m][3] = 2.f * x[nt][m][3] - sq1;
        }
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // the key 8 channels at a time (64 registers of it spilled); each
          // sum still runs over the channels in order, as score_block's
          const int tok = tok0 + 8 * nt + 2 * quad + e;
          float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
          float sq = 0.f;
#pragma unroll 8
          for (int c = 0; c < CKP; c += 8) {
            float kv[8];
            if (tok < valid) {
              load8(mk + static_cast<size_t>(tok) * CKP + c, kv);
            } else {
#pragma unroll
              for (int i = 0; i < 8; ++i) kv[i] = 0.f;
            }
#pragma unroll
            for (int i = 0; i < 8; ++i) sq = fmaf(kv[i], kv[i], sq);
#pragma unroll
            for (int m = 0; m < 2; ++m) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float* qrow = s_q + rows[m][h] * kQStride<CKP> + c;
#pragma unroll
                for (int i = 0; i < 8; i += 4) {
                  const float4 qv = *reinterpret_cast<const float4*>(qrow + i);
                  acc[m][h] = fmaf(qv.x, kv[i], acc[m][h]);
                  acc[m][h] = fmaf(qv.y, kv[i + 1], acc[m][h]);
                  acc[m][h] = fmaf(qv.z, kv[i + 2], acc[m][h]);
                  acc[m][h] = fmaf(qv.w, kv[i + 3], acc[m][h]);
                }
              }
            }
          }
          if (tok >= valid) sq = __uint_as_float(0x7f800000u);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              x[nt][m][2 * h + e] = 2.f * acc[m][h] - sq;
            }
          }
        }
      }
    }
    if constexpr (!kExact) {  // scores: x / root, rounded as the plain read
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int m = 0; m < 2; ++m) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {  // -inf (a dead token) stays -inf
            const float v = x[nt][m][i];
            x[nt][m][i] = v == topk::neg_inf() ? v : sc.div<false>(v);
          }
        }
      }
    }

    // admit: a row whose largest x is below its threshold's admits nothing
    // (most rows of most steps: one compare a row); the others' keys above
    // their thresholds set bit (2 nt + m) * 4 + i of `in`, and a lane
    // appends its few keys, each row's by one shared atomic
    unsigned hit = 0;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float top = fmaxf(x[0][m][2 * h], x[0][m][2 * h + 1]);
#pragma unroll
        for (int nt = 1; nt < kNT; ++nt) {
          top = fmaxf(top, fmaxf(x[nt][m][2 * h], x[nt][m][2 * h + 1]));
        }
        hit |= static_cast<unsigned>(top >= tx[m][h]) << (2 * m + h);
      }
    }
    if (hit) {
      unsigned in = 0;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int m = 0; m < 2; ++m) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int h = i >> 1;
            const int tok = tok0 + 8 * nt + 2 * quad + (i & 1);
            const float v = x[nt][m][i];
            const bool pass =
                v > tx[m][h] || (v == tx[m][h] && tok < tid[m][h]);
            in |= static_cast<unsigned>(pass) << ((2 * nt + m) * 4 + i);
          }
        }
      }
      int at[2][2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = __popc(in & (row_bits<kNT>() << (4 * m + 2 * h)));
          at[m][h] = c > 0 ? atomicAdd(&cnt[rows[m][h]], c) : 0;
        }
      }
      for (unsigned y = in; y != 0; y &= y - 1) {
        const int bit = __ffs(y) - 1;
        const int m = (bit >> 2) & 1;
        const int h = (bit >> 1) & 1;
        const int tok = tok0 + 8 * (bit >> 3) + 2 * quad + (bit & 1);
        const int p = m ? (h ? at[1][1]++ : at[1][0]++)
                        : (h ? at[0][1]++ : at[0][0]++);
        cand[(32 * pair + 16 * m + g + 8 * h) * G::kStride + p] =
            key_of(ord_of(pick<kNT * 8>(&x[0][0][0], bit) * ks + 0.f), tok);
      }
    }
    __syncthreads();  // the step's appends are in the buffers
    const int c = lane < G::kMine ? cnt[warp + kWarps * lane] : 0;
    over = __any_sync(kFull, c > G::kCap - kStep);
  }
  __syncthreads();  // the walk's last appends, or the init

  // the last compaction: each warp's queries' first k keys, sorted; with
  // several segments they go to part, with one a warp writes them as its
  // queries' rows (kRows)
  const bool direct = gridDim.y == 1;
#pragma unroll 1
  for (int i = 0; i < G::kMine; ++i) {
    const int row = warp + kWarps * i;
    u64* buf = cand + row * G::kStride;
    int c = cnt[row];
    if constexpr (kRows) {  // cut to the top_k keys, then sort those
      if (c > top_k) {
        cut_buffer<G::kCap>(buf, c, c, top_k);
        c = top_k;
      }
    }
    sort_buffer<G::kCap>(buf, c, top_k);
    const int q = q0 + row;
    if (!direct && q < n) {
      u64* out = part + (static_cast<size_t>(q) * gridDim.y + blockIdx.y) *
                            top_k;
      for (int e = lane; e < top_k; e += 32) out[e] = buf[e];
    }
    if constexpr (kRows) {
      if (direct && q < n) {
        write_row(buf, vals + static_cast<size_t>(q) * top_k,
                  idx + static_cast<size_t>(q) * top_k, top_k, raw);
      }
    }
  }
  if (lane == 0 && compacted > 0 && compactions != nullptr) {
    atomicAdd(compactions, compacted);
  }
  if (kRows || !direct) return;
  __syncthreads();
  // rows t of [k, N] as runs of the block's queries
  for (int e = threadIdx.x; e < top_k * G::kQ; e += kThreads) {
    const int t = e / G::kQ;
    const int qq = e % G::kQ;
    if (q0 + qq < n) {
      float v;
      int id;
      unpack(cand[qq * G::kStride + t], v, id);
      vals[static_cast<size_t>(t) * n + q0 + qq] = v;
      idx[static_cast<size_t>(t) * n + q0 + qq] = id;
    }
  }
}

// The row walk's merge of its S segments: one warp per query takes the
// S sorted lists part[q, S, k] (S k <= KEYS keys, 0 past a list's live
// keys) as one buffer, cuts it to its k largest live keys (cut_buffer, in
// place), sorts those and writes the query's row (write_row).  A merge
// that advances list heads one output slot at a time (topk_prune.cuh's
// topk_rows_merge_kernel) waits k times for a reload; this waits for one
// bisection.  (A template, so that the transposed walk's library, which
// launches no row merge, compiles none.)
constexpr int kCutMergeWarps = 8;
constexpr int kCutMergeKeys = 512;  // S * top_k a row merge takes

template <int KEYS>
__global__ void __launch_bounds__(32 * kCutMergeWarps)
topk_rows_cut_kernel(u64* __restrict__ part, float* __restrict__ out_v,
                     int* __restrict__ out_i, int n, int top_k, int n_lists,
                     int raw) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kCutMergeWarps + (threadIdx.x >> 5);
  if (q >= n) return;  // whole warps
  const int count = n_lists * top_k;
  u64* keys = part + static_cast<size_t>(q) * count;
  int live = 0;
  for (int e = lane; e < count; e += 32) live += keys[e] != 0ull;
  live = __reduce_add_sync(kFull, live);
  if (live > top_k) {
    cut_buffer<KEYS>(keys, count, live, top_k);
    sort_buffer<KEYS>(keys, top_k, top_k);
  } else {  // all live keys: sorted, 0 past them
    sort_buffer<KEYS>(keys, count, top_k);
  }
  write_row(keys, out_v + static_cast<size_t>(q) * top_k,
            out_i + static_cast<size_t>(q) * top_k, top_k, raw);
}

// The TMA map of bf16 keys mk [valid, CKP] in boxes of one piece (128
// tokens of Piece<CKP>::kW channels), swizzled by the box row's bytes as
// Piece::at reads it (the map's rows stop at `valid`: the TMA writes zeros
// past it).  cuTensorMapEncodeTiled is looked up at run time
// (cudaGetDriverEntryPoint), so the library needs no link against libcuda.
template <int CKP>
cudaError_t keys_map(const void* mk, int valid, CUtensorMap* map) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
        cudaEnableDefault, &found);
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      encode = nullptr;
      return err != cudaSuccess ? err : cudaErrorSymbolNotFound;
    }
  }
  using P = Piece<CKP>;
  const cuuint64_t dims[2] = {CKP, static_cast<cuuint64_t>(valid)};
  const cuuint64_t strides[1] = {CKP * sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {P::kW, kStep};
  const cuuint32_t steps[2] = {1, 1};
  const CUtensorMapSwizzle swizzle =
      P::kUnits == 8   ? CU_TENSOR_MAP_SWIZZLE_128B
      : P::kUnits == 4 ? CU_TENSOR_MAP_SWIZZLE_64B
                       : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(mk), dims,
      strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, int MT, int CKP, bool kRows, bool kExact>
int launch(const void* qk, const void* mk, float* vals, int* idx, u64* part,
           int n, int valid, int ck, int top_k, int segments,
           int* compactions, int raw, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, MT, CKP>();
  static_assert(smem <= 232448, "the walk's shared memory fits an SM");
  cudaError_t err = cudaFuncSetAttribute(
      topk_resident_kernel<T, MT, CKP, kRows, kExact>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map{};
  if (kBf16<T> && valid > 0) {
    err = keys_map<CKP>(mk, valid, &map);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((n + Tile<MT>::kQ - 1) / Tile<MT>::kQ, segments);
  topk_resident_kernel<T, MT, CKP, kRows, kExact>
      <<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qk), static_cast<const T*>(mk), vals, idx, part,
      n, valid, ck, top_k, raw, compactions, map);
  err = cudaGetLastError();
  if (err != cudaSuccess || segments == 1) return static_cast<int>(err);
  if constexpr (kRows) {
    topk_rows_cut_kernel<kCutMergeKeys>
        <<<(n + kCutMergeWarps - 1) / kCutMergeWarps, 32 * kCutMergeWarps, 0,
           stream>>>(part, vals, idx, n, top_k, segments, raw);
    return static_cast<int>(cudaGetLastError());
  } else {
    return launch_merge_t<kMergeQ>(part, vals, idx, n, top_k, segments,
                                   stream);
  }
}

// MT = 4 (64 queries, 256-key buffers) for top_k <= 128, else MT = 2; the
// exact instance for bf16 keys 64 wide.
template <typename T, int CKP, bool kRows>
int launch_dtype(const void* qk, const void* mk, float* vals, int* idx,
                 u64* part, int n, int valid, int ck, int top_k, int segments,
                 int* compactions, int raw, cudaStream_t stream) {
  auto tile = [&](auto exact) {
    constexpr bool kE = decltype(exact)::value;
    if (top_k <= 128) {
      return launch<T, 4, CKP, kRows, kE>(qk, mk, vals, idx, part, n, valid,
                                          ck, top_k, segments, compactions,
                                          raw, stream);
    }
    return launch<T, 2, CKP, kRows, kE>(qk, mk, vals, idx, part, n, valid, ck,
                                        top_k, segments, compactions, raw,
                                        stream);
  };
  if constexpr (kBf16<T> && CKP == 64) {
    if (ck == 64) return tile(std::true_type{});
  }
  return tile(std::false_type{});
}

// The C interface of memory_topk_resident.cu (kRows false) and
// memory_topk_iter.cu (kRows true): checks the arguments and launches the
// walk, and the merge of several segments.  qk [n, ckp], mk [m >= valid,
// ckp] row-major, 16-byte aligned, fp32 (is_bf16 = 0) or bf16 (is_bf16 =
// 1), ckp = topk::padded_width(ck) for keys ck wide, 1 <= ck <= 256 (the
// wrapper zero-pads them; ck sets the scale); vals/idx [top_k, n] or,
// kRows, [n, top_k]; 1 <= top_k <= 256.
// segments: the bank segments S, 1 <= S <= the live 128-token steps (any
// S >= 1 when valid = 0), at most kMaxLists, and, kRows, S top_k <=
// kCutMergeKeys when S > 1; part: [n, S, top_k] 64-bit scratch, or null
// when S = 1.  compactions: null, or one int32 on the
// device that counts the compactions of full buffers.  raw (kRows): raw
// scores in place of the weights.  Returns a cudaError_t code.
template <bool kRows>
int launch_checked(const void* qk, const void* mk, void* vals, void* idx,
                   void* part, int n, int valid, int ck, int top_k,
                   int segments, void* compactions, int raw, int is_bf16,
                   void* stream) {
  if (n <= 0) return 0;
  const int n_steps = (valid + kStep - 1) / kStep;
  if (ck < 1 || ck > topk::kMaxKeyWidth || top_k < 1 || top_k > 256 ||
      valid < 0 || segments < 1 ||
      segments > kMaxLists || (segments > n_steps && segments > 1) ||
      (segments > 1 && part == nullptr) ||
      (kRows && segments > 1 && segments * top_k > kCutMergeKeys)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* v = static_cast<float*>(vals);
  int* i = static_cast<int*>(idx);
  u64* p = static_cast<u64*>(part);
  int* c = static_cast<int*>(compactions);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return topk::with_width(ck, [&](auto w) {
    constexpr int kW = decltype(w)::value;
    return is_bf16 ? launch_dtype<__nv_bfloat16, kW, kRows>(
                         qk, mk, v, i, p, n, valid, ck, top_k, segments, c,
                         raw, s)
                   : launch_dtype<float, kW, kRows>(qk, mk, v, i, p, n, valid,
                                                    ck, top_k, segments, c,
                                                    raw, s);
  });
}

}  // namespace walk
