// The pruned block stage of the exact top-k selections by bank block
// (sm_90a): memory_topk.cu (the default read's selection) and
// memory_topk_sort.cu (select_topk's 'sort' method) score a tile of 16
// queries against one 2,048-token bank block and leave, for each query, the
// block's exact top k as sorted 64-bit keys.
//
// A candidate is one 64-bit key: the score's bits, mapped so that unsigned
// order is float order (ord), in the high word and ~id in the low word, so
// that one unsigned comparison is the (score desc, id asc) order and keys are
// distinct.  A dead token's ord is 0, so its key is below 2^32 and below
// every live one; the key 0 unpacks to (-1e30, id 0).
//
//  1. score_tile: the block scores its tile into shared memory as ords
//     (16 x 2,048 x 4 B = 128 KB; the id is the column): bf16 keys on the
//     tensor cores (mma.sync m16n8k16, the 16 queries one A tile held in
//     registers, keys staged by cp.async; score_block_mma), fp32 keys on the
//     FP32 units (score_block in topk_common.cuh), whose products stay exact
//     where TF32 would round them.
//  2. select_row: warp w selects query w's row:
//     a. threshold: column c belongs to group c mod G (G = 128, 256 or 512
//        for k <= 64, 128, 256); a lane reads its columns 16 bytes at a time
//        (4 l + 128 i + e, e < 4), so it owns G / 32 whole groups.  The warp
//        sorts the G group maxima of the ords (a bitonic network in registers
//        and shuffles) and takes the k-th, tau.  The k largest maxima come
//        from k distinct tokens, so the row's k-th key has an ord >= tau and
//        "ord >= tau" keeps the exact top k, ties at the boundary included.
//        tau is at least 1, so no dead token is admitted and a row with fewer
//        than k live tokens keeps all of them; groups strided across the
//        columns keep a block that ends mid-way at G live groups.
//     b. compaction: the keys of the columns with ord >= tau go to the row's
//        candidate list in shared memory (512 keys), placed by warp ballot
//        and popc.  For random scores ~1.2 k survive (62 at k = 50).
//     c. escalation, exact: a row with more than 512 survivors (its winners
//        packed into fewer than k groups, or scores tied across the row)
//        bisects the key range between tau and its largest ord, counting
//        keys at or above the midpoint, until k to 512 keys are left (keys
//        are distinct, so a count never jumps by more than one), and compacts
//        again.  It adds one to `escalations` when that is given.
//     d. up to 128 candidates are placed by rank (each lane counts the
//        candidates above its own, reading each once as a broadcast); more
//        are sorted by the warp in registers.  The first k keys, in order,
//        go to the caller's list (zeros past the live keys).
//
// memory_topk.py states the rule for the tests: SORT_CAPACITY is kCap,
// sort_prune_groups the group count, sort_prune_threshold the threshold.

#pragma once

#include <type_traits>

#include "topk_common.cuh"

namespace prune {

using topk::kNegInf;
using topk::load8;

using u64 = unsigned long long;

constexpr int kQT = 16;                  // queries per block, one per warp
constexpr int kBlk = 2048;               // bank tokens per block (block_m)
constexpr int kThreads1 = 32 * kQT;      // 512
// A lane reads a row 16 bytes at a time: columns 4 (lane + 32 i) + e,
// i < kVecs, e < 4.
constexpr int kVecs = kBlk / 128;
// Words per row of the score tile: rows 8 words apart in the banks, so that
// a half warp storing two columns each of four rows hits 32 distinct banks.
constexpr int kRowStride = kBlk + 8;
// Candidate list of a row.  memory_topk.py's SORT_CAPACITY states it (and
// sort_prune_groups the group count of select_row) for the tests, and
// test_sort_kernel_escalation holds the escalations counted here to it.
constexpr int kCap = 512;
constexpr unsigned kFull = 0xffffffffu;
// bf16 scoring: warp w scores tokens [128 w, 128 w + 128) of the block in
// chunks of 8 (one n8 tile), staged through a ring of kStages chunks
constexpr int kWarpToks = kBlk / kQT;        // 128
constexpr int kChunk = 8;
constexpr int kChunks = kWarpToks / kChunk;  // 16
constexpr int kStages = 4;
constexpr int kStageElems = kChunk * 64;     // bf16 of one staged chunk

// the candidate lists' space holds the staging ring until the tile is scored
static_assert(sizeof(__nv_bfloat16) * kQT * kStages * kStageElems <=
                  sizeof(u64) * kQT * kCap,
              "the staging ring fits in the candidate lists' space");
static_assert(kQT * kRowStride * sizeof(unsigned) % 16 == 0,
              "16-byte aligned staging ring");
// a row of the score tile, once selected, can hold the row's sorted keys
static_assert(kRowStride * sizeof(unsigned) >= 256 * sizeof(u64) &&
                  kRowStride * sizeof(unsigned) % sizeof(u64) == 0,
              "a tile row holds 256 aligned keys");

__device__ __forceinline__ unsigned ord_of(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ u64 key_of(unsigned ord, int id) {
  return (static_cast<u64>(ord) << 32) | static_cast<unsigned>(~id);
}

__device__ __forceinline__ void unpack(u64 key, float& v, int& id) {
  if (key == 0ull) {  // dead
    v = kNegInf;
    id = 0;
    return;
  }
  const unsigned ord = static_cast<unsigned>(key >> 32);
  v = __uint_as_float((ord & 0x80000000u) ? (ord & 0x7fffffffu) : ~ord);
  id = static_cast<int>(~static_cast<unsigned>(key));
}

struct OrdTile {
  unsigned* s;  // [kQT][kRowStride]
  __device__ void operator()(int qq, int j, float v) {
    s[qq * kRowStride + j] = ord_of(v);
  }
  __device__ void dead(int qq, int j) { s[qq * kRowStride + j] = 0u; }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; src_bytes = 0
// writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 -> fp32.
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two bf16 of query q's key (channels c, c + 1), 0 past the last query.
__device__ __forceinline__ unsigned query_pair(const __nv_bfloat16* qk, int q,
                                               int n, int c) {
  return q < n ? *reinterpret_cast<const unsigned*>(
                     qk + static_cast<size_t>(q) * 64 + c)
               : 0u;
}

// The bf16 counterpart of score_block: the ords of queries [q0, q0 + 16)
// against tokens [lo, lo + kBlk) on the tensor cores.  The queries are one
// m16 tile, held as A fragments for the whole block (four k16 steps of
// CK = 64).  Warp w's 128 tokens pass through its ring `stage` of kStages
// chunks of 8 token rows (128 B each, 16-byte unit u of row r at u ^ r, so
// that both cp.async's stores and ldmatrix's reads hit distinct banks);
// kStages - 1 chunks are in flight while one is scored.  A chunk is one n8
// tile: two ldmatrix.x4 give its B fragments, four mma.sync its 16 x 8
// dot products (bf16 products are exact in fp32, summed in the tensor
// core's order); |k|^2 is an fp32 sum of the staged bf16 values (four lanes
// a token, 16 channels each).  Ends with a barrier.
__device__ __forceinline__ void score_block_mma(const __nv_bfloat16* qk,
                                                const __nv_bfloat16* mk,
                                                int n, int q0, int lo, int hi,
                                                unsigned* tile,
                                                __nv_bfloat16* stage) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int quad = lane & 3;
  unsigned a[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = 16 * kk + 2 * quad;
    a[kk][0] = query_pair(qk, q0 + (lane >> 2), n, c);
    a[kk][1] = query_pair(qk, q0 + (lane >> 2) + 8, n, c);
    a[kk][2] = query_pair(qk, q0 + (lane >> 2), n, c + 8);
    a[kk][3] = query_pair(qk, q0 + (lane >> 2) + 8, n, c + 8);
  }
  const int col0 = warp * kWarpToks;  // the warp's first column
  stage += warp * kStages * kStageElems;
  auto issue = [&](int ch) {
    if (ch < kChunks) {
      __nv_bfloat16* buf = stage + (ch % kStages) * kStageElems;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int row = (lane >> 3) + 4 * j;
        const int unit = lane & 7;
        const int tok = lo + col0 + ch * kChunk + row;
        const bool live = tok < hi;
        cp_async16(buf + row * 64 + ((unit ^ row) << 3),
                   live ? mk + static_cast<size_t>(tok) * 64 + unit * 8 : mk,
                   live ? 16 : 0);
      }
    }
    cp_async_commit();  // an empty group past the last chunk
  };
#pragma unroll
  for (int ch = 0; ch < kStages - 1; ++ch) issue(ch);
  for (int ch = 0; ch < kChunks; ++ch) {
    issue(ch + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const __nv_bfloat16* buf = stage + (ch % kStages) * kStageElems;
    unsigned b[8];
    const int r = lane & 7;  // the row this lane addresses for ldmatrix
    ldmatrix_x4(b, buf + r * 64 + (((lane >> 3) ^ r) << 3));
    ldmatrix_x4(b + 4, buf + r * 64 + ((((lane >> 3) + 4) ^ r) << 3));
    float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_bf16(d, a[kk], b[2 * kk], b[2 * kk + 1]);
    // |k|^2: lane 4 t + u sums units 2 u, 2 u + 1 of row t
    float sq = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v[8];
      load8(buf + (lane >> 2) * 64 + (((2 * quad + h) ^ (lane >> 2)) << 3), v);
#pragma unroll
      for (int i = 0; i < 8; ++i) sq = fmaf(v[i], v[i], sq);
    }
    sq += __shfl_xor_sync(kFull, sq, 1);
    sq += __shfl_xor_sync(kFull, sq, 2);
    __syncwarp();  // the ring slot is free for the next issue
    // this lane's columns: rows 2 quad, 2 quad + 1 of the chunk
    const float sq0 = __shfl_sync(kFull, sq, 8 * quad);
    const float sq1 = __shfl_sync(kFull, sq, 8 * quad + 4);
    const int col = col0 + ch * kChunk + 2 * quad;
    const bool live0 = lo + col < hi;
    const bool live1 = lo + col + 1 < hi;
    const float scale = sqrtf(64.f);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v0 = (2.f * d[2 * h] - sq0) / scale + 0.f;
      const float v1 = (2.f * d[2 * h + 1] - sq1) / scale + 0.f;
      *reinterpret_cast<uint2*>(tile + ((lane >> 2) + 8 * h) * kRowStride +
                                col) =
          make_uint2(live0 ? ord_of(v0) : 0u, live1 ? ord_of(v1) : 0u);
    }
  }
  __syncthreads();
}

// Shared memory of a block: [kQT][kRowStride] ords, then the bf16 staging
// ring [kQT warps][kStages chunks] or, once the tile is scored, the candidate
// lists [kQT][kCap], then the fp32 queries [kQT][CK].
struct BlockSmem {
  unsigned* tile;
  u64* cand;
  float* s_q;
};

__device__ __forceinline__ BlockSmem carve_block(unsigned* smem) {
  BlockSmem s;
  s.tile = smem;
  s.cand = reinterpret_cast<u64*>(smem + kQT * kRowStride);
  s.s_q = reinterpret_cast<float*>(s.cand + kQT * kCap);
  return s;
}

inline size_t block_smem_bytes(int ck) {
  return sizeof(unsigned) * static_cast<size_t>(kQT) * kRowStride +
         sizeof(u64) * static_cast<size_t>(kQT) * kCap +
         sizeof(float) * static_cast<size_t>(kQT) * ck;
}

// The ords of queries [q0, q0 + kQT) against tokens [lo, lo + kBlk) (dead
// at or past hi) into s.tile.  Every thread of the block calls it; it ends
// with a barrier.
template <typename T, int CK>
__device__ __forceinline__ void score_tile(const T* qk, const T* mk, int n,
                                           int q0, int lo, int hi,
                                           const BlockSmem& s) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    static_assert(CK == 64, "score_block_mma takes four k16 steps");
    score_block_mma(qk, mk, n, q0, lo, hi, s.tile,
                    reinterpret_cast<__nv_bfloat16*>(s.cand));
  } else {
    OrdTile tile{s.tile};
    topk::score_block<T, CK, kQT, kBlk, kThreads1>(qk, mk, n, q0, lo, hi,
                                                   s.s_q, tile);
  }
}

template <typename V>
__device__ __forceinline__ void cmp_swap(V& x, V& y, bool desc) {
  if ((x < y) == desc) {
    const V t = x;
    x = y;
    y = t;
  }
}

// Bitonic sort, descending, of the warp's 32 R values: value e = 32 r + lane
// is v[r] of that lane.  Strides of 32 and more pair registers of one lane,
// smaller ones pair lanes by shuffles.
template <int R, typename V>
__device__ __forceinline__ void warp_sort_desc(V* v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32 * R; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 32) {
        const int rs = stride >> 5;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if ((r & rs) == 0) cmp_swap(v[r], v[r + rs], ((32 * r) & size) == 0);
        }
      } else {
        const bool lower = (lane & stride) == 0;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const V o = __shfl_xor_sync(kFull, v[r], stride);
          const bool desc = ((32 * r + lane) & size) == 0;
          v[r] = (lower == desc) ? (o > v[r] ? o : v[r]) : (o < v[r] ? o : v[r]);
        }
      }
    }
  }
}

// Value e = 32 r + lane of the warp's values v.
template <int R, typename V>
__device__ __forceinline__ V warp_value_at(const V* v, int e) {
  V x = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r == (e >> 5)) x = v[r];
  }
  return __shfl_sync(kFull, x, e & 31);
}

// The k-th largest of the row's 32 GPL group maxima of ords (at least 1),
// and the row's largest ord.  Column c is in group c mod 32 GPL, so lane l
// owns the groups 4 l + e + 128 (i % (GPL / 4)).
template <int GPL>
__device__ __forceinline__ void group_threshold(const unsigned* row,
                                                int top_k, unsigned& tau,
                                                unsigned& top) {
  const int lane = threadIdx.x & 31;
  const uint4* row4 = reinterpret_cast<const uint4*>(row);
  unsigned m[GPL];
#pragma unroll
  for (int j = 0; j < GPL; ++j) m[j] = 0u;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const uint4 o = row4[lane + 32 * i];
    unsigned* g = m + 4 * (i % (GPL / 4));
    g[0] = max(g[0], o.x);
    g[1] = max(g[1], o.y);
    g[2] = max(g[2], o.z);
    g[3] = max(g[3], o.w);
  }
  warp_sort_desc<GPL>(m);
  tau = max(warp_value_at<GPL>(m, top_k - 1), 1u);
  top = __shfl_sync(kFull, m[0], 0);
}

// The row's keys >= t, in no set order, to cand[0, min(count, kCap));
// returns their count.  By_ord: t's low word is 0, so an ord >= t's high
// word decides.  Few columns pass, so a warp skips the placement where none
// of its 32 does.
template <bool by_ord>
__device__ __forceinline__ int compact(const unsigned* row, int lo, u64 t,
                                       u64* cand) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const uint4* row4 = reinterpret_cast<const uint4*>(row);
  int count = 0;
#pragma unroll 4
  for (int i = 0; i < kVecs; ++i) {
    const uint4 o = row4[lane + 32 * i];
    const unsigned ord[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const u64 key = key_of(ord[e], lo + 4 * (lane + 32 * i) + e);
      const bool in = by_ord ? ord[e] >= static_cast<unsigned>(t >> 32)
                             : key >= t;
      const unsigned ballot = __ballot_sync(kFull, in);
      if (ballot) {
        const int p = count + __popc(ballot & below);
        if (in && p < kCap) cand[p] = key;
        count += __popc(ballot);
      }
    }
  }
  return count;
}

__device__ __forceinline__ int count_at_least(const unsigned* row, int lo,
                                              u64 t) {
  const int lane = threadIdx.x & 31;
  const uint4* row4 = reinterpret_cast<const uint4*>(row);
  unsigned c = 0;
#pragma unroll 4
  for (int i = 0; i < kVecs; ++i) {
    const uint4 o = row4[lane + 32 * i];
    const int id = lo + 4 * (lane + 32 * i);
    c += (key_of(o.x, id) >= t) + (key_of(o.y, id + 1) >= t) +
         (key_of(o.z, id + 2) >= t) + (key_of(o.w, id + 3) >= t);
  }
  return static_cast<int>(__reduce_add_sync(kFull, c));
}

// Sort the row's `count` candidates (R * 32 >= max(count, top_k)) and
// write the first top_k keys to out.
template <int R>
__device__ __forceinline__ void sort_candidates(const u64* cand, int count,
                                                int top_k, u64* out) {
  const int lane = threadIdx.x & 31;
  u64 v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = 32 * r + lane;
    v[r] = e < count ? cand[e] : 0ull;
  }
  warp_sort_desc<R>(v);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = 32 * r + lane;
    if (e < top_k) out[e] = v[r];
  }
}

// The row's `count` <= 32 R candidates placed by rank (how many candidates
// are larger; keys are distinct): the first top_k keys in order to out,
// zeros past `count`.  The warp reads each candidate once, as a broadcast.
template <int R>
__device__ __forceinline__ void rank_candidates(const u64* cand, int count,
                                                int top_k, u64* out) {
  const int lane = threadIdx.x & 31;
  u64 v[R];
  int rank[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = 32 * r + lane;
    v[r] = e < count ? cand[e] : 0ull;
    rank[r] = 0;
  }
#pragma unroll 4
  for (int j = 0; j < count; ++j) {
    const u64 o = cand[j];
#pragma unroll
    for (int r = 0; r < R; ++r) rank[r] += o > v[r];
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (32 * r + lane < count && rank[r] < top_k) out[rank[r]] = v[r];
  }
  for (int e = count + lane; e < top_k; e += 32) out[e] = 0ull;
}

// The warp's row of the score tile -> its exact top_k keys, sorted, in out
// (which may be the row itself: the row is read for the last time before
// out is written).
__device__ __forceinline__ void select_row(const unsigned* row, int lo,
                                           int top_k, u64* cand, u64* out,
                                           int* escalations) {
  unsigned tau, top;
  if (top_k <= 64) {
    group_threshold<4>(row, top_k, tau, top);
  } else if (top_k <= 128) {
    group_threshold<8>(row, top_k, tau, top);
  } else {
    group_threshold<16>(row, top_k, tau, top);
  }
  u64 a = static_cast<u64>(tau) << 32;  // keys of ords >= tau
  int count = compact<true>(row, lo, a, cand);
  if (count > kCap) {
    // count(a) > kCap >= top_k > count(b), so b - a >= 2 (keys are
    // distinct), mid lies strictly between them, and the loop ends at a
    // count in [top_k, kCap]
    u64 b = (static_cast<u64>(top) + 1) << 32;
    for (;;) {
      const u64 mid = a + ((b - a) >> 1);
      const int c = count_at_least(row, lo, mid);
      if (c < top_k) {
        b = mid;
      } else {
        a = mid;
        if (c <= kCap) break;
      }
    }
    __syncwarp();
    count = compact<false>(row, lo, a, cand);
    if ((threadIdx.x & 31) == 0 && escalations != nullptr) {
      atomicAdd(escalations, 1);
    }
  }
  __syncwarp();
  if (count <= 64) {
    rank_candidates<2>(cand, count, top_k, out);
  } else if (count <= 128) {
    rank_candidates<4>(cand, count, top_k, out);
  } else if (max(count, top_k) <= 256) {
    sort_candidates<8>(cand, count, top_k, out);
  } else {
    sort_candidates<16>(cand, count, top_k, out);
  }
}

// The number of live 2,048-token bank blocks that the callers launch for
// `valid` tokens (one at least, so that an empty bank still writes its
// dead slots).
__host__ __device__ __forceinline__ int live_blocks(int valid) {
  return valid > kBlk ? (valid + kBlk - 1) / kBlk : 1;
}

}  // namespace prune
