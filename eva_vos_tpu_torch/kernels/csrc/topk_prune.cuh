// The pruned block stage of the exact top-k selections by bank block
// (sm_90a): memory_topk.cu (the default read's selection and the
// newest-first one) and, through the row-output stage at the end,
// memory_topk_sort.cu (select_topk's 'sort' method) and memory_topk_grid.cu
// (the 'select' read's selection).  A block scores a tile of 16 queries
// against one 2,048-token bank block and leaves, for each query, the block's
// exact top k as sorted 64-bit keys.  The resident walk (resident_walk.cuh,
// of memory_topk_resident.cu and memory_topk_iter.cu) takes its key format,
// tensor-core scoring pieces and warp sort, the transposed merge
// (topk_merge_t_kernel, after the block stage) and the row-output stage's
// write_row (at the end).
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
//     registers, CKP / 16 k16 steps, keys staged by cp.async in pieces of
//     at most 64 channels; score_block_mma), fp32 keys on the FP32 units
//     (score_block in topk_common.cuh), whose products stay exact where
//     TF32 would round them.  Keys are CKP wide (topk_common.cuh's padded
//     widths, a template argument); the true width ck sets the scale.
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
//        With a running floor (the newest-first selection), the threshold is
//        the larger of tau and the floor: a key that some already ranked
//        bank block of the query has k keys at or above (see select_row).
//     b. compaction: the keys of the columns at or above the threshold go
//        to the row's candidate list in shared memory (512 keys), placed by
//        warp ballot and popc.  For random scores ~1.2 k survive (62 at
//        k = 50).
//     c. escalation, exact: a row with more than 512 survivors (its winners
//        packed into fewer than k groups, or scores tied across the row)
//        bisects the key range between the threshold and its largest ord,
//        counting keys at or above the midpoint, until k to 512 keys are
//        left (keys are distinct, so a count never jumps by more than one),
//        and compacts again.  It adds one to `escalations` when that is
//        given.
//     d. up to 128 candidates are placed by rank (each lane counts the
//        candidates above its own, reading each once as a broadcast); more
//        are sorted by the warp in registers.  The first k keys, in order,
//        go to the caller's list (zeros past the live keys).
//
// memory_topk.py states the rules for the tests: SORT_CAPACITY is kCap,
// sort_prune_groups the group count, sort_prune_threshold the threshold,
// floored_lists and list_floor the running floor, merge_lists_t the merge.

#pragma once

#include <type_traits>

#include "topk_common.cuh"

namespace prune {

using topk::KeyScale;
using topk::kNegInf;
using topk::load8;
using topk::with_exact;

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
// chunks of 8 (one n8 tile), each staged as CKP / 64 pieces of 64 channels
// (one piece of CKP < 64), through a ring of kStages pieces
constexpr int kWarpToks = kBlk / kQT;        // 128
constexpr int kChunk = 8;
constexpr int kChunks = kWarpToks / kChunk;  // 16
constexpr int kStages = 4;
constexpr int kStageElems = kChunk * 64;     // bf16 of the largest piece

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

// Two bf16 of query q's key (channels c, c + 1; keys `width` wide), 0 past
// the last query.
__device__ __forceinline__ unsigned query_pair(const __nv_bfloat16* qk, int q,
                                               int n, int c, int width) {
  return q < n ? *reinterpret_cast<const unsigned*>(
                     qk + static_cast<size_t>(q) * width + c)
               : 0u;
}

// A staged piece of bf16 keys CKP wide: kW = min(CKP, 64) channels of 8
// token rows (kW * 2 bytes a row, kUnits 16-byte units), kPieces a key.
// Unit u of row r sits at unit u ^ ((r kUnits / 8) mod kUnits) of the row:
// u ^ r for 128-byte rows, u ^ (r / 2) mod 4 for 64-byte ones, u ^ (r / 4)
// mod 2 for 32-byte ones, the TMA's 128-, 64- and 32-byte swizzles.  Eight
// rows' unit u then lie in eight distinct 16-byte bank groups (ldmatrix's
// reads), and eight consecutive units of the piece cover 128 contiguous
// bytes (cp.async's stores).
template <int CKP>
struct Piece {
  static constexpr int kW = CKP < 64 ? CKP : 64;
  static constexpr int kPieces = CKP / kW;
  static constexpr int kUnits = kW / 8;
  static constexpr int kElems = 8 * kW;  // bf16 of a piece of 8 rows
  __device__ static __forceinline__ int at(int u, int r) {
    return u ^ ((r * kUnits / 8) & (kUnits - 1));
  }
};

// The bf16 counterpart of score_block: the ords of queries [q0, q0 + 16)
// against tokens [lo, lo + kBlk) on the tensor cores, keys CKP wide.  The
// queries are one m16 tile, held as A fragments for the whole block (CKP /
// 16 k16 steps).  Warp w's 128 tokens pass through its ring `stage` of
// kStages pieces (Piece: 8 token rows of at most 64 channels, swizzled so
// that both cp.async's stores and ldmatrix's reads hit distinct banks);
// kStages - 1 pieces are in flight while one is scored.  A chunk of 8
// tokens is one n8 tile: per piece one or two ldmatrix.x4 give its B
// fragments and one to four mma.sync add its 16 x 8 dot products into the
// chunk's accumulators (bf16 products are exact in fp32, summed in the
// tensor core's order); |k|^2 is an fp32 sum of the staged bf16 values
// (four lanes a token).  sc scales by the true width.  Ends with a barrier.
template <int CKP>
__device__ __forceinline__ void score_block_mma(const __nv_bfloat16* qk,
                                                const __nv_bfloat16* mk,
                                                int n, int q0, int lo, int hi,
                                                const KeyScale& sc,
                                                unsigned* tile,
                                                __nv_bfloat16* stage) {
  using P = Piece<CKP>;
  constexpr int kSteps = P::kW / 16;  // k16 steps of a piece
  constexpr int kUnitsLane = P::kUnits >= 4 ? P::kUnits / 4 : 1;  // |k|^2
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int quad = lane & 3;
  unsigned a[CKP / 16][4];
#pragma unroll
  for (int kk = 0; kk < CKP / 16; ++kk) {
    const int c = 16 * kk + 2 * quad;
    a[kk][0] = query_pair(qk, q0 + (lane >> 2), n, c, CKP);
    a[kk][1] = query_pair(qk, q0 + (lane >> 2) + 8, n, c, CKP);
    a[kk][2] = query_pair(qk, q0 + (lane >> 2), n, c + 8, CKP);
    a[kk][3] = query_pair(qk, q0 + (lane >> 2) + 8, n, c + 8, CKP);
  }
  const int col0 = warp * kWarpToks;  // the warp's first column
  stage += warp * kStages * kStageElems;
  // piece i: chunk i / kPieces, channels [kW (i % kPieces), + kW)
  auto issue = [&](int i) {
    if (i < kChunks * P::kPieces) {
      __nv_bfloat16* buf = stage + (i % kStages) * kStageElems;
      const int tok0 = lo + col0 + (i / P::kPieces) * kChunk;
      const int c0 = (i % P::kPieces) * P::kW;
#pragma unroll
      for (int e = lane; e < 8 * P::kUnits; e += 32) {
        const int row = e / P::kUnits;
        const int unit = e % P::kUnits;
        const int tok = tok0 + row;
        const bool live = tok < hi;
        cp_async16(buf + row * P::kW + (P::at(unit, row) << 3),
                   live ? mk + static_cast<size_t>(tok) * CKP + c0 + unit * 8
                        : mk,
                   live ? 16 : 0);
      }
    }
    cp_async_commit();  // an empty group past the last piece
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  for (int ch = 0; ch < kChunks; ++ch) {
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    float sq = 0.f;
#pragma unroll
    for (int p = 0; p < P::kPieces; ++p) {
      const int i = ch * P::kPieces + p;
      issue(i + kStages - 1);
      cp_async_wait<kStages - 1>();
      __syncwarp();
      const __nv_bfloat16* buf = stage + (i % kStages) * kStageElems;
      unsigned b[8];
      const int r = lane & 7;  // the row this lane addresses for ldmatrix
      ldmatrix_x4(b, buf + r * P::kW + (P::at((lane >> 3) % P::kUnits, r)
                                        << 3));
      if constexpr (P::kUnits == 8) {
        ldmatrix_x4(b + 4, buf + r * P::kW + (P::at((lane >> 3) + 4, r) << 3));
      }
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        mma_bf16(d, a[p * kSteps + kk], b[2 * kk], b[2 * kk + 1]);
      }
      // |k|^2: lane 4 t + quad sums units kUnitsLane quad + h of row t
#pragma unroll
      for (int h = 0; h < kUnitsLane; ++h) {
        const int u = kUnitsLane * quad + h;
        if (u < P::kUnits) {
          const int t = lane >> 2;
          float v[8];
          load8(buf + t * P::kW + (P::at(u, t) << 3), v);
#pragma unroll
          for (int e = 0; e < 8; ++e) sq = fmaf(v[e], v[e], sq);
        }
      }
      __syncwarp();  // the ring slot is free for the next issue
    }
    sq += __shfl_xor_sync(kFull, sq, 1);
    sq += __shfl_xor_sync(kFull, sq, 2);
    // this lane's columns: rows 2 quad, 2 quad + 1 of the chunk
    const float sq0 = __shfl_sync(kFull, sq, 8 * quad);
    const float sq1 = __shfl_sync(kFull, sq, 8 * quad + 4);
    const int col = col0 + ch * kChunk + 2 * quad;
    const bool live0 = lo + col < hi;
    const bool live1 = lo + col + 1 < hi;
    with_exact(sc, [&](auto exact) {
      constexpr bool kExact = decltype(exact)::value;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v0 = sc.template div<kExact>(2.f * d[2 * h] - sq0) + 0.f;
        const float v1 =
            sc.template div<kExact>(2.f * d[2 * h + 1] - sq1) + 0.f;
        *reinterpret_cast<uint2*>(tile + ((lane >> 2) + 8 * h) * kRowStride +
                                  col) =
            make_uint2(live0 ? ord_of(v0) : 0u, live1 ? ord_of(v1) : 0u);
      }
    });
  }
  __syncthreads();
}

// Shared memory of a block: [kQT][kRowStride] ords, then the bf16 staging
// ring [kQT warps][kStages pieces] or, once the tile is scored, the
// candidate lists [kQT][kCap], then the fp32 queries [kQT][CKP]: 211.6 KB
// at CKP = 256, within an SM's 227 KB.
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

constexpr size_t block_smem_bytes(int ckp) {
  return sizeof(unsigned) * static_cast<size_t>(kQT) * kRowStride +
         sizeof(u64) * static_cast<size_t>(kQT) * kCap +
         sizeof(float) * static_cast<size_t>(kQT) * ckp;
}
static_assert(block_smem_bytes(topk::kMaxKeyWidth) <= 232448,
              "a block's shared memory fits an SM at the widest keys");

// The ords of queries [q0, q0 + kQT) against tokens [lo, lo + kBlk) (dead
// at or past hi) into s.tile, keys CKP wide, scaled for keys ck wide.
// Every thread of the block calls it; it ends with a barrier.
template <typename T, int CKP>
__device__ __forceinline__ void score_tile(const T* qk, const T* mk, int n,
                                           int q0, int lo, int hi, int ck,
                                           const BlockSmem& s) {
  const KeyScale sc(ck);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    score_block_mma<CKP>(qk, mk, n, q0, lo, hi, sc, s.tile,
                         reinterpret_cast<__nv_bfloat16*>(s.cand));
  } else {
    OrdTile tile{s.tile};
    topk::score_block<T, CKP, kQT, kBlk, kThreads1>(qk, mk, n, q0, lo, hi, sc,
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
//
// floor, when not null, is the query's running floor in device memory (0
// before any bank block of the query is ranked): a key with low word 0 that
// the k-th key of some already ranked block of the query is at or above.
// The true k-th key of the query is at or above every block's k-th key, so
// every winner is at or above the floor, and the row keeps only keys at or
// above max(tau, floor).  The floor is read once (lane 0, before the
// compaction); a stale read is a lower floor and still below every winner,
// so the result is exact whatever the blocks' timing.  A row whose largest
// key is below the floor holds no winner: it writes a dead list (out[0] = 0,
// which a merge never advances past) and adds one to `floored` when that is
// given.  A row that keeps k keys raises the floor to its k-th key lowered
// to the least key of the same score bits (atomicMax).
__device__ __forceinline__ void select_row(const unsigned* row, int lo,
                                           int top_k, u64* cand, u64* out,
                                           int* escalations,
                                           u64* floor = nullptr,
                                           int* floored = nullptr) {
  const int lane = threadIdx.x & 31;
  unsigned tau, top;
  if (top_k <= 64) {
    group_threshold<4>(row, top_k, tau, top);
  } else if (top_k <= 128) {
    group_threshold<8>(row, top_k, tau, top);
  } else {
    group_threshold<16>(row, top_k, tau, top);
  }
  u64 a = static_cast<u64>(tau) << 32;  // keys of ords >= tau
  if (floor != nullptr) {
    u64 f = lane == 0 ? *reinterpret_cast<volatile u64*>(floor) : 0ull;
    f = __shfl_sync(kFull, f, 0);
    if (top < static_cast<unsigned>(f >> 32)) {  // every key below the floor
      if (lane == 0) {
        out[0] = 0ull;
        if (floored != nullptr) atomicAdd(floored, 1);
      }
      return;
    }
    a = max(a, f);  // both with low word 0: "ord >= a's high word" still
  }
  int count = compact<true>(row, lo, a, cand);
  if (count > kCap) {
    // count(a) > kCap >= top_k > count(b), so b - a >= 2 (keys are
    // distinct), mid lies strictly between them, and the loop ends at a
    // count in [top_k, kCap]; a raised by the floor keeps count(a) > kCap
    // and a key at or above a, so b > a still
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
    if (lane == 0 && escalations != nullptr) atomicAdd(escalations, 1);
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
  if (floor != nullptr) {
    __syncwarp();
    const u64 kth = out[top_k - 1];  // 0 when fewer than top_k were kept
    if (lane == 0 && kth != 0ull) atomicMax(floor, kth >> 32 << 32);
  }
}

// The number of live 2,048-token bank blocks that the callers launch for
// `valid` tokens (one at least, so that an empty bank still writes its
// dead slots).
__host__ __device__ __forceinline__ int live_blocks(int valid) {
  return valid > kBlk ? (valid + kBlk - 1) / kBlk : 1;
}

// The transposed merge: per query, the top_k keys of its n_lists sorted
// lists part[N, n_lists, k] -> vals/idx [k, N].  memory_topk.cu merges its
// bank blocks' lists with it, memory_topk_resident.cu its bank segments'.
// QB queries a block, a half warp per query: lane h holds the largest head
// of lists h, h + 16, ...; each output slot is the half warp's largest head
// (four shuffle steps of 64-bit keys), and only the lane whose list it came
// from advances that list.  The merged keys are staged in shared memory and
// stored transposed, each row t of [k, N] one run of the QB queries' scores
// (and of their ids): no [N, k] intermediate and no transpose.  (A
// template, so that a file that includes this header and launches no merge
// compiles none.)

constexpr int kMergeQ = 32;  // queries a merge block: 128-byte output runs
// Lists the merge takes (4,194,304 tokens of 2,048-token blocks): its u16
// heads and staged keys fit the shared memory up to here.
constexpr int kMaxLists = 2048;

template <int QB>
__global__ void __launch_bounds__(16 * QB)
topk_merge_t_kernel(const u64* __restrict__ part, float* __restrict__ vals,
                    int* __restrict__ idx, int n, int top_k, int n_lists) {
  // [QB][stride] merged keys (an odd stride, so that the transposed reads
  // spread over the banks), then [QB][n_lists] u16 list heads
  extern __shared__ __align__(16) u64 merged[];
  const int stride = top_k | 1;
  unsigned short* heads =
      reinterpret_cast<unsigned short*>(merged + QB * stride);
  const int hl = threadIdx.x & 15;  // lane in the half warp
  const int qq = threadIdx.x >> 4;
  const int q0 = blockIdx.x * QB;
  const bool live = q0 + qq < n;
  unsigned short* head = heads + qq * n_lists;
  const u64* lists =
      part + static_cast<size_t>(live ? q0 + qq : 0) * n_lists * top_k;
  u64* out = merged + qq * stride;

  for (int b = hl; b < n_lists; b += 16) head[b] = 0;
  __syncwarp();
  // this lane's largest head and its list (key 0: none left)
  auto best_head = [&](u64& key, int& list) {
    key = 0ull;
    list = 0;
    if (!live) return;
    for (int b = hl; b < n_lists; b += 16) {
      const int h = head[b];
      const u64 k = h < top_k ? lists[static_cast<size_t>(b) * top_k + h] : 0ull;
      if (k > key) {
        key = k;
        list = b;
      }
    }
  };
  u64 mine;
  int list;
  best_head(mine, list);
  // both half warps take top_k steps, so the shuffles stay converged
  for (int t = 0; t < top_k; ++t) {
    u64 win = mine;
#pragma unroll
    for (int off = 8; off; off >>= 1) {
      const u64 o = __shfl_xor_sync(kFull, win, off);
      win = o > win ? o : win;
    }
    if (hl == 0) out[t] = win;  // 0 once only dead keys are left
    if (win != 0ull && mine == win) {  // live keys are distinct: one lane
      ++head[list];
      best_head(mine, list);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < top_k * QB; e += 16 * QB) {
    const int t = e / QB;
    const int j = e % QB;
    if (q0 + j < n) {
      float v;
      int id;
      unpack(merged[j * stride + t], v, id);
      vals[static_cast<size_t>(t) * n + q0 + j] = v;
      idx[static_cast<size_t>(t) * n + q0 + j] = id;
    }
  }
}

// The merge of part's lists on `stream`; n_lists <= kMaxLists.  Returns a
// cudaError_t code.
template <int QB>
int launch_merge_t(const u64* part, float* vals, int* idx, int n, int top_k,
                   int n_lists, cudaStream_t stream) {
  const size_t smem =
      sizeof(u64) * QB * static_cast<size_t>(top_k | 1) +
      sizeof(unsigned short) * QB * static_cast<size_t>(n_lists);
  cudaError_t err = cudaFuncSetAttribute(
      topk_merge_t_kernel<QB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_merge_t_kernel<QB><<<(n + QB - 1) / QB, 16 * QB, smem, stream>>>(
      part, vals, idx, n, top_k, n_lists);
  return static_cast<int>(cudaGetLastError());
}

// The row-output stage: [N, k] rows of softmax weights (or raw scores) and
// int32 ids, for memory_topk_sort.cu and memory_topk_grid.cu, which compute
// the same function and launch the same two kernels.
//
//  1. topk_rows_block_kernel: grid (tiles of 16 queries) x (live 2,048-token
//     bank blocks; blocks past `valid` are never launched).  The block stage
//     above; with several live blocks query q's sorted k keys go to list b
//     of a buffer part[N, n_live, k] of 64-bit keys.  With ONE live block
//     (up to 2,048 tokens) they are the answer: each warp writes them over
//     its own row of the score tile and then its query's output row, softmax
//     included; the merge is not launched.
//  2. topk_rows_merge_kernel: one warp per query merges its n_live sorted
//     lists: lane l holds the heads of lists l, l + 32, ...; each output
//     slot is the warp's largest head (one shuffle reduction of 64-bit
//     keys), and only the lane whose list it came from advances that list.
//     It writes the row of scores, then the weights.

constexpr int kRowMergeWarps = 8;
// Lists the row merge takes (12,288,000 tokens): its int heads fit the
// shared memory up to here.
constexpr int kMaxRowLists = 6000;

// A warp's sorted keys [top_k] (written by this warp) -> its query's output
// row: the raw scores, or exp(v - v_0) / sum as warp_softmax_row computes
// them, and the ids.
__device__ __forceinline__ void write_row(const u64* keys, float* ov, int* oi,
                                          int top_k, int raw) {
  __syncwarp();
  const int lane = threadIdx.x & 31;
  float v0;
  int id0;
  unpack(keys[0], v0, id0);
  float z = 0.f;
  if (!raw) {
    for (int t = lane; t < top_k; t += 32) {
      float v;
      int id;
      unpack(keys[t], v, id);
      z += expf(v - v0);
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) z += __shfl_xor_sync(kFull, z, off);
  }
  for (int t = lane; t < top_k; t += 32) {
    float v;
    int id;
    unpack(keys[t], v, id);
    ov[t] = raw ? v : expf(v - v0) / z;
    oi[t] = id;
  }
}

template <typename T, int CKP>
__global__ void __launch_bounds__(kThreads1, 1)
topk_rows_block_kernel(const T* __restrict__ qk, const T* __restrict__ mk,
                       u64* __restrict__ part, float* __restrict__ out_v,
                       int* __restrict__ out_i, int n, int valid, int ck,
                       int top_k, int raw, int* __restrict__ escalations) {
  extern __shared__ __align__(16) unsigned rows_smem[];
  const BlockSmem s = carve_block(rows_smem);
  const int q0 = blockIdx.x * kQT;
  const int lo = blockIdx.y * kBlk;
  score_tile<T, CKP>(qk, mk, n, q0, lo, min(lo + kBlk, valid), ck, s);

  const int warp = threadIdx.x >> 5;
  const int q = q0 + warp;
  if (q >= n) return;
  unsigned* row = s.tile + warp * kRowStride;
  const bool direct = gridDim.y == 1;  // one live block: no merge
  u64* out = direct ? reinterpret_cast<u64*>(row)
                    : part + (static_cast<size_t>(q) * gridDim.y +
                              blockIdx.y) * top_k;
  select_row(row, lo, top_k, s.cand + warp * kCap, out, escalations);
  if (direct) {
    write_row(out, out_v + static_cast<size_t>(q) * top_k,
              out_i + static_cast<size_t>(q) * top_k, top_k, raw);
  }
}

// A template (on the output: raw scores or weights), so that a file that
// includes this header and launches no row merge compiles none.
template <bool kRaw>
__global__ void __launch_bounds__(32 * kRowMergeWarps)
topk_rows_merge_kernel(const u64* __restrict__ part, float* __restrict__ out_v,
                       int* __restrict__ out_i, int n, int top_k,
                       int n_lists) {
  extern __shared__ int rows_heads[];  // [kRowMergeWarps][n_lists]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q = blockIdx.x * kRowMergeWarps + warp;
  if (q >= n) return;  // whole warps
  int* head = rows_heads + warp * n_lists;
  const u64* lists = part + static_cast<size_t>(q) * n_lists * top_k;
  float* ov = out_v + static_cast<size_t>(q) * top_k;
  int* oi = out_i + static_cast<size_t>(q) * top_k;

  for (int b = lane; b < n_lists; b += 32) head[b] = 0;
  // this lane's largest head and its list (-1: none left)
  auto best_head = [&](u64& key, int& list) {
    key = 0ull;
    list = -1;
    for (int b = lane; b < n_lists; b += 32) {
      const int h = head[b];
      const u64 k = h < top_k ? lists[static_cast<size_t>(b) * top_k + h] : 0ull;
      if (list < 0 || k > key) {
        key = k;
        list = b;
      }
    }
  };
  u64 mine;
  int list;
  best_head(mine, list);
  for (int t = 0; t < top_k; ++t) {
    u64 win = mine;
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      const u64 o = __shfl_xor_sync(kFull, win, off);
      win = o > win ? o : win;
    }
    if (win == 0ull) {  // only dead keys left
      for (int u = t + lane; u < top_k; u += 32) {
        ov[u] = kNegInf;
        oi[u] = 0;
      }
      break;
    }
    if (mine == win) {  // live keys are distinct: one lane owns it
      unpack(win, ov[t], oi[t]);
      ++head[list];
      best_head(mine, list);
    }
  }
  if (!kRaw) topk::warp_softmax_row(ov, top_k);
}

// Both kernels of the row-output stage on `stream`, keys CKP wide (true
// width ck); part may be null when n_live = 1.  Returns a cudaError_t code.
template <typename T, int CKP>
int launch_rows(const void* qk, const void* mk, u64* part, float* out_v,
                int* out_i, int n, int valid, int ck, int top_k, int n_live,
                int raw, int* escalations, cudaStream_t stream) {
  const size_t smem = block_smem_bytes(CKP);
  cudaError_t err = cudaFuncSetAttribute(
      topk_rows_block_kernel<T, CKP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kQT - 1) / kQT, n_live);
  topk_rows_block_kernel<T, CKP><<<grid, kThreads1, smem, stream>>>(
      static_cast<const T*>(qk), static_cast<const T*>(mk), part, out_v, out_i,
      n, valid, ck, top_k, raw, escalations);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_live == 1) return static_cast<int>(err);
  const size_t merge_smem = sizeof(int) * kRowMergeWarps * n_live;
  auto merge = raw ? &topk_rows_merge_kernel<true>
                   : &topk_rows_merge_kernel<false>;
  err = cudaFuncSetAttribute(merge, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(merge_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  merge<<<(n + kRowMergeWarps - 1) / kRowMergeWarps, 32 * kRowMergeWarps,
          merge_smem, stream>>>(part, out_v, out_i, n, top_k, n_live);
  return static_cast<int>(cudaGetLastError());
}

// The C interface of memory_topk_sort.cu and memory_topk_grid.cu: keys
// topk::padded_width(ck) wide (ck in [1, 256]: the wrapper pads them),
// scaled for ck; checks the arguments and launches the row-output stage.
// (A template, as the kernels are, so that a file that includes this header
// and calls it not compiles none of them.)
template <int kUnused = 0>
int launch_rows_checked(const void* qk, const void* mk, void* part,
                        void* out_v, void* out_i, int n, int valid, int ck,
                        int top_k, int n_live, int raw, int is_bf16,
                        void* stream, void* escalations) {
  if (n <= 0) return 0;
  if (ck < 1 || ck > topk::kMaxKeyWidth || top_k < 1 || top_k > 256 ||
      n_live > kMaxRowLists || n_live != live_blocks(valid) ||
      (n_live > 1 && part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  u64* p = static_cast<u64*>(part);
  float* ov = static_cast<float*>(out_v);
  int* oi = static_cast<int*>(out_i);
  int* e = static_cast<int*>(escalations);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return topk::with_width(ck, [&](auto w) {
    constexpr int kW = decltype(w)::value;
    return is_bf16 ? launch_rows<__nv_bfloat16, kW>(qk, mk, p, ov, oi, n,
                                                    valid, ck, top_k, n_live,
                                                    raw, e, s)
                   : launch_rows<float, kW>(qk, mk, p, ov, oi, n, valid, ck,
                                            top_k, n_live, raw, e, s);
  });
}

}  // namespace prune
