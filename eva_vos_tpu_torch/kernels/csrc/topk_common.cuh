// Shared pieces of the exact top-k selection kernels (sm_90a):
// memory_topk_resident.cu (the streaming block selection below),
// memory_topk_iter.cu and topk_prune.cuh (score_block and warp_softmax_row,
// at the end; topk_prune.cuh serves memory_topk.cu, memory_topk_sort.cu and
// memory_topk_grid.cu).
//
// All of them score memory token t for query n as
//     score(n, t) = (2 * <q_n, k_t> - |k_t|^2) / sqrt(CK)
// in fp32 and rank by (score desc, id asc), the order lax.top_k gives.
//
// A block of 8 warps owns 32 queries; lane i of every warp owns query i and
// keeps it in CK fp32 registers.  The bank is streamed in 128-token tiles
// through shared memory (converted to fp32 once, |k|^2 summed while
// staging), so each staged key is reused by 32 queries and each warp reads
// it as a broadcast; warp w scores tokens [16w, 16w + 16) of each tile.
//
// block_topk is the exact streaming selection of one block: a token that
// beats its query's k-th listed (value, id) is appended to that query's
// candidate buffer, and after the tile warp 0 insertion-sorts the candidates
// into the per-query list in shared memory.  When no thread admitted anything the
// merge is skipped (one __syncthreads_or).  The insertion compares
// (value desc, id asc), so the order in which tiles and warps find
// candidates never changes the result.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace topk {

constexpr int kQueries = 32;                 // queries per block, one per lane
constexpr int kWarps = 8;                    // warps sharing each bank tile
constexpr int kThreads = kQueries * kWarps;  // 256
constexpr int kTile = 128;                   // bank tokens per staged tile
constexpr int kTokPerWarp = kTile / kWarps;  // 16
constexpr float kNegInf = -1e30f;

static_assert(kThreads == 2 * kTile, "two staging threads per tile row");

__device__ __forceinline__ bool better(float v, int id, float ov, int oid) {
  return v > ov || (v == ov && id < oid);
}

// Eight consecutive elements (16 bytes of bf16, 32 of fp32) as fp32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// Query q's key as CK fp32 registers (zeros for a query past the end).
template <typename T, int CK>
__device__ __forceinline__ void load_query(const T* qk, int q, bool ok,
                                           float* qv) {
#pragma unroll
  for (int c = 0; c < CK; c += 8) {
    if (ok) {
      load8(qk + static_cast<size_t>(q) * CK + c, qv + c);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) qv[c + i] = 0.f;
    }
  }
}

// Stage keys [base, base + kTile) as fp32 rows, with |k|^2 summed as
// (channels 0..CK/2) + (channels CK/2..CK); rows at or past `end` are not
// read (their squared norm is 0 and they are never scored).  All threads of
// the block call it; the caller synchronises.
template <typename T, int CK>
__device__ __forceinline__ void stage_tile(const T* mk, int base, int end,
                                           float* tile, float* tile_sq) {
  const int row = threadIdx.x >> 1;        // tile row this thread stages
  const int half = threadIdx.x & 1;        // which half of its channels
  const int tok = base + row;
  float part = 0.f;
  float* dst = tile + row * CK + half * (CK / 2);
  if (tok < end) {
    const T* src = mk + static_cast<size_t>(tok) * CK + half * (CK / 2);
#pragma unroll
    for (int c = 0; c < CK / 2; c += 8) {
      float v[8];
      load8(src + c, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) part = fmaf(v[i], v[i], part);
      reinterpret_cast<float4*>(dst + c)[0] =
          make_float4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<float4*>(dst + c)[1] =
          make_float4(v[4], v[5], v[6], v[7]);
    }
  }
  const float other = __shfl_xor_sync(0xffffffffu, part, 1);
  if (half == 0) tile_sq[row] = part + other;
}

// Scores of staged tile rows j .. j+3 against the query in qv.
template <int CK>
__device__ __forceinline__ void score4(const float* qv, const float* tile,
                                       const float* tile_sq, int j,
                                       float* s) {
  const float scale = sqrtf(static_cast<float>(CK));
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < CK; c += 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 kv = *reinterpret_cast<const float4*>(tile + (j + u) * CK + c);
      acc[u] = fmaf(qv[c], kv.x, acc[u]);
      acc[u] = fmaf(qv[c + 1], kv.y, acc[u]);
      acc[u] = fmaf(qv[c + 2], kv.z, acc[u]);
      acc[u] = fmaf(qv[c + 3], kv.w, acc[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) s[u] = (2.f * acc[u] - tile_sq[j + u]) / scale;
}

struct TopkSmem {
  float* tile;     // [kTile][CK]
  float* tile_sq;  // [kTile]
  float* list_v;   // [top_k][kQueries]
  int* list_i;
  float* cand_v;   // [kQueries][kTile]
  int* cand_i;
  int* cand_n;     // [kQueries]
};

inline size_t block_topk_smem_bytes(int ck, int top_k) {
  return sizeof(float) * (static_cast<size_t>(kTile) * ck + kTile) +
         8 * static_cast<size_t>(top_k) * kQueries +
         8 * static_cast<size_t>(kQueries) * kTile + 4 * kQueries;
}

__device__ __forceinline__ TopkSmem carve(float* smem, int ck, int top_k) {
  TopkSmem s;
  s.tile = smem;
  s.tile_sq = s.tile + kTile * ck;
  s.list_v = s.tile_sq + kTile;
  s.list_i = reinterpret_cast<int*>(s.list_v + top_k * kQueries);
  s.cand_v = reinterpret_cast<float*>(s.list_i + top_k * kQueries);
  s.cand_i = reinterpret_cast<int*>(s.cand_v + kQueries * kTile);
  s.cand_n = s.cand_i + kQueries * kTile;
  return s;
}

// Exact top_k of tokens [lo, hi) for the block's 32 queries, left in
// s.list_v / s.list_i [top_k][kQueries] (value desc, id asc; slots left
// over when hi - lo < top_k hold (-1e30, 0)).  Tiles are walked from lo
// upwards.  Every thread of the block calls it; it ends with a barrier.
template <typename T, int CK>
__device__ __forceinline__ void block_topk(const float* qv, bool q_ok,
                                           const T* mk, int lo, int hi,
                                           int top_k, const TopkSmem& s) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int e = threadIdx.x; e < top_k * kQueries; e += kThreads) {
    s.list_v[e] = kNegInf;
    s.list_i[e] = 0;
  }
  if (threadIdx.x < kQueries) s.cand_n[threadIdx.x] = 0;

  const int j0 = warp * kTokPerWarp;       // this warp's tokens in a tile
  const int n_tiles = hi > lo ? (hi - lo + kTile - 1) / kTile : 0;
  for (int i = 0; i < n_tiles; ++i) {
    const int base = lo + i * kTile;
    stage_tile<T, CK>(mk, base, hi, s.tile, s.tile_sq);
    __syncthreads();

    // the k-th entry as it stood before this tile; it only rises, so a
    // stale bound admits a superset and the insertion decides exactly
    const float thr_v = s.list_v[(top_k - 1) * kQueries + lane];
    const int thr_i = s.list_i[(top_k - 1) * kQueries + lane];
    int admitted = 0;
#pragma unroll
    for (int jj = 0; jj < kTokPerWarp; jj += 4) {
      float sc[4];
      score4<CK>(qv, s.tile, s.tile_sq, j0 + jj, sc);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int tok = base + j0 + jj + u;
        if (q_ok && tok < hi && better(sc[u], tok, thr_v, thr_i)) {
          const int p = atomicAdd(&s.cand_n[lane], 1);
          s.cand_v[lane * kTile + p] = sc[u];
          s.cand_i[lane * kTile + p] = tok;
          admitted = 1;
        }
      }
    }
    // warp 0 merges each query's candidates into its sorted list; the next
    // tile's staging touches neither the lists nor the candidate buffers
    if (__syncthreads_or(admitted) && warp == 0) {
      const int cnt = s.cand_n[lane];
      for (int p = 0; p < cnt; ++p) {
        const float v = s.cand_v[lane * kTile + p];
        const int id = s.cand_i[lane * kTile + p];
        int pos = top_k - 1;
        if (!better(v, id, s.list_v[pos * kQueries + lane],
                    s.list_i[pos * kQueries + lane])) {
          continue;
        }
        while (pos > 0 && better(v, id, s.list_v[(pos - 1) * kQueries + lane],
                                 s.list_i[(pos - 1) * kQueries + lane])) {
          s.list_v[pos * kQueries + lane] = s.list_v[(pos - 1) * kQueries + lane];
          s.list_i[pos * kQueries + lane] = s.list_i[(pos - 1) * kQueries + lane];
          --pos;
        }
        s.list_v[pos * kQueries + lane] = v;
        s.list_i[pos * kQueries + lane] = id;
      }
      s.cand_n[lane] = 0;
    }
  }
  __syncthreads();
}

// The block's lists as transposed outputs vals/idx [top_k, n].
__device__ __forceinline__ void write_lists(const TopkSmem& s, float* vals,
                                            int* idx, int n, int q,
                                            int top_k) {
  if (threadIdx.x < kQueries && q < n) {
    for (int t = 0; t < top_k; ++t) {
      vals[static_cast<size_t>(t) * n + q] = s.list_v[t * kQueries + threadIdx.x];
      idx[static_cast<size_t>(t) * n + q] = s.list_i[t * kQueries + threadIdx.x];
    }
  }
}

__device__ __forceinline__ float neg_inf() {
  return __uint_as_float(0xff800000u);
}

// The dense score tile of the block-per-bank-block selections
// (memory_topk_iter.cu, and topk_prune.cuh for fp32 keys): the scores of queries
// [q0, q0 + QT) against tokens [lo, lo + BLK), handed to store(qq, j, score)
// for token lo + j < hi and to store.dead(qq, j) for the others.  The
// queries are staged once in s_q [QT][CK] fp32 (zeros past n); thread j
// keeps token lo + j's key in CK registers, so the queries are read from
// shared memory as broadcasts.  -0 is returned as +0, so that a score's
// bits order as the float.  Every thread of the block calls it; it begins
// and ends with a barrier.
template <typename T, int CK, int QT, int BLK, int THREADS, typename Store>
__device__ __forceinline__ void score_block(const T* qk, const T* mk, int n,
                                            int q0, int lo, int hi,
                                            float* s_q, Store& store) {
  for (int e = threadIdx.x; e < QT * CK / 8; e += THREADS) {
    const int qq = e / (CK / 8);
    const int c = (e % (CK / 8)) * 8;
    float v[8];
    if (q0 + qq < n) {
      load8(qk + static_cast<size_t>(q0 + qq) * CK + c, v);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) s_q[qq * CK + c + i] = v[i];
  }
  __syncthreads();
  const float scale = sqrtf(static_cast<float>(CK));
  for (int j = threadIdx.x; j < BLK; j += THREADS) {
    const int tok = lo + j;
    if (tok >= hi) {
      for (int qq = 0; qq < QT; ++qq) store.dead(qq, j);
      continue;
    }
    float kv[CK];
    float sq = 0.f;
#pragma unroll
    for (int c = 0; c < CK; c += 8) {
      load8(mk + static_cast<size_t>(tok) * CK + c, kv + c);
#pragma unroll
      for (int i = 0; i < 8; ++i) sq = fmaf(kv[c + i], kv[c + i], sq);
    }
#pragma unroll 2
    for (int qq = 0; qq < QT; ++qq) {
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < CK; c += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(s_q + qq * CK + c);
        acc = fmaf(qv.x, kv[c], acc);
        acc = fmaf(qv.y, kv[c + 1], acc);
        acc = fmaf(qv.z, kv[c + 2], acc);
        acc = fmaf(qv.w, kv[c + 3], acc);
      }
      store(qq, j, (2.f * acc - sq) / scale + 0.f);
    }
  }
  __syncthreads();
}

// A warp's output row [top_k] of raw scores (descending, written by this
// warp) -> its softmax weights exp(v - v_0) / sum, in place.
__device__ __forceinline__ void warp_softmax_row(float* row, int top_k) {
  __syncwarp();
  const int lane = threadIdx.x & 31;
  const float v0 = row[0];
  float z = 0.f;
  for (int t = lane; t < top_k; t += 32) z += expf(row[t] - v0);
#pragma unroll
  for (int off = 16; off; off >>= 1) z += __shfl_xor_sync(0xffffffffu, z, off);
  __syncwarp();
  for (int t = lane; t < top_k; t += 32) row[t] = expf(row[t] - v0) / z;
}

}  // namespace topk
