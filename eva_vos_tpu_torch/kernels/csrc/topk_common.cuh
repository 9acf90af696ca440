// Shared pieces of the exact top-k selection kernels (sm_90a), through
// topk_prune.cuh (score_block and warp_softmax_row; topk_prune.cuh serves
// memory_topk.cu, memory_topk_sort.cu, memory_topk_grid.cu and, through
// resident_walk.cuh, memory_topk_resident.cu and memory_topk_iter.cu).
//
// All of them score memory token t for query n as
//     score(n, t) = (2 * <q_n, k_t> - |k_t|^2) / sqrt(CK)
// in fp32 and rank by (score desc, id asc), the order lax.top_k gives.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace topk {

constexpr float kNegInf = -1e30f;

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

__device__ __forceinline__ float neg_inf() {
  return __uint_as_float(0xff800000u);
}

// The dense score tile of the pruned block stage for fp32 keys
// (topk_prune.cuh's score_tile): the scores of queries
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
