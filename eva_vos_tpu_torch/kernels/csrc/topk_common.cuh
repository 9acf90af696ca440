// Shared pieces of the exact top-k selection kernels (sm_90a), through
// topk_prune.cuh (score_block and warp_softmax_row; topk_prune.cuh serves
// memory_topk.cu, memory_topk_sort.cu, memory_topk_grid.cu and, through
// resident_walk.cuh, memory_topk_resident.cu and memory_topk_iter.cu).
//
// All of them score memory token t for query n as
//     score(n, t) = (2 * <q_n, k_t> - |k_t|^2) / sqrt(CK)
// in fp32 and rank by (score desc, id asc), the order lax.top_k gives.
//
// Key widths.  Each kernel is built for the padded widths CKP 16, 32, 64,
// 128 and 256 (with_width), a template argument; keys of another width
// CK <= 256 reach it zero-padded to the next one by the wrapper
// (memory_topk.py:key_width states the rule).  A product with 0 is exactly
// 0, in fp32 and in the tensor core's sums, so the padded channels change
// no dot product and no |k|^2.  The true CK is a run-time argument and
// sets the scale alone (KeyScale).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace topk {

constexpr float kNegInf = -1e30f;
constexpr int kMaxKeyWidth = 256;

// The padded width CKP that keys CK wide (1 <= CK <= kMaxKeyWidth) take.
__host__ __device__ constexpr int padded_width(int ck) {
  return ck <= 16 ? 16 : ck <= 32 ? 32 : ck <= 64 ? 64 : ck <= 128 ? 128 : 256;
}

// f(std::integral_constant<int, CKP>) for the padded width of ck, which the
// caller has checked is in [1, kMaxKeyWidth]: the one place that lists the
// instantiated widths.  Built with -DTOPK_KEY_WIDTH=CKP, a library holds
// that width's instance alone and refuses keys of another
// (cudaErrorInvalidValue): kernels/build.py builds each selection library
// once per width, the five compilers side by side.
template <typename F>
int with_width(int ck, F&& f) {
#ifdef TOPK_KEY_WIDTH
  if (padded_width(ck) != TOPK_KEY_WIDTH) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return f(std::integral_constant<int, TOPK_KEY_WIDTH>{});
#else
  switch (padded_width(ck)) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return f(std::integral_constant<int, 256>{});
  }
#endif
}

// x / sqrt(ck) for the true key width ck, rounded as the plain read's
// division rounds it (sqrtf is correctly rounded, as the host's sqrt then
// rounded to fp32), with no division: q = x inv, then one correction by
// the exact remainder x - q root (an fma), which makes q the correctly
// rounded quotient (Markstein's theorem: inv is within half an ulp of
// 1 / root and q within one ulp of x / root; finite x).  Where sqrt(ck) is
// a power of two (`exact`: ck = 16, 64, 256) inv is exact and the quotient
// is x inv alone; callers branch on `exact` once for a run of scores
// (with_exact), so that ck = 64 pays one product a score.
struct KeyScale {
  float root;  // sqrt(ck)
  float inv;   // 1 / root, rounded
  bool exact;  // root a power of two
  __device__ explicit KeyScale(int ck)
      : root(sqrtf(static_cast<float>(ck))),
        inv(1.f / root),
        exact((ck & (ck - 1)) == 0 && (ck & 0x55555555) != 0) {}
  template <bool kExact>
  __device__ __forceinline__ float div(float x) const {
    if constexpr (kExact) return x * inv;
    const float q = x * inv;
    return fmaf(fmaf(-q, root, x), inv, q);
  }
};

// f(std::true_type) where the scale is exact, else f(std::false_type): a
// uniform branch around a run of scores, each copy of which scales them
// with KeyScale::div<kExact>.
template <typename F>
__device__ __forceinline__ void with_exact(const KeyScale& sc, F&& f) {
  if (sc.exact) {
    f(std::true_type{});
  } else {
    f(std::false_type{});
  }
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

__device__ __forceinline__ float neg_inf() {
  return __uint_as_float(0xff800000u);
}

// The dense score tile of the pruned block stage for fp32 keys
// (topk_prune.cuh's score_tile): the scores of queries
// [q0, q0 + QT) against tokens [lo, lo + BLK), handed to store(qq, j, score)
// for token lo + j < hi and to store.dead(qq, j) for the others.  Keys and
// queries are CKP wide (padded); sc scales by the true width.  The queries
// are staged once in s_q [QT][CKP] fp32 (zeros past n); thread j walks
// token lo + j's key in register chunks of at most 32 channels (so that
// nothing spills at CKP = 256), keeping the QT sums, and reads the queries
// from shared memory as broadcasts.  Each sum runs over the channels in
// order.  -0 is returned as +0, so that a score's bits order as the float.
// Every thread of the block calls it; it begins and ends with a barrier.
template <typename T, int CKP, int QT, int BLK, int THREADS, typename Store>
__device__ __forceinline__ void score_block(const T* qk, const T* mk, int n,
                                            int q0, int lo, int hi,
                                            const KeyScale& sc, float* s_q,
                                            Store& store) {
  for (int e = threadIdx.x; e < QT * CKP / 8; e += THREADS) {
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
    for (int i = 0; i < 8; ++i) s_q[qq * CKP + c + i] = v[i];
  }
  __syncthreads();
  constexpr int kPiece = CKP < 32 ? CKP : 32;  // channels held at once
  for (int j = threadIdx.x; j < BLK; j += THREADS) {
    const int tok = lo + j;
    if (tok >= hi) {
      for (int qq = 0; qq < QT; ++qq) store.dead(qq, j);
      continue;
    }
    const T* key = mk + static_cast<size_t>(tok) * CKP;
    float acc[QT];
#pragma unroll
    for (int qq = 0; qq < QT; ++qq) acc[qq] = 0.f;
    float sq = 0.f;
#pragma unroll 1
    for (int c0 = 0; c0 < CKP; c0 += kPiece) {
      float kv[kPiece];
#pragma unroll
      for (int c = 0; c < kPiece; c += 8) {
        load8(key + c0 + c, kv + c);
#pragma unroll
        for (int i = 0; i < 8; ++i) sq = fmaf(kv[c + i], kv[c + i], sq);
      }
#pragma unroll
      for (int qq = 0; qq < QT; ++qq) {
#pragma unroll
        for (int c = 0; c < kPiece; c += 4) {
          const float4 qv =
              *reinterpret_cast<const float4*>(s_q + qq * CKP + c0 + c);
          acc[qq] = fmaf(qv.x, kv[c], acc[qq]);
          acc[qq] = fmaf(qv.y, kv[c + 1], acc[qq]);
          acc[qq] = fmaf(qv.z, kv[c + 2], acc[qq]);
          acc[qq] = fmaf(qv.w, kv[c + 3], acc[qq]);
        }
      }
    }
    with_exact(sc, [&](auto exact) {
#pragma unroll
      for (int qq = 0; qq < QT; ++qq) {
        store(qq, j,
              sc.template div<decltype(exact)::value>(2.f * acc[qq] - sq) +
                  0.f);
      }
    });
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
