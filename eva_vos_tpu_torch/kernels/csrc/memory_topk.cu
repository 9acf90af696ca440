// Exact top-k memory selection for the STCN memory read (sm_90a).
//
// Replaces eva_vos_tpu/kernels/memory_topk.py:_kernel_tournament, reached
// through tournament_topk_t.  For every query n it returns the top_k memory
// tokens t < valid by
//     score(n, t) = (2 * <q_n, k_t> - |k_t|^2) / sqrt(CK)
// (fp32 accumulation), in descending order, ties to the LOWEST token id,
// as raw scores vals[k, N] and int32 ids idx[k, N] (transposed: the layout
// the readout kernel reads).  Slots left over when valid < top_k hold
// (-1e30, id 0); their softmax weight is exactly 0.
//
// What bounds it: the N x valid x CK products.  At the engine's blocked
// step (N = 8100 queries, valid up to 116,640 tokens, CK = 64) that is 1.2e11
// flops against 15 MB of keys, far above the card's flops-per-byte ridge.
// Once a query's list is warm few tokens beat its k-th score, but while it
// fills (the first tiles, and all of a small bank) the serial merge below
// costs more than the products: on an H100 this kernel takes ~1.2 ms for a
// 1,620-token bank and ~11 ms for 116,640 tokens (chip_smoke.py).
//
// Design: one block of 8 warps per tile of 32 queries; lane i of every warp
// owns query i and keeps it in 64 fp32 registers.  The bank is streamed in
// 128-token tiles through shared memory (converted to fp32 once, |k|^2
// computed while staging), so each staged key is reused by 32 queries and
// each warp reads it as a broadcast.  The warps split a tile's tokens; a
// token that beats its query's current k-th entry (value desc, id asc) is
// appended to that query's candidate buffer, and after the tile warp 0
// insertion-sorts the candidates into the per-query list in shared memory.
// The loop over tiles stops at `valid` (the TPU kernel's live_blocks rule),
// so tokens past the bank's fill are never read.  The dot products run on
// the FMA units, not the tensor cores: right first, fast in a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <typename T, int CK>
__global__ void __launch_bounds__(kThreads, 2)
topk_kernel(const T* __restrict__ qk, const T* __restrict__ mk,
            float* __restrict__ out_vals, int* __restrict__ out_idx,
            int n, int valid, int top_k) {
  extern __shared__ __align__(16) float smem[];
  float* tile = smem;                                   // [kTile][CK]
  float* tile_sq = tile + kTile * CK;                   // [kTile]
  float* list_v = tile_sq + kTile;                      // [top_k][kQueries]
  int* list_i = reinterpret_cast<int*>(list_v + top_k * kQueries);
  float* cand_v = reinterpret_cast<float*>(list_i + top_k * kQueries);
  int* cand_i = reinterpret_cast<int*>(cand_v + kQueries * kTile);
  int* cand_n = cand_i + kQueries * kTile;              // [kQueries]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q = blockIdx.x * kQueries + lane;
  const bool q_ok = q < n;
  const float scale = sqrtf(static_cast<float>(CK));

  float qv[CK];
#pragma unroll
  for (int c = 0; c < CK; c += 8) {
    if (q_ok) {
      load8(qk + static_cast<size_t>(q) * CK + c, qv + c);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) qv[c + i] = 0.f;
    }
  }
  for (int e = threadIdx.x; e < top_k * kQueries; e += kThreads) {
    list_v[e] = kNegInf;
    list_i[e] = 0;
  }
  if (threadIdx.x < kQueries) cand_n[threadIdx.x] = 0;

  const int row = threadIdx.x >> 1;        // tile row this thread stages
  const int half = threadIdx.x & 1;        // which half of its channels
  const int j0 = warp * kTokPerWarp;       // this warp's tokens in a tile

  for (int base = 0; base < valid; base += kTile) {
    // stage keys [base, base + kTile) as fp32, with |k|^2 summed as
    // (channels 0..CK/2) + (channels CK/2..CK)
    {
      const int tok = base + row;
      float part = 0.f;
      float* dst = tile + row * CK + half * (CK / 2);
      if (tok < valid) {
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
    __syncthreads();

    // the k-th entry as it stood before this tile; it only rises, so a
    // stale bound admits a superset and the insertion decides exactly
    const float thr_v = list_v[(top_k - 1) * kQueries + lane];
    const int thr_i = list_i[(top_k - 1) * kQueries + lane];
#pragma unroll
    for (int jj = 0; jj < kTokPerWarp; jj += 4) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < CK; c += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 kv =
              *reinterpret_cast<const float4*>(tile + (j0 + jj + u) * CK + c);
          acc[u] = fmaf(qv[c], kv.x, acc[u]);
          acc[u] = fmaf(qv[c + 1], kv.y, acc[u]);
          acc[u] = fmaf(qv[c + 2], kv.z, acc[u]);
          acc[u] = fmaf(qv[c + 3], kv.w, acc[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + jj + u;
        const int tok = base + j;
        if (q_ok && tok < valid) {
          const float s = (2.f * acc[u] - tile_sq[j]) / scale;
          if (better(s, tok, thr_v, thr_i)) {
            const int p = atomicAdd(&cand_n[lane], 1);
            cand_v[lane * kTile + p] = s;
            cand_i[lane * kTile + p] = tok;
          }
        }
      }
    }
    __syncthreads();

    // warp 0 merges each query's candidates into its sorted list; the next
    // tile's staging touches neither the lists nor the candidate buffers
    if (warp == 0) {
      const int cnt = cand_n[lane];
      for (int p = 0; p < cnt; ++p) {
        const float v = cand_v[lane * kTile + p];
        const int id = cand_i[lane * kTile + p];
        int pos = top_k - 1;
        if (!better(v, id, list_v[pos * kQueries + lane],
                    list_i[pos * kQueries + lane])) {
          continue;
        }
        while (pos > 0 && better(v, id, list_v[(pos - 1) * kQueries + lane],
                                 list_i[(pos - 1) * kQueries + lane])) {
          list_v[pos * kQueries + lane] = list_v[(pos - 1) * kQueries + lane];
          list_i[pos * kQueries + lane] = list_i[(pos - 1) * kQueries + lane];
          --pos;
        }
        list_v[pos * kQueries + lane] = v;
        list_i[pos * kQueries + lane] = id;
      }
      cand_n[lane] = 0;
    }
  }

  // each list column was written only by this lane of warp 0
  if (warp == 0 && q_ok) {
    for (int t = 0; t < top_k; ++t) {
      out_vals[static_cast<size_t>(t) * n + q] = list_v[t * kQueries + lane];
      out_idx[static_cast<size_t>(t) * n + q] = list_i[t * kQueries + lane];
    }
  }
}

size_t smem_bytes(int ck, int top_k) {
  return sizeof(float) * (static_cast<size_t>(kTile) * ck + kTile) +
         8 * static_cast<size_t>(top_k) * kQueries +
         8 * static_cast<size_t>(kQueries) * kTile + 4 * kQueries;
}

template <typename T, int CK>
int launch(const void* qk, const void* mk, float* vals, int* idx, int n,
           int valid, int top_k, cudaStream_t stream) {
  const size_t smem = smem_bytes(CK, top_k);
  cudaError_t err = cudaFuncSetAttribute(
      topk_kernel<T, CK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kQueries - 1) / kQueries);
  topk_kernel<T, CK><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qk), static_cast<const T*>(mk), vals, idx, n,
      valid, top_k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// qk [n, ck], mk [m >= valid, ck] row-major, 16-byte aligned, fp32
// (is_bf16 = 0) or bf16 (is_bf16 = 1), ck = 64 (the STCN key width);
// vals/idx [top_k, n].  Returns a cudaError_t code.
int memory_topk_launch(const void* qk, const void* mk, void* vals, void* idx,
                       int n, int valid, int ck, int top_k, int is_bf16,
                       void* stream) {
  float* v = static_cast<float*>(vals);
  int* i = static_cast<int*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  if (ck != 64) return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16) {
    return launch<__nv_bfloat16, 64>(qk, mk, v, i, n, valid, top_k, s);
  }
  return launch<float, 64>(qk, mk, v, i, n, valid, top_k, s);
}

const char* memory_topk_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
