// Top-k weighted value readout for the STCN memory read, the default fused
// read's (sm_90a).
//
// Replaces eva_vos_tpu/kernels/memory_readout.py:_scatter_readout_kernel,
// reached through pallas_fused_readout.  Given the selection's raw scores
// vals[k, N] (descending) and token ids idx[k, N]:
//     out[o, n, :] = sum_t w_t * mv[o, idx[t, n], :] / sum_t w_t,
//     w_t = exp(vals[t, n] - vals[0, n]),
// accumulated in fp32 and written in mv's dtype.
//
// What bounds it: bytes.  Each query reads k value rows of CV elements
// (50 x 1 KB in bf16 at CV = 512) and does two flops per element read.
// The TPU kernel streamed the whole bank through VMEM and built a one-hot
// contribution matrix per block, because a TPU gathers rows badly.  A GPU
// gathers rows well, so this is a plain weighted gather: the bank is read
// only where a query selected a token, and neighbouring queries, which
// select neighbouring tokens, find those rows in L2.
//
// Design: one block per (tile of 16 queries, object).  The block stages the
// tile's weights and ids in shared memory once, read coalesced along the
// queries, then each 64-thread group walks one query at a time: its threads
// cover CV in 16-byte vectors (8 bf16 or 4 fp32), so every selected row is
// one coalesced 1 KB read in bf16.  The loop over t is unrolled so that
// several row loads are in flight.
//
// The chunked readout's stage (readout_common.cuh), which moves each
// distinct row once per query tile, took longer than this gather over the
// engine's frame-0 interact (0.96 against 0.76 device ms on an H100 80GB
// HBM3 at 700 W; PERF.md):
// at the engine's sharing (1.6 picks a distinct row of a 64-query tile) its
// sums do the gather's arithmetic and its plan and staging come on top.  So
// the default read keeps this kernel.
//
// Above 256 slots (readout_sliced_kernel): the staged weights and ids,
// 8 * 16 * top_k bytes, would outgrow the shared memory at top_k ~1,800,
// so the block stages them in slices of at most 256 slots (32 KB), sums
// each slice into per-thread fp32 accumulators (a group's four queries at
// once) and one running normaliser per query, and divides after the last
// slice: the same sums in the same order as the kernel above, so the same
// output bit for bit.  The value columns a thread owns are walked in an
// outer loop, each re-staging the slices (once at CV = 512 in bf16).  It
// is bound by the rows it gathers, as above: 0.67 ms at k = 512 and 2.79 ms
// at k = 2,048 (N = 8,100, CV = 512 bf16, H100 at 700 W; PERF.md).

#include "readout_common.cuh"

namespace {

constexpr int kGroup = 64;                  // threads per query
constexpr int kGroups = 4;                  // queries in flight per block
constexpr int kThreads = kGroup * kGroups;  // 256
constexpr int kQueriesPerBlock = 16;

template <typename T>
__global__ void __launch_bounds__(kThreads)
readout_kernel(const T* __restrict__ mv, const float* __restrict__ vals,
               const int* __restrict__ idx, T* __restrict__ out, int n, int m,
               int cv, int top_k) {
  extern __shared__ __align__(16) float smem[];
  float* w = smem;                                          // [16][top_k]
  int* ids = reinterpret_cast<int*>(w + kQueriesPerBlock * top_k);
  float* z = reinterpret_cast<float*>(ids + kQueriesPerBlock * top_k);

  const int o = blockIdx.y;
  const int q0 = blockIdx.x * kQueriesPerBlock;
  // neighbouring threads read neighbouring queries of one slot t
  for (int e = threadIdx.x; e < kQueriesPerBlock * top_k; e += kThreads) {
    const int t = e / kQueriesPerBlock;
    const int qq = e - t * kQueriesPerBlock;
    const int q = q0 + qq;
    float wt = 0.f;
    int id = 0;
    if (q < n) {
      wt = expf(vals[static_cast<size_t>(t) * n + q] - vals[q]);
      id = idx[static_cast<size_t>(t) * n + q];
    }
    w[qq * top_k + t] = wt;
    ids[qq * top_k + t] = id;
  }
  __syncthreads();
  if (threadIdx.x < kQueriesPerBlock) {
    float s = 0.f;
    for (int t = 0; t < top_k; ++t) s += w[threadIdx.x * top_k + t];
    z[threadIdx.x] = s;
  }
  __syncthreads();

  constexpr int kVec = Vec<T>::kN;
  const int g = threadIdx.x / kGroup;
  const int lane = threadIdx.x % kGroup;
  const T* bank = mv + static_cast<size_t>(o) * m * cv;
  for (int qq = g; qq < kQueriesPerBlock; qq += kGroups) {
    const int q = q0 + qq;
    if (q >= n) break;
    const float* wq = w + qq * top_k;
    const int* iq = ids + qq * top_k;
    const float zq = z[qq];
    for (int c = lane * kVec; c < cv; c += kGroup * kVec) {
      float acc[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] = 0.f;
#pragma unroll 5
      for (int t = 0; t < top_k; ++t) {
        float v[kVec];
        Vec<T>::load(bank + static_cast<size_t>(iq[t]) * cv + c, v);
        const float wt = wq[t];
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[i] = fmaf(wt, v[i], acc[i]);
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] /= zq;
      Vec<T>::store(out + (static_cast<size_t>(o) * n + q) * cv + c, acc);
    }
  }
}

constexpr int kSlice = 256;  // slots staged at a time above 256

template <typename T>
__global__ void __launch_bounds__(kThreads)
readout_sliced_kernel(const T* __restrict__ mv, const float* __restrict__ vals,
                      const int* __restrict__ idx, T* __restrict__ out, int n,
                      int m, int cv, int top_k) {
  __shared__ __align__(16) float w[kQueriesPerBlock * kSlice];
  __shared__ int ids[kQueriesPerBlock * kSlice];
  __shared__ float z[kQueriesPerBlock];

  constexpr int kVec = Vec<T>::kN;
  constexpr int kPer = kQueriesPerBlock / kGroups;  // a group's queries
  const int o = blockIdx.y;
  const int q0 = blockIdx.x * kQueriesPerBlock;
  const int g = threadIdx.x / kGroup;
  const int lane = threadIdx.x % kGroup;
  const T* bank = mv + static_cast<size_t>(o) * m * cv;
  float zq = 0.f;  // thread qq < 16: query qq's running sum of weights
  for (int c0 = 0; c0 < cv; c0 += kGroup * kVec) {
    const int c = c0 + lane * kVec;
    float acc[kPer][kVec];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[j][i] = 0.f;
    }
    for (int s0 = 0; s0 < top_k; s0 += kSlice) {
      const int len = min(kSlice, top_k - s0);
      __syncthreads();  // the previous slice is summed
      for (int e = threadIdx.x; e < kQueriesPerBlock * len; e += kThreads) {
        const int t = e / kQueriesPerBlock;
        const int qq = e - t * kQueriesPerBlock;
        const int q = q0 + qq;
        float wt = 0.f;
        int id = 0;
        if (q < n) {
          wt = expf(vals[static_cast<size_t>(s0 + t) * n + q] - vals[q]);
          id = idx[static_cast<size_t>(s0 + t) * n + q];
        }
        w[qq * kSlice + t] = wt;
        ids[qq * kSlice + t] = id;
      }
      __syncthreads();
      if (c0 == 0 && threadIdx.x < kQueriesPerBlock) {
        for (int t = 0; t < len; ++t) zq += w[threadIdx.x * kSlice + t];
      }
      if (c < cv) {
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int qq = g + kGroups * j;
          if (q0 + qq < n) {
            const float* wq = w + qq * kSlice;
            const int* iq = ids + qq * kSlice;
#pragma unroll 5
            for (int t = 0; t < len; ++t) {
              float v[kVec];
              Vec<T>::load(bank + static_cast<size_t>(iq[t]) * cv + c, v);
              const float wt = wq[t];
#pragma unroll
              for (int i = 0; i < kVec; ++i) acc[j][i] = fmaf(wt, v[i], acc[j][i]);
            }
          }
        }
      }
    }
    if (c0 == 0 && threadIdx.x < kQueriesPerBlock) z[threadIdx.x] = zq;
    __syncthreads();
    if (c < cv) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int qq = g + kGroups * j;
        const int q = q0 + qq;
        if (q < n) {
#pragma unroll
          for (int i = 0; i < kVec; ++i) acc[j][i] /= z[qq];
          Vec<T>::store(out + (static_cast<size_t>(o) * n + q) * cv + c, acc[j]);
        }
      }
    }
  }
}

template <typename T>
int launch_sliced(const void* mv, const float* vals, const int* idx, void* out,
                  int n_obj, int n, int m, int cv, int top_k,
                  cudaStream_t stream) {
  const dim3 grid((n + kQueriesPerBlock - 1) / kQueriesPerBlock, n_obj);
  readout_sliced_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(mv), vals, idx, static_cast<T*>(out), n, m, cv,
      top_k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* mv, const float* vals, const int* idx, void* out,
           int n_obj, int n, int m, int cv, int top_k, cudaStream_t stream) {
  if (top_k > kSlice) {
    return launch_sliced<T>(mv, vals, idx, out, n_obj, n, m, cv, top_k,
                            stream);
  }
  const size_t smem =
      8 * static_cast<size_t>(kQueriesPerBlock) * top_k + 4 * kQueriesPerBlock;
  cudaError_t err = cudaFuncSetAttribute(
      readout_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kQueriesPerBlock - 1) / kQueriesPerBlock, n_obj);
  readout_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(mv), vals, idx, static_cast<T*>(out), n, m, cv,
      top_k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// mv [n_obj, m, cv] row-major, 16-byte aligned, cv a multiple of 8; vals
// and idx [top_k, n] from memory_topk_launch or memory_topk_radix_launch
// (every id < m), any top_k >= 1 (above 256 the sliced kernel); out
// [n_obj, n, cv] in mv's dtype.  Returns a cudaError_t code.
int memory_readout_launch(const void* mv, const void* vals, const void* idx,
                          void* out, int n_obj, int n, int m, int cv,
                          int top_k, int is_bf16, void* stream) {
  if (n <= 0 || n_obj <= 0) return 0;
  const float* v = static_cast<const float*>(vals);
  const int* i = static_cast<const int*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16>(mv, v, i, out, n_obj, n, m, cv, top_k, s);
  }
  return launch<float>(mv, v, i, out, n_obj, n, m, cv, top_k, s);
}

const char* memory_readout_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
