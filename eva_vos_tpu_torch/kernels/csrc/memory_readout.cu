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

template <typename T>
int launch(const void* mv, const float* vals, const int* idx, void* out,
           int n_obj, int n, int m, int cv, int top_k, cudaStream_t stream) {
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
// and idx [top_k, n] from memory_topk_launch (every id < m); out
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
