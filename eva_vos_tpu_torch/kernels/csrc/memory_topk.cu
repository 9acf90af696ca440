// Exact top-k memory selection for the STCN memory read (sm_90a): two
// kernels over one shared block selection (topk_common.cuh).
//
// topk_kernel replaces eva_vos_tpu/kernels/memory_topk.py:_kernel_tournament,
// reached through tournament_topk_t.  topk_chunked_kernel replaces
// _kernel_tournament_chunked, reached through chunked_topk_t.  Both return,
// for every query n, the top_k memory tokens t < valid in descending order,
// ties to the LOWEST token id, as raw scores vals[k, N] and int32 ids
// idx[k, N] (transposed: the layout the readout kernels read).  Slots left
// over when valid < top_k hold (-1e30, id 0); their softmax weight is
// exactly 0.
//
// What bounds them: the N x valid x CK products.  At the engine's blocked
// step (N = 8100 queries, valid up to 116,640 tokens, CK = 64) that is
// 1.2e11 flops against 15 MB of keys, far above the card's flops-per-byte
// ridge.  Once a query's list is warm few tokens beat its k-th score, but
// while it fills (the first tiles, and all of a small bank) the serial merge
// costs more than the products (PERF.md, chip_smoke.py).
//
// Design: one block of 8 warps per tile of 32 queries walks the whole bank
// in 128-token tiles (block_topk).  The loop over tiles stops at `valid`
// (the TPU kernel's live_blocks rule), so tokens past the bank's fill are
// never read.  The dot products run on the FMA units, not the tensor cores:
// right first, fast in a later change.
//
// topk_kernel walks the bank oldest first and admits a token when it beats
// its query's k-th (value, id).  topk_chunked_kernel walks it NEWEST first,
// from the fill down: propagation queries are temporally next to the latest
// memories, so the running k-th score tau rises within the first tiles.  It
// admits a token when its score is >= tau (not >, so a token that ties tau
// still reaches the insertion, whose (value desc, id asc) rule picks
// lax.top_k's winner), and a tile in which no query admits anything skips
// its merge.  Exactness (memory_topk.py:611-618): tau is the k-th best of a
// subset of the tokens, so tau <= the true k-th score <= the score of any
// true winner, which is therefore always admitted.  With no_skip every token
// is admitted and every tile merges (the TPU kernel's sel_notau ablation).

#include "topk_common.cuh"

namespace {

using namespace topk;

template <typename T, int CK>
__global__ void __launch_bounds__(kThreads, 2)
topk_kernel(const T* __restrict__ qk, const T* __restrict__ mk,
            float* __restrict__ out_vals, int* __restrict__ out_idx,
            int n, int valid, int top_k) {
  extern __shared__ __align__(16) float smem[];
  const TopkSmem s = carve(smem, CK, top_k);
  const int q = blockIdx.x * kQueries + (threadIdx.x & 31);
  float qv[CK];
  load_query<T, CK>(qk, q, q < n, qv);
  block_topk<T, CK>(qv, q < n, mk, 0, valid, top_k, false, kAdmitBeatsList, s);
  write_lists(s, out_vals, out_idx, n, q, top_k);
}

template <typename T, int CK>
__global__ void __launch_bounds__(kThreads, 2)
topk_chunked_kernel(const T* __restrict__ qk, const T* __restrict__ mk,
                    float* __restrict__ out_vals, int* __restrict__ out_idx,
                    int n, int valid, int top_k, int no_skip) {
  extern __shared__ __align__(16) float smem[];
  const TopkSmem s = carve(smem, CK, top_k);
  const int q = blockIdx.x * kQueries + (threadIdx.x & 31);
  float qv[CK];
  load_query<T, CK>(qk, q, q < n, qv);
  block_topk<T, CK>(qv, q < n, mk, 0, valid, top_k, true,
                    no_skip ? kAdmitAll : kAdmitTau, s);
  write_lists(s, out_vals, out_idx, n, q, top_k);
}

template <typename T, int CK>
int launch(const void* qk, const void* mk, float* vals, int* idx, int n,
           int valid, int top_k, int chunked, int no_skip,
           cudaStream_t stream) {
  const size_t smem = block_topk_smem_bytes(CK, top_k);
  const dim3 grid((n + kQueries - 1) / kQueries);
  const T* q = static_cast<const T*>(qk);
  const T* m = static_cast<const T*>(mk);
  cudaError_t err;
  if (chunked) {
    err = cudaFuncSetAttribute(topk_chunked_kernel<T, CK>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    topk_chunked_kernel<T, CK><<<grid, kThreads, smem, stream>>>(
        q, m, vals, idx, n, valid, top_k, no_skip);
  } else {
    err = cudaFuncSetAttribute(topk_kernel<T, CK>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    topk_kernel<T, CK><<<grid, kThreads, smem, stream>>>(q, m, vals, idx, n,
                                                         valid, top_k);
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* qk, const void* mk, void* vals, void* idx, int n,
             int valid, int ck, int top_k, int is_bf16, int chunked,
             int no_skip, void* stream) {
  float* v = static_cast<float*>(vals);
  int* i = static_cast<int*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  if (ck != 64) return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16) {
    return launch<__nv_bfloat16, 64>(qk, mk, v, i, n, valid, top_k, chunked,
                                     no_skip, s);
  }
  return launch<float, 64>(qk, mk, v, i, n, valid, top_k, chunked, no_skip, s);
}

}  // namespace

extern "C" {

// qk [n, ck], mk [m >= valid, ck] row-major, 16-byte aligned, fp32
// (is_bf16 = 0) or bf16 (is_bf16 = 1), ck = 64 (the STCN key width);
// vals/idx [top_k, n].  Returns a cudaError_t code.
int memory_topk_launch(const void* qk, const void* mk, void* vals, void* idx,
                       int n, int valid, int ck, int top_k, int is_bf16,
                       void* stream) {
  return dispatch(qk, mk, vals, idx, n, valid, ck, top_k, is_bf16, 0, 0,
                  stream);
}

// The newest-first selection with the tau skip (no_skip = 1 disables it);
// the same operands and outputs as memory_topk_launch.
int memory_topk_chunked_launch(const void* qk, const void* mk, void* vals,
                               void* idx, int n, int valid, int ck, int top_k,
                               int no_skip, int is_bf16, void* stream) {
  return dispatch(qk, mk, vals, idx, n, valid, ck, top_k, is_bf16, 1, no_skip,
                  stream);
}

const char* memory_topk_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
