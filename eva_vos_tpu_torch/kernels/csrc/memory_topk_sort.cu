// Exact top-k selection by pruning each bank block's scores to a few
// candidates, ranking those, and merging the blocks' sorted lists (sm_90a).
//
// Replaces eva_vos_tpu/kernels/memory_topk.py:_kernel (with _merge_topk),
// reached through pallas_memory_topk(method="sort").  The same function and
// outputs as memory_topk_iter.cu: for every query n the top_k memory tokens
// t < valid by (score desc, id asc), as row-major [N, top_k] int32 ids and
// softmax weights (or, with raw = 1, raw scores); slots left over when
// valid < top_k hold the score -1e30 (weight exactly 0) and id 0.
//
// What bounds it: not the device-memory bytes nor the tensor-core rate
// (0.12 ms at fill 72, N = 8,100), but the block's two phases, whose split
// is not measured.  Each 16-query block stages its bank block's 256 KB of
// bf16 keys from L2 (7.6 GB at fill 72, N = 8,100) for the scoring; then
// the per-row threshold, compaction and ranking passes over 2,048 scores
// run one warp a row at 16 warps an SM (the 197 KB of shared memory allow
// one block an SM), so their shuffle and ballot chains are exposed and do
// not overlap the next block's scoring.  The row passes are a large share:
// top_k = 256, which changes only them, takes several times the block time
// of top_k = 50.  No row is sorted whole: only ~k of its 2,048 keys can
// reach the output, and a full per-row sort was the previous design's cost.
//
// Design.  The TPU kernel runs lax.top_k on each bank block's scores and
// merges the block's sorted top k into a running sorted list, incumbent
// first on ties.  Here a candidate is one 64-bit key (score bits, ~id), so
// that one unsigned comparison is the (score desc, id asc) order.
//
//  1. topk_sort_block_kernel: grid (tiles of 16 queries) x (live 2,048-token
//     bank blocks; blocks past `valid` are never launched).  The block stage
//     shared with memory_topk.cu (topk_prune.cuh): the block scores its tile
//     into shared memory (bf16 keys on the tensor cores, fp32 keys on the
//     FP32 units), and warp w prunes query w's row to the keys at or above
//     the k-th group maximum, with an exact escalation where they overflow
//     the 512-key list, and ranks or sorts them.  The first k go to the
//     query's list b of a buffer [N, n_live, k] in device memory.
//  2. topk_sort_merge_kernel: one warp per query merges its n_live sorted
//     lists: lane l holds the heads of lists l, l + 32, ...; each output
//     slot is the warp's largest head (one shuffle reduction of 64-bit
//     keys), and only the lane whose list it came from advances that list.
//     It writes the row of scores, then the weights.

#include "topk_prune.cuh"

namespace {

using namespace prune;
using topk::warp_softmax_row;

constexpr int kMergeWarps = 8;

template <typename T, int CK>
__global__ void __launch_bounds__(kThreads1, 1)
topk_sort_block_kernel(const T* __restrict__ qk, const T* __restrict__ mk,
                       u64* __restrict__ part, int n, int valid, int top_k,
                       int* __restrict__ escalations) {
  extern __shared__ __align__(16) unsigned smem[];
  const BlockSmem s = carve_block(smem);
  const int q0 = blockIdx.x * kQT;
  const int lo = blockIdx.y * kBlk;
  score_tile<T, CK>(qk, mk, n, q0, lo, min(lo + kBlk, valid), s);

  const int warp = threadIdx.x >> 5;
  const int q = q0 + warp;
  if (q >= n) return;
  u64* out = part + (static_cast<size_t>(q) * gridDim.y + blockIdx.y) * top_k;
  select_row(s.tile + warp * kRowStride, lo, top_k, s.cand + warp * kCap, out,
             escalations);
}

__global__ void __launch_bounds__(32 * kMergeWarps)
topk_sort_merge_kernel(const u64* __restrict__ part, float* __restrict__ out_v,
                       int* __restrict__ out_i, int n, int top_k, int n_lists,
                       int raw) {
  extern __shared__ int heads[];  // [kMergeWarps][n_lists]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q = blockIdx.x * kMergeWarps + warp;
  if (q >= n) return;  // whole warps
  int* head = heads + warp * n_lists;
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
  if (!raw) warp_softmax_row(ov, top_k);
}

template <typename T, int CK>
int launch(const void* qk, const void* mk, u64* part, float* out_v,
           int* out_i, int n, int valid, int top_k, int n_live, int raw,
           int* escalations, cudaStream_t stream) {
  const size_t smem = block_smem_bytes(CK);
  cudaError_t err = cudaFuncSetAttribute(
      topk_sort_block_kernel<T, CK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kQT - 1) / kQT, n_live);
  topk_sort_block_kernel<T, CK><<<grid, kThreads1, smem, stream>>>(
      static_cast<const T*>(qk), static_cast<const T*>(mk), part, n, valid,
      top_k, escalations);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t merge_smem = sizeof(int) * kMergeWarps * n_live;
  err = cudaFuncSetAttribute(topk_sort_merge_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(merge_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_sort_merge_kernel<<<(n + kMergeWarps - 1) / kMergeWarps,
                           32 * kMergeWarps, merge_smem, stream>>>(
      part, out_v, out_i, n, top_k, n_live, raw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// qk [n, ck], mk [m >= valid, ck] row-major, 16-byte aligned, fp32
// (is_bf16 = 0) or bf16 (is_bf16 = 1), ck = 64; part [n, n_live, top_k]
// 64-bit scratch, n_live = max(1, ceil(valid / 2048)) <= 6,000; out_v/out_i
// [n, top_k]; 1 <= top_k <= 256.  escalations: null, or one int32 on the
// device that counts the (query, bank block) rows that escalated.  Returns
// a cudaError_t code.
int memory_topk_sort_launch(const void* qk, const void* mk, void* part,
                            void* out_v, void* out_i, int n, int valid, int ck,
                            int top_k, int n_live, int raw, int is_bf16,
                            void* stream, void* escalations) {
  if (n <= 0) return 0;
  if (ck != 64 || top_k < 1 || top_k > 256 || n_live > 6000 ||
      n_live != live_blocks(valid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  u64* p = static_cast<u64*>(part);
  float* ov = static_cast<float*>(out_v);
  int* oi = static_cast<int*>(out_i);
  int* e = static_cast<int*>(escalations);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16, 64>(qk, mk, p, ov, oi, n, valid, top_k,
                                     n_live, raw, e, s);
  }
  return launch<float, 64>(qk, mk, p, ov, oi, n, valid, top_k, n_live, raw, e,
                           s);
}

const char* memory_topk_sort_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
