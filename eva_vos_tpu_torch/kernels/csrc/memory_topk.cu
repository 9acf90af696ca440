// Exact top-k memory selection for the STCN memory read (sm_90a), as raw
// scores vals[k, N] and int32 ids idx[k, N] (transposed: the layout the
// readout kernels read).  For every query n: the top_k memory tokens
// t < valid in descending order, ties to the LOWEST token id.  Slots left
// over when valid < top_k hold (-1e30, id 0); their softmax weight is
// exactly 0.
//
// memory_topk_launch replaces eva_vos_tpu/kernels/memory_topk.py:
// _kernel_tournament, reached through tournament_topk_t: the default read's
// selection.  memory_topk_chunked_launch replaces _kernel_tournament_chunked,
// reached through chunked_topk_t: the chunked read's selection, the same
// function read newest first.  Both run the two kernels below.
//
// The default selection: pruned bank blocks, merged into [k, N]
// ------------------------------------------------------------------------
// What bounds it: not the device-memory bytes (15 MB of keys at fill 72)
// nor the tensor-core rate (0.12 ms at fill 72, N = 8,100, CK = 64), but
// the block stage it shares with memory_topk_sort.cu (topk_prune.cuh).
// Each 16-query block stages its bank block's 256 KB of bf16 keys from L2
// (0.8 GB at fill 12, 7.6 GB at fill 72, N = 8,100) and then runs one warp
// per query through the threshold, compaction and ranking passes over 2,048
// scores; its 197 KB of shared memory allow one block an SM.  The sort
// kernel's times (PERF.md) put most of the block time in the row passes:
// their staging runs at ~2.2 TB/s, and top_k = 256, which changes only the
// row passes, takes several times the block time of top_k = 50.  The
// previous design (a serial insertion merge per 32-query block, FMA scores)
// spent its time in the merge while a query's list filled, which is all of
// a small bank: the frame-0 interact reads banks of 1 to 12 frames.
//
// Design.  The TPU kernel streams the bank through a running tournament of
// sorted lists, one per query.  Here the bank blocks are a grid dimension,
// and no list is kept across them:
//
//  1. topk_prune_block_kernel: grid (tiles of 16 queries) x (live 2,048-token
//     bank blocks; blocks past `valid` are never launched).  The block
//     scores its tile (bf16 keys by mma.sync on the tensor cores, fp32 keys
//     on the FP32 units, exactly) and prunes each query's row to the keys at
//     or above the k-th of its group maxima, with the exact escalation where
//     they overflow the 512-key list, then ranks them (topk_prune.cuh).
//     With several live blocks, query q's sorted k keys go to list b of a
//     buffer part[N, n_live, k] of 64-bit keys.  With ONE live block (up to
//     2,048 tokens: every first blocked step of an interact) the keys are
//     the answer: each warp writes them back over its own row of the score
//     tile, and the block stores them transposed, rows t of [k, N] as
//     16-query runs; the merge is not launched.
//  2. topk_merge_t_kernel (topk_prune.cuh, shared with
//     memory_topk_resident.cu): 32 queries a block, a half warp per query:
//     lane h holds the largest head of lists h, h + 16, ...; each output
//     slot is the half warp's largest head (four shuffle steps of 64-bit
//     keys), and only the lane whose list it came from advances that list.
//     The merged keys are staged in shared memory and stored transposed,
//     each row t of [k, N] one 128-byte run of the 32 queries' scores (and
//     of their ids): no [N, k] intermediate and no transpose.
//
// The newest-first selection: the same kernels, with a running floor
// ------------------------------------------------------------------
// What bounds it: the same block stage.  The TPU kernel's one idea beyond
// the default selection is order: it walks the bank newest first, since
// propagation queries are temporally next to the latest memories, and skips
// a sub-block with no score >= the running k-th score tau (the k-th best of
// the tokens seen so far, so tau <= the true k-th score <= every winner's:
// memory_topk.py:611-618).  Here the blocks run in parallel, so no list is
// seen "so far"; what carries over is a floor:
//
//  - newest first: grid row y takes bank block n_live - 1 - y, and blocks
//    are dispatched in grid order, so the newest blocks of every query tile
//    are scored first;
//  - a running floor per query in device memory (zeroed by the launch):
//    each ranked row with k keys raises it by atomicMax to its k-th key
//    (lowered to the least key of its score bits); each row reads it before
//    it compacts and keeps only keys at or above max(tau, floor).  A block's
//    k-th key is at most the query's true k-th key, so no winner is lost,
//    whatever the timing, and the result is the default selection's exactly.
//    A row whose largest key is below the floor writes a dead list and skips
//    the compaction and ranking (`floored` counts those rows); other rows
//    keep fewer candidates to rank.
//
// With no_skip the floor is off (the TPU kernel's sel_notau ablation): the
// default selection with the bank blocks reversed.  On banks where the newest
// block holds no better keys than any other (iid or periodic keys) the floor
// empties few rows; PERF.md records what it gives.

#include "topk_prune.cuh"

namespace {

using namespace prune;

// kNewest: grid row y is bank block n_live - 1 - y, and floor (null, or
// the running floors [n]) and floored (null, or one int32 counting the rows
// the floor emptied) are read.  The default selection is the instance
// without, so that none of the floor's code is in its kernel.
template <typename T, int CK, bool kNewest>
__global__ void __launch_bounds__(kThreads1, 1)
topk_prune_block_kernel(const T* __restrict__ qk, const T* __restrict__ mk,
                        u64* __restrict__ part, float* __restrict__ vals,
                        int* __restrict__ idx, int n, int valid, int top_k,
                        u64* floor, int* __restrict__ escalations,
                        int* floored) {
  extern __shared__ __align__(16) unsigned tile_smem[];
  const BlockSmem s = carve_block(tile_smem);
  const int q0 = blockIdx.x * kQT;
  const int b = kNewest ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int lo = b * kBlk;
  score_tile<T, CK>(qk, mk, n, q0, lo, min(lo + kBlk, valid), s);

  const int warp = threadIdx.x >> 5;
  const int q = q0 + warp;
  unsigned* row = s.tile + warp * kRowStride;
  const bool direct = gridDim.y == 1;  // one live block: no merge
  if (q < n) {
    u64* out = direct ? reinterpret_cast<u64*>(row)
                      : part + (static_cast<size_t>(q) * gridDim.y + b) *
                                   top_k;
    select_row(row, lo, top_k, s.cand + warp * kCap, out, escalations,
               kNewest && floor != nullptr ? floor + q : nullptr,
               kNewest ? floored : nullptr);
  }
  if (!direct) return;
  __syncthreads();
  const u64* keys = reinterpret_cast<const u64*>(s.tile);
  for (int e = threadIdx.x; e < top_k * kQT; e += kThreads1) {
    const int t = e / kQT;
    const int qq = e % kQT;
    if (q0 + qq < n) {
      float v;
      int id;
      unpack(keys[qq * (kRowStride / 2) + t], v, id);
      vals[static_cast<size_t>(t) * n + q0 + qq] = v;
      idx[static_cast<size_t>(t) * n + q0 + qq] = id;
    }
  }
}

template <typename T, int CK, bool kNewest>
int launch_pruned(const void* qk, const void* mk, u64* part, float* vals,
                  int* idx, int n, int valid, int top_k, int n_live,
                  u64* floor, int* escalations, int* floored,
                  cudaStream_t stream) {
  const size_t smem = block_smem_bytes(CK);
  cudaError_t err = cudaFuncSetAttribute(
      topk_prune_block_kernel<T, CK, kNewest>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kQT - 1) / kQT, n_live);
  topk_prune_block_kernel<T, CK, kNewest><<<grid, kThreads1, smem, stream>>>(
      static_cast<const T*>(qk), static_cast<const T*>(mk), part, vals, idx,
      n, valid, top_k, floor, escalations, floored);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_live == 1) return static_cast<int>(err);
  return launch_merge_t<kMergeQ>(part, vals, idx, n, top_k, n_live, stream);
}

// Both selections' checks and launch; floor as for topk_prune_block_kernel,
// zeroed here first.
int launch(const void* qk, const void* mk, void* vals, void* idx, int n,
           int valid, int ck, int top_k, int is_bf16, void* stream,
           void* part, int newest_first, void* floor, void* escalations,
           void* floored) {
  if (n <= 0) return 0;
  const int n_live = live_blocks(valid);
  if (ck != 64 || top_k < 1 || top_k > 256 || n_live > kMaxLists ||
      (n_live > 1 && part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  u64* f = n_live > 1 ? static_cast<u64*>(floor) : nullptr;  // one block
  if (f != nullptr) {
    const cudaError_t err = cudaMemsetAsync(f, 0, sizeof(u64) * n, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  u64* p = static_cast<u64*>(part);
  float* v = static_cast<float*>(vals);
  int* i = static_cast<int*>(idx);
  int* e = static_cast<int*>(escalations);
  int* fl = static_cast<int*>(floored);
  if (newest_first) {
    return is_bf16 ? launch_pruned<__nv_bfloat16, 64, true>(
                         qk, mk, p, v, i, n, valid, top_k, n_live, f, e, fl, s)
                   : launch_pruned<float, 64, true>(
                         qk, mk, p, v, i, n, valid, top_k, n_live, f, e, fl, s);
  }
  return is_bf16 ? launch_pruned<__nv_bfloat16, 64, false>(
                       qk, mk, p, v, i, n, valid, top_k, n_live, f, e, fl, s)
                 : launch_pruned<float, 64, false>(
                       qk, mk, p, v, i, n, valid, top_k, n_live, f, e, fl, s);
}

}  // namespace

extern "C" {

// qk [n, ck], mk [m >= valid, ck] row-major, 16-byte aligned, fp32
// (is_bf16 = 0) or bf16 (is_bf16 = 1), ck = 64 (the STCN key width);
// vals/idx [top_k, n]; 1 <= top_k <= 256.  part: [n, n_live, top_k] 64-bit
// scratch, n_live = max(1, ceil(valid / 2048)) <= 2,048, or null when
// n_live = 1 (no merge).  escalations: null, or one int32 on the device that
// counts the (query, bank block) rows that escalated.  Returns a cudaError_t
// code.
int memory_topk_launch(const void* qk, const void* mk, void* vals, void* idx,
                       int n, int valid, int ck, int top_k, int is_bf16,
                       void* stream, void* part, void* escalations) {
  return launch(qk, mk, vals, idx, n, valid, ck, top_k, is_bf16, stream, part,
                0, nullptr, escalations, nullptr);
}

// The newest-first selection with the running floor (no_skip = 1: without);
// qk, mk, vals, idx, part and escalations as for memory_topk_launch.  floor:
// [n] 64-bit scratch (null is allowed when no_skip = 1 or n_live = 1).
// floored: null, or one int32 on the device that counts the (query, bank
// block) rows that the floor emptied.
int memory_topk_chunked_launch(const void* qk, const void* mk, void* vals,
                               void* idx, int n, int valid, int ck, int top_k,
                               int no_skip, int is_bf16, void* stream,
                               void* part, void* floor, void* escalations,
                               void* floored) {
  if (!no_skip && floor == nullptr && live_blocks(valid) > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(qk, mk, vals, idx, n, valid, ck, top_k, is_bf16, stream, part,
                1, no_skip ? nullptr : floor, escalations, floored);
}

const char* memory_topk_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
