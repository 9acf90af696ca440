// Exact top-k selection over an L2-resident key bank, walked newest first
// with a running k-th key per query (sm_90a).
//
// Replaces eva_vos_tpu/kernels/memory_topk.py:_kernel_resident, reached
// through resident_topk_t.  Same function and outputs as memory_topk.cu:
// for every query n the top_k tokens t < valid by (score desc, id asc), as
// raw scores vals[k, N] and int32 ids idx[k, N]; slots left over when
// valid < top_k hold (-1e30, id 0).  1 <= top_k <= 256; above (any top_k
// up to M, as the TPU kernel) the wrapper takes memory_topk.cu's radix
// select (memory_topk_radix_launch) instead.
//
// What bounds it: not the device-memory bytes (15 MB of bf16 keys at fill
// 72, read once from HBM) nor the tensor cores (121 GFLOP at fill 72,
// N = 8,100: 0.12 ms), but the instructions the SMs issue per score and per
// admitted key, and the latency of the sorts that the block waits for.  The
// pruned block stage of memory_topk.cu (topk_prune.cuh) stages every key
// once per 16-query tile (7.6 GB at fill 72, N = 8,100) and runs four row
// passes over each (query, 2,048-token block) row of scores.
//
// Design: the walk of resident_walk.cuh, whose notes give it whole (query
// tiles walking their segment of the bank newest first in TMA-staged
// 128-token steps, bf16 scores on the tensor cores, a running threshold per
// query, candidate buffers compacted in waves by a warp sort), with the
// transposed epilogue: with one segment the block stores [k, N] as runs of
// its queries; with several, topk_prune.cuh's topk_merge_t_kernel merges
// the segments' sorted lists.  memory_topk_iter.cu runs the same walk with
// the row epilogue, and cuts its buffers by a bisection in place of the
// sort.

#include "resident_walk.cuh"

extern "C" {

// See walk::launch_checked; vals/idx [top_k, n].  Returns a cudaError_t
// code.
int memory_topk_resident_launch(const void* qk, const void* mk, void* vals,
                                void* idx, void* part, int n, int valid,
                                int ck, int top_k, int segments,
                                void* compactions, int is_bf16,
                                void* stream) {
  return walk::launch_checked<false>(qk, mk, vals, idx, part, n, valid, ck,
                                     top_k, segments, compactions, 1, is_bf16,
                                     stream);
}

const char* memory_topk_resident_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
