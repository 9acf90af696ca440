// Exact top-k selection as [N, k] rows by a running-threshold walk over the
// L2-resident key bank (sm_90a).
//
// Replaces eva_vos_tpu/kernels/memory_topk.py:_kernel_iter (with
// _extract_topk and _place_block), reached through
// pallas_memory_topk(method="iterative"), the JAX package's default.  For
// every query n it returns the top_k memory tokens t < valid by (score desc,
// id asc), as row-major [N, top_k]: int32 ids and either the softmax weights
// exp(v - v_0) / sum (fp32) or, with raw = 1, the raw scores.  Slots left
// over when valid < top_k hold the score -1e30 (weight exactly 0) and id 0.
// 1 <= top_k <= 256; above (any top_k up to M, as the TPU kernel) the
// wrapper takes memory_topk.cu's radix select with its row epilogue
// (memory_topk_radix_launch, rows = 1 or 2) instead.
//
// What bounds it: the resident walk's (resident_walk.cuh), not the
// device-memory bytes nor the tensor cores (0.12 ms at fill 72,
// N = 8,100), but the instructions the SMs issue per score and per admitted
// key (the scores' compares with the thresholds and the appends of the
// keys above them), and the latency of the compactions that a block waits
// for; at top_k = 256 a block holds 32 queries, so each staged key serves
// half as many queries and a buffer holds up to 512 keys.
//
// Design.  On the TPU one program per query tile walks the bank blocks in
// order, extracts each block's top k (k passes of max, argmax, mask-out)
// into a VMEM candidate buffer of n_blocks * k per query, and ends with one
// extraction over that buffer.  Here the walk of resident_walk.cuh takes
// its place, with the row epilogue: per query tile of 64 (32 for
// top_k > 128) a block walks its segment of the bank newest first in
// TMA-staged 128-token steps, scores bf16 keys on the tensor cores,
// compares each score with its query's running k-th key in registers, and
// keeps only the keys above it in a candidate buffer in shared memory.
// Compaction waves cut the buffers back to k by a bisection for the k-th
// key in registers (no sort); after the walk each buffer's k keys are
// sorted by a warp.  No candidate goes through device memory and no key is
// extracted k times.  With one segment each warp writes its queries' rows
// (topk_prune.cuh's write_row, softmax included); with several
// (memory_topk.py:iter_segments: a bank too small to fill the card with
// tiles is cut into segments of at least 256 tokens, S k <= 512), the
// blocks write their sorted lists to part[N, S, k] and
// topk_rows_cut_kernel, one warp a query, cuts the S k keys to the k
// largest by the same bisection, sorts them and writes the row.  Ties: keys are
// (score bits, ~id), so one comparison gives (score desc, id asc),
// lax.top_k's lowest id, in any walking order.

#include "resident_walk.cuh"

extern "C" {

// See walk::launch_checked; out_v/out_i [n, top_k].  Returns a cudaError_t
// code.
int memory_topk_iter_launch(const void* qk, const void* mk, void* out_v,
                            void* out_i, void* part, int n, int valid, int ck,
                            int top_k, int segments, void* compactions,
                            int raw, int is_bf16, void* stream) {
  return walk::launch_checked<true>(qk, mk, out_v, out_i, part, n, valid, ck,
                                    top_k, segments, compactions, raw,
                                    is_bf16, stream);
}

const char* memory_topk_iter_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
