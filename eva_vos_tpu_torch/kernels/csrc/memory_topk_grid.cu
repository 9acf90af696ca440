// Exact top-k selection by bank block with softmax weights, the 'select'
// read's selection (sm_90a).
//
// Replaces eva_vos_tpu/kernels/memory_topk.py:_kernel_grid, reached through
// pallas_memory_topk(method="grid") (the JAX engine's "pallas" memory read,
// the port's "select").  For every query n it returns the top_k memory
// tokens t < valid by (score desc, id asc), as row-major [N, top_k]: int32
// ids and either the softmax weights exp(v - v_0) / sum (fp32) or, with
// raw = 1, the raw scores.  Slots left over when valid < top_k hold the
// score -1e30 (weight exactly 0) and id 0.
//
// This is exactly the function of memory_topk_sort.cu (_kernel, "sort"),
// and on this card it runs exactly its device code: the row-output stage of
// topk_prune.cuh.  The two TPU kernels differ only in how the TPU walks
// the bank: _kernel loops over every bank block inside one grid step,
// _kernel_grid makes the bank blocks a sequential grid axis (pipelined key
// DMAs, blocks past the fill skipped) that carries the running top-k in
// VMEM; both merge each block's top k into it.  Here the bank blocks are a
// parallel grid dimension, only blocks below the fill are launched, and the
// blocks' lists are merged once: one design serves both.
//
// What bounds it: as memory_topk_sort.cu, not the device-memory bytes nor
// the tensor-core rate (0.12 ms at fill 72, N = 8,100), but the block
// stage.  Each 16-query block stages its 2,048-token bank block's 256 KB of
// bf16 keys from L2, scores them on the tensor cores, and runs one warp per
// query through the threshold, compaction and ranking passes over 2,048
// scores, at one block an SM (197 KB of shared memory).  The previous design
// (32-query blocks over bank splits, FMA scores, a serial insertion merge
// per split, then one thread per query merging the splits) took 10.8 ms at
// fill 72 (PERF.md); how that split between its parts was not measured.
//
// Design (topk_prune.cuh):
//  1. topk_rows_block_kernel: grid (tiles of 16 queries) x (live 2,048-token
//     bank blocks).  Each warp prunes its query's row to the keys at or
//     above the k-th of its group maxima (an exact bisection where they
//     overflow the 512-key list) and ranks them; the sorted k keys go to
//     list b of part[N, n_live, k].  With one live block (every first blocked
//     step of an interact, every single-frame step at fill 1) the warp writes
//     its query's row of weights and ids itself and no merge runs.
//  2. topk_rows_merge_kernel: a warp per query merges the n_live sorted
//     lists and writes the row, then the weights.

#include "topk_prune.cuh"

extern "C" {

// qk [n, ckp], mk [m >= valid, ckp] row-major, 16-byte aligned, fp32
// (is_bf16 = 0) or bf16 (is_bf16 = 1), ckp = topk::padded_width(ck) for
// keys ck wide, 1 <= ck <= 256 (the wrapper zero-pads them; ck sets the
// scale); part [n, n_live, top_k]
// 64-bit scratch, n_live = max(1, ceil(valid / 2048)) <= 6,000, or null when
// n_live = 1 (no merge); out_v/out_i [n, top_k]; 1 <= top_k <= 256.
// escalations: null, or one int32 on the device that counts the (query,
// bank block) rows that escalated.  Returns a cudaError_t code.
int memory_topk_grid_launch(const void* qk, const void* mk, void* part,
                            void* out_v, void* out_i, int n, int valid, int ck,
                            int top_k, int n_live, int raw, int is_bf16,
                            void* stream, void* escalations) {
  return prune::launch_rows_checked(qk, mk, part, out_v, out_i, n, valid,
                                    ck, top_k, n_live, raw, is_bf16, stream,
                                    escalations);
}

const char* memory_topk_grid_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
