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
// that one unsigned comparison is the (score desc, id asc) order, and the
// bank blocks are a grid dimension: the row-output stage of topk_prune.cuh
// (topk_rows_block_kernel, then topk_rows_merge_kernel over the blocks'
// sorted lists; with one live block the block kernel writes the rows and no
// merge runs).  memory_topk_grid.cu launches the same stage: on this card
// one design serves both TPU kernels.

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
int memory_topk_sort_launch(const void* qk, const void* mk, void* part,
                            void* out_v, void* out_i, int n, int valid, int ck,
                            int top_k, int n_live, int raw, int is_bf16,
                            void* stream, void* escalations) {
  return prune::launch_rows_checked(qk, mk, part, out_v, out_i, n, valid,
                                    ck, top_k, n_live, raw, is_bf16, stream,
                                    escalations);
}

const char* memory_topk_sort_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
