// Chunk-major top-k weighted value readout (sm_90a).
//
// Replaces eva_vos_tpu/kernels/memory_readout.py:
// _scatter_readout_kernel_chunked, reached through pallas_fused_readout
// with readout_method="chunked".  The same function as memory_readout.cu:
// given the selection's raw scores vals[k, N] (descending) and ids idx[k, N],
//     out[o, n, :] = sum_t w_t * mv[o, idx[t, n], :] / sum_t w_t,
//     w_t = exp(vals[t, n] - vals[0, n]),
// accumulated in fp32 and written in mv's dtype.
//
// What bounds it: bytes, the distinct selected rows (1 KB each in bf16 at
// CV = 512), the selection (8 B a pick) and the output.
//
// Design: the device stage of readout_common.cuh (its note gives the
// design): a per-warp sort in registers and a bitmap of the tile's ids in
// place of the block-wide sort, each distinct row staged once per tile by a
// bulk TMA copy in ascending id order through an mbarrier ring, the bank
// walked chunk by chunk of 1,024 ids with the chunks that no selected id
// lands in skipped (the TPU kernel's sub-chunk skip,
// memory_readout.py:227,247).  With no_skip every chunk of the bank takes
// its own stages, empty ones included (the readout_noskip ablation); the
// output is the same, bit for bit.
//
// Above top_k 256 (any top_k, as the TPU kernel) the wrapper takes
// memory_readout.cu's readout_large_k_kernel instead: the same idea (each
// distinct row staged once per query tile), built for lists of any length,
// whose note gives its design; no_skip has no counterpart there.

#include "readout_common.cuh"

extern "C" {

// mv [n_obj, m, cv] row-major, 16-byte aligned, cv a multiple of 8; vals
// and idx [top_k, n] from a selection (every id < m), 1 <= top_k <= 256;
// out [n_obj, n, cv] in mv's dtype.  queries (64 only for top_k <= 64, or
// 32) and slices (at most kMaxCols * 32 16-byte columns a slice) as
// memory_readout.py:readout_geometry chooses them.  staged: null, or one
// int32 on the device that gains the rows staged.  Returns a cudaError_t
// code.
int memory_readout_chunked_launch(const void* mv, const void* vals,
                                  const void* idx, void* out, int n_obj,
                                  int n, int m, int cv, int top_k, int queries,
                                  int slices, int no_skip, int is_bf16,
                                  void* stream, void* staged) {
  if (n <= 0 || n_obj <= 0) return 0;
  const int nv = cv * (is_bf16 ? 2 : 4) / 16;  // 16-byte columns
  if (top_k < 1 || top_k > 256 || cv <= 0 || cv % 8 || slices < 1 ||
      slices > nv || (nv + slices - 1) / slices > 32 * readout::kMaxCols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* v = static_cast<const float*>(vals);
  const int* i = static_cast<const int*>(idx);
  int* counter = static_cast<int*>(staged);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return readout::launch_typed<__nv_bfloat16>(mv, v, i, out, n_obj, n, m,
                                                cv, top_k, queries, slices,
                                                no_skip, counter, s);
  }
  return readout::launch_typed<float>(mv, v, i, out, n_obj, n, m, cv, top_k,
                                      queries, slices, no_skip, counter, s);
}

const char* memory_readout_chunked_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
