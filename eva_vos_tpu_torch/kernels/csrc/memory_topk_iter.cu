// Exact top-k selection by iterative extraction (sm_90a).
//
// Replaces eva_vos_tpu/kernels/memory_topk.py:_kernel_iter (with
// _extract_topk and _place_block), reached through
// pallas_memory_topk(method="iterative"), the JAX package's default.  For
// every query n it returns the top_k memory tokens t < valid by (score desc,
// id asc), as row-major [N, top_k]: int32 ids and either the softmax weights
// exp(v - v_0) / sum (fp32) or, with raw = 1, the raw scores.  Slots left
// over when valid < top_k hold the score -1e30 (weight exactly 0) and id 0.
//
// What bounds it: the N x valid x CK products (2 * CK flops per query and
// token), as for every selection here; the k extraction passes per block
// come next.
//
// Design.  On the TPU one program per query tile walks the bank blocks in
// order, extracts each block's top k (k passes of max, argmax, mask-out)
// into a VMEM candidate buffer of n_blocks * k per query, and ends with one
// extraction over that buffer.  The per-block extractions do not depend on
// each other, so here the block loop is a grid dimension:
//
//  1. topk_iter_block_kernel: grid (tiles of 16 queries) x (live 2,048-token
//     bank blocks; blocks past `valid` are never launched, the live_blocks
//     rule).  The block scores its tile into shared memory (16 x 2,048 fp32 =
//     128 KB; score_block in topk_common.cuh), then warp w extracts query
//     w's k best by k passes: each lane keeps the best (score, column) of
//     the 64 columns it owns, a five-step shuffle picks the warp's best, the
//     lane that owned the winner masks it, and the whole warp rescans that
//     lane's 64 columns (two per lane and a second shuffle reduction).  A
//     lane owns the columns 32 i + ((lane + i) & 31), so that both its own
//     scan and the warp's rescan of it read 32 distinct banks.  The block's
//     k (score, id) pairs go to slots [b * k, (b + 1) * k) of the query's
//     row of the candidate buffer in device memory ([N, n_live * k], 185 MB
//     at N = 8,100 and a 72-slot bank).
//  2. topk_iter_final_kernel: one warp per query extracts the k best of its
//     candidate row the same way from device memory (the row is scratch, so
//     a winner is masked in place); lane l owns a contiguous run of the row,
//     so the warp's rescan of it is coalesced.  It writes the row of scores,
//     then the weights.
//
// Ties: a pass picks (score desc, column asc); the final pass picks (score
// desc, slot asc), and a lower slot is a lower block or, within a block, a
// lower id, so both give lax.top_k's lowest id.

#include "topk_common.cuh"

namespace {

using namespace topk;

constexpr int kQT = 16;                 // queries per block, one per warp
constexpr int kBlk = 2048;              // bank tokens per block (block_m)
constexpr int kThreads1 = 32 * kQT;     // 512
constexpr int kCols = kBlk / 32;        // score columns a lane owns: 64
constexpr int kFinalWarps = 8;

static_assert(kCols == 64, "the warp rescans a lane's columns two per lane");

// Column i of the lane's own and the lane that owns column c.
__device__ __forceinline__ int owned_col(int lane, int i) {
  return 32 * i + ((lane + i) & 31);
}
__device__ __forceinline__ int owner_of(int c) {
  return ((c & 31) - (c >> 5)) & 31;
}

struct ScoreTile {
  float* s;  // [kQT][kBlk]
  __device__ void operator()(int qq, int j, float v) { s[qq * kBlk + j] = v; }
  __device__ void dead(int qq, int j) { s[qq * kBlk + j] = neg_inf(); }
};

// The warp's best (value, column) by (value desc, column asc).
__device__ __forceinline__ void warp_best(float& v, int& c) {
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oc = __shfl_xor_sync(0xffffffffu, c, off);
    if (better(ov, oc, v, c)) {
      v = ov;
      c = oc;
    }
  }
}

template <typename T, int CK>
__global__ void __launch_bounds__(kThreads1, 1)
topk_iter_block_kernel(const T* __restrict__ qk, const T* __restrict__ mk,
                       float* __restrict__ cand_v, int* __restrict__ cand_i,
                       int n, int valid, int top_k) {
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;                       // [kQT][CK]
  ScoreTile tile{s_q + kQT * CK};
  const int q0 = blockIdx.x * kQT;
  const int lo = blockIdx.y * kBlk;
  score_block<T, CK, kQT, kBlk, kThreads1>(qk, mk, n, q0, lo,
                                           min(lo + kBlk, valid), s_q, tile);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q = q0 + warp;
  if (q >= n) return;
  float* row = tile.s + warp * kBlk;
  const size_t width = static_cast<size_t>(gridDim.y) * top_k;
  float* out_v = cand_v + q * width + static_cast<size_t>(blockIdx.y) * top_k;
  int* out_i = cand_i + q * width + static_cast<size_t>(blockIdx.y) * top_k;

  float bv = neg_inf();   // this lane's best of its own columns
  int bc = kBlk;
  for (int i = 0; i < kCols; ++i) {
    const int c = owned_col(lane, i);
    if (better(row[c], c, bv, bc)) {
      bv = row[c];
      bc = c;
    }
  }
  for (int t = 0; t < top_k; ++t) {
    float wv = bv;
    int wc = bc;
    warp_best(wv, wc);
    if (wv == neg_inf()) {  // no live token left in this block
      for (int u = t + lane; u < top_k; u += 32) {
        out_v[u] = kNegInf;
        out_i[u] = 0;
      }
      break;
    }
    const int owner = owner_of(wc);
    if (lane == owner) {
      out_v[t] = wv;
      out_i[t] = lo + wc;
      row[wc] = neg_inf();
    }
    __syncwarp();
    // the warp rescans the owner's columns i = lane and lane + 32
    const int c1 = owned_col(owner, lane);
    const int c2 = owned_col(owner, lane + 32);
    float rv = row[c1];
    int rc = c1;
    if (better(row[c2], c2, rv, rc)) {
      rv = row[c2];
      rc = c2;
    }
    warp_best(rv, rc);
    if (lane == owner) {
      bv = rv;
      bc = rc;
    }
  }
}

__global__ void __launch_bounds__(32 * kFinalWarps)
topk_iter_final_kernel(float* __restrict__ cand_v,
                       const int* __restrict__ cand_i,
                       float* __restrict__ out_v, int* __restrict__ out_i,
                       int n, int top_k, int width, int raw) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kFinalWarps + (threadIdx.x >> 5);
  if (q >= n) return;  // whole warps
  float* cv = cand_v + static_cast<size_t>(q) * width;
  const int* ci = cand_i + static_cast<size_t>(q) * width;
  float* ov = out_v + static_cast<size_t>(q) * top_k;
  int* oi = out_i + static_cast<size_t>(q) * top_k;

  // lane l owns slots [l * per, (l + 1) * per) of the row
  const int per = (width + 31) / 32;
  float bv = neg_inf();
  int bc = width;
  for (int c = lane * per; c < min((lane + 1) * per, width); ++c) {
    const float v = cv[c];
    if (better(v, c, bv, bc)) {
      bv = v;
      bc = c;
    }
  }
  for (int t = 0; t < top_k; ++t) {
    float wv = bv;
    int wc = bc;
    warp_best(wv, wc);  // width >= top_k: a candidate is always left
    const int owner = wc / per;
    if (lane == owner) {
      ov[t] = wv;
      oi[t] = ci[wc];
      cv[wc] = neg_inf();
    }
    __syncwarp();
    // the warp rescans the owner's run, coalesced
    float rv = neg_inf();
    int rc = width;
    const int end = min((owner + 1) * per, width);
    for (int c = owner * per + lane; c < end; c += 32) {
      const float v = cv[c];
      if (better(v, c, rv, rc)) {
        rv = v;
        rc = c;
      }
    }
    warp_best(rv, rc);
    if (lane == owner) {
      bv = rv;
      bc = rc;
    }
  }
  if (!raw) warp_softmax_row(ov, top_k);
}

size_t block_smem_bytes(int ck) {
  return sizeof(float) * (static_cast<size_t>(kQT) * ck +
                          static_cast<size_t>(kQT) * kBlk);
}

template <typename T, int CK>
int launch(const void* qk, const void* mk, float* cand_v, int* cand_i,
           float* out_v, int* out_i, int n, int valid, int top_k, int n_live,
           int raw, cudaStream_t stream) {
  const size_t smem = block_smem_bytes(CK);
  cudaError_t err = cudaFuncSetAttribute(
      topk_iter_block_kernel<T, CK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kQT - 1) / kQT, n_live);
  topk_iter_block_kernel<T, CK><<<grid, kThreads1, smem, stream>>>(
      static_cast<const T*>(qk), static_cast<const T*>(mk), cand_v, cand_i, n,
      valid, top_k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_iter_final_kernel<<<(n + kFinalWarps - 1) / kFinalWarps,
                           32 * kFinalWarps, 0, stream>>>(
      cand_v, cand_i, out_v, out_i, n, top_k, n_live * top_k, raw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// qk [n, ck], mk [m >= valid, ck] row-major, 16-byte aligned, fp32
// (is_bf16 = 0) or bf16 (is_bf16 = 1), ck = 64; cand_v/cand_i
// [n, n_live * top_k] scratch, n_live = max(1, ceil(valid / 2048));
// out_v/out_i [n, top_k]; 1 <= top_k <= 256.  Returns a cudaError_t code.
int memory_topk_iter_launch(const void* qk, const void* mk, void* cand_v,
                            void* cand_i, void* out_v, void* out_i, int n,
                            int valid, int ck, int top_k, int n_live, int raw,
                            int is_bf16, void* stream) {
  if (n <= 0) return 0;
  if (ck != 64 || top_k < 1 || top_k > 256 ||
      n_live != (valid > kBlk ? (valid + kBlk - 1) / kBlk : 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* cv = static_cast<float*>(cand_v);
  int* ci = static_cast<int*>(cand_i);
  float* ov = static_cast<float*>(out_v);
  int* oi = static_cast<int*>(out_i);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16, 64>(qk, mk, cv, ci, ov, oi, n, valid, top_k,
                                     n_live, raw, s);
  }
  return launch<float, 64>(qk, mk, cv, ci, ov, oi, n, valid, top_k, n_live,
                           raw, s);
}

const char* memory_topk_iter_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
