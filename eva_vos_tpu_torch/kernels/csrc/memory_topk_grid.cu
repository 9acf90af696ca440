// Split-bank exact top-k selection with softmax weights (sm_90a).
//
// Replaces eva_vos_tpu/kernels/memory_topk.py:_kernel_grid, reached through
// pallas_memory_topk(method="grid") (the JAX engine's "pallas" memory read,
// the port's "select").  For every query n it returns the top_k memory
// tokens t < valid by (score desc, id asc), as row-major [N, top_k]: int32
// ids and either the softmax weights exp(v - v_0) / sum (fp32) or, with
// raw = 1, the raw scores.  Slots left over when valid < top_k hold the
// score -1e30 (weight exactly 0) and id 0.
//
// What bounds it: the N x valid x CK products, as for memory_topk.cu.
//
// Design.  The TPU kernel made the bank a sequential grid axis that carries
// a running top-k in VMEM.  Here the bank is split across blocks instead:
// the grid is (tiles of 32 queries) x (bank splits), and only splits below
// the fill are launched (the live_blocks rule, memory_topk.py:988).  Each
// block runs the shared block selection (topk_common.cuh) over its split
// and writes that split's sorted list to a partial buffer [S, k, N]; a
// second kernel merges the S sorted lists of each query (one thread per
// query, S heads) and writes the weights.  memory_topk.cu gives every
// 32-query block the whole bank, so a single-frame step (N = 1,620) fills
// only 51 of the card's 132 SMs; splitting the bank gives such a step
// several blocks per SM.

#include "topk_common.cuh"

namespace {

using namespace topk;

constexpr int kMaxSplits = 16;
constexpr int kMergeThreads = 128;

template <typename T, int CK>
__global__ void __launch_bounds__(kThreads, 2)
topk_split_kernel(const T* __restrict__ qk, const T* __restrict__ mk,
                  float* __restrict__ part_v, int* __restrict__ part_i,
                  int n, int valid, int top_k, int split_len) {
  extern __shared__ __align__(16) float smem[];
  const TopkSmem s = carve(smem, CK, top_k);
  const int q = blockIdx.x * kQueries + (threadIdx.x & 31);
  const int lo = blockIdx.y * split_len;
  const int hi = min(lo + split_len, valid);
  float qv[CK];
  load_query<T, CK>(qk, q, q < n, qv);
  block_topk<T, CK>(qv, q < n, mk, lo, hi, top_k, false, kAdmitBeatsList, s);
  const size_t off = static_cast<size_t>(blockIdx.y) * top_k * n;
  write_lists(s, part_v + off, part_i + off, n, q, top_k);
}

__global__ void __launch_bounds__(kMergeThreads)
topk_merge_kernel(const float* __restrict__ part_v,
                  const int* __restrict__ part_i, float* __restrict__ out_v,
                  int* __restrict__ out_i, int n, int top_k, int n_splits,
                  int raw) {
  const int q = blockIdx.x * kMergeThreads + threadIdx.x;
  if (q >= n) return;
  int head[kMaxSplits];
  for (int s = 0; s < n_splits; ++s) head[s] = 0;
  float* ov = out_v + static_cast<size_t>(q) * top_k;
  int* oi = out_i + static_cast<size_t>(q) * top_k;
  for (int t = 0; t < top_k; ++t) {
    int best = -1;
    float bv = 0.f;
    int bi = 0;
    for (int s = 0; s < n_splits; ++s) {
      if (head[s] >= top_k) continue;
      const size_t e = (static_cast<size_t>(s) * top_k + head[s]) * n + q;
      const float v = part_v[e];
      const int id = part_i[e];
      if (best < 0 || better(v, id, bv, bi)) {
        best = s;
        bv = v;
        bi = id;
      }
    }
    ++head[best];
    ov[t] = bv;
    oi[t] = bi;
  }
  if (!raw) {
    const float v0 = ov[0];
    float z = 0.f;
    for (int t = 0; t < top_k; ++t) z += expf(ov[t] - v0);
    for (int t = 0; t < top_k; ++t) ov[t] = expf(ov[t] - v0) / z;
  }
}

template <typename T, int CK>
int launch(const void* qk, const void* mk, float* part_v, int* part_i,
           float* out_v, int* out_i, int n, int valid, int top_k,
           int split_len, int n_splits, int raw, cudaStream_t stream) {
  const size_t smem = block_topk_smem_bytes(CK, top_k);
  cudaError_t err = cudaFuncSetAttribute(
      topk_split_kernel<T, CK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kQueries - 1) / kQueries, n_splits);
  topk_split_kernel<T, CK><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qk), static_cast<const T*>(mk), part_v, part_i, n,
      valid, top_k, split_len);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_merge_kernel<<<(n + kMergeThreads - 1) / kMergeThreads, kMergeThreads,
                      0, stream>>>(part_v, part_i, out_v, out_i, n, top_k,
                                   n_splits, raw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// qk [n, ck], mk [m >= valid, ck] row-major, 16-byte aligned, fp32
// (is_bf16 = 0) or bf16 (is_bf16 = 1), ck = 64; part_v/part_i
// [n_splits, top_k, n] scratch; out_v/out_i [n, top_k].  Split s covers
// tokens [s * split_len, min((s + 1) * split_len, valid)); split_len is a
// multiple of 128 and 1 <= n_splits <= 16.  Returns a cudaError_t code.
int memory_topk_grid_launch(const void* qk, const void* mk, void* part_v,
                            void* part_i, void* out_v, void* out_i, int n,
                            int valid, int ck, int top_k, int split_len,
                            int n_splits, int raw, int is_bf16, void* stream) {
  if (n <= 0) return 0;
  if (ck != 64 || n_splits < 1 || n_splits > kMaxSplits || split_len <= 0 ||
      split_len % kTile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* pv = static_cast<float*>(part_v);
  int* pi = static_cast<int*>(part_i);
  float* ov = static_cast<float*>(out_v);
  int* oi = static_cast<int*>(out_i);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16, 64>(qk, mk, pv, pi, ov, oi, n, valid, top_k,
                                     split_len, n_splits, raw, s);
  }
  return launch<float, 64>(qk, mk, pv, pi, ov, oi, n, valid, top_k, split_len,
                           n_splits, raw, s);
}

const char* memory_topk_grid_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
