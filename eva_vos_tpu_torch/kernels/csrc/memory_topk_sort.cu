// Exact top-k selection by per-block sort and a merge of sorted lists
// (sm_90a).
//
// Replaces eva_vos_tpu/kernels/memory_topk.py:_kernel (with _merge_topk),
// reached through pallas_memory_topk(method="sort").  The same function and
// outputs as memory_topk_iter.cu: for every query n the top_k memory tokens
// t < valid by (score desc, id asc), as row-major [N, top_k] int32 ids and
// softmax weights (or, with raw = 1, raw scores); slots left over when
// valid < top_k hold the score -1e30 (weight exactly 0) and id 0.
//
// What bounds it: the N x valid x CK products; the sorting networks come
// next.
//
// Design.  The TPU kernel runs lax.top_k on each bank block's scores and
// merges the block's sorted top k into a running sorted list, incumbent
// first on ties.  Here each candidate is one 64-bit key: the score's bits,
// mapped so that unsigned order is float order, in the high word and ~id in
// the low word, so that one unsigned comparison is the (score desc, id asc)
// order and a sorting network over keys keeps lax.top_k's tie rule exactly.
// A dead token's key is 0, below every live one.
//
//  1. topk_sort_block_kernel: grid (tiles of 8 queries) x (live 2,048-token
//     bank blocks; blocks past `valid` are never launched).  The block
//     scores its tile (score_block in topk_common.cuh) into keys in shared
//     memory (8 x 2,048 x 8 B = 128 KB) and sorts each query's 2,048 keys to
//     their top k2 (k rounded up to a power of two, at least 64) with
//     bitonic networks: runs of 64 keys are sorted in registers (32 keys a
//     thread, the last stage across a lane pair by shuffles); then each row
//     is halved until one run is left: two neighbouring runs, one sorted
//     each way, become their elementwise maximum, which holds the larger k2
//     of the two as a bitonic sequence, and a bitonic merge sorts it.  The
//     first k keys go to the query's list b of a buffer [N, n_live, k] in
//     device memory.
//  2. topk_sort_merge_kernel: one warp per query merges its n_live sorted
//     lists: lane l holds the heads of lists l, l + 32, ...; each output
//     slot is the warp's largest head (one shuffle reduction of 64-bit
//     keys), and only the lane whose list it came from advances that list.
//     It writes the row of scores, then the weights.

#include "topk_common.cuh"

namespace {

using namespace topk;

constexpr int kQT = 8;                  // queries per block
constexpr int kBlk = 2048;              // bank tokens per block (block_m)
constexpr int kThreads1 = 512;
constexpr int kMergeWarps = 8;

__device__ __forceinline__ unsigned long long pack(float v, int id) {
  const unsigned u = __float_as_uint(v);
  const unsigned ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(ord) << 32) |
         static_cast<unsigned>(~id);
}

__device__ __forceinline__ void unpack(unsigned long long key, float& v,
                                       int& id) {
  if (key == 0ull) {  // dead
    v = kNegInf;
    id = 0;
    return;
  }
  const unsigned ord = static_cast<unsigned>(key >> 32);
  v = __uint_as_float((ord & 0x80000000u) ? (ord & 0x7fffffffu) : ~ord);
  id = static_cast<int>(~static_cast<unsigned>(key));
}

// Keys of the block's rows [kQT][kBlk] sit in shared memory slot-major:
// logical key L (row L / kBlk) is thread L / 32's slot L % 32, at
// (L % 32) * kPad + L / 32.  A thread's 32 slots are then read and written
// by the warp from consecutive addresses, and the scoring threads' writes
// (consecutive L) are two-way bank conflicts (kPad is odd).
constexpr int kPad = kQT * kBlk / 32 + 1;  // 513
constexpr int kLgBlk = 11;
constexpr int kRun = 64;                   // keys a thread pair sorts

static_assert(kQT * kBlk == 32 * kThreads1, "32 keys per thread");
static_assert((1 << kLgBlk) == kBlk, "kLgBlk");

__device__ __forceinline__ int slot_addr(int l) {
  return (l & 31) * kPad + (l >> 5);
}

struct KeyTile {
  unsigned long long* k;  // slot-major, see slot_addr
  int lo;
  __device__ void operator()(int qq, int j, float v) {
    k[slot_addr(qq * kBlk + j)] = pack(v, lo + j);
  }
  __device__ void dead(int qq, int j) { k[slot_addr(qq * kBlk + j)] = 0ull; }
};

// Order x, y descending (desc) or ascending.
__device__ __forceinline__ void cmp_swap(unsigned long long& x,
                                         unsigned long long& y, bool desc) {
  if ((x < y) == desc) {
    const unsigned long long t = x;
    x = y;
    y = t;
  }
}

// One step of a bitonic network over kQT rows of 2^lg keys each: pairs
// (a, a + stride) of each row, descending where (a & dir_bit) == 0.  Keys
// at slot-major addresses (slot_addr) or row-major ones.
__device__ __forceinline__ void bitonic_step(unsigned long long* keys, int lg,
                                             int stride, int dir_bit,
                                             bool slot_major) {
  const int pairs_lg = lg - 1;
  for (int p = threadIdx.x; p < (kQT << pairs_lg); p += kThreads1) {
    const int r = p >> pairs_lg;
    const int i = p & ((1 << pairs_lg) - 1);
    const int a = ((i & ~(stride - 1)) << 1) | (i & (stride - 1));
    const int la = (r << lg) + a;
    const int ia = slot_major ? slot_addr(la) : la;
    const int ib = slot_major ? slot_addr(la + stride) : la + stride;
    unsigned long long x = keys[ia];
    unsigned long long y = keys[ib];
    cmp_swap(x, y, (a & dir_bit) == 0);
    keys[ia] = x;
    keys[ib] = y;
  }
  __syncthreads();
}

template <typename T, int CK>
__global__ void __launch_bounds__(kThreads1, 1)
topk_sort_block_kernel(const T* __restrict__ qk, const T* __restrict__ mk,
                       unsigned long long* __restrict__ part, int n,
                       int valid, int top_k) {
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;                       // [kQT][CK]
  const int q0 = blockIdx.x * kQT;
  const int lo = blockIdx.y * kBlk;
  unsigned long long* src =
      reinterpret_cast<unsigned long long*>(s_q + kQT * CK);  // [32][kPad]
  unsigned long long* dst = src + 32 * kPad;  // [kQT][kBlk / 2] row-major
  KeyTile tile{src, lo};
  score_block<T, CK, kQT, kBlk, kThreads1>(qk, mk, n, q0, lo,
                                           min(lo + kBlk, valid), s_q, tile);

  // 1. runs of 64 keys sorted, descending for even runs and ascending for
  // odd ones (bitonic sort, direction bit 64), in registers: thread t holds
  // keys [32 t, 32 t + 32) and sorts them with sizes 2..32; the size-64
  // stage pairs it with thread t ^ 1 (the next lane) by shuffles.
  const int t = threadIdx.x;
  unsigned long long v[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) v[j] = src[j * kPad + t];
#pragma unroll
  for (int size = 2; size <= 2 * 32; size <<= 1) {
    // direction of key 32 t + j: bit `size` of it
    const bool odd_t = size == 32 ? (t & 1) : size == 64 ? ((t >> 1) & 1) : 0;
    if (size == 64) {  // stride 32: the pair straddles threads t, t ^ 1
      const bool keep_max = ((t & 1) == 0) == !odd_t;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const unsigned long long o = __shfl_xor_sync(0xffffffffu, v[j], 1);
        v[j] = keep_max ? (o > v[j] ? o : v[j]) : (o < v[j] ? o : v[j]);
      }
    }
#pragma unroll
    for (int stride = (size == 64 ? 32 : size) >> 1; stride > 0;
         stride >>= 1) {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        if ((j & stride) == 0) {
          const bool desc = size >= 32 ? !odd_t : (j & size) == 0;
          cmp_swap(v[j], v[j + stride], desc);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 32; ++j) src[j * kPad + t] = v[j];
  __syncthreads();

  // runs of k2 >= top_k (a power of two): sizes past 64 in shared memory
  const int lg_k2 = max(6, 32 - __clz(top_k - 1));
  const int k2 = 1 << lg_k2;
  for (int size = 2 * kRun; size <= k2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      bitonic_step(src, kLgBlk, stride, size, true);
    }
  }

  // 2. halve each row until one run is left: runs 2g (descending) and
  // 2g + 1 (ascending) -> their elementwise maximum, a bitonic sequence
  // holding the larger k2 of the two, which a bitonic merge sorts (even
  // runs descending, odd ones ascending; the last run descending).
  bool slot_major = true;
  for (int lg = kLgBlk; lg > lg_k2; --lg) {
    const int half = 1 << (lg - 1);
    for (int e = threadIdx.x; e < kQT * half; e += kThreads1) {
      const int r = e >> (lg - 1);
      const int j = e & (half - 1);
      const int la = (r << lg) + ((j >> lg_k2) << (lg_k2 + 1)) + (j & (k2 - 1));
      const unsigned long long x = src[slot_major ? slot_addr(la) : la];
      const unsigned long long y =
          src[slot_major ? slot_addr(la + k2) : la + k2];
      dst[e] = x > y ? x : y;
    }
    __syncthreads();
    for (int stride = k2 >> 1; stride > 0; stride >>= 1) {
      bitonic_step(dst, lg - 1, stride, k2, false);
    }
    unsigned long long* tmp = src;
    src = dst;
    dst = tmp;
    slot_major = false;
  }

  const size_t lists = gridDim.y;
  for (int e = threadIdx.x; e < kQT * top_k; e += kThreads1) {
    const int r = e / top_k;
    const int j = e % top_k;
    if (q0 + r < n) {
      const int l = (r << lg_k2) + j;
      part[((q0 + r) * lists + blockIdx.y) * top_k + j] =
          src[slot_major ? slot_addr(l) : l];
    }
  }
}

__global__ void __launch_bounds__(32 * kMergeWarps)
topk_sort_merge_kernel(const unsigned long long* __restrict__ part,
                       float* __restrict__ out_v, int* __restrict__ out_i,
                       int n, int top_k, int n_lists, int raw) {
  extern __shared__ int heads[];  // [kMergeWarps][n_lists]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q = blockIdx.x * kMergeWarps + warp;
  if (q >= n) return;  // whole warps
  int* head = heads + warp * n_lists;
  const unsigned long long* lists =
      part + static_cast<size_t>(q) * n_lists * top_k;
  float* ov = out_v + static_cast<size_t>(q) * top_k;
  int* oi = out_i + static_cast<size_t>(q) * top_k;

  for (int b = lane; b < n_lists; b += 32) head[b] = 0;
  // this lane's largest head and its list (-1: none left)
  auto best_head = [&](unsigned long long& key, int& list) {
    key = 0ull;
    list = -1;
    for (int b = lane; b < n_lists; b += 32) {
      const int h = head[b];
      const unsigned long long k =
          h < top_k ? lists[static_cast<size_t>(b) * top_k + h] : 0ull;
      if (list < 0 || k > key) {
        key = k;
        list = b;
      }
    }
  };
  unsigned long long mine;
  int list;
  best_head(mine, list);
  for (int t = 0; t < top_k; ++t) {
    unsigned long long win = mine;
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      const unsigned long long o = __shfl_xor_sync(0xffffffffu, win, off);
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

size_t block_smem_bytes(int ck) {
  return sizeof(float) * static_cast<size_t>(kQT) * ck +
         sizeof(unsigned long long) *
             (32 * static_cast<size_t>(kPad) + kQT * kBlk / 2);
}

template <typename T, int CK>
int launch(const void* qk, const void* mk, unsigned long long* part,
           float* out_v, int* out_i, int n, int valid, int top_k, int n_live,
           int raw, cudaStream_t stream) {
  const size_t smem = block_smem_bytes(CK);
  cudaError_t err = cudaFuncSetAttribute(
      topk_sort_block_kernel<T, CK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kQT - 1) / kQT, n_live);
  topk_sort_block_kernel<T, CK><<<grid, kThreads1, smem, stream>>>(
      static_cast<const T*>(qk), static_cast<const T*>(mk), part, n, valid,
      top_k);
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
// [n, top_k]; 1 <= top_k <= 256.  Returns a cudaError_t code.
int memory_topk_sort_launch(const void* qk, const void* mk, void* part,
                            void* out_v, void* out_i, int n, int valid, int ck,
                            int top_k, int n_live, int raw, int is_bf16,
                            void* stream) {
  if (n <= 0) return 0;
  if (ck != 64 || top_k < 1 || top_k > 256 || n_live > 6000 ||
      n_live != (valid > kBlk ? (valid + kBlk - 1) / kBlk : 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  unsigned long long* p = static_cast<unsigned long long*>(part);
  float* ov = static_cast<float*>(out_v);
  int* oi = static_cast<int*>(out_i);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16, 64>(qk, mk, p, ov, oi, n, valid, top_k,
                                     n_live, raw, s);
  }
  return launch<float, 64>(qk, mk, p, ov, oi, n, valid, top_k, n_live, raw,
                           s);
}

const char* memory_topk_sort_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
