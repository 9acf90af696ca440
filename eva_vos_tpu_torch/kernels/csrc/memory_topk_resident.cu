// Two-pass exact top-k selection over an L2-resident key bank (sm_90a).
//
// Replaces eva_vos_tpu/kernels/memory_topk.py:_kernel_resident, reached
// through resident_topk_t.  Same function and outputs as memory_topk.cu:
// for every query n the top_k tokens t < valid by (score desc, id asc), as
// raw scores vals[k, N] and int32 ids idx[k, N]; slots left over when
// valid < top_k hold (-1e30, id 0).
//
// What bounds it: the N x valid x CK products, twice here (two passes).
//
// Design.  The TPU kernel holds the whole key bank in VMEM and replaces the
// running top-k by a candidate buffer, one extraction, and a verify sweep
// that escalates.  Here the key bank stays in the 50 MB L2 across two
// passes (15 MB at a 72-slot bank in bf16), and the serial merge that sets
// memory_topk.cu's time is replaced by a threshold:
//
//  1. pass 1 scores every token; each thread keeps, in registers, the top 8
//     scores of the tokens it scores (its warp's 16-token slice of every
//     tile), so a query has 64 candidate scores of distinct tokens.  Their
//     k-th largest, tau, is a lower bound on the true k-th score (the k-th
//     best of a subset of the tokens; -inf when k > 64 or fewer than k
//     tokens were seen).  Nothing else is kept: no candidate buffer in
//     device memory.
//  2. pass 2 recomputes the scores (the same arithmetic) and admits every
//     token scoring >= tau into the query's list in shared memory, which
//     therefore holds every true winner, ties at the k-th score included.
//     Each admitted token's rank among the admitted, by (score desc, id
//     asc), is its output slot when it is below k.
//  3. a block in which some query admitted more than kCap tokens (many
//     exact ties at tau, or tau far below the k-th score) escalates: it
//     runs memory_topk.cu's exact streaming selection (block_topk) over the
//     bank for its 32 queries, the counterpart of the TPU kernel's
//     verify/escalate ladder (memory_topk.py:881-912).  `escalations`, when
//     not null, counts the blocks that did.

#include "topk_common.cuh"

namespace {

using namespace topk;

constexpr int kR = 8;        // pass-1 scores kept per thread
constexpr int kCap = 256;    // admitted tokens a query's list holds
constexpr int kCand = kWarps * kR;  // pass-1 candidates per query: 64

__device__ __forceinline__ float minus_inf() {
  return __uint_as_float(0xff800000u);
}

size_t resident_smem_bytes(int ck) {
  return sizeof(float) * (static_cast<size_t>(kTile) * ck + kTile +
                          static_cast<size_t>(kCand) * kQueries + kQueries) +
         8 * static_cast<size_t>(kCap) * kQueries + 4 * kQueries;
}

template <typename T, int CK>
__global__ void __launch_bounds__(kThreads, 2)
topk_resident_kernel(const T* __restrict__ qk, const T* __restrict__ mk,
                     float* __restrict__ out_vals, int* __restrict__ out_idx,
                     int n, int valid, int top_k, int* escalations) {
  extern __shared__ __align__(16) float smem[];
  float* tile = smem;                                  // [kTile][CK]
  float* tile_sq = tile + kTile * CK;                  // [kTile]
  float* cand = tile_sq + kTile;                       // [kCand][kQueries]
  float* tau = cand + kCand * kQueries;                // [kQueries]
  float* adm_v = tau + kQueries;                       // [kCap][kQueries]
  int* adm_i = reinterpret_cast<int*>(adm_v + kCap * kQueries);
  int* adm_n = adm_i + kCap * kQueries;                // [kQueries]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q = blockIdx.x * kQueries + lane;
  const bool q_ok = q < n;
  const int j0 = warp * kTokPerWarp;
  const int n_tiles = valid > 0 ? (valid + kTile - 1) / kTile : 0;
  float qv[CK];
  load_query<T, CK>(qk, q, q_ok, qv);

  // pass 1: this thread's top kR scores, sorted descending, in registers
  float r[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) r[i] = minus_inf();
  for (int i = 0; i < n_tiles; ++i) {
    const int base = i * kTile;
    stage_tile<T, CK>(mk, base, valid, tile, tile_sq);
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < kTokPerWarp; jj += 4) {
      float sc[4];
      score4<CK>(qv, tile, tile_sq, j0 + jj, sc);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (q_ok && base + j0 + jj + u < valid && sc[u] > r[kR - 1]) {
          r[kR - 1] = sc[u];
#pragma unroll
          for (int k = kR - 1; k > 0; --k) {
            if (r[k] > r[k - 1]) {
              const float t = r[k];
              r[k] = r[k - 1];
              r[k - 1] = t;
            }
          }
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kR; ++i) cand[(warp * kR + i) * kQueries + lane] = r[i];
  if (warp == 0) {
    tau[lane] = minus_inf();
    adm_n[lane] = 0;
  }
  __syncthreads();

  // tau = the top_k-th largest of the query's kCand candidates (rank by
  // value desc, then candidate slot, so exactly one slot has each rank)
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int c = warp * kR + i;
    const float v = cand[c * kQueries + lane];
    int rank = 0;
    for (int c2 = 0; c2 < kCand; ++c2) {
      const float v2 = cand[c2 * kQueries + lane];
      rank += (v2 > v || (v2 == v && c2 < c)) ? 1 : 0;
    }
    if (rank == top_k - 1) tau[lane] = v;
  }
  __syncthreads();

  // pass 2: admit every token scoring >= tau
  const float tau_q = tau[lane];
  for (int i = 0; i < n_tiles; ++i) {
    const int base = i * kTile;
    stage_tile<T, CK>(mk, base, valid, tile, tile_sq);
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < kTokPerWarp; jj += 4) {
      float sc[4];
      score4<CK>(qv, tile, tile_sq, j0 + jj, sc);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int tok = base + j0 + jj + u;
        if (q_ok && tok < valid && sc[u] >= tau_q) {
          const int p = atomicAdd(&adm_n[lane], 1);
          if (p < kCap) {
            adm_v[p * kQueries + lane] = sc[u];
            adm_i[p * kQueries + lane] = tok;
          }
        }
      }
    }
    __syncthreads();
  }

  const int over = warp == 0 && adm_n[lane] > kCap;
  if (__syncthreads_or(over)) {
    if (threadIdx.x == 0 && escalations != nullptr) atomicAdd(escalations, 1);
    const TopkSmem s = carve(smem, CK, top_k);
    block_topk<T, CK>(qv, q_ok, mk, 0, valid, top_k, false, kAdmitBeatsList,
                      s);
    write_lists(s, out_vals, out_idx, n, q, top_k);
    return;
  }

  // each admitted token's rank is its output slot
  const int cnt = adm_n[lane];
  for (int p = warp; p < cnt; p += kWarps) {
    const float v = adm_v[p * kQueries + lane];
    const int id = adm_i[p * kQueries + lane];
    int rank = 0;
    for (int p2 = 0; p2 < cnt; ++p2) {
      rank += better(adm_v[p2 * kQueries + lane], adm_i[p2 * kQueries + lane],
                     v, id) ? 1 : 0;
    }
    if (rank < top_k) {
      out_vals[static_cast<size_t>(rank) * n + q] = v;
      out_idx[static_cast<size_t>(rank) * n + q] = id;
    }
  }
  if (warp == 0 && q_ok) {
    for (int t = cnt; t < top_k; ++t) {
      out_vals[static_cast<size_t>(t) * n + q] = kNegInf;
      out_idx[static_cast<size_t>(t) * n + q] = 0;
    }
  }
}

template <typename T, int CK>
int launch(const void* qk, const void* mk, float* vals, int* idx, int n,
           int valid, int top_k, int* escalations, cudaStream_t stream) {
  const size_t a = block_topk_smem_bytes(CK, top_k);
  const size_t b = resident_smem_bytes(CK);
  const size_t smem = a > b ? a : b;
  cudaError_t err = cudaFuncSetAttribute(
      topk_resident_kernel<T, CK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kQueries - 1) / kQueries);
  topk_resident_kernel<T, CK><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qk), static_cast<const T*>(mk), vals, idx, n,
      valid, top_k, escalations);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// qk [n, ck], mk [m >= valid, ck] row-major, 16-byte aligned, fp32
// (is_bf16 = 0) or bf16 (is_bf16 = 1), ck = 64; vals/idx [top_k, n];
// escalations: null, or one int32 on the device that counts the blocks
// that escalated.  Returns a cudaError_t code.
int memory_topk_resident_launch(const void* qk, const void* mk, void* vals,
                                void* idx, int n, int valid, int ck,
                                int top_k, void* escalations, int is_bf16,
                                void* stream) {
  if (n <= 0) return 0;
  if (ck != 64) return static_cast<int>(cudaErrorInvalidValue);
  float* v = static_cast<float*>(vals);
  int* i = static_cast<int*>(idx);
  int* e = static_cast<int*>(escalations);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16, 64>(qk, mk, v, i, n, valid, top_k, e, s);
  }
  return launch<float, 64>(qk, mk, v, i, n, valid, top_k, e, s);
}

const char* memory_topk_resident_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
