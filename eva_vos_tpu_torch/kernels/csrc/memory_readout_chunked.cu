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
// What bounds it: bytes, the selected value rows (1 KB each in bf16 at
// CV = 512) and the output.
//
// Design.  A block owns a tile of 16 queries and one object, and walks the
// value bank in ascending id order: the tile's selected ids are sorted (a
// bitonic sort in shared memory), the distinct ones listed, and each
// query's (id, weight) pairs sorted by id, so that a query's hits in any
// run of distinct rows are one run of its own list.  The distinct rows are
// copied into shared memory 32 at a time (16 bytes a thread), ONCE for all
// the tile's queries, and each (query, 16-byte column) thread adds w_t * row
// to its fp32 accumulator in registers over its query's hits among them.  The sum is normalised by sum_t w_t at the end.  A 1,024-token chunk
// of the bank that no selected id lands in costs nothing (the TPU kernel's
// sub-chunk skip, memory_readout.py:227,247); with no_skip every chunk of
// the bank is visited, each in its own staging rounds (the readout_noskip
// ablation).  memory_readout.cu fetches a row once per (query, slot) and
// relies on L2 for reuse; on clustered banks, where the queries of a tile
// select the same rows, this design reads each row from L2 once per tile.
// Rows are summed in ascending id order, the same in every run.

#include "readout_common.cuh"

namespace {

constexpr int kQ = 16;           // queries per block
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 1024;     // bank tokens per chunk (no_skip visits)
constexpr int kStageRows = 32;   // value rows staged at a time
constexpr int kLoads = 8;        // row loads a thread keeps in flight
// (query, 16-byte column) accumulators per thread, in registers: CV up to
// 1024 in bf16 or 512 in fp32
constexpr int kMaxPairs = 8;
constexpr int kNoId = 0x7fffffff;  // the ids of queries past the end

// Sorted keys: a power of two >= kQ * top_k, at least 4 per thread.
int sort_len(int top_k) {
  int len = 4 * kThreads;
  while (len < kQ * top_k) len <<= 1;
  return len;
}

size_t smem_bytes(int cv, int top_k, int itemsize) {
  const size_t qk = static_cast<size_t>(kQ) * top_k;
  return static_cast<size_t>(itemsize) * kStageRows * cv +   // stage
         4 * (2 * qk + kQ) +                                 // raw_w, sw, z
         4 * (3 * qk + 2 * static_cast<size_t>(sort_len(top_k)) + kWarps +
              2 * kQ + 1);
}

// First position in the ascending rows[0, n) whose id is >= key.
__device__ __forceinline__ int lower_bound(const int* rows, int n, int key) {
  int lo = 0;
  while (n > 0) {
    const int half = n >> 1;
    if (rows[lo + half] < key) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
readout_chunked_kernel(const T* __restrict__ mv,
                       const float* __restrict__ vals,
                       const int* __restrict__ idx, T* __restrict__ out,
                       int n, int m, int cv, int top_k, int sort_n,
                       int no_skip) {
  constexpr int kVec = Vec<T>::kN;
  const int qk = kQ * top_k;
  extern __shared__ __align__(16) float smem[];
  T* stage = reinterpret_cast<T*>(smem);               // [kStageRows][cv]
  float* raw_w = reinterpret_cast<float*>(stage + kStageRows * cv);
  float* sw = raw_w + qk;                              // [kQ][k] by id
  float* z = sw + qk;                                  // [kQ]
  int* raw_i = reinterpret_cast<int*>(z + kQ);         // [kQ][k]
  int* sid = raw_i + qk;                               // [kQ][k] ascending
  int* sslot = sid + qk;                               // [kQ][k] row slot
  int* keys = sslot + qk;                              // [sort_n] all ids
  int* rows = keys + sort_n;                           // [sort_n] distinct
  int* warp_tot = rows + sort_n;                       // [kWarps]
  int* bat_lo = warp_tot + kWarps;                     // [kQ] a query's hits
  int* bat_hi = bat_lo + kQ;                           //   in this batch
  int* n_rows = bat_hi + kQ;                           // [1]

  const int o = blockIdx.y;
  const int q0 = blockIdx.x * kQ;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nv = cv / kVec;
  for (int e = threadIdx.x; e < sort_n; e += kThreads) {
    int id = kNoId;
    if (e < qk) {
      const int qq = e / top_k;
      const int t = e - qq * top_k;
      const int q = q0 + qq;
      float w = 0.f;
      if (q < n) {
        w = expf(vals[static_cast<size_t>(t) * n + q] - vals[q]);
        id = idx[static_cast<size_t>(t) * n + q];
      }
      raw_w[e] = w;
      raw_i[e] = id;
    }
    keys[e] = id;
  }
  float acc[kMaxPairs][kVec];
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
#pragma unroll
    for (int u = 0; u < kVec; ++u) acc[i][u] = 0.f;
  }
  __syncthreads();

  // each query's pairs sorted by (id, slot t): the rank is the position
  for (int e = threadIdx.x; e < qk; e += kThreads) {
    const int base = (e / top_k) * top_k;
    const int id = raw_i[e];
    int rank = 0;
    for (int t2 = 0; t2 < top_k; ++t2) {
      const int id2 = raw_i[base + t2];
      rank += (id2 < id || (id2 == id && base + t2 < e)) ? 1 : 0;
    }
    sid[base + rank] = id;
    sw[base + rank] = raw_w[e];
  }
  if (threadIdx.x < kQ) {
    float s = 0.f;
    for (int t = 0; t < top_k; ++t) s += raw_w[threadIdx.x * top_k + t];
    z[threadIdx.x] = s;
  }
  // all the tile's ids, ascending (bitonic sort)
  for (int size = 2; size <= sort_n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int i = threadIdx.x; i < sort_n / 2; i += kThreads) {
        const int a = 2 * i - (i & (stride - 1));
        const int b = a + stride;
        const int ka = keys[a];
        const int kb = keys[b];
        if ((ka > kb) == ((a & size) == 0)) {
          keys[a] = kb;
          keys[b] = ka;
        }
      }
    }
  }
  __syncthreads();

  // the distinct ids, in order: an exclusive scan of "first of its id"
  const int per = sort_n / kThreads;
  const int p0 = threadIdx.x * per;
  int local = 0;
  for (int i = p0; i < p0 + per; ++i) {
    local += (keys[i] != kNoId && (i == 0 || keys[i] != keys[i - 1])) ? 1 : 0;
  }
  int incl = local;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  int slot = incl - local;
  for (int w2 = 0; w2 < warp; ++w2) slot += warp_tot[w2];
  for (int i = p0; i < p0 + per; ++i) {
    if (keys[i] != kNoId && (i == 0 || keys[i] != keys[i - 1])) {
      rows[slot++] = keys[i];
    }
  }
  if (threadIdx.x == kThreads - 1) *n_rows = slot;
  __syncthreads();
  const int nr = *n_rows;
  for (int j = threadIdx.x; j < qk; j += kThreads) {
    sslot[j] = sid[j] == kNoId ? kNoId : lower_bound(rows, nr, sid[j]);
  }
  if (threadIdx.x < kQ) bat_hi[threadIdx.x] = threadIdx.x * top_k;
  __syncthreads();

  // staging rounds: over all distinct rows at once, or (no_skip) over
  // every chunk of the bank in turn, empty chunks included
  const T* bank = mv + static_cast<size_t>(o) * m * cv;
  const int n_seg = no_skip ? (m + kChunk - 1) / kChunk : 1;
  int s_lo = 0;
  for (int c = 0; c < n_seg; ++c) {
    const int s_hi = no_skip ? lower_bound(rows, nr, (c + 1) * kChunk) : nr;
    int b0 = s_lo;
    do {
      const int nb = min(kStageRows, s_hi - b0);
      // kLoads 16-byte loads in flight per thread before the first store
      for (int p = threadIdx.x; p < nb * nv; p += kThreads * kLoads) {
        uint4 buf[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const int pp = p + u * kThreads;
          if (pp < nb * nv) {
            const int rr = pp / nv;
            buf[u] = *reinterpret_cast<const uint4*>(
                bank + static_cast<size_t>(rows[b0 + rr]) * cv +
                (pp - rr * nv) * kVec);
          }
        }
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const int pp = p + u * kThreads;
          if (pp < nb * nv) {
            *reinterpret_cast<uint4*>(stage + pp * kVec) = buf[u];
          }
        }
      }
      if (threadIdx.x < kQ) {   // the query's hits among the staged rows
        const int end = (threadIdx.x + 1) * top_k;
        int j = bat_hi[threadIdx.x];
        bat_lo[threadIdx.x] = j;
        while (j < end && sslot[j] < b0 + nb) ++j;
        bat_hi[threadIdx.x] = j;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kMaxPairs; ++i) {
        const int p = threadIdx.x + i * kThreads;
        if (p >= kQ * nv) break;
        const int qq = p / nv;
        const int v = p - qq * nv;
        for (int j = bat_lo[qq]; j < bat_hi[qq]; ++j) {
          float x[kVec];
          Vec<T>::load(stage + (sslot[j] - b0) * cv + v * kVec, x);
          const float wt = sw[j];
#pragma unroll
          for (int u = 0; u < kVec; ++u) acc[i][u] = fmaf(wt, x[u], acc[i][u]);
        }
      }
      __syncthreads();
      b0 += kStageRows;
    } while (b0 < s_hi);
    s_lo = s_hi;
  }

#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
    const int p = threadIdx.x + i * kThreads;
    if (p >= kQ * nv) break;
    const int qq = p / nv;
    const int v = p - qq * nv;
    const int q = q0 + qq;
    if (q < n) {
#pragma unroll
      for (int u = 0; u < kVec; ++u) acc[i][u] /= z[qq];
      Vec<T>::store(out + (static_cast<size_t>(o) * n + q) * cv + v * kVec,
                    acc[i]);
    }
  }
}

template <typename T>
int launch(const void* mv, const float* vals, const int* idx, void* out,
           int n_obj, int n, int m, int cv, int top_k, int no_skip,
           cudaStream_t stream) {
  if (kQ * (cv / Vec<T>::kN) > kMaxPairs * kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes(cv, top_k, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      readout_chunked_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kQ - 1) / kQ, n_obj);
  readout_chunked_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(mv), vals, idx, static_cast<T*>(out), n, m, cv,
      top_k, sort_len(top_k), no_skip);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// mv [n_obj, m, cv] row-major, 16-byte aligned, cv a multiple of 8 and at
// most 1024 (bf16) or 512 (fp32); vals and idx [top_k, n] from a selection
// kernel (every id < m); out [n_obj, n, cv] in mv's dtype.  Returns a
// cudaError_t code.
int memory_readout_chunked_launch(const void* mv, const void* vals,
                                  const void* idx, void* out, int n_obj,
                                  int n, int m, int cv, int top_k,
                                  int no_skip, int is_bf16, void* stream) {
  if (n <= 0 || n_obj <= 0) return 0;
  const float* v = static_cast<const float*>(vals);
  const int* i = static_cast<const int*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16>(mv, v, i, out, n_obj, n, m, cv, top_k,
                                 no_skip, s);
  }
  return launch<float>(mv, v, i, out, n_obj, n, m, cv, top_k, no_skip, s);
}

const char* memory_readout_chunked_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
