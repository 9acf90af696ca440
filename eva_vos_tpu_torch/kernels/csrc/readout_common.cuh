// Shared pieces of the value readout kernels (sm_90a): Vec, which both
// memory_readout.cu and memory_readout_chunked.cu use, and the device stage
// that memory_readout_chunked.cu launches (with the no_skip ablation).
// memory_readout.cu, a weighted gather, was measured against this stage and
// kept (its note).  Given the selection's raw scores vals[k, N]
// (descending) and ids idx[k, N]:
//     out[o, n, :] = sum_t w_t * mv[o, idx[t, n], :] / sum_t w_t,
//     w_t = exp(vals[t, n] - vals[0, n]),
// accumulated in fp32 and written in mv's dtype.  memory_readout.py states
// the plan in plain PyTorch (readout_stage_plain).
//
// What bounds it: bytes (two flops per element read): each distinct
// selected row once, the selection once (8 B a pick) and the output once.
// A gather per (query, pick) moves k rows a query from L2 to the SMs, so
// neighbouring queries that pick the same rows pay for them again and again;
// the stage moves each row once per tile of queries.
//
// Design.  A block owns a tile of kQ queries (64, or 32 for top_k > 64 or
// few tiles), one object and a slice of CV (the whole row unless the tiles
// leave SMs idle, and at most kMaxCols 16-byte columns a lane):
//  1. Plan, with no block-wide sort: the tile's (w, id) pairs are loaded
//     coalesced along the queries; each consumer warp sorts its queries'
//     picks by (id, slot) in registers (a bitonic network, E keys a lane)
//     and sums their weights.  A pick of weight 0 (past the fill) is
//     dropped.  The tile's distinct ids are marked in a bitmap over a
//     window of kWinIds ids starting at the tile's lowest chunk (atomicOr),
//     and a __popc prefix over its words gives each distinct id its row
//     slot, ascending in id: a window is sized by the ids, never by M.
//  2. Staging: each distinct row slice is copied once per tile by one
//     cp.async.bulk (TMA), in ascending id order, into a ring of kRing
//     stages with a "full" (complete_tx) and an "empty" mbarrier each.
//     Each stage has its own producer warp, whose lanes issue its copies
//     in parallel: one warp issuing every stage's copies held the walk to
//     about one copy per 60 cycles, and the copies' bytes did not matter
//     (half rows took as long on an H100; PERF.md).  16 consumer warps sum one
//     stage while the next ones are in flight, with no block barrier per
//     stage.  The rows go chunk by chunk of kChunk ids, and a chunk that no
//     pick lands in costs nothing; with no_skip every chunk of [0, M) takes
//     its own stages, empty ones included, and the output is the same.
//  3. Sums: a consumer lane owns (query, 16-byte column) pairs with fp32
//     accumulators in registers and walks its query's id-sorted hits that
//     lie in the stage, so every query sums its rows in ascending id order,
//     the same in every run, with or without the skip.  The
//     query's next hit waits in registers; a slice of one or two whole
//     columns a lane is summed with no column test.  Scaled by 1 / sum_t
//     w_t at the end, stored 16 bytes a lane.  No tensor cores: the TPU
//     kernel's dense contrib @ V costs kQ x rows x CV x 2 flops, more than
//     the byte bound at low sharing, and TF32 would not keep fp32 values to
//     1e-5.
//  4. A count: each (tile, object) adds the rows it staged to an optional
//     device counter (once, whatever the CV slices), so picks / staged rows
//     is the sharing factor.
//
// Where the time goes (PERF.md): at low sharing (a tile's picks
// nearly all distinct, as on the synthetic banks from fill 12 on) the sums
// do the gather's arithmetic and the stage adds its plan and staging, so
// the consumers' issue rate, not the bytes, sets the time.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Vec<T> moves 16 bytes of a value row (8 bf16 or 4 fp32) between memory
// and fp32 registers.
template <typename T> struct Vec;

template <> struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    // a bf16 is the high half of its fp32: one shift or mask a value
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const unsigned h[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(h[i] << 16);
      out[2 * i + 1] = __uint_as_float(h[i] & 0xffff0000u);
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* in) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    }
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

template <> struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  }
  __device__ static void store(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
};

namespace readout {

constexpr int kWarps = 16;                   // consumer warps
constexpr int kRing = 4;                     // ring stages
constexpr int kThreads = 32 * (kWarps + kRing);  // and a producer warp a
                                                 // stage of the ring
constexpr int kChunk = 1024;                 // bank ids a chunk
constexpr int kWinWords = 4096;              // bitmap words of a window
constexpr int kWinIds = 32 * kWinWords;      // 131,072 ids: 128 chunks
constexpr int kMaxCols = 2;  // 16-byte columns a lane owns a query: a slice
                             // holds at most 64 (1 KB)
constexpr int kNoId = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

// Shared memory of a block with E sorted keys a lane (top_k <= 32 E) and
// QW queries a consumer warp: the ring, each pick's (row slot, weight) by
// sorted position, the window's bitmap and word prefix, its rows' ids, the
// barriers and a few counters.
template <int E, int QW>
struct Geo {
  static constexpr int kQ = kWarps * QW;
  static constexpr int kP = 32 * E;
  static constexpr int kStageBytes = E == 8 ? 24576 : 32768;
  static constexpr size_t kPairsOff = static_cast<size_t>(kRing) * kStageBytes;
  static constexpr size_t kBitsOff = kPairsOff + 8ull * kQ * kP;
  static constexpr size_t kPrefixOff = kBitsOff + 4ull * kWinWords;
  static constexpr size_t kRowsOff = kPrefixOff + 2ull * kWinWords;
  static constexpr size_t kBarOff = kRowsOff + 4ull * kQ * kP;
  static constexpr size_t kMiscOff = kBarOff + 16ull * kRing;
  static constexpr size_t kBytes = kMiscOff + 4 * 32;
  // the raw picks [kQ][top_k] (w, id) sit in the ring before staging
  static_assert(8ull * kQ * kP <= kPairsOff, "raw picks exceed the ring");
  static_assert(kBytes <= 232448, "shared memory of one block");
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned phase) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_addr(bar)),
      "r"(phase)
      : "memory");
}

// One bulk copy (TMA, no tensor map) of `bytes` (a multiple of 16, both
// addresses 16-byte aligned) from global to shared memory; `bar` counts
// its bytes.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Ascending bitonic sort of a warp's 32 E keys, key j of a lane at
// position lane * E + j.
template <int E>
__device__ __forceinline__ void warp_sort(unsigned long long (&key)[E],
                                          int lane) {
  constexpr int kLogP = E == 1 ? 5 : E == 2 ? 6 : E == 4 ? 7 : 8;
  static_assert(32 * E == 1 << kLogP, "E is 1, 2, 4 or 8");
#pragma unroll
  for (int ls = 1; ls <= kLogP; ++ls) {
    const int size = 1 << ls;
#pragma unroll
    for (int lt = ls - 1; lt >= 0; --lt) {
      const int stride = 1 << lt;
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const int pos = lane * E + j;
        const bool up = (pos & size) == 0;
        if (stride >= E) {  // the partner is key j of lane ^ (stride / E)
          const unsigned long long other =
              __shfl_xor_sync(kFull, key[j], stride / E);
          const bool keep_min = ((pos & stride) == 0) == up;
          key[j] = keep_min ? (other < key[j] ? other : key[j])
                            : (other > key[j] ? other : key[j]);
        } else if ((j & stride) == 0) {  // the partner is key j | stride
          const int j2 = j | stride;
          if ((key[j] > key[j2]) == up) {
            const unsigned long long t = key[j];
            key[j] = key[j2];
            key[j2] = t;
          }
        }
      }
    }
  }
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(kFull, s, d);
  return s;
}

// The stages of a window's walk, in order: without no_skip its rows in
// groups of stage_rows; with no_skip each of its chunks in turn (chunk c
// holds rows [first(32 c), first(32 c + 32))), at least one stage each.
template <typename F>
__device__ __forceinline__ void walk(int nrows, int words, int chunks,
                                     const unsigned short* prefix,
                                     int stage_rows, int no_skip, F&& stage) {
  if (!no_skip) {
    for (int r0 = 0; r0 < nrows; r0 += stage_rows) {
      stage(r0, min(r0 + stage_rows, nrows));
    }
    return;
  }
  for (int c = 0; c < chunks; ++c) {
    const int lo = 32 * c < words ? static_cast<int>(prefix[32 * c]) : nrows;
    const int hi =
        32 * c + 32 < words ? static_cast<int>(prefix[32 * c + 32]) : nrows;
    int r0 = lo;
    do {
      const int r1 = min(r0 + stage_rows, hi);
      stage(r0, r1);
      r0 = r1;
    } while (r0 < hi);
  }
}

// A consumer warp's sums over one stage (rows [r0, r1) of the walk, at
// `stage`): each of its QW queries adds w * row for its hits there, in
// ascending id order, into fp32 accumulators of kCols 16-byte columns a
// lane (lane + 32 c of the slice's `width`; kCheck tests them against it).
// next[qi] holds the query's next hit (slot, weight bits), and the one
// after it is loaded while the hit is summed.
template <typename T, int QW, int kP, int kCols, bool kCheck>
__device__ __forceinline__ void sum_stage(
    const T* stage, int r0, int r1, int row_elems, int width, int lane,
    const int2* mine, int2 (&next)[QW], int (&pos_next)[QW],
    const int (&end)[QW], float (&acc)[QW][kMaxCols][Vec<T>::kN]) {
  constexpr int kVec = Vec<T>::kN;
  const T* lane_row = stage + lane * kVec;
#pragma unroll
  for (int qi = 0; qi < QW; ++qi) {
    while (next[qi].x < r1) {
      const T* row = lane_row + (next[qi].x - r0) * row_elems;
      const float w = __int_as_float(next[qi].y);
      const int pp = ++pos_next[qi];
      next[qi] = pp < end[qi] ? mine[qi * kP + pp] : make_int2(kNoId, 0);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (!kCheck || lane + 32 * c < width) {
          float x[kVec];
          Vec<T>::load(row + 32 * c * kVec, x);
#pragma unroll
          for (int u = 0; u < kVec; ++u) {
            acc[qi][c][u] = fmaf(w, x[u], acc[qi][c][u]);
          }
        }
      }
    }
  }
}

template <typename T, int E, int QW>
__global__ void __launch_bounds__(kThreads, 1)
readout_stage_kernel(const T* __restrict__ mv, const float* __restrict__ vals,
                     const int* __restrict__ idx, T* __restrict__ out, int n,
                     int m, int cv, int top_k, int slices, int no_skip,
                     int* __restrict__ staged) {
  using G = Geo<E, QW>;
  constexpr int kQ = G::kQ;
  constexpr int kP = G::kP;
  constexpr int kVec = Vec<T>::kN;
  constexpr int kStageElems = G::kStageBytes / static_cast<int>(sizeof(T));
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  int2* pairs = reinterpret_cast<int2*>(smem + G::kPairsOff);  // [kQ][kP]
  unsigned* bits = reinterpret_cast<unsigned*>(smem + G::kBitsOff);
  unsigned short* prefix =
      reinterpret_cast<unsigned short*>(smem + G::kPrefixOff);
  int* rows = reinterpret_cast<int*>(smem + G::kRowsOff);  // slot -> id
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(smem + G::kBarOff);
  unsigned long long* empty = full + kRing;
  int* misc = reinterpret_cast<int*>(smem + G::kMiscOff);
  // misc: [0] lowest live id, [1] highest, [2] the window's rows,
  // [4 + w] warp w's count in the prefix scan

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool producer = warp >= kWarps;
  const int q0 = blockIdx.x * kQ;
  const int o = blockIdx.y;
  const int nv = cv / kVec;
  const int c0 = static_cast<int>(static_cast<long long>(blockIdx.z) * nv /
                                  slices);
  const int width = static_cast<int>(static_cast<long long>(blockIdx.z + 1) *
                                     nv / slices) - c0;  // 16-byte columns
  const int row_elems = width * kVec;
  const unsigned row_bytes = 16u * width;
  const int stage_rows = G::kStageBytes / (16 * width);
  const T* bank = mv + static_cast<size_t>(o) * m * cv + c0 * kVec;

  // 1. the tile's picks, coalesced along the queries, to [kQ][top_k] in
  // the ring; a pick of weight 0 gets no id
  float* raw_w = reinterpret_cast<float*>(smem);
  int* raw_i = reinterpret_cast<int*>(raw_w + kQ * top_k);
#pragma unroll 4
  for (int e = threadIdx.x; e < kQ * top_k; e += kThreads) {
    const int t = e / kQ;
    const int qq = e - t * kQ;
    const int q = q0 + qq;
    float w = 0.f;
    int id = kNoId;
    if (q < n) {
      const size_t at = static_cast<size_t>(t) * n + q;
      const int pick = idx[at];  // loaded beside the scores, not after
      w = expf(vals[at] - vals[q]);
      if (w > 0.f) id = pick;
    }
    raw_w[qq * top_k + t] = w;
    raw_i[qq * top_k + t] = id;
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < kRing; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    misc[0] = kNoId;
    misc[1] = -1;
  }
  __syncthreads();

  // 2. each consumer warp sorts its queries' picks by (id, slot t) and
  // writes them by sorted position to pairs: (id, weight bits); a window
  // turns the ids of its picks into row slots
  float z[QW];
  int pos_next[QW];  // each query's first pick not yet summed
  float acc[QW][kMaxCols][kVec];
#pragma unroll
  for (int qi = 0; qi < QW; ++qi) {
    z[qi] = 0.f;
    pos_next[qi] = 0;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
#pragma unroll
      for (int u = 0; u < kVec; ++u) acc[qi][c][u] = 0.f;
    }
  }
  int2* mine = pairs + warp * QW * kP;  // this warp's queries' picks
  if (!producer) {
    int lo = kNoId, hi = -1;
#pragma unroll
    for (int qi = 0; qi < QW; ++qi) {
      const int qq = warp * QW + qi;
      unsigned long long key[E];
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const int pos = lane * E + j;
        key[j] = pos < top_k
                     ? (static_cast<unsigned long long>(
                            static_cast<unsigned>(raw_i[qq * top_k + pos]))
                        << 8) | static_cast<unsigned>(pos)
                     : ~0ull;
      }
      warp_sort<E>(key, lane);
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const unsigned long long hi_bits = key[j] >> 8;
        const int id = hi_bits >= static_cast<unsigned long long>(kNoId)
                           ? kNoId
                           : static_cast<int>(hi_bits);
        const float w =
            id == kNoId ? 0.f
                        : raw_w[qq * top_k + static_cast<int>(key[j] & 255)];
        mine[qi * kP + lane * E + j] = make_int2(id, __float_as_int(w));
        s += w;
        if (id != kNoId) {
          lo = min(lo, id);
          hi = max(hi, id);
        }
      }
      z[qi] = warp_sum(s);
    }
    lo = __reduce_min_sync(kFull, lo);
    hi = __reduce_max_sync(kFull, hi);
    if (lane == 0) {
      atomicMin(misc, lo);
      atomicMax(misc + 1, hi);
    }
  }
  __syncthreads();

  // 3. the windows of the walk: from the tile's lowest chunk to its highest
  // id, or (no_skip) over the whole bank
  int w_start = 0, w_end = 0;
  if (no_skip) {
    w_end = m;
  } else if (misc[1] >= 0) {
    w_start = misc[0] / kChunk * kChunk;
    w_end = misc[1] + 1;
  }
  int g = 0;      // stages walked, the same count in every warp
  int total = 0;  // rows staged
  for (int wlo = w_start; wlo < w_end; wlo += kWinIds) {
    const int whi = min(wlo + kWinIds, w_end);
    const int words = (whi - wlo + 31) / 32;
    const int chunks = (whi - wlo + kChunk - 1) / kChunk;
    for (int i = threadIdx.x; i < words; i += kThreads) bits[i] = 0u;
    __syncthreads();
    // the window's picks: positions [pos_next, end) of each query (the
    // positions before pos_next hold slots of earlier windows)
    int end[QW];
    if (!producer) {
#pragma unroll
      for (int qi = 0; qi < QW; ++qi) {
        end[qi] = pos_next[qi];
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const int pos = lane * E + j;
          const int id = mine[qi * kP + pos].x;
          const bool in = pos >= pos_next[qi] && id < whi;
          end[qi] += __popc(__ballot_sync(kFull, in));
          if (in) atomicOr(bits + ((id - wlo) >> 5), 1u << ((id - wlo) & 31));
        }
      }
    }
    __syncthreads();
    // exclusive prefix of the words' bit counts; the distinct ids in order
    const int per = (words + kThreads - 1) / kThreads;
    const int w0 = min(static_cast<int>(threadIdx.x) * per, words);
    const int w1 = min(w0 + per, words);
    int local = 0;
    for (int i = w0; i < w1; ++i) local += __popc(bits[i]);
    int incl = local;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) misc[4 + warp] = incl;
    __syncthreads();
    int base = incl - local;
    for (int i = 0; i < warp; ++i) base += misc[4 + i];
    if (threadIdx.x == kThreads - 1) misc[2] = base + local;
    for (int i = w0; i < w1; ++i) {
      prefix[i] = static_cast<unsigned short>(base);
      unsigned b = bits[i];
      while (b) {
        rows[base++] = wlo + 32 * i + __ffs(b) - 1;
        b &= b - 1;
      }
    }
    __syncthreads();
    const int nrows = misc[2];
    total += nrows;

    if (producer) {
      // the block's generic stores to the ring (the raw picks) before the
      // copies' (async proxy) writes
      if (wlo == w_start) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      }
      walk(nrows, words, chunks, prefix, stage_rows, no_skip,
           [&](int r0, int r1) {
             const int b = g % kRing;
             if (b == warp - kWarps) {  // this warp's slot of the ring
               // the consumers released the slot (their reads precede
               // the copies' writes through the empty barrier)
               if (g >= kRing) mbar_wait(empty + b, ((g / kRing) - 1) & 1);
               if (lane == 0) {
                 if (r1 > r0) {
                   mbar_arrive_tx(full + b, (r1 - r0) * row_bytes);
                 } else {
                   mbar_arrive(full + b);
                 }
               }
               __syncwarp();
               T* dst = ring + b * kStageElems;
               for (int r = r0 + lane; r < r1; r += 32) {
                 bulk_copy(dst + (r - r0) * row_elems,
                           bank + static_cast<size_t>(rows[r]) * cv,
                           row_bytes, full + b);
               }
             }
             ++g;
           });
    } else {
      // the window's ids become row slots
#pragma unroll
      for (int qi = 0; qi < QW; ++qi) {
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const int pos = lane * E + j;
          if (pos >= pos_next[qi] && pos < end[qi]) {
            const int off = mine[qi * kP + pos].x - wlo;
            const unsigned below = (1u << (off & 31)) - 1u;
            mine[qi * kP + pos].x = static_cast<int>(prefix[off >> 5]) +
                                    __popc(bits[off >> 5] & below);
          }
        }
      }
      __syncwarp();
      // each query's next hit (row slot, weight bits) in registers, so a
      // stage without one costs a compare, and the pair after it loads
      // while the hit is summed
      int2 next[QW];
#pragma unroll
      for (int qi = 0; qi < QW; ++qi) {
        next[qi] = pos_next[qi] < end[qi] ? mine[qi * kP + pos_next[qi]]
                                          : make_int2(kNoId, 0);
      }
      walk(nrows, words, chunks, prefix, stage_rows, no_skip,
           [&](int r0, int r1) {
             const int b = g % kRing;
             mbar_wait(full + b, (g / kRing) & 1);
             const T* stage = ring + b * kStageElems;
             // a slice of two or one whole 16-byte columns a lane needs no
             // column test
             if (width == 32 * kMaxCols) {
               sum_stage<T, QW, kP, kMaxCols, false>(
                   stage, r0, r1, row_elems, width, lane, mine, next,
                   pos_next, end, acc);
             } else if (width == 32) {
               sum_stage<T, QW, kP, 1, false>(stage, r0, r1, row_elems,
                                              width, lane, mine, next,
                                              pos_next, end, acc);
             } else {
               sum_stage<T, QW, kP, kMaxCols, true>(
                   stage, r0, r1, row_elems, width, lane, mine, next,
                   pos_next, end, acc);
             }
             __syncwarp();
             if (lane == 0) mbar_arrive(empty + b);
             ++g;
           });
    }
    __syncthreads();
  }

  // 4. normalise and store; count the staged rows once per (tile, object)
  if (!producer) {
#pragma unroll
    for (int qi = 0; qi < QW; ++qi) {
      const int q = q0 + warp * QW + qi;
      if (q >= n) continue;
      const float inv = 1.f / z[qi];
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        const int col = lane + 32 * c;
        if (col < width) {
#pragma unroll
          for (int u = 0; u < kVec; ++u) acc[qi][c][u] *= inv;
          Vec<T>::store(out + (static_cast<size_t>(o) * n + q) * cv +
                            (c0 + col) * kVec,
                        acc[qi][c]);
        }
      }
    }
  }
  if (threadIdx.x == 0 && staged != nullptr && blockIdx.z == 0) {
    atomicAdd(staged, total);
  }
}

template <typename T, int E, int QW>
int launch(const void* mv, const float* vals, const int* idx, void* out,
           int n_obj, int n, int m, int cv, int top_k, int slices, int no_skip,
           int* staged, cudaStream_t stream) {
  using G = Geo<E, QW>;
  auto kernel = readout_stage_kernel<T, E, QW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(G::kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + G::kQ - 1) / G::kQ, n_obj, slices);
  kernel<<<grid, kThreads, G::kBytes, stream>>>(
      static_cast<const T*>(mv), vals, idx, static_cast<T*>(out), n, m, cv,
      top_k, slices, no_skip, staged);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_typed(const void* mv, const float* vals, const int* idx, void* out,
                 int n_obj, int n, int m, int cv, int top_k, int queries,
                 int slices, int no_skip, int* staged, cudaStream_t s) {
  const int e = top_k <= 32 ? 1 : top_k <= 64 ? 2 : top_k <= 128 ? 4 : 8;
  if (queries == 64 && e == 1) {
    return launch<T, 1, 4>(mv, vals, idx, out, n_obj, n, m, cv, top_k, slices,
                           no_skip, staged, s);
  }
  if (queries == 64 && e == 2) {
    return launch<T, 2, 4>(mv, vals, idx, out, n_obj, n, m, cv, top_k, slices,
                           no_skip, staged, s);
  }
  if (queries != 32) return static_cast<int>(cudaErrorInvalidValue);
  switch (e) {
    case 1:
      return launch<T, 1, 2>(mv, vals, idx, out, n_obj, n, m, cv, top_k,
                             slices, no_skip, staged, s);
    case 2:
      return launch<T, 2, 2>(mv, vals, idx, out, n_obj, n, m, cv, top_k,
                             slices, no_skip, staged, s);
    case 4:
      return launch<T, 4, 2>(mv, vals, idx, out, n_obj, n, m, cv, top_k,
                             slices, no_skip, staged, s);
    default:
      return launch<T, 8, 2>(mv, vals, idx, out, n_obj, n, m, cv, top_k,
                             slices, no_skip, staged, s);
  }
}

}  // namespace readout
