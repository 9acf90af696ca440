// Top-k weighted value readout for the STCN memory read, the default fused
// read's (sm_90a).
//
// Replaces eva_vos_tpu/kernels/memory_readout.py:_scatter_readout_kernel,
// reached through pallas_fused_readout.  Given the selection's raw scores
// vals[k, N] (descending) and token ids idx[k, N]:
//     out[o, n, :] = sum_t w_t * mv[o, idx[t, n], :] / sum_t w_t,
//     w_t = exp(vals[t, n] - vals[0, n]),
// accumulated in fp32 and written in mv's dtype.
//
// What bounds it: bytes.  Each query reads k value rows of CV elements
// (50 x 1 KB in bf16 at CV = 512) and does two flops per element read.
// The TPU kernel streamed the whole bank through VMEM and built a one-hot
// contribution matrix per block, because a TPU gathers rows badly.  A GPU
// gathers rows well, so up to 256 slots this is a plain weighted gather: the
// bank is read only where a query selected a token, and neighbouring
// queries, which select neighbouring tokens, find those rows in L2.
//
// Design (readout_kernel, top_k <= 256): one block per (tile of 16
// queries, object).  The block stages the tile's weights and ids in shared
// memory once, read coalesced along the queries, then each 64-thread group
// walks one query at a time: its threads cover CV in 16-byte vectors (8
// bf16 or 4 fp32), so every selected row is one coalesced 1 KB read in
// bf16.  The loop over t is unrolled so that several row loads are in
// flight.
//
// The chunked readout's stage (readout_common.cuh), which moves each
// distinct row once per query tile, took longer than this gather over the
// engine's frame-0 interact (0.96 against 0.76 device ms on an H100 80GB
// HBM3 at 700 W; PERF.md):
// at the engine's sharing (1.6 picks a distinct row of a 64-query tile) its
// sums do the gather's arithmetic and its plan and staging come on top.  So
// the default read keeps this kernel up to 256 slots.
//
// Above 256 slots (readout_large_k_kernel).  A gather per (query, slot)
// moves N x top_k rows from L2 to the SMs: 4.2 GB at top_k 512 and 17 GB
// at 2,048 (N = 8,100, CV = 512 bf16), at the L2's 6-8 TB/s whatever the
// bank holds (0.51-2.81 ms on an H100 80GB HBM3 at 700 W; PERF.md).  The
// way under that is to read each distinct row of a tile once from memory
// and from shared memory for every query that picked it, and the picks
// share rows: a 64-query tile picks each of its distinct rows 20-64 times
// at fill 1, 3-8 times at fill 12 and 1.5-2.4 times at fill 72
// (chip_smoke.py's clustered banks).  So a block owns a tile of Q = 64
// queries (32 where the tiles of all objects would leave half the SMs
// idle), one object and a CV slice of at most 1 KB, and:
//  1. Plan.  Pass 1 reads the tile's picks coalesced along the queries
//     (each thread its own slots of one query, the weights' partial sums
//     added in order: the same bits in every run), drops the picks of
//     weight 0 and counts the others a byte an id in shared memory (ids
//     [0, kWinIds), one atomic a pick).  The ids with a pick, in a
//     bitmap, and a __popc prefix over its words give each distinct id its
//     row slot, ascending in id.  The tile takes one of three branches
//     from its live picks P, distinct rows R and live queries Qv:
//       dense  (bf16) when P * kDenseDen >= kDenseNum * Qv * R,
//       sparse when P >= kShare * R, or P >= kShareFar * R when its ids
//         span more than kNear bytes of rows (a gather of rows that L2
//         does not hold costs more: 22.6 against 18.6 ns a pick),
//       direct otherwise, or when an id lies past the window or R exceeds
//       kS * kMaxStages.
//     Dense and sparse tiles count their picks per stage of kS rows, and
//     pass 2 writes each live pick as a record (slot << 6 | query, weight)
//     into the block's scratch, grouped by stage: 8 B a pick, 0.26 MB
//     (top_k 512) to 1 MB (2,048) a tile, more than shared memory holds.
//     Records written where they belong, 8 B at a time, took 0.38 ms more
//     than coalesced ones at fill 12, top_k 2,048 (partial sectors), so
//     pass 2 sorts kChunk picks at a time by stage in shared memory and
//     writes runs.
//  2. Staging (dense and sparse): the distinct rows go in stages of kS
//     rows, ascending, each row slice copied once by cp.async.bulk (TMA)
//     into a ring of kRing stages with a full and an empty mbarrier each
//     and a producer warp for each stage, which also loads the stage's
//     records (the first before it waits for its slot) and adds them into
//     the slot's weight tile W[Q x kS] (fp32) before it arrives.  A staged
//     row is padded to an odd number of 16-byte columns, so that eight
//     rows read at one column hit distinct banks (ldmatrix.trans).
//  3. Sums, by the 16 consumer warps, for each stage once its rows and W
//     are in:
//       dense: W, split into two bf16 terms (hi and lo, ~16 bits of the
//         weight), times the staged rows on the tensor cores (mma.sync
//         m16n8k16, fp32 accumulators; a warp owns 16 queries and a quarter
//         of the slice);
//       sparse: each query's row of W is one ballot, and its lanes walk the
//         hits in ascending slot with fp32 FMAs, 16 bytes a lane and
//         column, as the stage does.
//     fp32 values stay sparse: TF32 would not keep them to 1e-5, and three
//     TF32 products were not tried.
//     direct: the tile gathers its rows straight from global memory in
//     slot order, 32 queries at a time, 8 rows in flight a lane.
//     Every query sums its picks in one fixed order (the tensor cores'
//     order, ascending id, or slot order), so two runs agree bit for bit.
//  4. A count: each (tile, object) adds its staged rows and its dense
//     stages to an optional device counter, so that picks / staged rows is
//     the sharing factor.
// What holds it (scripts/torch_port_large_k_breakdown.py, H100 80GB HBM3
// at 700 W; PERF.md): the plan, 0.02-0.12 ms for pass 1 and up to
// 0.6 ms for pass 2 at top_k 2,048, and a stage's round trip: a 32-row
// stage takes 1-7 us of which its rows and records are a small part, so
// four in flight leave the walk at 0.8-1.7 us a stage; the sparse sums
// read a 1 KB row from shared memory a hit.  The gather of the direct
// branch runs one block an SM and 3-8% behind readout_kernel's.  The cuts
// kDenseNum / kDenseDen and kShare are those measured with each branch
// forced on each of chip_smoke.py's phase 6c cases: each case takes the
// faster branch.

#include "readout_common.cuh"

namespace {

constexpr int kGroup = 64;                  // threads per query
constexpr int kGroups = 4;                  // queries in flight per block
constexpr int kThreads = kGroup * kGroups;  // 256
constexpr int kQueriesPerBlock = 16;

template <typename T>
__global__ void __launch_bounds__(kThreads)
readout_kernel(const T* __restrict__ mv, const float* __restrict__ vals,
               const int* __restrict__ idx, T* __restrict__ out, int n, int m,
               int cv, int top_k) {
  extern __shared__ __align__(16) float smem[];
  float* w = smem;                                          // [16][top_k]
  int* ids = reinterpret_cast<int*>(w + kQueriesPerBlock * top_k);
  float* z = reinterpret_cast<float*>(ids + kQueriesPerBlock * top_k);

  const int o = blockIdx.y;
  const int q0 = blockIdx.x * kQueriesPerBlock;
  // neighbouring threads read neighbouring queries of one slot t
  for (int e = threadIdx.x; e < kQueriesPerBlock * top_k; e += kThreads) {
    const int t = e / kQueriesPerBlock;
    const int qq = e - t * kQueriesPerBlock;
    const int q = q0 + qq;
    float wt = 0.f;
    int id = 0;
    if (q < n) {
      wt = expf(vals[static_cast<size_t>(t) * n + q] - vals[q]);
      id = idx[static_cast<size_t>(t) * n + q];
    }
    w[qq * top_k + t] = wt;
    ids[qq * top_k + t] = id;
  }
  __syncthreads();
  if (threadIdx.x < kQueriesPerBlock) {
    float s = 0.f;
    for (int t = 0; t < top_k; ++t) s += w[threadIdx.x * top_k + t];
    z[threadIdx.x] = s;
  }
  __syncthreads();

  constexpr int kVec = Vec<T>::kN;
  const int g = threadIdx.x / kGroup;
  const int lane = threadIdx.x % kGroup;
  const T* bank = mv + static_cast<size_t>(o) * m * cv;
  for (int qq = g; qq < kQueriesPerBlock; qq += kGroups) {
    const int q = q0 + qq;
    if (q >= n) break;
    const float* wq = w + qq * top_k;
    const int* iq = ids + qq * top_k;
    const float zq = z[qq];
    for (int c = lane * kVec; c < cv; c += kGroup * kVec) {
      float acc[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] = 0.f;
#pragma unroll 5
      for (int t = 0; t < top_k; ++t) {
        float v[kVec];
        Vec<T>::load(bank + static_cast<size_t>(iq[t]) * cv + c, v);
        const float wt = wq[t];
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[i] = fmaf(wt, v[i], acc[i]);
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] /= zq;
      Vec<T>::store(out + (static_cast<size_t>(o) * n + q) * cv + c, acc);
    }
  }
}

constexpr int kSmallK = 256;  // the largest top_k of readout_kernel

}  // namespace

namespace large_k {

using readout::kFull;
using readout::bulk_copy;
using readout::mbar_arrive;
using readout::mbar_init;
using readout::mbar_wait;
using readout::smem_addr;

constexpr int kWarps = 16;                       // consumer warps
constexpr int kRing = 4;                         // ring stages
constexpr int kThreads = 32 * (kWarps + kRing);  // and a producer warp each
constexpr int kS = 32;                  // rows a stage
constexpr int kMaxStages = 2048;        // stages a tile stages at most
constexpr int kWinWords = 4096;         // bitmap words
constexpr int kWinIds = 32 * kWinWords;  // ids [0, 131,072) of the bitmap
constexpr int kMaxVecs = 64;            // 16-byte columns of a slice (1 KB)
constexpr int kStageBytes = kS * 16 * (kMaxVecs + 1);  // padded rows
constexpr int kWStride = kS + 8;        // floats a row of W: the A loads'
                                        // half-warps hit distinct banks
constexpr int kPre = 8;                 // records a producer lane loads
                                        // before its slot is free
constexpr int kChunkPicks = 8;          // picks a thread sorts a chunk
constexpr int kChunk = kChunkPicks * kThreads;  // picks a chunk of pass 2
constexpr int kDirectQ = 32;            // queries a direct pass sums
constexpr int kDirectT = 128;           // slots a direct slice holds
// the cuts (measured; the head note)
constexpr int kDenseNum = 1, kDenseDen = 8;
constexpr int kShare = 4;           // a tile whose ids span at most kNear
constexpr int kShareFar = 2;        // bytes of rows, and one beyond
constexpr long long kNear = 32ll << 20;

enum Mode { kDirect = 0, kSparse = 1, kDense = 2 };

// misc words of shared memory
enum Misc { kOver = 0, kLive = 1, kLo = 2, kHi = 3, kScan = 4 };

template <int Q>
struct Geo {
  static constexpr size_t kWOff = static_cast<size_t>(kRing) * kStageBytes;
  static constexpr size_t kBitsOff = kWOff + 4ull * kRing * Q * kWStride;
  static constexpr size_t kRowOff = kBitsOff + 4ull * kWinWords;
  static constexpr size_t kSoffOff = kRowOff + 4ull * kWinWords;
  static constexpr size_t kZpOff = kSoffOff + 4ull * (kMaxStages + 4);
  static constexpr size_t kZOff = kZpOff + 4ull * kThreads;
  static constexpr size_t kV0Off = kZOff + 4ull * Q;
  static constexpr size_t kMetaOff = kV0Off + 4ull * Q;
  static constexpr size_t kBarOff = kMetaOff + 8ull * kRing;
  static constexpr size_t kMiscOff = kBarOff + 16ull * kRing;
  static constexpr size_t kSwordOff = kMiscOff + 4 * 64;
  static constexpr size_t kBytes = kSwordOff + 2ull * kMaxStages;
  // pass 2's chunk sort in the ring and the weight tiles: per stage its
  // chunk count (then offset), cursor and running global offset, then the
  // chunk's records and their global positions
  static constexpr size_t kChistOff = 0;
  static constexpr size_t kCurOff = kChistOff + 4ull * kMaxStages;
  static constexpr size_t kRunOff = kCurOff + 4ull * kMaxStages;
  static constexpr size_t kSortOff = kRunOff + 4ull * kMaxStages;
  static constexpr size_t kGposOff = kSortOff + 8ull * kChunk;
  static_assert(kGposOff + 4ull * kChunk <= kBitsOff, "pass 2's sort");
  static_assert(kThreads % Q == 0, "pass 1 gives each query whole threads");
  static_assert(kChunk % Q == 0, "a chunk of pass 2 is whole slots");
  static_assert(8ull * kDirectQ * kDirectT <= kWOff, "direct slice > ring");
  static_assert(kWinIds <= kWOff, "pass 1's id counts exceed the ring");
  static_assert(kBytes <= 232448, "shared memory of one block");
  static_assert(kZpOff % 16 == 0 && kMetaOff % 8 == 0 && kBarOff % 8 == 0,
                "aligned");
};

// The transaction bytes of a phase, without an arrival.
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// acc += w * the 16 bytes `raw` of a value row (8 bf16 or 4 fp32).
template <typename T>
__device__ __forceinline__ void fma16(uint4 raw, float w, float* acc) {
  if constexpr (sizeof(T) == 2) {
    const unsigned h[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[2 * i] = fmaf(w, __uint_as_float(h[i] << 16), acc[2 * i]);
      acc[2 * i + 1] =
          fmaf(w, __uint_as_float(h[i] & 0xffff0000u), acc[2 * i + 1]);
    }
  } else {
    acc[0] = fmaf(w, __uint_as_float(raw.x), acc[0]);
    acc[1] = fmaf(w, __uint_as_float(raw.y), acc[1]);
    acc[2] = fmaf(w, __uint_as_float(raw.z), acc[2]);
    acc[3] = fmaf(w, __uint_as_float(raw.w), acc[3]);
  }
}

__device__ __forceinline__ void ldmatrix_x2_t(unsigned& b0, unsigned& b1,
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b0), "=r"(b1)
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_t(unsigned* b, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 -> fp32.
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 weights as a bf16 pair (hi) and the pair of what hi leaves (lo).
__device__ __forceinline__ void split_pair(float2 x, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x.x, x.y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x.x - hf.x, x.y - hf.y);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&l);
}

// The exclusive prefix sums of a[0, len) in place, by the whole block;
// returns the total.  `tmp` holds a word a warp.
__device__ __forceinline__ int scan_block(int* a, int len, int* tmp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int per = (len + kThreads - 1) / kThreads;
  const int i0 = min(static_cast<int>(threadIdx.x) * per, len);
  const int i1 = min(i0 + per, len);
  int local = 0;
  for (int i = i0; i < i1; ++i) local += a[i];
  int incl = local;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) tmp[warp] = incl;
  __syncthreads();
  int base = incl - local;
  int total = 0;
  for (int i = 0; i < kThreads / 32; ++i) {
    if (i < warp) base += tmp[i];
    total += tmp[i];
  }
  for (int i = i0; i < i1; ++i) {
    const int c = a[i];
    a[i] = base;
    base += c;
  }
  __syncthreads();
  return total;
}

// A consumer warp's walk of the stages and its stores (warp < kWarps):
// for each stage, once its rows and its weight tile W (built by its
// producer) are in, W x the staged rows, on the tensor cores (kDenseSum:
// warp (mt, cg) owns queries [16 mt, 16 mt + 16) and n8 tiles, 16-byte
// columns, [kNT cg, kNT cg + kNT)) or as each query's hits in ascending
// slot (its queries [kQW warp, kQW warp + kQW), the lane's columns lane
// and lane + 32).  The two keep their sums in registers of their own
// layouts.
template <typename T, int Q, bool kDenseSum>
__device__ __forceinline__ void consume(
    const unsigned char* ring, const float* wt, const int2* meta,
    unsigned long long* full, unsigned long long* empty, const float* z,
    T* __restrict__ out, int stages, int n, int q0, int o, int cv, int c0,
    int width, int pitch) {
  constexpr int kVec = Vec<T>::kN;
  constexpr int kQW = Q / kWarps;
  constexpr int kMT = Q / 16;
  constexpr int kNT = kMaxVecs * kMT / kWarps;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int mt = warp % kMT;
  const int cg = warp / kMT;
  const int g8 = lane >> 2;
  const int t4 = lane & 3;
  // dense: the C fragments of kNT n8 tiles; sparse: kQW queries x 2 columns
  float acc[kDenseSum ? kNT : kQW][kDenseSum ? 1 : 2][kDenseSum ? 4 : kVec];
#pragma unroll
  for (int j = 0; j < (kDenseSum ? kNT : kQW); ++j) {
#pragma unroll
    for (int c = 0; c < (kDenseSum ? 1 : 2); ++c) {
#pragma unroll
      for (int u = 0; u < (kDenseSum ? 4 : kVec); ++u) acc[j][c][u] = 0.f;
    }
  }
  for (int g = 0; g < stages; ++g) {
    const int b = g % kRing;
    mbar_wait(full + b, (g / kRing) & 1);
    const int nr = meta[b].y - meta[b].x;
    const float* wg = wt + b * Q * kWStride;
    const T* stage = reinterpret_cast<const T*>(ring + b * kStageBytes);
    if constexpr (kDenseSum) {
      const float* wa = wg + (16 * mt) * kWStride;
#pragma unroll
      for (int ks = 0; ks < kS / 16; ++ks) {
        if (16 * ks >= nr) break;
        const int k0 = 16 * ks + 2 * t4;
        unsigned ahi[4], alo[4];
        split_pair(*reinterpret_cast<const float2*>(wa + g8 * kWStride + k0),
                   ahi[0], alo[0]);
        split_pair(*reinterpret_cast<const float2*>(
                       wa + (g8 + 8) * kWStride + k0), ahi[1], alo[1]);
        split_pair(*reinterpret_cast<const float2*>(
                       wa + g8 * kWStride + k0 + 8), ahi[2], alo[2]);
        split_pair(*reinterpret_cast<const float2*>(
                       wa + (g8 + 8) * kWStride + k0 + 8), ahi[3], alo[3]);
        // lane l's row of the ldmatrix: k row 16 ks + (l & 15), n8 tile jj
        // (lanes 0-15) or jj + 1 (lanes 16-31)
        const T* krow = stage + (16 * ks + (lane & 15)) * pitch;
#pragma unroll
        for (int j = 0; j < kNT; j += 2) {
          const int jj = cg * kNT + j;
          if (jj + 1 < width) {
            unsigned bf[4];
            ldmatrix_x4_t(bf, krow + (jj + (lane >> 4)) * 8);
            mma_bf16(acc[j][0], ahi, bf[0], bf[1]);
            mma_bf16(acc[j][0], alo, bf[0], bf[1]);
            mma_bf16(acc[j + 1][0], ahi, bf[2], bf[3]);
            mma_bf16(acc[j + 1][0], alo, bf[2], bf[3]);
          } else if (jj < width) {
            unsigned b0, b1;
            ldmatrix_x2_t(b0, b1, krow + jj * 8);
            mma_bf16(acc[j][0], ahi, b0, b1);
            mma_bf16(acc[j][0], alo, b0, b1);
          }
        }
      }
    } else {
      const T* lane_row = stage + lane * kVec;
#pragma unroll
      for (int j = 0; j < kQW; ++j) {
        const int qq = warp * kQW + j;
        const float wv = lane < nr ? wg[qq * kWStride + lane] : 0.f;
        unsigned hits = __ballot_sync(kFull, wv != 0.f);
        while (hits) {
          const int s = __ffs(hits) - 1;
          hits &= hits - 1u;
          const float w = __shfl_sync(kFull, wv, s);
          const T* row = lane_row + s * pitch;
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            if (lane + 32 * c < width) {
              fma16<T>(*reinterpret_cast<const uint4*>(row + 32 * c * kVec),
                       w, acc[j][c]);
            }
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + b);
  }

  // normalise and store
  if constexpr (kDenseSum) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qq = 16 * mt + g8 + 8 * h;
      const int q = q0 + qq;
      if (q >= n) continue;
      const float inv = 1.f / z[qq];
      T* orow = out + (static_cast<size_t>(o) * n + q) * cv + c0 * kVec;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int jj = cg * kNT + j;
        if (jj < width) {
          *reinterpret_cast<__nv_bfloat162*>(orow + jj * 8 + 2 * t4) =
              __floats2bfloat162_rn(acc[j][0][2 * h] * inv,
                                    acc[j][0][2 * h + 1] * inv);
        }
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kQW; ++j) {
      const int qq = warp * kQW + j;
      const int q = q0 + qq;
      if (q >= n) continue;
      const float inv = 1.f / z[qq];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = lane + 32 * c;
        if (col < width) {
#pragma unroll
          for (int u = 0; u < kVec; ++u) acc[j][c][u] *= inv;
          Vec<T>::store(out + (static_cast<size_t>(o) * n + q) * cv +
                            (c0 + col) * kVec,
                        acc[j][c]);
        }
      }
    }
  }
}

template <typename T, int Q>
__global__ void __launch_bounds__(kThreads, 1)
readout_large_k_kernel(const T* __restrict__ mv,
                       const float* __restrict__ vals,
                       const int* __restrict__ idx, T* __restrict__ out,
                       int2* scratch, int n, int m, int cv, int top_k,
                       int slices, int* __restrict__ counts) {
  using G = Geo<Q>;
  constexpr int kVec = Vec<T>::kN;
  constexpr bool kDenseOk = sizeof(T) == 2;
  extern __shared__ __align__(128) unsigned char lk_smem[];
  unsigned char* ring = lk_smem;
  float* wt = reinterpret_cast<float*>(lk_smem + G::kWOff);  // [kRing][Q][kWStride]
  unsigned* bits = reinterpret_cast<unsigned*>(lk_smem + G::kBitsOff);
  int* rowoff = reinterpret_cast<int*>(lk_smem + G::kRowOff);
  int* soff = reinterpret_cast<int*>(lk_smem + G::kSoffOff);  // stage offsets
  float* zp = reinterpret_cast<float*>(lk_smem + G::kZpOff);
  float* z = reinterpret_cast<float*>(lk_smem + G::kZOff);
  float* v0s = reinterpret_cast<float*>(lk_smem + G::kV0Off);
  int2* meta = reinterpret_cast<int2*>(lk_smem + G::kMetaOff);
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(lk_smem + G::kBarOff);
  unsigned long long* empty = full + kRing;
  int* misc = reinterpret_cast<int*>(lk_smem + G::kMiscOff);
  // each stage's first bitmap word
  unsigned short* sword =
      reinterpret_cast<unsigned short*>(lk_smem + G::kSwordOff);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool producer = warp >= kWarps;
  const int q0 = blockIdx.x * Q;
  const int o = blockIdx.y;
  const int nv = cv / kVec;
  const int c0 = static_cast<int>(static_cast<long long>(blockIdx.z) * nv /
                                  slices);
  const int width = static_cast<int>(static_cast<long long>(blockIdx.z + 1) *
                                     nv / slices) - c0;  // 16-byte columns
  const int pitch = (width | 1) * kVec;  // an odd count of 16-byte columns
                                         // a staged row: 8 rows, 8 banks
  const unsigned row_bytes = 16u * width;
  const T* bank = mv + static_cast<size_t>(o) * m * cv + c0 * kVec;
  const int words = (min(m, kWinIds) + 31) / 32;

  // 0. zero the ring and the weight tiles (the ring's first 128 KB hold
  // pass 1's counts)
  {
    uint4* p = reinterpret_cast<uint4*>(ring);
    for (int i = tid; i < static_cast<int>(G::kBitsOff / 16); i += kThreads) {
      p[i] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  if (tid == 0) {
    for (int i = 0; i < kRing; ++i) {
      mbar_init(full + i, 32);
      mbar_init(empty + i, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    misc[kOver] = 0;
    misc[kLive] = 0;
    misc[kLo] = kWinIds;
    misc[kHi] = -1;
  }
  __syncthreads();

  // 1. pass 1: each thread walks slots t1, t1 + per, ... of query qq1 and
  // counts each live pick at its id, a byte an id (at most Q picks)
  unsigned* idc = reinterpret_cast<unsigned*>(ring);  // [kWinIds / 4]
  constexpr int kPer = kThreads / Q;
  const int qq1 = tid % Q;
  const int t1 = tid / Q;
  const int q1 = q0 + qq1;
  {
    float zs = 0.f;
    int live = 0, lo = kWinIds, hi = -1;
    bool over = false;
    if (q1 < n) {
      const float v0 = vals[q1];
      if (t1 == 0) v0s[qq1] = v0;
#pragma unroll 4
      for (int t = t1; t < top_k; t += kPer) {
        const size_t at = static_cast<size_t>(t) * n + q1;
        const int id = idx[at];
        const float w = expf(vals[at] - v0);
        if (w > 0.f) {
          zs += w;
          ++live;
          if (id >= kWinIds) {
            over = true;
          } else {
            atomicAdd(idc + (id >> 2), 1u << (8 * (id & 3)));
            lo = min(lo, id);
            hi = max(hi, id);
          }
        }
      }
    }
    zp[t1 * Q + qq1] = zs;
    live = __reduce_add_sync(kFull, live);
    lo = __reduce_min_sync(kFull, lo);
    hi = __reduce_max_sync(kFull, hi);
    over = __any_sync(kFull, over);
    if (lane == 0) {
      atomicAdd(misc + kLive, live);
      atomicMin(misc + kLo, lo);
      atomicMax(misc + kHi, hi);
      if (over) misc[kOver] = 1;
    }
  }
  __syncthreads();
  if (tid < Q) {
    float s = 0.f;
    for (int p = 0; p < kPer; ++p) s += zp[p * Q + tid];
    z[tid] = s;
  }
  // each word's ids with a pick, then their row slots: ascending in id
  for (int wd = tid; wd < words; wd += kThreads) {
    const uint4* c4 = reinterpret_cast<const uint4*>(idc + 8 * wd);
    unsigned b = 0u;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 v = c4[h];
      const unsigned x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          b |= static_cast<unsigned>(((x[j] >> (8 * i)) & 255u) != 0u)
               << (16 * h + 4 * j + i);
        }
      }
    }
    bits[wd] = b;
    rowoff[wd] = __popc(b);
  }
  __syncthreads();
  const int nrows = scan_block(rowoff, words, misc + kScan);
  const int qv = min(Q, n - q0);
  int mode = kDirect;
  if (misc[kOver] == 0 && nrows > 0 && nrows <= kS * kMaxStages) {
    const long long p = misc[kLive];
    if (kDenseOk && p * kDenseDen >=
                        static_cast<long long>(kDenseNum) * qv * nrows) {
      mode = kDense;
    } else {
      const long long span = static_cast<long long>(misc[kHi] - misc[kLo] + 1) *
                             cv * static_cast<long long>(sizeof(T));
      if (p >= static_cast<long long>(span > kNear ? kShareFar : kShare) *
                   nrows) {
        mode = kSparse;
      }
    }
  }
  const int stages = (nrows + kS - 1) / kS;
  if (tid == 0 && counts != nullptr && blockIdx.z == 0 && mode != kDirect) {
    atomicAdd(counts, nrows);
    if (mode == kDense) atomicAdd(counts + 1, stages);
  }
  if (mode != kDirect) {
    // each stage's first word, and its picks (the ids' counts, added by
    // word: a word's rows lie in one stage or two)
    for (int i = tid; i <= stages; i += kThreads) soff[i] = 0;
    __syncthreads();
    for (int wd = tid; wd < words; wd += kThreads) {
      const unsigned b = bits[wd];
      if (!b) continue;
      const int a = rowoff[wd];
      const int st = (a + kS - 1) / kS;
      if (st * kS < a + __popc(b)) {
        sword[st] = static_cast<unsigned short>(wd);
      }
      const uint4* c4 = reinterpret_cast<const uint4*>(idc + 8 * wd);
      int lo = 0, hi = 0;  // picks before and from the stage boundary
      int r = a;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4 v = c4[h];
        const unsigned x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int c = static_cast<int>((x[j] >> (8 * i)) & 255u);
            if (c) {
              if (r < st * kS) {
                lo += c;
              } else {
                hi += c;
              }
              ++r;
            }
          }
        }
      }
      if (lo) atomicAdd(soff + a / kS, lo);
      if (hi) atomicAdd(soff + st, hi);
    }
    __syncthreads();
    scan_block(soff, stages + 1, misc + kScan);
  }
  // the ring's counts back to zero, for the direct branch's slices
  for (int i = tid; i < 8 * words; i += kThreads) idc[i] = 0u;
  __syncthreads();

  if (mode == kDirect) {
    // the kernel above's gather, kDirectQ queries at a time, the tile's
    // picks staged kDirectT slots at a time in the ring
    float* dw = reinterpret_cast<float*>(ring);  // [kDirectQ][kDirectT]
    int* di = reinterpret_cast<int*>(dw + kDirectQ * kDirectT);
    constexpr int kDW = kDirectQ / kWarps;  // queries a warp
    for (int h = 0; h < Q; h += kDirectQ) {
      float acc[kDW][2][kVec];
#pragma unroll
      for (int j = 0; j < kDW; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
#pragma unroll
          for (int u = 0; u < kVec; ++u) acc[j][c][u] = 0.f;
        }
      }
      for (int s0 = 0; s0 < top_k; s0 += kDirectT) {
        // slots in pairs: a pad slot weighs 0 and reads row 0
        const int len = min(kDirectT, (top_k - s0 + 1) & ~1);
        __syncthreads();  // the previous slice is summed
        for (int e = tid; e < kDirectQ * len; e += kThreads) {
          const int t = e / kDirectQ;
          const int qq = e - t * kDirectQ;
          const int q = q0 + h + qq;
          float w = 0.f;
          int id = 0;
          if (q < n && s0 + t < top_k) {
            const size_t at = static_cast<size_t>(s0 + t) * n + q;
            id = idx[at];
            w = expf(vals[at] - v0s[h + qq]);
          }
          dw[qq * kDirectT + t] = w;
          di[qq * kDirectT + t] = id;
        }
        __syncthreads();
        if (warp < kWarps) {
          // each lane keeps 2 queries x 2 slots x 2 columns of rows in
          // flight; a dead pick adds 0 x row 0, as the gather above
          for (int t = 0; t < len; t += 2) {
            uint4 x[kDW][2][2];
            float w[kDW][2];
#pragma unroll
            for (int j = 0; j < kDW; ++j) {
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                const int at = (warp * kDW + j) * kDirectT + t + u;
                w[j][u] = dw[at];
                const T* row = bank + static_cast<size_t>(di[at]) * cv;
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                  const int col = lane + 32 * c;
                  x[j][u][c] = col < width
                                   ? *reinterpret_cast<const uint4*>(
                                         row + col * kVec)
                                   : make_uint4(0u, 0u, 0u, 0u);
                }
              }
            }
#pragma unroll
            for (int j = 0; j < kDW; ++j) {
#pragma unroll
              for (int u = 0; u < 2; ++u) {
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                  fma16<T>(x[j][u][c], w[j][u], acc[j][c]);
                }
              }
            }
          }
        }
      }
      if (warp < kWarps) {
#pragma unroll
        for (int j = 0; j < kDW; ++j) {
          const int qq = h + warp * kDW + j;
          const int q = q0 + qq;
          if (q >= n) continue;
          const float inv = 1.f / z[qq];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = lane + 32 * c;
            if (col < width) {
#pragma unroll
              for (int u = 0; u < kVec; ++u) acc[j][c][u] *= inv;
              Vec<T>::store(out + (static_cast<size_t>(o) * n + q) * cv +
                                (c0 + col) * kVec,
                            acc[j][c]);
            }
          }
        }
      }
    }
    return;
  }

  // 2. pass 2: each live pick's record (slot << 6 | query, weight) into
  // the block's scratch, grouped by stage (soff): a chunk of kChunk picks at
  // a time is counted by stage, sorted in shared memory and written out in
  // runs
  int2* rec = scratch + (static_cast<size_t>(blockIdx.z) * gridDim.y +
                         blockIdx.y) * gridDim.x * Q * top_k +
              static_cast<size_t>(blockIdx.x) * Q * top_k;
  {
    int* chist = reinterpret_cast<int*>(lk_smem + G::kChistOff);
    int* cur = reinterpret_cast<int*>(lk_smem + G::kCurOff);
    int* run = reinterpret_cast<int*>(lk_smem + G::kRunOff);
    int2* sorted = reinterpret_cast<int2*>(lk_smem + G::kSortOff);
    int* gpos = reinterpret_cast<int*>(lk_smem + G::kGposOff);
    for (int i = tid; i < stages; i += kThreads) run[i] = soff[i];
    constexpr int kChunkT = kChunk / Q;  // slots a chunk
    for (int t0 = 0; t0 < top_k; t0 += kChunkT) {
      for (int i = tid; i < stages; i += kThreads) chist[i] = 0;
      __syncthreads();
      int key[kChunkPicks];
      float wk[kChunkPicks];
#pragma unroll
      for (int j = 0; j < kChunkPicks; ++j) {
        const int e = tid + j * kThreads;
        const int t = t0 + e / Q;
        const int qq = e % Q;
        key[j] = -1;
        wk[j] = 0.f;
        if (t < top_k && q0 + qq < n) {
          const size_t at = static_cast<size_t>(t) * n + q0 + qq;
          const int id = idx[at];
          const float w = expf(vals[at] - v0s[qq]);
          if (w > 0.f) {
            const int wd = id >> 5;
            const int slot =
                rowoff[wd] + __popc(bits[wd] & ((1u << (id & 31)) - 1u));
            key[j] = (slot << 6) | qq;
            wk[j] = w;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kChunkPicks; ++j) {
        if (key[j] >= 0) atomicAdd(chist + (key[j] >> 6) / kS, 1);
      }
      __syncthreads();
      const int total = scan_block(chist, stages, misc + kScan);
      for (int i = tid; i < stages; i += kThreads) cur[i] = chist[i];
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kChunkPicks; ++j) {
        if (key[j] >= 0) {
          const int st = (key[j] >> 6) / kS;
          const int lp = atomicAdd(cur + st, 1);
          sorted[lp] = make_int2(key[j], __float_as_int(wk[j]));
          gpos[lp] = run[st] + lp - chist[st];
        }
      }
      __syncthreads();
      for (int i = tid; i < total; i += kThreads) rec[gpos[i]] = sorted[i];
      for (int i = tid; i < stages; i += kThreads) {
        run[i] += cur[i] - chist[i];
      }
      __syncthreads();
    }
  }
  // the ring and the weight tiles back to zero (the dense sums read the
  // rows past a last stage's, with weight 0: they must be finite)
  for (int i = tid; i < static_cast<int>(G::kBitsOff / 16); i += kThreads) {
    reinterpret_cast<uint4*>(ring)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  // 3. the walk: stage g holds row slots [g kS, g kS + kS)
  if (producer) {
    // stage g's producer p = g % kRing loads the stage's first records,
    // and once the consumers release its slot, zeroes the slot's W, arms
    // the full barrier with the rows' bytes, copies the rows (TMA, a lane a
    // row of each word), adds the records into W and arrives, each lane
    // after its own stores
    const int p = warp - kWarps;
    T* dst0 = reinterpret_cast<T*>(ring + p * kStageBytes);
    float* wp = wt + p * Q * kWStride;
    // the block's generic stores to the ring (its zeros) before the copies'
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    for (int g = p; g < stages; g += kRing) {
      const int rs = soff[g];
      const int re = soff[g + 1];
      int2 pre[kPre];
#pragma unroll
      for (int u = 0; u < kPre; ++u) {
        const int i = rs + 32 * u + lane;
        pre[u] = i < re ? __ldcg(rec + i) : make_int2(-1, 0);
      }
      if (g >= kRing) mbar_wait(empty + p, ((g / kRing) - 1) & 1);
      const int r0 = g * kS;
      const int nr = min(kS, nrows - r0);
      if (g >= kRing) {
        for (int i = lane; i < Q * kWStride / 4; i += 32) {
          reinterpret_cast<float4*>(wp)[i] =
              make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
      if (lane == 0) {
        meta[p] = make_int2(r0, r0 + nr);
        mbar_expect_tx(full + p, nr * row_bytes);
      }
      __syncwarp();
      const int wa = sword[g];
      const int wb = g + 1 < stages ? sword[g + 1] : words - 1;
      for (int wd = wa; wd <= wb; ++wd) {
        const unsigned bw = bits[wd];
        const int slot = rowoff[wd] + __popc(bw & ((1u << lane) - 1u)) - r0;
        if (((bw >> lane) & 1u) && slot >= 0 && slot < nr) {
          bulk_copy(dst0 + slot * pitch,
                    bank + static_cast<size_t>(32 * wd + lane) * cv,
                    row_bytes, full + p);
        }
      }
      auto add = [&](int2 x) {
        if (x.x >= 0) {
          atomicAdd(wp + (x.x & 63) * kWStride + (x.x >> 6) - r0,
                    __int_as_float(x.y));
        }
      };
#pragma unroll
      for (int u = 0; u < kPre; ++u) add(pre[u]);
      for (int i0 = rs + 32 * kPre; i0 < re; i0 += 32 * kPre) {
#pragma unroll
        for (int u = 0; u < kPre; ++u) {
          const int i = i0 + 32 * u + lane;
          pre[u] = i < re ? __ldcg(rec + i) : make_int2(-1, 0);
        }
#pragma unroll
        for (int u = 0; u < kPre; ++u) add(pre[u]);
      }
      mbar_arrive(full + p);
    }
    return;
  }
  if constexpr (kDenseOk) {
    if (mode == kDense) {
      consume<T, Q, true>(ring, wt, meta, full, empty, z, out, stages, n, q0,
                          o, cv, c0, width, pitch);
      return;
    }
  }
  consume<T, Q, false>(ring, wt, meta, full, empty, z, out, stages, n, q0,
                       o, cv, c0, width, pitch);
}

template <typename T, int Q>
int launch(const void* mv, const float* vals, const int* idx, void* out,
           void* scratch, int n_obj, int n, int m, int cv, int top_k,
           int slices, int* counts, cudaStream_t stream) {
  auto kernel = readout_large_k_kernel<T, Q>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Geo<Q>::kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + Q - 1) / Q, n_obj, slices);
  kernel<<<grid, kThreads, Geo<Q>::kBytes, stream>>>(
      static_cast<const T*>(mv), vals, idx, static_cast<T*>(out),
      static_cast<int2*>(scratch), n, m, cv, top_k, slices, counts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace large_k

namespace {

template <typename T>
int launch(const void* mv, const float* vals, const int* idx, void* out,
           int n_obj, int n, int m, int cv, int top_k, cudaStream_t stream) {
  const size_t smem =
      8 * static_cast<size_t>(kQueriesPerBlock) * top_k + 4 * kQueriesPerBlock;
  cudaError_t err = cudaFuncSetAttribute(
      readout_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kQueriesPerBlock - 1) / kQueriesPerBlock, n_obj);
  readout_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(mv), vals, idx, static_cast<T*>(out), n, m, cv,
      top_k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// mv [n_obj, m, cv] row-major, 16-byte aligned, cv a multiple of 8; vals
// and idx [top_k, n] from memory_topk_launch or memory_topk_radix_launch
// (every id < m), any top_k >= 1; out [n_obj, n, cv] in mv's dtype.  Above
// 256 slots the large-k kernel, with queries (64 or 32) and slices (at most
// 64 16-byte columns a slice) as memory_readout.py:large_k_geometry
// chooses them, scratch of 8 * queries * top_k bytes for each of its
// blocks (tiles x n_obj x slices), and counts null or two int32 on the
// device that gain the rows staged and the stages summed dense.  Returns a
// cudaError_t code.
int memory_readout_launch(const void* mv, const void* vals, const void* idx,
                          void* out, int n_obj, int n, int m, int cv,
                          int top_k, int queries, int slices, int is_bf16,
                          void* stream, void* scratch, void* counts) {
  if (n <= 0 || n_obj <= 0) return 0;
  const float* v = static_cast<const float*>(vals);
  const int* i = static_cast<const int*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (top_k <= kSmallK) {
    if (is_bf16) {
      return launch<__nv_bfloat16>(mv, v, i, out, n_obj, n, m, cv, top_k, s);
    }
    return launch<float>(mv, v, i, out, n_obj, n, m, cv, top_k, s);
  }
  const int nv = cv * (is_bf16 ? 2 : 4) / 16;  // 16-byte columns
  if (cv <= 0 || cv % 8 || slices < 1 || slices > nv ||
      (nv + slices - 1) / slices > large_k::kMaxVecs ||
      (queries != 64 && queries != 32) || scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int* c = static_cast<int*>(counts);
  if (is_bf16) {
    return queries == 64
               ? large_k::launch<__nv_bfloat16, 64>(mv, v, i, out, scratch,
                                                    n_obj, n, m, cv, top_k,
                                                    slices, c, s)
               : large_k::launch<__nv_bfloat16, 32>(mv, v, i, out, scratch,
                                                    n_obj, n, m, cv, top_k,
                                                    slices, c, s);
  }
  return queries == 64
             ? large_k::launch<float, 64>(mv, v, i, out, scratch, n_obj, n,
                                          m, cv, top_k, slices, c, s)
             : large_k::launch<float, 32>(mv, v, i, out, scratch, n_obj, n,
                                          m, cv, top_k, slices, c, s);
}

const char* memory_readout_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
