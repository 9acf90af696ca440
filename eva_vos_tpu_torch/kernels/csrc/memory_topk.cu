// Exact top-k memory selection for the STCN memory read (sm_90a), as raw
// scores vals[k, N] and int32 ids idx[k, N] (transposed: the layout the
// readout kernels read).  For every query n: the top_k memory tokens
// t < valid in descending order, ties to the LOWEST token id.  Slots left
// over when valid < top_k hold (-1e30, id 0); their softmax weight is
// exactly 0.
//
// memory_topk_launch replaces eva_vos_tpu/kernels/memory_topk.py:
// _kernel_tournament, reached through tournament_topk_t: the default read's
// selection.  memory_topk_chunked_launch replaces _kernel_tournament_chunked,
// reached through chunked_topk_t: the chunked read's selection, the same
// function read newest first.  Both run the two kernels below.
//
// The default selection: pruned bank blocks, merged into [k, N]
// ------------------------------------------------------------------------
// What bounds it: not the device-memory bytes (15 MB of keys at fill 72)
// nor the tensor-core rate (0.12 ms at fill 72, N = 8,100, CK = 64), but
// the block stage it shares with memory_topk_sort.cu (topk_prune.cuh).
// Each 16-query block stages its bank block's 256 KB of bf16 keys from L2
// (0.8 GB at fill 12, 7.6 GB at fill 72, N = 8,100) and then runs one warp
// per query through the threshold, compaction and ranking passes over 2,048
// scores; its 197 KB of shared memory allow one block an SM.  The sort
// kernel's times (PERF.md) put most of the block time in the row passes:
// their staging runs at ~2.2 TB/s, and top_k = 256, which changes only the
// row passes, takes several times the block time of top_k = 50.  The
// previous design (a serial insertion merge per 32-query block, FMA scores)
// spent its time in the merge while a query's list filled, which is all of
// a small bank: the frame-0 interact reads banks of 1 to 12 frames.
//
// Design.  The TPU kernel streams the bank through a running tournament of
// sorted lists, one per query.  Here the bank blocks are a grid dimension,
// and no list is kept across them:
//
//  1. topk_prune_block_kernel: grid (tiles of 16 queries) x (live 2,048-token
//     bank blocks; blocks past `valid` are never launched).  The block
//     scores its tile (bf16 keys by mma.sync on the tensor cores, fp32 keys
//     on the FP32 units, exactly) and prunes each query's row to the keys at
//     or above the k-th of its group maxima, with the exact escalation where
//     they overflow the 512-key list, then ranks them (topk_prune.cuh).
//     With several live blocks, query q's sorted k keys go to list b of a
//     buffer part[N, n_live, k] of 64-bit keys.  With ONE live block (up to
//     2,048 tokens: every first blocked step of an interact) the keys are
//     the answer: each warp writes them back over its own row of the score
//     tile, and the block stores them transposed, rows t of [k, N] as
//     16-query runs; the merge is not launched.
//  2. topk_merge_t_kernel (topk_prune.cuh, shared with
//     memory_topk_resident.cu): 32 queries a block, a half warp per query:
//     lane h holds the largest head of lists h, h + 16, ...; each output
//     slot is the half warp's largest head (four shuffle steps of 64-bit
//     keys), and only the lane whose list it came from advances that list.
//     The merged keys are staged in shared memory and stored transposed,
//     each row t of [k, N] one 128-byte run of the 32 queries' scores (and
//     of their ids): no [N, k] intermediate and no transpose.
//
// The newest-first selection: the same kernels, with a running floor
// ------------------------------------------------------------------
// What bounds it: the same block stage.  The TPU kernel's one idea beyond
// the default selection is order: it walks the bank newest first, since
// propagation queries are temporally next to the latest memories, and skips
// a sub-block with no score >= the running k-th score tau (the k-th best of
// the tokens seen so far, so tau <= the true k-th score <= every winner's:
// memory_topk.py:611-618).  Here the blocks run in parallel, so no list is
// seen "so far"; what carries over is a floor:
//
//  - newest first: grid row y takes bank block n_live - 1 - y, and blocks
//    are dispatched in grid order, so the newest blocks of every query tile
//    are scored first;
//  - a running floor per query in device memory (zeroed by the launch):
//    each ranked row with k keys raises it by atomicMax to its k-th key
//    (lowered to the least key of its score bits); each row reads it before
//    it compacts and keeps only keys at or above max(tau, floor).  A block's
//    k-th key is at most the query's true k-th key, so no winner is lost,
//    whatever the timing, and the result is the default selection's exactly.
//    A row whose largest key is below the floor writes a dead list and skips
//    the compaction and ranking (`floored` counts those rows); other rows
//    keep fewer candidates to rank.
//
// With no_skip the floor is off (the TPU kernel's sel_notau ablation): the
// default selection with the bank blocks reversed.  On banks where the newest
// block holds no better keys than any other (iid or periodic keys) the floor
// empties few rows; PERF.md records what it gives.
//
// The default selection above 256: a radix select, sorted, into [k, N]
// --------------------------------------------------------------------
// memory_topk_radix_launch takes any top_k (the wrapper sends it those above
// 256).  The TPU kernel keeps a running list of k per query in VMEM, which
// its estimate admits for any k (4 k block_q words); here the design above
// does not stretch: its per-block lists part[N, n_live, k] take 7.5 GB at
// N = 8,100, 57 live blocks and k = 2,048, and a row's 512-key candidate
// list (kCap) holds less than k.  What bounds the radix select: the block
// stage's staging of the bank from L2, as above, once a pass, five passes:
// at fill 72, N = 8,100, k = 512 it took 17.9 ms on an H100 at 700 W, 17.7
// of them the radix kernel, against 13.2 for addmm + torch.topk (PERF.md).
// Design (memory O(N k) words; no [N, M] buffer, no [N, n_live, k] lists):
//
//  1. topk_radix_kernel: one block a tile of 16 queries walks every live
//     2,048-token bank block in order, five times, scoring each with the same
//     score_tile as the block stage above (one call site in the kernel, so
//     every pass sees the same bits).  Passes 1-4 build, per query (one warp
//     each), a 256-bin histogram in shared memory of the next 8-bit digit of
//     the ords that agree with the digits chosen so far (lanes with equal
//     digits add once, by __match_any_sync), and choose the digit at which
//     the counts from the top reach the rank still sought: after four, tau is
//     the ord of the query's kk-th largest key (kk = min(k, valid)) and
//     `need` the number of keys of ord tau among its top kk.  Pass 5 compacts
//     to keys[q, 0, kk): every key of ord > tau (kk - need of them), then the
//     keys of ord tau in id order (a warp prefix over the lanes' columns, in
//     bank-block order) until `need` are taken: ties go to the lowest id.
//     The block leaves the walk once every query has all of its keys.
//  2. topk_sort_chunks_kernel: a block a (query, chunk of kSortChunk keys)
//     sorts its chunk descending in shared memory (bitonic, zero padding).
//  3. topk_rank_merge_kernel, only for kk > kSortChunk: merge passes of
//     sorted runs in device memory, ping-ponging with keys2; a thread a key
//     places it at its index plus its rank in the partner run (a binary
//     search; keys are distinct).
//  4. topk_keys_t_kernel: 32 x 32 tiles of the sorted keys -> vals / idx
//     [k, N], coalesced both ways; (-1e30, 0) in the slots from kk.
// memory_topk.py states the rules for the tests: radix_threshold the digits,
// radix_lists the compaction and its tie rule.

#include <algorithm>

#include "topk_prune.cuh"

namespace {

using namespace prune;

// kNewest: grid row y is bank block n_live - 1 - y, and floor (null, or
// the running floors [n]) and floored (null, or one int32 counting the rows
// the floor emptied) are read.  The default selection is the instance
// without, so that none of the floor's code is in its kernel.
template <typename T, int CK, bool kNewest>
__global__ void __launch_bounds__(kThreads1, 1)
topk_prune_block_kernel(const T* __restrict__ qk, const T* __restrict__ mk,
                        u64* __restrict__ part, float* __restrict__ vals,
                        int* __restrict__ idx, int n, int valid, int top_k,
                        u64* floor, int* __restrict__ escalations,
                        int* floored) {
  extern __shared__ __align__(16) unsigned tile_smem[];
  const BlockSmem s = carve_block(tile_smem);
  const int q0 = blockIdx.x * kQT;
  const int b = kNewest ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int lo = b * kBlk;
  score_tile<T, CK>(qk, mk, n, q0, lo, min(lo + kBlk, valid), s);

  const int warp = threadIdx.x >> 5;
  const int q = q0 + warp;
  unsigned* row = s.tile + warp * kRowStride;
  const bool direct = gridDim.y == 1;  // one live block: no merge
  if (q < n) {
    u64* out = direct ? reinterpret_cast<u64*>(row)
                      : part + (static_cast<size_t>(q) * gridDim.y + b) *
                                   top_k;
    select_row(row, lo, top_k, s.cand + warp * kCap, out, escalations,
               kNewest && floor != nullptr ? floor + q : nullptr,
               kNewest ? floored : nullptr);
  }
  if (!direct) return;
  __syncthreads();
  const u64* keys = reinterpret_cast<const u64*>(s.tile);
  for (int e = threadIdx.x; e < top_k * kQT; e += kThreads1) {
    const int t = e / kQT;
    const int qq = e % kQT;
    if (q0 + qq < n) {
      float v;
      int id;
      unpack(keys[qq * (kRowStride / 2) + t], v, id);
      vals[static_cast<size_t>(t) * n + q0 + qq] = v;
      idx[static_cast<size_t>(t) * n + q0 + qq] = id;
    }
  }
}

template <typename T, int CK, bool kNewest>
int launch_pruned(const void* qk, const void* mk, u64* part, float* vals,
                  int* idx, int n, int valid, int top_k, int n_live,
                  u64* floor, int* escalations, int* floored,
                  cudaStream_t stream) {
  const size_t smem = block_smem_bytes(CK);
  cudaError_t err = cudaFuncSetAttribute(
      topk_prune_block_kernel<T, CK, kNewest>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kQT - 1) / kQT, n_live);
  topk_prune_block_kernel<T, CK, kNewest><<<grid, kThreads1, smem, stream>>>(
      static_cast<const T*>(qk), static_cast<const T*>(mk), part, vals, idx,
      n, valid, top_k, floor, escalations, floored);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_live == 1) return static_cast<int>(err);
  return launch_merge_t<kMergeQ>(part, vals, idx, n, top_k, n_live, stream);
}

// Both selections' checks and launch; floor as for topk_prune_block_kernel,
// zeroed here first.
int launch(const void* qk, const void* mk, void* vals, void* idx, int n,
           int valid, int ck, int top_k, int is_bf16, void* stream,
           void* part, int newest_first, void* floor, void* escalations,
           void* floored) {
  if (n <= 0) return 0;
  const int n_live = live_blocks(valid);
  if (ck != 64 || top_k < 1 || top_k > 256 || n_live > kMaxLists ||
      (n_live > 1 && part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  u64* f = n_live > 1 ? static_cast<u64*>(floor) : nullptr;  // one block
  if (f != nullptr) {
    const cudaError_t err = cudaMemsetAsync(f, 0, sizeof(u64) * n, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  u64* p = static_cast<u64*>(part);
  float* v = static_cast<float*>(vals);
  int* i = static_cast<int*>(idx);
  int* e = static_cast<int*>(escalations);
  int* fl = static_cast<int*>(floored);
  if (newest_first) {
    return is_bf16 ? launch_pruned<__nv_bfloat16, 64, true>(
                         qk, mk, p, v, i, n, valid, top_k, n_live, f, e, fl, s)
                   : launch_pruned<float, 64, true>(
                         qk, mk, p, v, i, n, valid, top_k, n_live, f, e, fl, s);
  }
  return is_bf16 ? launch_pruned<__nv_bfloat16, 64, false>(
                       qk, mk, p, v, i, n, valid, top_k, n_live, f, e, fl, s)
                 : launch_pruned<float, 64, false>(
                       qk, mk, p, v, i, n, valid, top_k, n_live, f, e, fl, s);
}

// The large-k selection (top_k above 256; any top_k is taken).

constexpr int kRadixBins = 256;     // an 8-bit digit of the ord, four passes
constexpr int kSortChunk = 8192;    // keys a block sorts in shared memory
constexpr int kSortThreads = 512;
constexpr int kMergeThreads = 256;
constexpr int kTT = 32;             // the transpose's tile: 32 x 32 keys

// The radix kernel's shared memory: the block stage's, then [kQT][256]
// histogram bins.
inline size_t radix_smem_bytes(int ck) {
  return block_smem_bytes(ck) + sizeof(unsigned) * kQT * kRadixBins;
}

// Adds the warp's row's live ords that agree with `prefix` above bit
// shift + 8 (all live ords when `first`) to hist[(ord >> shift) & 255].
__device__ __forceinline__ void radix_histogram(const unsigned* row,
                                                bool first, int shift,
                                                unsigned prefix,
                                                unsigned* hist) {
  const int lane = threadIdx.x & 31;
  const uint4* row4 = reinterpret_cast<const uint4*>(row);
  for (int i = 0; i < kVecs; ++i) {
    const uint4 o = row4[lane + 32 * i];
    const unsigned ord[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool in = ord[e] != 0u &&
                      (first || (ord[e] >> (shift + 8)) == prefix);
      if (__ballot_sync(kFull, in) == 0u) continue;
      const unsigned digit = in ? (ord[e] >> shift) & 0xffu : 0x100u;
      const unsigned peers = __match_any_sync(kFull, digit);
      if (in && lane == __ffs(peers) - 1) atomicAdd(hist + digit, __popc(peers));
    }
  }
}

// The warp's next digit: the bin, counted from the top, at which the counts
// reach `rank` (at least 1, at most their sum); prefix gains the digit and
// rank becomes the rank within its bin.  Lane l holds bins 255 - 8 l - j.
__device__ __forceinline__ void radix_digit(const unsigned* hist,
                                            unsigned& prefix,
                                            unsigned& rank) {
  const int lane = threadIdx.x & 31;
  unsigned c[8];
  unsigned sum = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c[j] = hist[255 - 8 * lane - j];
    sum += c[j];
  }
  unsigned incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned x = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += x;
  }
  const unsigned hit = __ballot_sync(kFull, incl >= rank);
  const int src = hit ? __ffs(hit) - 1 : 31;
  unsigned digit = 0u, r = rank;
  if (lane == src) {
    unsigned cum = incl - sum;
    bool found = false;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (!found && cum + c[j] >= rank) {
        digit = 255u - 8u * lane - j;
        r = rank - cum;
        found = true;
      }
      cum += c[j];
    }
  }
  prefix = (prefix << 8) | __shfl_sync(kFull, digit, src);
  rank = __shfl_sync(kFull, r, src);
}

// Pass 5 on the warp's row of bank block `lo`: its keys of ord > tau to
// out[gt...] (gt < greater), its keys of ord tau in id order to
// out[greater + ties...] while ties < need; gt and ties run over the blocks.
// Lane l holds columns 4 l + 128 i + e, so an exclusive prefix over the
// lanes of their counts, then e, is the id order within 128 columns.
__device__ __forceinline__ void radix_compact(const unsigned* row, int lo,
                                              unsigned tau, u64* out,
                                              int greater, int need, int& gt,
                                              int& ties) {
  const int lane = threadIdx.x & 31;
  const uint4* row4 = reinterpret_cast<const uint4*>(row);
  for (int i = 0; i < kVecs; ++i) {
    const uint4 o = row4[lane + 32 * i];
    const unsigned ord[4] = {o.x, o.y, o.z, o.w};
    unsigned packed = 0u;  // ties in the high half, keys above in the low
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      packed += ord[e] > tau ? 1u : ord[e] == tau ? 0x10000u : 0u;
    }
    if (__ballot_sync(kFull, packed != 0u) == 0u) continue;
    unsigned incl = packed;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned x = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += x;
    }
    const unsigned total = __shfl_sync(kFull, incl, 31);
    const unsigned ex = incl - packed;
    int pg = gt + static_cast<int>(ex & 0xffffu);
    int pt = ties + static_cast<int>(ex >> 16);
    const int id0 = lo + 4 * (lane + 32 * i);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (ord[e] > tau) {
        if (pg < greater) out[pg] = key_of(ord[e], id0 + e);
        ++pg;
      } else if (ord[e] == tau) {
        if (pt < need) out[greater + pt] = key_of(ord[e], id0 + e);
        ++pt;
      }
    }
    gt += static_cast<int>(total & 0xffffu);
    ties += static_cast<int>(total >> 16);
  }
}

// Stage 1: keys[n, kk], query q's top kk keys (unsorted), for
// 1 <= kk = min(top_k, valid).
template <typename T, int CK>
__global__ void __launch_bounds__(kThreads1, 1)
topk_radix_kernel(const T* __restrict__ qk, const T* __restrict__ mk,
                  u64* __restrict__ keys, int n, int valid, int kk) {
  extern __shared__ __align__(16) unsigned radix_smem[];
  const BlockSmem s = carve_block(radix_smem);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  unsigned* hist =
      reinterpret_cast<unsigned*>(s.s_q + kQT * CK) + warp * kRadixBins;
  const int q0 = blockIdx.x * kQT;
  const int q = q0 + warp;
  const bool live = q < n;
  const unsigned* row = s.tile + warp * kRowStride;
  u64* out = keys + static_cast<size_t>(live ? q : 0) * kk;
  const int n_live = (valid + kBlk - 1) / kBlk;
  unsigned prefix = 0u, rank = static_cast<unsigned>(kk);
  int greater = 0, need = 0, gt = 0, ties = 0;
  for (int pass = 0; pass < 5; ++pass) {
    const int shift = 24 - 8 * pass;  // pass 4 compacts
    __syncwarp();
    if (pass < 4) {
      for (int b = lane; b < kRadixBins; b += 32) hist[b] = 0u;
    } else {
      need = static_cast<int>(rank);
      greater = kk - need;
    }
    __syncwarp();
    for (int blk = 0; blk < n_live; ++blk) {
      const int lo = blk * kBlk;
      score_tile<T, CK>(qk, mk, n, q0, lo, min(lo + kBlk, valid), s);
      if (live) {
        if (pass < 4) {
          radix_histogram(row, pass == 0, shift, prefix, hist);
        } else {
          radix_compact(row, lo, prefix, out, greater, need, gt, ties);
        }
      }
      // the tile is scored again next; pass 5 ends once every query of the
      // tile holds its kk keys
      const bool more = live && (pass < 4 || gt < greater || ties < need);
      if (!__syncthreads_or(more)) break;
    }
    __syncwarp();
    if (live && pass < 4) radix_digit(hist, prefix, rank);
  }
}

// Stage 2: each chunk of kSortChunk keys of a query's list sorted
// descending; p2 (a power of two, at least the longest chunk) keys of
// shared memory, zeros past the chunk, which sort last.
__global__ void __launch_bounds__(kSortThreads)
topk_sort_chunks_kernel(u64* __restrict__ keys, int kk) {
  extern __shared__ u64 sorted_keys[];
  const int start = blockIdx.y * kSortChunk;
  const int len = min(kSortChunk, kk - start);
  int p = 1;
  while (p < len) p <<= 1;
  u64* list = keys + static_cast<size_t>(blockIdx.x) * kk + start;
  for (int i = threadIdx.x; i < p; i += kSortThreads) {
    sorted_keys[i] = i < len ? list[i] : 0ull;
  }
  __syncthreads();
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < p / 2; i += kSortThreads) {
        const int a = 2 * i - (i & (stride - 1));
        const int b = a + stride;
        const u64 x = sorted_keys[a];
        const u64 y = sorted_keys[b];
        if ((x < y) == ((a & size) == 0)) {
          sorted_keys[a] = y;
          sorted_keys[b] = x;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < len; i += kSortThreads) list[i] = sorted_keys[i];
}

// Stage 3: runs of `run` sorted keys merged pairwise into runs of 2 run,
// src -> dst.  A key goes to its run pair's start plus its index in its
// run plus the count of larger keys in the partner run.
__global__ void __launch_bounds__(kMergeThreads)
topk_rank_merge_kernel(const u64* __restrict__ src, u64* __restrict__ dst,
                       int n, int kk, int run) {
  const size_t e = static_cast<size_t>(blockIdx.x) * kMergeThreads +
                   threadIdx.x;
  if (e >= static_cast<size_t>(n) * kk) return;
  const size_t q = e / kk;
  const long long i = static_cast<long long>(e - q * kk);
  const long long a0 = i / (2LL * run) * (2LL * run);
  const long long b0 = a0 + run;
  const u64* list = src + q * kk;
  const u64 x = list[i];
  long long other, len, local;
  if (i < b0) {
    local = i - a0;
    other = b0;
    len = max(0LL, min(static_cast<long long>(run), kk - b0));
  } else {
    local = i - b0;
    other = a0;
    len = run;
  }
  long long lo = 0, hi = len;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (list[other + mid] > x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  dst[q * kk + a0 + local + lo] = x;
}

// Stage 4: sorted keys[n, kk] -> vals / idx [top_k, n], (-1e30, 0) in the
// slots from kk; a block a 32 x 32 tile, read along the keys and written
// along the queries.
__global__ void __launch_bounds__(kTT * 8)
topk_keys_t_kernel(const u64* __restrict__ keys, float* __restrict__ vals,
                   int* __restrict__ idx, int n, int kk, int top_k) {
  __shared__ u64 tile[kTT][kTT + 1];
  const int q0 = blockIdx.x * kTT;
  const int t0 = blockIdx.y * kTT;
  const int tx = threadIdx.x % kTT;
  const int ty = threadIdx.x / kTT;
  for (int r = ty; r < kTT; r += 8) {
    const int q = q0 + r;
    const int t = t0 + tx;
    tile[r][tx] = q < n && t < kk ? keys[static_cast<size_t>(q) * kk + t]
                                  : 0ull;
  }
  __syncthreads();
  for (int r = ty; r < kTT; r += 8) {
    const int t = t0 + r;
    const int q = q0 + tx;
    if (t < top_k && q < n) {
      float v;
      int id;
      unpack(tile[tx][r], v, id);
      vals[static_cast<size_t>(t) * n + q] = v;
      idx[static_cast<size_t>(t) * n + q] = id;
    }
  }
}

template <typename T>
int launch_radix(const void* qk, const void* mk, float* vals, int* idx, int n,
                 int valid, int top_k, u64* keys, u64* keys2,
                 cudaStream_t stream) {
  const int kk = std::min(top_k, valid);
  cudaError_t err;
  if (kk > 0) {
    const size_t smem = radix_smem_bytes(64);
    err = cudaFuncSetAttribute(topk_radix_kernel<T, 64>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    topk_radix_kernel<T, 64><<<(n + kQT - 1) / kQT, kThreads1, smem, stream>>>(
        static_cast<const T*>(qk), static_cast<const T*>(mk), keys, n, valid,
        kk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    int p = 1;
    while (p < std::min(kk, kSortChunk)) p <<= 1;
    const size_t sort_smem = sizeof(u64) * p;
    err = cudaFuncSetAttribute(topk_sort_chunks_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(sort_smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 chunks(n, (kk + kSortChunk - 1) / kSortChunk);
    topk_sort_chunks_kernel<<<chunks, kSortThreads, sort_smem, stream>>>(keys,
                                                                         kk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t total = static_cast<size_t>(n) * kk;
    for (long long run = kSortChunk; run < kk; run *= 2) {
      topk_rank_merge_kernel<<<(total + kMergeThreads - 1) / kMergeThreads,
                               kMergeThreads, 0, stream>>>(
          keys, keys2, n, kk, static_cast<int>(run));
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      u64* t = keys;
      keys = keys2;
      keys2 = t;
    }
  }
  const dim3 tiles((n + kTT - 1) / kTT, (top_k + kTT - 1) / kTT);
  topk_keys_t_kernel<<<tiles, kTT * 8, 0, stream>>>(keys, vals, idx, n, kk,
                                                     top_k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// qk [n, ck], mk [m >= valid, ck] row-major, 16-byte aligned, fp32
// (is_bf16 = 0) or bf16 (is_bf16 = 1), ck = 64 (the STCN key width);
// vals/idx [top_k, n]; 1 <= top_k <= 256.  part: [n, n_live, top_k] 64-bit
// scratch, n_live = max(1, ceil(valid / 2048)) <= 2,048, or null when
// n_live = 1 (no merge).  escalations: null, or one int32 on the device that
// counts the (query, bank block) rows that escalated.  Returns a cudaError_t
// code.
int memory_topk_launch(const void* qk, const void* mk, void* vals, void* idx,
                       int n, int valid, int ck, int top_k, int is_bf16,
                       void* stream, void* part, void* escalations) {
  return launch(qk, mk, vals, idx, n, valid, ck, top_k, is_bf16, stream, part,
                0, nullptr, escalations, nullptr);
}

// The newest-first selection with the running floor (no_skip = 1: without);
// qk, mk, vals, idx, part and escalations as for memory_topk_launch.  floor:
// [n] 64-bit scratch (null is allowed when no_skip = 1 or n_live = 1).
// floored: null, or one int32 on the device that counts the (query, bank
// block) rows that the floor emptied.
int memory_topk_chunked_launch(const void* qk, const void* mk, void* vals,
                               void* idx, int n, int valid, int ck, int top_k,
                               int no_skip, int is_bf16, void* stream,
                               void* part, void* floor, void* escalations,
                               void* floored) {
  if (!no_skip && floor == nullptr && live_blocks(valid) > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(qk, mk, vals, idx, n, valid, ck, top_k, is_bf16, stream, part,
                1, no_skip ? nullptr : floor, escalations, floored);
}

// The default selection for any top_k >= 1 (the wrapper calls it above 256);
// qk, mk, vals, idx as for memory_topk_launch.  keys: [n, kk] 64-bit
// scratch, kk = min(top_k, valid) (null when kk = 0); keys2: the same, for
// the merge passes when kk > 8,192 (else null is allowed).  Returns a
// cudaError_t code.
int memory_topk_radix_launch(const void* qk, const void* mk, void* vals,
                             void* idx, int n, int valid, int ck, int top_k,
                             int is_bf16, void* stream, void* keys,
                             void* keys2) {
  if (n <= 0) return 0;
  const int kk = std::min(top_k, std::max(valid, 0));
  if (ck != 64 || top_k < 1 || (kk > 0 && keys == nullptr) ||
      (kk > kSortChunk && keys2 == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* v = static_cast<float*>(vals);
  int* i = static_cast<int*>(idx);
  u64* k1 = static_cast<u64*>(keys);
  u64* k2 = static_cast<u64*>(keys2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int live = std::max(valid, 0);
  return is_bf16 ? launch_radix<__nv_bfloat16>(qk, mk, v, i, n, live, top_k,
                                               k1, k2, s)
                 : launch_radix<float>(qk, mk, v, i, n, live, top_k, k1, k2,
                                       s);
}

const char* memory_topk_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
