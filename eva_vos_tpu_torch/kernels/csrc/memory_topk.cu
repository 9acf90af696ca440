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
// function read newest first.  Both run the two kernels below up to top_k
// 256; above, every selection takes the radix select further down.
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
// The default selection above 256: a two-scoring radix select, into [k, N]
// ------------------------------------------------------------------------
// memory_topk_radix_launch takes any top_k (the wrapper sends it those above
// 256).  The TPU kernel keeps a running list of k per query in VMEM, which
// its estimate admits for any k (4 k block_q words); here the design above
// does not stretch: its per-block lists part[N, n_live, k] take 7.5 GB at
// N = 8,100, 57 live blocks and k = 2,048, and a row's 512-key candidate
// list (kCap) holds less than k.  Memory stays O(N k) words: the
// candidates take cap = 4 k a query, within [4,096, 16,384]; no [N, M]
// buffer.
//
// What bounds it: the bank's scorings.  Each scoring of a query tile stages
// the whole live bank from L2 (14.9 MB of bf16 keys at fill 72) and runs an
// epilogue on every (query, token) score; the bytes from device memory
// (15 MB) and the tensor-core work (0.12 ms at fill 72, N = 8,100) are far
// below that.  A first radix select here scored the bank five times
// (four 8-bit digits, then the compaction) on 16-query tiles: 37.8 GB of L2
// staging at fill 72, 17.6 ms on an H100 at 700 W against 13.0 for
// addmm + torch.topk.  fp32 keys score on the FP32 units (exact products,
// no TF32), where every scoring is dear.  With this design, at fill 72,
// N = 8,100, bf16, a pass over all tiles takes about 1.9 ms on that card:
// half of it the staging alone (3.8 GB from L2), an eighth the products,
// a quarter forming the scores and their digits, a twelfth the
// histogram's atomics (scripts/torch_port_radix_breakdown.py builds the
// kernel without each part).  The design scores at most twice
// in the common case, on 32-query tiles (two m16 mma.sync tiles: a tile's
// histograms of an 11-bit digit take 128 KB of shared memory as 16-bit
// counts, so 64 queries do not fit), and runs the rest of the digits on
// candidates alone (as AIR top-k, SC 2023, re-reads its input only for the
// bins that overflow):
//
//  1. topk_key_norms_kernel: |k|^2 of each live token once (fp32), so that
//     no pass recomputes it.
//  2. topk_radix_kernel: a block a tile of 32 queries walks the live bank in
//     1 KB chunks of keys, warp w the chunks w, w + 16, ... through its own
//     cp.async ring.  bf16: each lane holds its four queries' A fragments
//     and takes each score straight from the mma accumulators; fp32: lanes
//     2 p and 2 p + 1 hold half the channels of queries 2 p and 2 p + 1 in
//     registers, read each token's key as broadcasts and exchange a half
//     sum, so that lane l scores query l.  Keys are 64-bit (score bits,
//     ~id), and the digits run over the whole key, five of 11 bits, then 9,
//     so that ties in score fall to the id bits and keys are distinct.
//     Pass 1 counts the first digit (the ord's top 11 bits) of every live
//     key, a 2,048-bin histogram a query of 16-bit counts by shared
//     atomics (added to a 32-bit one in device memory every 65,520 tokens,
//     so that none overflows), and picks the bin where the query's rank
//     kk = min(k, valid) falls.  Pass 2 writes the keys above that bin to
//     the query's list and appends those in it to its candidates
//     cand[N, cap], slots from shared counters.  A bin of more than cap keys
//     (`escalations` counts such queries) instead feeds the next digit's
//     histogram in pass 2, and pass 3 does the same one digit down, until a
//     bin fits: a tile makes as many passes as its worst query (`scorings`),
//     at most seven, with one call site of the scoring.  When a block's
//     queries agree on the pass (all counting the first digit, or all
//     compacting at it) each score costs a shift and an atomic, or a shift
//     and a compare: the rare key at or above the bin takes a short inline
//     path, so that the lanes that take it hold the warp back little.  With
//     kk == valid every live key is the answer: one pass writes each at its
//     id, and no histogram is kept.
//  3. topk_cand_select_kernel (kk < valid): a block a query moves the
//     `need` largest of its candidates (the slots after the keys above the
//     bin) to its list, by 8-bit digits of the keys over the candidates in
//     shared memory: no scoring, and no sort of the candidates.
//  4. the list sorted descending: kk <= 1,024 by topk_sort_rows_kernel, a
//     warp a query in registers and shuffles (no barrier); above, by
//     topk_sort_chunks_kernel, a block a (query, chunk of 8,192 keys):
//     128-key runs sorted in registers, then merged pairwise in shared
//     memory by the merge path (16 outputs a thread a level), which does
//     O(k log k) work where a bitonic network does O(k log^2 k).
//  5. topk_rank_merge_kernel, only for kk > 8,192: merge passes of sorted
//     runs in device memory, ping-ponging with keys2; a thread a key places
//     it at its index plus its rank in the partner run (a binary search;
//     keys are distinct).
//  6. topk_keys_t_kernel: 32 x 32 tiles of the sorted keys -> vals / idx
//     [k, N], coalesced both ways; (-1e30, 0) in the slots from kk.  Or,
//     for the row selections (rows = 1 or 2), topk_keys_rows_kernel below.
// memory_topk.py states the rules for the tests: radix_threshold the digits,
// each query's final bin and its passes, radix_lists the selection.
//
// Every other selection above 256: the radix select with a row epilogue
// ---------------------------------------------------------------------
// The TPU kernels _kernel_tournament_chunked, _kernel_resident, _kernel_grid,
// _kernel_iter and _kernel (memory_topk.py:590, :801, :302, :187, :264)
// compute the function of _kernel_tournament (the exact top k, ties to the
// lowest id) with other layouts and walks of the bank, TPU tiling choices,
// and take any top_k their VMEM estimate admits.  Their CUDA designs for
// k <= 256 (memory_topk_chunked_launch above, memory_topk_resident.cu,
// memory_topk_grid.cu, memory_topk_iter.cu, memory_topk_sort.cu) hold a
// query's list in 512-key buffers, so above 256 every selection takes this
// radix select: the chunked and resident ones with its transposed write
// (rows = 0), the grid, iterative and sort ones with rows = 1 (softmax
// weights) or 2 (raw scores), whose last stage is topk_keys_rows_kernel in
// place of the transposed write.  It replaces no TPU kernel of its own: it is
// the row output of those three.  A warp a query reads the query's kk sorted
// keys (coalesced, 256 bytes a step), sums exp(v - v_0) over them in fp32
// from the decoded scores, v_0 the first (largest), as the plain
// softmax_weights and the TPU wrapper (memory_topk.py:1184-1185) do, and
// writes [N, top_k] weights (or raw scores) and int32 ids; the slots from kk
// hold weight 0 (raw -1e30) and id 0.  What bounds it: bytes, N kk 8 read
// (twice: the second read of a 16 KB row hits L1 or L2) and N top_k 8
// written, 0.08 ms at N = 8,100, k = 2,048 on the card's 3.35 TB/s.
// memory_topk.py's radix_rows states it.

#include <algorithm>

#include "topk_prune.cuh"

namespace {

using namespace prune;

// kNewest: grid row y is bank block n_live - 1 - y, and floor (null, or
// the running floors [n]) and floored (null, or one int32 counting the rows
// the floor emptied) are read.  The default selection is the instance
// without, so that none of the floor's code is in its kernel.
template <typename T, int CKP, bool kNewest>
__global__ void __launch_bounds__(kThreads1, 1)
topk_prune_block_kernel(const T* __restrict__ qk, const T* __restrict__ mk,
                        u64* __restrict__ part, float* __restrict__ vals,
                        int* __restrict__ idx, int n, int valid, int ck,
                        int top_k, u64* floor, int* __restrict__ escalations,
                        int* floored) {
  extern __shared__ __align__(16) unsigned tile_smem[];
  const BlockSmem s = carve_block(tile_smem);
  const int q0 = blockIdx.x * kQT;
  const int b = kNewest ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int lo = b * kBlk;
  score_tile<T, CKP>(qk, mk, n, q0, lo, min(lo + kBlk, valid), ck, s);

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

template <typename T, int CKP, bool kNewest>
int launch_pruned(const void* qk, const void* mk, u64* part, float* vals,
                  int* idx, int n, int valid, int ck, int top_k, int n_live,
                  u64* floor, int* escalations, int* floored,
                  cudaStream_t stream) {
  const size_t smem = block_smem_bytes(CKP);
  cudaError_t err = cudaFuncSetAttribute(
      topk_prune_block_kernel<T, CKP, kNewest>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kQT - 1) / kQT, n_live);
  topk_prune_block_kernel<T, CKP, kNewest><<<grid, kThreads1, smem, stream>>>(
      static_cast<const T*>(qk), static_cast<const T*>(mk), part, vals, idx,
      n, valid, ck, top_k, floor, escalations, floored);
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
  if (ck < 1 || ck > topk::kMaxKeyWidth || top_k < 1 || top_k > 256 ||
      n_live > kMaxLists || (n_live > 1 && part == nullptr)) {
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
  return topk::with_width(ck, [&](auto w) {
    constexpr int kW = decltype(w)::value;
    if (newest_first) {
      return is_bf16 ? launch_pruned<__nv_bfloat16, kW, true>(
                           qk, mk, p, v, i, n, valid, ck, top_k, n_live, f, e,
                           fl, s)
                     : launch_pruned<float, kW, true>(
                           qk, mk, p, v, i, n, valid, ck, top_k, n_live, f, e,
                           fl, s);
    }
    return is_bf16 ? launch_pruned<__nv_bfloat16, kW, false>(
                         qk, mk, p, v, i, n, valid, ck, top_k, n_live, f, e,
                         fl, s)
                   : launch_pruned<float, kW, false>(
                         qk, mk, p, v, i, n, valid, ck, top_k, n_live, f, e,
                         fl, s);
  });
}

// The large-k selection (top_k above 256; any top_k is taken).

constexpr int kRQ = 32;                   // queries a radix tile: two m16
constexpr int kRWarps = 16;
constexpr int kRThreads = 32 * kRWarps;   // 512
constexpr int kRBins = 2048;              // bins of an 11-bit digit
// Tokens a pass counts into a tile's 16-bit histograms (two bins a word)
// before it adds them to the queries' 32-bit ones in device memory: a bin
// gains at most one a token, so none overflows.  A multiple of 16, the
// most tokens of a staged chunk, so that no chunk straddles two rounds.
constexpr int kRRound = 65520;
constexpr int kRStages = 4;               // a warp's ring of 1 KB chunks
constexpr int kRChunkElems = 8 * 64;      // bf16 of the largest staged piece
constexpr int kRChunkBytes = 1024;
constexpr int kRMaxCap = 16384;           // candidates a query keeps at most
constexpr int kSortChunk = 8192;          // keys a block sorts in shared memory
constexpr int kSortMin = 512;             // the shortest sort: 16 keys a lane
constexpr int kMergeThreads = 256;
constexpr int kTT = 32;                   // the transpose's tile: 32 x 32 keys

// A query's part in a pass over the bank.
enum : int {
  kIdle = 0,     // done (or past n)
  kHist = 1,     // the first digit's histogram of every live key
  kCompact = 2,  // keys above digit b to the list, those at b to candidates
  kSpill = 3,    // as kCompact, but the keys at b (more than cap) feed the
                 // next digit's histogram
  kAll = 4,      // kk == valid: every live key to the list, at its id
};

// What a pass asks of every score of a block, when the block's queries
// agree: the first digit's histogram (kPassHist), the first digit's
// compaction (kPassLevel0: a score below the chosen bin, the common case,
// costs a shift and a compare), every key at its id (kPassAll), or anything
// (kPassAny: consider(), on the query's state in shared memory).
enum : int { kPassHist = 0, kPassLevel0 = 1, kPassAll = 2, kPassAny = 3 };

// Digit `level` of a 64-bit key: five of 11 bits from the top (the score
// bits, then ~id), then the last 9.  The first is the ord's top 11 bits.
__host__ __device__ __forceinline__ int digit_shift(int level) {
  return level < 5 ? 53 - 11 * level : 0;
}
__device__ __forceinline__ unsigned digit_mask(int shift) {
  return shift == 0 ? 511u : 2047u;
}
__device__ __forceinline__ int next_shift(int shift) {
  return shift >= 20 ? shift - 11 : 0;
}
__device__ __forceinline__ unsigned digit_of(u64 key, int shift) {
  return static_cast<unsigned>(key >> shift) & digit_mask(shift);
}

// A query's state in a pass, as every thread that scores it holds it: the
// keys it considers are those with key & mask == pre (an idle query has
// pre 1, mask 0: none).
struct RadixReg {
  u64 pre;
  u64 mask;
  int shift;  // of the digit
  int b;      // the chosen digit (kCompact, kSpill)
  int mode;
};

// The radix kernel's shared memory: [kRQ][kRBins / 2] histograms (16-bit
// counts, bin j in the low half of word j, j + 1,024 in the high half), the
// queries' states and counters, the staging ring [kRWarps][kRStages] of
// 1 KB chunks of keys (a piece of 8 bf16 tokens, or 256 / CKP fp32 ones),
// then, for keys wider than 64 (RadixQueries), the tile's queries.
struct RadixSmem {
  unsigned* hist;
  RadixReg* reg;
  int* gt;     // keys written to the query's list
  int* cn;     // candidates written
  int* rank;   // the rank still sought among the keys in the digit's bin
  int* level;  // of the digit
  void* ring;
  void* queries;
};

__device__ __forceinline__ RadixSmem carve_radix(unsigned char* p) {
  RadixSmem s;
  s.hist = reinterpret_cast<unsigned*>(p);
  p += sizeof(unsigned) * kRQ * kRBins / 2;
  s.reg = reinterpret_cast<RadixReg*>(p);
  p += sizeof(RadixReg) * kRQ;
  s.gt = reinterpret_cast<int*>(p);
  s.cn = s.gt + kRQ;
  s.rank = s.cn + kRQ;
  s.level = s.rank + kRQ;
  s.ring = p + 4 * sizeof(int) * kRQ;
  s.queries = static_cast<unsigned char*>(s.ring) +
              kRChunkBytes * kRWarps * kRStages;
  return s;
}

// Keys wider than 64 keep the tile's queries in shared memory, not in
// registers (2 CKP / 16 A fragments, or CKP fp32 channels, a lane would
// spill): bf16 [kRQ][CKP], 16-byte unit u of row r at u ^ (r mod 8), read
// by ldmatrix a piece at a time; fp32 [kRQ][CKP + 4], a lane's row read as
// float4s (rows 4 words apart in the banks).
template <typename T, int CKP>
struct RadixQueries {
  static constexpr bool kShared = CKP > 64;
  static constexpr int kStride =
      std::is_same<T, float>::value ? CKP + 4 : CKP;
  static constexpr size_t kBytes = kShared ? sizeof(T) * kRQ * kStride : 0;
};

template <typename T, int CKP>
constexpr size_t radix_smem_bytes() {
  return sizeof(unsigned) * kRQ * kRBins / 2 + sizeof(RadixReg) * kRQ +
         4 * sizeof(int) * kRQ + kRChunkBytes * kRWarps * kRStages +
         RadixQueries<T, CKP>::kBytes;
}
static_assert((sizeof(unsigned) * kRQ * kRBins / 2 + sizeof(RadixReg) * kRQ +
               4 * sizeof(int) * kRQ) % 16 == 0,
              "16-byte aligned staging ring");
static_assert(radix_smem_bytes<float, topk::kMaxKeyWidth>() <= 232448 &&
                  radix_smem_bytes<__nv_bfloat16, topk::kMaxKeyWidth>() <=
                      232448,
              "the radix kernel's shared memory fits an SM");

// One more key in bin d of query qi's histogram.  The first digit's top
// bit is the score's sign: the bulk of a query's scores, negative, adds a
// constant 1 to the low halves, which the hardware does for all the lanes
// that hit one word at once.
__device__ __forceinline__ void hist_add(const RadixSmem& s, int qi,
                                         unsigned d) {
  unsigned* word = s.hist + qi * (kRBins / 2) + (d & (kRBins / 2 - 1));
  if (d < kRBins / 2) {
    atomicAdd(word, 1u);
  } else {
    atomicAdd(word, 0x10000u);
  }
}

// The live score of ord `ord` (token tok) of query qi (row q) in this
// pass, by its state st: a key above the chosen digit goes to the query's
// list, one at it to the candidates (or the next digit's histogram).  Slots
// come from shared counters, so list and candidates are in no set order.
// The first digit is the ord's top 11 bits and has no prefix, so the
// passes at it never build the 64-bit key of a score they do not keep.
__device__ __forceinline__ void consider(unsigned ord, int tok, int qi,
                                         size_t q, const RadixReg& st,
                                         const RadixSmem& s, u64* keys,
                                         u64* cand, int kk, int cap) {
  if (st.mode == kIdle) return;  // (kAll queries take kPassAll passes)
  unsigned d;
  if (st.shift == digit_shift(0)) {
    d = ord >> 21;
  } else {
    const u64 key = key_of(ord, tok);
    if ((key & st.mask) != st.pre) return;
    d = digit_of(key, st.shift);
  }
  if (st.mode == kHist) {
    hist_add(s, qi, d);
  } else if (d > static_cast<unsigned>(st.b)) {
    keys[q * kk + atomicAdd(s.gt + qi, 1)] = key_of(ord, tok);
  } else if (d == static_cast<unsigned>(st.b)) {
    if (st.mode == kCompact) {
      cand[q * cap + atomicAdd(s.cn + qi, 1)] = key_of(ord, tok);
    } else {
      hist_add(s, qi, digit_of(key_of(ord, tok), next_shift(st.shift)));
    }
  }
}

// A query's gate on a score's first digit d in a pass of kind `kind`:
// kPassHist counts d, and kPassAll keeps the key, when the gate is 0 (a
// query in that mode); kPassLevel0 takes the score when d >= gate (the
// chosen digit; never for an idle query).
__device__ __forceinline__ unsigned radix_gate(const RadixReg& st, int kind) {
  if (kind == kPassHist) return st.mode == kHist ? 0u : ~0u;
  if (kind == kPassAll) return st.mode == kAll ? 0u : ~0u;
  return st.mode == kCompact || st.mode == kSpill ? static_cast<unsigned>(st.b)
                                                  : ~0u;
}

// A live score of ord `ord` (token tok) of query qi of the tile at q0, by
// the pass's kind and the query's gate: the first digit's histogram, the
// first digit's compaction (inline: the rare key at or above the chosen
// bin costs a few instructions, so that lanes that take it hold the warp
// back little), every key at its id, or consider().
__device__ __forceinline__ void radix_score(unsigned ord, int tok, int qi,
                                            int q0, int kind, unsigned gate,
                                            bool spill, const RadixSmem& s,
                                            u64* keys, u64* cand, int kk,
                                            int cap) {
  const size_t q = static_cast<size_t>(q0 + qi);
  const unsigned d = ord >> 21;
  if (kind == kPassHist) {
    if (gate == 0u) hist_add(s, qi, d);
  } else if (kind == kPassLevel0) {
    if (d < gate) return;
    const u64 key = key_of(ord, tok);
    if (d > gate) {
      keys[q * kk + atomicAdd(s.gt + qi, 1)] = key;
    } else if (!spill) {
      cand[q * cap + atomicAdd(s.cn + qi, 1)] = key;
    } else {
      hist_add(s, qi, digit_of(key, digit_shift(1)));
    }
  } else if (kind == kPassAll) {
    if (gate == 0u) keys[q * kk + tok] = key_of(ord, tok);
  } else {
    consider(ord, tok, qi, q, s.reg[qi], s, keys, cand, kk, cap);
  }
}

// The warp's digit of a histogram of `bins` bins, bin j's count h(j), for
// rank r (1 <= r <= its sum): the bin b at which the counts from the top
// reach r; above, the counts of the bins above b; count, h(b).  32 bins a
// step, from the top.
template <typename H>
__device__ __forceinline__ void choose_digit(H h, int bins, unsigned r,
                                             int& b, unsigned& above,
                                             unsigned& count) {
  const int lane = threadIdx.x & 31;
  unsigned run = 0u;
  b = 0;
  above = 0u;
  count = 0u;
  for (int top = bins - 1; top >= 0; top -= 32) {
    const int bin = top - lane;
    const unsigned x = bin >= 0 ? h(bin) : 0u;
    unsigned incl = x;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    const unsigned hit = __ballot_sync(kFull, run + incl >= r);
    if (hit) {
      const int src = __ffs(hit) - 1;
      b = top - src;
      count = __shfl_sync(kFull, x, src);
      above = run + __shfl_sync(kFull, incl, src) - count;
      return;
    }
    run += __shfl_sync(kFull, incl, 31);
  }
}

// After a pass, query qi's next state (the whole warp calls it): a query
// whose keys are all placed is done; after a histogram, the digit where
// its rank falls, with its candidates kept when they fit cap and the next
// digit's histogram built when they do not.  escalations counts the
// queries whose first bin overflows cap.
// (The histogram is in shared memory, plus hist32's row of the query when
// the pass flushed its earlier rounds there.)
__device__ __forceinline__ void next_state(int qi, const RadixSmem& s,
                                           const unsigned* hist32, int cap,
                                           int* escalations) {
  RadixReg st = s.reg[qi];
  if (st.mode == kIdle) return;
  const int lane = threadIdx.x & 31;
  if (st.mode == kAll || st.mode == kCompact) {
    __syncwarp();
    if (lane == 0) {
      st.mode = kIdle;
      st.pre = 1ull;
      st.mask = 0ull;
      s.reg[qi] = st;
    }
    __syncwarp();
    return;
  }
  int level = s.level[qi];
  if (st.mode == kSpill) {  // the histogram is the next digit's, in bin b
    st.pre |= static_cast<u64>(st.b) << st.shift;
    st.mask |= static_cast<u64>(digit_mask(st.shift)) << st.shift;
    st.shift = digit_shift(++level);
  }
  int b;
  unsigned above, count;
  const unsigned rank = static_cast<unsigned>(s.rank[qi]);
  const int bins = st.shift == 0 ? 512 : kRBins;
  const unsigned* row = s.hist + qi * (kRBins / 2);
  choose_digit([row, hist32](int j) {
                 return ((row[j % (kRBins / 2)] >> (16 * (j / (kRBins / 2)))) &
                         0xffffu) + (hist32 != nullptr ? hist32[j] : 0u);
               },
               bins, rank, b, above, count);
  __syncwarp();
  if (lane == 0) {
    const bool fits = count <= static_cast<unsigned>(cap);
    if (st.mode == kHist && !fits && escalations != nullptr) {
      atomicAdd(escalations, 1);
    }
    st.b = b;
    st.mode = fits ? kCompact : kSpill;
    s.reg[qi] = st;
    s.rank[qi] = static_cast<int>(rank - above);
    s.level[qi] = level;
  }
  __syncwarp();
}

// Stage 1: per query, its list keys[q, 0, kk - need) (the keys above its
// final bin, in no set order) and its candidates cand[q, 0, c) (the keys
// in that bin, c <= cap), meta[q] = (c, need): the top `need` candidates
// complete the list.  kk == valid: the list is every live key at its id,
// meta (0, 0).  norms[t] = |k_t|^2 (topk_key_norms_kernel).  A block a tile
// of kRQ queries, passes over the whole live bank until each of its
// queries is done; scorings (atomicMax) the most passes of a block.  Above
// kRRound valid tokens a pass that counts adds its 16-bit histograms to
// hist32 [n][kRBins] (32-bit) after every kRRound tokens but the last ones,
// and the digits are chosen from both.
template <typename T, int CKP>
__global__ void __launch_bounds__(kRThreads, 1)
topk_radix_kernel(const T* __restrict__ qk, const T* __restrict__ mk,
                  const float* __restrict__ norms, u64* __restrict__ keys,
                  u64* __restrict__ cand, int2* __restrict__ meta,
                  unsigned* __restrict__ hist32, int n, int valid, int ck,
                  int kk, int cap, int* escalations, int* scorings) {
  extern __shared__ __align__(16) unsigned char radix_smem[];
  const RadixSmem s = carve_radix(radix_smem);
  const int q0 = blockIdx.x * kRQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < kRQ) {
    const int qi = threadIdx.x;
    const bool live = q0 + qi < n;
    RadixReg st;
    st.pre = live ? 0ull : 1ull;
    st.mask = 0ull;
    st.shift = digit_shift(0);
    st.b = 0;
    st.mode = !live ? kIdle : kk == valid ? kAll : kHist;
    s.reg[qi] = st;
    s.gt[qi] = 0;
    s.cn[qi] = 0;
    s.rank[qi] = kk == valid ? 0 : kk;
    s.level[qi] = 0;
  }
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  using Q = RadixQueries<T, CKP>;
  using P = Piece<CKP>;
  // score = (2 <q, k> - |k|^2) / sqrt(ck), rounded as the plain read; with
  // sqrt(ck) a power of two (ck = 64 among them) one rounding of
  // <q, k> (2 / root) - |k|^2 / root, both exact scalings
  const KeyScale sc(ck);
  const float two_inv = 2.f * sc.inv;
  // bf16: the tile's queries as A fragments of two m16 tiles (rows g,
  // g + 8 of tile mt are queries 16 mt + g, 16 mt + g + 8), CKP / 16 k16
  // steps, in registers up to CKP = 64; fp32: half of two queries' channels
  // a lane (below), up to CKP = 64; wider keys stage the queries in shared
  // memory (RadixQueries)
  const int g = lane >> 2;
  const int quad = lane & 3;
  constexpr int kRegSteps = Q::kShared ? 1 : CKP / 16;
  unsigned a[2][kRegSteps][4];
  constexpr int kHalf = Q::kShared ? 1 : CKP / 2;
  constexpr int kRot = kHalf == 32 ? 16 : 0;  // see the fp32 pass below
  float qf[2][kHalf];
  if constexpr (Q::kShared) {
    T* qs = static_cast<T*>(s.queries);
    constexpr int kUnits = CKP * sizeof(T) / 16;  // 16-byte units a row
    for (int e = threadIdx.x; e < kRQ * kUnits; e += kRThreads) {
      const int row = e / kUnits;
      const int unit = e % kUnits;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + row < n) {
        v = *reinterpret_cast<const uint4*>(
            reinterpret_cast<const unsigned char*>(
                qk + static_cast<size_t>(q0 + row) * CKP) + 16 * unit);
      }
      const int at = kBf16 ? (unit ^ (row & 7)) : unit;
      *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(
          qs + row * Q::kStride) + 16 * at) = v;
    }
  } else if constexpr (kBf16) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int qa = q0 + 16 * mt + g;
#pragma unroll
      for (int kq = 0; kq < kRegSteps; ++kq) {
        const int c = 16 * kq + 2 * quad;
        a[mt][kq][0] = query_pair(qk, qa, n, c, CKP);
        a[mt][kq][1] = query_pair(qk, qa + 8, n, c, CKP);
        a[mt][kq][2] = query_pair(qk, qa, n, c + 8, CKP);
        a[mt][kq][3] = query_pair(qk, qa + 8, n, c + 8, CKP);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int qa = q0 + (lane & ~1) + j;
#pragma unroll
      for (int c = 0; c < kHalf; c += 8) {
        if (qa < n) {
          load8(qk + static_cast<size_t>(qa) * CKP + kHalf * (lane & 1) +
                    ((c + kRot * (lane & 1)) & (kHalf - 1)),
                qf[j] + c);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) qf[j][c + i] = 0.f;
        }
      }
    }
  }

  int passes = 0;
  for (;;) {
    __syncthreads();
    const RadixReg mine_q = s.reg[threadIdx.x % kRQ];
    const int qmode = threadIdx.x < kRQ ? mine_q.mode : kIdle;
    if (!__syncthreads_or(qmode != kIdle)) break;
    const bool all_hist = __syncthreads_and(qmode == kIdle || qmode == kHist);
    const bool all_level0 = __syncthreads_and(
        qmode == kIdle || ((qmode == kCompact || qmode == kSpill) &&
                           mine_q.shift == digit_shift(0)));
    const bool all_all = __syncthreads_and(qmode == kIdle || qmode == kAll);
    const bool counts = __syncthreads_or(qmode == kHist || qmode == kSpill);
    const int rounds = (valid + kRRound - 1) / kRRound;
    const bool flush = counts && rounds > 1;
    const int kind = all_hist     ? kPassHist
                     : all_level0 ? kPassLevel0
                     : all_all    ? kPassAll
                                  : kPassAny;
    uint4* h4 = reinterpret_cast<uint4*>(s.hist);
    for (int i = threadIdx.x; i < kRQ * kRBins / 8; i += kRThreads) {
      h4[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();
    for (int round = 0; round < rounds; ++round) {
      // tokens [lo_tok, hi_tok) of the live bank, a multiple of 8 from lo_tok
      const int lo_tok = round * kRRound;
      const int hi_tok = min(valid, lo_tok + kRRound);
      // one pass over the live bank: the only scoring of the kernel, so every
      // pass sees the same bits
      if constexpr (kBf16) {
        unsigned gate[2][2];
        bool spill[2][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const RadixReg& st = s.reg[16 * mt + g + 8 * h];
            gate[mt][h] = radix_gate(st, kind);
            spill[mt][h] = st.mode == kSpill;
          }
        }
        __nv_bfloat16* ring = static_cast<__nv_bfloat16*>(s.ring) +
                              warp * kRStages * kRChunkElems;
        const int c0 = lo_tok >> 3;
        const int n_chunks = ((hi_tok + 7) >> 3) - c0;
        const int mine = n_chunks > warp ? (n_chunks - 1 - warp) / kRWarps + 1
                                         : 0;
        // warp w's i-th chunk: tokens [8 (c0 + w + 16 i), + 8), staged as
        // P::kPieces pieces (topk_prune.cuh's Piece, swizzled as there);
        // unit u of the ring is piece u % kPieces of chunk u / kPieces
        auto issue = [&](int u) {
          if (u < mine * P::kPieces) {
            __nv_bfloat16* buf = ring + (u % kRStages) * kRChunkElems;
            const int tok0 = 8 * (c0 + warp + kRWarps * (u / P::kPieces));
            const int ch0 = (u % P::kPieces) * P::kW;
#pragma unroll
            for (int e = lane; e < 8 * P::kUnits; e += 32) {
              const int row = e / P::kUnits;
              const int unit = e % P::kUnits;
              const int tok = tok0 + row;
              const bool live = tok < valid;
              cp_async16(buf + row * P::kW + (P::at(unit, row) << 3),
                         live ? mk + static_cast<size_t>(tok) * CKP + ch0 +
                                    unit * 8
                              : mk,
                         live ? 16 : 0);
            }
          }
          cp_async_commit();
        };
#pragma unroll
        for (int u = 0; u < kRStages - 1; ++u) issue(u);
        // this lane's tokens' |k|^2, loaded a chunk ahead
        float2 sq_next = make_float2(0.f, 0.f);
        if (mine > 0) {
          sq_next = *reinterpret_cast<const float2*>(norms + 8 * (c0 + warp) +
                                                     2 * quad);
        }
        for (int i = 0; i < mine; ++i) {
          const float2 sq = sq_next;
          if (i + 1 < mine) {
            sq_next = *reinterpret_cast<const float2*>(
                norms + 8 * (c0 + warp + kRWarps * (i + 1)) + 2 * quad);
          }
          float d[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) d[mt][e] = 0.f;
          }
#pragma unroll
          for (int p = 0; p < P::kPieces; ++p) {
            const int u = i * P::kPieces + p;
            issue(u + kRStages - 1);
            cp_async_wait<kRStages - 1>();
            __syncwarp();
            const __nv_bfloat16* buf = ring + (u % kRStages) * kRChunkElems;
            unsigned bq[8];
            const int r = lane & 7;
            ldmatrix_x4(bq, buf + r * P::kW +
                                (P::at((lane >> 3) % P::kUnits, r) << 3));
            if constexpr (P::kUnits == 8) {
              ldmatrix_x4(bq + 4,
                          buf + r * P::kW + (P::at((lane >> 3) + 4, r) << 3));
            }
            __syncwarp();  // the ring slot is free for the next issue
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
              for (int kq = 0; kq < P::kW / 16; ++kq) {
                if constexpr (Q::kShared) {
                  // the A fragment of k16 step 4 p + kq from shared memory
                  const int row = 16 * mt + (lane & 7) + 8 * ((lane >> 3) & 1);
                  const int unit = 2 * (4 * p + kq) + (lane >> 4);
                  unsigned af[4];
                  ldmatrix_x4(af, static_cast<const __nv_bfloat16*>(
                                      s.queries) + row * CKP +
                                      ((unit ^ (row & 7)) << 3));
                  mma_bf16(d[mt], af, bq[2 * kq], bq[2 * kq + 1]);
                } else {
                  mma_bf16(d[mt], a[mt][kq], bq[2 * kq], bq[2 * kq + 1]);
                }
              }
            }
          }
          // this lane's tokens: columns 2 quad, 2 quad + 1 of the chunk
          const int tok = 8 * (c0 + warp + kRWarps * i) + 2 * quad;
          const float sqv[2] = {sq.x, sq.y};
          const float sqs[2] = {sq.x * sc.inv, sq.y * sc.inv};
          with_exact(sc, [&](auto exact) {
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int qi = 16 * mt + g + 8 * h;
#pragma unroll
                for (int t = 0; t < 2; ++t) {
                  if (tok + t >= valid) continue;
                  const float x = d[mt][2 * h + t];
                  const float v = decltype(exact)::value
                                      ? fmaf(x, two_inv, -sqs[t])
                                      : sc.div<false>(2.f * x - sqv[t]);
                  radix_score(ord_of(v + 0.f), tok + t, qi, q0, kind,
                              gate[mt][h], spill[mt][h], s, keys, cand, kk,
                              cap);
                }
              }
            }
          });
        }
        cp_async_wait<0>();
      } else {
        // fp32 on the FP32 units, exactly.  Up to CKP = 64, lanes 2 p and
        // 2 p + 1 hold queries 2 p and 2 p + 1 in registers, channels
        // [H h, H h + H) (H = CKP / 2) for lane 2 p + h (at CKP = 64 step c
        // of lane h on channel 32 h + (c + 16 h) % 32, so that the two
        // halves' broadcasts hit distinct banks); a token's key is read from
        // the warp's ring of 1 KB chunks (256 / CKP tokens), and the
        // partner's half sum of the other query is exchanged, so that lane
        // l scores query l (its state in registers).  Wider keys: lane l
        // reads query l's row from shared memory and sums all its channels.
        const unsigned gate = radix_gate(s.reg[lane], kind);
        const bool spill = s.reg[lane].mode == kSpill;
        constexpr int kSlot = kRChunkBytes / sizeof(float);
        constexpr int kTok = kSlot / CKP;  // tokens of a chunk
        constexpr int kRowUnits = CKP / 4;  // 16-byte units of a key
        float* ring = static_cast<float*>(s.ring) + warp * kRStages * kSlot;
        const int h = lane & 1;
        const int c0 = lo_tok / kTok;
        const int n_chunks = (hi_tok + kTok - 1) / kTok - c0;
        const int mine = n_chunks > warp ? (n_chunks - 1 - warp) / kRWarps + 1
                                         : 0;
        auto issue = [&](int i) {
          if (i < mine) {
            float* buf = ring + (i % kRStages) * kSlot;
            const int tok0 = kTok * (c0 + warp + kRWarps * i);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int e = lane + 32 * j;
              const int row = e / kRowUnits;
              const int unit = e % kRowUnits;
              const int tok = tok0 + row;
              const bool live = tok < valid;
              cp_async16(buf + row * CKP + unit * 4,
                         live ? mk + static_cast<size_t>(tok) * CKP + unit * 4
                              : mk,
                         live ? 16 : 0);
            }
          }
          cp_async_commit();
        };
#pragma unroll
        for (int i = 0; i < kRStages - 1; ++i) issue(i);
        // the chunk's |k|^2, loaded a chunk ahead (float4s from 4 tokens)
        auto load_sq = [&](int i, float* out) {
          const float* src = norms + kTok * (c0 + warp + kRWarps * i);
          if constexpr (kTok >= 4) {
#pragma unroll
            for (int e = 0; e < kTok; e += 4) {
              const float4 v = *reinterpret_cast<const float4*>(src + e);
              out[e] = v.x;
              out[e + 1] = v.y;
              out[e + 2] = v.z;
              out[e + 3] = v.w;
            }
          } else {
#pragma unroll
            for (int e = 0; e < kTok; ++e) out[e] = src[e];
          }
        };
        float sq_next[kTok];
        if (mine > 0) load_sq(0, sq_next);
        for (int i = 0; i < mine; ++i) {
          float sq[kTok];
#pragma unroll
          for (int e = 0; e < kTok; ++e) sq[e] = sq_next[e];
          if (i + 1 < mine) load_sq(i + 1, sq_next);
          issue(i + kRStages - 1);
          cp_async_wait<kRStages - 1>();
          __syncwarp();
          const float* buf = ring + (i % kRStages) * kSlot;
          const int tok0 = kTok * (c0 + warp + kRWarps * i);
#pragma unroll
          for (int j = 0; j < kTok; ++j) {
            float dot;
            if constexpr (Q::kShared) {
              const float* qrow =
                  static_cast<const float*>(s.queries) + lane * Q::kStride;
              const float* kr = buf + j * CKP;
              dot = 0.f;
#pragma unroll 8
              for (int c = 0; c < CKP; c += 4) {
                const float4 qv = *reinterpret_cast<const float4*>(qrow + c);
                const float4 kv = *reinterpret_cast<const float4*>(kr + c);
                dot = fmaf(qv.x, kv.x, dot);
                dot = fmaf(qv.y, kv.y, dot);
                dot = fmaf(qv.z, kv.z, dot);
                dot = fmaf(qv.w, kv.w, dot);
              }
            } else {
              const float* kr = buf + j * CKP + kHalf * h;
              float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
              for (int c = 0; c < kHalf; c += 4) {
                const float4 kv = *reinterpret_cast<const float4*>(
                    kr + ((c + kRot * h) & (kHalf - 1)));
                acc0 = fmaf(qf[0][c], kv.x, acc0);
                acc0 = fmaf(qf[0][c + 1], kv.y, acc0);
                acc0 = fmaf(qf[0][c + 2], kv.z, acc0);
                acc0 = fmaf(qf[0][c + 3], kv.w, acc0);
                acc1 = fmaf(qf[1][c], kv.x, acc1);
                acc1 = fmaf(qf[1][c + 1], kv.y, acc1);
                acc1 = fmaf(qf[1][c + 2], kv.z, acc1);
                acc1 = fmaf(qf[1][c + 3], kv.w, acc1);
              }
              const float other = __shfl_xor_sync(kFull, h ? acc0 : acc1, 1);
              dot = (h ? acc1 : acc0) + other;
            }
            const int tok = tok0 + j;
            if (tok < valid) {
              const float v = sc.exact ? fmaf(dot, two_inv, -sc.inv * sq[j])
                                       : sc.div<false>(2.f * dot - sq[j]);
              radix_score(ord_of(v + 0.f), tok, lane, q0, kind, gate, spill,
                          s, keys, cand, kk, cap);
            }
          }
          __syncwarp();  // the ring slot is free for the next issue
        }
        cp_async_wait<0>();
      }
      if (flush && round + 1 < rounds) {  // the counts to the 32-bit rows
        __syncthreads();
        for (int w = threadIdx.x; w < kRQ * kRBins / 2; w += kRThreads) {
          const int qi = w / (kRBins / 2);
          const unsigned c = s.hist[w];
          s.hist[w] = 0u;
          if (q0 + qi >= n) continue;
          unsigned* dst = hist32 + static_cast<size_t>(q0 + qi) * kRBins +
                          w % (kRBins / 2);
          const unsigned lo = (c & 0xffffu) + (round > 0 ? dst[0] : 0u);
          const unsigned hi = (c >> 16) + (round > 0 ? dst[kRBins / 2] : 0u);
          dst[0] = lo;
          dst[kRBins / 2] = hi;
        }
      }
      __syncthreads();
    }  // rounds
    ++passes;
    const unsigned* rows = flush ? hist32 + static_cast<size_t>(q0) * kRBins
                                 : nullptr;
    next_state(warp, s, rows ? rows + warp * kRBins : nullptr, cap,
               escalations);
    next_state(warp + kRWarps, s,
               rows ? rows + (warp + kRWarps) * kRBins : nullptr, cap,
               escalations);
  }
  if (threadIdx.x < kRQ && q0 + static_cast<int>(threadIdx.x) < n) {
    meta[q0 + threadIdx.x] = make_int2(s.cn[threadIdx.x], s.rank[threadIdx.x]);
  }
  if (threadIdx.x == 0 && scorings != nullptr) atomicMax(scorings, passes);
}

// |k_t|^2 in fp32 for t < valid, 0 up to `padded` (the radix kernel reads
// its chunks' norms whole), keys CKP wide.
template <typename T, int CKP>
__global__ void __launch_bounds__(256)
topk_key_norms_kernel(const T* __restrict__ mk, float* __restrict__ norms,
                      int valid, int padded) {
  const int t = blockIdx.x * 256 + threadIdx.x;
  if (t >= padded) return;
  float sq = 0.f;
  if (t < valid) {
#pragma unroll
    for (int c = 0; c < CKP; c += 8) {
      float v[8];
      load8(mk + static_cast<size_t>(t) * CKP + c, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) sq = fmaf(v[i], v[i], sq);
    }
  }
  norms[t] = sq;
}

// The block sort of stage 3 (kk > 1,024): 128-key runs sorted in
// registers by warps (warp_sort_desc, 4 keys a lane), then merged pairwise
// in shared memory, ping-ponging between two buffers, each thread placing
// kMergeOut consecutive outputs of its run pair by the merge path.  Key q
// of a buffer sits at q + q / 16, so that the threads' runs of 16 outputs
// start in distinct banks.
constexpr int kSortRun = 128;
constexpr int kMergeOut = 16;

__host__ __device__ __forceinline__ int padded(int q) { return q + (q >> 4); }

// Outputs [d, d + kMergeOut) of the merge of the descending runs a and b
// (each `run` keys, both from buffer src at padded offsets) to dst from
// position `out` on: i keys of a and d - i of b precede output d (the
// merge path, found by bisection); a key of a goes first on ties.
__device__ __forceinline__ void merge_path(const u64* src, int a, int run,
                                           int d, u64* dst, int out) {
  const int b = a + run;
  int lo = max(0, d - run);
  int hi = min(d, run);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (src[padded(b + d - mid - 1)] <= src[padded(a + mid)]) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int i = lo;
  int j = d - lo;
  u64 x = i < run ? src[padded(a + i)] : 0ull;
  u64 y = j < run ? src[padded(b + j)] : 0ull;
#pragma unroll
  for (int e = 0; e < kMergeOut; ++e) {
    if (j >= run || (i < run && x >= y)) {
      dst[padded(out + e)] = x;
      ++i;
      x = i < run ? src[padded(a + i)] : 0ull;
    } else {
      dst[padded(out + e)] = y;
      ++j;
      y = j < run ? src[padded(b + j)] : 0ull;
    }
  }
}

// The padded length a sort takes for `len` keys: a power of two in
// [kSortMin, kSortChunk].
__host__ __device__ __forceinline__ int sort_width(int len) {
  int p = kSortMin;
  while (p < len) p <<= 1;
  return p;
}

constexpr int kSelThreads = 256;

// Stage 2: a block a query with need > 0 (meta = (c, need)): the `need`
// largest of its c candidates to its list's slots [kk - need, kk), in no
// set order.  The candidates sit in shared memory; 8-bit digits of the
// keys from the top pick the need-th largest (a 256-bin histogram a
// round), until a bin is taken whole; the keys at or above its least key
// are the top need (keys are distinct).
__global__ void __launch_bounds__(kSelThreads)
topk_cand_select_kernel(u64* __restrict__ keys, const u64* __restrict__ cand,
                        const int2* __restrict__ meta, int kk, int cap) {
  extern __shared__ u64 cand_keys[];
  __shared__ unsigned hist[256];
  __shared__ u64 s_pre;
  __shared__ int s_rank;
  __shared__ int s_done;
  __shared__ int s_count;
  const int2 m = meta[blockIdx.x];
  if (m.y == 0) return;
  const u64* c = cand + static_cast<size_t>(blockIdx.x) * cap;
  for (int i = threadIdx.x; i < m.x; i += kSelThreads) cand_keys[i] = c[i];
  if (threadIdx.x == 0) {
    s_pre = 0ull;
    s_rank = m.y;
    s_done = m.y == m.x;  // every candidate is taken
    s_count = 0;
  }
  __syncthreads();
  u64 mask = 0ull;
  for (int shift = 56; shift >= 0 && !s_done; shift -= 8) {
    for (int b = threadIdx.x; b < 256; b += kSelThreads) hist[b] = 0u;
    __syncthreads();
    const u64 pre = s_pre;
    for (int i = threadIdx.x; i < m.x; i += kSelThreads) {
      const u64 key = cand_keys[i];
      if ((key & mask) == pre) {
        atomicAdd(hist + static_cast<unsigned>((key >> shift) & 255u), 1u);
      }
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      int b;
      unsigned above, count;
      const unsigned rank = static_cast<unsigned>(s_rank);
      const unsigned* hp = hist;
      choose_digit([hp](int j) { return hp[j]; }, 256, rank, b, above,
                   count);
      __syncwarp();
      if (threadIdx.x == 0) {
        s_pre = pre | (static_cast<u64>(b) << shift);
        s_rank = static_cast<int>(rank - above);
        s_done = count == rank - above;
      }
    }
    mask |= 255ull << shift;
    __syncthreads();
  }
  const u64 least = s_pre;  // the taken bin's least key (0: all)
  u64* out = keys + static_cast<size_t>(blockIdx.x) * kk + (kk - m.y);
  for (int i = threadIdx.x; i < m.x; i += kSelThreads) {
    const u64 key = cand_keys[i];
    if (key >= least) out[atomicAdd(&s_count, 1)] = key;
  }
}

constexpr int kRowSortWarps = 8;

// Stage 3, kk <= 1,024: a warp a query sorts its list descending in
// registers (R = 512 / 32 or 1,024 / 32 keys a lane, zeros past kk).
template <int R>
__global__ void __launch_bounds__(32 * kRowSortWarps)
topk_sort_rows_kernel(u64* __restrict__ keys, int n, int kk) {
  const int q = blockIdx.x * kRowSortWarps + (threadIdx.x >> 5);
  if (q >= n) return;  // whole warps
  const int lane = threadIdx.x & 31;
  u64* list = keys + static_cast<size_t>(q) * kk;
  u64 v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = 32 * r + lane;
    v[r] = e < kk ? list[e] : 0ull;
  }
  warp_sort_desc<R>(v);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = 32 * r + lane;
    if (e < kk) list[e] = v[r];
  }
}

// Stage 3, kk > 1,024: a block of W warps a (query, chunk of kSortChunk
// keys) sorts the chunk descending, 512 W keys (zeros past it): 128-key
// runs in registers, then log2(4 W) merge levels in shared memory, each
// thread placing 16 outputs a level.
template <int W>
__global__ void __launch_bounds__(32 * W)
topk_sort_chunks_kernel(u64* __restrict__ keys, int kk) {
  extern __shared__ u64 sorted_keys[];  // two buffers of padded(P) keys
  constexpr int P = 512 * W;
  static_assert(P / (32 * W) == kMergeOut, "16 outputs a thread a level");
  const int start = blockIdx.y * kSortChunk;
  const int len = min(kSortChunk, kk - start);
  u64* list = keys + static_cast<size_t>(blockIdx.x) * kk + start;
  const int lane = threadIdx.x & 31;
  u64* src = sorted_keys;
  u64* dst = sorted_keys + padded(P);
  for (int r0 = (threadIdx.x >> 5) * kSortRun; r0 < P; r0 += W * kSortRun) {
    u64 v[kSortRun / 32];
#pragma unroll
    for (int r = 0; r < kSortRun / 32; ++r) {
      const int e = r0 + 32 * r + lane;
      v[r] = e < len ? list[e] : 0ull;
    }
    warp_sort_desc<kSortRun / 32>(v);
#pragma unroll
    for (int r = 0; r < kSortRun / 32; ++r) {
      src[padded(r0 + 32 * r + lane)] = v[r];
    }
  }
  __syncthreads();
  for (int run = kSortRun; run < P; run *= 2) {
    const int out = threadIdx.x * kMergeOut;
    const int a = out & ~(2 * run - 1);
    merge_path(src, a, run, out - a, dst, out);
    __syncthreads();
    u64* t = src;
    src = dst;
    dst = t;
  }
  for (int i = threadIdx.x; i < len; i += 32 * W) list[i] = src[padded(i)];
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

// Stage 4 of the row selections: sorted keys[n, kk] -> rows out_v / out_i
// [n, top_k]: the softmax weights exp(v - v_0) / sum (raw = 0) or the raw
// scores (raw = 1), and the ids; (0 or -1e30, 0) in the slots from kk (with
// kk = 0 every slot is -1e30, weight 1 / top_k, as the plain softmax gives).
// A warp a query, as topk_prune.cuh's write_row.
constexpr int kRowsWarps = 8;

__global__ void __launch_bounds__(32 * kRowsWarps)
topk_keys_rows_kernel(const u64* __restrict__ keys, float* __restrict__ out_v,
                      int* __restrict__ out_i, int n, int kk, int top_k,
                      int raw) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kRowsWarps + (threadIdx.x >> 5);
  if (q >= n) return;  // whole warps
  const u64* row = keys + static_cast<size_t>(q) * kk;
  float* ov = out_v + static_cast<size_t>(q) * top_k;
  int* oi = out_i + static_cast<size_t>(q) * top_k;
  float v0;
  int id0;
  unpack(kk > 0 ? row[0] : 0ull, v0, id0);
  float z = 0.f;
  if (!raw) {
    for (int t = lane; t < top_k; t += 32) {
      float v;
      int id;
      unpack(t < kk ? row[t] : 0ull, v, id);
      z += expf(v - v0);
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) z += __shfl_xor_sync(kFull, z, off);
  }
  for (int t = lane; t < top_k; t += 32) {
    float v;
    int id;
    unpack(t < kk ? row[t] : 0ull, v, id);
    ov[t] = raw ? v : expf(v - v0) / z;
    oi[t] = id;
  }
}

template <int W>
cudaError_t launch_sort_chunks(u64* keys, int n, int kk, cudaStream_t stream) {
  const size_t smem = sizeof(u64) * 2 * padded(512 * W);
  cudaError_t err = cudaFuncSetAttribute(
      topk_sort_chunks_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 chunks(n, (kk + kSortChunk - 1) / kSortChunk);
  topk_sort_chunks_kernel<W><<<chunks, 32 * W, smem, stream>>>(keys, kk);
  return cudaGetLastError();
}

// Stage 3 by the width of a query's list (its first chunk's).
cudaError_t launch_sort(u64* keys, int n, int kk, cudaStream_t stream) {
  const int rows = (n + kRowSortWarps - 1) / kRowSortWarps;
  switch (sort_width(std::min(kk, kSortChunk))) {
    case 512:
      topk_sort_rows_kernel<16><<<rows, 32 * kRowSortWarps, 0, stream>>>(
          keys, n, kk);
      return cudaGetLastError();
    case 1024:
      topk_sort_rows_kernel<32><<<rows, 32 * kRowSortWarps, 0, stream>>>(
          keys, n, kk);
      return cudaGetLastError();
    case 2048: return launch_sort_chunks<4>(keys, n, kk, stream);
    case 4096: return launch_sort_chunks<8>(keys, n, kk, stream);
    default: return launch_sort_chunks<16>(keys, n, kk, stream);
  }
}

// The norms' padded length: whole chunks of the radix kernel's passes (8
// bf16 tokens; 256 / CKP fp32 ones, at most 16).
constexpr int kNormsPad = 16;

template <typename T, int CKP>
int launch_radix(const void* qk, const void* mk, float* vals, int* idx, int n,
                 int valid, int ck, int top_k, u64* keys, u64* keys2,
                 u64* cand, int cap, int2* meta, float* norms, unsigned* hist,
                 int* escalations, int* scorings, int rows,
                 cudaStream_t stream) {
  const int kk = std::min(top_k, valid);
  cudaError_t err;
  if (kk > 0) {
    const int padded = (valid + kNormsPad - 1) / kNormsPad * kNormsPad;
    topk_key_norms_kernel<T, CKP><<<(padded + 255) / 256, 256, 0, stream>>>(
        static_cast<const T*>(mk), norms, valid, padded);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t smem = radix_smem_bytes<T, CKP>();
    err = cudaFuncSetAttribute(topk_radix_kernel<T, CKP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    topk_radix_kernel<T, CKP>
        <<<(n + kRQ - 1) / kRQ, kRThreads, smem, stream>>>(
            static_cast<const T*>(qk), static_cast<const T*>(mk), norms, keys,
            cand, meta, hist, n, valid, ck, kk, cap, escalations, scorings);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (kk < valid) {
      const size_t sel_smem = sizeof(u64) * cap;
      err = cudaFuncSetAttribute(topk_cand_select_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(sel_smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      topk_cand_select_kernel<<<n, kSelThreads, sel_smem, stream>>>(
          keys, cand, meta, kk, cap);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    err = launch_sort(keys, n, kk, stream);
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
  if (rows) {
    topk_keys_rows_kernel<<<(n + kRowsWarps - 1) / kRowsWarps,
                            32 * kRowsWarps, 0, stream>>>(
        keys, vals, idx, n, kk, top_k, rows == 2);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 tiles((n + kTT - 1) / kTT, (top_k + kTT - 1) / kTT);
  topk_keys_t_kernel<<<tiles, kTT * 8, 0, stream>>>(keys, vals, idx, n, kk,
                                                     top_k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// qk [n, ckp], mk [m >= valid, ckp] row-major, 16-byte aligned, fp32
// (is_bf16 = 0) or bf16 (is_bf16 = 1), ckp = topk::padded_width(ck) for
// keys ck wide, 1 <= ck <= 256 (the wrapper zero-pads them; ck sets the
// scale); vals/idx [top_k, n]; 1 <= top_k <= 256.  part: [n, n_live, top_k] 64-bit
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
// qk, mk, vals, idx as for memory_topk_launch; kk = min(top_k, valid).
// Scratch, null when kk = 0: keys [n, kk] 64-bit; keys2 the same, for the
// merge passes when kk > 8,192 (else null is allowed); cand [n, cap] 64-bit
// candidates, 1 <= cap <= 16,384, when kk < valid (else null is allowed);
// meta [n] int2; norms [ceil(valid / 16) * 16] fp32; hist [n, 2,048]
// 32-bit when kk < valid and valid > 65,520 (else null is allowed).
// escalations: null, or one int32 on the device that counts the queries
// whose first bin held more than cap keys (they take more scorings of the
// bank); scorings: null, or one int32 on the device raised (atomicMax) to
// the most passes over the bank that a query tile took.  rows: 0 writes
// vals / idx [top_k, n] (the transposed selections); 1 writes them as rows
// [n, top_k] of softmax weights, 2 of raw scores (the row selections).
// Returns a cudaError_t code.
int memory_topk_radix_launch(const void* qk, const void* mk, void* vals,
                             void* idx, int n, int valid, int ck, int top_k,
                             int is_bf16, void* stream, void* keys,
                             void* keys2, void* cand, void* meta, void* norms,
                             void* hist, void* escalations, void* scorings,
                             int cap, int rows) {
  if (n <= 0) return 0;
  const int live = std::max(valid, 0);
  const int kk = std::min(top_k, live);
  if (ck < 1 || ck > topk::kMaxKeyWidth || top_k < 1 || rows < 0 ||
      rows > 2 ||
      (kk > 0 && (keys == nullptr || meta == nullptr || norms == nullptr)) ||
      (kk > kSortChunk && keys2 == nullptr) ||
      (kk < live && (cand == nullptr || cap < 1 || cap > kRMaxCap ||
                     (live > kRRound && hist == nullptr)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* v = static_cast<float*>(vals);
  int* i = static_cast<int*>(idx);
  u64* k1 = static_cast<u64*>(keys);
  u64* k2 = static_cast<u64*>(keys2);
  u64* c = static_cast<u64*>(cand);
  int2* m = static_cast<int2*>(meta);
  float* nr = static_cast<float*>(norms);
  unsigned* h = static_cast<unsigned*>(hist);
  int* e = static_cast<int*>(escalations);
  int* sc = static_cast<int*>(scorings);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return topk::with_width(ck, [&](auto w) {
    constexpr int kW = decltype(w)::value;
    return is_bf16 ? launch_radix<__nv_bfloat16, kW>(qk, mk, v, i, n, live, ck,
                                                     top_k, k1, k2, c, cap, m,
                                                     nr, h, e, sc, rows, s)
                   : launch_radix<float, kW>(qk, mk, v, i, n, live, ck, top_k,
                                             k1, k2, c, cap, m, nr, h, e, sc,
                                             rows, s);
  });
}

const char* memory_topk_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
