"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the repository root, one card

Phases, each of which raises on failure (so no failure ends with exit 0):

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``eva_vos_tpu_torch/kernels/csrc`` (one
   ``nvcc`` per source, all at once); print each kernel's registers and
   spills, and the HMMA (tensor-core) instructions in the SASS of the
   libraries of the selections that score bf16 keys on the tensor cores
   (``cuobjdump``): the default and newest-first (``memory_topk``), the
   resident (``memory_topk_resident``), the 'select' read's
   (``memory_topk_grid``) and the sort selection's;
3. the six top-k selection kernels (oldest first, newest first with the
   running floor, resident (query tiles walking the bank newest first),
   the 'select' read's, and through ``select_topk`` iterative extraction,
   its default, and per-block sort) against their plain versions at the
   engine's blocked-step shape (N = 5 x 1620 queries, CK = 64, top_k = 50,
   bf16) on banks of 1, 12 and 72 slots of 1620 tokens, random and
   clustered, and at a single-frame step (N = 1620).  The newest-first
   selection is also checked and timed with ``no_skip`` (its floor off).
   The library yardstick of every selection is the dense score product as
   one ``torch.addmm`` (TF32 off and on, the faster kept) and ``torch.topk``
   together (``torch.topk`` alone on the plain scores is printed as
   ``topk_only``).  For the selections on the pruned block stage also their
   block and merge kernels' device times (``torch.profiler``; with one live
   bank block no merge is launched), the rows that took their exact
   escalation and, for the newest-first one, the rows its floor emptied;
   for the resident one its bank segments, its compactions of full
   candidate buffers and, with several segments, its block and merge
   kernels' device times;
   and, on the 72-slot clustered bank at N = 8100, the sort kernel at
   top_k = 256, where each row keeps more candidates than the kernel ranks
   one by one;
4. the two readout kernels against their plain version, ``F.embedding_bag``
   and their bound on the oldest-first selection of every case of phase 3
   (K = 1, CV = 512; K = 2 too on the 72-slot banks at N = 8100), with each
   case's distinct rows and picks per 64-query tile; each must agree bit
   for bit with a second run, the chunked one (the readout stage) with its
   ``no_skip`` too, and it must count as many staged rows as the plan;
5. the selection entry point ``select_topk`` at N = 8100 on a 72-slot
   clustered bank, with no method and with method="sort": the launch
   counters, zeroed just before each call, must show the iterative and the
   sort kernel launched, and the weights and ids must match the plain
   version;
6. the engine at full width (T = 60, 480x854, resnet50/resnet18, top_k=50,
   mem_freq=5, bf16, random seeded weights), features computed once, under
   each memory read: the default 'fused' (oldest-first selection, grid
   readout), 'select' (split-bank selection + gather), and 'fused' with
   the resident selection, and with the newest-first selection and the
   chunked readout.  Each read: a warm-up ``interact`` at frame 0; then
   ENGINE_ITERS timed ones per read with the reads interleaved round-robin
   (fps as median and range), then FRAME30_ITERS untraced ones at frame 30
   from the frame-0 state (its backward pass fuses through FusionNet),
   interleaved too.  The launch counters, zeroed just before each
   ``interact`` and read just after, must show each read's kernels launched,
   the outputs be finite, and one blocked segmentation step through the
   kernels must match the plain read; one more frame-0 interact of the
   chunked read counts the rows its readout staged against the picks;
7. one JSON line with each kernel's launches (from the engine read that
   runs it, or from phase 5 for the iterative and sort kernels), error,
   times and bound.

The last line of standard output is ``{"ok": true, "device": {...}}``.  The
full results also go to ``chiprun_out/chip_smoke.json``.  Without a CUDA
device, or without the repository beside it, the script exits non-zero.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

DEVICE = "cuda"
ENGINE = dict(t=60, h=480, w=854, key_arch="resnet50")
HW_TOKENS = 30 * 54          # key tokens of one 480x864 frame
N_QUERIES = 5 * HW_TOKENS    # one blocked step: mem_freq frames
CK, CV, TOP_K = 64, 512, 50
FILLS = (1, 12, 72)          # bank slots: one memory, one pass, a full bank
ENGINE_ITERS = 10            # timed frame-0 interacts per read, interleaved
FRAME30_ITERS = 3            # untraced frame-30 interacts per read

# H100 SXM data-sheet peaks (dense), for the bound of each kernel
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

# Scores are sums of 64 bf16 x bf16 products in fp32, |terms| up to ~20, in
# another order than the plain version's cuBLAS product: differences stay
# within 64 * 20 * 2^-23 ~ 2e-4.  Ids may differ only where neighbouring
# scores are that close.
SCORE_ATOL = 1e-3
# The readout is a weighted mean in fp32 rounded to bf16 at the end: the two
# versions may land one bf16 ulp apart (2^-8 relative, values up to ~5).
READOUT_RTOL, READOUT_ATOL = 2 ** -7, 2e-2
# One blocked segmentation step, kernels vs plain read, through the bf16
# decoder: readouts one ulp apart, and a swapped near-tied token at the top-k
# boundary, move a few probabilities; the share of pixels off by more than
# PROB_ATOL must stay below PROB_FRAC.
PROB_ATOL, PROB_FRAC = 5e-2, 1e-3


# the block and merge kernels of the selections timed one by one: those
# of the pruned block stage (the transposed and the row-output kernels),
# and the resident kernel with the transposed merge of its segments
SPLIT_KERNELS = {
    "memory_topk": ("topk_prune_block_kernel", "topk_merge_t_kernel"),
    "memory_topk_chunked": ("topk_prune_block_kernel", "topk_merge_t_kernel"),
    "memory_topk_resident": ("topk_resident_kernel", "topk_merge_t_kernel"),
    "memory_topk_grid": ("topk_rows_block_kernel", "topk_rows_merge_kernel"),
    "memory_topk_sort": ("topk_rows_block_kernel", "topk_rows_merge_kernel")}
# the sort kernel's largest top_k: ~300 keys of a row survive its pruning,
# more than it ranks one by one, so it sorts them in a warp
SORT_WIDE_K = 256

# the selections that return [N, k] rows (softmax weights by default)
ROW_SELECTIONS = ("memory_topk_grid", "memory_topk_iter", "memory_topk_sort")
# the selections also checked and timed at a single-frame step (N = 1620)
SINGLE_FRAME = ("memory_topk", "memory_topk_chunked",
                "memory_topk_resident") + ROW_SELECTIONS
# select_topk's arguments that reach each entry-point kernel: no method for
# its default, the iterative kernel
ENTRY_KWARGS = {"memory_topk_iter": {}, "memory_topk_sort": {"method": "sort"}}

# each kernel's source and the TPU kernel it replaces
SOURCES = {"memory_topk": "memory_topk.cu",
           "memory_topk_chunked": "memory_topk.cu",
           "memory_topk_resident": "memory_topk_resident.cu",
           "memory_topk_grid": "memory_topk_grid.cu",
           "memory_topk_iter": "memory_topk_iter.cu",
           "memory_topk_sort": "memory_topk_sort.cu",
           "memory_readout": "memory_readout.cu",
           "memory_readout_chunked": "memory_readout_chunked.cu"}
REPLACES = {"memory_topk": "eva_vos_tpu/kernels/memory_topk.py:380",
            "memory_topk_chunked": "eva_vos_tpu/kernels/memory_topk.py:590",
            "memory_topk_resident": "eva_vos_tpu/kernels/memory_topk.py:801",
            "memory_topk_grid": "eva_vos_tpu/kernels/memory_topk.py:302",
            "memory_topk_iter": "eva_vos_tpu/kernels/memory_topk.py:187",
            "memory_topk_sort": "eva_vos_tpu/kernels/memory_topk.py:264",
            "memory_readout": "eva_vos_tpu/kernels/memory_readout.py:64",
            "memory_readout_chunked":
                "eva_vos_tpu/kernels/memory_readout.py:196"}


def fail(msg: str):
    raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return sorted(times)[len(times) // 2]


def split_ms(torch, fn, name: str, merged: bool = True, reps: int = 5,
             tries: int = 3) -> dict:
    """Mean device time of each of selection ``name``'s block and merge
    kernels (SPLIT_KERNELS) over ``reps`` calls of ``fn``, from a
    ``torch.profiler`` trace (taken again, up to ``tries`` times, when the
    trace lacks a launch).  Without ``merged`` the merge must not launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    block, merge = SPLIT_KERNELS[name]
    want = {block: reps, merge: reps if merged else 0}
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = {k: [] for k in want}
        for e in prof.events():
            for k in want:
                if e.device_type == DeviceType.CUDA and k in e.name:
                    us[k].append(e.time_range.end - e.time_range.start)
        if {k: len(v) for k, v in us.items()} == want:
            return {"block_ms": sum(us[block]) / reps / 1e3,
                    "merge_ms": sum(us[merge]) / reps / 1e3}
    fail(f"the profiler's trace of {name}: "
         f"{ {k: len(v) for k, v in us.items()} } launches, not {want}")


def device_ms(torch, fn, reps: int = 10, tries: int = 3) -> float:
    """Mean device time of ``fn``'s kernels a call over ``reps`` calls, from
    a ``torch.profiler`` trace (taken again, up to ``tries`` times, when a
    call's kernel is missing): the kernel's own time, without the host's
    launch path that CUDA events around a short call also measure."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.end - e.time_range.start for e in prof.events()
              if e.device_type == DeviceType.CUDA]
        if len(us) >= reps:
            return sum(us) / reps / 1e3
    fail(f"the profiler's trace holds {len(us)} kernels for {reps} calls")


def hmma_count(build, name: str):
    """HMMA (tensor-core) instructions in a built library's SASS, or None
    where the toolkit has no ``cuobjdump``."""
    tool = Path(build.nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    out = subprocess.run([str(tool), "-sass", str(build.library_path(name))],
                         capture_output=True, text=True, check=True).stdout
    return sum("HMMA" in line for line in out.splitlines())


def bound_ms(n_bytes: float, flops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def make_bank(torch, gen, qk, fill: int, clustered: bool):
    """Keys [72 slots x 1620, CK] bf16 with ``fill`` slots valid.  Clustered:
    every token is a query key plus small noise, so each query has
    near-tied neighbours (as a static background gives real banks)."""
    m = max(FILLS) * HW_TOKENS
    if clustered:
        src = torch.arange(m, device=qk.device) % qk.shape[0]
        noise = torch.randn((m, CK), generator=gen, device=qk.device)
        mk = qk.float()[src] + 0.05 * noise
    else:
        mk = torch.randn((m, CK), generator=gen, device=qk.device)
    return mk.to(torch.bfloat16), fill * HW_TOKENS


def check_selection(torch, vals, idx, ref_vals, ref_idx, name, k=None):
    k = k or TOP_K
    err = (vals - ref_vals[:k]).abs().max().item()
    if err > SCORE_ATOL:
        fail(f"{name}: selection scores differ by {err}")
    gaps = (ref_vals[:-1] - ref_vals[1:]).abs() <= SCORE_ATOL  # [k, N]
    tied = gaps[:k].clone()
    tied[1:] |= gaps[:k - 1]
    bad = (idx != ref_idx[:k]) & ~tied
    if bad.any():
        fail(f"{name}: {int(bad.sum())} selected ids differ away from ties")
    return err, int((idx != ref_idx[:k]).sum())


def selection_bound(n: int, valid: int, k=None):
    """Bound of an exact top-k selection: read qk and the valid keys once,
    write k (score, id) pairs per query; 2 * CK flops per (query, token)."""
    k = k or TOP_K
    n_bytes = 2 * CK * (n + valid) + 8 * k * n
    return bound_ms(n_bytes, 2.0 * n * valid * CK)


def library_select(torch, mk, q, k=None):
    """One library computation of the selection: the scores as one fp32
    GEMM whose bias is -|k|^2 / sqrt(CK) (2 / sqrt(64) and 1 / sqrt(64) are
    powers of two, so the result is the plain version's), then
    ``torch.topk``.  The bias stays 1-D, so that cuBLASLt adds it in the
    GEMM's epilogue instead of a [N, M] copy of it being read."""
    mk32 = mk.float()
    bias = (mk32 * mk32).sum(-1).mul_(-1.0 / math.sqrt(CK))
    scores = torch.addmm(bias, q.float(), mk32.T, alpha=2.0 / math.sqrt(CK))
    return torch.topk(scores, k or TOP_K, dim=1)


def library_times(torch, mk, q, ref_vals, k=None):
    """``library_select``'s time with TF32 off and on (bf16 keys convert to
    TF32 exactly); each run's scores must match the plain version's."""
    k = k or TOP_K
    times = {}
    for mode in ("fp32", "tf32"):
        torch.backends.cuda.matmul.allow_tf32 = mode == "tf32"
        try:
            vals, _ = library_select(torch, mk, q, k)
            err = (vals.T - ref_vals[:k]).abs().max().item()
            if err > SCORE_ATOL:
                fail(f"library selection ({mode}) scores differ by {err}")
            times[mode] = cuda_ms(
                torch, lambda: library_select(torch, mk, q, k), 5)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    return times


def sort_wide_case(torch, q, mk, valid, esc):
    """The sort kernel at top_k = SORT_WIDE_K on one bank: checked against
    the plain version, timed with its block and merge split and its
    escalated rows, beside the library call at the same k."""
    from eva_vos_tpu_torch.kernels import topk_select_plain, topk_select_sort
    from eva_vos_tpu_torch.kernels.memory_topk import _SELECT_BLOCK

    k, n = SORT_WIDE_K, q.shape[0]
    label = f"memory_topk_sort fill{max(FILLS)}_clustered N={n} top_k={k}"
    ref_vals, ref_idx = topk_select_plain(q, mk, valid, k + 1)
    esc.zero_()
    vals, idx = topk_select_sort(q, mk, valid, k, return_raw=True,
                                 escalations=esc)
    err, n_diff = check_selection(torch, vals.T, idx.T, ref_vals, ref_idx,
                                  label, k)
    rows = n * -(-valid // _SELECT_BLOCK)
    row = dict(kernel="memory_topk_sort", top_k=k, n=n, max_abs_err=err,
               ids_differ=n_diff, escalated_rows=int(esc.item()), rows=rows,
               ms=cuda_ms(torch, lambda: topk_select_sort(q, mk, valid, k),
                          10),
               **split_ms(torch, lambda: topk_select_sort(q, mk, valid, k),
                          "memory_topk_sort"))
    lib = library_times(torch, mk[:valid], q, ref_vals, k)
    row["library_ms"] = min(lib.values())
    row["bound_ms"], row["bound_by"] = selection_bound(n, valid, k)
    print(f"[select] {label}: max|dv|={err:.3g} ids_differ={n_diff} kernel "
          f"{row['ms']:.3f} ms (block kernel {row['block_ms']:.3f} ms + merge "
          f"kernel {row['merge_ms']:.3f} ms), addmm+torch.topk "
          f"{row['library_ms']:.3f} ms (fp32 {lib['fp32']:.3f}, tf32 "
          f"{lib['tf32']:.3f}), bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}), escalated rows {row['escalated_rows']} of "
          f"{rows}", flush=True)
    return row


def no_skip_case(torch, q, mk, valid, sel, chunked_counted, esc, floored,
                 rows: int, label: str) -> dict:
    """The newest-first selection with its floor off (``no_skip``, the JAX
    ``sel_notau`` ablation) on one case: the same output as with the floor,
    bit for bit (the same scores, an exact selection either way), no row
    floored; timed with its block and merge split."""
    from eva_vos_tpu_torch.kernels import topk_select_chunked
    from eva_vos_tpu_torch.kernels.memory_topk import _SELECT_BLOCK

    esc.zero_()
    floored.zero_()
    vals, idx = chunked_counted(q, mk, valid, TOP_K, no_skip=True)
    if not (torch.equal(vals, sel[0]) and torch.equal(idx, sel[1])):
        fail(f"{label} no_skip: differs from the selection with the floor")
    if int(floored.item()):
        fail(f"{label} no_skip: the floor emptied rows")
    timed = lambda: topk_select_chunked(q, mk, valid, TOP_K, no_skip=True)
    out = dict(ms=cuda_ms(torch, timed, 10), escalated_rows=int(esc.item()),
               **split_ms(torch, timed, "memory_topk_chunked",
                          merged=valid > _SELECT_BLOCK))
    print(f"[select] {label} no_skip: equal to the floor's; kernel "
          f"{out['ms']:.3f} ms, block kernel {out['block_ms']:.3f} ms + merge "
          f"kernel {out['merge_ms']:.3f} ms, escalated rows "
          f"{out['escalated_rows']} of {rows}", flush=True)
    return out


def readout_bound(idx, k_obj: int):
    """Bound of the readout: each distinct selected row once per object,
    the selection once, the output once; 2 flops per gathered element."""
    rows = idx.unique().numel()
    n = idx.shape[1]
    n_bytes = k_obj * rows * CV * 2 + 8 * TOP_K * n + k_obj * n * CV * 2
    return bound_ms(n_bytes, 2.0 * k_obj * n * TOP_K * CV), rows


def tile_rows(torch, vals, idx, queries: int):
    """(distinct ids of weight > 0 summed over the tiles of ``queries``
    queries, picks of weight > 0): the rows the readout stage copies for
    one object, and the picks it sums."""
    n = idx.shape[1]
    tile = (torch.arange(n, device=idx.device) // queries).expand_as(idx)
    live = torch.exp(vals - vals[:1]) > 0
    keys = (tile[live].long() << 32) | idx[live].long()
    return keys.unique().numel(), int(live.sum())


def readout_cases(torch, mv2, sels, stage: bool) -> list:
    """The two readout kernels on the default selection of every case of
    the selection phase (``sels``: (case, N) -> (vals, idx)), K = 1, and
    K = 2 at the fullest bank with N = N_QUERIES: each checked against the
    plain version and timed beside it, ``F.embedding_bag`` (K = 1) and the
    bound, with the distinct rows and picks per 64-query tile.  ``stage``:
    the package's chunked readout runs the readout stage, so it must also
    agree bit for bit with a second run and with its ``no_skip``, and count
    the rows that ``tile_rows`` counts at the stage's tile size (the
    default readout, a gather, with a second run).  The chunked readout's
    ``no_skip`` is timed at the fullest clustered bank.  A kernel's ``ms`` and the library's are device
    times (``device_ms``); ``call_ms`` and the plain version's are CUDA
    events around a call."""
    from eva_vos_tpu_torch.kernels import (topk_readout, topk_readout_chunked,
                                           topk_readout_plain)
    from eva_vos_tpu_torch.ops.memory_attention import softmax_weights

    readouts = (("memory_readout", topk_readout),
                ("memory_readout_chunked", topk_readout_chunked))
    staged = torch.zeros(1, dtype=torch.int32, device=mv2.device)
    rows_out = []
    for (case, n), (vals, idx) in sels.items():
        full = case.startswith(f"fill{max(FILLS)}_") and n == N_QUERIES
        for k_obj in ((1, 2) if full else (1,)):
            mv = mv2[:k_obj].contiguous()
            ref = topk_readout_plain(mv, vals, idx)
            plain_ms = cuda_ms(torch, lambda: topk_readout_plain(mv, vals, idx),
                               3)
            lib_ms = None
            if k_obj == 1:
                # one library call for the same weighted gather
                w = softmax_weights(vals.T).to(mv.dtype).contiguous()
                ids = idx.T.long().contiguous()
                lib_ms = device_ms(torch, lambda: torch.nn.functional
                                   .embedding_bag(ids, mv[0], mode="sum",
                                                  per_sample_weights=w))
            (bound, by), rows = readout_bound(idx, k_obj)
            tile64, picks = tile_rows(torch, vals, idx, 64)
            tiles = -(-n // 64)
            row = dict(case=f"{case}_K{k_obj}", n=n, k_obj=k_obj,
                       plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                       bound_by=by, unique_rows=rows,
                       tile64_rows=tile64 / tiles, tile64_picks=picks / tiles)
            note = ""
            if stage:
                from eva_vos_tpu_torch.kernels.memory_readout import (
                    _sm_count, readout_geometry)
                queries, slices = readout_geometry(
                    n, k_obj, CV, mv.element_size(), TOP_K,
                    _sm_count(mv.device))
                want = k_obj * tile_rows(torch, vals, idx, queries)[0]
                row.update(queries=queries, slices=slices, staged_rows=want,
                           sharing=k_obj * picks / want)
                note = (f", chunked: tiles of {queries} x {slices} slices, "
                        f"staged rows {want} (picks / staged rows "
                        f"{row['sharing']:.2f})")
            for name, readout in readouts:
                kw = {}
                counted = stage and name == "memory_readout_chunked"
                if counted:
                    staged.zero_()
                    kw["staged_rows"] = staged
                out = readout(mv, vals, idx, **kw)
                torch.testing.assert_close(out.float(), ref.float(),
                                           rtol=READOUT_RTOL,
                                           atol=READOUT_ATOL)
                if stage:
                    if counted and int(staged.item()) != row["staged_rows"]:
                        fail(f"{name} {case} N={n} K={k_obj}: staged "
                             f"{int(staged.item())} rows, not "
                             f"{row['staged_rows']}")
                    if not torch.equal(readout(mv, vals, idx), out):
                        fail(f"{name} {case} N={n}: two runs differ")
                row[f"{name}_err"] = (out.float() - ref.float()).abs().max(
                    ).item()
                row[f"{name}_ms"] = device_ms(
                    torch, lambda: readout(mv, vals, idx))
                row[f"{name}_call_ms"] = cuda_ms(
                    torch, lambda: readout(mv, vals, idx), 10)
            # out: the chunked readout's, the loop's last
            if stage and not torch.equal(
                    topk_readout_chunked(mv, vals, idx, no_skip=True), out):
                fail(f"memory_readout_chunked {case} N={n} K={k_obj}: "
                     f"no_skip differs")
            if full and k_obj == 1 and case.endswith("clustered"):
                row["memory_readout_chunked_no_skip_ms"] = device_ms(
                    torch, lambda: topk_readout_chunked(mv, vals, idx,
                                                        no_skip=True))
                note += (f", chunked no_skip "
                         f"{row['memory_readout_chunked_no_skip_ms']:.4f} ms")
            rows_out.append(row)
            lib = "None" if lib_ms is None else f"{lib_ms:.3f}"
            print(f"[readout] {case} N={n} K={k_obj}: memory_readout "
                  f"{row['memory_readout_ms']:.4f} ms on the device, "
                  f"{row['memory_readout_call_ms']:.3f} ms a call (max|d| "
                  f"{row['memory_readout_err']:.3g}), memory_readout_chunked "
                  f"{row['memory_readout_chunked_ms']:.4f} / "
                  f"{row['memory_readout_chunked_call_ms']:.3f} ms (max|d| "
                  f"{row['memory_readout_chunked_err']:.3g}), plain "
                  f"{plain_ms:.3f} ms, embedding_bag {lib} ms, bound "
                  f"{bound:.4f} ms ({by}), unique rows {rows}, per 64-query "
                  f"tile {row['tile64_rows']:.1f} distinct rows of "
                  f"{row['tile64_picks']:.1f} picks{note}", flush=True)
    return rows_out


def readout_inputs(torch):
    """The readout phase's inputs as ``kernel_phases`` makes them (the same
    seed and order): the values [2, 72 slots, CV] and the package's default
    selection (``topk_select``) of every case, (case, N) -> (vals, idx)."""
    from eva_vos_tpu_torch.kernels import topk_select

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(0)
    qk = torch.randn((N_QUERIES, CK), generator=gen, device=dev).to(
        torch.bfloat16)
    mv2 = torch.randn((2, max(FILLS) * HW_TOKENS, CV), generator=gen,
                      device=dev).to(torch.bfloat16)
    sels = {}
    for clustered in (False, True):
        for fill in FILLS:
            mk, valid = make_bank(torch, gen, qk, fill, clustered)
            case = f"fill{fill}_{'clustered' if clustered else 'random'}"
            for n in (N_QUERIES, HW_TOKENS):
                sels[(case, n)] = topk_select(qk[:n], mk, valid, TOP_K)
    return mv2, sels


def kernel_phases(torch, results):
    from eva_vos_tpu_torch.kernels import (select_topk, topk_select,
                                           topk_select_chunked,
                                           topk_select_grid, topk_select_plain,
                                           topk_select_resident,
                                           topk_select_sort)
    from eva_vos_tpu_torch.kernels.memory_topk import (_SELECT_BLOCK,
                                                       resident_segments)
    from eva_vos_tpu_torch.ops.memory_attention import (_scores,
                                                        memory_affinity_topk,
                                                        softmax_weights)

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(0)
    qk = torch.randn((N_QUERIES, CK), generator=gen, device=dev).to(
        torch.bfloat16)
    mv2 = torch.randn((2, max(FILLS) * HW_TOKENS, CV), generator=gen,
                      device=dev).to(torch.bfloat16)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    esc = torch.zeros(1, dtype=torch.int32, device=dev)
    floored = torch.zeros(1, dtype=torch.int32, device=dev)
    sel_rows, sels = [], {}

    def topk_counted(q, mk, valid, top_k):
        return topk_select(q, mk, valid, top_k, escalations=esc)

    def chunked_counted(q, mk, valid, top_k, no_skip=False):
        return topk_select_chunked(q, mk, valid, top_k, no_skip=no_skip,
                                   escalations=esc, floored_rows=floored)

    def resident_counted(q, mk, valid, top_k):
        return topk_select_resident(q, mk, valid, top_k, compactions=esc)

    def grid_transposed(q, mk, valid, top_k):
        vals, idx = topk_select_grid(q, mk, valid, top_k, return_raw=True,
                                     escalations=esc)
        return vals.T, idx.T

    def iter_transposed(q, mk, valid, top_k):
        vals, idx = select_topk(mk, q, top_k, valid, return_raw=True)
        return vals.T, idx.T

    def sort_transposed(q, mk, valid, top_k):
        vals, idx = topk_select_sort(q, mk, valid, top_k, return_raw=True,
                                     escalations=esc)
        return vals.T, idx.T

    def entry_timed(kwargs):
        return lambda q, mk, valid: select_topk(mk, q, TOP_K, valid, **kwargs)

    # (name in the kernels line, transposed selection (counting escalations,
    # or the resident kernel's compactions, in esc), the call timed)
    selectors = (
        ("memory_topk", topk_counted,
         lambda q, mk, valid: topk_select(q, mk, valid, TOP_K)),
        ("memory_topk_chunked", chunked_counted,
         lambda q, mk, valid: topk_select_chunked(q, mk, valid, TOP_K)),
        ("memory_topk_resident", resident_counted,
         lambda q, mk, valid: topk_select_resident(q, mk, valid, TOP_K)),
        ("memory_topk_grid", grid_transposed,
         lambda q, mk, valid: topk_select_grid(q, mk, valid, TOP_K)),
        ("memory_topk_iter", iter_transposed,
         entry_timed(ENTRY_KWARGS["memory_topk_iter"])),
        ("memory_topk_sort", sort_transposed,
         entry_timed(ENTRY_KWARGS["memory_topk_sort"])),
    )
    for clustered in (False, True):
        for fill in FILLS:
            mk, valid = make_bank(torch, gen, qk, fill, clustered)
            case = f"fill{fill}_{'clustered' if clustered else 'random'}"
            for n in (N_QUERIES, HW_TOKENS):
                q = qk[:n]
                ref_vals, ref_idx = topk_select_plain(q, mk, valid, TOP_K + 1)
                lib = library_times(torch, mk[:valid], q, ref_vals)
                lib_ms = min(lib.values())
                scores = _scores(mk[:valid], q)
                topk_only_ms = cuda_ms(
                    torch, lambda: torch.topk(scores, TOP_K, dim=1), 5)
                del scores
                plain_ms = cuda_ms(
                    torch, lambda: topk_select_plain(q, mk, valid, TOP_K), 3)
                affinity_ms = cuda_ms(
                    torch, lambda: memory_affinity_topk(mk, q, TOP_K, valid), 3)
                bound, by = selection_bound(n, valid)
                rows = n * -(-valid // _SELECT_BLOCK)
                for name, select, timed in selectors:
                    if n != N_QUERIES and name not in SINGLE_FRAME:
                        continue
                    esc.zero_()
                    floored.zero_()
                    vals, idx = select(q, mk, valid, TOP_K)
                    label = f"{name} {case} N={n}"
                    err, n_diff = check_selection(torch, vals, idx, ref_vals,
                                                  ref_idx, label)
                    if name == "memory_topk":
                        default_sel = (vals, idx)
                    elif name == "memory_topk_chunked" and not (
                            torch.equal(vals, default_sel[0])
                            and torch.equal(idx, default_sel[1])):
                        # the same scores, and an exact selection either way
                        fail(f"{label}: differs from the default selection")
                    if name in ROW_SELECTIONS:
                        w, wi = timed(q, mk, valid)
                        if not torch.equal(wi.T, idx) or not torch.allclose(
                                w, softmax_weights(vals.T), rtol=1e-6,
                                atol=1e-7):
                            fail(f"{label}: weights disagree with raw scores")
                    ms = cuda_ms(torch, lambda: timed(q, mk, valid), 10)
                    row = dict(kernel=name, case=case, n=n, max_abs_err=err,
                               ids_differ=n_diff, ms=ms,
                               plain_ms=(affinity_ms if name in ROW_SELECTIONS
                                         else plain_ms),
                               library_ms=lib_ms, library_fp32_ms=lib["fp32"],
                               library_tf32_ms=lib["tf32"],
                               topk_only_ms=topk_only_ms,
                               bound_ms=bound, bound_by=by)
                    note = ""
                    if name == "memory_topk_resident":
                        segs = resident_segments(n, valid, TOP_K, sms)
                        row.update(compactions=int(esc.item()), segments=segs)
                        note = (f", segments {segs}, compactions "
                                f"{row['compactions']} ("
                                f"{row['compactions'] / n:.2f} a query)")
                        if segs > 1:
                            row.update(split_ms(
                                torch, lambda: timed(q, mk, valid), name))
                            note += (f", block kernel {row['block_ms']:.3f} "
                                     f"ms + merge kernel "
                                     f"{row['merge_ms']:.3f} ms")
                    elif name in SPLIT_KERNELS:
                        row.update(split_ms(
                            torch, lambda: timed(q, mk, valid), name,
                            merged=valid > _SELECT_BLOCK),
                            escalated_rows=int(esc.item()), rows=rows)
                        note = (f", block kernel {row['block_ms']:.3f} ms + "
                                f"merge kernel {row['merge_ms']:.3f} ms, "
                                f"escalated rows {row['escalated_rows']} of "
                                f"{rows} ({row['escalated_rows'] / rows:.2e})")
                    if name == "memory_topk_chunked":
                        row["floored_rows"] = int(floored.item())
                        note += (f", floored rows {row['floored_rows']} of "
                                 f"{rows}")
                        row["no_skip"] = no_skip_case(
                            torch, q, mk, valid, (vals, idx), chunked_counted,
                            esc, floored, rows, label)
                    sel_rows.append(row)
                    print(f"[select] {label}: max|dv|={err:.3g} ids_differ="
                          f"{n_diff} kernel {ms:.3f} ms, plain "
                          f"{row['plain_ms']:.3f} ms, addmm+torch.topk "
                          f"{lib_ms:.3f} ms (fp32 {lib['fp32']:.3f}, tf32 "
                          f"{lib['tf32']:.3f}), topk_only {topk_only_ms:.3f} "
                          f"ms, bound {bound:.4f} ms ({by}){note}", flush=True)
                    if name == "memory_topk":
                        sels[(case, n)] = (vals, idx)
                if clustered and fill == max(FILLS) and n == N_QUERIES:
                    results["sort_wide"] = sort_wide_case(torch, q, mk, valid,
                                                          esc)

            del mk
    results["selection"] = sel_rows
    results["readout"] = readout_cases(torch, mv2, sels, stage=True)


def entry_phase(torch, results):
    """``select_topk`` as a user calls it, at N = 8100 on a 72-slot
    clustered bank: with no method (the iterative kernel) and with
    method="sort".  Returns each kernel's launches from its call."""
    from eva_vos_tpu_torch.kernels import select_topk, topk_select_plain
    from eva_vos_tpu_torch.ops.memory_attention import softmax_weights

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(1)
    qk = torch.randn((N_QUERIES, CK), generator=gen, device=dev).to(
        torch.bfloat16)
    mk, valid = make_bank(torch, gen, qk, max(FILLS), clustered=True)
    ref_vals, ref_idx = topk_select_plain(qk, mk, valid, TOP_K + 1)
    counters = launch_counters()
    launches, rows = {}, []
    for name, kwargs in ENTRY_KWARGS.items():
        for c in counters.values():
            c.launches = 0
        w, idx = select_topk(mk, qk, TOP_K, valid, **kwargs)
        torch.cuda.synchronize()
        counts = {k: c.launches for k, c in counters.items()}
        if counts[name] <= 0 or sum(counts.values()) != counts[name]:
            fail(f"select_topk({kwargs}) launched {counts}, not {name}")
        launches[name] = counts[name]
        vals, raw_idx = select_topk(mk, qk, TOP_K, valid, return_raw=True,
                                    **kwargs)
        if not torch.equal(raw_idx, idx) or not torch.allclose(
                w, softmax_weights(vals), rtol=1e-6, atol=1e-7):
            fail(f"select_topk({kwargs}): weights disagree with raw scores")
        err, n_diff = check_selection(torch, vals.T, idx.T, ref_vals, ref_idx,
                                      f"select_topk({kwargs})")
        if w.shape != (N_QUERIES, TOP_K) or not torch.isfinite(w).all():
            fail(f"select_topk({kwargs}): weights {tuple(w.shape)} not finite")
        rows.append(dict(kernel=name, kwargs=kwargs, launches=counts,
                         max_abs_err=err, ids_differ=n_diff))
        print(f"[entry] select_topk(mk, qk, {TOP_K}, {valid}, **{kwargs}) "
              f"launched "
              f"{counts}; max|dv|={err:.3g} ids_differ={n_diff}", flush=True)
    results["entry"] = rows
    return launches


def engine_paths():
    """The engine's memory reads: name -> (EngineConfig fields, the kernels
    that read must launch)."""
    from eva_vos_tpu_torch.kernels import KernelConfig

    return {
        "fused": (dict(readout_strategy="auto"),
                  ("memory_topk", "memory_readout")),
        "select": (dict(readout_strategy="select"), ("memory_topk_grid",)),
        "fused_resident": (
            dict(readout_strategy="fused",
                 kernels=KernelConfig(sel_method="resident")),
            ("memory_topk_resident", "memory_readout")),
        "fused_chunked_chunked": (
            dict(readout_strategy="fused",
                 kernels=KernelConfig(sel_method="chunked",
                                      readout_method="chunked")),
            ("memory_topk_chunked", "memory_readout_chunked")),
    }


def launch_counters():
    from eva_vos_tpu_torch import kernels as K

    return {"memory_topk": K.topk_select,
            "memory_topk_chunked": K.topk_select_chunked,
            "memory_topk_resident": K.topk_select_resident,
            "memory_topk_grid": K.topk_select_grid,
            "memory_topk_iter": K.topk_select_iter,
            "memory_topk_sort": K.topk_select_sort,
            "memory_readout": K.topk_readout,
            "memory_readout_chunked": K.topk_readout_chunked}


def staged_counts(torch, run):
    """The chunked readout's staged rows and the picks it summed (top_k x N
    x K a call) over one ``run()``, through the fused read's READOUTS (a
    package without that table gives None)."""
    from eva_vos_tpu_torch.kernels import memory_readout as R

    if not hasattr(R, "READOUTS"):
        return None
    staged = torch.zeros(1, dtype=torch.int32, device=torch.device(DEVICE))
    counts = dict(calls=0, picks=0)
    saved = dict(R.READOUTS)

    def counted(readout):
        def call(mv, vals, idx, **kw):
            counts["calls"] += 1
            counts["picks"] += mv.shape[0] * vals.numel()
            return readout(mv, vals, idx, staged_rows=staged, **kw)
        return call

    R.READOUTS["chunked"] = counted(saved["chunked"])
    try:
        run()
        torch.cuda.synchronize()
    finally:
        R.READOUTS.update(saved)
    counts["staged_rows"] = int(staged.item())
    return counts


def engine_phase(torch, results, card):
    import numpy as np

    from eva_vos_tpu_torch.data import synthetic_video
    from eva_vos_tpu_torch.engine import (EngineConfig, InferenceEngine,
                                          pad_mask, prepare_video)
    from eva_vos_tpu_torch.models import FusionNet, PropagationNetwork

    t, h, w = ENGINE["t"], ENGINE["h"], ENGINE["w"]
    dtype = torch.bfloat16
    torch.manual_seed(0)
    stcn = PropagationNetwork(key_arch=ENGINE["key_arch"],
                              value_arch="resnet18").to(dtype)
    fusion = FusionNet().to(dtype)
    cfg = EngineConfig(mem_freq=5, top_k=TOP_K, max_interactions=60,
                       feature_chunk=2)
    base = InferenceEngine(stcn, fusion, cfg, device=DEVICE)
    if base.config.readout_strategy != "fused":
        fail(f"engine resolved {base.config.readout_strategy!r} on CUDA")
    images, masks = synthetic_video(t, h, w, num_objects=1, seed=0)
    t0 = time.perf_counter()
    padded, pad = prepare_video(images, dtype=dtype, device=DEVICE)
    feats = base.precompute_features(padded)
    torch.cuda.synchronize()
    precompute_s = time.perf_counter() - t0
    state0 = base.init_state(feats, 1)
    m0 = pad_mask(masks[:1, 0], pad, device=DEVICE)
    m30 = pad_mask(masks[:1, 30], pad, device=DEVICE)
    plain = InferenceEngine(stcn, fusion,
                            cfg._replace(readout_strategy="gather"),
                            device=DEVICE)
    counters = launch_counters()
    reads = engine_paths()
    engines = {path: InferenceEngine(stcn, fusion, cfg._replace(**fields),
                                     device=DEVICE)
               for path, (fields, _) in reads.items()}
    counts = {path: dict.fromkeys(counters, 0) for path in reads}

    def interact(path, state, mask, idx):
        """One untraced interact of a read, in host seconds; the counters,
        zeroed just before, are added to the read's counts just after."""
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = engines[path].interact(state, feats, mask, idx)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        for k, c in counters.items():
            counts[path][k] += c.launches
        return out, seconds

    per_interact, out0 = {}, {}
    for path, (_, kernels) in reads.items():                # warm-up
        out0[path], _ = interact(path, state0, m0, 0)
        per_interact[path] = {k: counts[path][k] for k in kernels}
    walls = {path: [] for path in reads}
    for _ in range(ENGINE_ITERS):             # round-robin: A, B, C, D, A, ...
        for path in reads:
            out0[path], seconds = interact(path, state0, m0, 0)
            walls[path].append(seconds)
    walls30, states = {path: [] for path in reads}, {}
    for _ in range(FRAME30_ITERS):   # from the frame-0 state (no donation)
        for path in reads:
            states[path], seconds = interact(path, out0[path], m30, 30)
            walls30[path].append(seconds)

    staged = {}   # one more frame-0 interact of the chunked read, counted
    for path, (_, kernels) in reads.items():
        if "memory_readout_chunked" in kernels:
            staged[path] = staged_counts(torch, lambda: engines[path].interact(
                state0, feats, m0, 0))
            if staged[path] is not None:
                c = staged[path]
                if c["staged_rows"] <= 0:
                    fail(f"{path}: its readout staged no row")
                print(f"[engine {path}] readout at frame 0: {c['calls']} "
                      f"calls, {c['staged_rows']} rows staged for "
                      f"{c['picks']} picks "
                      f"({c['picks'] / max(1, c['staged_rows']):.2f} picks a "
                      f"staged row)", flush=True)

    launches, paths = {}, {}
    for path, (_, kernels) in reads.items():
        engine, state = engines[path], states[path]
        fps_all = sorted((t - 1) / sec for sec in walls[path])
        fps = statistics.median(fps_all)
        fused_s = statistics.median(walls30[path])
        print(f"[engine {path}] fps median {fps:.2f} (min {fps_all[0]:.2f}, "
              f"max {fps_all[-1]:.2f}; {t - 1} frames x {ENGINE_ITERS} "
              f"interleaved interacts); interact at frame 30 median "
              f"{fused_s * 1e3:.1f} ms (min {min(walls30[path]) * 1e3:.1f}, "
              f"max {max(walls30[path]) * 1e3:.1f}; {FRAME30_ITERS} "
              f"untraced); precompute {precompute_s:.2f} s; on {card}",
              flush=True)
        print(f"[engine {path}] launches per interact at frame 0: "
              f"{per_interact[path]}; whole path: {counts[path]}", flush=True)
        if min(counts[path][k] for k in kernels) <= 0:
            fail(f"{path}: a kernel of the path was not launched: "
                 f"{counts[path]}")
        for k in kernels:
            launches.setdefault(k, counts[path][k])
        if not torch.isfinite(state.prob).all():
            fail(f"{path}: non-finite probabilities after the fused "
                 f"interaction")
        sums = state.prob.sum(0)
        if (sums - 1).abs().max().item() > 1e-3:
            fail(f"{path}: probabilities do not sum to 1")
        if int(state.certain_count) != 2 or state.interacted.sum() != 2:
            fail(f"{path}: state bookkeeping wrong after two interactions")
        ids = engine.masks_from_prob(state.prob, pad)
        if ids.shape != (t, h, w):
            fail(f"{path}: mask shape {ids.shape}")

        # one blocked segmentation step (frames 31..35 against the bank the
        # frame-30 interaction left) through the kernels and the plain read
        front = state.certain_count + 5  # the backward pass's transients
        tis = list(range(31, 36))
        with torch.no_grad():
            got = engine._segment_frames(feats, state.bank_k, state.bank_v,
                                         front, tis).float()
            want = plain._segment_frames(feats, state.bank_k, state.bank_v,
                                         front, tis).float()
        diff = (got - want).abs()
        frac = (diff > PROB_ATOL).float().mean().item()
        if not torch.isfinite(got).all() or frac > PROB_FRAC:
            fail(f"{path}: segmentation step: {frac:.2e} of pixels off by > "
                 f"{PROB_ATOL}")
        print(f"[engine {path}] blocked step kernels vs plain: max|dp|="
              f"{diff.max().item():.3g}, mean {diff.mean().item():.3g}, share "
              f"> {PROB_ATOL}: {frac:.2e}", flush=True)
        paths[path] = dict(
            fps=fps, fps_min=fps_all[0], fps_max=fps_all[-1],
            interact0_s=walls[path], interact30_s=fused_s,
            interact30_all_s=walls30[path],
            launches_per_interact=per_interact[path], launches=counts[path],
            readout_staged0=staged.get(path),
            step_max_abs_dp=diff.max().item(), step_share_off=frac,
            foreground_share=float(np.mean(ids > 0)))
    results["engine"] = dict(precompute_s=precompute_s, paths=paths)
    return launches


def kernels_line(results, launches):
    """Each kernel's entry of the kernels JSON line: its time, plain time,
    library time and bound at a 72-slot clustered bank (N = 8100; readouts
    K = 1), its largest error over all cases, and its launches on the engine
    read that runs it (on the entry-point phase for the kernels that no
    engine read runs)."""

    def row(name, rows):
        readout = "topk" not in name
        mine = [r for r in rows if readout or r["kernel"] == name]
        head = next(r for r in mine if r["case"] in (
            f"fill{max(FILLS)}_clustered", f"fill{max(FILLS)}_clustered_K1")
            and r.get("n", N_QUERIES) == N_QUERIES)
        key = f"{name}_" if readout else ""
        return {"name": name, "route": "cuda",
                "source": f"eva_vos_tpu_torch/kernels/csrc/{SOURCES[name]}",
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": max(r[f"{key}err" if readout else "max_abs_err"]
                                   for r in mine),
                "ms": head[f"{key}ms"], "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                "library_ms": head["library_ms"]}

    return [row(name, results["selection" if "topk" in name else "readout"])
            for name in REPLACES]


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        from eva_vos_tpu_torch.kernels import build
    except ImportError:
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"[card] {card}", flush=True)
    t0 = time.perf_counter()
    build_s = build.build_all()
    print(f"[build] {build_s} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name in build.KERNELS:
        for line in build.ptxas_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas] {name}: {line.strip()}")
    hmma = {}
    for name in sorted({SOURCES[k].removesuffix(".cu") for k in SPLIT_KERNELS}):
        hmma[name] = hmma_count(build, name)
        print(f"[sass] {name}: " + (
            "cuobjdump not found" if hmma[name] is None else
            f"{hmma[name]} HMMA instructions (tensor-core scoring of bf16 "
            f"keys {'present' if hmma[name] else 'absent'})"), flush=True)
        if hmma[name] == 0:
            fail(f"{name}: no tensor-core instruction in its SASS")

    results = {"card": card, "build_s": build_s, "hmma": hmma}
    kernel_phases(torch, results)
    entry_launches = entry_phase(torch, results)
    launches = engine_phase(torch, results, card)
    launches.update(entry_launches)

    kernels = kernels_line(results, launches)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(
        json.dumps(dict(results, kernels=kernels), indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
