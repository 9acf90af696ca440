"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the repository root, one card

Phases, each of which raises on failure (so no failure ends with exit 0):

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``eva_vos_tpu_torch/kernels/csrc`` (one
   ``nvcc`` per source, all at once);
3. the four top-k selection kernels (oldest first, newest first with the
   tau skip, two-pass resident, split bank) against their plain versions at
   the engine's blocked-step shape (N = 5 x 1620 queries, CK = 64,
   top_k = 50, bf16) on banks of 1, 12 and 72 slots of 1620 tokens, random
   and clustered; the oldest-first and split-bank kernels also at a
   single-frame step (N = 1620);
4. the two readout kernels against their plain version (K = 1 and 2,
   CV = 512) on the oldest-first selections of phase 3;
5. the engine at full width (T = 60, 480x854, resnet50/resnet18, top_k=50,
   mem_freq=5, bf16, random seeded weights), features computed once, under
   each memory read: the default 'fused' (oldest-first selection, grid
   readout), 'select' (split-bank selection + gather), and 'fused' with
   the resident selection, and with the newest-first selection and the
   chunked readout.  Each: a warm-up ``interact`` at frame 0, three timed
   ones, then one at frame 30 from the resulting state (its backward pass
   fuses through FusionNet); the launch counters, zeroed just before, must
   show the read's kernels launched, the outputs be finite, and one blocked
   segmentation step through the kernels must match the plain read;
6. one JSON line with each kernel's launches (from the engine read that
   runs it), error, times and bound.

The last line of standard output is ``{"ok": true, "device": {...}}``.  The
full results also go to ``chiprun_out/chip_smoke.json``.  Without a CUDA
device, or without the repository beside it, the script exits non-zero.
"""

from __future__ import annotations

import json
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


# each kernel's source and the TPU kernel it replaces
SOURCES = {"memory_topk": "memory_topk.cu",
           "memory_topk_chunked": "memory_topk.cu",
           "memory_topk_resident": "memory_topk_resident.cu",
           "memory_topk_grid": "memory_topk_grid.cu",
           "memory_readout": "memory_readout.cu",
           "memory_readout_chunked": "memory_readout_chunked.cu"}
REPLACES = {"memory_topk": "eva_vos_tpu/kernels/memory_topk.py:380",
            "memory_topk_chunked": "eva_vos_tpu/kernels/memory_topk.py:590",
            "memory_topk_resident": "eva_vos_tpu/kernels/memory_topk.py:801",
            "memory_topk_grid": "eva_vos_tpu/kernels/memory_topk.py:302",
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


def check_selection(torch, vals, idx, ref_vals, ref_idx, name):
    err = (vals - ref_vals[:TOP_K]).abs().max().item()
    if err > SCORE_ATOL:
        fail(f"{name}: selection scores differ by {err}")
    gaps = (ref_vals[:-1] - ref_vals[1:]).abs() <= SCORE_ATOL  # [k, N]
    tied = gaps[:TOP_K].clone()
    tied[1:] |= gaps[:TOP_K - 1]
    bad = (idx != ref_idx[:TOP_K]) & ~tied
    if bad.any():
        fail(f"{name}: {int(bad.sum())} selected ids differ away from ties")
    return err, int((idx != ref_idx[:TOP_K]).sum())


def selection_bound(n: int, valid: int):
    """Bound of an exact top-k selection: read qk and the valid keys once,
    write k (score, id) pairs per query; 2 * CK flops per (query, token)."""
    n_bytes = 2 * CK * (n + valid) + 8 * TOP_K * n
    return bound_ms(n_bytes, 2.0 * n * valid * CK)


def readout_bound(idx, k_obj: int):
    """Bound of the readout: each distinct selected row once per object,
    the selection once, the output once; 2 flops per gathered element."""
    rows = idx.unique().numel()
    n = idx.shape[1]
    n_bytes = k_obj * rows * CV * 2 + 8 * TOP_K * n + k_obj * n * CV * 2
    return bound_ms(n_bytes, 2.0 * k_obj * n * TOP_K * CV), rows


def kernel_phases(torch, results):
    from eva_vos_tpu_torch.kernels import (topk_readout, topk_readout_chunked,
                                           topk_readout_plain, topk_select,
                                           topk_select_chunked,
                                           topk_select_grid, topk_select_plain,
                                           topk_select_resident)
    from eva_vos_tpu_torch.ops.memory_attention import (_scores,
                                                        memory_affinity_topk,
                                                        softmax_weights)

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(0)
    qk = torch.randn((N_QUERIES, CK), generator=gen, device=dev).to(
        torch.bfloat16)
    mv2 = torch.randn((2, max(FILLS) * HW_TOKENS, CV), generator=gen,
                      device=dev).to(torch.bfloat16)
    esc = torch.zeros(1, dtype=torch.int32, device=dev)
    sel_rows, ro_rows = [], []

    def grid_transposed(q, mk, valid, top_k):
        vals, idx = topk_select_grid(q, mk, valid, top_k, return_raw=True)
        return vals.T, idx.T

    # (name in the kernels line, transposed selection, the call timed)
    selectors = (
        ("memory_topk", topk_select,
         lambda q, mk, valid: topk_select(q, mk, valid, TOP_K)),
        ("memory_topk_chunked", topk_select_chunked,
         lambda q, mk, valid: topk_select_chunked(q, mk, valid, TOP_K)),
        ("memory_topk_resident", topk_select_resident,
         lambda q, mk, valid: topk_select_resident(q, mk, valid, TOP_K)),
        ("memory_topk_grid", grid_transposed,
         lambda q, mk, valid: topk_select_grid(q, mk, valid, TOP_K)),
    )
    for clustered in (False, True):
        for fill in FILLS:
            mk, valid = make_bank(torch, gen, qk, fill, clustered)
            case = f"fill{fill}_{'clustered' if clustered else 'random'}"
            scores = _scores(mk[:valid], qk)
            lib_ms = cuda_ms(torch, lambda: torch.topk(scores, TOP_K, dim=1), 5)
            del scores
            for n in (N_QUERIES, HW_TOKENS):
                q = qk[:n]
                ref_vals, ref_idx = topk_select_plain(q, mk, valid, TOP_K + 1)
                plain_ms = cuda_ms(
                    torch, lambda: topk_select_plain(q, mk, valid, TOP_K), 3)
                affinity_ms = cuda_ms(
                    torch, lambda: memory_affinity_topk(mk, q, TOP_K, valid), 3)
                bound, by = selection_bound(n, valid)
                for name, select, timed in selectors:
                    if n != N_QUERIES and name not in ("memory_topk",
                                                       "memory_topk_grid"):
                        continue
                    esc.zero_()
                    if name == "memory_topk_resident":
                        vals, idx = topk_select_resident(q, mk, valid, TOP_K,
                                                         escalations=esc)
                    else:
                        vals, idx = select(q, mk, valid, TOP_K)
                    label = f"{name} {case} N={n}"
                    err, n_diff = check_selection(torch, vals, idx, ref_vals,
                                                  ref_idx, label)
                    if name == "memory_topk_grid":
                        w, wi = topk_select_grid(q, mk, valid, TOP_K)
                        if not torch.equal(wi.T, idx) or not torch.allclose(
                                w, softmax_weights(vals.T), rtol=1e-6,
                                atol=1e-7):
                            fail(f"{label}: weights disagree with raw scores")
                    ms = cuda_ms(torch, lambda: timed(q, mk, valid), 10)
                    row = dict(kernel=name, case=case, n=n, max_abs_err=err,
                               ids_differ=n_diff, ms=ms,
                               plain_ms=(affinity_ms if name == "memory_topk_grid"
                                         else plain_ms),
                               library_ms=lib_ms, bound_ms=bound, bound_by=by,
                               escalated_blocks=int(esc.item()))
                    sel_rows.append(row)
                    print(f"[select] {label}: max|dv|={err:.3g} ids_differ="
                          f"{n_diff} kernel {ms:.3f} ms, plain "
                          f"{row['plain_ms']:.3f} ms, torch.topk {lib_ms:.3f} "
                          f"ms, bound {bound:.4f} ms ({by})"
                          + (f", escalated blocks {row['escalated_blocks']}"
                             if name == "memory_topk_resident" else ""),
                          flush=True)
                    if name == "memory_topk" and n == N_QUERIES:
                        sel = (vals, idx)

            vals, idx = sel
            for k_obj in (1, 2):
                mv = mv2[:k_obj].contiguous()
                ref = topk_readout_plain(mv, vals, idx)
                plain_ms = cuda_ms(
                    torch, lambda: topk_readout_plain(mv, vals, idx), 3)
                lib_ms = None
                if k_obj == 1:
                    # one library call for the same weighted gather
                    w = softmax_weights(vals.T).to(mv.dtype).contiguous()
                    ids = idx.T.long().contiguous()
                    lib_ms = cuda_ms(torch, lambda: torch.nn.functional
                                     .embedding_bag(ids, mv[0], mode="sum",
                                                    per_sample_weights=w), 10)
                (bound, by), rows = readout_bound(idx, k_obj)
                for name, readout in (("memory_readout", topk_readout),
                                      ("memory_readout_chunked",
                                       topk_readout_chunked)):
                    out = readout(mv, vals, idx)
                    torch.testing.assert_close(out.float(), ref.float(),
                                               rtol=READOUT_RTOL,
                                               atol=READOUT_ATOL)
                    rerr = (out.float() - ref.float()).abs().max().item()
                    ms = cuda_ms(torch, lambda: readout(mv, vals, idx), 10)
                    ro_rows.append(dict(kernel=name, case=f"{case}_K{k_obj}",
                                        max_abs_err=rerr, ms=ms,
                                        plain_ms=plain_ms, library_ms=lib_ms,
                                        bound_ms=bound, bound_by=by,
                                        unique_rows=rows))
                    print(f"[readout] {name} {case} K={k_obj}: max|d|="
                          f"{rerr:.3g} kernel {ms:.3f} ms, plain "
                          f"{plain_ms:.3f} ms, library "
                          f"{lib_ms if lib_ms is None else round(lib_ms, 3)} "
                          f"ms, bound {bound:.4f} ms ({by})", flush=True)
            del mk
    results["selection"], results["readout"] = sel_rows, ro_rows


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
            "memory_readout": K.topk_readout,
            "memory_readout_chunked": K.topk_readout_chunked}


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
    launches, paths = {}, {}
    for path, (fields, kernels) in engine_paths().items():
        engine = InferenceEngine(stcn, fusion, cfg._replace(**fields),
                                 device=DEVICE)
        for c in counters.values():
            c.launches = 0
        out = engine.interact(state0, feats, m0, 0)           # warm-up
        torch.cuda.synchronize()
        per_interact = {k: counters[k].launches for k in kernels}
        iters = 3
        start = time.perf_counter()
        for _ in range(iters):
            out = engine.interact(state0, feats, m0, 0)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - start
        fps = (t - 1) * iters / elapsed
        t1 = time.perf_counter()
        state = engine.interact(out, feats, m30, 30)
        torch.cuda.synchronize()
        fused_s = time.perf_counter() - t1
        counts = {k: c.launches for k, c in counters.items()}
        print(f"[engine {path}] fps={fps:.2f} ({t - 1} frames x {iters} interacts "
              f"in {elapsed:.3f} s; interact at frame 30 {fused_s:.3f} s; "
              f"precompute {precompute_s:.2f} s) on {card}", flush=True)
        print(f"[engine {path}] launches per interact at frame 0: "
              f"{per_interact}; whole path: {counts}", flush=True)
        if min(counts[k] for k in kernels) <= 0:
            fail(f"{path}: a kernel of the path was not launched: {counts}")
        for k in kernels:
            launches.setdefault(k, counts[k])
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
            fps=fps, elapsed_s=elapsed, iters=iters, interact30_s=fused_s,
            launches_per_interact=per_interact, launches=counts,
            step_max_abs_dp=diff.max().item(), step_share_off=frac,
            foreground_share=float(np.mean(ids > 0)))
    results["engine"] = dict(precompute_s=precompute_s, paths=paths)
    return launches


def kernels_line(results, launches):
    """Each kernel's entry of the kernels JSON line: its time, plain time,
    library time and bound at a 72-slot clustered bank (N = 8100; readouts
    K = 1), its largest error over all cases, and its launches on the engine
    read that runs it."""

    def row(name, rows):
        mine = [r for r in rows if r["kernel"] == name]
        head = next(r for r in mine if r["case"] in (
            f"fill{max(FILLS)}_clustered", f"fill{max(FILLS)}_clustered_K1")
            and r.get("n", N_QUERIES) == N_QUERIES)
        return {"name": name, "route": "cuda",
                "source": f"eva_vos_tpu_torch/kernels/csrc/{SOURCES[name]}",
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": max(r["max_abs_err"] for r in mine),
                "ms": head["ms"], "plain_ms": head["plain_ms"],
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

    results = {"card": card, "build_s": build_s}
    kernel_phases(torch, results)
    launches = engine_phase(torch, results, card)

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
