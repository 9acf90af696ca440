"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the repository root, one card

Phases, each of which raises on failure (so no failure ends with exit 0):

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``eva_vos_tpu_torch/kernels/csrc`` (one
   ``nvcc`` per source, all at once);
3. the top-k selection kernel against its plain version at the engine's
   blocked-step shape (N = 5 x 1620 queries, CK = 64, top_k = 50, bf16) on
   banks of 1, 12 and 72 slots of 1620 tokens, random and clustered;
4. the readout kernel against its plain version (K = 1 and 2, CV = 512) on
   the selections of phase 3;
5. the engine at full width (T = 60, 480x854, resnet50/resnet18, top_k=50,
   mem_freq=5, bf16, random seeded weights): a warm-up ``interact`` at frame
   0, three timed ones, then one at frame 30 from the resulting state (its
   backward pass fuses through FusionNet); the kernels' launch counters must
   rise, the outputs be finite, and one blocked segmentation step through
   the kernels must match the plain read;
6. one JSON line with each kernel's launches, error, times and bound.

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


def kernel_phases(torch, results):
    from eva_vos_tpu_torch.kernels import (topk_readout, topk_readout_plain,
                                           topk_select, topk_select_plain)
    from eva_vos_tpu_torch.ops.memory_attention import _scores, softmax_weights

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(0)
    qk = torch.randn((N_QUERIES, CK), generator=gen, device=dev).to(
        torch.bfloat16)
    mv2 = torch.randn((2, max(FILLS) * HW_TOKENS, CV), generator=gen,
                      device=dev).to(torch.bfloat16)
    sel_rows, ro_rows = [], []
    for clustered in (False, True):
        for fill in FILLS:
            mk, valid = make_bank(torch, gen, qk, fill, clustered)
            name = f"fill{fill}_{'clustered' if clustered else 'random'}"
            vals, idx = topk_select(qk, mk, valid, TOP_K)
            ref_vals, ref_idx = topk_select_plain(qk, mk, valid, TOP_K + 1)
            err, n_diff = check_selection(torch, vals, idx, ref_vals, ref_idx,
                                          name)
            ms = cuda_ms(torch, lambda: topk_select(qk, mk, valid, TOP_K), 10)
            plain_ms = cuda_ms(
                torch, lambda: topk_select_plain(qk, mk, valid, TOP_K), 3)
            scores = _scores(mk[:valid], qk)
            lib_ms = cuda_ms(torch, lambda: torch.topk(scores, TOP_K, dim=1), 5)
            del scores
            n_bytes = 2 * CK * (N_QUERIES + valid) + 8 * TOP_K * N_QUERIES
            bound, by = bound_ms(n_bytes, 2.0 * N_QUERIES * valid * CK)
            sel_rows.append(dict(case=name, max_abs_err=err, ids_differ=n_diff,
                                 ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                 bound_ms=bound, bound_by=by))
            print(f"[select] {name}: max|dv|={err:.3g} ids_differ={n_diff} "
                  f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, torch.topk "
                  f"{lib_ms:.3f} ms, bound {bound:.4f} ms ({by})", flush=True)

            for k_obj in (1, 2):
                mv = mv2[:k_obj].contiguous()
                out = topk_readout(mv, vals, idx)
                ref = topk_readout_plain(mv, vals, idx)
                torch.testing.assert_close(out.float(), ref.float(),
                                           rtol=READOUT_RTOL,
                                           atol=READOUT_ATOL)
                rerr = (out.float() - ref.float()).abs().max().item()
                ms = cuda_ms(torch, lambda: topk_readout(mv, vals, idx), 10)
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
                rows = torch.unique(idx).numel()
                n_bytes = (k_obj * rows * CV * 2 + 8 * TOP_K * N_QUERIES
                           + k_obj * N_QUERIES * CV * 2)
                bound, by = bound_ms(n_bytes,
                                     2.0 * k_obj * N_QUERIES * TOP_K * CV)
                ro_rows.append(dict(case=f"{name}_K{k_obj}", max_abs_err=rerr,
                                    ms=ms, plain_ms=plain_ms,
                                    library_ms=lib_ms, bound_ms=bound,
                                    bound_by=by, unique_rows=rows))
                print(f"[readout] {name} K={k_obj}: max|d|={rerr:.3g} kernel "
                      f"{ms:.3f} ms, plain {plain_ms:.3f} ms, library "
                      f"{lib_ms if lib_ms is None else round(lib_ms, 3)} ms, "
                      f"bound {bound:.4f} ms ({by})", flush=True)
            del mk
    results["selection"], results["readout"] = sel_rows, ro_rows


def engine_phase(torch, results, card):
    import numpy as np

    from eva_vos_tpu_torch.data import synthetic_video
    from eva_vos_tpu_torch.engine import (EngineConfig, InferenceEngine,
                                          pad_mask, prepare_video)
    from eva_vos_tpu_torch.kernels import topk_readout, topk_select
    from eva_vos_tpu_torch.models import FusionNet, PropagationNetwork

    t, h, w = ENGINE["t"], ENGINE["h"], ENGINE["w"]
    dtype = torch.bfloat16
    torch.manual_seed(0)
    stcn = PropagationNetwork(key_arch=ENGINE["key_arch"],
                              value_arch="resnet18")
    fusion = FusionNet()
    cfg = EngineConfig(mem_freq=5, top_k=TOP_K, max_interactions=60,
                       feature_chunk=2)
    engine = InferenceEngine(stcn.to(dtype), fusion.to(dtype), cfg,
                             device=DEVICE)
    if engine.config.readout_strategy != "fused":
        fail(f"engine resolved {engine.config.readout_strategy!r} on CUDA")
    images, masks = synthetic_video(t, h, w, num_objects=1, seed=0)
    t0 = time.perf_counter()
    padded, pad = prepare_video(images, dtype=dtype, device=DEVICE)
    feats = engine.precompute_features(padded)
    torch.cuda.synchronize()
    precompute_s = time.perf_counter() - t0
    state0 = engine.init_state(feats, 1)
    m0 = pad_mask(masks[:1, 0], pad, device=DEVICE)

    topk_select.launches = topk_readout.launches = 0
    out = engine.interact(state0, feats, m0, 0)           # warm-up
    torch.cuda.synchronize()
    per_interact = (topk_select.launches, topk_readout.launches)
    iters = 3
    start = time.perf_counter()
    for _ in range(iters):
        out = engine.interact(state0, feats, m0, 0)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    fps = (t - 1) * iters / elapsed
    state = engine.interact(out, feats,
                            pad_mask(masks[:1, 30], pad, device=DEVICE), 30)
    torch.cuda.synchronize()
    launches = {"memory_topk": topk_select.launches,
                "memory_readout": topk_readout.launches}
    print(f"[engine] fps={fps:.2f} (59 frames x {iters} interacts in "
          f"{elapsed:.3f} s; precompute {precompute_s:.2f} s) on {card}",
          flush=True)
    print(f"[engine] launches per interact at frame 0: {per_interact}; "
          f"whole main path: {launches}", flush=True)
    if min(launches.values()) <= 0:
        fail(f"a kernel was not launched on the main path: {launches}")
    if not torch.isfinite(state.prob).all():
        fail("non-finite probabilities after the fused interaction")
    sums = state.prob.sum(0)
    if (sums - 1).abs().max().item() > 1e-3:
        fail("probabilities do not sum to 1")
    if int(state.certain_count) != 2 or state.interacted.sum() != 2:
        fail("state bookkeeping wrong after two interactions")
    ids = engine.masks_from_prob(state.prob, pad)
    if ids.shape != (t, h, w):
        fail(f"mask shape {ids.shape}")

    # one blocked segmentation step (frames 31..35 against the bank the
    # frame-30 interaction left) through the kernels and the plain read
    plain = InferenceEngine(engine.stcn, engine.fusion,
                            cfg._replace(readout_strategy="gather"),
                            device=DEVICE)
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
        fail(f"segmentation step: {frac:.2e} of pixels off by > {PROB_ATOL}")
    print(f"[engine] blocked step kernels vs plain: max|dp|="
          f"{diff.max().item():.3g}, mean {diff.mean().item():.3g}, share > "
          f"{PROB_ATOL}: {frac:.2e}", flush=True)
    results["engine"] = dict(
        fps=fps, elapsed_s=elapsed, iters=iters, precompute_s=precompute_s,
        launches_per_interact=dict(zip(("memory_topk", "memory_readout"),
                                       per_interact)),
        launches=launches, step_max_abs_dp=diff.max().item(),
        step_share_off=frac, foreground_share=float(np.mean(ids > 0)))
    return launches


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

    def row(name, rows, replaces):
        head = rows[-1] if name == "memory_topk" else next(
            r for r in rows if r["case"] == f"fill{max(FILLS)}_clustered_K1")
        return {"name": name, "route": "cuda",
                "source": f"eva_vos_tpu_torch/kernels/csrc/{name}.cu",
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": head["ms"], "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                "library_ms": head["library_ms"]}

    kernels = [row("memory_topk", results["selection"],
                   "eva_vos_tpu/kernels/memory_topk.py:380"),
               row("memory_readout", results["readout"],
                   "eva_vos_tpu/kernels/memory_readout.py:64")]
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
