"""Time the readout kernels of a checkout of this repository under this
checkout's ``chip_smoke.py`` protocol, on one NVIDIA GPU.

    python3 scripts/torch_port_readout_compare.py --root DIR --tag _parent
    python3 scripts/torch_port_readout_compare.py --engine [--top-k 512]

Runs ``chip_smoke.readout_cases`` (both readout kernels, the plain version,
``F.embedding_bag`` and the bound on the default selection of every case
of the selection phase: fills 1, 12 and 72, N = 8100 and 1620, random and
clustered banks, K = 1, and K = 2 at fill 72 with N = 8100; the distinct
rows and picks per 64-query tile) on the ``eva_vos_tpu_torch`` package of
DIR (default: this checkout), so that an older tree is measured by the same
protocol.  Run it for two trees in turns (A, B, B, A) within one call to
compare them.  With ``--engine`` it also runs one frame-0 interact of the
engine (as ``chip_smoke.py`` builds it) under the default and the chunked
reads, and counts over the selections that reach the readout the picks and
the distinct ids per tile of 64 and of 32 queries: the rows a readout that
stages each distinct row once per tile copies.  ``--top-k`` sets the
engine's top_k for that count (default ``chip_smoke.TOP_K``); above 256
only the default read runs (the chunked read takes at most 256), and the
large-k readout's branch of each 64-query tile is counted too.  Results
also go to ``chiprun_out/readout_compare<--tag>.json``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def engine_rows(torch, smoke, top_k: int) -> dict:
    """Picks and distinct ids per 64- and 32-query tile over the readouts of
    one frame-0 interact at ``top_k``, for the default and (up to 256) the
    chunked reads; above 256 also the large-k readout's tiles by branch."""
    from eva_vos_tpu_torch.data import synthetic_video
    from eva_vos_tpu_torch.engine import (EngineConfig, InferenceEngine,
                                          pad_mask, prepare_video)
    from eva_vos_tpu_torch.kernels import KernelConfig
    from eva_vos_tpu_torch.kernels import memory_readout as R
    from eva_vos_tpu_torch.kernels import memory_topk as M
    from eva_vos_tpu_torch.models import FusionNet, PropagationNetwork

    t, h, w = smoke.ENGINE["t"], smoke.ENGINE["h"], smoke.ENGINE["w"]
    dtype = torch.bfloat16
    torch.manual_seed(0)
    stcn = PropagationNetwork(key_arch=smoke.ENGINE["key_arch"],
                              value_arch="resnet18").to(dtype)
    fusion = FusionNet().to(dtype)
    images, masks = synthetic_video(t, h, w, num_objects=1, seed=0)
    padded, pad = prepare_video(images, dtype=dtype, device=smoke.DEVICE)
    m0 = pad_mask(masks[:1, 0], pad, device=smoke.DEVICE)
    out = {}
    reads = (("fused", "tournament"), ("fused_chunked_chunked", "chunked"))
    for read, sel in reads[:1] if top_k > M.PRUNED_MAX_K else reads:
        cfg = EngineConfig(mem_freq=5, top_k=top_k, max_interactions=60,
                           feature_chunk=2, readout_strategy="fused",
                           kernels=KernelConfig(
                               sel_method=sel,
                               readout_method="grid" if sel == "tournament"
                               else "chunked"))
        engine = InferenceEngine(stcn, fusion, cfg, device=smoke.DEVICE)
        feats = engine.precompute_features(padded)
        state0 = engine.init_state(feats, 1)
        counts = dict(calls=0, picks=0, rows64=0, rows32=0, dense=0,
                      sparse=0, direct=0)
        select = M.SELECTORS[sel]

        def counted(qk, mk, valid, k, **kw):
            vals, idx = select(qk, mk, valid, k, **kw)
            counts["calls"] += 1
            for q in (64, 32):
                rows, picks = smoke.tile_rows(torch, vals, idx, q)
                counts[f"rows{q}"] += rows
            counts["picks"] += picks
            if k > M.PRUNED_MAX_K:
                for mode, _, _ in R.large_k_tiles(vals, idx, 64,
                                                  2 * smoke.CV, True):
                    counts[mode] += 1
            return vals, idx

        M.SELECTORS[sel] = counted
        try:
            engine.interact(state0, feats, m0, 0)
            torch.cuda.synchronize()
        finally:
            M.SELECTORS[sel] = select
        out[read] = counts
        print(f"[engine {read}] readouts at frame 0, top_k {top_k}: "
              f"{counts['calls']} calls, {counts['picks']} picks, distinct "
              f"ids per tile: {counts['rows64']} (64 queries; "
              f"{counts['picks'] / counts['rows64']:.2f} picks each), "
              f"{counts['rows32']} (32 queries; "
              f"{counts['picks'] / counts['rows32']:.2f} picks each)"
              + (f"; large-k tiles dense {counts['dense']}, sparse "
                 f"{counts['sparse']}, direct {counts['direct']}"
                 if top_k > M.PRUNED_MAX_K else ""), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(ROOT),
                    help="checkout whose eva_vos_tpu_torch is timed")
    ap.add_argument("--tag", default="", help="suffix of the JSON file's name")
    ap.add_argument("--engine", action="store_true",
                    help="also count the engine's readout rows at frame 0")
    ap.add_argument("--top-k", type=int, default=None,
                    help="the engine's top_k for --engine (default: "
                         "chip_smoke.TOP_K)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_port_readout_compare: no CUDA device", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke_protocol",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import eva_vos_tpu_torch
    from eva_vos_tpu_torch.kernels import build
    from eva_vos_tpu_torch.kernels import memory_readout as R

    if Path(eva_vos_tpu_torch.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"imported {eva_vos_tpu_torch.__file__}, not the "
                           f"package of {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smoke.card_line()
    print(f"[card] {card}; package {root}", flush=True)
    build.build_all()
    mv2, sels = smoke.readout_inputs(torch)
    # a package whose readouts run the shared stage is held to its checks
    stage = hasattr(R, "readout_stage_plain")
    results = {"card": card, "root": str(root), "stage": stage,
               "readout": smoke.readout_cases(torch, mv2, sels, stage)}
    if args.engine:
        results["engine"] = engine_rows(torch, smoke,
                                        args.top_k or smoke.TOP_K)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"readout_compare{args.tag}.json").write_text(
        json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
