"""Time the engine's memory reads of a checkout of this repository under
this checkout's ``chip_smoke.py`` protocol, on one NVIDIA GPU.

    python3 scripts/torch_port_engine_compare.py --root DIR --tag _parent

Runs ``chip_smoke.engine_phase`` (ENGINE_ITERS frame-0 interacts per read,
the four reads interleaved round-robin, then FRAME30_ITERS untraced
frame-30 interacts per read, with its launch and correctness checks) on the
``eva_vos_tpu_torch`` package of DIR (default: this checkout), so that an
older tree is measured by the same protocol.  Run it for two trees in
turns (A, B, B, A) within one call to compare them.  Prints each read's
fps median and range and its frame-30 latency; the results also go to
``chiprun_out/engine_compare<--tag>.json``.  With ``--large-k`` it then
runs ``chip_smoke.large_k_engine`` on the same engine (the fused read at
top_k LARGE_K_ENGINE against the gather read and the fused read at top_k
50, LARGE_K_ITERS frame-0 interacts each, interleaved) and prints their
medians.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(ROOT),
                    help="checkout whose eva_vos_tpu_torch is timed")
    ap.add_argument("--tag", default="", help="suffix of the JSON file's name")
    ap.add_argument("--large-k", action="store_true",
                    help="also time the engine at top_k LARGE_K_ENGINE")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_port_engine_compare: no CUDA device", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke_protocol",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import eva_vos_tpu_torch
    from eva_vos_tpu_torch.kernels import build

    if Path(eva_vos_tpu_torch.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"imported {eva_vos_tpu_torch.__file__}, not the "
                           f"package of {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smoke.card_line()
    print(f"[card] {card}; package {root}", flush=True)
    build.build_all()
    results = {"card": card, "root": str(root)}
    _, (engine, _, masks), (feats, pad) = smoke.engine_phase(torch, results,
                                                             card)
    if args.large_k:
        results["large_k_engine"] = smoke.large_k_engine(
            torch, card, engine, feats, pad, masks)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"engine_compare{args.tag}.json").write_text(
        json.dumps(results, indent=1))
    for path, r in results["engine"]["paths"].items():
        print(f"[compare{args.tag}] {path}: fps median {r['fps']:.2f} (min "
              f"{r['fps_min']:.2f}, max {r['fps_max']:.2f}); frame-30 "
              f"interact {r['interact30_s'] * 1e3:.1f} ms", flush=True)
    if args.large_k:
        for read, ms in results["large_k_engine"]["ms"].items():
            print(f"[compare{args.tag}] top_k {smoke.LARGE_K_ENGINE} engine, "
                  f"{read}: frame-0 interact median "
                  f"{ms[len(ms) // 2]:.1f} ms (min {ms[0]:.1f}, max "
                  f"{ms[-1]:.1f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
