"""Time every selection kernel of a checkout of this repository at one key
width under this checkout's ``chip_smoke.py`` protocol, on one NVIDIA GPU.

    python3 scripts/torch_port_width_compare.py --root DIR --tag _parent

On clustered banks of ``chip_smoke.py``'s phase 6d (fills 12 and 72 of the
72-slot bank, N = 8,100 queries, keys ``--ck`` wide, 64 by default), each of
#1, #4, #5, #6, #7 and #8 in bf16 at top_k 50, and #1 at top_k 512 (the
radix select) and in fp32 at top_k 50 and 512: checked against the plain
selection (``check_selection``), then timed by CUDA events around
back-to-back calls (``stream_ms``) and by kernel in a ``torch.profiler``
trace (``named_ms`` with ``width_launches``).  The package of DIR
(default: this checkout) is timed, so that an older tree, which may take
only CK = 64, is measured by the same protocol; run it for two trees in turns (A, B, B, A) within one call to
compare them.  Prints ``[width-compare]`` lines; the results also go to
``chiprun_out/width_compare<--tag>.json``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FILLS = (12, 72)
TOP_K = 50
LARGE_K = 512


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(ROOT),
                    help="checkout whose eva_vos_tpu_torch is timed")
    ap.add_argument("--tag", default="", help="suffix of the JSON file's name")
    ap.add_argument("--ck", type=int, default=64, help="the keys' width")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_port_width_compare: no CUDA device", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke_protocol",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import eva_vos_tpu_torch
    from eva_vos_tpu_torch.kernels import build, topk_select_plain

    if Path(eva_vos_tpu_torch.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"imported {eva_vos_tpu_torch.__file__}, not the "
                           f"package of {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smoke.card_line()
    print(f"[card] {card}; package {root}", flush=True)
    build.build_all()
    dev = torch.device(smoke.DEVICE)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(3)
    qk = torch.randn((smoke.N_QUERIES, args.ck), generator=gen,
                     device=dev).to(torch.bfloat16)
    selections = smoke.width_selectors()
    rows = []
    for fill in FILLS:
        mk, valid = smoke.make_bank(torch, gen, qk, fill, clustered=True)
        ref = topk_select_plain(qk, mk, valid, LARGE_K + 1)
        cases = [(name, qk, mk, TOP_K, "bf16") for name in selections]
        cases += [("memory_topk", qk, mk, LARGE_K, "bf16")]
        cases += [("memory_topk", qk.float(), mk.float(), k, "fp32")
                  for k in (TOP_K, LARGE_K)]
        for name, q, m, k, dtype in cases:
            fn = selections[name][0]
            label = (f"{name} CK={args.ck} fill{fill} top_k={k} {dtype}")
            vals, idx = fn(q, m, valid, k)
            err, n_diff = smoke.check_selection(torch, vals, idx, ref[0],
                                                ref[1], label, k)
            ms = smoke.stream_ms(torch, lambda: fn(q, m, valid, k))
            split = smoke.named_ms(torch, lambda: fn(q, m, valid, k),
                                   smoke.width_launches(
                                       name, q.shape[0], valid, k, False,
                                       sms))
            traced = split.pop("all")
            rows.append(dict(case=label, max_abs_err=err, ids_differ=n_diff,
                             ms=ms, traced_ms=traced, split_ms=split))
            print(f"[width-compare] {label}: device {ms:.4f} ms, kernels in "
                  f"a trace {traced:.4f} ms ("
                  f"{', '.join(f'{x} {t:.4f}' for x, t in split.items())})",
                  flush=True)
        del mk
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"width_compare{args.tag}.json").write_text(
        json.dumps(dict(card=card, root=str(root), rows=rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
