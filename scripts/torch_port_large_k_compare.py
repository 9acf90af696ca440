"""Time #1-#8 above top_k 256 of a checkout of this repository under
that checkout's own ``chip_smoke.py`` phase 6c and 6e cases, on one NVIDIA
GPU.

    python3 scripts/torch_port_large_k_compare.py --root DIR --tag _parent

Runs DIR's ``chip_smoke.large_k_kernels`` (#1 and #2 at top_k 512 and
2,048 on the clustered banks of fills 1, 12 and 72 at N = 8,100 in bf16,
top_k 512 in fp32 at fill 12, each checked against its plain version and
timed by kernel beside its library call and bound; #1's merge passes) and,
where DIR's script has phase 6e (``large_k_method_kernels``), #3-#8 on the
same cases (each selection by CUDA events around back-to-back calls and by
kernel, the chunked readout by kernel, and each selection with keys 24
wide) on DIR's ``eva_vos_tpu_torch`` package, so that an older tree, whose
wrappers may take other arguments, is measured by its own cases.  Run it
for two trees in turns (A, B, B, A) within one call to compare them.
Prints the cases' ``[large-k]`` and ``[large-k methods]`` lines; the
results also go to ``chiprun_out/large_k_compare<--tag>.json``.
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
                    help="checkout whose package and cases are timed")
    ap.add_argument("--tag", default="", help="suffix of the JSON file's name")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_port_large_k_compare: no CUDA device", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke_of_root",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import eva_vos_tpu_torch

    if Path(eva_vos_tpu_torch.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"imported {eva_vos_tpu_torch.__file__}, not the "
                           f"package of {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smoke.card_line()
    print(f"[card] {card}; package {root}", flush=True)
    if hasattr(smoke, "large_k_method_kernels"):  # phase 6e: on 6c's cases
        shared = {}
        rows = smoke.large_k_kernels(torch, shared)
        rows["methods"] = smoke.large_k_method_kernels(torch, shared)
        del shared
    else:
        rows = smoke.large_k_kernels(torch)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"large_k_compare{args.tag}.json").write_text(
        json.dumps(dict(card=card, root=str(root), **rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
