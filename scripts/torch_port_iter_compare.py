"""Time the iterative selection (select_topk's default) and the resident
selection of a checkout of this repository under this checkout's
``chip_smoke.py`` protocol, on one NVIDIA GPU.

    python3 scripts/torch_port_iter_compare.py --root DIR --tag _parent

On the inputs of ``chip_smoke.py``'s selection phase (the same seed and
order: banks of 1, 12 and 72 slots of 1,620 tokens, random and clustered,
N = 8100 and 1620, CK = 64, bf16, top_k = 50), and at top_k = 256 on the
72-slot clustered bank with N = 8100, for ``select_topk`` with no method
and for ``topk_select_resident``: each is checked against the plain version
(scores within ``SCORE_ATOL``, ids equal away from near-ties), then timed
as CUDA events around a call (median of 10) and as device time per kernel
name (``torch.profiler``, mean over 10 calls), beside the library call
(``torch.addmm`` + ``torch.topk``, TF32 off and on, the faster kept) and
the bound.  The package of DIR (default: this checkout) is timed, so that
an older tree is measured by the same protocol; run it for two trees in
turns (A, B, B, A) within one call to compare them.  ``--match`` keeps
the cases whose label ("fill72_clustered N=8100 top_k=50") it matches;
``--iter-segment`` sets the iterative selection's segment unit
(``memory_topk.ITER_SEGMENT``) to time other segment rules.  Results also
go to ``chiprun_out/iter_compare<--tag>.json``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def kernel_ms(torch, fn, reps: int = 10, tries: int = 3) -> dict:
    """Mean device time a call of each kernel that ``fn`` launches, by the
    kernel's name (template arguments dropped), from a ``torch.profiler``
    trace of ``reps`` calls (taken again, up to ``tries`` times, when a
    kernel's launches are not a multiple of ``reps``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                found = re.search(r"(\w+)[<(]", e.name)
                name = found.group(1) if found else e.name
                us.setdefault(name, []).append(
                    e.time_range.end - e.time_range.start)
        if us and all(len(v) % reps == 0 for v in us.values()):
            return {k: sum(v) / reps / 1e3 for k, v in us.items()}
    raise RuntimeError(f"the profiler's trace: { {k: len(v) for k, v in us.items()} }")


def cases(torch, smoke):
    """(case, n, top_k, q, mk, valid) in chip_smoke.kernel_phases' order and
    from its inputs, then top_k = 256 on the fullest clustered bank."""
    dev = torch.device(smoke.DEVICE)
    gen = torch.Generator(device=dev).manual_seed(0)
    qk = torch.randn((smoke.N_QUERIES, smoke.CK), generator=gen,
                     device=dev).to(torch.bfloat16)
    # the readout values, drawn only to keep the generator's sequence
    torch.randn((2, max(smoke.FILLS) * smoke.HW_TOKENS, smoke.CV),
                generator=gen, device=dev)
    for clustered in (False, True):
        for fill in smoke.FILLS:
            mk, valid = smoke.make_bank(torch, gen, qk, fill, clustered)
            case = f"fill{fill}_{'clustered' if clustered else 'random'}"
            for n in (smoke.N_QUERIES, smoke.HW_TOKENS):
                yield case, n, smoke.TOP_K, qk[:n], mk, valid
            if clustered and fill == max(smoke.FILLS):
                yield case, smoke.N_QUERIES, smoke.SORT_WIDE_K, qk, mk, valid


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(ROOT),
                    help="checkout whose eva_vos_tpu_torch is timed")
    ap.add_argument("--tag", default="", help="suffix of the JSON file's name")
    ap.add_argument("--match", default="",
                    help="regular expression: the case labels to time")
    ap.add_argument("--iter-segment", type=int, default=None,
                    help="tokens a segment unit of the iterative selection")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_port_iter_compare: no CUDA device", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke_protocol",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import eva_vos_tpu_torch
    from eva_vos_tpu_torch.kernels import (build, memory_topk, select_topk,
                                           topk_select_plain,
                                           topk_select_resident)

    if Path(eva_vos_tpu_torch.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"imported {eva_vos_tpu_torch.__file__}, not the "
                           f"package of {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smoke.card_line()
    print(f"[card] {card}; package {root}", flush=True)
    build.build_all()
    if args.iter_segment is not None:
        memory_topk.ITER_SEGMENT = args.iter_segment

    def iterative(q, mk, valid, k):
        vals, idx = select_topk(mk, q, k, valid, return_raw=True)
        return vals.T, idx.T

    selections = {
        "iterative": (iterative,
                      lambda q, mk, valid, k: select_topk(mk, q, k, valid)),
        "resident": (topk_select_resident, topk_select_resident)}
    rows = []
    for case, n, k, q, mk, valid in cases(torch, smoke):
        if not re.search(args.match, f"{case} N={n} top_k={k}"):
            continue
        ref_vals, ref_idx = topk_select_plain(q, mk, valid, k + 1)
        lib = smoke.library_times(torch, mk[:valid], q, ref_vals, k)
        bound, by = smoke.selection_bound(n, valid, k)
        for name, (checked, timed) in selections.items():
            label = f"{name} {case} N={n} top_k={k}"
            vals, idx = checked(q, mk, valid, k)
            err, n_diff = smoke.check_selection(torch, vals, idx, ref_vals,
                                                ref_idx, label, k)
            row = dict(selection=name, case=case, n=n, top_k=k,
                       max_abs_err=err, ids_differ=n_diff,
                       ms=smoke.cuda_ms(torch, lambda: timed(q, mk, valid, k),
                                        10),
                       kernels_ms=kernel_ms(torch,
                                            lambda: timed(q, mk, valid, k)),
                       library_ms=min(lib.values()), library=lib,
                       bound_ms=bound, bound_by=by)
            row["device_ms"] = sum(row["kernels_ms"].values())
            rows.append(row)
            split = ", ".join(f"{k_} {v:.4f}"
                              for k_, v in row["kernels_ms"].items())
            print(f"[{name}] {case} N={n} top_k={k}: max|dv|={err:.3g} "
                  f"ids_differ={n_diff} call {row['ms']:.4f} ms, device "
                  f"{row['device_ms']:.4f} ms ({split}), addmm+torch.topk "
                  f"{row['library_ms']:.4f} ms, bound {bound:.4f} ms ({by})",
                  flush=True)
        del ref_vals, ref_idx
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"iter_compare{args.tag}.json").write_text(
        json.dumps({"card": card, "root": str(root),
                    "iter_segment": args.iter_segment, "rows": rows},
                   indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
