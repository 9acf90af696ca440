"""Where the resident walk spends its device time, on one GPU.

    python3 scripts/torch_port_walk_breakdown.py

Builds copies of ``csrc/memory_topk_iter.cu`` (the iterative selection: the
walk of ``csrc/resident_walk.cuh`` with the row epilogue) whose walk has
one part taken out or doubled, and times each beside the walk itself with
``torch.profiler`` (mean device time of 10 launches, the row merge included
where there are several segments) on ``chip_smoke.py``'s selection inputs
(its clustered banks: fill 72 at N = 8100 with top_k 256 and 50, fill 12 at
N = 8100, fill 1 at N = 1620; CK = 64, bf16):

* ``walk``: the walk as it is (with its compactions counted);
* ``score_only``: no key is admitted, so no buffer fills and no wave runs:
  the TMA staging, the tensor-core products and the step's barriers (the
  scores themselves, unused, are not formed), and the last compaction of
  empty buffers;
* ``compare_only``: as ``score_only``, but the scores are formed and each
  row's largest is compared with its threshold (a condition the compiler
  cannot fold, never true at run time, stands between the compare and the
  admission);
* ``cut_twice``: every cut of a buffer (in the waves and the last
  compaction) finds its k-th key twice, so that the difference from
  ``walk`` is the cuts' bisections and the barrier waits they cause;
* ``final_sort_twice``: the last compaction sorts each buffer's kept keys
  twice, likewise.

The outputs of ``score_only`` are wrong by design; the doubled variants
give the walk's result.  Results also go to
``chiprun_out/walk_breakdown.json``.  A variant whose anchor text is no
longer in the header fails: update it with the walk.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "eva_vos_tpu_torch" / "kernels" / "csrc"

# variant -> [(text of resident_walk.cuh, its replacement)]
VARIANTS = {
    "walk": [],
    "score_only": [("    if (hit) {\n", "    if (hit && false) {\n")],
    "compare_only": [("    if (hit) {\n",
                      "    if (hit && compactions == "
                      "reinterpret_cast<int*>(8)) {\n")],
    "cut_twice": [("  const u64 kth = kth_key<R>(v, live, top_k);\n",
                   "  volatile int kk = top_k;  // read twice: no common "
                   "subexpression\n  const u64 kth = min(kth_key<R>(v, live, "
                   "kk), kth_key<R>(v, live, kk));\n")],
    "final_sort_twice": [("    sort_buffer<G::kCap>(buf, c, top_k);\n",
                          "    sort_buffer<G::kCap>(buf, c, c);\n"
                          "    sort_buffer<G::kCap>(buf, c, top_k);\n")],
}
CASES = [("fill72_clustered", 8100, 256), ("fill72_clustered", 8100, 50),
         ("fill12_clustered", 8100, 50), ("fill1_clustered", 1620, 50)]


def build_variants(build, work: Path) -> dict:
    """{variant: its memory_topk_iter_launch}, all built at once."""
    procs = {}
    for name, edits in VARIANTS.items():
        src = work / name
        shutil.copytree(CSRC, src)
        header = src / "resident_walk.cuh"
        text = header.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not once in the walk")
            text = text.replace(old, new)
        header.write_text(text)
        so = src / "lib.so"
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-o", str(so),
               str(src / "memory_topk_iter.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    fns = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(so)).memory_topk_iter_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def device_us(torch, call, reps: int = 10) -> float:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if call() != 0:
        raise RuntimeError("launch failed")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    return sum(e.time_range.end - e.time_range.start for e in prof.events()
               if e.device_type == DeviceType.CUDA) / reps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_port_walk_breakdown: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location("chip_smoke_protocol",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from eva_vos_tpu_torch.kernels import build
    from eva_vos_tpu_torch.kernels.memory_topk import iter_segments

    compare = importlib.util.spec_from_file_location(
        "iter_compare", ROOT / "scripts" / "torch_port_iter_compare.py")
    cmp = importlib.util.module_from_spec(compare)
    compare.loader.exec_module(cmp)
    card = smoke.card_line()
    print(f"[card] {card}", flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        fns = build_variants(build, Path(tmp))
        for case, n, k, q, mk, valid in cmp.cases(torch, smoke):
            if (case, n, k) not in CASES:
                continue
            segs = iter_segments(n, valid, k, sms)
            out_v = torch.empty((n, k), dtype=torch.float32, device=q.device)
            out_i = torch.empty((n, k), dtype=torch.int32, device=q.device)
            part = (torch.empty((n, segs, k), dtype=torch.int64,
                                device=q.device) if segs > 1 else None)
            comp = torch.zeros(1, dtype=torch.int32, device=q.device)

            def call(fn, counter=None):
                return fn(q.data_ptr(), mk.data_ptr(), out_v.data_ptr(),
                          out_i.data_ptr(),
                          None if part is None else part.data_ptr(), n, valid,
                          64, k, segs,
                          None if counter is None else counter.data_ptr(), 0,
                          1, stream)

            if call(fns["walk"], comp) != 0:
                raise RuntimeError("launch failed")
            torch.cuda.synchronize()
            row = dict(case=case, n=n, top_k=k, segments=segs,
                       compactions=int(comp.item()))
            for name, fn in fns.items():
                row[name] = device_us(torch, lambda: call(fn))
            rows.append(row)
            print(f"[breakdown] {case} N={n} top_k={k} (segments {segs}, "
                  f"compactions {row['compactions']}), device us: " +
                  ", ".join(f"{name} {row[name]:.1f}" for name in VARIANTS),
                  flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "walk_breakdown.json").write_text(
        json.dumps(dict(card=card, rows=rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
