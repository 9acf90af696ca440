"""Where the chunked readout's stage spends its device time, on one GPU.

    python3 scripts/torch_port_readout_breakdown.py

Builds copies of ``csrc/memory_readout_chunked.cu`` whose stage
(``csrc/readout_common.cuh``) has one part taken out or changed, and times
each beside the stage itself with ``torch.profiler`` (mean device time of
20 launches) on ``chip_smoke.py``'s readout inputs (its default selection
on the clustered banks at fills 1, 12 and 72, N = 8100 and 1620, K = 1,
CV = 512, bf16; and the random bank at fill 12, N = 8100):

* ``stage``: the stage as it is;
* ``plan_only``: returns after the per-warp sorts (the picks' loads and
  sorts, and the launch);
* ``no_sums``: the consumers release each stage without summing it (the
  plan and the staging);
* ``no_copies``: the producers arm each stage with no copy (the plan and
  the sums);
* ``half_rows``: each copy moves half of its row slice (the same copies,
  half the bytes);
* ``one_producer``: one producer warp issues every stage's copies.

The outputs of the variants are wrong by design; only their times count.
Results also go to ``chiprun_out/readout_breakdown.json``.  A variant whose
anchor text is no longer in the source fails: update it with the stage.
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

# variant -> [(text of readout_common.cuh, its replacement)]
VARIANTS = {
    "stage": [],
    "plan_only": [("  // 3. the windows of the walk",
                   "  return;\n  // 3. the windows of the walk")],
    "no_sums": [("while (next[qi].x < r1) {",
                 "while (next[qi].x < r1 && r1 < 0) {")],
    "no_copies": [("for (int r = r0 + lane; r < r1; r += 32) {",
                   "for (int r = r0 + lane; r < r0; r += 32) {"),
                  ("if (r1 > r0) {", "if (false) {")],
    "half_rows": [("mbar_arrive_tx(full + b, (r1 - r0) * row_bytes);",
                   "mbar_arrive_tx(full + b, (r1 - r0) * (row_bytes / 2));"),
                  ("row_bytes, full + b);", "row_bytes / 2, full + b);")],
    "one_producer": [("constexpr int kThreads = 32 * (kWarps + kRing);",
                      "constexpr int kThreads = 32 * (kWarps + 1);"),
                     ("if (b == warp - kWarps) {", "if (true) {")],
}
CASES = [(f"fill{f}_clustered", n) for f in (1, 12, 72) for n in (8100, 1620)]
CASES.append(("fill12_random", 8100))


def build_variants(build, work: Path) -> dict:
    """{variant: its memory_readout_chunked_launch}, all built at once."""
    procs = {}
    for name, edits in VARIANTS.items():
        src = work / name
        shutil.copytree(CSRC, src)
        header = src / "readout_common.cuh"
        text = header.read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} is not in the stage")
            text = text.replace(old, new)
        header.write_text(text)
        so = src / "lib.so"
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-o", str(so),
               str(src / "memory_readout_chunked.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    fns = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(so)).memory_readout_chunked_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def device_us(torch, call, reps: int = 20) -> float:
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
        print("torch_port_readout_breakdown: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location("chip_smoke_protocol",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from eva_vos_tpu_torch.kernels import build
    from eva_vos_tpu_torch.kernels.memory_readout import readout_geometry

    card = smoke.card_line()
    print(f"[card] {card}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        fns = build_variants(build, Path(tmp))
        mv2, sels = smoke.readout_inputs(torch)
        mv = mv2[:1].contiguous()
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        stream = torch.cuda.current_stream().cuda_stream
        rows = []
        for case, n in CASES:
            vals, idx = sels[(case, n)]
            k = vals.shape[0]
            _, m, cv = mv.shape
            queries, slices = readout_geometry(n, 1, cv, 2, k, sms)
            out = torch.empty((1, n, cv), dtype=mv.dtype, device=mv.device)
            row = dict(case=case, n=n, queries=queries, slices=slices)
            for name, fn in fns.items():
                row[name] = device_us(torch, lambda: fn(
                    mv.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                    out.data_ptr(), 1, n, m, cv, k, queries, slices, 0, 1,
                    stream, None))
            rows.append(row)
            print(f"[breakdown] {case} N={n} (tiles of {queries} x {slices} "
                  f"slices), device us: " + ", ".join(
                      f"{name} {row[name]:.1f}" for name in VARIANTS),
                  flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "readout_breakdown.json").write_text(
        json.dumps(dict(card=card, rows=rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
