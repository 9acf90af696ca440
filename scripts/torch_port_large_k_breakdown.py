"""Where #2's large-k readout spends its device time, on one GPU.

    python3 scripts/torch_port_large_k_breakdown.py

Builds copies of ``csrc/memory_readout.cu`` whose large-k kernel
(``readout_large_k_kernel``) has one part taken out or one branch forced,
and times each beside the kernel itself with ``torch.profiler`` (mean
device time of 10 launches) on ``chip_smoke.py``'s phase 6c inputs (the
default selection, #1, at top_k 512 and 2,048 on the clustered banks of
fills 1, 12 and 72 at N = 8,100, K = 1, CV = 512 bf16, and top_k 512 in
fp32 at fill 12):

* ``kernel``: the kernel as it is;
* ``dense``, ``sparse``, ``direct``: every tile takes that branch (fp32
  has no dense branch: ``dense`` runs its own rule there);
* ``pass1``: returns after the first pass over the picks and the prefix
  scans (the bitmap, the counts, the weights' sums);
* ``plan``: returns after the second pass (the records written), and a
  direct tile returns at once;
* ``no_sums``: the consumers release each stage unsummed (the plan, the
  staging and the weight tiles);
* ``no_weights``: no record is added into the weight tiles (the records
  are still loaded; the sums find no hit, dense stages still multiply);
* ``no_copies``: no row is copied into the ring (the plan, the weights and
  the sums, on whatever the ring holds).

The outputs of the variants but ``kernel`` and the forced branches are wrong
by design; only their times count.  Results also go to
``chiprun_out/large_k_breakdown.json``.  A variant whose anchor text is no
longer in the source fails: update it with the kernel.
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

_CUTS = ("constexpr int kDenseNum = 1, kDenseDen = 8;",
         "constexpr int kShare = 4;")
# variant -> [(text of memory_readout.cu, its replacement)]
VARIANTS = {
    "kernel": [],
    "dense": [(_CUTS[0], "constexpr int kDenseNum = 0, kDenseDen = 8;")],
    "sparse": [(_CUTS[0], "constexpr int kDenseNum = 1 << 20, "
                          "kDenseDen = 1;"),
               (_CUTS[1], "constexpr int kShare = 0;")],
    "direct": [(_CUTS[0], "constexpr int kDenseNum = 1 << 20, "
                          "kDenseDen = 1;"),
               (_CUTS[1], "constexpr int kShare = 1 << 20;")],
    "pass1": [("  const int stages = (nrows + kS - 1) / kS;",
               "  if (nrows >= 0) return;\n"
               "  const int stages = (nrows + kS - 1) / kS;")],
    "plan": [("  if (mode == kDirect) {\n    // the kernel above's gather",
              "  if (mode == kDirect) return;\n  if (mode == kDirect) {\n"
              "    // the kernel above's gather"),
             ("  // 3. the walk: stage g holds row slots",
              "  if (nrows >= 0) return;\n"
              "  // 3. the walk: stage g holds row slots")],
    "no_sums": [("        if (16 * ks >= nr) break;",
                 "        if (16 * ks >= nr || nr > 0) break;"),
                ("        while (hits) {", "        while (hits && nr < 0) {")],
    "no_weights": [("        if (x.x >= 0) {\n          atomicAdd(wp",
                    "        if (x.x >= 0 && nr < 0) {\n          atomicAdd(wp")],
    "no_copies": [("        if (((bw >> lane) & 1u) && slot >= 0 && slot < nr) {",
                   "        if (((bw >> lane) & 1u) && slot >= 0 && nr < 0) {"),
                  ("        mbar_expect_tx(full + p, nr * row_bytes);",
                   "        if (nr < 0) mbar_expect_tx(full + p, 0);")],
}


def build_variants(build, work: Path) -> dict:
    """{variant: its memory_readout_launch}, all built at once."""
    procs = {}
    for name, edits in VARIANTS.items():
        src = work / name
        shutil.copytree(CSRC, src)
        path = src / "memory_readout.cu"
        text = path.read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} is not in the kernel")
            text = text.replace(old, new)
        path.write_text(text)
        so = src / "lib.so"
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(path)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    fns = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(so)).memory_readout_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def device_us(torch, call, reps: int = 10, tries: int = 3) -> float:
    """Mean device time of one launch over ``reps``, from a profiler trace
    (taken again, up to ``tries`` times, when it lost a launch)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if call() != 0:
        raise RuntimeError("launch failed")
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
        us = [e.time_range.end - e.time_range.start for e in prof.events()
              if e.device_type == DeviceType.CUDA]
        if len(us) >= reps:
            return sum(us) / reps
    raise RuntimeError(f"the profiler's traces hold {len(us)} of {reps} "
                       f"launches")


def cases(torch, smoke):
    """(label, mv, vals, idx) of phase 6c's #2 cases, made as
    ``chip_smoke.large_k_kernels`` makes them (the same seed and order)."""
    from eva_vos_tpu_torch.kernels import topk_select

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    qk = torch.randn((smoke.N_QUERIES, smoke.CK), generator=gen,
                     device=dev).to(torch.bfloat16)
    mv = torch.randn((1, max(smoke.FILLS) * smoke.HW_TOKENS, smoke.CV),
                     generator=gen, device=dev).to(torch.bfloat16)
    out = []
    for fill in smoke.FILLS:
        mk, valid = smoke.make_bank(torch, gen, qk, fill, clustered=True)
        for k in smoke.LARGE_K:
            out.append((f"fill{fill} top_k={k} bf16", mv,
                        *topk_select(qk, mk, valid, k)))
        if fill == smoke.LARGE_K_FP32[0]:
            k = smoke.LARGE_K_FP32[1]
            out.append((f"fill{fill} top_k={k} fp32", mv.float(),
                        *topk_select(qk.float(), mk.float(), valid, k)))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_port_large_k_breakdown: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location("chip_smoke_protocol",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from eva_vos_tpu_torch.kernels import build
    from eva_vos_tpu_torch.kernels.memory_readout import (large_k_geometry,
                                                          large_k_tiles)

    card = smoke.card_line()
    print(f"[card] {card}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        fns = build_variants(build, Path(tmp))
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        stream = torch.cuda.current_stream().cuda_stream
        rows = []
        for label, mv, vals, idx in cases(torch, smoke):
            k, n = vals.shape
            _, m, cv = mv.shape
            bf16 = mv.dtype == torch.bfloat16
            queries, slices = large_k_geometry(n, 1, cv, mv.element_size(),
                                               sms)
            out = torch.empty((1, n, cv), dtype=mv.dtype, device=mv.device)
            scratch = torch.empty(2 * -(-n // queries) * slices * queries * k,
                                  dtype=torch.int32, device=mv.device)
            tiles = large_k_tiles(vals, idx, queries,
                                  cv * mv.element_size(), bf16)
            row = dict(case=label, queries=queries, slices=slices,
                       tiles={m: sum(t[0] == m for t in tiles)
                              for m in ("dense", "sparse", "direct")})
            for name, fn in fns.items():
                row[name] = device_us(torch, lambda: fn(
                    mv.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                    out.data_ptr(), 1, n, m, cv, k, queries, slices,
                    int(bf16), stream, scratch.data_ptr(), None))
            rows.append(row)
            print(f"[breakdown] {label} ({queries}-query tiles {row['tiles']})"
                  f", device us: " + ", ".join(
                      f"{name} {row[name]:.1f}" for name in VARIANTS),
                  flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "large_k_breakdown.json").write_text(
        json.dumps(dict(card=card, rows=rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
