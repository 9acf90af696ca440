"""Where #1's large-k radix kernel spends its device time, on one GPU.

    python3 scripts/torch_port_radix_breakdown.py

Builds copies of ``csrc/memory_topk.cu`` whose radix kernel
(``topk_radix_kernel``, the selection above top_k 256) has part of its work
taken out, and times that kernel alone by name with ``torch.profiler``
(mean device time of 10 calls) on ``chip_smoke.py``'s clustered banks at
N = 8,100, CK = 64 (fill 72 at top_k 512 and 2,048 and fill 12 at 2,048 in
bf16; fill 12 at 512 in fp32):

* ``radix``: the kernel as it is (every pass);
* ``pass1``: the first pass only (every query stops after its first
  digit's histogram): one scoring of the bank with the histogram's
  shared atomics;
* ``pass1_no_atomics``: as ``pass1``, the scores and their ords formed
  but not counted (a condition the compiler cannot fold, never true at
  run time, stands before the atomic);
* ``pass1_stage_mma`` (bf16): as ``pass1``, the tensor-core products
  formed but no score from them (the staging, ``ldmatrix`` and
  ``mma.sync``);
* ``pass1_stage`` (bf16): as ``pass1_stage_mma`` without the products:
  the bank's staging through each warp's ``cp.async`` ring alone.

The variants' selections are wrong by design; the times of the kernel's
parts are what they report.  Results also go to
``chiprun_out/radix_breakdown.json``.  A variant whose anchor text is no
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

_STOP = ("    st.mode = fits ? kCompact : kSpill;\n",
         "    st.mode = kIdle;\n    st.pre = 1ull;\n    st.mask = 0ull;\n")
_NO_ATOMIC = ("    if (gate == 0u) hist_add(s, qi, d);\n",
              "    if (gate == 0u && ord == 0u) hist_add(s, qi, d);\n")
_NO_SCORE = ("              if (tok + t >= valid) continue;\n",
             "              if (tok + t >= valid ||\n"
             "                  d[mt][2 * h + t] != -12345.f) continue;\n")
_NO_MMA = ("            mma_bf16(d[mt], a[mt][kq], bq[2 * kq], "
           "bq[2 * kq + 1]);\n",
           "            d[mt][kq] += __uint_as_float(bq[2 * kq] & 1u);\n")
# variant -> [(text of memory_topk.cu, its replacement)]
VARIANTS = {
    "radix": [],
    "pass1": [_STOP],
    "pass1_no_atomics": [_STOP, _NO_ATOMIC],
    "pass1_stage_mma": [_STOP, _NO_SCORE],
    "pass1_stage": [_STOP, _NO_SCORE, _NO_MMA],
}
BF16_ONLY = ("pass1_stage_mma", "pass1_stage")
# (fill, top_k, dtype name)
CASES = [(72, 512, "bf16"), (72, 2048, "bf16"), (12, 2048, "bf16"),
         (12, 512, "fp32")]


def build_variants(build, work: Path) -> dict:
    """{variant: its memory_topk_radix_launch}, all built at once."""
    procs = {}
    for name, edits in VARIANTS.items():
        src = work / name
        shutil.copytree(CSRC, src)
        path = src / "memory_topk.cu"
        text = path.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not once in the "
                                   f"source")
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
        fn = ctypes.CDLL(str(so)).memory_topk_radix_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p] * 9 + [ctypes.c_int])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def radix_us(torch, call, reps: int = 10) -> float:
    """Mean device time of the radix kernel a call, from a trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if call() != 0:
        raise RuntimeError("launch failed")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    us = [e.time_range.end - e.time_range.start for e in prof.events()
          if e.device_type == DeviceType.CUDA
          and "topk_radix_kernel" in e.name]
    if not us:
        raise RuntimeError("the trace holds no topk_radix_kernel")
    return sum(us) / len(us)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_port_radix_breakdown: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location("chip_smoke_protocol",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from eva_vos_tpu_torch.kernels import build
    from eva_vos_tpu_torch.kernels.memory_topk import (RADIX_HIST_BINS,
                                                       RADIX_ROUND, radix_cap)

    card = smoke.card_line()
    print(f"[card] {card}", flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    qk = torch.randn((smoke.N_QUERIES, smoke.CK), generator=gen,
                     device=dev).to(torch.bfloat16)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        fns = build_variants(build, Path(tmp))
        for fill, k, dtype in CASES:
            mk, valid = smoke.make_bank(torch, gen, qk, fill, clustered=True)
            q = qk if dtype == "bf16" else qk.float()
            mk = mk if dtype == "bf16" else mk.float()
            n, kk, cap = q.shape[0], min(k, valid), radix_cap(valid, k)
            keys = torch.empty((n, kk), dtype=torch.int64, device=dev)
            cand = torch.empty((n, cap), dtype=torch.int64, device=dev)
            meta = torch.empty((n, 2), dtype=torch.int32, device=dev)
            norms = torch.empty(-(-valid // 8) * 8, dtype=torch.float32,
                                device=dev)
            hist = (torch.empty((n, RADIX_HIST_BINS), dtype=torch.int32,
                                device=dev) if valid > RADIX_ROUND else None)
            vals = torch.empty((k, n), dtype=torch.float32, device=dev)
            idx = torch.empty((k, n), dtype=torch.int32, device=dev)

            def call(fn):
                return fn(q.data_ptr(), mk.data_ptr(), vals.data_ptr(),
                          idx.data_ptr(), n, valid, smoke.CK, k,
                          int(dtype == "bf16"), stream, keys.data_ptr(),
                          None, cand.data_ptr(), meta.data_ptr(),
                          norms.data_ptr(),
                          None if hist is None else hist.data_ptr(), None,
                          None, cap)

            row = dict(fill=fill, valid=valid, n=n, top_k=k, dtype=dtype)
            for name, fn in fns.items():
                if dtype == "fp32" and name in BF16_ONLY:
                    continue
                row[name] = radix_us(torch, lambda: call(fn))
            rows.append(row)
            print(f"[radix breakdown] fill{fill} N={n} top_k={k} {dtype}, "
                  f"topk_radix_kernel device us: " + ", ".join(
                      f"{name} {row[name]:.1f}" for name in VARIANTS
                      if name in row), flush=True)
            del mk
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "radix_breakdown.json").write_text(
        json.dumps(dict(card=card, rows=rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
