"""Where the PyTorch port's engine spends one ``interact`` on the GPU.

    python3 scripts/torch_port_profile.py     # from the repo root, one GPU
    python3 scripts/torch_port_profile.py --strategy fused \
        --sel-method resident --readout-method grid

Builds the engine as ``chip_smoke.py`` does (T=60, 480x854, ResNet-50 key
and ResNet-18 value encoders, top_k=50, mem_freq=5, bf16, random weights
from seed 0), warms up, times three untraced interacts, then traces with
``torch.profiler`` one interact at frame 0 (the forward pass over 59 frames)
and one at frame 30 from its result (both passes, fused through FusionNet).
For each it prints the host wall time, the device busy time (union of the
kernel intervals) and idle share, and the device time by kernel group and
by kernel.  ``--strategy`` ('auto', 'fused', 'select') and, for 'fused',
``--sel-method`` / ``--readout-method`` choose the memory read as
``EngineConfig`` does (default: 'auto' with the ``EVAVOS_*`` variables).
Results also go to ``chiprun_out/torch_port_profile<--tag>.json``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

GROUPS = (  # first match wins; lower-case substrings of kernel names
    ("memory_topk kernel", ("topk_kernel",)),
    ("memory_topk chunked kernel", ("topk_chunked_kernel",)),
    ("memory_topk_resident kernel", ("topk_resident_kernel",)),
    ("memory_topk_grid kernels", ("topk_split_kernel", "topk_merge_kernel")),
    ("memory_readout kernel", ("readout_kernel",)),
    ("memory_readout_chunked kernel", ("readout_chunked_kernel",)),
    ("convolution / matmul", ("conv", "xmma", "cudnn", "gemm", "sm90", "sm80",
                              "implicit", "cutlass", "wgrad", "dgrad")),
    ("sort / topk (plain ops)", ("sort", "topk", "radix")),
    ("resize", ("upsample", "interp")),
    ("batch norm", ("batch_norm", "bn_")),
    ("copy / fill", ("memcpy", "memset", "copy", "fill", "cat")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def busy_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def trace(torch, fn) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_kernel = defaultdict(lambda: [0.0, 0])
    intervals = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        s, t = e.time_range.start, e.time_range.end
        intervals.append((s, t))
        by_kernel[e.name][0] += t - s
        by_kernel[e.name][1] += 1
    if not intervals:
        raise RuntimeError("the profiler recorded no device activity")
    by_group = defaultdict(float)
    for name, (us, _) in by_kernel.items():
        by_group[group_of(name)] += us
    busy = busy_us(intervals)
    span = max(t for _, t in intervals) - min(s for s, _ in intervals)
    return dict(
        wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
        device_span_ms=span / 1e3, idle_share_of_wall=1 - busy / wall_us,
        kernel_launches=sum(n for _, n in by_kernel.values()),
        groups_ms={g: us / 1e3 for g, us in
                   sorted(by_group.items(), key=lambda kv: -kv[1])},
        top_kernels=[dict(name=n[:120], ms=us / 1e3, count=c) for n, (us, c) in
                     sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:15]])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--strategy", default="auto",
                    choices=("auto", "fused", "select"))
    ap.add_argument("--sel-method", default=None,
                    choices=("tournament", "chunked", "resident"))
    ap.add_argument("--readout-method", default=None,
                    choices=("grid", "chunked"))
    ap.add_argument("--tag", default="",
                    help="suffix of the JSON file's name")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_port_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from eva_vos_tpu_torch.data import synthetic_video
    from eva_vos_tpu_torch.engine import (EngineConfig, InferenceEngine,
                                          pad_mask, prepare_video)
    from eva_vos_tpu_torch.kernels import KernelConfig, build
    from eva_vos_tpu_torch.models import FusionNet, PropagationNetwork

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {card}", flush=True)
    build.build_all()
    dtype = torch.bfloat16
    torch.manual_seed(0)
    engine = InferenceEngine(
        PropagationNetwork(key_arch="resnet50", value_arch="resnet18").to(dtype),
        FusionNet().to(dtype),
        EngineConfig(mem_freq=5, top_k=50, max_interactions=60,
                     feature_chunk=2, readout_strategy=args.strategy,
                     kernels=KernelConfig(sel_method=args.sel_method,
                                          readout_method=args.readout_method)))
    images, masks = synthetic_video(60, 480, 854, num_objects=1, seed=0)
    padded, pad = prepare_video(images, dtype=dtype)
    feats = engine.precompute_features(padded)
    state0 = engine.init_state(feats, 1)
    m0, m30 = pad_mask(masks[:1, 0], pad), pad_mask(masks[:1, 30], pad)

    for _ in range(2):
        out = engine.interact(state0, feats, m0, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        out = engine.interact(state0, feats, m0, 0)
    torch.cuda.synchronize()
    untraced_ms = (time.perf_counter() - t0) / 3 * 1e3

    results = {"card": card, "strategy": engine.config.readout_strategy,
               "kernels": engine.config.kernels._asdict(),
               "untraced_interact0_ms": untraced_ms}
    print(f"[read] {engine.config.readout_strategy} {engine.config.kernels}")
    results["interact0"] = trace(
        torch, lambda: engine.interact(state0, feats, m0, 0))
    results["interact30"] = trace(
        torch, lambda: engine.interact(out, feats, m30, 30))
    print(f"[untraced] interact at frame 0: {untraced_ms:.2f} ms "
          f"({59 / untraced_ms * 1e3:.1f} fps)")
    for key in ("interact0", "interact30"):
        r = results[key]
        print(f"[{key}] wall {r['wall_ms']:.2f} ms, device busy "
              f"{r['device_busy_ms']:.2f} ms, idle share "
              f"{r['idle_share_of_wall']:.3f}, {r['kernel_launches']} kernels")
        for g, ms in r["groups_ms"].items():
            print(f"[{key}]   {g}: {ms:.2f} ms")
        for k in r["top_kernels"][:8]:
            print(f"[{key}]     {k['ms']:.2f} ms x{k['count']}  {k['name']}")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"torch_port_profile{args.tag}.json").write_text(
        json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
