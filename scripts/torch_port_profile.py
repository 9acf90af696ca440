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

Selection kernels that several reads launch (the pruned block stage's, and
the transposed merge, which the resident selection also launches for its
bank segments) are grouped under the selection of the read profiled, and
the readout kernels under the read's readout.  For
the newest-first selection ('fused' with ``--sel-method chunked``) the
script also counts, over an untraced interact at each frame, the (query,
bank block) rows its running floor emptied and those that escalated; for
the resident one ('fused' with ``--sel-method resident``) the compactions
of its candidate buffers.
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

# the selection kernels, by the library that launched them: the default
# and the newest-first selections share theirs, as the sort and the 'select'
# read's do, and the resident selection merges its segments with the
# default's topk_merge_t_kernel, so the read decides
SELECTION_KERNELS = ("topk_prune_block_kernel", "topk_merge_t_kernel",
                     "topk_rows_block_kernel", "topk_rows_merge_kernel",
                     "topk_resident_kernel")
# the selection of each 'fused' read's sel_method ('select' reads by grid)
SELECTIONS = {"tournament": "memory_topk", "chunked": "memory_topk_chunked",
              "resident": "memory_topk_resident"}
# the readout kernels (the chunked readout's stage and the default gather),
# grouped under the readout of the read profiled
READOUT_KERNELS = ("readout_stage_kernel", "readout_kernel")
GROUPS = (  # first match wins; lower-case substrings of kernel names
    ("convolution / matmul", ("conv", "xmma", "cudnn", "gemm", "sm90", "sm80",
                              "implicit", "cutlass", "wgrad", "dgrad")),
    ("sort / topk (plain ops)", ("sort", "topk", "radix")),
    ("resize", ("upsample", "interp")),
    ("batch norm", ("batch_norm", "bn_")),
    ("copy / fill", ("memcpy", "memset", "copy", "fill", "cat")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def group_of(name: str, selection: str, readout: str) -> str:
    """The group of a kernel's time; ``selection`` and ``readout`` name the
    read's."""
    low = name.lower()
    if any(k in low for k in SELECTION_KERNELS):
        return f"{selection} kernels"
    if any(k in low for k in READOUT_KERNELS):
        return f"{readout} kernel"
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


def trace(torch, fn, selection: str, readout: str) -> dict:
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
        by_group[group_of(name, selection, readout)] += us
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


def floor_counts(torch, run) -> dict:
    """The newest-first selection's rows over one ``run()``: (query, bank
    block) rows ranked, emptied by its running floor, and escalated.  Wraps
    the read's selector for the run only."""
    from eva_vos_tpu_torch.kernels import memory_topk as M

    dev = torch.device("cuda")
    floored = torch.zeros(1, dtype=torch.int32, device=dev)
    esc = torch.zeros(1, dtype=torch.int32, device=dev)
    rows = [0]
    select = M.SELECTORS["chunked"]

    def counted(qk, mk, valid, top_k, no_skip=False):
        valid_n = mk.shape[0] if valid is None else max(0, min(int(valid),
                                                               mk.shape[0]))
        rows[0] += qk.shape[0] * M._live_blocks(valid_n)
        return select(qk, mk, valid, top_k, no_skip=no_skip,
                      escalations=esc, floored_rows=floored)

    M.SELECTORS["chunked"] = counted
    try:
        run()
        torch.cuda.synchronize()
    finally:
        M.SELECTORS["chunked"] = select
    return dict(rows=rows[0], floored_rows=int(floored.item()),
                escalated_rows=int(esc.item()))


def compaction_counts(torch, run) -> dict:
    """The resident selection's calls, queries and compactions of its
    candidate buffers over one ``run()``.  Wraps the read's selector for the
    run only."""
    from eva_vos_tpu_torch.kernels import memory_topk as M

    comp = torch.zeros(1, dtype=torch.int32, device=torch.device("cuda"))
    calls = [0, 0]
    select = M.SELECTORS["resident"]

    def counted(qk, mk, valid, top_k):
        calls[0] += 1
        calls[1] += qk.shape[0]
        return select(qk, mk, valid, top_k, compactions=comp)

    M.SELECTORS["resident"] = counted
    try:
        run()
        torch.cuda.synchronize()
    finally:
        M.SELECTORS["resident"] = select
    return dict(calls=calls[0], queries=calls[1],
                compactions=int(comp.item()))


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

    strategy = engine.config.readout_strategy
    selection = ("memory_topk_grid" if strategy == "select" else
                 SELECTIONS[engine.config.kernels.methods()[0]])
    readout = ("memory_readout_chunked"
               if engine.config.kernels.methods()[1] == "chunked"
               else "memory_readout")
    results = {"card": card, "strategy": strategy,
               "kernels": engine.config.kernels._asdict(),
               "selection": selection, "untraced_interact0_ms": untraced_ms}
    print(f"[read] {strategy} {engine.config.kernels}: {selection}")
    runs = {"0": lambda: engine.interact(state0, feats, m0, 0),
            "30": lambda: engine.interact(out, feats, m30, 30)}
    if selection == "memory_topk_chunked":
        for key, run in runs.items():
            results[f"floor{key}"] = floor_counts(torch, run)
            print(f"[floor{key}] newest-first selection rows: "
                  f"{results[f'floor{key}']}")
    if selection == "memory_topk_resident":
        for key, run in runs.items():
            results[f"compactions{key}"] = compaction_counts(torch, run)
            print(f"[compactions{key}] resident selection: "
                  f"{results[f'compactions{key}']}")
    results["interact0"] = trace(
        torch, lambda: engine.interact(state0, feats, m0, 0), selection,
        readout)
    results["interact30"] = trace(
        torch, lambda: engine.interact(out, feats, m30, 30), selection,
        readout)
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
