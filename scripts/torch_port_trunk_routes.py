"""Time each distinct convolution of the STCN encoders' trunks two ways on
one NVIDIA GPU: cuDNN's fused epilogue (``torch.cudnn_convolution_relu`` /
``torch.cudnn_convolution_add_relu`` with the folded bias) against the
folded convolution followed by its own bias add, residual add and ReLU; and
beside both, the convolution as the module runs it, with its BatchNorm.

    python3 scripts/torch_port_trunk_routes.py [--reps 40]

The shapes are those of the engine at 480x864: the key trunk (ResNet-50 to
layer3) on a ``feature_chunk`` of 4 frames and on a remainder of 2, the
value trunk (5-channel ResNet-18 to layer3) on one frame.  Each shape's
time is the mean of ``--reps`` back-to-back calls between two CUDA events,
after a warm-up; ``first_ms`` is its first call on the host's clock to a
synchronise (cuDNN builds a fused plan there).  Then each whole trunk is
timed as the module, as the ``FusedTrunk`` (every epilogue in cuDNN's
convolution), and as the ``FusedTrunk`` with its CPU route (the folded
convolution, then its own add and ReLU passes), and a profiler lists the
kernels of the ``FusedTrunk``.  Prints a table and writes everything to
``chiprun_out/trunk_routes.json``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

DEVICE = "cuda"
SHAPES = {"key4": ("key_encoder", (4, 3, 480, 864)),
          "key2": ("key_encoder", (2, 3, 480, 864)),
          "value1": ("value_encoder", (1, 5, 480, 864))}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def event_ms(torch, fn, reps: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def random_stats_(net, g) -> None:
    """Non-trivial BatchNorm statistics, scales and shifts, and conv biases,
    so that the fold is not an identity."""
    import torch

    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
            elif isinstance(m, torch.nn.Conv2d) and m.bias is not None:
                m.bias.normal_(0.0, 0.1, generator=g)


def record_calls(ft, fused, x):
    """Run the folded trunk once, recording each convolution's call:
    (kind, input, _Conv, residual or None)."""
    calls = []
    orig = (fused._conv_relu, fused._conv_add_relu, fused._conv_plain)

    def relu(x, c):
        calls.append(("relu", x, c, None))
        return orig[0](x, c)

    def add_relu(x, c, z):
        calls.append(("add_relu", x, c, z))
        return orig[1](x, c, z)

    def plain(x, c):
        calls.append(("plain", x, c, None))
        return orig[2](x, c)

    fused._conv_relu, fused._conv_add_relu, fused._conv_plain = relu, add_relu, plain
    try:
        ft(x)
    finally:
        fused._conv_relu, fused._conv_add_relu, fused._conv_plain = orig
    return calls


def folded_route(F):
    """``fused_trunk``'s CPU route, to run on the card."""
    return (lambda x, c: F.conv2d(x, c.weight, c.bias, c.stride,
                                  c.padding).relu_(),
            lambda x, c, z: F.conv2d(x, c.weight, c.bias, c.stride,
                                     c.padding).add_(z).relu_())


def ways(torch, F, kind, x, c, z, dtype):
    """{way: fn} of one recorded convolution in ``dtype``."""
    x, z = x.to(dtype), None if z is None else z.to(dtype)
    w = c.weight.to(dtype)
    b = None if c.bias is None else c.bias.to(dtype)
    cout = w.shape[0]
    # the module's own: an NCHW weight, BatchNorm after the convolution
    w_mod = w.contiguous()
    mean = torch.zeros(cout, device=x.device, dtype=dtype)
    var = torch.ones_like(mean)

    def bn(y):
        return F.batch_norm(y, mean, var, var, mean, False, 0.0, 1e-5)

    conv = dict(stride=c.stride, padding=c.padding)
    if kind == "plain":
        return {"folded": lambda: F.conv2d(x, w, None, **conv),
                "module": lambda: bn(F.conv2d(x, w_mod, None, **conv))}
    if kind == "relu":
        return {
            "fused": lambda: torch.cudnn_convolution_relu(
                x, w, b, c.stride, c.padding, (1, 1), 1),
            "folded": lambda: F.conv2d(x, w, b, **conv).relu_(),
            "module": lambda: F.relu(bn(F.conv2d(x, w_mod, None, **conv)))}
    return {
        "fused": lambda: torch.cudnn_convolution_add_relu(
            x, w, z, 1.0, b, c.stride, c.padding, (1, 1), 1),
        "folded": lambda: F.conv2d(x, w, b, **conv).add_(z).relu_(),
        "module": lambda: F.relu(bn(F.conv2d(x, w_mod, None, **conv)) + z)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=40)
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_port_trunk_routes: no CUDA device", file=sys.stderr)
        return 1
    from eva_vos_tpu_torch.models import (PropagationNetwork, ResNetTrunk,
                                          make_generator, seeded_init_)
    from eva_vos_tpu_torch.models import fused_trunk

    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, cuDNN "
          f"{torch.backends.cudnn.version()}, cudnn.allow_tf32 "
          f"{torch.backends.cudnn.allow_tf32}", flush=True)
    dev = DEVICE
    net = PropagationNetwork().to(dev).eval()
    g = make_generator(0, dev)
    seeded_init_(net, g)
    random_stats_(net, g)
    result = {"card": card, "torch": torch.__version__,
              "cudnn": torch.backends.cudnn.version(), "shapes": [],
              "trunks": {}}
    seen = set()
    for tag, (enc, shape) in SHAPES.items():
        module = getattr(net, enc)
        x = torch.randn(shape, device=dev, generator=g).contiguous(
            memory_format=torch.channels_last)
        ft = fused_trunk.FusedTrunk(module)
        for kind, xi, c, z in record_calls(ft, fused_trunk, x):
            key = (kind, tuple(xi.shape), tuple(c.weight.shape), c.stride)
            if key in seen:
                continue
            seen.add(key)
            row = {"trunk": tag, "kind": kind, "input": list(xi.shape),
                   "weight": list(c.weight.shape), "stride": list(c.stride)}
            fns = ways(torch, F, kind, xi, c, z, torch.float32)
            if "fused" in fns:
                try:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    got = fns["fused"]()
                    torch.cuda.synchronize()
                    row["first_ms"] = (time.perf_counter() - t0) * 1e3
                    ref = fns["folded"]()
                    row["rel_err"] = float((got - ref).abs().max()
                                           / ref.abs().max().clamp_min(1e-30))
                except RuntimeError as e:
                    row["error"] = str(e).splitlines()[0][:200]
                    fns.pop("fused")
            for way, fn in fns.items():
                row[f"{way}_ms"] = event_ms(torch, fn, args.reps)
            if "fused" in fns:
                try:
                    bf = ways(torch, F, kind, xi, c, z, torch.bfloat16)
                    row["bf16_fused_ms"] = event_ms(torch, bf["fused"], args.reps)
                    row["bf16_folded_ms"] = event_ms(torch, bf["folded"], args.reps)
                except RuntimeError as e:
                    row["bf16_error"] = str(e).splitlines()[0][:200]
            result["shapes"].append(row)
            print("[shape] " + json.dumps(row), flush=True)

    for tag, (enc, shape) in SHAPES.items():
        module = getattr(net, enc)
        x = torch.randn(shape, device=dev, generator=g).contiguous(
            memory_format=torch.channels_last)
        ft = fused_trunk.FusedTrunk(module)

        def module_trunk():
            with torch.no_grad():
                return ResNetTrunk.forward(module, x)

        ref = module_trunk()
        row = {"input": list(shape),
               "module_ms": event_ms(torch, module_trunk, args.reps)}
        fused = (fused_trunk._conv_relu, fused_trunk._conv_add_relu)
        for name, route in (("fused", fused), ("folded", folded_route(F))):
            fused_trunk._conv_relu, fused_trunk._conv_add_relu = route
            try:
                got = ft(x)
                row[f"{name}_rel_err"] = max(
                    float((a - b).abs().max() / b.abs().max())
                    for a, b in zip(got, ref))
                row[f"{name}_ms"] = event_ms(torch, lambda: ft(x), args.reps)
            finally:
                fused_trunk._conv_relu, fused_trunk._conv_add_relu = fused
        acts = torch.profiler.ProfilerActivity
        with torch.profiler.profile(activities=[acts.CPU, acts.CUDA]) as prof:
            ft(x)
            torch.cuda.synchronize()
        row["kernels"] = [
            (e.key[:90], e.count, round(e.device_time_total / 1e3, 4))
            for e in sorted(prof.key_averages(),
                            key=lambda e: -e.device_time_total)[:12]]
        result["trunks"][tag] = row
        print(f"[trunk {tag}] " + json.dumps(row), flush=True)

    out = ROOT / "chiprun_out" / "trunk_routes.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print("| trunk | kind | input | weight | stride | fused ms | folded ms | "
          "module ms | first ms | bf16 fused / folded |")
    for r in result["shapes"]:
        print(f"| {r['trunk']} | {r['kind']} | {r['input']} | {r['weight']} | "
              f"{r['stride']} | {r.get('fused_ms', r.get('error', '-'))} | "
              f"{r['folded_ms']:.4f} | {r['module_ms']:.4f} | "
              f"{r.get('first_ms', '-')} | {r.get('bf16_fused_ms', r.get('bf16_error', '-'))}"
              f" / {r.get('bf16_folded_ms', '-')} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
