"""The port's own spans and counters (``utils/profiling.py``): where the
engine, the feature cache, the kernel build and the model build report to
the process clock ``TRACE``, what they put into a ``torch.profiler`` trace,
and the benchmark's readers of them.

The engine runs a tiny session on the CPU (T=9, 48x64, mem_freq 2, top_k 8,
random weights): frames 0, 6 and 3, so that the passes hold blocked and
single-frame steps, transient stores, and fusion between interacted frames.
The counts are held to ``benchmark/core/schedule.plan_session``, the
harness's own reckoning of the same work.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.core import schedule
from benchmark.core.spec import BENCH, load_module
from benchmark.core.trace import Trace, load_events
from eva_vos_tpu_torch.data import synthetic_video
from eva_vos_tpu_torch.engine import EngineConfig, InferenceEngine
from eva_vos_tpu_torch.interactions import VideoSample, initialize
from eva_vos_tpu_torch.interactions import eval as eval_mod
from eva_vos_tpu_torch.kernels import build
from eva_vos_tpu_torch.models import FusionNet, PropagationNetwork
from eva_vos_tpu_torch.utils import profiling
from eva_vos_tpu_torch.utils.profiling import TRACE, WallClock

T, H, W = 9, 48, 64
MEM_FREQ, TOP_K = 2, 8
FRAMES = [0, 6, 3]
HW = (H // 16) * (W // 16)


@pytest.fixture(scope="module")
def engine():
    torch.manual_seed(0)
    stcn = PropagationNetwork(key_arch="resnet18", value_arch="resnet18")
    cfg = EngineConfig(mem_freq=MEM_FREQ, top_k=TOP_K, max_interactions=4,
                       feature_chunk=4)
    return InferenceEngine(stcn, FusionNet(), cfg, device="cpu")


@pytest.fixture
def sample():
    images, masks = synthetic_video(T, H, W, num_objects=1, seed=3)
    return VideoSample("tiny", (images * 255).astype(np.uint8),
                       masks.astype(np.uint8))


def _session(engine, sample, monkeypatch):
    """A fresh feature cache and process clock; open the video and interact
    at FRAMES."""
    monkeypatch.setattr(eval_mod, "_FEATURE_CACHE", {})
    TRACE.reset()
    s = initialize(engine, sample)
    for f in FRAMES:
        s.interact(s.gt_mask(f), f)
    return s


def _within(inner, outers):
    return any(o["ts"] <= inner["ts"] and inner["ts"] + inner["dur"]
               <= o["ts"] + o["dur"] for o in outers)


def test_engine_spans_nest_and_count_the_schedule(engine, sample, monkeypatch,
                                                  tmp_path):
    from torch.profiler import ProfilerActivity, profile

    # a weight written since the engine's last fold: this session folds the
    # encoders' trunks once, whichever test ran first
    engine.stcn.key_encoder.bn1.running_var.mul_(1.0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _session(engine, sample, monkeypatch)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    tr = Trace(load_events(path))
    spans = {}
    for e in tr.host:
        spans.setdefault(e["name"], []).append(e)

    plans = schedule.plan_session(T, FRAMES, MEM_FREQ)
    steps = sum(len(p.reads) for p in plans)
    transient = sum(p.stores for p in plans) - len(plans)
    want = {"engine.precompute": 1, "engine.interact": len(plans),
            "engine.step": steps, "engine.read": steps,
            "engine.decode": steps, "engine.store": sum(p.stores for p in plans),
            "engine.fuse": sum(p.fused for p in plans),
            "propagate": len(plans)}
    assert {k: len(spans.get(k, [])) for k in want} == want
    assert all(TRACE.counts[k] == n for k, n in want.items()
               if k.startswith("engine."))
    assert want["engine.fuse"] > 0 and transient > 0

    assert all(_within(e, spans["propagate"]) for e in spans["engine.interact"])
    assert all(_within(e, spans["engine.interact"]) for e in spans["engine.step"])
    for name in ("engine.read", "engine.decode", "engine.fuse"):
        assert all(_within(e, spans["engine.step"]) for e in spans[name]), name
    assert all(_within(e, spans["engine.interact"])
               for e in spans["engine.store"])
    # the transient stores lie inside a step, each interaction's certain
    # one outside
    assert sum(_within(e, spans["engine.step"])
               for e in spans["engine.store"]) == transient
    assert not any(_within(e, spans["engine.interact"])
                   for e in spans["engine.precompute"])

    blocked = sum(b > 1 for p in plans for b, _ in p.reads)
    assert dict(TRACE.counters) == {
        "feature_cache_misses": 1, "frames_encoded": T,
        "frames_segmented": sum(p.frames for p in plans),
        "steps_blocked": blocked, "steps_single": steps - blocked,
        "reads": steps,
        "read_valid_tokens": sum(m * HW for p in plans for _, m in p.reads),
        "memories_stored": sum(p.stores for p in plans),
        "frames_fused": sum(p.fused for p in plans),
        "trunk_folds": 1, "bn_folded": 30}


def test_feature_cache_counts_hits_and_misses(engine, sample, monkeypatch):
    monkeypatch.setattr(eval_mod, "_FEATURE_CACHE", {})
    TRACE.reset()
    initialize(engine, sample)
    initialize(engine, sample)
    other = VideoSample("other", sample.images01.copy(), sample.gt)
    initialize(engine, other)
    assert TRACE.counters["feature_cache_hits"] == 1
    assert TRACE.counters["feature_cache_misses"] == 2
    assert TRACE.counts["engine.precompute"] == 2
    assert TRACE.counters["frames_encoded"] == 2 * T


def test_no_record_function_without_a_profiler(engine, sample, monkeypatch):
    entered = []
    real = profiling.record_function

    class Counted(real):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(profiling, "record_function", Counted)
    s = _session(engine, sample, monkeypatch)
    assert entered == []
    assert TRACE.counts["engine.step"] > 0 and s.timers.counts["propagate"] == 3

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        _session(engine, sample, monkeypatch)
    assert entered.count("engine.interact") == len(FRAMES)
    assert entered.count("propagate") == len(FRAMES)


def test_span_keeps_totals_and_counters_add():
    clock = WallClock()
    for _ in range(3):
        with clock.span("a"):
            pass
    clock.count("n")
    clock.count("n", 4)
    assert clock.counts["a"] == 3 and clock.totals["a"] >= 0
    assert clock.counters["n"] == 5
    report = clock.report()
    assert "a " in report and "counter" in report and "n " in report
    with pytest.raises(RuntimeError):
        with clock.span("b"):
            raise RuntimeError
    assert clock.counts["b"] == 1
    clock.reset()
    assert not clock.totals and not clock.counters


def test_kernel_build_span_only_when_nvcc_runs(monkeypatch, tmp_path):
    built = []
    monkeypatch.setattr(build, "library_path",
                        lambda name: tmp_path / f"{name}.so")
    monkeypatch.setattr(build, "_build", lambda names: (
        built.extend(names) or {n: 1.0 for n in names}))
    (tmp_path / "memory_readout.so").touch()
    TRACE.reset()
    assert build.build_all(("memory_readout",)) == {"memory_readout": 0.0}
    assert "kernels.build" not in TRACE.counts and built == []
    out = build.build_all(("memory_readout", "memory_topk@64",
                           "memory_topk@32"))
    assert out == {"memory_readout": 0.0, "memory_topk@64": 1.0,
                   "memory_topk@32": 1.0}
    assert built == ["memory_topk@64", "memory_topk@32"]
    assert TRACE.counts["kernels.build"] == 1
    assert TRACE.counters["kernel_builds"] == 2


# ---------------------------------------------------------------- readers
# A traced slice [0, 100] us on a hand-built trace: the host's main thread
# (tid 1) in engine.interact [10, 60] (a step [12, 58] holding a decode
# [15, 25] and a fuse [30, 50]) and engine.precompute [70, 90]; kernels
# [20, 40] launched in the decode, [45, 55] in the fuse, [75, 80] in the
# precompute.  Busy 35 us: the device idles 65%, 35% inside the engine's
# spans (70 - 35), 5% inside the fuse (20 - 15); the fuse's kernels take
# 10 of 35 busy us, the decode's 20.
HOST = [("aten::op", 0, 1), ("engine.interact", 10, 50),
        ("engine.step", 12, 46), ("engine.decode", 15, 10),
        ("engine.fuse", 30, 20), ("engine.precompute", 70, 20)]
KERNELS = [(20, 20, 16), (45, 10, 35), (75, 5, 72)]
EXPECTED = {"engine.idle_share": 35.0, "fuse.idle_share": 5.0,
            "fuse.device_share": 1000 / 35, "decode.device_share": 2000 / 35}


def _readings(host=HOST):
    events = [{"ph": "X", "cat": "cpu_op" if n.startswith("aten") else
               "user_annotation", "name": n, "ts": ts, "dur": d, "tid": 1}
              for n, ts, d in host]
    for i, (ts, d, launch) in enumerate(KERNELS):
        events.append({"ph": "X", "cat": "kernel", "name": f"k{i}", "ts": ts,
                       "dur": d, "tid": 7, "args": {"correlation": i}})
        events.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaLaunchKernel", "ts": launch, "dur": 1,
                       "tid": 1, "args": {"correlation": i}})
    tr = Trace(events)
    lo, hi = 0.0, 100.0
    return {"trace": tr, "slice_us": (lo, hi), "slice_s": (hi - lo) / 1e6,
            "busy_s": tr.device_busy_s(lo, hi)}


def _reader(name):
    return load_module(BENCH / "metrics" / f"{name}.py",
                       f"test_metric_{name.replace('.', '_')}")


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_a_hand_built_trace(name):
    r = _readings()
    assert _reader(name).read(r) == pytest.approx(EXPECTED[name])
    idle = _reader("device.idle_share.stcn").read(r)
    assert idle == pytest.approx(65.0)
    assert (_reader("fuse.idle_share").read(r)
            <= _reader("engine.idle_share").read(r) <= idle)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_without_its_span_is_none(name):
    assert _reader(name).read(_readings(host=HOST[:1])) is None
    assert _reader(name).read({"trace": None}) is None


def test_setup_models_reader(monkeypatch):
    clock = WallClock()
    monkeypatch.setattr(profiling, "TRACE", clock)
    reader = _reader("setup.models_s")
    assert reader.read({}) is None
    clock.totals["models.build"] += 1.25
    assert reader.read({}) == 1.25


def test_benchmark_lists_the_readers():
    bench = json.loads((Path(BENCH).parent / "BENCHMARK.json").read_text())
    names = {m["name"] for m in bench["per_layer"]}
    for name in (*EXPECTED, "setup.models_s"):
        assert name in names and (BENCH / "metrics" / f"{name}.py").exists()


# ---------------------------------------------------------------- the CLI
def test_timers_print_the_process_spans_and_counters(monkeypatch, tmp_path,
                                                    capsys):
    from eva_vos_tpu_torch.cli import eval_annotation_method as cli

    monkeypatch.setenv("EVAVOS_TINY", "1")
    monkeypatch.setenv("EVAVOS_WEIGHTS_ROOT", str(tmp_path / "none"))
    TRACE.reset()
    cli.main(["--policy", "rand_mask", "--synthetic", "1", "--rounds", "2",
              "--allow-random", "--top-k", "8", "--metric", "j",
              "--out-dir", str(tmp_path), "--device", "cpu", "--timers"])
    out = capsys.readouterr().out
    for name in ("propagate", "models.build", "engine.interact",
                 "engine.step", "engine.read", "engine.decode",
                 "engine.precompute", "frames_segmented", "frames_encoded",
                 "memories_stored", "feature_cache_misses", "reads"):
        assert f"\n{name} " in out, name
    assert TRACE.counts["models.build"] == 1
