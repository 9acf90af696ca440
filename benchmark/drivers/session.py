"""The session driver: one annotator, closed loop, on a pool of videos.

Each visit opens the next video of the pool (``interactions.eval.initialize``:
``prepare_video`` from uint8, ``precompute_features``, ``init_state``) and
makes up to ``per_video`` interactions (``Session.interact``) with the
ground-truth mask, at frames in a seeded random order of frames not yet
interacted (``first``: frame 0 first, as every policy's first round, or a
random frame; the orders are the same for every seed).  The visit ends
when its interactions or its frames run out; the pool is cycled.  There is no evaluation of the masks: a deployment has
no ground truth.

Traffic parameters (``traffic/<mix>.json``): ``videos.lengths`` (the pool's
frame counts, in order; the same for every seed, so that every seed does
the same work), ``interactions.per_video``, ``interactions.first``
(``zero`` or ``random``), ``warmup.lengths`` (short videos at the frame size
whose opens and interactions warm every shape the traffic uses), and
``check`` (``visits``: how many visits the reference replays, the first
visit, which holds the longest request, and others drawn from the seed
among the first ``among_first``).
"""

from __future__ import annotations

import contextlib
import statistics
import time

import numpy as np

from benchmark.core import program, schedule
from benchmark.core.gaps import FrameMedians, Gaps, logit, unpad
from benchmark.core.harness import strict_fp32
from benchmark.core.seeds import rng
from benchmark.core.video import synthetic_video, video_pool


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between closest ranks (numpy's
    default)."""
    v = sorted(values)
    r = (len(v) - 1) * q / 100
    lo = int(r)
    return v[lo] + (v[min(lo + 1, len(v) - 1)] - v[lo]) * (r - lo)


class Run:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.tr = ctx.cell.config, ctx.cell.traffic
        self.ref = ctx.cell.reference()
        self.visits = 0          # visits opened
        self.session = None
        self.todo = []           # (frame, plan) left in this visit
        self.interacts = []      # (seconds, plan) of counted interactions
        self.opens = []          # (seconds, frames) of counted opens
        self.encode = [0.0, 0]   # traced seconds and frames of precompute
        self.reads = []          # read shapes in the traced slice
        self.snaps = {}          # visit -> [(frame, plan, host tensor)]
        self.keys = {}           # visit -> the program's key features

    # ------------------------------------------------------------ set-up
    def setup(self):
        ctx, cfg, tr = self.ctx, self.cfg, self.tr
        h, w = cfg["frame"]
        self.pool = video_pool(tr["videos"]["lengths"], h, w,
                               rng(ctx.seed, "videos"))
        self.models = program.build(cfg, self.ref, ctx.seed, ctx.device,
                                    ctx.precision)
        self.engine = self.models["engine"]
        if ctx.plant:
            ctx.plant(self.models)
        self.mem_freq = self.engine.config.mem_freq
        first = tr["check"]["among_first"]
        others = rng(ctx.seed, "check").permutation(np.arange(1, first))
        self.checked = {0, *others[:tr["check"]["visits"] - 1].tolist()}
        self._host_buffers()
        self._warmup()
        if ctx.trace:
            self._count_work()
            self._time_precompute()

    def _frames(self, visit: int, t: int) -> list:
        """The frames visit ``visit`` of a ``t``-frame video interacts.  The
        same for every seed, so that every seed does the same work (the
        same spans, blocks, stores and fusions); the seed changes the
        videos and the weights."""
        g = rng(0, f"order.{visit}")
        n = min(self.tr["interactions"]["per_video"], t)
        if self.tr["interactions"]["first"] == "zero":
            return [0] + (1 + g.permutation(t - 1))[:n - 1].tolist()
        return g.permutation(t)[:n].tolist()

    def _host_buffers(self):
        """One host buffer a checked visit, pinned on the card, as large as
        the frames its interactions write: the window copies each
        interaction's probabilities there without waiting."""
        torch = self.ctx.torch
        nh, nw = (-(-d // 16) * 16 for d in self.cfg["frame"])
        self.buffers = {}
        for v in sorted(self.checked):
            t = self.pool[v % len(self.pool)][1].shape[0]
            order = self._frames(v, t)
            n = sum(p.hi - p.lo for p in schedule.plan_session(t, order, self.mem_freq))
            self.buffers[v] = [torch.empty((n, nh, nw), pin_memory=self.ctx.cuda), 0]

    def _warmup(self):
        """Open short videos at the frame size and interact as the traffic
        does: blocked and single-frame steps, fusion, memory stores, and
        every batch of the feature encoder (``feature_chunk`` frames and
        each remainder)."""
        from eva_vos_tpu_torch.interactions import VideoSample, initialize

        h, w = self.cfg["frame"]
        g = rng(self.ctx.seed, "warmup")
        for i, t in enumerate(self.tr["warmup"]["lengths"]):
            frames, masks = synthetic_video(t, h, w, g)
            s = initialize(self.engine, VideoSample(f"warmup-{i}", frames, masks))
            for f in self._frames(-1 - i, t)[:3]:
                s.interact(s.gt_mask(f), f)
        self.ctx.sync()

    def _count_work(self):
        """Operations of each unit of work, from the reference's modules
        on the meta device."""
        from torch.utils.flop_counter import FlopCounterMode

        self.unit_flops = {}
        for name, fn in self.ref.work_units(self.cfg).items():
            with FlopCounterMode(display=False) as fc:
                fn()
            self.unit_flops[name] = fc.get_total_flops()

    # ------------------------------------------------------------ steps
    def step(self, counted: bool):
        from eva_vos_tpu_torch.interactions import VideoSample, initialize

        torch = self.ctx.torch
        if not self.todo:
            v = self.visits
            name, frames, masks = self.pool[v % len(self.pool)]
            t = frames.shape[0]
            order = self._frames(v, t)
            self.todo = list(zip(order, schedule.plan_session(
                t, order, self.mem_freq)))
            self.visit, self.visits = v, v + 1
            self.session = None
            t0 = time.perf_counter()
            with torch.profiler.record_function("session.open"):
                self.session = initialize(self.engine,
                                          VideoSample(name, frames, masks))
                self.ctx.sync()
            if counted:
                self.opens.append((time.perf_counter() - t0, t))
                if v in self.checked:
                    self.keys[v] = self.session.feats.k16.to("cpu", copy=True)
            return
        f, plan = self.todo.pop(0)
        s = self.session
        mask = s.gt_mask(f)
        t0 = time.perf_counter()
        with torch.profiler.record_function("session.interact"):
            s.interact(mask, f)
        dt = time.perf_counter() - t0
        if not counted:
            return
        self.interacts.append((dt, plan))
        if self.visit in self.checked:
            buf = self.buffers[self.visit]
            snap = buf[0][buf[1]:buf[1] + plan.hi - plan.lo]
            buf[1] += plan.hi - plan.lo
            snap.copy_(s.state.prob[1, plan.lo:plan.hi], non_blocking=True)
            self.snaps.setdefault(self.visit, []).append((f, plan, snap))

    def _time_precompute(self):
        """With ``--trace 1``, each ``precompute_features`` of the window and
        the slice timed to a synchronise (the open syncs after it anyway)."""
        eng, pre = self.engine, self.engine.precompute_features

        def timed_precompute(images):
            t0 = time.perf_counter()
            out = pre(images)
            self.ctx.sync()
            self.encode[0] += time.perf_counter() - t0
            self.encode[1] += images.shape[0]
            return out

        eng.precompute_features = timed_precompute

    @contextlib.contextmanager
    def tracing(self):
        """The traced slice: each memory read marked ``memory_read`` with
        its shape."""
        import eva_vos_tpu_torch.engine.propagation as prop

        torch = self.ctx.torch
        read = prop.memory_readout

        def marked_read(mk, qk, mv, top_k=50, valid_tokens=None, **kw):
            self.reads.append((qk.shape[0], int(valid_tokens), top_k,
                               mk.shape[1], mv.shape[0], mv.shape[2],
                               mk.element_size()))
            with torch.profiler.record_function("memory_read"):
                return read(mk, qk, mv, top_k, valid_tokens, **kw)

        prop.memory_readout = marked_read
        try:
            yield
        finally:
            prop.memory_readout = read

    # ------------------------------------------------------------ results
    def end_to_end(self, window_s: float, peak: int) -> dict:
        frames = sum(p.frames for _, p in self.interacts)
        out = {"frames_per_s": frames / window_s, "peak_mem_gib": peak / 2 ** 30}
        if self.interacts:
            out["interact_p95_ms"] = percentile(
                [dt for dt, _ in self.interacts], 95) * 1e3
        return out

    def readings(self) -> dict:
        out = {"interactions": len(self.interacts),
               "frames": sum(p.frames for _, p in self.interacts),
               "opens": len(self.opens),
               "encode_s": self.encode[0], "encode_frames": self.encode[1],
               "reads": self.reads}
        if self.interacts:
            out["interact_median_ms"] = statistics.median(
                dt for dt, _ in self.interacts) * 1e3
        if self.ctx.trace:
            out["flops"] = self._window_flops()
        return out

    def _window_flops(self) -> float:
        u = self.unit_flops
        n = self.cfg["networks"]
        h, w = self.cfg["frame"]
        tokens = (-(-h // 16)) * (-(-w // 16))
        total = sum(t for _, t in self.opens) * u["encode"]
        for _, p in self.interacts:
            total += (p.frames * u["decode"] + p.stores * u["value"]
                      + p.fused * u["fuse"])
            total += sum(self.ref.read_flops(b * tokens, m, tokens,
                                             self.engine.config.top_k,
                                             n["keydim"], n["value_dim"])
                         for b, m in p.reads)
        return total

    def attempts(self) -> tuple:
        return len(self.interacts), 0

    def release(self):
        """Free the program's state before the reference runs."""
        from eva_vos_tpu_torch.interactions import eval as session_mod

        self.session = self.engine = self.models = None
        session_mod._FEATURE_CACHE.clear()
        session_mod.LAST_SESSION = None
        if self.ctx.cuda:
            self.ctx.torch.cuda.empty_cache()

    def check(self) -> dict:
        """Replay each checked visit on the reference, in float32 with
        TF32 off, and compare the program's outputs with it: ``key_gap``,
        the key features' mean gap over the reference's mean magnitude;
        and, over every interaction's written frames, the gaps of the first
        object's logits (probabilities clamped to [1e-6, 1 - 1e-6]) at the
        pixels where the reference's probability lies within (1e-3,
        1 - 1e-3), where the logit carries what the sigmoid saturates away:
        ``logit_median_gap``, their median, which the tokens swapped at
        the top-k's near-ties do not move, and ``frame_logit_gap``, the
        largest over frames of a frame's median, which a frame gone wrong
        does.  The means of the logit and probability gaps, which those
        swaps and saturated frames swing from seed to seed, are kept for
        the record beside the quantiles in ``info``."""
        torch, ctx = self.ctx.torch, self.ctx
        h, w = self.cfg["frame"]
        sds = program.state_dicts(self.cfg, self.ref, ctx.seed, ctx.device,
                                  {n: torch.float32 for n in self.cfg["weights"]})
        probs, keys, logits, frames_ = Gaps(), Gaps(), Gaps(), FrameMedians()
        with strict_fp32(torch):
            ref = self.ref.Reference(self.cfg, sds, ctx.device)
            for visit, snaps in sorted(self.snaps.items()):
                name, frames, masks = self.pool[visit % len(self.pool)]
                rs = ref.open(frames)
                if visit in self.keys:
                    keys.add(self.keys[visit].to(ctx.device),
                             rs.k16.flatten(2).transpose(1, 2))
                for f, plan, snap in snaps:
                    rs.interact(masks[:, f].astype(np.float32), f)
                    got = unpad(snap.to(ctx.device), h, w)
                    want = rs.foreground(plan.lo, plan.hi)
                    probs.add(got, want)
                    live = (want > 1e-3) & (want < 1 - 1e-3)
                    if live.any():
                        logits.add(logit(got[live]), logit(want[live]))
                    frames_.add(logit(got), logit(want), live)
                del rs
        self.info = {"prob": probs.info(), "keys": keys.info(),
                     "logit": logits.info(), "frames": frames_.info()}
        if not probs.n:
            return {}
        return {"key_gap": keys.relative, "prob_mean_gap": probs.mean,
                "logit_gap": logits.mean if logits.n else 0.0,
                "logit_median_gap": logits.quantile(0.5) if logits.n else 0.0,
                "frame_logit_gap": frames_.worst()}
