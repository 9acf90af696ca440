"""The policy driver: the experiment CLI's policy loop, closed loop, on a
pool of videos.

Each visit calls the policy on the next video of the pool as the CLI's
``dispatch`` calls it (``eval_annotation_method.py``), at the CLI's flags
that the configuration names (``cli``): for ``eva_vos``,
``eva_vos(qnet_extract, rl_agent.act_fn(), rounds, engine, sample,
annotator, eval_metric=...)``.  A round is an annotation (SAM's encoder, the
agent, SAM's decoder and the click robot, or the ground truth), one
``interact``, the evaluation of every frame and the next frame's choice
(QNet).  The window closes at a round's start: the harness's own wrapper
around the annotator raises there, so that every round counted ended inside
the window.

Traffic parameters (``traffic/<mix>.json``): ``videos.lengths`` (the pool,
in order, the same for every seed), ``warmup`` (``lengths``: short videos
run through the policy, ``rounds`` each; every pool length's batch is also
run once through QNet), and ``check``: of the first visit's SAM decodes the
reference recomputes the first and each with probability ``decode_share``
drawn from the seed, up to ``decodes``.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

from benchmark.core import program, schedule
from benchmark.core.gaps import Gaps, logit, unpad
from benchmark.core.harness import strict_fp32
from benchmark.core.seeds import rng
from benchmark.core.video import synthetic_video, video_pool

SPANS = ("annotate", "propagate", "eval", "choice")
AUTOCAST = "bf16-autocast"


class StopWindow(Exception):
    """The window closed: raised at the start of a round."""


class Run:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.tr = ctx.cell.config, ctx.cell.traffic
        self.ref = ctx.cell.reference()
        self.deadline = float("inf")
        self.visits = 0
        self.capture = False        # recording the checked visit
        self.counted = False
        self.rounds = 0             # counted rounds
        self.round_open = False     # an interact since the last round start
        self.spans = dict.fromkeys(SPANS, 0.0)
        self.work = {"open_frames": 0, "plans": [], "sam_encode": 0,
                     "sam_decode": 0, "qnet_frames": 0, "agent": 0}
        self.log = []               # the checked visit's events, in order
        self.decode_rng = rng(ctx.seed, "check")  # which SAM decodes are checked
        self.picked = 0

    # ------------------------------------------------------------ set-up
    def setup(self):
        ctx, cfg, tr = self.ctx, self.cfg, self.tr
        from eva_vos_tpu_torch.cli.eval_annotation_method import build_parser

        h, w = cfg["frame"]
        self.pool = video_pool(tr["videos"]["lengths"], h, w, rng(ctx.seed, "videos"))
        # the control: the program's bf16 path, or the program run under
        # torch.autocast to bf16 (its SAM has no working bf16 path)
        self.autocast = ctx.precision == AUTOCAST
        precision = None if self.autocast else ctx.precision
        self.args = build_parser().parse_args(
            list(cfg["cli"]) + ["--allow-random", "--device", ctx.device]
            + (["--dtype", precision] if precision else []))
        self.models = program.build(cfg, self.ref, ctx.seed, ctx.device, precision)
        if ctx.plant:
            ctx.plant(self.models)
        self.engine = self.models["engine"]
        self.mem_freq = self.engine.config.mem_freq
        self._wrap()
        self._warmup()
        if ctx.trace:
            from torch.utils.flop_counter import FlopCounterMode

            self.unit_flops = {}
            for name, fn in self.ref.work_units(cfg).items():
                with FlopCounterMode(display=False) as fc:
                    fn()
                self.unit_flops[name] = fc.get_total_flops()

    def _warmup(self):
        """The policy on short videos at the frame size, and QNet on every
        pool length's batch."""
        torch = self.ctx.torch
        from eva_vos_tpu_torch.interactions import VideoSample

        h, w = self.cfg["frame"]
        g = rng(self.ctx.seed, "warmup")
        rounds = self.args.rounds
        self.args.rounds = self.tr["warmup"]["rounds"]
        for i, t in enumerate(self.tr["warmup"]["lengths"]):
            frames, masks = synthetic_video(t, h, w, g)
            self._dispatch(VideoSample(f"warmup-{i}", frames, masks))
        self.args.rounds = rounds
        for t in sorted(set(self.tr["videos"]["lengths"])):
            x = torch.zeros((t, 224, 224, 3), device=self.ctx.device)
            self.qnet_extract(x, x)
        self.ctx.sync()

    def _dispatch(self, sample):
        from eva_vos_tpu_torch.cli.eval_annotation_method import dispatch

        torch = self.ctx.torch
        models = dict(self.models, qnet_extract=self.qnet_extract)
        self.interacted, self.round_open = [], False
        lower = (torch.autocast(torch.device(self.ctx.device).type, torch.bfloat16)
                 if self.autocast else contextlib.nullcontext())
        with lower:
            return dispatch(self.args, models, sample, np.random.default_rng(
                rng(self.ctx.seed, "policy").integers(2 ** 62)))

    # ------------------------------------------------------------ wrappers
    def _wrap(self):
        """The harness's wrappers, as attributes of the program's own
        objects: the round's start (the window's close, and the count), the
        engine's interact, and, on the checked visit, SAM, QNet and the
        agent's inputs and outputs."""
        torch = self.ctx.torch
        eng, ann = self.engine, self.models["annotator"]
        pred = ann.sam.predictor
        agent = self.models["rl_agent"].net
        interact, set_img = eng.interact, ann.set_image_to_sam
        set_image, decode = pred.set_image, pred._decode
        extract, net_fwd = self.models["qnet_extract"], agent.forward
        self.interacted = []

        def round_start(im, cache_key=None):
            if self.round_open:
                self.round_open = False
                if time.perf_counter() >= self.deadline:
                    raise StopWindow
            return set_img(im, cache_key=cache_key)

        def on_interact(state, feats, mask, idx, donate=False):
            plan = schedule.plan(feats.k16.shape[0], self.interacted, idx, self.mem_freq)
            out = interact(state, feats, mask, idx, donate=donate)
            self.interacted.append(idx)
            self.round_open = True
            if self.counted:
                self.rounds += 1
                self.work["plans"].append(plan)
            if self.capture:
                from eva_vos_tpu_torch.interactions import eval as session_mod

                s = session_mod.LAST_SESSION
                if len(self.interacted) == 1:
                    self.log.append(("keys", s.feats.k16.to("cpu", copy=True)))
                self.log.append(("interact", idx, plan, mask[0].to("cpu", copy=True),
                                 out.prob[1, plan.lo:plan.hi].to("cpu", copy=True)))
            return out

        def on_set_image(image):
            set_image(image)
            if self.counted:
                self.work["sam_encode"] += 1
            if self.capture:
                self.log.append(("embed", self.last_frame, image.copy(),
                                 pred.features.to("cpu", copy=True)))
                self.embeds[id(pred.features)] = len(self.log) - 1

        def on_decode(coords, labels, mask_input):
            out = decode(coords, labels, mask_input)
            if self.counted:
                self.work["sam_decode"] += 1
            if self.capture:
                k = self.decodes
                self.decodes += 1
                if self._pick(k):
                    mi = None if mask_input is None else torch.as_tensor(
                        mask_input).to("cpu", copy=True)
                    self.log.append(("decode", self.embeds.get(id(pred.features)),
                                     np.array(coords), np.array(labels), mi,
                                     out[0].to("cpu", copy=True),
                                     out[1].to("cpu", copy=True)))
            return out

        def on_extract(imgs, masks):
            out = extract(imgs, masks)
            if self.counted:
                self.work["qnet_frames"] += imgs.shape[0]
            if self.capture:
                self.log.append(("qnet", masks[..., 0].bool().to("cpu", copy=True),
                                 out.to("cpu", copy=True)))
            return out

        def on_agent(x_img, x_mask, x_cost=None):
            logits, value = net_fwd(x_img, x_mask, x_cost)
            if self.counted:
                self.work["agent"] += 1
            if self.capture:
                self.log.append(("agent", x_img.to("cpu", copy=True),
                                 x_mask[..., 0].bool().to("cpu", copy=True),
                                 logits.to("cpu", copy=True), value.to("cpu", copy=True)))
            return logits, value

        def frame_of(im, cache_key=None):
            self.last_frame = cache_key
            return round_start(im, cache_key=cache_key)

        eng.interact = on_interact
        ann.set_image_to_sam = frame_of
        pred.set_image = on_set_image
        pred._decode = on_decode
        self.qnet_extract = on_extract
        agent.forward = on_agent

    def _pick(self, k: int) -> bool:
        """Whether the checked visit's ``k``-th SAM decode is compared: the
        first, then each with probability ``check.decode_share`` drawn
        from the seed, up to ``check.decodes``."""
        chk = self.tr["check"]
        take = k == 0 or self.decode_rng.random() < chk["decode_share"]
        take = take and self.picked < chk["decodes"]
        self.picked += take
        return take

    # ------------------------------------------------------------ steps
    def step(self, counted: bool):
        from eva_vos_tpu_torch.interactions import VideoSample
        from eva_vos_tpu_torch.interactions import eval as session_mod

        v = self.visits
        self.visits += 1
        name, frames, masks = self.pool[v % len(self.pool)]
        self.counted = counted
        self.capture = counted and v == 0
        self.embeds, self.decodes, self.last_frame = {}, 0, None
        if counted:
            self.work["open_frames"] += frames.shape[0]
        torch = self.ctx.torch
        try:
            with torch.profiler.record_function("policy.visit"):
                self._dispatch(VideoSample(name, frames, masks))
        except StopWindow:
            pass
        finally:
            s = session_mod.LAST_SESSION
            if counted and s is not None:
                for k in SPANS:
                    key = f"eval[{self.args.metric}]" if k == "eval" else k
                    self.spans[k] += s.timers.totals.get(key, 0.0)
            self.capture = self.counted = False

    @contextlib.contextmanager
    def tracing(self):
        yield

    # ------------------------------------------------------------ results
    def end_to_end(self, window_s: float, peak: int) -> dict:
        return {"rounds_per_s": self.rounds / window_s, "peak_mem_gib": peak / 2 ** 30}

    def readings(self) -> dict:
        out = {"rounds": self.rounds}
        if self.rounds:
            out.update({f"round_{k}_ms": self.spans[k] / self.rounds * 1e3
                        for k in SPANS})
        if self.ctx.trace:
            out["flops"] = self._window_flops()
        return out

    def _window_flops(self) -> float:
        u, n = self.unit_flops, self.cfg["networks"]
        h, w = self.cfg["frame"]
        tokens = (-(-h // 16)) * (-(-w // 16))
        wk = self.work
        total = (wk["open_frames"] * u["encode"] + wk["sam_encode"] * u["sam_encode"]
                 + wk["sam_decode"] * u["sam_decode"] + wk["qnet_frames"] * u["qnet"]
                 + wk["agent"] * u["agent"])
        for p in wk["plans"]:
            total += p.frames * u["decode"] + p.stores * u["value"] + p.fused * u["fuse"]
            total += sum(self.ref.read_flops(b * tokens, m, tokens,
                                             self.engine.config.top_k,
                                             n["keydim"], n["value_dim"])
                         for b, m in p.reads)
        return total

    def attempts(self) -> tuple:
        return self.rounds, 0

    def release(self):
        from eva_vos_tpu_torch.interactions import eval as session_mod

        self.engine = self.models = None
        session_mod._FEATURE_CACHE.clear()
        session_mod.LAST_SESSION = None
        if self.ctx.cuda:
            self.ctx.torch.cuda.empty_cache()

    def check(self) -> dict:
        """Follow the checked visit on the reference, in float32 with TF32
        off: its interactions from the program's masks (the ground truth
        or SAM's), comparing every interaction's written frames; SAM's
        embedding of each image the annotator set (worked out again from
        the raw frame) and the sampled decodes (the program's prompts and
        mask inputs, on the reference's embedding); QNet's features of each
        choice (the frames worked out again) and the agent's logits and
        value of each decision, on the program's own inputs to them (its masks and SAM's embedding, each
        checked above)."""
        torch, ctx = self.ctx.torch, self.ctx
        dev = ctx.device
        h, w = self.cfg["frame"]
        sds = program.state_dicts(self.cfg, self.ref, ctx.seed, dev,
                                  {n: torch.float32 for n in self.cfg["weights"]})
        g = {k: Gaps() for k in ("prob", "logit", "keys", "sam_embed", "sam_mask",
                                 "sam_iou", "qnet", "agent_logits", "agent_value")}
        name, frames, masks = self.pool[0]
        with strict_fp32(torch):
            R = self.ref.Reference(self.cfg, sds, dev)
            rs = R.open(frames)
            f224 = self.ref.frames_224(frames, dev)
            embeds, done = {}, 0
            for i, ev in enumerate(self.log):
                kind = ev[0]
                if kind == "keys":
                    g["keys"].add(ev[1].to(dev), rs.k16.flatten(2).transpose(1, 2))
                elif kind == "interact":
                    _, idx, plan, mask, snap = ev
                    rs.interact(unpad(mask, h, w).numpy()[None], idx)
                    got = unpad(snap.to(dev), h, w)
                    want = rs.foreground(plan.lo, plan.hi)
                    g["prob"].add(got, want)
                    live = (want > 1e-3) & (want < 1 - 1e-3)
                    if live.any():
                        g["logit"].add(logit(got[live]), logit(want[live]))
                    done += 1
                elif kind == "embed":
                    _, frame, image, feats = ev
                    if not np.array_equal(image, self.ref.annotator_image(frames[frame])):
                        raise AssertionError(f"SAM was given another image of frame {frame}")
                    ref_emb = embeds[i] = R.sam.embed(image)
                    g["sam_embed"].add(feats.to(dev), ref_emb)
                elif kind == "decode":
                    _, at, coords, labels, mi, got_m, got_iou = ev
                    if at not in embeds:
                        continue
                    ref_m, ref_iou = R.sam.decode(embeds[at], coords, labels, mi)
                    g["sam_mask"].add(got_m.to(dev), ref_m)
                    g["sam_iou"].add(got_iou.to(dev), ref_iou)
                elif kind == "qnet":
                    _, m, feats = ev
                    m224 = m.to(dev).float()[..., None].expand(*m.shape, 3)
                    g["qnet"].add(feats.to(dev), R.qnet.features(f224, m224))
                else:
                    _, x_img, m, logits, value = ev
                    m224 = m.to(dev).float()[..., None].expand(*m.shape, 3)
                    lr, vr = R.agent(x_img.to(dev), m224)
                    g["agent_logits"].add(logits.to(dev), lr)
                    g["agent_value"].add(value.to(dev), vr)
        self.info = {k: v.info() for k, v in g.items()}
        if not done:
            return {}
        return {"key_gap": g["keys"].relative,
                "prob_mean_gap": g["prob"].mean,
                "logit_gap": g["logit"].mean if g["logit"].n else 0.0,
                "sam_embed_gap": g["sam_embed"].relative if g["sam_embed"].n else 0.0,
                "sam_mask_gap": g["sam_mask"].relative if g["sam_mask"].n else 0.0,
                "qnet_gap": g["qnet"].relative if g["qnet"].n else 0.0,
                "agent_gap": max(g["agent_logits"].worst, g["agent_value"].worst)}
