"""What the device click robot costs in SAM's warm start on the GPU.

    python3 scripts/torch_port_robot_profile.py   # from the repo root, one GPU

Builds SAM vit_h with seeded random weights on the card, as
``chip_smoke.py`` does, and runs ``warmstart_select`` on frames of the
synthetic 480x854 video (seed 0) against their ground-truth masks, keeping
every (pred, gt) pair that its click robot meets.  On those pairs it times
(median ms a call, the card synchronised):

* ``ops.components.click_robot_interact`` (the packed Hillis-Steele scans)
  with the fixpoint read every 1, 2 and 4 steps, its propagation steps
  counted;
* a variant whose run minima come from run ids and one ``scatter_reduce``
  ("amin") a direction instead of the doubling scans (the same labels at
  every step), at the same three read intervals; every variant's click is
  checked equal;
* the scipy robot on the host (``annotator.robots.ClickRobot.interact``,
  the masks already on the host, as in the host warm-start loop).

It also times a decode + select (``predict_select``'s device work) for the
share of a warm-start step.  Results go to
``chiprun_out/torch_port_robot_profile.json``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DEVICE = "cuda"
SAM_PRESET = "vit_h"
VIDEO = dict(t=60, h=480, w=854)
FRAMES = (0, 20, 40, 59)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def run_min_collapse(torch, lab, mask, dim):
    """The minimum of ``lab`` over each mask-contiguous run along ``dim``
    (on mask pixels), by run ids and one scatter."""
    from eva_vos_tpu_torch.ops.components import INF32

    m = mask.movedim(dim, -1).contiguous()
    lm = lab.movedim(dim, -1).contiguous()
    prev = torch.cat([torch.zeros_like(m[..., :1]), m[..., :-1]], dim=-1)
    rid = torch.cumsum((m & ~prev).reshape(-1), 0)
    vals = torch.where(m, lm, INF32).reshape(-1)
    mins = torch.full((rid.numel() + 1,), INF32, dtype=lab.dtype,
                      device=lab.device).scatter_reduce_(0, rid, vals, "amin")
    out = torch.where(m, mins[rid].reshape(m.shape), lm)
    return out.movedim(-1, dim)


def main() -> int:
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from eva_vos_tpu_torch.annotator.robots import ClickRobot
    from eva_vos_tpu_torch.data import synthetic_video
    from eva_vos_tpu_torch.models.sam import SamPredictor, build_sam
    from eva_vos_tpu_torch.models.sam import predictor as P
    from eva_vos_tpu_torch.ops import components as C

    if DEVICE == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    images, masks = synthetic_video(VIDEO["t"], VIDEO["h"], VIDEO["w"],
                                    num_objects=1, seed=0)
    predictor = SamPredictor(build_sam(SAM_PRESET, seed=0, device=DEVICE))

    pairs, robot = [], P.click_robot_interact

    def recorded(pred, gt):
        pairs.append((pred.clone(), gt))
        return robot(pred, gt)

    P.click_robot_interact = recorded
    try:
        for f in FRAMES:
            predictor.set_image((images[f] * 255).astype(np.uint8))
            predictor.warmstart_select(masks[0, f].astype(bool))
    finally:
        P.click_robot_interact = robot

    def timed(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out)

    steps = []
    propagate, collapse = C._propagate_once, C._run_collapse

    def stepped(every):
        """``every`` counted propagation steps between two fixpoint reads."""
        def step(lab, mask):
            for _ in range(every):
                steps[-1] += 1
                lab = propagate(lab, mask)
            return lab
        return step

    def scatter(lab, mask, dim):
        return run_min_collapse(torch, lab, mask, dim)

    variants = {f"{name}_every{every}": (fn, every)
                for name, fn in (("scan", collapse), ("scatter", scatter))
                for every in (1, 2, 4)}
    rows, ms = [], {name: [] for name in variants}
    ms["scipy"] = []
    for pred, gt in pairs:
        row = dict(fp=int((pred & ~gt).sum()), fn=int((~pred & gt).sum()))
        want = None
        for name, (fn, every) in variants.items():
            C._run_collapse, C._propagate_once = fn, stepped(every)
            steps.append(0)
            try:
                got = torch.stack(C.click_robot_interact(pred, gt)).tolist()
                row[f"{name}_steps"] = steps[-1]
                want = want or got
                if got != want:
                    print(f"{name} differs: {got} != {want}",
                          file=sys.stderr)
                    return 1
                row[name] = timed(lambda: C.click_robot_interact(pred, gt))
            finally:
                C._run_collapse, C._propagate_once = collapse, propagate
            ms[name].append(row[name])
        hp, hg = pred.cpu().numpy(), gt.cpu().numpy()
        row["scipy"] = timed(lambda: ClickRobot().interact(hp, hg))
        ms["scipy"].append(row["scipy"])
        rows.append(row)

    gt0 = masks[0, FRAMES[-1]].astype(bool)
    click, label = ClickRobot().middle_click(gt0)
    decode_ms = timed(lambda: predictor.predict_select(
        gt0, point_coords=click, point_labels=label), reps=5)
    summary = dict(
        card=card, pairs=len(pairs),
        steps_median={k: statistics.median(r[f"{k}_steps"] for r in rows)
                      for k in variants},
        steps_max={k: max(r[f"{k}_steps"] for r in rows) for k in variants},
        ms_median={k: statistics.median(v) for k, v in ms.items()},
        ms_total={k: sum(v) for k, v in ms.items()},
        predict_select_ms=decode_ms)
    print(json.dumps(summary))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "torch_port_robot_profile.json").write_text(
        json.dumps(dict(summary, rows=rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
