"""The traffic's schedules and frame counts, per seed, and the harness's
reckoning of an interaction's work against what the port's engine does."""

import numpy as np
import pytest

from benchmark.core import schedule
from benchmark.core.seeds import derive, rng
from benchmark.core.spec import BENCH, read_json
from benchmark.core.video import video_pool
from benchmark.tests._tiny import tiny_cell

SEEDS = (0, 7, 2 ** 31 + 17, -5)


class _Ctx:
    def __init__(self, cell, seed):
        self.cell, self.seed = cell, seed


def _run(name, seed):
    cell = tiny_cell(name)
    return cell.driver().Run(_Ctx(cell, seed)), cell


def test_seeds_take_any_whole_number():
    for s in SEEDS:
        assert 0 <= derive(s, "videos") < 2 ** 63
    assert derive(1, "a") != derive(1, "b") != derive(2, "a")
    assert derive(2 ** 31 + 3, "x") == derive(2 ** 31 + 3, "x")


@pytest.mark.parametrize("mix", ["session60", "first-mask", "eva-vos60"])
def test_every_seed_gets_the_same_pool_sizes(mix):
    lengths = read_json(BENCH / "traffic" / f"{mix}.json")["videos"]["lengths"]
    assert all(50 <= t <= 90 for t in lengths)
    pools = [video_pool(lengths[:2], 32, 48, rng(s, "videos")) for s in SEEDS[:2]]
    for a, b in zip(*pools):
        assert a[1].shape == b[1].shape and a[1].dtype == np.uint8
        assert a[2].shape == (1, *a[1].shape[:3])
        assert not np.array_equal(a[1], b[1])
    again = video_pool(lengths[:2], 32, 48, rng(SEEDS[0], "videos"))
    assert all(np.array_equal(x[1], y[1]) for x, y in zip(pools[0], again))


@pytest.mark.parametrize("seed", SEEDS)
def test_session60_orders(seed):
    run, cell = _run("stcn-480p.session60", seed)
    per = read_json(BENCH / "traffic" / "session60.json")["interactions"]["per_video"]
    run.tr["interactions"]["per_video"] = per
    for visit, t in enumerate((90, 54, 50)):
        order = run._frames(visit, t)
        assert order[0] == 0 and len(set(order)) == len(order) == min(per, t)
        assert all(0 <= f < t for f in order)
        assert order == run._frames(visit, t)
        plans = schedule.plan_session(t, order, 5)
        # the first pass segments every other frame; the session writes
        # each frame at least once
        assert plans[0].frames == t - 1 and plans[0].fused == 0
        assert sum(p.stores for p in plans) >= len(order)
    assert run._frames(0, 90) != run._frames(1, 90)
    # every seed interacts at the same frames: the same work
    other, _ = _run("stcn-480p.session60", seed + 1)
    other.tr["interactions"]["per_video"] = per
    assert other._frames(2, 76) == run._frames(2, 76)


@pytest.mark.parametrize("seed", SEEDS)
def test_first_mask_orders(seed):
    run, _ = _run("stcn-480p.first-mask", seed)
    for visit, t in enumerate((90, 54, 76)):
        (f,) = run._frames(visit, t)
        p = schedule.plan(t, [], f, 5)
        assert p.frames == t - 1 and p.fused == 0 and (p.lo, p.hi) == (0, t)
        assert p.stores == 1 + sum(q.stores for q in p.passes)


def test_eva_decode_sample_per_seed(monkeypatch):
    """The check's sample of SAM decodes comes from the seed: the first,
    then a share, up to a cap."""
    from benchmark.tests._tiny import tiny_eva_cell

    cell = tiny_eva_cell(monkeypatch)
    chk = cell.traffic["check"]
    picks = []
    for s in (SEEDS[0], SEEDS[0], SEEDS[1]):
        run = cell.driver().Run(_Ctx(cell, s))
        picks.append([k for k in range(400) if run._pick(k)])
    assert picks[0] == picks[1] != picks[2]
    for p in picks:
        assert p[0] == 0 and len(p) == chk["decodes"]
        assert 0.1 < chk["decodes"] / p[-1] / chk["decode_share"] < 10


def test_plan_counts():
    p = schedule.plan_session(12, [0, 6, 3], 5)
    assert [x.frames for x in p] == [11, 10, 4]
    assert [x.fused for x in p] == [0, 5, 4]
    assert [x.stores for x in p] == [3, 1, 1]
    assert p[0].reads == ((5, 1), (5, 2), (1, 3))
    assert [(x.lo, x.hi) for x in p] == [(0, 12), (1, 12), (1, 6)]


def test_schedule_matches_the_engine():
    """The harness's counts of segmented, fused and stored frames and of
    each read's bank against the port's engine, counted where it does the
    work (CPU, small frames)."""
    from benchmark.core import program

    cell = tiny_cell()
    cfg = cell.config
    models = program.build(cfg, cell.reference(), 3, "cpu")
    eng = models["engine"]
    seen = {"frames": 0, "stores": 0, "fused": 0, "reads": []}
    seg, store, fuse = eng._segment_frames, eng._store, eng._fuse_frame

    def count_seg(feats, bank_k, bank_v, front, tis):
        seen["frames"] += len(tis)
        seen["reads"].append((len(tis), front))
        return seg(feats, bank_k, bank_v, front, tis)

    def count_store(*a):
        seen["stores"] += 1
        return store(*a)

    def count_fuse(*a):
        seen["fused"] += 1
        return fuse(*a)

    eng._segment_frames, eng._store, eng._fuse_frame = count_seg, count_store, count_fuse
    from eva_vos_tpu_torch.interactions import VideoSample, initialize
    from benchmark.core.video import synthetic_video

    frames, masks = synthetic_video(23, 32, 48, rng(0, "v"))
    s = initialize(eng, VideoSample("v", frames, masks))
    order = [0, 17, 6, 11, 22, 3]
    for f, plan in zip(order, schedule.plan_session(23, order, eng.config.mem_freq)):
        before = dict(seen, reads=list(seen["reads"]))
        s.interact(s.gt_mask(f), f)
        assert seen["frames"] - before["frames"] == plan.frames
        assert seen["stores"] - before["stores"] == plan.stores
        assert seen["fused"] - before["fused"] == plan.fused
        assert seen["reads"][len(before["reads"]):] == list(plan.reads)
