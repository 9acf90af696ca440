"""The port's data layer and utilities against the JAX package's, on the CPU.

The PNG codec (``eva_vos_tpu_torch/data/_png.py``) is held to PIL byte for
byte on L, P and RGB images, both ways: PIL reads the port's files into the
port's pixels, and the port reads PIL's files (all five row filters) into
PIL's.  Trees written by the port's generators (tiny STCNs, the fake SAM,
the CPU) are read by the JAX readers (pandas and PIL) and by the port's
(``csv`` and the codec) into equal items: exactly, arrays and labels alike.
Inputs are numpy from a seed.
"""

import struct
import sys
import zlib

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from eva_vos_tpu.data import datasets as jd
from eva_vos_tpu.utils import config as jconfig
from eva_vos_tpu.utils import logging as jlogging
from eva_vos_tpu.utils import weight_convert as jwc
from eva_vos_tpu_torch.data import datasets as pd_
from eva_vos_tpu_torch.data import synthetic_video
from eva_vos_tpu_torch.data._png import (PNGError, imread_palette,
                                         imread_rgb01, read_png, write_png)
from eva_vos_tpu_torch.utils import checkpoint, config, load_report
from eva_vos_tpu_torch.utils import logging as plogging
from eva_vos_tpu_torch.utils import model_zoo

PALETTE = np.array([[0, 0, 0], [128, 0, 0], [0, 128, 0], [128, 128, 0]],
                   np.uint8)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# PNG codec
# ---------------------------------------------------------------------------

def _images(rng, h=37, w=53):
    yy, xx = np.mgrid[:h, :w]
    rgb = np.stack([xx * 4, yy * 6, xx + yy], -1) + rng.integers(0, 3,
                                                                (h, w, 3))
    return {"L": (xx * 5 % 256).astype(np.uint8),
            "P": rng.integers(0, len(PALETTE), (h, w)).astype(np.uint8),
            "RGB": np.clip(rgb, 0, 255).astype(np.uint8)}


@pytest.mark.parametrize("mode", ["L", "P", "RGB"])
def test_png_written_here_reads_in_pil(mode, rng, tmp_path):
    arr = _images(rng)[mode]
    path = tmp_path / "x.png"
    write_png(path, arr, PALETTE if mode == "P" else None)
    im = Image.open(path)
    assert im.mode == mode
    np.testing.assert_array_equal(np.asarray(im), arr)
    if mode == "P":
        np.testing.assert_array_equal(
            np.asarray(im.getpalette()[:PALETTE.size]).reshape(-1, 3),
            PALETTE)
    pixels, got_mode, palette = read_png(path)
    assert got_mode == mode
    np.testing.assert_array_equal(pixels, arr)


@pytest.mark.parametrize("mode", ["L", "P", "RGB"])
def test_png_written_by_pil_reads_here(mode, rng, tmp_path):
    arr = _images(rng)[mode]
    im = Image.fromarray(arr)
    if mode == "P":
        im = im.convert("P")                    # keeps the values
        im.putpalette(PALETTE.reshape(-1).tolist() + [0] * (768 - PALETTE.size))
    path = tmp_path / "x.png"
    im.save(path)
    pil = Image.open(path)
    pixels, got_mode, palette = read_png(path)
    assert got_mode == mode
    np.testing.assert_array_equal(pixels, np.asarray(pil))
    # the JAX package's two readers
    if mode != "RGB":
        np.testing.assert_array_equal(imread_palette(path),
                                      jd._imread_palette(path))
    np.testing.assert_array_equal(imread_rgb01(path), jd._imread_rgb01(path))


def _filtered_png(path, arr: np.ndarray):
    """An RGB PNG whose rows cycle through the five filter types, encoded
    by the specification's own formulas."""
    h, w, bpp = arr.shape[0], arr.shape[1], 3
    raw = arr.reshape(h, -1).astype(int)
    rows = []
    for y in range(h):
        kind, cur = y % 5, raw[y]
        prev = raw[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, int), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, int), prev[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        rows.append(bytes([kind]) + ((cur - pred) % 256).astype(
            np.uint8).tobytes())

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0,
                                                  0, 0))
                     + chunk(b"IDAT", zlib.compress(b"".join(rows)))
                     + chunk(b"IEND", b""))


def test_png_every_filter_type(rng, tmp_path):
    arr = _images(rng, h=23)["RGB"]
    path = tmp_path / "f.png"
    _filtered_png(path, arr)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), arr)
    np.testing.assert_array_equal(read_png(path)[0], arr)


@pytest.mark.parametrize("mode", ["RGBA", "LA", "I;16", "1"])
def test_png_other_kinds_raise(mode, tmp_path):
    path = tmp_path / "x.png"
    Image.new(mode, (8, 6)).save(path)
    with pytest.raises(PNGError):
        read_png(path)


def test_png_broken_files_raise(rng, tmp_path):
    good = tmp_path / "good.png"
    write_png(good, _images(rng)["L"])
    blob = good.read_bytes()
    for name, data in (("short", blob[:-20]), ("text", b"not a png"),
                       ("crc", blob[:40] + bytes([blob[40] ^ 1]) + blob[41:])):
        (tmp_path / name).write_bytes(data)
        with pytest.raises(OSError):
            read_png(tmp_path / name)
    rgb = tmp_path / "rgb.png"
    write_png(rgb, _images(rng)["RGB"])
    with pytest.raises(PNGError):
        imread_palette(rgb)                     # an RGB image is no mask


# ---------------------------------------------------------------------------
# CSVs, the IoU bins, the utilities
# ---------------------------------------------------------------------------

def test_csv_rows_read_by_pandas_as_written(tmp_path):
    rows = [{"id": "v__1_f3_r2", "frame_num": 3, "frame_cost": 4.5,
             "init_iou": 0.1 + 0.2, "3clicks_iou": 0.7},
            {"id": "v__1_f5_r3", "frame_num": 5, "frame_cost": 80,
             "init_iou": 1 / 3, "mask_iou": 1.0,
             "ious": str([1.0, 0.25, 20])}]
    path = tmp_path / "x.csv"
    pd_.write_csv_rows(path, rows)
    df = pd.read_csv(path, float_precision="round_trip")  # floats exactly
    assert list(df.columns) == ["id", "frame_num", "frame_cost", "init_iou",
                                "3clicks_iou", "mask_iou", "ious"]
    assert df["init_iou"].tolist() == [0.1 + 0.2, 1 / 3]
    assert df["frame_num"].tolist() == [3, 5]
    assert np.isnan(df["mask_iou"][0]) and df["3clicks_iou"][0] == 0.7
    assert pd_.read_csv_rows(path)[1]["ious"] == "[1.0, 0.25, 20]"


@pytest.mark.parametrize("iou", [0.0, 0.04, 0.05, 0.051, 0.5, 0.95, 0.999,
                                 1.0, 1.5, -0.1])
def test_iou_to_label_matches_jax(iou):
    try:
        want = jd.MaskQualityDB.iou_to_label(iou)
    except ValueError:
        with pytest.raises(ValueError):
            pd_.MaskQualityDB.iou_to_label(iou)
        return
    assert pd_.MaskQualityDB.iou_to_label(iou) == want


def test_checkpoint_round_trip_and_jax_loader(tmp_path):
    sd = {"a.weight": torch.arange(6.0).reshape(2, 3),
          "bn.num_batches_tracked": torch.tensor(3)}
    checkpoint.save_checkpoint(tmp_path / "m", sd)
    checkpoint.save_checkpoint(tmp_path / "c", sd, iters=40, max_reward=0.5)
    got, extra = checkpoint.restore_checkpoint(tmp_path / "m")
    assert extra == {} and torch.equal(got["a.weight"], sd["a.weight"])
    got, extra = checkpoint.restore_checkpoint(tmp_path / "c")
    assert extra == {"iters": 40, "max_reward": 0.5}
    for name in ("m", "c"):
        loaded = jwc.load_torch_state_dict(tmp_path / name)
        np.testing.assert_array_equal(loaded["a.weight"],
                                      sd["a.weight"].numpy())


def test_yaml_config_matches_jax(tmp_path):
    import argparse

    cfg = tmp_path / "c.yaml"
    cfg.write_text("lr: 0.5\nppo:\n  clip_param: 0.3\n")

    def parser():
        p = argparse.ArgumentParser()
        p.add_argument("--lr", type=float, default=1.0)
        p.add_argument("--clip-param", type=float, default=0.2)
        p.add_argument("--epochs", type=int, default=3)
        return p

    for argv in (["--config", str(cfg)], ["--config", str(cfg), "--lr", "2"],
                 []):
        assert (vars(config.apply_yaml_config(parser(), argv))
                == vars(jconfig.apply_yaml_config(parser(), argv)))


def test_metrics_logger_matches_jax(tmp_path):
    rows = [{"loss": 1.0}, {"loss": 0.5, "acc": 0.25}, {"acc": 1.0}]
    paths = []
    for mod, sub in ((plogging, "port"), (jlogging, "jax")):
        log = mod.MetricsLogger("p", out_dir=tmp_path / sub)
        for r in rows:
            log.log(r)
        log.close()
        paths.append(log.out_path)
    assert paths[0].read_text() == paths[1].read_text()


def test_model_zoo(tmp_path, monkeypatch):
    from eva_vos_tpu_torch.annotator import FakeSAMController
    from eva_vos_tpu_torch.models import ActorCritic, QualityNet

    load_report.reset()
    with pytest.raises(FileNotFoundError):
        model_zoo.load_qnet(weights_root=tmp_path, device="cpu")
    net, extract = model_zoo.load_qnet(allow_random=True,
                                       weights_root=tmp_path, device="cpu")
    assert isinstance(net, QualityNet) and not net.training
    assert load_report.weights_marker() == "RANDOM_WEIGHTS"

    # a .pth in the reference layout loads straight in
    ac = ActorCritic(out_dim=2, arch="resnet18", dropout=0.0)
    (tmp_path / "rl_agent").mkdir()
    torch.save({"state_dict": ac.state_dict()},
               tmp_path / "rl_agent" / "model.pth")
    load_report.reset()
    agent = model_zoo.load_rl_agent(weights_root=tmp_path, device="cpu")
    assert load_report.report() == {"model": False}
    for k, v in ac.state_dict().items():
        torch.testing.assert_close(agent.net.state_dict()[k], v)

    monkeypatch.setenv("EVAVOS_TINY", "1")
    stcn = model_zoo.load_stcn(device="cpu")
    assert type(stcn.key_encoder.layer2[0]).__name__ == "BasicBlock"
    assert isinstance(model_zoo.load_sam("fake"), FakeSAMController)


# ---------------------------------------------------------------------------
# Trees written by the port's generators, read by both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    from eva_vos_tpu_torch.cli import generate_annotation_dataset as gen_an
    from eva_vos_tpu_torch.cli import generate_fq_dataset as gen_fq

    root = tmp_path_factory.mktemp("data")
    mp = pytest.MonkeyPatch()
    mp.setenv("EVAVOS_TINY", "1")
    try:
        gen_fq.main(["--synthetic", "2", "--rounds", "2", "--imset", "train",
                     "--allow-random", "--out", str(root / "FQ_DB"),
                     "--device", "cpu"])
        gen_an.main(["--synthetic", "2", "--rounds", "4", "--imset", "train",
                     "--sam", "fake", "--allow-random", "--out",
                     str(root / "AnnotDB"), "--device", "cpu"])
    finally:
        mp.undo()
    for seed in range(2):
        sample = pd_.make_synthetic_sample(t=6, h=64, w=96, seed=seed)
        ann = root / "MOSE" / "Annotations" / "480p" / f"synthetic_{seed}"
        ann.mkdir(parents=True)
        for f in range(sample.gt.shape[1]):
            write_png(ann / f"{f:05d}.png", sample.gt[0, f], PALETTE)
    return root


def _assert_items_equal(ours, ref):
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(ours[k]), np.asarray(ref[k]),
                                      err_msg=k)
        assert np.asarray(ours[k]).dtype == np.asarray(ref[k]).dtype, k


def test_fq_tree_reads_the_same(trees):
    root = trees / "FQ_DB"
    df = pd.read_csv(root / "res_train.csv")
    assert list(df.columns) == ["state_name", "ious"]
    ours = pd_.MaskQualityDB(root, root / "res_train.csv")
    ref = jd.MaskQualityDB(root, root / "res_train.csv")
    assert len(ours) == len(ref) > 0
    assert ours.items == ref.items
    for i in range(len(ref)):
        _assert_items_equal(ours[i], ref[i])
    got = list(ours.batches(4, rng=np.random.default_rng(1)))
    want = list(ref.batches(4, rng=np.random.default_rng(1)))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        _assert_items_equal(g, w)
    # every kept state has T masks, and a T-long IoU list
    for state in df["state_name"]:
        assert len(list((root / "Annotations" / "224" / state).glob(
            "*.png"))) == 6
    assert all(len(eval(x)) == 6 for x in df["ious"])


@pytest.mark.parametrize("sample_size", [None, 1, 2])
def test_annot_tree_reads_the_same(trees, sample_size):
    root = trees / "AnnotDB"
    df = pd.read_csv(root / "train.csv")
    assert {"id", "video_name", "frame_num", "frame_cost", "video_cost",
            "selected_annotation", "init_iou"} <= set(df.columns)
    ours = pd_.AnnotTypeDB(root, "train", sample_size,
                           np.random.default_rng(5))
    ref = jd.AnnotTypeDB(root, "train", sample_size, np.random.default_rng(5))
    for epoch in range(3):
        assert [r["id"] for r in ours.active] == ref.active["id"].tolist()
        assert len(ours) > 0
        for i in range(len(ref)):
            _assert_items_equal(ours[i], ref[i])
        ours.sample_df()
        ref.sample_df()
    assert ours[0]["sam_embedding"].shape == (256, 64, 64)


def test_annot_tree_drops_corrupt_images(trees, tmp_path):
    import shutil

    root = tmp_path / "AnnotDB"
    shutil.copytree(trees / "AnnotDB", root)
    shutil.copytree(trees / "MOSE", tmp_path / "MOSE")
    ids = pd.read_csv(root / "train.csv")["id"].tolist()
    (root / "Images" / f"{ids[0]}.png").write_bytes(b"\x89PNG broken")
    ours = pd_.AnnotTypeDB(root, "train")
    ref = jd.AnnotTypeDB(root, "train")
    assert [r["id"] for r in ours.rows] == ref.df["id"].tolist() == ids[1:]


def test_annotation_dataset_matches_jax(rng, tmp_path):
    """A DAVIS-style tree: JPEG frames (PIL, in both packages) and palette
    annotations (the port's codec)."""
    root = tmp_path / "DAVIS"
    images, masks = synthetic_video(3, 32, 48, num_objects=2, seed=1)
    for vid in ("b", "a"):
        (root / "JPEGImages" / "480p" / vid).mkdir(parents=True)
        (root / "Annotations" / "480p" / vid).mkdir(parents=True)
        for f in range(3):
            Image.fromarray((images[f] * 255).astype(np.uint8)).save(
                root / "JPEGImages" / "480p" / vid / f"{f:05d}.jpg")
            ids = np.where(masks[1, f] > 0, 2, masks[0, f]).astype(np.uint8)
            write_png(root / "Annotations" / "480p" / vid / f"{f:05d}.png",
                      ids, PALETTE)
    imset = root / "set.txt"
    imset.write_text("b\na\n")
    for kw in ({}, {"min_idx": 1, "max_idx": 2}):
        ours = pd_.AnnotationDataset(root, imset, **kw)
        ref = jd.AnnotationDataset(root, imset, **kw)
        assert ours.samples == ref.samples
        for s_ours, s_ref in zip(ours, ref):
            assert s_ours.name == s_ref.name
            np.testing.assert_array_equal(s_ours.images01, s_ref.images01)
            np.testing.assert_array_equal(s_ours.gt, s_ref.gt)


def test_png_bytes_under_a_jpg_name_read_as_in_jax(rng, tmp_path,
                                                   monkeypatch):
    """The frame reader goes by the file's bytes, as PIL does: a PNG saved
    as ``00000.jpg`` reads the same in both packages, without PIL in the
    port; a real JPEG still goes through PIL."""
    rgb = _images(rng)["RGB"]
    png = tmp_path / "00000.jpg"
    write_png(png, rgb)
    jpeg = tmp_path / "00001.jpg"
    Image.fromarray(rgb).save(jpeg)
    for path in (png, jpeg):
        np.testing.assert_array_equal(pd_._imread_rgb01(path),
                                      jd._imread_rgb01(path))
    np.testing.assert_array_equal(pd_._imread_rgb01(png),
                                  rgb.astype(np.float32) / 255.0)
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(pd_._imread_rgb01(png),
                                  rgb.astype(np.float32) / 255.0)
    with pytest.raises(ImportError, match="needs PIL"):
        pd_._imread_rgb01(jpeg)


def test_synthetic_sample_matches_jax():
    ours = pd_.make_synthetic_sample(t=4, h=16, w=24, seed=3, empty_frame=2)
    ref = jd.make_synthetic_sample(t=4, h=16, w=24, seed=3, empty_frame=2)
    assert ours.name == ref.name
    np.testing.assert_array_equal(ours.images01, ref.images01)
    np.testing.assert_array_equal(ours.gt, ref.gt)
