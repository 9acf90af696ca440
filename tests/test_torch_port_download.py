"""The port's download CLIs (``eva_vos_tpu_torch.cli.download_data`` and
``download_weights``) against the JAX package's, on the CPU, with no
network: a MOSE-style archive built here, and weights trees of the port's
own modules."""

import io
import os
import subprocess
import sys
import tarfile
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from eva_vos_tpu.cli import download_weights as jdw
from eva_vos_tpu_torch.cli import download_data, download_weights

REPO = Path(__file__).resolve().parents[1]


def _add(tf, name, image):
    buf = io.BytesIO()
    image.save(buf, format="JPEG" if name.endswith(".jpg") else "PNG")
    info = tarfile.TarInfo(name)
    info.size = buf.tell()
    buf.seek(0)
    tf.addfile(info, buf)


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    """train.tar.gz with three videos of 15, 20 and 30 JPEG frames (36x64)
    and their palette masks; the 15-frame one is below MIN_FRAMES."""
    path = tmp_path_factory.mktemp("mose") / "train.tar.gz"
    rng = np.random.default_rng(7)
    with tarfile.open(path, "w:gz") as tf:
        for video, n in (("vid_a", 20), ("vid_b", 15), ("vid_c", 30)):
            for f in range(n):
                rgb = rng.integers(0, 256, (36, 64, 3), dtype=np.uint8)
                _add(tf, f"train/JPEGImages/{video}/{f:05d}.jpg",
                     Image.fromarray(rgb))
                ids = (rng.random((36, 64)) < 0.3).astype(np.uint8)
                mask = Image.fromarray(ids, mode="P")
                mask.putpalette([0, 0, 0, 128, 0, 0])
                _add(tf, f"train/Annotations/{video}/{f:05d}.png", mask)
    return path


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "raw" not in p.relative_to(root).parts}


def test_download_data_matches_jax(archive, tmp_path, monkeypatch):
    """``--archive`` with one worker: the same ImageSets and the same
    resized files in both packages (the JAX CLI in a subprocess, since its
    pool forks)."""
    jroot = tmp_path / "jax"
    env = dict(os.environ, EVAVOS_DATA_ROOT=str(jroot), JAX_PLATFORMS="cpu",
               PYTHONPATH=str(REPO))
    done = subprocess.run(
        [sys.executable, "-m", "eva_vos_tpu.cli.download_data", "--archive",
         str(archive), "--workers", "1"], cwd=REPO, env=env, timeout=120,
        capture_output=True, text=True)
    assert done.returncode == 0, done.stderr

    monkeypatch.setenv("EVAVOS_DATA_ROOT", str(tmp_path / "port"))
    download_data.main(["--archive", str(archive), "--workers", "1"])
    ours, ref = _tree(tmp_path / "port" / "MOSE"), _tree(jroot / "MOSE")
    assert ours.keys() == ref.keys()
    for name in ours:
        assert ours[name] == ref[name], name
    assert sorted(ours["ImageSets/train.txt"].decode().split()) == \
        ["vid_a", "vid_c"]
    assert ours["ImageSets/val.txt"] == ours["ImageSets/test.txt"] == b"\n"
    first = Image.open(tmp_path / "port" / "MOSE" / "JPEGImages" / "480p"
                       / "vid_a" / "00000.jpg")
    assert first.size == (853, 480)


@pytest.mark.parametrize("present", [[], ["mivos/fusion.pth",
                                          "qnet/qnet.pth"]])
def test_download_weights_reports_missing_as_jax(present, tmp_path,
                                                 monkeypatch, capsys):
    monkeypatch.setenv("EVAVOS_WEIGHTS_ROOT", str(tmp_path))
    for rel in present:
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_bytes(b"")
    assert jdw.main(["--check"]) == 1
    ref = capsys.readouterr().out
    assert download_weights.main(["--check"]) == 1
    assert capsys.readouterr().out == ref
    assert ref.count("[missing]") == 5 - len(present)
    assert download_weights.EXPECTED == jdw.EXPECTED
    assert download_weights.SOURCES == jdw.SOURCES


def test_download_weights_check_loads_every_file(tmp_path, monkeypatch,
                                                 capsys):
    """``--check`` on a tree of the port's modules (SAM at the tiny
    preset): every file loads strictly; a file of the wrong layout
    raises."""
    from eva_vos_tpu_torch.models import (ActorCritic, FusionNet,
                                          PropagationNetwork, QualityNet)
    from eva_vos_tpu_torch.models.sam.build import PRESETS, Sam

    monkeypatch.setenv("EVAVOS_WEIGHTS_ROOT", str(tmp_path))
    nets = {"mivos/stcn.pth": PropagationNetwork(),
            "mivos/fusion.pth": FusionNet(),
            "qnet/qnet.pth": QualityNet(arch="resnet18"),
            "rl_agent/model.pth": ActorCritic(out_dim=2, arch="resnet18",
                                              embed_dim=32),
            "sam/sam.pth": Sam(PRESETS["tiny"])}
    for rel, net in nets.items():
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        torch.save(net.state_dict(), tmp_path / rel)
    assert download_weights.main(["--check"]) == 0
    out = capsys.readouterr().out
    assert out.count("[load ok]") == 5 and "[missing]" not in out

    torch.save(QualityNet(arch="resnet18").state_dict(),
               tmp_path / "mivos" / "fusion.pth")
    with pytest.raises(RuntimeError, match="state_dict"):
        download_weights.main(["--check"])
    torch.save(QualityNet(arch="resnet18").state_dict(),
               tmp_path / "sam" / "sam.pth")
    with pytest.raises(ValueError, match="no SAM preset"):
        download_weights._modules()["sam/sam.pth"](
            torch.load(tmp_path / "sam" / "sam.pth"))
