"""Model assembly: build the port's modules and load reference checkpoints
(counterpart of ``eva_vos_tpu/utils/model_zoo.py``).

The port's modules take the reference state-dict layout, so a ``.pth``
loads straight in with no converter.  The weights root comes from
``EVAVOS_WEIGHTS_ROOT`` (default ``model_weights/``); every loader falls back
to seeded random weights with ``allow_random=True`` (recorded in
``load_report``), so smoke runs and tests work without checkpoints, and
``EVAVOS_TINY=1`` builds the STCN with resnet18 trunks (random weights: no
checkpoint loads in tiny mode).  Modules are made on the CPU, moved to
``device`` and seeded there.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

from . import load_report
from .paths import DataPaths
from ..models import (ActorCritic, FusionNet, PropagationNetwork, QualityNet,
                      make_generator, seeded_init_)


def load_torch_state_dict(path, device="cpu") -> dict:
    """A ``.pth`` state dict (unwrapping a ``{"state_dict": ...}`` file)."""
    sd = torch.load(path, map_location=device, weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return sd


def _maybe(path: Path, allow_random: bool, name: str | None = None):
    name = name or path.stem
    if path.exists():
        load_report.record(name, False)
        return load_torch_state_dict(path)
    if allow_random:
        load_report.record(name, True)
        return None
    raise FileNotFoundError(
        f"checkpoint {path} not found; pass allow_random=True for a smoke "
        f"run or set EVAVOS_WEIGHTS_ROOT")


def _tiny() -> bool:
    """EVAVOS_TINY=1 builds resnet18-trunk STCNs, for quick CLI runs."""
    return os.environ.get("EVAVOS_TINY") == "1"


def _place(module, sd, seed: int, device, dtype=torch.float32):
    """``module`` on ``device`` with the weights of ``sd``, or seeded
    random ones when ``sd`` is None; eval mode."""
    module = module.to(device)
    if sd is None:
        seeded_init_(module, make_generator(seed, device))
    else:
        module.load_state_dict(sd)
    return module.to(dtype).eval()


def _root(weights_root) -> Path:
    return Path(weights_root or DataPaths.weights_root())


def load_stcn(dtype=torch.float32, allow_random=False, weights_root=None,
              device="cuda") -> PropagationNetwork:
    if _tiny():
        return _place(PropagationNetwork(key_arch="resnet18",
                                         value_arch="resnet18"),
                      None, 0, device, dtype)
    sd = _maybe(_root(weights_root) / "mivos" / "stcn.pth", allow_random)
    return _place(PropagationNetwork(), sd, 0, device, dtype)


def load_fusion(dtype=torch.float32, allow_random=False, weights_root=None,
                device="cuda") -> FusionNet:
    sd = _maybe(_root(weights_root) / "mivos" / "fusion.pth", allow_random)
    return _place(FusionNet(), sd, 1, device, dtype)


def load_qnet(arch="resnet18", allow_random=False, weights_root=None,
              device="cuda"):
    """-> (QualityNet in eval mode, its ``extract_features``), fp32."""
    sd = _maybe(_root(weights_root) / "qnet" / "qnet.pth", allow_random)
    net = _place(QualityNet(arch=arch), sd, 2, device)
    return net, net.extract_features


def load_rl_agent(action_space=2, arch="resnet18", allow_random=False,
                  weights_root=None, device="cuda"):
    """-> a ``PPOAgent`` (fp32)."""
    from ..train.ppo.agent import PPOAgent

    sd = _maybe(_root(weights_root) / "rl_agent" / "model.pth", allow_random)
    if sd is None:
        net = ActorCritic(out_dim=action_space, arch=arch, dropout=0.0)
        sd = seeded_init_(net, make_generator(3, "cpu")).state_dict()
    return PPOAgent(action_space, arch, sd, device=device)


def load_sam(preset="vit_h", dtype=torch.float32, allow_random=False,
             weights_root=None, max_points=64, device="cuda"):
    """Returns a SAMController. ``preset='fake'`` gives the test simulator."""
    from ..annotator import FakeSAMController

    if preset == "fake":
        return FakeSAMController()

    from ..models.sam import SAMController, SamPredictor, build_sam

    sd = _maybe(_root(weights_root) / "sam" / "sam.pth", allow_random)
    sam = build_sam(preset, dtype=dtype, seed=0, device=device)
    if sd is not None:
        sam.load_state_dict(sd)
    return SAMController(SamPredictor(sam, max_points=max_points))
