"""Model-weight acquisition and check (counterpart of
``eva_vos_tpu/cli/download_weights.py``).

Behavior parity target: ``download_weights.py`` in the reference (gdown of
model_weights.zip + the SAM ViT-H checkpoint).  Nothing is fetched here:
this CLI checks a locally provided weights directory, reports exactly what
is missing, and with ``--check`` loads every checkpoint strictly into the
port's own modules (they take the reference state-dict layout, so no
conversion is needed).

Expected layout under EVAVOS_WEIGHTS_ROOT (default ./model_weights):
    mivos/stcn.pth  mivos/fusion.pth  qnet/qnet.pth
    rl_agent/model.pth  sam/sam.pth

Usage:
    python -m eva_vos_tpu_torch.cli.download_weights --check
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..utils.paths import DataPaths

EXPECTED = ["mivos/stcn.pth", "mivos/fusion.pth", "qnet/qnet.pth",
            "rl_agent/model.pth", "sam/sam.pth"]

SOURCES = {
    "model_weights.zip": "gdown id 1xKMGDdZxJKpGSm6directbK (see reference "
                         "download_weights.py)",
    "sam.pth": "https://dl.fbaipublicfiles.com/segment_anything/"
               "sam_vit_h_4b8939.pth",
}


def _sam_for(sd):
    """The ``Sam`` of the preset whose parameter shapes are the file's."""
    import torch

    from ..models.sam.build import PRESETS, Sam

    shapes = {k: tuple(v.shape) for k, v in sd.items()}
    for cfg in PRESETS.values():
        with torch.device("meta"):
            sam = Sam(cfg)
        if {k: tuple(v.shape) for k, v in sam.state_dict().items()} \
                == shapes:
            return Sam(cfg)
    raise ValueError("sam.pth matches no SAM preset "
                     f"({', '.join(PRESETS)})")


def _modules():
    """name -> a function from the file's state dict to the port's module
    it must load into."""
    from ..models import (ActorCritic, FusionNet, PropagationNetwork,
                          QualityNet)

    return {
        "mivos/stcn.pth": lambda sd: PropagationNetwork(),
        "mivos/fusion.pth": lambda sd: FusionNet(),
        "qnet/qnet.pth": lambda sd: QualityNet(arch="resnet18"),
        "rl_agent/model.pth": lambda sd: ActorCritic(
            out_dim=2, arch="resnet18", dropout=0.0,
            embed_dim=sd["embed_branch.2.weight"].shape[1]),
        "sam/sam.pth": _sam_for,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true",
                    help="verify presence, and that each file loads")
    args = ap.parse_args(argv)

    root = Path(DataPaths.weights_root())
    missing = [p for p in EXPECTED if not (root / p).exists()]
    present = [p for p in EXPECTED if (root / p).exists()]
    for p in present:
        print(f"[ok]      {root / p}")
    for p in missing:
        print(f"[missing] {root / p}")
    if missing:
        print("\nThis environment has no network egress. Obtain the "
              "checkpoints elsewhere:\n"
              "  - model_weights.zip from the reference's download_weights.py"
              " (gdown)\n"
              f"  - SAM ViT-H: {SOURCES['sam.pth']}\n"
              f"and place them under {root}/ as listed above.")
        return 1

    if args.check:
        from ..utils.model_zoo import load_torch_state_dict

        for name, module_for in _modules().items():
            sd = load_torch_state_dict(root / name)
            module_for(sd).load_state_dict(sd, strict=True)
            print(f"[load ok] {name}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
