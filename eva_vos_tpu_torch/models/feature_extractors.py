"""Pretrained-encoder feature extractors for the l2_mask baseline
(counterpart of ``eva_vos_tpu/models/feature_extractors.py``).

Reference ``feature_extractors/{resnet,vit,dino}.py``: ResNet layer4
features, ViT cls-token features, DINOv2 cls features, each behind the
torchvision eval transform (short side to 256 -> centre crop 224 ->
ImageNet normalisation).  The short side goes to 256 by ``resize_bilinear``
(ResNet) or ``resize_bicubic`` (ViT, DINOv2); both antialias when they
shrink, as ``jax.image.resize`` does.

Checkpoints: ``<weights root>/feature_extractors/<name>.pth`` in the
torchvision / DINOv2 state-dict layout (the root is ``EVAVOS_WEIGHTS_ROOT``,
default ``model_weights``).  Without one, ``allow_random`` gives seeded
random weights (selection quality is then roughly random), and otherwise
the build raises.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from .init import make_generator, seeded_init_
from .resnet import ResNetTrunk
from .vit import ViTEncoder
from ..ops.normalize import im_normalize
from ..ops.resize import resize_bicubic, resize_bilinear

VIT_CONFIGS = {
    "vit_base": dict(patch_size=16, dim=768, depth=12, num_heads=12),
    "vit_large": dict(patch_size=16, dim=1024, depth=24, num_heads=16),
    "dino_small": dict(patch_size=14, dim=384, depth=12, num_heads=6),
    "dino_base": dict(patch_size=14, dim=768, depth=12, num_heads=12),
    "dino_large": dict(patch_size=14, dim=1024, depth=24, num_heads=16),
    "dino_giant": dict(patch_size=14, dim=1536, depth=40, num_heads=24),
}


def weights_root() -> Path:
    return Path(os.environ.get("EVAVOS_WEIGHTS_ROOT", "model_weights"))


def eval_transform(images01, out: int = 224, method: str = "bilinear",
                   device="cuda") -> torch.Tensor:
    """[T, H, W, 3] in [0, 1] (float) or [0, 255] (uint8) -> short side 256
    -> centre crop ``out`` -> ImageNet-normalised, channel-last, on
    ``device`` (uint8 moves at 1 byte a pixel and is scaled there)."""
    x = torch.as_tensor(np.asarray(images01), device=device)
    if x.dtype == torch.uint8:
        x = x.float() / 255.0
    _, h, w, _ = x.shape
    scale = 256.0 / min(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    resize = resize_bicubic if method == "bicubic" else resize_bilinear
    x = resize(x.float(), (nh, nw), h_axis=1, w_axis=2)
    top, left = (nh - out) // 2, (nw - out) // 2
    return im_normalize(x[:, top:top + out, left:left + out])


def _load(name: str, module: torch.nn.Module, allow_random: bool, seed: int,
          device) -> torch.nn.Module:
    """The checkpoint's weights (keys the extractor does not run, such as a
    classifier head, are dropped), or seeded random weights."""
    path = weights_root() / "feature_extractors" / f"{name}.pth"
    module = module.to(device)
    if path.exists():
        sd = torch.load(path, map_location=device, weights_only=True)
        own = module.state_dict()
        module.load_state_dict({k: v for k, v in sd.items() if k in own})
    elif allow_random:
        seeded_init_(module, make_generator(seed, device))
    else:
        raise FileNotFoundError(
            f"feature extractor weights {path} not found; pass "
            f"allow_random=True")
    return module.eval()


def build_feature_extractor(name: str, allow_random: bool = False,
                            dtype=torch.float32, device="cuda", seed: int = 0):
    """Returns ``extract(images01 [T, H, W, 3]) -> [T, D]`` float32 on
    ``device``."""
    if name.startswith("resnet"):
        net = _load(name, ResNetTrunk(arch=name, num_stages=4), allow_random,
                    seed, device).to(dtype)

        def fwd(x):
            f = net(x.permute(0, 3, 1, 2))[-1]            # layer4, NCHW
            return f.permute(0, 2, 3, 1).reshape(x.shape[0], -1)

        method = "bilinear"
    elif name.startswith(("vit", "dino")):
        key = name if name in VIT_CONFIGS else {
            "vit_b_16": "vit_base", "vit_l_16": "vit_large",
            "dino": "dino_large"}.get(name)
        if key is None:
            raise AttributeError(f"{name} is invalid!")
        net = _load(key, ViTEncoder(img_size=224,
                                    layerscale=key.startswith("dino"),
                                    **VIT_CONFIGS[key]),
                    allow_random, seed, device).to(dtype)

        def fwd(x):
            return net(x.permute(0, 3, 1, 2))[0]

        method = "bicubic"
    else:
        raise AttributeError(f"{name} is invalid!")

    @torch.no_grad()
    def extract(images01):
        x = eval_transform(images01, method=method, device=device)
        return fwd(x.to(dtype)).float()

    extract.net = net
    return extract
