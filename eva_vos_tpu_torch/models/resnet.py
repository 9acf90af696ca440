"""ResNet trunks (counterpart of ``eva_vos_tpu/models/resnet.py``).

* ``conv_bias=False``: torchvision-style convs (the STCN key encoder).
* ``conv_bias=True``: the reference's ``mod_resnet`` with biased convs and a
  widened stem (the STCN value encoder).

BatchNorm runs in eval mode with eps 1e-5; the stem's max pool pads with
-inf, as ``F.max_pool2d`` does.  NCHW in, a tuple of stage features out.
"""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

_EPS = 1e-5


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=_EPS)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=False,
                 conv_bias=False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=conv_bias)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=conv_bias)
        self.bn2 = _bn(planes)
        self.downsample = nn.Sequential(
            nn.Conv2d(inplanes, planes, 1, stride, bias=conv_bias),
            _bn(planes)) if downsample else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=False,
                 conv_bias=False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=conv_bias)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=conv_bias)
        self.bn2 = _bn(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=conv_bias)
        self.bn3 = _bn(planes * 4)
        self.downsample = nn.Sequential(
            nn.Conv2d(inplanes, planes * 4, 1, stride, bias=conv_bias),
            _bn(planes * 4)) if downsample else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


_ARCHS = {
    # name: (block, blocks per stage)
    "resnet18": (BasicBlock, (2, 2, 2, 2)),
    "resnet34": (BasicBlock, (3, 4, 6, 3)),
    "resnet50": (Bottleneck, (3, 4, 6, 3)),
    "resnet101": (Bottleneck, (3, 4, 23, 3)),
}


def feature_dims(arch: str, num_stages: int = 4) -> list[int]:
    """Channel width of each stage's output."""
    block, _ = _ARCHS[arch]
    return [64 * (2 ** s) * block.expansion for s in range(num_stages)]


class ResNetTrunk(nn.Module):
    """Stem + the first ``num_stages`` stages of a ResNet.

    ``stage_names`` are the state-dict names of the stages (the reference's
    key encoder calls its first stage ``res2``).
    """

    def __init__(self, arch: str = "resnet50", num_stages: int = 4,
                 conv_bias: bool = False, in_chans: int = 3,
                 stage_names=None):
        super().__init__()
        block, layers = _ARCHS[arch]
        self.stage_names = list(stage_names or
                                [f"layer{s + 1}" for s in range(num_stages)])
        self.conv1 = nn.Conv2d(in_chans, 64, 7, 2, 3, bias=conv_bias)
        self.bn1 = _bn(64)
        inplanes = 64
        for s in range(num_stages):
            planes = 64 * (2 ** s)
            stride = 1 if s == 0 else 2
            blocks = []
            for b in range(layers[s]):
                ds = b == 0 and (stride != 1 or inplanes != planes * block.expansion)
                blocks.append(block(inplanes, planes, stride if b == 0 else 1,
                                    downsample=ds, conv_bias=conv_bias))
                inplanes = planes * block.expansion
            self.add_module(self.stage_names[s], nn.Sequential(*blocks))

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
        feats = []
        for name in self.stage_names:
            x = getattr(self, name)(x)
            feats.append(x)
        return tuple(feats)
