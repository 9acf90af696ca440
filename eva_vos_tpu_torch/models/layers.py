"""Shared network blocks (counterpart of ``eva_vos_tpu/models/layers.py``).

These are inner modules: they take and return NCHW tensors (the STCN and
FusionNet entry points convert from and to channel-last).  Attribute names
follow the reference's ``modules.py`` and ``cbam.py`` so the reference
state-dict layout loads with ``strict=True``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def conv3x3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel_size=3, padding=1)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, 2H, 2W] bilinear, half-pixel."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


class ResBlock(nn.Module):
    """Pre-activation residual block with 3x3 convs; a 3x3 conv on the skip
    when the width changes (``modules.py:15-35``)."""

    def __init__(self, indim: int, outdim: int):
        super().__init__()
        self.conv1 = conv3x3(indim, outdim)
        self.conv2 = conv3x3(outdim, outdim)
        self.downsample = conv3x3(indim, outdim) if indim != outdim else None

    def forward(self, x):
        r = self.conv2(F.relu(self.conv1(F.relu(x))))
        if self.downsample is not None:
            x = self.downsample(x)
        return x + r


class ChannelGate(nn.Module):
    """CBAM channel attention: shared MLP over avg- and max-pooled stats."""

    def __init__(self, gate_channels: int, reduction_ratio: int = 16):
        super().__init__()
        hidden = gate_channels // reduction_ratio
        self.mlp = nn.Sequential(nn.Flatten(), nn.Linear(gate_channels, hidden),
                                 nn.ReLU(), nn.Linear(hidden, gate_channels))

    def forward(self, x):
        att = self.mlp(x.mean(dim=(2, 3))) + self.mlp(x.amax(dim=(2, 3)))
        return x * torch.sigmoid(att)[:, :, None, None]


class SpatialGate(nn.Module):
    """CBAM spatial attention: 7x7 conv over the [max, mean] channel pool."""

    def __init__(self):
        super().__init__()
        self.spatial = nn.ModuleDict(
            {"conv": nn.Conv2d(2, 1, kernel_size=7, padding=3)})

    def forward(self, x):
        pooled = torch.cat([x.amax(dim=1, keepdim=True),
                            x.mean(dim=1, keepdim=True)], dim=1)
        return x * torch.sigmoid(self.spatial["conv"](pooled))


class CBAM(nn.Module):
    def __init__(self, gate_channels: int, reduction_ratio: int = 16):
        super().__init__()
        self.ChannelGate = ChannelGate(gate_channels, reduction_ratio)
        self.SpatialGate = SpatialGate()

    def forward(self, x):
        return self.SpatialGate(self.ChannelGate(x))


class FeatureFusionBlock(nn.Module):
    """ResBlock -> CBAM (residual) -> ResBlock over concatenated features."""

    def __init__(self, indim: int, outdim: int):
        super().__init__()
        self.block1 = ResBlock(indim, outdim)
        self.attention = CBAM(outdim)
        self.block2 = ResBlock(outdim, outdim)

    def forward(self, x, f16):
        x = self.block1(torch.cat([x, f16], dim=1))
        return self.block2(x + self.attention(x))


class UpsampleBlock(nn.Module):
    """skip_conv(skip) + 2x bilinear(up) -> ResBlock (``modules.py:152-163``).

    ``skip_is_conv=True``: ``skip_f`` already is the skip_conv output (the
    engine computes the per-frame skip convs once per video).
    """

    def __init__(self, skip_c: int, up_c: int, out_c: int):
        super().__init__()
        self.skip_conv = conv3x3(skip_c, up_c)
        self.out_conv = ResBlock(up_c, out_c)

    def forward(self, skip_f, up_f, skip_is_conv: bool = False):
        x = skip_f if skip_is_conv else self.skip_conv(skip_f)
        return self.out_conv(x + upsample2x(up_f))


class KeyProjection(nn.Module):
    """indim -> keydim 3x3 conv (``modules.py:166-175``)."""

    def __init__(self, indim: int, keydim: int = 64):
        super().__init__()
        self.key_proj = conv3x3(indim, keydim)
        nn.init.orthogonal_(self.key_proj.weight.data)
        nn.init.zeros_(self.key_proj.bias.data)

    def forward(self, x):
        return self.key_proj(x)
