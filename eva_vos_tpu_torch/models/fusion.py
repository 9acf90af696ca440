"""FusionNet (counterpart of ``eva_vos_tpu/models/fusion.py:FusionNet``).

A small CNN over cat[image(3), seg1(1), seg2(1), attention(2), time(2)]
= 9 channels with two residual stages, emitting one logit map
(reference ``mivos/model/fusion_net.py``).  Plain 3x3 convolutions only: the
JAX package's space-to-depth executions (``fusion_apply_packed``,
``fusion_apply_phase_gemm``) were layouts for the TPU's matrix unit.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import conv3x3
from .stcn import to_nchw


class FusionNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Sequential(conv3x3(9, 32), nn.ReLU())
        self.conv2 = nn.Sequential(conv3x3(32, 32), nn.ReLU(), conv3x3(32, 32))
        self.conv3 = nn.Sequential(conv3x3(32, 32), nn.ReLU(), conv3x3(32, 32))
        self.final_conv = conv3x3(32, 1)

    def forward(self, im, seg1, seg2, attn, time):
        """seg1/seg2 [..., H, W]; im [H, W, 3] or [..., H, W, 3] and time [2]
        or [..., 2], broadcast to seg1's leading axes; attn [..., H, W, 2].
        Returns [..., H, W] logits in the network's dtype."""
        lead = seg1.shape[:-2]
        h, w = seg1.shape[-2:]
        dtype = im.dtype
        t = time.to(dtype).expand(*lead, 2)[..., None, None, :]
        x = torch.cat([im.expand(*lead, h, w, 3), seg1[..., None].to(dtype),
                       seg2[..., None].to(dtype), attn.to(dtype),
                       t.expand(*lead, h, w, 2)], dim=-1)
        x = self.conv1(to_nchw(x))
        x = F.relu(x + self.conv2(x))
        x = F.relu(x + self.conv3(x))
        return self.final_conv(x)[:, 0].reshape(*lead, h, w)
