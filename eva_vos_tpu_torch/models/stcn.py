"""STCN space-time memory network (counterpart of ``eva_vos_tpu/models/stcn.py``).

* KeyEncoder   - ResNet trunk cut at layer3 (f16 @1/16, f8 @1/8, f4 @1/4)
* key_proj     - f16 -> keydim 3x3 conv (the memory key)
* key_comp     - f16 -> value_dim 3x3 conv (the thin query value)
* ValueEncoder - 5-channel mod-ResNet trunk (rgb + object mask + the other
                 objects' mask) fused with the key feature -> value_dim
* Decoder      - compress ResBlock, two UpsampleBlocks (1/16 -> 1/8 -> 1/4),
                 a 1-channel pred conv and one 4x bilinear upsample

Channel widths follow the trunks (``resnet.feature_dims``), so a resnet18
key encoder works at test size.  The public methods take and return
channel-last tensors, as the JAX module does; the convolutions run NCHW
inside (on the card the permuted tensors are channels-last NCHW, which
cuDNN takes as they are).  The memory read itself lives in ``ops`` and
``kernels`` and is driven by the engine.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import (FeatureFusionBlock, KeyProjection, ResBlock,
                     UpsampleBlock, conv3x3)
from .resnet import ResNetTrunk, feature_dims
from ..ops.memory_attention import full_softmax_affinity
from ..ops.resize import area_downsample, resize_bilinear


class STCNFeatures(NamedTuple):
    """Per-frame features of ``encode_key`` (all channel-last)."""

    k16: torch.Tensor        # [.., H/16, W/16, keydim]  memory/query key
    f16_thin: torch.Tensor   # [.., H/16, W/16, value_dim] query value
    f16: torch.Tensor        # [.., H/16, W/16, C16]
    f8: torch.Tensor         # [.., H/8,  W/8,  C8]
    f4: torch.Tensor         # [.., H/4,  W/4,  C4]


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """[..., H, W, C] -> [B, C, H, W] (leading axes flattened)."""
    return x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2)


def to_nhwc(y: torch.Tensor, lead) -> torch.Tensor:
    """[B, C, H, W] -> [*lead, H, W, C]."""
    return y.permute(0, 2, 3, 1).reshape(*lead, *y.shape[2:], y.shape[1])


class KeyEncoder(ResNetTrunk):
    def __init__(self, arch: str = "resnet50"):
        super().__init__(arch, num_stages=3, conv_bias=False, in_chans=3,
                         stage_names=("res2", "layer2", "layer3"))

    def forward(self, frame):
        f4, f8, f16 = super().forward(frame)
        return f16, f8, f4


class ValueEncoder(ResNetTrunk):
    """5-channel mod-ResNet trunk + fuser -> value_dim memory value."""

    def __init__(self, arch: str = "resnet18", key_f16_dim: int = 1024,
                 value_dim: int = 512):
        super().__init__(arch, num_stages=3, conv_bias=True, in_chans=5)
        self.fuser = FeatureFusionBlock(feature_dims(arch, 3)[-1] + key_f16_dim,
                                        value_dim)

    def forward(self, x, key_f16):
        return self.fuser(super().forward(x)[-1], key_f16)


class Decoder(nn.Module):
    def __init__(self, f8_dim: int, f4_dim: int, value_dim: int = 512):
        super().__init__()
        self.compress = ResBlock(2 * value_dim, 512)
        self.up_16_8 = UpsampleBlock(f8_dim, 512, 256)
        self.up_8_4 = UpsampleBlock(f4_dim, 256, 256)
        self.pred = conv3x3(256, 1)

    def forward(self, m16, f8, f4, skips_precomputed: bool = False):
        """NCHW -> [B, 1, 4h, 4w] logits.  One 4x bilinear, as the
        reference's ``F.interpolate(scale_factor=4)``."""
        x = self.compress(m16)
        x = self.up_16_8(f8, x, skip_is_conv=skips_precomputed)
        x = self.up_8_4(f4, x, skip_is_conv=skips_precomputed)
        x = self.pred(F.relu(x))
        h, w = x.shape[-2:]
        return F.interpolate(x, size=(4 * h, 4 * w), mode="bilinear",
                             align_corners=False)

    def skips(self, f8, f4):
        """The two readout-independent skip convolutions (NCHW)."""
        return self.up_16_8.skip_conv(f8), self.up_8_4.skip_conv(f4)


class PropagationNetwork(nn.Module):
    """Stateless STCN bundle; the memory bank lives in the engine."""

    def __init__(self, keydim: int = 64, value_dim: int = 512,
                 key_arch: str = "resnet50", value_arch: str = "resnet18"):
        super().__init__()
        self.keydim = keydim
        self.value_dim = value_dim
        f4_dim, f8_dim, f16_dim = feature_dims(key_arch, 3)
        self.key_encoder = KeyEncoder(key_arch)
        self.value_encoder = ValueEncoder(value_arch, f16_dim, value_dim)
        self.key_proj = KeyProjection(f16_dim, keydim)
        self.key_comp = conv3x3(f16_dim, value_dim)
        self.decoder = Decoder(f8_dim, f4_dim, value_dim)

    @property
    def dtype(self) -> torch.dtype:
        return self.key_comp.weight.dtype

    def encode_key(self, frame) -> STCNFeatures:
        """frame [..., H, W, 3] -> per-frame features (``prop_net.py:172-177``)."""
        lead = frame.shape[:-3]
        f16, f8, f4 = self.key_encoder(to_nchw(frame))
        return STCNFeatures(k16=to_nhwc(self.key_proj(f16), lead),
                            f16_thin=to_nhwc(self.key_comp(f16), lead),
                            f16=to_nhwc(f16, lead), f8=to_nhwc(f8, lead),
                            f4=to_nhwc(f4, lead))

    def encode_value(self, frame, kf16, masks):
        """Memory value of one frame for K objects.

        frame [H, W, 3], kf16 [H/16, W/16, C16], masks [K, H, W] ->
        [K, H/16, W/16, value_dim].  The "others" channel of object i is the
        sum of the other objects' masks (``prop_net.py:153-170``).
        """
        k = masks.shape[0]
        masks = masks.to(frame.dtype)
        others = (torch.zeros_like(masks) if k == 1
                  else masks.sum(0, keepdim=True) - masks)
        x = torch.cat([frame.expand(k, *frame.shape), masks[..., None],
                       others[..., None]], dim=-1)
        key_f16 = to_nchw(kf16.expand(k, *kf16.shape))
        return to_nhwc(self.value_encoder(to_nchw(x), key_f16), (k,))

    def decode_with_readout(self, readout_value, qv16, qf8, qf4,
                            skips_precomputed: bool = False,
                            return_logits: bool = False):
        """Memory readout [..., K, h, w, CV] + one frame's query features
        (qv16 [..., h, w, C], qf8, qf4) -> [..., K, H, W] probabilities.

        ``skips_precomputed``: qf8/qf4 already are the skip-conv outputs
        (``encode_skips``).  ``return_logits`` skips the sigmoid.
        """
        lead = readout_value.shape[:-3]

        def per_object(f):
            return f.unsqueeze(-4).expand(*lead, *f.shape[-3:])

        m16 = torch.cat([readout_value, per_object(qv16)], dim=-1)
        logits = self.decoder(to_nchw(m16), to_nchw(per_object(qf8)),
                              to_nchw(per_object(qf4)),
                              skips_precomputed=skips_precomputed)
        logits = logits[:, 0].reshape(*lead, *logits.shape[-2:])
        return logits if return_logits else torch.sigmoid(logits)

    def encode_skips(self, f8, f4):
        """Per-frame decoder skip-conv outputs (readout-independent)."""
        s8, s4 = self.decoder.skips(to_nchw(f8), to_nchw(f4))
        return to_nhwc(s8, f8.shape[:-3]), to_nhwc(s4, f4.shape[:-3])

    def get_attention(self, mk16, pos_mask, neg_mask, qk16):
        """Fusion attention maps (``prop_net.py:198-210``).

        mk16 [h, w, keydim] key of the interacted frame, pos/neg_mask
        [K, H, W] mask differences, qk16 [h, w, keydim] query key ->
        [K, H, W, 2] in the network's dtype.
        """
        h, w, _ = mk16.shape
        H, W = pos_mask.shape[-2:]
        k = pos_mask.shape[0]
        # softmax over the memory axis for each query: [hw_q, hw_m]
        w_aff = full_softmax_affinity(mk16.reshape(h * w, -1),
                                      qk16.reshape(h * w, -1))
        pos = area_downsample(pos_mask, H // h).reshape(k, h * w).float()
        neg = area_downsample(neg_mask, H // h).reshape(k, h * w).float()
        attn = torch.stack([pos @ w_aff.T, neg @ w_aff.T], dim=-1)
        return resize_bilinear(attn.reshape(k, h, w, 2).to(self.dtype), (H, W))
