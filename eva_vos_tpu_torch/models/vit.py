"""Plain ViT encoder, cls-token features (counterpart of
``eva_vos_tpu/models/vit.py``).

Backs the ViT / DINOv2 feature extractors and the ActorCritic's ViT mask
branch: patchify -> [cls] + position embedding -> pre-LN transformer ->
final LN -> (cls, patch tokens).  LayerNorm eps is 1e-6 and the MLP's gelu
is exact, as in the JAX module.

``layerscale`` picks the family and with it the state-dict layout:

* ``False``: torchvision's ``VisionTransformer`` (``conv_proj``,
  ``class_token``, ``encoder.pos_embedding``,
  ``encoder.layers.encoder_layer_{i}.{ln_1, self_attention, ln_2, mlp}``,
  ``encoder.ln``; the attention's packed ``in_proj_weight``);
* ``True``: DINOv2 (``patch_embed.proj``, ``cls_token``, ``pos_embed``,
  ``mask_token``, ``blocks.{i}.{norm1, attn.qkv, attn.proj, ls1.gamma,
  norm2, mlp.fc1, mlp.fc2, ls2.gamma}``, ``norm``), whose LayerScale
  multiplies the attention and MLP branches.

The module takes NCHW images, like ``ResNetTrunk``.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn as nn
import torch.nn.functional as F

_EPS = 1e-6


def multi_head_attention(x, w_qkv, b_qkv, w_out, b_out, heads: int):
    """Self-attention of ``x`` [B, N, D] with packed q/k/v weights [3D, D]:
    the query scaled by head_dim ** -0.5 (Flax's
    ``MultiHeadDotProductAttention``), softmax over the keys."""
    b, n, d = x.shape
    hd = d // heads
    qkv = F.linear(x, w_qkv, b_qkv).reshape(b, n, 3, heads, hd)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)                  # [B, heads, N, hd]
    attn = torch.softmax((q * hd ** -0.5) @ k.transpose(-2, -1), dim=-1)
    out = (attn @ v).transpose(1, 2).reshape(b, n, d)
    return F.linear(out, w_out, b_out)


class _TvSelfAttention(nn.Module):
    """torchvision's ``nn.MultiheadAttention`` parameter names."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x):
        return multi_head_attention(x, self.in_proj_weight, self.in_proj_bias,
                                    self.out_proj.weight, self.out_proj.bias,
                                    self.heads)


class _TvBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.ln_1 = nn.LayerNorm(dim, eps=_EPS)
        self.self_attention = _TvSelfAttention(dim, heads)
        self.ln_2 = nn.LayerNorm(dim, eps=_EPS)
        self.mlp = nn.Sequential(nn.Linear(dim, hidden), nn.GELU(),
                                 nn.Dropout(0.0), nn.Linear(hidden, dim),
                                 nn.Dropout(0.0))

    def forward(self, x):
        x = x + self.self_attention(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class _TvEncoder(nn.Module):
    def __init__(self, tokens: int, dim: int, depth: int, heads: int):
        super().__init__()
        self.pos_embedding = nn.Parameter(torch.zeros(1, tokens, dim))
        self.layers = nn.Sequential(OrderedDict(
            (f"encoder_layer_{i}", _TvBlock(dim, heads)) for i in range(depth)))
        self.ln = nn.LayerNorm(dim, eps=_EPS)
        self._param_std = {"pos_embedding": 0.02}


class _DinoAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        return multi_head_attention(x, self.qkv.weight, self.qkv.bias,
                                    self.proj.weight, self.proj.bias,
                                    self.heads)


class _LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))
        self._param_std = {"gamma": "ones"}

    def forward(self, x):
        return x * self.gamma


class _DinoMlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class _DinoBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=_EPS)
        self.attn = _DinoAttention(dim, heads)
        self.ls1 = _LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=_EPS)
        self.mlp = _DinoMlp(dim, int(dim * mlp_ratio))
        self.ls2 = _LayerScale(dim)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class _PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, patch)


class ViTEncoder(nn.Module):
    def __init__(self, patch_size: int = 16, dim: int = 768, depth: int = 12,
                 num_heads: int = 12, img_size: int = 224,
                 layerscale: bool = False):
        super().__init__()
        self.layerscale = layerscale
        tokens = (img_size // patch_size) ** 2 + 1
        if layerscale:
            self.patch_embed = _PatchEmbed(patch_size, dim)
            self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
            self.pos_embed = nn.Parameter(torch.zeros(1, tokens, dim))
            # unused at inference; kept so a DINOv2 checkpoint loads strictly
            self.mask_token = nn.Parameter(torch.zeros(1, dim))
            self.blocks = nn.ModuleList(
                _DinoBlock(dim, num_heads) for _ in range(depth))
            self.norm = nn.LayerNorm(dim, eps=_EPS)
            self._param_std = {"cls_token": 0.0, "pos_embed": 0.02,
                               "mask_token": 0.0}
        else:
            self.conv_proj = nn.Conv2d(3, dim, patch_size, patch_size)
            self.class_token = nn.Parameter(torch.zeros(1, 1, dim))
            self.encoder = _TvEncoder(tokens, dim, depth, num_heads)
            self._param_std = {"class_token": 0.0}

    def forward(self, x):
        """x [B, 3, img, img] -> (cls [B, dim], patches [B, N, dim])."""
        if self.layerscale:
            conv, cls, pos = self.patch_embed.proj, self.cls_token, self.pos_embed
            blocks, norm = self.blocks, self.norm
        else:
            conv, cls, pos = self.conv_proj, self.class_token, \
                self.encoder.pos_embedding
            blocks, norm = self.encoder.layers, self.encoder.ln
        x = conv(x).flatten(2).transpose(1, 2)            # [B, N, dim]
        x = torch.cat([cls.expand(x.shape[0], -1, -1), x], dim=1) + pos
        for blk in blocks:
            x = blk(x)
        x = norm(x)
        return x[:, 0], x[:, 1:]
