"""SAM image encoder: a ViT with windowed attention and decomposed relative
position embeddings (ViT-Det style), plus a 256-channel conv neck
(counterpart of ``eva_vos_tpu/models/sam/image_encoder.py``).

State-dict layout: segment-anything's ``ImageEncoderViT``
(``patch_embed.proj``, ``pos_embed``, ``blocks.{i}.{norm1, attn.{qkv, proj,
rel_pos_h, rel_pos_w}, norm2, mlp.{lin1, lin2}}``, ``neck.{0..3}``).  Like
the official module it takes NCHW images and runs its blocks on
channel-last ``[B, H, W, C]`` tokens; it returns the NCHW embedding.  The
attention logits, their relative-position terms and the softmax are fp32
whatever the weights' dtype; LayerNorms take eps 1e-6 and the MLP's gelu
is exact.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.resize import resize_bilinear

_EPS = 1e-6


class LayerNorm2d(nn.Module):
    """LayerNorm over the channels of an NCHW tensor (segment-anything's
    ``LayerNorm2d``, eps 1e-6)."""

    is_norm = True

    def __init__(self, channels: int, eps: float = _EPS):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x):
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + self.eps)
        return self.weight[:, None, None] * x + self.bias[:, None, None]


def window_partition(x: torch.Tensor, ws: int):
    """[B, H, W, C] -> ([B*nW, ws, ws, C], padded (Hp, Wp)); zero padding at
    the bottom and right."""
    b, h, w, c = x.shape
    pad_h, pad_w = (-h) % ws, (-w) % ws
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c), (hp, wp)


def window_unpartition(windows: torch.Tensor, ws: int, padded_hw, hw):
    hp, wp = padded_hw
    h, w = hw
    b = windows.shape[0] // ((hp // ws) * (wp // ws))
    x = windows.reshape(b, hp // ws, wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """The relative-position rows for each (query, key) offset: [q, k, C].

    A table of another length (a checkpoint made for another input size)
    is first resized linearly along its length, antialiased when it
    shrinks, as ``jax.image.resize`` does; the module's own tables have the
    right length."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel_dist:
        rel_pos = resize_bilinear(rel_pos.float(),
                                  (max_rel_dist, rel_pos.shape[1]),
                                  h_axis=0, w_axis=1)
    dev = rel_pos.device
    q_coords = (torch.arange(q_size, device=dev)[:, None]
                * max(k_size / q_size, 1.0))
    k_coords = (torch.arange(k_size, device=dev)[None, :]
                * max(q_size / k_size, 1.0))
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.long()]


def add_decomposed_rel_pos(attn, q, rel_pos_h, rel_pos_w, q_hw, k_hw):
    """attn [B*heads, qh*qw, kh*kw] += the decomposed relative-position
    terms of the (unscaled) queries q [B*heads, qh*qw, C]."""
    qh, qw = q_hw
    kh, kw = k_hw
    rh = get_rel_pos(qh, kh, rel_pos_h).float()
    rw = get_rel_pos(qw, kw, rel_pos_w).float()
    b = q.shape[0]
    r_q = q.reshape(b, qh, qw, -1)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, rw)
    attn = attn.reshape(b, qh, qw, kh, kw)
    attn = attn + rel_h[..., :, None] + rel_w[..., None, :]
    return attn.reshape(b, qh * qw, kh * kw)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, input_size=(14, 14)):
        super().__init__()
        self.num_heads = num_heads
        head_dim = dim // num_heads
        self.scale = head_dim ** -0.5
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1,
                                                  head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1,
                                                  head_dim))
        self._param_std = {"rel_pos_h": 0.0, "rel_pos_w": 0.0}

    def forward(self, x):
        b, h, w, _ = x.shape
        qkv = self.qkv(x).reshape(b, h * w, 3, self.num_heads, -1)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).reshape(
            3, b * self.num_heads, h * w, -1).unbind(0)
        qf = q.float()
        attn = (qf * self.scale) @ k.float().transpose(-2, -1)
        attn = add_decomposed_rel_pos(attn, qf, self.rel_pos_h,
                                      self.rel_pos_w, (h, w), (h, w))
        attn = attn.softmax(dim=-1).to(v.dtype)
        out = (attn @ v).reshape(b, self.num_heads, h, w, -1)
        return self.proj(out.permute(0, 2, 3, 1, 4).reshape(b, h, w, -1))


class MLPBlock(nn.Module):
    def __init__(self, dim: int, mlp_dim: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, mlp_dim)
        self.lin2 = nn.Linear(mlp_dim, dim)

    def forward(self, x):
        return self.lin2(F.gelu(self.lin1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 window_size: int = 0, input_size=(64, 64)):
        super().__init__()
        self.window_size = window_size
        self.norm1 = nn.LayerNorm(dim, eps=_EPS)
        self.attn = Attention(dim, num_heads, input_size if window_size == 0
                              else (window_size, window_size))
        self.norm2 = nn.LayerNorm(dim, eps=_EPS)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio))

    def forward(self, x):
        shortcut = x
        x = self.norm1(x)
        if self.window_size > 0:
            hw = x.shape[1:3]
            x, padded = window_partition(x, self.window_size)
        x = self.attn(x)
        if self.window_size > 0:
            x = window_unpartition(x, self.window_size, padded, hw)
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, patch)

    def forward(self, x):
        return self.proj(x).permute(0, 2, 3, 1)            # [B, H, W, C]


class ImageEncoderViT(nn.Module):
    def __init__(self, img_size: int = 1024, patch_size: int = 16,
                 embed_dim: int = 1280, depth: int = 32, num_heads: int = 16,
                 mlp_ratio: float = 4.0, out_chans: int = 256,
                 window_size: int = 14,
                 global_attn_indexes=(7, 15, 23, 31)):
        super().__init__()
        grid = img_size // patch_size
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, embed_dim))
        self._param_std = {"pos_embed": 0.0}
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio,
                  0 if i in global_attn_indexes else window_size, (grid, grid))
            for i in range(depth))
        self.neck = nn.Sequential(
            nn.Conv2d(embed_dim, out_chans, 1, bias=False),
            LayerNorm2d(out_chans),
            nn.Conv2d(out_chans, out_chans, 3, padding=1, bias=False),
            LayerNorm2d(out_chans))

    def forward(self, x):
        """x [B, 3, img, img] -> [B, out_chans, S, S], S = img / patch."""
        x = self.patch_embed(x) + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        return self.neck(x.permute(0, 3, 1, 2))
