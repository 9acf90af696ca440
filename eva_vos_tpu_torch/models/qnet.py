"""QualityNet (QNet): per-frame mask-quality scorer (counterpart of
``eva_vos_tpu/models/qnet.py``).

Two CNN branches (rgb, and the mask as 3 channels), merged by ``cat``,
``add`` or ``attn``, dropout, a linear head over 20 IoU bins.
``extract_features`` returns the merged pre-head features that the
farthest-point frame selection reads.  Eval mode (``.eval()``) means
BatchNorm's running statistics and no dropout.

State-dict layout: the reference QNet's (``rgb_branch.*`` and
``mask_branch.*`` are torchvision ResNet trunks, ``out_layer``).  The
``attn`` merge keeps the JAX module's layout, since the JAX package has no
converter for it: ``query_proj``, ``key_proj``, ``value_proj`` and
``attn_mod.{query, key, value, out}`` (Flax's single-head
``MultiHeadDotProductAttention``).  The public methods take channel-last
images ``[B, H, W, 3]``; the branches run NCHW.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .resnet import ResNetTrunk

_BRANCH_DIMS = {"small": 1024, "resnet18": 512, "resnet50": 2048,
                "resnet101": 2048}


class CNNBranch(ResNetTrunk):
    """ResNet trunk + global average pool -> feature vector.

    'small' = ResNet-50 cut at layer3 (1024-d); the others use the full
    trunk.  Takes NCHW."""

    def __init__(self, arch: str = "resnet18"):
        super().__init__("resnet50" if arch == "small" else arch,
                         num_stages=3 if arch == "small" else 4,
                         conv_bias=False)
        self.out_dim = _BRANCH_DIMS[arch]

    def forward(self, x):
        return super().forward(x)[-1].mean(dim=(2, 3))


class _SingleHeadAttention(nn.Module):
    """Flax's ``MultiHeadDotProductAttention`` with one head, as explicit
    query/key/value/out projections."""

    def __init__(self, dim: int):
        super().__init__()
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, q, k, v):
        """q [B, Nq, D], k/v [B, Nk, D] -> [B, Nq, D]."""
        q, k, v = self.query(q), self.key(k), self.value(v)
        attn = torch.softmax((q * q.shape[-1] ** -0.5) @ k.transpose(1, 2), -1)
        return self.out(attn @ v)


class QualityNet(nn.Module):
    def __init__(self, merge_strategy: str = "cat", arch: str = "resnet18",
                 n_labels: int = 20, dropout: float = 0.5):
        super().__init__()
        assert merge_strategy in {"add", "cat", "attn"}
        assert arch in _BRANCH_DIMS
        self.merge_strategy = merge_strategy
        self.rgb_branch = CNNBranch(arch)
        self.mask_branch = CNNBranch(arch)
        dim = _BRANCH_DIMS[arch]
        if merge_strategy == "attn":
            # mask features query the rgb features over one key
            self.query_proj = nn.Linear(dim, dim)
            self.key_proj = nn.Linear(dim, dim)
            self.value_proj = nn.Linear(dim, dim)
            self.attn_mod = _SingleHeadAttention(dim)
        feat_dim = 2 * dim if merge_strategy == "cat" else dim
        self.drop = nn.Dropout(dropout)
        self.out_layer = nn.Linear(feat_dim, 1 if n_labels == 2 else n_labels)

    def merge(self, rgb_out, mask_out):
        if self.merge_strategy == "add":
            return rgb_out + mask_out
        if self.merge_strategy == "attn":
            q = self.query_proj(mask_out)[:, None]
            k = self.key_proj(rgb_out)[:, None]
            v = self.value_proj(rgb_out)[:, None]
            return self.attn_mod(q, k, v)[:, 0]
        return torch.cat([rgb_out, mask_out], dim=-1)

    def features(self, x_rgb, x_mask):
        """Channel-last [B, H, W, 3] twice -> merged features [B, D]."""
        return self.merge(self.rgb_branch(x_rgb.permute(0, 3, 1, 2)),
                          self.mask_branch(x_mask.permute(0, 3, 1, 2)))

    def forward(self, x_rgb, x_mask):
        """x_rgb/x_mask [B, 224, 224, 3] -> [B, n_labels] logits."""
        return self.out_layer(self.drop(self.features(x_rgb, x_mask)))

    @torch.no_grad()
    def extract_features(self, x_rgb, x_mask):
        """Merged pre-head features for frame selection (eval mode)."""
        return self.features(x_rgb, x_mask)
