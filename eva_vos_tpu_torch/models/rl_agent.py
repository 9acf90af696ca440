"""ActorCritic: the annotation-type policy network (counterpart of
``eva_vos_tpu/models/rl_agent.py``).

A mask branch (``CNNBranch`` on the 224-resized mask as 3 channels, or a
torchvision-layout ``ViTEncoder`` for the ``vit_*`` archs) and a SAM
embedding branch (global average pool over the 64x64 grid + Linear(256 ->
dim)), optionally a cost branch (Linear + ReLU), concatenated, dropout, then
the policy and value heads.

State-dict layout: the reference actor-critic's (``mask_branch.*``,
``embed_branch.2``, ``cost_branch.0``, ``policy``, ``value``).  Inputs are
channel-last, as the JAX module takes them: ``x_img`` [B, 64, 64, 256],
``x_mask`` [B, 224, 224, 3].
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .qnet import CNNBranch, _BRANCH_DIMS
from .vit import ViTEncoder

_VIT_DIMS = {"vit_b_16": 768, "vit_b_32": 768, "vit_l_32": 1024}


class ActorCritic(nn.Module):
    def __init__(self, out_dim: int = 2, arch: str = "resnet18",
                 dropout: float = 0.5, use_cost: bool = False,
                 embed_dim: int = 256, cost_dim: int = 1):
        super().__init__()
        self.is_vit = "vit" in arch
        dim = _VIT_DIMS[arch] if self.is_vit else _BRANCH_DIMS[arch]
        self.embed_branch = nn.Sequential(nn.AdaptiveAvgPool2d(1),
                                          nn.Flatten(),
                                          nn.Linear(embed_dim, dim))
        if self.is_vit:
            large = arch.startswith("vit_l")
            self.mask_branch = ViTEncoder(
                patch_size=32 if arch.endswith("_32") else 16, dim=dim,
                depth=24 if large else 12, num_heads=16 if large else 12,
                img_size=224)
        else:
            self.mask_branch = CNNBranch(arch)
        self.use_cost = use_cost
        parts = 3 if use_cost else 2
        if use_cost:
            self.cost_branch = nn.Sequential(nn.Linear(cost_dim, dim),
                                             nn.ReLU())
        self.drop = nn.Dropout(dropout)
        self.policy = nn.Linear(parts * dim, out_dim)
        self.value = nn.Linear(parts * dim, 1)

    def forward(self, x_img, x_mask, x_cost=None):
        """Returns (policy logits [B, out_dim], value [B, 1])."""
        embed = self.embed_branch(x_img.permute(0, 3, 1, 2))
        mask_out = self.mask_branch(x_mask.permute(0, 3, 1, 2))
        if self.is_vit:
            mask_out = mask_out[0]
        parts = [embed, mask_out]
        if self.use_cost:
            assert x_cost is not None
            parts.append(self.cost_branch(x_cost))
        x = self.drop(torch.cat(parts, dim=-1))
        return self.policy(x), self.value(x)
