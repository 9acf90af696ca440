"""SAM prompt encoder: points / boxes / mask logits -> embeddings
(counterpart of ``eva_vos_tpu/models/sam/prompt_encoder.py``).

Prompts arrive as a fixed-size padded array of (coord, label) pairs, with
the JAX package's labels:

    -2  padding slot      -> contributes nothing (masked out of attention)
    -1  not-a-point       -> not_a_point_embed (the official pad token)
     0  negative click    -> point_embeddings[0]
     1  positive click    -> point_embeddings[1]
     2  box corner (tl)   -> point_embeddings[2]
     3  box corner (br)   -> point_embeddings[3]

State-dict layout: segment-anything's ``PromptEncoder`` (``pe_layer``,
``point_embeddings.{0..3}``, ``not_a_point_embed``, ``no_mask_embed``,
``mask_downscaling.{0, 1, 3, 4, 6}``).  The mask downscaler's LayerNorms
take eps 1e-6 and its gelus are exact.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from .image_encoder import LayerNorm2d

PAD_LABEL = -2
NOT_A_POINT = -1


class PositionEmbeddingRandom(nn.Module):
    """Random-Fourier positional encoding (official semantics)."""

    def __init__(self, num_pos_feats: int = 64, scale: float = 1.0):
        super().__init__()
        self.positional_encoding_gaussian_matrix = nn.Parameter(
            torch.zeros(2, num_pos_feats), requires_grad=False)
        self._param_std = {"positional_encoding_gaussian_matrix": scale}

    def forward(self, coords01: torch.Tensor) -> torch.Tensor:
        """coords01 [..., 2] in [0, 1] -> [..., 2 * num_pos_feats]."""
        c = 2.0 * coords01 - 1.0
        c = 2.0 * math.pi * (c @ self.positional_encoding_gaussian_matrix)
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)

    def grid_pe(self, size) -> torch.Tensor:
        """Dense encoding of an image grid: [H, W, C]."""
        h, w = size
        dev = self.positional_encoding_gaussian_matrix.device
        ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        return self(torch.stack([gx, gy], dim=-1))


class PromptEncoder(nn.Module):
    def __init__(self, embed_dim: int = 256, image_embedding_size=(64, 64),
                 input_image_size=(1024, 1024), mask_in_chans: int = 16):
        super().__init__()
        self.embed_dim = embed_dim
        self.image_embedding_size = tuple(image_embedding_size)
        self.input_image_size = tuple(input_image_size)
        self.pe_layer = PositionEmbeddingRandom(embed_dim // 2)
        self.point_embeddings = nn.ModuleList(
            nn.Embedding(1, embed_dim) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, embed_dim)
        self.no_mask_embed = nn.Embedding(1, embed_dim)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, mask_in_chans // 4, 2, 2),
            LayerNorm2d(mask_in_chans // 4), nn.GELU(),
            nn.Conv2d(mask_in_chans // 4, mask_in_chans, 2, 2),
            LayerNorm2d(mask_in_chans), nn.GELU(),
            nn.Conv2d(mask_in_chans, embed_dim, 1))

    def get_dense_pe(self) -> torch.Tensor:
        """[H, W, embed_dim] positional encoding of the embedding grid."""
        return self.pe_layer.grid_pe(self.image_embedding_size)

    def embed_points(self, coords: torch.Tensor, labels: torch.Tensor):
        """coords [N, 2] (x, y) in input-image pixels; labels [N] int.
        Returns (sparse embeddings [N, C], valid [N] bool)."""
        pts = (coords.float() + 0.5) / torch.tensor(
            [self.input_image_size[1], self.input_image_size[0]],
            dtype=torch.float32, device=coords.device)
        pe = self.pe_layer(pts)
        lab = labels[:, None]
        zero = pe.new_zeros(())
        emb = torch.where(lab == NOT_A_POINT, self.not_a_point_embed.weight,
                          zero)
        emb = emb + torch.where(lab == NOT_A_POINT, zero, pe)
        for li in range(4):
            emb = emb + torch.where(lab == li,
                                    self.point_embeddings[li].weight, zero)
        emb = torch.where(lab == PAD_LABEL, zero, emb)
        return emb, labels != PAD_LABEL

    def embed_masks(self, mask_input: torch.Tensor, has_mask: bool):
        """mask_input [4H, 4W] logits -> dense [H, W, C]; the no-mask
        embedding when ``has_mask`` is false (the input is then unused)."""
        h, w = self.image_embedding_size
        if not has_mask:
            return self.no_mask_embed.weight.reshape(1, 1, -1).expand(
                h, w, self.embed_dim)
        x = self.mask_downscaling(mask_input[None, None])
        return x[0].permute(1, 2, 0)

    def forward(self, coords, labels, mask_input, has_mask: bool):
        sparse, valid = self.embed_points(coords, labels)
        dense = self.embed_masks(mask_input, has_mask)
        return sparse, valid, dense, self.get_dense_pe()
