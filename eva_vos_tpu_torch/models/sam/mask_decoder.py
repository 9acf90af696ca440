"""SAM mask decoder: two-way transformer + hypernetwork mask heads
(counterpart of ``eva_vos_tpu/models/sam/mask_decoder.py``).

Prompt tokens have a fixed count with a validity mask: attention masks the
invalid keys, which is the official variable-length token list exactly.
Every LayerNorm takes eps 1e-6, as the JAX module's (Flax's default) do:
the official decoder's ``nn.LayerNorm`` would take 1e-5.  The upscaling's
gelus are exact.

State-dict layout: segment-anything's ``MaskDecoder`` (``iou_token``,
``mask_tokens``, ``transformer.layers.{i}``,
``transformer.final_attn_token_to_image``, ``transformer.norm_final_attn``,
``output_upscaling.{0, 1, 3}``, ``output_hypernetworks_mlps.{i}.layers.{j}``,
``iou_prediction_head.layers.{j}``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .image_encoder import LayerNorm2d

NEG_INF = -1e30
_EPS = 1e-6


def _ln(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=_EPS)


class DecoderAttention(nn.Module):
    """Multi-head attention with separate q/k/v projections and an optional
    internal downsampling (the official decoder's ``Attention``)."""

    def __init__(self, embedding_dim: int, num_heads: int,
                 downsample_rate: int = 1):
        super().__init__()
        internal = embedding_dim // downsample_rate
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embedding_dim, internal)
        self.k_proj = nn.Linear(embedding_dim, internal)
        self.v_proj = nn.Linear(embedding_dim, internal)
        self.out_proj = nn.Linear(internal, embedding_dim)

    def forward(self, q, k, v, key_valid=None):
        """q [N, C], k/v [M, C]; key_valid [M] bool masks padded keys."""
        q, k, v = self.q_proj(q), self.k_proj(k), self.v_proj(v)

        def split(x):
            return x.reshape(x.shape[0], self.num_heads, -1).transpose(0, 1)

        qh, kh, vh = split(q), split(k), split(v)         # [heads, N, hd]
        attn = qh.float() @ kh.float().transpose(1, 2)
        attn = attn / (qh.shape[-1] ** 0.5)
        if key_valid is not None:
            attn = torch.where(key_valid[None, None, :], attn,
                               attn.new_full((), NEG_INF))
        attn = attn.softmax(dim=-1).to(vh.dtype)
        out = (attn @ vh).transpose(0, 1).reshape(q.shape[0], -1)
        return self.out_proj(out)


class MLPBlock(nn.Module):
    def __init__(self, dim: int, mlp_dim: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, mlp_dim)
        self.lin2 = nn.Linear(mlp_dim, dim)

    def forward(self, x):
        return self.lin2(F.relu(self.lin1(x)))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, embedding_dim: int, num_heads: int, mlp_dim: int = 2048,
                 attention_downsample_rate: int = 2,
                 skip_first_layer_pe: bool = False):
        super().__init__()
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = DecoderAttention(embedding_dim, num_heads)
        self.norm1 = _ln(embedding_dim)
        self.cross_attn_token_to_image = DecoderAttention(
            embedding_dim, num_heads, attention_downsample_rate)
        self.norm2 = _ln(embedding_dim)
        self.mlp = MLPBlock(embedding_dim, mlp_dim)
        self.norm3 = _ln(embedding_dim)
        self.norm4 = _ln(embedding_dim)
        self.cross_attn_image_to_token = DecoderAttention(
            embedding_dim, num_heads, attention_downsample_rate)

    def forward(self, queries, keys, query_pe, key_pe, token_valid):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries, token_valid)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries, token_valid)
        queries = self.norm1(queries)

        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))

        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(
            k, q, queries, token_valid))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, depth: int = 2, embedding_dim: int = 256,
                 num_heads: int = 8, mlp_dim: int = 2048):
        super().__init__()
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(embedding_dim, num_heads, mlp_dim,
                                 skip_first_layer_pe=(i == 0))
            for i in range(depth))
        self.final_attn_token_to_image = DecoderAttention(
            embedding_dim, num_heads, downsample_rate=2)
        self.norm_final_attn = _ln(embedding_dim)

    def forward(self, image_embedding, image_pe, point_embedding, token_valid):
        """image_embedding / image_pe [H, W, C]; point_embedding [N, C]."""
        c = image_embedding.shape[-1]
        keys = image_embedding.reshape(-1, c)
        key_pe = image_pe.reshape(-1, c)
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, key_pe,
                                  token_valid)
        q, k = queries + point_embedding, keys + key_pe
        queries = self.norm_final_attn(
            queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys


class HyperMLP(nn.Module):
    """The official ``MLP``: ``layers.{j}`` with ReLU between them."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int = 3):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(dims, dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MaskDecoder(nn.Module):
    def __init__(self, transformer_dim: int = 256,
                 num_multimask_outputs: int = 3, iou_head_depth: int = 3,
                 iou_head_hidden_dim: int = 256, num_heads: int = 8,
                 mlp_dim: int = 2048, depth: int = 2):
        super().__init__()
        self.num_tokens = num_multimask_outputs + 1
        self.iou_token = nn.Embedding(1, transformer_dim)
        self.mask_tokens = nn.Embedding(self.num_tokens, transformer_dim)
        self.transformer = TwoWayTransformer(depth, transformer_dim, num_heads,
                                             mlp_dim)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(transformer_dim, transformer_dim // 4, 2, 2),
            LayerNorm2d(transformer_dim // 4), nn.GELU(),
            nn.ConvTranspose2d(transformer_dim // 4, transformer_dim // 8, 2,
                               2), nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(
            HyperMLP(transformer_dim, transformer_dim, transformer_dim // 8)
            for _ in range(self.num_tokens))
        self.iou_prediction_head = HyperMLP(transformer_dim,
                                            iou_head_hidden_dim,
                                            self.num_tokens, iou_head_depth)

    def forward(self, image_embedding, image_pe, sparse_prompt, token_valid,
                dense_prompt):
        """One image.  image_embedding / image_pe / dense_prompt [H, W, C];
        sparse_prompt [N, C] with token_valid [N].  Returns (all_masks
        [1 + M, 4H, 4W] fp32 logits, all_iou [1 + M] fp32); callers take
        [1:] for multimask or [0:1] for one mask, as the official
        predictor does."""
        out_tokens = torch.cat([self.iou_token.weight,
                                self.mask_tokens.weight], dim=0)
        tokens = torch.cat([out_tokens.to(sparse_prompt.dtype),
                            sparse_prompt], dim=0)
        valid = torch.cat([token_valid.new_ones(out_tokens.shape[0]),
                           token_valid])
        src = image_embedding + dense_prompt
        hs, src_out = self.transformer(src, image_pe, tokens, valid)
        iou_token_out = hs[0]
        mask_tokens_out = hs[1:1 + self.num_tokens]

        h, w, c = image_embedding.shape
        src_img = src_out.reshape(h, w, c).permute(2, 0, 1)[None]
        upscaled = self.output_upscaling(src_img)[0]       # [C/8, 4H, 4W]
        hyper_in = torch.stack([mlp(mask_tokens_out[i]) for i, mlp in
                                enumerate(self.output_hypernetworks_mlps)])
        masks = torch.einsum("tc,chw->thw", hyper_in.float(), upscaled.float())
        iou_pred = self.iou_prediction_head(iou_token_out)
        return masks, iou_pred.float()
