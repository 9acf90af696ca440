"""Plain reference of an EVA-VOS round's networks, in plain PyTorch.

It imports nothing of the program.  Beside the STCN engine with MiVOS
fusion (``stcn_mivos.py``), it holds frozen copies of the port's plain
modules for the flagship policy's other networks, laid out as their
published state dicts:

* SAM (Kirillov et al., ICCV 2023; facebookresearch/segment-anything,
  ``build_sam_vit_h``): the ViT image encoder with windowed attention and
  decomposed relative positions, the prompt encoder and the two-way mask
  decoder, behind the official predictor's pre-processing (longest side to
  1,024, pixel normalisation, bottom-right padding);
* QNet (EVA-VOS, Delatolas et al., WACV 2024; thanosDelatolas/eva-vos):
  two ResNet-18 branches, rgb and mask, pooled and concatenated: the
  features the frame selection reads;
* the PPO agent's actor-critic: SAM's embedding pooled through a linear
  layer beside a ResNet-18 mask branch, then the policy and value heads;

and the inputs the policy makes from a frame: the annotator's uint8 image
(the frame normalised and back, as ``annotator.py``'s ``inv_im_trans``) and
QNet's 224-pixel frames (bicubic, antialiased).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference import stcn_mivos as stcn

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


# ---------------------------------------------------------------- SAM

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
    """The relative-position rows for each (query, key) offset: [q, k, C]."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel_dist:
        raise ValueError("a relative-position table of another length")
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


NEG_INF = -1e30


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


class DecoderMLPBlock(nn.Module):
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
        self.mlp = DecoderMLPBlock(embedding_dim, mlp_dim)
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


class Sam(nn.Module):
    """Image encoder + prompt encoder + mask decoder (``cfg``: the
    configuration's ``sam`` sizes)."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        grid = cfg["img_size"] // cfg["patch_size"]
        self.image_encoder = ImageEncoderViT(
            img_size=cfg["img_size"], patch_size=cfg["patch_size"],
            embed_dim=cfg["encoder_embed_dim"], depth=cfg["encoder_depth"],
            num_heads=cfg["encoder_num_heads"], out_chans=cfg["prompt_embed_dim"],
            window_size=cfg["window_size"],
            global_attn_indexes=tuple(cfg["encoder_global_attn_indexes"]))
        self.prompt_encoder = PromptEncoder(
            embed_dim=cfg["prompt_embed_dim"], image_embedding_size=(grid, grid),
            input_image_size=(cfg["img_size"], cfg["img_size"]),
            mask_in_chans=cfg["mask_in_chans"])
        self.mask_decoder = MaskDecoder(
            transformer_dim=cfg["prompt_embed_dim"],
            num_heads=cfg["decoder_num_heads"], mlp_dim=cfg["decoder_mlp_dim"])

    @property
    def dtype(self):
        return self.image_encoder.pos_embed.dtype

    def preprocess(self, image: np.ndarray) -> torch.Tensor:
        """uint8 [H, W, 3] -> [1, img, img, 3]: longest side to ``img_size``
        (bilinear, half-pixel), normalised, padded bottom and right."""
        img = self.cfg["img_size"]
        h, w = image.shape[:2]
        scale = img / max(h, w)
        newh, neww = int(h * scale + 0.5), int(w * scale + 0.5)
        dev = self.image_encoder.pos_embed.device
        x = torch.as_tensor(np.ascontiguousarray(image), device=dev).float()
        x = F.interpolate(x.permute(2, 0, 1)[None], size=(newh, neww),
                          mode="bilinear", align_corners=False,
                          antialias=newh < h or neww < w)
        x = (x - torch.tensor(PIXEL_MEAN, device=dev)[:, None, None]) \
            / torch.tensor(PIXEL_STD, device=dev)[:, None, None]
        x = F.pad(x, (0, img - neww, 0, img - newh))
        return x.permute(0, 2, 3, 1)

    @torch.no_grad()
    def embed(self, image: np.ndarray) -> torch.Tensor:
        """uint8 [H, W, 3] -> the embedding [S, S, C] (float32)."""
        x = self.preprocess(image).to(self.dtype).permute(0, 3, 1, 2)
        return self.image_encoder(x)[0].permute(1, 2, 0).float()

    @torch.no_grad()
    def decode(self, embedding, coords, labels, mask_input):
        """embedding [S, S, C]; coords [N, 2] and labels [N] as the
        predictor pads them; mask_input [low, low] logits or None.
        Returns (all low-res mask logits [1 + M, low, low], all IoU
        predictions [1 + M]), float32."""
        dev, dt = embedding.device, self.dtype
        low = self.cfg["img_size"] // 4
        has_mask = mask_input is not None
        m = (torch.as_tensor(mask_input, device=dev).float().reshape(low, low)
             if has_mask else torch.zeros((low, low), device=dev))
        sparse, valid, dense, pe = self.prompt_encoder(
            torch.as_tensor(coords, device=dev), torch.as_tensor(labels, device=dev),
            m.to(dt), has_mask)
        masks, iou = self.mask_decoder(embedding.to(dt), pe.to(dt), sparse.to(dt),
                                       valid, dense.to(dt))
        return masks.float(), iou.float()


# ---------------------------------------------------------------- QNet, agent

class CNNBranch(stcn.Trunk):
    """A torchvision ResNet trunk, globally average-pooled."""

    def __init__(self, arch):
        super().__init__(arch, False, 3, ("layer1", "layer2", "layer3", "layer4"))

    def forward(self, x):
        return super().forward(x)[-1].mean(dim=(2, 3))


class QualityNet(nn.Module):
    """QNet with the ``cat`` merge; ``features`` is what the selection reads."""

    def __init__(self, arch="resnet18", n_labels=20):
        super().__init__()
        self.rgb_branch = CNNBranch(arch)
        self.mask_branch = CNNBranch(arch)
        dim = 64 * 8 * stcn.ARCHS[arch][0].expansion
        self.out_layer = nn.Linear(2 * dim, n_labels)

    @torch.no_grad()
    def features(self, x_rgb, x_mask):
        """[B, 224, 224, 3] twice -> [B, 2 * dim]."""
        return torch.cat([self.rgb_branch(x_rgb.permute(0, 3, 1, 2)),
                          self.mask_branch(x_mask.permute(0, 3, 1, 2))], dim=-1)


class ActorCritic(nn.Module):
    def __init__(self, out_dim=2, arch="resnet18", embed_dim=256):
        super().__init__()
        dim = 64 * 8 * stcn.ARCHS[arch][0].expansion
        self.embed_branch = nn.Sequential(nn.AdaptiveAvgPool2d(1), nn.Flatten(),
                                          nn.Linear(embed_dim, dim))
        self.mask_branch = CNNBranch(arch)
        self.policy = nn.Linear(2 * dim, out_dim)
        self.value = nn.Linear(2 * dim, 1)

    @torch.no_grad()
    def forward(self, x_img, x_mask):
        """x_img [B, S, S, C] SAM embedding, x_mask [B, 224, 224, 3] ->
        (policy logits [B, out_dim], value [B, 1])."""
        x = torch.cat([self.embed_branch(x_img.permute(0, 3, 1, 2)),
                       self.mask_branch(x_mask.permute(0, 3, 1, 2))], dim=-1)
        return self.policy(x), self.value(x)


# ---------------------------------------------------------------- inputs

def annotator_image(frame_u8: np.ndarray) -> np.ndarray:
    """The uint8 image the annotator gives SAM: the frame as float in
    [0, 1], ImageNet-normalised, then back (float32 throughout)."""
    mean = np.asarray(stcn.IMAGENET_MEAN, np.float32)
    std = np.asarray(stcn.IMAGENET_STD, np.float32)
    im = (frame_u8.astype(np.float32) / 255.0 - mean) / std
    return (np.clip(im * std + mean, 0.0, 1.0) * 255).astype(np.uint8)


def frames_224(frames_u8: np.ndarray, device) -> torch.Tensor:
    """[T, H, W, 3] uint8 -> [T, 224, 224, 3] normalised, bicubic
    (a = -0.5), antialiased."""
    x = torch.as_tensor(frames_u8, device=device).float() / 255.0
    mean = torch.tensor(stcn.IMAGENET_MEAN, device=device)
    std = torch.tensor(stcn.IMAGENET_STD, device=device)
    x = ((x - mean) / std).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(224, 224), mode="bicubic", align_corners=False,
                      antialias=True)
    return x.permute(0, 2, 3, 1)


# ---------------------------------------------------------------- build

def templates(config) -> dict:
    """{network: its layout on the meta device}, for the seeded weights."""
    out = stcn.templates(config)
    q, a = config["qnet"], config["agent"]
    with torch.device("meta"):
        out["qnet"] = QualityNet(q["arch"], q["n_labels"])
        out["agent"] = ActorCritic(a["actions"], a["arch"], config["sam"]["prompt_embed_dim"])
        out["sam"] = Sam(config["sam"])
    return out


class Reference(stcn.Reference):
    """The engine's reference and the policy's networks."""

    def __init__(self, config, state_dicts, device, dtype=torch.float32):
        super().__init__(config, state_dicts, device, dtype)
        q, a = config["qnet"], config["agent"]
        self.qnet = QualityNet(q["arch"], q["n_labels"])
        self.agent = ActorCritic(a["actions"], a["arch"], config["sam"]["prompt_embed_dim"])
        self.sam = Sam(config["sam"])
        for name, net in (("qnet", self.qnet), ("agent", self.agent), ("sam", self.sam)):
            net.load_state_dict(state_dicts[name])
            net.to(device, torch.float32).eval()


def work_units(config, num_objects: int = 1) -> dict:
    """``stcn_mivos.work_units`` and the policy's: ``sam_encode`` an
    image, ``sam_decode`` one prompt set, ``qnet`` one frame, ``agent``
    one decision."""
    units = stcn.work_units(config, num_objects)
    t = templates(config)
    s = config["sam"]
    grid, low = s["img_size"] // s["patch_size"], s["img_size"] // 4
    c = s["prompt_embed_dim"]

    def meta(*shape):
        return torch.zeros(shape, device="meta")

    def sam_decode():
        sparse, valid, dense, pe = t["sam"].prompt_encoder(
            meta(8, 2), torch.zeros(8, dtype=torch.long, device="meta"),
            meta(low, low), True)
        t["sam"].mask_decoder(meta(grid, grid, c), pe, sparse, valid, dense)

    units.update(
        sam_encode=lambda: t["sam"].image_encoder(meta(1, 3, s["img_size"], s["img_size"])),
        sam_decode=sam_decode,
        qnet=lambda: t["qnet"].features(meta(1, 224, 224, 3), meta(1, 224, 224, 3)),
        agent=lambda: t["agent"](meta(1, grid, grid, c), meta(1, 224, 224, 3)))
    return units


read_flops = stcn.read_flops
