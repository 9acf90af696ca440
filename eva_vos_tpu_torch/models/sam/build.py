"""SAM model assembly and size presets (counterpart of
``eva_vos_tpu/models/sam/build.py``).

Presets mirror the official vit_h / vit_l / vit_b checkpoints; ``tiny``
backs the tests.  ``build_sam`` builds the model on its device and fills it
from a seeded ``torch.Generator`` there; an official checkpoint loads over
it with ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn as nn

from .image_encoder import ImageEncoderViT
from .mask_decoder import MaskDecoder
from .prompt_encoder import PromptEncoder
from ..init import make_generator, seeded_init_

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


@dataclass(frozen=True)
class SamConfig:
    img_size: int = 1024
    patch_size: int = 16
    encoder_embed_dim: int = 1280
    encoder_depth: int = 32
    encoder_num_heads: int = 16
    encoder_global_attn_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    window_size: int = 14
    prompt_embed_dim: int = 256
    decoder_num_heads: int = 8
    decoder_mlp_dim: int = 2048
    mask_in_chans: int = 16

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size

    @property
    def low_res(self) -> int:
        return self.img_size // 4


PRESETS = {
    "vit_h": SamConfig(),
    "vit_l": SamConfig(encoder_embed_dim=1024, encoder_depth=24,
                       encoder_num_heads=16,
                       encoder_global_attn_indexes=(5, 11, 17, 23)),
    "vit_b": SamConfig(encoder_embed_dim=768, encoder_depth=12,
                       encoder_num_heads=12,
                       encoder_global_attn_indexes=(2, 5, 8, 11)),
    # tests: 128 px input, an 8x8 embedding grid, a 32-d decoder
    "tiny": SamConfig(img_size=128, encoder_embed_dim=32, encoder_depth=2,
                      encoder_num_heads=2, encoder_global_attn_indexes=(1,),
                      window_size=4, prompt_embed_dim=32,
                      decoder_num_heads=2, decoder_mlp_dim=64,
                      mask_in_chans=4),
}


class Sam(nn.Module):
    """Image encoder + prompt encoder + mask decoder."""

    def __init__(self, config: SamConfig = SamConfig()):
        super().__init__()
        c = self.config = config
        self.image_encoder = ImageEncoderViT(
            img_size=c.img_size, patch_size=c.patch_size,
            embed_dim=c.encoder_embed_dim, depth=c.encoder_depth,
            num_heads=c.encoder_num_heads, out_chans=c.prompt_embed_dim,
            window_size=c.window_size,
            global_attn_indexes=c.encoder_global_attn_indexes)
        self.prompt_encoder = PromptEncoder(
            embed_dim=c.prompt_embed_dim, image_embedding_size=(c.grid, c.grid),
            input_image_size=(c.img_size, c.img_size),
            mask_in_chans=c.mask_in_chans)
        self.mask_decoder = MaskDecoder(
            transformer_dim=c.prompt_embed_dim, num_heads=c.decoder_num_heads,
            mlp_dim=c.decoder_mlp_dim)

    @property
    def dtype(self) -> torch.dtype:
        return self.image_encoder.pos_embed.dtype

    @torch.no_grad()
    def encode_image(self, x):
        """x [B, img_size, img_size, 3] preprocessed -> [B, S, S, C]."""
        emb = self.image_encoder(x.to(self.dtype).permute(0, 3, 1, 2))
        return emb.permute(0, 2, 3, 1)

    @torch.no_grad()
    def decode(self, embedding, coords, labels, mask_input, has_mask: bool):
        """embedding [S, S, C]; coords [N, 2]; labels [N]; mask_input
        [low_res, low_res]; has_mask a bool.  Returns (masks [1 + M, 4S, 4S]
        logits, iou [1 + M])."""
        sparse, valid, dense, image_pe = self.prompt_encoder(
            coords, labels, mask_input.to(self.dtype), has_mask)
        dt = self.dtype
        return self.mask_decoder(embedding.to(dt), image_pe.to(dt),
                                 sparse.to(dt), valid, dense.to(dt))


def build_sam(preset: str = "vit_h", dtype=torch.float32, seed: int = 0,
              device="cuda") -> Sam:
    """A ``Sam`` in eval mode with random weights from ``seed``, made on
    ``device``."""
    with torch.device(device):
        sam = Sam(PRESETS[preset])
    seeded_init_(sam, make_generator(seed, device))
    return sam.to(dtype).eval()
