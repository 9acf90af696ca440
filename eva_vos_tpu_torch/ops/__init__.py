from .padding import compute_pad, pad_hw, unpad_hw, pad_divide_by
from .aggregate import aggregate_wbg
from .normalize import IMAGENET_MEAN, IMAGENET_STD, im_normalize
from .resize import resize_bilinear, upsample2x, area_downsample
from .memory_attention import (
    NEG_INF,
    memory_readout,
    resolve_strategy,
    memory_affinity_topk,
    topk_scores,
    full_softmax_affinity,
)

__all__ = [
    "compute_pad",
    "pad_hw",
    "unpad_hw",
    "pad_divide_by",
    "aggregate_wbg",
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "im_normalize",
    "resize_bilinear",
    "upsample2x",
    "area_downsample",
    "NEG_INF",
    "memory_readout",
    "resolve_strategy",
    "memory_affinity_topk",
    "topk_scores",
    "full_softmax_affinity",
]
