from .padding import compute_pad, pad_hw, unpad_hw, pad_divide_by
from .aggregate import aggregate_wbg, aggregate_sbg, aggregate_wbg_channel
from .normalize import (IMAGENET_MEAN, IMAGENET_STD, im_normalize,
                        im_denormalize)
from .resize import (resize_bilinear, resize_bicubic, resize_nearest,
                     upsample2x, area_downsample)
from .masks import all_to_onehot, masks_to_boxes
from .memory_attention import (
    NEG_INF,
    memory_readout,
    resolve_strategy,
    memory_affinity_topk,
    memory_affinity_topk_gauss,
    topk_scores,
    full_softmax_affinity,
)

__all__ = [
    "compute_pad",
    "pad_hw",
    "unpad_hw",
    "pad_divide_by",
    "aggregate_wbg",
    "aggregate_sbg",
    "aggregate_wbg_channel",
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "im_normalize",
    "im_denormalize",
    "resize_bilinear",
    "resize_bicubic",
    "resize_nearest",
    "upsample2x",
    "area_downsample",
    "all_to_onehot",
    "masks_to_boxes",
    "NEG_INF",
    "memory_readout",
    "resolve_strategy",
    "memory_affinity_topk",
    "memory_affinity_topk_gauss",
    "topk_scores",
    "full_softmax_affinity",
]
