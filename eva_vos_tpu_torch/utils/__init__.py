from .costs import ANNOTATION_COSTS
from .profiling import WallClock, device_trace
from .weight_convert import (
    stcn_state_dict_from_flax, fusion_state_dict_from_flax,
    qnet_state_dict_from_flax, actor_critic_state_dict_from_flax,
    tv_resnet_state_dict_from_flax, tv_vit_state_dict_from_flax,
    dinov2_state_dict_from_flax, sam_state_dict_from_flax)

__all__ = ["ANNOTATION_COSTS", "WallClock", "device_trace",
           "stcn_state_dict_from_flax", "fusion_state_dict_from_flax",
           "qnet_state_dict_from_flax", "actor_critic_state_dict_from_flax",
           "tv_resnet_state_dict_from_flax", "tv_vit_state_dict_from_flax",
           "dinov2_state_dict_from_flax", "sam_state_dict_from_flax"]
