from .costs import ANNOTATION_COSTS
from .profiling import WallClock, device_trace
from .weight_convert import stcn_state_dict_from_flax, fusion_state_dict_from_flax

__all__ = ["ANNOTATION_COSTS", "WallClock", "device_trace",
           "stcn_state_dict_from_flax", "fusion_state_dict_from_flax"]
