from .weight_convert import stcn_state_dict_from_flax, fusion_state_dict_from_flax

__all__ = ["stcn_state_dict_from_flax", "fusion_state_dict_from_flax"]
