from .eval import (
    VideoSample,
    Session,
    initialize,
    eval_session_metric,
    not_avail_frames,
    EMPTY_GT_TOKEN,
)
from .policies import (
    farthest_point_selection,
    qnet_frame_selection,
    rand_frame_selection,
    l2_frame_selection,
    upper_bound_frame_selection,
)
from .mask import (
    qnet_mask,
    rand_mask,
    oracle_mask,
    oracle_mask_dataset,
    l2_mask,
    upper_bound_mask,
)
from .multiple import (
    reward_func,
    ann_type_to_annotator_input,
    annotate,
    oracle_action,
    oracle_oracle,
    rand_type,
    rand_rand,
    rl_agent_annotate,
    eva_vos,
)

__all__ = [
    "VideoSample", "Session", "initialize", "eval_session_metric",
    "not_avail_frames", "EMPTY_GT_TOKEN",
    "farthest_point_selection", "qnet_frame_selection", "rand_frame_selection",
    "l2_frame_selection", "upper_bound_frame_selection",
    "qnet_mask", "rand_mask", "oracle_mask", "oracle_mask_dataset", "l2_mask",
    "upper_bound_mask",
    "reward_func", "ann_type_to_annotator_input", "annotate", "oracle_action",
    "oracle_oracle", "rand_type", "rand_rand", "rl_agent_annotate", "eva_vos",
]
