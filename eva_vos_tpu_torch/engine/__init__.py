from .propagation import (EngineConfig, InferenceEngine, PropagationState,
                          VideoFeatures, pad_mask, prepare_video)

__all__ = ["EngineConfig", "InferenceEngine", "PropagationState",
           "VideoFeatures", "pad_mask", "prepare_video"]
