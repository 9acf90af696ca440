from .build import PRESETS, Sam, SamConfig, build_sam
from .predictor import SAMController, SamPredictor

__all__ = ["PRESETS", "Sam", "SamConfig", "build_sam", "SamPredictor",
           "SAMController"]
