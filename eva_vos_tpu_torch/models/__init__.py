from .stcn import PropagationNetwork, STCNFeatures
from .fusion import FusionNet
from .resnet import ResNetTrunk, feature_dims

__all__ = ["PropagationNetwork", "STCNFeatures", "FusionNet", "ResNetTrunk",
           "feature_dims"]
