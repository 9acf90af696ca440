from .stcn import PropagationNetwork, STCNFeatures
from .fusion import FusionNet
from .resnet import ResNetTrunk, feature_dims
from .qnet import QualityNet, CNNBranch
from .rl_agent import ActorCritic
from .vit import ViTEncoder
from .init import make_generator, seeded_init_

__all__ = ["PropagationNetwork", "STCNFeatures", "FusionNet", "ResNetTrunk",
           "feature_dims", "QualityNet", "CNNBranch", "ActorCritic",
           "ViTEncoder", "make_generator", "seeded_init_"]
