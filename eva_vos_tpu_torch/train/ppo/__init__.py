from .env import AnnotationEnv
from .vector_env import VectorizedAnnotationEnvs
from .storage import RolloutStorage
from .rollout import rollout, batched_rollouts, compute_returns, calculate_gaes
from .trainer import PPOTrainer
from .agent import PPOAgent

__all__ = ["AnnotationEnv", "VectorizedAnnotationEnvs", "RolloutStorage",
           "rollout", "batched_rollouts", "compute_returns", "calculate_gaes",
           "PPOTrainer", "PPOAgent"]
