"""Trainers (counterpart of ``eva_vos_tpu/train``): the QNet trainer here,
PPO with its environments, storage and inference-time agent in ``ppo``."""

from .qnet import QNetTrainer, QNetTrainState

__all__ = ["QNetTrainer", "QNetTrainState"]
