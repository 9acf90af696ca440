from .agent import PPOAgent

__all__ = ["PPOAgent"]
