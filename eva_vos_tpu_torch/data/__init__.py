from .synthetic import synthetic_video

__all__ = ["synthetic_video"]
