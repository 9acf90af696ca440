"""Checkpoints as ``torch.save`` files (counterpart of
``eva_vos_tpu/utils/checkpoint.py``, which writes orbax trees).

A model is saved as its state dict in the reference layout, BatchNorm's
running statistics included as buffers, so a trained QNet or ActorCritic
loads straight into the port's modules (``model_zoo``) and, through
``load_torch_state_dict`` and ``convert_qnet`` / ``convert_actor_critic``,
into the JAX package's.  Extra scalars (the PPO resume file's ``iters`` and
``max_reward``) go beside the weights as ``{"state_dict": ..., **extra}``,
the nesting that both packages' loaders unwrap.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch


def save_checkpoint(path, state_dict, **extra):
    """Write ``state_dict`` (tensors, moved to the host) and ``extra``
    (ints / floats) to ``path``, replacing it whole."""
    sd = {k: v.detach().cpu() for k, v in state_dict.items()}
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    torch.save({"state_dict": sd, **extra} if extra else sd, tmp)
    os.replace(tmp, path)


def restore_checkpoint(path, map_location="cpu"):
    """-> (state dict, extras dict); ``weights_only`` loading."""
    obj = torch.load(path, map_location=map_location, weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        return obj["state_dict"], {k: v for k, v in obj.items()
                                   if k != "state_dict"}
    return obj, {}
