"""Inference-time pieces of the trainers (counterpart of
``eva_vos_tpu/train``); the trainers themselves are still to port."""
