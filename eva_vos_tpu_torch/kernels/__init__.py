"""Hand-written CUDA kernels for Hopper (``sm_90a``), built at first use.

Each wrapper takes its plain PyTorch version for CPU tensors and launches its
kernel for CUDA tensors, counting launches in ``<wrapper>.launches``.
"""

from .memory_topk import topk_select, topk_select_plain
from .memory_readout import (topk_readout, topk_readout_plain, fused_readout,
                             fused_readout_plain)

__all__ = ["topk_select", "topk_select_plain", "topk_readout",
           "topk_readout_plain", "fused_readout", "fused_readout_plain"]
