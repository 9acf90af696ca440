"""Hand-written CUDA kernels for Hopper (``sm_90a``), built at first use.

Each wrapper takes its plain PyTorch version for CPU tensors and launches its
kernel for CUDA tensors, counting launches in ``<wrapper>.launches``.
``KernelConfig`` chooses the kernels of the fused memory read.
"""

from .config import KernelConfig
from .memory_topk import (select_topk, topk_select, topk_select_chunked,
                          topk_select_grid, topk_select_plain,
                          topk_select_resident)
from .memory_readout import (topk_readout, topk_readout_chunked,
                             topk_readout_plain, fused_readout,
                             fused_readout_plain)

__all__ = ["KernelConfig", "select_topk", "topk_select",
           "topk_select_chunked", "topk_select_grid", "topk_select_plain",
           "topk_select_resident", "topk_readout", "topk_readout_chunked",
           "topk_readout_plain", "fused_readout", "fused_readout_plain"]
