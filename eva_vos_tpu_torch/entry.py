"""The port's two entry points (counterpart of the repository root's
``__graft_entry__.py``).

``entry()``           one propagation step of the flagship model at 480x864
                      in bf16: ``encode_key``, the top-k memory read of a
                      4-frame bank, ``decode_with_readout``, then
                      ``aggregate_wbg``.  The read resolves the engine's
                      'auto' strategy: 'fused' on a CUDA device (the
                      selection kernel #1 chained into the readout kernel
                      #2), the plain 'gather' read on the CPU.
``dryrun_multichip``  the multi-process dry run
                      (``eva_vos_tpu_torch.parallel.dryrun``): the
                      two-process multi-host rehearsal, then every
                      data-parallel and bank-sharded path against its
                      one-process result.

Both run on the card unless the caller passes ``device="cpu"``::

    from eva_vos_tpu_torch.entry import entry
    step, args = entry()          # args: (net, frame, mem_k, mem_v)
    prob = step(*args)            # [2, 480, 864] fp32

    python -m eva_vos_tpu_torch.entry      # dryrun_multichip(8)
"""

from __future__ import annotations

import numpy as np
import torch

from .models import PropagationNetwork
from .models.init import make_generator, seeded_init_
from .ops import aggregate_wbg, memory_readout, resolve_strategy
from .parallel import dryrun_multichip

__all__ = ["entry", "dryrun_multichip"]

TOP_K = 50


def entry(*, device="cuda", strategy: str = "auto", state_dict=None,
          h: int = 480, w: int = 864, mem_frames: int = 4,
          dtype: torch.dtype = torch.bfloat16, keydim: int = 64):
    """One propagation step and its arguments: ``(step, (net, frame,
    mem_k, mem_v))``; ``step(*args)`` returns [2, h, w] fp32
    probabilities (background, object).

    ``net`` is the flagship ``PropagationNetwork`` (resnet50 keys
    ``keydim`` wide, 64 by default; resnet18 values 512 wide) on ``device``
    in ``dtype``, in eval mode, with ``state_dict``'s weights (for example
    a JAX tree carried across by ``utils.stcn_state_dict_from_flax``) or
    seeded random ones (``models.init.seeded_init_`` from a generator
    seeded 0).  The inputs
    are drawn from ``np.random.default_rng(0)`` in the JAX entry's order:
    ``frame`` [h, w, 3], ``mem_k`` [M, keydim], ``mem_v`` [1, M, 512] with
    M = mem_frames x (h/16) x (w/16) tokens, each cast to ``dtype``
    through float32, as the JAX package casts them.  The read takes the
    top 50 tokens a query by ``strategy``, 'auto' resolved as the engine
    resolves it.  A CUDA ``device`` with no CUDA device raises.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("entry: no CUDA device; pass device='cpu' to run "
                           "the step on the CPU")
    h16, w16 = h // 16, w // 16
    hw = h16 * w16
    read = resolve_strategy(strategy, device)

    net = PropagationNetwork(keydim=keydim)
    if state_dict is None:
        seeded_init_(net, make_generator(0, "cpu"))
    else:
        net.load_state_dict(state_dict)
    net = net.to(device=device, dtype=dtype).eval()

    def step(net, frame, mem_k, mem_v):
        with torch.inference_mode():
            feats = net.encode_key(frame[None])
            qk = feats.k16[0].reshape(hw, -1).contiguous()
            readout = memory_readout(mem_k, qk, mem_v, top_k=TOP_K,
                                     strategy=read)
            readout = readout.reshape(mem_v.shape[0], h16, w16, -1)
            prob = net.decode_with_readout(readout, feats.f16_thin[0],
                                           feats.f8[0], feats.f4[0])
            return aggregate_wbg(prob.float(), keep_bg=True)

    rng = np.random.default_rng(0)
    draws = [rng.standard_normal((h, w, 3)),
             rng.standard_normal((mem_frames * hw, net.keydim)),
             rng.standard_normal((1, mem_frames * hw, net.value_dim))]
    frame, mem_k, mem_v = (
        torch.from_numpy(x.astype(np.float32)).to(device=device, dtype=dtype)
        for x in draws)
    return step, (net, frame, mem_k, mem_v)


if __name__ == "__main__":
    dryrun_multichip(8)
