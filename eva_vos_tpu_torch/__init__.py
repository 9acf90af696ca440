"""eva_vos_tpu_torch — the PyTorch/CUDA port of ``eva_vos_tpu`` for NVIDIA Hopper.

Same layer map as the JAX package, module for module:

- ``ops``       L0 tensor primitives (pad/unpad, normalisation, aggregation,
                resize, the plain memory read)
- ``kernels``   hand-written CUDA kernels for ``sm_90a`` (top-k memory
                selection, weighted value readout), each beside its plain
                PyTorch version
- ``models``    L1 networks as ``nn.Module`` s loading the reference
                state-dict layout (STCN, FusionNet)
- ``engine``    L2 propagation runtime (``InferenceEngine``)
- ``data``      synthetic videos
- ``utils``     weight conversion from the JAX parameter trees

Public functions keep the JAX package's channel-last layout (``[..., H, W,
C]`` images and features, token-major ``[M, CK]`` keys, ``[K, M, CV]``
values).  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"
