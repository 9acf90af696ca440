"""eva_vos_tpu_torch — the PyTorch/CUDA port of ``eva_vos_tpu`` for NVIDIA Hopper.

Same layer map as the JAX package, module for module:

- ``ops``       L0 primitives (pad/unpad, normalisation, aggregation,
                resize, the plain memory read; masks and quality metrics,
                on the host and batched on the device; the device click
                robot's connected components)
- ``kernels``   hand-written CUDA kernels for ``sm_90a`` (top-k memory
                selection, weighted value readout), each beside its plain
                PyTorch version
- ``models``    L1 networks as ``nn.Module`` s loading the reference
                state-dict layouts (STCN, FusionNet, QualityNet,
                ActorCritic, ViT, the feature extractors, SAM)
- ``engine``    L2 propagation runtime (``InferenceEngine``)
- ``annotator`` the simulated annotator: click and box robots and the
                SAM-driven ``Annotator`` (on ``models.sam.SAMController``,
                or ``FakeSAMController`` in tests)
- ``interactions`` L4 policy loops: evaluation sessions and metrics, frame
                selection, the mask loops and the multi-type loops
- ``train``     the QNet trainer, and PPO: storage, rollouts, the annotation
                environments (one, or a fleet on batched SAM), the
                trainer and the inference-time agent
- ``data``      synthetic videos, the datasets over the on-disk trees, a
                PNG codec
- ``utils``     annotation costs, wall-clock spans and device traces, weight
                conversion from the JAX parameter trees, config, logging,
                checkpoints, the model zoo and the CSV tables
- ``parallel``  the process group and its mesh, batch and video shards,
                the collectives, the bank-sharded memory read and the
                multi-process dry run
- ``native``    the click robot's C++ union-find, built with g++ at first
                use
- ``vis``       the experiment CSVs' curves and ranking, plots, overlays
- ``cli``       the main experiment CLI, the two dataset generators, the
                two trainers and the two download CLIs

Public functions keep the JAX package's channel-last layout (``[..., H, W,
C]`` images and features, token-major ``[M, CK]`` keys, ``[K, M, CV]``
values).  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"
