"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the repository root, one card

Phases, each of which raises on failure (so no failure ends with exit 0):

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``eva_vos_tpu_torch/kernels/csrc`` (one
   ``nvcc`` per library, all at once: each selection's source once for
   each key width, ``build.LIBRARIES``); print each kernel's registers and
   spills, and the HMMA (tensor-core) instructions in the SASS of the
   libraries (every width) of the selections that score bf16 keys on the
   tensor cores (``cuobjdump``): the default and newest-first (``memory_topk``), the
   resident (``memory_topk_resident``), the 'select' read's
   (``memory_topk_grid``), the iterative (``memory_topk_iter``) and the
   sort selection's;
3. the six top-k selection kernels (oldest first, newest first with the
   running floor, resident (query tiles walking the bank newest first),
   the 'select' read's, and through ``select_topk`` its default, the
   iterative one (the resident walk writing [N, k] rows), and per-block
   sort) against their plain versions at the engine's blocked-step shape
   (N = 5 x 1620 queries, CK = 64, top_k = 50, bf16) on banks of 1, 12 and
   72 slots of 1620 tokens, random and clustered, and at a single-frame
   step (N = 1620).  The newest-first
   selection is also checked and timed with ``no_skip`` (its floor off).
   The library yardstick of every selection is the dense score product as
   one ``torch.addmm`` (TF32 off and on, the faster kept) and ``torch.topk``
   together (``torch.topk`` alone on the plain scores is printed as
   ``topk_only``).  For the selections on the pruned block stage also their
   block and merge kernels' device times (``torch.profiler``; with one live
   bank block no merge is launched), the rows that took their exact
   escalation and, for the newest-first one, the rows its floor emptied;
   for the two on the resident walk (resident, iterative) their bank
   segments, their compactions of full candidate buffers and their walk
   and merge kernels' device times (no merge with one segment);
   and, on the 72-slot clustered bank at N = 8100, the sort and the
   iterative kernels at top_k = 256 (32-query tiles and 512-key buffers in
   the walk; each row of the sort kernel keeps more candidates than it
   ranks one by one);
4. the two readout kernels against their plain version, ``F.embedding_bag``
   and their bound on the oldest-first selection of every case of phase 3
   (K = 1, CV = 512; K = 2 too on the 72-slot banks at N = 8100), with each
   case's distinct rows and picks per 64-query tile; each must agree bit
   for bit with a second run, the chunked one (the readout stage) with its
   ``no_skip`` too, and it must count as many staged rows as the plan;
5. the selection entry point ``select_topk`` at N = 8100 on a 72-slot
   clustered bank, with no method and with method="sort": the launch
   counters, zeroed just before each call, must show the iterative and the
   sort kernel launched, and the weights and ids must match the plain
   version;
6. the engine at full width (T = 60, 480x854, resnet50/resnet18, top_k=50,
   mem_freq=5, bf16, random seeded weights), features computed once, under
   each memory read: the default 'fused' (oldest-first selection, grid
   readout), 'select' (split-bank selection + gather), and 'fused' with
   the resident selection, and with the newest-first selection and the
   chunked readout.  Each read: a warm-up ``interact`` at frame 0; then
   ENGINE_ITERS timed ones per read with the reads interleaved round-robin
   (fps as median and range), then FRAME30_ITERS untraced ones at frame 30
   from the frame-0 state (its backward pass fuses through FusionNet),
   interleaved too.  The launch counters, zeroed just before each
   ``interact`` and read just after, must show each read's kernels launched,
   the outputs be finite, and one blocked segmentation step through the
   kernels must match the plain read; one more frame-0 interact of the
   chunked read counts the rows its readout staged against the picks;
6b. the propagation step entry point, ``eva_vos_tpu_torch.entry.entry()``
   at its defaults (480x864, resnet50/resnet18, a 4-frame bank of 6,480
   tokens, N = 1,620 queries, top_k = 50, bf16, seeded weights): the
   'fused' step (#1, then #2) against a 'gather' step on the same weights
   and inputs (within PROB_ATOL / PROB_FRAC), its [2, 480, 864] output
   finite and summing to 1 over the channels, the launch counters, zeroed
   just before each step and read just after, showing #1 and #2 once
   each a fused step and no other kernel, and STEP_ITERS untraced steps
   of each read after a warm-up, interleaved (median and range);
6c. the default read above top_k 256 (#1's radix select, #2's large-k
   kernel): #1 on the clustered banks of FILLS at N = 8100, top_k 512 and
   2,048 in bf16 and 512 in fp32 at fill 12, against the plain selection
   (``check_selection``'s rule; the slots past the live tokens (-1e30, 0)),
   with its queries whose first bin overflowed the candidate cap and the
   most scorings of the bank a query tile took, and #2 on its picks
   against the plain readout (two runs equal bit for bit), with its rows
   staged, picks per staged row and stages summed dense, counted on the
   card against the plain statement of its plan, each with its device ms
   split per kernel, plain and library times and bound; #1 at top_k 50 on the fill-72 bank
   beside them (the kernels of the same file); #1's merge passes (top_k
   20,000); phase 6's engine at top_k 512, fused against
   gather at frame 0 and frame 30 (within PROB_ATOL / PROB_FRAC), #1 and #2
   exactly as often as at top_k 50 and no other kernel, LARGE_K_ITERS
   interleaved frame-0 interacts a read; the eval CLI with ``--top-k 512``
   (oracle_mask, 3 rounds) against a direct call (``[large-k ...]`` lines);
6d. keys of other widths than 64: each selection kernel (#1, #4-#8) at
   CK in KEY_WIDTHS_CK (bf16, top_k 50; 24 is taken zero-padded to 32 and
   counted in the wrapper's ``pads``) on a clustered bank at fill
   WIDTH_FILL, N = 8100, against the plain selection
   (``check_selection``'s rule), #1 also at top_k 512 (its radix select),
   in fp32 at WIDTH_FP32 and at fill 72 at WIDTH_FULL, each with its
   device ms (CUDA events around back-to-back calls, the pad included:
   ``stream_ms``; and by kernel from a trace, ``named_ms``), bound and
   addmm + torch.topk time (``[widths]`` lines); a
   CUDA call at CK 300 must raise naming the cap; phase 6's engine with
   ``PropagationNetwork(keydim=...)`` of WIDTH_KEYDIMS (resnet50 /
   resnet18, bf16, seeded): a frame-0 interact on the default read against
   the plain read (PROB_ATOL / PROB_FRAC), #1's launches and pads, and
   WIDTH_ITERS untraced interacts; ``entry(keydim=WIDTH_ENTRY)`` against
   its 'gather' step, and a one-process sharded read at that width against
   the fused read;
7. ``resize_bilinear`` on a bf16 batch of frames that shrinks: it must
   take the antialiased filter (in fp32, cast back), and whether torch's
   own antialiased kernel takes bf16 on the card is printed;
8. the policy loops (``eva_vos_tpu_torch.interactions``) on phase 6's
   engine (the default read) and video, the annotator
   ``Annotator(FakeSAMController())``: ``initialize`` (the features)
   timed, then oracle_mask (5 rounds, J&F), rand_rand (3clicks / mask, 5
   rounds, J), oracle_oracle (click / bbox / 3clicks / mask, 4 rounds) and
   upper_bound_mask (2 rounds; it interacts once for every free frame a
   round).  Each loop prints its
   seconds a round and its spans (``WallClock``: propagate, eval); the
   launch counters, zeroed just before each loop, must show the default
   read's two kernels launched at least once a round; the frames chosen
   must be in range, the annotation times the cost model's, a frame with a
   full mask must score 1 (or the empty-gt token) after every round and
   never be chosen again by rand_rand; and the session's device metrics
   must equal the host loop's (``EVAVOS_HOST_METRICS``) bit for bit.
   Then oracle_mask's first rounds under the default and the plain
   ('gather') read: while they annotate the same frames, every frame's J
   must agree within PARITY_DJ_ATOL and the mean J within PARITY_J_ATOL
   (a bf16 near-tie may flip a later choice: the first divergence is
   printed and ends the comparison);
9. the decision models and SAM (``eva_vos_tpu_torch.models``) at the
   CLI's defaults in fp32 with seeded random weights: QNet resnet18
   ('cat'), ActorCritic resnet18 (2 actions), SAM vit_h (1024 px, 32
   blocks of width 1280, built on the card) and the l2_mask encoder
   resnet50.  eva_vos (3clicks / mask, the annotator on SAM with the fused
   select and the host warm start, its default), qnet_mask and l2_mask
   run DECISION_ROUNDS rounds each on
   phase 6's engine and video, with their seconds a round, ``WallClock``
   spans (propagate, eval, annotate, choice), the agent's actions and #1 /
   #2 launches (at least once a round).  SAM's set_image (median of 5),
   predict, predict_select and warmstart_select (with its decodes), QNet on
   60 frames, the agent's act and the extractor on 60 frames are timed.
   Checks: predict_select equals predict + best_sam_mask exactly on 15
   prompts (a click, two clicks, a box, a box and a click, a mask_input) on
   three frames; the device warm start (``Annotator(...,
   device_warmstart=True)``, warmstart_select) gives the host loop's
   episode on the propagated masks and on the background
   (WARM_BACKGROUND_THRESHOLDS) of WARM_FRAMES frames, and chains stop on
   at least WARM_FRAMES of those frames (random weights give up on the
   propagated masks); the device click
   robot equals scipy's on every (pred, gt) pair it met; QNet, the
   ActorCritic, the extractor's trunk and SAM's prompt encoder and mask
   decoder on a vit_h embedding equal their CPU copies within CPU_RTOL of
   the output's largest magnitude;
10. training (``eva_vos_tpu_torch.train``, ``data``, ``cli``), in a
   temporary directory (``EVAVOS_DATA_ROOT`` and the working directory):
   the FQ generator's per-sample function on phase 6's video with a fresh
   fp32 engine (``model_zoo``, random seeded weights; FQ_ROUNDS oracle
   rounds), whose #1 and #2 (fp32) must launch every round and whose
   blocked step must match the plain read (FP32_PROB_ATOL), its states'
   PNGs and IoU lists, read back exactly by ``MaskQualityDB``;
   ``train_qnet.main`` over that tree (1 epoch, batch 64), QNET_TIMED_STEPS
   more steps timed, the checkpoint reloaded into ``QualityNet``, and one
   step at batch 4 against a CPU copy (float64: loss and gradients; fp32:
   the loss, and the gradients printed); the annotation generator's
   per-sample function (ANNOT_ROUNDS rounds, phase 9's ViT-H SAM), with
   [256, 64, 64] embeddings and #1 / #2 every round; ``train_rl_agent.main``
   over that tree (ViT-H, 4 envs), with its checkpoints; and one
   ``batched_rollouts`` of FLEET_ENVS envs with ``optimize``: the chunked
   encode's seconds and peak memory, the warm start, the steps and the
   updates timed, every reward finite, the sequential ``AnnotationEnv``
   equal to the fleet on SEQ_CHECK_ENVS envs, and one PPO update at 4
   samples against a CPU copy (as the QNet step);
11. the eval CLI (``eva_vos_tpu_torch.cli.eval_annotation_method``), in a
   temporary directory: phase 6's video written as a one-video DAVIS_17
   tree (PNG bytes under the frames' ``.jpg`` names, palette annotations,
   ``ImageSets/2017/val.txt``; ``EVAVOS_DATA_ROOT``, and an empty
   ``EVAVOS_WEIGHTS_ROOT``), and the CLI's ``main`` called in-process with
   random weights: (a) oracle_mask (CLI_MASK_ROUNDS rounds, fp32, J&F),
   whose CSV must equal a direct ``oracle_mask`` call on an engine from
   ``model_zoo`` over the sample read back (annotation times exactly,
   ``mu_metric`` within CLI_MU_ATOL, cudnn deterministic), with the frames
   read back equal to the frames written; (b) eva_vos with ViT-H SAM
   (CLI_EVA_ROUNDS, fp32): the JAX CLI's columns, a row a round, the
   RANDOM_WEIGHTS marker, 60 per-frame metrics a row; (c) rand_rand on the
   fake SAM in bf16 with ``--profile-dir``: the trace names #1's and #2's
   kernels; (d) (a) with ``--resume``: the file unchanged byte for byte;
   (e) (a) with ``--multihost`` (one process): the same file name and
   rows; (f) ``vis.read_exp`` of (a) and (b): finite curves.  #1 and #2
   must launch at least once a round of every run.  Each run prints its
   build seconds, seconds a round, ``WallClock`` spans and launches;
12. the parallel layer (``eva_vos_tpu_torch.parallel``, ``native``), after
   the native library is built and before any process is spawned: the
   default, newest-first and resident selections on an empty shard (fill
   0) must write NEG_INF scores with in-range ids; (a) phase 6's engine
   with ``readout_strategy="sharded"`` on a one-process NCCL group, its
   interacts at PARALLEL_FRAMES against the 'fused' engine's (within
   PROB_ATOL / PROB_FRAC), #1 launched once for every sharded read, the
   untraced interact ms and the collective bytes, and the same at top_k
   LARGE_K_ENGINE (#1's large-k path as the local selection) against the
   fused engine at that top_k; (b) the same episode in
   two processes sharing the card over gloo against (a)'s (each rank's
   bank half of (a)'s, its collective bytes the same on its whole bank and
   on a quarter of it and within 4x ``comm_model_bytes``), the
   data-parallel QNet step (the CLI's widths) and PPO update against one
   process's, and ``dryrun_multichip(2)`` (the two-process multi-host
   rehearsal on the card, then the dry run; gloo on one card); (c) (b) over
   NCCL on min(4, count) cards, only when there are two cards or more;
   (d) rand_rand's rounds of phase 8 with the native click robot and with
   scipy's, in turns: the same clicks, and each run's ``annotate`` span;
   the labeling alone on one error mask at 480x854, in turns: the same
   result, and each turn's median ms a call;
13. one JSON line with each kernel's launches (from the engine read that
   runs it, or from phase 5 for the iterative and sort kernels), error,
   times and bound, and the key widths it ran at (phase 6d), and the
   large-k paths of #1 and #2 (phase 6c).

The last line of standard output is ``{"ok": true, "device": {...}}``.  The
full results also go to ``chiprun_out/chip_smoke.json``.  Without a CUDA
device, or without the repository beside it, the script exits non-zero.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

DEVICE = "cuda"
ENGINE = dict(t=60, h=480, w=854, key_arch="resnet50")
HW_TOKENS = 30 * 54          # key tokens of one 480x864 frame
N_QUERIES = 5 * HW_TOKENS    # one blocked step: mem_freq frames
CK, CV, TOP_K = 64, 512, 50
FILLS = (1, 12, 72)          # bank slots: one memory, one pass, a full bank
ENGINE_ITERS = 10            # timed frame-0 interacts per read, interleaved
FRAME30_ITERS = 3            # untraced frame-30 interacts per read
STEP_ITERS = 10              # untraced propagation steps per read (phase 6b)
# the policy loops on the engine's video: (loop, rounds, keyword arguments)
POLICY_LOOPS = (
    ("oracle_mask", 5, dict(eval_metric="j_and_f")),
    ("rand_rand", 5, dict(annotation_types=("3clicks", "mask"),
                          eval_metric="j")),
    ("oracle_oracle", 4, dict(annotation_types=("click", "bbox", "3clicks",
                                                "mask"))),
    ("upper_bound_mask", 2, dict()))
PARITY_ROUNDS = 3            # oracle_mask under the default and plain reads
# while the frames agree: each frame's J (the largest |dJ| measured on the
# H100 was 3.3e-5, so 1e-3 leaves a margin of 30) and, as an outer limit,
# the per-round mean J
PARITY_DJ_ATOL = 1e-3
PARITY_J_ATOL = 2e-2
# the decision and SAM phase: the CLI's default models in fp32 (QNet
# resnet18 'cat', ActorCritic resnet18 with 2 actions, SAM vit_h, the
# l2_mask encoder resnet50), random weights from fixed seeds, on the policy
# phase's engine and video
SAM_PRESET = "vit_h"
EXTRACTOR = "resnet50"
DECISION_ROUNDS = 4
SELECT_FRAMES = (5, 25, 45)   # frames of the fused-select check
WARM_FRAMES = 4               # frames of the warm-start check
WARM_BACKGROUND_THRESHOLDS = (0.8, 0.6)    # chains on their background
# card against CPU, same weights, TF32 off: max |d| over max |value|
CPU_RTOL = 1e-3
# the training phase (cuts: PERF.md §4): the FQ generator's oracle rounds
# (the CLI runs 8) and the annotation generator's rounds (4 states), timed
# QNet steps of 64 after the CLI's epoch, and one rollout of the CLI's
# 40-env fleet (5 steps, 10 minibatches) with 2 PPO epochs (the CLI: 40);
# the sequential env is held to the fleet on its first SEQ_CHECK_ENVS envs
FQ_ROUNDS = 3
ANNOT_ROUNDS = 5
QNET_TIMED_STEPS = 10
FLEET_ENVS, FLEET_STEPS, FLEET_MINI_BATCH, FLEET_PPO_EPOCHS = 40, 5, 10, 2
SEQ_CHECK_ENVS = 3
# one blocked step of the fp32 engine, kernels vs the plain read: fp32
# scores in another summation order (a few ulps) and a near-tied token
# swapped at the top-k boundary move probabilities by far less than this;
# the share of pixels off by more must stay below PROB_FRAC
FP32_PROB_ATOL = 1e-3
# the eval CLI phase (cuts: PERF.md §4): its 60 rounds cut to 5 (oracle_mask,
# fp32, also resumed and under --multihost), 4 (eva_vos with ViT-H, fp32) and
# 3 (rand_rand on the fake SAM, bf16, traced); the CSV's oracle_mask rows
# against a direct call with cudnn deterministic
CLI_MASK_ROUNDS, CLI_EVA_ROUNDS, CLI_RAND_ROUNDS = 5, 4, 3
CLI_MU_ATOL = 1e-4
CLI_EVA_COLUMNS = ["video", "mu_metric", "annotation_time", "round",
                   "weights", "rl_values", "round_metrics",
                   "annotated_frames", "annotation_actions"]
# the parallel phase (cuts: PERF.md §4): the sharded engine's episode on
# phase 6's engine and video, its ranks' processes bounded by
# PARALLEL_TIMEOUT_S each; the data-parallel QNet step at the train_qnet
# CLI's widths and the PPO update at the fleet's minibatch (40 envs x 5
# steps / 10), fp32, against one process's: their losses within
# DP_LOSS_RTOL (measured up to 2.1e-7), each parameter's change within
# DP_PARAM_L2 of its L2 norm (fp32 near-ties in max-pool and ReLU move
# single elements; a gradient left unsummed moves the whole change by
# about half), the running statistics within DP_STAT_TOL of their largest
# magnitude.  (d) times the robot's labeling of one error mask at 480x854,
# LABEL_CALLS calls a turn
PARALLEL_FRAMES = (0, ENGINE["t"] - 1, 30)
PARALLEL_TIMEOUT_S = 300
ONE_CARD_BACKEND = "nccl"
QNET_DP_ROWS, QNET_DP_SIZE = 64, 224
PPO_DP_ROWS = 20
DP_LOSS_RTOL = 1e-5
DP_PARAM_L2 = 0.1
DP_STAT_TOL = 1e-3
LABEL_CALLS = 200

# the large-k phase (6c): #1 above 256 (the radix select) and #2 above 256
# (the large-k readout) on the clustered banks of FILLS at N = N_QUERIES in
# bf16 at each LARGE_K, and in fp32 at LARGE_K_FP32 (fill, top_k); the merge
# passes of #1 (more than 8,192 keys a query) on LARGE_K_MERGE (N, M,
# top_k), checked untimed; phase 6's engine at top_k LARGE_K_ENGINE, fused
# against gather, LARGE_K_ITERS interleaved frame-0 interacts a read; the
# eval CLI at --top-k LARGE_K_ENGINE, oracle_mask, LARGE_K_ROUNDS rounds
LARGE_K = (512, 2048)
LARGE_K_FP32 = (12, 512)
# the key-width phase (6d): each selection kernel (width_selectors()) at
# each of KEY_WIDTHS_CK on phase 6c's clustered bank at fill WIDTH_FILL,
# N = N_QUERIES, bf16, top_k TOP_K; #1 also at top_k LARGE_K[0], in fp32 at
# WIDTH_FP32 and at fill max(FILLS) at WIDTH_FULL; phase 6's engine with
# keys WIDTH_KEYDIMS wide (WIDTH_ITERS untraced interacts), entry() and a
# one-process sharded read at WIDTH_ENTRY
KEY_WIDTHS_CK = (16, 24, 32, 64, 128, 256)
WIDTH_FILL = 12
WIDTH_FP32 = (32, 128)
WIDTH_FULL = (128, 256)
WIDTH_KEYDIMS = (128, 24)
WIDTH_ENTRY = 128
WIDTH_ITERS = 3
LARGE_K_MERGE = (256, 40000, 20000)
LARGE_K_ENGINE = 512
LARGE_K_ITERS = 5
LARGE_K_ROUNDS = 3
# the large-k path's kernels, as a trace names them
RADIX_KERNELS = ("topk_key_norms_kernel", "topk_radix_kernel",
                 "topk_cand_select_kernel", "topk_sort_rows_kernel",
                 "topk_sort_chunks_kernel", "topk_rank_merge_kernel",
                 "topk_keys_t_kernel")
# the wrappers' pad of keys to a built width (memory_topk.pad_keys: a fill
# and a copy for qk and for the valid keys), as a trace names its kernels
PAD_KERNELS = {"FillFunctor": 2, "copy_kernel": 2}
# #1's kernels at top_k <= 256
PRUNED_KERNELS = ("topk_prune_block_kernel", "topk_merge_t_kernel")
LARGE_K_READOUT = "readout_large_k_kernel"

# H100 SXM data-sheet peaks (dense), for the bound of each kernel
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12

# Scores are sums of 64 bf16 x bf16 products in fp32, |terms| up to ~20, in
# another order than the plain version's cuBLAS product: differences stay
# within 64 * 20 * 2^-23 ~ 2e-4.  Ids may differ only where neighbouring
# scores are that close.
SCORE_ATOL = 1e-3
# The readout is a weighted mean in fp32 rounded to bf16 at the end: the two
# versions may land one bf16 ulp apart (2^-8 relative, values up to ~5).
READOUT_RTOL, READOUT_ATOL = 2 ** -7, 2e-2
# the fp32 readout: weighted means of N(0, 1) values in fp32, summed in
# the same order as the plain version's einsum only up to rounding
FP32_READOUT_ATOL = 1e-5
# One blocked segmentation step, kernels vs plain read, through the bf16
# decoder: readouts one ulp apart, and a swapped near-tied token at the top-k
# boundary, move a few probabilities; the share of pixels off by more than
# PROB_ATOL must stay below PROB_FRAC.
PROB_ATOL, PROB_FRAC = 5e-2, 1e-3


# the block and merge kernels of the selections timed one by one: those
# of the pruned block stage (the transposed and the row-output kernels),
# and the resident walk with the transposed merge of its segments (the
# resident selection) or the cut of their lists into rows (the iterative
# one)
SPLIT_KERNELS = {
    "memory_topk": ("topk_prune_block_kernel", "topk_merge_t_kernel"),
    "memory_topk_chunked": ("topk_prune_block_kernel", "topk_merge_t_kernel"),
    "memory_topk_resident": ("topk_resident_kernel", "topk_merge_t_kernel"),
    "memory_topk_grid": ("topk_rows_block_kernel", "topk_rows_merge_kernel"),
    "memory_topk_iter": ("topk_resident_kernel", "topk_rows_cut_kernel"),
    "memory_topk_sort": ("topk_rows_block_kernel", "topk_rows_merge_kernel")}
# the largest top_k, checked and timed for the sort and iterative kernels:
# ~300 keys of a sort kernel's row survive its pruning, more than it ranks
# one by one, so it sorts them in a warp; the walk takes 32-query tiles
SORT_WIDE_K = 256
WIDE_KERNELS = ("memory_topk_sort", "memory_topk_iter")

# the selections that return [N, k] rows (softmax weights by default)
ROW_SELECTIONS = ("memory_topk_grid", "memory_topk_iter", "memory_topk_sort")
# the selections also checked and timed at a single-frame step (N = 1620)
SINGLE_FRAME = ("memory_topk", "memory_topk_chunked",
                "memory_topk_resident") + ROW_SELECTIONS
# select_topk's arguments that reach each entry-point kernel: no method for
# its default, the iterative kernel
ENTRY_KWARGS = {"memory_topk_iter": {}, "memory_topk_sort": {"method": "sort"}}

# each kernel's source and the TPU kernel it replaces
SOURCES = {"memory_topk": "memory_topk.cu",
           "memory_topk_chunked": "memory_topk.cu",
           "memory_topk_resident": "memory_topk_resident.cu",
           "memory_topk_grid": "memory_topk_grid.cu",
           "memory_topk_iter": "memory_topk_iter.cu",
           "memory_topk_sort": "memory_topk_sort.cu",
           "memory_readout": "memory_readout.cu",
           "memory_readout_chunked": "memory_readout_chunked.cu"}
REPLACES = {"memory_topk": "eva_vos_tpu/kernels/memory_topk.py:380",
            "memory_topk_chunked": "eva_vos_tpu/kernels/memory_topk.py:590",
            "memory_topk_resident": "eva_vos_tpu/kernels/memory_topk.py:801",
            "memory_topk_grid": "eva_vos_tpu/kernels/memory_topk.py:302",
            "memory_topk_iter": "eva_vos_tpu/kernels/memory_topk.py:187",
            "memory_topk_sort": "eva_vos_tpu/kernels/memory_topk.py:264",
            "memory_readout": "eva_vos_tpu/kernels/memory_readout.py:64",
            "memory_readout_chunked":
                "eva_vos_tpu/kernels/memory_readout.py:196"}


# the large-k paths of #1 and #2 in the kernels line, by the kernel whose
# source and TPU kernel they share
LARGE_K_LINE = {"memory_topk_radix": "memory_topk",
                "memory_readout_large_k": "memory_readout"}


def fail(msg: str):
    raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return sorted(times)[len(times) // 2]


def stream_ms(torch, fn, reps: int = 10, rounds: int = 3) -> float:
    """Device ms a call of ``fn``: the time between two CUDA events around
    ``reps`` back-to-back calls, over ``reps`` (median of ``rounds``).  It
    holds every kernel the calls queue and the gaps between them, which
    stay a few microseconds while the host queues a call faster than the
    card runs one (calls of 0.3 ms and more); no trace can drop a kernel
    from it."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return sorted(times)[len(times) // 2]


def split_ms(torch, fn, name: str, merged: bool = True, reps: int = 5,
             tries: int = 5) -> dict:
    """Mean device time of each of selection ``name``'s block and merge
    kernels (SPLIT_KERNELS) over ``reps`` calls of ``fn``, from a
    ``torch.profiler`` trace (taken again, up to ``tries`` times, when the
    trace lacks a launch).  Without ``merged`` the merge must not launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    block, merge = SPLIT_KERNELS[name]
    want = {block: reps, merge: reps if merged else 0}
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = {k: [] for k in want}
        for e in prof.events():
            for k in want:
                if e.device_type == DeviceType.CUDA and k in e.name:
                    us[k].append(e.time_range.end - e.time_range.start)
        if {k: len(v) for k, v in us.items()} == want:
            return {"block_ms": sum(us[block]) / reps / 1e3,
                    "merge_ms": sum(us[merge]) / reps / 1e3}
    fail(f"the profiler's trace of {name}: "
         f"{ {k: len(v) for k, v in us.items()} } launches, not {want}")


def device_ms(torch, fn, reps: int = 10, tries: int = 3) -> float:
    """Mean device time of ``fn``'s kernels a call over ``reps`` calls, from
    a ``torch.profiler`` trace (taken again, up to ``tries`` times, when a
    call's kernel is missing): the kernel's own time, without the host's
    launch path that CUDA events around a short call also measure."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.end - e.time_range.start for e in prof.events()
              if e.device_type == DeviceType.CUDA]
        if len(us) >= reps:
            return sum(us) / reps / 1e3
    fail(f"the profiler's trace holds {len(us)} kernels for {reps} calls")


def hmma_count(build, name: str):
    """HMMA (tensor-core) instructions in a built library's SASS, or None
    where the toolkit has no ``cuobjdump``."""
    tool = Path(build.nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    out = subprocess.run([str(tool), "-sass", str(build.library_path(name))],
                         capture_output=True, text=True, check=True).stdout
    return sum("HMMA" in line for line in out.splitlines())


def bound_ms(n_bytes: float, flops: float,
             peak_flops: float = PEAK_BF16_FLOPS):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def make_bank(torch, gen, qk, fill: int, clustered: bool):
    """Keys [72 slots x 1620, CK] bf16 (CK as wide as qk) with ``fill``
    slots valid.  Clustered: every token is a query key plus small noise,
    so each query has near-tied neighbours (as a static background gives
    real banks)."""
    m, ck = max(FILLS) * HW_TOKENS, qk.shape[1]
    if clustered:
        src = torch.arange(m, device=qk.device) % qk.shape[0]
        noise = torch.randn((m, ck), generator=gen, device=qk.device)
        mk = qk.float()[src] + 0.05 * noise
    else:
        mk = torch.randn((m, ck), generator=gen, device=qk.device)
    return mk.to(torch.bfloat16), fill * HW_TOKENS


def check_selection(torch, vals, idx, ref_vals, ref_idx, name, k=None):
    k = k or TOP_K
    err = (vals - ref_vals[:k]).abs().max().item()
    if err > SCORE_ATOL:
        fail(f"{name}: selection scores differ by {err}")
    gaps = (ref_vals[:-1] - ref_vals[1:]).abs() <= SCORE_ATOL  # [k, N]
    tied = gaps[:k].clone()
    tied[1:] |= gaps[:k - 1]
    bad = (idx != ref_idx[:k]) & ~tied
    if bad.any():
        fail(f"{name}: {int(bad.sum())} selected ids differ away from ties")
    return err, int((idx != ref_idx[:k]).sum())


def selection_bound(n: int, valid: int, k=None, fp32: bool = False,
                    ck: int = CK):
    """Bound of an exact top-k selection: read qk and the valid keys (``ck``
    wide) once, write k (score, id) pairs per query; 2 * ck flops per
    (query, token), on the tensor cores for bf16 keys and on the FP32 units
    for fp32."""
    k = k or TOP_K
    n_bytes = (4 if fp32 else 2) * ck * (n + valid) + 8 * k * n
    return bound_ms(n_bytes, 2.0 * n * valid * ck,
                    PEAK_FP32_FLOPS if fp32 else PEAK_BF16_FLOPS)


def library_select(torch, mk, q, k=None):
    """One library computation of the selection: the scores as one fp32
    GEMM whose bias is -|k|^2 / sqrt(CK) (2 / sqrt(64) and 1 / sqrt(64) are
    powers of two, so the result is the plain version's; at other widths
    it may round apart), then ``torch.topk``.  The bias stays 1-D, so that
    cuBLASLt adds it in the GEMM's epilogue instead of a [N, M] copy of it
    being read."""
    ck = mk.shape[1]
    mk32 = mk.float()
    bias = (mk32 * mk32).sum(-1).mul_(-1.0 / math.sqrt(ck))
    scores = torch.addmm(bias, q.float(), mk32.T, alpha=2.0 / math.sqrt(ck))
    return torch.topk(scores, k or TOP_K, dim=1)


def library_times(torch, mk, q, ref_vals, k=None):
    """``library_select``'s time with TF32 off and on (bf16 keys convert to
    TF32 exactly); each run's scores must match the plain version's."""
    k = k or TOP_K
    times = {}
    for mode in ("fp32", "tf32"):
        torch.backends.cuda.matmul.allow_tf32 = mode == "tf32"
        try:
            vals, _ = library_select(torch, mk, q, k)
            err = (vals.T - ref_vals[:k]).abs().max().item()
            if err > SCORE_ATOL:
                fail(f"library selection ({mode}) scores differ by {err}")
            times[mode] = cuda_ms(
                torch, lambda: library_select(torch, mk, q, k), 5)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    return times


def wide_case(torch, name, q, mk, valid, counter):
    """Kernel ``name`` of WIDE_KERNELS at top_k = SORT_WIDE_K on one bank:
    checked against the plain version, timed with its block (or walk) and
    merge split, beside the library call at the same k; with the sort
    kernel's escalated rows or the iterative kernel's compactions (both
    counted in ``counter``)."""
    from eva_vos_tpu_torch.kernels import (topk_select_iter,
                                           topk_select_plain, topk_select_sort)
    from eva_vos_tpu_torch.kernels.memory_topk import (_SELECT_BLOCK,
                                                       iter_segments)

    k, n = SORT_WIDE_K, q.shape[0]
    label = f"{name} fill{max(FILLS)}_clustered N={n} top_k={k}"
    ref_vals, ref_idx = topk_select_plain(q, mk, valid, k + 1)
    counter.zero_()
    if name == "memory_topk_sort":
        select, count = topk_select_sort, "escalations"
        rows = n * -(-valid // _SELECT_BLOCK)
        merged = valid > _SELECT_BLOCK
    else:
        select, count = topk_select_iter, "compactions"
        segs = iter_segments(n, valid, k, torch.cuda.get_device_properties(
            q.device).multi_processor_count)
        merged = segs > 1
    vals, idx = select(q, mk, valid, k, return_raw=True, **{count: counter})
    err, n_diff = check_selection(torch, vals.T, idx.T, ref_vals, ref_idx,
                                  label, k)
    row = dict(kernel=name, top_k=k, n=n, max_abs_err=err,
               ids_differ=n_diff,
               ms=cuda_ms(torch, lambda: select(q, mk, valid, k), 10),
               **split_ms(torch, lambda: select(q, mk, valid, k), name,
                          merged=merged))
    if name == "memory_topk_sort":
        row.update(escalated_rows=int(counter.item()), rows=rows)
        note = f"escalated rows {row['escalated_rows']} of {rows}"
        first = "block"
    else:
        row.update(compactions=int(counter.item()), segments=segs)
        note = (f"segments {segs}, compactions {row['compactions']} "
                f"({row['compactions'] / n:.2f} a query)")
        first = "walk"
    lib = library_times(torch, mk[:valid], q, ref_vals, k)
    row["library_ms"] = min(lib.values())
    row["bound_ms"], row["bound_by"] = selection_bound(n, valid, k)
    print(f"[select] {label}: max|dv|={err:.3g} ids_differ={n_diff} kernel "
          f"{row['ms']:.3f} ms ({first} kernel {row['block_ms']:.3f} ms + merge "
          f"kernel {row['merge_ms']:.3f} ms), addmm+torch.topk "
          f"{row['library_ms']:.3f} ms (fp32 {lib['fp32']:.3f}, tf32 "
          f"{lib['tf32']:.3f}), bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}), {note}", flush=True)
    return row


def no_skip_case(torch, q, mk, valid, sel, chunked_counted, esc, floored,
                 rows: int, label: str) -> dict:
    """The newest-first selection with its floor off (``no_skip``, the JAX
    ``sel_notau`` ablation) on one case: the same output as with the floor,
    bit for bit (the same scores, an exact selection either way), no row
    floored; timed with its block and merge split."""
    from eva_vos_tpu_torch.kernels import topk_select_chunked
    from eva_vos_tpu_torch.kernels.memory_topk import _SELECT_BLOCK

    esc.zero_()
    floored.zero_()
    vals, idx = chunked_counted(q, mk, valid, TOP_K, no_skip=True)
    if not (torch.equal(vals, sel[0]) and torch.equal(idx, sel[1])):
        fail(f"{label} no_skip: differs from the selection with the floor")
    if int(floored.item()):
        fail(f"{label} no_skip: the floor emptied rows")
    timed = lambda: topk_select_chunked(q, mk, valid, TOP_K, no_skip=True)
    out = dict(ms=cuda_ms(torch, timed, 10), escalated_rows=int(esc.item()),
               **split_ms(torch, timed, "memory_topk_chunked",
                          merged=valid > _SELECT_BLOCK))
    print(f"[select] {label} no_skip: equal to the floor's; kernel "
          f"{out['ms']:.3f} ms, block kernel {out['block_ms']:.3f} ms + merge "
          f"kernel {out['merge_ms']:.3f} ms, escalated rows "
          f"{out['escalated_rows']} of {rows}", flush=True)
    return out


def readout_bound(idx, k_obj: int, vals=None, itemsize: int = 2):
    """Bound of the readout: each distinct selected row of weight > 0 once
    per object, the selection once, the output once; 2 flops per gathered
    element of weight > 0 (``vals`` None: every pick weighs)."""
    k, n = idx.shape
    live = ((vals - vals[:1]).exp() > 0 if vals is not None
            else idx.new_ones(idx.shape, dtype=bool))
    rows = idx[live].unique().numel()
    picks = int(live.sum())
    n_bytes = (k_obj * rows * CV * itemsize + 8 * k * n
               + k_obj * n * CV * itemsize)
    return bound_ms(n_bytes, 2.0 * k_obj * picks * CV), rows


def tile_rows(torch, vals, idx, queries: int):
    """(distinct ids of weight > 0 summed over the tiles of ``queries``
    queries, picks of weight > 0): the rows the readout stage copies for
    one object, and the picks it sums."""
    n = idx.shape[1]
    tile = (torch.arange(n, device=idx.device) // queries).expand_as(idx)
    live = torch.exp(vals - vals[:1]) > 0
    keys = (tile[live].long() << 32) | idx[live].long()
    return keys.unique().numel(), int(live.sum())


def readout_cases(torch, mv2, sels, stage: bool) -> list:
    """The two readout kernels on the default selection of every case of
    the selection phase (``sels``: (case, N) -> (vals, idx)), K = 1, and
    K = 2 at the fullest bank with N = N_QUERIES: each checked against the
    plain version and timed beside it, ``F.embedding_bag`` (K = 1) and the
    bound, with the distinct rows and picks per 64-query tile.  ``stage``:
    the package's chunked readout runs the readout stage, so it must also
    agree bit for bit with a second run and with its ``no_skip``, and count
    the rows that ``tile_rows`` counts at the stage's tile size (the
    default readout, a gather, with a second run).  The chunked readout's
    ``no_skip`` is timed at the fullest clustered bank.  A kernel's ``ms`` and the library's are device
    times (``device_ms``); ``call_ms`` and the plain version's are CUDA
    events around a call."""
    from eva_vos_tpu_torch.kernels import (topk_readout, topk_readout_chunked,
                                           topk_readout_plain)
    from eva_vos_tpu_torch.ops.memory_attention import softmax_weights

    readouts = (("memory_readout", topk_readout),
                ("memory_readout_chunked", topk_readout_chunked))
    staged = torch.zeros(1, dtype=torch.int32, device=mv2.device)
    rows_out = []
    for (case, n), (vals, idx) in sels.items():
        full = case.startswith(f"fill{max(FILLS)}_") and n == N_QUERIES
        for k_obj in ((1, 2) if full else (1,)):
            mv = mv2[:k_obj].contiguous()
            ref = topk_readout_plain(mv, vals, idx)
            plain_ms = cuda_ms(torch, lambda: topk_readout_plain(mv, vals, idx),
                               3)
            lib_ms = None
            if k_obj == 1:
                # one library call for the same weighted gather
                w = softmax_weights(vals.T).to(mv.dtype).contiguous()
                ids = idx.T.long().contiguous()
                lib_ms = device_ms(torch, lambda: torch.nn.functional
                                   .embedding_bag(ids, mv[0], mode="sum",
                                                  per_sample_weights=w))
            (bound, by), rows = readout_bound(idx, k_obj)
            tile64, picks = tile_rows(torch, vals, idx, 64)
            tiles = -(-n // 64)
            row = dict(case=f"{case}_K{k_obj}", n=n, k_obj=k_obj,
                       plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                       bound_by=by, unique_rows=rows,
                       tile64_rows=tile64 / tiles, tile64_picks=picks / tiles)
            note = ""
            if stage:
                from eva_vos_tpu_torch.kernels.memory_readout import (
                    _sm_count, readout_geometry)
                queries, slices = readout_geometry(
                    n, k_obj, CV, mv.element_size(), TOP_K,
                    _sm_count(mv.device))
                want = k_obj * tile_rows(torch, vals, idx, queries)[0]
                row.update(queries=queries, slices=slices, staged_rows=want,
                           sharing=k_obj * picks / want)
                note = (f", chunked: tiles of {queries} x {slices} slices, "
                        f"staged rows {want} (picks / staged rows "
                        f"{row['sharing']:.2f})")
            for name, readout in readouts:
                kw = {}
                counted = stage and name == "memory_readout_chunked"
                if counted:
                    staged.zero_()
                    kw["staged_rows"] = staged
                out = readout(mv, vals, idx, **kw)
                torch.testing.assert_close(out.float(), ref.float(),
                                           rtol=READOUT_RTOL,
                                           atol=READOUT_ATOL)
                if stage:
                    if counted and int(staged.item()) != row["staged_rows"]:
                        fail(f"{name} {case} N={n} K={k_obj}: staged "
                             f"{int(staged.item())} rows, not "
                             f"{row['staged_rows']}")
                    if not torch.equal(readout(mv, vals, idx), out):
                        fail(f"{name} {case} N={n}: two runs differ")
                row[f"{name}_err"] = (out.float() - ref.float()).abs().max(
                    ).item()
                row[f"{name}_ms"] = device_ms(
                    torch, lambda: readout(mv, vals, idx))
                row[f"{name}_call_ms"] = cuda_ms(
                    torch, lambda: readout(mv, vals, idx), 10)
            # out: the chunked readout's, the loop's last
            if stage and not torch.equal(
                    topk_readout_chunked(mv, vals, idx, no_skip=True), out):
                fail(f"memory_readout_chunked {case} N={n} K={k_obj}: "
                     f"no_skip differs")
            if full and k_obj == 1 and case.endswith("clustered"):
                row["memory_readout_chunked_no_skip_ms"] = device_ms(
                    torch, lambda: topk_readout_chunked(mv, vals, idx,
                                                        no_skip=True))
                note += (f", chunked no_skip "
                         f"{row['memory_readout_chunked_no_skip_ms']:.4f} ms")
            rows_out.append(row)
            lib = "None" if lib_ms is None else f"{lib_ms:.3f}"
            print(f"[readout] {case} N={n} K={k_obj}: memory_readout "
                  f"{row['memory_readout_ms']:.4f} ms on the device, "
                  f"{row['memory_readout_call_ms']:.3f} ms a call (max|d| "
                  f"{row['memory_readout_err']:.3g}), memory_readout_chunked "
                  f"{row['memory_readout_chunked_ms']:.4f} / "
                  f"{row['memory_readout_chunked_call_ms']:.3f} ms (max|d| "
                  f"{row['memory_readout_chunked_err']:.3g}), plain "
                  f"{plain_ms:.3f} ms, embedding_bag {lib} ms, bound "
                  f"{bound:.4f} ms ({by}), unique rows {rows}, per 64-query "
                  f"tile {row['tile64_rows']:.1f} distinct rows of "
                  f"{row['tile64_picks']:.1f} picks{note}", flush=True)
    return rows_out


def readout_inputs(torch):
    """The readout phase's inputs as ``kernel_phases`` makes them (the same
    seed and order): the values [2, 72 slots, CV] and the package's default
    selection (``topk_select``) of every case, (case, N) -> (vals, idx)."""
    from eva_vos_tpu_torch.kernels import topk_select

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(0)
    qk = torch.randn((N_QUERIES, CK), generator=gen, device=dev).to(
        torch.bfloat16)
    mv2 = torch.randn((2, max(FILLS) * HW_TOKENS, CV), generator=gen,
                      device=dev).to(torch.bfloat16)
    sels = {}
    for clustered in (False, True):
        for fill in FILLS:
            mk, valid = make_bank(torch, gen, qk, fill, clustered)
            case = f"fill{fill}_{'clustered' if clustered else 'random'}"
            for n in (N_QUERIES, HW_TOKENS):
                sels[(case, n)] = topk_select(qk[:n], mk, valid, TOP_K)
    return mv2, sels


def kernel_phases(torch, results):
    from eva_vos_tpu_torch.kernels import (select_topk, topk_select,
                                           topk_select_chunked,
                                           topk_select_grid, topk_select_iter,
                                           topk_select_plain,
                                           topk_select_resident,
                                           topk_select_sort)
    from eva_vos_tpu_torch.kernels.memory_topk import (_SELECT_BLOCK,
                                                       iter_segments,
                                                       resident_segments)
    from eva_vos_tpu_torch.ops.memory_attention import (_scores,
                                                        memory_affinity_topk,
                                                        softmax_weights)

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(0)
    qk = torch.randn((N_QUERIES, CK), generator=gen, device=dev).to(
        torch.bfloat16)
    mv2 = torch.randn((2, max(FILLS) * HW_TOKENS, CV), generator=gen,
                      device=dev).to(torch.bfloat16)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    esc = torch.zeros(1, dtype=torch.int32, device=dev)
    floored = torch.zeros(1, dtype=torch.int32, device=dev)
    sel_rows, sels = [], {}
    # the selections on the resident walk and their segment rules
    walks = {"memory_topk_resident": resident_segments,
             "memory_topk_iter": iter_segments}

    def topk_counted(q, mk, valid, top_k):
        return topk_select(q, mk, valid, top_k, escalations=esc)

    def chunked_counted(q, mk, valid, top_k, no_skip=False):
        return topk_select_chunked(q, mk, valid, top_k, no_skip=no_skip,
                                   escalations=esc, floored_rows=floored)

    def resident_counted(q, mk, valid, top_k):
        return topk_select_resident(q, mk, valid, top_k, compactions=esc)

    def grid_transposed(q, mk, valid, top_k):
        vals, idx = topk_select_grid(q, mk, valid, top_k, return_raw=True,
                                     escalations=esc)
        return vals.T, idx.T

    def iter_transposed(q, mk, valid, top_k):
        vals, idx = topk_select_iter(q, mk, valid, top_k, return_raw=True,
                                     compactions=esc)
        return vals.T, idx.T

    def sort_transposed(q, mk, valid, top_k):
        vals, idx = topk_select_sort(q, mk, valid, top_k, return_raw=True,
                                     escalations=esc)
        return vals.T, idx.T

    def entry_timed(kwargs):
        return lambda q, mk, valid: select_topk(mk, q, TOP_K, valid, **kwargs)

    # (name in the kernels line, transposed selection (counting escalations,
    # or the walks' compactions, in esc), the call timed: select_topk's for
    # the iterative and sort kernels)
    selectors = (
        ("memory_topk", topk_counted,
         lambda q, mk, valid: topk_select(q, mk, valid, TOP_K)),
        ("memory_topk_chunked", chunked_counted,
         lambda q, mk, valid: topk_select_chunked(q, mk, valid, TOP_K)),
        ("memory_topk_resident", resident_counted,
         lambda q, mk, valid: topk_select_resident(q, mk, valid, TOP_K)),
        ("memory_topk_grid", grid_transposed,
         lambda q, mk, valid: topk_select_grid(q, mk, valid, TOP_K)),
        ("memory_topk_iter", iter_transposed,
         entry_timed(ENTRY_KWARGS["memory_topk_iter"])),
        ("memory_topk_sort", sort_transposed,
         entry_timed(ENTRY_KWARGS["memory_topk_sort"])),
    )
    for clustered in (False, True):
        for fill in FILLS:
            mk, valid = make_bank(torch, gen, qk, fill, clustered)
            case = f"fill{fill}_{'clustered' if clustered else 'random'}"
            for n in (N_QUERIES, HW_TOKENS):
                q = qk[:n]
                ref_vals, ref_idx = topk_select_plain(q, mk, valid, TOP_K + 1)
                lib = library_times(torch, mk[:valid], q, ref_vals)
                lib_ms = min(lib.values())
                scores = _scores(mk[:valid], q)
                topk_only_ms = cuda_ms(
                    torch, lambda: torch.topk(scores, TOP_K, dim=1), 5)
                del scores
                plain_ms = cuda_ms(
                    torch, lambda: topk_select_plain(q, mk, valid, TOP_K), 3)
                affinity_ms = cuda_ms(
                    torch, lambda: memory_affinity_topk(mk, q, TOP_K, valid), 3)
                bound, by = selection_bound(n, valid)
                rows = n * -(-valid // _SELECT_BLOCK)
                for name, select, timed in selectors:
                    if n != N_QUERIES and name not in SINGLE_FRAME:
                        continue
                    esc.zero_()
                    floored.zero_()
                    vals, idx = select(q, mk, valid, TOP_K)
                    label = f"{name} {case} N={n}"
                    err, n_diff = check_selection(torch, vals, idx, ref_vals,
                                                  ref_idx, label)
                    if name == "memory_topk":
                        default_sel = (vals, idx)
                    elif name == "memory_topk_chunked" and not (
                            torch.equal(vals, default_sel[0])
                            and torch.equal(idx, default_sel[1])):
                        # the same scores, and an exact selection either way
                        fail(f"{label}: differs from the default selection")
                    if name in ROW_SELECTIONS:
                        w, wi = timed(q, mk, valid)
                        if not torch.equal(wi.T, idx) or not torch.allclose(
                                w, softmax_weights(vals.T), rtol=1e-6,
                                atol=1e-7):
                            fail(f"{label}: weights disagree with raw scores")
                    ms = cuda_ms(torch, lambda: timed(q, mk, valid), 10)
                    row = dict(kernel=name, case=case, n=n, max_abs_err=err,
                               ids_differ=n_diff, ms=ms,
                               plain_ms=(affinity_ms if name in ROW_SELECTIONS
                                         else plain_ms),
                               library_ms=lib_ms, library_fp32_ms=lib["fp32"],
                               library_tf32_ms=lib["tf32"],
                               topk_only_ms=topk_only_ms,
                               bound_ms=bound, bound_by=by)
                    note = ""
                    if name in walks:
                        segs = walks[name](n, valid, TOP_K, sms)
                        row.update(compactions=int(esc.item()), segments=segs)
                        row.update(split_ms(
                            torch, lambda: timed(q, mk, valid), name,
                            merged=segs > 1))
                        note = (f", segments {segs}, compactions "
                                f"{row['compactions']} ("
                                f"{row['compactions'] / n:.2f} a query), "
                                f"walk kernel {row['block_ms']:.3f} ms + "
                                f"merge kernel {row['merge_ms']:.3f} ms")
                    elif name in SPLIT_KERNELS:
                        row.update(split_ms(
                            torch, lambda: timed(q, mk, valid), name,
                            merged=valid > _SELECT_BLOCK),
                            escalated_rows=int(esc.item()), rows=rows)
                        note = (f", block kernel {row['block_ms']:.3f} ms + "
                                f"merge kernel {row['merge_ms']:.3f} ms, "
                                f"escalated rows {row['escalated_rows']} of "
                                f"{rows} ({row['escalated_rows'] / rows:.2e})")
                    if name == "memory_topk_chunked":
                        row["floored_rows"] = int(floored.item())
                        note += (f", floored rows {row['floored_rows']} of "
                                 f"{rows}")
                        row["no_skip"] = no_skip_case(
                            torch, q, mk, valid, (vals, idx), chunked_counted,
                            esc, floored, rows, label)
                    sel_rows.append(row)
                    print(f"[select] {label}: max|dv|={err:.3g} ids_differ="
                          f"{n_diff} kernel {ms:.3f} ms, plain "
                          f"{row['plain_ms']:.3f} ms, addmm+torch.topk "
                          f"{lib_ms:.3f} ms (fp32 {lib['fp32']:.3f}, tf32 "
                          f"{lib['tf32']:.3f}), topk_only {topk_only_ms:.3f} "
                          f"ms, bound {bound:.4f} ms ({by}){note}", flush=True)
                    if name == "memory_topk":
                        sels[(case, n)] = (vals, idx)
                if clustered and fill == max(FILLS) and n == N_QUERIES:
                    for name in WIDE_KERNELS:
                        results[f"{name}_wide"] = wide_case(
                            torch, name, q, mk, valid, esc)

            del mk
    results["selection"] = sel_rows
    results["readout"] = readout_cases(torch, mv2, sels, stage=True)


def entry_phase(torch, results):
    """``select_topk`` as a user calls it, at N = 8100 on a 72-slot
    clustered bank: with no method (the iterative kernel) and with
    method="sort".  Returns each kernel's launches from its call."""
    from eva_vos_tpu_torch.kernels import select_topk, topk_select_plain
    from eva_vos_tpu_torch.ops.memory_attention import softmax_weights

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(1)
    qk = torch.randn((N_QUERIES, CK), generator=gen, device=dev).to(
        torch.bfloat16)
    mk, valid = make_bank(torch, gen, qk, max(FILLS), clustered=True)
    ref_vals, ref_idx = topk_select_plain(qk, mk, valid, TOP_K + 1)
    counters = launch_counters()
    launches, rows = {}, []
    for name, kwargs in ENTRY_KWARGS.items():
        for c in counters.values():
            c.launches = 0
        w, idx = select_topk(mk, qk, TOP_K, valid, **kwargs)
        torch.cuda.synchronize()
        counts = {k: c.launches for k, c in counters.items()}
        if counts[name] <= 0 or sum(counts.values()) != counts[name]:
            fail(f"select_topk({kwargs}) launched {counts}, not {name}")
        launches[name] = counts[name]
        vals, raw_idx = select_topk(mk, qk, TOP_K, valid, return_raw=True,
                                    **kwargs)
        if not torch.equal(raw_idx, idx) or not torch.allclose(
                w, softmax_weights(vals), rtol=1e-6, atol=1e-7):
            fail(f"select_topk({kwargs}): weights disagree with raw scores")
        err, n_diff = check_selection(torch, vals.T, idx.T, ref_vals, ref_idx,
                                      f"select_topk({kwargs})")
        if w.shape != (N_QUERIES, TOP_K) or not torch.isfinite(w).all():
            fail(f"select_topk({kwargs}): weights {tuple(w.shape)} not finite")
        rows.append(dict(kernel=name, kwargs=kwargs, launches=counts,
                         max_abs_err=err, ids_differ=n_diff))
        print(f"[entry] select_topk(mk, qk, {TOP_K}, {valid}, **{kwargs}) "
              f"launched "
              f"{counts}; max|dv|={err:.3g} ids_differ={n_diff}", flush=True)
    results["entry"] = rows
    return launches


def engine_paths():
    """The engine's memory reads: name -> (EngineConfig fields, the kernels
    that read must launch)."""
    from eva_vos_tpu_torch.kernels import KernelConfig

    return {
        "fused": (dict(readout_strategy="auto"),
                  ("memory_topk", "memory_readout")),
        "select": (dict(readout_strategy="select"), ("memory_topk_grid",)),
        "fused_resident": (
            dict(readout_strategy="fused",
                 kernels=KernelConfig(sel_method="resident")),
            ("memory_topk_resident", "memory_readout")),
        "fused_chunked_chunked": (
            dict(readout_strategy="fused",
                 kernels=KernelConfig(sel_method="chunked",
                                      readout_method="chunked")),
            ("memory_topk_chunked", "memory_readout_chunked")),
    }


def launch_counters():
    from eva_vos_tpu_torch import kernels as K

    return {"memory_topk": K.topk_select,
            "memory_topk_chunked": K.topk_select_chunked,
            "memory_topk_resident": K.topk_select_resident,
            "memory_topk_grid": K.topk_select_grid,
            "memory_topk_iter": K.topk_select_iter,
            "memory_topk_sort": K.topk_select_sort,
            "memory_readout": K.topk_readout,
            "memory_readout_chunked": K.topk_readout_chunked}


def staged_counts(torch, run):
    """The chunked readout's staged rows and the picks it summed (top_k x N
    x K a call) over one ``run()``, through the fused read's READOUTS (a
    package without that table gives None)."""
    from eva_vos_tpu_torch.kernels import memory_readout as R

    if not hasattr(R, "READOUTS"):
        return None
    staged = torch.zeros(1, dtype=torch.int32, device=torch.device(DEVICE))
    counts = dict(calls=0, picks=0)
    saved = dict(R.READOUTS)

    def counted(readout):
        def call(mv, vals, idx, **kw):
            counts["calls"] += 1
            counts["picks"] += mv.shape[0] * vals.numel()
            return readout(mv, vals, idx, staged_rows=staged, **kw)
        return call

    R.READOUTS["chunked"] = counted(saved["chunked"])
    try:
        run()
        torch.cuda.synchronize()
    finally:
        R.READOUTS.update(saved)
    counts["staged_rows"] = int(staged.item())
    return counts


def engine_phase(torch, results, card):
    import numpy as np

    from eva_vos_tpu_torch.data import synthetic_video
    from eva_vos_tpu_torch.engine import (EngineConfig, InferenceEngine,
                                          pad_mask, prepare_video)
    from eva_vos_tpu_torch.models import FusionNet, PropagationNetwork

    t, h, w = ENGINE["t"], ENGINE["h"], ENGINE["w"]
    dtype = torch.bfloat16
    torch.manual_seed(0)
    stcn = PropagationNetwork(key_arch=ENGINE["key_arch"],
                              value_arch="resnet18").to(dtype)
    fusion = FusionNet().to(dtype)
    cfg = EngineConfig(mem_freq=5, top_k=TOP_K, max_interactions=60,
                       feature_chunk=2)
    base = InferenceEngine(stcn, fusion, cfg, device=DEVICE)
    if base.config.readout_strategy != "fused":
        fail(f"engine resolved {base.config.readout_strategy!r} on CUDA")
    images, masks = synthetic_video(t, h, w, num_objects=1, seed=0)
    t0 = time.perf_counter()
    padded, pad = prepare_video(images, dtype=dtype, device=DEVICE)
    feats = base.precompute_features(padded)
    torch.cuda.synchronize()
    precompute_s = time.perf_counter() - t0
    state0 = base.init_state(feats, 1)
    m0 = pad_mask(masks[:1, 0], pad, device=DEVICE)
    m30 = pad_mask(masks[:1, 30], pad, device=DEVICE)
    plain = InferenceEngine(stcn, fusion,
                            cfg._replace(readout_strategy="gather"),
                            device=DEVICE)
    counters = launch_counters()
    reads = engine_paths()
    engines = {path: InferenceEngine(stcn, fusion, cfg._replace(**fields),
                                     device=DEVICE)
               for path, (fields, _) in reads.items()}
    counts = {path: dict.fromkeys(counters, 0) for path in reads}

    def interact(path, state, mask, idx):
        """One untraced interact of a read, in host seconds; the counters,
        zeroed just before, are added to the read's counts just after."""
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = engines[path].interact(state, feats, mask, idx)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        for k, c in counters.items():
            counts[path][k] += c.launches
        return out, seconds

    per_interact, out0 = {}, {}
    for path, (_, kernels) in reads.items():                # warm-up
        out0[path], _ = interact(path, state0, m0, 0)
        per_interact[path] = {k: counts[path][k] for k in kernels}
    walls = {path: [] for path in reads}
    for _ in range(ENGINE_ITERS):             # round-robin: A, B, C, D, A, ...
        for path in reads:
            out0[path], seconds = interact(path, state0, m0, 0)
            walls[path].append(seconds)
    walls30, states = {path: [] for path in reads}, {}
    for _ in range(FRAME30_ITERS):   # from the frame-0 state (no donation)
        for path in reads:
            states[path], seconds = interact(path, out0[path], m30, 30)
            walls30[path].append(seconds)

    staged = {}   # one more frame-0 interact of the chunked read, counted
    for path, (_, kernels) in reads.items():
        if "memory_readout_chunked" in kernels:
            staged[path] = staged_counts(torch, lambda: engines[path].interact(
                state0, feats, m0, 0))
            if staged[path] is not None:
                c = staged[path]
                if c["staged_rows"] <= 0:
                    fail(f"{path}: its readout staged no row")
                print(f"[engine {path}] readout at frame 0: {c['calls']} "
                      f"calls, {c['staged_rows']} rows staged for "
                      f"{c['picks']} picks "
                      f"({c['picks'] / max(1, c['staged_rows']):.2f} picks a "
                      f"staged row)", flush=True)

    launches, paths = {}, {}
    for path, (_, kernels) in reads.items():
        engine, state = engines[path], states[path]
        fps_all = sorted((t - 1) / sec for sec in walls[path])
        fps = statistics.median(fps_all)
        fused_s = statistics.median(walls30[path])
        print(f"[engine {path}] fps median {fps:.2f} (min {fps_all[0]:.2f}, "
              f"max {fps_all[-1]:.2f}; {t - 1} frames x {ENGINE_ITERS} "
              f"interleaved interacts); interact at frame 30 median "
              f"{fused_s * 1e3:.1f} ms (min {min(walls30[path]) * 1e3:.1f}, "
              f"max {max(walls30[path]) * 1e3:.1f}; {FRAME30_ITERS} "
              f"untraced); precompute {precompute_s:.2f} s; on {card}",
              flush=True)
        print(f"[engine {path}] launches per interact at frame 0: "
              f"{per_interact[path]}; whole path: {counts[path]}", flush=True)
        if min(counts[path][k] for k in kernels) <= 0:
            fail(f"{path}: a kernel of the path was not launched: "
                 f"{counts[path]}")
        for k in kernels:
            launches.setdefault(k, counts[path][k])
        if not torch.isfinite(state.prob).all():
            fail(f"{path}: non-finite probabilities after the fused "
                 f"interaction")
        sums = state.prob.sum(0)
        if (sums - 1).abs().max().item() > 1e-3:
            fail(f"{path}: probabilities do not sum to 1")
        if int(state.certain_count) != 2 or state.interacted.sum() != 2:
            fail(f"{path}: state bookkeeping wrong after two interactions")
        ids = engine.masks_from_prob(state.prob, pad)
        if ids.shape != (t, h, w):
            fail(f"{path}: mask shape {ids.shape}")

        # one blocked segmentation step (frames 31..35 against the bank the
        # frame-30 interaction left) through the kernels and the plain read
        front = state.certain_count + 5  # the backward pass's transients
        tis = list(range(31, 36))
        with torch.no_grad():
            got = engine._segment_frames(feats, state.bank_k, state.bank_v,
                                         front, tis).float()
            want = plain._segment_frames(feats, state.bank_k, state.bank_v,
                                         front, tis).float()
        diff = (got - want).abs()
        frac = (diff > PROB_ATOL).float().mean().item()
        if not torch.isfinite(got).all() or frac > PROB_FRAC:
            fail(f"{path}: segmentation step: {frac:.2e} of pixels off by > "
                 f"{PROB_ATOL}")
        print(f"[engine {path}] blocked step kernels vs plain: max|dp|="
              f"{diff.max().item():.3g}, mean {diff.mean().item():.3g}, share "
              f"> {PROB_ATOL}: {frac:.2e}", flush=True)
        paths[path] = dict(
            fps=fps, fps_min=fps_all[0], fps_max=fps_all[-1],
            interact0_s=walls[path], interact30_s=fused_s,
            interact30_all_s=walls30[path],
            launches_per_interact=per_interact[path], launches=counts[path],
            readout_staged0=staged.get(path),
            step_max_abs_dp=diff.max().item(), step_share_off=frac,
            foreground_share=float(np.mean(ids > 0)))
    results["engine"] = dict(precompute_s=precompute_s, paths=paths)
    return launches, (base, images, masks), (feats, pad)


def step_phase(torch, results, card):
    """Phase 6b: the propagation step entry point at its defaults, the
    'fused' step against a 'gather' step on the same weights and inputs,
    #1 and #2 once each a fused step, STEP_ITERS untraced steps of each
    read after a warm-up, interleaved."""
    from eva_vos_tpu_torch.entry import entry

    step, args = entry(device=DEVICE)
    plain, _ = entry(device=DEVICE, strategy="gather")
    counters = launch_counters()
    path = {"memory_topk": 1, "memory_readout": 1}
    want_counts = {k: path.get(k, 0) for k in counters}

    def run(fn):
        """One untraced step in host seconds, and the launches it made
        (the counters zeroed just before it and read just after)."""
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, time.perf_counter() - start, {
            k: c.launches for k, c in counters.items()}

    got, _, counts = run(step)                                 # warm-up
    want, _, plain_counts = run(plain)
    times = {"fused": [], "gather": []}
    for _ in range(STEP_ITERS):                # interleaved: fused, gather
        got, seconds, c = run(step)
        times["fused"].append(seconds)
        if c != want_counts:
            fail(f"[step] a fused step launched {c}, not {want_counts}")
        _, seconds, c = run(plain)
        times["gather"].append(seconds)
        if any(c.values()):
            fail(f"[step] a gather step launched {c}")
    if counts != want_counts or any(plain_counts.values()):
        fail(f"[step] warm-up launches: fused {counts}, gather "
             f"{plain_counts}")
    if tuple(got.shape) != (2, 480, 864) or got.dtype != torch.float32:
        fail(f"[step] output {tuple(got.shape)} {got.dtype}")
    if not torch.isfinite(got).all():
        fail("[step] non-finite probabilities")
    sum_err = (got.sum(0) - 1).abs().max().item()
    if sum_err > 1e-3:
        fail(f"[step] probabilities sum to 1 within {sum_err:.3g}")
    diff = (got - want).abs()
    frac = (diff > PROB_ATOL).float().mean().item()
    if frac > PROB_FRAC:
        fail(f"[step] fused vs gather: {frac:.2e} of probabilities off by "
             f"> {PROB_ATOL}")
    ms = {k: sorted(1e3 * x for x in v) for k, v in times.items()}
    trace = step_trace(torch, step, args)
    print(f"[step] entry() fused vs gather: max|dp|={diff.max().item():.3g}, "
          f"share > {PROB_ATOL}: {frac:.2e}; channel sums within "
          f"{sum_err:.2e}; launches a fused step {counts}", flush=True)
    print(f"[step] untraced step ms, {STEP_ITERS} interleaved after a "
          f"warm-up: fused median {statistics.median(ms['fused']):.2f} (min "
          f"{ms['fused'][0]:.2f}, max {ms['fused'][-1]:.2f}), gather median "
          f"{statistics.median(ms['gather']):.2f} (min {ms['gather'][0]:.2f}"
          f", max {ms['gather'][-1]:.2f}); on {card}", flush=True)
    print(f"[step] traced fused step ({STEP_ITERS} steps): device busy "
          f"{trace['busy_ms']:.3f} ms a step in {trace['kernels']} kernels; "
          f"#1 {trace['topk_ms']:.4f} ms, #2 {trace['readout_ms']:.4f} ms; "
          f"idle share of the untraced median "
          f"{1 - trace['busy_ms'] / statistics.median(ms['fused']):.3f}",
          flush=True)
    results["step"] = dict(
        ms=ms, trace=trace, launches_per_step=counts,
        max_abs_dp=diff.max().item(),
        share_off=frac, sum_err=sum_err,
        foreground_mean=got[1].mean().item())


def step_trace(torch, step, args) -> dict:
    """Device time of the fused step's kernels a step over STEP_ITERS
    steps, from a ``torch.profiler`` trace: all of them (busy), #1's block
    and merge kernels, and #2's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(STEP_ITERS):
            step(*args)
        torch.cuda.synchronize()
    us = [(e.name, e.time_range.end - e.time_range.start)
          for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not us:
        fail("[step] the profiler's trace holds no kernel")

    def ms(*names):
        return sum(t for n, t in us if any(k in n for k in names)) / (
            STEP_ITERS * 1e3)

    return {"busy_ms": ms(""), "kernels": len(us) // STEP_ITERS,
            "topk_ms": ms("topk_prune_block_kernel", "topk_merge_t_kernel"),
            "readout_ms": ms("readout_kernel")}


def named_ms(torch, fn, per_call: dict, reps: int = 5,
             tries: int = 3) -> dict:
    """Device ms a call of ``fn`` of each kernel whose name holds a key of
    ``per_call`` (its launches a call), from a ``torch.profiler`` trace of
    ``reps`` calls: the mean time of its events times its launches a call
    (a trace may miss an event), and "all", their sum.  A trace that holds
    no event of a launched kernel (the profiler has dropped all of a
    kernel of a few microseconds) is taken again, up to ``tries`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [(e.name, e.time_range.end - e.time_range.start)
              for e in prof.events() if e.device_type == DeviceType.CUDA]
        mine = {k: [t for n, t in us if k in n] for k in per_call}
        missing = [k for k, n in per_call.items() if n and not mine[k]]
        if not missing:
            out = {k: sum(mine[k]) / max(1, len(mine[k])) * n / 1e3
                   for k, n in per_call.items()}
            out["all"] = sum(out.values())
            return out
    fail(f"the profiler's traces of {reps} calls hold no {missing}")


def radix_launches(kk: int, valid: int) -> dict:
    """#1's radix path's kernels (RADIX_KERNELS) -> launches a call, for
    kk = min(top_k, valid) of ``valid`` tokens: the norms and the radix
    select, the candidates' top below the valid tokens, the lists' sort (a
    warp a query up to RADIX_ROW_SORT keys, else chunks and merge passes
    above RADIX_SORT_CHUNK), the transposed write."""
    from eva_vos_tpu_torch.kernels.memory_topk import (RADIX_ROW_SORT,
                                                       RADIX_SORT_CHUNK)

    merges = max(0, math.ceil(math.log2(-(-kk // RADIX_SORT_CHUNK))))
    rows_sort = 0 < kk <= RADIX_ROW_SORT
    return dict(zip(RADIX_KERNELS, (
        int(kk > 0), int(kk > 0), int(0 < kk < valid), int(rows_sort),
        int(kk > 0 and not rows_sort), merges, 1)))


def large_k_case(torch, q, mk, valid, mv, k, label, rows):
    """#1 at top_k ``k`` (> 256: the radix select) against its plain
    version with ``check_selection``'s rule, its dead slots (-1e30, 0),
    and #2 on its picks against the plain readout, both timed beside
    their plain versions, library calls and bounds."""
    from eva_vos_tpu_torch import kernels as K
    from eva_vos_tpu_torch.kernels import memory_readout as R
    from eva_vos_tpu_torch.ops.memory_attention import softmax_weights

    fp32 = q.dtype == torch.float32
    n = q.shape[0]
    ref_vals, ref_idx = K.topk_select_plain(q, mk, valid, k + 1)
    K.topk_select.launches = 0
    overflow, scorings = (torch.zeros(1, dtype=torch.int32, device=q.device)
                          for _ in range(2))
    vals, idx = K.topk_select(q, mk, valid, k, escalations=overflow,
                              scorings=scorings)
    torch.cuda.synchronize()
    if K.topk_select.launches != 1:
        fail(f"{label}: topk_select launched {K.topk_select.launches} times")
    kk = min(k, valid)
    dead = int(k - kk)
    err, n_diff = check_selection(torch, vals[:kk], idx[:kk],
                                  ref_vals[:kk + 1], ref_idx[:kk + 1], label,
                                  kk)
    if not (bool((vals[kk:] == -1e30).all()) and bool((idx[kk:] == 0).all())):
        fail(f"{label}: the {dead} slots past the live tokens are not "
             f"(-1e30, 0)")
    call = lambda: K.topk_select(q, mk, valid, k)  # noqa: E731
    split = named_ms(torch, call, radix_launches(kk, valid))
    sort_ms = (split["topk_sort_rows_kernel"]
               + split["topk_sort_chunks_kernel"])
    # the library call selects the live kk (torch.topk takes no k above
    # the valid tokens; the dead slots are constants)
    lib = library_times(torch, mk[:valid], q, ref_vals, kk)
    bound, by = selection_bound(n, valid, k, fp32)
    sel = dict(kernel="memory_topk_radix", case=label, n=n, valid=valid,
               top_k=k, dead_slots=dead, max_abs_err=err, ids_differ=n_diff,
               overflow_queries=int(overflow), scorings=int(scorings),
               ms=split["all"], split_ms={x: split[x] for x in RADIX_KERNELS},
               call_ms=cuda_ms(torch, call, 5),
               plain_ms=cuda_ms(torch, lambda: K.topk_select_plain(
                   q, mk, valid, k), 3),
               library_ms=min(lib.values()), library_fp32_ms=lib["fp32"],
               library_tf32_ms=lib["tf32"], bound_ms=bound, bound_by=by)
    rows["selection"].append(sel)
    print(f"[large-k] #1 {label}: max|dv|={err:.3g} ids_differ={n_diff} "
          f"dead slots {dead}; {sel['scorings']} scorings of the bank, "
          f"{sel['overflow_queries']} queries past the cap; device "
          f"{sel['ms']:.3f} ms (norms {split['topk_key_norms_kernel']:.4f}, "
          f"radix {split['topk_radix_kernel']:.3f}, candidates "
          f"{split['topk_cand_select_kernel']:.3f}, sort "
          f"{sort_ms:.3f}, merge "
          f"{split['topk_rank_merge_kernel']:.3f}, transpose "
          f"{split['topk_keys_t_kernel']:.3f}), {sel['call_ms']:.3f} ms a "
          f"call, plain {sel['plain_ms']:.3f} ms, addmm+torch.topk "
          f"{sel['library_ms']:.3f} ms (fp32 {lib['fp32']:.3f}, tf32 "
          f"{lib['tf32']:.3f}), bound {bound:.4f} ms ({by})", flush=True)

    ref = K.topk_readout_plain(mv, vals, idx)
    counts = torch.zeros(2, dtype=torch.int32, device=mv.device)
    out = K.topk_readout(mv, vals, idx, counts=counts)
    if fp32:
        torch.testing.assert_close(out, ref, rtol=0, atol=FP32_READOUT_ATOL)
    else:
        torch.testing.assert_close(out.float(), ref.float(),
                                   rtol=READOUT_RTOL, atol=READOUT_ATOL)
    if not torch.equal(K.topk_readout(mv, vals, idx), out):
        fail(f"{label}: two runs of the readout differ")
    # the rows staged and the dense stages against the plan's plain
    # statement, and each branch's tiles
    queries = R.large_k_geometry(n, 1, mv.shape[2], mv.element_size(),
                                 R._sm_count(mv.device))[0]
    _, staged, dense = R.readout_large_k_plain(mv, vals, idx, queries)
    if counts.tolist() != [staged, dense]:
        fail(f"{label}: the readout counted {counts.tolist()} (rows staged, "
             f"dense stages), its plan {[staged, dense]}")
    tiles = R.large_k_tiles(vals, idx, queries,
                            mv.shape[2] * mv.element_size(), not fp32)
    modes = {m: sum(t[0] == m for t in tiles)
             for m in ("dense", "sparse", "direct")}
    picks = sum(t[1] for t in tiles if t[0] != "direct")
    w = softmax_weights(vals.T).to(mv.dtype).contiguous()
    ids = idx.T.long().contiguous()
    (rbound, rby), unique = readout_bound(idx, 1, vals, mv.element_size())
    ro = dict(kernel="memory_readout_large_k", case=label, n=n, top_k=k,
              max_abs_err=(out.float() - ref.float()).abs().max().item(),
              ms=named_ms(torch, lambda: K.topk_readout(mv, vals, idx),
                          {LARGE_K_READOUT: 1})[LARGE_K_READOUT],
              call_ms=cuda_ms(torch, lambda: K.topk_readout(mv, vals, idx),
                              10),
              plain_ms=cuda_ms(torch, lambda: K.topk_readout_plain(
                  mv, vals, idx), 3),
              library_ms=device_ms(torch, lambda: torch.nn.functional
                                   .embedding_bag(ids, mv[0], mode="sum",
                                                  per_sample_weights=w)),
              bound_ms=rbound, bound_by=rby, unique_rows=unique,
              queries=queries, tiles=modes, staged_rows=staged,
              staged_picks=picks, dense_stages=dense)
    rows["readout"].append(ro)
    share = f"{picks / staged:.2f}" if staged else "-"
    print(f"[large-k] #2 {label}: max|d|={ro['max_abs_err']:.3g}; device "
          f"{ro['ms']:.4f} ms, {ro['call_ms']:.3f} ms a call, plain "
          f"{ro['plain_ms']:.3f} ms, embedding_bag {ro['library_ms']:.3f} "
          f"ms, bound {rbound:.4f} ms ({rby}), unique rows {unique}; "
          f"{queries}-query tiles {modes}, rows staged {staged} (picks per "
          f"staged row {share}), dense stages {dense}", flush=True)


def large_k_kernels(torch):
    """#1 and #2 above top_k 256 at N = N_QUERIES on the clustered banks
    of FILLS (bf16, each LARGE_K; fp32 at LARGE_K_FP32), and #1's merge
    passes on LARGE_K_MERGE, checked against the plain selection."""
    from eva_vos_tpu_torch import kernels as K

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(2)
    qk = torch.randn((N_QUERIES, CK), generator=gen, device=dev).to(
        torch.bfloat16)
    mv = torch.randn((1, max(FILLS) * HW_TOKENS, CV), generator=gen,
                     device=dev).to(torch.bfloat16)
    rows = dict(selection=[], readout=[])
    for fill in FILLS:
        mk, valid = make_bank(torch, gen, qk, fill, clustered=True)
        for k in LARGE_K:
            large_k_case(torch, qk, mk, valid, mv, k,
                         f"fill{fill}_clustered N={N_QUERIES} top_k={k} bf16",
                         rows)
        if fill == max(FILLS):
            rows["k50"] = small_k_beside(torch, qk, mk, valid)
        if fill == LARGE_K_FP32[0]:
            k = LARGE_K_FP32[1]
            large_k_case(torch, qk.float(), mk.float(), valid, mv.float(), k,
                         f"fill{fill}_clustered N={N_QUERIES} top_k={k} fp32",
                         rows)
        del mk
    n, m, k = LARGE_K_MERGE
    q = torch.randn((n, CK), generator=gen, device=dev).to(torch.bfloat16)
    mk = torch.randn((m, CK), generator=gen, device=dev).to(torch.bfloat16)
    ref_vals, ref_idx = K.topk_select_plain(q, mk, m, k + 1)
    vals, idx = K.topk_select(q, mk, m, k)
    err, n_diff = check_selection(torch, vals, idx, ref_vals, ref_idx,
                                  f"merge passes N={n} M={m} top_k={k}", k)
    print(f"[large-k] #1 merge passes N={n} M={m} top_k={k} bf16: "
          f"max|dv|={err:.3g} ids_differ={n_diff}", flush=True)
    rows["merge"] = dict(n=n, m=m, top_k=k, max_abs_err=err,
                         ids_differ=n_diff)
    return rows


def small_k_beside(torch, q, mk, valid):
    """#1 at top_k TOP_K on a large-k case's bank (the pruned kernels, in
    the same source): checked, and timed by kernel, so that a slowdown of
    the code they share shows beside the large-k times."""
    from eva_vos_tpu_torch import kernels as K

    ref_vals, ref_idx = K.topk_select_plain(q, mk, valid, TOP_K + 1)
    vals, idx = K.topk_select(q, mk, valid, TOP_K)
    err, n_diff = check_selection(torch, vals, idx, ref_vals, ref_idx,
                                  f"#1 top_k={TOP_K} beside the large-k cases")
    split = named_ms(torch, lambda: K.topk_select(q, mk, valid, TOP_K),
                     dict.fromkeys(PRUNED_KERNELS, 1))
    print(f"[large-k] #1 at top_k {TOP_K} on the same bank (valid {valid}): "
          f"max|dv|={err:.3g} ids_differ={n_diff}; device {split['all']:.3f}"
          f" ms (block {split[PRUNED_KERNELS[0]]:.3f}, merge "
          f"{split[PRUNED_KERNELS[1]]:.3f})", flush=True)
    return dict(top_k=TOP_K, valid=valid, max_abs_err=err, ids_differ=n_diff,
                ms=split["all"],
                split_ms={x: split[x] for x in PRUNED_KERNELS})


def large_k_engine(torch, card, base, feats, pad, masks):
    """Phase 6's engine at top_k LARGE_K_ENGINE: the fused read (#1 and #2
    above 256) against the gather read on a frame-0 interact and on a
    frame-30 interact from the fused frame-0 state; #1 and #2 as often as
    in the same interacts at top_k 50 and no other kernel; LARGE_K_ITERS
    untraced frame-0 interacts a read (fused at LARGE_K_ENGINE, gather at
    LARGE_K_ENGINE, fused at top_k 50), interleaved."""
    from eva_vos_tpu_torch.engine import InferenceEngine, pad_mask

    cfg = base.config._replace(top_k=LARGE_K_ENGINE)
    engines = {
        "fused": InferenceEngine(base.stcn, base.fusion, cfg, device=DEVICE),
        "gather": InferenceEngine(base.stcn, base.fusion,
                                  cfg._replace(readout_strategy="gather"),
                                  device=DEVICE),
        "fused_k50": base}
    counters = launch_counters()
    state0 = base.init_state(feats, 1)
    m0 = pad_mask(masks[:1, 0], pad, device=DEVICE)
    m30 = pad_mask(masks[:1, 30], pad, device=DEVICE)

    def interact(name, state, mask, idx):
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = engines[name].interact(state, feats, mask, idx)
        torch.cuda.synchronize()
        return out, time.perf_counter() - start, {
            k: c.launches for k, c in counters.items()}

    out0, counts0 = {}, {}
    for name in engines:                                    # warm-up
        out0[name], _, counts0[name] = interact(name, state0, m0, 0)
    walls = {name: [] for name in engines}
    for _ in range(LARGE_K_ITERS):
        for name in engines:
            out0[name], seconds, counts = interact(name, state0, m0, 0)
            walls[name].append(seconds)
            if counts != counts0[name]:
                fail(f"[large-k engine] {name}: frame-0 launches {counts}, "
                     f"then {counts0[name]}")
    out30, counts30 = {}, {}
    for name in engines:
        out30[name], _, counts30[name] = interact(name, out0["fused"], m30, 30)
    path = ("memory_topk", "memory_readout")
    for frame, counts in ((0, counts0), (30, counts30)):
        want = {k: counts["fused_k50"][k] if k in path else 0
                for k in counters}
        if counts["fused"] != want or min(want[k] for k in path) <= 0:
            fail(f"[large-k engine] frame {frame}: top_k {LARGE_K_ENGINE} "
                 f"launched {counts['fused']}, top_k 50 {counts['fused_k50']}")
        if any(counts["gather"].values()):
            fail(f"[large-k engine] frame {frame}: the gather read launched "
                 f"{counts['gather']}")
    checks = {}
    for frame, out in ((0, out0), (30, out30)):
        got, want = out["fused"].prob, out["gather"].prob
        if not torch.isfinite(got).all():
            fail(f"[large-k engine] frame {frame}: non-finite probabilities")
        frac, dmax = prob_off(torch, got, want)
        if frac > PROB_FRAC:
            fail(f"[large-k engine] frame {frame}: fused vs gather {frac:.2e}"
                 f" of probabilities off by > {PROB_ATOL}")
        checks[frame] = dict(share_off=frac, max_abs_dp=dmax)
    ms = {k: sorted(1e3 * x for x in v) for k, v in walls.items()}
    print(f"[large-k engine] top_k {LARGE_K_ENGINE}: fused vs gather "
          f"frame 0 max|dp|={checks[0]['max_abs_dp']:.3g} share > "
          f"{PROB_ATOL}: {checks[0]['share_off']:.2e}, frame 30 max|dp|="
          f"{checks[30]['max_abs_dp']:.3g} share "
          f"{checks[30]['share_off']:.2e}; launches at frame 0 "
          f"{ {k: v for k, v in counts0['fused'].items() if v} } (top_k 50: "
          f"the same), at frame 30 "
          f"{ {k: v for k, v in counts30['fused'].items() if v} }", flush=True)
    print(f"[large-k engine] untraced frame-0 interact ms, {LARGE_K_ITERS} "
          f"interleaved: " + ", ".join(
              f"{k} median {statistics.median(v):.1f} (min {v[0]:.1f}, max "
              f"{v[-1]:.1f})" for k, v in ms.items()) + f"; on {card}",
          flush=True)
    return dict(top_k=LARGE_K_ENGINE, ms=ms, checks=checks,
                launches0=counts0["fused"], launches30=counts30["fused"])


def large_k_cli(torch, card, images, masks):
    """The eval CLI's ``main`` with ``--top-k LARGE_K_ENGINE`` (oracle_mask,
    LARGE_K_ROUNDS rounds, fp32) on phase 11's one-video DAVIS_17 tree: it
    completes, #1 and #2 launch every round and no other kernel, and its
    CSV equals a direct call on an engine at the same top_k (annotation
    times exactly, ``mu_metric`` within CLI_MU_ATOL)."""
    import os
    import tempfile

    from eva_vos_tpu_torch import interactions as I
    from eva_vos_tpu_torch.cli import eval_annotation_method as cli
    from eva_vos_tpu_torch.data.datasets import AnnotationDataset
    from eva_vos_tpu_torch.engine import EngineConfig, InferenceEngine
    from eva_vos_tpu_torch.utils import model_zoo
    from eva_vos_tpu_torch.utils.table import read_columns

    env_keys = ("EVAVOS_DATA_ROOT", "EVAVOS_WEIGHTS_ROOT",
                "EVAVOS_NUM_PROCESSES")
    saved_env = {k: os.environ.get(k) for k in env_keys}
    deterministic = torch.backends.cudnn.deterministic
    counters = launch_counters()
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    try:
        torch.backends.cudnn.deterministic = True
        os.environ["EVAVOS_DATA_ROOT"] = str(root / "data")
        os.environ["EVAVOS_WEIGHTS_ROOT"] = str(root / "weights")
        os.environ.pop("EVAVOS_NUM_PROCESSES", None)
        (root / "weights").mkdir()
        write_davis_tree(root / "data", images, masks)
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        start = time.perf_counter()
        path = Path(cli.main([
            "--policy", "oracle_mask", "--rounds", str(LARGE_K_ROUNDS),
            "--db", "DAVIS_17", "--allow-random", "--top-k",
            str(LARGE_K_ENGINE), "--out-dir", str(root / "exp"), "--device",
            DEVICE]))
        torch.cuda.synchronize()
        main_s = time.perf_counter() - start
        launches = {k: c.launches for k, c in counters.items() if c.launches}
        if set(launches) != {"memory_topk", "memory_readout"} or min(
                launches.values()) < LARGE_K_ROUNDS:
            fail(f"[large-k cli] launched {launches} in {LARGE_K_ROUNDS} "
                 f"rounds")
        table = read_columns(path)
        sample = AnnotationDataset(
            root / "data" / "DAVIS_17",
            root / "data" / "DAVIS_17" / "ImageSets" / "2017" / "val.txt")[0]
        engine = InferenceEngine(
            model_zoo.load_stcn(allow_random=True, device=DEVICE),
            model_zoo.load_fusion(allow_random=True, device=DEVICE),
            EngineConfig(top_k=LARGE_K_ENGINE,
                         max_interactions=LARGE_K_ROUNDS + 2), device=DEVICE)
        mus, times = I.oracle_mask(LARGE_K_ROUNDS, engine, sample, "j_and_f")
        d_mu = max(abs(float(a) - b) for a, b in zip(table["mu_metric"], mus))
        print(f"[large-k cli] --top-k {LARGE_K_ENGINE}: main {main_s:.2f} s, "
              f"{len(table['video'])} rows, launches {launches}; against the "
              f"direct call: times {table['annotation_time']} / {times}, "
              f"largest |d mu_metric| {d_mu:.3g}; on {card}", flush=True)
        if [float(x) for x in table["annotation_time"]] != \
                [float(x) for x in times]:
            fail(f"[large-k cli] annotation times {table['annotation_time']}"
                 f", direct {times}")
        if len(mus) != len(table["mu_metric"]) or d_mu > CLI_MU_ATOL:
            fail(f"[large-k cli] mu_metric {table['mu_metric']}, direct {mus}")
        return dict(main_s=main_s, launches=launches, d_mu=d_mu,
                    mu=table["mu_metric"], direct_mu=mus)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        tmp.cleanup()


def large_k_phase(torch, results, card, base, feats, pad, images, masks):
    """Phase 6c: the default read above top_k 256 (kernels, engine, CLI).
    Returns the large-k kernels' launches on the engine's fused interacts
    (the warm-up and the timed ones at frame 0, one at frame 30)."""
    phase_start = time.perf_counter()
    out = large_k_kernels(torch)
    out["engine"] = large_k_engine(torch, card, base, feats, pad, masks)
    out["cli"] = large_k_cli(torch, card, images, masks)
    out["phase_s"] = time.perf_counter() - phase_start
    print(f"[large-k] the phase took {out['phase_s']:.1f} s on {card}",
          flush=True)
    results["large_k"] = out
    e = out["engine"]
    runs = LARGE_K_ITERS + 1
    return {"memory_topk_radix": runs * e["launches0"]["memory_topk"]
            + e["launches30"]["memory_topk"],
            "memory_readout_large_k": runs * e["launches0"]["memory_readout"]
            + e["launches30"]["memory_readout"]}


def width_selectors():
    """Phase 6d's kernels: name -> (the selection as (vals [k, N] raw
    scores, idx [k, N]), the wrapper that counts its launches and pads)."""
    from eva_vos_tpu_torch import kernels as K

    def rows(fn):
        def transposed(q, mk, valid, k):
            vals, idx = fn(q, mk, valid, k, return_raw=True)
            return vals.T, idx.T
        return transposed

    return {"memory_topk": (K.topk_select, K.topk_select),
            "memory_topk_chunked": (K.topk_select_chunked,
                                    K.topk_select_chunked),
            "memory_topk_resident": (K.topk_select_resident,
                                     K.topk_select_resident),
            "memory_topk_grid": (rows(K.topk_select_grid),
                                 K.topk_select_grid),
            "memory_topk_iter": (rows(K.topk_select_iter),
                                 K.topk_select_iter),
            "memory_topk_sort": (rows(K.topk_select_sort),
                                 K.topk_select_sort)}


def width_launches(name: str, n: int, valid: int, k: int, padded: bool,
                   sms: int) -> dict:
    """The kernels one call of selection ``name`` of width_selectors()
    launches, as a trace names them -> launches a call, from the wrappers'
    plans: the radix path's above PRUNED_MAX_K (radix_launches), else the
    block (or walk) kernel and, where the bank takes several blocks (or
    segments), the merge (SPLIT_KERNELS); with the keys ``padded``, the
    pad's fill and copy of qk and of the valid keys (PAD_KERNELS)."""
    from eva_vos_tpu_torch.kernels.memory_topk import (
        _SELECT_BLOCK, PRUNED_MAX_K, iter_segments, resident_segments)

    if k > PRUNED_MAX_K:
        out = radix_launches(min(k, valid), valid)
    else:
        block, merge = SPLIT_KERNELS[name]
        segments = {"memory_topk_resident": resident_segments,
                    "memory_topk_iter": iter_segments}.get(name)
        merged = (segments(n, valid, k, sms) > 1 if segments
                  else valid > _SELECT_BLOCK)
        out = {block: 1, merge: int(merged)}
    if padded:
        out.update(PAD_KERNELS)
    return out


def width_case(torch, name, q, mk, valid, k, ref, label, rows):
    """Kernel ``name`` of width_selectors() on one bank at keys as wide as
    ``q``: launched once, padded once where the width is not one the
    kernels are built for, checked against the plain selection ``ref``
    (``check_selection``'s rule), its device ms (``stream_ms``: CUDA
    events around back-to-back calls, the pad's copies included) and each
    of its kernels' (``named_ms`` on ``width_launches``, from a trace)
    beside its bound and the library's addmm + torch.topk at the same
    width."""
    from eva_vos_tpu_torch.kernels.memory_topk import key_width

    fn, counted = width_selectors()[name]
    ck, fp32 = q.shape[1], q.dtype == torch.float32
    launches, pads = counted.launches, counted.pads
    vals, idx = fn(q, mk, valid, k)
    torch.cuda.synchronize()
    padded = int(key_width(ck)[1] > 0)
    if (counted.launches - launches, counted.pads - pads) != (1, padded):
        fail(f"[widths] {label}: {counted.launches - launches} launches and "
             f"{counted.pads - pads} pads, not 1 and {padded}")
    err, n_diff = check_selection(torch, vals, idx, ref[0], ref[1], label, k)
    ms = stream_ms(torch, lambda: fn(q, mk, valid, k))
    split = named_ms(torch, lambda: fn(q, mk, valid, k), width_launches(
        name, q.shape[0], valid, k, bool(padded),
        torch.cuda.get_device_properties(q.device).multi_processor_count))
    traced = split.pop("all")
    pad_ms = sum(split[x] for x in PAD_KERNELS) if padded else 0.0
    bound, by = selection_bound(q.shape[0], valid, k, fp32, ck)
    lib = library_times(torch, mk[:valid], q, ref[0], k)
    row = dict(kernel="memory_topk_radix" if k > 256 else name, case=label,
               ck=ck, n=q.shape[0], valid=valid, top_k=k,
               dtype="fp32" if fp32 else "bf16", max_abs_err=err,
               ids_differ=n_diff, pads=counted.pads - pads, ms=ms,
               traced_ms=traced, pad_ms=pad_ms, split_ms=split,
               bound_ms=bound, bound_by=by, library_ms=min(lib.values()))
    rows.append(row)
    print(f"[widths] {label}: max|dv|={err:.3g} ids_differ={n_diff} pads "
          f"{row['pads']}; device {ms:.4f} ms (kernels in a trace "
          f"{traced:.4f}, pad {pad_ms:.4f}), addmm+torch.topk "
          f"{row['library_ms']:.3f} ms, bound {bound:.4f} ms ({by})",
          flush=True)


def width_kernels(torch):
    """Each selection kernel at each of KEY_WIDTHS_CK (bf16, top_k TOP_K;
    #1 also at LARGE_K[0]) on a clustered bank at fill WIDTH_FILL, N =
    N_QUERIES; #1 in fp32 at WIDTH_FP32 and at fill max(FILLS) at
    WIDTH_FULL; a CUDA call at 300 must raise naming the cap."""
    from eva_vos_tpu_torch import kernels as K
    from eva_vos_tpu_torch.kernels.memory_topk import MAX_KEY_WIDTH

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(3)
    rows = []
    for ck in KEY_WIDTHS_CK:
        qk = torch.randn((N_QUERIES, ck), generator=gen, device=dev).to(
            torch.bfloat16)
        mk, valid = make_bank(torch, gen, qk, WIDTH_FILL, clustered=True)
        ref = K.topk_select_plain(qk, mk, valid, LARGE_K[0] + 1)
        for name in width_selectors():
            width_case(torch, name, qk, mk, valid, TOP_K, ref,
                       f"{name} CK={ck} fill{WIDTH_FILL} top_k={TOP_K} bf16",
                       rows)
        width_case(torch, "memory_topk", qk, mk, valid, LARGE_K[0], ref,
                   f"memory_topk CK={ck} fill{WIDTH_FILL} top_k={LARGE_K[0]}"
                   f" bf16", rows)
        if ck in WIDTH_FP32:  # bf16 values: the same plain selection
            width_case(torch, "memory_topk", qk.float(), mk.float(), valid,
                       TOP_K, ref, f"memory_topk CK={ck} fill{WIDTH_FILL} "
                       f"top_k={TOP_K} fp32", rows)
        if ck in WIDTH_FULL:
            mk, valid = make_bank(torch, gen, qk, max(FILLS), clustered=True)
            width_case(torch, "memory_topk", qk, mk, valid, TOP_K,
                       K.topk_select_plain(qk, mk, valid, TOP_K + 1),
                       f"memory_topk CK={ck} fill{max(FILLS)} top_k={TOP_K}"
                       f" bf16", rows)
        del mk
    wide = torch.zeros((64, MAX_KEY_WIDTH + 44), device=dev)
    for name, (fn, counted) in width_selectors().items():
        launches = counted.launches
        try:
            fn(wide, wide, 64, 8)
        except ValueError as e:
            if str(MAX_KEY_WIDTH) not in str(e):
                fail(f"[widths] {name} at CK={wide.shape[1]}: {e}")
        else:
            fail(f"[widths] {name} took keys {wide.shape[1]} wide")
        if counted.launches != launches:
            fail(f"[widths] {name} launched at CK={wide.shape[1]}")
    print(f"[widths] every selection at CK={wide.shape[1]} raised naming "
          f"the cap {MAX_KEY_WIDTH}", flush=True)
    return rows


def width_engine(torch, card, keydim, images, masks):
    """Phase 6's engine and video with a ``keydim``-wide key projection
    (resnet50 / resnet18, bf16, weights from torch.manual_seed(0)): one
    frame-0 interact on the default read (#1 + #2, the keys padded where
    keydim is not a built width) against the plain read within PROB_ATOL /
    PROB_FRAC, #1's launches and pads, WIDTH_ITERS untraced interacts."""
    from eva_vos_tpu_torch import kernels as K
    from eva_vos_tpu_torch.engine import (EngineConfig, InferenceEngine,
                                          pad_mask, prepare_video)
    from eva_vos_tpu_torch.kernels.memory_topk import KEY_WIDTHS
    from eva_vos_tpu_torch.models import FusionNet, PropagationNetwork

    dtype = torch.bfloat16
    torch.manual_seed(0)
    stcn = PropagationNetwork(keydim=keydim, key_arch=ENGINE["key_arch"],
                              value_arch="resnet18").to(dtype)
    fusion = FusionNet().to(dtype)
    cfg = EngineConfig(mem_freq=5, top_k=TOP_K, max_interactions=60,
                       feature_chunk=2)
    fused = InferenceEngine(stcn, fusion, cfg, device=DEVICE)
    plain = InferenceEngine(stcn, fusion,
                            cfg._replace(readout_strategy="gather"),
                            device=DEVICE)
    if fused.config.readout_strategy != "fused":
        fail(f"[widths] engine resolved {fused.config.readout_strategy!r}")
    padded, pad = prepare_video(images, dtype=dtype, device=DEVICE)
    feats = fused.precompute_features(padded)
    if feats.k16.shape[-1] != keydim:
        fail(f"[widths] keys {feats.k16.shape[-1]} wide, not {keydim}")
    state0 = fused.init_state(feats, 1)
    m0 = pad_mask(masks[:1, 0], pad, device=DEVICE)
    counters = launch_counters()
    for c in counters.values():
        c.launches = 0
    K.topk_select.pads = 0
    out = fused.interact(state0, feats, m0, 0)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items() if c.launches}
    pads = K.topk_select.pads
    if set(launches) != {"memory_topk", "memory_readout"}:
        fail(f"[widths] keydim {keydim}: the default read launched "
             f"{launches}")
    if pads != (launches["memory_topk"] if keydim not in KEY_WIDTHS
                else 0):
        fail(f"[widths] keydim {keydim}: {pads} pads for "
             f"{launches['memory_topk']} launches")
    want = plain.interact(state0, feats, m0, 0)
    if not torch.isfinite(out.prob).all():
        fail(f"[widths] keydim {keydim}: non-finite probabilities")
    frac, dmax = prob_off(torch, out.prob, want.prob)
    if frac > PROB_FRAC:
        fail(f"[widths] keydim {keydim}: fused vs gather {frac:.2e} of "
             f"probabilities off by > {PROB_ATOL}")
    walls = []
    for _ in range(WIDTH_ITERS):
        torch.cuda.synchronize()
        start = time.perf_counter()
        fused.interact(state0, feats, m0, 0)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - start))
    print(f"[widths] engine keydim {keydim}: frame-0 interact fused vs "
          f"gather max|dp|={dmax:.3g} share > {PROB_ATOL}: {frac:.2e}; "
          f"launches {launches}, #1 pads {pads}; untraced interact median "
          f"{statistics.median(walls):.1f} ms (min {min(walls):.1f}, max "
          f"{max(walls):.1f}); on {card}", flush=True)
    return dict(keydim=keydim, share_off=frac, max_abs_dp=dmax,
                launches=launches, pads=pads, ms=sorted(walls))


def width_entry_sharded(torch):
    """entry() with keys WIDTH_ENTRY wide, fused against its 'gather' step
    (#1 and #2 once each); a one-process sharded read at that width on a
    clustered bank against the fused read (#1 as its local selection)."""
    from eva_vos_tpu_torch import kernels as K
    from eva_vos_tpu_torch.entry import entry
    from eva_vos_tpu_torch.parallel import make_mesh, sharded_memory_readout

    steps = {read: entry(strategy=read, keydim=WIDTH_ENTRY)
             for read in ("fused", "gather")}
    counters = launch_counters()
    probs = {}
    for read, (step, args) in steps.items():
        for c in counters.values():
            c.launches = 0
        probs[read] = step(*args)
        torch.cuda.synchronize()
        counts = {k: c.launches for k, c in counters.items() if c.launches}
        want = {"memory_topk": 1, "memory_readout": 1} if read == "fused" \
            else {}
        if counts != want:
            fail(f"[widths] entry(keydim={WIDTH_ENTRY}) {read} step "
                 f"launched {counts}")
    got = probs["fused"]
    if got.shape != (2, 480, 864) or not torch.isfinite(got).all():
        fail(f"[widths] entry(keydim={WIDTH_ENTRY}): {tuple(got.shape)}")
    frac, dmax = prob_off(torch, got, probs["gather"])
    if frac > PROB_FRAC:
        fail(f"[widths] entry(keydim={WIDTH_ENTRY}): {frac:.2e} of "
             f"probabilities off the plain step's by > {PROB_ATOL}")
    print(f"[widths] entry(keydim={WIDTH_ENTRY}) fused vs gather step: "
          f"max|dp|={dmax:.3g} share > {PROB_ATOL}: {frac:.2e}", flush=True)

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(4)
    qk = torch.randn((N_QUERIES, WIDTH_ENTRY), generator=gen, device=dev).to(
        torch.bfloat16)
    mk, valid = make_bank(torch, gen, qk, WIDTH_FILL, clustered=True)
    mv = torch.randn((1, mk.shape[0], CV), generator=gen, device=dev).to(
        torch.bfloat16)
    mesh = make_mesh(device=DEVICE)
    K.topk_select.launches = 0
    out = sharded_memory_readout(mk, qk, mv, TOP_K, mesh, valid)
    torch.cuda.synchronize()
    if K.topk_select.launches != 1:
        fail(f"[widths] the sharded read launched #1 "
             f"{K.topk_select.launches} times")
    ref = K.fused_readout(mk, qk, mv, TOP_K, valid)
    torch.testing.assert_close(out.float(), ref.float(), rtol=READOUT_RTOL,
                               atol=READOUT_ATOL)
    sharded_err = (out.float() - ref.float()).abs().max().item()
    print(f"[widths] one-process sharded read at CK={WIDTH_ENTRY} against "
          f"the fused read: max|d|={sharded_err:.3g}", flush=True)
    return dict(entry=dict(ck=WIDTH_ENTRY, share_off=frac, max_abs_dp=dmax),
                sharded=dict(ck=WIDTH_ENTRY, max_abs_err=sharded_err))


def width_phase(torch, results, card, images, masks):
    """Phase 6d: keys of other widths than 64 (kernels, engines, entry
    point, sharded read)."""
    phase_start = time.perf_counter()
    out = dict(cases=width_kernels(torch))
    out["engines"] = [width_engine(torch, card, keydim, images, masks)
                      for keydim in WIDTH_KEYDIMS]
    out.update(width_entry_sharded(torch))
    out["phase_s"] = time.perf_counter() - phase_start
    print(f"[widths] the phase took {out['phase_s']:.1f} s on {card}",
          flush=True)
    results["widths"] = out


def resize_phase(torch, results):
    """``resize_bilinear`` on a bf16 frame batch that shrinks: it must take
    the antialiased filter (in fp32, cast back to bf16) and differ from the
    plain bilinear kernel; also whether torch's own antialiased kernel
    takes bf16 on this card."""
    import torch.nn.functional as F

    from eva_vos_tpu_torch.ops.resize import resize_bilinear

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    x = torch.rand((2, ENGINE["h"], ENGINE["w"], 3), generator=gen,
                   device=DEVICE).bfloat16()
    out = (ENGINE["h"] * 8 // 15, ENGINE["w"] * 8 // 15)    # 256 x 455
    got = resize_bilinear(x, out)
    want = resize_bilinear(x.float(), out).bfloat16()
    nchw = x.permute(0, 3, 1, 2)
    plain = F.interpolate(nchw, size=out, mode="bilinear",
                          align_corners=False).permute(0, 2, 3, 1)
    try:
        direct = F.interpolate(nchw, size=out, mode="bilinear",
                               align_corners=False, antialias=True)
        same = torch.equal(direct.permute(0, 2, 3, 1), got)
        native = f"accepted, {'equal' if same else 'not equal'} to ours"
    except (RuntimeError, NotImplementedError) as e:
        native = f"refused: {str(e).splitlines()[0]}"
    off_plain = (got.float() - plain.float()).abs().max().item()
    print(f"[resize] bf16 {tuple(x.shape)} -> {out}: dtype {got.dtype}, "
          f"equal to the fp32 antialiased resize cast to bf16: "
          f"{torch.equal(got, want)}; max |d| against the plain kernel "
          f"{off_plain:.3g}; torch's antialiased kernel in bf16: {native}",
          flush=True)
    if got.dtype != torch.bfloat16 or not torch.equal(got, want):
        fail("resize_bilinear: a bf16 shrink did not take the antialiased "
             "filter")
    if off_plain == 0.0:
        fail("resize_bilinear: a bf16 shrink gave the plain kernel's output")
    results["resize"] = dict(bf16_antialiased=True, max_abs_vs_plain=off_plain,
                             native_bf16_antialias=native)


def annotation_cost_ok(cost, action) -> bool:
    """Whether a round's annotation time is one the cost model gives for
    its action: a mask (or an empty object), clicks plus their overhead, a
    box with or without refinement clicks."""
    from eva_vos_tpu_torch.utils import ANNOTATION_COSTS as C

    if cost == C["no_object"]:
        return True
    if action == "mask":
        return cost == C["mask"]
    if action == "bbox":
        if cost == C["bbox"]:
            return True
        cost -= C["bbox"]
    n = (cost - C["click_overhead"]) / C["click"]
    return n >= 1 and n == int(n)


def policy_phase(torch, results, card, engine, images, masks):
    """The policy loops of ``eva_vos_tpu_torch.interactions`` on the engine
    phase's full-width engine (the default read) and video, the annotator
    ``Annotator(FakeSAMController())``: each loop's rounds timed, its spans,
    its kernels' launches, its contract, and its device metrics against the
    host loop; then oracle_mask's rounds under the default and the plain
    read."""
    import os

    import numpy as np

    from eva_vos_tpu_torch import interactions as I
    from eva_vos_tpu_torch.annotator import Annotator, FakeSAMController
    from eva_vos_tpu_torch.engine import InferenceEngine
    from eva_vos_tpu_torch.interactions import eval as E
    from eva_vos_tpu_torch.interactions import mask as MASK
    from eva_vos_tpu_torch.interactions import multiple as MULTI

    phase_start = time.perf_counter()
    counters = {k: c for k, c in launch_counters().items()
                if k in ("memory_topk", "memory_readout")}
    t = images.shape[0]
    sample = I.VideoSample(name="synthetic_seed0", images01=images, gt=masks)
    start = time.perf_counter()
    I.initialize(engine, sample)            # the features, cached for the loops
    torch.cuda.synchronize()
    init_s = time.perf_counter() - start
    print(f"[policy] initialize (feature precompute) {init_s:.2f} s for "
          f"T = {t}, {images.shape[1]}x{images.shape[2]}, on {card}",
          flush=True)

    def run(name, rounds, kwargs, eng=engine):
        """One loop: per round its wall seconds (from the loop's start or
        the previous round's evaluation to this round's), metrics and the
        masked frames' scores; the counters zeroed just before it."""
        log, stamps = [], [time.perf_counter()]

        def recorded(module):
            orig = module.eval_session_metric

            def rec(session, metric="j"):
                out = orig(session, metric)
                stamps.append(time.perf_counter())
                full = np.flatnonzero(session.frame_interaction_type == 1)
                bad = [int(f) for f in full
                       if out[3][f] not in (1.0, E.EMPTY_GT_TOKEN)]
                if bad:
                    fail(f"{name}: frames {bad} carry a full mask but score "
                         f"{[out[3][f] for f in bad]}")
                log.append(list(out[3]))
                return out
            return orig, rec

        module = MASK if hasattr(MASK, name) else MULTI
        orig, rec = recorded(module)
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        stamps[0] = time.perf_counter()
        module.eval_session_metric = rec
        try:
            if module is MASK:
                out = getattr(I, name)(rounds=rounds, engine=eng,
                                       sample=sample, **kwargs)
            else:
                out = getattr(I, name)(rounds, eng, sample,
                                       Annotator(FakeSAMController()),
                                       **kwargs)
        finally:
            module.eval_session_metric = orig
        torch.cuda.synchronize()
        launches = {k: c.launches for k, c in counters.items()}
        round_s = [b - a for a, b in zip(stamps, stamps[1:])]
        return out, E.LAST_SESSION, log, round_s, launches

    loops = {}
    for name, rounds, kwargs in POLICY_LOOPS:
        out, session, log, round_s, launches = run(name, rounds, kwargs)
        n, tt = len(log), sample.num_frames
        spans = session.timers.summary()
        report = session.timers.report()
        frames = session.frames_list
        actions = (["mask"] * n if name in ("oracle_mask", "upper_bound_mask")
                   else list(out[2]))
        times = session.annotation_times[:n]
        print(f"[policy {name}] T = {tt}, {n} rounds: seconds a round "
              f"{[round(x, 3) for x in round_s]}; mean quality "
              f"{[round(x, 4) for x in session.mu_metrics]}; frames "
              f"{frames}; actions {actions}; times {times}; launches "
              f"{launches}; on {card}", flush=True)
        for line in report.splitlines():
            print(f"[policy {name}] {line}", flush=True)
        if n != rounds:
            fail(f"{name}: {n} rounds evaluated, not {rounds}")
        if min(launches.values()) < n:
            fail(f"{name}: the default read's kernels launched {launches} "
                 f"times in {n} rounds")
        if not all(0 <= f < tt for f in frames):
            fail(f"{name}: a chosen frame out of range: {frames}")
        if not all(annotation_cost_ok(c, a) for c, a in zip(times, actions)):
            fail(f"{name}: annotation times {times} for actions {actions}")
        if name == "rand_rand":
            for r in range(1, min(n + 1, len(frames))):
                masked = {frames[j] for j in range(r) if actions[j] == "mask"}
                if frames[r] in masked:
                    fail(f"rand_rand: round {r} chose frame {frames[r]}, "
                         f"which has a full mask")
        # the device metrics against the host loop, bit for bit
        metric = kwargs.get("eval_metric", "j")
        _, dev_masks, _, dev_q = I.eval_session_metric(session, metric)
        os.environ["EVAVOS_HOST_METRICS"] = "1"
        host_start = time.perf_counter()
        try:
            _, host_masks, _, host_q = I.eval_session_metric(session, metric)
        finally:
            del os.environ["EVAVOS_HOST_METRICS"]
        host_s = time.perf_counter() - host_start
        same_masks = np.array_equal(dev_masks.cpu().numpy(), host_masks)
        print(f"[policy {name}] device metrics ({metric}) against the host "
              f"loop ({host_s:.2f} s): qualities equal {dev_q == host_q}, "
              f"masks equal {same_masks}", flush=True)
        if dev_q != host_q or not same_masks:
            fail(f"{name}: the device metrics differ from the host loop")
        loops[name] = dict(t=tt, rounds=n, round_s=round_s, spans=spans,
                           mu=session.mu_metrics, frames=frames,
                           actions=actions, times=times, launches=launches,
                           qualities=log, host_metrics_s=host_s)

    # read parity: oracle_mask's rounds under the default and the plain read
    plain = InferenceEngine(engine.stcn, engine.fusion,
                            engine.config._replace(readout_strategy="gather"),
                            device=DEVICE)
    per_read = {}
    for read, eng in (("fused", engine), ("gather", plain)):
        _, session, log, round_s, launches = run(
            "oracle_mask", PARITY_ROUNDS, dict(eval_metric="j"), eng=eng)
        per_read[read] = dict(frames=session.frames_list, qualities=log,
                              mu=session.mu_metrics, round_s=round_s,
                              launches=launches)
    if per_read["gather"]["launches"] != dict.fromkeys(counters, 0):
        fail(f"the plain read launched kernels: "
             f"{per_read['gather']['launches']}")
    fa, fb = per_read["fused"]["frames"], per_read["gather"]["frames"]
    parity = []
    for r in range(PARITY_ROUNDS):      # round r + 1 annotated frame fa[r]
        qa = np.asarray(per_read["fused"]["qualities"][r])
        qb = np.asarray(per_read["gather"]["qualities"][r])
        mua, mub = per_read["fused"]["mu"][r], per_read["gather"]["mu"][r]
        dj = float(np.abs(qa - qb).max())
        print(f"[policy parity] round {r + 1}: frame {fa[r]}, mean J fused "
              f"{mua:.5f} gather {mub:.5f}; largest per-frame |dJ| "
              f"{dj:.3g}", flush=True)
        if dj > PARITY_DJ_ATOL:
            fail(f"read parity: round {r + 1} a frame's J differs by "
                 f"{dj:.3g}")
        if abs(mua - mub) > PARITY_J_ATOL:
            fail(f"read parity: round {r + 1} mean J differs by "
                 f"{abs(mua - mub):.3g}")
        parity.append(dict(round=r + 1, frame=fa[r], d_mean_j=abs(mua - mub),
                           max_abs_dj=dj))
        if fa[r + 1] != fb[r + 1]:
            f0, f1 = fa[r + 1], fb[r + 1]
            print(f"[policy parity] round {r + 1}: the reads choose frames "
                  f"{f0} (fused) and {f1} (gather) next; J at them: fused "
                  f"{qa[f0]:.5f} / {qa[f1]:.5f}, gather {qb[f0]:.5f} / "
                  f"{qb[f1]:.5f}; the comparison ends", flush=True)
            parity[-1]["diverged"] = [f0, f1]
            break
    phase_s = time.perf_counter() - phase_start
    print(f"[policy] the phase took {phase_s:.1f} s", flush=True)
    results["policy"] = dict(init_s=init_s, t=t, loops=loops, parity=parity, parity_reads=per_read,
                             phase_s=phase_s)


def rel_err(a, b) -> float:
    """max |a - b| / max |b|, both on the host."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def grads_rel_err(net_a, net_b) -> float:
    """The largest rel_err over the two networks' parameter gradients."""
    return max(rel_err(pa.grad, pb.grad) for pa, pb in
               zip(net_a.parameters(), net_b.parameters()))


def decision_sam_phase(torch, results, card, engine, images, masks):
    """The decision models and SAM (``eva_vos_tpu_torch.models``) at full
    width on the policy phase's engine and video: eva_vos (QNet frame
    choice, the ActorCritic's type choice, SAM's annotations through the
    fused branches), qnet_mask and l2_mask for DECISION_ROUNDS rounds each,
    with their spans and #1 / #2 launches; the models' and SAM's times; and
    the card checks: the fused select against predict + best_sam_mask, the
    device warm start against the host loop, the device click robot
    against scipy on every pair it met, and the models (SAM's mask decoder
    on a real embedding) against their CPU copies."""
    import copy

    import numpy as np

    from eva_vos_tpu_torch import interactions as I
    from eva_vos_tpu_torch.annotator import Annotator
    from eva_vos_tpu_torch.annotator import annotator as A
    from eva_vos_tpu_torch.annotator.robots import ClickRobot
    from eva_vos_tpu_torch.interactions import eval as E
    from eva_vos_tpu_torch.interactions import mask as MASK
    from eva_vos_tpu_torch.interactions import multiple as MULTI
    from eva_vos_tpu_torch.interactions.policies import (frames_to_224,
                                                         masks_to_224_3ch)
    from eva_vos_tpu_torch.models import (ActorCritic, QualityNet,
                                          make_generator, seeded_init_)
    from eva_vos_tpu_torch.models.feature_extractors import (
        build_feature_extractor, eval_transform)
    from eva_vos_tpu_torch.models.sam import (PRESETS, SAMController,
                                              SamPredictor, build_sam)
    from eva_vos_tpu_torch.models.sam import predictor as P
    from eva_vos_tpu_torch.ops.metrics import compute_iou
    from eva_vos_tpu_torch.train.ppo import PPOAgent

    phase_start = time.perf_counter()
    dev = torch.device(DEVICE)
    start = time.perf_counter()
    qnet = seeded_init_(QualityNet(arch="resnet18", merge_strategy="cat"),
                        make_generator(2, "cpu")).to(dev).eval()
    net = seeded_init_(ActorCritic(out_dim=2, arch="resnet18", dropout=0.0,
                                   embed_dim=PRESETS[SAM_PRESET]
                                   .prompt_embed_dim),
                       make_generator(3, "cpu"))
    agent = PPOAgent(2, "resnet18", net.state_dict(), seed=0, device=DEVICE)
    sam = build_sam(SAM_PRESET, seed=0, device=DEVICE)
    predictor = SamPredictor(sam, max_points=64)
    extract = build_feature_extractor(EXTRACTOR, allow_random=True,
                                      device=DEVICE, seed=4)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - start
    n_sam = sum(p.numel() for p in sam.parameters())
    print(f"[decision] built QNet resnet18, ActorCritic resnet18, SAM "
          f"{SAM_PRESET} ({n_sam / 1e6:.1f} M parameters, seeded on the "
          f"card) and the {EXTRACTOR} extractor in {build_s:.2f} s",
          flush=True)

    # every click of the device robot, for the scipy check
    robot_pairs = []
    robot = P.click_robot_interact

    def recorded_robot(pred, gt):
        out = robot(pred, gt)
        robot_pairs.append((pred.clone(), gt, torch.stack(out).tolist()))
        return out

    P.click_robot_interact = recorded_robot

    counters = {k: c for k, c in launch_counters().items()
                if k in ("memory_topk", "memory_readout")}
    sample = I.VideoSample(name="synthetic_seed0", images01=images, gt=masks)
    loops, actions_seen = {}, []
    act = agent.act_fn()

    def agent_act(emb, mask224):
        action, value = act(emb, mask224)
        actions_seen.append(int(action))
        return action, value

    runs = (
        ("eva_vos", MULTI, lambda: I.eva_vos(
            qnet.extract_features, agent_act, DECISION_ROUNDS, engine, sample,
            Annotator(SAMController(predictor)), eval_metric="j")),
        ("qnet_mask", MASK, lambda: I.qnet_mask(
            qnet.extract_features, DECISION_ROUNDS, engine, sample, "j")),
        ("l2_mask", MASK, lambda: I.l2_mask(
            extract, DECISION_ROUNDS, engine, sample, "j")))
    try:
        for name, module, call in runs:
            stamps = [0.0]
            orig = module.eval_session_metric

            def rec(session, metric="j", orig=orig, stamps=stamps):
                out = orig(session, metric)
                stamps.append(time.perf_counter())
                return out

            for c in counters.values():
                c.launches = 0
            torch.cuda.synchronize()
            stamps[0] = time.perf_counter()
            module.eval_session_metric = rec
            try:
                out = call()
            finally:
                module.eval_session_metric = orig
            torch.cuda.synchronize()
            session = E.LAST_SESSION
            launches = {k: c.launches for k, c in counters.items()}
            round_s = [b - a for a, b in zip(stamps, stamps[1:])]
            n = len(round_s)
            spans = session.timers.summary()
            chosen = list(out[3]) if name == "eva_vos" else ["mask"] * n
            print(f"[decision {name}] T = {sample.num_frames}, {n} rounds: "
                  f"seconds a round {[round(x, 3) for x in round_s]}; mean J "
                  f"{[round(x, 4) for x in session.mu_metrics]}; frames "
                  f"{session.frames_list}; actions {chosen}; launches "
                  f"{launches}; on {card}", flush=True)
            for line in session.timers.report().splitlines():
                print(f"[decision {name}] {line}", flush=True)
            if n != DECISION_ROUNDS:
                fail(f"{name}: {n} rounds evaluated, not {DECISION_ROUNDS}")
            if min(launches.values()) < n:
                fail(f"{name}: #1 / #2 launched {launches} times in {n} "
                     f"rounds")
            if not all(0 <= f < sample.num_frames
                       for f in session.frames_list):
                fail(f"{name}: a chosen frame out of range")
            if not all(np.isfinite(session.mu_metrics)):
                fail(f"{name}: a non-finite mean J")
            loops[name] = dict(rounds=n, round_s=round_s, spans=spans,
                               mu=session.mu_metrics,
                               frames=session.frames_list, actions=chosen,
                               times=session.annotation_times[:n],
                               launches=launches)
        print(f"[decision] the agent's actions (0 = 3clicks, 1 = mask): "
              f"{actions_seen}", flush=True)
        eva_session_frames = loops["eva_vos"]["frames"]
        # the last session's (l2_mask's) masks: the warm starts' targets
        _, gen, _, _ = I.eval_session_metric(E.LAST_SESSION, "j")
        gen = gen.bool()

        # times: SAM, the decision models, the extractor
        ctrl = SAMController(predictor)
        frame_u8 = (np.clip(images[SELECT_FRAMES[0]], 0, 1) * 255).astype(
            np.uint8)

        def set_image():
            ctrl.reset_image()
            ctrl.set_image(frame_u8)

        set_image_ms = cuda_ms(torch, set_image, 5)

        def host_ms(fn, reps=5):
            fn()
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(times)

        gt0 = masks[0, SELECT_FRAMES[0]].astype(bool)
        click, label = ClickRobot().middle_click(gt0)
        predict_ms = host_ms(lambda: predictor.predict(
            point_coords=click, point_labels=label))
        select_ms = host_ms(lambda: predictor.predict_select(
            gt0, point_coords=click, point_labels=label))
        pred0 = gen[SELECT_FRAMES[0]]
        t0 = time.perf_counter()
        ok, _, _, ws_clicks, _ = predictor.warmstart_select(pred0)
        torch.cuda.synchronize()
        warm_ms = (time.perf_counter() - t0) * 1e3
        warm_decodes = len(ws_clicks) if ok else 21
        frames224 = frames_to_224(images, device=DEVICE)
        masks224 = masks_to_224_3ch(gen.float(), device=DEVICE)
        qnet_ms = cuda_ms(torch, lambda: qnet.extract_features(
            frames224, masks224), 5)
        emb = predictor.features.float()[None]
        act_ms = host_ms(lambda: agent.act(emb, masks224[:1]))
        extract_ms = host_ms(lambda: extract(images), reps=3)
        print(f"[decision] SAM {SAM_PRESET} set_image {set_image_ms:.2f} ms "
              f"(median of 5, a {images.shape[1]}x{images.shape[2]} frame); "
              f"predict {predict_ms:.2f} ms; predict_select {select_ms:.2f} "
              f"ms; warmstart_select {warm_ms:.1f} ms for {warm_decodes} "
              f"decodes ({'stopped' if ok else 'gave up'}); QNet "
              f"extract_features {qnet_ms:.2f} ms for {len(images)} frames; "
              f"ActorCritic act {act_ms:.2f} ms; {EXTRACTOR} extractor "
              f"{extract_ms:.1f} ms for {len(images)} frames (from host "
              f"float frames); on {card}", flush=True)

        # the fused select against predict + best_sam_mask, exactly; the
        # convolutions take deterministic algorithms for the checks, so that
        # two decodes of one prompt give the same logits
        torch.backends.cudnn.deterministic = True
        select_cases = []
        for f in SELECT_FRAMES:
            ctrl.reset_image()
            ctrl.set_image((np.clip(images[f], 0, 1) * 255).astype(np.uint8))
            gt = masks[0, f].astype(bool)
            mx, my = ClickRobot().middle_click(gt)[0][0]
            ys, xs = np.nonzero(gt)
            box = np.array([xs.min(), ys.min(), xs.max(), ys.max()], float)
            far = np.array([[gt.shape[1] - 1 - mx, gt.shape[0] - 1 - my]])
            prompts = [
                dict(point_coords=np.array([[mx, my]]),
                     point_labels=np.array([1])),
                dict(point_coords=np.array([[mx, my], *far]),
                     point_labels=np.array([1, 0])),
                dict(box=box),
                dict(box=box, point_coords=np.array([[mx, my]]),
                     point_labels=np.array([1]))]
            _, _, low = predictor.predict(**prompts[0])
            prompts.append(dict(prompts[0], mask_input=low[:1]))
            for kw in prompts:
                m, _, lg = predictor.predict(**kw)
                idx, best = -1, 0.0
                for i, g in enumerate(m):
                    iou = compute_iou(g[None], gt[None])
                    if iou > best:
                        idx, best = i, iou
                fm, fiou, fidx, flow = predictor.predict_select(gt, **kw)
                same = (fidx == idx and fiou == best
                        and np.array_equal(fm, m[idx])
                        and np.array_equal(flow.cpu().numpy(), lg[idx]))
                select_cases.append(dict(frame=f, prompt=sorted(kw), idx=idx,
                                         iou=best, equal=bool(same)))
                if not same:
                    fail(f"predict_select differs from predict + "
                         f"best_sam_mask on frame {f}, prompt {sorted(kw)}: "
                         f"index {fidx} / {idx}, IoU {fiou} / {best}")
        print(f"[decision] predict_select = predict + best_sam_mask exactly "
              f"on {len(select_cases)} prompts (points, two clicks, box, "
              f"box + click, mask_input) on frames {SELECT_FRAMES}; indices "
              f"{[c['idx'] for c in select_cases]}", flush=True)

        # the device warm start against the host loop
        warm_frames = list(dict.fromkeys(
            [f for f in eva_session_frames if gen[f].any()]
            + [f for f in range(sample.num_frames) if gen[f].any()]))
        warm_cases = []
        annotators = (Annotator(ctrl, device_warmstart=True), Annotator(ctrl))
        warm_frames = warm_frames[:WARM_FRAMES]
        # the propagated masks at the annotator's threshold (random SAM
        # weights give up there), and each frame's background, which SAM's
        # near-full random masks match well, at lower thresholds, so that
        # chains stop too
        default_threshold = A.SIMILAR_IOU_THRESHOLD
        runs = ([(f, "mask", default_threshold) for f in warm_frames]
                + [(f, "background", t) for f in warm_frames
                   for t in WARM_BACKGROUND_THRESHOLDS])
        for f, target, threshold in runs:
            ctrl.reset_image()
            ctrl.set_image((np.clip(images[f], 0, 1) * 255).astype(np.uint8))
            pred = (gen[f].cpu().numpy() if target == "mask"
                    else masks[0, f] == 0)
            eps = []
            for annotator in annotators:
                A.SIMILAR_IOU_THRESHOLD = threshold
                t0 = time.perf_counter()
                try:
                    eps.append(annotator.create_similar_samlogits(pred))
                finally:
                    A.SIMILAR_IOU_THRESHOLD = default_threshold
                torch.cuda.synchronize()
                eps[-1] = (*eps[-1], time.perf_counter() - t0)
            (fl, fm, fc, flab, fs), (hl, hm, hc, hlab, hs) = eps
            same = (fl is None) == (hl is None)
            if same and fl is not None:
                same = (np.array_equal(fc, np.asarray(hc, np.float64))
                        and np.array_equal(flab, np.asarray(hlab, np.int64))
                        and np.array_equal(np.asarray(fm).squeeze(),
                                           np.asarray(hm).squeeze())
                        and torch.equal(torch.as_tensor(fl).cpu(),
                                        torch.as_tensor(hl).cpu()))
            tries = 21 if fc is None else len(fc)
            warm_cases.append(dict(frame=f, target=target,
                                   threshold=threshold, ok=fl is not None,
                                   decodes=tries, device_s=fs, host_s=hs,
                                   equal=bool(same)))
            if not same:
                fail(f"warmstart_select differs from the host loop on frame "
                     f"{f} ({target}, threshold {threshold})")
        stopped = [c for c in warm_cases if c["ok"]]
        stop_frames = sorted({c["frame"] for c in stopped})
        print(f"[decision] warmstart_select = the host loop on (frame, "
              f"target, threshold) "
              f"{[(c['frame'], c['target'], c['threshold']) for c in warm_cases]}"
              f": {[(c['ok'], c['decodes']) for c in warm_cases]} (stopped, "
              f"decodes); {len(stopped)} of {len(warm_cases)} chains "
              f"stopped, on frames {stop_frames}; device / host seconds "
              f"{[(round(c['device_s'], 3), round(c['host_s'], 3)) for c in warm_cases]}",
              flush=True)
        if len(warm_frames) < WARM_FRAMES:
            fail(f"the warm-start check met {len(warm_frames)} frames")
        if len(stop_frames) < WARM_FRAMES:
            fail(f"warm-start chains stopped on {len(stop_frames)} frames, "
                 f"fewer than {WARM_FRAMES}: too few full episodes compared")
    finally:
        P.click_robot_interact = robot
        torch.backends.cudnn.deterministic = False

    # the device click robot against scipy on every pair it met
    scipy_robot = ClickRobot()
    for pred, gt, got in robot_pairs:
        clicks, labels = scipy_robot.interact(pred.cpu().numpy(),
                                              gt.cpu().numpy())
        if got != [*map(int, clicks[0]), int(labels[0])]:
            fail(f"device click robot {got} != scipy {clicks[0]} "
                 f"{labels[0]}")
    print(f"[decision] the device click robot = scipy on all "
          f"{len(robot_pairs)} (pred, gt) pairs it met", flush=True)
    if not robot_pairs:
        fail("the device click robot met no pair")

    # the card against the CPU, same weights, TF32 off
    errs = {}
    x224, m224 = frames224[:2], masks224[:2]
    qcpu = copy.deepcopy(qnet).cpu()
    acpu = copy.deepcopy(agent.net).cpu()
    ecpu = copy.deepcopy(extract.net).cpu()
    xt = eval_transform(images[:2], device=DEVICE).permute(0, 3, 1, 2)
    with torch.no_grad():
        errs["qnet_logits"] = rel_err(qnet(x224, m224),
                                  qcpu(x224.cpu(), m224.cpu()))
        errs["qnet_features"] = rel_err(qnet.features(x224, m224),
                                    qcpu.features(x224.cpu(), m224.cpu()))
        p_dev, v_dev = agent.net(emb, m224[:1])
        p_cpu, v_cpu = acpu(emb.cpu(), m224[:1].cpu())
        errs["actor_critic_logits"] = rel_err(p_dev, p_cpu)
        errs["actor_critic_value"] = rel_err(v_dev, v_cpu)
        errs[f"{EXTRACTOR}_layer4"] = rel_err(extract.net(xt)[-1],
                                          ecpu(xt.cpu())[-1])
    pe_cpu = copy.deepcopy(sam.prompt_encoder).cpu()
    md_cpu = copy.deepcopy(sam.mask_decoder).cpu()
    coords, labels = predictor._build_prompts(
        np.array([[100.0, 120.0], [400.0, 300.0]]), np.array([1, 0]), None)
    coords_t = torch.as_tensor(coords, device=dev)
    labels_t = torch.as_tensor(labels, device=dev)
    _, _, low = predictor.predict(point_coords=np.array([[100, 120]]),
                                  point_labels=np.array([1]))
    mask_in = torch.as_tensor(low[0], device=dev)
    with torch.no_grad():
        for has_mask in (False, True):
            masks_dev, iou_dev = sam.decode(predictor.features, coords_t,
                                            labels_t, mask_in, has_mask)
            sp, va, de, ipe = pe_cpu(coords_t.cpu(), labels_t.cpu(),
                                     mask_in.cpu(), has_mask)
            masks_cpu, iou_cpu = md_cpu(predictor.features.cpu(), ipe, sp, va,
                                        de)
            tag = "mask_input" if has_mask else "points"
            errs[f"sam_decoder_logits_{tag}"] = rel_err(masks_dev, masks_cpu)
            errs[f"sam_decoder_iou_{tag}"] = rel_err(iou_dev, iou_cpu)
    print(f"[decision] card vs CPU, same weights, TF32 off (max |d| / max "
          f"|value|): { {k: f'{v:.3g}' for k, v in errs.items()} }",
          flush=True)
    bad = {k: v for k, v in errs.items() if not v <= CPU_RTOL}
    if bad:
        fail(f"the card differs from the CPU by more than {CPU_RTOL}: {bad}")

    phase_s = time.perf_counter() - phase_start
    print(f"[decision] the phase took {phase_s:.1f} s", flush=True)
    results["decision_sam"] = dict(
        sam_preset=SAM_PRESET, extractor=EXTRACTOR, build_s=build_s,
        sam_parameters=n_sam, loops=loops, agent_actions=actions_seen,
        set_image_ms=set_image_ms, predict_ms=predict_ms,
        predict_select_ms=select_ms, warmstart_ms=warm_ms,
        warmstart_decodes=warm_decodes, warmstart_stopped=bool(ok),
        qnet_extract_ms=qnet_ms, act_ms=act_ms, extractor_ms=extract_ms,
        select_cases=select_cases, warm_cases=warm_cases,
        robot_pairs=len(robot_pairs), cpu_rel_err=errs, phase_s=phase_s)
    return predictor


def training_phase(torch, results, card, images, masks, predictor):
    """Training (``eva_vos_tpu_torch.train``, ``data``, ``cli``) at full
    width on phase 6's video, in a temporary directory: the FQ generator's
    per-sample function on a fresh fp32 engine (#1 / #2 in fp32, checked
    against the plain read), train_qnet's main over its tree, the
    annotation generator's per-sample function with phase 9's ViT-H SAM,
    train_rl_agent's main over that tree, and one rollout and update of
    the CLI's 40-env fleet; the QNet step and the PPO update against CPU
    copies."""
    import os
    import tempfile

    import numpy as np

    from eva_vos_tpu_torch import interactions as I
    from eva_vos_tpu_torch.annotator import Annotator
    from eva_vos_tpu_torch.cli import generate_annotation_dataset as gen_an
    from eva_vos_tpu_torch.cli import generate_fq_dataset as gen_fq
    from eva_vos_tpu_torch.cli import train_qnet, train_rl_agent
    from eva_vos_tpu_torch.data._png import read_png, write_png
    from eva_vos_tpu_torch.data.datasets import MaskQualityDB, write_csv_rows
    from eva_vos_tpu_torch.engine import EngineConfig, InferenceEngine
    from eva_vos_tpu_torch.interactions import eval as E
    from eva_vos_tpu_torch.models import QualityNet
    from eva_vos_tpu_torch.models.sam import SAMController
    from eva_vos_tpu_torch.ops.resize import resize_nearest
    from eva_vos_tpu_torch.train import QNetTrainer
    from eva_vos_tpu_torch.utils import model_zoo
    from eva_vos_tpu_torch.utils.checkpoint import restore_checkpoint

    phase_start = time.perf_counter()
    counters = {k: c for k, c in launch_counters().items()
                if k in ("memory_topk", "memory_readout")}
    out = {}
    cwd = os.getcwd()
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name) / "data"
    os.environ["EVAVOS_DATA_ROOT"] = str(root)
    os.chdir(tmp.name)                    # MetricsLogger writes to logs/
    try:
        t = images.shape[0]
        sample = I.VideoSample(name="synthetic_0__1", images01=images,
                               gt=masks)

        # 1. the FQ generator's per-sample function on a fresh fp32 engine
        stcn = model_zoo.load_stcn(allow_random=True, device=DEVICE)
        fusion = model_zoo.load_fusion(allow_random=True, device=DEVICE)
        cfg = EngineConfig(max_interactions=FQ_ROUNDS + 2)
        engine = InferenceEngine(stcn, fusion, cfg, device=DEVICE)
        if stcn.dtype != torch.float32 or engine.config.readout_strategy \
                != "fused":
            fail(f"the generator's engine: {stcn.dtype}, "
                 f"{engine.config.readout_strategy}")
        written = {}
        save_masks = gen_fq.save_state_masks

        def recorded(out_root, state_name, gen, device="cuda"):
            written[state_name] = np.asarray(gen)
            return save_masks(out_root, state_name, gen, device)

        gen_fq.save_state_masks = recorded
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        start = time.perf_counter()
        try:
            rows = gen_fq.generate_sample(FQ_ROUNDS, engine, sample, "j",
                                          root / "FQ_DB")
        finally:
            gen_fq.save_state_masks = save_masks
        torch.cuda.synchronize()
        fq_s = time.perf_counter() - start
        fq_launches = {k: c.launches for k, c in counters.items()}
        session = E.LAST_SESSION
        print(f"[train fq] T = {t}, {FQ_ROUNDS} oracle rounds, fp32 engine: "
              f"{fq_s:.2f} s ({len(rows)} states kept); launches "
              f"{fq_launches}; on {card}", flush=True)
        if min(fq_launches.values()) < FQ_ROUNDS:
            fail(f"FQ generator: #1 / #2 launched {fq_launches} times in "
                 f"{FQ_ROUNDS} rounds")
        if not rows:
            fail("FQ generator: no state kept")
        for row in rows:
            ious = eval(row["ious"])
            pngs = sorted((root / "FQ_DB" / "Annotations" / "224"
                           / row["state_name"]).glob("*.png"))
            if len(ious) != t or len(pngs) != t:
                fail(f"FQ state {row['state_name']}: {len(pngs)} PNGs, "
                     f"{len(ious)} IoUs for T = {t}")
        write_csv_rows(root / "FQ_DB" / "res_train.csv", rows)
        write_csv_rows(root / "FQ_DB" / "res_val.csv", rows)
        # MaskQualityDB reads back exactly the masks that were written
        db = MaskQualityDB(root / "FQ_DB", root / "FQ_DB" / "res_train.csv")
        want = {s: (resize_nearest(torch.as_tensor(g, device=DEVICE),
                                   (224, 224), h_axis=1, w_axis=2) * 255
                    ).to(torch.uint8).cpu().numpy()
                for s, g in written.items()}
        for i, (state_name, _, frame) in enumerate(db.items):
            got = np.rint(db[i]["mask"] * 255).astype(np.uint8)
            if not np.array_equal(got, want[state_name][frame]):
                fail(f"MaskQualityDB: {state_name} frame {frame} differs "
                     f"from the mask written")
        print(f"[train fq] MaskQualityDB read back {len(db)} masks of "
              f"{len(rows)} states exactly", flush=True)
        # one blocked step of the fp32 engine: kernels against the plain read
        plain = InferenceEngine(stcn, fusion,
                                cfg._replace(readout_strategy="gather"),
                                device=DEVICE)
        state = session.state
        front, tis = state.certain_count + 5, list(range(31, 36))
        with torch.no_grad():
            got = engine._segment_frames(session.feats, state.bank_k,
                                         state.bank_v, front, tis)
            ref = plain._segment_frames(session.feats, state.bank_k,
                                        state.bank_v, front, tis)
        diff = (got - ref).abs()
        frac = (diff > FP32_PROB_ATOL).float().mean().item()
        print(f"[train fq] fp32 blocked step, kernels vs plain read: "
              f"max|dp| = {diff.max().item():.3g}, share > {FP32_PROB_ATOL}: "
              f"{frac:.2e}", flush=True)
        if not torch.isfinite(got).all() or frac > PROB_FRAC:
            fail(f"the fp32 blocked step: {frac:.2e} of pixels off by > "
                 f"{FP32_PROB_ATOL}")
        out["fq"] = dict(rounds=FQ_ROUNDS, seconds=fq_s, states=len(rows),
                         launches=fq_launches, db_items=len(db),
                         step_max_abs_dp=diff.max().item(),
                         step_share_off=frac)

        # 2. QNet through its CLI, then timed steps and the card/CPU checks
        start = time.perf_counter()
        qstate = train_qnet.main(["--epochs", "1", "--batch-size", "64",
                                  "--train-set", "train", "--lr", "1e-5",
                                  "--optim", "SGD", "--arch", "resnet18",
                                  "--out", "qnet_out", "--device", DEVICE])
        torch.cuda.synchronize()
        cli_s, cli_steps = time.perf_counter() - start, qstate.step
        sd = model_zoo.load_torch_state_dict("qnet_out/qnet_ckpt")
        loaded = QualityNet(arch="resnet18").to(DEVICE).eval()
        loaded.load_state_dict(sd)
        batches = db.batches(64, rng=np.random.default_rng(0))
        batch = next(batches)
        x = torch.as_tensor(batch["img"][:8], device=DEVICE)
        m3 = torch.as_tensor(batch["mask"][:8], device=DEVICE)[..., None] \
            .repeat(1, 1, 1, 3)
        qstate.net.eval()
        with torch.no_grad():
            ckpt_err = rel_err(loaded(x, m3), qstate.net(x, m3))
        if not ckpt_err <= 1e-6:
            fail(f"the QNet checkpoint's logits differ by {ckpt_err:.3g}")
        trainer = QNetTrainer(arch="resnet18", lr=1e-5, device=DEVICE)
        times, losses = [], []
        for step in range(QNET_TIMED_STEPS + 1):
            try:
                batch = next(batches)
            except StopIteration:
                batches = db.batches(64, rng=np.random.default_rng(step))
                batch = next(batches)
            torch.cuda.synchronize()
            start = time.perf_counter()
            qstate, m = trainer.train_step(qstate, batch)
            losses.append(float(m["loss"]))
            times.append(time.perf_counter() - start)
        step_ms = statistics.median(times[1:]) * 1e3
        print(f"[train qnet] train_qnet.main (1 epoch, {cli_steps} steps of "
              f"64) {cli_s:.2f} s; {QNET_TIMED_STEPS} steps of 64 "
              f"at 224: median {step_ms:.1f} ms ({64e3 / step_ms:.0f} images "
              f"a second; each image is a frame and a mask), loss "
              f"{losses[-1]:.4f}; checkpoint reloaded, logits max rel "
              f"{ckpt_err:.2g}; on {card}", flush=True)
        # the card against the CPU: one step in float64 (gradients), the
        # fp32 forward (loss), same weights and batch, dropout 0
        qerr = {}
        b4 = {k: v[:4] for k, v in batch.items()}
        sd = {k: v.detach().cpu() for k, v in qstate.net.state_dict().items()}
        for dtype in (torch.float64, torch.float32):
            sides = []
            for dev in (DEVICE, "cpu"):
                tr = QNetTrainer(arch="resnet18", lr=1e-5, dropout=0.0,
                                 device=dev)
                st = tr.init(state_dict=sd)
                st.net.to(dtype)
                st, m = tr.train_step(st, b4)
                sides.append((st.net, m["loss"]))
            tag = "f64" if dtype == torch.float64 else "fp32"
            qerr[f"loss_{tag}"] = rel_err(sides[0][1], sides[1][1])
            qerr[f"update_{tag}"] = grads_rel_err(sides[0][0], sides[1][0])
        print(f"[train qnet] card vs CPU, one step at batch 4 (max |d| / max "
              f"|value|): { {k: f'{v:.3g}' for k, v in qerr.items()} }",
              flush=True)
        bad = {k: v for k, v in qerr.items()
               if not v <= CPU_RTOL and k != "update_fp32"}
        if bad:
            fail(f"the QNet step differs from the CPU's: {bad}")
        out["qnet"] = dict(cli_s=cli_s, step_ms=step_ms,
                           images_per_s=64e3 / step_ms, losses=losses,
                           checkpoint_rel_err=ckpt_err, cpu_rel_err=qerr)

        # 3. the annotation generator's per-sample function, ViT-H SAM
        ann = root / "MOSE" / "Annotations" / "480p" / "synthetic_0"
        ann.mkdir(parents=True)
        for f in range(t):
            write_png(ann / f"{f:05d}.png", masks[0, f],
                      palette=[[0, 0, 0], [128, 0, 0]])
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        start = time.perf_counter()
        rows = gen_an.generate_sample(
            sample, engine, Annotator(SAMController(predictor)),
            ANNOT_ROUNDS, ["3clicks", "mask"], "j", root / "AnnotDB")
        torch.cuda.synchronize()
        an_s = time.perf_counter() - start
        an_launches = {k: c.launches for k, c in counters.items()}
        write_csv_rows(root / "AnnotDB" / "train.csv", rows)
        print(f"[train annot] {ANNOT_ROUNDS} rounds with ViT-H SAM: "
              f"{an_s:.2f} s, {len(rows)} states, actions "
              f"{[r['selected_annotation'] for r in rows]}; launches "
              f"{an_launches}; on {card}", flush=True)
        if len(rows) != ANNOT_ROUNDS - 1:
            fail(f"annotation generator: {len(rows)} states")
        if min(an_launches.values()) < ANNOT_ROUNDS:
            fail(f"annotation generator: #1 / #2 launched {an_launches} times "
                 f"in {ANNOT_ROUNDS} rounds")
        for row in rows:
            emb = np.load(root / "AnnotDB" / "SAM_Embeddings"
                          / f"{row['id']}.npy")
            if emb.shape != (256, 64, 64) or not np.isfinite(emb).all():
                fail(f"state {row['id']}: embedding {emb.shape}")
            if read_png(root / "AnnotDB" / "Images" / f"{row['id']}.png"
                        )[0].shape != images.shape[1:]:
                fail(f"state {row['id']}: image size")
        out["annot"] = dict(rounds=ANNOT_ROUNDS, seconds=an_s,
                            states=len(rows), launches=an_launches)

        # 4. PPO through its CLI
        start = time.perf_counter()
        train_rl_agent.main(["--sam", "vit_h", "--allow-random",
                             "--num-envs", "4", "--mini-batch", "2",
                             "--num-steps", "5", "--rollouts", "4",
                             "--ppo-epochs", "4", "--imset", "train",
                             "--out", "rl_out", "--device", DEVICE])
        torch.cuda.synchronize()
        rl_s = time.perf_counter() - start
        _, meta = restore_checkpoint("rl_out/_checkpoint")
        print(f"[train ppo] train_rl_agent.main (4 envs, 5 steps, 4 PPO "
              f"epochs): {rl_s:.2f} s; iters {meta['iters']}, max reward "
              f"{meta['max_reward']:.4g}", flush=True)
        if not Path("rl_out/model").exists() or meta["iters"] < 4:
            fail(f"train_rl_agent: checkpoints {meta}")
        out["ppo_cli"] = dict(seconds=rl_s, **meta)

        # 5. the CLI's fleet size: one rollout of 40 envs and an update
        out["fleet"] = fleet_check(torch, card, predictor, root)
    finally:
        os.chdir(cwd)
        del os.environ["EVAVOS_DATA_ROOT"]
        tmp.cleanup()
    phase_s = time.perf_counter() - phase_start
    print(f"[train] the phase took {phase_s:.1f} s", flush=True)
    results["training"] = dict(out, phase_s=phase_s)


def fleet_check(torch, card, predictor, root):
    """One ``batched_rollouts`` of the CLI's fleet (FLEET_ENVS envs over the
    annotation tree's states, cycled) and ``optimize``, timed; the vector
    env against the sequential one on SEQ_CHECK_ENVS envs; one PPO update
    against a CPU copy."""
    import numpy as np

    from eva_vos_tpu_torch.data.datasets import AnnotTypeDB
    from eva_vos_tpu_torch.models.sam import SAMController
    from eva_vos_tpu_torch.ops.normalize import IMAGENET_MEAN, IMAGENET_STD
    from eva_vos_tpu_torch.train import ppo
    from eva_vos_tpu_torch.train.ppo import vector_env as VE

    db = AnnotTypeDB(root / "AnnotDB", "train")
    items = [db[i % len(db)] for i in range(FLEET_ENVS)]
    imgs = [(it["img"] - IMAGENET_MEAN) / IMAGENET_STD for it in items]
    gts = [it["gt_mask"] for it in items]
    inits = [it["mask"] for it in items]

    # the encode alone: a chunk of one image against a chunk of four
    u8 = [(np.clip(it["img"], 0, 1) * 255).astype(np.uint8)
          for it in items[:4]]
    chunks = {}
    for chunk in (1, 4):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        predictor.encode_images(u8, chunk=chunk)
        torch.cuda.synchronize()
        chunks[chunk] = dict(seconds=time.perf_counter() - start,
                             peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"[train fleet] ViT-H encode of 4 frames: "
          f"{ {k: {n: round(x, 3) for n, x in v.items()} for k, v in chunks.items()} } "
          f"(chunk: seconds, peak GB)", flush=True)

    trainer = ppo.PPOTrainer(action_space=2, ppo_epochs=FLEET_PPO_EPOCHS,
                             clip_param=0.2, value_loss_coef=0.5,
                             entropy_coef=1e-4, target_kl_div=0.02, lr=1e-5,
                             optim_str="Adam", arch="resnet18", dropout=0.5,
                             device=DEVICE)
    storage = ppo.RolloutStorage(num_envs=FLEET_ENVS, num_steps=FLEET_STEPS,
                                 num_mini_batch=FLEET_MINI_BATCH,
                                 device=DEVICE)
    timing = dict(encode=[], step=[], update=[])

    def timed(name, fn):
        def call(*args, **kw):
            torch.cuda.synchronize()
            start = time.perf_counter()
            res = fn(*args, **kw)
            torch.cuda.synchronize()
            timing[name].append(time.perf_counter() - start)
            return res
        return call

    encode, step = predictor.encode_images, VE.VectorizedAnnotationEnvs.step
    update = trainer._update
    predictor.encode_images = timed("encode", encode)
    VE.VectorizedAnnotationEnvs.step = timed("step", step)
    trainer._update = timed("update", update)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    try:
        envs = ppo.batched_rollouts(trainer, SAMController(predictor), imgs,
                                    gts, inits, storage, FLEET_STEPS, 0.95,
                                    "gae", np.random.default_rng(0))
        torch.cuda.synchronize()
        rollout_s = time.perf_counter() - start
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        loss = trainer.optimize(storage, np.random.default_rng(1))
    finally:
        predictor.encode_images = encode
        VE.VectorizedAnnotationEnvs.step = step
        trainer._update = update
    warm_s = rollout_s - sum(timing["encode"]) - sum(timing["step"])
    valid = ~storage.paddings
    rewards = storage.rewards[valid]
    update_ms = statistics.median(timing["update"]) * 1e3
    print(f"[train fleet] {FLEET_ENVS} envs: encode {sum(timing['encode']):.2f} s "
          f"(peak {peak_gb:.1f} GB allocated over the rollout), warm start "
          f"and the agent about {warm_s:.2f} s with {envs.warm_decodes} "
          f"decodes, steps {[round(x, 3) for x in timing['step']]} s; "
          f"{int(valid.sum())} valid steps, actions "
          f"{np.bincount(storage.actions[valid], minlength=2).tolist()}; "
          f"optimize ({FLEET_PPO_EPOCHS} epochs): "
          f"{len(timing['update'])} updates, median {update_ms:.1f} ms, loss "
          f"{loss:.4g}; on {card}", flush=True)
    if not np.isfinite(rewards).all() or not np.isfinite(loss):
        fail("the fleet: a non-finite reward or loss")
    if not valid.any(axis=1).all():
        fail("the fleet: an env took no step")

    # the vector env against the sequential one, the fleet's actions, ViT-H
    for e in range(SEQ_CHECK_ENVS):
        env = ppo.AnnotationEnv(SAMController(predictor), imgs[e], gts[e],
                                inits[e], FLEET_STEPS, device=DEVICE)
        steps = int(valid[e].sum())
        seq_rewards = [env.step(int(a))[0]
                       for a in storage.actions[e, :steps]]
        vs = envs.env_state[e]
        if not (np.allclose(seq_rewards, storage.rewards[e, :steps],
                            rtol=1e-6, atol=1e-9)
                and env.annotation_cost == vs["cost"]
                and env.iou == vs["iou"] and env.init_iou == vs["init_iou"]
                and np.array_equal(env.sam_mask, vs["sam_mask"])):
            fail(f"env {e}: the sequential env gives rewards {seq_rewards}, "
                 f"cost {env.annotation_cost}, IoU {env.iou}; the fleet "
                 f"{storage.rewards[e, :steps].tolist()}, {vs['cost']}, "
                 f"{vs['iou']}")
    print(f"[train fleet] the sequential env = the fleet on envs "
          f"0-{SEQ_CHECK_ENVS - 1} (rewards, cost, IoU, mask), ViT-H",
          flush=True)

    # one PPO update on the card against a CPU copy: float64 (loss, kl,
    # gradients) and the fp32 loss; a minibatch of 4, dropout 0
    batch = next(storage.data_generator(np.random.default_rng(2)))
    batch = {k: v[:4] for k, v in batch.items()}
    sd = {k: v.detach().cpu() for k, v in trainer.net.state_dict().items()}
    perr = {}
    for dtype in (torch.float64, torch.float32):
        sides = []
        for dev in (DEVICE, "cpu"):
            tr = ppo.PPOTrainer(action_space=2, ppo_epochs=1, clip_param=0.2,
                                value_loss_coef=0.5, entropy_coef=1e-4,
                                target_kl_div=None, lr=1e-5, optim_str="Adam",
                                arch="resnet18", dropout=0.0, device=dev)
            tr.net.load_state_dict(sd)
            tr.net.to(dtype)
            b = {k: v.to(dev, dtype) if v.is_floating_point() else v.to(dev)
                 for k, v in batch.items()}
            sides.append((tr.net, *tr._update(b)))
        tag = "f64" if dtype == torch.float64 else "fp32"
        perr[f"loss_{tag}"] = rel_err(sides[0][1], sides[1][1])
        perr[f"kl_{tag}"] = abs(sides[0][2].item() - sides[1][2].item())
        perr[f"update_{tag}"] = grads_rel_err(sides[0][0], sides[1][0])
    print(f"[train fleet] card vs CPU, one PPO update on 4 samples (max |d| "
          f"/ max |value|; kl: |d|): "
          f"{ {k: f'{v:.3g}' for k, v in perr.items()} }", flush=True)
    bad = {k: v for k, v in perr.items()
           if not v <= CPU_RTOL and k != "update_fp32"}
    if bad:
        fail(f"the PPO update differs from the CPU's: {bad}")
    return dict(envs=FLEET_ENVS, encode_chunks=chunks,
                encode_s=sum(timing["encode"]), peak_gb=peak_gb,
                warm_s=warm_s, warm_decodes=envs.warm_decodes,
                step_s=timing["step"], rollout_s=rollout_s,
                update_ms=update_ms, updates=len(timing["update"]),
                loss=loss, valid_steps=int(valid.sum()),
                mean_reward=float(rewards.mean()), cpu_rel_err=perr)


def write_davis_tree(root: Path, images, masks):
    """The video as a one-video DAVIS_17 tree under ``root``: frames as
    RGB PNG bytes under ``JPEGImages/480p/v0/NNNNN.jpg`` (the port's codec;
    the readers go by the bytes), object ids as palette PNGs, and
    ``ImageSets/2017/val.txt``.  Returns the uint8 frames written."""
    import numpy as np

    from eva_vos_tpu_torch.data._png import write_png

    db = root / "DAVIS_17"
    frames = np.rint(images * 255).astype(np.uint8)
    for sub in ("JPEGImages", "Annotations"):
        (db / sub / "480p" / "v0").mkdir(parents=True)
    for f in range(frames.shape[0]):
        write_png(db / "JPEGImages" / "480p" / "v0" / f"{f:05d}.jpg",
                  frames[f])
        write_png(db / "Annotations" / "480p" / "v0" / f"{f:05d}.png",
                  masks[0, f].astype(np.uint8),
                  palette=[[0, 0, 0], [128, 0, 0]])
    (db / "ImageSets" / "2017").mkdir(parents=True)
    (db / "ImageSets" / "2017" / "val.txt").write_text("v0\n")
    return frames


def cli_phase(torch, results, card, images, masks):
    """The eval CLI's ``main`` on phase 6's video written as a DAVIS_17
    tree: oracle_mask against a direct call, eva_vos with ViT-H, rand_rand
    in bf16 traced, ``--resume``, ``--multihost`` and ``vis.read_exp``;
    #1 / #2 launches every round."""
    import ast
    import os
    import tempfile

    import numpy as np

    from eva_vos_tpu_torch import interactions as I
    from eva_vos_tpu_torch import vis
    from eva_vos_tpu_torch.cli import eval_annotation_method as cli
    from eva_vos_tpu_torch.data.datasets import AnnotationDataset
    from eva_vos_tpu_torch.engine import EngineConfig, InferenceEngine
    from eva_vos_tpu_torch.interactions import eval as E
    from eva_vos_tpu_torch.interactions import mask as MASK
    from eva_vos_tpu_torch.interactions import multiple as MULTI
    from eva_vos_tpu_torch.utils import model_zoo
    from eva_vos_tpu_torch.utils.table import read_columns

    phase_start = time.perf_counter()
    counters = {k: c for k, c in launch_counters().items()
                if k in ("memory_topk", "memory_readout")}
    out = {}
    env_keys = ("EVAVOS_DATA_ROOT", "EVAVOS_WEIGHTS_ROOT",
                "EVAVOS_NUM_PROCESSES")
    saved_env = {k: os.environ.get(k) for k in env_keys}
    deterministic = torch.backends.cudnn.deterministic
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    saved = dict(build=cli.build_models, dispatch=cli.dispatch,
                 mask=MASK.eval_session_metric,
                 multi=MULTI.eval_session_metric)
    try:
        torch.backends.cudnn.deterministic = True
        os.environ["EVAVOS_DATA_ROOT"] = str(root / "data")
        os.environ["EVAVOS_WEIGHTS_ROOT"] = str(root / "weights")
        os.environ.pop("EVAVOS_NUM_PROCESSES", None)
        (root / "weights").mkdir()
        t0 = time.perf_counter()
        frames = write_davis_tree(root / "data", images, masks)
        print(f"[cli] a DAVIS_17 tree of T = {frames.shape[0]}, "
              f"{frames.shape[1]}x{frames.shape[2]} written in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)

        # the CLI's build and each round timed: build_models, and the
        # rounds' evaluations stamped from dispatch's start
        timing = {}

        def build(args):
            start = time.perf_counter()
            models = saved["build"](args)
            torch.cuda.synchronize()
            timing["build_s"] = time.perf_counter() - start
            return models

        def dispatch(*args):
            timing["stamps"] = [time.perf_counter()]
            result = saved["dispatch"](*args)
            torch.cuda.synchronize()
            return result

        def stamped(orig):
            def rec(session, metric="j"):
                result = orig(session, metric)
                timing["stamps"].append(time.perf_counter())
                return result
            return rec

        cli.build_models, cli.dispatch = build, dispatch
        MASK.eval_session_metric = stamped(saved["mask"])
        MULTI.eval_session_metric = stamped(saved["multi"])

        def run(tag, argv, rounds):
            """``main(argv)`` with the counters zeroed just before it and
            read just after; #1 / #2 at least once a round."""
            timing.clear()
            timing["stamps"] = []
            for c in counters.values():
                c.launches = 0
            torch.cuda.synchronize()
            start = time.perf_counter()
            path = cli.main(argv + ["--device", DEVICE])
            torch.cuda.synchronize()
            total_s = time.perf_counter() - start
            launches = {k: c.launches for k, c in counters.items()}
            stamps = timing["stamps"]
            round_s = [b - a for a, b in zip(stamps, stamps[1:])]
            spans = (E.LAST_SESSION.timers.summary() if rounds else {})
            print(f"[cli {tag}] {' '.join(argv[:4])}: main {total_s:.2f} s "
                  f"(build {timing.get('build_s', 0.0):.2f} s); seconds a "
                  f"round {[round(x, 3) for x in round_s]}; launches "
                  f"{launches}; on {card}", flush=True)
            for name, span in spans.items():
                print(f"[cli {tag}] span {name}: {span}", flush=True)
            if len(round_s) != rounds:
                fail(f"cli {tag}: {len(round_s)} rounds, not {rounds}")
            if rounds and min(launches.values()) < rounds:
                fail(f"cli {tag}: #1 / #2 launched {launches} times in "
                     f"{rounds} rounds")
            out[tag] = dict(argv=argv, main_s=total_s,
                            build_s=timing.get("build_s"), round_s=round_s,
                            spans=spans, launches=launches)
            return Path(path)

        db = ["--db", "DAVIS_17", "--allow-random"]
        mask_argv = ["--policy", "oracle_mask", "--rounds",
                     str(CLI_MASK_ROUNDS)] + db

        # (a) oracle_mask, fp32, against a direct call on the sample
        path_a = run("a", mask_argv + ["--out-dir", str(root / "exp_a"),
                                       "--timers"], CLI_MASK_ROUNDS)
        table_a = read_columns(path_a)
        ds = AnnotationDataset(root / "data" / "DAVIS_17",
                               root / "data" / "DAVIS_17" / "ImageSets"
                               / "2017" / "val.txt")
        sample = ds[0]
        read_back = np.rint(sample.images01 * 255).astype(np.uint8)
        if not np.array_equal(read_back, frames):
            fail("cli: the frames read back differ from the frames written")
        if not np.array_equal(sample.gt, masks[:1]):
            fail("cli: the masks read back differ from the masks written")
        stcn = model_zoo.load_stcn(allow_random=True, device=DEVICE)
        fusion = model_zoo.load_fusion(allow_random=True, device=DEVICE)
        engine = InferenceEngine(stcn, fusion, EngineConfig(
            max_interactions=CLI_MASK_ROUNDS + 2), device=DEVICE)
        mus, times = I.oracle_mask(CLI_MASK_ROUNDS, engine, sample,
                                   "j_and_f")
        direct_frames = E.LAST_SESSION.frames_list
        d_mu = max(abs(a - b) for a, b in zip(table_a["mu_metric"], mus))
        print(f"[cli a] the CSV against the direct oracle_mask call: frames "
              f"{direct_frames}, times {table_a['annotation_time']} / "
              f"{times}, largest |d mu_metric| {d_mu:.3g}; the frames read "
              f"back equal the frames written", flush=True)
        if [float(x) for x in table_a["annotation_time"]] != \
                [float(x) for x in times]:
            fail(f"cli a: annotation times {table_a['annotation_time']}, "
                 f"direct {times}")
        if len(mus) != len(table_a["mu_metric"]) or d_mu > CLI_MU_ATOL:
            fail(f"cli a: mu_metric {table_a['mu_metric']}, direct {mus}")
        out["a"].update(direct_frames=direct_frames, direct_mu=mus,
                        d_mu=d_mu, mu=table_a["mu_metric"])
        del engine, stcn, fusion

        # (b) eva_vos with ViT-H SAM, fp32
        path_b = run("b", ["--policy", "eva_vos", "--rounds",
                           str(CLI_EVA_ROUNDS)] + db
                     + ["--out-dir", str(root / "exp_b")], CLI_EVA_ROUNDS)
        table_b = read_columns(path_b)
        per_frame = [ast.literal_eval(m) for m in table_b["round_metrics"]]
        print(f"[cli b] columns {list(table_b)}; actions "
              f"{table_b['annotation_actions']}; frames "
              f"{table_b['annotated_frames']}; rl_values "
              f"{table_b['rl_values']}", flush=True)
        if list(table_b) != CLI_EVA_COLUMNS:
            fail(f"cli b: columns {list(table_b)}")
        if len(table_b["video"]) != CLI_EVA_ROUNDS or \
                set(table_b["weights"]) != {"RANDOM_WEIGHTS"}:
            fail(f"cli b: rows {table_b['video']} {table_b['weights']}")
        if any(len(m) != frames.shape[0] or not all(
                isinstance(x, (int, float)) for x in m) for m in per_frame):
            fail("cli b: a round_metrics cell is not one number a frame")
        out["b"].update(actions=table_b["annotation_actions"],
                        mu=table_b["mu_metric"])

        # (c) rand_rand on the fake SAM in bf16, traced
        trace_dir = root / "trace"
        run("c", ["--policy", "rand_rand", "--rounds", str(CLI_RAND_ROUNDS)]
            + db + ["--fake-sam", "--dtype", "bf16", "--types", "3clicks",
                    "mask", "--profile-dir", str(trace_dir), "--out-dir",
                    str(root / "exp_c")], CLI_RAND_ROUNDS)
        traces = sorted(trace_dir.glob("*.json"))
        text = "".join(p.read_text() for p in traces)
        named = {k: k in text for k in ("topk_prune_block_kernel",
                                        "readout_kernel")}
        print(f"[cli c] trace {[p.name for p in traces]} "
              f"({sum(p.stat().st_size for p in traces)} bytes) names "
              f"{named}", flush=True)
        if not traces or not all(named.values()):
            fail(f"cli c: the trace {traces} names {named}")
        out["c"]["trace_names"] = named

        # (d) (a) with --resume: no row added, the file unchanged
        before = path_a.read_bytes()
        path_d = run("d", mask_argv + ["--out-dir", str(root / "exp_a"),
                                       "--resume"], 0)
        same = path_d == path_a and path_d.read_bytes() == before
        print(f"[cli d] --resume: the file unchanged {same}", flush=True)
        if not same:
            fail("cli d: --resume changed the CSV")

        # (e) (a) with --multihost, one process: the whole range
        path_e = run("e", mask_argv + ["--out-dir", str(root / "exp_e"),
                                       "--multihost"], CLI_MASK_ROUNDS)
        table_e = read_columns(path_e)
        d_mu_e = max(abs(a - b) for a, b in zip(table_e["mu_metric"],
                                                table_a["mu_metric"]))
        print(f"[cli e] --multihost: {path_e.name}, "
              f"{len(table_e['video'])} rows, byte-identical to (a) "
              f"{path_e.read_bytes() == before}, largest |d mu_metric| "
              f"{d_mu_e:.3g}", flush=True)
        if path_e.name != path_a.name or d_mu_e > CLI_MU_ATOL or any(
                table_e[k] != table_a[k] for k in table_a
                if k != "mu_metric"):
            fail(f"cli e: {path_e.name} {table_e} against (a)'s {table_a}")

        # (f) the vis readers on (a)'s and (b)'s CSVs
        curves = {}
        for tag, path in (("a", path_a), ("b", path_b)):
            hours, quality = vis.read_exp(str(path))
            curves[tag] = dict(hours=[float(x) for x in hours],
                               quality=[float(x) for x in quality])
            if not (np.all(np.isfinite(hours))
                    and np.all(np.isfinite(quality))):
                fail(f"cli f: read_exp({path.name}) {curves[tag]}")
        print(f"[cli f] read_exp: {curves}", flush=True)
        out["read_exp"] = curves
    finally:
        cli.build_models, cli.dispatch = saved["build"], saved["dispatch"]
        MASK.eval_session_metric = saved["mask"]
        MULTI.eval_session_metric = saved["multi"]
        torch.backends.cudnn.deterministic = deterministic
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        tmp.cleanup()
    phase_s = time.perf_counter() - phase_start
    print(f"[cli] the phase took {phase_s:.1f} s", flush=True)
    results["cli"] = dict(out, phase_s=phase_s)


def run_episode(torch, engine, feats, pad, masks, frames=None):
    """Interacts at ``frames`` (PARALLEL_FRAMES by default) from a fresh
    state (donating it), after one untimed warm-up interact at the first
    frame (a group's first collective sets up its communicator); for
    each, its untraced host ms, the sharded reads it made and #1's
    launches, the counters zeroed just before it and read just after."""
    from eva_vos_tpu_torch import kernels as K
    from eva_vos_tpu_torch.engine import pad_mask
    from eva_vos_tpu_torch.engine import propagation as P

    reads = [0]
    orig = P.sharded_memory_readout

    def counted(*args, **kwargs):
        reads[0] += 1
        return orig(*args, **kwargs)

    def sync():
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)

    frames = frames or PARALLEL_FRAMES
    engine.interact(engine.init_state(feats, 1), feats, pad_mask(
        masks[:1, frames[0]], pad, device=engine.device), frames[0],
        donate=True)
    state, rows = engine.init_state(feats, 1), []
    P.sharded_memory_readout = counted
    try:
        for idx in frames:
            mask = pad_mask(masks[:1, idx], pad, device=engine.device)
            reads[0], K.topk_select.launches = 0, 0
            sync()
            start = time.perf_counter()
            state = engine.interact(state, feats, mask, idx, donate=True)
            sync()
            rows.append(dict(frame=idx, reads=reads[0],
                             ms=(time.perf_counter() - start) * 1e3,
                             topk_launches=K.topk_select.launches))
    finally:
        P.sharded_memory_readout = orig
    return state, rows


def check_episode(name, rows):
    """Every sharded read launched #1 once."""
    for r in rows:
        if r["reads"] <= 0 or r["topk_launches"] != r["reads"]:
            fail(f"{name}: #1 launched {r['topk_launches']} times for "
                 f"{r['reads']} sharded reads at frame {r['frame']}")


def prob_off(torch, got, want) -> tuple:
    """(share of probabilities off by more than PROB_ATOL, max |d|)."""
    diff = (got.float() - want.float()).abs()
    return (diff > PROB_ATOL).float().mean().item(), diff.max().item()


def bank_bytes(state) -> int:
    return (state.bank_k.numel() * state.bank_k.element_size()
            + state.bank_v.numel() * state.bank_v.element_size())


def readout_bytes(torch, mesh, state, feats) -> dict:
    """The collective bytes of one sharded read at the blocked step's N
    (mem_freq frames of queries) on this rank's whole bank and on a quarter
    of it (at least top_k tokens, which bound each rank's candidates),
    against comm_model_bytes."""
    from eva_vos_tpu_torch.parallel import (collective_bytes,
                                            comm_model_bytes,
                                            sharded_memory_readout)

    slots, hw, ck = state.bank_k.shape
    qk = feats.k16[1:6].reshape(-1, ck)
    quarter = max(slots // 4, -(-TOP_K // hw))
    out = {}
    for part in (slots, quarter):
        mk = state.bank_k[:part].reshape(-1, ck)
        mv = state.bank_v[:, :part].reshape(1, -1, state.bank_v.shape[-1])
        out[part] = collective_bytes(
            sharded_memory_readout, mesh, mk, qk, mv, TOP_K, mesh,
            valid_tokens=mesh.size * part * hw)["total_bytes"]
    model = comm_model_bytes(qk.shape[0], TOP_K, CV, 1, mesh.size)
    return dict(n=qk.shape[0], whole=out[slots], quarter=out[quarter],
                model=model["total_bytes"])


def check_readout_bytes(name, b):
    if b["whole"] != b["quarter"] or not 0 < b["whole"] <= 4 * b["model"]:
        fail(f"{name}: collective bytes {b}: they must not depend on the "
             f"bank and stay within 4x the model")


def parallel_rank(torch, spec, rank: int, size: int) -> dict:
    """One process of the parallel phase's group: the full-width sharded
    episode against the one-card engine's, its bank, its collective bytes,
    and the data-parallel QNet step and PPO update at the CLI's widths
    against the one-process ones."""
    from eva_vos_tpu_torch.data import synthetic_video
    from eva_vos_tpu_torch.engine import (EngineConfig, InferenceEngine,
                                          prepare_video)
    from eva_vos_tpu_torch.models import FusionNet, PropagationNetwork
    from eva_vos_tpu_torch.parallel import make_mesh
    from eva_vos_tpu_torch.parallel.dryrun import (ppo_update_check,
                                                   qnet_step_check)

    mesh = make_mesh(size, device=spec["device"])
    if mesh.device.type == "cuda":
        torch.cuda.set_device(mesh.device)
    eng = spec["engine"]
    dtype = torch.bfloat16
    weights = torch.load(spec["weights"])
    stcn = PropagationNetwork(key_arch=eng["key_arch"],
                              value_arch="resnet18").to(dtype)
    stcn.load_state_dict(weights["stcn"])
    fusion = FusionNet().to(dtype)
    fusion.load_state_dict(weights["fusion"])
    cfg = EngineConfig(mem_freq=5, top_k=TOP_K, max_interactions=60,
                       feature_chunk=2, readout_strategy="sharded")
    engine = InferenceEngine(stcn, fusion, cfg, mesh=mesh)
    images, masks = synthetic_video(eng["t"], eng["h"], eng["w"],
                                    num_objects=1, seed=0)
    padded, pad = prepare_video(images, dtype=dtype, device=mesh.device)
    feats = engine.precompute_features(padded)
    before = dict(mesh.collective_bytes)
    state, rows = run_episode(torch, engine, feats, pad, masks,
                              spec["frames"])
    moved = {k: mesh.collective_bytes[k] - before[k] for k in before}
    ref = torch.load(spec["ref_prob"]).to(mesh.device)
    off, dmax = prob_off(torch, state.prob, ref)
    out = dict(rank=rank, device=str(mesh.device), rounds=rows,
               bank_bytes=bank_bytes(state), episode_bytes=moved,
               share_off=off, max_abs_dp=dmax,
               finite=bool(torch.isfinite(state.prob).all()),
               readout_bytes=readout_bytes(torch, mesh, state, feats))
    del state, feats, engine
    for name, fn, kw in (
            ("qnet", qnet_step_check, dict(rows=spec["qnet_rows"],
                                           size=spec["qnet_size"])),
            ("ppo", ppo_update_check, dict(rows=spec["ppo_rows"], emb_hw=64,
                                           mask_hw=spec["qnet_size"]))):
        start = time.perf_counter()
        out[name] = fn(mesh, dtype=torch.float32, **kw)
        out[name]["seconds"] = time.perf_counter() - start
    return out


def parallel_worker(argv) -> int:
    """``chip_smoke.py --parallel-worker <spec.json> <rank> <size>``: one
    process of the parallel phase's group (spawned by ``parallel_group``)."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    spec = json.loads(Path(argv[0]).read_text())
    rank, size = int(argv[1]), int(argv[2])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(spec["backend"], init_method=spec["store"],
                            world_size=size, rank=rank)
    try:
        out = parallel_rank(torch, spec, rank, size)
    finally:
        dist.destroy_process_group()
    Path(spec["out"], f"rank{rank}.json").write_text(json.dumps(out))
    return 0


def parallel_group(torch, name, backend, n, tmp, one_card, card) -> list:
    """(b) / (c): the parallel phase's ranks in ``n`` processes over
    ``backend``, each checked against the one-card episode ``one_card``."""
    from eva_vos_tpu_torch.parallel.dryrun import spawn

    out_dir = Path(tmp, name)
    out_dir.mkdir()
    spec = dict(backend=backend, store=Path(out_dir, "store").as_uri(),
                weights=str(Path(tmp, "weights.pt")),
                ref_prob=str(Path(tmp, "ref_prob.pt")), out=str(out_dir),
                device=DEVICE, engine=ENGINE, frames=PARALLEL_FRAMES,
                qnet_rows=QNET_DP_ROWS, qnet_size=QNET_DP_SIZE,
                ppo_rows=PPO_DP_ROWS)
    Path(out_dir, "spec.json").write_text(json.dumps(spec))
    start = time.perf_counter()
    spawn(n, [ROOT / "chip_smoke.py", "--parallel-worker",
              Path(out_dir, "spec.json")], PARALLEL_TIMEOUT_S)
    wall = time.perf_counter() - start
    ranks = [json.loads(Path(out_dir, f"rank{r}.json").read_text())
             for r in range(n)]
    for r in ranks:
        tag = f"[parallel {name}] rank {r['rank']} ({r['device']})"
        check_episode(f"{tag} episode", r["rounds"])
        if not r["finite"] or r["share_off"] > PROB_FRAC:
            fail(f"{tag}: {r['share_off']:.2e} of probabilities off the "
                 f"one-card engine's by > {PROB_ATOL} (finite: "
                 f"{r['finite']})")
        if r["bank_bytes"] * n != one_card["bank_bytes"]:
            fail(f"{tag}: bank {r['bank_bytes']} B, not 1/{n} of the "
                 f"one-card bank's {one_card['bank_bytes']} B")
        check_readout_bytes(tag, r["readout_bytes"])
        for step in ("qnet", "ppo"):
            e = r[step]
            if not math.isfinite(e["loss"]) or e["loss_err"] > DP_LOSS_RTOL:
                fail(f"{tag} {step}: data-parallel loss {e['loss']} off the "
                     f"one-process loss by {e['loss_err']:.2e}")
            if not (e["param_l2_err"] <= DP_PARAM_L2
                    and e["stat_err"] <= DP_STAT_TOL):
                fail(f"{tag} {step}: data-parallel step off the one-process "
                     f"step: parameters {e['param_l2_err']:.2e} of a leaf's "
                     f"change in L2 (limit {DP_PARAM_L2}), running "
                     f"statistics {e['stat_err']:.2e} (limit {DP_STAT_TOL})")
        print(f"{tag}: interacts at frames {list(PARALLEL_FRAMES)}: "
              + ", ".join(f"{x['ms']:.0f} ms ({x['reads']} reads, #1 x "
                          f"{x['topk_launches']})" for x in r["rounds"])
              + f"; probabilities off the one-card engine by > {PROB_ATOL}:"
              f" {r['share_off']:.2e} (max |dp| {r['max_abs_dp']:.3g}); bank "
              f"{r['bank_bytes'] / 2**20:.1f} MiB (one card "
              f"{one_card['bank_bytes'] / 2**20:.1f} MiB); collectives "
              f"{r['episode_bytes']} B over the episode, "
              f"{r['readout_bytes']['whole']} B a read at N = "
              f"{r['readout_bytes']['n']} on the whole bank and on a quarter "
              f"(model {r['readout_bytes']['model']} B)", flush=True)
        print(f"{tag}: data-parallel QNet step (resnet18, {QNET_DP_SIZE} px, "
              f"batch {QNET_DP_ROWS}, fp32) against one process: loss rel "
              f"err {r['qnet']['loss_err']:.2e}, params "
              f"{r['qnet']['param_err']:.2e} of a leaf's largest change, "
              f"{r['qnet']['param_l2_err']:.2e} in L2, running stats "
              f"{r['qnet']['stat_err']:.2e}; PPO update (minibatch "
              f"{PPO_DP_ROWS}): loss {r['ppo']['loss_err']:.2e}, params "
              f"{r['ppo']['param_err']:.2e}, {r['ppo']['param_l2_err']:.2e} "
              f"in L2, running stats {r['ppo']['stat_err']:.2e}; both checks "
              f"{r['qnet']['seconds']:.2f} s / {r['ppo']['seconds']:.2f} s "
              f"(host; {n} processes on {card}: these times say nothing "
              f"about scaling)", flush=True)
    print(f"[parallel {name}] {n} processes over {backend}: {wall:.1f} s "
          f"with start-up", flush=True)
    return ranks


def native_check(torch, engine, images, masks):
    """(d): rand_rand's click rounds of the policy phase on the fake SAM
    with the native click robot and with scipy's, in turns (scipy, native,
    native, scipy): equal clicks, and each run's ``annotate`` span."""
    import os

    import numpy as np

    from eva_vos_tpu_torch import interactions as I
    from eva_vos_tpu_torch import native
    from eva_vos_tpu_torch.annotator import Annotator, FakeSAMController
    from eva_vos_tpu_torch.interactions import eval as E
    from eva_vos_tpu_torch.interactions import multiple as MULTI

    _, rounds, kwargs = next(p for p in POLICY_LOOPS if p[0] == "rand_rand")
    sample = I.VideoSample(name="synthetic_seed0", images01=images, gt=masks)
    I.initialize(engine, sample)
    saved = os.environ.get("EVAVOS_NATIVE")
    runs = []
    for flag in ("0", "1", "1", "0"):       # in turns
        clicks, calls = [], [0]
        annotate, center = MULTI.annotate, native.largest_component_center

        def recorded(*args, **kw):
            out = annotate(*args, **kw)
            clicks.append([args[1]] + [None if x is None else
                                       np.asarray(x).tolist()
                                       for x in out[4:6]])
            return out

        def counted(mask):
            calls[0] += 1
            return center(mask)

        os.environ["EVAVOS_NATIVE"] = flag
        MULTI.annotate, native.largest_component_center = recorded, counted
        try:
            torch.cuda.synchronize()
            start = time.perf_counter()
            I.rand_rand(rounds, engine, sample,
                        Annotator(FakeSAMController()), **kwargs)
            seconds = time.perf_counter() - start
        finally:
            MULTI.annotate, native.largest_component_center = annotate, center
            if saved is None:
                os.environ.pop("EVAVOS_NATIVE", None)
            else:
                os.environ["EVAVOS_NATIVE"] = saved
        spans = E.LAST_SESSION.timers.summary()
        runs.append(dict(native=flag == "1", clicks=clicks,
                         native_calls=calls[0], seconds=seconds,
                         annotate=spans.get("annotate")))
        print(f"[parallel native] rand_rand ({rounds} rounds) with the "
              f"{'native' if flag == '1' else 'scipy'} click robot: "
              f"{seconds:.2f} s, annotate span {spans.get('annotate')}, "
              f"{calls[0]} native labelings", flush=True)
    for r in runs:
        if (r["native_calls"] > 0) != r["native"]:
            fail(f"native robot: {r['native_calls']} native labelings in a "
                 f"run {'with' if r['native'] else 'without'} it")
        if r["clicks"] != runs[0]["clicks"]:
            fail("native robot: its clicks differ from scipy's")
    if not any(c[1] for c in runs[0]["clicks"]):
        fail("native robot: rand_rand made no click")
    print(f"[parallel native] {len(runs[0]['clicks'])} annotations, the "
          f"same clicks in all four runs", flush=True)
    return dict(runs=runs, labeling=labeling_check(masks))


def labeling_check(masks):
    """The click robot's labeling alone (``_largest_component_click``, what
    each click calls) on one error mask at the video's size, the frame-0
    and frame-10 masks' difference: LABEL_CALLS calls a turn, with scipy
    and the native library in turns (scipy, native, native, scipy); the
    same result, and each turn's median ms a call."""
    import os
    import statistics

    import numpy as np

    from eva_vos_tpu_torch.annotator import robots

    err = np.asarray(masks[0, 0]).astype(bool) ^ np.asarray(
        masks[0, 10]).astype(bool)
    saved = os.environ.get("EVAVOS_NATIVE")
    turns = []
    try:
        for flag in ("0", "1", "1", "0"):
            os.environ["EVAVOS_NATIVE"] = flag
            ms = []
            for _ in range(LABEL_CALLS):
                start = time.perf_counter()
                out = robots._largest_component_click(err)
                ms.append((time.perf_counter() - start) * 1e3)
            turns.append(dict(native=flag == "1", out=list(out),
                              median_ms=statistics.median(ms),
                              min_ms=min(ms)))
    finally:
        if saved is None:
            os.environ.pop("EVAVOS_NATIVE", None)
        else:
            os.environ["EVAVOS_NATIVE"] = saved
    if any(t["out"] != turns[0]["out"] for t in turns) or turns[0]["out"][1] == 0:
        fail(f"native robot: labelings differ or find nothing: "
             f"{[t['out'] for t in turns]}")
    print(f"[parallel native] labeling a {err.shape[1]}x{err.shape[0]} error "
          f"mask ({int(err.sum())} pixels), {LABEL_CALLS} calls a turn, "
          f"median (min) ms a call in turns: " + ", ".join(
              f"{'native' if t['native'] else 'scipy'} {t['median_ms']:.3f} "
              f"({t['min_ms']:.3f})" for t in turns) + " (host)", flush=True)
    return turns


def sharded_large_k(torch, card, engine, mesh, feats, pad, masks) -> dict:
    """(a) at top_k LARGE_K_ENGINE: the sharded engine on ``mesh`` (its
    local selection #1's large-k path) against the fused engine at the
    same top_k over PARALLEL_FRAMES, within PROB_ATOL / PROB_FRAC, #1 once
    a sharded read."""
    from eva_vos_tpu_torch.engine import InferenceEngine

    cfg = engine.config._replace(top_k=LARGE_K_ENGINE)
    fused = InferenceEngine(engine.stcn, engine.fusion, cfg, device=DEVICE)
    sharded = InferenceEngine(engine.stcn, engine.fusion, cfg._replace(
        readout_strategy="sharded"), mesh=mesh)
    fused_state, fused_rows = run_episode(torch, fused, feats, pad, masks)
    state, rows = run_episode(torch, sharded, feats, pad, masks)
    check_episode(f"[parallel a] top_k {LARGE_K_ENGINE}", rows)
    off, dmax = prob_off(torch, state.prob, fused_state.prob)
    if not torch.isfinite(state.prob).all() or off > PROB_FRAC:
        fail(f"[parallel a] top_k {LARGE_K_ENGINE}: {off:.2e} of "
             f"probabilities off the fused engine's by > {PROB_ATOL}")
    print(f"[parallel a] top_k {LARGE_K_ENGINE}: sharded interacts at frames "
          f"{list(PARALLEL_FRAMES)}: " + ", ".join(
              f"{x['ms']:.0f} ms ({x['reads']} reads, #1 x "
              f"{x['topk_launches']})" for x in rows)
          + "; fused engine: " + ", ".join(f"{x['ms']:.0f} ms"
                                           for x in fused_rows)
          + f" (untraced); probabilities off the fused engine's by > "
          f"{PROB_ATOL}: {off:.2e} (max |dp| {dmax:.3g}); on {card}",
          flush=True)
    return dict(top_k=LARGE_K_ENGINE, rounds=rows, fused_rounds=fused_rows,
                share_off=off, max_abs_dp=dmax)


def parallel_phase(torch, results, card, engine, images, masks):
    """The parallel phase: (a) a one-process NCCL group, (b) two processes
    sharing the card over gloo and the gloo dry run, (c) NCCL across cards
    where there are several, (d) the native click robot."""
    import tempfile

    import torch.distributed as dist

    from eva_vos_tpu_torch import kernels as K
    from eva_vos_tpu_torch import native
    from eva_vos_tpu_torch.engine import InferenceEngine, prepare_video
    from eva_vos_tpu_torch.ops.memory_attention import NEG_INF
    from eva_vos_tpu_torch.parallel import dryrun_multichip, make_mesh

    phase_start = time.perf_counter()
    native.build()            # before any process is spawned
    out = {}
    padded, pad = prepare_video(images, dtype=torch.bfloat16, device=DEVICE)
    feats = engine.precompute_features(padded)

    # the selections' output on an empty shard (rank > 0 at frame 0)
    qk = feats.k16[1:6].reshape(-1, CK)
    mk = feats.k16[:36].reshape(-1, CK)
    empty = {}
    for name, fn in (("memory_topk", K.topk_select),
                     ("memory_topk_chunked", K.topk_select_chunked),
                     ("memory_topk_resident", K.topk_select_resident)):
        vals, idx = fn(qk, mk, 0, TOP_K)
        torch.cuda.synchronize()
        empty[name] = bool((vals == NEG_INF).all()) and bool(
            ((idx >= 0) & (idx < mk.shape[0])).all())
    print(f"[parallel a] fill 0: every score NEG_INF with in-range ids: "
          f"{empty}", flush=True)
    if not all(empty.values()):
        fail(f"a selection at fill 0 writes other than NEG_INF: {empty}")

    with tempfile.TemporaryDirectory() as tmp:
        # (a) one process, an NCCL group of one, full width
        dist.init_process_group(ONE_CARD_BACKEND, init_method=Path(
            tmp, "store_a").as_uri(), world_size=1, rank=0)
        try:
            mesh = make_mesh(device=DEVICE)
            sharded = InferenceEngine(
                engine.stcn, engine.fusion, engine.config._replace(
                    readout_strategy="sharded"), mesh=mesh)
            fused_state, fused_rows = run_episode(torch, engine, feats, pad,
                                                  masks)
            before = dict(mesh.collective_bytes)
            state, rows = run_episode(torch, sharded, feats, pad, masks)
            moved = {k: mesh.collective_bytes[k] - before[k] for k in before}
            check_episode("[parallel a]", rows)
            off, dmax = prob_off(torch, state.prob, fused_state.prob)
            if not torch.isfinite(state.prob).all() or off > PROB_FRAC:
                fail(f"[parallel a]: {off:.2e} of probabilities off the "
                     f"fused engine's by > {PROB_ATOL}")
            rb = readout_bytes(torch, mesh, state, feats)
            check_readout_bytes("[parallel a]", rb)
            out["a"] = dict(rounds=rows, fused_rounds=fused_rows,
                            share_off=off, max_abs_dp=dmax,
                            episode_bytes=moved, readout_bytes=rb,
                            bank_bytes=bank_bytes(state), empty_fill=empty)
            print(f"[parallel a] sharded engine, one-process NCCL group: "
                  f"interacts at frames {list(PARALLEL_FRAMES)}: "
                  + ", ".join(f"{x['ms']:.0f} ms ({x['reads']} reads, #1 x "
                              f"{x['topk_launches']})" for x in rows)
                  + "; fused engine: " + ", ".join(
                      f"{x['ms']:.0f} ms" for x in fused_rows)
                  + f" (untraced); probabilities off the fused engine's by > "
                  f"{PROB_ATOL}: {off:.2e} (max |dp| {dmax:.3g}); collectives "
                  f"{moved} B over the episode, {rb['whole']} B a read at N "
                  f"= {rb['n']} (model {rb['model']} B); on {card}",
                  flush=True)
            out["a512"] = sharded_large_k(torch, card, engine, mesh, feats,
                                          pad, masks)
        finally:
            dist.destroy_process_group()
        torch.save({"stcn": engine.stcn.state_dict(),
                    "fusion": engine.fusion.state_dict()},
                   Path(tmp, "weights.pt"))
        torch.save(state.prob.half().cpu(), Path(tmp, "ref_prob.pt"))
        one_card = out["a"]
        del state, fused_state, feats, sharded
        torch.cuda.empty_cache()

        # (b) two processes sharing the card over gloo
        out["b"] = parallel_group(torch, "gloo2", "gloo", 2, tmp, one_card,
                                  card)
        start = time.perf_counter()
        out["dryrun_gloo2"] = dryrun_multichip(2, device=DEVICE,
                                               timeout=PARALLEL_TIMEOUT_S)
        out["dryrun_gloo2"]["seconds"] = time.perf_counter() - start

        # (c) NCCL across cards
        count = torch.cuda.device_count()
        if count >= 2:
            n = min(4, count)
            out["c"] = parallel_group(torch, f"nccl{n}", "nccl", n, tmp,
                                      one_card, card)
            out["dryrun_nccl"] = dryrun_multichip(n, "nccl", "cuda",
                                                  timeout=PARALLEL_TIMEOUT_S)
        else:
            out["c"] = None
            print(f"[parallel nccl-multi] not run: {count} card", flush=True)

    # (d) the native click robot
    out["native"] = native_check(torch, engine, images, masks)
    out["topk_launches"] = (
        sum(x["topk_launches"] for x in out["a"]["rounds"])
        + sum(x["topk_launches"] for x in out["a512"]["rounds"])
        + sum(x["topk_launches"] for r in out["b"] for x in r["rounds"])
        + sum(x["topk_launches"] for r in out["c"] or [] for x in r["rounds"]))
    phase_s = time.perf_counter() - phase_start
    print(f"[parallel] #1 launched {out['topk_launches']} times on the sharded"
          f" episodes; the phase took {phase_s:.1f} s", flush=True)
    results["parallel"] = dict(out, phase_s=phase_s)


def kernels_line(results, launches):
    """Each kernel's entry of the kernels JSON line: its time, plain time,
    library time and bound at a 72-slot clustered bank (N = 8100; readouts
    K = 1), its largest error over all cases, and its launches on the engine
    read that runs it (on the entry-point phase for the kernels that no
    engine read runs); then the large-k paths of #1 and #2 (phase 6c)."""

    def widths(name):
        """The key widths the selection ``name`` ran at (phase 6d, and 64
        in every other phase); None for a readout (it reads no keys)."""
        if "topk" not in name:
            return None
        return sorted({CK} | {r["ck"] for r in results["widths"]["cases"]
                              if r["kernel"] == name})

    def row(name, rows):
        readout = "topk" not in name
        mine = [r for r in rows if readout or r["kernel"] == name]
        head = next(r for r in mine if r["case"] in (
            f"fill{max(FILLS)}_clustered", f"fill{max(FILLS)}_clustered_K1")
            and r.get("n", N_QUERIES) == N_QUERIES)
        key = f"{name}_" if readout else ""
        return {"name": name, "route": "cuda",
                "source": f"eva_vos_tpu_torch/kernels/csrc/{SOURCES[name]}",
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": max(r[f"{key}err" if readout else "max_abs_err"]
                                   for r in mine),
                "ms": head[f"{key}ms"], "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                "library_ms": head["library_ms"], "key_widths": widths(name)}

    def large_k_row(name):
        """A large-k path's entry: its times at the fullest clustered bank
        at top_k LARGE_K[0] in bf16, its largest error over all cases, its
        launches on phase 6c's fused interacts."""
        base = LARGE_K_LINE[name]
        mine = results["large_k"]["selection" if "topk" in name
                                  else "readout"]
        head = next(r for r in mine if r["case"] == (
            f"fill{max(FILLS)}_clustered N={N_QUERIES} top_k={LARGE_K[0]} "
            f"bf16"))
        return {"name": name, "route": "cuda",
                "source": f"eva_vos_tpu_torch/kernels/csrc/{SOURCES[base]}",
                "replaces": REPLACES[base], "launches": launches[name],
                "max_abs_err": max(r["max_abs_err"] for r in mine),
                "ms": head["ms"], "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                "library_ms": head["library_ms"], "key_widths": widths(name)}

    return [row(name, results["selection" if "topk" in name else "readout"])
            for name in REPLACES] + [large_k_row(name) for name in LARGE_K_LINE]


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        from eva_vos_tpu_torch.kernels import build
    except ImportError:
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"[card] {card}", flush=True)
    t0 = time.perf_counter()
    build_s = build.build_all()
    print(f"[build] {build_s} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name in build.LIBRARIES:
        for line in build.ptxas_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas] {name}: {line.strip()}")
    hmma = {}
    scored = {SOURCES[k].removesuffix(".cu") for k in SPLIT_KERNELS}
    for name in (x for x in build.LIBRARIES if build.source(x) in scored):
        hmma[name] = hmma_count(build, name)
        print(f"[sass] {name}: " + (
            "cuobjdump not found" if hmma[name] is None else
            f"{hmma[name]} HMMA instructions (tensor-core scoring of bf16 "
            f"keys {'present' if hmma[name] else 'absent'})"), flush=True)
        if hmma[name] == 0:
            fail(f"{name}: no tensor-core instruction in its SASS")

    results = {"card": card, "build_s": build_s, "hmma": hmma}
    kernel_phases(torch, results)
    entry_launches = entry_phase(torch, results)
    launches, (engine, images, masks), (feats, pad) = engine_phase(
        torch, results, card)
    launches.update(entry_launches)
    step_phase(torch, results, card)
    launches.update(large_k_phase(torch, results, card, engine, feats, pad,
                                  images, masks))
    del feats
    width_phase(torch, results, card, images, masks)
    resize_phase(torch, results)
    policy_phase(torch, results, card, engine, images, masks)
    predictor = decision_sam_phase(torch, results, card, engine, images,
                                   masks)
    training_phase(torch, results, card, images, masks, predictor)
    cli_phase(torch, results, card, images, masks)
    parallel_phase(torch, results, card, engine, images, masks)

    kernels = kernels_line(results, launches)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(
        json.dumps(dict(results, kernels=kernels), indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-worker"]:
        sys.exit(parallel_worker(sys.argv[2:]))
    sys.exit(main())
