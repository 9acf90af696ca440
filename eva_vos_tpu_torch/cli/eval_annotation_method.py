"""Main experiment CLI: run an annotation policy over a dataset split
(counterpart of ``eva_vos_tpu/cli/eval_annotation_method.py``).

Behavior parity target: ``eval_annotation_method.py`` in the reference —
same flags (--rounds/--policy/--db/--encoder/--min-idx/--max-idx/--types),
same policy set, same CSV schema and output naming
(``Experiments/<db>/<policy_str>.csv``).  The JAX CLI's flags keep their
names and defaults; ``--device`` (default ``cuda``) is the port's.  The CSV
goes through ``utils.table``, in the text pandas writes for the JAX CLI.

With ``--multihost`` and no ``--min-idx/--max-idx``, each process of a
``torch.distributed`` group (``EVAVOS_COORDINATOR`` /
``EVAVOS_NUM_PROCESSES`` / ``EVAVOS_PROCESS_ID``) takes its shard of the
samples.  As in the JAX CLI, the shard's ``max_idx`` is read inclusively
(neighbouring shards share one sample), and every process writes the file
name of the whole run.

Usage:
    python -m eva_vos_tpu_torch.cli.eval_annotation_method --policy eva_vos \
        --db MOSE --rounds 60
"""

from __future__ import annotations

import argparse
import os
import re
import time

import numpy as np
import torch

from ..annotator import Annotator
from ..engine import InferenceEngine
from ..engine.propagation import EngineConfig
from ..interactions import (
    qnet_mask, rand_mask, oracle_mask, l2_mask, upper_bound_mask,
    oracle_oracle, rand_type, rand_rand, eva_vos,
)
from ..utils.paths import DataPaths
from ..utils.profiling import TRACE, device_trace
from ..utils.seeding import seed_everything
from ..utils.table import read_columns, write_columns

POLICIES = {"qnet_mask", "rand_mask", "oracle_mask", "l2_mask",
            "upper_bound_mask", "oracle_oracle", "rand_type", "rand_rand",
            "eva_vos"}


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--rounds", type=int, default=60)
    p.add_argument("--policy", default="eva_vos")
    p.add_argument("--db", type=str, default="MOSE",
                   choices=["MOSE", "DAVIS_17"])
    p.add_argument("--encoder", type=str, default="resnet50",
                   help="Only used with l2_mask policy")
    p.add_argument("--min-idx", type=int)
    p.add_argument("--max-idx", type=int)
    p.add_argument("--multihost", action="store_true",
                   help="multi-process experiment sharding: join a "
                        "torch.distributed group (EVAVOS_COORDINATOR / "
                        "EVAVOS_NUM_PROCESSES / EVAVOS_PROCESS_ID env; nccl "
                        "on a CUDA --device, gloo on the CPU) and derive "
                        "this process's --min-idx/--max-idx sample shard")
    p.add_argument("--types", nargs="+", default=["3clicks", "mask"])
    p.add_argument("--metric", default="j_and_f", choices=["j", "j_and_f"])
    p.add_argument("--dtype", default="f32", choices=["f32", "bf16"])
    p.add_argument("--top-k", type=int, default=50,
                   help="memory tokens a query reads; on CUDA every read "
                        "(EVAVOS_SEL_METHOD / EVAVOS_READOUT_METHOD too) "
                        "takes any top_k, above 256 on the large-k kernels "
                        "(above the bank's tokens it reads them all)")
    p.add_argument("--mem-freq", type=int, default=5)
    p.add_argument("--fake-sam", action="store_true",
                   help="use the FakeSAM simulator instead of SAM ViT-H")
    p.add_argument("--allow-random", action="store_true",
                   help="random-init models when checkpoints are missing")
    p.add_argument("--synthetic", type=int, default=0,
                   help="run on N synthetic videos instead of a dataset")
    p.add_argument("--out-dir", default="./Experiments")
    p.add_argument("--resume", action="store_true",
                   help="skip videos already present in the output CSV and "
                        "append (per-video restart safety for long runs)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the run here")
    p.add_argument("--timers", action="store_true",
                   help="print a per-phase wall-clock report per video, "
                        "and the process's spans and counters so far")
    p.add_argument("--device", default="cuda")
    return p


def build_models(args):
    with TRACE.span("models.build"):
        return _build_models(args)


def _build_models(args):
    from ..utils import model_zoo

    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    dev = args.device
    stcn = model_zoo.load_stcn(dtype=dtype, allow_random=args.allow_random,
                               device=dev)
    fusion = model_zoo.load_fusion(dtype=dtype,
                                   allow_random=args.allow_random, device=dev)
    engine = InferenceEngine(
        stcn, fusion,
        EngineConfig(mem_freq=args.mem_freq, top_k=args.top_k,
                     max_interactions=args.rounds + 2),
        device=dev)

    models = {"engine": engine}
    if args.policy in {"qnet_mask", "eva_vos"}:
        _, extract = model_zoo.load_qnet(allow_random=args.allow_random,
                                         device=dev)
        models["qnet_extract"] = extract
    if args.policy == "eva_vos":
        models["rl_agent"] = model_zoo.load_rl_agent(
            allow_random=args.allow_random, device=dev)
    if args.policy in {"eva_vos", "oracle_oracle", "rand_type", "rand_rand"}:
        sam = model_zoo.load_sam("fake" if args.fake_sam else "vit_h",
                                 dtype=dtype, allow_random=args.allow_random,
                                 device=dev)
        models["annotator"] = Annotator(sam)
    if args.policy == "l2_mask":
        from ..models.feature_extractors import build_feature_extractor

        models["encoder"] = build_feature_extractor(
            args.encoder, allow_random=args.allow_random, device=dev)
    return models


def policy_string(args):
    s = args.policy
    if args.policy == "l2_mask":
        s += f"_{args.encoder}"
    if args.policy in {"oracle_oracle", "rand_type", "rand_rand"}:
        for t in sorted(args.types):
            if t not in {"click", "bbox", "mask"} and \
                    not re.match(r"^\d+clicks$", t):
                raise AttributeError("Invalid annotation type")
            s += f"_{t}"
    if args.min_idx is not None and args.max_idx is not None:
        s += f"from_{args.min_idx}_to_{args.max_idx}"
    return s


def iter_samples(args):
    if args.synthetic:
        from ..data.datasets import make_synthetic_sample

        for i in range(args.synthetic):
            yield make_synthetic_sample(t=6, h=64, w=96, seed=i)
        return

    from ..data.datasets import AnnotationDataset

    root = DataPaths.db_root(args.db)
    if args.db == "MOSE":
        imset = root / "ImageSets" / "test.txt"
    else:
        imset = root / "ImageSets" / "2017" / "val.txt"
    if args.multihost and args.min_idx is None and args.max_idx is None:
        # this process's contiguous sample shard of the process group
        from ..parallel import host_shard_range

        full = AnnotationDataset(root, imset)
        args.min_idx, args.max_idx = host_shard_range(len(full))
    ds = AnnotationDataset(root, imset, min_idx=args.min_idx,
                           max_idx=args.max_idx)
    yield from ds


def dispatch(args, models, sample, rng):
    engine = models["engine"]
    m = args.metric
    if args.policy == "qnet_mask":
        return qnet_mask(models["qnet_extract"], args.rounds, engine, sample, m)
    if args.policy == "rand_mask":
        return rand_mask(args.rounds, engine, sample, m, rng=rng)
    if args.policy == "oracle_mask":
        return oracle_mask(args.rounds, engine, sample, m)
    if args.policy == "l2_mask":
        return l2_mask(models["encoder"], args.rounds, engine, sample, m)
    if args.policy == "upper_bound_mask":
        return upper_bound_mask(args.rounds, engine, sample, m)
    if args.policy == "oracle_oracle":
        return oracle_oracle(args.rounds, engine, sample,
                             models["annotator"], args.types, m)
    if args.policy == "rand_type":
        if len(args.types) != 1:
            raise ValueError("Only one annotation type for rand_type")
        return rand_type(args.rounds, engine, sample, models["annotator"],
                         args.types[0], m, rng=rng)
    if args.policy == "rand_rand":
        return rand_rand(args.rounds, engine, sample, models["annotator"],
                         args.types, m, rng=rng)
    if args.policy == "eva_vos":
        return eva_vos(models["qnet_extract"], models["rl_agent"].act_fn(),
                       args.rounds, engine, sample, models["annotator"],
                       eval_metric=m)
    raise AttributeError(f"Policy: {args.policy} is invalid!")


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.policy not in POLICIES:
        raise AttributeError(f"Policy: {args.policy} is invalid!")
    if args.rounds < 1:
        raise ValueError("At least one round is required")
    if args.multihost:
        from ..parallel import init_distributed

        # a no-op unless EVAVOS_NUM_PROCESSES > 1
        init_distributed(backend="nccl" if torch.device(args.device).type
                         == "cuda" else "gloo")
    seed_everything()
    rng = np.random.default_rng(29102910)

    from ..utils import load_report

    load_report.reset()
    models = build_models(args)
    pstr = policy_string(args)
    # loud degradation marker: a run with ANY random-initialized model can
    # never be mistaken for a real baseline (column on every row)
    weights_marker = load_report.weights_marker()
    if weights_marker == "RANDOM_WEIGHTS":
        print("[warn] RANDOM_WEIGHTS: some models are random-initialized; "
              f"report: {load_report.report()}")

    results = {"video": [], "mu_metric": [], "annotation_time": [],
               "round": [], "weights": []}
    if args.policy == "eva_vos":
        results.update({"rl_values": [], "round_metrics": [],
                        "annotated_frames": []})
    elif args.policy == "oracle_oracle":
        results.update({"round_metrics": [], "annotated_frames": []})
    if args.policy in {"oracle_oracle", "rand_type", "rand_rand", "eva_vos"}:
        results["annotation_actions"] = []

    out_dir = os.path.join(args.out_dir, args.db)
    csv_path = os.path.join(out_dir, f"{pstr}.csv")
    done_videos = set()
    if args.resume and os.path.exists(csv_path):
        prev = read_columns(csv_path)
        done_videos = set(prev["video"])
        for col in results:
            if col in prev:
                results[col] = prev[col]
        print(f"[resume] {len(done_videos)} videos already done")

    from ..interactions import eval as eval_mod

    t0 = time.time()
    n_videos = 0
    with device_trace(args.profile_dir):
        for sample in iter_samples(args):
            if sample.name in done_videos:
                continue
            out = dispatch(args, models, sample, rng)
            if args.policy == "eva_vos":
                mus, times, rl_values, actions, round_metrics, frames = out
                results["rl_values"].extend(rl_values)
                results["round_metrics"].extend(round_metrics)
                results["annotated_frames"].extend(frames)
                results["annotation_actions"].extend(actions)
            elif args.policy == "oracle_oracle":
                mus, times, actions, round_metrics, frames = out
                results["round_metrics"].extend(round_metrics)
                results["annotated_frames"].extend(frames)
                results["annotation_actions"].extend(actions)
            elif args.policy in {"rand_type", "rand_rand"}:
                mus, times, actions = out
                results["annotation_actions"].extend(actions)
            else:
                mus, times = out

            results["video"].extend([sample.name] * len(mus))
            results["weights"].extend([weights_marker] * len(mus))
            results["mu_metric"].extend(mus)
            results["annotation_time"].extend(times)
            results["round"].extend(range(len(mus)))
            n_videos += 1
            print(f"[{pstr}] {sample.name}: rounds={len(mus)} "
                  f"final={mus[-1] if mus else float('nan'):.4f} "
                  f"({time.time() - t0:.1f}s)")
            if args.timers and eval_mod.LAST_SESSION is not None:
                print(eval_mod.LAST_SESSION.timers.report())
                print("process (every video so far)")
                print(TRACE.report())
            if args.resume:  # incremental flush for restart safety
                os.makedirs(out_dir, exist_ok=True)
                write_columns(csv_path, results)

    os.makedirs(out_dir, exist_ok=True)
    write_columns(csv_path, results)
    print(f"[done] {n_videos} videos -> {csv_path}")
    return csv_path


if __name__ == "__main__":
    main()
