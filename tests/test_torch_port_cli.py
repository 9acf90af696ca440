"""The port's main experiment CLI (``eva_vos_tpu_torch.cli.
eval_annotation_method``) against the JAX CLI, on the CPU.

Both CLIs' ``build_models`` are replaced by models that share one random
JAX tree each, carried across with the port's converters: a resnet18 /
resnet18 STCN (top_k 8) with FusionNet, a resnet18 QNet and a resnet18
ActorCritic on the fake SAM's 256-channel embedding.  Both agents act by
the argmax of their logits (their sampled actions differ by design); the
ActorCritic's tree is one whose argmax chooses both annotation types on
these videos, so eva_vos takes the SAM path.  Each
JAX engine is built once per engine configuration and kept for the module
(its jit caches are per engine).  The videos are ``--synthetic`` (6x64x96)
or a DAVIS tree of the same size.

Held: the CSV's header, and per row the video, round, annotation time,
weights marker, frame and action exactly, the metrics (``mu_metric``,
``round_metrics``, ``rl_values``) within the interactions tests'
METRIC_ATOL; the port's text equals pandas' for the same values.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

from eva_vos_tpu.annotator import Annotator as JxAnnotator
from eva_vos_tpu.annotator import FakeSAMController as JxFakeSAM
from eva_vos_tpu.cli import eval_annotation_method as jcli
from eva_vos_tpu.engine.propagation import EngineConfig as JxConfig
from eva_vos_tpu.engine.propagation import InferenceEngine as JxEngine
from eva_vos_tpu.models import FusionNet as JxFusion
from eva_vos_tpu.models import PropagationNetwork as JxSTCN
from eva_vos_tpu.models.qnet import QualityNet as JxQNet
from eva_vos_tpu.models.rl_agent import ActorCritic as JxActorCritic
from eva_vos_tpu.train.ppo.agent import PPOAgent as JxPPOAgent
from eva_vos_tpu.utils import load_report as jreport
from eva_vos_tpu_torch.annotator import Annotator, FakeSAMController
from eva_vos_tpu_torch.cli import eval_annotation_method as cli
from eva_vos_tpu_torch.data._png import write_png
from eva_vos_tpu_torch.data import synthetic_video
from eva_vos_tpu_torch.engine import EngineConfig, InferenceEngine
from eva_vos_tpu_torch.models import FusionNet, PropagationNetwork, QualityNet
from eva_vos_tpu_torch.train.ppo import PPOAgent
from eva_vos_tpu_torch.utils import (actor_critic_state_dict_from_flax,
                                     fusion_state_dict_from_flax, load_report,
                                     qnet_state_dict_from_flax,
                                     stcn_state_dict_from_flax)
from eva_vos_tpu_torch.utils.table import read_columns, write_columns
from test_torch_port_decision import one_thread  # noqa: F401
from test_torch_port_interactions import METRIC_ATOL
from test_torch_port_models import _init

H, W = 64, 96           # the CLI's --synthetic frames (6 of them)
ROUNDS = "3"
EXACT = ("video", "round", "annotation_time", "weights", "annotated_frames",
         "annotation_actions")
METRICS = ("mu_metric", "rl_values")


class _ArgmaxAgent:
    """The CLI's ``rl_agent`` (``act_fn``), acting by the argmax of a
    ``return_logits`` agent's logits."""

    def __init__(self, agent):
        self.agent = agent

    def act_fn(self):
        def act(emb, mask224):
            logits, value = self.agent.act(emb, mask224)
            return (int(np.argmax(logits[0])),
                    float(np.asarray(value).reshape(-1)[0]))
        return act


@pytest.fixture(scope="module")
def models():
    """side -> a ``build_models(args)`` for that CLI, on shared weights."""
    rng = np.random.default_rng(41)
    jstcn = JxSTCN(key_arch="resnet18", value_arch="resnet18", top_k=8)
    sp = _init(jstcn, rng, jnp.zeros((H, W, 3)), jnp.zeros((1, H, W)),
               method="init_all")
    jfusion = JxFusion()
    fp = _init(jfusion, rng, jnp.zeros((H, W, 3)), jnp.zeros((H, W)),
               jnp.zeros((H, W)), jnp.zeros((H, W, 2)), jnp.zeros((2,)))
    stcn = PropagationNetwork(key_arch="resnet18", value_arch="resnet18")
    stcn.load_state_dict(stcn_state_dict_from_flax(sp, "resnet18",
                                                   "resnet18"), strict=True)
    fusion = FusionNet()
    fusion.load_state_dict(fusion_state_dict_from_flax(fp), strict=True)

    x = jnp.zeros((1, 32, 32, 3))
    jq = JxQNet(arch="resnet18")
    qv = _init(jq, np.random.default_rng(42), x, x)
    qnet = QualityNet(arch="resnet18")
    qnet.load_state_dict(qnet_state_dict_from_flax(qv), strict=True)
    qnet.eval()
    jextract = jax.jit(lambda i, m: jq.apply(qv, i, m,
                                             method="extract_features"))
    av = _init(JxActorCritic(out_dim=2, arch="resnet18", dropout=0.0),
               np.random.default_rng(48), jnp.zeros((1, 64, 64, 256)),
               jnp.zeros((1, 64, 64, 3)))
    jagent = _ArgmaxAgent(JxPPOAgent(2, "resnet18", av, return_logits=True))
    agent = _ArgmaxAgent(PPOAgent(2, "resnet18",
                                  actor_critic_state_dict_from_flax(av),
                                  return_logits=True, device="cpu"))
    jengines = {}

    def jax_models(args):
        key = (args.mem_freq, args.top_k, args.rounds)
        if key not in jengines:
            jengines[key] = JxEngine(jstcn, jfusion, sp, fp, JxConfig(
                mem_freq=args.mem_freq, top_k=args.top_k,
                max_interactions=args.rounds + 2))
        return {"engine": jengines[key], "qnet_extract": jextract,
                "rl_agent": jagent, "annotator": JxAnnotator(JxFakeSAM())}

    def port_models(args):
        engine = InferenceEngine(stcn, fusion, EngineConfig(
            mem_freq=args.mem_freq, top_k=args.top_k,
            max_interactions=args.rounds + 2), device=args.device)
        return {"engine": engine, "qnet_extract": qnet.extract_features,
                "rl_agent": agent,
                "annotator": Annotator(FakeSAMController())}

    return {"jax": jax_models, "port": port_models}


def _run(side, models, monkeypatch, argv):
    """One CLI's ``main(argv)`` on ``models[side]``, random-weights marked
    as a random-init run is (``fusion``, like the tiny STCN runs)."""
    module = jcli if side == "jax" else cli
    report = jreport if side == "jax" else load_report

    def build(args):
        report.record("fusion", True)
        return models[side](args)

    monkeypatch.setattr(module, "build_models", build)
    extra = ["--device", "cpu"] if side == "port" else []
    return module.main(argv + extra)


def _assert_same_csv(ours, ref):
    """Header and cells: EXACT columns as text, METRICS and round_metrics
    within METRIC_ATOL.  Returns the two tables."""
    got, want = read_columns(ours), read_columns(ref)
    with open(ours) as a, open(ref) as b:
        assert a.readline() == b.readline()
    assert len(got["video"]) == len(want["video"]) > 0
    for col in want:
        if col in EXACT:
            assert got[col] == want[col], col
        elif col in METRICS:
            np.testing.assert_allclose(got[col], want[col], rtol=0,
                                       atol=METRIC_ATOL, err_msg=col)
        else:
            assert col == "round_metrics"
            for g, w in zip(got[col], want[col]):
                np.testing.assert_allclose(eval(g), eval(w), rtol=0,
                                           atol=METRIC_ATOL)
    return got, want


def _assert_pandas_text(path):
    """The file's values, written again by ``write_columns``, are its text
    byte for byte (on the JAX CLI's file: the port writes pandas' text for
    the same values), and pandas reads the same values from it (its
    default float parser may miss by an ulp)."""
    table = read_columns(path)
    again = path.parent / f"{path.stem}.again.csv"
    write_columns(again, table)
    assert again.read_bytes() == path.read_bytes()
    df = pd.read_csv(path)
    assert list(df.columns) == list(table)
    for col in table:
        if col in METRICS + ("annotation_time",):
            np.testing.assert_allclose(df[col].to_numpy(), table[col],
                                       rtol=1e-15, atol=0)
        else:
            assert df[col].tolist() == table[col], col


@pytest.mark.parametrize("policy,extra", [
    ("oracle_mask", []),
    ("rand_rand", ["--fake-sam", "--metric", "j"]),
    ("eva_vos", ["--fake-sam", "--metric", "j"]),
])
def test_main_matches_jax(policy, extra, models, monkeypatch, tmp_path):
    argv = ["--policy", policy, "--synthetic", "2", "--rounds", ROUNDS,
            "--allow-random", "--top-k", "8"] + extra
    ref = _run("jax", models, monkeypatch,
               argv + ["--out-dir", str(tmp_path / "jax")])
    ours = _run("port", models, monkeypatch,
                argv + ["--out-dir", str(tmp_path / "port")])
    assert Path(ours).relative_to(tmp_path / "port") == \
        Path(ref).relative_to(tmp_path / "jax")
    got, want = _assert_same_csv(ours, ref)
    assert set(got["video"]) == {"synthetic_0__1", "synthetic_1__1"}
    assert set(got["weights"]) == {"RANDOM_WEIGHTS"}
    if policy == "eva_vos":
        assert got["rl_values"][0] == -2.0
        # the agent chose the fake SAM's clicks too: the SAM path ran
        assert set(got["annotation_actions"]) == {"mask", "3clicks"}
    _assert_pandas_text(Path(ref))
    _assert_pandas_text(Path(ours))


def test_resume_skips_done_videos(models, monkeypatch, tmp_path):
    """``tests/test_cli.py``'s resume check on both CLIs: video 0's rows
    stay (the port's byte for byte), video 1 is appended."""
    paths = {}
    for side in ("jax", "port"):
        argv = ["--policy", "oracle_mask", "--rounds", ROUNDS,
                "--allow-random", "--metric", "j", "--top-k", "8",
                "--out-dir", str(tmp_path / side), "--resume"]
        first = _run(side, models, monkeypatch, argv + ["--synthetic", "1"])
        before = open(first).read()
        paths[side] = _run(side, models, monkeypatch,
                           argv + ["--synthetic", "2"])
        after = open(paths[side]).read()
        if side == "port":
            assert after.startswith(before)
        assert set(read_columns(paths[side])["video"]) == \
            {"synthetic_0__1", "synthetic_1__1"}
    _assert_same_csv(paths["port"], paths["jax"])
    # a third run finds every video done: the file stays as it is
    text = open(paths["port"], "rb").read()
    _run("port", models, monkeypatch,
         ["--policy", "oracle_mask", "--rounds", ROUNDS, "--allow-random",
          "--metric", "j", "--top-k", "8", "--out-dir",
          str(tmp_path / "port"), "--resume", "--synthetic", "2"])
    assert open(paths["port"], "rb").read() == text


@pytest.fixture(scope="module")
def davis_root(tmp_path_factory):
    """A DAVIS_17 tree of three one-object videos, 6x64x96: PNG bytes under
    the frames' ``.jpg`` names, palette annotations, ``2017/val.txt``."""
    root = tmp_path_factory.mktemp("data")
    db = root / "DAVIS_17"
    names = ["bear", "car", "dog"]
    for seed, name in enumerate(names):
        images, masks = synthetic_video(6, H, W, num_objects=1, seed=seed)
        (db / "JPEGImages" / "480p" / name).mkdir(parents=True)
        (db / "Annotations" / "480p" / name).mkdir(parents=True)
        for f in range(6):
            write_png(db / "JPEGImages" / "480p" / name / f"{f:05d}.jpg",
                      np.rint(images[f] * 255).astype(np.uint8))
            write_png(db / "Annotations" / "480p" / name / f"{f:05d}.png",
                      masks[0, f].astype(np.uint8),
                      palette=[[0, 0, 0], [128, 0, 0]])
    (db / "ImageSets" / "2017").mkdir(parents=True)
    (db / "ImageSets" / "2017" / "val.txt").write_text("\n".join(names))
    return root


def test_multihost_single_process_takes_the_whole_tree(
        models, monkeypatch, tmp_path, davis_root):
    """``--multihost`` with EVAVOS_NUM_PROCESSES unset: one process, the
    whole tree, the run's own file name, the JAX CLI's rows."""
    monkeypatch.setenv("EVAVOS_DATA_ROOT", str(davis_root))
    monkeypatch.delenv("EVAVOS_NUM_PROCESSES", raising=False)
    argv = ["--policy", "oracle_mask", "--db", "DAVIS_17", "--rounds",
            ROUNDS, "--allow-random", "--metric", "j", "--top-k", "8",
            "--multihost"]
    ref = _run("jax", models, monkeypatch,
               argv + ["--out-dir", str(tmp_path / "jax")])
    ours = _run("port", models, monkeypatch,
                argv + ["--out-dir", str(tmp_path / "port")])
    assert ours == str(tmp_path / "port" / "DAVIS_17" / "oracle_mask.csv")
    got, _ = _assert_same_csv(ours, ref)
    assert sorted(set(got["video"])) == ["bear__1", "car__1", "dog__1"]


@pytest.mark.parametrize("rank", [0, 1])
def test_multihost_shards_match_jax(rank, monkeypatch, davis_root):
    """Two processes' shards of the three samples, as each CLI derives
    them: the same samples, the JAX overlap included (``max_idx`` is read
    inclusively, so both shards hold sample 2)."""
    from eva_vos_tpu import parallel as jparallel
    from eva_vos_tpu_torch import parallel

    monkeypatch.setenv("EVAVOS_DATA_ROOT", str(davis_root))
    jx_shard_range = jparallel.host_shard_range
    monkeypatch.setattr(jparallel, "host_shard_range",
                        lambda n: jx_shard_range(n, rank, 2))
    monkeypatch.setattr(parallel, "host_shard_range",
                        lambda n: parallel.mesh.host_shard_range(n, rank, 2))
    argv = ["--db", "DAVIS_17", "--multihost"]
    jargs = jcli.build_parser().parse_args(argv)
    args = cli.build_parser().parse_args(argv)
    want = [s.name for s in jcli.iter_samples(jargs)]
    got = [s.name for s in cli.iter_samples(args)]
    assert got == want == [["bear__1", "car__1", "dog__1"],
                           ["dog__1"]][rank]
    assert (args.min_idx, args.max_idx) == (jargs.min_idx, jargs.max_idx)


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices,
                     a.nargs, type(a).__name__)
            for a in parser._actions if a.dest != "help"}


def test_parsers_take_the_jax_flags_and_device():
    ours, ref = _options(cli.build_parser()), _options(jcli.build_parser())
    assert ours.pop("device") == (("--device",), "cuda", None, None, None,
                                  "_StoreAction")
    assert ours == ref


@pytest.mark.parametrize("argv,want", [
    (["--policy", "oracle_oracle", "--types", "3clicks", "mask"],
     "oracle_oracle_3clicks_mask"),
    (["--policy", "rand_type", "--types", "scribble"], AttributeError),
    (["--policy", "rand_mask", "--min-idx", "0", "--max-idx", "9"],
     "rand_maskfrom_0_to_9"),
    (["--policy", "l2_mask", "--encoder", "dino_large"],
     "l2_mask_dino_large"),
    (["--policy", "rand_rand", "--types", "mask", "click", "bbox", "5clicks"],
     "rand_rand_5clicks_bbox_click_mask"),
    (["--policy", "eva_vos", "--min-idx", "3"], "eva_vos"),
])
def test_policy_string_matches_jax(argv, want):
    args = cli.build_parser().parse_args(argv)
    jargs = jcli.build_parser().parse_args(argv)
    if want is AttributeError:
        for module, a in ((cli, args), (jcli, jargs)):
            with pytest.raises(AttributeError):
                module.policy_string(a)
        return
    assert cli.policy_string(args) == jcli.policy_string(jargs) == want


def test_bad_arguments_raise():
    with pytest.raises(AttributeError, match="invalid"):
        cli.main(["--policy", "nope", "--device", "cpu"])
    with pytest.raises(ValueError, match="round"):
        cli.main(["--rounds", "0", "--device", "cpu"])


def test_csv_text_is_pandas(tmp_path):
    """``utils.table`` against pandas on the CLI's kinds of columns:
    strings, ints, floats (ints among them written as floats, NaN as an
    empty cell) and lists; read back to the same types."""
    cols = {"video": ["a__1", "a__1", "b__1"],
            "mu_metric": [0.1, 0.1 + 0.2, 1 / 3],
            "annotation_time": [80.0, 5.5, 3],
            "round": [0, 1, 0],
            "rl_values": [-2, 0.5, float("nan")],
            "round_metrics": [[1.0, 0.25], [0.5, 20], [1.0]],
            "annotated_frames": [0, 5, -1],
            "annotation_actions": ["mask", "3clicks", "mask"]}
    write_columns(tmp_path / "port.csv", cols)
    pd.DataFrame.from_dict(cols).to_csv(tmp_path / "pd.csv", index=False)
    assert (tmp_path / "port.csv").read_bytes() == \
        (tmp_path / "pd.csv").read_bytes()
    back = read_columns(tmp_path / "port.csv")
    assert back["round"] == [0, 1, 0] and back["annotated_frames"][2] == -1
    assert back["mu_metric"] == cols["mu_metric"]
    assert back["annotation_time"] == [80.0, 5.5, 3.0]
    assert back["rl_values"][:2] == [-2.0, 0.5]
    assert np.isnan(back["rl_values"][2])
    assert back["round_metrics"] == [str(v) for v in cols["round_metrics"]]
    with pytest.raises(ValueError, match="lengths"):
        write_columns(tmp_path / "bad.csv", {"a": [1], "b": [1, 2]})


def test_cli_runs_on_the_port_models_by_default(monkeypatch, tmp_path):
    """Without the test's models: the CLI's own ``build_models`` (tiny
    STCN, the model zoo's random weights) on one synthetic video."""
    monkeypatch.setenv("EVAVOS_TINY", "1")
    monkeypatch.setenv("EVAVOS_WEIGHTS_ROOT", str(tmp_path / "none"))
    path = cli.main(["--policy", "oracle_oracle", "--synthetic", "1",
                     "--rounds", "2", "--fake-sam", "--allow-random",
                     "--top-k", "8", "--metric", "j", "--out-dir",
                     str(tmp_path), "--device", "cpu", "--timers"])
    table = read_columns(path)
    assert list(table) == ["video", "mu_metric", "annotation_time", "round",
                           "weights", "round_metrics", "annotated_frames",
                           "annotation_actions"]
    assert table["round"] == [0, 1] and table["annotation_actions"][0] == \
        "mask"
    assert set(table["weights"]) == {"RANDOM_WEIGHTS"}
    assert all(len(eval(m)) == 6 for m in table["round_metrics"])
