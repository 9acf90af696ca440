"""The port's experiment readers (``eva_vos_tpu_torch.vis``, on the ``csv``
module and numpy) against the JAX package's (pandas), on the CPU.

The CSVs are the JAX CLI's own, written in a module fixture: oracle_mask
and rand_rand (the per-round curve), oracle_oracle and eva_vos (the greedy
ranking), on three synthetic videos with a small random JAX engine
(resnet18 / resnet18, top_k 8), the fake SAM and numpy stand-ins for QNet
and the agent.  Both readers must give the same curves; the sums and means
may differ in the last bits (pandas' groupby sums, and its default float
parser, round otherwise), so they are held to a relative 1e-12.  The JAX
ranking walks a ``set`` of videos, the port's walks them in file order:
each CSV is checked to hold no tie that the order decides.
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

from eva_vos_tpu import vis as jvis
from eva_vos_tpu.annotator import Annotator as JxAnnotator
from eva_vos_tpu.annotator import FakeSAMController as JxFakeSAM
from eva_vos_tpu.cli import eval_annotation_method as jcli
from eva_vos_tpu.engine.propagation import EngineConfig as JxConfig
from eva_vos_tpu.engine.propagation import InferenceEngine as JxEngine
from eva_vos_tpu.models import FusionNet as JxFusion
from eva_vos_tpu.models import PropagationNetwork as JxSTCN
from eva_vos_tpu.utils import load_report as jreport
from eva_vos_tpu_torch import vis
from eva_vos_tpu_torch.utils.table import read_columns
from test_torch_port_interactions import _jx_qnet
from test_torch_port_models import _init

H, W = 64, 96
RTOL = 1e-12
POLICIES = {
    "oracle_mask": [],
    "rand_rand": ["--fake-sam"],
    "oracle_oracle": ["--fake-sam"],
    "eva_vos": ["--fake-sam"],
}


class _Agent:
    """Alternates '3clicks' and 'mask'; values the mask's foreground."""

    def act_fn(self):
        calls = []

        def act(emb, mask224):
            calls.append(1)
            return len(calls) % 2, float(np.asarray(mask224).mean())
        return act


@pytest.fixture(scope="module")
def exp_dir(tmp_path_factory):
    """Experiments/MOSE/<policy>.csv from the JAX CLI, 3 videos x 4
    rounds each."""
    out = tmp_path_factory.mktemp("exp")
    rng = np.random.default_rng(51)
    jstcn = JxSTCN(key_arch="resnet18", value_arch="resnet18", top_k=8)
    sp = _init(jstcn, rng, jnp.zeros((H, W, 3)), jnp.zeros((1, H, W)),
               method="init_all")
    jfusion = JxFusion()
    fp = _init(jfusion, rng, jnp.zeros((H, W, 3)), jnp.zeros((H, W)),
               jnp.zeros((H, W)), jnp.zeros((H, W, 2)), jnp.zeros((2,)))
    engine = JxEngine(jstcn, jfusion, sp, fp,
                      JxConfig(top_k=8, max_interactions=6))

    def build(args):
        jreport.record("fusion", True)
        return {"engine": engine, "qnet_extract": _jx_qnet,
                "rl_agent": _Agent(), "annotator": JxAnnotator(JxFakeSAM())}

    mp = pytest.MonkeyPatch()
    mp.setattr(jcli, "build_models", build)
    try:
        for policy, extra in POLICIES.items():
            jcli.main(["--policy", policy, "--synthetic", "3", "--rounds",
                       "4", "--allow-random", "--metric", "j", "--top-k",
                       "8", "--out-dir", str(out)] + extra)
    finally:
        mp.undo()
    return out / "MOSE"


def _csv(exp_dir, policy):
    return str(next(exp_dir.glob(f"{policy}*.csv")))


def _assert_curves(got, want):
    hours, quality = got
    jhours, jquality = want
    assert len(hours) == len(quality) == len(jhours) == len(jquality) > 1
    np.testing.assert_allclose(hours, jhours, rtol=RTOL, atol=0)
    np.testing.assert_allclose(quality, jquality, rtol=RTOL, atol=0)
    return hours, quality


@pytest.mark.parametrize("policy", list(POLICIES))
def test_read_exp_matches_jax(exp_dir, policy):
    path = _csv(exp_dir, policy)
    hours, quality = _assert_curves(vis.read_exp(path), jvis.read_exp(path))
    assert np.all(np.isfinite(hours)) and np.all(np.isfinite(quality))
    assert np.all(np.diff(hours) > 0)
    if policy in ("oracle_mask", "rand_rand"):
        assert isinstance(quality, np.ndarray) and len(quality) == 4


def _reversed_videos(table):
    """The table with its videos' row blocks in the opposite order."""
    videos = list(dict.fromkeys(table["video"]))[::-1]
    order = [i for v in videos for i, w in enumerate(table["video"])
             if w == v]
    return {k: [col[i] for i in order] for k, col in table.items()}


@pytest.mark.parametrize("policy,rl_agent", [("oracle_oracle", False),
                                             ("eva_vos", True)])
@pytest.mark.parametrize("gamma", [0.6, 0.9])
def test_rank_policy_matches_jax(exp_dir, policy, rl_agent, gamma):
    path = _csv(exp_dir, policy)
    table = read_columns(path)
    got = vis.rank_policy(table, gamma=gamma, rl_agent=rl_agent)
    _assert_curves(got, jvis.rank_policy(pd.read_csv(path), gamma=gamma,
                                         rl_agent=rl_agent))
    # no tie that the walk's order decides: the other order, same curve
    _assert_curves(vis.rank_policy(_reversed_videos(table), gamma=gamma,
                                   rl_agent=rl_agent), got)
    # 3 videos x 4 rounds: the start, then each video's pointer walks up
    # to its last round but one
    assert len(got[1]) == 1 + 3 * 2


def test_hand_made_tables_match_jax(tmp_path):
    """``tests/test_vis.py``'s tables, written by pandas."""
    simple = tmp_path / "rand_mask.csv"
    pd.DataFrame({"video": ["a", "a", "b", "b"],
                  "mu_metric": [0.5, 0.7, 0.4, 0.6],
                  "annotation_time": [80, 80, 80, 3],
                  "round": [0, 1, 0, 1]}).to_csv(simple, index=False)
    hours, metric = _assert_curves(vis.read_exp(str(simple)),
                                   jvis.read_exp(str(simple)))
    np.testing.assert_allclose(metric, [0.45, 0.65])
    np.testing.assert_allclose(hours, [160 / 3600, 243 / 3600])

    rows = []
    for vid, qualities in [("a", [[0.2, 0.4], [0.9, 0.4], [0.9, 0.95]]),
                           ("b", [[0.3, 0.3], [0.5, 0.6], [0.9, 0.9]])]:
        for r, q in enumerate(qualities):
            rows.append({"video": vid, "mu_metric": float(np.mean(q)),
                         "annotation_time": 80, "round": r,
                         "round_metrics": str(q), "annotated_frames": r % 2,
                         "annotation_actions": "mask",
                         "rl_values": 0.1 * (r + 1) + (vid == "b") * 0.05})
    for name, rl in (("oracle_oracle.csv", False), ("eva_vos.csv", True)):
        path = tmp_path / name
        pd.DataFrame(rows).to_csv(path, index=False)
        _, points = _assert_curves(vis.read_exp(str(path)),
                                   jvis.read_exp(str(path)))
        # the first greedy step: b (a larger rl value; oracle: 0.3 / 80
        # against a's 0)
        assert points[1] == pytest.approx((0.3 + 0.55) / 2)


def test_rank_policy_breaks_ties_in_file_order(tmp_path):
    """Equal rewards: the video of the earlier rows goes first (the JAX
    function takes the first of its set, which string hashing orders)."""
    rows = [{"video": vid, "mu_metric": mu, "annotation_time": 80,
             "round": r, "round_metrics": "[0.5, 0.5]",
             "annotated_frames": 0, "rl_values": 0.1}
            for vid, mus in (("a", [0.2, 0.6, 0.7]), ("b", [0.4, 0.5, 0.9]))
            for r, mu in enumerate(mus)]
    path = tmp_path / "eva_vos.csv"
    pd.DataFrame(rows).to_csv(path, index=False)
    _, points = vis.read_exp(str(path))
    assert points[:2] == [pytest.approx(0.3), pytest.approx((0.6 + 0.4) / 2)]
    _, points = vis.rank_policy(_reversed_videos(read_columns(path)),
                                rl_agent=True)
    assert points[1] == pytest.approx((0.2 + 0.5) / 2)


def test_plots_and_overlays_render(exp_dir, tmp_path):
    """The curves' figure over the JAX CLI's CSVs, and the annotator's
    debug overlays (matplotlib, where it is installed)."""
    pytest.importorskip("matplotlib")
    from eva_vos_tpu_torch.vis import plots

    out = plots.plot_experiments(
        str(exp_dir), str(tmp_path / "curves.png"),
        policies={"oracle_mask": ["black", "-"],
                  "eva_vos": ["red", "--", "EVA-VOS"]})
    assert (tmp_path / "curves.png").stat().st_size > 0
    assert out == str(tmp_path / "curves.png")

    h, w = 32, 48
    mask = np.zeros((h, w))
    mask[8:20, 10:30] = 1
    img = np.random.default_rng(0).random((h, w, 3))
    session = tmp_path / "session.png"
    vis.save_click_session(img, mask, str(session),
                           coords=np.array([[12.0, 9.0], [40.0, 28.0]]),
                           labels=np.array([1, 0]), box=[10, 8, 30, 20],
                           gt_mask=mask, title="round 3")
    assert session.stat().st_size > 0
