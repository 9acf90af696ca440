"""Result plots (a copy of ``eva_vos_tpu/vis/plots.py``; reference
``vis/frame_selection.py`` / ``full_pipeline.py``): J&F vs annotation
hours, log-x, with the 0.85 quality threshold line."""

from __future__ import annotations

import os

from .vis_util import read_exp, PLOT_DATA, PLOT_DATA_ANNOTATIONS

QUALITY_THRESHOLD = 0.85


def plot_experiments(exp_dir: str, out_path: str, policies: dict | None = None,
                     title: str = ""):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    policies = policies or {**PLOT_DATA, **PLOT_DATA_ANNOTATIONS}
    plt.figure(figsize=(7, 5))
    for name, style in policies.items():
        path = os.path.join(exp_dir, f"{name}.csv")
        if not os.path.exists(path):
            continue
        hours, quality = read_exp(path)
        label = style[2] if len(style) > 2 else name
        plt.plot(hours, quality, color=style[0], linestyle=style[1],
                 label=label)
    plt.axhline(QUALITY_THRESHOLD, color="gray", linestyle=":",
                label=f"J&F = {QUALITY_THRESHOLD}")
    plt.xscale("log")
    plt.xlabel("Annotation time (hours)")
    plt.ylabel("J&F")
    plt.title(title)
    plt.legend()
    plt.tight_layout()
    plt.savefig(out_path, dpi=150)
    plt.close()
    return out_path


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--exp-dir", default="Experiments/MOSE")
    ap.add_argument("--out", default="Experiments/curves.png")
    args = ap.parse_args(argv)
    print(plot_experiments(args.exp_dir, args.out))


if __name__ == "__main__":
    main()
