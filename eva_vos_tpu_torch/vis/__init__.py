"""Experiment results and debug overlays (counterpart of
``eva_vos_tpu/vis``): the eval CLI's CSVs read into time-vs-quality curves,
the greedy cross-video ranking, plots and SAM session overlays."""

from .vis_util import read_exp, rank_policy, PLOT_DATA, PLOT_DATA_ANNOTATIONS
from .overlays import (show_mask, show_mask_thickness, show_points, show_box,
                       save_click_session)

__all__ = ["read_exp", "rank_policy", "PLOT_DATA", "PLOT_DATA_ANNOTATIONS",
           "show_mask", "show_mask_thickness", "show_points", "show_box",
           "save_click_session"]
