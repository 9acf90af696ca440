"""The port's device click robot (``eva_vos_tpu_torch/ops/components.py``)
against the scipy robot and the JAX package's ``ops/components.py``, bit for
bit, on the cases of ``tests/test_components.py``: random masks, the
spiral, empty and full masks, the raster-first tie-break, snapping and the
middle click."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy import ndimage

from eva_vos_tpu.ops import components as jc
from eva_vos_tpu_torch.annotator.robots import ClickRobot, _largest_component_click
from eva_vos_tpu_torch.ops import components as pc
from test_torch_port_decision import one_thread  # noqa: F401

_EIGHT = np.ones((3, 3), int)
# one compile per shape for the JAX side
JX_LABELS = jax.jit(jc.label_components)
JX_LARGEST = jax.jit(jc.largest_component_stats)
JX_INTERACT = jax.jit(jc.click_robot_interact)
JX_MIDDLE = jax.jit(jc.middle_click)


def _blob_mask(rng, h, w, n_blobs=4, r=6):
    m = np.zeros((h, w), bool)
    for _ in range(n_blobs):
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        yy, xx = np.ogrid[:h, :w]
        rr = rng.integers(2, r)
        m |= (yy - cy) ** 2 + (xx - cx) ** 2 <= rr ** 2
    return m


def _spiral_mask(h, w):
    """One long serpentine component (many propagation steps)."""
    m = np.zeros((h, w), bool)
    for i in range(0, h, 4):
        m[i, :] = True
        if (i // 4) % 2 == 0:
            m[i:i + 5, w - 1] = True
        else:
            m[i:i + 5, 0] = True
    return m


def _ints(values):
    return [int(v) for v in values]


def _labels(m):
    return pc.label_components(torch.from_numpy(m)).numpy()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_labels_match_scipy_and_jax(seed):
    m = np.random.default_rng(seed).random((37, 53)) < 0.35
    lab = _labels(m)
    assert lab.dtype == np.int32
    np.testing.assert_array_equal(lab,
                                  np.asarray(JX_LABELS(jnp.asarray(m))))
    ref, num = ndimage.label(m, structure=_EIGHT)
    for c in range(1, num + 1):
        sel = ref == c
        assert (lab[sel] == np.flatnonzero(sel.ravel()).min()).all()
    assert (lab[~m] == pc.INF32).all()


def test_spiral_is_one_component():
    m = _spiral_mask(33, 41)
    lab = _labels(m)
    ref, num = ndimage.label(m, structure=_EIGHT)
    assert num == 1 and len(np.unique(lab[m])) == 1 and lab[m][0] == 0
    np.testing.assert_array_equal(lab,
                                  np.asarray(JX_LABELS(jnp.asarray(m))))


def test_empty_and_full():
    empty, full = np.zeros((8, 8), bool), np.ones((8, 8), bool)
    assert (_labels(empty) == pc.INF32).all()
    assert (_labels(full) == 0).all()
    assert _ints(pc.largest_component_stats(torch.from_numpy(empty))) == [0, 0, 0]
    assert _ints(pc.largest_component_stats(torch.from_numpy(full))) == [3, 3, 64]


@pytest.mark.parametrize("seed", list(range(8)))
def test_largest_component_matches_host_and_jax(seed):
    m = _blob_mask(np.random.default_rng(seed), 41, 59)
    cx, cy, size = _ints(pc.largest_component_stats(torch.from_numpy(m)))
    click, ref_size = _largest_component_click(m)
    assert size == ref_size
    if click is not None:
        assert (cx, cy) == click
    assert [cx, cy, size] == _ints(JX_LARGEST(jnp.asarray(m)))


def test_tie_break_raster_first():
    m = np.zeros((10, 20), bool)
    m[5:7, 10:12] = True    # 4 px, raster-second
    m[1:3, 2:4] = True      # 4 px, raster-first: kept
    assert _ints(pc.largest_component_stats(torch.from_numpy(m))) == [2, 1, 4]


@pytest.mark.parametrize("seed", list(range(10)))
def test_interact_matches_host_robot_and_jax(seed):
    rng = np.random.default_rng(100 + seed)
    gt = _blob_mask(rng, 43, 61, n_blobs=2)
    pred = _blob_mask(rng, 43, 61, n_blobs=3)
    if not gt.any():
        gt[20:25, 30:36] = True
    got = _ints(pc.click_robot_interact(torch.from_numpy(pred),
                                        torch.from_numpy(gt)))
    ref_clicks, ref_labels = ClickRobot().interact(pred, gt)
    assert got == [*ref_clicks[0], ref_labels[0]]
    assert got == _ints(JX_INTERACT(jnp.asarray(pred),
                                     jnp.asarray(gt)))


def test_perfect_prediction_falls_back_to_middle():
    gt = _blob_mask(np.random.default_rng(7), 31, 37, n_blobs=1)
    if not gt.any():
        gt[10:20, 10:20] = True
    got = _ints(pc.click_robot_interact(torch.from_numpy(gt),
                                        torch.from_numpy(gt)))
    ref_clicks, ref_labels = ClickRobot().interact(gt, gt)
    assert got == [*ref_clicks[0], ref_labels[0]]


@pytest.mark.parametrize("seed", list(range(6)))
def test_middle_click_matches_host_and_jax(seed):
    gt = _blob_mask(np.random.default_rng(200 + seed), 29, 47, n_blobs=2)
    if not gt.any():
        gt[5:9, 7:13] = True
    got = _ints(pc.middle_click(torch.from_numpy(gt)))
    ref_clicks, _ = ClickRobot().middle_click(gt)
    assert got == list(ref_clicks[0])
    assert got == _ints(JX_MIDDLE(jnp.asarray(gt)))


def test_snap_row_major_tie():
    m = np.zeros((9, 9), bool)
    m[2, 4] = m[6, 4] = m[4, 2] = m[4, 6] = True   # all at distance 2
    assert _ints(pc.snap_to_mask(4, 4, torch.from_numpy(m))) == [4, 2]
    m[4, 4] = True                                 # inside: unchanged
    assert _ints(pc.snap_to_mask(4, 4, torch.from_numpy(m))) == [4, 4]
