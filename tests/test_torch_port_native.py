"""The port's native click-robot library (``eva_vos_tpu_torch.native``)
against the JAX package's (``eva_vos_tpu.native``) and against scipy, on
``tests/test_native.py``'s cases, and the port's robots with
``EVAVOS_NATIVE`` set to 0 and to 1: equal outputs, exactly."""

import numpy as np
import pytest
from scipy import ndimage

from eva_vos_tpu import native as jx_native
from eva_vos_tpu_torch import native
from eva_vos_tpu_torch.annotator import robots
from eva_vos_tpu_torch.annotator.robots import ClickRobot

_EIGHT = np.ones((3, 3), dtype=int)


def scipy_largest_center(mask):
    labels, num = ndimage.label(mask, structure=_EIGHT)
    if num == 0:
        return None
    sizes = np.bincount(labels.ravel())[1:]
    biggest = int(np.argmax(sizes)) + 1
    ys, xs = np.nonzero(labels == biggest)
    return int(np.mean(xs)), int(np.mean(ys)), int(sizes.max())


def _masks():
    """test_native.py's masks: empty, a blob, a diagonal pair, two equal
    components, interleaved equal components, random masks."""
    out = {"empty": np.zeros((8, 8), bool)}
    m = np.zeros((20, 30), bool)
    m[4:10, 5:15] = True
    out["blob"] = m
    m = np.zeros((4, 4), bool)
    m[0, 0] = m[1, 1] = True
    out["diagonal"] = m
    m = np.zeros((10, 10), bool)
    m[0, 0:3] = True
    m[9, 7:10] = True
    out["size_tie"] = m
    m = np.zeros((10, 12), bool)
    m[0:5, 0] = True
    m[0, 5:10] = True
    out["interleaved_tie"] = m
    for seed in range(8):
        rng = np.random.default_rng(seed)
        out[f"random{seed}"] = rng.uniform(size=(64, 96)) > 0.72
    return out


MASKS = _masks()


def test_library_builds_outside_the_package():
    path = native.library_path()
    assert path.parent.name == ".kernel_build"
    assert native.available()
    assert native.load() is native.load()
    assert path.exists()


@pytest.mark.parametrize("name", list(MASKS))
def test_largest_component_matches_jax_and_scipy(name):
    m = MASKS[name]
    got = native.largest_component_center(m)
    assert got == scipy_largest_center(m)
    if jx_native.available():
        assert got == jx_native.largest_component_center(m)
    if name == "diagonal":
        assert got[2] == 2


@pytest.mark.parametrize("seed", range(5))
def test_nearest_true_matches_jax_and_numpy(seed):
    rng = np.random.default_rng(seed)
    m = rng.uniform(size=(32, 48)) > 0.9
    x, y = int(rng.integers(48)), int(rng.integers(32))
    ys, xs = np.nonzero(m)
    d = (xs - x) ** 2 + (ys - y) ** 2
    i = int(np.argmin(d))
    got = native.nearest_true(m, x, y)
    assert got == (int(xs[i]), int(ys[i]))
    if jx_native.available():
        assert got == jx_native.nearest_true(m, x, y)
    assert native.nearest_true(np.zeros((4, 4), bool), 1, 1) is None


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """No silent fallback: g++'s error reaches the caller."""
    bad = tmp_path / "click_ops.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            native.load()
        assert not native.available()
    finally:
        native.load.cache_clear()


def _robot_cases():
    """(pred, gt, iou) pairs: random blobs, an empty prediction, a perfect
    one, a prediction off the object (iou < 0.1)."""
    rng = np.random.default_rng(3)
    cases = []
    for _ in range(6):
        gt = ndimage.binary_dilation(rng.uniform(size=(40, 56)) > 0.97,
                                     iterations=3)
        pred = ndimage.binary_dilation(rng.uniform(size=(40, 56)) > 0.97,
                                       iterations=2)
        cases.append((pred, gt, 0.5))
    gt = np.zeros((40, 56), bool)
    gt[10:20, 30:40] = True
    off = np.zeros_like(gt)
    off[25:35, 2:12] = True
    cases += [(np.zeros_like(gt), gt, 0.0), (gt.copy(), gt, 1.0),
              (off, gt, 0.0)]
    return cases


def test_robot_clicks_equal_with_and_without_native(monkeypatch):
    calls = []
    center = native.largest_component_center
    monkeypatch.setattr(native, "largest_component_center",
                        lambda m: calls.append(1) or center(m))
    out = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("EVAVOS_NATIVE", flag)
        assert robots._use_native() == (flag == "1")
        calls.clear()
        robot = ClickRobot()
        out[flag] = [robot.interact(p, g, iou) for p, g, iou in
                     _robot_cases()]
        assert bool(calls) == (flag == "1")
    for (c0, l0), (c1, l1) in zip(out["0"], out["1"]):
        np.testing.assert_array_equal(c0, c1)
        np.testing.assert_array_equal(l0, l1)
