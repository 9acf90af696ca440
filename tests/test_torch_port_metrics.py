"""The port's resizes, mask utilities and quality metrics against the JAX
package, on the CPU.

The same seeded numpy inputs go through both packages' functions in each
test.  Tolerances: the resizes' filter weights are summed in another order
by XLA and torch, which stays within 1e-5 on images in [0, 1]; nearest
resizing picks pixels and must be exact.  The metrics count pixels, so the
host functions must agree exactly and the batched device versions must be
bit-equal to the JAX ones and to the port's own host loop.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from eva_vos_tpu.ops import masks as jx_masks
from eva_vos_tpu.ops import metrics as jx
from eva_vos_tpu.ops import resize as jx_resize
from eva_vos_tpu_torch.ops import masks as pt_masks
from eva_vos_tpu_torch.ops import metrics as pt
from eva_vos_tpu_torch.ops import resize as pt_resize

RESIZE_CASES = [((480, 854), (256, 455)),   # both axes shrink
                ((30, 54), (60, 20)),       # one grows, one shrinks
                ((48, 64), (224, 224))]     # both grow (the QNet input)


def _images(hw, seed=0):
    return np.random.default_rng(seed).uniform(
        0.0, 1.0, (2, *hw, 3)).astype(np.float32)


@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
@pytest.mark.parametrize("src,dst", RESIZE_CASES)
def test_resize_matches_jax(method, src, dst):
    x = _images(src)
    want = np.asarray(getattr(jx_resize, f"resize_{method}")(jnp.asarray(x),
                                                             dst))
    got = getattr(pt_resize, f"resize_{method}")(torch.from_numpy(x), dst)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("src,dst", RESIZE_CASES)
def test_resize_axes_match_jax(src, dst):
    """The h_axis / w_axis arguments: [T, H, W, 3] frames on axes 1, 2 (the
    QNet's bicubic input) and [T, H, W] masks on axes 1, 2 (nearest)."""
    x = _images(src, seed=1)
    want = np.asarray(jx_resize.resize_bicubic(jnp.asarray(x), dst,
                                               h_axis=1, w_axis=2))
    got = pt_resize.resize_bicubic(torch.from_numpy(x), dst, h_axis=1,
                                   w_axis=2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    m = (x[..., 0] > 0.5).astype(np.float32)
    want = np.asarray(jx_resize.resize_nearest(jnp.asarray(m), dst,
                                               h_axis=1, w_axis=2))
    got = pt_resize.resize_nearest(torch.from_numpy(m), dst, h_axis=1,
                                   w_axis=2)
    np.testing.assert_array_equal(got.numpy(), want)
    # a 2-D mask on the default axes
    want = np.asarray(jx_resize.resize_nearest(jnp.asarray(m[0]), dst))
    np.testing.assert_array_equal(
        pt_resize.resize_nearest(torch.from_numpy(m[0]), dst).numpy(), want)


def test_upsampling_keeps_the_plain_kernel():
    """Growing both axes, resize_bilinear is the plain (not antialiased)
    interpolation of the engine's calls, bit for bit, in fp32 and bf16."""
    x = torch.from_numpy(_images((30, 54)))
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype)
        want = F.interpolate(xd.permute(0, 3, 1, 2), size=(60, 108),
                             mode="bilinear", align_corners=False)
        got = pt_resize.resize_bilinear(xd, (60, 108))
        assert got.dtype == dtype
        assert torch.equal(got, want.permute(0, 2, 3, 1))
        assert torch.equal(pt_resize.upsample2x(xd), got)


def test_bf16_shrink_is_antialiased_in_fp32():
    """bf16 input with a shrinking axis: the antialiased filter in fp32,
    cast back to bf16."""
    x = torch.from_numpy(_images((60, 108))).bfloat16()
    got = pt_resize.resize_bilinear(x, (30, 40))
    assert got.dtype == torch.bfloat16
    want = pt_resize.resize_bilinear(x.float(), (30, 40)).bfloat16()
    assert torch.equal(got, want)
    got = pt_resize.resize_bicubic(x, (30, 40))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got,
                       pt_resize.resize_bicubic(x.float(), (30, 40)).bfloat16())


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------

def test_mask_utilities_match_jax():
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 4, (3, 20, 30))
    np.testing.assert_array_equal(pt_masks.all_to_onehot(ids, [1, 3]),
                                  jx_masks.all_to_onehot(ids, [1, 3]))
    np.testing.assert_array_equal(pt_masks.all_to_onehot(ids[0], [0, 2]),
                                  jx_masks.all_to_onehot(ids[0], [0, 2]))
    m = ids == 2
    m[1] = False                                    # an empty mask: zeros
    got, want = pt_masks.masks_to_boxes(m), jx_masks.masks_to_boxes(m)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pt_masks.masks_to_boxes(m[0]),
                                  jx_masks.masks_to_boxes(m[0]))


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _mask_pairs(h, w, seed):
    """[T, H, W] gt and prediction stacks: random noise, random blobs, and
    the edge cases (empty, full, both empty, one pixel, gt empty)."""
    rng = np.random.default_rng(seed)

    def blob():
        m = np.zeros((h, w), bool)
        y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
        m[y0:y0 + rng.integers(2, h // 2), x0:x0 + rng.integers(2, w // 2)] = 1
        return m

    empty, full = np.zeros((h, w), bool), np.ones((h, w), bool)
    one = empty.copy()
    one[h // 3, w // 2] = True
    gts = [rng.random((h, w)) > 0.5, blob(), blob(), blob(), empty, full,
           one, empty, blob(), one]
    preds = [rng.random((h, w)) > 0.5, blob(), gts[2], empty, empty, full,
             one, blob(), full, gts[9] | blob()]
    return np.stack(gts), np.stack(preds)


SIZES = [(48, 64), (120, 214), (480, 854)]


@pytest.mark.parametrize("hw", SIZES)
def test_host_metrics_match_jax(hw):
    gt, pred = _mask_pairs(*hw, seed=hw[0])
    for g, p in zip(gt, pred):
        assert pt.compute_iou(p[None], g[None]) == jx.compute_iou(p[None],
                                                                  g[None])
        assert pt.binary_jaccard(p, g) == jx.binary_jaccard(p, g)
        np.testing.assert_array_equal(pt.seg2bmap(p), jx.seg2bmap(p))
        assert pt.f_measure(g, p) == jx.f_measure(g, p)
        assert pt.get_j_and_f(g[None], p[None]) == jx.get_j_and_f(g[None],
                                                                  p[None])
        assert pt.get_j_and_f(g, p) == jx.get_j_and_f(g, p)
    assert pt.compute_iou(pred, gt) == jx.compute_iou(pred, gt)
    ids = pred[:3].astype(np.int64) + 2 * pred[3:6]
    assert (pt.compute_multi_class_iou_idx(ids[0], gt[:2]) ==
            jx.compute_multi_class_iou_idx(ids[0], gt[:2]))
    assert (pt.compute_multi_class_iou_both_idx(ids[0], ids[1]) ==
            jx.compute_multi_class_iou_both_idx(ids[0], ids[1]))


@pytest.mark.parametrize("radius", [0, 1, 2, 8])
def test_dilation_matches_jax(radius):
    """scipy's dilation against the JAX package's (cv2 where installed)."""
    np.testing.assert_array_equal(pt.disk(radius), jx.disk(radius))
    gt, pred = _mask_pairs(120, 214, seed=radius)
    for m in np.concatenate([gt, pred]):
        b = pt.seg2bmap(m)
        got = pt._dilate(b, pt.disk(radius))
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, jx._dilate(b, jx.disk(radius)))


@pytest.mark.parametrize("hw", SIZES)
def test_batched_quality_is_bit_equal(hw):
    gt, pred = _mask_pairs(*hw, seed=hw[1])
    host_j = np.asarray([pt.compute_iou(p[None], g[None])
                         for g, p in zip(gt, pred)])
    host_jf = np.asarray([pt.get_j_and_f(g[None], p[None])
                          for g, p in zip(gt, pred)])
    for metric, host in (("j", host_j), ("j_and_f", host_jf)):
        want = jx.quality_batch(gt, pred, metric)
        got = pt.quality_batch(gt, pred, metric, device="cpu")
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, host)
        # tensor inputs stay where they are
        got = pt.quality_batch(torch.from_numpy(gt), torch.from_numpy(pred),
                               metric)
        np.testing.assert_array_equal(got, host)
    np.testing.assert_array_equal(pt.j_and_f_batch(gt, pred, device="cpu"),
                                  jx.j_and_f_batch(gt, pred))
    counts = pt._jf_counts(torch.from_numpy(gt), torch.from_numpy(pred),
                           int(np.ceil(0.008 * np.linalg.norm(hw))))
    assert counts.dtype == torch.int32 and counts.shape == (len(gt), 6)
    np.testing.assert_array_equal(
        pt.torch_iou(torch.from_numpy(pred), torch.from_numpy(gt)).numpy(),
        np.asarray(jx.jnp_iou(jnp.asarray(pred), jnp.asarray(gt))))


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_batched_dilation_ignores_convolution_residues(monkeypatch, sign):
    """An FFT or Winograd convolution leaves residues of ~1e-7 around the
    integer sums; the batched dilation must still equal the host one."""
    conv2d = F.conv2d
    rng = np.random.default_rng(5)

    def noisy_conv2d(*args, **kwargs):
        y = conv2d(*args, **kwargs)
        noise = rng.choice([-1e-6, 1e-6], size=tuple(y.shape))
        noise[y.numpy() == 0] = sign * 1e-6
        return y + torch.from_numpy(noise).to(y.dtype)

    monkeypatch.setattr(pt.F, "conv2d", noisy_conv2d)
    gt, pred = _mask_pairs(120, 214, seed=7)
    selem = pt.disk(8)
    maps = np.stack([pt.seg2bmap(m) for m in np.concatenate([gt, pred])])
    got = pt._dilate_batch(torch.from_numpy(maps.astype(bool)), selem).numpy()
    want = np.stack([pt._dilate(b, selem) for b in maps]).astype(bool)
    np.testing.assert_array_equal(got, want)
