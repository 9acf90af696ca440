"""Annotator debug overlays for qualitative inspection of SAM click
sessions (a copy of ``eva_vos_tpu/vis/overlays.py``; behavior parity
target: reference ``annotator/util.py:16-53`` ``show_mask`` /
``show_mask_thickness`` / ``show_points`` / ``show_box``).

Pure numpy + matplotlib-Axes helpers — no torch, no device compute.  The
label convention matches the reference's click robots: 1 = positive click
(green star), 0 = negative click (red star), 2 = extra/middle click
(blue star).  ``save_click_session`` composes frame + mask + prompts into
one PNG, the typical way these are used while debugging an annotation
policy run.
"""

from __future__ import annotations

import numpy as np

_DEFAULT_MASK_COLOR = (1.0, 0.0, 0.0, 0.6)


def show_mask(mask, ax, color=None):
    """Overlay a binary mask on ``ax`` as a translucent RGBA image."""
    color = np.asarray(_DEFAULT_MASK_COLOR if color is None else color,
                       np.float32)
    m = np.asarray(mask, np.float32)
    h, w = m.shape[-2:]
    ax.imshow(m.reshape(h, w, 1) * color.reshape(1, 1, -1))


def show_mask_thickness(mask, ax, color=None, thickness=1):
    """Like :func:`show_mask`, plus a white dilation-XOR boundary ring of
    the given ``thickness`` (reference ``annotator/util.py:24-38``)."""
    color = np.asarray(_DEFAULT_MASK_COLOR if color is None else color,
                       np.float32)
    m = np.asarray(mask)
    h, w = m.shape[-2:]
    img = m.reshape(h, w, 1).astype(np.float32) * color.reshape(1, 1, -1)
    if thickness > 1:
        from scipy.ndimage import binary_dilation

        grown = binary_dilation(m.astype(bool),
                                structure=np.ones((thickness, thickness)))
        ring = np.logical_xor(m.astype(bool), grown)
        img = np.maximum(img, ring.reshape(h, w, 1).astype(np.float32))
    ax.imshow(img)


def show_points(coords, labels, ax, marker_size=375):
    """Scatter click prompts: label 1 green / 0 red / 2 blue stars."""
    coords = np.asarray(coords).reshape(-1, 2)
    labels = np.asarray(labels).reshape(-1)
    for lab, col in ((1, "green"), (0, "red"), (2, "blue")):
        pts = coords[labels == lab]
        ax.scatter(pts[:, 0], pts[:, 1], color=col, marker="*",
                   s=marker_size, edgecolor="white", linewidth=1.25)


def show_box(box, ax, lw=2):
    """Draw an (x0, y0, x1, y1) prompt box as a green rectangle."""
    import matplotlib.pyplot as plt

    x0, y0, x1, y1 = [float(v) for v in np.asarray(box).reshape(-1)[:4]]
    ax.add_patch(plt.Rectangle((x0, y0), x1 - x0, y1 - y0,
                               edgecolor="green", facecolor=(0, 0, 0, 0),
                               lw=lw))


def save_click_session(image, mask, out_path, *, coords=None, labels=None,
                       box=None, title=None, gt_mask=None):
    """Compose one debug frame: RGB image + predicted mask overlay (+ the
    gt mask in blue, prompts, box) and write it to ``out_path``.

    image: [H, W, 3] float (any range; min-max normalized for display)
    mask / gt_mask: [H, W] binary
    coords/labels: click prompts as given to the SAM predictor
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    im = np.asarray(image, np.float32)
    im = (im - im.min()) / max(float(im.max() - im.min()), 1e-8)

    fig, ax = plt.subplots(figsize=(im.shape[1] / 96, im.shape[0] / 96))
    ax.imshow(im)
    if gt_mask is not None:
        show_mask(gt_mask, ax, color=(0.0, 0.3, 1.0, 0.35))
    if mask is not None:
        show_mask(mask, ax)
    if coords is not None and labels is not None and len(np.ravel(labels)):
        show_points(coords, labels, ax)
    if box is not None:
        show_box(box, ax)
    if title:
        ax.set_title(title)
    ax.axis("off")
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
