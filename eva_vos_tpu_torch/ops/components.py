"""Device connected components and click selection: the click robot on the
card (counterpart of ``eva_vos_tpu/ops/components.py``).

SAM's warm-start chain (``SamPredictor.warmstart_select``) refines a mask
with the click robot after every decode; with these functions the robot
runs where the masks are, and only its click comes to the host.

Exactness contract, held bit for bit against the scipy robot
(``annotator/robots.py``) in ``tests/test_torch_port_components.py``:

* 8-connected components; a component's identity is the minimum flat
  (row-major) index in it.  scipy labels in raster order of first pixel, so
  "argmax over sizes, first max wins" over scipy labels is "the largest
  component, the smallest root on ties" here;
* a component's centre is (sum_x // size, sum_y // size), equal to
  ``int(np.mean(xs))`` for non-negative integers;
* snapping to the mask takes the nearest true pixel by squared distance,
  row-major first on ties (``np.argmin`` over ``np.nonzero`` order);
* the middle click is the median of xs and of ys (``np.median`` averages
  the two central order statistics; ``int`` truncation is the floor).

Labelling is the JAX package's masked min-label propagation: each step takes
the minimum over mask-contiguous row runs, then column runs (segmented
Hillis-Steele min scans in both directions, as shifted ``torch.minimum``s
of one packed int32 array), then over the 8-neighbourhood, and the steps
repeat to a fixpoint, so every shape is exact (a spiral takes more steps).
The fixpoint test reads one flag from the card after every step (on SAM's
warm-start masks at 480x854 that was faster on the H100 than reading every
2 or 4 steps, ``scripts/torch_port_robot_profile.py``), so the robot's
click, read by its caller, is the only other transfer.  The per-component
sums are
``index_add_`` scatters, exact for any number of components.
"""

from __future__ import annotations

import torch

INF32 = 2 ** 31 - 1
# packed scan state: the value in the low 30 bits, "the segment holds a
# blocked cell" in bit 30; a blocked cell is INF32 = BIT | VMAX
_BIT = 1 << 30
_VMAX = (1 << 30) - 1


def _packed_combine(k1, k2):
    """Segmented-min composition of packed states (k1 the earlier part): a
    blocked right operand wins, otherwise the min keeps the left flag."""
    return torch.where(k2 >= _BIT, k2,
                       torch.minimum(k1, k2 | (k1 & _BIT)))


def _shift_along(x, d: int, dim: int):
    """x[i - d] brought to position i along ``dim``; INF32 (blocked) fill."""
    fill = torch.full_like(x.narrow(dim, 0, d), INF32)
    return torch.cat([fill, x.narrow(dim, 0, x.shape[dim] - d)], dim=dim)


def _hillis_seg_scan(x, dim: int):
    """Inclusive segmented-min scan of packed states by doubling."""
    n, d = x.shape[dim], 1
    while d < n:
        x = _packed_combine(_shift_along(x, d, dim), x)
        d *= 2
    return x


def _run_collapse(lab, mask, dim: int):
    """The min over each mask-contiguous run along ``dim``, both ways, as
    one scan of the [forward, flipped] stack."""
    packed = torch.where(mask, torch.clamp(lab, max=_VMAX), INF32)
    s = _hillis_seg_scan(torch.stack([packed, packed.flip(dim)]),
                         dim if dim < 0 else dim + 1)
    fwd = s[0] & _VMAX
    rev = s[1].flip(dim) & _VMAX
    return torch.minimum(lab, torch.minimum(fwd, rev))


def _propagate_once(lab, mask):
    """One step: row runs, column runs (on the updated labels), then the
    8-neighbourhood.  The spatial axes are the last two."""
    lab = _run_collapse(lab, mask, -1)
    lab = _run_collapse(lab, mask, -2)
    big = torch.where(mask, lab, INF32)
    p = torch.nn.functional.pad(big, (1, 1, 1, 1), value=INF32)
    h, w = big.shape[-2:]
    neigh = big
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                neigh = torch.minimum(
                    neigh, p[..., 1 + dy:h + 1 + dy, 1 + dx:w + 1 + dx])
    return torch.where(mask, torch.minimum(big, neigh), INF32)


def label_components(mask: torch.Tensor) -> torch.Tensor:
    """mask [..., H, W] bool -> int32 labels: a true pixel gets the minimum
    flat row-major index of its 8-connected component (per leading slice),
    a false one INF32.  Leading slices are labelled in one loop."""
    h, w = mask.shape[-2:]
    flat = torch.arange(h * w, dtype=torch.int32,
                        device=mask.device).reshape(h, w)
    lab = torch.where(mask, flat.expand(mask.shape), INF32)
    while True:
        prev, lab = lab, _propagate_once(lab, mask)
        if not bool((lab != prev).any()):
            return lab


def _stats_from_labels(lab, mask):
    """(cx, cy, size) of the largest component: int64 0-d tensors, size 0
    on an empty mask."""
    h, w = mask.shape
    flat = lab.reshape(-1).long()
    valid = flat != INF32
    root = torch.where(valid, flat, 0)
    idx = torch.arange(h * w, device=lab.device)
    ys, xs = idx // w, idx % w
    zeros = torch.zeros(h * w, dtype=torch.int64, device=lab.device)
    sizes = zeros.index_add(0, root, valid.long())
    sum_y = zeros.index_add(0, root, torch.where(valid, ys, 0))
    sum_x = zeros.index_add(0, root, torch.where(valid, xs, 0))
    best = torch.argmax(sizes)       # first max: the smallest root
    size = sizes[best]
    div = torch.clamp(size, min=1)
    return sum_x[best] // div, sum_y[best] // div, size


def largest_component_stats(mask: torch.Tensor):
    """mask [H, W] bool -> (cx, cy, size) of the largest 8-connected
    component (0-d int64 tensors); size 0 when the mask is empty."""
    return _stats_from_labels(label_components(mask), mask)


def snap_to_mask(x, y, mask: torch.Tensor):
    """The nearest true pixel of ``mask`` to (x, y), row-major first on
    ties; (x, y) itself when it lies inside.  ``mask`` must be non-empty."""
    h, w = mask.shape
    x = torch.as_tensor(x, device=mask.device).long()
    y = torch.as_tensor(y, device=mask.device).long()
    yy = torch.arange(h, device=mask.device)[:, None]
    xx = torch.arange(w, device=mask.device)[None, :]
    d = torch.where(mask, (xx - x) ** 2 + (yy - y) ** 2,
                    torch.iinfo(torch.int64).max)
    i = torch.argmin(d.reshape(-1))
    inside = mask[y, x]
    return torch.where(inside, x, i % w), torch.where(inside, y, i // w)


def _median_int(counts, n):
    """int(np.median(values)) where ``counts[v]`` counts value v: the floor
    of the mean of the (n-1)//2-th and n//2-th order statistics."""
    cum = torch.cumsum(counts, 0)
    v1 = torch.argmax((cum > (n - 1) // 2).int())
    v2 = torch.argmax((cum > n // 2).int())
    return (v1 + v2) // 2


def middle_click(gt: torch.Tensor):
    """The object's median pixel, snapped into it (reference
    ``click_robot.py:78-99``).  gt [H, W] bool, non-empty.  Returns (x, y)
    0-d int64 tensors."""
    n = gt.sum()
    mx = _median_int(gt.sum(0), n)
    my = _median_int(gt.sum(1), n)
    return snap_to_mask(mx, my, gt)


def click_robot_interact(pred: torch.Tensor, gt: torch.Tensor):
    """One refinement click (``ClickRobot.interact`` without an iou): the
    larger of the largest false-positive component (a negative click at its
    centre) and the largest false-negative one (a positive click at its
    centre snapped into gt), the false positive winning ties; the middle
    click when the prediction is exact.  pred/gt [H, W] bool, gt non-empty.
    Returns (x, y, label) 0-d int64 tensors."""
    fp, fn = pred & ~gt, ~pred & gt
    lab2 = label_components(torch.stack([fp, fn]))    # one loop for both
    fpx, fpy, fps = _stats_from_labels(lab2[0], fp)
    fnx, fny, fns = _stats_from_labels(lab2[1], fn)
    snx, sny = snap_to_mask(fnx, fny, gt)
    fp_wins = (fps >= fns) & (fps > 0)
    x = torch.where(fp_wins, fpx, snx)
    y = torch.where(fp_wins, fpy, sny)
    label = torch.where(fp_wins, 0, 1)
    exact = (fps == 0) & (fns == 0)
    mx, my = middle_click(gt)
    return (torch.where(exact, mx, x), torch.where(exact, my, y),
            torch.where(exact, 1, label))
