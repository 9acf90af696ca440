"""Gaps between what the program produced and what the reference works out.

``Gaps`` accumulates, over every compared output of one kind, the largest
gap, the mean gap and the mean of the reference's magnitudes (for a
relative gap), and a few shares for the record.
"""

from __future__ import annotations


def unpad(p, h: int, w: int):
    """The [..., h, w] centre of a frame padded to multiples of 16 (the
    low side takes floor(extra / 2))."""
    top, left = (p.shape[-2] - h) // 2, (p.shape[-1] - w) // 2
    return p[..., top:top + h, left:left + w]


def logit(p, eps: float = 1e-6):
    """log(p / (1 - p)), p clamped to [eps, 1 - eps]."""
    p = p.float().clamp(eps, 1 - eps)
    return p.log() - (1 - p).log()


# the histogram of gaps, in bins of log10 from 1e-9 to 100, for quantiles
LOG_LO, LOG_HI, BINS = -9.0, 2.0, 440


class Gaps:
    def __init__(self):
        self.hist = None
        self.n = 0
        self.items = 0
        self.worst = 0.0
        self.total = 0.0
        self.sq = 0.0
        self.ref_total = 0.0
        self.over = {0.01: 0, 0.05: 0}
        self.worst_item_mean = 0.0

    def add(self, got, ref):
        """Compare one output (tensors of one shape)."""
        gap = (got.float() - ref.float()).abs()
        self.items += 1
        self.n += gap.numel()
        self.worst = max(self.worst, float(gap.max()))
        s = float(gap.double().sum())
        self.total += s
        self.sq += float((gap.double() ** 2).sum())
        self.ref_total += float(ref.double().abs().sum())
        for a in self.over:
            self.over[a] += int((gap > a).sum())
        self.worst_item_mean = max(self.worst_item_mean, s / gap.numel())
        lg = gap.clamp(10 ** LOG_LO, 10 ** LOG_HI).log10().flatten()
        h = lg.histc(BINS, LOG_LO, LOG_HI).double().cpu()
        self.hist = h if self.hist is None else self.hist + h

    def quantile(self, q: float) -> float:
        """The gap below which a share ``q`` of the values lie (to the
        upper edge of its histogram bin)."""
        c = self.hist.cumsum(0)
        i = int((c < q * c[-1]).sum())
        return 10 ** (LOG_LO + (i + 1) * (LOG_HI - LOG_LO) / BINS)

    @property
    def mean(self) -> float:
        return self.total / self.n

    @property
    def relative(self) -> float:
        """Mean gap over the reference's mean magnitude."""
        return self.total / self.ref_total if self.ref_total else float("inf")

    def info(self) -> dict:
        return {"items": self.items, "values": self.n, "max": self.worst,
                "mean": self.mean if self.n else None,
                "relative": self.relative if self.n else None,
                "rms": (self.sq / self.n) ** 0.5 if self.n else None,
                "share_over_0.01": self.over[0.01] / self.n if self.n else None,
                "share_over_0.05": self.over[0.05] / self.n if self.n else None,
                "worst_item_mean": self.worst_item_mean,
                **({f"p{q}": self.quantile(q / 100) for q in (50, 90, 99, 99.9)}
                   if self.n else {})}


class FrameMedians:
    """The median gap of each compared frame, over its pixels that a mask
    keeps: one number a frame that local outliers (a token swapped at a
    near-tie of the top-k) do not move, and a frame gone wrong does."""

    MIN_PIXELS = 64

    def __init__(self):
        self.medians = []

    def add(self, got, ref, keep):
        """got, ref, keep: [frames, H, W]."""
        gap = (got.float() - ref.float()).abs()
        for f in range(gap.shape[0]):
            v = gap[f][keep[f]]
            if v.numel() >= self.MIN_PIXELS:
                self.medians.append(float(v.median()))

    def worst(self) -> float:
        return max(self.medians) if self.medians else 0.0

    def info(self) -> dict:
        m = sorted(self.medians)
        return {"frames": len(m), "max": self.worst(),
                "median": m[len(m) // 2] if m else None}
