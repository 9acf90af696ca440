"""An inference copy of a ResNet trunk (``resnet.ResNetTrunk``) with every
eval BatchNorm folded into its convolution, for the engine's encoders.

Each fold is computed in f32 from the trunk's own tensors, then cast to the
trunk's dtype::

    w' = w * g,   b' = (b - running_mean) * g + beta,
    g = gamma / sqrt(running_var + eps)          (b = 0 for a bias-free conv)

So the stem's and each block's inner conv -> BN -> ReLU is one convolution
with a bias and a ReLU, and a block's last conv -> BN -> (+ residual) -> ReLU
one convolution with a bias, an add and a ReLU.  A downsample conv -> BN runs
with no bias: its folded bias joins the block's last one, since
``relu(c3 + b3 + cd + bd) = relu(c3 + cd + (b3 + bd))``.

On a CUDA device each convolution runs its bias, add and ReLU in cuDNN's
convolution epilogue (``torch.cudnn_convolution_relu``,
``torch.cudnn_convolution_add_relu``): on the H100 that beat the folded
convolution followed by its own bias, add and ReLU passes at every shape of
the engine's trunks, in f32 (TF32) and bf16 alike
(``scripts/torch_port_trunk_routes.py``).  On the CPU each runs ``F.conv2d``
with the bias, then the add and the ReLU.

Training needs BatchNorm's batch statistics and inference wants it folded,
so ``ResNetTrunk`` stays the module that trains and loads weights, and a
``FusedTrunk`` is a snapshot of its tensors: ``current`` says whether the
trunk still holds the very tensors, unchanged, that it was folded from.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class _Conv(NamedTuple):
    weight: torch.Tensor             # folded, channels-last
    bias: torch.Tensor | None        # folded; None on a downsample conv
    stride: tuple[int, int]
    padding: tuple[int, int]


class _Block(NamedTuple):
    inner: tuple[_Conv, ...]         # conv -> BN -> ReLU
    last: _Conv                      # conv -> BN -> (+ residual) -> ReLU
    down: _Conv | None               # downsample conv -> BN (bias in last)


def _block_pairs(block):
    """A block's (conv, BN) pairs in order, and its downsample's or None."""
    pairs, i = [], 1
    while hasattr(block, f"conv{i}"):
        pairs.append((getattr(block, f"conv{i}"), getattr(block, f"bn{i}")))
        i += 1
    ds = block.downsample
    return pairs, (None if ds is None else (ds[0], ds[1]))


def _trunk_pairs(trunk):
    """Every (conv, BN) pair of the trunk, in the order of its forward."""
    yield trunk.conv1, trunk.bn1
    for name in trunk.stage_names:
        for block in getattr(trunk, name):
            pairs, ds = _block_pairs(block)
            yield from pairs
            if ds is not None:
                yield ds


def _sources(trunk):
    """The tensors a fold reads."""
    for conv, bn in _trunk_pairs(trunk):
        yield from (t for t in (conv.weight, conv.bias, bn.weight, bn.bias,
                                bn.running_mean, bn.running_var)
                    if t is not None)


def _fold(conv, bn) -> tuple[torch.Tensor, torch.Tensor]:
    """(w', b') of one conv -> BN pair, in f32."""
    g = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    w = conv.weight.float() * g[:, None, None, None]
    b = bn.bias.float() - bn.running_mean.float() * g
    if conv.bias is not None:
        b = b + conv.bias.float() * g
    return w, b


def _conv(weight, bias, conv) -> _Conv:
    dtype = conv.weight.dtype
    return _Conv(weight.to(dtype).contiguous(memory_format=torch.channels_last),
                 None if bias is None else bias.to(dtype),
                 conv.stride, conv.padding)


def _conv_relu(x, c: _Conv):
    if x.is_cuda:
        return torch.cudnn_convolution_relu(x, c.weight, c.bias, c.stride,
                                            c.padding, (1, 1), 1)
    return F.conv2d(x, c.weight, c.bias, c.stride, c.padding).relu_()


def _conv_add_relu(x, c: _Conv, z):
    if x.is_cuda:
        return torch.cudnn_convolution_add_relu(x, c.weight, z, 1.0, c.bias,
                                                c.stride, c.padding, (1, 1), 1)
    return F.conv2d(x, c.weight, c.bias, c.stride, c.padding).add_(z).relu_()


def _conv_plain(x, c: _Conv):
    return F.conv2d(x, c.weight, None, c.stride, c.padding)


class FusedTrunk:
    """Called as the trunk is: NCHW in, a tuple of stage features out.  In
    eval semantics always, whatever the trunk's mode."""

    @torch.no_grad()
    def __init__(self, trunk):
        self._stamp = [(t, t._version) for t in _sources(trunk)]
        self.bn_folded = sum(1 for _ in _trunk_pairs(trunk))
        self.stem = _conv(*_fold(trunk.conv1, trunk.bn1), trunk.conv1)
        self.stages = [[self._block(b) for b in getattr(trunk, name)]
                       for name in trunk.stage_names]

    @staticmethod
    def _block(block) -> _Block:
        pairs, ds = _block_pairs(block)
        inner = tuple(_conv(*_fold(c, bn), c) for c, bn in pairs[:-1])
        w, b = _fold(*pairs[-1])
        down = None
        if ds is not None:
            wd, bd = _fold(*ds)
            down, b = _conv(wd, None, ds[0]), b + bd
        return _Block(inner, _conv(w, b, pairs[-1][0]), down)

    def current(self, trunk) -> bool:
        """Whether ``trunk`` holds the tensors this was folded from, none of
        them written since."""
        now = list(_sources(trunk))
        return len(now) == len(self._stamp) and all(
            t is s and t._version == v for t, (s, v) in zip(now, self._stamp))

    @torch.no_grad()
    def __call__(self, x):
        x = _conv_relu(x, self.stem)
        x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
        feats = []
        for blocks in self.stages:
            for blk in blocks:
                out = x
                for c in blk.inner:
                    out = _conv_relu(out, c)
                z = x if blk.down is None else _conv_plain(x, blk.down)
                x = _conv_add_relu(out, blk.last, z)
            feats.append(x)
        return tuple(feats)
