"""Plain reference of the STCN engine with MiVOS fusion, in plain PyTorch.

It imports nothing of the program.  The networks are a frozen copy of the
port's plain modules (STCN, Cheng et al., NeurIPS 2021, hkchengrex/STCN
``model/network.py`` and ``modules.py``; MiVOS's ``fusion_net.py``), laid
out as the published state dicts, so that one state dict loads into both.
They run NCHW.  The engine follows MiVOS's ``inference_core.py`` one frame
at a time: an interaction writes its mask, stores one certain memory,
then propagates forward to the next interacted frame (or the end) and
backward to the previous one (or the start), reading the top-k of the
memory bank for each frame, storing a transient memory every ``mem_freq``
frames (never at a pass's last frame), and fusing each frame of a pass
bounded by an interacted frame with its prior prediction.  The read scores
every memory token densely, ``(2 q.k - |k|^2) / sqrt(CK)`` in float32, and
softmaxes its top-k.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
AGG_EPS = 1e-7


# ---------------------------------------------------------------- networks

def conv3x3(cin, cout):
    return nn.Conv2d(cin, cout, kernel_size=3, padding=1)


def up2(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


class ResBlock(nn.Module):
    def __init__(self, indim, outdim):
        super().__init__()
        self.conv1 = conv3x3(indim, outdim)
        self.conv2 = conv3x3(outdim, outdim)
        self.downsample = conv3x3(indim, outdim) if indim != outdim else None

    def forward(self, x):
        r = self.conv2(F.relu(self.conv1(F.relu(x))))
        return (x if self.downsample is None else self.downsample(x)) + r


class ChannelGate(nn.Module):
    def __init__(self, c, reduction=16):
        super().__init__()
        self.mlp = nn.Sequential(nn.Flatten(), nn.Linear(c, c // reduction),
                                 nn.ReLU(), nn.Linear(c // reduction, c))

    def forward(self, x):
        att = self.mlp(x.mean(dim=(2, 3))) + self.mlp(x.amax(dim=(2, 3)))
        return x * torch.sigmoid(att)[:, :, None, None]


class SpatialGate(nn.Module):
    def __init__(self):
        super().__init__()
        self.spatial = nn.ModuleDict(
            {"conv": nn.Conv2d(2, 1, kernel_size=7, padding=3)})

    def forward(self, x):
        pooled = torch.cat([x.amax(dim=1, keepdim=True),
                            x.mean(dim=1, keepdim=True)], dim=1)
        return x * torch.sigmoid(self.spatial["conv"](pooled))


class CBAM(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.ChannelGate = ChannelGate(c)
        self.SpatialGate = SpatialGate()

    def forward(self, x):
        return self.SpatialGate(self.ChannelGate(x))


class FeatureFusionBlock(nn.Module):
    def __init__(self, indim, outdim):
        super().__init__()
        self.block1 = ResBlock(indim, outdim)
        self.attention = CBAM(outdim)
        self.block2 = ResBlock(outdim, outdim)

    def forward(self, x, f16):
        x = self.block1(torch.cat([x, f16], dim=1))
        return self.block2(x + self.attention(x))


class UpsampleBlock(nn.Module):
    def __init__(self, skip_c, up_c, out_c):
        super().__init__()
        self.skip_conv = conv3x3(skip_c, up_c)
        self.out_conv = ResBlock(up_c, out_c)

    def forward(self, skip, up):
        """``skip``: the skip convolution's output (computed once a frame)."""
        return self.out_conv(skip + up2(up))


class KeyProjection(nn.Module):
    def __init__(self, indim, keydim):
        super().__init__()
        self.key_proj = conv3x3(indim, keydim)

    def forward(self, x):
        return self.key_proj(x)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=False, bias=False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=bias)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=bias)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = nn.Sequential(
            nn.Conv2d(inplanes, planes, 1, stride, bias=bias),
            nn.BatchNorm2d(planes)) if downsample else None

    def forward(self, x):
        out = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        return F.relu(out + (x if self.downsample is None else self.downsample(x)))


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=False, bias=False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=bias)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=bias)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=bias)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = nn.Sequential(
            nn.Conv2d(inplanes, planes * 4, 1, stride, bias=bias),
            nn.BatchNorm2d(planes * 4)) if downsample else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + (x if self.downsample is None else self.downsample(x)))


ARCHS = {"resnet18": (BasicBlock, (2, 2, 2, 2)),
         "resnet34": (BasicBlock, (3, 4, 6, 3)),
         "resnet50": (Bottleneck, (3, 4, 6, 3)),
         "resnet101": (Bottleneck, (3, 4, 23, 3))}


def stage_widths(arch, stages=3):
    block, _ = ARCHS[arch]
    return [64 * 2 ** s * block.expansion for s in range(stages)]


class Trunk(nn.Module):
    """Stem and the first three stages of a ResNet (torchvision's, or
    STCN's 5-channel ``mod_resnet`` with biased convolutions)."""

    def __init__(self, arch, bias, in_chans, names=("layer1", "layer2", "layer3")):
        super().__init__()
        block, layers = ARCHS[arch]
        self.names = names
        self.conv1 = nn.Conv2d(in_chans, 64, 7, 2, 3, bias=bias)
        self.bn1 = nn.BatchNorm2d(64)
        inplanes = 64
        for s, name in enumerate(names):
            planes, stride = 64 * 2 ** s, 1 if s == 0 else 2
            blocks = []
            for b in range(layers[s]):
                ds = b == 0 and (stride != 1 or inplanes != planes * block.expansion)
                blocks.append(block(inplanes, planes, stride if b == 0 else 1, ds, bias))
                inplanes = planes * block.expansion
            self.add_module(name, nn.Sequential(*blocks))

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        out = []
        for name in self.names:
            x = getattr(self, name)(x)
            out.append(x)
        return out


class ValueEncoder(Trunk):
    def __init__(self, arch, key_f16, value_dim):
        super().__init__(arch, True, 5)
        self.fuser = FeatureFusionBlock(stage_widths(arch)[-1] + key_f16, value_dim)

    def forward(self, x, key_f16):
        return self.fuser(super().forward(x)[-1], key_f16)


class Decoder(nn.Module):
    def __init__(self, f8, f4, value_dim):
        super().__init__()
        self.compress = ResBlock(2 * value_dim, 512)
        self.up_16_8 = UpsampleBlock(f8, 512, 256)
        self.up_8_4 = UpsampleBlock(f4, 256, 256)
        self.pred = conv3x3(256, 1)

    def forward(self, m16, s8, s4):
        x = self.up_8_4(s4, self.up_16_8(s8, self.compress(m16)))
        x = self.pred(F.relu(x))
        return F.interpolate(x, scale_factor=4, mode="bilinear", align_corners=False)


class PropagationNetwork(nn.Module):
    def __init__(self, keydim=64, value_dim=512, key_arch="resnet50",
                 value_arch="resnet18"):
        super().__init__()
        f4, f8, f16 = stage_widths(key_arch)
        self.key_encoder = Trunk(key_arch, False, 3, ("res2", "layer2", "layer3"))
        self.value_encoder = ValueEncoder(value_arch, f16, value_dim)
        self.key_proj = KeyProjection(f16, keydim)
        self.key_comp = conv3x3(f16, value_dim)
        self.decoder = Decoder(f8, f4, value_dim)

    def encode_key(self, frames):
        """[B, 3, H, W] -> (k16, qv16, f16, skip8, skip4)."""
        f4, f8, f16 = self.key_encoder(frames)
        return (self.key_proj(f16), self.key_comp(f16), f16,
                self.decoder.up_16_8.skip_conv(f8), self.decoder.up_8_4.skip_conv(f4))

    def encode_value(self, frame, f16, masks):
        """frame [3, H, W], f16 [C, h, w], masks [K, H, W] -> [K, CV, h, w]."""
        k = masks.shape[0]
        others = (torch.zeros_like(masks) if k == 1
                  else masks.sum(0, keepdim=True) - masks)
        x = torch.cat([frame.expand(k, *frame.shape), masks[:, None],
                       others[:, None]], dim=1)
        return self.value_encoder(x, f16.expand(k, *f16.shape))

    def decode(self, readout, qv16, s8, s4):
        """readout [K, CV, h, w] and one frame's features -> [K, H, W]
        probabilities."""
        k = readout.shape[0]
        m16 = torch.cat([readout, qv16.expand(k, *qv16.shape)], dim=1)
        logits = self.decoder(m16, s8.expand(k, *s8.shape), s4.expand(k, *s4.shape))
        return torch.sigmoid(logits[:, 0])


class FusionNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Sequential(conv3x3(9, 32), nn.ReLU())
        self.conv2 = nn.Sequential(conv3x3(32, 32), nn.ReLU(), conv3x3(32, 32))
        self.conv3 = nn.Sequential(conv3x3(32, 32), nn.ReLU(), conv3x3(32, 32))
        self.final_conv = conv3x3(32, 1)

    def forward(self, im, seg1, seg2, attn, dist):
        """im [3, H, W], seg1 / seg2 [K, H, W], attn [K, 2, H, W], dist [2]
        -> [K, H, W] logits."""
        k, h, w = seg1.shape
        x = torch.cat([im.expand(k, 3, h, w), seg1[:, None], seg2[:, None], attn,
                       dist.reshape(1, 2, 1, 1).expand(k, 2, h, w)], dim=1)
        x = self.conv1(x)
        x = F.relu(x + self.conv2(x))
        x = F.relu(x + self.conv3(x))
        return self.final_conv(x)[:, 0]


# ---------------------------------------------------------------- plain ops

def pad16(h, w):
    """(top, bottom, left, right): the low side gets floor(extra / 2)."""
    eh, ew = (-h) % 16, (-w) % 16
    return eh // 2, eh - eh // 2, ew // 2, ew - ew // 2


def aggregate(prob):
    """[K, ...] object probabilities -> [K + 1, ...] with the background as
    the product of the complements, as soft-aggregated logits."""
    p = torch.cat([torch.prod(1 - prob, dim=0, keepdim=True), prob], dim=0)
    p = p.clamp(AGG_EPS, 1 - AGG_EPS)
    return torch.softmax(torch.log(p / (1 - p)), dim=0)


def scores(mk, qk):
    """mk [M, CK], qk [N, CK] -> [N, M] float32 affinities."""
    mk, qk = mk.float(), qk.float()
    return (2 * qk @ mk.T - (mk * mk).sum(1)[None]) / math.sqrt(mk.shape[1])


def read(mk, mv, qk, top_k):
    """Top-k read: mk [M, CK], mv [K, M, CV], qk [N, CK] -> [K, N, CV]."""
    vals, idx = torch.topk(scores(mk, qk), min(top_k, mk.shape[0]), dim=1)
    w = torch.softmax(vals, dim=1)
    return torch.einsum("nk,bnkc->bnc", w, mv[:, idx].float())


# ---------------------------------------------------------------- engine

class Reference:
    """The networks and the engine's settings, for one configuration."""

    def __init__(self, config, state_dicts, device, dtype=torch.float32):
        arch = config["networks"]
        self.net = PropagationNetwork(arch["keydim"], arch["value_dim"],
                                      arch["key_arch"], arch["value_arch"])
        self.net.load_state_dict(state_dicts["stcn"])
        self.fusion = FusionNet()
        self.fusion.load_state_dict(state_dicts["fusion"])
        self.net.to(device, dtype).eval()
        self.fusion.to(device, dtype).eval()
        self.mem_freq = config["engine"]["mem_freq"]
        self.top_k = config["engine"]["top_k"]
        self.device, self.dtype = device, dtype

    @torch.no_grad()
    def open(self, frames_u8: np.ndarray, num_objects: int = 1, chunk: int = 4):
        return Session(self, frames_u8, num_objects, chunk)


class Session:
    def __init__(self, ref, frames_u8, num_objects, chunk):
        self.ref = ref
        t, h, w, _ = frames_u8.shape
        self.hw_pad = pad16(h, w)
        top, bot, left, right = self.hw_pad
        x = torch.as_tensor(frames_u8, device=ref.device).to(ref.dtype) / 255
        mean = torch.tensor(IMAGENET_MEAN, device=ref.device, dtype=ref.dtype)
        std = torch.tensor(IMAGENET_STD, device=ref.device, dtype=ref.dtype)
        x = ((x - mean) / std).permute(0, 3, 1, 2)
        self.images = F.pad(x, (left, right, top, bot))       # [T, 3, nh, nw]
        feats = [ref.net.encode_key(self.images[i:i + chunk])
                 for i in range(0, t, chunk)]
        self.k16, self.qv16, self.f16, self.s8, self.s4 = (
            torch.cat(f) for f in zip(*feats))
        nh, nw = self.images.shape[2:]
        self.prob = torch.zeros((num_objects + 1, t, nh, nw), device=ref.device)
        self.prob[0] = 1e-7
        self.keys, self.values = [], []      # certain memories
        self.interacted = []

    def _tokens(self, i):
        return self.k16[i].flatten(1).T                        # [hw, CK]

    def _value(self, i, masks):
        v = self.ref.net.encode_value(self.images[i], self.f16[i],
                                      masks.to(self.ref.dtype))
        return v.flatten(2).transpose(1, 2)                    # [K, hw, CV]

    def _segment(self, i, keys, values):
        h, w = self.k16.shape[2:]
        out = read(torch.cat(keys), torch.cat(values, dim=1), self._tokens(i),
                   self.ref.top_k)                             # [K, hw, CV]
        out = out.transpose(1, 2).reshape(-1, out.shape[2], h, w)
        prob = self.ref.net.decode(out.to(self.ref.dtype), self.qv16[i],
                                   self.s8[i], self.s4[i])
        return aggregate(prob.float())                         # [K + 1, nh, nw]

    def _attention(self, idx, i, pos, neg):
        """[K, 2, nh, nw]: the mask differences at ``idx`` carried to ``i``
        by the softmax affinity of their keys."""
        a = torch.softmax(scores(self._tokens(idx), self._tokens(i)), dim=1)
        h, w = self.k16.shape[2:]
        nh, nw = pos.shape[1:]
        f = nh // h
        diffs = torch.stack([pos, neg], 1)                     # [K, 2, nh, nw]
        small = F.avg_pool2d(diffs, f).flatten(2)              # [K, 2, hw]
        attn = (small @ a.T).reshape(-1, 2, h, w)
        return F.interpolate(attn.to(self.ref.dtype), size=(nh, nw),
                             mode="bilinear", align_corners=False)

    def _fuse(self, idx, closest, i, prev, curr, pos, neg):
        dist = (torch.tensor([abs(closest - i), abs(idx - i)], dtype=torch.float32)
                / torch.tensor(abs(closest - idx), dtype=torch.float32))
        dt = self.ref.dtype
        logit = self.ref.fusion(self.images[i], prev[1:].to(dt), curr[1:].to(dt),
                                self._attention(idx, i, pos, neg),
                                dist.to(self.images.device, dt))
        return aggregate(torch.sigmoid(logit.float()))

    @torch.no_grad()
    def interact(self, mask: np.ndarray, idx: int):
        """mask [K, H, W] (unpadded) -> propagate; updates ``prob``."""
        top, bot, left, right = self.hw_pad
        m = F.pad(torch.as_tensor(np.asarray(mask, np.float32), device=self.ref.device),
                  (left, right, top, bot))
        t = self.prob.shape[1]
        fwd = min([j for j in self.interacted if j > idx] + [t])
        bwd = max([j for j in self.interacted if j < idx] + [-1])
        diff = m - self.prob[1:, idx]
        pos, neg = diff.clamp(0, 1), (-diff).clamp(0, 1)
        self.prob[0, idx] = 1 - m.amax(0)
        self.prob[1:, idx] = m
        self.keys.append(self._tokens(idx))
        self.values.append(self._value(idx, m))
        self.interacted.append(idx)
        for closest, step in ((fwd, 1), (bwd, -1)):
            keys, values = list(self.keys), list(self.values)
            frames = list(range(idx + step, closest, step))
            for s, i in enumerate(frames):
                out = self._segment(i, keys, values)
                if (s + 1) % self.ref.mem_freq == 0 and i != frames[-1]:
                    keys.append(self._tokens(i))
                    values.append(self._value(i, out[1:]))
                if closest not in (t, -1):
                    out = self._fuse(idx, closest, i, self.prob[:, i], out, pos, neg)
                self.prob[:, i] = out

    def foreground(self, lo, hi) -> torch.Tensor:
        """[hi - lo, H, W] first object's probabilities, unpadded."""
        top, bot, left, right = self.hw_pad
        p = self.prob[1, lo:hi]
        return p[:, top:p.shape[1] - bot, left:p.shape[2] - right]


# ---------------------------------------------------------------- work

def work_units(config, num_objects: int = 1) -> dict:
    """{unit: callable} of the networks' work on meta tensors, for a
    count of operations: ``encode`` a frame's features, ``decode`` a
    frame from its readout, ``value`` one memory, ``fuse`` one frame
    (attention and FusionNet).  The read's operations depend on the bank
    and are reckoned apart (``read_flops``)."""
    arch, (h, w) = config["networks"], config["frame"]
    top, bot, left, right = pad16(h, w)
    nh, nw = h + top + bot, w + left + right
    k = num_objects
    with torch.device("meta"):
        net = PropagationNetwork(arch["keydim"], arch["value_dim"],
                                 arch["key_arch"], arch["value_arch"])
        fusion = FusionNet()
    ck, cv = arch["keydim"], arch["value_dim"]
    f16 = stage_widths(arch["key_arch"])[-1]
    hs, ws = nh // 16, nw // 16

    def meta(*shape):
        return torch.zeros(shape, device="meta")

    def fuse():
        a = torch.softmax(scores(meta(hs * ws, ck), meta(hs * ws, ck)), dim=1)
        meta(k, 2, hs * ws) @ a.T
        fusion(meta(3, nh, nw), meta(k, nh, nw), meta(k, nh, nw),
               meta(k, 2, nh, nw), meta(2))

    return {
        "encode": lambda: net.encode_key(meta(1, 3, nh, nw)),
        "decode": lambda: net.decode(meta(k, cv, hs, ws), meta(cv, hs, ws),
                                     meta(512, 2 * hs, 2 * ws),
                                     meta(256, 4 * hs, 4 * ws)),
        "value": lambda: net.encode_value(meta(3, nh, nw), meta(f16, hs, ws),
                                          meta(k, nh, nw)),
        "fuse": fuse,
    }


def read_flops(queries: int, memories: int, tokens: int, top_k: int,
               ck: int, cv: int, num_objects: int = 1) -> float:
    """Operations of one top-k read: the scores of ``queries`` queries
    against ``memories`` x ``tokens`` keys, and the weighted sum of
    ``top_k`` value rows a query and object."""
    m = memories * tokens
    return 2.0 * queries * m * ck + 2.0 * num_objects * queries * min(top_k, m) * cv


def templates(config) -> dict:
    """{network: its layout on the meta device}, for the seeded weights."""
    arch = config["networks"]
    with torch.device("meta"):
        return {"stcn": PropagationNetwork(arch["keydim"], arch["value_dim"],
                                           arch["key_arch"], arch["value_arch"]),
                "fusion": FusionNet()}
