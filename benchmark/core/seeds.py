"""Seeds and seeded weights.

Every input of a run comes from ``--seed``: one stream of numbers for each
named use (``derive``), so that adding a use changes no other.  Weights are
made on the device in the type they are served in, from one ``randn`` call
over all of a network's random leaves, and handed alike to the program and
to the reference.
"""

from __future__ import annotations

import math
import zlib

import numpy as np


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for the use ``tag`` of the run seeded ``seed`` (any
    whole number, negative or past 32 bits too)."""
    ss = np.random.SeedSequence([seed % 2 ** 64, zlib.crc32(tag.encode())])
    return int(ss.generate_state(2, np.uint32).astype(np.uint64)
               @ np.array([1, 2 ** 32], np.uint64)) & (2 ** 63 - 1)


def rng(seed: int, tag: str) -> np.random.Generator:
    return np.random.default_rng(derive(seed, tag))


def _leaves(template):
    """(name, shape, rule) of every parameter and buffer of ``template``:
    rule ('normal', std) draws N(0, std), ('fill', v) fills.  Conv and
    linear weights N(0, 1 / fan_in), biases 0, norm scales 1 and shifts 0,
    BatchNorm statistics (0, 1), embedding tables N(0, 1), other
    parameters N(0, std) with the std their module names in
    ``_param_std`` (0.02 where it names none; "ones" fills ones); other
    persistent buffers N(0, 1), or 0 where they count.  The rule of the
    port's ``models/init.py``."""
    import torch.nn as nn

    norms = (nn.LayerNorm, nn.BatchNorm2d, nn.GroupNorm)
    out = []
    for mod_name, sub in template.named_modules():
        prefix = f"{mod_name}." if mod_name else ""
        stds = getattr(sub, "_param_std", {})
        for name, p in sub.named_parameters(recurse=False):
            shape = tuple(p.shape)
            if isinstance(sub, norms) or getattr(sub, "is_norm", False):
                rule = ("fill", 1.0 if name == "weight" else 0.0)
            elif isinstance(sub, nn.Embedding):
                rule = ("normal", 1.0)
            elif name == "bias" or name.endswith("_bias"):
                rule = ("fill", 0.0)
            elif name == "weight" or name.endswith("_weight"):
                if isinstance(sub, nn.ConvTranspose2d):
                    fan_in = shape[0] * math.prod(shape[2:])
                else:
                    fan_in = math.prod(shape[1:])
                rule = ("normal", 1.0 / math.sqrt(fan_in))
            else:
                std = stds.get(name, 0.02)
                rule = (("fill", 1.0) if std == "ones" else
                        ("fill", 0.0) if std == 0.0 else ("normal", std))
            out.append((prefix + name, shape, rule))
        for name, b in sub.named_buffers(recurse=False):
            if isinstance(sub, nn.BatchNorm2d):
                value = {"running_mean": 0.0, "running_var": 1.0}.get(name)
                if value is not None:
                    out.append((prefix + name, tuple(b.shape), ("fill", value)))
                    continue
            if name in sub.state_dict():  # persistent: a random table
                # (SAM's Fourier features) N(0, 1), a counter 0
                rule = (("normal", 1.0) if b.is_floating_point()
                        else ("zeros", b.dtype))
                out.append((prefix + name, tuple(b.shape), rule))
    return out


def seeded_state_dict(template, seed: int, device, dtype) -> dict:
    """A state dict for modules laid out as ``template`` (which may live on
    the meta device), made on ``device`` from one generator seeded
    ``seed``; floating leaves in ``dtype``."""
    import torch

    leaves = _leaves(template)
    total = sum(math.prod(s) for _, s, r in leaves if r[0] == "normal")
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    sd, off = {}, 0
    for name, shape, (kind, arg) in leaves:
        n = math.prod(shape)
        if kind == "normal":
            t = (flat[off:off + n] * arg).reshape(shape).to(dtype)
            off += n
        elif kind == "fill":
            t = torch.full(shape, arg, device=device, dtype=dtype)
        else:
            t = torch.zeros(shape, device=device, dtype=arg)
        sd[name] = t
    return sd
