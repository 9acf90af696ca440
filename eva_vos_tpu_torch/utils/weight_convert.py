"""JAX parameter trees -> reference-layout PyTorch state dicts.

The port's own copy of the mapping that ``eva_vos_tpu/utils/weight_convert.py``
walks (``InverseConverter``, ``_walk_stcn``, ``_walk_fusion``):

* conv kernel HWIO -> OIHW weight; Dense kernel [in, out] -> [out, in]
* BatchNorm scale/bias -> weight/bias; batch_stats mean/var ->
  running_mean/running_var (and a zero ``num_batches_tracked``)

Inputs are the flax variable collections as nested dicts of numpy arrays
(``{"params": ..., "batch_stats": ...}``); outputs load into the port's
``PropagationNetwork`` / ``FusionNet`` with ``strict=True``.
"""

from __future__ import annotations

import numpy as np
import torch


class _Walker:
    def __init__(self, variables):
        self.params = variables["params"]
        self.stats = variables.get("batch_stats", {})
        self.sd: dict[str, torch.Tensor] = {}

    @staticmethod
    def _leaf(tree, path):
        for p in path:
            tree = tree[p]
        return np.asarray(tree, np.float32)

    def exists(self, path) -> bool:
        node = self.params
        for p in path:
            if p not in node:
                return False
            node = node[p]
        return True

    def _put(self, key, array):
        self.sd[key] = torch.from_numpy(np.ascontiguousarray(array))

    def conv(self, path, prefix, bias=True):
        self._put(f"{prefix}.weight",
                  self._leaf(self.params, (*path, "kernel")).transpose(3, 2, 0, 1))
        if bias:
            self._put(f"{prefix}.bias", self._leaf(self.params, (*path, "bias")))

    def linear(self, path, prefix):
        self._put(f"{prefix}.weight", self._leaf(self.params, (*path, "kernel")).T)
        self._put(f"{prefix}.bias", self._leaf(self.params, (*path, "bias")))

    def batchnorm(self, path, prefix):
        self._put(f"{prefix}.weight", self._leaf(self.params, (*path, "scale")))
        self._put(f"{prefix}.bias", self._leaf(self.params, (*path, "bias")))
        self._put(f"{prefix}.running_mean", self._leaf(self.stats, (*path, "mean")))
        self._put(f"{prefix}.running_var", self._leaf(self.stats, (*path, "var")))
        self.sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


_LAYERS = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3),
           "resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}
_BOTTLENECK = {"resnet50", "resnet101"}


def _trunk(w: _Walker, flax_prefix, torch_prefix, arch, num_stages, conv_bias,
           stage_names):
    w.conv((*flax_prefix, "conv1"), f"{torch_prefix}.conv1", bias=conv_bias)
    w.batchnorm((*flax_prefix, "bn1", "bn"), f"{torch_prefix}.bn1")
    n_convs = 3 if arch in _BOTTLENECK else 2
    for s in range(num_stages):
        for b in range(_LAYERS[arch][s]):
            fb = (*flax_prefix, f"layer{s + 1}_{b}")
            tb = f"{torch_prefix}.{stage_names[s]}.{b}"
            for ci in range(1, n_convs + 1):
                w.conv((*fb, f"conv{ci}"), f"{tb}.conv{ci}", bias=conv_bias)
                w.batchnorm((*fb, f"bn{ci}", "bn"), f"{tb}.bn{ci}")
            if w.exists((*fb, "downsample_conv")):
                w.conv((*fb, "downsample_conv"), f"{tb}.downsample.0",
                       bias=conv_bias)
                w.batchnorm((*fb, "downsample_bn", "bn"), f"{tb}.downsample.1")


def _resblock(w: _Walker, flax_prefix, torch_prefix):
    w.conv((*flax_prefix, "conv1"), f"{torch_prefix}.conv1")
    w.conv((*flax_prefix, "conv2"), f"{torch_prefix}.conv2")
    if w.exists((*flax_prefix, "downsample")):
        w.conv((*flax_prefix, "downsample"), f"{torch_prefix}.downsample")


def stcn_state_dict_from_flax(variables, key_arch: str = "resnet50",
                              value_arch: str = "resnet18") -> dict:
    """JAX ``PropagationNetwork`` variables -> reference STCN state dict."""
    w = _Walker(variables)
    _trunk(w, ("key_encoder", "trunk"), "key_encoder", key_arch, 3, False,
           ["res2", "layer2", "layer3"])
    _trunk(w, ("value_encoder", "trunk"), "value_encoder", value_arch, 3, True,
           ["layer1", "layer2", "layer3"])
    fuser = ("value_encoder", "fuser")
    _resblock(w, (*fuser, "block1"), "value_encoder.fuser.block1")
    att = (*fuser, "attention")
    w.linear((*att, "channel_gate", "mlp_1"),
             "value_encoder.fuser.attention.ChannelGate.mlp.1")
    w.linear((*att, "channel_gate", "mlp_2"),
             "value_encoder.fuser.attention.ChannelGate.mlp.3")
    w.conv((*att, "spatial_gate", "spatial"),
           "value_encoder.fuser.attention.SpatialGate.spatial.conv")
    _resblock(w, (*fuser, "block2"), "value_encoder.fuser.block2")
    w.conv(("key_proj", "key_proj"), "key_proj.key_proj")
    w.conv(("key_comp",), "key_comp")
    _resblock(w, ("decoder", "compress"), "decoder.compress")
    for up in ("up_16_8", "up_8_4"):
        w.conv(("decoder", up, "skip_conv"), f"decoder.{up}.skip_conv")
        _resblock(w, ("decoder", up, "out_conv"), f"decoder.{up}.out_conv")
    w.conv(("decoder", "pred"), "decoder.pred")
    return w.sd


def fusion_state_dict_from_flax(variables) -> dict:
    """JAX ``FusionNet`` variables -> reference FusionNet state dict."""
    w = _Walker(variables)
    for flax_name, torch_name in (("conv1", "conv1.0"), ("conv2_0", "conv2.0"),
                                  ("conv2_1", "conv2.2"), ("conv3_0", "conv3.0"),
                                  ("conv3_1", "conv3.2"),
                                  ("final_conv", "final_conv")):
        w.conv((flax_name,), torch_name)
    return w.sd
