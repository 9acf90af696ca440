"""JAX parameter trees -> reference-layout PyTorch state dicts.

The port's own copy of the mapping that ``eva_vos_tpu/utils/weight_convert.py``
walks (``InverseConverter``, ``_walk_stcn``, ``_walk_fusion``):

* conv kernel HWIO -> OIHW weight; Dense kernel [in, out] -> [out, in]
* ConvTranspose kernel [kh, kw, in, out] -> [in, out, kh, kw] with the
  spatial taps flipped (torch's transposed conv correlates with the flipped
  kernel)
* BatchNorm scale/bias -> weight/bias; batch_stats mean/var ->
  running_mean/running_var (and a zero ``num_batches_tracked``)
* LayerNorm scale/bias -> weight/bias
* Flax ``MultiHeadDotProductAttention`` (query/key/value kernels
  [D, heads, head_dim], out kernel [heads, head_dim, D]) -> a packed
  [3D, D] in-projection and an out projection

Inputs are the flax variable collections as nested dicts of numpy arrays
(``{"params": ..., "batch_stats": ...}``); outputs load into the port's
modules with ``strict=True``: ``PropagationNetwork``, ``FusionNet``,
``QualityNet``, ``ActorCritic``, ``ResNetTrunk`` / ``ViTEncoder`` (the
feature extractors, in the torchvision and DINOv2 layouts) and ``Sam``.
Each mapping is the inverse of one JAX converter (``convert_qnet``,
``convert_actor_critic``, ``convert_tv_resnet``, ``convert_tv_vit``,
``convert_dinov2``, ``convert_sam``), which reads the same layout.
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

    def _node(self, path):
        node = self.params
        for p in path:
            node = node[p]
        return node

    def exists(self, path) -> bool:
        node = self.params
        for p in path:
            if p not in node:
                return False
            node = node[p]
        return True

    def _put(self, key, array):
        self.sd[key] = torch.tensor(np.ascontiguousarray(array))

    def raw(self, path, key):
        self._put(key, self._leaf(self.params, path))

    def layernorm(self, path, prefix):
        self._put(f"{prefix}.weight", self._leaf(self.params, (*path, "scale")))
        self._put(f"{prefix}.bias", self._leaf(self.params, (*path, "bias")))

    def conv_transpose(self, path, prefix):
        k = self._leaf(self.params, (*path, "kernel"))
        self._put(f"{prefix}.weight", k[::-1, ::-1].transpose(2, 3, 0, 1))
        self._put(f"{prefix}.bias", self._leaf(self.params, (*path, "bias")))

    def dense_general(self, path, prefix):
        """A Flax attention projection ([D, H, Dh] in or [H, Dh, D] out) as
        a torch Linear."""
        k = self._leaf(self.params, (*path, "kernel"))
        if path[-1] == "out":
            k = k.reshape(-1, k.shape[-1])
        else:
            k = k.reshape(k.shape[0], -1)
        self._put(f"{prefix}.weight", k.T)
        self._put(f"{prefix}.bias",
                  self._leaf(self.params, (*path, "bias")).reshape(-1))

    def mha_packed(self, path):
        """(in_proj weight [3D, D], in_proj bias [3D], out weight, out bias)."""
        ws, bs = [], []
        for name in ("query", "key", "value"):
            k = self._leaf(self.params, (*path, name, "kernel"))
            ws.append(k.reshape(k.shape[0], -1).T)
            bs.append(self._leaf(self.params, (*path, name, "bias")).reshape(-1))
        ko = self._leaf(self.params, (*path, "out", "kernel"))
        return (np.concatenate(ws, 0), np.concatenate(bs, 0),
                ko.reshape(-1, ko.shape[-1]).T,
                self._leaf(self.params, (*path, "out", "bias")))

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


def _key(prefix, name):
    return f"{prefix}.{name}" if prefix else name


def _trunk(w: _Walker, flax_prefix, torch_prefix, arch, num_stages, conv_bias,
           stage_names=None):
    stage_names = stage_names or [f"layer{s + 1}" for s in range(num_stages)]
    w.conv((*flax_prefix, "conv1"), _key(torch_prefix, "conv1"), bias=conv_bias)
    w.batchnorm((*flax_prefix, "bn1", "bn"), _key(torch_prefix, "bn1"))
    n_convs = 3 if arch in _BOTTLENECK else 2
    for s in range(num_stages):
        for b in range(_LAYERS[arch][s]):
            fb = (*flax_prefix, f"layer{s + 1}_{b}")
            tb = _key(torch_prefix, f"{stage_names[s]}.{b}")
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


# ---------------------------------------------------------------------------
# decision models and feature extractors
# ---------------------------------------------------------------------------

def _cnn_branch(w: _Walker, flax_prefix, torch_prefix, arch):
    """``CNNBranch``: 'small' is a ResNet-50 trunk cut at layer3."""
    _trunk(w, (*flax_prefix, "trunk"), torch_prefix,
           "resnet50" if arch == "small" else arch,
           3 if arch == "small" else 4, False)


def qnet_state_dict_from_flax(variables, arch: str = "resnet18") -> dict:
    """JAX ``QualityNet`` variables -> reference QNet state dict (the
    ``attn`` merge's projections in the JAX module's own layout)."""
    w = _Walker(variables)
    _cnn_branch(w, ("rgb_branch",), "rgb_branch", arch)
    _cnn_branch(w, ("mask_branch",), "mask_branch", arch)
    if w.exists(("attn_mod",)):
        for proj in ("query_proj", "key_proj", "value_proj"):
            w.linear((proj,), proj)
        for proj in ("query", "key", "value", "out"):
            w.dense_general(("attn_mod", proj), f"attn_mod.{proj}")
    w.linear(("out_layer",), "out_layer")
    return w.sd


def _vit_depth_heads(w: _Walker, flax_prefix):
    depth = sum(1 for k in w._node(flax_prefix) if k.startswith("block_"))
    heads = w._node((*flax_prefix, "block_0", "attn", "query"))["kernel"].shape[1]
    return depth, heads


def tv_vit_state_dict_from_flax(variables, flax_prefix=(), torch_prefix=""):
    """JAX ``ViTEncoder`` variables -> torchvision ``VisionTransformer``
    state dict (without the classification head)."""
    w = _Walker(variables)
    _tv_vit(w, tuple(flax_prefix), torch_prefix)
    return w.sd


def _tv_vit(w: _Walker, fp, tp):
    depth, _ = _vit_depth_heads(w, fp)
    w.conv((*fp, "patch_embed"), _key(tp, "conv_proj"))
    w.raw((*fp, "cls_token"), _key(tp, "class_token"))
    w.raw((*fp, "pos_embed"), _key(tp, "encoder.pos_embedding"))
    for i in range(depth):
        fb = (*fp, f"block_{i}")
        tb = _key(tp, f"encoder.layers.encoder_layer_{i}")
        w.layernorm((*fb, "norm1"), f"{tb}.ln_1")
        wi, bi, wo, bo = w.mha_packed((*fb, "attn"))
        w._put(f"{tb}.self_attention.in_proj_weight", wi)
        w._put(f"{tb}.self_attention.in_proj_bias", bi)
        w._put(f"{tb}.self_attention.out_proj.weight", wo)
        w._put(f"{tb}.self_attention.out_proj.bias", bo)
        w.layernorm((*fb, "norm2"), f"{tb}.ln_2")
        w.linear((*fb, "mlp_lin1"), f"{tb}.mlp.0")
        w.linear((*fb, "mlp_lin2"), f"{tb}.mlp.3")
    w.layernorm((*fp, "norm"), _key(tp, "encoder.ln"))


def dinov2_state_dict_from_flax(variables) -> dict:
    """JAX ``ViTEncoder(layerscale=True)`` variables -> DINOv2 state dict
    (its ``mask_token``, unused at inference, as zeros)."""
    w = _Walker(variables)
    depth, _ = _vit_depth_heads(w, ())
    w.conv(("patch_embed",), "patch_embed.proj")
    w.raw(("cls_token",), "cls_token")
    w.raw(("pos_embed",), "pos_embed")
    w._put("mask_token", np.zeros((1, w._leaf(w.params, ("cls_token",)).shape[-1]),
                                  np.float32))
    for i in range(depth):
        fb, tb = (f"block_{i}",), f"blocks.{i}"
        w.layernorm((*fb, "norm1"), f"{tb}.norm1")
        wi, bi, wo, bo = w.mha_packed((*fb, "attn"))
        w._put(f"{tb}.attn.qkv.weight", wi)
        w._put(f"{tb}.attn.qkv.bias", bi)
        w._put(f"{tb}.attn.proj.weight", wo)
        w._put(f"{tb}.attn.proj.bias", bo)
        w.raw((*fb, "gamma1"), f"{tb}.ls1.gamma")
        w.layernorm((*fb, "norm2"), f"{tb}.norm2")
        w.linear((*fb, "mlp_lin1"), f"{tb}.mlp.fc1")
        w.linear((*fb, "mlp_lin2"), f"{tb}.mlp.fc2")
        w.raw((*fb, "gamma2"), f"{tb}.ls2.gamma")
    w.layernorm(("norm",), "norm")
    return w.sd


def tv_resnet_state_dict_from_flax(variables, arch: str = "resnet18") -> dict:
    """JAX ``ResNetTrunk(num_stages=4)`` variables -> torchvision ResNet
    state dict (without ``fc``: the extractor reads layer4)."""
    w = _Walker(variables)
    _trunk(w, (), "", arch, 4, False)
    return w.sd


def actor_critic_state_dict_from_flax(variables, arch: str = "resnet18") -> dict:
    """JAX ``ActorCritic`` variables -> reference actor-critic state dict."""
    w = _Walker(variables)
    if "vit" in arch:
        _tv_vit(w, ("mask_branch",), "mask_branch")
    else:
        _cnn_branch(w, ("mask_branch",), "mask_branch", arch)
    w.linear(("embed_proj",), "embed_branch.2")
    if w.exists(("cost_proj",)):
        w.linear(("cost_proj",), "cost_branch.0")
    w.linear(("policy",), "policy")
    w.linear(("value",), "value")
    return w.sd


# ---------------------------------------------------------------------------
# SAM (the official segment-anything layout)
# ---------------------------------------------------------------------------

def sam_state_dict_from_flax(variables) -> dict:
    """JAX ``Sam`` variables -> official segment-anything state dict."""
    w = _Walker(variables)
    enc = ("image_encoder",)
    w.conv((*enc, "patch_embed"), "image_encoder.patch_embed.proj")
    if w.exists((*enc, "pos_embed")):
        w.raw((*enc, "pos_embed"), "image_encoder.pos_embed")
    depth = sum(1 for k in w._node(enc) if k.startswith("block_"))
    for i in range(depth):
        fb, tb = (*enc, f"block_{i}"), f"image_encoder.blocks.{i}"
        w.layernorm((*fb, "norm1"), f"{tb}.norm1")
        w.layernorm((*fb, "norm2"), f"{tb}.norm2")
        w.linear((*fb, "attn", "qkv"), f"{tb}.attn.qkv")
        w.linear((*fb, "attn", "proj"), f"{tb}.attn.proj")
        w.raw((*fb, "attn", "rel_pos_h"), f"{tb}.attn.rel_pos_h")
        w.raw((*fb, "attn", "rel_pos_w"), f"{tb}.attn.rel_pos_w")
        w.linear((*fb, "mlp", "lin1"), f"{tb}.mlp.lin1")
        w.linear((*fb, "mlp", "lin2"), f"{tb}.mlp.lin2")
    w.conv((*enc, "neck_conv1"), "image_encoder.neck.0", bias=False)
    w.layernorm((*enc, "neck_ln1"), "image_encoder.neck.1")
    w.conv((*enc, "neck_conv2"), "image_encoder.neck.2", bias=False)
    w.layernorm((*enc, "neck_ln2"), "image_encoder.neck.3")

    pe, tp = ("prompt_encoder",), "prompt_encoder"
    w.raw((*pe, "pe_layer", "positional_encoding_gaussian_matrix"),
          f"{tp}.pe_layer.positional_encoding_gaussian_matrix")
    points = w._leaf(w.params, (*pe, "point_embeddings"))
    for i in range(points.shape[0]):
        w._put(f"{tp}.point_embeddings.{i}.weight", points[i:i + 1])
    w.raw((*pe, "not_a_point_embed"), f"{tp}.not_a_point_embed.weight")
    w.raw((*pe, "no_mask_embed"), f"{tp}.no_mask_embed.weight")
    w.conv((*pe, "mask_conv1"), f"{tp}.mask_downscaling.0")
    w.layernorm((*pe, "mask_ln1"), f"{tp}.mask_downscaling.1")
    w.conv((*pe, "mask_conv2"), f"{tp}.mask_downscaling.3")
    w.layernorm((*pe, "mask_ln2"), f"{tp}.mask_downscaling.4")
    w.conv((*pe, "mask_conv3"), f"{tp}.mask_downscaling.6")

    md, tp = ("mask_decoder",), "mask_decoder"
    w.raw((*md, "iou_token"), f"{tp}.iou_token.weight")
    w.raw((*md, "mask_tokens"), f"{tp}.mask_tokens.weight")
    tr = (*md, "transformer")
    decoder_depth = sum(1 for k in w._node(tr) if k.startswith("layer_"))
    for i in range(decoder_depth):
        fb, tb = (*tr, f"layer_{i}"), f"{tp}.transformer.layers.{i}"
        for attn in ("self_attn", "cross_attn_token_to_image",
                     "cross_attn_image_to_token"):
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                w.linear((*fb, attn, proj), f"{tb}.{attn}.{proj}")
        for norm in ("norm1", "norm2", "norm3", "norm4"):
            w.layernorm((*fb, norm), f"{tb}.{norm}")
        w.linear((*fb, "mlp_lin1"), f"{tb}.mlp.lin1")
        w.linear((*fb, "mlp_lin2"), f"{tb}.mlp.lin2")
    for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
        w.linear((*tr, "final_attn_token_to_image", proj),
                 f"{tp}.transformer.final_attn_token_to_image.{proj}")
    w.layernorm((*tr, "norm_final_attn"), f"{tp}.transformer.norm_final_attn")
    w.conv_transpose((*md, "upscale_conv1"), f"{tp}.output_upscaling.0")
    w.layernorm((*md, "upscale_ln"), f"{tp}.output_upscaling.1")
    w.conv_transpose((*md, "upscale_conv2"), f"{tp}.output_upscaling.3")
    n_tokens = sum(1 for k in w._node(md)
                   if k.startswith("output_hypernetworks_mlps_"))
    for i in range(n_tokens):
        for j in range(3):
            w.linear((*md, f"output_hypernetworks_mlps_{i}", f"layers_{j}"),
                     f"{tp}.output_hypernetworks_mlps.{i}.layers.{j}")
    for j in range(3):
        w.linear((*md, "iou_prediction_head", f"layers_{j}"),
                 f"{tp}.iou_prediction_head.layers.{j}")
    return w.sd
