"""STCN propagation engine (counterpart of ``eva_vos_tpu/engine/propagation.py``).

Interact with a frame, propagate forward and backward to the nearest
previously interacted frames, admit a memory entry every ``mem_freq``
frames, and fuse with the prior prediction on frames between two interacted
frames (the reference's ``mivos/inference_core.py``).

As in the JAX engine:

* per-frame backbone features are computed once per video
  (``precompute_features``), including the decoder's readout-independent
  skip convolutions;
* the memory bank is a fixed-size token-major buffer: slots below
  ``certain_count`` hold one memory per interaction, the slots after them the
  current pass's transient memories, and the read masks every token past the
  fill;
* with ``block_frames`` the ``mem_freq`` frames between two admissions,
  which read one frozen bank, are segmented in one batched step, and the
  frames after the last full block run one at a time;
* with ``readout_strategy="sharded"`` and a ``mesh`` the bank's slots are
  sharded contiguously across the mesh's ranks, each rank allocating and
  writing only its own, and the read is
  ``parallel.sharded_memory_readout``; the features, the decoder,
  FusionNet and the probabilities are replicated on every rank.

PyTorch runs eagerly, so the passes are Python loops over host integers.
The state's tensors are updated in place on a copy (``donate=False``, the
default: lookahead policies interact many times from one state) or in place
on the caller's state (``donate=True``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels.config import KernelConfig
from ..models.fused_trunk import FusedTrunk
from ..ops.aggregate import aggregate_wbg
from ..ops.memory_attention import memory_readout, resolve_strategy
from ..ops.normalize import im_normalize
from ..ops.padding import compute_pad, pad_hw, unpad_hw
from ..parallel.sharded_attention import sharded_memory_readout
from ..utils.profiling import TRACE


class VideoFeatures(NamedTuple):
    """Per-video tensors at the padded resolution (channel-last).

    ``f8``/``f4`` hold the decoder's skip-conv OUTPUTS (``encode_skips``)."""

    images: torch.Tensor     # [T, nh, nw, 3] normalised frames
    k16: torch.Tensor        # [T, hw, CK] key tokens
    f16_thin: torch.Tensor   # [T, h, w, CV]
    f16: torch.Tensor        # [T, h, w, C16]
    f8: torch.Tensor         # [T, h8, w8, 512]
    f4: torch.Tensor         # [T, h4, w4, 256]


class PropagationState(NamedTuple):
    prob: torch.Tensor        # [K+1, T, nh, nw] fp32
    bank_k: torch.Tensor      # [Mmax, hw, CK]
    bank_v: torch.Tensor      # [K, Mmax, hw, CV] (object-major)
    certain_count: int        # slots < certain_count are permanent
    interacted: np.ndarray    # [T] bool


class EngineConfig(NamedTuple):
    mem_freq: int = 5
    top_k: int = 50
    max_interactions: int = 64
    feature_chunk: int = 4          # frames per encode_key step in precompute
    readout_strategy: str = "auto"  # 'auto': 'fused' (the CUDA kernels) on
    #   a CUDA device, 'gather' (the plain read) on the CPU; 'select' (the
    #   split-bank selection kernel + gather) and 'scatter' too; 'sharded'
    #   (never 'auto''s choice): the bank sharded over the engine's mesh
    block_frames: bool = True       # batch the mem_freq frames between
    #                                 memory admissions (same results)
    kernels: KernelConfig | None = None  # the 'fused' read's kernels; None:
    #   KernelConfig.from_env() (the EVAVOS_* variables), once, at engine
    #   construction


class InferenceEngine:
    """Host-side orchestrator of the propagation passes.

    stcn: a ``PropagationNetwork``; fusion: a ``FusionNet``, or None to keep
    the fresh prediction between interacted frames instead of fusing.
    Both are moved to ``device`` (by default the mesh's device, else
    'cuda') and set to eval mode.  ``mesh``: a ``parallel.Mesh``, which
    the 'sharded' read needs.
    """

    def __init__(self, stcn, fusion, config: EngineConfig = EngineConfig(),
                 device=None, mesh=None):
        if config.readout_strategy == "sharded" and mesh is None:
            raise ValueError("readout_strategy='sharded' needs a mesh")
        self.mesh = mesh
        if device is None:
            device = "cuda" if mesh is None else mesh.device
        self.device = torch.device(device)
        self.stcn = stcn.to(self.device).eval()
        self.fusion = None if fusion is None else fusion.to(self.device).eval()
        kernels = (KernelConfig.from_env() if config.kernels is None
                   else config.kernels.checked())
        self.config = config._replace(
            readout_strategy=resolve_strategy(config.readout_strategy,
                                              self.device),
            kernels=kernels)
        self._sharded = self.config.readout_strategy == "sharded"
        self._trunks = (None, None)   # FusedTrunks of the key, value encoders

    # ------------------------------------------------------------------
    # feature precompute
    # ------------------------------------------------------------------
    @torch.no_grad()
    def precompute_features(self, images) -> VideoFeatures:
        """images [T, nh, nw, 3] (padded, normalised) -> VideoFeatures."""
        parts = []
        chunk = self.config.feature_chunk
        with TRACE.span("engine.precompute"):
            self._fold_trunks()
            for lo in range(0, images.shape[0], chunk):
                f = self.stcn.encode_key(images[lo:lo + chunk],
                                         self._trunks[0])
                skip8, skip4 = self.stcn.encode_skips(f.f8, f.f4)
                parts.append((f.k16.flatten(1, 2), f.f16_thin, f.f16, skip8,
                              skip4))
            k16, f16_thin, f16, f8, f4 = (torch.cat(p) for p in zip(*parts))
        TRACE.count("frames_encoded", images.shape[0])
        return VideoFeatures(images=images, k16=k16, f16_thin=f16_thin,
                             f16=f16, f8=f8, f4=f4)

    def _fold_trunks(self):
        """Fold the key and value encoders' trunks (``FusedTrunk``) again
        when the network no longer holds the tensors of the last fold, or
        has written them (``load_state_dict`` copies into them); run the
        trunks themselves while the network trains, which needs
        BatchNorm's batch statistics.  Once an open, not once a call."""
        encoders = (self.stcn.key_encoder, self.stcn.value_encoder)
        if any(e.training for e in encoders):
            self._trunks = (None, None)
        elif not all(f is not None and f.current(e)
                     for f, e in zip(self._trunks, encoders)):
            self._trunks = tuple(FusedTrunk(e) for e in encoders)
            TRACE.count("trunk_folds")
            TRACE.count("bn_folded", sum(f.bn_folded for f in self._trunks))

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------
    def init_state(self, feats: VideoFeatures,
                   num_objects: int) -> PropagationState:
        t, hw, ck = feats.k16.shape
        nh, nw = feats.images.shape[1:3]
        cfg = self.config
        n_transient = max(0, t - 2) // cfg.mem_freq + 1
        mmax = cfg.max_interactions + n_transient
        if self._sharded:
            # the slots shard contiguously: this rank holds mmax / S of them
            mmax = -(-mmax // self.mesh.size)
        cv = self.stcn.value_dim
        dev, dtype = feats.k16.device, feats.k16.dtype
        prob = torch.zeros((num_objects + 1, t, nh, nw), dtype=torch.float32,
                           device=dev)
        prob[0] = 1e-7
        return PropagationState(
            prob=prob,
            bank_k=torch.zeros((mmax, hw, ck), dtype=dtype, device=dev),
            bank_v=torch.zeros((num_objects, mmax, hw, cv), dtype=dtype,
                               device=dev),
            certain_count=0,
            interacted=np.zeros((t,), dtype=bool))

    # ------------------------------------------------------------------
    # one interaction
    # ------------------------------------------------------------------
    def _segment_frames(self, feats, bank_k, bank_v, front, tis):
        """Top-k memory read + decode of frames ``tis`` against one bank
        -> [B, K, nh, nw] probabilities."""
        mmax, hw, ck = bank_k.shape
        k_obj, cv = bank_v.shape[0], bank_v.shape[-1]
        b = len(tis)
        qk = feats.k16[tis].reshape(b * hw, ck)
        mk = bank_k.reshape(mmax * hw, ck)
        mv = bank_v.reshape(k_obj, mmax * hw, cv)
        with TRACE.span("engine.read"):
            if self._sharded:
                top_k = min(self.config.top_k, self.mesh.size * mmax * hw)
                readout = sharded_memory_readout(
                    mk, qk, mv, top_k, self.mesh, valid_tokens=front * hw,
                    kernel_cfg=self.config.kernels)
            else:
                readout = memory_readout(
                    mk, qk, mv, top_k=min(self.config.top_k, mmax * hw),
                    valid_tokens=front * hw,
                    strategy=self.config.readout_strategy,
                    kernel_cfg=self.config.kernels)
        TRACE.count("reads")
        TRACE.count("read_valid_tokens", front * hw)
        h16, w16 = feats.f16_thin.shape[1:3]
        readout = readout.reshape(k_obj, b, h16, w16, cv).transpose(0, 1)
        with TRACE.span("engine.decode"):
            return self.stcn.decode_with_readout(
                readout, feats.f16_thin[tis], feats.f8[tis], feats.f4[tis],
                skips_precomputed=True)

    def _fuse_frame(self, feats, prob_prev, prob_curr, attn, tc, tr, ti):
        """FusionNet blend of the prior and current prediction of frame ti.

        prob_prev/prob_curr [K+1, nh, nw], attn [K, nh, nw, 2]
        (``inference_core.py:193-207``)."""
        # fp32 division, as the JAX engine computes the distances
        dist = (torch.tensor([abs(tc - ti), abs(tr - ti)], dtype=torch.float32)
                / torch.tensor(abs(tc - tr), dtype=torch.float32))
        im = feats.images[ti]
        dtype = im.dtype
        logit = self.fusion(im, prob_prev[1:].to(dtype), prob_curr[1:].to(dtype),
                            attn, dist.to(device=im.device, dtype=dtype))
        return aggregate_wbg(torch.sigmoid(logit.float()), keep_bg=True)

    def _blend(self, feats, prob, out, tis, ctx):
        """New probability columns [B, K+1, nh, nw] for frames ``tis``:
        fused with the prior prediction between two interacted frames."""
        key_k16, pos_diff, neg_diff, closest, idx = ctx
        t = feats.k16.shape[0]
        if self.fusion is None or closest in (t, -1):
            return out
        h16, w16 = feats.f16_thin.shape[1:3]
        fused = []
        for j, ti in enumerate(tis):
            with TRACE.span("engine.fuse"):
                attn = self.stcn.get_attention(
                    key_k16, pos_diff, neg_diff,
                    feats.k16[ti].reshape(h16, w16, -1))
                fused.append(self._fuse_frame(feats, prob[:, ti], out[j],
                                              attn, closest, idx, ti))
        TRACE.count("frames_fused", len(tis))
        return torch.stack(fused)

    def _store(self, feats, state, front, ti, masks):
        """Admit frame ti (object masks [K, nh, nw]) into bank slot ``front``
        (on a sharded bank: on the rank that owns the slot, alone)."""
        TRACE.count("memories_stored")
        with TRACE.span("engine.store"):
            if self._sharded:
                owned = state.bank_k.shape[0]
                if front // owned != self.mesh.rank:
                    return
                front -= self.mesh.rank * owned
            state.bank_k[front] = feats.k16[ti]
            value = self.stcn.encode_value(feats.images[ti], feats.f16[ti],
                                           masks.to(state.bank_v.dtype),
                                           self._trunks[1])
            state.bank_v[:, front] = value.flatten(1, 2)       # [K, hw, CV]

    def _do_pass(self, feats, state, ctx, forward: bool):
        """One directional pass from ``idx`` towards ``closest``.

        A memory is admitted every ``mem_freq`` frames, never at the pass's
        end frame (``inference_core.py:126-191``).  With ``block_frames``
        the frames between two admissions read one frozen bank, so each
        full ``mem_freq`` block is segmented in one batched step; the frames
        after the last full block never admit memory and run one at a time.
        """
        _, _, _, closest, idx = ctx
        mem_freq = self.config.mem_freq
        bsz = mem_freq if self.config.block_frames else 1
        n_steps = max(closest - idx - 1 if forward else idx - closest - 1, 0)
        end = closest - 1 if forward else closest + 1
        n_full = n_steps // bsz
        groups = ([range(b * bsz, (b + 1) * bsz) for b in range(n_full)]
                  + [range(s, s + 1) for s in range(n_full * bsz, n_steps)])
        front = state.certain_count
        for steps in groups:
            tis = [idx + 1 + s if forward else idx - 1 - s for s in steps]
            TRACE.count("frames_segmented", len(tis))
            TRACE.count("steps_blocked" if len(tis) > 1 else "steps_single")
            with TRACE.span("engine.step"):
                out = self._segment_frames(feats, state.bank_k, state.bank_v,
                                           front, tis)
                out = aggregate_wbg(out.transpose(0, 1).float(),
                                    keep_bg=True).transpose(0, 1)
                if (steps[-1] + 1) % mem_freq == 0 and tis[-1] != end:
                    self._store(feats, state, front, tis[-1], out[-1, 1:])
                    front += 1
                new = self._blend(feats, state.prob, out, tis, ctx)
                state.prob[:, tis] = new.transpose(0, 1)

    @torch.no_grad()
    def interact(self, state: PropagationState, feats: VideoFeatures, mask,
                 idx: int, donate: bool = False) -> PropagationState:
        """mask [K, nh, nw] float one-hot object masks (padded), idx int.

        ``donate=True`` updates the input state's tensors in place (no copy
        of the ~340 MB prob volume and bank at 480p/60 frames); the input
        state must not be used afterwards.  The default leaves it intact
        (it copies this rank's shard of a sharded bank).
        """
        cc = state.certain_count
        if cc >= self.config.max_interactions:
            raise ValueError(
                f"memory bank certain-slot capacity exhausted: {cc} "
                f"interactions recorded, EngineConfig.max_interactions="
                f"{self.config.max_interactions} - raise max_interactions "
                f"when creating the engine")
        with TRACE.span("engine.interact"):
            if not donate:
                state = state._replace(prob=state.prob.clone(),
                                       bank_k=state.bank_k.clone(),
                                       bank_v=state.bank_v.clone())
            t = feats.k16.shape[0]
            h16, w16 = feats.f16_thin.shape[1:3]
            interacted = state.interacted.copy()
            fwd_closest = min([j for j in range(idx + 1, t) if interacted[j]]
                              + [t])
            bwd_closest = max([j for j in range(idx) if interacted[j]] + [-1])
            interacted[idx] = True

            mask = mask.to(device=state.prob.device, dtype=torch.float32)
            # mask differences against the pre-update probability
            # (inference_core.py:222-224)
            diff = mask - state.prob[1:, idx]
            pos_diff = diff.clamp(0.0, 1.0)
            neg_diff = (-diff).clamp(0.0, 1.0)
            state.prob[0, idx] = 1.0 - mask.amax(dim=0)
            state.prob[1:, idx] = mask

            # the certain memory of this interaction
            self._store(feats, state, cc, idx, mask)
            state = state._replace(certain_count=cc + 1,
                                   interacted=interacted)

            key_k16 = feats.k16[idx].reshape(h16, w16, -1)
            for closest, forward in ((fwd_closest, True),
                                     (bwd_closest, False)):
                self._do_pass(feats, state,
                              (key_k16, pos_diff, neg_diff, closest, idx),
                              forward)
            return state

    # ------------------------------------------------------------------
    # host-side helpers
    # ------------------------------------------------------------------
    @staticmethod
    def masks_from_prob(prob, pad) -> np.ndarray:
        """prob [K+1, T, nh, nw] -> argmax object-id masks [T, H, W] uint8."""
        ids = torch.argmax(unpad_hw(prob, pad), dim=0).to(torch.uint8)
        return ids.cpu().numpy()


def prepare_video(images_01: np.ndarray, dtype=torch.float32, device="cuda"):
    """[T, H, W, 3] in [0,1] (float) or [0,255] (uint8) -> (padded,
    normalised tensor [T, nh, nw, 3] on ``device``, pad).

    uint8 input is moved as 1 byte per pixel and scaled on the device.
    """
    t, h, w, _ = images_01.shape
    pad = compute_pad(h, w, 16)
    x = torch.as_tensor(np.asarray(images_01), device=device)
    x = x.to(dtype) / 255.0 if x.dtype == torch.uint8 else x.to(dtype)
    return pad_hw(im_normalize(x), pad, h_axis=1, w_axis=2), pad


def pad_mask(mask: np.ndarray, pad, device="cuda") -> torch.Tensor:
    """[K, H, W] -> [K, nh, nw] zero-padded float32 on ``device``."""
    m = torch.as_tensor(np.asarray(mask, np.float32), device=device)
    return pad_hw(m, pad, h_axis=-2, w_axis=-1)
