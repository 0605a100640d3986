"""Whole-model rate estimate (port of ``gsvc_tpu/codec/estimate.py``;
reference: estimate_final_bits, scene/gaussian_model.py:1599-1725).

Runs on the state's device with static shapes: masked-out and padding
anchors weigh zero instead of being gathered out.  The entropy context
is one query over the whole anchor capacity — the largest launch of
kernel B3f.  This is the "estimated" tier of the reference's rate
telemetry (train-sampled / estimated / real, pipeline/train.py:153-261).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gsvc_tpu_torch.models.gaussians import (
    MLP_FIELDS, GaussianConfig, ModelState, Q_FEAT, Q_OFFSETS, Q_SCALING,
    calc_entropy_context, get_anchor, get_mask, get_mask_anchor, get_scaling,
)
from gsvc_tpu_torch.ops.entropy import binary_vxl_size, gaussian_bits
from gsvc_tpu_torch.ops.quant import ANCHOR_ROUND_DIGITS, CLAMP_BOUND, \
    ste_binary
from gsvc_tpu_torch.train.optim import tree_leaves


class EstimatedBits(NamedTuple):
    bit_anchor: float
    bit_feat: float
    bit_scaling: float
    bit_offsets: float
    bit_hash: float
    bit_masks: float
    bit_mlp: float

    @property
    def total(self):
        return (self.bit_anchor + self.bit_feat + self.bit_scaling
                + self.bit_offsets + self.bit_hash + self.bit_masks
                + self.bit_mlp)


def _mlp_bits(state: ModelState) -> float:
    n = sum(int(x.numel()) for f in MLP_FIELDS
            for x in tree_leaves(getattr(state.nets, f)))
    return float(n * 32)


@torch.no_grad()
def _estimate_device(state: ModelState, cfg: GaussianConfig):
    anchors = state.anchors
    k = cfg.n_offsets
    cap = anchors.anchor.shape[0]
    dev = anchors.anchor.device

    active = torch.arange(cap, device=dev) < state.n_active
    w_anchor = (get_mask_anchor(anchors) & active).to(torch.float32)
    w = w_anchor[:, None]

    ec = calc_entropy_context(state, cfg, get_anchor(state))
    q_feat = Q_FEAT * ec.q_feat_adj
    q_scaling = Q_SCALING * ec.q_scaling_adj
    q_offsets = Q_OFFSETS * ec.q_offsets_adj

    def rng_of(mean, q):
        c = torch.sum(mean * w) / torch.clamp(
            torch.sum(w) * mean.shape[-1], min=1.0) \
            / (torch.sum(q * w) / torch.clamp(torch.sum(w), min=1.0))
        c = torch.floor(c)
        return c - CLAMP_BOUND, c + CLAMP_BOUND

    f_lo, f_hi = rng_of(ec.mean_feat, q_feat)
    s_lo, s_hi = rng_of(ec.mean_scaling, q_scaling)
    o_lo, o_hi = rng_of(ec.mean_offsets, q_offsets)

    feat_sym = torch.clamp(torch.round(anchors.feat / q_feat), f_lo, f_hi)
    scaling_sym = torch.clamp(
        torch.round(get_scaling(anchors) / q_scaling), s_lo, s_hi)
    offsets_sym = torch.clamp(
        torch.round(anchors.offset.reshape(cap, 3 * k) / q_offsets),
        o_lo, o_hi)

    bit_feat = torch.sum(gaussian_bits(
        feat_sym, ec.mean_feat, ec.scale_feat, q_feat, quantized=True) * w)
    bit_scaling = torch.sum(gaussian_bits(
        scaling_sym, ec.mean_scaling, ec.scale_scaling, q_scaling,
        quantized=True) * w)
    mask = get_mask(anchors)
    mask3 = torch.repeat_interleave(mask[:, :, 0], 3, dim=-1).reshape(
        cap, 3 * k)
    bit_offsets = torch.sum(gaussian_bits(
        offsets_sym, ec.mean_offsets, ec.scale_offsets, q_offsets,
        quantized=True) * mask3 * w)

    bit_anchor = torch.sum(w_anchor) * 3 * ANCHOR_ROUND_DIGITS

    hash_bin = (ste_binary(state.nets.hash_table) + 1) / 2
    _, bit_hash, _, _ = binary_vxl_size(hash_bin)
    # mask bits over kept anchors only (weighted closed form)
    pos = torch.sum(mask[:, :, 0] * w)
    tot = torch.clamp(torch.sum(w) * k, min=1.0)
    p = torch.clamp(pos / tot, 1e-6, 1 - 1e-6)
    bit_masks = pos * (-torch.log2(p)) + (tot - pos) * (-torch.log2(1 - p)) \
        + 32.0
    return (bit_anchor, bit_feat, bit_scaling, bit_offsets, bit_hash,
            bit_masks)


def estimate_final_bits(state: ModelState, cfg: GaussianConfig
                        ) -> EstimatedBits:
    """The estimated bits of every stream of the model, as host floats."""
    ba, bf, bs, bo, bh, bm = (float(v) for v in _estimate_device(state,
                                                                 cfg))
    return EstimatedBits(bit_anchor=ba, bit_feat=bf, bit_scaling=bs,
                         bit_offsets=bo, bit_hash=bh, bit_masks=bm,
                         bit_mlp=_mlp_bits(state))
