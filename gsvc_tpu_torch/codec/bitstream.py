"""Bitstream decoding — the host half of the decoder (port of
``EncodeMeta`` and ``conduct_decoding``, gsvc_tpu/codec/bitstream.py:394-545,
plus ``load_streams``, gsvc_tpu/utils/checkpoint.py:117).

  geometry (octree) -> masks & hash signs -> per-batch entropy context
  from the decoded anchors (codec/detctx.py, numpy float64) -> rANS
  attribute streams -> a decoded ModelState on the target device
  (activations bypassed, anchors z-sorted and padded for rendering).

Every quantity the encoder conditioned on is recomputed here with the
same host arithmetic over the same batch slicing, so the decode is
bit-exact to the JAX decoder's.
"""

from __future__ import annotations

import dataclasses
import os
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from gsvc_tpu_torch.codec.detctx import det_entropy_context, host_nets
from gsvc_tpu_torch.codec.hashctx import decode_hash_table
from gsvc_tpu_torch.codec.native import (
    decode_binary, decode_gaussian_symbols, decode_octree,
)
from gsvc_tpu_torch.codec.param_codec import decode_mlp_params
from gsvc_tpu_torch.codec.unpickle import restricted_loads
from gsvc_tpu_torch.models.gaussians import (
    AnchorState, GaussianConfig, ModelState, NetParams, Q_FEAT, Q_OFFSETS,
    Q_SCALING, map_tree,
)
from gsvc_tpu_torch.ops.quant import ANCHOR_ROUND_DIGITS

MAX_BATCH = 1000
STREAM_Z_INTERVAL = 0.01
# probability-parameter grid (reference: common/range_coder.py:20,31-43)
Q_PROBA = 1024.0


@dataclasses.dataclass
class EncodeMeta:
    """Side info shipped with the streams (utils/codec_utils.py:21-33);
    field for field the JAX package's ``EncodeMeta``."""

    total_anchor_num: int
    anchor_num: int
    batch_size: int
    anchor_interval: np.ndarray       # [1, 3] float32
    anchor_min: np.ndarray            # [1, 3] float32
    batch_ranges: List[Tuple]         # per batch: ((f_lo,f_hi),(s..),(o..))
    prob_hash: float
    prob_masks: float
    streaming: bool = False
    index_splits: Optional[List[Tuple[int, int]]] = None
    hash_fmt: int = 2
    model_config: Optional[dict] = None
    video_info: Optional[dict] = None   # {width, height, num_frames}


def load_streams(path_dir: str) -> Dict[str, bytes]:
    """Every file of a bitstream directory, by name."""
    streams = {}
    for name in os.listdir(path_dir):
        with open(os.path.join(path_dir, name), "rb") as f:
            streams[name] = f.read()
    return streams


def read_meta(streams: Dict[str, bytes]) -> EncodeMeta:
    return restricted_loads(zlib.decompress(streams["meta.bin"]))


def _quantize_proba(x: np.ndarray) -> np.ndarray:
    """Snap probability parameters to the 1/Q_PROBA grid (the +1e-6
    keeps sigma strictly positive)."""
    return np.round(np.asarray(x, np.float64) * Q_PROBA) / Q_PROBA + 1e-6


def _z_order_splits(anchors: np.ndarray, interval: float = STREAM_Z_INTERVAL):
    """Sort by (z, x, y) and split into z-interval bands
    (reorder_and_split, utils/encodings.py:827-861)."""
    order = np.lexsort((anchors[:, 1], anchors[:, 0], anchors[:, 2]))
    z = anchors[order, 2]
    z_lo = np.floor(z.min() / interval) * interval
    z_hi = np.ceil(z.max() / interval) * interval + 1e-10
    splits = []
    lb = z_lo
    while lb < z_hi:
        ub = lb + interval
        s = int(np.searchsorted(z, lb, side="left"))
        e = int(np.searchsorted(z, ub, side="left"))
        if e > s:
            splits.append((s, e))
        lb = ub
    return order, splits


def _decode_batch(streams, s, ec, cfg, rng3, mask_b):
    """Dequantized (feat [nb,F], scaling [nb,6], offsets [nb,3K]) of batch
    ``s``; offsets of masked-out gaussians stay 0."""
    k = cfg.n_offsets
    nb = mask_b.shape[0]

    def dec(name, mean, scale, q, rng, shape, keep=None):
        q_b = np.broadcast_to(q, shape)
        mu = _quantize_proba((np.asarray(mean, np.float64) / q_b).ravel())
        sg = _quantize_proba((np.asarray(scale, np.float64) / q_b).ravel())
        qv = q_b.ravel()
        if keep is not None:
            mu, sg, qv = mu[keep], sg[keep], qv[keep]
        if mu.size == 0:
            return np.zeros(0, np.float64)
        sym = decode_gaussian_symbols(streams[f"{name}_{s}.b"], mu, sg,
                                      rng[0], rng[1])
        return sym.astype(np.float64) * qv

    f_rng, s_rng, o_rng = rng3
    qf = (Q_FEAT * ec.q_feat_adj).astype(np.float64)
    qs = (Q_SCALING * ec.q_scaling_adj).astype(np.float64)
    qo = (Q_OFFSETS * ec.q_offsets_adj).astype(np.float64)
    feat = dec("feat", ec.mean_feat, ec.scale_feat, qf, f_rng,
               (nb, cfg.feat_dim)).reshape(nb, cfg.feat_dim)
    scaling = dec("scaling", ec.mean_scaling, ec.scale_scaling, qs, s_rng,
                  (nb, 6)).reshape(nb, 6)
    m3 = np.repeat(mask_b, 3, axis=-1).reshape(nb, 3 * k).astype(bool)
    offsets = np.zeros((nb, 3 * k), np.float64)
    offsets[m3] = dec("offsets", ec.mean_offsets, ec.scale_offsets, qo,
                      o_rng, (nb, 3 * k), keep=m3.ravel())
    return feat, scaling, offsets


def conduct_decoding(streams: Dict[str, bytes], cfg: GaussianConfig,
                     template: ModelState, capacity: Optional[int] = None,
                     device="cpu"):
    """Decode streams into a render-ready ModelState on ``device``
    (decoded semantics: activations bypassed, anchors z-sorted).

    ``template`` (``models.gaussians.decode_template``) supplies the
    NetParams tree and the learned-bounds box.
    Returns (state, meta, seconds)."""
    t0 = time.time()
    meta = read_meta(streams)
    n = meta.anchor_num
    k = cfg.n_offsets

    nets = decode_mlp_params(streams["mlp.pkl"], template.nets)

    # geometry: two correctly rounded float32 numpy ops, as the encoder
    q_dec = decode_octree(streams["anchor.drc"], n, ANCHOR_ROUND_DIGITS)
    anchors_dec = (q_dec.astype(np.float32)
                   * np.asarray(meta.anchor_interval, np.float32)
                   + np.asarray(meta.anchor_min, np.float32)
                   ).astype(np.float32)

    spec = cfg.grid
    if getattr(meta, "hash_fmt", 1) >= 2:
        hash_bits = decode_hash_table(streams["hash.b"],
                                      spec.flat_level_sizes(),
                                      spec.n_features)
    else:  # global-Bernoulli streams
        hash_bits = decode_binary(
            streams["hash.b"], spec.total_rows * spec.n_features,
            meta.prob_hash).reshape(spec.total_rows, spec.n_features)
    hash_table = hash_bits.astype(np.float32) * 2 - 1
    mask_bits = decode_binary(streams["masks.b"], n * k, meta.prob_masks)
    masks = mask_bits.astype(np.float32).reshape(n, k, 1)
    nets = nets._replace(hash_table=torch.from_numpy(hash_table))

    if meta.streaming:
        z_order, _ = _z_order_splits(anchors_dec)
        anchors_ordered = anchors_dec[z_order]
        batches = meta.index_splits
    else:
        anchors_ordered = anchors_dec
        batches = [(lo, min(lo + MAX_BATCH, n))
                   for lo in range(0, n, MAX_BATCH)]

    feat_out = np.zeros((n, cfg.feat_dim), np.float32)
    scaling_out = np.zeros((n, 6), np.float32)
    offsets_out = np.zeros((n, k, 3), np.float32)
    hnets = host_nets(nets)
    for s, (lo, hi) in enumerate(batches):
        ec = det_entropy_context(hnets, template.x_bound_min,
                                 template.x_bound_max, cfg,
                                 anchors_ordered[lo:hi])
        feat, scaling, offsets = _decode_batch(
            streams, s, ec, cfg, meta.batch_ranges[s], masks[lo:hi, :, 0])
        feat_out[lo:hi] = feat
        scaling_out[lo:hi] = scaling
        offsets_out[lo:hi] = offsets.reshape(hi - lo, k, 3)

    if meta.streaming:
        # back from z-order to Morton order for a uniform layout
        inv = np.empty_like(z_order)
        inv[z_order] = np.arange(n)
        anchors_fin = anchors_ordered[inv]
        feat_fin, scaling_fin = feat_out[inv], scaling_out[inv]
        offsets_fin, masks_fin = offsets_out[inv], masks[inv]
    else:
        anchors_fin, feat_fin = anchors_ordered, feat_out
        scaling_fin, offsets_fin, masks_fin = scaling_out, offsets_out, masks

    # render-ready state: z-sorted + padded
    cap = max(capacity or meta.total_anchor_num, n)
    order = np.argsort(anchors_fin[:, 2], kind="stable")

    def pad(x, fill=0.0):
        out = np.full((cap,) + x.shape[1:], fill, np.float32)
        out[:n] = x[order]
        return torch.from_numpy(out).to(device)

    anchor_pad = np.zeros((cap, 3), np.float32)
    anchor_pad[:n] = anchors_fin[order]
    anchor_pad[n:, 2] = 1e9
    rot = np.zeros((n, 4), np.float32)
    rot[:, 0] = 1
    anchors_state = AnchorState(
        anchor=torch.from_numpy(anchor_pad).to(device),
        feat=pad(feat_fin), offset=pad(offsets_fin), mask=pad(masks_fin),
        scaling=pad(scaling_fin), rotation=pad(rot),
        opacity=pad(np.full((n, 1), float(np.log(0.1 / 0.9)), np.float32)),
    )
    nets = NetParams(*(map_tree(lambda t: t.to(device), v) for v in nets))
    state = ModelState(
        anchors=anchors_state, nets=nets, n_active=n,
        x_bound_min=torch.as_tensor(template.x_bound_min).to(device),
        x_bound_max=torch.as_tensor(template.x_bound_max).to(device))
    return state, meta, time.time() - t0

