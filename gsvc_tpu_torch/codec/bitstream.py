"""Attribute bitstream encode and decode — the host codec (port of
gsvc_tpu/codec/bitstream.py: ``EncodeMeta``, ``BitInfo``,
``conduct_encoding`` with its streaming mode, ``conduct_decoding``; plus
``load_streams``, gsvc_tpu/utils/checkpoint.py:117).

  encode: quantize and pack the MLPs (the live ones are replaced by their
          dequantized copies) -> octree-code the surviving anchors and
          order them as the decoder will (Morton; z-slices when streaming)
          -> one full-set entropy context from the decoder-identical
          anchors (codec/detctx.py, numpy float64) -> per batch, symbols
          and rANS streams -> context-coded hash signs and Bernoulli-coded
          gaussian masks -> zlib'd pickled side info.
  decode: geometry (octree) -> masks & hash signs -> per-batch entropy
          context from the decoded anchors -> rANS attribute streams -> a
          decoded ModelState on the target device (activations bypassed,
          anchors z-sorted and padded for rendering).

Both sides compute every quantity the decoder must reproduce with the
same host arithmetic over the same batch slicing, so the port's streams
are byte-identical to the JAX encoder's for the same state and decode in
either package.  ``meta.bin`` pickles ``EncodeMeta`` under the JAX
package's class name (``gsvc_tpu.codec.bitstream.EncodeMeta``), which
both decoders read, without importing that package.
"""

from __future__ import annotations

import dataclasses
import io
import os
import pickle
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from gsvc_tpu_torch.codec.detctx import det_entropy_context, host_nets
from gsvc_tpu_torch.codec.hashctx import decode_hash_table, encode_hash_table
from gsvc_tpu_torch.codec.native import (
    decode_binary, decode_gaussian_symbols, decode_octree, encode_binary,
    encode_gaussian_symbols, encode_octree, morton_sort_indices,
)
from gsvc_tpu_torch.codec.param_codec import (
    decode_mlp_params, encode_mlp_params, flatten_with_keys,
)
from gsvc_tpu_torch.codec.unpickle import META_CLASS, restricted_loads
from gsvc_tpu_torch.models.gaussians import (
    MLP_FIELDS, AnchorState, EntropyContext, GaussianConfig, ModelState,
    NetParams, Q_FEAT, Q_OFFSETS, Q_SCALING, get_mask, get_mask_anchor,
    get_scaling, map_tree,
)
from gsvc_tpu_torch.ops.quant import (
    ANCHOR_ROUND_DIGITS, CLAMP_BOUND, quantize_anchor_indices, ste_binary,
)

MAX_BATCH = 1000
BIT2MB = 8 * 1024 * 1024
STREAM_Z_INTERVAL = 0.01
# anchors per chunk of the encoder's full-set entropy context
CTX_CHUNK = 16_384
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


@dataclasses.dataclass
class BitInfo:
    """Per-stream bit accounting (scene/gaussian_model.py:55-66)."""

    bit_anchor: int = 0
    bit_anchor_gpcc: int = 0
    bit_feat: int = 0
    bit_scaling: int = 0
    bit_offsets: int = 0
    bit_hash: int = 0
    bit_masks: int = 0
    bit_mlp: int = 0
    bit_mlp_encoded: int = 0
    bit_meta: int = 0

    @property
    def total_bits(self) -> int:
        return (self.bit_anchor_gpcc + self.bit_feat + self.bit_scaling
                + self.bit_offsets + self.bit_hash + self.bit_masks
                + self.bit_mlp_encoded + self.bit_meta)

    @property
    def total_mb(self) -> float:
        return self.total_bits / BIT2MB


class _MetaPickler(pickle._Pickler):
    """Pickles ``EncodeMeta`` under the JAX package's class name (the name
    both decoders look up) without importing that package: the class is
    written as the (module, name) pair the C pickler would write for
    JAX's class; everything else pickles as usual."""

    def save_global(self, obj, name=None):
        if obj is EncodeMeta:
            self.save(META_CLASS[0])
            self.save(META_CLASS[1])
            self.write(pickle.STACK_GLOBAL)
            self.memoize(obj)
            return
        super().save_global(obj, name)


def dumps_meta(meta: EncodeMeta) -> bytes:
    """``pickle.dumps`` of JAX's ``EncodeMeta`` with these fields."""
    buf = io.BytesIO()
    _MetaPickler(buf, pickle.DEFAULT_PROTOCOL).dump(meta)
    return buf.getvalue()


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


def _quantize_clip(x, q, lo, hi):
    return np.clip(np.round(np.asarray(x, np.float64)
                            / np.asarray(q, np.float64)), lo, hi)


def _fullset_context(hnets, lo, hi, cfg, anchors_ordered,
                     chunk: int = CTX_CHUNK) -> EntropyContext:
    """Entropy context of the whole ordered anchor set, in chunks: it
    gives the global symbol ranges and every batch's slice (the context
    is pointwise per anchor)."""
    parts = [det_entropy_context(hnets, lo, hi, cfg, anchors_ordered[i:i
                                                                     + chunk])
             for i in range(0, anchors_ordered.shape[0], chunk)]
    if len(parts) == 1:
        return parts[0]
    return EntropyContext(*(np.concatenate([getattr(p, f) for p in parts])
                            for f in EntropyContext._fields))


def _fullset_symbol_ranges(ec: EntropyContext) -> list:
    """(feat, scaling, offsets) symbol clip ranges from a full-set context
    (calc_symbol_min_max over the whole model)."""
    out = []
    for m, q in ((ec.mean_feat, Q_FEAT * ec.q_feat_adj),
                 (ec.mean_scaling, Q_SCALING * ec.q_scaling_adj),
                 (ec.mean_offsets, Q_OFFSETS * ec.q_offsets_adj)):
        c = np.asarray(m, np.float64).mean() / np.asarray(q,
                                                           np.float64).mean()
        out.append((int(c) - CLAMP_BOUND, int(c) + CLAMP_BOUND))
    return out


def _encode_attribute_batches(hnets, lo, hi, cfg, anchors_ordered, feat,
                              scaling, offsets, masks, batches, streams,
                              bit_info):
    """Shared batch loop of the flat and streaming encoders; returns the
    per-batch symbol ranges."""
    k = cfg.n_offsets
    ec_full = _fullset_context(hnets, lo, hi, cfg, anchors_ordered)
    feat_rng, scaling_rng, offsets_rng = _fullset_symbol_ranges(ec_full)

    batch_ranges = []
    for s, (b0, b1) in enumerate(batches):
        ec = EntropyContext(*(v[b0:b1] for v in ec_full))
        qf = (Q_FEAT * ec.q_feat_adj).astype(np.float64)
        qs = (Q_SCALING * ec.q_scaling_adj).astype(np.float64)
        qo = (Q_OFFSETS * ec.q_offsets_adj).astype(np.float64)

        def one(x, mean, scale, q, rng, name, mask=None):
            q_b = np.broadcast_to(q, x.shape)
            sym = _quantize_clip(x, q_b, rng[0], rng[1])
            if mask is not None:
                sym, mean, scale, q_b = (sym[mask], mean[mask], scale[mask],
                                         q_b[mask])
            sym = sym.astype(np.int32).ravel()
            if sym.size == 0:
                streams[f"{name}_{s}.b"] = b""
                return (0, 1), 0
            lo_l, hi_l = int(sym.min()), int(sym.max())
            if lo_l == hi_l:
                hi_l += 1
            mu = _quantize_proba((np.asarray(mean, np.float64) / q_b).ravel())
            sg = _quantize_proba((np.asarray(scale, np.float64)
                                  / q_b).ravel())
            data = encode_gaussian_symbols(sym, mu, sg, lo_l, hi_l)
            streams[f"{name}_{s}.b"] = data
            return (lo_l, hi_l), len(data) * 8

        nb = b1 - b0
        f_rng, f_bits = one(feat[b0:b1], ec.mean_feat, ec.scale_feat, qf,
                            feat_rng, "feat")
        s_rng, s_bits = one(scaling[b0:b1], ec.mean_scaling,
                            ec.scale_scaling, qs, scaling_rng, "scaling")
        mask3 = np.repeat(masks[b0:b1], 3, axis=-1).reshape(nb, 3 * k)
        o_rng, o_bits = one(offsets[b0:b1].reshape(nb, 3 * k),
                            ec.mean_offsets, ec.scale_offsets, qo,
                            offsets_rng, "offsets", mask=mask3.astype(bool))
        batch_ranges.append((f_rng, s_rng, o_rng))
        bit_info.bit_feat += f_bits
        bit_info.bit_scaling += s_bits
        bit_info.bit_offsets += o_bits
    return batch_ranges


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def conduct_encoding(state: ModelState, cfg: GaussianConfig,
                     streaming: bool = False,
                     model_config: Optional[dict] = None,
                     video_info: Optional[dict] = None):
    """Full encode of a fitted state (on any device; the coding runs on
    the host).  Returns (streams dict, EncodeMeta, BitInfo, the state with
    its MLPs replaced by their quantized copies, seconds)."""
    t0 = time.time()
    streams: Dict[str, bytes] = {}
    bit_info = BitInfo()

    # 1. MLPs: quantize (replacing the live params) and pack
    mlp_stream, nets_q = encode_mlp_params(state.nets)
    state = state._replace(nets=nets_q)
    streams["mlp.pkl"] = mlp_stream
    bit_info.bit_mlp = sum(int(leaf.numel()) * 32 for f in MLP_FIELDS
                           for _, leaf in flatten_with_keys(
                               f, getattr(nets_q, f)))
    bit_info.bit_mlp_encoded = len(mlp_stream) * 8

    # 2. surviving anchors -> octree geometry
    anchors_all = _host(state.anchors.anchor)
    active = np.arange(anchors_all.shape[0]) < int(state.n_active)
    keep_idx = np.where(_host(get_mask_anchor(state.anchors)) & active)[0]
    # on the host, in float32 with each operation rounded on its own, as
    # the JAX encoder's eager ops give them
    q_idx, interval, min_v = (t.numpy() for t in quantize_anchor_indices(
        torch.from_numpy(anchors_all), state.x_bound_min.detach().cpu(),
        state.x_bound_max.detach().cpu()))
    q_np = q_idx.astype(np.uint32)[keep_idx]
    geom = encode_octree(q_np, ANCHOR_ROUND_DIGITS)
    streams["anchor.drc"] = geom
    sel = morton_sort_indices(q_np, ANCHOR_ROUND_DIGITS)
    n = q_np.shape[0]
    bit_info.bit_anchor = n * 3 * ANCHOR_ROUND_DIGITS
    bit_info.bit_anchor_gpcc = len(geom) * 8

    # 3. attributes in decoder order, at the decoder's (dequantized)
    # anchor positions: two correctly rounded float32 numpy ops, as the
    # decoder computes them
    order = keep_idx[sel]
    anchors_ordered = (q_np[sel].astype(np.float32) * interval
                       + min_v).astype(np.float32)
    feat = _host(state.anchors.feat)[order]
    offsets = _host(state.anchors.offset)[order]
    scaling = _host(get_scaling(state.anchors))[order]
    masks = _host(get_mask(state.anchors))[order]        # [n, K, 1] {0,1}

    index_splits = None
    if streaming:
        z_order, index_splits = _z_order_splits(anchors_ordered)
        anchors_ordered = anchors_ordered[z_order]
        feat, offsets = feat[z_order], offsets[z_order]
        scaling, masks = scaling[z_order], masks[z_order]
        batches = index_splits
    else:
        batches = [(lo, min(lo + MAX_BATCH, n))
                   for lo in range(0, n, MAX_BATCH)]
    batch_ranges = _encode_attribute_batches(
        host_nets(nets_q), state.x_bound_min, state.x_bound_max, cfg,
        anchors_ordered, feat, scaling, offsets, masks[:, :, 0], batches,
        streams, bit_info)

    # 4. binary streams: context-coded hash signs, Bernoulli-coded masks
    hash_bits01 = ((_host(ste_binary(nets_q.hash_table)) + 1) / 2).astype(
        np.uint8)
    prob_hash = float(hash_bits01.mean())
    streams["hash.b"] = encode_hash_table(hash_bits01,
                                          cfg.grid.flat_level_sizes())
    bit_info.bit_hash = len(streams["hash.b"]) * 8
    mask_bits = masks.reshape(-1).astype(np.uint8)
    prob_masks = float(mask_bits.mean())
    streams["masks.b"] = encode_binary(mask_bits, prob_masks)
    bit_info.bit_masks = len(streams["masks.b"]) * 8

    meta = EncodeMeta(
        total_anchor_num=int(anchors_all.shape[0]), anchor_num=n,
        batch_size=MAX_BATCH, anchor_interval=interval, anchor_min=min_v,
        batch_ranges=batch_ranges, prob_hash=prob_hash,
        prob_masks=prob_masks, streaming=streaming,
        index_splits=index_splits, model_config=model_config,
        video_info=video_info)
    streams["meta.bin"] = zlib.compress(dumps_meta(meta), 9)
    bit_info.bit_meta = len(streams["meta.bin"]) * 8
    return streams, meta, bit_info, state, time.time() - t0


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

