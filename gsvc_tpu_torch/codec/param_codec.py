"""MLP weight compression: 8-bit quantization, canonical Huffman, zlib
(port of gsvc_tpu/codec/param_codec.py).

2D weights are quantized per output dimension, 1D biases per tensor;
exact zeros are kept by a sparsity bitmask.  All arithmetic is float64
with a final float32 cast, on both sides, and the encoder replaces the
live parameters by their dequantized values, so the entropy-context
networks the decoder rebuilds are bit-identical to the ones the encoder
coded against.

Leaf keys follow the JAX package's flatten order (``tree_flatten_with_path``
over dicts sorts their keys), e.g. ``mlp_opacity['film']['beta0']['b']``.
"""

from __future__ import annotations

import pickle
import zlib

import numpy as np
import torch

from gsvc_tpu_torch.codec.huffman import (
    build_canonical_code, huffman_decode, huffman_encode,
)
from gsvc_tpu_torch.codec.unpickle import restricted_loads
from gsvc_tpu_torch.models.gaussians import MLP_FIELDS, NetParams


def _quantize_axis(t: np.ndarray, bits: int, axis: int):
    """Quantize ``t`` per group along ``axis`` (-1: the whole tensor).
    Returns (int64 symbols, nonzero mask, dequantized float32 values,
    {"t_min", "scale"} float32 side info).  The dequantized values come
    from the float32-snapped min and scale the stream ships, in float64."""
    valid = t != 0
    t64 = t.astype(np.float64)
    if axis < 0:
        vals = t64[valid]
        lo, hi = (float(vals.min()), float(vals.max())) if vals.size \
            else (0.0, 0.0)
        s = (hi - lo) / (2 ** bits)
        q = np.round((t64 - lo) / (s + 1e-19))
        lo32, s32 = np.float32(lo), np.float32(s)
        deq = np.float64(lo32) + np.float64(s32) * q
        new = np.where(valid, deq, 0.0).astype(np.float32)
        return (q.astype(np.int64), valid, new,
                {"t_min": np.asarray([lo32], np.float32),
                 "scale": np.asarray([s32], np.float32)})
    q = np.zeros(t.shape, np.float64)
    new = np.zeros(t.shape, np.float64)
    mins, scales = [], []
    for i in range(t.shape[axis]):
        sl = tuple(slice(None) if d != axis else i for d in range(t.ndim))
        sub = t64[sl]
        vals = sub[sub != 0]
        lo, hi = (float(vals.min()), float(vals.max())) if vals.size \
            else (0.0, 0.0)
        s = (hi - lo) / (2 ** bits)
        qq = np.round((sub - lo) / (s + 1e-19))
        q[sl] = qq
        lo32, s32 = np.float32(lo), np.float32(s)
        new[sl] = np.where(sub != 0,
                           np.float64(lo32) + np.float64(s32) * qq, 0.0)
        mins.append(lo32)
        scales.append(s32)
    return (q.astype(np.int64), valid, new.astype(np.float32),
            {"t_min": np.asarray(mins, np.float32),
             "scale": np.asarray(scales, np.float32)})


def _pack_bits(mask: np.ndarray) -> bytes:
    return zlib.compress(np.packbits(mask.astype(np.uint8)).tobytes(), 9)


def _unpack_bits(data: bytes, n: int) -> np.ndarray:
    return np.unpackbits(np.frombuffer(zlib.decompress(data), np.uint8))[:n]


def flatten_with_keys(field: str, tree) -> list:
    """[(key, leaf)] in sorted-key order with the JAX path spelling."""
    if not isinstance(tree, dict):
        return [(field, tree)]
    out = []
    for k in sorted(tree):
        out.extend(flatten_with_keys(f"{field}[{k!r}]", tree[k]))
    return out


def _rebuild(tree, prefix: str, by_key: dict):
    if not isinstance(tree, dict):
        arr = by_key[prefix]
        if tuple(arr.shape) != tuple(tree.shape):
            raise ValueError(f"shape mismatch for {prefix}: stream "
                             f"{arr.shape} vs template {tuple(tree.shape)}")
        return torch.from_numpy(arr)
    return {k: _rebuild(v, f"{prefix}[{k!r}]", by_key)
            for k, v in tree.items()}


def _replace_leaves(tree, prefix: str, by_key: dict):
    if not isinstance(tree, dict):
        return by_key[prefix]
    return {k: _replace_leaves(v, f"{prefix}[{k!r}]", by_key)
            for k, v in tree.items()}


def encode_mlp_params(nets: NetParams, bits: int = 8):
    """Returns (stream bytes, NetParams whose MLP leaves are replaced by
    their dequantized values, on each leaf's device).  The stream is
    byte-identical to the JAX package's for the same weights: the same
    leaf keys and order, Python ints in the table, numpy float32 side
    info."""
    quant_syms = []
    masks, meta_list, new = [], [], {}
    for field in MLP_FIELDS:
        for key, leaf in flatten_with_keys(field, getattr(nets, field)):
            arr = leaf.detach().cpu().numpy()
            axis = 1 if arr.ndim == 2 else -1
            q, valid, deq, meta = _quantize_axis(arr, bits, axis)
            quant_syms.extend(int(v) for v in q[valid].ravel())
            masks.append(valid.ravel())
            meta.update({"key": key, "shape": list(arr.shape),
                         "axis": axis})
            meta_list.append(meta)
            new[key] = torch.from_numpy(deq).to(leaf.device)
    table = build_canonical_code(quant_syms)
    blob = {
        "meta": zlib.compress(pickle.dumps(
            {"table": table, "meta_list": meta_list,
             "n_syms": len(quant_syms)}), 9),
        "mask": _pack_bits(np.concatenate(masks)),
        "params": huffman_encode(quant_syms, table),
    }
    return pickle.dumps(blob), nets._replace(**{
        f: _replace_leaves(getattr(nets, f), f, new) for f in MLP_FIELDS})


def decode_mlp_params(stream: bytes, template: NetParams) -> NetParams:
    """Rebuild the quantized MLP weights as CPU tensors; ``template``
    gives the tree structure and shapes (cross-checked against the stream
    metadata)."""
    blob = restricted_loads(stream)
    info = restricted_loads(zlib.decompress(blob["meta"]))
    syms = huffman_decode(blob["params"], info["table"], info["n_syms"])
    total_mask = sum(int(np.prod(m["shape"])) for m in info["meta_list"])
    mask = _unpack_bits(blob["mask"], total_mask)

    syms_pos = 0
    mask_pos = 0
    by_key = {}
    for meta in info["meta_list"]:
        shape = tuple(meta["shape"])
        n = int(np.prod(shape))
        valid = mask[mask_pos:mask_pos + n].astype(bool).reshape(shape)
        mask_pos += n
        nv = int(valid.sum())
        q = np.zeros(shape, np.float64)
        q[valid] = np.asarray(syms[syms_pos:syms_pos + nv], np.float64)
        syms_pos += nv
        axis = meta["axis"]
        t_min = np.asarray(meta["t_min"], np.float64)
        scale = np.asarray(meta["scale"], np.float64)
        if axis < 0:
            deq = t_min[0] + scale[0] * q
        else:
            bshape = [1] * len(shape)
            bshape[axis] = shape[axis]
            deq = t_min.reshape(bshape) + scale.reshape(bshape) * q
        by_key[meta["key"]] = np.where(valid, deq, 0.0).astype(np.float32)

    expected = {k for f in MLP_FIELDS
                for k, _ in flatten_with_keys(f, getattr(template, f))}
    if expected != set(by_key):
        raise ValueError(
            f"MLP stream leaves do not match the template: missing "
            f"{sorted(expected - set(by_key))[:4]}, unexpected "
            f"{sorted(set(by_key) - expected)[:4]}")
    return template._replace(**{
        f: _rebuild(getattr(template, f), f, by_key)
        for f in MLP_FIELDS})
