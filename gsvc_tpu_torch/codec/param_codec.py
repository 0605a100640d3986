"""MLP weight decoding: Huffman symbols -> 8-bit dequantization
(port of ``decode_mlp_params``, gsvc_tpu/codec/param_codec.py:144).

2D weights are quantized per output dimension, 1D biases per tensor;
exact zeros are restored from a sparsity bitmask.  All dequantization is
float64 with a final float32 cast — the same arithmetic as the encoder,
so the entropy-context networks the decoder rebuilds are bit-identical
to the ones the encoder coded against.

Leaf keys follow the JAX package's flatten order (``tree_flatten_with_path``
over dicts sorts their keys), e.g. ``mlp_opacity['film']['beta0']['b']``.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from gsvc_tpu_torch.codec.huffman import huffman_decode
from gsvc_tpu_torch.codec.unpickle import restricted_loads
from gsvc_tpu_torch.models.gaussians import MLP_FIELDS, NetParams


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
