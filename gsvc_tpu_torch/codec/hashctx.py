"""Context-modeled coding of the hash-table sign bits (port of
``encode_hash_table`` and ``decode_hash_table``,
gsvc_tpu/codec/hashctx.py:72, :114).

Model: channel 0 of a row is coded with context = level(row); channel
c >= 1 with context (c, level(row), b[r,c-1], b[r,c-2]).  Planes decode
in channel order, so every context bit is known before it is needed.

Stream layouts:
  version 2: [u8 2][u16 n_ctx][n_ctx x u16 prob_q][u32 plane_len x F]
             [plane streams...]
  version 1: [u8 1][u16 prob_q][rANS stream] (one global Bernoulli)
"""

from __future__ import annotations

import struct
from typing import Sequence

import numpy as np

from gsvc_tpu_torch.codec.native import decode_binary, encode_binary

PROB_Q = 4096
VERSION = 2


def _level_ids(level_sizes: Sequence[int]) -> np.ndarray:
    return np.repeat(np.arange(len(level_sizes), dtype=np.int64),
                     np.asarray(level_sizes, np.int64))


def _plane_ctx(levels: np.ndarray, n_levels: int, c: int,
               bits: np.ndarray) -> np.ndarray:
    """Context ids of channel plane ``c`` given the planes before it."""
    if c == 0:
        return levels
    b1 = bits[:, c - 1].astype(np.int64)
    b2 = (bits[:, c - 2].astype(np.int64) if c >= 2
          else np.zeros_like(b1))
    base = n_levels + (c - 1) * 4 * n_levels
    return base + levels * 4 + b1 * 2 + b2


def n_contexts(n_levels: int, n_features: int) -> int:
    return n_levels + (n_features - 1) * 4 * n_levels


def encode_hash_table(bits: np.ndarray, level_sizes: Sequence[int]) -> bytes:
    """Code uint8 {0,1} sign bits [rows, F] in flat table order; writes
    whichever of the context stream (version 2) and one global Bernoulli
    (version 1) is smaller."""
    bits = np.ascontiguousarray(bits, np.uint8)
    rows, nf = bits.shape
    n_levels = len(level_sizes)
    levels = _level_ids(level_sizes)
    if levels.shape[0] != rows:
        raise ValueError(f"level sizes cover {levels.shape[0]} rows, the "
                         f"table has {rows}")
    nc = n_contexts(n_levels, nf)

    # pass 1: per-context counts -> KT-smoothed, grid-quantized probs
    ones = np.zeros(nc, np.float64)
    total = np.zeros(nc, np.float64)
    for c in range(nf):
        ctx = _plane_ctx(levels, n_levels, c, bits)
        ones += np.bincount(ctx, weights=bits[:, c], minlength=nc)
        total += np.bincount(ctx, minlength=nc)
    p = (ones + 0.5) / (total + 1.0)
    prob_q = np.clip(np.round(p * PROB_Q), 1, PROB_Q - 1).astype(np.uint16)
    p_grid = prob_q.astype(np.float64) / PROB_Q

    # pass 2: one rANS stream per channel plane
    planes = [encode_binary(bits[:, c],
                            p_grid[_plane_ctx(levels, n_levels, c, bits)])
              for c in range(nf)]
    head = struct.pack("<BH", VERSION, nc) + prob_q.tobytes()
    head += struct.pack(f"<{nf}I", *(len(s) for s in planes))
    ctx_blob = head + b"".join(planes)

    flat = bits.reshape(-1)
    p1 = (float(flat.sum()) + 0.5) / (flat.size + 1.0)
    pq = int(np.clip(round(p1 * PROB_Q), 1, PROB_Q - 1))
    glob_blob = struct.pack("<BH", 1, pq) + encode_binary(
        flat, np.full(flat.size, pq / PROB_Q))
    return glob_blob if len(glob_blob) < len(ctx_blob) else ctx_blob


def decode_hash_table(blob: bytes, level_sizes: Sequence[int],
                      n_features: int) -> np.ndarray:
    """uint8 {0,1} [rows, n_features] sign bits in flat table order."""
    rows = int(np.sum(np.asarray(level_sizes, np.int64)))
    version = blob[0]
    if version == 1:
        (pq,) = struct.unpack_from("<H", blob, 1)
        n = rows * n_features
        flat = decode_binary(blob[3:], n, np.full(n, pq / PROB_Q))
        return np.asarray(flat, np.uint8).reshape(rows, n_features)
    if version != VERSION:
        raise ValueError(f"unknown hash stream version {version}")
    _, nc = struct.unpack_from("<BH", blob, 0)
    n_levels = len(level_sizes)
    if nc != n_contexts(n_levels, n_features):
        raise ValueError(f"hash stream has {nc} contexts, the grid needs "
                         f"{n_contexts(n_levels, n_features)}")
    off = 3
    prob_q = np.frombuffer(blob, np.uint16, nc, off)
    off += 2 * nc
    lens = struct.unpack_from(f"<{n_features}I", blob, off)
    off += 4 * n_features
    p_grid = prob_q.astype(np.float64) / PROB_Q

    levels = _level_ids(level_sizes)
    bits = np.zeros((rows, n_features), np.uint8)
    for c in range(n_features):
        ctx = _plane_ctx(levels, n_levels, c, bits)
        plane = blob[off:off + lens[c]]
        off += lens[c]
        bits[:, c] = decode_binary(plane, rows, p_grid[ctx])
    return bits
