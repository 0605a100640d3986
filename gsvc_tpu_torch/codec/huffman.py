"""Canonical Huffman coding of the 8-bit-quantized MLP weights (port of
``gsvc_tpu/codec/huffman.py``).

The table ships as canonically sorted (symbol, bit_length) pairs; codes
are assigned from it in the same order on both sides.
"""

from __future__ import annotations

import heapq
from collections import Counter
from typing import Dict, List, Sequence, Tuple


def _code_lengths(freqs: Dict[int, int]) -> Dict[int, int]:
    if len(freqs) == 1:
        return {next(iter(freqs)): 1}
    heap = [(f, i, (s,)) for i, (s, f) in enumerate(sorted(freqs.items()))]
    heapq.heapify(heap)
    lengths = {s: 0 for s in freqs}
    counter = len(heap)
    while len(heap) > 1:
        f1, _, s1 = heapq.heappop(heap)
        f2, _, s2 = heapq.heappop(heap)
        for s in s1 + s2:
            lengths[s] += 1
        heapq.heappush(heap, (f1 + f2, counter, s1 + s2))
        counter += 1
    return lengths


def build_canonical_code(symbols: Sequence[int]) -> List[Tuple[int, int]]:
    """[(symbol, bit_length)] sorted canonically (by length, then
    symbol)."""
    lengths = _code_lengths(Counter(symbols))
    return sorted(lengths.items(), key=lambda kv: (kv[1], kv[0]))


def _assign_codes(table: List[Tuple[int, int]]) -> Dict[int, Tuple[int, int]]:
    codes = {}
    code = 0
    prev_len = 0
    for sym, length in table:
        code <<= (length - prev_len)
        codes[sym] = (code, length)
        code += 1
        prev_len = length
    return codes


def huffman_encode(symbols: Sequence[int],
                   table: List[Tuple[int, int]]) -> bytes:
    codes = _assign_codes(table)
    acc = 0
    nbits = 0
    out = bytearray()
    for s in symbols:
        code, length = codes[s]
        acc = (acc << length) | code
        nbits += length
        while nbits >= 8:
            nbits -= 8
            out.append((acc >> nbits) & 0xFF)
        acc &= (1 << nbits) - 1      # keep only the bits not yet written
    if nbits:
        out.append((acc << (8 - nbits)) & 0xFF)
    return bytes(out)


def huffman_decode(data: bytes, table: List[Tuple[int, int]],
                   n_symbols: int) -> List[int]:
    if n_symbols == 0:
        return []
    decode_map = {cl: s for s, cl in _assign_codes(table).items()}
    out = []
    acc = 0
    length = 0
    for byte in data:
        for i in range(7, -1, -1):
            acc = (acc << 1) | ((byte >> i) & 1)
            length += 1
            sym = decode_map.get((acc, length))
            if sym is not None:
                out.append(sym)
                acc = 0
                length = 0
                if len(out) == n_symbols:
                    return out
    raise ValueError("huffman stream truncated")
