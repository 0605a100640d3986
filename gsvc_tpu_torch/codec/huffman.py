"""Canonical Huffman decoding of the 8-bit-quantized MLP weights
(port of the decode half of ``gsvc_tpu/codec/huffman.py``).

The table ships as canonically sorted (symbol, bit_length) pairs; codes
are reassigned from it exactly as the encoder assigned them.
"""

from __future__ import annotations

from typing import Dict, List, Tuple


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
