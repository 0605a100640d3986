"""NeRF-style sin/cos positional embedding (reference:
utils/time_util.py:7-55; port of ``gsvc_tpu/ops/embed.py``).

Conditions the FiLM MLP heads on the camera z ("time") and on
(anchor z - camera z).  multires=16, input dim 1 -> 33 dims.
"""

from __future__ import annotations

import torch


def positional_embedder(multires: int, input_dims: int = 1):
    """Returns (embed_fn, out_dim).  embed = [x, sin(2^k x), cos(2^k x)]
    for k in 0..multires-1."""
    if multires <= 0:
        return (lambda x: x), input_dims

    freqs = [2.0 ** k for k in range(multires)]
    out_dim = input_dims * (1 + 2 * multires)

    def embed(x):
        parts = [x]
        for f in freqs:
            parts.append(torch.sin(x * f))
            parts.append(torch.cos(x * f))
        return torch.cat(parts, dim=-1)

    return embed, out_dim
