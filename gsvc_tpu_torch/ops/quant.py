"""Quantization primitives with straight-through gradients (port of
``gsvc_tpu/ops/quant.py:20-107``; reference: utils/encodings.py
STE_multistep :395-431, UniformQuantizer :434-449, Quantize_anchor
:452-482).

A straight-through estimator is written ``s - s.detach() + v.detach()``:
EXACTLY ``v`` in the forward pass (the textbook ``s + (v - s).detach()``
is not forward-exact in floating point, and the codec needs the exact
value), the surrogate ``s``'s gradient in the backward.
"""

from __future__ import annotations

from typing import Optional

import torch

ANCHOR_ROUND_DIGITS = 16
Q_ANCHOR = 1.0 / (2 ** ANCHOR_ROUND_DIGITS - 1)
# symbol clamp half-range shared by quantizers / entropy model / coder
CLAMP_BOUND = 15_000


def _ste(value, surrogate):
    """``value`` forward, ``surrogate``'s gradient backward."""
    return surrogate - surrogate.detach() + value.detach()


def ste_round(x, q: float, x_mean=None):
    """Round to the nearest multiple of the scalar step ``q`` with a
    straight-through gradient, after clamping to ``x_mean/q +- 15000``
    symbol steps (STE_multistep.forward)."""
    if x_mean is None:
        x_mean = torch.mean(x)
    base = torch.floor((x_mean / q).detach())
    lo, hi = base - CLAMP_BOUND, base + CLAMP_BOUND
    x_c = torch.clamp(x / q, lo, hi) * q
    return _ste(torch.round(x_c / q) * q, x_c)


def uniform_noise_quantize(x, q: float, generator: Optional[torch.Generator]
                           = None, x_mean=None,
                           noise: Optional[torch.Tensor] = None):
    """Additive-uniform-noise quantization surrogate (UniformQuantizer),
    including the symbol-range clamp.

    The noise is uniform in [-0.5, 0.5) drawn from ``generator``, or the
    given ``noise`` tensor (tests inject the JAX key's exact draws)."""
    if x_mean is None:
        x_mean = torch.mean(x)
    centre = (x_mean / q).detach()
    x = torch.clamp(x / q, centre - CLAMP_BOUND, centre + CLAMP_BOUND) * q
    if noise is None:
        noise = torch.rand(x.shape, generator=generator, dtype=x.dtype,
                           device=x.device) - 0.5
    return x + noise * q


def quantize_anchor(anchors, min_v, max_v):
    """16-bit-per-axis anchor quantization with a straight-through
    gradient (Quantize_anchor).  Returns dequantized anchors."""
    interval = (max_v - min_v) * Q_ANCHOR + 1e-6
    q = torch.clamp(torch.floor((anchors - min_v) / interval),
                    0, 2 ** ANCHOR_ROUND_DIGITS - 1)
    return _ste(q * interval + min_v, anchors)
