"""Quantization primitives with straight-through gradients (port of
``gsvc_tpu/ops/quant.py``; reference: utils/encodings.py STE_binary
:375-392, STE_multistep :395-431, UniformQuantizer :434-449,
Quantize_anchor :452-482).

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


def ste_binary(x):
    """Sign binarisation to exactly {-1, +1} (0 maps to +1); the gradient
    passes only inside [-1, 1] (STE_binary).  Forward-exact: the entropy
    context from these embeddings must be bit-identical between encoder
    and decoder."""
    out = torch.where(x >= 0, torch.ones_like(x), -torch.ones_like(x))
    return _ste(out, x * (torch.abs(x) <= 1.0).to(x.dtype))


def _q_mean(q, x):
    """Mean quantisation step, detached (a Python float or a tensor)."""
    if isinstance(q, torch.Tensor):
        return torch.mean(q).detach()
    return torch.tensor(float(q), dtype=x.dtype, device=x.device)


def ste_round(x, q, x_mean=None):
    """Round to the nearest multiple of ``q`` (a scalar or a tensor that
    broadcasts against ``x``) with a straight-through gradient, after
    clamping to ``floor(x_mean / mean(q)) +- 15000`` symbol steps
    (STE_multistep.forward)."""
    if x_mean is None:
        x_mean = torch.mean(x)
    base = torch.floor((x_mean / _q_mean(q, x)).detach())
    lo, hi = base - CLAMP_BOUND, base + CLAMP_BOUND
    x_c = torch.clamp(x / q, lo, hi) * q
    return _ste(torch.round(x_c / q) * q, x_c)


def ste_quantize(x, q, min_value, max_value):
    """Deterministic integer symbols ``clip(round(x / q))``
    (STE_multistep.quantize)."""
    return torch.clamp(torch.round(x / q), min_value, max_value)



def uniform_noise_quantize(x, q, generator: Optional[torch.Generator]
                           = None, x_mean=None,
                           noise: Optional[torch.Tensor] = None):
    """Additive-uniform-noise quantization surrogate (UniformQuantizer),
    including the symbol-range clamp about ``x_mean / mean(q)``; ``q`` is
    a scalar or a tensor that broadcasts against ``x``.

    The noise is uniform in [-0.5, 0.5) drawn from ``generator``, or the
    given ``noise`` tensor (tests inject the JAX key's exact draws)."""
    if x_mean is None:
        x_mean = torch.mean(x)
    centre = (x_mean / _q_mean(q, x)).detach()
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


def quantize_anchor_indices(anchors, min_v, max_v):
    """Integer anchor voxel indices with the (interval, min_v) side
    information (Quantize_anchor.quantized)."""
    interval = (max_v - min_v) * Q_ANCHOR + 1e-6
    q = torch.clamp(torch.floor((anchors - min_v) / interval),
                    0, 2 ** ANCHOR_ROUND_DIGITS - 1)
    return q, interval, min_v


def dequantize_anchor(indices, interval, min_v):
    """Quantize_anchor.dequantized."""
    return indices * interval + min_v
