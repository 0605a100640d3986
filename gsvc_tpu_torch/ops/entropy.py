"""Differentiable bit-rate estimators (port of ``gsvc_tpu/ops/entropy.py``;
reference: utils/entropy_models.py EntropyGaussian :32-68,
Entropy_bernoulli :71-82, Entropy_factorized :85-156, Low_bound
:159-175, and utils/encodings.py get_binary_vxl_size :34-51).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from gsvc_tpu_torch.ops.quant import CLAMP_BOUND

_LIKELIHOOD_FLOOR = 2.0 ** -16
_LOG2E = 1.4426950408889634


class _LowBound(torch.autograd.Function):
    """``max(v, 2^-16)`` with the reference's asymmetric gradient rule:
    the gradient passes where ``v >= 2^-16`` or where it is negative
    (the optimizer pushes the likelihood up)."""

    @staticmethod
    def forward(ctx, v):
        ctx.save_for_backward(v)
        return torch.clamp(v, min=_LIKELIHOOD_FLOOR)

    @staticmethod
    def backward(ctx, g):
        (v,) = ctx.saved_tensors
        keep = (v >= _LIKELIHOOD_FLOOR) | (g < 0.0)
        return torch.where(keep, g, torch.zeros_like(g))


def _low_bound(v):
    return _LowBound.apply(v)


def _std_normal_cdf(z):
    return 0.5 * (1.0 + torch.erf(z / math.sqrt(2.0)))


def gaussian_bits(x, mean, scale, q=1.0, x_mean=None, quantized=False):
    """bits = -log2(Phi((x + q/2 - mu)/sigma) - Phi((x - q/2 - mu)/sigma)).

    ``quantized=True``: ``x`` holds integer symbols and the model is
    evaluated at (mu/q, sigma/q) with +-0.5 bins.  Otherwise ``x`` is
    first clamped to ``x_mean +- 15000 mean(q)`` (detached bounds)."""
    q = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    if not quantized:
        if x_mean is None:
            x_mean = torch.mean(x)
        q_mean = torch.mean(q)
        lo = (x_mean - CLAMP_BOUND * q_mean).detach()
        hi = (x_mean + CLAMP_BOUND * q_mean).detach()
        x = torch.clamp(x, lo, hi)
        upper = _std_normal_cdf((x + 0.5 * q - mean) / scale)
        lower = _std_normal_cdf((x - 0.5 * q - mean) / scale)
    else:
        mu = mean / q
        sigma = scale / q
        upper = _std_normal_cdf((x + 0.5 - mu) / sigma)
        lower = _std_normal_cdf((x - 0.5 - mu) / sigma)
    return -torch.log(_low_bound(upper - lower)) * _LOG2E


def bernoulli_bits(x, p):
    """Bits of a {-1, +1} tensor under Bernoulli(p of +1)."""
    p = torch.clamp(p, 1e-6, 1 - 1e-6)
    pos = (1 + x) / 2.0
    neg = (1 - x) / 2.0
    return -torch.log2(p) * pos + -torch.log2(1 - p) * neg


def factorized_entropy_init(channels: int, init_scale: float = 10.0,
                            filters=(3, 3, 3), device="cpu") -> dict:
    """Balle-style fully factorised entropy model parameters (kept for
    API parity; the main path uses the Gaussian conditional model).  The
    biases come from ``numpy.random.default_rng(0)``, as in the JAX
    package, so both hold the same numbers."""
    rng = np.random.default_rng(0)
    fs = (1,) + tuple(filters) + (1,)
    scale = init_scale ** (1.0 / (len(filters) + 1))
    params = {"matrices": [], "biases": [], "factors": []}
    for i in range(len(filters) + 1):
        init = np.log(np.expm1(1.0 / scale / fs[i + 1]))
        params["matrices"].append(torch.full(
            (channels, fs[i + 1], fs[i]), float(init), dtype=torch.float32,
            device=device))
        params["biases"].append(torch.from_numpy(
            rng.uniform(-0.5, 0.5, (channels, fs[i + 1], 1)).astype(
                np.float32)).to(device))
        if i < len(filters):
            params["factors"].append(torch.zeros(
                (channels, fs[i + 1], 1), dtype=torch.float32,
                device=device))
    return params


def factorized_bits(params, x, q=1.0):
    """Bits of ``x`` [N, C] under the factorised model (bin ``q``)."""
    q = torch.as_tensor(q, dtype=torch.float32, device=x.device)

    def logits_cumulative(v):                      # v: [C, 1, N]
        for i, m in enumerate(params["matrices"]):
            v = F.softplus(m) @ v + params["biases"][i]
            if i < len(params["factors"]):
                v = v + torch.tanh(params["factors"][i]) * torch.tanh(v)
        return v

    xt = x.T[:, None, :]
    lower = logits_cumulative(xt - 0.5 * (1.0 / q))
    upper = logits_cumulative(xt + 0.5 * (1.0 / q))
    sign = (-torch.sign(lower + upper)).detach()
    likelihood = torch.abs(torch.sigmoid(sign * upper)
                           - torch.sigmoid(sign * lower))
    bits = -torch.log(_low_bound(likelihood)) * _LOG2E
    return bits[:, 0, :].T


def binary_vxl_size(binary):
    """Closed-form bits of a {0, 1} tensor from its empirical 1-rate, plus
    32 bits for the probability.  Returns (p1, total bits, total MB,
    numel)."""
    binary = binary.to(torch.float32)
    n = binary.numel()
    pos = torch.sum(binary)
    p = torch.clamp(pos / n, 1e-6, 1 - 1e-6)
    bits = pos * (-torch.log2(p)) + (n - pos) * (-torch.log2(1 - p)) + 32.0
    return p, bits, bits / 8.0 / 1024.0 / 1024.0, n
