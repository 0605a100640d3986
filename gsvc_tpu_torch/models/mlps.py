"""MLP heads as parameter dicts + apply functions (port of
``gsvc_tpu/models/mlps.py``).

Architecture parity with the reference (scene/gaussian_model.py):
  * FiLM            :150-170  — two-layer gamma/beta conditioning
  * GeneratorNet    :173-196  — 2-layer GELU trunk, FiLM, output head
  * EntropyParamsNet:198-232  — dist_net (mu, sigma) + quant_step_net
  * deform MLP      :468-489  — 5 linear layers with GELU, out 3K

Weights stay in the JAX package's layout — ``{"w": [in, out], "b":
[out]}`` per linear — so decoded and carried-over parameter trees map
leaf for leaf.  GELU is the tanh form (``jax.nn.gelu``'s default).

The ``*_init`` functions draw every weight and bias from
U(-1/sqrt(in), 1/sqrt(in)) with a ``torch.Generator`` (on its own
device, then moved to the requested one) — the JAX
package's distributions and shapes; the numbers differ from JAX's
threefry draws, so tests carry states over instead of re-drawing them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def linear_shape(in_dim: int, out_dim: int) -> dict:
    return {"w": (in_dim, out_dim), "b": (out_dim,)}


def _uniform(shape, bound: float, gen: torch.Generator, device):
    """U(-bound, bound), drawn on the generator's device, moved to
    ``device``."""
    return ((torch.rand(shape, generator=gen, dtype=torch.float32,
                        device=gen.device) * 2.0 - 1.0) * bound).to(device)


def linear_init(gen: torch.Generator, in_dim: int, out_dim: int,
                device="cpu") -> dict:
    bound = 1.0 / float(np.sqrt(np.float32(in_dim)))
    return {"w": _uniform((in_dim, out_dim), bound, gen, device),
            "b": _uniform((out_dim,), bound, gen, device)}


def init_from_shapes(gen: torch.Generator, shapes: dict,
                     device="cpu") -> dict:
    """Initialise a nested dict of ``linear_shape`` entries in key order."""
    if set(shapes) == {"w", "b"}:
        return linear_init(gen, shapes["w"][0], shapes["w"][1], device)
    return {k: init_from_shapes(gen, v, device) for k, v in shapes.items()}


def linear(p, x):
    return x @ p["w"] + p["b"]


def film_shapes(condition_dim: int, input_dim: int) -> dict:
    return {
        "gamma0": linear_shape(condition_dim, condition_dim),
        "beta0": linear_shape(condition_dim, condition_dim),
        "gamma1": linear_shape(condition_dim, input_dim),
        "beta1": linear_shape(condition_dim, input_dim),
    }


def film(p, x, condition):
    gamma = linear(p["gamma1"], torch.relu(linear(p["gamma0"], condition)))
    beta = linear(p["beta1"], torch.relu(linear(p["beta0"], condition)))
    return gamma * x + beta


def generator_net_shapes(input_dim: int, output_dim: int, inner_dim: int,
                         condition_dim: int) -> dict:
    return {
        "linear1": linear_shape(input_dim, inner_dim),
        "linear2": linear_shape(inner_dim, inner_dim),
        "film": film_shapes(condition_dim, inner_dim),
        "out": linear_shape(inner_dim, output_dim),
    }


def generator_net_init(gen: torch.Generator, input_dim: int,
                       output_dim: int, inner_dim: int, condition_dim: int,
                       device="cpu") -> dict:
    return init_from_shapes(gen, generator_net_shapes(
        input_dim, output_dim, inner_dim, condition_dim), device)


def generator_net(p, feature, condition, out_act=None):
    h = _gelu(linear(p["linear1"], feature))
    h = linear(p["linear2"], h)
    h = film(p["film"], h, condition)
    out = linear(p["out"], h)
    return out if out_act is None else out_act(out)


def entropy_params_net_shapes(input_dim: int, inner_dim: int,
                              inner_dim2: int, output_dim: int,
                              layer: int = 2) -> dict:
    if layer not in (2, 3):
        raise ValueError(f"layer must be 2 or 3, got {layer}")
    p = {
        "dist0": linear_shape(input_dim, inner_dim),
        "dist_out": linear_shape(inner_dim, output_dim * 2),
        "q0": linear_shape(input_dim, inner_dim2),
        "q1": linear_shape(inner_dim2, 1),
    }
    if layer == 3:
        p["dist1"] = linear_shape(inner_dim, inner_dim)
    return p


def entropy_params_net_init(gen: torch.Generator, input_dim: int,
                            inner_dim: int, inner_dim2: int,
                            output_dim: int, layer: int = 2,
                            device="cpu") -> dict:
    return init_from_shapes(gen, entropy_params_net_shapes(
        input_dim, inner_dim, inner_dim2, output_dim, layer), device)


def entropy_params_net(p, x):
    h = _gelu(linear(p["dist0"], x))
    if "dist1" in p:
        h = _gelu(linear(p["dist1"], h))
    mean, scale = torch.chunk(linear(p["dist_out"], h), 2, dim=-1)
    q = linear(p["q1"], _gelu(linear(p["q0"], x)))
    return mean, scale, q


def deform_mlp_shapes(input_dim: int, hidden: int, output_dim: int) -> dict:
    return {
        "l0": linear_shape(input_dim, hidden),
        "l1": linear_shape(hidden, hidden),
        "l2": linear_shape(hidden, hidden),
        "l3": linear_shape(hidden, hidden),
        "out": linear_shape(hidden, output_dim),
    }


def deform_mlp_init(gen: torch.Generator, input_dim: int, hidden: int,
                    output_dim: int, device="cpu") -> dict:
    return init_from_shapes(gen, deform_mlp_shapes(input_dim, hidden,
                                                   output_dim), device)


def deform_mlp(p, x):
    h = x
    for name in ("l0", "l1", "l2", "l3"):
        h = _gelu(linear(p[name], h))
    return linear(p["out"], h)
