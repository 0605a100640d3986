"""Adam with per-group learning rates over the model tree (port of
gsvc_tpu/train/optim.py).

The reference builds 13 torch.optim.Adam param groups with per-group
schedules (training_setup, scene/gaussian_model.py:844-1058).  Here the
parameters are the (AnchorState, NetParams) tree, the groups a tree of
scalar learning rates congruent with it, and the update is the JAX
package's formula, ``p - lr * (m / bc1) / (sqrt(v / bc2) + EPS)`` with
EPS = 1e-15 and the bias corrections in float32 — not torch.optim.Adam's
``sqrt(v) / sqrt(bc2)`` arrangement, so both packages round alike.  The
update is functional: it returns new tensors and leaves its inputs as
they were.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gsvc_tpu_torch.models.gaussians import AnchorState, NetParams

BETA1 = 0.9
BETA2 = 0.999
EPS = 1e-15

# field name -> schedule-group name
_ANCHOR_GROUPS = {
    "anchor": "anchor", "feat": "feat", "offset": "offset", "mask": "mask",
    "scaling": "scaling", "rotation": "rotation", "opacity": "opacity",
}
_NET_GROUPS = {
    "hash_table": "hash", "mlp_opacity": "mlp_opacity", "mlp_cov": "mlp_cov",
    "mlp_color": "mlp_color", "mlp_deform": "mlp_deform",
    "mlp_feature_enet": "mlp_enet", "mlp_scaling_enet": "mlp_enet",
    "mlp_offset_enet": "mlp_enet",
}


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over congruent trees of NamedTuples, tuples
    and dicts."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves of a tree in ``tree_map`` order."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(tree, leaves) -> object:
    """A tree shaped like ``tree`` holding ``leaves`` in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


class AdamState(NamedTuple):
    m: tuple
    v: tuple
    step: int


def adam_init(params) -> AdamState:
    return AdamState(m=tree_map(torch.zeros_like, params),
                     v=tree_map(torch.zeros_like, params), step=0)


def build_lr_tree(params, lr_values: dict):
    """params = (AnchorState, NetParams); lr_values: group name -> float.
    Returns a tree of floats congruent with params."""
    anchors, nets = params

    def fill(subtree, lr):
        return tree_map(lambda _: float(lr), subtree)

    a_lrs = AnchorState(**{
        f: fill(getattr(anchors, f), lr_values[_ANCHOR_GROUPS[f]])
        for f in AnchorState._fields})
    n_lrs = NetParams(**{
        f: fill(getattr(nets, f), lr_values[_NET_GROUPS[f]])
        for f in NetParams._fields})
    return (a_lrs, n_lrs)


def adam_update(params, grads, state: AdamState, lr_tree):
    """One Adam step; returns (new params, new AdamState)."""
    step = state.step + 1
    t = np.float32(step)
    bc1 = float(np.float32(1.0) - np.float32(BETA1) ** t)
    bc2 = float(np.float32(1.0) - np.float32(BETA2) ** t)
    new_m = tree_map(lambda m, g: BETA1 * m + (1 - BETA1) * g, state.m,
                     grads)
    new_v = tree_map(lambda v, g: BETA2 * v + (1 - BETA2) * g * g, state.v,
                     grads)

    def upd(p, m, v, lr):
        return p - lr * (m / bc1) / (torch.sqrt(v / bc2) + EPS)

    new_params = tree_map(upd, params, new_m, new_v, lr_tree)
    return new_params, AdamState(m=new_m, v=new_v, step=step)
