"""Carry-over of a JAX model state into the port.

The JAX package saves its state as a pickled dict of NumPy arrays keyed
by tree paths (gsvc_tpu/utils/checkpoint.py:24-53): ``anchors`` (the
AnchorState fields), ``nets`` (NetParams: ``hash_table`` plus nested MLP
dicts of ``w``/``b``), ``n_active``, ``x_bound_min``, ``x_bound_max``.
``state_from_numpy`` turns that layout into the port's ModelState on a
device; the arrays keep their dtype and layout, so the two packages hold
the same numbers.  ``training_state_from_numpy`` also carries the Adam
moments (``adam_m``/``adam_v``: (anchors, nets) pairs of the same
layout, ``adam_step``) and the densification statistics (``stats``).
"""

from __future__ import annotations

import numpy as np
import torch

from gsvc_tpu_torch.models.gaussians import (
    AnchorState, ModelState, NetParams, map_tree,
)


def state_from_numpy(payload: dict, device="cpu") -> ModelState:
    """ModelState on ``device`` from the JAX checkpoint layout (extra keys
    such as optimizer moments are ignored)."""
    def to_t(x):
        return torch.from_numpy(np.array(x, copy=True)).to(device)

    return ModelState(
        anchors=AnchorState(**{k: to_t(payload["anchors"][k])
                               for k in AnchorState._fields}),
        nets=NetParams(**{k: map_tree(to_t, payload["nets"][k])
                          for k in NetParams._fields}),
        n_active=int(payload["n_active"]),
        x_bound_min=to_t(payload["x_bound_min"]),
        x_bound_max=to_t(payload["x_bound_max"]))


def training_state_from_numpy(payload: dict, device="cpu"):
    """(ModelState, AdamState, TrainStats) on ``device`` from a training
    checkpoint payload of either package."""
    from gsvc_tpu_torch.train.optim import AdamState
    from gsvc_tpu_torch.train.trainer import TrainStats

    def to_t(x):
        return torch.from_numpy(np.array(x, copy=True)).to(device)

    def moments(pair):
        anchors, nets = pair
        return (AnchorState(**{k: to_t(anchors[k])
                               for k in AnchorState._fields}),
                NetParams(**{k: map_tree(to_t, nets[k])
                             for k in NetParams._fields}))

    adam = AdamState(m=moments(payload["adam_m"]),
                     v=moments(payload["adam_v"]),
                     step=int(payload["adam_step"]))
    stats = TrainStats(**{k: to_t(payload["stats"][k])
                          for k in TrainStats._fields})
    return state_from_numpy(payload, device), adam, stats
