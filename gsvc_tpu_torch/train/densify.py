"""Anchor densification: hierarchical voxel growing + opacity pruning
(a copy of ``gsvc_tpu/train/densify.py``: host numpy drawing from the
fitter's ``numpy.random.Generator``, so both packages make the same
decisions).

Host-side NumPy re-implementation of adjust_anchor / anchor_growing /
prune_anchor and the optimizer-state surgery (scene/gaussian_model.py:
1258-1505).  Runs every ``update_interval`` iterations between training
steps; afterwards the anchor buffers are re-sorted by z (restoring the
TSW slice invariant) and padded back to capacity, and the Adam moment
buffers / accumulators get the same permutation.

Shapes may grow past capacity: the caller grows it by 1.5x (rounded to
1024) and rebuilds its step.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from gsvc_tpu_torch.config import ModelConfig, OptimizationConfig


_ANCHOR_FIELDS = ("anchor", "feat", "offset", "mask", "scaling",
                  "rotation", "opacity")


@dataclass
class DensifyResult:
    n_grown: int
    n_pruned: int
    n_active: int


def _scatter_max(values: np.ndarray, index: np.ndarray, n: int) -> np.ndarray:
    """Per-group elementwise max (replaces torch_scatter.scatter_max used
    at scene/gaussian_model.py:1417)."""
    out = np.full((n,) + values.shape[1:], -np.inf, values.dtype)
    np.maximum.at(out, index, values)
    out[np.isneginf(out)] = 0.0
    return out


def adjust_anchors(
    anchors: dict,            # field -> np array, ACTIVE prefix only [n, ...]
    adam_m: dict, adam_v: dict,  # same structure / shapes
    stats: dict,              # opacity_accum [n,1], anchor_demon [n,1],
                              # offset_gradient_accum [n*K,1], offset_denom
    mc: ModelConfig, opt: OptimizationConfig,
    voxel_size: float, rng: np.random.Generator,
):
    """Grow + prune in place on dict-of-arrays; returns DensifyResult.

    All arrays are active-prefix sized; the caller handles re-sorting,
    padding and capacity growth.
    """
    k = mc.n_offsets
    interval = opt.update_interval

    denom = stats["offset_denom"]
    grads = np.divide(stats["offset_gradient_accum"], denom,
                      out=np.zeros_like(denom), where=denom > 0)
    grads = np.nan_to_num(grads, nan=0.0, posinf=0.0, neginf=0.0)
    grads_norm = np.abs(grads[:, 0])
    offset_mask = (stats["offset_denom"][:, 0]
                   > interval * opt.success_threshold * 0.5)

    n0 = anchors["anchor"].shape[0]
    n_grown = 0

    # ---- growing (anchor_growing, gaussian_model.py:1362-1449) ----------
    for depth in range(mc.update_depth):
        cur_threshold = opt.densify_grad_threshold * (
            (mc.update_hierarchy_factor // 2) ** depth)
        n_now = anchors["anchor"].shape[0]
        cand = np.zeros(n_now * k, bool)
        cand[:n0 * k] = (grads_norm >= cur_threshold) & offset_mask
        cand &= rng.random(n_now * k) > 0.5 ** (depth + 1)

        if not cand.any():
            continue

        scale3 = np.exp(anchors["scaling"][:, :3])
        all_xyz = (anchors["anchor"][:, None, :]
                   + anchors["offset"] * scale3[:, None, :]).reshape(-1, 3)

        size_factor = mc.update_init_factor // (
            mc.update_hierarchy_factor ** depth)
        cur_size = voxel_size * size_factor

        grid_existing = np.round(anchors["anchor"] / cur_size).astype(np.int64)
        sel_xyz = all_xyz[cand]
        sel_grid = np.round(sel_xyz / cur_size).astype(np.int64)
        uniq_grid, inverse = np.unique(sel_grid, axis=0, return_inverse=True)

        # drop voxels already occupied by an existing anchor
        existing_set = set(map(tuple, grid_existing))
        keep = np.array([tuple(g) not in existing_set for g in uniq_grid],
                        bool)
        if not keep.any():
            continue

        new_anchor = (uniq_grid[keep] * cur_size).astype(np.float32)
        m = new_anchor.shape[0]

        cand_feat = np.repeat(anchors["feat"], k, axis=0)[cand]
        new_feat = _scatter_max(cand_feat, inverse,
                                uniq_grid.shape[0])[keep].astype(np.float32)

        new = {
            "anchor": new_anchor,
            "feat": new_feat,
            "offset": np.zeros((m, k, 3), np.float32),
            "mask": np.ones((m, k, 1), np.float32),
            "scaling": np.full((m, 6), np.log(cur_size), np.float32),
            "rotation": np.tile(np.array([1, 0, 0, 0], np.float32), (m, 1)),
            "opacity": np.full((m, 1), float(np.log(0.1 / 0.9)), np.float32),
        }
        for f in _ANCHOR_FIELDS:
            anchors[f] = np.concatenate([anchors[f], new[f]], axis=0)
            zpad = np.zeros_like(new[f])
            adam_m[f] = np.concatenate([adam_m[f], zpad], axis=0)
            adam_v[f] = np.concatenate([adam_v[f], zpad], axis=0)
        stats["opacity_accum"] = np.concatenate(
            [stats["opacity_accum"], np.zeros((m, 1), np.float32)])
        stats["anchor_demon"] = np.concatenate(
            [stats["anchor_demon"], np.zeros((m, 1), np.float32)])
        n_grown += m

    # reset gradient accumulators of offsets that passed the denom gate,
    # then pad for grown anchors (gaussian_model.py:1460-1471)
    n_now = anchors["anchor"].shape[0]
    oga = np.zeros((n_now * k, 1), np.float32)
    od = np.zeros((n_now * k, 1), np.float32)
    oga[:n0 * k] = np.where(offset_mask[:, None], 0.0,
                            stats["offset_gradient_accum"])
    od[:n0 * k] = np.where(offset_mask[:, None], 0.0,
                           stats["offset_denom"])
    stats["offset_gradient_accum"] = oga
    stats["offset_denom"] = od

    # ---- pruning (adjust_anchor, gaussian_model.py:1473-1505) -----------
    demon = stats["anchor_demon"][:, 0]
    prune = (stats["opacity_accum"][:, 0] < opt.min_opacity * demon) \
        & (demon > interval * opt.success_threshold)
    keep = ~prune

    # reset accumulators of anchors that accrued enough observations
    seen = demon > interval * opt.success_threshold
    stats["opacity_accum"][seen] = 0.0
    stats["anchor_demon"][seen] = 0.0

    for f in _ANCHOR_FIELDS:
        anchors[f] = anchors[f][keep]
        adam_m[f] = adam_m[f][keep]
        adam_v[f] = adam_v[f][keep]
    # gaussian-scale clamp applied on prune (gaussian_model.py:1330-1342)
    anchors["scaling"][:, 3:] = np.minimum(anchors["scaling"][:, 3:], 0.05)

    stats["opacity_accum"] = stats["opacity_accum"][keep]
    stats["anchor_demon"] = stats["anchor_demon"][keep]
    keep_rows = np.repeat(keep, k)
    stats["offset_gradient_accum"] = stats["offset_gradient_accum"][keep_rows]
    stats["offset_denom"] = stats["offset_denom"][keep_rows]

    n_active = anchors["anchor"].shape[0]
    return DensifyResult(n_grown=n_grown, n_pruned=int(prune.sum()),
                         n_active=n_active)


def resort_by_z(anchors: dict, adam_m: dict, adam_v: dict, stats: dict,
                n_offsets: int):
    """Restore the z-sorted invariant after grow/prune."""
    order = np.argsort(anchors["anchor"][:, 2], kind="stable")
    rows = (order[:, None] * n_offsets
            + np.arange(n_offsets)[None, :]).reshape(-1)
    for f in _ANCHOR_FIELDS:
        anchors[f] = anchors[f][order]
        adam_m[f] = adam_m[f][order]
        adam_v[f] = adam_v[f][order]
    stats["opacity_accum"] = stats["opacity_accum"][order]
    stats["anchor_demon"] = stats["anchor_demon"][order]
    stats["offset_gradient_accum"] = stats["offset_gradient_accum"][rows]
    stats["offset_denom"] = stats["offset_denom"][rows]
    return order
