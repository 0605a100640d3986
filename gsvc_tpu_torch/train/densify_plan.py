"""Index-plan densification: host decides, device applies (port of
``gsvc_tpu/train/densify_plan.py``).

The host path (``train/densify.py``) copies every anchor field and both
Adam moment planes to the host, does the grow/prune/z-sort surgery in
NumPy and copies everything back.  This module computes the SAME surgery
as an index plan from small planes (anchor xyz, log-scalings, the four
densify accumulators, plus per-candidate offset rows fetched on demand;
``build_plan`` is a copy of the JAX package's host code), and applies it
on the device with gathers:

    out_field = concat([old_field, new_block])[src_idx]

New-anchor features are a segment max over candidate feature rows
(``pairs_src -> pairs_dst``, ``scatter_reduce_`` with "amax"), so the
[N, F] feature plane and the Adam moment planes stay on the device.  The
plan is exact against the host path — same RNG stream, same ordering
decisions (tests/test_torch_densify.py).

Reference semantics being reproduced: scene/gaussian_model.py:1258-1505
(adjust_anchor / anchor_growing / prune_anchor + optimizer surgery).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from gsvc_tpu_torch.config import ModelConfig, OptimizationConfig
from gsvc_tpu_torch.train.densify import DensifyResult

_NEW_QUANTUM = 4096     # new-row block size quantum
_PAIR_QUANTUM = 8192    # candidate-pair buffer quantum


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _rows_in(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Vectorized 'row of a is a row of b' for int grids (exact — no
    hashing).  Replaces the per-depth ``set(map(tuple, ...))`` +
    Python-loop membership test, which cost O(n) tuple boxing over up
    to ~100k anchors per depth."""
    if b.shape[0] == 0:
        return np.zeros(a.shape[0], bool)
    dt = [("", a.dtype)] * a.shape[1]
    av = np.ascontiguousarray(a).view(dt).ravel()
    bv = np.ascontiguousarray(b).view(dt).ravel()
    return np.isin(av, bv)


@dataclass
class DensifyPlan:
    """Everything the device apply program needs, plus host-side results.

    ``src_idx`` indexes a virtual concat [old_field(capacity_in rows),
    new_block(new_cap rows)]: entries < capacity_in select surviving
    old rows (original, pre-surgery indices — growth only appends, so
    kept rows keep their indices); entries >= capacity_in select
    new-anchor block slots.  Output slots beyond ``n_active`` point at
    the new block's final row, which is an all-zeros pad row with
    anchor z = 1e9 (the same padding the host path writes).  When the
    surgery outgrows the old device buffers, ``capacity_out`` (=
    len(src_idx)) is the grown output padding — same 1.5x-then-1024
    rounding as the host path — and the caller rebuilds its step.
    """

    result: DensifyResult
    n0: int                     # active rows before surgery
    capacity_out: int           # output row padding (>= capacity_in iff grown)
    src_idx: np.ndarray         # [capacity_out] int32
    new_anchor: np.ndarray      # [new_cap, 3] f32; pad rows z = 1e9
    new_scaling: np.ndarray     # [new_cap, 6] f32 (log cur_size fills)
    is_new_real: np.ndarray     # [new_cap] bool
    pairs_src: np.ndarray       # [p_cap] int32 anchor rows (pad: 0)
    pairs_dst: np.ndarray       # [p_cap] int32 new-row ids (pad: new_cap)
    offset_reset: np.ndarray    # [capacity_in * K] bool
    opdem_reset: np.ndarray     # [capacity_in] bool
    z_full: np.ndarray          # [capacity_out] f32 post-surgery z (pad 1e9)


def build_plan(
    anchor: np.ndarray,          # [n, 3] active-prefix anchor positions
    scaling: np.ndarray,         # [n, 6] active-prefix log scalings
    stats: dict,                 # opacity_accum [n,1], anchor_demon [n,1],
                                 # offset_gradient_accum [n*K,1], offset_denom
    fetch_offsets: Callable[[np.ndarray], np.ndarray],  # flat idx -> [m,3]
    mc: ModelConfig, opt: OptimizationConfig,
    voxel_size: float, rng: np.random.Generator,
    capacity: int,
) -> DensifyPlan:
    """Replicates densify.adjust_anchors + resort_by_z decision-for-
    decision (including the RNG draws), but materializes only the index
    plan.  ``capacity`` is the CURRENT device padding; if the surgery
    outgrows it the plan's output arrays use a grown ``capacity_out``
    (the apply program's gathers produce the larger output directly)."""
    k = mc.n_offsets
    interval = opt.update_interval
    n0 = anchor.shape[0]

    denom = stats["offset_denom"]
    grads = np.divide(stats["offset_gradient_accum"], denom,
                      out=np.zeros_like(denom), where=denom > 0)
    grads = np.nan_to_num(grads, nan=0.0, posinf=0.0, neginf=0.0)
    grads_norm = np.abs(grads[:, 0])
    offset_mask = (stats["offset_denom"][:, 0]
                   > interval * opt.success_threshold * 0.5)

    # ---- growing (anchor_growing, gaussian_model.py:1362-1449) ----------
    new_anchor_chunks = []       # per-depth [m,3] positions
    new_scaling_fill = []        # per-depth scalar log(cur_size)
    new_counts = []
    pairs_src_chunks, pairs_dst_chunks = [], []
    n_now = n0
    m_total = 0
    for depth in range(mc.update_depth):
        cur_threshold = opt.densify_grad_threshold * (
            (mc.update_hierarchy_factor // 2) ** depth)
        cand = np.zeros(n_now * k, bool)
        cand[:n0 * k] = (grads_norm >= cur_threshold) & offset_mask
        cand &= rng.random(n_now * k) > 0.5 ** (depth + 1)
        if not cand.any():
            continue

        size_factor = mc.update_init_factor // (
            mc.update_hierarchy_factor ** depth)
        cur_size = voxel_size * size_factor

        all_anchor = (np.concatenate([anchor] + new_anchor_chunks)
                      if new_anchor_chunks else anchor)
        grid_existing = np.round(all_anchor / cur_size).astype(np.int64)

        flat_idx = np.nonzero(cand)[0]          # all < n0 * k
        rows = (flat_idx // k).astype(np.int64)
        sel_off = fetch_offsets(flat_idx)
        scale3 = np.exp(scaling[rows, :3])
        sel_xyz = anchor[rows] + sel_off * scale3
        sel_grid = np.round(sel_xyz / cur_size).astype(np.int64)
        uniq_grid, inverse = np.unique(sel_grid, axis=0, return_inverse=True)

        keep = ~_rows_in(uniq_grid, grid_existing)
        if not keep.any():
            continue

        new_pos = (uniq_grid[keep] * cur_size).astype(np.float32)
        m = new_pos.shape[0]
        dst_of_uniq = np.full(uniq_grid.shape[0], -1, np.int64)
        dst_of_uniq[keep] = m_total + np.arange(m)
        pd = dst_of_uniq[inverse]
        sel = pd >= 0
        pairs_src_chunks.append(rows[sel])
        pairs_dst_chunks.append(pd[sel])
        new_anchor_chunks.append(new_pos)
        new_scaling_fill.append(float(np.log(cur_size)))
        new_counts.append(m)
        m_total += m
        n_now += m

    # offset-accumulator reset (gaussian_model.py:1460-1471): offsets
    # that passed the denom gate restart their statistics
    offset_reset = np.zeros(capacity * k, bool)
    offset_reset[:n0 * k] = offset_mask

    # ---- pruning (adjust_anchor, gaussian_model.py:1473-1505) -----------
    demon = stats["anchor_demon"][:, 0]
    prune = (stats["opacity_accum"][:, 0] < opt.min_opacity * demon) \
        & (demon > interval * opt.success_threshold)
    keep_old = ~prune
    seen = demon > interval * opt.success_threshold
    opdem_reset = np.zeros(capacity, bool)
    opdem_reset[:n0] = seen

    kept_old_idx = np.nonzero(keep_old)[0].astype(np.int64)
    n_active = kept_old_idx.shape[0] + m_total
    capacity_out = capacity
    if n_active > capacity:
        # same growth policy as the host path (train/fit.py _densify)
        capacity_out = _round_up(int(n_active * 1.5), 1024)

    new_cap = max(_NEW_QUANTUM, _round_up(m_total + 1, _NEW_QUANTUM))
    new_anchor = np.zeros((new_cap, 3), np.float32)
    new_anchor[m_total:, 2] = 1e9            # pad rows, incl. the slot
    new_scaling = np.zeros((new_cap, 6), np.float32)
    if m_total:
        new_anchor[:m_total] = np.concatenate(new_anchor_chunks)
        new_scaling[:m_total] = np.repeat(
            np.asarray(new_scaling_fill, np.float32), new_counts)[:, None]
    is_new_real = np.arange(new_cap) < m_total

    p = sum(c.shape[0] for c in pairs_src_chunks)
    p_cap = max(_PAIR_QUANTUM, _round_up(max(p, 1), _PAIR_QUANTUM))
    pairs_src = np.zeros(p_cap, np.int32)
    pairs_dst = np.full(p_cap, new_cap, np.int32)   # dump segment
    if p:
        pairs_src[:p] = np.concatenate(pairs_src_chunks)
        pairs_dst[:p] = np.concatenate(pairs_dst_chunks)

    # ---- z re-sort over [kept old rows (original order), new rows] ------
    z_old = anchor[kept_old_idx, 2]
    z_new = new_anchor[:m_total, 2]
    z_all = np.concatenate([z_old, z_new])
    src_all = np.concatenate([
        kept_old_idx, capacity + np.arange(m_total, dtype=np.int64)])
    order = np.argsort(z_all, kind="stable")

    src_idx = np.full(capacity_out, capacity + new_cap - 1, np.int32)
    src_idx[:n_active] = src_all[order].astype(np.int32)
    z_full = np.full(capacity_out, 1e9, np.float32)
    z_full[:n_active] = z_all[order]

    return DensifyPlan(
        result=DensifyResult(n_grown=m_total, n_pruned=int(prune.sum()),
                             n_active=n_active),
        n0=n0, capacity_out=capacity_out, src_idx=src_idx,
        new_anchor=new_anchor,
        new_scaling=new_scaling, is_new_real=is_new_real,
        pairs_src=pairs_src, pairs_dst=pairs_dst,
        offset_reset=offset_reset, opdem_reset=opdem_reset, z_full=z_full)


def apply_plan(plan: DensifyPlan, anchors, adam_m, adam_v, stats):
    """Apply the plan on the anchors' device.  ``anchors``/``adam_m``/
    ``adam_v`` are AnchorStates, ``stats`` a TrainStats, all padded to
    the current capacity.  Returns the same structures padded to
    ``plan.capacity_out``."""
    dev = anchors.anchor.device

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    src_idx = put(plan.src_idx.astype(np.int64))
    new_anchor, new_scaling = put(plan.new_anchor), put(plan.new_scaling)
    is_new_real = put(plan.is_new_real)
    pairs_src = put(plan.pairs_src.astype(np.int64))
    pairs_dst = put(plan.pairs_dst.astype(np.int64))
    offset_reset, opdem_reset = put(plan.offset_reset), put(plan.opdem_reset)

    cap_in, k = anchors.offset.shape[0], anchors.offset.shape[1]
    cap_out = src_idx.shape[0]
    new_cap = new_anchor.shape[0]

    def gather(old, new_block):
        return torch.cat([old, new_block], dim=0)[src_idx]

    # new-anchor features: per-voxel max over candidate feature rows (the
    # host path's _scatter_max); empty segments stay -inf, then 0
    cand_feat = anchors.feat[pairs_src]
    seg = torch.full((new_cap + 1, cand_feat.shape[1]), float("-inf"),
                     dtype=cand_feat.dtype, device=dev)
    seg.scatter_reduce_(0, pairs_dst[:, None].expand_as(cand_feat),
                        cand_feat, reduce="amax", include_self=True)
    feat_block = seg[:new_cap]
    feat_block = torch.where(torch.isneginf(feat_block),
                             torch.zeros_like(feat_block), feat_block)
    feat_block = torch.where(is_new_real[:, None], feat_block,
                             torch.zeros_like(feat_block))

    real1 = is_new_real[:, None].to(anchors.mask.dtype)
    blocks = {
        "anchor": new_anchor,
        "feat": feat_block,
        "offset": torch.zeros((new_cap, k, 3), dtype=anchors.offset.dtype,
                              device=dev),
        "mask": real1[:, :, None].expand(new_cap, k, 1),
        "scaling": new_scaling,
        "rotation": real1 * torch.tensor([1.0, 0.0, 0.0, 0.0],
                                         dtype=anchors.rotation.dtype,
                                         device=dev),
        "opacity": real1 * float(np.log(0.1 / 0.9)),
    }
    out = {name: gather(getattr(anchors, name), blocks[name])
           for name in blocks}
    # gaussian-scale clamp applied on prune (gaussian_model.py:1330-1342)
    sc = out["scaling"]
    out["scaling"] = torch.cat([sc[:, :3], torch.clamp(sc[:, 3:], max=0.05)],
                               dim=1)
    new_anchors = anchors._replace(**out)

    def gather_zero(old):
        return gather(old, torch.zeros((new_cap,) + tuple(old.shape[1:]),
                                       dtype=old.dtype, device=dev))

    new_m = adam_m._replace(**{name: gather_zero(getattr(adam_m, name))
                               for name in blocks})
    new_v = adam_v._replace(**{name: gather_zero(getattr(adam_v, name))
                               for name in blocks})

    opdem = opdem_reset[:, None]

    def reset(x, mask):
        return torch.where(mask, torch.zeros_like(x), x)

    def gather_rows(flat):
        rows = reset(flat, offset_reset[:, None]).reshape(cap_in, k, 1)
        return gather_zero(rows).reshape(cap_out * k, 1)

    new_stats = stats._replace(
        opacity_accum=gather_zero(reset(stats.opacity_accum, opdem)),
        anchor_demon=gather_zero(reset(stats.anchor_demon, opdem)),
        offset_gradient_accum=gather_rows(stats.offset_gradient_accum),
        offset_denom=gather_rows(stats.offset_denom))
    return new_anchors, new_m, new_v, new_stats
