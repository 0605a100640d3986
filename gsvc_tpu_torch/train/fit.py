"""GOP fitting: the host loop around the training step (port of
gsvc_tpu/train/fit.py; reference: pipeline/train.py:267-605).

The host samples one frame pair per iteration (one ``rng.integers`` draw,
as the JAX package's single-step path), feeds the learning rates and runs
one step on the device.  Frames live on the device as uint8 [T, 3, H, W],
flows as int8 with a per-frame scale (zeros when the GOP has none).
Anchor buffers are padded to a capacity and z-sorted, so a frame's TSW
window is one slice.

All four phases of the schedule are ported (FULL_PRECISION,
QUANTIZED_NOISE, ENTROPY, STE_ENTROPY; past the schedule's end the fit
stays in STE_ENTROPY), and so is the densify epoch, which runs after an
iteration's step and before its log: by default as an index plan built
on the host and applied with gathers on the device
(``pipeline.device_densify``), else as host surgery.  Both grow the
capacity by 1.5x (rounded to 1024) when the anchors outgrow it.

Random numbers: the initial networks are drawn from a CPU
``torch.Generator(seed)`` and moved to the device, so a seed gives the
same networks on every device; the per-step quantisation noise comes
from a generator on the fit device (``self.generator``).

With a ``mesh`` (``parallel/spmd.py``, one process a rank) the fit runs
the SPMD step: this rank holds its z-slab of the anchors, every step
draws one frame pair per dp group (``n_dp`` draws from ``self.rng``,
the same on every rank, each rank taking its group's), the noise
generator is seeded ``seed + dp index``, and the densify epochs gather
the slabs, run the host epoch on every rank and re-shard.  Evaluation,
the rate estimate, snapshots and checkpoints read ``gathered_state()``
(the global z-ordered buffers); rank 0 renders and writes, and every
rank reaches every collective.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import numpy as np
import torch

from gsvc_tpu_torch.config import Config
from gsvc_tpu_torch.device import resolve_device
from gsvc_tpu_torch.framecube.frame import FrameCubeDataset
from gsvc_tpu_torch.framecube.pointcloud import init_point_cloud
from gsvc_tpu_torch.metrics.image import psnr
from gsvc_tpu_torch.models.gaussians import (
    AnchorState, GaussianConfig, GenerateMode, init_model,
    mean_nn3_distance, update_anchor_bound,
)
from gsvc_tpu_torch.render.batched import render_frame_bidir
from gsvc_tpu_torch.render.pipeline import (
    check_rasterizer, make_raster_settings,
)
from gsvc_tpu_torch.train.controller import TrainingController
from gsvc_tpu_torch.train.densify import adjust_anchors, resort_by_z
from gsvc_tpu_torch.train.optim import AdamState, adam_init
from gsvc_tpu_torch.train.schedules import build_schedules
from gsvc_tpu_torch.train.trainer import (
    TrainStats, gt_f32, init_stats, make_step_body,
)

def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def compute_window_cap(z_sorted: np.ndarray, n_active: int,
                       frame_zs: np.ndarray, threshold: float,
                       headroom: float = 1.5, quantum: int = 512) -> int:
    """Smallest padded capacity covering the largest TSW band."""
    z = z_sorted[:n_active]
    max_band = 1
    for fz in frame_zs:
        lo = np.searchsorted(z, fz - threshold)
        hi = np.searchsorted(z, fz + threshold, side="right")
        max_band = max(max_band, hi - lo)
    cap = _round_up(int(max_band * headroom) + 8, quantum)
    # never exceed the physical buffer length
    return max(1, min(cap, _round_up(max(n_active, 1), quantum),
                      len(z_sorted)))


@dataclass
class FitReport:
    iterations: int = 0
    psnr: float = 0.0
    loss: float = 0.0
    bit_per_param: float = 0.0
    n_active: int = 0
    history: list = field(default_factory=list)
    evals: list = field(default_factory=list)    # {"iter", "psnr"}


def write_snapshot(state, out_dir: str):
    """``point_cloud.ply`` (the first ``n_active`` anchors,
    ``utils/ply.py``) and ``networks.pkl`` (the networks as the JAX
    package pickles them: a nested dict of float32 numpy arrays under the
    NetParams keys) into ``out_dir``."""
    import pathlib
    import pickle

    from gsvc_tpu_torch.models.gaussians import map_tree
    from gsvc_tpu_torch.utils.ply import save_gaussian_ply

    p = pathlib.Path(out_dir)
    p.mkdir(parents=True, exist_ok=True)
    n = int(state.n_active)
    anchors = {f: getattr(state.anchors, f)[:n].detach().cpu().numpy()
               for f in AnchorState._fields}
    save_gaussian_ply(str(p / "point_cloud.ply"), anchors)
    nets = map_tree(lambda t: t.detach().cpu().numpy(), state.nets._asdict())
    with open(p / "networks.pkl", "wb") as f:
        pickle.dump(nets, f)


class GOPFitter:
    """Fits one frame cube (= encodes one GOP) on one device, or as one
    rank of a ``mesh`` (``parallel/spmd.py:make_mesh``).

    ``device`` defaults to ``cuda`` and raises without a card; ``cpu``
    runs the plain PyTorch versions of the kernels (the tests).  ``rng``:
    the host generator of the point cloud, the frame draws and the densify
    epochs (default ``default_rng(seed)``; the GOP fan-out shares one)."""

    MAX_GAUSSIAN_CAP = 4096
    MAX_TILES_PER_GAUSSIAN = 128

    def __init__(self, cfg: Config, dataset: FrameCubeDataset,
                 seed: int = 0, log_fn: Optional[Callable] = None,
                 device=None, mesh=None,
                 rng: Optional[np.random.Generator] = None):
        self.cfg = cfg
        self.dataset = dataset
        self.device = resolve_device(device)
        self.gcfg = GaussianConfig.from_model_config(cfg.model)
        self.log = log_fn or (lambda *a, **k: None)
        self.seed = seed
        self.rng = rng if rng is not None else np.random.default_rng(seed)
        self.mesh = mesh
        self.n_dp = mesh.size("dp") if mesh is not None else 1
        self.n_sp = mesh.size("sp") if mesh is not None else 1
        # per-step noise on the fit device, one generator a dp group; the
        # initial networks come from a CPU generator (below), the same on
        # every device and rank
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(
            seed + (mesh.dp_index if mesh is not None else 0))
        # "", "jnp", "pallas" and "pallas_train" train through kernels
        # B1/B2 at tile-aligned widths, "pallas_stream" through B6f/B6b
        # (with the compacted copy stream when copy_budget_factor > 0),
        # every name through B5f/B5b at other widths; others raise
        self.rasterizer = check_rasterizer(cfg.pipeline.rasterizer)

        opt = cfg.optimization
        pts = init_point_cloud(dataset.x_min, dataset.y_min, dataset.z_min,
                               n=opt.init_anchor_num, rng=self.rng)
        self.capacity = _round_up(
            _round_up(int(opt.init_anchor_num * 1.5), 1024), self.n_sp)
        self.state = init_model(torch.Generator().manual_seed(seed),
                                self.gcfg, pts, self.capacity,
                                voxel_size=cfg.model.voxel_size,
                                device=self.device)
        self.voxel_size = self._resolve_voxel_size(pts, cfg.model.voxel_size)
        self.state = update_anchor_bound(
            self.state, dataset.x_min, dataset.y_min, dataset.z_min)

        self.frame_zs = np.array([
            (i - dataset.num_frames / 2) / dataset.scale
            for i in range(dataset.num_frames)], np.float32)
        self.window_cap = compute_window_cap(
            self.state.anchors.anchor[:, 2].cpu().numpy(),
            self.state.n_active, self.frame_zs, self.gcfg.threshold)
        if mesh is not None:
            from gsvc_tpu_torch.parallel.spmd import shard_model_state

            # under sp each rank windows its own z-slab
            self.window_cap = min(self.window_cap,
                                  self.capacity // self.n_sp)
            self.state = shard_model_state(self.state, mesh)

        bg = 1.0 if cfg.model.white_background else 0.0
        self.settings = make_raster_settings(
            self.gcfg, dataset.height, dataset.width,
            tile_h=cfg.pipeline.tile_h, tile_w=cfg.pipeline.tile_w,
            gaussian_cap=cfg.pipeline.visible_capacity or 1024,
            chunk=cfg.pipeline.gaussian_chunk,
            copy_budget_factor=cfg.pipeline.copy_budget_factor, bg=bg,
            matmul_dtype=cfg.pipeline.matmul_dtype)

        self._overflow_strikes = 0
        self._underfill_strikes = 0
        self.schedules = build_schedules(opt, spatial_lr_scale=1.0,
                                         ste_binary=cfg.model.ste_binary)
        self.adam = adam_init((self.state.anchors, self.state.nets))
        self.stats = init_stats(self.capacity // self.n_sp,
                                self.gcfg.n_offsets, self.device)
        self.controller = TrainingController(opt)
        self._build_step()
        # optional per-step marker (``mark(name)``) for a timing breakdown
        self.timer = None
        self._upload_frames()

    def _upload_frames(self):
        """Frames as uint8 [T, 3, H, W] and flows as int8 [T-1, 2, H, W]
        with a per-frame float32 scale, on the device, one frame at a
        time (PNG sources are exact in uint8)."""
        d = self.dataset
        t_n, h, w = d.num_frames, d.height, d.width
        self.log(f"uploading {t_n} frames to {self.device} "
                 f"({t_n * 3 * h * w / 2**30:.2f} GB uint8)")
        self.images = torch.empty((t_n, 3, h, w), dtype=torch.uint8,
                                  device=self.device)
        for i in range(t_n):
            if d.images_u8 is not None:
                f8 = np.asarray(d.images_u8[i])
            else:
                f8 = np.clip(np.round(np.asarray(d.images[i]) * 255.0), 0,
                             255).astype(np.uint8)
            self.images[i] = torch.from_numpy(
                np.ascontiguousarray(np.transpose(f8, (2, 0, 1)))).to(
                    self.device)
        flows_raw = d.flows_raw
        if flows_raw is None and d.flows is not None:
            flows_raw = np.asarray(d.flows)
        if flows_raw is not None:
            # int8 + per-frame scale (~0.1 px quantisation error, below
            # flow-estimator noise), as the JAX package stores flows
            fr = np.asarray(flows_raw, np.float32)
            s = np.maximum(np.abs(fr).reshape(fr.shape[0], -1).max(axis=1)
                           / 127.0, 1e-6).astype(np.float32)
            q = np.clip(np.round(fr / s[:, None, None, None]),
                        -127, 127).astype(np.int8)
            self.flows = (torch.from_numpy(q).to(self.device),
                          torch.from_numpy(s[:, None, None, None]).to(
                              self.device))
        else:
            f_n = max(t_n - 1, 1)
            self.flows = (torch.zeros((f_n, 2, h, w), dtype=torch.int8,
                                      device=self.device),
                          torch.ones((f_n, 1, 1, 1), device=self.device))

    def _resolve_voxel_size(self, pts, voxel_size):
        if voxel_size > 0:
            return voxel_size
        return float(np.median(mean_nn3_distance(pts.astype(np.float32))))

    def gathered_state(self):
        """The model state with the global z-ordered anchor buffers (one
        all-gather of the slabs under a mesh; ``self.state`` without)."""
        if self.mesh is None:
            return self.state
        from gsvc_tpu_torch.parallel.spmd import gather_slabs

        return self.state._replace(anchors=AnchorState(
            *gather_slabs(list(self.state.anchors), self.mesh)))

    def _rank0(self) -> bool:
        return self.mesh is None or self.mesh.rank == 0

    def _build_step(self):
        """The step closure over the current settings and window (the
        JAX package re-jits here; the port only rebuilds the closure)."""
        d = self.dataset
        if self.mesh is not None:
            from gsvc_tpu_torch.parallel.spmd import make_spmd_train_step

            # the slab-overlap bound of the log-T exchange: the global
            # (unclamped) window band says how many consecutive slabs a
            # frame's window can intersect
            z = self.gathered_state().anchors.anchor[:, 2].cpu().numpy()
            global_band = compute_window_cap(
                z, self.state.n_active, self.frame_zs, self.gcfg.threshold)
            slab_rows = self.capacity // self.n_sp
            neighbors = min(self.n_sp - 1, -(-global_band // slab_rows))
            self.train_step = make_spmd_train_step(
                self.gcfg, self.settings, self.window_cap,
                self.cfg.optimization, width=d.width, height=d.height,
                scale=d.scale, x_min=d.x_min, y_min=d.y_min, mesh=self.mesh,
                rasterizer=self.rasterizer, overlap_neighbors=neighbors)
            return
        self.train_step = make_step_body(
            self.gcfg, self.settings, self.window_cap,
            self.cfg.optimization, width=d.width, height=d.height,
            scale=d.scale, x_min=d.x_min, y_min=d.y_min,
            rasterizer=self.rasterizer)

    def _lr_values(self, it: int) -> Dict[str, float]:
        return {name: sched(it) for name, sched in self.schedules.items()}

    def _maybe_resize_window(self, z_sorted: np.ndarray, n_active: int
                             ) -> bool:
        """Grow, or shrink below half, the padded TSW window to the
        current anchor density (hysteresis avoids rebuild thrash)."""
        new_window = compute_window_cap(z_sorted, n_active, self.frame_zs,
                                        self.gcfg.threshold)
        if self.mesh is not None:
            new_window = min(new_window, self.capacity // self.n_sp)
        if new_window > self.window_cap or \
                new_window <= self.window_cap // 2:
            old = self.window_cap
            self.window_cap = new_window
            self.log(f"window_cap {old} -> {new_window}")
            return True
        return False

    # -- densification -----------------------------------------------------
    def _stats_prefix(self, n: int) -> dict:
        """The densify accumulators of the live prefix, as host numpy."""
        k = self.gcfg.n_offsets
        st = self.stats
        return {
            "opacity_accum": st.opacity_accum[:n].cpu().numpy(),
            "anchor_demon": st.anchor_demon[:n].cpu().numpy(),
            "offset_gradient_accum":
                st.offset_gradient_accum[:n * k].cpu().numpy(),
            "offset_denom": st.offset_denom[:n * k].cpu().numpy(),
        }

    def _maybe_calibrate(self, stats: dict):
        """``auto_densify_threshold``: set the threshold once, at the
        first epoch, from the candidate fraction."""
        opt = self.cfg.optimization
        if not opt.auto_densify_threshold or getattr(
                self, "_threshold_calibrated", False):
            return
        from gsvc_tpu_torch.train.calibrate import \
            calibrate_densify_threshold

        new_thr = calibrate_densify_threshold(
            stats, opt, opt.densify_target_fraction)
        self.log(f"densify threshold calibrated: "
                 f"{opt.densify_grad_threshold:.6f} -> {new_thr:.6f} "
                 f"(target fraction {opt.densify_target_fraction})")
        opt.densify_grad_threshold = new_thr
        self._threshold_calibrated = True

    def _densify(self):
        """One densify epoch (grow, prune, z re-sort, re-pad), then the
        window and the step are rebuilt if they changed."""
        if self.mesh is not None:
            return self._densify_spmd()
        if self.cfg.pipeline.device_densify:
            return self._densify_device()
        return self._densify_host()

    def _densify_spmd(self):
        """The epoch under a mesh (``spmd_densify_epoch``): the slabs are
        gathered, every rank runs the host epoch on the same arrays with
        the same generator, and the result is re-padded to a capacity
        divisible by sp and re-sharded.  The one-time threshold
        calibration reads the gathered statistics."""
        from gsvc_tpu_torch.parallel.spmd import (
            gather_slabs, spmd_densify_epoch,
        )

        opt = self.cfg.optimization
        if opt.auto_densify_threshold and not getattr(
                self, "_threshold_calibrated", False):
            n, k = self.state.n_active, self.gcfg.n_offsets
            oga, od = gather_slabs([self.stats.offset_gradient_accum,
                                    self.stats.offset_denom], self.mesh)
            self._maybe_calibrate({
                "offset_gradient_accum": oga[:n * k].cpu().numpy(),
                "offset_denom": od[:n * k].cpu().numpy()})
        self.state, self.adam, self.stats, res, cap = spmd_densify_epoch(
            self.state, self.adam, self.stats, self.mesh, self.cfg.model,
            opt, self.voxel_size, self.rng, self.gcfg.n_offsets,
            capacity=self.capacity)
        rebuild = cap != self.capacity
        self.capacity = cap
        z = self.gathered_state().anchors.anchor[:, 2].cpu().numpy()
        if self._maybe_resize_window(z, res.n_active) or rebuild:
            self._build_step()
        return res

    def _densify_host(self):
        """The host-surgery path: the live prefix of every anchor field,
        both Adam moments and the accumulators go to the host, through
        ``adjust_anchors`` and ``resort_by_z``, and back padded."""
        n = self.state.n_active
        k = self.gcfg.n_offsets

        def prefix(tree):
            return {f: getattr(tree, f)[:n].cpu().numpy().copy()
                    for f in AnchorState._fields}

        anchors = prefix(self.state.anchors)
        adam_m, adam_v = prefix(self.adam.m[0]), prefix(self.adam.v[0])
        stats = {f: v.copy() for f, v in self._stats_prefix(n).items()}
        self._maybe_calibrate(stats)
        res = adjust_anchors(anchors, adam_m, adam_v, stats, self.cfg.model,
                             self.cfg.optimization, self.voxel_size, self.rng)
        resort_by_z(anchors, adam_m, adam_v, stats, k)

        n_new = res.n_active
        rebuild = False
        if n_new > self.capacity:
            self.capacity = _round_up(int(n_new * 1.5), 1024)
            rebuild = True
        cap, dev = self.capacity, self.device

        def pad_to(x, rows):
            out = np.zeros((rows,) + x.shape[1:], np.float32)
            out[:x.shape[0]] = x
            return torch.from_numpy(out).to(dev)

        anchor_pad = np.zeros((cap, 3), np.float32)
        anchor_pad[:n_new] = anchors["anchor"]
        anchor_pad[n_new:, 2] = 1e9
        fields = {f: pad_to(anchors[f], cap) for f in AnchorState._fields
                  if f != "anchor"}
        new_anchors = AnchorState(anchor=torch.from_numpy(anchor_pad).to(dev),
                                  **fields)
        new_m = AnchorState(**{f: pad_to(adam_m[f], cap)
                               for f in AnchorState._fields})
        new_v = AnchorState(**{f: pad_to(adam_v[f], cap)
                               for f in AnchorState._fields})
        self.state = self.state._replace(anchors=new_anchors, n_active=n_new)
        self.adam = AdamState(m=(new_m, self.adam.m[1]),
                              v=(new_v, self.adam.v[1]), step=self.adam.step)
        self.stats = TrainStats(
            opacity_accum=pad_to(stats["opacity_accum"], cap),
            anchor_demon=pad_to(stats["anchor_demon"], cap),
            offset_gradient_accum=pad_to(stats["offset_gradient_accum"],
                                         cap * k),
            offset_denom=pad_to(stats["offset_denom"], cap * k))
        if self._maybe_resize_window(anchor_pad[:, 2], n_new) or rebuild:
            self._build_step()
        return res

    def _densify_device(self):
        """The index-plan path (train/densify_plan.py): the host reads the
        small decision planes and the candidates' offsets, builds the
        grow/prune/z-sort plan, and the device applies it with gathers."""
        from gsvc_tpu_torch.train.densify_plan import apply_plan, build_plan

        n = self.state.n_active
        anchors = self.state.anchors
        stats = self._stats_prefix(n)
        self._maybe_calibrate(stats)
        offsets_flat = anchors.offset.reshape(-1, 3)

        def fetch_offsets(idx):
            idx = torch.from_numpy(np.asarray(idx, np.int64)).to(self.device)
            return offsets_flat[idx].cpu().numpy()

        plan = build_plan(
            anchor=anchors.anchor[:n].cpu().numpy(),
            scaling=anchors.scaling[:n].cpu().numpy(), stats=stats,
            fetch_offsets=fetch_offsets, mc=self.cfg.model,
            opt=self.cfg.optimization, voxel_size=self.voxel_size,
            rng=self.rng, capacity=self.capacity)
        new_anchors, new_m, new_v, new_stats = apply_plan(
            plan, anchors, self.adam.m[0], self.adam.v[0], self.stats)
        rebuild = plan.capacity_out != self.capacity
        self.capacity = plan.capacity_out
        self.state = self.state._replace(anchors=new_anchors,
                                         n_active=plan.result.n_active)
        self.adam = AdamState(m=(new_m, self.adam.m[1]),
                              v=(new_v, self.adam.v[1]), step=self.adam.step)
        self.stats = new_stats
        if self._maybe_resize_window(plan.z_full, plan.result.n_active) \
                or rebuild:
            self._build_step()
        return plan.result

    # -- overflow reaction -------------------------------------------------
    def _react_to_overflow(self, overflow: int, it: int,
                           strikes_to_act: int = 2,
                           num_rendered: int = -1,
                           harmful: int = -1):
        """Grow ``gaussian_cap`` / ``tiles_per_gaussian`` on persistent
        HARMFUL overflow (drops at tiles whose final T >= 1/255), shrink
        them back when tiles run persistently near-empty.  ``harmful < 0``
        treats all overflow as harmful.  Returns whether the settings
        changed (the step closure is rebuilt)."""
        effective = overflow if harmful < 0 else harmful
        s = self.settings
        if effective <= 0:
            self._overflow_strikes = 0
            if overflow > 0 and it % 1000 == 0:
                self.log(f"iter {it}: overflow={overflow} all at "
                         f"saturated tiles (harmful=0) — no quality "
                         f"impact, capacities unchanged")
            base_cap = self.cfg.pipeline.visible_capacity or 1024
            base_tpg = 32
            if (num_rendered >= 0 and s.gaussian_cap > base_cap
                    and s.gaussian_cap > 2 * s.chunk):
                avg_fill = num_rendered / (4.0 * s.n_tiles)
                if avg_fill < s.gaussian_cap / 4:
                    self._underfill_strikes += 1
                    if self._underfill_strikes >= 5:
                        new_cap = max(base_cap, s.gaussian_cap // 2,
                                      2 * s.chunk)
                        new_tpg = max(base_tpg, s.tiles_per_gaussian // 2)
                        base_cbf = self.cfg.pipeline.copy_budget_factor
                        new_cbf = (max(base_cbf, s.copy_budget_factor // 2)
                                   if s.copy_budget_factor else 0)
                        self.settings = dataclasses.replace(
                            s, gaussian_cap=new_cap,
                            tiles_per_gaussian=new_tpg,
                            copy_budget_factor=new_cbf)
                        self._build_step()
                        self._underfill_strikes = 0
                        self.log(f"iter {it}: tile fill {avg_fill:.0f} << "
                                 f"cap {s.gaussian_cap}; shrinking "
                                 f"gaussian_cap -> {new_cap}, "
                                 f"tiles_per_gaussian -> {new_tpg}")
                        return True
                else:
                    self._underfill_strikes = 0
            return False
        self._overflow_strikes += 1
        if self._overflow_strikes < strikes_to_act:
            return False
        if not self.cfg.pipeline.overflow_autogrow:
            if self._overflow_strikes == strikes_to_act:
                self.log(f"iter {it}: WARNING render overflow={overflow} "
                         f"(autogrow disabled; drops heal as footprints "
                         f"shrink)")
            return False
        new_cap = min(s.gaussian_cap * 2, self.MAX_GAUSSIAN_CAP)
        new_tpg = min(s.tiles_per_gaussian * 2, self.MAX_TILES_PER_GAUSSIAN)
        new_cbf = (min(s.copy_budget_factor * 2, new_tpg)
                   if s.copy_budget_factor else 0)
        if (new_cap == s.gaussian_cap and new_tpg == s.tiles_per_gaussian
                and new_cbf == s.copy_budget_factor):
            self.log(f"iter {it}: WARNING render overflow={overflow} "
                     f"(harmful={harmful if harmful >= 0 else 'n/a'}) "
                     f"persists at max capacities "
                     f"(gaussian_cap={s.gaussian_cap}); output quality "
                     f"may be degraded at the affected tiles")
            self._overflow_strikes = 0
            return False
        self.settings = dataclasses.replace(
            s, gaussian_cap=new_cap, tiles_per_gaussian=new_tpg,
            copy_budget_factor=new_cbf)
        self._build_step()
        self._overflow_strikes = 0
        self.log(f"iter {it}: WARNING render overflow={overflow} "
                 f"(harmful={harmful if harmful >= 0 else 'n/a'}); growing "
                 f"gaussian_cap {s.gaussian_cap}->{new_cap}, "
                 f"tiles_per_gaussian {s.tiles_per_gaussian}->{new_tpg}"
                 + (f", copy_budget_factor {s.copy_budget_factor}->"
                    f"{new_cbf}" if s.copy_budget_factor else ""))
        return True

    # -- model snapshots ---------------------------------------------------
    def save_snapshot(self, out_dir: str):
        """``write_snapshot`` of the (gathered) state; under a mesh every
        rank gathers and rank 0 writes."""
        state = self.gathered_state()
        if self._rank0():
            write_snapshot(state, out_dir)

    # -- main loop ---------------------------------------------------------
    def fit(self, iterations: Optional[int] = None,
            eval_every: int = 0, log_every: int = 100,
            rate_log_every: int = 0,
            checkpoint_iterations: tuple = (),
            checkpoint_dir: Optional[str] = None,
            metrics_writer=None) -> FitReport:
        """Run the loop from the controller's iteration to ``iterations``
        (default: the config's).  Per iteration, in the JAX package's
        order: the step, the densify epoch when due, the log every
        ``log_every`` iterations (reading the metrics on the host only
        there), the evaluation every ``eval_every``, the checkpoint at
        ``checkpoint_iterations`` and, in the entropy phases, the
        whole-model rate estimate every ``rate_log_every``."""
        opt = self.cfg.optimization
        total = iterations if iterations is not None else opt.iterations
        report = FitReport()
        t0 = time.time()
        n_frames = self.dataset.num_frames
        start = self.controller.current_iteration
        if start >= total:
            # a checkpoint at (or past) the final iteration: training is
            # done; the caller still runs the post-fit stages
            self.log(f"resume iteration {start} >= total {total}: "
                     "training already complete; skipping the loop")
            report.iterations = start - 1
            report.n_active = self.state.n_active
            return report

        self.controller.step()
        self.log(f"loop start at iter {start + 1}/{total} on {self.device}")
        it = start + 1
        metrics = None
        while it <= total:
            metrics = self._run_single(it, n_frames)
            if self.controller.gaussian_adjust_anchor:
                res = self._densify()
                self.log(f"iter {it}: densify +{res.n_grown} "
                         f"-{res.n_pruned} -> {res.n_active}")

            if log_every and it % log_every == 0:
                rec = {"iter": it, "loss": float(metrics.loss),
                       "psnr": float(metrics.psnr),
                       "bpp": float(metrics.bit_per_param),
                       "n_active": self.state.n_active,
                       "l1": float(metrics.l1),
                       "optical": float(metrics.optical_loss)}
                report.history.append(rec)
                if metrics_writer is not None:
                    metrics_writer.write(it, **{k: v for k, v in rec.items()
                                                if k != "iter"})
                ovf = int(metrics.overflow)
                harmful = int(metrics.harmful_overflow)
                self.log(f"iter {it}: loss={rec['loss']:.5f} "
                         f"psnr={rec['psnr']:.2f} bpp={rec['bpp']:.4f} "
                         f"anchors={self.state.n_active} overflow={ovf} "
                         f"harmful={harmful} ({time.time() - t0:.1f}s)")
                self._react_to_overflow(
                    ovf, it, num_rendered=int(metrics.num_rendered),
                    harmful=harmful)

            if eval_every and it % eval_every == 0:
                mode = self.controller.render_mode
                if mode is None:
                    mode = GenerateMode.STE_ENTROPY
                ev = self.evaluate(mode=mode)
                report.evals.append({"iter": it, "psnr": ev["psnr"]})
                self.log(f"iter {it}: eval psnr={ev['psnr']:.2f}")

            if checkpoint_dir and it in checkpoint_iterations:
                from gsvc_tpu_torch.utils.checkpoint import save_checkpoint

                path = f"{checkpoint_dir}/chkpnt{it}.pkl"
                save_checkpoint(path, self, it)
                self.log(f"iter {it}: checkpoint saved {path}")

            # estimated whole-model rate (the reference logs it every 100
            # iterations of the entropy phases, pipeline/train.py:547)
            if (rate_log_every and self.controller.entropy_constrained
                    and it % rate_log_every == 0):
                self._log_rate_estimate(it)

            self.controller.step()
            it += 1

        report.iterations = total
        if metrics is not None:
            report.loss = float(metrics.loss)
            report.psnr = float(metrics.psnr)
            report.bit_per_param = float(metrics.bit_per_param)
        report.n_active = self.state.n_active
        return report

    def _log_rate_estimate(self, it: int):
        """The estimated whole-model rate (the reference logs it every
        100 iterations of the entropy phases, pipeline/train.py:547); on
        rank 0 of a mesh, from the gathered state."""
        from gsvc_tpu_torch.codec.estimate import estimate_final_bits

        state = self.gathered_state()
        if not self._rank0():
            return
        est = estimate_final_bits(state, self.gcfg)
        mb = 8 * 2 ** 20
        self.log(f"iter {it}: est bits MB "
                 f"anchor={est.bit_anchor / mb:.3f} "
                 f"feat={est.bit_feat / mb:.3f} "
                 f"scaling={est.bit_scaling / mb:.3f} "
                 f"offsets={est.bit_offsets / mb:.3f} "
                 f"hash={est.bit_hash / mb:.3f} "
                 f"masks={est.bit_masks / mb:.3f} "
                 f"mlp={est.bit_mlp / mb:.3f} total={est.total / mb:.3f}")

    def _draw_frame(self, n_frames: int) -> int:
        """The step's first frame: one draw from ``self.rng`` per dp group
        (one without a mesh), drawn alike on every rank; this rank takes
        its group's."""
        dp = self.mesh.dp_index if self.mesh is not None else 0
        return [int(self.rng.integers(0, max(n_frames - 1, 1)))
                for _ in range(self.n_dp)][dp]

    def _run_single(self, it: int, n_frames: int):
        """One iteration: draw the frame pair, run the step."""
        mode = self.controller.render_mode
        if mode is None:  # past the schedule (GenerateMode 0 is falsy)
            mode = GenerateMode.STE_ENTROPY
        do_stats = self.controller.gaussian_statis
        fidx = self._draw_frame(n_frames)
        f2 = min(fidx + 1, n_frames - 1)
        fi = min(fidx, self.flows[0].shape[0] - 1)
        self.state, self.adam, self.stats, metrics = self.train_step(
            self.state, self.adam, self.stats, self._lr_values(it),
            float(self.frame_zs[fidx]), float(self.frame_zs[f2]),
            self.images[fidx], self.images[f2],
            (self.flows[0][fi], self.flows[1][fi]), mode=mode,
            do_stats=do_stats, generator=self.generator, timer=self.timer)
        return metrics

    # -- evaluation --------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, mode: GenerateMode = GenerateMode.FULL_PRECISION,
                 frames: Optional[list] = None, decoded: bool = False):
        """Mean PSNR of the fwd/flip-averaged frames (kernel B4; B5f at a
        width that is not a multiple of ``tile_w``).  The
        noise-quantised phases are evaluated without noise: QUANTIZED_NOISE
        in FULL_PRECISION, ENTROPY with STE rounding (STE_ENTROPY).  Under
        a mesh every rank gathers the state, rank 0 renders, and every
        rank returns its result."""
        if mode == GenerateMode.QUANTIZED_NOISE:
            mode = GenerateMode.FULL_PRECISION
        elif mode == GenerateMode.ENTROPY:
            mode = GenerateMode.STE_ENTROPY
        d = self.dataset
        state = self.gathered_state()
        if not self._rank0():
            return _broadcast_result(None)
        idxs = frames if frames is not None else range(d.num_frames)
        vals = []
        for i in idxs:
            img, _, _ = render_frame_bidir(
                state, self.gcfg, float(self.frame_zs[i]), d.x_min,
                d.y_min, d.scale, self.settings, self.window_cap, mode=mode,
                decoded=decoded)
            vals.append(float(psnr(img, gt_f32(self.images[i]))))
        out = {"psnr": float(np.mean(vals)), "per_frame": vals}
        return out if self.mesh is None else _broadcast_result(out)


def _broadcast_result(obj):
    """Rank 0's ``obj`` on every rank of the default process group."""
    import torch.distributed as dist

    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]
