"""GOP fitting: the host loop around the training step (port of
gsvc_tpu/train/fit.py without a mesh; reference: pipeline/train.py:
267-605).

The host samples one frame pair per iteration (one ``rng.integers`` draw,
as the JAX package's single-step path), feeds the learning rates and runs
one step on the device.  Frames live on the device as uint8 [T, 3, H, W],
flows as int8 with a per-frame scale (zeros when the GOP has none).
Anchor buffers are padded to a capacity and z-sorted, so a frame's TSW
window is one slice.

Ported: the FULL_PRECISION and QUANTIZED_NOISE phases.  Reaching an
entropy phase or a densify epoch raises ``NotImplementedError``: the
next slice of the port.
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
    NEXT_SLICE, GaussianConfig, GenerateMode, init_model, mean_nn3_distance,
    update_anchor_bound,
)
from gsvc_tpu_torch.render.batched import render_frame_bidir
from gsvc_tpu_torch.render.pipeline import make_raster_settings
from gsvc_tpu_torch.train.controller import TrainingController
from gsvc_tpu_torch.train.optim import adam_init
from gsvc_tpu_torch.train.schedules import build_schedules
from gsvc_tpu_torch.train.trainer import (
    gt_f32, init_stats, make_step_body,
)

# rasterizer settings the port serves: all name the same compositing
# function (the mirror kernels); "pallas_stream" is kernel pair B6
_MIRROR_RASTERIZERS = ("", "jnp", "pallas", "pallas_train")


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


class GOPFitter:
    """Fits one frame cube (= encodes one GOP) on one device.

    ``device`` defaults to ``cuda`` and raises without a card; ``cpu``
    runs the plain PyTorch versions of the kernels (the tests)."""

    MAX_GAUSSIAN_CAP = 4096
    MAX_TILES_PER_GAUSSIAN = 128

    def __init__(self, cfg: Config, dataset: FrameCubeDataset,
                 seed: int = 0, log_fn: Optional[Callable] = None,
                 device=None):
        self.cfg = cfg
        self.dataset = dataset
        self.device = resolve_device(device)
        self.gcfg = GaussianConfig.from_model_config(cfg.model)
        self.log = log_fn or (lambda *a, **k: None)
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        if cfg.pipeline.rasterizer not in _MIRROR_RASTERIZERS:
            raise NotImplementedError(
                f"rasterizer {cfg.pipeline.rasterizer!r} is not ported; the "
                f"port trains through the mirror kernels B1/B2")
        if cfg.pipeline.mesh_shape:
            raise NotImplementedError("the port fits on one device; "
                                      "pipeline.mesh_shape is not ported")

        opt = cfg.optimization
        pts = init_point_cloud(dataset.x_min, dataset.y_min, dataset.z_min,
                               n=opt.init_anchor_num, rng=self.rng)
        self.capacity = _round_up(int(opt.init_anchor_num * 1.5), 1024)
        self.state = init_model(self.generator, self.gcfg, pts,
                                self.capacity,
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
        self.stats = init_stats(self.capacity, self.gcfg.n_offsets,
                                self.device)
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

    def _build_step(self):
        """The step closure over the current settings and window (the
        JAX package re-jits here; the port only rebuilds the closure)."""
        d = self.dataset
        self.train_step = make_step_body(
            self.gcfg, self.settings, self.window_cap,
            self.cfg.optimization, width=d.width, height=d.height,
            scale=d.scale, x_min=d.x_min, y_min=d.y_min)

    def _lr_values(self, it: int) -> Dict[str, float]:
        return {name: sched(it) for name, sched in self.schedules.items()}

    def _maybe_resize_window(self, z_sorted: np.ndarray, n_active: int
                             ) -> bool:
        """Grow, or shrink below half, the padded TSW window to the
        current anchor density (hysteresis avoids rebuild thrash)."""
        new_window = compute_window_cap(z_sorted, n_active, self.frame_zs,
                                        self.gcfg.threshold)
        if new_window > self.window_cap or \
                new_window <= self.window_cap // 2:
            old = self.window_cap
            self.window_cap = new_window
            self.log(f"window_cap {old} -> {new_window}")
            return True
        return False

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
                 f"tiles_per_gaussian {s.tiles_per_gaussian}->{new_tpg}")
        return True

    # -- main loop ---------------------------------------------------------
    def fit(self, iterations: Optional[int] = None,
            eval_every: int = 0, log_every: int = 100,
            checkpoint_iterations: tuple = (),
            checkpoint_dir: Optional[str] = None,
            metrics_writer=None) -> FitReport:
        """Run the loop from the controller's iteration to ``iterations``
        (default: the config's).  Logs every ``log_every`` iterations
        (reading the metrics on the host only there), evaluates every
        ``eval_every`` and checkpoints at ``checkpoint_iterations``."""
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
                raise NotImplementedError(
                    f"iteration {it} is a densify epoch: {NEXT_SLICE}")

            if log_every and it % log_every == 0:
                rec = {"iter": it, "loss": float(metrics.loss),
                       "psnr": float(metrics.psnr), "bpp": 0.0,
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
                         f"psnr={rec['psnr']:.2f} "
                         f"anchors={self.state.n_active} overflow={ovf} "
                         f"harmful={harmful} ({time.time() - t0:.1f}s)")
                self._react_to_overflow(
                    ovf, it, num_rendered=int(metrics.num_rendered),
                    harmful=harmful)

            if eval_every and it % eval_every == 0:
                ev = self.evaluate(mode=self.controller.render_mode)
                report.evals.append({"iter": it, "psnr": ev["psnr"]})
                self.log(f"iter {it}: eval psnr={ev['psnr']:.2f}")

            if checkpoint_dir and it in checkpoint_iterations:
                from gsvc_tpu_torch.utils.checkpoint import save_checkpoint

                path = f"{checkpoint_dir}/chkpnt{it}.pkl"
                save_checkpoint(path, self, it)
                self.log(f"iter {it}: checkpoint saved {path}")

            self.controller.step()
            it += 1

        report.iterations = total
        if metrics is not None:
            report.loss = float(metrics.loss)
            report.psnr = float(metrics.psnr)
        report.n_active = self.state.n_active
        return report

    def _run_single(self, it: int, n_frames: int):
        """One iteration: draw the frame pair, run the step."""
        mode = self.controller.render_mode
        if mode is None or mode in (GenerateMode.ENTROPY,
                                    GenerateMode.STE_ENTROPY):
            name = "STE_ENTROPY" if mode is None else mode.name
            raise NotImplementedError(
                f"iteration {it} is in the {name} phase: {NEXT_SLICE}")
        do_stats = self.controller.gaussian_statis
        fidx = int(self.rng.integers(0, max(n_frames - 1, 1)))
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
        """Mean PSNR of the fwd/flip-averaged frames (kernel B4).  The
        noise-quantised phase evaluates in FULL_PRECISION; entropy modes
        are the next slice."""
        if mode == GenerateMode.QUANTIZED_NOISE:
            mode = GenerateMode.FULL_PRECISION
        if mode not in (GenerateMode.FULL_PRECISION, GenerateMode.DECODED):
            name = "STE_ENTROPY" if mode is None else mode.name
            raise NotImplementedError(f"evaluation in {name}: {NEXT_SLICE}")
        d = self.dataset
        idxs = frames if frames is not None else range(d.num_frames)
        vals = []
        for i in idxs:
            img, _, _ = render_frame_bidir(
                self.state, self.gcfg, float(self.frame_zs[i]), d.x_min,
                d.y_min, d.scale, self.settings, self.window_cap, mode=mode,
                decoded=decoded)
            vals.append(float(psnr(img, gt_f32(self.images[i]))))
        return {"psnr": float(np.mean(vals)), "per_frame": vals}
