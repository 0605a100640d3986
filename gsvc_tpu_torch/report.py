"""Full-video evaluation and frame export (port of ``evaluate_video``,
gsvc_tpu/report.py, with the decoded render loop).

Renders each frame through ``render_frame_bidir`` (the decode path: kernel
B4), or, when the environment sets ``GSVC_RASTERIZER=pallas_stream``, as
the JAX package's ``_make_eval_render`` chooses, through
``render_frame_views`` on the stream composite (kernel B6f, both views);
times the renders on the device clock's terms — each render ends in a
device synchronise — and, given ground truth, scores PSNR, SSIM and
MS-SSIM per frame.  Results are plain dicts.  (JAX's ``GSVC_DECODE``
two-view "mirror" decode is not ported.)
"""

from __future__ import annotations

import os
import pathlib
import time
from typing import Optional, Sequence

import numpy as np
import torch

from gsvc_tpu_torch.device import synchronize
from gsvc_tpu_torch.metrics.image import ms_ssim, psnr, ssim
from gsvc_tpu_torch.models.gaussians import (
    GaussianConfig, GenerateMode, ModelState,
)
from gsvc_tpu_torch.render.batched import (
    render_frame_bidir, render_frame_views,
)
from gsvc_tpu_torch.render.pipeline import check_rasterizer
from gsvc_tpu_torch.render.splat import RasterSettings


def evaluate_video(state: ModelState, cfg: GaussianConfig,
                   settings: RasterSettings, window_cap: int,
                   frame_zs: Sequence[float], x_min: float, y_min: float,
                   scale: float, gt_images=None,
                   mode: GenerateMode = GenerateMode.DECODED,
                   decoded: bool = True,
                   dump_dir: Optional[str] = None,
                   compute_msssim: bool = True,
                   frame_ids: Optional[Sequence[int]] = None) -> dict:
    """Render every frame of ``frame_zs`` on the state's device; report
    decode fps and, if ``gt_images`` is given (indexable by frame id,
    [H, W, 3] or [3, H, W] float in [0, 1]), mean PSNR/SSIM/MS-SSIM.

    ``frame_ids`` names the frames of ``frame_zs`` (default 0..n-1): they
    index ``gt_images`` and the dumped PNG names."""
    dev = state.anchors.anchor.device
    stream = check_rasterizer(
        os.environ.get("GSVC_RASTERIZER", "")) == "pallas_stream"
    n = len(frame_zs)
    ids = list(range(n)) if frame_ids is None else list(frame_ids)
    can_msssim = (compute_msssim and settings.image_height >= 176
                  and settings.image_width >= 176)
    dump_out = None
    if dump_dir is not None:
        dump_out = pathlib.Path(dump_dir)
        dump_out.mkdir(parents=True, exist_ok=True)

    psnrs, ssims, msssims = [], [], []
    render_time = 0.0
    with torch.no_grad():
        for fid, fz in zip(ids, frame_zs):
            t0 = time.perf_counter()
            if stream:
                img, _, _, _ = render_frame_views(
                    state, cfg, float(fz), x_min, y_min, scale, settings,
                    window_cap, mode=mode, decoded=decoded, inference=True,
                    rasterizer="pallas_stream")
            else:
                img, _, _ = render_frame_bidir(
                    state, cfg, float(fz), x_min, y_min, scale, settings,
                    window_cap, mode=mode, decoded=decoded)
            synchronize(dev)
            render_time += time.perf_counter() - t0
            if gt_images is not None:
                gt = torch.as_tensor(np.asarray(gt_images[fid]),
                                     dtype=torch.float32, device=dev)
                if gt.dim() == 3 and gt.shape[-1] == 3:  # HWC -> CHW
                    gt = gt.permute(2, 0, 1)
                psnrs.append(float(psnr(img, gt)))
                ssims.append(float(ssim(img, gt)))
                if can_msssim:
                    msssims.append(float(ms_ssim(img, gt)))
            if dump_out is not None:
                from PIL import Image

                arr = (img.clamp(0, 1) * 255).permute(1, 2, 0).cpu().numpy()
                Image.fromarray(arr.astype(np.uint8)).save(
                    dump_out / f"frame_{fid:05d}.png")

    result = {"fps": n / render_time if render_time else 0.0,
              "num_frames": n, "render_seconds": render_time,
              "device": str(dev)}
    if psnrs:
        result.update(psnr=float(np.mean(psnrs)),
                      ssim=float(np.mean(ssims)), per_frame_psnr=psnrs)
        if msssims:
            result["ms_ssim"] = float(np.mean(msssims))
    return result



def bits_per_pixel(total_bits: float, width: int, height: int,
                   num_frames: int) -> float:
    return total_bits / (width * height * num_frames)
