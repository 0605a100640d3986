"""Full-video evaluation and frame export (port of gsvc_tpu/report.py:
``_make_eval_render``, ``evaluate_video``, ``bits_per_pixel``).

``_make_eval_render`` gives the one-frame decode render that
``evaluate_video`` and ``viewer.ViewerServer`` call.  It reads two
environment variables when it is made, as the JAX package does:
``GSVC_DECODE`` (``DECODE_KINDS``; any other value raises) and
``GSVC_RASTERIZER`` (``render/pipeline.py:RASTERIZERS``).  ``"bidir"``, the
default, renders the fwd/flip-averaged frame through
``render_frame_bidir`` (kernel B4; B5f's two views at widths that are not
a multiple of ``tile_w``); ``"mirror"`` renders both views and averages
them through ``render_frame_views(..., inference=True)`` (kernel B1;
B5f elsewhere).  With ``GSVC_RASTERIZER=pallas_stream`` both go through
``render_frame_views`` on the stream composite (kernel B6f).

``evaluate_video`` times the renders — each ends in a device synchronise
— and, given ground truth, scores PSNR, SSIM, MS-SSIM and, given LPIPS
weights (``metrics/lpips.py``), LPIPS per frame.  Results are plain dicts.
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
from gsvc_tpu_torch.metrics.lpips import lpips
from gsvc_tpu_torch.models.gaussians import (
    GaussianConfig, GenerateMode, ModelState,
)
from gsvc_tpu_torch.render.batched import (
    render_frame_bidir, render_frame_views,
)
from gsvc_tpu_torch.render.pipeline import check_rasterizer
from gsvc_tpu_torch.render.splat import RasterSettings

# GSVC_DECODE values: the one-pass bidirectional decode and the two-view
# mirror decode
DECODE_KINDS = ("bidir", "mirror")


def check_decode(name: str) -> str:
    """``name`` if it is a ``GSVC_DECODE`` value, else ValueError."""
    if name not in DECODE_KINDS:
        raise ValueError(f"unknown GSVC_DECODE {name!r}; the port serves "
                         f"{DECODE_KINDS}")
    return name


def _make_eval_render(cfg: GaussianConfig, settings: RasterSettings,
                      window_cap: int, x_min: float, y_min: float,
                      scale: float, mode: GenerateMode, decoded: bool):
    """The decode render of one frame, ``render(state, frame_z) -> [3, H,
    W]``, chosen by ``GSVC_DECODE`` and ``GSVC_RASTERIZER`` (module
    docstring)."""
    rasterizer = check_rasterizer(os.environ.get("GSVC_RASTERIZER", ""))
    decode_kind = check_decode(os.environ.get("GSVC_DECODE", "bidir"))

    def render(state: ModelState, frame_z: float) -> torch.Tensor:
        with torch.no_grad():
            if decode_kind == "bidir" and rasterizer != "pallas_stream":
                img, _, _ = render_frame_bidir(
                    state, cfg, float(frame_z), x_min, y_min, scale,
                    settings, window_cap, mode=mode, decoded=decoded)
                return img
            img, _, _, _ = render_frame_views(
                state, cfg, float(frame_z), x_min, y_min, scale, settings,
                window_cap, mode=mode, decoded=decoded, inference=True,
                rasterizer=rasterizer)
            return img

    return render


def evaluate_video(state: ModelState, cfg: GaussianConfig,
                   settings: RasterSettings, window_cap: int,
                   frame_zs: Sequence[float], x_min: float, y_min: float,
                   scale: float, gt_images=None,
                   mode: GenerateMode = GenerateMode.DECODED,
                   decoded: bool = True,
                   dump_dir: Optional[str] = None,
                   compute_msssim: bool = True,
                   lpips_weights: Optional[dict] = None,
                   frame_ids: Optional[Sequence[int]] = None) -> dict:
    """Render every frame of ``frame_zs`` on the state's device through
    ``_make_eval_render``; report decode fps and, if ``gt_images`` is
    given (indexable by frame id, [H, W, 3] or [3, H, W] float in [0, 1]),
    mean PSNR/SSIM/MS-SSIM, and LPIPS given ``lpips_weights`` (from
    ``metrics.lpips.load_lpips_weights``).

    ``frame_ids`` names the frames of ``frame_zs`` (default 0..n-1): they
    index ``gt_images`` and the dumped PNG names."""
    dev = state.anchors.anchor.device
    render = _make_eval_render(cfg, settings, window_cap, x_min, y_min,
                               scale, mode, decoded)
    n = len(frame_zs)
    ids = list(range(n)) if frame_ids is None else list(frame_ids)
    can_msssim = (compute_msssim and settings.image_height >= 176
                  and settings.image_width >= 176)
    dump_out = None
    if dump_dir is not None:
        dump_out = pathlib.Path(dump_dir)
        dump_out.mkdir(parents=True, exist_ok=True)

    psnrs, ssims, msssims, lpipss = [], [], [], []
    render_time = 0.0
    with torch.no_grad():
        for fid, fz in zip(ids, frame_zs):
            t0 = time.perf_counter()
            img = render(state, fz)
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
                if lpips_weights is not None:
                    lpipss.append(float(lpips(lpips_weights,
                                              img.permute(1, 2, 0),
                                              gt.permute(1, 2, 0))))
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
        if lpipss:
            result["lpips"] = float(np.mean(lpipss))
    return result


def bits_per_pixel(total_bits: float, width: int, height: int,
                   num_frames: int) -> float:
    return total_bits / (width * height * num_frames)
