"""Headless debug renders from a checkpoint (port of
gsvc_tpu/cli/debug_vis.py):

  * ``gaussians_xy_<f>.png``: the frame's visible gaussians (radius > 0)
    scattered at their xy positions in NDC;
  * ``flow_scatter_<f>.png``: the gaussians alive in frames f and f+1,
    scattered at their pixel positions in frame f and coloured by their
    own screen motion through the Middlebury wheel;
  * ``flow_field_<f>.png``: the dataset's flow field through the same
    wheel (when the GOP has flows).

    python -m gsvc_tpu_torch.cli.debug_vis --model_path out/ \
        --checkpoint out/chkpnt_final.pkl --source_path frames/ [--frame 0]

Frames render with ``render/pipeline.render_frame`` on ``--device``
(default ``cuda``; ``cpu`` runs the plain versions of the kernels).
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

from gsvc_tpu_torch.cli.common import base_parser, resolve_config


def _scatter_png(path, xs, ys, colors, extent, size_px=800, dot=2,
                 bg=255):
    """Rasterise a scatter plot to a PNG (numpy and PIL, no display)."""
    from PIL import Image

    x0, x1, y0, y1 = extent
    h = int(size_px * (y1 - y0) / max(x1 - x0, 1e-9))
    img = np.full((h, size_px, 3), bg, np.uint8)
    if len(xs):
        px = ((np.asarray(xs) - x0) / (x1 - x0) * (size_px - 1)).astype(int)
        py = ((np.asarray(ys) - y0) / (y1 - y0) * (h - 1)).astype(int)
        keep = (px >= 0) & (px < size_px) & (py >= 0) & (py < h)
        px, py = px[keep], py[keep]
        cols = np.asarray(colors, np.uint8)
        cols = cols[keep] if cols.ndim == 2 else \
            np.broadcast_to(cols, (keep.sum(), 3))
        for dy in range(dot):
            for dx in range(dot):
                yy = np.clip(py + dy, 0, h - 1)
                xx = np.clip(px + dx, 0, size_px - 1)
                img[yy, xx] = cols
    Image.fromarray(img).save(path)


def main(argv=None):
    p = base_parser("gsvc-debug-vis: gaussian/flow scatter debug renders")
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--frame", type=int, default=0)
    p.add_argument("--out", type=str, default=None,
                   help="output dir (default <model_path>/debug_vis)")
    args = p.parse_args(argv)
    cfg = resolve_config(args)

    from gsvc_tpu_torch.framecube.frame import FrameCubeDataset
    from gsvc_tpu_torch.models.gaussians import GenerateMode
    from gsvc_tpu_torch.render.pipeline import render_frame
    from gsvc_tpu_torch.train.fit import GOPFitter
    from gsvc_tpu_torch.train.trainer import _align_to_window1
    from gsvc_tpu_torch.utils.checkpoint import load_checkpoint
    from gsvc_tpu_torch.utils.flow_viz import flow_to_image

    ds = FrameCubeDataset(cfg.pipeline.source_path,
                          cfg.pipeline.optical_path or None)
    fitter = GOPFitter(cfg, ds, seed=args.seed, device=args.device)
    load_checkpoint(args.checkpoint, fitter)

    out = pathlib.Path(args.out or
                       f"{cfg.pipeline.model_path}/debug_vis")
    out.mkdir(parents=True, exist_ok=True)

    f = args.frame
    z1 = float(fitter.frame_zs[f])
    z2 = float(fitter.frame_zs[min(f + 1, ds.num_frames - 1)])
    k = fitter.gcfg.n_offsets

    with torch.no_grad():
        r1, r2 = (render_frame(fitter.state, fitter.gcfg, z, ds.x_min,
                               ds.y_min, ds.scale, fitter.settings,
                               fitter.window_cap,
                               GenerateMode.FULL_PRECISION,
                               rasterizer="pallas")
                  for z in (z1, z2))

        # 1. visible-gaussian xy scatter (NDC)
        xyz = r1.gaussians.xyz.cpu().numpy()
        vis = r1.radii.cpu().numpy() > 0
        _scatter_png(out / f"gaussians_xy_{f}.png", xyz[vis, 0],
                     xyz[vis, 1], np.array([30, 90, 200], np.uint8),
                     (ds.x_min, -ds.x_min, ds.y_min, -ds.y_min))

        # 2. matched-gaussian motion scatter, coloured like the flow wheel
        rows = r1.selection_mask.shape[0]
        shift = (int(r2.window_start) - int(r1.window_start)) * k
        g1, g2 = r1.gaussians, r2.gaussians
        xy1 = (g1.anchor_xyz + g1.offsets_world)[:, :2].cpu().numpy()
        xy2 = _align_to_window1((g2.anchor_xyz + g2.offsets_world)[:, :2],
                                shift, rows).cpu().numpy()
        valid2 = _align_to_window1(r2.selection_mask.to(torch.float32),
                                   shift, rows).cpu().numpy() > 0.5
        common = r1.selection_mask.cpu().numpy() & valid2

    pix = np.round((xy1 - np.array([[ds.x_min, ds.y_min]])) * ds.scale)
    in_b = ((pix[:, 0] >= 0) & (pix[:, 0] < ds.width)
            & (pix[:, 1] >= 0) & (pix[:, 1] < ds.height))
    m = common & in_b
    uv = (xy2 - xy1) * ds.scale           # screen motion in pixels
    # (no gaussian alive in both frames: an empty scatter)
    cols = flow_to_image(uv[m, 0][None], uv[m, 1][None])[0] if m.any() \
        else np.zeros((0, 3), np.uint8)                       # [n, 3]
    _scatter_png(out / f"flow_scatter_{f}.png", pix[m, 0], pix[m, 1],
                 cols, (0, ds.width, 0, ds.height))

    # 3. the dataset flow field through the same wheel
    if ds.flows is not None:
        from PIL import Image

        fl = np.asarray(ds.flows[min(f, len(ds.flows) - 1)])
        Image.fromarray(flow_to_image(fl[0], fl[1])).save(
            out / f"flow_field_{f}.png")

    print(f"debug renders written to {out}")


if __name__ == "__main__":
    main()
