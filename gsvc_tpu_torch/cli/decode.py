"""Decode a bitstream directory and render the video — the port's
standalone decoder (port of gsvc_tpu/cli/decode.py).

Bitstreams in, frames out; no checkpoint needed.  Host entropy decode
runs in numpy and the C++ codec; generation, projection, binning and the
bidirectional composite kernel run on the card.

    python -m gsvc_tpu_torch.cli.decode --bitstream_path out/bitstreams \
        --model_path decoded_out [--source_path frames/ for metrics] \
        [--lpips_weights proxy|weights.npz]

The render follows ``GSVC_DECODE`` (``bidir``, the default: kernel B4;
``mirror``: both views through kernel B1) and ``GSVC_RASTERIZER``, as
``report.evaluate_video`` reads them.  ``--device cpu`` runs the plain
PyTorch path on the CPU (tests); the default is ``cuda`` and fails
without a card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
from typing import NamedTuple

import numpy as np


class Decoded(NamedTuple):
    """A decoded bitstream, ready to render."""

    state: object          # models.gaussians.ModelState on the device
    cfg: object            # models.gaussians.GaussianConfig
    settings: object       # render.splat.RasterSettings
    window_cap: int
    frame_zs: np.ndarray   # [T] float32 frame-plane z
    x_min: float
    y_min: float
    scale: float
    meta: object           # codec.bitstream.EncodeMeta
    seconds: float         # host decode wall time


def decode_bitstream(bitstream_path: str, device=None) -> Decoded:
    """Decode a bitstream directory onto ``device`` (default ``cuda``)."""
    from gsvc_tpu_torch.codec.bitstream import (
        conduct_decoding, load_streams, read_meta,
    )
    from gsvc_tpu_torch.config import ModelConfig
    from gsvc_tpu_torch.device import resolve_device
    from gsvc_tpu_torch.framecube.frame import frame_geometry, frame_z
    from gsvc_tpu_torch.models.gaussians import (
        GaussianConfig, decode_template,
    )
    from gsvc_tpu_torch.render.pipeline import make_raster_settings
    from gsvc_tpu_torch.train.fit import compute_window_cap

    dev = resolve_device(device)
    streams = load_streams(bitstream_path)
    meta = read_meta(streams)
    if meta.model_config is None or meta.video_info is None:
        raise ValueError("bitstream lacks self-contained decode info "
                         "(model_config / video_info)")
    cfg = GaussianConfig.from_model_config(ModelConfig(**meta.model_config))
    vi = meta.video_info
    w, h, t = vi["width"], vi["height"], vi["num_frames"]
    scale, x_min, y_min, z_min = frame_geometry(w, h, t)

    template = decode_template(cfg, x_min, y_min, z_min)
    state, meta, seconds = conduct_decoding(
        streams, cfg, template, capacity=max(meta.anchor_num, 8), device=dev)

    frame_zs = np.array([frame_z(i, t, scale) for i in range(t)], np.float32)
    window_cap = compute_window_cap(
        state.anchors.anchor[:, 2].cpu().numpy(), state.n_active, frame_zs,
        cfg.threshold)
    return Decoded(state=state, cfg=cfg,
                   settings=make_raster_settings(cfg, h, w),
                   window_cap=window_cap, frame_zs=frame_zs, x_min=x_min,
                   y_min=y_min, scale=scale, meta=meta, seconds=seconds)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--bitstream_path", type=str, required=True)
    p.add_argument("--model_path", type=str, required=True)
    p.add_argument("--source_path", type=str, default="",
                   help="original frames (optional, for metrics)")
    p.add_argument("--dump_frames", action="store_true")
    p.add_argument("--lpips_weights", type=str, default=None,
                   help="npz of VGG16+lin LPIPS weights, or 'proxy'")
    # accepted for parity with the JAX decoder, whose random template
    # initialisation it seeds; the port's template draws no random numbers
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    from gsvc_tpu_torch.framecube.frame import FrameFolder
    from gsvc_tpu_torch.report import evaluate_video
    from gsvc_tpu_torch.utils.logging import setup_logging

    out_dir = pathlib.Path(args.model_path)
    log = setup_logging(str(out_dir), filename="decode.log")
    dec = decode_bitstream(args.bitstream_path, device=args.device)
    log.info("decoded %d anchors in %.2fs", dec.meta.anchor_num, dec.seconds)
    gt = FrameFolder(args.source_path) if args.source_path else None
    dump = str(out_dir / "frames") if args.dump_frames else None
    lpips_w = None
    if args.lpips_weights:
        from gsvc_tpu_torch.metrics.lpips import load_lpips_weights

        lpips_w = load_lpips_weights(args.lpips_weights,
                                     device=dec.state.anchors.anchor.device)
    ev = evaluate_video(dec.state, dec.cfg, dec.settings, dec.window_cap,
                        dec.frame_zs, dec.x_min, dec.y_min, dec.scale,
                        gt_images=gt, dump_dir=dump, lpips_weights=lpips_w)
    summary = {k: v for k, v in ev.items() if not isinstance(v, list)}
    log.info("decode eval: %s", json.dumps(summary))
    print(json.dumps(summary))
    (out_dir / "decode_results.json").write_text(json.dumps(summary,
                                                            indent=2))
    return ev


if __name__ == "__main__":
    main()
