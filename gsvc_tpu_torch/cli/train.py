"""Encode one GOP by fitting it (port of gsvc_tpu/cli/train.py on the
single-GOP path).

    python -m gsvc_tpu_torch.cli.train --source_path frames/ \
        --model_path out/ --config_path cfgs/uvg.yaml

Fits through every phase of the config's schedule (densify epochs
included), logging the estimated rate every 500 iterations of the entropy
phases, and writes ``chkpnt_final.pkl`` (the JAX package's checkpoint
format).  Then, unless ``--skip_codec``, it logs the estimated size,
encodes the fitted model into ``bitstreams/`` (the JAX package's format,
byte for byte), decodes it and evaluates the decoded model on the frames
(every ``--eval_stride``-th).  ``results.json`` holds the JAX package's
keys plus ``device``.  A single GOP and a single device only:
``--gop_size``, ``--mesh``, ``--profile`` and ``--lpips_weights`` raise.
``--device cpu`` runs the plain PyTorch path (tests); the default is
``cuda`` and fails without a card.
"""

from __future__ import annotations

import json
import logging
import pathlib

from gsvc_tpu_torch.cli.common import (
    base_parser, model_config_dict, resolve_config,
)

log = logging.getLogger("gsvc_tpu_torch.train")


class _StridedFrames:
    """Index-mapped view over a lazy frame stack: view[i] == base[i*s]."""

    def __init__(self, base, stride):
        self.base, self.stride = base, stride

    def __getitem__(self, i):
        return self.base[i * self.stride]


def _codec_eval(state, gcfg, settings, window_cap, capacity, frame_zs,
                dataset, cfg, out_dir, log, eval_stride=1):
    """Encode -> decode -> evaluate one fitted GOP model.  The bitstream
    and bpp cover every frame; ``eval_stride`` subsamples only the
    frames the metrics average (recorded in the results when != 1)."""
    from gsvc_tpu_torch.codec.bitstream import (
        conduct_decoding, conduct_encoding,
    )
    from gsvc_tpu_torch.models.gaussians import GenerateMode
    from gsvc_tpu_torch.report import bits_per_pixel, evaluate_video
    from gsvc_tpu_torch.utils.checkpoint import save_streams

    streams, _, _, enc_state, enc_time = conduct_encoding(
        state, gcfg, model_config=model_config_dict(cfg),
        video_info={"width": dataset.width, "height": dataset.height,
                    "num_frames": dataset.num_frames})
    total_bytes = save_streams(str(pathlib.Path(out_dir) / "bitstreams"),
                               streams)
    bpp = bits_per_pixel(total_bytes * 8, dataset.width, dataset.height,
                         dataset.num_frames)
    log("encoded %.3f MB (%.5f bpp) in %.1fs"
        % (total_bytes / 2 ** 20, bpp, enc_time))

    # the decode template is the encoder's state: its MLPs are the
    # quantized copies the streams were coded against
    dev = state.anchors.anchor.device
    dec_state, _, dec_time = conduct_decoding(
        streams, gcfg, enc_state, capacity=capacity, device=dev)
    log("decoded in %.1fs" % dec_time)

    eval_zs, gt = frame_zs, dataset.images
    if eval_stride > 1:
        eval_zs = frame_zs[::eval_stride]
        gt = _StridedFrames(gt, eval_stride) if gt is not None else None
    ev = evaluate_video(
        dec_state, gcfg, settings, window_cap, eval_zs, dataset.x_min,
        dataset.y_min, dataset.scale, gt_images=gt,
        mode=GenerateMode.DECODED, decoded=True)
    log("decoded eval: psnr=%.2f ssim=%.4f lpips=%s fps=%.1f"
        % (ev.get("psnr", 0), ev.get("ssim", 0), ev.get("lpips", "n/a"),
           ev["fps"]))
    results = dict(bpp=bpp, encode_seconds=enc_time,
                   decode_seconds=dec_time,
                   decoded_psnr=ev.get("psnr"),
                   decoded_ssim=ev.get("ssim"),
                   decoded_ms_ssim=ev.get("ms_ssim"),
                   decoded_lpips=ev.get("lpips"),
                   decode_fps=ev["fps"],
                   size_mb=total_bytes / 2 ** 20)
    if eval_stride > 1:
        results["eval_stride"] = eval_stride
        results["eval_frames"] = len(eval_zs)
    return results


def main(argv=None):
    parser = base_parser(__doc__)
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="resume from a training checkpoint (either "
                             "package's)")
    parser.add_argument("--checkpoint_iterations", type=int, nargs="*",
                        default=[], help="iterations to checkpoint at")
    parser.add_argument("--eval_every", type=int, default=0)
    parser.add_argument("--skip_codec", action="store_true",
                        help="fit only; skip the encode/decode round trip")
    parser.add_argument("--eval_stride", type=int, default=1)
    parser.add_argument("--profile", type=str, default=None)
    parser.add_argument("--lpips_weights", type=str, default=None)
    parser.add_argument("--gop_size", type=int, default=0)
    parser.add_argument("--gop_parallel", action="store_true")
    parser.add_argument("--mesh", type=str, default=None)
    args = parser.parse_args(argv)
    cfg = resolve_config(args)

    if args.gop_size or args.gop_parallel:
        raise NotImplementedError("--gop_size / --gop_parallel (per-GOP "
                                  "segmenting) is not ported yet")
    if args.mesh or cfg.pipeline.mesh_shape:
        raise NotImplementedError("--mesh (SPMD fitting) is not ported yet")
    if args.profile:
        raise NotImplementedError("--profile is not ported yet")
    if args.lpips_weights:
        raise NotImplementedError(
            "--lpips_weights: LPIPS (metrics/lpips.py) is not ported yet")

    from gsvc_tpu_torch.config import save_config
    from gsvc_tpu_torch.framecube.frame import FrameCubeDataset
    from gsvc_tpu_torch.train.fit import GOPFitter
    from gsvc_tpu_torch.utils.checkpoint import (
        load_checkpoint, save_checkpoint,
    )

    out = pathlib.Path(cfg.pipeline.model_path)
    out.mkdir(parents=True, exist_ok=True)
    handler = logging.FileHandler(out / "output.log")
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    try:
        save_config(cfg, str(out / "cfg_args.yaml"))
        dataset = FrameCubeDataset(cfg.pipeline.source_path,
                                   cfg.pipeline.optical_path or None,
                                   prefetch=not cfg.pipeline.skip_prefetch)
        log.info("dataset: %dx%d, %d frames", dataset.width, dataset.height,
                 dataset.num_frames)
        fitter = GOPFitter(cfg, dataset, seed=args.seed, log_fn=log.info,
                           device=args.device)
        if args.checkpoint:
            start = load_checkpoint(args.checkpoint, fitter)
            log.info("resumed from %s at iteration %d", args.checkpoint,
                     start)
        report = fitter.fit(eval_every=args.eval_every, rate_log_every=500,
                            checkpoint_iterations=tuple(
                                args.checkpoint_iterations),
                            checkpoint_dir=str(out))
        ckpt = out / "chkpnt_final.pkl"
        save_checkpoint(str(ckpt), fitter, report.iterations)
        log.info("checkpoint saved: %s", ckpt)
        results = {"fit_psnr": report.psnr, "iterations": report.iterations,
                   "n_anchors": report.n_active,
                   "device": str(fitter.device)}
        if not args.skip_codec:
            from gsvc_tpu_torch.codec.estimate import estimate_final_bits

            est = estimate_final_bits(fitter.state, fitter.gcfg)
            log.info("estimated bits: total=%.3f MB",
                     est.total / 8 / 2 ** 20)
            results.update(_codec_eval(
                fitter.state, fitter.gcfg, fitter.settings,
                fitter.window_cap, fitter.capacity, fitter.frame_zs,
                dataset, cfg, str(out), log.info,
                eval_stride=args.eval_stride))
        (out / "results.json").write_text(json.dumps(results, indent=2))
        log.info("results: %s", json.dumps(results))
    finally:
        log.removeHandler(handler)
        handler.close()
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
