"""Encode a video by fitting it (port of gsvc_tpu/cli/train.py).

    python -m gsvc_tpu_torch.cli.train --source_path frames/ \
        --model_path out/ --config_path cfgs/uvg.yaml [--gop_size 60]

One GOP: fits through every phase of the config's schedule (densify
epochs included), logging the estimated rate every 500 iterations of the
entropy phases and the logged scalars to ``metrics.jsonl``, and writes
``cfg_args.yaml``, ``point_cloud/final/`` (``point_cloud.ply`` and
``networks.pkl``) and ``chkpnt_final.pkl`` (the JAX package's checkpoint
format).  Then, unless ``--skip_codec``, it logs the estimated size,
encodes the fitted model into ``bitstreams/`` (the JAX package's format,
byte for byte), decodes it and evaluates the decoded model on the frames
(every ``--eval_stride``-th; LPIPS too with ``--lpips_weights``, an npz
or ``proxy``).  ``results.json`` holds the JAX package's keys plus
``device``.  ``--profile DIR`` first runs up to 50 iterations under
``torch.profiler`` and writes ``DIR/trace.json`` (Chrome trace format);
the fit then continues from there.

``--gop_size N`` fits one model per segment of N frames instead
(``_train_segmented``), each into ``gop_<first frame:05d>/``, with a
summary in ``results.json``.  Multi-GPU fitting (``--gop_parallel``,
``--mesh``) is not ported and raises.  ``--device cpu`` runs the plain
PyTorch path (tests); the default is ``cuda`` and fails without a card.
"""

from __future__ import annotations

import json
import pathlib

from gsvc_tpu_torch.cli.common import (
    base_parser, model_config_dict, resolve_config,
)


def _train_segmented(args, cfg):
    """Fit one model per GOP segment of a long video (the reference's
    UVG protocol), calling ``main`` once per segment.

    Each segment's frames (and the flows between them) are symlinked into
    a temporary directory; its outputs land in
    ``<model_path>/gop_<start:05d>/``.  A segment's ``main`` gets the JAX
    package's flags — ``--source_path --model_path --seed`` and, where
    given, ``--optical_path --config_path --lmbda --iterations`` — plus
    ``--device``; as in the JAX package, ``--set``, ``--lpips_weights``,
    ``--skip_codec``, ``--eval_stride`` and ``--profile`` are not passed
    on, so a schedule for the segments goes in the config file.  The mean
    decoded PSNR and bpp go to ``<model_path>/results.json``."""
    import os
    import tempfile

    src = pathlib.Path(cfg.pipeline.source_path)
    frames = sorted(p for p in src.iterdir() if p.is_file())
    flow_dir = pathlib.Path(cfg.pipeline.optical_path) \
        if cfg.pipeline.optical_path else None
    flows = sorted(p for p in flow_dir.iterdir()) if flow_dir else []

    g = args.gop_size
    segments = [(i, frames[i:i + g]) for i in range(0, len(frames), g)]
    aggregate = []
    root = pathlib.Path(cfg.pipeline.model_path)
    for start, seg in segments:
        with tempfile.TemporaryDirectory() as td:
            fdir = pathlib.Path(td) / "frames"
            fdir.mkdir()
            for p in seg:
                os.symlink(p.resolve(), fdir / p.name)
            odir = None
            if flows:
                odir = pathlib.Path(td) / "flow"
                odir.mkdir()
                for p in flows[start:start + len(seg) - 1]:
                    os.symlink(p.resolve(), odir / p.name)
            seg_args = ["--source_path", str(fdir),
                        "--model_path", str(root / f"gop_{start:05d}"),
                        "--seed", str(args.seed)]
            if odir is not None:
                seg_args += ["--optical_path", str(odir)]
            if args.config_path:
                seg_args += ["--config_path", args.config_path]
            if args.lmbda is not None:
                seg_args += ["--lmbda", str(args.lmbda)]
            if args.iterations is not None:
                seg_args += ["--iterations", str(args.iterations)]
            seg_args += ["--device", args.device]
            aggregate.append(main(seg_args))
    summary = {
        "gops": len(segments),
        "mean_psnr": float(sum(r.get("decoded_psnr") or 0
                               for r in aggregate) / len(aggregate)),
        "mean_bpp": float(sum(r.get("bpp") or 0
                              for r in aggregate) / len(aggregate)),
        "per_gop": aggregate,
    }
    (root / "results.json").write_text(json.dumps(summary, indent=2))
    return summary


class _StridedFrames:
    """Index-mapped view over a lazy frame stack: view[i] == base[i*s]."""

    def __init__(self, base, stride):
        self.base, self.stride = base, stride

    def __getitem__(self, i):
        return self.base[i * self.stride]


def _codec_eval(state, gcfg, settings, window_cap, capacity, frame_zs,
                dataset, cfg, out_dir, lpips_arg, log, eval_stride=1):
    """Encode -> decode -> evaluate one fitted GOP model.  The bitstream
    and bpp cover every frame; ``eval_stride`` subsamples only the
    frames the metrics average (recorded in the results when != 1).
    ``lpips_arg``: an LPIPS weights npz or ``"proxy"`` (the proxy's
    results carry ``lpips_kind: proxy-vgg16w4``), or None."""
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

    lpips_w = None
    if lpips_arg:
        from gsvc_tpu_torch.metrics.lpips import load_lpips_weights

        lpips_w = load_lpips_weights(lpips_arg, device=dev)
    eval_zs, gt = frame_zs, dataset.images
    if eval_stride > 1:
        eval_zs = frame_zs[::eval_stride]
        gt = _StridedFrames(gt, eval_stride) if gt is not None else None
    ev = evaluate_video(
        dec_state, gcfg, settings, window_cap, eval_zs, dataset.x_min,
        dataset.y_min, dataset.scale, gt_images=gt,
        mode=GenerateMode.DECODED, decoded=True, lpips_weights=lpips_w)
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
    if lpips_arg == "proxy":
        # the deterministic random-feature proxy, not pretrained-VGG LPIPS
        results["lpips_kind"] = "proxy-vgg16w4"
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
    parser.add_argument("--eval_stride", type=int, default=1,
                        help="score every Nth frame in the decoded eval "
                             "(bpp still covers all frames)")
    parser.add_argument("--profile", type=str, default=None,
                        help="write a torch.profiler trace of the first "
                             "<= 50 iterations into this directory")
    parser.add_argument("--lpips_weights", type=str, default=None,
                        help="npz of VGG16+lin LPIPS weights, or 'proxy'")
    parser.add_argument("--gop_size", type=int, default=0,
                        help="fit one model per segment of this many frames")
    parser.add_argument("--gop_parallel", action="store_true")
    parser.add_argument("--mesh", type=str, default=None)
    args = parser.parse_args(argv)
    cfg = resolve_config(args)

    if args.gop_parallel or args.mesh or cfg.pipeline.mesh_shape:
        raise NotImplementedError(
            "--gop_parallel / --mesh / pipeline.mesh_shape (multi-GPU "
            "fitting, parallel/spmd.py) is not ported yet: ROADMAP A5")
    if args.gop_size:
        return _train_segmented(args, cfg)

    from gsvc_tpu_torch.framecube.frame import FrameCubeDataset
    from gsvc_tpu_torch.train.fit import GOPFitter
    from gsvc_tpu_torch.utils.checkpoint import (
        load_checkpoint, save_checkpoint,
    )
    from gsvc_tpu_torch.utils.logging import (
        MetricsWriter, dump_config, setup_logging,
    )

    out = pathlib.Path(cfg.pipeline.model_path)
    log = setup_logging(str(out))
    dump_config(cfg, str(out))
    metrics = MetricsWriter(str(out))
    try:
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
        if args.profile:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if fitter.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            with profile(activities=acts) as prof:
                fitter.fit(iterations=min(50, cfg.optimization.iterations),
                           log_every=0)
            trace = pathlib.Path(args.profile)
            trace.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(trace / "trace.json"))
            log.info("profiler trace written to %s", args.profile)
        report = fitter.fit(eval_every=args.eval_every, rate_log_every=500,
                            checkpoint_iterations=tuple(
                                args.checkpoint_iterations),
                            checkpoint_dir=str(out), metrics_writer=metrics)
    finally:
        metrics.close()
    fitter.save_snapshot(str(out / "point_cloud" / "final"))
    ckpt = out / "chkpnt_final.pkl"
    save_checkpoint(str(ckpt), fitter, report.iterations)
    log.info("checkpoint saved: %s", ckpt)
    results = {"fit_psnr": report.psnr, "iterations": report.iterations,
               "n_anchors": report.n_active, "device": str(fitter.device)}
    if not args.skip_codec:
        from gsvc_tpu_torch.codec.estimate import estimate_final_bits

        est = estimate_final_bits(fitter.state, fitter.gcfg)
        log.info("estimated bits: total=%.3f MB", est.total / 8 / 2 ** 20)
        results.update(_codec_eval(
            fitter.state, fitter.gcfg, fitter.settings, fitter.window_cap,
            fitter.capacity, fitter.frame_zs, dataset, cfg, str(out),
            args.lpips_weights, log.info, eval_stride=args.eval_stride))
    (out / "results.json").write_text(json.dumps(results, indent=2))
    log.info("results: %s", json.dumps(results))
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
