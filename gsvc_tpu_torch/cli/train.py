"""Fit one GOP (port of gsvc_tpu/cli/train.py on the single-GOP path).

    python -m gsvc_tpu_torch.cli.train --source_path frames/ \
        --model_path out/ --config_path cfgs/uvg.yaml --skip_codec

Fits, writes ``chkpnt_final.pkl`` (the JAX package's checkpoint format)
and ``results.json``.  The encode/decode round trip after the fit is the
next slice of the port, so ``--skip_codec`` is required for now; so are
a single GOP and a single device (``--gop_size`` and ``--mesh`` raise).
``--device cpu`` runs the plain PyTorch path (tests); the default is
``cuda`` and fails without a card.
"""

from __future__ import annotations

import argparse
import json
import logging
import pathlib

from gsvc_tpu_torch.config import Config, load_config

log = logging.getLogger("gsvc_tpu_torch.train")


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--source_path", type=str, default="",
                   help="directory of video frames (one GOP)")
    p.add_argument("--optical_path", type=str, default="",
                   help="directory of optical-flow pickles [2,H,W]")
    p.add_argument("--model_path", type=str, required=True,
                   help="output directory")
    p.add_argument("--config_path", type=str, default=None,
                   help="YAML config overlay (cfgs/*.yaml)")
    p.add_argument("--lmbda", type=float, default=None,
                   help="rate-distortion trade-off override")
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="SECTION.KEY=VALUE",
                   help="dotted config override applied after the YAML "
                        "overlay (repeatable; values parsed as YAML "
                        "scalars)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch versions of the kernels)")
    return p


def resolve_config(args) -> Config:
    overrides = None
    if getattr(args, "overrides", None):
        import yaml

        overrides = {}
        for spec in args.overrides:
            key, sep, val = spec.partition("=")
            if "." not in key or not sep:
                raise SystemExit(
                    f"--set expects SECTION.KEY=VALUE, got {spec!r}")
            overrides[key.strip()] = yaml.safe_load(val)
    cfg = load_config(args.config_path, overrides=overrides)
    cfg.pipeline.source_path = args.source_path
    cfg.pipeline.optical_path = args.optical_path
    cfg.pipeline.model_path = args.model_path
    if args.lmbda is not None:
        cfg.optimization.lmbda = args.lmbda
    if args.iterations is not None:
        cfg.optimization.iterations = args.iterations
    return cfg


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
    if not args.skip_codec:
        raise NotImplementedError(
            "the encode/decode round trip after the fit is the next slice "
            "of the port; pass --skip_codec to fit and checkpoint only")

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
        report = fitter.fit(eval_every=args.eval_every,
                            checkpoint_iterations=tuple(
                                args.checkpoint_iterations),
                            checkpoint_dir=str(out))
        ckpt = out / "chkpnt_final.pkl"
        save_checkpoint(str(ckpt), fitter, report.iterations)
        log.info("checkpoint saved: %s", ckpt)
        results = {"fit_psnr": report.psnr, "iterations": report.iterations,
                   "n_anchors": report.n_active,
                   "device": str(fitter.device)}
        (out / "results.json").write_text(json.dumps(results, indent=2))
        log.info("results: %s", json.dumps(results))
    finally:
        log.removeHandler(handler)
        handler.close()
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
