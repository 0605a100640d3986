"""Shared CLI plumbing (port of gsvc_tpu/cli/common.py: ``base_parser``,
``resolve_config``, ``model_config_dict``).  The parser adds ``--device``:
``cuda`` by default (raises without a card), ``cpu`` runs the plain
PyTorch versions of the kernels."""

from __future__ import annotations

import argparse
import dataclasses

from gsvc_tpu_torch.config import Config, load_config


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
                        "overlay, e.g. --set pipeline.rasterizer="
                        "pallas_stream --set pipeline.copy_budget_factor=8 "
                        "(repeatable; values parsed as YAML scalars)")
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


def model_config_dict(cfg: Config) -> dict:
    return dataclasses.asdict(cfg.model)
