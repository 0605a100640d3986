"""Rate-distortion sweep: fit the same GOP at several lambdas (port of
gsvc_tpu/cli/sweep.py).

    python -m gsvc_tpu_torch.cli.sweep --source_path frames/ \
        --model_path sweep_out/ --lmbdas 0.001 0.002 0.004 0.008

One ``cli.train.main`` per lambda into ``<model_path>/lmbda_<lambda:g>/``,
each given the JAX package's flags (``--source_path --model_path --lmbda
--seed`` and, where given, ``--optical_path --config_path --iterations``)
plus ``--device``; ``rd_curve.json`` is rewritten after each point with
one (lmbda, bpp, psnr, ms_ssim, size_mb) entry a lambda.
"""

from __future__ import annotations

import json
import pathlib

from gsvc_tpu_torch.cli.common import base_parser


def main(argv=None):
    parser = base_parser(__doc__)
    parser.add_argument("--lmbdas", type=float, nargs="+",
                        default=[0.001, 0.002, 0.004, 0.008])
    args = parser.parse_args(argv)

    from gsvc_tpu_torch.cli.train import main as train_main

    root = pathlib.Path(args.model_path)
    curve = []
    for lam in args.lmbdas:
        out = root / f"lmbda_{lam:g}"
        argv_pt = ["--source_path", args.source_path,
                   "--model_path", str(out),
                   "--lmbda", str(lam), "--seed", str(args.seed)]
        if args.optical_path:
            argv_pt += ["--optical_path", args.optical_path]
        if args.config_path:
            argv_pt += ["--config_path", args.config_path]
        if args.iterations:
            argv_pt += ["--iterations", str(args.iterations)]
        argv_pt += ["--device", args.device]
        results = train_main(argv_pt)
        curve.append({"lmbda": lam, "bpp": results.get("bpp"),
                      "psnr": results.get("decoded_psnr"),
                      "ms_ssim": results.get("decoded_ms_ssim"),
                      "size_mb": results.get("size_mb")})
        (root / "rd_curve.json").write_text(json.dumps(curve, indent=2))
    print(json.dumps(curve, indent=2))
    return curve


if __name__ == "__main__":
    main()
