"""Stream codec round trip: z-sliced encode from a checkpoint, streaming
decode, evaluation (port of gsvc_tpu/cli/stream.py).

    python -m gsvc_tpu_torch.cli.stream --source_path frames/ \
        --model_path out/ --checkpoint out/chkpnt_final.pkl

Loads a training checkpoint (either package's) into a fitter, encodes the
state as the z-sliced, prefix-decodable bitstream into
``stream_bitstreams/`` (the JAX package's files, byte for byte), decodes
it and evaluates the decoded model on the frames; ``stream_results.json``
holds the JAX CLI's keys.  With ``GSVC_RASTERIZER=pallas_stream`` in the
environment the evaluation renders through the stream composite (kernel
B6f), else through the bidirectional one (B4).  ``--device cpu`` runs the
plain PyTorch path (tests); the default is ``cuda`` and fails without a
card.
"""

from __future__ import annotations

import json
import pathlib

from gsvc_tpu_torch.cli.common import (
    base_parser, model_config_dict, resolve_config,
)


def main(argv=None):
    parser = base_parser(__doc__)
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--dump_frames", action="store_true")
    args = parser.parse_args(argv)
    cfg = resolve_config(args)

    from gsvc_tpu_torch.codec.bitstream import (
        conduct_decoding, conduct_encoding,
    )
    from gsvc_tpu_torch.framecube.frame import FrameCubeDataset
    from gsvc_tpu_torch.models.gaussians import GenerateMode
    from gsvc_tpu_torch.report import bits_per_pixel, evaluate_video
    from gsvc_tpu_torch.train.fit import GOPFitter
    from gsvc_tpu_torch.utils.checkpoint import load_checkpoint, save_streams
    from gsvc_tpu_torch.utils.logging import setup_logging

    out_dir = pathlib.Path(cfg.pipeline.model_path)
    log = setup_logging(str(out_dir), filename="stream.log")
    dataset = FrameCubeDataset(cfg.pipeline.source_path,
                               cfg.pipeline.optical_path or None)
    fitter = GOPFitter(cfg, dataset, seed=args.seed, log_fn=log.info,
                       device=args.device)
    load_checkpoint(args.checkpoint, fitter)
    log.info("checkpoint loaded")

    streams, meta, _, enc_state, enc_time = conduct_encoding(
        fitter.state, fitter.gcfg, streaming=True,
        model_config=model_config_dict(cfg),
        video_info={"width": dataset.width, "height": dataset.height,
                    "num_frames": dataset.num_frames})
    total_bytes = save_streams(str(out_dir / "stream_bitstreams"), streams)
    bpp = bits_per_pixel(total_bytes * 8, dataset.width, dataset.height,
                         dataset.num_frames)
    n_slices = len(meta.index_splits or [])
    log.info("stream-encoded %.3f MB (%.5f bpp) in %.1fs, %d z-slices",
             total_bytes / 2 ** 20, bpp, enc_time, n_slices)

    dec_state, _, dec_time = conduct_decoding(
        streams, fitter.gcfg, enc_state, capacity=fitter.capacity,
        device=fitter.device)
    log.info("stream-decoded in %.1fs", dec_time)

    dump = str(out_dir / "stream_frames") if args.dump_frames else None
    ev = evaluate_video(
        dec_state, fitter.gcfg, fitter.settings, fitter.window_cap,
        fitter.frame_zs, dataset.x_min, dataset.y_min, dataset.scale,
        gt_images=dataset.images, mode=GenerateMode.DECODED, decoded=True,
        dump_dir=dump)
    results = {"bpp": bpp, "size_mb": total_bytes / 2 ** 20,
               "encode_seconds": enc_time, "decode_seconds": dec_time,
               "psnr": ev.get("psnr"), "ssim": ev.get("ssim"),
               "fps": ev["fps"], "z_slices": n_slices}
    log.info("stream results: %s", json.dumps(results))
    (out_dir / "stream_results.json").write_text(json.dumps(results,
                                                            indent=2))
    return results


if __name__ == "__main__":
    main()
