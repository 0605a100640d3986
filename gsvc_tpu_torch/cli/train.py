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
summary in ``results.json``.  ``--device cpu`` runs the plain PyTorch
path (tests); the default is ``cuda`` and fails without a card.

Multi-rank fitting (``parallel/spmd.py``), one process a rank:

* ``--mesh dp=D,sp=S`` (or ``pipeline.mesh_shape``): one GOP on D x S
  ranks, the anchors in S z-slabs, D frame pairs a step.  Rank 0 writes
  every file (the single-GPU run's files) and runs the codec.
* ``--gop_size N --gop_parallel``: one GOP a dp rank (dp = the number of
  segments unless ``--mesh`` says otherwise; it must equal it, and sp
  must be 1).  Each rank writes its own ``gop_*/`` (what the sequential
  run writes there) and runs its own codec; rank 0 writes the summary,
  with ``"mesh"``.

The launcher, one rule: inside an initialised process group, or with
``torchrun``'s environment (``RANK``, ``WORLD_SIZE``), ``main`` uses it;
otherwise it spawns the D x S local ranks itself (``torch.multiprocessing``,
start method ``spawn``), each running ``main`` with the same arguments
inside a group on ``tcp://localhost:<free port>``, and returns rank 0's
results.  The backend, by rule: ``--device cpu`` -> gloo; CUDA with at
least one card a rank -> NCCL, rank r on ``cuda:r``; with fewer cards ->
gloo, rank r on ``cuda:(r % count)`` (ranks sharing a card, which shows
that the path is right, not how fast it runs on several cards).  The
choice is logged; nothing falls back to another backend or to the CPU.
Every group has a timeout (``spmd.GROUP_TIMEOUT``).
"""

from __future__ import annotations

import json
import logging
import pathlib
import sys

from gsvc_tpu_torch.cli.common import (
    base_parser, model_config_dict, resolve_config,
)


def _segments(cfg, gop_size: int):
    """[(first frame index, frame paths)] of the source directory, and
    the flow paths."""
    src = pathlib.Path(cfg.pipeline.source_path)
    frames = sorted(p for p in src.iterdir() if p.is_file())
    flow_dir = pathlib.Path(cfg.pipeline.optical_path) \
        if cfg.pipeline.optical_path else None
    flows = sorted(p for p in flow_dir.iterdir()) if flow_dir else []
    return ([(i, frames[i:i + gop_size])
             for i in range(0, len(frames), gop_size)], flows)


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

    segments, flows = _segments(cfg, args.gop_size)
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


def _mesh_axes(args, cfg, n_segments: int = 0) -> dict:
    """{"dp", "sp"} of ``--mesh`` / ``pipeline.mesh_shape``; the GOP
    fan-out defaults to one dp rank a segment."""
    from gsvc_tpu_torch.parallel.spmd import parse_mesh_spec

    spec = args.mesh or cfg.pipeline.mesh_shape
    if spec:
        return parse_mesh_spec(spec)
    return {"dp": n_segments, "sp": 1}


def _rank_main(rank: int, argv: list, world: int, port: int,
               backend: str, device_type: str):
    """One spawned rank: ``main(argv)`` inside a process group.  Ranks on
    the CPU share the process's intra-op threads (PyTorch's default, or
    ``OMP_NUM_THREADS``): each takes that count / ranks, at least 1."""
    import torch
    import torch.distributed as dist

    from gsvc_tpu_torch.parallel.spmd import GROUP_TIMEOUT

    if device_type == "cpu":
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=GROUP_TIMEOUT)
    try:
        main(argv)
    finally:
        dist.destroy_process_group()


def _launch(argv: list, args, world: int):
    """Run ``main(argv)`` on ``world`` ranks: under ``torchrun``'s
    environment in this process, else on spawned local ranks; returns
    rank 0's ``results.json``."""
    import os
    import socket

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from gsvc_tpu_torch.parallel.spmd import GROUP_TIMEOUT, choose_backend

    from gsvc_tpu_torch.utils.logging import setup_logging

    backend = choose_backend(torch.device(args.device).type, world)
    log = setup_logging()
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if int(os.environ["WORLD_SIZE"]) != world:
            raise ValueError(f"the mesh needs {world} ranks, torchrun "
                             f"started {os.environ['WORLD_SIZE']}")
        dist.init_process_group(backend, timeout=GROUP_TIMEOUT)
        try:
            return main(argv)
        finally:
            dist.destroy_process_group()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    log.info("spawning %d ranks, backend %s, device %s (%d card(s))",
             world, backend, args.device, torch.cuda.device_count())
    mp.start_processes(_rank_main, args=(argv, world, port, backend,
                                         torch.device(args.device).type),
                       nprocs=world, join=True, start_method="spawn")
    out = pathlib.Path(args.model_path) / "results.json"
    return json.loads(out.read_text())


def _rank_setup(args):
    """(rank, device) of this rank of the initialised group, the device
    made current."""
    import torch
    import torch.distributed as dist

    from gsvc_tpu_torch.parallel.spmd import rank_device

    rank = dist.get_rank()
    device = rank_device(args.device, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return rank, device


def _rank_logger(rank: int, paths: list) -> logging.Logger:
    """The ``gsvc_tpu_torch`` logger on stderr and ``output.log`` in each
    of ``paths`` (the first through ``setup_logging``)."""
    from gsvc_tpu_torch.utils.logging import setup_logging

    if not paths:
        log = logging.getLogger(f"gsvc_tpu_torch.rank{rank}")
        log.addHandler(logging.NullHandler())
        log.propagate = False
        return log
    log = setup_logging(str(paths[0]))
    for extra in paths[1:]:
        fh = logging.FileHandler(pathlib.Path(extra) / "output.log")
        fh.setFormatter(log.handlers[0].formatter)
        log.addHandler(fh)
    return log


def _train_gop_parallel(args, cfg):
    """The GOP fan-out (``parallel/spmd.py:GopRankFitter``): this dp rank
    fits its segment while the others fit theirs, with the shared draws
    of the JAX package's ``fit_gops``; then it writes what the sequential
    run writes into its ``gop_*/`` (config, log, metrics, snapshot,
    checkpoint, results) and runs its own encode, decode and evaluation.
    Rank 0 writes the summary ``results.json``."""
    import dataclasses
    import os
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from gsvc_tpu_torch.framecube.frame import FrameCubeDataset
    from gsvc_tpu_torch.parallel.spmd import GopRankFitter, make_mesh
    from gsvc_tpu_torch.utils.checkpoint import save_checkpoint
    from gsvc_tpu_torch.utils.logging import MetricsWriter, dump_config

    segments, flows = _segments(cfg, args.gop_size)
    axes = _mesh_axes(args, cfg, len(segments))
    rank, device = _rank_setup(args)
    root = pathlib.Path(cfg.pipeline.model_path)
    mesh = make_mesh(axes["dp"], axes["sp"], device)
    if len(segments) != axes["dp"]:
        raise ValueError(f"need dp == n_gops ({len(segments)}), mesh has "
                         f"dp={axes['dp']}")
    start, _ = segments[mesh.dp_index]
    out_dir = root / f"gop_{start:05d}"
    log = _rank_logger(rank, [out_dir] + ([root] if rank == 0 else []))
    if rank == 0:
        dump_config(cfg, str(root))
    log.info("GOP fan-out: %d segments over mesh %s (backend %s, rank %d "
             "on %s)", len(segments), mesh.shape, mesh.backend, rank,
             device)
    seg_cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, model_path=str(out_dir)))
    dump_config(seg_cfg, str(out_dir))
    metrics = MetricsWriter(str(out_dir))
    with tempfile.TemporaryDirectory() as td:
        datasets = []
        for i, (first, seg) in enumerate(segments):
            fdir = pathlib.Path(td) / f"frames_{first:05d}"
            fdir.mkdir()
            for p in seg:
                os.symlink(p.resolve(), fdir / p.name)
            odir = None
            if flows:
                odir = pathlib.Path(td) / f"flow_{first:05d}"
                odir.mkdir()
                for p in flows[first:first + len(seg) - 1]:
                    os.symlink(p.resolve(), odir / p.name)
            # the other segments give only their geometry and frame count
            datasets.append(FrameCubeDataset(
                str(fdir), str(odir) if odir else None,
                prefetch=(not cfg.pipeline.skip_prefetch
                          and i == mesh.dp_index), cache=False))
        try:
            fitter = GopRankFitter(mesh, cfg, datasets, seed=args.seed,
                                   log_fn=log.info, device=device)
            report = fitter.fit(
                eval_every=args.eval_every, rate_log_every=500,
                checkpoint_iterations=tuple(args.checkpoint_iterations),
                checkpoint_dir=str(out_dir), metrics_writer=metrics)
        finally:
            metrics.close()
        fitter.save_snapshot(str(out_dir / "point_cloud" / "final"))
        save_checkpoint(str(out_dir / "chkpnt_final.pkl"), fitter,
                        report.iterations)
        res = _finish(args, cfg, fitter, fitter.state, report,
                      datasets[mesh.dp_index], out_dir, log)
    aggregate = [None] * dist.get_world_size()
    dist.all_gather_object(aggregate, res)
    summary = {
        "gops": len(segments),
        "mesh": dict(mesh.shape),
        "mean_psnr": float(np.mean([r.get("decoded_psnr") or
                                    r.get("fit_psnr") or 0
                                    for r in aggregate])),
        "mean_bpp": float(np.mean([r.get("bpp") or 0 for r in aggregate])),
        "per_gop": aggregate,
    }
    if rank == 0:
        (root / "results.json").write_text(json.dumps(summary, indent=2))
        log.info("collectives of rank 0: %s", mesh.stats.as_dict())
        log.info("results: %s", json.dumps(summary))
    return summary


def _train_mesh(args, cfg):
    """One GOP on the mesh of ``--mesh`` / ``pipeline.mesh_shape``
    (``GOPFitter(mesh=...)``): every rank fits its z-slab of its dp
    group's pairs; rank 0 writes the files, logs the rate estimate and
    runs the codec on the gathered state.  Returns the results on rank 0,
    None on the others."""
    import torch.distributed as dist

    from gsvc_tpu_torch.framecube.frame import FrameCubeDataset
    from gsvc_tpu_torch.parallel.spmd import make_mesh
    from gsvc_tpu_torch.train.fit import GOPFitter
    from gsvc_tpu_torch.utils.checkpoint import (
        load_checkpoint, save_checkpoint,
    )
    from gsvc_tpu_torch.utils.logging import MetricsWriter, dump_config

    axes = _mesh_axes(args, cfg)
    rank, device = _rank_setup(args)
    out = pathlib.Path(cfg.pipeline.model_path)
    log = _rank_logger(rank, [out] if rank == 0 else [])
    mesh = make_mesh(axes["dp"], axes["sp"], device)
    log.info("SPMD mesh: dp=%d x sp=%d over %d ranks, backend %s, rank 0 "
             "on %s", axes["dp"], axes["sp"], axes["dp"] * axes["sp"],
             mesh.backend, device)
    metrics = None
    if rank == 0:
        dump_config(cfg, str(out))
        metrics = MetricsWriter(str(out))
    try:
        # rank 0 decodes the frames (and writes the frame cache) first
        for turn in (0, 1):
            if (rank == 0) == (turn == 0):
                dataset = FrameCubeDataset(
                    cfg.pipeline.source_path,
                    cfg.pipeline.optical_path or None,
                    prefetch=not cfg.pipeline.skip_prefetch)
            dist.barrier()
        log.info("dataset: %dx%d, %d frames", dataset.width, dataset.height,
                 dataset.num_frames)
        fitter = GOPFitter(cfg, dataset, seed=args.seed, log_fn=log.info,
                           device=device, mesh=mesh)
        if args.checkpoint:
            start = load_checkpoint(args.checkpoint, fitter)
            log.info("resumed from %s at iteration %d", args.checkpoint,
                     start)
        if args.profile:
            _profiled_fit(fitter, cfg, args.profile, log, write=rank == 0)
        report = fitter.fit(eval_every=args.eval_every, rate_log_every=500,
                            checkpoint_iterations=tuple(
                                args.checkpoint_iterations),
                            checkpoint_dir=str(out), metrics_writer=metrics)
    finally:
        if metrics is not None:
            metrics.close()
    fitter.save_snapshot(str(out / "point_cloud" / "final"))
    ckpt = out / "chkpnt_final.pkl"
    save_checkpoint(str(ckpt), fitter, report.iterations)
    state = fitter.gathered_state()
    log.info("collectives of rank 0: %s", mesh.stats.as_dict())
    if rank != 0:
        return None
    log.info("checkpoint saved: %s", ckpt)
    return _finish(args, cfg, fitter, state, report, dataset, out, log)


def _profiled_fit(fitter, cfg, trace_dir: str, log, write: bool = True):
    """Up to 50 iterations under ``torch.profiler``; ``write``: export
    ``trace_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if fitter.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        fitter.fit(iterations=min(50, cfg.optimization.iterations),
                   log_every=0)
    if write:
        trace = pathlib.Path(trace_dir)
        trace.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace / "trace.json"))
        log.info("profiler trace written to %s", trace_dir)


def _finish(args, cfg, fitter, state, report, dataset, out, log):
    """Results of a fitted GOP: the fit's numbers and, unless
    ``--skip_codec``, the rate estimate and ``_codec_eval`` of
    ``state``; written to ``results.json`` and printed."""
    results = {"fit_psnr": report.psnr, "iterations": report.iterations,
               "n_anchors": report.n_active, "device": str(fitter.device)}
    if not args.skip_codec:
        from gsvc_tpu_torch.codec.estimate import estimate_final_bits

        est = estimate_final_bits(state, fitter.gcfg)
        log.info("estimated bits: total=%.3f MB", est.total / 8 / 2 ** 20)
        results.update(_codec_eval(
            state, fitter.gcfg, fitter.settings, fitter.window_cap,
            fitter.capacity, fitter.frame_zs, dataset, cfg, str(out),
            args.lpips_weights, log.info, eval_stride=args.eval_stride))
    (out / "results.json").write_text(json.dumps(results, indent=2))
    log.info("results: %s", json.dumps(results))
    print(json.dumps(results))
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
    parser.add_argument("--gop_parallel", action="store_true",
                        help="with --gop_size: fit every GOP at once, one "
                             "dp rank a GOP (parallel/spmd.py:GopRankFitter)")
    parser.add_argument("--mesh", type=str, default=None,
                        help="mesh spec, e.g. 'dp=2,sp=2' (overrides "
                             "pipeline.mesh_shape): anchors in sp z-slabs, "
                             "dp frame pairs a step, one process a rank")
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parser.parse_args(argv)
    cfg = resolve_config(args)

    if args.gop_size:
        if not args.gop_parallel:
            return _train_segmented(args, cfg)
    if args.gop_size or args.mesh or cfg.pipeline.mesh_shape:
        import torch.distributed as dist

        if not dist.is_initialized():
            n_segments = (len(_segments(cfg, args.gop_size)[0])
                          if args.gop_size else 0)
            axes = _mesh_axes(args, cfg, n_segments)
            return _launch(argv, args, axes["dp"] * axes["sp"])
        if args.gop_size:
            return _train_gop_parallel(args, cfg)
        return _train_mesh(args, cfg)

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
            _profiled_fit(fitter, cfg, args.profile, log)
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
    return _finish(args, cfg, fitter, fitter.state, report, dataset, out,
                   log)


if __name__ == "__main__":
    main()
