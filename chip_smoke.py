"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the port's native code from the checkout (``nvcc`` for the
   kernels, the host C++ compiler for the entropy codec), all compilers
   started together, and prints the build's wall seconds.
3. Kernel phase: kernel B4 (``bidir_composite_attrs``) against its plain
   PyTorch version at the 1080p decode shapes (T=1020 tiles, cap 1024,
   chunk 128, P=2048 pixels), and kernels B1/B2 (``mirror_forward`` /
   ``mirror_backward``, the training composite) against theirs at the
   1080p training shapes (F=2 frames, T=2025 tiles of 8x128, cap 1024,
   chunk 128), with and without per-view means2d gradients; seeded
   attribute rows: empty tiles, full lists of saturated stacks,
   chunk-aligned and partial last chunks.
4. Decode phase: decodes the committed 1080p bitstream
   (artifacts/rd_r5/realtex_0.004) with ``gsvc_tpu_torch.cli.decode`` and
   renders 8 frames through ``report.evaluate_video`` — the decoder's own
   render loop — with the launch counts reset just before and read just
   after; then holds each frame's kernel composite against the plain
   version and times both.
5. Training phase: the 600 frames the port decodes from that bitstream
   become the ground truth (uint8 on the card); ``GOPFitter.fit`` runs 24
   steps of the fixture's model and pipeline
   (artifacts/rd_r5/realtex_0.004/cfg_args.yaml: 1920x1080, 100k initial
   anchors, 50-dim features, 10 offsets, 8x128 tiles) with only the
   schedule overlaid — 12 FULL_PRECISION and 12 QUANTIZED_NOISE steps,
   statistics from step 3 on, no densify epoch; the fit's eval hook
   scores all 600 frames after steps 12 and 24.  The launch counts are
   reset just before and read just after: B1 and B2 must launch once per
   step.  Every loss must be finite; the mean PSNR of the 600 frames
   (FULL_PRECISION renders) after the 12 FULL_PRECISION steps must be
   above the PSNR before step 1; and the checkpoint written at step 24
   must load into a fresh fitter.  (The training loss itself does not
   fall in 12 steps: at step 1 the optical-flow term is ~0 — the
   time-conditioned offsets barely differ between neighbouring frames at
   the initial weights — and it grows as soon as the deform MLP takes its
   first Adam steps, in the JAX package as in the port.)  Prints each
   step's loss terms and time split (CUDA events) and times B1/B2 and
   their plain versions on one training pair's inputs against their
   bounds.
6. Prints the kernel table as one JSON line, then the result line.

Any failed check raises, so the run exits non-zero and prints no result.
Frames are written nowhere; the checkpoint goes to a temporary directory.
Without a CUDA device the script exits 1.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

FIXTURE_DIR = pathlib.Path(__file__).resolve().parent / "artifacts" \
    / "rd_r5" / "realtex_0.004"
FIXTURE = str(FIXTURE_DIR / "bitstreams")
N_FRAMES = 8
# the training run: the fixture's config with only the schedule overlaid
TRAIN_STEPS = 24
SCHEDULE = {"optimization.iterations": TRAIN_STEPS,
            "optimization.full_precision_training_total": 12,
            "optimization.quantized_training_total": 12,
            "optimization.start_stat": 2,
            "optimization.pause_densification": 4}
# kernel B2 vs its plain version, per attribute: the largest difference at
# most 2e-3 of the largest gradient magnitude.  Both run the same chunk
# stops; the kernel forms each in-chunk suffix as the chunk's sum minus a
# running prefix, the plain version by a reverse cumsum, and 1/(1 - alpha)
# amplifies that rounding up to 100x; pixel sums also run in other orders.
BWD_REL_ERR = 2e-3
# kernel vs plain version: both run the same per-tile, chunk-granular loop
# stops; they differ by float rounding (sequential products in the kernel,
# cumprod/bmm in the plain version, FMA contraction) except where a pixel's
# transmittance rounds across T_EPS on one side only — then one term of
# weight < T_EPS per view differs.  Limit: 2 T_EPS.
MAX_ABS_ERR = 2e-4
# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, FP32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# least FP32 work of one evaluated (copy, pixel) pair: the alpha (two
# deltas, quadratic form, exponent scale, opacity, clamps: 15) plus one
# compositing step (weight, gate, 3 colour FMAs, transmittance: 10);
# FMA counts 2.  The front loop's Horner step costs 9 more per pair.
FLOPS_PER_PAIR = 25
# least FP32 work of one replayed (copy, pixel) pair in the backward: the
# alpha (15), its transmittance and weight (3), the colour-gradient dot
# (5), the suffix (2), dL/dalpha with its division (5), dq (2), the six
# moment sums (11) and the colour sums (6); the kernel's second alpha
# evaluation is not counted.
FLOPS_PER_BWD_PAIR = 49


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` runs (CUDA
    events, after one warm-up run)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound_ms(n_bytes: int, flops: float):
    """(least ms, what bounds it): ``n_bytes`` (each input read once, each
    output written once) over HBM bandwidth, or ``flops`` FP32 operations
    over peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops > t_bytes
                                       else "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def synthetic_tiles(settings, seed: int, device):
    """Seeded attribute rows and tile lists at the settings' shapes:
    10% empty tiles, 10% full lists, 10% chunk-aligned counts, the rest
    random counts (partial last chunks); tiles of the first three kinds
    hold wide, nearly opaque (saturating) gaussians."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    t_n, cap, chunk = settings.n_tiles, settings.gaussian_cap, settings.chunk
    tw, th, ntx = settings.tile_w, settings.tile_h, settings.n_tiles_x

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=device)

    kind = torch.randint(0, 10, (t_n,), generator=gen, device=device)
    counts = torch.randint(1, cap, (t_n,), generator=gen, device=device)
    counts = torch.where(kind == 0, 0, counts)
    counts = torch.where(kind == 1, cap, counts)
    counts = torch.where(kind == 2, 3 * chunk, counts)
    owner = torch.repeat_interleave(torch.arange(t_n, device=device), counts)
    total = owner.numel()
    sat = (kind[owner] >= 1) & (kind[owner] <= 3)
    mux = (owner % ntx) * tw + rand(total) * 1.5 * tw - 0.25 * tw
    muy = (owner // ntx) * th + rand(total) * 1.5 * th - 0.25 * th
    sig_x = torch.where(sat, 20 + 40 * rand(total), 1 + 20 * rand(total))
    sig_y = torch.where(sat, 20 + 40 * rand(total), 1 + 20 * rand(total))
    rho = rand(total) - 0.5
    a, c = 1 / sig_x ** 2, 1 / sig_y ** 2
    b = rho * torch.sqrt(a * c)
    opacity = torch.where(sat, 0.6 + 0.39 * rand(total),
                          0.05 + 0.5 * rand(total))
    attrs = torch.stack([mux, muy, a, b, c, opacity, rand(total),
                         rand(total), rand(total)], dim=1).float()

    start = torch.cumsum(counts, 0) - counts
    slot = torch.arange(total, device=device) - start[owner]
    lists = torch.full((t_n, cap), -1, dtype=torch.int32, device=device)
    lists[owner, slot] = torch.arange(total, dtype=torch.int32,
                                      device=device)
    return (attrs[None].contiguous(), lists[None].contiguous(),
            counts.to(torch.int32)[None].contiguous())


def synthetic_frames(settings, seed: int, n_frames: int, device):
    """``synthetic_tiles`` for F frames, stacked (rows zero padded to the
    largest frame's)."""
    parts = [synthetic_tiles(settings, seed + f, device)
             for f in range(n_frames)]
    m = max(p[0].shape[1] for p in parts)
    attrs = torch.zeros((n_frames, m, 9), device=device)
    for f, p in enumerate(parts):
        attrs[f, :p[0].shape[1]] = p[0][0]
    return (attrs.contiguous(), torch.cat([p[1] for p in parts]),
            torch.cat([p[2] for p in parts]))


def bwd_rel_err(got, want, dim: int):
    """Largest |got - want| over the largest |want|, per attribute (the
    9 entries along ``dim``)."""
    worst = 0.0
    for g, w in zip(got.unbind(dim), want.unbind(dim)):
        scale = max(float(w.abs().max()), 1e-30)
        worst = max(worst, float((g - w).abs().max()) / scale)
    return worst


def mirror_check(mirror, settings, attrs, lists, counts, label):
    """B1 and B2 against their plain versions on one input; the scatter
    with and without per-view means2d through the autograd function.
    Returns (B1 max abs err, B2 max abs err, forward pairs, backward
    pairs, (plain out4, plain t_chk, cotangent, plain per-copy grads))."""
    out_k, chk_k = mirror.mirror_fwd_cuda(settings, attrs, lists, counts)
    out_p, chk_p, pairs_f = mirror.mirror_fwd_plain(settings, attrs, lists,
                                                    counts)
    torch.cuda.synchronize()
    fwd_err = max(float((out_k - out_p).abs().max()),
                  float((chk_k - chk_p).abs().max()))
    if not np.isfinite(fwd_err) or fwd_err > MAX_ABS_ERR:
        raise AssertionError(f"{label}: B1 disagrees with its plain "
                             f"version: {fwd_err} > {MAX_ABS_ERR}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    g_out = torch.randn(out_p.shape, generator=gen, device="cuda")
    # both versions replay from the same checkpoints, so they stop on the
    # same chunks
    gr_k = mirror.mirror_bwd_cuda(settings, attrs, lists, counts, chk_p,
                                  g_out)
    gr_p, pairs_b = mirror.mirror_bwd_plain(settings, attrs, lists, counts,
                                            chk_p, g_out)
    torch.cuda.synchronize()
    if not torch.isfinite(gr_k).all():
        raise AssertionError(f"{label}: B2 gave non-finite gradients")
    bwd_err = bwd_rel_err(gr_k, gr_p, 1)
    bwd_abs = float((gr_k - gr_p).abs().max())
    for per_view in (False, True):
        da_k, dm_k = mirror.scatter_grads(settings, gr_k, lists,
                                          attrs.shape[1], per_view)
        da_p, dm_p = mirror.scatter_grads(settings, gr_p, lists,
                                          attrs.shape[1], per_view)
        bwd_err = max(bwd_err, bwd_rel_err(da_k, da_p, -1))
        bwd_abs = max(bwd_abs, float((da_k - da_p).abs().max()))
        if per_view:
            diff = float((dm_k - dm_p).abs().max())
            scale = max(float(dm_p.abs().max()), 1e-30)
            bwd_err = max(bwd_err, diff / scale)
            bwd_abs = max(bwd_abs, diff)
    if not np.isfinite(bwd_err) or bwd_err > BWD_REL_ERR:
        raise AssertionError(f"{label}: B2 disagrees with its plain "
                             f"version: {bwd_err} > {BWD_REL_ERR} of the "
                             f"largest gradient")
    log(f"{label}: {int(counts.sum())} copies over {counts.numel()} tiles; "
        f"B1 max |kernel - plain| {fwd_err:.3e} (limit {MAX_ABS_ERR:.0e}); "
        f"B2 max |kernel - plain| / max |plain| {bwd_err:.3e} (limit "
        f"{BWD_REL_ERR:.0e}; max |kernel - plain| {bwd_abs:.3e}; per-copy "
        f"rows and the scatter with and without means2d)")
    return fwd_err, bwd_abs, pairs_f, pairs_b, (out_p, chk_p, g_out, gr_p)


def mirror_times(mirror, settings, attrs, lists, counts, aux, pairs_f,
                 pairs_b, label):
    """Kernel and plain times of B1 and B2 on one input, with bounds."""
    out_p, chk_p, g_out, gr_p = aux
    f_ms = cuda_ms(lambda: mirror.mirror_fwd_cuda(settings, attrs, lists,
                                                  counts), 10)
    b_ms = cuda_ms(lambda: mirror.mirror_bwd_cuda(settings, attrs, lists,
                                                  counts, chk_p, g_out), 5)
    f_plain = cuda_ms(lambda: mirror.mirror_fwd_plain(settings, attrs,
                                                      lists, counts), 1)
    b_plain = cuda_ms(lambda: mirror.mirror_bwd_plain(
        settings, attrs, lists, counts, chk_p, g_out), 1)
    ins = nbytes(attrs, lists, counts)
    fb = bound_ms(ins + nbytes(out_p, chk_p), pairs_f * FLOPS_PER_PAIR)
    bb = bound_ms(ins + nbytes(chk_p, g_out, gr_p),
                  pairs_b * FLOPS_PER_BWD_PAIR)
    log(f"{label}: B1 kernel {f_ms:.4f} ms, plain {f_plain:.3f} ms, bound "
        f"{fb[0]:.4f} ms ({fb[1]}; {pairs_f} pairs); B2 kernel "
        f"{b_ms:.4f} ms, plain {b_plain:.3f} ms, bound {bb[0]:.4f} ms "
        f"({bb[1]}; {pairs_b} pairs)")
    return (dict(ms=f_ms, plain_ms=f_plain, bound_ms=fb[0], bound_by=fb[1]),
            dict(ms=b_ms, plain_ms=b_plain, bound_ms=bb[0], bound_by=bb[1]))


def mirror_kernel_phase(mirror, settings):
    """B1/B2 against their plain versions at the 1080p training shapes."""
    attrs, lists, counts = synthetic_frames(settings, seed=1, n_frames=2,
                                            device="cuda")
    f_err, b_err, pf, pb, aux = mirror_check(mirror, settings, attrs, lists,
                                             counts, "kernel phase (B1/B2)")
    mirror_times(mirror, settings, attrs, lists, counts, aux, pf, pb,
                 "kernel phase (B1/B2, synthetic)")
    return f_err, b_err


def kernel_phase(bidir, settings):
    """B4 against its plain version at the 1080p shapes."""
    attrs, lists, counts = synthetic_tiles(settings, seed=0, device="cuda")
    out_k = bidir.bidir_out4_cuda(settings, attrs, lists, counts)
    out_p, pairs = bidir.bidir_out4_plain(settings, attrs, lists, counts)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    n_empty = int((counts == 0).sum())
    n_partial = int((counts % settings.chunk != 0).sum())
    log(f"kernel phase: {counts.shape[1]} tiles ({n_empty} empty, "
        f"{n_partial} with a partial last chunk), {attrs.shape[1]} "
        f"gaussians, {int(counts.sum())} copies; max |kernel - plain| = "
        f"{err:.3e} (limit {MAX_ABS_ERR:.0e})")
    if not np.isfinite(err) or err > MAX_ABS_ERR:
        raise AssertionError(f"kernel disagrees with the plain version: "
                             f"{err} > {MAX_ABS_ERR}")
    ms = cuda_ms(lambda: bidir.bidir_out4_cuda(settings, attrs, lists,
                                               counts), 20)
    plain_ms = cuda_ms(lambda: bidir.bidir_out4_plain(settings, attrs,
                                                      lists, counts), 2)
    b_ms, b_by = bound_ms(nbytes(attrs, lists, counts, out_k),
                          pairs * FLOPS_PER_PAIR)
    log(f"kernel phase: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}; {pairs} evaluated pairs)")
    return err


def slice_phase(bidir):
    """Decode the committed bitstream and render 8 frames through B4.
    Returns (B4's numbers, the decoded bitstream)."""
    from gsvc_tpu_torch.cli.decode import decode_bitstream
    from gsvc_tpu_torch.render.batched import frame_splats
    from gsvc_tpu_torch.report import evaluate_video

    dec = decode_bitstream(FIXTURE, device="cuda")
    n = dec.meta.anchor_num
    log(f"slice phase: host decode {dec.seconds:.3f} s, {n} anchors, "
        f"window_cap {dec.window_cap}")
    if n != 30_224:
        raise AssertionError(f"decoded {n} anchors, expected 30224")

    t = len(dec.frame_zs)
    ids = np.linspace(0, t - 1, N_FRAMES).round().astype(int)
    zs = dec.frame_zs[ids]

    def splats(z):
        return frame_splats(dec.state, dec.cfg, float(z), dec.x_min,
                            dec.y_min, dec.scale, dec.settings,
                            dec.window_cap)

    # warm-up outside the counted run (first cuBLAS/allocator use)
    fs = splats(zs[0])
    bidir.bidir_composite_attrs(dec.settings, fs.attrs, fs.tile_lists,
                                fs.counts)
    torch.cuda.synchronize()

    bidir.bidir_composite_attrs.launches = 0
    ev = evaluate_video(dec.state, dec.cfg, dec.settings, dec.window_cap,
                        zs, dec.x_min, dec.y_min, dec.scale, frame_ids=ids)
    launches = bidir.bidir_composite_attrs.launches
    log(f"slice phase: rendered frames {ids.tolist()} at "
        f"{dec.settings.image_width}x{dec.settings.image_height}: "
        f"{1e3 / ev['fps']:.3f} ms per frame, decode fps {ev['fps']:.3f}; "
        f"bidir launches {launches}")
    if launches != N_FRAMES:
        raise AssertionError(f"{launches} kernel launches, expected "
                             f"{N_FRAMES}: the main path bypassed B4")

    max_err = 0.0
    for fid, z in zip(ids, zs):
        fs = splats(z)
        img_k, tau_k = bidir.bidir_composite_attrs(
            dec.settings, fs.attrs, fs.tile_lists, fs.counts)
        img_p, tau_p = bidir.bidir_composite_plain(
            dec.settings, fs.attrs, fs.tile_lists, fs.counts)
        torch.cuda.synchronize()
        shape = (1, 3, dec.settings.image_height, dec.settings.image_width)
        if tuple(img_k.shape) != shape or not torch.isfinite(img_k).all():
            raise AssertionError(f"frame {fid}: shape {tuple(img_k.shape)}"
                                 f" or non-finite values")
        err = max(float((img_k - img_p).abs().max()),
                  float((tau_k - tau_p).abs().max()))
        max_err = max(max_err, err)
        log(f"  frame {fid:3d}: {int(fs.num_rendered)} copies, mean "
            f"{float(img_k.mean()):.4f}, max |kernel - plain| {err:.3e}")
        if err > MAX_ABS_ERR:
            raise AssertionError(f"frame {fid}: kernel disagrees with the "
                                 f"plain version: {err} > {MAX_ABS_ERR}")

    # times on one main-path frame's inputs (the middle frame)
    fs = splats(zs[N_FRAMES // 2])
    a, l, c = fs.attrs, fs.tile_lists, fs.counts
    ms = cuda_ms(lambda: bidir.bidir_out4_cuda(dec.settings, a, l, c), 20)
    out_p, pairs = bidir.bidir_out4_plain(dec.settings, a, l, c)
    plain_ms = cuda_ms(lambda: bidir.bidir_out4_plain(dec.settings, a, l,
                                                      c), 2)
    b_ms, b_by = bound_ms(nbytes(a, l, c, out_p), pairs * FLOPS_PER_PAIR)
    splats_ms = cuda_ms(lambda: splats(zs[N_FRAMES // 2]), 5)
    log(f"slice phase: frame {ids[N_FRAMES // 2]} composite: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms "
        f"({b_by}; {pairs} evaluated pairs); window + generation + "
        f"projection + binning {splats_ms:.3f} ms")
    return dict(launches=launches, max_abs_err=max_err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by), dec


def decoded_ground_truth(dec):
    """All frames of the decoded bitstream as a uint8 [T, H, W, 3] host
    stack — the training phase's ground truth (the fixture's source
    frames are not in the repository)."""
    from gsvc_tpu_torch.render.batched import render_frame_bidir

    t = len(dec.frame_zs)
    h, w = dec.settings.image_height, dec.settings.image_width
    out = np.empty((t, h, w, 3), np.uint8)
    with torch.no_grad():
        for i, z in enumerate(dec.frame_zs):
            img, _, _ = render_frame_bidir(
                dec.state, dec.cfg, float(z), dec.x_min, dec.y_min,
                dec.scale, dec.settings, dec.window_cap)
            u8 = torch.round(img.clamp(0, 1) * 255).to(torch.uint8)
            out[i] = u8.permute(1, 2, 0).cpu().numpy()
    return out


class StepTimer:
    """CUDA events at the train step's marks (gsvc_tpu_torch.train.
    trainer.make_step_body): start, b1_start, b1_end, loss_end, b2_start,
    b2_end, backward_end, adam_end."""

    def __init__(self):
        self.steps = []

    def mark(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        if name == "start":
            self.steps.append({})
        self.steps[-1][name] = ev

    def split(self):
        """Per step: {phase: ms}."""
        torch.cuda.synchronize()
        rows = []
        for e in self.steps:
            def ms(a, b, e=e):
                return e[a].elapsed_time(e[b])
            b2 = ms("b2_start", "b2_end")
            rows.append({
                "step": ms("start", "adam_end"),
                "generation+projection+binning": ms("start", "b1_start"),
                "B1": ms("b1_start", "b1_end"),
                "loss": ms("b1_end", "loss_end"),
                "B2+scatter": b2,
                "rest of backward": ms("loss_end", "backward_end") - b2,
                "Adam+stats": ms("backward_end", "adam_end"),
            })
        return rows


def training_pair_inputs(fitter, i1: int):
    """The composite's inputs for the frame pair (i1, i1 + 1) of the
    fitted state, built as render_pair builds them (FULL_PRECISION)."""
    from gsvc_tpu_torch.models.gaussians import (
        GenerateMode, generate_neural_gaussians, window_for_frame,
    )
    from gsvc_tpu_torch.render.splat import (
        _bin_gaussians, attr_rows_from_proj, project_gaussians,
    )

    d, st, s = fitter.dataset, fitter.state, fitter.settings
    attrs, lists, counts = [], [], []
    with torch.no_grad():
        for i in (i1, i1 + 1):
            z = float(fitter.frame_zs[i])
            start, in_window = window_for_frame(st, fitter.gcfg, z,
                                                fitter.window_cap)
            gss = generate_neural_gaussians(
                st, fitter.gcfg, z, z, start, in_window, fitter.window_cap,
                mode=GenerateMode.FULL_PRECISION, decoded=False)
            proj = project_gaussians(gss.xyz, gss.scaling, gss.rot,
                                     gss.valid, z, d.x_min, d.y_min,
                                     d.scale, s)
            tl, cnt, _, _, _ = _bin_gaussians(proj, s)
            op = torch.where(proj.valid[:, None], gss.opacity,
                             torch.zeros_like(gss.opacity))
            attrs.append(attr_rows_from_proj(proj, op, gss.color))
            lists.append(tl)
            counts.append(cnt)
    return (torch.stack(attrs).contiguous(), torch.stack(lists),
            torch.stack(counts))


def training_phase(dec, bidir, mirror):
    """24 steps of GOPFitter.fit at the fixture's full width."""
    from gsvc_tpu_torch.config import load_config
    from gsvc_tpu_torch.framecube.frame import FrameCubeDataset
    from gsvc_tpu_torch.train.fit import GOPFitter
    from gsvc_tpu_torch.utils.checkpoint import load_checkpoint

    t0 = time.perf_counter()
    frames = decoded_ground_truth(dec)
    log(f"training phase: ground truth {frames.shape} uint8 rendered from "
        f"the bitstream in {time.perf_counter() - t0:.2f} s")
    cfg = load_config(str(FIXTURE_DIR / "cfg_args.yaml"), overrides=SCHEDULE)
    cfg.pipeline.source_path = cfg.pipeline.optical_path = ""
    cfg.pipeline.model_path = ""
    dataset = FrameCubeDataset(images=frames)
    t0 = time.perf_counter()
    fitter = GOPFitter(cfg, dataset, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"training phase: fitter set up in {time.perf_counter() - t0:.2f} s"
        f": {fitter.state.n_active} anchors (capacity {fitter.capacity}), "
        f"window_cap {fitter.window_cap}, tiles "
        f"{fitter.settings.tile_h}x{fitter.settings.tile_w} "
        f"(T={fitter.settings.n_tiles}), cap {fitter.settings.gaussian_cap}"
        f", chunk {fitter.settings.chunk}")
    t0 = time.perf_counter()
    psnr0 = fitter.evaluate()["psnr"]
    log(f"training phase: before step 1, mean PSNR of the {len(frames)} "
        f"frames {psnr0:.4f} dB ({time.perf_counter() - t0:.2f} s)")
    fitter.timer = StepTimer()
    ckpt_dir = tempfile.mkdtemp(prefix="gsvc_smoke_")

    bidir.bidir_composite_attrs.launches = 0
    mirror.mirror_forward.launches = 0
    mirror.mirror_backward.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = fitter.fit(iterations=TRAIN_STEPS, log_every=1,
                        eval_every=TRAIN_STEPS // 2,
                        checkpoint_iterations=(TRAIN_STEPS,),
                        checkpoint_dir=ckpt_dir)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (mirror.mirror_forward.launches,
                mirror.mirror_backward.launches)
    log(f"training phase: {TRAIN_STEPS} steps in {wall:.3f} s wall "
        f"(two 600-frame evals and the checkpoint included); launches "
        f"B1 {launches[0]}, B2 {launches[1]}")
    if launches != (TRAIN_STEPS, TRAIN_STEPS):
        raise AssertionError(f"B1/B2 launched {launches} times in "
                             f"{TRAIN_STEPS} steps")

    losses = [h["loss"] for h in report.history]
    if len(losses) != TRAIN_STEPS or not np.all(np.isfinite(losses)):
        raise AssertionError(f"losses: {losses}")
    for key in ("loss", "l1", "optical", "psnr"):
        log(f"training phase: {key} per step " + ", ".join(
            f"{h[key]:.5f}" for h in report.history))
    evals = {e["iter"]: e["psnr"] for e in report.evals}
    log(f"training phase: mean PSNR of the {len(frames)} frames: before "
        f"step 1 {psnr0:.4f} dB, after step 12 {evals[12]:.4f} dB, after "
        f"step 24 {evals[24]:.4f} dB")
    if not evals[12] > psnr0:
        raise AssertionError(f"the FULL_PRECISION steps did not improve the "
                             f"fit: PSNR {psnr0} before, {evals[12]} after")

    split = fitter.timer.split()
    later = split[1:]
    med = {k: float(np.median([r[k] for r in later])) for k in later[0]}
    log("training phase: step ms (CUDA events) " + ", ".join(
        f"{r['step']:.2f}" for r in split))
    log("training phase: median over steps 2-24: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in med.items()))
    log(f"training phase: {1e3 / med['step']:.3f} it/s at 1920x1080 from "
        f"the median step")

    fresh = GOPFitter(cfg, dataset, seed=1, device="cuda")
    it = load_checkpoint(f"{ckpt_dir}/chkpnt{TRAIN_STEPS}.pkl", fresh)
    same = all(torch.equal(a, b) for a, b in zip(fresh.state.anchors,
                                                 fitter.state.anchors))
    if it != TRAIN_STEPS or not same or fresh.adam.step != TRAIN_STEPS:
        raise AssertionError("the step-24 checkpoint did not load back")
    log(f"training phase: checkpoint {ckpt_dir}/chkpnt{TRAIN_STEPS}.pkl "
        f"loaded into a fresh fitter (iteration {it})")
    del fresh

    # the kernels on one training pair's inputs (frames 299, 300)
    attrs, lists, counts = training_pair_inputs(fitter, 299)
    f_err, b_err, pf, pb, aux = mirror_check(
        mirror, fitter.settings, attrs, lists, counts,
        "training phase (frames 299-300)")
    b1, b2 = mirror_times(mirror, fitter.settings, attrs, lists, counts, aux,
                          pf, pb, "training phase (frames 299-300)")
    b1.update(launches=launches[0], max_abs_err=f_err,
              step_ms=med["B1"])
    b2.update(launches=launches[1], max_abs_err=b_err,
              step_ms=med["B2+scatter"])
    return b1, b2


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from gsvc_tpu_torch import build
    from gsvc_tpu_torch.render import bidir, mirror
    from gsvc_tpu_torch.render.splat import RasterSettings

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    logs = build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s wall (nvcc and host "
        f"compiler started together)")
    for name, text in logs.items():
        for line in text.splitlines():
            if "entry function" in line or "registers" in line:
                log(f"  {name}: {line.strip()}")

    settings = RasterSettings(image_height=1080, image_width=1920,
                              threshold=0.1, tile_h=16, tile_w=128,
                              gaussian_cap=1024, chunk=128,
                              tiles_per_gaussian=32)
    kernel_err = kernel_phase(bidir, settings)
    train_settings = RasterSettings(image_height=1080, image_width=1920,
                                    threshold=0.05, tile_h=8, tile_w=128,
                                    gaussian_cap=1024, chunk=128,
                                    tiles_per_gaussian=32)
    mk_fwd, mk_bwd = mirror_kernel_phase(mirror, train_settings)
    res, dec = slice_phase(bidir)
    b1, b2 = training_phase(dec, bidir, mirror)

    table = {"kernels": [{
        "name": "bidir_composite_attrs",
        "route": "cuda",
        "source": "gsvc_tpu_torch/csrc/bidir.cu",
        "replaces": "gsvc_tpu/render/pallas_splat.py:1074",
        "launches": res["launches"],
        "max_abs_err": max(kernel_err, res["max_abs_err"]),
        "ms": res["ms"],
        "plain_ms": res["plain_ms"],
        "bound_ms": res["bound_ms"],
        "bound_by": res["bound_by"],
        "library_ms": None,   # no PyTorch call computes this function
    }, {
        "name": "mirror_forward",
        "route": "cuda",
        "source": "gsvc_tpu_torch/csrc/mirror_fwd.cu",
        "replaces": "gsvc_tpu/render/pallas_splat.py:636",
        "launches": b1["launches"],
        "max_abs_err": max(mk_fwd, b1["max_abs_err"]),
        "ms": b1["ms"],
        "plain_ms": b1["plain_ms"],
        "bound_ms": b1["bound_ms"],
        "bound_by": b1["bound_by"],
        "library_ms": None,   # no PyTorch call computes this function
    }, {
        "name": "mirror_backward",
        "route": "cuda",
        "source": "gsvc_tpu_torch/csrc/mirror_bwd.cu",
        "replaces": "gsvc_tpu/render/pallas_splat.py:699",
        "launches": b2["launches"],
        "max_abs_err": max(mk_bwd, b2["max_abs_err"]),
        "ms": b2["ms"],
        "plain_ms": b2["plain_ms"],
        "bound_ms": b2["bound_ms"],
        "bound_by": b2["bound_by"],
        "library_ms": None,   # no PyTorch call computes this function
    }]}
    log(json.dumps(table))
    log(f"wall: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
