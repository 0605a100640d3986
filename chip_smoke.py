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
   become the ground truth (uint8 on the card); ``GOPFitter.fit`` runs 40
   steps of the fixture's model and pipeline
   (artifacts/rd_r5/realtex_0.004/cfg_args.yaml: 1920x1080, 100k initial
   anchors, 50-dim features, 10 offsets, 8x128 tiles, the 12 + 4 level
   hash grid with 8 features) with only the schedule overlaid — 24
   FULL_PRECISION, 4 QUANTIZED_NOISE, 6 ENTROPY and 6 STE_ENTROPY steps,
   statistics from step 3 on, densify epochs (the index-plan path) at
   steps 6, 12, 18 (FULL_PRECISION), 30 and 36; the fit's eval hook
   scores all 600 frames every 8 steps (after steps 32 and 40 with STE
   rounding, through B3f), and the whole-model rate estimate runs after
   step 40.  The launch counts are reset just before and read just
   after: B1 and B2 must launch once per step, B3f/B3b once per entropy
   step (one union-window context query per frame pair) and in no other
   step, and B3f once per frame of the entropy-mode evaluations and once
   in the estimate.  Every loss must be finite and the bits per
   parameter finite and positive in the entropy phases; the mean PSNR of
   the 600 frames (FULL_PRECISION renders) after the 24 FULL_PRECISION
   steps must be MIN_FP_RISE above the PSNR before step 1; and the
   checkpoint written at step 40 must load into a fresh fitter.  (The
   training loss itself does not fall in a few steps: at step 1 the
   optical-flow term is ~0 — the time-conditioned offsets barely differ
   between neighbouring frames at the initial weights — and it grows as
   soon as the deform MLP takes its first Adam steps, in the JAX package
   as in the port.  The PSNR falls again in the entropy phases: the rate
   term drives the quantisation steps up, and with ``lmbda`` 0 it keeps
   rising, --fit-study.)  Prints each step's loss terms and time split
   (CUDA events), each densify epoch's milliseconds with the anchor
   count and capacity before and after, the per-phase median step, the
   estimated bits, and times B1/B2 and their plain versions on one
   training pair's inputs against their bounds.
6. Hash-grid phase: kernels B3f/B3b (``hashgrid_forward`` /
   ``hashgrid_backward``) against their plain versions on the fitted
   state's STE-binarised table, at (a) the union window of the frame pair
   299-300 (the inputs of a training step's context query) and (b) the
   whole anchor capacity (the estimate's query), timed with their bounds.
7. Prints the kernel table as one JSON line, then the result line.

Any failed check raises, so the run exits non-zero and prints no result.
Frames are written nowhere; the checkpoint goes to a temporary directory.
Without a CUDA device the script exits 1.

    python3 chip_smoke.py --fit-study

fits the training phase's model under the schedule variants of FIT_STUDY
(seeds, with and without the densify epoch, longer FULL_PRECISION,
``lmbda`` 0) and prints the mean PSNR of the 600 frames every 6 steps,
one JSON line per fit.
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
# (24 + 4 + 6 + 6 steps; densify epochs every 6 steps from step 6)
PHASES = (("FULL_PRECISION", 24), ("QUANTIZED_NOISE", 4), ("ENTROPY", 6),
          ("STE_ENTROPY", 6))
TRAIN_STEPS = sum(n for _, n in PHASES)
EVAL_EVERY = 8
# the mean PSNR of the 600 frames must rise by this much (dB) over the
# FULL_PRECISION steps.  Which frame pairs a short fit draws moves the
# 600-frame mean: 12 steps rose by -0.26 to +0.61 dB over three seeds
# with and without an epoch (--fit-study), so the stretch is 24 steps.
MIN_FP_RISE = 0.5
SCHEDULE = {"optimization.iterations": TRAIN_STEPS,
            "optimization.full_precision_training_total": PHASES[0][1],
            "optimization.quantized_training_total": PHASES[1][1],
            "optimization.entropy_constrained_train_total": PHASES[2][1],
            "optimization.ste_entropy_constrained_train_total": PHASES[3][1],
            "optimization.start_stat": 2,
            "optimization.pause_densification": 4,
            "optimization.update_from": 4,
            "optimization.update_interval": 6,
            "optimization.update_until": TRAIN_STEPS}
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
# kernel B3b vs its plain version: the largest difference at most 1e-4 of
# the largest gradient magnitude (the table gradient is an atomic float32
# sum of up to ~10^3 terms per row in an order that changes from run to
# run; the position gradient is formed as sum_c r_c dw_c, autograd takes
# the terms apart).  The forward is exact (MAX_HASH_FWD_ERR guards it).
HASH_BWD_REL_ERR = 1e-4
MAX_HASH_FWD_ERR = 1e-6


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
    trainer.make_step_body): start, b3f_start, b3f_end (the context query
    of the entropy phases), b1_start, b1_end, loss_end, b2_start, b2_end,
    b3b_start, b3b_end, backward_end, adam_end; and the hash-grid kernels'
    launch counts at start and adam_end."""

    def __init__(self, hk):
        self.hk = hk
        self.steps = []

    def _counts(self):
        return (self.hk.hashgrid_forward.launches,
                self.hk.hashgrid_backward.launches)

    def mark(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        if name == "start":
            self.steps.append({"b3_at_start": self._counts()})
        self.steps[-1][name] = ev
        if name == "adam_end":
            self.steps[-1]["b3_at_end"] = self._counts()

    def launches(self):
        """Per step: (B3f, B3b) launched inside it."""
        return [tuple(b - a for a, b in zip(e["b3_at_start"],
                                            e["b3_at_end"]))
                for e in self.steps]

    def split(self):
        """Per step: {phase: ms}."""
        torch.cuda.synchronize()
        rows = []
        for e in self.steps:
            def ms(a, b, e=e):
                return e[a].elapsed_time(e[b]) if a in e else 0.0
            b2 = ms("b2_start", "b2_end")
            b3f = ms("b3f_start", "b3f_end")
            b3b = ms("b3b_start", "b3b_end")
            rows.append({
                "step": ms("start", "adam_end"),
                "B3f": b3f,
                "generation+projection+binning": ms("start", "b1_start")
                - b3f,
                "B1": ms("b1_start", "b1_end"),
                "loss": ms("b1_end", "loss_end"),
                "B2+scatter": b2,
                "B3b": b3b,
                "rest of backward": ms("loss_end", "backward_end") - b2
                - b3b,
                "Adam+stats": ms("backward_end", "adam_end"),
            })
        return rows


def phase_of(it: int) -> str:
    """The schedule phase of iteration ``it`` (1-based)."""
    end = 0
    for name, n in PHASES:
        end += n
        if it <= end:
            return name
    return "STE_ENTROPY"


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


def timed_densify(fitter, epochs: list):
    """Wrap the fitter's densify epoch: record each epoch's iteration,
    milliseconds (host clock around a synchronised epoch) and the anchor
    count, capacity and window before and after."""
    run = fitter._densify

    def epoch():
        torch.cuda.synchronize()
        before = (fitter.state.n_active, fitter.capacity, fitter.window_cap)
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        epochs.append(dict(
            it=fitter.controller.current_iteration,
            ms=1e3 * (time.perf_counter() - t0), before=before,
            after=(fitter.state.n_active, fitter.capacity,
                   fitter.window_cap),
            grown=res.n_grown, pruned=res.n_pruned))
        return res

    fitter._densify = epoch


def training_phase(dec, bidir, mirror, hk):
    """GOPFitter.fit through the four phases at the fixture's full width.
    Returns (B1's numbers, B2's numbers, B3f/B3b launches, the fitter)."""
    from gsvc_tpu_torch.codec.estimate import estimate_final_bits
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
    fitter = GOPFitter(cfg, dataset, seed=0, device="cuda",
                       log_fn=lambda m: log(f"  fit: {m}"))
    torch.cuda.synchronize()
    log(f"training phase: fitter set up in {time.perf_counter() - t0:.2f} s"
        f": {fitter.state.n_active} anchors (capacity {fitter.capacity}), "
        f"window_cap {fitter.window_cap}, tiles "
        f"{fitter.settings.tile_h}x{fitter.settings.tile_w} "
        f"(T={fitter.settings.n_tiles}), cap {fitter.settings.gaussian_cap}"
        f", chunk {fitter.settings.chunk}; schedule "
        + ", ".join(f"{n} {name}" for name, n in PHASES))
    t0 = time.perf_counter()
    psnr0 = fitter.evaluate()["psnr"]
    log(f"training phase: before step 1, mean PSNR of the {len(frames)} "
        f"frames {psnr0:.4f} dB ({time.perf_counter() - t0:.2f} s)")
    fitter.timer = StepTimer(hk)
    epochs = []
    timed_densify(fitter, epochs)
    ckpt_dir = tempfile.mkdtemp(prefix="gsvc_smoke_")

    bidir.bidir_composite_attrs.launches = 0
    mirror.mirror_forward.launches = 0
    mirror.mirror_backward.launches = 0
    hk.hashgrid_forward.launches = 0
    hk.hashgrid_backward.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = fitter.fit(iterations=TRAIN_STEPS, log_every=1,
                        eval_every=EVAL_EVERY, rate_log_every=TRAIN_STEPS,
                        checkpoint_iterations=(TRAIN_STEPS,),
                        checkpoint_dir=ckpt_dir)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (mirror.mirror_forward.launches,
                mirror.mirror_backward.launches,
                hk.hashgrid_forward.launches, hk.hashgrid_backward.launches)
    log(f"training phase: {TRAIN_STEPS} steps in {wall:.3f} s wall "
        f"({len(report.evals)} 600-frame evals, {len(epochs)} densify "
        f"epochs, the rate estimate and the checkpoint included); launches "
        f"B1 {launches[0]}, B2 {launches[1]}, B3f {launches[2]}, B3b "
        f"{launches[3]}")
    if launches[:2] != (TRAIN_STEPS, TRAIN_STEPS):
        raise AssertionError(f"B1/B2 launched {launches[:2]} times in "
                             f"{TRAIN_STEPS} steps")
    entropic = ("ENTROPY", "STE_ENTROPY")
    per_step = fitter.timer.launches()
    for it, counts in enumerate(per_step, start=1):
        want = (1, 1) if phase_of(it) in entropic else (0, 0)
        if counts != want:
            raise AssertionError(f"step {it} ({phase_of(it)}): B3f/B3b "
                                 f"launched {counts} times, expected {want}")
    n_entropy = sum(phase_of(it) in entropic
                    for it in range(1, TRAIN_STEPS + 1))
    eval_b3 = len(frames) * sum(phase_of(e["iter"]) in entropic
                                for e in report.evals)
    want = (n_entropy + eval_b3 + 1, n_entropy)
    if launches[2:] != want:
        raise AssertionError(f"B3f/B3b launched {launches[2:]} times, "
                             f"expected {want} ({n_entropy} entropy steps, "
                             f"{eval_b3} evaluated frames, one estimate)")

    for e in epochs:
        log(f"training phase: densify epoch at step {e['it']} "
            f"({phase_of(e['it'])}): {e['ms']:.1f} ms, +{e['grown']} "
            f"-{e['pruned']} anchors; anchors / capacity / window_cap "
            f"{e['before']} -> {e['after']}")
    if not any(phase_of(e["it"]) == "FULL_PRECISION" for e in epochs):
        raise AssertionError(f"no densify epoch in FULL_PRECISION: "
                             f"{[e['it'] for e in epochs]}")

    hist = report.history
    losses = [h["loss"] for h in hist]
    if len(losses) != TRAIN_STEPS or not np.all(np.isfinite(losses)):
        raise AssertionError(f"losses: {losses}")
    for h in hist:
        rated = phase_of(h["iter"]) in entropic
        if rated != (np.isfinite(h["bpp"]) and h["bpp"] > 0):
            raise AssertionError(f"step {h['iter']} ({phase_of(h['iter'])})"
                                 f": bits per parameter {h['bpp']}")
    for key in ("loss", "l1", "optical", "psnr", "bpp", "n_active"):
        log(f"training phase: {key} per step " + ", ".join(
            f"{h[key]:.5f}" if key != "n_active" else str(h[key])
            for h in hist))
    evals = {e["iter"]: e["psnr"] for e in report.evals}
    log(f"training phase: mean PSNR of the {len(frames)} frames: before "
        f"step 1 {psnr0:.4f} dB, then " + ", ".join(
            f"after step {it} ({phase_of(it)}) {v:.4f} dB"
            for it, v in evals.items()))
    fp_end = PHASES[0][1]
    if not evals[fp_end] > psnr0 + MIN_FP_RISE:
        raise AssertionError(f"the FULL_PRECISION steps did not improve the "
                             f"fit by {MIN_FP_RISE} dB: PSNR {psnr0} before, "
                             f"{evals[fp_end]} after step {fp_end}")

    split = fitter.timer.split()
    log("training phase: step ms (CUDA events) " + ", ".join(
        f"{r['step']:.2f}" for r in split))
    meds = {}
    for name, _ in PHASES:
        rows = [r for it, r in enumerate(split, start=1)
                if phase_of(it) == name and it > 1]
        meds[name] = {k: float(np.median([r[k] for r in rows]))
                      for k in rows[0]}
        log(f"training phase: {name} median step over {len(rows)} steps: "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in meds[name].items())
            + f" ({1e3 / meds[name]['step']:.3f} it/s at 1920x1080)")

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    est = estimate_final_bits(fitter.state, fitter.gcfg)
    stop.record()
    torch.cuda.synchronize()
    mb = 8 * 2 ** 20
    log(f"training phase: estimate_final_bits in {start.elapsed_time(stop):.3f}"
        f" ms over capacity {fitter.capacity}: MB anchor "
        f"{est.bit_anchor / mb:.4f}, feat {est.bit_feat / mb:.4f}, scaling "
        f"{est.bit_scaling / mb:.4f}, offsets {est.bit_offsets / mb:.4f}, "
        f"hash {est.bit_hash / mb:.4f}, masks {est.bit_masks / mb:.4f}, mlp "
        f"{est.bit_mlp / mb:.4f}, total {est.total / mb:.4f}")
    if not (np.isfinite(est.total) and est.total > 0):
        raise AssertionError(f"estimated bits {est}")

    fresh = GOPFitter(cfg, dataset, seed=1, device="cuda")
    it = load_checkpoint(f"{ckpt_dir}/chkpnt{TRAIN_STEPS}.pkl", fresh)
    same = all(torch.equal(a, b) for a, b in zip(fresh.state.anchors,
                                                 fitter.state.anchors))
    if it != TRAIN_STEPS or not same or fresh.adam.step != TRAIN_STEPS:
        raise AssertionError(f"the step-{TRAIN_STEPS} checkpoint did not "
                             f"load back")
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
    fp = meds["FULL_PRECISION"]
    b1.update(launches=launches[0], max_abs_err=f_err, step_ms=fp["B1"])
    b2.update(launches=launches[1], max_abs_err=b_err,
              step_ms=fp["B2+scatter"])
    return b1, b2, launches[2:], fitter


def hash_flops(spec, n: int, backward: bool) -> int:
    """Least FP32 work of the encode (or its gradient) of n queries: per
    (query, instance) the cell (3 per dimension) and per corner its
    weight (2 per dimension), F multiply-adds and the weight sum, then F
    divisions; the gradient adds per corner the table row's F products,
    the residual's F subtract-multiply-adds and the position terms (4
    per dimension).  FMA counts 2."""
    f = spec.n_features
    total = 0
    for d, levels in ((3, spec.grid_3d.n_levels),
                      (2, 3 * spec.grid_2d.n_levels)):
        c = 1 << d
        per = 3 * d + c * (2 * d + 2 * f + 1) + f
        if backward:
            per += c * (3 * f + 4 * d)
        total += levels * per
    return n * total


def touched_rows(spec, x) -> int:
    """Distinct table rows that the encode of ``x`` needs: the corners of
    nonzero weight of every (query, level-instance).  Border corners and
    rows no query reaches are never read."""
    from gsvc_tpu_torch.ops.hashgrid import _level_indices

    s = spec.param_splits()
    rows = []
    for base, grid, cols in ((s[0], spec.grid_3d, [0, 1, 2]),
                             (s[1], spec.grid_2d, [0, 1]),
                             (s[2], spec.grid_2d, [0, 2]),
                             (s[3], spec.grid_2d, [1, 2])):
        xs = x[:, cols]
        for lvl in range(grid.n_levels):
            idx, w = _level_indices(xs, grid.resolutions[lvl],
                                    grid.level_sizes[lvl],
                                    grid.level_offsets[lvl], grid.num_dim)
            rows.append(torch.unique(idx[w != 0]) + base)
    return int(torch.unique(torch.cat(rows)).numel())


def hashgrid_check(hk, spec, table, x, label):
    """B3f/B3b against their plain versions on one input, timed."""
    out_k = hk.hashgrid_fwd_cuda(table, x, spec)
    out_p = hk.hashgrid_fwd_plain(table, x, spec)
    torch.cuda.synchronize()
    f_err = float((out_k - out_p).abs().max())
    if not np.isfinite(f_err) or f_err > MAX_HASH_FWD_ERR:
        raise AssertionError(f"{label}: B3f disagrees with its plain "
                             f"version: {f_err} > {MAX_HASH_FWD_ERR}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    g = torch.randn(out_p.shape, generator=gen, device="cuda")
    gt_k, gx_k = hk.hashgrid_bwd_cuda(table, x, g, spec)
    gt_p, gx_p = hk.hashgrid_bwd_plain(table, x, g, spec)
    torch.cuda.synchronize()
    b_abs, b_rel = 0.0, 0.0
    for got, want in ((gt_k, gt_p), (gx_k, gx_p)):
        if not torch.isfinite(got).all():
            raise AssertionError(f"{label}: B3b gave non-finite gradients")
        err = float((got - want).abs().max())
        b_abs = max(b_abs, err)
        b_rel = max(b_rel, err / max(float(want.abs().max()), 1e-30))
    if b_rel > HASH_BWD_REL_ERR:
        raise AssertionError(f"{label}: B3b disagrees with its plain "
                             f"version: {b_rel} > {HASH_BWD_REL_ERR} of the "
                             f"largest gradient")
    f_ms = cuda_ms(lambda: hk.hashgrid_fwd_cuda(table, x, spec), 20)
    b_ms = cuda_ms(lambda: hk.hashgrid_bwd_cuda(table, x, g, spec), 20)
    f_plain = cuda_ms(lambda: hk.hashgrid_fwd_plain(table, x, spec), 3)
    b_plain = cuda_ms(lambda: hk.hashgrid_bwd_plain(table, x, g, spec), 3)
    # bytes: the table rows the queries need (read once), x, the
    # cotangent, the outputs; B3b's table gradient is a dense output
    n = x.shape[0]
    rows = touched_rows(spec, x)
    row_bytes = rows * spec.n_features * 4
    fb = bound_ms(row_bytes + nbytes(x, out_k), hash_flops(spec, n, False))
    bb = bound_ms(row_bytes + nbytes(x, g, gt_k, gx_k),
                  hash_flops(spec, n, True))
    log(f"{label}: N={n} queries x {hk.instance_table(spec).shape[0]} "
        f"instances, {rows} of {spec.total_rows} table rows needed "
        f"({row_bytes / 1e6:.2f} MB); B3f max |kernel - plain| {f_err:.3e} (limit "
        f"{MAX_HASH_FWD_ERR:.0e}), kernel {f_ms:.4f} ms, plain "
        f"{f_plain:.3f} ms, bound {fb[0]:.4f} ms ({fb[1]}); B3b max |kernel "
        f"- plain| {b_abs:.3e} = {b_rel:.3e} of the largest gradient (limit "
        f"{HASH_BWD_REL_ERR:.0e}), kernel {b_ms:.4f} ms, plain "
        f"{b_plain:.3f} ms, bound {bb[0]:.4f} ms ({bb[1]})")
    return (dict(ms=f_ms, plain_ms=f_plain, bound_ms=fb[0], bound_by=fb[1],
                 max_abs_err=f_err),
            dict(ms=b_ms, plain_ms=b_plain, bound_ms=bb[0], bound_by=bb[1],
                 max_abs_err=b_abs))


def hashgrid_phase(hk, fitter):
    """B3f/B3b on the fitted state's STE-binarised table, at (a) the union
    window of the frame pair 299-300 and (b) the whole capacity."""
    from gsvc_tpu_torch.models.gaussians import get_anchor, window_for_frame
    from gsvc_tpu_torch.ops.quant import ste_binary

    st, spec = fitter.state, fitter.gcfg.grid
    cap = fitter.window_cap
    with torch.no_grad():
        table = ste_binary(st.nets.hash_table).contiguous()
        anchor_q = get_anchor(st)
        x_all = ((anchor_q - st.x_bound_min)
                 / (st.x_bound_max - st.x_bound_min)).contiguous()
    capacity = x_all.shape[0]
    s1, s2 = (window_for_frame(st, fitter.gcfg, float(fitter.frame_zs[i]),
                               cap)[0] for i in (299, 300))
    # the union window of render/batched.py:_pair_entropy_contexts
    slack = min(max(cap // 8, 64), capacity - cap)
    s_min = min(max(min(s1, s2), 0), capacity - cap - slack)
    x_win = x_all[s_min:s_min + cap + slack].contiguous()
    log(f"hash-grid phase: table {tuple(table.shape)} "
        f"({nbytes(table) / 1e6:.1f} MB), window_cap {cap} + slack {slack}, "
        f"capacity {capacity}")
    win = hashgrid_check(hk, spec, table, x_win,
                         "hash-grid phase (union window, frames 299-300)")
    full = hashgrid_check(hk, spec, table, x_all,
                          "hash-grid phase (whole capacity)")
    return win, full


# python3 chip_smoke.py --fit-study [index ...]: name, seed, fit steps,
# eval every, overrides on STUDY_SCHEDULE, keep the frame draws of a run
# without epochs (the epoch's random draws are undone).  STUDY_SCHEDULE
# is the training phase's schedule before it was widened: 12 + 8 + 8 + 8
# steps, densify epochs at steps 6, 18, 24 and 30.
STUDY_SCHEDULE = {**SCHEDULE, "optimization.iterations": 36,
                  "optimization.full_precision_training_total": 12,
                  "optimization.quantized_training_total": 8,
                  "optimization.entropy_constrained_train_total": 8,
                  "optimization.ste_entropy_constrained_train_total": 8,
                  "optimization.update_until": 36}
NO_EPOCH = {"optimization.update_from": 600}
FP24 = {"optimization.full_precision_training_total": 24}
FIT_STUDY = (
    ("smoke schedule (epoch at step 6)", 0, 12, 6, {}, False),
    ("no epoch in 12 steps", 0, 12, 6, NO_EPOCH, False),
    ("epoch at step 6, frame draws kept", 0, 12, 6, {}, True),
    ("smoke schedule, seed 1", 1, 12, 6, {}, False),
    ("no epoch, seed 1", 1, 12, 6, NO_EPOCH, False),
    ("smoke schedule, seed 2", 2, 12, 6, {}, False),
    ("no epoch, seed 2", 2, 12, 6, NO_EPOCH, False),
    ("24 FULL_PRECISION steps", 0, 24, 6, FP24, False),
    ("four phases, 36 steps", 0, 36, 6, {}, False),
    ("four phases, lmbda 0", 0, 36, 6, {"optimization.lmbda": 0.0}, False),
    ("four phases, no epoch after step 12", 0, 36, 6,
     {"optimization.update_until": 12}, False),
    ("24 FULL_PRECISION steps, seed 1", 1, 24, 8, FP24, False),
    ("24 FULL_PRECISION steps, seed 2", 2, 24, 8, FP24, False),
    ("24 FULL_PRECISION steps, seed 3", 3, 24, 8, FP24, False),
)


def fit_study(which):
    """Fits of the training phase's model on the decoded frames under the
    schedule variants ``which`` (indices into FIT_STUDY): the mean PSNR of
    the 600 frames before step 1 and every few steps, and the anchor
    count at the end."""
    from gsvc_tpu_torch import build
    from gsvc_tpu_torch.cli.decode import decode_bitstream
    from gsvc_tpu_torch.config import load_config
    from gsvc_tpu_torch.framecube.frame import FrameCubeDataset
    from gsvc_tpu_torch.train.fit import GOPFitter

    build.build()
    frames = decoded_ground_truth(decode_bitstream(FIXTURE, device="cuda"))
    dataset = FrameCubeDataset(images=frames)
    for i in which:
        name, seed, steps, every, over, keep_draws = FIT_STUDY[i]
        t0 = time.perf_counter()
        cfg = load_config(str(FIXTURE_DIR / "cfg_args.yaml"),
                          overrides={**STUDY_SCHEDULE, **over})
        cfg.pipeline.source_path = cfg.pipeline.optical_path = ""
        cfg.pipeline.model_path = ""
        fitter = GOPFitter(cfg, dataset, seed=seed, device="cuda",
                           log_fn=lambda m: None)
        epochs = []
        run = fitter._densify

        def epoch(fitter=fitter, run=run, epochs=epochs,
                  keep_draws=keep_draws):
            state = fitter.rng.bit_generator.state
            res = run()
            if keep_draws:
                fitter.rng.bit_generator.state = state
            epochs.append((fitter.controller.current_iteration,
                           res.n_grown, res.n_pruned))
            return res

        fitter._densify = epoch
        psnr0 = fitter.evaluate()["psnr"]
        report = fitter.fit(iterations=steps, log_every=1, eval_every=every)
        row = dict(index=i, name=name, seed=seed, psnr0=psnr0,
                   evals={e["iter"]: e["psnr"] for e in report.evals},
                   epochs=epochs, n_active=fitter.state.n_active,
                   bpp_last=report.history[-1]["bpp"],
                   seconds=time.perf_counter() - t0)
        log("fit study: " + json.dumps(row))
        del fitter
        torch.cuda.empty_cache()


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from gsvc_tpu_torch import build
    from gsvc_tpu_torch.ops import hashgrid_kernels as hk
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
    b1, b2, b3_launches, fitter = training_phase(dec, bidir, mirror, hk)
    (h3f, h3b), (c3f, c3b) = hashgrid_phase(hk, fitter)

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
    }, {
        "name": "hashgrid_forward",
        "route": "cuda",
        "source": "gsvc_tpu_torch/csrc/hashgrid_fwd.cu",
        "replaces": "gsvc_tpu/ops/pallas_hashgrid.py:270",
        "launches": b3_launches[0],
        "max_abs_err": max(h3f["max_abs_err"], c3f["max_abs_err"]),
        "ms": h3f["ms"],
        "plain_ms": h3f["plain_ms"],
        "bound_ms": h3f["bound_ms"],
        "bound_by": h3f["bound_by"],
        "library_ms": None,   # no PyTorch call computes a hash-grid encode
    }, {
        "name": "hashgrid_backward",
        "route": "cuda",
        "source": "gsvc_tpu_torch/csrc/hashgrid_bwd.cu",
        "replaces": "gsvc_tpu/ops/pallas_hashgrid.py:295",
        "launches": b3_launches[1],
        "max_abs_err": max(h3b["max_abs_err"], c3b["max_abs_err"]),
        "ms": h3b["ms"],
        "plain_ms": h3b["plain_ms"],
        "bound_ms": h3b["bound_ms"],
        "bound_by": h3b["bound_by"],
        "library_ms": None,   # no PyTorch call computes a hash-grid encode
    }]}
    log(json.dumps(table))
    log(f"wall: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--fit-study"]:
        if not torch.cuda.is_available():
            sys.exit("chip_smoke: no CUDA device available")
        fit_study([int(a) for a in sys.argv[2:]]
                  or range(len(FIT_STUDY)))
        sys.exit(0)
    sys.exit(main())
