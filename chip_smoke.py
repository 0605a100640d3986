"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the port's native code from the checkout (``nvcc`` for the
   kernels, the host C++ compiler for the entropy codec), all compilers
   started together, and prints the build's wall seconds, each kernel's
   registers, shared memory and spills (``-Xptxas -v``), the SASS
   instructions per evaluated (copy, pixel) pair of the inner loops of
   B1, B2, B6f, B6b, B4, B5f and B5b (``cuobjdump -sass``, where the
   toolkit has it) and the SM clock (``nvidia-smi clocks.max.sm``).
3. Kernel phase: kernel B4 (``bidir_composite_attrs``) against its plain
   PyTorch version at the 1080p decode shapes (T=1020 tiles, cap 1024,
   chunk 128, P=2048 pixels), with B4's report (below), and kernels
   B1/B2 (``mirror_forward`` /
   ``mirror_backward``, the training composite) against theirs at the
   1080p training shapes (F=2 frames, T=2025 tiles of 8x128, cap 1024,
   chunk 128), with and without per-view means2d gradients; seeded
   attribute rows: empty tiles, full lists of saturated stacks,
   chunk-aligned and partial last chunks.  B2 takes the forward's out4
   and t_chk, and two of its launches must give the same bits.
4. Decode phase: decodes the committed 1080p bitstream
   (artifacts/rd_r5/realtex_0.004) with ``gsvc_tpu_torch.cli.decode`` and
   renders 8 frames through ``report.evaluate_video`` — the decoder's own
   render loop — with the launch counts reset just before and read just
   after; then holds each frame's kernel composite against the plain
   version and times both.  B4's report on the middle frame (342) and in
   the kernel phase: the kernel alone (torch.profiler), the work per
   block (chunks used per tile, the heaviest tile's pairs and share),
   the chip-wide and critical-path issue floors, and a digest of the
   output's bits.
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
   state's STE-binarised table (B3f bit for bit), at (a) the union window
   of the frame pair 299-300 (the inputs of a training step's context
   query) and (b) the whole anchor capacity (the estimate's query).  Each
   kernel's own device time (torch.profiler's CUPTI kernel durations),
   all device work of its wrapper's call, the call back to back (CUDA
   events), the host time of a call and the bound; B3b's global atomic
   count, and what combining the adds per row in a block would leave.
7. Tile-kernel phase (run right after step 3's kernels): kernels B5f/B5b
   (``tile_forward`` / ``tile_backward``, the single-view composite that
   serves frame widths that are not a multiple of tile_w) against their
   plain versions at the 1080p training shapes (V=4 views of T=2025
   8x128 tiles, cap 1024, chunk 128; the synthetic tiles of step 3), with
   and without checkpoints, and the plane gradients of both pushed
   through the gather's transpose with and without per-view means2d;
   two B5b launches must give the same bits, and B5f's out4 and t_chk
   must equal B1's forward-view rows on the same four frames bit for
   bit.  B5f and B5b are timed alone too, with their work per block
   (chunks walked per row, the heaviest row, the padding share of the
   walked chunks) and both issue floors, and a SHA-256 digest of B5f's
   out4 and t_chk.
8. Codec phase: the training phase's fitted state through
   ``conduct_encoding`` -> ``save_streams`` -> ``load_streams`` ->
   ``conduct_decoding`` -> ``evaluate_video`` over all 600 frames (B4 once
   per frame and no other composite); the decoded hash signs must equal
   the STE-binarised table, the decoded masks their encoded count, and
   the decoded anchors the encoder's quantized anchors.  Prints the
   encode and decode seconds, the size, bpp, the rate estimate and the
   decoded PSNR beside the fitter's STE evaluation of the state before
   the encode (none of them gated).
9. Stream phase (the stream rasterizer, kernels B6f/B6b):
   (a) B6f/B6b (``stream_forward`` / ``stream_backward``) against their
   plain versions on the synthetic 1080p tiles of step 3 laid out as the
   chunk-aligned copy stream, and on the fitted state's pair 299-300
   binned with copy_budget_factor 0 and 8 (``bin_gaussians_stream``);
   (b) on the same copies B6f against B1 (bit for bit) and B6b against
   B2 (both scattered to the gaussians, with per-view means2d), kernel
   to kernel, and on each of the three inputs their times against their
   bounds and against B1/B2's: each kernel alone (torch.profiler) and
   each call, taken in turns with B1/B2's on the same copies (the log
   prints B6f/B1 and B6b/B2 alone, B1/B6f and B2/B6b by call), and the
   padding share of the stream's live blocks; then (d)
   ``gsvc_tpu_torch.cli.stream.main`` on a checkpoint of the fitted state
   with --set pipeline.rasterizer=pallas_stream --set
   pipeline.copy_budget_factor=8 and GSVC_RASTERIZER=pallas_stream (the
   CLI's dataset is handed the 1080p frames from memory): streaming
   encode, save, decode and the evaluation of all 600 frames, which must
   launch B6f once per frame and no other composite, give z_slices > 1
   and a decoded PSNR within 0.01 dB of the codec phase's B4 evaluation;
   then (c) ``GOPFitter.fit`` with the stream rasterizer and
   copy_budget_factor 8 on the 1080p frames, 12 steps of the narrow
   phase's schedule: B6f and B6b once per step and no other composite,
   finite losses, the per-step overflow and the per-phase medians; and
   the same fit (seed, frames, schedule) through B1/B2 for comparison.
10. Narrow-width phase: the 600 frames resized on the card to 854x480
   (DAVIS 2017 480p; 854 is not a multiple of 128) as PNGs, then
   ``gsvc_tpu_torch.cli.train.main`` without --skip_codec on them with
   the fixture's cfg_args.yaml and a 12-step four-phase schedule
   overlaid (densify epochs from step 4): fit, estimate, encode, save,
   decode, evaluate.  The launch counts are reset just before main and
   read just after: B5f and B5b once per step, B5f once per frame of the
   fitter's evaluation and of the decoded one, B1, B2 and B4 never; the
   losses must be finite, and results.json must hold bpp > 0 and a finite
   decoded PSNR.  Then B5f/B5b against their plain versions on the
   fitted state's pair 299-300 (its four views' planes), timed as in
   step 7.  The fit is not bitwise repeatable, so with GSVC_SMOKE_PAIR
   set to a file name the first run saves its pair there and every run
   prints the digest of B5f's output on the saved pair.
11. Whole-video phase (``whole_video_phase``): the first 16 decoded
   frames as PNGs with seeded uniform flow fields, and the fixture's
   cfg_args.yaml with the narrow phase's schedule in the file (segments
   are given no --set).  ``cli.train.main --gop_size 8`` encodes them in
   two GOPs at the fixture's full model; the counts, reset before and read
   after, must show B1 and B2 once a step, B3f/B3b once an entropy step,
   B4 once per frame of each decoded evaluation and no B5f, B5b, B6f or
   B6b; each ``gop_*`` must hold bitstreams/, results.json (bpp > 0,
   finite decoded PSNR), metrics.jsonl, cfg_args.yaml, chkpnt_final.pkl
   and point_cloud/final/ (the PLY equal to the checkpoint's first
   n_active anchors) and the summary gops == 2.  Then ``cli.decode`` on
   GOP 0 with GSVC_DECODE=mirror and proxy LPIPS: B1 once per frame and
   no B4, LPIPS in [0, 1), the PSNR within 0.01 dB of B4's on the same
   decoded state (fps of both printed); ``cli.train --profile`` (the
   trace must parse; whether B1 and B2 show in it is printed); LPIPS at
   full VGG16 width on decoded frame 0, on the card with cuDNN's TF32
   switch at PyTorch's default against the CPU at rel 1e-6 (TF32 would
   differ by ~1.5e-5);
   ``cli.debug_vis`` (three PNGs) and ``ViewerServer.render_png(0)``
   against the decode's frame 0 (1 LSB).  ``cli.sweep`` is not run: it
   only loops over ``cli.train.main``, which this phase runs, and each
   point would cost another ~30 s host codec round trip.
12. Multi-rank phase (``multi_rank_phase``, ``parallel/spmd.py``): its
   ranks share the card over gloo, so it shows that the path is right at
   full width, not multi-GPU speed.  (a) Frame 300's forward and flipped
   views of the training phase's fitted state, one z-slab a rank (4
   spawned ranks as 2 x 2, i.e. sp = 2, and as 1 x 4, where
   ``neighbors=1`` takes the ppermute rounds staged through the host),
   ``combine_slab_renders`` with and without ``neighbors`` against the
   single-rank ``render_frame`` at 2e-4, the branches within 1e-6; the
   same, gated alike, for a depth-disjoint copy of the state (no z
   offsets, no two slabs at one depth) at the frame on the slabs' middle
   boundary, where the combine weights one slab by another's
   transmittance; the fitted state's boundary frame, whose slabs overlap
   in depth, is printed, not gated;
   (b) ``cli.train.main --mesh dp=2,sp=2`` with the codec on the
   whole-video phase's GOP 0 (8 frames, the fixture's full model, the
   12-step schedule), on 4 ranks that the smoke spawns inside a gloo group
   on cuda:0 (the CLI's use-the-group path): per step and rank B1 and B2
   once, B3f/B3b once an entropy step, no other composite; B4 once per
   decoded frame on rank 0 only; a densify epoch, the capacity a multiple
   of 2, equal nets on all ranks, bpp > 0 and a finite decoded PSNR; the
   mesh checkpoint in a single-GPU ``GOPFitter`` evaluates frame 0 to the
   mesh fitter's PSNR exactly; per rank the peak memory, the median step
   and the collective milliseconds a step (the smoke's own synchronised
   host clock around the transport helpers); (c) ``cli.train.main
   --gop_size 8 --gop_parallel`` on the 16 frames through the CLI's own
   spawner (2 ranks): every ``gop_*`` artifact of the sequential run, the
   summary's gops and mesh, its wall beside the sequential run's.
13. Prints the kernel table as one JSON line (``ms``: the wrapper's
   call, 20 back to back under CUDA events; ``kernel_ms``, B3f, B3b, B4,
   B5f, B5b, B6f and B6b: the kernel alone; ``launches``: the sum over
   the paths that were counted, each reset before and read after; the
   multi-rank phase's summed over its ranks), then the result line.

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
import os
import pathlib
import re
import shutil
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
# stops; the kernel forms each suffix as the colour total minus a running
# sum, the plain version by a reverse cumsum, and 1/(1 - alpha) amplifies
# that rounding up to 100x; pixel sums also run in other orders.
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
# moment sums (11) and the colour sums (6).
FLOPS_PER_BWD_PAIR = 49
# kernel B3b vs its plain version: the largest difference at most 1e-4 of
# the largest gradient magnitude (the table gradient is an atomic float32
# sum of up to ~10^3 terms per row in an order that changes from run to
# run; the position gradient is formed as sum_c r_c dw_c, autograd takes
# the terms apart).  The forward is exact: kernel and plain version must
# agree bit for bit.
HASH_BWD_REL_ERR = 1e-4


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


def profiled_ms(fn, iters: int, tries: int = 3):
    """{device activity name: (mean device ms a launch, launches)} over
    ``iters`` calls of ``fn`` after one warm-up call: the durations of
    the CUDA kernels and memsets that CUPTI records (``torch.profiler``;
    the host side's launch events, which carry their kernels' time too,
    are left out).  A profile that holds no device activity at all (seen
    in runs on the H100, once after the training phase three times in a
    row) is taken again after the allocator's cache is returned to the
    card, up to ``tries`` times; None if every profile was empty."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        times = {e.key: (e.device_time_total / e.count / 1e3, e.count)
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and e.device_time_total > 0}
        if times:
            return times
        free, total = torch.cuda.mem_get_info()
        log(f"torch.profiler recorded no device activity ({free / 2**30:.1f}"
            f" of {total / 2**30:.1f} GiB free, "
            f"{torch.cuda.memory_reserved() / 2**30:.1f} GiB held by the "
            f"allocator); profiling again after emptying its cache")
        torch.cuda.empty_cache()
    return None


def kernel_ms(fn, kernel: str, iters: int):
    """(mean device ms a launch of the kernel whose name holds
    ``kernel``, device ms of one call of ``fn``: the sum of the mean
    launches of every kernel and memset it runs, each once a call), from
    ``profiled_ms``.  Where every profile came back empty, both are the
    call's time under CUDA events (``cuda_ms``), and the log says so.
    Raises when the profiler saw no such kernel."""
    times = profiled_ms(fn, iters)
    if times is None:
        ms = cuda_ms(fn, iters)
        log(f"torch.profiler empty: {kernel} timed by CUDA events around "
            f"the call instead ({ms:.4f} ms): not the kernel alone")
        return ms, ms
    mine = [ms for k, (ms, _) in times.items() if kernel in k]
    if len(mine) != 1:
        raise AssertionError(f"torch.profiler recorded {len(mine)} kernels "
                             f"named {kernel}: {times}")
    return mine[0], sum(ms for ms, _ in times.values())


def host_ms(fn, iters: int) -> float:
    """Mean host milliseconds of one call of ``fn`` (the host clock
    around ``iters`` calls, without a synchronise inside: the time the
    caller's thread spends in the call)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * t / iters


def paired_ms(fa, fb, iters: int):
    """(mean ms of ``fa``, of ``fb``), each the mean of two ``cuda_ms``
    runs taken in turns a, b, b, a on the same card."""
    a1, b1 = cuda_ms(fa, iters), cuda_ms(fb, iters)
    b2, a2 = cuda_ms(fb, iters), cuda_ms(fa, iters)
    return (a1 + a2) / 2, (b1 + b2) / 2


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


def ptxas_report(text: str, lib: str):
    """One line per kernel of library ``lib``'s ``nvcc -Xptxas -v`` log:
    registers, shared memory, stack and spills (a kernel named
    ``<lib>_kernel``, with its pixels per thread where it is a template)."""
    lines, name, spill = [], None, ""
    for line in text.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name = entry.group(1)
            ppt = re.search(rf"{lib}_kernelILi(\d+)E", name)
            if f"{lib}_kernel" in name:
                name = f"{lib}_kernel" + (f"<{ppt.group(1)}>" if ppt else "")
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name:
            lines.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            name, spill = None, ""
    return lines


# kernel instantiations whose inner loops sass_floors counts: the mirror
# kernels at the training tiles' 8 pixels a thread; B4, B5f, B5b and the
# stream kernels join them at the instantiations their launch plans take
# (sass_kernels)
SASS_KERNELS = (("B1", "mirror_fwd", "mirror_fwd_kernelILi8E"),
                ("B2", "mirror_bwd", "mirror_bwd_kernelILi8E"))
# the card's SM clock (MHz, nvidia-smi clocks.max.sm), read in main
SM_CLOCK_MHZ = None


def sass_kernels(bidir, stream, tile, decode_settings, train_settings):
    """SASS_KERNELS plus B4 at the decode tiles and B5f, B5b, B6f and B6b
    at the training tiles, each at the pixels a thread its launch plan
    gives, and how a pair meets the loops: "each" (a pair runs in one of
    them: B4's front or back loop, a view's copy of a loop) or "sum"
    (every replayed pair runs in each: a backward that walks a chunk
    twice)."""
    ppt4 = bidir.bidir_launch_plan(decode_settings)[2]
    ppt5 = tile.launch_shape(train_settings)[1]
    ppt6 = stream.launch_shape(train_settings)[1]
    return tuple((*k, "each") for k in SASS_KERNELS) + (
        ("B6f", "stream_fwd", f"stream_fwd_kernelILi{ppt6}E", "each"),
        ("B6b", "stream_bwd", f"stream_bwd_kernelILi{ppt6}E", "each"),
        ("B4", "bidir", f"bidir_kernelILi{ppt4}E", "each"),
        ("B5f", "tile_fwd", f"tile_fwd_kernelILi{ppt5}E", "each"),
        ("B5b", "tile_bwd", f"tile_bwd_kernelILi{ppt5}E", "sum"))


def sass_loops(sass: str, kernel: str):
    """The innermost loops of ``kernel`` that evaluate an exponential:
    [(instructions, MUFU.EX2 count, SHFL count)] from ``cuobjdump -sass``
    text.  A loop spans a backward branch's target (a label, or an
    address as CUDA 12.8's cuobjdump prints it) to the branch; its count
    leaves out NOPs."""
    code = next((part for part in sass.split("Function : ")[1:]
                 if kernel in part.split(None, 1)[0]), None)
    if code is None:
        return []
    ins, at = [], {}
    for line in code.splitlines():
        label = re.match(r"\s*(\.L_x_\d+):", line)
        if label:
            at[label.group(1)] = len(ins)
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            at[int(m.group(1), 16)] = len(ins)
            ins.append(m.group(2))
    loops = []
    for k, text in enumerate(ins):
        m = re.search(r"\bBRA\b.*?(\.L_x_\d+|0x[0-9a-f]+)", text)
        if not m:
            continue
        target = m.group(1)
        lo = at.get(target if target.startswith(".") else int(target, 16))
        if lo is not None and lo <= k:
            loops.append((lo, k))

    def count(op, a, b):
        return sum(op in t for t in ins[a:b + 1])

    out = []
    for lo, hi in loops:
        inner = any(lo <= lo2 and hi2 <= hi and (lo2, hi2) != (lo, hi)
                    and count("MUFU.EX2", lo2, hi2) for lo2, hi2 in loops)
        if count("MUFU.EX2", lo, hi) and not inner:
            out.append((sum("NOP" not in t.split() for t in ins[lo:hi + 1]),
                        count("MUFU.EX2", lo, hi), count("SHFL", lo, hi)))
    return out


def sass_floors(build, kernels):
    """Issued-instruction floor per evaluated (copy, pixel) pair of the
    compositing kernels' inner loops: static SASS instructions of each
    innermost loop that evaluates alphas over its MUFU.EX2 count (one per
    pair).  A design that walks a chunk twice has a loop per walk, and
    the compiler may keep a copy of a loop per view (forward, flip), so
    the line lists every loop.  Prints "not measured" without
    ``cuobjdump``.  Returns {label: (least, most) instructions a pair}:
    over the loops ("each"), or their sum both times ("sum")."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not pathlib.Path(tool).exists():
        log("sass: cuobjdump not found; instructions per pair not measured")
        return {}
    per_pair = {}
    for label, lib, kernel, how in kernels:
        sass = subprocess.run([tool, "-sass", str(build._target(lib))],
                              capture_output=True, text=True).stdout
        loops = sass_loops(sass, kernel)
        if not loops:
            log(f"sass: {label} ({kernel}): no loop found; not measured")
            continue
        ipp = [n / ex2 for n, ex2, _ in loops]
        per_pair[label] = ((sum(ipp),) * 2 if how == "sum"
                           else (min(ipp), max(ipp)))
        log(f"sass: {label} ({kernel}): inner loops (instructions, "
            f"MUFU.EX2, SHFL) {loops}: " + ", ".join(
                f"{v:.1f}" for v in ipp) + " instructions per pair"
            + (f" (a pair runs in every loop: {sum(ipp):.1f})"
               if how == "sum" and len(ipp) > 1 else ""))
    return per_pair


# instructions a pair of B4, B5f, B5b, B6f and B6b (sass_floors), read by
# their phases
SASS_PER_PAIR = {}


def floors(label, pairs, heaviest, threads):
    """The two issue floors of a compositing kernel, in ms, from its
    SASS instructions a pair (least and most over its loops): the
    chip-wide floor, pairs x instructions / 32 lanes over every
    scheduler of the card (4 an SM) at the SM clock, and the
    critical-path floor, the heaviest block's pairs x instructions over
    its threads, times its warps a scheduler, at the SM clock (left out
    where ``heaviest`` is None).  A string for the log ("not measured"
    without the SASS count or the clock)."""
    ipp = SASS_PER_PAIR.get(label)
    if ipp is None or not SM_CLOCK_MHZ:
        return "floors not measured (no SASS count or SM clock)"
    hz = SM_CLOCK_MHZ * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    wps = -(-threads // 128)
    chip = [1e3 * pairs * i / 32 / (sms * 4 * hz) for i in ipp]

    def rng(v):
        return (f"{v[0]:.4f}" if v[0] == v[1]
                else f"{v[0]:.4f}-{v[1]:.4f}")
    if heaviest is None:
        return (f"chip-wide issue floor {rng(chip)} ms ({ipp[0]:.1f}-"
                f"{ipp[1]:.1f} instructions a pair, {pairs} pairs, {sms} "
                f"SMs at {SM_CLOCK_MHZ} MHz)")
    crit = [1e3 * heaviest * i / threads * wps / hz for i in ipp]
    return (f"chip-wide issue floor {rng(chip)} ms, critical-path floor "
            f"{rng(crit)} ms ({ipp[0]:.1f}-{ipp[1]:.1f} instructions a "
            f"pair, {sms} SMs at {SM_CLOCK_MHZ} MHz, heaviest block "
            f"{heaviest} pairs on {threads} threads, {wps} warps a "
            f"scheduler)")


def bidir_tile_pairs(settings, attrs, lists, counts, batch: int = 128):
    """Evaluated pairs of each tile of one frame [T] in B4's loops: the
    front loop walks a tile's used chunks while some pixel keeps T >=
    T_EPS at the chunk boundary, the back loop walks down from its last
    used chunk to that stop while some pixel keeps S >= T_EPS.  The
    alphas are the plain mirror composite's, ``batch`` tiles at a time;
    the stops are taken for every tile at once."""
    from gsvc_tpu_torch.render import mirror
    from gsvc_tpu_torch.render.splat import T_EPS

    t_n, chunk = settings.n_tiles, settings.chunk
    n_chunks = settings.gaussian_cap // chunk
    dev = attrs.device
    cnt = counts.reshape(-1).long()
    n_used = ((cnt + chunk - 1) // chunk).clamp(max=n_chunks)
    # each chunk's product of (1 - alpha) per pixel [n_chunks, T, P]
    factor = torch.empty(n_chunks, t_n, settings.tile_h * settings.tile_w,
                         device=dev)
    for lo in range(0, t_n, batch):
        sel = torch.arange(lo, min(lo + batch, t_n), device=dev)
        tl = mirror._mirror_tiles(settings, attrs, lists, counts, 2 * sel)
        idx = torch.arange(sel.numel(), device=dev)
        for c in range(n_chunks):
            factor[c, sel] = mirror._excl_cumprod(
                1.0 - tl.load(c, idx)[1])[1]
    walked = torch.zeros(n_chunks, t_n, dtype=torch.bool, device=dev)
    t = torch.ones_like(factor[0])
    alive = torch.ones(t_n, dtype=torch.bool, device=dev)
    for c in range(n_chunks):
        alive &= (c < n_used) & (t.amax(dim=1) >= T_EPS)
        walked[c] = alive
        t = torch.where(alive[:, None], t * factor[c], t)
    p_stop = walked.sum(dim=0)
    s = torch.ones_like(t)
    alive = torch.ones_like(alive)
    for c in range(n_chunks - 1, -1, -1):
        started = c < n_used
        alive &= ~started | ((c >= p_stop) & (s.amax(dim=1) >= T_EPS))
        run = alive & started
        walked[c] |= run
        s = torch.where(run[:, None], s * factor[c], s)
    pos = torch.arange(n_chunks, device=dev)[:, None]
    real = (cnt[None] - pos * chunk).clamp(0, chunk)
    return (real * walked).sum(dim=0) * settings.tile_h * settings.tile_w


def bidir_work(settings, attrs, lists, counts, pairs):
    """Work per block of B4 on one frame: (log text, the heaviest tile's
    evaluated pairs), from ``bidir_tile_pairs``; their sum is checked
    against the plain version's ``pairs`` in the text."""
    cnt = counts.reshape(-1).long()
    cap, chunk = settings.gaussian_cap, settings.chunk
    p_pix = settings.tile_h * settings.tile_w
    n_used = ((cnt + chunk - 1) // chunk).clamp(max=cap // chunk)
    hist = torch.bincount(n_used, minlength=cap // chunk + 1).tolist()
    per_tile = bidir_tile_pairs(settings, attrs, lists, counts)
    best = int(per_tile.max()) if per_tile.numel() else 0
    full = cnt >= cap
    single = int(cnt[n_used == 1].sum()) * p_pix
    slots = int(n_used.sum()) * chunk * p_pix
    text = (f"{cnt.numel()} tiles, {int(cnt.sum())} copies, median "
            f"{int(cnt.median())}; chunks used {{0..{cap // chunk}}}: "
            f"{hist}; {slots} (slot, pixel) pairs in the used chunks, "
            f"padding slots included; {pairs} evaluated pairs "
            f"({int(per_tile.sum())} summed over the tiles), "
            f"{pairs - single} "
            f"({(pairs - single) / max(pairs, 1):.1%}) in the "
            f"{int((n_used > 1).sum())} tiles of more than one chunk, "
            f"{int(per_tile[full].sum())} in the {int(full.sum())} full "
            f"tiles; heaviest tile {best} pairs "
            f"({best / max(pairs, 1):.2%} of all)")
    return text, best


def tile_work(settings, cnt, chk, pairs):
    """Work per block of B5f and B5b (one block a plane row): (log text
    with the padding share of the walked chunks' slots, the heaviest
    row's pairs).  B5f walks a row's used chunks while some pixel of the
    tile keeps T >= T_EPS at the chunk's start, B5b replays the same
    chunks: those up to the last used one whose checkpoint has a live
    pixel."""
    from gsvc_tpu_torch.render.splat import T_EPS

    cnt = cnt.long()
    cap, chunk = settings.gaussian_cap, settings.chunk
    n_chunks = cap // chunk
    p_pix = settings.tile_h * settings.tile_w
    pos = torch.arange(n_chunks, device=cnt.device)
    n_used = ((cnt + chunk - 1) // chunk).clamp(max=n_chunks)
    live = (chk[:, :n_chunks].amax(dim=2) >= T_EPS) \
        & (pos[None] < n_used[:, None])
    walked = torch.where(live, pos[None] + 1, 0).amax(dim=1)
    real = (cnt[:, None] - pos[None] * chunk).clamp(0, chunk)
    per_row = (real * (pos[None] < walked[:, None])).sum(dim=1) * p_pix
    best = int(per_row.max()) if per_row.numel() else 0
    hist = torch.bincount(walked, minlength=n_chunks + 1).tolist()
    slots = int(walked.sum()) * chunk * p_pix
    pad = 1.0 - int(per_row.sum()) / max(slots, 1)
    text = (f"{cnt.numel()} rows, chunks walked {{0..{n_chunks}}}: "
            f"{hist}; {slots} (slot, pixel) pairs in the walked chunks, "
            f"padding slots included (padding share {pad:.4f}); "
            f"{int(per_row.sum())} pairs of copies (plain version: "
            f"{pairs}); heaviest row {best} pairs "
            f"({best / max(pairs, 1):.2%} of all)")
    return text, best


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
    gr_k = mirror.mirror_bwd_cuda(settings, attrs, lists, counts, out_p,
                                  chk_p, g_out)
    gr_k2 = mirror.mirror_bwd_cuda(settings, attrs, lists, counts, out_p,
                                   chk_p, g_out)
    gr_p, pairs_b = mirror.mirror_bwd_plain(settings, attrs, lists, counts,
                                            chk_p, g_out)
    torch.cuda.synchronize()
    if not torch.isfinite(gr_k).all():
        raise AssertionError(f"{label}: B2 gave non-finite gradients")
    if not torch.equal(gr_k, gr_k2):
        raise AssertionError(f"{label}: two B2 launches on the same inputs "
                             f"gave different per-copy rows")
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
        f"rows and the scatter with and without means2d; two launches "
        f"bit-identical)")
    return fwd_err, bwd_abs, pairs_f, pairs_b, (out_p, chk_p, g_out, gr_p)


def mirror_times(mirror, settings, attrs, lists, counts, aux, pairs_f,
                 pairs_b, label):
    """Kernel and plain times of B1 and B2 on one input, with bounds."""
    out_p, chk_p, g_out, gr_p = aux
    f_ms = cuda_ms(lambda: mirror.mirror_fwd_cuda(settings, attrs, lists,
                                                  counts), 10)
    b_ms = cuda_ms(lambda: mirror.mirror_bwd_cuda(settings, attrs, lists,
                                                  counts, out_p, chk_p,
                                                  g_out), 5)
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


def b4_report(bidir, settings, attrs, lists, counts, out_k, pairs, label):
    """B4 on one frame's inputs: the kernel alone (torch.profiler), the
    work per block, both issue floors at the launch plan's cluster size,
    and a digest of the output's bits (to hold two trees' kernels to each
    other).  Returns the kernel alone in ms."""
    import hashlib

    k_ms, _ = kernel_ms(lambda: bidir.bidir_out4_cuda(settings, attrs,
                                                      lists, counts),
                        "bidir_kernel", 20)
    work, heaviest = bidir_work(settings, attrs, lists, counts, pairs)
    c_n, threads, ppt = bidir.bidir_launch_plan(settings)
    digest = hashlib.sha1(out_k.cpu().numpy().tobytes()).hexdigest()[:16]
    log(f"{label}: B4 kernel alone {k_ms:.4f} ms; launch plan {c_n} CTAs "
        f"a tile x {threads} threads x {ppt} pixels, tiles heaviest first; "
        f"out4 sha1 {digest}")
    log(f"{label}: work per block: {work}")
    log(f"{label}: {floors('B4', pairs, heaviest // c_n, threads)}")
    return k_ms


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
    k_ms = b4_report(bidir, settings, attrs, lists, counts, out_k, pairs,
                     "kernel phase (synthetic 1080p)")
    return err, k_ms


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
    out_k = bidir.bidir_out4_cuda(dec.settings, a, l, c)
    k_ms = b4_report(bidir, dec.settings, a, l, c, out_k, pairs,
                     f"slice phase (frame {ids[N_FRAMES // 2]})")
    return dict(launches=launches, max_abs_err=max_err, ms=ms,
                kernel_ms=k_ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by), dec


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
    of the entropy phases), the composite's forward marks (b1_start,
    b1_end at tile-aligned widths, b6f_start, b6f_end with the stream
    rasterizer; b5f_start, b5f_end at others), loss_end, the composite's
    backward marks (b2_start, b2_end, b6b_start, b6b_end or b5b_start,
    b5b_end), b3b_start, b3b_end, backward_end, adam_end; and
    the hash-grid kernels' launch counts at start and adam_end."""

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
        """Per step: {phase: ms}; the composite's columns are B1 and
        B2+scatter at tile-aligned widths (B6f and B6b+scatter with the
        stream rasterizer), B5f and B5b at others (where the gather's
        transpose falls in the rest of the backward)."""
        torch.cuda.synchronize()
        rows = []
        for e in self.steps:
            def ms(a, b, e=e):
                return e[a].elapsed_time(e[b]) if a in e else 0.0
            f, b, fname, bname = (
                ("b1", "b2", "B1", "B2+scatter") if "b1_start" in e
                else ("b6f", "b6b", "B6f", "B6b+scatter")
                if "b6f_start" in e else ("b5f", "b5b", "B5f", "B5b"))
            bwd = ms(f"{b}_start", f"{b}_end")
            b3f = ms("b3f_start", "b3f_end")
            b3b = ms("b3b_start", "b3b_end")
            rows.append({
                "step": ms("start", "adam_end"),
                "B3f": b3f,
                "generation+projection+binning": ms("start", f"{f}_start")
                - b3f,
                fname: ms(f"{f}_start", f"{f}_end"),
                "loss": ms(f"{f}_end", "loss_end"),
                bname: bwd,
                "B3b": b3b,
                "rest of backward": ms("loss_end", "backward_end") - bwd
                - b3b,
                "Adam+stats": ms("backward_end", "adam_end"),
            })
        return rows


def phase_of(it: int, phases=PHASES) -> str:
    """The schedule phase of iteration ``it`` (1-based)."""
    end = 0
    for name, n in phases:
        end += n
        if it <= end:
            return name
    return "STE_ENTROPY"


def pair_views(fitter, i1: int, flips=(False,)):
    """The projected views of the frame pair (i1, i1 + 1) of the fitted
    state, as render_pair builds them (FULL_PRECISION): per frame one view
    for the mirror and stream composites (``flips`` (False,)), or the
    forward and flip views each projected on its own for the single-view
    composite ((False, True)).  Returns [(projection, attribute rows)]."""
    from gsvc_tpu_torch.models.gaussians import (
        GenerateMode, generate_neural_gaussians, window_for_frame,
    )
    from gsvc_tpu_torch.render.splat import (
        attr_rows_from_proj, project_gaussians,
    )

    d, st, s = fitter.dataset, fitter.state, fitter.settings
    views = []
    with torch.no_grad():
        for i in (i1, i1 + 1):
            z = float(fitter.frame_zs[i])
            start, in_window = window_for_frame(st, fitter.gcfg, z,
                                                fitter.window_cap)
            gss = generate_neural_gaussians(
                st, fitter.gcfg, z, z, start, in_window, fitter.window_cap,
                mode=GenerateMode.FULL_PRECISION, decoded=False)
            for flip in flips:
                proj = project_gaussians(gss.xyz, gss.scaling, gss.rot,
                                         gss.valid, z, d.x_min, d.y_min,
                                         d.scale, s, flip=flip)
                op = torch.where(proj.valid[:, None], gss.opacity,
                                 torch.zeros_like(gss.opacity))
                views.append((proj, attr_rows_from_proj(proj, op,
                                                        gss.color)))
    return views


def training_pair_inputs(fitter, i1: int, flips=(False,), settings=None):
    """The tile composites' inputs for the frame pair (i1, i1 + 1) of the
    fitted state (``pair_views``), binned with ``settings`` (default the
    fitter's).  Returns (attrs [V, M, 9], lists [V, T, cap], counts
    [V, T])."""
    from gsvc_tpu_torch.render.splat import _bin_gaussians

    s = settings or fitter.settings
    views = pair_views(fitter, i1, flips)
    lists, counts = zip(*(_bin_gaussians(p, s)[:2] for p, _ in views))
    return (torch.stack([a for _, a in views]).contiguous(),
            torch.stack(lists), torch.stack(counts))


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
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    report = fitter.fit(iterations=TRAIN_STEPS, log_every=1,
                        eval_every=EVAL_EVERY, rate_log_every=TRAIN_STEPS,
                        checkpoint_iterations=(TRAIN_STEPS,),
                        checkpoint_dir=ckpt_dir)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    FIT_PEAK["bytes"] = torch.cuda.max_memory_allocated()
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
    return b1, b2, launches[2:], fitter, frames


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


def corner_rows(spec, x):
    """(rows int64 [N, C], valid bool [N, C]) of every level-instance, in
    the kernels' order: the corner rows of ``_level_indices``, valid where
    every coordinate of the corner lies in (0, res - 1) (the corners that
    B3b adds to; a border corner weighs 0 and is skipped)."""
    from gsvc_tpu_torch.ops.hashgrid import _level_indices

    s = spec.param_splits()
    for base, grid, cols in ((s[0], spec.grid_3d, [0, 1, 2]),
                             (s[1], spec.grid_2d, [0, 1]),
                             (s[2], spec.grid_2d, [0, 2]),
                             (s[3], spec.grid_2d, [1, 2])):
        xs = x[:, cols]
        for lvl in range(grid.n_levels):
            res = grid.resolutions[lvl]
            idx, _ = _level_indices(xs, res, grid.level_sizes[lvl],
                                    grid.level_offsets[lvl], grid.num_dim)
            pg = torch.floor(xs * float(res - 2) + 0.5).to(torch.int64)
            valid = []
            for c in range(1 << grid.num_dim):
                ok = torch.ones_like(pg[:, 0], dtype=torch.bool)
                for d in range(grid.num_dim):
                    coord = (torch.clamp(pg[:, d] + 1, max=res - 1)
                             if (c >> d) & 1 else pg[:, d])
                    ok = ok & (coord > 0) & (coord < res - 1)
                valid.append(ok)
            yield idx + base, torch.stack(valid, 1)


def hash_atomics(spec, x) -> dict:
    """B3b's global atomic operations on ``x``, reckoned from the inputs
    (``corner_rows``): one float4 add per 4 features (F scalar adds when
    F is 2) of every valid corner of every (query, instance), in the
    kernel's design as in the previous one (a thread a (query,
    instance)); and what combining the adds that fall on one row inside a
    block of 32 or 256 z-consecutive queries would leave."""
    f = spec.n_features
    per = f // 4 if f % 4 == 0 else f
    n, blocks = 0, {32: 0, 256: 0}
    q = torch.arange(x.shape[0], device=x.device)[:, None]
    for rows, valid in corner_rows(spec, x):
        n += int(valid.sum())
        for b in blocks:
            key = (q // b).expand_as(rows)[valid] * spec.total_rows \
                + rows[valid]
            blocks[b] += int(torch.unique(key).numel())
    return {"per valid corner (this design and the previous one)": n * per,
            **{f"combined per row in blocks of {b} queries": u * per
               for b, u in blocks.items()}}


def hashgrid_check(hk, spec, table, x, label):
    """B3f/B3b against their plain versions on one input, timed."""
    out_k = hk.hashgrid_fwd_cuda(table, x, spec)
    out_p = hk.hashgrid_fwd_plain(table, x, spec)
    torch.cuda.synchronize()
    f_err = float((out_k - out_p).abs().max())
    if not torch.equal(out_k, out_p):
        raise AssertionError(f"{label}: B3f differs from its plain version "
                             f"(max |kernel - plain| {f_err}); both round "
                             f"alike and must agree bit for bit")
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

    def fwd():
        return hk.hashgrid_fwd_cuda(table, x, spec)

    def bwd():
        return hk.hashgrid_bwd_cuda(table, x, g, spec)

    # the kernel alone (CUPTI's kernel durations), everything the call
    # runs on the card, the call back to back (CUDA events) and the host
    # time of one call
    f_kernel, f_device = kernel_ms(fwd, "hashgrid_fwd_kernel", 20)
    b_kernel, b_device = kernel_ms(bwd, "hashgrid_bwd_kernel", 20)
    f_call, b_call = cuda_ms(fwd, 20), cuda_ms(bwd, 20)
    f_host, b_host = host_ms(fwd, 50), host_ms(bwd, 50)
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
    atomics = hash_atomics(spec, x)
    log(f"{label}: N={n} queries x {hk.instance_table(spec).shape[0]} "
        f"instances, {rows} of {spec.total_rows} table rows needed "
        f"({row_bytes / 1e6:.2f} MB); B3f equals its plain version bit "
        f"for bit, B3b max |kernel - plain| "
        f"{b_abs:.3e} = {b_rel:.3e} of the largest gradient (limit "
        f"{HASH_BWD_REL_ERR:.0e})")
    for name, kern, dev, call, host, plain, bnd in (
            ("B3f", f_kernel, f_device, f_call, f_host, f_plain, fb),
            ("B3b", b_kernel, b_device, b_call, b_host, b_plain, bb)):
        log(f"{label}: {name} kernel {kern:.4f} ms (torch.profiler, CUPTI "
            f"kernel durations over 20 calls), {kern / bnd[0]:.2f}x its "
            f"bound {bnd[0]:.4f} ms ({bnd[1]}); all device work of the "
            f"call {dev:.4f} ms; call {call:.4f} ms (CUDA events, 20 calls "
            f"back to back); host {host:.4f} ms a call; plain {plain:.3f} ms")
    log(f"{label}: B3b global atomics " + ", ".join(
        f"{k} {v}" for k, v in atomics.items()))
    return (dict(ms=f_call, kernel_ms=f_kernel, host_ms=f_host,
                 plain_ms=f_plain, bound_ms=fb[0], bound_by=fb[1],
                 max_abs_err=f_err),
            dict(ms=b_call, kernel_ms=b_kernel, host_ms=b_host,
                 plain_ms=b_plain, bound_ms=bb[0], bound_by=bb[1],
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


def view_planes(attrs, lists, counts):
    """The single-view composite's inputs for V views: planes 9 x [V*T,
    cap] gathered from each view's attribute rows and lists, counts
    [V*T]."""
    from gsvc_tpu_torch.render.splat import gather_tile_planes_rows

    views = [gather_tile_planes_rows(attrs[v], lists[v])
             for v in range(attrs.shape[0])]
    return (tuple(torch.cat([p[i] for p in views]).contiguous()
                  for i in range(9)), counts.reshape(-1).contiguous())


def b5f_digest(out4, t_chk) -> str:
    """SHA-256 of B5f's out4 and t_chk bits (to hold two trees' kernels
    to each other), 16 hex digits each."""
    import hashlib

    return " ".join(f"{name} sha256 "
                    + hashlib.sha256(t.cpu().numpy().tobytes())
                    .hexdigest()[:16]
                    for name, t in (("out4", out4), ("t_chk", t_chk)))


def tile_check(tile, settings, attrs, lists, counts, label):
    """B5f (with and without checkpoints) and B5b against their plain
    versions on V views' planes, and the plane gradients of both pushed
    through the gather's transpose to per-gaussian rows, with and without
    per-view means2d; then both kernels and plain versions timed against
    their bounds, each kernel alone too, with their work per block, issue
    floors and B5f's output digest.  Returns (B5f numbers, B5b numbers)."""
    from gsvc_tpu_torch.render.splat import gather_tile_planes_rows

    planes, cnt = view_planes(attrs, lists, counts)
    out_k, chk_k = tile.tile_fwd_cuda(settings, planes, cnt)
    inf_k, _ = tile.tile_fwd_cuda(settings, planes, cnt, save_tchk=False)
    out_p, chk_p, pairs_f = tile.tile_fwd_plain(settings, planes, cnt)
    torch.cuda.synchronize()
    fwd_err = max(float((out_k - out_p).abs().max()),
                  float((chk_k - chk_p).abs().max()),
                  float((inf_k - out_p).abs().max()))
    if not np.isfinite(fwd_err) or fwd_err > MAX_ABS_ERR:
        raise AssertionError(f"{label}: B5f disagrees with its plain "
                             f"version: {fwd_err} > {MAX_ABS_ERR}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(29)
    g_out = torch.randn(out_p.shape, generator=gen, device="cuda")
    # both versions replay from the same checkpoints: the same chunk stops
    gr_k = tile.tile_bwd_cuda(settings, planes, cnt, out_p, chk_p, g_out)
    gr_k2 = tile.tile_bwd_cuda(settings, planes, cnt, out_p, chk_p, g_out)
    gr_p, pairs_b = tile.tile_bwd_plain(settings, planes, cnt, chk_p, g_out)
    torch.cuda.synchronize()
    if not torch.isfinite(gr_k).all():
        raise AssertionError(f"{label}: B5b gave non-finite gradients")
    if not torch.equal(gr_k, gr_k2):
        raise AssertionError(f"{label}: two B5b launches on the same inputs "
                             f"gave different per-slot rows")
    bwd_err = bwd_rel_err(gr_k, gr_p, 1)
    bwd_abs = float((gr_k - gr_p).abs().max())
    v_n, m = attrs.shape[0], attrs.shape[1]
    for with_m2d in (False, True):
        a = attrs.clone().requires_grad_(True)
        ins = [a]
        rows = a
        if with_m2d:
            m2d = torch.zeros((v_n, m, 2), device="cuda", requires_grad=True)
            ins.append(m2d)
            rows = torch.cat([a[..., :2] + m2d, a[..., 2:]], dim=-1)
        views = [gather_tile_planes_rows(rows[v], lists[v])
                 for v in range(v_n)]
        pl = tuple(torch.cat([p[i] for p in views]) for i in range(9))
        got = torch.autograd.grad(pl, ins, grad_outputs=gr_k.unbind(1),
                                  retain_graph=True)
        want = torch.autograd.grad(pl, ins, grad_outputs=gr_p.unbind(1))
        bwd_err = max(bwd_err, bwd_rel_err(got[0], want[0], -1))
        bwd_abs = max(bwd_abs, float((got[0] - want[0]).abs().max()))
        if with_m2d:
            bwd_err = max(bwd_err, bwd_rel_err(got[1], want[1], -1))
            bwd_abs = max(bwd_abs, float((got[1] - want[1]).abs().max()))
    if not np.isfinite(bwd_err) or bwd_err > BWD_REL_ERR:
        raise AssertionError(f"{label}: B5b disagrees with its plain "
                             f"version: {bwd_err} > {BWD_REL_ERR} of the "
                             f"largest gradient")
    f_ms = cuda_ms(lambda: tile.tile_fwd_cuda(settings, planes, cnt), 10)
    f_kernel, _ = kernel_ms(lambda: tile.tile_fwd_cuda(
        settings, planes, cnt), "tile_fwd_kernel", 10)
    b_ms = cuda_ms(lambda: tile.tile_bwd_cuda(settings, planes, cnt, out_p,
                                              chk_p, g_out), 5)
    b_kernel, _ = kernel_ms(lambda: tile.tile_bwd_cuda(
        settings, planes, cnt, out_p, chk_p, g_out), "tile_bwd_kernel", 5)
    f_plain = cuda_ms(lambda: tile.tile_fwd_plain(settings, planes, cnt), 1)
    b_plain = cuda_ms(lambda: tile.tile_bwd_plain(settings, planes, cnt,
                                                  chk_p, g_out), 1)
    fb = bound_ms(nbytes(*planes, cnt, out_p, chk_p),
                  pairs_f * FLOPS_PER_PAIR)
    bb = bound_ms(nbytes(*planes, cnt, chk_p, g_out, gr_p),
                  pairs_b * FLOPS_PER_BWD_PAIR)
    log(f"{label}: {cnt.numel()} rows ({v_n} views), {int(cnt.sum())} "
        f"copies, {int((cnt == 0).sum())} empty rows; B5f max |kernel - "
        f"plain| {fwd_err:.3e} (limit {MAX_ABS_ERR:.0e}; out, t_chk and the "
        f"checkpoint-free launch), kernel {f_ms:.4f} ms, alone "
        f"{f_kernel:.4f} ms, plain {f_plain:.3f} ms, bound {fb[0]:.4f} ms "
        f"({fb[1]}; {pairs_f} pairs); B5b max |kernel - plain| / max "
        f"|plain| {bwd_err:.3e} (limit {BWD_REL_ERR:.0e}; max |kernel - "
        f"plain| {bwd_abs:.3e}; per-slot rows and the gather's transpose "
        f"with and without means2d; two launches bit-identical), kernel "
        f"{b_ms:.4f} ms, "
        f"alone {b_kernel:.4f} ms, plain {b_plain:.3f} ms, bound "
        f"{bb[0]:.4f} ms ({bb[1]}; {pairs_b} pairs)")
    work, heaviest = tile_work(settings, cnt, chk_p, pairs_b)
    threads, ppt = tile.launch_shape(settings)
    log(f"{label}: B5f/B5b launch {threads} threads x {ppt} pixels; work "
        f"per block: {work}")
    log(f"{label}: B5f {floors('B5f', pairs_f, heaviest, threads)}")
    log(f"{label}: B5b {floors('B5b', pairs_b, heaviest, threads)}")
    log(f"{label}: B5f {b5f_digest(out_k, chk_k)}")
    return (dict(ms=f_ms, kernel_ms=f_kernel, plain_ms=f_plain,
                 bound_ms=fb[0], bound_by=fb[1], max_abs_err=fwd_err),
            dict(ms=b_ms, kernel_ms=b_kernel, plain_ms=b_plain,
                 bound_ms=bb[0], bound_by=bb[1], max_abs_err=bwd_abs))


def tile_kernel_phase(tile, mirror, settings):
    """B5f/B5b against their plain versions at the 1080p training shapes:
    V = 4 views of synthetic tiles; at this aligned width B5f's out4 and
    t_chk must equal B1's forward-view rows on the same 4 frames bit for
    bit (the same column alpha, running products and stops)."""
    label = "tile-kernel phase (B5f/B5b, synthetic 1080p)"
    attrs, lists, counts = synthetic_frames(settings, seed=3, n_frames=4,
                                            device="cuda")
    res = tile_check(tile, settings, attrs, lists, counts, label)
    planes, cnt = view_planes(attrs, lists, counts)
    out_5, chk_5 = tile.tile_fwd_cuda(settings, planes, cnt)
    out_1, chk_1 = mirror.mirror_fwd_cuda(settings, attrs, lists, counts)
    torch.cuda.synchronize()
    t_n = settings.n_tiles
    fwd = (torch.arange(out_1.shape[0], device="cuda") // t_n) % 2 == 0
    vs_b1 = max(float((out_5 - out_1[fwd]).abs().max()),
                float((chk_5 - chk_1[fwd]).abs().max()))
    log(f"{label}: max |B5f - B1 forward view| {vs_b1:.3e} over out4 and "
        f"t_chk (bit for bit)")
    if not (torch.equal(out_5, out_1[fwd]) and torch.equal(chk_5,
                                                            chk_1[fwd])):
        raise AssertionError(f"{label}: B5f's out4 and t_chk differ from "
                             f"B1's forward view: {vs_b1}")
    return res


def codec_phase(fitter, bidir, mirror, tile, hk):
    """The encode half and the decode on the training phase's fitted
    state: conduct_encoding -> save_streams -> load_streams ->
    conduct_decoding -> evaluate_video over every frame through B4, with
    the exactness checks of the round trip.  Returns B4's launches."""
    import dataclasses

    from gsvc_tpu_torch.codec.bitstream import (
        conduct_decoding, conduct_encoding, load_streams,
    )
    from gsvc_tpu_torch.codec.estimate import estimate_final_bits
    from gsvc_tpu_torch.models.gaussians import (
        GenerateMode, get_mask, get_mask_anchor,
    )
    from gsvc_tpu_torch.ops.quant import quantize_anchor_indices, ste_binary
    from gsvc_tpu_torch.report import bits_per_pixel, evaluate_video
    from gsvc_tpu_torch.utils.checkpoint import save_streams

    d, st = fitter.dataset, fitter.state
    est = estimate_final_bits(st, fitter.gcfg)
    psnr_ste = fitter.evaluate(mode=GenerateMode.STE_ENTROPY)["psnr"]
    counters = (bidir.bidir_composite_attrs, mirror.mirror_forward,
                mirror.mirror_backward, tile.tile_forward,
                tile.tile_backward, hk.hashgrid_forward,
                hk.hashgrid_backward)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streams, meta, bits, enc_state, enc_s = conduct_encoding(
        st, fitter.gcfg, model_config=dataclasses.asdict(fitter.cfg.model),
        video_info={"width": d.width, "height": d.height,
                    "num_frames": d.num_frames})
    out_dir = tempfile.mkdtemp(prefix="gsvc_smoke_bs_")
    total = save_streams(out_dir, streams)
    streams = load_streams(out_dir)
    dec, _, dec_s = conduct_decoding(streams, fitter.gcfg, enc_state,
                                     capacity=fitter.capacity, device="cuda")
    ev = evaluate_video(dec, fitter.gcfg, fitter.settings, fitter.window_cap,
                        fitter.frame_zs, d.x_min, d.y_min, d.scale,
                        gt_images=d.images, mode=GenerateMode.DECODED,
                        decoded=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = tuple(c.launches for c in counters)
    bpp = bits_per_pixel(total * 8, d.width, d.height, d.num_frames)
    log(f"codec phase: {meta.anchor_num} of {st.n_active} anchors coded; "
        f"encode {enc_s:.3f} s, decode {dec_s:.3f} s, {total / 2 ** 20:.4f}"
        f" MB ({total} bytes, {len(streams)} files), {bpp:.6f} bpp; "
        f"estimate {est.total / 8 / 2 ** 20:.4f} MB; decoded PSNR "
        f"{ev['psnr']:.4f} dB over {ev['num_frames']} frames (the fitter's "
        f"STE eval of the state before the encode {psnr_ste:.4f} dB), "
        f"{ev['fps']:.2f} decode fps; {wall:.2f} s wall; launches B4, B1, "
        f"B2, B5f, B5b, B3f, B3b {launches}")
    n_frames = len(fitter.frame_zs)
    if launches != (n_frames, 0, 0, 0, 0, 0, 0):
        raise AssertionError(f"codec phase launches {launches}: expected "
                             f"B4 once per frame ({n_frames}) and nothing "
                             f"else")
    if not (bpp > 0 and np.isfinite(ev["psnr"])):
        raise AssertionError(f"codec phase: bpp {bpp}, PSNR {ev['psnr']}")
    # exactness: hash signs, mask counts, anchors
    want_hash = ste_binary(enc_state.nets.hash_table)
    if not torch.equal(dec.nets.hash_table, want_hash):
        raise AssertionError("decoded hash signs differ from the "
                             "STE-binarised table")
    n = meta.anchor_num
    keep = get_mask_anchor(st.anchors).clone()
    keep[st.n_active:] = False
    want_masks = int(get_mask(st.anchors)[keep].sum())
    got_masks = int(dec.anchors.mask[:n].sum())
    if got_masks != want_masks:
        raise AssertionError(f"decoded masks {got_masks} != encoded "
                             f"{want_masks}")
    q, interval, lo = (t.numpy() for t in quantize_anchor_indices(
        st.anchors.anchor.cpu(), st.x_bound_min.cpu(),
        st.x_bound_max.cpu()))
    want_a = (q.astype(np.float32) * interval + lo).astype(np.float32)[
        keep.cpu().numpy()]
    got_a = dec.anchors.anchor[:n].cpu().numpy()

    def rows_sorted(a):
        return a[np.lexsort(a.T[::-1])]

    if got_a.shape != want_a.shape or not np.array_equal(
            rows_sorted(got_a), rows_sorted(want_a)):
        raise AssertionError("decoded anchors differ from the encoder's "
                             "quantized anchors")
    log(f"codec phase: exact: hash signs ({want_hash.numel()}), masks "
        f"({got_masks} of {n * fitter.gcfg.n_offsets}), anchors ({n})")
    return dict(encode_s=enc_s, decode_s=dec_s, mb=total / 2 ** 20,
                bpp=bpp, est_mb=est.total / 8 / 2 ** 20,
                psnr=ev["psnr"], psnr_ste=psnr_ste, launches=launches[0])


# the stream rasterizer (B6f/B6b) over the compacted copy stream
STREAM_SET = {"pipeline.rasterizer": "pallas_stream",
              "pipeline.copy_budget_factor": 8}


def stream_bounds(settings, bins, pairs_f, pairs_b):
    """(B6f bound, B6b bound) on one stream: the live slots' nine rows and
    the block counts read once; out4, the live blocks' checkpoints and
    (backward) the live slots' two views' gradients written once; g_out,
    out4's T row and the checkpoints read once; 25 / 49 FLOP per
    evaluated (copy, pixel, view)."""
    p_pix = settings.tile_h * settings.tile_w
    live_slots = int((bins[0] >= 0).sum())
    live_blocks = int((bins[1] >= 0).sum())
    n_out = 2 * bins[3].numel()
    rows = live_slots * 9 * 4 + nbytes(bins[3])
    out4 = n_out * 4 * p_pix * 4
    chk = 2 * live_blocks * p_pix * 4
    fwd = bound_ms(rows + out4 + chk, pairs_f * FLOPS_PER_PAIR)
    bwd = bound_ms(rows + n_out * p_pix * 4 + out4 + chk
                   + 2 * live_slots * 9 * 4, pairs_b * FLOPS_PER_BWD_PAIR)
    return fwd, bwd


def padding_share(settings, bins):
    """(live slots, live blocks, padding share): the share of the live
    blocks' slots that hold no copy, 1 - live slots / (live blocks x
    chunk) — the slots a walk over every slot of a tile's blocks spends
    on padding."""
    live_slots = int((bins[0] >= 0).sum())
    live_blocks = int((bins[1] >= 0).sum())
    return (live_slots, live_blocks,
            1.0 - live_slots / max(live_blocks * settings.chunk, 1))


def stream_check(stream, mirror, settings, attrs, bins, lists, counts,
                 label):
    """(a) B6f (with and without checkpoints) and B6b against their plain
    versions on one stream, and the scatter with and without per-view
    means2d; (b) B6f against B1 (bit for bit) and B6b (scattered) against
    B2 (scattered) on the same copies, kernel to kernel.  Returns the
    errors, the evaluated pairs and the plain version's outputs for
    timing."""
    sids, m = bins[0], attrs.shape[1]
    rows = stream.stream_rows(attrs, sids)
    out_k, chk_k = stream.stream_fwd_cuda(settings, rows, *bins)
    inf_k, _ = stream.stream_fwd_cuda(settings, rows, *bins,
                                      save_tchk=False)
    out_p, chk_p, pairs_f = stream.stream_fwd_plain(settings, rows, *bins)
    torch.cuda.synchronize()
    fwd_err = max(float((out_k - out_p).abs().max()),
                  float((chk_k - chk_p).abs().max()),
                  float((inf_k - out_p).abs().max()))
    if not np.isfinite(fwd_err) or fwd_err > MAX_ABS_ERR:
        raise AssertionError(f"{label}: B6f disagrees with its plain "
                             f"version: {fwd_err} > {MAX_ABS_ERR}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(31)
    g_out = torch.randn(out_p.shape, generator=gen, device="cuda")
    gr_k = stream.stream_bwd_cuda(settings, rows, *bins, out_p, chk_p,
                                  g_out)
    gr_p, pairs_b = stream.stream_bwd_plain(settings, rows, *bins, out_p,
                                            chk_p, g_out)
    torch.cuda.synchronize()
    if not torch.isfinite(gr_k).all():
        raise AssertionError(f"{label}: B6b gave non-finite gradients")
    bwd_err = bwd_rel_err(gr_k, gr_p, 1)
    bwd_abs = float((gr_k - gr_p).abs().max())
    for per_view in (False, True):
        da_k, dm_k = stream.scatter_stream_grads(gr_k, sids, m, per_view)
        da_p, dm_p = stream.scatter_stream_grads(gr_p, sids, m, per_view)
        bwd_err = max(bwd_err, bwd_rel_err(da_k, da_p, -1))
        bwd_abs = max(bwd_abs, float((da_k - da_p).abs().max()))
        if per_view:
            diff = float((dm_k - dm_p).abs().max())
            bwd_err = max(bwd_err, diff / max(float(dm_p.abs().max()),
                                              1e-30))
            bwd_abs = max(bwd_abs, diff)
    if not np.isfinite(bwd_err) or bwd_err > BWD_REL_ERR:
        raise AssertionError(f"{label}: B6b disagrees with its plain "
                             f"version: {bwd_err} > {BWD_REL_ERR} of the "
                             f"largest gradient")
    # (b) the stream kernels against the mirror kernels, each pair on its
    # own forward's checkpoints, both backwards scattered to the gaussians
    out_1, chk_1 = mirror.mirror_fwd_cuda(settings, attrs, lists, counts)
    gr_2 = mirror.mirror_bwd_cuda(settings, attrs, lists, counts, out_1,
                                  chk_1, g_out)
    gr_6 = stream.stream_bwd_cuda(settings, rows, *bins, out_k, chk_k,
                                  g_out)
    torch.cuda.synchronize()
    vs_b1 = float((out_k - out_1).abs().max())
    da_2, dm_2 = mirror.scatter_grads(settings, gr_2, lists, m, True)
    da_6, dm_6 = stream.scatter_stream_grads(gr_6, sids, m, True)
    vs_b2 = max(bwd_rel_err(da_6, da_2, -1),
                float((dm_6 - dm_2).abs().max())
                / max(float(dm_2.abs().max()), 1e-30))
    # B6f composites B1's copies with B1's column alpha, running products
    # and stops, and ends a block where B1's zero-alpha padding begins
    if not (torch.equal(out_k, out_1) and vs_b2 <= BWD_REL_ERR):
        raise AssertionError(f"{label}: the stream kernels disagree with "
                             f"B1/B2: out {vs_b1} (B6f must equal B1 bit "
                             f"for bit), gradients {vs_b2} of the largest "
                             f"(limit {BWD_REL_ERR})")
    live_slots, live_blocks, pad = padding_share(settings, bins)
    log(f"{label}: {live_slots} live slots in {live_blocks} live blocks of "
        f"{bins[1].numel()} ({int((bins[3] == 1).sum())} tiles of one "
        f"block; padding share {pad:.4f}); B6f max |kernel - plain| "
        f"{fwd_err:.3e} "
        f"(limit {MAX_ABS_ERR:.0e}; out, t_chk and the checkpoint-free "
        f"launch); B6b max |kernel - plain| / max |plain| {bwd_err:.3e} "
        f"(limit {BWD_REL_ERR:.0e}; max |kernel - plain| {bwd_abs:.3e}; "
        f"per-slot rows and the scatter with and without means2d); "
        f"against B1 max |B6f - B1| {vs_b1:.3e} (bit for bit), against B2 "
        f"(scattered, with means2d) {vs_b2:.3e} of the largest gradient")
    return dict(fwd_err=fwd_err, bwd_abs=bwd_abs, pairs_f=pairs_f,
                pairs_b=pairs_b, vs_b1=vs_b1, vs_b2=vs_b2,
                aux=(rows, out_p, chk_p, g_out))


def stream_times(stream, mirror, settings, attrs, bins, lists, counts, chk,
                 label):
    """Times of B6f and B6b on one stream against their bounds and their
    plain versions, and of B1/B2 on the same copies: each kernel alone
    (CUPTI through ``torch.profiler``, ``kernel_ms``) and the wrapper's
    call back to back (CUDA events), each B6 call timed in turns with its
    B1/B2 counterpart (B6, B1/B2, B1/B2, B6)."""
    rows, out_p, chk_p, g_out = chk["aux"]
    out_1, chk_1 = mirror.mirror_fwd_cuda(settings, attrs, lists, counts)

    def b6f():
        return stream.stream_fwd_cuda(settings, rows, *bins)

    def b6b():
        return stream.stream_bwd_cuda(settings, rows, *bins, out_p, chk_p,
                                      g_out)

    def b1():
        return mirror.mirror_fwd_cuda(settings, attrs, lists, counts)

    def b2():
        return mirror.mirror_bwd_cuda(settings, attrs, lists, counts, out_1,
                                      chk_1, g_out)

    f_ms, b1_ms = paired_ms(b6f, b1, 10)
    b_ms, b2_ms = paired_ms(b6b, b2, 5)
    f_alone, _ = kernel_ms(b6f, "stream_fwd_kernel", 10)
    b1_alone, _ = kernel_ms(b1, "mirror_fwd_kernel", 10)
    b_alone, _ = kernel_ms(b6b, "stream_bwd_kernel", 5)
    b2_alone, _ = kernel_ms(b2, "mirror_bwd_kernel", 5)
    f_plain = cuda_ms(lambda: stream.stream_fwd_plain(settings, rows,
                                                      *bins), 1)
    b_plain = cuda_ms(lambda: stream.stream_bwd_plain(
        settings, rows, *bins, out_p, chk_p, g_out), 1)
    fb, bb = stream_bounds(settings, bins, chk["pairs_f"], chk["pairs_b"])
    pad = padding_share(settings, bins)[2]
    log(f"{label}: B6f alone {f_alone:.4f} ms (B1 {b1_alone:.4f}, B6f/B1 "
        f"{f_alone / b1_alone:.3f}), call {f_ms:.4f} ms (B1 {b1_ms:.4f}, "
        f"B1/B6f {b1_ms / f_ms:.3f}), plain {f_plain:.3f} ms, bound "
        f"{fb[0]:.4f} ms ({fb[1]}; {chk['pairs_f']} pairs); B6b alone "
        f"{b_alone:.4f} ms (B2 {b2_alone:.4f}, B6b/B2 "
        f"{b_alone / b2_alone:.3f}), call {b_ms:.4f} ms (B2 {b2_ms:.4f}, "
        f"B2/B6b {b2_ms / b_ms:.3f}), plain {b_plain:.3f} ms, bound "
        f"{bb[0]:.4f} ms ({bb[1]}; {chk['pairs_b']} pairs); padding share "
        f"{pad:.4f}")
    threads = stream.launch_shape(settings)[0]
    log(f"{label}: B6f {floors('B6f', chk['pairs_f'], None, threads)}; "
        f"B6b {floors('B6b', chk['pairs_b'], None, threads)}")
    return (dict(ms=f_ms, kernel_ms=f_alone, plain_ms=f_plain,
                 bound_ms=fb[0], bound_by=fb[1], b1_ms=b1_ms),
            dict(ms=b_ms, kernel_ms=b_alone, plain_ms=b_plain,
                 bound_ms=bb[0], bound_by=bb[1], b2_ms=b2_ms))


def stream_kernel_phase(stream, mirror, fitter):
    """B6f/B6b against their plain versions and against B1/B2: on the
    synthetic 1080p tiles of the mirror-kernel phase (as a stream), and on
    the fitted state's pair 299-300 with copy_budget_factor 0 and 8,
    each timed.  Returns (B6f numbers, B6b numbers) on the factor-8
    pair (the last)."""
    import dataclasses

    from gsvc_tpu_torch.render.splat import (
        _bin_gaussians, _sorted_copy_stream, bin_gaussians_stream,
        stream_blocks_max,
    )

    s0 = fitter.settings
    attrs, lists, counts = synthetic_frames(s0, seed=1, n_frames=2,
                                            device="cuda")
    bins = stream.stream_from_tile_lists(
        s0, lists, counts, stream_blocks_max(s0, attrs.shape[1]))
    syn = stream_check(stream, mirror, s0, attrs, bins, lists, counts,
                       "stream phase (B6f/B6b, synthetic 1080p)")
    stream_times(stream, mirror, s0, attrs, bins, lists, counts, syn,
                 "stream phase (B6f/B6b, synthetic 1080p)")
    del attrs, lists, counts, bins, syn
    errs = []
    for factor in (0, 8):
        s = dataclasses.replace(s0, copy_budget_factor=factor)
        views = pair_views(fitter, 299)
        attrs = torch.stack([a for _, a in views]).contiguous()
        lists, counts = (torch.stack(x) for x in zip(
            *(_bin_gaussians(p, s)[:2] for p, _ in views)))
        sbs = [bin_gaussians_stream(p, s) for p, _ in views]
        bins = stream.concat_stream_bins(sbs, s)
        label = (f"stream phase (frames 299-300, copy_budget_factor "
                 f"{factor})")
        budget = sum(int(_sorted_copy_stream(p, s)[3]) for p, _ in views)
        log(f"{label}: B_MAX {bins[1].numel() // 2} blocks per frame, "
            f"overflow {sum(int(sb.overflow) for sb in sbs)} of which "
            f"budget_dropped {budget}")
        chk = stream_check(stream, mirror, s, attrs, bins, lists, counts,
                           label)
        errs.append(chk)
        b6f, b6b = stream_times(stream, mirror, s, attrs, bins, lists,
                                counts, chk, label)
    b6f["max_abs_err"] = max(c["fwd_err"] for c in errs)
    b6b["max_abs_err"] = max(c["bwd_abs"] for c in errs)
    return b6f, b6b


def stream_cli_phase(ckpt, frames, want_psnr, counters):
    """``gsvc_tpu_torch.cli.stream.main`` on the training phase's
    checkpoint with ``--set pipeline.rasterizer=pallas_stream --set
    pipeline.copy_budget_factor=8`` and ``GSVC_RASTERIZER=pallas_stream``:
    the frames come from memory (the CLI's dataset class is given the
    1080p frames) and its evaluation is counted.  Requires z_slices > 1,
    one B6f launch per frame and no other composite, and the decoded PSNR
    within 0.01 dB of the codec phase's B4 evaluation of the same state.
    Returns (the results, B6f launches)."""
    import gsvc_tpu_torch.framecube.frame as frame_mod
    import gsvc_tpu_torch.report as report
    from gsvc_tpu_torch.cli import stream as cli

    names = [n for n, _ in counters]

    def counts():
        return tuple(c.launches for _, c in counters)

    evals = []
    orig = (frame_mod.FrameCubeDataset, report.evaluate_video,
            os.environ.get("GSVC_RASTERIZER"))

    def dataset(*_a, **_k):
        return orig[0](images=frames)

    def evaluate_video(*a, **k):
        c0 = counts()
        r = orig[1](*a, **k)
        evals.append((r["num_frames"], a[2].copy_budget_factor,
                      tuple(b - a_ for a_, b in zip(c0, counts()))))
        return r

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="gsvc_smoke_stream_"))
    argv = ["--model_path", str(tmp / "out"), "--config_path",
            str(FIXTURE_DIR / "cfg_args.yaml"), "--checkpoint", str(ckpt)]
    for k, v in STREAM_SET.items():
        argv += ["--set", f"{k}={v}"]
    frame_mod.FrameCubeDataset, report.evaluate_video = dataset, \
        evaluate_video
    os.environ["GSVC_RASTERIZER"] = "pallas_stream"
    try:
        for _, c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        total = counts()
    finally:
        frame_mod.FrameCubeDataset, report.evaluate_video = orig[:2]
        if orig[2] is None:
            os.environ.pop("GSVC_RASTERIZER")
        else:
            os.environ["GSVC_RASTERIZER"] = orig[2]
    log(f"stream CLI phase: cli.stream.main in {wall:.2f} s wall: results "
        f"{json.dumps(res)}")
    log(f"stream CLI phase: launches {names} in all {total}; per "
        f"evaluation (frames, the evaluating fitter's copy_budget_factor "
        f"after the checkpoint, launches) {evals}; decoded PSNR "
        f"{res['psnr']:.4f} dB against {want_psnr:.4f} dB through B4 (codec "
        f"phase, flat bitstream)")
    n = len(frames)
    want = tuple(n if name == "B6f" else 0 for name in names)
    if len(evals) != 1 or evals[0][0] != n or evals[0][2] != want \
            or total != want:
        raise AssertionError(f"stream CLI launches {total}, per evaluation "
                             f"{evals}: expected B6f once per frame ({n}) "
                             f"and nothing else")
    if not res["z_slices"] > 1:
        raise AssertionError(f"stream CLI: {res['z_slices']} z-slices")
    if not abs(res["psnr"] - want_psnr) <= 0.01:
        raise AssertionError(f"stream CLI: decoded PSNR {res['psnr']} is "
                             f"not within 0.01 dB of B4's {want_psnr}")
    return res, total[names.index("B6f")]


def short_fit_phase(frames, hk, counters, overrides, kernels, label):
    """GOPFitter.fit on the 1080p frames with the fixture's model, the
    narrow phase's 12-step four-phase schedule (densify epochs from step
    4) and ``overrides``: the stream rasterizer with copy_budget_factor 8
    (STREAM_SET), and, for comparison on the same seed and frames, the
    mirror rasterizer.  The launch counts are read per step: the two
    ``kernels`` once each and no other composite.  Returns (their
    launches, the per-phase medians)."""
    from gsvc_tpu_torch.config import load_config
    from gsvc_tpu_torch.framecube.frame import FrameCubeDataset
    from gsvc_tpu_torch.train.fit import GOPFitter

    names = [n for n, _ in counters]

    def counts():
        return tuple(c.launches for _, c in counters)

    cfg = load_config(str(FIXTURE_DIR / "cfg_args.yaml"),
                      overrides={**NARROW_SET, **overrides})
    cfg.pipeline.source_path = cfg.pipeline.optical_path = ""
    cfg.pipeline.model_path = ""
    fitter = GOPFitter(cfg, FrameCubeDataset(images=frames), seed=0,
                       device="cuda", log_fn=lambda m: log(f"  fit: {m}"))
    fitter.timer = StepTimer(hk)
    steps, losses, ovf = [], [], []
    run = fitter._run_single

    def run_single(*a, **k):
        c0 = counts()
        m = run(*a, **k)
        steps.append(tuple(b - a_ for a_, b in zip(c0, counts())))
        losses.append(float(m.loss))
        ovf.append((int(m.overflow), int(m.harmful_overflow),
                    int(m.num_rendered)))
        return m

    fitter._run_single = run_single
    for _, c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fitter.fit(iterations=NARROW_STEPS, log_every=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    total = counts()
    log(f"{label}: {NARROW_STEPS} steps at "
        f"{fitter.settings.image_width}x{fitter.settings.image_height} in "
        f"{wall:.2f} s wall; settings at the end: gaussian_cap "
        f"{fitter.settings.gaussian_cap}, tiles_per_gaussian "
        f"{fitter.settings.tiles_per_gaussian}, copy_budget_factor "
        f"{fitter.settings.copy_budget_factor}; launches {names} in all "
        f"{total}; per step {steps}")
    want = tuple(int(n in kernels) for n in names)
    if len(steps) != NARROW_STEPS or any(c != want for c in steps):
        raise AssertionError(f"{label}: per-step launches {steps}: "
                             f"expected {kernels} once per step and no "
                             f"other composite")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"{label}: losses {losses}")
    log(f"{label}: loss per step " + ", ".join(f"{v:.5f}" for v in losses))
    log(f"{label}: (overflow, harmful, composited copies) per step "
        + ", ".join(str(o) for o in ovf))
    split = fitter.timer.split()
    log(f"{label}: step ms (CUDA events) " + ", ".join(
        f"{r['step']:.2f}" for r in split))
    meds = {}
    for name, _ in NARROW_PHASES:
        rows = [r for it, r in enumerate(split, start=1)
                if phase_of(it, NARROW_PHASES) == name and it > 1]
        meds[name] = {k: float(np.median([r[k] for r in rows]))
                      for k in rows[0]}
        log(f"{label}: {name} median step over {len(rows)} steps: "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in meds[name].items())
            + f" ({1e3 / meds[name]['step']:.3f} it/s at 1920x1080)")
    del fitter
    return tuple(total[names.index(k)] for k in kernels), meds


NARROW = (480, 854)          # DAVIS 2017 480p: 854 = 6.67 x 128
NARROW_PHASES = (("FULL_PRECISION", 4), ("QUANTIZED_NOISE", 2),
                 ("ENTROPY", 3), ("STE_ENTROPY", 3))
NARROW_STEPS = sum(n for _, n in NARROW_PHASES)
NARROW_SET = {"optimization.iterations": NARROW_STEPS,
              "optimization.full_precision_training_total": 4,
              "optimization.quantized_training_total": 2,
              "optimization.entropy_constrained_train_total": 3,
              "optimization.ste_entropy_constrained_train_total": 3,
              "optimization.start_stat": 1,
              "optimization.pause_densification": 1,
              "optimization.update_from": 2,
              "optimization.update_interval": 4,
              "optimization.update_until": NARROW_STEPS}


def narrow_frames(frames, out_dir: pathlib.Path):
    """The 1080p frames resized on the card (bilinear with antialiasing,
    deterministic) to NARROW, written as uint8 PNGs."""
    from PIL import Image

    out_dir.mkdir(parents=True)
    for i0 in range(0, len(frames), 50):
        x = torch.from_numpy(np.ascontiguousarray(frames[i0:i0 + 50])).cuda()
        x = x.permute(0, 3, 1, 2).float()
        y = torch.nn.functional.interpolate(x, size=NARROW, mode="bilinear",
                                            antialias=True,
                                            align_corners=False)
        u8 = torch.round(y.clamp(0, 255)).to(torch.uint8)
        for j, fr in enumerate(u8.permute(0, 2, 3, 1).cpu().numpy()):
            Image.fromarray(fr).save(out_dir / f"f_{i0 + j:04d}.png",
                                     compress_level=1)


def narrow_phase(frames, bidir, mirror, tile, hk):
    """``gsvc_tpu_torch.cli.train.main`` without --skip_codec on the frames
    resized to 854x480 (not a multiple of tile_w 128): the fixture's full
    model with a short four-phase schedule overlaid, then the estimate,
    encode, save, decode and the decoded evaluation.  The launch counts
    are reset just before main and read just after, per step (B5f and B5b
    once each, nothing else of the composites), per evaluation (B5f once
    per frame) and in all.  Then B5f/B5b against their plain versions on
    the fitted state's pair 299-300.  Returns (B5f numbers, B5b numbers,
    the results)."""
    import gsvc_tpu_torch.report as report
    from gsvc_tpu_torch.cli import train as cli
    from gsvc_tpu_torch.config import load_config
    from gsvc_tpu_torch.framecube.frame import FrameCubeDataset
    from gsvc_tpu_torch.train.fit import GOPFitter
    from gsvc_tpu_torch.utils.checkpoint import load_checkpoint

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="gsvc_smoke_narrow_"))
    t0 = time.perf_counter()
    narrow_frames(frames, tmp / "frames")
    log(f"narrow-width phase: {len(frames)} frames resized on the card to "
        f"{NARROW[1]}x{NARROW[0]} PNGs in {time.perf_counter() - t0:.2f} s")

    counters = (tile.tile_forward, tile.tile_backward, mirror.mirror_forward,
                mirror.mirror_backward, bidir.bidir_composite_attrs)

    def counts():
        return tuple(c.launches for c in counters)

    steps, losses, evals, timers = [], [], [], []
    orig = (GOPFitter.__init__, GOPFitter._run_single, GOPFitter.evaluate,
            report.evaluate_video)

    def init(self, *a, **k):
        orig[0](self, *a, **k)
        self.timer = StepTimer(hk)
        timers.append(self.timer)

    def run_single(self, *a, **k):
        c0 = counts()
        m = orig[1](self, *a, **k)
        steps.append(tuple(b - a for a, b in zip(c0, counts())))
        losses.append(float(m.loss))
        return m

    def evaluate(self, *a, **k):
        c0 = counts()
        r = orig[2](self, *a, **k)
        evals.append(("fitter", len(r["per_frame"]),
                      tuple(b - a for a, b in zip(c0, counts()))))
        return r

    def evaluate_video(*a, **k):
        c0 = counts()
        r = orig[3](*a, **k)
        evals.append(("decoded", r["num_frames"],
                      tuple(b - a for a, b in zip(c0, counts()))))
        return r

    argv = ["--source_path", str(tmp / "frames"), "--model_path",
            str(tmp / "out"), "--config_path",
            str(FIXTURE_DIR / "cfg_args.yaml"),
            "--eval_every", str(NARROW_STEPS)]
    for k, v in NARROW_SET.items():
        argv += ["--set", f"{k}={v}"]
    GOPFitter.__init__, GOPFitter._run_single = init, run_single
    GOPFitter.evaluate, report.evaluate_video = evaluate, evaluate_video
    try:
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        total = counts()
    finally:
        GOPFitter.__init__, GOPFitter._run_single = orig[:2]
        GOPFitter.evaluate, report.evaluate_video = orig[2:]
    log(f"narrow-width phase: cli.train.main in {wall:.2f} s wall: "
        f"results {json.dumps(res)}")
    log(f"narrow-width phase: launches B5f, B5b, B1, B2, B4 in all {total}; "
        f"per step {steps}; per evaluation "
        f"{[(kind, n, c) for kind, n, c in evals]}")
    if len(steps) != NARROW_STEPS or any(c != (1, 1, 0, 0, 0)
                                         for c in steps):
        raise AssertionError(f"per-step launches {steps}: expected B5f and "
                             f"B5b once per step and nothing else")
    kinds = [kind for kind, _, _ in evals]
    if kinds != ["fitter", "decoded"] or any(
            c != (n, 0, 0, 0, 0) for _, n, c in evals):
        raise AssertionError(f"evaluation launches {evals}: expected B5f "
                             f"once per frame of the fitter's and the "
                             f"decoded evaluation and nothing else")
    n_eval = sum(n for _, n, _ in evals)
    if total != (NARROW_STEPS + n_eval, NARROW_STEPS, 0, 0, 0):
        raise AssertionError(f"launches {total}")
    if len(losses) != NARROW_STEPS or not np.all(np.isfinite(losses)):
        raise AssertionError(f"losses {losses}")
    if not (res["bpp"] > 0 and np.isfinite(res["decoded_psnr"])):
        raise AssertionError(f"results {res}")
    log("narrow-width phase: loss per step " + ", ".join(
        f"{v:.5f}" for v in losses))
    split = timers[0].split()
    meds = {}
    for name, _ in NARROW_PHASES:
        rows = [r for it, r in enumerate(split, start=1)
                if phase_of(it, NARROW_PHASES) == name and it > 1]
        meds[name] = {k: float(np.median([r[k] for r in rows]))
                      for k in rows[0]}
        log(f"narrow-width phase: {name} median step over {len(rows)} "
            f"steps: " + ", ".join(f"{k} {v:.3f} ms"
                                    for k, v in meds[name].items())
            + f" ({1e3 / meds[name]['step']:.3f} it/s at "
            f"{NARROW[1]}x{NARROW[0]})")

    # the kernels on the fitted state's pair 299-300 (main-path inputs)
    cfg = load_config(str(FIXTURE_DIR / "cfg_args.yaml"),
                      overrides=NARROW_SET)
    dataset = FrameCubeDataset(str(tmp / "frames"))
    fitter = GOPFitter(cfg, dataset, seed=0, device="cuda")
    load_checkpoint(str(tmp / "out" / "chkpnt_final.pkl"), fitter)
    attrs, lists, cnt = training_pair_inputs(fitter, 299, (False, True))
    b5f, b5b = tile_check(tile, fitter.settings, attrs, lists, cnt,
                          "narrow-width phase (frames 299-300)")
    shared = os.environ.get("GSVC_SMOKE_PAIR")
    if shared:
        # the fit is not bitwise repeatable: runs that are to compare B5f's
        # bits share the first run's pair through this file
        path = pathlib.Path(shared)
        if not path.exists():
            torch.save(tuple(t.cpu() for t in (attrs, lists, cnt)), path)
        planes, c = view_planes(*(t.cuda() for t in torch.load(path)))
        log(f"narrow-width phase (the pair saved in {path}): B5f "
            f"{b5f_digest(*tile.tile_fwd_cuda(fitter.settings, planes, c))}")
    b5f.update(launches=total[0], step_ms=meds["FULL_PRECISION"]["B5f"])
    b5b.update(launches=total[1], step_ms=meds["FULL_PRECISION"]["B5b"])
    del fitter
    return b5f, b5b, res, meds


WHOLE_FRAMES = 16       # frames of the whole-video phase's video
WHOLE_GOP = 8           # its --gop_size: two GOPs
WHOLE_PROFILE_STEPS = 4
# LPIPS on the card against the CPU: in float32 the two differ by ~1e-7
# relative, with the convolutions in TF32 (the guard in ``lpips`` gone) by
# ~1.5e-5 on a decoded 1080p frame, so 1e-4 could not tell them apart
LPIPS_REL = 1e-6


def whole_video_files(frames, root: pathlib.Path):
    """The first WHOLE_FRAMES frames as PNGs in ``root/frames``, one seeded
    uniform flow field a frame pair (float16 [2, H, W] pickles) in
    ``root/flow``, GOP 0's frames and flows as symlinks in ``root/gop0``,
    and ``root/cfg.yaml``: the fixture's config with the narrow phase's
    12-step schedule in the file (the segments are given no --set)."""
    import pickle

    from PIL import Image

    from gsvc_tpu_torch.config import load_config, save_config

    for sub in ("frames", "flow", "gop0/frames", "gop0/flow"):
        (root / sub).mkdir(parents=True)
    h, w = frames.shape[1:3]
    rng = np.random.default_rng(0)
    for i in range(WHOLE_FRAMES):
        Image.fromarray(frames[i]).save(root / "frames" / f"f_{i:04d}.png",
                                        compress_level=1)
        if i < WHOLE_GOP:
            os.symlink(root / "frames" / f"f_{i:04d}.png",
                       root / "gop0/frames" / f"f_{i:04d}.png")
        if i + 1 < WHOLE_FRAMES:
            uv = rng.normal(0, 1.5, 2).astype(np.float16)
            flow = np.broadcast_to(uv[:, None, None], (2, h, w)).copy()
            with open(root / "flow" / f"flow_{i:04d}.pkl", "wb") as f:
                pickle.dump(flow, f)
            if i + 1 < WHOLE_GOP:
                os.symlink(root / "flow" / f"flow_{i:04d}.pkl",
                           root / "gop0/flow" / f"flow_{i:04d}.pkl")
    cfg = load_config(str(FIXTURE_DIR / "cfg_args.yaml"), overrides=NARROW_SET)
    save_config(cfg, str(root / "cfg.yaml"))


def lpips_npz(path: pathlib.Path, seed: int = 0):
    """Seeded weights at full VGG16 width in the LPIPS exporter's npz
    schema (``features.{i}.weight|bias``, ``lin{k}.weight``)."""
    from gsvc_tpu_torch.metrics.lpips import _SLICES, _VGG_CONVS

    widths = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)
    rng = np.random.default_rng(seed)
    out, in_ch = {}, 3
    for ci, conv_idx in enumerate(_VGG_CONVS):
        out[f"features.{conv_idx}.weight"] = rng.normal(
            0, np.sqrt(2.0 / (in_ch * 9)), (widths[ci], in_ch, 3, 3)).astype(
                np.float32)
        out[f"features.{conv_idx}.bias"] = np.zeros(widths[ci], np.float32)
        in_ch = widths[ci]
    for k, upto in enumerate(_SLICES):
        c = widths[upto - 1]
        out[f"lin{k}.weight"] = (rng.uniform(0.5, 1.5, (1, c, 1, 1)).astype(
            np.float32) / c)
    np.savez(path, **out)


def whole_video_phase(frames, hk, counters):
    """The whole-video encode and the rest of the single-GPU surface on
    the first WHOLE_FRAMES decoded 1080p frames at the fixture's full
    model (``whole_video_files``):

    (a) ``cli.train.main --gop_size 8``: two GOPs, each fit (12 steps),
        estimate, encode, decode and evaluation through ``main``.  The
        counts are reset before and read after, per step (B1 and B2 once,
        B3f/B3b once in the entropy steps and never before them), per
        decoded evaluation (B4 once per frame) and in all (no B5f, B5b,
        B6f, B6b); each ``gop_*`` holds every artifact, its
        ``point_cloud.ply`` gives back the checkpoint's first n_active
        anchors exactly, and results.json has gops == 2;
    (b) ``cli.decode --lpips_weights proxy --dump_frames`` on GOP 0's
        bitstream and frames with GSVC_DECODE=mirror: B1 once per frame and
        never B4, a finite LPIPS in [0, 1), and a PSNR within 0.01 dB of
        the same decoded state rendered through B4 (``evaluate_video``
        with GSVC_DECODE=bidir; fps side by side) and printed beside the
        train CLI's decoded PSNR of GOP 0;
    (c) ``cli.train --profile`` (WHOLE_PROFILE_STEPS steps, --skip_codec)
        on GOP 0: the trace parses as JSON; whether B1 and B2 show in it is
        printed, not required (PERF.md §7);
    (d) ``lpips`` at full VGG16 width (``lpips_npz``) on decoded frame 0
        against its ground truth, on the card with cuDNN's TF32 switch
        at PyTorch's default (on) and on the CPU: LPIPS_REL (the call
        without the guard is printed beside them);
    (e) ``cli.debug_vis`` on GOP 0's checkpoint (its three PNGs), and
        ``viewer.ViewerServer.render_png(0)`` on the decoded state equal to
        the decode's frame 0 to 1 LSB.

    ``cli.sweep`` is not run: it only loops over ``cli.train.main``.
    Returns the launches of (a) and (b) by kernel name, the phase's
    directory (its files serve the multi-rank phase) and the wall seconds
    of (a)."""
    import contextlib
    import io

    import gsvc_tpu_torch.cli.decode as cli_decode
    import gsvc_tpu_torch.report as report
    from PIL import Image

    from gsvc_tpu_torch.cli import debug_vis, train as cli_train
    from gsvc_tpu_torch.framecube.frame import FrameFolder
    from gsvc_tpu_torch.metrics.lpips import load_lpips_weights, lpips
    from gsvc_tpu_torch.models.gaussians import GenerateMode
    from gsvc_tpu_torch.train.fit import GOPFitter
    from gsvc_tpu_torch.utils.checkpoint import read_checkpoint
    from gsvc_tpu_torch.utils.ply import load_gaussian_ply
    from gsvc_tpu_torch.viewer import ViewerServer

    t_phase = time.perf_counter()
    names = [n for n, _ in counters]

    def counts():
        return tuple(c.launches for _, c in counters)

    def named(c):
        return dict(zip(names, c))

    root = pathlib.Path(tempfile.mkdtemp(prefix="gsvc_smoke_whole_"))
    t0 = time.perf_counter()
    whole_video_files(frames, root)
    log(f"whole-video phase: {WHOLE_FRAMES} PNG frames, "
        f"{WHOLE_FRAMES - 1} flow pickles and the config written in "
        f"{time.perf_counter() - t0:.2f} s")

    # (a) the segmented encode through the train CLI
    steps, evals = [], []
    orig = (GOPFitter._run_single, report.evaluate_video)

    def run_single(self, it, n):
        c0 = counts()
        m = orig[0](self, it, n)
        steps.append((phase_of(it, NARROW_PHASES),
                      named(tuple(b - a for a, b in zip(c0, counts())))))
        return m

    def evaluate_video(*a, **k):
        c0 = counts()
        r = orig[1](*a, **k)
        evals.append((r["num_frames"],
                      named(tuple(b - a_ for a_, b in zip(c0, counts())))))
        return r

    GOPFitter._run_single, report.evaluate_video = run_single, evaluate_video
    try:
        for _, c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        summary = cli_train.main([
            "--source_path", str(root / "frames"), "--optical_path",
            str(root / "flow"), "--model_path", str(root / "out"),
            "--config_path", str(root / "cfg.yaml"),
            "--gop_size", str(WHOLE_GOP)])
        torch.cuda.synchronize()
        train_wall = time.perf_counter() - t0
        train_total = named(counts())
    finally:
        GOPFitter._run_single, report.evaluate_video = orig
    log(f"whole-video phase: cli.train.main --gop_size {WHOLE_GOP} in "
        f"{train_wall:.2f} s wall: summary {json.dumps(summary)}")
    log(f"whole-video phase: launches in all {train_total}; per decoded "
        f"evaluation {evals}")
    n_gops = WHOLE_FRAMES // WHOLE_GOP
    if summary["gops"] != n_gops or len(summary["per_gop"]) != n_gops:
        raise AssertionError(f"summary {summary}")
    if len(steps) != n_gops * NARROW_STEPS:
        raise AssertionError(f"{len(steps)} steps, expected "
                             f"{n_gops * NARROW_STEPS}")
    for phase, c in steps:
        entropy = phase in ("ENTROPY", "STE_ENTROPY")
        want = dict(B1=1, B2=1, B3b=int(entropy))
        if any(c[k] != v for k, v in want.items()) or \
                (c["B3f"] != 1 if entropy else c["B3f"] != 0) or any(
                    c[k] for k in ("B4", "B5f", "B5b", "B6f", "B6b")):
            raise AssertionError(f"per-step launches {steps}: expected B1 "
                                 f"and B2 once a step, B3f/B3b once in the "
                                 f"entropy steps and nothing else")
    if len(evals) != n_gops or any(
            c != dict(named((0,) * len(names)), B4=n) for n, c in evals):
        raise AssertionError(f"decoded evaluations {evals}: expected B4 once "
                             f"per frame and nothing else")
    if any(train_total[k] for k in ("B5f", "B5b", "B6f", "B6b")):
        raise AssertionError(f"launches {train_total}")
    for (start, res) in zip(range(0, WHOLE_FRAMES, WHOLE_GOP),
                            summary["per_gop"]):
        gop = root / "out" / f"gop_{start:05d}"
        for name in ("bitstreams", "results.json", "metrics.jsonl",
                     "cfg_args.yaml", "chkpnt_final.pkl",
                     "point_cloud/final/point_cloud.ply",
                     "point_cloud/final/networks.pkl"):
            if not (gop / name).exists():
                raise AssertionError(f"{gop} lacks {name}")
        if not (res["bpp"] > 0 and np.isfinite(res["decoded_psnr"])):
            raise AssertionError(f"{gop}: results {res}")
        ck = read_checkpoint(str(gop / "chkpnt_final.pkl"))
        n = int(ck["n_active"])
        ply = load_gaussian_ply(str(gop / "point_cloud/final/point_cloud.ply"))
        for k, v in ply.items():
            if not np.array_equal(v, ck["anchors"][k][:n]):
                raise AssertionError(f"{gop}: point_cloud.ply {k} is not the "
                                     f"checkpoint's first {n} anchors")
        log(f"whole-video phase: GOP {start}: {n} anchors, bpp "
            f"{res['bpp']:.5f}, {res['size_mb']:.3f} MB, encode "
            f"{res['encode_seconds']:.2f} s, decode "
            f"{res['decode_seconds']:.2f} s, decoded PSNR "
            f"{res['decoded_psnr']:.4f} dB, SSIM {res['decoded_ssim']:.4f}, "
            f"decode fps {res['decode_fps']:.2f} (B4)")
    if not (root / "out/results.json").exists():
        raise AssertionError("no summary results.json")

    # (b) the mirror decode with LPIPS through the decode CLI
    decoded = []
    orig_dec = cli_decode.decode_bitstream

    def decode_bitstream(*a, **k):
        decoded.append(orig_dec(*a, **k))
        return decoded[-1]

    env = os.environ.get("GSVC_DECODE")
    cli_decode.decode_bitstream = decode_bitstream
    os.environ["GSVC_DECODE"] = "mirror"
    try:
        for _, c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev = cli_decode.main([
            "--bitstream_path", str(root / "out/gop_00000/bitstreams"),
            "--model_path", str(root / "dec"), "--source_path",
            str(root / "gop0/frames"), "--lpips_weights", "proxy",
            "--dump_frames"])
        torch.cuda.synchronize()
        dec_wall = time.perf_counter() - t0
        dec_total = named(counts())
        dec = decoded[0]
        viewer = ViewerServer(dec.state, dec.cfg, dec.settings,
                              dec.window_cap, dec.frame_zs, dec.x_min,
                              dec.y_min, dec.scale, decoded=True)
        png0 = viewer.render_png(0)
        os.environ["GSVC_DECODE"] = "bidir"
        ev_b4 = report.evaluate_video(
            dec.state, dec.cfg, dec.settings, dec.window_cap, dec.frame_zs,
            dec.x_min, dec.y_min, dec.scale,
            gt_images=FrameFolder(str(root / "gop0/frames")))
    finally:
        cli_decode.decode_bitstream = orig_dec
        if env is None:
            os.environ.pop("GSVC_DECODE")
        else:
            os.environ["GSVC_DECODE"] = env
    want_psnr = summary["per_gop"][0]["decoded_psnr"]
    log(f"whole-video phase: cli.decode (GSVC_DECODE=mirror, proxy LPIPS) in "
        f"{dec_wall:.2f} s wall (host decode {dec.seconds:.2f} s): "
        f"{json.dumps({k: v for k, v in ev.items() if k != 'per_frame_psnr'})}"
        f"; launches {dec_total}")
    log(f"whole-video phase: GOP 0 decoded PSNR {ev['psnr']:.4f} dB through "
        f"B1 (mirror, fps {ev['fps']:.2f}), {ev_b4['psnr']:.4f} dB through B4 "
        f"on the same decoded state and settings (fps {ev_b4['fps']:.2f}), "
        f"{want_psnr:.4f} dB in the train CLI's evaluation (B4 at the "
        f"fitter's settings, tile {dec.settings.tile_h}x"
        f"{dec.settings.tile_w} here); proxy LPIPS {ev['lpips']:.6f}")
    if dec_total["B1"] != WHOLE_GOP or any(
            v for k, v in dec_total.items() if k != "B1"):
        raise AssertionError(f"mirror decode launches {dec_total}: expected "
                             f"B1 once per frame and nothing else")
    if not abs(ev["psnr"] - ev_b4["psnr"]) <= 0.01:
        raise AssertionError(f"mirror PSNR {ev['psnr']} is not within 0.01 "
                             f"dB of B4's {ev_b4['psnr']}")
    if not 0 <= ev["lpips"] < 1:
        raise AssertionError(f"LPIPS {ev['lpips']}")

    # (c) the profiled fit
    t0 = time.perf_counter()
    cli_train.main(["--source_path", str(root / "gop0/frames"),
                    "--model_path", str(root / "prof"), "--config_path",
                    str(root / "cfg.yaml"), "--skip_codec", "--iterations",
                    str(WHOLE_PROFILE_STEPS), "--profile",
                    str(root / "trace")])
    trace_path = root / "trace" / "trace.json"
    events = json.loads(trace_path.read_text())["traceEvents"]
    kernels = {e.get("name", "") for e in events
               if e.get("cat") == "kernel"}
    shows = {k: any(pat in n for n in kernels)
             for k, pat in (("B1", "mirror_fwd"), ("B2", "mirror_bwd"))}
    log(f"whole-video phase: --profile ({WHOLE_PROFILE_STEPS} steps) in "
        f"{time.perf_counter() - t0:.2f} s: {trace_path.stat().st_size} "
        f"bytes, {len(events)} events, {len(kernels)} kernel names; B1/B2 "
        f"in the trace: {shows}")

    # (d) LPIPS at full VGG16 width, card against CPU, TF32 at its default
    lpips_npz(root / "lpips_vgg16.npz")
    gt0 = torch.from_numpy(frames[0]).float() / 255.0
    img0 = report._make_eval_render(
        dec.cfg, dec.settings, dec.window_cap, dec.x_min, dec.y_min,
        dec.scale, GenerateMode.DECODED, True)(
            dec.state, float(dec.frame_zs[0])).permute(1, 2, 0)
    smoke_flags = (torch.backends.cuda.matmul.allow_tf32,
                   torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False     # PyTorch's defaults
    torch.backends.cudnn.allow_tf32 = True
    try:
        w_card = load_lpips_weights(str(root / "lpips_vgg16.npz"), "cuda")
        lpips(w_card, img0, gt0.cuda())                # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = float(lpips(w_card, img0, gt0.cuda()))
        card_s = time.perf_counter() - t0
        tf32_after = torch.backends.cudnn.allow_tf32
        # what the guard prevents: the same call with cuDNN's flags left
        # alone, i.e. the convolutions in TF32
        guard = torch.backends.cudnn.flags
        torch.backends.cudnn.flags = lambda **_: contextlib.nullcontext()
        try:
            unguarded = float(lpips(w_card, img0, gt0.cuda()))
        finally:
            torch.backends.cudnn.flags = guard
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = smoke_flags
    t0 = time.perf_counter()
    cpu = float(lpips(load_lpips_weights(str(root / "lpips_vgg16.npz")),
                      img0.cpu(), gt0))
    cpu_s = time.perf_counter() - t0
    log(f"whole-video phase: full-width LPIPS of decoded frame 0 "
        f"({gt0.shape[1]}x{gt0.shape[0]}): card {card!r} ({card_s:.3f} s, "
        f"cuDNN TF32 flag on before and {tf32_after} after), CPU {cpu!r} "
        f"({cpu_s:.2f} s), rel diff {abs(card - cpu) / abs(cpu):.3e}; "
        f"without the guard (TF32) {unguarded!r}, rel diff "
        f"{abs(unguarded - cpu) / abs(cpu):.3e}")
    if not tf32_after or not abs(card - cpu) <= LPIPS_REL * abs(cpu):
        raise AssertionError(f"LPIPS on the card {card} against the CPU's "
                             f"{cpu} (TF32 flag after: {tf32_after})")

    # (e) debug renders and the viewer
    t0 = time.perf_counter()
    debug_vis.main(["--model_path", str(root / "out/gop_00000"),
                    "--checkpoint",
                    str(root / "out/gop_00000/chkpnt_final.pkl"),
                    "--source_path", str(root / "gop0/frames"),
                    "--optical_path", str(root / "gop0/flow"),
                    "--config_path", str(root / "cfg.yaml")])
    vis = root / "out/gop_00000/debug_vis"
    pngs = sorted(p.name for p in vis.iterdir())
    log(f"whole-video phase: cli.debug_vis in {time.perf_counter() - t0:.2f}"
        f" s: {pngs}")
    if pngs != ["flow_field_0.png", "flow_scatter_0.png",
                "gaussians_xy_0.png"]:
        raise AssertionError(f"debug_vis wrote {pngs}")
    got = np.asarray(Image.open(io.BytesIO(png0)), np.int16)
    want = np.asarray(Image.open(root / "dec/frames/frame_00000.png"),
                      np.int16)
    if got.shape != want.shape or np.abs(got - want).max() > 1:
        raise AssertionError(f"viewer frame 0 differs from the decode's by "
                             f"{np.abs(got - want).max()} levels")
    wall = time.perf_counter() - t_phase
    log(f"whole-video phase: viewer frame 0 equals the decode's to "
        f"{int(np.abs(got - want).max())} LSB; phase wall {wall:.2f} s")
    return ({k: train_total[k] + dec_total[k] for k in names}, root,
            train_wall)


# ---------------------------------------------------------------------------
# The multi-rank phase: parallel/spmd.py on gloo ranks sharing the card
# ---------------------------------------------------------------------------

MESH_SPEC = "dp=2,sp=2"
MESH_WORLD = 4
MESH_TIMEOUT = 600      # seconds for one spawn of ranks (and their group)
SLAB_FRAME = 300
SLAB_ATOL = 2e-4        # tests/test_parallel.py:67
BRANCH_ATOL = 1e-6      # tests/test_parallel.py:133
FIT_PEAK = {}           # the training phase's single-GPU fit: peak bytes


def _spawn_ranks(fn, world: int, args: tuple, timeout: float = MESH_TIMEOUT):
    """``fn(rank, world, port, *args)`` on ``world`` spawned processes;
    a rank that raises fails the phase, and ranks past ``timeout``
    seconds are killed and fail it."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.start_processes(fn, args=(world, port) + args, nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError(f"ranks still running after {timeout} s")


def _rank_group(rank: int, world: int, port: int):
    """This spawned rank inside a gloo group on 127.0.0.1, on cuda:0."""
    import datetime

    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=MESH_TIMEOUT))
    torch.cuda.set_device(0)


def _depth_disjoint(state):
    """A copy of ``state`` whose z-slabs are depth-disjoint: no gaussian
    leaves its anchor's depth (the offsets' scale in z, ``exp(scaling[:,
    2])``, made ~1e-26, so learned and neural offsets alike lose their z
    part), and the anchors that share one z value (the voxel grid) spread
    evenly over the gap to the next value, so no two slabs hold gaussians
    at one depth (equal depths composite in row order, not slab order).
    The rows stay z-sorted."""
    n = state.n_active
    anchor = state.anchors.anchor.clone()
    z = anchor[:n, 2].cpu().numpy().astype(np.float64)
    starts = np.r_[0, np.flatnonzero(np.diff(z)) + 1]
    counts = np.diff(np.r_[starts, n])
    gaps = np.diff(np.r_[z[starts], z[-1] + 1e-3])
    within = np.arange(n) - np.repeat(starts, counts)
    anchor[:n, 2] = torch.from_numpy(
        (z + np.repeat(gaps / counts, counts) * within).astype(np.float32))
    scaling = state.anchors.scaling.clone()
    scaling[:, 2] = -60.0
    return state._replace(anchors=state.anchors._replace(anchor=anchor,
                                                         scaling=scaling))


def _slab_checks(rank: int, world: int, job: dict):
    """The slab composite on this rank of the group, forward and flipped
    views, one z-slab a rank (B5f), combined over sp with and without
    ``neighbors``, at sp = 2 (mesh 2 x 2) and sp = 4 (1 x 4); ``neighbors``
    is the fitter's bound, min(sp - 1, ceil(global window band / slab
    rows)), which takes the ppermute rounds when it is below sp - 1.
    Cases: the fitted state at frame SLAB_FRAME (gated) and at the frame
    nearest the z of the anchor row at half the capacity (where the slabs
    of sp = 2 and the middle ones of sp = 4 meet; not gated: its slabs
    overlap in depth), and ``_depth_disjoint`` of it at its own boundary
    frame (gated).  Returns, on rank 0, each case's largest difference
    from the single-rank render of the same state and between the
    branches, the combine's milliseconds and the host copies."""
    from gsvc_tpu_torch.convert import state_from_numpy
    from gsvc_tpu_torch.parallel import spmd
    from gsvc_tpu_torch.render.pipeline import render_frame
    from gsvc_tpu_torch.train.fit import compute_window_cap
    from gsvc_tpu_torch.utils.checkpoint import read_checkpoint

    fitted = state_from_numpy(read_checkpoint(job["ckpt"]), "cuda")
    cap = fitted.anchors.anchor.shape[0]
    zs = np.asarray(job["frame_zs"])
    res = {}
    for label, state in (("fitted", fitted),
                         ("depth-disjoint", _depth_disjoint(fitted))):
        band = compute_window_cap(state.anchors.anchor[:, 2].cpu().numpy(),
                                  state.n_active, zs, job["gcfg"].threshold)
        window = max(job["window_cap"], band)
        z_mid = float(state.anchors.anchor[cap // 2, 2])
        frames = {int(np.argmin(np.abs(zs - z_mid))): label != "fitted"}
        if label == "fitted":
            frames[SLAB_FRAME] = True
        for f, gated in sorted(frames.items()):
            args = (float(zs[f]), *job["geom"], job["settings"])
            ref = {flip: render_frame(state, job["gcfg"], *args, window,
                                      flip=flip).image
                   for flip in (False, True)} if rank == 0 else {}
            for n_sp in (2, 4):
                mesh = spmd.make_mesh(world // n_sp, n_sp, "cuda:0")
                local = spmd.shard_model_state(state, mesh)
                wc = min(window, cap // n_sp)
                bound = min(n_sp - 1, -(-band // (cap // n_sp)))
                for flip in (False, True):
                    r = render_frame(local, job["gcfg"], *args, wc,
                                     flip=flip)
                    imgs, ms = {}, {}
                    for nb in (None, bound):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        imgs[nb] = spmd.combine_slab_renders(
                            r.image, r.transmittance, flip,
                            job["settings"].bg, mesh, neighbors=nb)[0]
                        torch.cuda.synchronize()
                        ms[nb] = (time.perf_counter() - t0) * 1e3
                    if rank == 0:
                        diff = (imgs[None] - ref[flip]).abs()
                        res[(label, f, n_sp, flip)] = {
                            "err": float(diff.max()), "neighbors": bound,
                            "err_nb": float((imgs[bound] - ref[flip]).abs()
                                            .max()),
                            "branch": float((imgs[bound] - imgs[None])
                                            .abs().max()),
                            "over": int((diff > SLAB_ATOL).sum()),
                            "ms": ms[None], "ms_nb": ms[bound],
                            "band": band, "gated": gated,
                            "host_copies": mesh.stats.host_copies}
    del fitted, state
    torch.cuda.empty_cache()
    return res if rank == 0 else None


def _kernel_counters():
    from gsvc_tpu_torch.ops import hashgrid_kernels as hk
    from gsvc_tpu_torch.render import bidir, mirror, stream, tile

    return (("B1", mirror.mirror_forward), ("B2", mirror.mirror_backward),
            ("B3f", hk.hashgrid_forward), ("B3b", hk.hashgrid_backward),
            ("B4", bidir.bidir_composite_attrs), ("B5f", tile.tile_forward),
            ("B5b", tile.tile_backward), ("B6f", stream.stream_forward),
            ("B6b", stream.stream_backward))


def _mesh_rank(rank, world, port, argv, out_dir, slab_job):
    """On this rank of a gloo group that the smoke initialised: the slab
    composite checks (``_slab_checks``; rank 0 writes ``slab.pkl``), then
    ``cli.train.main(argv)`` (``--mesh``: the CLI's use-the-group path).
    Writes ``rank<r>.pkl``: its launches per step and in all, each step's
    milliseconds and collective milliseconds (the host clock around
    spmd's transport helpers, synchronised before and after each call),
    its peak memory, the nets' digest, the capacity, and the mesh
    fitter's FULL_PRECISION evaluation of frame 0."""
    import hashlib
    import pickle

    import torch.distributed as dist

    from gsvc_tpu_torch.cli import train as cli_train
    from gsvc_tpu_torch.models.gaussians import GenerateMode
    from gsvc_tpu_torch.parallel import spmd
    from gsvc_tpu_torch.train.fit import GOPFitter
    from gsvc_tpu_torch.train.optim import tree_leaves

    _rank_group(rank, world, port)
    t0 = time.perf_counter()
    slab = _slab_checks(rank, world, slab_job)
    if slab is not None:
        slab["wall"] = time.perf_counter() - t0
        with open(pathlib.Path(out_dir) / "slab.pkl", "wb") as f:
            pickle.dump(slab, f)
    counters = _kernel_counters()

    def counts():
        return {n: c.launches for n, c in counters}

    steps, box = [], {}
    orig = GOPFitter._run_single
    # the collectives' time: the host clock between two synchronisations
    # around each of spmd's transport helpers (they do not synchronise)
    coll = {"s": 0.0}
    helpers = {n: getattr(spmd, n) for n in ("_reduce", "_gather",
                                             "_permute")}

    def timed(fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                coll["s"] += time.perf_counter() - t0
        return run

    def run_single(self, it, n):
        box["fitter"] = self
        c0, s0 = counts(), coll["s"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = orig(self, it, n)
        torch.cuda.synchronize()
        c1 = counts()
        steps.append({"it": it, "ms": (time.perf_counter() - t0) * 1e3,
                      "coll_ms": (coll["s"] - s0) * 1e3,
                      "launches": {k: c1[k] - c0[k] for k in c1}})
        return m

    GOPFitter._run_single = run_single
    for n, fn in helpers.items():
        setattr(spmd, n, timed(fn))
    try:
        for _, c in counters:
            c.launches = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cli_train.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        total = counts()
        peak = torch.cuda.max_memory_allocated()
    finally:
        GOPFitter._run_single = orig
        for n, fn in helpers.items():
            setattr(spmd, n, fn)
    fitter = box["fitter"]
    ev0 = fitter.evaluate(GenerateMode.FULL_PRECISION, frames=[0])["psnr"]
    digest = hashlib.sha256(b"".join(
        t.detach().cpu().numpy().tobytes()
        for t in tree_leaves(fitter.state.nets))).hexdigest()
    out = {"rank": rank, "steps": steps, "total": total, "peak": peak,
           "wall": wall, "digest": digest, "capacity": fitter.capacity,
           "window_cap": fitter.window_cap, "eval0": ev0, "res": res,
           "stats": fitter.mesh.stats.as_dict(),
           "local_rows": fitter.state.anchors.anchor.shape[0]}
    with open(pathlib.Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def multi_rank_phase(root: pathlib.Path, seq_wall: float, slab_job: dict):
    """The multi-GPU path (``parallel/spmd.py``) on the card, its ranks
    sharing it over gloo (one card cannot show multi-GPU speed: every
    time here is of ranks sharing one card), on the whole-video phase's
    files (``root``: 16 decoded 1920x1080 PNGs with flows, GOP 0's 8, the
    fixture's full model with the 12-step schedule):

    (1) the slab composite (``_slab_checks``, on the ranks of (2) before
        the fit), at sp = 2 and sp = 4 (where ``neighbors`` = 1 takes the
        ppermute rounds, staged through the host over gloo): the fitted
        state's frame SLAB_FRAME, and the depth-disjoint copy's frame at
        the slabs' middle boundary (where one slab's colours are weighted
        by another's transmittance), each combined within SLAB_ATOL of the
        single-rank render of the same state; the fitted state's boundary
        frame, whose slabs overlap in depth (the decomposition is exact
        only for depth-disjoint slabs), printed, not gated; in every case
        the two branches within BRANCH_ATOL of each other;
    (2) ``cli.train.main --mesh dp=2,sp=2`` on GOP 0 with the codec, on 4
        ranks that the smoke spawns inside a gloo group on cuda:0
        (``_mesh_rank``): B1 and B2 once a step on every rank, B3f/B3b
        once an entropy step and never before, no B4, B5 or B6 in a step,
        B4 once per evaluated frame on rank 0 and never elsewhere; a
        densify epoch, the capacity a multiple of sp, the nets' digests
        equal on all ranks, results.json with bpp > 0 and a finite
        decoded PSNR; ``chkpnt_final.pkl`` loaded into a single-GPU
        ``GOPFitter`` evaluates frame 0 (FULL_PRECISION) to the mesh
        fitter's PSNR exactly.  Per rank: peak memory, median step,
        collective ms a step;
    (3) ``cli.train.main --gop_size 8 --gop_parallel`` on the 16 frames
        through the CLI's own spawner (2 ranks): every ``gop_*`` file of
        the sequential run, the summary's gops == 2 and mesh {dp: 2, sp:
        1}; its wall beside the sequential run's (``seq_wall``).

    Returns the launches of (2) summed over the ranks, by kernel."""
    import pickle

    from gsvc_tpu_torch.cli import train as cli_train
    from gsvc_tpu_torch.config import load_config
    from gsvc_tpu_torch.framecube.frame import FrameCubeDataset
    from gsvc_tpu_torch.models.gaussians import GenerateMode
    from gsvc_tpu_torch.train.fit import GOPFitter
    from gsvc_tpu_torch.utils.checkpoint import load_checkpoint, \
        read_checkpoint

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    log(f"multi-rank phase (ranks sharing one card over gloo): the "
        f"single-GPU fit's peak memory in the training phase "
        f"{FIT_PEAK.get('bytes', 0) / 2**30:.2f} GiB (steps, 600-frame "
        f"evaluations and densify epochs)")

    # (1) and (2): the slab composite, then the mesh fit with the codec,
    # on the same four ranks
    out_mesh = root / "out_mesh"
    ranks_dir = root / "mesh_ranks"
    ranks_dir.mkdir()
    argv = ["--source_path", str(root / "gop0/frames"), "--optical_path",
            str(root / "gop0/flow"), "--model_path", str(out_mesh),
            "--config_path", str(root / "cfg.yaml"), "--mesh", MESH_SPEC]
    t0 = time.perf_counter()
    _spawn_ranks(_mesh_rank, MESH_WORLD, (argv, str(ranks_dir), slab_job))
    mesh_wall = time.perf_counter() - t0
    with open(ranks_dir / "slab.pkl", "rb") as f:
        slab = pickle.load(f)
    for key, r in sorted((k, v) for k, v in slab.items() if k != "wall"):
        label, f, n_sp, flip = key
        gated = r["gated"]
        log(f"multi-rank phase: slab composite, {label} state, frame {f} "
            f"{'flipped' if flip else 'forward'} view, sp={n_sp}: max |"
            f"combined - single-rank| {r['err']:.3e} (all-gather), "
            f"{r['err_nb']:.3e} (neighbors={r['neighbors']}: global band "
            f"{r['band']} rows), {r['over']} values past "
            f"{SLAB_ATOL}{'' if gated else ' (not gated)'}; branches "
            f"{r['branch']:.3e} apart; combine {r['ms']:.2f} / "
            f"{r['ms_nb']:.2f} ms; host copies {r['host_copies']}")
        if r["branch"] > BRANCH_ATOL or (gated and r["err"] > SLAB_ATOL):
            raise AssertionError(f"slab composite {key}: {r}")
    log(f"multi-rank phase: slab composite checks in {slab['wall']:.2f} s "
        f"on the ranks")
    ranks = []
    for r in range(MESH_WORLD):
        with open(ranks_dir / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    entropic = ("ENTROPY", "STE_ENTROPY")
    for rk in ranks:
        if len(rk["steps"]) != NARROW_STEPS:
            raise AssertionError(f"rank {rk['rank']}: {len(rk['steps'])} "
                                 f"steps")
        for s in rk["steps"]:
            c, ent = s["launches"], phase_of(s["it"], NARROW_PHASES) \
                in entropic
            if (c["B1"], c["B2"], c["B3f"], c["B3b"]) != (1, 1, int(ent),
                                                         int(ent)) or any(
                    c[k] for k in ("B4", "B5f", "B5b", "B6f", "B6b")):
                raise AssertionError(f"rank {rk['rank']} step {s['it']}: "
                                     f"launches {c}")
        b4 = rk["total"]["B4"]
        if (rk["rank"] == 0) != (b4 == WHOLE_GOP) or (
                rk["rank"] and b4):
            raise AssertionError(f"rank {rk['rank']}: B4 {b4} times")
        ms = [s["ms"] for s in rk["steps"][1:]]
        coll = [s["coll_ms"] for s in rk["steps"][1:]]
        log(f"multi-rank phase: rank {rk['rank']} (ranks sharing one "
            f"card): peak memory {rk['peak'] / 2**30:.2f} GiB, median step "
            f"{np.median(ms):.1f} ms (steps 2-{NARROW_STEPS}: "
            + ", ".join(f"{v:.0f}" for v in ms) + "), collectives "
            f"{np.median(coll):.1f} ms a step (median), {rk['stats']}; "
            f"slab rows {rk['local_rows']}, window_cap {rk['window_cap']}"
            f"; launches in all {rk['total']}; main {rk['wall']:.2f} s")
    if len({rk["digest"] for rk in ranks}) != 1:
        raise AssertionError("the nets differ between ranks")
    if len({rk["capacity"] for rk in ranks}) != 1 or \
            ranks[0]["capacity"] % 2:
        raise AssertionError(f"capacities {[r['capacity'] for r in ranks]}")
    res = ranks[0]["res"]
    log(f"multi-rank phase: cli.train.main --mesh {MESH_SPEC} in "
        f"{mesh_wall:.2f} s wall (spawn included): {json.dumps(res)}")
    if not (res["bpp"] > 0 and np.isfinite(res["decoded_psnr"])):
        raise AssertionError(f"mesh results {res}")
    text = (out_mesh / "output.log").read_text()
    if "densify +" not in text or "backend gloo" not in text:
        raise AssertionError("no densify epoch (or no backend line) in the "
                             "mesh fit's log")
    ck = read_checkpoint(str(out_mesh / "chkpnt_final.pkl"))
    cfg = load_config(str(root / "cfg.yaml"))
    single = GOPFitter(cfg, FrameCubeDataset(str(root / "gop0/frames")),
                       seed=0, device="cuda")
    load_checkpoint(str(out_mesh / "chkpnt_final.pkl"), single)
    ev0 = single.evaluate(GenerateMode.FULL_PRECISION, frames=[0])["psnr"]
    log(f"multi-rank phase: chkpnt_final.pkl (capacity {ck['capacity']}, "
        f"{ck['n_active']} anchors) in a single-GPU GOPFitter: frame 0 "
        f"PSNR {ev0!r} dB, the mesh fitter's {ranks[0]['eval0']!r}")
    if ev0 != ranks[0]["eval0"] or ck["capacity"] % 2:
        raise AssertionError("the mesh checkpoint does not evaluate alike "
                             "in a single-GPU fitter")
    del single
    torch.cuda.empty_cache()

    # (3) the GOP fan-out through the CLI's own spawner
    t0 = time.perf_counter()
    summary = cli_train.main([
        "--source_path", str(root / "frames"), "--optical_path",
        str(root / "flow"), "--model_path", str(root / "out_fan"),
        "--config_path", str(root / "cfg.yaml"), "--gop_size",
        str(WHOLE_GOP), "--gop_parallel"])
    fan_wall = time.perf_counter() - t0
    log(f"multi-rank phase: cli.train.main --gop_size {WHOLE_GOP} "
        f"--gop_parallel (2 ranks sharing the card) in {fan_wall:.2f} s "
        f"wall against {seq_wall:.2f} s for the sequential --gop_size "
        f"{WHOLE_GOP} of the whole-video phase: {json.dumps(summary)}")
    if summary["gops"] != 2 or summary["mesh"] != {"dp": 2, "sp": 1}:
        raise AssertionError(f"fan-out summary {summary}")
    for start, r in zip(range(0, WHOLE_FRAMES, WHOLE_GOP),
                        summary["per_gop"]):
        gop = root / "out_fan" / f"gop_{start:05d}"
        for name in ("bitstreams", "results.json", "metrics.jsonl",
                     "cfg_args.yaml", "chkpnt_final.pkl", "output.log",
                     "point_cloud/final/point_cloud.ply",
                     "point_cloud/final/networks.pkl"):
            if not (gop / name).exists():
                raise AssertionError(f"{gop} lacks {name}")
        if not (r["bpp"] > 0 and np.isfinite(r["decoded_psnr"])):
            raise AssertionError(f"{gop}: results {r}")
    log(f"multi-rank phase: wall {time.perf_counter() - t_phase:.2f} s")
    return {k: sum(rk["total"][k] for rk in ranks)
            for k in ("B1", "B2", "B3f", "B3b", "B4")}


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
    from gsvc_tpu_torch.render import bidir, mirror, stream, tile
    from gsvc_tpu_torch.render.splat import RasterSettings
    from gsvc_tpu_torch.utils.checkpoint import save_checkpoint

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
        for line in ptxas_report(text, name):
            log(f"  {name}: {line}")
    global SM_CLOCK_MHZ
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True,
        text=True).stdout.strip().splitlines()
    SM_CLOCK_MHZ = int(clock[0]) if clock and clock[0].isdigit() else None
    log(f"SM clock (clocks.max.sm): {SM_CLOCK_MHZ} MHz; "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")

    settings = RasterSettings(image_height=1080, image_width=1920,
                              threshold=0.1, tile_h=16, tile_w=128,
                              gaussian_cap=1024, chunk=128,
                              tiles_per_gaussian=32)
    train_settings = RasterSettings(image_height=1080, image_width=1920,
                                    threshold=0.05, tile_h=8, tile_w=128,
                                    gaussian_cap=1024, chunk=128,
                                    tiles_per_gaussian=32)
    SASS_PER_PAIR.update(sass_floors(build, sass_kernels(
        bidir, stream, tile, settings, train_settings)))
    kernel_err, _ = kernel_phase(bidir, settings)
    mk_fwd, mk_bwd = mirror_kernel_phase(mirror, train_settings)
    t5f, t5b = tile_kernel_phase(tile, mirror, train_settings)
    res, dec = slice_phase(bidir)
    b1, b2, b3_launches, fitter, frames = training_phase(dec, bidir, mirror,
                                                         hk)
    (h3f, h3b), (c3f, c3b) = hashgrid_phase(hk, fitter)
    codec = codec_phase(fitter, bidir, mirror, tile, hk)
    b6f, b6b = stream_kernel_phase(stream, mirror, fitter)
    ckpt = pathlib.Path(tempfile.mkdtemp(prefix="gsvc_smoke_ckpt_")) \
        / "chkpnt_fitted.pkl"
    save_checkpoint(str(ckpt), fitter, TRAIN_STEPS)
    ds = fitter.dataset
    slab_job = {"ckpt": str(ckpt), "gcfg": fitter.gcfg,
                "settings": fitter.settings,
                "geom": (ds.x_min, ds.y_min, ds.scale),
                "frame_zs": fitter.frame_zs,
                "window_cap": fitter.window_cap}
    del fitter, ds
    torch.cuda.empty_cache()
    counters = (("B6f", stream.stream_forward),
                ("B6b", stream.stream_backward),
                ("B1", mirror.mirror_forward), ("B2", mirror.mirror_backward),
                ("B5f", tile.tile_forward), ("B5b", tile.tile_backward),
                ("B4", bidir.bidir_composite_attrs))
    _, cli_b6f = stream_cli_phase(ckpt, frames, codec["psnr"], counters)
    torch.cuda.empty_cache()
    fit_b6, stream_meds = short_fit_phase(
        frames, hk, counters, STREAM_SET, ("B6f", "B6b"),
        "stream fit phase (pallas_stream, copy_budget_factor 8)")
    torch.cuda.empty_cache()
    # the same fit through B1/B2, for comparison
    short_fit_phase(frames, hk, counters, {"pipeline.rasterizer":
                                           "pallas_train"}, ("B1", "B2"),
                    "stream fit phase (pallas_train, the same fit)")
    torch.cuda.empty_cache()
    b6f.update(launches=fit_b6[0] + cli_b6f,
               step_ms=stream_meds["FULL_PRECISION"]["B6f"])
    b6b.update(launches=fit_b6[1],
               step_ms=stream_meds["FULL_PRECISION"]["B6b+scatter"])
    b5f, b5b, _, _ = narrow_phase(frames, bidir, mirror, tile, hk)
    torch.cuda.empty_cache()
    whole, whole_root, seq_wall = whole_video_phase(
        frames, hk, counters + (("B3f", hk.hashgrid_forward),
                                ("B3b", hk.hashgrid_backward)))
    torch.cuda.empty_cache()
    multi = multi_rank_phase(whole_root, seq_wall, slab_job)
    # each path's launches: its count reset before it and read after (the
    # multi-rank phase's summed over its ranks)
    res["launches"] += whole["B4"] + multi["B4"]
    b1["launches"] += whole["B1"] + multi["B1"]
    b2["launches"] += whole["B2"] + multi["B2"]
    b3_launches = (b3_launches[0] + whole["B3f"] + multi["B3f"],
                   b3_launches[1] + whole["B3b"] + multi["B3b"])

    table = {"kernels": [{
        "name": "bidir_composite_attrs",
        "route": "cuda",
        "source": "gsvc_tpu_torch/csrc/bidir.cu",
        "replaces": "gsvc_tpu/render/pallas_splat.py:1074",
        "launches": res["launches"],
        "max_abs_err": max(kernel_err, res["max_abs_err"]),
        "ms": res["ms"],
        "kernel_ms": res["kernel_ms"],   # the kernel alone (torch.profiler)
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
        "kernel_ms": h3f["kernel_ms"],   # the kernel alone (torch.profiler)
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
        "kernel_ms": h3b["kernel_ms"],   # the kernel alone (torch.profiler)
        "plain_ms": h3b["plain_ms"],
        "bound_ms": h3b["bound_ms"],
        "bound_by": h3b["bound_by"],
        "library_ms": None,   # no PyTorch call computes a hash-grid encode
    }, {
        "name": "tile_forward",
        "route": "cuda",
        "source": "gsvc_tpu_torch/csrc/tile_fwd.cu",
        "replaces": "gsvc_tpu/render/pallas_splat.py:277",
        "launches": b5f["launches"],
        "max_abs_err": max(t5f["max_abs_err"], b5f["max_abs_err"]),
        "ms": b5f["ms"],
        "kernel_ms": b5f["kernel_ms"],   # the kernel alone (torch.profiler)
        "plain_ms": b5f["plain_ms"],
        "bound_ms": b5f["bound_ms"],
        "bound_by": b5f["bound_by"],
        "library_ms": None,   # no PyTorch call computes a tile composite
    }, {
        "name": "tile_backward",
        "route": "cuda",
        "source": "gsvc_tpu_torch/csrc/tile_bwd.cu",
        "replaces": "gsvc_tpu/render/pallas_splat.py:349",
        "launches": b5b["launches"],
        "max_abs_err": max(t5b["max_abs_err"], b5b["max_abs_err"]),
        "ms": b5b["ms"],
        "kernel_ms": b5b["kernel_ms"],   # the kernel alone (torch.profiler)
        "plain_ms": b5b["plain_ms"],
        "bound_ms": b5b["bound_ms"],
        "bound_by": b5b["bound_by"],
        "library_ms": None,   # no PyTorch call computes a tile composite
    }, {
        "name": "stream_forward",
        "route": "cuda",
        "source": "gsvc_tpu_torch/csrc/stream_fwd.cu",
        "replaces": "gsvc_tpu/render/pallas_stream.py:103",
        "launches": b6f["launches"],
        "max_abs_err": b6f["max_abs_err"],
        "ms": b6f["ms"],
        "kernel_ms": b6f["kernel_ms"],   # the kernel alone (torch.profiler)
        "plain_ms": b6f["plain_ms"],
        "bound_ms": b6f["bound_ms"],
        "bound_by": b6f["bound_by"],
        "library_ms": None,   # no PyTorch call computes a stream composite
    }, {
        "name": "stream_backward",
        "route": "cuda",
        "source": "gsvc_tpu_torch/csrc/stream_bwd.cu",
        "replaces": "gsvc_tpu/render/pallas_stream.py:172",
        "launches": b6b["launches"],
        "max_abs_err": b6b["max_abs_err"],
        "ms": b6b["ms"],
        "kernel_ms": b6b["kernel_ms"],   # the kernel alone (torch.profiler)
        "plain_ms": b6b["plain_ms"],
        "bound_ms": b6b["bound_ms"],
        "bound_by": b6b["bound_by"],
        "library_ms": None,   # no PyTorch call computes a stream composite
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
