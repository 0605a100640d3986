"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the port's native code from the checkout (``nvcc`` for the
   kernels, the host C++ compiler for the entropy codec) and prints the
   build's wall seconds.
3. Kernel phase: kernel B4 (``bidir_composite_attrs``) against its plain
   PyTorch version on the card at the 1080p decode shapes (T=1020 tiles,
   cap 1024, chunk 128, P=2048 pixels) with seeded random attribute rows:
   empty tiles, full lists of saturated stacks, chunk-aligned and partial
   last chunks.
4. Slice phase: decodes the committed 1080p bitstream
   (artifacts/rd_r5/realtex_0.004) with ``gsvc_tpu_torch.cli.decode`` and
   renders 8 frames spread over the video through ``report.evaluate_video``
   — the decoder's own render loop — with the launch counts reset just
   before and read just after; then holds each frame's kernel composite
   against the plain version on the same inputs and times both.
5. Prints the kernel table as one JSON line, then the result line.

Any failed check raises, so the run exits non-zero and prints no result.
Frames are written nowhere.  Without a CUDA device the script exits 1.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

FIXTURE = str(pathlib.Path(__file__).resolve().parent / "artifacts"
              / "rd_r5" / "realtex_0.004" / "bitstreams")
N_FRAMES = 8
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


def bound_ms(attrs, lists, counts, out_elems: int, pairs: int):
    """(least ms, what bounds it): each input read once, the output
    written once, over HBM bandwidth; the pairs' FP32 work over peak."""
    n_bytes = (attrs.numel() * 4 + lists.numel() * 4 + counts.numel() * 4
               + out_elems * 4)
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = pairs * FLOPS_PER_PAIR / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops > t_bytes
                                       else "bytes")


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
    b_ms, b_by = bound_ms(attrs, lists, counts, out_k.numel(), pairs)
    log(f"kernel phase: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}; {pairs} evaluated pairs)")
    return err


def slice_phase(bidir):
    """Decode the committed bitstream and render 8 frames through B4."""
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
    b_ms, b_by = bound_ms(a, l, c, out_p.numel(), pairs)
    splats_ms = cuda_ms(lambda: splats(zs[N_FRAMES // 2]), 5)
    log(f"slice phase: frame {ids[N_FRAMES // 2]} composite: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms "
        f"({b_by}; {pairs} evaluated pairs); window + generation + "
        f"projection + binning {splats_ms:.3f} ms")
    return dict(launches=launches, max_abs_err=max_err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from gsvc_tpu_torch import build
    from gsvc_tpu_torch.render import bidir
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
    res = slice_phase(bidir)

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
    }]}
    log(json.dumps(table))
    log(f"wall: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
