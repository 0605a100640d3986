"""PyTorch/CUDA port of gsvc_tpu: the gaussian-splat video codec on an
NVIDIA H100.

The JAX package ``gsvc_tpu`` is the reference.  This package imports
neither ``jax`` nor anything of ``gsvc_tpu``; it keeps its own copies of
what it needs.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper takes its plain PyTorch
version (the tests), on a CUDA tensor it launches the hand-written kernel.

Ported so far: the standalone decoder (``python -m gsvc_tpu_torch.cli.decode``)
— bitstream in, host entropy decode, then gaussian generation,
projection, binning and the bidirectional composite kernel (B4) on the
card; and encoding a GOP (``python -m gsvc_tpu_torch.cli.train``): the
fit through the four phases of the schedule with densify epochs, then
the rate estimate, the encode into the JAX package's bitstream format,
the decode and the decoded evaluation.  Training composites through the
mirror kernels B1 (forward) and B2 (backward) when the frame width is a
multiple of ``tile_w`` and through the single-view kernels B5f and B5b
otherwise (where the decoded frame is B5f's two views, not B4's); the
entropy phases add the hash-grid kernels B3f and B3b.  Around them: a
long video one model per segment (``cli.train --gop_size``), the stream
rasterizer and ``cli.stream``, LPIPS, the two-view decode
(``GSVC_DECODE=mirror``, B1), ``--profile``, model snapshots, the RD sweep
(``cli.sweep``), debug renders (``cli.debug_vis``) and the HTTP viewer
(``viewer``).  Fitting on several GPUs is not ported.
"""
