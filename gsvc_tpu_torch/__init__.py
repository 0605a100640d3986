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
card; and fitting a GOP in the FULL_PRECISION and QUANTIZED_NOISE phases
(``python -m gsvc_tpu_torch.cli.train --skip_codec``) through the mirror
compositing kernels B1 (forward) and B2 (backward).
"""
