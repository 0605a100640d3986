"""Initial anchor point cloud (port of gsvc_tpu/framecube/pointcloud.py;
reference: frame_cube/utils.py:6-21)."""

from __future__ import annotations

import numpy as np


def init_point_cloud(x_min: float, y_min: float, z_min: float,
                     n: int = 10_000, bleed: float = 0.1,
                     rng: np.random.Generator | None = None) -> np.ndarray:
    """Uniform random anchors inside the bleed-extended NDC box — the same
    ``numpy.random.Generator`` draw as the JAX package's."""
    rng = rng or np.random.default_rng(0)
    x_lim, y_lim, z_lim = (x_min * (1 + bleed), y_min * (1 + bleed),
                           z_min * (1 + bleed))
    pts = rng.uniform(
        low=[x_lim, y_lim, z_lim], high=[-x_lim, -y_lim, -z_lim], size=(n, 3))
    return pts.astype(np.float32)
