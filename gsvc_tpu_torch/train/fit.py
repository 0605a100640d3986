"""Window capacity of the decode render (port of ``compute_window_cap``,
gsvc_tpu/train/fit.py:43; the rest of the fitter is the training slice)."""

from __future__ import annotations

import numpy as np


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def compute_window_cap(z_sorted: np.ndarray, n_active: int,
                       frame_zs: np.ndarray, threshold: float,
                       headroom: float = 1.5, quantum: int = 512) -> int:
    """Smallest padded capacity covering the largest TSW band."""
    z = z_sorted[:n_active]
    max_band = 1
    for fz in frame_zs:
        lo = np.searchsorted(z, fz - threshold)
        hi = np.searchsorted(z, fz + threshold, side="right")
        max_band = max(max_band, hi - lo)
    cap = _round_up(int(max_band * headroom) + 8, quantum)
    # never exceed the physical buffer length
    return max(1, min(cap, _round_up(max(n_active, 1), quantum),
                      len(z_sorted)))
