"""Frame-cube geometry and ground-truth frames.

A video is a 3D volume: frame width -> x, height -> y, time -> z, in an
NDC-like box (port of ``gsvc_tpu/framecube/frame.py``; reference:
frame_cube/frame.py:65-190).  ``scale = max(H, W, T) / 2`` and frame
``i`` sits at ``z = (i - T/2) / scale``.
"""

from __future__ import annotations

import pathlib

import numpy as np


def frame_geometry(width: int, height: int, num_frames: int):
    """(scale, x_min, y_min, z_min) for a (width, height, num_frames) cube."""
    scale = max(height, width, num_frames) / 2
    x_min = -width / 2 / scale
    y_min = -height / 2 / scale
    z_min = -num_frames / 2 / scale
    return scale, x_min, y_min, z_min


def frame_z(image_id: int, num_frames: int, scale: float) -> float:
    """z of frame plane i (reference: frame_cube/frame.py:158)."""
    return (image_id - num_frames / 2) / scale


class FrameFolder:
    """Ground-truth frames of one GOP, read lazily from an image folder
    (files sorted by name, as the JAX dataset orders them).  Indexing
    returns one [H, W, 3] float32 frame in [0, 1]; a 600-frame 1080p GOP
    never sits in memory at once."""

    def __init__(self, path):
        self._paths = sorted(p for p in pathlib.Path(path).iterdir()
                             if p.is_file())

    def __len__(self) -> int:
        return len(self._paths)

    def __getitem__(self, idx) -> np.ndarray:
        from PIL import Image

        img = Image.open(self._paths[idx]).convert("RGB")
        return np.asarray(img, dtype=np.float32) / 255.0
