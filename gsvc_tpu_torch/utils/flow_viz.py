"""Optical-flow colouring through the Middlebury colour wheel (port of
gsvc_tpu/utils/flow_viz.py; numpy, output equal to the JAX package's).
``cli/debug_vis.py`` colours gaussian motion and the dataset's flow field
with it."""

from __future__ import annotations

import numpy as np


def _color_wheel() -> np.ndarray:
    """[55, 3] float64 wheel: red-yellow-green-cyan-blue-magenta ramps."""
    ry, yg, gc, cb, bm, mr = 15, 6, 4, 11, 13, 6
    ncols = ry + yg + gc + cb + bm + mr
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[:ry, 0] = 255
    wheel[:ry, 1] = np.floor(255 * np.arange(ry) / ry)
    col += ry
    wheel[col:col + yg, 0] = 255 - np.floor(255 * np.arange(yg) / yg)
    wheel[col:col + yg, 1] = 255
    col += yg
    wheel[col:col + gc, 1] = 255
    wheel[col:col + gc, 2] = np.floor(255 * np.arange(gc) / gc)
    col += gc
    wheel[col:col + cb, 1] = 255 - np.floor(255 * np.arange(cb) / cb)
    wheel[col:col + cb, 2] = 255
    col += cb
    wheel[col:col + bm, 2] = 255
    wheel[col:col + bm, 0] = np.floor(255 * np.arange(bm) / bm)
    col += bm
    wheel[col:col + mr, 2] = 255 - np.floor(255 * np.arange(mr) / mr)
    wheel[col:col + mr, 0] = 255
    return wheel


def flow_to_image(u: np.ndarray, v: np.ndarray,
                  max_flow: float | None = None) -> np.ndarray:
    """[H, W] u/v components -> [H, W, 3] uint8 Middlebury colouring."""
    wheel = _color_wheel()
    ncols = wheel.shape[0]
    rad = np.sqrt(u ** 2 + v ** 2)
    maxrad = max_flow if max_flow else max(float(rad.max()), 1e-6)
    un, vn = u / maxrad, v / maxrad
    rad = np.sqrt(un ** 2 + vn ** 2)
    a = np.arctan2(-vn, -un) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = fk - k0
    img = np.zeros(u.shape + (3,), np.uint8)
    for c in range(3):
        col0 = wheel[k0, c] / 255
        col1 = wheel[k1, c] / 255
        col = (1 - f) * col0 + f * col1
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] = col[~idx] * 0.75
        img[..., c] = np.floor(255 * col)
    return img
