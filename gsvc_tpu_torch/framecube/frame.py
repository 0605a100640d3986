"""Frame-cube geometry and ground-truth frames.

A video is a 3D volume: frame width -> x, height -> y, time -> z, in an
NDC-like box (port of ``gsvc_tpu/framecube/frame.py``; reference:
frame_cube/frame.py:65-190).  ``scale = max(H, W, T) / 2`` and frame
``i`` sits at ``z = (i - T/2) / scale``.

``FrameCubeDataset`` holds one GOP's frames (and optical-flow pickles):
in memory — a uint8 [T, H, W, 3] stack stays uint8, the form the fitter
keeps on the device (600 1080p frames are 3.7 GB as uint8, 15 GB as
float32) — or decoded from a folder of PNG/JPG files, cached under
``<folder>/.cube_cache/`` as uint8 so a relaunch skips the decode.
"""

from __future__ import annotations

import json
import pathlib
import pickle
from typing import List, Optional, Union

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


class _LazyF32Frames:
    """Per-item float32 view over a compact (uint8/float16) frame stack:
    one frame is converted at a time, on access."""

    def __init__(self, raw: np.ndarray, divisor: float = 1.0):
        self._raw = raw
        self._div = divisor

    @property
    def shape(self):
        return self._raw.shape

    def __len__(self) -> int:
        return len(self._raw)

    def __getitem__(self, idx):
        out = np.asarray(self._raw[idx], np.float32)
        if self._div != 1.0:
            out = out / self._div   # divide (not mul-by-inverse): bit-
        return out                  # identical to the uncached loader


class FrameCubeDataset:
    """All frames (and optical-flow pickles) of one GOP (port of
    ``gsvc_tpu.framecube.FrameCubeDataset``).

    In memory: ``images`` [T, H, W, 3] — uint8 is kept as ``images_u8``
    with ``images`` a lazy per-frame float32 view; float arrays are kept
    as float32.  From a folder: frames sorted by name, decoded to uint8
    (cached under ``.cube_cache/`` when ``cache``); flows are [2, H, W]
    backward flow pickles, one per frame pair."""

    _CACHE_VERSION = 1

    def __init__(self, main_dir: Union[str, pathlib.Path, None] = None,
                 optical_flow_dir: Union[str, pathlib.Path, None] = None,
                 images: Optional[np.ndarray] = None,
                 flows: Optional[np.ndarray] = None,
                 prefetch: bool = True, cache: bool = True):
        self.images_u8: Optional[np.ndarray] = None
        self.flows_raw: Optional[np.ndarray] = None
        self._paths: List[pathlib.Path] = []
        self._flow_paths: List[pathlib.Path] = []
        if images is not None:
            if getattr(images, "dtype", None) == np.uint8:
                self.images_u8 = images
                self.images = _LazyF32Frames(images, 255.0)
            else:
                self.images = np.asarray(images, dtype=np.float32)
            self.flows = (None if flows is None
                          else np.asarray(flows, np.float32))
            t, h, w = images.shape[0], images.shape[1], images.shape[2]
        else:
            main_dir = pathlib.Path(main_dir)
            self._paths = sorted(p for p in main_dir.iterdir()
                                 if p.is_file())
            if optical_flow_dir:
                self._flow_paths = sorted(
                    p for p in pathlib.Path(optical_flow_dir).iterdir()
                    if p.is_file())
            first = self._load_image(self._paths[0])
            t, h, w = len(self._paths), first.shape[0], first.shape[1]
            self.images = None
            self.flows = None
            if prefetch:
                u8, flow_raw = (self._load_cached(main_dir) if cache
                                else (None, None))
                if u8 is None:
                    u8, flow_raw = self._decode_all(
                        main_dir if cache else None)
                self.images_u8 = u8
                self.images = _LazyF32Frames(u8, 255.0)
                if flow_raw is not None:
                    self.flows_raw = flow_raw
                    self.flows = _LazyF32Frames(flow_raw)
        self.height = h
        self.width = w
        self.num_frames = t
        self.scale, self.x_min, self.y_min, self.z_min = frame_geometry(
            w, h, t)

    def __len__(self) -> int:
        return self.num_frames

    # -- IO -----------------------------------------------------------------
    def _manifest(self) -> dict:
        return {
            "version": self._CACHE_VERSION,
            "frames": [[p.name, p.stat().st_size] for p in self._paths],
            "flows": [[p.name, p.stat().st_size] for p in self._flow_paths],
        }

    def _load_cached(self, main_dir: pathlib.Path):
        """(img_u8, flow_raw) memory maps if a valid cache exists."""
        cdir = main_dir / ".cube_cache"
        man = cdir / "manifest.json"
        if not man.exists():
            return None, None
        try:
            saved = json.loads(man.read_text())
        except (OSError, ValueError):
            return None, None
        if saved != self._manifest():
            return None, None
        try:
            u8 = np.load(cdir / "img_u8.npy", mmap_mode="r")
            flow = (np.load(cdir / "flow.npy", mmap_mode="r")
                    if self._flow_paths else None)
        except (OSError, ValueError):
            return None, None
        return u8, flow

    def _decode_all(self, cache_root: Optional[pathlib.Path]):
        """Decode every frame (uint8) and flow (native precision); with
        ``cache_root``, persist them under ``.cube_cache/`` (temporary
        file, rename, manifest last: an interrupted build never looks
        valid)."""
        from numpy.lib.format import open_memmap
        from PIL import Image

        cdir = None
        if cache_root is not None:
            cdir = cache_root / ".cube_cache"
            cdir.mkdir(exist_ok=True)
        with Image.open(self._paths[0]) as im0:
            w, h = im0.size
        t = len(self._paths)
        if cdir is not None:
            u8 = open_memmap(cdir / "img_u8.npy.tmp", mode="w+",
                             dtype=np.uint8, shape=(t, h, w, 3))
        else:
            u8 = np.empty((t, h, w, 3), np.uint8)
        for i, p in enumerate(self._paths):
            with Image.open(p) as im:
                u8[i] = np.asarray(im.convert("RGB"), np.uint8)

        flow = None
        if self._flow_paths:
            f0 = self._load_flow_raw(self._flow_paths[0])
            fdtype = np.float16 if f0.dtype == np.float16 else np.float32
            fshape = (len(self._flow_paths),) + f0.shape
            if cdir is not None:
                flow = open_memmap(cdir / "flow.npy.tmp", mode="w+",
                                   dtype=fdtype, shape=fshape)
            else:
                flow = np.empty(fshape, fdtype)
            flow[0] = f0
            for i, p in enumerate(self._flow_paths[1:], start=1):
                flow[i] = self._load_flow_raw(p)

        if cdir is not None:
            u8.flush()
            (cdir / "img_u8.npy.tmp").rename(cdir / "img_u8.npy")
            if flow is not None:
                flow.flush()
                (cdir / "flow.npy.tmp").rename(cdir / "flow.npy")
            (cdir / "manifest.json").write_text(json.dumps(self._manifest()))
            u8 = np.load(cdir / "img_u8.npy", mmap_mode="r")
            if flow is not None:
                flow = np.load(cdir / "flow.npy", mmap_mode="r")
        return u8, flow

    @staticmethod
    def _load_flow_raw(path: pathlib.Path) -> np.ndarray:
        # flow pickles are the user's own input files, as in the JAX package
        with open(path, "rb") as f:
            return np.asarray(pickle.load(f))

    @staticmethod
    def _load_image(path: pathlib.Path) -> np.ndarray:
        from PIL import Image

        with Image.open(path) as img:
            return np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0
