"""Builds the port's native code at first use.

Two shared libraries with plain C interfaces, loaded with ``ctypes``:

  * ``csrc/gsvc_codec.cpp`` (the repo's host entropy codec) compiled by the
    host C++ compiler — the one ``nvcc`` drives (``g++`` on the PATH);
  * each ``gsvc_tpu_torch/csrc/*.cu`` kernel (with the shared headers
    ``composite.cuh`` and ``hashgrid.cuh``) compiled by ``nvcc`` for
    ``sm_90a`` (Hopper) with ``-O3 -shared -Xcompiler -fPIC``.

Nothing includes PyTorch's headers, so a build takes seconds.  Outputs
go to ``build/gsvc_tpu_torch/`` under the repo root (never next to the
sources) and are named by a hash of source and command, so a stale
library is never loaded and concurrent builds (parallel test workers) race
harmlessly: each compiles to a private temporary name and renames it
into place atomically.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, List

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]
BUILD_DIR = REPO_ROOT / "build" / "gsvc_tpu_torch"
CODEC_SRC = REPO_ROOT / "csrc" / "gsvc_codec.cpp"
KERNEL_DIR = pathlib.Path(__file__).resolve().parent / "csrc"
KERNELS = ("bidir", "mirror_fwd", "mirror_bwd", "hashgrid_fwd",
           "hashgrid_bwd")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _host_cxx() -> str:
    for name in ("g++", "c++"):
        path = shutil.which(name)
        if path:
            return path
    raise RuntimeError("no host C++ compiler (g++ or c++) on the PATH")


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path:
        return path
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (on the PATH or /usr/local/cuda/bin)")


def _source(name: str) -> pathlib.Path:
    if name == "gsvc_codec":
        return CODEC_SRC
    if name in KERNELS:
        return KERNEL_DIR / f"{name}.cu"
    raise KeyError(f"unknown native library {name!r}")


def _command(name: str, out: str) -> List[str]:
    if name == "gsvc_codec":
        return [_host_cxx(), "-O3", "-shared", "-fPIC", "-std=c++17",
                str(CODEC_SRC), "-o", out]
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", str(_source(name)), "-o", out]


def _target(name: str) -> pathlib.Path:
    """Content-addressed output path: hash of the source, the kernels'
    shared headers and the command."""
    h = hashlib.sha1(_source(name).read_bytes())
    if name in KERNELS:
        for header in sorted(KERNEL_DIR.glob("*.cuh")):
            h.update(header.read_bytes())
    h.update(" ".join(_command(name, "OUT")[1:]).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start compiling ``name`` unless its library exists.  Returns
    (target, Popen or None, temporary path)."""
    target = _target(name)
    if target.exists():
        return target, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(
        f"{target.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.Popen(_command(name, str(tmp)), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, proc, tmp


def _finish(name: str, target, proc, tmp) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"building {name} failed:\n{log}")
    os.replace(tmp, target)
    return log


def build() -> Dict[str, str]:
    """Compile the codec and every kernel, all compilers started
    together.  Returns each compiler's output (``nvcc -Xptxas -v``
    register/shared-memory report; empty when the library was already
    built)."""
    started = {n: _start(n) for n in ("gsvc_codec", *KERNELS)}
    return {n: _finish(n, *started[n]) for n in started}


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, building it first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            target, proc, tmp = _start(name)
            _finish(name, target, proc, tmp)
            lib = ctypes.CDLL(str(target))
            _libs[name] = lib
    return lib

