"""ctypes bindings of the repo's C++ host codec (``csrc/gsvc_codec.cpp``):
the encode and decode entry points (port of gsvc_tpu/codec/native.py).

The library is built into the port's own build directory
(``gsvc_tpu_torch/build.py``), never next to the source.  Entry points
take and return NumPy arrays; streams are ``bytes``.
"""

from __future__ import annotations

import ctypes

import numpy as np

from gsvc_tpu_torch.build import load

_bound = False


def _lib():
    global _bound
    lib = load("gsvc_codec")
    if not _bound:
        ll = ctypes.c_longlong
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
        lib.ans_encode_gaussian.restype = ll
        lib.ans_encode_gaussian.argtypes = [i32p, f64p, f64p, ll, ll, ll,
                                            u8p, ll]
        lib.ans_encode_binary.restype = ll
        lib.ans_encode_binary.argtypes = [u8p, f64p, ll, u8p, ll]
        lib.octree_encode.restype = ll
        lib.octree_encode.argtypes = [u32p, ll, ctypes.c_int, u8p, ll]
        lib.octree_sort_indices.restype = None
        lib.octree_sort_indices.argtypes = [u32p, ll, ctypes.c_int, i64p]
        lib.ans_decode_gaussian.restype = ll
        lib.ans_decode_gaussian.argtypes = [u8p, ll, f64p, f64p, ll, ll, ll,
                                            i32p]
        lib.ans_decode_binary.restype = ll
        lib.ans_decode_binary.argtypes = [u8p, ll, f64p, ll, u8p]
        lib.octree_decode.restype = ll
        lib.octree_decode.argtypes = [u8p, ll, ll, ctypes.c_int, u32p]
        _bound = True
    return lib


def _stream(data: bytes) -> np.ndarray:
    return np.ascontiguousarray(np.frombuffer(data, np.uint8))


def encode_gaussian_symbols(symbols, mu, sigma, min_s: int,
                            max_s: int) -> bytes:
    """rANS-encode int32 ``symbols`` [N] against per-element gaussians;
    ``mu``/``sigma`` float64 [N] in symbol units (already divided by Q)."""
    lib = _lib()
    symbols = np.ascontiguousarray(symbols, np.int32)
    mu = np.ascontiguousarray(mu, np.float64)
    sigma = np.ascontiguousarray(sigma, np.float64)
    n = symbols.shape[0]
    cap = 16 + 8 * max(n, 2)
    out = np.empty(cap, np.uint8)
    written = lib.ans_encode_gaussian(symbols, mu, sigma, n, min_s, max_s,
                                      out, cap)
    if written < 0:
        raise ValueError(f"ans_encode_gaussian failed: {written}")
    return bytes(out[:written])


def decode_gaussian_symbols(stream: bytes, mu, sigma, min_s: int,
                            max_s: int) -> np.ndarray:
    """rANS-decode int32 symbols coded against per-element gaussians;
    ``mu``/``sigma`` float64 [N] in symbol units."""
    lib = _lib()
    mu = np.ascontiguousarray(mu, np.float64)
    sigma = np.ascontiguousarray(sigma, np.float64)
    if mu.shape != sigma.shape or mu.ndim != 1:
        raise ValueError(f"mu {mu.shape} and sigma {sigma.shape} must be "
                         f"equal-length vectors")
    n = mu.shape[0]
    buf = _stream(stream)
    out = np.empty(n, np.int32)
    got = lib.ans_decode_gaussian(buf, buf.shape[0], mu, sigma, n, min_s,
                                  max_s, out)
    if got != n:
        raise ValueError("ans_decode_gaussian failed")
    return out


def encode_binary(bits, p1) -> bytes:
    """Encode {0,1} uint8 ``bits`` [N]; ``p1`` is a scalar or [N]
    probability of 1."""
    lib = _lib()
    bits = np.ascontiguousarray(bits, np.uint8)
    n = bits.shape[0]
    p = np.ascontiguousarray(np.broadcast_to(np.asarray(p1, np.float64),
                                             (n,)))
    cap = 16 + max(n, 2)
    out = np.empty(cap, np.uint8)
    written = lib.ans_encode_binary(bits, p, n, out, cap)
    if written < 0:
        raise ValueError("ans_encode_binary failed")
    return bytes(out[:written])


def decode_binary(stream: bytes, n: int, p1) -> np.ndarray:
    """Decode ``n`` bits; ``p1`` is a scalar or [n] probability of 1."""
    lib = _lib()
    p = np.ascontiguousarray(np.broadcast_to(
        np.asarray(p1, np.float64), (n,)))
    buf = _stream(stream)
    out = np.empty(n, np.uint8)
    got = lib.ans_decode_binary(buf, buf.shape[0], p, n, out)
    if got != n:
        raise ValueError("ans_decode_binary failed")
    return out


def decode_octree(stream: bytes, n: int, depth: int = 16) -> np.ndarray:
    """uint32 [N, 3] quantized anchor coordinates in Morton order."""
    lib = _lib()
    buf = _stream(stream)
    out = np.empty(3 * n, np.uint32)
    got = lib.octree_decode(buf, buf.shape[0], n, depth, out)
    if got != n:
        raise ValueError(f"octree_decode returned {got} of {n}")
    return out.reshape(n, 3)


def encode_octree(xyz_q: np.ndarray, depth: int = 16) -> bytes:
    """Octree-code uint32 [N, 3] quantized coordinates (< 2**depth per
    axis)."""
    lib = _lib()
    flat = np.ascontiguousarray(xyz_q.reshape(-1), np.uint32)
    n = xyz_q.shape[0]
    # worst case: every point opens its own branch at every level
    cap = 1024 + 4 * max(n, 2) * depth
    out = np.empty(cap, np.uint8)
    written = lib.octree_encode(flat, n, depth, out, cap)
    if written < 0:
        raise ValueError("octree_encode overflow")
    return bytes(out[:written])


def morton_sort_indices(xyz_q: np.ndarray, depth: int = 16) -> np.ndarray:
    """``selection[i]``: the original index of the i-th point in decoder
    (Morton) order — the attribute-alignment permutation."""
    lib = _lib()
    flat = np.ascontiguousarray(xyz_q.reshape(-1), np.uint32)
    n = xyz_q.shape[0]
    out = np.empty(n, np.int64)
    lib.octree_sort_indices(flat, n, depth, out)
    return out
