"""Kernels B3f (forward) and B3b (backward) of the port — the Mix3d2d
hash-grid encode — their launchers, the wrappers that count launches and
the autograd function ``mix_grid_encode_kernel`` around them.

Counterpart of ``gsvc_tpu/ops/pallas_hashgrid.py`` (``_fwd_kernel`` :270,
``_bwd_kernel`` :295, ``mix_grid_encode_lanegather`` :486).  The kernels
(``csrc/hashgrid_fwd.cu``, ``csrc/hashgrid_bwd.cu``) compute what the
plain ``ops/hashgrid.py:mix_grid_encode`` computes, straight from the flat
[rows, F] table: one thread per (query, level-instance), the instances
being the 3D grid's levels, then the xy, xz and yz planes' levels
(``instance_table``), so the output columns are ``mix_grid_encode``'s.
The TPU kernel's lane-packed tables (``pack_tables``, ``_seg_reduce``) and
one-hot matmul scatter are TPU workarounds and are not carried over.

B3b adds the table gradient with atomics (its summation order changes
from run to run) and writes each instance's position gradient to its own
row of ``[n_inst, N, 3]``; one sum over the instances after the kernel
gives ``dL/dx``.

CUDA tensors launch the kernels (and add one to ``hashgrid_forward.
launches`` / ``hashgrid_backward.launches``); CPU tensors take the plain
versions (``mix_grid_encode`` and its autograd gradient); any other
device raises.  A failed build or launch raises: nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from gsvc_tpu_torch.build import load
from gsvc_tpu_torch.ops.hashgrid import MixGridSpec, mix_grid_encode

_FEATURES = (2, 4, 8)


def instance_table(spec: MixGridSpec) -> np.ndarray:
    """int32 [n_inst, 8]: (res, size, first row, ndim, dims[3], use_hash)
    per level-instance, in ``mix_grid_encode``'s column order."""
    rows = []
    g3, g2 = spec.grid_3d, spec.grid_2d
    for lvl in range(g3.n_levels):
        res, size = g3.resolutions[lvl], g3.level_sizes[lvl]
        rows.append((res, size, g3.level_offsets[lvl], 3, 0, 1, 2,
                     int(res ** 3 > size)))
    for plane, (a, b) in enumerate(((0, 1), (0, 2), (1, 2))):
        base = g3.total_rows + plane * g2.total_rows
        for lvl in range(g2.n_levels):
            res, size = g2.resolutions[lvl], g2.level_sizes[lvl]
            rows.append((res, size, base + g2.level_offsets[lvl], 2, a, b, 0,
                         int(res ** 2 > size)))
    return np.asarray(rows, np.int32)


@functools.lru_cache(maxsize=16)
def _meta(spec: MixGridSpec, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(instance_table(spec)).to(device)


def _check(table, x, spec: MixGridSpec):
    if table.dtype != x.dtype:
        raise ValueError(f"table {table.dtype}, x {x.dtype}")
    if tuple(table.shape) != (spec.total_rows, spec.n_features):
        raise ValueError(f"table: expected {(spec.total_rows, spec.n_features)}"
                         f", got {tuple(table.shape)}")
    if x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"x: expected [N, 3], got {tuple(x.shape)}")
    if table.device != x.device:
        raise ValueError(f"table on {table.device}, x on {x.device}")


# ---------------------------------------------------------------------------
# Kernel launchers (CUDA tensors)
# ---------------------------------------------------------------------------

def _fn(lib: str, name: str, n_ptrs: int):
    fn = getattr(load(lib), name)
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.restype = ci
        fn.argtypes = [vp] * n_ptrs + [ci] * 3 + [vp]
    return fn


def _cuda_inputs(table, x, spec):
    _check(table, x, spec)
    if not (table.is_cuda and x.is_cuda):
        raise ValueError("the hash-grid kernels take CUDA tensors")
    if x.dtype != torch.float32:
        raise ValueError(f"the hash-grid kernels take float32, got {x.dtype}")
    if spec.n_features not in _FEATURES:
        raise ValueError(f"the hash-grid kernels take F in {_FEATURES}, got "
                         f"{spec.n_features}")
    table = table.contiguous()
    if table.data_ptr() % 16:
        table = table.clone()      # float4 rows need 16-byte alignment
    return table, x.contiguous(), _meta(spec, x.device)


def _check_err(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def hashgrid_fwd_cuda(table, x, spec: MixGridSpec):
    """Launch kernel B3f once: [N, output_dim]."""
    table, x, meta = _cuda_inputs(table, x, spec)
    n, n_inst = x.shape[0], meta.shape[0]
    out = torch.empty((n, n_inst * spec.n_features), dtype=torch.float32,
                      device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _fn("hashgrid_fwd", "hashgrid_forward", 4)(
            table.data_ptr(), x.data_ptr(), meta.data_ptr(), out.data_ptr(),
            n, n_inst, spec.n_features, stream)
    _check_err(err, "hashgrid_forward")
    return out


def hashgrid_bwd_cuda(table, x, g_out, spec: MixGridSpec):
    """Launch kernel B3b once: (g_table [rows, F], g_x [N, 3])."""
    table, x, meta = _cuda_inputs(table, x, spec)
    n, n_inst = x.shape[0], meta.shape[0]
    if g_out.dtype != torch.float32 or tuple(g_out.shape) != (
            n, n_inst * spec.n_features):
        raise ValueError(f"g_out: expected float32 {(n, n_inst * spec.n_features)}"
                         f", got {g_out.dtype} {tuple(g_out.shape)}")
    g_out = g_out.contiguous()
    g_table = torch.zeros_like(table)
    gx_part = torch.empty((n_inst, n, 3), dtype=torch.float32,
                          device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _fn("hashgrid_bwd", "hashgrid_backward", 6)(
            table.data_ptr(), x.data_ptr(), g_out.data_ptr(), meta.data_ptr(),
            g_table.data_ptr(), gx_part.data_ptr(), n, n_inst,
            spec.n_features, stream)
    _check_err(err, "hashgrid_backward")
    return g_table, gx_part.sum(dim=0)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def hashgrid_fwd_plain(table, x, spec: MixGridSpec):
    """Kernel B3f's function in plain PyTorch."""
    _check(table, x, spec)
    with torch.no_grad():
        return mix_grid_encode(table, x, spec)


def hashgrid_bwd_plain(table, x, g_out, spec: MixGridSpec):
    """Kernel B3b's function in plain PyTorch: the autograd gradient of
    ``mix_grid_encode`` (its gathers' transpose is an index add)."""
    _check(table, x, spec)
    with torch.enable_grad():
        t = table.detach().requires_grad_(True)
        xx = x.detach().requires_grad_(True)
        out = mix_grid_encode(t, xx, spec)
        return torch.autograd.grad(out, (t, xx), g_out)


# ---------------------------------------------------------------------------
# Wrappers: kernel on CUDA tensors, plain version on CPU tensors
# ---------------------------------------------------------------------------

def hashgrid_forward(table, x, spec: MixGridSpec):
    """The encode [N, output_dim]: kernel B3f on CUDA tensors (adding one
    to ``hashgrid_forward.launches``), the plain version on CPU tensors."""
    if x.is_cuda:
        out = hashgrid_fwd_cuda(table, x, spec)
        hashgrid_forward.launches += 1
        return out
    if x.device.type == "cpu":
        return hashgrid_fwd_plain(table, x, spec)
    raise ValueError(f"hashgrid_forward: unsupported device {x.device}")


hashgrid_forward.launches = 0


def hashgrid_backward(table, x, g_out, spec: MixGridSpec):
    """(g_table, g_x): kernel B3b on CUDA tensors (adding one to
    ``hashgrid_backward.launches``), the plain version on CPU tensors."""
    if x.is_cuda:
        res = hashgrid_bwd_cuda(table, x, g_out, spec)
        hashgrid_backward.launches += 1
        return res
    if x.device.type == "cpu":
        return hashgrid_bwd_plain(table, x, g_out, spec)
    raise ValueError(f"hashgrid_backward: unsupported device {x.device}")


hashgrid_backward.launches = 0


class _MixGridEncode(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table, x, spec, timer):
        if timer is not None:
            timer.mark("b3f_start")
        out = hashgrid_forward(table, x, spec)
        if timer is not None:
            timer.mark("b3f_end")
        ctx.spec, ctx.timer = spec, timer
        ctx.save_for_backward(table, x)
        return out

    @staticmethod
    def backward(ctx, g_out):
        table, x = ctx.saved_tensors
        if ctx.timer is not None:
            ctx.timer.mark("b3b_start")
        g_table, g_x = hashgrid_backward(table, x, g_out.contiguous(),
                                         ctx.spec)
        if ctx.timer is not None:
            ctx.timer.mark("b3b_end")
        return g_table, g_x, None, None


def mix_grid_encode_kernel(params, x, spec: MixGridSpec, binarize=None,
                           timer=None):
    """Drop-in for ``ops/hashgrid.py:mix_grid_encode`` through kernels
    B3f/B3b, differentiable in the table and the positions.  ``binarize``
    (optional) is applied to the table in PyTorch first; ``timer``
    (optional, with ``mark(name)``) is marked around each kernel."""
    if binarize is not None:
        params = binarize(params)
    return _MixGridEncode.apply(params, x, spec, timer)
