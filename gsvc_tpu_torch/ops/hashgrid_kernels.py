"""Kernels B3f (forward) and B3b (backward) of the port — the Mix3d2d
hash-grid encode — their launchers, the wrappers that count launches and
the autograd function ``mix_grid_encode_kernel`` around them.

Counterpart of ``gsvc_tpu/ops/pallas_hashgrid.py`` (``_fwd_kernel`` :270,
``_bwd_kernel`` :295, ``mix_grid_encode_lanegather`` :486).  The kernels
(``csrc/hashgrid_fwd.cu``, ``csrc/hashgrid_bwd.cu``) compute what the
plain ``ops/hashgrid.py:mix_grid_encode`` computes, straight from the flat
[rows, F] table, two lanes a query at F = 8, over the level-instances:
the 3D grid's levels, then the xy, xz and yz planes' levels
(``instance_table``), so the output columns are ``mix_grid_encode``'s.
B3f's blocks each take one instance of 64 queries; B3b's take 32
z-consecutive queries with every instance, add the table gradient with
atomics (its summation order changes from run to run) and sum each
query's position gradient over the instances in a fixed order, writing
``dL/dx`` themselves.  The TPU kernel's lane-packed tables
(``pack_tables``, ``_seg_reduce``) and one-hot matmul scatter are TPU
workarounds and are not carried over.

What a launch needs that depends on the spec and the device alone is
built once per (spec, device) (``launch_plan``); a call checks only its
tensors.

CUDA tensors launch the kernels (and add one to ``hashgrid_forward.
launches`` / ``hashgrid_backward.launches``); CPU tensors take the plain
versions (``mix_grid_encode`` and its autograd gradient); any other
device raises.  A failed build or launch raises: nothing falls back.
"""

from __future__ import annotations

import ctypes
from collections import OrderedDict

import numpy as np
import torch

from gsvc_tpu_torch.build import load
from gsvc_tpu_torch.ops.hashgrid import MixGridSpec, mix_grid_encode

_FEATURES = (2, 4, 8)


def instance_table(spec: MixGridSpec) -> np.ndarray:
    """int32 [n_inst, 9]: (res, size, first row, ndim, dims[3], use_hash,
    mask) per level-instance, in ``mix_grid_encode``'s column order.
    ``mask`` is ``size - 1`` in a hashed level, whose size must be a power
    of two (``h % size == h & mask``), and 0 in a dense one."""
    rows = []
    g3, g2 = spec.grid_3d, spec.grid_2d
    levels = [(g3, lvl, g3.level_offsets[lvl], (0, 1, 2))
              for lvl in range(g3.n_levels)]
    for plane, dims in enumerate(((0, 1, 0), (0, 2, 0), (1, 2, 0))):
        base = g3.total_rows + plane * g2.total_rows
        levels += [(g2, lvl, base + g2.level_offsets[lvl], dims)
                   for lvl in range(g2.n_levels)]
    for grid, lvl, offset, dims in levels:
        res, size = grid.resolutions[lvl], grid.level_sizes[lvl]
        use_hash = res ** grid.num_dim > size
        if use_hash and size & (size - 1):
            raise ValueError(f"hashed level of resolution {res}: size {size} "
                             f"is not a power of two")
        rows.append((res, size, offset, grid.num_dim, *dims, int(use_hash),
                     size - 1 if use_hash else 0))
    return np.asarray(rows, np.int32)


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

def _fn(lib: str, name: str, n_ptrs: int, n_ints: int):
    fn = getattr(load(lib), name)
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.restype = ci
        fn.argtypes = [vp] * n_ptrs + [ci] * n_ints + [vp]
    return fn


class LaunchPlan:
    """What a launch of B3f/B3b needs that depends only on the spec and
    the device, built once per (spec, device) by ``launch_plan``: the
    instance table on the card, n_inst and F, the table's shape and the
    ctypes functions.  Building it checks F and the 32-bit row index."""

    def __init__(self, spec: MixGridSpec, device: int):
        f = spec.n_features
        if f not in _FEATURES:
            raise ValueError(f"the hash-grid kernels take F in {_FEATURES}, "
                             f"got {f}")
        if spec.total_rows * f >= 2 ** 31:
            raise ValueError(f"the hash-grid kernels index the table in 32 "
                             f"bits: {spec.total_rows} rows x {f} features "
                             f">= 2^31")
        self.spec, self.device = spec, device
        meta = instance_table(spec)
        self.n_inst, self.f = meta.shape[0], f
        self.table_shape = (spec.total_rows, f)
        self.out_dim = self.n_inst * f
        self.meta = torch.from_numpy(meta).to(f"cuda:{device}")
        self.fwd = _fn("hashgrid_fwd", "hashgrid_forward", 4, 3)
        self.bwd = _fn("hashgrid_bwd", "hashgrid_backward", 6, 4)


_PLANS_KEPT = 16
_plans: "OrderedDict[tuple, LaunchPlan]" = OrderedDict()


def launch_plan(spec: MixGridSpec, device: int) -> LaunchPlan:
    """The (spec, device)'s plan, built at its first use (counted in
    ``launch_plan.built``); the ``_PLANS_KEPT`` most recently used are
    kept.  Keyed by the spec's identity, so no call hashes the dataclass;
    a kept plan holds its spec, so the spec's id cannot be reused while
    the key is in the cache."""
    key = (id(spec), device)
    plan = _plans.get(key)
    if plan is None:
        plan = _plans[key] = LaunchPlan(spec, device)
        launch_plan.built += 1
        if len(_plans) > _PLANS_KEPT:
            _plans.popitem(last=False)
    else:
        _plans.move_to_end(key)
    return plan


launch_plan.built = 0


def _cuda_inputs(table, x, spec):
    """The plan and the call's tensors after the checks that depend on
    them: float32 CUDA tensors on one device, shapes, contiguity, 16-byte
    aligned rows."""
    if not (x.is_cuda and table.is_cuda):
        raise ValueError("the hash-grid kernels take CUDA tensors")
    device = x.get_device()
    plan = launch_plan(spec, device)
    if table.get_device() != device:
        raise ValueError(f"table on {table.device}, x on {x.device}")
    if x.dtype != torch.float32 or table.dtype != torch.float32:
        raise ValueError(f"the hash-grid kernels take float32, got table "
                         f"{table.dtype}, x {x.dtype}")
    if table.shape != plan.table_shape:
        raise ValueError(f"table: expected {plan.table_shape}, got "
                         f"{tuple(table.shape)}")
    if x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"x: expected [N, 3], got {tuple(x.shape)}")
    table = table.contiguous()
    if table.data_ptr() % 16:
        table = table.clone()      # float4 rows need 16-byte alignment
    return plan, table, x.contiguous()


def _stream(device: int) -> int:
    """The raw handle of ``device``'s current stream: PyTorch's own
    accessor (the one its compiled kernels launch with), which builds no
    ``torch.cuda.Stream`` object on every call."""
    return torch._C._cuda_getCurrentRawStream(device)


def _launch(fn, device: int, *args):
    if device == torch.cuda.current_device():
        err = fn(*args, _stream(device))
    else:
        with torch.cuda.device(device):
            err = fn(*args, _stream(device))
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")


def hashgrid_fwd_cuda(table, x, spec: MixGridSpec):
    """Launch kernel B3f once: [N, output_dim]."""
    plan, table, x = _cuda_inputs(table, x, spec)
    n = x.shape[0]
    out = torch.empty((n, plan.out_dim), dtype=torch.float32, device=x.device)
    _launch(plan.fwd, plan.device, table.data_ptr(), x.data_ptr(),
            plan.meta.data_ptr(), out.data_ptr(), n, plan.n_inst, plan.f)
    return out


def hashgrid_bwd_cuda(table, x, g_out, spec: MixGridSpec):
    """Launch kernel B3b once: (g_table [rows, F], g_x [N, 3]).  The
    launcher zeroes the table gradient (one memset on the stream) before
    the kernel adds to it; the kernel writes every row of g_x."""
    plan, table, x = _cuda_inputs(table, x, spec)
    n = x.shape[0]
    if (g_out.dtype != torch.float32 or g_out.shape != (n, plan.out_dim)
            or g_out.get_device() != plan.device):
        raise ValueError(f"g_out: expected float32 {(n, plan.out_dim)} on "
                         f"{x.device}, got {g_out.dtype} "
                         f"{tuple(g_out.shape)} on {g_out.device}")
    g_out = g_out.contiguous()
    if g_out.data_ptr() % 16:
        g_out = g_out.clone()      # read as float4 rows
    g_table = torch.empty_like(table)
    g_x = torch.empty((n, 3), dtype=torch.float32, device=x.device)
    _launch(plan.bwd, plan.device, table.data_ptr(), x.data_ptr(),
            g_out.data_ptr(), plan.meta.data_ptr(), g_table.data_ptr(),
            g_x.data_ptr(), plan.table_shape[0], n, plan.n_inst, plan.f)
    return g_table, g_x


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
