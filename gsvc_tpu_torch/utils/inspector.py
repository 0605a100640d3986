"""Debug tensor inspector (port of gsvc_tpu/utils/inspector.py)."""

from __future__ import annotations

import inspect

import numpy as np
import torch


def check_tensor(x, name: str | None = None) -> str:
    """Print and return the shape, dtype, mean, std, min, max and NaN
    count of a numpy array or a torch tensor on any device, in the JAX
    package's format (the statistics are numpy's on a host copy, so the
    same values print the same line).

    Without ``name`` the caller's argument expression is the label."""
    if name is None:
        frame = inspect.currentframe().f_back
        ctx = inspect.getframeinfo(frame).code_context
        if ctx:
            call = ctx[0].strip()
            lo = call.find("check_tensor(") + len("check_tensor(")
            hi = call.rfind(")")
            name = call[lo:hi] or "tensor"
        else:
            name = "tensor"
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    a = np.asarray(x)
    n_nan = int(np.isnan(a).sum()) if np.issubdtype(a.dtype, np.floating) \
        else 0
    msg = (f"{name}: shape={a.shape} dtype={a.dtype} "
           f"mean={a.mean():.6g} std={a.std():.6g} "
           f"min={a.min():.6g} max={a.max():.6g} nan={n_nan}")
    print(msg)
    return msg
