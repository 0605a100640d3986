"""Restricted unpickling of the bitstream's pickled side info.

``meta.bin`` holds a pickled ``gsvc_tpu.codec.bitstream.EncodeMeta``; a
plain ``pickle.loads`` would import the JAX package to find that class.
This unpickler maps it to the port's ``EncodeMeta`` and admits numpy's
array reconstruction and nothing else: any other global raises
``pickle.UnpicklingError``.  ``mlp.pkl`` and its zlib'd ``meta`` go
through the same loader (their globals are numpy's alone).
"""

from __future__ import annotations

import io
import pickle

import numpy as np

try:
    from numpy._core.multiarray import _reconstruct
except ImportError:  # numpy < 2
    from numpy.core.multiarray import _reconstruct

_NUMPY = {
    ("numpy._core.multiarray", "_reconstruct"): _reconstruct,
    ("numpy.core.multiarray", "_reconstruct"): _reconstruct,
    ("numpy", "ndarray"): np.ndarray,
    ("numpy", "dtype"): np.dtype,
}
META_CLASS = ("gsvc_tpu.codec.bitstream", "EncodeMeta")


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == META_CLASS:
            from gsvc_tpu_torch.codec.bitstream import EncodeMeta

            return EncodeMeta
        found = _NUMPY.get((module, name))
        if found is None:
            raise pickle.UnpicklingError(
                f"global {module}.{name} is not allowed in a bitstream")
        return found


def restricted_loads(data: bytes):
    return _Unpickler(io.BytesIO(data)).load()
