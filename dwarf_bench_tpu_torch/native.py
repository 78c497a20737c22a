"""ctypes binding for the native group-by oracle (native/liboracles.cpp), as
``dwarf_bench_tpu/native.py`` loads it. Falls back to numpy when the shared
library has not been built (``make -C native``) or does not load on this
host: functional parity, just slower at large sizes.

Only the oracle the ported dwarfs use is bound. The CSR-join validation of
the JAX package (a per-row Python loop) is replaced by a vectorized exact
check in ``dwarfs/join.py``.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "native",
    "liboracles.so",
)

_lib: Optional[ctypes.CDLL] = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:  # built for another host; the numpy path still holds
        return None
    i64, u32p = ctypes.c_int64, ctypes.POINTER(ctypes.c_uint32)
    lib.oracle_groupby_sum_u32.argtypes = [u32p, u32p, i64, u32p, i64]
    lib.oracle_groupby_sum_u32.restype = None
    _lib = lib
    return lib


def _p(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def groupby_sum(keys, vals, groups: int) -> np.ndarray:
    """(groups,) uint32 sums of vals per key, wrapping mod 2^32."""
    k = np.ascontiguousarray(keys, np.uint32)
    v = np.ascontiguousarray(vals, np.uint32)
    out = np.zeros(groups, np.uint32)
    lib = _load()
    if lib is not None:
        lib.oracle_groupby_sum_u32(
            _p(k, ctypes.c_uint32), _p(v, ctypes.c_uint32), len(k),
            _p(out, ctypes.c_uint32), groups,
        )
        return out
    np.add.at(out, k.astype(np.int64), v)
    return out
