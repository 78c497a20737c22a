"""Sum reduction (``dwarf_bench_tpu/ops/reduce.py``).

Reference: reduce/reduce.cpp:50-61, a work-group tree reduction. The int32
sum wraps mod 2^32 like the reference's ``int`` sum; addition mod 2^32 does
not depend on order, so every engine and the numpy oracle agree bit for bit.

Two engines, as in the JAX package: ``reduce_sum_xla``, the plain PyTorch
sum, and ``reduce_sum_pallas``, the hand-written kernel (``csrc/reduce.cu``).
``reduce_sum`` launches the kernel for a CUDA tensor. The JAX package picks
XLA's sum there because of a TPU measurement (reduce.py:77-86), which says
nothing about the card; PERF.md records both engines' times on the H100.
"""

from __future__ import annotations

import numpy as np

from .reduce_cuda import reduce_sum as reduce_sum_pallas
from .reduce_cuda import reduce_sum_plain as reduce_sum_xla

__all__ = ["reduce_sum", "reduce_sum_pallas", "reduce_sum_xla",
           "reduce_oracle"]

# 0-d int32 sum mod 2^32: the kernel on a CUDA tensor, the plain sum on a
# CPU one
reduce_sum = reduce_sum_pallas


def reduce_oracle(x) -> int:
    """std::accumulate with an int accumulator (reduce/reduce.cpp:10-22)."""
    return int(np.sum(np.asarray(x, dtype=np.int32), dtype=np.int32))
