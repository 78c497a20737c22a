"""Minimal device kernel demo, the port of ``examples/vadd.py`` (vadd.cl /
simple.cpp): an elementwise vector add, once as plain PyTorch and once by
the hand-written kernel ``vadd_pallas`` (``csrc/vadd.cu``; its plain version
on the CPU).

    python -m dwarf_bench_tpu_torch.examples.vadd [--device=cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops.vadd_cuda import vadd_pallas
from . import parse_device


def main(argv=None) -> int:
    device = parse_device(argv, __doc__.splitlines()[0])
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((8, 128), dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal((8, 128), dtype=np.float32))
    a, b = a.to(device), b.to(device)
    out = a + b
    plain_ok = bool(torch.allclose(out, a + b))
    print("xla vadd ok:", plain_ok)
    kernel_ok = bool(torch.equal(vadd_pallas(a, b), out))
    print("pallas vadd ok:", kernel_ok)
    return 0 if plain_ok and kernel_ok else 1


if __name__ == "__main__":
    sys.exit(main())
