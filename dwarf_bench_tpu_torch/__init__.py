"""dwarf_bench_tpu_torch: the dwarf_bench_tpu benchmark ported to PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package ``dwarf_bench_tpu`` is the reference this package is held
against; this package imports no JAX. Plain tensor code is PyTorch; every
function the JAX package wrote as a Pallas TPU kernel on the ported path is
a CUDA kernel under ``csrc/``, built with nvcc at first use
(``ops/_build.py``), with a plain PyTorch twin that CPU tensors take.
"""

from .api import (
    ApiDeviceType,
    DwarfBench,
    DwarfBenchException,
    DwarfKind,
    Measurement,
    RunConfig,
)
from .common import (
    DeviceType,
    Dwarf,
    GroupByRunOptions,
    Registry,
    RunOptions,
)
from .dwarfs import populate_registry

__version__ = "0.1.0"

__all__ = [
    "ApiDeviceType",
    "DwarfBench",
    "DwarfBenchException",
    "DwarfKind",
    "Measurement",
    "RunConfig",
    "DeviceType",
    "Dwarf",
    "GroupByRunOptions",
    "Registry",
    "RunOptions",
    "populate_registry",
    "__version__",
]
