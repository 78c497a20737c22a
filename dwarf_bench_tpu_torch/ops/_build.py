"""Build, load and launch the hand-written CUDA kernels in ``csrc/``.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, at first use, and loaded with
ctypes. The library is cached under ``dwarf_bench_tpu_torch/build/`` (which
``.gitignore`` covers through its ``build/`` line), named by a hash of the
sources and the flags, so an edited source builds anew. A failed build
raises; nothing falls back.

Each C entry point returns ``cudaGetLastError()`` after its launches, and
``launch`` raises on anything but 0: a launch the card refuses (too much
shared memory, too many threads) never runs, and ``torch.cuda.synchronize``
would not report it.

``LAUNCHES`` counts, per kernel, the launches the wrappers in
``ops/*_cuda.py`` made, so a run can show which kernels its path went
through. Each wrapper adds one where it launches its kernel, and nowhere
else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time
from typing import Dict, Optional

import torch

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64

# name -> (argtypes, restype). Every pointer and the stream are c_void_p:
# without argtypes ctypes would pass a Python int as a 32-bit C int.
_SIGNATURES = {
    "dbt_histogram": ([_P, _I64, _P, _I32, _P], ctypes.c_int),
    "dbt_weighted_histogram": ([_P, _P, _I64, _P, _I32, _P], ctypes.c_int),
    "dbt_groupby_small": ([_P, _P, _I64, _P, _I32, _P], ctypes.c_int),
    "dbt_cumsum": ([_P, _I64, _P, _P, _P, _P], ctypes.c_int),
    "dbt_cumsum_scratch": ([_I64], _I64),
    "dbt_error_string": ([ctypes.c_int], ctypes.c_char_p),
}

LAUNCHES: Dict[str, int] = {
    "histogram": 0,
    "cumsum": 0,
    "groupby_small": 0,
    "weighted_histogram": 0,
}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # set when this process compiled


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "dwarf_bench_tpu_torch cannot be built"
    )


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile csrc/*.cu into the cached library unless it exists; return
    its path. Raises RuntimeError with nvcc's output if the build fails."""
    global build_seconds
    target = BUILD_DIR / f"libdbt_kernels_{_digest()}.so"
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    units = [str(p) for p in sorted(CSRC.glob("*.cu"))]
    # build beside the target and rename, so a concurrent or interrupted
    # build never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *units]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, target)
    build_seconds = time.perf_counter() - t0
    return target


def library() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
    return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call the C entry point ``name`` on ``device``'s current stream (the
    stream is appended to ``args``) and raise if it reports an error."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        msg = lib.dbt_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def scratch_words(n: int) -> int:
    return int(library().dbt_cumsum_scratch(n))


def check_vectors(op: str, *tensors: torch.Tensor) -> torch.device:
    """Every tensor is 1-D, int32, contiguous, and on one device; returns
    that device. Raises ValueError otherwise."""
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{op}: expected a tensor, got {type(t).__name__}")
    device = tensors[0].device
    for t in tensors:
        if t.dtype != torch.int32:
            raise ValueError(f"{op}: expected int32, got {t.dtype}")
        if t.dim() != 1:
            raise ValueError(f"{op}: expected a 1-D tensor, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: expected a contiguous tensor")
        if t.device != device:
            raise ValueError(f"{op}: tensors on {device} and {t.device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{op}: unsupported device {device}")
    return device
