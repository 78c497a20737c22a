"""Build, load and launch the hand-written CUDA kernels in ``csrc/``.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``, all
in parallel, and linked into one shared library with a plain C interface,
at first use, and loaded with ctypes. The library is cached under ``dwarf_bench_tpu_torch/build/`` (which
``.gitignore`` covers through its ``build/`` line), named by a hash of the
sources and the flags, so an edited source builds anew. A failed build
raises; nothing falls back.

Each C entry point returns ``cudaGetLastError()`` after its launches, and
``launch`` raises on anything but 0: a launch the card refuses (too much
shared memory, too many threads) never runs, and ``torch.cuda.synchronize``
would not report it.

``LAUNCHES`` counts, per kernel and per JAX name a kernel serves, the
launches the wrappers in ``ops/*_cuda.py`` made, so a run can show which
kernels its path went through. Each wrapper adds one where it launches its
kernel, and nowhere else; a name's wrapper that launches through another
wrapper (``histogram_16k_pallas`` through ``histogram``) counts under both
names.
"""

from __future__ import annotations

import ctypes
import functools
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64

# name -> (argtypes, restype). Every pointer and the stream are c_void_p:
# without argtypes ctypes would pass a Python int as a 32-bit C int.
_SIGNATURES = {
    "dbt_histogram": ([_P, _I64, _P, _I32, _I32, _I32, _P, _P], ctypes.c_int),
    "dbt_histogram_scratch": ([_I32, _I32], _I64),
    "dbt_weighted_histogram": (
        [_P, _P, _I64, _P, _I32, _I32, _I32, _P, _P], ctypes.c_int),
    "dbt_weighted_histogram_max_clusters": ([_I32, _I32], ctypes.c_int),
    "dbt_groupby_small": ([_P, _P, _I64, _P, _I32, _P], ctypes.c_int),
    "dbt_cumsum": ([_P, _I64, _P, _I32, _P, _P, _P], ctypes.c_int),
    "dbt_cumsum_scratch": ([_I64], _I64),
    "dbt_compact_scratch": ([_I64, _I32], _I64),
    "dbt_filter": ([_P, _I64, _I32, _P, _I64, _P, _P, _P], ctypes.c_int),
    "dbt_compact_mask": (
        [_P, _P, _P, _P, _I32, _I64, _P, _P, _P, _I64, _P, _P, _P],
        ctypes.c_int,
    ),
    "dbt_emit_prefix": ([_P, _P, _I64, _P, _P], ctypes.c_int),
    "dbt_scan_tail_streams": (
        [_P, _P, _I64, _I32, _P, _P, _I64, _P, _P, _I64, _P, _P, _P],
        ctypes.c_int,
    ),
    "dbt_reduce_sum": ([_P, _I64, _P, _P, _I32, _P], ctypes.c_int),
    "dbt_merge_bitonic": (
        [_P] * 8 + [_I32, _I64, _I32, _I32, _I32, _P, _P], ctypes.c_int),
    "dbt_merge_fill": (
        [_P, _P, _P, _I64, _I64, _I32, _P, _P, _P, _P],
        ctypes.c_int,
    ),
    "dbt_merge_fill_scratch": ([_I64], _I64),
    "dbt_chunk_stats": ([_P, _I64, _I32, _P, _P, _P], ctypes.c_int),
    "dbt_probe_dense": ([_P, _P, _P, _I64, _I32, _P, _P, _P], ctypes.c_int),
    "dbt_vadd": ([_P, _P, _P, _I64, _I32, _P], ctypes.c_int),
    "dbt_lock_add": ([_P, _P, _I32, _P], ctypes.c_int),
    "dbt_l2_round_trip": ([_P, _I32, _P, _P], ctypes.c_int),
    "dbt_gb_diag": (
        [_P, _P, _I64, _P, _I32, _I32, _I32, _I64, _I32, _P, _I64, _P],
        ctypes.c_int,
    ),
    "dbt_error_string": ([ctypes.c_int], ctypes.c_char_p),
}

LAUNCHES: Dict[str, int] = {
    "histogram": 0,
    "cumsum": 0,
    "groupby_small": 0,
    "weighted_histogram": 0,
    "scan_tail_streams": 0,
    "compact_mask": 0,
    "emit_prefix": 0,
    "filter": 0,
    "merge_bitonic": 0,
    "merge_fill": 0,
    "reduce_sum": 0,
    # the sparse filter's phase A (csrc/chunk_stats.cu)
    "chunk_stats": 0,
    # JAX names served by the kernels above or by csrc/chunk_stats.cu and
    # csrc/probe_dense.cu: each name's wrapper counts its own launches
    "chunk_stats_pallas": 0,
    "chunk_stats_roll_pallas": 0,
    "chunk_stats_fused": 0,
    "scan_tail_compact": 0,
    "probe_dense_rel_pallas": 0,
    "probe_dense_cat_pallas": 0,
    "histogram_16k_pallas": 0,
    "weighted_histogram_pallas": 0,
    "weighted_histogram_16k_pallas": 0,
    "groupby_small_swar_pallas": 0,
    "groupby_small_pallas_f32": 0,
    # the examples' kernels (csrc/vadd.cu, csrc/lock_add.cu)
    "vadd_pallas": 0,
    "grid_accumulate": 0,
    # the measurement scripts' names (ops/measure_variants.py), served by
    # the kernels above or by csrc/gb_diag.cu
    "histogram_16k_i8cmp": 0,
    "hist16k_bf16cmp": 0,
    "groupby_small_v2": 0,
    "groupby_small_v3": 0,
    "weighted_histogram_i8": 0,
    "dyn_store_probe": 0,
    "hist_variant": 0,
    "whist_i8": 0,
    "groupby_small_v5": 0,
    "hist_rows": 0,
    "hist_swar": 0,
    "groupby_small_stacked": 0,
    "_gb_diag_kernel_factory": 0,
    "_gb_dbuf_kernel": 0,
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


def _run_all(cmds):
    """Run the commands in parallel; raise RuntimeError with the output of
    each that failed. Every process is waited for or killed on return."""
    procs = []
    try:
        for cmd in cmds:
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
        failed = []
        for cmd, proc in zip(cmds, procs):
            out = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): "
                              f"{' '.join(cmd)}\n{out}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> pathlib.Path:
    """Compile csrc/*.cu into the cached library unless it exists; return
    its path. Each source compiles in its own nvcc process, all at once,
    then one nvcc links them. Raises RuntimeError with nvcc's output if the
    build fails."""
    global build_seconds
    target = BUILD_DIR / f"libdbt_kernels_{_digest()}.so"
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    # build beside the target and rename, so a concurrent or interrupted
    # build never leaves a half-written library under the final name
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        units = sorted(CSRC.glob("*.cu"))
        objs = [os.path.join(tmp, f"{u.stem}.o") for u in units]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(u)]
                  for u, o in zip(units, objs)])
        lib = os.path.join(tmp, "lib.so")
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, target)
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
    raw stream handle is appended to ``args``) and raise if it reports an
    error. The stream is looked up on every call, so a caller's
    ``torch.cuda.stream(s)`` is honoured; the current device is switched
    only when it is not ``device`` already."""
    fn = getattr(library(), name)
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    if index == torch._C._cuda_getDevice():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        msg = _lib.dbt_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


@functools.lru_cache(maxsize=256)
def cumsum_scratch_words(n: int) -> int:
    """int32 scratch words of ``dbt_cumsum`` for ``n`` values (at least
    one)."""
    return max(int(library().dbt_cumsum_scratch(n)), 1)


_STREAM_SCRATCH: Dict[tuple, torch.Tensor] = {}


def stream_scratch(kind: str, device: torch.device, words: int) -> torch.Tensor:
    """A lasting int32 buffer of at least ``words`` words for the kernel
    ``kind`` on ``device``'s current stream, zero when first made. Work on
    one stream runs in order, so a call never overlaps the last call that
    used the buffer; each stream has its own. It saves a torch.empty, and
    its host time, a call; a kernel that needs it zero must leave it zero
    (``dbt_cumsum`` and the compactions do, ``dbt_reduce_sum`` and
    ``dbt_gb_diag`` their tickets, ``dbt_histogram`` its counters and
    ``dbt_lock_add`` its lock)."""
    index = device.index
    key = (kind, index, torch._C._cuda_getCurrentRawStream(index))
    buf = _STREAM_SCRATCH.get(key)
    if buf is None or buf.numel() < words:
        old = 0 if buf is None else buf.numel()
        buf = torch.zeros(max(words, 2 * old), dtype=torch.int32,
                          device=device)
        _STREAM_SCRATCH[key] = buf
    return buf


@functools.lru_cache(maxsize=256)
def compact_scratch_words(n: int, streams: int) -> int:
    """int32 scratch words of a compaction of ``n`` rows into ``streams``
    streams (``csrc/compact.cuh``: two counters, then one 64-bit status word
    a tile and stream), for ``stream_scratch("compact", ...)``. Counts and
    ranks are int32, so ``n`` must be below 2^31."""
    if n >= 2**31:
        raise ValueError(f"compaction of {n} rows: counts are int32")
    return int(library().dbt_compact_scratch(n, streams))


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


def check_int32(op: str, name: str, value) -> int:
    """``value`` as a Python int; raises ValueError outside int32."""
    v = int(value)
    if not -(2**31) <= v < 2**31:
        raise ValueError(f"{op}: {name} {v} is not an int32")
    return v


def check_capacity(op: str, capacity, n: int) -> int:
    """The slot count of a compaction's output (``n`` when None)."""
    cap = n if capacity is None else int(capacity)
    if cap < 0:
        raise ValueError(f"{op}: capacity {cap} is negative")
    return cap
