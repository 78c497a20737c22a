"""Release packager, the port of ``scripts/release.py`` (the reference's
cmake Release build, install and tar.gz): builds the native oracle library
and writes ``dwarf_bench_tpu_torch-<version>.tar.gz`` into ``--out``.

    python -m dwarf_bench_tpu_torch.scripts.release [--out dist/] [--kernels]

The tar holds the package (its CUDA sources in ``csrc/`` included),
``native/`` with the oracle library built by ``make``, ``README.md`` and
``pyproject.toml``; no ``__pycache__`` and no ``build/``. ``make`` runs in a
staging copy of ``native/``, so the checkout's own files stay as they are.

``--kernels`` is the analog of the reference's Release build: it builds
the CUDA kernel library with nvcc (``ops/_build.py``) and adds it under
``dwarf_bench_tpu_torch/build/``. The library's name is a hash of the
sources and the flags, so the unpacked tree loads it without nvcc. Without
nvcc it raises before anything is written: it never ships a tree whose
kernels are missing.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tarfile
import tempfile

from .. import __version__

PKG = "dwarf_bench_tpu_torch"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NATIVE_SOURCES = ("native/oracles.cpp", "native/Makefile")


def _skip(ti: tarfile.TarInfo):
    parts = ti.name.split("/")
    return None if "__pycache__" in parts or "build" in parts else ti


def build_kernels() -> str:
    """The kernel library for this checkout's sources, built with nvcc
    (raises without it); returns its path."""
    from ..ops import _build

    _build.nvcc_path()  # raises RuntimeError without nvcc
    return str(_build.build())


def release(out_dir: str, kernels: bool = False) -> str:
    """Write the tar into ``out_dir``; returns its path."""
    kernel_lib = build_kernels() if kernels else None
    name = f"{PKG}-{__version__}"
    with tempfile.TemporaryDirectory() as stage:
        native = os.path.join(stage, "native")
        os.makedirs(native)
        for rel in NATIVE_SOURCES:
            shutil.copy2(os.path.join(ROOT, rel), native)
        subprocess.run(["make", "-C", native], check=True)
        os.makedirs(out_dir, exist_ok=True)
        tar_path = os.path.join(out_dir, f"{name}.tar.gz")
        with tarfile.open(tar_path, "w:gz") as tf:
            tf.add(os.path.join(ROOT, PKG), arcname=f"{name}/{PKG}",
                   filter=_skip)
            for rel in (*NATIVE_SOURCES, "native/liboracles.so"):
                tf.add(os.path.join(stage, rel), arcname=f"{name}/{rel}")
            for rel in ("README.md", "pyproject.toml"):
                tf.add(os.path.join(ROOT, rel), arcname=f"{name}/{rel}")
            if kernel_lib is not None:
                tf.add(kernel_lib, arcname=f"{name}/{PKG}/build/"
                                           f"{os.path.basename(kernel_lib)}")
    print(f"wrote {tar_path}")
    return tar_path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=os.path.join(ROOT, "dist"))
    p.add_argument("--kernels", action="store_true",
                   help="build the CUDA kernel library with nvcc and ship it")
    args = p.parse_args(argv)
    release(args.out, args.kernels)
    return 0


if __name__ == "__main__":
    sys.exit(main())
