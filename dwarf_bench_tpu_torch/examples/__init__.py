"""The examples of ``examples/`` on the port, each runnable as a module:

    python -m dwarf_bench_tpu_torch.examples.bench_usage [--device=cpu]
    python -m dwarf_bench_tpu_torch.examples.vadd [--device=cpu]
    python -m dwarf_bench_tpu_torch.examples.lock_add [--device=cpu]

Each runs on the card unless ``--device=cpu`` is given, and fails (exit
code 1, or the exception) when CUDA is missing or a check does not hold.
"""

from __future__ import annotations

import argparse

import torch

from ..common.device import resolve_device
from ..common.options import parse_device_type


def parse_device(argv, description: str) -> torch.device:
    """The ``--device`` flag (gpu, its alias cuda, or cpu; the card by
    default) of an example's command line, resolved."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", choices=("gpu", "cuda", "cpu"), default="gpu",
                   help="Device to run on; the card by default.")
    args = p.parse_args(argv)
    return resolve_device(parse_device_type(args.device))
