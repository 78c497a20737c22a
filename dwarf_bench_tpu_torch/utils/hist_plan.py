"""Run one explicit plan of the count histogram on the card, then the
wrapper's own call on the same stream against its plain twin.

    python -m dwarf_bench_tpu_torch.utils.hist_plan HI_BINS BLOCKS [MERGERS]

Prints ``ran`` or ``refused: <error>`` for the plan (MERGERS defaults to
BLOCKS: every block a merger), then ``next call exact: True`` or
``False``. ``tests/test_torch_gpu.py`` runs it in a subprocess under a time
limit, so that a plan that hung the card would be killed and reported
instead of stalling the tests.
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def main(argv=None) -> int:
    from dwarf_bench_tpu_torch.ops import hist_cuda

    args = [int(a) for a in (sys.argv[1:] if argv is None else argv)]
    hi_bins, blocks = args[0], args[1]
    mergers = args[2] if len(args) > 2 else blocks
    if not torch.cuda.is_available():
        print("hist_plan: CUDA is not available", file=sys.stderr)
        return 1
    keys = np.random.default_rng(7).integers(0, hi_bins * 128, 1 << 22)
    k = torch.from_numpy(keys.astype(np.int32)).cuda()
    try:
        hist_cuda.launch_histogram(k, hi_bins * 128, blocks, mergers)
        torch.cuda.synchronize()
        print("ran", flush=True)
    except RuntimeError as e:
        print(f"refused: {e}", flush=True)
    exact = torch.equal(hist_cuda.histogram(k, hi_bins),
                        hist_cuda.histogram_plain(k, hi_bins))
    print(f"next call exact: {exact}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
