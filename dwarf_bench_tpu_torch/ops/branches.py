"""The branch each adaptive engine took, counted on every device.

``TAKEN["<engine>:<branch>"]`` counts the calls of ``sort.sort_auto``
(branches ``hi80``, ``hi128`` and ``torch.sort``) and ``scan.filter_sparse``
(``sparse``, and ``general`` where a cap trips, the threshold is within 512
of INT32_MIN, or the input is not int32) by the branch they took.
``_build.LAUNCHES`` counts the kernels a run launched, on the card only; this
counter says which side of a dispatch cliff a call fell on, on the CPU too
(``utils/cliffs.py`` reads it).
"""

from __future__ import annotations

import collections

TAKEN: collections.Counter = collections.Counter()


def take(engine: str, branch: str) -> None:
    TAKEN[f"{engine}:{branch}"] += 1
