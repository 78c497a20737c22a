"""The one traffic generator: reads a traffic mix and deals queries from
the seed.

A mix lists the ``lengths`` a query covers (``"column"`` for a whole
column). They form a deck: every length once, dealt in an order the seed
shuffles anew for each deck, so every seed sends the same set of sizes in
another order. ``columns`` is ``"in_turn"`` (from a column the seed draws)
or ``"random"``; a range that is not a whole column starts at a random
multiple of ``offset_align`` rows that keeps it inside its column.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

Query = Tuple[int, int, int]  # (column, offset, rows)

_DEAL = 4096  # queries drawn from the generator at a time


def lengths(traffic: dict, rows: int) -> list:
    out = [rows if n == "column" else int(n) for n in traffic["lengths"]]
    for n in out:
        if not 0 < n <= rows:
            raise ValueError(f"a query of {n} rows in a column of {rows}")
    return out


def deal(traffic: dict, columns: int, rows: int, seed: int) -> Iterator[Query]:
    """Endless (column, offset, rows) of the mix, the same for the same
    seed."""
    rng = np.random.default_rng(seed % 2**64)
    deck = np.array(lengths(traffic, rows), dtype=np.int64)
    align = int(traffic.get("offset_align", 1))
    in_turn = traffic["columns"] == "in_turn"
    if not in_turn and traffic["columns"] != "random":
        raise ValueError(f"columns: {traffic['columns']!r}")
    first = int(rng.integers(columns))
    decks = -(-_DEAL // deck.size)
    dealt = 0
    while True:
        size = np.concatenate([rng.permutation(deck) for _ in range(decks)])
        if in_turn:
            col = (first + dealt + np.arange(size.size)) % columns
        else:
            col = rng.integers(columns, size=size.size)
        slots = (rows - size) // align + 1
        off = np.where(size == rows, 0, rng.integers(0, slots) * align)
        dealt += size.size
        yield from zip(col.tolist(), off.tolist(), size.tolist())
