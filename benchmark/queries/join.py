"""Query kind ``join``: the port's dense one-to-many CSR join, as its
JoinOmnisci dwarf calls it once ``csr_join.dense_applicable`` holds (and as
``bench.py``'s ``join_fn`` and ``entry.forward`` do):
``csr_join.build_dense`` over a build range, then
``csr_join.probe_dense(..., hi_rows=128)`` with the probe range, on
device-resident int32 key columns. Nothing is read back to the host. It
returns ``(found, pos, counts, id_buffer)``, as ``entry.forward`` does.

Inputs: the configuration's build ``table`` and its ``probe`` table, of the
build table's shape and drawn from the seed on a generator of its own, both
on the card. A query ``(column, offset, rows)`` joins that range of the
build column with the same range of the probe column.

Compared with the reference: each probe row's (found, pos, counts), whether
``id_buffer`` is a permutation of the build rows, the descents of the build
keys along it, and the outputs' lengths.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import data
from benchmark.reference import join as reference
from benchmark.work import join as work

# every number compared is exact
LIMITS = {"wrong_views": 0, "id_buffer_not_permutation": 0,
          "id_buffer_descents": 0, "length_diff": 0}


def _probe_seed(seed: int) -> int:
    """A seed of the probe table's own stream, drawn from the run's seed."""
    return int(np.random.SeedSequence([seed % 2**64, 1]).generate_state(
        1, np.uint64)[0])


def make_inputs(config: dict, seed: int, device: torch.device) -> dict:
    table = config["table"]
    probe = dict(config["probe"], columns=table["columns"],
                 rows=table["rows"])
    return {"build": data.draw(table, data.generator(seed, device), device),
            "probe": data.draw(probe, data.generator(_probe_seed(seed),
                                                     device), device)}


def args(inputs: dict, query) -> tuple:
    """The same range of the same column of the build and probe tables
    (views)."""
    col, off, n = query
    return (inputs["build"][col, off:off + n],
            inputs["probe"][col, off:off + n])


def program(params: dict):
    from dwarf_bench_tpu_torch.ops import csr_join

    def join(build, probe):
        table = csr_join.build_dense(build)
        res = csr_join.probe_dense(table, probe, hi_rows=128)
        return res.found, res.pos, res.counts, table.id_buffer

    return join


def control(params: dict):
    return lambda build, probe: reference.control(build, probe, params)


def written(out) -> int:
    """The probe rows given a view (found, pos, counts)."""
    return out[0].numel()


def compare(out, args: tuple, params: dict) -> dict:
    """``wrong_views``: probe rows whose (found, pos, counts) differ from
    the reference's, up to the shortest length; ``id_buffer_not_permutation``
    and ``id_buffer_descents`` (``reference.id_buffer_faults``);
    ``length_diff``: how far each output's length is from its input's."""
    build, probe = args
    found, pos, counts, id_buffer = (t.reshape(-1) for t in out)
    ref = reference.expected(build, probe, params)
    m = min(found.numel(), pos.numel(), counts.numel(), ref[0].numel())
    wrong = ((found[:m] != ref[0][:m]) | (pos[:m] != ref[1][:m])
             | (counts[:m] != ref[2][:m])).sum()
    not_perm, descents = reference.id_buffer_faults(build, id_buffer)
    nb = probe.numel()
    length = (sum(abs(t.numel() - nb) for t in (found, pos, counts))
              + abs(id_buffer.numel() - build.numel()))
    return {"wrong_views": int(wrong), "id_buffer_not_permutation": not_perm,
            "id_buffer_descents": descents, "length_diff": length}
