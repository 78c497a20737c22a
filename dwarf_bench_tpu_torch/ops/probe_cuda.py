"""The dense CSR join's lookup: CUDA kernel (``csrc/probe_dense.cu``) under
its two JAX names, and the plain PyTorch version.

``probe_dense_rel_pallas(packed3, base128, ki)`` and
``probe_dense_cat_pallas(packed3, base128, ki, hi_rows)``
(``dwarf_bench_tpu/ops/probe_pallas.py:174, 43``): per int32 query ``k``,
``(0, 0)`` where ``uint32(k) >= hi_rows * 128`` (rel: hi_rows = 128), else
``cnt = packed3[k] & 1023`` and ``pos = base128[k >> 7] + (packed3[k] >> 10)``,
with ``pos = 0`` where ``cnt == 0``. ``packed3`` is the (16384,) int32 and
``base128`` the (128,) int32 field of ``csr_join.DenseCsrTable``.

PRECONDITION for agreement with the JAX kernels: every entry of ``packed3``
and ``base128`` is below 2^24 (``packed3_ok`` of ``csr_join.build_dense``).
The JAX kernels read the tables through f32 (rel) or three 8-bit (cat)
matmul planes and are exact only there; the kernel and the plain version
here compute the contract for any table.

``csr_join.probe_dense`` keeps its plain gathers, as the JAX ``probe_dense``
keeps its XLA ones. A wrapper takes the plain version only for a CPU tensor;
for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build

TABLE_KEYS = 1 << 14  # packed3 entries: the dense table's 2^14 keys


def _check(op: str, packed3, base128, ki, hi_rows: int):
    device = _build.check_vectors(op, packed3, base128, ki)
    if packed3.numel() != TABLE_KEYS or base128.numel() != TABLE_KEYS // 128:
        raise ValueError(f"{op}: tables of {packed3.numel()} and "
                         f"{base128.numel()} entries; expected "
                         f"{TABLE_KEYS} and {TABLE_KEYS // 128}")
    if not 1 <= int(hi_rows) <= 128:
        raise ValueError(f"{op}: hi_rows {hi_rows} is not in [1, 128]")
    return device


def probe_dense_plain(packed3: torch.Tensor, base128: torch.Tensor,
                      ki: torch.Tensor, hi_rows: int = 128):
    """(pos, cnt) per query in plain torch (the contract above)."""
    _check("probe_dense", packed3, base128, ki, hi_rows)
    u = ki.to(torch.int64) & 0xFFFFFFFF
    ok = u < hi_rows * 128
    safe = torch.where(ok, u, 0)
    rel = packed3[safe]
    cnt = torch.where(ok, rel & 1023, 0)
    pos = torch.where(cnt > 0, base128[safe >> 7] + (rel >> 10), 0)
    return pos, cnt


def _probe(op: str, packed3, base128, ki, hi_rows: int):
    device = _check(op, packed3, base128, ki, hi_rows)
    if device.type == "cpu":
        return probe_dense_plain(packed3, base128, ki, hi_rows)
    n = ki.numel()
    pos = torch.empty(n, dtype=torch.int32, device=device)
    cnt = torch.empty(n, dtype=torch.int32, device=device)
    _build.launch("dbt_probe_dense", device, packed3.data_ptr(),
                  base128.data_ptr(), ki.data_ptr(), n, int(hi_rows) * 128,
                  pos.data_ptr(), cnt.data_ptr())
    _build.LAUNCHES[op] += 1
    return pos, cnt


def probe_dense_rel_pallas(packed3: torch.Tensor, base128: torch.Tensor,
                           ki: torch.Tensor):
    """(pos, cnt) per query over the whole 2^14-key table."""
    return _probe("probe_dense_rel_pallas", packed3, base128, ki, 128)


def probe_dense_cat_pallas(packed3: torch.Tensor, base128: torch.Tensor,
                           ki: torch.Tensor, hi_rows: int = 128):
    """(pos, cnt) per query over the first ``hi_rows * 128`` keys (the
    range-aware form: keys past them are not found)."""
    return _probe("probe_dense_cat_pallas", packed3, base128, ki, hi_rows)
