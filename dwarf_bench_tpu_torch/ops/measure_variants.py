"""The measurement scripts' TPU kernels (``scripts/measure_r*.py``) on the
card.

Each function keeps the script function's name, arguments, output shape and
dtype (uint32 outputs as int32 bit patterns). The block-shape arguments
(``w``, ``rows``, ``stack``, ``form``, ``i16``, ``bf16cmp``, ``one_dot``,
``interpret``) chose how the TPU built its one-hots; they do not change what
is computed, so the card ignores them after the checks the script functions
make on them (as ValueErrors).

Thirteen names compute a contract a kernel of this package already serves,
and launch it:

  * the histograms (``histogram``, ``csrc/hist.cu``): keys whose uint32
    value is at or past hi_bins * 128 are dropped, as in
    ``hist_cuda.histogram``. ``dyn_store_probe`` is that histogram at
    hi_bins 64 as a (64, 128) matrix; the TPU kernel stores out of bounds
    for indices of 8192 or more, which the card drops.
  * the weighted histograms (``weighted_histogram``, ``csrc/hist.cu``): the
    TPU's two 7-bit value planes hold values below 2^14 only; the card sums
    any int32 value mod 2^32.
  * the group-bys, G <= 4096 (``groupby_small``, ``csrc/groupby.cu``):
    ``groupby_small_v2``, ``_v3``, ``_v5``, ``groupby_small_stacked`` and
    ``_gb_dbuf_kernel`` (G = ga * gb); values below 2^14 on the TPU, any on
    the card.

``_gb_diag_kernel_factory`` computes no group sum; its three modes have their
own kernel, ``csrc/gb_diag.cu``, whose header gives their closed forms. Keys
outside [0, ga * gb) are dropped there (the TPU's SWAR bytes alias for
hi digits of 256 or more).

Each name counts its own launches in ``_build.LAUNCHES`` beside the kernel
it goes through. A wrapper takes the plain version only for CPU tensors; for
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build
from .groupby_cuda import MAX_GROUPS, groupby_small
from .hist_cuda import _check_jax_hi_bins, histogram, weighted_histogram
from .primitives import as_u32, wrap_i32

SWAR_FORMS = ("f1", "f3", "f4", "f5")
DIAG_MODES = ("full", "dotonly", "nodot")


def _counted(name: str, out: torch.Tensor) -> torch.Tensor:
    if out.is_cuda:
        _build.LAUNCHES[name] += 1
    return out


def _check_positive(op: str, **dims) -> None:
    for arg, value in dims.items():
        if int(value) < 1:
            raise ValueError(f"{op}: {arg} must be positive, got {value}")


# -- histograms (hist.cu histogram) -----------------------------------------


def histogram_16k_i8cmp(k: torch.Tensor, interpret: bool = False):
    """``scripts/measure_r2.py:38``: (16384,) int32 counts of the keys in
    [0, 2^14)."""
    return _counted("histogram_16k_i8cmp", histogram(k, 128))


def hist16k_bf16cmp(k: torch.Tensor, w: int = 2048, interpret: bool = False):
    """``scripts/measure_r2b.py:37``: as ``histogram_16k_i8cmp``."""
    _check_positive("hist16k_bf16cmp", w=w)
    return _counted("hist16k_bf16cmp", histogram(k, 128))


def dyn_store_probe(idx: torch.Tensor, interpret: bool = False):
    """``scripts/measure_r2c.py:228``: a (64, 128) int32 with one added at
    (i >> 7, i & 127) for each index i in [0, 8192); other indices are
    dropped."""
    return _counted("dyn_store_probe", histogram(idx, 64).view(64, 128))


def hist_variant(k: torch.Tensor, hi_bins: int = 128, i16: bool = False,
                 interpret: bool = False):
    """``scripts/measure_r3.py:60``: (hi_bins * 128,) int32 counts,
    hi_bins <= 128."""
    return _counted("hist_variant", histogram(k, int(hi_bins)))


def hist_rows(k: torch.Tensor, hi_bins: int = 128, rows: int = 8,
              interpret: bool = False):
    """``scripts/measure_r3c.py:24``: as ``hist_variant``."""
    _check_positive("hist_rows", rows=rows)
    return _counted("hist_rows", histogram(k, int(hi_bins)))


def hist_swar(k: torch.Tensor, hi_bins: int = 80, form: str = "f1",
              rows: int = 8, interpret: bool = False):
    """``scripts/measure_r4.py:70``: as ``hist_variant``, for every SWAR
    form; rows a multiple of 4 (the script's assert) and, for the
    bin-packed form f5, hi_bins a multiple of 4."""
    if form not in SWAR_FORMS:
        raise ValueError(f"hist_swar: form must be one of {SWAR_FORMS}, "
                         f"got {form!r}")
    _check_positive("hist_swar", rows=rows)
    if int(rows) % 4:
        raise ValueError(f"hist_swar: rows {rows} is not a multiple of 4")
    if form == "f5" and int(hi_bins) % 4:
        raise ValueError(f"hist_swar: form f5 packs four bins a word; "
                         f"hi_bins {hi_bins} is not a multiple of 4")
    return _counted("hist_swar", histogram(k, int(hi_bins)))


# -- weighted histograms (hist.cu weighted_histogram) ----------------------


def weighted_histogram_i8(k: torch.Tensor, v: torch.Tensor,
                          hi_bins: int = 512, interpret: bool = False):
    """``scripts/measure_r2c.py:146``: (hi_bins * 128,) int32 sums of v per
    key, hi_bins a multiple of 8 up to 512 (the script's assert)."""
    hi_bins = _check_jax_hi_bins("weighted_histogram_i8", hi_bins, 512)
    return _counted("weighted_histogram_i8", weighted_histogram(k, v, hi_bins))


def whist_i8(k: torch.Tensor, v: torch.Tensor, hi_bins: int = 512,
             interpret: bool = False):
    """``scripts/measure_r3.py:121``: (hi_bins * 128,) int32 sums of v per
    key, hi_bins <= 512."""
    return _counted("whist_i8", weighted_histogram(k, v, int(hi_bins)))


# -- group-bys (groupby.cu groupby_small) -----------------------------------


def groupby_small_v2(k: torch.Tensor, v: torch.Tensor, num_groups: int,
                     w: int = 8192, bf16cmp: bool = True,
                     interpret: bool = False):
    """``scripts/measure_r2b.py:106``: (G,) uint32 sums of v per key in
    [0, G), G <= 4096, as int32 bits."""
    _check_positive("groupby_small_v2", w=w)
    return _counted("groupby_small_v2", groupby_small(k, v, int(num_groups)))


def groupby_small_v3(k: torch.Tensor, v: torch.Tensor, num_groups: int,
                     one_dot: bool = False, interpret: bool = False):
    """``scripts/measure_r2c.py:42``: as ``groupby_small_v2``."""
    return _counted("groupby_small_v3", groupby_small(k, v, int(num_groups)))


def groupby_small_v5(k: torch.Tensor, v: torch.Tensor, num_groups: int,
                     rows: int = 8, w: int = 2048, interpret: bool = False):
    """``scripts/measure_r3b.py:39``: as ``groupby_small_v2``."""
    _check_positive("groupby_small_v5", rows=rows, w=w)
    return _counted("groupby_small_v5", groupby_small(k, v, int(num_groups)))


def groupby_small_stacked(k: torch.Tensor, v: torch.Tensor, num_groups: int,
                          rows: int = 32, w: int = 4096, stack: int = 4,
                          interpret: bool = False):
    """``scripts/measure_r4.py:574``: as ``groupby_small_v2``, with the
    script's asserts: 127 * rows * w < 2^24 (its f32 block sums stay exact)
    and rows a multiple of stack."""
    _check_positive("groupby_small_stacked", rows=rows, w=w, stack=stack)
    if 127 * int(rows) * int(w) >= 1 << 24:
        raise ValueError(f"groupby_small_stacked: 127 * rows * w >= 2^24 "
                         f"(rows {rows}, w {w})")
    if int(rows) % int(stack):
        raise ValueError(f"groupby_small_stacked: rows {rows} is not a "
                         f"multiple of stack {stack}")
    return _counted("groupby_small_stacked",
                    groupby_small(k, v, int(num_groups)))


def _check_digits(op: str, ga: int, gb: int, rows: int, w: int) -> None:
    """The SWAR kernels' digit shapes: ga and gb multiples of 4 (four digit
    bytes a uint32 word), gb a power of two (lo = k & (gb - 1)), and
    ga * gb <= 4096 (the card's shared-memory tables)."""
    _check_positive(op, ga=ga, gb=gb, rows=rows, w=w)
    if ga % 4 or gb % 4:
        raise ValueError(f"{op}: ga {ga} and gb {gb} must be multiples of 4")
    if gb & (gb - 1):
        raise ValueError(f"{op}: gb {gb} is not a power of two")
    if ga * gb > MAX_GROUPS:
        raise ValueError(f"{op}: ga * gb = {ga * gb} > {MAX_GROUPS}")


def _gb_dbuf_kernel(ga: int = 8, gb: int = 8, rows: int = 32,
                    w: int = 4096):
    """``scripts/measure_r5.py:645``: returns ``run(k, v)``, the
    (ga * gb,) int32 sums of v per key in [0, ga * gb)."""
    ga, gb = int(ga), int(gb)
    _check_digits("_gb_dbuf_kernel", ga, gb, int(rows), int(w))

    def run(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return _counted("_gb_dbuf_kernel", groupby_small(k, v, ga * gb))

    return run


# -- the diagnostic modes (gb_diag.cu) --------------------------------------


def gb_diag_plain(k: torch.Tensor, v: torch.Tensor, mode: str, ga: int,
                  gb: int, rows: int, w: int) -> torch.Tensor:
    """Plain version of ``_gb_diag_kernel_factory``'s ``run(k, v)``: the
    (ga, gb) int32 closed form of ``mode`` (``csrc/gb_diag.cu``)."""
    n, block = k.numel(), rows * w
    cells = ga * gb
    shift = gb.bit_length() - 1
    out = torch.zeros(ga, gb, dtype=torch.int64, device=k.device)
    if mode == "nodot":
        pad = (-n) % block
        zeros = torch.zeros(pad, dtype=torch.int32, device=k.device)
        kk = torch.cat([k, zeros]).view(-1, w)[:, :gb].to(torch.int64)
        vv = torch.cat([v, zeros]).view(-1, w)[:, :gb].to(torch.int64)
        col = torch.arange(gb, device=k.device).expand_as(kk)
    else:
        kk, vv = k.to(torch.int64), v.to(torch.int64)
        col = None
    ku = as_u32(kk)
    keep = ku < cells
    p = (vv & 0x7F) + (vv >> 7)
    if mode == "full":
        out.view(-1).index_add_(0, ku[keep], p[keep])
    elif mode == "dotonly":
        first = (torch.arange(n, device=k.device) % block) < w
        keep &= first
        out.view(-1).index_add_(0, ku[keep], rows * p[keep])
    else:
        hi, lo = ku >> shift, ku & (gb - 1)
        out.index_put_((hi[keep], col[keep]),
                       torch.full_like(hi[keep], -128), accumulate=True)
        keep &= lo < ga
        out.index_put_((lo[keep], col[keep]), p[keep], accumulate=True)
    return wrap_i32(out)


def _gb_diag_kernel_factory(mode: str, ga: int = 8, gb: int = 8,
                            rows: int = 32, w: int = 4096, naccs: int = 1):
    """``scripts/measure_r5.py:485``: returns ``run(k, v)``, the (ga, gb)
    int32 of the diagnostic ``mode`` (full, dotonly or nodot), computed by
    ``csrc/gb_diag.cu``. ``naccs`` (round-robin accumulators on the TPU)
    does not change the sum. nodot reads gb columns of every row into ga
    rows, so it needs ga <= gb <= w."""
    op = "_gb_diag_kernel_factory"
    if mode not in DIAG_MODES:
        raise ValueError(f"{op}: mode must be one of {DIAG_MODES}, "
                         f"got {mode!r}")
    ga, gb, rows, w = int(ga), int(gb), int(rows), int(w)
    _check_digits(op, ga, gb, rows, w)
    _check_positive(op, naccs=naccs)
    if mode == "nodot" and not ga <= gb <= w:
        raise ValueError(f"{op}: nodot needs ga <= gb <= w, got ga {ga}, "
                         f"gb {gb}, w {w}")

    def run(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        device = _build.check_vectors(op, k, v)
        if k.numel() != v.numel():
            raise ValueError(f"{op}: {k.numel()} keys but {v.numel()} "
                             "values")
        if device.type == "cpu":
            return gb_diag_plain(k, v, mode, ga, gb, rows, w)
        out = torch.zeros(ga, gb, dtype=torch.int32, device=device)
        if k.numel() == 0:
            return out
        _build.launch("dbt_gb_diag", device, k.data_ptr(), v.data_ptr(),
                      k.numel(), out.data_ptr(), ga, gb, rows, w,
                      DIAG_MODES.index(mode))
        _build.LAUNCHES[op] += 1
        return out

    return run
