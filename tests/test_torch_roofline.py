"""``dwarf_bench_tpu_torch/utils/roofline.py`` against the JAX package's
``utils/roofline.py``: the bytes-per-row table, the reports at the same
bandwidth, the scaling efficiency, and the card table."""

import jax
import pytest

pytest.importorskip("torch")

import torch

from dwarf_bench_tpu.utils import roofline as jax_roofline
from dwarf_bench_tpu_torch.utils import roofline


def test_bytes_per_row_is_the_jax_table():
    assert roofline.BYTES_PER_ROW == jax_roofline.BYTES_PER_ROW
    assert roofline.DEFAULT_CPU_BW == jax_roofline.DEFAULT_CPU_BW


def test_tpu_walls_are_not_carried_over():
    assert roofline.ACHIEVABLE_ROWS_PER_S == {}


@pytest.mark.parametrize("op", sorted(jax_roofline.BYTES_PER_ROW))
@pytest.mark.parametrize("rows,seconds,bpr", [(1 << 22, 5.3e-5, None),
                                              (1 << 20, 2.5e-2, None),
                                              (1000, 1e-3, 12.5)])
def test_report_matches_jax_at_the_same_bandwidth(op, rows, seconds, bpr):
    # the CPU is the one device both tables know: DEFAULT_CPU_BW
    jax_rep = jax_roofline.report(op, rows, seconds,
                                  device=jax.devices("cpu")[0],
                                  bytes_per_row=bpr)
    rep = roofline.report(op, rows, seconds, device="cpu", bytes_per_row=bpr)
    assert rep.as_dict() == jax_rep.as_dict()
    assert rep == roofline.OpReport(*vars(jax_rep).values())


@pytest.mark.parametrize("rates", [{1: 10.0, 2: 19.0, 4: 30.0},
                                   {2: 5.0, 8: 20.0}, {1: 3.0}])
def test_scaling_efficiency_matches_jax(rates):
    assert roofline.scaling_efficiency(rates) == \
        jax_roofline.scaling_efficiency(rates)


@pytest.mark.parametrize("name,bw", [("NVIDIA H100 80GB HBM3", 3.35e12),
                                     ("NVIDIA H100 PCIe", 2.0e12),
                                     ("NVIDIA H100 NVL", 3.9e12)])
def test_h100_bandwidths(monkeypatch, name, bw):
    assert roofline.hbm_bandwidth(name) == bw
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name)
    assert roofline.device_bandwidth("cuda:0") == bw
    assert roofline.report("scan", 1 << 24, 1e-4,
                           device="cuda:0").bw_roofline_rows_per_s == bw / 4


def test_an_unknown_card_raises_and_names_itself(monkeypatch):
    with pytest.raises(ValueError, match="A100-SXM4-80GB"):
        roofline.hbm_bandwidth("NVIDIA A100-SXM4-80GB")
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "Tesla T4")
    with pytest.raises(ValueError, match="Tesla T4"):
        roofline.device_bandwidth(torch.device("cuda", 0))


def test_the_cpu_takes_the_cpu_rate():
    assert roofline.device_bandwidth(torch.device("cpu")) == \
        roofline.DEFAULT_CPU_BW
