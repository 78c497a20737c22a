"""The port's timers (``dwarf_bench_tpu_torch/utils/timing.py``) on the CPU:
the slopes of ``time_device_looped``, ``time_device_looped_inplace`` and
``time_amortized`` on a call of known cost, their keyword surface against
the JAX package's timers, and ``kernel_time`` as it was. Their graph and
eviction paths need the card (``tests/test_torch_gpu.py``)."""

import inspect
import time

import pytest

pytest.importorskip("torch")

import torch

from dwarf_bench_tpu.utils import timing as jax_timing
from dwarf_bench_tpu_torch.utils import kernel_times, timing

COST_S = 0.004


def _sleeper(x):
    time.sleep(COST_S)
    return x + 1


@pytest.mark.parametrize("timer", ["time_device_looped",
                                   "time_device_looped_inplace"])
@pytest.mark.parametrize("cold", [False, True])
def test_looped_timers_take_the_host_slope_on_the_cpu(timer, cold):
    x = torch.zeros(4, dtype=torch.int32)
    t = getattr(timing, timer)(_sleeper, x, cold=cold)
    # the slope of 17 calls against 1: one call's cost, whatever the
    # fixed cost of a measurement
    assert 0.8 * COST_S <= t <= 3 * COST_S


def test_time_amortized_takes_the_queue_slope_on_the_cpu():
    x = torch.zeros(4, dtype=torch.int32)
    t = timing.time_amortized(_sleeper, x, k=4)
    assert 0.8 * COST_S <= t <= 3 * COST_S


def test_a_free_call_reads_the_floor_not_zero():
    x = torch.zeros(4, dtype=torch.int32)
    for t in (timing.time_device_looped(lambda v: v, x, k=2),
              timing.time_amortized(lambda v: v, x, k=2)):
        assert t >= 1e-9


def test_slope_cancels_a_fixed_cost_per_measurement(monkeypatch):
    """A fixed cost paid once per measured run (as the fence's round trip
    or a replay's launch) drops out of both slopes."""
    calls = []

    def fn(x):
        calls.append(1)
        time.sleep(COST_S)
        return x

    def slow_fence(dev):
        time.sleep(10 * COST_S)

    monkeypatch.setattr(timing, "_fence", slow_fence)
    t = timing.time_device_looped(fn, torch.zeros(1), k=8, repeats=2)
    assert 0.8 * COST_S <= t <= 3 * COST_S
    # one warm call, then 2 x 1 and 2 x 9 calls
    assert len(calls) == 1 + 2 + 2 * 9
    calls.clear()
    t = timing.time_amortized(fn, torch.zeros(1), k=4)
    assert 0.8 * COST_S <= t <= 3 * COST_S


def test_keyword_surface():
    """``cold`` is accepted, ``k`` and ``repeats`` keep the JAX defaults,
    and the JAX loop's coupling arguments are gone: a graph replays every
    kernel it captured, so nothing needs to couple the calls."""
    jax_looped = {
        "time_device_looped": {"perturb", "fold"},
        "time_device_looped_inplace": {"update", "fold"},
    }
    for name, coupling in jax_looped.items():
        port = inspect.signature(getattr(timing, name)).parameters
        jax = inspect.signature(getattr(jax_timing, name)).parameters
        assert set(port) == {"fn", "args", "k", "repeats", "cold"}
        assert set(jax) - set(port) == coupling
        for arg in ("k", "repeats"):
            assert port[arg].default == jax[arg].default
        assert port["cold"].default is False
        with pytest.raises(TypeError):
            getattr(timing, name)(_sleeper, torch.zeros(1),
                                  **{c: None for c in coupling})
    port = inspect.signature(timing.time_amortized).parameters
    jax = inspect.signature(jax_timing.time_amortized).parameters
    assert list(port) == list(jax)
    assert all(port[a].default == jax[a].default for a in ("k", "warmup"))


def test_kernel_time_unchanged():
    params = inspect.signature(timing.kernel_time).parameters
    assert list(params) == ["fn", "args", "k", "warmup"]
    assert params["k"].default == 10 and params["warmup"].default == 1
    calls = []

    def fn(x):
        calls.append(1)
        time.sleep(COST_S)
        return x

    t = timing.kernel_time(fn, torch.zeros(1), k=5, warmup=2)
    assert len(calls) == 7
    assert 0.8 * COST_S <= t <= 3 * COST_S


def test_kernel_times_reads_the_same_timers():
    """The measurement script and the bench share one implementation of
    the graph and eviction timers."""
    assert kernel_times.graph_ms is timing.graph_ms
    assert kernel_times.cold_ms is timing.cold_ms
    assert kernel_times.capture is timing.capture
