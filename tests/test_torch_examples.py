"""The examples' kernels (``ops/vadd_cuda.py``, ``ops/lock_add_cuda.py``)
and the port's examples against ``examples/*.py`` on the CPU, exactly: the
Pallas kernels run in interpret mode (``vadd_pallas``, which takes no
``interpret`` argument, under ``force_tpu_interpret_mode``)."""

import contextlib
import importlib.util
import io
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dwarf_bench_tpu_torch.examples import bench_usage, lock_add, vadd
from dwarf_bench_tpu_torch.ops import lock_add_cuda, vadd_cuda

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_vadd():
    return _jax_example("vadd")


@pytest.mark.parametrize("shape", [(8, 128), (16, 256), (2, 8, 128), (1,)])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_vadd_matches_pallas(rng, jax_vadd, shape, dtype):
    if dtype == np.float32:
        a = rng.standard_normal(shape).astype(dtype) * 1e3
        b = rng.standard_normal(shape).astype(dtype)
    else:  # sums past INT32_MAX wrap
        a = rng.integers(-(2**31), 2**31, shape).astype(dtype)
        b = rng.integers(-(2**31), 2**31, shape).astype(dtype)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_vadd.vadd_pallas(jnp.asarray(a), jnp.asarray(b)))
    for fn in (vadd_cuda.vadd_plain, vadd_cuda.vadd_pallas):
        got = fn(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_vadd_rejects_what_the_kernel_does_not_take():
    f64 = torch.zeros(4, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32 or int32"):
        vadd_cuda.vadd_pallas(f64, f64)
    i32 = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="differ"):
        vadd_cuda.vadd_pallas(i32, torch.zeros(5, dtype=torch.int32))
    with pytest.raises(ValueError, match="differ"):
        vadd_cuda.vadd_pallas(i32, i32.float())
    m = torch.zeros(4, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="contiguous"):
        vadd_cuda.vadd_pallas(m.t(), m)


@pytest.mark.parametrize("n_steps", [1, 64, 1000])
def test_grid_accumulate_matches_pallas(n_steps):
    ref = np.asarray(_jax_example("lock_add").grid_accumulate(
        n_steps, interpret=True))
    for fn in (lock_add_cuda.grid_accumulate_plain,
               lock_add_cuda.grid_accumulate):
        got = fn(n_steps, device="cpu")
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("n_steps,resident", [(1, None), (2, None),
                                              (64, None), (1000, 7),
                                              (1 << 16, 4224)])
def test_ticket_lock_serves_in_ticket_order(n_steps, resident):
    """The card's ticket lock rendered on the CPU: blocks start in a drawn
    order, at most ``resident`` at once (4224: 32 blocks an SM on an
    H100), each holder finds the counter equal to its ticket, the result
    equals the Pallas example's, and the scratch is left zero for the next
    call on the stream."""
    out, seen, scratch = lock_add_cuda._ticket_schedule(
        n_steps, seed=n_steps, resident=resident)
    assert seen == list(range(n_steps))
    assert out == n_steps
    if n_steps <= 1000:
        assert out == int(np.asarray(_jax_example("lock_add").grid_accumulate(
            n_steps, interpret=True))[0, 0])
    assert scratch == (0, 0, 0)


def test_grid_accumulate_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lock_add_cuda.grid_accumulate(64)
    with pytest.raises(ValueError, match="n_steps"):
        lock_add_cuda.grid_accumulate(0, device="cpu")


def _stdout(main, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(*args)
    return rc, out.getvalue().splitlines()


def test_vadd_example_prints_the_jax_lines(jax_vadd):
    with pltpu.force_tpu_interpret_mode():
        _, expected = _stdout(jax_vadd.main)
    rc, lines = _stdout(vadd.main, ["--device=cpu"])
    assert rc == 0
    assert lines == expected == ["xla vadd ok: True", "pallas vadd ok: True"]


def test_lock_add_example_prints_the_jax_line():
    _, expected = _stdout(_jax_example("lock_add").main)
    rc, lines = _stdout(lock_add.main, ["--device=cpu"])
    assert rc == 0 and lines == expected == ["64 = 64"]


def test_bench_usage_example_matches_jax():
    _, expected = _stdout(_jax_example("bench_usage").main)
    rc, lines = _stdout(bench_usage.main, ["--device=cpu"])
    assert rc == 0
    pattern = re.compile(r"(Sort|GroupBy): dataSize=1024 microseconds=\d+$")

    def measured(out):
        return [pattern.match(line).group(1) for line in out
                if pattern.match(line)]

    assert measured(lines) == measured(expected) == \
        ["Sort"] * 10 + ["GroupBy"] * 10


@pytest.mark.parametrize("example", [bench_usage, vadd, lock_add])
def test_examples_default_to_the_card(monkeypatch, example):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        example.main([])
