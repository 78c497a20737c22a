"""Port parity: dwarf_bench_tpu_torch.ops.cumsum_cuda against the JAX
Pallas cumsum (interpret mode on the CPU), and the counting sort's run
expansion. All outputs are integers, so the tolerance is exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from dwarf_bench_tpu.ops.cumsum_pallas import cumsum_pallas
from dwarf_bench_tpu.ops.sort import _expand_runs as jax_expand_runs
from dwarf_bench_tpu.ops.sort import histogram_16k
from dwarf_bench_tpu_torch.ops import cumsum_cuda
from dwarf_bench_tpu_torch.ops.primitives import wrap_i32
from dwarf_bench_tpu_torch.ops.sort import _expand_runs


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.int32))


@pytest.mark.parametrize("n", [1, 1000, 131_072 + 5])
def test_matches_pallas(rng, n):
    x = (rng.random(n) < 0.01).astype(np.int32) * rng.integers(
        1, 5, n).astype(np.int32)
    ref = np.asarray(cumsum_pallas(jnp.asarray(x), interpret=True))
    got = cumsum_cuda.cumsum(_t(x))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("carry", [-7, 0, 2**31 - 5])
def test_carry_init_and_negatives(rng, carry):
    x = rng.integers(-3, 4, 50_000).astype(np.int32)
    ref = np.asarray(cumsum_pallas(jnp.asarray(x), carry_init=carry,
                                   interpret=True))
    assert np.array_equal(cumsum_cuda.cumsum(_t(x), carry).numpy(), ref)
    # a one-element device tensor carries the same value
    got = cumsum_cuda.cumsum(_t(x), _t([carry]))
    assert np.array_equal(got.numpy(), ref)


def test_wide_multiplicities(rng):
    """Values past bf16's 256 exact-int limit: the two-plane TPU case of
    tests/test_cumsum_pallas.py::test_wide_multiplicities."""
    s = np.zeros(25600, np.int32)
    np.add.at(s, rng.integers(0, 25600, 10240), 1)
    s[7] = 9000
    s[200] = 300
    ref = np.asarray(cumsum_pallas(jnp.asarray(s), interpret=True))
    assert np.array_equal(cumsum_cuda.cumsum(_t(s)).numpy(), ref)


def test_wraps_mod_2p32(rng):
    """Sums past 2^31 and 2^32, outside the TPU kernel's precondition: the
    contract is int32 wrap, as jnp.cumsum on int32."""
    x = np.full(4099, 1 << 30, np.int32)
    x[::5] = rng.integers(-(2**31), 2**31, x[::5].size)
    ref = np.asarray(jnp.cumsum(jnp.asarray(x), dtype=jnp.int32)) + np.int32(3)
    assert np.array_equal(cumsum_cuda.cumsum(_t(x), 3).numpy(), ref)


@pytest.mark.parametrize("n", [256, 25_600])
@pytest.mark.parametrize("keys", ["random", "all_equal"])
def test_expand_runs_matches_pallas_path(rng, n, keys):
    """The counting sort's run expansion against the JAX accelerator path
    (force_pallas + interpret), including the degenerate all-equal column
    whose boundary multiplicity exceeds 255 (the two-plane dispatch)."""
    k = (rng.integers(0, 10000, n) if keys == "random"
         else np.full(n, 9000)).astype(np.int32)
    counts = histogram_16k(jnp.asarray(k), hi_bins=80)
    ref = np.asarray(jax_expand_runs(counts, n, force_pallas=True,
                                     interpret=True))
    got = _expand_runs(_t(np.asarray(counts)), n)
    assert np.array_equal(got.numpy(), ref)
    assert np.array_equal(got.numpy(), np.sort(k))


def test_rejects_bad_carry():
    x = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        cumsum_cuda.cumsum(x, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        cumsum_cuda.cumsum(x, torch.zeros(1, dtype=torch.int64))



@pytest.mark.parametrize("carry", [-(2**31), 2**31 - 1, 2**32 + 5, -1, 0,
                                   -(2**33) - 7])
def test_int_carry_packs_like_wrap_i32(carry):
    """An int carry goes to the kernel by value, wrapped on the host to the
    int32 that ``wrap_i32`` (the plain version's carry) gives."""
    tensor, value = cumsum_cuda.pack_carry(carry, torch.device("cpu"))
    assert tensor is None
    exp = wrap_i32(torch.tensor([carry], dtype=torch.int64))
    assert value == int(exp[0])
    assert -(2**31) <= value < 2**31


def test_tensor_carry_packs_as_a_tensor():
    carry = _t([-(2**31)])
    tensor, value = cumsum_cuda.pack_carry(carry, carry.device)
    assert tensor is not None and tensor.data_ptr() == carry.data_ptr()
    assert value == 0
