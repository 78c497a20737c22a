"""Hash-table build dwarfs: HashBuild, HashBuildNonBitmask, CuckooHashBuild,
SlabHashBuild.

Reference pipelines (hash/*.cpp): generate keys, build the table on the
device, then a probe-all pass; validation asserts every inserted key is
found. Here the builds are the parking construction, the cuckoo rounds and
the bucketized sort (``ops/``); the probes are chain walks, 2-probe gathers
or the sort-merge probe.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..common.datagen import derive_seed, make_random, make_unique_random
from ..common.result import Result
from ..ops import bucket_hash, cuckoo, hashtable
from ..ops.hashing import murmur3_32, simple_hash
from ..ops.primitives import sort_by_key
from ..utils.timing import sync
from .base import TorchDwarf


def _murmur_build_probe(keys: torch.Tensor, ht_size: int, seed: int):
    """HashBuild pipeline: murmur homes, parking build, probe-all
    (hash/hash_build.cpp:43-75; ht_size = 2 x input, hash_build.cpp:18)."""
    home = murmur3_32(keys, seed, ht_size)
    table = hashtable.build(keys, home, ht_size)
    found, _ = hashtable.probe(table, keys, home)
    return found


def _simple_build_probe(keys: torch.Tensor, ht_size: int):
    """HashBuildNonBitmask pipeline: SimpleHasher homes, ht_size = input
    size (hash_build_non_bitmask.cpp:18-44). The reference's ``insert``
    dedups equal keys into one slot (hashtable.hpp:155-172), so the build
    runs over the distinct keys."""
    sk = sort_by_key(keys, unsigned=True)
    is_first = torch.ones_like(sk, dtype=torch.bool)
    is_first[1:] = sk[1:] != sk[:-1]
    home = torch.where(is_first, simple_hash(sk, ht_size), ht_size)
    table = hashtable.build(sk, home, ht_size, valid=is_first)
    found, _ = hashtable.probe(table, keys, simple_hash(keys, ht_size))
    return found


class HashBuild(TorchDwarf):
    def __init__(self):
        super().__init__("HashBuild")

    def _run(self, buf_size: int, meter) -> None:
        opts = meter.opts
        keys = make_random(
            buf_size, seed=derive_seed(opts.seed, buf_size, 0), dtype=np.uint32
        )
        # hasher seeded once per size, used for all iterations
        # (hash_build.cpp:20)
        hseed = derive_seed(opts.seed, buf_size, 1) & 0xFFFFFFFF
        device = self.device(opts)
        ht_size = 2 * buf_size

        def fn(k):
            return _murmur_build_probe(k, ht_size, hseed)

        for _ in range(opts.iterations):
            found, dev, host_time = self.timed_with_transfer(
                device, fn, (keys,)
            )
            kernel_time = self.kernel_timed(buf_size, fn, *dev)
            result = Result(host_time=host_time, kernel_time=kernel_time)
            result.valid = bool(found.all())
            meter.add_result({"buf_size": str(buf_size)}, result)


class HashBuildNonBitmask(TorchDwarf):
    def __init__(self):
        super().__init__("HashBuildNonBitmask")

    def _run(self, buf_size: int, meter) -> None:
        opts = meter.opts
        keys = make_random(
            buf_size, seed=derive_seed(opts.seed, buf_size, 0), dtype=np.uint32
        )
        device = self.device(opts)

        def fn(k):
            return _simple_build_probe(k, buf_size)

        for _ in range(opts.iterations):
            found, dev, host_time = self.timed_with_transfer(
                device, fn, (keys,)
            )
            kernel_time = self.kernel_timed(buf_size, fn, *dev)
            result = Result(host_time=host_time, kernel_time=kernel_time)
            result.valid = bool(found.all())
            meter.add_result({"buf_size": str(buf_size)}, result)


class CuckooHashBuild(TorchDwarf):
    """Host-controlled retry loop: build with two seeded murmur hashers; on
    non-convergence re-seed both and rebuild. host_time covers every
    attempt (cuckoo_hash_build.cpp:41-93); kernel_time is the bulk ``has``
    over the inserted keys, as the JAX dwarf times it."""

    def __init__(self):
        super().__init__("CuckooHashBuild")

    def _run(self, buf_size: int, meter) -> None:
        opts = meter.opts
        keys = make_unique_random(
            buf_size, seed=derive_seed(opts.seed, buf_size, 0))
        device = self.device(opts)
        ht_size = 4 * buf_size  # cuckoo_hash_build.cpp:14
        # rounds cap, as the JAX dwarf sets it: far past convergence at 4x
        # slots; non-convergence reports success=False and the host
        # re-seeds, the reference's failure-detection semantics
        max_iters = min(buf_size, 256)

        for it in range(opts.iterations):
            (dev_keys,) = self.put(device, keys)
            t0 = time.perf_counter()
            attempt = 0
            while True:
                s1 = derive_seed(opts.seed, buf_size, 1, it, attempt) & 0xFFFFFFFF
                s2 = derive_seed(opts.seed, buf_size, 2, it, attempt) & 0xFFFFFFFF
                table = sync(cuckoo.build(dev_keys, ht_size, s1, s2,
                                          max_iters))
                if table.success:
                    break
                attempt += 1
            host_time = time.perf_counter() - t0
            found = cuckoo.has(table, dev_keys)
            kernel_time = self.kernel_timed(buf_size, cuckoo.has, table,
                                            dev_keys)
            result = Result(host_time=host_time, kernel_time=kernel_time)
            result.valid = bool(found.all())
            meter.add_result({"buf_size": str(buf_size)}, result)


class SlabHashBuild(TorchDwarf):
    """Bucketized build over possibly-duplicate keys (slab_hash_build.cpp:17,
    bucket heuristic slab_hash.hpp:30-58), validated by a find-all pass
    (slab_hash_build.cpp:78-95)."""

    mem_util = 60

    def __init__(self, name: str = "SlabHashBuild"):
        super().__init__(name)

    def _run(self, buf_size: int, meter) -> None:
        opts = meter.opts
        keys = make_random(
            buf_size, seed=derive_seed(opts.seed, buf_size, 0), dtype=np.uint32
        )
        device = self.device(opts)
        nb = bucket_hash.calculate_buckets_count(buf_size, self.mem_util)

        def build(k):
            return bucket_hash.build(k, k, nb)

        for _ in range(opts.iterations):
            table, dev, host_time = self.timed_with_transfer(
                device, build, (keys,)
            )
            kernel_time = self.kernel_timed(buf_size, build, *dev)
            found, _ = bucket_hash.find(table, dev[0])
            result = Result(host_time=host_time, kernel_time=kernel_time)
            result.valid = bool(found.all())
            meter.add_result({"buf_size": str(buf_size)}, result)
