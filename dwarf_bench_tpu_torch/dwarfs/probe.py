"""SlabProbe: times only the probe phase of the bucketized hash table (the
build happens outside the timer, probe/slab_probe.cpp:40-63); keys are
unique (slab_probe.cpp:16)."""

from __future__ import annotations

from ..common.datagen import derive_seed, make_unique_random
from ..common.result import Result
from ..ops import bucket_hash
from ..utils.timing import sync, timed
from .base import TorchDwarf


class SlabProbe(TorchDwarf):
    mem_util = 60

    def __init__(self):
        super().__init__("SlabProbe")

    def _run(self, buf_size: int, meter) -> None:
        opts = meter.opts
        keys = make_unique_random(
            buf_size, seed=derive_seed(opts.seed, buf_size, 0)
        )
        device = self.device(opts)
        nb = bucket_hash.calculate_buckets_count(buf_size, self.mem_util)
        (dev_keys,) = self.put(device, keys)
        table = sync(bucket_hash.build(dev_keys, dev_keys, nb))  # untimed

        for _ in range(opts.iterations):
            (found, _), host_time = timed(bucket_hash.find, table, dev_keys)
            kernel_time = self.kernel_timed(buf_size, bucket_hash.find,
                                            table, dev_keys)
            result = Result(host_time=host_time, kernel_time=kernel_time)
            result.valid = bool(found.all())
            meter.add_result({"buf_size": str(buf_size)}, result)
