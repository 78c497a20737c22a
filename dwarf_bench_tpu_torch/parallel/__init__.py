"""The distributed layer over torch.distributed: the port of
``dwarf_bench_tpu/parallel/``, with the same 21 public names. A builder
takes the mesh and the sizes, as the JAX one does, and returns a function
of this rank's local tensors (``mesh.py`` says how ``shard_map`` maps onto
SPMD code)."""

from .mesh import (
    DCN_AXIS,
    ICI_AXIS,
    ROW_AXIS,
    init_multihost,
    make_mesh,
    make_mesh_2d,
    replicated,
    row_sharding,
    shard_rows,
)
from .dist_groupby import dist_groupby_dense, dist_groupby_shuffle
from .dist_join import (
    dist_csr_join,
    dist_csr_join_2d,
    dist_csr_join_ring,
    dist_csr_join_ring_2d,
    dist_csr_join_skew,
    dist_hash_join_rows,
)
from .dist_scan import dist_filter
from .dist_sort import dist_sort
from .shuffle import partition_for_shuffle, partition_for_shuffle_2d

__all__ = [
    "DCN_AXIS",
    "ICI_AXIS",
    "ROW_AXIS",
    "init_multihost",
    "make_mesh",
    "make_mesh_2d",
    "replicated",
    "row_sharding",
    "shard_rows",
    "dist_groupby_dense",
    "dist_groupby_shuffle",
    "dist_csr_join",
    "dist_csr_join_2d",
    "dist_csr_join_ring",
    "dist_csr_join_ring_2d",
    "dist_csr_join_skew",
    "dist_hash_join_rows",
    "dist_filter",
    "dist_sort",
    "partition_for_shuffle",
    "partition_for_shuffle_2d",
]
