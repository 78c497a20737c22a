"""Device meshes over torch.distributed (the port of
``dwarf_bench_tpu/parallel/mesh.py``).

torch.distributed runs one process a device: a rank is a chip. The JAX
package's ``shard_map`` over a global array becomes SPMD code here: every
rank calls the same builder's function on its own row shard, and the
collectives run on the process group of a mesh dimension. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over every rank of the world:
1-D with the dimension ``"x"`` (``ROW_AXIS``), or 2-D ``("dcn", "ici")``,
hosts by the chips of a host, so that a collective can ride the links
inside a host before it crosses hosts (``shuffle.partition_for_shuffle_2d``).

``init_multihost`` brings up the process group: NCCL on the card, gloo when
the caller asks for the CPU (the tests' multi-process double of a pod).
"""

from __future__ import annotations

import os
import socket
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..common.device import resolve_device
from ..common.options import parse_device_type

ROW_AXIS = "x"
DCN_AXIS = "dcn"  # across hosts
ICI_AXIS = "ici"  # within a host


def init_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    device: str = "gpu",
) -> None:
    """Bring up the default process group, once a process; a no-op when it
    is up already. With no ``coordinator_address`` the rendezvous is
    ``env://`` (``MASTER_ADDR``, ``MASTER_PORT``, and ``RANK`` and
    ``WORLD_SIZE`` unless ``process_id`` and ``num_processes`` are given);
    otherwise ``tcp://coordinator_address``. ``device`` is ``"gpu"`` (the
    default: NCCL, on the card ``local_device_ids[0]``, else ``LOCAL_RANK``'s,
    else the rank's modulo the cards; raises without CUDA) or ``"cpu"``
    (gloo)."""
    if dist.is_initialized():
        return
    dev = resolve_device(parse_device_type(str(device)))
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    init_method = ("env://" if coordinator_address is None
                   else f"tcp://{coordinator_address}")
    if dev.type == "cpu":
        dist.init_process_group("gloo", init_method=init_method, **kwargs)
        return
    if local_device_ids:
        index = int(local_device_ids[0])
    else:
        rank = kwargs.get("rank", int(os.environ.get("RANK", "0")))
        index = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
    torch.cuda.set_device(index)
    dist.init_process_group("nccl", init_method=init_method,
                            device_id=torch.device("cuda", index), **kwargs)


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def local_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device: its card under NCCL, the CPU under gloo."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def axis_size(mesh: DeviceMesh, name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(name))


def make_mesh(n_devices: Optional[int] = None) -> DeviceMesh:
    """The 1-D mesh ``("x",)`` over every rank. ``n_devices``, where given,
    must be the world size: a mesh spans the world, as the collectives over
    several of its dimensions run on the world's group."""
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"make_mesh: {n} devices in a world of {world}; a "
                         "mesh spans every rank")
    return init_device_mesh(_device_type(), (n,), mesh_dim_names=(ROW_AXIS,))


def _host_count() -> int:
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, socket.gethostname())
    return len(set(names))


def make_mesh_2d(
    n_hosts: Optional[int] = None,
    chips_per_host: Optional[int] = None,
) -> DeviceMesh:
    """The ``(dcn, ici)`` mesh over every rank, rank-major. Defaults: the
    hosts the ranks run on (their distinct host names; ranks must be
    numbered host by host, as torchrun numbers them) and the world over
    them. Pass both to fake a multi-host layout on one host."""
    world = dist.get_world_size()
    if n_hosts is None:
        n_hosts = _host_count()
    if chips_per_host is None:
        chips_per_host = world // n_hosts
    if n_hosts * chips_per_host != world:
        raise ValueError(f"make_mesh_2d: {n_hosts} x {chips_per_host} ranks "
                         f"in a world of {world}; a mesh spans every rank")
    return init_device_mesh(_device_type(), (n_hosts, chips_per_host),
                            mesh_dim_names=(DCN_AXIS, ICI_AXIS))


def row_sharding(mesh: DeviceMesh):
    """Rows split across all the mesh's dimensions, major to minor: the
    DTensor placements of ``P(tuple(axis_names))``."""
    from torch.distributed.tensor import Shard

    return tuple(Shard(0) for _ in mesh.mesh_dim_names)


def replicated(mesh: DeviceMesh):
    """The same value on every rank: the DTensor placements of ``P()``."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def linear_index(mesh: DeviceMesh) -> int:
    """This rank's chip number in the mesh, row-major over its dimensions
    (dcn_idx * n_ici + ici_idx on a 2-D mesh)."""
    return int(np.ravel_multi_index(tuple(mesh.get_coordinate()),
                                    tuple(mesh.shape)))


def shard_rows(mesh: DeviceMesh, *arrays):
    """This rank's contiguous row shard of each host array (the same full
    arrays on every rank), as an int32 tensor on the rank's device: uint32
    columns as their bit patterns. A single array gives a tensor, several a
    tuple."""
    n_shards = mesh.size()
    me = linear_index(mesh)
    dev = local_device(mesh)
    out = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        if a.dtype.itemsize != 4 or a.dtype.kind not in "iu":
            raise ValueError(f"shard_rows: 32-bit integer columns, got "
                             f"{a.dtype}")
        if a.shape[0] % n_shards:
            raise ValueError(f"shard_rows: {a.shape[0]} rows over "
                             f"{n_shards} chips")
        per = a.shape[0] // n_shards
        part = a[me * per:(me + 1) * per].view(np.int32)
        out.append(torch.from_numpy(part.copy()).to(dev))
    return out[0] if len(out) == 1 else tuple(out)
