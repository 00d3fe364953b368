"""Process-group bring-up and host-aware meshes (port of
parallel/multihost.py).

The two parallel axes of the port:

  * 'd' (streams, parallel/batch_runner.py): camera streams are
    independent, so a 'd' group exchanges nothing and may span hosts.
  * 'p' (the covariance, parallel/sharding.py): the sharded step sums
    H P strips and gathers small blocks every frame, so 'p' stays inside
    a host, where its collectives ride NVLink.

``make_host_mesh`` lays a (hosts, devices per host) mesh out that way.
Bring-up on each process::

    from openekfmonoslam_tpu_torch.parallel import multihost
    multihost.initialize("10.0.0.1:29500", num_processes=8, process_id=r)
    mesh = multihost.make_host_mesh()

With no address and no ``MASTER_ADDR`` in the environment, one process
starts a process group of its own (world size 1), so single-process runs
work unchanged.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from openekfmonoslam_tpu_torch.engine.step import resolve_device


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               device=None) -> bool:
    """Start the default process group; True when it spans several
    processes.

    ``coordinator_address`` "host:port" gives a ``tcp://`` rendezvous,
    else ``env://`` (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``).  The backend defaults to NCCL when ``device`` (as for
    ``SlamRuntime``: the card unless the caller passes "cpu") is a CUDA
    device, and gloo on the CPU; ``backend="gloo"`` with CUDA tensors is
    how several ranks share one card.  NCCL that cannot start raises: it
    never falls back to gloo.  A group already started is kept."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        if not (torch.cuda.is_available() and dist.is_nccl_available()):
            raise RuntimeError("NCCL was asked for but this process has no "
                               "CUDA device or no NCCL")
        torch.cuda.set_device(dev)
    if coordinator_address is None and "MASTER_ADDR" not in os.environ:
        if num_processes not in (None, 1):
            raise ValueError("several processes need a coordinator address "
                             "or MASTER_ADDR")
        dist.init_process_group(backend, store=dist.HashStore(),
                                world_size=1, rank=0)
        return False
    init = (f"tcp://{coordinator_address}" if coordinator_address
            else "env://")
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes if num_processes
                            is not None else -1,
                            rank=process_id if process_id is not None
                            else -1)
    return dist.get_world_size() > 1


def local_devices() -> int:
    """Devices a host: ``LOCAL_WORLD_SIZE``, else the CUDA device count,
    else 1."""
    if "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_WORLD_SIZE"])
    return torch.cuda.device_count() or 1


def make_host_mesh(axis_hosts: str = "d", axis_local: str = "p",
                   device=None) -> DeviceMesh:
    """The (hosts, devices per host) mesh of the started process group:
    ``axis_hosts`` across hosts, ``axis_local`` within each.  Ranks are
    numbered host by host, so a host's ranks form one ``axis_local``
    group."""
    world = dist.get_world_size()
    local = min(local_devices(), world)
    if world % local:
        raise ValueError(f"{world} ranks do not split into hosts of {local}")
    return init_device_mesh(resolve_device(device).type,
                            (world // local, local),
                            mesh_dim_names=(axis_hosts, axis_local))


def local_batch_slice(global_batch: int, mesh: DeviceMesh | None = None,
                      axis: str = "d") -> slice:
    """The [start, stop) slice of a stream batch sharded over ``mesh``'s
    ``axis`` (without a mesh, over the process group's ranks) that this
    rank owns -- for feeding per-rank frame sources."""
    if mesh is not None:
        n = mesh.shape[list(mesh.mesh_dim_names).index(axis)]
        i = mesh.get_local_rank(axis)
    elif dist.is_initialized():
        n, i = dist.get_world_size(), dist.get_rank()
    else:
        n, i = 1, 0
    if global_batch % n:
        raise ValueError(f"{global_batch} streams do not split over {n}")
    per = global_batch // n
    return slice(i * per, (i + 1) * per)
