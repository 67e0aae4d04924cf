"""Several processes, several nodes: the process group and global meshes.

Counterpart of the JAX package's `parallel/multihost.py`. JAX's
multi-controller runtime gives every host process the same program over
the global device set; in PyTorch every rank is a process of its own, and
the terms map so:

  JAX                                  here
  process (one a host)                 node: the ranks of one machine
  device                               rank (one a CUDA card, or a CPU rank)
  `coordinator` "host:port"            `init_method` "tcp://host:port"
  `num_processes`, `process_id`        `world_size`, `rank` (over all nodes)
  `local_device_ids`                   `local_world_size`: ranks a node
  `jax.process_index/count()`          node index / count
  `jax.local_device_count()`           `local_world_size`
  `jax.device_count()`                 world size

Typical launch, one process a card on every node:

    from pytheiasfm_tpu_torch.parallel import multihost
    multihost.initialize("tcp://10.0.0.1:8476", world_size=8, rank=RANK,
                         local_world_size=4)
    mesh = multihost.global_mesh()          # every rank of every node
    mesh2 = multihost.global_mesh_2d()      # ("host", "chip"): nodes x ranks

The backend: NCCL where each rank has a CUDA card of its own; gloo for CPU
tensors, and for CUDA tensors where ranks share a card (NCCL refuses two
ranks on one device), which it carries through the host
(`backend="cpu:gloo,cuda:gloo"`). A rank on a card uses
`cuda:(rank % device_count)`.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

__all__ = ["initialize", "global_mesh", "global_mesh_2d", "process_info", "is_initialized"]

_state = {"local_world_size": None}


def initialize(
    init_method: str,
    world_size: int,
    rank: int,
    backend: str | None = None,
    local_world_size: int | None = None,
    timeout_s: float = 300.0,
) -> None:
    """`torch.distributed.init_process_group` with the arguments every rank
    must agree on. `backend` None: NCCL when there are CUDA cards, gloo
    otherwise. `local_world_size`: the ranks of one node (None: the
    `LOCAL_WORLD_SIZE` environment variable, else every rank on one node).
    The group's `timeout_s` bounds every collective, so that ranks that
    disagree about the collectives they run fail instead of waiting for
    ever. A rank on a card is pinned to `cuda:(rank % device_count)`."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if local_world_size is None:
        local_world_size = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if world_size % local_world_size:
        raise ValueError(f"{world_size} ranks do not divide into nodes of {local_world_size}")
    if "cuda" in backend or backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend=backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    _state["local_world_size"] = int(local_world_size)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_info():
    """(node index, node count, ranks a node, world size): the JAX
    package's (process_index, process_count, local_device_count,
    device_count)."""
    world = dist.get_world_size()
    local = _state["local_world_size"] or world
    return dist.get_rank() // local, world // local, local, world


def _device_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def global_mesh(axis_name: str = "data"):
    """1-D mesh over every rank of every node, in rank order: ranks of one
    node are contiguous, so the data axis crosses nodes only at their
    boundaries."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_device_type(), (dist.get_world_size(),),
                            mesh_dim_names=(axis_name,))


def global_mesh_2d(axis_names=("host", "chip")):
    """2-D (nodes x ranks a node) mesh: the `host` dimension crosses nodes,
    the `chip` dimension stays within one. Every node must hold the same
    number of ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    local = _state["local_world_size"] or world
    if world % local:
        raise ValueError(f"uneven rank distribution: {world} ranks over nodes of {local}")
    return init_device_mesh(_device_type(), (world // local, local),
                            mesh_dim_names=tuple(axis_names))
