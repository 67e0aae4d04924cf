"""Device meshes and the collectives the estimators run on them.

Counterpart of the JAX package's `parallel/sharding.py`. The scaling axes
are the JAX package's: the observation axis of bundle adjustment (its
per-view and per-track blocks are segment sums: each device sums its share,
one reduction combines them), the pair axis of matching and the track axis
of triangulation, with the edge axis of rotation averaging and LUD.

JAX is single-controller: one process holds the mesh and XLA inserts the
collectives. PyTorch is multi-controller, and the port takes that form:

  - every rank runs the same entry point on the same inputs and options;
  - each rank computes its shard of the sharded axis (contiguous blocks in
    rank order, the axis padded to a multiple of the mesh size);
  - an explicit `all_reduce` stands wherever the JAX package has a `psum`
    or a reduction GSPMD inserts;
  - a decision that steers a loop is rank 0's value, broadcast, so that no
    rank takes a branch the others do not (on a CUDA card `index_add_` adds
    by atomics, and replicated work may differ in the last bits);
  - every entry point ends by broadcasting rank 0's replicated result, so
    that all ranks return the same bits.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over an initialized
default process group (`parallel.multihost.initialize`); the estimators
read it through `MeshAxis` (`mesh_axis`), the counterpart of the JAX
package's `int(np.prod(mesh.shape.values()))` and `mesh.axis_names[0]`.
A mesh of several dimensions is taken whole, flattened in row-major order,
and must then span every rank of the default group.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "MeshAxis",
    "collective_stats",
    "gather_shards",
    "local_shard",
    "make_mesh",
    "mesh_axis",
    "pad_to_multiple",
    "replicated",
    "reset_collective_stats",
    "shard_observations",
]


def _device_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_mesh(num_devices: int | None = None, axis_name: str = "data"):
    """A 1-D `DeviceMesh` named `(axis_name,)` over ranks 0..num_devices-1
    of the default process group (None: every rank), on the CUDA cards when
    there are any, else on the CPU. Raises without an initialized default
    group: a mesh never falls back to a run on one device."""
    from torch.distributed.device_mesh import DeviceMesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialized default process group "
                           "(pytheiasfm_tpu_torch.parallel.multihost.initialize)")
    world = dist.get_world_size()
    n = world if num_devices is None else int(num_devices)
    if not 1 <= n <= world:
        raise ValueError(f"make_mesh: {n} devices asked for, {world} ranks in the group")
    return DeviceMesh(_device_type(), list(range(n)), mesh_dim_names=(axis_name,))


def _placements(mesh, sharded_dim):
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(0) if d == sharded_dim else Replicate() for d in range(mesh.ndim))


def replicated(mesh):
    """The placements of a tensor replicated on every rank of `mesh` (the
    JAX package's `NamedSharding(mesh, P())`)."""
    return _placements(mesh, None)


def shard_observations(mesh, axis_name: str = "data"):
    """The placements of a tensor whose leading axis is sharded over the
    mesh dimension `axis_name` (the JAX package's
    `NamedSharding(mesh, P(axis_name))`)."""
    names = mesh.mesh_dim_names or ()
    if axis_name not in names:
        raise ValueError(f"mesh has no dimension {axis_name!r} (its dimensions: {names})")
    return _placements(mesh, names.index(axis_name))


def pad_to_multiple(arr, multiple: int, axis: int = 0, fill=0):
    """Pad an axis so that it divides evenly across the mesh: (padded, the
    axis's length before). numpy, as the JAX package's."""
    n = arr.shape[axis]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return arr, n
    pad_width = [(0, 0)] * arr.ndim
    pad_width[axis] = (0, target - n)
    return np.pad(np.asarray(arr), pad_width, constant_values=fill), n


# ------------------------------------------------------------ collectives

collective_stats = {"all_reduce": 0, "broadcast": 0, "all_gather": 0, "seconds": 0.0}
_timing = {"on": False}


def reset_collective_stats(timing: bool = False) -> None:
    """Zero `collective_stats`. With `timing`, each collective is timed from
    a device synchronize before it to one after it (its cost is then in the
    run's time); without, only counted."""
    for k in collective_stats:
        collective_stats[k] = 0 if k != "seconds" else 0.0
    _timing["on"] = bool(timing)


class _Timed:
    def __init__(self, kind, device):
        self.kind, self.device = kind, device

    def __enter__(self):
        collective_stats[self.kind] += 1
        if _timing["on"]:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if _timing["on"]:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            collective_stats["seconds"] += time.perf_counter() - self.t0


class MeshAxis:
    """The flattened mesh as the estimators use it: its `size`, this rank's
    `index` in it, the process `group` over it, and the collectives."""

    def __init__(self, mesh):
        self.ranks = [int(r) for r in mesh.mesh.flatten().tolist()]
        if mesh.ndim == 1:
            self.group = mesh.get_group()
        else:
            if sorted(self.ranks) != list(range(dist.get_world_size())):
                raise ValueError("a mesh of several dimensions must span every rank of the "
                                 "default process group")
            self.group = dist.group.WORLD
        self.size = len(self.ranks)
        self.index = self.ranks.index(dist.get_rank())
        self.src = self.ranks[0]
        self.backend = dist.get_backend(self.group)
        # gloo carries a CUDA tensor through the host: copying it there and
        # reducing on gloo's CPU path takes a fraction of the time of its
        # CUDA path (ranks that share a card, `parallel.multihost`).
        self.staged = "nccl" not in self.backend

    # -------------------------------------------------------------- shards

    def block(self, n: int) -> tuple[int, int]:
        """This rank's block [lo, hi) of an axis of any length `n`: blocks
        of ceil(n / size), the last ones short or empty."""
        per = -(-n // self.size)
        lo = min(n, self.index * per)
        return lo, min(n, lo + per)

    def shard(self, x):
        """This rank's block of the leading axis of `x` (numpy or torch),
        whose length must be a multiple of the mesh size."""
        if len(x) % self.size:
            raise ValueError(f"an axis of {len(x)} does not divide over {self.size} ranks")
        lo, hi = self.block(len(x))
        return x[lo:hi]

    def _wire(self, x):
        """`x` as it travels: a contiguous copy, on the host where gloo
        carries it, booleans as bytes."""
        y = x.to("cpu", copy=True) if self.staged else x.clone()
        y = y.contiguous()
        return y.to(torch.uint8) if y.dtype == torch.bool else y

    def _back(self, y, x):
        y = y.bool() if x.dtype == torch.bool else y
        return y.to(x.device)

    def gather(self, x):
        """The blocks of every rank concatenated along the leading axis in
        rank order (`all_gather`: every rank's block has the same shape)."""
        wire = self._wire(x)
        parts = [torch.empty_like(wire) for _ in range(self.size)]
        with _Timed("all_gather", x.device):
            dist.all_gather(parts, wire, group=self.group)
        return self._back(torch.cat(parts), x)

    # ---------------------------------------------------------- reductions

    def sum(self, x):
        """`all_reduce` (sum) of `x` over the mesh: the JAX package's `psum`.
        Returns a new tensor; `x` is left as it was."""
        with _Timed("all_reduce", x.device):
            y = self._wire(x)
            dist.all_reduce(y, group=self.group)
            return self._back(y, x)

    def broadcast(self, x):
        """Rank 0's `x` on every rank (a new tensor)."""
        with _Timed("broadcast", x.device):
            y = self._wire(x)
            dist.broadcast(y, src=self.src, group=self.group)
            return self._back(y, x)

    def decide(self, flag) -> bool:
        """Rank 0's truth value of `flag` (a tensor or a Python value): the
        branch every rank takes."""
        t = torch.as_tensor(flag).reshape(1).to(torch.float32)
        if not self.staged:
            t = t.to(torch.device("cuda", torch.cuda.current_device()))
        return bool(self.broadcast(t)[0] != 0)

    def broadcast_object(self, obj):
        """Rank 0's picklable `obj` on every rank."""
        box = [obj]
        device = (torch.device("cuda", torch.cuda.current_device())
                  if self.backend == "nccl" else None)
        with _Timed("broadcast", device or torch.device("cpu")):
            dist.broadcast_object_list(box, src=self.src, group=self.group, device=device)
        return box[0]


def mesh_axis(mesh) -> MeshAxis | None:
    """`MeshAxis` of a mesh, None for None (the run on one device)."""
    if mesh is None:
        return None
    if isinstance(mesh, MeshAxis):
        return mesh
    return MeshAxis(mesh)


def local_shard(x, mesh):
    """This rank's block of the leading axis of `x`, the axis first padded
    with zeros to a multiple of the mesh size (the torch form of
    `jax.device_put(x, NamedSharding(mesh, P(axis_name)))`). numpy in, numpy
    out; torch in, torch out."""
    ax = mesh_axis(mesh)
    if isinstance(x, torch.Tensor):
        pad = -len(x) % ax.size
        if pad:
            x = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])
        return ax.shard(x)
    return ax.shard(pad_to_multiple(np.asarray(x), ax.size)[0])


def gather_shards(x_local, mesh, n: int | None = None):
    """The rank blocks of `local_shard` gathered back in rank order along the
    leading axis (every rank the whole tensor), cut to `n` rows: reading a
    sharded array back."""
    out = mesh_axis(mesh).gather(x_local)
    return out if n is None else out[:n]
