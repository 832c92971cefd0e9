"""Rank meshes over ``torch.distributed`` (port of ``parallel/mesh.py``).

The framework uses a 1-2D logical mesh:
  * ``data``  — data-parallel axis: each rank samples its own voxel
    micro-batches, and gradients and metrics are averaged over the axis
    (``parallel/training.py``);
  * ``space`` — spatial axis: column stripes or volume slabs of a frame
    (``parallel/render.py``).

In torch one process drives one device, so the mesh's devices are the
ranks of the process group: rank ``ranks[d * space + s]`` sits at (d, s),
as JAX's mesh places ``devices[d * space + s]``. Each rank holds one
process group along each axis. Without a process group (one process) the
only mesh is 1 x 1, and its collectives are the identity.

Multi-process: call ``initialize_distributed()`` once per process before
building a mesh: NCCL between CUDA ranks, gloo between CPU ranks.
"""

from __future__ import annotations

import datetime
import os
from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from mri_raytracer_tpu_torch.env import resolve_device

AXES = ("data", "space")


def rendezvous_url(coordinator_address: str) -> str:
    """``init_method`` of a coordinator: ``host:port`` becomes
    ``tcp://host:port``, anything else is a shared file's path
    (``file://``)."""
    host, _, port = coordinator_address.rpartition(":")
    if host and port.isdigit():
        return f"tcp://{coordinator_address}"
    return "file://" + os.path.abspath(coordinator_address)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, device=None,
                           timeout: float = 300.0) -> None:
    """Multi-process bring-up; a no-op for at most one process, as in JAX.

    Joins ``num_processes`` ranks through ``coordinator_address``
    (``rendezvous_url``) as rank ``process_id``, on ``device`` (``cuda``
    unless given): NCCL on a CUDA device, whose index the process then
    uses, gloo on the CPU. No wait lasts longer than ``timeout`` seconds.
    A failed NCCL start is an error: nothing falls back to gloo."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError(f"{num_processes} processes need a coordinator "
                         "address and this process's id")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=rendezvous_url(coordinator_address),
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout))


class MeshAxis(NamedTuple):
    """One axis of a mesh as this rank sees it: its size, this rank's index
    along it and the process group of the ranks that share this rank's
    other coordinate (None without a process group)."""

    name: str
    size: int
    index: int
    group: Optional[dist.ProcessGroup]

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the axis, in place; returns ``t``."""
        if self.group is not None:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t`` along the axis, in axis order."""
        if self.group is None:
            return [t]
        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t, group=self.group)
        return out


class Mesh:
    """A data x space mesh of ranks (``make_mesh``). ``shape`` is
    {"data": d, "space": s}; ``axis(name)`` this rank's ``MeshAxis``."""

    def __init__(self, data: int, space: int, ranks: Sequence[int],
                 rank: int, groups):
        self.shape = {"data": data, "space": space}
        self.ranks = list(ranks)
        self.rank = rank
        self._axes = {}
        if rank in self.ranks:
            d, s = divmod(self.ranks.index(rank), space)
            self._axes = {"data": MeshAxis("data", data, d, groups["data"]),
                          "space": MeshAxis("space", space, s,
                                            groups["space"])}

    def axis(self, name: str) -> MeshAxis:
        if name not in AXES:
            raise ValueError(f"mesh axes are {AXES}, not {name!r}")
        if not self._axes:
            raise ValueError(f"rank {self.rank} is not in the mesh "
                             f"{self.ranks}")
        return self._axes[name]


def make_mesh(data: int = 1, space: int = 1,
              devices: Optional[Sequence[int]] = None) -> Mesh:
    """The data x space mesh of the first ``data * space`` ranks of
    ``devices`` (default: every rank in order). Every rank of the process
    group must call it, with the same arguments, since each group along an
    axis is made by all ranks together."""
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    devices = list(devices) if devices is not None else list(range(world))
    need = data * space
    if need > len(devices):
        raise ValueError(f"mesh {data}x{space} needs {need} devices, "
                         f"have {len(devices)}")
    ranks = devices[:need]
    groups = {"data": None, "space": None}
    if initialized:
        for d in range(data):
            row = ranks[d * space:(d + 1) * space]
            g = dist.new_group(row)
            if rank in row:
                groups["space"] = g
        for s in range(space):
            col = ranks[s::space]
            g = dist.new_group(col)
            if rank in col:
                groups["data"] = g
    return Mesh(data, space, ranks, rank, groups)


class Placement(NamedTuple):
    """How a tensor lies on a mesh: whole on every rank (``axis`` None), or
    split into equal blocks along dimension ``dim`` over mesh axis
    ``axis``, block i on the ranks at index i."""

    mesh: Mesh
    axis: Optional[str]
    dim: int = 0

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's part of the global tensor ``x``."""
        if self.axis is None:
            return x
        ax = self.mesh.axis(self.axis)
        n = x.shape[self.dim]
        if n % ax.size:
            raise ValueError(f"dimension {self.dim} of size {n} does not "
                             f"split over {ax.size} ranks of '{ax.name}'")
        k = n // ax.size
        return x.narrow(self.dim, ax.index * k, k)


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, None)


def data_sharded(mesh: Mesh, axis: int = 0) -> Placement:
    return Placement(mesh, "data", axis)


def space_sharded(mesh: Mesh, axis: int = 0) -> Placement:
    return Placement(mesh, "space", axis)
