"""Rank meshes over a torch.distributed process group.

Port of ``multimot_track_tpu.parallel.mesh``.  A JAX mesh is an array of
devices with named axes, and XLA inserts the collectives a sharding needs.
Here every rank is one process computing on one device, a mesh is an array
of ranks with named axes, and the collectives are explicit:
``Mesh.all_reduce`` (SUM for ``psum``, MAX for ``pmax``) and
``Mesh.all_gather_rows``.  A sharded ``jax.Array`` becomes each rank's own
rows (``LocalRows``): no rank holds the whole batch.

Axes:
  "pair"  — data parallelism over frame pairs (batch axis of the tracker);
  "point" — sharding of a single solve's point set (distributed BA).

Transport: the process group's backend.  NCCL on the card; gloo on the
CPU, and for ranks that share one card.  gloo's route for a CUDA tensor is
through host memory, for every collective: the tensor is copied to the
host, reduced or gathered there, and copied back.  ``Mesh.counts`` counts
the collectives a mesh issued, and the ones staged that way under
``"staged <name>"``.

A mesh of one rank needs no process group: without one, its collectives
return a copy of their input.  A mesh of more ranks needs the group that
``multihost.initialize`` (or the caller) brought up; nothing here starts one.
"""

from __future__ import annotations

import collections
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from multimot_track_tpu_torch.pipeline.frames import tree_leaves, tree_map

PAIR_AXIS = "pair"
POINT_AXIS = "point"

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class Mesh:
    """Ranks in an n-d array with named axes.

    ``ranks`` holds global ranks in the mesh's shape, ascending in flat (C)
    order (the order of the group's all-gather), which is the order of the
    rows a sharded batch gives each rank.  ``device_type`` is where each
    rank computes ("cuda": its current CUDA device).  ``group`` is the
    process group of the mesh's ranks (None: the default group, or no group
    for a one-rank mesh in a plain process)."""

    def __init__(self, ranks, axis_names: Sequence[str], device_type: str = "cuda",
                 group: Optional[dist.ProcessGroup] = None):
        self.ranks = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.ranks.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.ranks.shape} with axes {self.axis_names}")
        if device_type not in ("cuda", "cpu"):
            raise ValueError(f"device_type must be 'cuda' or 'cpu', not {device_type!r}")
        if device_type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh needs a CUDA device, and none is available")
        self.device_type = device_type
        self.group = group
        self.backend = dist.get_backend(group) if dist.is_initialized() else None
        if self.backend is None and self.ranks.size > 1:
            raise RuntimeError("a mesh of more than one rank needs an initialised process "
                               "group (parallel.multihost.initialize)")
        if self.backend == "nccl" and device_type != "cuda":
            raise ValueError("NCCL moves CUDA tensors only: use device_type='cuda'")
        self.counts = collections.Counter()

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.ranks.shape))

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    @property
    def device(self) -> torch.device:
        if self.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    def position(self) -> int:
        """This rank's index in the mesh's flat order."""
        rank = dist.get_rank() if self.backend is not None else 0
        hit = np.flatnonzero(self.ranks.ravel() == rank)
        if hit.size == 0:
            raise RuntimeError(f"rank {rank} is not in the mesh {self.ranks.tolist()}")
        return int(hit[0])

    def _staged(self, x: torch.Tensor) -> bool:
        return self.backend == "gloo" and x.is_cuda

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``op`` ("sum" or "max") of ``x`` over the mesh's ranks, as a new
        tensor on ``x``'s device."""
        if self.backend is None:
            return x.clone()
        self.counts["all_reduce"] += 1
        staged = self._staged(x)
        y = x.detach().to("cpu" if staged else x.device, copy=True).contiguous()
        if staged:
            self.counts["staged all_reduce"] += 1
        dist.all_reduce(y, op=_OPS[op], group=self.group)
        return y.to(x.device) if staged else y

    def all_gather_rows(self, x: torch.Tensor, counts: Sequence[int]) -> torch.Tensor:
        """Every rank's rows of ``x`` (this rank's (counts[position], ...)),
        concatenated in mesh order, as a new tensor on ``x``'s device."""
        if self.backend is None:
            return x.clone()
        m, row_shape = max(counts), tuple(x.shape[1:])
        if m == 0 or 0 in row_shape:          # nothing to move
            return x.new_empty((sum(counts),) + row_shape)
        self.counts["all_gather"] += 1
        staged = self._staged(x)
        if staged:
            self.counts["staged all_gather"] += 1
        y = x.detach().to("cpu" if staged else x.device)
        if x.dtype == torch.bool:
            y = y.to(torch.uint8)
        if y.shape[0] < m:
            y = torch.cat([y, y.new_zeros((m - y.shape[0],) + row_shape)], 0)
        y = y.contiguous()
        bufs = [torch.empty_like(y) for _ in range(self.size)]
        dist.all_gather(bufs, y, group=self.group)
        out = torch.cat([b[:c] for b, c in zip(bufs, counts)], 0)
        return out.to(device=x.device, dtype=x.dtype)

    def shard_rows(self, tree) -> "LocalRows":
        """This rank's rows of a whole batch ``tree`` (leading axis B,
        split evenly over the mesh in flat order)."""
        B = _batch_size(tree)
        if B % self.size:
            raise ValueError(f"a batch of {B} rows does not divide over {self.size} ranks")
        k, n = self.position(), B // self.size
        local = tree_map(lambda x: _to_device(x[k * n:(k + 1) * n], self.device), tree)
        return LocalRows(self, local, (n,) * self.size)


class LocalRows(NamedTuple):
    """This rank's rows of a batch sharded over ``mesh`` in flat order:
    ``counts[k]`` rows at mesh position k, ``tree`` this rank's."""

    mesh: Mesh
    tree: Any
    counts: tuple

    @property
    def rows(self) -> list:
        """The global row indices of this rank's rows (a pair's global
        index, which names its hypothesis draws)."""
        k = self.mesh.position()
        lo = int(sum(self.counts[:k]))
        return list(range(lo, lo + self.counts[k]))

    def gather(self, tree=None):
        """Every rank's rows of ``tree`` (default: this batch's), the whole
        (total, ...) batch on every rank."""
        tree = self.tree if tree is None else tree
        return tree_map(lambda x: self.mesh.all_gather_rows(x, self.counts), tree)


class NamedSharding(NamedTuple):
    """A placement: ``spec[i]`` names the mesh axis (or tuple of axes)
    that array axis i is split over, None for replicated."""

    mesh: Mesh
    spec: tuple


def _batch_size(tree) -> int:
    sizes = {int(x.shape[0]) for x in tree_leaves(tree)}
    if len(sizes) != 1:
        raise ValueError(f"a pair batch's leaves disagree on its leading axis: {sorted(sizes)}")
    return sizes.pop()


def _to_device(x, device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


def make_mesh(n_devices: int | None = None, axis: str = PAIR_AXIS,
              device_type: str = "cuda") -> Mesh:
    """A 1-d mesh over the first ``n_devices`` ranks of the initialised
    process group (all of them by default).  Every rank of the group must
    call it, in the same order as its other group calls: a mesh over fewer
    ranks than the group creates a subgroup.  Without a group, only a
    one-rank mesh can be made."""
    if not dist.is_initialized():
        n = 1 if n_devices is None else n_devices
        if n != 1:
            raise RuntimeError(f"a mesh of {n} ranks needs an initialised process group "
                               "(parallel.multihost.initialize)")
        return Mesh(np.arange(1), (axis,), device_type)
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a group of {world}")
    group = None if n == world else dist.new_group(list(range(n)))
    return Mesh(np.arange(n), (axis,), device_type, group)


def pair_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-axis sharding for a batch of frame pairs."""
    return NamedSharding(mesh, (PAIR_AXIS,))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())
