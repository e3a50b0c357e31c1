"""Multi-process distribution: the torch.distributed process group and
process-aware meshes.

Port of ``multimot_track_tpu.parallel.multihost``.  Every rank runs the
same program and calls :func:`initialize` once, with the coordinator's
address, the number of ranks and its own rank; each rank computes on one
device.

  * the transport is NCCL for ranks on CUDA devices (``device="cuda"``,
    the default) and gloo for ranks on the CPU (``device="cpu"``).
    Without NCCL or without a CUDA device, ``initialize`` raises: it never
    gives way to gloo or the CPU.  Ranks that share one card (NCCL refuses
    two ranks on one device) ask for gloo explicitly, ``backend="gloo"``
    with ``device="cuda"``; their tensors cross through host memory
    (``mesh.Mesh``);
  * the mesh is ``("host", "pair")``, host-major: each row the ranks of one
    host, in rank order.  The host count is the world size over
    ``LOCAL_WORLD_SIZE`` (set by ``torchrun``; one host without it), or
    ``emulate_hosts``;
  * the frame-pair batch is split over both axes in that order.  Each rank
    passes only its own rows to :func:`global_pair_batch` and gets a
    ``mesh.LocalRows`` back, whose ``rows`` are its pairs' global indices.
    Those indices name the pairs' hypothesis draws, so a pair draws what it
    draws unsharded whatever rank it lands on::

        rows = multihost.global_pair_batch(mesh, (prev_obs, gray, depth, sem, gt))
        res = batch.track_pairs(*rows.tree, cfg, sampler, rows.rows)
        whole = rows.gather(res)        # the (B, ...) PairResult on every rank
"""

from __future__ import annotations

import datetime
import os
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from multimot_track_tpu_torch.parallel.mesh import (
    PAIR_AXIS, LocalRows, Mesh, _batch_size, _to_device,
)
from multimot_track_tpu_torch.pipeline.frames import tree_map

HOST_AXIS = "host"


def _init_method(address: str) -> str:
    """``tcp://host:port`` or ``file:///path`` as given; ``host:port`` (the
    JAX package's form) as ``tcp://host:port``."""
    return address if "://" in address else f"tcp://{address}"


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids: Sequence[int] | None = None,
    device: str = "cuda",
    backend: str | None = None,
    timeout_s: float | None = None,
) -> bool:
    """Bring up the process group (idempotent).

    ``coordinator_address`` is the rendezvous: ``tcp://host:port``,
    ``host:port`` or ``file:///path``.  Without it the environment's
    ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` serve.
    ``device`` is where this rank computes; ``backend`` defaults to NCCL
    for "cuda" and gloo for "cpu".  On NCCL the rank's CUDA device is
    ``local_device_ids[0]``, else ``LOCAL_RANK``, else its rank modulo the
    card count.

    Returns True if this call brought the group up, False if it was
    already up, or if this is a plain single-process run (no coordinator
    given and none in the environment), which needs none."""
    if dist.is_initialized():
        return False
    if coordinator_address is None and "MASTER_ADDR" not in os.environ:
        return False
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', not {device!r}")
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' needs a CUDA device, and none is available")
    if backend == "nccl":
        if device != "cuda":
            raise ValueError("NCCL moves CUDA tensors only: use device='cuda'")
        if not dist.is_nccl_available():
            raise RuntimeError("this torch has no NCCL")
    if backend == "gloo" and not dist.is_gloo_available():
        raise RuntimeError("this torch has no gloo")
    kw = {}
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and process_id")
        kw.update(init_method=_init_method(coordinator_address), world_size=num_processes,
                  rank=process_id)
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    if device == "cuda":
        rank = process_id if process_id is not None else int(os.environ.get("RANK", 0))
        if local_device_ids:
            idx = int(local_device_ids[0])
        elif "LOCAL_RANK" in os.environ:
            idx = int(os.environ["LOCAL_RANK"])
        else:
            idx = rank % torch.cuda.device_count()
        torch.cuda.set_device(idx)
    dist.init_process_group(backend, **kw)
    return True


def make_process_mesh(emulate_hosts: int | None = None, device_type: str = "cuda") -> Mesh:
    """A ("host", "pair") mesh over every rank of the group (one rank in a
    plain process), host-major.  The host count is ``emulate_hosts`` if
    given, else the world size over ``LOCAL_WORLD_SIZE``."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if emulate_hosts is not None:
        h = int(emulate_hosts)
    else:
        h = max(1, n // int(os.environ.get("LOCAL_WORLD_SIZE", n)))
    if n % h:
        raise ValueError(f"{n} ranks do not fold into {h} hosts")
    return Mesh(np.arange(n).reshape(h, n // h), (HOST_AXIS, PAIR_AXIS), device_type)


def pair_batch_spec(ndim: int) -> tuple:
    """Leading axis split over host x pair, everything else replicated."""
    return ((HOST_AXIS, PAIR_AXIS),) + (None,) * (ndim - 1)


def shard_pair_batch(mesh: Mesh, tree) -> LocalRows:
    """This rank's rows of a whole pair batch (leading axis B, split
    host-major over the full mesh)."""
    return mesh.shard_rows(tree)


def global_pair_batch(mesh: Mesh, local_tree) -> LocalRows:
    """Assemble per-rank local pair batches into one sharded batch.

    Every rank passes its own (B_local, ...) pytree (numpy arrays or
    tensors; B_local may differ by rank); the result holds them on the
    rank's device, with every rank's row count, so ``rows`` are global
    pair indices in host-major order.  One all-gather of the row counts;
    no rank builds the whole batch."""
    n_local = _batch_size(local_tree)
    local = tree_map(lambda x: _to_device(x, mesh.device), local_tree)
    if mesh.size == 1:
        return LocalRows(mesh, local, (n_local,))
    n = torch.tensor([n_local], dtype=torch.int64, device=mesh.device)
    counts = mesh.all_gather_rows(n, [1] * mesh.size)
    return LocalRows(mesh, local, tuple(int(c) for c in counts.tolist()))


def shutdown() -> None:
    """Tear the process group down (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()

