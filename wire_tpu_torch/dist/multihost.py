"""Joining a process group, and per-rank row feeding (port of
wire_tpu/dist/multihost.py).

- :func:`initialize` calls ``torch.distributed.init_process_group`` when
  asked to (an address or a process count) or when the environment of
  ``python -m torch.distributed.run`` is there (``MASTER_ADDR``,
  ``WORLD_SIZE``, ``RANK``: the counterpart of wire_tpu's
  ``JAX_COORDINATOR_ADDRESS``), and is a no-op for one process without
  one, so the apps can call it unconditionally.
- :func:`world_of_one` makes a process group of this process alone, so
  ``--mesh 1`` runs the sharded fitters in one process.
- :func:`make_global_mesh` is the Mesh of every rank of the group.
- :func:`feed_rows` has each rank build only its own rows (a
  ``signals.coords.GridSpec``'s rows of a 512^3 grid, say) and hands the
  sharded fitters a ``LocalRows`` in place of a global array: no rank ever
  holds the global coordinate set.

The backend: NCCL when each rank of this host has a card of its own, Gloo
when ranks share a card (NCCL refuses two ranks on one device) or run on
the CPU; the choice and its reason are logged.  The sharded fitters'
permutation streams are a pure function of (seed, rank), so no rank waits
on another for its indices.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from wire_tpu_torch.dist.mesh import (LocalRows, data_sharding, local_device,
                                      make_mesh)
from wire_tpu_torch.train import artifacts as A


def choose_backend(device=None, local_ranks=1):
    """(backend, reason) for ``local_ranks`` ranks of one host on
    ``device`` (as ``mesh.local_device`` resolves it)."""
    dev = local_device(device)
    if dev.type != "cuda":
        return "gloo", f"the ranks run on the {dev.type}"
    cards = torch.cuda.device_count()
    if local_ranks <= cards:
        return "nccl", (f"{local_ranks} rank(s) of this host on {cards} "
                        f"card(s): one card each")
    return "gloo", (f"{local_ranks} ranks of this host share {cards} "
                    f"card(s); NCCL refuses two ranks on one device")


def _join(backend, device, local_ranks, **kw):
    why = "asked for"
    if backend is None:
        backend, why = choose_backend(device, local_ranks)
    dev = local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, **kw)
    A.log(f"torch.distributed: rank {dist.get_rank()} of "
          f"{dist.get_world_size()} on {dev}, backend {backend} ({why})")


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, backend=None, device=None):
    """Join (or skip joining) a process group.

    Returns True if ``torch.distributed.init_process_group`` was called.
    With no arguments and no ``torch.distributed.run`` environment, or with
    a group already joined, this is a no-op.  ``coordinator_address`` is
    ``host:port`` (or an init-method URL), ``num_processes`` the world size
    and ``process_id`` this rank, each defaulting to the environment's
    ``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``.  ``backend``
    defaults to ``choose_backend``'s, for ``LOCAL_WORLD_SIZE`` ranks of
    this host (the whole world when unset) on ``device``."""
    env = os.environ
    explicit = (coordinator_address is not None
                or num_processes not in (None, 0, 1)
                or ("MASTER_ADDR" in env and "WORLD_SIZE" in env))
    if not explicit or dist.is_initialized():
        return False
    world = int(num_processes if num_processes is not None
                else env["WORLD_SIZE"])
    rank = int(process_id if process_id is not None else env["RANK"])
    if coordinator_address is None:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    _join(backend, device, int(env.get("LOCAL_WORLD_SIZE", world)),
          init_method=url, world_size=world, rank=rank)
    return True


def world_of_one(backend=None, device=None):
    """A process group of this process alone (an in-memory store), on
    ``device``'s backend unless ``backend`` is given; a no-op when a group
    is already joined.  Returns True if it made one."""
    if dist.is_initialized():
        return False
    _join(backend, device, 1, store=dist.HashStore(), rank=0, world_size=1)
    return True


def make_global_mesh(device=None):
    """The Mesh of every rank in the process group."""
    return make_mesh(None, device)


def local_row_range(mesh, global_n):
    """[lo, hi): the contiguous rows of a row-sharded (global_n, ...) array
    that this rank owns (global_n must divide by the mesh size)."""
    return data_sharding(mesh, global_n)


def feed_rows(mesh, row_fn, global_n):
    """This rank's rows of a row-sharded (global_n, ...) array.

    ``row_fn(lo, hi)`` returns the rows [lo, hi) (a numpy array or a
    tensor); it is called exactly once, with this rank's range.  Returns a
    ``LocalRows`` of them on the mesh's device."""
    lo, hi = local_row_range(mesh, global_n)
    local = row_fn(lo, hi)
    if not isinstance(local, torch.Tensor):
        local = torch.from_numpy(np.ascontiguousarray(local))
    if local.shape[0] != hi - lo:
        raise ValueError(f"row_fn returned {local.shape[0]} rows for range "
                         f"[{lo}, {hi})")
    return LocalRows(local.to(mesh.device), global_n, lo, hi)
