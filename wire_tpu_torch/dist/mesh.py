"""This rank's view of a process group for coordinate-parallel INR fitting
(port of wire_tpu/dist/mesh.py).

wire_tpu drives a 1-D 'data' mesh of N devices from one process under
``shard_map``; the port runs SPMD instead: one process per rank, each on
its own device, the same fitter on its own shard, and collectives on a
``torch.distributed`` process group.  A ``Mesh`` is that rank's view: the
group, its rank and size, and its device.  The network (a few hundred
thousand parameters) and the optimizer state are replicated; the
coordinate, render or frame axis is split into contiguous rank-major
ranges.

The trainer's fitters (``train.trainer.fit_pointwise``, ``fit_operator``
and ``fit_frames``) take a mesh through the ``Mesh``'s methods: the rows
a rank owns (``span``, ``local``), a global input on every rank
(``whole``), a parameter tree's gradients flattened into one buffer and
all-reduced once (``sum_tree``), rows all-gathered in rank order
(``gather``, and ``splice`` with this rank's rows live), and a vector of
scalars all-reduced (``sum_``).  Without a mesh the trainer's ``_Solo``
stands in, every collective the identity.
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from wire_tpu_torch import tree
from wire_tpu_torch.device import resolve


@dataclasses.dataclass(frozen=True)
class LocalRows:
    """Rows [lo, hi) of a (global_n, ...) array, held by the rank that owns
    them: what ``multihost.feed_rows`` returns and the fitters take in
    place of a global array."""
    data: torch.Tensor
    global_n: int
    lo: int
    hi: int

    @property
    def shape(self):
        """The global array's shape."""
        return (self.global_n,) + tuple(self.data.shape[1:])


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a 1-D mesh: ``group`` (a ProcessGroup),
    ``rank`` in it, ``size`` ranks, this rank's ``device`` and the group's
    ``backend``."""
    group: object
    rank: int
    size: int
    device: torch.device
    backend: str

    def span(self, n):
        """[lo, hi): the contiguous rows of an (n, ...) array this rank
        owns; n must divide by the mesh size."""
        return data_sharding(self, n)

    def local(self, x, n):
        """This rank's rows of a global (n, ...) input (an array or a
        tensor), or the data of a ``LocalRows`` fed for the same range."""
        lo, hi = self.span(n)
        if isinstance(x, LocalRows):
            if (x.lo, x.hi, x.global_n) != (lo, hi, n):
                raise ValueError(f"fed rows [{x.lo}, {x.hi}) of {x.global_n} "
                                 f"on rank {self.rank}, which owns [{lo}, "
                                 f"{hi}) of {n}")
            return x.data
        return x[lo:hi]

    def whole(self, x):
        """A global input on every rank: fed rows all-gathered."""
        if isinstance(x, LocalRows):
            return self.gather(self.local(x, x.global_n).to(
                self.device, torch.float32))
        return x

    def sum_(self, t):
        """Sum ``t`` over the mesh in place and return it."""
        dist.all_reduce(t, group=self.group)
        return t

    def sum_tree(self, grads, mean=False):
        """The sum (or, with ``mean``, the mean: the sum divided by the mesh
        size, wire_tpu's ``pmean``) of a float32 tree over the mesh: every
        leaf flattened into one buffer, one all-reduce, the leaves returned
        as views of it."""
        flat = tree.leaves(grads)
        buf = torch.cat([v.reshape(-1) for _, v in flat])
        self.sum_(buf)
        if mean:
            buf.div_(self.size)
        views, off = [], 0
        for _, v in flat:
            views.append(buf[off:off + v.numel()].view_as(v))
            off += v.numel()
        return tree.unflatten([p for p, _ in flat], views)

    def gather(self, local):
        """(size * rows, ...) of every rank's ``local`` (rows, ...) in rank
        order."""
        local = local.contiguous()
        out = local.new_empty((self.size * local.shape[0],)
                              + local.shape[1:])
        dist.all_gather_into_tensor(out, local, group=self.group)
        return out

    def splice(self, local):
        """Every rank's rows with this rank's slot the live ``local`` itself:
        autograd through the result reaches this rank's rows only, the
        others' being the all-gather of their detached values."""
        lo, hi = self.span(self.size * local.shape[0])
        full = self.gather(local.detach())
        return torch.cat([full[:lo], local, full[hi:]])


def local_device(device=None):
    """The rank's device: ``device`` when given (a CUDA device without an
    index takes ``LOCAL_RANK % device_count``), by default
    ``cuda:<LOCAL_RANK % device_count>``; raises without a card unless
    the CPU is asked for."""
    dev = resolve(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", 0))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def make_mesh(n=None, device=None):
    """The Mesh of the first ``n`` ranks of the default process group (all
    of them by default) for this rank, or None for a rank outside it.  A
    subset is ``torch.distributed.new_group(ranks[:n])``, a collective
    every rank of the world must call.  Raises without a process group:
    join one with ``multihost.initialize()`` (``torch.distributed.run``
    sets its environment) or ``multihost.world_of_one()``."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh: no process group; launch with python -m "
            "torch.distributed.run and call "
            "wire_tpu_torch.dist.multihost.initialize(), or make a world of "
            "one with multihost.world_of_one()")
    world = dist.get_world_size()
    n = world if n is None else int(n)
    if not 1 <= n <= world:
        raise ValueError(f"make_mesh: {n} ranks asked of a world of {world}")
    group = (dist.group.WORLD if n == world
             else dist.new_group(list(range(n))))
    rank = dist.get_rank()
    if rank >= n:
        return None
    dev = local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(group=group, rank=rank, size=n, device=dev,
                backend=str(dist.get_backend(group)))


def data_sharding(mesh, n):
    """[lo, hi): the contiguous rows of an (n, ...) array this rank owns;
    n must divide by the mesh size."""
    if n % mesh.size:
        raise ValueError(f"npoints={n} not divisible by mesh size "
                         f"{mesh.size}; pad the coordinate set")
    per = n // mesh.size
    return mesh.rank * per, (mesh.rank + 1) * per


def replicated(mesh, n):
    """[0, n): every rank holds all rows (the exact mode's inputs)."""
    return 0, n
