"""Row groups: who holds which image slab, and how slabs talk.

What ``jax.sharding.Mesh``, named axes, ``ppermute`` and ``psum`` are to
``dirt_tpu.parallel.sharding``. The slab op's compute (``parallel.sharding``)
takes its halo rows as arguments; a group supplies them and sums what must
be summed. A group has ``size`` slabs along the image's row axis, numbered
top to bottom, and two implementations:

* :class:`DistGroup`: one slab per process of a ``torch.distributed``
  process group (gloo on the CPU, NCCL on cards). Halo rows travel with
  ``dist.batch_isend_irecv`` between neighbouring ranks and parameter
  gradients with ``dist.all_reduce``, both inside the backward of an
  autograd Function.
* :class:`LocalGroup`: all ``size`` slabs in this process on one device,
  rendered in turn. A halo row is then a slice of the neighbouring slab's
  arrays and nothing needs reducing across processes. It is how one card
  (or the CPU tests) runs more than one slab, as virtual CPU devices are
  for the JAX package; size 1 is the sharded path on a single device.

The contract. Put together over the group, what the processes end with
equals what ``dirt_tpu.parallel.sharding.rasterise_sharded`` returns on a
``size``-device mesh: the rows a process holds (``local``: one slab of a
:class:`DistGroup`, all of a :class:`LocalGroup`, concatenated top to
bottom) are the image's rows, the gradient of a row-sharded input is held
by rows likewise, and the gradient of a replicated input (vertices, vertex
colors and whatever they were computed from) is the sum over all slabs and
equal on every process.

Groups over another axis (scenes of a batch, the "data" axis) use the same
two classes: :meth:`replicated` marks a tensor every member uses, so its
gradient is summed over the group, and :meth:`all_reduce_sum` sums a value
(a loss) over it.

The collectives of the overlapped and the face-sharded renderers
(``parallel.overlap``, ``parallel.face_sharding``) take and return one
tensor per local member, as :meth:`exchange_rows` does:
:meth:`all_reduce_async_` (the per-chunk ``psum`` of ``dirt_tpu``, whose
handle is waited on later), :meth:`all_reduce_min` (``pmin``),
:meth:`all_gather` (``all_gather(tiled=True)``) and :meth:`reduce_scatter`
(``psum_scatter(tiled=True)``).
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist


class LocalGroup:
    """``size`` slabs held by this process, on one device."""

    def __init__(self, size: int = 1):
        if size < 1:
            raise ValueError(f"a group needs at least one slab, got {size}")
        self.size = size

    @property
    def local(self):
        """Indices of the slabs this process holds, top to bottom."""
        return range(self.size)

    def exchange_rows(self, first_rows, last_rows):
        """Halo rows of each local slab: (tops, bottoms).

        ``first_rows[i]`` / ``last_rows[i]`` are local slab i's own first
        and last row; slab i's top halo is its upper neighbour's last row
        and its bottom halo the lower neighbour's first row. None marks an
        end of the image.
        """
        return [None, *last_rows[:-1]], [*first_rows[1:], None]

    def replicated(self, tensor):
        """``tensor`` as every slab uses it; one process sums all slabs'
        gradients by itself."""
        return tensor

    def all_reduce_sum(self, tensor):
        """The sum of ``tensor`` over the group's processes: just this one."""
        return tensor

    def all_reduce_async_(self, tensors):
        """Sum over the members, in place: each tensor of ``tensors`` (one
        per local member) becomes the sum of all of them. Returns a handle
        whose ``wait()`` returns once the sums are there: here at once."""
        total = functools.reduce(torch.add, tensors)
        for tensor in tensors:
            tensor.copy_(total)
        return _Done()

    def all_reduce_min(self, tensors):
        """The elementwise minimum over the members, for each member."""
        least = functools.reduce(torch.minimum, tensors)
        return [least] * len(tensors)

    def all_gather(self, tensors):
        """The members' tensors concatenated along dim 0, for each member."""
        gathered = torch.cat(tensors)
        return [gathered] * len(tensors)

    def reduce_scatter(self, tensors):
        """The sum over the members, split along dim 0 into ``size`` equal
        blocks: member i gets block i."""
        return list(functools.reduce(torch.add, tensors).chunk(self.size))


class _Done:
    """The handle of a collective that has already completed."""

    def wait(self):
        return True


class _SumGradient(torch.autograd.Function):
    """Identity forward, all-reduce backward: the counterpart of the
    ``psum`` that ``shard_map``'s transpose applies to a replicated input."""

    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        return tensor.view_as(tensor)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_reduce_(grad.contiguous().clone()), None


class _SumValue(torch.autograd.Function):
    """All-reduce forward, identity backward: every member goes on to use
    the sum identically, so each one's own term has the sum's cotangent."""

    @staticmethod
    def forward(ctx, tensor, group):
        return group.all_reduce_(tensor.detach().contiguous().clone())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class DistGroup:
    """One slab per process of a ``torch.distributed`` process group.

    Args:
        ranks: global ranks of the members, in slab order (top to bottom);
            default: every rank of the default group, in rank order.
        process_group: the ``ProcessGroup`` of exactly these ranks
            (``dist.new_group(ranks)``); None means the default group.
    """

    def __init__(self, ranks=None, process_group=None):
        if not dist.is_initialized():
            raise RuntimeError("DistGroup needs torch.distributed to be "
                               "initialised (multihost.init_distributed)")
        self.ranks = (list(range(dist.get_world_size())) if ranks is None
                      else list(ranks))
        self.process_group = process_group
        self.size = len(self.ranks)
        self.rank = self.ranks.index(dist.get_rank())

    @property
    def local(self):
        return (self.rank,)

    def exchange_rows(self, first_rows, last_rows):
        """See :meth:`LocalGroup.exchange_rows`; here one slab is local, and
        its rows go to and come from the neighbouring ranks."""
        (first,), (last,) = first_rows, last_rows
        top = bottom = None
        ops = []
        if self.rank > 0:
            peer = self.ranks[self.rank - 1]
            top = torch.empty_like(last)
            ops += [dist.P2POp(dist.isend, first, peer, self.process_group),
                    dist.P2POp(dist.irecv, top, peer, self.process_group)]
        if self.rank < self.size - 1:
            peer = self.ranks[self.rank + 1]
            bottom = torch.empty_like(first)
            ops += [dist.P2POp(dist.isend, last, peer, self.process_group),
                    dist.P2POp(dist.irecv, bottom, peer, self.process_group)]
        if ops:
            for request in dist.batch_isend_irecv(ops):
                request.wait()
        return [top], [bottom]

    def all_reduce_(self, tensor):
        """Sum ``tensor`` over the group, in place; returns it."""
        dist.all_reduce(tensor, group=self.process_group)
        return tensor

    def all_reduce_async_(self, tensors):
        """See :meth:`LocalGroup.all_reduce_async_`: the sum over the ranks,
        started and not waited for (``dist.all_reduce(async_op=True)``).
        The tensor must be contiguous and left alone until ``wait()``."""
        (tensor,) = tensors
        return dist.all_reduce(tensor, group=self.process_group,
                               async_op=True)

    def all_reduce_min(self, tensors):
        """See :meth:`LocalGroup.all_reduce_min`."""
        (tensor,) = tensors
        least = tensor.contiguous().clone()
        dist.all_reduce(least, op=dist.ReduceOp.MIN,
                        group=self.process_group)
        return [least]

    def all_gather(self, tensors):
        """See :meth:`LocalGroup.all_gather`."""
        (tensor,) = tensors
        tensor = tensor.contiguous()
        parts = [torch.empty_like(tensor) for _ in range(self.size)]
        dist.all_gather(parts, tensor, group=self.process_group)
        return [torch.cat(parts)]

    def reduce_scatter(self, tensors):
        """See :meth:`LocalGroup.reduce_scatter`."""
        (tensor,) = tensors
        block = tensor.new_empty((tensor.shape[0] // self.size,
                                  *tensor.shape[1:]))
        dist.reduce_scatter_tensor(block, tensor.contiguous(),
                                   group=self.process_group)
        return [block]

    def replicated(self, tensor):
        """``tensor`` (equal on every rank) with its gradient summed over
        the group in the backward."""
        return _SumGradient.apply(tensor, self)

    def all_reduce_sum(self, tensor):
        """The sum of ``tensor`` over the group, differentiable: each rank's
        term gets the cotangent of the sum."""
        return _SumValue.apply(tensor, self)
