"""The global batch of a data-parallel step, seen from one rank.

JAX's dense data-parallel step is ONE program over the sharded global
batch, so everything in it that depends on the batch sees the whole
batch: batch norm's statistics, the loss's normalisation, the dropout
masks. In the port every rank runs the step on its own rows, so those
places ask this module for the global view. Inside :func:`over`, rank
``index`` of ``count`` holds rows ``[index * b, (index + 1) * b)`` of a
global batch of ``count * b`` rows, and

- :func:`sum_` is the sum of a tensor over the ranks, differentiable:
  its backward sums the gradients over the ranks (batch norm's mean and
  variance, a loss's batch-wide counts such as the F-measure's);
- :func:`rows` and :func:`count` give a row count and a count tensor
  of the global batch (the divisor of a mean over the batch);
- :func:`share` is a rank's share of a term that does not depend on the
  batch (the L1/L2 penalty): ``term / count``, so the ranks' losses sum
  to the global loss and their gradients to its gradient;
- :func:`draw` makes a draw over the batch for the global batch's shape
  from the same key and returns this rank's rows of it: the masks JAX
  draws for the global batch, bit for bit (``random.py`` is threefry).

Outside :func:`over` (and at ``count == 1``) each is the identity on
its operands, so a single-process step runs the same operations as
before. The view is process-wide, not per thread: autograd's device
threads recompute a remat'd layer during the backward, outside the
thread that opened it, and must see the same view.

:class:`LocalShard` is a rank's rows of a global array that the rank
loaded itself (``parallel.multihost.host_local_array``): a step takes
them as they are instead of slicing a global batch.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence

import torch


class _View:
    def __init__(self, index: int, count: int,
                 reduce: Callable[[torch.Tensor], torch.Tensor]):
        self.index = int(index)
        self.count = int(count)
        self.reduce = reduce


_VIEW: Optional[_View] = None


@contextlib.contextmanager
def over(index: int, count: int,
         reduce: Callable[[torch.Tensor], torch.Tensor]):
    """Within: this rank is ``index`` of ``count``; ``reduce(t)`` returns
    the sum of ``t`` over the ranks (a collective every rank calls in
    the same order)."""
    global _VIEW
    prev = _VIEW
    _VIEW = _View(index, count, reduce) if count > 1 else None
    try:
        yield
    finally:
        _VIEW = prev


def active() -> bool:
    return _VIEW is not None


class _SumOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, reduce):
        ctx.reduce = reduce
        return reduce(t.detach().clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.reduce(g.detach().clone()), None


def sum_(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks (``t`` outside a view)."""
    v = _VIEW
    if v is None:
        return t
    return _SumOverRanks.apply(t, v.reduce)


def count(t):
    """A count (a tensor with no gradient) summed over the ranks."""
    v = _VIEW
    if v is None:
        return t
    return v.reduce(t.detach().clone())


def rows(n: int) -> int:
    """The global batch's rows for a rank's ``n``."""
    v = _VIEW
    return n if v is None else n * v.count


def share(term):
    """This rank's share of a batch-independent term."""
    v = _VIEW
    return term if v is None else term / v.count


def draw(fn: Callable[[Sequence[int]], torch.Tensor],
         shape: Sequence[int]) -> torch.Tensor:
    """``fn(shape)``, a draw whose first axis is the batch: inside a
    view, this rank's rows of ``fn`` for the global batch's shape."""
    v = _VIEW
    if v is None:
        return fn(shape)
    b = int(shape[0])
    full = fn((b * v.count,) + tuple(shape[1:]))
    return full[v.index * b:(v.index + 1) * b]


class LocalShard:
    """This rank's part of a global array sharded over its first axis:
    ``local`` (an array or tensor) and the ``global_shape``."""

    def __init__(self, local, global_shape: Sequence[int]):
        self.local = local
        self.global_shape = tuple(int(d) for d in global_shape)

    @property
    def shape(self):
        return self.global_shape

    @property
    def ndim(self) -> int:
        return len(self.global_shape)

    def __len__(self) -> int:
        return self.global_shape[0]

    def map(self, fn) -> "LocalShard":
        """The same shard with ``fn`` applied to the local part."""
        out = fn(self.local)
        return LocalShard(out, self.global_shape[:1] + tuple(out.shape[1:]))
