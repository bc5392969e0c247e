"""The collectives of data-parallel training, over one
``torch.distributed`` process group.

A :class:`Transport` moves a step's tensors in ONE collective: the
leaves are copied into a flat buffer per dtype, the buffer is reduced,
gathered or broadcast, and the leaves come back as views of it.

With NCCL (every rank has a card of its own) CUDA tensors go to the
collective as they are. Gloo takes host tensors, so a CUDA tensor on a
gloo group (several ranks on one card, or a machine without NCCL) is
staged through a pinned host buffer on purpose: copied to the host on
the tensor's stream, reduced there, and copied back. That is the
transport on such a group, not a fallback; its time is the cost of the
collective and :attr:`Transport.stats` counts it.
"""
from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    return dist.get_rank() if initialized() else 0


class Transport:
    """Flat-buffer collectives over ``group``, whose members are the
    global ``ranks`` in group order."""

    def __init__(self, group, ranks: Sequence[int]):
        self.group = group
        self.ranks = [int(r) for r in ranks]
        self.size = len(self.ranks)
        self.backend = str(dist.get_backend(group))
        self._host: Dict[Tuple[int, torch.dtype], torch.Tensor] = {}
        #: collectives run, bytes through them (this rank's buffer) and
        #: the host seconds they took (staging copies included)
        self.stats = {"calls": 0, "bytes": 0, "seconds": 0.0}

    # -- staging -----------------------------------------------------
    def _staged(self, t: torch.Tensor) -> bool:
        return t.is_cuda and "nccl" not in self.backend

    def _host_buffer(self, n: int, dtype: torch.dtype) -> torch.Tensor:
        key = (n, dtype)
        buf = self._host.get(key)
        if buf is None:
            buf = torch.empty(n, dtype=dtype, pin_memory=True)
            self._host[key] = buf
        return buf

    def _run(self, flat: torch.Tensor, op) -> None:
        """``op(t)`` on ``flat`` in place, staged through the host when
        gloo meets a CUDA tensor."""
        t0 = time.perf_counter()
        if self._staged(flat):
            host = self._host_buffer(flat.numel(), flat.dtype)
            host.copy_(flat, non_blocking=True)
            torch.cuda.current_stream(flat.device).synchronize()
            op(host)
            flat.copy_(host, non_blocking=True)
            torch.cuda.current_stream(flat.device).synchronize()
        else:
            op(flat)
        self._count(flat, t0)

    # -- collectives ---------------------------------------------------
    @staticmethod
    def _by_dtype(tensors: Sequence[torch.Tensor]):
        groups: Dict[torch.dtype, List[int]] = {}
        for i, t in enumerate(tensors):
            groups.setdefault(t.dtype, []).append(i)
        return groups

    def all_reduce(self, tensors: Sequence[torch.Tensor],
                   op=dist.ReduceOp.SUM) -> List[torch.Tensor]:
        """The ranks' tensors reduced elementwise (a sum by default), as
        new tensors of the same shapes; one collective per dtype."""
        out: List[torch.Tensor] = [None] * len(tensors)
        for dtype, idx in self._by_dtype(tensors).items():
            flat = torch.cat([tensors[i].reshape(-1) for i in idx])
            self._run(flat, lambda t: dist.all_reduce(t, op=op,
                                                      group=self.group))
            for i, part in zip(idx, torch.split(
                    flat, [tensors[i].numel() for i in idx])):
                out[i] = part.view(tensors[i].shape)
        return out

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """One tensor summed over the ranks."""
        return self.all_reduce([t])[0]

    def all_gather(self, tensors: Sequence[torch.Tensor]
                   ) -> List[torch.Tensor]:
        """Every rank's tensors stacked on a new leading axis in group
        order: ``[size, *shape]`` each; one collective per dtype."""
        out: List[torch.Tensor] = [None] * len(tensors)
        for dtype, idx in self._by_dtype(tensors).items():
            flat = torch.cat([tensors[i].reshape(-1) for i in idx])
            n = flat.numel()
            full = torch.empty(self.size * n, dtype=dtype,
                               device=flat.device)
            t0 = time.perf_counter()
            if self._staged(flat):
                # the rank's part and the gathered result both stage
                host_in = self._host_buffer(n, dtype)
                host_out = self._host_buffer(self.size * n, dtype)
                host_in.copy_(flat, non_blocking=True)
                torch.cuda.current_stream(flat.device).synchronize()
                dist.all_gather(list(torch.split(host_out, n)), host_in,
                                group=self.group)
                full.copy_(host_out, non_blocking=True)
                torch.cuda.current_stream(flat.device).synchronize()
            else:
                dist.all_gather(list(torch.split(full, n)), flat,
                                group=self.group)
            self._count(flat, t0)
            rows = full.view(self.size, n)
            off = 0
            for i in idx:
                k = tensors[i].numel()
                out[i] = rows[:, off:off + k].reshape(
                    (self.size,) + tuple(tensors[i].shape))
                off += k
        return out

    def broadcast(self, tensors: Sequence[torch.Tensor], src: int
                  ) -> List[torch.Tensor]:
        """Global rank ``src``'s tensors on every rank (new tensors)."""
        out: List[torch.Tensor] = [None] * len(tensors)
        for dtype, idx in self._by_dtype(tensors).items():
            flat = torch.cat([tensors[i].reshape(-1) for i in idx])
            self._run(flat, lambda t: dist.broadcast(t, src=src,
                                                     group=self.group))
            for i, part in zip(idx, torch.split(
                    flat, [tensors[i].numel() for i in idx])):
                out[i] = part.view(tensors[i].shape)
        return out

    def _count(self, flat: torch.Tensor, t0: float) -> None:
        st = self.stats
        st["calls"] += 1
        st["bytes"] += flat.numel() * flat.element_size()
        st["seconds"] += time.perf_counter() - t0
