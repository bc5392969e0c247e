"""Threshold gradient compression, residual carry and the update bus
(counterpart of ``deeplearning4j_tpu/parallel/compression.py``).

The reference's Strom-2015 quantised-update pipeline: an entry of
(update + residual) at or above the threshold in magnitude is sent, the
rest stays in the worker's residual for later steps, and an adaptive
rule keeps the fired fraction in a target band.

- The host codec (:func:`threshold_encode`, :func:`threshold_decode`)
  is the JAX package's (its ``runtime`` package's native codec, kept here
  as a numpy copy with the same f32 arithmetic: the port's runtime is a
  later item): an int64 stream of ``index << 1 | sign``.
- :func:`topk_encode`/:func:`topk_decode` keep a fixed number of
  entries.
- :func:`strom_encode_decode` (sign times threshold on the wire) and
  :func:`strom_value_encode_decode` (the fired entries' values) are
  what ``ParallelWrapper``'s compressed steps run on each worker, on
  the device; :func:`adapt_threshold` is their threshold rule.
- :class:`EncodingHandler`, :class:`LoopbackBus` and
  :class:`EncodedGradientsAccumulator` are the reference's per-worker
  endpoint over an in-process bus, on host arrays, line for line.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch


# ---------------------------------------------------------------------------
# host codec: exact threshold encoding, variable length
# ---------------------------------------------------------------------------
def threshold_encode(update: np.ndarray, threshold: float,
                     cap: Optional[int] = None):
    """Encode the entries with ``|u| >= threshold`` as a flat int64 array
    of ``index << 1 | sign`` (sign 1 for a negative entry), at most
    ``cap`` of them. Returns (encoded, residual); the residual is the
    update less the decoded entries, ``update`` itself is unchanged."""
    grad = np.asarray(update, np.float32)
    flat = np.ascontiguousarray(grad, np.float32).ravel().copy()
    cap = int(cap if cap is not None else flat.size)
    t = np.float32(threshold)   # compared and subtracted in f32
    mask = np.abs(flat) >= t
    idx = np.nonzero(mask)[0][:cap]
    neg = (flat[idx] < 0).astype(np.int64)
    encoded = (idx.astype(np.int64) << 1) | neg
    flat[idx] -= np.where(neg == 1, -t, t)
    return encoded, flat.reshape(grad.shape)


def threshold_decode(encoded: np.ndarray, shape, threshold: float,
                     out: Optional[np.ndarray] = None) -> np.ndarray:
    """Decode into a dense float32 array of ``shape`` (adding into
    ``out`` when given)."""
    n = int(np.prod(shape))
    if out is None:
        out = np.zeros(n, np.float32)
    else:
        out = np.ascontiguousarray(out, np.float32).ravel()
    enc = np.ascontiguousarray(encoded, np.int64)
    idx = (enc >> 1).astype(np.int64)
    sign = np.where((enc & 1) == 1, -1.0, 1.0).astype(np.float32)
    np.add.at(out, idx, sign * np.float32(threshold))
    return out.reshape(shape)


# ---------------------------------------------------------------------------
# fixed-k sparsification
# ---------------------------------------------------------------------------
def topk_encode(update: torch.Tensor, k: int):
    """Keep the k largest-magnitude entries. Returns (indices [k] int32,
    values [k], residual)."""
    flat = update.reshape(-1)
    _, idx = torch.topk(flat.abs(), k)
    kept = flat[idx]
    residual = flat.clone()
    residual[idx] = 0.0
    return idx.to(torch.int32), kept, residual.reshape(update.shape)


def topk_decode(indices, values, shape):
    out = torch.zeros(int(np.prod(shape)), dtype=values.dtype,
                      device=values.device)
    out.index_add_(0, indices.long(), values)
    return out.reshape(shape)


# ---------------------------------------------------------------------------
# the per-worker Strom step of the compressed ParallelWrapper steps
# ---------------------------------------------------------------------------
def strom_encode_decode(update, residual, threshold):
    """One worker's Strom-2015 quantisation: entries of (update +
    residual) with ``|u| >= t`` are sent as ``sign(u) * t``; everything
    else stays in the residual. Returns (decoded, new_residual)."""
    u = update + residual
    fire = torch.abs(u) >= threshold
    decoded = torch.where(fire, torch.sign(u) * threshold,
                          torch.zeros((), dtype=u.dtype, device=u.device))
    return decoded, u - decoded


def strom_value_encode_decode(update, residual, threshold):
    """The magnitude-keeping variant (the accumulator's ``mode=
    "gradient"``): a fired entry of (update + residual) is sent with its
    value; the rest stays in the residual. Returns (decoded,
    new_residual)."""
    u = update + residual
    fire = torch.abs(u) >= threshold
    decoded = torch.where(fire, u, torch.zeros((), dtype=u.dtype,
                                               device=u.device))
    return decoded, u - decoded


def adapt_threshold(threshold, sparsity, min_sparsity=1e-4,
                    max_sparsity=1e-2, adapt_factor=1.2):
    """The reference's AdaptiveThresholdAlgorithm: raise the threshold
    by ``adapt_factor`` when the fired fraction is above the band, lower
    it when below."""
    too_dense = sparsity > max_sparsity
    too_sparse = sparsity < min_sparsity
    return torch.where(too_dense, threshold * adapt_factor,
                       torch.where(too_sparse, threshold / adapt_factor,
                                   threshold))


# ---------------------------------------------------------------------------
# adaptive threshold (ref: ThresholdAlgorithm + AdaptiveThresholdAlgorithm)
# ---------------------------------------------------------------------------
class EncodingHandler:
    """Per-worker encode pipeline with residual carry and an adaptive
    threshold targeting a sparsity band (ref: `EncodingHandler.java:51`,
    `AdaptiveThresholdAlgorithm`)."""

    def __init__(self, threshold: float = 1e-3,
                 min_sparsity: float = 1e-4, max_sparsity: float = 1e-2,
                 adapt_factor: float = 1.2):
        self.threshold = float(threshold)
        self.min_sparsity = min_sparsity
        self.max_sparsity = max_sparsity
        self.adapt_factor = adapt_factor
        self._residual: Optional[np.ndarray] = None
        self.last_sparsity = 0.0

    def encode(self, update: np.ndarray) -> np.ndarray:
        u = np.asarray(update, np.float32)
        if self._residual is not None:
            u = u + self._residual
        encoded, self._residual = threshold_encode(u, self.threshold)
        self.last_sparsity = encoded.size / max(u.size, 1)
        # adapt: re-target the threshold to the |u| quantile that lands in
        # the sparsity band (one step, unlike a multiplicative nudge on a
        # badly scaled initial threshold)
        if not (self.min_sparsity <= self.last_sparsity
                <= self.max_sparsity):
            target = 0.5 * (self.min_sparsity + self.max_sparsity)
            q = float(np.quantile(np.abs(u), 1.0 - target))
            if q > 0:
                self.threshold = q
        return encoded

    def residual(self) -> Optional[np.ndarray]:
        return self._residual


# ---------------------------------------------------------------------------
# update bus (ref: EncodedGradientsAccumulator + IndexedTail + transports)
# ---------------------------------------------------------------------------
class LoopbackBus:
    """In-process broadcast bus, the test stand-in for a transport (ref:
    `DummyTransport.java`). Thread-safe; each node sees every other
    node's messages exactly once (ref: `IndexedTail` fan-out)."""

    def __init__(self):
        self._queues: Dict[int, deque] = {}
        self._lock = threading.Lock()

    def register(self, node_id: int):
        with self._lock:
            self._queues[node_id] = deque()

    def broadcast(self, sender: int, message):
        with self._lock:
            for nid, q in self._queues.items():
                if nid != sender:
                    q.append((sender, message))

    def drain(self, node_id: int) -> List:
        with self._lock:
            q = self._queues[node_id]
            out = list(q)
            q.clear()
        return out


class EncodedGradientsAccumulator:
    """Gradient-sharing endpoint for one worker (ref:
    `EncodedGradientsAccumulator.java:59`): local updates are threshold-
    encoded (with residual carry) and broadcast; external updates are
    decoded and accumulated, then folded into the next step by
    :meth:`apply_update` (ref: applyUpdate :286, externalSource :312)."""

    def __init__(self, node_id: int, bus: LoopbackBus, shapes: Dict,
                 threshold: float = 1e-3, **handler_kw):
        self.node_id = node_id
        self.bus = bus
        bus.register(node_id)
        self.shapes = shapes
        self.handlers = {k: EncodingHandler(threshold, **handler_kw)
                         for k in shapes}

    def store_update(self, grads: Dict[str, np.ndarray]):
        """Encode and broadcast this worker's update (the worker applies
        its own update locally, like the reference)."""
        msg = {}
        for k, g in grads.items():
            h = self.handlers[k]
            thr = h.threshold  # captured BEFORE encode() adapts it
            msg[k] = (h.encode(np.asarray(g)), thr)
        self.bus.broadcast(self.node_id, msg)

    def apply_update(self, grads: Dict[str, np.ndarray]
                     ) -> Dict[str, np.ndarray]:
        """Fold the queued external updates into ``grads`` (decoded
        sum)."""
        out = {k: np.asarray(g, np.float32).copy() for k, g in grads.items()}
        for _, msg in self.bus.drain(self.node_id):
            for k, (encoded, thr) in msg.items():
                # decode with the threshold that produced the message
                out[k] = threshold_decode(encoded, self.shapes[k], thr,
                                          out[k])
        return out
