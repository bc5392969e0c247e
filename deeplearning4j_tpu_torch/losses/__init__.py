"""Loss functions (counterpart of ``deeplearning4j_tpu/losses``; the
subset the ported output layers use: mcxent and mse).

Each loss takes (labels, preout, activation, mask) as the reference's
``ILossFunction``: ``preout`` is the output layer's pre-activation, so
the softmax cross-entropy runs in fused log-softmax form.
``score_array`` gives one score per example (the sum over outputs),
``score`` their mean over the minibatch, or over the live rows when a
mask is given.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..activations import Activation, Identity, Softmax


def _apply_mask(per_out, mask):
    if mask is None:
        return per_out
    mask = mask.to(per_out.dtype)
    if mask.ndim == per_out.ndim - 1:
        mask = mask[..., None]
    return per_out * mask


class LossFunction:
    """Base loss."""

    name: str = "loss"

    def per_output(self, labels, preout, activation: Activation):
        """Unreduced loss, the shape of ``labels``."""
        raise NotImplementedError

    def score_array(self, labels, preout, activation: Activation = Identity(),
                    mask=None):
        per = _apply_mask(self.per_output(labels, preout, activation), mask)
        return per.reshape(per.shape[0], -1).sum(-1)

    def score(self, labels, preout, activation: Activation = Identity(),
              mask: Optional[torch.Tensor] = None, average: bool = True):
        """Sum of ``score_array``, divided by the number of examples
        (``labels.shape[0]``) or, with a mask, by the number of rows
        whose mask is nonzero anywhere (at least 1)."""
        s = self.score_array(labels, preout, activation, mask).sum()
        if average:
            n = labels.shape[0] if mask is None else torch.clamp_min(
                mask.reshape(mask.shape[0], -1).amax(-1).sum(), 1)
            s = s / n
        return s

    def __repr__(self):
        return f"Loss({self.name})"


class LossMSE(LossFunction):
    """Mean squared error: per-output (y - yhat)^2 / nOut."""

    name = "mse"

    def per_output(self, labels, preout, activation):
        return (labels - activation(preout)) ** 2 / labels.shape[-1]


class LossMCXENT(LossFunction):
    """Multi-class cross entropy: fused log-softmax with a Softmax
    output activation, else -sum(y * log(clip(yhat)))."""

    name = "mcxent"

    def __init__(self, clip_eps: float = 1e-10):
        self.clip_eps = float(clip_eps)

    def per_output(self, labels, preout, activation):
        if isinstance(activation, Softmax):
            return -(labels * torch.log_softmax(preout, dim=-1))
        out = torch.clamp(activation(preout), self.clip_eps,
                          1.0 - self.clip_eps)
        return -(labels * torch.log(out))


_REGISTRY = {c.name: c for c in (LossMSE, LossMCXENT)}


def get(spec) -> LossFunction:
    """A loss from an instance, a name or a ``{"@class": name,
    **kwargs}`` dict. A name the JAX package knows but the port does
    not raises ``NotImplementedError``."""
    if isinstance(spec, LossFunction):
        return spec
    d = dict(spec) if isinstance(spec, dict) else {"@class": str(spec)}
    name = str(d.pop("@class")).lower()
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"loss {name!r} is not ported (ported: {sorted(_REGISTRY)}; "
            f"ROADMAP.md queue A, item 11)")
    return _REGISTRY[name](**d)
