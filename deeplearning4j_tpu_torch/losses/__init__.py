"""Loss functions (counterpart of ``deeplearning4j_tpu/losses``: every
loss of the JAX package, under the same names and aliases).

Each loss takes (labels, preout, activation, mask) as the reference's
``ILossFunction``: ``preout`` is the output layer's pre-activation, so
the softmax and sigmoid cross-entropies run in fused, stable forms.
``score_array`` gives one score per example (the sum over outputs),
``score`` their mean over the minibatch, or over the live rows when a
mask is given. Per-output ``weights`` multiply the unreduced loss. In a
data-parallel step the divisor (and the F-measure's batch sums) are the
global batch's (``nn/global_batch.py``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..activations import Activation, Identity, Sigmoid, Softmax
from ..nn import global_batch as G

_EPS = 1e-7


def _apply_mask(per_out, mask):
    if mask is None:
        return per_out
    mask = mask.to(per_out.dtype)
    if mask.ndim == per_out.ndim - 1:
        mask = mask[..., None]
    return per_out * mask


def _row_mask(mask):
    """A per-example mask: whether any entry of the row is live."""
    return mask.reshape(mask.shape[0], -1).amax(-1)


class LossFunction:
    """Base loss."""

    name: str = "loss"

    def __init__(self, weights=None):
        self.weights = None if weights is None else \
            torch.as_tensor(weights, dtype=torch.float32)

    def per_output(self, labels, preout, activation: Activation):
        """Unreduced loss, the shape of ``labels``."""
        raise NotImplementedError

    def score_array(self, labels, preout, activation: Activation = Identity(),
                    mask=None):
        per = self.per_output(labels, preout, activation)
        if self.weights is not None:
            per = per * self.weights.to(per.device)
        per = _apply_mask(per, mask)
        return per.reshape(per.shape[0], -1).sum(-1)

    def score(self, labels, preout, activation: Activation = Identity(),
              mask: Optional[torch.Tensor] = None, average: bool = True):
        """Sum of ``score_array``, divided by the number of examples
        (``labels.shape[0]``) or, with a mask, by the number of rows
        whose mask is nonzero anywhere (at least 1)."""
        s = self.score_array(labels, preout, activation, mask).sum()
        if average:
            # the global batch's count in a data-parallel step
            n = G.rows(labels.shape[0]) if mask is None else \
                torch.clamp_min(G.count(_row_mask(mask).sum()), 1)
            s = s / n
        return s

    def to_json(self) -> dict:
        d = {"@class": self.name}
        for k, v in self.__dict__.items():
            if k == "weights":
                if v is not None:
                    d["weights"] = [float(w) for w in v]
            else:
                d[k] = v
        return d

    def __eq__(self, other):
        return type(self) is type(other) and self.to_json() == other.to_json()

    def __hash__(self):
        return hash(type(self).__name__)

    def __repr__(self):
        return f"Loss({self.name})"


class LossMSE(LossFunction):
    """Mean squared error: per-output (y - yhat)^2 / nOut."""

    name = "mse"

    def per_output(self, labels, preout, activation):
        return (labels - activation(preout)) ** 2 / labels.shape[-1]


class LossL2(LossFunction):
    name = "l2"

    def per_output(self, labels, preout, activation):
        return (labels - activation(preout)) ** 2


class LossMAE(LossFunction):
    name = "mae"

    def per_output(self, labels, preout, activation):
        return torch.abs(labels - activation(preout)) / labels.shape[-1]


class LossL1(LossFunction):
    name = "l1"

    def per_output(self, labels, preout, activation):
        return torch.abs(labels - activation(preout))


class LossMAPE(LossFunction):
    name = "mape"

    def per_output(self, labels, preout, activation):
        denom = torch.where(torch.abs(labels) < _EPS,
                            torch.full_like(labels, _EPS), labels)
        return 100.0 / labels.shape[-1] * torch.abs(
            (labels - activation(preout)) / denom)


class LossMSLE(LossFunction):
    name = "msle"

    def per_output(self, labels, preout, activation):
        out = activation(preout)
        return (torch.log1p(torch.clamp_min(out, -1 + _EPS))
                - torch.log1p(torch.clamp_min(labels, -1 + _EPS))) ** 2 \
            / labels.shape[-1]


class LossMCXENT(LossFunction):
    """Multi-class cross entropy: fused log-softmax with a Softmax
    output activation, else -sum(y * log(clip(yhat)))."""

    name = "mcxent"

    def __init__(self, weights=None, clip_eps: float = 1e-10):
        super().__init__(weights)
        self.clip_eps = float(clip_eps)

    def per_output(self, labels, preout, activation):
        if isinstance(activation, Softmax):
            return -(labels * torch.log_softmax(preout, dim=-1))
        out = torch.clamp(activation(preout), self.clip_eps,
                          1.0 - self.clip_eps)
        return -(labels * torch.log(out))


class LossNegativeLogLikelihood(LossMCXENT):
    name = "negativeloglikelihood"


class LossBinaryXENT(LossFunction):
    """Binary cross entropy; the fused form max(x, 0) - x y +
    log1p(exp(-|x|)) with a Sigmoid output, else clipped at 1e-5."""

    name = "binaryxent"

    def __init__(self, weights=None, clip_eps: float = 1e-5):
        super().__init__(weights)
        self.clip_eps = float(clip_eps)

    def per_output(self, labels, preout, activation):
        if isinstance(activation, Sigmoid):
            x = preout
            return torch.clamp_min(x, 0) - x * labels + \
                torch.log1p(torch.exp(-torch.abs(x)))
        out = torch.clamp(activation(preout), self.clip_eps,
                          1.0 - self.clip_eps)
        return -(labels * torch.log(out) + (1.0 - labels) * torch.log1p(-out))


class LossXENT(LossBinaryXENT):
    name = "xent"


class LossHinge(LossFunction):
    """Labels in {-1, +1}."""

    name = "hinge"

    def per_output(self, labels, preout, activation):
        return torch.clamp_min(1.0 - labels * activation(preout), 0.0)


class LossSquaredHinge(LossFunction):
    name = "squaredhinge"

    def per_output(self, labels, preout, activation):
        return torch.clamp_min(1.0 - labels * activation(preout), 0.0) ** 2


class LossKLD(LossFunction):
    name = "kld"

    def per_output(self, labels, preout, activation):
        out = torch.clamp(activation(preout), _EPS, 1.0 - _EPS)
        lab = torch.clamp(labels, _EPS, 1.0)
        return lab * (torch.log(lab) - torch.log(out))


class LossPoisson(LossFunction):
    name = "poisson"

    def per_output(self, labels, preout, activation):
        out = torch.clamp_min(activation(preout), _EPS)
        return out - labels * torch.log(out)


class LossCosineProximity(LossFunction):
    """-cos(labels, out) per example, spread over the outputs."""

    name = "cosineproximity"

    def per_output(self, labels, preout, activation):
        out = activation(preout)
        ln = torch.linalg.norm(labels, dim=-1, keepdim=True)
        on = torch.linalg.norm(out, dim=-1, keepdim=True)
        return -(labels * out) / torch.clamp_min(ln * on, _EPS)


class LossFMeasure(LossFunction):
    """Soft F-beta of a binary problem over the whole minibatch;
    ``score_array`` spreads the batch score evenly over the examples."""

    name = "fmeasure"

    def __init__(self, beta: float = 1.0):
        super().__init__(None)
        self.beta = float(beta)

    def _batch_score(self, labels, preout, activation):
        out = activation(preout)
        col = 1 if labels.shape[-1] == 2 else 0
        y, p = labels[..., col], out[..., col]
        tp = G.sum_(torch.sum(y * p))
        fp = G.sum_(torch.sum((1 - y) * p))
        fn = G.sum_(torch.sum(y * (1 - p)))
        b2 = self.beta ** 2
        num = (1 + b2) * tp
        den = (1 + b2) * tp + b2 * fn + fp
        return torch.where(den < _EPS, torch.zeros_like(den),
                           1.0 - num / torch.clamp_min(den, _EPS))

    def score_array(self, labels, preout, activation=Identity(), mask=None):
        n = labels.shape[0]
        return (self._batch_score(labels, preout, activation) / n).expand(n)

    def score(self, labels, preout, activation=Identity(), mask=None,
              average=True):
        return G.share(self._batch_score(labels, preout, activation))


class LossMultiLabel(LossFunction):
    """Rank loss over (positive, negative) label pairs: the mean of
    exp(out_neg - out_pos)."""

    name = "multilabel"

    def score_array(self, labels, preout, activation=Identity(), mask=None):
        out = activation(preout)
        pos = labels > 0.5
        diff = out[:, None, :] - out[:, :, None]     # [n, i, j]
        pair = pos[:, :, None] & ~pos[:, None, :]    # i positive, j not
        n = labels.shape[0]
        cnt = torch.clamp_min(pair.reshape(n, -1).sum(-1), 1)
        val = torch.where(pair, torch.exp(diff), torch.zeros_like(diff))
        per = val.reshape(n, -1).sum(-1) / cnt
        if mask is not None:
            per = per * _row_mask(mask)
        return per


class LossWasserstein(LossFunction):
    """mean(labels * out) per example."""

    name = "wasserstein"

    def per_output(self, labels, preout, activation):
        return labels * activation(preout) / labels.shape[-1]


class LossMixtureDensity(LossFunction):
    """Mixture-density loss: ``preout`` packs [alpha | sigma | mu] for
    ``mixtures`` Gaussians over ``labels_width`` dims; the negative log
    of the mixture's likelihood."""

    name = "mixturedensity"

    def __init__(self, mixtures: int, labels_width: int):
        super().__init__(None)
        self.mixtures = int(mixtures)
        self.labels_width = int(labels_width)

    def score_array(self, labels, preout, activation=Identity(), mask=None):
        m, w = self.mixtures, self.labels_width
        alpha = torch.log_softmax(preout[..., :m], dim=-1)
        sigma = torch.exp(preout[..., m:2 * m])
        mu = preout[..., 2 * m:2 * m + m * w].reshape(
            *preout.shape[:-1], m, w)
        lab = labels[..., None, :]
        log_norm = -0.5 * w * math.log(2 * math.pi) - w * torch.log(sigma)
        sq = -0.5 * torch.sum((lab - mu) ** 2, dim=-1) / sigma ** 2
        per = -torch.logsumexp(alpha + log_norm + sq, dim=-1)
        if per.ndim > 1:
            per = per.reshape(per.shape[0], -1).sum(-1)
        if mask is not None:
            per = per * _row_mask(mask)
        return per


_REGISTRY = {c.name: c for c in (
    LossMSE, LossL2, LossMAE, LossL1, LossMAPE, LossMSLE, LossMCXENT,
    LossNegativeLogLikelihood, LossBinaryXENT, LossXENT, LossHinge,
    LossSquaredHinge, LossKLD, LossPoisson, LossCosineProximity,
    LossFMeasure, LossMultiLabel, LossWasserstein, LossMixtureDensity)}

# the reference's LossFunction enum aliases and Keras loss identifiers
# (sparse_categorical_crossentropy is deliberately not one: mcxent
# takes one-hot labels)
_ALIASES = {
    "squared_loss": "l2",
    "reconstruction_crossentropy": "binaryxent",
    "cosine_proximity": "cosineproximity",
    "mean_absolute_error": "mae",
    "mean_squared_logarithmic_error": "msle",
    "mean_absolute_percentage_error": "mape",
    "kl_divergence": "kld",
    "mean_squared_error": "mse",
    "categorical_crossentropy": "mcxent",
    "binary_crossentropy": "xent",
}


def get(spec) -> LossFunction:
    """A loss from an instance, a name (or alias) or a ``{"@class":
    name, **kwargs}`` dict."""
    if isinstance(spec, LossFunction):
        return spec
    if isinstance(spec, dict):
        d = dict(spec)
        return _lookup(d.pop("@class"))(**d)
    name = str(spec).lower()
    return _lookup(_ALIASES.get(name, name))()


def _lookup(name: str) -> type:
    if name not in _REGISTRY:
        raise ValueError(f"Unknown loss: {name!r}. Known: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def names():
    return sorted(_REGISTRY)
