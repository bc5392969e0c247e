"""Early stopping (counterpart of ``deeplearning4j_tpu/earlystopping``):
a score calculator, the termination conditions, the model savers, the
configuration, the trainer and its result.

The trainer fits one epoch at a time, scores the model every
``evaluate_every_n_epochs`` epochs, saves the best model and stops at
the first termination condition that holds, as JAX's does.
``InMemoryModelSaver`` keeps a JSON ``clone`` of the best network;
``LocalFileModelSaver`` writes it with the serializer.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence

import numpy as np
import torch


# ---------------------------------------------------------------------------
# score calculators
# ---------------------------------------------------------------------------
class DataSetLossCalculator:
    """The mean of ``model.score`` over an iterator's batches."""

    def __init__(self, iterator):
        self.iterator = iterator

    def calculate_score(self, model) -> float:
        losses = []
        for batch in self.iterator:
            x, y = batch[0], batch[1]
            m = batch[2] if len(batch) > 2 else None
            losses.append(float(model.score(x, y, mask=m)))
        if hasattr(self.iterator, "reset"):
            self.iterator.reset()
        return float(np.mean(losses))


# ---------------------------------------------------------------------------
# termination conditions
# ---------------------------------------------------------------------------
class MaxEpochsTerminationCondition:
    def __init__(self, max_epochs: int):
        self.max_epochs = max_epochs

    def terminate(self, epoch: int, score: float, best_score: float,
                  epochs_without_improvement: int) -> bool:
        return epoch + 1 >= self.max_epochs


class ScoreImprovementEpochTerminationCondition:
    """Stop after more than ``patience`` epochs without improvement."""

    def __init__(self, patience: int, min_improvement: float = 0.0):
        self.patience = patience
        self.min_improvement = min_improvement

    def terminate(self, epoch, score, best_score,
                  epochs_without_improvement) -> bool:
        return epochs_without_improvement > self.patience


class BestScoreEpochTerminationCondition:
    """Stop once the score reaches ``target``."""

    def __init__(self, target: float):
        self.target = target

    def terminate(self, epoch, score, best_score,
                  epochs_without_improvement) -> bool:
        return score <= self.target


class MaxTimeTerminationCondition:
    def __init__(self, seconds: float):
        self.seconds = seconds
        self._start: Optional[float] = None

    def terminate(self, epoch, score, best_score,
                  epochs_without_improvement) -> bool:
        if self._start is None:
            self._start = time.time()
            return False
        return time.time() - self._start > self.seconds


# ---------------------------------------------------------------------------
# savers
# ---------------------------------------------------------------------------
class InMemoryModelSaver:
    """Keeps a copy of the best network (``clone``: params and layer
    state) in memory."""

    def __init__(self):
        self._best = None

    def save_best_model(self, model, score: float):
        self._best = (model.clone(), score)

    def get_best_model(self, model):
        """Copies the saved params and layer state INTO ``model`` (its
        updater state stays) and returns it."""
        if self._best is None:
            return model
        best = self._best[0]
        with torch.no_grad():
            for tree, saved in ((model.params(), best.params()),
                                (model.get_net_state(),
                                 best.get_net_state())):
                for key, leaves in tree.items():
                    for n, t in leaves.items():
                        t.copy_(saved[key][n])
        return model


class LocalFileModelSaver:
    """Writes the best network to ``directory/bestModel.zip``."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    @property
    def path(self) -> str:
        return os.path.join(self.directory, "bestModel.zip")

    def save_best_model(self, model, score: float):
        from ..util.serializer import ModelSerializer
        ModelSerializer.write_model(model, self.path)

    def get_best_model(self, model):
        """The saved network, restored on ``model``'s device."""
        from ..util.serializer import ModelSerializer
        return ModelSerializer.restore_multi_layer_network(
            self.path, device=model.device)


# ---------------------------------------------------------------------------
# configuration + trainer + result
# ---------------------------------------------------------------------------
@dataclass
class EarlyStoppingResult:
    """What the trainer ran to, and the best model."""
    termination_reason: str
    termination_details: str
    score_vs_epoch: List[float]
    best_model_epoch: int
    best_model_score: float
    total_epochs: int
    best_model: Any


class EarlyStoppingConfiguration:
    """The calculator, the conditions, the saver and the cadence."""

    def __init__(self, score_calculator,
                 epoch_termination_conditions: Sequence = (),
                 model_saver=None, evaluate_every_n_epochs: int = 1,
                 save_last_model: bool = False):
        self.score_calculator = score_calculator
        self.epoch_termination_conditions = list(
            epoch_termination_conditions)
        self.model_saver = model_saver or InMemoryModelSaver()
        self.evaluate_every_n_epochs = evaluate_every_n_epochs


class EarlyStoppingTrainer:
    """Train an epoch, score, keep the best, check the conditions."""

    def __init__(self, config: EarlyStoppingConfiguration, model,
                 train_iterator):
        self.config = config
        self.model = model
        self.iterator = train_iterator

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        best_score = np.inf
        best_epoch = -1
        scores: List[float] = []
        epochs_no_improve = 0
        epoch = 0
        reason, details = "MaxEpochs", "conditions exhausted"
        while True:
            self.model.fit(self.iterator, epochs=1)
            if epoch % cfg.evaluate_every_n_epochs == 0:
                score = cfg.score_calculator.calculate_score(self.model)
                scores.append(score)
                if score < best_score:
                    best_score = score
                    best_epoch = epoch
                    epochs_no_improve = 0
                    cfg.model_saver.save_best_model(self.model, score)
                else:
                    epochs_no_improve += 1
            stop = False
            for cond in cfg.epoch_termination_conditions:
                if cond.terminate(epoch, scores[-1], best_score,
                                  epochs_no_improve):
                    reason = type(cond).__name__
                    details = (f"epoch={epoch} score={scores[-1]:.6f} "
                               f"best={best_score:.6f}")
                    stop = True
                    break
            epoch += 1
            if stop:
                break
        best = cfg.model_saver.get_best_model(self.model)
        return EarlyStoppingResult(
            termination_reason=reason, termination_details=details,
            score_vs_epoch=scores, best_model_epoch=best_epoch,
            best_model_score=best_score, total_epochs=epoch,
            best_model=best)
