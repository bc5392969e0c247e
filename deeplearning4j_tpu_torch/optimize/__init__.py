"""Training listeners (counterpart of ``deeplearning4j_tpu/optimize``).

``MultiLayerNetwork.fit`` calls ``iteration_done`` and ``on_timing``
after every step and ``on_epoch_end`` after every pass, as the JAX
package does. A listener that reads ``model.score_`` synchronizes with
the device at its own reporting frequency only. ``CheckpointListener``
writes the serializer's archives, which either package restores.
"""
from __future__ import annotations

import os
import time
from typing import Callable, List, Optional


class TrainingListener:
    """The listener SPI: every hook is a no-op by default."""

    def iteration_done(self, model, iteration: int, epoch: int):
        pass

    def on_epoch_end(self, model):
        pass

    def on_timing(self, model, seconds: float, batch_size: int):
        pass


class ScoreIterationListener(TrainingListener):
    """Logs the score every ``print_every`` iterations."""

    def __init__(self, print_every: int = 10,
                 out: Callable[[str], None] = print):
        self.print_every = max(int(print_every), 1)
        self.out = out

    def iteration_done(self, model, iteration, epoch):
        if iteration % self.print_every == 0:
            self.out(f"Score at iteration {iteration} is {model.score_:.6f}")


class PerformanceListener(TrainingListener):
    """Samples/s and ms an iteration every ``frequency`` iterations,
    from the host's wall clock of each step (its dispatch; on the card
    a step returns once queued)."""

    def __init__(self, frequency: int = 10,
                 report: Callable[[str], None] = print):
        self.frequency = max(int(frequency), 1)
        self.report = report
        self._samples = 0
        self._seconds = 0.0
        self._iter = 0
        self.last_samples_per_sec: Optional[float] = None

    def on_timing(self, model, seconds, batch_size):
        self._samples += batch_size
        self._seconds += seconds
        self._iter += 1
        if self._iter % self.frequency == 0 and self._seconds > 0:
            self.last_samples_per_sec = self._samples / self._seconds
            self.report(
                f"iteration {self._iter}: {self.last_samples_per_sec:.1f} "
                f"samples/sec ({1000 * self._seconds / self.frequency:.1f} "
                f"ms/iter)")
            self._samples = 0
            self._seconds = 0.0


class TimeIterationListener(TrainingListener):
    """An ETA every ``frequency`` iterations."""

    def __init__(self, total_iterations: int,
                 report: Callable[[str], None] = print, frequency: int = 50):
        self.total = total_iterations
        self.report = report
        self.frequency = frequency
        self._start = None

    def iteration_done(self, model, iteration, epoch):
        if self._start is None:
            self._start = time.time()
            return
        if iteration % self.frequency == 0:
            elapsed = time.time() - self._start
            remaining = (self.total - iteration) * elapsed / max(iteration, 1)
            self.report(f"ETA: {remaining:.0f}s ({iteration}/{self.total})")


class EvaluativeListener(TrainingListener):
    """Runs ``model.evaluate`` every ``frequency`` epochs (or
    iterations, ``unit="iteration"``)."""

    def __init__(self, iterator, frequency: int = 1, unit: str = "epoch",
                 report: Callable[[str], None] = print):
        self.iterator = iterator
        self.frequency = max(int(frequency), 1)
        self.unit = unit
        self.report = report
        self.last_evaluation = None

    def _run(self, model):
        self.last_evaluation = model.evaluate(self.iterator)
        self.report(f"Accuracy: {self.last_evaluation.accuracy():.4f}")

    def iteration_done(self, model, iteration, epoch):
        if self.unit == "iteration" and iteration % self.frequency == 0:
            self._run(model)

    def on_epoch_end(self, model):
        if self.unit == "epoch":
            self._run(model)


class CheckpointListener(TrainingListener):
    """Writes a checkpoint (``util/serializer.py``, updater state
    included) every ``save_every_n_iterations`` iterations and/or every
    ``save_every_n_epochs`` epochs into ``directory``, as
    ``checkpoint_iter_<n>.zip`` or ``checkpoint_epoch_<n>.zip``, and
    keeps only the last ``keep_last`` files it wrote."""

    def __init__(self, directory: str,
                 save_every_n_iterations: Optional[int] = None,
                 save_every_n_epochs: Optional[int] = None,
                 keep_last: int = 3):
        self.directory = directory
        self.every_iter = save_every_n_iterations
        self.every_epoch = save_every_n_epochs
        self.keep_last = keep_last
        self._saved: List[str] = []
        os.makedirs(directory, exist_ok=True)

    def _save(self, model, tag: str):
        from ..util.serializer import ModelSerializer
        path = os.path.join(self.directory, f"checkpoint_{tag}.zip")
        ModelSerializer.write_model(model, path, save_updater=True)
        self._saved.append(path)
        while len(self._saved) > self.keep_last:
            old = self._saved.pop(0)
            if os.path.exists(old):
                os.remove(old)

    def iteration_done(self, model, iteration, epoch):
        if self.every_iter and iteration % self.every_iter == 0:
            self._save(model, f"iter_{iteration}")

    def on_epoch_end(self, model):
        if self.every_epoch and model._epoch % self.every_epoch == 0:
            self._save(model, f"epoch_{model._epoch}")

    def last_checkpoint(self) -> Optional[str]:
        return self._saved[-1] if self._saved else None
