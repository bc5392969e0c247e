"""Dataset iterators (counterpart of ``deeplearning4j_tpu/datasets``:
``DataSetIterator`` and ``ArrayDataSetIterator``, plain numpy, kept as
the port's own copy).

Iterating yields ``(features, labels[, labels_mask])`` tuples of numpy
arrays; ``MultiLayerNetwork.fit`` moves each batch to its device.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


class DataSetIterator:
    """Base iterator SPI: ``has_next``/``next``/``reset``."""

    def __iter__(self) -> Iterator:
        self.reset()
        return self

    def __next__(self):
        if not self.has_next():
            raise StopIteration
        return self.next()

    def has_next(self) -> bool:
        raise NotImplementedError

    def next(self):
        raise NotImplementedError

    def reset(self):
        pass

    def batch_size(self) -> int:
        raise NotImplementedError


class ArrayDataSetIterator(DataSetIterator):
    """Minibatches over in-memory arrays. Drops the ragged final batch
    unless ``keep_last=True``. With ``shuffle=True`` each pass draws
    its order from ``RandomState(seed + pass number)``."""

    def __init__(self, features, labels, batch: int = 32,
                 shuffle: bool = False, seed: int = 0,
                 keep_last: bool = False, labels_mask=None):
        self.features = np.asarray(features)
        self.labels = np.asarray(labels)
        self.labels_mask = None if labels_mask is None \
            else np.asarray(labels_mask)
        self.batch = int(batch)
        self.shuffle = shuffle
        self.seed = seed
        self.keep_last = keep_last
        self._order = np.arange(self.features.shape[0])
        self._pos = 0
        self._epoch = 0

    def reset(self):
        self._pos = 0
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self._epoch)
            self._order = rng.permutation(self.features.shape[0])
        self._epoch += 1

    def has_next(self) -> bool:
        remaining = self.features.shape[0] - self._pos
        return remaining >= self.batch or (self.keep_last and remaining > 0)

    def next(self):
        idx = self._order[self._pos:self._pos + self.batch]
        self._pos += len(idx)
        if self.labels_mask is not None:
            return (self.features[idx], self.labels[idx],
                    self.labels_mask[idx])
        return (self.features[idx], self.labels[idx])

    def batch_size(self) -> int:
        return self.batch

    def total_examples(self) -> int:
        return self.features.shape[0]
