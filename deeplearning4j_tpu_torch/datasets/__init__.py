"""Datasets and iterators (counterpart of
``deeplearning4j_tpu/datasets``, plain numpy, kept as the port's own
copy): ``DataSet``, ``DataSetIterator``, ``ArrayDataSetIterator``,
``AsyncDataSetIterator``, ``MnistDataSetIterator``,
``IrisDataSetIterator``, ``Cifar10DataSetIterator`` and
``TinyImageNetDataSetIterator``.

Iterating yields ``(features, labels[, labels_mask])`` tuples of numpy
arrays; ``MultiLayerNetwork.fit`` moves each batch to its device.

``MnistDataSetIterator`` reads the four MNIST IDX files from the first
directory that holds them, in the JAX package's order: ``$MNIST_DATA_DIR``,
``$DL4J_TPU_DATA_DIR/mnist`` (default ``~/.deeplearning4j_tpu/mnist``),
``~/.cache/mnist``; the JAX package's fixed absolute paths are not
searched, so only the environment and ``$HOME`` choose. Without them
it reads the vendored real handwritten digits in
``fixtures/real_digits`` (1,797 8x8 scans of UCI ML digits, public
domain, in IDX form), each file checked against its sha256 in
``manifest.json`` before it is parsed, and re-gridded to 28x28 by 3x
pixel replication and a 2-pixel zero border. Only a missing fixture
falls back to a labelled synthetic set; a corrupt one raises.

``Cifar10DataSetIterator`` reads CIFAR-10's binary batches from
``data_dir``, ``$CIFAR10_DATA_DIR`` or ``$DL4J_TPU_DATA_DIR/cifar10``,
and ``TinyImageNetDataSetIterator`` the ``tiny-imagenet-200`` layout
from ``data_dir`` or ``$DL4J_TPU_DATA_DIR/tiny-imagenet-200`` (decoded
through PIL). Without them each builds the JAX package's seeded
synthetic set (``.synthetic``). As for MNIST, the JAX package's fixed
absolute paths are not searched. The directories come from the port's
``flags`` registry, a copy of the JAX package's.
"""
from __future__ import annotations

import gzip
import hashlib
import json
import os
import queue
import struct
import threading
from typing import Iterator, Optional, Tuple

import numpy as np


class DataSet:
    """Features, labels and optional masks."""

    def __init__(self, features, labels, features_mask=None,
                 labels_mask=None):
        self.features = features
        self.labels = labels
        self.features_mask = features_mask
        self.labels_mask = labels_mask

    def num_examples(self) -> int:
        return int(np.asarray(self.features).shape[0])

    def split_test_and_train(self, n_train: int
                             ) -> Tuple["DataSet", "DataSet"]:
        f, l = np.asarray(self.features), np.asarray(self.labels)
        return (DataSet(f[:n_train], l[:n_train]),
                DataSet(f[n_train:], l[n_train:]))

    def shuffle(self, seed: int = 0):
        idx = np.random.RandomState(seed).permutation(self.num_examples())
        self.features = np.asarray(self.features)[idx]
        self.labels = np.asarray(self.labels)[idx]
        if self.features_mask is not None:
            self.features_mask = np.asarray(self.features_mask)[idx]
        if self.labels_mask is not None:
            self.labels_mask = np.asarray(self.labels_mask)[idx]


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

    # -- replay cursor -------------------------------------------------
    def state_dict(self) -> dict:
        """The reset counter: a pass's shuffle is a function of (seed,
        pass number)."""
        return {"epoch": int(self._epoch)}

    def load_state_dict(self, state: dict):
        self._epoch = int(state.get("epoch", self._epoch))


class AsyncDataSetIterator(DataSetIterator):
    """Prefetches the base iterator's batches on a background thread, so
    host ETL overlaps the device's steps. ``reset`` stops and joins the
    old worker before the base iterator is reset; each pass has its own
    queue and stop event."""

    _DONE = object()

    def __init__(self, base: DataSetIterator, prefetch: int = 2):
        self.base = base
        self.prefetch = prefetch
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop: Optional[threading.Event] = None
        self._next_item = None

    def reset(self):
        if self._thread is not None and self._thread.is_alive():
            self._stop.set()
            try:   # drain, so a worker blocked on put() sees the stop
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=5)
        self.base.reset()
        q = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        base, done = self.base, self._DONE

        def worker():
            try:
                while not stop.is_set() and base.has_next():
                    item = base.next()
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
            finally:
                if not stop.is_set():
                    q.put(done)

        self._queue, self._stop = q, stop
        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()
        self._advance()

    def _advance(self):
        item = self._queue.get()
        self._next_item = None if item is self._DONE else item

    def has_next(self) -> bool:
        if self._queue is None:
            self.reset()
        return self._next_item is not None

    def next(self):
        item = self._next_item
        self._advance()
        return item

    def batch_size(self) -> int:
        return self.base.batch_size()

    def state_dict(self) -> dict:
        return (self.base.state_dict()
                if hasattr(self.base, "state_dict") else {})

    def load_state_dict(self, state: dict):
        if hasattr(self.base, "load_state_dict"):
            self.base.load_state_dict(state)


# -- MNIST and the vendored real digits ---------------------------------
def _mnist_dirs():
    """Where MNIST's IDX files are looked for, in order (the flags
    ``mnist_dir`` and ``data_dir``)."""
    from ..flags import flags
    return [flags.mnist_dir, os.path.join(flags.data_dir, "mnist"),
            os.path.expanduser("~/.cache/mnist")]


def _read_idx_images(path: str) -> np.ndarray:
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        magic, n, h, w = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise IOError(f"{path}: bad IDX image magic {magic}")
        return np.frombuffer(f.read(), np.uint8).reshape(n, h, w)


def _read_idx_labels(path: str) -> np.ndarray:
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise IOError(f"{path}: bad IDX label magic {magic}")
        return np.frombuffer(f.read(), np.uint8)


def _find_mnist() -> Optional[str]:
    names = ["train-images-idx3-ubyte", "train-labels-idx1-ubyte",
             "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"]
    for d in _mnist_dirs():
        if not d or not os.path.isdir(d):
            continue
        if all(os.path.exists(os.path.join(d, n)) or
               os.path.exists(os.path.join(d, n + ".gz")) for n in names):
            return d
    return None


_REAL_DIGITS_DIR = os.path.join(os.path.dirname(__file__), "fixtures",
                                "real_digits")


def _load_real_digits(train: bool) -> Tuple[np.ndarray, np.ndarray]:
    """The vendored real digits as uint8 [n, 28, 28] images and labels,
    each file's sha256 checked against the manifest first (a mismatch
    raises ``IOError``; a missing file ``FileNotFoundError``)."""
    with open(os.path.join(_REAL_DIGITS_DIR, "manifest.json")) as f:
        manifest = json.load(f)
    prefix = "train" if train else "t10k"

    def verified(name):
        path = os.path.join(_REAL_DIGITS_DIR, name)
        want = manifest["files"][name]["sha256"]
        with open(path, "rb") as f:
            got = hashlib.sha256(f.read()).hexdigest()
        if got != want:
            raise IOError(f"real-digits fixture {name} checksum mismatch:"
                          f" {got} != {want}")
        return path

    imgs = _read_idx_images(verified(f"{prefix}-images-idx3-ubyte.gz"))
    labels = _read_idx_labels(verified(f"{prefix}-labels-idx1-ubyte.gz"))
    up = np.repeat(np.repeat(imgs, 3, axis=1), 3, axis=2)   # 8 -> 24
    out = np.zeros((len(up), 28, 28), np.uint8)
    out[:, 2:26, 2:26] = up
    return out, labels


def _synthetic_mnist(n: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """A learnable stand-in: one fixed blob pattern a class plus
    noise; only the noise and the labels vary with ``seed``."""
    protos = np.random.RandomState(424242).rand(10, 28, 28) > 0.75
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, n)
    imgs = protos[labels].astype(np.float32) * 0.8
    imgs += rng.rand(n, 28, 28).astype(np.float32) * 0.3
    return (imgs * 255).clip(0, 255).astype(np.uint8), labels.astype(np.uint8)


class MnistDataSetIterator(ArrayDataSetIterator):
    """MNIST (or the vendored real digits, see the module doc):
    features in [0, 1], flattened to 784 or, with ``flatten=False``,
    NHWC [28, 28, 1] images; one-hot labels. ``source`` says which data
    it read ("mnist", "real-digits-8x8" or "synthetic"). Evaluation
    (``train=False``) keeps the last partial batch by default."""

    def __init__(self, batch: int, train: bool = True, shuffle: bool = True,
                 seed: int = 6, flatten: bool = True,
                 num_examples: Optional[int] = None,
                 keep_last: Optional[bool] = None):
        if keep_last is None:
            keep_last = not train
        d = _find_mnist()
        if d is not None:
            self.source = "mnist"
            prefix = "train" if train else "t10k"

            def path(name):
                full = os.path.join(d, name)
                return full if os.path.exists(full) else full + ".gz"
            imgs = _read_idx_images(path(f"{prefix}-images-idx3-ubyte"))
            labels = _read_idx_labels(path(f"{prefix}-labels-idx1-ubyte"))
        else:
            try:
                imgs, labels = _load_real_digits(train)
                self.source = "real-digits-8x8"
            except FileNotFoundError:
                # only a MISSING fixture falls back; a corrupt one has
                # raised its checksum IOError
                n = num_examples or (10000 if train else 2000)
                imgs, labels = _synthetic_mnist(n, seed=1 if train else 2)
                self.source = "synthetic"
        self.synthetic = self.source == "synthetic"
        if num_examples:
            imgs, labels = imgs[:num_examples], labels[:num_examples]
        feats = imgs.astype(np.float32) / 255.0
        feats = feats.reshape(len(feats), -1) if flatten else feats[..., None]
        onehot = np.eye(10, dtype=np.float32)[labels]
        super().__init__(feats, onehot, batch=batch, shuffle=shuffle,
                         seed=seed, keep_last=keep_last)


# Fisher's iris measurements (public domain), embedded:
# (sepal length, sepal width, petal length, petal width, class)
_IRIS = np.array([
    [5.1,3.5,1.4,0.2,0],[4.9,3.0,1.4,0.2,0],[4.7,3.2,1.3,0.2,0],
    [4.6,3.1,1.5,0.2,0],[5.0,3.6,1.4,0.2,0],[5.4,3.9,1.7,0.4,0],
    [4.6,3.4,1.4,0.3,0],[5.0,3.4,1.5,0.2,0],[4.4,2.9,1.4,0.2,0],
    [4.9,3.1,1.5,0.1,0],[5.4,3.7,1.5,0.2,0],[4.8,3.4,1.6,0.2,0],
    [4.8,3.0,1.4,0.1,0],[4.3,3.0,1.1,0.1,0],[5.8,4.0,1.2,0.2,0],
    [5.7,4.4,1.5,0.4,0],[5.4,3.9,1.3,0.4,0],[5.1,3.5,1.4,0.3,0],
    [5.7,3.8,1.7,0.3,0],[5.1,3.8,1.5,0.3,0],[5.4,3.4,1.7,0.2,0],
    [5.1,3.7,1.5,0.4,0],[4.6,3.6,1.0,0.2,0],[5.1,3.3,1.7,0.5,0],
    [4.8,3.4,1.9,0.2,0],[5.0,3.0,1.6,0.2,0],[5.0,3.4,1.6,0.4,0],
    [5.2,3.5,1.5,0.2,0],[5.2,3.4,1.4,0.2,0],[4.7,3.2,1.6,0.2,0],
    [4.8,3.1,1.6,0.2,0],[5.4,3.4,1.5,0.4,0],[5.2,4.1,1.5,0.1,0],
    [5.5,4.2,1.4,0.2,0],[4.9,3.1,1.5,0.2,0],[5.0,3.2,1.2,0.2,0],
    [5.5,3.5,1.3,0.2,0],[4.9,3.6,1.4,0.1,0],[4.4,3.0,1.3,0.2,0],
    [5.1,3.4,1.5,0.2,0],[5.0,3.5,1.3,0.3,0],[4.5,2.3,1.3,0.3,0],
    [4.4,3.2,1.3,0.2,0],[5.0,3.5,1.6,0.6,0],[5.1,3.8,1.9,0.4,0],
    [4.8,3.0,1.4,0.3,0],[5.1,3.8,1.6,0.2,0],[4.6,3.2,1.4,0.2,0],
    [5.3,3.7,1.5,0.2,0],[5.0,3.3,1.4,0.2,0],[7.0,3.2,4.7,1.4,1],
    [6.4,3.2,4.5,1.5,1],[6.9,3.1,4.9,1.5,1],[5.5,2.3,4.0,1.3,1],
    [6.5,2.8,4.6,1.5,1],[5.7,2.8,4.5,1.3,1],[6.3,3.3,4.7,1.6,1],
    [4.9,2.4,3.3,1.0,1],[6.6,2.9,4.6,1.3,1],[5.2,2.7,3.9,1.4,1],
    [5.0,2.0,3.5,1.0,1],[5.9,3.0,4.2,1.5,1],[6.0,2.2,4.0,1.0,1],
    [6.1,2.9,4.7,1.4,1],[5.6,2.9,3.6,1.3,1],[6.7,3.1,4.4,1.4,1],
    [5.6,3.0,4.5,1.5,1],[5.8,2.7,4.1,1.0,1],[6.2,2.2,4.5,1.5,1],
    [5.6,2.5,3.9,1.1,1],[5.9,3.2,4.8,1.8,1],[6.1,2.8,4.0,1.3,1],
    [6.3,2.5,4.9,1.5,1],[6.1,2.8,4.7,1.2,1],[6.4,2.9,4.3,1.3,1],
    [6.6,3.0,4.4,1.4,1],[6.8,2.8,4.8,1.4,1],[6.7,3.0,5.0,1.7,1],
    [6.0,2.9,4.5,1.5,1],[5.7,2.6,3.5,1.0,1],[5.5,2.4,3.8,1.1,1],
    [5.5,2.4,3.7,1.0,1],[5.8,2.7,3.9,1.2,1],[6.0,2.7,5.1,1.6,1],
    [5.4,3.0,4.5,1.5,1],[6.0,3.4,4.5,1.6,1],[6.7,3.1,4.7,1.5,1],
    [6.3,2.3,4.4,1.3,1],[5.6,3.0,4.1,1.3,1],[5.5,2.5,4.0,1.3,1],
    [5.5,2.6,4.4,1.2,1],[6.1,3.0,4.6,1.4,1],[5.8,2.6,4.0,1.2,1],
    [5.0,2.3,3.3,1.0,1],[5.6,2.7,4.2,1.3,1],[5.7,3.0,4.2,1.2,1],
    [5.7,2.9,4.2,1.3,1],[6.2,2.9,4.3,1.3,1],[5.1,2.5,3.0,1.1,1],
    [5.7,2.8,4.1,1.3,1],[6.3,3.3,6.0,2.5,2],[5.8,2.7,5.1,1.9,2],
    [7.1,3.0,5.9,2.1,2],[6.3,2.9,5.6,1.8,2],[6.5,3.0,5.8,2.2,2],
    [7.6,3.0,6.6,2.1,2],[4.9,2.5,4.5,1.7,2],[7.3,2.9,6.3,1.8,2],
    [6.7,2.5,5.8,1.8,2],[7.2,3.6,6.1,2.5,2],[6.5,3.2,5.1,2.0,2],
    [6.4,2.7,5.3,1.9,2],[6.8,3.0,5.5,2.1,2],[5.7,2.5,5.0,2.0,2],
    [5.8,2.8,5.1,2.4,2],[6.4,3.2,5.3,2.3,2],[6.5,3.0,5.5,1.8,2],
    [7.7,3.8,6.7,2.2,2],[7.7,2.6,6.9,2.3,2],[6.0,2.2,5.0,1.5,2],
    [6.9,3.2,5.7,2.3,2],[5.6,2.8,4.9,2.0,2],[7.7,2.8,6.7,2.0,2],
    [6.3,2.7,4.9,1.8,2],[6.7,3.3,5.7,2.1,2],[7.2,3.2,6.0,1.8,2],
    [6.2,2.8,4.8,1.8,2],[6.1,3.0,4.9,1.8,2],[6.4,2.8,5.6,2.1,2],
    [7.2,3.0,5.8,1.6,2],[7.4,2.8,6.1,1.9,2],[7.9,3.8,6.4,2.0,2],
    [6.4,2.8,5.6,2.2,2],[6.3,2.8,5.1,1.5,2],[6.1,2.6,5.6,1.4,2],
    [7.7,3.0,6.1,2.3,2],[6.3,3.4,5.6,2.4,2],[6.4,3.1,5.5,1.8,2],
    [6.0,3.0,4.8,1.8,2],[6.9,3.1,5.4,2.1,2],[6.7,3.1,5.6,2.4,2],
    [6.9,3.1,5.1,2.3,2],[5.8,2.7,5.1,1.9,2],[6.8,3.2,5.9,2.3,2],
    [6.7,3.3,5.7,2.5,2],[6.7,3.0,5.2,2.3,2],[6.3,2.5,5.0,1.9,2],
    [6.5,3.0,5.2,2.0,2],[6.2,3.4,5.4,2.3,2],[5.9,3.0,5.1,1.8,2],
], dtype=np.float32)


class IrisDataSetIterator(ArrayDataSetIterator):
    """The iris set, embedded: 150 samples, 4 features, 3 classes."""

    def __init__(self, batch: int = 150, shuffle: bool = False,
                 seed: int = 6):
        feats = _IRIS[:, :4]
        onehot = np.eye(3, dtype=np.float32)[_IRIS[:, 4].astype(int)]
        super().__init__(feats, onehot, batch=batch, shuffle=shuffle,
                         seed=seed)


# -- CIFAR-10 and TinyImageNet (JAX ``datasets/__init__.py:433-585``) ----
def _find_cifar10() -> Optional[str]:
    from ..flags import flags
    for d in (flags.cifar10_dir, os.path.join(flags.data_dir, "cifar10")):
        if d and os.path.exists(os.path.join(d, "data_batch_1.bin")):
            return d
    return None


class Cifar10DataSetIterator(ArrayDataSetIterator):
    """Ref: `Cifar10DataSetIterator.java`. Reads the standard CIFAR-10
    BINARY format (data_batch_*.bin / test_batch.bin: per record 1 label
    byte + 3072 CHW pixel bytes) from a local directory; falls back to a
    deterministic synthetic set when absent (no egress — the reference
    downloads)."""

    def __init__(self, batch: int, train: bool = True, shuffle: bool = True,
                 seed: int = 6, num_examples: Optional[int] = None,
                 data_dir: Optional[str] = None):
        d = data_dir or _find_cifar10()
        self.synthetic = d is None
        if d is not None:
            files = ([os.path.join(d, f"data_batch_{i}.bin")
                      for i in range(1, 6)] if train
                     else [os.path.join(d, "test_batch.bin")])
            imgs, labels = [], []
            for f in files:
                raw = np.fromfile(f, np.uint8).reshape(-1, 3073)
                labels.append(raw[:, 0])
                # CHW bytes -> NHWC float
                imgs.append(raw[:, 1:].reshape(-1, 3, 32, 32)
                            .transpose(0, 2, 3, 1))
            imgs = np.concatenate(imgs)
            labels = np.concatenate(labels)
        else:
            n = num_examples or (4096 if train else 1024)
            rng = np.random.RandomState(11 if train else 22)
            labels = rng.randint(0, 10, n).astype(np.uint8)
            base = rng.rand(10, 32, 32, 3).astype(np.float32)
            imgs = ((base[labels] * 0.7 + rng.rand(n, 32, 32, 3) * 0.3)
                    * 255).astype(np.uint8)
        if num_examples:
            imgs, labels = imgs[:num_examples], labels[:num_examples]
        feats = imgs.astype(np.float32) / 255.0
        onehot = np.eye(10, dtype=np.float32)[labels]
        super().__init__(feats, onehot, batch=batch, shuffle=shuffle,
                         seed=seed)


def _find_tiny_imagenet() -> Optional[str]:
    from ..flags import flags
    d = os.path.join(flags.data_dir, "tiny-imagenet-200")
    return d if os.path.isdir(os.path.join(d, "train")) else None


class TinyImageNetDataSetIterator(ArrayDataSetIterator):
    """Ref: `TinyImageNetDataSetIterator.java` (fetcher at
    `deeplearning4j-data/deeplearning4j-datasets/.../fetchers/
    TinyImageNetFetcher.java` — downloads + reads the tiny-imagenet-200
    layout: train/<wnid>/images/*.JPEG, val/images + val_annotations.txt).

    Reads the standard on-disk layout when present (decoding via PIL;
    if the dataset is on disk but PIL is not importable, a warning is
    emitted before falling back). With no dataset and no egress, falls
    back to a LABELED deterministic synthetic set (`.synthetic`) of
    64x64x3 images over `num_classes` prototype textures — the same
    hermetic contract as the MNIST/CIFAR iterators."""

    IMG = 64

    def __init__(self, batch: int, train: bool = True, shuffle: bool = True,
                 seed: int = 6, num_examples: Optional[int] = None,
                 num_classes: int = 200, data_dir: Optional[str] = None):
        d = data_dir or _find_tiny_imagenet()
        imgs = labels = None
        if d is not None:
            # per-class cap BEFORE decoding (class-sorted data: a flat
            # prefix would hold only the first wnids, and decoding all
            # 100k JPEGs to keep 100 would waste minutes)
            per_class = None
            if num_examples:
                per_class = -(-num_examples // num_classes)  # ceil
            imgs, labels = self._read_disk(d, train, num_classes,
                                           per_class)
        self.synthetic = imgs is None
        if imgs is not None and num_examples:
            rng = np.random.RandomState(seed)
            idx = rng.permutation(len(imgs))[:num_examples]
            imgs, labels = imgs[idx], labels[idx]
        if imgs is None:
            n = num_examples or (8192 if train else 2048)
            rng = np.random.RandomState(33 if train else 44)
            labels = rng.randint(0, num_classes, n)
            protos = np.random.RandomState(777).rand(
                num_classes, self.IMG, self.IMG, 3).astype(np.float32)
            imgs = ((protos[labels] * 0.7
                     + rng.rand(n, self.IMG, self.IMG, 3) * 0.3)
                    * 255).astype(np.uint8)
        feats = imgs.astype(np.float32) / 255.0
        onehot = np.eye(num_classes, dtype=np.float32)[labels]
        super().__init__(feats, onehot, batch=batch, shuffle=shuffle,
                         seed=seed)

    def _read_disk(self, d: str, train: bool, num_classes: int,
                   per_class: Optional[int] = None):
        try:
            from PIL import Image  # optional; not baked in every image
        except ImportError:
            import warnings
            warnings.warn(
                f"tiny-imagenet-200 found at {d} but PIL is not "
                "installed — falling back to SYNTHETIC data "
                "(.synthetic=True)", RuntimeWarning)
            return None, None
        wnids = sorted(os.listdir(os.path.join(d, "train")))[:num_classes]
        cls = {w: i for i, w in enumerate(wnids)}
        imgs, labels = [], []
        if train:
            for w in wnids:
                img_dir = os.path.join(d, "train", w, "images")
                files = sorted(os.listdir(img_dir))
                if per_class is not None:
                    files = files[:per_class]
                for f in files:
                    with Image.open(os.path.join(img_dir, f)) as im:
                        imgs.append(np.asarray(im.convert("RGB"), np.uint8))
                    labels.append(cls[w])
        else:
            # cap decodes here too (val order is not class-sorted, so a
            # simple count bound keeps the sample representative)
            limit = per_class * num_classes if per_class else None
            ann = os.path.join(d, "val", "val_annotations.txt")
            with open(ann) as fh:
                for line in fh:
                    if limit is not None and len(imgs) >= limit:
                        break
                    parts = line.split("\t")
                    if len(parts) < 2 or parts[1] not in cls:
                        continue
                    with Image.open(os.path.join(
                            d, "val", "images", parts[0])) as im:
                        imgs.append(np.asarray(im.convert("RGB"), np.uint8))
                    labels.append(cls[parts[1]])
        if not imgs:
            return None, None
        return np.stack(imgs), np.asarray(labels)
