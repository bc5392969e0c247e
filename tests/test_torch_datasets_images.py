"""``Cifar10DataSetIterator`` and ``TinyImageNetDataSetIterator`` of the
port against the JAX package's for the same arguments: the arrays, the
labels, the batch order over two passes and ``.synthetic``. They run
on the synthetic sets, on a few records written to ``tmp_path`` in
CIFAR-10's binary format, and on a tiny ``tiny-imagenet-200`` tree of
PNGs (PIL is imported where the tree is written). ``data_dir`` is
passed explicitly (or ``DL4J_TPU_DATA_DIR``/``CIFAR10_DATA_DIR`` point
at ``tmp_path``), so nothing outside the test's directory is read by
the port."""
import os

import numpy as np
import pytest

import deeplearning4j_tpu.datasets as JD
import deeplearning4j_tpu_torch.datasets as TD


def _passes(it, n=2):
    """Every batch of ``n`` passes (a reset before each), as arrays."""
    out = []
    for _ in range(n):
        it.reset()
        while it.has_next():
            out.append(tuple(np.asarray(a) for a in it.next()))
    return out


def _same(jit, tit):
    assert tit.synthetic == jit.synthetic
    np.testing.assert_array_equal(tit.features, jit.features)
    np.testing.assert_array_equal(tit.labels, jit.labels)
    assert tit.features.dtype == jit.features.dtype == np.float32
    jb, tb = _passes(jit), _passes(tit)
    assert len(tb) == len(jb) > 0
    for a, b in zip(jb, tb):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            np.testing.assert_array_equal(v, u)


@pytest.fixture
def no_data_dirs(monkeypatch, tmp_path):
    """Point every data flag at an empty directory."""
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path / "none"))
    monkeypatch.setenv("CIFAR10_DATA_DIR", "")


@pytest.mark.parametrize("kw", [
    dict(batch=64, train=True, num_examples=512),
    dict(batch=50, train=False, shuffle=False, num_examples=300),
    dict(batch=32, train=True, seed=3, num_examples=200),
])
def test_cifar10_synthetic_matches_jax(no_data_dirs, kw):
    jit, tit = JD.Cifar10DataSetIterator(**kw), \
        TD.Cifar10DataSetIterator(**kw)
    assert tit.synthetic
    assert tit.features.shape == (kw["num_examples"], 32, 32, 3)
    _same(jit, tit)


def test_cifar10_synthetic_default_size(no_data_dirs):
    jit, tit = JD.Cifar10DataSetIterator(256, train=False), \
        TD.Cifar10DataSetIterator(256, train=False)
    assert tit.features.shape == (1024, 32, 32, 3)
    _same(jit, tit)


def _write_cifar(d, rs, per_file=20):
    """Records in CIFAR-10's binary layout: a label byte, then 3,072
    channel-major pixel bytes."""
    os.makedirs(d, exist_ok=True)
    names = [f"data_batch_{i}.bin" for i in range(1, 6)] + ["test_batch.bin"]
    for name in names:
        rec = np.concatenate(
            [rs.randint(0, 10, (per_file, 1)),
             rs.randint(0, 256, (per_file, 3072))], axis=1).astype(np.uint8)
        rec.tofile(os.path.join(d, name))


@pytest.mark.parametrize("train", [True, False])
def test_cifar10_binary_records_match_jax(tmp_path, train):
    d = str(tmp_path / "cifar10")
    _write_cifar(d, np.random.RandomState(5))
    kw = dict(batch=8, train=train, data_dir=d)
    jit, tit = JD.Cifar10DataSetIterator(**kw), \
        TD.Cifar10DataSetIterator(**kw)
    assert not tit.synthetic
    n = 100 if train else 20
    assert tit.features.shape == (n, 32, 32, 3)
    # channel-major bytes become NHWC: pixel (0, 0) of record 0
    raw = np.fromfile(os.path.join(
        d, "data_batch_1.bin" if train else "test_batch.bin"),
        np.uint8).reshape(-1, 3073)
    np.testing.assert_array_equal(
        tit.features[0, 0, 0] * 255.0,
        raw[0, [1, 1 + 1024, 1 + 2048]].astype(np.float32))
    _same(jit, tit)


def test_cifar10_found_through_the_flags(monkeypatch, tmp_path):
    """``$DL4J_TPU_DATA_DIR/cifar10`` and ``$CIFAR10_DATA_DIR`` are
    found as the JAX package finds them."""
    rs = np.random.RandomState(6)
    _write_cifar(str(tmp_path / "root" / "cifar10"), rs, per_file=4)
    _write_cifar(str(tmp_path / "own"), rs, per_file=6)
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path / "root"))
    monkeypatch.setenv("CIFAR10_DATA_DIR", "")
    assert TD._find_cifar10() == JD._find_cifar10() == \
        str(tmp_path / "root" / "cifar10")
    _same(JD.Cifar10DataSetIterator(4), TD.Cifar10DataSetIterator(4))
    monkeypatch.setenv("CIFAR10_DATA_DIR", str(tmp_path / "own"))
    assert TD._find_cifar10() == JD._find_cifar10() == str(tmp_path / "own")
    tit = TD.Cifar10DataSetIterator(4, num_examples=12)
    assert not tit.synthetic and tit.features.shape[0] == 12
    _same(JD.Cifar10DataSetIterator(4, num_examples=12), tit)


@pytest.mark.parametrize("kw", [
    dict(batch=32, train=True, num_examples=128, num_classes=10),
    dict(batch=16, train=False, shuffle=False, num_examples=48,
         num_classes=200),
])
def test_tiny_imagenet_synthetic_matches_jax(no_data_dirs, kw):
    jit, tit = JD.TinyImageNetDataSetIterator(**kw), \
        TD.TinyImageNetDataSetIterator(**kw)
    assert tit.synthetic
    assert tit.features.shape == (kw["num_examples"], 64, 64, 3)
    assert tit.labels.shape[1] == kw["num_classes"]
    _same(jit, tit)


def _write_tiny_imagenet(root, rs, wnids=("n01", "n02", "n03"), per=4):
    """A tiny ``tiny-imagenet-200`` tree: train/<wnid>/images/*.png and
    val/images with val_annotations.txt."""
    from PIL import Image
    for w in wnids:
        d = os.path.join(root, "train", w, "images")
        os.makedirs(d)
        for i in range(per):
            Image.fromarray(rs.randint(0, 256, (64, 64, 3)).astype(
                np.uint8)).save(os.path.join(d, f"{w}_{i}.png"))
    vd = os.path.join(root, "val", "images")
    os.makedirs(vd)
    with open(os.path.join(root, "val", "val_annotations.txt"), "w") as f:
        for i in range(7):
            name = f"val_{i}.png"
            Image.fromarray(rs.randint(0, 256, (64, 64, 3)).astype(
                np.uint8)).save(os.path.join(vd, name))
            f.write(f"{name}\t{wnids[i % len(wnids)]}\t0\t0\t63\t63\n")


@pytest.mark.parametrize("kw", [
    dict(batch=2, train=True, num_classes=3),
    dict(batch=2, train=True, num_classes=2, num_examples=4),
    dict(batch=3, train=False, num_classes=3),
    dict(batch=2, train=False, num_classes=3, num_examples=3),
])
def test_tiny_imagenet_disk_tree_matches_jax(tmp_path, kw):
    pytest.importorskip("PIL")
    root = str(tmp_path / "tiny-imagenet-200")
    _write_tiny_imagenet(root, np.random.RandomState(8))
    jit = JD.TinyImageNetDataSetIterator(data_dir=root, **kw)
    tit = TD.TinyImageNetDataSetIterator(data_dir=root, **kw)
    assert not tit.synthetic
    _same(jit, tit)


def test_tiny_imagenet_found_under_the_data_dir(monkeypatch, tmp_path):
    pytest.importorskip("PIL")
    _write_tiny_imagenet(str(tmp_path / "tiny-imagenet-200"),
                         np.random.RandomState(9), per=2)
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path))
    assert TD._find_tiny_imagenet() == JD._find_tiny_imagenet() == \
        str(tmp_path / "tiny-imagenet-200")
    kw = dict(batch=2, num_classes=3)
    _same(JD.TinyImageNetDataSetIterator(**kw),
          TD.TinyImageNetDataSetIterator(**kw))


def test_tiny_imagenet_without_pil_warns_and_goes_synthetic(
        monkeypatch, tmp_path):
    """A tree on disk but no PIL: both packages warn with the same words
    and build the synthetic set."""
    import builtins
    root = tmp_path / "tiny-imagenet-200"
    (root / "train" / "n01" / "images").mkdir(parents=True)
    real_import = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL")
        return real_import(name, *a, **k)
    monkeypatch.setattr(builtins, "__import__", no_pil)
    kw = dict(batch=4, num_examples=8, num_classes=5, data_dir=str(root))
    with pytest.warns(RuntimeWarning) as jw:
        jit = JD.TinyImageNetDataSetIterator(**kw)
    with pytest.warns(RuntimeWarning) as tw:
        tit = TD.TinyImageNetDataSetIterator(**kw)
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    assert "PIL is not installed" in str(tw[0].message)
    assert tit.synthetic and jit.synthetic
    _same(jit, tit)


def test_mnist_dirs_come_from_the_flags(monkeypatch, tmp_path):
    """``_mnist_dirs`` reads the flags registry: the same directories as
    the environment gives them."""
    monkeypatch.setenv("MNIST_DATA_DIR", str(tmp_path / "m"))
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path / "d"))
    assert TD._mnist_dirs() == [str(tmp_path / "m"),
                                str(tmp_path / "d" / "mnist"),
                                os.path.expanduser("~/.cache/mnist")]
    monkeypatch.delenv("MNIST_DATA_DIR")
    monkeypatch.delenv("DL4J_TPU_DATA_DIR")
    assert TD._mnist_dirs() == [
        "", os.path.join(os.path.expanduser("~/.deeplearning4j_tpu"),
                         "mnist"),
        os.path.expanduser("~/.cache/mnist")]


def test_flags_declare_what_the_port_reads(monkeypatch, tmp_path):
    """The port's registry declares the three flags ``datasets`` reads,
    each with the JAX registry's variable, default, parsing and doc."""
    from deeplearning4j_tpu.flags import flags as jflags
    from deeplearning4j_tpu_torch.flags import flags as tflags
    names = ["cifar10_dir", "data_dir", "mnist_dir"]
    assert sorted(tflags.as_dict()) == names
    monkeypatch.setenv("CIFAR10_DATA_DIR", str(tmp_path))
    for attr in names:
        t, j = tflags._flags[attr], jflags._flags[attr]
        assert (t.name, t.default, t.parse, t.doc) == \
            (j.name, j.default, j.parse, j.doc)
        assert getattr(tflags, attr) == getattr(jflags, attr)
    assert tflags.cifar10_dir == str(tmp_path)
    assert tflags.describe().count("(flags.") == 3
