"""The port's HDF5 reader (``modelimport/_h5.py``) against ``h5py``.

On every committed Keras fixture (the eight ``tests/fixtures/keras_*.h5``
and the port's MobileNetV2 file) the reader gives what ``h5py`` gives:
every group's members in the same order, every attribute's name, type
and value, every dataset's dtype, shape and bytes, and the same
``visititems`` walk. Files written here by ``h5py`` at its default,
earliest library version cover the rest of the subset (both byte
orders, every integer and float width, fixed and variable-length
strings, compact storage, many-member groups, continuation blocks) and
the refusals: a chunked or compressed dataset, an enum or a compound
type, a soft link, a later superblock (``libver`` v108 or latest) and a
version-2 object header (a group that tracks creation order) raise
``NotImplementedError`` naming the feature."""
import glob
import os

import numpy as np
import pytest

from deeplearning4j_tpu_torch.modelimport import _h5

h5py = pytest.importorskip("h5py")

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = sorted(glob.glob(os.path.join(HERE, "fixtures", "keras_*.h5")))
MOBILENET = os.path.join(HERE, "..", "deeplearning4j_tpu_torch",
                         "modelimport", "fixtures",
                         "keras_mobilenet_v2_224.h5")


def _same_value(want, got):
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray)
        assert got.dtype == want.dtype and got.shape == want.shape
        if want.dtype == object:
            assert [type(v) for v in got.ravel()] == \
                [type(v) for v in want.ravel()]
            assert got.tolist() == want.tolist()
        else:
            assert got.tobytes() == want.tobytes()
    else:
        assert type(got) is type(want), (type(got), type(want))
        assert got == want


def _same_attrs(want, got):
    assert list(got.keys()) == list(want.keys())
    for k in want.keys():
        _same_value(want[k], got[k])


def _walk(f, ours: bool):
    out = []
    ds = _h5.Dataset if ours else h5py.Dataset
    f.visititems(lambda name, obj: out.append(
        (name, "D" if isinstance(obj, ds) else "G")))
    return out


def _compare(path):
    with h5py.File(path, "r") as want, _h5.File(path) as got:
        _same_attrs(want.attrs, got.attrs)
        walk = _walk(want, False)
        assert _walk(got, True) == walk
        assert list(got.keys()) == list(want.keys())
        for name, kind in walk:
            w, g = want[name], got[name]
            _same_attrs(w.attrs, g.attrs)
            if kind == "G":
                assert list(g.keys()) == list(w.keys())
                continue
            assert g.shape == w.shape and g.dtype == w.dtype
            _same_value(w[()], g[()])
            _same_value(np.asarray(w), np.asarray(g))
        return len(walk)


@pytest.mark.parametrize("path", FIXTURES + [MOBILENET],
                         ids=lambda p: os.path.basename(p))
def test_keras_fixture_reads_as_h5py_reads_it(path):
    assert _compare(path) > 0


def test_every_keras_fixture_is_listed():
    assert len(FIXTURES) == 8 and os.path.exists(MOBILENET)


def test_mobilenet_fixture_layout():
    """The file the card reads: 264 datasets, of which the 262 under
    ``model_weights`` hold the 3,538,984 weights (the other two are the
    optimizer's scalars), ``model_config`` and ``training_config`` as
    variable-length strings."""
    with _h5.File(MOBILENET) as f:
        assert isinstance(f.attrs["model_config"], str)
        assert len(f.attrs["model_config"]) > 100_000
        assert "Adam" in f.attrs["training_config"]
        n, every = [], []
        f["model_weights"].visititems(
            lambda name, o: n.append(o.size)
            if isinstance(o, _h5.Dataset) else None)
        f.visititems(lambda name, o: every.append(name)
                     if isinstance(o, _h5.Dataset) else None)
    assert len(n) == 262 and sum(n) == 3_538_984 and len(every) == 264


def test_types_and_layouts_written_here(tmp_path):
    path = str(tmp_path / "types.h5")
    rs = np.random.RandomState(0)
    with h5py.File(path, "w", libver="earliest") as f:
        for i, dt in enumerate(("<f2", ">f2", "<f4", ">f4", "<f8", ">f8",
                                "i1", "u1", "<i2", ">u2", "<i4", ">i4",
                                "<u8", ">i8")):
            a = (rs.standard_normal((3, 5)) * 100).astype(dt)
            f.require_group(f"n{i // 7}").create_dataset(
                f"d_{dt.replace('<', 'le').replace('>', 'be')}", data=a)
        g = f.create_group("g")
        g.create_dataset("scalar", data=np.float64(2.5))
        g.create_dataset("empty", data=np.zeros((0, 4), np.float32))
        g.create_dataset("fixed", data=np.array([b"ab", b"cde"], "S4"))
        g.create_dataset("vlen", data=["x", "héllo", ""],
                         dtype=h5py.string_dtype())
        g.attrs["s"] = "a vlen string"
        g.attrs["b"] = np.bytes_(b"fixed")
        g.attrs["f"] = np.float32(1.5)
        g.attrs["i"] = np.int64(-7)
        g.attrs["arr"] = np.arange(6, dtype=">i2").reshape(2, 3)
        g.attrs["names"] = np.array(["a", "bb", "ccc"],
                                    dtype=h5py.string_dtype())
        g.attrs["empty"] = np.zeros((0,), np.float64)
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        sid = h5py.h5s.create_simple((4, 2))
        did = h5py.h5d.create(g.id, b"compact", h5py.h5t.IEEE_F32LE, sid,
                              dcpl=dcpl)
        did.write(h5py.h5s.ALL, h5py.h5s.ALL,
                  np.arange(8, dtype=np.float32).reshape(4, 2))
        f.create_group("z/y/x").attrs["deep"] = 1
    assert _compare(path) == 25
    with _h5.File(path) as f:
        assert f["g/compact"][()].tolist() == [[0, 1], [2, 3], [4, 5],
                                               [6, 7]]
        assert f["g"]["vlen"][()].tolist() == [b"x", "héllo".encode(), b""]
        assert "z/y/x" in f and "z/q" not in f
        with pytest.raises(KeyError):
            f["missing"]


def test_many_members_and_attributes_written_here(tmp_path):
    """A symbol-table group of 600 members (a B-tree above its leaves)
    and an object header grown by continuation blocks."""
    path = str(tmp_path / "many.h5")
    with h5py.File(path, "w", libver="earliest") as f:
        g = f.create_group("many")
        for i in range(600):
            g.create_dataset(f"m{i:04d}_{(i * 7919) % 600}",
                             data=np.full(2, i, np.int32))
        for i in range(40):
            g.attrs[f"a{i}"] = np.arange(i + 1, dtype=np.float64)
    assert _compare(path) == 601


def _refuses(path, feature, reach=lambda f: f["x"]):
    with _h5.File(path) as f:
        with pytest.raises(NotImplementedError, match=feature):
            r = reach(f)
            r[()] if isinstance(r, _h5.Dataset) else r.attrs


@pytest.mark.parametrize("kind, feature", [
    ("chunked", "chunked layout"),
    ("gzip", "filter pipeline"),
    ("enum", "enum datatype"),
    ("compound", "compound datatype"),
])
def test_refused_datasets(tmp_path, kind, feature):
    path = str(tmp_path / f"{kind}.h5")
    with h5py.File(path, "w") as f:
        a = np.arange(64, dtype=np.float32).reshape(8, 8)
        if kind == "chunked":
            f.create_dataset("x", data=a, chunks=(4, 4))
        elif kind == "gzip":
            f.create_dataset("x", data=a, compression="gzip")
        elif kind == "enum":
            f.create_dataset("x", data=np.array([True, False]))
        else:
            f.create_dataset("x", data=np.zeros(3, [("a", "<f4"),
                                                    ("b", "<i4")]))
    _refuses(path, feature)


@pytest.mark.parametrize("kind, feature", [
    ("v108", "superblock version 2"),
    ("latest", "superblock version 3"),
    ("track_order", "object header version 2"),
    ("soft_link", "soft link"),
])
def test_refused_later_formats(tmp_path, kind, feature):
    path = str(tmp_path / f"{kind}.h5")
    libver = kind if kind in ("v108", "latest") else "earliest"
    with h5py.File(path, "w", libver=libver) as f:
        if kind == "track_order":
            f.create_group("x", track_order=True)
        elif kind == "soft_link":
            f.create_group("g")
            f["x"] = h5py.SoftLink("/g")
        else:
            f.create_dataset("x", data=np.arange(3.0))
    with pytest.raises(NotImplementedError, match=feature):
        with _h5.File(path) as f:
            f["x"].attrs


def test_not_an_hdf5_file(tmp_path):
    p = tmp_path / "plain.bin"
    p.write_bytes(b"\0" * 4096)
    with pytest.raises(ValueError, match="not an HDF5 file"):
        _h5.File(str(p))
    with pytest.raises(ValueError, match="only reads"):
        _h5.File(MOBILENET, "w")
