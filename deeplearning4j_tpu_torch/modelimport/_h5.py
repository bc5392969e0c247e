"""A read-only HDF5 reader for the subset Keras's legacy ``.h5`` files
are written in, so the importer needs no ``h5py``.

That subset is the file format h5py writes at its default, earliest
library version: a version-0 superblock, version-1 object headers with
their continuation blocks, groups held as a symbol table (a version-1
B-tree of ``SNOD`` nodes over a local heap), version-1 attribute
messages, version-1 (simple and scalar) dataspaces, version-3 data
layouts (contiguous or compact), and these datatypes: IEEE f16/f32/f64
and integers in either byte order, fixed-length strings and
variable-length strings through the global heap.

Anything else raises ``NotImplementedError`` naming the feature (a
superblock or object header of a later version, a link message, a
soft link, a chunked layout, a filter pipeline, a shared message, a
compound type ...): the reader never returns partial data.

The surface is the part of ``h5py`` that ``modelimport/keras.py``
uses: ``File(path)`` (a context manager), ``attrs`` (a mapping with
``get``), ``group[path]`` with ``/``-separated paths, ``keys()``,
``in``, ``visititems(fn)`` (depth first, names in byte order, each
object once, as ``h5py`` walks) and datasets read to ``np.ndarray``
(``ds[()]``, ``np.asarray(ds)``). Attribute values take ``h5py``'s
types: a variable-length string is a ``str`` (an array of them an
object array of ``str``), a fixed-length one ``np.bytes_``; a dataset
of variable-length strings reads as an object array of ``bytes``.

Format: the HDF5 File Format Specification, version 3.0.
"""
from __future__ import annotations

import mmap
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"

# the object header message types the reader acts on (the others, such
# as fill values and modification times, carry nothing it needs)
_DATASPACE, _DATATYPE, _EXTERNAL, _LAYOUT = 0x01, 0x03, 0x07, 0x08
_FILTERS, _ATTRIBUTE, _CONTINUATION, _SYMBOL_TABLE = 0x0B, 0x0C, 0x10, 0x11
# the messages of later-format groups and attributes, which the reader
# refuses wherever they appear
_REFUSED = {0x02: "link info", 0x06: "link", 0x15: "attribute info"}

_DATATYPE_CLASSES = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound",
                     7: "reference", 8: "enum", 10: "array"}

# IEEE layouts: size -> (mantissa size, exponent size, exponent bias)
_IEEE = {2: (10, 5, 15), 4: (23, 8, 127), 8: (52, 11, 1023)}


class _Type:
    """A parsed datatype: a numpy dtype, or a variable-length string
    (``vlen_str``, ``utf8``) whose elements live in the global heap."""

    def __init__(self, dtype: np.dtype, size: int, vlen_str: bool = False,
                 utf8: bool = False):
        self.dtype = dtype
        self.size = size
        self.vlen_str = vlen_str
        self.utf8 = utf8


class _Reader:
    """Little-endian field reads over the mapped file, with the
    superblock's offset and length sizes."""

    def __init__(self, buf):
        self.buf = buf
        self.offset_size = 8
        self.length_size = 8
        self._gheaps: Dict[int, Dict[int, bytes]] = {}

    def bytes(self, pos: int, n: int) -> bytes:
        if pos < 0 or pos + n > len(self.buf):
            raise ValueError(f"HDF5 read past the end of the file "
                             f"({pos}+{n} > {len(self.buf)})")
        return self.buf[pos:pos + n]

    def uint(self, pos: int, n: int) -> int:
        return int.from_bytes(self.bytes(pos, n), "little")

    def addr(self, pos: int) -> int:
        return self.uint(pos, self.offset_size)

    def length(self, pos: int) -> int:
        return self.uint(pos, self.length_size)

    def undefined(self, a: int) -> bool:
        return a == (1 << (8 * self.offset_size)) - 1

    # -- global heap ---------------------------------------------------
    def gheap_object(self, collection: int, index: int) -> bytes:
        objs = self._gheaps.get(collection)
        if objs is None:
            objs = self._read_gheap(collection)
            self._gheaps[collection] = objs
        if index not in objs:
            raise ValueError(f"HDF5 global heap at {collection} has no "
                             f"object {index}")
        return objs[index]

    def _read_gheap(self, at: int) -> Dict[int, bytes]:
        if self.bytes(at, 4) != b"GCOL":
            raise ValueError(f"no global heap collection at {at}")
        size = self.length(at + 8)
        end = at + size
        pos = at + 8 + self.length_size
        objs: Dict[int, bytes] = {}
        while pos + 8 + self.length_size <= end:
            index = self.uint(pos, 2)
            n = self.length(pos + 8)
            if index == 0:  # free space: the rest of the collection
                break
            data_at = pos + 8 + self.length_size
            objs[index] = self.bytes(data_at, n)
            pos = data_at + ((n + 7) & ~7)
        return objs


def _datatype(r: _Reader, pos: int) -> _Type:
    """Parse a datatype message at ``pos``."""
    b0 = r.uint(pos, 1)
    cls, bits, size = b0 & 0x0F, r.uint(pos + 1, 3), r.uint(pos + 4, 4)
    props = pos + 8
    if cls == 0:  # fixed-point
        order = ">" if bits & 1 else "<"
        offset, precision = r.uint(props, 2), r.uint(props + 2, 2)
        if offset != 0 or precision != 8 * size or size not in (1, 2, 4, 8):
            raise NotImplementedError(
                f"HDF5 integer of {precision} bits at offset {offset} "
                f"in {size} bytes")
        kind = "i" if bits & 0x08 else "u"
        return _Type(np.dtype(f"{order}{kind}{size}"), size)
    if cls == 1:  # floating point
        if bits & 0x40:
            raise NotImplementedError("HDF5 float in VAX byte order")
        order = ">" if bits & 1 else "<"
        offset, precision = r.uint(props, 2), r.uint(props + 2, 2)
        layout = (r.uint(props + 7, 1), r.uint(props + 5, 1),
                  r.uint(props + 8, 4))
        if (size not in _IEEE or offset != 0 or precision != 8 * size
                or layout != _IEEE[size]):
            raise NotImplementedError(
                f"HDF5 non-IEEE float (size {size}, precision "
                f"{precision}, mantissa/exponent/bias {layout})")
        return _Type(np.dtype(f"{order}f{size}"), size)
    if cls == 3:  # fixed-length string
        return _Type(np.dtype(f"S{size}"), size)
    if cls == 9:  # variable-length
        if bits & 0x0F != 1:
            raise NotImplementedError("HDF5 variable-length sequence")
        return _Type(np.dtype(object), size, vlen_str=True,
                     utf8=(bits >> 8) & 0x0F == 1)
    raise NotImplementedError(
        f"HDF5 {_DATATYPE_CLASSES.get(cls, f'class {cls}')} datatype")


def _dataspace(r: _Reader, pos: int) -> Tuple[int, ...]:
    """Parse a dataspace message: the shape (``()`` for a scalar)."""
    version, rank, flags = r.uint(pos, 1), r.uint(pos + 1, 1), \
        r.uint(pos + 2, 1)
    if version != 1:
        raise NotImplementedError(f"HDF5 dataspace version {version}")
    if flags & 0x02:
        raise NotImplementedError("HDF5 dataspace permutation")
    return tuple(r.length(pos + 8 + i * r.length_size) for i in range(rank))


def _decode(r: _Reader, raw: bytes, t: _Type, shape: Tuple[int, ...],
            as_str: bool):
    """Elements of ``shape`` from their stored bytes: a numpy array,
    or for variable-length strings an object array of ``str``
    (``as_str``, attributes) or ``bytes`` (datasets)."""
    n = int(np.prod(shape, dtype=np.int64))
    if not t.vlen_str:
        return np.frombuffer(raw, t.dtype, count=n).reshape(shape).copy()
    out = np.empty(n, dtype=object)
    step = 4 + r.offset_size + 4
    for i in range(n):
        at = i * step
        length = int.from_bytes(raw[at:at + 4], "little")
        coll = int.from_bytes(raw[at + 4:at + 4 + r.offset_size], "little")
        index = int.from_bytes(raw[at + 4 + r.offset_size:at + step],
                               "little")
        data = (b"" if length == 0 and coll == 0
                else r.gheap_object(coll, index)[:length])
        out[i] = data.decode("utf-8" if t.utf8 else "ascii") \
            if as_str else data
    return out.reshape(shape)


def _attribute(r: _Reader, pos: int) -> Tuple[str, object]:
    """Parse an attribute message: (name, value)."""
    version = r.uint(pos, 1)
    if version != 1:
        raise NotImplementedError(f"HDF5 attribute version {version}")
    name_size, type_size, space_size = (r.uint(pos + 2, 2),
                                        r.uint(pos + 4, 2),
                                        r.uint(pos + 6, 2))

    def pad(n):
        return (n + 7) & ~7
    at = pos + 8
    name = r.bytes(at, name_size).split(b"\0", 1)[0].decode("utf-8")
    at += pad(name_size)
    t = _datatype(r, at)
    at += pad(type_size)
    shape = _dataspace(r, at)
    at += pad(space_size)
    n = int(np.prod(shape, dtype=np.int64))
    value = _decode(r, r.bytes(at, n * t.size), t, shape, as_str=True)
    if shape == ():
        value = value[()]
        if t.vlen_str:
            return name, value
        return name, value if isinstance(value, np.generic) \
            else t.dtype.type(value)
    return name, value


def _messages(r: _Reader, at: int) -> List[Tuple[int, int, int]]:
    """Every message of the object header at ``at``, continuation
    blocks followed: (type, position of the data, size)."""
    out: List[Tuple[int, int, int]] = []
    if r.bytes(at, 4) == b"OHDR":
        raise NotImplementedError("HDF5 object header version 2")
    version = r.uint(at, 1)
    if version != 1:
        raise NotImplementedError(f"HDF5 object header version {version}")
    count = r.uint(at + 2, 2)
    blocks = [(at + 16, r.uint(at + 8, 4))]
    while blocks and len(out) < count:
        pos, size = blocks.pop(0)
        end = pos + size
        while pos + 8 <= end and len(out) < count:
            mtype, msize, mflags = (r.uint(pos, 2), r.uint(pos + 2, 2),
                                    r.uint(pos + 4, 1))
            data = pos + 8
            if mflags & 0x02:
                raise NotImplementedError("HDF5 shared object header "
                                          "message")
            if mtype in _REFUSED:
                raise NotImplementedError(f"HDF5 {_REFUSED[mtype]} message")
            if mtype == _CONTINUATION:
                blocks.append((r.addr(data), r.length(data + r.offset_size)))
            out.append((mtype, data, msize))
            pos = data + msize
    return out


class _Object:
    """An object header's parsed messages, shared by groups and
    datasets."""

    def __init__(self, r: _Reader, addr: int, name: str):
        self._r = r
        self._addr = addr
        self.name = name
        self._msgs = _messages(r, addr)
        self._attrs: Optional[Dict[str, object]] = None

    def _find(self, mtype: int) -> Optional[int]:
        for t, pos, _ in self._msgs:
            if t == mtype:
                return pos
        return None

    @property
    def attrs(self) -> "Attributes":
        if self._attrs is None:
            attrs: Dict[str, object] = {}
            for t, pos, _ in self._msgs:
                if t == _ATTRIBUTE:
                    k, v = _attribute(self._r, pos)
                    attrs[k] = v
            self._attrs = dict(sorted(attrs.items(),
                                      key=lambda kv: kv[0].encode()))
        return Attributes(self._attrs)


class Attributes(dict):
    """An object's attributes by name, in byte order as ``h5py`` lists
    them (a ``dict``: ``get``, ``in``, ``items`` ...)."""


class Dataset(_Object):
    """A dataset: ``shape``, ``dtype`` and its values (``ds[()]``)."""

    def __init__(self, r: _Reader, addr: int, name: str):
        super().__init__(r, addr, name)
        for t, _, _ in self._msgs:
            if t == _FILTERS:
                raise NotImplementedError(
                    f"HDF5 filter pipeline (compression) on {name!r}")
            if t == _EXTERNAL:
                raise NotImplementedError(
                    f"HDF5 external storage on {name!r}")
        self._type = _datatype(r, self._find(_DATATYPE))
        self.shape = _dataspace(r, self._find(_DATASPACE))
        self.dtype = self._type.dtype
        self._storage = self._layout(self._find(_LAYOUT))

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    def _layout(self, pos: Optional[int]):
        """(address, compact bytes) of the data: one of them is set."""
        r = self._r
        if pos is None:
            raise ValueError(f"dataset {self.name!r} has no layout message")
        version = r.uint(pos, 1)
        if version != 3:
            raise NotImplementedError(f"HDF5 layout version {version}")
        cls = r.uint(pos + 1, 1)
        at = pos + 2
        if cls == 0:
            return None, r.bytes(at + 2, r.uint(at, 2))
        if cls == 2:
            raise NotImplementedError(
                f"HDF5 chunked layout on {self.name!r}")
        if cls != 1:
            raise NotImplementedError(
                f"HDF5 layout class {cls} on {self.name!r}")
        return r.addr(at), None

    def _raw(self) -> bytes:
        n = self.size * self._type.size
        addr, compact = self._storage
        if compact is not None:
            return compact[:n]
        if n == 0:
            return b""
        if self._r.undefined(addr):
            raise NotImplementedError(
                f"HDF5 dataset {self.name!r} with unallocated storage "
                "(fill value)")
        return self._r.bytes(addr, n)

    def read(self) -> np.ndarray:
        return _decode(self._r, self._raw(), self._type, self.shape,
                       as_str=False)

    def __getitem__(self, key):
        """``ds[()]`` is every value (a numpy scalar for a scalar
        dataset, as in ``h5py``); other keys index the read array."""
        return self.read()[key]

    def __array__(self, dtype=None, copy=None):
        a = self.read()
        return a if dtype is None else a.astype(dtype)


class Group(_Object):
    """A group: members by name, in byte order."""

    def __init__(self, r: _Reader, addr: int, name: str):
        super().__init__(r, addr, name)
        self._links: Optional[Dict[str, int]] = None

    def _members(self) -> Dict[str, int]:
        if self._links is None:
            links: Dict[str, int] = {}
            for t, pos, _ in self._msgs:
                if t == _SYMBOL_TABLE:
                    _symbol_table(self._r, self._r.addr(pos),
                                  self._r.addr(pos + self._r.offset_size),
                                  links)
            self._links = dict(sorted(links.items(),
                                      key=lambda kv: kv[0].encode()))
        return self._links

    def keys(self) -> List[str]:
        return list(self._members())

    def __contains__(self, path: str) -> bool:
        try:
            self._resolve(path)
        except KeyError:
            return False
        return True

    def _child(self, name: str):
        addr = self._members().get(name)
        if addr is None:
            raise KeyError(f"{name!r} is not in group {self.name!r}")
        full = f"{self.name.rstrip('/')}/{name}"
        return _open(self._r, addr, full)

    def _resolve(self, path: str):
        obj = self
        for part in (p for p in path.split("/") if p):
            if not isinstance(obj, Group):
                raise KeyError(f"{obj.name!r} is a dataset, not a group")
            obj = obj._child(part)
        return obj

    def __getitem__(self, path: str):
        return self._resolve(path)

    def visititems(self, fn: Callable[[str, object], Optional[object]]):
        """Call ``fn(relative_name, obj)`` for every object below this
        group, depth first, names in byte order, each object once;
        stop at the first call that returns something other than
        None, and return it."""
        seen = {self._addr}

        def walk(group: Group, prefix: str):
            for name, addr in group._members().items():
                if addr in seen:
                    continue
                seen.add(addr)
                rel = f"{prefix}{name}"
                obj = group._child(name)
                ret = fn(rel, obj)
                if ret is not None:
                    return ret
                if isinstance(obj, Group):
                    ret = walk(obj, rel + "/")
                    if ret is not None:
                        return ret
            return None
        return walk(self, "")


def _open(r: _Reader, addr: int, name: str):
    msgs = {t for t, _, _ in _messages(r, addr)}
    if _SYMBOL_TABLE in msgs:
        return Group(r, addr, name)
    if _LAYOUT in msgs:
        return Dataset(r, addr, name)
    if _DATATYPE in msgs:
        raise NotImplementedError(f"HDF5 committed datatype {name!r}")
    raise NotImplementedError(f"HDF5 object {name!r} that is neither a "
                              "symbol-table group nor a dataset")


def _symbol_table(r: _Reader, btree: int, heap: int,
                  links: Dict[str, int]) -> None:
    """Collect (name -> object header address) of a symbol-table group:
    walk the version-1 B-tree down to its SNOD leaves; names come from
    the local heap."""
    if r.bytes(heap, 4) != b"HEAP":
        raise ValueError(f"no local heap at {heap}")
    data = r.addr(heap + 8 + 2 * r.length_size)

    def name_at(off: int) -> str:
        end = r.buf.find(b"\0", data + off)
        return r.bytes(data + off, end - data - off).decode("utf-8")

    def node(at: int):
        if r.bytes(at, 4) != b"TREE":
            raise ValueError(f"no B-tree node at {at}")
        ntype, level, used = (r.uint(at + 4, 1), r.uint(at + 5, 1),
                              r.uint(at + 6, 2))
        if ntype != 0:
            raise ValueError(f"B-tree node at {at} is not a group node")
        pos = at + 8 + 2 * r.offset_size + r.length_size  # past key 0
        for _ in range(used):
            child = r.addr(pos)
            if level > 0:
                node(child)
            else:
                leaf(child)
            pos += r.offset_size + r.length_size

    def leaf(at: int):
        if r.bytes(at, 4) != b"SNOD":
            raise ValueError(f"no symbol table node at {at}")
        count = r.uint(at + 6, 2)
        entry = 2 * r.offset_size + 24
        for i in range(count):
            e = at + 8 + i * entry
            name = name_at(r.addr(e))
            if r.uint(e + 2 * r.offset_size, 4) == 2:  # cache type
                raise NotImplementedError(f"HDF5 soft link {name!r}")
            links[name] = r.addr(e + r.offset_size)

    node(btree)


class File(Group):
    """An HDF5 file opened read-only; the root group. Close it (or use
    it in a ``with``) to release the mapping; arrays read from it are
    copies and stay valid."""

    def __init__(self, path: str, mode: str = "r"):
        if mode != "r":
            raise ValueError(f"the HDF5 reader only reads (mode {mode!r})")
        self.filename = str(path)
        self._fh = open(path, "rb")
        try:
            self._mm = mmap.mmap(self._fh.fileno(), 0,
                                 access=mmap.ACCESS_READ)
            r = _Reader(self._mm)
            super().__init__(r, _superblock(r), "/")
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        mm = getattr(self, "_mm", None)
        if mm is not None:
            mm.close()
            self._mm = None
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _superblock(r: _Reader) -> int:
    """Find and parse the superblock; returns the root group's object
    header address. The superblock sits at 0 or a power of two from
    512 on (after a user block)."""
    at = 0
    while r.bytes(at, 8) != _SIGNATURE:
        at = 512 if at == 0 else at * 2
        if at + 8 > len(r.buf):
            raise ValueError("not an HDF5 file (no superblock signature)")
    version = r.uint(at + 8, 1)
    if version != 0:
        raise NotImplementedError(f"HDF5 superblock version {version}")
    r.offset_size, r.length_size = r.uint(at + 13, 1), r.uint(at + 14, 1)
    pos = at + 24
    base = r.addr(pos)
    root_entry = pos + 4 * r.offset_size
    root = r.addr(root_entry + r.offset_size)
    if base != 0:
        raise NotImplementedError(f"HDF5 base address {base}")
    return root
