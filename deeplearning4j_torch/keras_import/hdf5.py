"""A read-only reader of the corner of HDF5 that Keras model files use.

The JAX package opens Keras files through h5py; this reader takes its place,
so Keras import needs nothing beyond numpy. It reads what h5py writes for a
Keras 2 model file with the library's default (earliest) format:

- superblock versions 0 and 1;
- version-1 object headers, with continuation blocks;
- symbol-table groups: the version-1 B-tree of group nodes, its symbol
  table nodes (SNOD) and the local heap of link names;
- the dataspace (scalar or simple), datatype, fill value, data layout
  (version 3: contiguous, or compact), attribute and symbol-table messages;
- fixed-point and IEEE floating-point data in either byte order, fixed-length
  strings and variable-length strings (through the global heap), scalar and
  in arrays;
- an empty contiguous dataset (no storage allocated: its fill value).

Anything else raises `UnsupportedKerasConfigurationException` naming the
feature it met: chunked or filtered (compressed) layouts, superblock
versions 2 and 3, version-2 object headers, new-style groups (link
messages, external links among them), soft links, dense attribute storage
and shared messages.

The surface is a small mapping, as h5py's: ``File(path)``, groups with
``in``, ``[]`` (paths with ``/``), ``keys()``, ``attrs`` and ``name``, and
datasets with ``shape``, ``dtype``, ``[()]`` and ``np.asarray``. Attribute
values come back as h5py gives them: a numpy scalar or array, ``str`` (or an
object array of ``str``) for variable-length strings, ``bytes``-typed numpy
values for fixed-length ones.
"""
from __future__ import annotations

import mmap
from collections.abc import Mapping
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"

# object header message types
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL = 0x0, 0x1, 0x2, 0x3, 0x4, 0x5
_LINK, _LAYOUT, _FILTERS, _ATTRIBUTE = 0x6, 0x8, 0xB, 0xC
_CONTINUATION, _SYMBOL_TABLE, _ATTRIBUTE_INFO = 0x10, 0x11, 0x15

_TYPE_CLASSES = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound",
                 7: "reference", 8: "enumeration", 10: "array"}
_FILTER_NAMES = {1: "deflate (gzip)", 2: "shuffle", 3: "fletcher32", 4: "szip",
                 5: "nbit", 6: "scaleoffset"}


def _refuse(what: str):
    from .reader import UnsupportedKerasConfigurationException
    raise UnsupportedKerasConfigurationException(
        f"HDF5 feature outside the Keras reader's corner: {what}")


def _align8(n: int) -> int:
    return (n + 7) & ~7


class _VlenString:
    """A variable-length string type: each element is a length, a global
    heap collection's address and an object's index in it (the text UTF-8,
    of which ASCII is a part)."""


class File:
    """An HDF5 file opened for reading; the root group's surface."""

    def __init__(self, path: str, mode: str = "r"):
        if mode != "r":
            raise ValueError("the HDF5 reader opens files read-only")
        self.filename = str(path)
        self._fh = open(path, "rb")
        try:
            self._m = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError:  # an empty file cannot be mapped
            self._fh.close()
            raise OSError(f"{path!r} is not an HDF5 file (empty)") from None
        self._heaps: Dict[int, Dict[int, Tuple[int, int]]] = {}
        try:
            self._root = self._object(self._superblock(), "/")
        except BaseException:
            self.close()
            raise

    # ------------------------------------------------------------ raw bytes
    def _u(self, pos: int, n: int) -> int:
        return int.from_bytes(self._m[pos:pos + n], "little")

    def _addr(self, pos: int) -> Optional[int]:
        """An address field at `pos`, relative to the base address; None
        where it is undefined (all bits set)."""
        a = self._u(pos, self._so)
        return None if a == (1 << (8 * self._so)) - 1 else self._base + a

    def _superblock(self) -> int:
        """Parse the superblock (at 0 or after a user block of 512 * 2^i
        bytes) and return the root group's object header address."""
        base = 0
        while self._m[base:base + 8] != SIGNATURE:
            base = 512 if base == 0 else 2 * base
            if base + 8 > len(self._m):
                raise OSError(f"{self.filename!r} is not an HDF5 file")
        version = self._m[base + 8]
        if version not in (0, 1):
            _refuse(f"superblock version {version} (a file written with "
                    "libver='latest' or 'v108' and later)")
        self._so, self._sl = self._m[base + 13], self._m[base + 14]
        pos = base + 24 + (4 if version == 1 else 0)
        self._base = self._u(pos, self._so)
        root_entry = pos + 4 * self._so
        return self._addr(root_entry + self._so)

    # -------------------------------------------------------- object header
    def _messages(self, addr: int) -> List[Tuple[int, int, int]]:
        """(type, body offset, body size) of every message of the version-1
        object header at `addr`, continuation blocks followed."""
        if self._m[addr:addr + 4] == b"OHDR":
            _refuse("version 2 object header")
        if self._m[addr] != 1:
            _refuse(f"object header version {self._m[addr]}")
        blocks = [(addr + 16, self._u(addr + 8, 4))]
        out = []
        while blocks:
            start, size = blocks.pop(0)
            pos, end = start, start + size
            while pos + 8 <= end:
                mtype, msize = self._u(pos, 2), self._u(pos + 2, 2)
                flags, body = self._m[pos + 4], pos + 8
                if flags & 0x02:
                    _refuse(f"shared object header message (type {mtype:#x})")
                if mtype == _CONTINUATION:
                    blocks.append((self._addr(body), self._u(body + self._so,
                                                             self._sl)))
                elif mtype != _NIL:
                    out.append((mtype, body, msize))
                pos = body + msize
        return out

    def _object(self, addr: int, name: str):
        msgs = self._messages(addr)
        types = {t for t, _, _ in msgs}
        if _LINK_INFO in types or _LINK in types:
            _refuse(f"link messages at {name!r} (a new-style group, as "
                    "external links and libver='latest' make)")
        if _SYMBOL_TABLE in types:
            return _Group(self, addr, name, msgs)
        if _LAYOUT in types:
            return Dataset(self, addr, name, msgs)
        _refuse(f"object at {name!r} is neither a symbol-table group nor a "
                "dataset")

    # ------------------------------------------------------------- messages
    def _dataspace(self, b: int) -> Tuple[int, ...]:
        version, rank = self._m[b], self._m[b + 1]
        if version == 1:
            pos = b + 8
        elif version == 2:
            if self._m[b + 3] == 2:
                _refuse("null dataspace")
            pos = b + 4
        else:
            _refuse(f"dataspace message version {version}")
        return tuple(self._u(pos + i * self._sl, self._sl) for i in range(rank))

    def _datatype(self, b: int):
        """(numpy dtype or _VlenString, bytes the message takes)."""
        cls = self._m[b] & 0x0F
        bits = self._u(b + 1, 3)
        size = self._u(b + 4, 4)
        order = ">" if bits & 0x01 else "<"
        if cls == 0:  # fixed-point
            offset, precision = self._u(b + 8, 2), self._u(b + 10, 2)
            if size not in (1, 2, 4, 8) or offset or precision != 8 * size:
                _refuse(f"fixed-point type of {size} bytes, precision "
                        f"{precision} at bit {offset}")
            kind = "i" if bits & 0x08 else "u"
            return np.dtype(f"{order}{kind}{size}"), 12
        if cls == 1:  # IEEE floating point
            precision = self._u(b + 10, 2)
            if bits & 0x40 or size not in (2, 4, 8) or precision != 8 * size:
                _refuse(f"floating-point type of {size} bytes, precision "
                        f"{precision}, byte-order bits {bits & 0x41:#x}")
            return np.dtype(f"{order}f{size}"), 20
        if cls == 3:  # fixed-length string
            return np.dtype(f"S{size}"), 8
        if cls == 9:  # variable length
            if bits & 0x0F != 1:
                _refuse("variable-length sequence (not a string)")
            _, base = self._datatype(b + 8)
            return _VlenString(), 8 + base
        _refuse(f"{_TYPE_CLASSES.get(cls, f'class {cls}')} datatype")

    def _global_heap(self, addr: int) -> Dict[int, Tuple[int, int]]:
        heap = self._heaps.get(addr)
        if heap is None:
            if self._m[addr:addr + 4] != b"GCOL":
                raise OSError(f"no global heap collection at {addr}")
            heap, pos = {}, addr + 8 + self._sl
            end = addr + self._u(addr + 8, self._sl)
            while pos + 8 + self._sl <= end:
                index = self._u(pos, 2)
                if index == 0:  # the collection's free space
                    break
                size = self._u(pos + 8, self._sl)
                heap[index] = (pos + 8 + self._sl, size)
                pos += 8 + self._sl + _align8(size)
            self._heaps[addr] = heap
        return heap

    def _values(self, pos: int, dtype, shape: Tuple[int, ...], strings: type):
        """`shape` elements of `dtype` stored from `pos`, as a numpy array;
        variable-length strings decoded to `strings` (str or bytes)."""
        count = int(np.prod(shape, dtype=np.int64))
        if not isinstance(dtype, _VlenString):
            return np.frombuffer(self._m, dtype, count, pos).reshape(shape).copy()
        step = 8 + self._so
        out = np.empty(count, dtype=object)
        for i in range(count):
            e = pos + i * step
            length, coll = self._u(e, 4), self._addr(e + 4)
            if coll is None or length == 0:
                raw = b""
            else:
                start, _ = self._global_heap(coll)[self._u(e + 4 + self._so, 4)]
                raw = bytes(self._m[start:start + length])
            out[i] = raw.decode("utf-8") if strings is str else raw
        return out.reshape(shape)

    def _attributes(self, msgs) -> Dict[str, Tuple[int, object, Tuple[int, ...]]]:
        """name -> (data offset, type, shape) of each attribute message."""
        out = {}
        for mtype, b, _ in msgs:
            if mtype == _ATTRIBUTE_INFO:
                flags = self._m[b + 1]
                if self._addr(b + 2 + (2 if flags & 0x01 else 0)) is not None:
                    _refuse("dense attribute storage")
            if mtype != _ATTRIBUTE:
                continue
            version = self._m[b]
            name_size, type_size, space_size = (self._u(b + 2, 2), self._u(b + 4, 2),
                                                self._u(b + 6, 2))
            if version == 1:
                pad, pos = _align8, b + 8
            elif version in (2, 3):
                if self._m[b + 1] & 0x03:
                    _refuse("shared attribute datatype or dataspace")
                pad, pos = (lambda n: n), b + 8 + (1 if version == 3 else 0)
            else:
                _refuse(f"attribute message version {version}")
            name = bytes(self._m[pos:pos + name_size - 1]).decode("utf-8")
            pos += pad(name_size)
            dtype, _ = self._datatype(pos)
            pos += pad(type_size)
            shape = self._dataspace(pos)
            out[name] = (pos + pad(space_size), dtype, shape)
        return out

    # --------------------------------------------------------------- groups
    def _local_heap_name(self, heap: int, offset: int) -> str:
        if self._m[heap:heap + 4] != b"HEAP":
            raise OSError(f"no local heap at {heap}")
        start = self._addr(heap + 8 + 2 * self._sl) + offset
        end = self._m.find(b"\x00", start)
        return bytes(self._m[start:end]).decode("utf-8")

    def _links(self, btree: int, heap: int) -> Dict[str, int]:
        """name -> object header address of every entry under the group
        B-tree at `btree`, in its (name) order."""
        out: Dict[str, int] = {}
        stack = [btree]
        while stack:
            node = stack.pop()
            if self._m[node:node + 4] != b"TREE" or self._m[node + 4] != 0:
                raise OSError(f"no group B-tree node at {node}")
            level, used = self._m[node + 5], self._u(node + 6, 2)
            pos = node + 8 + 2 * self._so + self._sl
            children = []
            for _ in range(used):
                children.append(self._addr(pos))
                pos += self._so + self._sl
            if level:
                stack.extend(reversed(children))
                continue
            for snod in children:
                if self._m[snod:snod + 4] != b"SNOD":
                    raise OSError(f"no symbol table node at {snod}")
                entry = snod + 8
                for _ in range(self._u(snod + 6, 2)):
                    name = self._local_heap_name(heap, self._u(entry, self._so))
                    if self._u(entry + 2 * self._so, 4) == 2:
                        _refuse(f"soft link {name!r}")
                    out[name] = self._addr(entry + self._so)
                    entry += 2 * self._so + 24
        return out

    # -------------------------------------------------------------- surface
    def __getitem__(self, path: str):
        return self._root[path]

    def __contains__(self, path: str) -> bool:
        return path in self._root

    def keys(self):
        return self._root.keys()

    @property
    def attrs(self) -> "_Attrs":
        return self._root.attrs

    @property
    def name(self) -> str:
        return "/"

    def close(self):
        if self._m is not None:
            self._m.close()
            self._fh.close()
            self._m = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _Attrs(Mapping):
    """An object's attributes, read when asked for."""

    def __init__(self, f: File, msgs):
        self._f = f
        self._index = f._attributes(msgs)

    def __getitem__(self, name: str):
        pos, dtype, shape = self._index[name]
        value = self._f._values(pos, dtype, shape, str)
        return value[()] if shape == () else value

    def __iter__(self) -> Iterator[str]:
        return iter(self._index)

    def __len__(self) -> int:
        return len(self._index)

    def __contains__(self, name) -> bool:
        return name in self._index


class _Object:
    def __init__(self, f: File, addr: int, name: str, msgs=None):
        self._f = f
        self._msgs = f._messages(addr) if msgs is None else msgs
        self.name = name
        self._attrs: Optional[_Attrs] = None

    @property
    def attrs(self) -> _Attrs:
        if self._attrs is None:
            self._attrs = _Attrs(self._f, self._msgs)
        return self._attrs

    def _body(self, mtype: int) -> Optional[Tuple[int, int]]:
        for t, b, size in self._msgs:
            if t == mtype:
                return b, size
        return None


class _Group(_Object):
    def __init__(self, f: File, addr: int, name: str, msgs=None):
        super().__init__(f, addr, name, msgs)
        b, _ = self._body(_SYMBOL_TABLE)
        self._children = f._links(f._addr(b), f._addr(b + f._so))

    def _child(self, part: str):
        return self._f._object(self._children[part],
                               self.name.rstrip("/") + "/" + part)

    def __getitem__(self, path: str):
        node = self._f._root if path.startswith("/") else self
        for part in (p for p in path.split("/") if p):
            if not isinstance(node, _Group) or part not in node._children:
                raise KeyError(f"{path!r} not found under {self.name!r}")
            node = node._child(part)
        return node

    def __contains__(self, path: str) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True

    def __iter__(self) -> Iterator[str]:
        return iter(self._children)

    def keys(self):
        return list(self._children)


class Dataset(_Object):
    """A dataset: its type, shape and storage, read whole when asked for."""

    def __init__(self, f: File, addr: int, name: str, msgs=None):
        super().__init__(f, addr, name, msgs)
        filters = self._body(_FILTERS)
        if filters is not None:
            b, _ = filters
            first = f._u(b + (8 if f._m[b] == 1 else 2), 2)
            _refuse(f"filter pipeline at {name!r}: "
                    f"{_FILTER_NAMES.get(first, f'filter {first}')}")
        b, _ = self._body(_LAYOUT)
        version, cls = f._m[b], f._m[b + 1]
        if version != 3:
            _refuse(f"data layout message version {version} at {name!r}")
        if cls == 0:
            self._storage: Optional[int] = b + 4
        elif cls == 1:
            self._storage = f._addr(b + 2)
        else:
            _refuse(f"{'chunked' if cls == 2 else f'class {cls}'} layout at "
                    f"{name!r}")
        self._type, _ = f._datatype(self._body(_DATATYPE)[0])
        self.shape = f._dataspace(self._body(_DATASPACE)[0])

    @property
    def dtype(self) -> np.dtype:
        return np.dtype(object) if isinstance(self._type, _VlenString) else self._type

    def _fill_value(self) -> Optional[int]:
        """Where the dataset's fill value is stored, if it defines one."""
        f = self._f
        new, old = self._body(_FILL), self._body(_FILL_OLD)
        if new is not None:
            b, _ = new
            if f._m[b] == 3:
                flags = f._m[b + 1]
                size_at = b + 2 if flags & 0x20 else None
            else:
                size_at = b + 4 if f._m[b + 3] else None
        elif old is not None:
            size_at = old[0]
        else:
            return None
        if size_at is None or f._u(size_at, 4) != self._type.itemsize:
            return None
        return size_at + 4

    def _fill(self) -> np.ndarray:
        """The array of a dataset with no storage: its fill value, else 0."""
        if isinstance(self._type, _VlenString):
            return np.full(self.shape, b"", dtype=object)
        at = self._fill_value()
        if at is None:
            return np.zeros(self.shape, self._type)
        value = np.frombuffer(self._f._m, self._type, 1, at).copy()
        return np.full(self.shape, value[0], self._type)

    def _read(self) -> np.ndarray:
        if self._storage is None:
            return self._fill()
        return self._f._values(self._storage, self._type, self.shape, bytes)

    def __getitem__(self, key):
        return self._read()[key]

    def __array__(self, dtype=None, copy=None):
        a = self._read()
        return a if dtype is None else a.astype(dtype)
