"""A minimal HDF5 writer in pure Python + numpy: the benchmark's own copy
of the writing half of ``nanoreviser_torch/io/hdf5.py`` (contiguous
datasets only), so that the files the benchmark feeds the program come
from the yardstick and not from the program.

It writes what ``h5py`` writes by default, so the HDF5 library and the
program's readers read it: superblock v0, v1 object headers, symbol-table
groups, contiguous datasets and v1 attributes of little-endian fixed-point,
floating-point, fixed-string and compound types (HDF5 File Format
Specification, version 3.0). Intermediate groups of a path are created on
demand. ``File(path)`` is written when it is closed.
"""

from __future__ import annotations

import struct

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF


class HDF5Error(ValueError):
    """A value outside the subset this writer supports."""


def _pad8(b: bytes) -> bytes:
    return b + bytes(-len(b) % 8)


def _encode_datatype(dt: np.dtype) -> bytes:
    dt = np.dtype(dt)
    if dt.byteorder == ">":
        raise HDF5Error("big-endian data is not supported")
    if dt.kind in "iu":
        bits = 0x08 if dt.kind == "i" else 0
        return (bytes([0x10 | 0]) + bits.to_bytes(3, "little")
                + struct.pack("<IHH", dt.itemsize, 0, 8 * dt.itemsize))
    if dt.kind == "f":
        spec = {2: (15, 10, 5, 0, 10, 15), 4: (31, 23, 8, 0, 23, 127),
                8: (63, 52, 11, 0, 52, 1023)}[dt.itemsize]
        sign, eloc, esize, mloc, msize, bias = spec
        bits = 0x20 | (sign << 8)
        return (bytes([0x10 | 1]) + bits.to_bytes(3, "little")
                + struct.pack("<IHHBBBBI", dt.itemsize, 0, 8 * dt.itemsize,
                              eloc, esize, mloc, msize, bias))
    if dt.kind == "S":
        return bytes([0x10 | 3]) + (1).to_bytes(3, "little") + struct.pack(
            "<I", dt.itemsize)                     # null-padded ASCII
    if dt.kind == "V" and dt.names:
        body = b""
        for name in dt.names:
            sub, off = dt.fields[name][:2]
            body += _pad8(name.encode() + b"\0")
            body += struct.pack("<IB3xI4x16x", off, 0, 0)
            body += _encode_datatype(sub)
        return (bytes([0x10 | 6]) + len(dt.names).to_bytes(3, "little")
                + struct.pack("<I", dt.itemsize) + body)
    raise HDF5Error(f"cannot write dtype {dt}")


def _encode_dataspace(shape: tuple) -> bytes:
    return struct.pack("<BBB5x", 1, len(shape), 0) + b"".join(
        struct.pack("<Q", d) for d in shape)


def _message(mtype: int, body: bytes) -> bytes:
    body = _pad8(body)
    return struct.pack("<HHB3x", mtype, len(body), 0) + body


def _attr_message(name: str, value) -> bytes:
    arr = np.asarray(value)
    if arr.dtype.kind == "U":
        arr = np.char.encode(arr, "utf-8")
    if arr.dtype == object:
        raise HDF5Error(f"attribute {name!r}: object arrays are not supported")
    nm = name.encode() + b"\0"
    dt = _encode_datatype(arr.dtype)
    ds = _encode_dataspace(arr.shape)
    body = (struct.pack("<BBHHH", 1, 0, len(nm), len(dt), len(ds))
            + _pad8(nm) + _pad8(dt) + _pad8(ds) + arr.tobytes())
    return _message(0x0C, body)


def _object_header(messages: list[bytes]) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


class _Alloc:
    def __init__(self, start: int):
        self.end = start
        self.chunks: list[tuple[int, bytes]] = []

    def reserve(self, size: int) -> int:
        addr = self.end
        self.end += (size + 7) // 8 * 8
        return addr

    def put(self, addr: int, data: bytes) -> None:
        self.chunks.append((addr, data))


class Group:
    """A group being written; serialized when the file is closed."""

    LEAF_K = 4            # a symbol table node holds 2K entries
    INTERNAL_K = 16       # a B-tree node holds 2K children

    def __init__(self):
        self.members: dict = {}
        self.attrs: dict = {}

    def _walk(self, path: str):
        parts = [p for p in str(path).split("/") if p]
        node = self
        for part in parts[:-1]:
            node = node.members.setdefault(part, Group())
        return node, parts[-1]

    def create_group(self, path: str) -> "Group":
        parent, name = self._walk(path)
        return parent.members.setdefault(name, Group())

    def create_dataset(self, path: str, data) -> "Dataset":
        parent, name = self._walk(path)
        if name in parent.members:
            raise HDF5Error(f"{path} exists")
        ds = parent.members[name] = Dataset(np.asarray(data))
        return ds

    def _size(self) -> int:
        return 16 + len(_message(0x11, bytes(16))) + sum(
            len(_attr_message(k, v)) for k, v in self.attrs.items())

    def _serialize(self, alloc: _Alloc, addr: int) -> tuple[int, int]:
        """Write this group at ``addr``; returns (btree, heap) addresses."""
        names = sorted(self.members, key=lambda s: s.encode())
        heap_data = bytearray(8)                   # offset 0: the empty name
        offsets = {}
        for n in names:
            offsets[n] = len(heap_data)
            heap_data += _pad8(n.encode() + b"\0")
        per_node = 2 * self.LEAF_K
        groups = [names[i : i + per_node] for i in range(0, len(names), per_node)] or [[]]
        if len(groups) > 2 * self.INTERNAL_K:
            raise HDF5Error(f"group with {len(names)} members is too large")
        heap = alloc.reserve(32)
        heap_seg = alloc.reserve(len(heap_data))
        btree_size = 24 + (2 * self.INTERNAL_K + 1) * 8 + 2 * self.INTERNAL_K * 8
        btree = alloc.reserve(btree_size)
        snod_size = 8 + per_node * 40
        snods = [alloc.reserve(snod_size) for _ in groups]

        child_info = {}
        for n in names:
            child = self.members[n]
            caddr = alloc.reserve(child._size())
            child_info[n] = (caddr, child._serialize(alloc, caddr))

        # free-list offset 1 is the library's "no free block" marker
        alloc.put(heap, b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap_data),
                                              1, heap_seg))
        alloc.put(heap_seg, bytes(heap_data))
        tree = b"TREE" + struct.pack("<BBHQQ", 0, 0, len(groups), UNDEF, UNDEF)
        tree += struct.pack("<Q", 0)
        for g, saddr in zip(groups, snods):
            tree += struct.pack("<QQ", saddr, offsets[g[-1]] if g else 0)
        alloc.put(btree, tree + bytes(btree_size - len(tree)))
        for g, saddr in zip(groups, snods):
            snod = b"SNOD" + struct.pack("<BBH", 1, 0, len(g))
            for n in g:
                caddr, sub = child_info[n]
                if sub is None:
                    snod += struct.pack("<QQII16x", offsets[n], caddr, 0, 0)
                else:
                    snod += struct.pack("<QQIIQQ", offsets[n], caddr, 1, 0, *sub)
            alloc.put(saddr, snod + bytes(snod_size - len(snod)))

        msgs = [_message(0x11, struct.pack("<QQ", btree, heap))]
        msgs += [_attr_message(k, v) for k, v in self.attrs.items()]
        alloc.put(addr, _object_header(msgs))
        return btree, heap


class Dataset:
    """A contiguous dataset being written."""

    def __init__(self, data: np.ndarray):
        if data.dtype.kind == "U":
            data = np.char.encode(data, "utf-8")
        # (np.ascontiguousarray would turn a scalar into shape (1,))
        self.data = np.array(data, order="C", copy=True)
        self.attrs: dict = {}

    def _messages(self, data_addr: int) -> list[bytes]:
        nbytes = self.data.nbytes
        return [
            _message(0x01, _encode_dataspace(self.data.shape)),
            _message(0x03, _encode_datatype(self.data.dtype)),
            # fill value v2: allocation late, write on allocation, undefined
            _message(0x05, struct.pack("<BBBB", 2, 2, 0, 0)),
            _message(0x08, struct.pack("<BBQQ", 3, 1,
                                       data_addr if nbytes else UNDEF, nbytes)),
        ] + [_attr_message(k, v) for k, v in self.attrs.items()]

    def _size(self) -> int:
        return 16 + sum(len(m) for m in self._messages(0))

    def _serialize(self, alloc: _Alloc, addr: int):
        if self.data.nbytes:
            data_addr = alloc.reserve(self.data.nbytes)
            alloc.put(data_addr, self.data.tobytes())
        else:
            data_addr = UNDEF
        alloc.put(addr, _object_header(self._messages(data_addr)))
        return None


class File(Group):
    """``File(path)``: a root group written to ``path`` on ``close``."""

    def __init__(self, path):
        super().__init__()
        self.path = path

    def close(self) -> None:
        alloc = _Alloc(96)
        root_addr = alloc.reserve(self._size())
        btree, heap = self._serialize(alloc, root_addr)
        eof = alloc.end
        sb = SIGNATURE + struct.pack("<BBBBBBBBHHI", 0, 0, 0, 0, 0, 8, 8, 0, 4, 16, 0)
        sb += struct.pack("<QQQQ", 0, UNDEF, eof, UNDEF)
        sb += struct.pack("<QQII", 0, root_addr, 1, 0) + struct.pack("<QQ", btree, heap)
        buf = bytearray(eof)
        buf[: len(sb)] = sb
        for addr, data in alloc.chunks:
            buf[addr : addr + len(data)] = data
        with open(self.path, "wb") as fp:
            fp.write(bytes(buf))

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        return False
