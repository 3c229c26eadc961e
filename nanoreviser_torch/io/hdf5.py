"""A minimal HDF5 reader and writer in pure Python + numpy.

The port reads fast5 reads and Keras ``.h5`` weights and writes weights and
synthetic fast5 files, on machines where neither h5py nor libhdf5 is
installed. This module covers the subset of the HDF5 file format those files
use (HDF5 File Format Specification, version 3.0):

Reading
  * superblock versions 0-3; object headers v1 and v2 (with continuation
    blocks);
  * groups stored as symbol tables (v1 B-tree + local heap) or as compact
    link messages;
  * datasets with compact, contiguous or chunked (v1 B-tree) layout; the
    deflate and shuffle filters;
  * datatypes: fixed-point, floating-point, fixed strings, compound
    (versions 1-3), variable-length strings (global heap);
  * attributes (message versions 1-3) in the object header.

Writing (what ``h5py`` writes by default, so the HDF5 library reads it):
superblock v0, v1 object headers, symbol-table groups, contiguous datasets
and v1 attributes of little-endian fixed-point, floating-point, fixed-string
and compound types; 1-D datasets also chunked (a v1 B-tree of chunks) with
h5py's shuffle and gzip filters. Intermediate groups of a path are created
on demand.

The interface mirrors the parts of h5py the package uses: ``File(path,
mode)``, ``f[path]``, ``group.attrs``, ``keys/values/items``,
``create_group``, ``create_dataset`` and ``dataset[()]``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF


class HDF5Error(ValueError):
    """Malformed file or a feature outside the supported subset."""


# ===================================================================== reading


class _Buf:
    """Little-endian cursor over the file bytes."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise HDF5Error("read past the end of the file")
        b = self.data[self.pos : self.pos + n]
        self.pos += n
        return b

    def u(self, n: int) -> int:
        return int.from_bytes(self.take(n), "little")

    def skip(self, n: int) -> None:
        self.pos += n


def _parse_datatype(b: _Buf) -> np.dtype | tuple:
    """Datatype message -> numpy dtype, or ("vlen_str", charset)."""
    head = b.u(1)
    cls, ver = head & 0x0F, head >> 4
    bits = b.u(3)
    size = b.u(4)
    if cls == 0:                                   # fixed-point
        if bits & 1:
            raise HDF5Error("big-endian integers are not supported")
        b.skip(4)
        signed = bool(bits & 0x08)
        return np.dtype(f"<{'i' if signed else 'u'}{size}")
    if cls == 1:                                   # floating-point
        if bits & 1:
            raise HDF5Error("big-endian floats are not supported")
        b.skip(12)
        return np.dtype(f"<f{size}")
    if cls == 3:                                   # fixed-length string
        return np.dtype(f"S{size}")
    if cls == 6:                                   # compound
        n_members = bits & 0xFFFF
        names, formats, offsets = [], [], []
        for _ in range(n_members):
            start = b.pos
            end = b.data.index(b"\0", start)
            name = b.data[start:end].decode()
            if ver < 3:
                b.pos = start + ((end - start + 1 + 7) // 8) * 8
                off = b.u(4)
                if ver == 1:
                    b.skip(1 + 3 + 4 + 4 + 16)    # array dims of version 1
            else:
                b.pos = end + 1
                nb = 1 if size < 256 else 2 if size < 65536 else 3 if size < 2**24 else 4
                off = b.u(nb)
            names.append(name)
            formats.append(_parse_datatype(b))
            offsets.append(off)
        return np.dtype({"names": names, "formats": formats,
                         "offsets": offsets, "itemsize": size})
    if cls == 9:                                   # variable-length
        base = _parse_datatype(b)
        if bits & 0x0F == 1:
            return ("vlen_str", (bits >> 8) & 0x0F)   # charset: 0 ASCII, 1 UTF-8
        raise HDF5Error(f"variable-length sequences of {base} are not supported")
    raise HDF5Error(f"datatype class {cls} is not supported")


def _parse_dataspace(b: _Buf) -> tuple:
    ver = b.u(1)
    rank = b.u(1)
    flags = b.u(1)
    if ver == 1:
        b.skip(5)
        kind = 1 if rank else 0
    else:
        kind = b.u(1)
    dims = tuple(b.u(8) for _ in range(rank))
    if flags & 1:
        b.skip(8 * rank)
    if kind == 2:                                  # null dataspace
        return (0,)
    return dims


class _Reader:
    def __init__(self, path):
        with open(path, "rb") as fp:
            self.data = fp.read()
        if self.data[:8] != SIGNATURE:
            raise HDF5Error(f"{path}: not an HDF5 file (no signature at 0)")
        b = _Buf(self.data, 8)
        ver = b.u(1)
        if ver in (0, 1):
            b.skip(4)
            if b.u(1) != 8 or b.u(1) != 8:
                raise HDF5Error("only 8-byte offsets and lengths are supported")
            b.skip(1 + 4 + 4 + (4 if ver == 1 else 0))
            b.skip(8 * 4)                          # base, free space, eof, driver
            b.skip(8)                              # root link name offset
            self.root = b.u(8)
        elif ver in (2, 3):
            if b.u(1) != 8 or b.u(1) != 8:
                raise HDF5Error("only 8-byte offsets and lengths are supported")
            b.skip(1 + 8 * 3)
            self.root = b.u(8)
        else:
            raise HDF5Error(f"superblock version {ver} is not supported")

    # ------------------------------------------------------ object headers

    def messages(self, addr: int) -> list:
        """[(type, bytes)] of one object header, continuations followed."""
        data = self.data
        if data[addr : addr + 4] == b"OHDR":
            return self._messages_v2(addr)
        b = _Buf(data, addr)
        if b.u(1) != 1:
            raise HDF5Error(f"object header at {addr}: unknown version")
        b.skip(1)
        n_msgs = b.u(2)
        b.skip(4)
        size = b.u(4)
        blocks = [(addr + 16, size)]
        out = []
        while blocks and len(out) < n_msgs:
            start, length = blocks.pop(0)
            b = _Buf(data, start)
            while b.pos < start + length and len(out) < n_msgs:
                mtype = b.u(2)
                msize = b.u(2)
                b.skip(4)
                body = b.take(msize)
                if mtype == 0x10:
                    c = _Buf(body)
                    blocks.append((c.u(8), c.u(8)))
                out.append((mtype, body))
        return out

    def _messages_v2(self, addr: int) -> list:
        b = _Buf(self.data, addr + 4)
        b.skip(1)                                  # version 2
        flags = b.u(1)
        if flags & 0x20:
            b.skip(16)                             # times
        if flags & 0x10:
            b.skip(4)                              # attribute phase change
        size = b.u(1 << (flags & 3))
        tracked = bool(flags & 0x04)
        out = []
        blocks = [(b.pos, size)]
        while blocks:
            start, length = blocks.pop(0)
            b = _Buf(self.data, start)
            while b.pos + 4 <= start + length:
                mtype = b.u(1)
                msize = b.u(2)
                b.skip(1 + (2 if tracked else 0))
                body = b.take(msize)
                if mtype == 0x10:
                    c = _Buf(body)
                    caddr, clen = c.u(8), c.u(8)
                    blocks.append((caddr + 4, clen - 8))   # "OCHK" ... checksum
                out.append((mtype, body))
        return out

    # -------------------------------------------------------------- groups

    def links(self, addr: int) -> dict:
        """name -> object header address of a group's members (sorted)."""
        msgs = self.messages(addr)
        out = {}
        for mtype, body in msgs:
            if mtype == 0x11:                      # symbol table
                b = _Buf(body)
                btree, heap = b.u(8), b.u(8)
                heap_data = self._local_heap(heap)
                for name_off, obj in self._btree_group(btree):
                    end = heap_data.index(b"\0", name_off)
                    out[heap_data[name_off:end].decode()] = obj
            elif mtype == 0x06:                    # link (compact storage)
                name, obj = self._link(body)
                if obj is not None:
                    out[name] = obj
            elif mtype == 0x02:                    # link info
                b = _Buf(body)
                b.skip(1)
                fl = b.u(1)
                if fl & 1:
                    b.skip(8)
                if b.u(8) != UNDEF:
                    raise HDF5Error("dense link storage is not supported")
        return dict(sorted(out.items()))

    def _link(self, body: bytes):
        b = _Buf(body)
        b.skip(1)
        flags = b.u(1)
        ltype = b.u(1) if flags & 0x08 else 0
        if flags & 0x04:
            b.skip(8)
        if flags & 0x10:
            b.skip(1)
        nlen = b.u(1 << (flags & 3))
        name = b.take(nlen).decode()
        return name, (b.u(8) if ltype == 0 else None)

    def _local_heap(self, addr: int) -> bytes:
        b = _Buf(self.data, addr)
        if b.take(4) != b"HEAP":
            raise HDF5Error(f"no local heap at {addr}")
        b.skip(4)
        size = b.u(8)
        b.skip(8)
        start = b.u(8)
        return self.data[start : start + size]

    def _btree_group(self, addr: int):
        b = _Buf(self.data, addr)
        if b.take(4) != b"TREE":
            raise HDF5Error(f"no B-tree node at {addr}")
        ntype, level, used = b.u(1), b.u(1), b.u(2)
        b.skip(16)
        children = []
        for _ in range(used):
            b.skip(8)                              # key
            children.append(b.u(8))
        for child in children:
            if level > 0:
                yield from self._btree_group(child)
            else:
                s = _Buf(self.data, child)
                if s.take(4) != b"SNOD":
                    raise HDF5Error(f"no symbol table node at {child}")
                s.skip(2)
                n = s.u(2)
                for _ in range(n):
                    name_off, obj = s.u(8), s.u(8)
                    s.skip(24)
                    yield name_off, obj

    # ------------------------------------------------------------ datasets

    def read_value(self, dtype, shape: tuple, raw: bytes):
        count = int(np.prod(shape)) if shape else 1
        if isinstance(dtype, tuple):               # vlen strings
            vals = []
            b = _Buf(raw)
            for _ in range(count):
                length, gaddr, idx = b.u(4), b.u(8), b.u(4)
                raw_s = self._global_heap(gaddr, idx)[:length]
                # like h5py: UTF-8 strings as str, ASCII strings as bytes
                vals.append(raw_s.decode("utf-8") if dtype[1] == 1 else raw_s)
            arr = np.array(vals, dtype=object).reshape(shape)
            return arr[()] if not shape else arr
        arr = np.frombuffer(raw, dtype=dtype, count=count).reshape(shape)
        return arr[()] if not shape else arr.copy()

    def _global_heap(self, addr: int, index: int) -> bytes:
        b = _Buf(self.data, addr)
        if b.take(4) != b"GCOL":
            raise HDF5Error(f"no global heap collection at {addr}")
        b.skip(4)
        end = addr + b.u(8)
        while b.pos + 16 <= end:
            idx = b.u(2)
            b.skip(6)
            size = b.u(8)
            if idx == 0:
                break
            if idx == index:
                return b.take(size)
            b.skip((size + 7) // 8 * 8)
        raise HDF5Error(f"global heap object {index} not found")

    def dataset(self, addr: int):
        """(dtype, shape, raw-bytes getter) of a dataset object header."""
        dtype = shape = layout = None
        filters = []
        for mtype, body in self.messages(addr):
            if mtype == 0x01:
                shape = _parse_dataspace(_Buf(body))
            elif mtype == 0x03:
                dtype = _parse_datatype(_Buf(body))
            elif mtype == 0x08:
                layout = body
            elif mtype == 0x0B:
                filters = self._filters(body)
        if dtype is None or shape is None or layout is None:
            raise HDF5Error(f"object at {addr} is not a dataset")
        return dtype, shape, lambda: self._raw(layout, dtype, shape, filters)

    def _filters(self, body: bytes) -> list:
        b = _Buf(body)
        ver = b.u(1)
        n = b.u(1)
        if ver == 1:
            b.skip(6)
        out = []
        for _ in range(n):
            fid = b.u(2)
            nlen = b.u(2) if (ver == 1 or fid >= 256) else 0
            b.skip(2)                              # flags
            nvals = b.u(2)
            if nlen:
                b.skip((nlen + 7) // 8 * 8 if ver == 1 else nlen)
            vals = [b.u(4) for _ in range(nvals)]
            if ver == 1 and nvals % 2:
                b.skip(4)
            out.append((fid, vals))
        return out

    def _raw(self, layout: bytes, dtype, shape, filters) -> bytes:
        b = _Buf(layout)
        ver = b.u(1)
        cls = b.u(1)
        if ver not in (3, 4) or (ver == 4 and cls == 2):
            raise HDF5Error(f"data layout version {ver} class {cls} is not "
                            f"supported")
        itemsize = 16 if isinstance(dtype, tuple) else dtype.itemsize
        nbytes = (int(np.prod(shape)) if shape else 1) * itemsize
        if cls == 0:                               # compact
            size = b.u(2)
            return b.take(size)[:nbytes]
        if cls == 1:                               # contiguous
            addr = b.u(8)
            if addr == UNDEF:
                return bytes(nbytes)
            return self.data[addr : addr + nbytes]
        if cls == 2:                               # chunked
            rank = b.u(1) - 1
            btree = b.u(8)
            chunk = tuple(b.u(4) for _ in range(rank))
            return self._chunked(btree, chunk, dtype, shape, filters)
        raise HDF5Error(f"layout class {cls} is not supported")

    def _chunked(self, btree, chunk, dtype, shape, filters) -> bytes:
        out = np.zeros(shape, dtype=dtype)
        if btree == UNDEF:
            return out.tobytes()
        for offs, mask, addr, size in self._btree_chunks(btree, len(chunk)):
            raw = self.data[addr : addr + size]
            for fid, vals in reversed(filters):
                if mask:
                    raise HDF5Error("partially filtered chunks are not supported")
                if fid == 1:
                    raw = zlib.decompress(raw)
                elif fid == 2:
                    n = len(raw) // dtype.itemsize
                    raw = (np.frombuffer(raw, np.uint8).reshape(dtype.itemsize, n)
                           .T.tobytes())
                else:
                    raise HDF5Error(f"filter {fid} is not supported")
            block = np.frombuffer(raw, dtype=dtype, count=int(np.prod(chunk))).reshape(chunk)
            sl = tuple(slice(o, min(o + c, s)) for o, c, s in zip(offs, chunk, shape))
            out[sl] = block[tuple(slice(0, x.stop - x.start) for x in sl)]
        return out.tobytes()

    def _btree_chunks(self, addr: int, rank: int):
        b = _Buf(self.data, addr)
        if b.take(4) != b"TREE":
            raise HDF5Error(f"no B-tree node at {addr}")
        ntype, level, used = b.u(1), b.u(1), b.u(2)
        b.skip(16)
        for _ in range(used):
            size, mask = b.u(4), b.u(4)
            offs = tuple(b.u(8) for _ in range(rank + 1))[:rank]
            child = b.u(8)
            if level > 0:
                yield from self._btree_chunks(child, rank)
            else:
                yield offs, mask, child, size

    # ---------------------------------------------------------- attributes

    def attrs(self, addr: int) -> dict:
        out = {}
        for mtype, body in self.messages(addr):
            if mtype != 0x0C:
                continue
            b = _Buf(body)
            ver = b.u(1)
            b.skip(1)
            nsize, tsize, ssize = b.u(2), b.u(2), b.u(2)
            if ver >= 3:
                b.skip(1)
            pad = (lambda n: (n + 7) // 8 * 8) if ver == 1 else (lambda n: n)
            name = b.take(pad(nsize))[: nsize - 1].decode()
            t0 = b.pos
            dtype = _parse_datatype(b)
            b.pos = t0 + pad(tsize)
            s0 = b.pos
            shape = _parse_dataspace(b)
            b.pos = s0 + pad(ssize)
            out[name] = self.read_value(dtype, shape, body[b.pos :])
        return out

    def is_group(self, addr: int) -> bool:
        return any(t in (0x11, 0x02, 0x06) for t, _ in self.messages(addr))


class _RNode:
    def __init__(self, reader: _Reader, addr: int, name: str):
        self._r = reader
        self._addr = addr
        self.name = name
        self._attrs = None

    @property
    def attrs(self) -> dict:
        if self._attrs is None:
            self._attrs = self._r.attrs(self._addr)
        return self._attrs


class Dataset(_RNode):
    """A dataset opened for reading; ``ds[()]`` or ``np.asarray(ds)``."""

    def __init__(self, reader, addr, name):
        super().__init__(reader, addr, name)
        self.dtype, self.shape, self._getter = reader.dataset(addr)

    def __getitem__(self, key):
        value = self._r.read_value(self.dtype, self.shape, self._getter())
        return value if key == () else value[key]

    def __array__(self, dtype=None, copy=None):
        arr = np.asarray(self[()])
        return arr if dtype is None else arr.astype(dtype)

    def __len__(self):
        return self.shape[0]


class Group(_RNode):
    """A group opened for reading."""

    def _links(self) -> dict:
        return self._r.links(self._addr)

    def __getitem__(self, path: str):
        node = self
        for part in [p for p in str(path).split("/") if p]:
            if not isinstance(node, Group):
                raise KeyError(path)
            links = node._links()
            if part not in links:
                raise KeyError(f"{path}: no member {part!r}")
            addr = links[part]
            full = node.name.rstrip("/") + "/" + part
            node = (Group(self._r, addr, full) if self._r.is_group(addr)
                    else Dataset(self._r, addr, full))
        return node

    def __contains__(self, path: str) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True

    def keys(self):
        return list(self._links())

    def values(self):
        return [self[k] for k in self.keys()]

    def items(self):
        return [(k, self[k]) for k in self.keys()]


# ===================================================================== writing


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


def _object_header(messages: list[bytes]) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


class WGroup:
    """A group being written; serialized when the file is closed."""

    LEAF_K = 4            # symbol table node holds 2K entries
    INTERNAL_K = 16       # B-tree node holds 2K children

    def __init__(self):
        self.members: dict = {}
        self.attrs: dict = {}

    def _walk(self, path: str, create: bool):
        parts = [p for p in str(path).split("/") if p]
        node = self
        for part in parts[:-1]:
            nxt = node.members.get(part)
            if nxt is None:
                if not create:
                    raise KeyError(path)
                nxt = node.members[part] = WGroup()
            node = nxt
        return node, parts[-1]

    def create_group(self, path: str) -> "WGroup":
        parent, name = self._walk(path, create=True)
        if name not in parent.members:
            parent.members[name] = WGroup()
        return parent.members[name]

    def create_dataset(self, path: str, data, chunks=None, compression=None,
                       shuffle: bool = False) -> "WDataset":
        """h5py's keywords: ``chunks`` (a 1-tuple, 1-D data only),
        ``compression`` None or "gzip" (zlib level 4, h5py's default) and
        ``shuffle``; the filters need ``chunks``."""
        parent, name = self._walk(path, create=True)
        if name in parent.members:
            raise HDF5Error(f"{path} exists")
        ds = parent.members[name] = WDataset(np.asarray(data), chunks,
                                             compression, shuffle)
        return ds

    def __getitem__(self, path: str):
        parent, name = self._walk(path, create=False)
        return parent.members[name]

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


class WDataset:
    """A dataset being written: contiguous, or 1-D chunked with a v1 B-tree
    of chunks and optional shuffle and gzip filters."""

    GZIP_LEVEL = 4        # h5py's default for compression="gzip"
    CHUNK_K = 32          # the superblock's default: 2K chunks per B-tree node

    def __init__(self, data: np.ndarray, chunks=None, compression=None,
                 shuffle: bool = False):
        if data.dtype.kind == "U":
            data = np.char.encode(data, "utf-8")
        # (np.ascontiguousarray would turn a scalar into shape (1,))
        self.data = np.array(data, order="C", copy=True)
        self.attrs: dict = {}
        if compression not in (None, "gzip"):
            raise HDF5Error(f"compression {compression!r} is not supported")
        if chunks is None and (compression or shuffle):
            raise HDF5Error("filters need a chunked layout")
        if chunks is not None and (self.data.ndim != 1 or len(chunks) != 1
                                   or int(chunks[0]) < 1):
            raise HDF5Error(f"chunks {chunks} for shape {self.data.shape}: "
                            f"only 1-D chunking is supported")
        self.chunk = None if chunks is None else int(chunks[0])
        self.filters = ([2] if shuffle else []) + ([1] if compression else [])

    def _filter_message(self) -> bytes:
        body = struct.pack("<BB6x", 1, len(self.filters))
        for fid in self.filters:
            name, val = {1: (b"deflate\0", self.GZIP_LEVEL),
                         2: (b"shuffle\0", self.data.dtype.itemsize)}[fid]
            body += struct.pack("<HHHH", fid, len(name), 1, 1) + name
            body += struct.pack("<I4x", val)       # one value, padded to 8
        return _message(0x0B, body)

    def _messages(self, data_addr: int) -> list[bytes]:
        msgs = [_message(0x01, _encode_dataspace(self.data.shape)),
                _message(0x03, _encode_datatype(self.data.dtype))]
        if self.chunk is None:
            nbytes = self.data.nbytes
            msgs += [
                # fill value v2: allocation late, write on allocation, undefined
                _message(0x05, struct.pack("<BBBB", 2, 2, 0, 0)),
                _message(0x08, struct.pack("<BBQQ", 3, 1,
                                           data_addr if nbytes else UNDEF, nbytes)),
            ]
        else:
            # fill value v2: allocation incremental, the default (zero) fill
            msgs.append(_message(0x05, struct.pack("<BBBBI", 2, 3, 2, 1, 0)))
            if self.filters:
                msgs.append(self._filter_message())
            msgs.append(_message(0x08, struct.pack(
                "<BBBQII", 3, 2, 2, data_addr, self.chunk, self.data.dtype.itemsize)))
        return msgs + [_attr_message(k, v) for k, v in self.attrs.items()]

    def _size(self) -> int:
        return 16 + sum(len(m) for m in self._messages(0))

    def _chunk_bytes(self, k: int) -> bytes:
        """Chunk ``k`` as stored: padded to the chunk size with zeros, then
        shuffled and deflated."""
        c, item = self.chunk, self.data.dtype.itemsize
        raw = self.data[k * c : (k + 1) * c].tobytes()
        raw += bytes(c * item - len(raw))
        if 2 in self.filters:
            raw = np.frombuffer(raw, np.uint8).reshape(c, item).T.tobytes()
        if 1 in self.filters:
            raw = zlib.compress(raw, self.GZIP_LEVEL)
        return raw

    def _btree(self, alloc: _Alloc) -> int:
        """Write the chunks and their v1 B-tree (type 1); returns the root's
        address. A key is (stored size, filter mask, offset, 0); a node's
        last key bounds its last chunk."""
        n = len(self.data)
        if n == 0:
            return UNDEF
        c, per_node = self.chunk, 2 * self.CHUNK_K
        node_size = 24 + (per_node + 1) * 24 + per_node * 8
        entries = []                               # (first key, child address)
        for k in range(-(-n // c)):
            blob = self._chunk_bytes(k)
            addr = alloc.reserve(len(blob))
            alloc.put(addr, blob)
            entries.append(((len(blob), k * c), addr))
        end_key = (0, -(-n // c) * c)
        level = 0
        while True:
            nodes = [entries[i : i + per_node] for i in range(0, len(entries), per_node)]
            addrs = [alloc.reserve(node_size) for _ in nodes]
            for j, group in enumerate(nodes):
                left = addrs[j - 1] if j > 0 else UNDEF
                right = addrs[j + 1] if j + 1 < len(nodes) else UNDEF
                last = nodes[j + 1][0][0] if j + 1 < len(nodes) else end_key
                node = b"TREE" + struct.pack("<BBHQQ", 1, level, len(group), left, right)
                for (size, off), child in group:
                    node += struct.pack("<IIQQQ", size, 0, off, 0, child)
                node += struct.pack("<IIQQ", last[0], 0, last[1], 0)
                alloc.put(addrs[j], node + bytes(node_size - len(node)))
            if len(nodes) == 1:
                return addrs[0]
            entries = [(group[0][0], a) for group, a in zip(nodes, addrs)]
            level += 1

    def _serialize(self, alloc: _Alloc, addr: int):
        if self.chunk is not None:
            data_addr = self._btree(alloc)
        elif self.data.nbytes:
            data_addr = alloc.reserve(self.data.nbytes)
            alloc.put(data_addr, self.data.tobytes())
        else:
            data_addr = UNDEF
        alloc.put(addr, _object_header(self._messages(data_addr)))
        return None


def _write_file(path, root: WGroup) -> None:
    alloc = _Alloc(96)
    root_addr = alloc.reserve(root._size())
    btree, heap = root._serialize(alloc, root_addr)
    eof = alloc.end
    sb = SIGNATURE + struct.pack("<BBBBBBBBHHI", 0, 0, 0, 0, 0, 8, 8, 0, 4, 16, 0)
    sb += struct.pack("<QQQQ", 0, UNDEF, eof, UNDEF)
    sb += struct.pack("<QQII", 0, root_addr, 1, 0) + struct.pack("<QQ", btree, heap)
    buf = bytearray(eof)
    buf[: len(sb)] = sb
    for addr, data in alloc.chunks:
        buf[addr : addr + len(data)] = data
    with open(path, "wb") as fp:
        fp.write(bytes(buf))


# ======================================================================== File


class File:
    """``File(path, "r")`` reads; ``File(path, "w")`` writes on close."""

    def __init__(self, path, mode: str = "r"):
        self.path = path
        self.mode = mode
        if mode == "r":
            reader = _Reader(path)
            self._root = Group(reader, reader.root, "/")
        elif mode == "w":
            self._root = WGroup()
        else:
            raise ValueError(f"mode must be 'r' or 'w', got {mode!r}")

    @property
    def attrs(self) -> dict:
        return self._root.attrs

    def __getitem__(self, path):
        return self._root[path]

    def __contains__(self, path):
        return path in self._root

    def keys(self):
        return self._root.keys()

    def values(self):
        return self._root.values()

    def items(self):
        return self._root.items()

    def create_group(self, path):
        return self._root.create_group(path)

    def create_dataset(self, path, data, **kwargs):
        return self._root.create_dataset(path, data=data, **kwargs)

    def close(self) -> None:
        if self.mode == "w" and self._root is not None:
            _write_file(self.path, self._root)
            self._root = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        return False
