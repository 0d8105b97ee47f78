"""HDF5 files with numpy and the standard library alone.

The port reads and writes the reference's Keras weights files (``.h5``)
through this module, so no path of it needs the ``h5py`` package.  The
format is The HDF Group's *HDF5 File Format Specification, Version 3.0*;
where it leaves a detail open, the library's behaviour is the reference.

:class:`File` reads, read-only, what h5py writes for the Keras weights
layout under either of its formats:

* h5py's default (``libver='earliest'``, which TF-Keras ``save_weights``
  writes): superblock v0/v1; v1 object headers with continuation blocks;
  symbol-table groups (v1 B-trees of any depth, ``SNOD`` nodes, a local
  heap for the names); attribute messages v1-v3 holding fixed- and
  variable-length strings (the latter in the global heap), numbers, empty
  arrays or a null dataspace; datasets of IEEE floats (2, 4, 8 bytes) and
  integers (1-8 bytes) in either byte order, compact, contiguous or chunked
  (v3 layout, a v1 B-tree chunk index, the deflate, shuffle and fletcher32
  filters);
* ``libver='latest'``: superblock v2/v3; ``OHDR``/``OCHK`` object headers;
  links and attributes stored in the header or densely (a fractal heap of
  managed and tiny objects, indexed by a v2 B-tree); layout v4 compact,
  contiguous and chunked, through each of its five chunk indexes (single
  chunk, implicit, fixed array, extensible array, v2 B-tree), paged or not,
  with partial edge chunks left unfiltered where the layout says so.

What it refuses, the library refuses too, with ``ValueError`` where h5py
raises ``OSError``:

* a file shorter than the end-of-file address its superblock records;
* a Fletcher-32 checksum that does not match a chunk's bytes (either the
  library's form or the byte-swapped one it accepts from files of HDF5
  1.6.2 and before), and a corrupt deflate stream;
* a Jenkins lookup3 checksum that does not match its structure: the v2/v3
  superblock, ``OHDR`` and ``OCHK``, the v2 B-tree's ``BTHD``/``BTIN``/
  ``BTLF``, the fractal heap's ``FRHP``/``FHIB`` (and ``FHDB`` where the
  heap checksums its direct blocks), the fixed array's ``FAHD``/``FADB``
  and its pages, the extensible array's ``EAHD``/``EAIB``/``EASB``/``EADB``
  and its pages.  Each block is checked once per open file.  Version-1
  structures carry no checksum (superblock v0/v1, v1 object headers,
  ``TREE``, ``SNOD``, ``HEAP``, ``GCOL``): h5py's default format costs
  nothing more to read.

What lies outside the formats above also raises ``ValueError`` naming the
feature: a huge fractal-heap object, a filtered fractal heap, shared
(committed) messages, soft and external links, variable-length string
datasets, and datatypes other than the ones above.

Groups index by ``/``-separated paths, list their members in h5py's order
(by name, bytewise), and carry ``.attrs``; a dataset reads with ``[()]``.
Values come back as h5py gives them: arrays with the file's dtype (byte
order included), numpy scalars for scalar numbers, ``bytes`` arrays for
fixed-length strings, ``str`` (an object array of ``str``) for
variable-length string attributes, :class:`Empty` for a null dataspace.

:class:`Writer` writes h5py's default format, the one TF-Keras reads:
superblock v0, v1 object headers, symbol-table groups, attributes of
numbers or fixed-length null-padded strings, and contiguous datasets.
"""
from __future__ import annotations

import mmap
import os
import struct
import zlib
from collections.abc import Mapping
from typing import Dict, List, Optional, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"

# object header message types
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL = 0x00, 0x01, 0x02, 0x03, 0x04, 0x05
_LINK, _LAYOUT, _FILTERS, _ATTRIBUTE, _CONTINUATION, _SYMBOL_TABLE, _ATTRIBUTE_INFO = (
    0x06, 0x08, 0x0B, 0x0C, 0x10, 0x11, 0x15)

_CLASS_NAMES = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound", 7: "reference", 8: "enum", 10: "array"}
_FILTER_NAMES = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip", 5: "nbit", 6: "scaleoffset"}

_MAX_MESSAGE = 0xFFFF  # a v1 header message's size (8-byte aligned) is a 16-bit field


class Empty:
    """The value of an attribute or dataset with a null dataspace (h5py's
    ``h5py.Empty``)."""

    def __init__(self, dtype):
        self.dtype = np.dtype(dtype)

    def __repr__(self):
        return f"Empty(dtype={self.dtype!r})"


def _u(b, pos: int, n: int) -> int:
    return int.from_bytes(b[pos:pos + n], "little")


def _log2(n: int) -> int:
    return n.bit_length() - 1


_M32 = 0xFFFFFFFF


def lookup3(data: bytes) -> int:
    """Bob Jenkins' lookup3 ``hashlittle`` of ``data`` with initval 0: the
    checksum of HDF5's v2 metadata (the library's ``H5_checksum_lookup3``).
    The bytes go in as little-endian words, 12 at a time; the last block,
    zero-padded, gets the final mix (none for empty data)."""
    n = len(data)
    a = b = c = (0xDEADBEEF + n) & _M32
    if n == 0:
        return c
    words = struct.unpack(f"<{(n + 11) // 12 * 3}I", bytes(data) + bytes(-n % 12))
    for i in range(0, len(words) - 3, 3):
        a, b, c = (a + words[i]) & _M32, (b + words[i + 1]) & _M32, (c + words[i + 2]) & _M32
        a = ((a - c) & _M32) ^ (((c << 4) & _M32) | (c >> 28))
        c = (c + b) & _M32
        b = ((b - a) & _M32) ^ (((a << 6) & _M32) | (a >> 26))
        a = (a + c) & _M32
        c = ((c - b) & _M32) ^ (((b << 8) & _M32) | (b >> 24))
        b = (b + a) & _M32
        a = ((a - c) & _M32) ^ (((c << 16) & _M32) | (c >> 16))
        c = (c + b) & _M32
        b = ((b - a) & _M32) ^ (((a << 19) & _M32) | (a >> 13))
        a = (a + c) & _M32
        c = ((c - b) & _M32) ^ (((b << 4) & _M32) | (b >> 28))
        b = (b + a) & _M32
    a, b, c = (a + words[-3]) & _M32, (b + words[-2]) & _M32, (c + words[-1]) & _M32
    c = ((c ^ b) - (((b << 14) & _M32) | (b >> 18))) & _M32
    a = ((a ^ c) - (((c << 11) & _M32) | (c >> 21))) & _M32
    b = ((b ^ a) - (((a << 25) & _M32) | (a >> 7))) & _M32
    c = ((c ^ b) - (((b << 16) & _M32) | (b >> 16))) & _M32
    a = ((a ^ c) - (((c << 4) & _M32) | (c >> 28))) & _M32
    b = ((b ^ a) - (((a << 14) & _M32) | (a >> 18))) & _M32
    c = ((c ^ b) - (((b << 24) & _M32) | (b >> 8))) & _M32
    return c


_FLETCHER_BLOCK = 1 << 20  # words a numpy pass: sums of index x word stay far inside uint64


def fletcher32(data: bytes) -> int:
    """The library's Fletcher-32 of ``data`` (``H5_checksum_fletcher32``):
    the sums run over big-endian 16-bit words (an odd last byte counts as
    ``byte << 8``) and fold as ones' complement, so each lands in 1..0xffff
    unless every word is 0; the value is ``(sum2 << 16) | sum1``.  With
    ``P_k`` the prefix sums of the ``m`` words, ``sum1`` is ``P_{m-1}`` and
    ``sum2`` is ``sum P_k = sum (m - i) w_i``, both taken mod 65535, which
    numpy computes a block at a time."""
    raw = np.frombuffer(data, np.uint8)
    if len(raw) % 2:
        raw = np.concatenate([raw, np.zeros(1, np.uint8)])
    words = raw.view(">u2")
    m, s1, s2 = len(words), 0, 0
    for start in range(0, m, _FLETCHER_BLOCK):
        w = words[start:start + _FLETCHER_BLOCK].astype(np.uint64)
        ws = int(w.sum())
        s1 += ws
        s2 += (m - start) * ws - int(np.dot(w, np.arange(len(w), dtype=np.uint64)))
    if s1 == 0:  # every word 0: the running sums never left 0
        return 0
    return ((s2 - 1) % 65535 + 1) << 16 | ((s1 - 1) % 65535 + 1)


def _fletcher_ok(raw: bytes) -> bool:
    """Whether the 4 bytes after the data hold its Fletcher-32, as the
    library writes it (little-endian) or with each 16-bit half byte-swapped
    (HDF5 1.6.2 and before, which the library still accepts)."""
    stored, want = _u(raw, len(raw) - 4, 4), fletcher32(raw[:-4])
    swapped = ((want & 0x00FF00FF) << 8) | ((want >> 8) & 0x00FF00FF)
    return stored in (want, swapped)


def _le_uints(cols: np.ndarray) -> np.ndarray:
    """The little-endian unsigned integers in the rows of a ``(n, width)``
    uint8 array."""
    out = np.zeros(len(cols), np.uint64)
    for i in range(cols.shape[1]):
        out |= cols[:, i].astype(np.uint64) << np.uint64(8 * i)
    return out


class _Cursor:
    """Sequential little-endian fields of ``buf`` (the file's map, or the
    bytes of a heap object) from ``pos``."""

    __slots__ = ("f", "buf", "pos")

    def __init__(self, f: "_Store", pos: int, buf=None):
        self.f, self.buf, self.pos = f, f.buf if buf is None else buf, pos

    def u(self, n: int) -> int:
        self.pos += n
        return _u(self.buf, self.pos - n, n)

    def addr(self) -> Optional[int]:
        return self.f.address(self.u(self.f.O))

    def length(self) -> int:
        return self.u(self.f.L)

    def take(self, n: int) -> bytes:
        self.pos += n
        return bytes(self.buf[self.pos - n:self.pos])

    def expect(self, signature: bytes, what: str) -> None:
        got = self.take(len(signature))
        if got != signature:
            raise ValueError(f"HDF5 {what} at {self.pos - len(signature)}: signature {got!r}, not {signature!r}")


class _Type:
    """A parsed datatype: ``dtype`` (``object`` for variable-length
    strings), the size of one element in the file, and for fixed-length
    strings their padding (0 null-terminated, 1 null-padded, 2 space-padded)."""

    __slots__ = ("dtype", "size", "vlen", "pad")

    def __init__(self, dtype, size, vlen=False, pad=None):
        self.dtype, self.size, self.vlen, self.pad = np.dtype(dtype), size, vlen, pad


class _Store:
    """The file's bytes and what every object parse needs: the sizes of
    offsets and lengths, the base address, and caches of heaps."""

    def __init__(self, path: str):
        with open(path, "rb") as fh:
            try:
                self.buf = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
            except ValueError as e:  # an empty file
                raise ValueError(f"{path} is not an HDF5 file ({e})") from None
        self._global: Dict[int, Dict[int, Tuple[int, int]]] = {}
        self._heaps: Dict[int, "_FractalHeap"] = {}
        self._verified: set = set()  # addresses whose checksum matched
        self.O = self.L = 8
        self.base = 0
        try:
            self.root = self._superblock(path)
        except BaseException:
            self.buf.close()
            raise

    def close(self) -> None:
        self.buf.close()

    def address(self, value: int) -> Optional[int]:
        return None if value == (1 << (8 * self.O)) - 1 else value + self.base

    def verify(self, addr: int, size: int, what: str, zeroed: Optional[int] = None) -> None:
        """Check the lookup3 checksum of the ``size`` bytes at ``addr``,
        stored in the 4 bytes after them or, for a block that holds its
        checksum inside (a fractal heap's direct block), at ``zeroed``,
        read as 0 while the block is summed.  Each block once per file."""
        if addr in self._verified:
            return
        at = addr + size if zeroed is None else zeroed
        if max(at + 4, addr + size) > len(self.buf):
            raise ValueError(f"HDF5 {what} at {addr} runs past the end of the file ({len(self.buf)} bytes)")
        image = self.buf[addr:addr + size]
        if zeroed is not None:
            image = image[:zeroed - addr] + bytes(4) + image[zeroed - addr + 4:]
        stored, computed = _u(self.buf, at, 4), lookup3(image)
        if stored != computed:
            raise ValueError(f"HDF5 {what} at {addr}: checksum mismatch (stored {stored:#010x}, "
                             f"computed {computed:#010x})")
        self._verified.add(addr)

    def take(self, addr: int, size: int, what: str) -> bytes:
        """The ``size`` bytes at ``addr``, which must lie inside the file."""
        if addr + size > len(self.buf):
            raise ValueError(f"HDF5 {what} at {addr} ({size} bytes) runs past the end of the file "
                             f"({len(self.buf)} bytes)")
        return self.buf[addr:addr + size]

    # -- superblock ----------------------------------------------------------------
    def _superblock(self, path: str) -> int:
        at = 0
        while self.buf[at:at + 8] != SIGNATURE:
            at = 512 if at == 0 else 2 * at  # a user block shifts the superblock to 512, 1024, ...
            if at + 8 > len(self.buf):
                raise ValueError(f"{path} is not an HDF5 file (no superblock signature)")
        version = self.buf[at + 8]
        if version in (0, 1):
            self.O, self.L = self.buf[at + 13], self.buf[at + 14]
            c = _Cursor(self, at + 24 + (4 if version == 1 else 0))
            base = c.u(self.O)
            c.pos += self.O  # free-space info
            eof = c.u(self.O)
            c.pos += self.O  # driver information block
            c.pos += self.O  # the root's symbol-table entry: its link name offset
        elif version in (2, 3):
            self.O, self.L = self.buf[at + 9], self.buf[at + 10]
            self.verify(at, 12 + 4 * self.O, f"superblock (version {version})")
            c = _Cursor(self, at + 12)
            base, extension, eof = c.u(self.O), c.u(self.O), c.u(self.O)
        else:
            raise ValueError(f"{path}: HDF5 superblock version {version} is not supported")
        # as the library: addresses count from the superblock, the stored end
        # of file moves with it, and a file that ends before it is truncated
        self.base, eof = at, eof - base + at
        if len(self.buf) < eof:
            raise ValueError(f"{path}: truncated HDF5 file ({len(self.buf)} bytes; its superblock "
                             f"records {eof})")
        if version >= 2 and self.address(extension) is not None:
            self.messages(self.address(extension))  # the library reads (and checks) it at open
        return c.addr()

    # -- object headers ------------------------------------------------------------
    def messages(self, addr: int) -> List[Tuple[int, int, int]]:
        """``(type, data position, flags)`` of every message of the object
        header at ``addr``, continuation blocks followed, NIL messages
        dropped."""
        buf = self.buf
        if buf[addr:addr + 4] == b"OHDR":
            flags = buf[addr + 5]
            pos = addr + 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
            n = 1 << (flags & 3)
            blocks = [(pos + n, _u(buf, pos, n))]
            self.verify(addr, pos + n + blocks[0][1] - addr, "object header (OHDR)")
            head, v2 = (6 if flags & 0x04 else 4), True
        elif buf[addr] == 1:
            blocks = [(addr + 16, _u(buf, addr + 8, 4))]
            head, v2 = 8, False
        else:
            raise ValueError(f"HDF5 object header at {addr}: version {buf[addr]} is not supported")
        out = []
        for start, size in blocks:  # grows as continuation messages are met
            pos, end = start, start + size
            while pos + head <= end:
                if v2:
                    mtype, msize, mflags = buf[pos], _u(buf, pos + 1, 2), buf[pos + 3]
                else:
                    mtype, msize, mflags = _u(buf, pos, 2), _u(buf, pos + 2, 2), buf[pos + 4]
                data, pos = pos + head, pos + head + msize
                if mtype == _CONTINUATION:
                    c = _Cursor(self, data)
                    where, length = c.addr(), c.length()
                    if v2:  # OCHK: signature, messages, checksum
                        _Cursor(self, where).expect(b"OCHK", "object header continuation")
                        self.verify(where, length - 4, "object header continuation (OCHK)")
                    blocks.append((where + 4, length - 8) if v2 else (where, length))
                elif mtype != _NIL:
                    out.append((mtype, data, mflags))
        return out

    def node(self, addr: int, name: str):
        msgs = self.messages(addr)
        kinds = {m[0] for m in msgs}
        if _LAYOUT in kinds:
            return Dataset(self, name, msgs)
        if kinds & {_SYMBOL_TABLE, _LINK_INFO, _LINK}:
            return Group(self, name, msgs)
        raise ValueError(f"HDF5 object {name!r} is neither a group nor a dataset (messages {sorted(kinds)})")

    # -- symbol-table groups -------------------------------------------------------
    def btree1_leaves(self, addr: int, key_size: int) -> List[Tuple[int, int]]:
        """``(key position, child address)`` of every entry at level 0 of
        the v1 B-tree at ``addr``."""
        out, stack = [], [addr]
        while stack:
            c = _Cursor(self, stack.pop())
            c.expect(b"TREE", "v1 B-tree node")
            c.u(1)
            level, used = c.u(1), c.u(2)
            c.pos += 2 * self.O  # siblings
            for _ in range(used):
                key = c.pos
                c.pos += key_size
                child = c.addr()
                if level:
                    stack.append(child)
                else:
                    out.append((key, child))
        return out

    def symbol_table(self, btree: int, heap: int) -> Dict[str, Optional[int]]:
        c = _Cursor(self, heap)
        c.expect(b"HEAP", "local heap")
        c.pos += 4 + 2 * self.L  # version, reserved, data size, free list
        names = c.addr()
        links = {}
        entry = 2 * self.O + 24
        for _, snod in self.btree1_leaves(btree, self.L):
            c = _Cursor(self, snod)
            c.expect(b"SNOD", "symbol table node")
            c.pos += 2
            for i in range(c.u(2)):
                e = _Cursor(self, c.pos + i * entry)
                off, obj = e.u(self.O), e.addr()
                end = self.buf.find(b"\0", names + off)
                name = self.buf[names + off:end].decode("utf-8")
                links[name] = obj if e.u(4) != 2 else None  # cache type 2: a soft link
        return links

    # -- v2 B-trees and fractal heaps ----------------------------------------------
    def btree2_records(self, addr: int) -> List[bytes]:
        """Every record of the v2 B-tree at ``addr``, internal nodes' included."""
        c = _Cursor(self, addr)
        c.expect(b"BTHD", "v2 B-tree header")
        self.verify(addr, 18 + self.O + self.L, "v2 B-tree header (BTHD)")
        c.pos += 2
        node_size, rec_size, depth = c.u(4), c.u(2), c.u(2)
        c.pos += 2
        root, nroot, total = c.addr(), c.u(2), c.length()
        # node capacities, as the library derives them from the node size
        max_nrec = [(node_size - 10) // rec_size]
        cum, cum_size = [max_nrec[0]], [0]
        nrec_size = _log2(max_nrec[0]) // 8 + 1
        for d in range(1, depth + 1):
            ptr = self.O + nrec_size + (cum_size[d - 1] if d > 1 else 0)
            m = (node_size - (10 + ptr)) // (rec_size + ptr)
            max_nrec.append(m)
            cum.append((m + 1) * cum[d - 1] + m)
            cum_size.append(_log2(cum[d]) // 8 + 1)
        records: List[bytes] = []
        stack = [(root, nroot, depth)] if root is not None and total else []
        while stack:
            node, nrec, d = stack.pop()
            c = _Cursor(self, node)
            kind = b"BTIN" if d else b"BTLF"
            c.expect(kind, "v2 B-tree node")
            pointers = (nrec + 1) * (self.O + nrec_size + (cum_size[d - 1] if d > 1 else 0)) if d else 0
            self.verify(node, 6 + nrec * rec_size + pointers, f"v2 B-tree node ({kind.decode()})")
            c.pos += 2
            records.extend(c.take(rec_size) for _ in range(nrec))
            for _ in range(nrec + 1 if d else 0):
                child, count = c.addr(), c.u(nrec_size)
                c.pos += cum_size[d - 1] if d > 1 else 0
                stack.append((child, count, d - 1))
        return records

    def heap(self, addr: int) -> "_FractalHeap":
        if addr not in self._heaps:
            self._heaps[addr] = _FractalHeap(self, addr)
        return self._heaps[addr]

    def dense(self, heap: int, btree: int, id_at: int, id_len: int) -> List[bytes]:
        """The objects a dense link or attribute index names: each record of
        the v2 B-tree holds a heap ID at ``id_at``."""
        h = self.heap(heap)
        return [h.object(r[id_at:id_at + id_len]) for r in self.btree2_records(btree)]

    # -- v4 chunk indexes: fixed and extensible arrays -----------------------------
    def fixed_array(self, addr: int) -> Tuple[int, List[Tuple[int, bytes]]]:
        """The element size of the fixed array at ``addr`` and its elements,
        as runs of ``(index of the first element, their bytes)``.  A data
        block of more than ``2**page_bits`` elements is split into pages, each
        with its checksum; a page never written (its bit clear in the block's
        bitmap, most significant bit first) is left out."""
        c = _Cursor(self, addr)
        c.expect(b"FAHD", "fixed array header")
        self.verify(addr, 8 + self.L + self.O, "fixed array header (FAHD)")
        c.pos += 2  # version, client
        es, page_bits, n, block = c.u(1), c.u(1), c.length(), c.addr()
        if block is None:
            return es, []
        _Cursor(self, block).expect(b"FADB", "fixed array data block")
        at, page = block + 6 + self.O, 1 << page_bits  # after signature, version, client, header address
        if n <= page:
            self.verify(block, at - block + n * es, "fixed array data block (FADB)")
            return es, [(0, self.buf[at:at + n * es])]
        npages = -(-n // page)
        bitmap = self.buf[at:at + (npages + 7) // 8]
        self.verify(block, at - block + len(bitmap), "fixed array data block (FADB)")
        runs, at = [], at + len(bitmap) + 4
        for p in range(npages):
            count = min(page, n - p * page)
            if bitmap[p // 8] & (0x80 >> (p % 8)):
                self.verify(at, count * es, "fixed array data block page")
                runs.append((p * page, self.buf[at:at + count * es]))
            at += page * es + 4
        return es, runs

    def extensible_array(self, addr: int) -> Tuple[int, List[Tuple[int, bytes]]]:
        """As :meth:`fixed_array`, for the extensible array at ``addr``: the
        index block's own elements, then data blocks by super block ``u``
        (``2**(u // 2)`` blocks of ``2**((u + 1) // 2) * min_elements``
        elements), the first super blocks' data blocks addressed from the
        index block, the rest through super blocks, whose bitmaps say which
        pages of a paged data block were written."""
        O = self.O
        c = _Cursor(self, addr)
        c.expect(b"EAHD", "extensible array header")
        self.verify(addr, 12 + 6 * self.L + O, "extensible array header (EAHD)")
        c.pos += 2  # version, client
        es, max_bits, index_elements, min_elements, min_pointers, page_bits = (c.u(1) for _ in range(6))
        c.pos += 6 * self.L  # statistics
        iblock = c.addr()
        if iblock is None:
            return es, []
        page, offset_size = 1 << page_bits, (max_bits + 7) // 8
        nsuper = 1 + max_bits - _log2(min_elements)
        blocks = [1 << (u // 2) for u in range(nsuper)]
        elements = [(1 << ((u + 1) // 2)) * min_elements for u in range(nsuper)]
        first = [index_elements]
        for u in range(nsuper - 1):
            first.append(first[-1] + blocks[u] * elements[u])
        in_index = 2 * _log2(min_pointers)  # super blocks whose data blocks the index block addresses
        ndirect = sum(blocks[:in_index])
        _Cursor(self, iblock).expect(b"EAIB", "extensible array index block")
        at = iblock + 6 + O
        self.verify(iblock, 6 + O + index_elements * es + (ndirect + nsuper - in_index) * O,
                    "extensible array index block (EAIB)")
        runs = [(0, self.buf[at:at + index_elements * es])]
        c = _Cursor(self, at + index_elements * es)
        direct = [c.addr() for _ in range(ndirect)]
        supers = [c.addr() for _ in range(nsuper - in_index)]
        for u in range(in_index):
            for k in range(blocks[u]):
                block = direct.pop(0)
                if block is not None:
                    runs += self._ea_data_block(block, first[u] + k * elements[u], elements[u], es, offset_size, page)
        for u, sblock in zip(range(in_index, nsuper), supers):
            if sblock is None:
                continue
            npages = elements[u] // page if elements[u] > page else 0
            bitmap_len = blocks[u] * ((npages + 7) // 8)
            _Cursor(self, sblock).expect(b"EASB", "extensible array super block")
            at = sblock + 6 + O + offset_size  # after signature, version, client, header address, block offset
            self.verify(sblock, at - sblock + bitmap_len + blocks[u] * O, "extensible array super block (EASB)")
            bitmap = self.buf[at:at + bitmap_len]
            c = _Cursor(self, at + bitmap_len)
            for k in range(blocks[u]):
                block = c.addr()
                if block is not None:
                    runs += self._ea_data_block(block, first[u] + k * elements[u], elements[u], es, offset_size,
                                                page, bitmap, k * npages)
        return es, runs

    def _ea_data_block(self, addr: int, start: int, n: int, es: int, offset_size: int, page: int,
                       bitmap: Optional[bytes] = None, bit: int = 0) -> List[Tuple[int, bytes]]:
        _Cursor(self, addr).expect(b"EADB", "extensible array data block")
        at = addr + 6 + self.O + offset_size  # after signature, version, client, header address, block offset
        if n <= page:
            self.verify(addr, at - addr + n * es, "extensible array data block (EADB)")
            return [(start, self.buf[at:at + n * es])]
        if bitmap is None:
            raise ValueError(f"HDF5 extensible array data block at {addr}: a paged block in the index block "
                             "is not supported")
        self.verify(addr, at - addr, "extensible array data block (EADB)")
        runs, at = [], at + 4
        for p in range(n // page):
            if bitmap[(bit + p) // 8] & (0x80 >> ((bit + p) % 8)):
                self.verify(at, page * es, "extensible array data block page")
                runs.append((start + p * page, self.buf[at:at + page * es]))
            at += page * es + 4
        return runs

    # -- the global heap (variable-length data) ------------------------------------
    def global_object(self, collection: int, index: int) -> Tuple[int, int]:
        objs = self._global.get(collection)
        if objs is None:
            c = _Cursor(self, collection)
            c.expect(b"GCOL", "global heap collection")
            c.pos += 4
            end = collection + c.length()
            objs = {}
            while c.pos + 8 + self.L <= end:
                idx = c.u(2)
                c.pos += 6
                size = c.length()
                if idx == 0:  # the collection's free space
                    break
                objs[idx] = (c.pos, size)
                c.pos += (size + 7) & ~7
            self._global[collection] = objs
        return objs[index]

    # -- messages ------------------------------------------------------------------
    def datatype(self, buf, pos: int) -> _Type:
        b0, bits, size = buf[pos], _u(buf, pos + 1, 3), _u(buf, pos + 4, 4)
        cls = b0 & 0x0F
        order = ">" if bits & 1 else "<"
        if cls == 0 and size in (1, 2, 4, 8):
            return _Type(f"{order}{'i' if bits & 0x08 else 'u'}{size}", size)
        if cls == 1 and size in (2, 4, 8) and not bits & 0x40:
            return _Type(f"{order}f{size}", size)
        if cls == 3:
            return _Type(f"S{size}", size, pad=bits & 0x0F)
        if cls == 9 and bits & 0x0F == 1:
            return _Type(object, size, vlen=True)
        what = {0: f"{size}-byte integer", 1: f"{size}-byte float", 9: "variable-length sequence"}.get(
            cls, _CLASS_NAMES.get(cls, f"class {cls}"))
        raise ValueError(f"HDF5 datatype {what} is not supported")

    def dataspace(self, buf, pos: int, maximum: bool = False) -> Optional[Tuple[int, ...]]:
        """The shape (``()`` for a scalar), ``None`` for a null dataspace;
        with ``maximum``, the maximum shape (``None`` for an unlimited axis)."""
        version, rank, flags = buf[pos], buf[pos + 1], buf[pos + 2]
        if version == 1:
            pos += 8
        elif version == 2:
            if buf[pos + 3] == 2:
                return None
            pos += 4
        else:
            raise ValueError(f"HDF5 dataspace version {version} is not supported")
        if maximum and flags & 1:  # the maximum dimensions follow the dimensions
            pos += rank * self.L
            dims = [_u(buf, pos + i * self.L, self.L) for i in range(rank)]
            return tuple(None if d == (1 << (8 * self.L)) - 1 else d for d in dims)
        return tuple(_u(buf, pos + i * self.L, self.L) for i in range(rank))

    def values(self, t: _Type, shape, buf, pos: int):
        """The array of ``prod(shape)`` elements of type ``t`` stored at
        ``pos`` of ``buf`` (variable-length strings as ``str``)."""
        n = int(np.prod(shape, dtype=np.int64))
        if t.vlen:
            out = np.empty(n, object)
            for i in range(n):
                c = _Cursor(self, pos + i * t.size, buf)
                length, collection, index = c.u(4), c.addr(), c.u(4)
                raw = b""
                if length:
                    at, _ = self.global_object(collection, index)
                    raw = self.buf[at:at + length]
                out[i] = raw.decode("utf-8")
            return out.reshape(shape)
        arr = np.frombuffer(buf, t.dtype, n, pos).reshape(shape).copy()
        if t.pad == 0:  # null-terminated: the string ends at its first null
            arr = np.array([s.split(b"\0", 1)[0] for s in arr.ravel()], t.dtype).reshape(shape)
        elif t.pad == 2:  # space-padded
            arr = np.array([s.rstrip(b" ") for s in arr.ravel()], t.dtype).reshape(shape)
        return arr

    def attribute(self, buf, pos: int):
        """``(name, type, shape, data position)`` of an attribute message."""
        version, flags = buf[pos], buf[pos + 1]
        nlen, tlen, slen = _u(buf, pos + 2, 2), _u(buf, pos + 4, 2), _u(buf, pos + 6, 2)
        if version not in (1, 2, 3):
            raise ValueError(f"HDF5 attribute message version {version} is not supported")
        if version > 1 and flags & 3:
            raise ValueError("HDF5 attributes with a shared (committed) datatype or dataspace are not supported")
        pos += 9 if version == 3 else 8

        def pad(n):
            return (n + 7) & ~7 if version == 1 else n

        name = bytes(buf[pos:pos + nlen]).split(b"\0", 1)[0].decode("utf-8")
        pos += pad(nlen)
        t = self.datatype(buf, pos)
        pos += pad(tlen)
        shape = self.dataspace(buf, pos)
        return name, t, shape, pos + pad(slen)


class _FractalHeap:
    """A fractal heap's header and the lookup of an object by heap ID."""

    def __init__(self, f: _Store, addr: int):
        self.f = f
        c = _Cursor(f, addr)
        c.expect(b"FRHP", "fractal heap header")
        c.pos += 1
        self.id_len, filters, flags = c.u(2), c.u(2), c.u(1)
        f.verify(addr, 22 + 12 * f.L + 3 * f.O + (f.L + 4 + filters if filters else 0),
                 "fractal heap header (FRHP)")
        self.checksummed = bool(flags & 0x02)  # the direct blocks carry a checksum
        max_managed = c.u(4)
        c.pos += f.L + f.O + f.L + f.O + 8 * f.L  # huge-object and free-space bookkeeping, counters
        self.width, self.start, max_direct = c.u(2), c.length(), c.length()
        max_heap_bits = c.u(2)
        c.pos += 2
        self.root, self.rows = c.addr(), c.u(2)
        if filters:
            raise ValueError("HDF5 fractal heaps with I/O filters are not supported")
        self.off_size = (max_heap_bits + 7) // 8
        self.len_size = min((_log2(max_direct) + 7) // 8, _log2(max_managed) // 8 + 1)
        self.max_direct_rows = _log2(max_direct) - _log2(self.start) + 2

    def object(self, hid: bytes) -> bytes:
        kind = (hid[0] >> 4) & 3
        if hid[0] >> 6:
            raise ValueError(f"HDF5 fractal heap ID version {hid[0] >> 6} is not supported")
        if kind == 0:  # managed: an offset into the heap's address space and a length
            off = int.from_bytes(hid[1:1 + self.off_size], "little")
            n = int.from_bytes(hid[1 + self.off_size:1 + self.off_size + self.len_size], "little")
            if self.rows == 0:  # the root is a direct block of the starting size
                block, size, at = self.root, self.start, self.root + off
            else:
                block, size, at = self._locate(self.root, self.rows, 0, off)
            if self.checksummed:
                self.f.verify(block, size, "fractal heap direct block (FHDB)",
                              zeroed=block + 5 + self.f.O + self.off_size)
            return self.f.take(at, n, "fractal heap object")
        if kind == 2:  # tiny: the object is inside the ID
            if self.id_len <= 18:
                return hid[1:2 + (hid[0] & 0x0F)]
            return hid[2:3 + (((hid[0] & 0x0F) << 8) | hid[1])]
        raise ValueError("HDF5 huge fractal-heap objects are not supported")

    def _row_size(self, row: int) -> int:
        return self.start if row == 0 else self.start << (row - 1)

    def _locate(self, addr: int, rows: int, base: int, off: int) -> Tuple[int, int, int]:
        """``(direct block, its size, file position)`` of heap offset ``off``
        under the indirect block at ``addr`` whose address space starts at
        ``base``."""
        f = self.f
        _Cursor(f, addr).expect(b"FHIB", "fractal heap indirect block")
        entries = addr + 5 + f.O + self.off_size  # signature, version, heap header address, block offset
        f.verify(addr, entries + rows * self.width * f.O - addr, "fractal heap indirect block (FHIB)")
        start = base
        for row in range(rows):
            size = self._row_size(row)
            for col in range(self.width):
                if start <= off < start + size:
                    child = f.address(_u(f.buf, entries + (row * self.width + col) * f.O, f.O))
                    if child is None:
                        raise ValueError(f"HDF5 fractal heap offset {off} lies in an unallocated block")
                    if row < self.max_direct_rows:
                        return child, size, child + (off - start)
                    sub_rows = _log2(size) - _log2(self.start * self.width) + 1
                    return self._locate(child, sub_rows, start, off)
                start += size
        raise ValueError(f"HDF5 fractal heap offset {off} lies outside the heap")


class Attributes(Mapping):
    """An object's attributes, by name (h5py's order: bytewise by name)."""

    def __init__(self, f: _Store, msgs):
        self._f = f
        found = [(f.buf, pos) for mtype, pos, _ in msgs if mtype == _ATTRIBUTE]
        for mtype, pos, _ in msgs:
            if mtype == _ATTRIBUTE_INFO:
                c = _Cursor(f, pos + 1)
                flags = c.u(1)
                c.pos += 2 if flags & 1 else 0
                heap, btree = c.addr(), c.addr()
                if heap is not None:  # dense: records of heap ID (8), flags, creation order, name hash
                    found += [(obj, 0) for obj in f.dense(heap, btree, 0, 8)]
        parsed = [f.attribute(buf, pos) + (buf,) for buf, pos in found]
        self._attrs = {a[0]: a[1:] for a in sorted(parsed, key=lambda a: a[0].encode("utf-8"))}

    def __getitem__(self, name: str):
        t, shape, pos, buf = self._attrs[name]
        if shape is None:
            return Empty(t.dtype)
        arr = self._f.values(t, shape, buf, pos)
        return arr[()] if arr.ndim == 0 else arr

    def __iter__(self):
        return iter(self._attrs)

    def __len__(self):
        return len(self._attrs)


class _Object:
    def __init__(self, f: _Store, name: str, msgs):
        self._f, self.name, self._msgs = f, name, msgs
        self._attrs: Optional[Attributes] = None

    @property
    def attrs(self) -> Attributes:
        if self._attrs is None:
            self._attrs = Attributes(self._f, self._msgs)
        return self._attrs

    def _first(self, *types):
        return next(((t, pos, flags) for t, pos, flags in self._msgs if t in types), None)


class Group(_Object, Mapping):
    """A group: its members by ``/``-separated path."""

    _links: Optional[Dict[str, Optional[int]]] = None

    def _members(self) -> Dict[str, Optional[int]]:
        if self._links is None:
            f, links = self._f, {}
            for mtype, pos, _ in self._msgs:
                if mtype == _SYMBOL_TABLE:
                    c = _Cursor(f, pos)
                    links.update(f.symbol_table(c.addr(), c.addr()))
                elif mtype == _LINK:
                    links.update([_link(f, f.buf, pos)])
                elif mtype == _LINK_INFO:
                    c = _Cursor(f, pos + 1)
                    flags = c.u(1)
                    c.pos += 8 if flags & 1 else 0
                    heap, btree = c.addr(), c.addr()
                    if heap is not None:  # dense: records of name hash (4) and heap ID (7)
                        links.update(_link(f, obj, 0) for obj in f.dense(heap, btree, 4, 7))
            self._links = dict(sorted(links.items(), key=lambda kv: kv[0].encode("utf-8")))
        return self._links

    def __getitem__(self, path: str):
        node = self._f.node(self._f.root, "/") if path.startswith("/") else self
        for part in (p for p in path.split("/") if p):
            if not isinstance(node, Group) or part not in node._members():
                raise KeyError(path)
            addr = node._members()[part]
            if addr is None:
                raise ValueError(f"HDF5 soft and external links are not supported ({path!r})")
            node = self._f.node(addr, f"{node.name.rstrip('/')}/{part}")
        return node

    def __iter__(self):
        return iter(self._members())

    def __len__(self):
        return len(self._members())

    def __repr__(self):
        return f"<HDF5 group {self.name!r} ({len(self)} members)>"


def _link(f: _Store, buf, pos: int) -> Tuple[str, Optional[int]]:
    """``(name, object address)`` of a link message (``None`` for a soft or
    external link)."""
    c = _Cursor(f, pos + 1, buf)
    flags = c.u(1)
    kind = c.u(1) if flags & 0x08 else 0
    c.pos += (8 if flags & 0x04 else 0) + (1 if flags & 0x10 else 0)
    name = c.take(c.u(1 << (flags & 3))).decode("utf-8")
    return name, c.addr() if kind == 0 else None


class Dataset(_Object):
    """A dataset; ``ds[()]`` reads all of it."""

    @property
    def shape(self) -> Optional[Tuple[int, ...]]:
        _, pos, _ = self._first(_DATASPACE)
        return self._f.dataspace(self._f.buf, pos)

    @property
    def dtype(self) -> np.dtype:
        return self._type().dtype

    def _type(self) -> _Type:
        _, pos, flags = self._first(_DATATYPE)
        if flags & 0x02:
            raise ValueError("HDF5 datasets of a shared (committed) datatype are not supported")
        t = self._f.datatype(self._f.buf, pos)
        if t.vlen:
            raise ValueError("HDF5 variable-length string datasets are not supported")
        return t

    def __getitem__(self, key):
        if key != ():
            raise ValueError("only ds[()] (the whole dataset) is supported")
        f, t, shape = self._f, self._type(), self.shape
        if shape is None:
            return Empty(t.dtype)
        _, pos, _ = self._first(_LAYOUT)
        version, cls = f.buf[pos], f.buf[pos + 1]
        if version not in (3, 4):
            raise ValueError(f"HDF5 data layout version {version} is not supported")
        c = _Cursor(f, pos + 2)
        if cls == 0:  # compact: the data is in the message
            size = c.u(2)
            raw, at = f.buf, c.pos
        elif cls == 1:  # contiguous
            addr = c.addr()
            if addr is None:  # never written
                return self._filled(t, shape)
            raw, at = f.buf, addr
        elif cls == 2:
            return self._chunked(version, c, t, shape)
        else:
            raise ValueError(f"HDF5 data layout class {cls} (virtual) is not supported")
        arr = f.values(t, shape, raw, at)
        return arr[()] if arr.ndim == 0 else arr

    def _fill(self, t: _Type) -> bytes:
        """One element of the fill value (zeros where none is defined)."""
        msg = self._first(_FILL, _FILL_OLD)
        raw = b""
        if msg is not None:
            mtype, pos, _ = msg
            c = _Cursor(self._f, pos)
            if mtype == _FILL_OLD:
                raw = c.take(c.u(4))
            else:
                version = c.u(1)
                defined = c.u(1) & 0x20 if version == 3 else (c.u(2), c.u(1))[1]
                if defined or version == 1:
                    raw = c.take(c.u(4))
        return raw if len(raw) == t.size else bytes(t.size)

    def _filled(self, t: _Type, shape) -> np.ndarray:
        n = int(np.prod(shape, dtype=np.int64))
        arr = self._f.values(t, (n,), self._fill(t) * n, 0).reshape(shape)
        return arr[()] if arr.ndim == 0 else arr

    @property
    def maxshape(self) -> Optional[Tuple[Optional[int], ...]]:
        _, pos, _ = self._first(_DATASPACE)
        return self._f.dataspace(self._f.buf, pos, maximum=True)

    def _chunked(self, version: int, c: _Cursor, t: _Type, shape) -> np.ndarray:
        """A chunked dataset: the fill value where no chunk was written, and
        each written chunk through the filter pipeline into its place."""
        f, filters = self._f, self._filters()
        if version == 3:  # a v1 B-tree keyed by each chunk's size, filter mask and element offsets
            rank = c.u(1)
            btree = c.addr()
            chunk = tuple(c.u(4) for _ in range(rank))[:-1]  # the last is the element size
            flags, chunks = 0, [
                (tuple(_u(f.buf, key + 8 + 8 * i, 8) for i in range(rank - 1)), addr, _u(f.buf, key, 4),
                 _u(f.buf, key + 4, 4))
                for key, addr in ([] if btree is None else f.btree1_leaves(btree, 8 + 8 * rank))]
        else:  # v4: dimensions of an encoded width, then one of five chunk indexes keyed by scaled offsets
            flags, rank, width = c.u(1), c.u(1), c.u(1)
            chunk = tuple(c.u(width) for _ in range(rank))[:-1]
            chunks = [(tuple(s * n for s, n in zip(scaled, chunk)), addr, size, mask)
                      for scaled, addr, size, mask in self._v4_chunks(c, flags, chunk, t)]
        out = np.frombuffer(self._fill(t), t.dtype).repeat(int(np.prod(shape, dtype=np.int64))).reshape(shape)
        for offsets, addr, size, mask in chunks:
            raw = f.take(addr, size, f"chunk of {self.name!r} at {offsets}")
            edge = any(o + n > s for o, n, s in zip(offsets, chunk, shape))
            if filters and not (edge and flags & 0x01):  # bit 0: partial edge chunks are stored unfiltered
                raw = self._unfilter(raw, filters, mask, t, offsets)
            self._place(out, raw, t, chunk, offsets)
        if t.pad is not None:  # strings: the padding rules of values()
            out = f.values(t, shape, out.tobytes(), 0)
        return out[()] if out.ndim == 0 else out

    def _v4_chunks(self, c: _Cursor, flags: int, chunk, t: _Type) -> List[Tuple[Tuple[int, ...], int, int, int]]:
        """``(scaled offsets, address, stored size, filter mask)`` of every
        written chunk, from the chunk index of a v4 layout message whose
        index type ``c`` points at.  The fixed and extensible arrays hold
        one element a chunk of the dataset's maximum chunk grid, row-major,
        the extensible array's unlimited axis moved first."""
        f = self._f
        kind, nbytes = c.u(1), int(np.prod(chunk, dtype=np.int64)) * t.size
        grid = [None if m is None else -(-m // n) for m, n in zip(self.maxshape, chunk)]
        if kind == 1:  # single chunk: the address in the message (bit 1: with its size and filter mask)
            size, mask = (c.length(), c.u(4)) if flags & 0x02 else (nbytes, 0)
            addr = c.addr()
            return [] if addr is None else [((0,) * len(chunk), addr, size, mask)]
        if kind == 2:  # implicit: unfiltered chunks in order from one address
            addr = c.addr()
            if addr is None:
                return []
            return [(scaled, addr + int(np.ravel_multi_index(scaled, grid)) * nbytes, nbytes, 0)
                    for scaled in np.ndindex(*(-(-s // n) for s, n in zip(self.shape, chunk)))]
        if kind in (3, 4):
            c.pos += 1 if kind == 3 else 5  # array parameters: the array's header holds them too
            addr = c.addr()
            if addr is None:
                return []
            es, runs = f.fixed_array(addr) if kind == 3 else f.extensible_array(addr)
            return self._array_chunks(runs, es, nbytes, grid)
        if kind == 5:  # v2 B-tree: records of type 10 (address, scaled offsets) or 11 (filtered)
            c.pos += 6  # node size, split and merge percents: the header holds them too
            addr = c.addr()
            if addr is None:
                return []
            records = f.btree2_records(addr)
            filtered, O, r = f.buf[addr + 5] == 11, f.O, len(chunk)
            out = []
            for rec in records:
                n = len(rec) - O - 4 - 8 * r if filtered else 0
                size, mask = (_u(rec, O, n), _u(rec, O + n, 4)) if filtered else (nbytes, 0)
                at = O + (n + 4 if filtered else 0)
                addr = f.address(_u(rec, 0, O))
                if addr is not None:
                    out.append((tuple(_u(rec, at + 8 * i, 8) for i in range(r)), addr, size, mask))
            return out
        raise ValueError(f"HDF5 chunk index type {kind} is not supported")

    def _array_chunks(self, runs, es: int, nbytes: int, grid) -> List[Tuple[Tuple[int, ...], int, int, int]]:
        """The written chunks among a fixed or extensible array's elements:
        an address, then (filtered, when the element is wider) the stored
        size and the filter mask.  Element ``i`` is the chunk at ``i`` in
        ``grid``'s row-major order, its unlimited axis (if any) first."""
        f, O = self._f, self._f.O
        unlimited = [i for i, g in enumerate(grid) if g is None]
        order = unlimited + [i for i, g in enumerate(grid) if g is not None]
        rest = [grid[i] for i in order[1:]]
        out = []
        for start, raw in runs:
            cols = np.frombuffer(raw, np.uint8).reshape(-1, es)
            addrs = _le_uints(cols[:, :O])
            written = np.nonzero(addrs != np.uint64((1 << (8 * O)) - 1))[0]
            if not len(written):
                continue
            sizes = _le_uints(cols[written, O:es - 4]) if es > O else np.full(len(written), nbytes)
            masks = _le_uints(cols[written, es - 4:]) if es > O else np.zeros(len(written))
            index = written.astype(np.int64) + start
            swizzled = [index // int(np.prod(rest, dtype=np.int64))]
            swizzled += list(np.unravel_index(index % int(np.prod(rest, dtype=np.int64)), rest)) if rest else []
            scaled = np.empty((len(index), len(grid)), np.int64)
            for axis, coords in zip(order, swizzled):
                scaled[:, axis] = coords
            out += [(tuple(map(int, sc)), int(a) + f.base, int(n), int(m))
                    for sc, a, n, m in zip(scaled, addrs[written], sizes, masks)]
        return out

    def _unfilter(self, raw: bytes, filters, mask: int, t: _Type, offsets) -> bytes:
        """A chunk's stored bytes through the filter pipeline, last filter
        first; bit ``i`` of ``mask`` set skips filter ``i``."""
        for i, (fid, values) in reversed(list(enumerate(filters))):
            if mask & (1 << i):
                continue
            if fid == 1:
                try:
                    raw = zlib.decompress(raw)
                except zlib.error as e:
                    raise ValueError(f"HDF5 dataset {self.name!r}: the chunk at {offsets} is not a valid deflate "
                                     f"stream ({e})") from None
            elif fid == 2:  # shuffle: byte k of every element, then byte k + 1, ...
                es = values[0] if values else t.size
                n = len(raw) // es
                planes, elements = np.frombuffer(raw, np.uint8, n * es).reshape(es, n), np.empty((n, es), np.uint8)
                for k in range(es):  # a plane at a time, each read contiguously
                    elements[:, k] = planes[k]
                raw = elements.tobytes() + raw[n * es:]
            elif fid == 3:  # fletcher32: a checksum after the data
                if len(raw) < 4 or not _fletcher_ok(raw):
                    raise ValueError(f"HDF5 dataset {self.name!r}: the chunk at {offsets} fails its Fletcher-32 "
                                     "checksum")
                raw = raw[:-4]
        return raw

    def _place(self, out: np.ndarray, raw: bytes, t: _Type, chunk, offsets) -> None:
        """Put a decoded chunk whose first element is at ``offsets`` into
        ``out``, cut where it passes the dataset's edge."""
        n = int(np.prod(chunk, dtype=np.int64))
        if len(raw) < n * t.size:
            raise ValueError(f"HDF5 dataset {self.name!r}: the chunk at {offsets} holds {len(raw)} bytes, "
                             f"not {n * t.size}")
        block = np.frombuffer(raw, t.dtype, n).reshape(chunk)
        dst = tuple(slice(o, min(o + k, s)) for o, k, s in zip(offsets, chunk, out.shape))
        out[dst] = block[tuple(slice(0, max(d.stop - d.start, 0)) for d in dst)]

    def _filters(self) -> List[Tuple[int, List[int]]]:
        msg = self._first(_FILTERS)
        if msg is None:
            return []
        c = _Cursor(self._f, msg[1])
        version, count = c.u(1), c.u(1)
        c.pos += 6 if version == 1 else 0
        out = []
        for _ in range(count):
            fid = c.u(2)
            name_len = c.u(2) if version == 1 or fid >= 256 else 0
            c.pos += 2
            nvalues = c.u(2)
            c.pos += (name_len + 7) & ~7 if version == 1 else name_len
            values = [c.u(4) for _ in range(nvalues)]
            c.pos += 4 if version == 1 and nvalues % 2 else 0
            if fid not in (1, 2, 3):
                raise ValueError(f"HDF5 filter {_FILTER_NAMES.get(fid, fid)} is not supported")
            out.append((fid, values))
        return out

    def __repr__(self):
        return f"<HDF5 dataset {self.name!r}: shape {self.shape}, type {self.dtype}>"


class File(Group):
    """An HDF5 file, read-only: the root group.  Use as a context manager,
    or call :meth:`close`; arrays read from it are copies and outlive it."""

    def __init__(self, path: str):
        f = _Store(os.fspath(path))
        super().__init__(f, "/", f.messages(f.root))

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# Writing (h5py's default format)
# ---------------------------------------------------------------------------
_UNDEF = b"\xff" * 8
_LEAF_K, _NODE_K = 4, 16  # symbol-table nodes hold 2 * 4 entries, B-tree nodes 2 * 16 children
_SNOD_SIZE = 8 + 2 * _LEAF_K * 40
_TREE_SIZE = 24 + 2 * _NODE_K * 8 + (2 * _NODE_K + 1) * 8


def _pad8(b: bytes) -> bytes:
    return b + bytes(-len(b) % 8)


def _encode_type(dtype: np.dtype) -> bytes:
    """A v1 datatype message for a number or a fixed-length null-padded
    string."""
    big = 1 if dtype.byteorder == ">" else 0
    if dtype.kind == "S":
        return struct.pack("<BBHI", 0x13, 1, 0, dtype.itemsize)
    if dtype.kind in "iu" and dtype.itemsize in (1, 2, 4, 8):
        signed = 0x08 if dtype.kind == "i" else 0
        return struct.pack("<BBHIHH", 0x10, big | signed, 0, dtype.itemsize, 0, 8 * dtype.itemsize)
    if dtype.kind == "f" and dtype.itemsize in (2, 4, 8):
        exp_size, mant_size = {2: (5, 10), 4: (8, 23), 8: (11, 52)}[dtype.itemsize]
        bits = 8 * dtype.itemsize
        return struct.pack("<BBBBIHHBBBBI", 0x11, big | 0x20, bits - 1, 0, dtype.itemsize, 0, bits,
                           mant_size, exp_size, 0, mant_size, (1 << (exp_size - 1)) - 1)
    raise TypeError(f"cannot write an HDF5 value of dtype {dtype}")


def _encode_space(shape: Tuple[int, ...]) -> bytes:
    """A v1 dataspace message (the maximum dimensions equal the dimensions)."""
    return struct.pack("<BBBB4x", 1, len(shape), 1 if shape else 0, 0) + struct.pack(
        f"<{2 * len(shape)}Q", *shape, *shape)


def _as_value(value) -> np.ndarray:
    if isinstance(value, str):
        value = value.encode("utf-8")
    arr = np.asarray(value)
    if arr.dtype.kind == "U":
        arr = np.array([s.encode("utf-8") for s in arr.ravel()], "S").reshape(arr.shape)
    if arr.dtype.kind == "S" and arr.dtype.itemsize == 0:
        arr = arr.astype("S1")
    _encode_type(arr.dtype)  # refuses what it cannot write
    return arr


class _WGroup:
    def __init__(self):
        self.attrs: Dict[str, np.ndarray] = _WAttrs()
        self.members: Dict[str, object] = {}

    def _walk(self, path: str, create: bool) -> Tuple["_WGroup", str]:
        parts = [p for p in path.split("/") if p]
        if not parts:
            raise ValueError(f"empty HDF5 path {path!r}")
        g = self
        for p in parts[:-1]:
            if p not in g.members and create:
                g.members[p] = _WGroup()
            g = g.members[p]
            if not isinstance(g, _WGroup):
                raise ValueError(f"{path!r}: {p!r} is a dataset")
        if parts[-1] in g.members:
            raise ValueError(f"{path!r} already exists")
        return g, parts[-1]

    def create_group(self, path: str) -> "_WGroup":
        """A new group at ``path``, intermediate groups created."""
        g, name = self._walk(path, create=True)
        g.members[name] = _WGroup()
        return g.members[name]

    def create_dataset(self, path: str, data) -> None:
        """A contiguous dataset holding ``data`` (kept by reference until
        the file is closed)."""
        arr = np.asarray(data)
        _encode_type(arr.dtype)
        g, name = self._walk(path, create=True)
        g.members[name] = arr


class _WAttrs(dict):
    """Attribute values, encoded (and checked) as they are set."""

    def __setitem__(self, name: str, value) -> None:
        arr = _as_value(value)
        size = len(_pad8(_attribute_message(name, arr)))
        if size > _MAX_MESSAGE:  # h5py raises past it too, and at its very edge writes a file it cannot open
            raise ValueError(f"attribute {name!r} takes {size} bytes: an HDF5 object header message "
                             f"holds at most {_MAX_MESSAGE}")
        super().__setitem__(name, arr)


def _attribute_message(name: str, arr: np.ndarray) -> bytes:
    """A v1 attribute message: its name, datatype and dataspace each padded
    to 8 bytes, then the data."""
    bname, dtype, space = name.encode("utf-8") + b"\0", _encode_type(arr.dtype), _encode_space(arr.shape)
    return (struct.pack("<BBHHH", 1, 0, len(bname), len(dtype), len(space)) + _pad8(bname) + _pad8(dtype)
            + _pad8(space) + arr.tobytes())


class Writer(_WGroup):
    """Write an HDF5 file in h5py's default format: ``create_group``,
    ``create_dataset`` and ``attrs[name] = value`` as with h5py, the file
    written when the writer is closed (``with Writer(path) as f: ...``).

    Attributes take numbers, numeric arrays, ``bytes``/``str`` and lists of
    them (fixed-length null-padded strings, as Keras'
    ``save_attributes_to_hdf5_group`` writes); an attribute of more than
    64 KB raises ``ValueError``.  Datasets are contiguous, in their arrays'
    byte order.  Names are stored sorted bytewise in every symbol-table node
    and B-tree key, as the library's binary search needs.
    """

    def __init__(self, path: str):
        super().__init__()
        self.path = os.fspath(path)

    def __enter__(self) -> "Writer":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        if exc_type is None:
            self.close()

    def close(self) -> None:
        with open(self.path, "wb") as fh:
            out = _Layout(fh, start=96)
            root, btree, heap = out.group(self)
            out.write(0, SIGNATURE + struct.pack("<BBBBBBBBHHI", 0, 0, 0, 0, 0, 8, 8, 0, _LEAF_K, _NODE_K, 0)
                      + struct.pack("<Q", 0) + _UNDEF + struct.pack("<Q", out.eof) + _UNDEF
                      + struct.pack("<QQII", 0, root, 1, 0) + struct.pack("<QQ", btree, heap))


class _Layout:
    """Objects written one after the other: each group after its members."""

    def __init__(self, fh, start: int):
        self.fh, self.eof = fh, start

    def write(self, addr: int, data) -> None:
        self.fh.seek(addr)
        self.fh.write(data)

    def alloc(self, data) -> int:
        addr = self.eof
        self.write(addr, data)
        self.eof += len(data)  # bytes, or a 1-d uint8 view of an array
        return addr

    def header(self, messages: List[Tuple[int, bytes]]) -> int:
        """A v1 object header."""
        body = b"".join(struct.pack("<HHB3x", t, len(_pad8(d)), 0) + _pad8(d) for t, d in messages)
        return self.alloc(struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body)

    def dataset(self, arr: np.ndarray) -> int:
        arr = np.asarray(arr, order="C")  # ascontiguousarray would make a scalar 1-d
        addr = self.alloc(arr.reshape(-1).view(np.uint8)) if arr.nbytes else None
        layout = struct.pack("<BB", 3, 1) + (_UNDEF if addr is None else struct.pack("<Q", addr)) + struct.pack(
            "<Q", arr.nbytes)
        return self.header([(_DATASPACE, _encode_space(arr.shape)), (_DATATYPE, _encode_type(arr.dtype)),
                            (_FILL, struct.pack("<BBBB", 2, 2, 2, 0)), (_LAYOUT, layout)])

    def group(self, g: _WGroup) -> Tuple[int, int, int]:
        """Write ``g`` and its members; ``(object header, B-tree, local heap)``."""
        entries = []  # (name bytes, heap offset, object header, cache type, scratch)
        heap = bytearray(8)  # offset 0: the empty name the B-tree's first key points at
        for name in sorted(g.members, key=lambda n: n.encode("utf-8")):
            member = g.members[name]
            if isinstance(member, _WGroup):
                obj, btree, lheap = self.group(member)
                cache, scratch = 1, struct.pack("<QQ", btree, lheap)
            else:
                obj, cache, scratch = self.dataset(member), 0, bytes(16)
            entries.append((len(heap), obj, cache, scratch))
            heap += _pad8(name.encode("utf-8") + b"\0")
        heap_addr = self.alloc(b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap), 1, self.eof + 32) + bytes(heap))
        # symbol-table nodes of at most 2K entries, then B-tree levels of at
        # most 2K children; each key names the last entry of the subtree on its left
        nodes = []  # (address, heap offset of its last name)
        for i in range(0, len(entries), 2 * _LEAF_K):
            chunk = entries[i:i + 2 * _LEAF_K]
            body = b"".join(struct.pack("<QQII", off, obj, cache, 0) + scratch for off, obj, cache, scratch in chunk)
            snod = b"SNOD" + struct.pack("<BBH", 1, 0, len(chunk)) + body
            nodes.append((self.alloc(snod + bytes(_SNOD_SIZE - len(snod))), chunk[-1][0]))
        level = 0
        while True:
            groups = [nodes[i:i + 2 * _NODE_K] for i in range(0, len(nodes), 2 * _NODE_K)] or [[]]
            addrs = [self.eof + j * _TREE_SIZE for j in range(len(groups))]
            for j, children in enumerate(groups):
                left = struct.pack("<Q", addrs[j - 1]) if j else _UNDEF
                right = struct.pack("<Q", addrs[j + 1]) if j + 1 < len(groups) else _UNDEF
                body = struct.pack("<Q", 0) + b"".join(struct.pack("<QQ", a, last) for a, last in children)
                node = b"TREE" + struct.pack("<BBH", 0, level, len(children)) + left + right + body
                self.alloc(node + bytes(_TREE_SIZE - len(node)))
            if len(groups) == 1:
                btree = addrs[0]
                break
            nodes = [(a, children[-1][1]) for a, children in zip(addrs, groups)]
            level += 1
        messages = [(_SYMBOL_TABLE, struct.pack("<QQ", btree, heap_addr))]
        messages += [(_ATTRIBUTE, _attribute_message(k, v)) for k, v in g.attrs.items()]
        return self.header(messages), btree, heap_addr
