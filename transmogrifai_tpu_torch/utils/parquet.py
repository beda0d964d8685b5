"""Apache Parquet files in Python and numpy (the work ``pd.read_parquet``
and ``DataFrame.to_parquet`` do for the JAX package; the card has neither
pandas nor pyarrow, so the port speaks the format itself, as
``utils.avro`` speaks Avro).

Read: the Thrift compact protocol of the footer and page headers; data
pages v1 and v2 and dictionary pages; the codecs UNCOMPRESSED, SNAPPY and
GZIP (any other raises ``ParquetError`` naming the codec and the file);
the encodings PLAIN, PLAIN_DICTIONARY / RLE_DICTIONARY and the
RLE/bit-packed hybrid (levels, dictionary indices, RLE booleans), any
other raising by name; optional and required columns, groups (structs),
the 3-level ``LIST`` and the legacy 2-level list; the logical types
String/UTF8, the INT widths, FLOAT16, DATE, TIME and TIMESTAMP (ms, us,
ns). A directory reads as pyarrow's dataset reads it: its data files (not
those whose name starts with ``_`` or ``.``) in the order of their sorted
paths, the columns of each concatenated, and each hive-style
``key=value`` directory level a column after the files' own.

``read_parquet`` gives each column as ``pd.read_parquet`` gives it (pandas
3 on pyarrow):

- int64 (or a narrower int) with a null is float64 with NaN; bool with a
  null is an object column of True/False/None; a string column is an
  object column whose nulls are NaN; binary, DATE (``datetime.date``)
  and null-typed columns are object columns with None;
- FLOAT16 is float16 with NaN; TIME is an object column of
  ``datetime.time`` with None;
- a hive partition column is an object column of the directories' value
  strings, or int32 where every value is an int32 (pandas reads it as a
  category, and this is its ``to_numpy()``);
- TIMESTAMP is ``datetime64[unit]`` with NaT (a UTC-adjusted one too:
  numpy has no time zone);
- a struct is a dict holding every key of the struct (a null field
  None, ints of a field that has a null or a null struct as floats), a
  null struct None;
- a list is a numpy array typed as a column is typed (ints with a null
  element float64, strings and bools with a null element objects with
  None), an empty list an empty array, a null list None.

A column named in the ``pandas`` metadata's ``index_columns`` is the
frame's index there and is left out here.

Write (``write_parquet``): one row group per ``ROW_GROUP_ROWS`` rows, one
data page v1 per column chunk (dictionary-encoded behind a dictionary
page where a leaf holds few distinct values, ``DICT_MAX``, else PLAIN),
levels in the hybrid encoding, the
schema pyarrow infers from the frame (optional primitives, ``String``
for text, a struct over the union of a dict column's keys in the order
they first appear, a 3-level ``LIST`` for list columns, a null column as
INT32 ``Null``), and the ``pandas`` key-value metadata, so that
``pd.read_parquet`` restores a RangeIndex (or the index given).
Snappy by default (``compression="snappy"``), or ``None``.
"""
from __future__ import annotations

import datetime
import json
import math
import os
import struct
import zlib
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

MAGIC = b"PAR1"

# ---------------------------------------------------------------------------
# Parquet's enums (parquet.thrift)
# ---------------------------------------------------------------------------

BOOLEAN, INT32, INT64, INT96, FLOAT, DOUBLE, BYTE_ARRAY, FIXED = range(8)
TYPE_NAMES = ("BOOLEAN", "INT32", "INT64", "INT96", "FLOAT", "DOUBLE",
              "BYTE_ARRAY", "FIXED_LEN_BYTE_ARRAY")
REQUIRED, OPTIONAL, REPEATED = 0, 1, 2
CODECS = {0: "UNCOMPRESSED", 1: "SNAPPY", 2: "GZIP", 3: "LZO",
          4: "BROTLI", 5: "LZ4", 6: "ZSTD", 7: "LZ4_RAW"}
ENCODINGS = {0: "PLAIN", 2: "PLAIN_DICTIONARY", 3: "RLE", 4: "BIT_PACKED",
             5: "DELTA_BINARY_PACKED", 6: "DELTA_LENGTH_BYTE_ARRAY",
             7: "DELTA_BYTE_ARRAY", 8: "RLE_DICTIONARY",
             9: "BYTE_STREAM_SPLIT"}
PLAIN, PLAIN_DICTIONARY, RLE, RLE_DICTIONARY = 0, 2, 3, 8
DATA_PAGE, DICTIONARY_PAGE, DATA_PAGE_V2 = 0, 2, 3
# converted types
UTF8, MAP, MAP_KEY_VALUE, LIST, ENUM, DECIMAL, DATE = 0, 1, 2, 3, 4, 5, 6
TIME_MILLIS, TIME_MICROS = 7, 8
TIMESTAMP_MILLIS, TIMESTAMP_MICROS = 9, 10
_CONVERTED_INTS = {11: (8, False), 12: (16, False), 13: (32, False),
                   14: (64, False), 15: (8, True), 16: (16, True),
                   17: (32, True), 18: (64, True)}
_INT_CONVERTED = {(w, s): c for c, (w, s) in _CONVERTED_INTS.items()}
_NUMPY_INTS = {(8, True): np.int8, (16, True): np.int16,
               (32, True): np.int32, (64, True): np.int64,
               (8, False): np.uint8, (16, False): np.uint16,
               (32, False): np.uint32, (64, False): np.uint64}


class ParquetError(ValueError):
    """A file this module cannot read (or a frame it cannot write)."""


# ---------------------------------------------------------------------------
# Thrift compact protocol
# ---------------------------------------------------------------------------

# compact type codes
_T_TRUE, _T_FALSE, _T_BYTE, _T_I16, _T_I32, _T_I64 = 1, 2, 3, 4, 5, 6
_T_DOUBLE, _T_BINARY, _T_LIST, _T_SET, _T_MAP, _T_STRUCT = (
    7, 8, 9, 10, 11, 12)


class _Reader:
    """A cursor over a buffer of compact-protocol structs."""

    def __init__(self, buf, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def varint(self) -> int:
        buf, pos, shift, acc = self.buf, self.pos, 0, 0
        while True:
            b = buf[pos]
            pos += 1
            acc |= (b & 0x7F) << shift
            if not b & 0x80:
                self.pos = pos
                return acc
            shift += 7

    def zigzag(self) -> int:
        v = self.varint()
        return (v >> 1) ^ -(v & 1)

    def value(self, t: int):
        if t == _T_TRUE:
            return True
        if t == _T_FALSE:
            return False
        if t == _T_BYTE:
            b = self.buf[self.pos]
            self.pos += 1
            return b - 256 if b > 127 else b
        if t in (_T_I16, _T_I32, _T_I64):
            return self.zigzag()
        if t == _T_DOUBLE:
            v = struct.unpack_from("<d", self.buf, self.pos)[0]
            self.pos += 8
            return v
        if t == _T_BINARY:
            n = self.varint()
            v = bytes(self.buf[self.pos:self.pos + n])
            self.pos += n
            return v
        if t in (_T_LIST, _T_SET):
            head = self.buf[self.pos]
            self.pos += 1
            size, et = head >> 4, head & 0x0F
            if size == 15:
                size = self.varint()
            if et in (_T_TRUE, _T_FALSE):
                out = []
                for _ in range(size):
                    out.append(self.buf[self.pos] == _T_TRUE)
                    self.pos += 1
                return out
            return [self.value(et) for _ in range(size)]
        if t == _T_MAP:
            size = self.varint()
            if not size:
                return {}
            kv = self.buf[self.pos]
            self.pos += 1
            return {self.value(kv >> 4): self.value(kv & 0x0F)
                    for _ in range(size)}
        if t == _T_STRUCT:
            return self.struct()
        raise ParquetError(f"thrift compact: unknown type {t}")

    def struct(self) -> Dict[int, Any]:
        """{field id: value}; nested structs are dicts too."""
        out: Dict[int, Any] = {}
        fid = 0
        while True:
            head = self.buf[self.pos]
            self.pos += 1
            if head == 0:
                return out
            delta, t = head >> 4, head & 0x0F
            fid = fid + delta if delta else self.zigzag()
            out[fid] = self.value(t)


class _Writer:
    """Compact-protocol output. A struct is a list of (field id, type,
    value); a list is (element type, [values])."""

    def __init__(self):
        self.out = bytearray()

    def varint(self, v: int) -> None:
        out = self.out
        while v > 0x7F:
            out.append((v & 0x7F) | 0x80)
            v >>= 7
        out.append(v)

    def zigzag(self, v: int) -> None:
        self.varint((v << 1) ^ (v >> 63))

    def value(self, t: int, v) -> None:
        if t in (_T_I16, _T_I32, _T_I64):
            self.zigzag(int(v))
        elif t == _T_BYTE:
            self.out.append(v & 0xFF)
        elif t == _T_DOUBLE:
            self.out += struct.pack("<d", v)
        elif t == _T_BINARY:
            b = v.encode("utf-8") if isinstance(v, str) else bytes(v)
            self.varint(len(b))
            self.out += b
        elif t == _T_LIST:
            et, items = v
            if len(items) < 15:
                self.out.append((len(items) << 4) | et)
            else:
                self.out.append(0xF0 | et)
                self.varint(len(items))
            for item in items:
                self.value(et, item)
        elif t == _T_STRUCT:
            self.struct(v)
        else:
            raise ParquetError(f"thrift compact: cannot write type {t}")

    def struct(self, fields) -> None:
        last = 0
        for fid, t, v in fields:
            if v is None:
                continue
            if t == _T_TRUE:            # a bool field's value is its type
                t = _T_TRUE if v else _T_FALSE
            delta = fid - last
            if 0 < delta <= 15:
                self.out.append((delta << 4) | t)
            else:
                self.out.append(t)
                self.zigzag(fid)
            last = fid
            if t not in (_T_TRUE, _T_FALSE):
                self.value(t, v)
        self.out.append(0)


# ---------------------------------------------------------------------------
# Codecs
# ---------------------------------------------------------------------------

def snappy_decompress(data) -> bytes:
    """A raw snappy block (no framing) -> its bytes."""
    src = memoryview(bytes(data))
    pos, n, shift = 0, 0, 0
    while True:                         # the preamble: the output length
        b = src[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    out = bytearray()
    end = len(src)
    while pos < end:
        tag = src[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:                   # literal
            ln = tag >> 2
            if ln >= 60:
                extra = ln - 59
                ln = int.from_bytes(src[pos:pos + extra], "little")
                pos += extra
            ln += 1
            out += src[pos:pos + ln]
            pos += ln
            continue
        if kind == 1:
            ln = ((tag >> 2) & 7) + 4
            off = ((tag >> 5) << 8) | src[pos]
            pos += 1
        elif kind == 2:
            ln = (tag >> 2) + 1
            off = src[pos] | (src[pos + 1] << 8)
            pos += 2
        else:
            ln = (tag >> 2) + 1
            off = int.from_bytes(src[pos:pos + 4], "little")
            pos += 4
        if off == 0 or off > len(out):
            raise ParquetError(f"snappy: copy offset {off} outside the "
                               f"{len(out)} bytes written")
        start = len(out) - off
        if off >= ln:
            out += out[start:start + ln]
        else:                           # overlapping: the pattern repeats
            pattern = bytes(out[start:])
            out += (pattern * (ln // off + 1))[:ln]
    if len(out) != n:
        raise ParquetError(f"snappy: {len(out)} bytes decoded, the block "
                           f"says {n}")
    return bytes(out)


def _snappy_literal(out: bytearray, data, start: int, end: int) -> None:
    while start < end:
        ln = min(end - start, 1 << 16)
        if ln <= 60:
            out.append((ln - 1) << 2)
        elif ln <= 256:
            out += bytes([60 << 2, ln - 1])
        else:
            out += bytes([61 << 2]) + (ln - 1).to_bytes(2, "little")
        out += data[start:start + ln]
        start += ln


def _snappy_copy(out: bytearray, off: int, ln: int) -> None:
    while ln > 0:
        if 4 <= ln < 12 and off < 2048:
            out += bytes([((off >> 8) << 5) | ((ln - 4) << 2) | 1,
                          off & 0xFF])
            return
        take = min(ln, 64)
        if ln - take and ln - take < 4:     # leave a copyable tail
            take = ln - 4
        out += bytes([((take - 1) << 2) | 2]) + off.to_bytes(2, "little")
        ln -= take


def snappy_compress(data) -> bytes:
    """A raw snappy block of ``data``: literals and copies found by a hash
    of 4-byte windows, with snappy's skipping heuristic on incompressible
    stretches (the bytes differ from the reference encoder's; any snappy
    decoder reads them)."""
    data = bytes(data)
    n = len(data)
    out = bytearray()
    v = n
    while v > 0x7F:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    if n < 16:
        _snappy_literal(out, data, 0, n)
        return bytes(out)
    table: Dict[bytes, int] = {}
    lit = 0
    i = 0
    misses = 32
    limit = n - 4
    while i <= limit:
        key = data[i:i + 4]
        cand = table.get(key)
        table[key] = i
        if cand is None or i - cand > 0xFFFF:
            i += misses >> 5
            misses += 1
            continue
        misses = 32
        ln = 4
        while i + ln + 256 <= n and \
                data[cand + ln:cand + ln + 256] == data[i + ln:i + ln + 256]:
            ln += 256                   # long matches a block at a time
        while i + ln < n and data[cand + ln] == data[i + ln]:
            ln += 1
        _snappy_literal(out, data, lit, i)
        _snappy_copy(out, i - cand, ln)
        i += ln
        lit = i
    _snappy_literal(out, data, lit, n)
    return bytes(out)


def _decompress(codec: int, data, size: int, path: str) -> bytes:
    if codec == 0:
        return bytes(data)
    if codec == 1:
        return snappy_decompress(data)
    if codec == 2:
        return zlib.decompress(bytes(data), 16 + zlib.MAX_WBITS)
    raise ParquetError(f"{path}: codec {CODECS.get(codec, codec)} is not "
                       f"supported (UNCOMPRESSED, SNAPPY and GZIP are)")


_CODEC_IDS = {None: 0, "snappy": 1}


def _compress(codec: int, data: bytes) -> bytes:
    return snappy_compress(data) if codec == 1 else data


# ---------------------------------------------------------------------------
# The RLE / bit-packed hybrid
# ---------------------------------------------------------------------------

def _unpack_bits(raw, bit_width: int, count: int) -> np.ndarray:
    """``count`` little-endian ``bit_width``-bit values packed LSB first."""
    bits = np.unpackbits(np.frombuffer(raw, dtype=np.uint8),
                         bitorder="little")[:count * bit_width]
    bits = bits.reshape(count, bit_width).astype(np.int64)
    return bits @ (np.int64(1) << np.arange(bit_width, dtype=np.int64))


def rle_hybrid_decode(buf, bit_width: int, count: int,
                      pos: int = 0) -> Tuple[np.ndarray, int]:
    """(``count`` values of the hybrid stream at ``buf[pos:]``, the
    position after the runs read). One numpy step per run."""
    out = np.zeros(count, dtype=np.int64)
    if bit_width == 0:
        return out, pos
    r = _Reader(buf, pos)
    width_bytes = (bit_width + 7) // 8
    got = 0
    while got < count:
        head = r.varint()
        if head & 1:                        # bit-packed groups of 8
            groups = head >> 1
            nbytes = groups * bit_width
            m = groups * 8
            vals = _unpack_bits(bytes(buf[r.pos:r.pos + nbytes]),
                                bit_width, m)
            r.pos += nbytes
            take = min(m, count - got)
            out[got:got + take] = vals[:take]
            got += take
        else:                               # one value repeated
            run = head >> 1
            v = int.from_bytes(bytes(buf[r.pos:r.pos + width_bytes]),
                               "little")
            r.pos += width_bytes
            take = min(run, count - got)
            out[got:got + take] = v
            got += take
    return out, r.pos


def _varint_bytes(v: int) -> bytes:
    out = bytearray()
    while v > 0x7F:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


#: equal groups of 8 in a row that make an RLE run (fewer are bit-packed)
RLE_MIN_GROUPS = 4


def rle_hybrid_encode(values, bit_width: int) -> bytes:
    """The hybrid stream of ``values``: runs of groups of 8 equal values
    become one RLE run each, the other groups bit-packed runs (the last
    group padded with zeros, as the format allows). One numpy step finds
    the runs; Python steps once a run."""
    vals = np.asarray(values, dtype=np.int64)
    n = len(vals)
    if n == 0 or bit_width == 0:
        return b""
    width_bytes = (bit_width + 7) // 8
    full = n // 8
    tail = vals[full * 8:]
    out = bytearray()
    if full:
        groups = vals[:full * 8].reshape(full, 8)
        const = (groups == groups[:, :1]).all(axis=1)
        key = np.where(const, groups[:, 0], -1)     # values are >= 0
        # a short run of equal groups packs with its neighbours
        cuts = np.flatnonzero(np.diff(key)) + 1
        starts = np.concatenate([[0], cuts])
        lengths = np.diff(np.concatenate([starts, [full]]))
        short = np.repeat(lengths < RLE_MIN_GROUPS, lengths)
        key = np.where(short, -1, key)
        cuts = np.flatnonzero(np.diff(key)) + 1
        bounds = [0] + cuts.tolist() + [full]
        # every group packed at once: group g is bytes [g w, (g + 1) w)
        packed = np.packbits(((groups.reshape(-1, 1) >> np.arange(
            bit_width)) & 1).astype(np.uint8).reshape(-1),
            bitorder="little").tobytes()
        for a, b in zip(bounds[:-1], bounds[1:]):
            v = int(key[a])
            if v < 0:
                out += _varint_bytes(((b - a) << 1) | 1)
                out += packed[a * bit_width:b * bit_width]
                continue
            run = (b - a) * 8
            if b == full and len(tail) and (tail == v).all():
                run += len(tail)                    # the tail joins the run
                tail = tail[:0]
            out += _varint_bytes(run << 1)
            out += v.to_bytes(width_bytes, "little")
    if len(tail):
        out += _pack_run(tail, bit_width)
    return bytes(out)


def _pack_run(vals: np.ndarray, bit_width: int) -> bytes:
    groups = (len(vals) + 7) // 8
    padded = np.zeros(groups * 8, dtype=np.int64)
    padded[:len(vals)] = vals
    bits = ((padded[:, None] >> np.arange(bit_width)) & 1).astype(np.uint8)
    return _varint_bytes((groups << 1) | 1) + np.packbits(
        bits.reshape(-1), bitorder="little").tobytes()


def _bit_width(max_level: int) -> int:
    return int(max_level).bit_length()


# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------

class _Node:
    """One schema element with its place in the tree."""

    def __init__(self, el: Dict[int, Any], parent: Optional["_Node"]):
        self.name = el[4].decode("utf-8")
        self.type = el.get(1)
        self.type_length = el.get(2)
        self.repetition = el.get(3, REQUIRED) if parent is not None \
            else REQUIRED
        self.num_children = el.get(5, 0)
        self.converted = el.get(6)
        self.logical = el.get(10) or {}
        self.parent = parent
        self.children: List[_Node] = []
        up = parent
        self.max_def = (up.max_def if up else 0) + (
            self.repetition != REQUIRED)
        self.max_rep = (up.max_rep if up else 0) + (
            self.repetition == REPEATED)

    @property
    def is_leaf(self) -> bool:
        return self.type is not None and not self.num_children

    @property
    def is_list(self) -> bool:
        return (not self.is_leaf and (self.converted == LIST
                                      or 3 in self.logical))

    @property
    def is_map(self) -> bool:
        return (not self.is_leaf and (self.converted in (MAP, MAP_KEY_VALUE)
                                      or 2 in self.logical))


def _schema_tree(elements: List[Dict[int, Any]]) -> _Node:
    root = _Node(elements[0], None)
    pos = 1

    def fill(node: _Node) -> None:
        nonlocal pos
        for _ in range(node.num_children):
            child = _Node(elements[pos], node)
            pos += 1
            node.children.append(child)
            fill(child)

    fill(root)
    return root


def _leaves(node: _Node) -> List[_Node]:
    if node.is_leaf:
        return [node]
    return [lf for c in node.children for lf in _leaves(c)]


def _path(leaf: _Node) -> List[_Node]:
    out = []
    node = leaf
    while node.parent is not None:
        out.append(node)
        node = node.parent
    return out[::-1]


# ---------------------------------------------------------------------------
# Pages -> (definition levels, repetition levels, values)
# ---------------------------------------------------------------------------

def _plain(buf, ptype: int, count: int, type_length: Optional[int],
           as_text: bool, pos: int = 0):
    """``count`` PLAIN values of ``ptype`` at ``buf[pos:]``: a numpy array
    (byte arrays: an object array of bytes, or of str with ``as_text``)."""
    if ptype == BOOLEAN:
        raw = np.frombuffer(bytes(buf[pos:pos + (count + 7) // 8]),
                            dtype=np.uint8)
        return np.unpackbits(raw, bitorder="little")[:count].astype(bool)
    if ptype in (INT32, INT64, FLOAT, DOUBLE):
        dt = {INT32: "<i4", INT64: "<i8", FLOAT: "<f4", DOUBLE: "<f8"}[ptype]
        size = np.dtype(dt).itemsize
        return np.frombuffer(bytes(buf[pos:pos + size * count]),
                             dtype=dt).astype(dt[1:])
    out = np.empty(count, dtype=object)
    mv = memoryview(buf)
    if ptype == BYTE_ARRAY:
        for i in range(count):
            ln = int.from_bytes(mv[pos:pos + 4], "little")
            pos += 4
            b = bytes(mv[pos:pos + ln])
            out[i] = b.decode("utf-8") if as_text else b
            pos += ln
        return out
    if ptype == FIXED:
        w = type_length
        for i in range(count):
            b = bytes(mv[pos + i * w:pos + (i + 1) * w])
            out[i] = b.decode("utf-8") if as_text else b
        return out
    raise ParquetError(f"physical type {TYPE_NAMES[ptype]} is not supported")


def _is_text(leaf: _Node) -> bool:
    return leaf.converted in (UTF8, ENUM, 19) or any(
        k in leaf.logical for k in (1, 4, 12))


def _read_chunk(data: bytes, meta: Dict[int, Any], leaf: _Node,
                path: str):
    """One column chunk -> (def levels, rep levels, values) as numpy
    arrays; values hold the non-null leaf values in order."""
    codec = meta.get(4, 0)
    ptype = meta[1]
    if ptype == INT96:
        raise ParquetError(f"{path}: INT96 column {_leaf_key(leaf)!r} is "
                           f"not read")
    total = meta[5]
    start = meta.get(11) if meta.get(11) else meta[9]
    pos = start
    text = _is_text(leaf)
    dictionary = None
    defs, reps, vals = [], [], []
    seen = 0
    while seen < total:
        r = _Reader(data, pos)
        header = r.struct()
        body_at = r.pos
        kind, usize, csize = header[1], header[2], header[3]
        body = data[body_at:body_at + csize]
        pos = body_at + csize
        if kind == DICTIONARY_PAGE:
            dh = header[7]
            if dh.get(2, PLAIN) not in (PLAIN, PLAIN_DICTIONARY):
                raise ParquetError(
                    f"{path}: dictionary page encoding "
                    f"{ENCODINGS.get(dh.get(2), dh.get(2))} is not "
                    f"supported")
            raw = _decompress(codec, body, usize, path)
            dictionary = _plain(raw, ptype, dh[1], leaf.type_length, text)
            continue
        if kind == DATA_PAGE:
            dh = header[5]
            n = dh[1]
            enc = dh[2]
            raw = _decompress(codec, body, usize, path)
            p = 0
            rl = dl = None
            for lvl_max, which in ((leaf.max_rep, "rep"),
                                   (leaf.max_def, "def")):
                if not lvl_max:
                    continue
                lenc = dh.get(4 if which == "rep" else 3, RLE)
                if lenc != RLE:
                    raise ParquetError(
                        f"{path}: level encoding "
                        f"{ENCODINGS.get(lenc, lenc)} is not supported")
                ln = int.from_bytes(raw[p:p + 4], "little")
                lv, _ = rle_hybrid_decode(raw[p + 4:p + 4 + ln],
                                          _bit_width(lvl_max), n)
                p += 4 + ln
                if which == "rep":
                    rl = lv
                else:
                    dl = lv
            values_buf = raw[p:]
        elif kind == DATA_PAGE_V2:
            dh = header[8]
            n = dh[1]
            enc = dh[4]
            dlen, rlen = dh[5], dh[6]
            rl = dl = None
            if leaf.max_rep:
                rl, _ = rle_hybrid_decode(body[:rlen],
                                          _bit_width(leaf.max_rep), n)
            if leaf.max_def:
                dl, _ = rle_hybrid_decode(body[rlen:rlen + dlen],
                                          _bit_width(leaf.max_def), n)
            rest = body[rlen + dlen:]
            if dh.get(7, True):
                rest = _decompress(codec, rest, usize - rlen - dlen, path)
            values_buf = rest
        else:
            continue                     # an index page
        if dl is None:
            dl = np.full(n, leaf.max_def, dtype=np.int64)
        if rl is None:
            rl = np.zeros(n, dtype=np.int64)
        present = int((dl == leaf.max_def).sum())
        if enc == PLAIN:
            v = _plain(values_buf, ptype, present, leaf.type_length, text)
        elif enc in (PLAIN_DICTIONARY, RLE_DICTIONARY):
            if dictionary is None:
                raise ParquetError(f"{path}: a dictionary-encoded page "
                                   f"without a dictionary page")
            bw = values_buf[0] if len(values_buf) else 0
            idx, _ = rle_hybrid_decode(values_buf, bw, present, pos=1)
            v = dictionary[idx]
        elif enc == RLE and ptype == BOOLEAN:
            ln = int.from_bytes(values_buf[:4], "little")
            v, _ = rle_hybrid_decode(values_buf[4:4 + ln], 1, present)
            v = v.astype(bool)
        else:
            raise ParquetError(f"{path}: encoding "
                               f"{ENCODINGS.get(enc, enc)} is not "
                               f"supported")
        defs.append(dl)
        reps.append(rl)
        vals.append(v)
        seen += n
    cat = (lambda xs: np.concatenate(xs) if xs else np.zeros(0, np.int64))
    values = (np.concatenate(vals) if vals else
              _plain(b"", ptype, 0, leaf.type_length, text))
    return cat(defs), cat(reps), values


# ---------------------------------------------------------------------------
# Values as pandas gives them
# ---------------------------------------------------------------------------

def _timestamp_unit(leaf: _Node) -> Optional[str]:
    ts = leaf.logical.get(8)
    if ts is not None:
        unit = ts.get(2) or {}
        return "ms" if 1 in unit else "us" if 2 in unit else "ns"
    if leaf.converted == TIMESTAMP_MILLIS:
        return "ms"
    if leaf.converted == TIMESTAMP_MICROS:
        return "us"
    return None


def _int_kind(leaf: _Node) -> Tuple[int, bool]:
    it = leaf.logical.get(10)
    if it is not None:
        return int(it.get(1, 64 if leaf.type == INT64 else 32)), bool(
            it.get(2, True))
    if leaf.converted in _CONVERTED_INTS:
        return _CONVERTED_INTS[leaf.converted]
    return (64 if leaf.type == INT64 else 32), True


def _time_unit(leaf: _Node) -> Optional[str]:
    """The unit of a TIME leaf ("ms", "us" or "ns"), None for another."""
    tm = leaf.logical.get(7)
    if tm is not None:
        unit = tm.get(2) or {}
        return "ms" if 1 in unit else "us" if 2 in unit else "ns"
    if leaf.converted == TIME_MILLIS:
        return "ms"
    if leaf.converted == TIME_MICROS:
        return "us"
    return None


def _times(values: np.ndarray, unit: str, path: str) -> List[Any]:
    """TIME values as ``datetime.time`` (pandas' conversion: whole
    microseconds; a nanosecond remainder raises there and here)."""
    v = values.astype(np.int64)
    if unit == "ns":
        if (v % 1000).any():
            raise ParquetError(f"{path}: a TIME value has non-zero "
                               f"nanoseconds")
        v = v // 1000
    elif unit == "ms":
        v = v * 1000
    out = []
    for us in v.tolist():
        sec, micro = divmod(us, 1_000_000)
        minute, second = divmod(sec, 60)
        out.append(datetime.time(minute // 60, minute % 60, second, micro))
    return out


_EPOCH = datetime.date(1970, 1, 1)


def _convert(leaf: _Node, values: np.ndarray, valid: np.ndarray,
             path: str) -> np.ndarray:
    """The slots of one leaf (``valid`` where a value is present, the
    values in order) as the numpy array pyarrow's ``to_pandas`` makes of
    them, a string's null None."""
    n = len(valid)
    nulls = not valid.all()
    if 11 in leaf.logical:                          # the null type
        out = np.empty(n, dtype=object)
        out[:] = None
        return out
    pt = leaf.type
    if pt == BOOLEAN:
        if not nulls:
            return values.astype(bool)
        out = np.empty(n, dtype=object)
        out[:] = None
        out[valid] = values.astype(bool).astype(object)
        return out
    if pt in (INT32, INT64):
        if 6 in leaf.logical or leaf.converted == DATE:
            out = np.empty(n, dtype=object)
            out[:] = None
            out[valid] = [_EPOCH + datetime.timedelta(days=int(d))
                          for d in values]
            return out
        tunit = _time_unit(leaf)
        if tunit is not None:
            out = np.empty(n, dtype=object)
            out[:] = None
            out[valid] = _times(values, tunit, path)
            return out
        unit = _timestamp_unit(leaf) if pt == INT64 else None
        if unit is not None:
            out = np.full(n, np.datetime64("NaT"), dtype=f"M8[{unit}]")
            out[valid] = values.astype(np.int64).view(f"M8[{unit}]")
            return out
        if 5 in leaf.logical or leaf.converted == DECIMAL:
            raise ParquetError(f"{path}: DECIMAL columns are not read")
        width, signed = _int_kind(leaf)
        dt = _NUMPY_INTS[(width, signed)]
        ints = values.astype(np.int64 if pt == INT64 else np.int32)
        typed = ints.view(np.uint64).astype(dt) if (
            pt == INT64 and not signed) else ints.astype(dt)
        if not nulls:
            return typed
        out = np.full(n, np.nan)
        out[valid] = typed.astype(np.float64)
        return out
    if pt in (FLOAT, DOUBLE):
        dt = np.float32 if pt == FLOAT else np.float64
        out = np.full(n, np.nan, dtype=dt)
        out[valid] = values
        return out
    if pt == FIXED and 15 in leaf.logical:          # FLOAT16
        out = np.full(n, np.nan, dtype=np.float16)
        out[valid] = np.frombuffer(b"".join(values.tolist()), dtype="<f2")
        return out
    if pt in (BYTE_ARRAY, FIXED):
        if 5 in leaf.logical or leaf.converted == DECIMAL:
            raise ParquetError(f"{path}: DECIMAL columns are not read")
        out = np.empty(n, dtype=object)
        out[:] = None
        out[valid] = values
        return out
    raise ParquetError(f"{path}: physical type {TYPE_NAMES[pt]} is not "
                       f"supported")


def _assemble(path_nodes: List[_Node], defs: np.ndarray, reps: np.ndarray,
              slots: np.ndarray, n_rows: int) -> List[Any]:
    """One leaf's levels and converted slots -> its value in each row:
    a group a dict of this leaf's branch, a list a numpy array (of the
    slots when its elements are the leaf), None where a level is null."""
    k = len(path_nodes)
    D = [nd.max_def for nd in path_nodes]
    R = [nd.max_rep for nd in path_nodes]
    d_rep = max((D[i] for i in range(k)
                 if path_nodes[i].repetition == REPEATED), default=0)
    has_slot = defs >= d_rep
    slot_of = np.cumsum(has_slot) - 1
    dl, rl, so = defs.tolist(), reps.tolist(), slot_of.tolist()
    slot_objs = slots.tolist()
    n = len(dl)

    def value(i: int, pos: int):
        nd = path_nodes[i]
        if nd.repetition == OPTIONAL and dl[pos] < D[i]:
            return None, pos + 1
        if nd.repetition == REPEATED:
            return items(i, pos)
        return content(i, pos)

    def unwraps(nd: _Node) -> bool:
        """A LIST's repeated group whose one child is the element."""
        return (nd.parent is not None and nd.parent.is_list
                and len(nd.children) == 1 and nd.name != "array"
                and not nd.name.endswith("_tuple"))

    def items(i: int, pos: int):
        leaf_elems = i == k - 1 or (i == k - 2 and unwraps(path_nodes[i]))
        if dl[pos] < D[i]:                       # an empty list
            if leaf_elems:
                return slots[0:0], pos + 1
            return np.empty(0, dtype=object), pos + 1
        start = pos
        out = []
        while True:
            v, pos = content(i, pos)
            out.append(v)
            if pos < n and rl[pos] == R[i]:
                continue
            break
        if leaf_elems:                           # a slice of the slots
            s0 = so[start]
            return slots[s0:s0 + len(out)], pos
        arr = np.empty(len(out), dtype=object)
        arr[:] = out
        return arr, pos

    def content(i: int, pos: int):
        nd = path_nodes[i]
        if i == k - 1:                           # a present leaf
            return slot_objs[so[pos]], pos + 1
        child = path_nodes[i + 1]
        v, pos = value(i + 1, pos)
        if nd.is_list:
            return v, pos                        # the repeated child's
        if nd.repetition == REPEATED and unwraps(nd):
            return v, pos                        # a list's element
        return {child.name: v}, pos

    rows = []
    pos = 0
    for _ in range(n_rows):
        v, pos = value(0, pos)
        rows.append(v)
    return rows


def _flat_list(nodes: List[_Node]) -> bool:
    """A top-level 3-level LIST of a primitive element."""
    return (len(nodes) == 3 and nodes[0].is_list
            and nodes[1].repetition == REPEATED
            and len(nodes[1].children) == 1 and nodes[2].is_leaf
            and nodes[2].repetition != REPEATED)


def _list_rows(defs: np.ndarray, reps: np.ndarray, slots: np.ndarray,
               d_rep: int) -> List[Any]:
    """The rows of a top-level list of a primitive (``_flat_list``): one
    numpy step for the row bounds, then a slice of the slots a row."""
    starts = np.flatnonzero(reps == 0)
    has_slot = (defs >= d_rep).astype(np.int64)
    counts = np.add.reduceat(has_slot, starts) if len(starts) else \
        np.zeros(0, np.int64)
    ends = np.cumsum(counts)
    first = defs[starts]
    rows: List[Any] = []
    for f, e, c in zip(first.tolist(), ends.tolist(), counts.tolist()):
        rows.append(None if f < d_rep - 1 else slots[e - c:e])
    return rows


def _merge(a, b):
    """Two leaves' values of one column merged key by key."""
    if isinstance(a, dict):
        for key, v in b.items():
            a[key] = _merge(a[key], v) if key in a else v
        return a
    if isinstance(a, np.ndarray) and a.dtype == object and len(a) and \
            isinstance(a[0], dict):
        for j in range(len(a)):
            a[j] = _merge(a[j], b[j])
        return a
    return a


def _column(top: _Node, chunks: Dict[str, List[Tuple]], n_rows: int,
            path: str) -> np.ndarray:
    """A top-level field's levels and values over every row group -> the
    pandas column."""
    if top.is_map or any(nd.is_map for nd in _descendants(top)):
        raise ParquetError(f"{path}: MAP column {top.name!r} is not read")
    rows = None
    for leaf in _leaves(top):
        parts = chunks[_leaf_key(leaf)] or [(
            np.zeros(0, np.int64), np.zeros(0, np.int64),
            _plain(b"", leaf.type, 0, leaf.type_length, _is_text(leaf)))]
        defs = np.concatenate([p[0] for p in parts])
        reps = np.concatenate([p[1] for p in parts])
        values = np.concatenate([p[2] for p in parts])
        nodes = _path(leaf)
        d_rep = max((nd.max_def for nd in nodes
                     if nd.repetition == REPEATED), default=0)
        slot_defs = defs[defs >= d_rep]
        valid = slot_defs == leaf.max_def
        slots = _convert(leaf, values, valid, path)
        if top.is_leaf and top.repetition != REPEATED:
            if _is_text(leaf) and leaf.type in (BYTE_ARRAY, FIXED):
                slots[~valid] = np.nan           # pandas' str dtype
            return slots
        if _flat_list(nodes):
            got = _list_rows(defs, reps, slots, leaf.max_def - 1)
        else:
            got = _assemble(nodes, defs, reps, slots, n_rows)
        rows = got if rows is None else [_merge(a, b)
                                         for a, b in zip(rows, got)]
    out = np.empty(n_rows, dtype=object)
    out[:] = rows
    return out


def _descendants(node: _Node):
    for c in node.children:
        yield c
        yield from _descendants(c)


def _leaf_key(leaf: _Node) -> str:
    return ".".join(nd.name for nd in _path(leaf))


def read_metadata(path: str) -> Dict[str, Any]:
    """The footer: {"num_rows", "schema" (the root ``_Node``),
    "row_groups" (raw thrift), "key_value" {key: value}, "created_by"}."""
    with open(path, "rb") as fh:
        data = fh.read()
    return _footer(data, path)


def _footer(data: bytes, path: str) -> Dict[str, Any]:
    if len(data) < 12 or data[:4] != MAGIC or data[-4:] != MAGIC:
        raise ParquetError(f"{path}: not a Parquet file")
    size = int.from_bytes(data[-8:-4], "little")
    meta = _Reader(data, len(data) - 8 - size).struct()
    kv = {e[1].decode("utf-8"): (e.get(2) or b"").decode("utf-8")
          for e in meta.get(5, [])}
    return {"num_rows": meta[3], "schema": _schema_tree(meta[2]),
            "row_groups": meta.get(4, []), "key_value": kv,
            "created_by": (meta.get(6) or b"").decode("utf-8", "replace")}


def read_parquet(path: str) -> Dict[str, np.ndarray]:
    """The columns of a Parquet file or a directory of them, {name: numpy
    column} in schema order, as ``pd.read_parquet`` gives them (module
    docstring)."""
    if os.path.isdir(path):
        return _read_dataset(path)
    return _read_file(path)


def _dataset_files(root: str) -> List[Tuple[str, List[Tuple[str, str]]]]:
    """(file, [(partition key, value string), ...]) of every data file
    under ``root``, in the order of their sorted paths."""
    from urllib.parse import unquote
    found = []
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if not d.startswith(("_", "."))]
        found.extend(os.path.join(dirpath, f) for f in files
                     if not f.startswith(("_", ".")))
    out = []
    for f in sorted(found):
        parts = os.path.relpath(f, root).split(os.sep)[:-1]
        out.append((f, [tuple(unquote(x) for x in p.split("=", 1))
                        for p in parts if "=" in p]))
    return out


def _partition_column(values: List[str]) -> np.ndarray:
    """A hive partition level's values as pandas gives them: int32 where
    every value is an int32, else strings."""
    try:
        ints = [int(v) for v in values]
    except ValueError:
        ints = None
    if ints is not None and all(-2 ** 31 <= i < 2 ** 31 for i in ints):
        return np.array(ints, dtype=np.int32)
    out = np.empty(len(values), dtype=object)
    out[:] = values
    return out


def _read_dataset(root: str) -> Dict[str, np.ndarray]:
    files = _dataset_files(root)
    if not files:
        raise ParquetError(f"{root}: no Parquet files in the directory")
    keys = [k for k, _ in files[0][1]]
    parts: Dict[str, List[np.ndarray]] = {}
    labels: Dict[str, List[str]] = {k: [] for k in keys}
    for f, kv in files:
        if [k for k, _ in kv] != keys:
            raise ParquetError(f"{f}: partition keys {[k for k, _ in kv]} "
                               f"differ from {keys}")
        cols = _read_file(f)
        if parts and list(cols) != list(parts):
            raise ParquetError(f"{f}: columns {list(cols)} differ from "
                               f"{list(parts)}")
        for name, col in cols.items():
            parts.setdefault(name, []).append(col)
        n = len(next(iter(cols.values()))) if cols else \
            _footer_rows(f)
        for k, v in kv:
            if v == "__HIVE_DEFAULT_PARTITION__":
                raise ParquetError(f"{f}: a null partition value of "
                                   f"'{k}' is not read")
            labels[k].extend([v] * n)
    out = {name: np.concatenate(cols) for name, cols in parts.items()}
    for k in keys:
        out[k] = _partition_column(labels[k])
    return out


def _footer_rows(path: str) -> int:
    return int(read_metadata(path)["num_rows"])


def _read_file(path: str) -> Dict[str, np.ndarray]:
    with open(path, "rb") as fh:
        data = fh.read()
    foot = _footer(data, path)
    root = foot["schema"]
    leaves = _leaves(root)
    chunks: Dict[str, List[Tuple]] = {_leaf_key(lf): [] for lf in leaves}
    for rg in foot["row_groups"]:
        for cc, leaf in zip(rg[1], leaves):
            meta = cc[3]
            chunks[_leaf_key(leaf)].append(
                _read_chunk(data, meta, leaf, path))
    n_rows = foot["num_rows"]
    index_cols = set()
    pd_meta = foot["key_value"].get("pandas")
    if pd_meta:
        for ix in json.loads(pd_meta).get("index_columns", []):
            if isinstance(ix, str):
                index_cols.add(ix)
    return {top.name: _column(top, chunks, n_rows, path)
            for top in root.children if top.name not in index_cols}


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------

class _Type:
    """An inferred column type: kind in bool, int32 (``bits``, ``signed``),
    int64, float, double, string, binary, timestamp (``unit``), null,
    struct (``fields``), list (``element``)."""

    def __init__(self, kind: str, **kw):
        self.kind = kind
        self.__dict__.update(kw)


def _is_null(v) -> bool:
    return v is None or (isinstance(v, (float, np.floating))
                         and math.isnan(v))


def _infer_values(vals: Sequence[Any], where: str) -> _Type:
    """The type pyarrow infers for python values (None and NaN null)."""
    types = set(map(type, vals)) - {type(None)}
    if float in types or np.float64 in types or np.float32 in types:
        if not any(isinstance(v, (float, np.floating)) and v == v
                   for v in vals):          # every float is a NaN: nulls
            types -= {float, np.float64, np.float32}
    if not types:
        return _Type("null")
    bools = {bool, np.bool_}
    ints = {int, np.int64, np.int32, np.int16, np.int8, np.uint8,
            np.uint16, np.uint32, np.uint64}
    floats = {float, np.float64, np.float32}
    if types <= bools:
        return _Type("bool")
    if types <= ints:
        return _Type("int64")
    if types <= ints | floats:
        return _Type("double")
    if types <= {str, np.str_}:
        return _Type("string")
    if types <= {bytes, bytearray}:
        return _Type("binary")
    present = [v for v in vals if not _is_null(v)]
    if all(isinstance(v, Mapping) for v in present):
        keys: Dict[str, None] = {}
        for d in present:
            keys.update(dict.fromkeys(d))
        return _Type("struct", fields={
            str(k): _infer_values([d.get(k) for d in present],
                                  f"{where}.{k}") for k in keys})
    if all(isinstance(v, (list, tuple, np.ndarray)) for v in present):
        from itertools import chain
        elems = list(chain.from_iterable(
            v.tolist() if isinstance(v, np.ndarray) else v
            for v in present))
        return _Type("list", element=_infer_values(elems, where))
    kinds = sorted(t.__name__ for t in types)
    raise ParquetError(f"column {where!r}: cannot write a column of "
                       f"{', '.join(kinds)}")


def _infer(arr: np.ndarray, name: str) -> _Type:
    dt = arr.dtype
    if dt.kind == "b":
        return _Type("bool")
    if dt.kind in "iu":
        if dt.itemsize == 8:
            return _Type("int64", signed=dt.kind == "i")
        return _Type("int32", bits=dt.itemsize * 8, signed=dt.kind == "i")
    if dt.kind == "f":
        return _Type("float" if dt.itemsize == 4 else "double")
    if dt.kind == "M":
        unit = np.datetime_data(dt)[0]
        if unit not in ("ms", "us", "ns"):
            raise ParquetError(f"column {name!r}: datetime64[{unit}] is not "
                               f"written (ms, us, ns are)")
        return _Type("timestamp", unit=unit)
    return _infer_values(arr.tolist(), name)


def _schema_elements(name: str, t: _Type, out: List) -> None:
    """Thrift SchemaElement fields for ``t`` (optional) and its children."""
    if t.kind == "struct":
        out.append([(3, _T_I32, OPTIONAL), (4, _T_BINARY, name),
                    (5, _T_I32, len(t.fields))])
        for k, ft in t.fields.items():
            _schema_elements(k, ft, out)
        return
    if t.kind == "list":
        out.append([(3, _T_I32, OPTIONAL), (4, _T_BINARY, name),
                    (5, _T_I32, 1), (6, _T_I32, LIST),
                    (10, _T_STRUCT, [(3, _T_STRUCT, [])])])
        out.append([(3, _T_I32, REPEATED), (4, _T_BINARY, "list"),
                    (5, _T_I32, 1)])
        _schema_elements("element", t.element, out)
        return
    el = [(1, _T_I32, _PHYSICAL[t.kind]), (3, _T_I32, OPTIONAL),
          (4, _T_BINARY, name)]
    if t.kind == "string":
        el += [(6, _T_I32, UTF8), (10, _T_STRUCT, [(1, _T_STRUCT, [])])]
    elif t.kind == "int32" and (t.bits, t.signed) != (32, True):
        el += [(6, _T_I32, _INT_CONVERTED[(t.bits, t.signed)]),
               (10, _T_STRUCT, [(10, _T_STRUCT, [
                   (1, _T_BYTE, t.bits), (2, _T_TRUE, t.signed)])])]
    elif t.kind == "int64" and not getattr(t, "signed", True):
        el += [(6, _T_I32, _INT_CONVERTED[(64, False)]),
               (10, _T_STRUCT, [(10, _T_STRUCT, [
                   (1, _T_BYTE, 64), (2, _T_TRUE, False)])])]
    elif t.kind == "timestamp":
        unit_id = {"ms": 1, "us": 2, "ns": 3}[t.unit]
        el += [(10, _T_STRUCT, [(8, _T_STRUCT, [
            (1, _T_TRUE, False), (2, _T_STRUCT, [(unit_id, _T_STRUCT,
                                                  [])])])])]
    elif t.kind == "null":
        el += [(10, _T_STRUCT, [(11, _T_STRUCT, [])])]
    out.append(el)


_PHYSICAL = {"bool": BOOLEAN, "int32": INT32, "int64": INT64,
             "float": FLOAT, "double": DOUBLE, "string": BYTE_ARRAY,
             "binary": BYTE_ARRAY, "timestamp": INT64, "null": INT32}


def _leaf_types(name: str, t: _Type, prefix=()) -> List[Tuple]:
    """(path, leaf type) of every leaf under ``t``."""
    path = prefix + (name,)
    if t.kind == "struct":
        return [lt for k, ft in t.fields.items()
                for lt in _leaf_types(k, ft, path)]
    if t.kind == "list":
        return _leaf_types("element", t.element, path + ("list",))
    return [(path, t)]


def _shred(v, t: _Type, d: int, r: int, rep_depth: int,
           sinks: List[Tuple[List, List, List]], at: int) -> int:
    """Append the levels and values of ``v`` (type ``t``, its parent
    defined at level ``d``) to the leaf sinks from ``at``; -> the next
    sink index."""
    if t.kind == "struct":
        if _is_null(v):
            n = len(_leaf_types("", t))
            for j in range(at, at + n):
                sinks[j][0].append(d)
                sinks[j][1].append(r)
            return at + n
        j = at
        for k, ft in t.fields.items():
            j = _shred(v.get(k) if isinstance(v, Mapping) else None, ft,
                       d + 1, r, rep_depth, sinks, j)
        return j
    if t.kind == "list":
        n = len(_leaf_types("", t))
        if _is_null(v):
            for j in range(at, at + n):
                sinks[j][0].append(d)
                sinks[j][1].append(r)
            return at + n
        items = v.tolist() if isinstance(v, np.ndarray) else list(v)
        if not items:
            for j in range(at, at + n):
                sinks[j][0].append(d + 1)
                sinks[j][1].append(r)
            return at + n
        for i, e in enumerate(items):
            _shred(e, t.element, d + 2, r if i == 0 else rep_depth + 1,
                   rep_depth + 1, sinks, at)
        return at + n
    sink = sinks[at]
    if _is_null(v):
        sink[0].append(d)
        sink[1].append(r)
    else:
        sink[0].append(d + 1)
        sink[1].append(r)
        sink[2].append(v)
    return at + 1


def _max_levels(t: _Type, d: int = 1, r: int = 0) -> List[Tuple[int, int]]:
    if t.kind == "struct":
        return [lv for ft in t.fields.values()
                for lv in _max_levels(ft, d + 1, r)]
    if t.kind == "list":
        return _max_levels(t.element, d + 2, r + 1)
    return [(d, r)]


def _plain_bytes(t: _Type, values) -> bytes:
    if t.kind == "bool":
        return np.packbits(np.asarray(values, dtype=bool),
                           bitorder="little").tobytes()
    if t.kind in ("int32", "null"):
        return np.asarray(values, dtype="<i4").tobytes()
    if t.kind == "timestamp":
        arr = np.asarray(values)
        if arr.dtype.kind == "M":
            arr = arr.view(np.int64)
        return arr.astype("<i8").tobytes()
    if t.kind == "int64":
        arr = np.asarray(values)
        if arr.dtype.kind == "u":
            arr = arr.view(np.int64)
        return arr.astype("<i8").tobytes()
    if t.kind == "float":
        return np.asarray(values, dtype="<f4").tobytes()
    if t.kind == "double":
        return np.asarray(values, dtype="<f8").tobytes()
    parts = []
    for v in values:
        b = v.encode("utf-8") if isinstance(v, str) else bytes(v)
        parts.append(len(b).to_bytes(4, "little"))
        parts.append(b)
    return b"".join(parts)


#: rows a written row group holds at most
ROW_GROUP_ROWS = 1 << 20

#: a leaf's values are dictionary-encoded when they hold at most this many
#: distinct values and at most half as many as values
DICT_MAX = 1 << 16


def _dictionary(t: _Type, values):
    """(distinct values, each value's index) when a dictionary page pays
    (``DICT_MAX``), else None. Numbers are told apart by their bits, so
    -0.0 keeps its sign."""
    n = len(values)
    if n < 16 or t.kind in ("bool", "null"):
        return None
    if t.kind in ("string", "binary"):
        index: Dict[Any, int] = {}
        idx = [index.setdefault(v, len(index)) for v in values]
        if len(index) > min(DICT_MAX, n // 2):
            return None
        return list(index), np.asarray(idx, dtype=np.int64)
    arr = np.asarray(values)
    if arr.dtype.kind == "M":
        arr = arr.view(np.int64)
    dt = {"int32": "<i4", "int64": "<i8", "timestamp": "<i8",
          "float": "<f4", "double": "<f8"}[t.kind]
    if t.kind == "int64" and arr.dtype.kind == "u":
        arr = arr.view(np.int64)
    arr = arr.astype(dt)
    bits = arr.view({4: np.int32, 8: np.int64}[arr.dtype.itemsize])
    uniq, idx = np.unique(bits, return_inverse=True)
    if len(uniq) > min(DICT_MAX, n // 2):
        return None
    return uniq.view(arr.dtype), idx.astype(np.int64)


def _levels_block(levels: np.ndarray, max_level: int) -> bytes:
    enc = rle_hybrid_encode(levels, _bit_width(max_level))
    return len(enc).to_bytes(4, "little") + enc


def _pandas_types(arr: np.ndarray, t: _Type) -> Tuple[str, str]:
    """(pandas_type, numpy_type) of the ``pandas`` metadata, as pyarrow
    names them."""
    numpy_type = "object" if arr.dtype == object else str(arr.dtype)
    names = {"bool": "bool", "int64": "int64", "double": "float64",
             "float": "float32", "string": "unicode", "binary": "bytes",
             "null": "empty", "struct": "object",
             "timestamp": "datetime"}
    if t.kind == "int32":
        pt = f"{'' if t.signed else 'u'}int{t.bits}"
    elif t.kind == "list":
        inner = _pandas_types(np.empty(0, object), t.element)[0]
        pt = f"list[{inner}]"
    else:
        pt = names[t.kind]
    return pt, numpy_type


def write_parquet(path: str, columns: Mapping[str, np.ndarray],
                  compression: Optional[str] = "snappy",
                  index: Optional[np.ndarray] = None) -> None:
    """Write ``columns`` (name -> numpy column of one length; object
    columns of python values, None or NaN null) as a Parquet file that
    ``pd.read_parquet`` reads back as the frame of these columns with a
    RangeIndex, or with ``index`` (int64) as its index."""
    codec = _CODEC_IDS.get(compression)
    if codec is None:
        raise ParquetError(f"{path}: compression {compression!r} is not "
                           f"written (snappy or None)")
    cols = {str(k): np.asarray(v) if not isinstance(v, np.ndarray) else v
            for k, v in columns.items()}
    if index is not None:
        cols["__index_level_0__"] = np.asarray(index, dtype=np.int64)
    sizes = {len(v) for v in cols.values()}
    if len(sizes) > 1:
        raise ParquetError(f"{path}: columns differ in length: "
                           f"{sorted(sizes)}")
    n_rows = sizes.pop() if sizes else 0
    types = {k: _infer(v, k) for k, v in cols.items()}
    schema: List = [[(4, _T_BINARY, "schema"),
                     (5, _T_I32, len(cols))]]
    for k, t in types.items():
        _schema_elements(k, t, schema)
    body = bytearray(MAGIC)
    row_groups = []
    starts = list(range(0, n_rows, ROW_GROUP_ROWS)) or [0]
    for g0 in starts:
        g1 = min(g0 + ROW_GROUP_ROWS, n_rows)
        chunk_meta = []
        group_bytes = 0
        group_start = len(body)
        for k, t in types.items():
            arr = cols[k][g0:g1]
            for (lpath, lt), (max_d, max_r), (defs, reps, vals) in zip(
                    _leaf_types(k, t), _max_levels(t),
                    _shred_column(arr, t)):
                offset = len(body)
                levels = bytearray()
                if max_r:
                    levels += _levels_block(reps, max_r)
                levels += _levels_block(defs, max_d)
                dict_at = None
                usize = csize = 0
                coded = _dictionary(lt, vals)
                if coded is None:
                    enc, payload = PLAIN, _plain_bytes(lt, vals)
                else:
                    uniq, idx = coded
                    dict_at = offset
                    raw = _plain_bytes(lt, uniq)
                    comp = _compress(codec, raw)
                    w = _Writer()
                    w.struct([(1, _T_I32, DICTIONARY_PAGE),
                              (2, _T_I32, len(raw)), (3, _T_I32, len(comp)),
                              (7, _T_STRUCT, [(1, _T_I32, len(uniq)),
                                              (2, _T_I32, PLAIN)])])
                    body += w.out
                    body += comp
                    usize += len(w.out) + len(raw)
                    csize += len(w.out) + len(comp)
                    bw = max(1, _bit_width(len(uniq) - 1))
                    enc = RLE_DICTIONARY
                    payload = bytes([bw]) + rle_hybrid_encode(idx, bw)
                page = bytes(levels) + payload
                comp = _compress(codec, page)
                w = _Writer()
                w.struct([(1, _T_I32, DATA_PAGE),
                          (2, _T_I32, len(page)),
                          (3, _T_I32, len(comp)),
                          (5, _T_STRUCT, [(1, _T_I32, len(defs)),
                                          (2, _T_I32, enc),
                                          (3, _T_I32, RLE),
                                          (4, _T_I32, RLE)])])
                data_at = len(body)
                body += w.out
                body += comp
                usize += len(w.out) + len(page)
                csize += len(w.out) + len(comp)
                group_bytes += usize
                encodings = [PLAIN, RLE] + ([RLE_DICTIONARY] if dict_at
                                            is not None else [])
                chunk_meta.append([
                    (2, _T_I64, offset),
                    (3, _T_STRUCT, [
                        (1, _T_I32, _PHYSICAL[lt.kind]),
                        (2, _T_LIST, (_T_I32, encodings)),
                        (3, _T_LIST, (_T_BINARY, list(lpath))),
                        (4, _T_I32, codec),
                        (5, _T_I64, len(defs)),
                        (6, _T_I64, usize),
                        (7, _T_I64, csize),
                        (9, _T_I64, data_at),
                        (11, _T_I64, dict_at)])])
        row_groups.append([(1, _T_LIST, (_T_STRUCT, chunk_meta)),
                           (2, _T_I64, group_bytes),
                           (3, _T_I64, g1 - g0),
                           (5, _T_I64, group_start),
                           (6, _T_I64, len(body) - group_start)])
    pd_meta = _pandas_metadata(cols, types, n_rows, index is not None)
    w = _Writer()
    w.struct([(1, _T_I32, 2),
              (2, _T_LIST, (_T_STRUCT, schema)),
              (3, _T_I64, n_rows),
              (4, _T_LIST, (_T_STRUCT, row_groups)),
              (5, _T_LIST, (_T_STRUCT, [[(1, _T_BINARY, "pandas"),
                                          (2, _T_BINARY, pd_meta)]])),
              (6, _T_BINARY, "transmogrifai_tpu_torch parquet writer")])
    body += w.out
    body += len(w.out).to_bytes(4, "little")
    body += MAGIC
    with open(path, "wb") as fh:
        fh.write(bytes(body))


def _shred_column(arr: np.ndarray, t: _Type):
    """[(def levels, rep levels, values)] of each leaf of a top-level
    column; a flat column vectorized."""
    if t.kind not in ("struct", "list"):
        if arr.dtype == object:
            valid = np.array([not _is_null(v) for v in arr.tolist()],
                             dtype=bool)
        elif arr.dtype.kind == "f":
            valid = ~np.isnan(arr)
        elif arr.dtype.kind == "M":
            valid = ~np.isnat(arr)
        else:
            valid = np.ones(len(arr), dtype=bool)
        vals = arr[valid]
        if t.kind == "null":
            vals = np.zeros(0, np.int32)
        elif arr.dtype == object:
            vals = vals.tolist()
        return [(valid.astype(np.int64), np.zeros(len(arr), np.int64),
                 vals)]
    if t.kind == "list" and t.element.kind not in ("struct", "list"):
        return [_shred_flat_list(arr, t.element)]
    n_leaves = len(_leaf_types("", t))
    sinks = [([], [], []) for _ in range(n_leaves)]
    for v in arr.tolist():
        _shred(v, t, 0, 0, 0, sinks, 0)
    return [(np.asarray(d, np.int64), np.asarray(r, np.int64), vals)
            for d, r, vals in sinks]


def _shred_flat_list(arr: np.ndarray, elem: _Type):
    """(def, rep, values) of a top-level list of a primitive, levels
    vectorized: a null row (0, 0), an empty one (1, 0), an element (2 null
    or 3 present, rep 0 first and 1 after)."""
    from itertools import chain
    cells = arr.tolist()
    null_row = np.array([_is_null(c) for c in cells], dtype=bool)
    lengths = np.array([0 if nl else len(c) for c, nl in zip(
        cells, null_row)], dtype=np.int64)
    items = [c.tolist() if isinstance(c, np.ndarray) else c
             for c, nl in zip(cells, null_row) if not nl]
    flat = list(chain.from_iterable(items))
    if elem.kind in ("double", "float"):
        vals = np.array(flat, dtype=np.float64)
        valid = ~np.isnan(vals)
    else:
        vals = np.empty(len(flat), dtype=object)
        vals[:] = flat
        valid = np.array([not _is_null(v) for v in flat], dtype=bool)
    entries = np.maximum(lengths, 1)
    n = int(entries.sum())
    row_start = np.cumsum(entries) - entries
    reps = np.ones(n, dtype=np.int64)
    reps[row_start] = 0
    defs = np.empty(n, dtype=np.int64)
    has = lengths > 0
    elem_at = np.ones(n, dtype=bool)
    elem_at[row_start[~has]] = False
    defs[elem_at] = np.where(valid, 3, 2)
    defs[row_start[null_row]] = 0
    defs[row_start[~null_row & ~has]] = 1
    out = vals[valid]
    return defs, reps, out.tolist() if out.dtype == object else out


def _pandas_metadata(cols, types, n_rows: int, stored_index: bool) -> str:
    entries = []
    for k, arr in cols.items():
        pt, nt = _pandas_types(arr, types[k])
        entries.append({"name": None if k == "__index_level_0__" else k,
                        "field_name": k, "pandas_type": pt,
                        "numpy_type": nt, "metadata": None})
    index = (["__index_level_0__"] if stored_index else
             [{"kind": "range", "name": None, "start": 0, "stop": n_rows,
               "step": 1}])
    return json.dumps({
        "index_columns": index,
        "column_indexes": [{"name": None, "field_name": None,
                            "pandas_type": "unicode", "numpy_type": "str",
                            "metadata": {"encoding": "UTF-8"}}],
        "columns": entries, "attributes": {},
        "creator": {"library": "transmogrifai_tpu_torch",
                    "version": "1"}})


__all__ = ["ParquetError", "read_parquet", "write_parquet",
           "read_metadata", "snappy_compress", "snappy_decompress",
           "rle_hybrid_decode", "rle_hybrid_encode"]
