"""Avro Object Container Files in pure Python (counterpart of
``transmogrifai_tpu.utils.avro``, a copy: the port imports nothing of the
JAX package): the header, the null and deflate codecs and the zigzag
varint primitives of Avro 1.11, records in and out as plain dicts.

Schema types: null, boolean, int, long, float, double, bytes, string,
record, enum, array, map, fixed and unions of them. Logical types pass
through as their underlying primitives. ``write_avro`` draws its sync
marker from ``os.urandom``, so two writes of the same records decode
equal and differ in their bytes. A file of no records holds one block of
0 records, its empty payload written through the codec; the reader skips
such a block (the JAX package writes a deflate file's as no bytes, which
it cannot inflate).
"""
from __future__ import annotations

import io
import json
import os
import struct
import zlib
from typing import Any, BinaryIO, Dict, Iterator, List, Optional, Sequence

MAGIC = b"Obj\x01"
_SYNC_SIZE = 16


# ---------------------------------------------------------------------------
# Primitive codecs (Avro spec: zigzag varints, little-endian IEEE floats)
# ---------------------------------------------------------------------------

def _read_long(buf: BinaryIO) -> int:
    shift = 0
    acc = 0
    while True:
        b = buf.read(1)
        if not b:
            raise EOFError("truncated varint")
        byte = b[0]
        acc |= (byte & 0x7F) << shift
        if not byte & 0x80:
            break
        shift += 7
    return (acc >> 1) ^ -(acc & 1)


def _write_long(out: io.BytesIO, value: int) -> None:
    value = (value << 1) ^ (value >> 63)
    while True:
        if value & ~0x7F:
            out.write(bytes([(value & 0x7F) | 0x80]))
            value >>= 7
        else:
            out.write(bytes([value]))
            return


def _read_bytes(buf: BinaryIO) -> bytes:
    n = _read_long(buf)
    data = buf.read(n)
    if len(data) != n:
        raise EOFError("truncated bytes")
    return data


def _write_bytes(out: io.BytesIO, data: bytes) -> None:
    _write_long(out, len(data))
    out.write(data)


# ---------------------------------------------------------------------------
# Schema-driven datum codec
# ---------------------------------------------------------------------------

def _named(schema: Any) -> Any:
    """Normalize a schema node to a dict with a 'type' key or a string."""
    if isinstance(schema, str):
        return schema
    if isinstance(schema, list):
        return schema
    return schema


def _read_datum(buf: BinaryIO, schema: Any, names: Dict[str, Any]) -> Any:
    schema = _named(schema)
    if isinstance(schema, list):                       # union
        idx = _read_long(buf)
        return _read_datum(buf, schema[idx], names)
    if isinstance(schema, dict):
        t = schema["type"]
    else:
        t = schema
    if t in names and not isinstance(schema, dict):
        return _read_datum(buf, names[t], names)
    if t == "null":
        return None
    if t == "boolean":
        return buf.read(1) == b"\x01"
    if t in ("int", "long"):
        return _read_long(buf)
    if t == "float":
        return struct.unpack("<f", buf.read(4))[0]
    if t == "double":
        return struct.unpack("<d", buf.read(8))[0]
    if t == "bytes":
        return _read_bytes(buf)
    if t == "string":
        return _read_bytes(buf).decode("utf-8")
    if t == "record":
        out = {}
        for f in schema["fields"]:
            out[f["name"]] = _read_datum(buf, f["type"], names)
        return out
    if t == "enum":
        return schema["symbols"][_read_long(buf)]
    if t == "fixed":
        return buf.read(schema["size"])
    if t == "array":
        items: List[Any] = []
        while True:
            n = _read_long(buf)
            if n == 0:
                break
            if n < 0:
                _read_long(buf)  # block byte size, unused
                n = -n
            for _ in range(n):
                items.append(_read_datum(buf, schema["items"], names))
        return items
    if t == "map":
        out = {}
        while True:
            n = _read_long(buf)
            if n == 0:
                break
            if n < 0:
                _read_long(buf)
                n = -n
            for _ in range(n):
                k = _read_bytes(buf).decode("utf-8")
                out[k] = _read_datum(buf, schema["values"], names)
        return out
    raise ValueError(f"unsupported avro type {t!r}")


def _union_index(schema: List[Any], value: Any) -> int:
    def kind(s):
        return s if isinstance(s, str) else s.get("type")

    if value is None:
        for i, s in enumerate(schema):
            if kind(s) == "null":
                return i
    prefer = {bool: ("boolean",), int: ("long", "int", "double", "float"),
              float: ("double", "float"), str: ("string", "enum"),
              bytes: ("bytes", "fixed"), dict: ("record", "map"),
              list: ("array",)}
    for want in prefer.get(type(value), ()):
        for i, s in enumerate(schema):
            if kind(s) == want:
                return i
    for i, s in enumerate(schema):
        if kind(s) != "null":
            return i
    raise ValueError(f"no union branch for {value!r} in {schema}")


def _write_datum(out: io.BytesIO, schema: Any, value: Any,
                 names: Dict[str, Any]) -> None:
    schema = _named(schema)
    if isinstance(schema, list):
        idx = _union_index(schema, value)
        _write_long(out, idx)
        _write_datum(out, schema[idx], value, names)
        return
    t = schema["type"] if isinstance(schema, dict) else schema
    if t in names and not isinstance(schema, dict):
        _write_datum(out, names[t], value, names)
        return
    if t == "null":
        return
    if t == "boolean":
        out.write(b"\x01" if value else b"\x00")
    elif t in ("int", "long"):
        _write_long(out, int(value))
    elif t == "float":
        out.write(struct.pack("<f", float(value)))
    elif t == "double":
        out.write(struct.pack("<d", float(value)))
    elif t == "bytes":
        _write_bytes(out, bytes(value))
    elif t == "string":
        _write_bytes(out, str(value).encode("utf-8"))
    elif t == "record":
        for f in schema["fields"]:
            _write_datum(out, f["type"], value.get(f["name"]), names)
    elif t == "enum":
        _write_long(out, schema["symbols"].index(value))
    elif t == "fixed":
        out.write(bytes(value))
    elif t == "array":
        if value:
            _write_long(out, len(value))
            for v in value:
                _write_datum(out, schema["items"], v, names)
        _write_long(out, 0)
    elif t == "map":
        if value:
            _write_long(out, len(value))
            for k, v in value.items():
                _write_bytes(out, str(k).encode("utf-8"))
                _write_datum(out, schema["values"], v, names)
        _write_long(out, 0)
    else:
        raise ValueError(f"unsupported avro type {t!r}")


def _collect_names(schema: Any, names: Dict[str, Any]) -> None:
    if isinstance(schema, list):
        for s in schema:
            _collect_names(s, names)
    elif isinstance(schema, dict):
        t = schema.get("type")
        if t in ("record", "enum", "fixed") and "name" in schema:
            names[schema["name"]] = schema
            ns = schema.get("namespace")
            if ns:
                names[f"{ns}.{schema['name']}"] = schema
        if t == "record":
            for f in schema.get("fields", []):
                _collect_names(f["type"], names)
        elif t == "array":
            _collect_names(schema.get("items"), names)
        elif t == "map":
            _collect_names(schema.get("values"), names)


# ---------------------------------------------------------------------------
# Container files
# ---------------------------------------------------------------------------

def read_avro(path: str) -> Iterator[Dict[str, Any]]:
    """Iterate records of an Avro Object Container File."""
    with open(path, "rb") as fh:
        if fh.read(4) != MAGIC:
            raise ValueError(f"{path}: not an avro container file")
        meta_schema = {"type": "map", "values": "bytes"}
        meta = _read_datum(fh, meta_schema, {})
        schema = json.loads(meta["avro.schema"].decode("utf-8"))
        codec = meta.get("avro.codec", b"null").decode("utf-8")
        if codec not in ("null", "deflate"):
            raise ValueError(f"unsupported avro codec {codec!r}")
        names: Dict[str, Any] = {}
        _collect_names(schema, names)
        fh.read(_SYNC_SIZE)
        while True:
            head = fh.read(1)
            if not head:
                return
            fh.seek(-1, os.SEEK_CUR)
            try:
                count = _read_long(fh)
            except EOFError:
                return
            block = _read_bytes(fh)
            if count == 0:         # an empty file's one block
                fh.read(_SYNC_SIZE)
                continue
            if codec == "deflate":
                block = zlib.decompress(block, -15)
            buf = io.BytesIO(block)
            for _ in range(count):
                yield _read_datum(buf, schema, names)
            fh.read(_SYNC_SIZE)


def schema_of_records(records: Sequence[Dict[str, Any]],
                      name: str = "Row") -> Dict[str, Any]:
    """Infer a nullable-union record schema from dict records."""
    fields: Dict[str, set] = {}
    for r in records:
        for k, v in r.items():
            kinds = fields.setdefault(k, set())
            if v is None:
                kinds.add("null")
            elif isinstance(v, bool):
                kinds.add("boolean")
            elif isinstance(v, int):
                kinds.add("long")
            elif isinstance(v, float):
                kinds.add("double")
            else:
                kinds.add("string")
    out_fields = []
    for k, kinds in fields.items():
        kinds.discard("null")
        if kinds == {"long"}:
            t: Any = "long"
        elif kinds <= {"long", "double"} and kinds:
            t = "double"
        elif kinds == {"boolean"}:
            t = "boolean"
        else:
            t = "string"
        out_fields.append({"name": k, "type": ["null", t]})
    return {"type": "record", "name": name, "fields": out_fields}


def write_avro(path: str, records: Sequence[Dict[str, Any]],
               schema: Optional[Dict[str, Any]] = None,
               codec: str = "deflate", sync_interval: int = 4000) -> None:
    """Write records to an Avro Object Container File."""
    if schema is None:
        schema = schema_of_records(records)
    if codec not in ("null", "deflate"):
        raise ValueError(f"unsupported avro codec {codec!r}")
    names: Dict[str, Any] = {}
    _collect_names(schema, names)
    sync = os.urandom(_SYNC_SIZE)
    with open(path, "wb") as fh:
        fh.write(MAGIC)
        head = io.BytesIO()
        meta = {"avro.schema": json.dumps(schema).encode("utf-8"),
                "avro.codec": codec.encode("utf-8")}
        _write_datum(head, {"type": "map", "values": "bytes"}, meta, {})
        fh.write(head.getvalue())
        fh.write(sync)
        i = 0
        while i < len(records):
            chunk = records[i:i + sync_interval]
            i += sync_interval
            block = io.BytesIO()
            for r in chunk:
                _write_datum(block, schema, r, names)
            payload = block.getvalue()
            if codec == "deflate":
                co = zlib.compressobj(9, zlib.DEFLATED, -15)
                payload = co.compress(payload) + co.flush()
            frame = io.BytesIO()
            _write_long(frame, len(chunk))
            _write_bytes(frame, payload)
            fh.write(frame.getvalue())
            fh.write(sync)
        if not records:
            payload = b""
            if codec == "deflate":
                co = zlib.compressobj(9, zlib.DEFLATED, -15)
                payload = co.compress(payload) + co.flush()
            frame = io.BytesIO()
            _write_long(frame, 0)
            _write_bytes(frame, payload)
            fh.write(frame.getvalue())
            fh.write(sync)
