"""Wire protocol for the network edge (serving/netedge.py).

The PyTorch port's copy of the JAX package's ``serving/netproto.py``:
the frame layout is the contract between the two packages, so a frame
encoded by either decodes byte for byte in the other, and either
package's :class:`WireClient` talks to either package's edge. It uses
numpy, ``struct`` and ``socket`` only.

Two framings terminate on the same scoring path (docs/serving.md
"Network edge"):

* **HTTP/JSON** — ``POST /score`` with a ``{"rows": [...]}`` body; the
  compatible slow path. Decoding is per-row: the JSON parser hands back
  a list of row dicts.
* **Binary batch** (``TGB1``) — a length-prefixed columnar frame; the
  fast path. The payload carries one contiguous block *per column*
  (little-endian float64/int64, u8 booleans, length-prefixed UTF-8) plus
  an optional null bitmap, so decode is one ``np.frombuffer`` sweep per
  column instead of ``rows x cols`` JSON token parses. Columns are
  zipped into row dicts in a single C-level sweep only at the submit
  boundary (the runtime batches per-request rows), and those dicts feed
  ``serve_table_builder``'s vectorized per-feature gather unchanged.

Binary frame layout (all integers big-endian unless noted)::

    frame   := magic(4)="TGB1" | kind(1) | payload_len(u32)| payload
    kind    := 1 request | 2 response | 3 error
    request := header_len(u16) | header(JSON utf-8) | column blocks
    header  := {"rows": n, "tenant"?, "token"?, "deadlineMs"?, "model"?,
                "columns": [{"name", "kind", "nulls"}...]}

The optional ``model`` field (HTTP twin: ``X-TG-Model``) selects which
registered model scores the rows — the multi-model placement layer
(serving/placement.py) routes it to a warm holder or pages it in; an
unknown id is a typed 404 (``unknown_model``), mirroring the tenant
plumbing.

Column blocks appear in header order. When ``nulls`` is true the block
opens with a ``ceil(n/8)``-byte bitmap (bit ``i`` set = row ``i`` is
null; null slots in the data block are zero-filled carriers). Kinds:
``f8`` n*8 bytes little-endian float64, ``i8`` n*8 bytes little-endian
int64, ``b1`` n bytes u8 0/1, ``u8`` per value u32 length + UTF-8
bytes. Response/error payloads are JSON (the response path is not the
hot loop); errors carry ``{"status", "error", "message", "retryAfterS"?}``
using the same status codes as the HTTP mapping.

Every malformed condition raises :class:`FrameError` — the edge maps it
to a typed 400 shed, never an untyped escape. :class:`WireClient` is the
shared synchronous client (tests, loadgen socket driver, campaign ``net``
scenario, bench wire lines, ``op serve --listen``); a connection that
dies mid-request raises :class:`WireDisconnect`, which callers count in
the typed ``shedDisconnect`` bucket — never ``lost``.
"""
from __future__ import annotations

import json
import os
import socket
import struct
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

MAGIC = b"TGB1"
KIND_REQUEST = 1
KIND_RESPONSE = 2
KIND_ERROR = 3

#: magic(4) + kind(1) + payload_len(u32)
FRAME_HEADER = struct.Struct(">4sBI")
_U16 = struct.Struct(">H")
_U32 = struct.Struct(">I")

#: column kinds: dtype for the fixed-width ones, None for utf-8
COLUMN_KINDS: Dict[str, Optional[str]] = {
    "f8": "<f8", "i8": "<i8", "b1": "u1", "u8": None}

#: hard per-request row cap (override: TG_NET_MAX_ROWS). The header's
#: "rows" field is untrusted input and must never size an allocation on
#: its own — column truncation checks bound it when blocks exist, this
#: cap bounds the degenerate cases.
DEFAULT_MAX_ROWS = 1 << 20


def _max_rows() -> int:
    try:
        return int(os.environ.get("TG_NET_MAX_ROWS", "")
                   or DEFAULT_MAX_ROWS)
    except ValueError:
        return DEFAULT_MAX_ROWS


class FrameError(ValueError):
    """A malformed frame/request: bad magic, truncated block, header
    overrun, unknown column kind, invalid JSON. Typed — the edge answers
    400 and the connection survives when the payload was consumed."""


class WireDisconnect(ConnectionError):
    """The peer vanished mid-request (reset / EOF before a full
    response). The client-side twin of the server's ``disconnect`` shed
    reason; load generators count it as ``shedDisconnect``."""


# -- columnar encode (client side) -------------------------------------------

def columns_from_rows(rows: List[Dict[str, Any]]
                      ) -> Tuple[List[str], List[List[Any]]]:
    """Pivot row dicts into (names, columns) in first-seen key order —
    the client-side half of the columnar fast path."""
    names: List[str] = []
    seen = set()
    for r in rows:
        for k in r:
            if k not in seen:
                seen.add(k)
                names.append(str(k))
    cols = [[r.get(n) for r in rows] for n in names]
    return names, cols


def _column_kind(vals: List[Any]) -> str:
    kinds = set()
    for v in vals:
        if v is None:
            continue
        if isinstance(v, (bool, np.bool_)):
            kinds.add("b1")
        elif isinstance(v, (int, np.integer)):
            kinds.add("i8")
        elif isinstance(v, (float, np.floating)):
            kinds.add("f8")
        else:
            kinds.add("u8")
    if not kinds:
        return "f8"  # all-null column: carrier kind is arbitrary
    if kinds == {"b1"}:
        return "b1"
    if kinds == {"i8"}:
        return "i8"
    if kinds <= {"i8", "f8"}:
        return "f8"
    return "u8"


def _null_bitmap(vals: List[Any]) -> Optional[bytes]:
    bm = bytearray((len(vals) + 7) // 8)
    any_null = False
    for i, v in enumerate(vals):
        if v is None:
            bm[i >> 3] |= 1 << (i & 7)
            any_null = True
    return bytes(bm) if any_null else None


def _encode_column(kind: str, vals: List[Any]) -> bytes:
    if kind == "u8":
        out = bytearray()
        for v in vals:
            b = b"" if v is None else str(v).encode("utf-8")
            out += _U32.pack(len(b)) + b
        return bytes(out)
    if kind == "b1":
        return bytes(1 if v else 0 for v in vals)
    dtype = COLUMN_KINDS[kind]
    zero = 0 if kind == "i8" else 0.0
    return np.asarray([zero if v is None else v for v in vals],
                      dtype=dtype).tobytes()


def encode_binary_request(rows: List[Dict[str, Any]],
                          tenant: Optional[str] = None,
                          token: Optional[str] = None,
                          deadline_ms: Optional[float] = None,
                          model: Optional[str] = None,
                          scratch: Optional[bytearray] = None) -> bytes:
    """One request frame carrying ``rows`` as column blocks.

    ``scratch`` is an optional growable reuse buffer: the frame is
    assembled in place (header reserved up front, then packed over) and
    the *same bytearray* is returned, so a steady-state connection stops
    allocating a fresh frame per request — the buffer grows to the
    largest frame the connection ever sent and stays there. The returned
    buffer is only valid until the next encode into the same scratch;
    ``WireClient`` keeps one per connection and hands it straight to
    ``sendall`` (which takes any buffer), never holding it across
    requests. Without ``scratch`` the function returns immutable
    ``bytes`` as before."""
    names, cols = columns_from_rows(rows)
    col_meta = []
    blocks = []
    for name, vals in zip(names, cols):
        kind = _column_kind(vals)
        bitmap = _null_bitmap(vals)
        col_meta.append({"name": name, "kind": kind,
                         "nulls": bitmap is not None})
        blocks.append((bitmap or b"") + _encode_column(kind, vals))
    header: Dict[str, Any] = {"rows": len(rows), "columns": col_meta}
    if tenant is not None:
        header["tenant"] = tenant
    if token is not None:
        header["token"] = token
    if deadline_ms is not None:
        header["deadlineMs"] = deadline_ms
    if model is not None:
        header["model"] = model
    hdr = json.dumps(header, separators=(",", ":")).encode("utf-8")
    buf = bytearray() if scratch is None else scratch
    del buf[:]  # drop the previous frame, keep the capacity
    buf += b"\x00" * FRAME_HEADER.size
    buf += _U16.pack(len(hdr))
    buf += hdr
    for block in blocks:
        buf += block
    FRAME_HEADER.pack_into(buf, 0, MAGIC, KIND_REQUEST,
                           len(buf) - FRAME_HEADER.size)
    return buf if scratch is not None else bytes(buf)


def encode_binary_response(status: int, obj: Dict[str, Any]) -> bytes:
    kind = KIND_RESPONSE if status == 200 else KIND_ERROR
    payload = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    return FRAME_HEADER.pack(MAGIC, kind, len(payload)) + payload


# -- columnar decode (server side) -------------------------------------------

def _decode_column(kind: str, n: int, payload: bytes, off: int,
                   nulls: bool) -> Tuple[List[Any], int]:
    mask: Optional[bytearray] = None
    if nulls:
        nb = (n + 7) // 8
        if off + nb > len(payload):
            raise FrameError("column null bitmap truncated")
        mask = bytearray(payload[off:off + nb])
        off += nb
    if kind == "u8":
        vals: List[Any] = []
        for _ in range(n):
            if off + 4 > len(payload):
                raise FrameError("utf8 column truncated")
            ln = _U32.unpack_from(payload, off)[0]
            off += 4
            if off + ln > len(payload):
                raise FrameError("utf8 value truncated")
            vals.append(payload[off:off + ln].decode("utf-8"))
            off += ln
    else:
        dtype = COLUMN_KINDS.get(kind)
        if dtype is None:
            raise FrameError(f"unknown column kind '{kind}'")
        width = np.dtype(dtype).itemsize
        end = off + n * width
        if end > len(payload):
            raise FrameError(f"{kind} column truncated")
        arr = np.frombuffer(payload, dtype=dtype, count=n, offset=off)
        if kind == "b1":
            vals = [bool(v) for v in arr]
        else:
            vals = arr.tolist()
        off = end
    if mask is not None:
        for i in range(n):
            if mask[i >> 3] & (1 << (i & 7)):
                vals[i] = None
    return vals, off


def decode_binary_request(payload: bytes,
                          max_rows: Optional[int] = None
                          ) -> Tuple[Dict[str, Any],
                                     List[Dict[str, Any]]]:
    """Decode a request payload into ``(header, rows)``. Column blocks
    decode with one ``np.frombuffer`` sweep each; rows materialize in a
    single ``zip`` sweep at the end (the submit boundary). The declared
    row count is bounded (``max_rows``, default ``TG_NET_MAX_ROWS``) and
    must be backed by column blocks — a 40-byte frame claiming 10**12
    rows is a :class:`FrameError`, not an allocation."""
    if len(payload) < _U16.size:
        raise FrameError("request payload shorter than its header length")
    hlen = _U16.unpack_from(payload, 0)[0]
    off = _U16.size + hlen
    if off > len(payload):
        raise FrameError("request header overruns the payload")
    try:
        header = json.loads(payload[_U16.size:off].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise FrameError(f"request header is not valid JSON: {e}") from e
    if not isinstance(header, dict):
        raise FrameError("request header must be a JSON object")
    try:
        n = int(header["rows"])
        col_meta = list(header.get("columns", []))
    except (KeyError, TypeError, ValueError) as e:
        raise FrameError(f"request header missing 'rows': {e}") from e
    if n < 0:
        raise FrameError("negative row count")
    cap = _max_rows() if max_rows is None else int(max_rows)
    if n > cap:
        raise FrameError(
            f"row count {n} exceeds TG_NET_MAX_ROWS={cap}")
    if n and not col_meta:
        raise FrameError(
            f"{n} row(s) declared but no column blocks back them")
    names: List[str] = []
    cols: List[List[Any]] = []
    for cm in col_meta:
        if not isinstance(cm, dict) or "name" not in cm:
            raise FrameError("column metadata entry missing 'name'")
        vals, off = _decode_column(str(cm.get("kind", "")), n, payload,
                                   off, bool(cm.get("nulls")))
        names.append(str(cm["name"]))
        cols.append(vals)
    if off != len(payload):
        raise FrameError(f"{len(payload) - off} trailing byte(s) after "
                         "the last column block")
    if cols:
        rows = [dict(zip(names, tup)) for tup in zip(*cols)]
    else:
        rows = [{} for _ in range(n)]
    return header, rows


# -- HTTP helpers (client side) ----------------------------------------------

def encode_http_request(rows: List[Dict[str, Any]],
                        tenant: Optional[str] = None,
                        token: Optional[str] = None,
                        deadline_ms: Optional[float] = None,
                        keep_alive: bool = True,
                        path: str = "/score",
                        model: Optional[str] = None) -> bytes:
    body = json.dumps({"rows": rows}, separators=(",", ":")).encode("utf-8")
    lines = [f"POST {path} HTTP/1.1", "Host: tg-edge",
             "Content-Type: application/json",
             f"Content-Length: {len(body)}",
             "Connection: " + ("keep-alive" if keep_alive else "close")]
    if token is not None:
        lines.append(f"X-TG-Token: {token}")
    if tenant is not None:
        lines.append(f"X-TG-Tenant: {tenant}")
    if deadline_ms is not None:
        lines.append(f"X-TG-Deadline-Ms: {deadline_ms:g}")
    if model is not None:
        lines.append(f"X-TG-Model: {model}")
    return ("\r\n".join(lines) + "\r\n\r\n").encode("ascii") + body


class _SockReader:
    """Minimal buffered reader over a blocking socket; EOF mid-read is a
    :class:`WireDisconnect` (read timeouts propagate as ``socket.timeout``
    so callers can tell a dead peer from a slow one)."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._buf = b""

    def _fill(self) -> None:
        chunk = self._sock.recv(65536)
        if not chunk:
            raise WireDisconnect("connection closed by peer")
        self._buf += chunk

    def read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            self._fill()
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def read_line(self, max_bytes: int = 65536) -> bytes:
        while b"\n" not in self._buf:
            if len(self._buf) > max_bytes:
                raise FrameError("header line too long")
            self._fill()
        line, self._buf = self._buf.split(b"\n", 1)
        return line.rstrip(b"\r")


def read_http_response(reader: _SockReader
                       ) -> Tuple[int, Dict[str, str], bytes]:
    status_line = reader.read_line()
    parts = status_line.split(None, 2)
    if len(parts) < 2 or not parts[1].isdigit():
        raise FrameError(f"malformed HTTP status line: {status_line!r}")
    status = int(parts[1])
    headers: Dict[str, str] = {}
    while True:
        line = reader.read_line()
        if not line:
            break
        if b":" in line:
            k, v = line.split(b":", 1)
            headers[k.decode("latin-1").strip().lower()] = \
                v.decode("latin-1").strip()
    body = reader.read_exact(int(headers.get("content-length", "0") or 0))
    return status, headers, body


# -- shared synchronous client -----------------------------------------------

@dataclass
class WireResult:
    """One request's outcome as seen on the wire."""
    status: int
    records: Optional[List[Dict[str, Any]]]
    error: Optional[str] = None
    retry_after_s: Optional[float] = None
    protocol: str = "http"


class WireClient:
    """Blocking client speaking either framing over one keep-alive
    connection. ``request`` returns a :class:`WireResult` for every
    response the server managed to send (including typed sheds — 4xx/5xx
    are *results*, not exceptions) and raises :class:`WireDisconnect`
    when the connection dies mid-request."""

    def __init__(self, host: str, port: int, protocol: str = "http",
                 token: Optional[str] = None, tenant: Optional[str] = None,
                 timeout: float = 10.0, model: Optional[str] = None):
        if protocol not in ("http", "binary"):
            raise ValueError(f"unknown protocol '{protocol}'")
        self.host, self.port, self.protocol = host, int(port), protocol
        self.token, self.tenant = token, tenant
        self.model = model
        self.timeout = timeout
        self._sock: Optional[socket.socket] = None
        self._reader: Optional[_SockReader] = None
        # per-connection encode scratch: binary frames are assembled in
        # this growable buffer instead of allocating bytes per request
        self._scratch = bytearray()

    # -- lifecycle ----------------------------------------------------------
    def connect(self) -> "WireClient":
        self.close()
        sock = socket.create_connection((self.host, self.port),
                                        timeout=self.timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock, self._reader = sock, _SockReader(sock)
        return self

    @property
    def connected(self) -> bool:
        return self._sock is not None

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._sock = None
        self._reader = None

    def __enter__(self) -> "WireClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- request/response ---------------------------------------------------
    def request(self, rows: List[Dict[str, Any]],
                deadline_ms: Optional[float] = None,
                model: Optional[str] = None) -> WireResult:
        if self._sock is None:
            self.connect()
        try:
            return self._exchange(rows, deadline_ms,
                                  self.model if model is None else model)
        except socket.timeout:
            # a late reply would be read as the answer to the *next*
            # request — the keep-alive stream is desynchronized, so the
            # next request must reconnect on a clean one
            self.close()
            raise
        except WireDisconnect:
            self.close()
            raise
        except (ConnectionError, BrokenPipeError, OSError) as e:
            self.close()
            raise WireDisconnect(f"connection died mid-request: {e}") from e

    def _exchange(self, rows, deadline_ms, model=None) -> WireResult:
        assert self._sock is not None and self._reader is not None
        if self.protocol == "binary":
            self._sock.sendall(encode_binary_request(
                rows, tenant=self.tenant, token=self.token,
                deadline_ms=deadline_ms, model=model,
                scratch=self._scratch))
            magic, kind, ln = FRAME_HEADER.unpack(
                self._reader.read_exact(FRAME_HEADER.size))
            if magic != MAGIC:
                raise FrameError(f"bad response magic {magic!r}")
            obj = json.loads(self._reader.read_exact(ln).decode("utf-8"))
            if kind == KIND_RESPONSE:
                return WireResult(200, obj.get("results"), protocol="binary")
            return WireResult(int(obj.get("status", 500)), None,
                              error=obj.get("error"),
                              retry_after_s=obj.get("retryAfterS"),
                              protocol="binary")
        self._sock.sendall(encode_http_request(
            rows, tenant=self.tenant, token=self.token,
            deadline_ms=deadline_ms, model=model))
        status, headers, body = read_http_response(self._reader)
        retry = None
        if "retry-after" in headers:
            try:
                retry = float(headers["retry-after"])
            except ValueError:
                retry = None
        try:
            obj = json.loads(body.decode("utf-8")) if body else {}
        except (UnicodeDecodeError, json.JSONDecodeError):
            obj = {}
        if headers.get("connection", "").lower() == "close":
            self.close()
        if status == 200:
            return WireResult(200, obj.get("results"), retry_after_s=retry)
        return WireResult(status, None, error=obj.get("error"),
                          retry_after_s=retry)
