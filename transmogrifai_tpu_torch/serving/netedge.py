"""Chaos-hardened asyncio network edge over the serving stack.

The PyTorch port's copy of the JAX package's ``serving/netedge.py``: the
same statuses (:data:`SHED_STATUS`), ``Retry-After`` rule, chaos sites
and series, so a client cannot tell the two packages' edges apart.

:class:`NetEdge` terminates both wire framings (serving/netproto.py) on
a localhost-or-beyond TCP listener and submits per-request rows to any
target that duck-types ``submit(row, deadline_ms=..., tenant=...)`` — a
:class:`~.runtime.ServingRuntime` or a fleet
:class:`~.frontdoor.FrontDoor` — so every in-process guarantee
(zero-lost-futures accounting, typed sheds, SLO budgets) extends across
the socket (docs/serving.md "Network edge").

Robustness contract:

* **Typed sheds, never lost futures.** Every failure mode a socket can
  produce — malformed frame, oversized payload, slow-loris reader,
  half-open peer, mid-request disconnect — resolves as a typed shed on
  ``tg_net_shed_total{reason}`` with a mapped status code
  (:data:`SHED_STATUS`). Futures already submitted when a connection
  dies are *always* awaited to resolution; the runtime's accounting
  identity stays intact.
* **Backpressure at the edge.** Queue-full / admission refusals map to
  429/503 with a ``Retry-After`` derived from the *windowed* shed rate
  (:func:`derive_retry_after` over the target's and edge's
  MetricsSampler windows), clamped to
  ``[retry_min_s, retry_max_s]`` and absent when the window is clean.
* **Per-tenant auth/quota at the socket.** An optional token map
  authenticates before ``submit(..., tenant=...)``; a per-tenant
  request-rate window (``TG_NET_TENANT_RPS``) sheds abusive tenants at
  the edge (401/429) before they cost a queue slot.
* **Model routing on the wire.** An optional model id (binary header
  ``model`` field / HTTP ``X-TG-Model``) selects which registered model
  scores the rows — forwarded as ``submit(..., model=...)`` when the
  target routes by model (a fleet front door under placement). An
  unknown id, or a model id against a target that cannot route, is a
  typed 404 ``unknown_model`` shed; a placement-refused model is a
  typed 429 ``placement`` shed.
* **Deterministic chaos.** Three counter-driven sites —
  ``net.accept``, ``net.read``, ``net.write`` — fault the connection at
  each lifecycle stage; each fires as a typed shed, records its
  recovery kind on the edge's FaultLog (``net_accept_refused`` /
  ``net_read_shed`` / ``net_write_shed``), and is replayed by the
  campaign ``net`` scenario under the same accounting oracles as the
  fleet scenario.

The listener runs on a dedicated ``tg-net[{name}]`` thread owning a
private asyncio loop; live edges register in a module registry so
``oracles.net_violations`` can prove no listening socket, edge thread,
or pending connection task survives a test. Correlation ids are minted
at *accept* (one per connection) so the flight recorder can replay a
request's socket story end to end.
"""
from __future__ import annotations

import asyncio
import json
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Deque, Dict, List, Optional, Tuple

from ..observability import blackbox as _blackbox
from ..observability import metrics as _obs_metrics
from ..observability import timeseries as _timeseries
from ..robustness import faults
from ..robustness.faults import InjectedFaultError, TransientFaultError
from ..robustness.policy import FaultLog, FaultReport
from . import netproto
from .fleet import AdmissionRefusedError
from .placement import PlacementRefusedError, UnknownModelError
from .runtime import (DeadlineExceededError, OverloadError,
                      RuntimeStoppedError, ServingError, _env_float,
                      _env_int)

__all__ = ["NetEdge", "NetEdgeConfig", "SHED_STATUS", "derive_retry_after",
           "live_edges"]

#: typed shed reason -> wire status code (the HTTP statuses double as the
#: ``status`` field of binary error frames; docs/serving.md status table)
SHED_STATUS: Dict[str, int] = {
    "bad_frame": 400,      # malformed JSON / frame / header
    "auth": 401,           # unknown or missing tenant token
    "bad_path": 404,       # method/path other than POST /score
    "unknown_model": 404,  # model id not in the target's registry
    "placement": 429,      # model refused by the placement budget
    "read_timeout": 408,   # slow-loris: body/frame stalled past deadline
    "oversize": 413,       # payload above TG_NET_MAX_FRAME_BYTES
    "quota": 429,          # per-tenant rate window exceeded at the edge
    "overload": 429,       # queue full at submit (OverloadError)
    "admission": 429,      # front-door pre-flight refusal
    "no_replica": 503,     # typed post-accept shed (failover exhausted)
    "stopped": 503,        # target not accepting (RuntimeStoppedError)
    "deadline": 504,       # request deadline exceeded inside the target
}

#: live edges, newest last — the no-leak oracle's probe surface
_LIVE: List["NetEdge"] = []
_LIVE_LOCK = threading.Lock()


def live_edges() -> List["NetEdge"]:
    """Every started-and-not-closed edge (oracles.net_violations)."""
    with _LIVE_LOCK:
        return list(_LIVE)


@dataclass(frozen=True)
class NetEdgeConfig:
    """Env-tunable edge knobs (table: docs/serving.md "TG_NET_* knobs")."""
    max_frame_bytes: int = 1 << 20   # TG_NET_MAX_FRAME_BYTES
    read_timeout_s: float = 5.0      # TG_NET_READ_TIMEOUT_S
    write_timeout_s: float = 5.0     # TG_NET_WRITE_TIMEOUT_S
    idle_timeout_s: float = 30.0     # TG_NET_IDLE_TIMEOUT_S
    max_connections: int = 256       # TG_NET_MAX_CONNS
    tenant_rps: float = 0.0          # TG_NET_TENANT_RPS (0 = unlimited)
    retry_window_s: float = 10.0     # TG_NET_RETRY_WINDOW_S
    retry_scale_s: float = 1.0       # TG_NET_RETRY_SCALE_S
    retry_min_s: float = 1.0         # TG_NET_RETRY_MIN_S
    retry_max_s: float = 30.0        # TG_NET_RETRY_MAX_S
    collect_timeout_s: float = 30.0  # TG_NET_COLLECT_TIMEOUT_S

    @classmethod
    def from_env(cls) -> "NetEdgeConfig":
        # _env_float returns its (non-None) default for unset/empty/bad
        # values and the parsed float otherwise — an explicit 0 in the
        # environment must stay 0 (tenant_rps=0 means unlimited), so no
        # truthiness fallbacks here
        return cls(
            max_frame_bytes=_env_int("TG_NET_MAX_FRAME_BYTES", 1 << 20),
            read_timeout_s=_env_float("TG_NET_READ_TIMEOUT_S", 5.0),
            write_timeout_s=_env_float("TG_NET_WRITE_TIMEOUT_S", 5.0),
            idle_timeout_s=_env_float("TG_NET_IDLE_TIMEOUT_S", 30.0),
            max_connections=_env_int("TG_NET_MAX_CONNS", 256),
            tenant_rps=_env_float("TG_NET_TENANT_RPS", 0.0),
            retry_window_s=_env_float("TG_NET_RETRY_WINDOW_S", 10.0),
            retry_scale_s=_env_float("TG_NET_RETRY_SCALE_S", 1.0),
            retry_min_s=_env_float("TG_NET_RETRY_MIN_S", 1.0),
            retry_max_s=_env_float("TG_NET_RETRY_MAX_S", 30.0),
            collect_timeout_s=_env_float("TG_NET_COLLECT_TIMEOUT_S", 30.0))


def derive_retry_after(shed_rate_per_s: float,
                       config: Optional[NetEdgeConfig] = None
                       ) -> Optional[float]:
    """Map a windowed shed rate to a ``Retry-After`` hint: ``None`` when
    the window is clean (no header), otherwise ``rate * retry_scale_s``
    clamped to ``[retry_min_s, retry_max_s]`` — monotone in the observed
    shed pressure, never absurd."""
    cfg = config or NetEdgeConfig()
    if shed_rate_per_s is None or shed_rate_per_s <= 0.0:
        return None
    return min(max(shed_rate_per_s * cfg.retry_scale_s, cfg.retry_min_s),
               cfg.retry_max_s)


class NetEdge:
    """One listener over one serving target. Use as a context manager::

        with NetEdge(runtime, port=0, name="edge") as edge:
            host, port = edge.address
            ...  # WireClient(host, port).request([row])

    ``close()`` stops the loop, cancels connection tasks (each resolves
    its in-flight work as a typed ``server_close`` shed), closes the
    listening socket, joins the ``tg-net`` thread and detaches the
    sampler — the no-leak oracle asserts all of it."""

    def __init__(self, target, host: str = "127.0.0.1", port: int = 0,
                 name: Optional[str] = None,
                 config: Optional[NetEdgeConfig] = None,
                 tokens: Optional[Dict[str, str]] = None,
                 fault_log: Optional[FaultLog] = None,
                 auto_start: bool = True):
        self.target = target
        self.host = host
        self._req_port = int(port)
        self.name = name or getattr(target, "name", "edge")
        self.config = config or NetEdgeConfig.from_env()
        #: token -> tenant; None = open edge (tenant from request header)
        self.tokens = dict(tokens) if tokens else None
        self.fault_log = fault_log if fault_log is not None \
            else getattr(target, "fault_log", None) or FaultLog()
        #: edge-local instruments (always on) + windowed sampler source
        self.metrics = _obs_metrics.MetricsRegistry()
        self.sampler: Optional[_timeseries.MetricsSampler] = None
        self.bound_port: Optional[int] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._thread: Optional[threading.Thread] = None
        self._ready = threading.Event()
        self._startup_error: Optional[BaseException] = None
        self._conn_tasks: "set" = set()
        self._active = 0
        self._closed = False
        #: does target.submit accept a ``model=`` kwarg? (resolved lazily)
        self._routes_models: Optional[bool] = None
        #: per-tenant arrival window (loop thread only — no lock)
        self._tenant_window: Dict[str, Deque[float]] = {}
        if auto_start:
            self.start()

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "NetEdge":
        if self._thread is not None:
            return self
        if self._closed:
            raise RuntimeStoppedError(f"net edge '{self.name}' is closed")
        self._ready.clear()
        self._thread = threading.Thread(
            target=self._run_loop, name=f"tg-net[{self.name}]", daemon=True)
        self._thread.start()
        if not self._ready.wait(timeout=10.0):
            raise RuntimeError(
                f"net edge '{self.name}' failed to start within 10s")
        if self._startup_error is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
            raise self._startup_error
        self.sampler = _timeseries.attach(self.metrics,
                                          name=f"net[{self.name}]")
        with _LIVE_LOCK:
            _LIVE.append(self)
        return self

    @property
    def address(self) -> Tuple[str, int]:
        """The bound ``(host, port)`` — port resolved when 0 was asked."""
        return self.host, int(self.bound_port or 0)

    def pending_tasks(self) -> int:
        """Live connection tasks (the oracle's asyncio-leak probe)."""
        return sum(1 for t in list(self._conn_tasks) if not t.done())

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        loop = self._loop
        if loop is not None and not loop.is_closed():
            try:
                loop.call_soon_threadsafe(lambda: None)
                loop.call_soon_threadsafe(loop.stop)
            except RuntimeError:
                pass  # loop already stopped
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        _timeseries.detach(self.sampler)
        self.sampler = None
        with _LIVE_LOCK:
            if self in _LIVE:
                _LIVE.remove(self)

    def __enter__(self) -> "NetEdge":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- event-loop thread ---------------------------------------------------
    def _run_loop(self) -> None:
        loop = asyncio.new_event_loop()
        self._loop = loop
        asyncio.set_event_loop(loop)
        try:
            self._server = loop.run_until_complete(asyncio.start_server(
                self._handle_conn, self.host, self._req_port,
                limit=max(65536, self.config.max_frame_bytes)))
            self.bound_port = self._server.sockets[0].getsockname()[1]
        except BaseException as e:
            self._startup_error = e
            self._ready.set()
            loop.close()
            return
        self._ready.set()
        try:
            loop.run_forever()
        finally:
            try:
                loop.run_until_complete(self._shutdown())
            finally:
                asyncio.set_event_loop(None)
                loop.close()

    async def _shutdown(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        tasks = [t for t in list(self._conn_tasks) if not t.done()]
        for t in tasks:
            t.cancel()
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)
        self._conn_tasks.clear()

    # -- instruments ---------------------------------------------------------
    def _count(self, name: str, n: float = 1.0, help: str = "",
               **labels: str) -> None:
        labels.setdefault("edge", self.name)
        self.metrics.counter(name, help, **labels).inc(n)
        _obs_metrics.inc_counter(name, n, help, **labels)

    def _gauge(self, name: str, v: float, help: str = "") -> None:
        self.metrics.gauge(name, help, edge=self.name).set(v)
        _obs_metrics.set_gauge(name, v, help, edge=self.name)

    def _shed(self, reason: str, corr: Optional[str],
              proto: str = "none", tenant: Optional[str] = None) -> None:
        """One typed edge shed: counted on ``tg_net_shed_total{reason}``
        (+ the per-tenant twin) and stamped on the flight recorder."""
        self._count("tg_net_shed_total", reason=reason, proto=proto,
                    help="requests/connections shed at the network edge "
                    "(docs/serving.md 'Network edge')")
        if tenant is not None:
            self._count("tg_net_tenant_shed_total", tenant=tenant,
                        reason=reason,
                        help="per-tenant edge sheds (docs/serving.md)")
        if _blackbox.blackbox_enabled():
            _blackbox.record("net.shed", corr=corr, edge=self.name,
                             reason=reason, proto=proto)

    def _record_fault(self, site: str, kind: str,
                      exc: BaseException) -> None:
        self.fault_log.add(FaultReport(
            site=site, kind=kind,
            detail={"edge": self.name,
                    "error": f"{type(exc).__name__}: {exc}"}))

    # -- Retry-After ---------------------------------------------------------
    def retry_after_s(self) -> Optional[float]:
        """The windowed shed pressure, as a clamped hint (None when both
        the target's serve window and the edge's own window are clean,
        or when sampling is off — the header is then absent)."""
        cfg = self.config
        rate = 0.0
        saw = False
        target_sampler = getattr(self.target, "sampler", None)
        if target_sampler is not None:
            rate += max(0.0, target_sampler.rate(
                "tg_serve_shed_total", cfg.retry_window_s))
            saw = True
        if self.sampler is not None:
            rate += max(0.0, self.sampler.rate(
                "tg_net_shed_total", cfg.retry_window_s))
            saw = True
        if not saw:
            return None
        return derive_retry_after(rate, cfg)

    # -- connection handling -------------------------------------------------
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        if task is not None:
            self._conn_tasks.add(task)
            task.add_done_callback(self._conn_tasks.discard)
        self._active += 1
        self._gauge("tg_net_active_connections", float(self._active),
                    help="currently open edge connections")
        self._count("tg_net_connections_total",
                    help="connections accepted by the edge")
        # one correlation id per connection, minted at accept — every
        # request/shed event on this socket links to it
        boxed = _blackbox.blackbox_enabled()
        corr = _blackbox.new_correlation_id("net") if boxed else None
        try:
            if self._active > self.config.max_connections:
                self._shed("conn_limit", corr)
                return
            try:
                # chaos: the accept path dying (listener thread fault,
                # fd exhaustion) — connection drops as a typed shed
                faults.inject("net.accept", key=self.name)
            except (TransientFaultError, InjectedFaultError) as e:
                self._shed("accept_fault", corr)
                self._record_fault("net.accept", "net_accept_refused", e)
                return
            if boxed:
                peer = writer.get_extra_info("peername")
                _blackbox.record("net.accept", corr=corr, edge=self.name,
                                 peer=str(peer))
            await self._serve_connection(reader, writer, corr)
        except asyncio.CancelledError:
            # server shutdown with the connection mid-flight: typed shed
            # (submitted futures keep resolving inside the target)
            self._shed("server_close", corr)
        except (ConnectionError, OSError):
            self._shed("disconnect", corr)
        finally:
            self._active -= 1
            self._gauge("tg_net_active_connections", float(self._active))
            try:
                writer.close()
                # wait for the transport to actually tear down so the
                # fd is released before the connection task completes
                # (pending_tasks()/the no-leak oracle track task exits)
                await writer.wait_closed()
            except Exception:
                pass

    async def _serve_connection(self, reader, writer,
                                corr: Optional[str]) -> None:
        cfg = self.config
        first_request = True
        while True:
            # first bytes of the next request; between keep-alive
            # requests an idle timeout is a clean close, not a shed
            try:
                head = await asyncio.wait_for(
                    reader.readexactly(4),
                    cfg.idle_timeout_s if not first_request
                    else cfg.read_timeout_s)
            except asyncio.IncompleteReadError as e:
                if e.partial:
                    self._shed("bad_frame", corr)
                return  # clean EOF between requests
            except asyncio.TimeoutError:
                if first_request:
                    self._shed("read_timeout", corr)
                else:
                    self._count("tg_net_idle_closed_total",
                                help="keep-alive connections closed idle")
                return
            first_request = False
            if head == netproto.MAGIC:
                alive = await self._serve_binary(reader, writer, corr)
            else:
                alive = await self._serve_http(head, reader, writer, corr)
            if not alive:
                return

    # -- binary framing ------------------------------------------------------
    async def _serve_binary(self, reader, writer,
                            corr: Optional[str]) -> bool:
        cfg = self.config
        t0 = time.monotonic()
        try:
            # chaos: the read path dying mid-frame — the client observes
            # a mid-request disconnect; the edge accounts a typed shed
            faults.inject("net.read", key=self.name)
        except (TransientFaultError, InjectedFaultError) as e:
            self._shed("read_fault", corr, proto="binary")
            self._record_fault("net.read", "net_read_shed", e)
            return False
        try:
            rest = await asyncio.wait_for(reader.readexactly(5),
                                          cfg.read_timeout_s)
        except (asyncio.IncompleteReadError, asyncio.TimeoutError):
            self._shed("read_timeout", corr, proto="binary")
            return False
        kind, length = rest[0], int.from_bytes(rest[1:5], "big")
        if kind != netproto.KIND_REQUEST:
            await self._respond_binary(writer, corr, 400, error="bad_frame",
                                       message=f"unexpected kind {kind}")
            self._shed("bad_frame", corr, proto="binary")
            return False
        if length > cfg.max_frame_bytes:
            await self._respond_binary(
                writer, corr, 413, error="oversize",
                message=f"frame of {length} bytes exceeds "
                f"TG_NET_MAX_FRAME_BYTES={cfg.max_frame_bytes}")
            self._shed("oversize", corr, proto="binary")
            return False  # cannot skip an unread payload: close
        try:
            payload = await asyncio.wait_for(reader.readexactly(length),
                                             cfg.read_timeout_s)
        except (asyncio.IncompleteReadError, asyncio.TimeoutError):
            self._shed("read_timeout", corr, proto="binary")
            return False
        self._count("tg_net_bytes_read_total", 9.0 + length,
                    help="request bytes read off the wire")
        try:
            header, rows = netproto.decode_binary_request(payload)
        except netproto.FrameError as e:
            # payload fully consumed — the connection survives
            await self._respond_binary(writer, corr, 400,
                                       error="bad_frame", message=str(e))
            self._shed("bad_frame", corr, proto="binary")
            return True
        status, body = await self._score(
            rows, header.get("token"), header.get("tenant"),
            header.get("deadlineMs"), corr, "binary",
            model=header.get("model"))
        ok = await self._respond_binary(writer, corr, status, **body)
        self._observe_request("binary", status, len(rows),
                              time.monotonic() - t0, corr)
        return ok

    async def _respond_binary(self, writer, corr: Optional[str],
                              status: int, **body: Any) -> bool:
        if status == 200:
            frame = netproto.encode_binary_response(200, body)
        else:
            obj = {"status": status}
            obj.update({k: v for k, v in body.items() if v is not None})
            retry = self.retry_after_s() if status in (429, 503) else None
            if retry is not None:
                obj["retryAfterS"] = round(retry, 3)
            frame = netproto.encode_binary_response(status, obj)
        return await self._write(writer, frame, corr, proto="binary")

    # -- HTTP framing --------------------------------------------------------
    async def _serve_http(self, head: bytes, reader, writer,
                          corr: Optional[str]) -> bool:
        cfg = self.config
        t0 = time.monotonic()
        try:
            faults.inject("net.read", key=self.name)
        except (TransientFaultError, InjectedFaultError) as e:
            self._shed("read_fault", corr, proto="http")
            self._record_fault("net.read", "net_read_shed", e)
            return False
        try:
            line = head + await asyncio.wait_for(reader.readline(),
                                                 cfg.read_timeout_s)
            headers: Dict[str, str] = {}
            hdr_bytes = len(line)
            while True:
                raw = await asyncio.wait_for(reader.readline(),
                                             cfg.read_timeout_s)
                hdr_bytes += len(raw)
                if hdr_bytes > cfg.max_frame_bytes:
                    await self._respond_http(
                        writer, corr, 413, {"error": "oversize"},
                        close=True)
                    self._shed("oversize", corr, proto="http")
                    return False
                stripped = raw.rstrip(b"\r\n")
                if not raw or not stripped:
                    break
                if b":" in stripped:
                    k, v = stripped.split(b":", 1)
                    headers[k.decode("latin-1").strip().lower()] = \
                        v.decode("latin-1").strip()
        except asyncio.TimeoutError:
            # slow-loris: the request line / headers stalled — typed shed
            # with a best-effort 408 before the close
            self._shed("read_timeout", corr, proto="http")
            await self._respond_http(writer, corr, 408,
                                     {"error": "read_timeout"}, close=True,
                                     best_effort=True)
            return False
        except (asyncio.LimitOverrunError, ValueError):
            # one header line above the stream limit: readline raises
            # before the hdr_bytes check can fire — same typed oversize
            # shed as the counted path, connection closes
            await self._respond_http(writer, corr, 413,
                                     {"error": "oversize",
                                      "message": "header line exceeds "
                                      "the stream limit"},
                                     close=True, best_effort=True)
            self._shed("oversize", corr, proto="http")
            return False
        parts = line.rstrip(b"\r\n").split()
        if len(parts) < 3:
            self._shed("bad_frame", corr, proto="http")
            await self._respond_http(writer, corr, 400,
                                     {"error": "bad_frame",
                                      "message": "malformed request line"},
                                     close=True, best_effort=True)
            return False
        method, path = parts[0].decode("latin-1"), parts[1].decode("latin-1")
        try:
            length = int(headers.get("content-length", "0") or 0)
        except ValueError:
            length = -1
        if length < 0:
            await self._respond_http(writer, corr, 400,
                                     {"error": "bad_frame",
                                      "message": "bad Content-Length"},
                                     close=True)
            self._shed("bad_frame", corr, proto="http")
            return False
        if length > cfg.max_frame_bytes:
            await self._respond_http(
                writer, corr, 413,
                {"error": "oversize",
                 "message": f"body of {length} bytes exceeds "
                 f"TG_NET_MAX_FRAME_BYTES={cfg.max_frame_bytes}"},
                close=True)
            self._shed("oversize", corr, proto="http")
            return False  # refuse to drain an oversized body
        try:
            body = await asyncio.wait_for(reader.readexactly(length),
                                          cfg.read_timeout_s) \
                if length else b""
        except (asyncio.IncompleteReadError, asyncio.TimeoutError):
            self._shed("read_timeout", corr, proto="http")
            return False
        self._count("tg_net_bytes_read_total", float(hdr_bytes + length))
        keep = headers.get("connection", "keep-alive").lower() != "close"
        if method.upper() != "POST" or path not in ("/score", "/v1/score"):
            self._shed("bad_path", corr, proto="http")
            return await self._respond_http(
                writer, corr, 404,
                {"error": "bad_path",
                 "message": f"{method} {path} (want POST /score)"},
                close=not keep)
        try:
            obj = json.loads(body.decode("utf-8")) if body else {}
            rows = obj if isinstance(obj, list) else obj.get("rows")
            if not isinstance(rows, list) or not all(
                    isinstance(r, dict) for r in rows):
                raise ValueError("body must be {'rows': [{...}, ...]}")
        except (ValueError, UnicodeDecodeError) as e:
            # body fully drained — keep-alive survives a malformed request
            self._shed("bad_frame", corr, proto="http")
            return await self._respond_http(
                writer, corr, 400,
                {"error": "bad_frame", "message": str(e)}, close=not keep)
        dl = headers.get("x-tg-deadline-ms")
        try:
            deadline_ms = float(dl) if dl else None
        except ValueError:
            deadline_ms = None
        status, out = await self._score(
            rows, headers.get("x-tg-token"), headers.get("x-tg-tenant"),
            deadline_ms, corr, "http", model=headers.get("x-tg-model"))
        ok = await self._respond_http(writer, corr, status, out,
                                      close=not keep)
        self._observe_request("http", status, len(rows),
                              time.monotonic() - t0, corr)
        return ok and keep

    _REASONS = {400: "Bad Request", 401: "Unauthorized", 404: "Not Found",
                408: "Request Timeout", 413: "Payload Too Large",
                429: "Too Many Requests", 500: "Internal Server Error",
                503: "Service Unavailable", 504: "Gateway Timeout"}

    async def _respond_http(self, writer, corr: Optional[str], status: int,
                            obj: Dict[str, Any], close: bool = False,
                            best_effort: bool = False) -> bool:
        obj = {k: v for k, v in obj.items() if v is not None}
        payload = json.dumps(obj, separators=(",", ":")).encode("utf-8")
        lines = [f"HTTP/1.1 {status} {self._REASONS.get(status, 'OK')}",
                 "Content-Type: application/json",
                 f"Content-Length: {len(payload)}",
                 f"Connection: {'close' if close else 'keep-alive'}"]
        if status in (429, 503):
            retry = self.retry_after_s()
            if retry is not None:
                lines.append(f"Retry-After: {retry:g}")
        data = ("\r\n".join(lines) + "\r\n\r\n").encode("ascii") + payload
        ok = await self._write(writer, data, corr, proto="http",
                               best_effort=best_effort)
        return ok and not close

    # -- shared scoring core -------------------------------------------------
    def _check_quota(self, tenant: str) -> bool:
        """Sliding 1s window per tenant; True = admit."""
        rps = self.config.tenant_rps
        if rps <= 0:
            return True
        now = time.monotonic()
        win = self._tenant_window.setdefault(tenant, deque())
        while win and now - win[0] > 1.0:
            win.popleft()
        if len(win) >= rps:
            return False
        win.append(now)
        return True

    def _target_routes_models(self) -> bool:
        """Whether ``target.submit`` accepts a ``model=`` kwarg (a fleet
        front door does; a bare runtime does not) — resolved once."""
        if self._routes_models is None:
            import inspect
            try:
                self._routes_models = "model" in inspect.signature(
                    self.target.submit).parameters
            except (TypeError, ValueError):  # builtins / C callables
                self._routes_models = False
        return self._routes_models

    async def _score(self, rows: List[Dict[str, Any]],
                     token: Optional[str], tenant: Optional[str],
                     deadline_ms: Optional[float], corr: Optional[str],
                     proto: str, model: Optional[Any] = None
                     ) -> Tuple[int, Dict[str, Any]]:
        """Auth -> quota -> submit -> collect. Returns (status, body).
        Futures submitted before a shed are ALWAYS awaited — the edge
        never abandons a future, whatever the socket does next."""
        if model is not None:
            model = str(model)  # untrusted header field
            if not self._target_routes_models():
                self._shed("unknown_model", corr, proto=proto,
                           tenant=tenant)
                return 404, {"error": "unknown_model",
                             "message": f"model '{model}' requested but "
                             "the target does not route by model"}
        if self.tokens is not None:
            mapped = self.tokens.get(token or "")
            if mapped is None:
                self._shed("auth", corr, proto=proto, tenant=tenant)
                return 401, {"error": "auth",
                             "message": "unknown or missing X-TG-Token"}
            tenant = mapped
        if tenant is not None and not self._check_quota(tenant):
            self._shed("quota", corr, proto=proto, tenant=tenant)
            return 429, {"error": "quota",
                         "message": f"tenant '{tenant}' above "
                         f"TG_NET_TENANT_RPS={self.config.tenant_rps:g}"}
        kwargs: Dict[str, Any] = {"deadline_ms": deadline_ms,
                                  "tenant": tenant}
        if model is not None:
            kwargs["model"] = model
        futs: List[Any] = []
        shed: Optional[Tuple[str, int]] = None
        for row in rows:
            try:
                futs.append(self.target.submit(row, **kwargs))
            except UnknownModelError:
                shed = ("unknown_model", SHED_STATUS["unknown_model"])
                break
            except AdmissionRefusedError:
                shed = ("admission", SHED_STATUS["admission"])
                break
            except PlacementRefusedError:
                shed = ("placement", SHED_STATUS["placement"])
                break
            except OverloadError:
                shed = ("overload", SHED_STATUS["overload"])
                break
            except RuntimeStoppedError:
                shed = ("stopped", SHED_STATUS["stopped"])
                break
            except ServingError:
                shed = ("stopped", SHED_STATUS["stopped"])
                break
        results: List[Optional[Dict[str, Any]]] = []
        row_shed: Optional[Tuple[str, int]] = None
        lost = 0
        budget = self.config.collect_timeout_s
        t_end = time.monotonic() + budget
        for f in futs:
            try:
                rec = await asyncio.wait_for(
                    asyncio.wrap_future(f),
                    max(0.05, t_end - time.monotonic()))
                results.append(rec)
            except DeadlineExceededError:
                results.append({"error": "deadline"})
                row_shed = row_shed or ("deadline", SHED_STATUS["deadline"])
            except OverloadError:
                results.append({"error": "no_replica"})
                row_shed = row_shed or ("no_replica",
                                        SHED_STATUS["no_replica"])
            except ServingError as e:
                results.append({"error": type(e).__name__})
                row_shed = row_shed or ("stopped", SHED_STATUS["stopped"])
            except asyncio.TimeoutError:
                # a future that outlives the collect budget is the one
                # outcome the stack must never produce — surface loudly
                results.append({"error": "lost"})
                lost += 1
        if lost:
            self._count("tg_net_lost_total", float(lost),
                        help="futures unresolved inside the collect "
                        "budget — MUST stay zero (docs/serving.md)")
            return 500, {"error": "lost",
                         "message": f"{lost} future(s) unresolved after "
                         f"{budget:g}s collect budget"}
        if shed is not None:
            reason, status = shed
            self._shed(reason, corr, proto=proto, tenant=tenant)
            return status, {"error": reason,
                            "completed": sum(1 for r in results
                                             if r and "error" not in r),
                            "results": results or None}
        if row_shed is not None:
            reason, status = row_shed
            self._shed(reason, corr, proto=proto, tenant=tenant)
            completed = sum(1 for r in results if r and "error" not in r)
            if completed:
                # partial batch: completed rows ship with per-row errors
                return 200, {"results": results, "shed": reason}
            return status, {"error": reason, "results": results}
        self._count("tg_net_rows_total", float(len(rows)), proto=proto,
                    help="rows scored through the edge")
        return 200, {"results": results}

    # -- write path ----------------------------------------------------------
    async def _write(self, writer, data: bytes, corr: Optional[str],
                     proto: str, best_effort: bool = False) -> bool:
        try:
            # chaos: the write path dying mid-response — by now every
            # submitted future has resolved; the client sees a
            # disconnect, the edge accounts a typed shed
            faults.inject("net.write", key=self.name)
        except (TransientFaultError, InjectedFaultError) as e:
            if not best_effort:
                self._shed("write_fault", corr, proto=proto)
            self._record_fault("net.write", "net_write_shed", e)
            return False
        try:
            writer.write(data)
            await asyncio.wait_for(writer.drain(),
                                   self.config.write_timeout_s)
        except (asyncio.TimeoutError, ConnectionError, OSError):
            if not best_effort:
                self._shed("disconnect", corr, proto=proto)
            return False
        self._count("tg_net_bytes_written_total", float(len(data)),
                    help="response bytes written to the wire")
        return True

    def _observe_request(self, proto: str, status: int, rows: int,
                         seconds: float, corr: Optional[str]) -> None:
        self._count("tg_net_requests_total", proto=proto,
                    status=str(status),
                    help="requests terminated at the edge, by protocol "
                    "and status")
        self.metrics.histogram(
            "tg_net_request_seconds",
            "edge request wall time, accept->response-written",
            proto=proto, edge=self.name).observe(seconds, exemplar=corr)
        _obs_metrics.observe("tg_net_request_seconds", seconds,
                             proto=proto, edge=self.name)
        if _blackbox.blackbox_enabled():
            _blackbox.record("net.request", corr=corr, edge=self.name,
                             proto=proto, status=status, rows=rows,
                             ms=round(seconds * 1e3, 3))
