"""The PyTorch port's network edge and wire protocol against the JAX package
(``transmogrifai_tpu_torch/serving/{netedge,netproto}.py`` and the wire
load generator; the cases of ``tests/test_netedge.py`` on the port's CPU
path).

The wire is the contract between the two packages: a ``TGB1`` frame or an
HTTP request encoded by either package is byte-equal to the other's and
decodes in it to the same rows; the JAX package's ``WireClient`` gets the
same records from the port's edge as the port's client; the port's client
gets the JAX package's records (within ``PROB_ATOL``, 1e-5: the packages'
RF sums differ in the last bit, ROADMAP Queue 3) from the JAX package's
edge; every shed reason answers the JAX package's status, error field and
``Retry-After`` rule. Scoring runs on the committed JAX-saved
``serve64/rf`` (64 predictors), bit-equal to the port's micro-batch
scorer. Nothing depends on the host's speed: timeouts are waited out on a
counter with a generous deadline, the tenant quota reads a frozen clock,
faults fire by count.
"""
from __future__ import annotations

import json
import os
import shutil
import socket
import struct
import sys
import time
import types
from concurrent.futures import Future

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import jax  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import transmogrifai_tpu.models.trees  # noqa: E402,F401  (registers families)
import transmogrifai_tpu_torch as port  # noqa: E402
from transmogrifai_tpu_torch.local.scoring import (  # noqa: E402
    micro_batch_score_function,
)
from transmogrifai_tpu_torch.robustness import faults, oracles  # noqa: E402
from transmogrifai_tpu_torch.serving import (  # noqa: E402
    NetEdge, NetEdgeConfig, ServeConfig, ServingRuntime, derive_retry_after,
    live_edges,
)
from transmogrifai_tpu_torch.serving import netedge as netedge_mod  # noqa: E402
from transmogrifai_tpu_torch.serving import netproto  # noqa: E402
from transmogrifai_tpu_torch.serving.loadgen import (  # noqa: E402
    run_wire_open_loop,
)
from transmogrifai_tpu_torch.serving.netproto import (  # noqa: E402
    FrameError, WireClient, WireDisconnect,
)
from transmogrifai_tpu_torch.testing import (  # noqa: E402
    close_serving_state, request_rows, score_frame,
)

import transmogrifai_tpu.serving as jserving  # noqa: E402
from transmogrifai_tpu.serving import netedge as jnetedge  # noqa: E402
from transmogrifai_tpu.serving import netproto as jnetproto  # noqa: E402

pytestmark = pytest.mark.net

SERVE64 = os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures",
                       "serve64")
PROB_ATOL = 1e-5
#: the FaultLog kind each net.* site records (the JAX campaign's
#: ACCOUNT_KINDS for these sites)
NET_KINDS = {"net.accept": "net_accept_refused", "net.read": "net_read_shed",
             "net.write": "net_write_shed"}


@pytest.fixture(autouse=True)
def _clean_serving(tmp_path, monkeypatch):
    monkeypatch.setenv("TG_POSTMORTEM_DIR", str(tmp_path / "postmortems"))
    yield
    leaks = close_serving_state()
    assert not leaks, f"the test leaked serving state: {leaks}"


@pytest.fixture(scope="module")
def rf_path(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("net_rf") / "rf")
    shutil.copytree(os.path.join(SERVE64, "rf"), d)
    return d


@pytest.fixture(scope="module")
def model(rf_path):
    return port.load_model(rf_path, device="cpu")


def _rows(n=8, seed=57):
    return request_rows(score_frame(n, 64, seed))


def _cfg(**kw):
    base = dict(max_batch=32, max_queue=128, max_wait_ms=5.0)
    base.update(kw)
    return ServeConfig(**base)


def _counter(edge, name, **labels):
    total = 0.0
    for key, value in edge.metrics.snapshot().get(name, {}).items():
        lbls = dict(p.split("=", 1) for p in key.split(",") if "=" in p)
        if all(lbls.get(k) == v for k, v in labels.items()):
            total += value
    return total


def _wait_counter(edge, name, target, timeout=30.0, **labels):
    """Wait for an edge counter to reach ``target`` (a shed is counted
    after its response is written, so a fast client can read first)."""
    deadline = time.monotonic() + timeout
    while _counter(edge, name, **labels) < target \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    return _counter(edge, name, **labels)


# -- the frame format: the contract between the packages ---------------------

ODD_ROWS = [{"f": 1.5, "i": 2, "b": True, "s": "αβ", "n": None},
            {"f": -0.25, "i": -7, "b": False, "s": "", "n": 3.0},
            {"f": None, "i": 0, "b": None, "s": "x", "n": None},
            {"f": float("inf"), "i": 2 ** 40, "extra": "late key"}]


@pytest.mark.parametrize("kw", [
    {}, {"tenant": "t1", "token": "tok", "deadline_ms": 125.0},
    {"model": "b", "tenant": "acme"}])
def test_frames_are_byte_equal_and_decode_across_the_packages(kw):
    rows = ODD_ROWS + _rows(3)
    ours = bytes(netproto.encode_binary_request(rows, **kw))
    theirs = bytes(jnetproto.encode_binary_request(rows, **kw))
    assert ours == theirs
    assert bytes(netproto.encode_binary_request(
        rows, scratch=bytearray(b"stale"), **kw)) == ours
    payload = ours[netproto.FRAME_HEADER.size:]
    h1, r1 = netproto.decode_binary_request(payload)
    h2, r2 = jnetproto.decode_binary_request(payload)
    assert h1 == h2 and r1 == r2
    for got, sent in zip(r1, rows):
        assert {k: v for k, v in got.items() if k in sent} == sent
    for obj in ({"results": [{"p": 0.25}]}, {"status": 429,
                                              "error": "overload"}):
        status = obj.get("status", 200)
        assert netproto.encode_binary_response(status, obj) == \
            jnetproto.encode_binary_response(status, obj)
    assert netproto.encode_http_request(rows, **kw) == \
        jnetproto.encode_http_request(rows, **kw)
    assert netproto.columns_from_rows(rows) == jnetproto.columns_from_rows(
        rows)


def test_binary_roundtrip_preserves_rows_and_types():
    frame = netproto.encode_binary_request(
        ODD_ROWS[:3], tenant="t1", token="tok", deadline_ms=125.0)
    header, out = netproto.decode_binary_request(
        frame[netproto.FRAME_HEADER.size:])
    assert header["tenant"] == "t1" and header["token"] == "tok"
    assert header["deadlineMs"] == 125.0
    assert out == [dict(r) for r in ODD_ROWS[:3]]


def test_binary_decode_rejects_garbage_and_bounds_rows(monkeypatch):
    with pytest.raises(FrameError):
        netproto.decode_binary_request(b"\x00\x01garbage")
    good = netproto.encode_binary_request(
        [{"x": float(i)} for i in range(4)])[netproto.FRAME_HEADER.size:]
    for bad in (good + b"trailing", good[:-3]):
        with pytest.raises(FrameError):
            netproto.decode_binary_request(bad)

    def _payload(n, columns=()):
        hdr = json.dumps({"rows": n, "columns": list(columns)},
                         separators=(",", ":")).encode()
        return struct.pack(">H", len(hdr)) + hdr
    with pytest.raises(FrameError, match="TG_NET_MAX_ROWS"):
        netproto.decode_binary_request(_payload(10 ** 12))
    with pytest.raises(FrameError, match="no column blocks"):
        netproto.decode_binary_request(_payload(3))
    assert netproto.decode_binary_request(_payload(0))[1] == []
    with pytest.raises(FrameError):
        netproto.decode_binary_request(good, max_rows=2)
    assert len(netproto.decode_binary_request(good, max_rows=4)[1]) == 4
    monkeypatch.setenv("TG_NET_MAX_ROWS", "2")
    with pytest.raises(FrameError):
        netproto.decode_binary_request(good)


# -- statuses and Retry-After: the JAX package's ------------------------------

def test_shed_statuses_and_retry_after_rules_equal_the_jax_packages(
        monkeypatch):
    assert netedge_mod.SHED_STATUS == jnetedge.SHED_STATUS
    assert NetEdgeConfig() == NetEdgeConfig(**vars(jnetedge.NetEdgeConfig()))
    assert NetEdge._REASONS == jnetedge.NetEdge._REASONS
    for cfg in ({}, {"retry_scale_s": 2.0}, {"retry_min_s": 0.5,
                                              "retry_max_s": 4.0}):
        for rate in (None, -1.0, 0.0, 0.01, 0.4, 1.0, 5.0, 31.0, 1e9):
            assert derive_retry_after(rate, NetEdgeConfig(**cfg)) == \
                jnetedge.derive_retry_after(
                    rate, jnetedge.NetEdgeConfig(**cfg))
    cfg = NetEdgeConfig(retry_scale_s=2.0)
    assert derive_retry_after(0.01, cfg) == 1.0
    assert derive_retry_after(5.0, cfg) == 10.0
    assert derive_retry_after(1e9, cfg) == 30.0
    monkeypatch.setenv("TG_NET_TENANT_RPS", "0")
    monkeypatch.setenv("TG_NET_RETRY_MIN_S", "0")
    monkeypatch.setenv("TG_NET_RETRY_SCALE_S", "0.5")
    ours = NetEdgeConfig.from_env()
    assert ours.tenant_rps == 0.0 and ours.retry_min_s == 0.0
    assert ours.retry_scale_s == 0.5 and ours.read_timeout_s == 5.0
    assert vars(ours) == vars(jnetedge.NetEdgeConfig.from_env())


class _Stub:
    """A target that answers every row one way: raise ``exc`` at submit,
    or accept and fail the future with ``late`` (or resolve ``record``)."""

    def __init__(self, exc=None, late=None, routes=False):
        self.exc, self.late, self.routes = exc, late, routes
        if routes:
            self.submit = self._submit_model

    def submit(self, row, deadline_ms=None, tenant=None):
        return self._answer()

    def _submit_model(self, row, deadline_ms=None, tenant=None, model=None):
        return self._answer()

    def _answer(self):
        if self.exc is not None:
            raise self.exc("staged")
        f = Future()
        if self.late is not None:
            f.set_exception(self.late("staged"))
        else:
            f.set_result({"p": 0.5})
        return f


def _stub(pkg, reason):
    """The stub answering ``reason`` with ``pkg``'s own typed errors."""
    s = port.serving if pkg == "port" else jserving
    return {
        "overload": lambda: _Stub(exc=s.OverloadError),
        "admission": lambda: _Stub(exc=s.AdmissionRefusedError),
        "placement": lambda: _Stub(exc=s.PlacementRefusedError,
                                   routes=True),
        "unknown_model": lambda: _Stub(exc=s.UnknownModelError,
                                       routes=True),
        "stopped": lambda: _Stub(exc=s.RuntimeStoppedError),
        "no_replica": lambda: _Stub(late=s.OverloadError),
        "deadline": lambda: _Stub(late=s.DeadlineExceededError),
        "model_on_a_runtime": lambda: _Stub(),
        "auth": lambda: _Stub(),
        "ok": lambda: _Stub(),
    }[reason]()


def _edge_answers(pkg, reason):
    """[(status, error field)] of ``pkg``'s edge for ``reason``, over both
    framings (whether ``Retry-After`` rides along depends on when the
    sampler last ticked; its rule is held above)."""
    edge_cls = NetEdge if pkg == "port" else jserving.NetEdge
    client = WireClient if pkg == "port" else jnetproto.WireClient
    kw = {"tokens": {"good": "acme"}} if reason == "auth" else {}
    model = "m" if reason in ("placement", "unknown_model",
                              "model_on_a_runtime") else None
    out = []
    with edge_cls(_stub(pkg, reason), name=f"{pkg}-{reason}", **kw) as edge:
        for proto in ("http", "binary"):
            with client(*edge.address, protocol=proto, model=model,
                        token="bad" if reason == "auth" else None) as cli:
                res = cli.request([{"x": 1.0}, {"x": 2.0}])
                out.append((res.status, res.error))
    return out


@pytest.mark.parametrize("reason", [
    "ok", "overload", "admission", "placement", "unknown_model", "stopped",
    "no_replica", "deadline", "model_on_a_runtime", "auth"])
def test_every_shed_answers_the_jax_packages_status(reason):
    ours = _edge_answers("port", reason)
    assert ours == _edge_answers("jax", reason)
    fixed = {"ok": 200, "auth": 401, "model_on_a_runtime": 404}
    want = (fixed[reason] if reason in fixed
            else netedge_mod.SHED_STATUS[reason])
    assert {s for s, _ in ours} == {want}


# -- scoring over the wire, across the packages -------------------------------

def test_both_protocols_score_bit_equal_to_in_process(model):
    rows = _rows(12)
    base = micro_batch_score_function(model)(rows)
    with ServingRuntime(model, "wire-eq", _cfg()) as rt:
        with NetEdge(rt, name="eq-edge") as edge:
            for proto in ("http", "binary"):
                for cls in (WireClient, jnetproto.WireClient):
                    with cls(*edge.address, protocol=proto) as cli:
                        res = cli.request(rows)
                        assert res.status == 200 and res.protocol == proto
                        assert res.records == base, (proto, cls)


def test_the_ports_client_against_the_jax_packages_edge(model, rf_path,
                                                       tmp_path):
    from transmogrifai_tpu.persistence import load_model as jax_load
    rows = _rows(12)
    base = micro_batch_score_function(model)(rows)
    name = model.result_features[0].name
    path = str(tmp_path / "rf")
    shutil.copytree(rf_path, path)
    with jserving.ServingRuntime(jax_load(path), "jax-rf",
                                 jserving.ServeConfig(max_wait_ms=5.0)) as rt:
        with jserving.NetEdge(rt, name="jax-edge") as edge:
            for proto in ("http", "binary"):
                with WireClient(*edge.address, protocol=proto) as cli:
                    res = cli.request(rows)
                assert res.status == 200 and res.protocol == proto
                got = np.asarray([r[name]["probability_1"]
                                  for r in res.records])
                want = np.asarray([r[name]["probability_1"] for r in base])
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=PROB_ATOL)
                assert [r[name]["prediction"] for r in res.records] == \
                    [r[name]["prediction"] for r in base]


def test_keep_alive_connection_reused_across_requests(model):
    with ServingRuntime(model, "ka", _cfg()) as rt:
        with NetEdge(rt, name="ka-edge") as edge:
            with WireClient(*edge.address) as cli:
                for _ in range(3):
                    assert cli.request(_rows(2)).status == 200
                assert cli.connected
            assert _counter(edge, "tg_net_connections_total") == 1.0


def test_retry_after_tracks_windowed_shed_rate(model):
    with ServingRuntime(model, "ra", _cfg()) as rt:
        with NetEdge(rt, name="ra-edge") as edge:
            assert edge.retry_after_s() is None
            s = edge.sampler
            t0 = time.monotonic() + 120.0
            s.tick(now=t0)
            edge.metrics.counter("tg_net_shed_total", "", reason="overload",
                                 proto="http", edge=edge.name).inc(40)
            s.tick(now=t0 + 10.0)
            hint = derive_retry_after(
                s.rate("tg_net_shed_total", edge.config.retry_window_s,
                       now=t0 + 10.0), edge.config)
            assert hint is not None and abs(hint - 4.0) < 0.5


def test_wire_429_carries_retry_after_and_clean_200_does_not(model):
    with ServingRuntime(model, "bp", _cfg(max_queue=1,
                                          max_wait_ms=300.0)) as rt:
        with NetEdge(rt, name="bp-edge") as edge:
            with WireClient(*edge.address, protocol="binary") as cli:

                def _next_429():
                    for _ in range(200):
                        res = cli.request(_rows(4))
                        if res.status == 429:
                            return res
                    raise AssertionError("a queue of 1 never overloaded")
                _next_429()
                # the shed lands in the edge's window; a forced tick makes
                # the next refusal carry the clamped windowed hint
                edge.sampler.tick()
                res = _next_429()
                assert res.retry_after_s is not None
                assert (edge.config.retry_min_s <= res.retry_after_s
                        <= edge.config.retry_max_s)
    with ServingRuntime(model, "bp2", _cfg()) as rt:
        with NetEdge(rt, name="bp2-edge") as edge:
            with WireClient(*edge.address) as cli:
                res = cli.request(_rows(2))
                assert res.status == 200 and res.retry_after_s is None


# -- wire failure modes are typed sheds ---------------------------------------

def test_malformed_http_json_is_400_and_keep_alive_survives(model):
    with ServingRuntime(model, "bad", _cfg()) as rt:
        with NetEdge(rt, name="bad-edge") as edge:
            with socket.create_connection(edge.address, timeout=30) as s:
                body = b"{not json"
                s.sendall(b"POST /score HTTP/1.1\r\n"
                          + f"Content-Length: {len(body)}\r\n\r\n"
                          .encode() + body)
                reader = netproto._SockReader(s)
                status, _, resp = netproto.read_http_response(reader)
                assert status == 400
                assert json.loads(resp)["error"] == "bad_frame"
                good = json.dumps({"rows": _rows(2)}).encode()
                s.sendall(b"POST /score HTTP/1.1\r\n"
                          + f"Content-Length: {len(good)}\r\n\r\n"
                          .encode() + good)
                assert netproto.read_http_response(reader)[0] == 200
            assert _counter(edge, "tg_net_shed_total",
                            reason="bad_frame") >= 1


def test_http_bad_path_is_404_typed(model):
    with ServingRuntime(model, "path", _cfg()) as rt:
        with NetEdge(rt, name="path-edge") as edge:
            with socket.create_connection(edge.address, timeout=30) as s:
                s.sendall(b"GET /metrics HTTP/1.1\r\n\r\n")
                status, _, resp = netproto.read_http_response(
                    netproto._SockReader(s))
                assert status == 404
                assert json.loads(resp)["error"] == "bad_path"
            assert _counter(edge, "tg_net_shed_total",
                            reason="bad_path") == 1.0


def test_oversized_frames_and_header_lines_are_413(model):
    cfg = NetEdgeConfig(max_frame_bytes=512)
    with ServingRuntime(model, "big", _cfg()) as rt:
        with NetEdge(rt, name="big-edge", config=cfg) as edge:
            with socket.create_connection(edge.address, timeout=30) as s:
                s.sendall(netproto.MAGIC + bytes([netproto.KIND_REQUEST])
                          + (1 << 16).to_bytes(4, "big"))
                rdr = netproto._SockReader(s)
                _, _, ln = struct.unpack(">4sBI", rdr.read_exact(9))
                assert json.loads(rdr.read_exact(ln))["status"] == 413
                with pytest.raises(WireDisconnect):
                    rdr.read_exact(1)
            with socket.create_connection(edge.address, timeout=30) as s:
                s.sendall(b"POST /score HTTP/1.1\r\n"
                          b"Content-Length: 999999\r\n\r\n")
                assert netproto.read_http_response(
                    netproto._SockReader(s))[0] == 413
            limit = max(65536, edge.config.max_frame_bytes)
            with socket.create_connection(edge.address, timeout=30) as s:
                s.sendall(b"POST /score HTTP/1.1\r\n"
                          b"X-Big: " + b"a" * (limit + 1024) + b"\r\n")
                status, _, resp = netproto.read_http_response(
                    netproto._SockReader(s))
                assert status == 413
                assert json.loads(resp)["error"] == "oversize"
            assert _wait_counter(edge, "tg_net_shed_total", 3.0,
                                 reason="oversize") == 3.0


def test_tiny_frame_claiming_huge_rows_is_400_not_oom(model):
    with ServingRuntime(model, "rows", _cfg()) as rt:
        with NetEdge(rt, name="rows-edge") as edge:
            hdr = json.dumps({"rows": 10 ** 12, "columns": []},
                             separators=(",", ":")).encode()
            payload = struct.pack(">H", len(hdr)) + hdr
            frame = netproto.FRAME_HEADER.pack(
                netproto.MAGIC, netproto.KIND_REQUEST, len(payload)) \
                + payload
            with socket.create_connection(edge.address, timeout=30) as s:
                s.sendall(frame)
                rdr = netproto._SockReader(s)
                _, _, ln = struct.unpack(">4sBI", rdr.read_exact(9))
                obj = json.loads(rdr.read_exact(ln))
                assert obj["status"] == 400 and obj["error"] == "bad_frame"
                s.sendall(netproto.encode_binary_request(_rows(2)))
                _, kind, ln = struct.unpack(">4sBI", rdr.read_exact(9))
                assert kind == netproto.KIND_RESPONSE
                rdr.read_exact(ln)


def test_wire_client_timeout_closes_desynchronized_connection():
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    try:
        cli = WireClient(*srv.getsockname(), protocol="binary", timeout=0.3)
        with pytest.raises(socket.timeout):
            cli.request([{"x": 1.0}])
        assert not cli.connected
        cli.close()
    finally:
        srv.close()


def test_slow_loris_and_half_open_shed_without_touching_the_runtime(model):
    cfg = NetEdgeConfig(read_timeout_s=0.2)
    with ServingRuntime(model, "loris", _cfg()) as rt:
        with NetEdge(rt, name="loris-edge", config=cfg) as edge:
            with socket.create_connection(edge.address, timeout=30) as s:
                s.sendall(b"PO")
                assert _wait_counter(edge, "tg_net_shed_total", 1.0,
                                     reason="read_timeout") >= 1.0
            with socket.create_connection(edge.address, timeout=30) as s:
                s.sendall(netproto.MAGIC + bytes([netproto.KIND_REQUEST])
                          + (64).to_bytes(4, "big") + b"short")
            assert _wait_counter(edge, "tg_net_shed_total", 2.0,
                                 reason="read_timeout") >= 2.0
            assert _counter(edge, "tg_net_lost_total") == 0
            with WireClient(*edge.address, protocol="binary") as cli:
                assert cli.request(_rows(2)).status == 200


# -- auth and quota at the socket ----------------------------------------------

def test_token_auth_maps_tenant_and_rejects_unknown(model):
    with ServingRuntime(model, "auth", _cfg()) as rt:
        with NetEdge(rt, name="auth-edge", tokens={"sekrit": "acme"}) as edge:
            for proto in ("http", "binary"):
                for token, status in ((None, 401), ("wrong", 401),
                                      ("sekrit", 200)):
                    with WireClient(*edge.address, protocol=proto,
                                    token=token) as cli:
                        assert cli.request(_rows(2)).status == status
            assert _counter(edge, "tg_net_shed_total", reason="auth") == 4.0


def test_tenant_quota_sheds_429_at_the_edge(model, monkeypatch):
    """The edge's clock is frozen, so the five requests fall in one quota
    window however long they take."""
    frozen = types.SimpleNamespace(monotonic=lambda: 1000.0,
                                   perf_counter=time.perf_counter)
    monkeypatch.setattr(netedge_mod, "time", frozen)
    cfg = NetEdgeConfig(tenant_rps=2.0)
    with ServingRuntime(model, "quota", _cfg()) as rt:
        with NetEdge(rt, name="quota-edge", config=cfg,
                     tokens={"k": "noisy"}) as edge:
            with WireClient(*edge.address, protocol="binary",
                            token="k") as cli:
                statuses = [cli.request(_rows(1)).status for _ in range(5)]
            assert statuses == [200, 200, 429, 429, 429]
            assert _counter(edge, "tg_net_tenant_shed_total",
                            tenant="noisy") == 3.0


# -- chaos sites ----------------------------------------------------------------

@pytest.mark.chaos
def test_chaos_net_accept_drops_connection_as_typed_shed(model):
    with ServingRuntime(model, "ca", _cfg()) as rt:
        with NetEdge(rt, name="ca-edge") as edge:
            with faults.injected({"net.accept": {"mode": "raise", "nth": 1,
                                                 "count": 1}}):
                with pytest.raises(WireDisconnect):
                    with WireClient(*edge.address, protocol="binary") as c:
                        c.request(_rows(2))
                assert faults.fired_counts().get("net.accept")
            assert _wait_counter(edge, "tg_net_shed_total", 1.0,
                                 reason="accept_fault") == 1.0
            kinds = [r.kind for r in edge.fault_log.reports]
            assert NET_KINDS["net.accept"] in kinds
            with WireClient(*edge.address, protocol="binary") as cli:
                assert cli.request(_rows(2)).status == 200


@pytest.mark.chaos
@pytest.mark.parametrize("site,reason", [
    ("net.read", "read_fault"), ("net.write", "write_fault")])
def test_chaos_read_write_resolve_as_typed_sheds_never_lost(
        model, site, reason):
    rows = _rows(4)
    base = micro_batch_score_function(model)(rows)
    with ServingRuntime(model, "crw", _cfg()) as rt:
        with NetEdge(rt, name="crw-edge") as edge:
            with faults.injected({site: {"mode": "raise", "nth": 1,
                                         "count": 1}}):
                with pytest.raises(WireDisconnect):
                    with WireClient(*edge.address, protocol="http") as cli:
                        cli.request(rows)
            assert _wait_counter(edge, "tg_net_shed_total", 1.0,
                                 reason=reason) == 1.0
            assert _counter(edge, "tg_net_lost_total") == 0
            assert NET_KINDS[site] in [r.kind
                                       for r in edge.fault_log.reports]
            with WireClient(*edge.address, protocol="binary") as cli:
                res = cli.request(rows)
                assert res.status == 200 and res.records == base


# -- socket-mode load generation -------------------------------------------------

def test_wire_loadgen_accounting_clean_with_protocol_breakdown(model):
    with ServingRuntime(model, "lg", _cfg()) as rt:
        with NetEdge(rt, name="lg-edge") as edge:
            rep = run_wire_open_loop(*edge.address, _rows(32), seconds=0.8,
                                     rps=120.0, batch_rows=4)
    assert rep["accountingOk"], rep
    assert rep["lost"] == 0 and rep["failed"] == 0 and rep["completed"] > 0
    for proto in ("http", "binary"):
        pp = rep["protocols"][proto]
        assert pp["requests"] > 0 and pp["p99Ms"] == pp["p99Ms"]


@pytest.mark.chaos
def test_wire_loadgen_disconnect_chaos_typed_never_lost(model):
    with ServingRuntime(model, "lgc", _cfg()) as rt:
        with NetEdge(rt, name="lgc-edge") as edge:
            with faults.injected({
                    "net.read": {"mode": "raise", "nth": 4, "count": 2},
                    "net.write": {"mode": "raise", "nth": 9, "count": 2}}):
                rep = run_wire_open_loop(
                    *edge.address, _rows(32), seconds=1.0, rps=160.0,
                    batch_rows=4, reconnect_every=5)
    assert rep["shedDisconnect"] > 0, rep
    assert rep["lost"] == 0 and rep["failed"] == 0, rep
    assert rep["accountingOk"], rep


def test_net_oracle_reports_and_cleans_a_leaked_edge(model):
    with ServingRuntime(model, "leak", _cfg()) as rt:
        edge = NetEdge(rt, name="leak-edge")
        try:
            assert any("leak-edge" in v for v in oracles.net_violations())
            assert edge in live_edges()
        finally:
            assert oracles.close_leaked_net_edges() == ["leak-edge"]
        assert oracles.net_violations() == [] and edge not in live_edges()
        assert not oracles.leaked_threads(("tg-net",))
