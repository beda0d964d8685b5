"""The port's Avro codec, ``AvroReader``, ``CSVAutoReader`` and
``StreamingDataReader`` against the JAX package's, on the CPU (the
records of ``tests/test_avro.py`` and seeded passenger-like records with
nulls and nested records). Files written by either package's codec decode
equal in the other; with the sync marker pinned both write the same
bytes. The readers' tables are compared by ``testing.table_digest``:
keys, order, values and nulls. Tolerance: none.
"""
from __future__ import annotations

import csv
import math
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pandas as pd
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from transmogrifai_tpu.features import FeatureBuilder as JFB  # noqa: E402
from transmogrifai_tpu.readers import readers as jreaders  # noqa: E402
from transmogrifai_tpu.utils import avro as javro  # noqa: E402

from transmogrifai_tpu_torch.features import (  # noqa: E402
    FeatureBuilder as PFB,
)
from transmogrifai_tpu_torch.readers import readers as preaders  # noqa: E402
from transmogrifai_tpu_torch.testing import table_digest  # noqa: E402
from transmogrifai_tpu_torch.utils import avro as pavro  # noqa: E402

FLAT = [{"a": 1, "b": 2.5, "c": "x", "d": None, "e": True},
        {"a": None, "b": 1.0, "c": "y", "d": None, "e": False}]
COMPLEX_SCHEMA = {
    "type": "record", "name": "R", "fields": [
        {"name": "tags", "type": {"type": "array", "items": "string"}},
        {"name": "m", "type": {"type": "map", "values": "double"}},
        {"name": "kind", "type": {"type": "enum", "name": "K",
                                  "symbols": ["A", "B"]}},
        {"name": "blob", "type": ["null", "bytes"]},
        {"name": "f", "type": "float"},
        {"name": "fx", "type": {"type": "fixed", "name": "F", "size": 2}},
    ]}
COMPLEX = [{"tags": ["x", "y"], "m": {"p": 1.5}, "kind": "B",
            "blob": b"\x00\x01", "f": 0.5, "fx": b"ab"},
           {"tags": [], "m": {}, "kind": "A", "blob": None, "f": -2.0,
            "fx": b"cd"}]
NESTED_SCHEMA = {
    "type": "record", "name": "P", "fields": [
        {"name": "id", "type": "long"},
        {"name": "name", "type": ["null", "string"]},
        {"name": "age", "type": ["null", "double"]},
        {"name": "address", "type": {
            "type": "record", "name": "Addr", "fields": [
                {"name": "city", "type": ["null", "string"]},
                {"name": "geo", "type": {
                    "type": "record", "name": "Geo", "fields": [
                        {"name": "lat", "type": "double"},
                        {"name": "lon", "type": "double"}]}}]}},
        {"name": "scores", "type": {"type": "map", "values": "double"}},
    ]}


def passengers(n=300, seed=0):
    """Seeded records: a key, nullable numbers and strings, a nested
    record two levels deep and a map."""
    rng = np.random.RandomState(seed)
    cities = ["Paris", "Oslo", None, "Lima"]
    out = []
    for i in range(n):
        out.append({
            "id": int(i * 3 + 1),
            "name": None if rng.rand() < 0.1 else f"p{int(rng.randint(50))}",
            "age": None if rng.rand() < 0.2 else float(
                np.round(rng.rand() * 80, 1)),
            "address": {"city": cities[int(rng.randint(4))],
                        "geo": {"lat": float(rng.randn()),
                                "lon": float(rng.randn())}},
            "scores": {f"k{j}": float(rng.rand())
                       for j in range(int(rng.randint(0, 3)))}})
    return out


@pytest.mark.parametrize("codec", ["deflate", "null"])
@pytest.mark.parametrize("recs,schema", [
    (FLAT, None), (COMPLEX, COMPLEX_SCHEMA), (passengers(), NESTED_SCHEMA)])
def test_files_cross_both_codecs(tmp_path, monkeypatch, codec, recs,
                                 schema):
    """Each package reads what the other wrote; with ``os.urandom``
    pinned both write the same bytes, and infer the same schema."""
    jp, pp = str(tmp_path / "j.avro"), str(tmp_path / "p.avro")
    javro.write_avro(jp, recs, schema=schema, codec=codec, sync_interval=7)
    pavro.write_avro(pp, recs, schema=schema, codec=codec, sync_interval=7)
    assert list(pavro.read_avro(jp)) == recs
    assert list(javro.read_avro(pp)) == recs
    assert list(pavro.read_avro(pp)) == recs
    monkeypatch.setattr(os, "urandom", lambda k: bytes(range(k)))
    javro.write_avro(jp, recs, schema=schema, codec=codec)
    pavro.write_avro(pp, recs, schema=schema, codec=codec)
    with open(jp, "rb") as a, open(pp, "rb") as b:
        assert a.read() == b.read()
    if schema is None:
        assert pavro.schema_of_records(recs) == javro.schema_of_records(recs)


def test_empty_and_bad_files(tmp_path):
    """A file of no records: the port writes its empty block through the
    codec, so both packages read it; the JAX package writes a deflate
    file's empty block as no bytes, which its own reader cannot inflate
    and the port's reader skips (a block of 0 records)."""
    schema = {"type": "record", "name": "E", "fields": []}
    for codec in ("deflate", "null"):
        p = str(tmp_path / f"e_{codec}.avro")
        pavro.write_avro(p, [], schema=schema, codec=codec)
        assert list(pavro.read_avro(p)) == list(javro.read_avro(p)) == []
        javro.write_avro(p, [], schema=schema, codec=codec)
        assert list(pavro.read_avro(p)) == []
    p = str(tmp_path / "e_deflate.avro")
    with pytest.raises(Exception, match="incomplete or truncated"):
        list(javro.read_avro(p))
    bad = str(tmp_path / "bad.avro")
    with open(bad, "wb") as fh:
        fh.write(b"nope")
    with pytest.raises(ValueError, match="not an avro"):
        list(pavro.read_avro(bad))
    with pytest.raises(ValueError, match="codec"):
        pavro.write_avro(p, FLAT, codec="snappy")


def _canon(v):
    if isinstance(v, float) and math.isnan(v):
        return "nan"
    if isinstance(v, dict):
        return {k: _canon(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_canon(x) for x in v]
    return v


def test_avro_reader_flattens_and_types_as_jax(tmp_path):
    """Nested records flatten to dotted names, a map stays a value; the
    frame's records equal the JAX DataFrame's, and the tables of typed
    features (a dotted field among them) are equal."""
    p = str(tmp_path / "pass.avro")
    javro.write_avro(p, passengers(), schema=NESTED_SCHEMA)
    jdf = jreaders.AvroReader(p).read()
    pfr = preaders.AvroReader(p).read()
    assert list(pfr.columns) == list(jdf.columns)
    # a record of plain values is one value: flattening stops above it
    assert {"address.city", "address.geo", "scores"} <= set(pfr.columns)
    assert [_canon(r) for r in pfr.records()] == \
        [_canon(r) for r in jdf.to_dict("records")]

    def feats(FB):
        return [FB.Real("age").extract_field().as_predictor(),
                FB.Text("name").extract_field().as_predictor(),
                FB.PickList("address.city").extract_field().as_predictor(),
                FB.Real("lat").extract(
                    lambda r: r["address.geo"]["lat"]).as_predictor(),
                FB.RealMap("scores").extract_field().as_predictor()]
    jt = jreaders.DataReaders.Simple.avro(p, key_field="id") \
        .generate_table(feats(JFB))
    pt = preaders.DataReaders.Simple.avro(p, key_field="id") \
        .generate_table(feats(PFB))
    names = ["age", "name", "address.city", "lat", "scores"]
    assert table_digest(pt, names) == table_digest(jt, names)
    assert list(pt.key)[:2] == ["1", "4"]


def test_flatten_record_matches_jax():
    recs = [{"a": {"b": {"c": 1}, "d": 2}, "m": {"x": 1.0, "y": 2.0},
             "e": {}, "n": {"q": [1, 2], "r": {"s": None}}}]
    for r in recs:
        assert preaders.flatten_record(r) == jreaders.AvroReader._flatten(r)


def _headed_csv(path, n=200, seed=1):
    rng = np.random.RandomState(seed)
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh, lineterminator="\n")
        w.writerow(["id", "x", "k", "flag", "t", "gap"])
        for i in range(n):
            w.writerow([i, f"{rng.randn():.4f}", int(rng.randint(5)),
                        "True" if rng.rand() < 0.5 else "False",
                        "" if rng.rand() < 0.2 else f"w{int(rng.randint(9))}",
                        "" if rng.rand() < 0.3 else int(rng.randint(100))])
    return path


def test_csv_auto_reader_matches_jax(tmp_path):
    p = _headed_csv(str(tmp_path / "auto.csv"))

    def feats(FB):
        return [FB.Real("x").extract_field().as_predictor(),
                FB.Integral("k").extract_field().as_predictor(),
                FB.Binary("flag").extract_field().as_predictor(),
                FB.Text("t").extract_field().as_predictor(),
                FB.Real("gap").extract_field().as_predictor(),
                FB.PickList("gapText").extract(
                    lambda r: str(r["gap"])).as_predictor()]
    jt = jreaders.DataReaders.Simple.csv_auto(p, key_field="id") \
        .generate_table(feats(JFB))
    pr = preaders.DataReaders.Simple.csv_auto(p, key_field="id")
    assert isinstance(pr, preaders.CSVAutoReader)
    pt = pr.generate_table(feats(PFB))
    names = ["x", "k", "flag", "t", "gap", "gapText"]
    assert table_digest(pt, names) == table_digest(jt, names)
    assert [_canon(r) for r in pr.read().records()] == \
        [_canon(r) for r in pd.read_csv(p).to_dict("records")]


def test_whitespace_csv_reads_as_pandas(tmp_path):
    p = str(tmp_path / "ws.data")
    with open(p, "w") as fh:
        fh.write(" 0.00632  18.00   2.310  0  0.5380\n"
                 "\t0.02731   0.00   7.070  1  0.4690  \n\n"
                 " 0.02729   0.00   7.070  0  0.4690\n")
    names = ["a", "b", "c", "d", "e"]
    got = preaders.read_csv(p, schema=names, header=False, whitespace=True)
    want = pd.read_csv(p, header=None, names=names, sep=r"\s+")
    assert [_canon(r) for r in got.records()] == \
        [_canon(r) for r in want.to_dict("records")]
    assert {n: got[n].dtype for n in names} == \
        {n: want[n].dtype for n in names}


@pytest.mark.parametrize("kind", ["frames", "mappings", "records"])
def test_streaming_reader_batches_match_jax(kind):
    rng = np.random.RandomState(3)
    batches = []
    for size in (5, 1, 7):
        batches.append({"id": [f"r{int(v)}" for v in rng.randint(0, 99,
                                                               size)],
                        "x": [None if rng.rand() < 0.3 else float(v)
                              for v in rng.randn(size)],
                        "s": [None if rng.rand() < 0.3 else f"s{int(v)}"
                              for v in rng.randint(0, 4, size)]})

    def port_batch(b):
        if kind == "frames":
            return preaders.Frame.of(b)
        if kind == "records":
            return [dict(zip(b, vals)) for vals in zip(*b.values())]
        return b

    def feats(FB):
        return [FB.Real("x").extract_field().as_predictor(),
                FB.PickList("s").extract_field().as_predictor()]
    jt = list(jreaders.DataReaders.Streaming.batches(
        [pd.DataFrame(b) for b in batches], key_field="id")
        .stream_tables(feats(JFB)))
    pt = list(preaders.DataReaders.Streaming.batches(
        [port_batch(b) for b in batches], key_field="id")
        .stream_tables(feats(PFB)))
    assert len(pt) == len(jt) == 3
    for a, b in zip(jt, pt):
        assert table_digest(b, ["x", "s"]) == table_digest(a, ["x", "s"])
    with pytest.raises(ValueError, match="stream_tables"):
        preaders.StreamingDataReader(batches).generate_table(feats(PFB))
