"""The port's Parquet (``transmogrifai_tpu_torch/utils/parquet.py``, the
``ParquetReader`` and the runner's Parquet writes) against pandas and
pyarrow and the JAX package, on the CPU.

- Reading: a table of every kind that ``table_to_dataframe`` writes (real,
  integral, binary and date with nulls; text with None; a map as a struct
  over the union of its keys, ``{}`` and None rows; lists of strings and
  doubles, empty and None; a prediction struct) written by pyarrow with
  pandas' defaults and with ``compression=None``/``"gzip"``,
  ``use_dictionary=False``, ``data_page_version="2.0"``, small row groups,
  a dictionary page limit that forces the PLAIN fallback mid-chunk and
  small data pages. The port's columns equal ``pd.read_parquet``'s (dtype
  and every cell, nested ones by type and value), and its raw table equals
  the JAX package's ``dataframe_to_table`` of that frame.
- Writing: files the port writes read through ``pd.read_parquet`` and
  ``pq.read_table`` equal to the JAX package's own write of the same table.
- Snappy and the RLE/bit-packed hybrid: round trips against pyarrow's
  codec, hypothesis cases for both.
- Errors: a codec or an encoding the port does not read raises by name.
- The runner: ``tests/test_runner_testkit.py``'s Parquet cases in both
  packages (score, streaming score, the features run through ``OpApp``).
- The committed fixture ``fixtures/parquet``: each file read equal to what
  ``pd.read_parquet`` gave when it was written (the leads file's values in
  ``leads_features.npz``; the two Titanic files' per-column digests in
  ``fixture.json``, ``testing.columns_digest``, which keeps the directory
  under 600 KB).

Tolerances: exact everywhere except the runner's predictions, whose
probabilities are within ``PROB_ATOL`` (1e-5: the LR's dot product adds in
another order on the port).

Regenerate the fixture (JAX package, CPU, ~20 s):
``python tests/test_torch_parquet.py``.
"""
from __future__ import annotations

import hashlib
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from hypothesis import given, settings, strategies as st

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (REPO, os.path.dirname(os.path.abspath(__file__))):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import transmogrifai_tpu  # noqa: E402,F401
from transmogrifai_tpu import runner as jrun  # noqa: E402
from transmogrifai_tpu.features import (  # noqa: E402
    FeatureBuilder as JFB, reset_uids as jax_reset,
)
from transmogrifai_tpu.readers.readers import (  # noqa: E402
    DataReaders as JReaders, dataframe_to_table as jax_frame_to_table,
)
from transmogrifai_tpu.table import (  # noqa: E402
    Column as JColumn, FeatureTable as JTable,
)
from transmogrifai_tpu import types as jtypes  # noqa: E402

from transmogrifai_tpu_torch import runner as prun  # noqa: E402
from transmogrifai_tpu_torch import types as ptypes  # noqa: E402
from transmogrifai_tpu_torch.features import (  # noqa: E402
    FeatureBuilder as PFB, reset_uids as port_reset,
)
from transmogrifai_tpu_torch.readers.readers import (  # noqa: E402
    DataReaders as PReaders, ParquetReader,
)
from transmogrifai_tpu_torch.table import (  # noqa: E402
    Column as PColumn, FeatureTable as PTable,
)
from transmogrifai_tpu_torch.testing import (  # noqa: E402
    LEADS_CLOCK_MS, LEADS_SCORE_SEED, TITANIC_SCORE_ROWS,
    TITANIC_SCORE_SEED, column_gaps, leads_records, load_columns,
    columns_digest, save_columns, table_digest, titanic_csv,
)
from transmogrifai_tpu_torch.utils import parquet as P  # noqa: E402

pytestmark = pytest.mark.parquet

FIXTURE = os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures",
                       "parquet")
#: the fixture's leads features run: scoring records
LEADS_PARQUET_ROWS = 512
#: a prediction's probability, the port against the JAX package
PROB_ATOL = 1e-5

# ---------------------------------------------------------------------------
# A table of every kind
# ---------------------------------------------------------------------------

#: (column, feature type) of ``_kinds_values``
KINDS = (("r", "Real"), ("i", "Integral"), ("b", "Binary"), ("d", "Date"),
         ("t", "Text"), ("m", "RealMap"), ("pm", "PickListMap"),
         ("tl", "TextList"), ("g", "Geolocation"))


def _kinds_values(n: int = 300, seed: int = 0):
    """{column: python values} with nulls everywhere a kind can hold one,
    and the prediction dicts."""
    rng = np.random.RandomState(seed)

    def maybe(v, p=0.15):
        return None if rng.rand() < p else v
    vals = {
        "r": [maybe(float(np.float32(x))) for x in rng.randn(n)],
        "i": [maybe(int(x)) for x in rng.randint(-50, 50, n)],
        "b": [maybe(bool(x)) for x in rng.randint(0, 2, n)],
        "d": [maybe(int(x)) for x in rng.randint(0, 2 ** 41, n)],
        "t": [maybe(f"w{x}") for x in rng.randint(0, 40, n)],
        "m": [None if rng.rand() < 0.1 else {} if rng.rand() < 0.1 else
              {f"k{j}": float(np.float32(rng.randn()))
               for j in rng.choice(6, rng.randint(1, 4), replace=False)}
              for _ in range(n)],
        "pm": [None if rng.rand() < 0.1 else
               {f"p{j}": f"v{rng.randint(5)}"
                for j in rng.choice(3, rng.randint(1, 3), replace=False)}
               for _ in range(n)],
        "tl": [None if rng.rand() < 0.1 else
               [f"x{v}" for v in rng.randint(0, 9, rng.randint(0, 4))]
               for _ in range(n)],
        "g": [None if rng.rand() < 0.15 else
              [float(np.float32(v)) for v in
               (rng.uniform(-80, 80), rng.uniform(-170, 170),
                rng.randint(1, 10))] for _ in range(n)],
    }
    p1 = rng.rand(n)
    preds = [{"prediction": float(v > 0.5), "probability_0": 1.0 - float(v),
              "probability_1": float(v)} for v in p1]
    return vals, preds


def _table(ns_types, Column, Table, n: int = 300, seed: int = 0):
    vals, preds = _kinds_values(n, seed)
    cols = {name: Column.of_values(getattr(ns_types, t), vals[name])
            for name, t in KINDS}
    cols["pred"] = Column.of_values(ns_types.Prediction, preds)
    return Table(cols, n, np.array([f"id{i:04d}" for i in range(n)],
                                   dtype=object))


def _features(FB, reset):
    reset()
    return [getattr(FB, t)(name).extract_field().as_predictor()
            for name, t in KINDS]


def _pandas_columns(path):
    df = pd.read_parquet(path)
    return {c: df[c].to_numpy() for c in df.columns}


def _same_tables(got, want, names):
    """Two raw tables (either package's) cell by cell: numeric values and
    validity bit for bit, any other cell by type and value (arrays by
    dtype), the keys."""
    from transmogrifai_tpu_torch.testing import _same_value
    assert [str(k) for k in got.key] == [str(k) for k in want.key]
    for n in names:
        g, w = got[n], want[n]
        gv, wv = np.asarray(g.values), np.asarray(w.values)
        gm = np.ones(len(gv), bool) if g.mask is None else np.asarray(g.mask)
        wm = np.ones(len(wv), bool) if w.mask is None else np.asarray(w.mask)
        assert np.array_equal(gm, wm), n
        if wv.dtype != object:
            assert gv.dtype == wv.dtype and np.array_equal(gv, wv), n
            continue
        for i, (a, b) in enumerate(zip(gv.tolist(), wv.tolist())):
            assert _same_value(a, b), (n, i, a, b)


VARIANTS = {
    "defaults": {},
    "uncompressed": dict(compression=None),
    "gzip": dict(compression="gzip"),
    "plain": dict(use_dictionary=False),
    "page_v2": dict(data_page_version="2.0"),
    "row_groups": dict(row_group_size=37),
    "dict_fallback": dict(dictionary_pagesize_limit=64),
    "small_pages": dict(data_page_size=256),
}


@pytest.fixture(scope="module")
def kinds_frame():
    return jrun.table_to_dataframe(_table(jtypes, JColumn, JTable))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_reads_pyarrow_writes_as_pandas(kinds_frame, variant, tmp_path):
    path = str(tmp_path / "k.parquet")
    kinds_frame.to_parquet(path, **VARIANTS[variant])
    assert column_gaps(P.read_parquet(path), _pandas_columns(path)) == []
    names = [n for n, _ in KINDS]
    jfeats = _features(JFB, jax_reset)
    want = jax_frame_to_table(pd.read_parquet(path), jfeats, key_field="key")
    pfeats = _features(PFB, port_reset)
    got = ParquetReader(path, key_field="key").generate_table(pfeats)
    _same_tables(got, want, names)


def test_reads_every_physical_and_logical_type(tmp_path):
    """The INT widths, unsigned ints, float32, FLOAT16, DATE, TIME in s,
    ms, us and ns, TIMESTAMP in ms, us and ns, binary and fixed-length
    binary, a null column, bools with and without nulls, nested lists and
    lists of structs."""
    import datetime
    t = pa.table({
        "i8": pa.array([1, None, -3], pa.int8()),
        "i16": pa.array([1, 2, -3], pa.int16()),
        "i32": pa.array([1, 2, -3], pa.int32()),
        "u8": pa.array([1, 2, 255], pa.uint8()),
        "u32": pa.array([1, 2, 2 ** 32 - 1], pa.uint32()),
        "u64": pa.array([1, 2, 2 ** 64 - 1], pa.uint64()),
        "f32": pa.array([1.5, None, -2.25], pa.float32()),
        "date": pa.array([datetime.date(2020, 1, 2), None,
                          datetime.date(1969, 12, 31)], pa.date32()),
        "ts_ms": pa.array([1000, None, -5], pa.timestamp("ms")),
        "ts_us": pa.array([1000, None, 7], pa.timestamp("us")),
        "ts_ns": pa.array([1000, None, 9], pa.timestamp("ns")),
        "bin": pa.array([b"x", None, b"\x00\xff"]),
        "fixed": pa.array([b"ab", None, b"cd"], pa.binary(2)),
        "null": pa.array([None, None, None], pa.null()),
        "bools": pa.array([True, False, True]),
        "nbools": pa.array([True, None, False]),
        "ll": pa.array([[[1, 2], [], None], None, [[3]]],
                       pa.list_(pa.list_(pa.int64()))),
        "ls": pa.array([[{"a": 1, "b": "x"}, None], [], None],
                       pa.list_(pa.struct([("a", pa.int64()),
                                           ("b", pa.string())]))),
        "sl": pa.array([{"x": [1.0, None]}, {"x": None}, None],
                       pa.struct([("x", pa.list_(pa.float64()))])),
        "f16": pa.array(np.array([1.5, 0.0, -2.25], np.float16)),
        "nf16": pa.array([1.0, None, 65504.0], pa.float32()).cast(
            pa.float16()),
        "t_ms": pa.array([1000, None, 86399999], pa.time32("ms")),
        "t_s": pa.array([1000, None, 5], pa.time32("s")),
        "t_us": pa.array([1000, None, 7], pa.time64("us")),
        "t_ns": pa.array([1000, None, 9000], pa.time64("ns")),
    })
    for kw in ({}, dict(data_page_version="2.0", use_dictionary=False)):
        path = str(tmp_path / "t.parquet")
        pq.write_table(t, path, **kw)
        assert column_gaps(P.read_parquet(path), _pandas_columns(path)) == []


def test_float16_and_time_tables_as_the_jax_reader(tmp_path):
    """A Real feature over a FLOAT16 column and over a TIME column, and a
    Text feature over the TIME column: the port's raw table equals the JAX
    ``ParquetReader``'s (a TIME value is no number: the Real is missing
    there on every row, as in the JAX package)."""
    t = pa.table({
        "key": pa.array(["a", "b", "c", "d"]),
        "h": pa.array([1.5, None, -2.25, 0.0], pa.float32()).cast(
            pa.float16()),
        "tm": pa.array([1000, None, 5, 86399999], pa.time32("ms")),
    })
    path = str(tmp_path / "ht.parquet")
    pq.write_table(t, path)
    assert column_gaps(P.read_parquet(path), _pandas_columns(path)) == []

    def feats(FB, reset):
        reset()
        return [FB.Real("h").extract_field().as_predictor(),
                FB.Real("tm").extract_field().as_predictor()]
    want = JReaders.Simple.parquet(path, key_field="key").generate_table(
        feats(JFB, jax_reset))
    got = PReaders.Simple.parquet(path, key_field="key").generate_table(
        feats(PFB, port_reset))
    _same_tables(got, want, ["h", "tm"])


def test_reads_a_directory_of_parts_as_pandas(tmp_path):
    """A directory of two part files (2 rows and 1; a ``_SUCCESS`` marker
    and a hidden file beside them) and a frame written with
    ``partition_cols=``: the port's columns equal ``pd.read_parquet``'s of
    the directory (the files in sorted order, the partition levels as
    columns after the files' own), and its raw table equals the JAX
    ``ParquetReader``'s."""
    parts = tmp_path / "parts"
    parts.mkdir()
    pd.DataFrame({"key": ["k1", "k2"], "x": [1.5, None],
                  "s": ["u", None]}).to_parquet(parts / "part-1.parquet")
    pd.DataFrame({"key": ["k0"], "x": [2.5], "s": ["v"]}).to_parquet(
        parts / "part-0.parquet")
    (parts / "_SUCCESS").write_text("")
    (parts / ".part-0.parquet.crc").write_text("")
    hive = str(tmp_path / "hive")
    pd.DataFrame({"key": [f"h{i}" for i in range(6)],
                  "x": [0.5, 1.0, None, 2.0, 3.5, -1.0],
                  "s": ["a", "b", "a", None, "c", "b"],
                  "g": ["u", "v", "u", "w", "v", "u"],
                  "n": [1, 2, 1, 3, -2, 1]}).to_parquet(
        hive, partition_cols=["g", "n"])
    cases = ((str(parts), (("x", "Real"), ("s", "PickList"))),
             (hive, (("x", "Real"), ("s", "Text"), ("g", "PickList"),
                     ("n", "Integral"))))
    for path, kinds in cases:
        got_cols = P.read_parquet(path)
        assert column_gaps(got_cols, _pandas_columns(path)) == [], path
        assert len(got_cols["key"]) == (3 if path.endswith("parts") else 6)

        def feats(FB, reset):
            reset()
            return [getattr(FB, t)(name).extract_field().as_predictor()
                    for name, t in kinds]
        want = JReaders.Simple.parquet(path, key_field="key"
                                       ).generate_table(feats(JFB, jax_reset))
        got = PReaders.Simple.parquet(path, key_field="key").generate_table(
            feats(PFB, port_reset))
        _same_tables(got, want, [n for n, _ in kinds])


def test_reads_the_legacy_two_level_list(tmp_path):
    path = str(tmp_path / "legacy.parquet")
    t = pa.table({"l": pa.array([[1.0, 2.0], [], None], pa.list_(
        pa.float64()))})
    pq.write_table(t, path, use_compliant_nested_type=False)
    assert column_gaps(P.read_parquet(path), _pandas_columns(path)) == []
    # a bare repeated primitive (no LIST annotation): one array a row
    sch = P.read_metadata(path)["schema"]
    assert sch.children[0].is_list


@pytest.mark.parametrize("compression,row_group_rows", [
    ("snappy", 1 << 20), (None, 1 << 20), (None, 41), ("snappy", 41)])
def test_port_writes_read_as_the_jax_write(compression, row_group_rows,
                                            tmp_path, monkeypatch):
    jt = _table(jtypes, JColumn, JTable)
    pt = _table(ptypes, PColumn, PTable)
    jpath, ppath = str(tmp_path / "j.parquet"), str(tmp_path / "p.parquet")
    jrun.table_to_dataframe(jt).to_parquet(jpath)
    monkeypatch.setattr(P, "ROW_GROUP_ROWS", row_group_rows)
    P.write_parquet(ppath, prun.table_to_frame(pt).columns,
                    compression=compression)
    assert len(pq.ParquetFile(ppath).metadata.to_dict()["row_groups"]) == (
        -(-len(pt) // row_group_rows))
    pd.testing.assert_frame_equal(pd.read_parquet(ppath),
                                  pd.read_parquet(jpath))
    # pyarrow's read: the same values (the JAX write's stored arrow schema
    # widens its strings to large_string; the port stores none)
    pt_, jt_ = pq.read_table(ppath), pq.read_table(jpath)
    assert pt_.column_names == jt_.column_names
    assert pt_.to_pylist() == jt_.to_pylist()
    assert column_gaps(P.read_parquet(ppath), _pandas_columns(jpath)) == []


def test_writes_an_index_and_numeric_dtypes(tmp_path):
    """A stored index (``pd.concat``'s) and int32, uint, float32, bool and
    datetime64 columns read back as pandas wrote them."""
    cols = {"a": np.array([1, 2, 3], np.int32),
            "u": np.array([1, 2, 2 ** 63], np.uint64),
            "f": np.array([1.5, np.nan, 2.0], np.float32),
            "b": np.array([True, False, True]),
            "t": np.array([1, -2, 3], "M8[us]"),
            "s": np.array(["x", np.nan, "z"], dtype=object)}
    index = np.array([0, 1, 0])
    path, jpath = str(tmp_path / "p.parquet"), str(tmp_path / "j.parquet")
    P.write_parquet(path, cols, index=index)
    df = pd.DataFrame(cols, index=index)
    df.to_parquet(jpath)
    pd.testing.assert_frame_equal(pd.read_parquet(path),
                                  pd.read_parquet(jpath))
    assert column_gaps(P.read_parquet(path), _pandas_columns(jpath)) == []


def test_empty_frames_both_ways(tmp_path):
    """pandas' write of no rows reads as pandas reads it; the port's write
    of no rows reads back with its dtypes."""
    df = pd.DataFrame({"a": pd.Series([], dtype="float64"),
                       "s": pd.Series([], dtype="str"),
                       "i": pd.Series([], dtype="int64")})
    path = str(tmp_path / "e.parquet")
    df.to_parquet(path)
    assert column_gaps(P.read_parquet(path), _pandas_columns(path)) == []
    ppath = str(tmp_path / "p.parquet")
    P.write_parquet(ppath, {"a": np.zeros(0), "i": np.zeros(0, np.int64)})
    back = pd.read_parquet(ppath)
    assert len(back) == 0 and back.dtypes.to_dict() == {
        "a": np.dtype("float64"), "i": np.dtype("int64")}


# ---------------------------------------------------------------------------
# Codecs, the hybrid encoding, errors
# ---------------------------------------------------------------------------

def _snappy_blobs():
    rng = np.random.RandomState(3)
    return [b"", b"a", b"abcd" * 3, b"abcabcabcabcabcabcabc" * 100,
            b"x" * 70000, bytes(rng.randint(0, 256, 5000).astype(np.uint8)),
            b"".join(rng.choice([b"alpha", b"beta", b"gamma"], 3000)),
            bytes(range(256)) * 300]


@pytest.mark.parametrize("i", range(len(_snappy_blobs())))
def test_snappy_against_pyarrow(i):
    blob = _snappy_blobs()[i]
    ours = P.snappy_compress(blob)
    assert pa.decompress(ours, len(blob), codec="snappy") == blob
    assert P.snappy_decompress(pa.compress(blob, codec="snappy")) == blob
    assert P.snappy_decompress(ours) == blob


@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.binary(min_size=1, max_size=12),
                          st.integers(1, 40)), max_size=30))
def test_snappy_round_trips_hypothesis(parts):
    """Repeated fragments make copies, overlapping ones included."""
    blob = b"".join(frag * k for frag, k in parts)
    assert P.snappy_decompress(P.snappy_compress(blob)) == blob
    assert P.snappy_decompress(pa.compress(blob, codec="snappy")) == blob


@settings(max_examples=80, deadline=None)
@given(st.integers(1, 21).flatmap(lambda w: st.tuples(
    st.just(w), st.lists(st.tuples(st.integers(0, 2 ** w - 1),
                                   st.integers(1, 30)), max_size=20))))
def test_rle_hybrid_round_trips_hypothesis(case):
    """Runs and mixed stretches at bit widths that are not a multiple of
    8: the port's encoding decodes to the values."""
    width, runs = case
    vals = np.array([v for v, k in runs for _ in range(k)], np.int64)
    enc = P.rle_hybrid_encode(vals, width)
    got, _ = P.rle_hybrid_decode(enc, width, len(vals))
    assert np.array_equal(got, vals)


def test_rle_hybrid_decodes_hand_made_runs():
    """An RLE run, a bit-packed run at width 3 and a trailing RLE run."""
    vals = [5] * 10 + [1, 2, 3, 4, 5, 6, 7, 0] + [2] * 3
    enc = bytes([10 << 1, 5])                 # RLE: 10 x 5
    bits = "".join(format(v, "03b")[::-1] for v in vals[10:18])
    packed = bytes(int(bits[i:i + 8][::-1], 2) for i in range(0, 24, 8))
    enc += bytes([(1 << 1) | 1]) + packed     # one bit-packed group of 8
    enc += bytes([3 << 1, 2])                 # RLE: 3 x 2
    got, end = P.rle_hybrid_decode(enc, 3, len(vals))
    assert got.tolist() == vals and end == len(enc)


@pytest.mark.parametrize("codec", ["zstd", "brotli", "lz4"])
def test_unsupported_codec_raises_by_name(codec, tmp_path):
    path = str(tmp_path / f"{codec}.parquet")
    pd.DataFrame({"x": [1.0, 2.0]}).to_parquet(path, compression=codec)
    name = {"zstd": "ZSTD", "brotli": "BROTLI", "lz4": "LZ4"}[codec]
    with pytest.raises(P.ParquetError, match=f"{name}.*not supported") as e:
        P.read_parquet(path)
    assert path in str(e.value)


@pytest.mark.parametrize("codec", ["gzip", "uncompressed"])
def test_writer_takes_snappy_or_none(codec, tmp_path):
    path = str(tmp_path / "w.parquet")
    with pytest.raises(P.ParquetError, match=f"{codec}.*snappy or None"):
        P.write_parquet(path, {"x": np.arange(3.0)}, compression=codec)
    assert not os.path.exists(path)


def test_unsupported_encoding_raises_by_name(tmp_path):
    path = str(tmp_path / "delta.parquet")
    pq.write_table(pa.table({"x": pa.array([1, 2, 3], pa.int64())}), path,
                   use_dictionary=False,
                   column_encoding={"x": "DELTA_BINARY_PACKED"})
    with pytest.raises(P.ParquetError, match="DELTA_BINARY_PACKED"):
        P.read_parquet(path)


# ---------------------------------------------------------------------------
# The runner (tests/test_runner_testkit.py's Parquet cases)
# ---------------------------------------------------------------------------

def _runner_pair(**kw):
    from test_torch_runner import _runners
    return _runners(**kw)


def _same_scores(ppath, jpath, pred_name):
    got, want = pd.read_parquet(ppath), pd.read_parquet(jpath)
    assert list(got.columns) == list(want.columns)
    assert got.index.equals(want.index)
    for c in want.columns:
        if c == pred_name:
            g = pd.DataFrame(list(got[c])).to_numpy()
            w = pd.DataFrame(list(want[c])).to_numpy()
            np.testing.assert_allclose(g, w, rtol=0, atol=PROB_ATOL)
        else:
            pd.testing.assert_series_equal(got[c], want[c])


def test_runner_score_writes_parquet_as_jax(tmp_path):
    jr, pr, jpred, _ = _runner_pair()
    for name, mod, runner in (("jax", jrun, jr), ("port", prun, pr)):
        d = tmp_path / name
        runner.run("train", mod.OpParams(model_location=str(d / "model")))
        runner.run("score", mod.OpParams(
            model_location=str(d / "model"),
            write_location=str(d / "scores.parquet")))
    _same_scores(str(tmp_path / "port" / "scores.parquet"),
                 str(tmp_path / "jax" / "scores.parquet"), jpred.name)
    written = pd.read_parquet(str(tmp_path / "port" / "scores.parquet"))
    assert written[jpred.name][0]["prediction"] in (0.0, 1.0)


def test_runner_streaming_score_writes_parquet_as_jax(tmp_path):
    from test_torch_runner import _data
    data = _data()
    batches = [{k: v[:100] for k, v in data.items()},
               {k: v[100:150] for k, v in data.items()}]
    jr, pr, jpred, _ = _runner_pair(streaming_score_reader=(
        JReaders.Streaming.batches([pd.DataFrame(b) for b in batches],
                                   key_field="id"),
        PReaders.Streaming.batches(batches, key_field="id")))
    for name, mod, runner in (("jax", jrun, jr), ("port", prun, pr)):
        res = runner.run("streamingScore", mod.OpParams(
            write_location=str(tmp_path / name / "stream.parquet")))
        assert res.score_batches == 2
    _same_scores(str(tmp_path / "port" / "stream.parquet"),
                 str(tmp_path / "jax" / "stream.parquet"), jpred.name)
    assert len(pd.read_parquet(str(tmp_path / "port" /
                                   "stream.parquet"))) == 150


def test_runner_features_run_and_app_write_parquet_as_jax(tmp_path):
    jr, pr, _, _ = _runner_pair()
    for name, mod, runner in (("jax", jrun, jr), ("port", prun, pr)):
        (tmp_path / name).mkdir()
        res = mod.OpApp(runner).main([
            "--run-type", "features",
            "--write-location", str(tmp_path / name / "raw.parquet")])
        assert res.scores is not None
    got = pd.read_parquet(str(tmp_path / "port" / "raw.parquet"))
    want = pd.read_parquet(str(tmp_path / "jax" / "raw.parquet"))
    pd.testing.assert_frame_equal(got, want)
    assert {"x1", "x2", "y"} <= set(got.columns)


def test_leads_features_run_writes_the_fixture(tmp_path):
    """The port's features run of the leads workflow on the fixture's 512
    records reads back as the JAX package's (struct maps, lists, dates)."""
    from transmogrifai_tpu_torch.testing import leads_workflow
    recs = leads_records(LEADS_PARQUET_ROWS, LEADS_SCORE_SEED)
    wf, _, _, _ = leads_workflow(recs, device="cpu", clock_ms=LEADS_CLOCK_MS)
    path = str(tmp_path / "leads.parquet")
    prun.OpWorkflowRunner(wf, train_reader=wf.reader).run(
        "features", prun.OpParams(write_location=path))
    pd.testing.assert_frame_equal(
        pd.read_parquet(path),
        pd.read_parquet(os.path.join(FIXTURE, "leads_features.parquet")))


# ---------------------------------------------------------------------------
# The committed fixture
# ---------------------------------------------------------------------------

FILES = ("titanic_score", "titanic_scores", "leads_features")
#: files whose values ``pd.read_parquet`` gave are kept whole (npz)
VALUES_KEPT = ("leads_features",)


@pytest.mark.parametrize("name", FILES)
def test_fixture_reads_as_pandas_did(name):
    path = os.path.join(FIXTURE, f"{name}.parquet")
    with open(os.path.join(FIXTURE, "fixture.json")) as fh:
        fx = json.load(fh)["files"][name]
    assert _sha(path) == fx["sha256"]
    got, now = P.read_parquet(path), _pandas_columns(path)
    assert columns_digest(now) == fx["columns"]
    assert columns_digest(got) == fx["columns"]
    assert column_gaps(got, now) == []
    if name in VALUES_KEPT:
        want = load_columns(os.path.join(FIXTURE, f"{name}.npz"))
        assert column_gaps(got, want) == []


def test_fixture_titanic_table_equals_the_csv_table(tmp_path):
    """The committed scoring file's raw Titanic table is the CSV reader's
    table of the rebuilt scoring file, bit for bit."""
    from transmogrifai_tpu_torch.examples.titanic import (
        TITANIC_SCHEMA, build_workflow,
    )
    csv_path = str(tmp_path / "score.csv")
    with open(os.path.join(FIXTURE, "fixture.json")) as fh:
        fx = json.load(fh)
    assert titanic_csv(csv_path, TITANIC_SCORE_ROWS,
                       TITANIC_SCORE_SEED) == fx["titanic_score_csv_sha256"]
    port_reset()
    wf, _, _ = build_workflow(csv_path, device="cpu")
    raw = wf.raw_features
    csv_table = PReaders.Simple.csv(
        csv_path, schema=TITANIC_SCHEMA, header=False,
        key_field="PassengerId").generate_table(raw)
    pq_table = PReaders.Simple.parquet(
        os.path.join(FIXTURE, "titanic_score.parquet"),
        key_field="PassengerId").generate_table(raw)
    names = [f.name for f in raw]
    assert table_digest(pq_table, names) == table_digest(csv_table, names)
    assert [pq_table[n].feature_type for n in names] == \
        [csv_table[n].feature_type for n in names]


def test_fixture_stays_small():
    total = sum(os.path.getsize(os.path.join(FIXTURE, f))
                for f in os.listdir(FIXTURE))
    assert total < 600 * 1024, total


# ---------------------------------------------------------------------------
# Writing the committed fixture (JAX package, CPU)
# ---------------------------------------------------------------------------

def _sha(path):
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def generate_fixture(out_dir: str = FIXTURE) -> None:
    """``titanic_score.parquet`` (the 4,096-row Titanic scoring file as
    ``pd.read_csv(...).to_parquet`` writes it), ``titanic_scores.parquet``
    (the key and prediction columns of the JAX package's ``score`` run of
    ``fixtures/titanic/model`` on it: the run's whole output, with the
    vectors, is 777 KB), ``leads_features.parquet`` (the JAX package's
    ``features`` run of the leads workflow on 512 scoring records), each
    and ``fixture.json``: each file's sha256, rows and per-column digests
    of what ``pd.read_parquet`` gives (``testing.columns_digest``); the
    leads file's values too (``leads_features.npz``,
    ``testing.save_columns``)."""
    import shutil
    import tempfile
    from transmogrifai_tpu.examples.titanic import (
        TITANIC_SCHEMA, build_workflow,
    )
    from test_torch_leads_e2e import jax_leads_workflow

    os.makedirs(out_dir, exist_ok=True)
    tmp = tempfile.mkdtemp()
    try:
        csv_path = os.path.join(tmp, "score.csv")
        csv_sha = titanic_csv(csv_path, TITANIC_SCORE_ROWS,
                              TITANIC_SCORE_SEED)
        score_pq = os.path.join(out_dir, "titanic_score.parquet")
        pd.read_csv(csv_path, header=None,
                    names=TITANIC_SCHEMA).to_parquet(score_pq)
        jax_reset()
        wf, _, pred = build_workflow(csv_path)
        runner = jrun.OpWorkflowRunner(
            wf, score_reader=JReaders.Simple.parquet(
                score_pq, key_field="PassengerId"))
        whole = os.path.join(tmp, "scores.parquet")
        runner.run("score", jrun.OpParams(
            model_location=os.path.join(REPO, "transmogrifai_tpu_torch",
                                        "fixtures", "titanic", "model"),
            write_location=whole))
        scores = pd.read_parquet(whole)[["key", pred.name]]
        scores.to_parquet(os.path.join(out_dir, "titanic_scores.parquet"))
        recs = leads_records(LEADS_PARQUET_ROWS, LEADS_SCORE_SEED)
        lwf, _, _, _ = jax_leads_workflow(recs)
        jrun.OpWorkflowRunner(lwf, train_reader=lwf.reader).run(
            "features", jrun.OpParams(write_location=os.path.join(
                out_dir, "leads_features.parquet")))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    fx = {"titanic_score_csv_sha256": csv_sha,
          "prediction": pred.name,
          "leads_rows": LEADS_PARQUET_ROWS,
          "pandas": pd.__version__, "pyarrow": pa.__version__,
          "files": {}}
    for name in FILES:
        path = os.path.join(out_dir, f"{name}.parquet")
        cols = _pandas_columns(path)
        if name in VALUES_KEPT:
            save_columns(os.path.join(out_dir, f"{name}.npz"), cols)
        fx["files"][name] = {"sha256": _sha(path),
                             "rows": pq.read_metadata(path).num_rows,
                             "columns": columns_digest(cols)}
    with open(os.path.join(out_dir, "fixture.json"), "w") as fh:
        json.dump(fx, fh, indent=1)
    total = sum(os.path.getsize(os.path.join(out_dir, f))
                for f in os.listdir(out_dir))
    print(f"wrote {out_dir} ({total} bytes)")


if __name__ == "__main__":
    generate_fixture()
