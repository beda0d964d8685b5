"""The port's typed features, table, reader and lambda transformers
against the JAX package on the CPU.

The reader is held to the JAX package's ``CSVReader`` (pandas
``read_csv``) and ``dataframe_to_table`` on a small CSV that holds every
case pandas types by itself: an int column, an int column with blanks,
floats, strings, strings with blanks and NA strings, numeric-looking
strings, quoted commas and quotes, booleans. Tolerance: none; columns,
masks, keys and records are equal, types and NaN included. A subprocess
reads that CSV and runs the Titanic workflow through the port alone: it
must load neither ``jax``, ``pandas`` nor ``transmogrifai_tpu``.
"""
from __future__ import annotations

import math
import os
import subprocess
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pandas as pd
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from transmogrifai_tpu import types as JT  # noqa: E402
from transmogrifai_tpu.features import (  # noqa: E402
    FeatureBuilder as JFB, reset_uids as jax_reset,
)
from transmogrifai_tpu.readers import DataReaders as JDR  # noqa: E402
from transmogrifai_tpu.readers.readers import (  # noqa: E402
    dataframe_to_table,
)
from transmogrifai_tpu.stages import base as JB  # noqa: E402
from transmogrifai_tpu.table import (  # noqa: E402
    Column as JColumn, FeatureTable as JTable,
    column_of_scalars as jax_column_of_scalars,
)

from transmogrifai_tpu_torch import types as PT  # noqa: E402
from transmogrifai_tpu_torch.features import (  # noqa: E402
    FeatureBuilder as PFB, reset_uids as port_reset,
)
from transmogrifai_tpu_torch.readers import (  # noqa: E402
    DataReaders as PDR, Frame, read_csv,
)
from transmogrifai_tpu_torch.stages import base as PB  # noqa: E402
from transmogrifai_tpu_torch.table import (  # noqa: E402
    Column as PColumn, FeatureTable as PTable, column_of_scalars,
)

#: the ported types and their column kinds
PORTED = {"Real": "real", "RealNN": "real", "Currency": "real",
          "Percent": "real", "Integral": "integral", "Binary": "binary",
          "Text": "text", "TextArea": "text", "Base64": "text",
          "URL": "text", "Email": "text", "PickList": "text",
          "ComboBox": "text", "ID": "text", "Country": "text",
          "State": "text", "City": "text", "PostalCode": "text",
          "Street": "text", "Phone": "text", "MultiPickList": "multipicklist",
          "TextList": "text_list", "OPVector": "vector",
          "Prediction": "prediction", "Date": "date", "DateTime": "date",
          "DateList": "date_list", "DateTimeList": "date_list",
          "Geolocation": "geolocation",
          **{name: "map" for name in (
              "TextMap", "EmailMap", "Base64Map", "PhoneMap", "IDMap",
              "URLMap", "TextAreaMap", "PickListMap", "ComboBoxMap",
              "CountryMap", "StateMap", "CityMap", "PostalCodeMap",
              "StreetMap", "GeolocationMap", "BinaryMap", "IntegralMap",
              "RealMap", "CurrencyMap", "PercentMap", "DateMap",
              "DateTimeMap", "MultiPickListMap")}}

TRAP_CSV = (
    "id,n,nb,x,s,sb,num,quoted,flag,cat\n"
    "1,3,1,0.5,male,C85,113803,\"Braund, Mr. Owen Harris\",True,A/5 21\n"
    "2,1,,1e3,female,,113804,\"O'Brien, Mrs. \"\"Kate\"\"\",False,PC 17\n"
    "3, 2,3,-2,NA,C123,0042,Heikkinen,True,113803\n"
    "\n"
    "4,5,2,inf,male,nan,7,\"a,b,,c\",False,\n"
)


@pytest.fixture(autouse=True)
def _same_uids():
    jax_reset()
    port_reset()


@pytest.fixture()
def trap_csv(tmp_path):
    path = tmp_path / "trap.csv"
    path.write_text(TRAP_CSV)
    return str(path)


def _same_cell(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) \
            and math.isnan(a) and math.isnan(b):
        return True
    return type(a) is type(b) and a == b


def _assert_same_column(jc, pc):
    a = np.asarray(jc.values)
    b = pc.host_values()
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    if a.dtype == object:
        assert [_same_cell(x, y) for x, y in zip(a, b)] == [True] * len(a)
    else:
        np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(pc.valid_mask(), jc.valid_mask())


# -- types and builders -----------------------------------------------------

def test_ported_types_keep_their_kinds_and_resolve_by_name():
    assert sorted(PT.FEATURE_TYPES) == sorted(PORTED)
    for name, kind in PORTED.items():
        pt = PT.feature_type_by_name(name)
        assert pt.__name__ == name
        assert pt.column_kind == JT.FEATURE_TYPES[name].column_kind == kind
        if name not in ("OPVector", "Prediction"):   # never empty
            assert pt.is_nullable == JT.FEATURE_TYPES[name].is_nullable
    assert sorted(PT.FEATURE_TYPES) == sorted(JT.FEATURE_TYPES)
    for name in ("NoSuchType", "OPMap", "OPList"):
        with pytest.raises(ValueError, match=name):
            PT.feature_type_by_name(name)


@pytest.mark.parametrize("name,values", [
    ("Integral", [3, 2.0, True, None, float("nan")]),
    ("Binary", [True, 0, 2.5, None, float("nan")]),
    ("Real", [1, 2.5, False, None, float("nan")]),
    ("Text", ["a", "", None]),
    ("PickList", ["x", None]),
    ("MultiPickList", [{"a"}, ["b", "b"], None, set()]),
])
def test_value_conversions_match(name, values):
    for v in values:
        jv, pv = JT.FEATURE_TYPES[name](v), PT.FEATURE_TYPES[name](v)
        assert pv.value == jv.value or (pv.value is None and jv.value is None)
        assert pv.is_empty == jv.is_empty
    for bad in ({"Integral": 2.5, "Binary": "yes", "Real": "x",
                 "Text": 3, "PickList": 4.0}.get(name),):
        if bad is not None:
            with pytest.raises(TypeError):
                JT.FEATURE_TYPES[name](bad)
            with pytest.raises(TypeError):
                PT.FEATURE_TYPES[name](bad)


def test_feature_builders_for_every_ported_type():
    for name in PORTED:
        jf = getattr(JFB, name)(f"f_{name}").extract_field().as_predictor()
        pf = getattr(PFB, name)(f"f_{name}").extract_field().as_predictor()
        assert (pf.name, pf.type_name, pf.uid) == (jf.name, jf.type_name,
                                                   jf.uid)
        ext = pf.origin_stage.extract_fn
        assert ext.__name__ == f"extract_f_{name}"
        assert ext({f"f_{name}": 7}) == 7
    a = PFB.Integral("a").extract_field().as_predictor()
    b = PFB.Integral("b").extract_field().as_predictor()
    s = a.transform_with(PB.BinaryTransformer("sum", lambda x, y: x + y,
                                              PT.Real), b)
    assert s.parents == (a, b) and s.type_name == "Real"


# -- the table --------------------------------------------------------------

@pytest.mark.parametrize("name,values", [
    ("Real", [1.0, None, float("nan"), 2.5, 1e39]),
    ("Binary", [True, False, None, 3.0]),
    ("Integral", [1, None, 2 ** 40, -3]),
    ("Text", ["a", None, "", float("nan")]),
    ("PickList", ["3", "nan", None]),
    ("MultiPickList", [{"a", "b"}, set(), None]),
    ("TextList", [["x"], [], None]),
])
def test_column_of_values_matches(name, values):
    _assert_same_column(JColumn.of_values(JT.FEATURE_TYPES[name], values),
                        PColumn.of_values(PT.FEATURE_TYPES[name], values))


@pytest.mark.parametrize("name", ["Real", "Binary", "Integral"])
def test_column_of_scalars_matches(name):
    raw = [1.5, np.nan, -2.7, 0.0, 3.0]
    _assert_same_column(jax_column_of_scalars(JT.FEATURE_TYPES[name], raw),
                        column_of_scalars(PT.FEATURE_TYPES[name], raw))
    with pytest.raises(TypeError):
        column_of_scalars(PT.FEATURE_TYPES[name], ["x", 1.0])


def test_table_key_take_and_device_kinds():
    cols = {"r": PColumn.of_values(PT.Real, [1.0, None, 3.0]),
            "b": PColumn.of_values(PT.Binary, [True, None, False]),
            "i": PColumn.of_values(PT.Integral, [1, 2, None]),
            "t": PColumn.of_values(PT.Text, ["a", None, "c"])}
    t = PTable(cols, 3, key=np.array(["x", "y", "z"], dtype=object))
    d = t.to_device("cpu")
    assert d.device == torch.device("cpu") and list(d.key) == ["x", "y", "z"]
    for name in ("r", "b"):       # moved, as real columns are
        assert isinstance(d[name].values, torch.Tensor)
        assert isinstance(d[name].mask, torch.Tensor)
        np.testing.assert_array_equal(d[name].host_values(),
                                      cols[name].values)
    for name in ("i", "t"):       # stay on the host
        assert d[name].values is cols[name].values
    sub = d.take([2, 0])
    assert list(sub.key) == ["z", "x"] and sub.device == d.device
    assert sub["t"].host_values().tolist() == ["c", "a"]
    assert d.with_column("r2", d["r"]).key is d.key


# -- the reader -------------------------------------------------------------

def test_read_csv_types_columns_as_pandas(trap_csv):
    df = pd.read_csv(trap_csv)
    fr = read_csv(trap_csv)
    assert list(fr.columns) == list(df.columns)
    for c in df.columns:
        want = df[c].to_numpy(dtype=object if df[c].dtype == "str"
                              else None)
        got = fr[c]
        assert got.dtype == want.dtype or (got.dtype == object and str(
            df[c].dtype) == "str"), (c, got.dtype, want.dtype)
        assert [_same_cell(x, y) for x, y in zip(got.tolist(),
                                                 want.tolist())] \
            == [True] * len(want), c
    recs, want = fr.records(), df.to_dict("records")
    assert len(recs) == len(want)
    for r, w in zip(recs, want):
        assert list(r) == list(w)
        assert all(_same_cell(r[k], w[k]) for k in w), (r, w)


def test_read_csv_with_a_schema_and_no_header(trap_csv, tmp_path):
    body = TRAP_CSV.split("\n", 1)[1]
    path = tmp_path / "noheader.csv"
    path.write_text(body)
    names = TRAP_CSV.split("\n", 1)[0].split(",")
    df = pd.read_csv(str(path), header=None, names=names)
    fr = read_csv(str(path), schema=names, header=False)
    for c in names:
        assert [_same_cell(x, y) for x, y in zip(
            fr[c].tolist(), df[c].tolist())] == [True] * len(df), c


#: (feature type, column): every column through numeric and text types
READ_AS = [(t, c) for c in ("id", "n", "nb", "x", "s", "sb", "num",
                            "quoted", "flag", "cat")
           for t in ("Real", "Integral", "Binary", "Text", "PickList")]


def test_csv_to_table_matches_the_jax_reader(trap_csv):
    jf = [getattr(JFB, t)(f"{c}_{t}").extract(None) for t, c in READ_AS]
    jfeats, pfeats = [], []
    for t, c in READ_AS:
        jb = getattr(JFB, t)(f"{c}_{t}")
        pb = getattr(PFB, t)(f"{c}_{t}")
        # a field extractor of column c under another feature name
        jb._extract_fn = _field(c, "jax")
        pb._extract_fn = _field(c, "port")
        jfeats.append(jb.as_predictor())
        pfeats.append(pb.as_predictor())
    # custom extract functions see records: str() of an int column, of a
    # float column with a blank (a NaN, not None)
    for c in ("n", "nb", "sb"):
        jfeats.append(JFB.PickList(f"{c}_str").extract(
            lambda r, c=c: None if r.get(c) is None else str(r.get(c))
        ).as_predictor())
        pfeats.append(PFB.PickList(f"{c}_str").extract(
            lambda r, c=c: None if r.get(c) is None else str(r.get(c))
        ).as_predictor())
    del jf
    jt = JDR.Simple.csv(trap_csv, key_field="id").generate_table(jfeats)
    pt = PDR.Simple.csv(trap_csv, key_field="id").generate_table(pfeats)
    assert pt.num_rows == jt.num_rows == 4
    assert sorted(pt.column_names) == sorted(jt.column_names)
    for name in jt.column_names:
        _assert_same_column(jt[name], pt[name])
    assert list(pt.key) == list(jt.key)
    assert pt["nb_str"].host_values().tolist() == ["1.0", "nan", "3.0",
                                                   "2.0"]
    assert pt["s_Text"].valid_mask().tolist() == [True, True, False, True]
    assert not pt["num_Text"].valid_mask().any()   # parsed as numbers


class _field:
    """A field extractor (``extract_<field>``) of either package."""

    def __init__(self, field, _):
        self.field = field
        self.__name__ = f"extract_{field}"

    def __call__(self, r):
        return r.get(self.field)


#: inputs on which the port's reader once gave another table than pandas
#: through the JAX reader: {case: (CSV text, schema or None for a header)}
READER_FAULTS = {
    "bom_with_header": ("﻿age,name\n22,Bob\n38,Ann\n", None),
    "bom_with_schema": ("﻿22,Bob\n38,Ann\n", ["age", "name"]),
    "lines_of_blanks": ("age,name\n22,Bob\n  \n38,Ann\n \t \n", None),
    "duplicate_names": ("age,age,name,age.1,age\n22,1,Bob,5,7\n"
                        "38,2,Ann,6,8\n", None),
    "implicit_index": ("age,name\n22,Bob,\n38,Ann,\n", None),
    "implicit_index_schema": ("22,Bob,\n38,Ann\n", ["age", "name"]),
    "unicode_digits": ("age,name,x\n٢٢,Bob,1.5\n38,Ann,"
                       "٢.5\n", None),
    "int64_overflow": ("big,neg,huge,mixed,name\n"
                       "18446744073709551615,-9223372036854775809,"
                       "18446744073709551616,18446744073709551615,Bob\n"
                       "38,38,-38,-1,Ann\n", None),
    "uint64_with_a_blank": ("big,name\n18446744073709551615,Bob\n,Ann\n",
                            None),
}


def _read_both(text, schema, tmp_path):
    path = tmp_path / "fault.csv"
    path.write_bytes(text.encode("utf-8"))
    if schema is None:
        return str(path), pd.read_csv(str(path)), read_csv(str(path))
    return (str(path), pd.read_csv(str(path), header=None, names=schema),
            read_csv(str(path), schema=schema, header=False))


@pytest.mark.parametrize("case", sorted(READER_FAULTS))
def test_reader_faults_give_the_jax_readers_table(case, tmp_path):
    """Each input of a repaired reader fault: the frame is pandas' (names,
    dtypes, cells, records) and the table of every column read as each
    numeric and text type, and as a custom ``str`` extract function, is
    the JAX reader's."""
    text, schema = READER_FAULTS[case]
    path, df, fr = _read_both(text, schema, tmp_path)
    assert list(fr.columns) == list(df.columns)
    for c in df.columns:
        want = df[c].to_numpy(dtype=object if str(df[c].dtype) == "str"
                              else None)
        assert fr[c].dtype == want.dtype, (c, fr[c].dtype, want.dtype)
        assert [_same_cell(x, y) for x, y in zip(fr[c].tolist(),
                                                 want.tolist())] \
            == [True] * len(want), (c, fr[c].tolist(), want.tolist())
    assert [[_same_cell(r[k], w[k]) for k in w] for r, w in zip(
        fr.records(), df.to_dict("records"))] == [
            [True] * len(df.columns)] * len(df)
    jfeats, pfeats = [], []
    for c in df.columns:
        for t in ("Real", "Integral", "Text", "PickList"):
            jb, pb = (getattr(B, t)(f"{c}_{t}") for B in (JFB, PFB))
            jb._extract_fn = _field(c, "jax")
            pb._extract_fn = _field(c, "port")
            jfeats.append(jb.as_predictor())
            pfeats.append(pb.as_predictor())
        for B, feats in ((JFB, jfeats), (PFB, pfeats)):
            feats.append(B.PickList(f"{c}_str").extract(
                lambda r, c=c: None if r.get(c) is None else str(r.get(c))
            ).as_predictor())
    jt = JDR.Simple.csv(path, schema=schema, header=schema is None
                        ).generate_table(jfeats)
    pt = PDR.Simple.csv(path, schema=schema, header=schema is None
                        ).generate_table(pfeats)
    assert pt.num_rows == jt.num_rows == len(df)
    for name in jt.column_names:
        _assert_same_column(jt[name], pt[name])


@pytest.mark.parametrize("text,schema,line", [
    ("age,name\n22,Bob\n38,Ann,\n", None, 3),
    ("age,name\n22,Bob,\n38,Ann,x,y\n", None, 3),
    ("1,2\n3,4,5\n", ["a", "b"], 2),
])
def test_a_row_wider_than_the_first_raises_as_in_pandas(text, schema, line,
                                                        tmp_path):
    path = tmp_path / "wide.csv"
    path.write_text(text)
    kw = {} if schema is None else {"header": None, "names": schema}
    with pytest.raises(ValueError, match=f"Expected .* in line {line}"):
        pd.read_csv(str(path), **kw)
    with pytest.raises(ValueError, match=f"expected .* in line {line}"):
        read_csv(str(path), schema=schema, header=schema is None)


def test_an_all_none_column_stays_none_as_in_a_dataframe():
    """A column of only None keeps them (object), as a DataFrame does, so
    a custom extract function sees None; a record without the field is
    NaN there, as ``pd.DataFrame(records)`` makes it."""
    data = {"c": [None] * 3, "x": [1.0, 2.0, 3.0]}
    jf = JFB.PickList("c_str").extract(
        lambda r: None if r.get("c") is None else str(r.get("c"))
    ).as_predictor()
    pf = PFB.PickList("c_str").extract(
        lambda r: None if r.get("c") is None else str(r.get("c"))
    ).as_predictor()
    jt = JDR.Simple.dataframe(pd.DataFrame(data)).generate_table([jf])
    pt = PDR.Simple.dataframe(data).generate_table([pf])
    _assert_same_column(jt["c_str"], pt["c_str"])
    assert not pt["c_str"].valid_mask().any()
    for recs in ([{"c": None}, {"c": None}], [{"c": None}, {"x": 1}],
                 [{"c": None, "x": 1.0}, {"x": None}]):
        want = pd.DataFrame(recs).to_dict("records")
        got = Frame.of(recs).records()
        assert [[_same_cell(r[k], w[k]) or r[k] is w[k] is None for k in w]
                for r, w in zip(got, want)] == [[True] * len(want[0])] * 2


def test_column_mapping_and_records_match_a_dataframe():
    data = {"i": [1, 2, 3], "f": [1.0, None, 2.5], "s": ["a", None, "b"],
            "b": [True, False, True], "o": [True, None, False],
            "m": [1, 2.5, None]}
    df = pd.DataFrame(data)
    for fr in (Frame.of(data), Frame.of(df.to_dict("records"))):
        recs = fr.records()
        for r, w in zip(recs, df.to_dict("records")):
            assert all(_same_cell(r[k], w[k]) or (r[k] is None and w[k] is
                                                  None) for k in w), (r, w)
    feats_j = [JFB.Real("f").extract_field().as_predictor(),
               JFB.Integral("i").extract_field().as_predictor(),
               JFB.Text("s").extract_field().as_predictor(),
               JFB.Binary("b").extract_field().as_predictor()]
    feats_p = [PFB.Real("f").extract_field().as_predictor(),
               PFB.Integral("i").extract_field().as_predictor(),
               PFB.Text("s").extract_field().as_predictor(),
               PFB.Binary("b").extract_field().as_predictor()]
    jt = dataframe_to_table(df, feats_j)
    pt = PDR.Simple.dataframe(data).generate_table(feats_p)
    for name in jt.column_names:
        _assert_same_column(jt[name], pt[name])


def test_a_missing_field_raises():
    f = PFB.Real("absent").extract_field().as_predictor()
    with pytest.raises(ValueError, match="absent"):
        PDR.Simple.dataframe({"x": [1.0]}).generate_table([f])


def _run(code: str):
    return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=600)


def test_port_reads_and_trains_without_jax_or_pandas(trap_csv, tmp_path):
    """The reader and the Titanic workflow (train and score, one linear
    family pinned) in a process of its own: no jax, pandas or JAX
    package module is loaded."""
    csv_path = str(tmp_path / "titanic.csv")
    res = _run(
        "import sys\n"
        "from transmogrifai_tpu_torch.readers import read_csv\n"
        f"fr = read_csv({trap_csv!r})\n"
        "assert fr.records()[0]['quoted'] == 'Braund, Mr. Owen Harris'\n"
        "from transmogrifai_tpu_torch.testing import titanic_csv\n"
        "from transmogrifai_tpu_torch.examples.titanic import "
        "build_workflow\n"
        f"titanic_csv({csv_path!r}, 300, 5)\n"
        f"wf, _, pred = build_workflow({csv_path!r}, device='cpu',\n"
        "    models=[('OpLogisticRegression', [{'regParam': 0.1}])])\n"
        "model = wf.train()\n"
        "out = model.score()\n"
        "assert out[pred.name].values.shape[0] == 300\n"
        "assert list(out.key[:2]) == ['1', '2']\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'pandas', 'transmogrifai_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    assert res.returncode == 0, res.stdout + res.stderr


# -- lambda transformers ----------------------------------------------------

def _lambda_tables(masked: bool):
    rng = np.random.RandomState(0)
    i = rng.randint(0, 5, 50).astype(np.int64)
    r = (rng.lognormal(2.0, 1.0, 50)).astype(np.float32)
    mi = rng.rand(50) > 0.2 if masked else np.ones(50, bool)
    mr = rng.rand(50) > 0.2 if masked else np.ones(50, bool)
    data = {"i": (JT.Integral, PT.Integral, np.where(mi, i, 0), mi),
            "r": (JT.Real, PT.Real, np.where(mr, r, 0).astype(np.float32),
                  mr)}
    jt = JTable({k: JColumn(j, v, m) for k, (j, _, v, m) in data.items()},
                50)
    pt = PTable({k: PColumn(p, v, m) for k, (_, p, v, m) in data.items()},
                50).to_device("cpu")
    return jt, pt


LAMBDAS = [
    # Titanic's familySize and estCost: ``or`` refuses arrays -> row map
    ("binary", lambda s, p: (s or 0) + (p or 0) + 1, "Real"),
    ("binary", lambda f, v: (f or 0) * (v or 0.0), "Real"),
    # ufunc-friendly: the whole-column route when nothing is missing
    ("binary", lambda a, b: None if a is None or b is None
     else a * b + 1.5, "Real"),
    ("binary", lambda a, b: None if a is None or b is None
     else np.sqrt(a) / (b + 1), "Real"),
    ("binary", lambda a, b: None if a is None else a > 2, "Binary"),
    ("unary", lambda a: None if a is None else a * 3, "Integral"),
    ("sequence", lambda vs: sum(v or 0 for v in vs), "Real"),
    ("binseq", lambda vs: (vs[0] or 0) - (vs[1] or 0), "Real"),
]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", range(len(LAMBDAS)))
def test_lambda_transformers_match(case, masked):
    kind, fn, out = LAMBDAS[case]
    jt, pt = _lambda_tables(masked)
    ji = [JFB.Integral("i").extract_field().as_predictor(),
          JFB.Real("r").extract_field().as_predictor()]
    pi = [PFB.Integral("i").extract_field().as_predictor(),
          PFB.Real("r").extract_field().as_predictor()]
    stages = []
    for B, T, feats in ((JB, JT, ji), (PB, PT, pi)):
        ot = getattr(T, out)
        st = {"binary": lambda: B.BinaryTransformer("op", fn, ot),
              "unary": lambda: B.UnaryTransformer("op", fn, ot),
              "sequence": lambda: B.SequenceTransformer("op", fn, ot),
              "binseq": lambda: B.BinarySequenceTransformer("op", fn, ot)
              }[kind]()
        st.set_input(*(feats[:1] if kind == "unary" else feats))
        stages.append(st)
    jc = stages[0].transform_column(jt)
    pc = stages[1].transform_column(pt)
    if pc.kind in ("real", "binary"):
        assert isinstance(pc.values, torch.Tensor)    # back on the device
    _assert_same_column(jc, pc.to_host())
    for row in ({"i": 2, "r": 1.25}, {"i": None, "r": 3.5},
                {"i": 4, "r": None}):
        assert stages[1].transform_row(row) == stages[0].transform_row(row)


def test_est_cost_rounds_the_same_either_route():
    """``familySize * Fare`` in float64 on float32 fares, rounded once:
    the whole-column route and the row map give the same float32."""
    rng = np.random.RandomState(1)
    fam = rng.randint(1, 11, 1000).astype(np.int64)
    fare = rng.lognormal(2.5, 1.2, 1000).astype(np.float32)
    cols = [PColumn(PT.Integral, fam), PColumn(PT.Real, fare)]
    fast = PB._vectorized_value_transform(lambda f, v: f * v, PT.Real, cols)
    assert fast is not None
    slow = PColumn.of_values(PT.Real, [f * v for f, v in
                                       PB._iter_cell_values(cols)])
    np.testing.assert_array_equal(fast.values, slow.values)
    assert fast.values.dtype == np.float32
