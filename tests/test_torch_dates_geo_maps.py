"""The port's date, geolocation and map stages, ``transmogrify``'s groups of
every feature type, the new types and the DSL methods against the JAX
package on the CPU.

Inputs are ``tests/test_feature_stages.py``'s, ``tests/test_types.py``'s
and ``tests/test_dsl.py::test_date_dsl``'s, and seeded tables of a few
hundred rows. Tolerance: none. Every block is bit-equal and every
``VectorMetadata`` equal: the same numpy calls on the same values (sine
and cosine in float64 then float32, midpoints and means in float64, "days
since" a python integer difference over the day's milliseconds).
"""
from __future__ import annotations

import dataclasses
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pandas as pd
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import transmogrifai_tpu.dsl  # noqa: E402,F401  (attaches the JAX DSL)
from transmogrifai_tpu import types as JT  # noqa: E402
from transmogrifai_tpu.features import (  # noqa: E402
    FeatureBuilder as JFB, reset_uids as jax_reset,
)
from transmogrifai_tpu.impl.feature import (  # noqa: E402
    dates as JD, geo as JG, maps as JM, math as JMath,
    transmogrifier as JTr,
)
from transmogrifai_tpu.readers.readers import (  # noqa: E402
    series_to_column as jax_series_to_column,
)
from transmogrifai_tpu.table import (  # noqa: E402
    Column as JColumn, FeatureTable as JTable,
)

import transmogrifai_tpu_torch  # noqa: E402,F401  (attaches the port's DSL)
from transmogrifai_tpu_torch import types as PT  # noqa: E402
from transmogrifai_tpu_torch.features import (  # noqa: E402
    FeatureBuilder as PFB, reset_uids as port_reset,
)
from transmogrifai_tpu_torch.impl.feature import (  # noqa: E402
    dates as PD, geo as PG, maps as PM, math as PMath,
    transmogrifier as PTr,
)
from transmogrifai_tpu_torch.readers.readers import (  # noqa: E402
    Frame, series_to_column as port_series_to_column,
)
from transmogrifai_tpu_torch.table import (  # noqa: E402
    Column as PColumn, FeatureTable as PTable,
)
from transmogrifai_tpu_torch.testing import leads_records  # noqa: E402

MS_DAY = 86_400_000
NOON = 12 * 3_600_000
MON, TUE = 1592179200000, 1592265600000        # 2020-06-15 and -16


def host(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def meta_json(col):
    vm = col.metadata.get("vector_meta")
    return None if vm is None else {
        "name": vm.name, "columns": [dataclasses.asdict(c)
                                     for c in vm.columns]}


def run_both(mod, cls, kw, type_name, rows, fit=True, name="f"):
    """(JAX output column, port output column) of the stage ``cls`` of the
    modules ``mod`` (JAX, port) built with ``kw`` on a column ``name`` of
    ``type_name`` holding ``rows``: fitted first when ``fit``. Both DAGs
    are built after ``reset_uids``, so output names agree."""
    out = []
    for m, FB, reset, table in ((mod[0], JFB, jax_reset, JTable),
                                (mod[1], PFB, port_reset, PTable)):
        reset()
        ft = (JT if m is mod[0] else PT).FEATURE_TYPES[type_name]
        f = FB(name, ft).extract_field().as_predictor()
        col = (JColumn if m is mod[0] else PColumn).of_values(ft, rows)
        t = table({name: col}, len(rows))
        stage = getattr(m, cls)(**kw).set_input(f)
        if fit:
            stage = stage.fit(t)
        out.append(stage.transform_column(t))
    return out


def assert_same(jc, pc):
    np.testing.assert_array_equal(host(pc.values), host(jc.values))
    assert host(pc.values).dtype == host(jc.values).dtype
    assert meta_json(pc) == meta_json(jc)
    if jc.mask is None:
        assert pc.mask is None
    else:
        np.testing.assert_array_equal(host(pc.mask), host(jc.mask))


def _seeded_dates(n, seed, null=0.1):
    rng = np.random.RandomState(seed)
    ms = rng.randint(0, 2 * 10 ** 12, n, dtype=np.int64)
    return [None if rng.rand() < null else int(v) for v in ms]


def _seeded_lists(n, seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        k = rng.randint(0, 6)
        out.append(None if rng.rand() < 0.1 else
                   [int(v) for v in rng.randint(0, 2 * 10 ** 12, k,
                                                dtype=np.int64)])
    return out


def _seeded_maps(n, seed, value):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        if rng.rand() < 0.1:
            out.append(None)
            continue
        out.append({k: value(rng) for k in ("a", "b", "c", "d")
                    if rng.rand() < 0.7})
    return out


def _text_value(rng):
    return ["x", "y", "z", "w"][rng.randint(4)] if rng.rand() < 0.8 else \
        f"v{rng.randint(60)}"


def _geo_value(rng):
    return [float(rng.uniform(-80, 80)), float(rng.uniform(-170, 170)),
            float(rng.randint(0, 9))]


def _words(rng):
    words = ["alpha", "beta", "gamma", "delta", "eps", "zeta", "eta"]
    return " ".join(words[i] for i in rng.randint(len(words),
                                                  size=rng.randint(1, 5)))


DATES = (JD, PD)
GEO = (JG, PG)
MAPS = (JM, PM)

#: (id, modules, class, kwargs, type, rows, fit)
CASES = [
    ("map_mean_fill", MAPS, "MapVectorizer", {}, "RealMap",
     [{"a": 1.0, "b": 10.0}, {"a": 3.0}, None], True),
    ("map_key_lists", MAPS, "MapVectorizer",
     {"black_list_keys": ["c"], "track_nulls": False}, "RealMap",
     [{"a": 1.0, "b": 2.0, "c": 3.0}] * 3, True),
    ("map_constant_fill_white", MAPS, "MapVectorizer",
     {"fill_with_mean": False, "fill_value": -1.0,
      "white_list_keys": ["a", "c"]}, "RealMap",
     _seeded_maps(200, 1, lambda r: float(r.randn())), True),
    ("map_integral", MAPS, "MapVectorizer", {}, "IntegralMap",
     _seeded_maps(200, 2, lambda r: int(r.poisson(3))), True),
    ("map_binary", MAPS, "MapVectorizer", {}, "BinaryMap",
     _seeded_maps(200, 3, lambda r: bool(r.rand() < 0.3)), True),
    ("map_currency_nan", MAPS, "MapVectorizer", {}, "CurrencyMap",
     _seeded_maps(200, 4, lambda r: float("nan") if r.rand() < 0.2
                  else float(r.lognormal(10, 1))), True),
    ("pivot_per_key", MAPS, "TextMapPivotVectorizer",
     {"min_support": 1, "top_k": 5}, "PickListMap",
     [{"color": "red", "size": "L"}, {"color": "red"}, {"color": "blue"},
      None] * 3, True),
    ("pivot_multipicklist", MAPS, "TextMapPivotVectorizer",
     {"min_support": 1, "top_k": 3}, "MultiPickListMap",
     [{"tags": ["a", "b"]}, {"tags": ["b"]}, None] * 4, True),
    ("pivot_defaults_other", MAPS, "TextMapPivotVectorizer", {},
     "PickListMap", _seeded_maps(300, 5, _text_value), True),
    ("pivot_lists", MAPS, "TextMapPivotVectorizer",
     {"white_list_keys": ["a", "b"], "track_nulls": False},
     "MultiPickListMap",
     _seeded_maps(300, 6, lambda r: sorted({_text_value(r)
                                           for _ in range(3)})), True),
    ("smart_pivot_and_hash", MAPS, "SmartTextMapVectorizer",
     {"num_hashes": 32}, "TextMap",
     [None if r is None else dict(r, d=_words(np.random.RandomState(i)))
      for i, r in enumerate(_seeded_maps(300, 7, _text_value))], True),
    ("smart_low_cardinality", MAPS, "SmartTextMapVectorizer",
     {"max_cardinality": 2, "min_support": 1, "num_hashes": 8},
     "TextAreaMap", _seeded_maps(100, 8, _text_value), True),
    ("map_nulls", MAPS, "TextMapNullEstimator", {}, "TextMap",
     [{"a": "x", "b": "y"}, {"a": ""}, None, {"b": "z"}], True),
    ("map_nulls_black", MAPS, "TextMapNullEstimator",
     {"black_list_keys": ["b"]}, "TextMap",
     _seeded_maps(100, 9, _text_value), True),
    ("unit_circle_noon", DATES, "DateToUnitCircleTransformer",
     {"periods": ("HourOfDay",)}, "Date", [NOON, None], False),
    ("unit_circle_all_periods", DATES, "DateToUnitCircleTransformer",
     {"periods": tuple(JD.TIME_PERIODS)}, "DateTime",
     _seeded_dates(300, 10), False),
    ("unit_circle_defaults", DATES, "DateToUnitCircleTransformer",
     {"periods": JD.DEFAULT_CIRCULAR_PERIODS}, "Date",
     _seeded_dates(300, 11), False),
    ("since_last", DATES, "DateListVectorizer",
     {"pivot": "SinceLast", "reference_date_ms": 100 * MS_DAY}, "DateList",
     [[10 * MS_DAY, 90 * MS_DAY], [], None], False),
    ("mode_day", DATES, "DateListVectorizer", {"pivot": "ModeDay"},
     "DateList", [[MON, MON + 3600_000, TUE]], False),
] + [
    (f"date_list_{pivot}", DATES, "DateListVectorizer",
     {"pivot": pivot, "reference_date_ms": 2 * 10 ** 12 + 12345,
      "track_nulls": pivot != "SinceFirst"}, "DateTimeList",
     _seeded_lists(300, 12), False)
    for pivot in JD.DATE_LIST_PIVOTS
] + [
    ("date_map_keys", DATES, "DateMapToUnitCircleVectorizer",
     {"period": "HourOfDay", "keys": ["k"]}, "DateMap",
     [{"k": NOON}, None], False),
    ("date_map_batch_keys", DATES, "DateMapToUnitCircleVectorizer",
     {"period": "DayOfYear"}, "DateTimeMap",
     _seeded_maps(300, 13, lambda r: int(r.randint(0, 2 * 10 ** 12,
                                                  dtype=np.int64))), False),
    ("date_map_empty", DATES, "DateMapToUnitCircleVectorizer", {},
     "DateMap", [None, {}], False),
    ("geo_fill", GEO, "GeolocationVectorizer", {}, "Geolocation",
     [[10.0, 20.0, 1.0], None], True),
    ("geo_seeded", GEO, "GeolocationVectorizer", {}, "Geolocation",
     [None if np.random.RandomState(i).rand() < 0.1 else
      _geo_value(np.random.RandomState(i)) for i in range(300)], True),
    ("geo_zero_fill", GEO, "GeolocationVectorizer",
     {"fill_with_mean": False, "track_nulls": False}, "Geolocation",
     [[1.5, 2.5], None, [3.0, 4.0, 7.0]], True),
    ("geo_antipodes", GEO, "GeolocationVectorizer", {}, "Geolocation",
     [[0.0, 0.0, 1.0], [0.0, 180.0, 3.0], None], True),
    ("geo_map", GEO, "GeolocationMapVectorizer", {}, "GeolocationMap",
     [{"home": [40.0, -75.0, 2.0]}, {}], True),
    ("geo_map_seeded", GEO, "GeolocationMapVectorizer", {},
     "GeolocationMap", _seeded_maps(300, 14, _geo_value), True),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_stage_matches_the_jax_package(case):
    _, mods, cls, kw, type_name, rows, fit = case
    jc, pc = run_both(mods, cls, kw, type_name, rows, fit)
    assert_same(jc, pc)


@pytest.mark.parametrize("period", sorted(JD.TIME_PERIODS))
def test_time_period_stages(period):
    dates = _seeded_dates(200, 20) + [MON, TUE, NOON]
    assert_same(*run_both(DATES, "TimePeriodTransformer",
                          {"period": period}, "Date", dates, fit=False))
    lists = _seeded_lists(200, 21)
    for width in (None, 2):
        jc, pc = run_both(DATES, "TimePeriodListTransformer",
                          {"period": period, "width": width}, "DateList",
                          lists, fit=False)
        assert_same(jc, pc)
    maps = _seeded_maps(100, 22, lambda r: int(r.randint(
        0, 2 * 10 ** 12, dtype=np.int64)))
    jc, pc = run_both(DATES, "TimePeriodMapTransformer", {"period": period},
                      "DateMap", maps, fit=False)
    assert list(pc.values) == list(jc.values)
    np.testing.assert_array_equal(host(pc.mask), host(jc.mask))


def test_time_period_list_width_locks_on_the_first_batch():
    """``tests/test_round3_fixes.py``'s case: the train batch's longest
    list fixes the width of every later batch."""
    for D, FB, T, C, reset in ((JD, JFB, JTable, JColumn, jax_reset),
                               (PD, PFB, PTable, PColumn, port_reset)):
        reset()
        types = JT if D is JD else PT
        f = FB.DateList("d").extract_field().as_predictor()
        t = D.TimePeriodListTransformer(period="DayOfWeek").set_input(f)
        train = T({"d": C.of_values(types.DateList, [
            [MS_DAY, 2 * MS_DAY, 3 * MS_DAY], [MS_DAY]])}, 2)
        score = T({"d": C.of_values(types.DateList, [[MS_DAY]])}, 1)
        assert host(t.transform_column(train).values).shape[1] == 3
        assert host(t.transform_column(score).values).shape[1] == 3


def test_helpers_bit_for_bit():
    ms = np.array(_seeded_dates(500, 30, null=0.0) + [1592179200000],
                  dtype=np.int64)
    for period in JD.TIME_PERIODS:
        a = JD.time_period_values(ms, period)
        b = PD.time_period_values(ms, period)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(JD.unit_circle(a, period),
                                      PD.unit_circle(b, period))
    assert PD.time_period_values(np.array([1592179200000]),
                                 "DayOfWeek")[0] == 1
    with pytest.raises(ValueError, match="unknown time period"):
        PD.time_period_values(ms, "Fortnight")
    rng = np.random.RandomState(31)
    for pts in (rng.uniform(-80, 80, (50, 2)),
                np.array([[0.0, 0.0], [0.0, 90.0]]),
                np.array([[0.0, 0.0], [0.0, 180.0]])):
        assert PG.geographic_midpoint(pts) == JG.geographic_midpoint(pts)


def test_date_map_key_space_is_taken_per_batch():
    """A scoring batch without one of the training keys gives a narrower
    vector, in both packages (the JAX package's behaviour, kept)."""
    train = [{"a": NOON, "b": MON}, {"a": TUE}]
    score = [{"a": NOON}]
    for rows in (train, score):
        jc, pc = run_both(DATES, "DateMapToUnitCircleVectorizer", {},
                          "DateMap", rows, fit=False)
        assert_same(jc, pc)
    assert host(pc.values).shape == (1, 2)


def test_row_path_matches_the_jax_package():
    rows = [{"a": 1.0, "b": 10.0}, {"a": 3.0}, None]
    for mods, cls, kw, tn, fit, row in (
            (MAPS, "MapVectorizer", {}, "RealMap", True, {"b": 4.0}),
            (MAPS, "TextMapNullEstimator", {}, "TextMap", True,
             {"b": "z"}),
            (GEO, "GeolocationVectorizer", {}, "Geolocation", True, None),
            (DATES, "DateToUnitCircleTransformer", {}, "Date", False,
             NOON),
            (DATES, "DateListVectorizer",
             {"reference_date_ms": 10 ** 12}, "DateList", False,
             [MON, TUE])):
        data = (rows if tn.endswith("Map") else
                [[1.0, 2.0, 3.0], None] if tn == "Geolocation" else
                [NOON, None] if tn == "Date" else [[MON], None])
        stages = []
        for m, FB, reset, table, C, types in (
                (mods[0], JFB, jax_reset, JTable, JColumn, JT),
                (mods[1], PFB, port_reset, PTable, PColumn, PT)):
            reset()
            ft = types.FEATURE_TYPES[tn]
            f = FB(tn.lower(), ft).extract_field().as_predictor()
            s = getattr(m, cls)(**kw).set_input(f)
            if fit:
                s = s.fit(table({f.name: C.of_values(ft, data)}, len(data)))
            stages.append((s, f.name))
        (js, name), (ps, _) = stages
        assert ps.transform_row({name: row}) == js.transform_row({name: row})


# ---------------------------------------------------------------------------
# Types, reader, transmogrify's groups, DSL
# ---------------------------------------------------------------------------

def test_every_jax_type_resolves_in_the_port():
    assert sorted(PT.FEATURE_TYPES) == sorted(JT.FEATURE_TYPES)
    assert len([n for n in PT.FEATURE_TYPES if n.endswith("Map")]) == 23
    for name, jt in JT.FEATURE_TYPES.items():
        pt = PT.feature_type_by_name(name)
        assert pt.column_kind == jt.column_kind, name
        je, pe = (getattr(t, "element_type", None) for t in (jt, pt))
        assert (je and je.__name__) == (pe and pe.__name__), name
    assert issubclass(PT.DateTime, PT.Date) and issubclass(PT.Date,
                                                           PT.Integral)


def test_new_types_convert_as_the_jax_package():
    """``tests/test_types.py``'s values."""
    assert PT.Date(1700000000000).value == 1700000000000
    g = PT.Geolocation([37.7, -122.4, 5.0])
    assert g.value == JT.Geolocation([37.7, -122.4, 5.0]).value
    for bad in ([100.0, 0.0, 1.0], [0.0, 200.0, 1.0], [1.0, 2.0]):
        with pytest.raises(ValueError):
            JT.Geolocation(bad)
        with pytest.raises(ValueError):
            PT.Geolocation(bad)
    assert PT.Geolocation(None).is_empty
    assert PT.DateList([1.0, 2]).value == JT.DateList([1.0, 2]).value
    m = PT.RealMap({"a": 1.0})
    assert m.value == {"a": 1.0} and m.element_type is PT.Real
    assert PT.TextMap(None).is_empty and PT.TextMap({}).is_empty


@pytest.mark.parametrize("name", sorted(JT.FEATURE_TYPES))
def test_transmogrify_group_of_every_type(name):
    jf = JFB(name.lower(), JT.FEATURE_TYPES[name]).extract_field() \
        .as_predictor()
    pf = PFB(name.lower(), PT.FEATURE_TYPES[name]).extract_field() \
        .as_predictor()
    try:
        want = JTr._group_of(jf)
    except NotImplementedError:
        with pytest.raises(NotImplementedError):
            PTr._group_of(pf)
        return
    assert PTr._group_of(pf) == want
    assert (type(PTr._vectorizer_for(want)).__name__
            == type(JTr._vectorizer_for(want)).__name__)


def test_reader_types_records_as_a_dataframe():
    """The port's frame of the leads records gives the JAX reader's
    columns: dates with None are float64 NaN in pandas and come out as the
    same int64 values and mask; lists, geolocations and maps stay python
    objects with None kept."""
    recs = leads_records(300, 4)
    recs[0]["CreatedDate"] = None
    recs[1]["Activities"] = None
    recs[2]["Offices"] = None
    df = pd.DataFrame(recs)
    frame = Frame.of(recs)
    for name, tn in (("CreatedDate", "Date"), ("LastActivity", "DateTime"),
                     ("Employees", "Integral"), ("Activities", "DateList"),
                     ("Location", "Geolocation"), ("Scores", "RealMap"),
                     ("Offices", "GeolocationMap"),
                     ("Products", "MultiPickListMap")):
        assert frame[name].dtype == df[name].to_numpy().dtype, name
        jc = jax_series_to_column(JT.FEATURE_TYPES[tn], df[name])
        pc = port_series_to_column(PT.FEATURE_TYPES[tn], frame[name])
        assert pc.kind == jc.kind
        np.testing.assert_array_equal(pc.valid_mask(), jc.valid_mask())
        if jc.kind in ("date", "integral"):
            assert pc.values.dtype == np.int64
            np.testing.assert_array_equal(pc.values, jc.values)
        else:
            assert list(pc.values) == list(jc.values)


def _score_single(feature, df, pkg):
    if pkg == "jax":
        from transmogrifai_tpu.workflow import OpWorkflow
        model = OpWorkflow().set_input_dataset(df).set_result_features(
            feature).train()
        return model.score(df=df)[feature.name]
    from transmogrifai_tpu_torch.workflow import OpWorkflow
    model = OpWorkflow(device="cpu").set_input_dataset(
        {c: df[c].tolist() for c in df.columns}).set_result_features(
        feature).train()
    return model.score(data={c: df[c].tolist() for c in df.columns})[
        feature.name]


def _dsl_outputs(pkg, FB, types):
    d = FB.Date("d").extract_field().as_predictor()
    dl = FB.DateList("dl").extract_field().as_predictor()
    dm = FB.DateMap("dm").extract_field().as_predictor()
    rm = FB.RealMap("rm").extract_field().as_predictor()
    tm = FB.TextMap("tm").extract_field().as_predictor()
    return [d.to_unit_circle(periods=("HourOfDay",)), d.time_period(
        "HourOfDay"), d.to_unit_circle(), dl.time_period("DayOfWeek"),
        dl.since_last(reference_date_ms=10 ** 12), d.to_date_list(),
        dm.to_unit_circle(periods=("HourOfDay", "DayOfWeek")),
        dm.time_period("MonthOfYear"), rm.filter_keys(white_list=["a"]),
        rm.vectorize_map(black_list_keys=["b"]),
        tm.smart_vectorize_map(num_hashes=16), tm.pivot_map(min_support=1)]


def test_date_dsl_and_map_dsl():
    """``tests/test_dsl.py::test_date_dsl``'s frame, then every date and
    map method of the DSL on a seeded frame: the same stages, names and
    outputs."""
    df = pd.DataFrame({"d": [12 * 3_600_000]})
    jax_reset()
    port_reset()
    jd = JFB.Date("d").extract_field().as_predictor()
    pd_ = PFB.Date("d").extract_field().as_predictor()
    for jf, pf in ((jd.to_unit_circle(periods=("HourOfDay",)),
                    pd_.to_unit_circle(periods=("HourOfDay",))),
                   (jd.time_period("HourOfDay"), pd_.time_period(
                       "HourOfDay"))):
        jo, po = _score_single(jf, df, "jax"), _score_single(pf, df, "port")
        np.testing.assert_array_equal(host(po.values), host(jo.values))
    np.testing.assert_allclose(host(po.values), [12])
    rng = np.random.RandomState(40)
    n = 60
    frame = pd.DataFrame({
        "d": [int(v) for v in rng.randint(0, 2 * 10 ** 12, n,
                                          dtype=np.int64)],
        "dl": [[int(v) for v in rng.randint(0, 10 ** 12, 3, dtype=np.int64)]
               for _ in range(n)],
        "dm": [{"x": int(rng.randint(0, 10 ** 12, dtype=np.int64))}
               for _ in range(n)],
        "rm": [{"a": float(rng.randn()), "b": 1.0} for _ in range(n)],
        "tm": [{"k": _text_value(rng), "w": _words(rng)} for _ in range(n)],
    })
    jax_reset()
    jo = _dsl_outputs("jax", JFB, JT)
    port_reset()
    po = _dsl_outputs("port", PFB, PT)
    assert [f.name for f in po] == [f.name for f in jo]
    assert [type(f.origin_stage).__name__ for f in po] == [
        type(f.origin_stage).__name__ for f in jo]
    from transmogrifai_tpu.workflow import OpWorkflow as JW
    from transmogrifai_tpu_torch.workflow import OpWorkflow as PW
    js = JW().set_input_dataset(frame).set_result_features(*jo).train() \
        .score(df=frame)
    ps = PW(device="cpu").set_input_dataset(
        {c: frame[c].tolist() for c in frame.columns}).set_result_features(
        *po).train().score(data={c: frame[c].tolist()
                                 for c in frame.columns})
    for jf, pf in zip(jo, po):
        jc, pc = js[jf.name], ps[pf.name]
        if jc.kind in ("map", "date_list", "integral"):
            assert list(host(pc.values)) == list(host(jc.values)), jf.name
        else:
            np.testing.assert_array_equal(host(pc.values), host(jc.values),
                                          err_msg=jf.name)
            assert meta_json(pc) == meta_json(jc), jf.name


def test_filter_map_keeps_the_map_type():
    port_reset()
    f = PFB.RealMap("m").extract_field().as_predictor()
    out = f.filter_keys(white_list=["a"], black_list=["b"])
    assert out.feature_type is PT.RealMap
    stage = out.origin_stage
    t = PTable({"m": PColumn.of_values(PT.RealMap, [
        {"a": 1.0, "b": 2.0}, {"b": 3.0}, None])}, 3)
    assert list(stage.transform_column(t).values) == [{"a": 1.0}, None,
                                                      None]
    assert isinstance(stage, PMath.FilterMap)
    assert JMath.FilterMap.__name__ == "FilterMap"
