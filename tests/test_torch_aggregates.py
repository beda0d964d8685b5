"""The port's monoid aggregators and aggregating, conditional, joined and
streaming readers against the JAX package's, on the CPU: the inputs of
``tests/test_aggregates.py``, plus empty numeric cells, integer keys with
gaps (their keys are ``"1.0"``, ``"nan"``), ``timestamp_to_keep="random"``,
the dataprep example on small synthetic Clicks, Sends and WebVisits files,
and the reference's published ConditionalAggregation output on a file
that reproduces it. Each case builds the same features in both packages
from one builder, reads the same data (a DataFrame in the JAX package, the
same columns as python lists in the port) and compares the tables by
``testing.table_digest``: keys, their order, every value and every null.
Tolerance: none.
"""
from __future__ import annotations

import csv
import os
import sys
from types import SimpleNamespace

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pandas as pd
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import transmogrifai_tpu  # noqa: E402,F401
from transmogrifai_tpu import aggregators as jagg  # noqa: E402
from transmogrifai_tpu import types as jtypes  # noqa: E402
from transmogrifai_tpu.features import FeatureBuilder as JFB  # noqa: E402
from transmogrifai_tpu.readers import aggregates as jaggr  # noqa: E402
from transmogrifai_tpu.readers import readers as jreaders  # noqa: E402

from transmogrifai_tpu_torch import aggregators as pagg  # noqa: E402
from transmogrifai_tpu_torch import types as ptypes  # noqa: E402
from transmogrifai_tpu_torch.features import (  # noqa: E402
    FeatureBuilder as PFB,
)
from transmogrifai_tpu_torch.readers import aggregates as paggr  # noqa: E402
from transmogrifai_tpu_torch.readers import readers as preaders  # noqa: E402
from transmogrifai_tpu_torch.testing import table_digest  # noqa: E402

DAY = 86_400_000

JAX = SimpleNamespace(FB=JFB, agg=jagg, aggr=jaggr, R=jreaders,
                      frame=lambda data, **kw: jreaders.DataFrameReader(
                          pd.DataFrame(data), **kw))
PORT = SimpleNamespace(FB=PFB, agg=pagg, aggr=paggr, R=preaders,
                       frame=lambda data, **kw: preaders.FrameReader(
                           data, **kw))
BOTH = [JAX, PORT]


def _same(build):
    """``build(ns) -> (table, names)`` in both packages; the tables'
    digests equal. Returns the port's table."""
    (jt, names), (pt, pnames) = build(JAX), build(PORT)
    assert names == pnames
    assert table_digest(pt, names) == table_digest(jt, names)
    return pt


MONOID_CASES = [
    ("Sum", (), [1.0, 2.0, None, 3.0]),
    ("Sum", (), []),
    ("MaxAgg", (), [3, 1, 2]),
    ("MinAgg", (), [3, 1, None, 2]),
    ("MeanAgg", (), [1.0, 3.0, 0.1]),
    ("MeanAgg", (), []),
    ("LogicalOr", (), [False, None, True]),
    ("ModeAgg", (), ["b", "a", "b", "a", "c"]),
    ("ConcatText", (" ",), ["hello", None, "world"]),
    ("ConcatList", (), [["a"], ["b", "c"]]),
    ("UnionSet", (), [["a", "b"], ["b", "c"]]),
    ("LastValue", (), [1, 2, 3]),
    ("FirstValue", (), [1, 2, 3]),
    ("GeoMidpoint", (), [[0.0, 0.0, 1.0], [0.0, 90.0, 3.0],
                         [45.5, -120.25]]),
]


@pytest.mark.parametrize("name,args,values", MONOID_CASES)
def test_monoid_matches_jax(name, args, values):
    want = getattr(jagg, name)(*args).aggregate(values)
    got = getattr(pagg, name)(*args).aggregate(values)
    assert got == want and type(got) is type(want)


def test_union_map_and_defaults_match_jax():
    vals = [{"x": 1.0}, {"x": 2.0, "y": 5.0}, {"y": None}]
    assert pagg.UnionMap(pagg.Sum()).aggregate(vals) == \
        jagg.UnionMap(jagg.Sum()).aggregate(vals)
    assert pagg.UnionMap().aggregate(vals) == jagg.UnionMap().aggregate(vals)
    for name in sorted(jtypes.FEATURE_TYPES):
        if name not in ptypes.FEATURE_TYPES:
            continue
        want = type(jagg.default_aggregator(jtypes.FEATURE_TYPES[name]))
        got = type(pagg.default_aggregator(ptypes.FEATURE_TYPES[name]))
        assert got.__name__ == want.__name__, name


def test_cutoffs_match_jax():
    for ns in BOTH:
        assert vars(ns.agg.CutOffTime.unix_epoch(5 * DAY)) == {
            "kind": "UnixEpoch", "cutoff_ms": 5 * DAY}
        assert vars(ns.agg.CutOffTime.days_ago(2, now_ms=10 * DAY)) == {
            "kind": "DaysAgo", "cutoff_ms": 8 * DAY}
        assert vars(ns.agg.CutOffTime.no_cutoff()) == {
            "kind": "NoCutoff", "cutoff_ms": None}


def _events():
    return {"user": ["u1", "u1", "u1", "u2"],
            "t": [1 * DAY, 2 * DAY, 10 * DAY, 1 * DAY],
            "amount": [10.0, 20.0, 99.0, 5.0],
            "label": [0.0, 0.0, 1.0, 0.0],
            "kind": ["a", "b", "b", "c"]}


def _gappy_events():
    """Integer users with a gap (a float column: keys "1.0", "2.0",
    "nan"), empty amounts, and ties in time."""
    return {"user": [1, 2, None, 2, 1, 3, 3],
            "t": [1 * DAY, 1 * DAY, 2 * DAY, 3 * DAY, 3 * DAY, 4 * DAY,
                  6 * DAY],
            "amount": [1.5, None, 3.0, 4.0, None, 2.5, 7.0],
            "kind": ["a", "b", "a", None, "b", "b", "a"],
            "label": [0.0, 1.0, 0.0, 1.0, None, 0.0, 1.0]}


def _agg_features(ns, window=None):
    fb = ns.FB
    amount = fb.Real("amount").extract_field()
    if window:
        amount = amount.window(window)
    return [amount.as_predictor(),
            fb.PickList("kind").extract_field().as_predictor(),
            fb.Real("avg").extract(lambda r: r["amount"])
            .aggregate(ns.agg.MeanAgg()).as_predictor(),
            fb.MultiPickList("kinds").extract(
                lambda r: [r["kind"]] if isinstance(r["kind"], str)
                else None).as_predictor(),
            fb.Real("n").extract(lambda r: 1.0).as_predictor(),
            fb.RealNN("label").extract_field().as_response()]


@pytest.mark.parametrize("data", [_events, _gappy_events])
@pytest.mark.parametrize("cutoff,window", [
    (5 * DAY, None), (3 * DAY, 2 * DAY), (None, None)])
def test_aggregate_reader_matches_jax(data, cutoff, window):
    def build(ns):
        feats = _agg_features(ns, window)
        cut = (ns.agg.CutOffTime.unix_epoch(cutoff) if cutoff
               else ns.agg.CutOffTime.no_cutoff())
        reader = ns.aggr.AggregateDataReader(
            ns.frame(data()), ns.aggr.AggregateParams(
                cutoff=cut, timestamp_field="t"), key_field="user")
        return reader.generate_table(feats), [f.name for f in feats]
    t = _same(build)
    if data is _events and cutoff == 5 * DAY and window is None:
        assert list(t.key) == ["u1", "u2"]
        assert t["amount"].host_values()[0] == pytest.approx(30.0)
    if data is _gappy_events:
        assert list(t.key) == ["1.0", "2.0", "3.0", "nan"]


@pytest.mark.parametrize("keep", ["min", "max", "random"])
@pytest.mark.parametrize("drop", [True, False])
@pytest.mark.parametrize("data", [_events, _gappy_events])
def test_conditional_reader_matches_jax(keep, drop, data):
    def build(ns):
        feats = _agg_features(ns)
        reader = ns.aggr.ConditionalDataReader(
            ns.frame(data()), ns.aggr.ConditionalParams(
                target_condition=lambda r: r["kind"] == "b",
                timestamp_field="t", timestamp_to_keep=keep,
                drop_if_target_condition_not_met=drop,
                response_window=5 * DAY, seed=7),
            key_field="user")
        return reader.generate_table(feats), [f.name for f in feats]
    t = _same(build)
    if data is _events and drop:
        assert list(t.key) == ["u1"]


def test_random_timestamp_draws_as_jax():
    """``timestamp_to_keep="random"`` draws with ``random.Random(seed)``
    in key order: many users with several firing times pick the JAX
    package's cutoffs (the predictor counts show them)."""
    rng = np.random.RandomState(4)
    n = 300
    data = {"user": [f"k{i % 40:02d}" for i in range(n)],
            "t": (rng.randint(1, 60, n) * DAY).tolist(),
            "kind": rng.choice(["a", "b"], n).tolist()}

    def build(ns):
        f = ns.FB.Real("n").extract(lambda r: 1.0).as_predictor()
        reader = ns.aggr.ConditionalDataReader(
            ns.frame(data), ns.aggr.ConditionalParams(
                target_condition=lambda r: r["kind"] == "b",
                timestamp_field="t", timestamp_to_keep="random", seed=11),
            key_field="user")
        return reader.generate_table([f]), ["n"]
    _same(build)


@pytest.mark.parametrize("how", ["inner", "left", "outer"])
def test_joined_reader_matches_jax(how):
    users = {"uid": ["u3", "u1", "u2"], "age": [50.0, None, 40.0]}
    orders = {"uid": ["u2", "u1", "u4", "u2"],
              "total": [7.0, 9.0, 1.0, 2.0]}

    def build(ns):
        age = ns.FB.Real("age").extract_field().as_predictor()
        total = ns.FB.Real("total").extract_field().as_predictor()
        reader = ns.aggr.JoinedDataReader(
            ns.frame(users, key_field="uid"),
            ns.frame(orders, key_field="uid"), how)
        return reader.generate_table([age, total]), ["age", "total"]
    t = _same(build)
    assert list(t.key) == {"inner": ["u1", "u2"],
                           "left": ["u3", "u1", "u2"],
                           "outer": ["u3", "u1", "u2", "u4"]}[how]


def test_joined_aggregate_reader_with_routing_matches_jax():
    users = {"user": ["u2", "u1"], "age": [30.0, 40.0]}

    def build(ns):
        feats = _agg_features(ns)[:3]
        age = ns.FB.Real("age").extract_field().as_predictor()
        left = ns.aggr.AggregateDataReader(
            ns.frame(_events()), ns.aggr.AggregateParams(
                cutoff=ns.agg.CutOffTime.unix_epoch(5 * DAY),
                timestamp_fn=lambda r: r["t"]), key_field="user")
        reader = ns.aggr.JoinedDataReader(
            left, ns.frame(users, key_field="user"), "outer",
            feature_sides={"avg": "left"})
        return reader.generate_table(feats + [age]), \
            [f.name for f in feats] + ["age"]
    _same(build)


def test_join_without_a_side_raises_in_both():
    for ns in BOTH:
        f = ns.FB.Real("x").extract(lambda r: 1.0).as_predictor()
        reader = ns.aggr.JoinedDataReader(
            ns.frame({"k": ["a"], "y": [1.0]}, key_field="k"),
            ns.frame({"k": ["a"], "z": [1.0]}, key_field="k"))
        with pytest.raises(ValueError, match="cannot route"):
            reader.generate_table([f])


def test_streaming_reader_matches_jax():
    batches = [{"amount": [1.0, None], "kind": ["a", None]},
               {"amount": [3.0], "kind": ["b"]}]
    jt = list(jreaders.DataReaders.Streaming.batches(
        [pd.DataFrame(b) for b in batches]).stream_tables(
        [JFB.Real("amount").extract_field().as_predictor(),
         JFB.Text("kind").extract_field().as_predictor()]))
    pt = list(preaders.DataReaders.Streaming.batches(batches).stream_tables(
        [PFB.Real("amount").extract_field().as_predictor(),
         PFB.Text("kind").extract_field().as_predictor()]))
    assert [len(t) for t in pt] == [len(t) for t in jt] == [2, 1]
    for a, b in zip(jt, pt):
        assert table_digest(b, ["amount", "kind"]) == \
            table_digest(a, ["amount", "kind"])
    with pytest.raises(ValueError, match="stream_tables"):
        preaders.DataReaders.Streaming.batches(batches).read()


def test_feature_builder_aggregation_attributes():
    for ns in BOTH:
        f = (ns.FB.Real("x").extract_field().aggregate(ns.agg.MaxAgg())
             .window(3 * DAY).as_predictor())
        st = f.origin_stage
        assert type(st.aggregator).__name__ == "MaxAgg"
        assert st.aggregate_window == 3 * DAY
        raw = f.as_raw()
        assert raw.name == "x" and not raw.is_response
        assert raw.origin_stage.aggregator is None
    pf = PFB.Real("a").extract_field().as_predictor()
    jf = JFB.Real("a").extract_field().as_predictor()
    for f in (pf, jf):
        h = f.history()
        assert h["originFeatures"] == ["a"] and len(h["stages"]) == 1
        assert f.pretty_parent_stages().startswith("[0] FeatureGenerator")


@pytest.mark.parametrize("row", [
    {"y": 1.0, "a": 2.5, "n": 3, "b": True, "s": "x", "m": None},
    {"y": 0.0, "a": None, "n": 1, "b": False, "s": None, "m": 2.0}])
def test_from_row_and_dataframe_types_match_jax(row):
    jy, jfs = JFB.from_row(row, "y")
    py, pfs = PFB.from_row(row, "y")
    assert [(f.name, f.type_name) for f in pfs] == \
        [(f.name, f.type_name) for f in jfs]
    assert (py.name, py.type_name, py.is_response) == \
        (jy.name, jy.type_name, jy.is_response)
    rows = [row, {**row, "n": None, "s": "z"}]
    jy, jfs = JFB.from_dataframe(pd.DataFrame(rows), "y")
    py, pfs = PFB.from_dataframe(rows, "y")
    assert [(f.name, f.type_name) for f in pfs] == \
        [(f.name, f.type_name) for f in jfs]
    with pytest.raises(ValueError, match="not present"):
        PFB.from_dataframe(rows, "nope")


# ---------------------------------------------------------------------------
# The dataprep example
# ---------------------------------------------------------------------------

def _ts(day: int, hour: int = 9, minute: int = 30) -> str:
    return f"2017-09-{day:02d}::{hour:02d}:{minute:02d}:00"


def _write(path, rows):
    with open(path, "w", newline="") as fh:
        csv.writer(fh, lineterminator="\n").writerows(rows)
    return path


def _email_files(d, seed=0):
    """Headerless Clicks and Sends files: integer users, a few emails,
    events around the example's 2017-09-04 cutoff."""
    rng = np.random.RandomState(seed)
    clicks, sends = [], []
    for i in range(60):
        sends.append([i, int(rng.randint(100, 123)), int(rng.randint(1, 6)),
                      _ts(int(rng.randint(1, 8)), int(rng.randint(0, 24)))])
    for i in range(45):
        clicks.append([i, int(rng.randint(100, 123)), int(rng.randint(1, 6)),
                       _ts(int(rng.randint(2, 7)), int(rng.randint(0, 24)))])
    clicks.append([99, 123, 1, _ts(3, 10)])
    clicks.append([98, 123, 2, _ts(3, 11)])
    clicks.append([97, 123, 1, _ts(4, 12)])
    sends.append([99, 123, 1, _ts(1, 8)])
    return (_write(os.path.join(d, "Clicks.csv"), clicks),
            _write(os.path.join(d, "Sends.csv"), sends))


def _web_visits(d, published: bool, seed=0):
    """A headerless WebVisits file. ``published``: three users whose
    aggregation is the table published with the reference's
    ConditionalAggregation example, and one who never reaches the target
    page; otherwise seeded random visits."""
    target = "http://www.amazon.com/SaveBig"
    if published:
        rows = [
            ["xyz@salesforce.com", "http://www.amazon.com/a", "", "", _ts(1)],
            ["xyz@salesforce.com", "http://www.amazon.com/b", "", "", _ts(3)],
            ["xyz@salesforce.com", "http://www.amazon.com/c", "", "", _ts(5)],
            ["xyz@salesforce.com", target, "", "", _ts(6)],
            ["xyz@salesforce.com", "http://www.amazon.com/p", "P1", "9.99",
             _ts(6, 15)],
            ["lmn@salesforce.com", target, "", "", _ts(2)],
            ["lmn@salesforce.com", "http://www.amazon.com/p", "P2", "5.0",
             _ts(2, 20)],
            ["abc@salesforce.com", "http://www.amazon.com/a", "", "", _ts(4)],
            ["abc@salesforce.com", target, "", "", _ts(5)],
            ["abc@salesforce.com", "http://www.amazon.com/a", "", "",
             _ts(5, 12)],
            ["def@salesforce.com", "http://www.amazon.com/a", "", "", _ts(5)],
        ]
    else:
        rng = np.random.RandomState(seed)
        pages = [target] + [f"http://www.amazon.com/{c}" for c in "abcdef"]
        rows = []
        for i in range(150):
            u = f"user{int(rng.randint(0, 20))}@example.com"
            buy = rng.rand() < 0.2
            rows.append([u, pages[int(rng.randint(0, len(pages)))],
                         f"P{int(rng.randint(1, 9))}" if buy else "",
                         f"{rng.rand() * 50:.2f}" if buy else "",
                         _ts(int(rng.randint(1, 20)),
                             int(rng.randint(0, 24)),
                             int(rng.randint(0, 60)))])
    return _write(os.path.join(d, "WebVisits.csv"), rows)


def _digest(tbl):
    return table_digest(tbl, [c for c in tbl.column_names])


def test_dataprep_joins_and_aggregates_matches_jax(tmp_path):
    from transmogrifai_tpu.examples import dataprep as jdp
    from transmogrifai_tpu_torch.examples import dataprep as pdp
    clicks, sends = _email_files(str(tmp_path))
    jt, jctr = jdp.joins_and_aggregates(clicks, sends)
    pt, pctr = pdp.joins_and_aggregates(clicks, sends)
    assert _digest(pt) == _digest(jt)
    np.testing.assert_array_equal(pctr, jctr)
    i = [str(k) for k in pt.key].index("123")
    assert pt["numClicksYday"].host_values()[i] == 2.0
    assert pt["numSendsLastWeek"].host_values()[i] == 1.0
    assert pt["numClicksTomorrow"].host_values()[i] == 1.0


@pytest.mark.parametrize("published", [True, False])
def test_dataprep_conditional_aggregation_matches_jax(tmp_path, published):
    from transmogrifai_tpu.examples import dataprep as jdp
    from transmogrifai_tpu_torch.examples import dataprep as pdp
    path = _web_visits(str(tmp_path), published)
    jt = jdp.conditional_aggregation(path)
    pt = pdp.conditional_aggregation(path)
    assert _digest(pt) == _digest(jt)
    if published:
        got = {str(k): (float(pt["numVisitsWeekPrior"].host_values()[i]),
                        float(pt["numPurchasesNextDay"].host_values()[i]))
               for i, k in enumerate(pt.key)}
        assert got == {"xyz@salesforce.com": (3.0, 1.0),
                       "lmn@salesforce.com": (0.0, 1.0),
                       "abc@salesforce.com": (1.0, 0.0)}


def test_workflow_on_an_aggregate_reader_matches_jax():
    """``tests/test_aggregates.py``'s workflow on an aggregate reader in
    both packages: the same raw table, winner and holdout metric."""
    from transmogrifai_tpu.impl.feature.transmogrifier import (
        transmogrify as jtr,
    )
    from transmogrifai_tpu.impl.selector.factories import (
        BinaryClassificationModelSelector as JSel,
    )
    from transmogrifai_tpu.workflow import OpWorkflow as JWF
    from transmogrifai_tpu_torch.impl.feature.transmogrifier import (
        transmogrify as ptr,
    )
    from transmogrifai_tpu_torch.impl.selector.factories import (
        BinaryClassificationModelSelector as PSel,
    )
    from transmogrifai_tpu_torch.workflow import OpWorkflow as PWF
    rng = np.random.RandomState(0)
    rows = []
    for u in range(80):
        spend = 0.0
        for e in range(rng.randint(1, 5)):
            amt = float(rng.exponential(50))
            spend += amt
            rows.append({"user": f"u{u}", "t": (e + 1) * DAY, "amount": amt,
                         "label": 0.0})
        rows.append({"user": f"u{u}", "t": 50 * DAY, "amount": 0.0,
                     "label": float(spend > 100)})
    data = {k: [r[k] for r in rows] for k in rows[0]}
    out = []
    for ns, tr, Sel, wf in ((JAX, jtr, JSel, JWF()),
                            (PORT, ptr, PSel, PWF(device="cpu"))):
        amount = ns.FB.Real("amount").extract_field().as_predictor()
        label = ns.FB.RealNN("label").extract_field().as_response()
        pred = (Sel.with_train_validation_split(
            seed=2, models=[("OpLogisticRegression", None)])
            .set_input(label, tr([amount])).get_output())
        reader = ns.aggr.AggregateDataReader(
            ns.frame(data), ns.aggr.AggregateParams(
                cutoff=ns.agg.CutOffTime.unix_epoch(40 * DAY),
                timestamp_field="t"), key_field="user")
        model = wf.set_reader(reader).set_result_features(pred).train()
        sel = model.get_stage(pred.origin_stage.uid)
        out.append((table_digest(model.train_table, ["amount", "label"]),
                    sel.summary.best_model_type,
                    float(sel.summary.best_metric_value)))
    assert out[1][:2] == out[0][:2]
    assert out[1][2] == pytest.approx(out[0][2], abs=1e-4)
    assert out[1][2] > 0.9
