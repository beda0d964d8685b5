"""The raw feature filter of the PyTorch port, its distributions and the
streaming histogram sketch, against the JAX package on the CPU:
``tests/test_raw_feature_filter.py``'s cases with the JAX package as the
oracle, the native sketch against its numpy twin and both against the JAX
package's sketch, the blacklist surgery in a workflow, and saves that each
package loads from the other with the blacklist and the filter's results
intact.

Tolerances, stated once:

* the sketch's bins, the integer bin counts, fill counts and rates, the
  exclusions and their reasons, the blacklist, the cleaned table and the
  uids: equal (the same float64 host arithmetic, bit for bit);
* JS divergences: 1e-9 relative (float64 on the host; the same formulas
  on the same bins, numpy's summation order);
* null-label correlations: float32 at the JAX package's precision, from
  sums over the rows in another order: 1e-6 absolute, which keeps every
  decision against ``max_correlation`` away from its edge on these frames
  (the JAX package's XLA reduction order is not torch's).
"""
from __future__ import annotations

import json
import os
import sys
import zlib

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pandas as pd
import pytest
import jax  # noqa: F401
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

import transmogrifai_tpu  # noqa: E402,F401
import transmogrifai_tpu.utils.streaming_histogram as jsh  # noqa: E402
from transmogrifai_tpu.features import FeatureBuilder as JFB  # noqa: E402
from transmogrifai_tpu.features import reset_uids as jax_reset  # noqa: E402
from transmogrifai_tpu.filters import distribution as jdist  # noqa: E402
from transmogrifai_tpu.filters import RawFeatureFilter as JRFF  # noqa: E402
from transmogrifai_tpu.readers.readers import (  # noqa: E402
    dataframe_to_table,
)
import transmogrifai_tpu_torch as port  # noqa: E402
import transmogrifai_tpu_torch.utils.streaming_histogram as psh  # noqa: E402
from transmogrifai_tpu_torch.features import reset_uids as port_reset  # noqa: E402
from transmogrifai_tpu_torch.filters import distribution as pdist  # noqa: E402
from transmogrifai_tpu_torch.filters import RawFeatureFilter as PRFF  # noqa: E402
from transmogrifai_tpu_torch.table import Column, FeatureTable  # noqa: E402
from transmogrifai_tpu_torch.types import FEATURE_TYPES  # noqa: E402

JS_RTOL = 1e-9
CORR_ATOL = 1e-6


def _jax_python_sketch(monkeypatch):
    """Make the JAX package's sketches its pure-python fallback."""
    monkeypatch.setattr(jsh, "_build_lib", lambda: None)


def _values(kind, n, seed):
    rng = np.random.RandomState(seed)
    if kind == "normal":
        return rng.randn(n)
    if kind == "ties":
        return rng.randint(0, 7, n).astype(np.float64) * 0.5
    if kind == "exponential":
        return rng.exponential(3.0, n)
    xs = rng.randn(n) * 1e6
    xs[::5] = np.nan
    return xs


# ---------------------------------------------------------------------------
# The streaming histogram
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["normal", "ties", "exponential", "nan"])
@pytest.mark.parametrize("max_bins", [2, 16, 100])
def test_sketch_updates_bit_equal(kind, max_bins, monkeypatch):
    xs = _values(kind, 3000, 11)
    native = psh.StreamingHistogram(max_bins).update(xs)
    plain = psh.StreamingHistogram(max_bins, native=False).update(xs)
    jnative = jsh.StreamingHistogram(max_bins).update(xs)
    assert jnative._lib is not None
    _jax_python_sketch(monkeypatch)
    jplain = jsh.StreamingHistogram(max_bins).update(xs)
    assert jplain._lib is None
    want = jnative.to_state()
    for h in (native, plain, jplain):
        st = h.to_state()
        for k in want:
            assert np.asarray(st[k]).tobytes() == np.asarray(
                want[k]).tobytes(), k
    edges = np.linspace(np.nanmin(xs) - 1, np.nanmax(xs) + 1, 23)
    for h in (native, plain):
        assert h.density(edges).tobytes() == jnative.density(
            edges).tobytes()
        assert h.uniform(5).shape == (4,)


@pytest.mark.parametrize("pair", ["native+native", "native+plain",
                                  "plain+native", "plain+plain"])
def test_sketch_merges_bit_equal(pair, monkeypatch):
    a_native, b_native = (p == "native" for p in pair.split("+"))
    xs, ys = _values("normal", 2000, 1), _values("exponential", 1500, 2)
    a = psh.StreamingHistogram(24, native=a_native).update(xs)
    b = psh.StreamingHistogram(24, native=b_native).update(ys)
    ja = jsh.StreamingHistogram(24).update(xs)
    jb = jsh.StreamingHistogram(24).update(ys)
    a.merge(b)
    ja.merge(jb)
    assert a.bins() == ja.bins()
    assert (a.total, a.min, a.max) == (ja.total, ja.min, ja.max)
    # the canonical N-way merge, in any order
    parts = [psh.StreamingHistogram(8, native=i % 2 == 0).update(
        _values("ties", 300, i)) for i in range(5)]
    jparts = [jsh.StreamingHistogram(8).update(_values("ties", 300, i))
              for i in range(5)]
    got = psh.StreamingHistogram.merged(parts[::-1], max_bins=10)
    want = jsh.StreamingHistogram.merged(jparts, max_bins=10)
    assert got.bins() == want.bins()
    assert got.total == want.total
    _jax_python_sketch(monkeypatch)
    jp = jsh.StreamingHistogram(24).update(xs)
    jp.merge(jsh.StreamingHistogram(24).update(ys))
    assert a.bins() == jp.bins()


def test_sketch_state_round_trip():
    h = psh.StreamingHistogram(12).update(_values("normal", 500, 4))
    for native in (True, False):
        back = psh.StreamingHistogram.from_state(h.to_state(), native=native)
        assert back.bins() == h.bins()
        assert (back.total, back.min, back.max) == (h.total, h.min, h.max)
    j = jsh.StreamingHistogram.from_state(h.to_state())
    assert j.bins() == h.bins()


def test_sketch_invariants_raise():
    h = psh.StreamingHistogram(4).update(np.arange(10.0))
    with pytest.raises(AssertionError, match="lost mass"):
        h._check_invariants(11.0)
    with pytest.raises(TypeError):
        h.merge([1.0])


def test_sketch_raises_when_the_library_does_not_build(tmp_path,
                                                       monkeypatch):
    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(psh, "SOURCE", broken)
    monkeypatch.setattr(psh, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(psh, "_LIB", None)
    with pytest.raises(RuntimeError, match="did not build"):
        psh.StreamingHistogram(8)
    monkeypatch.setattr(psh, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="did not build"):
        psh.StreamingHistogram(8)
    # the numpy version needs no library
    assert psh.StreamingHistogram(8, native=False).update([1.0]).total == 1.0


def test_sketch_library_builds_into_the_package():
    path = psh.library_path()
    psh.load_library()
    assert path.exists()
    assert path.parent == psh.BUILD_DIR
    assert path.name.startswith("libstreaminghist-")


# ---------------------------------------------------------------------------
# Distributions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("token", ["Braund, Mr. Owen Harris", "Müller",
                                   "Ødegård, Mrs. 中文 🚢", "", "C85",
                                   "PC 17599"])
@pytest.mark.parametrize("bins", [255, 100, 7])
def test_text_hash_bins(token, bins):
    assert pdist._hash_bin(token, bins) == jdist._hash_bin(token, bins)
    assert pdist._hash_bin(token, bins) == zlib.crc32(
        token.encode("utf-8")) % bins


def _dist_fields(d):
    return (d.name, d.key, d.count, d.nulls, d.is_numeric,
            d.summary.min, d.summary.max, d.summary.sum, d.summary.count,
            np.asarray(d.distribution).tobytes())


@pytest.mark.parametrize("kind", ["normal", "ties", "nan"])
def test_numeric_distribution_matches_jax(kind):
    xs = _values(kind, 2000, 5)
    valid = ~np.isnan(xs)
    got = pdist.numeric_distribution("x", np.nan_to_num(xs), valid, 100)
    want = jdist.numeric_distribution("x", np.nan_to_num(xs), valid, 100)
    assert _dist_fields(got) == _dist_fields(want)
    assert got.sketch.bins() == want.sketch.bins()
    ys = _values("normal", 800, 6) + 0.3
    sg = pdist.numeric_distribution("x", ys, np.ones(800, bool), 100)
    sw = jdist.numeric_distribution("x", ys, np.ones(800, bool), 100)
    cg = pdist.compare_distributions(got, sg, 100)
    cw = jdist.compare_distributions(want, sw, 100)
    assert got.distribution.tobytes() == want.distribution.tobytes()
    assert sg.distribution.tobytes() == sw.distribution.tobytes()
    for k in ("trainFill", "scoreFill", "fillDelta", "fillRatio"):
        assert cg[k] == cw[k]
    assert cg["jsDivergence"] == pytest.approx(cw["jsDivergence"],
                                               rel=JS_RTOL)


def test_empty_numeric_column_has_no_edges():
    got = pdist.numeric_distribution("e", np.zeros(10), np.zeros(10, bool),
                                     100)
    want = jdist.numeric_distribution("e", np.zeros(10), np.zeros(10, bool),
                                      100)
    assert _dist_fields(got) == _dist_fields(want)
    assert pdist.numeric_bin_edges(got, None, 100) is None


def test_js_divergence_of_sketches_and_arrays():
    a = _values("normal", 1000, 1)
    b = _values("normal", 1000, 2) + 1.0
    pa, pb = (psh.StreamingHistogram(50).update(v) for v in (a, b))
    ja, jb = (jsh.StreamingHistogram(50).update(v) for v in (a, b))
    assert pdist.js_divergence(pa, pb) == pytest.approx(
        jdist.js_divergence(ja, jb), rel=JS_RTOL)
    p = np.random.RandomState(0).rand(30)
    q = np.random.RandomState(1).rand(30)
    assert pdist.js_divergence(p, q) == pytest.approx(
        jdist.js_divergence(p, q), rel=JS_RTOL)
    assert pdist.js_divergence(p, q[:5]) == 0.0
    with pytest.raises(TypeError):
        pdist.js_divergence(pa, q)


# ---------------------------------------------------------------------------
# The filter
# ---------------------------------------------------------------------------

def _jax_features():
    return (JFB.RealNN("y").extract_field().as_response(),
            JFB.Real("good").extract_field().as_predictor(),
            JFB.Real("empty").extract_field().as_predictor(),
            JFB.Real("shifted").extract_field().as_predictor(),
            JFB.Real("leaky").extract_field().as_predictor(),
            JFB.RealMap("m").extract_field().as_predictor(),
            JFB.Text("t").extract_field().as_predictor())


def _port_features():
    FB = port.FeatureBuilder
    return (FB.RealNN("y").extract_field().as_response(),
            FB.Real("good").extract_field().as_predictor(),
            FB.Real("empty").extract_field().as_predictor(),
            FB.Real("shifted").extract_field().as_predictor(),
            FB.Real("leaky").extract_field().as_predictor(),
            FB.RealMap("m").extract_field().as_predictor(),
            FB.Text("t").extract_field().as_predictor())


def _train_df(n=400, seed=0):
    """``tests/test_raw_feature_filter.py``'s train frame, with a text
    column of names."""
    rng = np.random.RandomState(seed)
    y = (rng.rand(n) > 0.5).astype(float)
    leaky = rng.randn(n)
    leaky[y > 0.5] = np.nan
    return pd.DataFrame({
        "y": y, "good": rng.randn(n), "empty": np.full(n, np.nan),
        "shifted": rng.randn(n), "leaky": leaky,
        "m": [{"a": rng.randn(), "b": None if rng.rand() < 0.995 else 1.0}
              for _ in range(n)],
        "t": [None if rng.rand() < 0.2 else
              ["Müller", "Ødegård", "Smith", "中文"][rng.randint(4)]
              for _ in range(n)],
    })


def _score_df(n=400, seed=1):
    rng = np.random.RandomState(seed)
    return pd.DataFrame({
        "good": rng.randn(n), "empty": np.full(n, np.nan),
        "shifted": rng.randn(n) + 50.0, "leaky": rng.randn(n),
        "m": [{"a": rng.randn()} for _ in range(n)],
        "t": [["Smith", "Jones"][rng.randint(2)] for _ in range(n)],
    })


def _port_table(jtable, names):
    """A JAX host table's columns as the port's host table (the same
    values and masks)."""
    cols = {}
    for name in names:
        jc = jtable[name]
        ftype = FEATURE_TYPES[jc.feature_type.__name__]
        vals = np.asarray(jc.values)
        if ftype.column_kind == "real":
            vals = vals.astype(np.float32)
        cols[name] = Column(ftype, vals, None if jc.mask is None
                            else np.asarray(jc.mask, bool))
    return FeatureTable(cols, jtable.num_rows)


def _tables(train_df, score_df):
    jf = _jax_features()
    pf = _port_features()
    jtrain = dataframe_to_table(train_df, jf)
    jscore = dataframe_to_table(score_df, [f for f in jf
                                           if not f.is_response])
    return (jf, jtrain, jscore, pf, _port_table(jtrain, train_df.columns),
            _port_table(jscore, score_df.columns))


def assert_same_results(got, want):
    """Two ``RawFeatureFilterResults.to_json()``: every key, count, rate
    and reason equal; JS divergences within JS_RTOL, null-label
    correlations within CORR_ATOL."""
    assert got["config"] == want["config"]
    assert got["excludedFeatures"] == want["excludedFeatures"]
    assert got["excludedMapKeys"] == want["excludedMapKeys"]
    assert len(got["metrics"]) == len(want["metrics"])
    for g, w in zip(got["metrics"], want["metrics"]):
        assert sorted(g) == sorted(w)
        for k, v in w.items():
            if k == "js_divergence" and v is not None:
                assert g[k] == pytest.approx(v, rel=JS_RTOL), (w["name"], k)
            elif k == "null_label_correlation" and v is not None:
                assert g[k] == pytest.approx(v, abs=CORR_ATOL), (w["name"],
                                                                 k)
            else:
                assert g[k] == v, (w["name"], k)


@pytest.mark.parametrize("correlation_type", ["pearson", "spearman"])
def test_filter_matches_jax(correlation_type):
    jf, jtrain, jscore, pf, ptrain, pscore = _tables(_train_df(),
                                                     _score_df())
    kw = dict(max_js_divergence=0.5, max_correlation=0.8,
              min_fill_rate=0.02, correlation_type=correlation_type)
    jclean, jbl, jres = JRFF(score_table=jscore, **kw).filter_raw(jtrain, jf)
    pclean, pbl, pres = PRFF(score_table=pscore, device="cpu",
                             **kw).filter_raw(ptrain, pf)
    assert_same_results(pres.to_json(), jres.to_json())
    assert [f.name for f in pbl] == [f.name for f in jbl]
    assert {"empty", "shifted", "leaky"} <= set(pres.excluded_features)
    assert pres.excluded_map_keys == {"m": ["b"]}
    assert sorted(pclean.column_names) == sorted(jclean.column_names)
    assert list(pclean["m"].host_values()) == list(jclean["m"].values)
    np.testing.assert_array_equal(pclean["m"].valid_mask(),
                                  jclean["m"].valid_mask())
    by_name = {m.full_name: m for m in pres.metrics}
    assert by_name["leaky"].null_label_correlation == pytest.approx(
        1.0, abs=0.05)


def test_filter_without_a_scoring_table_matches_jax():
    jf, jtrain, _, pf, ptrain, _ = _tables(_train_df(), _score_df())
    _, jbl, jres = JRFF(min_fill_rate=0.02).filter_raw(jtrain, jf)
    _, pbl, pres = PRFF(min_fill_rate=0.02, device="cpu").filter_raw(
        ptrain, pf)
    assert_same_results(pres.to_json(), jres.to_json())
    assert [f.name for f in pbl] == [f.name for f in jbl] == ["empty",
                                                              "leaky"]


def test_protected_features_survive():
    jf, jtrain, _, pf, ptrain, _ = _tables(_train_df(), _score_df())
    jfeats = [jf[0], jf[2], jf[1]]
    pfeats = [pf[0], pf[2], pf[1]]
    kw = dict(min_fill_rate=0.02, protected_features=["empty"])
    jclean, _, jres = JRFF(**kw).filter_raw(jtrain, jfeats)
    pclean, pbl, pres = PRFF(device="cpu", **kw).filter_raw(ptrain,
                                                            pfeats)
    assert "empty" in pclean.column_names
    assert pres.excluded_features == [] and pbl == []
    assert_same_results(pres.to_json(), jres.to_json())
    assert any("(protected, kept)" in r for m in pres.metrics
               for r in m.exclusion_reasons)


def test_map_feature_without_keys_uses_whole_column_fill():
    n = 50
    jfeat = JFB.RealMap("m").extract_field().as_predictor()
    pfeat = port.FeatureBuilder.RealMap("m").extract_field().as_predictor()
    jtab = dataframe_to_table(pd.DataFrame({"m": [None] * n}), [jfeat])
    ptab = _port_table(jtab, ["m"])
    _, jbl, jres = JRFF(score_table=jtab).filter_raw(jtab, [jfeat])
    _, pbl, pres = PRFF(score_table=ptab, device="cpu").filter_raw(
        ptab, [pfeat])
    assert_same_results(pres.to_json(), jres.to_json())
    assert [f.name for f in pbl] == ["m"]


def test_mesh_path_raises():
    with pytest.raises(NotImplementedError, match="mesh"):
        PRFF().set_mesh(object())


def test_filter_without_a_device_needs_the_card(monkeypatch):
    """A filter given no device runs its null-label pass where the port's
    other entry points do: on the CUDA device; with none it raises rather
    than falling back to the CPU."""
    jf, jtrain, _, pf, ptrain, _ = _tables(_train_df(), _score_df())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PRFF(min_fill_rate=0.02).filter_raw(ptrain, pf)
    _, _, jres = JRFF(min_fill_rate=0.02).filter_raw(jtrain, jf)
    _, _, pres = PRFF(min_fill_rate=0.02, device="cpu").filter_raw(ptrain,
                                                                   pf)
    assert_same_results(pres.to_json(), jres.to_json())

def _columns(df):
    return {c: df[c].to_numpy() for c in df.columns}


def _workflows(train_df):
    from transmogrifai_tpu.impl.feature.transmogrifier import (
        transmogrify as jax_transmogrify,
    )
    from transmogrifai_tpu.impl.selector.factories import (
        BinaryClassificationModelSelector as JBinary,
    )
    from transmogrifai_tpu.workflow import OpWorkflow as JWorkflow
    models = [("OpLogisticRegression",
               [{"regParam": 0.01, "elasticNetParam": 0.0}])]
    kw = dict(min_fill_rate=0.02, max_correlation=0.8)
    jax_reset()
    y, good, empty, _, leaky, _, _ = _jax_features()
    jpred = (JBinary.with_train_validation_split(seed=1, models=models)
             .set_input(y, jax_transmogrify([good, empty, leaky]))
             .get_output())
    jwf = (JWorkflow().set_input_dataset(train_df).set_result_features(jpred)
           .with_raw_feature_filter(JRFF(**kw)))
    port_reset()
    y, good, empty, _, leaky, _, _ = _port_features()
    ppred = (port.BinaryClassificationModelSelector
             .with_train_validation_split(seed=1, models=models)
             .set_input(y, port.transmogrify([good, empty, leaky]))
             .get_output())
    pwf = (port.OpWorkflow(device="cpu")
           .set_input_dataset(_columns(train_df))
           .set_result_features(ppred).with_raw_feature_filter(PRFF(**kw)))
    return jwf, jpred, pwf, ppred


@pytest.fixture(scope="module")
def surgery(tmp_path_factory):
    df = _train_df()[["y", "good", "empty", "leaky"]]
    jwf, jpred, pwf, ppred = _workflows(df)
    jm, pm = jwf.train(), pwf.train()
    root = tmp_path_factory.mktemp("rff")
    from test_torch_serve import save_jax_model
    save_jax_model(jm, str(root / "jax"))
    port.save_model(pm, str(root / "port"))
    return dict(df=df, jm=jm, pm=pm, jpred=jpred, ppred=ppred, pwf=pwf,
                jwf=jwf, jax_dir=str(root / "jax"),
                port_dir=str(root / "port"))


def _plan(path):
    with open(os.path.join(path, "plan.json")) as fh:
        return json.load(fh)


def test_workflow_blacklist_surgery_matches_jax(surgery):
    jm, pm = surgery["jm"], surgery["pm"]
    assert ([f.name for f in pm.blacklisted_features]
            == [f.name for f in jm.blacklisted_features]
            == ["empty", "leaky"])
    assert ([f.uid for f in pm.blacklisted_features]
            == [f.uid for f in jm.blacklisted_features])
    assert_same_results(pm.rff_results.to_json(), jm.rff_results.to_json())
    assert surgery["pwf"].phase_seconds["filter"] >= 0.0
    # the vectorizer lost two inputs: a copy keeps its uid and output
    assert ([(s.uid, [f.uid for f in s.input_features]) for s in pm.stages]
            == [(s.uid, [f.uid for f in s.input_features])
                for s in jm.stages])
    assert ([f.uid for f in pm.result_features]
            == [f.uid for f in jm.result_features])
    jplan, pplan = _plan(surgery["jax_dir"]), _plan(surgery["port_dir"])
    for key in ("resultFeatures", "rawFeatures", "blacklistedFeatures"):
        assert pplan[key] == jplan[key], key
    assert ([s["uid"] for s in pplan["stages"]]
            == [s["uid"] for s in jplan["stages"]])
    assert ([f["uid"] for f in pplan["features"]]
            == [f["uid"] for f in jplan["features"]])
    df = surgery["df"]
    jv = np.asarray(jm.score(df=df)[surgery["jpred"].name].values)
    pv = pm.score(data=_columns(df))[surgery["ppred"].name].values.numpy()
    np.testing.assert_allclose(pv, jv, rtol=0, atol=2e-4)


def test_port_save_loads_in_jax_with_the_filter(surgery):
    from transmogrifai_tpu.persistence import load_model as jax_load
    loaded = jax_load(surgery["port_dir"])
    assert ([f.name for f in loaded.blacklisted_features]
            == ["empty", "leaky"])
    assert_same_results(loaded.rff_results.to_json(),
                        surgery["pm"].rff_results.to_json())
    df = surgery["df"]
    s1 = np.asarray(loaded.score(df=df)[surgery["ppred"].name].values)
    s2 = surgery["pm"].score(data=_columns(df))[
        surgery["ppred"].name].values.numpy()
    np.testing.assert_allclose(s1, s2, rtol=1e-5, atol=1e-6)


def test_jax_save_loads_in_the_port_with_the_filter(surgery, tmp_path):
    loaded = port.load_model(surgery["jax_dir"], device="cpu")
    assert ([f.name for f in loaded.blacklisted_features]
            == ["empty", "leaky"])
    assert type(loaded.rff_results).__name__ == "RawFeatureFilterResults"
    assert_same_results(loaded.rff_results.to_json(),
                        surgery["jm"].rff_results.to_json())
    df = surgery["df"]
    s1 = loaded.score(data=_columns(df))[surgery["jpred"].name].values
    s2 = np.asarray(surgery["jm"].score(df=df)[surgery["jpred"].name].values)
    np.testing.assert_allclose(s1.numpy(), s2, rtol=1e-5, atol=1e-6)
    # and saved again by the port, the JAX package reads it back
    from transmogrifai_tpu.persistence import load_model as jax_load
    again = str(tmp_path / "again")
    port.save_model(loaded, again)
    back = jax_load(again)
    assert ([f.uid for f in back.blacklisted_features]
            == [f.uid for f in surgery["jm"].blacklisted_features])
    assert_same_results(back.rff_results.to_json(),
                        surgery["jm"].rff_results.to_json())
