"""The port's vectorizers, tokenizer, hash, transmogrifier, arithmetic DSL
and SanityChecker against the JAX package on the CPU.

Inputs are ``tests/test_vectorizers.py``'s and the seeded Titanic-shaped
frame ``testing.titanic_frame`` at 2,000 rows, through both packages.
Tolerance: none. Every matrix is bit-equal and every ``VectorMetadata``
equal (the same float32 arithmetic on the same values; the one-hot, hash
count, null-indicator and fill columns are exact), the SanityChecker keeps
the same slots for the same reasons, and its Cramér's V agree to 1e-12
(float64 on the same counts).
"""
from __future__ import annotations

import dataclasses
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pandas as pd
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from transmogrifai_tpu import types as JT  # noqa: E402
from transmogrifai_tpu.dag import (  # noqa: E402
    compute_dag as jax_dag, fit_and_transform_dag as jax_fit,
)
from transmogrifai_tpu.examples import titanic as jax_titanic  # noqa: E402
from transmogrifai_tpu.features import (  # noqa: E402
    FeatureBuilder as JFB, reset_uids as jax_reset,
)
from transmogrifai_tpu.impl.feature import vectorizers as JV  # noqa: E402
from transmogrifai_tpu.impl.feature.transmogrifier import (  # noqa: E402
    transmogrify as jax_transmogrify,
)
from transmogrifai_tpu.readers import DataReaders as JDR  # noqa: E402
from transmogrifai_tpu.table import (  # noqa: E402
    FeatureTable as JTable,
)
import transmogrifai_tpu.dsl  # noqa: E402,F401  (attaches the JAX DSL)

import transmogrifai_tpu_torch as port  # noqa: E402
from transmogrifai_tpu_torch import types as PT  # noqa: E402
from transmogrifai_tpu_torch.dag import (  # noqa: E402
    compute_dag as port_dag, fit_and_transform_dag as port_fit,
)
from transmogrifai_tpu_torch.examples import titanic as port_titanic  # noqa: E402
from transmogrifai_tpu_torch.features import (  # noqa: E402
    FeatureBuilder as PFB, reset_uids as port_reset,
)
from transmogrifai_tpu_torch.impl.feature import vectorizers as PV  # noqa: E402
from transmogrifai_tpu_torch.readers import DataReaders as PDR  # noqa: E402
from transmogrifai_tpu_torch.table import (  # noqa: E402
    Column as PColumn, FeatureTable as PTable,
)
from transmogrifai_tpu_torch.testing import titanic_csv  # noqa: E402


@pytest.fixture(autouse=True)
def _same_uids():
    """Both packages number their stages and features from 1 in every
    test, so the same definitions get the same names."""
    jax_reset()
    port_reset()


def _tables(data):
    """{name: (type name, python values)} -> (JAX table, port table on
    the CPU device)."""
    jt = JTable.from_columns({n: (getattr(JT, t), v)
                              for n, (t, v) in data.items()})
    n = len(next(iter(data.values()))[1])
    pt = PTable({k: PColumn.of_values(getattr(PT, t), v)
                 for k, (t, v) in data.items()}, n).to_device("cpu")
    return jt, pt


def _features(data):
    """Raw predictors of both packages, by name."""
    jf = {n: getattr(JFB, t)(n).extract_field().as_predictor()
          for n, (t, _) in data.items()}
    pf = {n: getattr(PFB, t)(n).extract_field().as_predictor()
          for n, (t, _) in data.items()}
    return jf, pf


def _meta(vm):
    return vm.name, [dataclasses.asdict(c) for c in vm.columns]


def assert_same_vector(jcol, pcol, names_too=True):
    a = np.asarray(jcol.values)
    b = pcol.values.cpu().numpy()
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(b, a)
    jn, jm = _meta(jcol.metadata["vector_meta"])
    pn, pm = _meta(pcol.metadata["vector_meta"])
    assert pm == jm
    if names_too:
        assert pn == jn


def _run(jstage, pstage, data, names, fit=True):
    """Fit (when an estimator) and transform a stage of each package on
    the same inputs; the two output columns and the fitted stages."""
    jt, pt = _tables(data)
    jf, pf = _features(data)
    jstage.set_input(*[jf[n] for n in names])
    pstage.set_input(*[pf[n] for n in names])
    jm = jstage.fit(jt) if fit else jstage
    pm = pstage.fit(pt) if fit else pstage
    return jm.transform_column(jt), pm.transform_column(pt), jm, pm


REAL = {"age": ("Real", [10.0, None, 30.0, 41.5]),
        "fare": ("Real", [1.0, 2.0, 3.0, float("nan")])}
INTEGRAL = {"x": ("Integral", [1, 2, 2, None, 3]),
            "tie": ("Integral", [3, 1, 3, 1, None])}
BINARY = {"vip": ("Binary", [True, False, None, True]),
          "ok": ("Binary", [1.0, 0.0, 0.0, float("nan")])}
PICK = {"color": ("PickList", ["red"] * 5 + ["blue"] * 3 + ["green"]
                  + [None])}
MULTI = {"tags": ("MultiPickList", [{"a", "b"}, {"a"}, set(), None])}
TEXT = {"lo": ("Text", ["a" if i % 2 else "b" for i in range(60)]),
        "hi": ("Text", [f"word{i} text{i % 7}" if i % 9 else None
                        for i in range(60)])}
TEXTLIST = {"t1": ("TextList", [["x", "y"], ["x"]]),
            "t2": ("TextList", [["z"], []])}


@pytest.mark.parametrize("track_nulls", [True, False])
def test_real_vectorizer(track_nulls):
    jc, pc, jm, pm = _run(JV.RealVectorizer(track_nulls=track_nulls),
                          PV.RealVectorizer(track_nulls=track_nulls), REAL,
                          ["age", "fare"])
    assert pm.fills == jm.fills
    assert_same_vector(jc, pc)
    row = {"age": None, "fare": 5.0}
    assert pm.transform_row(row) == jm.transform_row(row)


def test_integral_vectorizer_mode_fill_ties_to_the_smallest():
    jc, pc, jm, pm = _run(JV.IntegralVectorizer(), PV.IntegralVectorizer(),
                          INTEGRAL, ["x", "tie"])
    assert pm.fills == jm.fills == [2.0, 1.0]
    assert type(pm).__name__ == type(jm).__name__ == "RealVectorizerModel"
    assert pm.operation_name == jm.operation_name == "vecIntegral"
    assert_same_vector(jc, pc)
    row = {"x": None, "tie": 7}
    assert pm.transform_row(row) == jm.transform_row(row)


@pytest.mark.parametrize("track_nulls", [True, False])
def test_binary_vectorizer(track_nulls):
    jc, pc, _, pm = _run(JV.BinaryVectorizer(track_nulls=track_nulls),
                         PV.BinaryVectorizer(track_nulls=track_nulls),
                         BINARY, ["vip", "ok"], fit=False)
    assert_same_vector(jc, pc)
    jm = JV.BinaryVectorizer(track_nulls=track_nulls)
    jm.input_features = pm.input_features
    for row in ({"vip": None, "ok": True}, {"vip": False, "ok": None}):
        assert pm.transform_row(row) == jm.transform_row(row)


@pytest.mark.parametrize("kw", [dict(top_k=2, min_support=2),
                                dict(top_k=5, min_support=1),
                                dict(top_k=2, min_support=2,
                                     track_nulls=False)])
def test_one_hot_pick_list(kw):
    jc, pc, jm, pm = _run(JV.OneHotVectorizer(**kw),
                          PV.OneHotVectorizer(**kw), PICK, ["color"])
    assert pm.vocabs == jm.vocabs
    assert_same_vector(jc, pc)
    for v in ("red", "green", "purple", None):
        assert pm.transform_row({"color": v}) == jm.transform_row(
            {"color": v})


def test_one_hot_multi_pick_list():
    jc, pc, jm, pm = _run(JV.OneHotVectorizer(top_k=5, min_support=1),
                          PV.OneHotVectorizer(top_k=5, min_support=1),
                          MULTI, ["tags"])
    assert pm.vocabs == jm.vocabs
    assert_same_vector(jc, pc)
    for v in ({"a", "c"}, set(), None):
        assert pm.transform_row({"tags": v}) == jm.transform_row({"tags": v})


@pytest.mark.parametrize("kw", [dict(max_cardinality=10, min_support=1,
                                     num_hashes=16),
                                dict(), dict(track_nulls=False)])
def test_smart_text_pivot_and_hash(kw):
    jc, pc, jm, pm = _run(JV.SmartTextVectorizer(**kw),
                          PV.SmartTextVectorizer(**kw), TEXT, ["lo", "hi"])
    assert pm.plans == jm.plans
    assert_same_vector(jc, pc)
    for row in ({"lo": "a", "hi": "word3 TEXT, word3"},
                {"lo": None, "hi": None}):
        assert pm.transform_row(row) == jm.transform_row(row)


@pytest.mark.parametrize("kw", [dict(num_hashes=8, shared_hash_space=True),
                                dict(num_hashes=8),
                                dict(num_hashes=8, binary_freq=True)])
def test_hashing_vectorizer(kw):
    jc, pc, _, _ = _run(JV.HashingVectorizer(**kw),
                        PV.HashingVectorizer(**kw), TEXTLIST, ["t1", "t2"],
                        fit=False)
    assert_same_vector(jc, pc)


DOCS = ["Hello, World! 123", "Braund, Mr. Owen Harris", "", None,
        "O'Brien, Mrs. (\"Kate\")", "Ünïcödé straße — ça va", "a_b c-d",
        "  many   spaces\tand\nlines  ", "日本語のテキスト", "x" * 300]


def test_tokenizer_and_hash_match():
    for d in DOCS:
        for m in (1, 3):
            assert PV.tokenize_text(d, m) == JV.tokenize_text(d, m)
    toks = [PV.tokenize_text(d) for d in DOCS]
    for t in sum(toks, []):
        for h in (16, 512):
            assert PV._hash_token(t, h) == JV._hash_token(t, h)
    for binary in (False, True):
        np.testing.assert_array_equal(
            PV.hash_token_lists(toks, 512, binary),
            JV.hash_token_lists(toks, 512, binary))
        np.testing.assert_array_equal(
            PV.tokenize_hash_texts(DOCS, 512, 1, binary),
            JV.tokenize_hash_texts(DOCS, 512, 1, binary))
    assert PV.TextTokenizer().transform_fn("Hello, World! 123") == [
        "hello", "world", "123"]


def test_vectors_combiner_of_host_and_device_blocks():
    data = dict(REAL, **PICK, **{"hi": TEXT["hi"]})
    data = {k: (t, list(v)[:4]) for k, (t, v) in data.items()}
    jt, pt = _tables(data)
    jf, pf = _features(data)
    outs = []
    for tbl, f, V, feats in ((jt, jf, JV, None), (pt, pf, PV, None)):
        stages = [V.RealVectorizer().set_input(f["age"], f["fare"]),
                  V.OneHotVectorizer(min_support=1).set_input(f["color"]),
                  V.SmartTextVectorizer(max_cardinality=2, num_hashes=8
                                        ).set_input(f["hi"])]
        vecs = []
        for st in stages:
            m = st.fit(tbl)
            tbl = m.transform(tbl)
            vecs.append(st.get_output())
        comb = V.VectorsCombiner().set_input(*vecs)
        outs.append(comb.transform_column(tbl))
    assert_same_vector(outs[0], outs[1], names_too=False)


def test_transmogrify_end_to_end():
    """``tests/test_vectorizers.py``'s frame through both workflows."""
    df = pd.DataFrame({
        "age": [20.0, None, 40.0, 35.0] * 5,
        "cnt": [1, 2, 2, None] * 5,
        "vip": [True, False, None, True] * 5,
        "color": ["red", "blue", "red", None] * 5,
        "label": [0.0, 1.0, 1.0, 0.0] * 5,
    })
    types = {"age": "Real", "cnt": "Real", "vip": "Text", "color": "PickList"}
    jax_reset()
    jv = jax_transmogrify([getattr(JFB, t)(n).extract_field().as_predictor()
                           for n, t in types.items()])
    from transmogrifai_tpu.workflow import OpWorkflow as JWF
    jm = JWF().set_input_dataset(df).set_result_features(jv).train()
    port_reset()
    pv = port.transmogrify([getattr(PFB, t)(n).extract_field().as_predictor()
                            for n, t in types.items()])
    pm = port.OpWorkflow(device="cpu").set_input_dataset(
        {c: df[c].to_numpy() for c in df.columns}).set_result_features(
            pv).train()
    assert_same_vector(jm.score(df=df)[jv.name],
                       pm.score(data={c: df[c].tolist()
                                      for c in df.columns})[pv.name])


@pytest.fixture(scope="module")
def titanic_2k(tmp_path_factory):
    """The Titanic feature DAG of both packages fitted on 2,000 rows of
    ``titanic_csv``: (JAX fitted table, port fitted table, JAX vector
    feature, port vector feature, fitted stages of each)."""
    path = str(tmp_path_factory.mktemp("titanic") / "t.csv")
    titanic_csv(path, 2000, 3)
    jax_reset()
    js, jv = jax_titanic.titanic_features()
    jchk = jv.sanity_check(js)
    port_reset()
    ps, pv = port_titanic.titanic_features()
    pchk = pv.sanity_check(ps)
    jt = JDR.Simple.csv(path, schema=jax_titanic.TITANIC_SCHEMA,
                        header=False).generate_table(jchk.raw_features())
    pt = PDR.Simple.csv(path, schema=port_titanic.TITANIC_SCHEMA,
                        header=False).generate_table(
                            pchk.raw_features()).to_device("cpu")
    jout, jfitted = jax_fit(jt, jax_dag([jchk]))
    pout, pfitted = port_fit(pt, port_dag([pchk]))
    return jout, pout, jv, pv, jchk, pchk, jfitted, pfitted, path


def test_titanic_transmogrify_is_bit_equal(titanic_2k):
    jout, pout, jv, pv = titanic_2k[:4]
    assert jv.name == pv.name
    assert_same_vector(jout[jv.name], pout[pv.name], names_too=True)
    vm = pout[pv.name].metadata["vector_meta"]
    by_parent = {}
    for c in vm.columns:
        by_parent[c.parent_feature_name] = by_parent.get(
            c.parent_feature_name, 0) + 1
    # Name hashed (512 + null), pick lists pivoted, numerics filled
    assert by_parent["Name"] == 513
    assert by_parent["Sex"] == 4 and by_parent["Embarked"] == 5
    assert vm.size > 550


def test_titanic_sanity_checker_keeps_the_same_slots(titanic_2k):
    jout, pout, _, _, jchk, pchk, jfitted, pfitted, _ = titanic_2k
    jsc = jfitted[jchk.origin_stage.uid]
    psc = pfitted[pchk.origin_stage.uid]
    assert psc.keep_indices == jsc.keep_indices
    js, ps = jsc.summary, psc.summary
    assert ps.dropped == js.dropped and ps.reasons == js.reasons
    assert sorted(ps.categorical.cramers_v) == sorted(js.categorical.cramers_v)
    for g, v in js.categorical.cramers_v.items():
        assert ps.categorical.cramers_v[g] == pytest.approx(v, abs=1e-12)
    # the hashed Name group has no contingency statistics; the pivots do
    assert not any(g.startswith("Name::") for g in ps.categorical.cramers_v)
    assert any(g.startswith("Sex::") for g in ps.categorical.cramers_v)
    assert_same_vector(jout[jchk.name], pout[pchk.name])


def test_titanic_rows_through_each_fitted_stage(titanic_2k):
    """Every fitted vectorizer's ``transform_row`` on rows of the frame,
    in both packages."""
    jout, pout, jv, pv, _, _, jfitted, pfitted, _ = titanic_2k
    jt, pt = jout, pout
    for uid, pst in pfitted.items():
        jst = jfitted[uid]
        if type(pst).__name__ in ("SanityCheckerModel",):
            continue
        for i in (0, 1, 7, 1999):
            jrow = jt.row(i)
            prow = {f.name: jrow.get(f.name) for f in pst.input_features}
            assert pst.transform_row(prow) == jst.transform_row(prow), (
                type(pst).__name__, i)


def test_arithmetic_dsl_matches():
    """``+ - * /`` between features and with scalars, and ``alias``: the
    same float32 values and missing slots (a missing input, a division by
    zero), column and row."""
    data = {"a": ("Real", [1.5, None, 3.0, 0.0, 2.0, 1e30]),
            "b": ("Real", [2.0, 4.0, None, 0.0, 0.0, 1e30])}
    jt, pt = _tables(data)
    jf, pf = _features(data)
    exprs = [lambda a, b: a + b, lambda a, b: a - b, lambda a, b: a * b,
             lambda a, b: a / b, lambda a, b: a * 2.5, lambda a, b: 3 - a,
             lambda a, b: 1.0 + b, lambda a, b: a / 0.0,
             lambda a, b: (a + b).alias("total")]
    for e in exprs:
        jo, po = e(jf["a"], jf["b"]), e(pf["a"], pf["b"])
        assert po.type_name == jo.type_name
        jout, _ = jax_fit(jt, jax_dag([jo]))
        pout, _ = port_fit(pt, port_dag([po]))
        jc, pc = jout[jo.name], pout[po.name]
        np.testing.assert_array_equal(pc.values.cpu().numpy(),
                                      np.asarray(jc.values))
        np.testing.assert_array_equal(pc.valid_mask(), jc.valid_mask())
        for i in range(6):
            jrow, prow = jout.row(i), jt.row(i)
            for f in po.parents:
                prow[f.name] = jrow[f.name]
            assert po.origin_stage.transform_row(prow) == \
                jo.origin_stage.transform_row(prow)
    assert (pf["a"] + pf["b"]).alias("total").name == "total"


def test_dsl_text_methods_match():
    data = dict(TEXT)
    jt, pt = _tables(data)
    jf, pf = _features(data)
    for jo, po in ((jf["lo"].pivot(min_support=1), pf["lo"].pivot(
                        min_support=1)),
                   (jf["hi"].smart_vectorize(num_hashes=16),
                    pf["hi"].smart_vectorize(num_hashes=16))):
        jc = jo.origin_stage.fit(jt).transform_column(jt)
        pc = po.origin_stage.fit(pt).transform_column(pt)
        assert_same_vector(jc, pc, names_too=False)
    jtok, ptok = jf["hi"].tokenize(), pf["hi"].tokenize()
    jt2 = jt.with_column(jtok.name, jtok.origin_stage.transform_column(jt))
    pt2 = pt.with_column(ptok.name, ptok.origin_stage.transform_column(pt))
    assert list(pt2[ptok.name].values) == list(np.asarray(
        jt2[jtok.name].values))
    jtf, ptf = jtok.tf(num_hashes=32), ptok.tf(num_hashes=32)
    assert_same_vector(jtf.origin_stage.transform_column(jt2),
                       ptf.origin_stage.transform_column(pt2),
                       names_too=False)
    assert pf["lo"].vectorize().type_name == "OPVector"
