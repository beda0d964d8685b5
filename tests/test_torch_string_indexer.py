"""The port's label indexers and ``PredictionDeIndexer`` against the JAX
package on the CPU.

Inputs are ``tests/test_text_stages.py``'s (the indexer round trips, with
and without the filter), ``tests/test_review_fixes.py``'s (the deindexer
end to end) and ``tests/test_round3_fixes.py``'s (the deindexer rounds
float noise), and seeded columns. Tolerance: none: the same labels in the
same order, the same indices and the same strings.
"""
from __future__ import annotations

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from transmogrifai_tpu import types as JT  # noqa: E402
from transmogrifai_tpu.features import (  # noqa: E402
    FeatureBuilder as JFB, reset_uids as jax_reset,
)
from transmogrifai_tpu.impl.feature import text as JX  # noqa: E402
from transmogrifai_tpu.impl.preparators import (  # noqa: E402
    prediction_deindexer as JP,
)
from transmogrifai_tpu.table import (  # noqa: E402
    Column as JColumn, FeatureTable as JTable,
)

from transmogrifai_tpu_torch import types as PT  # noqa: E402
from transmogrifai_tpu_torch.features import (  # noqa: E402
    FeatureBuilder as PFB, reset_uids as port_reset,
)
from transmogrifai_tpu_torch.impl.feature import text as PX  # noqa: E402
from transmogrifai_tpu_torch.impl.preparators import (  # noqa: E402
    prediction_deindexer as PP,
)
from transmogrifai_tpu_torch.table import (  # noqa: E402
    Column as PColumn, FeatureTable as PTable,
)

#: each package's (types, FeatureBuilder, reset_uids, Column, FeatureTable,
#: text module, deindexer module)
PKGS = {"jax": (JT, JFB, jax_reset, JColumn, JTable, JX, JP),
        "port": (PT, PFB, port_reset, PColumn, PTable, PX, PP)}


def host(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def round_trip(pkg, values, no_filter=False, handle_invalid="keep",
               score=None):
    """(labels, summary, indices of ``score`` (or ``values``), their
    metadata labels, the strings back) of one package's indexer fitted on
    a Text column of ``values``."""
    types, FB, reset, C, T, X, _ = PKGS[pkg]
    reset()
    f = FB("t", types.Text).extract_field().as_predictor()
    tbl = T({"t": C.of_values(types.Text, values)}, len(values))
    est = (X.OpStringIndexerNoFilter() if no_filter
           else X.OpStringIndexer(handle_invalid=handle_invalid))
    model = est.set_input(f).fit(tbl)
    if score is not None:
        tbl = T({"t": C.of_values(types.Text, score)}, len(score))
    out = model.transform_column(tbl)
    inv = (X.OpIndexToStringNoFilter if no_filter else X.OpIndexToString)(
        model.labels).set_input(model.get_output())
    back = inv.transform_column(tbl.with_column(model.get_output().name,
                                                out))
    return (list(model.labels), model.summary_metadata,
            host(out.values).tolist(), host(out.valid_mask()).tolist(),
            out.metadata["labels"], list(back.values),
            [inv.transform_fn(v) for v in (None, 0.0, 1.0, 99.0)])


def _seeded_labels(n, seed):
    rng = np.random.RandomState(seed)
    pool = ["a", "b", "c", "", "null", "d"]
    return [None if rng.rand() < 0.1 else pool[rng.randint(len(pool))]
            for _ in range(n)]


CASES = {
    "round_trip": (["b", "a", "b", "b", None], {}),
    "no_filter": (["b", "a", "b", None, "zz"], {"no_filter": True}),
    "no_filter_frequent_null": ([None, None, "a", "", "b"],
                                {"no_filter": True}),
    "seeded": (_seeded_labels(300, 1), {}),
    "seeded_no_filter": (_seeded_labels(300, 2), {"no_filter": True}),
    "skip_unseen": (["x", "y", "x"], {"handle_invalid": "skip",
                                      "score": ["x", "z", None]}),
    "keep_unseen": (["x", "y", "x"], {"score": ["x", "z", None, "y"]}),
    "no_filter_unseen": (["x", "y", "x"], {"no_filter": True,
                                           "score": ["x", "z", None]}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_indexers_match_the_jax_package(case):
    values, kw = CASES[case]
    assert round_trip("port", values, **kw) == round_trip("jax", values,
                                                          **kw)


def test_round_trip_values():
    """``tests/test_text_stages.py``'s assertions, on the port."""
    labels, _, idx, _, _, back, _ = round_trip("port",
                                               ["b", "a", "b", "b", None])
    assert labels == ["b", "a"] and idx[0] == 0 and idx[1] == 1 \
        and idx[4] == 2
    assert back[:2] == ["b", "a"]
    labels, summary, idx, _, _, back, fn = round_trip(
        "port", ["b", "a", "b", None, "zz"], no_filter=True)
    assert summary["labels"][-1] == PX.UNSEEN_LABEL
    assert "null" in summary["labels"] and back[3] == "null"
    assert fn[0] == PX.UNSEEN_LABEL


def test_unseen_label_errors_in_both():
    for pkg in PKGS:
        with pytest.raises(ValueError, match="unseen label"):
            round_trip(pkg, ["x"], handle_invalid="error", score=["y"])
    for pkg in PKGS:
        with pytest.raises(ValueError, match="handle_invalid"):
            PKGS[pkg][5].OpStringIndexer(handle_invalid="drop")


def deindex(pkg, preds, labels=None):
    """``tests/test_review_fixes.py``'s deindexer: fitted on the indexed
    response of ["cat", "dog", "cat", "bird"], decoding ``preds``."""
    types, FB, reset, C, T, X, P = PKGS[pkg]
    reset()
    raw = FB.Text("label").extract_field().as_response()
    tbl = T({"label": C.of_values(types.Text, ["cat", "dog", "cat",
                                               "bird"])}, 4)
    idx_model = X.OpStringIndexer().set_input(raw).fit(tbl)
    t2 = tbl.with_column("labelIdx", idx_model.transform_column(tbl))
    t2 = t2.with_column("pred", C.of_values(types.RealNN, preds))
    resp = FB.RealNN("labelIdx").extract_field().as_response()
    pred = FB.RealNN("pred").extract_field().as_predictor()
    model = P.PredictionDeIndexer().set_input(resp, pred).fit(t2)
    return (list(model.labels), list(model.transform_column(t2).values),
            model.transform_row({"pred": 0.0}),
            [model._decode(v) for v in (1.9999999, -0.3, -0.6, 2.4, 2.6,
                                        None, float("nan"))])


def test_deindexer_matches_the_jax_package():
    preds = [1.0, 0.0, 99.0, 2.0]
    got = deindex("port", preds)
    assert got == deindex("jax", preds)
    assert got[1] == ["bird", "cat", "UnseenLabel", "dog"]
    assert got[2] == "cat"


def test_deindexer_rounds_float_noise():
    """``tests/test_round3_fixes.py``'s decoding."""
    m = PP.PredictionDeIndexerModel(labels=["a", "b", "c"])
    j = JP.PredictionDeIndexerModel(labels=["a", "b", "c"])
    vals = (1.9999999, -0.3, -0.6, 2.4, 2.6, None, float("nan"))
    assert [m._decode(v) for v in vals] == [j._decode(v) for v in vals]
    assert m._decode(1.9999999) == "c" and m._decode(-0.6) == m.unseen_name


def test_deindexer_needs_label_metadata():
    for pkg in PKGS:
        types, FB, reset, C, T, X, P = PKGS[pkg]
        reset()
        tbl = T({"r": C.of_values(types.RealNN, [0.0, 1.0]),
                 "p": C.of_values(types.RealNN, [0.0, 1.0])}, 2)
        st = P.PredictionDeIndexer().set_input(
            FB.RealNN("r").extract_field().as_response(),
            FB.RealNN("p").extract_field().as_predictor())
        with pytest.raises(ValueError, match="label/index"):
            st.fit(tbl)


def test_indexed_column_lands_on_the_table_device():
    """The port's indexed label is a RealNN column on the table's device
    (here the CPU) carrying its labels."""
    port_reset()
    f = PFB.Text("t").extract_field().as_predictor()
    tbl = PTable({"t": PColumn.of_values(PT.Text, ["a", "b", "a"])},
                 3).to_device("cpu")
    out = PX.OpStringIndexer().set_input(f).fit(tbl).transform_column(tbl)
    assert isinstance(out.values, torch.Tensor)
    assert out.values.dtype == torch.float32
    assert out.metadata["labels"] == ["a", "b"]
