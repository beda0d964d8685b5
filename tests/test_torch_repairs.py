"""Two repairs of the port against the JAX package, on the CPU.

The sweep-fidelity switch (``utils.fidelity``): ``TG_SWEEP_FIDELITY=round4``
gives the JAX package's ``max_eval_rows`` (65536; an explicit value,
``None`` included, still wins), split-search sample (16384) and no
ensemble caps, read at call time (``tests/test_robustness.py::
test_round4_fidelity_switch`` on both packages); a small GBT sweep whose
rounds exceed the sweep cap gives the JAX package's fold metrics under the
switch (within 1e-5, ``tests/test_torch_forest_e2e.py``'s GBT limit: the
sigmoid's ``exp`` differs in the last bit between the CPU backends).

The SanityChecker summary's reader (``SanityCheckerSummary.from_json``)
and its dict view: summaries of schema 3 written by either package and
read by the other, schema 1's flat dict and schema 2 upgraded, an unknown
version raising as in the JAX package, on the inputs of
``tests/test_sanity_checker.py``.
"""
import json

import numpy as np
import pytest

from transmogrifai_tpu.impl.preparators import sanity_checker as jsc
from transmogrifai_tpu.impl.preparators import sanity_checker_metadata as jmeta
from transmogrifai_tpu.impl.tuning.validators import (
    OpCrossValidation as JCV,
)
from transmogrifai_tpu.models import trees as jtrees
from transmogrifai_tpu.utils import fidelity as jfidelity

from transmogrifai_tpu_torch.impl.preparators import sanity_checker as psc
from transmogrifai_tpu_torch.impl.tuning.validators import (
    OpCrossValidation as PCV, OpTrainValidationSplit as PTVS,
)
from transmogrifai_tpu_torch.models import trees as ptrees
from transmogrifai_tpu_torch.utils import fidelity as pfidelity


# ---------------------------------------------------------------------------
# the sweep-fidelity switch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("value", [None, "round4", "R4", "high", "other"])
def test_round4_fidelity_switch_is_the_jax_packages(value, monkeypatch):
    assert pfidelity.ENV == jfidelity.ENV
    if value is None:
        monkeypatch.delenv(pfidelity.ENV, raising=False)
    else:
        monkeypatch.setenv(pfidelity.ENV, value)
    assert pfidelity.round4_defaults() == jfidelity.round4_defaults()
    assert PCV().max_eval_rows == JCV().max_eval_rows
    assert PTVS().max_eval_rows == PCV().max_eval_rows
    assert ptrees._sweep_hist_sample() == jtrees._sweep_hist_sample()
    for vals in ([50.0, 50.0], [8.0, 64.0], [4.0, 8.0]):
        got = ptrees._sweep_ensemble_cap(np.array(vals), 16, "t")
        want = jtrees._sweep_ensemble_cap(np.array(vals), 16, "t")
        assert (got is None) == (want is None)
        if want is not None:
            np.testing.assert_array_equal(got, want)
    # an explicit caller choice wins over the switch
    assert PCV(max_eval_rows=1000).max_eval_rows == 1000
    assert PCV(max_eval_rows=None).max_eval_rows is None


def test_round4_values(monkeypatch):
    monkeypatch.delenv(pfidelity.ENV, raising=False)
    assert PCV().max_eval_rows == 32768
    assert ptrees._sweep_hist_sample() == 8192
    assert ptrees._sweep_ensemble_cap(np.array([50.0, 50.0]), 16,
                                      "t").tolist() == [16.0, 16.0]
    monkeypatch.setenv(pfidelity.ENV, "round4")
    assert PCV().max_eval_rows == 65536
    assert ptrees._sweep_hist_sample() == 16384
    assert ptrees._sweep_ensemble_cap(np.array([50.0, 50.0]), 16,
                                      "t") is None


def _sweep(pkg):
    """A two-point GBT sweep of 14 rounds (above the 12-round sweep cap)
    on ``tests/test_torch_forest_e2e.py``'s 400 rows, in either package;
    the selector's fold metrics."""
    grid = [{"maxDepth": 3, "maxIter": 14, "stepSize": 0.3,
             "minInstancesPerNode": 5, "minInfoGain": 0.001},
            {"maxDepth": 2, "maxIter": 14, "stepSize": 0.3,
             "minInstancesPerNode": 5, "minInfoGain": 0.001}]
    from transmogrifai_tpu_torch.testing import serve_bench_data
    data = serve_bench_data(400, 5, 3)
    if pkg == "jax":
        import pandas as pd
        import transmogrifai_tpu as tg
        from transmogrifai_tpu.features import FeatureBuilder as FB
        from transmogrifai_tpu.impl.selector.factories import (
            BinaryClassificationModelSelector as Sel)
        from transmogrifai_tpu.workflow import OpWorkflow
        wf, data = OpWorkflow(), pd.DataFrame(data)
    else:
        import transmogrifai_tpu_torch as tg
        from transmogrifai_tpu_torch import FeatureBuilder as FB
        from transmogrifai_tpu_torch import (
            BinaryClassificationModelSelector as Sel)
        from transmogrifai_tpu_torch.workflow import OpWorkflow
        wf = OpWorkflow(device="cpu")
    label = FB.RealNN("y").extract_field().as_response()
    feats = [FB.Real(f"x{i}").extract_field().as_predictor()
             for i in range(5)]
    pred = (Sel.with_cross_validation(seed=3,
                                      models=[("OpGBTClassifier", grid)])
            .set_input(label, tg.transmogrify(feats).sanity_check(label))
            .get_output())
    m = wf.set_input_dataset(data).set_result_features(pred).train()
    return np.asarray(m.stages[-1].summary.validation_results[0]
                      .fold_metrics)


def test_a_sweep_under_round4_gives_the_jax_packages_fold_metrics(
        monkeypatch):
    import jax
    jax.clear_caches()
    monkeypatch.setenv(pfidelity.ENV, "round4")
    got, want = _sweep("port"), _sweep("jax")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the switch changed the sweep: 14 rounds, not the capped 12
    monkeypatch.delenv(pfidelity.ENV)
    assert np.abs(_sweep("port") - got).max() > 1e-6


# ---------------------------------------------------------------------------
# the SanityChecker summary's reader and dict view
# ---------------------------------------------------------------------------

def _fitted_summaries():
    """Both packages' SanityChecker summaries of
    ``tests/test_sanity_checker.py``'s table (with a leaking slot, a
    constant one and an indicator group), full correlations on."""
    from transmogrifai_tpu.table import Column as JColumn
    from transmogrifai_tpu.table import FeatureTable as JTable
    from transmogrifai_tpu.types import OPVector as JVec
    from transmogrifai_tpu.types import RealNN as JRealNN
    from transmogrifai_tpu.vector_metadata import (
        VectorColumnMetadata as JVCM, VectorMetadata as JVM)
    from transmogrifai_tpu_torch.table import Column, FeatureTable
    from transmogrifai_tpu_torch.types import OPVector, RealNN
    from transmogrifai_tpu_torch.vector_metadata import (
        VectorColumnMetadata, VectorMetadata)
    from types import SimpleNamespace
    rng = np.random.RandomState(0)
    n = 600
    y = rng.randint(0, 2, n).astype(np.float32)
    cat = (rng.rand(n) < 0.4).astype(np.float32)
    X = np.stack([rng.randn(n), y + 0.001 * rng.randn(n), np.ones(n),
                  cat, 1.0 - cat], axis=1).astype(np.float32)
    meta = [("a", "Real", "a", None), ("leak", "Real", "leak", None),
            ("c", "Real", "c", None), ("g", "PickList", "g", "x"),
            ("g", "PickList", "g", "y")]
    out = []
    for mod, Col, Tab, Vec, RNN, VCM, VM in (
            (jsc, JColumn, JTable, JVec, JRealNN, JVCM, JVM),
            (psc, Column, FeatureTable, OPVector, RealNN,
             VectorColumnMetadata, VectorMetadata)):
        vm = VM.of("features", [VCM(*m) for m in meta])
        tbl = Tab({"label": Col(RNN, y, None),
                   "features": Col(Vec, X, None, {"vector_meta": vm})}, n)
        est = mod.SanityChecker(correlations="full", seed=0)
        est.input_features = (SimpleNamespace(name="label"),
                              SimpleNamespace(name="features"))
        est._finalize_model = lambda m: m
        if mod is psc:
            import torch
            tbl = tbl.to_device(torch.device("cpu"))
        out.append(est.fit(tbl).summary)
    return out


def test_summaries_written_by_either_package_read_in_the_other():
    jsum, psum = _fitted_summaries()
    jd = json.loads(json.dumps(jsum.to_json()))
    pd_ = json.loads(json.dumps(psum.to_json()))
    assert jd["schemaVersion"] == pd_["schemaVersion"] == 3
    assert jd["dropped"] and jd["dropped"] == pd_["dropped"]
    for d in (jd, pd_):
        mine = psc.SanityCheckerSummary.from_json(d)
        theirs = jmeta.SanityCheckerSummary.from_json(d)
        assert mine.to_json() == theirs.to_json() == d
        for key in theirs.keys():
            assert json.dumps(mine[key]) == json.dumps(theirs[key]), key
            assert mine.get(key) == mine[key] and key in mine
        assert sorted(mine.keys()) == sorted(theirs.keys())
        assert "nope" not in mine and mine.get("nope", 7) == 7
        with pytest.raises(KeyError):
            mine["nope"]
        # the summary the port reads round-trips through the JAX reader
        assert jmeta.SanityCheckerSummary.from_json(
            mine.to_json()).to_json() == d
    # the dict view of the port's own fitted summary
    assert psum["dropped"] == list(psum.dropped)
    assert psum["names"] == psum.stats.names
    assert psum["cramersV"] == psum.categorical.cramers_v


def test_schema_1_and_2_upgrade_as_in_the_jax_package():
    v1 = {"names": ["a"], "dropped": ["a"], "sampleSize": 7,
          "reasons": {"a": ["why"]}, "cramersV": {"g": 0.2},
          "count": [7.0], "mean": [1.5], "variance": [0.25],
          "min": [1.0], "max": [2.0], "correlationsWithLabel": [0.3]}
    v2 = {"schemaVersion": 2,
          "stats": {"names": ["a"], "count": [1.0], "mean": [0.0],
                    "variance": [1.0], "min": [0.0], "max": [1.0]},
          "categorical": {"cramers_v": {"g": 0.5}},
          "correlationsWithLabel": [0.1], "correlationType": "pearson",
          "dropped": [], "reasons": {}, "sampleSize": 1}
    for d in (v1, v2, {}):
        mine = psc.SanityCheckerSummary.from_json(d)
        theirs = jmeta.SanityCheckerSummary.from_json(d)
        assert mine.to_json() == theirs.to_json()
        assert mine.schema_version == 3
    up = psc.SanityCheckerSummary.from_json(v1)
    assert up["sampleSize"] == 7 and up["dropped"] == ["a"]
    s2 = psc.SanityCheckerSummary.from_json(v2)
    assert s2.categorical.mutual_info == {}
    assert s2.feature_correlations is None
    assert s2.categorical.cramers_v == {"g": 0.5}


@pytest.mark.parametrize("version", [0, 4, "3"])
def test_an_unknown_schema_version_raises(version):
    d = {"schemaVersion": version}
    with pytest.raises(ValueError, match="schemaVersion") as mine:
        psc.SanityCheckerSummary.from_json(d)
    with pytest.raises(ValueError, match="schemaVersion") as theirs:
        jmeta.SanityCheckerSummary.from_json(d)
    assert str(mine.value) == str(theirs.value)
