"""The port's scalers, bucketizers and percentile calibrator, and the
nine DSL methods over them, against the JAX package's on the CPU.

Each stage is built in both packages on the same host table (numpy
draws from a seed, or ``tests/test_dsl_surface.py``'s columns) and on
edge cases: all-null and constant columns, a single class, boundaries
that collapse, maps with empty and NaN values. Fitted state
(``summary_metadata`` and the models' attributes), every output value,
mask and vector metadata, the row dual and saves across the packages are
compared. Tolerance: none (the fits are float64 numpy in both packages,
the transforms float32 numpy). ``DSL_METHODS`` equals the JAX package's
list; ``tests/test_torch_dsl_text.py`` runs each method through a
workflow in both packages.
"""
from __future__ import annotations

import dataclasses
import math
import os
import sys
from types import SimpleNamespace

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import test_dsl_surface as surface  # noqa: E402
import transmogrifai_tpu  # noqa: E402,F401
from transmogrifai_tpu import dsl as jax_dsl  # noqa: E402
from transmogrifai_tpu import persistence as jpers  # noqa: E402
from transmogrifai_tpu import types as jtypes  # noqa: E402
from transmogrifai_tpu.features import FeatureBuilder as JFB  # noqa: E402
from transmogrifai_tpu.impl.feature import bucketizers as jb  # noqa: E402
from transmogrifai_tpu.impl.feature import scalers as js  # noqa: E402
from transmogrifai_tpu.table import FeatureTable as JTable  # noqa: E402

from transmogrifai_tpu_torch import dsl as port_dsl  # noqa: E402
from transmogrifai_tpu_torch import persistence as ppers  # noqa: E402
from transmogrifai_tpu_torch import types as ptypes  # noqa: E402
from transmogrifai_tpu_torch.features import (  # noqa: E402
    FeatureBuilder as PFB,
)
from transmogrifai_tpu_torch.impl.feature import (  # noqa: E402
    bucketizers as pb, scalers as ps,
)
from transmogrifai_tpu_torch.table import FeatureTable as PTable  # noqa: E402

JAX = SimpleNamespace(FB=JFB, s=js, b=jb, T=jtypes, Table=JTable)
PORT = SimpleNamespace(FB=PFB, s=ps, b=pb, T=ptypes, Table=PTable)
N = 300


def host(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _cols(seed=0):
    """{name: (type name, python values)} of the stage tests' table."""
    rng = np.random.RandomState(seed)
    x = rng.gamma(2.0, 3.0, N)
    y = ((x + rng.randn(N) * 2) > 6).astype(float)
    maps = []
    for i in range(N):
        m = {}
        if rng.rand() < 0.8:
            m["a"] = float(x[i] * 2 + rng.randn())
        if rng.rand() < 0.5:
            m["b"] = float(rng.randn())
        if rng.rand() < 0.1:
            m["c"] = float("nan")
        maps.append(m or None)
    return {
        "y": ("RealNN", y.tolist()),
        "one": ("RealNN", [1.0] * N),
        "x": ("Real", [None if i % 9 == 0 else float(v)
                       for i, v in enumerate(x)]),
        "pos": ("Real", [None if i % 5 == 0 else float(v) + 0.5
                         for i, v in enumerate(x)]),
        "xnn": ("RealNN", x.tolist()),
        "const": ("Real", [3.25] * N),
        "constnn": ("RealNN", [3.25] * N),
        "nulls": ("Real", [None] * N),
        "few": ("Real", [float(i % 3) for i in range(N)]),
        "m": ("RealMap", maps),
        "mnull": ("RealMap", [None] * N),
    }


def _table(ns, cols):
    return ns.Table.from_columns({n: (ns.T.FEATURE_TYPES[t], vals)
                                  for n, (t, vals) in cols.items()})


def _feat(ns, cols, name):
    t = cols[name][0]
    f = getattr(ns.FB, t)(name).extract_field()
    return f.as_response() if name in ("y", "one") else f.as_predictor()


#: (case, builder(ns, F) -> stage): F maps a column name to its feature
CASES = {
    "scale_linear": lambda ns, F: ns.s.ScalerTransformer(
        "linear", 2.5, -1.0).set_input(F("x")),
    "scale_log": lambda ns, F: ns.s.ScalerTransformer("log").set_input(
        F("pos")),
    "scale_log_nulls": lambda ns, F: ns.s.ScalerTransformer(
        "log").set_input(F("nulls")),
    "zscore": lambda ns, F: ns.s.OpScalarStandardScaler().set_input(
        F("xnn")),
    "zscore_const": lambda ns, F: ns.s.OpScalarStandardScaler().set_input(
        F("constnn")),
    "zscore_no_mean": lambda ns, F: ns.s.OpScalarStandardScaler(
        with_mean=False).set_input(F("xnn")),
    "fill_mean": lambda ns, F: ns.s.FillMissingWithMean().set_input(F("x")),
    "fill_mean_nulls": lambda ns, F: ns.s.FillMissingWithMean(
        2.0).set_input(F("nulls")),
    "bucketize": lambda ns, F: ns.b.NumericBucketizer(
        [0.0, 2.0, 5.0, 10.0]).set_input(F("x")),
    "bucketize_invalid": lambda ns, F: ns.b.NumericBucketizer(
        [1.0, 4.0, 8.0], bucket_labels=["lo", "mid"], track_invalid=True,
        track_nulls=False).set_input(F("x")),
    "auto_bucketize": lambda ns, F: ns.b.DecisionTreeNumericBucketizer(
        ).set_input(F("y"), F("x")),
    "auto_bucketize_deep": lambda ns, F: ns.b.DecisionTreeNumericBucketizer(
        max_depth=4, min_info_gain=0.0, track_invalid=True
    ).set_input(F("y"), F("x")),
    "auto_bucketize_one_class": lambda ns, F:
        ns.b.DecisionTreeNumericBucketizer().set_input(F("one"), F("x")),
    "auto_bucketize_const": lambda ns, F:
        ns.b.DecisionTreeNumericBucketizer().set_input(F("y"), F("const")),
    "auto_bucketize_nulls": lambda ns, F:
        ns.b.DecisionTreeNumericBucketizer().set_input(F("y"), F("nulls")),
    "auto_bucketize_map": lambda ns, F:
        ns.b.DecisionTreeNumericMapBucketizer().set_input(F("y"), F("m")),
    "auto_bucketize_map_nulls": lambda ns, F:
        ns.b.DecisionTreeNumericMapBucketizer().set_input(F("y"),
                                                          F("mnull")),
    "percentile": lambda ns, F: ns.b.PercentileCalibrator().set_input(
        F("x")),
    "percentile_few": lambda ns, F: ns.b.PercentileCalibrator(
        10).set_input(F("few")),
    "percentile_const": lambda ns, F: ns.b.PercentileCalibrator(
        ).set_input(F("const")),
    "percentile_nulls": lambda ns, F: ns.b.PercentileCalibrator(
        ).set_input(F("nulls")),
}


def _fit(ns, case, cols):
    feats = {}

    def F(name):
        if name not in feats:
            feats[name] = _feat(ns, cols, name)
        return feats[name]
    stage = CASES[case](ns, F)
    table = _table(ns, cols)
    model = stage.fit(table) if hasattr(stage, "fit") else stage
    return model, table


def _state(model):
    """The model's fitted attributes and summary (no wiring)."""
    skip = {"input_features", "_output_feature", "uid", "_params",
            "transform_fn", "columnar_fn", "_device_constants"}
    out = {k: v for k, v in vars(model).items() if k not in skip}
    return json_safe(out)


def json_safe(v):
    if isinstance(v, dict):
        return {str(k): json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [json_safe(x) for x in v]
    if isinstance(v, float) and math.isnan(v):
        return "nan"
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, type):
        return v.__name__
    return v


def _same_column(pc, jc):
    pv, jv = host(pc.values), host(jc.values)
    np.testing.assert_array_equal(pv, jv)
    assert pv.dtype == jv.dtype
    pm = np.ones(len(pv), bool) if pc.mask is None else host(pc.mask)
    jm = np.ones(len(jv), bool) if jc.mask is None else host(jc.mask)
    np.testing.assert_array_equal(pm.astype(bool), jm.astype(bool))
    jvm, pvm = (c.metadata.get("vector_meta") for c in (jc, pc))
    assert (jvm is None) == (pvm is None)
    if jvm is not None:
        assert [dataclasses.asdict(c) for c in pvm.columns] == \
            [dataclasses.asdict(c) for c in jvm.columns]
    assert {k: v for k, v in pc.metadata.items() if k != "vector_meta"} \
        == {k: v for k, v in jc.metadata.items() if k != "vector_meta"}


@pytest.mark.parametrize("case", list(CASES))
def test_stage_matches_jax(case):
    """Fitted state, summary, the output column and the row dual."""
    cols = _cols()
    jm, jt = _fit(JAX, case, cols)
    pm, pt = _fit(PORT, case, cols)
    assert _state(pm) == _state(jm)
    _same_column(pm.transform_column(pt), jm.transform_column(jt))
    if type(jm).__name__ in ("DescalerTransformer",):
        return
    for i in (0, 1, 9, 17):
        row = jt.row(i)
        want = jm.transform_row(row)
        got = pm.transform_row(pt.row(i))
        assert json_safe(got) == json_safe(want), (case, i)


@pytest.mark.parametrize("case", ["scale_linear", "zscore", "fill_mean",
                                  "bucketize", "auto_bucketize",
                                  "auto_bucketize_map", "percentile"])
def test_stage_runs_on_a_device_table(case):
    """On a table moved to a device (the CPU here) the output columns
    are tensors there, equal to the host table's."""
    cols = _cols(1)
    pm, pt = _fit(PORT, case, cols)
    dev = pt.to_device("cpu")
    a, b = pm.transform_column(dev), pm.transform_column(pt)
    if a.kind in ("real", "vector"):
        assert isinstance(a.values, torch.Tensor)
    np.testing.assert_array_equal(host(a.values), host(b.values))


def test_descaler_inverts_as_jax():
    cols = _cols()
    out = []
    for ns in (JAX, PORT):
        x = _feat(ns, cols, "x")
        scaled = ns.s.ScalerTransformer("linear", 4.0, 2.0).set_input(x)
        sf = scaled.get_output()
        logged = ns.s.ScalerTransformer("log").set_input(
            _feat(ns, cols, "pos"))
        table = _table(ns, cols)
        table = table.with_column(sf.name, scaled.transform_column(table))
        lf = logged.get_output()
        table = table.with_column(lf.name, logged.transform_column(table))
        d1 = ns.s.DescalerTransformer().set_input(sf, sf)
        d2 = ns.s.DescalerTransformer().set_input(lf, lf)
        out.append((d1.transform_column(table), d2.transform_column(table),
                    d1.transform_row({sf.name: 10.0}),
                    d2.transform_row({lf.name: 0.5})))
        bad = ns.s.DescalerTransformer().set_input(x, x)
        with pytest.raises(ValueError, match="no scaler metadata"):
            bad.transform_column(table)
    (j1, j2, jr1, jr2), (p1, p2, pr1, pr2) = out
    _same_column(p1, j1)
    _same_column(p2, j2)
    assert (pr1, pr2) == (jr1, jr2)


def test_bad_arguments_raise_as_jax():
    for ns in (JAX, PORT):
        with pytest.raises(ValueError, match="scaling_type"):
            ns.s.ScalerTransformer("cubic")
        with pytest.raises(ValueError, match="ascending"):
            ns.b.NumericBucketizer([3.0, 1.0])
        with pytest.raises(ValueError, match="one label per bucket"):
            ns.b.NumericBucketizer([0.0, 1.0], bucket_labels=["a", "b"])


@pytest.mark.parametrize("seed", [0, 3, 8])
@pytest.mark.parametrize("depth,gain,cands,leaf", [
    (2, 0.01, 64, 10), (5, 0.0, 16, 2), (3, 0.05, 128, 25)])
def test_decision_tree_splits_match_jax(seed, depth, gain, cands, leaf):
    rng = np.random.RandomState(seed)
    n = 500
    x = np.round(rng.randn(n) * 3, 2 if seed else 0)
    y = (rng.rand(n) < 1 / (1 + np.exp(-x))).astype(float)
    if seed == 8:
        y = np.where(y > 0, 2.0, np.where(x > 1, 1.0, 0.0))
    assert pb.decision_tree_splits(x, y, depth, gain, cands, leaf) == \
        jb.decision_tree_splits(x, y, depth, gain, cands, leaf)


def _save_cross(stage_from, pers_from, pers_to, feats):
    arrays = pers_from._Arrays()
    desc = pers_from.stage_to_json(stage_from, arrays)
    loaded = pers_to.stage_from_json(desc, arrays.store)
    loaded.input_features = feats
    loaded._output_feature = None
    return desc, loaded


@pytest.mark.parametrize("case", list(CASES))
def test_saves_cross_both_packages(case):
    """JAX save -> port load and port save -> JAX load transform as the
    saving package's model; both write the same class, module and state
    keys."""
    cols = _cols()
    jm, jt = _fit(JAX, case, cols)
    pm, pt = _fit(PORT, case, cols)
    jdesc, p_loaded = _save_cross(jm, jpers, ppers, pm.input_features)
    pdesc, j_loaded = _save_cross(pm, ppers, jpers, jm.input_features)
    assert (pdesc["module"], pdesc["className"], sorted(pdesc["state"])) \
        == (jdesc["module"], jdesc["className"], sorted(jdesc["state"]))
    p_loaded._output_feature = pm.get_output()
    j_loaded._output_feature = jm.get_output()
    _same_column(p_loaded.transform_column(pt), jm.transform_column(jt))
    _same_column(pm.transform_column(pt), j_loaded.transform_column(jt))


def test_dsl_methods_are_the_jax_list():
    assert list(port_dsl.DSL_METHODS) == list(jax_dsl.DSL_METHODS)
    from transmogrifai_tpu_torch.features import Feature
    for name in ("bucketize", "auto_bucketize", "auto_bucketize_map",
                 "fill_missing_with_mean", "zscore", "scale", "descale",
                 "percentile_calibrate", "to_isotonic_calibrated"):
        assert callable(getattr(Feature, name)), name


@pytest.mark.parametrize("name", [
    "bucketize", "auto_bucketize", "fill_missing_with_mean", "zscore",
    "scale", "descale", "percentile_calibrate", "auto_bucketize_map",
    "to_isotonic_calibrated"])
def test_dsl_method_builds_the_jax_stage(name):
    """Each method's stage in both packages: the same class, uid order,
    output name and type, on ``test_dsl_surface``'s features."""
    from transmogrifai_tpu.features import reset_uids as jreset
    from transmogrifai_tpu_torch.features import reset_uids as preset
    outs = []
    for reset, FB in ((jreset, JFB), (preset, PFB)):
        reset()
        fs = {n: (getattr(FB, t)(n).extract_field().as_response()
                  if n == "y" else
                  getattr(FB, t)(n).extract_field().as_predictor())
              for n, t in (("y", "RealNN"), ("a", "Real"), ("rn", "RealNN"),
                           ("rm", "RealMap"))}
        f = surface.BUILDERS[name](fs)
        outs.append((f.name, f.type_name, type(f.origin_stage).__name__,
                     [p.name for p in f.parents]))
    assert outs[1] == outs[0]
