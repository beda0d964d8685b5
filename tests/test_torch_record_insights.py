"""The port's record insights against the JAX package's on the CPU:
``RecordInsightsLOCO`` and ``RecordInsightsCorr`` on
``tests/test_insights.py``'s frame, with an LR winner and an RF winner.

Tolerances, measured here (the tests print the gaps):

* LOCO diffs: ``LOCO_ATOL`` = 1e-6 absolute. The two packages add a
  score's terms in other orders: the LR's dot product, and the JAX
  package's CPU forest, which sums its trees inside a GEMM whose
  blocking depends on the row count, while the port sums them in order
  (measured: 1.19e-7 with either winner, one float32 ulp at 1). A map is
  compared on the entries whose |diff| clears the tolerance
  (``testing.loco_map_gaps``).
* The platform order difference: for a group that no tree splits on,
  the port's diff is exactly 0 and its map has no entry; the JAX
  package's base (n rows) and variant (g*n rows) scores can differ in
  the last bit, so its map may hold a near-zero entry. Pinned by
  ``test_rf_groups_no_tree_uses_are_exact_zeros_in_the_port``.
* Corr contributions: ``CORR_ATOL`` = 1e-5 (the correlations are float32
  sums in other orders; measured 1e-6 with either winner).
"""
from __future__ import annotations

import os
import sys
from types import SimpleNamespace

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pandas as pd
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import transmogrifai_tpu  # noqa: E402,F401
from transmogrifai_tpu.features import (  # noqa: E402
    FeatureBuilder as JFB, reset_uids as jax_reset,
)
from transmogrifai_tpu.impl.feature.transmogrifier import (  # noqa: E402
    transmogrify as jtr,
)
from transmogrifai_tpu.impl.selector.factories import (  # noqa: E402
    BinaryClassificationModelSelector as JSel,
)
from transmogrifai_tpu.insights import record_insights as jri  # noqa: E402
from transmogrifai_tpu.workflow import OpWorkflow as JWF  # noqa: E402

import transmogrifai_tpu_torch  # noqa: E402,F401
from transmogrifai_tpu_torch.features import (  # noqa: E402
    FeatureBuilder as PFB, reset_uids as port_reset,
)
from transmogrifai_tpu_torch.impl.feature.transmogrifier import (  # noqa: E402
    transmogrify as ptr,
)
from transmogrifai_tpu_torch.impl.selector.factories import (  # noqa: E402
    BinaryClassificationModelSelector as PSel,
)
from transmogrifai_tpu_torch.insights import (  # noqa: E402
    RecordInsightsCorr, RecordInsightsLOCO, TopKMaps,
)
from transmogrifai_tpu_torch.insights import record_insights as pri  # noqa: E402
from transmogrifai_tpu_torch.testing import loco_map_gaps  # noqa: E402
from transmogrifai_tpu_torch.workflow import OpWorkflow as PWF  # noqa: E402

LOCO_ATOL = 1e-6
CORR_ATOL = 1e-5
MODELS = {
    "lr": [("OpLogisticRegression", None)],
    "rf": [("OpRandomForestClassifier",
            [{"maxDepth": 5, "numTrees": 8, "minInstancesPerNode": 5}])],
}


def host(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _frame():
    """``tests/test_insights.py``'s frame, with a constant-ish column no
    tree uses."""
    rng = np.random.RandomState(5)
    n = 400
    strong, weak, noise = rng.randn(n), rng.randn(n), rng.randn(n)
    y = ((2.0 * strong + 0.3 * weak + 0.5 * rng.randn(n)) > 0).astype(float)
    return {"y": y, "strong": strong, "weak": weak, "noise": noise,
            "flat": np.where(rng.rand(n) < 0.02, 1.0, 0.0)}


def _train(key):
    data = _frame()
    out = []
    for reset, FB, tr, Sel, wf, frame in (
            (jax_reset, JFB, jtr, JSel, JWF(), pd.DataFrame(data)),
            (port_reset, PFB, ptr, PSel, PWF(device="cpu"), data)):
        reset()
        yf = FB.RealNN("y").extract_field().as_response()
        fs = [FB.Real(c).extract_field().as_predictor()
              for c in ("strong", "weak", "noise", "flat")]
        checked = tr(fs).sanity_check(yf, min_variance=1e-6)
        pred = (Sel.with_train_validation_split(seed=7, models=MODELS[key])
                .set_input(yf, checked).get_output())
        model = wf.set_input_dataset(frame).set_result_features(
            pred, checked).train()
        scored = model.score(df=frame) if isinstance(frame, pd.DataFrame) \
            else model.score(data=frame)
        sel = model.get_stage(pred.origin_stage.uid)
        vec = sel.input_features[1]
        out.append(SimpleNamespace(model=model, scored=scored, sel=sel,
                                   vec=vec, pred=pred, frame=frame))
    return out


@pytest.fixture(scope="module", params=["lr", "rf"])
def trained(request):
    j, p = _train(request.param)
    return SimpleNamespace(key=request.param, j=j, p=p)


def jax_loco_diffs(loco, table):
    """(group names, (g, n) diffs) of the JAX package's LOCO: its
    ``transform_column`` up to the top-k step, with its chunking (the JAX
    CPU forest's tree sums depend on the row count, so the chunks must be
    the same)."""
    import jax.numpy as jnp
    from transmogrifai_tpu.models.api import MODEL_REGISTRY
    col = table[loco.input_features[0].name]
    X = np.asarray(col.values, dtype=np.float32)
    n, d = X.shape
    groups = loco._groups(col.metadata.get("vector_meta"), d)
    g = len(groups)
    fitted = loco.model_stage.fitted
    family = MODEL_REGISTRY[fitted.family]
    Xd = jnp.asarray(X)
    base = jri._score_of(family.predict_one(fitted, Xd))
    keep = np.ones((g, d), np.float32)
    for v, (_, idxs) in enumerate(groups):
        keep[v, idxs] = 0.0
    keep_d = jnp.asarray(keep)
    rows_per_block = max(1, int(loco.VARIANT_BLOCK_BYTES // (4 * d)))
    gc = max(1, min(g, rows_per_block // max(n, 1)) or 1)
    rc = min(n, rows_per_block)
    diffs = np.empty((g, n), np.float32)
    for g0 in range(0, g, gc):
        g1 = min(g0 + gc, g)
        for r0 in range(0, n, rc):
            r1 = min(r0 + rc, n)
            block = Xd[None, r0:r1, :] * keep_d[g0:g1, None, :]
            s = jri._score_of(family.predict_one(
                fitted, block.reshape((g1 - g0) * (r1 - r0), d)))
            diffs[g0:g1, r0:r1] = base[None, r0:r1] - s.reshape(
                g1 - g0, r1 - r0)
    return [name for name, _ in groups], diffs


def test_loco_diffs_and_maps_match_jax(trained):
    jloco = jri.RecordInsightsLOCO(trained.j.sel, top_k=3).set_input(
        trained.j.vec)
    ploco = RecordInsightsLOCO(trained.p.sel, top_k=3).set_input(
        trained.p.vec)
    jn, jd = jax_loco_diffs(jloco, trained.j.scored)
    pn, pd_ = ploco.diffs(trained.p.scored)
    assert pn == jn
    gap = float(np.abs(pd_ - jd).max())
    print(f"{trained.key}: LOCO diff gap {gap:.3g} over {jd.shape}")
    assert gap <= LOCO_ATOL
    jmaps = jloco.transform_column(trained.j.scored)
    pmaps = ploco.transform_column(trained.p.scored)
    assert isinstance(pmaps.values, TopKMaps)
    for i in range(len(pmaps.values)):
        gaps = loco_map_gaps(jd[:, i], pd_[:, i], jn, jmaps.values[i],
                             pmaps.values[i], 3, LOCO_ATOL)
        assert not gaps, (i, gaps)


def test_loco_chunks_and_row_dual(trained):
    """Tiny variant blocks give the same diffs (bounded peak), and the
    row dual gives each row's columnar map within the tolerance."""
    ploco = RecordInsightsLOCO(trained.p.sel, top_k=3).set_input(
        trained.p.vec)
    names, full = ploco.diffs(trained.p.scored)
    d = host(trained.p.scored[trained.p.vec.name].values).shape[1]
    ploco.VARIANT_BLOCK_BYTES = 4 * 8 * d
    _, chunked = ploco.diffs(trained.p.scored)
    assert ploco._peak_variant_bytes <= 4 * 8 * d
    np.testing.assert_allclose(chunked, full, rtol=0, atol=LOCO_ATOL)
    ploco.VARIANT_BLOCK_BYTES = RecordInsightsLOCO.VARIANT_BLOCK_BYTES
    cols = ploco.transform_column(trained.p.scored)
    for i in range(0, 400, 37):
        row = trained.p.scored.row(i)
        got = ploco.transform_row(row)
        assert not loco_map_gaps(full[:, i], full[:, i], names,
                                 cols.values[i], got, 3, LOCO_ATOL)


def test_rf_groups_no_tree_uses_are_exact_zeros_in_the_port():
    """The platform order difference: with an RF winner, a group that no
    tree splits on has diff exactly 0 in the port (its trees are summed
    in order, so a variant's score is the base's bit for bit); the JAX
    package's diffs there are within LOCO_ATOL of 0 and may be nonzero
    (its CPU GEMM blocks the g*n variant rows and the n base rows
    differently)."""
    j, p = _train("rf")
    jloco = jri.RecordInsightsLOCO(j.sel, top_k=20).set_input(j.vec)
    ploco = RecordInsightsLOCO(p.sel, top_k=20).set_input(p.vec)
    names, jd = jax_loco_diffs(jloco, j.scored)
    _, pd_ = ploco.diffs(p.scored)
    unused = [v for v in range(len(names)) if not pd_[v].any()]
    assert unused, "expected groups no tree splits on"
    assert np.abs(jd[unused]).max() <= LOCO_ATOL
    print(f"JAX nonzero entries in unused groups: "
          f"{int((jd[unused] != 0).sum())} of {jd[unused].size}")
    pmaps = ploco.transform_column(p.scored)
    for i in range(len(pmaps.values)):
        assert not any(names[v] in pmaps.values[i] for v in unused)


def test_corr_matches_jax(trained):
    jc = jri.RecordInsightsCorr(trained.j.sel, top_k=4).set_input(
        trained.j.vec).transform_column(trained.j.scored)
    pc = RecordInsightsCorr(trained.p.sel, top_k=4).set_input(
        trained.p.vec).transform_column(trained.p.scored)
    worst = 0.0
    for i in range(len(pc.values)):
        a, b = jc.values[i], pc.values[i]
        for k in set(a) | set(b):
            va, vb = a.get(k), b.get(k)
            if va is None or vb is None:
                # only a near-tie at the top-k boundary may differ
                assert abs(va if vb is None else vb) <= sorted(
                    map(abs, (a if vb is None else b).values()))[0] \
                    + CORR_ATOL
                continue
            worst = max(worst, abs(va - vb))
    print(f"{trained.key}: Corr contribution gap {worst:.3g}")
    assert worst <= CORR_ATOL
    with pytest.raises(ValueError, match="scoring batch"):
        RecordInsightsCorr(trained.p.sel).transform_row({})


def test_topk_maps_column_matches_jax():
    rng = np.random.RandomState(2)
    contrib = rng.randn(50, 9).astype(np.float32)
    contrib[::4, 2] = 0.0
    contrib[3] = 0.0
    contrib[5] = 0.0
    contrib[5, 1] = 1e-9
    names = [f"g{i}" for i in range(9)]
    jc = jri._topk_maps_column(names, contrib, 4)
    pc = pri._topk_maps_column(names, contrib, 4)
    assert list(pc.values) == list(jc.values)
    np.testing.assert_array_equal(pc.mask, jc.mask)
    assert pc.values[5]["g1"] == 0.0 and "g1" in pc.values[5]
    assert len(pc.values[1:3]) == 2 and pc.values.shape == (50,)


def _with_insights(model, sel, vec, compute_dag):
    """The trained model with a LOCO and a Corr column among its
    results."""
    loco = RecordInsightsLOCO if compute_dag.__module__.startswith(
        "transmogrifai_tpu_torch") else jri.RecordInsightsLOCO
    corr = RecordInsightsCorr if loco is RecordInsightsLOCO \
        else jri.RecordInsightsCorr
    lo = loco(sel, top_k=3).set_input(vec).get_output()
    co = corr(sel, top_k=2).set_input(vec).get_output()
    model.result_features = tuple(model.result_features) + (lo, co)
    model._layers = compute_dag(model.result_features)
    return lo, co


def test_stage_refs_save_and_load_across_packages(tmp_path):
    """A model holding LOCO and Corr saves their ``model_stage`` as a
    ``__stage_ref__``; loading re-links it to the loaded SelectedModel,
    in the port and across the packages, and the reload's insights equal
    the saving model's."""
    import transmogrifai_tpu_torch as port
    from transmogrifai_tpu.dag import compute_dag as jdag
    from transmogrifai_tpu.persistence import load_model as jload
    from transmogrifai_tpu.persistence import save_model as jsave
    from transmogrifai_tpu_torch.dag import compute_dag as pdag
    j, p = _train("lr")
    plo, pco = _with_insights(p.model, p.sel, p.vec, pdag)
    jlo, jco = _with_insights(j.model, j.sel, j.vec, jdag)
    ppath, jpath = str(tmp_path / "p"), str(tmp_path / "j")
    p.model.save(ppath)
    os.environ["TG_AOT_SAVE"] = "0"
    try:
        jsave(j.model, jpath)
    finally:
        os.environ.pop("TG_AOT_SAVE", None)
    import json
    with open(os.path.join(ppath, "plan.json")) as fh:
        plan = json.load(fh)
    st = next(d for d in plan["stages"]
              if d["className"] == "RecordInsightsLOCO")
    assert st["module"] == "transmogrifai_tpu.insights.record_insights"
    assert st["state"]["model_stage"] == {"__stage_ref__": p.sel.uid}
    want = p.model.score(data=p.frame)
    for path in (ppath, jpath):
        loaded = port.load_model(path, device="cpu")
        lstage = next(s for s in loaded.stages
                      if type(s).__name__ == "RecordInsightsLOCO")
        assert lstage.model_stage is loaded.get_stage(lstage.model_stage.uid)
        got = loaded.score(data=p.frame)
        if path == ppath:
            assert list(got[plo.name].values) == list(want[plo.name].values)
            assert list(got[pco.name].values) == list(want[pco.name].values)
    back = jload(ppath)
    bstage = next(s for s in back.stages
                  if type(s).__name__ == "RecordInsightsLOCO")
    assert bstage.model_stage is back.get_stage(p.sel.uid)
    jgot = back.score(df=j.frame)[plo.name].values
    pw = want[plo.name].values
    for i in range(0, 400, 10):
        a, b = jgot[i], pw[i]
        for k in set(a) | set(b):
            if k in a and k in b:
                assert abs(a[k] - b[k]) <= LOCO_ATOL + 1e-6
            else:
                assert abs(a.get(k, b.get(k))) <= LOCO_ATOL + 1e-6
