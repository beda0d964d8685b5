"""The MLP family, ``rng.normal`` and the isotonic calibrator of the
PyTorch port against the JAX package on the CPU.

Tolerances, each with its cause:

* ``rng.normal``, the MLP's initial weights, ``pav_fit`` and the
  calibrator's interpolation: none, bit for bit (the same float32
  operations in the same order: XLA's ``erf_inv`` and its folded scale,
  host float64 PAV, ``jnp.interp``'s fused slope);
* one Adam step from the same weights: 1e-6 absolute (the gradient's
  float32 matmuls add in another order than XLA's);
* a whole fit (100 Adam steps): every parameter within ``FIT_RTOL`` of
  the largest |parameter| of its table, the probabilities within
  ``PROB_ATOL``: the same rounding differences, carried through the steps
  (measured 6.9e-6 and 1.2e-7 on these frames).
"""
from __future__ import annotations

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from transmogrifai_tpu.features import FeatureBuilder as JFB  # noqa: E402
from transmogrifai_tpu.impl.regression import (  # noqa: E402
    IsotonicRegressionCalibrator as JIso,
)
from transmogrifai_tpu.impl.regression.isotonic import (  # noqa: E402
    pav_fit as jax_pav_fit,
)
from transmogrifai_tpu.models import mlp as JM  # noqa: E402
from transmogrifai_tpu.models.api import (  # noqa: E402
    MODEL_REGISTRY as JAX_REGISTRY,
)
from transmogrifai_tpu.table import (  # noqa: E402
    Column as JColumn, FeatureTable as JTable,
)
from transmogrifai_tpu.types import RealNN as JRealNN  # noqa: E402

from transmogrifai_tpu_torch import rng  # noqa: E402
from transmogrifai_tpu_torch.features import (  # noqa: E402
    FeatureBuilder as PFB,
)
from transmogrifai_tpu_torch.impl.regression import (  # noqa: E402
    IsotonicRegressionCalibrator as PIso, pav_fit,
)
from transmogrifai_tpu_torch.impl.selector.model_selector import (  # noqa: E402,E501
    DEFAULT_MODELS,
)
from transmogrifai_tpu_torch.models import mlp as PM  # noqa: E402
from transmogrifai_tpu_torch.models.api import MODEL_REGISTRY  # noqa: E402
from transmogrifai_tpu_torch.ops.xla_cpu import xla_erf_inv  # noqa: E402
from transmogrifai_tpu_torch.table import (  # noqa: E402
    Column as PColumn, FeatureTable as PTable,
)
from transmogrifai_tpu_torch.testing import (  # noqa: E402
    CALIBRATED_KEY, calibration_labels,
)
from transmogrifai_tpu_torch.types import RealNN as PRealNN  # noqa: E402

NAME = "OpMultilayerPerceptronClassifier"
FIT_RTOL = 5e-5
PROB_ATOL = 1e-6
STEP_ATOL = 1e-6


def _bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32)


def _blobs(n=300, seed=0, classes=2):
    """``tests/test_mlp.py``'s frames."""
    rng_ = np.random.RandomState(seed)
    centers = rng_.randn(classes, 4) * 3
    y = rng_.randint(0, classes, n)
    X = centers[y] + rng_.randn(n, 4).astype(np.float32)
    return X.astype(np.float32), y.astype(np.float32)


# -- the normal draw --------------------------------------------------------

@pytest.mark.parametrize("seed,shape", [(0, (10000,)), (7, (64, 50)),
                                        (42, (50, 50)), (123456, (3, 5, 7)),
                                        (2 ** 31 - 1, (4096,))])
def test_normal_is_jax_random_normal_bit_for_bit(seed, shape):
    want = jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32)
    got = rng.normal(rng.prng_key(torch.tensor(seed)), shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_normal_with_a_folded_scale_is_xlas():
    """XLA folds a constant factor into the normal's sqrt(2)."""
    key = jax.random.PRNGKey(3)
    want = jax.jit(lambda k: jax.random.normal(k, (2000,), jnp.float32)
                   * jnp.sqrt(2.0 / 114).astype(jnp.float32))(key)
    got = rng.normal(rng.prng_key(torch.tensor(3)), (2000,),
                     float(np.sqrt(np.float32(2.0 / 114))))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_erf_inv_at_the_ends_of_the_uniforms_range():
    """The least uniform (nextafter(-1, 0)), values near +-1 where
    w = -log1p(-x^2) passes 5, the branch point and 0."""
    lo = np.nextafter(np.float32(-1), np.float32(0))
    x = np.array([lo, -0.9999999, -0.99999, -0.9933, -0.5, -1e-7, 0.0,
                  1e-30, 0.25, 0.99326, 0.9999, 0.99999994], np.float32)
    x = np.concatenate([x, np.linspace(-0.999999, 0.999999, 20001,
                                       dtype=np.float32)])
    want = jax.jit(jax.scipy.special.erfinv)(x)
    np.testing.assert_array_equal(_bits(xla_erf_inv(torch.tensor(x))),
                                  _bits(want))


# -- the MLP family ---------------------------------------------------------

def test_mlp_is_registered_and_off_by_default():
    fam = MODEL_REGISTRY[NAME]
    assert fam.supports == JAX_REGISTRY[NAME].supports
    for problem in ("binary", "multiclass"):
        assert fam.default_grid(problem) == JAX_REGISTRY[NAME].default_grid(
            problem)
    assert all(NAME not in names for names in DEFAULT_MODELS.values())


@pytest.mark.parametrize("seed,d,h,nc", [(42, 4, 10, 2), (43, 64, 50, 6),
                                         (7, 3, 100, 3)])
def test_init_is_the_jax_packages_bit_for_bit(seed, d, h, nc):
    want = jax.jit(lambda k: JM._init(k, d, h, nc, jnp.float32))(
        jax.random.PRNGKey(seed))
    got = PM._init(torch.tensor([seed], dtype=torch.int32), d, h, nc)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(_bits(g[0]), _bits(w))


def _jax_loss(params, X, Y, w, masks):
    lp = jax.nn.log_softmax(JM._forward(params, X, masks), axis=-1)
    return (-(Y * lp).sum(axis=1) * w).sum() / jnp.maximum(w.sum(), 1.0)


def test_gradient_and_one_adam_step_match_jax():
    X, y = _blobs(classes=3, seed=1)
    w = np.ones(len(y), np.float32)
    w[::5] = 0.0
    h, nc, step = 16, 3, np.float32(0.05)
    params = jax.jit(lambda k: JM._init(k, 4, h, nc, jnp.float32))(
        jax.random.PRNGKey(42))
    masks = (jnp.asarray((np.arange(h) < 16).astype(np.float32)),
             jnp.asarray((np.arange(h) < 8).astype(np.float32)))
    Y = jax.nn.one_hot(jnp.asarray(y, jnp.int32), nc)

    @jax.jit
    def jax_step(params):
        g = jax.grad(_jax_loss)(params, jnp.asarray(X), Y, jnp.asarray(w),
                                masks)
        m = jax.tree_util.tree_map(lambda b: (1 - 0.9) * b, g)
        v = jax.tree_util.tree_map(lambda b: (1 - 0.999) * b * b, g)
        t = jnp.float32(1.0)
        new = jax.tree_util.tree_map(
            lambda p, mm, vv: p - step * (mm / (1 - 0.9 ** t)) / (
                jnp.sqrt(vv / (1 - 0.999 ** t)) + 1e-8), params, m, v)
        return g, new

    g_want, p_want = jax_step(params)
    leaves = [torch.tensor(np.asarray(p))[None].requires_grad_(True)
              for p in params]
    pm = tuple(torch.tensor(np.asarray(m))[None] for m in masks)
    Yp = torch.tensor(np.asarray(Y))
    loss = PM._loss(leaves, torch.tensor(X), Yp, torch.tensor(w)[None],
                    torch.tensor([float(w.sum())]), pm)
    g_got = torch.autograd.grad(loss, leaves)
    zeros = tuple(torch.zeros_like(p) for p in leaves)
    p_got, _, _ = PM.adam_step(tuple(p.detach() for p in leaves), zeros,
                               zeros, g_got, 1, torch.tensor([step]))
    for a, b in zip(g_got, g_want):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-7)
    for a, b in zip(p_got, p_want):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b), rtol=0,
                                   atol=STEP_ATOL)


FIT_CASES = {
    "binary_default_grid": (2, None, 0),
    "three_classes": (3, [{"hiddenLayer1": 16, "hiddenLayer2": 8,
                           "stepSize": 0.05}], 1),
    "masked_widths": (2, [{"hiddenLayer1": 2, "hiddenLayer2": 2,
                           "stepSize": 0.05},
                          {"hiddenLayer1": 32, "hiddenLayer2": 32,
                           "stepSize": 0.05}], 2),
}


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_fit_and_predict_batch_match_jax(case):
    classes, grid, seed = FIT_CASES[case]
    X, y = _blobs(classes=classes, seed=seed)
    jf, pf = JAX_REGISTRY[NAME], MODEL_REGISTRY[NAME]
    grid = grid or jf.default_grid("binary")
    W = np.ones((len(grid), len(y)), np.float32)
    W[:, ::7] = 0.0                       # rows a fold leaves out
    want = jf.fit_batch(jnp.asarray(X), jnp.asarray(y), jnp.asarray(W),
                        jf.grid_to_arrays(grid), classes)
    got = pf.fit_batch(torch.tensor(X), torch.tensor(y), torch.tensor(W),
                       pf.grid_to_arrays(grid), classes)
    assert got["num_classes"] == want["num_classes"]
    for a, b in zip(got["masks"], want["masks"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(got["params"], want["params"]):
        b = np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=FIT_RTOL * np.abs(b).max())
    ps = pf.predict_batch(got, torch.tensor(X), classes).numpy()
    js = np.asarray(jf.predict_batch(want, jnp.asarray(X), classes))
    np.testing.assert_allclose(ps, js, rtol=0, atol=PROB_ATOL)
    one = pf.select_params(got, len(grid) - 1)
    fitted = type("F", (), {"params": one})
    parts = pf.predict_parts(fitted, torch.tensor(X))
    probs = ps[-1] if classes > 2 else np.stack([1 - ps[-1], ps[-1]], 1)
    np.testing.assert_allclose(parts["probability"].numpy(), probs,
                               rtol=0, atol=PROB_ATOL)
    np.testing.assert_array_equal(parts["prediction"].numpy(),
                                  parts["probability"].numpy().argmax(1))


def test_params_round_trip_the_jax_saved_layout():
    """``params_from_numpy`` / ``params_to_numpy`` of the committed MLP
    fixture's saved params give back its arrays, dtypes and layout."""
    from transmogrifai_tpu_torch.persistence import _read
    path = os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures",
                        "serve64", "mlp")
    plan, arrays = _read(path)
    sel = next(s for s in plan["stages"] if s["className"] ==
               "SelectedModel")
    saved = sel["state"]["fitted"]["state"]["params"]["__dict__"]
    want = {"params": tuple(arrays[a["__array__"]]
                            for a in saved["params"]["__tuple__"]),
            "masks": tuple(arrays[a["__array__"]]
                           for a in saved["masks"]["__tuple__"]),
            "num_classes": saved["num_classes"]}
    fam = MODEL_REGISTRY[NAME]
    back = fam.params_to_numpy(fam.params_from_numpy(want, "cpu"))
    assert sorted(back) == sorted(want) and back["num_classes"] == 2
    for k in ("params", "masks"):
        assert isinstance(back[k], tuple) and len(back[k]) == len(want[k])
        for a, b in zip(back[k], want[k]):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


# -- the isotonic calibrator ------------------------------------------------

def test_pav_fit_is_the_jax_packages_bit_for_bit():
    """``tests/test_glm_isotonic.py``'s PAV input, ties and weights."""
    r = np.random.RandomState(3)
    s = r.rand(200).astype(np.float32)
    y = (r.rand(200) < s).astype(np.float32)
    cases = [(s, y, None), (np.round(s, 1), y, None),
             (s, y, r.rand(200).astype(np.float32) + 0.1),
             (s, np.zeros_like(y), None), (s[:1], y[:1], None)]
    for scores, labels, weights in cases:
        for a, b in zip(pav_fit(scores, labels, weights),
                        jax_pav_fit(scores, labels, weights)):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("isotonic", [True, False])
def test_calibrator_is_the_jax_packages_bit_for_bit(isotonic):
    """``tests/test_glm_isotonic.py``'s calibrator input, both
    directions, with scores outside the fitted range and on its
    boundaries."""
    r = np.random.RandomState(4)
    n = 300
    s = r.rand(n).astype(np.float32)
    y = (r.rand(n) < (s ** 2 if isotonic else 1 - s)).astype(np.float32)
    models = []
    for B, Col, Tab, T, Iso in ((JFB, JColumn, JTable, JRealNN, JIso),
                                (PFB, PColumn, PTable, PRealNN, PIso)):
        label = B.RealNN("label").extract_field().as_response()
        score = B.RealNN("score").extract_field().as_predictor()
        est = Iso(isotonic=isotonic)
        est.set_input(label, score).get_output()
        tbl = Tab({"label": Col(T, y, None), "score": Col(T, s, None)}, n)
        models.append(est.fit(tbl))
    jm, pm = models
    np.testing.assert_array_equal(pm.boundaries, jm.boundaries)
    np.testing.assert_array_equal(pm.values, jm.values)
    assert pm.summary_metadata == jm.summary_metadata
    probe = np.concatenate([s, jm.boundaries, [-0.5, 0.0, 1.0, 2.0]]
                           ).astype(np.float32)
    m = len(probe)
    jt = JTable({"label": JColumn(JRealNN, np.zeros(m, np.float32), None),
                 "score": JColumn(JRealNN, probe, None)}, m)
    pt = PTable({"label": PColumn(PRealNN, np.zeros(m, np.float32), None),
                 "score": PColumn(PRealNN, probe, None)}, m
                ).to_device("cpu")
    got = pm.transform_column(pt).values
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(_bits(got),
                                  _bits(jm.transform_column(jt).values))
    for v in (float(s[0]), 0.5, -1.0, None):
        row = {"label": None, "score": v}
        assert pm.transform_row(row) == jm.transform_row(row)


def test_calibrator_fixture_is_reproduced_bit_for_bit():
    """The committed ``calibration.npz`` (the JAX package's fit to the
    ``mlp`` fixture's probability_1): the port's ``pav_fit`` and
    interpolation give its bits."""
    from transmogrifai_tpu_torch.impl.regression.isotonic import (
        IsotonicCalibratorModel,
    )
    path = os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures",
                        "serve64", CALIBRATED_KEY)
    p1 = np.load(os.path.join(path, "expected.npz"))["probability_1"]
    cal = np.load(os.path.join(path, "calibration.npz"))
    b, v = pav_fit(p1, calibration_labels(p1))
    np.testing.assert_array_equal(b, cal["boundaries"])
    np.testing.assert_array_equal(v, cal["values"])
    model = IsotonicCalibratorModel(b, v)
    out = model._interp(torch.tensor(p1))
    np.testing.assert_array_equal(_bits(out), _bits(cal["calibrated"]))
    # between the breakpoints the slope times delta and the add round
    # once, as XLA fuses them (unfused, ~0.3% of these values differ)
    u = np.random.RandomState(0).rand(100_000).astype(np.float32)
    want = jnp.interp(jnp.asarray(u), jnp.asarray(b), jnp.asarray(v))
    np.testing.assert_array_equal(_bits(model._interp(torch.tensor(u))),
                                  _bits(want))
