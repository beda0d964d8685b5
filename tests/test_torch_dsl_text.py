"""The port's feature DSL against the JAX package's on the CPU.

``DSL_METHODS`` is the JAX package's list (the scalers', bucketizers' and
calibrators' nine are held on their own in
``test_torch_scalers_bucketizers.py``); every method of the port's list is built by
``tests/test_dsl_surface.py``'s builder on that file's table in both
packages (the port's table from python lists, no pandas), trained and
scored, and the outputs compared. Tolerance: none (values, masks and
vector metadata equal).
"""
from __future__ import annotations

import dataclasses
import math
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import test_dsl_surface as surface  # noqa: E402
from transmogrifai_tpu import dsl as jax_dsl  # noqa: E402
from transmogrifai_tpu.features import (  # noqa: E402
    FeatureBuilder as JFB, reset_uids as jax_reset,
)
from transmogrifai_tpu.workflow import OpWorkflow as JWorkflow  # noqa: E402

from transmogrifai_tpu_torch import dsl as port_dsl  # noqa: E402
from transmogrifai_tpu_torch.features import (  # noqa: E402
    FeatureBuilder as PFB, reset_uids as port_reset,
)
from transmogrifai_tpu_torch.workflow import (  # noqa: E402
    OpWorkflow as PWorkflow,
)

#: the JAX package's DSL methods the port does not have: none since the
#: scalers, bucketizers and calibrators were ported
NOT_PORTED = ()


def host(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def test_dsl_methods_are_the_jax_list_less_nine():
    want = [m for m in jax_dsl.DSL_METHODS if m not in NOT_PORTED]
    assert list(port_dsl.DSL_METHODS) == want
    assert sorted(set(jax_dsl.DSL_METHODS) - set(port_dsl.DSL_METHODS)) \
        == sorted(NOT_PORTED)
    from transmogrifai_tpu_torch.features import Feature
    for name in port_dsl.DSL_METHODS:
        assert callable(getattr(Feature, name)), name


def _records():
    """``test_dsl_surface.DF`` as python records (NaN missing -> None)."""
    cols = {c: surface.DF[c].tolist() for c in surface.DF.columns}

    def plain(v):
        if isinstance(v, float) and math.isnan(v):
            return None
        return v
    return [{c: plain(cols[c][i]) for c in cols} for i in range(surface.N)]


def _feats(FB):
    def f(name, type_name):
        return getattr(FB, type_name)(name).extract_field()
    out = {}
    for name, kind in (("y", "RealNN"), ("a", "Real"), ("rn", "RealNN"),
                       ("t", "Text"), ("t2", "Text"), ("pk", "PickList"),
                       ("e", "Email"), ("u", "URL"), ("p", "Phone"),
                       ("d", "Date"), ("dl", "DateList"),
                       ("mpl", "MultiPickList"), ("mpl2", "MultiPickList"),
                       ("tm", "TextMap"), ("b64", "Base64"),
                       ("tl", "TextList"), ("rm", "RealMap"),
                       ("pm", "PhoneMap"), ("dm", "DateMap")):
        g = f(name, kind)
        out[name] = g.as_response() if name == "y" else g.as_predictor()
    return out


def _value(v):
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, set):
        return sorted(v)
    return v


@pytest.mark.parametrize("name", list(port_dsl.DSL_METHODS))
def test_dsl_method_matches_jax(name):
    """The method's output feature, trained and scored in both packages
    on the surface table: same name, type, values, mask and metadata."""
    outs = []
    for reset, FB, wf_cls, data in (
            (jax_reset, JFB, JWorkflow, None),
            (port_reset, PFB, PWorkflow, _records())):
        reset()
        f = surface.BUILDERS[name](_feats(FB))
        if data is None:
            model = wf_cls().set_input_dataset(surface.DF) \
                .set_result_features(f).train()
            scored = model.score(df=surface.DF)
        else:
            model = wf_cls(device="cpu").set_input_dataset(data) \
                .set_result_features(f).train()
            scored = model.score(data=data)
        outs.append((f, scored[f.name]))
    (jf, jc), (pf, pc) = outs
    assert (pf.name, pf.type_name) == (jf.name, jf.type_name)
    jv, pv = host(jc.values), host(pc.values)
    if jv.dtype == object or pv.dtype == object:
        assert [_value(v) for v in pv] == [_value(v) for v in jv]
    else:
        np.testing.assert_array_equal(pv, jv)
        assert pv.dtype == jv.dtype
    jm = None if jc.mask is None else host(jc.mask).astype(bool)
    pm = None if pc.mask is None else host(pc.mask).astype(bool)
    if jm is not None or pm is not None:
        ones = np.ones(len(jv), bool)
        np.testing.assert_array_equal(ones if pm is None else pm,
                                      ones if jm is None else jm)
    jvm, pvm = (c.metadata.get("vector_meta") for c in (jc, pc))
    assert (jvm is None) == (pvm is None)
    if jvm is not None:
        assert [dataclasses.asdict(c) for c in pvm.columns] == \
            [dataclasses.asdict(c) for c in jvm.columns]
