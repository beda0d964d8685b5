"""Contract specs for a user's own stages (counterpart of
``transmogrifai_tpu.test.specs``): subclass ``OpTransformerSpec`` or
``OpEstimatorSpec``, return the wired stage, its input table and the
expected output values (or None) from ``build``, and pytest checks the
stage's naming and typing, the columnar path against the expected values
and the row dual, and a save and load of its state.

Usage::

    class TestMyStage(OpTransformerSpec):
        @classmethod
        def build(cls):
            f = FeatureBuilder.Real("x").extract_field().as_predictor()
            stage = MyStage().set_input(f)
            table = FeatureTable.from_columns({"x": (Real, [1.0, None])})
            return stage, table, [2.0, None]
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import numpy as np
import pytest

from ..stages.base import Estimator, OpPipelineStage, Transformer
from ..table import Column, FeatureTable


def _cell(col: Column, i: int) -> Any:
    if not col.valid_mask()[i]:
        return None
    v = col.host_values()[i]
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v.item() if isinstance(v, np.generic) else v


def _norm_empty(v: Any) -> Any:
    """The FeatureTable's missing semantics conflate empty collections with
    null (table._is_missing) — row duals may surface []/{} where the columnar
    path surfaces None; both mean "empty" (reference SomeValue). Applied ONLY
    to the row/columnar parity comparison — explicit expected values stay
    strict."""
    if isinstance(v, (list, set, dict, tuple)) and len(v) == 0:
        return None
    return v


def _approx_equal(a: Any, b: Any) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_approx_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return set(a) == set(b) and all(_approx_equal(a[k], b[k]) for k in a)
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return bool(np.isclose(float(a), float(b), rtol=1e-5, atol=1e-6))
    return a == b


class _SpecBase:
    """Shared plumbing; subclasses implement build()."""

    @classmethod
    def build(cls) -> Tuple[OpPipelineStage, FeatureTable, Optional[Sequence[Any]]]:
        raise NotImplementedError("spec subclasses must implement build()")

    @pytest.fixture(scope="class")
    def spec(self):
        return type(self).build()

    # -- stage contract (reference OpPipelineStageSpec) ----------------------
    def test_stage_naming(self, spec):
        stage, table, _ = spec
        assert stage.uid.startswith(type(stage).__name__ + "_")
        out = stage.get_output()
        assert out.origin_stage is stage
        assert out.feature_type is stage.output_type

    def test_input_wiring(self, spec):
        stage, table, _ = spec
        assert stage.input_features, "spec stage must have wired inputs"
        for f in stage.input_features:
            assert f.name in table.column_names, (
                f"input feature '{f.name}' missing from the spec table")


class OpTransformerSpec(_SpecBase):
    """Contract for transformers (reference OpTransformerSpec): columnar
    transform matches expected values, and the row dual agrees with the
    columnar path on every row."""

    #: set False for stages whose row dual legitimately differs (e.g. needs
    #: batch-level metadata)
    check_row_parity: bool = True

    def _transformer(self, spec) -> Tuple[Transformer, FeatureTable]:
        stage, table, _ = spec
        assert isinstance(stage, Transformer), "use OpEstimatorSpec for estimators"
        return stage, table

    def test_transform(self, spec):
        stage, table = self._transformer(spec)
        _, _, expected = spec
        out = stage.transform_column(table)
        assert len(out) == len(table)
        if expected is not None:
            got = [_cell(out, i) for i in range(len(out))]
            for i, (g, e) in enumerate(zip(got, expected)):
                assert _approx_equal(g, e), f"row {i}: got {g!r}, want {e!r}"

    def test_row_columnar_parity(self, spec):
        stage, table = self._transformer(spec)
        if not self.check_row_parity:
            pytest.skip("row parity disabled for this stage")
        out = stage.transform_column(table)
        for i in range(len(table)):
            row_val = _norm_empty(stage.transform_row(table.row(i)))
            col_val = _norm_empty(_cell(out, i))
            assert _approx_equal(row_val, col_val), (
                f"row {i}: transform_row={row_val!r} vs columnar={col_val!r}")

    def test_serialization_round_trip(self, spec):
        stage, table = self._transformer(spec)
        from ..persistence import _Arrays, stage_from_json, stage_to_json
        arrays = _Arrays()
        desc = stage_to_json(stage, arrays)
        loaded = stage_from_json(desc, arrays.store)
        unresolved = [k for k, v in vars(loaded).items()
                      if type(v).__name__ in ("Unresolved", "_StageRef")]
        if unresolved:
            pytest.skip(f"stage holds unserializable state {unresolved} "
                        f"(resolved from the workflow at load time)")
        loaded.input_features = stage.input_features
        loaded._output_feature = stage._output_feature
        out1 = stage.transform_column(table)
        out2 = loaded.transform_column(table)
        for i in range(len(table)):
            a, b = _cell(out1, i), _cell(out2, i)
            assert _approx_equal(a, b), (
                f"row {i} after round-trip: {a!r} != {b!r}")


class OpEstimatorSpec(_SpecBase):
    """Contract for estimators (reference OpEstimatorSpec:55-142): fit yields
    a Transformer that reuses the estimator's uid/output feature, and the
    fitted model passes the transformer contract."""

    check_row_parity: bool = True

    @pytest.fixture(scope="class")
    def fitted(self, spec):
        stage, table, _ = spec
        assert isinstance(stage, Estimator), "use OpTransformerSpec for transformers"
        return stage.fit(table)

    def test_fit_returns_transformer(self, spec, fitted):
        stage, table, _ = spec
        assert isinstance(fitted, Transformer)
        assert fitted.uid == stage.uid, "model must reuse the estimator uid"
        assert fitted.get_output() is stage.get_output()

    def test_model_transform(self, spec, fitted):
        stage, table, expected = spec
        out = fitted.transform_column(table)
        assert len(out) == len(table)
        if expected is not None:
            got = [_cell(out, i) for i in range(len(out))]
            for i, (g, e) in enumerate(zip(got, expected)):
                assert _approx_equal(g, e), f"row {i}: got {g!r}, want {e!r}"

    def test_model_row_parity(self, spec, fitted):
        if not self.check_row_parity:
            pytest.skip("row parity disabled for this stage")
        stage, table, _ = spec
        out = fitted.transform_column(table)
        for i in range(len(table)):
            row_val = _norm_empty(fitted.transform_row(table.row(i)))
            col_val = _norm_empty(_cell(out, i))
            assert _approx_equal(row_val, col_val), (
                f"row {i}: transform_row={row_val!r} vs columnar={col_val!r}")
