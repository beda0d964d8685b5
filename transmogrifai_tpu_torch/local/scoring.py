"""Serve-time scoring of a fitted model (counterpart of
``transmogrifai_tpu.local.scoring``).

Every scorer builds a host table from request rows (each raw feature's
extract function on each row, the label's too), scores it on the model's
device through the same columnar pass as ``OpWorkflowModel.score``, and
hands back plain python records: a Prediction as ``{key: float}``.

* :func:`serve_table_builder` — the request-to-table front shared by the
  scorers, the serving runtime and the warm-start fingerprint; homogeneous
  numeric batches take one numpy sweep, anything else the exact per-cell
  path (byte-identical by construction).
* :func:`compiled_score_function` — the schema-guarded columnar pass: a
  descriptive :class:`ScoreSchemaError` *before* any data reaches the
  card, then the model's stages as a plan (``plan.py``: host waves and
  one program per device segment, a CUDA graph per bucket on the card),
  or as ``model.score`` runs them where no plan applies or a planned run
  fell back.
* :class:`ServeStages` — the same pass cut into gather / dispatch /
  flatten for the pipelined serving dataplane (``serving/runtime.py``);
  on CUDA it stages through pooled pinned buffers on its own stream.
* :func:`micro_batch_score_function` — one pass per batch with per-row
  quarantine; :func:`score_function` — one request row.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..observability import metrics as _obs_metrics
from ..observability.trace import span as _obs_span
from ..table import DEVICE_KINDS, Column, FeatureTable, column_of_scalars

logger = logging.getLogger(__name__)

#: per-row error key of micro-batch quarantine: the row could not be
#: scored, its result features are None and this key says why
SCORE_ERROR_KEY = "__score_error__"

_SCALAR_KINDS = ("real", "binary", "integral", "date")


class ScoreSchemaError(ValueError):
    """Serve-time input does not match the fitted schema (missing column,
    unconvertible dtype, wrong vector width). Raised with the offending
    column and the expected-vs-actual detail *before* the data reaches the
    device."""


def _scalars_or_none(feature_type, raw) -> Optional[Column]:
    """``column_of_scalars`` of a homogeneous numeric batch, or None when
    the batch is not one (a string, a wrapper, a nested value): the
    caller then takes the exact per-cell path."""
    try:
        vals = np.asarray(raw, dtype=np.float64)
    except (TypeError, ValueError):
        return None
    if vals.shape != (len(raw),):
        return None
    return column_of_scalars(feature_type, vals)


def serve_table_builder(model) -> Callable[[Sequence[Dict[str, Any]]],
                                           FeatureTable]:
    """The serve-time table front: ``build(rows) -> FeatureTable`` (on the
    host) running each raw feature's extract over the request rows.
    Shared by :func:`micro_batch_score_function`, the serving runtime and
    the warm-start fingerprint (``serving/warmup.py``): all must build
    identical tables.

    Every raw feature is extracted, the label's too, as the JAX package's
    row scorer does: a request without the label gives a missing value,
    which a fitted stage of the label (an indexer) reads as the JAX
    package's does; the model's predictors never read it. Homogeneous
    numeric batches of plain-field features gather with one dict lookup a
    cell and convert in one numpy sweep; anything else (a string, a
    ``FeatureType`` wrapper, a custom extractor, a non-numeric type) takes
    the exact per-cell path, so outputs are byte-identical."""
    from ..readers.readers import _field_name_of
    extractors = [(f, _field_name_of(f.origin_stage.extract_fn))
                  for f in model.raw_features]

    def build(rows: Sequence[Dict[str, Any]]) -> FeatureTable:
        cols = {}
        dict_rows = all(isinstance(r, dict) for r in rows)
        for f, field in extractors:
            numeric = f.feature_type.column_kind in _SCALAR_KINDS
            col = None
            if numeric and field is not None and dict_rows:
                col = _scalars_or_none(f.feature_type,
                                       [r.get(field) for r in rows])
            if col is None:
                col = _exact_column(f, [f.origin_stage.extract(r)
                                        for r in rows])
            cols[f.name] = col
        return FeatureTable(cols, len(rows))

    return build


def _exact_column(f, vals: List[Any]) -> Column:
    try:
        if f.feature_type.column_kind in _SCALAR_KINDS:
            return column_of_scalars(
                f.feature_type, [np.nan if v is None else v for v in vals])
        return Column.of_values(f.feature_type, vals)
    except (TypeError, ValueError) as e:
        raise ScoreSchemaError(
            f"raw feature '{f.name}' ({f.type_name}): value does not "
            f"conform to the fitted schema ({type(e).__name__}: {e})") from e


def serve_record_builder(model) -> Callable[[FeatureTable, int],
                                            List[Dict[str, Any]]]:
    """``records(scored_table, n) -> [result dict]``: the row-major view
    of a scored table (Prediction columns as {key: float} maps, masked
    slots as None); one ``tolist()`` sweep a column."""
    results = model.result_features

    def records(scored: FeatureTable, n: int) -> List[Dict[str, Any]]:
        per_col = []
        for f in results:
            col = scored[f.name].to_host()
            per_col.append((
                f.name, np.asarray(col.values).tolist(),
                None if col.mask is None else np.asarray(col.mask).tolist(),
                col.metadata.get("keys") if col.kind == "prediction"
                else None))
        return _rows_of(per_col, n)

    return records


def _rows_of(per_col, n: int) -> List[Dict[str, Any]]:
    out = []
    for i in range(n):
        rec: Dict[str, Any] = {}
        for name, vals, masks, keys in per_col:
            if masks is not None and not masks[i]:
                rec[name] = None
            elif keys is not None:
                rec[name] = dict(zip(keys, vals[i]))
            else:
                rec[name] = vals[i]
        out.append(rec)
    return out


class _CompiledScore:
    """The schema-guarded columnar pass (:func:`compiled_score_function`)."""

    def __init__(self, model):
        self.model = model
        stages = self.stages = list(model.stages)
        self.result_names = [f.name for f in model.result_features]
        # the fitted column set: every column the pass reads that no
        # stage of the model produces must arrive in the input table
        produced = {s.get_output().name for s in stages}
        self.required: List[str] = []
        for s in stages:
            # response features are train-only: scoring never reads them
            for f in s.input_features:
                if (not f.is_response and f.name not in produced
                        and f.name not in self.required):
                    self.required.append(f.name)
        # per-column trailing shape: from the training table when the
        # model still carries one, else pinned by the first scored batch
        self.expected: Dict[str, Tuple[int, ...]] = {}
        ttbl = getattr(model, "train_table", None)
        if ttbl is not None:
            for nm in self.required:
                if nm in ttbl.column_names:
                    self.expected[nm] = tuple(ttbl[nm].values.shape[1:])

    def check(self, table: FeatureTable) -> None:
        """Raise :class:`ScoreSchemaError` unless the host ``table``
        carries every required column, each device column convertible to
        float32 with the fitted trailing shape."""
        missing = [nm for nm in self.required
                   if nm not in table.column_names]
        if missing:
            raise ScoreSchemaError(
                f"input is missing column(s) {missing} required by the "
                f"fitted model; table has {sorted(table.column_names)}")
        self._check_columns(table, self.required)

    def _check_columns(self, table: FeatureTable, names) -> None:
        for nm in names:
            col = table[nm]
            if col.kind not in DEVICE_KINDS:
                continue
            if isinstance(col.values, torch.Tensor):
                want = self.expected.get(nm)
                got = tuple(col.values.shape[1:])
                if want is not None and got != want:
                    raise ScoreSchemaError(
                        f"column '{nm}': per-row shape {got} does not "
                        f"match the fitted schema {want}")
                continue
            try:
                v = np.asarray(col.values, dtype=np.float32)
            except (TypeError, ValueError) as e:
                raise ScoreSchemaError(
                    f"column '{nm}': values of dtype {col.values.dtype} "
                    f"cannot convert to float32 for the serve pass "
                    f"({e})") from e
            want = self.expected.get(nm)
            if want is not None and tuple(v.shape[1:]) != want:
                raise ScoreSchemaError(
                    f"column '{nm}': per-row shape {tuple(v.shape[1:])} "
                    f"does not match the fitted schema {want}")
            self.expected.setdefault(nm, tuple(v.shape[1:]))

    def run(self, table: FeatureTable) -> FeatureTable:
        """The model's stages on a checked table (host or on the device):
        planned with only the result columns kept, the plan's device
        inputs validated before any dispatch; ``model.score`` where no
        plan applies or the planned run fell back (recorded)."""
        from .. import plan as _plan
        table = table.to_device(self.model.device)
        plan = _plan.get_plan(self.stages, table, keep_intermediates=False,
                              extra_keep=self.result_names, cat="score")
        if plan is None:
            return self.model.score(table=table)
        self._check_columns(table, plan.device_table_inputs(table))
        out = _plan.run_planned(plan, table)
        if out is None:
            return self.model.score(table=table)
        return out

    def __call__(self, table: FeatureTable) -> FeatureTable:
        self.check(table)
        return self.run(table)


def compiled_score_function(model) -> Callable[[FeatureTable], FeatureTable]:
    """``score(table) -> FeatureTable``: the serve pass with the serve-time
    schema guard, a descriptive :class:`ScoreSchemaError` before any data
    reaches the card, then the model's stages on its device as one plan
    (``plan.get_plan(..., keep_intermediates=False, extra_keep=result
    names)``): the result columns and the host stages' columns come back,
    fused intermediates nobody reads do not."""
    return _CompiledScore(model)


class PinnedPool:
    """Pinned host blocks for one runtime's copies, pooled per (dtype,
    power-of-two bucket). A block goes back with the event of the last
    copy that read or wrote it, and is handed out again only after that
    event has completed: a block whose event is still pending is skipped
    for a new one, up to ``PER_BUCKET`` blocks a bucket, past which the
    oldest is waited for."""

    #: blocks a bucket: a flush in its copy, one in flight, one forming
    #: and one spare
    PER_BUCKET = 4

    def __init__(self):
        self._lock = threading.Lock()
        self._free: Dict[Tuple[torch.dtype, int], List[Tuple[
            torch.Tensor, Optional[torch.cuda.Event]]]] = {}
        self._count: Dict[Tuple[torch.dtype, int], int] = {}

    def take(self, dtype: torch.dtype, numel: int) -> torch.Tensor:
        key = (dtype, max(64, 1 << max(0, numel - 1).bit_length()))
        with self._lock:
            slots = self._free.setdefault(key, [])
            for i, (buf, event) in enumerate(slots):
                if event is None or event.query():
                    del slots[i]
                    return buf
            if slots and self._count.get(key, 0) >= self.PER_BUCKET:
                buf, event = slots.pop(0)
            else:
                self._count[key] = self._count.get(key, 0) + 1
                buf = event = None
        if buf is None:
            return torch.empty(key[1], dtype=dtype, pin_memory=True)
        event.synchronize()
        return buf

    def give(self, buf: torch.Tensor,
             event: Optional[torch.cuda.Event]) -> None:
        with self._lock:
            self._free.setdefault((buf.dtype, buf.numel()), []).append(
                (buf, event))


class _InFlight:
    """One dispatched flush on CUDA: the scored table (its tensors live
    until the flush completes), the pinned host views its result columns
    are being copied into, their blocks, and the event recorded after the
    flush's last launch and copy."""

    __slots__ = ("scored", "host_cols", "event", "outputs")

    def __init__(self, scored, host_cols, event, outputs):
        self.scored = scored
        self.host_cols = host_cols
        self.event = event
        self.outputs = outputs


class ServeStages:
    """Staged decomposition of :func:`micro_batch_score_function` for the
    pipelined serving dataplane (``serving/runtime.py``), as the JAX
    package cuts it:

    * :meth:`gather` — request rows -> FeatureTable through
      :func:`serve_table_builder`. On CUDA the host table is then
      schema-checked, packed into pooled pinned blocks (one a dtype, one
      for the masks) and copied with ``non_blocking=True`` on the
      runtime's stream: the device table has ``FeatureTable.to_device``'s
      layout and values.
    * :meth:`dispatch` — run the model's stages (planned: the segments'
      graphs replay on the runtime's stream) on the runtime's stream,
      enqueue the result columns' copies into pinned host blocks, record
      one event after them, and return without waiting.
    * :meth:`flatten` — wait on that event and produce exactly the
      records :func:`serve_record_builder` gives.

    On the CPU ``gather`` returns the host table, ``dispatch`` the scored
    table and ``flatten`` its records. Failure semantics stay with the
    caller (the runtime re-scores a failed flush through the monolithic
    scorer)."""

    def __init__(self, model):
        self.model = model
        self._build = serve_table_builder(model)
        self._compiled = _CompiledScore(model)
        self._records = serve_record_builder(model)
        self._results = list(model.result_features)
        dev = getattr(model, "device", None)
        self.device = torch.device(dev) if dev is not None else None
        self.cuda = self.device is not None and self.device.type == "cuda"
        self.stream = (torch.cuda.Stream(device=self.device) if self.cuda
                       else None)
        self.pool = PinnedPool() if self.cuda else None

    def gather(self, rows: Sequence[Dict[str, Any]]) -> FeatureTable:
        table = self._build(rows)
        if not self.cuda:
            return table
        self._compiled.check(table)
        inputs: List[torch.Tensor] = []

        def host_buffer(dtype, numel):
            inputs.append(self.pool.take(dtype, numel))
            return inputs[-1]

        with torch.cuda.stream(self.stream):
            dev_table = table.to_device(self.device, host_buffer=host_buffer)
            copied = torch.cuda.Event()
            copied.record(self.stream)
        # a block is handed out again once its copy has completed
        for buf in inputs:
            self.pool.give(buf, copied)
        return dev_table

    def dispatch(self, table: FeatureTable):
        if not self.cuda:
            return self._compiled(table)
        outputs: List[torch.Tensor] = []
        with torch.cuda.stream(self.stream):
            if table.device is None:        # a host table: check and copy
                self._compiled.check(table)
            scored = self._compiled.run(table)
            host_cols = []
            for f in self._results:
                col = scored[f.name]
                vals = self._to_pinned(col.values, outputs)
                mask = (None if col.mask is None
                        else self._to_pinned(col.mask, outputs))
                keys = (col.metadata.get("keys")
                        if col.kind == "prediction" else None)
                host_cols.append((f.name, vals, mask, keys))
            event = torch.cuda.Event()
            event.record(self.stream)
        return _InFlight(scored, host_cols, event, outputs)

    def _to_pinned(self, t, outputs: List[torch.Tensor]):
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            return t
        buf = self.pool.take(t.dtype, t.numel())
        outputs.append(buf)
        view = buf[:t.numel()].view(t.shape)
        view.copy_(t, non_blocking=True)
        return view

    def flatten(self, inflight, n: int) -> List[Dict[str, Any]]:
        if not isinstance(inflight, _InFlight):
            return self._records(inflight, n)
        inflight.event.synchronize()
        try:
            per_col = []
            for name, vals, mask, keys in inflight.host_cols:
                v = vals.numpy() if isinstance(vals, torch.Tensor) else vals
                m = mask.numpy() if isinstance(mask, torch.Tensor) else mask
                per_col.append((name, np.asarray(v).tolist(),
                                None if m is None else
                                np.asarray(m).tolist(), keys))
            return _rows_of(per_col, n)
        finally:
            for buf in inflight.outputs:
                self.pool.give(buf, None)
            inflight.outputs = []


def micro_batch_score_function(model) -> Callable[[Sequence[Dict[str, Any]]],
                                                  List[Dict[str, Any]]]:
    """``fn(rows) -> [record]``: one schema-guarded columnar pass per batch
    of rows (:func:`compiled_score_function`).

    Malformed input does not kill the batch: a batch that fails (a
    :class:`ScoreSchemaError`, a ``TypeError`` or ``ValueError``) is
    scored row by row, and only the rows that still fail are
    **quarantined**: their result features are None and
    :data:`SCORE_ERROR_KEY` carries the reason."""
    result_features = model.result_features
    compiled = compiled_score_function(model)
    build = serve_table_builder(model)
    records = serve_record_builder(model)

    def score(rows: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
        t0 = time.perf_counter()
        quarantined = 0
        with _obs_span("score.micro_batch", cat="score",
                       rows=len(rows)) as sp:
            try:
                out = records(compiled(build(rows)), len(rows))
            except (ScoreSchemaError, TypeError, ValueError) as batch_err:
                # isolate the offenders: score each row alone; rows that
                # still fail are quarantined instead of poisoning the batch
                out = []
                for row in rows:
                    try:
                        out.append(records(compiled(build([row])), 1)[0])
                    except (ScoreSchemaError, TypeError, ValueError) as e:
                        rec = {f.name: None for f in result_features}
                        rec[SCORE_ERROR_KEY] = str(e) or str(batch_err)
                        out.append(rec)
                        quarantined += 1
                sp.add_event("score.quarantine", rows=quarantined,
                             batchError=str(batch_err)[:200])
                logger.warning(
                    "micro-batch scoring quarantined %d/%d row(s) "
                    "(first batch error: %s)", quarantined, len(rows),
                    batch_err)
        if _obs_metrics.metrics_enabled():
            _obs_metrics.observe(
                "tg_score_microbatch_seconds", time.perf_counter() - t0,
                help="per-micro-batch scoring latency (columnar path)")
            _obs_metrics.inc_counter(
                "tg_score_rows_total", float(len(rows)),
                help="rows submitted to micro-batch scoring")
            if quarantined:
                _obs_metrics.inc_counter(
                    "tg_score_quarantined_total", float(quarantined),
                    help="rows quarantined under __score_error__")
        return out

    return score


def score_function(model) -> Callable[[Dict[str, Any]], Dict[str, Any]]:
    """``fn(row) -> {result feature name: value}`` for one request row
    (raw feature names -> python values, None = missing): the columnar
    pass on a one-row table."""
    build = serve_table_builder(model)
    records = serve_record_builder(model)

    def score(row: Dict[str, Any]) -> Dict[str, Any]:
        t0 = (time.perf_counter()
              if _obs_metrics.metrics_enabled() else None)
        out = records(model.score(table=build([row])), 1)[0]
        if t0 is not None:
            _obs_metrics.observe(
                "tg_score_request_seconds", time.perf_counter() - t0,
                help="per-request scoring latency (row path)")
        return out

    return score
