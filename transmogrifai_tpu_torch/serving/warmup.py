"""Warm-start: first requests that build nothing.

A fresh process pays, on its first flush, every ``nvcc`` build and
``ctypes`` load of the kernels the model's serve pass launches
(``ops/cuda_build``; each a compile-ledger record). The cure has the JAX
package's two halves (``transmogrifai_tpu/serving/warmup.py``), with its
names and JSON shapes:

* **save time** — :func:`manifest_serving_entry` records the serve pass's
  *schema fingerprint* (per external column name / dtype / trailing shape
  / mask presence, what the JAX package's ``plan.py`` keys its cache on)
  in the model's ``MANIFEST.json``. It is computed from a synthetic
  all-missing request batch, schema-identical to any real batch, and
  equals the JAX package's fingerprint for the same model: the port keeps
  its own copy of ``plan.schema_fingerprint`` (:func:`schema_fingerprint`)
  and does not port the plan compiler (ROADMAP Queue 1 item 3).
* **load time** — :func:`warm_runtime` drives the runtime's scorer once
  over the same synthetic batch, so every kernel library is built and
  loaded before the first real request, and checks the recorded
  fingerprint against the loaded model's (a mismatch is reported in the
  health snapshot, never fatal).

The warm report keeps every key of the JAX package's. Until the plan
compiler and the program store are ported (ROADMAP Queue 1 items 3 and
10), ``plansWarmed``, ``aotHits``, ``aotMisses`` and ``aotExports`` are 0
and ``compiles`` counts the ledger's builds.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..local.scoring import serve_table_builder

#: synthetic rows of the warm pass
WARM_ROWS_ENV = "TG_SERVE_WARM_ROWS"
DEFAULT_WARM_ROWS = 8


def _warm_rows(rows: Optional[int] = None) -> int:
    if rows is not None:
        return max(1, int(rows))
    try:
        return max(1, int(os.environ.get(WARM_ROWS_ENV, "")
                          or DEFAULT_WARM_ROWS))
    except ValueError:
        return DEFAULT_WARM_ROWS


def _device_inputs(stage: Any) -> List[str]:
    if hasattr(stage, "device_inputs"):
        return list(stage.device_inputs())
    return [f.name for f in stage.input_features]


def _host_inputs(stage: Any) -> List[str]:
    return [f.name for f in stage.input_features]


def _schema_fingerprint(stages: Sequence[Any], table) -> Tuple:
    """Per-column (name, dtype, trailing shape, mask-is-None) of every
    external column the stage sequence reads from the host ``table``, in
    the order the stages read them (the JAX package's
    ``plan._schema_fingerprint``)."""
    produced = {s.get_output().name for s in stages}
    items: List[Tuple] = []
    seen = set()
    present = set(table.column_names)
    for s in stages:
        for nm in list(_host_inputs(s)) + list(_device_inputs(s)):
            if nm in produced or nm in seen:
                continue
            seen.add(nm)
            if nm not in present:
                # response features are train-only; anything else missing
                # is the serve pass's (descriptive) error to raise
                continue
            col = table[nm]
            v = col.values
            items.append((nm, str(getattr(v, "dtype", "object")),
                          tuple(int(x) for x in v.shape[1:]),
                          col.mask is None))
    return tuple(items)


def schema_fingerprint(stages: Sequence[Any], table) -> List[List[Any]]:
    """JSON-ready ``[[column, dtype, trailing shape, mask-is-None], ...]``;
    row count is absent, so a fingerprint recorded at save time matches
    any request batch of the same schema."""
    return [[nm, dt, list(shape), bool(maskless)]
            for nm, dt, shape, maskless in _schema_fingerprint(
                list(stages), table)]


def serve_plan_fingerprint(model, rows: int = 1) -> List[List[Any]]:
    """The JSON-ready schema fingerprint of the model's serve path."""
    table = serve_table_builder(model)([{} for _ in range(max(1, rows))])
    return schema_fingerprint(model.stages, table)


def manifest_serving_entry(model) -> Dict[str, Any]:
    """The ``serving`` section written into the model's ``MANIFEST.json``
    at save time (persistence.save_model)."""
    return {
        "planFingerprint": serve_plan_fingerprint(model),
        "warmRows": _warm_rows(),
        "resultFeatures": [f.name for f in model.result_features],
    }


def warm_runtime(runtime, entry: Optional[Dict[str, Any]] = None,
                 rows: Optional[int] = None) -> Dict[str, Any]:
    """Pre-warm the runtime's serve path; returns the warm report that
    lands in ``runtime.warm_info`` / the registry health snapshot:
    ``{"rows", "plansWarmed", "ok", "fingerprintMatch", "error",
    "compiles", "compileCauses", "aotHits", "aotMisses", "aotExports"}``.

    The JAX package's ``store_path`` (its AOT program store) has no
    counterpart until ROADMAP Queue 1 item 10. Never raises — a model
    whose raw extracts cannot take an all-missing probe row serves its
    first request cold (reported)."""
    from ..observability import ledger as _ledger
    n = _warm_rows(rows if rows is not None
                   else (entry or {}).get("warmRows"))
    led = _ledger.ledger()
    mark = led.mark()
    info: Dict[str, Any] = {"rows": n, "plansWarmed": 0, "ok": True,
                            "fingerprintMatch": None, "error": None}
    try:
        with runtime.fault_log.activate():
            runtime.warm(n)
    except Exception as e:
        info["ok"] = False
        info["error"] = f"{type(e).__name__}: {e}"[:300]
    info["aotHits"] = 0
    info["aotMisses"] = 0
    info["aotExports"] = 0
    # the builds warmup pre-paid (subsystem "serve"): what the warm-path
    # gate subtracts before asserting the first real request builds
    # nothing
    causes: Dict[str, int] = {}
    for rec in led.since(mark):
        causes[rec.cause] = causes.get(rec.cause, 0) + 1
    info["compiles"] = led.mark() - mark
    info["compileCauses"] = causes
    recorded = (entry or {}).get("planFingerprint")
    if recorded is not None:
        try:
            actual = serve_plan_fingerprint(runtime.model)
            info["fingerprintMatch"] = (
                _normalize(actual) == _normalize(recorded))
        except Exception as e:
            info["fingerprintMatch"] = False
            info["error"] = info["error"] or f"{type(e).__name__}: {e}"[:300]
    runtime.warm_info = info
    return info


def _normalize(fp: Any) -> List[List[Any]]:
    # JSON round-trips tuples to lists; compare shape-insensitively
    return [[c[0], c[1], list(c[2]), bool(c[3])] for c in fp]
