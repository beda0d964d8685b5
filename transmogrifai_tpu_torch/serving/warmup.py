"""Warm-start: first requests that build nothing.

A fresh process pays, on its first flush, every ``nvcc`` build and
``ctypes`` load of the kernels the model's serve pass launches
(``ops/cuda_build``; each a compile-ledger record). The cure has the JAX
package's two halves (``transmogrifai_tpu/serving/warmup.py``), with its
names and JSON shapes:

* **save time** — :func:`manifest_serving_entry` records the serve pass's
  *schema fingerprint* (per external column name / dtype / trailing shape
  / mask presence, what ``plan.py`` keys its cache on,
  ``plan.schema_fingerprint``) in the model's ``MANIFEST.json``. It is
  computed from a synthetic all-missing request batch, schema-identical
  to any real batch, and equals the JAX package's fingerprint for the
  same model.
* **load time** — :func:`warm_runtime` drives the runtime's scorer once
  over the same synthetic batch, so every kernel library is built and
  loaded, and the serve plan built and its first bucket's CUDA graphs
  captured, before the first real request; it checks the recorded
  fingerprint against the loaded model's (a mismatch is reported in the
  health snapshot, never fatal).

The warm report keeps every key of the JAX package's: ``plansWarmed``
counts the plan cache entries the warm pass added and ``compiles`` the
ledger's builds. Until the program store is ported (ROADMAP Queue 1 item
10), ``aotHits``, ``aotMisses`` and ``aotExports`` are 0.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence

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


def schema_fingerprint(stages: Sequence[Any], table) -> List[List[Any]]:
    """JSON-ready ``[[column, dtype, trailing shape, mask-is-None], ...]``
    of the planner's cache key (``plan.schema_fingerprint``); row count is
    absent, so a fingerprint recorded at save time matches any request
    batch of the same schema."""
    from ..plan import schema_fingerprint as _fingerprint
    return _fingerprint(stages, table)


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
    from .. import plan as _plan
    from ..observability import ledger as _ledger
    n = _warm_rows(rows if rows is not None
                   else (entry or {}).get("warmRows"))
    before = _plan.cache_stats()["entries"]
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
    info["plansWarmed"] = max(0, _plan.cache_stats()["entries"] - before)
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
