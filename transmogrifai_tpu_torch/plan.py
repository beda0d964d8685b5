"""Transform-plan compiler (counterpart of ``transmogrifai_tpu.plan``): one
replayed program per device-fusable segment and row bucket.

A *plan* partitions a topologically ordered run of fitted transformer
stages into maximal device segments (stages exposing a pure torch
``device_columnar`` dual over ``{name: (values, mask)}``) separated by
host waves (text and map fronts, row lambdas), as the JAX package's
planner does, with the same steps: the same host waves, the same segments
and the same ``in_names``/``out_names`` for the same stages and table.

What a segment's "program" is differs with the device:

* on CUDA, one ``torch.cuda.CUDAGraph`` for each (segment, padding
  bucket). A bucket's first dispatch runs the segment's duals eagerly, as
  on the CPU, on the capture stream: it is both the run's result and the
  warm-up PyTorch asks for before a capture (every first-use device
  constant, library load and shared-memory opt-in happens there). The
  bucket's second dispatch captures the duals into the graph and replays
  it, and every later one replays it, on the caller's stream. A plan used
  once (a train's layer run, a one-off batch score) so captures nothing
  and holds no graph memory. The hand-written kernels' ctypes launches go
  to the current stream, so the capture records them; each replay adds
  the launches it recorded to the kernels' counts
  (``cuda_build.capturing``). The graphs of one plan share one memory
  pool; under the plan's lock each dispatch first waits (on the device)
  for the plan's previous one, whatever stream that ran on, and a replay
  copies its outputs out before it returns: replays of one plan never
  overlap, and a second flush in flight or a second thread never reads
  outputs that a later replay overwrites. One capture stream a device for
  every first dispatch and capture, so their freed blocks are reused. No
  ``torch.compile``: it would reorder reductions.
* on the CPU, the segment's duals run in order at the padded bucket; there
  is nothing to capture.

Consumers: ``dag._transform_stages`` (each layer of a train and the
flattened score pass, ``apply_transformations_dag``) and
``local/scoring.compiled_score_function`` (the micro-batch scorer and the
serving runtime's dispatch). Plans live in a bounded LRU
(``TG_PLAN_CACHE_MAX``, default 32) keyed on the stage sequence, the
input schema's fingerprint and the keep options; an entry holds every stage
object of its key, so a stage's ``id`` cannot be reused while its plan is
cached.

Robustness (the JAX package's ``docs/plan.md`` "Fallback semantics"):

* planning is skipped when per-stage fault semantics are active: a
  workflow ``with_fault_policy`` or ``with_profiler`` (the caller passes
  eager), ``TG_CHAOS``, or an armed site outside the ``plan.``, ``serve.``,
  ``drift.``, ``oom.``, ``fleet.``, ``aot.`` and ``place.`` prefixes;
* a planned run that raises (the ``plan.segment_execute`` site, a capture
  that fails) records a FaultLog ``plan_fallback`` and the caller runs
  eagerly, with identical results; resource exhaustion
  (``torch.cuda.OutOfMemoryError``, a host ``MemoryError``; the ``oom.plan``
  site) first halves the rows (``oom_downshift``) and falls back only below
  the minimum bucket. ``SimulatedPreemption`` passes through.

Observability: spans ``plan.compile``, ``plan.execute`` and
``plan.segment``; counters ``tg_dispatch_total{kind}`` (one per planned
segment; ``max(1, |device inputs|)`` per eager device-capable stage) and
``tg_device_transfer_total``; histogram ``tg_plan_transfer_seconds``; a
compile-ledger build for each plan and each segment's first bucket, and an
eviction record; ``devicemem`` predicted bytes per dispatch and a cost row
per (segment, bucket), the measured allocation delta on CUDA (the graph
pool's growth once the bucket is captured).
"""
from __future__ import annotations

import logging
import os
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .observability import devicemem as _devicemem
from .observability import ledger as _ledger
from .observability import metrics as _obs_metrics
from .observability.trace import span as _obs_span
from .table import DEVICE_KINDS, Column, FeatureTable

logger = logging.getLogger(__name__)

#: env switch: TG_PLAN=0 disables the planner process-wide (eager dispatch)
PLAN_ENV = "TG_PLAN"

_FALSY = ("", "0", "false", "False", "no")

#: armed fault sites with these prefixes keep the planner on: they target
#: the planner itself or layers above it
_KEEP_PREFIXES = ("plan.", "serve.", "drift.", "oom.", "fleet.", "aot.",
                  "place.")

_enabled_override: Optional[bool] = None

#: plan LRU: key -> (TransformPlan or None, the key's stages). None caches
#: "planning infeasible for this shape"; the stages keep every ``id`` of
#: the key alive while the entry lives
_PLAN_CACHE: "OrderedDict[Any, Tuple[Optional[TransformPlan], Tuple]]" = (
    OrderedDict())
_PLAN_CACHE_MAX = int(os.environ.get("TG_PLAN_CACHE_MAX", "32"))
_CACHE_LOCK = threading.RLock()


def plan_enabled() -> bool:
    """True when the planner may be used (``TG_PLAN``, unless overridden
    from code)."""
    if _enabled_override is not None:
        return _enabled_override
    return os.environ.get(PLAN_ENV, "1") not in _FALSY


def enable_planning(on: Optional[bool]) -> None:
    """Force planning on or off from code (tests, A/B runs); ``None`` hands
    control back to ``TG_PLAN``."""
    global _enabled_override
    _enabled_override = None if on is None else bool(on)


def planning_applicable() -> bool:
    """Planning is allowed only when per-stage fault semantics are not in
    play: under ``TG_CHAOS`` or an armed site outside the planner's own
    prefixes (``plan.``, ``oom.``, ``aot.``) and the layers above it
    (``serve.``, ``drift.``, ``fleet.``, ``place.``) the eager per-stage
    path runs."""
    if not plan_enabled():
        return False
    from .robustness import faults
    if os.environ.get(faults.CHAOS_ENV):
        return False
    return all(s.startswith(_KEEP_PREFIXES) for s in faults.active_sites())


def clear_plan_cache() -> None:
    """Drop every cached plan (test isolation)."""
    with _CACHE_LOCK:
        for plan, _ in _PLAN_CACHE.values():
            if plan is not None:
                plan.release()
        _PLAN_CACHE.clear()


def cache_stats() -> Dict[str, int]:
    """{"entries", "max"}: ``summary()["observability"]["planCache"]``."""
    return {"entries": len(_PLAN_CACHE), "max": _PLAN_CACHE_MAX}


# ---------------------------------------------------------------------------
# Stage classification
# ---------------------------------------------------------------------------

def is_device_capable(stage: Any) -> bool:
    """A stage with a ``device_columnar`` dual that has not opted out (a
    SelectedModel whose family has no ``predict_parts`` of its own)."""
    return (hasattr(stage, "device_columnar")
            and getattr(stage, "device_fusable", True))


def count_eager_dispatch(stage: Any) -> None:
    """Account one eager transform of a device-capable stage: eager
    execution launches at least one program per input column chain, so
    the counter adds ``max(1, |device inputs|)``, a lower bound of the
    launches one planned segment replaces."""
    if not is_device_capable(stage):
        return
    _obs_metrics.inc_counter(
        "tg_dispatch_total", float(max(1, len(_device_inputs(stage)))),
        kind="stage",
        help="top-level device program launches on the transform path")


def _device_inputs(stage: Any) -> List[str]:
    if hasattr(stage, "device_inputs"):
        return list(stage.device_inputs())
    return [f.name for f in stage.input_features]


def _host_inputs(stage: Any) -> List[str]:
    return [f.name for f in stage.input_features]


def _numeric_table_col(col: Column) -> bool:
    v = col.values
    if isinstance(v, torch.Tensor):
        return not v.dtype.is_complex
    dt = getattr(v, "dtype", None)
    return dt is not None and np.dtype(dt).kind in "fiub"


def _dtype_name(v: Any) -> str:
    """A column's dtype as the JAX package names it (numpy's names)."""
    if isinstance(v, torch.Tensor):
        return str(v.dtype).replace("torch.", "")
    return str(getattr(v, "dtype", "object"))


# ---------------------------------------------------------------------------
# Plan structure
# ---------------------------------------------------------------------------

class _Inputs:
    """A segment's inputs staged at one bucket, on one device: float32
    values (each 1-D input a column of one block, each other input its own
    buffer) and bool masks (columns of one block); padding rows zero and
    False. Staging is a few launches whatever the number of inputs."""

    __slots__ = ("vals", "masks", "vblock", "mblock", "scalars")

    def __init__(self, seg: "_DeviceSegment", table: FeatureTable,
                 n_pad: int, device: torch.device):
        shapes = [tuple(int(x) for x in table[nm].values.shape[1:])
                  for nm in seg.in_names]
        self.scalars = [i for i, sh in enumerate(shapes) if not sh]
        self.vblock = torch.zeros((n_pad, len(self.scalars)),
                                  dtype=torch.float32, device=device)
        self.mblock = torch.zeros((n_pad, len(shapes)), dtype=torch.bool,
                                  device=device)
        self.vals: List[torch.Tensor] = [
            torch.zeros((n_pad,) + sh, dtype=torch.float32, device=device)
            if sh else None for sh in shapes]
        for j, i in enumerate(self.scalars):
            self.vals[i] = self.vblock[:, j]
        self.masks = [self.mblock[:, i] for i in range(len(shapes))]

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in
                   [self.vblock, self.mblock] + [
                       v for i, v in enumerate(self.vals)
                       if i not in self.scalars])

    def stage(self, seg: "_DeviceSegment", table: FeatureTable,
              n: int) -> int:
        """Copy the table's inputs in (row ``n`` on zeroed); returns the
        host-to-device copies it made."""
        device = self.mblock.device
        transfers = 0

        def on_device(a, dtype):
            nonlocal transfers
            if isinstance(a, torch.Tensor):
                return a
            transfers += device.type != "cpu"
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

        cols = [table[nm] for nm in seg.in_names]
        ones = None
        ms = []
        for c in cols:
            if c.mask is None:
                if ones is None:
                    ones = torch.ones(n, dtype=torch.bool, device=device)
                ms.append(ones)
            else:
                ms.append(on_device(c.mask, bool))
        if ms:
            torch.stack(ms, dim=1, out=self.mblock[:n])
        if self.scalars:
            torch.stack([on_device(cols[i].values, np.float32).reshape(-1)
                         .to(torch.float32) for i in self.scalars], dim=1,
                        out=self.vblock[:n])
        for i, c in enumerate(cols):
            if i not in self.scalars:
                self.vals[i][:n].copy_(on_device(c.values, np.float32))
                self.vals[i][n:].zero_()
        self.mblock[n:].zero_()
        self.vblock[n:].zero_()
        return transfers


class _Graph:
    """One captured (segment, bucket): the graph, its static
    inputs and outputs, the kernel launches a replay runs, what runs
    after each replay (``cuda_build.after_replay``) and the device bytes
    it holds (its pool's growth at the capture and its static inputs)."""

    __slots__ = ("graph", "inputs", "outs", "launches", "after", "nbytes",
                 "replays")

    def __init__(self, graph, inputs, outs, launches, after, nbytes):
        self.graph = graph
        self.inputs = inputs
        self.outs = outs
        self.launches = launches
        self.after = after
        self.nbytes = nbytes
        self.replays = 0


#: one capture at a time in the process: a capture's allocations go to its
#: pool, and two open captures would see each other's frees
_CAPTURE_LOCK = threading.Lock()
#: device index -> the stream every first dispatch and capture runs on
_CAPTURE_STREAMS: Dict[int, Any] = {}


def _capture_stream(device: torch.device):
    """The device's capture stream (call under ``_CAPTURE_LOCK``)."""
    side = _CAPTURE_STREAMS.get(device.index)
    if side is None:
        side = _CAPTURE_STREAMS[device.index] = torch.cuda.Stream(
            device=device)
    return side


class _DeviceSegment:
    """One maximal run of device-fusable stages, run as one program.
    ``in_names`` are the columns it reads (produced outside it),
    ``out_names`` the columns it materializes."""

    __slots__ = ("stages", "in_names", "out_names", "out_meta", "out_shape",
                 "seen_buckets", "fp_key", "pred_cache", "graphs",
                 "captures", "replays")

    def __init__(self, stages: List[Any], in_names: List[str],
                 out_names: List[str]):
        self.stages = stages
        self.in_names = in_names
        self.out_names = out_names
        self.out_meta: Dict[str, Tuple[Any, Dict[str, Any]]] = {}
        #: output column (itemsize, trailing shape) from the zero-row probe
        self.out_shape: Dict[str, Tuple[int, Tuple[int, ...]]] = {}
        #: buckets this segment has been dispatched at (a first dispatch
        #: at a new one is a build; on CUDA the second one captures)
        self.seen_buckets: set = set()
        self.fp_key: Optional[str] = None
        self.pred_cache: Dict[int, int] = {}
        #: bucket -> _Graph (CUDA only)
        self.graphs: Dict[int, _Graph] = {}
        #: [(bucket, seconds)] of every capture, and the replays
        self.captures: List[Tuple[int, float]] = []
        self.replays = 0

    def chain(self, vals: Sequence[torch.Tensor],
              masks: Sequence[torch.Tensor]) -> List[Tuple[Any, Any]]:
        """The segment's duals over staged inputs: one (values, mask) per
        ``out_names``."""
        env = {nm: (v, m) for nm, v, m in zip(self.in_names, vals, masks)}
        for s in self.stages:
            env[s.get_output().name] = s.device_columnar(env)
        return [env[nm] for nm in self.out_names]


class TransformPlan:
    """An executable schedule: host waves (eager per-stage dispatch) and
    device segments (one program each)."""

    def __init__(self, steps: List[Tuple[str, Any]], cat: str):
        self.steps = steps
        self.cat = cat
        #: the planned stages' uids, the ledger identity of that sequence
        #: and the JSON schema fingerprint (the compile ledger's
        #: classification baseline), set by get_plan
        self.uids: List[str] = []
        self.ident: str = "plan"
        self.fp_json: Any = None
        self.ident_hash: Optional[str] = None
        #: the graphs' memory pool, the event recorded after the plan's
        #: last dispatch, and the lock that orders staging, replay and the
        #: copy out of its graphs
        self._pool: Any = None
        self._done: Any = None
        self._lock = threading.Lock()

    @property
    def num_segments(self) -> int:
        return sum(1 for k, _ in self.steps if k == "device")

    @property
    def num_host_stages(self) -> int:
        return sum(len(p) for k, p in self.steps if k == "host")

    @property
    def segments(self) -> List[_DeviceSegment]:
        return [p for k, p in self.steps if k == "device"]

    def device_table_inputs(self, table: FeatureTable) -> List[str]:
        """Segment inputs that come straight from the caller's table (what
        the serve-time schema guard validates)."""
        produced = {s.get_output().name
                    for k, p in self.steps
                    for s in (p if k == "host" else p.stages)}
        out: List[str] = []
        for k, p in self.steps:
            if k != "device":
                continue
            for nm in p.in_names:
                if nm not in produced and nm in table and nm not in out:
                    out.append(nm)
        return out

    def release(self) -> None:
        """Drop the plan's graphs and pools (an evicted plan): their memory
        returns once no running dispatch holds them."""
        with self._lock:
            for seg in self.segments:
                seg.graphs.clear()
            self._pool = None

    # -- execution -----------------------------------------------------------
    def execute(self, table: FeatureTable) -> FeatureTable:
        with _obs_span("plan.execute", cat=self.cat, rows=table.num_rows,
                       segments=self.num_segments,
                       hostStages=self.num_host_stages):
            seg_idx = 0
            for kind, payload in self.steps:
                if kind == "host":
                    for s in payload:
                        # a device-capable stage demoted to host (non-
                        # numeric inputs) still launches eagerly
                        count_eager_dispatch(s)
                        with _obs_span("stage.transform", cat=self.cat,
                                       uid=getattr(s, "uid", "?"),
                                       stage=type(s).__name__, planned=True):
                            table = s.transform(table)
                else:
                    table = self._run_segment(payload, table, seg_idx)
                    seg_idx += 1
        return table

    def _predicted_bytes(self, seg: _DeviceSegment, table: FeatureTable,
                         n_pad: int) -> int:
        """Shape-predicted device bytes of one padded dispatch: every input
        staged at the bucket (float32 and a bool mask) and every output at
        its probed shape."""
        from .utils.padding import padded_bytes
        total = 0
        for nm in seg.in_names:
            total += padded_bytes(n_pad, tuple(table[nm].values.shape[1:]),
                                  4)
        for nm in seg.out_names:
            itemsize, trailing = seg.out_shape.get(nm, (4, ()))
            total += padded_bytes(n_pad, trailing, itemsize)
        return total

    def _run_segment(self, seg: _DeviceSegment, table: FeatureTable,
                     seg_idx: int = 0) -> FeatureTable:
        from .manifest import sentinel_phase
        from .robustness import faults
        from .utils.padding import bucket_for
        # crash evidence: a process that dies past here was in a dispatch
        sentinel_phase("device_dispatch")
        # chaos: a runtime error mid-plan (apply_planned falls back)
        faults.inject("plan.segment_execute", key=seg.stages[0].uid)
        # chaos: the padded segment does not fit (apply_planned bisects)
        faults.inject("oom.plan", key=seg.stages[0].uid)
        n = table.num_rows
        n_pad = bucket_for(n)
        device = table.device or torch.device("cpu")
        cuda = device.type == "cuda"
        subsystem = _ledger.current_subsystem("plan")
        predicted = seg.pred_cache.get(n_pad)
        if predicted is None:
            predicted = seg.pred_cache[n_pad] = self._predicted_bytes(
                seg, table, n_pad)
        _devicemem.record_dispatch(subsystem, predicted, bucket=n_pad,
                                   rows=n)
        first_bucket = n_pad not in seg.seen_buckets
        if seg.fp_key is None:
            seg.fp_key = _ledger.cache_key_hash(
                (self.ident, seg_idx, tuple(seg.in_names),
                 tuple(seg.out_names), self.fp_json))
        _obs_metrics.inc_counter(
            "tg_dispatch_total", kind="plan_segment",
            help="top-level device program launches on the transform path")
        t0 = time.perf_counter()
        with _obs_span("plan.segment", cat=self.cat, stages=len(seg.stages),
                       rows=n, inputs=len(seg.in_names),
                       outputs=len(seg.out_names), bucket=n_pad) as sp:
            if cuda:
                outs, transfers, cost_bytes = self._dispatch_cuda(
                    seg, table, n, n_pad, device, sp, first_bucket)
            else:
                inputs = _Inputs(seg, table, n_pad, device)
                transfers = inputs.stage(seg, table, n)
                _observe_staging(t0)
                outs = [(v[:n], None if m is None else m[:n])
                        for v, m in seg.chain(inputs.vals, inputs.masks)]
                cost_bytes = predicted
        secs = time.perf_counter() - t0
        _obs_metrics.inc_counter(
            "tg_device_transfer_total", float(transfers),
            help="host-to-device uploads (packed: one a dtype)")
        if first_bucket:
            seg.seen_buckets.add(n_pad)
            _ledger.record_build(
                subsystem, identity=f"{self.ident}/seg{seg_idx}",
                key=f"{seg.fp_key}@{n_pad}", fingerprint=self.fp_json,
                bucket=n_pad, seconds=secs, rows=n, stages=len(seg.stages),
                cat=self.cat)
            _devicemem.record_cost(seg.fp_key, n_pad, cost_bytes,
                                   compile_s=secs)
        else:
            _devicemem.record_cost(seg.fp_key, n_pad, cost_bytes,
                                   execute_s=secs)
        new_cols: Dict[str, Column] = {}
        for nm, (arr, msk) in zip(seg.out_names, outs):
            if msk is not None and bool(msk.all()):
                msk = None
            ftype, md = seg.out_meta[nm]
            new_cols[nm] = Column(ftype, arr, msk, dict(md))
        out = table
        for nm, col in new_cols.items():
            out = out.with_column(nm, col)
        return out

    def _dispatch_cuda(self, seg: _DeviceSegment, table: FeatureTable,
                       n: int, n_pad: int, device: torch.device, sp,
                       first_bucket: bool):
        """One dispatch on the card, after the plan's previous one: a
        bucket's first runs the duals eagerly on the capture stream, its
        second captures them, and from then on the inputs are staged into
        the graph's static buffers, the graph replays and its outputs are
        copied out, on the current stream. Returns (outputs sliced to n
        rows, copies, the device bytes measured: the eager run's
        allocation delta, or the graph's)."""
        stream = torch.cuda.current_stream(device)
        t0 = time.perf_counter()
        with self._lock:
            if self._done is not None:
                stream.wait_event(self._done)
            g = seg.graphs.get(n_pad)
            if g is None and first_bucket:
                outs, transfers, nbytes = self._eager(seg, table, n, n_pad,
                                                      device, stream, t0)
            else:
                if g is None:
                    g, transfers = self._capture(seg, table, n, n_pad,
                                                 device, stream)
                    seg.graphs[n_pad] = g
                    sp.set_attr(captured=True)
                else:
                    transfers = g.inputs.stage(seg, table, n)
                _observe_staging(t0)
                g.graph.replay()
                for kernel, c in g.launches.items():
                    kernel.count_replays(c)
                for fn in g.after:
                    fn()
                g.replays += 1
                seg.replays += 1
                # the copies out run on this stream after the replay, and
                # the plan's next dispatch waits for them
                outs = [(v[:n].clone(), None if m is None else m[:n].clone())
                        for v, m in g.outs]
                nbytes = g.nbytes
            if self._done is None:
                self._done = torch.cuda.Event()
            self._done.record(stream)
        return outs, transfers, nbytes

    @staticmethod
    def _eager(seg: _DeviceSegment, table: FeatureTable, n: int, n_pad: int,
               device: torch.device, stream, t0: float):
        """A bucket's first dispatch: the duals at the padded bucket on the
        capture stream, ordered after the caller's stream and before its
        later work. The outputs are marked in use on the caller's stream,
        so their blocks return to the capture stream only once its work
        on them is done."""
        before = torch.cuda.memory_allocated(device)
        inputs = _Inputs(seg, table, n_pad, device)
        transfers = inputs.stage(seg, table, n)
        _observe_staging(t0)
        with _CAPTURE_LOCK:
            side = _capture_stream(device)
            side.wait_stream(stream)
            with torch.cuda.stream(side):
                res = seg.chain(inputs.vals, inputs.masks)
            stream.wait_stream(side)
        outs = []
        for v, m in res:
            for t in (v, m):
                if isinstance(t, torch.Tensor):
                    t.record_stream(stream)
            outs.append((v[:n], None if m is None else m[:n]))
        nbytes = max(0, torch.cuda.memory_allocated(device) - before)
        return outs, transfers, nbytes

    def _capture(self, seg: _DeviceSegment, table: FeatureTable, n: int,
                 n_pad: int, device: torch.device, stream) -> Tuple:
        """Capture the duals at a bucket they already ran at eagerly (the
        warm-up), on the capture stream, into the plan's pool."""
        from .ops import cuda_build
        t0 = time.perf_counter()
        inputs = _Inputs(seg, table, n_pad, device)
        transfers = inputs.stage(seg, table, n)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        with _CAPTURE_LOCK:
            side = _capture_stream(device)
            side.wait_stream(stream)
            before = torch.cuda.memory_reserved(device)
            graph = torch.cuda.CUDAGraph()
            with cuda_build.capturing() as cap, torch.cuda.stream(side):
                graph.capture_begin(pool=self._pool,
                                    capture_error_mode="thread_local")
                try:
                    outs = seg.chain(inputs.vals, inputs.masks)
                finally:
                    graph.capture_end()
            stream.wait_stream(side)
            grown = torch.cuda.memory_reserved(device) - before
        seg.captures.append((n_pad, time.perf_counter() - t0))
        nbytes = max(0, grown) + inputs.nbytes()
        return (_Graph(graph, inputs, outs, dict(cap.counts),
                       list(cap.after), nbytes), transfers)


def _observe_staging(t0: float) -> None:
    if _obs_metrics.metrics_enabled():
        _obs_metrics.observe(
            "tg_plan_transfer_seconds", time.perf_counter() - t0,
            help="input staging per planned segment")


# ---------------------------------------------------------------------------
# Plan construction
# ---------------------------------------------------------------------------

def _build_plan(stages: List[Any], table: FeatureTable,
                keep_intermediates: bool, extra_keep: Sequence[str],
                cat: str) -> Optional[TransformPlan]:
    """Partition ``stages`` (topological order) into host waves and device
    segments and probe each output's type and metadata. None when the
    sequence has nothing worth fusing."""
    producer: Dict[str, Any] = {}
    is_dev: Dict[int, bool] = {}
    numeric: Dict[str, bool] = {nm: _numeric_table_col(table[nm])
                                for nm in table.column_names}
    for s in stages:
        dev = is_device_capable(s)
        if dev:
            # demoted to host when a runtime input is not numeric
            dev = all(numeric.get(nm, False) for nm in _device_inputs(s))
        is_dev[id(s)] = dev
        out = s.get_output()
        producer[out.name] = s
        numeric[out.name] = (dev
                             or out.feature_type.column_kind in DEVICE_KINDS)
    if not any(is_dev[id(s)] for s in stages):
        return None

    # host wave w runs before device segment w; a stage lands in the
    # earliest slot its producers allow, so device segments are maximal
    wave: Dict[int, int] = {}
    for s in stages:
        dev = is_dev[id(s)]
        w = 0
        for nm in (_device_inputs(s) if dev else _host_inputs(s)):
            p = producer.get(nm)
            if p is None:
                continue
            pw = wave[id(p)]
            # only a device -> host crossing pushes into the next wave
            w = max(w, pw + 1 if (is_dev[id(p)] and not dev) else pw)
        wave[id(s)] = w

    sched: List[Tuple[str, List[Any]]] = []
    for w in range(max(wave.values()) + 1):
        host = [s for s in stages if not is_dev[id(s)] and wave[id(s)] == w]
        if host:
            sched.append(("host", host))
        run: List[Any] = []
        for s in stages:
            if not is_dev[id(s)] or wave[id(s)] != w:
                continue
            # a fusion barrier (the Prediction emission) runs as its own
            # program
            if getattr(s, "device_fusion_barrier", False):
                if run:
                    sched.append(("dev", run))
                    run = []
                sched.append(("dev", [s]))
            else:
                run.append(s)
        if run:
            sched.append(("dev", run))

    steps: List[Tuple[str, Any]] = []
    for i, (kind, group) in enumerate(sched):
        if kind == "host":
            steps.append(("host", group))
            continue
        seg_out = {s.get_output().name for s in group}
        in_names: List[str] = []
        for s in group:
            for nm in _device_inputs(s):
                if nm not in seg_out and nm not in in_names:
                    in_names.append(nm)
        if keep_intermediates:
            out_names = [s.get_output().name for s in group]
        else:
            # materialize only what escapes the segment
            ext = set(extra_keep)
            for _, later in sched[i + 1:]:
                for t in later:
                    ext.update(_device_inputs(t) if is_dev[id(t)]
                               else _host_inputs(t))
            out_names = [s.get_output().name for s in group
                         if s.get_output().name in ext]
            if not out_names:
                continue   # a dead segment: plan-level DCE
        steps.append(("device", _DeviceSegment(group, in_names, out_names)))

    if not any(k == "device" for k, _ in steps):
        return None
    plan = TransformPlan(steps, cat)

    # zero-row probe: output types and metadata depend on fitted state and
    # input metadata, never on values, so one eager pass over an empty
    # table captures them
    produced = {s.get_output().name for s in stages}
    probe_cols: Dict[str, Column] = {}
    for s in stages:
        for nm in list(_host_inputs(s)) + list(_device_inputs(s)):
            if nm not in produced and nm in table and nm not in probe_cols:
                col = table[nm]
                probe_cols[nm] = Column(
                    col.feature_type, col.values[:0],
                    None if col.mask is None else col.mask[:0],
                    dict(col.metadata))
    probe = FeatureTable(probe_cols, 0, None, table.device)
    for s in stages:
        probe = s.transform(probe)
    for seg in plan.segments:
        for nm in seg.out_names:
            col = probe[nm]
            seg.out_meta[nm] = (col.feature_type, dict(col.metadata))
            v = col.values
            itemsize = (v.element_size() if isinstance(v, torch.Tensor)
                        else np.dtype(getattr(v, "dtype", np.float32)
                                      ).itemsize)
            seg.out_shape[nm] = (int(itemsize),
                                 tuple(int(x) for x in v.shape[1:]))
    return plan


def _schema_fingerprint(stages: List[Any], table: FeatureTable) -> Tuple:
    """Per-column (name, dtype, trailing shape, mask-is-None) of every
    external column the sequence reads from ``table``: a plan is reusable
    exactly when this matches (the row count is free)."""
    produced = {s.get_output().name for s in stages}
    items: List[Tuple] = []
    seen = set()
    for s in stages:
        for nm in list(_host_inputs(s)) + list(_device_inputs(s)):
            if nm in produced or nm in seen:
                continue
            seen.add(nm)
            if nm not in table:
                # response features are train-only; anything else missing
                # is the eager path's (descriptive) error to raise
                continue
            col = table[nm]
            v = col.values
            items.append((nm, _dtype_name(v),
                          tuple(int(x) for x in v.shape[1:]),
                          col.mask is None))
    return tuple(items)


def schema_fingerprint(stages: Sequence[Any],
                       table: FeatureTable) -> List[List[Any]]:
    """JSON-ready ``[[column, dtype, trailing shape, mask-is-None], ...]``
    of the plan cache's key; the row count is absent, so a fingerprint
    recorded at save time matches any request batch of the same schema
    (the serving warm start, ``serving/warmup.py``)."""
    return [[nm, dt, list(shape), bool(maskless)]
            for nm, dt, shape, maskless in _schema_fingerprint(list(stages),
                                                               table)]


def get_plan(stages: Sequence[Any], table: FeatureTable, *,
             keep_intermediates: bool = True,
             extra_keep: Sequence[str] = (),
             cat: str = "score",
             min_device_stages: int = 1) -> Optional[TransformPlan]:
    """Build (or fetch from the LRU) the plan of this stage sequence and
    input schema. None when planning is off or not applicable, or the
    sequence has fewer than ``min_device_stages`` device-capable stages
    (a train's layer runs ask for two)."""
    if not planning_applicable():
        return None
    stages = list(stages)
    if sum(1 for s in stages if is_device_capable(s)) < min_device_stages:
        return None
    fp = _schema_fingerprint(stages, table)
    key = (tuple((s.uid, id(s)) for s in stages), fp, keep_intermediates,
           tuple(sorted(extra_keep)))
    with _CACHE_LOCK:
        hit = _PLAN_CACHE.get(key)
        if hit is not None:
            _PLAN_CACHE.move_to_end(key)
            return hit[0]
    t0 = time.perf_counter()
    with _obs_span("plan.compile", cat=cat, stages=len(stages)) as sp:
        try:
            plan = _build_plan(stages, table, keep_intermediates, extra_keep,
                               cat)
        except Exception as e:  # infeasible: cached, eager from now on
            logger.warning("plan compile failed (%s: %s); eager dispatch "
                           "for this stage sequence", type(e).__name__, e)
            sp.set_attr(failed=f"{type(e).__name__}: {e}"[:200])
            plan = None
        if plan is not None:
            sp.set_attr(segments=plan.num_segments,
                        hostStages=plan.num_host_stages)
    if plan is not None:
        plan.uids = [str(getattr(s, "uid", "?")) for s in stages]
        plan.ident = "plan/" + ",".join(plan.uids)
        plan.fp_json = [[nm, dt, list(shape), bool(maskless)]
                        for nm, dt, shape, maskless in fp]
        plan.ident_hash = _ledger.cache_key_hash(
            (plan.ident, plan.fp_json, keep_intermediates,
             tuple(sorted(extra_keep))))
        _ledger.record_build(
            _ledger.current_subsystem("plan"),
            identity=(plan.ident + f"/ki={int(keep_intermediates)}"
                      + f"/ek={','.join(sorted(extra_keep))}"),
            key=_ledger.cache_key_hash(key), fingerprint=plan.fp_json,
            seconds=time.perf_counter() - t0, segments=plan.num_segments,
            cat=cat)
    with _CACHE_LOCK:
        _PLAN_CACHE[key] = (plan, tuple(stages))
        _PLAN_CACHE.move_to_end(key)
        while len(_PLAN_CACHE) > _PLAN_CACHE_MAX:
            evicted_key, (old, _) = _PLAN_CACHE.popitem(last=False)
            if old is not None:
                old.release()
            _ledger.record_eviction(_ledger.cache_key_hash(evicted_key))
    return plan


def export_plan_programs(plan: TransformPlan,
                         bucket: Optional[int] = None) -> int:
    """Offer the plan's segments to the program store. The port has no
    program store yet, so nothing is offered: 0."""
    return 0


def _concat_columns(a: Column, b: Column) -> Column:
    """Row-concatenate two halves of a bisected run: tensors on their
    device, host arrays with numpy; a mask on either half materializes on
    both."""
    va, vb = a.values, b.values
    if isinstance(va, torch.Tensor) or isinstance(vb, torch.Tensor):
        dev = va.device if isinstance(va, torch.Tensor) else vb.device
        vals = torch.cat([torch.as_tensor(va, device=dev),
                          torch.as_tensor(vb, device=dev)])
    else:
        vals = np.concatenate([va, vb])
    if a.mask is None and b.mask is None:
        mask = None
    elif isinstance(a.mask, torch.Tensor) or isinstance(b.mask, torch.Tensor):
        dev = vals.device if isinstance(vals, torch.Tensor) else "cpu"
        mask = torch.cat([torch.as_tensor(a.valid_mask(), device=dev)
                          if not isinstance(a.mask, torch.Tensor) else a.mask,
                          torch.as_tensor(b.valid_mask(), device=dev)
                          if not isinstance(b.mask, torch.Tensor)
                          else b.mask])
    else:
        mask = np.concatenate([a.valid_mask(), b.valid_mask()])
    return Column(a.feature_type, vals, mask, dict(a.metadata))


def _concat_tables(a: FeatureTable, b: FeatureTable) -> FeatureTable:
    cols = {nm: _concat_columns(a[nm], b[nm]) for nm in a.column_names}
    key = (None if a.key is None or b.key is None
           else np.concatenate([a.key, b.key]))
    return FeatureTable(cols, a.num_rows + b.num_rows, key, a.device)


def _execute_adaptive(plan: TransformPlan, table: FeatureTable
                      ) -> FeatureTable:
    """Run the plan; on resource exhaustion halve the rows into smaller
    buckets and join the halves: bit-equal by construction (every planned
    stage is a per-row map, padding rows are zeros). Below the minimum
    bucket a halving cannot shrink the program, so the error goes to the
    eager fallback."""
    from .robustness import resources
    from .utils.padding import _MIN_BUCKET
    try:
        return plan.execute(table)
    except Exception as e:
        n = table.num_rows
        if resources.classify_exhaustion(e) is None or n <= _MIN_BUCKET:
            raise
        mid = n // 2
        resources.record_downshift(
            "oom.plan", rows=n, splitRows=[mid, n - mid],
            error=f"{type(e).__name__}: {e}"[:200])
        logger.warning("planned transform run exhausted memory at %d rows; "
                       "halving to %d + %d", n, mid, n - mid)
        lo = _execute_adaptive(plan, table.take(np.arange(0, mid)))
        hi = _execute_adaptive(plan, table.take(np.arange(mid, n)))
        return _concat_tables(lo, hi)


def apply_planned(stages: Sequence[Any], table: FeatureTable, *,
                  keep_intermediates: bool = True,
                  extra_keep: Sequence[str] = (),
                  cat: str = "score",
                  min_device_stages: int = 1) -> Optional[FeatureTable]:
    """Run the stage sequence as a plan. Returns the transformed table, or
    None when the caller should run eagerly (planning off or not
    applicable, nothing to fuse, or the planned run raised: recorded as a
    FaultLog ``plan_fallback``). A plan never transforms its input table
    in place, so the eager run that follows gives identical results."""
    plan = get_plan(stages, table, keep_intermediates=keep_intermediates,
                    extra_keep=extra_keep, cat=cat,
                    min_device_stages=min_device_stages)
    if plan is None:
        return None
    return run_planned(plan, table)


def run_planned(plan: TransformPlan,
                table: FeatureTable) -> Optional[FeatureTable]:
    """Run a plan that ``get_plan`` gave: the transformed table, or None
    (recorded as a FaultLog ``plan_fallback``) when the caller should run
    eagerly."""
    try:
        return _execute_adaptive(plan, table)
    except Exception as e:
        from .robustness.policy import FaultLog, FaultReport
        FaultLog.record(FaultReport(
            site="plan.execute", kind="plan_fallback",
            detail={"error": f"{type(e).__name__}: {e}"[:300],
                    "segments": plan.num_segments,
                    "stages": list(plan.uids)}))
        logger.warning("planned transform run failed (%s: %s); eager "
                       "per-stage dispatch for this run",
                       type(e).__name__, e)
        return None
