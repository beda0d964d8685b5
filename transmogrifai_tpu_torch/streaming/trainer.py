"""Streaming DAG trainer (counterpart of
``transmogrifai_tpu.streaming.trainer``): layer-wise estimator fits as
chunk folds.

The streaming dual of ``dag.fit_and_transform_dag``: estimators fit layer
by layer, but each fit makes one or more *passes* over the
:class:`~.source.ChunkSource` through the :class:`~.feed.DeviceFeed`,
every chunk uploaded to the card and transformed there through the
already-fitted upstream stages behind the consumer. An estimator opts in
with::

    def fit_streaming(self, run: StreamRun) -> Transformer

and drives its passes through ``run.fold(pass_id, fold, extract)``, where
the chunk checkpoints (``checkpoint``), the ``stream.fold`` site, the
memory-pressure downshift and the O(chunk) residency bound live. A stage
without the hook fails the train with a descriptive error: a streamed fit
never materializes the dataset behind the caller's back.

Two input-engine hooks ride on the same contract:

* every ``StreamRun`` carries the run's transformed-chunk cache and the
  identity of its fitted upstream stack, so repeat passes of one stage
  (the GBT's ``1 + trees x (depth + 1)``) replay cached chunks;
* an estimator whose whole streaming fit is one fold pass may expose
  ``fit_streaming_prep(run) -> (pass_id, fold, extract, finish)`` (or
  None when it needs no pass); when a DAG layer holds two or more such
  stages, the trainer fuses their passes into one chunk sweep through a
  ``CompositeFold``. The fused state checkpoints under the joined uids,
  so kill and resume stay bit-exact; ``TG_STREAM_FUSE=0`` turns fusion
  off.

The pass ids are a persistence contract (checkpoint keys embed them):
``"fills"``, ``"sanity"``, ``"edges"``, ``"t{t}.l{lv}"``, ``"t{t}.leaf"``
and ``"+"``-joined ids of fused passes, as in the JAX package.

Telemetry, by the JAX package's names: each pass runs under a
``stream.pass`` span, between the flight recorder's ``stream.pass`` and
``stream.pass_done`` events, and is one ``stream`` record of the compile
ledger (an out-of-memory downshift's rerun at a halved chunk budget is
classified as a bucket change).
"""
from __future__ import annotations

import logging
import os

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

import torch

from ..observability import blackbox as _blackbox
from ..observability import ledger as _obs_ledger
from ..observability.trace import span as _obs_span
from ..robustness import faults, resources
from ..robustness.policy import FaultLog, FaultReport
from ..stages.base import Estimator, Transformer
from ..table import FeatureTable
from .cache import ChunkCache, transform_identity
from .checkpoint import PASS_COMPLETE, StreamCheckpoint
from .feed import DeviceFeed, FeedStats
from .folds import MonoidFold
from .source import ChunkSource

FUSE_ENV = "TG_STREAM_FUSE"


def env_fuse() -> bool:
    return os.environ.get(FUSE_ENV, "1").lower() not in ("0", "false", "no")

logger = logging.getLogger(__name__)


class StreamingNotSupportedError(TypeError):
    """A DAG stage cannot fit as a streaming fold. Names the stage and the
    hook it would need: the streamed train fails up front instead of
    materializing the dataset."""


class StreamRun:
    """One estimator's view of the stream: fold passes and a schema probe.
    ``device``: where the feed puts the chunks (None: the CUDA device)."""

    def __init__(self, source: ChunkSource, upstream: List[Transformer],
                 stage_uid: str, checkpoint: Optional[StreamCheckpoint] = None,
                 prefetch: Optional[int] = None,
                 stats: Optional[FeedStats] = None,
                 cache: Optional[ChunkCache] = None,
                 workers: Optional[int] = None,
                 device: Optional[torch.device] = None):
        self.source = source
        self.device = device
        self.upstream = list(upstream)
        self.stage_uid = stage_uid
        self.checkpoint = checkpoint
        self.prefetch = prefetch
        self.stats = stats if stats is not None else FeedStats()
        self.cache = cache
        self.workers = workers
        self._probe: Optional[FeatureTable] = None
        self._cache_ident: Optional[str] = None

    @property
    def cache_ident(self) -> str:
        """Fitted-transform identity of this run's upstream stack, the third
        axis of the cache key (a chunk prepared under other upstream models
        is never replayed here)."""
        if self._cache_ident is None:
            self._cache_ident = transform_identity(self.upstream)
        return self._cache_ident

    @property
    def num_chunks(self) -> int:
        return self.source.num_chunks

    @property
    def chunk_rows(self) -> int:
        return self.source.chunk_rows

    def probe_table(self, rows: int = 256) -> FeatureTable:
        """A small transformed head-of-stream host table for the schema
        (vector widths, ``vector_meta`` groups), never the data itself."""
        if self._probe is None:
            chunk = next(iter(self.source.chunks(0)))
            table = chunk.table
            if table.num_rows > rows:
                table = table.take(np.arange(rows))
            for model in self.upstream:
                table = model.transform(table)
            self._probe = table
        return self._probe

    def fold(self, pass_id: str, fold: MonoidFold,
             extract: Callable[[FeatureTable], Tuple]) -> Any:
        """Run one full pass: ``state = fold(extract(chunk) for chunks)``.

        Restores a committed state for this (stage, pass) and continues
        from the next chunk not folded; commits after every
        ``TG_STREAM_CKPT_EVERY`` chunks and marks the pass complete at the
        end, so a resumed train repeats no completed pass and no committed
        chunk.

        Resource exhaustion (a chunk the card cannot hold, forwarded from
        the feed or raised by the fold) downshifts instead of dying: the
        chunk row budget halves and the pass continues from the
        committed-row prefix (the folded rows align with the new grid, old
        budget = 2 x new, so no row refolds and none is skipped). Commits
        after a downshift carry the re-chunked source's fingerprint and
        ``chunkRows``, which the restore recognizes (``with_chunk_rows``),
        so a kill in a downshifted pass resumes on the same schedule. The
        downshift is local to the pass; the floor is
        ``TG_OOM_MIN_CHUNK_ROWS``."""
        key = f"{self.stage_uid}/{pass_id}"
        src = self.source
        state, start = None, 0
        if self.checkpoint is not None:
            src, state, start = self._restore(key, pass_id, fold, src)
            if start == PASS_COMPLETE:
                return state
        if state is None:
            state, start = fold.zero(), 0
        every = self.checkpoint.every if self.checkpoint is not None else 0
        while True:
            folded = start
            _blackbox.record("stream.pass", uid=self.stage_uid,
                             passId=pass_id, fromChunk=start,
                             chunkRows=src.chunk_rows)
            _obs_ledger.record_build(
                "stream", identity=f"stream/{key}",
                key=f"{key}@{src.chunk_rows}", bucket=src.chunk_rows,
                fromChunk=start, chunks=src.num_chunks)
            try:
                with _obs_span("stream.pass", cat="train",
                               uid=self.stage_uid, passId=pass_id,
                               fromChunk=start,
                               chunkRows=src.chunk_rows), \
                        DeviceFeed(src, start=start,
                                   transforms=self.upstream,
                                   prefetch=self.prefetch,
                                   workers=self.workers, cache=self.cache,
                                   cache_ident=self.cache_ident,
                                   device=self.device) as feed:
                    try:
                        for chunk in feed:
                            faults.inject("stream.fold", key=pass_id)
                            state = fold.accumulate(state,
                                                    *extract(chunk.table))
                            folded = chunk.index + 1
                            if (self.checkpoint is not None
                                    and folded < src.num_chunks
                                    and (folded - start) % every == 0):
                                self.checkpoint.commit(
                                    key, fold.state_to_arrays(state),
                                    folded,
                                    fingerprint=src.fingerprint(),
                                    chunk_rows=src.chunk_rows)
                    finally:
                        self.stats.merge(feed.stats)
                break
            except Exception as e:
                src, start = self._downshift(e, src, folded, key, fold,
                                             state)
        if self.checkpoint is not None:
            self.checkpoint.commit(key, fold.state_to_arrays(state),
                                   PASS_COMPLETE,
                                   fingerprint=src.fingerprint(),
                                   chunk_rows=src.chunk_rows)
        _blackbox.record("stream.pass_done", uid=self.stage_uid,
                         passId=pass_id, chunks=folded)
        return state

    def _restore(self, key: str, pass_id: str, fold: MonoidFold, src):
        """Restore aware of the committed-row prefix: a record committed by
        a downshifted run carries its ``chunkRows``; when re-chunking the
        run's source at that budget gives the record's fingerprint, the
        pass resumes on the downshifted grid (the committed rows are a
        prefix of both schedules)."""
        rec = self.checkpoint.manifest.streams.get(key)
        if rec is not None and rec.get("fingerprint") != src.fingerprint():
            cr = rec.get("chunkRows")
            if cr and int(cr) != src.chunk_rows:
                try:
                    cand = src.with_chunk_rows(int(cr))
                except NotImplementedError:
                    cand = None
                if (cand is not None
                        and cand.fingerprint() == rec.get("fingerprint")):
                    src = cand
        arrays, start = self.checkpoint.restore(
            key, fingerprint=src.fingerprint())
        if arrays is None:
            return src, None, 0
        state = fold.state_from_arrays(arrays)
        detail = {"key": key, "pass": pass_id}
        if start != PASS_COMPLETE:
            detail["fromChunk"] = start
        if src is not self.source:
            detail["chunkRows"] = src.chunk_rows  # downshifted record
        FaultLog.record(FaultReport(site="stream.fold", kind="restored",
                                    detail=detail))
        return src, state, start

    def _downshift(self, exc: Exception, src, folded: int, key: str,
                   fold: MonoidFold, state):
        """Halve the chunk row budget after resource exhaustion, or re-raise
        what is not exhaustion or cannot halve. Returns ``(re-chunked
        source, next chunk on the new grid)``: ``folded`` chunks at the old
        budget are ``2 * folded`` at the new one, so the committed-row
        prefix holds row for row."""
        if resources.classify_exhaustion(exc) is None:
            raise exc
        new_rows = src.chunk_rows // 2
        if src.chunk_rows % 2 or new_rows < resources.min_chunk_rows():
            raise exc  # at (or below) the floor: exhaustion is fatal
        try:
            new_src = src.with_chunk_rows(new_rows)
        except NotImplementedError:
            raise exc  # source cannot re-chunk deterministically
        start = folded * 2
        resources.record_downshift(
            "oom.stream", stage=self.stage_uid,
            chunkRows=new_rows, fromChunk=start,
            error=f"{type(exc).__name__}: {exc}"[:200])
        logger.warning(
            "stream pass for %s exhausted memory at chunk_rows=%d; "
            "halving to %d and resuming at chunk %d",
            self.stage_uid, src.chunk_rows, new_rows, start)
        if self.checkpoint is not None:
            # commit the prefix under the new chunking, so a kill right
            # after the downshift resumes on the same grid
            self.checkpoint.commit(key, fold.state_to_arrays(state), start,
                                   fingerprint=new_src.fingerprint(),
                                   chunk_rows=new_rows)
        return new_src, start


def _fit_layer_fused(candidates, source, upstream, *, stream_checkpoint,
                     prefetch, workers, cache, stats, retry_policy,
                     device) -> Dict[str, Transformer]:
    """Fuse the independent one-pass prep fits of one DAG layer into one
    chunk sweep (they share one upstream, so none depends on another).
    Each stage's fold is one arm of a ``CompositeFold`` keyed by its uid;
    the fused state checkpoints under the joined uids, so a kill in the
    pass resumes the joint fold bit-exactly. Returns ``{uid: fitted
    model}`` of the stages that took part (a stage whose
    ``fit_streaming_prep`` returns None needs no pass and fits alone)."""
    from .folds import CompositeFold
    runs = {s.uid: StreamRun(source, upstream, s.uid, checkpoint=None,
                             prefetch=prefetch, stats=stats,
                             cache=cache, workers=workers, device=device)
            for s in candidates}
    specs = {}
    for s in candidates:
        spec = s.fit_streaming_prep(runs[s.uid])
        if spec is not None:
            specs[s.uid] = spec
    if len(specs) < 2:
        return {}
    stages = [s for s in candidates if s.uid in specs]
    fused_uid = "+".join(s.uid for s in stages)
    pass_id = "+".join(specs[s.uid][0] for s in stages)

    def _fit() -> Dict[str, Transformer]:
        for s in stages:
            faults.inject("preempt.stage_fit", key=s.uid)
        composite = CompositeFold({uid: spec[1]
                                   for uid, spec in specs.items()})
        extractors = {uid: spec[2] for uid, spec in specs.items()}

        def extract_all(table: FeatureTable) -> Tuple:
            return ({uid: ex(table) for uid, ex in extractors.items()},)

        fused_run = StreamRun(source, upstream, fused_uid,
                              checkpoint=stream_checkpoint,
                              prefetch=prefetch, stats=stats,
                              cache=cache, workers=workers, device=device)
        state = fused_run.fold(pass_id, composite, extract_all)
        return {uid: specs[uid][3](state[uid]) for uid in specs}

    if retry_policy is not None:
        return retry_policy.execute(
            _fit, site=f"stream.stage_fit[{fused_uid}]")
    return _fit()


def fit_dag_streaming(source: ChunkSource, layers, *,
                      checkpoint: Optional[Callable] = None,
                      stream_checkpoint: Optional[StreamCheckpoint] = None,
                      preloaded: Optional[Dict[str, Any]] = None,
                      retry_policy: Optional[Any] = None,
                      prefetch: Optional[int] = None,
                      cache: Optional[ChunkCache] = None,
                      workers: Optional[int] = None,
                      device: Optional[torch.device] = None,
                      ) -> Tuple[Dict[str, Any], List[Transformer], FeedStats]:
    """Fit every estimator of the layered DAG as streaming folds on
    ``device`` (None: the CUDA device).

    Returns ``(fitted {uid: model}, the transformers in topological order,
    the feed's summed stats)``. ``preloaded`` stages restore instead of
    refitting, ``checkpoint(model)`` commits each fitted stage, transient
    errors retry under ``retry_policy``. ``cache`` is the run's
    transformed-chunk cache (shared by every pass and stage); ``workers``
    sizes the feed's pool (None: ``TG_STREAM_WORKERS``).
    """
    pre = preloaded or {}
    fitted: Dict[str, Any] = {}
    upstream: List[Transformer] = []
    stats = FeedStats()
    for layer in layers:
        models: List[Transformer] = []
        fused: Dict[str, Transformer] = {}
        fusable = [stage for stage, _ in layer
                   if isinstance(stage, Estimator) and stage.uid not in pre
                   and hasattr(stage, "fit_streaming_prep")]
        if env_fuse() and len(fusable) >= 2:
            fused = _fit_layer_fused(
                fusable, source, upstream,
                stream_checkpoint=stream_checkpoint, prefetch=prefetch,
                workers=workers, cache=cache, stats=stats,
                retry_policy=retry_policy, device=device)
        for stage, _ in layer:
            if isinstance(stage, Estimator):
                if stage.uid in pre:
                    model = pre[stage.uid]
                    model.input_features = stage.input_features
                    model._output_feature = stage.get_output()
                    FaultLog.record(FaultReport(
                        site="dag.stage_fit", kind="restored",
                        detail={"uid": stage.uid,
                                "stage": type(stage).__name__}))
                elif stage.uid in fused:
                    model = fused[stage.uid]
                    if checkpoint is not None:
                        checkpoint(model)
                elif hasattr(stage, "fit_streaming"):
                    def _fit(stage=stage):
                        faults.inject("preempt.stage_fit", key=stage.uid)
                        run = StreamRun(source, upstream, stage.uid,
                                        checkpoint=stream_checkpoint,
                                        prefetch=prefetch, stats=stats,
                                        cache=cache, workers=workers,
                                        device=device)
                        return stage.fit_streaming(run)
                    if retry_policy is not None:
                        model = retry_policy.execute(
                            _fit, site=f"stream.stage_fit[{stage.uid}]")
                    else:
                        model = _fit()
                    if checkpoint is not None:
                        checkpoint(model)
                        if stream_checkpoint is not None:
                            # per-pass fold states are now redundant
                            stream_checkpoint.manifest.drop_streams(stage.uid)
                            stream_checkpoint.manifest.save()
                else:
                    raise StreamingNotSupportedError(
                        f"stage {type(stage).__name__} ({stage.uid}) does "
                        f"not implement fit_streaming(run) — it cannot fit "
                        f"on a chunk stream. Streaming-capable stages: "
                        f"RealVectorizer, SanityChecker, StreamingGBT")
                fitted[stage.uid] = model
                models.append(model)
            elif isinstance(stage, Transformer):
                models.append(stage)
            else:
                raise TypeError(
                    f"unexpected stage kind {type(stage).__name__}")
        if (fused and checkpoint is not None
                and stream_checkpoint is not None):
            # every fused stage's checkpoint is committed: the joint fold
            # state under the joined uids is not needed
            stream_checkpoint.manifest.drop_streams("+".join(fused))
            stream_checkpoint.manifest.save()
        upstream.extend(models)
    return fitted, upstream, stats
