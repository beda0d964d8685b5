"""Run configuration, workflow runner and command-line app (counterpart
of ``transmogrifai_tpu.runner``).

``OpParams`` is the JSON run configuration (stage parameters, model and
metrics locations). ``OpWorkflowRunner`` wires readers, the workflow and
an evaluator for the run types ``train``, ``score``, ``streamingScore``,
``features`` and ``evaluate``, and ``OpApp`` parses a command line into
one run. The runner trains and scores on its workflow's device (the CUDA
device unless the workflow was built with ``device="cpu"``); a saved
model loads onto that device.

Scores and raw features are written by the output path's extension:
``.avro`` through ``utils.avro`` (the records the JAX package writes),
``.csv`` with the text pandas' ``to_csv(index=False)`` writes; any other
extension raises (Parquet: the port is to write the format itself, as
``utils.avro`` writes Avro; ROADMAP Queue 1 item 11). The JAX
package's ``features`` run always writes Parquet; the port's writes by
extension. ``log_stage_metrics`` attaches a ``utils.profiler.StageProfiler``
to the workflow, and a train writes its ``appMetrics``.
"""
from __future__ import annotations

import argparse
import csv
import json
import math
import os
from typing import Any, Dict, List, Optional

import numpy as np

from .readers.readers import Frame
from .table import FeatureTable
from .workflow import OpWorkflow, OpWorkflowModel


class OpParams:
    """JSON run configuration."""

    def __init__(self,
                 stage_params: Optional[Dict[str, Dict[str, Any]]] = None,
                 reader_params: Optional[Dict[str, Any]] = None,
                 model_location: Optional[str] = None,
                 write_location: Optional[str] = None,
                 metrics_location: Optional[str] = None,
                 log_stage_metrics: bool = False,
                 custom_params: Optional[Dict[str, Any]] = None):
        self.stage_params = dict(stage_params or {})
        self.reader_params = dict(reader_params or {})
        self.model_location = model_location
        self.write_location = write_location
        self.metrics_location = metrics_location
        self.log_stage_metrics = log_stage_metrics
        self.custom_params = dict(custom_params or {})

    def to_json(self) -> Dict[str, Any]:
        return {
            "stageParams": self.stage_params,
            "readerParams": self.reader_params,
            "modelLocation": self.model_location,
            "writeLocation": self.write_location,
            "metricsLocation": self.metrics_location,
            "logStageMetrics": self.log_stage_metrics,
            "customParams": self.custom_params,
        }

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "OpParams":
        return OpParams(
            stage_params=d.get("stageParams"),
            reader_params=d.get("readerParams"),
            model_location=d.get("modelLocation"),
            write_location=d.get("writeLocation"),
            metrics_location=d.get("metricsLocation"),
            log_stage_metrics=bool(d.get("logStageMetrics", False)),
            custom_params=d.get("customParams"),
        )

    @staticmethod
    def from_file(path: str) -> "OpParams":
        with open(path) as fh:
            return OpParams.from_json(json.load(fh))


def table_to_frame(table: FeatureTable) -> Frame:
    """A table as the frame the JAX package's ``table_to_dataframe`` makes
    of it: the key first (``FeatureTable.KEY``), a prediction row as one
    {key: value} dict, a vector row as a list of floats, a numeric value
    as a python number (None missing), any other value as it is (None
    missing); columns typed as a DataFrame types them (``Frame.of``)."""
    data: Dict[str, Any] = {}
    if table.key is not None:
        data[FeatureTable.KEY] = list(table.key)
    for name in table.column_names:
        col = table[name]
        vals = np.asarray(col.host_values())
        valid = col.valid_mask()
        if vals.ndim > 1:
            keys = col.metadata.get("keys")
            if keys:
                data[name] = [dict(zip(keys, row)) for row in vals.tolist()]
            else:
                data[name] = [list(map(float, row)) for row in vals.tolist()]
        elif col.kind in ("real", "binary", "integral", "date"):
            out = vals.astype(object)
            out[~valid] = None
            data[name] = out
        else:
            data[name] = [v if ok else None for v, ok in zip(vals, valid)]
    return Frame.of(data)


def table_to_records(table: FeatureTable) -> List[Dict[str, Any]]:
    """One dict a row (``table_to_frame`` then ``to_dict("records")``)."""
    return table_to_frame(table).records()


def _csv_cell(v: Any) -> str:
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return ""
    return str(v)


def write_csv(path: str, frame: Frame) -> None:
    """The frame as pandas' ``to_csv(index=False)`` writes it: a header,
    then one line a row; a missing cell (None or NaN) is empty, any other
    cell is ``str`` of its value, quoted where it holds a comma, a quote
    or a line break."""
    names = list(frame.columns)
    cols = [frame[n].tolist() for n in names]
    with open(path, "w", newline="", encoding="utf-8") as fh:
        w = csv.writer(fh, lineterminator="\n")
        w.writerow(names)
        for row in zip(*cols):
            w.writerow([_csv_cell(v) for v in row])


def write_scores(frame: Frame, path: str) -> None:
    """Write a score (or raw feature) frame by the path's extension."""
    if not path.endswith((".avro", ".csv")):
        raise ValueError(
            f"cannot write {path!r}: the port writes .avro and .csv; "
            f"Parquet is not written yet: the port is to write the format "
            f"itself (ROADMAP Queue 1 item 11)")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if path.endswith(".avro"):
        from .utils.avro import write_avro
        write_avro(path, frame.records())
    else:
        write_csv(path, frame)


def _concat(frames: List[Frame]) -> Frame:
    """Frames of the same columns one after another (``pd.concat``)."""
    return Frame({n: np.concatenate([f[n] for f in frames])
                  for n in frames[0].columns})


class OpWorkflowRunnerResult:
    """What one run produced."""

    def __init__(self, run_type: str):
        self.run_type = run_type
        self.model: Optional[OpWorkflowModel] = None
        self.metrics: Dict[str, Any] = {}
        self.scores: Optional[FeatureTable] = None
        self.score_batches: int = 0


class RunType:
    TRAIN = "train"
    SCORE = "score"
    STREAMING_SCORE = "streamingScore"
    FEATURES = "features"
    EVALUATE = "evaluate"
    ALL = (TRAIN, SCORE, STREAMING_SCORE, FEATURES, EVALUATE)


class OpWorkflowRunner:
    """Readers, a workflow and an evaluator wired for each run type."""

    def __init__(self, workflow: OpWorkflow,
                 train_reader=None, score_reader=None,
                 streaming_score_reader=None,
                 evaluator=None,
                 label_feature=None, prediction_feature=None):
        self.workflow = workflow
        self.train_reader = train_reader
        self.score_reader = score_reader
        self.streaming_score_reader = streaming_score_reader
        self.evaluator = evaluator
        self.label_feature = label_feature
        self.prediction_feature = prediction_feature

    def _eval(self):
        ev = self.evaluator
        if ev is None:
            return None
        if self.label_feature is not None:
            ev.set_label_col(self.label_feature)
        if self.prediction_feature is not None:
            ev.set_prediction_col(self.prediction_feature)
        return ev

    def run(self, run_type: str, params: Optional[OpParams] = None
            ) -> OpWorkflowRunnerResult:
        params = params or OpParams()
        if params.stage_params:
            self.workflow.set_parameters(
                {"stageParams": params.stage_params})
        if params.log_stage_metrics and self.workflow.profiler is None:
            self.workflow.with_profiler()
        handler = {
            RunType.TRAIN: self._train,
            RunType.SCORE: self._score,
            RunType.STREAMING_SCORE: self._streaming_score,
            RunType.FEATURES: self._features,
            RunType.EVALUATE: self._evaluate,
        }.get(run_type)
        if handler is None:
            raise ValueError(f"unknown run type {run_type!r}; one of "
                             f"{RunType.ALL}")
        result = OpWorkflowRunnerResult(run_type)
        handler(result, params)
        if params.metrics_location and result.metrics:
            os.makedirs(os.path.dirname(params.metrics_location) or ".",
                        exist_ok=True)
            with open(params.metrics_location, "w") as fh:
                json.dump(result.metrics, fh, indent=2, default=str)
        return result

    def _metrics(self, ev, table: FeatureTable) -> Dict[str, Any]:
        return {k: v for k, v in ev.evaluate_all(table).items()
                if isinstance(v, (int, float))}

    def _train(self, result: OpWorkflowRunnerResult,
               params: OpParams) -> None:
        if self.train_reader is not None:
            self.workflow.set_reader(self.train_reader)
        model = self.workflow.train()
        result.model = model
        if params.model_location:
            model.save(params.model_location)
        ev = self._eval()
        if ev is not None and model.train_table is not None:
            result.metrics["trainEvaluation"] = self._metrics(
                ev, model.train_table)
        result.metrics["summary"] = model.summary()
        if self.workflow.profiler is not None:
            result.metrics["appMetrics"] = self.workflow.profiler.app_metrics()

    def _load_model(self, params: OpParams) -> OpWorkflowModel:
        if params.model_location:
            return OpWorkflowModel.load(params.model_location,
                                        device=self.workflow.device,
                                        workflow=self.workflow)
        if self.train_reader is not None:
            self.workflow.set_reader(self.train_reader)
        return self.workflow.train()

    def _score(self, result: OpWorkflowRunnerResult,
               params: OpParams) -> None:
        model = self._load_model(params)
        reader = self.score_reader or self.train_reader
        scored = model.score(reader=reader) if reader is not None \
            else model.score()
        result.model = model
        result.scores = scored
        ev = self._eval()
        if ev is not None:
            result.metrics["scoreEvaluation"] = self._metrics(ev, scored)
        if params.write_location:
            write_scores(table_to_frame(scored), params.write_location)

    def _streaming_score(self, result: OpWorkflowRunnerResult,
                         params: OpParams) -> None:
        model = self._load_model(params)
        reader = self.streaming_score_reader
        if reader is None:
            raise ValueError("streamingScore needs a streaming_score_reader")
        frames = []
        for batch in reader.stream_tables(model.raw_features):
            frames.append(table_to_frame(model.score(table=batch)))
        result.model = model
        result.score_batches = len(frames)
        if params.write_location and frames:
            write_scores(_concat(frames), params.write_location)

    def _features(self, result: OpWorkflowRunnerResult,
                  params: OpParams) -> None:
        reader = self.train_reader or self.workflow.reader
        if reader is None:
            raise ValueError("features run needs a reader")
        if not self.workflow.raw_features:
            raise ValueError("call set_result_features before a features "
                             "run")
        table = reader.generate_table(self.workflow.raw_features)
        result.scores = table
        if params.write_location:
            write_scores(table_to_frame(table), params.write_location)

    def _evaluate(self, result: OpWorkflowRunnerResult,
                  params: OpParams) -> None:
        if self.evaluator is None:
            raise ValueError("evaluate run needs an evaluator")
        self._score(result, params)
        result.metrics["evaluation"] = result.metrics.pop(
            "scoreEvaluation", {})


class OpApp:
    """Command-line entry: ``OpApp(runner).main(argv)`` runs one run
    type with the locations the arguments give."""

    def __init__(self, runner: OpWorkflowRunner):
        self.runner = runner

    def parse_args(self, argv: Optional[List[str]] = None
                   ) -> argparse.Namespace:
        p = argparse.ArgumentParser(description="transmogrifai_tpu_torch app")
        p.add_argument("--run-type", required=True, choices=RunType.ALL)
        p.add_argument("--param-location", default=None,
                       help="path to an OpParams JSON file")
        p.add_argument("--model-location", default=None)
        p.add_argument("--write-location", default=None)
        p.add_argument("--metrics-location", default=None)
        return p.parse_args(argv)

    def main(self, argv: Optional[List[str]] = None
             ) -> OpWorkflowRunnerResult:
        a = self.parse_args(argv)
        params = (OpParams.from_file(a.param_location)
                  if a.param_location else OpParams())
        for attr, val in (("model_location", a.model_location),
                          ("write_location", a.write_location),
                          ("metrics_location", a.metrics_location)):
            if val:
                setattr(params, attr, val)
        return self.runner.run(a.run_type, params)
