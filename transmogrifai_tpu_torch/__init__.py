"""transmogrifai_tpu_torch: the PyTorch/CUDA port of transmogrifai_tpu.

Training: ``OpWorkflow().set_reader(reader)`` (or ``set_input_dataset``
with columns or records) ``.set_result_features(pred).train()`` fits typed
raw features (numbers, text, pick lists; ``readers.DataReaders`` reads a
CSV) through ``transmogrify -> sanity_check -> ModelSelector`` (the
binary, multiclass and regression factories) on an NVIDIA GPU (the tree
families' split and leaf histograms in hand-written CUDA kernels), with
the raw feature filter (``filters.RawFeatureFilter``) and workflow-level
cross-validation on request; ``model.model_insights()`` reports it and
``insights.RecordInsightsLOCO`` explains each scored row on the card.
Event records aggregate per key (``readers.aggregates``,
``aggregators``); ``runner.OpWorkflowRunner`` and ``runner.OpApp`` run a
workflow's train, score, evaluate and features runs as an application.
Saving: ``save_model`` (``OpWorkflowModel.save``) writes a trained model in
the JAX package's format, and ``load_model`` reads a model that either
package saved. Serving: ``OpWorkflowModel.score`` / ``score_function``
score a loaded or a trained one,
with the forest descent in hand-written CUDA kernels (``csrc/``). Entry
points run on CUDA unless given ``device="cpu"``.
"""
from .dsl import transmogrify
from .features import FeatureBuilder
from .evaluators import Evaluators
from .impl.selector.factories import (
    BinaryClassificationModelSelector, MultiClassificationModelSelector,
    RegressionModelSelector,
)
from .local.scoring import micro_batch_score_function, score_function
from .persistence import load_model, save_model
from .readers import DataReaders
from .table import Column, FeatureTable
from .workflow import OpWorkflow, OpWorkflowModel

__all__ = ["load_model", "save_model", "OpWorkflow", "OpWorkflowModel", "FeatureBuilder",
           "DataReaders",
           "BinaryClassificationModelSelector",
           "MultiClassificationModelSelector", "RegressionModelSelector",
           "Evaluators", "transmogrify",
           "FeatureTable", "Column", "score_function",
           "micro_batch_score_function"]
