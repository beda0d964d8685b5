"""transmogrifai_tpu_torch: the PyTorch/CUDA port of transmogrifai_tpu.

Two slices so far. Training: ``OpWorkflow().set_input_dataset(data)
.set_result_features(pred).train()`` fits ``transmogrify -> sanity_check ->
BinaryClassificationModelSelector`` with gradient-boosted trees on an NVIDIA
GPU (the leaf histograms in the hand-written ``hist_matmul`` kernel).
Serving: ``load_model`` reads a model that the JAX package saved, and
``OpWorkflowModel.score`` / ``score_function`` score it or a trained one,
with the forest descent in hand-written CUDA kernels (``csrc/``). Entry
points run on CUDA unless given ``device="cpu"``.
"""
from .dsl import transmogrify
from .features import FeatureBuilder
from .impl.selector.factories import BinaryClassificationModelSelector
from .local.scoring import micro_batch_score_function, score_function
from .persistence import load_model
from .table import Column, FeatureTable
from .workflow import OpWorkflow, OpWorkflowModel

__all__ = ["load_model", "OpWorkflow", "OpWorkflowModel", "FeatureBuilder",
           "BinaryClassificationModelSelector", "transmogrify",
           "FeatureTable", "Column", "score_function",
           "micro_batch_score_function"]
