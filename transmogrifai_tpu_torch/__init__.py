"""transmogrifai_tpu_torch: the PyTorch/CUDA port of transmogrifai_tpu.

This slice serves: ``load_model`` reads a model that the JAX package trained
and saved, and ``OpWorkflowModel.score`` / ``score_function`` score it on an
NVIDIA GPU, with the tree ensembles' forest descent in hand-written CUDA
kernels (``csrc/``). Entry points run on CUDA unless given ``device="cpu"``.
"""
from .local.scoring import micro_batch_score_function, score_function
from .persistence import load_model
from .table import Column, FeatureTable
from .workflow import OpWorkflowModel

__all__ = ["load_model", "OpWorkflowModel", "FeatureTable", "Column",
           "score_function", "micro_batch_score_function"]
