"""Histogram engine of tree growth (counterpart of
``transmogrifai_tpu.histeng``)."""
from .engine import build_hist, build_node_hist
from .kernels import (hist_matmul, hist_matmul_plain, node_hist_matmul,
                      node_hist_plain, pinned_row_sum)

__all__ = ["build_hist", "build_node_hist", "hist_matmul",
           "hist_matmul_plain", "node_hist_matmul", "node_hist_plain",
           "pinned_row_sum"]
