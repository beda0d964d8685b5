"""Histogram engine of tree growth (counterpart of
``transmogrifai_tpu.histeng``)."""
from .engine import build_hist, build_node_hist, chaos_gate, engine_probe
from .host import bin_codes_host, build_node_hist_host, node_stat_sums
from .kernels import (hist_matmul, hist_matmul_plain, node_hist_matmul,
                      node_hist_plain, pinned_row_sum)

__all__ = ["bin_codes_host", "build_hist", "build_node_hist",
           "build_node_hist_host", "chaos_gate", "engine_probe", "hist_matmul", "node_stat_sums",
           "hist_matmul_plain", "node_hist_matmul", "node_hist_plain",
           "pinned_row_sum"]
