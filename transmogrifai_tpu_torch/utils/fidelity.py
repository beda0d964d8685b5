"""Sweep-fidelity switch (counterpart of
``transmogrifai_tpu.utils.fidelity``).

The CV sweep's throughput defaults stack three approximations: 32,768-row
metric estimates, an 8,192-row split-search sample and 16-tree RF /
12-round GBT ranking ensembles. ``TG_SWEEP_FIDELITY=round4`` restores the
earlier defaults in one switch: ``max_eval_rows=65536``, a 16,384-row
split-search sample and no ensemble caps. The variable is read at call
time, so a long-lived process (or a test) can flip it without
re-importing.
"""
from __future__ import annotations

import os

ENV = "TG_SWEEP_FIDELITY"

#: the values the switch restores
ROUND4_MAX_EVAL_ROWS = 65536
ROUND4_SWEEP_HIST_SAMPLE = 16384


def round4_defaults() -> bool:
    """True when the process asked for the round-4 sweep defaults."""
    return os.environ.get(ENV, "").lower() in ("round4", "r4", "high")
