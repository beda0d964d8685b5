"""Build and version stamp of a saved model (counterpart of
``transmogrifai_tpu.utils.version``): ``plan.json``'s ``versionInfo``."""
from __future__ import annotations

import os
import subprocess
import time
from functools import lru_cache
from typing import Dict

#: the JAX package's framework version: the saved format is its
FRAMEWORK_VERSION = "0.1.0"


@lru_cache(maxsize=1)
def git_sha() -> str:
    """The short commit of the checkout holding this package, or
    "unknown" outside a git checkout."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], capture_output=True,
            text=True, timeout=5,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        return out.stdout.strip() or "unknown"
    except Exception:
        return "unknown"


def version_info() -> Dict[str, str]:
    return {"version": FRAMEWORK_VERSION, "gitSha": git_sha(),
            "savedAt": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())}
