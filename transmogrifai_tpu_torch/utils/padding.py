"""Row-count bucketing (a copy of ``transmogrifai_tpu.utils.padding``'s
``row_bucket`` / ``bucket_for``). The port compiles nothing per shape, but
it pads rows to the same buckets as the JAX package wherever a padded row
changes a result: the tree fits bin and sample the padded matrix, so the
bucket is part of the model."""
from __future__ import annotations

import math

_STEPS_PER_OCTAVE = 4
_MIN_BUCKET = 256


def row_bucket(n: int) -> int:
    """Smallest bucket >= n on the geometric grid (multiples of 256, four
    buckets per octave)."""
    if n <= _MIN_BUCKET:
        return _MIN_BUCKET
    k = math.ceil(_STEPS_PER_OCTAVE * math.log2(n / _MIN_BUCKET))
    b = _MIN_BUCKET * 2 ** (k / _STEPS_PER_OCTAVE)
    b = int(math.ceil(b / _MIN_BUCKET) * _MIN_BUCKET)
    while b < n:  # guard rounding
        b += _MIN_BUCKET
    return b


def bucket_for(n: int, multiple_of: int = 1) -> int:
    """Bucket >= n that is also a multiple of ``multiple_of``."""
    b = row_bucket(n)
    if multiple_of > 1:
        b = int(math.ceil(b / multiple_of) * multiple_of)
    return b
