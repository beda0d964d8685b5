"""Row-count bucketing (a copy of ``transmogrifai_tpu.utils.padding``'s
``row_bucket`` / ``bucket_for`` / ``padded_bytes``). The port pads rows to
the same buckets as the JAX package wherever a padded row changes a result
(the tree fits bin and sample the padded matrix, so the bucket is part of
the model) and where a program is reused per shape: a planned segment
runs at its bucket, one CUDA graph a bucket (``plan.py``)."""
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


def padded_bytes(n_pad: int, trailing=(), itemsize: int = 4,
                 with_mask: bool = True) -> int:
    """Device bytes one padded column stages: ``n_pad`` rows of
    ``trailing``-shaped ``itemsize`` cells, plus the bool validity mask of
    one byte a row that a planned segment always stages (the JAX
    package's ``padded_bytes``)."""
    cells = 1
    for x in trailing:
        cells *= int(x)
    total = int(n_pad) * cells * int(itemsize)
    if with_mask:
        total += int(n_pad)
    return total
