"""Raw feature screening (counterpart of ``transmogrifai_tpu.filters``)."""
from .distribution import FeatureDistribution, Summary  # noqa: F401
from .raw_feature_filter import (  # noqa: F401
    RawFeatureFilter, RawFeatureFilterResults,
)
