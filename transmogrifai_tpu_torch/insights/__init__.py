"""Model and record insights (counterpart of
``transmogrifai_tpu.insights``)."""
from .model_insights import ModelInsights  # noqa: F401
from .record_insights import (  # noqa: F401
    RecordInsightsCorr, RecordInsightsLOCO, TopKMaps,
)
