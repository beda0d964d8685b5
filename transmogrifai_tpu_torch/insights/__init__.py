"""Model insights (counterpart of ``transmogrifai_tpu.insights``)."""
from .model_insights import ModelInsights  # noqa: F401
