from .prediction_deindexer import PredictionDeIndexer, PredictionDeIndexerModel

__all__ = ["PredictionDeIndexer", "PredictionDeIndexerModel"]
