from .isotonic import (  # noqa: F401
    IsotonicCalibratorModel, IsotonicRegressionCalibrator, pav_fit,
)
