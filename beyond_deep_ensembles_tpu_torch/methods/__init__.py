"""Posterior methods (counterpart of ``beyond_deep_ensembles_tpu/methods``)."""
from .ensemble import deep_ensemble, predict
from .swag import swag_method

__all__ = ["deep_ensemble", "predict", "swag_method"]
