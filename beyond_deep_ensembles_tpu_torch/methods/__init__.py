"""Posterior methods (counterpart of ``beyond_deep_ensembles_tpu/methods``)."""
from .ensemble import deep_ensemble, predict
from .ivon import ivon_method
from .laplace import laplace_method
from .sngp import sngp_method
from .swag import swag_method

__all__ = ["deep_ensemble", "ivon_method", "laplace_method", "predict", "sngp_method", "swag_method"]
