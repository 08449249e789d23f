"""Bayesian and stochastic layers and the model wrapper (counterpart of
``beyond_deep_ensembles_tpu/nn``; reference src/algos/bbb_layers.py,
rank1.py, dropout.py, src/architectures/frn.py, gauss.py and
src/algos/kernel/)."""
from .base import KL_COLLECTION, Model, sow_kl  # noqa: F401
from .gaussian import NoiseSource, blundell_mean_init, gaussian_param  # noqa: F401
from .bbb import BBBConv, BBBDense, LowRankBBBDense  # noqa: F401
from .rank1 import Rank1Conv, Rank1Dense  # noqa: F401
from .dropout import FixableDropout  # noqa: F401
from .frn import FilterResponseNorm, VariationalFilterResponseNorm  # noqa: F401
from .gauss import GaussLayer  # noqa: F401
from .norm import BatchNorm, StaticBatchNorm  # noqa: F401
from .sngp import RandomFourierFeatures, SNGPHead  # noqa: F401
from .spectral_norm import SpectralNormConv, SpectralNormDense  # noqa: F401
