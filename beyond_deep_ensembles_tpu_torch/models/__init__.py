"""The port's models (counterpart of ``beyond_deep_ensembles_tpu/models``):
from-scratch backbones whose dense and conv layers take a kind, plain,
BBB-variational, Rank-1 or spectral (reference src/architectures/)."""
from .layers import make_conv, make_dense  # noqa: F401
from .mlp import RegressionMLP  # noqa: F401
from .resnet import PreResNet20, ResNet18, ResNet20, ResNet50  # noqa: F401
from .densenet import DenseNet, DenseNetClassifier  # noqa: F401
from .bert import BertClassifier, DistilBertConfig  # noqa: F401
from .tiramisu import MidasTiramisu  # noqa: F401
from .lenet import LeNet5  # noqa: F401
from .cnn_lstm import CNNLSTM, smooth_cnn_lstm  # noqa: F401
from .zoo import MLP, get_model  # noqa: F401
