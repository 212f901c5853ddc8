"""Models of the port: the causal pre-LN decoder (``transformer``: serving
and training), ResNet-50 (``resnet``), Wide&Deep (``wide_deep``), the MNIST
MLP (``mlp``) and the CIFAR-10 CNN (``cnn``), with the classification loss
and eval adapters (``common``)."""

from .cnn import CNN, CNNConfig
from .mlp import MLP, MLPConfig

__all__ = ["CNN", "CNNConfig", "MLP", "MLPConfig"]
