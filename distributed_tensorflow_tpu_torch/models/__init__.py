"""Models of the port: the causal pre-LN decoder (``transformer``: serving
and training) and ResNet-50 (``resnet``) with its loss (``common``)."""
