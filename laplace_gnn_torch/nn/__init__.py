from .module import (ACTIVATIONS, CNN, MLP, BatchNorm, Conv2d,
                     DictInputModel, Identity, LayerNorm, Linear,
                     TapCollector, activation_resolver, dropout, get_subtree,
                     make_norm, set_subtree)

__all__ = ["ACTIVATIONS", "CNN", "MLP", "BatchNorm", "Conv2d",
           "DictInputModel", "Identity", "LayerNorm", "Linear",
           "TapCollector", "activation_resolver", "dropout", "get_subtree",
           "make_norm", "set_subtree"]
