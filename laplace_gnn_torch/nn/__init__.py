from .module import (BatchNorm, Identity, LayerNorm, Linear, TapCollector,
                     activation_resolver, dropout, get_subtree, make_norm,
                     set_subtree)

__all__ = ["BatchNorm", "Identity", "LayerNorm", "Linear", "TapCollector",
           "activation_resolver", "dropout", "get_subtree", "make_norm",
           "set_subtree"]
