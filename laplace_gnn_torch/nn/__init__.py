from .module import (Identity, Linear, TapCollector, activation_resolver,
                     dropout, get_subtree, make_norm, set_subtree)

__all__ = ["Identity", "Linear", "TapCollector", "activation_resolver",
           "dropout", "get_subtree", "make_norm", "set_subtree"]
