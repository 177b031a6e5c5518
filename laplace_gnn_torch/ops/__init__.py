from .adjacency import (binarize_ste, fill_diagonal, fill_diagonal_any,
                        normalize_adj, train_adj_mask)
from .fused_spmm import (StaticNormAdjOp, core, core_reference,
                         norm_aggregate, ste_norm_aggregate)
from .linalg import batched_eigvalsh, batched_symeig, symeig
from .spmm import aggregate

__all__ = ["binarize_ste", "fill_diagonal", "fill_diagonal_any",
           "normalize_adj", "train_adj_mask", "StaticNormAdjOp", "core",
           "core_reference", "norm_aggregate", "ste_norm_aggregate",
           "batched_eigvalsh", "batched_symeig", "symeig", "aggregate"]
