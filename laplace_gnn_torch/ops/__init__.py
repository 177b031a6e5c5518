from .adjacency import (binarize_ste, fill_diagonal, fill_diagonal_any,
                        normalize_adj, train_adj_mask)
from .flash_attention import (flash_bwd, flash_bwd_reference, flash_fwd,
                              flash_fwd_reference, flash_masked_attention)
from .fused_spmm import (StaticNormAdjOp, core, core_reference,
                         norm_aggregate, ste_norm_aggregate)
from .linalg import batched_eigvalsh, batched_symeig, symeig
from .spmm import aggregate

__all__ = ["binarize_ste", "fill_diagonal", "fill_diagonal_any",
           "normalize_adj", "train_adj_mask", "StaticNormAdjOp", "core",
           "core_reference", "norm_aggregate", "ste_norm_aggregate",
           "batched_eigvalsh", "batched_symeig", "symeig", "aggregate",
           "flash_fwd", "flash_bwd", "flash_fwd_reference",
           "flash_bwd_reference", "flash_masked_attention"]
