from .base_gnn import BaseGNN
from .layers import GCNConv
from .models import GCN, STEGCN, FusedAdjOp

__all__ = ["BaseGNN", "GCNConv", "GCN", "STEGCN", "FusedAdjOp"]
