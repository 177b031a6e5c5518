from .base_gnn import BaseGNN
from .layers import GATConv, GCNConv
from .models import GAT, GCN, STEGCN, FusedAdjOp

__all__ = ["BaseGNN", "GATConv", "GCNConv", "GAT", "GCN", "STEGCN",
           "FusedAdjOp"]
