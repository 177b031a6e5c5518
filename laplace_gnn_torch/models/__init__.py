from .base_gnn import BaseGNN
from .layers import GATConv, GCNConv, GraphSAGEConv
from .models import (MODEL_REGISTRY, GAT, GCN, STEGCN, AttSTEGCN, FusedAdjOp,
                     GraphSAGE, LoRASTEGCN, STEGraphSAGE)

__all__ = ["BaseGNN", "GATConv", "GCNConv", "GraphSAGEConv", "GAT", "GCN",
           "STEGCN", "AttSTEGCN", "GraphSAGE", "LoRASTEGCN", "STEGraphSAGE",
           "FusedAdjOp", "MODEL_REGISTRY"]
