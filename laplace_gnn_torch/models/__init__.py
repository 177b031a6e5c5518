from .base_gnn import BaseGNN
from .layers import GATConv, GCNConv, GraphSAGEConv
from .models import (MODEL_REGISTRY, GAT, GCN, STEGCN, AttSTEGCN, FusedAdjOp,
                     GraphSAGE, LoRASTEGCN, STEGraphSAGE)
from .sparse_gnn import (SparseGAT, SparseGATConv, SparseGCN, SparseGCNII,
                         SparseGCNIIConv, SparseSAGE, SparseSAGEConv)

__all__ = ["BaseGNN", "GATConv", "GCNConv", "GraphSAGEConv", "GAT", "GCN",
           "STEGCN", "AttSTEGCN", "GraphSAGE", "LoRASTEGCN", "STEGraphSAGE",
           "FusedAdjOp", "MODEL_REGISTRY", "SparseGAT", "SparseGATConv",
           "SparseGCN", "SparseGCNII", "SparseGCNIIConv", "SparseSAGE",
           "SparseSAGEConv"]
