"""Scale-out over a device mesh (counterpart of ``laplace_gnn_tpu/parallel``)
on ``torch.distributed``, one process per device.

Every module is ported: the mesh and placements (:mod:`.mesh`; a value
placed on the graph axis is the rank's row block), the partition plans
(:mod:`.partition`), the scaling model (:mod:`.scaling`), the partitioned
aggregations and sharded steps (:mod:`.sharded`) on the collectives of
:mod:`.collectives`, and the process group and hybrid ('dcn', 'graph',
'model') mesh with its edge-striped aggregates (:mod:`.distributed`)."""

from .distributed import (DcnAggGraph, hybrid_grid, initialize,
                          make_dcn_gat_aggregate, make_dcn_halo_aggregate,
                          make_hybrid_mesh, stripe_edges)
from .mesh import graph_sharding, make_mesh, replicated, shard_gnn_params
from .partition import (HaloPlan, Partition, apply_node_order, bandwidth,
                        build_halo_plan, degree_balanced_partition,
                        edge_balanced_blocks, pad_to_blocks,
                        partition_efficiency, rcm_order)
from .scaling import dcn_projection, projected_scaling
from .sharded import (HaloAggGraph, build_halo_exchange,
                      build_ring_halo_exchange, halo_widths,
                      make_halo_gat_aggregate, make_halo_sparse_aggregate,
                      make_ring_dense_aggregate,
                      make_ring_halo_sparse_aggregate,
                      make_row_sharded_gat_attention,
                      make_sharded_sparse_aggregate, make_sharded_train_step,
                      partition_sparse_graph, sharded_aggregate)

__all__ = [
    "DcnAggGraph", "hybrid_grid", "make_dcn_gat_aggregate",
    "make_dcn_halo_aggregate", "make_hybrid_mesh", "stripe_edges",
    "HaloAggGraph", "HaloPlan", "Partition", "apply_node_order", "bandwidth",
    "build_halo_exchange", "build_halo_plan", "build_ring_halo_exchange",
    "dcn_projection", "degree_balanced_partition", "edge_balanced_blocks",
    "graph_sharding", "halo_widths", "initialize", "make_halo_gat_aggregate",
    "make_halo_sparse_aggregate", "make_mesh", "make_ring_dense_aggregate",
    "make_ring_halo_sparse_aggregate", "make_row_sharded_gat_attention",
    "make_sharded_sparse_aggregate", "make_sharded_train_step",
    "pad_to_blocks", "partition_efficiency", "partition_sparse_graph",
    "projected_scaling", "rcm_order", "replicated", "shard_gnn_params",
    "sharded_aggregate"]
