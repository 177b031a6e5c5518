from .data import (GraphData, adj_to_edge_index, edge_index_to_adj,
                   fully_connected_labels, get_knn_graph)
from .datasets import (add_random_splits, banana_dataset, gen_edge_index,
                       karate_club, load_data, load_npz, load_planetoid,
                       moons_dataset, sbm_dataset)
from .homophily import (avg_local_homophilies, avg_receptive_field_degree,
                        edge_diff, global_homophily, interaction_bound,
                        label_informativeness, local_homophily,
                        test_receptive_field)
from .container import (FastAggGraph, SparseGraph, add_ell_format, make_spmm,
                        sparse_from_edge_index)
from .plots import (class_sort_order, count_type_edges, get_learned_graphs,
                    plot_adjacency_by_class, plot_avg_local_homophily,
                    plot_degree_distribution, plot_interaction_bounds)
