from .pytree import (DEFAULT_EXCLUDE, merge_split, named_leaves,
                     parameters_per_layer, path_mask, posterior_mask,
                     split_by_mask, tree_add, tree_dot, tree_random_normal,
                     tree_scale, tree_size, tree_unflattener, tree_vector,
                     tree_zeros_like)
from .checkpoint import (TrainCheckpointer, load_laplace, load_pytree,
                         save_laplace, save_pytree)
from .metrics import (RunningNLLMetric, accuracy, brier_score,
                      expected_calibration_error, expand_prior_precision,
                      fix_prior_prec_structure, mse_loss, nll_loss,
                      validate)
