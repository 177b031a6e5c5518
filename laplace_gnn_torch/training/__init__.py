from .marglik_gnn import (TrainingPrograms, make_neg_marglik_fn,
                          marglik_optimization, mean_eval)

__all__ = ["TrainingPrograms", "make_neg_marglik_fn", "marglik_optimization",
           "mean_eval"]
