from .checkpoint import (TrainCheckpointer, load_laplace, load_pytree,
                         save_laplace, save_pytree)
