"""``python -m laplace_gnn_torch.native.build``: compile the C++ graph
preprocessing library and print its path."""

from . import build

if __name__ == "__main__":
    print(build(verbose=True))
