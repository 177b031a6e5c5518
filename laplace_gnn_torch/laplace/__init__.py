from .kron import Kron

__all__ = ["Kron"]
