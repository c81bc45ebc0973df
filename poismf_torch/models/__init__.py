from .poismf import PoisMF

__all__ = ["PoisMF"]
