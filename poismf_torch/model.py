"""Alias of :mod:`poismf_torch.models.poismf` (as ``poismf_tpu.model`` is
of the JAX package's)."""

from .models.poismf import PoisMF

__all__ = ["PoisMF"]
