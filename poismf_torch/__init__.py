"""PyTorch port of poismf_tpu: non-Bayesian Poisson matrix factorization
of sparse counts, with the hot loop's kernels written by hand in CUDA for
NVIDIA Hopper (``poismf_torch/csrc``).  Imports neither JAX nor the JAX
package."""

from .models.poismf import PoisMF

__version__ = "0.1.0"
__all__ = ["PoisMF", "__version__"]
