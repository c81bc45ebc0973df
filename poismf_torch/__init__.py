"""PyTorch port of poismf_tpu: non-Bayesian Poisson matrix factorization
of sparse counts, with the hot loop's kernels written by hand in CUDA for
NVIDIA Hopper (``poismf_torch/csrc``).  Imports neither JAX nor the JAX
package."""

__version__ = "0.1.0"

from .sparse import (CountsMatrix, build_both_orientations, build_counts,
                     ingest)
from .ops.objective import eval_llk, poisson_f, poisson_fg
from .train import FitParams, initialize_factors, run_poismf
from .models.poismf import PoisMF

__all__ = [
    "CountsMatrix", "build_counts", "build_both_orientations", "ingest",
    "eval_llk", "poisson_fg", "poisson_f",
    "FitParams", "run_poismf", "initialize_factors",
    "PoisMF", "__version__",
]
