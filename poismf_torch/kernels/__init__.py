"""Hand-written CUDA kernels for Hopper (sources in ``poismf_torch/csrc``),
each beside its plain PyTorch version.

Dispatch goes by the tensor: CPU tensors (and float64 planes) take the
plain version; CUDA tensors launch the kernel or raise.  There is no
fallback from a failed kernel to the plain version.
"""

from ._lib import launch_counts, reset_launch_counts
from .fgh import fgh_bucket, fgh_bucket_torch
from .hvp import hvp_bucket, hvp_bucket_torch
from .raygtd import raygtd_multi_bucket, raygtd_multi_bucket_torch

__all__ = [
    "launch_counts", "reset_launch_counts",
    "fgh_bucket", "fgh_bucket_torch",
    "hvp_bucket", "hvp_bucket_torch",
    "raygtd_multi_bucket", "raygtd_multi_bucket_torch",
]
