"""Hand-written CUDA kernels for Hopper (sources in ``poismf_torch/csrc``),
each beside its plain PyTorch version, and the one rule that picks
between them (``route.py``): the layers above ask for an operation and
never choose a version.  There is no fallback from a failed kernel to
the plain version.  Nothing here imports the layers above.
"""

from ._lib import launch_counts, reset_launch_counts
from .assemble import assemble, assemble_torch
from .fg import f_bucket, f_bucket_torch, fg_bucket, fg_bucket_torch
from .fgh import fgh_bucket, fgh_bucket_torch
from .fgtd import (f_gtd_bucket, f_gtd_bucket_torch, f_gtd_fused_bucket,
                   f_gtd_fused_bucket_torch)
from .fgtd_multi import f_gtd_multi_bucket, f_gtd_multi_bucket_torch
from .hvp import hvp_bucket, hvp_bucket_torch
from .ls_round import ls_round, ls_round_state, ls_round_torch
from .pg import pg_bucket, pg_bucket_torch
from .rayf import rayf_multi_bucket, rayf_multi_bucket_torch
from .raygtd import (ray_bucket, ray_bucket_torch, raygtd_multi_bucket,
                     raygtd_multi_bucket_torch)
from .route import ray, sweep, takes_plain

__all__ = [
    "launch_counts", "reset_launch_counts",
    "assemble", "assemble_torch",
    "f_bucket", "f_bucket_torch",
    "fg_bucket", "fg_bucket_torch",
    "fgh_bucket", "fgh_bucket_torch",
    "f_gtd_bucket", "f_gtd_bucket_torch",
    "f_gtd_fused_bucket", "f_gtd_fused_bucket_torch",
    "f_gtd_multi_bucket", "f_gtd_multi_bucket_torch",
    "hvp_bucket", "hvp_bucket_torch",
    "ls_round", "ls_round_state", "ls_round_torch",
    "pg_bucket", "pg_bucket_torch",
    "rayf_multi_bucket", "rayf_multi_bucket_torch",
    "ray_bucket", "ray_bucket_torch",
    "raygtd_multi_bucket", "raygtd_multi_bucket_torch",
    "ray", "sweep", "takes_plain",
]
