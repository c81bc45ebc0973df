"""raygtd_multi: trial f and g(trial).d data terms at C ray steps of one
ELL bucket, from the cached prediction planes.

CUDA kernel ``csrc/raygtd.cu`` (replaces ``raygtd_multi_bucket`` of
``poismf_tpu/ops/pallas_kernels.py``) and its plain PyTorch version.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _lib

PRED_EPS = 1e-30
MAX_C = 8  # candidates the kernel holds in registers (csrc/raygtd.cu)


def raygtd_multi_bucket_torch(px, pd, vals, alphas):
    """Plain PyTorch version, from the jnp branch of
    ``poismf_tpu/ops/ell.py`` ``_bucket_data_raygtd_multi`` (:987-995).
    The log is unfloored: a non-positive trial prediction gives inf/NaN."""
    pred = px[None] + alphas[:, None, :] * pd[None]  # [C, P, R]
    valid = (vals > 0)[None]
    logt = torch.where(valid, vals[None] * torch.log(pred), 0.0)
    ratio = torch.where(
        valid, vals[None] * pd[None] / torch.clamp_min(pred, PRED_EPS), 0.0
    )
    return -logt.sum(1), ratio.sum(1)


def raygtd_multi_bucket(px: torch.Tensor, pd: torch.Tensor,
                        vals: torch.Tensor, alphas: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """px, pd, vals [P, R] f32, alphas [C, R] f32 ->
    (neg_llk [C, R], gud [C, R]).

    Tensors on the CPU, and float64 planes on any device, take
    :func:`raygtd_multi_bucket_torch`; CUDA tensors launch the kernel or
    raise."""
    if _lib.uses_plain(px, pd, vals, alphas):
        return raygtd_multi_bucket_torch(px, pd, vals, alphas)
    _lib.require(px.dim() == 2 and alphas.dim() == 2,
                 "px must be [P, R] and alphas [C, R]")
    P, R = px.shape
    C = alphas.shape[0]
    _lib.require(1 <= C <= MAX_C, f"1 <= C <= {MAX_C} candidates")
    for name, t in (("px", px), ("pd", pd), ("vals", vals)):
        _lib.require(t.dtype == torch.float32 and tuple(t.shape) == (P, R),
                     f"{name} must be float32 [P, R]")
    _lib.require(alphas.dtype == torch.float32 and alphas.shape[1] == R,
                 "alphas must be float32 [C, R]")
    warps, splits = _lib.launch_plan(P, R, lambda w: 0, px.device)
    lib = _lib.library()
    f32 = dict(dtype=torch.float32, device=px.device)
    out = torch.empty((2, C, R), **f32)
    scratch = torch.empty((splits, 2, C, R), **f32) if splits > 1 else None
    with torch.cuda.device(px.device):
        rc = lib.poismf_raygtd(
            px.data_ptr(), pd.data_ptr(), vals.data_ptr(), alphas.data_ptr(),
            out.data_ptr(), _lib.ptr(scratch), C, P, R, warps, splits,
            _lib.stream_of(px),
        )
    _lib.check(rc, "raygtd_multi")
    _lib.launch_counts["raygtd"] += 1
    return out[0], out[1]
