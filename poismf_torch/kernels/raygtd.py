"""raygtd_multi: trial f and g(trial).d data terms at C ray steps of one
ELL bucket, from the cached prediction planes; ray: the same at one step.

CUDA kernel ``csrc/raygtd.cu`` (replaces ``raygtd_multi_bucket`` and,
launched with C = 1, ``ray_bucket`` of ``poismf_tpu/ops/pallas_kernels.py``;
its instance without the g.d sums serves ``rayf.py``) and its plain
PyTorch version.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _lib

PRED_EPS = 1e-30


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

    Tensors on the CPU take :func:`raygtd_multi_bucket_torch`; CUDA
    tensors launch the kernel or raise (float64 included, and R not a
    multiple of 4).  More than ``_lib.MAX_C`` candidates run as
    successive launches of at most MAX_C over the same planes."""
    if _lib.uses_plain(px, pd, vals, alphas):
        return raygtd_multi_bucket_torch(px, pd, vals, alphas)
    if alphas.dim() == 2 and alphas.shape[0] > _lib.MAX_C:
        parts = [_launch(px, pd, vals, a.contiguous(), "raygtd")
                 for a in alphas.split(_lib.MAX_C)]
        return (torch.cat([nll for nll, _ in parts]),
                torch.cat([gud for _, gud in parts]))
    return _launch(px, pd, vals, alphas, "raygtd")


def ray_bucket_torch(px, pd, vals, alpha):
    """Plain PyTorch version of ``_bucket_data_ray`` (``poismf_tpu/ops/
    ell.py`` :906-914): :func:`raygtd_multi_bucket_torch` at the one
    candidate ``alpha`` [1, R]."""
    nll, gud = raygtd_multi_bucket_torch(px, pd, vals, alpha)
    return nll[0], gud[0]


def ray_bucket(px: torch.Tensor, pd: torch.Tensor, vals: torch.Tensor,
               alpha: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """px, pd, vals [P, R] f32, alpha [1, R] f32 (the per-row step) ->
    (neg_llk [R], gud [R]): the raygtd kernel at C = 1, counted apart.

    Tensors on the CPU take :func:`ray_bucket_torch`; CUDA tensors launch
    the kernel or raise (float64 included, and R not a multiple of 4)."""
    if _lib.uses_plain(px, pd, vals, alpha):
        return ray_bucket_torch(px, pd, vals, alpha)
    _lib.require(alpha.dim() == 2 and alpha.shape[0] == 1,
                 "alpha must be [1, R]")
    nll, gud = _launch(px, pd, vals, alpha, "ray")
    return nll[0], gud[0]


def plan_of(px: torch.Tensor, pd: torch.Tensor, vals: torch.Tensor,
            C: int, gud: bool = True) -> _lib.RayPlan:
    """The kernel's launch plan for C candidates on these [P, R] planes,
    with the g.d sums (raygtd, ray) or without them (rayf); raises on what
    its 16-byte loads do not take: R not a multiple of 4, or a plane not
    16-byte aligned."""
    P, R = px.shape
    name = "raygtd" if gud else "rayf"
    _lib.require(R % 4 == 0, f"{name}: R={R} rows must be a multiple of 4 "
                             "(the kernel loads four rows at once)")
    _lib.require(all(t.data_ptr() % 16 == 0 for t in (px, pd, vals)),
                 f"{name}: px, pd and vals must be 16-byte aligned")
    return _lib.ray_plan(C, P, R, _lib.sm_count(px.device), 2 if gud else 1)


def _launch(px, pd, vals, alphas, counter: str):
    C, P, R = _lib.check_ray_inputs(px, pd, vals, alphas)
    plan = plan_of(px, pd, vals, C)
    lib = _lib.library()
    f32 = dict(dtype=torch.float32, device=px.device)
    out = torch.empty((2, C, R), **f32)
    scratch = (torch.empty((plan.splits, 2, C, R), **f32)
               if plan.splits > 1 else None)
    with torch.cuda.device(px.device):
        rc = lib.poismf_raygtd(
            px.data_ptr(), pd.data_ptr(), vals.data_ptr(), alphas.data_ptr(),
            out.data_ptr(), _lib.ptr(scratch), C, P, R, plan.warps,
            plan.p_per_split, _lib.stream_of(px),
        )
    _lib.check(rc, counter)
    _lib.launch_counts[counter] += 1
    return out[0], out[1]
