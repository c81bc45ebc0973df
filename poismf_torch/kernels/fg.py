"""fg: fused f / gradient data terms of one ELL bucket (the CG solver's
evaluation; no Hessian data), and f: the same objective alone (line-search
trials).

CUDA kernels of ``csrc/fg.cu``, two instances of the plane sweep of
``csrc/plane_sweep.cuh`` (they replace ``fg_bucket`` and, without the
gradient pass, ``f_bucket`` of ``poismf_tpu/ops/pallas_kernels.py``), and
the plain PyTorch versions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _lib

PRED_EPS = 1e-30


def fg_bucket_torch(bg, vals, a_t, want_pred: bool = True):
    """Plain PyTorch version, from the jnp branch of
    ``poismf_tpu/ops/ell.py`` ``fg_ell`` (:1224-1234).  The log is
    unfloored (a non-positive prediction at a positive count gives
    inf/NaN); the gradient weights are floored."""
    bg = bg.to(torch.promote_types(bg.dtype, torch.float32))
    pred = (bg * a_t[:, None, :]).sum(0)  # [P, R]
    valid = vals > 0
    logt = torch.where(valid, vals * torch.log(pred), 0.0)
    w = torch.where(valid, vals / torch.clamp_min(pred, PRED_EPS), 0.0)
    return -logt.sum(0), -(w[None] * bg).sum(1), (pred if want_pred else None)


def fg_bucket(bg: torch.Tensor, vals: torch.Tensor, a_t: torch.Tensor,
              want_pred: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """bg [k, P, R] (bf16 or f32), vals [P, R] f32, a_t [k, R] f32 ->
    (neg_llk [R], grad [k, R], pred [P, R] or None).  ``pred`` is the raw
    prediction plane; ``want_pred=False`` writes none.

    Tensors on the CPU take :func:`fg_bucket_torch`; CUDA tensors launch
    the kernel or raise (float64 included, and R not a multiple of 8)."""
    if _lib.uses_plain(bg, vals, a_t):
        return fg_bucket_torch(bg, vals, a_t, want_pred)
    k, P, R = _lib.check_plane_inputs(bg, vals, a_t)
    plan = _lib.sweep_plan("fg", bg, vals)
    lib = _lib.library()
    f32 = dict(dtype=torch.float32, device=bg.device)
    out = torch.empty((1 + k, R), **f32)
    px = torch.empty((P, R), **f32) if want_pred else None
    scratch = (torch.empty((plan.splits, 1 + k, R), **f32)
               if plan.splits > 1 else None)
    with torch.cuda.device(bg.device):
        rc = lib.poismf_fg(
            bg.data_ptr(), int(bg.dtype == torch.bfloat16), vals.data_ptr(),
            a_t.data_ptr(), out.data_ptr(), _lib.ptr(px), _lib.ptr(scratch),
            k, P, R, plan.kg, plan.pt, plan.stages, plan.p_per_split,
            _lib.stream_of(bg),
        )
    _lib.check(rc, "fg")
    _lib.launch_counts["fg"] += 1
    return out[0], out[1:], px


def f_bucket_torch(bg, vals, a_t):
    """Plain PyTorch version, from the jnp branch of
    ``poismf_tpu/ops/ell.py`` ``_bucket_data_f`` (:674-676).  The log is
    unfloored: a zero prediction at a positive count gives +inf, a
    negative one NaN."""
    bg = bg.to(torch.promote_types(bg.dtype, torch.float32))
    pred = (bg * a_t[:, None, :]).sum(0)  # [P, R]
    return -torch.where(vals > 0, vals * torch.log(pred), 0.0).sum(0)


def f_bucket(bg: torch.Tensor, vals: torch.Tensor, a_t: torch.Tensor
             ) -> torch.Tensor:
    """bg [k, P, R] (bf16 or f32), vals [P, R] f32, a_t [k, R] f32 ->
    neg_llk [R].

    Tensors on the CPU take :func:`f_bucket_torch`; CUDA tensors launch
    the kernel or raise (float64 included, and R not a multiple of 8)."""
    if _lib.uses_plain(bg, vals, a_t):
        return f_bucket_torch(bg, vals, a_t)
    k, P, R = _lib.check_plane_inputs(bg, vals, a_t)
    plan = _lib.sweep_plan("f", bg, vals)
    lib = _lib.library()
    f32 = dict(dtype=torch.float32, device=bg.device)
    out = torch.empty((R,), **f32)
    scratch = (torch.empty((plan.splits, R), **f32)
               if plan.splits > 1 else None)
    with torch.cuda.device(bg.device):
        rc = lib.poismf_f(
            bg.data_ptr(), int(bg.dtype == torch.bfloat16), vals.data_ptr(),
            a_t.data_ptr(), out.data_ptr(), _lib.ptr(scratch), k, P, R,
            plan.kg, plan.pt, plan.stages, plan.p_per_split,
            _lib.stream_of(bg),
        )
    _lib.check(rc, "f")
    _lib.launch_counts["f"] += 1
    return out
