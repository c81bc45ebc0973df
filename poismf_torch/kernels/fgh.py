"""fgh: fused f / gradient / Hessian-diagonal data terms of one ELL bucket.

CUDA kernel ``csrc/fgh.cu`` (replaces ``fgh_bucket`` of
``poismf_tpu/ops/pallas_kernels.py``) and its plain PyTorch version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _lib

PRED_EPS = 1e-30


def fgh_bucket_torch(bg, vals, a_t, w_mult: float = 1.0,
                     want_pred: bool = True):
    """Plain PyTorch version, from the jnp branch of
    ``poismf_tpu/ops/ell.py`` ``_bucket_data_fgh`` (:647-659).  The plane
    is promoted to float32 (float64 stays) before any arithmetic, as the
    TPU kernel does (``pallas_kernels.py:105``): the jnp branch squares a
    bf16 plane in bf16, this version and both kernels square in f32."""
    bg = bg.to(torch.promote_types(bg.dtype, torch.float32))
    pred = (bg * a_t[:, None, :]).sum(0)  # [P, R]
    safe = torch.clamp_min(pred, PRED_EPS)
    valid = vals > 0
    logt = torch.where(valid, vals * torch.log(safe), 0.0)
    w = torch.where(valid, vals / safe, 0.0)
    w2 = torch.where(valid, w_mult * vals / (safe * safe), 0.0)
    return (
        -logt.sum(0),
        -(w[None] * bg).sum(1),
        (w2[None] * (bg * bg)).sum(1),
        w2,
        pred if want_pred else None,
    )


def fgh_bucket(bg: torch.Tensor, vals: torch.Tensor, a_t: torch.Tensor,
               w_mult: float = 1.0, want_pred: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor, Optional[torch.Tensor]]:
    """bg [k, P, R] (bf16 or f32), vals [P, R] f32, a_t [k, R] f32 ->
    (neg_llk [R], grad [k, R], diag [k, R], w2 [P, R], pred [P, R] or
    None).  ``pred`` is the raw (unfloored) prediction plane.

    Tensors on the CPU, and float64 planes on any device, take
    :func:`fgh_bucket_torch`; CUDA tensors launch the kernel or raise."""
    if _lib.uses_plain(bg, vals, a_t):
        return fgh_bucket_torch(bg, vals, a_t, w_mult, want_pred)
    _lib.require(bg.dim() == 3, "bg must be [k, P, R]")
    k, P, R = bg.shape
    _lib.require(bg.dtype in (torch.float32, torch.bfloat16),
                 "bg must be float32 or bfloat16")
    _lib.require(vals.dtype == torch.float32 and a_t.dtype == torch.float32,
                 "vals and a_t must be float32")
    _lib.require(tuple(vals.shape) == (P, R), "vals must be [P, R]")
    _lib.require(tuple(a_t.shape) == (k, R), "a_t must be [k, R]")
    warps, splits = _lib.launch_plan(
        P, R, lambda w: 4 * (k * _lib.TILE_R * (1 + 2 * w) + w * _lib.TILE_R),
        bg.device,
    )
    lib = _lib.library()
    f32 = dict(dtype=torch.float32, device=bg.device)
    out = torch.empty((1 + 2 * k, R), **f32)
    w2 = torch.empty((P, R), **f32)
    px = torch.empty((P, R), **f32) if want_pred else None
    scratch = (torch.empty((splits, 1 + 2 * k, R), **f32)
               if splits > 1 else None)
    with torch.cuda.device(bg.device):
        rc = lib.poismf_fgh(
            bg.data_ptr(), int(bg.dtype == torch.bfloat16), vals.data_ptr(),
            a_t.data_ptr(), out.data_ptr(), w2.data_ptr(), _lib.ptr(px),
            _lib.ptr(scratch), k, P, R, warps, splits, float(w_mult),
            _lib.stream_of(bg),
        )
    _lib.check(rc, "fgh")
    _lib.launch_counts["fgh"] += 1
    return out[0], out[1:1 + k], out[1 + k:], w2, px
