"""hvp: Hessian-vector product data term of one ELL bucket, optionally
with its <B, v> plane.

CUDA kernel ``csrc/hvp.cu`` (replaces ``hvp_bucket`` and ``hvp_bv_bucket``
of ``poismf_tpu/ops/pallas_kernels.py``) and its plain PyTorch version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _lib


def hvp_bucket_torch(bg, w2, v_t, want_bv: bool = False):
    """Plain PyTorch version, from the jnp branch of
    ``poismf_tpu/ops/ell.py`` ``_bucket_data_hvp`` (:1087-1088); the plane
    is promoted to float32 (float64 stays) first, as in the kernels."""
    bg = bg.to(torch.promote_types(bg.dtype, torch.float32))
    bv = (bg * v_t[:, None, :]).sum(0)  # [P, R]
    out = ((w2 * bv)[None] * bg).sum(1)  # [k, R]
    return out, (bv if want_bv else None)


def hvp_bucket(bg: torch.Tensor, w2: torch.Tensor, v_t: torch.Tensor,
               want_bv: bool = False
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """bg [k, P, R] (bf16 or f32), w2 [P, R] f32, v_t [k, R] f32 ->
    (out [k, R], bv [P, R] or None).  ``want_bv`` is the TPU's
    ``hvp_bv_bucket``; both variants are one kernel.

    Tensors on the CPU, and float64 planes on any device, take
    :func:`hvp_bucket_torch`; CUDA tensors launch the kernel or raise."""
    if _lib.uses_plain(bg, w2, v_t):
        return hvp_bucket_torch(bg, w2, v_t, want_bv)
    _lib.require(bg.dim() == 3, "bg must be [k, P, R]")
    k, P, R = bg.shape
    _lib.require(bg.dtype in (torch.float32, torch.bfloat16),
                 "bg must be float32 or bfloat16")
    _lib.require(w2.dtype == torch.float32 and v_t.dtype == torch.float32,
                 "w2 and v_t must be float32")
    _lib.require(tuple(w2.shape) == (P, R), "w2 must be [P, R]")
    _lib.require(tuple(v_t.shape) == (k, R), "v_t must be [k, R]")
    warps, splits = _lib.launch_plan(
        P, R, lambda w: 4 * k * _lib.TILE_R * (1 + w), bg.device
    )
    lib = _lib.library()
    f32 = dict(dtype=torch.float32, device=bg.device)
    out = torch.empty((k, R), **f32)
    bv = torch.empty((P, R), **f32) if want_bv else None
    scratch = torch.empty((splits, k, R), **f32) if splits > 1 else None
    with torch.cuda.device(bg.device):
        rc = lib.poismf_hvp(
            bg.data_ptr(), int(bg.dtype == torch.bfloat16), w2.data_ptr(),
            v_t.data_ptr(), out.data_ptr(), _lib.ptr(bv), _lib.ptr(scratch),
            k, P, R, warps, splits, _lib.stream_of(bg),
        )
    _lib.check(rc, "hvp")
    _lib.launch_counts["hvp_bv" if want_bv else "hvp"] += 1
    return out, bv
