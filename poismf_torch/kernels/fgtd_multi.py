"""f_gtd_multi: complete (f, g(trial).d) of one ELL bucket at C projected
trials ``max(0, x + alpha_c * d)``, linear, l2 and Bsum terms folded in on
the rows the caller marks.

CUDA kernel ``csrc/fgtd_multi.cu`` (replaces ``f_gtd_multi_bucket`` of
``poismf_tpu/ops/pallas_kernels.py``) and its plain PyTorch version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _lib
from .fgtd import f_gtd_bucket_torch


def f_gtd_multi_bucket_torch(bg, vals, x_t, d_t, alphas, bsum, l2_reg,
                             w_mult=1.0, l2_in_f=True, fold=None):
    """Plain PyTorch version, from the jnp fallback of
    ``poismf_tpu/ops/ell.py`` ``f_gtd_multi_ell`` (:870-886) for one
    bucket: per candidate the fused (f, g.d) data terms at the projected
    trial, plus ``combine_f_gtd``'s linear and l2 terms on the rows that
    ``fold`` marks (None: every row)."""
    bg = bg.to(torch.promote_types(bg.dtype, torch.float32))
    bsum = bsum[:, None] if bsum.dim() == 1 else bsum  # [k, 1] or [k, R]
    bd = (bg * d_t[:, None, :]).sum(0)  # [P, R]
    lin_d = (d_t * bsum).sum(0)
    fs, gs = [], []
    for a in alphas:
        trial = torch.clamp_min(x_t + a * d_t, 0.0)  # [k, R]
        nll, gud = f_gtd_bucket_torch(bg, vals, trial, bd)
        lin = (trial * bsum).sum(0)
        if l2_in_f:
            lin = lin + l2_reg * (trial * trial).sum(0)
        g0 = lin_d + 2.0 * l2_reg * (trial * d_t).sum(0)
        if fold is not None:
            lin = torch.where(fold, lin, 0.0)
            g0 = torch.where(fold, g0, 0.0)
        fs.append(lin + w_mult * nll)
        gs.append(g0 - w_mult * gud)
    return torch.stack(fs), torch.stack(gs)


def f_gtd_multi_bucket(bg: torch.Tensor, vals: torch.Tensor,
                       x_t: torch.Tensor, d_t: torch.Tensor,
                       alphas: torch.Tensor, bsum: torch.Tensor,
                       l2_reg: float, w_mult: float = 1.0,
                       l2_in_f: bool = True,
                       fold: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """bg [k, P, R] (bf16 or f32), vals [P, R] f32, x_t and d_t [k, R]
    f32, alphas [C, R] f32 (1 <= C <= MAX_C), bsum [k] or [k, R] f32,
    fold [R] bool or None (every row) -> (f [C, R], gtd [C, R]).  The
    linear terms ``<trial, bsum>`` (+ ``l2 |trial|^2`` with ``l2_in_f``)
    and ``<d, bsum> + 2 l2 <trial, d>`` enter on the rows ``fold`` marks;
    the others get data terms only (``w_mult`` applied).

    Tensors on the CPU take :func:`f_gtd_multi_bucket_torch`; CUDA tensors
    launch the kernel or raise (float64 included)."""
    if _lib.uses_plain(bg, vals, x_t, d_t, alphas, bsum):
        return f_gtd_multi_bucket_torch(bg, vals, x_t, d_t, alphas, bsum,
                                        l2_reg, w_mult, l2_in_f, fold)
    k, P, R = _lib.check_plane_inputs(bg, vals, x_t, names=("vals", "x_t"))
    C = alphas.shape[0] if alphas.dim() == 2 else 0
    _lib.require(1 <= C <= _lib.MAX_C, f"1 <= C <= {_lib.MAX_C} candidates")
    for name, t, shape in (("d_t", d_t, (k, R)), ("alphas", alphas, (C, R))):
        _lib.require(t.dtype == torch.float32 and tuple(t.shape) == shape,
                     f"{name} must be float32 {list(shape)}")
    _lib.require(bsum.dtype == torch.float32
                 and tuple(bsum.shape) in ((k,), (k, R)),
                 "bsum must be float32 [k] or [k, R]")
    if fold is not None:
        _lib.require(fold.dtype == torch.bool and tuple(fold.shape) == (R,)
                     and fold.device == bg.device and fold.is_contiguous(),
                     "fold must be a contiguous bool [R] on the card")
    # the trial and direction rows in dynamic shared memory, the per-warp
    # candidate sums in static
    red = 4 * 2 * _lib.MAX_C * _lib.MAX_WARPS * _lib.TILE_R
    warps, splits = _lib.launch_plan(
        P, R, lambda w: 4 * k * _lib.TILE_R * (1 + C) + red, bg.device
    )
    lib = _lib.library()
    f32 = dict(dtype=torch.float32, device=bg.device)
    out = torch.empty((2, C, R), **f32)
    scratch = torch.empty((splits, 2, C, R), **f32) if splits > 1 else None
    with torch.cuda.device(bg.device):
        rc = lib.poismf_fgtd_multi(
            bg.data_ptr(), int(bg.dtype == torch.bfloat16), vals.data_ptr(),
            x_t.data_ptr(), d_t.data_ptr(), alphas.data_ptr(),
            bsum.data_ptr(), int(bsum.dim() == 2), _lib.ptr(fold),
            float(l2_reg), float(w_mult), int(l2_in_f), out.data_ptr(),
            _lib.ptr(scratch), C, k, P, R, warps, splits, _lib.stream_of(bg),
        )
    _lib.check(rc, "f_gtd_multi")
    _lib.launch_counts["f_gtd_multi"] += 1
    return out[0], out[1]
