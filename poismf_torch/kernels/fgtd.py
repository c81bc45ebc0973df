"""f_gtd: a line-search trial's objective and g(trial).d data terms of one
ELL bucket, with the ``<B, d>`` factors read from a hoisted [P, R] plane
(``f_gtd_bucket``) or computed from the same plane read
(``f_gtd_fused_bucket``).

CUDA kernels of ``csrc/fgtd.cu``, two instances of the plane sweep of
``csrc/plane_sweep.cuh`` (they replace ``f_gtd_bucket`` and
``f_gtd_fused_bucket`` of ``poismf_tpu/ops/pallas_kernels.py``: the bd
plane copied beside vals, or a second dot against ``d_t``), and the plain
PyTorch versions.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _lib

PRED_EPS = 1e-30


def f_gtd_bucket_torch(bg, vals, a_t, bd):
    """Plain PyTorch version, from the jnp branch of
    ``poismf_tpu/ops/ell.py`` ``_bucket_data_f_gtd`` (:691-698).  The log
    is unfloored (a non-positive prediction at a positive count gives
    inf/NaN); the ratio is floored."""
    bg = bg.to(torch.promote_types(bg.dtype, torch.float32))
    pred = (bg * a_t[:, None, :]).sum(0)  # [P, R]
    valid = vals > 0
    nll = -torch.where(valid, vals * torch.log(pred), 0.0).sum(0)
    ratio = torch.where(valid, vals * bd / torch.clamp_min(pred, PRED_EPS),
                        0.0)
    return nll, ratio.sum(0)


def f_gtd_fused_bucket_torch(bg, vals, a_t, d_t):
    """Plain PyTorch version, from the jnp branch of
    ``poismf_tpu/ops/ell.py`` ``_bucket_data_f_gtd_fused`` (:758-766):
    :func:`f_gtd_bucket_torch` with ``bd = sum_k bg * d``."""
    bg = bg.to(torch.promote_types(bg.dtype, torch.float32))
    return f_gtd_bucket_torch(bg, vals, a_t, (bg * d_t[:, None, :]).sum(0))


def _launch(bg, vals, a_t, direction, fused: bool):
    k, P, R = _lib.check_plane_inputs(bg, vals, a_t)
    if fused:
        _lib.require(direction.dtype == torch.float32
                     and tuple(direction.shape) == (k, R),
                     "d_t must be float32 [k, R]")
        kernel, planes = "f_gtd_fused", (vals,)
    else:
        _lib.require(direction.dtype == torch.float32
                     and tuple(direction.shape) == (P, R),
                     "bd must be float32 [P, R]")
        kernel, planes = "f_gtd", (vals, direction)
    plan = _lib.sweep_plan(kernel, bg, *planes)
    lib = _lib.library()
    f32 = dict(dtype=torch.float32, device=bg.device)
    out = torch.empty((2, R), **f32)
    scratch = (torch.empty((plan.splits, 2, R), **f32)
               if plan.splits > 1 else None)
    with torch.cuda.device(bg.device):
        rc = getattr(lib, f"poismf_{kernel}")(
            bg.data_ptr(), int(bg.dtype == torch.bfloat16), vals.data_ptr(),
            a_t.data_ptr(), direction.data_ptr(), out.data_ptr(),
            _lib.ptr(scratch), k, P, R, plan.kg, plan.pt, plan.stages,
            plan.p_per_split, _lib.stream_of(bg),
        )
    _lib.check(rc, kernel)
    _lib.launch_counts[kernel] += 1
    return out[0], out[1]


def f_gtd_bucket(bg: torch.Tensor, vals: torch.Tensor, a_t: torch.Tensor,
                 bd: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """bg [k, P, R] (bf16 or f32), vals [P, R] f32, a_t [k, R] f32 (the
    trial), bd [P, R] f32 (``<B, d>`` from ``bdot_ell``) ->
    (neg_llk [R], gud [R]).

    Tensors on the CPU take :func:`f_gtd_bucket_torch`; CUDA tensors
    launch the kernel or raise (float64 included, R not a multiple of 8,
    and k above 384 in bfloat16 or 256 in float32)."""
    if _lib.uses_plain(bg, vals, a_t, bd):
        return f_gtd_bucket_torch(bg, vals, a_t, bd)
    return _launch(bg, vals, a_t, bd, False)


def f_gtd_fused_bucket(bg: torch.Tensor, vals: torch.Tensor,
                       a_t: torch.Tensor, d_t: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """bg [k, P, R] (bf16 or f32), vals [P, R] f32, a_t [k, R] f32 (the
    trial), d_t [k, R] f32 (the direction) -> (neg_llk [R], gud [R]).

    Tensors on the CPU take :func:`f_gtd_fused_bucket_torch`; CUDA tensors
    launch the kernel or raise (float64 included, R not a multiple of 8,
    and k above 256 in bfloat16 or 192 in float32)."""
    if _lib.uses_plain(bg, vals, a_t, d_t):
        return f_gtd_fused_bucket_torch(bg, vals, a_t, d_t)
    return _launch(bg, vals, a_t, d_t, True)
