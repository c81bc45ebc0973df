"""rayf_multi: trial f data terms at C ray steps of one ELL bucket, from
the cached prediction planes (the CG line search; no g.d output).

CUDA kernel: the instance of ``csrc/raygtd.cu`` without the g.d sums
(replaces ``rayf_multi_bucket`` of ``poismf_tpu/ops/pallas_kernels.py``),
planned as raygtd is; and its plain PyTorch version.
"""

from __future__ import annotations

import torch

from . import _lib, raygtd


def rayf_multi_bucket_torch(px, pd, vals, alphas):
    """Plain PyTorch version, from the jnp branch of
    ``poismf_tpu/ops/ell.py`` ``_bucket_data_ray_multi`` (:932-935).
    The log is unfloored: a non-positive trial prediction gives inf/NaN."""
    pred = px[None] + alphas[:, None, :] * pd[None]  # [C, P, R]
    valid = (vals > 0)[None]
    logt = torch.where(valid, vals[None] * torch.log(pred), 0.0)
    return -logt.sum(1)


def rayf_multi_bucket(px: torch.Tensor, pd: torch.Tensor,
                      vals: torch.Tensor, alphas: torch.Tensor
                      ) -> torch.Tensor:
    """px, pd, vals [P, R] f32, alphas [C, R] f32 -> neg_llk [C, R].

    Tensors on the CPU take :func:`rayf_multi_bucket_torch`; CUDA tensors
    launch the kernel or raise (float64 included, R not a multiple of 4,
    and planes that are not 16-byte aligned).  More than ``_lib.MAX_C``
    candidates run as successive launches of at most MAX_C."""
    if _lib.uses_plain(px, pd, vals, alphas):
        return rayf_multi_bucket_torch(px, pd, vals, alphas)
    if alphas.dim() == 2 and alphas.shape[0] > _lib.MAX_C:
        return torch.cat([rayf_multi_bucket(px, pd, vals, a.contiguous())
                          for a in alphas.split(_lib.MAX_C)])
    C, P, R = _lib.check_ray_inputs(px, pd, vals, alphas)
    plan = raygtd.plan_of(px, pd, vals, C, gud=False)
    lib = _lib.library()
    f32 = dict(dtype=torch.float32, device=px.device)
    out = torch.empty((C, R), **f32)
    scratch = (torch.empty((plan.splits, C, R), **f32)
               if plan.splits > 1 else None)
    with torch.cuda.device(px.device):
        rc = lib.poismf_rayf(
            px.data_ptr(), pd.data_ptr(), vals.data_ptr(), alphas.data_ptr(),
            out.data_ptr(), _lib.ptr(scratch), C, P, R, plan.warps,
            plan.p_per_split, _lib.stream_of(px),
        )
    _lib.check(rc, "rayf_multi")
    _lib.launch_counts["rayf"] += 1
    return out
