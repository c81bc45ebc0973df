"""pg: the proximal-gradient data term ``sum_p (x / pred) * B`` of one
ELL bucket.

CUDA kernel ``csrc/pg.cu``, an instance of the plane sweep of
``csrc/plane_sweep.cuh`` (replaces ``pg_bucket`` of
``poismf_tpu/ops/pallas_kernels.py``), and its plain PyTorch version.
"""

from __future__ import annotations

import torch

from . import _lib

PRED_EPS = 1e-30


def pg_bucket_torch(bg, vals, a_t):
    """Plain PyTorch version, from the jnp branch of
    ``poismf_tpu/ops/ell.py`` ``pg_grad_ell`` (:1274-1278)."""
    bg = bg.to(torch.promote_types(bg.dtype, torch.float32))
    pred = (bg * a_t[:, None, :]).sum(0)  # [P, R]
    w = torch.where(vals > 0, vals / torch.clamp_min(pred, PRED_EPS), 0.0)
    return (w[None] * bg).sum(1)


def pg_bucket(bg: torch.Tensor, vals: torch.Tensor, a_t: torch.Tensor
              ) -> torch.Tensor:
    """bg [k, P, R] (bf16 or f32), vals [P, R] f32, a_t [k, R] f32 ->
    [k, R].

    Tensors on the CPU take :func:`pg_bucket_torch`; CUDA tensors launch
    the kernel or raise (float64 included, R not a multiple of 8, and k
    above 384 in bf16 or 256 in f32)."""
    if _lib.uses_plain(bg, vals, a_t):
        return pg_bucket_torch(bg, vals, a_t)
    k, P, R = _lib.check_plane_inputs(bg, vals, a_t)
    plan = _lib.sweep_plan("pg", bg, vals)
    lib = _lib.library()
    f32 = dict(dtype=torch.float32, device=bg.device)
    out = torch.empty((k, R), **f32)
    scratch = (torch.empty((plan.splits, k, R), **f32)
               if plan.splits > 1 else None)
    with torch.cuda.device(bg.device):
        rc = lib.poismf_pg(
            bg.data_ptr(), int(bg.dtype == torch.bfloat16), vals.data_ptr(),
            a_t.data_ptr(), out.data_ptr(), _lib.ptr(scratch), k, P, R,
            plan.kg, plan.pt, plan.stages, plan.p_per_split,
            _lib.stream_of(bg),
        )
    _lib.check(rc, "pg")
    _lib.launch_counts["pg"] += 1
    return out
