"""assemble: the per-slot sums of ``ops.ell._assemble``, in place on its
[n_rows_ell, D] output once the buckets' row outputs fill its covered rows:
each group of the layout's :class:`~poismf_torch.ops.ell.Assembly` summed
in its fixed order into its target slot, and the rows that read zero
zeroed.

CUDA kernel ``csrc/assemble.cu`` (replaces no TPU kernel: the JAX package's
``_assemble`` is a plain ``.at[].add``) and its plain PyTorch version,
:func:`assemble_torch` (a gather, ``masked_fill_``,
``torch.segment_reduce`` and an index write).  The kernel gives its
result bit for bit, in float32 and float64.
"""

from __future__ import annotations

import torch

from . import _lib


def assemble_torch(flat: torch.Tensor, asm) -> None:
    """Plain PyTorch version of :func:`assemble`, any device and dtype."""
    flat[asm.covered:] = 0
    adds = None if asm.targets is None else flat[asm.order]
    if asm.drop is not None:
        flat[:asm.covered].masked_fill_(asm.drop[:, None], 0)
    if adds is not None:
        # sequential from -0.0, which leaves the group's first value as is
        flat[asm.targets] = torch.segment_reduce(
            adds, "sum", offsets=asm.offsets, unsafe=True, initial=-0.0)


def assemble(flat: torch.Tensor, asm) -> None:
    """The sums of ``asm`` (an ``Assembly``) in place on ``flat`` [n_rows,
    D], whose rows ``[0, asm.covered)`` hold the buckets' row outputs.  A
    CPU tensor takes :func:`assemble_torch`; a CUDA tensor (float32 or
    float64, contiguous, ``asm``'s tensors on its device) one launch of
    the kernel, or a raise.  No sync."""
    if _lib.plain_device(flat):
        assemble_torch(flat, asm)
        return
    _lib.require(flat.dim() == 2 and flat.is_contiguous()
                 and flat.dtype in (torch.float32, torch.float64),
                 "assemble: flat must be a contiguous float32 or float64 "
                 "[n_rows, D]")
    index = [t for t in (asm.targets, asm.order, asm.offsets, asm.drop,
                         asm.long_groups, asm.short_groups, asm.zero_rows)
             if t is not None]
    _lib.require(all(t.device == flat.device and t.is_contiguous()
                     for t in index),
                 "assemble: the layout's assembly must lie on flat's device")
    n_rows, D = flat.shape
    _lib.require(n_rows < 2 ** 31, "assemble: slots must fit in int32")
    if D == 0:
        return
    n_long = 0 if asm.long_groups is None else asm.long_groups.numel()
    n_short = 0 if asm.short_groups is None else asm.short_groups.numel()
    n_zero = 0 if asm.zero_rows is None else asm.zero_rows.numel()
    lib = _lib.library()
    with torch.cuda.device(flat.device):
        rc = lib.poismf_assemble(
            flat.data_ptr(), int(flat.dtype == torch.float64),
            _lib.ptr(asm.targets), _lib.ptr(asm.order),
            _lib.ptr(asm.offsets), _lib.ptr(asm.long_groups), n_long,
            _lib.ptr(asm.short_groups), n_short, _lib.ptr(asm.zero_rows),
            n_zero, _lib.ptr(asm.drop), n_rows, asm.covered, D,
            _lib.stream_of(flat))
    _lib.check(rc, "assemble")
    _lib.launch_counts["assemble"] += 1
    _lib.launch_counts["assemble_long"] += n_long > 0
