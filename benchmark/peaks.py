"""The yardstick's arithmetic: the card's peaks, the operations and bytes
of one hand-kernel call (frozen here from ``chip_smoke.py``'s ``work``),
and the least work of one alternating epoch, counted from the data's
shape alone.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, at its 700 W
limit): 3.35 TB/s of HBM and 67 TFLOP/s in float32 outside the tensor
cores.  Every hand kernel is a float32 sweep bound by its bytes.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12


def bound_s(nbytes: float, ops: float) -> float:
    """The least seconds for the work: the larger of its bytes over the
    HBM rate and its operations over the float32 rate."""
    return max(nbytes / HBM_BYTES_S, ops / F32_OPS_S)


def kernel_work(name: str, k: int, P: int, R: int, itemsize: int, nnz: int,
                C: int = 4):
    """(bytes, operations) of one call at a bucket's shapes and its
    ``nnz`` nonzero slots: each input read once, each output written
    once, and only what the data needs.  The vals plane is read whole;
    the bg plane, and the px / pd / bd planes, only at the nonzero slots,
    except where a [P, R] prediction plane is an output (fgh, fg, hvp_bv
    write one for every slot, so they read every slot's bg).  A log or a
    division counts as one operation, like an add or a multiply."""
    slot, row = 4 * P * R, 4 * R
    full, valid = k * P * R * itemsize, k * nnz * itemsize
    return {
        "fgh": (full + slot + k * row + (1 + 2 * k) * row + 2 * slot,
                P * R * 2 * k + nnz * (5 * k + 8)),
        "hvp": (valid + slot + 2 * k * row, nnz * (4 * k + 1)),
        "hvp_bv": (full + 2 * slot + 2 * k * row,
                   P * R * 2 * k + nnz * (2 * k + 1)),
        "raygtd": (slot + 8 * nnz + 3 * C * row, nnz * 9 * C),
        "fg": (full + 2 * slot + (1 + 2 * k) * row,
               P * R * 2 * k + nnz * (2 * k + 5)),
        "rayf": (slot + 8 * nnz + 2 * C * row, nnz * 5 * C),
        "pg": (valid + slot + 2 * k * row, nnz * (4 * k + 2)),
        "f": (valid + slot + (k + 1) * row, nnz * (2 * k + 3)),
        "f_gtd": (valid + slot + 4 * nnz + (k + 2) * row,
                  nnz * (2 * k + 6)),
        "f_gtd_fused": (valid + slot + (2 * k + 2) * row,
                        nnz * (4 * k + 6)),
        "f_gtd_multi": (valid + slot + (2 * k + 3 * C) * row + 4 * k,
                        nnz * (2 * k * (C + 1) + 7 * C) + R * C * 11 * k),
        "ray": (slot + 8 * nnz + 3 * row, nnz * 9),
    }[name]


def epoch_least_s(n_users: int, n_items: int, nnz: int, k: int) -> float:
    """The least seconds of one alternating epoch's required work: per
    half one objective-and-gradient evaluation, 4k operations and 8 bytes
    (a count and an index) a nonzero, the fixed side's factors read once
    and the target side's read and written once, in float32."""
    total = 0.0
    for n_target, n_fixed in ((n_items, n_users), (n_users, n_items)):
        ops = 4.0 * k * nnz
        nbytes = 8.0 * nnz + 4.0 * k * (n_fixed + 2 * n_target)
        total += bound_s(nbytes, ops)
    return total
