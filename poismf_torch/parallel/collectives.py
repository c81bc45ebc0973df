"""The collectives of a row-sharded fit, counted.

Every collective the fit makes goes through these functions, on
tensors of the mesh's device (NCCL on CUDA tensors, gloo on CPU tensors;
nothing is staged through the host).  ``counts`` adds one per call, so a
run can report how many it made.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

counts = {"all_gather": 0, "all_reduce": 0}


def reset_counts() -> None:
    for name in counts:
        counts[name] = 0


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's row block ``x`` [rows, ...] (the same shape on each),
    concatenated in rank order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    counts["all_gather"] += 1
    return torch.cat(parts)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the ranks, in place."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    counts["all_reduce"] += 1
    return x


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """``x``'s elementwise maximum over the ranks, in place."""
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    counts["all_reduce"] += 1
    return x
