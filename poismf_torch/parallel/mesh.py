"""Multi-device data parallelism over rows on ``torch.distributed``.

Counterpart of ``poismf_tpu/parallel/mesh.py``.  The JAX package runs one
controller over a ``jax.sharding.Mesh``; the port runs one process per
device (SPMD), and its mesh is a one-dimensional
``torch.distributed.device_mesh.DeviceMesh`` over them:

  * every rank calls the same fit with the same data, parameters and
    seed, so every rank ingests and initializes identically;
  * the matrix being UPDATED is sharded by contiguous row ranges, one a
    rank; each half-update all-gathers the fixed side over the mesh's
    group and every rank solves its own rows (:mod:`.ell_mesh`);
  * after the fit every rank holds the whole of A and B.

The JAX package's flat-COO sharded body (``shard_counts``,
``sharded_half_update``) is not ported: ``layout="coo"`` runs on the
planar ELL, as it does without a mesh.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..sparse import CountsMatrix


def make_mesh(device_type: str = "cuda") -> DeviceMesh:
    """A one-dimensional mesh over every rank of the default process
    group, which the caller has initialized (``dist.init_process_group``):
    ``"cuda"`` (NCCL, one GPU a rank) or ``"cpu"`` (gloo)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: initialize the default process group "
                           "first (torch.distributed.init_process_group)")
    return init_device_mesh(device_type, (dist.get_world_size(),))


def mesh_device(mesh) -> torch.device:
    """This rank's device on a one-dimensional ``DeviceMesh``: the CPU on a
    "cpu" mesh, the current CUDA device (which the mesh's set-up selects
    from ``LOCAL_RANK``) on a "cuda" mesh."""
    if not isinstance(mesh, DeviceMesh) or mesh.ndim != 1:
        raise TypeError("mesh must be a one-dimensional torch.distributed "
                        f"DeviceMesh (make_mesh), not {mesh!r}")
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    raise ValueError(f"mesh device type {mesh.device_type!r}: only 'cuda' "
                     "and 'cpu' meshes are supported")


def _ceil_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def pad_rows_for_mesh(M: torch.Tensor, rows_per_shard: int, n_shards: int
                      ) -> torch.Tensor:
    """Re-pad a factor matrix to ``rows_per_shard * n_shards`` rows (zero
    rows appended, or trailing rows dropped)."""
    target = rows_per_shard * n_shards
    if M.shape[0] >= target:
        return M[:target]
    return torch.cat([M, M.new_zeros((target - M.shape[0], M.shape[1]))])


def run_poismf_sharded(
    A: torch.Tensor,
    B: torch.Tensor,
    by_user: CountsMatrix,
    by_item: CountsMatrix,
    params,
    mesh: DeviceMesh,
    handle_interrupt: bool = True,
    callback: Optional[Callable[[int, torch.Tensor, torch.Tensor], None]]
    = None,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Sharded alternating driver, the multi-device twin of
    :func:`poismf_torch.train.run_poismf`; every rank of ``mesh`` calls it
    with the same arguments.  A and B (this rank's copies of the initial
    factors, on :func:`mesh_device`) come back whole on every rank, with
    their input row counts.  Every layout runs on the planar ELL
    (:func:`poismf_torch.parallel.ell_mesh.run_poismf_ell_sharded`)."""
    from .ell_mesh import run_poismf_ell_sharded

    dev = mesh_device(mesh)
    if A.device != dev or B.device != dev:
        raise ValueError(f"the factors are on {A.device} / {B.device}, this "
                         f"rank's mesh device is {dev}")
    return run_poismf_ell_sharded(A, B, by_user, by_item, params.resolved(),
                                  mesh, handle_interrupt=handle_interrupt,
                                  callback=callback)
