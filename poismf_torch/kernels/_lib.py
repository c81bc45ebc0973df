"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

All ``poismf_torch/csrc/*.cu`` files compile with nvcc into ONE shared
library with a plain C interface, loaded with ctypes.  The build happens
at first use, into ``build/kernels/`` at the repository root (git-ignored),
under a name keyed on a hash of the sources and flags, so a changed source
rebuilds and an unchanged one loads at once.  Nothing here runs at import:
this module imports on a machine without CUDA.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, Optional, Tuple

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Shared memory one block may use on Hopper (227 KB).
SMEM_LIMIT = 232_448
# Rows per block (one per lane) and the most warps a block splits P over;
# both fixed by the kernels (csrc/common.cuh, __launch_bounds__(128)).
TILE_R = 32
MAX_WARPS = 4

# Launches per kernel wrapper, counted only where a wrapper launches its
# CUDA kernel (never on the plain path): a run shows through these that it
# went through the kernels.
launch_counts = {"fgh": 0, "hvp": 0, "hvp_bv": 0, "raygtd": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# What the last build did (seconds, library path, compiler output); empty
# until the library is first loaded in this process.
build_info: dict = {}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "poismf_torch/csrc are built with the CUDA toolkit"
    )


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libpoismf_kernels-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    cu, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        res = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
             *[str(f) for f in cu]],
            capture_output=True, text=True, timeout=900,
        )
        if res.returncode != 0:
            raise RuntimeError(
                "nvcc failed to build poismf_torch/csrc:\n"
                + res.stdout[-4000:] + res.stderr[-8000:]
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    build_info.update(seconds=time.perf_counter() - t0, log=res.stderr)


def library() -> ctypes.CDLL:
    """The kernel library, built on first call; raises if it cannot be."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _build(path)
        else:
            build_info.update(seconds=0.0, log="")
        build_info["path"] = str(path)
        lib = ctypes.CDLL(str(path))
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.poismf_fgh.argtypes = [vp, i, vp, vp, vp, vp, vp, vp,
                                   i, i, i, i, i, f, vp]
        lib.poismf_fgh.restype = i
        lib.poismf_hvp.argtypes = [vp, i, vp, vp, vp, vp, vp,
                                   i, i, i, i, i, vp]
        lib.poismf_hvp.restype = i
        lib.poismf_raygtd.argtypes = [vp, vp, vp, vp, vp, vp,
                                      i, i, i, i, i, vp]
        lib.poismf_raygtd.restype = i
        lib.poismf_error_string.argtypes = [i]
        lib.poismf_error_string.restype = ctypes.c_char_p
        _lib = lib
        return _lib


def check(rc: int, name: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if rc != 0:
        msg = library().poismf_error_string(rc).decode()
        raise RuntimeError(f"poismf_torch CUDA kernel {name} failed: {msg}")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_plan(P: int, R: int, smem_bytes: Callable[[int], int],
                device: torch.device) -> Tuple[int, int]:
    """``(warps, splits)`` for a bucket of P slots and R rows.

    Warps split P inside a block (fewer for short rows, where the per-warp
    accumulators would cost more than the slots they sum); splits cut P
    across blocks until the grid holds about four blocks per SM, keeping
    at least 8 slots per warp and split.  Raises when even one warp's
    shared memory (``smem_bytes(warps)``) exceeds the limit."""
    warps = None
    for w in (4, 2, 1):
        if w <= max(1, P // 8) and smem_bytes(w) <= SMEM_LIMIT:
            warps = w
            break
    if warps is None:
        raise ValueError(
            f"bucket needs {smem_bytes(1)} bytes of shared memory per block, "
            f"more than the {SMEM_LIMIT} a Hopper block may use (k too large)"
        )
    blocks_x = -(-R // TILE_R)
    target = 4 * _sm_count(device.index if device.index is not None
                           else torch.cuda.current_device())
    splits = max(1, min(-(-target // blocks_x), P // (warps * 8)))
    per_split = -(-P // splits)
    return warps, -(-P // per_split)


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def uses_plain(*tensors: torch.Tensor) -> bool:
    """True when the plain PyTorch version must run: the inputs lie on the
    CPU, or the planes are float64 (the JAX package keeps f64 off its
    Pallas kernels too).  Any other device that is not CUDA raises."""
    t0 = tensors[0]
    if t0.device.type == "cpu" or t0.dtype == torch.float64:
        return True
    if t0.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {t0.device}")
    for t in tensors:
        require(t.device == t0.device,
                f"tensors on {t.device} and {t0.device}")
        require(t.is_contiguous(), "kernel inputs must be contiguous")
    return False
