"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

All ``poismf_torch/csrc/*.cu`` files compile with nvcc into ONE shared
library with a plain C interface, loaded with ctypes: one nvcc process per
source, all started together, then one link.  The build happens at first
use, into ``build/kernels/`` at the repository root (git-ignored), under a
name keyed on a hash of the sources and flags, so a changed source
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
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Shared memory one block may use on Hopper (227 KB).
SMEM_LIMIT = 232_448
# Rows per block (one per lane) and the most warps a block splits P over;
# both fixed by the kernels (csrc/common.cuh, __launch_bounds__(128)).
TILE_R = 32
MAX_WARPS = 4
# Line-search candidates the multi-candidate kernels hold in registers
# (raygtd.cu, rayf.cu, fgtd_multi.cu).
MAX_C = 8

# Launches per kernel wrapper, counted only where a wrapper launches its
# CUDA kernel (never on the plain path): a run shows through these that it
# went through the kernels.
launch_counts = {"fgh": 0, "hvp": 0, "hvp_bv": 0, "raygtd": 0,
                 "fg": 0, "rayf": 0, "pg": 0, "f": 0, "f_gtd": 0,
                 "f_gtd_fused": 0, "f_gtd_multi": 0, "ray": 0}


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


def _run_all(cmds, what: str) -> str:
    """Run the commands in parallel; their joined stderr.  Raises if one
    fails or outlasts 900 s; every process is ended before returning."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    try:
        outs = [p.communicate(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for c, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed to {what} {c[-1]}:\n"
                               + out[-4000:] + err[-8000:])
    return "".join(err for _, err in outs)


def _build(out: Path) -> None:
    cu, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, f.stem + ".o") for f in cu]
        log = _run_all(
            [[_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", o, str(f)]
             for f, o in zip(cu, objs)], "compile")
        so = os.path.join(tmp, "lib.so")
        _run_all([[_nvcc(), "-shared", "-o", so, *objs]], "link")
        os.replace(so, out)
    build_info.update(seconds=time.perf_counter() - t0, log=log)


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
        lib.poismf_fg.argtypes = [vp, i, vp, vp, vp, vp, vp,
                                  i, i, i, i, i, vp]
        lib.poismf_fg.restype = i
        lib.poismf_rayf.argtypes = [vp, vp, vp, vp, vp, vp,
                                    i, i, i, i, i, vp]
        lib.poismf_rayf.restype = i
        lib.poismf_pg.argtypes = [vp, i, vp, vp, vp, vp,
                                  i, i, i, i, i, vp]
        lib.poismf_pg.restype = i
        lib.poismf_f.argtypes = [vp, i, vp, vp, vp, vp, i, i, i, i, i, vp]
        lib.poismf_f.restype = i
        lib.poismf_fgtd.argtypes = [vp, i, vp, vp, vp, i, vp, vp,
                                    i, i, i, i, i, vp]
        lib.poismf_fgtd.restype = i
        lib.poismf_fgtd_multi.argtypes = [vp, i, vp, vp, vp, vp, vp, i, vp,
                                          f, f, i, vp, vp,
                                          i, i, i, i, i, i, vp]
        lib.poismf_fgtd_multi.restype = i
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


def check_plane_inputs(bg: torch.Tensor, slots: torch.Tensor,
                       rows: torch.Tensor, names=("vals", "a_t")
                       ) -> Tuple[int, int, int]:
    """Raise unless ``bg`` is a bf16 or f32 [k, P, R] plane with an f32
    [P, R] plane ``slots`` and an f32 [k, R] block ``rows`` beside it
    (``names`` name them in the errors); returns (k, P, R)."""
    require(bg.dim() == 3, "bg must be [k, P, R]")
    k, P, R = bg.shape
    require(bg.dtype in (torch.float32, torch.bfloat16),
            "bg must be float32 or bfloat16")
    require(slots.dtype == torch.float32 and rows.dtype == torch.float32,
            f"{names[0]} and {names[1]} must be float32")
    require(tuple(slots.shape) == (P, R), f"{names[0]} must be [P, R]")
    require(tuple(rows.shape) == (k, R), f"{names[1]} must be [k, R]")
    return k, P, R


def check_ray_inputs(px: torch.Tensor, pd: torch.Tensor, vals: torch.Tensor,
                     alphas: torch.Tensor) -> Tuple[int, int, int]:
    """Raise unless px, pd and vals are f32 [P, R] planes and ``alphas``
    holds 1..MAX_C f32 candidate rows [C, R]; returns (C, P, R)."""
    require(px.dim() == 2 and alphas.dim() == 2,
            "px must be [P, R] and alphas [C, R]")
    P, R = px.shape
    C = alphas.shape[0]
    require(1 <= C <= MAX_C, f"1 <= C <= {MAX_C} candidates")
    for name, t in (("px", px), ("pd", pd), ("vals", vals)):
        require(t.dtype == torch.float32 and tuple(t.shape) == (P, R),
                f"{name} must be float32 [P, R]")
    require(alphas.dtype == torch.float32 and alphas.shape[1] == R,
            "alphas must be float32 [C, R]")
    return C, P, R


def uses_plain(*tensors: torch.Tensor) -> bool:
    """True when the plain PyTorch version must run: the inputs lie on the
    CPU (float64 included).  CUDA tensors take the kernel, which reads
    float32 and bfloat16 only: a float64 tensor on the card raises, as
    does a device that is neither CPU nor CUDA."""
    t0 = tensors[0]
    if t0.device.type == "cpu":
        return True
    if t0.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {t0.device}")
    for t in tensors:
        require(t.device == t0.device,
                f"tensors on {t.device} and {t0.device}")
        require(t.dtype != torch.float64,
                "float64 tensors on the card: the CUDA kernels take float32 "
                "and bfloat16 (fit with use_float=True, or on the CPU)")
        require(t.is_contiguous(), "kernel inputs must be contiguous")
    return False
