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
from dataclasses import dataclass
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

# The ray kernel's own shape (csrc/raygtd.cu): rows per block (four a
# lane), the most warps a block splits P over, the slots a thread keeps in
# flight, the warps an SM holds at once, and the most splits of P.
RAY_TILE_R = 128
RAY_MAX_WARPS = 8
RAY_UNROLL = 4
RAY_WARPS_PER_SM = 16
RAY_MAX_SPLITS = 256
# Line-search candidates the multi-candidate kernels hold in registers
# (raygtd.cu, fgtd_multi.cu).
MAX_C = 8


def template_c(C: int) -> int:
    """The candidates of the kernel instance that runs C of them (1, 2, 4
    or 8: the next power of two)."""
    return 1 << (C - 1).bit_length()


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
                                   i, i, i, i, i, i, i, f, vp]
        lib.poismf_fgh.restype = i
        lib.poismf_hvp.argtypes = [vp, i, vp, vp, vp, vp, vp,
                                   i, i, i, i, i, i, i, vp]
        lib.poismf_hvp.restype = i
        ip = ctypes.POINTER(i)
        for name in ("fgh", "hvp", "fg", "f", "pg", "f_gtd", "f_gtd_fused",
                     *(f"f_gtd_multi_c{c}" for c in (1, 2, 4, 8))):
            fn = getattr(lib, f"poismf_{name}_occupancy")
            fn.argtypes = [i, i, i, i, i, ip, ip, ip, ip, ip]
            fn.restype = i
        for name in ("raygtd", "rayf"):
            fn = getattr(lib, f"poismf_{name}")
            fn.argtypes = [vp, vp, vp, vp, vp, vp, i, i, i, i, i, vp]
            fn.restype = i
        for name in ("fg", "f_gtd", "f_gtd_fused"):
            fn = getattr(lib, f"poismf_{name}")
            fn.argtypes = [vp, i, vp, vp, vp, vp, vp, i, i, i, i, i, i, i, vp]
            fn.restype = i
        for name in ("f", "pg"):
            fn = getattr(lib, f"poismf_{name}")
            fn.argtypes = [vp, i, vp, vp, vp, vp, i, i, i, i, i, i, i, vp]
            fn.restype = i
        lib.poismf_f_gtd_multi.argtypes = [vp, i, vp, vp, vp, vp, vp, i, vp,
                                           f, f, i, vp, vp,
                                           i, i, i, i, i, i, i, i, vp]
        lib.poismf_f_gtd_multi.restype = i
        lib.poismf_sweep_shape.argtypes = [ip, ip, ip]
        lib.poismf_sweep_shape.restype = None
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


def sm_count(device: torch.device) -> int:
    """SMs of a CUDA device (the current one for a bare ``cuda``)."""
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())


@dataclass(frozen=True)
class RayPlan:
    """Launch plan of the ray kernel: blocks of ``warps`` warps over 128
    rows, P cut into ``splits`` of ``p_per_split`` slots."""
    warps: int
    p_per_split: int
    splits: int


@functools.lru_cache(maxsize=None)
def ray_plan(C: int, P: int, R: int, sms: int, sums: int = 2) -> RayPlan:
    """The ray kernel's plan for C candidates on a [P, R] bucket, on a
    card of ``sms`` SMs, with ``sums`` sums a candidate (2: nll and g.d,
    raygtd and ray; 1: nll alone, rayf).

    P is cut into slices, a warp each: as many as bring the card to the
    ``RAY_WARPS_PER_SM`` warps an SM holds at once (twice as many above
    two candidates, where the arithmetic and not the planes' bytes set
    the pace and finer slices let the SMs end together), of at least one
    round of ``RAY_UNROLL`` slots each.  Up to ``RAY_MAX_WARPS`` slices
    share a block (a power of two; half as many where the block's sums,
    16 bytes a lane, sum and candidate of the kernel's template C, would
    outgrow its 48 KB of shared memory: above four candidates with g.d),
    fewer while that leaves SMs without a block; the rest are splits,
    ``RAY_MAX_SPLITS`` at most, their count chosen so that the blocks fill
    whole rounds of the card's resident blocks (a round that a few blocks
    spill into costs a whole one)."""
    tiles = -(-R // RAY_TILE_R)
    cap = RAY_WARPS_PER_SM * sms
    slices = max(1, min((cap if C <= 2 else 2 * cap) // tiles,
                        -(-P // RAY_UNROLL)))
    c_tpl = template_c(C)
    max_warps = RAY_MAX_WARPS
    while max_warps > 1 and max_warps * sums * c_tpl * 32 * 16 > 48 * 1024:
        max_warps //= 2
    warps = 1
    while warps * 2 <= min(max_warps, slices):
        warps *= 2
    while (warps > 1 and tiles * (slices // warps) < sms
           and slices // warps < RAY_MAX_SPLITS):
        warps //= 2
    resident = sms * (RAY_WARPS_PER_SM // warps)  # blocks at once
    best = None
    for splits in range(1, min(RAY_MAX_SPLITS, slices // warps) + 1):
        per = -(-P // splits)
        if -(-P // per) != splits:
            continue  # the same splits as a smaller count
        rounds = -(-tiles * splits // resident)
        cost = rounds * -(-per // warps)  # slots a warp, over the rounds
        if best is None or cost <= best[0]:
            best = (cost, per)
    return RayPlan(warps, best[1], -(-P // best[1]))


# The bg bytes a ring stage of the plane sweeps aims at
# (csrc/plane_sweep.cuh), and the resident warps an SM should hold to hide
# a tile's latency (a block's threads work through each tile between
# barriers; at pg's k=10, two k groups, 8-slot tiles gave 12 warps an SM
# and ran 19% slower than 4-slot tiles with 28: PERF.md, pg on the plane
# sweep).
SWEEP_STAGE_BYTES = 32 * 1024
SWEEP_MIN_WARPS = 16


@dataclass(frozen=True)
class SweepPlan:
    """Launch plan of a plane sweep: ``kg`` k groups of 64 threads, slot
    tiles of ``pt`` slots in a ring of ``stages``, P cut into ``splits``
    of ``p_per_split`` slots; ``smem`` bytes a block, ``blocks_per_sm``
    resident blocks, ``stage_bytes`` copied into each ring stage, and the
    ``slot_planes`` [P, R] planes the kernel copies with each tile."""
    kg: int
    pt: int
    stages: int
    p_per_split: int
    splits: int
    smem: int
    blocks_per_sm: int
    stage_bytes: int
    slot_planes: int


def choose_splits(blocks: int, P: int, pt: int, resident: int,
                  tile_bytes: int, fill_tiles: int, split_bytes: int) -> int:
    """Tiles of P per split, for ``blocks`` blocks per split on a card
    that holds ``resident`` at once: the count that minimises the modelled
    bytes, ``waves * (tiles + fill_tiles) * tile_bytes * resident`` (a
    partial last wave costs a whole one; ``fill_tiles`` is the ring's
    start-up per block) plus ``2 * splits * split_bytes`` for the partial
    sums written and added again when P is split."""
    n_tiles = -(-P // pt)
    best = None
    for tiles in range(1, n_tiles + 1):
        splits = -(-n_tiles // tiles)
        if -(-n_tiles // splits) != tiles:
            continue  # the same splits as fewer tiles
        waves = -(-(blocks * splits) // resident)
        cost = (waves * (tiles + fill_tiles) * tile_bytes * resident
                + (2 * splits * split_bytes if splits > 1 else 0))
        if best is None or cost < best[0]:
            best = (cost, tiles)
    return best[1]


def shrink_tile(pt: int, warps: int, blocks_at: Callable[[int], int]
                ) -> int:
    """The slot tile, halved from ``pt`` while the blocks an SM holds at
    it (``blocks_at(pt)``, of ``warps`` warps each) have fewer than
    ``SWEEP_MIN_WARPS`` warps together; 1 at least.  ``blocks_at`` is
    called last for the tile returned."""
    while pt > 1 and blocks_at(pt) * warps < SWEEP_MIN_WARPS:
        pt //= 2
    blocks_at(pt)
    return pt


def grow_tile(pt: int, stages: int, P: int,
              blocks_at: Callable[[int, int], int]) -> Tuple[int, int]:
    """The slot tile and ring stages when the SM holds no more blocks at a
    smaller tile: the registers, not the shared memory, bound them, as in
    f_gtd_multi at four candidates.  The tile is doubled, up to 8 slots
    and P, while the doubled tile in 3 or else 2 stages keeps the blocks
    an SM holds at ``pt`` (``blocks_at(pt, stages)``): fewer, longer tiles
    cost fewer barriers and share a tile's per-slot work over more k
    groups.  ``blocks_at`` is called last for the plan returned."""
    held = blocks_at(pt, stages)
    while pt < 8 and 2 * pt <= P:
        nxt = next(((2 * pt, st) for st in (3, 2)
                    if blocks_at(2 * pt, st) >= held), None)
        if nxt is None:
            break
        pt, stages = nxt
    blocks_at(pt, stages)
    return pt, stages


# Rows of a plane sweep's [out_rows, R] output block at k factors and C
# line-search candidates (f_gtd_multi: an f row and a g.d row each, on
# whichever template C runs them).
SWEEP_OUT_ROWS = {"fgh": lambda k, C=1: 1 + 2 * k, "hvp": lambda k, C=1: k,
                  "fg": lambda k, C=1: 1 + k, "f": lambda k, C=1: 1,
                  "pg": lambda k, C=1: k, "f_gtd": lambda k, C=1: 2,
                  "f_gtd_fused": lambda k, C=1: 2,
                  "f_gtd_multi": lambda k, C=1: 2 * C}


@functools.lru_cache(maxsize=None)
def sweep_shape() -> Tuple[int, int, int]:
    """The plane sweeps' fixed shape, from the library: (rows per block,
    k values a thread sums in registers, most k groups a block has)."""
    out = [ctypes.c_int(0) for _ in range(3)]
    library().poismf_sweep_shape(*(ctypes.byref(v) for v in out))
    return tuple(v.value for v in out)


def sweep_occupancy(name: str, bf16: bool, k: int, kg: int, pt: int,
                    stages: int, device_index: int) -> Tuple[int, ...]:
    """The library's answers for the sweep instance ``name`` at a plan:
    (shared memory of a block, blocks an SM holds (0 when that memory
    exceeds what a block may use), bytes copied into a ring stage, blocks
    along k, slot planes)."""
    fn = getattr(library(), f"poismf_{name}_occupancy")
    out = [ctypes.c_int(0) for _ in range(5)]
    with torch.cuda.device(device_index):
        check(fn(int(bf16), k, kg, pt, stages,
                 *(ctypes.byref(v) for v in out)), name)
    return tuple(v.value for v in out)


@functools.lru_cache(maxsize=None)
def _sweep_plan(kernel: str, k: int, P: int, R: int, itemsize: int,
                device_index: int, C: int = 1) -> SweepPlan:
    # f_gtd_multi has an instance per template C
    name = (f"{kernel}_c{template_c(C)}" if kernel == "f_gtd_multi"
            else kernel)
    rows, kpt, max_kg = sweep_shape()
    kg = min(max_kg, -(-k // kpt))
    k_rows = -(-k // (kg * kpt)) * kg * kpt  # tile rows, k padded
    seg = k_rows * rows * itemsize  # bg bytes of one slot of a row tile
    pt = 8
    while pt > 1 and (pt * seg > SWEEP_STAGE_BYTES or pt > P):
        pt //= 2
    # the library's answers at the last shape asked: shared memory and
    # blocks an SM, bytes of a ring stage, blocks along k, slot planes
    last = []

    def blocks_at(pt_: int, stages: int) -> int:
        last[:] = sweep_occupancy(name, itemsize == 2, k, kg, pt_, stages,
                                  device_index)
        return last[1]

    for pt_, stages in ((pt, 3), (pt, 2), (1, 2)):
        if blocks_at(pt_, stages) > 0:
            break
    else:
        raise ValueError(
            f"{kernel}: a bucket of k={k} needs {last[0]} bytes of shared "
            f"memory per block at its smallest tile, more than a block may "
            f"use on this card (k too large)")
    warps = kg * rows // 32
    pt_ = shrink_tile(pt_, warps, lambda p: blocks_at(p, stages))
    if last[1] * warps < SWEEP_MIN_WARPS:  # even at a 1-slot tile
        pt_, stages = grow_tile(pt_, stages, P, blocks_at)
    smem, blocks, stage_bytes, blocks_k, slot_planes = last
    out_rows = SWEEP_OUT_ROWS[kernel](k, C)
    tiles = choose_splits(blocks_k * -(-R // rows), P, pt_,
                          blocks * _sm_count(device_index), pt_ * seg,
                          stages - 1, 4 * out_rows * R)
    per = tiles * pt_
    return SweepPlan(kg, pt_, stages, per, -(-P // per), smem, blocks,
                     stage_bytes, slot_planes)


def sweep_plan(kernel: str, bg: torch.Tensor, *slot_planes: torch.Tensor,
               C: int = 1) -> SweepPlan:
    """The launch plan of ``kernel`` ("fgh", "hvp", "fg", "f", "pg",
    "f_gtd", "f_gtd_fused" or "f_gtd_multi", the latter at C candidates)
    on the bucket plane ``bg`` [k, P, R] and its [P, R] slot planes
    (f_gtd's bd plane beside vals); raises on what
    the copies of csrc/plane_sweep.cuh do not take: R not a multiple of 8
    (rows of 16-byte copies), planes not 16-byte aligned, a k whose
    smallest tile does not fit in shared memory, or another count of slot
    planes than the kernel copies (each is checked here before the kernel
    encodes a copy of it)."""
    k, P, R = bg.shape
    require(R % 8 == 0, f"{kernel}: R={R} rows must be a multiple of 8 "
                        "(the kernel copies 16-byte row segments)")
    require(all(t.data_ptr() % 16 == 0 for t in (bg, *slot_planes)),
            f"{kernel}: bg and the [P, R] planes must be 16-byte aligned")
    index = (bg.device.index if bg.device.index is not None
             else torch.cuda.current_device())
    plan = _sweep_plan(kernel, k, P, R, bg.element_size(), index, C)
    require(len(slot_planes) == plan.slot_planes,
            f"{kernel}: copies {plan.slot_planes} [P, R] slot planes with "
            f"each tile, {len(slot_planes)} given")
    return plan


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
