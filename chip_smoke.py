#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (name, power limit) and the torch / CUDA versions.
2. Builds the hand-written CUDA kernels from ``poismf_torch/csrc``.
3. Checks each kernel against its plain PyTorch version on the card, at
   the main path's shapes: the largest bucket and a long-row extension
   bucket of the Last.FM-scale item-side ELL, k=50, f32 and bf16 planes,
   4 line-search candidates; times both versions with CUDA events.
4. Fits a small problem on the card and on the CPU (kernels against
   plain versions through the whole solver) and compares the results.
5. Drives the main path: ``PoisMF(k=50, method="tncg", l2_reg=1e3,
   maxupd=750, reuse_prev=True, plane_dtype="bfloat16", niter=1)`` on
   synthetic Last.FM-360K-scale data (358,858 x 160,112, 17.16M
   nonzeros), then ``topN`` and ``topN_batched``; checks the factors, the
   train LL against the initial one, and the rankings against a CPU
   ``torch.topk``; requires every kernel to have launched in that run.

Prints one JSON line of per-kernel results before the last line, and as
the last line ``{"ok": true, "device": {...}}``.  Exits nonzero, with no
result line, when there is no CUDA device, when the repository's package
is absent, or when any check fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SEED = 0
K = 50
# Scale of the main-path data (1.0 = the full Last.FM-360K shape).
SCALE = 1.0
REPS = 7  # timed runs per version; the median is reported

KERNELS = {
    # name: (source, TPU kernel it replaces)
    "fgh": ("poismf_torch/csrc/fgh.cu",
            "poismf_tpu/ops/pallas_kernels.py:164"),
    "hvp": ("poismf_torch/csrc/hvp.cu",
            "poismf_tpu/ops/pallas_kernels.py:855"),
    "hvp_bv": ("poismf_torch/csrc/hvp.cu",
               "poismf_tpu/ops/pallas_kernels.py:886"),
    "raygtd": ("poismf_torch/csrc/raygtd.cu",
               "poismf_tpu/ops/pallas_kernels.py:796"),
}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def time_ms(torch, fn):
    """Median ms of REPS back-to-back runs, CUDA events between them."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(REPS + 1)]
    ev[0].record()
    for i in range(REPS):
        fn()
        ev[i + 1].record()
    torch.cuda.synchronize()
    return float(np.median([ev[i].elapsed_time(ev[i + 1])
                            for i in range(REPS)]))


def compare(torch, name, out, ref, rtol=1e-4):
    """Max abs error of ``out`` against ``ref``; fails beyond
    rtol * |ref| + rtol * max|ref| (float32 sums in another order), and
    on any difference of the inf/NaN pattern."""
    check(torch.equal(torch.isnan(out), torch.isnan(ref)),
          f"{name}: NaN pattern differs from the plain version")
    check(torch.equal(torch.isinf(out), torch.isinf(ref)),
          f"{name}: inf pattern differs from the plain version")
    fin = torch.isfinite(ref)
    o, r = out[fin].double(), ref[fin].double()
    if r.numel() == 0:
        return 0.0
    err = (o - r).abs()
    bound = rtol * r.abs() + rtol * float(r.abs().max())
    worst = float((err - bound).max())
    check(worst <= 0, f"{name}: max abs err {float(err.max()):.3e} "
                      f"exceeds rtol {rtol}")
    return float(err.max())


def kernel_phase(torch, data, results):
    """Phase 3: kernels against plain versions on real buckets."""
    from poismf_torch import kernels
    from poismf_torch.ops import ell as ell_ops
    from poismf_torch.train import initialize_factors

    t0 = time.perf_counter()
    ell = ell_ops.ell_from_counts(data.by_item, device="cuda")
    log(f"# item-side ELL built in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"P={b.P} x R={b.n_rows}"
                    + (f" ({b.ext.numel()} ext)" if b.ext is not None
                       else "") for b in ell.buckets))
    big = max(ell.buckets, key=lambda b: b.n_rows * b.P)
    ext = [b for b in ell.buckets if b.ext is not None and b is not big]
    picks = [("largest", big)] + ([("extension", ext[0])] if ext else [])
    if big.ext is not None:
        picks[0] = ("largest+extension", big)
    check(any(b.ext is not None for _, b in picks),
          "no long-row extension bucket in the item-side ELL")
    rng = np.random.default_rng(SEED + 1)
    A = initialize_factors(data.n_users, data.by_user.n_rows_pad, K, rng,
                           device="cuda")
    B = initialize_factors(data.n_items, ell.n_rows_ell, K, rng,
                           device="cuda")
    A_t = A.t().contiguous()
    g = torch.Generator(device="cuda").manual_seed(SEED)
    for label, b in picks:
        a_t = ell_ops._bucket_x(B, b).t().contiguous()
        vals = b.vals.float().contiguous()
        v_t = torch.randn(a_t.shape, generator=g, device="cuda") * 0.1
        R = b.n_rows
        # line-search candidate steps: small ones as the solver takes them
        # (all trial predictions positive; their error is the one
        # reported), and ones far past the first non-positive prediction,
        # which must poison the same rows as the plain version
        scale = 0.5 + torch.rand((1, R), generator=g, device="cuda")
        alphas = torch.tensor([1e-3, 3e-3, 1e-2, 3e-2],
                              device="cuda")[:, None] * scale
        alphas_far = torch.tensor([1e-1, 3.0, 30.0, 300.0],
                                  device="cuda")[:, None] * scale
        for pdt in (torch.float32, torch.bfloat16):
            bg = ell_ops.gather_bucket(A_t.to(pdt), b)
            tag = f"{label} P={b.P} R={R} {str(pdt)[6:]}"
            ref = kernels.fgh_bucket_torch(bg, vals, a_t, 1.0, True)
            out = kernels.fgh_bucket(bg, vals, a_t)
            err = max(compare(torch, f"fgh {tag} {n}", o, r)
                      for n, o, r in zip(("nll", "grad", "diag", "w2", "px"),
                                         out, ref))
            w2, px = ref[3], ref[4]
            href = kernels.hvp_bucket_torch(bg, w2, v_t, True)
            hout = kernels.hvp_bucket(bg, w2, v_t, want_bv=False)
            herr = compare(torch, f"hvp {tag}", hout[0], href[0])
            bout = kernels.hvp_bucket(bg, w2, v_t, want_bv=True)
            berr = max(compare(torch, f"hvp_bv {tag} out", bout[0], href[0]),
                       compare(torch, f"hvp_bv {tag} bv", bout[1], href[1]))
            pd = href[1]
            rref = kernels.raygtd_multi_bucket_torch(px, pd, vals, alphas)
            rout = kernels.raygtd_multi_bucket(px, pd, vals, alphas)
            rerr = max(compare(torch, f"raygtd {tag} {n}", o, r)
                       for n, o, r in zip(("nll", "gud"), rout, rref))
            fref = kernels.raygtd_multi_bucket_torch(px, pd, vals, alphas_far)
            fout = kernels.raygtd_multi_bucket(px, pd, vals, alphas_far)
            for n, o, r in zip(("nll", "gud"), fout, fref):
                compare(torch, f"raygtd far steps {tag} {n}", o, r)
            n_poison = int((~torch.isfinite(fref[0])).sum())
            check(n_poison > 0, "no poisoned ray trial to compare")
            timing = {
                "fgh": (lambda: kernels.fgh_bucket(bg, vals, a_t),
                        lambda: kernels.fgh_bucket_torch(bg, vals, a_t, 1.0,
                                                         True)),
                "hvp": (lambda: kernels.hvp_bucket(bg, w2, v_t),
                        lambda: kernels.hvp_bucket_torch(bg, w2, v_t)),
                "hvp_bv": (lambda: kernels.hvp_bucket(bg, w2, v_t, True),
                           lambda: kernels.hvp_bucket_torch(bg, w2, v_t,
                                                            True)),
                "raygtd": (lambda: kernels.raygtd_multi_bucket(
                               px, pd, vals, alphas),
                           lambda: kernels.raygtd_multi_bucket_torch(
                               px, pd, vals, alphas)),
            }
            errs = dict(fgh=err, hvp=herr, hvp_bv=berr, raygtd=rerr)
            for name, (kfn, pfn) in timing.items():
                ms_k = time_ms(torch, kfn)
                ms_p = time_ms(torch, pfn)
                log(f"# {name:7s} {tag}: max_abs_err {errs[name]:.3e}  "
                    f"kernel {ms_k:.4f} ms  plain {ms_p:.4f} ms")
                r = results.setdefault(name, dict(max_abs_err=0.0))
                r["max_abs_err"] = max(r["max_abs_err"], errs[name])
                if label.startswith("largest") and pdt == torch.bfloat16:
                    r["ms"], r["plain_ms"] = ms_k, ms_p
            log(f"# raygtd {tag}, far steps: {n_poison} poisoned (row, "
                "candidate) pairs, inf/NaN pattern identical")
            del bg, ref, out, href, hout, bout, rref, rout, fref, fout
        torch.cuda.empty_cache()


def small_fit_phase(torch):
    """Phase 4: one small problem fitted on the card and on the CPU."""
    from poismf_torch import PoisMF
    from poismf_torch.utils.data import synth_lastfm_like

    rng = np.random.default_rng(SEED + 2)
    rows, cols, vals = synth_lastfm_like(rng, 3000, 1500, 60_000)
    X = (rows, cols, vals, (3000, 1500))
    kw = dict(k=8, method="tncg", niter=2, plane_dtype="bfloat16",
              random_state=SEED)
    m_gpu = PoisMF(device="cuda", **kw).fit(X)
    m_cpu = PoisMF(device="cpu", **kw).fit(X)
    l_gpu, l_cpu = m_gpu.eval_llk(), m_cpu.eval_llk()
    rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    dz_a = abs((m_gpu.A == 0).mean() - (m_cpu.A == 0).mean())
    dz_b = abs((m_gpu.B == 0).mean() - (m_cpu.B == 0).mean())
    log(f"# small fit 3000x1500, 60k nnz, k=8: LL cuda {l_gpu:.6e} cpu "
        f"{l_cpu:.6e} (rel {rel:.2e}); zero share diff A {dz_a:.4f} "
        f"B {dz_b:.4f}")
    check(np.isfinite(l_gpu) and rel <= 1e-2,
          f"small fit LL differs between cuda and cpu by {rel:.3e}")
    check(dz_a <= 0.02 and dz_b <= 0.02, "small fit sparsity differs")


def topn_matches(torch, A, B, user, ids, n):
    """ids equal to a CPU torch.topk of the same factors, up to ties."""
    scores = B @ A[user]
    ref_vals, ref_ids = torch.topk(scores, n)
    if np.array_equal(ref_ids.numpy(), ids):
        return True
    got = scores[torch.as_tensor(ids)]
    return torch.allclose(got, ref_vals, rtol=1e-5, atol=0.0)


def main_path_phase(torch, X, data, results):
    """Phase 5: the port's main path, through its public entry points."""
    from poismf_torch import PoisMF, kernels
    from poismf_torch.ops import objective
    from poismf_torch.train import initialize_factors

    rng = np.random.default_rng(SEED)
    A0 = initialize_factors(data.n_users, data.by_user.n_rows_pad, K, rng,
                            device="cuda")
    B0 = initialize_factors(data.n_items, data.by_item.n_rows_pad, K, rng,
                            device="cuda")
    # the full Poisson LL (every user-item pair's -pred included) is what
    # the fit improves; the LL over the observed entries alone is printed
    # beside it, as the JAX bench reports it
    ll0 = float(objective.eval_llk(A0, B0, data.by_user,
                                   include_missing=True))
    ll0_obs = float(objective.eval_llk(A0, B0, data.by_user))
    del A0, B0

    model = PoisMF(k=K, method="tncg", l2_reg=1e3, maxupd=750,
                   reuse_prev=True, plane_dtype="bfloat16", niter=1,
                   random_state=SEED, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    model.fit(X)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    users = np.arange(5)
    top = [model.topN(int(u), n=10) for u in users]
    q = rng.choice(data.n_users, size=1024, replace=False)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    top_b = model.topN_batched(q, n=10)
    torch.cuda.synchronize()
    batched_s = time.perf_counter() - t1
    counts = dict(kernels.launch_counts)

    A, B = model.A, model.B
    check(A.shape == (data.n_users, K) and B.shape == (data.n_items, K),
          "factor shapes")
    check(np.isfinite(A).all() and np.isfinite(B).all(), "non-finite factors")
    check((A >= 0).all() and (B >= 0).all(), "negative factors")
    ll1 = model.eval_llk(include_missing=True)
    ll1_obs = model.eval_llk()
    log(f"# main path: fit {fit_s:.2f} s (niter=1: the B half and the A half "
        f"of one epoch, ELL build included), peak device memory "
        f"{peak_gb:.2f} GB")
    log(f"# train LL (all pairs) init {ll0:.6e} -> fitted {ll1:.6e}; over "
        f"the nonzeros {ll0_obs:.6e} -> {ll1_obs:.6e}; exact zeros "
        f"A {(A == 0).mean():.4f} B {(B == 0).mean():.4f}")
    log(f"# topN_batched 1024 users: {batched_s * 1e3:.2f} ms "
        f"({1024 / batched_s:.0f} queries/s, first call)")
    log(f"# kernel launches in the main path: {counts}")
    check(np.isfinite(ll1) and np.isfinite(ll1_obs) and ll1 > ll0,
          "train LL did not improve")
    At, Bt = torch.from_numpy(A), torch.from_numpy(B)
    for u, ids in zip(users, top):
        check(topn_matches(torch, At, Bt, int(u), ids, 10),
              f"topN of user {u} differs from a CPU topk")
    for row in range(8):
        check(topn_matches(torch, At, Bt, int(q[row]), top_b[row], 10),
              f"topN_batched row {row} differs from a CPU topk")
    for name, n in counts.items():
        check(n > 0, f"kernel {name} never launched in the main path")
        results[name]["launches"] = n


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"# python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from poismf_torch.kernels import _lib
    from poismf_torch.sparse import ingest
    from poismf_torch.utils.data import (N_ITEMS, N_USERS, NNZ_TARGET,
                                         synth_lastfm_like)

    t0 = time.perf_counter()
    _lib.library()
    log(f"# kernels built in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_lib.build_info['seconds']:.1f} s) -> "
        f"{_lib.build_info['path']}")
    for line in _lib.build_info.get("log", "").splitlines():
        if "registers" in line or "spill" in line:
            log("#   ptxas: " + line.strip())

    n_users, n_items = int(N_USERS * SCALE), int(N_ITEMS * SCALE)
    t0 = time.perf_counter()
    rows, cols, vals = synth_lastfm_like(np.random.default_rng(SEED),
                                         n_users, n_items,
                                         int(NNZ_TARGET * SCALE))
    X = (rows, cols, vals, (n_users, n_items))
    data = ingest(X)
    log(f"# data: {n_users} x {n_items}, {data.by_user.nnz} nonzeros "
        f"(scale {SCALE}), generated and ingested in "
        f"{time.perf_counter() - t0:.1f} s")

    results = {}
    kernel_phase(torch, data, results)
    small_fit_phase(torch)
    main_path_phase(torch, X, data, results)

    line = {"kernels": [
        dict(name=name, route="cuda", source=src, replaces=rep,
             launches=results[name]["launches"],
             max_abs_err=results[name]["max_abs_err"],
             ms=results[name]["ms"], plain_ms=results[name]["plain_ms"])
        for name, (src, rep) in KERNELS.items()
    ]}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
