#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (name, power limit) and the torch / CUDA versions.
2. Builds the hand-written CUDA kernels from ``poismf_torch/csrc``.
3. Checks each of the twelve kernels against its plain PyTorch version
   on the card, at the main paths' shapes: the largest bucket and a
   long-row extension bucket of the Last.FM-scale item-side ELL, k=50
   (and k=10 for pg), f32 and bf16 planes, 4 line-search candidates at
   small steps and at steps far enough to poison rows, and rows whose
   factor vector is zero or negative for f, f_gtd and f_gtd_fused; times
   both versions with CUDA events and computes each kernel's bound (the
   larger of its bytes over the HBM rate and its operations over the f32
   rate, counted over the bucket's nonzero slots where the work skips
   the padding).  fgh, hvp, hvp_bv, fg, f, pg, f_gtd, f_gtd_fused and
   f_gtd_multi (the plane sweeps of ``csrc/plane_sweep.cuh``) and raygtd,
   ray and rayf (``csrc/raygtd.cu``) also run on the user side's shortest
   bucket (P=16 x 103,424 rows), are launched twice on each bucket and
   must give bitwise-equal outputs, and print their launch plan, achieved
   GB/s and share of their bound.
4. Drives the line-search evaluators of ``poismf_torch.ops.ell`` on the
   whole item-side ELL (k=50, bf16 planes of A) at an iterate x and a
   random direction d, launch counts set to 0 just before and read just
   after, and holds four identities at rtol 1e-4 with identical inf/NaN
   patterns: ``f_ell(x) = fg_ell(x)[0]``; ``f_gtd_ell(t, d, bdot_ell(d))
   = f_gtd_fused_ell(t, d)``; ``f_gtd_ray_ell(a) =
   f_gtd_ray_multi_ell(a[None])[0]``; and, for each candidate c and every
   true row (the primary rows of buckets holding extension chunks
   included), ``f_gtd_multi_ell(alphas)[c] =
   f_gtd_fused_ell(max(0, x + alphas[c] d), d)``.
5. Fits a small problem on the card and on the CPU (kernels against
   plain versions through the whole solver) for tncg, cg with the ray
   and the fused line search, and pg, and compares the results; prints
   the ray rounds (``f_ray_multi_ell`` calls) of the cg ray fit on both.
6. Drives the main paths on synthetic Last.FM-360K-scale data (358,858 x
   160,112, 17.16M nonzeros), each with the launch counts set to 0 just
   before and read just after:
   - tncg: ``PoisMF(k=50, method="tncg", l2_reg=1e3, maxupd=750,
     reuse_prev=True, plane_dtype="bfloat16", niter=1)``, then ``topN``
     and ``topN_batched``, checked against a CPU ``torch.topk``;
   - cg: ``PoisMF(k=50, method="cg", l2_reg=1e4, maxupd=5,
     plane_dtype="bfloat16", niter=3)`` (the published niter is 30);
   - pg: ``PoisMF(k=10, method="pg", l2_reg=1e9, maxupd=1, niter=10,
     plane_dtype="bfloat16")``, the published configuration.
   Each checks the factors, its objective (-LL plus the l2 penalty) and,
   for tncg and cg, the train LL against the initial one, and that its
   own kernels launched; prints its fit seconds and peak device memory.
   pg is then fitted again on the CPU (plain versions, same data and
   seed), and the card's train LL must agree with it within 1e-4.
7. Serves from each fitted model of phase 6, launch counts set to 0
   just before each call and read just after:
   - ``transform`` of 16,384 new users on the same item catalog (a CSR,
     783,600 draws, the training data's ~48 items a user) by each model,
     so by the tncg, cg and pg serving solves; checks that the path's
     kernels launched, that the factors are finite and >= 0 and that each
     row's serving objective (-LL over its items + <Bsum, a> + l2 |a|^2)
     is no higher than at its init; the path's kernels held to their
     plain versions on the solve's own ELL, planes and factors; 512 of
     those users are solved again on the CPU (plain versions) from the
     card's B, Bsum and Amean, and the summed objectives must agree
     within ``SERVE_CPU_RTOL``; for cg also the same 512 users run to
     convergence (150 iterations) on the card and on the CPU;
   - tncg: ``predict_factors`` / ``topN_new`` for 8 single users (7 of
     the new batch and the training user with the most items, beyond
     P_MAX = 2048: a row of extension chunks), top-N checked against a
     CPU ``torch.topk``; the first and the last of them, their kernels
     held to the plain versions on their one-row ELL, solved again on
     the CPU, each within ``SERVE_SINGLE_ROUNDINGS`` float32 epsilons of
     its objective's terms; ``topN_batched(exclude_seen=True)``
     for phase 6's 1,024 users, checked against a CPU ``torch.topk`` with
     each user's training items masked.

Prints one JSON line of per-kernel results before the last line, and as
the last line ``{"ok": true, "device": {...}}``.  Exits nonzero, with no
result line, when there is no CUDA device, when the repository's package
is absent, or when any check fails.
"""

from __future__ import annotations

import dataclasses
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
    "fg": ("poismf_torch/csrc/fg.cu",
           "poismf_tpu/ops/pallas_kernels.py:238"),
    "rayf": ("poismf_torch/csrc/raygtd.cu",
             "poismf_tpu/ops/pallas_kernels.py:732"),
    "pg": ("poismf_torch/csrc/pg.cu",
           "poismf_tpu/ops/pallas_kernels.py:281"),
    "f": ("poismf_torch/csrc/fg.cu",
          "poismf_tpu/ops/pallas_kernels.py:324"),
    "f_gtd": ("poismf_torch/csrc/fgtd.cu",
              "poismf_tpu/ops/pallas_kernels.py:374"),
    "f_gtd_fused": ("poismf_torch/csrc/fgtd.cu",
                    "poismf_tpu/ops/pallas_kernels.py:445"),
    "f_gtd_multi": ("poismf_torch/csrc/fgtd_multi.cu",
                    "poismf_tpu/ops/pallas_kernels.py:567"),
    "ray": ("poismf_torch/csrc/raygtd.cu",
            "poismf_tpu/ops/pallas_kernels.py:662"),
}
# Kernels driven by the line-search phase (section 4 of the docstring).
LINE_SEARCH_KERNELS = ("f", "f_gtd", "f_gtd_fused", "f_gtd_multi", "ray")
# The line-search phase's regularization, and its trial steps per row.
LS_L2 = 1e3
LS_STEPS = (0.25, 0.5, 1.0, 2.0)

# The main paths (section 6 of the docstring): constructor arguments and
# the kernels each must launch.
PATHS = {
    "tncg": (dict(k=K, method="tncg", l2_reg=1e3, maxupd=750,
                  reuse_prev=True, plane_dtype="bfloat16", niter=1),
             ("fgh", "hvp", "hvp_bv", "raygtd")),
    "cg": (dict(k=K, method="cg", l2_reg=1e4, maxupd=5,
                plane_dtype="bfloat16", niter=3),
           ("fg", "rayf")),
    "pg": (dict(k=10, method="pg", l2_reg=1e9, maxupd=1, niter=10,
                plane_dtype="bfloat16"),
           ("pg",)),
}
# The serving phase (section 7 of the docstring): the new users'
# data, and the kernels each model's serving solve must launch (tncg
# serves with the reference inner-CG cap, maxCGit = 25 at k=50: plain
# HVPs, no hvp_bv).
SERVE_USERS, SERVE_NNZ = 16_384, 783_600
SERVE_KERNELS = {"tncg": ("fgh", "hvp", "raygtd"), "cg": ("fg", "rayf"),
                 "pg": ("pg",)}
SERVE_CPU_USERS = 512
# Limits of the card-versus-CPU serving checks: the relative gap of the
# summed serving objective, per transform path and for cg run to
# convergence.  Measured on an NVIDIA H100 80GB HBM3 at 700 W: tncg
# 2.2e-10 to 2.0e-9 (the largest per-row gap of 512 tncg rows 9.6e-8),
# pg 7.3e-13, cg converged 1.4e-10 to 3.6e-9.  cg's 15 iterations do not
# converge and follow rounding: card against CPU 2.6e-7 to 4.2e-6, and on
# the CPU alone float32 against float64 1.7e-5
# (scripts/torch_cg_armijo_base_probe.py).
SERVE_CPU_RTOL = {"tncg": 1e-7, "pg": 1e-7, "cg": 5e-5, "cg converged": 1e-7}
# A single user's solve is one row, with no other rows to average its
# rounding: with ftol = 0 both solves run until float32 no longer sees
# the row's objective fall, and stop anywhere within a few float32
# roundings of its terms (sum |x log <a, B_i>| + <Bsum, a> + l2 |a|^2).
# A row of extension chunks is not even reproducible on the card: its
# chunks' sums are added with index_add_, in no fixed order.  The limit
# is this many float32 epsilons of those terms; measured on the same
# card: 0.00 to 0.09, and 2.0 once (a 5,158-item row, 2.4e-7 relative).
SERVE_SINGLE_ROUNDINGS = 16
F32_EPS = 2.0 ** -23
SERVE_CG_CONVERGED_MAXUPD = 50
# Slack of the per-row "no higher than at its init" test: the solvers
# decide in float32, the objective is evaluated here in float64.
SERVE_INIT_RTOL = 1e-6

# Main paths fitted again on the CPU, same data and seed, and the band
# their train LL must keep to it (float32 sums in another order).  pg's
# published l2=1e9 leaves an objective that is almost all penalty, so
# its objective falling says little about its data term: this check does.
CPU_REFERENCE = ("pg",)
CPU_REFERENCE_RTOL = 1e-4

# One H100 SXM (NVIDIA's data sheet): HBM bytes/s and float32 operations/s
# outside the tensor cores, at the full 700 W power limit.
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def time_ms(torch, fn):
    """Median ms of REPS back-to-back runs, CUDA events between them.  The
    card is first kept busy for ~10 ms, so that the runs queue up behind
    it and the events time the card, not the host's pace of launching
    (which is slower than the shortest kernels here)."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(REPS + 1)]
    torch.cuda._sleep(20_000_000)
    ev[0].record()
    for i in range(REPS):
        fn()
        ev[i + 1].record()
    torch.cuda.synchronize()
    return float(np.median([ev[i].elapsed_time(ev[i + 1])
                            for i in range(REPS)]))


def bound(nbytes, ops):
    """(bound_ms, bound_by): the least time for the work, the larger of
    its bytes over the HBM rate and its operations over the f32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / F32_OPS_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def work(name, k, P, R, itemsize, nnz, C=4):
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
        # bg, vals, a_t in; nll, grad, diag, w2, px out
        "fgh": (full + slot + k * row + (1 + 2 * k) * row + 2 * slot,
                P * R * 2 * k + nnz * (5 * k + 8)),
        "hvp": (valid + slot + 2 * k * row, nnz * (4 * k + 1)),
        "hvp_bv": (full + 2 * slot + 2 * k * row,
                   P * R * 2 * k + nnz * (2 * k + 1)),
        # vals, and px, pd at the nonzero slots, alphas in; nll and g.d
        # per candidate out
        "raygtd": (slot + 8 * nnz + 3 * C * row, nnz * 9 * C),
        # bg, vals, a_t in; nll, grad, px out
        "fg": (full + 2 * slot + (1 + 2 * k) * row,
               P * R * 2 * k + nnz * (2 * k + 5)),
        "rayf": (slot + 8 * nnz + 2 * C * row, nnz * 5 * C),
        "pg": (valid + slot + 2 * k * row, nnz * (4 * k + 2)),
        # bg, vals, a_t in; nll out
        "f": (valid + slot + (k + 1) * row, nnz * (2 * k + 3)),
        # bg, vals, a_t, bd (nonzero slots) in; nll, gud out
        "f_gtd": (valid + slot + 4 * nnz + (k + 2) * row,
                  nnz * (2 * k + 6)),
        # bg, vals, a_t, d_t in; nll, gud out
        "f_gtd_fused": (valid + slot + (2 * k + 2) * row,
                        nnz * (4 * k + 6)),
        # bg, vals, x_t, d_t, alphas, a [k] Bsum in; f, gtd per candidate
        # out; C + 1 dots a slot, and per row and candidate the trial and
        # the four folded dot products
        "f_gtd_multi": (valid + slot + (2 * k + 3 * C) * row + 4 * k,
                        nnz * (2 * k * (C + 1) + 7 * C) + R * C * 11 * k),
        # the one-step ray: raygtd at C = 1
        "ray": (slot + 8 * nnz + 3 * row, nnz * 9),
    }[name]


def compare(torch, name, out, ref, rtol=1e-4, rows=None):
    """Max abs error of ``out`` against ``ref``; fails beyond
    rtol * |ref| + rtol * max|ref| (float32 sums in another order), and
    on any difference of the inf/NaN pattern.  ``rows`` (bool over the
    last axis) marks rows poisoned on purpose, whose ratios of order
    x / 1e-30 are held to their own scale, apart; the error returned is
    the other rows'."""
    if rows is not None:
        compare(torch, name + " (poisoned rows)", out[..., rows],
                ref[..., rows], rtol)
        return compare(torch, name, out[..., ~rows], ref[..., ~rows], rtol)
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


def sweep_kernels(torch, tag, bg, vals, a_t, v_t, pg_planes, nnz, results,
                  record):
    """fgh, hvp, hvp_bv, fg, f, pg, f_gtd and f_gtd_fused
    (csrc/plane_sweep.cuh) on one bucket, pg on its own k=10 planes
    ``pg_planes`` (bg, a_t), f_gtd_fused in the direction ``v_t`` and f_gtd
    with its <B, v_t> plane pd: each against its plain version, launched
    twice for bitwise-equal outputs, timed beside its plain version, with
    its launch plan, achieved GB/s and share of its bound; fg, f, pg, f_gtd
    and f_gtd_fused also at rows whose factor vector is zero (+inf) or
    negative (NaN; pg's weights and the g.d ratios of order x * 1e30).
    ``record`` puts the times in the kernels' results.  Returns the plain
    versions' (w2, px, pd) planes and the counts of f's, f_gtd's and
    f_gtd_fused's poisoned rows."""
    from poismf_torch import kernels
    from poismf_torch.kernels import _lib

    k, P, R = bg.shape
    it = bg.element_size()
    bg10, a_t10 = pg_planes
    ref = kernels.fgh_bucket_torch(bg, vals, a_t, 1.0, True)
    w2, px = ref[3], ref[4]
    href = kernels.hvp_bucket_torch(bg, w2, v_t, True)
    fgref = kernels.fg_bucket_torch(bg, vals, a_t, True)
    pd = href[1]
    gtd = (
        # f_gtd with the hoisted <B, v_t> plane, f_gtd_fused with v_t
        ("f_gtd", kernels.f_gtd_bucket, kernels.f_gtd_bucket_torch, pd,
         (bg, vals, pd)),
        ("f_gtd_fused", kernels.f_gtd_fused_bucket,
         kernels.f_gtd_fused_bucket_torch, v_t, (bg, vals)))
    calls = {
        # name: (kernel call, plain call, plain outputs, output names,
        # the plan's kernel and planes)
        "fgh": (lambda: kernels.fgh_bucket(bg, vals, a_t),
                lambda: kernels.fgh_bucket_torch(bg, vals, a_t, 1.0, True),
                ref, ("nll", "grad", "diag", "w2", "px"), "fgh", (bg, vals)),
        "hvp": (lambda: kernels.hvp_bucket(bg, w2, v_t),
                lambda: kernels.hvp_bucket_torch(bg, w2, v_t),
                href[:1], ("out",), "hvp", (bg, w2)),
        "hvp_bv": (lambda: kernels.hvp_bucket(bg, w2, v_t, True),
                   lambda: kernels.hvp_bucket_torch(bg, w2, v_t, True),
                   href, ("out", "bv"), "hvp", (bg, w2)),
        "fg": (lambda: kernels.fg_bucket(bg, vals, a_t),
               lambda: kernels.fg_bucket_torch(bg, vals, a_t, True),
               fgref, ("nll", "grad", "px"), "fg", (bg, vals)),
        "f": (lambda: (kernels.f_bucket(bg, vals, a_t),),
              lambda: kernels.f_bucket_torch(bg, vals, a_t),
              fgref[:1], ("nll",), "f", (bg, vals)),
        "pg": (lambda: (kernels.pg_bucket(bg10, vals, a_t10),),
               lambda: kernels.pg_bucket_torch(bg10, vals, a_t10),
               (kernels.pg_bucket_torch(bg10, vals, a_t10),), ("out",),
               "pg", (bg10, vals)),
    }
    for name, kern, plain, direction, planes in gtd:
        calls[name] = (
            lambda kern=kern, direction=direction: kern(bg, vals, a_t,
                                                        direction),
            lambda plain=plain, direction=direction: plain(bg, vals, a_t,
                                                           direction),
            plain(bg, vals, a_t, direction), ("nll", "gud"), name, planes)
    for name, (kern, plain, want, names, planned, planes) in calls.items():
        out1, out2 = kern(), kern()
        err = max(compare(torch, f"{name} {tag} {n}", o, r)
                  for n, o, r in zip(names, out1, want))
        for n, o1, o2 in zip(names, out1, out2):
            check(torch.equal(o1.view(torch.int32), o2.view(torch.int32)),
                  f"{name} {tag} {n}: two launches differ bitwise")
        del out1, out2
        plan = _lib.sweep_plan(planned, *planes)
        in_flight = plan.blocks_per_sm * (plan.stages - 1) * plan.stage_bytes
        ms_k, ms_p = time_ms(torch, kern), time_ms(torch, plain)
        nbytes, ops = work(name, planes[0].shape[0], P, R, it, nnz)
        b_ms, b_by = bound(nbytes, ops)
        log(f"# {name:7s} {tag}: max_abs_err {err:.3e}  kernel {ms_k:.4f} "
            f"ms  plain {ms_p:.4f} ms  bound {b_ms:.4f} ms ({b_by}); "
            f"{nbytes / ms_k / 1e6:.0f} GB/s, {b_ms / ms_k:.1%} of its "
            f"bound; two launches bitwise equal; plan kg={plan.kg} "
            f"pt={plan.pt} stages={plan.stages} splits={plan.splits} "
            f"smem={plan.smem} B x {plan.blocks_per_sm} blocks/SM, "
            f"{in_flight / 1024:.0f} KB of bg in flight per SM")
        r = results.setdefault(name, dict(max_abs_err=0.0))
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if record:
            r.update(ms=ms_k, plain_ms=ms_p, bound_ms=b_ms, bound_by=b_by)
    # fg without px, and fg, f and pg with the first rows' factor vectors
    # zeroed (+inf) or negated (NaN); fg's gradient stays finite there
    out = kernels.fg_bucket(bg, vals, a_t, want_pred=False)
    check(out[2] is None, "fg wrote px with want_pred=False")
    err = max(compare(torch, f"fg {tag} no px {n}", o, r)
              for n, o, r in zip(("nll", "grad"), out, fgref))
    a_tz = a_t.clone()
    a_tz[:, :4] = 0.0
    a_tz[:, 4:6] *= -1.0
    bad = torch.zeros(a_t.shape[1], dtype=torch.bool, device=a_t.device)
    bad[:6] = True
    zref = kernels.fg_bucket_torch(bg, vals, a_tz, True)
    zout = kernels.fg_bucket(bg, vals, a_tz)
    err = max([err] + [compare(torch, f"fg {tag} poisoned {n}", o, r,
                               rows=bad)
                       for n, o, r in zip(("nll", "grad", "px"), zout, zref)])
    check(bool(torch.isfinite(zout[1]).all()),
          f"fg {tag}: a gradient is not finite on the poisoned rows")
    results["fg"]["max_abs_err"] = max(results["fg"]["max_abs_err"], err)
    err = compare(torch, f"f {tag} poisoned", kernels.f_bucket(bg, vals, a_tz),
                  zref[0], rows=bad)
    results["f"]["max_abs_err"] = max(results["f"]["max_abs_err"], err)
    n_poison = {"f": int((~torch.isfinite(zref[0])).sum())}
    # f_gtd and f_gtd_fused at the same rows: +inf or NaN nll, g.d ratios
    # of order x / 1e-30
    for name, kern, plain, direction, _ in gtd:
        gref = plain(bg, vals, a_tz, direction)
        err = max(compare(torch, f"{name} {tag} poisoned {n}", o, r,
                          rows=bad)
                  for n, o, r in zip(("nll", "gud"),
                                     kern(bg, vals, a_tz, direction), gref))
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
        n_poison[name] = int((~torch.isfinite(gref[0])).sum())
    for name, n in n_poison.items():
        check(n > 0, f"{name} {tag}: no poisoned row to compare")
    a_tz10 = a_tz[:a_t10.shape[0]].contiguous()
    pref = kernels.pg_bucket_torch(bg10, vals, a_tz10)
    check(float(pref[:, bad].abs().max()) > 1e20,
          f"pg {tag}: no floored prediction to compare")
    err = compare(torch, f"pg {tag} poisoned",
                  kernels.pg_bucket(bg10, vals, a_tz10), pref, rows=bad)
    results["pg"]["max_abs_err"] = max(results["pg"]["max_abs_err"], err)
    return w2, px, pd, n_poison


def multi_kernel(torch, tag, bg, vals, a_t, v_t, bsum, fold, alphas,
                 alphas_far, nnz, results, record):
    """f_gtd_multi (csrc/fgtd_multi.cu on csrc/plane_sweep.cuh) on one
    bucket at the C = 4 projected trials max(0, a_t + alpha d): d = v_t,
    but -2 a_t on rows 2-5, whose trials project to zero from a step of
    0.5 on (+inf); Bsum ``bsum`` [k]; the linear terms fold on the rows
    ``fold`` marks.  Against its plain version at the small steps and at
    the far ones (identical inf/NaN pattern), launched twice for
    bitwise-equal outputs, timed beside its plain version, with its launch
    plan, achieved GB/s and share of its bound.  Returns the poisoned
    (row, candidate) count at the far steps."""
    from poismf_torch import kernels
    from poismf_torch.kernels import _lib

    k, P, R = bg.shape
    d_m = v_t.clone()
    d_m[:, 2:6] = -2.0 * a_t[:, 2:6]
    mbad = torch.zeros(R, dtype=torch.bool, device=bg.device)
    mbad[2:6] = True

    def args(al):
        return (bg, vals, a_t, d_m, al, bsum, LS_L2, 1.0, False, fold)

    out1 = kernels.f_gtd_multi_bucket(*args(alphas))
    out2 = kernels.f_gtd_multi_bucket(*args(alphas))
    err = max(compare(torch, f"f_gtd_multi {tag}", o, r, rows=mbad)
              for o, r in zip(out1, kernels.f_gtd_multi_bucket_torch(
                  *args(alphas))))
    for o1, o2 in zip(out1, out2):
        check(torch.equal(o1.view(torch.int32), o2.view(torch.int32)),
              f"f_gtd_multi {tag}: two launches differ bitwise")
    del out1, out2
    rref = kernels.f_gtd_multi_bucket_torch(*args(alphas_far))
    for o, r in zip(kernels.f_gtd_multi_bucket(*args(alphas_far)), rref):
        compare(torch, f"f_gtd_multi far steps {tag}", o, r, rows=mbad)
    n_poison = int((~torch.isfinite(rref[0])).sum())
    C = alphas.shape[0]
    plan = _lib.sweep_plan("f_gtd_multi", bg, vals, C=C)
    in_flight = plan.blocks_per_sm * (plan.stages - 1) * plan.stage_bytes
    ms_k = time_ms(torch, lambda: kernels.f_gtd_multi_bucket(*args(alphas)))
    ms_p = time_ms(torch,
                   lambda: kernels.f_gtd_multi_bucket_torch(*args(alphas)))
    nbytes, ops = work("f_gtd_multi", k, P, R, bg.element_size(), nnz, C)
    b_ms, b_by = bound(nbytes, ops)
    log(f"# f_gtd_multi {tag}: max_abs_err {err:.3e}  kernel {ms_k:.4f} ms  "
        f"plain {ms_p:.4f} ms  bound {b_ms:.4f} ms ({b_by}); "
        f"{nbytes / ms_k / 1e6:.0f} GB/s, {b_ms / ms_k:.1%} of its bound; "
        f"two launches bitwise equal; plan C={C} kg={plan.kg} pt={plan.pt} "
        f"stages={plan.stages} splits={plan.splits} smem={plan.smem} B x "
        f"{plan.blocks_per_sm} blocks/SM, {in_flight / 1024:.0f} KB of bg "
        f"in flight per SM")
    r = results.setdefault("f_gtd_multi", dict(max_abs_err=0.0))
    r["max_abs_err"] = max(r["max_abs_err"], err)
    if record:
        r.update(ms=ms_k, plain_ms=ms_p, bound_ms=b_ms, bound_by=b_by)
    return n_poison


def ray_kernels(torch, tag, px, pd, vals, alphas, alphas_far, nnz, results,
                record):
    """raygtd (the C = 4 steps ``alphas``), ray (C = 1, its third row) and
    rayf (the C = 4 steps, no g.d sums) of csrc/raygtd.cu on one bucket's
    prediction planes: each against its plain version at the small steps
    and at the far ones (identical inf/NaN pattern), launched twice for
    bitwise-equal outputs, timed beside its plain version, with its launch
    plan, achieved GB/s and share of its bound.  Returns the poisoned
    (row, candidate) counts."""
    from poismf_torch import kernels
    from poismf_torch.kernels import _lib

    P, R = px.shape
    n_poison = {}
    for name, kern, plain, pick in (
            ("raygtd", kernels.raygtd_multi_bucket,
             kernels.raygtd_multi_bucket_torch, lambda al: al),
            ("ray", kernels.ray_bucket, kernels.ray_bucket_torch,
             lambda al: al[2:3]),
            ("rayf", lambda *a: (kernels.rayf_multi_bucket(*a),),
             lambda *a: (kernels.rayf_multi_bucket_torch(*a),),
             lambda al: al)):
        al, far = pick(alphas), pick(alphas_far)
        out1, out2 = kern(px, pd, vals, al), kern(px, pd, vals, al)
        err = max(compare(torch, f"{name} {tag}", o, r)
                  for o, r in zip(out1, plain(px, pd, vals, al)))
        for o1, o2 in zip(out1, out2):
            check(torch.equal(o1.view(torch.int32), o2.view(torch.int32)),
                  f"{name} {tag}: two launches differ bitwise")
        fref = plain(px, pd, vals, far)
        for o, r in zip(kern(px, pd, vals, far), fref):
            compare(torch, f"{name} far steps {tag}", o, r)
        n_poison[name] = int((~torch.isfinite(fref[0])).sum())
        check(n_poison[name] > 0, f"{name} {tag}: no poisoned ray trial")
        C = al.shape[0]
        plan = kernels.raygtd.plan_of(px, pd, vals, C, name != "rayf")
        tiles = -(-R // _lib.RAY_TILE_R)
        resident = min(_lib.RAY_WARPS_PER_SM, -(-tiles * plan.warps
                                                * plan.splits
                                                // _lib.sm_count(px.device)))
        in_flight = resident * _lib.RAY_UNROLL * 3 * 4 * _lib.RAY_TILE_R
        ms_k = time_ms(torch, lambda: kern(px, pd, vals, al))
        ms_p = time_ms(torch, lambda: plain(px, pd, vals, al))
        nbytes, ops = work(name, K, P, R, 4, nnz, C)
        b_ms, b_by = bound(nbytes, ops)
        log(f"# {name:7s} {tag}: max_abs_err {err:.3e}  kernel {ms_k:.4f} "
            f"ms  plain {ms_p:.4f} ms  bound {b_ms:.4f} ms ({b_by}); "
            f"{nbytes / ms_k / 1e6:.0f} GB/s, {b_ms / ms_k:.1%} of its "
            f"bound; two launches bitwise equal; plan C={C} "
            f"warps={plan.warps} splits={plan.splits} "
            f"p_per_split={plan.p_per_split}, {in_flight / 1024:.0f} KB of "
            f"the planes in flight per SM")
        r = results.setdefault(name, dict(max_abs_err=0.0))
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if record:
            r.update(ms=ms_k, plain_ms=ms_p, bound_ms=b_ms, bound_by=b_by)
    return n_poison


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
            # the pg path's planes: k=10 (its published configuration)
            bg10 = ell_ops.gather_bucket(A_t[:10].contiguous().to(pdt), b)
            a_t10 = a_t[:10].contiguous()
            tag = f"{label} P={b.P} R={R} {str(pdt)[6:]}"
            errs = {}
            nnz = int((vals > 0).sum())
            log(f"# {tag}: {nnz} nonzero slots of {b.P * R}")
            record = label.startswith("largest") and pdt == torch.bfloat16
            w2, px, pd, n_poison = sweep_kernels(
                torch, tag, bg, vals, a_t, v_t, (bg10, a_t10), nnz, results,
                record)
            n_poison.update(ray_kernels(torch, tag, px, pd, vals, alphas,
                                        alphas_far, nnz, results, record))
            errs["pg k=50"] = compare(torch, f"pg k=50 {tag}",
                                      kernels.pg_bucket(bg, vals, a_t),
                                      kernels.pg_bucket_torch(bg, vals, a_t))
            # f_gtd_multi: the item side's Bsum is A's colsums; the linear
            # terms fold on the bucket's primary rows
            n_poison["f_gtd_multi"] = multi_kernel(
                torch, tag, bg, vals, a_t, v_t, A[:data.n_users].sum(0),
                None if b.src is None else ell_ops._self_mask(b), alphas,
                alphas_far, nnz, results, record)
            for name in LINE_SEARCH_KERNELS:
                check(n_poison[name] > 0,
                      f"{name}: no poisoned row or trial to compare")
            it = bg.element_size()
            timing = [
                # (name, kernel call, plain call, k of the work)
                ("pg k=50", lambda: kernels.pg_bucket(bg, vals, a_t),
                 lambda: kernels.pg_bucket_torch(bg, vals, a_t), K),
            ]
            for name, kfn, pfn, kw in timing:
                ms_k = time_ms(torch, kfn)
                ms_p = time_ms(torch, pfn)
                b_ms, b_by = bound(*work(name.split()[0], kw, b.P, R, it,
                                         nnz, alphas.shape[0]))
                log(f"# {name:7s} {tag}: max_abs_err {errs[name]:.3e}  "
                    f"kernel {ms_k:.4f} ms  plain {ms_p:.4f} ms  "
                    f"bound {b_ms:.4f} ms ({b_by})")
                if name not in KERNELS:
                    continue
                r = results.setdefault(name, dict(max_abs_err=0.0))
                r["max_abs_err"] = max(r["max_abs_err"], errs[name])
                if label.startswith("largest") and pdt == torch.bfloat16:
                    r.update(ms=ms_k, plain_ms=ms_p, bound_ms=b_ms,
                             bound_by=b_by)
            for name, n in n_poison.items():
                log(f"# {name} {tag}, far steps: {n} poisoned (row, "
                    "candidate) pairs, inf/NaN pattern identical")
            del bg, bg10, w2, px, pd, timing
        torch.cuda.empty_cache()
    # the user side's shortest, widest bucket, where a slot tile is most of
    # a row's slots and a ray block has few slots to share: the plane
    # sweeps (f_gtd_multi with B's colsums as its Bsum) and the ray kernels
    t0 = time.perf_counter()
    uell = ell_ops.ell_from_counts(data.by_user, device="cuda")
    short = min(uell.buckets, key=lambda b: (b.P, -b.n_rows))
    log(f"# user-side ELL built in {time.perf_counter() - t0:.1f} s; its "
        f"shortest bucket P={short.P} x R={short.n_rows}")
    A_u = initialize_factors(uell.n_rows_ell, uell.n_rows_ell, K, rng,
                             device="cuda")
    a_t = ell_ops._bucket_x(A_u, short).t().contiguous()
    vals = short.vals.float().contiguous()
    v_t = torch.randn(a_t.shape, generator=g, device="cuda") * 0.1
    nnz = int((vals > 0).sum())
    B_t = B.t().contiguous()
    for pdt in (torch.float32, torch.bfloat16):
        tag = f"short user-side P={short.P} R={short.n_rows} {str(pdt)[6:]}"
        log(f"# {tag}: {nnz} nonzero slots of {short.P * short.n_rows}")
        pg_planes = (ell_ops.gather_bucket(B_t[:10].contiguous().to(pdt),
                                           short), a_t[:10].contiguous())
        bg = ell_ops.gather_bucket(B_t.to(pdt), short)
        _, px, pd, n_sweep = sweep_kernels(
            torch, tag, bg, vals, a_t, v_t, pg_planes, nnz, results,
            record=False)
        scale = 0.5 + torch.rand((1, short.n_rows), generator=g,
                                 device="cuda")
        steps = torch.tensor([1e-3, 3e-3, 1e-2, 3e-2], device="cuda")[:, None]
        far = torch.tensor([1e-1, 3.0, 30.0, 300.0], device="cuda")[:, None]
        n_multi = multi_kernel(
            torch, tag, bg, vals, a_t, v_t, B[:data.n_items].sum(0),
            None if short.src is None else ell_ops._self_mask(short),
            steps * scale, far * scale, nnz, results, record=False)
        check(n_multi > 0, f"f_gtd_multi {tag}: no poisoned trial")
        n_poison = ray_kernels(torch, tag, px, pd, vals, steps * scale,
                               far * scale, nnz, results, record=False)
        log(f"# {tag}, poisoned: f {n_sweep['f']}, f_gtd "
            f"{n_sweep['f_gtd']} and f_gtd_fused {n_sweep['f_gtd_fused']} "
            f"rows, f_gtd_multi {n_multi}, raygtd {n_poison['raygtd']} and "
            f"rayf {n_poison['rayf']} (row, candidate) pairs, ray "
            f"{n_poison['ray']} rows, inf/NaN pattern identical")
        del px, pd, pg_planes, bg
    del uell, short, A_u, B_t
    torch.cuda.empty_cache()
    return ell


def line_search_phase(torch, data, ell, results):
    """Phase 4: the line-search evaluators on the whole item-side ELL."""
    from poismf_torch import kernels
    from poismf_torch.ops import ell as ell_ops
    from poismf_torch.ops import objective
    from poismf_torch.train import initialize_factors

    rng = np.random.default_rng(SEED + 3)
    A = initialize_factors(data.n_users, data.by_user.n_rows_pad, K, rng,
                           device="cuda")
    planes = ell_ops.gather_planes(A, ell, "bfloat16")
    Bsum = objective.make_bsum(A, data.n_users, 0.0)
    del A
    n = ell.n_rows_ell
    true_rows = ell.row_nnz_perm > 0
    x = initialize_factors(n, n, K, rng, device="cuda")
    x[~true_rows] = 0.0
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    d = torch.randn((n, K), generator=g, device="cuda") * 0.05
    alpha0 = 0.5 + torch.rand(n, generator=g, device="cuda")
    # rows poisoned on purpose: 64 true rows spread over all buckets
    idx = torch.nonzero(true_rows)[:, 0]
    poison = torch.zeros(n, dtype=torch.bool, device="cuda")
    poison[idx[:: max(1, idx.numel() // 64)]] = True
    l2, args = LS_L2, (LS_L2, 1.0, False)

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    # 1. f_ell = fg_ell's f, rows with a zero factor vector at +inf
    x1 = torch.where(poison[:, None], 0.0, x)
    f1 = ell_ops.f_ell(x1, planes, ell, Bsum, l2)
    fg1 = ell_ops.fg_ell(x1, planes, ell, Bsum, l2, want_px=False)[0]
    err1 = compare(torch, "f_ell vs fg_ell", f1, fg1, rows=poison)
    check(bool(torch.isposinf(f1[poison]).all()),
          "f_ell: a zero factor vector did not give +inf")
    # 2. hoisted bd planes = <B, d> from the same plane read, at a trial
    # with the poisoned rows at zero (g.d ratios ~x / 1e-30)
    t = torch.where(poison[:, None], 0.0,
                    torch.clamp_min(x + 0.5 * alpha0[:, None] * d, 0.0))
    bds = ell_ops.bdot_ell(d, planes, ell)
    h = ell_ops.f_gtd_ell(t, d, bds, planes, ell, Bsum, *args)
    fu = ell_ops.f_gtd_fused_ell(t, d, planes, ell, Bsum, *args)
    err2 = max(compare(torch, f"f_gtd_ell vs f_gtd_fused_ell {n_}", a, b,
                       rows=poison)
               for n_, a, b in zip(("f", "gtd"), h, fu))
    # 3. the one-step ray = the multi-candidate ray at C = 1, from x's
    # prediction planes; the poisoned rows step 1e3 times farther
    pxs = ell_ops.fg_ell(x, planes, ell, Bsum, l2)[2]
    coef = objective.ray_coef(x, d, Bsum)
    alpha = torch.where(poison, 1e3 * alpha0, alpha0)
    r1 = ell_ops.f_gtd_ray_ell(alpha, coef, pxs, bds, ell, *args)
    rm = ell_ops.f_gtd_ray_multi_ell(alpha[None], coef, pxs, bds, ell,
                                     *args)
    err3 = max(compare(torch, f"f_gtd_ray_ell vs f_gtd_ray_multi_ell {n_}",
                       a, b[0], rows=poison)
               for n_, a, b in zip(("f", "gtd"), r1, rm))
    n_ray_poison = int((~torch.isfinite(r1[0])).sum())
    # 4. the projected multi-candidate trials = the fused evaluation at
    # each projected trial, on every true row; d = -2x on the poisoned
    # rows projects their trials to zero from a step of 0.5 on
    d_m = torch.where(poison[:, None], -2.0 * x, d)
    alphas = torch.stack([s * alpha0 for s in LS_STEPS])
    mf, mg = ell_ops.f_gtd_multi_ell(alphas, x, d_m, planes, ell, Bsum,
                                     *args)
    err4 = 0.0
    for c in range(len(LS_STEPS)):
        trial = torch.clamp_min(x + alphas[c][:, None] * d_m, 0.0)
        sf, sg = ell_ops.f_gtd_fused_ell(trial, d_m, planes, ell, Bsum,
                                         *args)
        for n_, a, b in (("f", mf[c], sf), ("gtd", mg[c], sg)):
            err4 = max(err4, compare(
                torch, f"f_gtd_multi_ell[{c}] vs f_gtd_fused_ell {n_}",
                a[true_rows], b[true_rows], rows=poison[true_rows]))
    check(bool(torch.isposinf(mf[2:, poison]).all()),
          "f_gtd_multi_ell: a trial projected to zero did not give +inf")
    torch.cuda.synchronize()
    phase_s = time.perf_counter() - t0
    counts = dict(kernels.launch_counts)
    mixed = [b for b in ell.buckets if b.src is not None]
    n_mixed = int(sum(int((ell_ops._self_mask(b)
                           & true_rows[b.offset:b.offset + b.n_rows]).sum())
                      for b in mixed))
    log(f"# line-search evaluators, item side ({len(ell.buckets)} buckets, "
        f"{int(true_rows.sum())} true rows, {n_mixed} of them primary rows "
        f"of {len(mixed)} buckets holding extension chunks), k={K}, bf16 "
        f"planes: {phase_s:.2f} s; max abs err f_ell {err1:.3e}, f_gtd "
        f"{err2:.3e}, ray {err3:.3e}, multi {err4:.3e}; "
        f"{int(poison.sum())} poisoned rows, {n_ray_poison} poisoned ray "
        f"rows")
    log(f"# kernel launches in the line-search phase: {counts}")
    for name in LINE_SEARCH_KERNELS:
        check(counts[name] > 0,
              f"kernel {name} never launched in the line-search phase")
        results[name]["launches"] = counts[name]
    # whole evaluators over all buckets (kernels, assembly, linear terms)
    for label, fn in (
            ("f_ell", lambda: ell_ops.f_ell(x, planes, ell, Bsum, l2)),
            ("fg_ell", lambda: ell_ops.fg_ell(x, planes, ell, Bsum, l2,
                                              want_px=False)),
            ("f_gtd_ell", lambda: ell_ops.f_gtd_ell(t, d, bds, planes, ell,
                                                    Bsum, *args)),
            ("f_gtd_fused_ell", lambda: ell_ops.f_gtd_fused_ell(
                t, d, planes, ell, Bsum, *args)),
            ("f_gtd_ray_ell", lambda: ell_ops.f_gtd_ray_ell(
                alpha0, coef, pxs, bds, ell, *args)),
            ("f_gtd_ray_multi_ell C=4", lambda: ell_ops.f_gtd_ray_multi_ell(
                alphas, coef, pxs, bds, ell, *args)),
            ("f_gtd_multi_ell C=4", lambda: ell_ops.f_gtd_multi_ell(
                alphas, x, d_m, planes, ell, Bsum, *args))):
        log(f"# {label:24s} whole item side: {time_ms(torch, fn):.3f} ms")
    del planes, pxs, bds
    torch.cuda.empty_cache()


def counting_ray_rounds(fit):
    """(fit(), the ray line-search rounds it took): the calls of
    ``ell.f_ray_multi_ell``, one a round and side of the cg ray search,
    counted on the card and on the CPU alike."""
    from poismf_torch.ops import ell as ell_ops

    real, calls = ell_ops.f_ray_multi_ell, [0]

    def counted(*args, **kw):
        calls[0] += 1
        return real(*args, **kw)

    ell_ops.f_ray_multi_ell = counted
    try:
        return fit(), calls[0]
    finally:
        ell_ops.f_ray_multi_ell = real


def small_fit_phase(torch):
    """Phase 5: one small problem fitted on the card and on the CPU, by
    each method (cg by both line searches)."""
    from poismf_torch import PoisMF
    from poismf_torch.utils.data import synth_lastfm_like

    rng = np.random.default_rng(SEED + 2)
    rows, cols, vals = synth_lastfm_like(rng, 3000, 1500, 60_000)
    X = (rows, cols, vals, (3000, 1500))
    for label, kw in (("tncg", dict(method="tncg", niter=2)),
                      ("cg ray", dict(method="cg", niter=2)),
                      ("cg fused", dict(method="cg", niter=2,
                                        limit_step=False)),
                      ("pg", dict(method="pg", niter=3))):
        kw = dict(k=8, plane_dtype="bfloat16", random_state=SEED, **kw)
        m_gpu, n_gpu = counting_ray_rounds(
            lambda: PoisMF(device="cuda", **kw).fit(X))
        m_cpu, n_cpu = counting_ray_rounds(
            lambda: PoisMF(device="cpu", **kw).fit(X))
        l_gpu, l_cpu = m_gpu.eval_llk(), m_cpu.eval_llk()
        rel = abs(l_gpu - l_cpu) / abs(l_cpu)
        dz_a = abs((m_gpu.A == 0).mean() - (m_cpu.A == 0).mean())
        dz_b = abs((m_gpu.B == 0).mean() - (m_cpu.B == 0).mean())
        log(f"# small {label} fit 3000x1500, 60k nnz, k=8: LL cuda "
            f"{l_gpu:.6e} cpu {l_cpu:.6e} (rel {rel:.2e}); zero share "
            f"diff A {dz_a:.4f} B {dz_b:.4f}; ray rounds cuda {n_gpu} cpu "
            f"{n_cpu}")
        check(np.isfinite(l_gpu) and rel <= 1e-2,
              f"small {label} fit LL differs between cuda and cpu by "
              f"{rel:.3e}")
        check(dz_a <= 0.02 and dz_b <= 0.02,
              f"small {label} fit sparsity differs")


def topn_matches(torch, A, B, user, ids, n):
    """ids equal to a CPU torch.topk of the same factors, up to ties."""
    scores = B @ A[user]
    ref_vals, ref_ids = torch.topk(scores, n)
    if np.array_equal(ref_ids.numpy(), ids):
        return True
    got = scores[torch.as_tensor(ids)]
    return torch.allclose(got, ref_vals, rtol=1e-5, atol=0.0)


def cpu_reference_check(X, kw, model, ll1, ll1_obs):
    """The same full-scale fit (data, configuration, seed) on the CPU,
    through the plain versions: the card's train LL must land within
    CPU_REFERENCE_RTOL of it, and its exact-zero shares within 0.02."""
    from poismf_torch import PoisMF

    t0 = time.perf_counter()
    ref = PoisMF(random_state=SEED, device="cpu", **kw).fit(X)
    cpu_s = time.perf_counter() - t0
    ll_ref, ll_ref_obs = ref.eval_llk(include_missing=True), ref.eval_llk()
    rel = abs(ll1 - ll_ref) / abs(ll_ref)
    rel_obs = abs(ll1_obs - ll_ref_obs) / abs(ll_ref_obs)
    dz_a = abs((model.A == 0).mean() - (ref.A == 0).mean())
    dz_b = abs((model.B == 0).mean() - (ref.B == 0).mean())
    log(f"# {kw['method']} same fit on the CPU (plain versions, "
        f"{cpu_s:.2f} s): train LL (all pairs) {ll_ref:.6e}, rel diff to "
        f"the card {rel:.3e}; over the nonzeros {ll_ref_obs:.6e}, rel diff "
        f"{rel_obs:.3e}; zero share diff A {dz_a:.4f} B {dz_b:.4f}")
    check(np.isfinite(ll_ref) and max(rel, rel_obs) <= CPU_REFERENCE_RTOL,
          f"{kw['method']}: train LL differs from the CPU fit by "
          f"{max(rel, rel_obs):.3e}")
    check(dz_a <= 0.02 and dz_b <= 0.02,
          f"{kw['method']}: sparsity differs from the CPU fit")


def main_path_phase(torch, X, data, results, path):
    """Phase 6: one of the port's main paths (``PATHS``), through its
    public entry points, with the launch counts read around it alone."""
    from poismf_torch import PoisMF, kernels
    from poismf_torch.ops import objective
    from poismf_torch.train import initialize_factors

    kw, expected = PATHS[path]
    k = kw["k"]
    rng = np.random.default_rng(SEED)
    A0 = initialize_factors(data.n_users, data.by_user.n_rows_pad, k, rng,
                            device="cuda")
    B0 = initialize_factors(data.n_items, data.by_item.n_rows_pad, k, rng,
                            device="cuda")
    # the full Poisson LL (every user-item pair's -pred included) is what
    # the fit improves; the LL over the observed entries alone is printed
    # beside it, as the JAX bench reports it
    ll0 = float(objective.eval_llk(A0, B0, data.by_user,
                                   include_missing=True))
    ll0_obs = float(objective.eval_llk(A0, B0, data.by_user))
    # what the fit minimizes: the negative LL plus the l2 penalty
    l2 = kw["l2_reg"]
    obj0 = -ll0 + l2 * float((A0 * A0).sum() + (B0 * B0).sum())
    del A0, B0

    model = PoisMF(random_state=SEED, device="cuda", **kw)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    model.fit(X)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    if path == "tncg":
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
    check(A.shape == (data.n_users, k) and B.shape == (data.n_items, k),
          f"{path}: factor shapes")
    check(np.isfinite(A).all() and np.isfinite(B).all(),
          f"{path}: non-finite factors")
    check((A >= 0).all() and (B >= 0).all(), f"{path}: negative factors")
    ll1 = model.eval_llk(include_missing=True)
    ll1_obs = model.eval_llk()
    obj1 = -ll1 + l2 * float((A.astype(np.float64) ** 2).sum()
                             + (B.astype(np.float64) ** 2).sum())
    log(f"# main path {path} {kw}: fit {fit_s:.2f} s (ingest and ELL "
        f"build included), peak device memory {peak_gb:.2f} GB")
    log(f"# {path} train LL (all pairs) init {ll0:.6e} -> fitted "
        f"{ll1:.6e}; over the nonzeros {ll0_obs:.6e} -> {ll1_obs:.6e}; "
        f"-LL + l2 penalty {obj0:.6e} -> {obj1:.6e}; exact zeros "
        f"A {(A == 0).mean():.4f} B {(B == 0).mean():.4f}")
    log(f"# kernel launches in the {path} path: {counts}")
    check(np.isfinite(ll1) and np.isfinite(ll1_obs) and obj1 < obj0,
          f"{path}: the fit's objective did not improve")
    # pg at its published l2=1e9 shrinks the factors toward zero and
    # lowers the LL; the other methods must raise it
    check(path == "pg" or ll1 > ll0, f"{path}: train LL did not improve")
    for name in expected:
        check(counts[name] > 0,
              f"kernel {name} never launched in the {path} path")
        results[name]["launches"] = counts[name]
    if path in CPU_REFERENCE:
        cpu_reference_check(X, kw, model, ll1, ll1_obs)
    if path != "tncg":
        return model, None
    log(f"# topN_batched 1024 users: {batched_s * 1e3:.2f} ms "
        f"({1024 / batched_s:.0f} queries/s, first call)")
    At, Bt = torch.from_numpy(A), torch.from_numpy(B)
    for u, ids in zip(users, top):
        check(topn_matches(torch, At, Bt, int(u), ids, 10),
              f"topN of user {u} differs from a CPU topk")
    for row in range(8):
        check(topn_matches(torch, At, Bt, int(q[row]), top_b[row], 10),
              f"topN_batched row {row} differs from a CPU topk")
    return model, q


def serving_objective(torch, A, B, Bsum, X, l2, magnitude=False):
    """Per row of the CSR ``X``: -sum_i x_i log(<a, B_i>) + <Bsum, a> +
    l2 |a|^2 (the serving solves' objective, l2 in f), in float64 on the
    CPU; ``A`` [n, k] and ``B``, ``Bsum`` as tensors or arrays.  With
    ``magnitude``, also the sum of its terms' absolute values per row."""
    A = torch.as_tensor(A).double().cpu()
    B = torch.as_tensor(B).double().cpu()
    coo = X.tocoo()
    r = torch.from_numpy(coo.row.astype(np.int64))
    c = torch.from_numpy(coo.col.astype(np.int64))
    pred = (A[r] * B[c]).sum(1)
    terms = -torch.from_numpy(coo.data).double() * torch.log(pred)
    nll = torch.zeros(A.shape[0], dtype=torch.float64)
    nll.index_add_(0, r, terms)
    bsum = torch.as_tensor(Bsum).double().cpu()
    lin = A @ bsum + l2 * (A * A).sum(1)
    if not magnitude:
        return nll + lin
    mag = torch.zeros(A.shape[0], dtype=torch.float64)
    mag.index_add_(0, r, terms.abs())
    return nll + lin, mag + (A @ bsum).abs() + l2 * (A * A).sum(1)


def agree_on_cpu(torch, what, f_card, f_cpu, rtol):
    """The card's serving objectives ``f_card`` (per row) against the same
    solve's ``f_cpu`` through the plain versions: the sums within
    ``rtol`` relative."""
    rel = abs(float(f_card.sum() - f_cpu.sum())) / abs(float(f_cpu.sum()))
    gap = (f_card - f_cpu).abs()
    worst = int(gap.argmax())
    log(f"# {what}: summed objective card {float(f_card.sum()):.9e} cpu "
        f"{float(f_cpu.sum()):.9e}, rel {rel:.3e} (limit {rtol:.2e}); "
        f"largest per-row gap {float(gap[worst]):.3e} (row {worst}, "
        f"{float(gap[worst] / f_cpu[worst].abs()):.3e} relative)")
    check(rel <= rtol, f"{what}: card and CPU objectives differ by "
          f"{rel:.3e}")


def serving_kernels(torch, tag, B, X, A, path, plane_dtype, results):
    """The kernels of ``path``'s serving solve held to their plain versions
    on the solve's own inputs: the planar ELL of the new rows ``X`` (a
    CountsMatrix), the planes of the card's ``B`` in ``plane_dtype`` and
    the solved factors ``A`` [n, k] (rows in ``X``'s order), each bucket
    in turn; for hvp a direction of random entries, for raygtd and rayf
    its <B_i, d> plane and four small steps.  Tolerance as in the kernel
    phase; the errors go into the kernels' results.  At solved factors
    some predictions are small, and outputs such as fgh's x / pred^2
    weights large: each error is also printed relative to the largest
    value of its output."""
    from poismf_torch import kernels
    from poismf_torch.ops import ell as ell_ops

    ell = ell_ops.ell_from_counts(X, device=B.device)
    planes = ell_ops.gather_planes(B, ell, ell_ops.torch_dtype(plane_dtype))
    A = torch.as_tensor(A).to(B.device, torch.float32)
    A_perm = ell_ops.permute_rows(A, ell.perm)
    g = torch.Generator(device=B.device).manual_seed(SEED)
    errs = dict.fromkeys(SERVE_KERNELS[path], 0.0)
    rels = dict(errs)
    for b, bg in zip(ell.buckets, planes):
        vals = b.vals.float().contiguous()
        a_t = ell_ops._bucket_x(A_perm, b).t().contiguous()
        v_t = torch.randn(a_t.shape, generator=g, device=B.device) * 0.1
        pd = (bg.float() * v_t[:, None, :]).sum(0)
        steps = torch.tensor([1e-3, 3e-3, 1e-2, 3e-2], device=B.device)
        al = steps[:, None].expand(4, b.n_rows).contiguous()
        pairs = {}
        if path == "tncg":
            ref = kernels.fgh_bucket_torch(bg, vals, a_t, 1.0, True)
            w2, px = ref[3], ref[4]
            pairs["fgh"] = (kernels.fgh_bucket(bg, vals, a_t), ref)
            pairs["hvp"] = (kernels.hvp_bucket(bg, w2, v_t)[:1],
                            kernels.hvp_bucket_torch(bg, w2, v_t)[:1])
            pairs["raygtd"] = (
                kernels.raygtd_multi_bucket(px, pd, vals, al),
                kernels.raygtd_multi_bucket_torch(px, pd, vals, al))
        elif path == "cg":
            ref = kernels.fg_bucket_torch(bg, vals, a_t, True)
            px = ref[2]
            pairs["fg"] = (kernels.fg_bucket(bg, vals, a_t), ref)
            pairs["rayf"] = (
                (kernels.rayf_multi_bucket(px, pd, vals, al),),
                (kernels.rayf_multi_bucket_torch(px, pd, vals, al),))
        else:
            pairs["pg"] = ((kernels.pg_bucket(bg, vals, a_t),),
                           (kernels.pg_bucket_torch(bg, vals, a_t),))
        for name, (out, ref) in pairs.items():
            for o, r in zip(out, ref):
                err = compare(torch, f"{name} {tag} P={b.P} R={b.n_rows}",
                              o, r)
                fin = r[torch.isfinite(r)].abs()
                top = float(fin.max()) if fin.numel() else 0.0
                errs[name] = max(errs[name], err)
                rels[name] = max(rels[name], err / top if top else 0.0)
    for name, err in errs.items():
        r = results.setdefault(name, dict(max_abs_err=0.0))
        r["max_abs_err"] = max(r["max_abs_err"], err)
    log(f"# {tag}: the serving kernels against their plain versions on its "
        f"ELL ({', '.join(f'P={b.P} x R={b.n_rows}' for b in ell.buckets)}, "
        f"{str(planes[0].dtype)[6:]} planes): max abs err "
        + ", ".join(f"{n} {e:.3e} ({rels[n]:.1e} of the output's largest "
                    "value)" for n, e in errs.items()))


def topn_excl_matches(torch, scores, seen, ids, n):
    """ids equal to a CPU torch.topk of ``scores`` with the items ``seen``
    masked, up to ties; none of them seen."""
    if set(ids.tolist()) & set(seen.tolist()):
        return False
    masked = scores.clone()
    masked[torch.as_tensor(seen, dtype=torch.int64)] = -torch.inf
    ref_vals, ref_ids = torch.topk(masked, n)
    if np.array_equal(ref_ids.numpy(), ids):
        return True
    return torch.allclose(scores[torch.as_tensor(ids)], ref_vals, rtol=1e-5,
                          atol=0.0)


def serving_phase(torch, model, path, X_new, data, q, results):
    """Phase 7: serving from one of phase 6's fitted models; the
    serving kernels' errors go into ``results``."""
    from poismf_torch import kernels, serve
    from poismf_torch.sparse import build_counts, csr_like

    p = model._params()
    n_new, k = X_new.shape[0], p.k
    B, Bsum, Amean = model.B, model.Bsum, model.Amean
    reuse = model.reuse_prev or model.method != "tncg"

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    A_new = model.transform(X_new)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    counts = dict(kernels.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(A_new.shape == (n_new, k), f"{path} transform: shape")
    check(np.isfinite(A_new).all() and (A_new >= 0).all(),
          f"{path} transform: non-finite or negative factors")
    f_new = serving_objective(torch, A_new, B, Bsum, X_new, p.l2_reg)
    init = (Amean.cpu().double() if reuse
            else torch.full((k,), 1e-3, dtype=torch.float64))
    f_init = serving_objective(torch, init.expand(n_new, k), B, Bsum, X_new,
                               p.l2_reg)
    rise = (f_new - f_init) / f_init.abs().clamp_min(1e-30)
    n_rose = int((f_new > f_init).sum())
    log(f"# serving {path}: transform of {n_new} new users "
        f"({X_new.nnz} nonzeros) {solve_s:.2f} s, {n_new / solve_s:.0f} "
        f"rows/s, peak device memory {peak_gb:.2f} GB; serving objective "
        f"summed {float(f_init.sum()):.6e} at the init -> "
        f"{float(f_new.sum()):.6e}; rows above their init: {n_rose} (worst "
        f"relative rise {float(rise.max()):.3e}); exact zeros "
        f"{(A_new == 0).mean():.4f}")
    log(f"# kernel launches in the {path} transform: {counts}")
    check(bool((rise <= SERVE_INIT_RTOL).all()),
          f"{path} transform: a row's objective rose above its init by "
          f"{float(rise.max()):.3e}")
    for name in SERVE_KERNELS[path]:
        check(counts[name] > 0,
              f"kernel {name} never launched in the {path} transform")
    coo = X_new.tocoo()
    serving_kernels(torch, f"serving {path} transform", model._B,
                    build_counts(coo.row, coo.col, coo.data, n_new,
                                 X_new.shape[1]),
                    A_new, path, p.plane_dtype, results)
    # the same solve of the first 512 users through the plain versions on
    # the CPU, from the card's B, Bsum and Amean, on planes in the dtype
    # the whole batch had
    sub = X_new[:SERVE_CPU_USERS].tocoo()
    X_sub = build_counts(sub.row, sub.col, sub.data, SERVE_CPU_USERS,
                         X_new.shape[1])
    threshold = serve.ELL_SERVE_NNZ_THRESHOLD
    if X_new.nnz > threshold:
        serve.ELL_SERVE_NNZ_THRESHOLD = 0
    cpu_args = (model._B.cpu(), Bsum.cpu(), Amean.cpu(), X_sub)
    try:
        t0 = time.perf_counter()
        A_cpu = serve.factors_multiple(*cpu_args, p, reuse_mean=reuse)
        cpu_s = time.perf_counter() - t0
        if path == "cg":
            # cg's 15 iterations do not converge, and their result follows
            # rounding: the same 512 users run to convergence on both
            p_conv = dataclasses.replace(p, maxupd=SERVE_CG_CONVERGED_MAXUPD)
            A_conv = serve.factors_multiple(model._B, Bsum, Amean, X_sub,
                                            p_conv, reuse_mean=reuse).cpu()
            A_conv_cpu = serve.factors_multiple(*cpu_args, p_conv,
                                                reuse_mean=reuse)
    finally:
        serve.ELL_SERVE_NNZ_THRESHOLD = threshold
    f_sub = [serving_objective(torch, A[:SERVE_CPU_USERS], B, Bsum,
                               X_new[:SERVE_CPU_USERS], p.l2_reg)
             for A in ((A_cpu, A_conv, A_conv_cpu) if path == "cg"
                       else (A_cpu,))]
    agree_on_cpu(torch, f"serving {path}: {SERVE_CPU_USERS} of the new "
                 f"users on the CPU (plain versions, {cpu_s:.2f} s)",
                 f_new[:SERVE_CPU_USERS], f_sub[0], SERVE_CPU_RTOL[path])
    if path == "cg":
        agree_on_cpu(torch, f"serving cg: the same {SERVE_CPU_USERS} users "
                     f"run to convergence ({p_conv.maxupd * p.niter} "
                     "iterations) on the card and on the CPU", f_sub[1],
                     f_sub[2], SERVE_CPU_RTOL["cg converged"])
    if path != "tncg":
        return

    # predict_factors / topN_new for 8 single users: 7 of the new batch,
    # and the training user with the most items (extension chunks)
    indptr, indices, vals = csr_like(data.by_user)
    u_long = int(np.argmax(np.diff(indptr)))
    n_long = int(indptr[u_long + 1] - indptr[u_long])
    check(n_long > 2048, f"no training user beyond P_MAX: {n_long} items")
    rows_new = [r for r in range(n_new) if X_new.indptr[r + 1]
                > X_new.indptr[r]][:7]
    singles = [(f"new user {r}",
                X_new.indices[X_new.indptr[r]:X_new.indptr[r + 1]],
                X_new.data[X_new.indptr[r]:X_new.indptr[r + 1]])
               for r in rows_new]
    singles.append((f"training user {u_long}",
                    indices[indptr[u_long]:indptr[u_long + 1]],
                    vals[indptr[u_long]:indptr[u_long + 1]]))
    Bt = torch.from_numpy(B)
    kernels.reset_launch_counts()
    secs, solved = [], []
    for label, items, cnt in singles:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a = model.predict_factors((items, cnt))
        secs.append(time.perf_counter() - t0)
        ids = model.topN_new((items, cnt), n=10)
        check(np.isfinite(a).all() and (a >= 0).all() and a.max() > 0,
              f"predict_factors of {label}: bad factors")
        scores = Bt @ torch.from_numpy(a)
        ref_vals, ref_ids = torch.topk(scores, 10)
        check(np.array_equal(ref_ids.numpy(), ids) or torch.allclose(
            scores[torch.as_tensor(ids)], ref_vals, rtol=1e-5, atol=0.0),
            f"topN_new of {label} differs from a CPU topk")
        f1 = serving_objective(torch, a[None], B, Bsum, _one_row(items, cnt,
                                                                 B.shape[0]),
                               p.l2_reg)
        log(f"# predict_factors {label} ({len(items)} items): "
            f"{secs[-1]:.3f} s, serving objective {float(f1[0]):.6e}; "
            f"topN_new equals a CPU topk")
        solved.append((label, items, cnt, f1, a))
    counts = dict(kernels.launch_counts)
    # the first new user and the long training user solved again through
    # the plain versions on the CPU, as predict_factors calls the solve
    for label, items, cnt, f1, a in (solved[0], solved[-1]):
        ix, c = model._process_data_single((items, cnt))
        serving_kernels(torch, f"predict_factors {label}", model._B,
                        build_counts(np.zeros_like(ix), ix, c, 1,
                                     model.nitems), a[None], "tncg", None,
                        results)
        t0 = time.perf_counter()
        a_cpu = serve.factors_single(
            model._B.cpu(), Bsum.cpu(), Amean.cpu(), ix, c, l2_reg=p.l2_reg,
            l1_new=p.l1_reg, l1_old=p.l1_reg, w_mult=p.w_mult,
            maxupd=max(1000, p.maxupd), reuse_mean=model.reuse_prev,
            n_items=model.nitems)
        cpu_s = time.perf_counter() - t0
        f_cpu, mag = serving_objective(torch, a_cpu[None], B, Bsum,
                                       _one_row(items, cnt, B.shape[0]),
                                       p.l2_reg, magnitude=True)
        gap = abs(float(f1[0] - f_cpu[0])) / (F32_EPS * float(mag[0]))
        agree_on_cpu(torch, f"predict_factors {label} on the CPU (plain "
                     f"versions, {cpu_s:.2f} s; gap {gap:.2f} float32 "
                     f"epsilons of the row's terms, limit "
                     f"{SERVE_SINGLE_ROUNDINGS})", f1, f_cpu,
                     SERVE_SINGLE_ROUNDINGS * F32_EPS * float(mag[0])
                     / abs(float(f_cpu[0])))
    log(f"# predict_factors: {np.mean(secs):.3f} s a user (median "
        f"{np.median(secs):.3f}, 8 users, each then topN_new); kernel "
        f"launches: {counts}")
    for name in SERVE_KERNELS["tncg"]:
        check(counts[name] > 0,
              f"kernel {name} never launched in predict_factors")

    # exclude_seen for phase 6's 1,024 users
    kernels.reset_launch_counts()
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        top_x = model.topN_batched(q, n=10, exclude_seen=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    At = torch.from_numpy(model.A)
    for lo in range(0, q.shape[0], 256):
        scores = At[torch.as_tensor(q[lo:lo + 256])] @ Bt.t()
        for j in range(scores.shape[0]):
            u = int(q[lo + j])
            check(topn_excl_matches(torch, scores[j],
                                    indices[indptr[u]:indptr[u + 1]],
                                    top_x[lo + j], 10),
                  f"topN_batched(exclude_seen) of user {u} differs from a "
                  "CPU topk with the training items masked")
    log(f"# topN_batched(exclude_seen=True) {q.shape[0]} users: first call "
        f"{times[0] * 1e3:.2f} ms (host CSR of the training data built), "
        f"second {times[1] * 1e3:.2f} ms ({q.shape[0] / times[1]:.0f} "
        f"queries/s); equal to a CPU topk with the training items masked, "
        f"no training item returned")


def _one_row(items, counts, n_items):
    import scipy.sparse as sp

    return sp.csr_matrix((counts, (np.zeros(len(items), np.int64), items)),
                         shape=(1, n_items))


def serving_data(n_items):
    """The serving phase's new users: SERVE_USERS rows of the synthetic
    generator at the training density, as a SciPy CSR."""
    import scipy.sparse as sp

    from poismf_torch.utils.data import synth_lastfm_like

    rows, cols, vals = synth_lastfm_like(np.random.default_rng(SEED + 1),
                                         n_users=SERVE_USERS,
                                         n_items=n_items, nnz=SERVE_NNZ)
    X_new = sp.csr_matrix((vals, (rows, cols)),
                          shape=(SERVE_USERS, n_items))
    log(f"# serving data: {SERVE_USERS} new users x {n_items} items, "
        f"{X_new.nnz} nonzeros, "
        f"{int((np.diff(X_new.indptr) == 0).sum())} users without items")
    return X_new


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
        if any(w in line for w in ("Function properties", "registers",
                                   "spill")):
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
    ell = kernel_phase(torch, data, results)
    line_search_phase(torch, data, ell, results)
    del ell
    small_fit_phase(torch)
    X_new = serving_data(n_items)
    for path in PATHS:
        model, q = main_path_phase(torch, X, data, results, path)
        serving_phase(torch, model, path, X_new, data, q, results)
        del model
        torch.cuda.empty_cache()

    # no single PyTorch call computes any of these functions: library_ms
    # stays null
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by")
    line = {"kernels": [
        dict(name=name, route="cuda", source=src, replaces=rep,
             **{key: results[name][key] for key in keys}, library_ms=None)
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
