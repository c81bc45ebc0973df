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
   Each path is then fitted a second time, launch counts set to 0 just
   before and read just after: A and B must be SHA-256-equal to the first
   fit's and the launch counts equal (card fits repeat bit for bit).
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
   - ``transform`` of the first new users holding at most
     ``serve.ELL_SERVE_NNZ_THRESHOLD`` nonzeros by each model: the
     flat-COO serving solve, which launches no sweep kernel, each
     row no higher than at its init, the summed objective within
     ``SERVE_CPU_RTOL`` of the same solve on the CPU;
   - tncg: ``predict_factors`` / ``topN_new`` for 8 single users (7 of
     the new batch and the training user with the most items), solved
     by the flat-COO tncg (no sweep kernel launched), top-N
     checked against a CPU ``torch.topk``; the first and the last of
     them solved again on the CPU, each within
     ``SERVE_SINGLE_ROUNDINGS`` float32 epsilons of its objective's
     terms; ``topN_batched(exclude_seen=True)``
     for phase 6's 1,024 users, checked against a CPU ``torch.topk`` with
     each user's training items masked; ``predict`` over all 17.16M
     training pairs (streamed ``PREDICT_CHUNK`` pairs at a time), its
     seconds and peak device memory printed, finite, and a sample of
     PREDICT_SAMPLE pairs within PREDICT_RTOL of a CPU float64 dot
     product.
8. Row-sharded training (``poismf_torch.parallel``):
   a. ``shard_ell`` of both orientations in MESH_SHARDS shards (the
      layout a 2-GPU fit would run on): on each shard its largest and
      smallest bucket, and every bucket of padding rows alone, the
      training kernels (the plane sweeps and the ray kernels, as in
      phase 3, bf16 planes of the whole fixed side) against their plain
      versions;
   b. on a one-rank NCCL mesh (``init_device_mesh("cuda", (1,))``; the
      machine has one GPU), each main path of phase 6 through
      ``PoisMF(mesh=...)``, the launch and collective counts set to 0
      just before each fit and read just after: its kernels launched,
      its train LL within MESH_LL_RTOL and its exact-zero shares within
      MESH_ZERO_TOL of phase 6's fit of the same path, top-N equal to a
      CPU ``torch.topk``; prints the fit seconds, peak device memory and
      the counts of collectives; then cg and pg again with
      ``layout="coo"`` (the flat-COO row-sharded driver), no hand-written
      kernel launched, each within MESH_LL_RTOL of phase 10's one-GPU
      COO fit of the same path.
9. The port's entry points (``poismf_torch.entry``): ``entry()`` on the
   card, one tncg half-update of the user factors on the tiny problem
   (64 x 48, k=8), launch counts set to 0 just before and read just
   after, its kernels launched, held to ``entry(device="cpu")`` within
   rtol 1e-2; then ``dryrun_multichip(torch.cuda.device_count(),
   device="cuda")``: NCCL ranks, one a GPU, fit the tiny problem
   row-sharded by every method and each is held to a single-process fit
   (train LL bands ``entry.CASES``: pg 1e-5, cg 1e-1, tncg 5e-2) and to
   bitwise-equal factors on every rank.
10. The flat-COO layout (run after phase 7, before phase 8, whose mesh
   COO fits it anchors): each main path of phase 6 again through
   ``PoisMF(layout="coo", device="cuda")``, the same data and seed, its
   published configuration (tncg with ``max_cg`` resolving to the
   reference's 25), fitted twice, the launch counts set to 0 just before
   each fit and read just after: no sweep kernel launched (the
   fit did not drift onto the ELL), SHA-256-equal A and B, factors
   finite and >= 0, the objective below its init; cg within COO_LL_RTOL
   train LL and COO_ZERO_TOL exact-zero shares of phase 6's ELL fit, pg
   within CPU_REFERENCE_RTOL of the same COO fit on the CPU; tncg fitted
   a third time through ``fit_unsafe`` from the ELL fit's effective start
   (the same initial factors, the rows without nonzeros zeroed: the COO
   driver, as the JAX package's, sums their initial values into the
   first half's Bsum, which the ELL driver leaves out), that fit within
   the band of the ELL fit, and the first fit's gap to both printed;
   cg once more with ``nnz_chunk`` (the largest divisor of the padded
   nnz that makes at least COO_MIN_CHUNKS chunks), in the same band,
   its peak device memory beside the unchunked fit's.  Prints each fit's
   seconds and peak device memory, and one line setting each path's COO
   wall beside its ELL wall (phase 6, this process).
11. float64 on the card (run after phase 10, before phase 8, whose mesh
   fits it anchors), ``use_float=False`` along the JAX package's x64
   routes: the plane kernels on float32 casts beside bf16 planes, the
   plain versions in float64 for the ray searches (float64 px) and for
   float64 planes.  Launch counts are set to 0 just before each fit or
   call and read just after:
   a. phase 5's fits with ``use_float=False``, ``plane_dtype="bfloat16"``
      and None, on the card and on the CPU: bf16 planes within phase 5's
      band, float64 planes within ``F64_SMALL``'s; bf16 runs launch
      their plane kernels and no ray kernel, float64 planes none;
   b. each main path of phase 6, its configuration with
      ``use_float=False``: float64 factors, finite and >= 0, the train LL
      within F64_LL_RTOL of phase 6's float32 fit, and for
      F64_ZERO_PATHS the exact-zero shares within F64_ZERO_TOL of it (tncg
      snaps to zero within 10 epsilons of its dtype: its shares are
      printed); its plane kernels launched and no ray kernel; pg
      fitted twice (SHA-256-equal, equal launches) and held to the same
      float64 fit on the CPU as phase 6 holds its own;
   c. F64_PLAIN_PATHS float64 end to end (``plane_dtype=None``) on the
      ELL and on the COO: no hand-written kernel launched, the COO within
      phase 10's band of the ELL; each fit's seconds and peak GB beside
      (b)'s and phase 6's;
   d. serving from (b)'s tncg model: ``transform`` of phase 7's 16,384
      new users (the ELL route: fgh and hvp launched, no ray kernel; 512
      again on the CPU), the first 1,859 (the COO route, no kernel), 8
      ``predict_factors`` / ``topN_new`` users (the first and the last
      again on the CPU), ``topN_batched(exclude_seen=True)`` for phase
      6's 1,024 users, ``predict`` over the training pairs and
      ``eval_llk``, each held to the CPU within ``F64_SERVE_RTOL``;
   e. ``save``, then ``PoisMF.load`` with its default device: the
      loaded model's ``transform`` bitwise equal to (d)'s;
   f. (in phase 8b) F64_MESH_PATHS of (b) on the one-rank NCCL mesh,
      held to (b)'s fits (pg: the same LL).
   Prints the phase's seconds.
12. The tncg cascade past its first epoch (run after phase 11, before
   phase 8): the published tncg configuration (phase 6's) at
   CASCADE_NITER epochs, the launch counts set to 0 just before each fit
   and read just after, ``train.CASCADE_TRACE`` kept:
   a. the first fit's cascade, half by half: each round's structure and
      plan denominator (0: a profile plan), its active rows in and out,
      the profile plans in use by size class with their caps, and the
      full-structure rounds on tails of at most half the rows;
   b. the same fit again: SHA-256-equal A and B, equal launches;
   c. the same fit with ``POISMF_ADAPTIVE_PLAN=0`` (the uniform plans
      alone): both walls, peak GB, launches by kernel and rounds by
      structure side by side, the train LLs within CASCADE_LL_RTOL (the
      JAX package's band, ``tests/test_adaptive_cascade.py:98``) and both
      exact-zero shares;
   d. a profile plan of (b)'s fit (or, where no tail was rejected, one
      from every bucket's ``n_rows // 8``; the line says which), its
      compact sub-ELL built from a tail it holds, and on each of its
      buckets fgh, hvp, hvp_bv, fg, raygtd and rayf against their plain
      versions at rtol 1e-4, as phase 3 holds them;
   e. the compacted halves of phase 6's cg fit (its entry-probe
      compaction), and that phase 6's tncg epoch ran no profile plan.
   Prints the phase's seconds.
13. The solvers' other routes (run after phase 12, before phase 8), each a
   fit of a phase 6 configuration under a variable set after import, the
   launch counts set to 0 just before and read just after,
   ``train.PASS_STATS`` kept:
   a. tncg (phase 6's) with ``POISMF_TNCG_LS_CAND=1``: the fit's seconds,
      its train LL within ROUTE_LL_RTOL of phase 6's tncg fit, its line-
      search rounds per outer iteration beside phase 6's, and raygtd's
      launches by candidate count (C = 1 in the full rounds; the compact
      rounds take 4, as the JAX package's); then raygtd at C = 1 on the
      fitted item side's largest bucket against its plain version at rtol
      1e-4, launched twice for bitwise-equal outputs;
   b. the same fit with ``POISMF_TNCG_BD_ACCUM=0``: no hvp_bv launch, hvp
      and the plain bdot sweep in its place, the train LL in the band, and
      ``ops.ell.bdot_ell``'s ms a call on the item side (bf16 planes, k=50);
   c. cg (phase 6's) with ``POISMF_CG_RAY=0``: fg at every trial, no rayf
      launch, the train LL within the band of phase 6's cg fit;
   d. per fit of (a) to (c) and of phase 6's second fits (the published
      routes; pg is its published 10 epochs), the bytes ``PASS_STATS``
      counts, the achieved GB/s over the fit's wall (ingest and ELL build
      included) and its share of HBM_BYTES_S;
   e. (a) under ``POISMF_CASCADE_LOG=1``: one log line a
      ``train.CASCADE_TRACE`` round, printed.
   Prints the phase's seconds (its budget: ROUTES_BUDGET_S).

14. tncg's line-search round kernel (``ls_round``; run after phase 4),
   against its plain version (``kernels.ls_round_torch``: ``_ls_fold``
   then ``_ls_candidates``, beside the kernel's wrapper in
   ``kernels/ls_round.py``) on the card: three tncg solves of the
   published configuration at LS_ROUND_OUTER outer iterations, C = 4, on
   the whole user-side ELL (319,360 rows at full scale), the whole
   item-side ELL and a compact sub-ELL of LS_ROUND_COMPACT_SHARE of the
   user side's rows (as the cascade's compact rounds build one), with
   every call of the kernel twinned by the plain round on a copy of its
   state and candidates with the same trials (from the solve's own
   ``f_gtd_ray_multi_ell``): every state vector, candidate and flag
   equal as bit patterns after every call, and the launches equal to the
   rounds plus the searches; then the kernel and the plain round timed
   on a user-side round's inputs, with the kernel's bytes, GB/s and
   share of its bound.  Phase 6 then requires the tncg main path's
   ls_round launches to equal its line-search rounds plus its searches
   (every round on the kernel).
15. ``_assemble``'s kernel (``kernels.assemble``; run after phase 14) on
   layouts shaped as the tncg cell's compact sub-ELLs (rows written in
   place, long rows' chunks and active rows summed through ``src``) whose
   zero-tail groups hold ASM_ZERO_TAILS fill rows (the cell's largest, on
   the user and the item side), at D = 1, 4 and 50 columns (f; C; k),
   float32: the output bitwise the plain route's
   (``kernels.assemble_torch``: gather, ``masked_fill_``,
   ``torch.segment_reduce``, index write), one launch, the long path
   counted; then the kernel, the plain route and ``torch.segment_reduce``
   alone (``library_ms``) timed, with the kernel's floor (the zero tail's
   chain of dependent adds at ASM_ADD_CYCLES a cycle at the card's
   highest SM clock, or its bytes over HBM_BYTES_S, the larger) and the
   zero-tail group's share of ``segment_reduce``'s time (the same call
   without that group).  Phase 6 then requires the tncg main path to
   launch it, the long path among its launches.

Prints one JSON line of per-kernel results before the last line, and as
the last line ``{"ok": true, "device": {...}}``.  Exits nonzero, with no
result line, when there is no CUDA device, when the repository's package
is absent, or when any check fails.
"""

from __future__ import annotations

import dataclasses
import hashlib
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
    # tncg's line-search round: no TPU kernel (an XLA-fused loop body
    # there)
    "ls_round": ("poismf_torch/csrc/ls_round.cu", None),
    # _assemble's group sums: no TPU kernel (a plain .at[].add there)
    "assemble": ("poismf_torch/csrc/assemble.cu", None),
}
# Kernels driven by the line-search phase (section 4 of the docstring).
LINE_SEARCH_KERNELS = ("f", "f_gtd", "f_gtd_fused", "f_gtd_multi", "ray")
# The line-search phase's regularization, and its trial steps per row.
LS_L2 = 1e3
LS_STEPS = (0.25, 0.5, 1.0, 2.0)

# The line-search round phase (section 14 of the docstring): the outer
# iterations of each of its solves, and the share of the user side's rows
# its compact sub-ELL holds (the cascade's compact rounds hold 5-30%).
LS_ROUND_OUTER = 3
LS_ROUND_COMPACT_SHARE = 0.3

# The assembly phase (section 15 of the docstring): the fill rows of the
# zero-tail groups of the tncg cell's compact sub-ELLs (PERF.md, PR 19),
# the columns _assemble sums (f; C line-search candidates; k), and the
# cycles of one dependent float32 add on Hopper.
ASM_ZERO_TAILS = {"user": 114_640, "item": 36_812}
ASM_COLUMNS = (1, 4, 50)
ASM_ADD_CYCLES = 4
# The rest of those layouts: rows written in place, long rows among them
# and their chunks each, active rows summed through src.
ASM_PRIMARIES, ASM_CHUNKED, ASM_CHUNKS, ASM_OWN = 16_384, 1_024, 3, 8_192

# The main paths (section 6 of the docstring): constructor arguments and
# the kernels each must launch.
PATHS = {
    "tncg": (dict(k=K, method="tncg", l2_reg=1e3, maxupd=750,
                  reuse_prev=True, plane_dtype="bfloat16", niter=1),
             ("fgh", "hvp", "hvp_bv", "raygtd", "ls_round", "assemble")),
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
# The flat-COO solve sums the row's entries in the same fixed order on
# the card as on the CPU (only each k-term dot <a, B_i> may round
# otherwise), so it repeats bit for bit on the card.  The limit is this
# many float32 epsilons of those terms; measured on an NVIDIA H100 80GB
# HBM3 at 700 W while these users were solved on a one-row planar ELL:
# 0.05 (a new user) and 0.19 (the 5,158-item training user).
SERVE_SINGLE_ROUNDINGS = 4
F32_EPS = 2.0 ** -23
SERVE_CG_CONVERGED_MAXUPD = 50
# Slack of the per-row "no higher than at its init" test: the solvers
# decide in float32, the objective is evaluated here in float64.
SERVE_INIT_RTOL = 1e-6

# predict over every training pair (section 7 of the docstring): the
# pairs checked against a CPU float64 dot product, and their limit (a
# float32 sum of k=50 non-negative products).
PREDICT_SAMPLE, PREDICT_RTOL = 100_000, 1e-5
# The entry-point phase (section 9 of the docstring): the kernels
# entry()'s half-update must launch (k=8: the inner CG accumulates the
# <B, d> plane through hvp_bv), and its band against the CPU.
ENTRY_KERNELS = ("fgh", "hvp_bv", "raygtd")
ENTRY_RTOL = 1e-2

# The mesh phase (section 8 of the docstring): shards of the layout whose
# buckets the kernels run on, and the band of a one-rank mesh fit against
# the single-device fit of the same path (the port's band against JAX).
MESH_SHARDS = 2
MESH_LL_RTOL, MESH_ZERO_TOL = 1e-2, 0.02

# Main paths fitted again on the CPU, same data and seed, and the band
# their train LL must keep to it (float32 sums in another order).  pg's
# published l2=1e9 leaves an objective that is almost all penalty, so
# its objective falling says little about its data term: this check does.
CPU_REFERENCE = ("pg",)
CPU_REFERENCE_RTOL = 1e-4

# The flat-COO phase (section 10 of the docstring): its band against the
# ELL fits of phase 6 (the port's quality band against JAX,
# docs/DESIGN.md:376-380), the chunks of its nnz_chunk fit, and the paths
# also fitted with layout="coo" on the one-rank mesh.
COO_LL_RTOL, COO_ZERO_TOL = 1e-2, 0.02
# Held to the band from the ELL fit's effective start (a third fit): a
# tncg epoch carries the first half's Bsum into every later decision,
# and from fit's own start it landed 1.13e-2 from the ELL fit's LL on an
# NVIDIA H100 80GB HBM3 at 700 W (cg 3.1e-5).
COO_FROM_ELL_START = ("tncg",)
COO_MIN_CHUNKS = 16
COO_CHUNK_PATH = "cg"
COO_MESH_PATHS = ("cg", "pg")

# The float64 phase (section 11 of the docstring).  (a): phase 5's fits
# with use_float=False: float64 end to end (plane_dtype=None) they are
# held to the CPU within these LL bands (expected: ~1e-12, summation
# order alone), with bf16 planes within phase 5's band, where they must
# launch these plane kernels.
F64_SMALL = {"tncg": (1e-6, ("fgh", "hvp_bv")), "cg ray": (1e-6, ("fg",)),
             "cg fused": (1e-6, ("fg",)), "pg": (1e-9, ("pg",))}
# The ray searches' kernels: float64 px takes their plain versions.
RAY_KERNELS = ("raygtd", "rayf", "ray")
# What float64 factors never launch: the ray kernels, and tncg's
# line-search round (float64 state takes the plain round).
F64_PLAIN_KERNELS = RAY_KERNELS + ("ls_round",)
# (b): a float64 fit of each main path held to phase 6's float32 fit of
# the same path (the port's quality band against JAX): the train LL of
# every path, the exact-zero shares of F64_ZERO_PATHS.  tncg snaps a
# coordinate to its bound within 10 machine epsilons of the factors'
# dtype (tnc.c; poismf_tpu/solvers/tncg.py:775), a band 2^29 times
# narrower in float64, so its float64 epoch keeps nonzero what float32
# zeroes: exact zeros of B 0.7797 against 0.8487 on an NVIDIA H100 80GB
# HBM3 at 700 W; its shares are printed beside float32's.
F64_LL_RTOL, F64_ZERO_TOL = 1e-2, 0.02
F64_ZERO_PATHS = ("cg", "pg")
# (c): the paths fitted float64 end to end, each also with layout="coo".
F64_PLAIN_PATHS = ("pg", "cg")
# (d): float64 serving from (b)'s tncg model against the same solves on
# the CPU.  The ELL route runs the plane kernels on bf16 planes (float32
# sums, as phase 7: 1e-7 of the summed objective); the COO route, the
# single users, predict and eval_llk are float64 end to end.
F64_SERVE_RTOL = {"ell": 1e-7, "coo": 1e-9, "single": 1e-9,
                  "predict": 1e-12, "eval_llk": 1e-12}
F64_SERVE_KERNELS = ("fgh", "hvp")
# (f): the float64 fits of (b) also run on the one-rank NCCL mesh.
F64_MESH_PATHS = ("pg", "cg")

# The cascade phase (section 12 of the docstring): phase 6's tncg
# configuration at the published niter cut to CASCADE_NITER, and the
# band between its fits with and without the profile plans.
CASCADE_NITER = 3
CASCADE_LL_RTOL = 5e-2
# phase 6's fits' cascade traces (train.CASCADE_TRACE), by path
MAIN_TRACES = {}

# The routes phase (section 13 of the docstring): the band of its fits
# against phase 6's fits of the same configuration (the port's quality
# band against JAX), and the seconds it is meant to take.
ROUTE_LL_RTOL = 1e-2
ROUTES_BUDGET_S = 150
# phase 6's tncg solves' counters (outer iterations, line-search rounds),
# and per path of its second fits (fit s, train.PASS_STATS)
MAIN_SOLVES = {}
MAIN_PASSES = {}

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


def sweeps_launched(counts):
    """The launch counts of the hand-written kernels other than tncg's
    line-search round (``ls_round``, on every layout's float32 tncg),
    where nonzero: what a flat-COO solve must leave empty."""
    return {k: v for k, v in counts.items() if v and k != "ls_round"}


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
    # (a bucket of padding rows alone, as a shard's unified layout has,
    # has no count to poison)
    for name, n in n_poison.items():
        check(n > 0 or nnz == 0,
              f"{name} {tag}: no poisoned row to compare")
    a_tz10 = a_tz[:a_t10.shape[0]].contiguous()
    pref = kernels.pg_bucket_torch(bg10, vals, a_tz10)
    check(float(pref[:, bad].abs().max()) > 1e20 or nnz == 0,
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
        check(n_poison[name] > 0 or nnz == 0,
              f"{name} {tag}: no poisoned ray trial")
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


def same_bits(torch, a, b):
    """Whether two tensors hold the same bit patterns (floats as ints)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and bool(torch.equal(a, b))


class ls_round_twin:
    """Context: every ``kernels.ls_round`` call (the solver's rounds) also
    runs the plain round (``ls_round_torch``, on the card) on a copy of
    its state and candidates with the same trials, and the two must
    agree bit for bit in every state vector, every candidate and the
    round's flag.  Counts the calls compared (``calls``, those with
    trials ``rounds``) and the rows still searching after them; keeps the
    first call with trials at ``keep_rows`` rows (its inputs, before the
    call) for timing."""

    def __init__(self, torch, what, keep_rows=None):
        self.torch, self.what, self.keep_rows = torch, what, keep_rows
        self.calls = self.rounds = self.searching = 0
        self.kept = None

    def __enter__(self):
        from poismf_torch import kernels

        self.kernels, self.launch = kernels, kernels.ls_round
        torch = self.torch

        def twinned(state, cands, trials, f, dginit, spe, tnytol, more,
                    **kw):
            twin = tuple(t.clone() for t in state)
            cands_p, more_p = cands.clone(), torch.zeros_like(more)
            if (trials is not None and self.kept is None
                    and cands.shape[1] == self.keep_rows):
                self.kept = (tuple(t.clone() for t in state), cands.clone(),
                             tuple(t.clone() for t in trials),
                             (f, dginit, spe, tnytol), kw)
            self.launch(state, cands, trials, f, dginit, spe, tnytol, more,
                        **kw)
            kernels.ls_round_torch(twin, cands_p, trials, f, dginit, spe,
                                   tnytol, more_p, **kw)
            for name, a, b in zip(("floats", "flags", "nfeval"), state,
                                  twin):
                check(same_bits(torch, a, b), f"ls_round, {self.what}: "
                      f"the state's {name} differ from the plain round's "
                      f"after call {self.calls}")
            check(same_bits(torch, cands, cands_p), f"ls_round, "
                  f"{self.what}: the candidates differ from the plain "
                  f"round's after call {self.calls}")
            check(int(more) == int(more_p), f"ls_round, {self.what}: the "
                  f"round's flag differs from the plain round's after call "
                  f"{self.calls}")
            self.calls += 1
            self.rounds += trials is not None
            self.searching += int(state[1][1].sum())

        kernels.ls_round = twinned
        return self

    def __exit__(self, *exc):
        self.kernels.ls_round = self.launch
        return False


def ls_round_phase(torch, data, ell, results):
    """Phase 14: tncg's line-search round (ls_round) against its plain
    version on the card, in real searches, and its time."""
    from poismf_torch import kernels
    from poismf_torch.kernels.ls_round import STATE_FLOATS
    from poismf_torch.ops import ell as ell_ops
    from poismf_torch.ops import objective
    from poismf_torch.solvers import tncg
    from poismf_torch.train import initialize_factors

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 14)
    A = initialize_factors(data.n_users, data.by_user.n_rows_pad, K, rng,
                           device="cuda")
    B = initialize_factors(data.n_items, data.by_item.n_rows_pad, K, rng,
                           device="cuda")
    ell_u = ell_ops.ell_from_counts(data.by_user, device="cuda")
    A_u = ell_ops.permute_rows(A, ell_u.perm)
    B_i = ell_ops.permute_rows(B, ell.perm)
    plan = ell_ops.plan_compact(ell_u, 2)
    active = rng.random(ell_u.n_rows_ell) < LS_ROUND_COMPACT_SHARE
    sel = ell_ops.select_active(ell_u, plan, active,
                                ell_u.host["row_nnz_perm"],
                                list(ell_u.host["src"]))
    check(sel is not None, "ls_round phase: no compact sub-ELL")
    compact = ell_ops.build_compact(ell_u, plan, *sel[:4])
    kw = dict(PATHS["tncg"][0])
    solve_kw = dict(l2_reg=kw["l2_reg"], maxupd=kw["maxupd"],
                    reuse_prev=True, max_outer=LS_ROUND_OUTER,
                    return_stats=True)
    bsum_u = objective.make_bsum(B, data.n_items, 0.0)
    bsum_i = objective.make_bsum(A, data.n_users, 0.0)
    solves = (
        ("user side", A_u, B, ell_u, bsum_u, {}),
        ("item side", B_i, A, ell, bsum_i, {}),
        ("user side compact", A_u[compact.perm], B, compact, bsum_u,
         dict(nfeval0=torch.zeros((compact.n_rows_ell,), dtype=torch.int32,
                                  device="cuda"), ls_cand=4)),
    )
    lines = []
    kept = None
    for what, x, fixed, ell_s, bsum, extra in solves:
        planes = ell_ops.gather_planes(fixed, ell_s, kw["plane_dtype"])
        kernels.reset_launch_counts()
        with ls_round_twin(torch, what, ell_u.n_rows_ell) as twin:
            _, _, st = tncg.tncg_update_ell(x, planes, ell_s, bsum,
                                            **solve_kw, **extra)
            torch.cuda.synchronize()
        n = kernels.launch_counts["ls_round"]
        check(n == twin.calls == st["ls_rounds"] + st["outer_iters"],
              f"ls_round, {what}: {n} launches, {twin.calls} calls, "
              f"{st['ls_rounds']} rounds in {st['outer_iters']} searches")
        check(twin.rounds > 0, f"ls_round, {what}: no round ran")
        kept = kept or twin.kept
        lines.append(f"{what} (R={ell_s.n_rows_ell}): {twin.rounds} rounds "
                     f"in {st['outer_iters']} searches, {n} launches, "
                     f"{twin.searching} row-rounds still searching")
        del planes
    del A, B, A_u, B_i, ell_u, compact
    torch.cuda.empty_cache()
    check(kept is not None, "ls_round phase: no user-side round kept")
    state, cands, trials, row, kw_r = kept
    C, R = cands.shape
    twin = (tuple(t.clone() for t in state), cands.clone())
    more = torch.zeros((2,), dtype=torch.int32, device="cuda")
    kernels.reset_launch_counts()
    ms_k = time_ms(torch, lambda: kernels.ls_round(
        state, cands, trials, *row, more[0], **kw_r))
    launches = kernels.launch_counts["ls_round"]
    ms_p = time_ms(torch, lambda: kernels.ls_round_torch(
        twin[0], twin[1], trials, *row, more[1], **kw_r))
    # a row reads its state (13 floats, 2 flags, nfeval), C steps, C
    # trials' f and g.d and 4 fixed floats, and writes back its state and
    # C steps; arithmetic: ~7 a candidate and ~30 a row
    nbytes = R * ((4 * len(STATE_FLOATS) + 2 + 4) * 2 + 4 * C * 4 + 4 * 4)
    b_ms, b_by = bound(nbytes, R * (7 * C + 30))
    # bitwise equal: no error; phase 6 counts the main path's launches
    results["ls_round"] = dict(launches=launches, max_abs_err=0.0, ms=ms_k,
                               plain_ms=ms_p, bound_ms=b_ms, bound_by=b_by)
    log(f"# ls_round against the plain round (ls_round_torch) on the "
        f"card, bit for bit in every state vector, candidate and flag, "
        f"tncg's published configuration, {LS_ROUND_OUTER} outer "
        f"iterations, C=4: " + "; ".join(lines))
    log(f"# ls_round C={C} R={R} (a user-side round): {ms_k * 1e3:.2f} us "
        f"a call, plain round {ms_p * 1e3:.2f} us; {nbytes / 1e6:.1f} MB, "
        f"{nbytes / ms_k / 1e6:.0f} GB/s, {100 * b_ms / ms_k:.1f}% of its "
        f"bound {b_ms * 1e3:.2f} us ({b_by}); ls_round phase "
        f"{time.perf_counter() - t0:.1f} s")


def compact_like_assembly(fill, device):
    """(the ``Assembly`` of a layout shaped as a compact sub-ELL of the
    tncg cell, its two buckets' rows, its slots): a bucket of
    ASM_PRIMARIES rows written in place, the first ASM_CHUNKED of them
    long rows, then a bucket summed through ``src`` holding their
    ASM_CHUNKS chunks each, ASM_OWN active rows that add into themselves
    and ``fill`` fill rows that add into the zero tail, then the tail."""
    from poismf_torch.ops import ell as ell_ops

    n_chunks = ASM_CHUNKED * ASM_CHUNKS
    rows = (ASM_PRIMARIES, n_chunks + ASM_OWN + fill)
    n_slots = sum(rows) + ell_ops.ROW_TILE
    src = np.full(rows[1], n_slots - 1, dtype=np.int64)
    src[:n_chunks] = np.repeat(np.arange(ASM_CHUNKED), ASM_CHUNKS)
    src[n_chunks:n_chunks + ASM_OWN] = rows[0] + n_chunks + np.arange(
        ASM_OWN)
    asm = ell_ops.assembly([(0, rows[0], None, None),
                            (rows[0], rows[1], src, None)], n_slots, device)
    return asm, rows, n_slots


def assemble_phase(torch, results):
    """Phase 15: ``_assemble``'s kernel against its plain route on layouts
    with the tncg cell's zero-tail groups, and its time."""
    from poismf_torch import kernels

    t0 = time.perf_counter()
    clock_hz = 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    for side, fill in ASM_ZERO_TAILS.items():
        asm, rows, n_slots = compact_like_assembly(fill, "cuda")
        lens = np.diff(asm.offsets.cpu().numpy())
        check(int(lens[-1]) == fill + 1
              and int(asm.targets[-1]) == n_slots - 1,
              f"assemble phase, {side} side: the zero tail's group reads "
              f"{lens[-1]}, not {fill} fill rows and its placeholder")
        n_reads, n_adds = int(lens.sum()), int(lens.sum()) - lens.shape[0]
        for D in ASM_COLUMNS:
            pieces = [torch.randn((r, D), generator=gen, device="cuda")
                      for r in rows]
            flat_k = torch.empty((n_slots, D), device="cuda")
            torch.cat(pieces, out=flat_k[:asm.covered])
            flat_p = flat_k.clone()
            kernels.reset_launch_counts()
            kernels.assemble(flat_k, asm)
            launches = dict(kernels.launch_counts)
            check(launches["assemble"] == 1
                  and launches["assemble_long"] == 1,
                  f"assemble phase: launches {launches}")
            kernels.assemble_torch(flat_p, asm)
            check(same_bits(torch, flat_k, flat_p),
                  f"assemble, {side} side, D={D}: the kernel's output "
                  "differs from the plain route's")
            ms_k = time_ms(torch, lambda: kernels.assemble(flat_k, asm))
            ms_p = time_ms(torch, lambda: kernels.assemble_torch(flat_p,
                                                                 asm))
            adds = flat_p[asm.order]
            segs = [(adds, asm.offsets),
                    (adds[:int(asm.offsets[-2])], asm.offsets[:-1])]
            ms_lib, ms_rest = (time_ms(torch, lambda a=a, o=o:
                                       torch.segment_reduce(
                                           a, "sum", offsets=o, unsafe=True,
                                           initial=-0.0))
                               for a, o in segs)
            # reads: order and each read's D values; writes: the targets,
            # the zeroed add rows and the other zeroed rows
            n_zero = asm.zero_rows.numel()
            nbytes = (8 * n_reads
                      + 4 * D * (n_reads + lens.shape[0] + n_adds + n_zero))
            chain_ms = 1e3 * (fill + 1) * ASM_ADD_CYCLES / clock_hz
            bytes_ms = 1e3 * nbytes / HBM_BYTES_S
            b_ms, b_by = max((chain_ms, "chain"), (bytes_ms, "bytes"))
            share = 1.0 - ms_rest / ms_lib
            log(f"# assemble {side} side ({n_slots} slots, {lens.shape[0]} "
                f"groups, zero tail {fill} fill rows), D={D}, float32: "
                f"bitwise the plain route; kernel {ms_k:.4f} ms "
                f"[{100 * b_ms / ms_k:.1f}% of its floor {b_ms:.4f} ms, "
                f"{b_by}: chain {chain_ms:.4f} at {clock_hz / 1e9:.3f} "
                f"GHz, bytes {bytes_ms:.4f}], plain route {ms_p:.4f} ms, "
                f"segment_reduce alone {ms_lib:.4f} ms (library_ms), "
                f"without the zero tail's group {ms_rest:.4f} ms: the zero "
                f"tail {100 * share:.1f}% of segment_reduce's time")
            if side == "user" and D == max(ASM_COLUMNS):
                results["assemble"] = dict(
                    launches=1, max_abs_err=0.0, ms=ms_k, plain_ms=ms_p,
                    bound_ms=b_ms, bound_by=b_by, library_ms=ms_lib)
            del pieces, flat_k, flat_p, adds, segs
        del asm
        torch.cuda.empty_cache()
    log(f"# assemble phase {time.perf_counter() - t0:.1f} s")


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


# Phase 5's fits: (label, constructor arguments).
SMALL_FITS = (("tncg", dict(method="tncg", niter=2)),
              ("cg ray", dict(method="cg", niter=2)),
              ("cg fused", dict(method="cg", niter=2, limit_step=False)),
              ("pg", dict(method="pg", niter=3)))


def small_fit_data():
    """Phase 5's problem: 3000 x 1500, 60k nonzeros."""
    from poismf_torch.utils.data import synth_lastfm_like

    rows, cols, vals = synth_lastfm_like(np.random.default_rng(SEED + 2),
                                         3000, 1500, 60_000)
    return rows, cols, vals, (3000, 1500)


def small_fit_phase(torch):
    """Phase 5: one small problem fitted on the card and on the CPU, by
    each method (cg by both line searches)."""
    from poismf_torch import PoisMF

    X = small_fit_data()
    for label, kw in SMALL_FITS:
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
    public entry points, with the launch counts read around it alone.
    Returns (model, the topN_batched users, (fit s, peak GB, the initial
    objective))."""
    from poismf_torch import PoisMF, kernels, train
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
    train.CASCADE_TRACE = []
    t0 = time.perf_counter()
    with solve_counters() as solves:
        model.fit(X)
        torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    MAIN_TRACES[path], train.CASCADE_TRACE = train.CASCADE_TRACE, None
    MAIN_SOLVES[path] = solves

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
    if path == "tncg":
        check(counts["assemble_long"] > 0, "tncg: no _assemble launch summed "
              "a long group (the compact rounds' zero tails)")
        # every round of every search on the kernel, one launch more a
        # search for its first candidates
        check(counts["ls_round"] == solves["ls_rounds"]
              + solves["outer_iters"],
              f"tncg: {counts['ls_round']} ls_round launches for "
              f"{solves['ls_rounds']} line-search rounds in "
              f"{solves['outer_iters']} searches")
    repeat_fit(torch, X, kw, path, A, B, counts)
    if path in CPU_REFERENCE:
        cpu_reference_check(X, kw, model, ll1, ll1_obs)
    info = (fit_s, peak_gb, obj0)
    if path != "tncg":
        return model, None, info
    log(f"# topN_batched 1024 users: {batched_s * 1e3:.2f} ms "
        f"({1024 / batched_s:.0f} queries/s, first call)")
    At, Bt = torch.from_numpy(A), torch.from_numpy(B)
    for u, ids in zip(users, top):
        check(topn_matches(torch, At, Bt, int(u), ids, 10),
              f"topN of user {u} differs from a CPU topk")
    for row in range(8):
        check(topn_matches(torch, At, Bt, int(q[row]), top_b[row], 10),
              f"topN_batched row {row} differs from a CPU topk")
    return model, q, info


def chunk_divisor(nnz_pad: int, min_chunks: int) -> int:
    """The largest multiple of 1024 that divides ``nnz_pad`` into at
    least ``min_chunks`` chunks."""
    for n in range(min_chunks, nnz_pad // 1024 + 1):
        if nnz_pad % n == 0 and (nnz_pad // n) % 1024 == 0:
            return nnz_pad // n
    return 1024


def coo_fit(torch, X, kw):
    """One ``layout="coo"`` fit on the card, launch counts set to 0 just
    before and read just after: (model, fit s, peak GB); no sweep kernel
    may launch (tncg's line search launches ls_round on any layout), and
    the factors must be finite and >= 0."""
    from poismf_torch import PoisMF, kernels

    model = PoisMF(random_state=SEED, device="cuda", layout="coo", **kw)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    model.fit(X)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts = sweeps_launched(kernels.launch_counts)
    A, B = model.A, model.B
    check(not counts, f"COO {kw['method']} fit launched sweep "
          f"kernels {counts}: it drifted onto the ELL")
    check(np.isfinite(A).all() and np.isfinite(B).all()
          and (A >= 0).all() and (B >= 0).all(),
          f"COO {kw['method']}: non-finite or negative factors")
    return model, fit_s, peak_gb


def coo_fit_from_ell_start(torch, data, kw):
    """The COO fit of ``kw`` from the ELL fit's effective start, through
    ``PoisMF.fit_unsafe``: the same initial factors as ``fit`` draws (seed
    SEED, A then B), with the rows without nonzeros zeroed.  The ELL
    driver leaves those rows out of its permuted factors, so they never
    enter a Bsum; the COO driver, as the JAX package's, sums their initial
    values into the first half's Bsum.  From this start the two fits
    differ by their solvers alone.  Returns (model, fit s)."""
    import scipy.sparse as sp

    from poismf_torch import PoisMF, kernels
    from poismf_torch.sparse import csr_like
    from poismf_torch.train import initialize_factors

    rng = np.random.default_rng(SEED)
    n_u, n_i, k = data.n_users, data.n_items, kw["k"]
    A0 = initialize_factors(n_u, data.by_user.n_rows_pad, k, rng).numpy()
    B0 = initialize_factors(n_i, data.by_item.n_rows_pad, k, rng).numpy()
    A0, B0 = A0[:n_u], B0[:n_i]
    A0[data.by_user.row_nnz[:n_u] == 0] = 0.0
    B0[data.by_item.row_nnz[:n_i] == 0] = 0.0
    indptr, indices, vals = csr_like(data.by_user)
    X_csr = sp.csr_matrix((vals, indices, indptr), shape=(n_u, n_i))
    X_csc = X_csr.tocsc()
    model = PoisMF(random_state=SEED, device="cuda", layout="coo", **kw)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    model.fit_unsafe(A0, B0, X_csr, X_csc)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    check(not sweeps_launched(kernels.launch_counts),
          f"COO {kw['method']} fit_unsafe launched a sweep kernel")
    return model, fit_s


def coo_phase(torch, X, data, ell):
    """Phase 10: each main path again on the flat COO (see the module
    docstring); ``ell[path]`` holds phase 6's fit of it (train LL, exact
    zero shares of A and B, fit s, peak GB, initial objective).  Returns
    {path: (train LL, zero share A, zero share B)} of the COO fits."""
    from poismf_torch import train
    from poismf_torch.solvers.tncg import _maxcgit

    # the ELL pair phase 6 cached is no part of a COO fit's memory
    train._ELL_CACHE.clear()
    out, walls = {}, []
    for path in ("cg", "pg", "tncg"):
        kw = dict(PATHS[path][0])
        kw.pop("plane_dtype")  # the COO has no planes
        ll_e, z_a_e, z_b_e, s_e, gb_e, obj0 = ell[path]
        model, fit_s, peak_gb = coo_fit(torch, X, kw)
        A, B = model.A, model.B
        ll = model.eval_llk(include_missing=True)
        obj1 = -ll + kw["l2_reg"] * float((A.astype(np.float64) ** 2).sum()
                                         + (B.astype(np.float64) ** 2).sum())
        z_a, z_b = (A == 0).mean(), (B == 0).mean()
        rel = abs(ll - ll_e) / abs(ll_e)
        cap = ("" if path != "tncg" else
               f", inner-CG cap {model._params().max_cg or _maxcgit(kw['k'])}")
        log(f"# COO {path} {kw}{cap}: fit {fit_s:.2f} s (ingest and "
            f"device COO included), peak device memory {peak_gb:.2f} GB, "
            f"no sweep kernel launched; train LL (all pairs) "
            f"{ll:.6e} (ELL fit {ll_e:.6e}, rel {rel:.3e}); -LL + l2 "
            f"penalty {obj0:.6e} -> {obj1:.6e}; exact zeros A {z_a:.4f} "
            f"B {z_b:.4f} (ELL {z_a_e:.4f}, {z_b_e:.4f})")
        check(np.isfinite(ll) and obj1 < obj0,
              f"COO {path}: the fit's objective did not improve")
        again, again_s, _ = coo_fit(torch, X, kw)
        first, second = digest(A, B), digest(again.A, again.B)
        log(f"# COO {path} fitted again: {again_s:.2f} s; sha256(A, B) "
            f"first {first[:16]} second {second[:16]} "
            f"({'equal' if first == second else 'DIFFERENT'})")
        check(first == second, f"COO {path}: a second fit of the same data "
              "and seed gave other factors")
        del again
        if path in CPU_REFERENCE:
            cpu_reference_check(X, dict(kw, layout="coo"), model, ll,
                                model.eval_llk())
        elif path in COO_FROM_ELL_START:
            like, like_s = coo_fit_from_ell_start(torch, data, kw)
            ll_l = like.eval_llk(include_missing=True)
            z_al, z_bl = (like.A == 0).mean(), (like.B == 0).mean()
            rel_l = abs(ll_l - ll_e) / abs(ll_e)
            log(f"# COO {path} from the ELL fit's start (fit_unsafe, the "
                f"rows without nonzeros zeroed): {like_s:.2f} s; train LL "
                f"{ll_l:.6e} (rel to the ELL fit {rel_l:.3e}, limit "
                f"{COO_LL_RTOL:.0e}; the fit from fit's own start "
                f"{abs(ll - ll_l) / abs(ll_l):.3e} from it); exact zeros "
                f"A {z_al:.4f} B {z_bl:.4f}")
            check(rel_l <= COO_LL_RTOL and abs(z_al - z_a_e) <= COO_ZERO_TOL
                  and abs(z_bl - z_b_e) <= COO_ZERO_TOL,
                  f"COO {path}: outside the quality band of the ELL fit "
                  "from the same start")
            del like
        else:
            check(rel <= COO_LL_RTOL and abs(z_a - z_a_e) <= COO_ZERO_TOL
                  and abs(z_b - z_b_e) <= COO_ZERO_TOL,
                  f"COO {path}: outside the quality band of the ELL fit")
        out[path] = (ll, z_a, z_b)
        walls.append(f"{path} ELL {s_e:.2f} s ({gb_e:.2f} GB), COO "
                     f"{fit_s:.2f} s ({peak_gb:.2f} GB)")
        del model
        if path == COO_CHUNK_PATH:
            chunk = chunk_divisor(data.by_user.nnz_pad, COO_MIN_CHUNKS)
            model, c_s, c_gb = coo_fit(torch, X, dict(kw, nnz_chunk=chunk))
            ll_c = model.eval_llk(include_missing=True)
            z_ac, z_bc = (model.A == 0).mean(), (model.B == 0).mean()
            rel_c = abs(ll_c - ll_e) / abs(ll_e)
            log(f"# COO {path} nnz_chunk={chunk} "
                f"({data.by_user.nnz_pad // chunk} chunks): fit {c_s:.2f} s, "
                f"peak device memory {c_gb:.2f} GB (unchunked "
                f"{peak_gb:.2f} GB); train LL {ll_c:.6e} (rel to the ELL "
                f"fit {rel_c:.3e}, to the unchunked COO fit "
                f"{abs(ll_c - ll) / abs(ll):.3e}); exact zeros A "
                f"{z_ac:.4f} B {z_bc:.4f}")
            check(rel_c <= COO_LL_RTOL and abs(z_ac - z_a_e) <= COO_ZERO_TOL
                  and abs(z_bc - z_b_e) <= COO_ZERO_TOL,
                  f"COO {path} nnz_chunk: outside the quality band of the "
                  "ELL fit")
            del model
        torch.cuda.empty_cache()
    log("# fit walls, one process, ELL (phase 6) against COO: "
        + "; ".join(walls))
    train._COO_CACHE.clear()
    return out


def digest(A, B):
    return hashlib.sha256(A.tobytes() + B.tobytes()).hexdigest()


def repeat_fit(torch, X, kw, path, A, B, counts):
    """Phase 6, again: the same fit of ``path`` (data, configuration,
    seed) a second time, launch counts set to 0 just before and read just
    after, ``train.PASS_STATS`` kept (for phase 13d); A and B must be
    SHA-256-equal to the first fit's ``A`` and ``B``, and the launches
    equal to its ``counts``: the count changes nothing."""
    from poismf_torch import PoisMF, kernels, train

    model = PoisMF(random_state=SEED, device="cuda", **kw)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    train.PASS_STATS = []
    t0 = time.perf_counter()
    try:
        model.fit(X)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        MAIN_PASSES[path] = (fit_s, train.PASS_STATS)
    finally:
        train.PASS_STATS = None
    again = dict(kernels.launch_counts)
    first, second = digest(A, B), digest(model.A, model.B)
    log(f"# {path} fitted again: {fit_s:.2f} s; sha256(A, B) first "
        f"{first[:16]} second {second[:16]} "
        f"({'equal' if first == second else 'DIFFERENT'}); launches "
        f"{'equal' if again == counts else f'DIFFERENT: {again}'}")
    check(first == second, f"{path}: a second fit of the same data and seed "
          "gave other factors")
    check(again == counts, f"{path}: a second fit launched other kernel "
          "counts")


def serving_objective(torch, A, B, Bsum, X, l2, magnitude=False):
    """Per row of the CSR ``X``: -sum_i x_i log(<a, B_i>) + <Bsum, a> +
    l2 |a|^2 (the serving solves' objective, l2 in f), in float64 on the
    CPU; ``A`` [n, k] and ``B``, ``Bsum`` as tensors or arrays.  With
    ``magnitude``, also the sum of its terms' absolute values per row.
    Each row sums its terms one after another in the CSR's order, so the
    check itself repeats bit for bit."""
    A = torch.as_tensor(A).cpu().double()
    B = torch.as_tensor(B).cpu().double()
    X = X.tocsr()
    lengths = torch.from_numpy(np.diff(X.indptr).astype(np.int64))
    r = torch.repeat_interleave(torch.arange(X.shape[0]), lengths)
    c = torch.from_numpy(X.indices.astype(np.int64))
    pred = (A[r] * B[c]).sum(1)
    terms = -torch.from_numpy(X.data).double() * torch.log(pred)

    def row_sums(t):
        return torch.segment_reduce(t, "sum", lengths=lengths, initial=0.0)

    bsum = torch.as_tensor(Bsum).cpu().double()
    lin = A @ bsum + l2 * (A * A).sum(1)
    if not magnitude:
        return row_sums(terms) + lin
    return (row_sums(terms) + lin,
            row_sums(terms.abs()) + (A @ bsum).abs() + l2 * (A * A).sum(1))


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


def float64_small_fits(torch):
    """Phase 11a: phase 5's fits with ``use_float=False``, bf16 planes and
    float64 planes, each on the card (launch counts set to 0 just before
    and read just after) and on the CPU."""
    from poismf_torch import PoisMF, kernels

    X = small_fit_data()
    for label, kw in SMALL_FITS:
        for pdt in ("bfloat16", None):
            kw_f = dict(k=8, plane_dtype=pdt, random_state=SEED,
                        use_float=False, **kw)
            kernels.reset_launch_counts()
            m_gpu = PoisMF(device="cuda", **kw_f).fit(X)
            counts = {n: c for n, c in kernels.launch_counts.items() if c}
            m_cpu = PoisMF(device="cpu", **kw_f).fit(X)
            l_gpu, l_cpu = m_gpu.eval_llk(), m_cpu.eval_llk()
            rel = abs(l_gpu - l_cpu) / abs(l_cpu)
            dz_a = abs((m_gpu.A == 0).mean() - (m_cpu.A == 0).mean())
            dz_b = abs((m_gpu.B == 0).mean() - (m_cpu.B == 0).mean())
            rtol, launched = F64_SMALL[label]
            limit = 1e-2 if pdt else rtol
            log(f"# float64 small {label} fit, plane_dtype={pdt}: LL cuda "
                f"{l_gpu:.12e} cpu {l_cpu:.12e} (rel {rel:.3e}, limit "
                f"{limit:.0e}); zero share diff A {dz_a:.4f} B {dz_b:.4f}; "
                f"kernel launches {counts}")
            check(m_gpu.A.dtype == np.float64 and np.isfinite(l_gpu)
                  and rel <= limit, f"float64 small {label} fit "
                  f"(plane_dtype={pdt}) differs from the CPU by {rel:.3e}")
            check(dz_a <= 0.02 and dz_b <= 0.02,
                  f"float64 small {label} fit sparsity differs")
            check_float64_route(counts, pdt, f"float64 small {label} fit",
                                launched)


def check_float64_route(counts, plane_dtype, what, expected=()):
    """The JAX package's x64 routes in a float64 run's launch counts: the
    ray kernels never (float64 px), nor ls_round (float64 search state);
    with float64 planes no kernel but ``_assemble``'s; else each of
    ``expected``."""
    if plane_dtype is None:
        # _assemble's sums run on the card in any dtype (no TPU route)
        check(not any(v for k, v in counts.items()
                      if not k.startswith("assemble")),
              f"{what} launched hand-written kernels {counts} on float64 "
              "planes")
        return
    for name in F64_PLAIN_KERNELS:
        check(counts.get(name, 0) == 0, f"{what} launched {name} on "
              "float64 px or state")
    for name in expected:
        check(counts.get(name, 0) > 0, f"kernel {name} never launched in "
              f"{what}")


def float64_fit(torch, X, kw, what):
    """One ``use_float=False`` fit on the card of ``kw``, launch counts set
    to 0 just before and read just after: (model, fit s, peak GB, launch
    counts); float64 factors, finite and >= 0."""
    from poismf_torch import PoisMF, kernels

    model = PoisMF(random_state=SEED, device="cuda", use_float=False, **kw)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    model.fit(X)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts = dict(kernels.launch_counts)
    A, B = model.A, model.B
    check(A.dtype == np.float64 and B.dtype == np.float64,
          f"{what}: factors not float64")
    check(np.isfinite(A).all() and np.isfinite(B).all()
          and (A >= 0).all() and (B >= 0).all(),
          f"{what}: non-finite or negative factors")
    return model, fit_s, peak_gb, counts


def float64_main_paths(torch, X, ell):
    """Phase 11b: each main path of phase 6 with ``use_float=False`` (bf16
    planes), held to phase 6's float32 fit of the same path (``ell``, as
    :func:`coo_phase` takes it); pg also to the same float64 fit on the CPU
    and fitted twice.  Returns {path: (the model (tncg) or None, fit s,
    peak GB, train LL, zero share A, zero share B)}."""
    out = {}
    for path in PATHS:
        kw, expected = PATHS[path]
        what = f"float64 {path}"
        model, fit_s, peak_gb, counts = float64_fit(torch, X, kw, what)
        ll_e, z_a_e, z_b_e, s_e, gb_e, obj0 = ell[path]
        A, B = model.A, model.B
        ll, ll_obs = model.eval_llk(include_missing=True), model.eval_llk()
        z_a, z_b = (A == 0).mean(), (B == 0).mean()
        rel = abs(ll - ll_e) / abs(ll_e)
        obj1 = -ll + kw["l2_reg"] * float((A ** 2).sum() + (B ** 2).sum())
        log(f"# {what} {kw}, use_float=False: fit {fit_s:.2f} s, peak "
            f"device memory {peak_gb:.2f} GB (float32, phase 6: {s_e:.2f} "
            f"s, {gb_e:.2f} GB); train LL (all pairs) {ll:.9e} (float32 "
            f"fit {ll_e:.9e}, rel {rel:.3e}, limit {F64_LL_RTOL:.0e}); -LL "
            f"+ l2 penalty {obj0:.6e} -> {obj1:.6e}; exact zeros A "
            f"{z_a:.4f} B {z_b:.4f} (float32 {z_a_e:.4f}, {z_b_e:.4f})")
        log(f"# kernel launches in the {what} path: {counts}")
        check(np.isfinite(ll) and obj1 < obj0,
              f"{what}: the fit's objective did not improve")
        check(rel <= F64_LL_RTOL, f"{what}: train LL outside the band of "
              "the float32 fit")
        check(path not in F64_ZERO_PATHS or (
            abs(z_a - z_a_e) <= F64_ZERO_TOL
            and abs(z_b - z_b_e) <= F64_ZERO_TOL),
            f"{what}: exact-zero shares outside the band of the float32 "
            "fit")
        check_float64_route(counts, kw["plane_dtype"], f"the {what} path",
                            [n for n in expected
                             if n not in F64_PLAIN_KERNELS])
        if path in CPU_REFERENCE:
            repeat_fit(torch, X, dict(kw, use_float=False), what, A, B,
                       counts)
            cpu_reference_check(X, dict(kw, use_float=False), model, ll,
                                ll_obs)
        out[path] = (model if path == "tncg" else None, fit_s, peak_gb, ll,
                     z_a, z_b)
        del model
        torch.cuda.empty_cache()
    return out


def float64_plain_paths(torch, X, f64, ell):
    """Phase 11c: F64_PLAIN_PATHS float64 end to end (``plane_dtype=None``)
    on the ELL and on the flat COO: no hand-written kernel launched, the
    COO fit within phase 10's band of the ELL fit; each fit's seconds and
    peak GB beside (b)'s (``f64``) and phase 6's (``ell``)."""
    for path in F64_PLAIN_PATHS:
        kw = dict(PATHS[path][0], plane_dtype=None)
        fits = {}
        for layout in ("ell", "coo"):
            what = f"float64 {path} {layout.upper()}, float64 planes"
            model, fit_s, peak_gb, counts = float64_fit(
                torch, X, dict(kw, layout=layout), what)
            check_float64_route(counts, None, what)
            fits[layout] = (model.eval_llk(include_missing=True),
                            (model.A == 0).mean(), (model.B == 0).mean(),
                            fit_s, peak_gb)
            del model
            torch.cuda.empty_cache()
        (ll_e, za_e, zb_e, s_e, gb_e), (ll_c, za_c, zb_c, s_c, gb_c) = (
            fits["ell"], fits["coo"])
        rel = abs(ll_c - ll_e) / abs(ll_e)
        log(f"# float64 {path} end to end (plane_dtype=None), no hand-written "
            f"kernel launched: ELL fit {s_e:.2f} s ({gb_e:.2f} GB), train "
            f"LL {ll_e:.9e}, zeros A {za_e:.4f} B {zb_e:.4f}; COO fit "
            f"{s_c:.2f} s ({gb_c:.2f} GB), train LL {ll_c:.9e} (rel to the "
            f"ELL {rel:.3e}, limit {COO_LL_RTOL:.0e}), zeros A {za_c:.4f} B "
            f"{zb_c:.4f}; bf16 planes (b) {f64[path][1]:.2f} s "
            f"({f64[path][2]:.2f} GB), float32 (phase 6) {ell[path][3]:.2f} "
            f"s ({ell[path][4]:.2f} GB)")
        check(rel <= COO_LL_RTOL and abs(za_c - za_e) <= COO_ZERO_TOL
              and abs(zb_c - zb_e) <= COO_ZERO_TOL,
              f"float64 {path}: the COO fit is outside the band of the ELL "
              "fit")


def float64_serving(torch, model, X, X_new, data, q):
    """Phase 11d: serving from (b)'s float64 tncg model on the card, launch
    counts set to 0 just before each call and read just after, each held
    to the CPU (``F64_SERVE_RTOL``).  Returns the ELL transform's A_new."""
    from poismf_torch import kernels, serve
    from poismf_torch.ops import objective
    from poismf_torch.sparse import build_counts, csr_like

    p = model._params()
    n_new, k = X_new.shape[0], p.k
    B, Bsum, Amean = model.B, model.Bsum, model.Amean
    reuse = model.reuse_prev
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
    check(A_new.shape == (n_new, k) and A_new.dtype == np.float64,
          "float64 transform: shape or dtype")
    check(np.isfinite(A_new).all() and (A_new >= 0).all(),
          "float64 transform: non-finite or negative factors")
    f_new = serving_objective(torch, A_new, B, Bsum, X_new, p.l2_reg)
    init = Amean.cpu() if reuse else torch.full((k,), 1e-3,
                                                 dtype=torch.float64)
    f_init = serving_objective(torch, init.expand(n_new, k), B, Bsum, X_new,
                               p.l2_reg)
    rise = (f_new - f_init) / f_init.abs().clamp_min(1e-30)
    log(f"# float64 serving tncg: transform of {n_new} new users "
        f"({X_new.nnz} nonzeros, the ELL route, bf16 planes) {solve_s:.2f} "
        f"s, {n_new / solve_s:.0f} rows/s, peak device memory {peak_gb:.2f} "
        f"GB; serving objective summed {float(f_init.sum()):.6e} at the "
        f"init -> {float(f_new.sum()):.6e}; worst relative rise "
        f"{float(rise.max()):.3e}; exact zeros {(A_new == 0).mean():.4f}")
    log(f"# kernel launches in the float64 tncg transform: {counts}")
    check(bool((rise <= SERVE_INIT_RTOL).all()),
          "float64 transform: a row's objective rose above its init")
    check_float64_route(counts, "bfloat16", "the float64 tncg transform",
                        F64_SERVE_KERNELS)
    sub = X_new[:SERVE_CPU_USERS].tocoo()
    X_sub = build_counts(sub.row, sub.col, sub.data, SERVE_CPU_USERS,
                         X_new.shape[1], dtype=np.float64)
    threshold = serve.ELL_SERVE_NNZ_THRESHOLD
    serve.ELL_SERVE_NNZ_THRESHOLD = 0
    try:
        t0 = time.perf_counter()
        A_cpu = serve.factors_multiple(model._B.cpu(), Bsum.cpu(),
                                       Amean.cpu(), X_sub, p,
                                       reuse_mean=reuse)
        cpu_s = time.perf_counter() - t0
    finally:
        serve.ELL_SERVE_NNZ_THRESHOLD = threshold
    agree_on_cpu(torch, f"float64 serving tncg: {SERVE_CPU_USERS} of the new "
                 f"users on the CPU (the same route, {cpu_s:.2f} s)",
                 f_new[:SERVE_CPU_USERS],
                 serving_objective(torch, A_cpu[:SERVE_CPU_USERS], B, Bsum,
                                   X_new[:SERVE_CPU_USERS], p.l2_reg),
                 F64_SERVE_RTOL["ell"])
    serving_coo_batch(torch, model, "float64 tncg", X_new, p, reuse,
                      rtol=F64_SERVE_RTOL["coo"])

    # predict_factors / topN_new for 8 single users (7 of the new batch,
    # the training user with the most items) on the flat COO, the first
    # and the last again on the CPU
    indptr, indices, vals = csr_like(data.by_user)
    u_long = int(np.argmax(np.diff(indptr)))
    singles = [(f"new user {r}",
                X_new.indices[X_new.indptr[r]:X_new.indptr[r + 1]],
                X_new.data[X_new.indptr[r]:X_new.indptr[r + 1]])
               for r in range(n_new)
               if X_new.indptr[r + 1] > X_new.indptr[r]][:7]
    singles.append((f"training user {u_long}",
                    indices[indptr[u_long]:indptr[u_long + 1]],
                    vals[indptr[u_long]:indptr[u_long + 1]]))
    Bt = torch.from_numpy(B)
    kernels.reset_launch_counts()
    secs, gaps = [], []
    for j, (label, items, cnt) in enumerate(singles):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a = model.predict_factors((items, cnt))
        secs.append(time.perf_counter() - t0)
        ids = model.topN_new((items, cnt), n=10)
        check(a.dtype == np.float64 and np.isfinite(a).all()
              and (a >= 0).all() and a.max() > 0,
              f"float64 predict_factors of {label}: bad factors")
        scores = Bt @ torch.from_numpy(a)
        ref_vals, ref_ids = torch.topk(scores, 10)
        check(np.array_equal(ref_ids.numpy(), ids) or torch.allclose(
            scores[torch.as_tensor(ids)], ref_vals, rtol=1e-12, atol=0.0),
            f"float64 topN_new of {label} differs from a CPU topk")
        if j not in (0, len(singles) - 1):
            continue
        ix, c = model._process_data_single((items, cnt))
        a_cpu = serve.factors_single(
            model._B.cpu(), Bsum.cpu(), Amean.cpu(), ix, c, l2_reg=p.l2_reg,
            l1_new=p.l1_reg, l1_old=p.l1_reg, w_mult=p.w_mult,
            maxupd=max(1000, p.maxupd), reuse_mean=model.reuse_prev,
            n_items=model.nitems)
        row = _one_row(items, cnt, B.shape[0])
        f1, f_cpu = (serving_objective(torch, x[None], B, Bsum, row,
                                       p.l2_reg) for x in (a, a_cpu))
        gaps.append(abs(float(f1[0] - f_cpu[0])) / abs(float(f_cpu[0])))
        log(f"# float64 predict_factors {label} ({len(items)} items): "
            f"{secs[-1]:.3f} s; serving objective card {float(f1[0]):.15e} "
            f"cpu {float(f_cpu[0]):.15e} (rel {gaps[-1]:.3e}, limit "
            f"{F64_SERVE_RTOL['single']:.0e})")
    counts = {n: c for n, c in kernels.launch_counts.items() if c}
    log(f"# float64 predict_factors: {np.mean(secs):.3f} s a user (8 users, "
        f"each then topN_new equal to a CPU topk, on the flat COO); kernel "
        f"launches {counts}")
    check(max(gaps) <= F64_SERVE_RTOL["single"],
          f"float64 predict_factors differs from the CPU by {max(gaps):.3e}")
    check(not counts, "float64 predict_factors launched a hand-written "
          "kernel")

    # exclude_seen for phase 6's 1,024 users
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    top_x = model.topN_batched(q, n=10, exclude_seen=True)
    torch.cuda.synchronize()
    excl_s = time.perf_counter() - t0
    check_exclude_seen(torch, model, q, top_x, indptr, indices, "float64 ")
    log(f"# float64 topN_batched(exclude_seen=True) {q.shape[0]} users: "
        f"{excl_s * 1e3:.2f} ms; equal to a CPU topk with the training "
        "items masked")

    predict_phase(torch, model, X, F64_SERVE_RTOL["predict"])
    t0 = time.perf_counter()
    ll = model.eval_llk(include_missing=True)
    ll_s = time.perf_counter() - t0
    ll_cpu = float(objective.eval_llk(model._A.cpu(), model._B.cpu(),
                                      model._by_user, include_missing=True))
    rel = abs(ll - ll_cpu) / abs(ll_cpu)
    log(f"# float64 eval_llk on the card {ll:.15e} ({ll_s:.2f} s), on the "
        f"CPU {ll_cpu:.15e} (rel {rel:.3e}, limit "
        f"{F64_SERVE_RTOL['eval_llk']:.0e})")
    check(rel <= F64_SERVE_RTOL["eval_llk"],
          f"float64 eval_llk differs from the CPU by {rel:.3e}")
    return A_new


def float64_checkpoint(torch, model, X_new, A_new):
    """Phase 11e: ``save``, then ``PoisMF.load`` with its default device:
    the loaded model is float64 on the card and its ``transform`` of
    ``X_new`` (launch counts set to 0 just before and read just after) is
    bitwise (d)'s ``A_new``."""
    import os

    from poismf_torch import PoisMF, kernels

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_float64.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    t0 = time.perf_counter()
    model.save(path)
    loaded = PoisMF.load(path)
    load_s = time.perf_counter() - t0
    try:
        check(loaded.device.type == "cuda"
              and loaded._B.dtype == torch.float64,
              "float64 checkpoint: not loaded onto the card in float64")
        kernels.reset_launch_counts()
        again = loaded.transform(X_new)
        counts = {n: c for n, c in kernels.launch_counts.items() if c}
    finally:
        os.remove(path)
    same = again.dtype == A_new.dtype and np.array_equal(
        again.view(np.uint64), A_new.view(np.uint64))
    log(f"# float64 checkpoint: saved and loaded ({loaded.device}) in "
        f"{load_s:.2f} s; transform of {X_new.shape[0]} new users "
        f"{'bitwise equal to' if same else 'DIFFERENT from'} the model in "
        f"memory; kernel launches {counts}")
    check(same, "float64 checkpoint: the loaded model's transform differs")
    check_float64_route(counts, "bfloat16", "the loaded model's transform",
                        F64_SERVE_KERNELS)


def float64_phase(torch, X, data, X_new, q, ell):
    """Phase 11 (section 11 of the docstring); ``ell`` holds phase 6's
    fits as :func:`coo_phase` takes them.  Returns {path: (train LL, zero
    share A, zero share B)} of (b)'s F64_MESH_PATHS fits, for the mesh
    phase."""
    from poismf_torch import train

    t0 = time.perf_counter()
    float64_small_fits(torch)
    f64 = float64_main_paths(torch, X, ell)
    float64_plain_paths(torch, X, f64, ell)
    model = f64["tncg"][0]
    A_new = float64_serving(torch, model, X, X_new, data, q)
    float64_checkpoint(torch, model, X_new, A_new)
    del model, f64["tncg"]
    # the float64 layouts are no part of the later phases' memory
    train._ELL_CACHE.clear()
    train._COO_CACHE.clear()
    torch.cuda.empty_cache()
    log(f"# float64 phase: {time.perf_counter() - t0:.1f} s")
    return {path: f64[path][3:] for path in F64_MESH_PATHS}


def cascade_halves(trace):
    """A fit's ``train.CASCADE_TRACE`` cut into its half-updates (each
    starts at round 0)."""
    halves = []
    for e in trace:
        if e.rnd == 0:
            halves.append([])
        halves[-1].append(e)
    return halves


def cascade_fit(torch, X, plans_on):
    """Phase 12: CASCADE_KW at CASCADE_NITER epochs, with the profile plans
    or under ``POISMF_ADAPTIVE_PLAN=0``, the launch counts set to 0 just
    before and read just after.  Returns (model, fit s, peak GB, launches,
    halves)."""
    import os

    from poismf_torch import PoisMF, kernels, train

    kw = dict(PATHS["tncg"][0], niter=CASCADE_NITER)
    if plans_on:
        os.environ.pop("POISMF_ADAPTIVE_PLAN", None)
    else:
        os.environ["POISMF_ADAPTIVE_PLAN"] = "0"
    try:
        model = PoisMF(random_state=SEED, device="cuda", **kw)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        train.CASCADE_TRACE = []
        t0 = time.perf_counter()
        model.fit(X)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        trace, train.CASCADE_TRACE = train.CASCADE_TRACE, None
    finally:
        os.environ.pop("POISMF_ADAPTIVE_PLAN", None)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts = {k: v for k, v in kernels.launch_counts.items() if v}
    check(np.isfinite(model.A).all() and np.isfinite(model.B).all()
          and (model.A >= 0).all() and (model.B >= 0).all(),
          "cascade fit: non-finite or negative factors")
    return model, fit_s, peak_gb, counts, cascade_halves(trace)


def small_full_rounds(half):
    """A half's full-structure rounds on tails of at most half its rows."""
    return sum(e.structure == "full" and e.rnd > 0
               and 2 * e.n_in <= half[0].n_in for e in half)


def cascade_summary(halves):
    """(rounds by structure, full rounds on tails of at most half the
    rows, compact rounds on a profile plan)."""
    by = {}
    for e in (e for half in halves for e in half):
        by[e.structure] = by.get(e.structure, 0) + 1
    return (by, sum(small_full_rounds(h) for h in halves),
            sum(e.denom == 0 for h in halves for e in h))


def print_cascade(label, halves, n_item_slots):
    for h, half in enumerate(halves):
        side = "item" if half[0].n_in == n_item_slots else "user"
        small_full = small_full_rounds(half)
        log(f"# {label} half {h} ({side} side, epoch {h // 2}): "
            + " ".join(f"{e.rnd}:{e.structure}:{e.n_in}->{e.n_out}"
                       for e in half)
            + f"; full rounds on tails <= 50%: {small_full}; profile plans "
            f"{ {c: list(caps) for c, caps in half[0].plans.items()} }")


def profile_plan_kernels(torch, model):
    """Phase 12d: a profile plan of the cached pair's cascade state (from
    every bucket's n_rows // 8 where none was built), its compact sub-ELL
    for a tail it holds, and the tncg and cg kernels on each of its buckets
    against their plain versions."""
    from poismf_torch import kernels, train
    from poismf_torch.ops import ell as ell_ops

    ell_user, ell_item = next(iter(train._ELL_CACHE.values()))[0]
    A = torch.from_numpy(model.A).cuda()
    B = torch.from_numpy(model.B).cuda()
    sides = ((ell_item, ell_ops.permute_rows(A, ell_user.perm),
              ell_ops.permute_rows(B, ell_item.perm), "item"),
             (ell_user, ell_ops.permute_rows(B, ell_item.perm),
              ell_ops.permute_rows(A, ell_user.perm), "user"))
    pick = next(((ell, fixed, x, side, plan)
                 for ell, fixed, x, side in sides
                 for plan in train.cascade_aux(ell)["adaptive_plans"]
                 .values()), None)
    if pick is not None:
        ell, fixed, x, side, plan = pick
        how = "built from the fit's rejected-tail profile"
    else:
        ell, fixed, x, side = sides[0][:4]
        plan = ell_ops.plan_compact_from_profile(
            ell, [b.n_rows // 8 for b in ell.buckets])
        check(plan is not None, "no profile plan from n_rows // 8")
        how = "no tail was rejected: built from every bucket's n_rows // 8"
    aux = train.cascade_aux(ell)
    rng = np.random.default_rng(SEED + 12)
    real = aux["row_nnz"] > 0
    share, sel = 0.5, None
    while sel is None:
        active = real & (rng.random(real.shape[0]) < share)
        sel = ell_ops.select_active(ell, plan, active, aux["row_nnz"],
                                    aux["src"])
        share /= 2
    compact = ell_ops.build_compact(ell, plan, *sel[:4])
    planes = ell_ops.gather_planes(fixed, compact, torch.bfloat16)
    x_c = x[compact.perm]
    log(f"# cascade (d): {side} side's profile plan ({how}): caps "
        f"{list(plan.caps)} of {[b.n_rows for b in ell.buckets]} rows, "
        f"{int(np.count_nonzero(active))} active rows selected, "
        f"{compact.n_rows_ell} compact slots")
    g = torch.Generator(device="cuda").manual_seed(SEED + 12)
    worst = {}
    for b, bg in zip(compact.buckets, planes):
        vals = b.vals.float().contiguous()
        a_t = ell_ops._bucket_x(x_c, b).t().contiguous()
        v_t = torch.randn(a_t.shape, generator=g, device="cuda") * 0.1
        ref = kernels.fgh_bucket_torch(bg, vals, a_t, 1.0, True)
        w2, px = ref[3], ref[4]
        href = kernels.hvp_bucket_torch(bg, w2, v_t, True)
        pd = href[1]
        steps = (torch.tensor([1e-3, 3e-3, 1e-2, 3e-2], device="cuda")[:, None]
                 * (0.5 + torch.rand((1, b.n_rows), generator=g,
                                     device="cuda")))
        tag = f"P={b.P} R={b.n_rows}"
        for name, out, want in (
                ("fgh", kernels.fgh_bucket(bg, vals, a_t), ref),
                ("hvp", kernels.hvp_bucket(bg, w2, v_t)[:1], href[:1]),
                ("hvp_bv", kernels.hvp_bucket(bg, w2, v_t, True), href),
                ("fg", kernels.fg_bucket(bg, vals, a_t),
                 kernels.fg_bucket_torch(bg, vals, a_t, True)),
                ("raygtd", kernels.raygtd_multi_bucket(px, pd, vals, steps),
                 kernels.raygtd_multi_bucket_torch(px, pd, vals, steps)),
                ("rayf", (kernels.rayf_multi_bucket(px, pd, vals, steps),),
                 (kernels.rayf_multi_bucket_torch(px, pd, vals, steps),))):
            err = max(compare(torch, f"{name} cascade (d) {tag}", o, r)
                      for o, r in zip(out, want))
            worst[name] = max(worst.get(name, 0.0), err)
    shapes = ", ".join(f"P={b.P} x R={b.n_rows}" for b in compact.buckets)
    log(f"# cascade (d): the profile plan's {len(compact.buckets)} compact "
        f"buckets ({shapes}), kernels against their plain versions, max abs "
        f"err "
        + ", ".join(f"{n} {e:.3e}" for n, e in worst.items())
        + " (rtol 1e-4)")


def cascade_phase(torch, X, data):
    """Phase 12 (section 12 of the docstring)."""
    from poismf_torch import train

    t0 = time.perf_counter()
    n_item_slots = None
    runs = {}
    for label, plans_on in (("a", True), ("b", True), ("c", False)):
        runs[label] = cascade_fit(torch, X, plans_on)
        model, fit_s, peak_gb, counts, halves = runs[label]
        if label == "a":
            n_item_slots = halves[0][0].n_in
            print_cascade("cascade (a)", halves, n_item_slots)
        if label == "b":
            first, again = runs["a"], runs["b"]
            same = digest(first[0].A, first[0].B) == digest(model.A, model.B)
            log(f"# cascade (b) fitted again: {fit_s:.2f} s; sha256(A, B) "
                f"{'equal' if same else 'DIFFERENT'}; launches "
                f"{'equal' if counts == first[3] else 'DIFFERENT'}")
            check(same, "cascade: a second fit gave other factors")
            check(counts == first[3], "cascade: a second fit launched other "
                  "kernel counts")
            profile_plan_kernels(torch, model)
        if label == "c":
            print_cascade("cascade (c) POISMF_ADAPTIVE_PLAN=0", halves,
                          n_item_slots)
    lls = {}
    for label, (model, fit_s, peak_gb, counts, halves) in runs.items():
        if label == "b":
            continue
        by, small_full, profile = cascade_summary(halves)
        lls[label] = model.eval_llk(include_missing=True)
        how = ("profile plans on" if label == "a"
               else "POISMF_ADAPTIVE_PLAN=0")
        log(f"# cascade {how} ({CASCADE_NITER} epochs): fit {fit_s:.2f} s, "
            f"peak device memory {peak_gb:.2f} GB, train LL (all pairs) "
            f"{lls[label]:.6e}"
            f", exact zeros A {(model.A == 0).mean():.4f} B "
            f"{(model.B == 0).mean():.4f}; {len(halves)} halves, rounds by "
            f"structure {by}, full rounds on tails <= 50%: {small_full}, "
            f"compact rounds on a profile plan: {profile}; launches {counts}")
    rel = abs(lls["a"] - lls["c"]) / abs(lls["c"])
    log(f"# cascade: train LL with the profile plans against without: rel "
        f"{rel:.3e} (limit {CASCADE_LL_RTOL:.0e}); walls {runs['a'][1]:.2f} "
        f"/ {runs['b'][1]:.2f} s against {runs['c'][1]:.2f} s")
    check(np.isfinite(rel) and rel <= CASCADE_LL_RTOL,
          f"cascade: the fits with and without profile plans differ in "
          f"train LL by {rel:.3e}")
    # (e) phase 6's fits
    cg = cascade_halves(MAIN_TRACES["cg"])
    compacted = sum(h[0].structure.startswith("compact/") for h in cg)
    log(f"# cascade (e): phase 6's cg fit compacted {compacted} of its "
        f"{len(cg)} halves at the entry probe ("
        + " ".join(f"{h[0].structure}:{h[0].n_out}/{h[0].n_in}" for h in cg)
        + ")")
    tncg = MAIN_TRACES["tncg"]
    check(not any(e.denom == 0 for e in tncg),
          "cascade: phase 6's tncg epoch ran a profile plan")
    del runs
    train._ELL_CACHE.clear()
    torch.cuda.empty_cache()
    log(f"# cascade phase: {time.perf_counter() - t0:.1f} s")


class solve_counters:
    """Context: wraps ``train.tncg_update_ell`` (the cascade's solver, full
    and compact rounds) to sum the counters of its stats (outer
    iterations, line-search and HVP rounds, solves), which the solver
    keeps on the host; nothing else changes."""

    def __enter__(self):
        from poismf_torch import train

        self.train, self.solve = train, train.tncg_update_ell
        self.sums = dict(outer_iters=0, ls_rounds=0, hvp_rounds=0, solves=0)

        def counted(*a, **kw):
            out = self.solve(*a, **kw)
            if kw.get("return_stats"):
                for name in ("outer_iters", "ls_rounds", "hvp_rounds"):
                    self.sums[name] += int(out[2][name])
                self.sums["solves"] += 1
            return out

        train.tncg_update_ell = counted
        return self.sums

    def __exit__(self, *exc):
        self.train.tncg_update_ell = self.solve
        return False


def ls_per_outer(sums):
    return sums["ls_rounds"] / max(sums["outer_iters"], 1)


def traffic(fit_s, entries):
    """(GB PASS_STATS counts, achieved GB/s over ``fit_s``, share of
    HBM_BYTES_S)."""
    nbytes = sum(float(s) * b for s, b in entries)
    return nbytes / 1e9, nbytes / 1e9 / fit_s, nbytes / fit_s / HBM_BYTES_S


def route_fit(torch, X, path, env, log_rounds=False):
    """Phase 13: phase 6's fit of ``path`` under the variables ``env``,
    set after import (and removed after), the launch counts set to 0 just
    before and read just after, ``train.PASS_STATS`` and
    ``train.CASCADE_TRACE`` kept, the tncg solves' counters summed and
    raygtd's launches counted by candidate count (a spy on its wrapper);
    ``log_rounds`` also sets ``POISMF_CASCADE_LOG=1`` and keeps the
    stderr lines.  Returns dict(model, fit_s, counts, by_c, solves,
    passes, trace, lines)."""
    import contextlib
    import io
    import os

    from poismf_torch import PoisMF, kernels, train

    kw = PATHS[path][0]
    env = dict(env, **({"POISMF_CASCADE_LOG": "1"} if log_rounds else {}))
    by_c = {}
    raygtd = kernels.raygtd_multi_bucket

    def spy(px, pd, vals, alphas):
        C = alphas.shape[0]
        by_c[C] = by_c.get(C, 0) + 1
        return raygtd(px, pd, vals, alphas)

    os.environ.update(env)
    kernels.raygtd_multi_bucket = spy
    err = io.StringIO()
    try:
        model = PoisMF(random_state=SEED, device="cuda", **kw)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        train.PASS_STATS, train.CASCADE_TRACE = [], []
        t0 = time.perf_counter()
        with solve_counters() as solves, contextlib.redirect_stderr(err):
            model.fit(X)
            torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = {k: v for k, v in kernels.launch_counts.items() if v}
        passes, trace = train.PASS_STATS, train.CASCADE_TRACE
    finally:
        train.PASS_STATS = train.CASCADE_TRACE = None
        kernels.raygtd_multi_bucket = raygtd
        for name in env:
            os.environ.pop(name, None)
    check(np.isfinite(model.A).all() and np.isfinite(model.B).all()
          and (model.A >= 0).all() and (model.B >= 0).all(),
          f"route {env}: non-finite or negative factors")
    lines = [ln for ln in err.getvalue().splitlines() if "cascade[" in ln]
    return dict(model=model, fit_s=fit_s, counts=counts, by_c=by_c,
                solves=solves, passes=passes, trace=trace, lines=lines)


def route_band(what, model, ref_ll):
    ll = model.eval_llk(include_missing=True)
    rel = abs(ll - ref_ll) / abs(ref_ll)
    check(np.isfinite(rel) and rel <= ROUTE_LL_RTOL,
          f"{what}: train LL {ll:.6e} is {rel:.3e} from phase 6's "
          f"{ref_ll:.6e}")
    return ll, rel


def raygtd_c1_check(torch, model):
    """Phase 13a: raygtd at C = 1 on the item side's largest bucket of the
    fitted model (the cached pair's ELL, bf16 planes of A), px and pd from
    the plain fgh and HVP at B and a random direction, small steps:
    against its plain version at rtol 1e-4, twice bitwise, timed."""
    from poismf_torch import kernels, train
    from poismf_torch.ops import ell as ell_ops

    ell_user, ell_item = next(iter(train._ELL_CACHE.values()))[0]
    A = torch.from_numpy(model.A).cuda()
    B = torch.from_numpy(model.B).cuda()
    A_p = ell_ops.permute_rows(A, ell_user.perm)
    B_p = ell_ops.permute_rows(B, ell_item.perm)
    b = max(ell_item.buckets, key=lambda b: b.n_rows * b.P)
    bg = ell_ops.gather_bucket(A_p.t().contiguous().to(torch.bfloat16), b)
    vals = b.vals.float().contiguous()
    a_t = ell_ops._bucket_x(B_p, b).t().contiguous()
    g = torch.Generator(device="cuda").manual_seed(SEED + 13)
    v_t = torch.randn(a_t.shape, generator=g, device="cuda") * 0.1
    px = kernels.fgh_bucket_torch(bg, vals, a_t, 1.0, True)[4]
    pd = kernels.hvp_bucket_torch(bg, torch.ones_like(vals), v_t, True)[1]
    alphas = 1e-3 * (0.5 + torch.rand((1, b.n_rows), generator=g,
                                      device="cuda"))
    out1 = kernels.raygtd_multi_bucket(px, pd, vals, alphas)
    out2 = kernels.raygtd_multi_bucket(px, pd, vals, alphas)
    ref = kernels.raygtd_multi_bucket_torch(px, pd, vals, alphas)
    err = max(compare(torch, f"raygtd C=1 P={b.P} R={b.n_rows}", o, r)
              for o, r in zip(out1, ref))
    for o1, o2 in zip(out1, out2):
        check(torch.equal(o1.view(torch.int32), o2.view(torch.int32)),
              "raygtd C=1: two launches differ bitwise")
    ms_k = time_ms(torch, lambda: kernels.raygtd_multi_bucket(px, pd, vals,
                                                              alphas))
    nnz = int((vals > 0).sum())
    b_ms, b_by = bound(*work("raygtd", K, b.P, b.n_rows, 4, nnz, 1))
    log(f"# routes (a): raygtd at C=1 on the fitted item side's largest "
        f"bucket P={b.P} x R={b.n_rows}: max abs err {err:.3e} against its "
        f"plain version (rtol 1e-4), two launches bitwise equal; kernel "
        f"{ms_k:.4f} ms, bound {b_ms:.4f} ms ({b_by}), {b_ms / ms_k:.1%} "
        f"of its bound")
    return ell_item, A_p, b


def bdot_ms(torch, ell_item, A_p):
    """Phase 13b: ms a call of ``ops.ell.bdot_ell`` on the whole item-side
    ELL (bf16 planes of A, k=50, a random direction), CUDA events."""
    from poismf_torch.ops import ell as ell_ops

    planes = ell_ops.gather_planes(A_p, ell_item, torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(SEED + 14)
    d = torch.randn((ell_item.n_rows_ell, A_p.shape[1]), generator=g,
                    device="cuda")
    ms = time_ms(torch, lambda: ell_ops.bdot_ell(d, planes, ell_item))
    slots = sum(b.n_rows * b.P for b in ell_item.buckets)
    nbytes = slots * (A_p.shape[1] * 2 + 4)
    del planes
    return ms, nbytes / ms / 1e6, slots


def routes_phase(torch, X, single):
    """Phase 13 (section 13 of the docstring); ``single[path]`` holds
    phase 6's fit of each path (train LL first)."""
    t0 = time.perf_counter()
    fits = {}
    # (a) + (e)
    a = fits["a"] = route_fit(torch, X, "tncg", {"POISMF_TNCG_LS_CAND": "1"},
                              log_rounds=True)
    ll, rel = route_band("routes (a)", a["model"], single["tncg"][0])
    main = MAIN_SOLVES["tncg"]
    log(f"# routes (a) tncg POISMF_TNCG_LS_CAND=1 (1 epoch): fit "
        f"{a['fit_s']:.2f} s, train LL {ll:.6e} (phase 6 "
        f"{single['tncg'][0]:.6e}, rel {rel:.3e}, limit {ROUTE_LL_RTOL:.0e}); "
        f"LS rounds per outer iteration {ls_per_outer(a['solves']):.2f} "
        f"({a['solves']['ls_rounds']} in {a['solves']['outer_iters']}; phase "
        f"6 {ls_per_outer(main):.2f}, {main['ls_rounds']} in "
        f"{main['outer_iters']}); raygtd launches by candidates "
        f"{dict(sorted(a['by_c'].items()))}; launches {a['counts']}")
    check(a["by_c"].get(1, 0) > 0, "routes (a): raygtd never ran at C = 1")
    check(set(a["by_c"]) <= {1, 4}, f"routes (a): raygtd at {a['by_c']}")
    ell_item, A_p, _ = raygtd_c1_check(torch, a["model"])
    check(len(a["lines"]) == len(a["trace"]) > 0,
          f"routes (e): {len(a['lines'])} log lines for "
          f"{len(a['trace'])} cascade rounds")
    log(f"# routes (e): POISMF_CASCADE_LOG=1 on (a), {len(a['lines'])} lines "
        f"for {len(a['trace'])} CASCADE_TRACE rounds:")
    for line in a["lines"]:
        log(line)
    # (b)
    b = fits["b"] = route_fit(torch, X, "tncg", {"POISMF_TNCG_BD_ACCUM": "0"})
    ll, rel = route_band("routes (b)", b["model"], single["tncg"][0])
    ms, gbs, slots = bdot_ms(torch, ell_item, A_p)
    del ell_item, A_p
    log(f"# routes (b) tncg POISMF_TNCG_BD_ACCUM=0 (1 epoch): fit "
        f"{b['fit_s']:.2f} s, train LL {ll:.6e} (rel {rel:.3e}); launches "
        f"{b['counts']}; bdot_ell on the item side ({slots} slots, bf16 "
        f"planes, k={K}): {ms:.4f} ms a call, {gbs:.0f} GB/s")
    check(b["counts"].get("hvp_bv", 0) == 0, "routes (b): hvp_bv launched")
    check(b["counts"].get("hvp", 0) > 0, "routes (b): hvp never launched")
    # (c)
    c = fits["c"] = route_fit(torch, X, "cg", {"POISMF_CG_RAY": "0"})
    ll, rel = route_band("routes (c)", c["model"], single["cg"][0])
    log(f"# routes (c) cg POISMF_CG_RAY=0 (3 epochs): fit {c['fit_s']:.2f} "
        f"s, train LL {ll:.6e} (phase 6 {single['cg'][0]:.6e}, rel "
        f"{rel:.3e}); fg launches {c['counts'].get('fg', 0)}, rayf "
        f"{c['counts'].get('rayf', 0)}")
    check(c["counts"].get("rayf", 0) == 0, "routes (c): rayf launched")
    check(c["counts"].get("fg", 0) > 0, "routes (c): fg never launched")
    # (d)
    rows = [(f"phase 6 {path} (published route)", *MAIN_PASSES[path])
            for path in PATHS]
    rows += [(f"routes ({label})", f["fit_s"], f["passes"])
             for label, f in fits.items()]
    for what, fit_s, entries in rows:
        check(entries and all(isinstance(s, float) and s > 0
                              for s, _ in entries),
              f"routes (d): {what}: no PASS_STATS entries")
        gb, gbs, share = traffic(fit_s, entries)
        log(f"# routes (d) PASS_STATS {what}: {len(entries)} entries, "
            f"{gb:.1f} GB in {fit_s:.2f} s, {gbs:.1f} GB/s, {share:.2%} of "
            f"{HBM_BYTES_S / 1e12:.2f} TB/s")
    del fits, a, b, c
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t0
    log(f"# routes phase: {phase_s:.1f} s (budget {ROUTES_BUDGET_S} s)")


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


def check_exclude_seen(torch, model, q, top_x, indptr, indices, what):
    """``top_x``, the model's ``topN_batched(q, n=10, exclude_seen=True)``,
    equal to a CPU ``torch.topk`` of its factors with each user's training
    items (the CSR ``indptr``, ``indices``) masked."""
    At, Bt = torch.from_numpy(model.A), torch.from_numpy(model.B)
    for lo in range(0, q.shape[0], 256):
        scores = At[torch.as_tensor(q[lo:lo + 256])] @ Bt.t()
        for j in range(scores.shape[0]):
            u = int(q[lo + j])
            check(topn_excl_matches(torch, scores[j],
                                    indices[indptr[u]:indptr[u + 1]],
                                    top_x[lo + j], 10),
                  f"{what}topN_batched(exclude_seen) of user {u} differs "
                  "from a CPU topk with the training items masked")


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
    for name in SERVE_KERNELS[path] + (("ls_round",) if path == "tncg"
                                       else ()):
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
    serving_coo_batch(torch, model, path, X_new, p, reuse)
    if path != "tncg":
        return

    # predict_factors / topN_new for 8 single users: 7 of the new batch,
    # and the training user with the most items; the flat-COO tncg solves
    # each
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
    # the first new user and the long training user solved again on the
    # CPU, as predict_factors calls the solve
    for label, items, cnt, f1, a in (solved[0], solved[-1]):
        ix, c = model._process_data_single((items, cnt))
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
        f"{np.median(secs):.3f}, 8 users, each then topN_new, on the flat "
        f"COO); kernel launches: {counts}")
    check(not sweeps_launched(counts),
          "predict_factors launched a sweep kernel: it left the COO")

    # exclude_seen for phase 6's 1,024 users
    kernels.reset_launch_counts()
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        top_x = model.topN_batched(q, n=10, exclude_seen=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    check_exclude_seen(torch, model, q, top_x, indptr, indices, "")
    log(f"# topN_batched(exclude_seen=True) {q.shape[0]} users: first call "
        f"{times[0] * 1e3:.2f} ms (host CSR of the training data built), "
        f"second {times[1] * 1e3:.2f} ms ({q.shape[0] / times[1]:.0f} "
        f"queries/s); equal to a CPU topk with the training items masked, "
        f"no training item returned")


def serving_coo_batch(torch, model, path, X_new, p, reuse, rtol=None):
    """Phase 7: ``transform`` of the first new users holding at most
    ``serve.ELL_SERVE_NNZ_THRESHOLD`` nonzeros, which the flat-COO solvers
    take: no sweep kernel launched, each row no higher than at its
    init, and the summed objective within ``SERVE_CPU_RTOL`` of the same
    solve on the CPU (from the card's B, Bsum and Amean; ``rtol`` for
    another limit)."""
    from poismf_torch import kernels, serve
    from poismf_torch.sparse import build_counts

    n = int(np.searchsorted(X_new.indptr, serve.ELL_SERVE_NNZ_THRESHOLD,
                            side="right")) - 1
    X_s = X_new[:n]
    B, Bsum, Amean = model.B, model.Bsum, model.Amean
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    A_s = model.transform(X_s)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = sweeps_launched(kernels.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(np.isfinite(A_s).all() and (A_s >= 0).all(),
          f"{path} COO transform: non-finite or negative factors")
    check(not counts, f"{path} COO transform launched sweep kernels "
          f"{counts}: it left the COO")
    coo = X_s.tocoo()
    t0 = time.perf_counter()
    A_cpu = serve.factors_multiple(
        model._B.cpu(), Bsum.cpu(), Amean.cpu(),
        build_counts(coo.row, coo.col, coo.data, n, X_s.shape[1],
                     dtype=B.dtype), p, reuse_mean=reuse)[:n]
    cpu_s = time.perf_counter() - t0
    f_card = serving_objective(torch, A_s, B, Bsum, X_s, p.l2_reg)
    init = (Amean.cpu().double() if reuse
            else torch.full((p.k,), 1e-3, dtype=torch.float64))
    f_init = serving_objective(torch, init.expand(n, p.k), B, Bsum, X_s,
                               p.l2_reg)
    rise = (f_card - f_init) / f_init.abs().clamp_min(1e-30)
    log(f"# serving {path}: transform of {n} new users ({X_s.nnz} "
        f"nonzeros, at most serve.ELL_SERVE_NNZ_THRESHOLD: the flat COO) "
        f"{secs:.2f} s, {n / secs:.0f} rows/s, peak device memory "
        f"{peak_gb:.2f} GB, no sweep kernel launched; worst "
        f"relative rise above the init {float(rise.max()):.3e}; exact "
        f"zeros {(A_s == 0).mean():.4f}")
    check(bool((rise <= SERVE_INIT_RTOL).all()),
          f"{path} COO transform: a row's objective rose above its init")
    agree_on_cpu(torch, f"serving {path} COO transform on the CPU ({cpu_s:.2f}"
                 " s)", f_card, serving_objective(torch, A_cpu, B, Bsum, X_s,
                                                  p.l2_reg),
                 SERVE_CPU_RTOL[path] if rtol is None else rtol)


def predict_phase(torch, model, X, rtol=PREDICT_RTOL):
    """Phase 7, last: ``predict`` over every training pair of ``X`` (the
    model streams them ``PREDICT_CHUNK`` at a time), its seconds and peak
    device memory; the values finite, and PREDICT_SAMPLE of them within
    ``rtol`` of a CPU float64 dot product of the model's factors."""
    from poismf_torch.models import poismf as model_mod

    rows, cols = X[0], X[1]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    pred = model.predict(rows, cols)
    secs = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(pred.shape == rows.shape and np.isfinite(pred).all(),
          "predict over the training pairs: shape or non-finite values")
    pick = np.random.default_rng(SEED + 5).choice(rows.shape[0],
                                                  PREDICT_SAMPLE,
                                                  replace=False)
    u, i = model._map_users(rows[pick]), model._map_items(cols[pick])
    ref = (model.A[u].astype(np.float64) * model.B[i].astype(np.float64)
           ).sum(1)
    rel = float((np.abs(pred[pick] - ref) / np.maximum(ref, 1e-30)).max())
    log(f"# predict over {rows.shape[0]} training pairs "
        f"({model_mod.PREDICT_CHUNK} a chunk): {secs:.2f} s, peak device "
        f"memory {peak_gb:.2f} GB ({peak_gb - base_gb:.2f} GB above the "
        f"model); {PREDICT_SAMPLE} of them against a CPU float64 dot "
        f"product: max rel {rel:.3e} (limit {rtol:.0e})")
    check(rel <= rtol, f"predict differs from a CPU dot product by "
          f"{rel:.3e}")


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


def shard_kernel_phase(torch, data, results):
    """Phase 8a: the training kernels on the buckets of a row-sharded fit's
    unified layout (``shard_ell``, MESH_SHARDS shards of each orientation):
    on each shard its largest and its smallest bucket, and a bucket of
    padding rows alone where the unification made one, against their
    plain versions (bf16 planes of the whole fixed side, gathered through
    the shard's columns in its original row order, as the sharded half
    all-gathers it)."""
    from poismf_torch.ops import ell as ell_ops
    from poismf_torch.parallel.ell_mesh import shard_ell
    from poismf_torch.train import initialize_factors

    rng = np.random.default_rng(SEED + 4)
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    n_padding = 0
    for side, X in (("user", data.by_user), ("item", data.by_item)):
        t0 = time.perf_counter()
        se = shard_ell(X, MESH_SHARDS)
        log(f"# mesh: {side} side in {MESH_SHARDS} shards of {se.rps} rows "
            f"built in {time.perf_counter() - t0:.1f} s: "
            + ", ".join(f"P={P} x R={R}" + (" (src)" if s is not None
                                              else "")
                        for P, R, s in zip(se.Ps, se.Rbs, se.srcs)))
        F_t = initialize_factors(X.n_cols, X.n_cols, K, rng,
                                 device="cuda").t().contiguous()
        for d in range(MESH_SHARDS):
            ell = se.local_ell(d, "cuda")
            x = ell_ops.permute_rows(
                initialize_factors(se.rps, se.rps, K, rng, device="cuda"),
                ell.perm)
            by_size = sorted(ell.buckets, key=lambda b: b.n_rows * b.P)
            picks = {id(b): b for b in (by_size[-1], by_size[0])}
            picks.update({id(b): b for b in ell.buckets
                          if not bool((b.vals > 0).any())})
            for b in picks.values():
                vals = b.vals.float().contiguous()
                nnz = int((vals > 0).sum())
                n_padding += nnz == 0
                a_t = ell_ops._bucket_x(x, b).t().contiguous()
                v_t = torch.randn(a_t.shape, generator=g, device="cuda") * 0.1
                bg = ell_ops.gather_bucket(F_t.to(torch.bfloat16), b)
                pg_planes = (ell_ops.gather_bucket(
                    F_t[:10].contiguous().to(torch.bfloat16), b),
                    a_t[:10].contiguous())
                tag = (f"mesh {side} shard {d} P={b.P} R={b.n_rows} "
                       "bfloat16")
                log(f"# {tag}: {nnz} nonzero slots of {b.P * b.n_rows}"
                    + (" (padding rows alone)" if nnz == 0 else ""))
                _, px, pd, _ = sweep_kernels(torch, tag, bg, vals, a_t, v_t,
                                             pg_planes, nnz, results,
                                             record=False)
                scale = 0.5 + torch.rand((1, b.n_rows), generator=g,
                                         device="cuda")
                steps = torch.tensor([1e-3, 3e-3, 1e-2, 3e-2],
                                     device="cuda")[:, None]
                far = torch.tensor([1e-1, 3.0, 30.0, 300.0],
                                   device="cuda")[:, None]
                ray_kernels(torch, tag, px, pd, vals, steps * scale,
                            far * scale, nnz, results, record=False)
                del bg, pg_planes, px, pd
            del ell, x
        del se, F_t
        torch.cuda.empty_cache()
    log(f"# mesh: the shards' buckets against the plain versions, "
        f"{n_padding} of them padding rows alone")


def mesh_path_phase(torch, X, single, single_coo, single_f64, results):
    """Phase 8b: each main path (``PATHS``) through ``PoisMF(mesh=...)`` on
    a one-rank NCCL mesh, with the kernel launch counts and the
    collectives' counts set to 0 just before each fit and read just
    after; the train LL and the exact-zero shares held to phase 6's
    single-device fit of the same path (``single``), and top-N to a CPU
    ``torch.topk``; then COO_MESH_PATHS with ``layout="coo"``, held to
    phase 10's single-device COO fits (``single_coo``), and
    F64_MESH_PATHS with ``use_float=False``, held to phase 11's
    single-device float64 fits (``single_f64``; pg to the same LL)."""
    import os

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from poismf_torch import PoisMF, kernels
    from poismf_torch.parallel import collectives

    store = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "chip_smoke_mesh_store")
    os.makedirs(os.path.dirname(store), exist_ok=True)
    if os.path.exists(store):
        os.remove(store)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        mesh = init_device_mesh("cuda", (1,))
        runs = [(path, kw, expected, "ell", single[path])
                for path, (kw, expected) in PATHS.items()]
        runs += [(path, dict(PATHS[path][0], layout="coo"), (), "coo",
                  single_coo[path]) for path in COO_MESH_PATHS]
        runs += [(f"float64 {path}", dict(PATHS[path][0], use_float=False),
                  [n for n in PATHS[path][1]
                   if n not in F64_PLAIN_KERNELS], "ell",
                  single_f64[path]) for path in F64_MESH_PATHS]
        for path, kw, expected, layout, ref in runs:
            model = PoisMF(random_state=SEED, mesh=mesh, **kw)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            collectives.reset_counts()
            t0 = time.perf_counter()
            model.fit(X)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            counts, coll = dict(kernels.launch_counts), dict(
                collectives.counts)
            A, B = model.A, model.B
            check(np.isfinite(A).all() and np.isfinite(B).all()
                  and (A >= 0).all() and (B >= 0).all(),
                  f"mesh {path}: non-finite or negative factors")
            ll = model.eval_llk(include_missing=True)
            ll1, z_a1, z_b1 = ref
            rel = abs(ll - ll1) / abs(ll1)
            dz_a, dz_b = abs((A == 0).mean() - z_a1), abs((B == 0).mean()
                                                          - z_b1)
            if layout == "coo":
                path = f"{path} COO"
            log(f"# mesh {path} on a one-rank NCCL mesh ({model.device}): "
                f"fit {fit_s:.2f} s (ingest and shard build included), peak "
                f"device memory {peak_gb:.2f} GB; train LL (all pairs) "
                f"{ll:.6e}, single-device fit {ll1:.6e} (rel {rel:.3e}, "
                f"limit {MESH_LL_RTOL:.0e}); zero share diff A {dz_a:.4f} "
                f"B {dz_b:.4f}; collectives {coll}")
            log(f"# kernel launches in the mesh {path} path: {counts}")
            check(np.isfinite(ll) and rel <= MESH_LL_RTOL,
                  f"mesh {path}: train LL differs from the single-device fit "
                  f"by {rel:.3e}")
            check(dz_a <= MESH_ZERO_TOL and dz_b <= MESH_ZERO_TOL,
                  f"mesh {path}: sparsity differs from the single-device fit")
            for name in expected:
                check(counts[name] > 0,
                      f"kernel {name} never launched in the mesh {path} path")
            if layout == "coo":
                check(sum(counts.values()) == 0,
                      f"mesh {path}: a hand-written kernel launched")
            check(coll["all_gather"] > 0,
                  f"mesh {path}: no collective ran")
            if not kw.get("use_float", True):
                check(A.dtype == np.float64, f"mesh {path}: not float64")
                check_float64_route(counts, kw["plane_dtype"],
                                    f"the mesh {path} path", expected)
                check(kw["method"] != "pg" or rel == 0.0,
                      f"mesh {path}: train LL differs from one GPU's")
            At, Bt = torch.from_numpy(A), torch.from_numpy(B)
            for u in range(5):
                check(topn_matches(torch, At, Bt, u, model.topN(u, n=10), 10),
                      f"mesh {path}: topN of user {u} differs from a CPU "
                      "topk")
            del model, A, B, At, Bt
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        os.remove(store)


def entry_phase(torch):
    """Phase 9: ``entry()`` on the card, launch counts set to 0 just
    before and read just after, held to ``entry(device="cpu")``; then
    ``dryrun_multichip`` on NCCL ranks, one a GPU of this host."""
    from poismf_torch import entry, kernels

    fn, args = entry.entry()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(kernels.launch_counts)
    fn_cpu, args_cpu = entry.entry(device="cpu")
    ref = fn_cpu(*args_cpu).numpy()
    got = out.cpu().numpy()
    check(got.shape == ref.shape and np.isfinite(got).all(),
          "entry: shape or non-finite factors")
    off = ~np.isclose(got, ref, rtol=1e-4, atol=1e-7).all(1)
    rel = float((np.abs(got - ref) / np.maximum(np.abs(ref), 1e-7)).max())
    log(f"# entry(): one tncg half-update of {got.shape[0]} x {got.shape[1]} "
        f"user factors on the card, {secs:.3f} s; against entry(device="
        f"'cpu'): max rel {rel:.3e} (limit {ENTRY_RTOL:.0e}), {int(off.sum())} "
        f"rows beyond 1e-4; kernel launches {counts}")
    check(rel <= ENTRY_RTOL, f"entry: the card's half-update differs from "
          f"the CPU's by {rel:.3e}")
    for name in ENTRY_KERNELS:
        check(counts[name] > 0, f"kernel {name} never launched in entry()")
    n = torch.cuda.device_count()
    t0 = time.perf_counter()
    lls = entry.dryrun_multichip(n, device="cuda")
    log(f"# dryrun_multichip({n}, device='cuda'): {n} NCCL rank(s), "
        f"{time.perf_counter() - t0:.1f} s; train LL sharded / single "
        "process: " + ", ".join(f"{m} {a:.6e} / {b:.6e}"
                                for m, (a, b) in lls.items())
        + "; factors bitwise equal on every rank")


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
    ls_round_phase(torch, data, ell, results)
    del ell
    assemble_phase(torch, results)
    small_fit_phase(torch)
    X_new = serving_data(n_items)
    single, ell = {}, {}
    for path in PATHS:
        model, q, info = main_path_phase(torch, X, data, results, path)
        if path == "tncg":
            q_tncg = q
        single[path] = (model.eval_llk(include_missing=True),
                        (model.A == 0).mean(), (model.B == 0).mean())
        ell[path] = single[path] + info
        serving_phase(torch, model, path, X_new, data, q, results)
        if path == "tncg":
            predict_phase(torch, model, X)
        del model
        torch.cuda.empty_cache()
    single_coo = coo_phase(torch, X, data, ell)
    single_f64 = float64_phase(torch, X, data, X_new, q_tncg, ell)
    cascade_phase(torch, X, data)
    routes_phase(torch, X, single)
    shard_kernel_phase(torch, data, results)
    mesh_path_phase(torch, X, single, single_coo, single_f64, results)
    entry_phase(torch)

    # no single PyTorch call computes any of these functions but
    # assemble's group sums (torch.segment_reduce): library_ms null else
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by")
    line = {"kernels": [
        dict(name=name, route="cuda", source=src, replaces=rep,
             **{key: results[name][key] for key in keys},
             library_ms=results[name].get("library_ms"))
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
