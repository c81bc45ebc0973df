"""Fits back to back: ``train.run_poismf`` (the call ``PoisMF.fit`` makes
after ingest) on one ``CountsMatrix`` pair, each fit from the same seeded
init, until ``--seconds`` have passed; the fit in progress is finished.

Set-up makes the counts on the card (the mix's ``sample_seed`` sample,
its users and items relabelled from the run's seed, so that every seed
gives the same work), ingests them on the host and builds
the ELL pair (both timed apart), draws the init, and warms up with a
one-epoch fit of a few updates, after which the pair's cascade state is
dropped: the window's first fit is a user's first fit, and the later
ones find the plans it built, as a refit on the same data does.

The check judges the window's last fit on a seeded sample of rows of
each side, the longest among them (every row with nonzeros where the
mix's ``check_users`` / ``check_items`` exceed a side's rows), in two
ways, each as the method's solver entry (``fit_solvers/<method>.py``)
says.

* The kernels' evaluation: the first objective evaluation of each half
  (the solver entry's ``EVALUATED``: tncg's fgh sweep, cg's fg probe) is
  kept for the sampled rows as the solver got it (tncg and cg: ``f`` and
  its gradient); the reference evaluates the same rows at the same
  point, in float64 from the raw counts (tncg and cg: ``grad_err``, the
  widest gradient gap, as a share of the linear term's norm).  The last
  epoch's halves start from the state the driver's per-epoch callback
  hands over after the epoch before.
* The halves' outcome, followed from that state against the reference's
  solve from the same start (the entry's ``OUTCOME``: tncg's items
  against each row's exact minimiser, its users against the published
  truncated Newton, cg's halves against the published CG, pg's halves
  against the published proximal step).  Each solve is told the half it
  stands for (:class:`Half`: its side, the judged epoch and the run's
  configuration), which a solver whose steps follow a schedule, as pg's
  do, needs to work the step out again.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import data, faults
from ..reference import rows as ref
from . import fit_solvers

SIDES = ("items", "users")
FAULTS = ("unchanged", "half", "altered", "unchanged.users", "half.users")
fault = faults.fit
# a tiny problem in the regime of the full one: the data terms outweigh
# the l2 penalty, as they do at 17.2M nonzeros
TINY = {"n_users": 200, "n_items": 80, "nnz": 2000, "l2_reg": 1.0,
        "niter": 2}


@dataclasses.dataclass(frozen=True)
class Half:
    """The half that an outcome solve stands for: its ``side`` ("items"
    or "users"), the judged ``epoch`` (from 0; the window's callback keeps
    the start after the epoch before, so ``niter - 1``) and the run's
    ``config``."""

    side: str
    epoch: int
    config: dict


def params(config: dict):
    """The fit's ``FitParams``; ``initial_step`` (pg's first step) only
    where the configuration states it."""
    from poismf_torch.train import FitParams

    stated = {}
    if "initial_step" in config:
        stated["initial_step"] = float(config["initial_step"])
    return FitParams(
        k=int(config["k"]), method=config["method"],
        l2_reg=float(config["l2_reg"]), l1_reg=float(config["l1_reg"]),
        niter=int(config["niter"]), maxupd=int(config["maxupd"]),
        reuse_prev=bool(config["reuse_prev"]),
        early_stop=bool(config["early_stop"]), layout=config["layout"],
        plane_dtype=config["plane_dtype"], **stated)


def _sample(lens, n_sample, n_heavy, gen):
    """A seeded sample of the rows with nonzeros, and the longest rows."""
    has = torch.nonzero(lens > 0).squeeze(1)
    pick = has[torch.randperm(has.shape[0], generator=gen,
                              device=has.device)[:n_sample]]
    heavy = torch.topk(lens, min(n_heavy, lens.shape[0])).indices
    return torch.unique(torch.cat([pick, heavy]))


class FirstEvaluation:
    """While installed, keeps the sampled rows of each half's first
    objective evaluation on a full ELL (the next call of the solver
    entry's ``EVALUATED`` after that half's plane gather), as the entry's
    ``keep`` says, on the card (no sync)."""

    def __init__(self, solver, sides: dict):
        self.fn = solver.EVALUATED
        self.keep = solver.keep
        self.sides = sides  # id(ell) -> (side, positions in ELL order)
        self.armed = set()
        self.got = {}

    def __enter__(self):
        from poismf_torch.ops import ell as ell_ops

        self._gather = ell_ops.gather_planes
        self._eval = getattr(ell_ops, self.fn)

        def gather(M, ell, *a, **kw):
            if id(ell) in self.sides:
                self.armed.add(id(ell))
            return self._gather(M, ell, *a, **kw)

        def evaluate(x, planes, ell, *a, **kw):
            out = self._eval(x, planes, ell, *a, **kw)
            if id(ell) in self.armed:
                self.armed.discard(id(ell))
                side, pos = self.sides[id(ell)]
                self.got[side] = self.keep(x, out, pos)
            return out

        ell_ops.gather_planes = gather
        setattr(ell_ops, self.fn, evaluate)
        return self

    def __exit__(self, *exc):
        from poismf_torch.ops import ell as ell_ops

        ell_ops.gather_planes = self._gather
        setattr(ell_ops, self.fn, self._eval)
        return False


def setup(run):
    import dataclasses

    from poismf_torch import sparse, train

    c, t, dev = run.config, run.traffic, run.device
    solver = fit_solvers.load(c["method"])
    rows, cols, vals = data.counts_for(run.seed, c, dev,
                                       t["sample_seed"])
    run.shape.update(n_users=c["n_users"], n_items=c["n_items"],
                     nnz=int(rows.shape[0]), k=int(c["k"]))
    gen = data.generator(run.seed, "check.rows", dev)
    sample = {
        "items": _sample(torch.bincount(cols, minlength=c["n_items"]),
                         int(t["check_items"]), int(t["check_heavy"]), gen),
        "users": _sample(torch.bincount(rows, minlength=c["n_users"]),
                         int(t["check_users"]), int(t["check_heavy"]), gen)}
    host = (rows.to(torch.int32).cpu().numpy(),
            cols.to(torch.int32).cpu().numpy(), vals.cpu().numpy())
    del rows, cols, vals
    tm = time.perf_counter()
    ing = sparse.ingest((*host, (c["n_users"], c["n_items"])),
                        reindex=False)
    run.setup["ingest_s"] = time.perf_counter() - tm
    k = int(c["k"])
    A0 = data.init_factors(run.seed, "init.A", c["n_users"],
                           ing.by_user.n_rows_pad, k, dev)
    B0 = data.init_factors(run.seed, "init.B", c["n_items"],
                           ing.by_item.n_rows_pad, k, dev)
    # the pair is cached under the fit's device as the driver names it
    # ("cuda:0", not "cuda"), so that the fits find this one
    tm = time.perf_counter()
    ell_user, ell_item = train.ell_pair_cached(ing.by_user, ing.by_item,
                                               A0.device)
    if dev.startswith("cuda"):
        torch.cuda.synchronize()
    run.setup["ell_build_s"] = time.perf_counter() - tm
    p = params(c)
    warm = dataclasses.replace(p, niter=1, maxupd=int(t["warmup_maxupd"]))
    train.run_poismf(A0, B0, ing.by_user, ing.by_item, warm)
    found = train.ell_pair_cached(ing.by_user, ing.by_item, A0.device)
    if found[0] is not ell_user or found[1] is not ell_item:
        raise RuntimeError("the warm-up fit did not find the set-up's pair")
    for ell in (ell_user, ell_item):
        ell.host.pop("cascade", None)
    sides = {id(ell_item): ("items", ell_item.inv_perm[sample["items"]]),
             id(ell_user): ("users", ell_user.inv_perm[sample["users"]])}
    return dict(host=host, ing=ing, pair=(ell_user, ell_item), A0=A0, B0=B0,
                p=p, sample=sample, sides=sides, solver=solver)


def window(run, st, fault=None):
    from poismf_torch import train

    p, ing = st["p"], st["ing"]
    call = train.run_poismf if fault is None else fault(train.run_poismf)
    keep, fits = {}, []
    epochs = 0

    def callback(epoch, A, B):
        nonlocal epochs
        epochs += 1
        if epoch == p.niter - 2:
            keep["start"] = (A, B)

    if run.trace:
        train.CASCADE_TRACE = []
    sync = run.device.startswith("cuda")
    spy = FirstEvaluation(st["solver"], st["sides"])
    t0 = time.perf_counter()
    try:
        with spy:
            while True:
                ts = time.perf_counter()
                n0 = (0 if train.CASCADE_TRACE is None
                      else len(train.CASCADE_TRACE))
                keep.pop("start", None)
                A, B, status = call(st["A0"], st["B0"], ing.by_user,
                                    ing.by_item, p, callback=callback)
                if sync:
                    torch.cuda.synchronize()
                fit = dict(s=time.perf_counter() - ts, status=int(status))
                if train.CASCADE_TRACE is not None:
                    fit["rounds"] = [r.structure for r in
                                     train.CASCADE_TRACE[n0:]]
                fits.append(fit)
                if time.perf_counter() - t0 >= run.seconds:
                    break
        window_s = time.perf_counter() - t0
        cascade = train.CASCADE_TRACE
    finally:
        train.CASCADE_TRACE = None
    start = keep.get("start", (st["A0"], st["B0"]))
    run.window.update(
        window_s=window_s, epochs=epochs, fits=fits, cascade=cascade,
        attempted=len(fits), failed=sum(f["status"] != 0 for f in fits),
        result=(start, (A, B), spy.got))
    for i, f in enumerate(fits):
        line = f"fit {i}: {f['s']:.4f} s, status {f['status']}"
        if "rounds" in f:
            n = len(f["rounds"])
            prof = sum(r == "compact/0" for r in f["rounds"])
            comp = sum(r.startswith("compact") for r in f["rounds"])
            line += (f", rounds {n} (compact {comp}, on profile plans "
                     f"{prof})")
        run.note(line)


def release(run, st):
    (A_s, B_s), (A, B), got = run.window.pop("result")
    return dict(host=st["host"], sample=st["sample"], A_s=A_s, B_s=B_s, A=A,
                B=B, got=got)


def planted(j: dict, name: str) -> dict:
    """The answers ``j`` of a sound run as a run with the user-half fault
    ``name`` (``faults.users_only``) returns them."""
    return dict(j, A=faults.users_only(name, j["A"], j["A_s"]))


def _outcome_gap(groups, bests, start, judged, s, l2, solve, how, compare,
                 maxupd, half, fixed_low):
    """(number, detail) of one half's outcome over its groups, the judged
    end against the reference's (``bests``, a group each), compared as
    ``compare`` says: by the objective sums at the start, at the judged
    end and at the reference's end, over the reference's decrease
    ("signed", "absolute", "shortfall"); or row by row ("rows": the
    widest distance between a row's two ends, over the larger of that
    row's move from the start in the reference and the median row's).
    With ``fixed_low`` the reference in that precision (``solve(how, ...,
    half)``) is judged in the program's place."""
    f_start = f_judged = f_ref = short = 0.0
    gaps, moves = [], []
    for g, best in zip(groups, bests):
        x0 = start[g.rows].to(torch.float64)
        if fixed_low is None:
            mine = judged[g.rows]
        else:
            mine = solve(how, ref.regather(g, fixed_low), x0, s, l2, maxupd,
                         half)
        if compare == "rows":
            gaps.append((mine.to(torch.float64) - best).norm(dim=1))
            moves.append((best - x0).norm(dim=1))
            continue
        fs, fj, fr = (ref.objective(g, x, s, l2) for x in (x0, mine, best))
        f_start += float(fs.sum())
        f_judged += float(fj.sum())
        f_ref += float(fr.sum())
        short += float((fj - fr).clamp_min(0.0).sum())
    if compare == "rows":
        gap, move = torch.cat(gaps), torch.cat(moves)
        median = float(move.median())
        share = gap / move.clamp_min(median)
        num = float(share.max())
        return (num if np.isfinite(num) else float("inf"),
                dict(median_move=median, median_gap=float(gap.median()),
                     widest_share=num))
    gap = {"signed": f_judged - f_ref, "absolute": abs(f_judged - f_ref),
           "shortfall": short}[compare]
    num = gap / (f_start - f_ref)
    return (num if np.isfinite(num) else float("inf"),
            dict(f_start=f_start, f_judged=f_judged, f_ref=f_ref))


def check(run, j, judge="program"):
    c, t, dev = run.config, run.traffic, run.device
    rows, cols, vals = (torch.from_numpy(a).to(dev) for a in j["host"])
    rows, cols = rows.to(torch.int64), cols.to(torch.int64)
    u_ptr, u_cols, u_vals = data.csr(rows, cols, vals, c["n_users"])
    i_ptr, i_cols, i_vals = data.csr(cols, rows, vals, c["n_items"])
    l2, l1 = float(c["l2_reg"]), float(c["l1_reg"])
    solver, maxupd = fit_solvers.load(c["method"]), int(c["maxupd"])
    low = getattr(torch, t["control_dtype"])
    n_u, n_i = c["n_users"], c["n_items"]
    halves = {
        # the item half: items against the users' rows at its start
        "items": (i_ptr, i_cols, i_vals, j["A_s"][:n_u], u_ptr, j["B_s"],
                  j["B"]),
        # the user half: users against the items' final rows
        "users": (u_ptr, u_cols, u_vals, j["B"][:n_i], i_ptr, j["A_s"],
                  j["A"]),
    }
    memo = j.setdefault("memo", {})
    out = []
    for side in SIDES:
        half = Half(side, int(c["niter"]) - 1, c)
        ptr, idx, v, fixed, fixed_ptr, start, judged = halves[side]
        sample = j["sample"][side]
        F = fixed.to(torch.float64)
        s = F[fixed_ptr[1:] > fixed_ptr[:-1]].sum(0) + l1
        # the reference's ends are the same whoever is judged: solved once
        if side not in memo:
            memo[side] = ref.make_groups(sample, ptr, idx, v, F), {}
        groups, ends = memo[side]
        low_F = ref.round_fixed(fixed, low) if judge == "control" else None
        ev = solver.evaluation(groups, sample, j["got"].get(side), start, s,
                               l2, low_F)
        lim = run.cell.limits
        label = f"{solver.EVALUATION}.{side}"
        out.append((label, ev, float(lim[label])))
        for label, how, compare in solver.OUTCOME[side]:
            if how not in ends:
                ends[how] = [solver.solve(
                    how, g, start[g.rows].to(torch.float64), s, l2, maxupd,
                    half) for g in groups]
            num, detail = _outcome_gap(groups, ends[how], start, judged, s,
                                       l2, solver.solve, how, compare, maxupd,
                                       half, low_F)
            if judge == "program" and not bool(torch.isfinite(judged).all()):
                num = float("inf")
            run.note(f"{label}.{side}: rows {int(sample.shape[0])}, "
                     + ", ".join(f"{k} {v!r}" for k, v in detail.items()))
            out.append((f"{label}.{side}", num,
                        float(lim[f"{label}.{side}"])))
    return out


def end_to_end(run):
    return {"fit_epoch_s": run.window["window_s"] / max(run.window["epochs"],
                                                         1)}
