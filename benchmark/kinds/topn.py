"""A batch recommendation job: every user ranked in closed-loop batches
through ``PoisMF.topN_batched(users, n, exclude_seen=True)`` until
``--seconds`` have passed (the batches repeat once they are used up).

Every seed does the same work in another order: the counts are the
mix's ``sample_seed`` sample with users and items relabelled from the
run's seed (``data.counts_for``), and the batches are the sample's users
cut in one fixed order drawn from ``sample_seed``, under the run's
relabelling, ranked in an order of batches drawn from the run's seed.
So every seed ranks batches of the same lists, padded to the same
lengths on the host, as a random order of users gives them.  The window
notes each request's latency percentiles and the requests in each
quarter of the window on standard error.  The rate, users over the
window's wall, is bound by the host thread's speed, which wanders from
run to run by 10-30% on a shared host; the cell's end-to-end metric is
the card's kernel time per 1,000 users, from the trace that each of its
runs takes.

The model serves seeded factors through
``io.checkpoint.model_from_numpy``; the ingested by-user counts are
attached where ``PoisMF.fit`` keeps them (``_by_user``), since the port
has no public way to give a restored model its training data.  Warm-up
ranks the batch that holds the heaviest user (which also builds the
model's host list of seen items, as a first call does).

The check takes a seeded sample of the ranked users, the heaviest among
them, and judges each one's last list against float64 scores with the
user's seen items left out (``reference.ranking.rank_gap``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import data, faults
from ..reference import ranking

FAULTS = ("half", "altered")
fault = faults.topn
TINY = {"n_users": 200, "n_items": 80, "nnz": 2000}


def serving_model(run, host):
    """(model, A, B): the seeded factors on the card and a port model
    serving them."""
    from poismf_torch.io.checkpoint import model_from_numpy

    c = run.config
    sf = c["serving_factors"]
    A, B = data.serving_factors(run.seed, c["n_users"], c["n_items"],
                                int(c["k"]), float(sf["zeros_a"]),
                                float(sf["zeros_b"]),
                                float(host[2].sum(dtype=np.float64)),
                                run.device)
    model = model_from_numpy(
        A.cpu().numpy(), B.cpu().numpy(), device=run.device, k=int(c["k"]),
        method=c["method"], l2_reg=float(c["l2_reg"]),
        l1_reg=float(c["l1_reg"]), maxupd=int(c["maxupd"]),
        reuse_prev=bool(c["reuse_prev"]))
    return model, A, B


def counts(run):
    c = run.config
    rows, cols, vals = data.counts_for(run.seed, c, run.device,
                                       run.traffic["sample_seed"])
    run.shape.update(n_users=c["n_users"], n_items=c["n_items"],
                     nnz=int(rows.shape[0]), k=int(c["k"]))
    return (rows.to(torch.int32).cpu().numpy(),
            cols.to(torch.int32).cpu().numpy(), vals.cpu().numpy())


def setup(run):
    from poismf_torch import sparse

    c, t = run.config, run.traffic
    host = counts(run)
    tm = time.perf_counter()
    ing = sparse.ingest((*host, (c["n_users"], c["n_items"])),
                        reindex=False)
    run.setup["ingest_s"] = time.perf_counter() - tm
    model, A, B = serving_model(run, host)
    model._by_user = ing.by_user
    batches = user_batches(run)
    heaviest = int(np.argmax(np.bincount(host[0], minlength=c["n_users"])))
    heavy = next(b for b in batches if heaviest in b)
    model.topN_batched(heavy, n=int(t["n"]), exclude_seen=True)
    return dict(host=host, model=model, A=A, B=B, batches=batches)


def user_batches(run):
    """The window's batches of user ids, in the order they are ranked:
    the ``sample_seed`` sample's users cut into batches of ``batch`` in
    one order drawn from ``sample_seed``, relabelled as the run's counts
    are, the batches' order drawn from the run's seed."""
    c, t, dev = run.config, run.traffic, run.device
    n, batch = c["n_users"], int(t["batch"])
    fixed = torch.randperm(n, generator=data.generator(
        t["sample_seed"], "topn.batches", dev), device=dev)
    pu, _ = data.relabel_perms(n, c["n_items"],
                               data.relabel_gen(run.seed, dev), dev)
    users = pu[fixed].cpu().numpy()
    cut = [users[s:s + batch] for s in range(0, n, batch)]
    order = torch.randperm(len(cut), generator=data.generator(
        run.seed, "topn.order", dev), device=dev).tolist()
    return [cut[i] for i in order]


def window(run, st, fault=None):
    t = run.traffic
    model, cut = st["model"], st["batches"]
    n = int(t["n"])
    call = model.topN_batched if fault is None else fault(model.topN_batched)
    answers, ends, users, batches, failed = [], [], 0, 0, 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        uu = cut[batches % len(cut)]
        idx = call(uu, n=n, exclude_seen=True)
        ends.append(time.perf_counter())
        answers.append((uu, idx))
        users += uu.shape[0]
        batches += 1
        failed += int(np.count_nonzero((idx < 0).any(1)))
    window_s = time.perf_counter() - t0
    lat_ms = 1e3 * np.diff(np.concatenate([[t0], ends]))
    run.window.update(window_s=window_s, users=users, batches=batches,
                      attempted=users, failed=failed, answers=answers)
    quarters = np.searchsorted(np.asarray(ends) - t0,
                               window_s * np.arange(1, 4) / 4)
    per_q = np.diff(np.concatenate([[0], quarters, [batches]]))
    run.note("topn window: {} requests; latency ms p10 {:.3f} p50 {:.3f} "
             "p90 {:.3f} max {:.3f}; requests a quarter {}".format(
                 batches, *np.percentile(lat_ms, [10, 50, 90]),
                 lat_ms.max(), per_q.tolist()))


def release(run, st):
    return dict(host=st["host"], A=st["A"], B=st["B"],
                answers=run.window.pop("answers"))


def check(run, j, judge="program"):
    c, t = run.config, run.traffic
    dev = run.device
    n = int(t["n"])
    last = {}
    for uu, idx in j["answers"]:
        for u, row in zip(uu.tolist(), idx):
            last[u] = row
    ranked = np.fromiter(last.keys(), dtype=np.int64)
    lens = np.bincount(j["host"][0], minlength=c["n_users"])
    gen = data.generator(run.seed, "check.users", dev)
    pick = torch.randperm(ranked.shape[0], generator=gen, device=dev)
    pick = ranked[pick[:int(t["check_users"])].cpu().numpy()]
    heavy = ranked[np.argsort(-lens[ranked], kind="stable")[
        :int(t["check_heavy"])]]
    sample = np.unique(np.concatenate([pick, heavy]))
    rows, cols = (torch.from_numpy(a.astype(np.int64)).to(dev)
                  for a in j["host"][:2])
    worst = 0.0
    step = 512
    for s in range(0, sample.shape[0], step):
        uu = sample[s:s + step]
        u_t = torch.from_numpy(uu).to(dev)
        sel = torch.isin(rows, u_t)
        local = torch.searchsorted(u_t, rows[sel])
        seen = torch.zeros((uu.shape[0], c["n_items"]), dtype=torch.bool,
                           device=dev)
        seen[local, cols[sel]] = True
        A = j["A"][u_t]
        if judge == "program":
            got = torch.from_numpy(np.stack([last[u] for u in uu])).to(dev)
        else:
            _, got = ranking.topn_lowp(A, j["B"], n,
                                       getattr(torch, t["control_dtype"]),
                                       seen)
        gap = ranking.rank_gap(A, j["B"], got.to(torch.int64), seen)
        worst = max(worst, float(gap.max()))
    run.note(f"rank_gap: {sample.shape[0]} users judged of "
             f"{ranked.shape[0]} ranked")
    return [("rank_gap", worst, float(run.cell.limits["rank_gap"]))]


def end_to_end(run):
    # the cell's end-to-end time is the card's kernels' (metrics/
    # topn_kernel_ms_per_kuser.py); the host-bound rate is per layer
    # (metrics/topn.users_per_s.py)
    return {}
