"""One full-length record of a fit configuration, outside the cells: the
published number of epochs (the configuration's ``published.niter``),
once, on the data of ``--seed``, with each epoch's seconds (the card
synchronised at its end), the wall, and the training Poisson
log-likelihood of the result (without the log-factorial term), computed
here in float64.

    python benchmark/full_length.py --config tncg-lastfm --seed 1
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import env  # noqa: E402

env.pin_caches()


def train_llk(A, B, rows, cols, vals) -> float:
    """sum x log(a.b) - sum_u a_u . colsums(B), in float64 by chunks."""
    import torch

    A64, B64 = A.to(torch.float64), B.to(torch.float64)
    ll = -float(A64.sum(0) @ B64.sum(0))
    step = 1 << 22
    for s in range(0, rows.shape[0], step):
        r, c = rows[s:s + step], cols[s:s + step]
        pred = (A64[r] * B64[c]).sum(1)
        ll += float((vals[s:s + step].to(torch.float64)
                     * torch.log(pred)).sum())
    return ll


def main(argv=None):
    import dataclasses

    import torch

    from benchmark import core, data
    from benchmark.kinds import fit as fk
    from poismf_torch import sparse, train

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    spec = core.load_spec()
    entry = {c["name"]: c for c in spec["configs"]}[args.config]
    with open(ROOT / entry["file"]) as f:
        cfg = json.load(f)
    dev = "cuda"
    rows, cols, vals = data.synth_counts(args.seed, cfg["n_users"],
                                         cfg["n_items"], cfg["nnz"],
                                         cfg["data"], dev)
    host = (rows.to(torch.int32).cpu().numpy(),
            cols.to(torch.int32).cpu().numpy(), vals.cpu().numpy())
    ing = sparse.ingest((*host, (cfg["n_users"], cfg["n_items"])),
                        reindex=False)
    k = int(cfg["k"])
    A0 = data.init_factors(args.seed, "init.A", cfg["n_users"],
                           ing.by_user.n_rows_pad, k, dev)
    B0 = data.init_factors(args.seed, "init.B", cfg["n_items"],
                           ing.by_item.n_rows_pad, k, dev)
    train.ell_pair_cached(ing.by_user, ing.by_item, A0.device)
    p = dataclasses.replace(fk.params(cfg),
                            niter=int(cfg["published"]["niter"]))
    train.CASCADE_TRACE = []
    epochs, marks = [], [0]

    def callback(epoch, A, B):
        torch.cuda.synchronize()
        t = time.perf_counter()
        epochs.append(t - marks[0])
        marks[0] = t

    torch.cuda.synchronize()
    t0 = marks[0] = time.perf_counter()
    A, B, status = train.run_poismf(A0, B0, ing.by_user, ing.by_item, p,
                                    callback=callback)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rounds = [r.structure for r in train.CASCADE_TRACE]
    n_u, n_i = cfg["n_users"], cfg["n_items"]
    out = dict(
        config=args.config, seed=args.seed, niter=p.niter, status=status,
        wall_s=wall, epoch_s=epochs,
        train_llk=train_llk(A[:n_u], B[:n_i], rows, cols, vals),
        init_llk=train_llk(A0[:n_u], B0[:n_i], rows, cols, vals),
        zeros_A=float((A[:n_u] == 0).double().mean()),
        zeros_B=float((B[:n_i] == 0).double().mean()),
        rounds=len(rounds),
        compact_rounds=sum(r.startswith("compact") for r in rounds),
        profile_rounds=sum(r == "compact/0" for r in rounds),
        device=torch.cuda.get_device_name(),
        peak_bytes=torch.cuda.max_memory_allocated())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
