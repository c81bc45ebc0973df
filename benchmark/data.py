"""The benchmark's inputs, made on the device from ``--seed``: the
Last.FM-360K-shaped counts, the fit's initial factors, the serving
factors, and the streams that order users and draw new histories.

The counts follow the laws of ``synth_lastfm_like`` (the old JAX
benchmark's generator): user activity lognormal(0, 1.2), item popularity
Zipf(0.9), 1.25x oversampled pairs deduplicated down to the target, and
counts 1 + Poisson(8).  Two departures, both on purpose: every draw is a
``torch.Generator`` on the device (seconds, not the 23 s of NumPy), and
the cut to the target drops a seeded random subset of the distinct pairs
rather than the pairs with the highest keys, so no range of user ids is
emptied.
"""

from __future__ import annotations

import hashlib

import torch


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream ``tag`` of the run seeded ``seed``:
    the streams are independent, and each depends on the seed alone."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def activity_weights(n_users: int, sigma: float, gen, device):
    """Each user's share of the draws: lognormal(0, ``sigma``)."""
    w = torch.empty(n_users, dtype=torch.float64, device=device)
    return w.log_normal_(0.0, sigma, generator=gen)


def popularity_weights(n_items: int, zipf: float, device):
    """Item ``i``'s share of the draws: (i + 1) ** -zipf."""
    return torch.arange(1, n_items + 1, dtype=torch.float64,
                        device=device) ** -zipf


def draw(weights: torch.Tensor, n: int, gen) -> torch.Tensor:
    """``n`` ids drawn with replacement in proportion to ``weights``, by
    the inverse of their cumulative distribution."""
    cdf = torch.cumsum(weights, 0)
    cdf = cdf / cdf[-1]
    u = torch.rand(n, dtype=torch.float64, generator=gen,
                   device=weights.device)
    idx = torch.searchsorted(cdf, u, right=True)
    return idx.clamp_(max=weights.shape[0] - 1)


def keep_random(keys: torch.Tensor, n: int, gen) -> torch.Tensor:
    """A seeded random subset of ``n`` of the distinct sorted ``keys``,
    sorted again (all of them when there are no more than ``n``)."""
    if keys.shape[0] <= n:
        return keys
    pick = torch.randperm(keys.shape[0], generator=gen,
                          device=keys.device)[:n]
    return keys[pick].sort().values


def synth_counts(seed: int, n_users: int, n_items: int, nnz: int, data: dict,
                 device):
    """(rows int64, cols int64, vals float32) on ``device``, sorted by
    (row, col), distinct pairs, ``nnz`` of them at most.  ``data`` holds
    the laws: ``activity_sigma``, ``popularity_zipf``, ``oversample``,
    ``count_mean``."""
    gen = generator(seed, "counts", device)
    over = int(nnz * float(data["oversample"]))
    user_w = activity_weights(n_users, float(data["activity_sigma"]), gen,
                              device)
    item_w = popularity_weights(n_items, float(data["popularity_zipf"]),
                                device)
    rows = draw(user_w, over, gen)
    cols = draw(item_w, over, gen)
    keys = keep_random(torch.unique(rows * n_items + cols), nnz, gen)
    rows, cols = keys // n_items, keys % n_items
    mean = torch.full((keys.shape[0],), float(data["count_mean"]),
                      dtype=torch.float32, device=device)
    vals = 1.0 + torch.poisson(mean, generator=gen)
    return rows, cols, vals


def relabel_perms(n_users: int, n_items: int, gen, device):
    """(user ids' permutation, item ids' permutation) that ``relabel``
    draws from ``gen``: sample id ``u`` becomes ``pu[u]``."""
    pu = torch.randperm(n_users, generator=gen, device=device)
    pi = torch.randperm(n_items, generator=gen, device=device)
    return pu, pi


def relabel(rows, cols, vals, n_users: int, n_items: int, gen):
    """The pairs under seeded permutations of the user ids and of the item
    ids, sorted by (row, col) again: the same counts, in another order."""
    pu, pi = relabel_perms(n_users, n_items, gen, rows.device)
    rows, cols = pu[rows], pi[cols]
    order = torch.argsort(rows * n_items + cols)
    return rows[order], cols[order], vals[order]


def counts_for(seed: int, config: dict, device, sample_seed: int):
    """The run's counts: the sample drawn from ``sample_seed``, relabelled
    from ``seed`` (every run seed gets the same rows and columns, in
    another order, so the same work)."""
    c = config
    rows, cols, vals = synth_counts(int(sample_seed), c["n_users"],
                                    c["n_items"], c["nnz"], c["data"],
                                    device)
    return relabel(rows, cols, vals, c["n_users"], c["n_items"],
                   relabel_gen(seed, device))


def relabel_gen(seed: int, device) -> torch.Generator:
    """The stream ``counts_for`` relabels the run ``seed``'s counts from."""
    return generator(seed, "relabel", device)


def init_factors(seed: int, tag: str, n_rows: int, n_rows_pad: int, k: int,
                 device) -> torch.Tensor:
    """The fit's initial factors: 0.3 + U(0, 0.01), padded rows zero, in
    float32 (the distribution of the port's
    ``train.initialize_factors_device``, drawn here)."""
    gen = generator(seed, tag, device)
    M = 0.3 + 0.01 * torch.rand((n_rows_pad, k), generator=gen,
                                dtype=torch.float32, device=device)
    M[n_rows:] = 0.0
    return M


def serving_factors(seed: int, n_users: int, n_items: int, k: int,
                    zeros_a: float, zeros_b: float, total: float,
                    device) -> tuple:
    """Seeded non-negative factors (A [n_users, k], B [n_items, k],
    float32): U(0, 1) entries, each exactly zero with probability
    ``zeros_a`` / ``zeros_b``, then both scaled alike so that the
    predictions over all pairs sum to ``total``, the data's total count,
    as a fitted Poisson factorization's do."""
    gen = generator(seed, "serving", device)

    def one(n, zeros):
        M = torch.rand((n, k), generator=gen, dtype=torch.float32,
                       device=device)
        keep = torch.rand((n, k), generator=gen, dtype=torch.float32,
                          device=device) >= zeros
        return torch.where(keep, M, 0.0)

    A, B = one(n_users, zeros_a), one(n_items, zeros_b)
    mass = A.to(torch.float64).sum(0) @ B.to(torch.float64).sum(0)
    c = float((total / mass) ** 0.5)
    return A * c, B * c


def csr(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
        n_rows: int):
    """(indptr [n_rows + 1], cols, vals) of pairs sorted by row; a stable
    sort first where they are not."""
    if rows.shape[0] > 1 and not bool((rows[1:] >= rows[:-1]).all()):
        order = torch.sort(rows, stable=True).indices
        rows, cols, vals = rows[order], cols[order], vals[order]
    counts = torch.bincount(rows, minlength=n_rows)
    indptr = torch.zeros(n_rows + 1, dtype=torch.int64, device=rows.device)
    indptr[1:] = torch.cumsum(counts, 0)
    return indptr, cols, vals
