"""The benchmark's data generator at a small scale on the CPU: the same
seed gives the same arrays, every range of user ids keeps items, and the
marginals follow the stated laws within a sampling tolerance."""

import math

import numpy as np
import pytest
import torch

from benchmark import data

LAWS = dict(activity_sigma=1.2, popularity_zipf=0.9, oversample=1.25,
            count_mean=8.0)
N_USERS, N_ITEMS, NNZ = 4000, 1500, 40000


@pytest.fixture(scope="module")
def counts():
    return data.synth_counts(2**31 + 77, N_USERS, N_ITEMS, NNZ, LAWS, "cpu")


def test_same_seed_same_arrays(counts):
    again = data.synth_counts(2**31 + 77, N_USERS, N_ITEMS, NNZ, LAWS, "cpu")
    other = data.synth_counts(2**31 + 78, N_USERS, N_ITEMS, NNZ, LAWS, "cpu")
    for a, b in zip(counts, again):
        assert torch.equal(a, b)
    assert not torch.equal(counts[0], other[0])


def test_distinct_sorted_pairs_at_the_target(counts):
    rows, cols, vals = counts
    key = rows * N_ITEMS + cols
    assert rows.shape[0] == NNZ
    assert bool((key[1:] > key[:-1]).all())
    assert int(rows.min()) >= 0 and int(rows.max()) < N_USERS
    assert int(cols.min()) >= 0 and int(cols.max()) < N_ITEMS


def test_every_user_id_range_keeps_items(counts):
    rows = counts[0].numpy()
    per_tenth = np.bincount(rows * 10 // N_USERS, minlength=10)
    # a random cut keeps each tenth of the ids near a tenth of the pairs
    assert per_tenth.min() > 0.7 * NNZ / 10
    assert per_tenth.max() < 1.3 * NNZ / 10


def test_cut_drops_a_random_subset():
    keys = torch.arange(0, 10000, dtype=torch.int64)
    gen = torch.Generator().manual_seed(5)
    kept = data.keep_random(keys, 5000, gen)
    assert kept.shape[0] == 5000 and bool((kept[1:] > kept[:-1]).all())
    halves = torch.bincount(kept // 5000, minlength=2)
    assert abs(int(halves[0]) - 2500) < 200
    assert torch.equal(data.keep_random(keys[:10], 20, gen), keys[:10])


def test_draws_follow_their_weights():
    gen = torch.Generator().manual_seed(3)
    w = torch.tensor([1.0, 2.0, 3.0, 4.0], dtype=torch.float64)
    n = 200_000
    got = torch.bincount(data.draw(w, n, gen), minlength=4).double() / n
    want = w / w.sum()
    sd = (want * (1 - want) / n).sqrt()
    assert bool(((got - want).abs() < 5 * sd).all())


def test_activity_is_lognormal():
    gen = torch.Generator().manual_seed(4)
    logs = data.activity_weights(100_000, 1.2, gen, "cpu").log()
    assert abs(float(logs.mean())) < 5 * 1.2 / math.sqrt(100_000)
    assert abs(float(logs.std()) - 1.2) < 0.02


def test_popularity_is_zipf(counts):
    w = data.popularity_weights(N_ITEMS, 0.9, "cpu")
    slope = (w[99].log() - w[9].log()) / (math.log(100) - math.log(10))
    assert abs(float(slope) + 0.9) < 1e-9
    cols = counts[1].numpy()
    freq = np.bincount(cols, minlength=N_ITEMS).astype(np.float64)
    r = np.arange(20, 400)
    fit = np.polyfit(np.log(r + 1), np.log(freq[r]), 1)[0]
    assert abs(fit + 0.9) < 0.15


def test_counts_are_one_plus_poisson(counts):
    v = counts[2].double() - 1.0
    n = v.shape[0]
    assert float(v.min()) >= 0 and bool((v == v.round()).all())
    assert abs(float(v.mean()) - 8.0) < 5 * math.sqrt(8.0 / n)
    assert abs(float(v.var()) - 8.0) < 0.3


def test_sub_seeds_differ_by_stream_and_seed():
    assert data.sub_seed(1, "a") != data.sub_seed(1, "b")
    assert data.sub_seed(1, "a") != data.sub_seed(2, "a")
    assert data.sub_seed(2**31 + 5, "a") < 2**63


def test_serving_factors_scale_and_zeros():
    A, B = data.serving_factors(9, 500, 300, 50, 0.52, 0.77, 45000.0, "cpu")
    assert abs(float((A == 0).double().mean()) - 0.52) < 0.01
    assert abs(float((B == 0).double().mean()) - 0.77) < 0.01
    total = float((A.double() @ B.double().t()).sum())
    assert abs(total - 45000.0) < 1e-6 * 45000.0


def test_relabel_keeps_the_counts_in_another_order():
    rows, cols, vals = data.synth_counts(3, 300, 120, 3000, LAWS, "cpu")
    gen = torch.Generator().manual_seed(8)
    r2, c2, v2 = data.relabel(rows, cols, vals, 300, 120, gen)
    key = r2 * 120 + c2
    assert bool((key[1:] > key[:-1]).all())
    assert torch.equal(torch.sort(v2).values, torch.sort(vals).values)
    lens = torch.sort(torch.bincount(rows, minlength=300)).values
    assert torch.equal(torch.sort(torch.bincount(r2, minlength=300)).values,
                       lens)
    assert not torch.equal(r2, rows)
    cfg = dict(n_users=300, n_items=120, nnz=3000, data=LAWS)
    a = data.counts_for(11, cfg, "cpu", sample_seed=3)
    b = data.counts_for(12, cfg, "cpu", sample_seed=3)
    assert not torch.equal(a[0], b[0])
    assert torch.equal(torch.sort(torch.bincount(a[0], minlength=300)).values,
                       torch.sort(torch.bincount(b[0], minlength=300)).values)


def test_topn_batches_hold_the_same_lists_for_every_seed():
    from benchmark import core
    from benchmark.kinds import topn

    cell = core.find_cell(core.load_spec(), "tncg-lastfm.topn")
    cell.config.update(n_users=300, n_items=120, nnz=3000, data=LAWS)
    cell.traffic["batch"] = 64

    def lens_by_batch(seed):
        run = core.Run(cell, seed, 0.0, False, "cpu")
        rows = topn.counts(run)[0]
        lens = np.bincount(rows, minlength=300)
        batches = topn.user_batches(run)
        assert sorted(np.concatenate(batches).tolist()) == list(range(300))
        return [tuple(sorted(lens[b])) for b in batches]

    a, b = lens_by_batch(2**31 + 11), lens_by_batch(2**31 + 12)
    assert a != b
    assert sorted(a) == sorted(b)
