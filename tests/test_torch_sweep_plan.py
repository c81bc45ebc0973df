"""PyTorch port: the launch plan of the fgh and hvp plane sweeps
(``poismf_torch/kernels/_lib.py`` ``choose_splits`` and ``sweep_plan``),
the parts that run without a card.

``choose_splits`` cuts a bucket's P slots into splits of whole slot tiles
so that the grid fills whole waves of the card's resident blocks; the
shapes below are the Last.FM-scale buckets the tncg path runs (k=50, bf16:
4-slot tiles of 64 rows, two blocks a SM on 132 SMs)."""

import pytest

torch = pytest.importorskip("torch")

from poismf_torch.kernels import _lib  # noqa: E402

RESIDENT = 2 * 132
TILE = 50 * 4 * 64 * 2 + 4 * 64 * 4


def _splits(P, pt, tiles):
    n_tiles = -(-P // pt)
    return -(-n_tiles // tiles)


def test_largest_bucket_fills_its_waves():
    # P=2048 x 3,840 rows: 60 row tiles, 512 slot tiles; one split (60
    # blocks on 264 places) would leave most of the card idle
    tiles = _lib.choose_splits(60, 2048, 4, RESIDENT, TILE, 2,
                               4 * 101 * 3840)
    blocks = 60 * _splits(2048, 4, tiles)
    waves = -(-blocks // RESIDENT)
    assert blocks / (waves * RESIDENT) >= 0.9


def test_short_wide_bucket_is_not_split():
    # the user side's P=16 x 103,424 rows: 1,616 row tiles fill six waves
    assert _lib.choose_splits(1616, 16, 4, RESIDENT, TILE, 2,
                              4 * 101 * 103424) == 4


def test_few_rows_and_a_long_p_give_many_splits():
    tiles = _lib.choose_splits(1, 4096, 8, 3 * 132, 8 * 1024, 2, 4 * 17 * 64)
    assert _splits(4096, 8, tiles) >= 64


@pytest.mark.parametrize("blocks,P,pt", [
    (1, 1, 1), (1, 3, 4), (7, 37, 4), (60, 2048, 4), (34, 1024, 2),
    (1616, 16, 4), (2, 4096, 8), (500, 64, 8),
])
def test_splits_cover_p_with_whole_tiles_and_none_empty(blocks, P, pt):
    tiles = _lib.choose_splits(blocks, P, pt, RESIDENT, TILE, 2, 4096)
    per = tiles * pt  # slots per split: whole tiles
    splits = -(-P // per)
    assert 1 <= tiles <= -(-P // pt)
    assert splits * per >= P
    assert (splits - 1) * per < P  # the last split holds a slot


@pytest.mark.parametrize("kernel", ["fgh", "hvp"])
@pytest.mark.parametrize("R", [100, 12, 1])
def test_plan_refuses_rows_the_copies_cannot_take(kernel, R):
    bg = torch.zeros((2, 4, R))
    with pytest.raises(ValueError, match="multiple of 8"):
        _lib.sweep_plan(kernel, bg, torch.zeros((4, R)))
