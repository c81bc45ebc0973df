"""PyTorch port: the launch plans of the plane sweeps fgh, hvp, fg, f and
pg (``poismf_torch/kernels/_lib.py`` ``choose_splits`` and ``sweep_plan``)
and of the ray kernel (``ray_plan``: raygtd, ray and rayf), the parts that
run without a card, and the refusals the wrappers raise before the kernel
library is loaded.

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


@pytest.mark.parametrize("warps,blocks,want", [
    # pg at k=10 in bf16: 2 k groups (4 warps), 3 blocks an SM at 8-slot
    # tiles, 7 at 4-slot ones: the tile is halved once
    (4, {8: 3, 4: 7, 2: 12, 1: 16}, 4),
    # fgh / hvp / fg at k=50 in bf16: 7 k groups, 2 blocks: kept
    (14, {4: 2, 2: 3, 1: 4}, 4),
    # one k group (k <= 8), few blocks even at small tiles: down to 1
    (2, {8: 2, 4: 3, 2: 4, 1: 6}, 1),
])
def test_shrink_tile_halves_until_the_sms_hold_enough_warps(warps, blocks,
                                                             want):
    asked = []

    def blocks_at(pt):
        asked.append(pt)
        return blocks[pt]

    start = max(blocks)
    assert _lib.shrink_tile(start, warps, blocks_at) == want
    assert asked[-1] == want  # the occupancy read last is the tile's
    assert blocks[want] * warps >= _lib.SWEEP_MIN_WARPS or want == 1


@pytest.mark.parametrize("kernel", ["fgh", "hvp", "fg", "f", "pg"])
@pytest.mark.parametrize("R", [100, 12, 1])
def test_plan_refuses_rows_the_copies_cannot_take(kernel, R):
    bg = torch.zeros((2, 4, R))
    with pytest.raises(ValueError, match="multiple of 8"):
        _lib.sweep_plan(kernel, bg, torch.zeros((4, R)))


@pytest.mark.parametrize("kernel", ["fg", "f", "pg"])
def test_plan_refuses_planes_that_are_not_16_byte_aligned(kernel):
    bg = torch.zeros(2 * 4 * 16 + 1)[1:].view(2, 4, 16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        _lib.sweep_plan(kernel, bg, torch.zeros((4, 16)))
    with pytest.raises(ValueError, match="16-byte aligned"):
        _lib.sweep_plan(kernel, torch.zeros((2, 4, 16)),
                        torch.zeros(4 * 16 + 1)[1:].view(4, 16))


@pytest.mark.parametrize("kernel,k,rows", [
    ("fgh", 50, 101), ("hvp", 50, 50), ("fg", 50, 51), ("f", 50, 1),
    ("fg", 1, 2), ("f", 200, 1), ("pg", 10, 10), ("pg", 1, 1),
])
def test_sweep_output_rows(kernel, k, rows):
    # rows of the [out_rows, R] block each split writes and sum_splits adds
    assert _lib.SWEEP_OUT_ROWS[kernel](k) == rows


SMS = 132


def _ray(C, P, R, sums=2):
    plan = _lib.ray_plan(C, P, R, SMS, sums)
    tiles = -(-R // _lib.RAY_TILE_R)
    return plan, tiles * plan.splits, tiles * plan.splits * plan.warps


@pytest.mark.parametrize("sums", [2, 1], ids=["raygtd", "rayf"])
@pytest.mark.parametrize("C", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("P,R", [
    (1, 8), (3, 128), (37, 256), (64, 96), (16, 103424), (32, 82048),
    (256, 8192), (2048, 256), (2048, 3840), (4096, 64), (100000, 8),
])
def test_ray_plan_covers_p_within_the_kernels_limits(C, P, R, sums):
    plan, _, _ = _ray(C, P, R, sums)
    assert plan.warps in (1, 2, 4, 8)
    # the block's sums, W x sums x C x 32 lanes x 16 bytes, fit in 48 KB
    ct = 1 if C == 1 else 2 if C == 2 else 4 if C <= 4 else 8
    assert plan.warps == 1 or plan.warps * sums * ct * 32 * 16 <= 48 * 1024
    assert 1 <= plan.splits <= _lib.RAY_MAX_SPLITS
    assert plan.splits * plan.p_per_split >= P
    assert (plan.splits - 1) * plan.p_per_split < P  # no empty split


def test_ray_plan_fills_the_card_on_the_largest_item_bucket():
    # P=2048 x 3,840 rows is 30 row tiles: without splits 30 blocks on 132
    # SMs.  One candidate (bytes set the pace) gets the 16 warps an SM
    # holds, four candidates (arithmetic does) twice as many, finer slices
    for C, per_sm in ((1, 16), (4, 32)):
        plan, blocks, warps = _ray(C, 2048, 3840)
        assert plan.warps == 8 and blocks >= SMS
        assert 0.9 * per_sm * SMS <= warps <= 1.15 * per_sm * SMS


def test_ray_plan_does_not_split_a_short_wide_bucket():
    # the user side's P=16 x 103,424 rows: 808 row tiles fill the card,
    # and a split would cost a second launch
    for C in (1, 4):
        plan, _, _ = _ray(C, 16, 103424)
        assert plan.splits == 1 and plan.p_per_split == 16
        assert plan.warps * _lib.RAY_UNROLL <= 16  # a round of slots a warp


def test_ray_plan_spreads_a_small_bucket_over_the_sms():
    # P=64 x 2,048 rows is 16 row tiles: blocks of 8 warps would use 16
    # SMs; the plan takes one-warp blocks, a block for nearly every SM
    plan, blocks, _ = _ray(4, 64, 2048)
    assert plan.warps == 1 and blocks >= SMS
    # one row tile and a long P: two-warp blocks, a block for every SM
    plan, blocks, _ = _ray(4, 2048, 128)
    assert plan.warps == 2 and blocks == plan.splits >= SMS
    # the splits stop at RAY_MAX_SPLITS
    plan, _, _ = _ray(4, 100000, 8)
    assert plan.splits <= _lib.RAY_MAX_SPLITS


def test_ray_plan_gives_rayf_eight_warps_at_eight_candidates():
    # rayf holds one sum a candidate: 8 warps x 8 x 32 x 16 bytes = 32 KB,
    # where raygtd's two sums would take 64 KB and are held to 4 warps
    assert _ray(8, 2048, 3840, sums=1)[0].warps == 8
    assert _ray(8, 2048, 3840, sums=2)[0].warps == 4
    # below five candidates the sums per candidate change nothing
    for C in (1, 2, 3, 4):
        assert _ray(C, 2048, 3840, 1)[0] == _ray(C, 2048, 3840, 2)[0]


def test_ray_plan_is_cached_per_shape():
    assert _lib.ray_plan(4, 2048, 3840, SMS) is _lib.ray_plan(4, 2048, 3840,
                                                              SMS)


def test_ray_wrappers_refuse_before_the_library_loads():
    from poismf_torch.kernels import raygtd

    odd = torch.zeros((4, 102))
    with pytest.raises(ValueError, match="multiple of 4"):
        raygtd.plan_of(odd, odd, odd, 4)
    ok = torch.zeros((4, 128))
    shifted = torch.zeros(4 * 128 + 1)[1:].view(4, 128)
    with pytest.raises(ValueError, match="16-byte aligned"):
        raygtd.plan_of(ok, shifted, ok, 4)
    with pytest.raises(ValueError, match="candidates"):
        _lib.check_ray_inputs(ok, ok, ok, torch.zeros((9, 128)))
    with pytest.raises(ValueError, match=r"float32 \[P, R\]"):
        _lib.check_ray_inputs(ok, ok.double(), ok, torch.zeros((4, 128)))
    with pytest.raises(ValueError, match=r"\[k, R\]"):
        _lib.check_plane_inputs(torch.zeros((2, 4, 16)), torch.zeros((4, 16)),
                                torch.zeros((3, 16)))
    assert _lib._lib is None  # nothing above built or loaded the kernels


def test_rayf_refuses_before_the_library_loads():
    # rayf is planned as raygtd, with one sum a candidate: the same
    # refusals, named after it
    from poismf_torch.kernels import raygtd

    odd = torch.zeros((4, 102))
    with pytest.raises(ValueError, match="rayf: R=102 rows must be a "
                                         "multiple of 4"):
        raygtd.plan_of(odd, odd, odd, 4, gud=False)
    ok = torch.zeros((4, 128))
    shifted = torch.zeros(4 * 128 + 1)[1:].view(4, 128)
    for planes in ((shifted, ok, ok), (ok, shifted, ok), (ok, ok, shifted)):
        with pytest.raises(ValueError, match="rayf: px, pd and vals must be "
                                             "16-byte aligned"):
            raygtd.plan_of(*planes, 4, gud=False)
    assert _lib._lib is None
