"""PyTorch port on a GPU: each hand-written CUDA kernel against its plain
PyTorch version on the same inputs (the line-search kernels f, f_gtd,
f_gtd_fused, f_gtd_multi and ray included; the fgh, hvp, fg, f, pg, f_gtd,
f_gtd_fused and f_gtd_multi plane sweeps and the ray kernels raygtd, ray
and rayf also at the edges of their tiling and on trials that land
exactly on zero, and launched twice for bitwise-equal outputs), the
wrappers' input checks,
the launch counters, small tncg, cg and pg fits on the card against the
same fits on the CPU (tncg also with every cascade tail rejected, so
that profile plans carry its later halves), and the serving solves
(``factors_multiple`` by each method on the ELL and on the flat COO, a
one-row ``factors_single``
on the COO, ``top_n_batched_excl``) and ``ranking_metrics`` on the card
against the same calls on the CPU, small ``layout="coo"`` fits on the
card (no kernel launched, bitwise repeats, against the CPU), small
fits on a one-rank NCCL mesh against the same fits without one, the
solvers' other routes (``POISMF_TNCG_LS_CAND`` 1 and 12,
``POISMF_TNCG_BD_ACCUM=0``, ``POISMF_CG_RAY=0``) on the card against the
CPU, ``train.PASS_STATS`` of card fits against the CPU's, tncg's
line-search round kernel (ls_round) against the plain round bit for bit,
alone and in whole solves on the ELL, a compact sub-ELL and the COO, at
one launch a round, and ``_assemble``'s kernel bit for bit the CPU's on a
compact sub-ELL whose zero-tail group sums over 100,000 rows.

Every test needs a CUDA device and skips without one.  The file imports
neither JAX nor the JAX package, so it also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance: rtol 1e-4 (float32 sums taken in another order), identical
inf/NaN patterns; whole fits and solves as their tests state."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from poismf_torch import PoisMF, kernels  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


def _inputs(gen, k, P, R, dtype):
    bg = (torch.rand((k, P, R), generator=gen, device="cuda") * 0.3).to(dtype)
    vals = torch.poisson(torch.full((P, R), 0.7, device="cuda"),
                         generator=gen)
    a_t = torch.rand((k, R), generator=gen, device="cuda") * 0.3 + 0.01
    return bg, vals, a_t


def _same(out, ref, atol):
    assert torch.equal(torch.isnan(out), torch.isnan(ref))
    assert torch.equal(torch.isinf(out), torch.isinf(ref))
    fin = torch.isfinite(ref)
    torch.testing.assert_close(out[fin], ref[fin], rtol=1e-4, atol=atol)


@pytest.mark.parametrize("pdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,P,R", [
    (50, 2048, 256),  # long bucket: P split across blocks and warps
    (3, 4, 384),  # short bucket: one warp, one split
])
def test_kernels_match_plain_versions(gen, pdt, k, P, R):
    bg, vals, a_t = _inputs(gen, k, P, R, getattr(torch, pdt))
    fgh_ref = kernels.fgh_bucket_torch(bg, vals, a_t, 1.5, True)
    fgh_out = kernels.fgh_bucket(bg, vals, a_t, w_mult=1.5)
    for o, r in zip(fgh_out, fgh_ref):
        _same(o, r, atol=1e-4 * float(r.abs().max()))
    assert kernels.fgh_bucket(bg, vals, a_t, want_pred=False)[4] is None
    w2 = fgh_ref[3]
    v_t = torch.randn((k, R), generator=gen, device="cuda")
    hvp_ref = kernels.hvp_bucket_torch(bg, w2, v_t, True)
    for want_bv in (False, True):
        hv, bv = kernels.hvp_bucket(bg, w2, v_t, want_bv=want_bv)
        _same(hv, hvp_ref[0], atol=1e-4 * float(hvp_ref[0].abs().max()))
        if want_bv:
            _same(bv, hvp_ref[1], atol=1e-5)
        else:
            assert bv is None
    px, pd = fgh_ref[4], hvp_ref[1]
    # in-bound steps, then steps far past the first non-positive prediction
    for steps in ([1e-3, 1e-2, 3e-2, 1e-1], [1.0, 3.0, 30.0, 300.0]):
        alphas = torch.tensor(steps, device="cuda")[:, None] \
            * (0.5 + torch.rand((1, R), generator=gen, device="cuda"))
        ref = kernels.raygtd_multi_bucket_torch(px, pd, vals, alphas)
        out = kernels.raygtd_multi_bucket(px, pd, vals, alphas)
        for o, r in zip(out, ref):
            fin = torch.isfinite(r)
            _same(o, r, atol=1e-4 * float(r[fin].abs().max()))
    assert not torch.isfinite(ref[0]).all()


def _same_by_row(out, ref):
    """As ``_same``, with the absolute tolerance scaled per bucket row
    (the last axis): a poisoned row's weights x / eps ~ 1e30 must not
    set the scale of the others."""
    assert torch.equal(torch.isnan(out), torch.isnan(ref))
    assert torch.equal(torch.isinf(out), torch.isinf(ref))
    fin = torch.isfinite(ref)
    mag = torch.where(fin, ref.abs(), 0.0)
    scale = mag.amax(0, keepdim=True) if ref.dim() > 1 else mag.amax()
    ok = (out - ref).abs() <= 1e-4 * (ref.abs() + scale)
    assert bool((ok | ~fin).all())


def _bitwise_equal(a, b):
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("pdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,P,R", [
    (50, 37, 256),  # P not a multiple of the slot tile
    (50, 64, 96),  # R not a multiple of the 64-row tile
    (16, 32, 40),  # R a multiple of 8 only
    (1, 64, 128),  # k = 1: one k group
    (200, 64, 128),  # k above one register chunk (64): four k chunks
    (8, 4096, 64),  # one row tile: P cut into many splits
    (50, 2048, 3840),  # the Last.FM-scale item side's largest bucket
])
def test_plane_sweeps_match_plain_versions_and_repeat(gen, pdt, k, P, R):
    """fgh, hvp and hvp_bv (csrc/plane_sweep.cuh) at the edges of their
    tiling, with rows whose factor vector is zero or negative (pred
    floored to 1e-30: w2 = inf, identical inf/NaN patterns), launched
    twice for bitwise-equal outputs."""
    bg, vals, a_t = _inputs(gen, k, P, R, getattr(torch, pdt))
    a_t[:, 0] = 0.0
    a_t[:, 1] = -a_t[:, 1]
    ref = kernels.fgh_bucket_torch(bg, vals, a_t, 1.5, True)
    out = kernels.fgh_bucket(bg, vals, a_t, w_mult=1.5)
    again = kernels.fgh_bucket(bg, vals, a_t, w_mult=1.5)
    for o, o2, r in zip(out, again, ref):
        _same_by_row(o, r)
        _bitwise_equal(o, o2)
    assert torch.isinf(ref[3][:, :2]).any()
    w2 = ref[3]
    v_t = torch.randn((k, R), generator=gen, device="cuda")
    href = kernels.hvp_bucket_torch(bg, w2, v_t, True)
    for want_bv in (False, True):
        hv, bv = kernels.hvp_bucket(bg, w2, v_t, want_bv=want_bv)
        hv2, bv2 = kernels.hvp_bucket(bg, w2, v_t, want_bv=want_bv)
        _same_by_row(hv, href[0])
        _bitwise_equal(hv, hv2)
        if want_bv:
            _same(bv, href[1], atol=1e-4 * float(href[1].abs().max()))
            _bitwise_equal(bv, bv2)
        else:
            assert bv is None


@pytest.mark.parametrize("pdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,P,R", [
    (50, 37, 256),  # P not a multiple of the slot tile
    (50, 64, 96),  # R not a multiple of the 64-row tile
    (16, 32, 40),  # R a multiple of 8 only
    (1, 64, 128),  # k = 1: one k group
    (200, 64, 128),  # k above one register chunk (64): four k chunks
    (8, 4096, 64),  # one row tile: P cut into many splits
    (50, 2048, 3840),  # the Last.FM-scale item side's largest bucket
    (50, 16, 4096),  # short rows: a slot tile is a quarter of a row
])
def test_fg_and_f_match_plain_versions_and_repeat(gen, pdt, k, P, R):
    """fg and f (csrc/fg.cu on csrc/plane_sweep.cuh) at the edges of
    their tiling, with rows whose factor vector is zero (+inf nll) or
    negative (NaN nll, finite gradient), px written for every slot or not
    at all, launched twice for bitwise-equal outputs."""
    bg, vals, a_t = _inputs(gen, k, P, R, getattr(torch, pdt))
    a_t[:, 0] = 0.0
    a_t[:, 1] = -a_t[:, 1]
    ref = kernels.fg_bucket_torch(bg, vals, a_t, True)
    assert not torch.isfinite(ref[0][:2]).any()
    for want_pred in (True, False):
        out = kernels.fg_bucket(bg, vals, a_t, want_pred=want_pred)
        again = kernels.fg_bucket(bg, vals, a_t, want_pred=want_pred)
        _same_by_row(out[0], ref[0])
        _same_by_row(out[1], ref[1])
        assert torch.isfinite(out[1]).all()
        _bitwise_equal(out[0], again[0])
        _bitwise_equal(out[1], again[1])
        if want_pred:
            _same(out[2], ref[2], atol=1e-4 * float(ref[2].abs().max()))
            _bitwise_equal(out[2], again[2])
        else:
            assert out[2] is None
    fref = kernels.f_bucket_torch(bg, vals, a_t)
    f1, f2 = kernels.f_bucket(bg, vals, a_t), kernels.f_bucket(bg, vals, a_t)
    _same_by_row(f1, fref)
    _bitwise_equal(f1, f2)
    # the nll row of f is fg's
    _same_by_row(f1, out[0])


@pytest.mark.parametrize("pdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,P,R", [
    (50, 37, 256),  # P not a multiple of the slot tile
    (50, 64, 96),  # R not a multiple of the 64-row tile
    (16, 32, 40),  # R a multiple of 8 only
    (1, 64, 128),  # k = 1: one k group
    (200, 64, 128),  # four k chunks: both factor blocks in shared memory
    (8, 4096, 64),  # one row tile: P cut into many splits
    (50, 2048, 3840),  # the Last.FM-scale item side's largest bucket
    (50, 16, 4096),  # short rows: a slot tile is a quarter of a row
])
def test_f_gtd_and_f_gtd_fused_match_plain_versions_and_repeat(gen, pdt, k,
                                                                 P, R):
    """f_gtd (the bd plane copied beside vals) and f_gtd_fused (a second
    dot against d_t), csrc/fgtd.cu on csrc/plane_sweep.cuh, at the edges
    of their tiling, with rows whose trial is zero (+inf nll, g.d ratios of
    order x / 1e-30) or negated (NaN), launched twice for bitwise-equal
    outputs.  f_gtd_fused holds k to 192 in float32: at k=200 it raises."""
    bg, vals, a_t = _inputs(gen, k, P, R, getattr(torch, pdt))
    a_t[:, 0] = 0.0
    a_t[:, 1] = -a_t[:, 1]
    d_t = torch.randn((k, R), generator=gen, device="cuda")
    bd = (bg.float() * d_t[:, None, :]).sum(0)
    kernels.reset_launch_counts()
    for name, kern, plain, direction in (
            ("f_gtd", kernels.f_gtd_bucket, kernels.f_gtd_bucket_torch, bd),
            ("f_gtd_fused", kernels.f_gtd_fused_bucket,
             kernels.f_gtd_fused_bucket_torch, d_t)):
        if name == "f_gtd_fused" and pdt == "float32" and k > 192:
            with pytest.raises(ValueError, match=r"f_gtd_fused: a bucket of "
                                                 r"k=200 needs \d+ bytes of "
                                                 "shared memory"):
                kern(bg, vals, a_t, direction)
            continue
        ref = plain(bg, vals, a_t, direction)
        assert torch.isposinf(ref[0][0]) and torch.isnan(ref[0][1])
        out = kern(bg, vals, a_t, direction)
        again = kern(bg, vals, a_t, direction)
        for o, o2, r in zip(out, again, ref):
            assert o.shape == (R,)
            # the poisoned rows apart: their ratios must not set the
            # others' scale
            _same_by_row(o[:2], r[:2])
            _same_by_row(o[2:], r[2:])
            _bitwise_equal(o, o2)
        assert kernels.launch_counts[name] == 2


@pytest.mark.parametrize("C", [1, 2, 3, 4, 8, 12, 17])
@pytest.mark.parametrize("P,R", [
    (37, 256),  # P not a multiple of a round of slots
    (64, 96),  # R not a multiple of the 128-row tile
    (32, 40),  # R a multiple of 8 only
    (3, 128),  # fewer slots than a round
    (4096, 64),  # one row tile: P cut into many splits
    (2048, 3840),  # the Last.FM-scale item side's largest bucket
    (16, 4096),  # short rows: blocks of few warps, no split
])
def test_ray_kernels_match_plain_versions_and_repeat(gen, C, P, R):
    """raygtd at C candidates (csrc/raygtd.cu; ray at C = 1) on small
    steps, on steps far past the first non-positive trial prediction
    (NaN) and on a row whose trial prediction is exactly zero (+inf),
    launched twice for bitwise-equal outputs."""
    vals = torch.poisson(torch.full((P, R), 0.7, device="cuda"),
                         generator=gen)
    px = torch.rand((P, R), generator=gen, device="cuda") + 0.5
    pd = torch.randn((P, R), generator=gen, device="cuda")
    px[:, 0], pd[:, 0], vals[0, 0] = 1.0, -1.0, 2.0
    for steps in (1e-2, 30.0):
        alphas = steps * torch.linspace(0.5, 1.0, C, device="cuda")[:, None] \
            * (0.5 + torch.rand((1, R), generator=gen, device="cuda"))
        alphas[:, 0] = 1.0  # px + alpha pd = 0 on row 0
        ref = kernels.raygtd_multi_bucket_torch(px, pd, vals, alphas)
        out = kernels.raygtd_multi_bucket(px, pd, vals, alphas)
        again = kernels.raygtd_multi_bucket(px, pd, vals, alphas)
        for o, o2, r in zip(out, again, ref):
            # rows with a non-positive trial prediction (inf, NaN, ratios
            # of order x / 1e-30) by their own scale; a sum of the others
            # can cancel, so their tolerance scales with the largest
            big = (~torch.isfinite(r) | (r.abs() > 1e20)).any(0)
            _same_by_row(o[:, big], r[:, big])
            if not bool(big.all()):
                _same(o[:, ~big], r[:, ~big],
                      atol=1e-4 * float(r[:, ~big].abs().max()))
            _bitwise_equal(o, o2)
        assert torch.isposinf(ref[0][:, 0]).all()
        if C == 1:
            one = kernels.ray_bucket(px, pd, vals, alphas)
            _bitwise_equal(one[0], out[0][0])
            _bitwise_equal(one[1], out[1][0])
    assert torch.isnan(ref[0]).any()


@pytest.mark.parametrize("C", [1, 2, 3, 5, 8, 12])
@pytest.mark.parametrize("P,R", [
    (37, 256),  # P not a multiple of a round of slots
    (64, 96),  # R not a multiple of the 128-row tile
    (3, 128),  # fewer slots than a round
    (4096, 64),  # one row tile: P cut into many splits
    (2048, 3840),  # the Last.FM-scale item side's largest bucket
    (16, 4096),  # short rows: blocks of few warps, no split
])
def test_rayf_matches_plain_version_and_repeats(gen, C, P, R):
    """rayf (the instance of csrc/raygtd.cu without the g.d sums) on small
    steps, on steps far past the first non-positive trial prediction (NaN)
    and on a row whose trial prediction is exactly zero (+inf), launched
    twice for bitwise-equal outputs."""
    vals = torch.poisson(torch.full((P, R), 0.7, device="cuda"),
                         generator=gen)
    px = torch.rand((P, R), generator=gen, device="cuda") + 0.5
    pd = torch.randn((P, R), generator=gen, device="cuda")
    px[:, 0], pd[:, 0], vals[0, 0] = 1.0, -1.0, 2.0
    for steps in (1e-2, 30.0):
        alphas = steps * torch.linspace(0.5, 1.0, C, device="cuda")[:, None] \
            * (0.5 + torch.rand((1, R), generator=gen, device="cuda"))
        alphas[:, 0] = 1.0  # px + alpha pd = 0 on row 0
        ref = kernels.rayf_multi_bucket_torch(px, pd, vals, alphas)
        out = kernels.rayf_multi_bucket(px, pd, vals, alphas)
        again = kernels.rayf_multi_bucket(px, pd, vals, alphas)
        assert out.shape == (C, R)
        # rows with a non-finite trial by their own scale; a sum of the
        # others can cancel, so their tolerance scales with the largest
        big = (~torch.isfinite(ref)).any(0)
        _same_by_row(out[:, big], ref[:, big])
        if not bool(big.all()):
            _same(out[:, ~big], ref[:, ~big],
                  atol=1e-4 * float(ref[:, ~big].abs().max()))
        _bitwise_equal(out, again)
        assert torch.isposinf(ref[:, 0]).all()
    assert torch.isnan(ref).any()


def test_ray_trials_that_land_on_zero_poison_as_the_plain_versions(gen):
    """px = -(alpha_c pd), rounded in f32, on chosen slots: the plain
    version's trial px + (alpha_c pd) is exactly 0 there (+inf in nll_c),
    and larger steps go negative (NaN).  A kernel that computed the trial
    as one fused multiply-add would get the product's rounding error
    instead, of either sign, and poison other (row, candidate) pairs.
    rayf and raygtd at C = 4 and ray at C = 1 must give the plain
    version's inf/NaN pattern."""
    P, R, C = 64, 1024, 4
    vals = torch.poisson(torch.full((P, R), 1.5, device="cuda"),
                         generator=gen) + 1.0
    px = torch.rand((P, R), generator=gen, device="cuda") + 0.5
    pd = torch.randn((P, R), generator=gen, device="cuda") * 0.1
    alphas = torch.tensor([0.1, 0.2, 0.4, 0.8], device="cuda")[:, None] \
        * (0.5 + torch.rand((1, R), generator=gen, device="cuda"))
    rows = torch.arange(0, R, 3, device="cuda")  # a third of the rows
    slot = rows % P
    cand = rows % C
    d = -(0.3 + torch.rand(rows.shape, generator=gen, device="cuda"))
    pd[slot, rows] = d
    px[slot, rows] = -(alphas[cand, rows] * d)  # one f32 rounding
    assert bool(((px[slot, rows] + alphas[cand, rows] * d) == 0).all())
    kernels.reset_launch_counts()
    cases = (
        ("rayf", lambda al: (kernels.rayf_multi_bucket(px, pd, vals, al),),
         lambda al: (kernels.rayf_multi_bucket_torch(px, pd, vals, al),),
         alphas),
        ("raygtd", lambda al: kernels.raygtd_multi_bucket(px, pd, vals, al),
         lambda al: kernels.raygtd_multi_bucket_torch(px, pd, vals, al),
         alphas),
        ("ray", lambda al: kernels.ray_bucket(px, pd, vals, al),
         lambda al: kernels.ray_bucket_torch(px, pd, vals, al),
         alphas[C - 1:C]))
    for name, kern, plain, al in cases:
        ref, out = plain(al), kern(al)
        nll = ref[0]
        assert torch.isposinf(nll).any() and torch.isnan(nll).any(), name
        for o, r in zip(out, ref):
            _same_by_row(o, r)
    assert kernels.launch_counts["rayf"] == 1
    assert kernels.launch_counts["raygtd"] == 1
    assert kernels.launch_counts["ray"] == 1


@pytest.mark.parametrize("pdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,P,R", [
    (1, 64, 128),  # k = 1: one k group
    (10, 37, 256),  # the pg configuration's k; P not a multiple of a tile
    (10, 16, 4096),  # short rows: a slot tile is half of a row
    (10, 2048, 3840),  # the Last.FM-scale item side's largest bucket
    (16, 32, 40),  # R a multiple of 8 only
    (200, 64, 128),  # k above one register chunk (64): four k chunks
    (8, 4096, 64),  # one row tile: P cut into many splits
])
def test_pg_matches_plain_version_and_repeats(gen, pdt, k, P, R):
    """pg (csrc/pg.cu on csrc/plane_sweep.cuh) at the edges of its tiling,
    with rows whose factor vector is zero or negative (pred floored to
    1e-30: weights of order x * 1e30), launched twice for bitwise-equal
    outputs."""
    bg, vals, a_t = _inputs(gen, k, P, R, getattr(torch, pdt))
    a_t[:, 0] = 0.0
    a_t[:, 1] = -a_t[:, 1]
    ref = kernels.pg_bucket_torch(bg, vals, a_t)
    out = kernels.pg_bucket(bg, vals, a_t)
    again = kernels.pg_bucket(bg, vals, a_t)
    assert out.shape == (k, R)
    _same_by_row(out, ref)
    _bitwise_equal(out, again)
    assert bool(torch.isfinite(out).all())
    assert float(ref[:, :2].abs().max()) > 1e20  # the floored rows


def test_redesigned_kernels_refuse_what_they_do_not_take(gen):
    bg, vals, a_t = _inputs(gen, 4, 16, 128, torch.float32)
    shifted = torch.zeros(16 * 128 + 1, device="cuda")[1:].view(16, 128)
    f_gtd = (
        # f_gtd with a [P, R] bd plane, f_gtd_fused with d_t [k, R]
        lambda bg_, vals_, a_t_: kernels.f_gtd_bucket(bg_, vals_, a_t_,
                                                      vals_),
        lambda bg_, vals_, a_t_: kernels.f_gtd_fused_bucket(bg_, vals_, a_t_,
                                                            a_t_))
    for call in (kernels.fg_bucket, kernels.f_bucket, kernels.pg_bucket,
                 *f_gtd):
        with pytest.raises(ValueError, match="multiple of 8"):
            call(bg[:, :, :100].contiguous(), vals[:, :100].contiguous(),
                 a_t[:, :100].contiguous())
        with pytest.raises(ValueError, match="shared memory"):
            call(torch.zeros((2000, 16, 128), device="cuda"), vals,
                 torch.zeros((2000, 128), device="cuda"))
        with pytest.raises(ValueError, match="aligned"):
            call(bg.flatten()[1:1 + 3 * 16 * 128].view(3, 16, 128), vals,
                 a_t[:3].contiguous())
        with pytest.raises(ValueError, match="aligned"):
            call(bg, shifted, a_t)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="aligned"):
        kernels.f_gtd_bucket(bg, vals, a_t, shifted)  # the bd plane
    assert sum(kernels.launch_counts.values()) == 0
    odd = vals[:, :102].contiguous()
    with pytest.raises(ValueError, match="multiple of 4"):
        kernels.raygtd_multi_bucket(odd, odd, odd,
                                    torch.ones((4, 102), device="cuda"))
    with pytest.raises(ValueError, match="multiple of 4"):
        kernels.ray_bucket(odd, odd, odd, torch.ones((1, 102), device="cuda"))
    with pytest.raises(ValueError, match="multiple of 4"):
        kernels.rayf_multi_bucket(odd, odd, odd,
                                  torch.ones((4, 102), device="cuda"))
    shifted = vals.flatten()[1:1 + 8 * 128].view(8, 128)
    for call in (kernels.raygtd_multi_bucket, kernels.rayf_multi_bucket):
        with pytest.raises(ValueError, match="aligned"):
            call(shifted, shifted, shifted,
                 torch.ones((4, 128), device="cuda"))
    # limits of f_gtd_fused (two factor blocks in shared memory): k = 256
    # in bf16 and 192 in f32 run, the next chunk of 64 values raises
    for k, pdt in ((256, torch.bfloat16), (192, torch.float32)):
        bg, vals, a_t = _inputs(gen, k, 8, 64, pdt)
        for o, r in zip(kernels.f_gtd_fused_bucket(bg, vals, a_t, a_t),
                        kernels.f_gtd_fused_bucket_torch(bg, vals, a_t,
                                                         a_t)):
            _same_by_row(o, r)
        bg, vals, a_t = _inputs(gen, k + 1, 8, 64, pdt)
        with pytest.raises(ValueError, match="shared memory"):
            kernels.f_gtd_fused_bucket(bg, vals, a_t, a_t)
    # limits of fg, f, pg and f_gtd: k = 384 in bf16 and 256 in f32 run
    for k, pdt in ((384, torch.bfloat16), (256, torch.float32)):
        bg, vals, a_t = _inputs(gen, k, 8, 64, pdt)
        for o, r in zip(kernels.f_gtd_bucket(bg, vals, a_t, vals),
                        kernels.f_gtd_bucket_torch(bg, vals, a_t, vals)):
            _same_by_row(o, r)
        _same_by_row(kernels.f_bucket(bg, vals, a_t),
                     kernels.f_bucket_torch(bg, vals, a_t))
        _same_by_row(kernels.pg_bucket(bg, vals, a_t),
                     kernels.pg_bucket_torch(bg, vals, a_t))
        ref = kernels.fg_bucket_torch(bg, vals, a_t, False)
        out = kernels.fg_bucket(bg, vals, a_t, want_pred=False)
        _same_by_row(out[0], ref[0])
        _same_by_row(out[1], ref[1])


@pytest.mark.parametrize("pdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,P,R", [
    (50, 2048, 256),  # long bucket: P split across blocks and warps
    (10, 1024, 384),  # the pg configuration's k
    (3, 4, 384),  # short bucket: one warp, one split
])
def test_cg_and_pg_kernels_match_plain_versions(gen, pdt, k, P, R):
    bg, vals, a_t = _inputs(gen, k, P, R, getattr(torch, pdt))
    # rows whose factor vector is zero or negative poison fg's nll
    a_t[:, 0] = 0.0
    a_t[:, 1] = -a_t[:, 1]
    ref = kernels.fg_bucket_torch(bg, vals, a_t, True)
    for want_pred in (True, False):
        out = kernels.fg_bucket(bg, vals, a_t, want_pred=want_pred)
        _same_by_row(out[0], ref[0])
        _same_by_row(out[1], ref[1])
        if want_pred:
            _same(out[2], ref[2], atol=1e-5)
        else:
            assert out[2] is None
    assert not torch.isfinite(ref[0]).all()
    _same_by_row(kernels.pg_bucket(bg, vals, a_t),
                 kernels.pg_bucket_torch(bg, vals, a_t))
    px = ref[2]
    pd = kernels.hvp_bucket_torch(bg, vals, torch.randn(
        (k, R), generator=gen, device="cuda"), True)[1]
    for steps in ([1e-3, 1e-2, 3e-2, 1e-1], [1.0, 3.0, 30.0, 300.0]):
        alphas = torch.tensor(steps, device="cuda")[:, None] \
            * (0.5 + torch.rand((1, R), generator=gen, device="cuda"))
        rref = kernels.rayf_multi_bucket_torch(px, pd, vals, alphas)
        _same_by_row(kernels.rayf_multi_bucket(px, pd, vals, alphas), rref)
    assert not torch.isfinite(rref).all()


@pytest.mark.parametrize("pdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,P,R", [
    (50, 2048, 256),  # long bucket: P split across blocks and warps
    (3, 4, 384),  # short bucket: one warp, one split
])
def test_line_search_kernels_match_plain_versions(gen, pdt, k, P, R):
    """f, f_gtd (hoisted bd plane), f_gtd_fused and the one-step ray, with
    rows whose trial is zero (+inf) or negative (NaN)."""
    bg, vals, a_t = _inputs(gen, k, P, R, getattr(torch, pdt))
    a_t[:, 0] = 0.0
    a_t[:, 1] = -a_t[:, 1]
    d_t = torch.randn((k, R), generator=gen, device="cuda")
    bd = kernels.hvp_bucket_torch(bg, vals, d_t, True)[1]
    ref = kernels.f_bucket_torch(bg, vals, a_t)
    _same_by_row(kernels.f_bucket(bg, vals, a_t), ref)
    assert not torch.isfinite(ref).all()
    for out, ref in (
            (kernels.f_gtd_bucket(bg, vals, a_t, bd),
             kernels.f_gtd_bucket_torch(bg, vals, a_t, bd)),
            (kernels.f_gtd_fused_bucket(bg, vals, a_t, d_t),
             kernels.f_gtd_fused_bucket_torch(bg, vals, a_t, d_t))):
        for o, r in zip(out, ref):
            _same_by_row(o, r)
    px = kernels.fg_bucket_torch(bg, vals, a_t.abs() + 0.01, True)[2]
    for steps in (1e-2, 300.0):
        alpha = steps * (0.5 + torch.rand((1, R), generator=gen,
                                          device="cuda"))
        ref = kernels.ray_bucket_torch(px, bd, vals, alpha)
        for o, r in zip(kernels.ray_bucket(px, bd, vals, alpha), ref):
            _same_by_row(o, r)
    assert not torch.isfinite(ref[0]).all()


@pytest.mark.parametrize("pdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", range(1, 9))
def test_f_gtd_multi_matches_plain_version(gen, pdt, C):
    """C = 1..8 projected trials on a long bucket, small and far steps,
    a [k] and a per-row [k, R] Bsum, a per-row fold mask; the first rows'
    trials project to zero (+inf) from step 0.5 on."""
    k, P, R = 50, 2048, 256
    bg, vals, x_t = _inputs(gen, k, P, R, getattr(torch, pdt))
    d_t = torch.randn((k, R), generator=gen, device="cuda") * 0.1
    d_t[:, :3] = -2.0 * x_t[:, :3]
    fold = torch.rand(R, generator=gen, device="cuda") < 0.7
    bsum_k = torch.rand(k, generator=gen, device="cuda") * 100.0
    bsum_rows = torch.rand((k, R), generator=gen, device="cuda") * 100.0
    for steps, bsum, mask in ((1e-2, bsum_k, None), (1.0, bsum_rows, fold),
                              (30.0, bsum_k, fold)):
        alphas = steps * torch.linspace(0.5, 1.0, C, device="cuda")[:, None] \
            * (0.5 + torch.rand((1, R), generator=gen, device="cuda"))
        args = (bg, vals, x_t, d_t, alphas, bsum, 7.0, 1.5, steps < 10, mask)
        ref = kernels.f_gtd_multi_bucket_torch(*args)
        out = kernels.f_gtd_multi_bucket(*args)
        # f = lin + w_mult * nll cancels on some rows: the other rows'
        # tolerance scales with the block's largest value, not their own
        for o, r in zip(out, ref):
            _same_by_row(o[:, :3], r[:, :3])
            rest = r[:, 3:]
            _same(o[:, 3:], rest,
                  atol=1e-4 * float(rest[torch.isfinite(rest)].abs().max()))
    assert torch.isposinf(ref[0][:, :3]).all()



def _multi_inputs(gen, k, P, R, pdt, C, steps):
    """f_gtd_multi's inputs: rows 0-2 step along d = -2 x, so their trials
    project to zero from a step of 0.5 on (+inf f); a [k] Bsum and a fold
    mask that leaves some rows out."""
    bg, vals, x_t = _inputs(gen, k, P, R, getattr(torch, pdt))
    d_t = torch.randn((k, R), generator=gen, device="cuda") * 0.1
    d_t[:, :3] = -2.0 * x_t[:, :3]
    alphas = steps * torch.linspace(0.5, 1.0, C, device="cuda")[:, None] \
        * (0.5 + torch.rand((1, R), generator=gen, device="cuda"))
    bsum = torch.rand(k, generator=gen, device="cuda") * 100.0
    fold = torch.rand(R, generator=gen, device="cuda") < 0.7
    return bg, vals, x_t, d_t, alphas, bsum, 7.0, 1.5, True, fold


def _multi_same(out, ref):
    # the poisoned rows apart; the others' tolerance scales with the
    # block's largest value (f = lin + w_mult * nll cancels on some rows)
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        _same_by_row(o[:, :3], r[:, :3])
        rest = r[:, 3:]
        fin = torch.isfinite(rest)
        _same(o[:, 3:], rest, atol=1e-4 * float(rest[fin].abs().max()))


@pytest.mark.parametrize("pdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,P,R", [
    (50, 37, 256),  # P not a multiple of the slot tile
    (50, 64, 96),  # R not a multiple of the 64-row tile
    (16, 32, 40),  # R a multiple of 8 only
    (1, 64, 128),  # k = 1: one k group
    (100, 64, 128),  # two k chunks: trials formed from x and d as read
    (8, 4096, 64),  # one row tile: P cut into many splits
    (50, 2048, 3840),  # the Last.FM-scale item side's largest bucket
    (50, 16, 4096),  # short rows: a slot tile is a quarter of a row
])
def test_f_gtd_multi_sweep_matches_plain_version_and_repeats(gen, pdt, k, P,
                                                               R):
    """f_gtd_multi (csrc/fgtd_multi.cu on csrc/plane_sweep.cuh) at the
    edges of its tiling, on each template C (1, 2, 4, 8) and on C = 3 (the
    instance for 4, a spare candidate), at small and far steps, launched
    twice for bitwise-equal outputs."""
    kernels.reset_launch_counts()
    for C in (1, 2, 3, 4, 8):
        for steps in (1e-2, 30.0):
            args = _multi_inputs(gen, k, P, R, pdt, C, steps)
            ref = kernels.f_gtd_multi_bucket_torch(*args)
            out = kernels.f_gtd_multi_bucket(*args)
            again = kernels.f_gtd_multi_bucket(*args)
            _multi_same(out, ref)
            for o, o2 in zip(out, again):
                _bitwise_equal(o, o2)
        assert torch.isposinf(ref[0][:, :3]).all()
    assert kernels.launch_counts["f_gtd_multi"] == 20


@pytest.mark.parametrize("pdt,limit", [("bfloat16", 256), ("float32", 192)])
@pytest.mark.parametrize("C", [1, 4, 8])
def test_f_gtd_multi_runs_to_its_k_limit(gen, pdt, limit, C):
    """x and d lie in shared memory when k spans several chunks, as
    f_gtd_fused's two blocks: at every C, k runs to 256 in bf16 and 192
    in f32, and the next k raises before any launch, naming the shared
    memory the library reported."""
    args = _multi_inputs(gen, limit, 8, 64, pdt, C, 1.0)
    _multi_same(kernels.f_gtd_multi_bucket(*args),
                kernels.f_gtd_multi_bucket_torch(*args))
    args = _multi_inputs(gen, limit + 1, 8, 64, pdt, C, 1.0)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match=rf"f_gtd_multi: a bucket of "
                                         rf"k={limit + 1} needs \d+ bytes "
                                         "of shared memory"):
        kernels.f_gtd_multi_bucket(*args)
    assert kernels.launch_counts["f_gtd_multi"] == 0


def test_f_gtd_multi_trials_that_land_on_zero_poison_as_the_plain_version(
        gen):
    """x = -(alpha_c d), rounded in f32, on chosen rows: the plain
    version's trial x + (alpha_c d) is exactly 0 for every k there (+inf
    f_c), and larger steps project to zero too.  A kernel that formed the
    trial as one fused multiply-add would get the product's rounding error
    instead, a tiny trial of either sign, and a finite f on about half of
    those pairs.  At k = 100 the other k chunk's trials are formed from
    shared memory: both ways must give the plain version's inf/NaN
    pattern."""
    for k in (20, 100):
        P, R, C = 32, 256, 4
        bg, vals, x_t = _inputs(gen, k, P, R, torch.float32)
        vals = vals + 1.0  # every slot valid
        d_t = torch.randn((k, R), generator=gen, device="cuda") * 0.1
        alphas = torch.tensor([0.1, 0.2, 0.4, 0.8], device="cuda")[:, None] \
            * (0.5 + torch.rand((1, R), generator=gen, device="cuda"))
        rows = torch.arange(0, R, 3, device="cuda")
        cand = rows % C
        d = -(0.3 + torch.rand((k, rows.numel()), generator=gen,
                               device="cuda"))
        d_t[:, rows] = d
        x_t[:, rows] = -(alphas[cand, rows] * d)  # one f32 rounding
        assert bool(((x_t[:, rows] + alphas[cand, rows] * d) == 0).all())
        args = (bg, vals, x_t, d_t, alphas, torch.rand(k, device="cuda"),
                7.0, 1.0, True, None)
        ref = kernels.f_gtd_multi_bucket_torch(*args)
        out = kernels.f_gtd_multi_bucket(*args)
        assert torch.isposinf(ref[0][cand, rows]).all()
        for o, r in zip(out, ref):
            _same_by_row(o, r)

def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    bg, vals, a_t = _inputs(gen, 4, 16, 128, torch.float32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kernels.fgh_bucket(bg.half(), vals, a_t)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.fgh_bucket(bg, vals, a_t.t().contiguous().t())
    with pytest.raises(ValueError, match=r"\[k, R\]"):
        kernels.fgh_bucket(bg, vals, a_t[:3].contiguous())
    with pytest.raises(ValueError, match="tensors on"):
        kernels.hvp_bucket(bg, vals.cpu(), a_t)
    with pytest.raises(ValueError, match="shared memory"):
        kernels.fgh_bucket(torch.zeros((2000, 16, 128), device="cuda"),
                           vals, torch.zeros((2000, 128), device="cuda"))
    with pytest.raises(ValueError, match="shared memory"):
        kernels.hvp_bucket(torch.zeros((2000, 16, 128), device="cuda"),
                           vals, torch.zeros((2000, 128), device="cuda"))
    for call in (kernels.fgh_bucket, kernels.hvp_bucket):
        with pytest.raises(ValueError, match="multiple of 8"):
            call(bg[:, :, :100].contiguous(), vals[:, :100].contiguous(),
                 a_t[:, :100].contiguous())
    # no candidate at all (more than 8 run in parts: see
    # test_ray_kernels_above_eight_candidates_launch_in_parts)
    with pytest.raises(ValueError, match="candidates"):
        kernels.raygtd_multi_bucket(vals, vals, vals,
                                    torch.ones((0, 128), device="cuda"))
    with pytest.raises(ValueError, match="candidates"):
        kernels.rayf_multi_bucket(vals, vals, vals,
                                  torch.ones((0, 128), device="cuda"))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kernels.fg_bucket(bg.half(), vals, a_t)
    with pytest.raises(ValueError, match=r"\[P, R\]"):
        kernels.pg_bucket(bg, vals[:8].contiguous(), a_t)
    with pytest.raises(ValueError, match=r"bd must be float32 \[P, R\]"):
        kernels.f_gtd_bucket(bg, vals, a_t, a_t)
    with pytest.raises(ValueError, match=r"d_t must be float32 \[k, R\]"):
        kernels.f_gtd_fused_bucket(bg, vals, a_t, vals)
    with pytest.raises(ValueError, match="candidates"):
        kernels.f_gtd_multi_bucket(bg, vals, a_t, a_t,
                                   torch.ones((9, 128), device="cuda"),
                                   a_t[:, 0].contiguous(), 1.0)
    with pytest.raises(ValueError, match="bsum"):
        kernels.f_gtd_multi_bucket(bg, vals, a_t, a_t, a_t[:2].contiguous(),
                                   a_t[:2].contiguous(), 1.0)
    with pytest.raises(ValueError, match="fold"):
        kernels.f_gtd_multi_bucket(bg, vals, a_t, a_t, a_t[:2].contiguous(),
                                   a_t[:, 0].contiguous(), 1.0,
                                   fold=torch.ones(128, device="cuda"))
    with pytest.raises(ValueError, match=r"\[1, R\]"):
        kernels.ray_bucket(vals, vals, vals, a_t[:2].contiguous())


@pytest.mark.parametrize("name", ["fgh", "hvp", "raygtd", "fg", "rayf",
                                  "pg", "f", "f_gtd", "f_gtd_fused",
                                  "f_gtd_multi", "ray"])
def test_float64_on_the_card_raises(gen, name):
    bg, vals, a_t = _inputs(gen, 4, 16, 128, torch.float64)
    vals, a_t = vals.double(), a_t.double()
    al = a_t[:2].contiguous()
    call = {
        "f": lambda: kernels.f_bucket(bg, vals, a_t),
        "f_gtd": lambda: kernels.f_gtd_bucket(bg, vals, a_t, vals),
        "f_gtd_fused": lambda: kernels.f_gtd_fused_bucket(bg, vals, a_t,
                                                          a_t),
        "f_gtd_multi": lambda: kernels.f_gtd_multi_bucket(
            bg, vals, a_t, a_t, al, a_t[:, 0].contiguous(), 1.0),
        "ray": lambda: kernels.ray_bucket(vals, vals, vals, al[:1]),
        "fgh": lambda: kernels.fgh_bucket(bg, vals, a_t),
        "hvp": lambda: kernels.hvp_bucket(bg, vals, a_t),
        "raygtd": lambda: kernels.raygtd_multi_bucket(vals, vals, vals,
                                                      a_t[:4].contiguous()),
        "fg": lambda: kernels.fg_bucket(bg, vals, a_t),
        "rayf": lambda: kernels.rayf_multi_bucket(vals, vals, vals,
                                                  a_t[:4].contiguous()),
        "pg": lambda: kernels.pg_bucket(bg, vals, a_t),
    }[name]
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="float64"):
        call()
    assert sum(kernels.launch_counts.values()) == 0


def _float64_problem():
    rng = np.random.default_rng(1)
    n_u, n_i = 300, 120
    rows = rng.integers(0, n_u, 4000)
    cols = rng.integers(0, n_i, 4000)
    vals = rng.poisson(3.0, 4000) + 1.0
    return rows, cols, vals, (n_u, n_i)


# float64 fits on the card: (constructor arguments, the plane kernels its
# bf16-plane fit launches, its LL band against the CPU with float64
# planes).  With bf16 planes the band is the port's 1e-2.
FLOAT64_FITS = {
    "tncg": (dict(method="tncg"), ("fgh", "hvp_bv"), 1e-6),
    "cg-ray": (dict(method="cg"), ("fg",), 1e-6),
    "cg-fused": (dict(method="cg", limit_step=False), ("fg",), 1e-6),
    "pg": (dict(method="pg", l2_reg=10.0, initial_step=1e-3), ("pg",), 1e-9),
}
RAY_KERNELS = ("raygtd", "rayf", "ray")


def _check_float64_route(counts, pdt, launched):
    """The JAX package's x64 routes in a float64 fit's launch counts: with
    bf16 planes the plane kernels and no ray kernel; with float64 planes
    no kernel but ``_assemble``'s (no TPU kernel's port: its sums run on
    the card in any dtype)."""
    if pdt is None:
        assert counts["assemble"] > 0, counts
        assert sum(v for k, v in counts.items()
                   if not k.startswith("assemble")) == 0, counts
        return
    for name in launched:
        assert counts[name] > 0, (name, counts)
    assert all(counts[name] == 0 for name in RAY_KERNELS), counts


@pytest.mark.parametrize("pdt", ["bfloat16", None], ids=["bf16", "f64"])
@pytest.mark.parametrize("fit", list(FLOAT64_FITS))
def test_float64_fit_on_the_card_raises(gen, fit, pdt):
    """Named for the refusal this test pinned until float64 fits ran on
    the card; it now holds them.  A ``use_float=False`` fit on the card
    keeps float64 factors, launches what the JAX package's x64 routes
    give (``_check_float64_route``) and lands within the band of the same
    fit on the CPU: the port's 1e-2 LL and 0.02 zero shares with bf16
    planes; float64 end to end 1e-6 (pg 1e-9)."""
    kw, launched, rtol = FLOAT64_FITS[fit]
    kw = dict(k=16, niter=3, random_state=2, use_float=False,
              plane_dtype=pdt, **kw)
    X = _float64_problem()
    kernels.reset_launch_counts()
    m_gpu = PoisMF(device="cuda", **kw).fit(X)
    _check_float64_route(dict(kernels.launch_counts), pdt, launched)
    assert m_gpu._A.dtype == torch.float64 and m_gpu._A.is_cuda
    assert np.isfinite(m_gpu.A).all() and (m_gpu.A >= 0).all()
    m_cpu = PoisMF(device="cpu", **kw).fit(X)
    l_gpu, l_cpu = m_gpu.eval_llk(), m_cpu.eval_llk()
    assert abs(l_gpu - l_cpu) / abs(l_cpu) <= (1e-2 if pdt else rtol)
    assert abs((m_gpu.A == 0).mean() - (m_cpu.A == 0).mean()) <= 0.02
    assert abs((m_gpu.B == 0).mean() - (m_cpu.B == 0).mean()) <= 0.02


@pytest.mark.parametrize("method", ["tncg", "cg", "pg"])
def test_float64_model_loaded_on_the_card_serves(gen, method, tmp_path,
                                                 monkeypatch):
    """A float64 checkpoint loads onto the card (``PoisMF.load``'s default
    device) and serves there: ``transform`` on the ELL route
    (``ELL_SERVE_NNZ_THRESHOLD`` patched to 0) bitwise equal to the model
    in memory, the plane kernels launched and no ray kernel, each row's
    serving objective within 1e-6 of the same solve on the CPU (float32
    sums of the bf16 planes in another order); ``predict`` and ``topN``
    equal to the in-memory model's."""
    import scipy.sparse as sp

    from poismf_torch import serve
    from poismf_torch.io.checkpoint import load_model

    kw, launched, _ = FLOAT64_FITS["cg-ray" if method == "cg" else method]
    m = PoisMF(device="cuda", k=16, niter=2, random_state=2, use_float=False,
               plane_dtype="bfloat16", **kw).fit(_float64_problem())
    path = str(tmp_path / "model.npz")
    m.save(path)
    loaded = PoisMF.load(path)
    assert loaded.device.type == "cuda" and loaded._B.dtype == torch.float64
    rng = np.random.default_rng(3)
    X_new = sp.random(40, 120, density=0.1, format="csr", random_state=rng,
                      data_rvs=lambda n: rng.poisson(3.0, n) + 1.0)
    monkeypatch.setattr(serve, "ELL_SERVE_NNZ_THRESHOLD", 0)
    kernels.reset_launch_counts()
    out = loaded.transform(X_new)
    counts = dict(kernels.launch_counts)
    assert out.dtype == np.float64
    assert np.array_equal(out, m.transform(X_new))
    serving = {"tncg": ("fgh", "hvp"), "cg": ("fg",), "pg": ("pg",)}
    _check_float64_route(counts, "bfloat16", serving[method])
    ref = load_model(path, device="cpu").transform(X_new)
    from poismf_torch.sparse import build_counts

    coo = X_new.tocoo()
    X1 = build_counts(coo.row, coo.col, coo.data, 40, 120)
    l2 = m._params().l2_reg
    f_gpu, f_cpu = (_serving_objective(torch.from_numpy(a), m.B,
                                       m.Bsum.cpu(), X1, l2)
                    for a in (out, ref))
    torch.testing.assert_close(f_gpu, f_cpu, rtol=1e-6, atol=0.0)
    users, items = np.arange(10), np.arange(10)
    assert np.array_equal(loaded.predict(users, items),
                          m.predict(users, items))
    assert np.array_equal(loaded.topN(0, n=5), m.topN(0, n=5))


def test_launch_counts_count_kernel_launches_only(gen):
    bg, vals, a_t = _inputs(gen, 4, 16, 128, torch.bfloat16)
    kernels.reset_launch_counts()
    _, _, _, w2, px = kernels.fgh_bucket(bg, vals, a_t)
    kernels.hvp_bucket(bg, w2, a_t)
    _, bv = kernels.hvp_bucket(bg, w2, a_t, want_bv=True)
    kernels.raygtd_multi_bucket(px, bv, vals, a_t[:4].contiguous())
    kernels.fg_bucket(bg, vals, a_t)
    kernels.rayf_multi_bucket(px, bv, vals, a_t[:4].contiguous())
    kernels.pg_bucket(bg, vals, a_t)
    kernels.f_bucket(bg, vals, a_t)
    kernels.f_gtd_bucket(bg, vals, a_t, bv)
    kernels.f_gtd_fused_bucket(bg, vals, a_t, a_t)
    kernels.f_gtd_multi_bucket(bg, vals, a_t, a_t, a_t[:3].contiguous(),
                               a_t[:, 0].contiguous(), 1.0)
    kernels.ray_bucket(px, bv, vals, a_t[:1].contiguous())
    ls, row = _ls_state(np.random.default_rng(0), 4, 128)
    state, _ = kernels.ls_round_state(ls)
    kernels.ls_round(state, torch.empty((4, 128), device="cuda"), None,
                     *row, torch.zeros((1,), dtype=torch.int32,
                                       device="cuda"), maxupd=750, ftol=1e-4)
    kernels.fgh_bucket(bg.cpu(), vals.cpu(), a_t.cpu())  # plain versions
    kernels.pg_bucket(bg.cpu(), vals.cpu(), a_t.cpu())
    kernels.f_gtd_multi_bucket(bg.cpu(), vals.cpu(), a_t.cpu(), a_t.cpu(),
                               a_t[:3].cpu(), a_t[:, 0].cpu(), 1.0)
    assert kernels.launch_counts == dict(
        fgh=1, hvp=1, hvp_bv=1, raygtd=1, fg=1, rayf=1, pg=1, f=1, f_gtd=1,
        f_gtd_fused=1, f_gtd_multi=1, ray=1, ls_round=1, assemble=0,
        assemble_long=0)


@pytest.mark.parametrize("max_cg,hvp_kind", [
    ("auto", "hvp_bv"),  # capped bulk rounds accumulate <B, d> in the HVP
    (None, "hvp"),  # maxCGit = 8 at k=16: plain HVPs and the bdot sweep
])
def test_small_fit_on_the_card_matches_the_cpu(gen, max_cg, hvp_kind):
    rng = np.random.default_rng(1)
    n_u, n_i = 300, 120
    rows = rng.integers(0, n_u, 4000)
    cols = rng.integers(0, n_i, 4000)
    vals = rng.poisson(3.0, 4000) + 1.0
    X = (rows, cols, vals, (n_u, n_i))
    kw = dict(k=16, method="tncg", niter=3, random_state=2,
              plane_dtype="bfloat16", max_cg=max_cg)
    kernels.reset_launch_counts()
    m_gpu = PoisMF(device="cuda", **kw).fit(X)
    for name in ("fgh", "raygtd", hvp_kind):
        assert kernels.launch_counts[name] > 0, name
    m_cpu = PoisMF(device="cpu", **kw).fit(X)
    l_gpu, l_cpu = m_gpu.eval_llk(), m_cpu.eval_llk()
    assert abs(l_gpu - l_cpu) / abs(l_cpu) <= 1e-2
    assert abs((m_gpu.A == 0).mean() - (m_cpu.A == 0).mean()) <= 0.02
    assert abs((m_gpu.B == 0).mean() - (m_cpu.B == 0).mean()) <= 0.02
    np.testing.assert_array_equal(m_gpu.topN(0, n=5).shape, (5,))


@pytest.mark.parametrize("kw,launched", [
    (dict(method="cg"), ("fg", "rayf", "assemble")),  # ray line search
    (dict(method="cg", limit_step=False), ("fg", "assemble")),  # fused
    (dict(method="pg", l2_reg=10.0, initial_step=1e-3), ("pg", "assemble")),
], ids=["cg-ray", "cg-fused", "pg"])
def test_small_cg_and_pg_fits_on_the_card_match_the_cpu(gen, kw, launched):
    rng = np.random.default_rng(1)
    n_u, n_i = 300, 120
    rows = rng.integers(0, n_u, 4000)
    cols = rng.integers(0, n_i, 4000)
    vals = rng.poisson(3.0, 4000) + 1.0
    X = (rows, cols, vals, (n_u, n_i))
    kw = dict(k=16, niter=3, random_state=2, plane_dtype="bfloat16", **kw)
    kernels.reset_launch_counts()
    m_gpu = PoisMF(device="cuda", **kw).fit(X)
    for name in launched:
        assert kernels.launch_counts[name] > 0, name
    assert sum(kernels.launch_counts.values()) == sum(
        kernels.launch_counts[name] for name in launched)
    m_cpu = PoisMF(device="cpu", **kw).fit(X)
    l_gpu, l_cpu = m_gpu.eval_llk(), m_cpu.eval_llk()
    assert abs(l_gpu - l_cpu) / abs(l_cpu) <= 1e-2
    assert abs((m_gpu.A == 0).mean() - (m_cpu.A == 0).mean()) <= 0.02
    assert abs((m_gpu.B == 0).mean() - (m_cpu.B == 0).mean()) <= 0.02


def _serving_problem(n_new=200, n_items=3000, k=16, nnz=6000):
    """Fixed factors B, their colsums + 0.1 and a mean user vector, and a
    batch of new users' counts (rows 0 and 1 hold 40 and 2,500 items, the
    second beyond P_MAX = 2048, so it is split into extension chunks)."""
    from poismf_torch.sparse import build_counts

    rng = np.random.default_rng(11)
    B = rng.uniform(0.02, 0.3, (n_items, k)).astype(np.float32)
    Amean = rng.uniform(0.02, 0.3, k).astype(np.float32)
    rows = np.concatenate([np.zeros(40), np.ones(2500),
                           rng.integers(2, n_new, nnz)]).astype(np.int32)
    cols = np.concatenate([rng.permutation(n_items)[:40],
                           rng.permutation(n_items)[:2500],
                           rng.integers(0, n_items, nnz)]).astype(np.int32)
    vals = (rng.poisson(2.0, rows.shape[0]) + 1.0).astype(np.float32)
    X = build_counts(rows, cols, vals, n_new, n_items)
    return B, B.sum(0) + 0.1, Amean, X


def _serving_objective(A, B, Bsum, X, l2):
    """Per row -sum x log(<a, B_i>) + <Bsum, a> + l2 |a|^2, in float64."""
    A, B = A.double().cpu(), torch.as_tensor(B).double()
    r, c, v = (torch.as_tensor(t) for t in X.triplets())
    pred = (A[r.long()] * B[c.long()]).sum(1)
    nll = torch.zeros(A.shape[0], dtype=torch.float64)
    nll.index_add_(0, r.long(), -v.double() * torch.log(pred))
    bsum = torch.as_tensor(Bsum).double()
    return nll + A @ bsum + l2 * (A * A).sum(1)


@pytest.mark.parametrize("method,launched", [
    # maxCGit 8 at k=16
    ("tncg", ("fgh", "hvp", "raygtd", "ls_round", "assemble")),
    ("cg", ("fg", "rayf", "assemble")),
    ("pg", ("pg", "assemble")),
])
def test_factors_multiple_on_the_card_matches_the_cpu(gen, method,
                                                      launched, monkeypatch):
    """The batch serving solve through the kernels against the same solve
    through the plain versions on the CPU (bf16 planes on both, as a batch
    above ``ELL_SERVE_NNZ_THRESHOLD`` nonzeros has them): the summed
    serving objective within 1e-5 relative of the CPU's, each row's within
    1e-4 (cg: 1e-3) and no higher than at the init, the factors within the
    JAX package's ELL-versus-COO band (rtol 5e-2, atol 5e-3).  cg's 15
    float32 iterations do not converge, and a row's trajectory parts from
    the CPU's after an Armijo test or a clamp at zero that the last bit
    decides: one row of 200 differs by 1.4e-4 (NVIDIA H100 80GB HBM3,
    700 W; tncg and pg rows by 1.6e-7 at most).  On the CPU alone, float32
    against float64 differs by 2.1e-4 after those 15 iterations and by
    1.6e-7 after 150: the converged case below holds cg at 1e-4."""
    from poismf_torch import serve

    monkeypatch.setattr(serve, "ELL_SERVE_NNZ_THRESHOLD", 0)
    _check_factors_multiple(method, launched,
                            {"tncg": 240, "cg": 5, "pg": 2}[method],
                            "bfloat16", 1e-3 if method == "cg" else 1e-4)


def test_factors_multiple_cg_converged_on_the_card_matches_the_cpu(
        gen, monkeypatch):
    """cg run to convergence (150 iterations) on the ELL with f32 planes:
    each row's serving objective within 1e-4 of the CPU's."""
    from poismf_torch import serve

    monkeypatch.setattr(serve, "ELL_SERVE_NNZ_THRESHOLD", 0)
    _check_factors_multiple("cg", ("fg", "rayf", "assemble"), 50, None,
                            1e-4)


@pytest.mark.parametrize("method,row_rtol", [
    ("tncg", 1e-4), ("cg", 1e-3), ("pg", 1e-4)])
def test_factors_multiple_on_the_coo_on_the_card_matches_the_cpu(
        gen, method, row_rtol):
    """A batch of at most ``ELL_SERVE_NNZ_THRESHOLD`` nonzeros takes the
    flat-COO solvers, which launch no sweep kernel (tncg's line-search
    rounds launch ls_round): the same tolerances against the CPU as on
    the ELL."""
    _check_factors_multiple(method, ("ls_round",) if method == "tncg"
                            else (), {"tncg": 240, "cg": 5,
                                      "pg": 2}[method], None, row_rtol)


def _check_factors_multiple(method, launched, maxupd, plane_dtype,
                            row_rtol):
    from poismf_torch import serve
    from poismf_torch.train import FitParams

    B, Bsum, Amean, X = _serving_problem()
    l2 = {"tncg": 1e3, "cg": 1e4, "pg": 10.0}[method]
    p = FitParams(k=B.shape[1], method=method, niter=3, l2_reg=l2,
                  maxupd=maxupd, initial_step=1e-4, plane_dtype=plane_dtype)
    args = (torch.from_numpy(B), torch.from_numpy(Bsum),
            torch.from_numpy(Amean))
    kernels.reset_launch_counts()
    out = serve.factors_multiple(*(t.cuda() for t in args), X, p,
                                 reuse_mean=True)
    torch.cuda.synchronize()
    for name in launched:
        assert kernels.launch_counts[name] > 0, name
    assert sum(kernels.launch_counts.values()) == sum(
        kernels.launch_counts[name] for name in launched)
    assert out.device.type == "cuda"
    ref = serve.factors_multiple(*args, X, p, reuse_mean=True)
    n = X.n_rows
    out, ref = out[:n].cpu(), ref[:n]
    assert torch.isfinite(out).all() and (out >= 0).all()
    f_gpu = _serving_objective(out, B, Bsum, X, l2)
    f_cpu = _serving_objective(ref, B, Bsum, X, l2)
    f_init = _serving_objective(torch.from_numpy(Amean).expand(n, -1), B,
                                Bsum, X, l2)
    assert abs(float(f_gpu.sum() - f_cpu.sum())) <= 1e-5 * abs(
        float(f_cpu.sum()))
    torch.testing.assert_close(f_gpu, f_cpu, atol=0.0, rtol=row_rtol)
    assert (f_gpu <= f_init + 1e-6 * f_init.abs()).all()
    torch.testing.assert_close(out, ref, rtol=5e-2, atol=5e-3)


@pytest.mark.parametrize("row", [0, 1], ids=["40-items", "2500-items"])
def test_factors_single_on_the_card_matches_the_cpu(gen, row):
    """One row through the flat-COO tncg, which launches no hand-written
    kernel but its line search's ls_round; the 2,500-item row is summed
    in pieces of SEGMENT_PIECE entries.  Tolerances as above."""
    from poismf_torch import serve

    B, Bsum, Amean, X = _serving_problem()
    r, c, v = X.triplets()
    items, counts = c[r == row], v[r == row]
    args = (torch.from_numpy(B), torch.from_numpy(Bsum),
            torch.from_numpy(Amean))
    kw = dict(l2_reg=1e3, maxupd=1000, reuse_mean=True)
    kernels.reset_launch_counts()
    out = serve.factors_single(*(t.cuda() for t in args), items, counts,
                               **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts["ls_round"] > 0
    assert sum(kernels.launch_counts.values()) == kernels.launch_counts[
        "ls_round"]
    ref = serve.factors_single(*args, items, counts, **kw)
    out = out.cpu()
    assert out.shape == ref.shape == (B.shape[1],)
    assert torch.isfinite(out).all() and (out >= 0).all() and out.max() > 0
    from poismf_torch.sparse import build_counts

    X1 = build_counts(np.zeros_like(items), items, counts, 1, B.shape[0])
    f_gpu, f_cpu = (_serving_objective(a[None], B, Bsum, X1, 1e3)
                    for a in (out, ref))
    torch.testing.assert_close(f_gpu, f_cpu, rtol=1e-4, atol=0.0)
    torch.testing.assert_close(out, ref, rtol=5e-2, atol=5e-3)


def test_top_n_batched_excl_on_the_card_matches_the_cpu(gen):
    from poismf_torch import serve

    rng = np.random.default_rng(12)
    A = torch.from_numpy(rng.uniform(0, 1, (64, 16)).astype(np.float32))
    B = torch.from_numpy(rng.uniform(0, 1, (1000, 16)).astype(np.float32))
    lens = rng.integers(0, 50, 64)
    lens[3] = 990  # all but the padded rows seen: an exhausted pool
    L = int(lens.max())
    items = np.stack([np.concatenate([rng.permutation(990)[:n],
                                      np.zeros(L - n, np.int64)])
                      for n in lens])
    valid = np.arange(L)[None, :] < lens[:, None]
    args = (A, B, torch.from_numpy(items), torch.from_numpy(valid), 10)
    vals, idx = serve.top_n_batched_excl(*(a.cuda() for a in args[:4]),
                                         10, n_items=990)
    ref_vals, ref_idx = serve.top_n_batched_excl(*args, n_items=990)
    vals, idx = vals.cpu(), idx.cpu()
    assert (idx[3] == -1).all() and torch.isneginf(vals[3]).all()
    torch.testing.assert_close(vals, ref_vals, rtol=1e-5, atol=1e-5)
    scores = A @ B.t()
    for q in range(64):
        seen = set(items[q, :lens[q]].tolist())
        got = idx[q][idx[q] >= 0]
        assert not seen & set(got.tolist()) and (got < 990).all()
        # equal ids, up to near-ties
        same = torch.equal(idx[q], ref_idx[q]) or torch.allclose(
            scores[q, got], ref_vals[q][:got.numel()], rtol=1e-5)
        assert same, q


def test_ranking_metrics_on_the_card_match_the_cpu(gen):
    """``ranking_metrics`` on factors held on the card (it runs on their
    device) against the same call on the CPU: within 1e-6."""
    import scipy.sparse as sp

    from poismf_torch.utils.data import train_test_split
    from poismf_torch.utils.metrics import ranking_metrics

    rng = np.random.default_rng(13)
    A = torch.from_numpy(rng.uniform(0, 1, (300, 8)).astype(np.float32))
    B = torch.from_numpy(rng.uniform(0, 1, (500, 8)).astype(np.float32))
    dense = (rng.random((300, 500)) < 0.05) * (rng.poisson(3.0, (300, 500))
                                               + 1.0)
    Xtr, Xte, users = train_test_split(sp.csr_matrix(dense), seed=4)
    ref = ranking_metrics(A, B, Xtr, Xte, k=5, users=users, chunk=64)
    got = ranking_metrics(A.cuda(), B.cuda(), Xtr, Xte, k=5, users=users,
                          chunk=64)
    for name in ref:
        assert abs(got[name] - ref[name]) <= 1e-6, (name, got, ref)


@pytest.fixture
def nccl_mesh(gen, tmp_path):
    """A one-rank NCCL mesh on the card (a machine with one GPU cannot
    hold two NCCL ranks)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        yield init_device_mesh("cuda", (1,))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("pdt", ["bfloat16", None], ids=["bf16", "f64"])
@pytest.mark.parametrize("fit", list(FLOAT64_FITS))
def test_float64_fit_on_a_cuda_mesh_raises(nccl_mesh, fit, pdt):
    """Named for the refusal this test pinned until float64 fits ran on
    the card; it now holds them.  A ``use_float=False`` fit on the
    one-rank NCCL mesh launches what the JAX package's x64 routes give,
    its collectives run in float64, and it lands within the band of the
    same fit on one GPU (as ``test_float64_fit_on_the_card_raises``
    states it); a device that contradicts the mesh still raises."""
    from poismf_torch.parallel import collectives

    kw, launched, rtol = FLOAT64_FITS[fit]
    kw = dict(k=16, niter=3, random_state=2, use_float=False,
              plane_dtype=pdt, **kw)
    X = _float64_problem()
    kernels.reset_launch_counts()
    collectives.reset_counts()
    m_mesh = PoisMF(mesh=nccl_mesh, **kw).fit(X)
    _check_float64_route(dict(kernels.launch_counts), pdt, launched)
    assert collectives.counts["all_gather"] > 0
    assert m_mesh._A.dtype == torch.float64 and m_mesh._A.is_cuda
    m_one = PoisMF(device="cuda", **kw).fit(X)
    l_mesh, l_one = m_mesh.eval_llk(), m_one.eval_llk()
    assert abs(l_mesh - l_one) / abs(l_one) <= (1e-2 if pdt else rtol)
    assert abs((m_mesh.A == 0).mean() - (m_one.A == 0).mean()) <= 0.02
    assert abs((m_mesh.B == 0).mean() - (m_one.B == 0).mean()) <= 0.02
    with pytest.raises(ValueError, match="contradicts the mesh"):
        PoisMF(k=2, mesh=nccl_mesh, device="cpu")


@pytest.mark.parametrize("kw,launched", [
    (dict(method="tncg"), ("fgh", "hvp_bv", "raygtd")),
    (dict(method="cg"), ("fg", "rayf")),
    (dict(method="pg", l2_reg=10.0, initial_step=1e-3), ("pg",)),
], ids=["tncg", "cg", "pg"])
def test_small_fit_on_a_one_rank_nccl_mesh_matches_one_device(nccl_mesh, kw,
                                                              launched):
    """``PoisMF(mesh=...)`` on the card: its kernels launch, its
    collectives run on the card, and the fit lands within the port's band
    (LL 1e-2, zero shares 0.02) of the same fit without a mesh."""
    from poismf_torch.parallel import collectives

    rng = np.random.default_rng(1)
    n_u, n_i = 300, 120
    rows = rng.integers(0, n_u, 4000)
    cols = rng.integers(0, n_i, 4000)
    vals = rng.poisson(3.0, 4000) + 1.0
    X = (rows, cols, vals, (n_u, n_i))
    kw = dict(k=16, niter=3, random_state=2, plane_dtype="bfloat16", **kw)
    kernels.reset_launch_counts()
    collectives.reset_counts()
    m_mesh = PoisMF(mesh=nccl_mesh, **kw).fit(X)
    assert m_mesh.device == torch.device("cuda", 0)
    for name in launched:
        assert kernels.launch_counts[name] > 0, name
    assert collectives.counts["all_gather"] > 0
    m_one = PoisMF(device="cuda", **kw).fit(X)
    l_mesh, l_one = m_mesh.eval_llk(), m_one.eval_llk()
    assert abs(l_mesh - l_one) / abs(l_one) <= 1e-2
    assert abs((m_mesh.A == 0).mean() - (m_one.A == 0).mean()) <= 0.02
    assert abs((m_mesh.B == 0).mean() - (m_one.B == 0).mean()) <= 0.02
    np.testing.assert_array_equal(m_mesh.topN(0, n=5).shape, (5,))


@pytest.mark.parametrize("shape", [(), (5,)])
def test_assemble_on_the_card_equals_the_cpu(gen, monkeypatch, shape):
    """``ops.ell._assemble`` on the card adds each long row's extension
    chunks in chunk order, as on the CPU: bitwise the CPU's result, on a
    layout of rows of up to 5 chunks (P_MAX = 16) and on a compact
    sub-ELL of it."""
    from poismf_torch import sparse
    from poismf_torch.ops import ell as ell_ops

    monkeypatch.setattr(ell_ops, "P_MAX", 16)
    rng = np.random.default_rng(7)
    lens = rng.integers(1, 9, 300)
    lens[:3] = (76, 64, 40)
    rows = np.repeat(np.arange(300), lens)
    cols = np.concatenate([rng.choice(90, n, replace=False) for n in lens])
    X = sparse.ingest((rows, cols, rng.poisson(2.0, rows.shape[0]) + 1.0,
                       (300, 90))).by_user
    active = rng.random(1024) < 0.2
    want = []
    for dev in ("cpu", "cuda"):
        ell = ell_ops.ell_from_counts(X, device=dev)
        plan = ell_ops.plan_compact(ell, 2)
        sel = ell_ops.select_active(ell, plan, active[:ell.n_rows_ell] | (
            ell.host["row_nnz_perm"] > 16), ell.host["row_nnz_perm"],
            ell.host["src"])
        assert sel is not None
        compact = ell_ops.build_compact(ell, plan, *sel[:4])
        for i, lay in enumerate((ell, compact)):
            g = np.random.default_rng(i)
            pieces = [torch.from_numpy(
                g.standard_normal((b.n_rows,) + shape).astype(np.float32)
                * 10.0 ** g.integers(-4, 6, (b.n_rows,) + shape)).to(dev)
                for b in lay.buckets]
            out = ell_ops._assemble(lay, pieces, shape, torch.float32).cpu()
            if dev == "cpu":
                want.append(out)
            else:
                assert torch.equal(out.view(torch.int32),
                                   want[i].view(torch.int32))


@pytest.fixture(scope="module")
def zero_tail_layouts():
    """{device: {"full": ELL, "compact": sub-ELL}} of one synthetic counts
    matrix at P_MAX = 16: 240,000 users of 12 items and three long users
    of 40, 64 and 76 (2 to 4 extension chunks), so that one mixed bucket
    holds every row; the compact sub-ELL (``plan_compact`` at 2,
    ``select_active``, ``build_compact``) keeps the long users and ~2% of
    the others, so its zero-tail group sums over 100,000 fill rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from poismf_torch import sparse
    from poismf_torch.ops import ell as ell_ops

    rng = np.random.default_rng(11)
    lens = np.full(240_003, 12)
    lens[:3] = (40, 64, 76)
    rows = np.repeat(np.arange(lens.shape[0]), lens)
    first = np.repeat(np.cumsum(lens) - lens, lens)
    step = np.repeat(rng.integers(1, 7, lens.shape[0]), lens)
    start = np.repeat(rng.integers(0, 2000, lens.shape[0]), lens)
    cols = (start + step * (np.arange(rows.shape[0]) - first)) % 2000
    vals = rng.poisson(2.0, rows.shape[0]) + 1.0
    X = sparse.ingest((rows, cols, vals, (lens.shape[0], 2000))).by_user
    out, active = {}, None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ell_ops, "P_MAX", 16)
        for dev in ("cpu", "cuda"):
            ell = ell_ops.ell_from_counts(X, device=dev)
            if active is None:
                active = rng.random(ell.n_rows_ell) < 0.02
                active |= ell.host["row_nnz_perm"] > 16
            plan = ell_ops.plan_compact(ell, 2)
            sel = ell_ops.select_active(ell, plan, active,
                                        ell.host["row_nnz_perm"],
                                        ell.host["src"])
            assert sel is not None
            out[dev] = {"full": ell, "compact": ell_ops.build_compact(
                ell, plan, *sel[:4])}
    return out


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", [(), (4,), (13,), (50,)])
def test_assemble_kernel_sums_a_zero_tail_of_100k_rows_as_the_cpu(
        zero_tail_layouts, shape, dtype):
    """``_assemble``'s kernel on a compact sub-ELL whose zero-tail group
    holds more than 100,000 fill rows (a block of its own: the long path,
    ``assemble_long`` counted) and on its full ELL (short groups alone):
    bitwise the CPU's plain route, int bit patterns compared, one launch
    a call.  13 columns: a block of 8 and one of 5."""
    from poismf_torch.ops import ell as ell_ops

    tdt = getattr(torch, dtype)
    int_dt = torch.int32 if dtype == "float32" else torch.int64
    cpu, gpu = zero_tail_layouts["cpu"], zero_tail_layouts["cuda"]
    asm = cpu["compact"].asm
    zero_slot = cpu["compact"].n_rows_ell - 1
    g = int(torch.nonzero(asm.targets == zero_slot)[0, 0])
    assert int(asm.offsets[g + 1] - asm.offsets[g]) > 100_000
    assert asm.max_len > 100_000 and asm.long_groups.numel() >= 1
    assert cpu["full"].asm.max_len < ell_ops.LONG_GROUP_ROWS
    for i, (name, long_launches) in enumerate((("compact", 1),
                                                ("full", 0))):
        g_np = np.random.default_rng(i)
        pieces = [torch.from_numpy(
            g_np.standard_normal((b.n_rows,) + shape)
            * 10.0 ** g_np.integers(-4, 6, (b.n_rows,) + shape)).to(tdt)
            for b in cpu[name].buckets]
        want = ell_ops._assemble(cpu[name], pieces, shape, tdt)
        kernels.reset_launch_counts()
        got = ell_ops._assemble(gpu[name], [p.cuda() for p in pieces],
                                shape, tdt).cpu()
        assert kernels.launch_counts["assemble"] == 1
        assert kernels.launch_counts["assemble_long"] == long_launches
        assert torch.equal(got.view(int_dt), want.view(int_dt)), name


def test_forced_rejection_fit_on_the_card_matches_the_cpu(gen,
                                                         monkeypatch):
    """The cascade with no uniform plan (every tail rejected, recorded,
    and carried by profile plans from the second epoch on): a tncg fit on
    the card launches its kernels on the profile plans' compact buckets,
    and lands within 1e-2 train LL and 0.02 exact-zero shares of the same
    fit on the CPU; both run profile-plan rounds."""
    from poismf_torch import train

    monkeypatch.setattr(train, "COMPACT_DENOMS", ())
    rng = np.random.default_rng(1)
    n_u, n_i = 2500, 150
    key = np.unique(rng.integers(0, n_u * n_i, int(n_u * n_i * 0.06)))
    rows, cols = key // n_i, key % n_i
    vals = rng.poisson(3.0, key.shape[0]) + 1.0
    X = (rows, cols, vals, (n_u, n_i))
    kw = dict(k=6, method="tncg", niter=4, l2_reg=1e3, maxupd=90,
              random_state=1, plane_dtype="bfloat16")
    fits = {}
    for device in ("cuda", "cpu"):
        kernels.reset_launch_counts()
        train.CASCADE_TRACE = []
        try:
            m = PoisMF(device=device, **kw).fit(X)
            trace = train.CASCADE_TRACE
        finally:
            train.CASCADE_TRACE = None
        assert any(e.denom == 0 for e in trace), device
        fits[device] = (m, dict(kernels.launch_counts))
    (m_gpu, counts), (m_cpu, _) = fits["cuda"], fits["cpu"]
    for name in ("fgh", "raygtd", "hvp_bv"):
        assert counts[name] > 0, name
    l_gpu, l_cpu = m_gpu.eval_llk(), m_cpu.eval_llk()
    assert abs(l_gpu - l_cpu) / abs(l_cpu) <= 1e-2
    assert abs((m_gpu.A == 0).mean() - (m_cpu.A == 0).mean()) <= 0.02
    assert abs((m_gpu.B == 0).mean() - (m_cpu.B == 0).mean()) <= 0.02


@pytest.mark.parametrize("kw", [
    dict(method="tncg", niter=1),
    dict(method="cg", niter=3),
    dict(method="pg", niter=3),
], ids=["tncg", "cg", "pg"])
def test_two_fits_on_the_card_are_bitwise_equal(gen, monkeypatch, kw):
    """Two fits of the same data and seed on the card give the same A and
    B bit for bit and the same kernel launch counts (P_MAX = 64, so this
    small problem has rows of extension chunks on both sides)."""
    from poismf_torch.ops import ell as ell_ops
    from poismf_torch.utils.data import synth_lastfm_like

    monkeypatch.setattr(ell_ops, "P_MAX", 64)
    rows, cols, vals = synth_lastfm_like(np.random.default_rng(2), 3000,
                                         1500, 60_000)
    X = (rows, cols, vals, (3000, 1500))
    fits = []
    for _ in range(2):
        kernels.reset_launch_counts()
        m = PoisMF(k=16, plane_dtype="bfloat16", random_state=0,
                   device="cuda", **kw).fit(X)
        fits.append((m.A, m.B, dict(kernels.launch_counts)))
    (A1, B1, c1), (A2, B2, c2) = fits
    assert np.array_equal(A1.view(np.uint32), A2.view(np.uint32))
    assert np.array_equal(B1.view(np.uint32), B2.view(np.uint32))
    assert c1 == c2 and sum(c1.values()) > 0


@pytest.mark.parametrize("kw", [
    dict(method="tncg", niter=1),
    dict(method="cg", niter=3),
    dict(method="cg", niter=3, nnz_chunk=1024),
    dict(method="pg", niter=3, l2_reg=10.0, initial_step=1e-5),
], ids=["tncg", "cg", "cg-chunked", "pg"])
def test_coo_fits_on_the_card_repeat_and_match_the_cpu(gen, kw):
    """``layout="coo"`` fits on the card launch no hand-written kernel
    but tncg's line-search round (ls_round), repeat bit for bit (the row
    sums run in a fixed order), and land within 1e-2 train LL and 0.02
    exact-zero shares of the same fits on the CPU (pg within 1e-5)."""
    from poismf_torch.utils.data import synth_lastfm_like

    rows, cols, vals = synth_lastfm_like(np.random.default_rng(2), 3000,
                                         1500, 60_000)
    X = (rows, cols, vals, (3000, 1500))
    kw = dict(k=16, random_state=0, layout="coo", **kw)
    fits = []
    for _ in range(2):
        kernels.reset_launch_counts()
        m = PoisMF(device="cuda", **kw).fit(X)
        ls_rounds = kernels.launch_counts["ls_round"]
        assert (ls_rounds > 0) == (kw["method"] == "tncg")
        assert sum(kernels.launch_counts.values()) == ls_rounds
        fits.append(m)
    (A1, B1), (A2, B2) = ((m.A, m.B) for m in fits)
    assert np.array_equal(A1.view(np.uint32), A2.view(np.uint32))
    assert np.array_equal(B1.view(np.uint32), B2.view(np.uint32))
    m_cpu = PoisMF(device="cpu", **kw).fit(X)
    l_gpu, l_cpu = fits[0].eval_llk(), m_cpu.eval_llk()
    rtol = 1e-5 if kw["method"] == "pg" else 1e-2
    assert abs(l_gpu - l_cpu) / abs(l_cpu) <= rtol
    assert abs((A1 == 0).mean() - (m_cpu.A == 0).mean()) <= 0.02
    assert abs((B1 == 0).mean() - (m_cpu.B == 0).mean()) <= 0.02


@pytest.mark.parametrize("C", [9, 12, 17])
def test_ray_kernels_above_eight_candidates_launch_in_parts(gen, C):
    """raygtd and rayf at more candidates than the kernel's largest
    instance (8): successive launches of at most 8 over the same planes,
    each counted, equal to the plain versions."""
    P, R = 64, 256
    vals = torch.poisson(torch.full((P, R), 0.7, device="cuda"),
                         generator=gen)
    px = torch.rand((P, R), generator=gen, device="cuda") + 0.5
    pd = torch.randn((P, R), generator=gen, device="cuda")
    alphas = 1e-2 * torch.rand((C, R), generator=gen, device="cuda")
    kernels.reset_launch_counts()
    out = kernels.raygtd_multi_bucket(px, pd, vals, alphas)
    nll = kernels.rayf_multi_bucket(px, pd, vals, alphas)
    parts = -(-C // 8)
    assert kernels.launch_counts["raygtd"] == parts
    assert kernels.launch_counts["rayf"] == parts
    ref = kernels.raygtd_multi_bucket_torch(px, pd, vals, alphas)
    for o, r in zip(out, ref):
        assert o.shape == (C, R)
        _same(o, r, atol=1e-4 * float(r.abs().max()))
    _same(nll, ref[0], atol=1e-4 * float(ref[0].abs().max()))


def _route_problem():
    rng = np.random.default_rng(1)
    n_u, n_i = 300, 120
    rows = rng.integers(0, n_u, 4000)
    cols = rng.integers(0, n_i, 4000)
    vals = rng.poisson(3.0, 4000) + 1.0
    return (rows, cols, vals, (n_u, n_i))


@pytest.mark.parametrize("env,kw,launched,absent", [
    ({"POISMF_TNCG_LS_CAND": "1"}, dict(method="tncg"),
     ("fgh", "hvp_bv", "raygtd"), ()),
    ({"POISMF_TNCG_LS_CAND": "12"}, dict(method="tncg"),
     ("fgh", "hvp_bv", "raygtd"), ()),
    ({"POISMF_TNCG_BD_ACCUM": "0"}, dict(method="tncg"),
     ("fgh", "hvp", "raygtd"), ("hvp_bv",)),
    ({"POISMF_CG_RAY": "0"}, dict(method="cg"), ("fg",), ("rayf",)),
], ids=["ls_cand-1", "ls_cand-12", "bd_accum-0", "cg-fused"])
def test_solver_routes_on_the_card_match_the_cpu(gen, monkeypatch, env, kw,
                                                launched, absent):
    """Each route the variables pick, set after import: a small fit on the
    card launches its kernels and not the other route's, its line
    searches take the candidates the route gives (raygtd spied), and it
    lands within 1e-2 train LL and 0.02 exact-zero shares of the same fit
    on the CPU."""
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    cands = set()
    raygtd = kernels.raygtd_multi_bucket

    def spy(px, pd, vals, alphas):
        cands.add(alphas.shape[0])
        return raygtd(px, pd, vals, alphas)

    monkeypatch.setattr(kernels, "raygtd_multi_bucket", spy)
    X = _route_problem()
    kw = dict(k=16, niter=3, random_state=2, plane_dtype="bfloat16", **kw)
    kernels.reset_launch_counts()
    m_gpu = PoisMF(device="cuda", **kw).fit(X)
    counts = dict(kernels.launch_counts)
    for name in launched:
        assert counts[name] > 0, name
    for name in absent:
        assert counts[name] == 0, name
    if "POISMF_TNCG_LS_CAND" in env:
        # full rounds at the variable's count; compact rounds at 4, as in
        # the JAX package
        assert int(env["POISMF_TNCG_LS_CAND"]) in cands
        assert cands <= {int(env["POISMF_TNCG_LS_CAND"]), 4}
    m_cpu = PoisMF(device="cpu", **kw).fit(X)
    l_gpu, l_cpu = m_gpu.eval_llk(), m_cpu.eval_llk()
    assert abs(l_gpu - l_cpu) / abs(l_cpu) <= 1e-2
    assert abs((m_gpu.A == 0).mean() - (m_cpu.A == 0).mean()) <= 0.02
    assert abs((m_gpu.B == 0).mean() - (m_cpu.B == 0).mean()) <= 0.02


@pytest.mark.parametrize("kw", [
    dict(method="tncg", use_float=False),
    dict(method="cg", use_float=False),
    dict(method="pg", use_float=False),
    dict(method="pg", plane_dtype="bfloat16"),
], ids=["tncg-f64", "cg-f64", "pg-f64", "pg-bf16"])
def test_pass_stats_on_the_card_equal_the_cpu(gen, kw):
    """train.PASS_STATS over a fit on the card equals the same fit's on
    the CPU: the same entries in the same order, bytes equal and sweeps
    within 1e-6 (float64 end to end takes every solver decision as the
    CPU does; pg's sweeps are fixed); every sweep count a host float."""
    from poismf_torch import train

    X = _route_problem()
    kw = dict(k=8, niter=2, random_state=2, **kw)
    stats = {}
    for device in ("cuda", "cpu"):
        train.PASS_STATS = []
        try:
            PoisMF(device=device, **kw).fit(X)
            stats[device] = train.PASS_STATS
        finally:
            train.PASS_STATS = None
    card, cpu = stats["cuda"], stats["cpu"]
    assert len(card) == len(cpu) > 0
    assert [b for _, b in card] == [b for _, b in cpu]
    for (s_card, _), (s_cpu, _) in zip(card, cpu):
        assert isinstance(s_card, float)
        assert s_card == pytest.approx(s_cpu, rel=1e-6)


def _ls_state(rng, C, R, maxupd=750):
    """A float32 line-search state on the card, as ``_tncg_core`` builds
    it (``f_new`` and ``f_best`` the solver's ``f`` itself), holding every
    kind of row a round meets: unbracketed and bracketed rows, poisoned
    upper ends (``f_hi`` inf or NaN), brackets about to collapse, rows
    whose getptc tolerance is too tiny, rows at the feval budget and rows
    that no longer search -> (ls, (f, dginit, spe, tnytol))."""
    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    lo = np.abs(r(R)) * np.float32(0.1)
    hi = lo + np.abs(r(R)) * np.float32(2.0)
    hi[rng.random(R) < 0.4] = np.inf
    tight = rng.random(R) < 0.2
    hi[tight] = lo[tight] + np.float32(1e-7)
    f = r(R) * np.float32(10.0)
    f_hi = f + r(R)
    f_hi[rng.random(R) < 0.15] = np.inf
    f_hi[rng.random(R) < 0.05] = np.nan
    spe = np.abs(r(R)) * np.float32(3.0)
    spe[rng.random(R) < 0.3] = np.inf
    tnytol = np.abs(r(R)) * np.float32(1e-6)
    tnytol[rng.random(R) < 0.1] = 1.0
    nfeval = np.where(rng.random(R) < 0.3,
                      rng.integers(maxupd - 3 * C, maxupd + 1, R),
                      rng.integers(0, 10, R)).astype(np.int32)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()

    f_d = dev(f)
    ls = dict(alpha=dev(np.abs(r(R)) + np.float32(0.01)), lo=dev(lo),
              hi=dev(hi), f_lo=dev(f + r(R) * np.float32(0.1)),
              g_lo=dev(-np.abs(r(R))), f_hi=dev(f_hi), g_hi=dev(r(R)),
              a_new=dev(np.zeros(R, np.float32)), f_new=f_d,
              a_best=dev(np.zeros(R, np.float32)), f_best=f_d,
              reltol=dev(np.abs(r(R)) * np.float32(1e-3)),
              abstol=dev(np.abs(r(R)) * np.float32(1e-6)),
              found=dev(rng.random(R) < 0.1),
              searching=dev(rng.random(R) < 0.8), nfeval=dev(nfeval), t=0)
    dginit = dev(-np.abs(r(R)) - np.float32(0.1))
    return ls, (f_d, dginit, dev(spe), dev(tnytol))


def _ls_trials(rng, f, C, R):
    """Trial (f, g.d) at C steps around ``f``, 5% NaN and 5% inf f."""
    f_c = f[None].cpu().numpy() + rng.standard_normal((C, R)).astype(
        np.float32)
    f_c[rng.random((C, R)) < 0.05] = np.nan
    f_c[rng.random((C, R)) < 0.05] = np.inf
    gu_c = rng.standard_normal((C, R)).astype(np.float32)
    return torch.from_numpy(f_c).cuda(), torch.from_numpy(gu_c).cuda()


def _bits_equal(out, ref):
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    if out.dtype in ints:
        out, ref = out.view(ints[out.dtype]), ref.view(ints[out.dtype])
    assert out.dtype == ref.dtype and torch.equal(out, ref)


@pytest.mark.parametrize("C", [1, 2, 3, 4, 8, 12])
def test_ls_round_is_the_plain_round_bit_for_bit(gen, C):
    """The kernel's candidates from the initial state, then four rounds of
    fold + next candidates, against ``_ls_candidates`` / ``_ls_fold`` on
    the card: every state vector and candidate as bit patterns, and each
    round's flag set exactly when a row still searches.  The solver's
    ``f`` (which ``f_new`` and ``f_best`` start as) is left as it was."""
    from poismf_torch.kernels.ls_round import (STATE_FLOATS, _ls_candidates,
                                               _ls_fold)

    rng = np.random.default_rng(100 + C)
    R, maxupd, ftol = 5003, 750, 1e-4  # 5003: a ragged last block
    ls, (f, dginit, spe, tnytol) = _ls_state(rng, C, R, maxupd)
    f_before = f.clone()
    state, view = kernels.ls_round_state(ls)
    more = torch.zeros((5,), dtype=torch.int32, device="cuda")
    cands = torch.empty((C, R), device="cuda")
    kernels.reset_launch_counts()
    kernels.ls_round(state, cands, None, f, dginit, spe, tnytol, more[0],
                     maxupd=maxupd, ftol=ftol)
    ref = _ls_candidates(ls, spe, C)
    _bits_equal(cands, ref)
    assert more[0].item() == int(ls["searching"].any())
    plain, seen = ls, dict(found=0, budget=0, tightened=0, stopped=0)
    for t in range(4):
        f_c, gu_c = _ls_trials(rng, f, C, R)
        new = _ls_fold(plain, ref, f_c, gu_c, f, dginit, spe, tnytol,
                       maxupd, ftol, C)
        kernels.ls_round(state, cands, (f_c, gu_c), f, dginit, spe, tnytol,
                         more[t + 1], maxupd=maxupd, ftol=ftol)
        ref = _ls_candidates(new, spe, C)
        for key in STATE_FLOATS + ("found", "searching", "nfeval"):
            _bits_equal(view[key], new[key])
        _bits_equal(cands, ref)
        assert more[t + 1].item() == int(new["searching"].any())
        seen["found"] += int((new["found"] & ~plain["found"]).sum())
        seen["budget"] += int((plain["searching"]
                               & (new["nfeval"] >= maxupd)).sum())
        seen["tightened"] += int((new["reltol"] < plain["reltol"]).sum())
        seen["stopped"] += int((plain["searching"] & ~new["searching"]
                                & ~new["found"]).sum())
        plain = new
    assert torch.equal(f, f_before)
    assert all(n > 0 for n in seen.values()), seen
    assert kernels.launch_counts["ls_round"] == 5


def test_ls_round_on_no_rows_launches_nothing(gen):
    """R = 0: no launch, no count, the flag left at zero."""
    ls, row = _ls_state(np.random.default_rng(1), 4, 0)
    state, _ = kernels.ls_round_state(ls)
    more = torch.zeros((1,), dtype=torch.int32, device="cuda")
    kernels.reset_launch_counts()
    kernels.ls_round(state, torch.empty((4, 0), device="cuda"), None, *row,
                     more[0], maxupd=750, ftol=1e-4)
    assert kernels.launch_counts["ls_round"] == 0 and more.item() == 0


def test_float64_state_on_the_card_takes_the_plain_round(gen):
    """The kernel's launch refuses float64 state; ``kernels.ls_round``
    hands it to ``ls_round_torch`` on the card, so the solver's rounds
    give the plain pair's result and launch no ls_round."""
    from poismf_torch.kernels.ls_round import (_launch, _ls_candidates,
                                               _ls_fold)
    from poismf_torch.solvers import tncg

    rng = np.random.default_rng(6)
    C, R = 4, 1000
    ls, row = _ls_state(rng, C, R)
    ls = {k: v.double() if torch.is_tensor(v) and v.is_floating_point()
          else v for k, v in ls.items()}
    row = tuple(x.double() for x in row)
    state, _ = kernels.ls_round_state(ls)
    more = torch.zeros((1,), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="float64"):
        _launch(state, torch.empty((C, R), dtype=torch.float64,
                                   device="cuda"), None, *row, more[0],
                750, 1e-4)
    trials = [tuple(x.double() for x in _ls_trials(rng, row[0].float(), C,
                                                   R))
              for _ in range(tncg.MAX_LS)]
    f, dginit, spe, tnytol = row
    kernels.reset_launch_counts()
    out = tncg._ls_rounds(dict(ls), lambda cands, it=iter(trials): next(it),
                          f, dginit, spe, tnytol, 750, 1e-4, C, None)
    assert kernels.launch_counts["ls_round"] == 0 and out["t"] >= 2
    plain, it = ls, iter(trials)
    for _ in range(out["t"]):
        plain = _ls_fold(plain, _ls_candidates(plain, spe, C), *next(it), f,
                         dginit, spe, tnytol, 750, 1e-4, C)
    for key in ("alpha", "lo", "hi", "f_new", "a_new", "found", "nfeval"):
        _bits_equal(out[key], plain[key])


def _tncg_card_problem(layout):
    """(solver, args, keywords) of one float32 tncg solve on the card:
    the ELL of 3,000 synthetic users (P_MAX = 64: rows of extension
    chunks), a compact sub-ELL of 30% of its rows (as the cascade's
    compact rounds build one), or the flat COO."""
    from poismf_torch import sparse
    from poismf_torch.ops import ell as ell_ops
    from poismf_torch.solvers import tncg
    from poismf_torch.utils.data import synth_lastfm_like

    rows, cols, vals = synth_lastfm_like(np.random.default_rng(2), 3000,
                                         1500, 60_000)
    X = sparse.ingest((rows, cols, vals, (3000, 1500)), reindex=False)
    rng = np.random.default_rng(3)
    A = torch.from_numpy(rng.uniform(0.0, 0.3, (X.by_user.n_rows_pad, 16))
                         .astype(np.float32)).cuda()
    B = torch.from_numpy(rng.uniform(0.0, 0.3, (X.by_item.n_rows_pad, 16))
                         .astype(np.float32)).cuda()
    Bsum = B.sum(0)
    kw = dict(l2_reg=1e3, maxupd=200, reuse_prev=True, return_stats=True)
    if layout == "coo":
        return tncg.tncg_update, (A, B, sparse.to_device(X.by_user, "cuda"),
                                  Bsum), kw
    ell = ell_ops.ell_from_counts(X.by_user, device="cuda")
    assert any(b.ext is not None for b in ell.buckets)
    A_p = ell_ops.permute_rows(A, ell.perm)
    if layout == "ell":
        return tncg.tncg_update_ell, (A_p, ell_ops.gather_planes(
            B, ell, torch.bfloat16), ell, Bsum), kw
    plan = ell_ops.plan_compact(ell, 2)
    active = rng.random(ell.n_rows_ell) < 0.3
    sel = ell_ops.select_active(ell, plan, active, ell.host["row_nnz_perm"],
                                list(ell.host["src"]))
    assert sel is not None
    compact = ell_ops.build_compact(ell, plan, *sel[:4])
    nfeval0 = torch.zeros((compact.n_rows_ell,), dtype=torch.int32,
                          device="cuda")
    return tncg.tncg_update_ell, (
        A_p[compact.perm], ell_ops.gather_planes(B, compact, torch.bfloat16),
        compact, Bsum), dict(kw, nfeval0=nfeval0, max_outer=6, ls_cand=4)


@pytest.mark.parametrize("layout", ["ell", "compact", "coo"])
def test_tncg_kernel_rounds_equal_the_plain_rounds(gen, monkeypatch, layout):
    """A float32 tncg solve with ``return_stats`` on the card gives the
    same x (bit for bit), share and stats with its line-search rounds on
    ls_round as with the plain round forced (``kernels.ls_round`` set to
    ``ls_round_torch``), and launches ls_round once a round and once a
    search."""
    from poismf_torch.ops import ell as ell_ops

    monkeypatch.setattr(ell_ops, "P_MAX", 64)
    solve, args, kw = _tncg_card_problem(layout)
    outs = []
    for route in ("kernel", "plain"):
        if route == "plain":
            monkeypatch.setattr(kernels, "ls_round", kernels.ls_round_torch)
        kernels.reset_launch_counts()
        x, share, stats = solve(*args, **kw)
        # a launch a round, and one a search for its first candidates
        assert kernels.launch_counts["ls_round"] == (
            stats["ls_rounds"] + stats["outer_iters"] if route == "kernel"
            else 0)
        outs.append((x, share, stats))
    (x1, s1, st1), (x2, s2, st2) = outs
    _bits_equal(x1, x2)
    assert s1 == s2 and st1.keys() == st2.keys() and st1["ls_rounds"] > 0
    for name, v in st1.items():
        if isinstance(v, torch.Tensor):
            _bits_equal(v, st2[name])
        else:
            assert v == st2[name], name


def test_ls_round_is_one_launch_a_round(gen):
    """One C=4 line search on the kernel route, its trials' evaluator a
    stub that launches nothing: each round launches ls_round alone (one
    launch more forms round 1's candidates), beside at most the four
    launches that build the kernel's state and flags once a search."""
    from torch.profiler import ProfilerActivity, profile

    from poismf_torch.solvers import tncg

    rng = np.random.default_rng(5)
    C, R = 4, 4096
    ls, (f, dginit, spe, tnytol) = _ls_state(rng, C, R)
    trials = iter([_ls_trials(rng, f, C, R) for _ in range(tncg.MAX_LS)])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = tncg._ls_rounds(ls, lambda cands: next(trials), f, dginit,
                              spe, tnytol, 750, 1e-4, C, None)
        torch.cuda.synchronize()
    kernels_run = [e.name() for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA
                   and not e.name().startswith(("Memcpy", "Memset"))]
    rounds = sum("ls_round_kernel" in n for n in kernels_run)
    assert out["t"] >= 2 and rounds == out["t"] + 1
    assert len(kernels_run) - rounds <= 4, kernels_run
