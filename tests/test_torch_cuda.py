"""PyTorch port on a GPU: each hand-written CUDA kernel against its plain
PyTorch version on the same inputs (the line-search kernels f, f_gtd,
f_gtd_fused, f_gtd_multi and ray included; the fgh, hvp, fg, f and pg
plane sweeps and the ray kernels raygtd, ray and rayf also at the edges of
their tiling and on trials that land exactly on zero, and launched twice
for bitwise-equal outputs), the wrappers' input checks,
the launch counters, and small tncg, cg and pg fits on the card against
the same fits on the CPU.

Every test needs a CUDA device and skips without one.  The file imports
neither JAX nor the JAX package, so it also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance: rtol 1e-4 (float32 sums taken in another order), identical
inf/NaN patterns."""

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


@pytest.mark.parametrize("C", [1, 2, 3, 4, 8])
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


@pytest.mark.parametrize("C", [1, 2, 3, 5, 8])
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
    for call in (kernels.fg_bucket, kernels.f_bucket, kernels.pg_bucket):
        with pytest.raises(ValueError, match="multiple of 8"):
            call(bg[:, :, :100].contiguous(), vals[:, :100].contiguous(),
                 a_t[:, :100].contiguous())
        with pytest.raises(ValueError, match="shared memory"):
            call(torch.zeros((2000, 16, 128), device="cuda"), vals,
                 torch.zeros((2000, 128), device="cuda"))
        with pytest.raises(ValueError, match="aligned"):
            call(bg.flatten()[1:1 + 3 * 16 * 128].view(3, 16, 128), vals,
                 a_t[:3].contiguous())
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
    # limits of fg, f and pg: k = 384 in bf16 and 256 in f32 run
    for k, pdt in ((384, torch.bfloat16), (256, torch.float32)):
        bg, vals, a_t = _inputs(gen, k, 8, 64, pdt)
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
    with pytest.raises(ValueError, match="candidates"):
        kernels.raygtd_multi_bucket(vals, vals, vals,
                                    torch.ones((9, 128), device="cuda"))
    with pytest.raises(ValueError, match="candidates"):
        kernels.rayf_multi_bucket(vals, vals, vals,
                                  torch.ones((9, 128), device="cuda"))
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


@pytest.mark.parametrize("method", ["tncg", "cg", "pg"])
def test_float64_fit_on_the_card_raises(gen, method):
    X = (np.arange(8) % 4, np.arange(8) % 3, np.ones(8), (4, 3))
    with pytest.raises(ValueError, match="use_float=False"):
        PoisMF(k=2, method=method, use_float=False, device="cuda").fit(X)


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
    kernels.fgh_bucket(bg.cpu(), vals.cpu(), a_t.cpu())  # plain versions
    kernels.pg_bucket(bg.cpu(), vals.cpu(), a_t.cpu())
    kernels.f_gtd_multi_bucket(bg.cpu(), vals.cpu(), a_t.cpu(), a_t.cpu(),
                               a_t[:3].cpu(), a_t[:, 0].cpu(), 1.0)
    assert kernels.launch_counts == dict(
        fgh=1, hvp=1, hvp_bv=1, raygtd=1, fg=1, rayf=1, pg=1, f=1, f_gtd=1,
        f_gtd_fused=1, f_gtd_multi=1, ray=1)


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
    (dict(method="cg"), ("fg", "rayf")),  # ray line search
    (dict(method="cg", limit_step=False), ("fg",)),  # fused trials
    (dict(method="pg", l2_reg=10.0, initial_step=1e-3), ("pg",)),
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
