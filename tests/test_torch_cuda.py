"""PyTorch port on a GPU: each hand-written CUDA kernel against its plain
PyTorch version on the same inputs (the line-search kernels f, f_gtd,
f_gtd_fused, f_gtd_multi and ray included; the fgh, hvp, fg, f, pg, f_gtd,
f_gtd_fused and f_gtd_multi plane sweeps and the ray kernels raygtd, ray
and rayf also at the edges of their tiling and on trials that land
exactly on zero, and launched twice for bitwise-equal outputs), the
wrappers' input checks,
the launch counters, small tncg, cg and pg fits on the card against the
same fits on the CPU, and the serving solves (``factors_multiple`` by
each method, a one-row ``factors_single``, ``top_n_batched_excl``) and
``ranking_metrics`` on the card against the same calls on the CPU.

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
    ("tncg", ("fgh", "hvp", "raygtd")),  # maxCGit 8 at k=16: plain HVPs
    ("cg", ("fg", "rayf")),
    ("pg", ("pg",)),
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


def test_factors_multiple_cg_converged_on_the_card_matches_the_cpu(gen):
    """cg run to convergence (150 iterations, f32 planes, as a batch of
    at most ``ELL_SERVE_NNZ_THRESHOLD`` nonzeros has them): each row's
    serving objective within 1e-4 of the CPU's."""
    _check_factors_multiple("cg", ("fg", "rayf"), 50, None, 1e-4)


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
    """A one-row ELL (a 128-row bucket, R a multiple of 8) through fgh,
    hvp and raygtd; the 2,500-item row as extension chunks.  Tolerances
    as above."""
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
    for name in ("fgh", "hvp", "raygtd"):
        assert kernels.launch_counts[name] > 0, name
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
