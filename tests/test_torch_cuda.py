"""PyTorch port on a GPU: each hand-written CUDA kernel against its plain
PyTorch version on the same inputs, the wrappers' input checks, the launch
counters, and a small fit on the card against the same fit on the CPU.

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
    with pytest.raises(ValueError, match="candidates"):
        kernels.raygtd_multi_bucket(vals, vals, vals,
                                    torch.ones((9, 128), device="cuda"))


def test_launch_counts_count_kernel_launches_only(gen):
    bg, vals, a_t = _inputs(gen, 4, 16, 128, torch.bfloat16)
    kernels.reset_launch_counts()
    _, _, _, w2, px = kernels.fgh_bucket(bg, vals, a_t)
    kernels.hvp_bucket(bg, w2, a_t)
    _, bv = kernels.hvp_bucket(bg, w2, a_t, want_bv=True)
    kernels.raygtd_multi_bucket(px, bv, vals, a_t[:4].contiguous())
    kernels.fgh_bucket(bg.cpu(), vals.cpu(), a_t.cpu())  # plain version
    assert kernels.launch_counts == dict(fgh=1, hvp=1, hvp_bv=1, raygtd=1)


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
