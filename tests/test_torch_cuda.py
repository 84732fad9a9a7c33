"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device: a CUDA
kernel has no CPU mode.  The file imports neither JAX nor the JAX package,
so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q
"""
import pytest
import torch

from ipoke_tpu_torch.flows import mcf
from ipoke_tpu_torch.ops.cuda import _build
from ipoke_tpu_torch.ops.cuda import mcf_inverse as k1
from ipoke_tpu_torch.ops.cuda import mcf_unit_inverse as k2

TOL = 2e-4   # tests/test_pallas_mcf.py, tests/test_pallas_unit.py


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _weights(gen, c, hid, hc, kernel, dev):
    w = torch.randn((hid, c) + kernel, generator=gen) * 0.1
    w1 = torch.randn(2 * c, hid + hc, generator=gen) * 0.2 / (hid + hc) ** 0.5
    b1 = torch.randn(2 * c, generator=gen) * 0.05
    return [a.to(dev) for a in (w, w1, b1)]


def _mcf(c, hc, order, dev, seed, kernel=(2, 3)):
    """K1's inputs for one MCF of ``order``, w_shift as stored: (kseq, kpar)
    for A/B, (kpar, kseq) for C/D."""
    gen = torch.Generator().manual_seed(seed)
    z = torch.randn(8, 8, 8, c, generator=gen).to(dev)
    h = torch.randn(8, 8, 8, hc, generator=gen).to(dev) if hc else None
    w, w1, b1 = _weights(gen, c, mcf.default_hidden(c), hc,
                         kernel if order in "AB" else kernel[::-1], dev)
    return z, h, w, w1, b1


K1_CASES = [(c, hc, g, order) for c, hc in [(32, 128), (64, 128), (4, 0), (6, 12)]
            for g in k1.allowed_clusters(c, mcf.default_hidden(c), hc, 2, 3, 8, 8)
            for order in k1.ORDERS]


@pytest.mark.gpu
@pytest.mark.parametrize("c,hc,g,order", K1_CASES)
def test_k1_kernel_matches_plain(cuda, c, hc, g, order):
    z, h, w, w1, b1 = _mcf(c, hc, order, cuda, c)
    n0 = k1.mcf_inverse.launches
    out = k1.mcf_inverse(z, h, w, w1, b1, order, cluster=g)
    torch.cuda.synchronize()
    assert k1.mcf_inverse.launches == n0 + 1
    ref = k1.mcf_inverse_plain(z, h, w, w1, b1, order)
    torch.testing.assert_close(out, ref, rtol=TOL, atol=TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("order", k1.ORDERS)
@pytest.mark.parametrize("kernel,g", [((3, 5), 4), ((1, 3), 2)])
def test_k1_other_kernel_extents_match_plain(cuda, kernel, g, order):
    """Kernel extents other than the registry's 2 x 3 take the kernel's
    run-time-extent path."""
    z, h, w, w1, b1 = _mcf(8, 16, order, cuda, 12, kernel)
    out = k1.mcf_inverse(z, h, w, w1, b1, order, cluster=g)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, k1.mcf_inverse_plain(z, h, w, w1, b1, order),
                               rtol=TOL, atol=TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("c,hc,order", [(32, 128, "A"), (64, 0, "D")])
def test_k1_two_launches_are_bitwise_equal(cuda, c, hc, order):
    """The partials are summed in rank order, so a launch repeats bit for bit."""
    args = _mcf(c, hc, order, cuda, 5)
    a = k1.mcf_inverse(*args, order)
    b = k1.mcf_inverse(*args, order)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.gpu
def test_k1_raises_on_a_cluster_that_does_not_fit(cuda):
    z, h, w, w1, b1 = _mcf(64, 128, "A", cuda, 3)
    with pytest.raises(ValueError):   # 2 CTAs cannot hold a C=64 MCF's slice
        k1.mcf_inverse(z, h, w, w1, b1, cluster=2)
    with pytest.raises(ValueError):   # 3 is no cluster size
        k1.mcf_inverse(z, h, w, w1, b1, cluster=3)
    # the launcher refuses both on its own, without launching
    lib, stream = _build.load("mcf_inverse"), torch.cuda.current_stream(cuda).cuda_stream
    for g in (2, 3):
        err = lib(z.data_ptr(), h.data_ptr(), w.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                  z.data_ptr(), 8, 8, 8, 64, 256, 128, 2, 3, 1.0, 0, 0, 0, g, stream)
        assert err != 0


def _unit(c, hc, dev, seed, kernel=(2, 3)):
    gen = torch.Generator().manual_seed(seed)
    y = torch.randn(8, 8, 8, c, generator=gen).to(dev)
    h = torch.randn(8, 8, 8, hc, generator=gen).to(dev) if hc else None
    hid = mcf.default_hidden(c)
    weights = [_weights(gen, c, hid, hc, k, dev) for k in (kernel, kernel, kernel[::-1], kernel[::-1])]
    an1, an2 = ((torch.randn(2, c, generator=gen) * 0.1).to(dev) for _ in range(2))
    return y, h, weights, an1, an2


K2_CASES = [(c, hc, g) for c, hc in [(32, 128), (64, 128), (4, 0), (6, 12)] 
            for g in k2.allowed_clusters(c, mcf.default_hidden(c), hc, 2, 3, 8, 8)]


@pytest.mark.gpu
@pytest.mark.parametrize("c,hc,g", K2_CASES)
def test_k2_kernel_matches_plain(cuda, c, hc, g):
    y, h, weights, an1, an2 = _unit(c, hc, cuda, 100 + c)
    n0 = k2.macow_unit_inverse.launches
    out = k2.macow_unit_inverse(y, h, weights, an1, an2, cluster=g)
    torch.cuda.synchronize()
    assert k2.macow_unit_inverse.launches == n0 + 1
    ref = k2.macow_unit_inverse_plain(y, h, weights, an1, an2)
    torch.testing.assert_close(out, ref, rtol=TOL, atol=TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,g", [((3, 5), 4), ((1, 3), 2)])
def test_k2_other_kernel_extents_match_plain(cuda, kernel, g):
    """Kernel extents other than the registry's 2 x 3 take the kernel's
    run-time-extent path."""
    y, h, weights, an1, an2 = _unit(8, 16, cuda, 11, kernel)
    out = k2.macow_unit_inverse(y, h, weights, an1, an2, cluster=g)
    torch.cuda.synchronize()
    ref = k2.macow_unit_inverse_plain(y, h, weights, an1, an2)
    torch.testing.assert_close(out, ref, rtol=TOL, atol=TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("c,hc", [(32, 128), (64, 0)])
def test_k2_two_launches_are_bitwise_equal(cuda, c, hc):
    """The partials are summed in rank order, so a launch repeats bit for bit."""
    y, h, weights, an1, an2 = _unit(c, hc, cuda, 7)
    a = k2.macow_unit_inverse(y, h, weights, an1, an2)
    b = k2.macow_unit_inverse(y, h, weights, an1, an2)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.gpu
def test_k2_raises_on_a_cluster_that_does_not_fit(cuda):
    y, h, weights, an1, an2 = _unit(32, 128, cuda, 3)
    with pytest.raises(ValueError):   # 1 CTA cannot hold a C=32 unit's slices
        k2.macow_unit_inverse(y, h, weights, an1, an2, cluster=1)
    with pytest.raises(ValueError):   # 3 is no cluster size
        k2.macow_unit_inverse(y, h, weights, an1, an2, cluster=3)
    # the launcher refuses it on its own, without launching
    ptrs = [t.data_ptr() for w in weights for t in w]
    err = _build.load("mcf_unit_inverse")(
        y.data_ptr(), h.data_ptr(), *ptrs, an1.data_ptr(), an2.data_ptr(), y.data_ptr(),
        8, 8, 8, 32, 128, 128, 2, 3, 1.0, 0, 1, torch.cuda.current_stream(cuda).cuda_stream)
    assert err != 0


@pytest.mark.gpu
def test_kernels_raise_on_inputs_they_do_not_take(cuda):
    z = torch.randn(2, 8, 8, 4, device=cuda)
    w, w1, b1 = _weights(torch.Generator().manual_seed(0), 4, 16, 0, (2, 3), cuda)
    with pytest.raises(ValueError):
        k1.mcf_inverse(z.double(), None, w, w1, b1)
    with pytest.raises(ValueError):
        k1.mcf_inverse(z.transpose(1, 2), None, w, w1, b1)
    with pytest.raises(ValueError):
        k1.mcf_inverse(z, None, w, w1[:, :-1].contiguous(), b1)
    with pytest.raises(ValueError):   # C/D take w_shift as (hid, C, kpar, kseq): kpar 2 is even
        k1.mcf_inverse(z, None, w, w1, b1, "C")
    with pytest.raises(ValueError):
        k1.mcf_inverse(z, None, w, w1, b1, "E")
