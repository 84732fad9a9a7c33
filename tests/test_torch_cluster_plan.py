"""The cluster plans of K1 (``ops/cuda/mcf_inverse.cluster_plan``, one
weight slice) and K2 (``ops/cuda/mcf_unit_inverse.cluster_plan``, a ring of
two) at every MCF shape of every registry model, on the CPU.

Both kernels run one thread-block cluster of G CTAs per example; the plan
picks G and counts the shared memory of one CTA.  These tests hold the plan
to what the kernel takes: G a portable cluster size that divides the hidden
and the h channels, a CTA within the H100's 232,448 bytes, and a split of
the channels that gives each one to exactly one rank.
"""
import pytest

from ipoke_tpu_torch import registry
from ipoke_tpu_torch.flows import mcf
from ipoke_tpu_torch.ops.cuda import mcf_inverse as k1
from ipoke_tpu_torch.ops.cuda import mcf_unit_inverse as k2

KERNEL = (2, 3)   # (kseq, kpar) of every registry model
PLANS = {"K1": k1, "K2": k2}


def _levels(name):
    spec = registry.build_specs(registry.MODELS[name])
    return spec.latent_size, spec.flow.level_channels()


@pytest.mark.parametrize("kernel", sorted(PLANS))
@pytest.mark.parametrize("hc", [128, 0])
@pytest.mark.parametrize("name", sorted(registry.MODELS))
def test_plan_fits_every_level(name, hc, kernel):
    plan = PLANS[kernel]
    size, levels = _levels(name)
    for c in levels:
        hid = mcf.default_hidden(c)
        g, nbytes = plan.cluster_plan(c, hid, hc, *KERNEL, size, size)
        assert g in (1, 2, 4, 8)
        assert hid % g == 0 and hc % g == 0
        assert nbytes <= 232_448
        assert g == max(plan.allowed_clusters(c, hid, hc, *KERNEL, size, size))
        ranks = k1.rank_channels(g, hid, hc)
        assert len(ranks) == g
        hidden = sorted(j for own, _ in ranks for j in own)
        h = sorted(k for _, own in ranks for k in own)
        assert hidden == list(range(hid)) and h == list(range(hc))


@pytest.mark.parametrize("kernel,c,hc,want", [
    ("K2", 64, 128, [8]), ("K2", 64, 0, [8]), ("K2", 32, 128, [2, 4, 8]),
    ("K2", 4, 0, [1, 2, 4, 8]), ("K2", 6, 12, [1, 2, 4]),
    # one slice: C=32 fits a single CTA, C=64 from G=4
    ("K1", 32, 128, [1, 2, 4, 8]), ("K1", 64, 128, [4, 8]), ("K1", 64, 0, [4, 8]),
    ("K1", 16, 128, [1, 2, 4, 8]), ("K1", 4, 0, [1, 2, 4, 8]), ("K1", 6, 12, [1, 2, 4])])
def test_allowed_clusters(kernel, c, hc, want):
    assert PLANS[kernel].allowed_clusters(c, mcf.default_hidden(c), hc, *KERNEL, 8, 8) == want


@pytest.mark.parametrize("kernel", sorted(PLANS))
def test_shared_memory_falls_with_the_cluster(kernel):
    plan = PLANS[kernel]
    nbytes = [plan.cluster_smem_bytes(g, 32, 128, 128, *KERNEL, 8, 8) for g in (1, 2, 4, 8)]
    assert nbytes == sorted(nbytes, reverse=True)


def test_k2_shared_memory_term_by_term():
    # C=64 at G=8: 2 latent copies, act_fn(h), activations, partials, two
    # weight slices of 32 hidden and 16 h channels each
    assert k2.cluster_smem_bytes(8, 64, 256, 128, *KERNEL, 8, 8) == 4 * (
        2 * 8 * ((8 * 65) | 1) + 8 * ((8 * 17) | 1) + 8 * 49 + 2 * 8 * 128
        + 2 * (32 * 385 + 128 * 49 + 128))


def test_k1_shared_memory_term_by_term():
    # C=32, hid=128, hc=128 at G=1: 2 latent copies (8 rows of (8*33)|1),
    # act_fn(h) (8 rows of (8*129)|1), activations (8 x 257), partials
    # (2 x 8 x 64), one weight slice (128 w_shift rows of (32*6)|1, 64 w1
    # rows of 257, 64 of b1)
    assert k1.cluster_smem_bytes(1, 32, 128, 128, *KERNEL, 8, 8) == 4 * (
        4_240 + 8_264 + 2_056 + 1_024 + 41_216) == 227_200
    # the same shapes with K2's two slices do not fit one CTA
    assert k2.cluster_smem_bytes(1, 32, 128, 128, *KERNEL, 8, 8) == 227_200 + 4 * 41_216


@pytest.mark.parametrize("kernel,c,hc,g", [
    ("K2", 32, 128, 1), ("K2", 64, 128, 4), ("K2", 64, 0, 2),
    ("K1", 64, 128, 2), ("K1", 64, 0, 2), ("K1", 64, 128, 1)])
def test_explicit_cluster_that_does_not_fit_raises(kernel, c, hc, g):
    with pytest.raises(ValueError, match="exceed"):
        PLANS[kernel].cluster_plan(c, mcf.default_hidden(c), hc, *KERNEL, 8, 8, cluster=g)


@pytest.mark.parametrize("kernel", sorted(PLANS))
@pytest.mark.parametrize("c,hc,g", [(6, 12, 8), (32, 128, 3), (32, 128, 16)])
def test_explicit_cluster_that_does_not_divide_raises(c, hc, g, kernel):
    with pytest.raises(ValueError, match="divide"):
        PLANS[kernel].cluster_plan(c, mcf.default_hidden(c), hc, *KERNEL, 8, 8, cluster=g)


@pytest.mark.parametrize("c,s,g,slices,nbytes", [
    # plants_128 with 32 augment channels: level 0 at 8x8
    (96, 8, 8, 1, 229_952),
    # a registry width keeps the ring of two
    (64, 8, 8, 2, 197_248),
    # iper_128's multistack 'down' block at 4x4
    (128, 4, 8, 1, 176_256)])
def test_k2_slice_plan(c, s, g, slices, nbytes):
    hid, hc = mcf.default_hidden(c), 128
    assert k2.slice_plan(c, hid, hc, *KERNEL, s, s) == slices
    assert k2.cluster_plan(c, hid, hc, *KERNEL, s, s) == (g, nbytes)
    assert nbytes == k2.cluster_smem_bytes(g, c, hid, hc, *KERNEL, s, s, slices)
    assert g == max(k2.allowed_clusters(c, hid, hc, *KERNEL, s, s, slices))
    if slices == 1:   # two slices fit no G
        assert k2.allowed_clusters(c, hid, hc, *KERNEL, s, s) == []


def test_k2_one_slice_too_wide_raises():
    # C=128 at 8x8: one slice needs 238,080 bytes at G=8
    assert k2.cluster_smem_bytes(8, 128, 256, 128, *KERNEL, 8, 8, 1) == 238_080
    with pytest.raises(ValueError, match="one weight slice or two"):
        k2.cluster_plan(128, 256, 128, *KERNEL, 8, 8)
