"""K2's cluster plan (``ops/cuda/mcf_unit_inverse.cluster_plan``) at every
MaCowUnit shape of every registry model, on the CPU.

K2 runs one thread-block cluster of G CTAs per example; the plan picks G and
counts the shared memory of one CTA.  These tests hold the plan to what the
kernel takes: G a portable cluster size that divides the hidden and the h
channels, a CTA within the H100's 232,448 bytes, and a split of the channels
that gives each one to exactly one rank.
"""
import pytest

from ipoke_tpu_torch import registry
from ipoke_tpu_torch.flows import mcf
from ipoke_tpu_torch.ops.cuda import mcf_unit_inverse as k2

KERNEL = (2, 3)   # (kseq, kpar) of every registry model


def _levels(name):
    spec = registry.build_specs(registry.MODELS[name])
    return spec.latent_size, spec.flow.level_channels()


@pytest.mark.parametrize("hc", [128, 0])
@pytest.mark.parametrize("name", sorted(registry.MODELS))
def test_plan_fits_every_level(name, hc):
    size, levels = _levels(name)
    for c in levels:
        hid = mcf.default_hidden(c)
        g, nbytes = k2.cluster_plan(c, hid, hc, *KERNEL, size, size)
        assert g in (1, 2, 4, 8)
        assert hid % g == 0 and hc % g == 0
        assert nbytes <= 232_448
        assert g == max(k2.allowed_clusters(c, hid, hc, *KERNEL, size, size))
        ranks = k2.rank_channels(g, hid, hc)
        assert len(ranks) == g
        hidden = sorted(j for own, _ in ranks for j in own)
        h = sorted(k for _, own in ranks for k in own)
        assert hidden == list(range(hid)) and h == list(range(hc))


@pytest.mark.parametrize("c,hc,want", [(64, 128, [8]), (64, 0, [8]), (32, 128, [2, 4, 8]),
                                       (4, 0, [1, 2, 4, 8]), (6, 12, [1, 2, 4])])
def test_allowed_clusters(c, hc, want):
    assert k2.allowed_clusters(c, mcf.default_hidden(c), hc, *KERNEL, 8, 8) == want


def test_shared_memory_falls_with_the_cluster():
    nbytes = [k2.cluster_smem_bytes(g, 32, 128, 128, *KERNEL, 8, 8) for g in (1, 2, 4, 8)]
    assert nbytes == sorted(nbytes, reverse=True)
    # C=64 at G=8: 2 latent copies, act_fn(h), activations, partials, two
    # weight slices of 32 hidden and 16 h channels each
    assert k2.cluster_smem_bytes(8, 64, 256, 128, *KERNEL, 8, 8) == 4 * (
        2 * 8 * ((8 * 65) | 1) + 8 * ((8 * 17) | 1) + 8 * 49 + 2 * 8 * 128
        + 2 * (32 * 385 + 128 * 49 + 128))


@pytest.mark.parametrize("c,hc,g", [(32, 128, 1), (64, 128, 4), (64, 0, 2)])
def test_explicit_cluster_that_does_not_fit_raises(c, hc, g):
    with pytest.raises(ValueError, match="exceed"):
        k2.cluster_plan(c, mcf.default_hidden(c), hc, *KERNEL, 8, 8, cluster=g)


@pytest.mark.parametrize("c,hc,g", [(6, 12, 8), (32, 128, 3), (32, 128, 16)])
def test_explicit_cluster_that_does_not_divide_raises(c, hc, g):
    with pytest.raises(ValueError, match="divide"):
        k2.cluster_plan(c, mcf.default_hidden(c), hc, *KERNEL, 8, 8, cluster=g)
