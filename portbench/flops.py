"""Model FLOPs of one unit of a cell's work, counted on the reference.

The reference runs on the ``meta`` device under ``FlopCounterMode``, which
counts the convolutions and matrix products (forward and every backward,
the gradient penalty's double backward included) from their shapes.  The
masked-conv-flow inverses count by the work formula of ``roofline``: the
reference's row loop recomputes each row's context and would count more
than the algorithm needs."""
from __future__ import annotations

from unittest import mock

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import roofline, weights
from portbench.reference import gan, prng, sample

META = torch.device("meta")


def _meta_tree(node):
    if isinstance(node, weights.Leaf):
        dtype = torch.int64 if node.kind == "perm" else torch.float32
        return torch.empty(node.shape, dtype=dtype, device=META)
    if isinstance(node, list):
        return [_meta_tree(v) for v in node]
    out = {k: _meta_tree(v) for k, v in node.items() if v is not None}
    if "fwd_idx" in out:
        out["inv_idx"] = torch.empty_like(out["fwd_idx"])
    return out


def sample_call(cfg, b, n, length):
    """FLOPs of one ``forward_sample`` call: ``b`` start images, ``n`` samples
    each, ``length`` frames."""
    params = _meta_tree(weights.second_stage_tree(cfg))
    fs = cfg["first_stage"]
    s, hc = fs["min_spatial_size"], cfg["poke_embedder"]["nf_max"] + cfg["conditioner"]["nf_max"]
    mcf_flops = [0]

    def mcf_stub(p, z, h, order):
        mcf_flops[0] += roofline.k1_work(z.shape[0], s, z.shape[-1], hc)[0]
        return torch.empty_like(z)

    size = fs["spatial_size"]
    images = torch.empty((b, 1, size, size, 3), device=META)
    poke = torch.empty((b, size, size, 2), device=META)
    z = torch.empty((n, b, s, s, fs["z_dim"]), device=META)
    with mock.patch.object(sample, "mcf_inverse", mcf_stub), FlopCounterMode(display=False) as fc:
        sample.forward_sample(params, cfg, images, poke, z, length)
    return fc.get_total_flops() + mcf_flops[0]


def gan_step(cfg, tcfg):
    """FLOPs of one stage-1 train step at the traffic's batch."""
    nets = _meta_tree(weights.gan_trees(cfg))
    fs = cfg["first_stage"]
    step = gan.GanStep(nets, fs, tcfg, META)
    x = torch.empty((tcfg["batch"], tcfg["frames"], fs["spatial_size"], fs["spatial_size"], 3),
                    device=META)
    with FlopCounterMode(display=False) as fc:
        step(x, prng.prng_key(0))
    return fc.get_total_flops()
