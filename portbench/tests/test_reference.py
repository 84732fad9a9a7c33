"""The frozen reference against the port's plain CPU path at a tiny size,
and the benchmark's weight trees against the port's own parameter trees."""
import copy
import json

import torch

from portbench import inputs, layout, weights
from portbench.port import port_spec
from portbench.reference import gan as ref_gan
from portbench.reference import sample as ref_sample
from portbench.result import Ctx


def _ctx(pkg, name, seed=7):
    cell = layout.cell(name, pkg)
    return Ctx(name, cell, layout.config(cell["config"], pkg), layout.traffic(cell["traffic"], pkg),
               seed, 0.0, False, torch.device("cpu"), 0.0)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


def test_second_stage_tree_is_the_ports(tiny):
    from ipoke_tpu_torch.models import second_stage
    from ipoke_tpu_torch.utils import prng
    _, pkg = tiny
    cfg = json.loads((pkg / "configs" / "tiny.json").read_text())
    ours = weights.make(weights.second_stage_tree(cfg), torch.Generator().manual_seed(0), "cpu",
                        0.05, 0.02)
    theirs = second_stage.init(prng.prng_key(0), port_spec(cfg), device="cpu")
    assert _shapes(ours) == _shapes(theirs)


def test_gan_trees_are_the_ports(tiny):
    from ipoke_tpu_torch.models import discriminators as D
    from ipoke_tpu_torch.models import first_stage
    from ipoke_tpu_torch.utils import prng
    _, pkg = tiny
    cfg = json.loads((pkg / "configs" / "tiny.json").read_text())
    ours = weights.make(weights.gan_trees(cfg), torch.Generator().manual_seed(0), "cpu", 0.05, None)
    fs = port_spec(cfg).first_stage
    assert _shapes(ours["gen"]) == _shapes(first_stage.init(prng.prng_key(0), fs, "cpu", spectral_u=True))
    assert _shapes(ours["ds"]) == _shapes(D.init_patch_disc(prng.prng_key(1), D.PatchDiscSpec()))
    assert _shapes(ours["dt"]) == _shapes(D.init_temp_disc(prng.prng_key(2), D.TempDiscSpec(32, 4)))


def test_weights_scales_and_permutations():
    tree = {"a": weights.Leaf((1000,)), "gamma": weights.Leaf((4,), "ones"),
            "u": weights.Leaf((16,), "unit"), "g": weights.Leaf((3,), "gain"),
            "p": {"fwd_idx": weights.Leaf((6,), "perm"), "inv_idx": None}}
    made = weights.make(tree, torch.Generator().manual_seed(1), "cpu", 0.05, 0.02)
    assert 0.04 < float(made["a"].std()) < 0.06
    assert torch.equal(made["gamma"], torch.ones(4)) and torch.allclose(made["g"], torch.full((3,), 0.02))
    assert abs(float(torch.linalg.vector_norm(made["u"])) - 1) < 1e-6
    p = made["p"]
    assert torch.equal(p["fwd_idx"][p["inv_idx"]], torch.arange(6))


def test_reference_sampling_matches_the_port(tiny):
    from ipoke_tpu_torch.models import second_stage
    _, pkg = tiny
    ctx = _ctx(pkg, "tiny.sample")
    drv = layout.driver("sample", pkg)
    params = drv.make_params(ctx)
    images, pokes, z = drv.call_inputs(ctx, 3)
    port = second_stage.forward_sample(params, port_spec(ctx.config), {"images": images, "poke": pokes},
                                       z=z, length=3)
    ref = ref_sample.forward_sample(params, ctx.config, images, pokes, z, 3)
    assert port.shape == ref.shape == (2, 2, 3, 32, 32, 3)
    assert float((port - ref).abs().max()) < 1e-5
    assert float(ref.std()) > 1e-3       # the videos carry signal, not a constant


def test_reference_gan_step_matches_the_port(tiny):
    _, pkg = tiny
    ctx = _ctx(pkg, "tiny.gan")
    drv = layout.driver("gan", pkg)
    nets = drv.make_nets(ctx)
    start = copy.deepcopy(nets)
    state, step = drv.port_step(ctx, nets)
    x = drv.batch(ctx, 0)
    state, m = step(state, {"images": x}, drv.key(ctx, 0))
    rstep = ref_gan.GanStep(copy.deepcopy(start), ctx.config["first_stage"], ctx.traffic, ctx.device)
    out = rstep(x, drv.key(ctx, 0))
    for k in drv.LOSSES:
        assert abs(float(m[k]) - float(out[k])) <= 1e-5 * abs(float(out[k]))
    b1 = ctx.traffic["adam"]["b1"]
    # the first gradients, as each Adam holds them; the generator's follows the
    # discriminators' first Adam step, which moves each weight by about lr
    # whatever the size of its gradient, so it carries their round-off further
    for n, tol in (("dt", 1e-5), ("ds", 1e-5), ("gen", 1e-3)):
        port_g = drv.adam_first(getattr(state, f"{n}_opt"), b1)
        ref_g = [float(torch.linalg.vector_norm(m)) / (1 - b1) for m in rstep.opts[n].mu]
        assert drv.leaf_gap(port_g, ref_g) < tol


def test_inputs_repeat_from_the_seed():
    g1, g2 = inputs.generator("cpu", 2**31 + 5, "call", 3), inputs.generator("cpu", 2**31 + 5, "call", 3)
    a = inputs.sparse_pokes(g1, 2, 32, "cpu")
    assert torch.equal(a, inputs.sparse_pokes(g2, 2, 32, "cpu"))
    assert int((a.abs().sum(-1) > 0).sum()) == 2 * 25      # one 5x5 patch per image
    v = inputs.blob_videos(inputs.generator("cpu", 1, "batch"), 2, 4, 32, "cpu")
    assert v.shape == (2, 4, 32, 32, 3) and float(v.abs().max()) <= 1.0
