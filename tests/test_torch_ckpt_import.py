"""The port's reference-checkpoint converters (``ipoke_tpu_torch/ckpt/
torch_import.py``) against the JAX package's on the same numpy state_dicts:
bitwise, leaf for leaf.  The state_dicts are built from the key schema the
converters read (the JAX package's ``export_flow`` for the flow, the port's
``export_second_stage`` for the rest, the backbones' module layouts), since
no released checkpoint is in the repository."""
import numpy as np
import pytest
import torch

from ipoke_tpu.ckpt import torch_import as jti
from ipoke_tpu.experiments.second_stage import build_spec_from_config as jax_spec_of
from ipoke_tpu.flows.macow import FlowSpec as JaxFlowSpec
from ipoke_tpu_torch.ckpt import jax_bridge
from ipoke_tpu_torch.ckpt import torch_import as ti
from ipoke_tpu_torch.experiments.second_stage import build_spec_from_config
from ipoke_tpu_torch.flows import macow
from ipoke_tpu_torch.metrics import i3d, lpips
from ipoke_tpu_torch.utils import prng
from torch_ckpt_fixture import redraw, reference_tree
from torch_port_util import (CPU, assert_trees_equal, flatten, np_tree, port_flow_spec,
                             tiny_config)

JSPEC = JaxFlowSpec(num_steps=(2, 1), in_channels=8, hidden_channels=32, h_channels=12, factor=4)
PREFIXES = ("first_stage_model.", "poke_embedder.", "conditioner.")


@pytest.fixture(scope="module")
def specs(tmp_path_factory):
    cfg = tiny_config(tmp_path_factory.mktemp("cfg"))
    return jax_spec_of(cfg), build_spec_from_config(cfg, mcf_backend="scan")


@pytest.fixture(scope="module")
def tree(specs):
    return reference_tree(specs[1], seed=3)


def _flow_tree(seed=0):
    spec = port_flow_spec(JSPEC)
    return spec, redraw(jax_bridge.unbridge_flow(macow.init_multiscale(prng.prng_key(seed), spec)),
                        seed)


def test_flow_converts_as_jax():
    """JAX's export_flow of a tree -> the port's convert_flow equals JAX's,
    the port's export_flow equals JAX's, and bridge_flow of both trees is
    the same (JAX's tree bridged as JAX's own checkpoints are)."""
    spec, tree = _flow_tree()
    sd = jti.export_flow(tree, JSPEC)
    port_sd = ti.export_flow(tree, spec)
    assert set(port_sd) == set(sd)
    for k in sd:
        assert port_sd[k].dtype == sd[k].dtype and np.array_equal(port_sd[k], sd[k]), k
    ours = ti.convert_flow(sd, spec)
    theirs = np_tree(jti.convert_flow(sd, JSPEC))
    assert_trees_equal(ours, theirs)
    assert_trees_equal(ours, tree)   # the schema round trip is exact
    a, b = flatten(jax_bridge.bridge_flow(ours, CPU)), flatten(jax_bridge.bridge_flow(theirs, CPU))
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def _strip_u(tree):
    if isinstance(tree, dict):
        return {k: _strip_u(v) for k, v in tree.items() if k != "u"}
    if isinstance(tree, list):
        return [_strip_u(v) for v in tree]
    return tree


@pytest.mark.parametrize("spectral", ["orig", "weight"])
@pytest.mark.parametrize("embedded", [True, False], ids=["embedded", "sub_sds"])
def test_second_stage_converts_as_jax(specs, tree, spectral, embedded):
    """The port's export_second_stage -> both packages' convert_second_stage
    give the same tree; with the towers and the first stage embedded under
    their prefixes, or passed as separate sub-state_dicts (the released
    sub-model checkpoints filling the gaps)."""
    jspec, spec = specs
    full = ti.export_second_stage(tree, spec, spectral=spectral)
    sd, subs = dict(full), {}
    if not embedded:
        for key, pre in zip(("first_stage_sd", "poke_sd", "cond_sd"), PREFIXES):
            subs[key] = {k[len(pre):]: sd.pop(k) for k in [k for k in sd if k.startswith(pre)]}
    ours = ti.convert_second_stage(sd, spec, **subs)
    assert_trees_equal(ours, np_tree(jti.convert_second_stage(sd, jspec, **subs)))
    if spectral == "weight":   # plain weights convert back to the tree itself
        assert_trees_equal(ours, _strip_u(tree))
    else:   # torch's stored form: W_orig / (u^T W v) with u, v as exported
        w_orig = full["poke_embedder.decoder.blocks.0.conv1.conv.weight_orig"]
        u = full["poke_embedder.decoder.blocks.0.conv1.conv.weight_u"]
        v = full["poke_embedder.decoder.blocks.0.conv1.conv.weight_v"]
        w_mat = np.moveaxis(w_orig, 1, 0).reshape(w_orig.shape[1], -1)   # transpose conv: dim 1
        want = np.transpose(w_orig / float(u @ (w_mat @ v)), (2, 3, 0, 1))
        got = ours["poke_embedder"]["decoder"]["blocks"][0]["conv1"]["conv"]["w"]
        np.testing.assert_allclose(got, want, rtol=1e-6)
        assert "poke_embedder.decoder.blocks.0.conv1.conv.weight" not in full


def test_to_port_bridges_the_converted_tree(specs, tree):
    _, spec = specs
    sd = ti.export_second_stage(tree, spec)
    ours = flatten(ti.to_port(sd, spec, CPU))
    ref = flatten(jax_bridge.bridge_second_stage(ti.convert_second_stage(sd, spec), spec, CPU))
    assert set(ours) == set(ref) and all(torch.equal(ours[k], ref[k]) for k in ours)


@pytest.mark.parametrize("transposed", [False, True], ids=["Conv2d", "ConvTranspose2d"])
def test_spectral_fold_matches_torch(transposed):
    """sn_conv's fold against torch.nn.utils.spectral_norm's weight in eval
    mode; a transpose conv folds along dim 1 (dim 0 would be wrong)."""
    torch.manual_seed(0)
    conv = (torch.nn.ConvTranspose2d(6, 4, 4, stride=2, padding=1) if transposed
            else torch.nn.Conv2d(6, 4, 3, padding=1))
    conv = torch.nn.utils.spectral_norm(conv)
    x = torch.randn(2, 6, 5, 5)
    for _ in range(3):   # power iterations move u and v off their draw
        conv(x)
    conv.eval()
    conv(x)
    sd = {f"c.{k}": v.detach().numpy() for k, v in conv.state_dict().items()}
    assert "c.weight" not in sd and "c.weight_orig" in sd
    kw = dict(transpose=ti.convT2d_w, dim=1) if transposed else {}
    ours = ti.sn_conv(sd, "c", **kw)
    jkw = dict(transpose=jti.convT2d_w, dim=1) if transposed else {}
    assert_trees_equal(ours, np_tree(jti.sn_conv(sd, "c", **jkw)))
    want = (ti.convT2d_w if transposed else ti.conv2d_w)(conv.weight.detach().numpy())
    np.testing.assert_allclose(ours["w"], want, rtol=1e-6, atol=1e-7)
    if transposed:   # along dim 0, torch's v does not even fit the weight's shape
        with pytest.raises(ValueError):
            ti.sn_conv(sd, "c", transpose=ti.convT2d_w, dim=0)


# ---------------------------------------------------------------------------
# metric backbones, as small state_dicts in each network's key layout
# ---------------------------------------------------------------------------

def _bn(rng, sd, key, c):
    sd[f"{key}.weight"] = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    sd[f"{key}.bias"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
    sd[f"{key}.running_mean"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
    sd[f"{key}.running_var"] = (1 + 0.1 * rng.random(c)).astype(np.float32)


def _w(rng, *shape):
    return (0.1 * rng.standard_normal(shape)).astype(np.float32)


def i3d_state_dict(rng, c=2):
    """The reference's I3D in Unit3Dpy keys, every unit c -> c wide (the
    logits with a bias and no batch norm)."""
    sd = {}
    names = ["conv3d_1a_7x7", "conv3d_2b_1x1", "conv3d_2c_3x3"]
    for blk in i3d.INCEPTION:
        low = "mixed_" + blk.split("_", 1)[1]
        names += [f"{low}.branch_0", f"{low}.branch_1.0", f"{low}.branch_1.1",
                  f"{low}.branch_2.0", f"{low}.branch_2.1", f"{low}.branch_3.1"]
    for name in names:
        sd[f"{name}.conv3d.weight"] = _w(rng, c, c, 1, 1, 1)
        _bn(rng, sd, f"{name}.batch3d", c)
    sd["conv3d_0c_1x1.conv3d.weight"] = _w(rng, c, c, 1, 1, 1)
    sd["conv3d_0c_1x1.conv3d.bias"] = _w(rng, c)
    return sd


def vgg_state_dict(rng):
    sd = {}
    for idx in (0, 2, 5, 7, 10):
        sd[f"features.{idx}.weight"] = _w(rng, 3, 3, 3, 3)
        sd[f"features.{idx}.bias"] = _w(rng, 3)
    sd["classifier.0.weight"] = _w(rng, 4, 4)
    return sd


def lpips_state_dict(rng):
    return {f"lin{i}.model.1.weight": rng.random((1, c, 1, 1)).astype(np.float32)
            for i, c in enumerate((64, 128, 256, 512, 512))}


def pose_state_dict(rng, depth=50, c=2):
    from ipoke_tpu_torch.metrics.pose import BOTTLENECK_LAYERS

    sd = {"conv1.weight": _w(rng, c, c, 1, 1)}
    _bn(rng, sd, "bn1", c)
    for li, n_blocks in enumerate(BOTTLENECK_LAYERS[depth]):
        for bi in range(n_blocks):
            pre = f"layer{li + 1}.{bi}"
            for ci in (1, 2, 3):
                sd[f"{pre}.conv{ci}.weight"] = _w(rng, c, c, 1, 1)
                _bn(rng, sd, f"{pre}.bn{ci}", c)
            if bi == 0:
                sd[f"{pre}.downsample.0.weight"] = _w(rng, c, c, 1, 1)
                _bn(rng, sd, f"{pre}.downsample.1", c)
    for di in range(3):
        sd[f"deconv_layers.{di * 3}.weight"] = _w(rng, c, c, 1, 1)
        _bn(rng, sd, f"deconv_layers.{di * 3 + 1}", c)
    sd["final_layer.weight"] = _w(rng, c, c, 1, 1)
    sd["final_layer.bias"] = _w(rng, c)
    return sd


def inception_state_dict(rng, c=2):
    from ipoke_tpu_torch.metrics.fid import BLOCKS

    names = list(ti.INCEPTION_STEM)
    for bname, kind, _, _ in BLOCKS:
        names += [f"{bname}.{b}" for b in ti._INCEPTION_BRANCH_MAP[kind]]
    sd = {}
    for name in names:
        sd[f"{name}.conv.weight"] = _w(rng, c, c, 1, 1)
        _bn(rng, sd, f"{name}.bn", c)
    return sd


BACKBONES = {
    "convert_i3d": (i3d_state_dict, {}),
    "convert_torchvision_vgg": (vgg_state_dict, {}),
    "convert_lpips_lins": (lpips_state_dict, {}),
    "convert_pose_resnet": (pose_state_dict, {"depth": 50}),
    "convert_inception_v3": (inception_state_dict, {}),
}


@pytest.mark.parametrize("name", sorted(BACKBONES))
def test_backbone_converts_as_jax(tmp_path, name):
    make, kw = BACKBONES[name]
    sd = make(np.random.default_rng(len(name)))
    ours = getattr(ti, name)(sd, str(tmp_path / "port" / "w.npz"), **kw)
    theirs = getattr(jti, name)(sd, str(tmp_path / "jax" / "w.npz"), **kw)
    with np.load(ours) as a, np.load(theirs) as b:
        assert set(a.files) == set(b.files) and a.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.fixture
def weights_dir(tmp_path, monkeypatch):
    """$IPOKE_WEIGHTS pointed at a fresh directory; the metrics' caches
    cleared before and after, so no other test sees these weights."""
    monkeypatch.setenv("IPOKE_WEIGHTS", str(tmp_path))
    caches = (i3d.load_params, i3d.i3d, lpips._lins)
    for c in caches:
        c.cache_clear()
    yield tmp_path
    for c in caches:
        c.cache_clear()


def test_port_metrics_read_converted_npz(weights_dir):
    rng = np.random.default_rng(5)
    ti.convert_i3d(i3d_state_dict(rng), str(weights_dir / "i3d_kinetics_rgb.npz"))
    heads = lpips_state_dict(rng)
    ti.convert_lpips_lins(heads, str(weights_dir / "lpips_vgg_lins.npz"))
    params, pretrained = i3d.load_params()
    assert pretrained and len(params) == len(i3d._unit_names())
    assert params["logits"]["w"].shape == (1, 1, 1, 2, 2)
    lins, lins_pretrained = lpips._lins()
    assert lins_pretrained
    for i, w in enumerate(lins):
        assert np.array_equal(w, heads[f"lin{i}.model.1.weight"].reshape(-1))


# one spec per key family of the flow variants: the attention NICE coupling
# (pos_emb, in_resnet, the conv-attention blocks) and the gated conv on h of
# a conditioned MaCowUnit (cond_conv_block)
VARIANTS = {"attention": (dict(attention=True, heads=2), ".net.pos_emb"),
            "cond_conv": (dict(cond_conv=True), ".cond_conv_block.conv1.weight")}


def _variant_tree(family, seed=0):
    jspec = JaxFlowSpec(num_steps=(1,), in_channels=8, hidden_channels=16, h_channels=16,
                        factor=4, **VARIANTS[family][0])
    spec = port_flow_spec(jspec)
    tree = redraw(jax_bridge.unbridge_flow(macow.init_multiscale(prng.prng_key(seed), spec)), seed)
    return jspec, spec, tree


@pytest.mark.parametrize("family", sorted(VARIANTS))
def test_variant_flow_converts_as_jax(family):
    """A reference-shaped state_dict holding the family's keys: the port's
    convert_flow equals JAX's, leaf for leaf and bitwise."""
    jspec, spec, tree = _variant_tree(family)
    sd = ti.export_flow(tree, spec)
    assert any(k.endswith(VARIANTS[family][1]) for k in sd)
    assert_trees_equal(ti.convert_flow(sd, spec), np_tree(jti.convert_flow(sd, jspec)))


@pytest.mark.parametrize("family", sorted(VARIANTS))
def test_variant_flow_export_round_trip(family):
    """The port's export_flow of a variant tree converts back to that tree,
    and exports again to the same state_dict."""
    _, spec, tree = _variant_tree(family, seed=1)
    sd = ti.export_flow(tree, spec)
    back = ti.convert_flow(sd, spec)
    assert_trees_equal(back, tree)
    again = ti.export_flow(back, spec)
    assert set(again) == set(sd) and all(np.array_equal(again[k], sd[k]) for k in sd)


@pytest.mark.parametrize("key,what", [
    ("flow.flow.layers.0.0.units1.0.conv1.net.masked_conv.conv.weight_v", "MaCow v1"),
    ("flow.flow.sub_layers.0.norm_layer.loc", "fully connected flow")])
def test_legacy_flow_keys_raise(key, what):
    spec, tree = _flow_tree(1)
    sd = dict(ti.export_flow(tree, spec), **{key: np.zeros((2, 2), np.float32)})
    with pytest.raises(NotImplementedError, match="queue 1 item 7.3") as err:
        ti.convert_flow(sd, spec)
    assert what in str(err.value)


@pytest.mark.parametrize("kind", ["stack", "variants"])
def test_variant_trees_round_trip_through_npz(kind, tmp_path):
    """A port flow tree -> JAX's layout -> ckpt/io npz -> back, bitwise: a
    multistack tree ('up': its h transforms are transpose convs) with conv-LU
    leaves, and a flow with conv-LU, attention and cond_conv leaves."""
    from ipoke_tpu_torch.ckpt import io
    from ipoke_tpu_torch.flows import transformer
    from ipoke_tpu_torch.flows.multistack import StackSpec

    if kind == "stack":
        spec = StackSpec(levels=((1,), (1,)), factors=(4, 2), in_channels=8,
                         mid_channels_factor=2, h_channels=16, reshape="up", use_1x1=True)
    else:
        spec = port_flow_spec(JaxFlowSpec(num_steps=(1,), in_channels=8, hidden_channels=16,
                                          h_channels=16, factor=4, use_1x1=True, attention=True,
                                          cond_conv=True))
    params = transformer.init(prng.prng_key(2), spec, CPU)
    io.save(tmp_path / "flow.npz", {"flow": jax_bridge.unbridge_flow(params)})
    loaded, _ = io.load(tmp_path / "flow.npz")
    back = jax_bridge.bridge_flow(loaded["flow"], CPU)
    a, b = flatten(params), flatten(back)
    assert set(a) == set(b) and all(a[k].dtype == b[k].dtype and torch.equal(a[k], b[k])
                                    for k in a)


def test_load_lightning_ckpt(tmp_path):
    """A Lightning-shaped file (state_dict beside the trainer's entries and
    plain hyper-parameters) reads back as numpy, key for key."""
    g = torch.Generator().manual_seed(0)
    sd = {"flow.flow.layers.0.0.actnorm1.log_scale": torch.randn(4, 1, 1, generator=g),
          "first_stage_model.motion_bias": torch.randn(1, 2, 8, 8, generator=g),
          "flow.flow.shuffle_layers.0.forward_shuffle_idx": torch.randperm(4, generator=g)}
    path = tmp_path / "epoch=3-FVD-val=80.000.ckpt"
    torch.save({"epoch": 3, "global_step": 1200, "pytorch-lightning_version": "1.1.7",
                "state_dict": sd, "optimizer_states": [{"state": {}, "param_groups": []}],
                "lr_schedulers": [], "hyper_parameters": {"lr": 1e-3, "name": "iper_128",
                                                          "num_steps": [10, 5]}}, path)
    out = ti.load_lightning_ckpt(str(path))
    assert set(out) == set(sd)
    for k, v in sd.items():
        assert isinstance(out[k], np.ndarray) and np.array_equal(out[k], v.numpy())


@pytest.mark.slow
def test_flagship_depth_flow_converts_and_reverses_as_jax():
    """The registry flagship's flow topology (15 levels, 50 MaCowSteps, 32
    channels peeled 2 at a time) at reduced widths (hidden 16, h 8): the
    port's init with weight-norm gains 0.02 -> JAX's export_flow -> both
    packages' convert_flow (bitwise equal) -> the port's reverse on 'scan'
    against JAX's, within 1e-3 of 1 + max|ref| (50 steps of f32 against the
    2e-4 of a 3-level flow, tests/test_torch_flow.py)."""
    import jax
    import jax.numpy as jnp

    from ipoke_tpu.flows import transformer as jtransformer
    from ipoke_tpu_torch import registry
    from ipoke_tpu_torch.flows import transformer
    from torch_port_util import set_wn_gains, t

    jspec = JaxFlowSpec(num_steps=registry.MODELS[registry.FLAGSHIP].num_steps, in_channels=32,
                        hidden_channels=16, h_channels=8, factor=16)
    spec = port_flow_spec(jspec)
    tree = np_tree(set_wn_gains(jax_bridge.unbridge_flow(
        transformer.init(prng.prng_key(11), spec, CPU)), 0.02))
    sd = jti.export_flow(tree, jspec)
    ours = ti.convert_flow(sd, spec)
    theirs = jti.convert_flow(sd, jspec)
    assert_trees_equal(ours, np_tree(theirs))
    rng = np.random.default_rng(12)
    z = rng.standard_normal(transformer.reverse_input_shape(spec, 2, 8, 32)).astype(np.float32)
    h = rng.standard_normal((2, 8, 8, 8)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, z, h: jtransformer.reverse(p, jspec, z, h))(
        theirs, jnp.asarray(z), jnp.asarray(h)))
    got = transformer.reverse(jax_bridge.bridge_flow(ours, CPU), spec, t(z), t(h)).numpy()
    assert np.isfinite(ref).all()
    assert np.abs(got - ref).max() <= 1e-3 * (1 + np.abs(ref).max())
