"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device: a CUDA
kernel has no CPU mode.  The file imports neither JAX nor the JAX package,
so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q
"""
import numpy as np
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


def _unit(c, hc, dev, seed, kernel=(2, 3), s=8):
    gen = torch.Generator().manual_seed(seed)
    y = torch.randn(8, s, s, c, generator=gen).to(dev)
    h = torch.randn(8, s, s, hc, generator=gen).to(dev) if hc else None
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
        8, 8, 8, 32, 128, 128, 2, 3, 1.0, 0, 1, 2, torch.cuda.current_stream(cuda).cuda_stream)
    assert err != 0


# one weight slice: the widest levels of plants_128 with 32 augment channels
# (C=96 at 8x8) and of iper_128's multistack 'down' block (C=128 at 4x4)
K2_ONE_SLICE_CASES = [(c, s, g) for c, s in [(96, 8), (128, 4)]
                      for g in k2.allowed_clusters(c, mcf.default_hidden(c), 128, 2, 3, s, s, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("c,s,g", K2_ONE_SLICE_CASES)
def test_k2_one_slice_matches_plain(cuda, c, s, g):
    assert k2.slice_plan(c, mcf.default_hidden(c), 128, 2, 3, s, s) == 1
    y, h, weights, an1, an2 = _unit(c, 128, cuda, 200 + c, s=s)
    n0 = k2.macow_unit_inverse.launches
    out = k2.macow_unit_inverse(y, h, weights, an1, an2, cluster=g)
    torch.cuda.synchronize()
    assert k2.macow_unit_inverse.launches == n0 + 1
    ref = k2.macow_unit_inverse_plain(y, h, weights, an1, an2)
    torch.testing.assert_close(out, ref, rtol=TOL, atol=TOL)


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


@pytest.mark.gpu
def test_batcher_on_the_card(cuda):
    """The serving batcher at a small spec on the card: video shapes, the u8
    wire's dtype, and the same requests alone and in one shared batch within
    CUDA_BATCH_TOL (cuDNN may pick another algorithm per batch size)."""
    import numpy as np

    from ipoke_tpu_torch.flows.macow import FlowSpec
    from ipoke_tpu_torch.models.encoders import WrapperSpec
    from ipoke_tpu_torch.models.first_stage import FirstStageSpec
    from ipoke_tpu_torch.models.second_stage import SecondStageSpec
    from ipoke_tpu_torch.serve.batcher import CUDA_BATCH_TOL, BatcherConfig, SampleBatcher
    from ipoke_tpu_torch.utils import synth

    s, t = 32, 3
    spec = SecondStageSpec(
        flow=FlowSpec(num_steps=(1, 1), in_channels=16, hidden_channels=32, h_channels=32,
                      factor=16, mcf_backend="cuda_unit"),
        first_stage=FirstStageSpec(z_dim=16, spatial_size=s, max_frames=t, enc_channels=(16,) * 4,
                                   dec_channels=(16,) * 3, n_gru_layers=2, min_spatial_size=8),
        poke_embedder=WrapperSpec(nf_in=2, nf_max=16, spatial_size=s, min_spatial_size=8,
                                  deterministic=True),
        conditioner=WrapperSpec(nf_in=3, nf_max=16, spatial_size=s, min_spatial_size=8,
                                deterministic=False))
    params = synth.synth_params(spec, seed=0, device=cuda)
    params = dict(params, flow=synth.set_flow_output_gains(params["flow"], 0.02))
    rng = np.random.default_rng(0)
    reqs = [(rng.uniform(-1, 1, (s, s, 3)).astype(np.float32),
             rng.standard_normal((s, s, 2)).astype(np.float32), seed) for seed in (1, 2, 2**33 + 5)]
    f32 = SampleBatcher(params, spec, BatcherConfig(max_batch=4, max_delay_ms=200.0))
    u8 = SampleBatcher(params, spec, BatcherConfig(max_batch=4, max_delay_ms=200.0, wire_u8=True))
    try:
        n0 = k2.macow_unit_inverse.launches
        solo = [f32.submit(x0, poke, seed, timeout=300) for x0, poke, seed in reqs]
        assert k2.macow_unit_inverse.launches == n0 + 3 * 2 * 4   # 2 steps x 4 units per batch
        handles = [f32.submit_async(x0, poke, seed) for x0, poke, seed in reqs]
        for h in handles:
            assert h.event.wait(300) and h.error is None
        assert f32.stats.batch_hist == {1: 3, 4: 1}
        for a, h in zip(solo, handles):
            assert a.shape == (t, s, s, 3) and a.dtype == np.float32 and np.isfinite(a).all()
            assert np.abs(a - h.result).max() <= CUDA_BATCH_TOL
        v8 = u8.submit(*reqs[0], timeout=300)
        assert v8.dtype == np.uint8 and v8.shape == (t, s, s, 3)
        want = np.clip((solo[0] + 1.0) * 127.5, 0, 255).astype(np.uint8)
        assert np.abs(v8.astype(np.int16) - want.astype(np.int16)).max() <= 1
    finally:
        f32.close()
        u8.close()


@pytest.mark.gpu
def test_train_step_on_the_card_matches_the_cpu(cuda):
    """Two train steps of a tiny second stage (torch-Adam, lr 1e-5 from step
    0) on the card and on the CPU from the same params, batch and keys: loss,
    grad norm and the updated params within 1e-4·(1+|ref|).  At lr 1e-5 a
    first Adam step moves a param by ~lr, so a gradient that cuDNN rounds to
    the other sign stays inside the tolerance."""
    from ipoke_tpu_torch.data.datamodule import StaticDataModule
    from ipoke_tpu_torch.experiments.second_stage import build_spec_from_config
    from ipoke_tpu_torch.models import second_stage
    from ipoke_tpu_torch.train import second_stage as train
    from ipoke_tpu_torch.utils import prng, synth

    config = {
        "general": {"seed": 0},
        "first_stage": {"spec": {"z_dim": 16, "ENC_M_channels": [16] * 4, "dec_channels": [16] * 4,
                                 "n_gru_layers": 2, "min_spatial_size": 8}},
        "poke_embedder": {"spec": {"nf_max": 16}}, "conditioner": {"spec": {"nf_max": 16}},
        "data": {"spatial_size": [64, 64], "max_frames": 3, "n_examples": 4},
        "architecture": {"flow_mid_channels_factor": 2, "num_steps": [1, 1]},
    }
    spec = build_spec_from_config(config)
    params = second_stage.init(prng.prng_key(0), spec, device="cpu")
    params["flow"] = synth.set_flow_output_gains(params["flow"], 0.05)
    # the first training batch in JAX's order (seed 0, no zero pokes)
    batch = next(iter(StaticDataModule(dict(config["data"], batch_size=2, n_workers=0))
                      .loader("train")))
    runs = []
    for dev in ("cpu", cuda):
        p = {k: _copy_to(v, dev) for k, v in params.items()}
        trainable, frozen = train.split_params(p)
        opt = train.make_optimizer(lr=1e-5, warmup_steps=0, total_steps=10)
        state = train.init_state(trainable, opt)
        step = train.make_train_step(spec, frozen, opt)
        b = {k: torch.from_numpy(batch[k]).to(dev) for k in ("images", "poke")}
        metrics = []
        for i in range(2):
            state, m = step(state, b, prng.prng_key(i))
            metrics.append({k: float(v) for k, v in m.items()})
        runs.append((metrics, train.float_leaves(state.params)))
    (ref_m, ref_p), (got_m, got_p) = runs
    for r, g in zip(ref_m, got_m):
        for k in ("flow_loss", "grad_norm", "nll_loss", "nlogdet_loss", "reference_nll_loss"):
            assert abs(g[k] - r[k]) <= 1e-4 * (1 + abs(r[k])), (k, g[k], r[k])
    assert len(ref_p) == len(got_p) > 100
    for r, g in zip(ref_p, got_p):
        torch.testing.assert_close(g.detach().cpu(), r.detach(), rtol=1e-4, atol=1e-4)


def _copy_to(tree, device):
    if isinstance(tree, dict):
        return {k: _copy_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy_to(v, device) for v in tree]
    return tree.to(device, copy=True)


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["mcf_inverse", "macow_unit_inverse"])
def test_custom_ops_equal_the_ctypes_launch(cuda, op):
    """``torch.ops.ipoke.*`` on CUDA tensors is the ctypes launch: bitwise
    equal, and each launches (and counts) once."""
    if op == "mcf_inverse":
        z, h, w, w1, b1 = _mcf(32, 128, "C", cuda, seed=21)
        args = (z, h, [w, w1, b1], "C", 1.0, "elu", None)
        direct = lambda: k1.launch(z, h, w, w1, b1, "C")   # noqa: E731
        counter = k1.mcf_inverse
    else:
        y, h, weights, an1, an2 = _unit(32, 128, cuda, seed=22)
        args = (y, h, [x for ws in weights for x in ws], an1, an2, 1.0, "elu", None)
        direct = lambda: k2.launch(y, h, weights, an1, an2)   # noqa: E731
        counter = k2.macow_unit_inverse
    n0 = counter.launches
    via_op = getattr(torch.ops.ipoke, op)(*args)
    assert counter.launches == n0 + 1
    ref = direct()
    torch.cuda.synchronize()
    assert counter.launches == n0 + 2
    assert torch.equal(via_op, ref)
    torch.library.opcheck(getattr(torch.ops.ipoke, op).default, args,
                          test_utils=("test_schema", "test_faketensor"))


def _tiny_spec(s=32, t=3):
    from ipoke_tpu_torch.flows.macow import FlowSpec
    from ipoke_tpu_torch.models.encoders import WrapperSpec
    from ipoke_tpu_torch.models.first_stage import FirstStageSpec
    from ipoke_tpu_torch.models.second_stage import SecondStageSpec

    return SecondStageSpec(
        flow=FlowSpec(num_steps=(1, 1), in_channels=16, hidden_channels=32, h_channels=32,
                      factor=16, mcf_backend="cuda_unit"),
        first_stage=FirstStageSpec(z_dim=16, spatial_size=s, max_frames=t, enc_channels=(16,) * 4,
                                   dec_channels=(16,) * 3, n_gru_layers=2, min_spatial_size=8),
        poke_embedder=WrapperSpec(nf_in=2, nf_max=16, spatial_size=s, min_spatial_size=8,
                                  deterministic=True),
        conditioner=WrapperSpec(nf_in=3, nf_max=16, spatial_size=s, min_spatial_size=8,
                                deterministic=False))


@pytest.mark.gpu
def test_exported_flow_artifact_runs_k2_on_the_card(cuda, tmp_path):
    """A tiny flow artifact exported on the card holds one
    ``ipoke::macow_unit_inverse`` node per MaCowUnit, launches K2 once per
    unit when it runs, and equals the live ``forward_sample`` within
    CUDA_BATCH_TOL; the CPU may not load it."""
    from ipoke_tpu_torch.models import second_stage
    from ipoke_tpu_torch.serve import artifact
    from ipoke_tpu_torch.serve.batcher import CUDA_BATCH_TOL
    from ipoke_tpu_torch.utils import synth

    spec = _tiny_spec()
    params = synth.synth_params(spec, seed=0, device=cuda)
    params = dict(params, flow=synth.set_flow_output_gains(params["flow"], 0.02))
    artifact.export_sampler(params, spec, tmp_path / "a", buckets=(2,))
    art = artifact.load_artifact(tmp_path / "a", cuda)
    units = 4 * sum(spec.flow.num_steps)
    nodes = [n for n in art.programs[2].graph.nodes if "ipoke.macow_unit_inverse" in str(n.target)]
    assert len(nodes) == units
    gen = torch.Generator(device=cuda).manual_seed(3)
    x0 = torch.rand(2, 32, 32, 3, generator=gen, device=cuda) * 2 - 1
    poke = torch.randn(2, 32, 32, 2, generator=gen, device=cuda)
    z = art.draw_z([4, 5])
    n0 = k2.macow_unit_inverse.launches
    got = art.run(art.params, x0, poke, z)
    torch.cuda.synchronize()
    assert k2.macow_unit_inverse.launches == n0 + units
    live = second_stage.forward_sample(params, spec, {"images": x0[:, None], "poke": poke},
                                       length=2, add_first_frame=True, z=z)[0]
    assert got.shape == (2, 3, 32, 32, 3) and bool(torch.isfinite(got).all())
    assert float((got - live).abs().max()) <= CUDA_BATCH_TOL
    with pytest.raises(ValueError, match="exported for cuda"):
        artifact.load_artifact(tmp_path / "a", "cpu")


@pytest.mark.gpu
def test_direct_distill_step_on_the_card(cuda):
    """One direct-student distill step at a tiny spec on the card: the
    teacher's reverse launches K2 once per unit, the loss is finite and the
    student moves."""
    from ipoke_tpu_torch.models import second_stage
    from ipoke_tpu_torch.train import distill
    from ipoke_tpu_torch.train.second_stage import adam, float_leaves
    from ipoke_tpu_torch.utils import prng, synth

    spec = _tiny_spec()
    teacher = synth.synth_params(spec, seed=0, device=cuda)
    teacher = dict(teacher, flow=synth.set_flow_output_gains(teacher["flow"], 0.02))
    init_state, step = distill.make_distill_step(spec, distill.DirectStudentSpec(32, 2), adam(1e-3))
    state = init_state(prng.prng_key(0), cuda)
    start = [p.detach().clone() for p in float_leaves(state["params"])]
    x0 = torch.zeros(2, 32, 32, 3, device=cuda)
    cond = second_stage.embed_cond(teacher, spec, x0, torch.ones(2, 32, 32, 2, device=cuda))
    z = prng.normal(prng.prng_key(1), (2, 8, 8, 16), cuda)
    n0 = k2.macow_unit_inverse.launches
    state, logs = step(state, teacher, z, cond)
    torch.cuda.synchronize()
    assert k2.macow_unit_inverse.launches == n0 + 4 * sum(spec.flow.num_steps)
    assert state["step"] == 1 and bool(torch.isfinite(logs["loss"]))
    assert float(logs["teacher_finite_frac"]) == 1.0
    moved = [not torch.equal(a, b) for a, b in zip(start, float_leaves(state["params"]))]
    assert sum(moved) > len(moved) // 2


METRIC_TOL = 1e-4   # cuDNN's f32 convs (TF32 off) against the CPU's, relative to 1 + max|ref|


def _rel(got, ref):
    return float((got.detach().cpu().double() - ref.double()).abs().max() / (1 + ref.abs().max()))


@pytest.mark.gpu
def test_metrics_on_the_card_match_the_cpu(cuda):
    """I3D features, LPIPS and SSIM/PSNR of the same videos on the card and on
    the CPU (oneDNN off, whose f32 convs round coarser)."""
    from ipoke_tpu_torch.metrics import i3d, image, lpips

    gen = torch.Generator().manual_seed(0)
    a = torch.tanh(torch.randn(2, 5, 48, 48, 3, generator=gen))
    b = (a + 0.3 * torch.randn(a.shape, generator=gen)).clamp(-1, 1)
    with torch.backends.mkldnn.flags(enabled=False):
        ref = {"i3d": i3d.features(a), "lpips": lpips.lpips_video(a, b),
               "ssim": image.ssim_video(a, b), "psnr": image.psnr(a, b)}
    got = {"i3d": i3d.features(a.to(cuda)), "lpips": lpips.lpips_video(a.to(cuda), b.to(cuda)),
           "ssim": image.ssim_video(a.to(cuda), b.to(cuda)), "psnr": image.psnr(a.to(cuda), b.to(cuda))}
    for k, r in ref.items():
        assert got[k].device.type == "cuda" and got[k].shape == r.shape
        assert _rel(got[k], r) <= METRIC_TOL, (k, _rel(got[k], r))


@pytest.mark.gpu
def test_pose_net_on_the_card_matches_the_cpu(cuda):
    """The pose net's heatmaps of 3 frames (64², upscaled to 256²; one of
    300², shrunk with the antialiased resize) on the card and on the CPU
    (oneDNN off) within METRIC_TOL; keypoints equal where the first peak
    leads the second by more than that."""
    from ipoke_tpu_torch.metrics import pose

    gen = torch.Generator().manual_seed(3)
    for size in (64, 300):
        x = torch.rand(3, size, size, 3, generator=gen) * 2 - 1
        with torch.backends.mkldnn.flags(enabled=False):
            ref = pose.heatmaps(x)
        got = pose.heatmaps(x.to(cuda))
        assert got.device.type == "cuda" and got.shape == ref.shape == (3, 64, 64, 17)
        assert _rel(got, ref) <= METRIC_TOL, (size, _rel(got, ref))
        top2 = ref.reshape(3, -1, 17).topk(2, dim=1).values
        clear = (top2[:, 0] - top2[:, 1]) > METRIC_TOL * (1 + ref.abs().max())
        kp_card = pose.get_max_preds(got)[0].cpu()
        assert torch.equal(kp_card[clear], pose.get_max_preds(ref)[0][clear])


@pytest.mark.gpu
def test_gui_poke_on_the_card(cuda):
    """One POST /poke to the GUI of a tiny session on the card: length + 1
    frames, 4 K2 launches per MaCowStep of the flow, and the video of the
    same key equal to the CPU session's within METRIC_TOL."""
    import http.client
    import json
    import threading

    import numpy as np

    from ipoke_tpu_torch.eval import gui
    from ipoke_tpu_torch.eval.interactive import InteractiveSession
    from ipoke_tpu_torch.utils import synth

    spec = _tiny_spec()
    params = synth.synth_params(spec, seed=0, device=cuda)
    params = dict(params, flow=synth.set_flow_output_gains(params["flow"], 0.02))
    image = np.random.default_rng(0).uniform(-1, 1, (32, 32, 3)).astype(np.float32)
    pokes = [{"x": 100, "y": 60, "dx": 20, "dy": -8}]
    sess = InteractiveSession(params, spec)
    sess.set_image(image)
    server = gui.make_server(sess, lambda i: image, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        n0 = k2.macow_unit_inverse.launches
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=300)
        conn.request("POST", "/poke", body=json.dumps({"pokes": pokes, "length": 4}))
        resp = conn.getresponse()
        reply = json.loads(resp.read())
        conn.close()
        assert resp.status == 200 and len(reply["frames"]) == 5
        assert k2.macow_unit_inverse.launches - n0 == 4 * sum(spec.flow.num_steps)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    card = InteractiveSession(params, spec, fixed_seed=True)
    cpu = InteractiveSession(_copy_to(params, "cpu"), spec, fixed_seed=True)
    for s in (card, cpu):
        s.set_image(image)
    with torch.backends.mkldnn.flags(enabled=False):
        ref = torch.from_numpy(cpu.generate(pokes, length=4)[0])
    assert _rel(torch.from_numpy(card.generate(pokes, length=4)[0]), ref) <= METRIC_TOL


@pytest.mark.gpu
def test_fvd_run_on_the_card(cuda, tmp_path):
    """``test --mode fvd`` of a tiny second stage on the card, end to end:
    K2 in every sampling call, the score finite, its features on the card,
    the score within 1e-3 relative of the same run on the CPU."""
    import json

    import yaml

    from ipoke_tpu_torch.experiments import second_stage as experiment

    config = {
        "general": {"experiment": "e", "seed": 0, "base_dir": str(tmp_path / "logs")},
        "first_stage": {"spec": {"z_dim": 16, "ENC_M_channels": [16] * 4, "dec_channels": [16] * 4,
                                 "n_gru_layers": 2, "min_spatial_size": 8}},
        "poke_embedder": {"spec": {"nf_max": 16}}, "conditioner": {"spec": {"nf_max": 16}},
        "data": {"spatial_size": [64, 64], "max_frames": 3, "n_examples": 8, "batch_size": 4},
        "architecture": {"flow_mid_channels_factor": 2, "num_steps": [1, 1]},
        "testing": {"n_samples_fvd": 8, "seed": 3},
    }
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(config))
    scores = {}
    for dev in (cuda, "cpu"):
        n0 = k2.macow_unit_inverse.launches
        experiment.main(["test", "-c", str(path), "-m", "m", "--mode", "fvd", "--device", str(dev)])
        with open(tmp_path / "logs" / "e" / "generated" / "m" / "metrics" / "fvd.json") as f:
            scores[str(dev)] = json.load(f)["FVD_UNPRETRAINED"]
        assert k2.macow_unit_inverse.launches - n0 == (2 * 2 * 4 if dev == cuda else 0)
    card, cpu = scores[str(cuda)], scores["cpu"]
    assert card > 0 and abs(card - cpu) <= 1e-3 * cpu, scores


@pytest.mark.gpu
def test_device_prefetch_on_the_card(cuda):
    """``data/loader.device_prefetch``: each batch through pinned memory on
    a side stream, in order, equal to the host batch once the consumer's
    stream has waited on its copy; a step on the batch sees the copied data."""
    import numpy as np

    from ipoke_tpu_torch.data.loader import device_prefetch

    rng = np.random.default_rng(0)
    batches = [{"images": rng.normal(size=(4, 3, 32, 32, 3)).astype(np.float32),
                "sample_ids": np.arange(4) + i} for i in range(6)]
    got = []
    for b in device_prefetch(iter(batches), cuda, size=2):
        assert b["images"].is_cuda
        got.append((b["images"] * 2).sum().item())       # a step on the consumer's stream
    assert got == [float((torch.from_numpy(b["images"]).to(cuda) * 2).sum()) for b in batches]


def _ae_make(kind, dev, dtype):
    from ipoke_tpu_torch.models.discriminators import PatchDiscSpec
    from ipoke_tpu_torch.models.encoders import WrapperSpec
    from ipoke_tpu_torch.train import encoders as te
    from ipoke_tpu_torch.train.first_stage import trainable
    from ipoke_tpu_torch.utils import prng

    def cast(t):
        if isinstance(t, dict):
            return {k: cast(v) for k, v in t.items()}
        if isinstance(t, list):
            return [cast(v) for v in t]
        return t.detach().to(dtype).requires_grad_(t.requires_grad)

    if kind == "image":
        spec = WrapperSpec(nf_in=3, nf_max=16, spatial_size=32, min_spatial_size=8,
                           deterministic=False)
        disc = PatchDiscSpec(ndf=8, n_layers=2, gp_weight=0.5)
        st, opts = te.init_image_ae(prng.prng_key(3), spec, disc, device=dev)
        p, d = cast(st.params), cast(st.disc_params)
        st = te.AETrainState(0, p, d, opts["gen"].init(trainable(p)), opts["disc"].init(trainable(d)))
        return st, te.make_image_ae_step(spec, disc, opts)
    spec = WrapperSpec(nf_in=2, nf_max=16, spatial_size=32, min_spatial_size=8,
                       deterministic=True, poke_and_image=True)
    st, opt = te.init_poke_ae(prng.prng_key(3), spec, device=dev)
    p = cast(st.params)
    return te.PokeAEState(0, p, opt.init(trainable(p))), te.make_poke_ae_step(spec, opt)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["image", "poke"])
def test_encoder_step_on_the_card_matches_the_cpu(cuda, kind):
    """One image-AE step (variational, gradient penalty 0.5) and one poke-AE
    step (``poke_and_image``) on the card and on the CPU: every log within
    TOL·(1+|ref|) in f32; in f64 the logs and the gradients (2 x Adam's
    first moment) within TOL.  (The image AE's f32 gradients are not: its
    adaptive weight sets the adversarial gradient against the NLL's.)"""
    import numpy as np

    from ipoke_tpu_torch.utils import prng

    r = np.random.default_rng(0)
    batch = {"images": r.uniform(-1, 1, (2, 2, 32, 32, 3)), "poke": r.normal(size=(2, 32, 32, 2)),
             "flow": r.normal(size=(2, 32, 32, 2))}
    for dtype in (torch.float32, torch.float64):
        runs = []
        for dev in (cuda, torch.device("cpu")):
            with torch.backends.mkldnn.flags(enabled=False):
                st, step = _ae_make(kind, dev, dtype)
                b = {k: torch.from_numpy(v).to(dev, dtype) for k, v in batch.items()}
                new, logs = step(st, b, prng.prng_key(1))
                runs.append(({k: float(v) for k, v in logs.items()},
                             [(2 * m).detach().cpu() for m in new.opt_state[0]["mu"]]))
        (lc, gc), (lr, gr) = runs
        for k in lr:
            assert abs(lc[k] - lr[k]) <= TOL * (1 + abs(lr[k])), (dtype, k, lc[k], lr[k])
        if dtype == torch.float64:
            for a, b_ in zip(gc, gr):
                assert (a - b_).abs().max() <= TOL * (1 + b_.abs().max())


@pytest.mark.gpu
def test_encoder_trainer_on_the_card(cuda, tmp_path):
    """``python -m ipoke_tpu_torch.main`` on a tiny image-AE config on the
    card: one step, its validation with a top-k checkpoint, ``--test`` of
    the best checkpoint equal to the validation."""
    from pathlib import Path

    import yaml

    from ipoke_tpu_torch.main import main

    cfg = yaml.safe_load((Path(__file__).resolve().parent.parent / "configs" /
                          "img_encoder.yaml").read_text())
    cfg["general"]["base_dir"] = str(tmp_path / "logs")
    cfg["data"].update(spatial_size=[32, 32], max_frames=2, batch_size=2, n_examples=4,
                       n_workers=0)
    cfg["architecture"]["nf_max"] = 16
    cfg["training"].update(n_epochs=1, max_batches_per_epoch=1, max_val_batches=1)
    path = tmp_path / "img.yaml"
    path.write_text(yaml.safe_dump(cfg))
    run = main(["-c", str(path), "-m", "t", "--device", "cuda"])
    assert run["state"].params["logvar"].is_cuda and len(run["val"]) == 1
    tested = main(["-c", str(path), "-m", "t", "--device", "cuda", "--test", "fvd"])
    assert abs(tested["lpips-val"] - run["val"][0]["lpips-val"]) <= 1e-5 * run["val"][0]["lpips-val"]


@pytest.mark.gpu
def test_stage2_signal_save_and_resume_on_the_card(cuda, tmp_path, monkeypatch):
    """configs/debug_second_stage.yaml through ``python -m
    ipoke_tpu_torch.main`` on the card: SIGTERM raised in step 2 saves
    last.npz after that step (``preempted``) and the run returns; ``--resume``
    restores the params, moments and counts bitwise, trains step 3 at the
    schedule's lr of count 2, and saves its last.npz at step 3."""
    import signal
    from pathlib import Path

    import numpy as np
    import yaml

    from ipoke_tpu_torch.ckpt import io
    from ipoke_tpu_torch.experiments import second_stage as experiment
    from ipoke_tpu_torch.main import main
    from ipoke_tpu_torch.train import second_stage as train_ss

    cfg = yaml.safe_load((Path(__file__).resolve().parent.parent / "configs" /
                          "debug_second_stage.yaml").read_text())
    cfg["general"]["base_dir"] = str(tmp_path / "logs")
    path = tmp_path / "ss.yaml"
    path.write_text(yaml.safe_dump(cfg))
    argv = ["-c", str(path), "-m", "t", "--device", "cuda"]
    make = train_ss.make_train_step

    def signalling(*a, **k):
        step = make(*a, **k)

        def wrapped(state, batch, rng):
            out = step(state, batch, rng)
            if out[0].step == 2:
                signal.raise_signal(signal.SIGTERM)
            return out
        return wrapped

    monkeypatch.setattr(train_ss, "make_train_step", signalling)
    run = main(argv)
    assert run["preempted"] == 2 and run["state"].step == 2
    saved, meta = io.load(run["ckpt"])
    assert meta == {"step": 2, "preempted": True}
    monkeypatch.setattr(train_ss, "make_train_step", make)
    restore, checked, lrs = experiment.restore_train_state, [], []

    def checking(tree, optimizer, template, spec, device=None):
        state = restore(tree, optimizer, template, spec, device)
        assert all(p.is_cuda for p in train_ss.float_leaves(state.params))
        a = io._flatten(experiment.ckpt_tree(state, optimizer, spec))
        b = io._flatten(tree)
        checked.append(a.keys() == b.keys() and all(
            np.asarray(a[k]).dtype == np.asarray(b[k]).dtype and np.array_equal(a[k], b[k])
            for k in a))
        return state

    upd = train_ss._ScaleBySchedule.update
    monkeypatch.setattr(experiment, "restore_train_state", checking)
    monkeypatch.setattr(train_ss._ScaleBySchedule, "update", lambda self, u, s, p: (
        lrs.append((s["count"], self.schedule(s["count"]))), upd(self, u, s, p))[1])
    resumed = main([*argv, "--resume", "--max-steps", "1"])
    assert checked == [True] and resumed["start_step"] == 2 and resumed["state"].step == 3
    assert resumed["ckpt_dir"] == run["ckpt_dir"] and lrs[0][0] == 2
    assert len(resumed["history"]) == 1 and resumed["preempted"] is None
    _, meta = io.load(resumed["ckpt"])
    assert meta["step"] == 3 and "preempted" not in meta


# ---------------------------------------------------------------------------
# data preparation: the flow ops, PWC-lite and compute_flows on the card
# ---------------------------------------------------------------------------

FLOW_TOL = 1e-4   # the card against the CPU, relative to 1 + max|ref|


def _flow_close(card, cpu, tol=FLOW_TOL):
    card, cpu = card.detach().cpu(), cpu.detach()
    err = float((card - cpu).abs().max())
    assert err <= tol * (1 + float(cpu.abs().max())), err


def _smooth_frames(b, size, seed):
    from ipoke_tpu_torch.nn.core import resize_bilinear_align_corners

    gen = torch.Generator().manual_seed(seed)
    coarse = torch.randn(b, 8, 8, 3, generator=gen)
    img1 = torch.tanh(resize_bilinear_align_corners(coarse, (size, size)) * 1.5)
    return img1, torch.roll(img1, (1, -2), dims=(1, 2))


@pytest.mark.gpu
def test_flow_ops_on_the_card_match_the_cpu(cuda):
    """Correlation (max_disp 4 and 2, stride 1 and 2), the warp and its
    gradients (flows leaving the frame), Horn-Schunck's level and
    estimate_flow on smooth frames."""
    from ipoke_tpu_torch.ops import flow_ops

    gen = torch.Generator().manual_seed(0)
    f1, f2 = torch.randn(2, 16, 20, 8, generator=gen), torch.randn(2, 16, 20, 8, generator=gen)
    for md, st in ((4, 1), (2, 1), (4, 2), (2, 2)):
        _flow_close(flow_ops.correlation_cost_volume(f1.to(cuda), f2.to(cuda), md, st),
                    flow_ops.correlation_cost_volume(f1, f2, md, st))
    flow = torch.randn(2, 16, 20, 2, generator=gen) * 6
    runs = []
    for dev in (cuda, torch.device("cpu")):
        x, f = f1.to(dev).requires_grad_(), flow.to(dev).requires_grad_()
        out = flow_ops.warp_bilinear(x, f)
        (out * f2.to(dev)).sum().backward()
        runs.append((out, x.grad, f.grad))
    for a, b in zip(*runs):
        _flow_close(a, b)
    img1, img2 = _smooth_frames(2, 32, 1)
    init = torch.randn(2, 32, 32, 2, generator=gen)
    g1, g2 = img1[..., :1], img2[..., :1]
    _flow_close(flow_ops.horn_schunck_level(g1.to(cuda), g2.to(cuda), init.to(cuda), n_iters=10),
                flow_ops.horn_schunck_level(g1, g2, init, n_iters=10))
    _flow_close(flow_ops.estimate_flow(img1.to(cuda), img2.to(cuda)), flow_ops.estimate_flow(img1, img2))


@pytest.mark.gpu
def test_pwc_flow_and_its_loss_on_the_card_match_the_cpu(cuda):
    """pwc_flow on the same params and frames; a layered pair drawn on each
    device from JAX's key, and the fit's loss and gradients on it."""
    from ipoke_tpu_torch.ops import pwc
    from ipoke_tpu_torch.utils import prng

    img1, img2 = _smooth_frames(4, 64, 2)
    runs = []
    for dev in (cuda, torch.device("cpu")):
        params = pwc.init_pwc(prng.prng_key(5), device=dev)
        with torch.no_grad():
            flow = pwc.pwc_flow(params, img1.to(dev), img2.to(dev))
        pair = pwc.synthetic_pair_layered(prng.prng_key(7), 4, 64, 64, np.float32(9.0), device=dev)
        for t in pwc.leaves(params):
            t.requires_grad_(True)
        loss = pwc.multiscale_epe_loss(params, *pair[:3])
        runs.append((flow, *pair[:3], loss, *torch.autograd.grad(loss, pwc.leaves(params))))
        occ = pair[3].cpu()
    for a, b in zip(*runs):
        _flow_close(a, b)
    assert 0 < int(occ.sum()) < occ.numel()


@pytest.mark.gpu
@pytest.mark.parametrize("estimator", ["hs", "pwc"])
def test_compute_flows_on_the_card(cuda, tmp_path, monkeypatch, estimator):
    """compute_flows on the card against the CPU: the same files, flows
    within FLOW_TOL (PWC-lite on a pwc_lite.npz of its init)."""
    from ipoke_tpu_torch.data import prepare
    from ipoke_tpu_torch.ops import pwc
    from ipoke_tpu_torch.utils import prng
    from ipoke_tpu_torch.utils.video import save_image

    monkeypatch.setenv("IPOKE_WEIGHTS", str(tmp_path / "weights"))
    pwc.save_params(pwc.init_pwc(prng.prng_key(21)))
    pwc.default_params.cache_clear()
    img1, _ = _smooth_frames(1, 96, 3)
    frames = [save_image(torch.roll(img1[0], (i, 2 * i), dims=(0, 1)).numpy()[8:72, 8:72],
                         str(tmp_path / "v" / f"frame_{i:06d}.png")) for i in range(12)]
    try:
        card = prepare.compute_flows(frames, 3, str(tmp_path / "card"), estimator=estimator, device=cuda)
        cpu = prepare.compute_flows(frames, 3, str(tmp_path / "cpu"), estimator=estimator, device="cpu")
    finally:
        pwc.default_params.cache_clear()
    assert sorted(card) == sorted(cpu) == list(range(9))
    for i in card:
        a, b = np.load(card[i]), np.load(cpu[i])
        assert a.shape == (64, 64, 2) and np.isfinite(a).all()
        _flow_close(torch.from_numpy(a), torch.from_numpy(b))


@pytest.mark.gpu
def test_pwc_fit_on_the_card_is_reproducible(cuda):
    """Two fits of 60 steps from one key on the card (deterministic
    algorithms, ``pwc.reproducible``) give the same net bit for bit."""
    from ipoke_tpu_torch.ops import pwc
    from ipoke_tpu_torch.utils import prng

    a, b = (pwc.train_synthetic(prng.prng_key(1234), steps=60, device=cuda) for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(pwc.leaves(a), pwc.leaves(b)))


@pytest.mark.gpu
def test_cli_pwc_fit_on_the_card_passes_the_regime_guards(cuda, tmp_path, monkeypatch):
    """prepare.fit_pwc_weights with no pwc_lite.npz: the fit (and any refit
    its validation asks for) on the card, written to the npz; the kept net
    passes the nine guards of the JAX package's tests/test_pwc.py on that
    file's pairs, on the card (printed)."""
    from ipoke_tpu_torch.data import prepare
    from ipoke_tpu_torch.ops import pwc

    monkeypatch.setenv("IPOKE_WEIGHTS", str(tmp_path))
    path = prepare.fit_pwc_weights(cuda)
    guards = pwc.regime_guards(pwc.load_params(path, cuda), cuda)
    print("\n".join(f"{c}: {v:.4f} < {lim:.4f}" for c, v, lim, _ in guards))
    failed = [g for g in guards if not g[1] < g[2]]
    assert not failed, failed


@pytest.mark.gpu
def test_converted_checkpoint_samples_on_the_card(cuda):
    """A tiny reference-shaped checkpoint (spectral-norm convs in torch's
    weight_orig form) through ``torch_import.to_port`` onto the card, sampled
    on 'cuda_unit' (K2: 4 launches per MaCowStep) within TOL of the same
    params on 'scan' (plain)."""
    from dataclasses import replace

    from torch_ckpt_fixture import reference_tree

    from ipoke_tpu_torch.ckpt import torch_import as ti
    from ipoke_tpu_torch.experiments.second_stage import build_spec_from_config
    from ipoke_tpu_torch.models import second_stage
    from ipoke_tpu_torch.utils import prng

    config = {
        "first_stage": {"spec": {"z_dim": 16, "ENC_M_channels": [16] * 4, "dec_channels": [16] * 4,
                                 "n_gru_layers": 2, "min_spatial_size": 8}},
        "poke_embedder": {"spec": {"nf_max": 16}}, "conditioner": {"spec": {"nf_max": 16}},
        "data": {"spatial_size": [64, 64], "max_frames": 3},
        "architecture": {"flow_mid_channels_factor": 2, "num_steps": [1, 1]},
    }
    spec = build_spec_from_config(config, mcf_backend="cuda_unit")
    params = ti.to_port(ti.export_second_stage(reference_tree(spec, seed=5), spec), spec, cuda)
    gen = torch.Generator().manual_seed(0)
    batch = {"images": (torch.rand(2, 3, 64, 64, 3, generator=gen) * 2 - 1).to(cuda),
             "poke": (torch.randn(2, 64, 64, 2, generator=gen) * 0.5).to(cuda)}
    n0 = k2.macow_unit_inverse.launches
    with torch.no_grad():
        card = second_stage.forward_sample(params, spec, batch, prng.prng_key(3))
        assert k2.macow_unit_inverse.launches - n0 == 4 * sum(spec.flow.num_steps)
        plain = second_stage.forward_sample(
            params, replace(spec, flow=replace(spec.flow, mcf_backend="scan")), batch,
            prng.prng_key(3))
    assert torch.isfinite(card).all()
    err = float((card - plain).abs().max() / (1 + plain.abs().max()))
    assert err <= TOL, err


@pytest.mark.gpu
def test_fid_features_on_the_card_match_the_cpu(cuda):
    """InceptionV3's pool3 features (seeded filters) of 64^2 images, resized
    to 299^2 inside, on the card against the CPU (oneDNN off)."""
    from ipoke_tpu_torch.metrics import fid

    gen = torch.Generator().manual_seed(1)
    images = torch.rand(2, 64, 64, 3, generator=gen) * 2 - 1
    with torch.no_grad():
        card = fid.pool3_features(images.to(cuda)).cpu()
        with torch.backends.mkldnn.flags(enabled=False):
            cpu = fid.pool3_features(images)
    assert card.shape == (2, 2048) and torch.isfinite(card).all()
    err = float((card - cpu).abs().max() / (1 + cpu.abs().max()))
    assert err <= 1e-4, err


@pytest.mark.gpu
def test_parallel_train_check_calls_planted_faults_wrong_on_the_card(cuda):
    """tests/torch_parallel_faults.py at tiny width, two ranks on this card:
    the sound data-parallel leg held, each planted fault called wrong."""
    from torch_parallel_faults import main

    assert main(["--device", "cuda", "--timeout", "300"]) == 0


@pytest.mark.gpu
def test_parallel_dryrun_on_the_card(cuda):
    """python -m ipoke_tpu_torch.parallel.dryrun at tiny width: two ranks on
    this card over gloo (NCCL refuses two ranks on one card), every leg held
    against its one-process run, K2 in every rank's sampling call and in no
    train step."""
    from ipoke_tpu_torch.parallel import dryrun

    reports = dryrun.run(2, "cuda", "gloo", full=False, timeout=300)
    units = 4 * sum(dryrun.tiny_spec().flow.num_steps)
    for r in reports:
        assert r["backend"] == "gloo" and r["device"].startswith("cuda")
        for leg in r["ok"] + [r["fsdp"]]:
            assert dryrun.held(leg, dryrun.TRAIN_TOLS["cuda"]), leg["errs"]
            assert leg["launches"] == {"mcf_inverse": 0, "macow_unit_inverse": 0}
        assert r["seqpar"]["max_abs_err"] < dryrun.SEQ_TOL
        for k in ("z_fixed", "z_drawn"):
            assert r["sample"][k]["max_abs_err"] <= dryrun.CUDA_BATCH_TOL
            assert r["sample"][k]["launches"] == {"mcf_inverse": 0, "macow_unit_inverse": units}


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["stack-up", "stack-none", "nlsq", "attention"])
def test_variant_flows_sample_on_the_card(cuda, variant):
    """A tiny second stage of each variant the smoke does not run, sampled on
    the card on 'cuda_unit' and 'cuda' against 'scan': an 'up' stack (its
    second block on a 16x16 latent), a stack without reshape, the nlsq
    transform (no launch: the plain loop on every backend) and attention."""
    from dataclasses import replace

    from ipoke_tpu_torch.flows import transformer
    from ipoke_tpu_torch.flows.macow import FlowSpec
    from ipoke_tpu_torch.flows.multistack import StackSpec
    from ipoke_tpu_torch.models import second_stage
    from ipoke_tpu_torch.models.encoders import WrapperSpec
    from ipoke_tpu_torch.models.first_stage import FirstStageSpec
    from ipoke_tpu_torch.models.second_stage import SecondStageSpec
    from ipoke_tpu_torch.utils import prng, synth

    s, t = 32, 3
    if variant.startswith("stack"):
        flow = StackSpec(levels=((1,), (1,)), factors=(4, 2), in_channels=16,
                         mid_channels_factor=2, h_channels=32, reshape=variant[6:])
    else:
        flow = FlowSpec(num_steps=(1, 1), in_channels=16, hidden_channels=32, h_channels=32,
                        factor=16, transform="nlsq" if variant == "nlsq" else "affine",
                        attention=variant == "attention", cond_conv=variant == "attention")
    spec = SecondStageSpec(
        flow=flow,
        first_stage=FirstStageSpec(z_dim=16, spatial_size=s, max_frames=t, enc_channels=(16,) * 4,
                                   dec_channels=(16,) * 3, n_gru_layers=2, min_spatial_size=8,
                                   decode_dtype="f32"),
        poke_embedder=WrapperSpec(nf_in=2, nf_max=16, spatial_size=s, min_spatial_size=8,
                                  deterministic=True),
        conditioner=WrapperSpec(nf_in=3, nf_max=16, spatial_size=s, min_spatial_size=8,
                                deterministic=False))
    params = second_stage.init(prng.prng_key(0), spec, cuda)
    params["flow"] = synth.set_flow_output_gains(params["flow"], 0.02)
    gen = torch.Generator(device=cuda).manual_seed(0)
    batch = {"images": torch.rand(2, t, s, s, 3, generator=gen, device=cuda) * 2 - 1,
             "poke": torch.randn(2, s, s, 2, generator=gen, device=cuda)}
    z = torch.randn(transformer.reverse_input_shape(flow, 2, 8, 16), generator=gen, device=cuda)
    units = 4 * (2 if variant.startswith("stack") else sum(flow.num_steps))
    affine = variant != "nlsq"
    vids = {}
    for backend, want in (("cuda_unit", (0, units * affine)), ("cuda", (4 * units * affine, 0)),
                          ("scan", (0, 0))):
        n0 = (k1.mcf_inverse.launches, k2.macow_unit_inverse.launches)
        vids[backend] = second_stage.forward_sample(
            params, replace(spec, flow=replace(flow, mcf_backend=backend)), batch, z=z)
        torch.cuda.synchronize()
        got = (k1.mcf_inverse.launches - n0[0], k2.macow_unit_inverse.launches - n0[1])
        assert got == want, (backend, got, want)
    assert bool(torch.isfinite(vids["scan"]).all())
    for backend in ("cuda_unit", "cuda"):
        assert (vids[backend] - vids["scan"]).abs().max().item() <= 2e-3


# ---------------------------------------------------------------------------
# the poke_vae baseline (models/variants) on the card
# ---------------------------------------------------------------------------

def _pv_spec(stack):
    from ipoke_tpu_torch.models.first_stage import FirstStageSpec
    from ipoke_tpu_torch.models.variants import PokeVAESpec

    return PokeVAESpec(FirstStageSpec(z_dim=16, spatial_size=32, max_frames=3,
                                      enc_channels=(16,) * 4, dec_channels=(16, 8, 8, 8),
                                      n_gru_layers=2, min_spatial_size=4), stack)


def _pv_batch(dev, dtype=torch.float32):
    r = np.random.default_rng(0)
    return {"images": torch.from_numpy(r.uniform(-1, 1, (2, 3, 32, 32, 3))).to(dev, dtype),
            "poke": torch.from_numpy(r.normal(size=(2, 32, 32, 2))).to(dev, dtype)}


def _moved(tree, dev, dtype=torch.float32):
    if isinstance(tree, dict):
        return {k: _moved(v, dev, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_moved(v, dev, dtype) for v in tree]
    return tree.detach().to(dev, dtype, copy=True)


@pytest.mark.gpu
@pytest.mark.parametrize("stack", [False, True], ids=["poke_in", "stacked"])
def test_poke_vae_forward_on_the_card_matches_the_cpu(cuda, stack):
    """``poke_vae_forward`` on the spectral-normed PokeVAE, its posterior
    draw and ``sample_prior``, on the card against the CPU (oneDNN off) on
    the same weights: within TOL·(1+max|ref|)."""
    from ipoke_tpu_torch.models import first_stage, variants
    from ipoke_tpu_torch.utils import prng

    spec = _pv_spec(stack)
    p = variants.init_poke_vae(prng.prng_key(1), spec)
    for prior in (False, True):
        outs = []
        for dev in (cuda, torch.device("cpu")):
            with torch.no_grad(), torch.backends.mkldnn.flags(enabled=False):
                outs.append(variants.poke_vae_forward(
                    first_stage.materialize_spectral_norm(_moved(p, dev)), _pv_batch(dev), spec,
                    rng=prng.prng_key(2), sample_prior=prior))
        for a, b in zip(*outs):
            if b is None:
                assert a is None and prior
                continue
            assert a.is_cuda and (a.cpu() - b).abs().max() <= TOL * (1 + b.abs().max()), prior


@pytest.mark.gpu
def test_poke_vae_gan_step_on_the_card_matches_the_cpu(cuda):
    """One stage-1 GAN step with the PokeVAE forward (``forward_fn``) on the
    card and on the CPU from the same weights: every metric within
    TOL·(1+|ref|) in f32; in f64 also the generator's gradients (2 x Adam's
    first moment, weight decay included) within TOL·(1+max|ref|)."""
    from ipoke_tpu_torch.models import discriminators as D
    from ipoke_tpu_torch.models import variants
    from ipoke_tpu_torch.train import first_stage as tfs
    from ipoke_tpu_torch.utils import prng

    spec = _pv_spec(False)
    ds, dt = D.PatchDiscSpec(n_layers=1), D.TempDiscSpec(spatial_size=32, sequence_length=2,
                                                         layers=(1, 1, 1, 1))
    cpu = torch.device("cpu")
    base, _ = tfs.init_gan_state(prng.prng_key(0), spec.first_stage, ds, dt, device=cpu)
    nets = {"gen": variants.init_poke_vae(prng.prng_key(1), spec), "ds": base.ds_params,
            "dt": base.dt_params}
    for dtype in (torch.float32, torch.float64):
        runs = []
        for dev in (cuda, cpu):
            with torch.backends.mkldnn.flags(enabled=False):
                p = {n: _moved(v, dev, dtype) for n, v in nets.items()}
                for v in p.values():
                    for leaf in tfs.float_leaves(tfs.trainable(v)):
                        leaf.requires_grad_(True)
                opts = {n: tfs.make_gan_optimizer(2e-4) for n in tfs.NETS}
                state = tfs.GanTrainState(0, p["gen"], p["ds"], p["dt"],
                                          *(opts[n].init(tfs.trainable(p[n])) for n in tfs.NETS))
                step = tfs.make_gan_train_step(
                    spec.first_stage, ds, dt, opts, n_spatial_examples=2,
                    forward_fn=lambda q, b, k: variants.poke_vae_forward(q, b, spec, rng=k))
                state, metrics = step(state, _pv_batch(dev, dtype), prng.prng_key(3))
                runs.append(({k: float(v) for k, v in metrics.items()},
                             [(2 * m).detach().cpu() for m in state.gen_opt[1]["mu"]]))
        (mc, gc), (mr, gr) = runs
        for k in mr:
            assert abs(mc[k] - mr[k]) <= TOL * (1 + abs(mr[k])), (dtype, k, mc[k], mr[k])
        if dtype == torch.float64:
            for a, b_ in zip(gc, gr):
                assert (a - b_).abs().max() <= TOL * (1 + b_.abs().max())
