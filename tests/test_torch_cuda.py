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
    from ipoke_tpu_torch.data.synthetic import from_data_config, train_batches
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
    batch = next(train_batches(from_data_config(config["data"]), 2))
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
