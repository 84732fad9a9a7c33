"""The port's evaluation path (``eval/test_modes``, the trainers' validation
and top-k checkpoints, the data module on the synthetic dataset) against the JAX package
on the CPU, on tests/torch_port_util.py's tiny second stage (64x64, 3
frames) with non-zero flow output gains.

``forward_sample``'s parity with JAX is tests/test_torch_slice.py's; here a
recording wrapper around it shows what each mode samples: on which batches,
with how many samples, on which keys (JAX's ``split`` chain, bitwise), and
what the mode makes of the videos:
* ``run_fvd``: JAX's ``FVDAccumulator`` on the same real and sampled
  videos gives the port's score within FVD_REL_TOL = 1e-5 relative
  (measured 7.5e-7 on 4 to 8 videos and 4.3e-7 for the stage-2 validation
  on 2 to 4: both covariances of the 400-dim features are rank-deficient,
  and ``sqrtm`` of their product turns the features' ~5e-7 differences
  into that); the other FVD paths (``validate``, the CLI, the stage-1
  trainer) on cheap stand-in features, which show their wiring;
* ``run_diversity``: the three scores of the sampled videos (JAX's MSE
  score; the VGG and LPIPS scores, held to JAX's in
  tests/test_torch_metrics.py, the port's) within 2e-5;
* ``run_samples``: the files of JAX's layout, enrollment PNGs equal to
  JAX's ``enrollment`` pixel for pixel.
The trainers: JAX's ``Experiment.fit`` validation schedule and
``CheckpointManager`` top-k rule on scripted FVD values, the stage-2 trainer
and ``test`` loading ``find_best``, the stage-1 trainer with its real
validation, whose best checkpoint ``test`` scores again identically.
Whole modes and both ``validate``s against JAX's own are ``slow``.
"""
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from ipoke_tpu.ckpt import io as jio
from ipoke_tpu.data.datamodule import StaticDataModule
from ipoke_tpu.experiments.base import Experiment
from ipoke_tpu.metrics import diversity as jdiv
from ipoke_tpu.metrics import fvd as jfvd
from ipoke_tpu.metrics import i3d as ji3d
from ipoke_tpu.utils.video import enrollment as jenrollment
from ipoke_tpu.utils.video import save_image as jsave_image
from ipoke_tpu_torch.ckpt import io
from ipoke_tpu_torch.ckpt.jax_bridge import bridge_second_stage
from ipoke_tpu_torch.config import load_parameters
from ipoke_tpu_torch.data.datamodule import StaticDataModule as PortDataModule
from ipoke_tpu_torch.eval import test_modes
from ipoke_tpu_torch.experiments import base
from ipoke_tpu_torch.experiments import first_stage as experiment_fs
from ipoke_tpu_torch.experiments import second_stage as experiment
from ipoke_tpu_torch.metrics import diversity
from ipoke_tpu_torch.metrics import fvd as fvd_mod
from ipoke_tpu_torch.utils import synth
from torch_port_util import CPU, flatten, tiny_config

FVD_REL_TOL = 1e-5
DIV_TOL = 2e-5
SEED = 5          # testing.seed
DATA = {"spatial_size": [64, 64], "max_frames": 3, "batch_size": 2, "n_examples": 6, "seed": 1}


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    cfg = tiny_config(tmp_path_factory.mktemp("eval") / "logs")
    cfg["data"] = dict(DATA)
    spec = experiment.build_spec_from_config(cfg)
    params = experiment.init_params(cfg, spec, CPU)
    params["flow"] = synth.set_flow_output_gains(params["flow"], 0.05)
    batches = list(PortDataModule(cfg["data"]).loader("test"))
    assert len(batches) == 3
    return cfg, spec, params, batches


class ListData:
    """A data module whose every split yields ``batches``."""

    def __init__(self, batches):
        self.batches = batches
        self.splits = []

    def loader(self, split):
        self.splits.append(split)
        return iter(self.batches)


@pytest.fixture
def record(monkeypatch):
    """Every ``forward_sample`` call of the eval modes: its key, sample
    count, images and videos."""
    calls = []
    real = test_modes.second_stage.forward_sample

    def wrapped(params, spec, batch, rng=None, n_samples=1, **kw):
        out = real(params, spec, batch, rng, n_samples=n_samples, **kw)
        calls.append({"key": rng, "n": n_samples, "images": batch["images"].numpy().copy(),
                      "out": out.numpy().copy()})
        return out

    monkeypatch.setattr(test_modes.second_stage, "forward_sample", wrapped)
    return calls


_jax_i3d = jax.jit(ji3d.features)


def _jax_accumulator(n_samples=1000):
    """JAX's FVDAccumulator with its I3D jitted once per process, the filters
    as arguments (its own jit closes over them as constants: the same
    function, a slower compile)."""
    acc = jfvd.FVDAccumulator(n_samples=n_samples)
    params = jax.tree_util.tree_map(jnp.asarray, ji3d.load_params()[0])
    acc._feat_fn = lambda v: _jax_i3d(jnp.asarray(v), params)
    return acc


def _stand_in(videos):
    """Cheap deterministic 32-dim features of each video: the FVD wiring
    tests' stand-in for I3D (whose features are held to JAX's in
    tests/test_torch_metrics.py, and whose whole FVD chain to JAX's in
    test_run_fvd_draws_and_scores_as_jax)."""
    flat = videos.float().reshape(videos.shape[0], -1)
    return flat[:, ::max(1, flat.shape[1] // 32)][:, :32].cpu().numpy()


@pytest.fixture
def stand_in_features(monkeypatch):
    monkeypatch.setattr(fvd_mod, "_features", _stand_in)


def _fvd_of(pairs):
    """JAX's Fréchet distance of the stand-in features of (real, fake) pairs."""
    real = np.concatenate([_stand_in(torch.from_numpy(np.asarray(r))) for r, _ in pairs])
    fake = np.concatenate([_stand_in(torch.from_numpy(np.asarray(f))) for _, f in pairs])
    return jfvd.frechet_distance(*jfvd._moments(real), *jfvd._moments(fake))


def _jax_keys(seed, n):
    rng, keys = jax.random.PRNGKey(seed), []
    for _ in range(n):
        rng, sub = jax.random.split(rng)
        keys.append(tuple(int(v) for v in np.asarray(sub)))
    return keys


def _mode_config(cfg, **testing):
    return dict(cfg, testing=dict({"seed": SEED}, **testing))


def _dirs(tmp_path):
    return {"generated": str(tmp_path / "generated")}


def test_synthetic_loader_matches_jax_datamodule():
    """The port's ``StaticDataModule`` on the synthetic dataset: JAX's
    val/test batches (index order, the partial batch dropped) and its
    training batches with zero pokes; an unknown dataset raises as JAX's."""
    data = {"dataset": "SyntheticDataset", "spatial_size": [32, 32], "max_frames": 3,
            "batch_size": 2, "n_examples": 5, "seed": 3, "n_pokes": 2, "n_workers": 1,
            "zero_poke": True, "zero_poke_amount": 2}
    jdm, dm = StaticDataModule(data), PortDataModule(data)
    for split in ("val", "test", "train"):
        got, want = list(dm.loader(split)), list(jdm.loader(split))
        assert len(got) == len(want) == 2          # 5 examples, the partial batch dropped
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                assert np.array_equal(g[k], np.asarray(w[k])), (split, k)
    with pytest.raises(KeyError):
        PortDataModule(dict(data, dataset="NoSuchDataset"))


def test_run_fvd_draws_and_scores_as_jax(model, record, tmp_path):
    """n_samples_fvd 4 over a split of one batch of 2 wraps to it again; one
    sample per example; the npy dump is under 200 MB, so written."""
    cfg, spec, params, batches = model
    out = test_modes.run_fvd(params, spec, _mode_config(cfg, n_samples_fvd=4),
                             ListData(batches[:1]), _dirs(tmp_path))
    assert [c["key"] for c in record] == _jax_keys(SEED, 2)
    assert all(c["n"] == 1 for c in record)
    for c in record:
        assert np.array_equal(c["images"], batches[0]["images"])
    acc = _jax_accumulator(n_samples=4)
    for c in record:
        acc.update(c["images"][:, 1:], c["out"][0])
    ref = acc.compute()
    assert set(out) == {"FVD_UNPRETRAINED", "n", "i3d_pretrained", "npy_dir"}
    assert out["n"] == 4 and out["i3d_pretrained"] is False
    assert abs(out["FVD_UNPRETRAINED"] - ref) <= FVD_REL_TOL * abs(ref)
    real = np.load(os.path.join(out["npy_dir"], "real_samples.npy"))
    fake = np.load(os.path.join(out["npy_dir"], "fake_samples.npy"))
    assert real.dtype == fake.dtype == np.uint8 and real.shape == fake.shape == (4, 2, 64, 64, 3)
    assert np.array_equal(real, np.concatenate(
        [((c["images"][:, 1:] + 1) * 127.5).astype(np.uint8) for c in record]))
    assert np.array_equal(fake, np.concatenate(
        [((c["out"][0] + 1) * 127.5).astype(np.uint8) for c in record]))
    with open(tmp_path / "generated" / "metrics" / "fvd.json") as f:
        assert json.load(f) == out


def test_run_diversity_draws_and_scores_as_jax(model, record, tmp_path):
    """3 samples per example, 1 example: one batch sampled, its second
    example cut; the three pairs of samples scored."""
    cfg, spec, params, batches = model
    out = test_modes.run_diversity(
        params, spec, _mode_config(cfg, n_samples_per_data_point=3, n_samples_metrics=1),
        ListData(batches), _dirs(tmp_path))
    assert [c["key"] for c in record] == _jax_keys(SEED, 1)
    assert [c["n"] for c in record] == [3]
    samples = np.concatenate([c["out"].transpose(1, 0, 2, 3, 4, 5) for c in record])[:1]
    assert out["n"] == 1
    # the VGG and LPIPS scores themselves are held to JAX's in
    # tests/test_torch_metrics.py; here, the samples the mode hands them
    for name, ref in (("div_vgg_cosine", diversity.div_score_vgg(torch.from_numpy(samples))),
                      ("div_mse", jdiv.div_score_mse(jnp.asarray(samples))),
                      ("div_lpips", diversity.div_score_lpips(torch.from_numpy(samples)))):
        assert abs(out[name] - ref) <= DIV_TOL * (1 + abs(ref)), name
    assert os.path.exists(tmp_path / "generated" / "metrics" / "diversity.json")


def test_run_samples_writes_jax_layout(model, record, tmp_path):
    """n_samples_vis 3: the whole first batch and one example of the second."""
    cfg, spec, params, batches = model
    out = test_modes.run_samples(
        params, spec, _mode_config(cfg, n_samples_per_data_point=2, n_samples_vis=3),
        ListData(batches), _dirs(tmp_path))
    assert out["n_examples"] == 3 and [c["key"] for c in record] == _jax_keys(SEED, 2)
    root = tmp_path / "generated" / "samples_best_fvd"
    sids = [(0, 0), (0, 1), (1, 0)]
    assert sorted(os.listdir(root)) == sorted(f"sid_{int(batches[b]['sample_ids'][i])}" for b, i in sids)
    for b, i in sids:
        sid_dir = root / f"sid_{int(batches[b]['sample_ids'][i])}"
        (stamp,) = os.listdir(sid_dir)
        files = sorted(os.listdir(sid_dir / stamp))
        stems = sorted(os.path.splitext(f)[0] for f in files)
        assert stems == ["enrollment_0", "enrollment_1", "groundtruth", "sample_0", "sample_1"]
        for si in range(2):
            clip = np.concatenate([batches[b]["images"][i][:1], record[b]["out"][si, i]], 0)
            jsave_image(jenrollment(clip), str(tmp_path / "jax.png"))
            got = np.asarray(Image.open(sid_dir / stamp / f"enrollment_{si}.png"))
            assert np.array_equal(got, np.asarray(Image.open(tmp_path / "jax.png")))


def test_every_test_mode_dispatches(monkeypatch):
    """``main.TEST_MODES`` are the choices of the repository's ``main.py
    --test``, and each mode but ``none`` maps to its function in
    ``test_modes.MODES``, as JAX's ``SecondStageExperiment.test`` maps it;
    an unknown mode raises."""
    import argparse
    import importlib.util

    from ipoke_tpu_torch import main as port_main
    from test_torch_gan_trainer import ROOT

    seen = {}

    def capture(self, *a, **k):
        seen["parser"] = self
        return argparse.Namespace()

    spec = importlib.util.spec_from_file_location("jax_main", ROOT / "main.py")
    jax_main = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_main)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    jax_main.parse_args()
    (action,) = [a for a in seen["parser"]._actions if "--test" in a.option_strings]
    assert tuple(action.choices) == port_main.TEST_MODES
    assert list(test_modes.MODES) == [m for m in port_main.TEST_MODES if m != "none"]
    for mode in test_modes.MODES:
        assert test_modes.mode_fn(mode) is getattr(test_modes, f"run_{mode}")
    with pytest.raises(ValueError, match="unknown test mode"):
        test_modes.mode_fn("nope")


def test_evaluate_diversity_cli_matches_jax(tmp_path, capsys, monkeypatch):
    """The diversity CLI on a uint8 (n_ex, n_samples, T, C, H, W) npy: the
    same layout and dequantisation as JAX's, the same MSE score."""
    from ipoke_tpu.eval import evaluate_diversity as jcli
    from ipoke_tpu_torch.eval import evaluate_diversity as cli

    path = tmp_path / "s.npy"
    np.save(path, np.random.default_rng(6).integers(0, 256, (3, 3, 2, 3, 8, 8)).astype(np.uint8))
    out = cli.main(["--samples", str(path), "--repr", "mse", "--max_examples", "2", "--device", "cpu"])
    monkeypatch.setattr("sys.argv", ["x", "--samples", str(path), "--repr", "mse", "--max_examples", "2"])
    capsys.readouterr()
    jcli.main()
    ref = json.loads(capsys.readouterr().out)
    assert out.keys() == ref.keys() == {"div_mse"}
    assert abs(out["div_mse"] - ref["div_mse"]) <= DIV_TOL * (1 + abs(ref["div_mse"]))
    assert cli.load_samples(path, 2).shape == (2, 3, 2, 8, 8, 3)


def test_second_stage_validate_chain(model, record, stand_in_features):
    """``validate``: the val split's first max_val_batches batches, the keys
    of prng_key(123), the density loss as the train step's, FVD of frames
    1..T-1 against one sample each (JAX's Fréchet code on the same
    stand-in features)."""
    cfg, spec, params, batches = model
    data = ListData(batches)
    out = experiment.validate(params, spec, dict(cfg, training={"max_val_batches": 2}), data)
    assert data.splits == ["val"] and [c["key"] for c in record] == _jax_keys(123, 2)
    for c, b in zip(record, batches):
        assert np.array_equal(c["images"], b["images"]) and c["n"] == 1
    ref = _fvd_of([(c["images"][:, 1:], c["out"][0]) for c in record])
    assert abs(out["FVD-val"] - ref) <= 1e-12 * abs(ref)
    with torch.no_grad():
        losses = [float(experiment.flow_loss(*experiment.second_stage.forward_density(
            params, spec, test_modes._to_batch(b, CPU))[:2])[0]) for b in batches[:2]]
    assert out["flow_loss-val"] == pytest.approx(np.mean(losses), rel=1e-6)


# ---------------------------------------------------------------------------
# the validation schedule and the top-k checkpoints
# ---------------------------------------------------------------------------

def _jax_fit(tmp_path, n_epochs, steps_per_epoch, val_every_steps, values, top_k):
    """JAX's ``Experiment.fit`` with a no-op step and scripted FVD values:
    the steps it validates at and its CheckpointManager's directory."""
    exp = Experiment.__new__(Experiment)
    exp.monitor = "FVD-val"
    exp.console = types.SimpleNamespace(info=lambda *a: None, warning=lambda *a: None)
    exp.logger = types.SimpleNamespace(log_scalars=lambda *a, **k: None)
    exp.ckpt_dir = str(tmp_path / "jax")
    exp.ckpt_mgr = jio.CheckpointManager(exp.ckpt_dir, monitor="FVD-val", top_k=top_k)
    seen = []

    def validate(state, dm):
        seen.append(exp_step["i"])
        return {"FVD-val": values[len(seen) - 1]}

    def step(state, batch, key):
        exp_step["i"] += 1
        return {"step": np.int32(exp_step["i"])}, {}

    step._jitted = True
    exp_step = {"i": 0}
    dm = types.SimpleNamespace(loader=lambda split: iter(range(steps_per_epoch + 1)))
    exp.fit(step, {"step": np.int32(0)}, dm, jax.random.PRNGKey(0), n_epochs, validate=validate,
            val_every_steps=val_every_steps, max_batches_per_epoch=steps_per_epoch)
    return seen, exp.ckpt_dir


def _ckpt_listing(d):
    with open(os.path.join(d, "best_k_models.json")) as f:
        best = {os.path.basename(k): v for k, v in json.load(f).items()}
    return sorted(f for f in os.listdir(d) if f.endswith(".npz")), best


@pytest.mark.parametrize("n_epochs,steps_per_epoch,val_every_steps", [
    (2, 3, 1),       # every step and each epoch's end: the end twice
    (2, 4, 3),
    (3, 2, None),    # stage 1: epoch ends only
])
def test_fit_schedule_and_top_k_match_jax(tmp_path, n_epochs, steps_per_epoch, val_every_steps):
    values = [7.0, 3.5, 9.0, 1.25, 3.5, 8.0, 2.0, 6.0, 0.5]
    want, jdir = _jax_fit(tmp_path, n_epochs, steps_per_epoch, val_every_steps, values, top_k=2)
    mgr = io.CheckpointManager(str(tmp_path / "port"), monitor="FVD-val", top_k=2)
    steps, seen = [0], []

    def validate(i):
        seen.append(i)
        mgr.save_step({"step": np.int32(i)}, i, values[len(seen) - 1])

    epoch = lambda: iter(range(steps_per_epoch + 1))   # noqa: E731  (JAX's loader above)
    n = base.fit(lambda batch: steps.append(steps[-1] + 1), n_epochs, epoch, steps_per_epoch,
                 validate, val_every_steps)
    assert seen == want and n == n_epochs * steps_per_epoch
    assert _ckpt_listing(mgr.ckpt_dir) == _ckpt_listing(jdir)
    assert os.path.basename(io.find_best(mgr.ckpt_dir)) == os.path.basename(jio.CheckpointManager.find_best(jdir))
    # max_steps cuts the schedule: a step's validations and an epoch's end
    # only where that step ran (at cut = n, JAX's schedule above)
    for cut in range(1, n + 1):
        part = []
        assert base.fit(lambda batch: None, n_epochs, epoch, steps_per_epoch, part.append,
                        val_every_steps, max_steps=cut) == cut
        expected = [s for s in range(1, cut + 1)
                    for hit in (val_every_steps and s % val_every_steps == 0, s % steps_per_epoch == 0)
                    if hit]
        assert part == expected
    assert expected == want


def test_second_stage_trainer_keeps_top_k_and_test_loads_best(model, tmp_path, monkeypatch):
    """2 epochs of 2 steps, val_every 0.5: validations at steps 1, 2, 2, 3,
    4, 4 (scripted FVD values), top 2 kept as JAX keeps them; ``test`` runs
    its mode on the flow of the best step, not the last."""
    cfg0 = model[0]
    cfg = dict(cfg0, general=dict(cfg0["general"], base_dir=str(tmp_path / "logs")),
               training={"n_epochs": 2, "max_batches_per_epoch": 2, "val_every": 0.5,
                         "lr": 1e-3, "lr_scaling_max_it": 1},
               logging={"n_saved_ckpt": 2})
    dirs = {k: str(tmp_path / "logs" / k) for k in ("ckpt", "generated")}
    values = [5.0, 1.0, 1.0, 4.0, 3.0, 3.0]
    flows = {}

    def scripted(params, spec, config, datamod, log_dir=None, timings=None):
        assert isinstance(datamod, PortDataModule)
        flows[len(flows)] = {k: v.detach().clone() for k, v in flatten(params["flow"]).items()}
        return {"FVD-val": values[len(flows) - 1], "flow_loss-val": 0.0}

    monkeypatch.setattr(experiment, "validate", scripted)
    run = experiment.train(cfg, dirs, device="cpu")
    assert [v["step"] for v in run["val"]] == [1, 2, 2, 3, 4, 4]
    want, jdir = _jax_fit(tmp_path, 2, 2, 1, values, top_k=2)
    assert want == [1, 2, 2, 3, 4, 4]
    assert _ckpt_listing(run["ckpt_dir"]) == _ckpt_listing(jdir)
    best = io.find_best(run["ckpt_dir"])
    assert os.path.basename(best) == "step=2-FVD-val=1.000.npz"
    tree, meta = jio.load(best)          # JAX's reader
    assert meta == {"step": 2, "FVD-val": 1.0} and int(tree["step"]) == 2
    _, last_meta = jio.load(run["ckpt"])
    assert last_meta == {"step": 4, "FVD-val": 3.0}

    seen = {}

    def capture(params, spec, config, datamod, dirs, timings=None):
        seen["flow"] = flatten(params["flow"])
        return {}

    monkeypatch.setitem(test_modes.MODES, "fvd", capture)
    experiment.test(cfg, dirs, mode="fvd", device="cpu")
    for k, v in flows[1].items():          # the second validation: step 2
        assert torch.equal(seen["flow"][k], v), k
    assert any(not torch.equal(seen["flow"][k], v) for k, v in flows[5].items())
    saved = flatten(bridge_second_stage({"flow": tree["params"]["flow"]}, run["spec"], CPU)["flow"])
    assert all(torch.equal(saved[k], v) for k, v in flows[1].items())


def test_second_stage_test_cli(model, tmp_path, stand_in_features):
    """``test --mode fvd`` on the run tree of a config without checkpoints
    (every component from the seed, as JAX's ``_load_for_test``); a mode
    that is not one of JAX's is refused before anything loads."""
    cfg = dict(model[0], general=dict(model[0]["general"], base_dir=str(tmp_path / "logs")),
               testing={"n_samples_fvd": 2, "seed": 0})
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    experiment.main(["test", "-c", str(path), "-m", "m", "--mode", "fvd", "--device", "cpu"])
    with open(tmp_path / "logs" / "serve_ckpt" / "generated" / "m" / "metrics" / "fvd.json") as f:
        out = json.load(f)
    assert out["n"] == 2 and np.isfinite(out["FVD_UNPRETRAINED"])
    with pytest.raises(SystemExit):
        experiment.main(["test", "-c", str(path), "-m", "m", "--mode", "nope", "--device", "cpu"])
    if not torch.cuda.is_available():   # no quiet fallback to the CPU
        with pytest.raises(SystemExit, match="no CUDA device"):
            experiment.main(["test", "-c", str(path), "-m", "m", "--mode", "fvd"])


def _nudged(tree, delta):
    if isinstance(tree, dict):
        return {k: _nudged(v, delta) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_nudged(v, delta) for v in tree]
    return tree + delta if tree.is_floating_point() else tree


def test_first_stage_trainer_validates_and_test_loads_best(tmp_path, monkeypatch, stand_in_features):
    """The stage-1 trainer's validation and checkpoints at the GAN test size
    (32x32, B=2), 2 epochs of one step: a real validation of the generator
    at each epoch's end, the top 1 kept by FVD-val as JAX's
    CheckpointManager keeps it; ``test`` scores the best generator again to
    the same numbers.  The GAN state's discriminators, the step (it moves
    the generator) and the I3D features are stubs: JAX's GAN init, step and
    the trainer's CLI are held in tests/test_torch_gan_init.py,
    tests/test_torch_first_stage.py and tests/test_torch_gan_trainer.py."""
    from test_torch_gan_trainer import ROOT
    from torch_port_util import GAN_FS

    from ipoke_tpu_torch.models import first_stage as pfs
    from ipoke_tpu_torch.train import first_stage as tfs
    from ipoke_tpu_torch.utils import prng

    cfg = yaml.safe_load((ROOT / "configs" / "first_stage.yaml").read_text())
    cfg["general"]["base_dir"] = str(tmp_path / "logs")
    cfg["data"].update({"batch_size": 2, "n_examples": 4, "max_frames": GAN_FS["max_frames"],
                        "spatial_size": [32, 32]})
    cfg["architecture"].update({"ENC_M_channels": list(GAN_FS["enc_channels"]), "z_dim": GAN_FS["z_dim"],
                                "dec_channels": list(GAN_FS["dec_channels"]), "n_gru_layers": 1,
                                "min_spatial_size": GAN_FS["min_spatial_size"]})
    cfg["d_s"]["n_examples"] = 2
    cfg["training"].update({"n_epochs": 2, "max_batches_per_epoch": 1, "max_val_batches": 1})
    cfg.setdefault("logging", {})["n_saved_ckpt"] = 1
    path = tmp_path / "fs.yaml"
    path.write_text(yaml.safe_dump(cfg))
    config, dirs = load_parameters(str(path), "tiny")

    def stub_init(key, fs_spec, ds_spec, dt_spec, lr=2e-4, weight_decay=1e-5, gamma=0.98,
                  steps_per_epoch=2000, device=None):
        # the generator as init_gan_state draws it, one-leaf discriminators
        nets = {"gen": pfs.init(prng.split(key, 3)[0], fs_spec, device, spectral_u=True),
                "ds": {"w": torch.zeros(2)}, "dt": {"w": torch.zeros(2)}}
        opts = {n: tfs.make_gan_optimizer(lr, weight_decay, gamma, steps_per_epoch) for n in tfs.NETS}
        return tfs.GanTrainState(0, nets["gen"], nets["ds"], nets["dt"],
                                 *(opts[n].init(tfs.trainable(nets[n])) for n in tfs.NETS)), opts

    def stub_step(*args, **kw):
        def step(state, batch, rng):
            assert batch["images"].shape == (2, GAN_FS["max_frames"], 32, 32, 3)
            with torch.no_grad():
                gen = _nudged(state.gen_params, 0.01 * (state.step + 1))
            return state._replace(step=state.step + 1, gen_params=gen), {
                k: torch.tensor(0.0) for k in ("loss", "loss_d_dt", "loss_d_ds", "l_rec")}
        return step

    monkeypatch.setattr(experiment_fs.train_fs, "init_gan_state", stub_init)
    monkeypatch.setattr(experiment_fs.train_fs, "make_gan_train_step", stub_step)
    run = experiment_fs.train(config, dirs, device="cpu")
    assert [v["step"] for v in run["val"]] == [1, 2]
    for v in run["val"]:
        assert all(np.isfinite(v[k]) for k in ("FVD-val", "ssim-val", "psnr-val", "lpips-val"))
    values = [v["FVD-val"] for v in run["val"]]
    assert values[0] != values[1]
    _, jdir = _jax_fit(tmp_path, 2, 1, None, values, top_k=1)
    assert _ckpt_listing(run["ckpt_dir"]) == _ckpt_listing(jdir)
    best = run["val"][int(np.argmin(values))]
    got = experiment_fs.test(config, dirs, device="cpu")
    assert got == {k: best[k] for k in got}


# ---------------------------------------------------------------------------
# slow: whole modes and validations against JAX's own
# ---------------------------------------------------------------------------

def _jax_model(cfg, spec, params):
    from ipoke_tpu.experiments.second_stage import build_spec_from_config as jbuild
    from ipoke_tpu_torch.ckpt.jax_bridge import unbridge_second_stage

    return jbuild(cfg), jax.tree_util.tree_map(jnp.asarray, unbridge_second_stage(params, spec))


# Relative tolerances, each about ten times the difference measured in the
# slow runs here: forward_sample holds JAX's videos to ~1e-6
# (tests/test_torch_slice.py), and the scores carry that on.  The VGG-cosine
# diversity (4.8e-5 measured) is one minus a cosine of ~0.9994, and the
# stage-1 SSIM (7.9e-5) a mean of ~-0.004: both relative to small values.
WHOLE_REL_TOL = {"FVD_UNPRETRAINED": 1e-5, "div_vgg_cosine": 5e-4, "div_mse": 1e-5,
                 "div_lpips": 1e-5, "FVD-val": 1e-5, "flow_loss-val": 1e-6, "ssim-val": 1e-3,
                 "psnr-val": 1e-6, "lpips-val": 1e-5}


def _close(got, ref):
    for k, r in ref.items():
        if isinstance(r, float):
            assert abs(got[k] - r) <= WHOLE_REL_TOL[k] * abs(r), (k, got[k], r)


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["fvd", "diversity"])
def test_whole_mode_matches_jax(model, tmp_path, mode):
    from ipoke_tpu.eval import test_modes as jmodes

    cfg, spec, params, batches = model
    jspec, jparams = _jax_model(cfg, spec, params)
    config = _mode_config(cfg, n_samples_fvd=6, n_samples_per_data_point=2, n_samples_metrics=3)
    ref = getattr(jmodes, f"run_{mode}")(jparams, jspec, config, ListData(batches),
                                         {"generated": str(tmp_path / "jax")})
    got = getattr(test_modes, f"run_{mode}")(params, spec, config, ListData(batches),
                                             {"generated": str(tmp_path / "port")})
    assert got.keys() == ref.keys() - {"npy_dir"} | ({"npy_dir"} if "npy_dir" in ref else set())
    print(mode, {k: (got[k], ref[k]) for k in ref if isinstance(ref[k], float)})
    _close(got, ref)


@pytest.mark.slow
def test_second_stage_validate_matches_jax(model, tmp_path):
    from ipoke_tpu.experiments.second_stage import SecondStageExperiment
    from ipoke_tpu.train.second_stage import split_params

    cfg, spec, params, _ = model
    config = dict(cfg, general=dict(cfg["general"], experiment="v", base_dir=str(tmp_path)),
                  training={"max_val_batches": 2}, logging={"n_fvd_samples": 4})
    dirs = {k: str(tmp_path / k) for k in ("ckpt", "log", "generated", "config")}
    exp = SecondStageExperiment(config, dirs)
    _, jparams = _jax_model(cfg, spec, params)
    trainable, exp._frozen = split_params(jparams)
    ref = exp.validate(types.SimpleNamespace(params=trainable), exp.datamod)
    got = experiment.validate(params, spec, config, PortDataModule(config["data"]))
    print("stage-2 validate", {k: (got[k], float(ref[k])) for k in ref})
    _close(got, {k: float(v) for k, v in ref.items()})


@pytest.mark.slow
def test_first_stage_validate_matches_jax(tmp_path):
    from ipoke_tpu.experiments.first_stage import FirstStageExperiment
    from ipoke_tpu_torch.ckpt.jax_bridge import unbridge_gan_params
    from test_torch_gan_trainer import ROOT
    from torch_port_util import GAN_FS

    cfg = yaml.safe_load((ROOT / "configs" / "first_stage.yaml").read_text())
    cfg["general"].update({"base_dir": str(tmp_path), "seed": 3})
    cfg["data"].update({"batch_size": 2, "n_examples": 4, "max_frames": GAN_FS["max_frames"],
                        "spatial_size": [32, 32]})
    cfg["architecture"].update({"ENC_M_channels": list(GAN_FS["enc_channels"]), "z_dim": GAN_FS["z_dim"],
                                "dec_channels": list(GAN_FS["dec_channels"]), "n_gru_layers": 1,
                                "min_spatial_size": GAN_FS["min_spatial_size"]})
    cfg["training"]["max_val_batches"] = 2
    dirs = {k: str(tmp_path / k) for k in ("ckpt", "log", "generated", "config")}
    exp = FirstStageExperiment(cfg, dirs)
    gen = experiment_fs.load_generator(cfg, dirs, device="cpu")     # no checkpoint: the seed's
    jgen = jax.tree_util.tree_map(jnp.asarray, unbridge_gan_params({"gen_params": gen})["gen_params"])
    ref = exp.validate(types.SimpleNamespace(gen_params=jgen), exp.datamod)
    with torch.backends.mkldnn.flags(enabled=False):
        got = experiment_fs.validate(gen, experiment_fs.specs_from_config(cfg)[0], cfg,
                                     PortDataModule(cfg["data"]))
    print("stage-1 validate", {k: (got[k], float(ref[k])) for k in ref})
    _close(got, {k: float(v) for k, v in ref.items()})
