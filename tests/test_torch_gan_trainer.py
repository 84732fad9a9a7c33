"""The port's stage-1 trainer CLI against the JAX package on the CPU:
``python -m ipoke_tpu_torch.experiments.first_stage train`` on
configs/first_stage.yaml shrunk to the test size of tests/test_torch_first_stage.py
(one step, B=1) writes a ``last.npz`` that ``ipoke_tpu.ckpt.io.load`` reads,
with JAX's ``GanTrainState`` keys and ``u`` beside the kernels; the nets bridge
back bitwise; JAX's ``first_stage.forward`` on its ``gen_params`` equals the
port's within 2e-4·(1+max|ref|); without ``--device`` and without a card the
CLI stops with the port's "no CUDA device" error.  Most of its ~35 s here is
the port's init of the default temporal disc (JAX's draws of a 3D ResNet-18
at its fixed widths) and one step of it."""
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ipoke_tpu.ckpt import io as jio
from ipoke_tpu_torch.ckpt.jax_bridge import bridge_gan_params, unbridge_gan_params
from ipoke_tpu_torch.config import load_parameters
from ipoke_tpu_torch.experiments import first_stage as experiment
from ipoke_tpu_torch.models import first_stage as pfs
from ipoke_tpu_torch.utils import prng
from test_torch_first_stage import FS_SPEC, FWD_KEY, N_SPATIAL, TOL, _max_err, jax_forward
from torch_port_util import CPU, GAN_BATCH, GAN_FS, flatten, np_tree, t

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _no_onednn():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def test_trainer_cli_writes_jax_last_npz(tmp_path):
    """``python -m ipoke_tpu_torch.experiments.first_stage train`` on
    configs/first_stage.yaml shrunk to the test size (B=1), one step on the CPU."""
    cfg = yaml.safe_load((ROOT / "configs" / "first_stage.yaml").read_text())
    cfg["general"]["base_dir"] = str(tmp_path / "logs")
    cfg["data"].update({"batch_size": 1, "n_examples": 2, "max_frames": GAN_FS["max_frames"],
                        "spatial_size": [32, 32]})
    cfg["architecture"].update({"ENC_M_channels": list(GAN_FS["enc_channels"]), "z_dim": GAN_FS["z_dim"],
                                "dec_channels": list(GAN_FS["dec_channels"]), "n_gru_layers": 1,
                                "min_spatial_size": GAN_FS["min_spatial_size"]})
    cfg["d_t"]["max_frames"] = 12   # clipped to the data's frames
    cfg["d_s"]["n_examples"] = N_SPATIAL
    path = tmp_path / "first_stage.yaml"
    path.write_text(yaml.safe_dump(cfg))
    experiment.main(["train", "-c", str(path), "-m", "tiny", "--max-steps", "1", "--device", "cpu"])
    config, dirs = load_parameters(str(path), "tiny")
    fs_spec, ds_spec, dt_spec, n_spatial = experiment.specs_from_config(config)
    assert fs_spec == FS_SPEC and dt_spec.sequence_length == GAN_FS["max_frames"] and n_spatial == 2
    ckpt = os.path.join(dirs["ckpt"], "0", "last.npz")
    tree, meta = jio.load(ckpt)
    assert meta == {"step": 1} and int(tree["step"]) == 1
    assert sorted(tree) == ["ds_opt", "ds_params", "dt_opt", "dt_params", "gen_opt", "gen_params", "step"]
    gen_chain, dt_chain = (tree[k]["inner_states"]["train"]["inner_state"]   # optax's layout
                           for k in ("gen_opt", "dt_opt"))
    assert int(gen_chain[1]["count"]) == 1 and int(dt_chain[2]["count"]) == 1
    assert "u" in tree["dt_params"]["conv1"] and dt_chain[1]["mu"]["conv1"]["u"] == {}
    nets = bridge_gan_params(np_tree(tree), device=CPU)
    back = unbridge_gan_params(nets)
    for k, v in flatten(np_tree({n: tree[n] for n in back})).items():
        assert np.array_equal(flatten(back)[k], v), k
    images = np.random.default_rng(15).uniform(-1, 1, (GAN_BATCH, GAN_FS["max_frames"], 32, 32, 3))
    images = images.astype(np.float32)
    want = jax_forward(tree["gen_params"], jnp.asarray(images), jax.random.PRNGKey(FWD_KEY))
    with torch.no_grad():
        got = pfs.forward(pfs.materialize_spectral_norm(nets["gen_params"]), t(images), FS_SPEC,
                          rng=prng.prng_key(FWD_KEY))
    for g, w in zip(got, want):
        assert _max_err(g, w) <= TOL
    if not torch.cuda.is_available():   # no quiet fallback to the CPU
        with pytest.raises(SystemExit, match="no CUDA device"):
            experiment.main(["train", "-c", str(path), "-m", "tiny", "--max-steps", "1"])
