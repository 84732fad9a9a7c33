"""The port's training and quality tools on the CPU: ``utils/profiling``,
the draws of ``utils/bench_gan --converge`` and ``utils/bench_train
--converge``, ``utils/bench_e2e`` end to end at micro settings, and
``utils/bench_distill``'s FVD* of a flow student.

* ``trace`` writes a Chrome trace.
* The blob videos and the converge batches equal JAX's draws within 1e-6
  (the same threefry bits; exp and erfinv in f32 may differ in the last
  ulp).
* ``bench_e2e.main`` on the CPU at 64^2, 3 frames, B=2 with both stage-2
  trainers: its JSON line holds JAX's keys, the curve has one FVD* per
  evaluation, K2's plain version ran (the launch counter stays 0 on the
  CPU); JAX's flagship shape at the default flow factor raises as JAX's
  init does.  I3D is replaced by ``tests/test_torch_eval.py``'s stand-in
  features: the FVD chain is held to JAX in ``tests/test_torch_metrics.py``
  and ``tests/test_torch_eval.py``.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipoke_tpu.flows import macow as jmacow
from ipoke_tpu.flows.macow import FlowSpec as JaxFlowSpec
from ipoke_tpu_torch import registry
from ipoke_tpu_torch.metrics import fvd as fvd_mod
from ipoke_tpu_torch.ops.cuda import launches_since
from ipoke_tpu_torch.utils import bench_distill, bench_e2e, bench_gan, bench_train, profiling
from torch_port_util import CPU

DRAW_TOL = 1e-6
# the keys of JAX's bench_e2e JSON line
E2E_KEYS = {"metric", "i3d_pretrained", "fvd_key", "steps", "fvd", "flow_loss_at_evals",
            "fvd_recon_floor", "improved_final_lt_80pct_of_control", "n_decreasing_transitions",
            "n_evals", "encoders", "stage1", "distill_signoff", "config", "artifacts_dir",
            "wall_s"}
SIGNOFF_KEYS = {"student", "final_distill_mse", "teacher_finite_frac_logged", "teacher_fvd",
                "student_fvd", "fvd_delta_student_minus_teacher", "control_fvd"}
E2E_MICRO = ["--size", "64", "--frames", "3", "--batch", "2", "--n-eval", "2", "--n-train", "4",
             "--nf-max", "16", "--flow-hidden", "16", "--num-steps", "1,1", "--device", "cpu"]
FLAGSHIP_STEPS = "10,5,5,4,4,4,3,3,3,2,2,2,1,1,1"


def _stand_in(videos):
    """tests/test_torch_eval.py's stand-in for I3D's features."""
    flat = videos.float().reshape(videos.shape[0], -1)
    return flat[:, ::max(1, flat.shape[1] // 32)][:, :32].cpu().numpy()


@pytest.fixture
def stand_in_features(monkeypatch):
    monkeypatch.setattr(fvd_mod, "_features", _stand_in)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.ones(4).sum()
    assert prof is not None
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    assert events
    with profiling.trace(str(tmp_path / "off"), enabled=False) as prof:
        pass
    assert prof is None and not (tmp_path / "off").exists()


def _jax_blob_videos(k, b, t, ss):
    """JAX's bench_gan --converge ``make_videos``, as written there."""
    grid = jnp.linspace(0.0, 1.0, ss)
    gy, gx = jnp.meshgrid(grid, grid, indexing="ij")
    ks = jax.random.split(k, 6)
    c0 = jax.random.uniform(ks[0], (b, 2), minval=0.25, maxval=0.75)
    vel = jax.random.uniform(ks[1], (b, 2), minval=-0.03, maxval=0.03)
    color = jax.random.uniform(ks[2], (b, 3), minval=0.3, maxval=1.0)
    tint = jax.random.uniform(ks[3], (b, 3), minval=-0.6, maxval=0.0)
    sign = jnp.sign(jax.random.normal(ks[4], (b, 3)))
    steps = jnp.arange(t, dtype=jnp.float32)[None, :, None]
    ctr = c0[:, None, :] + vel[:, None, :] * steps
    d2 = (gy[None, None] - ctr[..., 0:1, None]) ** 2 + (gx[None, None] - ctr[..., 1:2, None]) ** 2
    blob = jnp.exp(-d2 / (2 * 0.008))
    vids = (tint[:, None, None, None, :]
            + sign[:, None, None, None, :] * color[:, None, None, None, :] * blob[..., None])
    return jnp.clip(vids, -1.0, 1.0)


@pytest.mark.parametrize("i", [0, 7])
def test_blob_videos_equal_jax(i):
    b, t, ss = 2, 4, 16
    ref = np.asarray(_jax_blob_videos(jax.random.fold_in(jax.random.PRNGKey(21), i), b, t, ss))
    got = bench_gan.blob_videos(i, b, t, ss, CPU)["images"].numpy()
    assert got.shape == (b, t, ss, ss, 3)
    assert np.abs(got - ref).max() <= DRAW_TOL


@pytest.mark.parametrize("i", [0, 13])
def test_converge_batches_equal_jax(i):
    b, t, s = 2, 3, 8
    k1, k2_ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(11), i))
    ref = {"images": jax.random.normal(k1, (b, t, s, s, 3)),
           "poke": jax.random.normal(k2_, (b, s, s, 2))}
    got = bench_train.converge_batch(i, b, t, s, CPU)
    for k, v in ref.items():
        assert np.abs(got[k].numpy() - np.asarray(v)).max() <= DRAW_TOL, k


@pytest.mark.parametrize("trainer", [
    ["--stage2-trainer", "monolithic", "--enc-steps", "1", "--steps1", "1",
     "--distill-steps", "1", "--distill-hidden", "16", "--distill-depth", "1"],
    ["--stage2-trainer", "per-level", "--opt2", "adafactor", "--enc-steps", "0", "--steps1", "0"],
], ids=["monolithic_distill", "per_level_adafactor"])
def test_bench_e2e_runs_both_trainers(trainer, tmp_path, capsys, stand_in_features):
    signoff = tmp_path / "signoff.json"
    before = profiling.counts()
    out = bench_e2e.main(E2E_MICRO + ["--steps2", "2", "--eval-every", "1", "--out",
                                      str(tmp_path / "out"), "--signoff-out", str(signoff)]
                         + trainer)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == out
    assert E2E_KEYS <= set(out)
    assert out["steps"] == [0, 1, 2] and out["n_evals"] == 3 and len(out["fvd"]) == 3
    assert len(out["flow_loss_at_evals"]) == 2
    assert all(np.isfinite(v) for v in out["fvd"] + [out["fvd_recon_floor"]])
    assert out["sampling_calls"] == 3 and out["k2_launches"] == 0
    assert launches_since(before)["macow_unit_inverse"] == 0
    assert out["config"]["stage2_trainer"] == trainer[1]
    if "--distill-steps" in trainer:
        assert set(out["distill_signoff"]) == SIGNOFF_KEYS
        assert out["teacher_reverses"] == 1 and np.isfinite(out["distill_signoff"]["student_fvd"])
        assert json.loads(signoff.read_text())["distill_signoff"] == out["distill_signoff"]
    else:
        assert out["distill_signoff"] is None and not signoff.exists()
    assert (tmp_path / "out").is_dir() and any((tmp_path / "out").iterdir())


def test_bench_e2e_flagship_shape_at_factor_4_raises_as_jax(tmp_path):
    """z_dim 32 over 15 levels at factor 4: level 4 has no channels left."""
    jspec = JaxFlowSpec(num_steps=tuple(int(x) for x in FLAGSHIP_STEPS.split(",")),
                        in_channels=32, hidden_channels=16, h_channels=32, factor=4)
    assert jspec.level_channels()[4] == 0
    c, f = jspec.level_channels()[4], jspec.level_factors()[4]
    with pytest.raises(ZeroDivisionError):   # JAX's init of that level (levels 0-3 init fine)
        jax.eval_shape(lambda k: jmacow.init_level(k, 4, c, f, 1, jspec), jax.random.PRNGKey(0))
    with pytest.raises(ZeroDivisionError):
        bench_e2e.main(E2E_MICRO + ["--num-steps", FLAGSHIP_STEPS, "--z-dim", "32",
                                    "--enc-steps", "0", "--steps1", "0", "--steps2", "1",
                                    "--out", str(tmp_path)])


def test_bench_distill_flow_student_reports_fvd_star(monkeypatch, capsys, stand_in_features):
    entry = registry.ModelEntry("tiny_tools", "synthetic", 64, 16, 2, max_frames=3,
                                nf_max_cond=16, nf_max_poke=16, num_steps=(1, 1), factor=16)
    monkeypatch.setitem(registry.MODELS, "tiny_tools", entry)
    bench_distill.main(["--model", "tiny_tools", "--student", "flow", "--batch", "2",
                        "--steps", "1", "--eval-batches", "2", "--device", "cpu"])
    ev = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["final_eval"]
    assert ev["i3d_pretrained"] is False and np.isfinite(ev["fvd_star_teacher_vs_student"])
    assert ev["n_eval_batches"] == 2 and ev["fvd_star_teacher_vs_student"] > 0
