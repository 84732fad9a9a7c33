"""The port's serving artifact (``serve/artifact.py``), the batcher over it,
and the custom ops ``ipoke::mcf_inverse`` / ``ipoke::macow_unit_inverse``,
against the JAX package on the CPU.

The model is tests/test_serve_artifact.py's tiny second stage (two flow
levels of one step, 64x64, 4 frames), drawn by the port's ``init`` (JAX's
numbers) with the flow's output gains set non-zero, on the default backend
``'cuda_unit'``.  One flow artifact and one direct-student artifact with the
u8 wire are exported (bucket 2 each; an export and a load take seconds
here) and loaded once for the whole file.

* The loaded flow artifact equals the live ``forward_sample`` bitwise (the
  same aten ops on the same CPU) and JAX's ``forward_sample`` within 2e-4;
  its graph holds one ``ipoke::macow_unit_inverse`` node per MaCowUnit.
* ``params.npz`` equals, key for key and bitwise, what JAX's ``ckpt/io.save``
  writes for the canonical tree, as JAX's ``export_sampler`` saves it.
* ``draw_z`` within 7.2e-7 of JAX's draw (``utils/prng``'s bound).
* ``SampleBatcher.from_artifact`` guards as JAX's does; an artifact is
  refused on another device type; ``torch.library.opcheck`` on both ops.
"""
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipoke_tpu.ckpt import io as jio
from ipoke_tpu.models import second_stage as jss
from ipoke_tpu.serve.artifact import _canonicalize
from ipoke_tpu_torch.ckpt.jax_bridge import unbridge_direct, unbridge_second_stage
from ipoke_tpu_torch.models import second_stage
from ipoke_tpu_torch.ops.cuda import mcf_inverse as k1
from ipoke_tpu_torch.ops.cuda import mcf_unit_inverse as k2
from ipoke_tpu_torch.serve import artifact
from ipoke_tpu_torch.serve.batcher import BatcherConfig, SampleBatcher
from ipoke_tpu_torch.train import distill
from ipoke_tpu_torch.utils import prng, synth
from test_serve_artifact import _spec as jax_artifact_spec
from torch_port_util import CPU, jit_o0, port_second_stage_spec, t

S, T, BUCKET = 64, 4, 2
SAMPLE_TOL = 2e-4
DRAW_TOL = 7.2e-7


@pytest.fixture(scope="module")
def arts(tmp_path_factory):
    jspec = jax_artifact_spec()
    spec = port_second_stage_spec(jspec, mcf_backend="cuda_unit")
    pt = second_stage.init(prng.prng_key(0), spec, device=CPU)
    pt["flow"] = synth.set_flow_output_gains(pt["flow"], 0.05)
    ds = distill.DirectStudentSpec(hidden=32, depth=2)
    sp = distill.init_direct(prng.prng_key(5), spec, ds, CPU)
    root = tmp_path_factory.mktemp("art")
    artifact.export_sampler(pt, spec, root / "flow", buckets=(BUCKET,))
    artifact.export_sampler(pt, spec, root / "student", buckets=(BUCKET,), student=(sp, ds),
                            wire_u8=True)
    rng = np.random.default_rng(3)
    inputs = (rng.uniform(-1, 1, (BUCKET, S, S, 3)).astype(np.float32),
              rng.standard_normal((BUCKET, S, S, 2)).astype(np.float32),
              rng.standard_normal((BUCKET, 8, 8, 16)).astype(np.float32))
    return {"root": root, "spec": spec, "jspec": jspec, "pt": pt, "ds": ds, "sp": sp,
            "flow": artifact.load_artifact(root / "flow", CPU),
            "student": artifact.load_artifact(root / "student", CPU), "inputs": inputs}


def _live(a, student):
    x0, poke, z = (t(v) for v in a["inputs"])
    batch = {"images": x0[:, None], "poke": poke}
    if student:
        return distill.forward_sample_student(a["pt"], a["sp"], a["ds"], a["spec"], batch,
                                              length=T - 1, add_first_frame=True, z=z)[0]
    return second_stage.forward_sample(a["pt"], a["spec"], batch, length=T - 1,
                                       add_first_frame=True, z=z)[0]


def test_manifest_and_files(arts):
    for kind, sampler, wire in (("flow", "flow", "f32"), ("student", "direct_student", "u8")):
        art = arts[kind]
        m = json.loads((arts["root"] / kind / "manifest.json").read_text())
        assert (m["format_version"], m["sampler"], m["wire"]) == (1, sampler, wire)
        assert art.buckets == m["buckets"] == [BUCKET] and art.length == m["length"] == T - 1
        assert art.x0_shape == (S, S, 3) and art.poke_shape == (S, S, 2)
        assert art.z_shape == artifact.z_shape_of(arts["spec"]) == (8, 8, 16)
        assert m["device"] == "cpu" and m["torch_version"] == torch.__version__
        assert sorted(p.name for p in (arts["root"] / kind).iterdir()) == [
            "manifest.json", "params.npz", f"sampler_b{BUCKET}.pt2"]


def test_flow_graph_holds_one_k2_node_per_unit(arts):
    targets = [str(n.target) for n in arts["flow"].programs[BUCKET].graph.nodes
               if n.op == "call_function"]
    units = 4 * sum(arts["spec"].flow.num_steps)
    assert sum("ipoke.macow_unit_inverse" in x for x in targets) == units == 8
    assert not any("ipoke.mcf_inverse" in x for x in targets)
    assert not any("ipoke" in str(n.target) for n in arts["student"].programs[BUCKET].graph.nodes)
    for art in (arts["flow"], arts["student"]):   # the params are inputs, not in the file
        ep = art.programs[BUCKET]
        assert ep.example_inputs is None and not ep.state_dict and not ep.constants


def test_flow_artifact_matches_live_and_jax(arts):
    art = arts["flow"]
    x0, poke, z = (t(v) for v in arts["inputs"])
    got = art.run(art.params, x0, poke, z)
    live = _live(arts, student=False)
    assert got.shape == (BUCKET, T, S, S, 3) and torch.isfinite(got).all()
    assert torch.equal(got, live)
    jx0, jpoke, jz = (jnp.asarray(v) for v in arts["inputs"])
    pj = jax.tree_util.tree_map(jnp.asarray, unbridge_second_stage(arts["pt"], arts["spec"]))
    ref = jit_o0(lambda p, a, b, c: jss.forward_sample(
        p, arts["jspec"], {"images": a[:, None], "poke": b}, None, length=T - 1,
        add_first_frame=True, z=c)[0])(pj, jx0, jpoke, jz)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=SAMPLE_TOL, atol=SAMPLE_TOL)


def test_student_artifact_u8_matches_live(arts):
    art = arts["student"]
    x0, poke, z = (t(v) for v in arts["inputs"])
    got = art.run(art.params, x0, poke, z)
    live = _live(arts, student=True)
    assert got.dtype == torch.uint8 and got.shape == (BUCKET, T, S, S, 3)
    # float -> uint8 truncates, as JAX's astype does
    assert torch.equal(got, ((live + 1.0) * 127.5).clamp(0.0, 255.0).to(torch.uint8))
    assert int(got.max()) > int(got.min())


def _flat_npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def test_params_npz_matches_jax_save(arts, tmp_path):
    """The canonical trees of JAX's export_sampler: the second stage's, and
    for a student ``{'base': without the flow, 'student': ...}``."""
    base = unbridge_second_stage(arts["pt"], arts["spec"])
    trees = {"flow": base,
             "student": {"base": {k: v for k, v in base.items() if k != "flow"},
                         "student": unbridge_direct(arts["sp"])}}
    for kind, tree in trees.items():
        ref = str(tmp_path / f"{kind}.npz")
        jio.save(ref, _canonicalize(jax.tree_util.tree_map(jnp.asarray, tree)))
        want, got = _flat_npz(ref), _flat_npz(arts["root"] / kind / "params.npz")
        assert got.keys() == want.keys() and len(got) > 100
        for k, v in want.items():
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), (kind, k)


def test_draw_z_matches_jax(arts):
    seeds = [0, 7, 2**32 - 1]
    got = arts["flow"].draw_z(seeds).numpy()
    ref = np.stack([np.asarray(jax.random.normal(jax.random.PRNGKey(np.uint32(s)), (8, 8, 16)))
                    for s in seeds])
    assert got.shape == ref.shape and float(np.abs(got - ref).max()) <= DRAW_TOL


def test_sample_convenience_and_bad_bucket(arts):
    art = arts["flow"]
    vid = art.sample(np.zeros((S, S, 3), np.float32), np.zeros((S, S, 2), np.float32), seed=5)
    assert vid.shape == (T, S, S, 3) and np.isfinite(vid).all()
    x0, poke, z = (t(v) for v in arts["inputs"])
    with pytest.raises(ValueError, match="bucket"):
        art.run(art.params, x0[:1], poke[:1], z[:1])


def test_batcher_from_artifact_guards_and_serves(arts):
    flow, student = arts["flow"], arts["student"]
    with pytest.raises(ValueError, match="max_batch"):
        SampleBatcher.from_artifact(flow, BatcherConfig(max_batch=1))
    with pytest.raises(ValueError, match="length"):
        SampleBatcher.from_artifact(flow, BatcherConfig(length=T))
    with pytest.raises(ValueError, match="wire_u8"):
        SampleBatcher.from_artifact(flow, BatcherConfig(wire_u8=True))
    b = SampleBatcher.from_artifact(flow, BatcherConfig(max_batch=8, max_delay_ms=1.0))
    try:
        assert b.buckets == [BUCKET] and b.cfg.max_batch == BUCKET   # clamped
        x0, poke, _ = arts["inputs"]
        vid = b.submit(x0[0], poke[0], seed=11, timeout=120)
        z = prng.normal_for_seeds([11, 11], flow.z_shape)
        want = flow.run(flow.params, t(x0[:1]).repeat(2, 1, 1, 1), t(poke[:1]).repeat(2, 1, 1, 1), z)
        assert np.array_equal(vid, want[0].numpy())
    finally:
        b.close()
    b = SampleBatcher.from_artifact(student, BatcherConfig(wire_u8=True))
    b.close()


def test_artifact_is_refused_on_another_device(arts, tmp_path):
    with pytest.raises(ValueError, match="exported for cpu"):
        artifact.load_artifact(arts["root"] / "student", "cuda")
    shutil.copytree(arts["root"] / "student", tmp_path / "a")
    m = json.loads((tmp_path / "a" / "manifest.json").read_text())
    (tmp_path / "a" / "manifest.json").write_text(json.dumps(dict(m, device="cuda")))
    with pytest.raises(ValueError, match="exported for cuda"):
        artifact.load_artifact(tmp_path / "a", "cpu")


def test_verify_cli(arts, capsys, monkeypatch):
    loaded = []

    def load(path, device):   # the fixture's artifact: a load takes seconds here
        loaded.append((str(path), str(device)))
        return arts["student"]

    monkeypatch.setattr(artifact, "load_artifact", load)
    artifact.main(["verify", "--dir", str(arts["root"] / "student"), "--device", "cpu"])
    assert loaded == [(str(arts["root"] / "student"), "cpu")]
    assert "artifact ok" in capsys.readouterr().out


def _tiny_mcf(g, c=4, hc=8):
    hid = 4 * c
    z, h = torch.randn(2, 8, 8, c, generator=g), torch.randn(2, 8, 8, hc, generator=g)
    w1 = 0.1 * torch.randn(2 * c, hid + hc, generator=g)
    return z, h, 0.1 * torch.randn(hid, c, 2, 3, generator=g), w1, 0.1 * torch.randn(2 * c, generator=g)


@pytest.mark.parametrize("op", ["mcf_inverse", "macow_unit_inverse"])
def test_custom_ops_pass_opcheck(op):
    g = torch.Generator().manual_seed(0)
    z, h, w, w1, b1 = _tiny_mcf(g)
    if op == "mcf_inverse":
        args = (z, h, [w, w1, b1], "B", 0.7, "elu", None)
        plain = k1.mcf_inverse_plain(z, h, w, w1, b1, "B", 0.7)
    else:
        wt = w.transpose(2, 3).contiguous()
        weights = [(w, w1, b1), (w, w1, b1), (wt, w1, b1), (wt, w1, b1)]
        an = [0.1 * torch.randn(2, 4, generator=g) for _ in range(2)]
        args = (z, h, [x for ws in weights for x in ws], *an, 0.7, "elu", None)
        plain = k2.macow_unit_inverse_plain(z, h, weights, *an, 0.7)
    torch.library.opcheck(getattr(torch.ops.ipoke, op).default, args)
    assert torch.equal(getattr(torch.ops.ipoke, op)(*args), plain)   # the CPU implementation
