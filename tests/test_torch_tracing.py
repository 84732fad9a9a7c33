"""The port's tracing facility (``ipoke_tpu_torch/utils/profiling.py``) on
the CPU, against the port alone:

* spans off: ``span`` is the shared null context, a sampling call under a
  CPU profiler records no span;
* spans on: the same call records every span of the sampling path, nested
  as the code nests them (one ``flow.level.<k>`` per level), and returns
  the same videos bit for bit;
* the stage-1 GAN step records ``gan.step`` around its five phases, in
  order, and still calls ``on_phase``;
* ``trace`` exports a Chrome trace that holds the spans;
* counters: snapshots difference, CPU tensors launch no MCF kernel, a
  sampling call counts one call;
* an exported graph holds no span.
"""
import json
from dataclasses import replace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ipoke_tpu_torch import registry
from ipoke_tpu_torch.models import discriminators as D
from ipoke_tpu_torch.models import first_stage as fs_mod
from ipoke_tpu_torch.models import second_stage
from ipoke_tpu_torch.ops.cuda import launches_since
from ipoke_tpu_torch.train import first_stage as tfs
from ipoke_tpu_torch.utils import prng, profiling, synth
from torch_port_util import CPU, GAN_BATCH, gan_specs

TINY = registry.ModelEntry("tiny_tracing", "synthetic", 64, 16, 2, max_frames=3, nf_max_cond=16,
                           nf_max_poke=16, num_steps=(1, 1), factor=16)
SAMPLE_SPANS = ("second_stage.forward_sample", "second_stage.embed_cond", "flow.reverse",
                "flow.level.1", "flow.level.0", "first_stage.decode")
# each span and the span open around it
SAMPLE_PARENTS = {"second_stage.embed_cond": "second_stage.forward_sample",
                  "flow.reverse": "second_stage.forward_sample",
                  "flow.level.0": "flow.reverse", "flow.level.1": "flow.reverse",
                  "first_stage.decode": "second_stage.forward_sample"}
GAN_PHASES = ("gan.plan", "gan.gen_forward", "gan.dt", "gan.ds", "gan.gen")


def _spans(prof):
    """[(name, start_ns, end_ns)] of the profiled block's spans, by start."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _parent(spans, child):
    """The innermost span that holds ``child``'s interval, or None."""
    around = [s for s in spans if s is not child and s[1] <= child[1] and child[2] <= s[2]]
    return min(around, key=lambda s: s[2] - s[1])[0] if around else None


@pytest.fixture(scope="module")
def tiny_sampler():
    """``call(backend='cuda_unit')``: one sampling call of the tiny second
    stage with its MCF inverses on ``backend``."""
    spec = registry.build_specs(TINY)
    params = synth.synth_params(spec, seed=0, device=CPU)   # a tenth of init's draws' time
    g = torch.Generator().manual_seed(0)
    batch = {"images": torch.rand((1, 3, 64, 64, 3), generator=g) * 2 - 1,
             "poke": torch.randn((1, 64, 64, 2), generator=g)}

    def call(backend="cuda_unit"):
        s = replace(spec, flow=replace(spec.flow, mcf_backend=backend))
        return second_stage.forward_sample(params, s, batch, prng.prng_key(1))

    return call


def test_span_is_the_shared_null_context_while_spans_are_off():
    assert profiling.span("a") is profiling.span("b")
    with profiling.spans():
        assert profiling.span("a") is not profiling.span("a")
        with profiling.spans(False):
            assert profiling.span("a") is profiling.span("b")
        assert profiling.span("a") is not profiling.span("b")
    assert profiling.span("a") is profiling.span("b")


def test_sampling_call_with_spans_off_records_no_span(tiny_sampler):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tiny_sampler()
    assert _spans(prof) == []


def test_sampling_call_with_spans_on_records_each_span_nested(tiny_sampler):
    off = tiny_sampler()
    with profile(activities=[ProfilerActivity.CPU]) as prof, profiling.spans():
        on = tiny_sampler()
    assert torch.equal(on, off)
    spans = _spans(prof)
    assert [s[0] for s in spans] == list(SAMPLE_SPANS)
    assert {s[0]: _parent(spans, s) for s in spans} == dict(
        SAMPLE_PARENTS, **{"second_stage.forward_sample": None})


def test_gan_step_records_its_phases_in_order_and_calls_on_phase():
    fs, ds, dt = gan_specs(fs_mod, D, gp_weight=0.0)   # no double backward: half the CPU time
    state, opts = tfs.init_gan_state(prng.prng_key(0), fs, ds, dt, device=CPU)
    step = tfs.make_gan_train_step(fs, ds, dt, opts)
    x = torch.rand((GAN_BATCH, fs.max_frames, fs.spatial_size, fs.spatial_size, 3),
                   generator=torch.Generator().manual_seed(1)) * 2 - 1
    phases = []
    with profile(activities=[ProfilerActivity.CPU]) as prof, profiling.spans():
        step(state, {"images": x}, prng.prng_key(2), phases.append)
    assert phases == ["dt", "ds", "gen"]
    spans = _spans(prof)
    top = [s for s in spans if _parent(spans, s) == "gan.step"]
    assert [s[0] for s in spans][0] == "gan.step" and [s[0] for s in top] == list(GAN_PHASES)
    assert all(a[2] <= b[1] for a, b in zip(top, top[1:]))   # one after the other
    # the generator's forward decodes in gan.gen_forward and again in gan.gen
    decodes = [_parent(spans, s) for s in spans if s[0] == "first_stage.decode"]
    assert decodes == ["gan.gen_forward", "gan.gen"]


def test_trace_exports_the_spans(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.span("outer"):
            with profiling.span("inner"):
                torch.ones(4).sum()
    assert profiling.span("outer") is profiling.span("x")   # spans off again after the block
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events if e.get("cat") == "user_annotation"}
    assert {"outer", "inner"} <= names


def test_counts_snapshots_difference():
    before = profiling.counts()
    profiling.count("tracing_test.a")
    profiling.count("tracing_test.a", 4)
    profiling.count("tracing_test.b", 2)
    mid = profiling.counts()
    profiling.count("tracing_test.b")
    after = profiling.counts()
    mid["tracing_test.a"] = -1   # a copy: the counters do not change
    assert after["tracing_test.a"] - before.get("tracing_test.a", 0) == 5
    assert after["tracing_test.b"] - before.get("tracing_test.b", 0) == 3
    assert profiling.counts()["tracing_test.a"] == after["tracing_test.a"]


@pytest.mark.parametrize("backend", ["cuda_unit", "cuda"])
def test_cpu_tensors_launch_no_mcf_kernel(tiny_sampler, backend):
    """On CPU tensors K2 ('cuda_unit') and K1 ('cuda') take their plain
    versions; the call itself is counted."""
    before = profiling.counts()
    tiny_sampler(backend)
    assert launches_since(before) == {"mcf_inverse": 0, "macow_unit_inverse": 0}
    assert profiling.counts()["second_stage.calls"] - before.get("second_stage.calls", 0) == 1


def test_exported_graph_holds_no_span():
    class Sampler(torch.nn.Module):
        def forward(self, x):
            with profiling.span("exported"):
                return x * 2 + 1

    with profiling.spans():
        ep = torch.export.export(Sampler(), (torch.ones(3),), strict=False)
    targets = [str(n.target) for n in ep.graph.nodes]
    assert not any("record_function" in t or "profiler" in t for t in targets), targets
    assert torch.equal(ep.module()(torch.ones(3)), torch.full((3,), 3.0))
