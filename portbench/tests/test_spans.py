"""The span window (``portbench/spans.py``): its reading of a trace on
synthetic events, its readers and the MCF launch count's, whole traced
CPU runs at the tiny cells, and ``profile_cell`` there."""
import math

import pytest
import torch
from torch.autograd import DeviceType

from portbench import layout, run, spans

MS = 1_000_000   # ns
SEED = 2**31 + 11
# read from the MCF kernels' names or from CUDA events: nothing to read on the CPU
CARD_ONLY = {"mcf_roofline_pct", "gan_disc_ms", "gan_gen_ms"}


class Ev:
    """A profiler event as ``summarize`` reads it (times in ms)."""

    def __init__(self, name, start, end, tid=1, corr=0, device=False, annotation=False):
        self._v = (name, int(start * MS), int((end - start) * MS), tid, corr, device, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def start_thread_id(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def device_type(self):
        return DeviceType.CUDA if self._v[5] else DeviceType.CPU

    def is_user_annotation(self):
        return self._v[6]


def span(name, start, end, tid=1):
    return Ev(name, start, end, tid, annotation=True)


def launch(corr, at, start, end, tid=1):
    """A runtime launch at ``at`` on thread ``tid`` and its kernel [start, end]."""
    return [Ev("cudaLaunchKernel", at, at + 0.01, tid, corr),
            Ev("kernel", start, end, 1, corr, device=True)]


def test_a_kernel_in_a_level_counts_toward_the_flow_reverse():
    events = [span(spans.WINDOW, 0, 1000), span("second_stage.forward_sample", 0, 900),
              span("flow.reverse", 100, 600), span("flow.level.3", 200, 400),
              *launch(7, 250, 300, 500)]
    sw = spans.summarize(events, 1)
    for name in ("flow.level.3", "flow.reverse", "second_stage.forward_sample"):
        assert sw["spans"][name]["device_ms"] == pytest.approx(200), name
    assert sw["busy_ms"] == pytest.approx(200) and sw["harness_ms"] == 0


def test_a_launch_from_a_second_thread_counts_toward_the_open_span():
    events = [span(spans.WINDOW, 0, 1000), span("gan.step", 0, 900), span("gan.dt", 100, 500),
              span("gan.ds", 500, 800), *launch(3, 200, 210, 300, tid=2),
              *launch(4, 600, 610, 640, tid=2)]
    sw = spans.summarize(events, 1)
    assert sw["spans"]["gan.dt"]["device_ms"] == pytest.approx(90)
    assert sw["spans"]["gan.ds"]["device_ms"] == pytest.approx(30)
    assert sw["spans"]["gan.step"]["device_ms"] == pytest.approx(120)


def test_gpu_side_annotations_are_neither_busy_time_nor_device_ops():
    events = [span(spans.WINDOW, 0, 1000), span("gan.dt", 100, 500),
              Ev("gan.dt", 150, 700, corr=2, device=True, annotation=True),
              *launch(5, 200, 300, 400)]
    sw = spans.summarize(events, 1)
    assert sw["device_ops"] == 1 and sw["busy_ms"] == pytest.approx(100)
    assert sw["idle_ms"] == pytest.approx(900)


def test_an_idle_gap_splits_by_the_spans_open_on_the_calling_thread():
    events = [span(spans.WINDOW, 0, 300), span("gan.plan", 0, 100), span("gan.dt", 100, 200, tid=2),
              *launch(1, 195, 200, 300)]
    sw = spans.summarize(events, 1)
    assert sw["idle_by_span"] == pytest.approx({"gan.plan": 100, spans.HARNESS: 100})
    assert sw["spans"]["gan.plan"]["idle_ms"] == pytest.approx(100)
    assert sw["spans"]["gan.dt"]["idle_ms"] == 0   # another thread's span takes no idle time


def test_idle_gaps_are_placed_by_their_launches_when_the_clocks_drift():
    """The device's stamps run 80 ms ahead of the host's: the kernels
    launched at 100 and 200 host ms, 50 ms each, read [180, 230] and
    [280, 330].  Each gap lies before the launch that ends it."""
    events = [span(spans.WINDOW, 0, 300), span("gan.plan", 0, 100), span("gan.gen", 100, 300),
              *launch(1, 100, 180, 230), *launch(2, 200, 280, 330)]
    sw = spans.summarize(events, 1)
    assert sw["busy_ms"] == pytest.approx(100) and sw["idle_ms"] == pytest.approx(200)
    assert sw["idle_by_span"] == pytest.approx({"gan.plan": 100, "gan.gen": 100})
    assert sw["spans"]["gan.gen"]["device_ms"] == pytest.approx(100)


def test_a_kernel_with_no_launch_in_the_trace_is_unlinked():
    events = [span(spans.WINDOW, 0, 100), span("flow.reverse", 0, 100),
              Ev("kernel", 10, 30, corr=99, device=True), *launch(2, 40, 50, 60)]
    sw = spans.summarize(events, 2)
    assert sw["unlinked_ms"] == pytest.approx(10) and sw["spans"]["flow.reverse"]["device_ms"] == 5
    rows = {r[0]: r for r in spans.breakdown(sw)["spans"]}
    assert rows[spans.UNLINKED][3] == pytest.approx(10) and rows["flow.reverse"][1] == 0.5


def test_nested_spans_give_the_innermost_and_the_rest_to_the_harness():
    events = [span(spans.WINDOW, 0, 100), span("a", 10, 90), span("b", 20, 40), span("c", 50, 60)]
    sw = spans.summarize(events, 1)
    assert sw["idle_by_span"] == pytest.approx({"a": 50, "b": 20, "c": 10, spans.HARNESS: 20})
    assert sw["spans"]["a"]["idle_ms"] == pytest.approx(80)
    assert sw["spans"]["a"]["host_ms"] == pytest.approx(80) and sw["window_ms"] == 100


def test_no_window_without_the_ports_spans(monkeypatch):
    from ipoke_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "spans")
    assert spans.window(lambda: None, 1, torch.device("cpu")) is None


SPAN_METRICS = [(kind, m) for kind, ms in spans.SPAN_METRICS.items() for m in ms]


@pytest.mark.parametrize("kind,name", SPAN_METRICS, ids=[m for _, m in SPAN_METRICS])
def test_readers_return_none_for_the_other_kind_and_without_a_window(kind, name):
    sw = spans.summarize([span(spans.WINDOW, 0, 10)], 1)
    reader = layout.metric(name)
    kind = "train" if kind == "gan" else kind
    other = "train" if kind == "sample" else "sample"
    assert reader.read({"kind": other, "span_window": sw}) is None
    assert reader.read({"kind": kind}) is None


def test_mcf_launches_per_call_reads_the_ports_counters(monkeypatch):
    from ipoke_tpu_torch.utils import profiling
    reader = layout.metric("mcf_launches_per_call")
    counts = {"second_stage.calls": 4, "mcf.k1_launches": 8, "mcf.k2_launches": 800}
    monkeypatch.setattr(profiling, "counts", lambda: dict(counts))
    assert reader.read({"kind": "sample"}) == 202
    assert reader.read({"kind": "train"}) is None
    counts["second_stage.calls"] = 0
    assert reader.read({"kind": "sample"}) is None
    monkeypatch.delattr(profiling, "counts")   # a port without counters
    assert reader.read({"kind": "sample"}) is None


@pytest.mark.parametrize("cell", ["tiny.sample", "tiny.gan"])
def test_traced_run_reports_every_metric_of_its_cell(tiny, monkeypatch, cell):
    """A traced run reports every per-layer metric of its cell; a port
    without counters (as before them) reports all but the MCF launch count.
    On the CPU the metrics of the card alone find nothing to read
    (``CARD_ONLY``)."""
    from ipoke_tpu_torch.utils import profiling
    root, pkg = tiny
    lines = {}
    for side in ("counters", "no_counters"):
        with monkeypatch.context() as m:
            if side == "no_counters":
                m.delattr(profiling, "counts")
            lines[side] = run.run_cell(cell, SEED, 0.3, True, torch.device("cpu"), pkg=pkg,
                                       root=root)
        assert lines[side]["correct"] is True
    bench = layout.benchmark(root)
    want = {m["name"] for m in bench["per_layer"] if layout.applies(m, cell)}
    line, before = lines["counters"], lines["no_counters"]
    assert set(line["metrics"]) == want - CARD_ONLY
    assert set(before["metrics"]) == set(line["metrics"]) - {"mcf_launches_per_call"}
    assert all(math.isfinite(m["value"]) and m["value"] >= 0 for m in line["metrics"].values())
    if cell == "tiny.sample":
        assert line["metrics"]["mcf_launches_per_call"]["value"] == 0   # CPU tensors launch nothing


@pytest.mark.parametrize("cell", ["tiny.sample", "tiny.gan"])
def test_profile_cell_reports_the_span_metrics_of_its_cell(tiny, monkeypatch, cell):
    """``profile_cell`` reads every span metric of its cell's kind, finite
    and not negative, with each span of the path in its breakdown; a port
    without spans gives None."""
    from ipoke_tpu_torch.utils import profiling
    _, pkg = tiny
    out = spans.profile_cell(cell, SEED, torch.device("cpu"), pkg=pkg)
    kind = layout.traffic(layout.cell(cell, pkg)["traffic"], pkg)["kind"]
    want = set(spans.SPAN_METRICS[kind]) | ({"mcf_launches_per_call"} if kind == "sample" else set())
    assert set(out["metrics"]) == want
    assert all(math.isfinite(v) and v >= 0 for v in out["metrics"].values())
    assert out["traced_ms_per_unit"] > 0 and out["span_window"]["window_ms"] > 0
    names = {r[0] for r in out["breakdown"]["spans"]}
    if kind == "sample":
        assert {"second_stage.forward_sample", "second_stage.embed_cond", "flow.reverse",
                "flow.level.0", "flow.level.1", "first_stage.decode"} <= names
    else:
        assert {"gan.step", "gan.plan", "gan.gen_forward", "gan.dt", "gan.ds", "gan.gen"} <= names
    assert out["breakdown"]["idle_by_span"]
    monkeypatch.delattr(profiling, "spans")
    assert spans.profile_cell(cell, SEED, torch.device("cpu"), pkg=pkg) is None
