"""The work formulas and the FLOP counter against hand counts and the
figures the port's kernel table gives (C=32, B=8, hc=128, 8x8 latent)."""
import pytest
import torch

from portbench import flops, roofline, weights
from portbench.reference import sample


def test_k2_and_k1_work_at_c32_b8():
    f2, b2 = roofline.k2_work(8, 8, 32, 128)
    f1, b1 = roofline.k1_work(8, 8, 32, 128)
    assert round(f2 / 1e6, 1) == 142.1 and round(b2 / 1e6, 3) == 1.050
    assert round(f1 / 1e6, 1) == 35.5 and round(b1 / 1e6, 3) == 0.557
    ms, by = roofline.bound_ms(f2, b2)
    assert by == "operations" and round(ms, 5) == 0.00212
    assert round(roofline.bound_ms(f1, b1)[0], 5) == 0.00053


def test_mcf_flops_by_hand():
    # one row of 1 column, kernel 2x3 (one tap reaches it), C=1, hid=1, no h:
    # 2 rows: the second sees one row x one column of taps
    assert roofline.mcf_flops(1, 2, 1, 1, 1, 0) == 2 * 1 * 1 + 2 * 2 * 1 * 2 * 1


def test_least_time_sums_the_units():
    cfg = {"flow": {"num_steps": [2, 1], "factor": 4}, "first_stage": {"z_dim": 8}}
    chans = sample.level_channels(cfg)
    assert chans == [8, 6]
    want = 8 * roofline.bound_ms(*roofline.k2_work(4, 8, 8, 16))[0] \
        + 4 * roofline.bound_ms(*roofline.k2_work(4, 8, 6, 16))[0]
    assert roofline.mcf_least_ms(4, 8, 16, chans, [2, 1]) == pytest.approx(want)


def test_flop_counter_counts_a_conv_by_hand():
    x = torch.empty((2, 8, 8, 3), device="meta")
    w = torch.empty((5, 3, 3, 3), device="meta")
    with flops.FlopCounterMode(display=False) as fc:
        sample.nn.conv2d(x, w, padding=1)
    assert fc.get_total_flops() == 2 * (2 * 8 * 8) * 5 * (3 * 3 * 3)


def test_sample_call_counts_the_mcf_inverses_by_formula(tiny):
    _, pkg = tiny
    import json
    cfg = json.loads((pkg / "configs" / "tiny.json").read_text())
    total = flops.sample_call(cfg, 2, 2, 3)
    b, s, hc = 4, 4, 32
    mcf = sum(4 * 4 * n * roofline.k1_work(b, s, c, hc)[0]
              for c, n in zip(sample.level_channels(cfg), cfg["flow"]["num_steps"]))
    assert total > mcf > 0
    assert weights.count(weights.second_stage_tree(cfg)) > 0


def test_gan_step_counts_forward_and_backward(tiny):
    _, pkg = tiny
    import json
    cfg = json.loads((pkg / "configs" / "tiny.json").read_text())
    tcfg = json.loads((pkg / "traffic" / "tiny.gan.json").read_text())
    step = flops.gan_step(cfg, tcfg)
    assert step > 0
