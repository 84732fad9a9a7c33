"""The end-to-end two-stage quality loop on the CUDA card, weights-free (the
port's counterpart of ``ipoke_tpu/utils/bench_e2e.py``).

Trains the whole product from scratch on the synthetic procedural videos
and shows whether the evaluation metric falls over stage-2 training:

  1. the poke encoder and the image conditioner (``train/encoders``),
  2. a small stage-1 cVAE-GAN (``train/first_stage``, the 3-optimizer step),
  3. everything frozen (spectral norm materialised), the stage-2 cINN from
     a fresh init, on the one-graph step or the per-level trainer
     (``train/chunked``), with ``make_optimizer`` or ``adafactor``,
  4. every ``--eval-every`` steps: videos sampled on a FIXED eval set (the
     val split's first ``--n-eval`` examples, keys from
     ``split(prng_key(1234))``) and FVD* against the real ones (seeded I3D
     without weights, so the score is relative: the fresh-init score at
     step 0 is the control, the frozen stage-1's reconstruction FVD*, keys
     from ``prng_key(4321)``, the floor);
  5. optionally (``--distill-steps``) a direct student distilled from the
     trained teacher, signed off by its FVD* on the same eval set and keys.

The flow samples on ``'cuda_unit'``: every evaluation's ``forward_sample``
and each distillation step's teacher reverse run kernel K2 on the card (its
plain version only on CPU tensors).  Prints JAX's one JSON line (the steps
-> FVD* curve, the floor, the sign-off) with the card's name and power
limit and K2's launches; progress goes to stderr.

    python -m ipoke_tpu_torch.utils.bench_e2e [--size 64] [--steps1 600] \\
        [--steps2 2000] [--enc-steps 200] [--eval-every 500] [--n-eval 64] \\
        [--stage2-trainer monolithic|per-level] [--opt2 adam|adafactor] \\
        [--distill-steps N] [--signoff-out JSON]

JAX's flagship-shaped suggestion (``--num-steps 10,5,5,4,4,4,3,3,3,2,2,2,1,1,1
--z-dim 32``) needs ``--flow-factor 16``: at the default factor 4 the levels
run out of channels (32, 24, ..., 0, -8, ...) and the flow's init raises
ZeroDivisionError, as JAX's does.  ``--device cpu`` runs the loop on the CPU,
only when asked.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from ipoke_tpu_torch import resolve_device
from ipoke_tpu_torch.data.datamodule import StaticDataModule
from ipoke_tpu_torch.data.loader import to_device
from ipoke_tpu_torch.flows import macow, transformer
from ipoke_tpu_torch.flows.macow import FlowSpec
from ipoke_tpu_torch.metrics.fvd import FVDAccumulator
from ipoke_tpu_torch.models import encoders as enc_model
from ipoke_tpu_torch.models import first_stage as fs_model
from ipoke_tpu_torch.models import second_stage as ss_model
from ipoke_tpu_torch.models.discriminators import PatchDiscSpec, TempDiscSpec
from ipoke_tpu_torch.models.encoders import WrapperSpec
from ipoke_tpu_torch.models.first_stage import FirstStageSpec
from ipoke_tpu_torch.models.second_stage import SecondStageSpec
from ipoke_tpu_torch.ops.cuda import launches_since
from ipoke_tpu_torch.train import chunked
from ipoke_tpu_torch.train import distill as tdist
from ipoke_tpu_torch.train import encoders as tenc
from ipoke_tpu_torch.train import first_stage as tfs
from ipoke_tpu_torch.train import second_stage as tss
from ipoke_tpu_torch.utils import prng, profiling
from ipoke_tpu_torch.utils import video as vid_util

T0 = time.time()


def log(msg):
    print(f"[bench_e2e +{time.time() - T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ipoke_tpu_torch.utils.bench_e2e")
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--z-dim", type=int, default=16)
    ap.add_argument("--nf-max", type=int, default=32)
    ap.add_argument("--enc-steps", type=int, default=200)
    ap.add_argument("--steps1", type=int, default=600)
    ap.add_argument("--steps2", type=int, default=2000)
    ap.add_argument("--eval-every", type=int, default=500)
    ap.add_argument("--n-eval", type=int, default=64)
    ap.add_argument("--n-train", type=int, default=128)
    ap.add_argument("--lr2", type=float, default=1e-3)
    ap.add_argument("--out", default="logs/bench_e2e")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num-steps", default="4,4", help="comma-separated MaCow steps per flow level")
    ap.add_argument("--flow-hidden", type=int, default=64)
    ap.add_argument("--flow-factor", type=int, default=4)
    ap.add_argument("--gan-remat", default="none", choices=["none", "outer", "decode", "both"],
                    help="stage-1 generator remat (train/first_stage.make_gan_train_step)")
    ap.add_argument("--vgg-chunks", type=int, default=1)
    ap.add_argument("--stage2-trainer", default="monolithic", choices=["monolithic", "per-level"],
                    help="per-level: train/chunked.make_per_level_trainer")
    ap.add_argument("--opt2", default="adam", choices=["adam", "adafactor"],
                    help="the per-level trainer's optimizer: make_optimizer or adafactor")
    ap.add_argument("--distill-steps", type=int, default=0)
    ap.add_argument("--distill-hidden", type=int, default=256)
    ap.add_argument("--distill-depth", type=int, default=6)
    ap.add_argument("--distill-lr", type=float, default=1e-3)
    ap.add_argument("--signoff-out", default=None, metavar="JSON",
                    help="also write {'distill_signoff': ...} here")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' only when asked)")
    return ap.parse_args(argv)


def build_spec(args):
    """The SecondStageSpec of the loop: towers and first stage at the
    loop's width, the flow on ``'cuda_unit'`` (K2)."""
    S, nf = args.size, args.nf_max
    # tower depth follows the registry rule: 128^2 needs one more decoder
    # stage than 64^2 to reach full resolution from the 8x8 motion latent
    enc_ch = (32, 64, 64, 64, 64) if S >= 128 else (32, 64, 64, 64)
    dec_ch = (64, 64, 64, 48, 32) if S >= 128 else (64, 64, 48, 32)
    fs_spec = FirstStageSpec(z_dim=args.z_dim, spatial_size=S, max_frames=args.frames,
                             enc_channels=enc_ch, dec_channels=dec_ch, n_gru_layers=2,
                             min_spatial_size=8, motion_bias=True, full_sequence=True)
    poke_spec = WrapperSpec(nf_in=2, nf_max=nf, spatial_size=S, min_spatial_size=8,
                            deterministic=True)
    cond_spec = WrapperSpec(nf_in=3, nf_max=nf, spatial_size=S, min_spatial_size=8,
                            deterministic=False)
    flow_spec = FlowSpec(num_steps=tuple(int(x) for x in args.num_steps.split(",")),
                         in_channels=args.z_dim, hidden_channels=args.flow_hidden,
                         h_channels=2 * nf, factor=args.flow_factor, mcf_backend="cuda_unit")
    return SecondStageSpec(flow=flow_spec, first_stage=fs_spec, poke_embedder=poke_spec,
                           conditioner=cond_spec)


def main(argv=None):
    """Runs the loop, prints its JSON line and returns it as a dict."""
    global T0
    T0 = time.time()
    args = parse_args(argv)
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    if cuda:   # f32 convs and matmuls in full f32, as the JAX package computes
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    counts0 = profiling.counts()
    S, T, B = args.size, args.frames, args.batch
    spec = build_spec(args)
    fs_spec, poke_spec, cond_spec = spec.first_stage, spec.poke_embedder, spec.conditioner
    num_steps = spec.flow.num_steps

    dm = StaticDataModule({"dataset": "SyntheticDataset", "spatial_size": [S, S],
                           "max_frames": T, "n_examples": args.n_train, "batch_size": B,
                           "seed": args.seed})
    dm.setup()
    keys = ("images", "poke", "flow")

    def batches(split):
        """Endless batches of ``split`` on the device."""
        while True:
            for raw in dm.loader(split):
                yield to_device(raw, device, keys)

    train_it = batches("train")
    # the FIXED eval set: n_eval examples of the val split
    eval_batches = []
    for raw in dm.loader("val"):
        eval_batches.append(to_device(raw, device, keys))
        if sum(e["images"].shape[0] for e in eval_batches) >= args.n_eval:
            break
    rng = prng.prng_key(args.seed)

    # ---------------- phase E: conditioning encoders ----------------
    log("phase E: encoder training")
    k1, k2_, _, rng = prng.split(rng, 4)
    img_disc = PatchDiscSpec(ndf=32, n_layers=2)
    img_state, img_opts = tenc.init_image_ae(k1, cond_spec, img_disc, lr=2e-4, device=device)
    img_step = tenc.make_image_ae_step(cond_spec, img_disc, img_opts)
    poke_state, poke_opt = tenc.init_poke_ae(k2_, poke_spec, lr=2e-4, device=device)
    poke_step = tenc.make_poke_ae_step(poke_spec, poke_opt, vgg=img_step.losses.vgg)
    img_logs = poke_logs = {}
    for i in range(args.enc_steps):
        rng, sub = prng.split(rng)
        batch = next(train_it)
        img_state, img_logs = img_step(img_state, batch, sub)
        poke_state, poke_logs = poke_step(poke_state, batch, sub)
        if i % 50 == 0:
            log(f"  enc step {i}: img rec {float(img_logs['rec_loss']):.4f} "
                f"poke rec {float(poke_logs['rec_loss']):.4f}")
    enc_summary = {"img_rec_loss": float(img_logs["rec_loss"]) if img_logs else None,
                   "poke_rec_loss": float(poke_logs["rec_loss"]) if poke_logs else None}

    # ---------------- phase 1: stage-1 cVAE-GAN ----------------
    log("phase 1: stage-1 GAN training")
    dt_spec = TempDiscSpec(spatial_size=S, sequence_length=min(12, T), gp_weight=1.0)
    ds_spec = PatchDiscSpec(gp_weight=0.0, ndf=32, n_layers=2)
    k1, rng = prng.split(rng)
    gmet = {}
    if args.steps1:
        gan_state, gan_opts = tfs.init_gan_state(k1, fs_spec, ds_spec, dt_spec, lr=2e-4,
                                                 device=device)
        gan_step = tfs.make_gan_train_step(fs_spec, ds_spec, dt_spec, gan_opts,
                                           n_spatial_examples=16, remat=args.gan_remat,
                                           vgg_chunks=args.vgg_chunks)
        for i in range(args.steps1):
            rng, sub = prng.split(rng)
            gan_state, gmet = gan_step(gan_state, next(train_it), sub)
            if i % 100 == 0:
                log(f"  gan step {i}: rec {float(gmet['l_rec']):.4f} "
                    f"kl {float(gmet['l_kl']):.2f} d_t {float(gmet['loss_d_dt']):.3f}")
        gen_params = gan_state.gen_params
        del gan_state
    else:   # no GAN step: init_gan_state's generator, without the discriminators
        gen_params = fs_model.init(prng.split(k1, 3)[0], fs_spec, device, spectral_u=True)
    gan_summary = {"l_rec": float(gmet["l_rec"]) if gmet else None,
                   "loss_d_dt": float(gmet["loss_d_dt"]) if gmet else None}

    # ---------------- freeze + assemble ----------------
    # the trained weights with their spectral norm materialised once, as
    # sampling reads them
    with torch.no_grad():
        frozen_fs = fs_model.materialize_spectral_norm(gen_params)
        frozen_poke = enc_model.materialize_spectral_norm(poke_state.params["model"])
        frozen_cond = enc_model.materialize_spectral_norm(img_state.params["model"])
    del gen_params, img_state, poke_state
    k1, rng = prng.split(rng)
    flow_params = macow.init_multiscale(k1, spec.flow, device)
    params = {"flow": flow_params, "first_stage": frozen_fs, "poke_embedder": frozen_poke,
              "conditioner": frozen_cond}
    trainable, frozen = tss.split_params(params)

    # ---------------- eval machinery ----------------
    os.makedirs(args.out, exist_ok=True)
    acc = FVDAccumulator(n_samples=args.n_eval, device=device)
    counts = {"sampling_calls": 0, "teacher_reverses": 0}

    def eval_fvd(sample, tag, save_mp4=False, save_real=True):
        """FVD* of ``sample(batch, key)`` on the eval set, keys from
        ``split(prng_key(1234))`` per batch."""
        acc.reset()
        rng_eval = prng.prng_key(1234)
        for j, eb in enumerate(eval_batches):
            rng_eval, sub = prng.split(rng_eval)
            fake = sample(eb, sub)
            real = eb["images"][:, 1:]
            acc.update(real, fake)
            if save_mp4 and j == 0:
                for n in range(2):
                    vid_util.save_video(fake[n].float().cpu().numpy(),
                                        os.path.join(args.out, f"{tag}_sample{n}.mp4"))
                    if save_real:
                        vid_util.save_video(real[n].float().cpu().numpy(),
                                            os.path.join(args.out, f"real_{n}.mp4"))
        out = float(acc.compute())
        if acc.n_dropped_fake or acc.n_dropped_real:
            log(f"  WARNING {tag}: FVD dropped non-finite rows (real {acc.n_dropped_real}, "
                f"fake {acc.n_dropped_fake} of {args.n_eval})")
        return out

    def teacher_sample(ss_params):
        def sample(eb, key):
            counts["sampling_calls"] += 1
            return ss_model.forward_sample(ss_params, spec, eb, key, n_samples=1)[0]
        return sample

    def eval_recon_floor():
        acc.reset()
        rng_eval = prng.prng_key(4321)
        with torch.no_grad():
            for eb in eval_batches:
                rng_eval, sub = prng.split(rng_eval)
                rec = fs_model.forward(frozen_fs, eb["images"], fs_spec, rng=sub)[0]
                acc.update(eb["images"][:, 1:], rec)
        return float(acc.compute())

    log("eval: stage-1 reconstruction FVD floor")
    fvd_recon = eval_recon_floor()
    log(f"  recon floor FVD* = {fvd_recon:.2f} (i3d pretrained={acc.pretrained})")

    # ---------------- phase 2: stage-2 flow training ----------------
    log(f"phase 2: stage-2 flow training ({args.stage2_trainer}) with periodic FVD evals")
    if args.stage2_trainer == "per-level":
        def make_opt(level_params):
            if args.opt2 == "adafactor":
                return tss.adafactor(args.lr2)
            return tss.make_optimizer(lr=args.lr2, warmup_steps=200, total_steps=args.steps2)

        step2 = chunked.make_per_level_trainer(spec.flow, spec, frozen, make_opt)
        state2 = step2.init_state(trainable["flow"])

        def current_trained():
            return {"flow": {"levels": list(state2.levels)}}
    else:
        opt = tss.make_optimizer(lr=args.lr2, warmup_steps=200, total_steps=args.steps2)
        step2 = tss.make_train_step(spec, frozen, opt)
        state2 = tss.init_state(trainable, opt)

        def current_trained():
            return state2.params
    curve_steps, curve_fvd, curve_nll = [], [], []
    fvd0 = eval_fvd(teacher_sample(params), "step0", save_mp4=True)
    curve_steps.append(0)
    curve_fvd.append(fvd0)
    log(f"  step 0 (fresh-init control): FVD* {fvd0:.2f}")
    met = {}
    for i in range(1, args.steps2 + 1):
        rng, sub = prng.split(rng)
        state2, met = step2(state2, next(train_it), sub)
        if i % 100 == 0:
            log(f"  flow step {i}: loss {float(met['flow_loss']):.3f}")
        if i % args.eval_every == 0 or i == args.steps2:
            cur = {**frozen, **current_trained()}
            fvd = eval_fvd(teacher_sample(cur), f"step{i}", save_mp4=(i == args.steps2))
            curve_steps.append(i)
            curve_fvd.append(fvd)
            curve_nll.append(float(met["flow_loss"]))
            log(f"  step {i}: FVD* {fvd:.2f}")

    # ---------------- phase 3 (optional): distill + sign-off ----------------
    distill_out = None
    if args.distill_steps:
        log("phase 3: distill the direct student from the trained teacher")
        teacher = {**frozen, **current_trained()}
        ds = tdist.DirectStudentSpec(hidden=args.distill_hidden, depth=args.distill_depth)
        init_state_d, dstep = tdist.make_distill_step(spec, ds, tss.adam(args.distill_lr))
        k1, rng = prng.split(rng)
        dstate = init_state_d(k1, device)
        zshape = transformer.reverse_input_shape(spec.flow, B, spec.latent_size,
                                                 spec.flow_in_channels)
        dmse = None
        finite_fracs = []
        for i in range(args.distill_steps):
            batch = next(train_it)
            with torch.no_grad():
                cond = ss_model.embed_cond(
                    teacher, spec, batch["images"][:, 0],
                    batch["flow"] if spec.use_flow_as_poke else batch["poke"])
            z = prng.normal(prng.prng_key(50_000 + i), zshape, device)
            dstate, dlogs = dstep(dstate, teacher, z, cond)
            counts["teacher_reverses"] += 1
            if i % 200 == 0 or i == args.distill_steps - 1:
                dmse = float(dlogs["distill_mse"])
                ff = float(dlogs["teacher_finite_frac"])
                finite_fracs.append(ff)
                log(f"  distill step {i}: mse {dmse:.5f}"
                    + (f" (teacher finite frac {ff:.2f})" if ff < 1 else ""))

        # the student on the SAME eval set and keys: each example gets the
        # teacher's z, so the comparison isolates the student map
        def student_sample(eb, key):
            return tdist.forward_sample_student(teacher, dstate["params"], ds, spec, eb, key,
                                                n_samples=1)[0]

        try:
            fvd_student = eval_fvd(student_sample, "student", save_mp4=True, save_real=False)
        except ValueError as e:   # a degenerate feature set, reported as JAX reports it
            log(f"  student FVD failed: {e}")
            fvd_student = None
        fvd_teacher = curve_fvd[-1]
        log(f"  sign-off: teacher FVD* {fvd_teacher:.3f} vs student FVD* "
            f"{fvd_student if fvd_student is None else round(fvd_student, 3)} "
            f"(control {curve_fvd[0]:.3f}, floor {fvd_recon:.3f})")
        distill_out = {
            "student": {"hidden": ds.hidden, "depth": ds.depth, "steps": args.distill_steps},
            "final_distill_mse": dmse,
            "teacher_finite_frac_logged": finite_fracs,
            "teacher_fvd": round(fvd_teacher, 3),
            "student_fvd": None if fvd_student is None else round(fvd_student, 3),
            "fvd_delta_student_minus_teacher": (
                None if fvd_student is None else round(fvd_student - fvd_teacher, 3)),
            "control_fvd": round(curve_fvd[0], 3),
        }
    train_it.close()

    improved = curve_fvd[-1] < 0.8 * curve_fvd[0]
    decreasing = sum(b < a for a, b in zip(curve_fvd, curve_fvd[1:]))
    if cuda:
        from ipoke_tpu_torch.utils.kernel_bench import card_line

        where = card_line()
    else:
        where = str(device)
    out = {
        "metric": "e2e_fvd_curve",
        "i3d_pretrained": acc.pretrained,
        "fvd_key": "FVD" if acc.pretrained else "FVD_RELATIVE_SEEDED_I3D",
        "steps": curve_steps,
        "fvd": [round(v, 3) for v in curve_fvd],
        "flow_loss_at_evals": [round(v, 3) for v in curve_nll],
        "fvd_recon_floor": round(fvd_recon, 3),
        "improved_final_lt_80pct_of_control": bool(improved),
        "n_decreasing_transitions": int(decreasing),
        "n_evals": len(curve_fvd),
        "encoders": enc_summary,
        "stage1": gan_summary,
        "distill_signoff": distill_out,
        "config": {"size": S, "frames": T, "batch": B, "steps1": args.steps1,
                   "steps2": args.steps2, "enc_steps": args.enc_steps, "n_eval": args.n_eval,
                   "num_steps": list(num_steps), "z_dim": args.z_dim,
                   "flow_hidden": args.flow_hidden, "stage2_trainer": args.stage2_trainer},
        "artifacts_dir": args.out,
        "wall_s": round(time.time() - T0, 1),
        "device": where,
        "k2_launches": launches_since(counts0)["macow_unit_inverse"],
        **counts,
    }
    print(json.dumps(out), flush=True)
    if args.signoff_out and distill_out is not None:
        os.makedirs(os.path.dirname(args.signoff_out) or ".", exist_ok=True)
        with open(args.signoff_out, "w") as f:
            json.dump({"distill_signoff": distill_out, "run_config": out["config"],
                       "wall_s": out["wall_s"]}, f, indent=1)
        log(f"sign-off artifact written to {args.signoff_out}")
    return out


if __name__ == "__main__":
    main()
