#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ipoke_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device  the card's name and power limit (nvidia-smi), torch and CUDA
             versions; TF32 off for every f32 conv and matmul.
  2. build   nvcc builds both kernels from csrc/, one process each, in
             parallel; registers, shared memory and spills per kernel.
  3. kernels K1 (one MCF inverse, all four orders in their native
             orientation) and K2 (a MaCowUnit inverse), each one
             thread-block cluster of G CTAs per example, against their plain
             PyTorch versions at C=32, 4 and 64 at every G they take, at the
             flagship's shapes (B=8, 8x8 latent, with and without h); each
             timed beside its bound at the level-0 shape and its planned G,
             swept over G at C=32, 16, 4 and 64 (hc=128), and timed at every
             flagship level at its planned G for its share of one call; K2
             on one weight slice (where two do not fit one CTA) at C=96 on
             8x8 and C=128 on 4x4, against its plain version at every G it
             takes, timed beside its bound.
  4. slice   iper_128 at full width, params synthesised on the card from a
             seed, bf16 decode: a few requests of 8 through forward_sample on
             the default backend 'cuda_unit' (K2, 200 launches per call) and
             one on the option 'cuda' (K1, 800 launches), launch counts read
             around them; then one batch through 'cuda_unit', 'cuda' and
             'scan' (plain) with non-zero flow output gains, compared.
  4b. variants the flow variants the configs expose (VARIANT_LEGS), each at
             full width on STEPS_PER_LEVEL MaCowSteps per level, JAX's init
             on the card, flow output gains CROSS_GAIN, B=8, f32 decode:
             plants_128 with 32 augment channels, condition_nice, use1x1 and
             cond_conv (K2 on one slice at levels 0-4); iper_128 as a 'down'
             multistack (K2 on one slice at C=128, 120, 112 on 4x4);
             iper_128 with attention and cond_conv at hidden 256.  Each: one
             z through 'cuda_unit', 'cuda' and 'scan' within CROSS_TOL, K2 4
             and K1 16 launches per MaCowStep, reverse(forward(x)) within
             TRAIN_TOL; on the augmented leg one make_train_step step with
             finite loss and non-zero gradients of the augment gains.
  5. serve   the serving path on the same params: the port's HTTP server
             (127.0.0.1, a free port) over a SampleBatcher (max_batch 8,
             30 ms window), every bucket warmed, then the port's load test
             (2 spawned processes x 8 connections, 48 requests, npy_u8);
             launch counts read around it (K2 200 per batch run).  Then, on
             a batcher with flow output gains CROSS_GAIN and f32 decode, one
             served npy video against forward_sample on the z that
             utils/prng draws from its seed, and three requests alone
             against the same three in one batch.  Before it, the host cost
             of the custom ops per launch against the ctypes launch.
  6. distill the distillation path on the slice's params as the frozen
             teacher (seed 0, flow output convs zeroed: the port's
             synth-stable teacher), B=8: a direct student (hidden 256, depth
             6) from JAX's init, DISTILL_DIRECT_STEPS steps of optax's adam
             (K2 200 launches per step, the teacher's reverse; the loss must
             fall); a flow student of one MaCowStep per level,
             DISTILL_FLOW_STEPS steps with finite NLL, then
             reverse(forward(m)) back to m within TRAIN_TOL (60 K2
             launches); then forward_sample_student with the direct student
             trained above, timed beside the slice's calls.
  7. artifact serving artifacts exported on the card (torch.export, K2 as
             the custom op ipoke::macow_unit_inverse): the flow sampler at
             ARTIFACT_FLOW_BUCKETS with flow output gains CROSS_GAIN, at
             iper_128's width and all 15 levels (their splits and priors) on
             a cut depth (STEPS_PER_LEVEL: each level's first
             MaCowStep), loaded and held to the live forward_sample of the
             same cut flow on the same z within CUDA_BATCH_TOL (60 K2
             launches per call); the direct student of
             the distill phase with the u8 wire at bucket 8,
             served over HTTP by the port's server (SERVE_REQUESTS npy_u8
             requests, 2 processes x 8 connections).  Export seconds per
             bucket and file sizes are printed.
  8. eval    the evaluation path on the slice's params at full width, B=8,
             10 frames of 128^2 from the synthetic test split (the port's
             StaticDataModule, as every phase's data), each mode with
             the launch counters zeroed just before it and read just after:
             run_fvd (16 videos in two batches, K2 200 per batch), run_diversity
             (3 samples of 8 examples, 200), run_samples (2 examples, 200),
             the stage-2 validate (two val batches and the latent scatter's
             two, 800; its latents.png, or where matplotlib is missing JAX's
             "latent scatter skipped" warning); seconds by part
             (sampling, I3D features, Frechet), peak memory and every
             *_UNPRETRAINED value printed; the sampled videos' I3D features on
             the card against the port's CPU I3D within I3D_TOL; then the
             stage-2 trainer's top-k checkpoints at cut depth (iper_128's
             width on one MaCowStep), find_best, and test --mode fvd on it;
             then that run resumed (--resume) for one step, which it must
             validate (K2, 12 launches with the scatter's) with its record
             in metrics.jsonl.  The run tree is config.load_parameters'
             layout, so the entry points of eval2 load it.
  8b. eval2  the rest of evaluation on the same params and split, B=8,
             one test batch per mode (EVAL2_TESTING): run_accuracy (the
             pose net's keypoints; without matplotlib it must write
             accuracy.csv, finite, then raise ModuleNotFoundError at the
             first plot, as JAX's), run_kps_acc, run_control_sensitivity
             (2 directions, its artefact tree) and run_transfer, each with
             its exact K2 count (200 per sampling call); the GUI in this
             process (eval/gui over an InteractiveSession of the slice's
             params, B=1): GET / and /frame, a first and GUI_POKES steady
             pokes at the config's length, one of length 16, one with no
             poke, 200 K2 each, ms per poke; then python -m
             ipoke_tpu_torch.eval.interactive and python -m
             ipoke_tpu_torch.eval.gui in child processes on the eval
             phase's cut-depth top-k run (the GUI's start line, one poke).
  8c. ingest reference-checkpoint ingestion at full width: a Lightning
             checkpoint of iper_128 in the reference's key schema (1.5 GB:
             the slice's flow on STEPS_PER_LEVEL MaCowSteps per level, all
             15 levels, a first stage and both towers with both
             halves from JAX's init at seed 1, their spectral-norm convs as
             weight_orig/u/v), a seeded I3D in Unit3Dpy keys and pip-lpips
             heads, in a temporary logs/ tree with best_k_models.yaml and
             the saved config; python -m ipoke_tpu_torch.ckpt.quality_gate
             in a child process (its own IPOKE_WEIGHTS) converts it, samples
             the self-check (K2 60), converts both backbones and gates
             run_fvd (16 videos at B=8, K2 120, the converted I3D); then the
             written npz reloaded through the bridge here: the flow bitwise
             the slice's, every spectral-norm kernel W_orig / (u^T W v) of
             the exported tensors within 1e-6, a B=8 sample on fixed z (K2
             60) within INGEST_TOL of the source params with those folded
             weights.  Seconds per part, the checkpoint's GB, peak device
             memory and host RSS printed.
  8d. parallel the parallel slice at iper_128 full width, after the
             parent freed its model: python -m ipoke_tpu_torch.parallel.dryrun's
             legs (parallel/dryrun.run) in PARALLEL_NPROC spawned ranks, all on
             this card over gloo (NCCL refuses two ranks on one card; with two
             or more cards, again under NCCL, one card per rank): the probe
             of all_reduce / all_gather / broadcast on CUDA tensors; the
             stage-2 step (the flow on STEPS_PER_LEVEL MaCowSteps per level,
             all 15 levels) at a global B=8 (4 rows per rank) on a data x model
             mesh of 2 x 1 with ZeRO-1 moments and on 1 x 2 (the priors' NICE
             convs tensor parallel), two steps each; the motion encoder on
             the shortest video check_plan admits on 2 seq shards (T=64 at
             128^2); the step under FSDP; forward_sample at full depth and a
             global B=8 with z fixed and z drawn.  Each rank holds its params, their change
             over the two steps, their first moments and the metrics against
             its own one-process run within dryrun.TRAIN_TOLS, mu against the
             dense encoder, its videos against the one-process videos within
             CUDA_BATCH_TOL (the ranks raise otherwise);
             launch counts read in the ranks around each driven call (K2 200
             per rank per sampling call, K1 and K2 0 in the train steps);
             step ms and peak memory per rank (FSDP beside data parallel).
             The gloo run adds the microbatched leg (dryrun.micro_leg) in
             the same ranks after FSDP: the step data parallel with ZeRO-1
             and make_train_step(n_microbatches=PARALLEL_MICROBATCHES), so
             each rank runs two microbatches of 2 rows and accumulates their
             gradients, two steps, each rank held against its one-process
             microbatched run within dryrun.TRAIN_TOLS['cuda']; K1 and K2 0
             in its steps.
 9. train   the training path: experiments/second_stage.train on iper_128
             at full width and all 15 levels on STEPS_PER_LEVEL
             MaCowSteps each from JAX's init at seed 0, synthetic
             data in JAX's training order with zero pokes (B=8, 10 frames of
             128^2), torch-Adam (lr 1e-3 after 2
             warm-up steps, weight decay 1e-5), one warm-up step and 5 timed
             steps of an epoch of 7 (so no validation: the eval phase
             validates); no kernel launches in a step.  Checked: finite losses and
             grad norms, the float leaves moved, the frozen and integer leaves
             bitwise as initialised, last.npz (the whole train state, in a
             temporary directory) reloads to the trained params bitwise, and
             reverse(forward(x)) on the trained flow returns the motion latent
             within TRAIN_TOL with 4 K2 launches per MaCowStep (60).
  9b. resume resumption at full width (B=8, the train phase's config and
             cut depth): stage-2 training through python -m ipoke_tpu_torch.main
             in a child process, sent SIGTERM once its log shows step 2; it
             must exit 0 with last.npz (~4.3 GB) saved after the step in
             flight, marked preempted.  Then main --resume for 2 steps in
             this process: the restored train state (params, Adam moments,
             counts) equal to that last.npz bitwise, the first step at the
             schedule's lr of the saved count, the step counter going on
             from the saved step (the eval phase's resumed run holds
             metrics.jsonl going on), no kernel launch.  Printed: seconds from the signal
             to the child's exit, load and restore seconds, the first
             resumed step's ms, the checkpoint's GB.
 10. stage1  first-stage cVAE-GAN training: experiments/first_stage.train
             on iper_128's first stage at full width from JAX's init at seed
             0 (temporal disc ResNet-18 3D with its gradient penalty, patch
             disc, VGG19 perceptual loss, three optimizers), synthetic data
             in JAX's order with zero pokes (B=8, 10 frames of 128^2), f32,
             one warm-up step and
             STAGE1_STEPS timed steps; no kernel launches in a step; the
             epoch's end validated (SSIM, PSNR, LPIPS, FVD of one val batch)
             with its top-k checkpoint.
             Checked: every loss finite, all three nets moved, the
             discriminators' u refreshed and the generator's as drawn,
             last.npz reloads bitwise (u included), test (find_best, then
             validate) gives the trainer's validation again, and the gradient
             penalty on one example on the card against the CPU's.
 10b. stage1 variants  experiments/first_stage.train with
             architecture.baseline: poke_vae on the stage-1 phase's config
             (the PokeVAE from JAX's init at seed 1), one warm-up step and
             POKE_VAE_STEPS timed steps, the epoch's validation, test of the
             best checkpoint; checked: finite losses, all three nets moved,
             last.npz reloads bitwise (u kept), test equals the validation,
             one poke_vae_forward on the card against the CPU (VARIANT_TOL),
             a sample_prior batch of 8 finite in [-1, 1].  Then the RNN
             motion model and the FC baseline at the same width (B=8 timed,
             one video against the CPU), and a MaCow v1 step, the FC,
             mix-CDF and leapfrog flows (round trips, LEGACY_ROUND_TOL), a
             BigGAN and a motion-generator forward at the JAX tests' widths,
             each against the CPU.  No kernel launches in the phase.
 10c. tools  the training and quality tools at iper_128's full width on
             STEPS_PER_LEVEL MaCowSteps per level, params synthesised from
             seed 0 with flow output gains CROSS_GAIN, B=8: (a) one step of
             train/chunked's per-level trainer against one of
             make_train_step from the same params and batch, both with
             make_optimizer at clip 0 (losses, params and first moments per
             leaf within PER_LEVEL_TOLS), peak memory of each; (b) the
             per-level trainer with adafactor and FlowSpec.remat, 1 + 2
             steps, step ms and peak; (c) utils/profile_decode's stages at
             B=8, bf16, 3 iterations; (d) utils/bench_e2e at its default
             geometry with its step counts cut (TOOLS_E2E_ARGS), both K2
             launches per sampling call and per teacher reverse equal to 4
             per MaCowStep (counted around each call), K1 none, and K2
             against its plain version at the loop's level shapes (C=16 and
             12, MCF hidden 4C, h 64) at every G it takes.
 11. data    the data path on a prepared iPER-layout tree written with
             data/tree (4 videos x 30 frames at 256^2, PNG rows in all five
             filters, so the port's PNG decode and LANCZOS resize run): the
             loader (StaticDataModule on IperDataset, 10 frames of 128^2,
             B=8, 4 workers, zero pokes, augment off and on, DATA_BATCHES
             batches each through device_prefetch) in batches/s, samples/s
             and zero-poke share, and one batch's pinned H2D copy; the image
             AE (conditioner width, variational) and the poke AE (poke
             embedder width) at B=16, 1 + AE_STEPS steps each: step ms, the
             disc/gen split by CUDA events, peak memory, every loss and
             d_weight; one step of each on the card against the CPU (logs in
             f32, gradients in f64, ENC_TOL); each trainer through
             ipoke_tpu_torch.main with a validation (lpips-val) and its top-k
             save, the image AE's test through python -m
             ipoke_tpu_torch.main; then 2 stage-2 steps through main on the
             tree at cut depth.  No kernel launches on any of these paths.
 11a. native the native host data engine (IPOKE_NATIVE=1) on the data
             phase's tree: the compiler probed (g++ --version, an OpenMP
             program, whether zlib.h and png.h are found: the engine needs
             neither), csrc/dataio.cpp built by g++ (seconds printed); the
             first clip's 10 frames decoded bitwise data/image's bytes and,
             resized to 128^2 one by one and through load_frames, within
             NATIVE_TOL of the numpy twin; their flows bitwise np.load;
             simulate_pokes on 8 seeded flows twice, bitwise; the loader
             (NATIVE_BATCHES batches of B=8, 10 frames of 128^2) with
             IPOKE_NATIVE=1 (bilinear frames) and without (LANCZOS), in
             batches/s.  No kernel launches.
 11b. prep  data preparation through python -m ipoke_tpu_torch.data.prepare
             in a child process: 4 MJPG clips of textured layers in known
             motion (pwc.synthetic_pair_layered's kind, 40 frames at 256^2,
             cv2.VideoWriter), --mode all at 128^2 with lag 10 and
             IPOKE_WEIGHTS an empty directory, so PWC-lite fits itself on
             the card (900 Adam steps of 8 pairs at 64^2, deterministic;
             fitted again from another key while it loses to Horn-Schunck
             on validation pairs) and writes pwc_lite.npz; frames, 30 flows
             per clip, meta.p and meta_kp_nn.p (without cv2: extract_frames
             must raise ImportError; frames written at 128^2, compute_flows
             here, then --mode prepare and pose_estimation as children).
             Printed: the fit's s and ms per step, flow pairs/s at B=8, the
             meta and NN seconds, the command's; checked: the flows, the NN
             ids from other clips, the fitted net from the child's npz
             under the nine guards of the JAX package's tests/test_pwc.py
             on the card, the card's pwc_flow against the CPU's and the
             child's files (PREP_FLOW_TOL), the child's flows against the
             layers' known motion (PREP_EPE_RATIO of the displacement and
             Horn-Schunck's EPE on the extracted frames, which must beat no
             flow); then one batch of the tree through StaticDataModule and
             2 stage-2 steps through main at cut depth.  No kernel launches.
 12. report  a JSON line of the variants phase, one of the parallel phase, one of the ingest phase, one of the prep phase, one of the data phase, one of the native phase, one of the eval phase, one of
             the eval2 phase, one of
             the stage-1 phase, one of the stage-1 variants phase and its
             seconds, one of the tools phase, one of the resume phase, one of the train phase, one of the distill
             and artifact phases, a JSON line of kernels, the card's line,
             and last {"ok": true, "device": {...}}.
Every time, rate and memory figure printed is this card's, at the power
limit printed beside it.
"""
from __future__ import annotations

import gc
import http.client
import importlib.util
import io as pyio
import itertools
import json
import logging
import os
import pickle
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import replace
from http.server import ThreadingHTTPServer
from pathlib import Path

ROOT = Path(__file__).resolve().parent
if not (ROOT / "ipoke_tpu_torch" / "__init__.py").is_file():
    sys.exit("chip_smoke: ipoke_tpu_torch/ not found beside this script; run it from a checkout")
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ipoke_tpu_torch import registry  # noqa: E402
from ipoke_tpu_torch.ckpt import io  # noqa: E402
from ipoke_tpu_torch.ckpt import torch_import  # noqa: E402
from ipoke_tpu_torch.ckpt.jax_bridge import (  # noqa: E402
    bridge_components, bridge_gan_params, bridge_second_stage, unbridge_flow,
    unbridge_second_stage, unbridge_wrapper)
from ipoke_tpu_torch import main as port_main  # noqa: E402
from ipoke_tpu_torch.data import image, native  # noqa: E402
from ipoke_tpu_torch.data.datamodule import StaticDataModule  # noqa: E402
from ipoke_tpu_torch.data.loader import device_prefetch, to_device  # noqa: E402
from ipoke_tpu_torch.data.tree import write_tree  # noqa: E402
from ipoke_tpu_torch.experiments import encoders as experiment_enc  # noqa: E402
from ipoke_tpu_torch.eval import test_modes  # noqa: E402
from ipoke_tpu_torch.experiments import first_stage as experiment_fs  # noqa: E402
from ipoke_tpu_torch.experiments import second_stage as experiment  # noqa: E402
from ipoke_tpu_torch.flows import mcf, transformer  # noqa: E402
from ipoke_tpu_torch.metrics import i3d  # noqa: E402
from ipoke_tpu_torch.metrics.lpips import lpips_pretrained  # noqa: E402
from ipoke_tpu_torch.models import encoders as encoders_mod  # noqa: E402
from ipoke_tpu_torch.models import first_stage as first_stage_mod  # noqa: E402
from ipoke_tpu_torch.models import second_stage  # noqa: E402
from ipoke_tpu_torch.models.discriminators import gradient_penalty, temp_disc_apply  # noqa: E402
from ipoke_tpu_torch.nn.blocks import materialize_spectral_norm  # noqa: E402
from ipoke_tpu_torch.ops.cuda import _build  # noqa: E402
from ipoke_tpu_torch.ops.cuda import mcf_inverse as k1  # noqa: E402
from ipoke_tpu_torch.ops.cuda import mcf_unit_inverse as k2  # noqa: E402
from ipoke_tpu_torch.parallel import dryrun  # noqa: E402
from ipoke_tpu_torch.serve import artifact, loadtest  # noqa: E402
from ipoke_tpu_torch.serve.batcher import CUDA_BATCH_TOL, BatcherConfig, SampleBatcher  # noqa: E402
from ipoke_tpu_torch.serve.server import make_handler  # noqa: E402
from ipoke_tpu_torch.train import distill  # noqa: E402
from ipoke_tpu_torch.train import encoders as train_enc  # noqa: E402
from ipoke_tpu_torch.train import first_stage as train_fs  # noqa: E402
from ipoke_tpu_torch.train import chunked  # noqa: E402
from ipoke_tpu_torch.train import second_stage as train_ss  # noqa: E402
from ipoke_tpu_torch.train.lr import second_stage_schedule as lr_schedule  # noqa: E402
from ipoke_tpu_torch.utils import bench_e2e, prng, profile_decode, synth  # noqa: E402
from ipoke_tpu_torch.utils.logging import read_metrics  # noqa: E402
from ipoke_tpu_torch.utils.kernel_bench import (  # noqa: E402
    K1_KERNEL, K2_KERNEL, bound, card_line, device_ms, k1_clusters, k1_plan, k1_work,
    k2_clusters, k2_plan, k2_work, mcf_inputs, op_overhead, sweep_k1, sweep_k2, time_ms,
    unit_inputs)

KERNEL_TOL = 2e-4          # tests/test_pallas_mcf.py, tests/test_pallas_unit.py
BATCH, LATENT, HC = 8, 8, 128
REQUESTS = 3
# Flow output-conv gain of the backend cross-check: with the zeroed gains of
# zero_flow_output_convs every MCF is the identity and the check proves nothing.
CROSS_GAIN = 0.02
# The cross-check decodes in f32: kernel and plain sums differ by ~1 ulp per
# MCF, 800 MCFs deep, and the decoder adds its own cuDNN f32 sums.
CROSS_TOL = 2e-3
SERVE_REQUESTS, SERVE_PROCS, SERVE_CONNS = 48, 2, 8
TRAIN_STEPS = 5            # timed train steps, after one warm-up step
# reverse(forward(x)) on the trained flow against x, in f32
TRAIN_TOL = 1e-3
DISTILL_DIRECT_STEPS, DISTILL_FLOW_STEPS = 10, 3
DISTILL_LR = 1e-4          # configs/distill.yaml's distill.lr
STUDENT_CALLS = 3          # timed forward_sample_student calls, after one warm-up
# bucket 8 only: exporting the flagship flow graph is the slowest step of the
# run (PERF.md)
ARTIFACT_FLOW_BUCKETS = (8,)
# bucket 8 only since the stage-1 variants phase came in: each student export
# took 34 s on a slow host (PERF.md), and the smoke must stay well inside 1200 s
ARTIFACT_STUDENT_BUCKETS = (8,)
STAGE1_STEPS = 4           # timed stage-1 GAN steps, after one warm-up step
STAGE1_GP_TOL = 2e-4       # the gradient penalty on the card against the CPU's
# I3D features of the sampled videos on the card against the port's CPU I3D
# (oneDNN off) on the same videos: ~60 f32 convs deep, cuDNN against the CPU
I3D_TOL = 1e-5             # relative to 1 + max|ref| (5.7e-7 measured on the H100)
I3D_CPU_VIDEOS = 4         # videos the CPU recomputes (its I3D takes seconds per video)
# the stage-1 test (find_best, then validate) against the trainer's own
# validation of the same generator on the same card
STAGE1_TEST_TOL = 1e-5     # relative
EVAL_TESTING = {"seed": 42, "n_samples_fvd": 16, "n_samples_per_data_point": 3,
                "n_samples_metrics": 8, "n_samples_vis": 2}
# top-k and test at cut depth: iper_128's width (C=32, hidden 2048, h 128) on
# one level of one MaCowStep, so a checkpoint saves in seconds
TOPK_NUM_STEPS = [1]
# val batches each stage-2 validation reverses for its latent scatter (JAX's
# _log_latents reads 2, whatever max_val_batches says)
LATENT_BATCHES = 2
TOPK_MODEL = "topk"        # the eval phase's run, which the entry points load
# the rest of evaluation (eval2 phase): one test batch of 8 per mode
EVAL2_TESTING = {"seed": 42, "n_samples_metrics": 8, "n_samples_per_data_point": 2,
                 "n_control_sensitivity_pokes": 2, "n_samples_vis": 1}
GUI_POKES = 3              # steady GUI pokes timed after the first
ENTRY_TIMEOUT_S = 240      # the entry points' child processes, start-up included
# the cut depth of the artifact phase's flow sampler, the ingested checkpoint, the
# parallel phase's train legs and the train and resume phases: iper_128's width and
# all 15 levels with the first MaCowStep of each (at 50 MaCowSteps their exports,
# checkpoints and gloo transfers took ~450 s of the run, PERF.md)
STEPS_PER_LEVEL = 1
# K2's one-slice shapes (C, latent size): plants_128 with 32 augment channels
# at level 0, and iper_128's multistack 'down' block at 4x4
K2_ONE_SLICE = ((96, 8), (128, 4))
# the parallel phase: ranks on the card, and how long the spawned dry run may take
PARALLEL_NPROC, PARALLEL_TIMEOUT_S = 2, 600
# the microbatched leg's make_train_step(n_microbatches=): at B=8 on 2 data
# ranks, two microbatches of 2 rows on each rank, their gradients accumulated
PARALLEL_MICROBATCHES = 4
# resumption at full width: the child's epoch (long enough that it never ends
# in the run), the logged step that triggers SIGTERM, the resumed steps, and
# how long the child may take
RESUME_EPOCH, RESUME_SIGNAL_AT, RESUME_STEPS, RESUME_TIMEOUT_S = 12, 2, 2, 300


def log(msg):
    print(msg, flush=True)


def phase_kernels(device, card, k1_levels=(32, 4, 64), k2_levels=(32, 4, 64),
                  sweep_levels=(32, 16, 4, 64), b=BATCH, s=LATENT, hc_full=HC,
                  flagship_levels=None, k2_one_slice=K2_ONE_SLICE):
    """Each kernel against its plain version at every cluster size G it
    takes, and timed, at the flagship's shapes (level 0 is ``k1_levels[0]``
    = ``k2_levels[0]``); K2 also on one weight slice at the (C, size) of
    ``k2_one_slice``; each swept over G; ``card`` labels the times."""
    gen = torch.Generator().manual_seed(0)
    report = {name: {"max_abs_err": 0.0} for name in ("mcf_inverse", "macow_unit_inverse")}

    def check(name, label, out, ref):
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        log(f"kernels: {label}: max |kernel - plain| {err:.3g}")
        if not err <= KERNEL_TOL * (1 + ref.abs().max().item()):
            raise SystemExit(f"{label} disagrees with its plain version: {err}")
        report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)

    def timed(name, kernel, label, kern, plain, flops, nbytes):
        ms, ev_ms, plain_ms = device_ms(kern, 100, kernel), time_ms(kern, 100), time_ms(plain, 20)
        bms, by = bound(flops, nbytes)
        log(f"kernels [{card}]: {label}: {ms:.4f} ms/launch on the device ({ev_ms:.4f} by "
            f"events in a loop), plain {plain_ms:.4f} ms, bound {bms:.5f} ms ({by}; "
            f"{flops / 1e6:.1f} MFLOP, {nbytes / 1e6:.3f} MB), {flops / ms / 1e9:.1f} GFLOP/s")
        return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)

    # K1 in all four orders, at every cluster size it takes
    for c in k1_levels:
        for hc in (hc_full, 0):
            for order in k1.ORDERS:
                z, h, w, w1, b1 = mcf_inputs(gen, c, hc, b, s, order, device)
                ref = k1.mcf_inverse_plain(z, h, w, w1, b1, order)
                for g in k1_clusters(c, hc, s):
                    check("mcf_inverse", f"K1 order {order} C={c} hc={hc} G={g}",
                          k1.mcf_inverse(z, h, w, w1, b1, order, cluster=g), ref)
                if c == k1_levels[0] and hc == hc_full and order == "A":
                    g = k1_plan(c, hc, s)   # the level-0 shape, at the plan's G
                    report["mcf_inverse"].update(timed(
                          "mcf_inverse", K1_KERNEL, f"K1 B={b} C={c} hc={hc} order A G={g} (plan)",
                          lambda: k1.mcf_inverse(z, h, w, w1, b1),
                          lambda: k1.mcf_inverse_plain(z, h, w, w1, b1), *k1_work(b, s, c, hc)))
                    report["mcf_inverse"]["cluster"] = g

    # K2 at every cluster size it takes
    for c in k2_levels:
        for hc in (hc_full, 0):
            weights, an, y, h = unit_inputs(gen, c, hc, b, s, device)
            ref = k2.macow_unit_inverse_plain(y, h, weights, *an)
            for g in k2_clusters(c, hc, s):
                check("macow_unit_inverse", f"K2 C={c} hc={hc} G={g}",
                      k2.macow_unit_inverse(y, h, weights, *an, cluster=g), ref)
            if c == k2_levels[0] and hc == hc_full:   # the level-0 shape, at the plan's G
                g = k2_plan(c, hc, s)
                report["macow_unit_inverse"].update(timed(
                    "macow_unit_inverse", K2_KERNEL, f"K2 B={b} C={c} hc={hc} G={g} (plan)",
                    lambda: k2.macow_unit_inverse(y, h, weights, *an),
                    lambda: k2.macow_unit_inverse_plain(y, h, weights, *an),
                    *k2_work(b, s, c, hc)))
                report["macow_unit_inverse"]["cluster"] = g

    # K2 on one weight slice, at shapes where two do not fit one CTA: every G
    # it takes against the plain version, then timed at the plan's G
    report["macow_unit_inverse"]["one_slice"] = []
    for c, s1 in k2_one_slice:
        weights, an, y, h = unit_inputs(gen, c, hc_full, b, s1, device)
        slices = k2.slice_plan(c, mcf.default_hidden(c), hc_full, 2, 3, s1, s1)
        if slices != 1:
            raise SystemExit(f"kernels: K2 plans {slices} slices at C={c}, {s1}x{s1}, not one")
        ref = k2.macow_unit_inverse_plain(y, h, weights, *an)
        for g in k2_clusters(c, hc_full, s1):
            check("macow_unit_inverse", f"K2 one slice C={c} {s1}x{s1} hc={hc_full} G={g}",
                  k2.macow_unit_inverse(y, h, weights, *an, cluster=g), ref)
        g = k2_plan(c, hc_full, s1)
        row = timed("macow_unit_inverse", K2_KERNEL,
                    f"K2 one slice B={b} C={c} {s1}x{s1} hc={hc_full} G={g} (plan)",
                    lambda: k2.macow_unit_inverse(y, h, weights, *an),
                    lambda: k2.macow_unit_inverse_plain(y, h, weights, *an),
                    *k2_work(b, s1, c, hc_full))
        report["macow_unit_inverse"]["one_slice"].append(dict(c=c, size=s1, cluster=g, **row))

    # the sweeps over G at B=8, hc=128
    report["mcf_inverse"]["sweep"] = sweep_k1(device, log, card, sweep_levels, b, s, hc_full)
    report["macow_unit_inverse"]["sweep"] = sweep_k2(device, log, card, sweep_levels, b, s, hc_full)

    # each kernel at every level of the flagship at its planned G, for its
    # share of one forward_sample: per MaCowStep, 16 K1 launches (4 of each
    # order) under 'cuda', 4 K2 launches under 'cuda_unit'
    if flagship_levels:
        total = {"mcf_inverse": 0.0, "macow_unit_inverse": 0.0}
        for c, n_steps in flagship_levels:
            mcfs = {o: mcf_inputs(gen, c, hc_full, b, s, o, device) for o in k1.ORDERS}
            ms1 = device_ms(lambda: [k1.mcf_inverse(*mcfs[o], o) for o in k1.ORDERS], 25, K1_KERNEL)
            weights, an, y, h = unit_inputs(gen, c, hc_full, b, s, device)
            ms2 = device_ms(lambda: k2.macow_unit_inverse(y, h, weights, *an), 50, K2_KERNEL)
            total["mcf_inverse"] += 16 * n_steps * ms1
            total["macow_unit_inverse"] += 4 * n_steps * ms2
            log(f"kernels [{card}]: level C={c}: K1 G={k1_plan(c, hc_full, s)} {ms1:.4f} ms/launch "
                f"on the device (mean of the four orders) x {16 * n_steps} launches; "
                f"K2 G={k2_plan(c, hc_full, s)} {ms2:.4f} ms/launch x {4 * n_steps} launches")
        for name, label, backend in (("mcf_inverse", "K1", "cuda"),
                                     ("macow_unit_inverse", "K2", "cuda_unit")):
            log(f"kernels [{card}]: {label} launches of one forward_sample (B={b}, '{backend}') "
                f"sum to {total[name]:.2f} ms")
            report[name]["per_sample_call_ms"] = total[name]
    return report


def make_requests(device, n, b, spec, seed=1000):
    """n requests of b examples, each from its own seeded generator:
    (batch dict, fixed z)."""
    fs = spec.first_stage
    out = []
    for r in range(n):
        g = torch.Generator(device=device).manual_seed(seed + r)
        batch = {"images": torch.randn(b, fs.max_frames, fs.spatial_size, fs.spatial_size, 3,
                                       generator=g, device=device).clamp_(-1, 1),
                 "poke": torch.randn(b, fs.spatial_size, fs.spatial_size, 2, generator=g, device=device)}
        z = torch.randn(b, spec.latent_size, spec.latent_size, spec.flow_in_channels,
                        generator=g, device=device)
        out.append((batch, z))
    return out


def phase_slice(device, card, spec, params, n_requests=REQUESTS, b=BATCH):
    """The main path: ``n_requests`` requests through forward_sample on the
    default backend 'cuda_unit' (K2), then one on the option 'cuda' (K1);
    ``card`` labels the times.  Both launch counters are zeroed just before
    the first request and read just after the last.  Returns the latencies of
    the 'cuda_unit' requests and each kernel's launches."""
    requests = make_requests(device, n_requests + 1, b, spec)
    backends = ["cuda_unit"] * n_requests + ["cuda"]
    units = sum(spec.flow.num_steps) * 4
    want_launches = {"cuda_unit": (0, units), "cuda": (4 * units, 0)}   # (K1, K2) per call
    fs = spec.first_stage
    want = (1, b, fs.max_frames - 1, fs.spatial_size, fs.spatial_size, 3)
    lat = []
    k1.mcf_inverse.launches = 0
    k2.macow_unit_inverse.launches = 0
    for i, ((batch, z), backend) in enumerate(zip(requests, backends)):
        s = replace(spec, flow=replace(spec.flow, mcf_backend=backend))
        before = (k1.mcf_inverse.launches, k2.macow_unit_inverse.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vid = second_stage.forward_sample(params, s, batch, z=z)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if backend == "cuda_unit":
            lat.append(dt)
        n = (k1.mcf_inverse.launches - before[0], k2.macow_unit_inverse.launches - before[1])
        finite = bool(torch.isfinite(vid).all())
        log(f"slice [{card}]: request {i} on '{backend}': {dt * 1e3:.1f} ms, shape "
            f"{tuple(vid.shape)}, finite {finite}, K1/K2 launches {n[0]}/{n[1]}")
        if tuple(vid.shape) != want or not finite or n != want_launches[backend]:
            raise SystemExit(f"slice: request {i} failed (shape {tuple(vid.shape)} want {want}, "
                             f"finite {finite}, K1/K2 launches {n} want {want_launches[backend]})")
    launches = {"mcf_inverse": k1.mcf_inverse.launches,
                "macow_unit_inverse": k2.macow_unit_inverse.launches}
    return {"latency_s": lat, "launches": launches}


def phase_cross_check(device, spec, params, b=BATCH):
    """One batch through 'cuda_unit', 'cuda' and 'scan', f32 decode, with flow
    output gains CROSS_GAIN."""
    gain, tol = CROSS_GAIN, CROSS_TOL
    spec = replace(spec, first_stage=replace(spec.first_stage, decode_dtype="f32"))
    params = dict(params, flow=synth.set_flow_output_gains(params["flow"], gain))
    (batch, z), = make_requests(device, 1, b, spec, seed=2000)
    vids = {}
    for backend in ("cuda_unit", "cuda", "scan"):
        s = replace(spec, flow=replace(spec.flow, mcf_backend=backend))
        vids[backend] = second_stage.forward_sample(params, s, batch, z=z)
    ref = vids["scan"]
    if not bool(torch.isfinite(ref).all()):
        raise SystemExit(f"cross-check: the plain video is not finite at gain {gain}")
    for backend in ("cuda_unit", "cuda"):
        err = (vids[backend] - ref).abs().max().item()
        log(f"cross-check (flow output gain {gain}, f32 decode): max |{backend} - scan| "
            f"{err:.3g} (tolerance {tol}); video range [{ref.min().item():.3f}, {ref.max().item():.3f}]")
        if not err <= tol:
            raise SystemExit(f"cross-check: {backend} disagrees with scan: {err}")


# the flow variants the configs expose, each on one registry model at full
# width on STEPS_PER_LEVEL MaCowSteps per level: (leg, registry model,
# architecture keys, FlowSpec fields no config key sets).  The attention leg
# runs at flow_mid_channels_factor 8 (hidden 256), not iper_128's 64: at
# hidden 2048 one attention NICE block alone holds ~0.5 G params.
VARIANT_LEGS = (
    ("plants_128-aug", "plants_128",
     dict(augmented_input=True, augment_channels=32, scale_augmentation=True,
          shift_augmentation=True, condition_nice=True, use1x1=True), dict(cond_conv=True)),
    ("iper_128-stack-down", "iper_128",
     dict(multistack=True, levels=[[1, 1, 1, 1], [1, 1, 1, 1]], factors=[16, 16],
          reshape="down", flow_mid_channels_factor=64), {}),
    ("iper_128-attn", "iper_128",
     dict(attention=True, flow_attn_heads=4, ssize=8, flow_mid_channels_factor=8),
     dict(cond_conv=True)),
)


def variant_spec(entry, arch, flow_fields):
    """The registry entry's spec with the variant's architecture keys, f32
    decode, STEPS_PER_LEVEL MaCowSteps per level (every block of a stack)."""
    spec = registry.build_specs(entry, arch_overrides=arch)
    flow = spec.flow
    if transformer.is_stack(flow):
        flow = replace(flow, levels=tuple(tuple(min(STEPS_PER_LEVEL, n) for n in block)
                                          for block in flow.levels))
    else:
        flow = replace(flow, num_steps=tuple(min(STEPS_PER_LEVEL, n) for n in flow.num_steps),
                       **flow_fields)
    return replace(spec, flow=flow,
                   first_stage=replace(spec.first_stage, decode_dtype="f32")).validate()


def macow_steps(flow):
    """MaCowSteps of a flow spec (every block of a stack)."""
    if transformer.is_stack(flow):
        return sum(sum(block) for block in flow.levels)
    return sum(flow.num_steps)


def phase_variants(device, card, legs=VARIANT_LEGS, b=BATCH):
    """Each leg: params from JAX's init at seed 0 drawn on the card, flow output
    gains CROSS_GAIN; one fixed z sampled on 'cuda_unit', 'cuda' and 'scan'
    (f32 decode), the kernels within CROSS_TOL of the plain path, with the
    launch counters zeroed before and read after each call (K2 4 per
    MaCowStep on 'cuda_unit', K1 16 on 'cuda'); reverse(forward(x)) back to
    x on 'cuda_unit' within TRAIN_TOL; on an augmented leg one
    make_train_step step with a finite loss and non-zero gradients of
    scale_augment and shift_augment."""
    t_phase = time.perf_counter()
    out = {}
    for leg, model, arch, flow_fields in legs:
        t_leg = time.perf_counter()
        entry = registry.MODELS[model]
        spec = variant_spec(entry, arch, flow_fields)
        params = second_stage.init(prng.prng_key(0), spec, device)
        params["flow"] = synth.set_flow_output_gains(params["flow"], CROSS_GAIN)
        torch.cuda.synchronize()
        n_flow = sum(t.numel() for t in train_ss.leaves(params["flow"]))
        steps = macow_steps(spec.flow)
        init_s = time.perf_counter() - t_leg
        (batch, _), = make_requests(device, 1, b, spec, seed=3000)
        z_shape = transformer.reverse_input_shape(spec.flow, b, spec.latent_size,
                                                  spec.flow_in_channels)
        z = torch.randn(z_shape, generator=torch.Generator(device=device).manual_seed(3001),
                        device=device)
        vids, launches = {}, {}
        want = {"cuda_unit": (0, 4 * steps), "cuda": (16 * steps, 0), "scan": (0, 0)}
        for backend in ("cuda_unit", "cuda", "scan"):
            s = replace(spec, flow=replace(spec.flow, mcf_backend=backend))
            _zero_counts()
            vids[backend] = second_stage.forward_sample(params, s, batch, z=z)
            torch.cuda.synchronize()
            launches[backend] = _counts()
            if launches[backend] != want[backend]:
                raise SystemExit(f"variants: {leg} on '{backend}': K1/K2 launches "
                                 f"{launches[backend]}, want {want[backend]}")
        ref = vids["scan"]
        if not bool(torch.isfinite(ref).all()):
            raise SystemExit(f"variants: {leg}: the plain video is not finite")
        errs = {k: (vids[k] - ref).abs().max().item() for k in ("cuda_unit", "cuda")}
        if not all(e <= CROSS_TOL for e in errs.values()):
            raise SystemExit(f"variants: {leg}: a kernel path disagrees with scan: {errs}")
        # reverse(forward(x)) on 'cuda_unit'
        gen = torch.Generator(device=device).manual_seed(3002)
        x = torch.randn((b, spec.latent_size, spec.latent_size, spec.flow_in_channels),
                        generator=gen, device=device)
        unit_spec = replace(spec.flow, mcf_backend="cuda_unit")
        with torch.no_grad():
            cond = second_stage.embed_cond(params, spec, batch["images"][:, 0], batch["poke"])
            zz, _ = transformer.forward(params["flow"], unit_spec, x, cond)
            _zero_counts()
            back = transformer.reverse(params["flow"], unit_spec, zz, cond)
            torch.cuda.synchronize()
        rt_launches = _counts()
        rt_err = (back - x).abs().max().item()
        if not rt_err <= TRAIN_TOL or rt_launches != (0, 4 * steps):
            raise SystemExit(f"variants: {leg}: reverse(forward(x)) off by {rt_err}, "
                             f"K1/K2 launches {rt_launches}")
        row = {"macow_steps": steps, "flow_params": n_flow, "init_s": init_s,
               "launches": {k: {"mcf_inverse": v[0], "macow_unit_inverse": v[1]}
                            for k, v in launches.items()},
               "max_abs_err": errs, "roundtrip_err": rt_err,
               "roundtrip_launches": {"mcf_inverse": rt_launches[0],
                                      "macow_unit_inverse": rt_launches[1]}}
        if spec.augment_channels:
            trainable, frozen = train_ss.split_params(params)
            step = train_ss.make_train_step(spec, frozen, train_ss.make_optimizer(1e-3))
            state = train_ss.init_state(trainable, step.optimizer)
            _zero_counts()
            _, _, grads = step.grads_of(state.params, batch, prng.prng_key(7))
            state, metrics = step(state, batch, prng.prng_key(7))
            torch.cuda.synchronize()
            leaves = train_ss.float_leaves(trainable)
            gnorm = {k: next(g for p, g in zip(leaves, grads) if p is trainable[k]).norm().item()
                     for k in ("scale_augment", "shift_augment")}
            loss = float(metrics["flow_loss"])
            row["train"] = {"flow_loss": loss, "grad_norm": gnorm, "launches": list(_counts())}
            if not np.isfinite(loss) or not all(g > 0 and np.isfinite(g) for g in gnorm.values()) \
                    or _counts() != (0, 0):
                raise SystemExit(f"variants: {leg}: the train step failed: {row['train']}")
        row["s"] = time.perf_counter() - t_leg
        out[leg] = row
        log(f"variants [{card}]: {leg}: {steps} MaCowSteps, {n_flow / 1e9:.3f} G flow params "
            f"(init {init_s:.1f} s); K1/K2 launches {launches}; max |cuda_unit - scan| "
            f"{errs['cuda_unit']:.3g}, |cuda - scan| {errs['cuda']:.3g} (tolerance {CROSS_TOL}); "
            f"reverse(forward(x)) off by {rt_err:.3g}"
            + (f"; train step flow_loss {row['train']['flow_loss']:.6g}, |grad| of the augment "
               f"gains {row['train']['grad_norm']}" if "train" in row else "")
            + f"; {row['s']:.1f} s")
        del params, vids
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"variants [{card}]: the phase took {out['phase_s']:.1f} s")
    return out


def _start_server(batcher):
    """The port's HTTP server over ``batcher`` on 127.0.0.1, a free port."""
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(batcher))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, thread


def _stop_server(httpd, thread, batcher):
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=10)
    batcher.close()


def _http(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        data = resp.read()
        if resp.status != 200:
            raise SystemExit(f"serve: {method} {path} answered {resp.status}: {data[:200]!r}")
        return data
    finally:
        conn.close()


def phase_serve(card, spec, params, direct_s, b=BATCH, n_requests=SERVE_REQUESTS,
                procs=SERVE_PROCS, conns=SERVE_CONNS):
    """The serving path, the second path of this run: the port's HTTP server
    over a SampleBatcher (max_batch ``b``, 30 ms window) on the slice's
    params, every bucket warmed, then the port's load test (``procs``
    processes x ``conns`` connections, ``n_requests`` requests, npy_u8).
    Both launch counters are zeroed just before the warm-up and read just
    after the load test; K2 must have launched 200 times per batch run.
    ``direct_s`` are the slice phase's B=``b`` latencies, printed beside."""
    batcher = SampleBatcher(params, spec, BatcherConfig(max_batch=b, max_delay_ms=30.0))
    httpd, thread = _start_server(batcher)
    port = httpd.server_address[1]
    units = sum(spec.flow.num_steps) * 4
    try:
        k1.mcf_inverse.launches = 0
        k2.macow_unit_inverse.launches = 0
        t0 = time.perf_counter()
        batcher.warmup()
        warm_s = time.perf_counter() - t0
        res = loadtest.run(port, requests=n_requests, procs=procs, conns=conns,
                           size=spec.first_stage.spatial_size, fmt="npy_u8", timeout=600)
        stats = json.loads(_http(port, "GET", "/stats"))
        n = (k1.mcf_inverse.launches, k2.macow_unit_inverse.launches)
    finally:
        _stop_server(httpd, thread, batcher)
    n_warm = len(batcher.buckets)
    want = (0, units * (stats["batches"] + n_warm))
    direct_mean = sum(direct_s) / len(direct_s)
    log(f"serve [{card}]: {res['requests_ok']}/{n_requests} requests ok, {res['errors']} errors "
        f"({procs} processes x {conns} connections, npy_u8); {res['videos_per_s_served']:.3f} "
        f"videos/s served over {res['wall_s']:.3f} s; p50 {res['p50_s'] * 1e3:.1f} ms, "
        f"p95 {res['p95_s'] * 1e3:.1f} ms; batch sizes {stats['batch_size_histogram']}, "
        f"mean batch exec {stats['mean_batch_exec_ms']:.1f} ms, mean wait "
        f"{stats['mean_wait_ms']:.1f} ms; warm-up of buckets {batcher.buckets} {warm_s:.2f} s; "
        f"K1/K2 launches {n[0]}/{n[1]} (want {want[0]}/{want[1]} = {units} x ({stats['batches']} "
        f"batches + {n_warm} warm-up calls)); direct forward_sample B={b}: "
        f"{', '.join(f'{x * 1e3:.1f}' for x in direct_s)} ms, {b / direct_mean:.3f} videos/s")
    if (res["requests_ok"] != n_requests or res["errors"] or stats["requests"] != n_requests
            or n != want):
        raise SystemExit(f"serve: failed ({res}, stats {stats}, K1/K2 launches {n} want {want})")
    return {"launches": {"mcf_inverse": n[0], "macow_unit_inverse": n[1]}}


def phase_serve_check(device, spec, params, seeds=(11, 2**32 - 1, 2**40 + 3)):
    """What the server answers, on a batcher whose flow output gains are
    CROSS_GAIN, f32 decode: one request's npy video over HTTP against
    forward_sample on the z that utils/prng draws from its seed (CROSS_TOL),
    and the same requests alone and in one shared batch (CUDA_BATCH_TOL)."""
    spec = replace(spec, first_stage=replace(spec.first_stage, decode_dtype="f32"))
    params = dict(params, flow=synth.set_flow_output_gains(params["flow"], CROSS_GAIN))
    fs = spec.first_stage
    rng = np.random.default_rng(3000)
    reqs = [(rng.uniform(-1, 1, (fs.spatial_size, fs.spatial_size, 3)).astype(np.float32),
             rng.standard_normal((fs.spatial_size, fs.spatial_size, 2)).astype(np.float32), s)
            for s in seeds]
    batcher = SampleBatcher(params, spec, BatcherConfig(max_batch=4, max_delay_ms=200.0))
    httpd, thread = _start_server(batcher)
    try:
        x0, poke, seed = reqs[0]
        buf = pyio.BytesIO()
        np.savez(buf, x0=x0, poke=poke, seed=np.int64(seed), format=np.str_("npy"))
        served = np.load(pyio.BytesIO(_http(httpd.server_address[1], "POST", "/sample", buf.getvalue(),
                                          {"Content-Type": "application/octet-stream"})))
        z_shape = transformer.reverse_input_shape(spec.flow, 1, spec.latent_size,
                                                  spec.flow_in_channels)[1:]
        z = prng.normal_for_seeds([seed & prng.MASK], z_shape, device)
        batch = {"images": torch.from_numpy(x0).to(device)[None, None],
                 "poke": torch.from_numpy(poke).to(device)[None]}
        direct = second_stage.forward_sample(params, spec, batch, length=fs.max_frames - 1,
                                             add_first_frame=True, z=z)[0, 0].cpu().numpy()
        err = float(np.abs(served - direct).max())
        log(f"serve check (flow output gain {CROSS_GAIN}, f32 decode): max |served npy - "
            f"forward_sample on prng z| {err:.3g} (tolerance {CROSS_TOL}); shape {served.shape}, "
            f"video range [{direct.min():.3f}, {direct.max():.3f}]")
        if not (np.isfinite(served).all() and err <= CROSS_TOL):
            raise SystemExit(f"serve check: the served video disagrees with forward_sample: {err}")
        solo = [batcher.submit(x0, poke, seed, timeout=300) for x0, poke, seed in reqs]
        before = dict(batcher.stats.batch_hist)
        handles = [batcher.submit_async(x0, poke, seed) for x0, poke, seed in reqs]
        for h in handles:
            if not h.event.wait(300) or h.error is not None:
                raise SystemExit(f"serve check: a batched request failed: {h.error}")
        grew = {k: v - before.get(k, 0) for k, v in batcher.stats.batch_hist.items()
                if v != before.get(k, 0)}
        gap = max(float(np.abs(a - h.result).max()) for a, h in zip(solo, handles))
        log(f"serve check: {len(reqs)} requests alone (bucket 1) and together (batches {grew}): "
            f"max |alone - batched| {gap:.3g} (tolerance {CUDA_BATCH_TOL})")
        if grew != {4: 1} or not gap <= CUDA_BATCH_TOL:
            raise SystemExit(f"serve check: alone and batched disagree ({gap}) or did not share "
                             f"a batch ({grew})")
    finally:
        _stop_server(httpd, thread, batcher)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def _counts():
    return k1.mcf_inverse.launches, k2.macow_unit_inverse.launches


def _zero_counts():
    k1.mcf_inverse.launches = 0
    k2.macow_unit_inverse.launches = 0


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def phase_distill(device, card, spec, params, slice_s, b=BATCH, direct_steps=DISTILL_DIRECT_STEPS,
                  flow_steps=DISTILL_FLOW_STEPS, student_calls=STUDENT_CALLS):
    """The distillation path on ``params`` as the frozen teacher, one fixed
    cond of ``b`` examples, step i's z from ``prng_key(100 + i)``: a direct
    student (256, 6) from JAX's init at key 0, then a flow student of one
    MaCowStep per level from key 1, then forward_sample_student of the
    trained direct student.  The launch counters are zeroed just before each
    part and read just after it.  Returns (numbers, (the trained direct
    student's params, its spec))."""
    units = 4 * sum(spec.flow.num_steps)
    (batch, _), = make_requests(device, 1, b, spec, seed=4000)
    cond = second_stage.embed_cond(params, spec, batch["images"][:, 0], batch["poke"])
    zshape = transformer.reverse_input_shape(spec.flow, b, spec.latent_size, spec.flow_in_channels)
    out = {}

    def train(student, key, steps, lr):
        init_state, step = distill.make_distill_step(spec, student, train_ss.adam(lr))
        t0 = time.perf_counter()
        state = init_state(prng.prng_key(key), device)
        _sync(device)
        init_s = time.perf_counter() - t0
        hist = []
        _zero_counts()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        for i in range(steps):
            z = prng.normal(prng.prng_key(100 + i), zshape, device)
            _sync(device)
            t0 = time.perf_counter()
            state, logs = step(state, params, z, cond)
            logs = {k: float(v) for k, v in logs.items()}   # a host read: the step has finished
            hist.append(dict(logs, ms=(time.perf_counter() - t0) * 1e3))
        n = _counts()
        peak = torch.cuda.max_memory_allocated() / 2**30 if device.type == "cuda" else 0.0
        return state, hist, n, init_s, peak

    # direct student
    ds = distill.DirectStudentSpec(hidden=256, depth=6)
    state, hist, n, init_s, peak = train(ds, 0, direct_steps, DISTILL_LR)
    for i, h in enumerate(hist):
        log(f"distill [{card}]: direct step {i}: loss {h['loss']:.6g}, teacher_finite_frac "
            f"{h['teacher_finite_frac']:.3f}, {h['ms']:.1f} ms")
    losses = [h["loss"] for h in hist]
    step_ms = _median([h["ms"] for h in hist[1:]] or [hist[0]["ms"]])
    log(f"distill [{card}]: direct student (256, 6), B={b}, lr {DISTILL_LR}: init {init_s:.2f} s; "
        f"step first {hist[0]['ms']:.1f} ms, median of the rest {step_ms:.1f} ms; loss "
        f"{losses[0]:.6g} -> {losses[-1]:.6g}; K1/K2 launches {n[0]}/{n[1]} ({n[1] / direct_steps:g} "
        f"K2 per step, want {units}); peak {peak:.2f} GiB")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
            and n == (0, units * direct_steps)):
        raise SystemExit(f"distill: the direct student failed (losses {losses}, K1/K2 {n})")
    out["direct"] = {"init_s": init_s, "step_ms": [h["ms"] for h in hist],
                     "step_ms_median": step_ms, "loss": losses, "peak_gib": peak,
                     "teacher_finite_frac": [h["teacher_finite_frac"] for h in hist],
                     "launches_per_step": {"mcf_inverse": n[0] / direct_steps,
                                           "macow_unit_inverse": n[1] / direct_steps}}
    sp = state["params"]
    del state

    # flow student: one MaCowStep per level
    s_spec = distill.flow_student_spec(spec.flow, (1,) * len(spec.flow.num_steps))
    fstate, fhist, n, init_s, peak = train(s_spec, 1, flow_steps, 1e-4)
    nll = [h["loss"] for h in fhist]
    s_units = 4 * sum(s_spec.num_steps)
    with torch.no_grad():
        m = distill.teacher_motion(params, spec, prng.normal(prng.prng_key(200), zshape, device), cond)
        g, _ = transformer.forward(fstate["params"], s_spec, m, cond)
        _zero_counts()
        back = transformer.reverse(fstate["params"], s_spec, g, cond)
        _sync(device)
        n_rt = _counts()
    err = (back - m).abs().max().item()
    log(f"distill [{card}]: flow student {s_spec.num_steps}: init {init_s:.2f} s; steps "
        f"{', '.join(f'{h['ms']:.1f}' for h in fhist)} ms; NLL {', '.join(f'{x:.6g}' for x in nll)}; "
        f"K1/K2 launches in the steps {n[0]}/{n[1]}; peak {peak:.2f} GiB; max |reverse(forward(m)) - m| "
        f"{err:.3g} (tolerance {TRAIN_TOL}) with K1/K2 launches {n_rt[0]}/{n_rt[1]} (want 0/{s_units})")
    if not (all(np.isfinite(nll)) and n == (0, units * flow_steps) and err <= TRAIN_TOL
            and n_rt == (0, s_units)):
        raise SystemExit(f"distill: the flow student failed (NLL {nll}, K1/K2 {n}, round trip "
                         f"{err} with {n_rt})")
    out["flow"] = {"init_s": init_s, "step_ms": [h["ms"] for h in fhist], "nll": nll,
                   "peak_gib": peak, "roundtrip_max_abs_err": err,
                   "roundtrip_launches": {"mcf_inverse": n_rt[0], "macow_unit_inverse": n_rt[1]}}
    del fstate, m, g, back

    # the trained direct student's sampler
    (batch, z), = make_requests(device, 1, b, spec, seed=5000)
    fs = spec.first_stage
    want = (1, b, fs.max_frames - 1, fs.spatial_size, fs.spatial_size, 3)
    lat = []
    _zero_counts()
    for i in range(1 + student_calls):
        _sync(device)
        t0 = time.perf_counter()
        vid = distill.forward_sample_student(params, sp, ds, spec, batch, z=z)
        _sync(device)
        lat.append((time.perf_counter() - t0) * 1e3)
    n = _counts()
    finite = bool(torch.isfinite(vid).all())
    steady = lat[1:]
    flow_ms = [x * 1e3 for x in slice_s]
    log(f"distill [{card}]: forward_sample_student ({ds.hidden}, {ds.depth}) trained above, "
        f"B={b}: first {lat[0]:.1f} ms, then {', '.join(f'{x:.1f}' for x in steady)} ms, "
        f"{b * 1e3 / (sum(steady) / len(steady)):.2f} videos/s; the flow's forward_sample "
        f"(slice phase) {', '.join(f'{x:.1f}' for x in flow_ms)} ms, "
        f"{b * 1e3 / (sum(flow_ms) / len(flow_ms)):.2f} videos/s; shape {tuple(vid.shape)}, finite "
        f"{finite}; K1/K2 launches {n[0]}/{n[1]}")
    if tuple(vid.shape) != want or not finite or n != (0, 0):
        raise SystemExit(f"distill: forward_sample_student failed ({tuple(vid.shape)}, {finite}, {n})")
    out["student_sample_ms"] = lat
    return out, (sp, ds)


def cut_spec(spec, k):
    """``spec`` with at most ``k`` MaCowSteps per level, every level kept."""
    return replace(spec, flow=replace(spec.flow, num_steps=tuple(min(k, n) for n in
                                                                 spec.flow.num_steps)))


def cut_flow(flow, k):
    """Flow params with each level's first ``k`` MaCowSteps (``cut_spec``'s)."""
    return dict(flow, levels=[dict(level, steps=level["steps"][:k]) for level in flow["levels"]])


def phase_artifact(device, card, spec, params, student, tmp, flow_buckets=ARTIFACT_FLOW_BUCKETS,
                   student_buckets=ARTIFACT_STUDENT_BUCKETS, b=BATCH,
                   n_requests=SERVE_REQUESTS, procs=SERVE_PROCS, conns=SERVE_CONNS):
    """Serving artifacts exported on ``device`` into ``tmp``: the flow
    sampler (flow output gains CROSS_GAIN) of ``spec``'s width and levels
    on STEPS_PER_LEVEL MaCowSteps per level at
    ``flow_buckets``, loaded and run at
    bucket ``b`` against the live forward_sample; then the direct
    student ``student`` = (params, spec) with the u8 wire at
    ``student_buckets``, served over HTTP.  The launch counters are zeroed just before each run
    and read just after it."""
    cut = cut_spec(spec, STEPS_PER_LEVEL)
    units = 4 * sum(cut.flow.num_steps)
    gparams = dict(params, flow=synth.set_flow_output_gains(
        cut_flow(params["flow"], STEPS_PER_LEVEL), CROSS_GAIN))

    def export(name, **kw):
        t0 = time.perf_counter()
        artifact.export_sampler(gparams if name == "flow" else params,
                                cut if name == "flow" else spec, tmp / name, **kw)
        total = time.perf_counter() - t0
        m = json.loads((tmp / name / "manifest.json").read_text())
        sizes = {f.name: f.stat().st_size for f in sorted((tmp / name).iterdir())}
        t0 = time.perf_counter()
        art = artifact.load_artifact(tmp / name, device)
        load_s = time.perf_counter() - t0
        log(f"artifact [{card}]: {name} ({m['sampler']}, wire {m['wire']}) exported in "
            f"{total:.1f} s: per bucket {', '.join(f'{k}: {v:.1f} s' for k, v in m['export_s'].items())}; "
            f"files {', '.join(f'{k} {v / 1e6:.1f} MB' for k, v in sizes.items())}; loaded in "
            f"{load_s:.1f} s")
        return art, {"export_s": m["export_s"], "export_total_s": total, "load_s": load_s,
                     "bytes": sizes}

    out = {}
    art, out["flow"] = export("flow", buckets=flow_buckets)
    nodes = sum("ipoke.macow_unit_inverse" in str(n.target) for n in art.programs[b].graph.nodes)
    (batch, _), = make_requests(device, 1, b, spec, seed=6000)
    x0, poke = batch["images"][:, 0], batch["poke"]
    z = art.draw_z(range(b))
    art.run(art.params, x0, poke, z)   # first call
    ms, n = [], []
    for _ in range(2):
        _zero_counts()
        _sync(device)
        t0 = time.perf_counter()
        got = art.run(art.params, x0, poke, z)
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        n.append(_counts())
    live_ms = []
    for _ in range(2):
        _sync(device)
        t0 = time.perf_counter()
        live = second_stage.forward_sample(gparams, cut, batch, length=art.length,
                                           add_first_frame=True, z=z)[0]
        _sync(device)
        live_ms.append((time.perf_counter() - t0) * 1e3)
    err = (got - live).abs().max().item()
    log(f"artifact [{card}]: flow bucket {b}: {nodes} ipoke::macow_unit_inverse nodes; calls "
        f"{', '.join(f'{x:.1f}' for x in ms)} ms (live forward_sample {', '.join(f'{x:.1f}' for x in live_ms)} "
        f"ms); K1/K2 launches per call {n}; max |artifact - live| {err:.3g} (tolerance "
        f"{CUDA_BATCH_TOL}); video range [{live.min().item():.3f}, {live.max().item():.3f}]")
    if nodes != units or any(x != (0, units) for x in n) or not err <= CUDA_BATCH_TOL \
            or not bool(torch.isfinite(got).all()):
        raise SystemExit(f"artifact: the flow artifact failed ({nodes} nodes, launches {n}, err {err})")
    out["flow"].update(call_ms=ms, live_ms=live_ms, max_abs_err=err, nodes=nodes,
                       launches_per_call={"mcf_inverse": n[0][0], "macow_unit_inverse": n[0][1]})
    del art, got, live, gparams

    art, out["student"] = export("student", buckets=student_buckets, student=student, wire_u8=True)
    batcher = SampleBatcher.from_artifact(art, BatcherConfig(max_batch=b, max_delay_ms=30.0))
    httpd, thread = _start_server(batcher)
    port = httpd.server_address[1]
    try:
        _zero_counts()
        t0 = time.perf_counter()
        batcher.warmup()
        warm_s = time.perf_counter() - t0
        res = loadtest.run(port, requests=n_requests, procs=procs, conns=conns,
                           size=spec.first_stage.spatial_size, fmt="npy_u8", timeout=600)
        stats = json.loads(_http(port, "GET", "/stats"))
        n = _counts()
    finally:
        _stop_server(httpd, thread, batcher)
    log(f"artifact [{card}]: student artifact served: {res['requests_ok']}/{n_requests} requests ok, "
        f"{res['errors']} errors ({procs} processes x {conns} connections, npy_u8); "
        f"{res['videos_per_s_served']:.3f} videos/s served over {res['wall_s']:.3f} s; p50 "
        f"{res['p50_s'] * 1e3:.1f} ms, p95 {res['p95_s'] * 1e3:.1f} ms; batch sizes "
        f"{stats['batch_size_histogram']}, mean batch exec {stats['mean_batch_exec_ms']:.1f} ms, "
        f"mean wait {stats['mean_wait_ms']:.1f} ms; warm-up of buckets {batcher.buckets} "
        f"{warm_s:.2f} s; K1/K2 launches {n[0]}/{n[1]}")
    if (res["requests_ok"] != n_requests or res["errors"] or stats["requests"] != n_requests
            or n != (0, 0)):
        raise SystemExit(f"artifact: serving the student failed ({res}, stats {stats}, K1/K2 {n})")
    out["student"].update(served=res, stats=stats, warm_s=warm_s,
                          launches={"mcf_inverse": n[0], "macow_unit_inverse": n[1]})
    return out


def _parallel_run(card, backend, spec, n_microbatches=1):
    """One spawned dry run at full width under ``backend`` (its ranks hold
    every leg against its one-process run, or the run raises), with the
    microbatched leg when ``n_microbatches`` > 1; the launch counts checked,
    and the ranks' figures printed."""
    t0 = time.perf_counter()
    reports = dryrun.run(PARALLEL_NPROC, "cuda", backend, full=True, timeout=PARALLEL_TIMEOUT_S,
                         steps_per_level=STEPS_PER_LEVEL, n_microbatches=n_microbatches)
    wall = time.perf_counter() - t0
    units = 4 * sum(spec.flow.num_steps)
    legs = {"ok": [r["ok"] for r in reports], "fsdp": [r["fsdp"] for r in reports]}
    for r in reports:
        log(f"parallel [{card}]: rank {r['rank']} on {r['device']} ({r['backend']}): probe "
            + ", ".join(f"{k} {v if isinstance(v, str) else f'{v:.1f} ms'}"
                        for k, v in r["probe"].items()))
        for leg in r["ok"] + [r["fsdp"]]:
            log(f"parallel [{card}]: rank {r['rank']} {'fsdp' if leg['fsdp'] else 'train'} mesh "
                f"{leg['mesh']}: step ms {', '.join(f'{x:.1f}' for x in leg['step_ms'])}; peak "
                f"{leg['peak_gib']:.2f} GiB; against one process "
                + ", ".join(f"{k} {v:.3g} (tolerance {dryrun.TRAIN_TOLS['cuda'][k]})"
                            for k, v in leg["errs"].items())
                + f"; K1/K2 launches in the steps {leg['launches']}")
        sp, sa = r["seqpar"], r["sample"]
        log(f"parallel [{card}]: rank {r['rank']} seqpar {sp['mesh']} T={sp['t']}: "
            f"{sp['ms']:.1f} ms, |mu - dense| {sp['max_abs_err']:.3g}; sample {sa['mesh']}: "
            + "; ".join(f"{k} {sa[k]['ms']:.1f} ms, |video - one process| "
                        f"{sa[k]['max_abs_err']:.3g}, launches {sa[k]['launches']}"
                        for k in ("z_fixed", "z_drawn")))
    micro = [r["micro"] for r in reports if "micro" in r]
    tols = dryrun.TRAIN_TOLS["cuda"]
    for r in (r for r in reports if "micro" in r):
        leg = r["micro"]
        log(f"parallel [{card}]: rank {r['rank']} microbatched train mesh {leg['mesh']}, "
            f"n_microbatches {leg['n_microbatches']}: step ms "
            f"{', '.join(f'{x:.1f}' for x in leg['step_ms'])}; peak {leg['peak_gib']:.2f} GiB; "
            f"one-process reference {leg['ref_s']:.1f} s, leg {leg['leg_s']:.1f} s; against one "
            "process " + ", ".join(f"{k} {v:.3g} (tolerance {tols[k]})"
                                   for k, v in leg["errs"].items())
            + f"; K1/K2 launches in the steps {leg['launches']}")
    if len(micro) != (PARALLEL_NPROC if n_microbatches > 1 else 0) or not all(
            dryrun.held(leg, tols) and leg["n_microbatches"] == n_microbatches
            for leg in micro):
        raise SystemExit(f"parallel: the microbatched leg left the one-process step: {micro}")
    bad = [leg for r in reports for leg in r["ok"] + [r["fsdp"]] + [r[k] for k in ("micro",) if k in r]
           if leg["launches"] != {"mcf_inverse": 0, "macow_unit_inverse": 0}]
    bad += [r["sample"] for r in reports for k in ("z_fixed", "z_drawn")
            if r["sample"][k]["launches"] != {"mcf_inverse": 0, "macow_unit_inverse": units}]
    if bad or any(r["backend"] != backend for r in reports):
        raise SystemExit(f"parallel: a leg launched otherwise than it should: {bad}")
    if micro:
        log(f"parallel [{card}]: microbatched leg ({PARALLEL_NPROC} ranks, {backend}, ZeRO-1, "
            f"n_microbatches={n_microbatches}) held, one-process reference and leg "
            f"{max(x['ref_s'] + x['leg_s'] for x in micro):.1f} s")
    log(f"parallel [{card}]: {PARALLEL_NPROC} ranks under {backend}: every leg held, "
        f"{wall:.1f} s")
    return {"backend": backend, "wall_s": wall, "reports": reports, "legs": legs, "micro": micro}


def phase_parallel(card, spec):
    """The parallel slice at full width (``parallel/dryrun``): PARALLEL_NPROC
    ranks on this card over gloo and, with as many cards, one rank per card
    over NCCL; the gloo run adds the microbatched leg.  The launch counts
    are the ranks' own, zeroed and read around each driven call."""
    t_phase = time.perf_counter()
    out = {"gloo": _parallel_run(card, "gloo", spec, PARALLEL_MICROBATCHES)}
    if torch.cuda.device_count() >= PARALLEL_NPROC:
        out["nccl"] = _parallel_run(card, "nccl", spec)
    else:
        log(f"parallel [{card}]: NCCL across cards not run: {torch.cuda.device_count()} card(s) "
            f"visible, {PARALLEL_NPROC} ranks need one each")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"parallel: the phase took {out['phase_s']:.1f} s")
    return out


def train_config(entry, b=BATCH, steps=TRAIN_STEPS):
    """An in-memory config that trains the registry model ``entry`` at full
    width and depth on the synthetic dataset: torch-Adam, lr 1e-3 after a
    warm-up of 2 steps, weight decay 1e-5."""
    wrapper = {"min_spatial_size": entry.min_spatial_size}
    return {
        "general": {"experiment": "chip_smoke", "seed": 0},
        "first_stage": {"registry": entry.name},
        "poke_embedder": {"spec": dict(wrapper, nf_max=entry.nf_max_poke)},
        "conditioner": {"use": True, "spec": dict(wrapper, nf_max=entry.nf_max_cond)},
        # JAX's training order with zero pokes (configs/second_stage.yaml), an
        # epoch of 2 + steps batches
        "data": {"dataset": "SyntheticDataset", "spatial_size": [entry.spatial_size] * 2,
                 "max_frames": entry.max_frames, "batch_size": b, "n_examples": (2 + steps) * b,
                 "zero_poke": True, "zero_poke_amount": 12, "n_workers": 4},
        "architecture": {"num_steps": list(entry.num_steps), "factor": entry.factor,
                         "flow_mid_channels_factor": entry.flow_mid_channels_factor,
                         "kernel_size": [2, 3], "transform": "affine", "prior_transform": "affine",
                         "activation": "elu", "condition_nice": False, "augmented_input": False},
        "training": {"lr": 1e-3, "weight_decay": 1e-5, "lr_scaling_max_it": 2, "n_epochs": 1,
                     "max_batches_per_epoch": 1 + steps},
    }


def _flat(tree, prefix=""):
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        return {k2: v2 for k, v in items for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    return {prefix: tree}


def phase_train(device, card, entry, steps=TRAIN_STEPS):
    """The training path: ``experiments/second_stage.train`` on ``entry`` at
    full width and all its levels on STEPS_PER_LEVEL MaCowSteps each,
    B=8, one warm-up step then ``steps`` timed steps;
    the launch counters read around it (neither kernel is on a train step).
    Then: the trained float leaves moved and the frozen and integer leaves
    did not (against a fresh ``init`` from the same seed); ``last.npz``
    reloads through ``ckpt/io`` and the bridge to the trained params bitwise;
    and ``transformer.reverse(transformer.forward(x))`` on 'cuda_unit' returns
    the batch's motion latent within TRAIN_TOL with 4 K2 launches per
    MaCowStep."""
    spec = cut_spec(registry.build_specs(entry), STEPS_PER_LEVEL)
    config = train_config(entry, steps=steps)
    config["architecture"]["num_steps"] = list(spec.flow.num_steps)
    # the epoch is one batch longer than the run, so it never ends and nothing
    # validates here: the eval phase validates, at a depth that saves in seconds
    config["training"]["max_batches_per_epoch"] = 2 + steps
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        dirs = {k: os.path.join(tmp, k) for k in ("ckpt", "config", "generated", "log")}
        free_gb = shutil.disk_usage(tmp).free / 1e9
        k1.mcf_inverse.launches = 0
        k2.macow_unit_inverse.launches = 0
        torch.cuda.reset_peak_memory_stats()
        run = experiment.train(config, dirs, device=device, max_steps=1 + steps)
        n_step = (k1.mcf_inverse.launches, k2.macow_unit_inverse.launches)
        peak = torch.cuda.max_memory_allocated() / 2**30
        if run["spec"] != spec:
            raise SystemExit(f"train: the config's spec is not the registry's {entry.name} "
                             f"on {spec.flow.num_steps} MaCowSteps")
        hist = run["history"]
        for i, h in enumerate(hist):
            log(f"train [{card}]: step {i}{' (warm-up)' if i == 0 else ''}: flow_loss "
                f"{h['flow_loss']:.6g}, nll {h['nll_loss']:.6g}, nlogdet {h['nlogdet_loss']:.6g}, "
                f"grad_norm {h['grad_norm']:.6g}, {h['step_s'] * 1e3:.1f} ms")
        step_ms = [h["step_s"] * 1e3 for h in hist]
        timed = sorted(step_ms[1:])
        median = timed[len(timed) // 2]
        n_params = sum(t.numel() for t in train_ss.leaves(run["state"].params))
        ckpt_gb = os.path.getsize(run["ckpt"]) / 1e9
        log(f"train [{card}]: {entry.name} full width, {sum(spec.flow.num_steps)} MaCowSteps in "
            f"{len(spec.flow.num_steps)} levels, {n_params / 1e9:.3f} G trainable params, B={BATCH}, "
            f"{entry.max_frames} frames of {entry.spatial_size}^2: init {run['init_s']:.2f} s; step "
            f"first {step_ms[0]:.1f} ms, median of {steps} {median:.1f} ms; peak "
            f"{peak:.2f} GiB; K1/K2 launches in the steps {n_step[0]}/{n_step[1]}; last.npz "
            f"{ckpt_gb:.2f} GB written in {run['save_s']:.1f} s ({free_gb:.0f} GB free before)")
        if not all(np.isfinite(h["flow_loss"]) and np.isfinite(h["grad_norm"]) for h in hist):
            raise SystemExit("train: a loss or grad norm is not finite")
        if n_step != (0, 0):
            raise SystemExit(f"train: a kernel launched in a train step: K1/K2 {n_step}")

        trained = {**run["frozen"], **run["state"].params}
        start = _flat(second_stage.init(prng.prng_key(config["general"]["seed"]), spec, device))
        moved = kept = 0
        for k, v in _flat(trained).items():
            same = torch.equal(v.detach(), start[k])
            trainable = k.split("/")[1] in train_ss.TRAINABLE_KEYS and v.is_floating_point()
            if trainable:
                moved += not same
            elif not same:
                raise SystemExit(f"train: the frozen or integer leaf {k} changed")
            else:
                kept += 1
        n_float = sum(v.is_floating_point() for v in train_ss.leaves(run["state"].params))
        del start
        t0 = time.perf_counter()
        saved, meta = io.load(run["ckpt"])
        back = _flat(bridge_second_stage(saved["params"], spec, device))
        load_s = time.perf_counter() - t0
        ckpt_ok = back.keys() == _flat(run["state"].params).keys() and all(
            torch.equal(back[k], v.detach()) for k, v in _flat(run["state"].params).items())
        del saved, back
        log(f"train: {moved} of {n_float} trainable float leaves moved, {kept} frozen and integer "
            f"leaves bitwise as initialised; last.npz (step {meta['step']}) reloads to the trained "
            f"params bitwise: {ckpt_ok} ({load_s:.1f} s)")
        if moved < n_float // 2 or not ckpt_ok or meta["step"] != 1 + steps:
            raise SystemExit("train: the params did not move, or last.npz does not reload to them")

    batch = to_device(next(iter(StaticDataModule(config["data"]).loader("val"))), device,
                      ("images", "poke"))
    flow = run["state"].params["flow"]
    with torch.no_grad():
        x, _ = second_stage.encode_first_stage(trained, spec, batch["images"])
        cond = second_stage.embed_cond(trained, spec, batch["images"][:, 0], batch["poke"])
        z, logdet = transformer.forward(flow, spec.flow, x, cond)
        k1.mcf_inverse.launches = 0
        k2.macow_unit_inverse.launches = 0
        x_back = transformer.reverse(flow, replace(spec.flow, mcf_backend="cuda_unit"), z, cond)
        torch.cuda.synchronize()
        n_rt = (k1.mcf_inverse.launches, k2.macow_unit_inverse.launches)
    err = (x_back - x).abs().max().item()
    log(f"train: round trip on the trained params: max |reverse(forward(x)) - x| {err:.3g} "
        f"(tolerance {TRAIN_TOL}; |x| up to {x.abs().max().item():.3g}, logdet "
        f"{logdet.mean().item():.6g}); K1/K2 launches {n_rt[0]}/{n_rt[1]} (want 0/"
        f"{4 * sum(spec.flow.num_steps)})")
    if not err <= TRAIN_TOL or n_rt != (0, 4 * sum(spec.flow.num_steps)):
        raise SystemExit(f"train: the round trip failed ({err}, K1/K2 launches {n_rt})")
    phase_s = time.perf_counter() - t_phase
    log(f"train: the phase took {phase_s:.1f} s")
    return {"phase_s": phase_s, "init_s": run["init_s"], "save_s": run["save_s"],
            "load_s": load_s, "step_ms_first": step_ms[0], "step_ms_median": median,
            "step_ms": step_ms, "peak_gib": peak, "flow_loss": [h["flow_loss"] for h in hist],
            "grad_norm": [h["grad_norm"] for h in hist], "ckpt_gb": ckpt_gb,
            "roundtrip_max_abs_err": err,
            "launches": {"mcf_inverse": n_step[0], "macow_unit_inverse": n_step[1]},
            "roundtrip_launches": {"mcf_inverse": n_rt[0], "macow_unit_inverse": n_rt[1]}}


def _npz_meta(path):
    """The metadata of an npz checkpoint, without reading its arrays."""
    with np.load(path) as f:
        return json.loads(bytes(f["__metadata__"]).decode())


def _preempt(cfg_path, name, at_step, timeout_s=RESUME_TIMEOUT_S):
    """``python -m ipoke_tpu_torch.main`` training ``cfg_path`` in a child
    process, sent SIGTERM once its log shows step ``at_step``: (return code,
    its output, seconds from the signal to its exit).  The child is killed
    if it outlives ``timeout_s``."""
    proc = subprocess.Popen([sys.executable, "-m", "ipoke_tpu_torch.main", "-c", cfg_path, "-m",
                             name], cwd=str(ROOT), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines, t_sig = [], None
    timer = threading.Timer(timeout_s, proc.kill)
    timer.start()
    try:
        for line in proc.stdout:
            lines.append(line)
            if t_sig is None and line.startswith(f"step {at_step}:"):
                t_sig = time.perf_counter()
                proc.send_signal(signal.SIGTERM)
        rc = proc.wait()
        exit_s = time.perf_counter() - t_sig if t_sig is not None else float("nan")
    finally:
        timer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return rc, "".join(lines), exit_s


def phase_resume(device, card, entry, tmp, steps=RESUME_STEPS):
    """Resumption at full width (``entry``, B=8, the train phase's config
    and cut depth): stage-2 training through ``python -m
    ipoke_tpu_torch.main`` in a child process, sent SIGTERM once its log
    shows step RESUME_SIGNAL_AT; it must exit 0 with ``last.npz`` saved
    after the step in flight (``preempted: True`` and that step).  Then
    ``main --resume --max-steps steps`` in this process, the launch counters
    zeroed just before it and read just after: the train state restored from
    that ``last.npz`` must equal it bitwise (params, moments, counts), the
    first resumed step must run at the schedule's lr of the saved count, and
    the run must go on from the saved step for ``steps`` steps (the eval
    phase's resumed run holds ``metrics.jsonl`` going on: with JAX's
    ``log_every`` of 50 these steps write no record).  Prints the seconds from
    the signal to the child's exit, the load and restore seconds, the first
    resumed step's ms and the checkpoint's GB."""
    t_phase = time.perf_counter()
    config = train_config(entry, steps=RESUME_EPOCH)
    config["architecture"]["num_steps"] = list(
        cut_spec(registry.build_specs(entry), STEPS_PER_LEVEL).flow.num_steps)
    config["general"].update(experiment="second_stage", base_dir=os.path.join(tmp, "logs"))
    config["training"].update(max_batches_per_epoch=RESUME_EPOCH)
    cfg_path = _write_config(os.path.join(tmp, "resume.yaml"), config)
    rc, out, exit_s = _preempt(cfg_path, "resume", RESUME_SIGNAL_AT)
    stepped = [int(m) for m in re.findall(r"^step (\d+):", out, re.M)]
    ckpt_dir = os.path.join(tmp, "logs", "second_stage", "ckpt", "resume", "0")
    last = os.path.join(ckpt_dir, "last.npz")
    meta = _npz_meta(last) if os.path.exists(last) else None
    ckpt_gb = os.path.getsize(last) / 1e9 if meta else float("nan")
    log(f"resume [{card}]: preempted run (child process, {entry.name} full width, "
        f"{sum(config['architecture']['num_steps'])} MaCowSteps): steps "
        f"{stepped}, SIGTERM once step {RESUME_SIGNAL_AT} was logged; exit code {rc} "
        f"{exit_s:.1f} s after the signal; last.npz {ckpt_gb:.2f} GB, metadata {meta}")
    if (rc != 0 or not stepped or meta != {"step": stepped[-1], "preempted": True}
            or not RESUME_SIGNAL_AT <= stepped[-1] <= RESUME_SIGNAL_AT + 1):
        raise SystemExit(f"resume: the preempted run did not save after the step in flight "
                         f"(rc {rc}, meta {meta}):\n{out[-4000:]}")
    k = stepped[-1]

    restore, checked, lrs = experiment.restore_train_state, {}, []

    def checking(tree, optimizer, template, spec, dev=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = restore(tree, optimizer, template, spec, dev)
        torch.cuda.synchronize()
        checked["restore_s"] = time.perf_counter() - t0
        a, b = io._flatten(experiment.ckpt_tree(state, optimizer, spec)), io._flatten(tree)
        bad = [key for key in b if key not in a or np.asarray(a[key]).dtype != np.asarray(b[key]).dtype
               or not np.array_equal(a[key], b[key])]
        checked.update(leaves=len(b), bad=bad + sorted(a.keys() - b.keys()),
                       counts=[s.get("count") for s in state.opt_state], step=state.step)
        return state

    def recording(self, updates, state, params):
        lrs.append((state["count"], self.schedule(state["count"])))
        return schedule_update(self, updates, state, params)

    schedule_update = train_ss._ScaleBySchedule.update
    experiment.restore_train_state, train_ss._ScaleBySchedule.update = checking, recording
    try:
        _zero_counts()
        t0 = time.perf_counter()
        run = port_main.main(["-c", cfg_path, "-m", "resume", "--resume", "--max-steps",
                              str(steps), "--device", "cuda"])
        resume_s = time.perf_counter() - t0
        n = _counts()
    finally:
        experiment.restore_train_state, train_ss._ScaleBySchedule.update = restore, schedule_update
    cfg_t = config["training"]
    schedule = lr_schedule(cfg_t["lr"], cfg_t["lr_scaling_max_it"],
                           cfg_t["n_epochs"] * cfg_t["max_batches_per_epoch"])
    hist = run["history"]
    first_ms = hist[0]["step_s"] * 1e3 if hist else float("nan")
    log(f"resume [{card}]: main --resume: restored step {checked.get('step')} from last.npz "
        f"({run['resume'].get('load_s', float('nan')):.1f} s load, "
        f"{checked.get('restore_s', float('nan')):.1f} s restore onto the card), "
        f"{checked.get('leaves')} leaves checked, {len(checked.get('bad', [None]))} differ; "
        f"optimizer counts {checked.get('counts')}; first resumed step at count/lr {lrs[:1]} "
        f"(schedule({k}) = {schedule(k):.6g}, schedule(0) = {schedule(0):.6g}); steps "
        f"{[round(h['step_s'] * 1e3, 1) for h in hist]} ms; "
        f"last.npz saved in {run['save_s']:.1f} s; the resume {resume_s:.1f} s; K1/K2 "
        f"launches {n[0]}/{n[1]}")
    if (checked.get("bad") != [] or checked.get("step") != k or run["start_step"] != k
            or run["state"].step != k + steps or not lrs or lrs[0] != (k, schedule(k))
            or len(hist) != steps or n != (0, 0)
            or not all(np.isfinite(h["flow_loss"]) for h in hist)):
        raise SystemExit(f"resume: the resumed run is not the saved one going on: {checked}, "
                         f"lr {lrs[:2]}, {len(hist)} steps run, K1/K2 {n}")
    phase_s = time.perf_counter() - t_phase
    log(f"resume: the phase took {phase_s:.1f} s")
    return {"phase_s": phase_s, "preempted_step": k, "signal_to_exit_s": exit_s,
            "ckpt_gb": ckpt_gb, "load_s": run["resume"]["load_s"],
            "restore_s": checked["restore_s"], "first_step_ms": first_ms,
            "step_ms": [h["step_s"] * 1e3 for h in hist], "save_s": run["save_s"],
            "resume_s": resume_s, "lr": lrs[0][1], "leaves_checked": checked["leaves"],
            "launches": {"mcf_inverse": n[0], "macow_unit_inverse": n[1]}}


def stage1_config(entry, b=BATCH, steps=STAGE1_STEPS):
    """An in-memory config that trains the first stage of the registry model
    ``entry`` at full width as configs/first_stage.yaml does (lr 2e-4, weight
    decay 1e-5, w_vgg = w_l1 = 10, w_kl 1e-7, the temporal disc's gp weight
    1 on mf_dt = the data's frames, 16 spatial examples) on the synthetic
    dataset."""
    ss = entry.spatial_size
    return {
        "general": {"experiment": "chip_smoke_stage1", "seed": 0},
        "data": {"dataset": "SyntheticDataset", "spatial_size": [ss, ss],
                 "max_frames": entry.max_frames, "batch_size": b, "n_examples": (1 + steps) * b,
                 "zero_poke": True, "zero_poke_amount": 12, "n_workers": 4},
        "architecture": {"z_dim": entry.fs_z_dim,
                         "ENC_M_channels": list(registry.default_enc_channels(ss)),
                         "dec_channels": list(registry.default_dec_channels(ss)),
                         "n_gru_layers": 4, "min_spatial_size": entry.min_spatial_size,
                         "motion_bias": True, "deterministic": False, "spectral_norm": True},
        "training": {"lr": 2e-4, "weight_decay": 1e-5, "gamma": 0.98, "n_epochs": 1,
                     "max_batches_per_epoch": 1 + steps, "full_sequence": True,
                     "w_vgg": 10, "w_l1": 10, "w_kl": 1e-7, "max_val_batches": 1},
        "d_t": {"max_frames": 12, "gp_weight": 1.0},
        "d_s": {"gp_weight": 0.0, "n_examples": 16},
    }


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.detach().cpu()


def _gp(specs_dt, dt_params, x):
    """The temporal disc's gradient penalty on ``x`` with ``dt_params``
    spectral-normed, as the train step computes it."""
    p_sn = materialize_spectral_norm(dt_params)
    x = x.detach().requires_grad_(True)
    pred, _ = temp_disc_apply(p_sn, x, specs_dt)
    return gradient_penalty(pred, x).item()


def phase_stage1(device, card, entry, steps=STAGE1_STEPS, b=BATCH):
    """Stage-1 cVAE-GAN training: ``experiments/first_stage.train`` on the
    first stage of ``entry`` at full width from JAX's init at seed 0,
    synthetic batches of ``b`` videos, one warm-up step then ``steps`` timed
    steps; the launch counters read around it (no kernel is on a stage-1
    step).  Checked: every loss of every step finite; the trainable leaves of
    all three nets moved (against a fresh ``init_gan_state`` of the seed);
    both discriminators' ``u`` refreshed and the generator's as drawn;
    ``last.npz`` reloads through ``ckpt/io`` and the bridge to the trained
    nets bitwise, ``u`` included; and the temporal disc's gradient penalty on
    one example on the card equals the CPU's on the same weights (JAX's init;
    the trained disc's penalty is ~1e-4 of it) within
    STAGE1_GP_TOL (1 + |gp_cpu|)."""
    config = stage1_config(entry, b, steps)
    fs_spec, ds_spec, dt_spec, _ = experiment_fs.specs_from_config(config)
    if fs_spec != registry.build_specs(entry).first_stage:
        raise SystemExit(f"stage1: the config's first stage is not the registry's {entry.name}")
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_stage1_") as tmp:
        dirs = {k: os.path.join(tmp, k) for k in ("ckpt", "config", "generated", "log")}
        _zero_counts()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        run = experiment_fs.train(config, dirs, device=device, max_steps=1 + steps)
        n_step = _counts()
        peak = torch.cuda.max_memory_allocated() / 2**30 if device.type == "cuda" else 0.0
        hist, state = run["history"], run["state"]
        keys = list(hist[0].keys() - {"step_s"})
        for i, h in enumerate(hist):
            log(f"stage1 [{card}]: step {i}{' (warm-up)' if i == 0 else ''}: "
                + ", ".join(f"{k} {h[k]:.6g}" for k in sorted(keys)) + f"; {h['step_s'] * 1e3:.1f} ms")
        step_ms = [h["step_s"] * 1e3 for h in hist]
        median = _median(step_ms[1:])
        launches = sum(n_step) / len(hist)
        n_params = {n: sum(t.numel() for t in train_ss.float_leaves(
            train_fs.trainable(getattr(state, f"{n}_params")))) for n in train_fs.NETS}
        log(f"stage1 [{card}]: {entry.name} first stage full width (z {fs_spec.z_dim}, encoder "
            f"{fs_spec.enc_channels}, decoder {fs_spec.dec_channels}, {fs_spec.n_gru_layers} GRU "
            f"layers), temporal disc ResNet-18 3D on {dt_spec.sequence_length} frames, patch disc "
            f"ndf {ds_spec.ndf}, VGG19 on {2 * b * (entry.max_frames - 1)} frames; trainable params "
            + ", ".join(f"{n} {v / 1e6:.2f} M" for n, v in n_params.items())
            + f"; B={b}, {entry.max_frames} frames of {entry.spatial_size}^2, f32: init "
            f"{run['init_s']:.2f} s; step first {step_ms[0]:.1f} ms, median of {steps} {median:.1f} "
            f"ms; peak {peak:.2f} GiB; K1/K2 launches in the steps {n_step[0]}/{n_step[1]} "
            f"({launches:g} per step)")
        if not all(np.isfinite(h[k]) for h in hist for k in keys):
            raise SystemExit("stage1: a loss is not finite")
        if n_step != (0, 0):
            raise SystemExit(f"stage1: a kernel launched in a stage-1 step: K1/K2 {n_step}")

        start, _ = train_fs.init_gan_state(prng.prng_key(config["general"]["seed"]), fs_spec,
                                           ds_spec, dt_spec, device=device)
        moved = {}
        for n in train_fs.NETS:
            now, then = _flat(getattr(state, f"{n}_params")), _flat(getattr(start, f"{n}_params"))
            trained = [k for k in now if not k.endswith("/u")]
            moved[n] = sum(not torch.equal(now[k].detach(), then[k]) for k in trained)
            u_same = [torch.equal(now[k], then[k]) for k in now if k.endswith("/u")]
            log(f"stage1: {n}: {moved[n]} of {len(trained)} trainable leaves moved; "
                f"{len(u_same) - sum(u_same)} of {len(u_same)} u refreshed")
            if moved[n] < len(trained) // 2 or (all(u_same) if n != "gen" else not all(u_same)):
                raise SystemExit(f"stage1: {n} did not train as it should")
        gp_dt = start.dt_params
        del start
        t0 = time.perf_counter()
        saved, meta = io.load(run["ckpt"])
        back = bridge_gan_params(saved, device)
        load_s = time.perf_counter() - t0
        ckpt_ok = meta["step"] == 1 + steps and all(
            _flat(back[f"{n}_params"]).keys() == _flat(getattr(state, f"{n}_params")).keys()
            and all(torch.equal(v, _flat(getattr(state, f"{n}_params"))[k].detach())
                    for k, v in _flat(back[f"{n}_params"]).items())
            for n in train_fs.NETS)
        ckpt_gb = os.path.getsize(run["ckpt"]) / 1e9
        del saved, back
        log(f"stage1: last.npz ({ckpt_gb:.3f} GB, step {meta['step']}, written in "
            f"{run['save_s']:.1f} s) reloads to the trained nets bitwise, u included: {ckpt_ok} "
            f"({load_s:.1f} s)")
        if not ckpt_ok:
            raise SystemExit("stage1: last.npz does not reload to the trained nets")
        # the epoch's end validated (one val batch) and kept its top-k checkpoint;
        # test finds it and validates the best generator again
        vals = run["val"]
        val_keys = ("FVD-val", "ssim-val", "psnr-val", "lpips-val")
        val = {k: vals[-1][k] for k in val_keys} if vals else {}
        best = io.find_best(run["ckpt_dir"])
        log(f"stage1 [{card}]: validation at step {[v['step'] for v in vals]}: "
            + ", ".join(f"{k} {v:.6g}" for k, v in val.items())
            + f" ({sum(v['val_s'] for v in vals):.1f} s, top-k save {sum(v['save_s'] for v in vals):.1f}"
            f" s); best {os.path.basename(best or '')}")
        if [v["step"] for v in vals] != [1 + steps] or not all(np.isfinite(v) for v in val.values()):
            raise SystemExit(f"stage1: the epoch's end was not validated as JAX's schedule says: {vals}")
        test_timings = {}
        _zero_counts()
        t0 = time.perf_counter()
        tested = experiment_fs.test(config, dirs, device=device, timings=test_timings)
        test_s = time.perf_counter() - t0
        n_test = _counts()
        test_err = max(abs(tested[k] - val[k]) / (1 + abs(val[k])) for k in val_keys)
        log(f"stage1 [{card}]: test (find_best, then validate on 1 batch of {b}): "
            + ", ".join(f"{k} {tested[k]:.6g}" for k in val_keys)
            + f"; {test_s:.1f} s (" + ", ".join(f"{k} {v:.2f}" for k, v in test_timings.items())
            + f"); max relative difference from the trainer's validation {test_err:.3g} (tolerance "
            f"{STAGE1_TEST_TOL}); K1/K2 launches {n_test[0]}/{n_test[1]}")
        if not test_err <= STAGE1_TEST_TOL or n_test != (0, 0):
            raise SystemExit(f"stage1: test of the best checkpoint disagrees: {tested} vs {val}")

    example = next(iter(StaticDataModule(config["data"]).loader("val")))["images"][:1]
    x = torch.from_numpy(example[:, :dt_spec.sequence_length])
    gp_card = _gp(dt_spec, gp_dt, x.to(device))
    with torch.backends.mkldnn.flags(enabled=False):   # oneDNN's f32 convs round coarser
        cpu_params = _to_cpu(gp_dt)
        t0 = time.perf_counter()
        gp_cpu = _gp(dt_spec, cpu_params, x)
        cpu_s = time.perf_counter() - t0
    gp_err = abs(gp_card - gp_cpu)
    log(f"stage1: gradient penalty of the initial temporal disc on one example (1 x "
        f"{dt_spec.sequence_length} frames of {entry.spatial_size}^2): card {gp_card:.9g}, CPU "
        f"{gp_cpu:.9g} ({cpu_s:.1f} s), |diff| {gp_err:.3g} (tolerance {STAGE1_GP_TOL} x (1 + |CPU|))")
    if not gp_err <= STAGE1_GP_TOL * (1 + abs(gp_cpu)):
        raise SystemExit(f"stage1: the card's gradient penalty disagrees with the CPU's: {gp_err}")
    phase_s = time.perf_counter() - t_phase
    log(f"stage1: the phase took {phase_s:.1f} s")
    return {"phase_s": phase_s, "init_s": run["init_s"], "save_s": run["save_s"], "load_s": load_s,
            "step_ms_first": step_ms[0], "step_ms_median": median, "step_ms": step_ms,
            "peak_gib": peak, "batch": b, "losses": {k: [h[k] for h in hist] for k in sorted(keys)},
            "moved": moved, "ckpt_gb": ckpt_gb, "gp_card": gp_card, "gp_cpu": gp_cpu,
            "gp_abs_err": gp_err, "val": val, "val_s": sum(v["val_s"] for v in vals),
            "test": tested, "test_s": test_s, "test_timings": test_timings,
            "test_max_rel_diff": test_err,
            "launches": {"mcf_inverse": n_step[0], "macow_unit_inverse": n_step[1]},
            "test_launches": {"mcf_inverse": n_test[0], "macow_unit_inverse": n_test[1]}}


# the stage-1 variants and the legacy modules
POKE_VAE_STEPS = 2         # timed poke_vae GAN steps, after one warm-up step
# a forward on the card against the CPU (oneDNN off) on the same weights and
# inputs, every output relative to 1 + max|ref|: f32 convs, cuDNN against the CPU
VARIANT_TOL = 2e-4
# inverse(forward(x)) = x on the card: the JAX package's own round-trip
# tolerances (tests/test_legacy_flows.py, tests/test_legacy_models.py), and
# how many of a leg's inputs its round trip gives back (its last outputs)
LEGACY_ROUND_TOL = {"macow_v1": (2e-4, 1), "fc_flow": (1e-4, 1), "mixcdf": (5e-3, 1),
                    "leapfrog": (1e-4, 2)}


def _moved(tree, device):
    if isinstance(tree, dict):
        return {k: _moved(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_moved(v, device) for v in tree]
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def _outputs(out):
    return [o for o in (out if isinstance(out, (tuple, list)) else [out]) if o is not None]


def _card_vs_cpu(device, fn, tree, *args):
    """``fn(tree, *args)`` on the card, timed after a warm-up call, and on
    the CPU (oneDNN off) on copies of the same tree and inputs: (card
    outputs, the max error of each relative to 1 + max|CPU's|, card ms)."""
    cpu = torch.device("cpu")
    with torch.no_grad():
        t_card, a_card = _moved(tree, device), _moved(args, device)
        fn(t_card, *a_card)
        _sync(device)
        t0 = time.perf_counter()
        got = _outputs(fn(t_card, *a_card))
        _sync(device)
        ms = (time.perf_counter() - t0) * 1e3
        del t_card, a_card
        with torch.backends.mkldnn.flags(enabled=False):
            ref = _outputs(fn(_moved(tree, cpu), *_moved(args, cpu)))
    errs = [float((g.cpu() - r).abs().max() / (1 + r.abs().max())) for g, r in zip(got, ref)]
    if len(got) != len(ref) or any(tuple(g.shape) != tuple(r.shape) for g, r in zip(got, ref)):
        raise SystemExit("a forward on the card and on the CPU gave outputs of other shapes")
    return got, errs, ms


def _legacy_legs(key):
    """(name, fn(tree, *inputs), tree, inputs, index of the round trip's
    input among the outputs or None) at the JAX package's test widths; a
    flow's fn returns its forward, its logdet and inverse(forward(x))."""
    from ipoke_tpu_torch.flows import leapfrog, legacy, macow_v1, mixcdf
    from ipoke_tpu_torch.models import biggan, motion_generator

    rng = np.random.default_rng(0)
    arr = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))  # noqa: E731
    v1 = macow_v1.MaCowV1Spec(in_channels=8, hidden_channels=24)
    fc = legacy.FCFlowSpec(in_channels=16, embedding_dim=8, hidden_dim=32, hidden_depth=2,
                           n_flows=4)
    mc = mixcdf.MixCDFSpec(channels=8, hidden_dim=16, components=3, n_flows=2)
    lf = leapfrog.LeapFlowSpec(in_channels=12, hidden_dim=32, n_flows=3)
    mg = motion_generator.GeneratorSpec(img_size=64, z_dim=16, decoder_factor=2)
    bg = biggan.BigGANSpec(resolution=64, chn=8)

    def v1_fn(p, x):
        y, ld = macow_v1.step_v1_forward(p, x, v1)
        return y, ld, macow_v1.step_v1_inverse(p, y, v1)

    def fc_fn(p, x, e):
        z, ld = legacy.fc_flow_forward(p, fc, x, e)
        return z, ld, legacy.fc_flow_inverse(p, fc, z, e)

    def mc_fn(p, x):
        z, ld = mixcdf.flow_forward(p, x, mc)
        return z, ld, mixcdf.flow_inverse(p, z, mc)

    def lf_fn(p, x, v):
        x1, v1_, ld = leapfrog.leap_flow_forward(p, lf, x, v)
        return x1, v1_, ld, *leapfrog.leap_flow_inverse(p, lf, x1, v1_)

    return [
        ("macow_v1", v1_fn, macow_v1.init_step_v1(prng.fold_in(key, 1), v1), (arr(2, 8, 8, 8),)),
        ("fc_flow", fc_fn, legacy.init_fc_flow(prng.fold_in(key, 2), fc), (arr(4, 16), arr(4, 8))),
        ("mixcdf", mc_fn, mixcdf.init_flow(prng.fold_in(key, 3), mc), (arr(2, 8, 8, 8),)),
        ("leapfrog", lf_fn, leapfrog.init_leap_flow(prng.fold_in(key, 4), lf),
         (arr(4, 12), arr(4, 12))),
        ("biggan", lambda p, z, c: biggan.apply(p, z, c, bg), biggan.init(prng.fold_in(key, 5), bg),
         (arr(2, 100), arr(2, 128))),
        ("motion_generator", lambda p, img, m: motion_generator.apply(p, img, m, mg),
         motion_generator.init(prng.fold_in(key, 6), mg), (arr(2, 64, 64, 3), arr(2, 16))),
    ]


def phase_stage1_variants(device, card, entry, steps=POKE_VAE_STEPS, b=BATCH):
    """The stage-1 model variants and the legacy modules on the card.

    poke_vae: ``experiments/first_stage.train`` with ``architecture.baseline:
    poke_vae`` on ``stage1_config`` (``entry``'s first stage at full width;
    the PokeVAE from JAX's init at seed 1, the discriminators at seed 0),
    one warm-up step then ``steps`` timed steps, the epoch's validation on
    one batch, then ``test`` on the best checkpoint.  Checked: every loss
    finite, the trainable leaves of all three nets moved, ``last.npz``
    reloads bitwise through the bridge (``u`` kept), ``test`` gives the
    validation again; one ``poke_vae_forward`` of a video on the card
    against the CPU's on the trained weights (VARIANT_TOL); one
    ``sample_prior`` call at B=``b`` finite in [-1, 1].
    Parity legs: ``rnn_motion_forward`` and ``fc_baseline_forward`` (one
    more decoder stage and one more encoder layer for 128^2 from a 4x4
    start) at the same width from JAX's init, timed at B=``b``, one video
    on the card against the CPU; a MaCow v1 step, the FC, mix-CDF and
    leapfrog flows, a BigGAN and a motion-generator forward at the widths
    of the JAX package's own tests, each on the card against the CPU, the
    flows' round trips within LEGACY_ROUND_TOL.  No kernel launches in the
    phase."""
    from ipoke_tpu_torch.models import variants

    config = stage1_config(entry, b, steps)
    config["general"]["experiment"] = "chip_smoke_poke_vae"
    config["architecture"]["baseline"] = "poke_vae"
    fs_spec, ds_spec, dt_spec, _ = experiment_fs.specs_from_config(config)
    pv_spec = experiment_fs.poke_vae_spec(config, fs_spec)
    seed = config["general"]["seed"]
    t_phase = time.perf_counter()
    _zero_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_poke_vae_") as tmp:
        dirs = {k: os.path.join(tmp, k) for k in ("ckpt", "config", "generated", "log")}
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        run = experiment_fs.train(config, dirs, device=device, max_steps=1 + steps)
        n_step = _counts()
        peak = torch.cuda.max_memory_allocated() / 2**30 if device.type == "cuda" else 0.0
        hist, state = run["history"], run["state"]
        keys = sorted(hist[0].keys() - {"step_s"})
        step_ms = [h["step_s"] * 1e3 for h in hist]
        n_params = sum(t.numel() for t in train_ss.float_leaves(
            train_fs.trainable(state.gen_params)))
        log(f"poke_vae [{card}]: the PokeVAE on {entry.name}'s first stage at full width (z "
            f"{fs_spec.z_dim}, encoder {fs_spec.enc_channels}, decoder {fs_spec.dec_channels}, "
            f"{fs_spec.n_gru_layers} GRU layers, a {pv_spec.poke_enc_spec.n_stages}-stage poke "
            f"encoder), {n_params / 1e6:.2f} M trainable; B={b}, {entry.max_frames} frames of "
            f"{entry.spatial_size}^2, f32: init {run['init_s']:.2f} s; step first "
            f"{step_ms[0]:.1f} ms, then {', '.join(f'{x:.1f}' for x in step_ms[1:])} ms; peak "
            f"{peak:.2f} GiB; K1/K2 launches in the steps {n_step[0]}/{n_step[1]}")
        for i, h in enumerate(hist):
            log(f"poke_vae: step {i}: " + ", ".join(f"{k} {h[k]:.6g}" for k in keys))
        if not all(np.isfinite(h[k]) for h in hist for k in keys):
            raise SystemExit("poke_vae: a loss is not finite")
        base, _ = train_fs.init_gan_state(prng.prng_key(seed), fs_spec, ds_spec, dt_spec,
                                          device=device)
        start = {"gen": variants.init_poke_vae(prng.prng_key(seed + 1), pv_spec, device),
                 "ds": base.ds_params, "dt": base.dt_params}
        del base
        moved = {}
        for n in train_fs.NETS:
            now, then = _flat(getattr(state, f"{n}_params")), _flat(start[n])
            trained = [k for k in now if not k.endswith("/u")]
            moved[n] = sum(not torch.equal(now[k].detach(), then[k]) for k in trained)
            log(f"poke_vae: {n}: {moved[n]} of {len(trained)} trainable leaves moved")
            if moved[n] < len(trained) // 2:
                raise SystemExit(f"poke_vae: {n} did not train")
        del start
        saved, meta = io.load(run["ckpt"])
        back = bridge_gan_params(saved, device)
        ckpt_ok = (meta["step"] == 1 + steps and "u" in back["gen_params"]["poke_enc"]["stem"]["conv"]
                   and all(_flat(back[f"{n}_params"]).keys() == _flat(getattr(state, f"{n}_params")).keys()
                           and all(torch.equal(v, _flat(getattr(state, f"{n}_params"))[k].detach())
                                   for k, v in _flat(back[f"{n}_params"]).items())
                           for n in train_fs.NETS))
        ckpt_gb = os.path.getsize(run["ckpt"]) / 1e9
        del saved, back
        log(f"poke_vae: last.npz ({ckpt_gb:.3f} GB, step {meta['step']}) reloads to the trained "
            f"nets bitwise, u included: {ckpt_ok}")
        if not ckpt_ok:
            raise SystemExit("poke_vae: last.npz does not reload to the trained nets")
        val_keys = ("FVD-val", "ssim-val", "psnr-val", "lpips-val")
        vals = run["val"]
        if [v["step"] for v in vals] != [1 + steps]:
            raise SystemExit(f"poke_vae: the epoch's end was not validated: {vals}")
        val = {k: vals[-1][k] for k in val_keys}
        t0 = time.perf_counter()
        tested = experiment_fs.test(config, dirs, device=device)
        test_s = time.perf_counter() - t0
        test_err = max(abs(tested[k] - val[k]) / (1 + abs(val[k])) for k in val_keys)
        log(f"poke_vae [{card}]: validation " + ", ".join(f"{k} {v:.6g}" for k, v in val.items())
            + f" ({vals[-1]['val_s']:.1f} s); test of the best checkpoint {test_s:.1f} s, max "
            f"relative difference {test_err:.3g} (tolerance {STAGE1_TEST_TOL})")
        if not test_err <= STAGE1_TEST_TOL or not all(np.isfinite(v) for v in val.values()):
            raise SystemExit(f"poke_vae: test of the best checkpoint disagrees: {tested} vs {val}")
    pv = {"init_s": run["init_s"], "step_ms": step_ms, "step_ms_median": _median(step_ms[1:]),
          "peak_gib": peak, "losses": {k: [h[k] for h in hist] for k in keys}, "moved": moved,
          "ckpt_gb": ckpt_gb, "val": val, "test": tested, "test_s": test_s,
          "step_launches": {"mcf_inverse": n_step[0], "macow_unit_inverse": n_step[1]}}
    raw = next(iter(StaticDataModule(config["data"]).loader("val")))
    batch = {k: torch.from_numpy(np.asarray(raw[k])) for k in ("images", "poke")}
    one = {k: v[:1] for k, v in batch.items()}
    with torch.no_grad():
        gen_sn = _to_cpu(first_stage_mod.materialize_spectral_norm(state.gen_params))
    del state, run
    if device.type == "cuda":
        torch.cuda.empty_cache()

    def pv_fwd(p, bt, prior=False):
        return variants.poke_vae_forward(p, bt, pv_spec, rng=prng.prng_key(5), sample_prior=prior)

    _, errs, _ = _card_vs_cpu(device, pv_fwd, gen_sn, one)
    pv["forward_max_rel_err"] = max(errs)
    with torch.no_grad():
        card_gen, card_batch = _moved(gen_sn, device), _moved(batch, device)
        pv_fwd(card_gen, card_batch)
        _sync(device)
        t0 = time.perf_counter()
        x_hat = pv_fwd(card_gen, card_batch)[0]
        _sync(device)
        pv["forward_ms"] = (time.perf_counter() - t0) * 1e3
        prior, mu, _ = pv_fwd(card_gen, card_batch, prior=True)
        del card_gen, card_batch
    prior_ok = (mu is None and tuple(prior.shape) == tuple(x_hat.shape)
                and bool(torch.isfinite(prior).all()) and float(prior.abs().max()) <= 1.0)
    log(f"poke_vae [{card}]: poke_vae_forward at B={b} {pv['forward_ms']:.1f} ms; one video on "
        f"the card against the CPU: max relative error {max(errs):.3g} (tolerance "
        f"{VARIANT_TOL}); sample_prior at B={b} {tuple(prior.shape)} finite in [-1, 1]: {prior_ok}")
    if not max(errs) <= VARIANT_TOL or not prior_ok:
        raise SystemExit("poke_vae: the card's forward disagrees with the CPU's or the prior "
                         "sample is off")
    del gen_sn, x_hat, prior

    out = {"poke_vae": pv, "batch": b}
    images = batch["images"]
    rnn, enc_static, dec = variants.init_rnn_motion(prng.prng_key(0), fs_spec)
    fc_spec = variants.FCBaselineSpec(
        z_dim=fs_spec.z_dim, spatial_size=fs_spec.spatial_size, max_frames=fs_spec.max_frames,
        enc_channels=tuple(fs_spec.enc_channels) + (fs_spec.enc_channels[-1],),
        dec_channels=(fs_spec.dec_channels[0],) + tuple(fs_spec.dec_channels))
    fc, me_spec = variants.init_fc_baseline(prng.prng_key(0), fc_spec)
    for name, fn, tree in (
            ("rnn_motion", lambda p, x: variants.rnn_motion_forward(
                first_stage_mod.materialize_spectral_norm(p), x, fs_spec, enc_static, dec,
                rng=prng.prng_key(7)), rnn),
            ("fc_baseline", lambda p, x: variants.fc_baseline_forward(
                first_stage_mod.materialize_spectral_norm(p), x, fc_spec, me_spec,
                rng=prng.prng_key(7)), fc)):
        got, errs, _ = _card_vs_cpu(device, fn, tree, images[:1])
        with torch.no_grad():
            p_card, x_card = _moved(tree, device), images.to(device)
            fn(p_card, x_card)
            _sync(device)
            t0 = time.perf_counter()
            frames = fn(p_card, x_card)[0]
            _sync(device)
            ms = (time.perf_counter() - t0) * 1e3
            del p_card, x_card
        ok = (max(errs) <= VARIANT_TOL and tuple(frames.shape) == tuple(images[:, 1:].shape)
              and bool(torch.isfinite(frames).all()))
        n = sum(t.numel() for t in train_ss.float_leaves(tree))
        log(f"{name} [{card}]: {n / 1e6:.2f} M params, forward at B={b} {ms:.1f} ms; one video "
            f"on the card against the CPU: max relative error {max(errs):.3g} (tolerance "
            f"{VARIANT_TOL})")
        if not ok:
            raise SystemExit(f"{name}: the card's forward disagrees with the CPU's")
        out[name] = {"forward_ms": ms, "max_rel_err": max(errs), "params_m": n / 1e6}
        del frames
    del rnn, fc

    legacy_out = {}
    for name, fn, tree, inputs in _legacy_legs(prng.prng_key(0)):
        got, errs, ms = _card_vs_cpu(device, fn, tree, *inputs)
        leg = {"ms": ms, "max_rel_err": max(errs)}
        line = (f"legacy {name} [{card}]: {ms:.2f} ms on the card; against the CPU max relative "
                f"error {max(errs):.3g} (tolerance {VARIANT_TOL})")
        ok = max(errs) <= VARIANT_TOL and all(bool(torch.isfinite(g).all()) for g in got)
        if name in LEGACY_ROUND_TOL:   # the round trip's outputs end the list
            tol, k = LEGACY_ROUND_TOL[name]
            leg["round_trip_err"] = max(float((r.cpu() - x).abs().max())
                                        for r, x in zip(got[-k:], inputs[:k]))
            line += (f"; inverse(forward(x)) - x max {leg['round_trip_err']:.3g} (tolerance "
                     f"{tol})")
            ok = ok and leg["round_trip_err"] <= tol
        else:
            ok = ok and float(got[0].abs().max()) <= 1.0
        log(line)
        if not ok:
            raise SystemExit(f"legacy {name}: the card disagrees with the CPU or the round trip fails")
        legacy_out[name] = leg
    out["legacy"] = legacy_out
    n = _counts()
    if n != (0, 0):
        raise SystemExit(f"stage1 variants: a kernel launched: K1/K2 {n}")
    out["launches"] = {"mcf_inverse": n[0], "macow_unit_inverse": n[1]}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"stage1 variants: the phase took {out['phase_s']:.1f} s")
    return out


# the tools phase: the per-level trainer against make_train_step after one
# step (the losses relative; params per leaf relative to 1 + max|p|; first
# moments per leaf relative to their own max, as parallel/dryrun's cuda legs)
PER_LEVEL_TOLS = {"loss": 1e-5, "params": 1e-3, "mu": 1e-2}
TOOLS_ADAFACTOR_STEPS = 2  # timed adafactor steps, after one warm-up step
TOOLS_DECODE_ITERS = 3
# bench_e2e at its default geometry (64^2, 10 frames, B=8, flow (4, 4) at
# hidden 64, h 64, factor 4), step counts cut
TOOLS_E2E_ARGS = ("--enc-steps", "2", "--steps1", "2", "--steps2", "4", "--eval-every", "2",
                  "--n-eval", "16", "--distill-steps", "2")


def _first_moments(opt_state):
    return next(s["mu"] for s in opt_state if isinstance(s, dict) and "mu" in s)


def _count_calls(module, name, counts):
    """Wrap ``module.name`` so each call appends its (K1, K2) launches to
    ``counts``; returns the original, which the caller puts back."""
    orig = getattr(module, name)

    def counted(*args, **kw):
        before = _counts()
        out = orig(*args, **kw)
        torch.cuda.synchronize()
        after = _counts()
        counts.append((after[0] - before[0], after[1] - before[1]))
        return out

    setattr(module, name, counted)
    return orig


def phase_tools(device, card, entry, tmp, b=BATCH):
    """The per-level trainer, adafactor with remat, profile_decode's stages
    and the cut bench_e2e loop on the card (docstring, 10c)."""
    t_phase = time.perf_counter()
    out = {}
    spec = cut_spec(registry.build_specs(entry), STEPS_PER_LEVEL)
    params = synth.synth_params(spec, seed=0, device=device)
    params["flow"] = synth.set_flow_output_gains(params["flow"], CROSS_GAIN)
    trainable, frozen = train_ss.split_params(params)
    if set(trainable) != {"flow"}:
        raise SystemExit(f"tools: {entry.name} trains {sorted(trainable)}, not the flow alone")
    (batch, _), = make_requests(device, 1, b, spec, seed=4000)

    def opt():   # make_optimizer at clip 0; no warm-up, so the first step moves the params
        return train_ss.make_optimizer(lr=1e-3, warmup_steps=0, total_steps=1000)

    def fresh_flow():
        return _clone(trainable["flow"])

    # (a) per-level against monolithic, one step each from the same params
    mono_step = train_ss.make_train_step(spec, frozen, opt())
    mono = train_ss.init_state({"flow": fresh_flow()}, mono_step.optimizer)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    mono, m_mono = mono_step(mono, batch, prng.prng_key(4001))
    torch.cuda.synchronize()
    mono_ms = (time.perf_counter() - t0) * 1e3
    mono_peak = torch.cuda.max_memory_allocated() / 2**30
    per_level = chunked.make_per_level_trainer(spec.flow, spec, frozen, lambda level: opt())
    lvl = per_level.init_state(fresh_flow())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lvl, m_lvl = per_level(lvl, batch)
    torch.cuda.synchronize()
    lvl_ms = (time.perf_counter() - t0) * 1e3
    lvl_peak = torch.cuda.max_memory_allocated() / 2**30
    train_launches = _counts()
    loss_err = {k: abs(float(m_lvl[k]) - float(m_mono[k])) / (1 + abs(float(m_mono[k])))
                for k in chunked.METRICS}
    p_lvl = train_ss.float_leaves({"levels": lvl.levels})
    p_mono = train_ss.float_leaves(mono.params)
    mu_lvl = [m for s in lvl.opt_states for m in _first_moments(s)]
    mu_mono = _first_moments(mono.opt_state)
    start = train_ss.float_leaves(trainable)
    param_err = max(((a - c).abs().max() / (1 + c.abs().max())).item() for a, c in zip(p_lvl, p_mono))
    mu_err = max(((a - c).abs().max() / c.abs().max().clamp(min=1e-30)).item()
                 for a, c in zip(mu_lvl, mu_mono))
    moved = sum(bool((a != s0).any()) for a, s0 in zip(p_lvl, start))
    out["per_level"] = {"flow_params": sum(t.numel() for t in start), "leaves": len(p_lvl),
                        "leaves_moved": moved, "loss": {k: float(m_lvl[k]) for k in chunked.METRICS},
                        "loss_rel_err": loss_err, "param_rel_err": param_err, "mu_rel_err": mu_err,
                        "mono_ms": mono_ms, "per_level_ms": lvl_ms, "mono_peak_gib": mono_peak,
                        "per_level_peak_gib": lvl_peak, "launches": list(train_launches)}
    log(f"tools [{card}]: per-level against monolithic, {entry.name} at full width on "
        f"{sum(spec.flow.num_steps)} MaCowSteps ({out['per_level']['flow_params'] / 1e9:.3f} G flow "
        f"params), B={b}, one step: flow_loss {float(m_lvl['flow_loss']):.6g} against "
        f"{float(m_mono['flow_loss']):.6g} (relative {max(loss_err.values()):.3g}); params within "
        f"{param_err:.3g}, first moments within {mu_err:.3g} per leaf ({moved} of {len(p_lvl)} "
        f"leaves moved); step {mono_ms:.1f} / {lvl_ms:.1f} ms, peak {mono_peak:.2f} / "
        f"{lvl_peak:.2f} GiB (monolithic / per-level); K1/K2 launches {train_launches}")
    if not (max(loss_err.values()) <= PER_LEVEL_TOLS["loss"]
            and param_err <= PER_LEVEL_TOLS["params"] and mu_err <= PER_LEVEL_TOLS["mu"]
            and moved == len(p_lvl) and train_launches == (0, 0)
            and len(p_lvl) == len(p_mono) == len(mu_lvl)):
        raise SystemExit(f"tools: the per-level trainer disagrees with make_train_step: "
                         f"{out['per_level']}")
    del mono, mono_step, lvl, per_level, p_lvl, p_mono, mu_lvl, mu_mono
    torch.cuda.empty_cache()

    # (b) adafactor with remat, 1 + TOOLS_ADAFACTOR_STEPS steps
    remat_spec = replace(spec, flow=replace(spec.flow, remat=True))
    ada = chunked.make_per_level_trainer(remat_spec.flow, remat_spec, frozen,
                                         lambda level: train_ss.adafactor(1e-3))
    st = ada.init_state(fresh_flow())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ada_ms, losses = [], []
    for i in range(1 + TOOLS_ADAFACTOR_STEPS):
        t0 = time.perf_counter()
        st, m = ada(st, batch)
        losses.append(float(m["flow_loss"]))
        torch.cuda.synchronize()
        ada_ms.append((time.perf_counter() - t0) * 1e3)
    ada_peak = torch.cuda.max_memory_allocated() / 2**30
    out["adafactor_remat"] = {"step_ms": ada_ms, "peak_gib": ada_peak, "flow_loss": losses}
    log(f"tools [{card}]: per-level adafactor with remat: steps "
        f"{', '.join(f'{x:.1f}' for x in ada_ms)} ms (the first the warm-up), peak "
        f"{ada_peak:.2f} GiB, flow_loss {', '.join(f'{x:.6g}' for x in losses)}")
    if not all(np.isfinite(losses)):
        raise SystemExit(f"tools: adafactor steps gave a non-finite loss: {losses}")
    del st, ada, params, trainable, frozen
    torch.cuda.empty_cache()

    # (c) profile_decode's stages
    dec = profile_decode.profile(spec.first_stage, b, TOOLS_DECODE_ITERS, "bf16", device=device)
    stages = {k: v for k, v in dec.items() if isinstance(v, dict)}
    out["profile_decode"] = dec
    log(f"tools [{card}]: profile_decode B={b} bf16 (ms, median of {TOOLS_DECODE_ITERS} / "
        f"pipelined): " + "; ".join(f"{k} {v['s'] * 1e3:.2f} / {v['pipelined_s'] * 1e3:.2f}"
                                    for k, v in stages.items()))
    if len(stages) < 6 or not all(v["s"] > 0 and v["flops_counted"] > 0 for v in stages.values()):
        raise SystemExit(f"tools: profile_decode's report is incomplete: {dec}")
    torch.cuda.empty_cache()

    # (d) the cut bench_e2e loop, K2 counted around each sampling call and
    # each teacher reverse
    t0 = time.perf_counter()
    per_call = {"sampling": [], "teacher_reverse": []}
    orig_sample = _count_calls(second_stage, "forward_sample", per_call["sampling"])
    orig_teacher = _count_calls(distill, "teacher_motion", per_call["teacher_reverse"])
    try:
        _zero_counts()
        e2e = bench_e2e.main(list(TOOLS_E2E_ARGS) + ["--out", os.path.join(tmp, "bench_e2e")])
        torch.cuda.synchronize()
        e2e_launches = _counts()
    finally:
        second_stage.forward_sample = orig_sample
        distill.teacher_motion = orig_teacher
    e2e_s = time.perf_counter() - t0
    args = bench_e2e.parse_args(list(TOOLS_E2E_ARGS))
    per_unit = 4 * sum(int(x) for x in args.num_steps.split(","))
    calls = per_call["sampling"] + per_call["teacher_reverse"]
    want_calls = (e2e["n_evals"] * -(-args.n_eval // args.batch), args.distill_steps)
    fvds = e2e["fvd"] + [e2e["fvd_recon_floor"], e2e["distill_signoff"]["student_fvd"]]
    out["bench_e2e"] = {"s": e2e_s, "launches": list(e2e_launches), "per_call": per_call,
                        "report": e2e}
    log(f"tools [{card}]: bench_e2e {' '.join(TOOLS_E2E_ARGS)}: {e2e_s:.1f} s; FVD* "
        f"{e2e['fvd']} (floor {e2e['fvd_recon_floor']}), student {fvds[-1]}; "
        f"{len(per_call['sampling'])} sampling calls and {len(per_call['teacher_reverse'])} "
        f"teacher reverses of {per_unit} K2 launches each; K1/K2 launches {e2e_launches}")
    if not (all(c == (0, per_unit) for c in calls)
            and (len(per_call["sampling"]), len(per_call["teacher_reverse"])) == want_calls
            and e2e_launches == (0, per_unit * len(calls)) == (0, e2e["k2_launches"])
            and all(v is not None and np.isfinite(v) for v in fvds)):
        raise SystemExit(f"tools: the bench_e2e loop failed its checks: {out['bench_e2e']}")

    # K2 against its plain version at the loop's level shapes, every G it takes
    flow = bench_e2e.build_spec(args).flow
    gen = torch.Generator().manual_seed(4002)
    rows = []
    for c in flow.level_channels():
        weights, an, y, h = unit_inputs(gen, c, flow.h_channels, b, LATENT, device)
        ref = k2.macow_unit_inverse_plain(y, h, weights, *an)
        tol = KERNEL_TOL * (1 + ref.abs().max().item())
        for g in k2_clusters(c, flow.h_channels, LATENT):
            err = (k2.macow_unit_inverse(y, h, weights, *an, cluster=g) - ref).abs().max().item()
            rows.append({"c": c, "hc": flow.h_channels, "g": g, "max_abs_err": err, "tol": tol})
            if not err <= tol:
                raise SystemExit(f"tools: K2 disagrees with its plain version at C={c}, "
                                 f"hc={flow.h_channels}, G={g}: {err} > {tol}")
    out["k2_loop_shapes"] = rows
    log(f"tools [{card}]: K2 at the loop's shapes against its plain version: "
        + "; ".join(f"C={r['c']} G={r['g']} {r['max_abs_err']:.3g}" for r in rows)
        + f" (tolerance {KERNEL_TOL}·(1+max|ref|))")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"tools [{card}]: the phase took {out['phase_s']:.1f} s")
    return out


def _clone(tree):
    """A copy of a param tree's tensors, detached."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.detach().clone()


def eval_config(entry, b=BATCH):
    """train_config's model and data at full width, with the eval modes'
    testing section and two val batches per validation."""
    config = train_config(entry, b)
    config["testing"] = dict(EVAL_TESTING)
    config["training"]["max_val_batches"] = 2
    config["logging"] = {"n_fvd_samples": EVAL_TESTING["n_samples_fvd"], "n_saved_ckpt": 2}
    return config


def _mode(card, name, fn, want_k2, *args, raises=None, **kw):
    """One eval mode with its launch counts read around it: (result, host
    seconds, timings by part, (K1, K2) launches).  With ``raises``, the
    mode must raise that exception (its result is then ``{}``)."""
    timings = {}
    _zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if raises is None:
        out = fn(*args, timings=timings, **kw)
    else:
        try:
            fn(*args, timings=timings, **kw)
        except raises as e:
            out = {"raised": repr(e)}
        else:
            raise SystemExit(f"eval: {name} did not raise {raises.__name__}")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = _counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"eval [{card}]: {name}: {dt:.2f} s (" + ", ".join(f"{k} {v:.2f}" for k, v in timings.items())
        + f"); K1/K2 launches {n[0]}/{n[1]} (want 0/{want_k2}); peak {peak:.2f} GiB; "
        + json.dumps({k: v for k, v in out.items() if not isinstance(v, str)}, default=float))
    if n != (0, want_k2):
        raise SystemExit(f"eval: {name} launched K1/K2 {n}, want 0/{want_k2}")
    return out, {"s": dt, "timings": timings, "peak_gib": peak,
                 "launches": {"mcf_inverse": n[0], "macow_unit_inverse": n[1]}}


def phase_eval(device, card, entry, spec, params, tmp):
    """The evaluation path on the slice's params (K2, 200 launches per
    forward_sample call) at full width, B=8, 10 frames of 128^2 on the
    synthetic test split: run_fvd (16 videos, two batches), run_diversity
    (3 samples of 8 examples), run_samples (2 examples), the stage-2
    validate (two val batches, then the latent scatter's LATENT_BATCHES);
    the fake videos' I3D features on the card against the port's CPU I3D on
    the first I3D_CPU_VIDEOS of them; then the trainer's top-k checkpoints
    and ``test --mode fvd`` at cut depth (TOPK_NUM_STEPS), and that run
    resumed.  Every *_UNPRETRAINED value is printed.  Returns (the numbers,
    the cut-depth run's config)."""
    config = eval_config(entry)
    dirs = eval_dirs(tmp)
    data = StaticDataModule(config["data"])
    units = 4 * sum(spec.flow.num_steps)
    # each validation also draws the latent scatter: LATENT_BATCHES val
    # batches through the flow's reverse, whatever max_val_batches says
    scatter = min(LATENT_BATCHES, len(data.loader("val")))
    out = {"i3d_pretrained": i3d.i3d().pretrained, "lpips_pretrained": lpips_pretrained()}
    t_phase = time.perf_counter()
    n_batches = EVAL_TESTING["n_samples_fvd"] // BATCH
    fvd, out["run_fvd"] = _mode(card, "run_fvd", test_modes.run_fvd, units * n_batches,
                                params, spec, config, data, dirs)
    div, out["run_diversity"] = _mode(card, "run_diversity", test_modes.run_diversity, units,
                                      params, spec, config, data, dirs)
    smp, out["run_samples"] = _mode(card, "run_samples", test_modes.run_samples, units,
                                    params, spec, config, data, dirs)
    with _captured_log(experiment.log) as warnings:
        val, out["validate"] = _mode(card, "stage-2 validate", experiment.validate,
                                     units * (config["training"]["max_val_batches"] + scatter),
                                     params, spec, config, data, log_dir=dirs["log"])
    _check_scatter(os.path.join(dirs["log"], "latents.png"), warnings)
    key = "FVD" if out["i3d_pretrained"] else "FVD_UNPRETRAINED"
    scores = {f"run_fvd {key}": fvd[key], "run_diversity div_vgg_cosine": div["div_vgg_cosine"],
              "run_diversity div_mse": div["div_mse"], "run_diversity div_lpips": div["div_lpips"],
              "validate FVD-val": val["FVD-val"], "validate flow_loss-val": val["flow_loss-val"]}
    out["scores"] = scores
    log(f"eval: I3D pretrained {out['i3d_pretrained']}, LPIPS pretrained {out['lpips_pretrained']} "
        "(random seeded filters: every FVD and LPIPS below is a relative number, "
        "*_UNPRETRAINED); " + ", ".join(f"{k} = {v:.9g}" for k, v in scores.items()))
    if not all(np.isfinite(v) for v in scores.values()) or fvd["n"] != EVAL_TESTING["n_samples_fvd"]:
        raise SystemExit(f"eval: a score is not finite, or run_fvd saw {fvd['n']} videos")
    if smp["n_examples"] != EVAL_TESTING["n_samples_vis"] or div["n"] != EVAL_TESTING["n_samples_metrics"]:
        raise SystemExit(f"eval: run_samples wrote {smp['n_examples']}, run_diversity scored {div['n']}")
    pngs = [f for _, _, fs in os.walk(smp["dir"]) for f in fs if f.endswith(".png")]
    if len(pngs) != EVAL_TESTING["n_samples_vis"] * EVAL_TESTING["n_samples_per_data_point"]:
        raise SystemExit(f"eval: run_samples wrote {len(pngs)} enrollment PNGs")

    # the sampled videos' I3D features: the card against the CPU (run_fvd's uint8 dump)
    fake = np.load(os.path.join(fvd["npy_dir"], "fake_samples.npy"))[:I3D_CPU_VIDEOS]
    videos = torch.from_numpy(fake.astype(np.float32) / 127.5 - 1.0)
    feats_card = i3d.features(videos.to(device)).cpu()
    t0 = time.perf_counter()
    with torch.backends.mkldnn.flags(enabled=False):
        feats_cpu = i3d.features(videos)
    cpu_s = time.perf_counter() - t0
    i3d_err = float((feats_card - feats_cpu).abs().max() / (1 + feats_cpu.abs().max()))
    out["i3d_card_vs_cpu"] = {"videos": I3D_CPU_VIDEOS, "max_rel_err": i3d_err, "cpu_s": cpu_s,
                              "max_abs_feature": float(feats_cpu.abs().max())}
    log(f"eval [{card}]: I3D features of {I3D_CPU_VIDEOS} sampled videos ({fake.shape[1]} frames of "
        f"{fake.shape[2]}^2, resized to 224^2) on the card against the CPU ({cpu_s:.1f} s): max "
        f"|diff| / (1 + max|ref|) {i3d_err:.3g} (tolerance {I3D_TOL}; max|ref| "
        f"{out['i3d_card_vs_cpu']['max_abs_feature']:.4g})")
    if not i3d_err <= I3D_TOL:
        raise SystemExit(f"eval: the card's I3D features disagree with the CPU's: {i3d_err}")

    # top-k checkpoints and test at cut depth
    cut = eval_config(entry)
    cut["architecture"]["num_steps"] = list(TOPK_NUM_STEPS)
    cut["training"].update({"n_epochs": 1, "max_batches_per_epoch": 2, "val_every": 0.5,
                            "max_val_batches": 1})
    cut["testing"]["n_samples_fvd"] = BATCH
    topk_spec = experiment.build_spec_from_config(cut)
    cut_units = 4 * sum(topk_spec.flow.num_steps)
    _zero_counts()
    t0 = time.perf_counter()
    run = experiment.train(cut, dirs, device=device)
    train_s = time.perf_counter() - t0
    n_train = _counts()
    vals = run["val"]
    best = io.find_best(run["ckpt_dir"])
    kept = sorted(f for f in os.listdir(run["ckpt_dir"]) if f.startswith("step="))
    want_best = min(vals, key=lambda v: v["FVD-val"])
    ckpt_mb = os.path.getsize(best) / 1e6
    want_train = cut_units * (1 + scatter) * len(vals)
    log(f"eval [{card}]: top-k at cut depth ({entry.name} width, num_steps {TOPK_NUM_STEPS}): 2 steps, "
        f"validations at steps {[v['step'] for v in vals]} with FVD-val "
        f"{[round(v['FVD-val'], 6) for v in vals]}; kept {kept}; find_best {os.path.basename(best)} "
        f"({ckpt_mb:.0f} MB, top-k saves {sum(v['save_s'] for v in vals):.1f} s); the run "
        f"{train_s:.1f} s, K1/K2 launches {n_train[0]}/{n_train[1]} (want 0/{want_train} = "
        f"{cut_units} x (1 FVD batch + {scatter} scatter batches) x {len(vals)} validations)")
    if [v["step"] for v in vals] != [1, 2, 2] or n_train != (0, want_train):
        raise SystemExit(f"eval: the cut-depth trainer did not validate on JAX's schedule: {vals}")
    if os.path.basename(best) != f"step={want_best['step']}-FVD-val={want_best['FVD-val']:.3f}.npz":
        raise SystemExit(f"eval: find_best gave {best}, not the least FVD-val {want_best}")
    tested, out["test_fvd"] = _mode(card, "test --mode fvd (find_best, cut depth)", experiment.test,
                                    cut_units, cut, dirs, mode="fvd", device=device)
    if not np.isfinite(tested[key]):
        raise SystemExit(f"eval: test --mode fvd gave {tested}")
    out["topk"] = {"val": [{k: v[k] for k in ("step", "FVD-val", "flow_loss-val", "val_s", "save_s")}
                           for v in vals], "kept": kept, "best": os.path.basename(best),
                   "ckpt_mb": ckpt_mb, "train_s": train_s, "test": tested[key],
                   "launches": {"mcf_inverse": n_train[0], "macow_unit_inverse": n_train[1]}}

    # --resume of the cut-depth run: it trains on from last.npz (step 2), and
    # its next step is validated (K2) with a record in metrics.jsonl
    _zero_counts()
    t0 = time.perf_counter()
    again = experiment.train(dict(cut, general=dict(cut["general"], restart=True)), dirs,
                             device=device, max_steps=1)
    again_s = time.perf_counter() - t0
    n_again = _counts()
    records = read_metrics(dirs["log"])
    log(f"eval [{card}]: --resume of the cut-depth run: from step {again['start_step']} in "
        f"{os.path.basename(again['ckpt_dir'])} (load {again['resume'].get('load_s', float('nan')):.2f} "
        f"s, restore {again['resume'].get('restore_s', float('nan')):.2f} s), validations at steps "
        f"{[v['step'] for v in again['val']]}; metrics.jsonl steps {[r['step'] for r in records]}; "
        f"{again_s:.1f} s, K1/K2 launches {n_again[0]}/{n_again[1]} (want 0/"
        f"{cut_units * (1 + scatter)}, the scatter's included)")
    if (again["start_step"] != 2 or again["ckpt_dir"] != run["ckpt_dir"]
            or [v["step"] for v in again["val"]] != [3] or n_again != (0, cut_units * (1 + scatter))
            or [r["step"] for r in records] != [1, 2, 2, 3] or "FVD-val" not in records[-1]):
        raise SystemExit(f"eval: the resumed cut-depth run did not validate on: {again['val']}, "
                         f"records {records}, K1/K2 {n_again}")
    out["topk_resume"] = {"s": again_s, "start_step": again["start_step"],
                          "val": [{k: v[k] for k in ("step", "FVD-val", "val_s")}
                                  for v in again["val"]],
                          "launches": {"mcf_inverse": n_again[0],
                                       "macow_unit_inverse": n_again[1]}}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"eval: the phase took {out['phase_s']:.1f} s")
    return out, cut


def eval_dirs(tmp, name=TOPK_MODEL):
    """The eval phases' run directories, in ``config.load_parameters``'s
    layout under ``<tmp>/logs``, so the entry points find the run."""
    return {k: os.path.join(tmp, "logs", "chip_smoke", k, name)
            for k in ("ckpt", "config", "generated", "log")}


class _captured_log:
    """The messages a logger emits inside the ``with`` block (a list)."""

    def __init__(self, logger):
        self.logger, self.records = logger, []
        self.handler = logging.Handler()
        self.handler.emit = lambda record: self.records.append(record.getMessage())

    def __enter__(self):
        self.logger.addHandler(self.handler)
        return self.records

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


def _have_matplotlib():
    return importlib.util.find_spec("matplotlib") is not None


def _check_scatter(png, warnings):
    """The validation's latent scatter: written where matplotlib imports,
    else skipped with JAX's warning."""
    skipped = [w for w in warnings if w.startswith("latent scatter skipped")]
    if _have_matplotlib():
        ok = os.path.exists(png) and not skipped
        log(f"eval: matplotlib imports; the latent scatter wrote {png} ({ok})")
    else:
        ok = not os.path.exists(png) and len(skipped) == 1
        log(f"eval: matplotlib is missing; the validation logged {skipped} ({ok})")
    if not ok:
        raise SystemExit(f"eval: the latent scatter did not behave as JAX's: {warnings}")


def _png_size(data):
    """(width, height) of PNG bytes, read off their IHDR chunk."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise SystemExit("eval2: not a PNG")
    return tuple(int.from_bytes(data[i:i + 4], "big") for i in (16, 20))


def _gui_poke(port, body):
    """One POST /poke: (round-trip ms, the reply)."""
    t0 = time.perf_counter()
    reply = json.loads(_http(port, "POST", "/poke", json.dumps(body).encode()))
    return (time.perf_counter() - t0) * 1e3, reply


def phase_eval2(device, card, entry, spec, params, tmp, cut):
    """The rest of evaluation on the eval phase's params and synthetic test
    split at full width, B=8: the modes accuracy, kps_acc,
    control_sensitivity and transfer (EVAL2_TESTING) with their K2 launches
    (200 per sampling call); the GUI in this process on an
    ``InteractiveSession`` of the same params (B=1: GUI_POKES steady pokes
    at the config's length after a first, one past the trained horizon, one
    with no poke; 200 K2 launches each); then ``python -m
    ipoke_tpu_torch.eval.interactive`` and ``python -m
    ipoke_tpu_torch.eval.gui`` in child processes on the eval phase's
    cut-depth top-k run (config ``cut``).  Returns the numbers."""
    from ipoke_tpu_torch.eval import gui
    from ipoke_tpu_torch.eval.interactive import InteractiveSession

    t_phase = time.perf_counter()
    config = dict(eval_config(entry), testing=dict(EVAL2_TESTING))
    dirs = eval_dirs(tmp, "eval2")
    data = StaticDataModule(config["data"])
    units = 4 * sum(spec.flow.num_steps)
    mpl = _have_matplotlib()
    out = {"matplotlib": mpl}
    n_test = len(data.loader("test"))
    k = EVAL2_TESTING["n_control_sensitivity_pokes"]
    # sampling calls, nb test batches per mode (one at B=8); kps_acc's
    # keypoint_mse reads up to 8 test batches, then its proxy nb more;
    # control_sensitivity samples k directions per batch and, in the first
    # (where its one artefact example is), the batch's own poke; transfer
    # reverses once per batch
    nb = -(-EVAL2_TESTING["n_samples_metrics"] // BATCH)
    want = {"accuracy": units * nb, "kps_acc": units * (min(8, n_test) + nb),
            "control_sensitivity": units * (1 + k * nb), "transfer": units * nb}
    acc, out["accuracy"] = _mode(card, "run_accuracy" + ("" if mpl else " (no matplotlib)"),
                                 test_modes.run_accuracy, want["accuracy"], params, spec, config,
                                 data, dirs, raises=None if mpl else ModuleNotFoundError)
    with open(os.path.join(dirs["generated"], "metrics", "accuracy.csv")) as f:
        rows = [line.strip().split(",") for line in f][1:]
    finite = len(rows) == entry.max_frames - 1 and all(np.isfinite(float(v)) for r in rows for v in r)
    if mpl:
        finite = finite and all(np.isfinite(v) for k_, v in acc.items() if isinstance(v, float))
        pngs = [os.path.exists(os.path.join(dirs["generated"], "metrics", f))
                for f in ("lpips_per_frame.png", "accuracy_two_axes.png")]
    else:   # JAX's behaviour: the CSV written, then the first plot raises
        finite = finite and "matplotlib" in acc["raised"]
        pngs = []
    log(f"eval2: accuracy.csv {len(rows)} frames, finite {finite}; plots {pngs}")
    if not finite or not all(pngs):
        raise SystemExit(f"eval2: run_accuracy's numbers or files are wrong: {rows}, {acc}")
    kps, out["kps_acc"] = _mode(card, "run_kps_acc", test_modes.run_kps_acc, want["kps_acc"],
                                params, spec, config, data, dirs)
    ctl, out["control_sensitivity"] = _mode(card, "run_control_sensitivity",
                                            test_modes.run_control_sensitivity,
                                            want["control_sensitivity"], params, spec, config, data, dirs)
    trf, out["transfer"] = _mode(card, "run_transfer", test_modes.run_transfer, want["transfer"],
                                 params, spec, config, data, dirs)
    n_files = {"control_sensitivity": sum(len(fs) for _, _, fs in os.walk(ctl["artifact_dir"])),
               "transfer": len(os.listdir(trf["dir"]))}
    numbers = [kps[k_] for k_ in kps if isinstance(kps[k_], float)] + ctl["per_direction_response"] + [
        ctl["response_cv_across_directions"]]
    log(f"eval2: kps_acc {json.dumps({k_: v for k_, v in kps.items() if k_ != 'status'})}; "
        f"control_sensitivity artefacts {n_files['control_sensitivity']} files, transfer "
        f"{n_files['transfer']}; motion-energy correlation {trf['motion_energy_correlation']}")
    # control_sensitivity: overview, samples_all, then groundtruth and k + 1
    # samples, each a video and an enrollment PNG; transfer: 3 videos
    if (not all(np.isfinite(v) for v in numbers) or kps["n_examples"] != nb * BATCH
            or n_files != {"control_sensitivity": 2 + 2 * (k + 2), "transfer": 3}
            or ctl["n_examples"] != nb * BATCH or trf["n"] != nb * BATCH):
        raise SystemExit(f"eval2: a mode's numbers or files are wrong: {kps}, {ctl}, {trf}, {n_files}")

    # the GUI in this process, B=1, the slice's params
    examples = data.datasets["test"]
    sess = InteractiveSession(params, spec, display_size=256)
    sess.set_image(examples[0]["images"][0])
    videos = []
    generate = sess.generate

    def recording(pokes, length=None, poke_size=5):
        vid, poke = generate(pokes, length, poke_size)
        videos.append(vid)
        return vid, poke

    sess.generate = recording
    server = gui.make_server(sess, lambda i: examples[i % len(examples)]["images"][0], port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    poke = {"x": 128, "y": 100, "dx": 30, "dy": -12}
    gui_ms, server_s, sent = [], [], []
    try:
        page = _http(port, "GET", "/").decode()
        frame = _png_size(_http(port, "GET", "/frame"))
        length = spec.first_stage.max_frames - 1
        for body in ([{"pokes": [poke], "length": length}] * (1 + GUI_POKES)
                     + [{"pokes": [poke], "length": 16}, {"pokes": [], "length": length}]):
            _zero_counts()
            ms, reply = _gui_poke(port, body)
            n = _counts()
            sent.append({"frames": len(reply["frames"]), "want": body["length"] + 1,
                         "launches": {"mcf_inverse": n[0], "macow_unit_inverse": n[1]},
                         "finite": bool(np.isfinite(videos[-1]).all())})
            gui_ms.append(ms)
            server_s.append(reply["seconds"])
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    steady = gui_ms[1:1 + GUI_POKES]
    out["gui"] = {"first_ms": gui_ms[0], "median_ms": _median(steady), "ms": gui_ms,
                  "server_s": server_s, "launches_per_poke": [p["launches"] for p in sent]}
    k2_per_poke = [p["launches"]["macow_unit_inverse"] for p in sent]
    log(f"eval2 [{card}]: GUI in process ({entry.name} full width, B=1): GET / {len(page)} bytes, "
        f"GET /frame {frame[0]}x{frame[1]} PNG; POST /poke first {gui_ms[0]:.1f} ms, median of "
        f"{GUI_POKES} steady {out['gui']['median_ms']:.1f} ms (server {_median(server_s[1:1 + GUI_POKES]):.3f} "
        f"s), length 16 {gui_ms[-2]:.1f} ms, no poke {gui_ms[-1]:.1f} ms; frames "
        f"{[p['frames'] for p in sent]}, K2 per poke {k2_per_poke} (want {units}; K1 "
        f"{sum(p['launches']['mcf_inverse'] for p in sent)})")
    if (frame != (256, 256) or "<canvas" not in page or any(
            p["frames"] != p["want"] or p["launches"] != {"mcf_inverse": 0, "macow_unit_inverse": units}
            or not p["finite"] for p in sent)):
        raise SystemExit(f"eval2: the GUI answered wrong: {sent}, frame {frame}")

    # the entry points as users start them, on the cut-depth top-k run
    cfg_path = _write_config(os.path.join(tmp, "cut.yaml"),
                             dict(cut, general=dict(cut["general"], base_dir=os.path.join(tmp, "logs"))))
    out["entry_points"] = _entry_points(card, cfg_path, poke)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"eval2 [{card}]: the phase took {out['phase_s']:.1f} s")
    return out


def _entry_points(card, cfg_path, poke):
    """``eval.gui`` (waited for its start line, one POST /poke, then stopped)
    and ``eval.interactive`` (its JSON line and files) in child processes on
    the run of ``cfg_path``, model TOPK_MODEL, the card by default."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    gui_proc = subprocess.Popen([sys.executable, "-m", "ipoke_tpu_torch.eval.gui", "-c", cfg_path,
                                 "-m", TOPK_MODEL, "--port", str(port)], cwd=str(ROOT),
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        proc = subprocess.run([sys.executable, "-m", "ipoke_tpu_torch.eval.interactive", "-c", cfg_path,
                               "-m", TOPK_MODEL, "--pokes", json.dumps([poke]), "--length", "12"],
                              cwd=str(ROOT), capture_output=True, text=True, timeout=ENTRY_TIMEOUT_S)
        inter_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise SystemExit(f"eval2: eval.interactive failed:\n{proc.stderr[-3000:]}")
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        files = sorted(os.listdir(line["out"]))
        log(f"eval2 [{card}]: python -m ipoke_tpu_torch.eval.interactive: {line} in {inter_s:.1f} s "
            f"with start-up; files {files}")
        if (set(line) != {"frames", "out"} or line["frames"] != 12 or len(files) != 2
                or "enrollment.png" not in files):
            raise SystemExit(f"eval2: eval.interactive wrote {line}, {files}")
        lines, started = [], None
        timer = threading.Timer(ENTRY_TIMEOUT_S, gui_proc.kill)
        timer.start()
        for text in gui_proc.stdout:
            lines.append(text)
            if text.startswith("ipoke-tpu GUI: http://127.0.0.1:"):
                started = time.perf_counter() - t0
                break
        timer.cancel()
        if started is None:
            raise SystemExit(f"eval2: eval.gui never served:\n{''.join(lines)[-3000:]}")
        ms, reply = _gui_poke(port, {"pokes": [poke], "length": 9})
        log(f"eval2 [{card}]: python -m ipoke_tpu_torch.eval.gui: serving {started:.1f} s after its "
            f"start; one POST /poke {ms:.1f} ms, {len(reply['frames'])} frames")
        if len(reply["frames"]) != 10:
            raise SystemExit(f"eval2: eval.gui answered {len(reply['frames'])} frames")
    finally:
        gui_proc.terminate()
        try:
            gui_proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            gui_proc.kill()
            gui_proc.wait()
    return {"interactive_s": inter_s, "gui_start_s": started, "gui_poke_ms": ms}


# ---------------------------------------------------------------------------
# reference-checkpoint ingestion
# ---------------------------------------------------------------------------

INGEST_SAMPLES_FVD = 16    # the gate's run_fvd: 16 videos in batches of BATCH
INGEST_TIMEOUT_S = 600     # the quality-gate child, start-up included
# the converted model's video against the source params with the weights
# folded from the exported tensors, relative to 1 + max|ref|
INGEST_TOL = 2e-4
# a spectral-norm conv stored as a ConvTranspose2d: sigma along dim 1
_SN_TRANSPOSED = re.compile(r"(^|\.)(decoder|gen)\.blocks\.\d+\.(conv1|res_conv)\.conv$")


def ingest_config(entry, spec):
    """The saved config of a released model (logs/second_stage/config/
    <model>/config.yaml): ``spec``'s architecture written out, the first
    stage explicitly, the synthetic dataset (no meta tree)."""
    fs = spec.first_stage
    config = train_config(entry)
    config["architecture"]["num_steps"] = list(spec.flow.num_steps)
    config["general"] = {"experiment": "second_stage", "model_name": entry.name}
    config["first_stage"] = {"spec": {
        "z_dim": fs.z_dim, "ENC_M_channels": list(fs.enc_channels),
        "dec_channels": list(fs.dec_channels), "n_gru_layers": fs.n_gru_layers,
        "min_spatial_size": fs.min_spatial_size, "motion_bias": fs.motion_bias,
        "full_seq": fs.full_sequence}}
    del config["training"]
    return config


def _i3d_state_dict():
    """The port's seeded I3D filters as the reference's i3d_kinetics_rgb.pth
    holds a network: Unit3Dpy keys, (O, I, D, H, W) kernels, batch norms of
    unit gain (running variance 1 - 1e-3 against TF's eps 1e-3), the logits
    with a bias and no batch norm."""
    host, _ = i3d.load_params()
    sd = {}
    for name, p in host.items():
        w = torch.from_numpy(np.ascontiguousarray(np.asarray(p["w"]).transpose(4, 3, 0, 1, 2)))
        if name == "logits":
            sd["conv3d_0c_1x1.conv3d.weight"] = w
            sd["conv3d_0c_1x1.conv3d.bias"] = torch.from_numpy(np.asarray(p["b"]))
            continue
        if "/" in name:   # Mixed_3b/b1a -> mixed_3b.branch_1.0; b3 -> branch_3.1
            blk, unit = name.split("/")
            sub = {"a": ".0", "b": ".1", "": ".1" if unit[1] == "3" else ""}[unit[2:]]
            torch_name = f"mixed_{blk.split('_', 1)[1]}.branch_{unit[1]}{sub}"
        else:
            torch_name = name.lower()
        c = w.shape[0]
        sd[f"{torch_name}.conv3d.weight"] = w
        sd[f"{torch_name}.batch3d.weight"] = torch.ones(c)
        sd[f"{torch_name}.batch3d.bias"] = torch.from_numpy(np.asarray(p["b"]))
        sd[f"{torch_name}.batch3d.running_mean"] = torch.zeros(c)
        sd[f"{torch_name}.batch3d.running_var"] = torch.full((c,), 1 - 1e-3)
    return sd


def _sn_folds(sd):
    """{prefix: W_orig / (u^T W v)} of every conv that ``sd`` stores in
    torch's spectral-norm form, in float64 from the exported tensors."""
    out = {}
    for key in sd:
        if key.endswith(".weight_orig"):
            prefix = key[:-len(".weight_orig")]
            w = np.asarray(sd[key], np.float64)
            dim = 1 if _SN_TRANSPOSED.search(prefix) else 0
            w_mat = np.moveaxis(w, dim, 0).reshape(w.shape[dim], -1)
            sigma = (np.asarray(sd[f"{prefix}.weight_u"], np.float64)
                     @ (w_mat @ np.asarray(sd[f"{prefix}.weight_v"], np.float64)))
            out[prefix] = w / sigma
    return out


def _rss_gb(pid="self"):
    """The resident set (VmRSS) of a process in GB; None where /proc does
    not say."""
    try:
        with open(f"/proc/{pid}/status") as f:
            kb = next(int(line.split()[1]) for line in f if line.startswith("VmRSS:"))
    except (OSError, StopIteration, ValueError):
        return None
    return kb * 1024 / 1e9


def _gb(x):
    return "not measured" if x is None else f"{x:.2f} GB"


class _PeakRss:
    """The largest resident set of a process, sampled every 0.2 s by a
    thread between ``start`` and ``stop`` (neither rusage's maxrss, which
    holds the parent's resident set at a fork, nor VmHWM, which the card's
    machine lacks, gives one process's peak in one phase)."""

    def __init__(self, pid="self"):
        self.pid, self.peak = pid, None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            rss = _rss_gb(self.pid)
            if rss is not None:
                self.peak = max(self.peak or 0.0, rss)
            self._stop.wait(0.2)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._thread.join()
        return self.peak


def phase_ingest(device, card, entry, params, tmp):
    """Reference-checkpoint ingestion at full width: a Lightning checkpoint
    of ``entry`` in the reference's key schema (the smoke's flow, a first
    stage and both towers with both halves from the port's init at seed 1,
    their spectral-norm convs as torch stores them), a seeded I3D and
    pip-lpips heads beside it, through ``python -m
    ipoke_tpu_torch.ckpt.quality_gate`` in a child process (conversion, its
    self-check sample on K2, the backbones, the gate's run_fvd on K2 with the
    converted I3D).  Then here: the written npz through the bridge, the flow
    bitwise the smoke's, every spectral-norm kernel W_orig / (u^T W v) of the
    exported tensors, and a B=8 forward_sample on fixed z against the source
    params with those folded weights.  The flow is ``params``' on
    STEPS_PER_LEVEL MaCowSteps per level."""
    spec = cut_spec(registry.build_specs(entry), STEPS_PER_LEVEL)
    flow = cut_flow(params["flow"], STEPS_PER_LEVEL)
    config = ingest_config(entry, spec)
    if experiment.build_spec_from_config(config) != spec:
        raise SystemExit("ingest: the saved config does not give the registry's spec")
    root = Path(tmp) / "datapath"
    ck_dir = root / "logs" / "second_stage" / "ckpt" / entry.name / "0"
    ck_dir.mkdir(parents=True)
    _write_config(str(root / "logs" / "second_stage" / "config" / entry.name / "config.yaml"), config)
    out, seconds = {}, {}
    parent_rss = _PeakRss().start()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t_phase = t0 = time.perf_counter()
    ks = prng.split(prng.prng_key(1), 3)
    rest = {"first_stage": first_stage_mod.init(ks[0], spec.first_stage, device, spectral_u=True),
            "poke_embedder": encoders_mod.init_wrapper(ks[1], spec.poke_embedder, device, train=True),
            "conditioner": encoders_mod.init_wrapper(ks[2], spec.conditioner, device, train=True)}
    tree = {"flow": unbridge_flow(flow),
            "first_stage": unbridge_second_stage({"first_stage": rest["first_stage"]},
                                                 spec)["first_stage"],
            "poke_embedder": unbridge_wrapper(rest["poke_embedder"]),
            "conditioner": unbridge_wrapper(rest["conditioner"])}
    del rest
    sd = torch_import.export_second_stage(tree, spec)
    del tree
    state_dict = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    sd_rest = {k: v for k, v in sd.items() if not k.startswith("flow.")}
    del sd
    seconds["export"] = time.perf_counter() - t0
    n_sn = sum(k.endswith(".weight_orig") for k in sd_rest)
    ck_path = ck_dir / "epoch=17-FVD-val=74.530.ckpt"
    t0 = time.perf_counter()
    torch.save({"epoch": 17, "global_step": 100000, "pytorch-lightning_version": "1.1.7",
                "state_dict": state_dict, "optimizer_states": [], "lr_schedulers": [],
                "hyper_parameters": {"model_name": entry.name,
                                     "num_steps": list(spec.flow.num_steps)}},
               ck_path)
    seconds["torch_save"] = time.perf_counter() - t0
    n_keys = len(state_dict)
    del state_dict   # the parent's copy goes before the child loads its own
    gc.collect()
    out["ckpt_gb"] = ck_path.stat().st_size / 1e9
    _write_config(str(ck_dir / "best_k_models.yaml"), {str(ck_path): 74.53})
    src = root / "weights_src"
    src.mkdir()
    torch.save(_i3d_state_dict(), src / "i3d_kinetics_rgb.pth")
    torch.save({f"lin{i}.model.1.weight": torch.rand(1, c, 1, 1, generator=torch.Generator().manual_seed(i))
                for i, c in enumerate((64, 128, 256, 512, 512))}, src / "lpips_vgg_lins.pth")
    log(f"ingest: {entry.name} as a Lightning checkpoint: {n_keys} keys ({n_sn} spectral-norm "
        f"convs as weight_orig/u/v), {out['ckpt_gb']:.3f} GB; export {seconds['export']:.1f} s, "
        f"torch.save {seconds['torch_save']:.1f} s")

    report_path = Path(tmp) / "quality_gate_report.json"
    cmd = [sys.executable, "-m", "ipoke_tpu_torch.ckpt.quality_gate", "--datapath", str(root),
           "--models", entry.name, "--n-samples-fvd", str(INGEST_SAMPLES_FVD), "--batch", str(BATCH),
           "--published", json.dumps({entry.name: 1e9}), "--allow-blocked-gates",
           "--report", str(report_path)] + (["--device", "cpu"] if device.type == "cpu" else [])
    env = dict(os.environ, IPOKE_WEIGHTS=str(Path(tmp) / "weights"))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    child_rss = _PeakRss(proc.pid).start()
    try:
        stdout, stderr = proc.communicate(timeout=INGEST_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        child_rss = child_rss.stop()
    rc = proc.returncode
    seconds["child"] = time.perf_counter() - t0
    if rc != 0 or not report_path.exists():
        raise SystemExit(f"ingest: the quality gate exited {rc}:\n{stdout[-3000:]}\n{stderr[-3000:]}")
    with open(report_path) as f:
        report = json.load(f)
    (conv,), (gate,) = report["models"], report["gates"]
    units = 4 * sum(spec.flow.num_steps)
    want_k2 = {"self_check": units, "gate": units * INGEST_SAMPLES_FVD // BATCH}
    launches = {"self_check": conv.get("launches"), "gate": gate.get("launches")}
    backbones = {k: report["backbones"][k]["status"]
                 for k in ("i3d_kinetics_rgb.npz", "lpips_vgg_lins.npz")}
    for part, s in conv.get("seconds", {}).items():
        seconds[f"child_{part}"] = s
    seconds["child_backbones"] = report.get("backbones_seconds")
    seconds.update({f"child_gate_{k}": v for k, v in gate["seconds"].items()})
    log(f"ingest [{card}]: python -m ipoke_tpu_torch.ckpt.quality_gate: rc {rc} in "
        f"{seconds['child']:.1f} s; {conv['status']}, flow round trip {conv['flow_roundtrip_max_err']}, "
        f"sample finite {conv['sample_finite']}; backbones {backbones}; gate {gate['gate']} "
        f"({gate['fvd_key']} {gate['fvd']:.6g} of {gate['n_videos']} videos, I3D pretrained "
        f"{gate['i3d_pretrained']}); launches {launches}; child seconds "
        + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items() if k.startswith("child_")))
    if (conv["status"] != "converted" or not conv["flow_roundtrip_ok"] or not conv["sample_finite"]
            or set(backbones.values()) != {"converted"} or gate["i3d_pretrained"] is not True
            or gate["gate"] != "pass" or "gate_note" not in gate or gate["n_videos"] != INGEST_SAMPLES_FVD
            or not np.isfinite(gate["fvd"])):
        raise SystemExit(f"ingest: the gate's report is off: {json.dumps(report, default=str)[-3000:]}")
    if device.type == "cuda" and launches != {p: {"mcf_inverse": 0, "macow_unit_inverse": n}
                                               for p, n in want_k2.items()}:
        raise SystemExit(f"ingest: the child's launches {launches}, not K2 {want_k2} and K1 0")

    # the written npz, as every entry point reads it
    t0 = time.perf_counter()
    conv_tree, meta = io.load(conv["out"])
    converted = bridge_second_stage(conv_tree, spec, device)
    _sync(device)
    seconds["reload"] = time.perf_counter() - t0
    flow_a, flow_b = _flat(converted["flow"]), _flat(flow)
    if set(flow_a) != set(flow_b) or not all(torch.equal(flow_a[k], flow_b[k]) for k in flow_a):
        raise SystemExit("ingest: the converted flow is not the smoke's flow bitwise")
    del flow_a, flow_b
    folds = _sn_folds(sd_rest)
    plain = torch_import.export_second_stage({k: conv_tree[k] for k in (
        "first_stage", "poke_embedder", "conditioner")}, spec, spectral="weight")
    del conv_tree
    sn_err = max(float(np.max(np.abs(plain[f"{p}.weight"] - w)) / np.max(np.abs(w)))
                 for p, w in folds.items())
    if len(folds) != n_sn or sn_err > 1e-6:
        raise SystemExit(f"ingest: {len(folds)} spectral-norm kernels, worst relative error {sn_err}")
    # the source params with the folded weights: the exported plain form
    for p, w in folds.items():
        sd_rest[f"{p}.weight"] = w.astype(np.float32)
        for suffix in (".weight_orig", ".weight_u", ".weight_v"):
            del sd_rest[p + suffix]
    def sub(pre):
        return {k[len(pre):]: v for k, v in sd_rest.items() if k.startswith(pre)}

    source = dict(bridge_components({
        "first_stage": torch_import.convert_first_stage(sub("first_stage_model."), spec.first_stage),
        "poke_embedder": torch_import.convert_wrapper(sub("poke_embedder."), spec.poke_embedder),
        "conditioner": torch_import.convert_wrapper(sub("conditioner."), spec.conditioner)},
        device=device), flow=flow)
    batch = to_device(next(iter(StaticDataModule(config["data"]).loader("test"))), device,
                      keys=("images", "poke"))
    z = prng.normal(prng.prng_key(5), transformer.reverse_input_shape(
        spec.flow, BATCH, spec.latent_size, spec.flow_in_channels), device)
    _zero_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        video = second_stage.forward_sample(converted, spec, batch, z=z)
        _sync(device)
        seconds["sample"] = time.perf_counter() - t0
        k1_n, k2_n = _counts()
        ref = second_stage.forward_sample(source, spec, batch, z=z)
    err = float((video - ref).abs().max() / (1 + ref.abs().max()))
    out["launches"] = {"mcf_inverse": k1_n, "macow_unit_inverse": k2_n}
    out["child_launches"] = launches
    seconds["phase"] = time.perf_counter() - t_phase
    out.update(seconds=seconds, video_max_rel_err=err, sn_max_rel_err=sn_err, n_sn=n_sn,
               gate=gate["gate"], fvd=gate["fvd"], fvd_key=gate["fvd_key"],
               peak_gib=torch.cuda.max_memory_allocated() / 2**30 if device.type == "cuda" else 0.0,
               rss_gb=parent_rss.stop(), child_rss_gb=child_rss)
    log(f"ingest [{card}]: the npz reloaded and bridged in {seconds['reload']:.1f} s, flow bitwise; "
        f"{n_sn} spectral-norm kernels within {sn_err:.3g} of W_orig / (u^T W v); a B={BATCH} sample "
        f"on the converted params in {seconds['sample'] * 1e3:.1f} ms (K2 {k2_n}, K1 {k1_n}) "
        f"against the folded source {err:.3g} (tolerance {INGEST_TOL}); peak memory "
        f"{out['peak_gib']:.2f} GiB, peak host RSS in the phase {_gb(out['rss_gb'])} (the child's "
        f"{_gb(out['child_rss_gb'])}); "
        f"the phase {seconds['phase']:.1f} s")
    if not torch.isfinite(video).all() or err > INGEST_TOL:
        raise SystemExit(f"ingest: the converted model's video is {err} off the source's")
    if device.type == "cuda" and (k2_n != units or k1_n != 0):
        raise SystemExit(f"ingest: the parent's sample launched K2 {k2_n} and K1 {k1_n} times")
    return out


# ---------------------------------------------------------------------------
# the data path on a prepared tree, and the conditioning towers' trainers
# ---------------------------------------------------------------------------

DATA_VIDEOS, DATA_FRAMES, DATA_STORED, DATA_GAPS = 4, 30, 256, (5, 10)
# loader batches timed per augment setting: 2 since PR 16's variants phase
# (4 in PR 15, 10 before; ~6 s a batch of the GIL-bound loader on a slow host)
DATA_BATCHES = 2
AE_STEPS = 4               # timed encoder steps, after one warm-up step
AE_BATCH = 16              # configs/img_encoder.yaml, configs/poke_encoder.yaml
ENC_TOL = 2e-4             # the card's encoder step against the CPU's, relative to 1 + max|ref|


def data_config(meta, entry, b=BATCH, augment=False):
    """The iPER tree's data section at ``entry``'s size, JAX's zero pokes."""
    return {"dataset": "IperDataset", "meta_path": meta, "spatial_size": [entry.spatial_size] * 2,
            "max_frames": entry.max_frames, "batch_size": b, "n_workers": 4, "zero_poke": True,
            "zero_poke_amount": 12, "augment": augment, "seed": 0, "poke_size": 5, "n_pokes": 5}


def _loader_run(card, device, cfg, n_batches):
    """``n_batches`` batches of fresh ``loader("train")`` epochs through
    ``device_prefetch``, as a trainer draws them, each epoch's sampler cut
    to the batches taken: batches/s, samples/s and the zero-poke share."""
    dm = StaticDataModule(cfg)
    got, zero, n_epochs = 0, 0, 0
    keys = ("images", "poke", "flow", "sample_ids")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while got < n_batches:
        n_epochs += 1
        loader = dm.loader("train")
        # the epoch's first batches only: no loader work past what is timed
        loader.sampler = list(itertools.islice(loader.sampler, (n_batches - got) * cfg["batch_size"]))
        for batch in device_prefetch(loader, device, keys):
            zero += int((batch["sample_ids"] == -1).sum())
            got += 1
            if got == n_batches:
                break
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    b = cfg["batch_size"]
    out = {"batches": got, "epochs": n_epochs, "s": dt, "batches_per_s": got / dt,
           "samples_per_s": got * b / dt, "zero_poke_share": zero / (got * b),
           "train_examples": len(dm.datasets["train"])}
    log(f"data [{card}]: loader, augment {cfg['augment']}: {got} batches of {b} in {n_epochs} "
        f"epochs of {out['train_examples']} examples, {dt:.2f} s: {out['batches_per_s']:.3f} "
        f"batches/s, {out['samples_per_s']:.2f} samples/s; zero-poke share {out['zero_poke_share']:.4f}")
    return out


def _h2d(card, device, batch, reps=5):
    """Milliseconds of one batch's pinned, non-blocking copy to the card (CUDA events)."""
    keys = ("images", "poke", "flow")
    nbytes = sum(batch[k].nbytes for k in keys)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ms = []
    for _ in range(reps):
        pinned = {k: torch.from_numpy(batch[k]).pin_memory() for k in keys}
        torch.cuda.synchronize()
        start.record()
        for v in pinned.values():
            v.to(device, non_blocking=True)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    out = {"ms": _median(ms), "bytes": nbytes, "gb_per_s": nbytes / _median(ms) / 1e6}
    log(f"data [{card}]: H2D copy of one batch ({nbytes / 1e6:.1f} MB pinned, non-blocking): "
        f"median {out['ms']:.3f} ms of {reps}, {out['gb_per_s']:.2f} GB/s")
    return out


def _ae_batches(cfg, device, keys, n=2):
    """The first ``n`` batches of the tree's training loader on the card,
    cycled (the loader's own rate is timed above; at ~0.3 s per example a
    fresh batch of 16 per step would take most of the phase)."""
    dm = StaticDataModule(cfg, datakeys=keys + ("sample_ids",))
    first = []
    for batch in device_prefetch(dm.loader("train"), device, keys):
        first.append(batch)
        if len(first) == n:
            break
    while True:
        yield from first


def _ae_steps(card, device, name, step_fn, state, batches, steps):
    """One warm-up step then ``steps`` timed ones: host ms to a synchronised
    card, each phase's ms by CUDA events, the peak memory, the logs."""
    rng = prng.prng_key(0)
    hist = []
    held = torch.cuda.memory_allocated() / 2**30    # earlier phases' live tensors
    torch.cuda.reset_peak_memory_stats()
    for i in range(1 + steps):
        batch = next(batches)
        rng, sub = prng.split(rng)
        events = [torch.cuda.Event(enable_timing=True)]
        names = []

        def on_phase(phase):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
            names.append(phase)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        events[0].record()
        if isinstance(state, train_enc.AETrainState):
            state, logs = step_fn(state, batch, sub, on_phase=on_phase)
        else:
            state, logs = step_fn(state, batch, sub)
            on_phase("events")
        torch.cuda.synchronize()
        h = {k: float(v) for k, v in logs.items()}
        h["step_ms"] = (time.perf_counter() - t0) * 1e3
        h.update({f"{n}_ms": events[j].elapsed_time(events[j + 1]) for j, n in enumerate(names)})
        hist.append(h)
        log(f"data [{card}]: {name} step {i}{' (warm-up)' if i == 0 else ''}: "
            + ", ".join(f"{k} {v:.6g}" for k, v in h.items()))
    peak = torch.cuda.max_memory_allocated() / 2**30
    timed = hist[1:]
    out = {"step_ms_median": _median([h["step_ms"] for h in timed]), "peak_gib": peak,
           "held_gib": held, "history": hist}
    for k in hist[0]:
        if k.endswith("_ms") and k != "step_ms":
            out[f"{k}_median"] = _median([h[k] for h in timed])
    log(f"data [{card}]: {name}: median step {out['step_ms_median']:.1f} ms of {steps}"
        + "".join(f", {k[:-10]} {v:.1f} ms" for k, v in out.items()
                  if k.endswith("_ms_median") and k != "step_ms_median")
        + f"; peak {peak:.2f} GiB, {peak - held:.2f} above the {held:.2f} held before")
    if not all(np.isfinite(v) for h in hist for v in h.values()):
        raise SystemExit(f"data: {name}: a loss is not finite")
    return state, out


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.detach().to(dtype).requires_grad_(tree.requires_grad)


def _enc_card_vs_cpu(card, device, name, make, batch_np, keys):
    """One step of ``make(device, dtype) -> (state, step_fn)`` on the card
    and on the CPU (TF32 off on the card, oneDNN off on the CPU) on the same
    batch: in f32 the logs (every loss and ``d_weight``) within ENC_TOL of
    the CPU's; in f64 the logs and the gradients (2 x Adam's first moment
    after one step of b1 0.5) within ENC_TOL.  The image AE's f32 gradients
    are printed beside them: its adaptive weight sets the adversarial
    gradient against the NLL's, and their sum is ill-conditioned in f32."""
    out = {}
    for dtype in (torch.float32, torch.float64):
        runs = {}
        for dev in (device, torch.device("cpu")):
            with torch.backends.mkldnn.flags(enabled=False):
                state, step_fn = make(dev, dtype)
                batch = {k: v.to(dtype) for k, v in to_device(batch_np, dev, keys).items()}
                t0 = time.perf_counter()
                new, logs = step_fn(state, batch, prng.prng_key(1))
                _sync(dev)
                runs[dev.type] = ({k: float(v) for k, v in logs.items()},
                                  [(2 * m).detach().cpu() for m in new.opt_state[0]["mu"]],
                                  time.perf_counter() - t0)
        (lc, gc, _), (lr, gr, sr) = runs["cuda"], runs["cpu"]
        tag = "f32" if dtype == torch.float32 else "f64"
        out[f"{tag}_logs_max_rel"] = max(abs(lc[k] - lr[k]) / (1 + abs(lr[k])) for k in lr)
        out[f"{tag}_grads_max_rel"] = max(float((a - b).abs().max() / (1 + b.abs().max()))
                                          for a, b in zip(gc, gr))
        out[f"{tag}_cpu_s"] = sr
    log(f"data [{card}]: {name} step, card against CPU: f32 logs max rel "
        f"{out['f32_logs_max_rel']:.3g} (f32 gradients {out['f32_grads_max_rel']:.3g}); f64 logs "
        f"{out['f64_logs_max_rel']:.3g}, gradients {out['f64_grads_max_rel']:.3g} over {len(gr)} "
        f"leaves (tolerance {ENC_TOL}; CPU step f32 {out['f32_cpu_s']:.1f} s, f64 "
        f"{out['f64_cpu_s']:.1f} s)")
    if not max(out["f32_logs_max_rel"], out["f64_logs_max_rel"], out["f64_grads_max_rel"]) <= ENC_TOL:
        raise SystemExit(f"data: the card's {name} step disagrees with the CPU's: {out}")
    return out


def _write_config(path, config):
    from ipoke_tpu_torch.config import save_yaml

    save_yaml(config, path)
    return path


def phase_data(device, card, entry, train_step_ms, tmp):
    """The data path on a prepared iPER-layout tree (``data/tree``: 4
    videos of 30 frames stored at 256^2 so the LANCZOS resize runs, PNG rows
    with all five filters, flow at lags 5 and 10, train.txt naming 3): the
    loader at entry's size (B=8, 4 workers, zero pokes) with augment off and
    on over DATA_BATCHES batches each and one batch's H2D copy; the image AE
    (the conditioner's width, variational) and the poke AE (the poke
    embedder's width) at B=AE_BATCH for 1 + AE_STEPS steps on two batches of
    the tree, each trainer's validation (lpips-val) with its top-k save, and
    the image AE's ``test`` through ``python -m ipoke_tpu_torch.main``; one
    step of each on the card against the CPU; then 2 steps of the stage-2
    trainer through ``main`` on the tree at entry's width and cut depth.
    Launch counts read around every path (none launches K1 or K2)."""
    t_phase = time.perf_counter()
    root = os.path.join(tmp, "iper")
    t0 = time.perf_counter()
    meta = write_tree(root, n_videos=DATA_VIDEOS, n_frames=DATA_FRAMES, size=DATA_STORED,
                      gaps=DATA_GAPS, train_videos=3)
    out = {"tree_s": time.perf_counter() - t0}
    try:
        import cv2  # noqa: F401
        mask = "GrabCut (cv2)"
    except ImportError:
        mask = "flow amplitude (no cv2)"
    log(f"data [{card}]: tree of {DATA_VIDEOS} videos x {DATA_FRAMES} frames at {DATA_STORED}^2 written in "
        f"{out['tree_s']:.1f} s; iPER's foreground masks by {mask}")
    out["mask"] = mask
    _zero_counts()
    out["loader"] = [_loader_run(card, device, data_config(meta, entry, augment=aug), DATA_BATCHES)
                     for aug in (False, True)]
    n = _counts()
    batch_np = next(iter(StaticDataModule(data_config(meta, entry)).loader("train")))
    out["h2d"] = _h2d(card, device, batch_np)
    log(f"data [{card}]: loader {out['loader'][0]['batches_per_s']:.3f} batches/s (augment off), "
        f"{out['loader'][1]['batches_per_s']:.3f} (on), against the stage-2 train step of the "
        f"train phase (one MaCowStep per level) {train_step_ms:.1f} ms ({1e3 / train_step_ms:.3f} steps/s); K1/K2 launches {n}")
    if n != (0, 0) or not all(0 < r["zero_poke_share"] < 0.5 for r in out["loader"]):
        raise SystemExit(f"data: the loader launched a kernel or drew no zero pokes: {out['loader']}")

    logs_root = os.path.join(tmp, "logs")
    for kind, name, keys in (("img_encoder", "image AE", ("images",)),
                             ("poke_encoder", "poke AE", ("poke", "flow", "images"))):
        nf_max = entry.nf_max_cond if kind == "img_encoder" else entry.nf_max_poke
        config = {"general": {"experiment": kind, "seed": 42, "base_dir": logs_root},
                  "data": data_config(meta, entry, b=AE_BATCH),
                  "architecture": {"nf_max": nf_max, "min_spatial_size": entry.min_spatial_size,
                                   "deterministic": kind == "poke_encoder"},
                  "training": {"lr": 1e-4, "w_kl": 1e-6, "gp_weight": 0.0, "n_epochs": 1,
                               "max_batches_per_epoch": 1, "max_val_batches": 1},
                  "logging": {"n_saved_ckpt": 2}}
        spec, disc_spec = experiment_enc.specs_from_config(config)

        def make(dev, dtype=torch.float32, spec=spec, disc_spec=disc_spec):
            key = prng.prng_key(42)
            if disc_spec is not None:
                st, opts = train_enc.init_image_ae(key, spec, disc_spec, device=dev)
                if dtype != torch.float32:
                    p, d = _cast(st.params, dtype), _cast(st.disc_params, dtype)
                    st = train_enc.AETrainState(0, p, d, opts["gen"].init(train_fs.trainable(p)),
                                                opts["disc"].init(train_fs.trainable(d)))
                return st, train_enc.make_image_ae_step(spec, disc_spec, opts)
            st, opt = train_enc.init_poke_ae(key, spec, device=dev)
            if dtype != torch.float32:
                p = _cast(st.params, dtype)
                st = train_enc.PokeAEState(0, p, opt.init(train_fs.trainable(p)))
            return st, train_enc.make_poke_ae_step(spec, opt)

        res = {"spec": {"nf_max": nf_max, "spatial_size": spec.spatial_size,
                        "variational": not spec.deterministic, "batch": AE_BATCH}}
        _zero_counts()
        state, step_fn = make(device)
        state, res["steps"] = _ae_steps(card, device, name, step_fn, state,
                                        _ae_batches(config["data"], device, keys), AE_STEPS)
        res["launches"] = dict(zip(("mcf_inverse", "macow_unit_inverse"), _counts()))
        del state
        res["card_vs_cpu"] = _enc_card_vs_cpu(
            card, device, name, make, {k: v[:2] for k, v in batch_np.items()}, keys)
        cfg_path = _write_config(os.path.join(tmp, f"{kind}.yaml"), config)
        _zero_counts()
        t0 = time.perf_counter()
        run = port_main.main(["-c", cfg_path, "-m", "smoke", "--device", "cuda"])
        train_s = time.perf_counter() - t0
        val = run["val"][-1]
        kept = sorted(f for f in os.listdir(run["ckpt_dir"]) if f.startswith("step="))
        log(f"data [{card}]: {name} trainer through main: {len(run['history'])} step, "
            f"validation lpips-val {val['lpips-val']:.6g} ({val['val_s']:.1f} s), kept {kept}; "
            f"{train_s:.1f} s; K1/K2 launches {_counts()}")
        res.update(trainer_s=train_s, val=val["lpips-val"], kept=kept)
        if kind == "img_encoder":
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", "ipoke_tpu_torch.main", "-c", cfg_path,
                                   "-m", "smoke", "--test", "fvd", "--device", "cuda"],
                                  cwd=str(ROOT), capture_output=True, text=True, timeout=300)
            test_s = time.perf_counter() - t0
            if proc.returncode != 0:
                raise SystemExit(f"data: main --test failed:\n{proc.stderr[-3000:]}")
            tested = json.loads(proc.stdout.strip().splitlines()[-1])
            rel = abs(tested["lpips-val"] - val["lpips-val"]) / (1 + abs(val["lpips-val"]))
            log(f"data [{card}]: python -m ipoke_tpu_torch.main --test (find_best, then validate): "
                f"lpips-val {tested['lpips-val']:.6g}, {test_s:.1f} s with start-up; relative "
                f"difference from the trainer's validation {rel:.3g} (tolerance {STAGE1_TEST_TOL})")
            if not rel <= STAGE1_TEST_TOL:
                raise SystemExit(f"data: the test of the best checkpoint disagrees: {tested} vs {val}")
            res.update(test_s=test_s, test=tested["lpips-val"])
        out[kind] = res

    # stage 2 on the tree: iper_128's width at cut depth, 2 steps through main
    config = train_config(entry)
    config["general"].update(experiment="second_stage", base_dir=logs_root)
    config["architecture"]["num_steps"] = list(TOPK_NUM_STEPS)
    config["data"] = data_config(meta, entry)
    config["training"].update(n_epochs=1, max_batches_per_epoch=10)
    cfg_path = _write_config(os.path.join(tmp, "second_stage.yaml"), config)
    _zero_counts()
    t0 = time.perf_counter()
    run = port_main.main(["-c", cfg_path, "-m", "smoke", "--device", "cuda", "--max-steps", "2"])
    s2_s = time.perf_counter() - t0
    n = _counts()
    hist = run["history"]
    log(f"data [{card}]: stage-2 trainer through main on the tree (num_steps {TOPK_NUM_STEPS}): "
        f"{len(hist)} steps, flow_loss {[round(h['flow_loss'], 4) for h in hist]}, step ms "
        f"{[round(h['step_s'] * 1e3, 1) for h in hist]}; {s2_s:.1f} s; K1/K2 launches {n}")
    if len(hist) != 2 or not all(np.isfinite(h["flow_loss"]) for h in hist) or n != (0, 0):
        raise SystemExit(f"data: the stage-2 trainer on the tree failed: {hist}, {n}")
    out["stage2"] = {"s": s2_s, "flow_loss": [h["flow_loss"] for h in hist],
                     "step_ms": [h["step_s"] * 1e3 for h in hist]}
    out["phase_s"] = time.perf_counter() - t_phase
    out["meta"] = meta
    log(f"data [{card}]: the phase took {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# the native host data engine (IPOKE_NATIVE=1)
# ---------------------------------------------------------------------------

NATIVE_BATCHES = 2         # timed loader batches per setting
NATIVE_TOL = 1e-6          # the engine's resize against its numpy twin
NATIVE_FRAMES = 10         # the tree's frames held against the twin


def _probe_compiler():
    """The host compiler the engine builds with: its version, whether an
    OpenMP program builds and runs, and whether zlib.h and png.h are found
    (the engine needs neither)."""
    out = {"cxx": native.CXX}
    ver = subprocess.run([native.CXX, "--version"], capture_output=True, text=True, timeout=60)
    out["version"] = ver.stdout.splitlines()[0] if ver.returncode == 0 else f"exit {ver.returncode}"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cxx_") as tmp:
        exe = os.path.join(tmp, "omp")
        src = "#include <omp.h>\nint main() { return omp_get_max_threads() > 0 ? 0 : 1; }\n"
        r = subprocess.run([native.CXX, "-fopenmp", "-x", "c++", "-", "-o", exe], input=src,
                           capture_output=True, text=True, timeout=120)
        ok = r.returncode == 0 and subprocess.run([exe], timeout=60).returncode == 0
        out["openmp"] = "builds and runs" if ok else f"fails: {r.stderr.strip()[-300:]}"
        for header in ("zlib.h", "png.h"):
            r = subprocess.run([native.CXX, "-fsyntax-only", "-x", "c++", "-"],
                               input=f"#include <{header}>\n", capture_output=True, text=True,
                               timeout=60)
            out[header] = "found" if r.returncode == 0 else "missing"
    return out


def phase_native(device, card, entry, meta):
    """The native engine on the data phase's tree: built from csrc/dataio.cpp
    by g++ (build seconds); the tree's first clip decoded bitwise
    data/image's bytes and, resized to entry's size, within NATIVE_TOL of
    the numpy twin, one frame at a time and through load_frames; its flows
    bitwise np.load; simulate_pokes on a seeded flow batch twice, bitwise;
    then the loader (NATIVE_BATCHES batches of B=8) with IPOKE_NATIVE=1 and
    without, in batches/s.  K1 and K2 launch nowhere here."""
    t_phase = time.perf_counter()
    _zero_counts()
    out = {"probe": _probe_compiler()}
    log(f"native [{card}]: {out['probe']}")
    info = native.build()
    out["build_s"] = info.seconds
    log(f"native [{card}]: engine {info.path.name} built by {native.CXX} "
        f"{' '.join(native.CXX_FLAGS)} in {info.seconds:.2f} s"
        + (" (reused)" if info.seconds == 0.0 else ""))
    with open(meta, "rb") as f:
        tree = pickle.load(f)
    root = os.path.dirname(meta)
    frames = [os.path.join(root, str(p)) for p in tree["img_path"][:NATIVE_FRAMES]]
    flows = [f for f in (os.path.join(root, str(p)) for row in tree["flow_paths"][:NATIVE_FRAMES]
                         for p in row) if os.path.isfile(f)]   # a video's last frames have none
    s = entry.spatial_size
    t0 = time.perf_counter()
    bytes_ok = all(np.array_equal(native.decode_png(p), image.read_png(p)) for p in frames)
    twins = np.stack([native.load_png_plain(p, s) for p in frames])
    one = np.stack([native.load_png(p, s) for p in frames])
    batch = native.load_frames([frames], s)[0]
    err = max(float(np.abs(one - twins).max()), float(np.abs(batch - twins).max()))
    flows_ok = all(np.array_equal(native.load_npy_flow(p), native.load_npy_flow_plain(p))
                   for p in flows)
    rng = np.random.default_rng(0)
    fb = np.zeros((BATCH, s, s, 2), np.float32)
    fb[:, s // 4:s // 2, s // 3:2 * s // 3] = rng.normal(0, 3, (BATCH, 1, 1, 2))
    fb += rng.normal(0, 0.2, fb.shape).astype(np.float32)
    pokes = [native.simulate_pokes(fb, seed=7) for _ in range(2)]
    pokes_ok = all(np.array_equal(a, b) for a, b in zip(*pokes)) and bool(
        (pokes[0][1][:, 0, 0] >= 0).all())
    out["checks"] = {"frames": len(frames), "bytes_bitwise": bytes_ok, "resize_max_abs_err": err,
                     "flows": len(flows), "flows_bitwise": flows_ok,
                     "pokes_deterministic": pokes_ok, "s": time.perf_counter() - t0}
    log(f"native [{card}]: {len(frames)} frames of {DATA_STORED}^2: decoded bytes bitwise "
        f"data/image's {bytes_ok}; at {s}^2 one by one and through load_frames within "
        f"{err:.3g} of the numpy twin (tolerance {NATIVE_TOL}); {len(flows)} flows bitwise "
        f"np.load {flows_ok}; simulate_pokes on {BATCH} seeded flows twice bitwise {pokes_ok}")
    if not (bytes_ok and err <= NATIVE_TOL and flows and flows_ok and pokes_ok):
        raise SystemExit(f"native: the engine disagrees with its numpy twin: {out['checks']}")
    loader = {}
    for name, env in (("native", "1"), ("numpy", None)):
        old = os.environ.pop("IPOKE_NATIVE", None)
        if env is not None:
            os.environ["IPOKE_NATIVE"] = env
        try:
            loader[name] = _loader_run(card, device, data_config(meta, entry), NATIVE_BATCHES)
        finally:
            os.environ.pop("IPOKE_NATIVE", None)
            if old is not None:
                os.environ["IPOKE_NATIVE"] = old
    out["loader"] = loader
    out["launches"] = dict(zip(("mcf_inverse", "macow_unit_inverse"), _counts()))
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"native [{card}]: loader {loader['native']['batches_per_s']:.3f} batches/s of {BATCH} at "
        f"{s}^2 with IPOKE_NATIVE=1 (bilinear), {loader['numpy']['batches_per_s']:.3f} without "
        f"(LANCZOS); K1/K2 launches {out['launches']}; the phase took {out['phase_s']:.1f} s")
    if any(out["launches"].values()):
        raise SystemExit(f"native: a kernel launched: {out['launches']}")
    return out


# ---------------------------------------------------------------------------
# data preparation: raw videos -> frames, PWC-lite flows, meta.p, NN ids
# ---------------------------------------------------------------------------

PREP_VIDEOS, PREP_FRAMES, PREP_STORED, PREP_SIZE, PREP_LAG = 4, 40, 256, 128, 10
PREP_TIMEOUT_S = 600       # the prepare child, the PWC-lite fit included
PREP_FLOW_TOL = 1e-4       # the card's pwc_flow against the CPU's, relative to 1 + max|ref|
# The clips are pwc.synthetic_pair_layered's kind, the regime PWC-lite is
# fitted on, at 256^2: a textured disc (radius 1/6 to 1/3.5 of the frame)
# over a textured background moving the other way (v_bg = -0.35 v_fg), each
# texture tanh of PREP_WAVES plane waves per channel (wavelengths
# PREP_WAVELENGTHS stored px), so a frame is the layers translated exactly.
# Over the lag at 128^2 the disc moves 4-7 px and the background 1.4-2.5 px.
# Checked on the child's flow files of every PREP_EVERY-th pair, outside the
# occlusion band (pwc.synthetic_pair_layered's) and a border as wide as the
# largest displacement: PWC-lite's mean EPE under PREP_EPE_RATIO of the mean
# displacement (the guards' clean-region limit) and under Horn-Schunck's on
# the same extracted frames; Horn-Schunck's under that of no flow.  On the
# CPU, of a 2.652 px mean displacement: JAX's own fit from 1234 (JAX's
# pwc_flow) 0.836 px, Horn-Schunck 1.477, JAX's flows with (dy, dx) swapped
# 2.270 (tests/test_torch_prepare.py, -m slow).
PREP_WAVES, PREP_WAVELENGTHS, PREP_EVERY = 24, (16.0, 80.0), 5
PREP_EPE_RATIO = 0.5
_PREP_LINES = {
    "fit": r"pwc: fit (\d+) steps .* \((\d+) fits?\) in ([\d.]+) s \(([\d.]+) ms per step\)",
    "validation": r"pwc: fit (\d+), validation \(value < limit\): (.*)",
    "flows": r"prepare: (\S+): extract ([\d.]+) s; (\d+) flow pairs in ([\d.]+) s",
    "meta": r"prepare: meta in ([\d.]+) s",
    "nn": r"prepare: nn ids in ([\d.]+) s",
}


def _texture(rng):
    """A smooth RGB texture as a function of position: ``at(sy, sx)`` is it
    on the stored grid shifted by (sy, sx), (H, W, 3) in (-1, 1), tanh of a
    sum of plane waves (as two matrix products: sin(a + b) splits)."""
    n = PREP_WAVES
    k = 2 * np.pi / rng.uniform(*PREP_WAVELENGTHS, (3, n))
    ang, phase = rng.uniform(0, 2 * np.pi, (2, 3, n))
    amp = rng.normal(0, np.sqrt(2.0 / n), (3, n))
    ky, kx = k * np.sin(ang), k * np.cos(ang)
    grid = np.arange(PREP_STORED, dtype=np.float64)

    def at(sy, sx):
        ay = (grid[:, None, None] - sy) * ky + phase      # (H, 3, n)
        ax = (grid[:, None, None] - sx) * kx              # (W, 3, n)
        u = np.concatenate([amp * np.sin(ay), amp * np.cos(ay)], -1)
        v = np.concatenate([np.cos(ax), np.sin(ax)], -1)
        return np.tanh(np.einsum("hcn,wcn->hwc", u, v))
    return at


def _layer_clip(rng):
    """One clip's motion and frames: ``(frame(t), mask(t, q))``, frame t at
    PREP_STORED^2 in [-1, 1] and the disc's soft mask of frame t at stored
    positions q (..., 2); the velocities (stored px per frame)."""
    fg, bg = _texture(rng), _texture(rng)
    speed, heading = rng.uniform(0.8, 1.4), rng.uniform(0, 2 * np.pi)
    v_fg = speed * np.array([np.sin(heading), np.cos(heading)])
    v_bg = -0.35 * v_fg
    radius = rng.uniform(PREP_STORED / 6.0, PREP_STORED / 3.5)
    c0 = rng.uniform(0.35, 0.65, 2) * PREP_STORED - v_fg * (PREP_FRAMES - 1) / 2

    def mask(t, q):
        d = np.sqrt(((q - c0 - v_fg * t) ** 2).sum(-1))
        return 1.0 / (1.0 + np.exp(-(radius - d) / 3.0))   # the regime's 1.5 px edge at 128^2

    yy, xx = np.mgrid[0:PREP_STORED, 0:PREP_STORED].astype(np.float64)
    pos = np.stack([yy, xx], -1)

    def frame(t):
        m = mask(t, pos)[..., None]
        return m * fg(*(v_fg * t)) + (1 - m) * bg(*(v_bg * t))
    return frame, mask, v_fg, v_bg


def _prep_videos(root, with_cv2, seed=0):
    """PREP_VIDEOS clips of moving textured layers, PREP_FRAMES frames at
    PREP_STORED^2: MJPG .avi files with cv2, else the frames themselves at
    PREP_SIZE^2 (utils/video.save_image, resized by data/image).  Returns
    each clip's (mask, v_fg, v_bg)."""
    from ipoke_tpu_torch.data.image import resize
    from ipoke_tpu_torch.utils.video import save_image, to_uint8

    rng = np.random.default_rng(seed)
    motion = {}
    for v in range(PREP_VIDEOS):
        name = f"clip{v}"
        frame, mask, v_fg, v_bg = _layer_clip(rng)
        motion[name] = (mask, v_fg, v_bg)
        if with_cv2:
            import cv2

            os.makedirs(root, exist_ok=True)
            writer = cv2.VideoWriter(os.path.join(root, f"{name}.avi"), cv2.VideoWriter_fourcc(*"MJPG"),
                                     25, (PREP_STORED, PREP_STORED))
            for i in range(PREP_FRAMES):
                writer.write(np.ascontiguousarray(to_uint8(frame(i))[..., ::-1]))
            writer.release()
        else:
            for i in range(PREP_FRAMES):
                small = np.asarray(resize(to_uint8(frame(i)), (PREP_SIZE, PREP_SIZE)))
                save_image(small, os.path.join(root, name, f"frame_{i:06d}.png"), filters=range(5))
    return motion


def _layer_truth(mask, v_fg, v_bg, i):
    """Pair (i, i + PREP_LAG)'s flow at PREP_SIZE^2 in its pixels (dy, dx)
    and where it is checked: outside the occlusion band (either frame's disc
    mask between 0.02 and 0.98, pwc.synthetic_pair_layered's band) and a
    border as wide as the largest displacement."""
    s = PREP_SIZE / PREP_STORED
    qy, qx = np.mgrid[0:PREP_SIZE, 0:PREP_SIZE].astype(np.float64)
    q = (np.stack([qy, qx], -1) + 0.5) / s - 0.5          # output pixel centres on the stored grid
    m1, m2 = mask(i, q), mask(i + PREP_LAG, q)
    gt = m1[..., None] * (v_fg * PREP_LAG * s) + (1 - m1[..., None]) * (v_bg * PREP_LAG * s)
    occ = ((m1 > 0.02) | (m2 > 0.02)) & ~((m1 > 0.98) & (m2 > 0.98))
    edge = int(np.ceil(np.abs(v_fg).max() * PREP_LAG * s)) + 1
    keep = ~occ
    keep[:edge], keep[-edge:], keep[:, :edge], keep[:, -edge:] = False, False, False, False
    return gt.astype(np.float32), keep


def _motion_epe(motion, flows, frames_of, device):
    """Mean EPE against the layers' motion over every PREP_EVERY-th pair
    where ``_layer_truth`` checks it: of ``flows`` (clip -> the pairs'
    flows), of Horn-Schunck on the frames (``frames_of(clip, ids)``) on
    ``device`` and of no flow (the mean displacement)."""
    from ipoke_tpu_torch.ops import flow_ops, pwc

    ids = list(range(0, PREP_FRAMES - PREP_LAG, PREP_EVERY))
    sums = {k: [0.0, 0] for k in ("pwc", "hs", "zero")}
    for name, (mask, v_fg, v_bg) in motion.items():
        with torch.no_grad(), pwc.exact_f32():
            hs = flow_ops.estimate_flow(frames_of(name, ids).to(device),
                                        frames_of(name, [i + PREP_LAG for i in ids]).to(device)).cpu().numpy()
        for j, i in enumerate(ids):
            gt, keep = _layer_truth(mask, v_fg, v_bg, i)
            for k, f in (("pwc", flows[name][i]), ("hs", hs[j]), ("zero", np.zeros_like(gt))):
                e = np.sqrt(((f - gt) ** 2).sum(-1))
                sums[k][0] += float(e[keep].sum())
                sums[k][1] += int(keep.sum())
    return dict({k: a / n for k, (a, n) in sums.items()}, pixels=sums["pwc"][1], pairs=len(ids) * len(motion))


def phase_prep(device, card, entry, tmp):
    """Data preparation through ``python -m ipoke_tpu_torch.data.prepare``
    on the card: 4 clips of 40 frames at 256^2 of textured layers in known
    motion (MJPG .avi by cv2.VideoWriter), ``--mode all --spatial_size 128
    --flow_lag 10`` in a child process with IPOKE_WEIGHTS an empty
    directory, so PWC-lite fits itself on the card (``fit_pwc_weights``)
    and writes pwc_lite.npz; without cv2, ``extract_frames`` must raise
    ImportError, the frames are written at 128^2 and ``compute_flows`` runs
    here, then ``--mode prepare`` and ``--mode pose_estimation`` as
    children.  Checked: 30 finite (128, 128, 2) flows per clip, meta.p and
    meta_kp_nn.p (neighbours from other clips), the fitted net from the
    child's npz under the guards of the JAX package's tests/test_pwc.py on
    the card, the card's pwc_flow against the CPU's, the child's flows
    against the layers' known motion (``_motion_epe``); then one batch of
    the tree through StaticDataModule and 2 stage-2 steps through ``main``
    at entry's width and cut depth."""
    from ipoke_tpu_torch.data import prepare
    from ipoke_tpu_torch.ops import pwc

    t_phase = time.perf_counter()
    out = {}
    for mod in ("cv2", "PIL"):
        out[f"{mod}_imports"] = importlib.util.find_spec(mod) is not None
    log(f"prep [{card}]: cv2 importable: {out['cv2_imports']}; PIL importable: {out['PIL_imports']}")
    videos, tree = os.path.join(tmp, "videos"), os.path.join(tmp, "tree")
    weights = os.path.join(tmp, "weights")
    os.makedirs(weights)
    env = dict(os.environ, IPOKE_WEIGHTS=weights)
    t0 = time.perf_counter()
    motion = _prep_videos(videos if out["cv2_imports"] else tree, out["cv2_imports"])
    out["videos_s"] = time.perf_counter() - t0
    cmd = [sys.executable, "-m", "ipoke_tpu_torch.data.prepare", "--out", tree,
           "--spatial_size", str(PREP_SIZE), "--flow_lag", str(PREP_LAG)]
    _zero_counts()
    t0 = time.perf_counter()
    if out["cv2_imports"]:
        runs = [subprocess.run(cmd + ["--mode", "all", "--video_dir", videos], cwd=str(ROOT), env=env,
                               capture_output=True, text=True, timeout=PREP_TIMEOUT_S)]
    else:
        try:
            prepare.extract_frames(os.path.join(videos, "clip0.avi"), tree, PREP_SIZE)
            raise SystemExit("prep: extract_frames ran without cv2")
        except ImportError:
            log(f"prep [{card}]: extract_frames raises ImportError without cv2, as JAX's does")
        held = os.environ.get("IPOKE_WEIGHTS")
        os.environ["IPOKE_WEIGHTS"] = weights
        pwc.default_params.cache_clear()
        try:
            prepare.fit_pwc_weights(device)
            for name in sorted(motion):
                frames = sorted(os.path.join(tree, name, f) for f in os.listdir(os.path.join(tree, name)))
                prepare.compute_flows(frames, PREP_LAG, os.path.join(tree, name))
        finally:
            pwc.default_params.cache_clear()
            os.environ.pop("IPOKE_WEIGHTS")
            if held is not None:
                os.environ["IPOKE_WEIGHTS"] = held
        runs = [subprocess.run(cmd + ["--mode", mode], cwd=str(ROOT), env=env, capture_output=True,
                               text=True, timeout=PREP_TIMEOUT_S)
                for mode in ("prepare", "pose_estimation")]
    out["command_s"] = time.perf_counter() - t0
    for r in runs:
        if r.returncode != 0:
            raise SystemExit(f"prep: the prepare child failed:\n{r.stderr[-3000:]}")
    err = "".join(r.stderr for r in runs)
    parsed = {k: re.findall(p, err) for k, p in _PREP_LINES.items()}
    if out["cv2_imports"]:
        (steps, fits, fit_s, step_ms), = parsed["fit"]
        out["fit"] = {"steps": int(steps), "fits": int(fits), "s": float(fit_s),
                      "ms_per_step": float(step_ms), "validation": [v for _, v in parsed["validation"]]}
        for i, v in parsed["validation"]:
            log(f"prep [{card}]: fit {i}, validation (value < limit): {v}")
        out["flows"] = [{"clip": c, "extract_s": float(e), "pairs": int(n), "s": float(s)}
                        for c, e, n, s in parsed["flows"]]
        pairs, flow_s = sum(f["pairs"] for f in out["flows"]), sum(f["s"] for f in out["flows"])
        out["pairs_per_s"] = pairs / flow_s
    out["meta_s"], out["nn_s"] = float(parsed["meta"][0]), float(parsed["nn"][0])
    log(f"prep [{card}]: python -m ipoke_tpu_torch.data.prepare ({'--mode all' if out['cv2_imports'] else '--mode prepare, then --mode pose_estimation'}) "
        f"took {out['command_s']:.1f} s with start-up: "
        + (f"PWC-lite fit {out['fit']['steps']} steps ({out['fit']['fits']} fits) in {out['fit']['s']:.1f} s "
           f"({out['fit']['ms_per_step']:.2f} ms per step); {pairs} flow pairs at B=8 and "
           f"{PREP_SIZE}^2 in {flow_s:.2f} s ({out['pairs_per_s']:.1f} pairs/s); " if out["cv2_imports"] else "")
        + f"meta {out['meta_s']:.3f} s, NN ids {out['nn_s']:.3f} s")

    # the tree: flows, meta.p, meta_kp_nn.p
    n_pairs = PREP_FRAMES - PREP_LAG
    flows = {}
    for name in sorted(motion):
        d = os.path.join(tree, name)
        files = sorted(f for f in os.listdir(d) if f.endswith(".flow.npy"))
        want = sorted(f"prediction_{i}_{i + PREP_LAG}.flow.npy" for i in range(n_pairs))
        if files != want or len([f for f in os.listdir(d) if f.startswith("frame_")]) != PREP_FRAMES:
            raise SystemExit(f"prep: {name} holds {files[:3]}... ({len(files)} flows), want {n_pairs}")
        flows[name] = [np.load(os.path.join(d, f"prediction_{i}_{i + PREP_LAG}.flow.npy"))
                       for i in range(n_pairs)]
        if not all(f.shape == (PREP_SIZE, PREP_SIZE, 2) and np.isfinite(f).all() for f in flows[name]):
            raise SystemExit(f"prep: {name}'s flows are not finite ({PREP_SIZE}, {PREP_SIZE}, 2)")
    with open(os.path.join(tree, "meta_kp_nn.p"), "rb") as f:
        meta = pickle.load(f)
    nn = meta["nn_ids"]
    if len(nn) != PREP_VIDEOS * n_pairs or (meta["vid"][nn] == meta["vid"]).any():
        raise SystemExit(f"prep: meta_kp_nn.p holds {len(nn)} ids or a neighbour from the same clip")
    out["meta_rows"] = len(nn)

    # the fitted net, from the child's npz, on the card
    _zero_counts()
    params = pwc.load_params(os.path.join(weights, "pwc_lite.npz"), device)
    guards = pwc.regime_guards(params, device)
    out["guards"] = [{"check": c, "value": v, "limit": lim, "against_hs": rel} for c, v, lim, rel in guards]
    for c, v, lim, _ in guards:
        log(f"prep [{card}]: guard {c}: {v:.4f} < {lim:.4f}: {v < lim}")
    if not all(v < lim for _, v, lim, _ in guards):
        raise SystemExit(f"prep: the fitted PWC-lite fails a guard: {guards}")
    from ipoke_tpu_torch.data.image import read_png

    def frames_of(name, ids):
        return torch.from_numpy(np.stack([
            np.asarray(read_png(os.path.join(tree, name, f"frame_{i:06d}.png")), np.float32) / 127.5 - 1
            for i in ids]))

    f1, f2 = frames_of("clip0", (0, 1)), frames_of("clip0", (PREP_LAG, PREP_LAG + 1))
    with torch.no_grad(), torch.backends.mkldnn.flags(enabled=False):
        on_card = pwc.pwc_flow(params, f1.to(device), f2.to(device)).cpu()
        on_cpu = pwc.pwc_flow(pwc.load_params(os.path.join(weights, "pwc_lite.npz")), f1, f2)
    rel = float((on_card - on_cpu).abs().max() / (1 + on_cpu.abs().max()))
    out["card_vs_cpu_rel"] = rel
    out["card_vs_child_rel"] = float(np.abs(on_card[0].numpy() - flows["clip0"][0]).max()
                                     / (1 + np.abs(flows["clip0"][0]).max()))
    motion_epe = _motion_epe(motion, flows, frames_of, device)
    out["motion"] = motion_epe
    n = _counts()
    out["launches"] = dict(zip(("mcf_inverse", "macow_unit_inverse"), n))
    log(f"prep [{card}]: pwc_flow card against CPU (same npz, 2 pairs at {PREP_SIZE}^2): max rel "
        f"{rel:.3g} (tolerance {PREP_FLOW_TOL}); against the child's flow file {out['card_vs_child_rel']:.3g}; "
        f"the layers' known motion on {motion_epe['pairs']} pairs ({motion_epe['pixels']} pixels outside "
        f"the occlusion band and border, mean displacement {motion_epe['zero']:.3f} px): the child's "
        f"PWC-lite flows mean EPE {motion_epe['pwc']:.3f} px (limits {PREP_EPE_RATIO} of the displacement, "
        f"{PREP_EPE_RATIO * motion_epe['zero']:.3f}, and Horn-Schunck's), Horn-Schunck on the extracted "
        f"frames {motion_epe['hs']:.3f} px (limit: no flow's, the displacement); K1/K2 launches {n}")
    if not rel <= PREP_FLOW_TOL or not out["card_vs_child_rel"] <= PREP_FLOW_TOL:
        raise SystemExit(f"prep: the card's pwc_flow disagrees with the CPU's or the child's: {out}")
    if (not motion_epe["pwc"] < PREP_EPE_RATIO * motion_epe["zero"] or not motion_epe["pwc"] < motion_epe["hs"]
            or not motion_epe["hs"] < motion_epe["zero"] or n != (0, 0)):
        raise SystemExit(f"prep: the child's flows miss the layers' known motion, or a kernel launched: {out}")

    # the chain into training: the port's loader, then 2 stage-2 steps
    cfg = data_config(os.path.join(tree, "meta.p"), entry)
    dm = StaticDataModule(cfg)
    batch = next(iter(dm.loader("train")))
    shapes = {k: tuple(batch[k].shape) for k in ("images", "poke", "flow")}
    sz = entry.spatial_size
    want = {"images": (cfg["batch_size"], entry.max_frames, sz, sz, 3),
            "poke": (cfg["batch_size"], sz, sz, 2), "flow": (cfg["batch_size"], sz, sz, 2)}
    log(f"prep [{card}]: StaticDataModule on the prepared tree (IperDataset, {len(dm.datasets['train'])} "
        f"train examples): one batch {shapes}")
    if shapes != want or not all(np.isfinite(batch[k]).all() for k in shapes):
        raise SystemExit(f"prep: the loader's batch on the prepared tree: {shapes}, want {want}")
    config = train_config(entry)
    config["general"].update(experiment="second_stage", base_dir=os.path.join(tmp, "logs"))
    config["architecture"]["num_steps"] = list(TOPK_NUM_STEPS)
    config["data"] = cfg
    config["training"].update(n_epochs=1, max_batches_per_epoch=10)
    cfg_path = _write_config(os.path.join(tmp, "second_stage.yaml"), config)
    _zero_counts()
    t0 = time.perf_counter()
    run = port_main.main(["-c", cfg_path, "-m", "prep", "--device", "cuda", "--max-steps", "2"])
    s2_s = time.perf_counter() - t0
    n = _counts()
    hist = run["history"]
    log(f"prep [{card}]: stage-2 trainer through main on the prepared tree (num_steps "
        f"{TOPK_NUM_STEPS}): {len(hist)} steps, flow_loss {[round(h['flow_loss'], 4) for h in hist]}; "
        f"{s2_s:.1f} s; K1/K2 launches {n}")
    if len(hist) != 2 or not all(np.isfinite(h["flow_loss"]) for h in hist) or n != (0, 0):
        raise SystemExit(f"prep: the stage-2 trainer on the prepared tree failed: {hist}, {n}")
    out["stage2"] = {"s": s2_s, "flow_loss": [h["flow_loss"] for h in hist]}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"prep [{card}]: the phase took {out['phase_s']:.1f} s")
    return out


def ptxas_report(log_text):
    """registers / shared memory / spills lines of nvcc -Xptxas -v."""
    keep = [ln.strip() for ln in log_text.splitlines()
            if re.search(r"registers|spill|smem|Compiling entry", ln)]
    return keep


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this smoke run needs a CUDA card")
    device = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {card} | torch {torch.__version__} CUDA {torch.version.cuda} | "
        f"{torch.cuda.device_count()} visible")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"device: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    t_run = t0 = time.perf_counter()
    infos = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s wall for {len(infos)} kernels (parallel nvcc)")
    for name, info in infos.items():
        log(f"build: {name}: {info.seconds:.1f} s, {info.path.name}")
        for line in ptxas_report(info.log):
            log(f"build:   {line}")

    entry = registry.MODELS[registry.FLAGSHIP]
    spec = registry.build_specs(entry)
    spec = replace(spec, first_stage=replace(spec.first_stage, decode_dtype="bf16")).validate()
    levels = list(zip(spec.flow.level_channels(), spec.flow.num_steps))
    kernels = phase_kernels(device, card, flagship_levels=levels)

    t0 = time.perf_counter()
    params = synth.synth_params(spec, seed=0, device=device)
    params = dict(params, flow=synth.zero_flow_output_convs(params["flow"]))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in train_ss.leaves(params))
    log(f"slice: {registry.FLAGSHIP} full width, {sum(spec.flow.num_steps)} MaCowSteps in "
        f"{len(spec.flow.num_steps)} levels, {n_params / 1e9:.3f} G params "
        f"({4 * n_params / 1e9:.2f} GB f32) synthesised on the card in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    res = phase_slice(device, card, spec, params)
    peak = torch.cuda.max_memory_allocated()
    steady = res["latency_s"][1:] or res["latency_s"]
    mean_s = sum(steady) / len(steady)
    log(f"slice [{card}]: latency per call of {BATCH} videos on 'cuda_unit': first "
        f"{res['latency_s'][0] * 1e3:.1f} ms, then {', '.join(f'{x * 1e3:.1f}' for x in steady)} ms; "
        f"{BATCH / mean_s:.2f} videos/s; peak memory {peak / 2**30:.2f} GiB")
    phase_cross_check(device, spec, params)
    variants = phase_variants(device, card)
    overhead = op_overhead(device, log, card)
    serve = phase_serve(card, spec, params, steady)
    phase_serve_check(device, spec, params)
    t0 = time.perf_counter()
    dist, student = phase_distill(device, card, spec, params, steady)
    log(f"distill: the phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_artifact_") as tmp:
        art = phase_artifact(device, card, spec, params, student, Path(tmp))
    log(f"artifact: the phase took {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as tmp:
        ev, cut = phase_eval(device, card, entry, spec, params, tmp)
        ev2 = phase_eval2(device, card, entry, spec, params, tmp, cut)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ingest_") as tmp:
        ingest = phase_ingest(device, card, entry, params, tmp)
    del params
    torch.cuda.empty_cache()   # the parallel phase's ranks need the card
    parallel = phase_parallel(card, spec)
    train = phase_train(device, card, entry)
    torch.cuda.empty_cache()   # the child of the resume phase needs the train step's memory
    with tempfile.TemporaryDirectory(prefix="chip_smoke_resume_") as tmp:
        resume = phase_resume(device, card, entry, tmp)
    stage1 = phase_stage1(device, card, entry)
    stage1_variants = phase_stage1_variants(device, card, entry)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tools_") as tmp:
        tools = phase_tools(device, card, entry, tmp)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_data_") as tmp:
        data = phase_data(device, card, entry, train["step_ms_median"], tmp)
        nat = phase_native(device, card, entry, data["meta"])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_prep_") as tmp:
        prep = phase_prep(device, card, entry, tmp)

    src = "ipoke_tpu_torch/csrc/{}.cu"
    rows = [
        dict(name=name, route="cuda", source=src.format(source), replaces=replaces,
             launches=res["launches"][name], serve_launches=serve["launches"][name],
             distill_direct_step_launches=dist["direct"]["launches_per_step"][name],
             distill_flow_roundtrip_launches=dist["flow"]["roundtrip_launches"][name],
             artifact_flow_call_launches=art["flow"]["launches_per_call"][name],
             artifact_student_serve_launches=art["student"]["launches"][name],
             train_step_launches=train["launches"][name],
             train_roundtrip_launches=train["roundtrip_launches"][name],
             stage1_step_launches=stage1["launches"][name],
             **{f"eval_{m}_launches": ev[m]["launches"][name]
                for m in ("run_fvd", "run_diversity", "run_samples", "validate", "test_fvd")},
             **{f"eval_{m}_launches": ev2[m]["launches"][name]
                for m in ("accuracy", "kps_acc", "control_sensitivity", "transfer")},
             gui_poke_launches=[p[name] for p in ev2["gui"]["launches_per_poke"]],
             eval_topk_train_launches=ev["topk"]["launches"][name],
             eval_topk_resume_launches=ev["topk_resume"]["launches"][name],
             resume_train_step_launches=resume["launches"][name],
             eval_stage1_test_launches=stage1["test_launches"][name],
             stage1_variants_launches=stage1_variants["launches"][name],
             tools_train_step_launches=tools["per_level"]["launches"][0 if name == "mcf_inverse"
                                                                       else 1],
             tools_e2e_launches=tools["bench_e2e"]["launches"][0 if name == "mcf_inverse" else 1],
             tools_e2e_launches_per_sampling_call=[
                 c[0 if name == "mcf_inverse" else 1] for c in tools["bench_e2e"]["per_call"]["sampling"]],
             tools_e2e_launches_per_teacher_reverse=[
                 c[0 if name == "mcf_inverse" else 1]
                 for c in tools["bench_e2e"]["per_call"]["teacher_reverse"]],
             image_ae_step_launches=data["img_encoder"]["launches"][name],
             poke_ae_step_launches=data["poke_encoder"]["launches"][name],
             prep_launches=prep["launches"][name],
             ingest_self_check_launches=ingest["child_launches"]["self_check"][name],
             ingest_gate_launches=ingest["child_launches"]["gate"][name],
             ingest_reload_sample_launches=ingest["launches"][name],
             parallel_sample_launches=[r["sample"][k]["launches"][name]
                                       for r in parallel["gloo"]["reports"]
                                       for k in ("z_fixed", "z_drawn")],
             parallel_train_step_launches=[leg["launches"][name]
                                           for r in parallel["gloo"]["reports"]
                                           for leg in r["ok"] + [r["fsdp"]]],
             parallel_micro_train_step_launches=[leg["launches"][name]
                                                 for leg in parallel["gloo"]["micro"]],
             native_phase_launches=nat["launches"][name],
             variant_launches={leg: {backend: n[name] for backend, n in v["launches"].items()}
                               for leg, v in variants.items() if leg != "phase_s"},
             variant_roundtrip_launches={leg: v["roundtrip_launches"][name]
                                         for leg, v in variants.items() if leg != "phase_s"},
             **{k: kernels[name][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                              "bound_by")},
             library_ms=None)
        for name, source, replaces in (
            ("mcf_inverse", "mcf_inverse", "ipoke_tpu/ops/pallas/mcf_inverse.py:79"),
            ("macow_unit_inverse", "mcf_unit_inverse", "ipoke_tpu/ops/pallas/mcf_unit_inverse.py:172"))
    ]
    for r in rows:   # each kernel's G at level 0; K2's one-slice shapes
        r["cluster"] = kernels[r["name"]]["cluster"]
        if "one_slice" in kernels[r["name"]]:
            r["one_slice"] = kernels[r["name"]]["one_slice"]
    if any(r["launches"] == 0 for r in rows):
        raise SystemExit(f"a kernel of the path never launched: {rows}")
    log(f"smoke: every phase held, {time.perf_counter() - t_run:.1f} s from the build's start")
    print(json.dumps({"variants": variants}, default=float), flush=True)
    print(json.dumps({"parallel": parallel}, default=float), flush=True)
    print(json.dumps({"ingest": ingest}, default=float), flush=True)
    print(json.dumps({"prep": prep}, default=float), flush=True)
    print(json.dumps({"data": data}, default=float), flush=True)
    print(json.dumps({"native": nat}, default=float), flush=True)
    print(json.dumps({"eval": ev}, default=float), flush=True)
    print(json.dumps({"eval2": ev2}, default=float), flush=True)
    print(json.dumps({"stage1": stage1}, default=float), flush=True)
    print(json.dumps({"stage1_variants": stage1_variants}, default=float), flush=True)
    print(json.dumps({"stage1_variants_phase_s": stage1_variants["phase_s"]}), flush=True)
    print(json.dumps({"tools": tools}, default=float), flush=True)
    print(json.dumps({"resume": resume}), flush=True)
    print(json.dumps({"train": train}), flush=True)
    print(json.dumps({"distill": dist, "artifact": art, "op_overhead": overhead}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
