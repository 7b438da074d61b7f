#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU: ``python3 chip_smoke.py``.

Phases, each printing one JSON object per line (with its seconds):
  1. build   — compiles the port's CUDA kernels (``puzzlefusion_plusplus_tpu_torch/csrc``)
               for sm_90a and the native host core (``utils/native.py``, g++; fails if it
               does not build); prints the card's name and power limit from nvidia-smi.
  2. kernels — every kernel (S, F, G, N, M, P of inference; F, G, N, A, B of training; R
               of the 'always' encoder mode) at the shapes each path gives it (training's at
               M = 160 clouds), on seeded inputs, against its plain PyTorch version on the card
               (P also against F):
               error, exact-index agreement, and CUDA-event times of the kernel, the plain
               version and (where one exists) a single PyTorch library call. G, A, B, N
               and M also time the bare launch into buffers made beforehand (``kernel_ms``,
               beside ``ms``, the call as callers make it) and the bare launch replayed from
               a CUDA graph (``kernel_graph_ms``: the card's time without host gaps), G, A
               and B also their library call so (``library_graph_ms``). N and M are held
               bit-equal to their plain versions and across two launches, N also at the b8
               engine's shape_cd input ([8,12000], built by ``utils/metrics.py::
               shape_cd_clouds``) and M also at the b8 merge's pad (B = 8, P = 12); their
               records add under ``computed`` the issue-slot bound (8 unfused FP32
               operations a pair, one slot each on 128 lanes an SM at the max SM clock that
               nvidia-smi reports) and the measured slots a pair. A and S also run at the
               denoiser's frozen-encode shapes (M = 1280) and B with every row to one index,
               all listed under ``per_shape`` and left out of the step's sum. S and R
               compute in 3xTF32 on the tensor cores: their ``bound_ms`` counts three TF32
               MMAs per product at 495 TFLOP/s. Their per-shape records add, under
               ``computed`` (worked out, not measured), the same work's bound on the CUDA
               cores (``bound_fp32_ms``), the kernel's rows per block and the weight bytes its
               blocks read from L2 (``l2_weight_bytes``, and with 64-row blocks). Both must
               be bit-equal across two launches, as must F and P, which are also held to
               the plain indices at the inference cache build's three stages and P to F's at
               the merge resample's pads; their records add ``us_per_selection`` (ms / npoint)
               and the block shape under ``computed``.
 2b. fps_shapes — F and P at every block shape they can take (blocks a cloud, points a
               thread in registers, threads), each bit-equal to the plain version: the ms of
               each beside the shape the wrapper picks (``ops/fps.py::cluster_shape``).
  3. engine  — the full-width engine (``Config()`` defaults: VQ-VAE 1000 pts / 25x64 tokens /
               1024x16 codebook, denoiser 512/6/8, verifier 256/6/8, 6 iterations x 20 steps,
               fp32, batch 8) on 8 synthetic shapes of 3-12 parts (seed 7) through
               ``build_engine_fn`` + ``run_inference``, with seeded random weights.
  4. merge   — a forced-merge batch (2 shapes, no reference part, verifier threshold 0): every
               valid edge is predicted, so parts merge and kernel M and the merge FPS (P) run.
               The same batch and noise also go through the CPU engine (plain versions);
               discrete outcomes must agree and poses stay within 1e-3 (damped denoiser
               weights keep the 20-step recurrence contractive, as tests/test_bucketing.py).
  5. profile — torch.profiler over one more full-width engine call: self device time grouped
               into the port's kernels, matrix products and the rest, and the program's
               ``pfpp.*`` spans (count and host ms of each).
  6. train   — VQ-VAE training through its entry point ``training.vqvae.train`` at
               ``Config()``'s full ``ae`` width on 16 synthetic shapes of 3-12 parts (seed 11),
               batch 8 x 20 part slots = 160 clouds per step: one warm-up step and 5 timed
               steps; steps/s, valid parts/s, every step's losses, peak device memory, and
               the host seconds to build one batch (``loader_s_per_batch``: the trainers'
               ``prefetch_batches`` overlaps it with the step, except an epoch's first).
  7. train_parity — one train_step on the card and one on the CPU from the same weights and
               a 2-shape batch: loss, every gradient, BatchNorm statistics and the
               parameters after AdamW must agree (``training/parity.py``).
  8. profile_train — torch.profiler over one full-width training step, grouped as in 5.
  9. encoder_modes — the frozen encoder's three modes on the engine batch's 96 clouds at full
               width, randomly rotated, with the indices (and geometry) of the unrotated
               clouds: 'always' (kernel R), 'never' (the composable encode) and 'cached'
               (kernel S). z_e agrees within 1e-4 of its largest entry; codes agree except
               where the two nearest codes are within 1e-5; ms per encode of each mode.
 10. train_denoiser — stage-2 denoiser training through ``training.denoiser.train`` at
               ``Config()`` widths (denoiser 512/6/8, encoder ``Config().ae`` from phase 6's
               checkpoint, or seeded when phase 6 did not run), fp32, batch 64 at the
               20-slot pad (1280 encoder clouds a step), on 64 + 64 synthetic shapes of 3-12
               parts (seeds 13, 14): one warm-up step, 5 timed steps, one validation pass
               (the 20-step sampler through kernel S), then one step with
               ``denoiser.train_encode_cached``; steps/s, shapes/s, losses, eval metrics,
               peak device memory, the checkpoints written, ``loader_s_per_batch``.
 11. denoiser_parity — one denoiser train_step on the card and one on the CPU, full width,
               from the same weights, a 2-shape batch, the same timesteps and noise and no
               dropout: loss, every gradient and the parameters after AdamW must agree
               (``training/parity.py``).
 12. profile_denoiser — torch.profiler over one full-width denoiser training step.
 13. verifier_gen — verifier data from the full-width denoiser through
               ``data/verifier_gen.py`` (denoiser and encoder loaded from phases 10 and 6's
               checkpoints, seeded when those did not run): 8 synthetic train shapes of 3-12
               parts (seed 15) at the 20-part pad, one round; 8 files that
               ``VerifierDataset`` reads back with finite features, kernels S, F, G, N
               launched; seconds per shape. Phase 2 holds S (M = 20), F, G and N at this
               path's shapes against their plain versions (path "verifier_gen").
 14. train_verifier — verifier training through ``training.verifier.train`` at ``Config()``
               widths (256/6/8, 7 features, 190 edges) and the config's batch of 64, on 160
               synthetic verifier files (``data/synthetic.py::make_verifier_data_npz``, seed
               16; 128 train, 32 val): one warm-up step, 5 timed steps, one validation pass;
               steps/s, edges/s, peak device memory, the checkpoints written.
 15. verifier_parity — one verifier train_step on the card and one on the CPU, full width,
               batch 64, dropout off (``training/parity.py``).
 16. serve   — the b8 engine batch of phase 3 served through ``build_engine_fn`` with
               ``denoiser.encoder_ckpt_path``, ``denoiser.ckpt_path`` and
               ``verifier.ckpt_path`` naming phases 6, 10 and 14's checkpoints (a phase not
               run is stood in for by a saved seeded model), then with the same weights as
               ``state_dicts`` under the same generator seed: results equal; assemblies/s.
 17. train_matching — the Jigsaw matcher's entry ``matching.train.train_matching`` at its
               defaults (the reference jigsaw_4x4_128_512_250e width: PointNet++ MSG
               (1024, 256, 64, 16), 128/512 features, 8 heads, 16 kNN samples, Sinkhorn 20 x
               0.05, 5000 points, 20 parts, batch 1, Adam 1e-3 under cosine decay) with
               ``mat_epoch = rig_epoch = 0`` (all three losses) on 7 synthetic shapes of 3-12
               parts (seed 18): a warm-up step, 6 timed steps, one validation pass over 1
               shape (seed 20) and a top-k checkpoint; steps/s, points/s, peak memory, the
               loader's s a shape, val ``mat_f1`` (random weights: it measures nothing).
 18. matching_parity — one full-width matcher train_step on the card and one on the CPU
               (``training/parity.py::MATCHING``).
 18b. profile_matching — torch.profiler over one full-width matcher training step.
 19. matching_gen — the eval entry ``matching.eval`` writes matching_data for 1 shape
               (seed 19; 1, not more: 83-129 s a shape on an H100 machine's host, the
               Hungarian over nearly every one of the 5000 points) at the configuration's 5000
               points from phase 17's checkpoint (a saved seeded model without it); s a
               shape; the oracle mode once; then ``run_inference`` serves that shape (5 parts,
               bucketed to P = 8) from the written directory with the full-width seeded
               engine, finite metrics.
               Phase 2 holds F, G and B at the matcher's batch-1 shapes, which the writer's
               forward shares (path "train_matching": F on the 5000/1024/256/64-point
               stages, G on sa1-sa4's groupings, fp4's and fp1's interpolation and the
               PointTransformer's [1,5000,128] by [1,5000,16], B on the backward of those
               with a gradient, R = 80000 at C = 128 on the CSR route) and S, F, G and N at
               the serving run's M = 1 x 8 = 8 clouds (path "matching_serve").
 20. dp      — data parallelism (``parallel/``; the other phases run on one card,
               ``trainer.num_devices=1``): NCCL over up to 4 cards, or with one card 2 ranks
               on it over gloo (``dp_plan``: 4 ranks from 4 cards, else 2). One VQ-VAE, denoiser and verifier step at that
               world size W held to the one-process step (``training/parity.py::dp_steps``,
               ``compare``; BatchNorm statistics equal on every rank), and one full-width
               matcher step (one 5000-point shape a rank, ``parity.MATCHING``); each
               trainer's entry for 6 steps (the first warms up) at W: steps/s and peak
               memory per card, the VQ-VAE at global batch 8 W (the config's 64, 16 shapes a card, from 4 cards),
               the denoiser at 64 (16 on a shared card), the verifier at 64; the b8 engine
               batch through ``run_inference`` at W against one process, each with its
               engine built once and called twice (the second timed): per-shape
               ``breakdown.jsonl`` records and ``n_iters`` equal, mean metrics within 1e-3
               relative; assemblies/s of both. Phase 2 holds S, F, G and N at the
               engine's per-rank shapes (M = 8/W x 12 clouds, N also on the engine-shaped
               [8/W, 12000] shape_cd clouds) and F, G, N, A, B at each training rank's M
               where no other path gives them (path "dp").
 21. bench   — the port's benchmark entry ``python -m puzzlefusion_plusplus_tpu_torch.bench``
               in a subprocess: fp32, ``PFPP_BENCH_PRECISION=bf16``, and ``--serving`` with
               ``PFPP_BENCH_REPEATS=1`` (its 32 shapes made in a background process from the
               start): every line parses, no ``timing_suspect``; the fp32 value beside the
               engine phase's assemblies/s on the same b8 seed-7 batch.
 22. bf16    — ``trainer.precision=bf16``: the full-width denoiser trained 6 steps at batch 64
               (the first warms up; steps/s and peak memory beside phase 10's fp32), one bf16
               train_step on the card held to the CPU (``training/parity.py::BF16``), and the
               b8 engine batch served under bf16 (kernel S keeps its fp32 weights) with finite
               metrics; phase 2 holds G and A on bf16 rows at the denoiser's SA2 and SA3
               feature gathers (M = 1280, path "bf16").
 23. int8    — kernel S's int8 gather mode (``PFPP_SA_GATHER=int8``): the quantize kernel
               (``S int8 quantize``) bit-equal to its plain version at the engine's SA2
               [96,256,128] and SA3 [96,128,256] projections, each with an all-zero column;
               S's int8 instantiation (``S int8``) within 1e-4 relative of its plain version
               at the engine's SA2 and SA3 shapes (M = 96) and bit-equal across two launches,
               beside the exact S on the same inputs (``exact_kernel_ms``, and the whole
               stage, matmul and quantize included, ``stage_ms`` and ``exact_stage_ms``); its
               bound counts the codes as one byte each; then the b8 engine batch built under
               the variable (metrics finite, assemblies/s beside phase 3's exact call, SA1
               exact and SA2, SA3 int8 in every step), z_e of the int8 encode against the
               exact one on the engine batch's 96 clouds, and the bench entry under the
               variable (``sa_gather`` in its line).
 24. overfit — the overfit proof (``scripts/overfit_proof.py::run``) at ``Config()`` widths
               on one synthetic shape of 4-6 parts (seed 3), cut in depth (``OVERFIT_CUT``):
               the VQ-VAE at batch 1, the denoiser overfit at batch 64 (1280 encoder clouds a
               step) on the 20 inference timesteps with its curve, the verifier stage, then
               the engine over the shape without merging and with the verifier checkpoint,
               all served from the phase's own checkpoints. Fails unless every curve point
               and both engine results are finite, the loss on the held draws at the last
               evaluation is at most ``OVERFIT_MSE_FRACTION`` of its value after step 1, and
               the engine's checkpoints are the phase's. Phase 2 holds A and B at the VQ-VAE
               step's M = 20, G at its xyz gathers, F and G at the overfit step's M = 1280
               and N on the engine's [1, 20000] shape_cd clouds (path "overfit").
 25. matcher_eval — the matcher's train-and-eval driver (``scripts/matcher_train_eval.py::
               run``) at ``make_model()``'s widths, 2000 points, batch 4, POS_WEIGHT 4, cut in
               depth only (``MATCHER_EVAL``: 8 + 4 synthetic shapes of 2-20 parts, seeds 11
               and 12, 2 epochs with all three losses, validated after each): the oracle
               ceiling, training, the writer on the 4 held-out shapes, and the engine at
               ``Config()`` widths served from phases 6, 10 and 14's checkpoints (or their
               seeded stand-ins) on the written and on the GT-synthetic matching data; then
               ``scripts/matcher_diagnosis.py`` over 4 shapes of each split (regimes C and D,
               which no weight enters, also on the CPU: their critical sets, GT permutations
               and cross masks equal, D's scores within 1e-4 and F1 within 1e-3, C's within
               1e-3 and 5e-3; beside them the CPU's own float error in C and D,
               ``oracle_witness``) and
               ``scripts/matching_sensitivity_probe.py``. Fails unless every loss is finite,
               val ``mat_f1`` and every F1 lie in [0, 1], 4 files were written, both engine
               rows are finite, the engine served the 4 shapes in one batch at P = 20 and the
               probe covers the 4 shapes. Phase 2 holds F, G and B at the matcher's batch-4
               shapes (path "matcher_eval": F on [4,2000] through SA1-SA4 and stage B's
               [4,1000]->1024, more selections than points), and S, F, G and N at the
               engine's: the cache build at M = 4 x 20 = 80 clouds, N on the [80,1000] part
               clouds and on the [4,20000] engine-shaped shape_cd clouds.
Each path's launch counts are read from its own run: reset right before phase 3's second
(counted) engine call and read right after phase 4's GPU run (the inference path), reset
right before phase 6 and read right after it (the VQ-VAE training path), reset right before
phase 9's three encodes and read right after them (the encoder-modes path), reset right
before phase 10 and read right after it (the denoiser training path), and so for phases 13,
14 (which runs no kernel of the port), 16's checkpoint-loaded call, phase 17 (the matcher's
training path, "train_matching") and phase 19's writer ("matching_gen") and serving run
("matching_serve"); phase 20's counts are
each rank's, reset in the rank right before each entry run and summed over the ranks after it
(its parity steps are not counted); phase 22's are reset right before its training run and
read right after its engine call (path "bf16"); phase 23's are reset right before its
counted engine call and read right after it (path "int8"); phase 24's right before the
overfit run and read right after it (path "overfit"); phase 25's right before the driver
and read right after the probe (path "matcher_eval"). Then a ``kernels``
line lists every kernel with its path's count, its error and its times, and the last line is
``{"ok": true, "device": {...}}``. Any failure raises and the script exits non-zero without
that line. Needs one CUDA card; ``--phases`` picks phases.
"""

from __future__ import annotations

import argparse
import atexit
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
H100_FP32_FLOPS = 67e12  # FP32 outside the tensor cores, H100 SXM data sheet
# TF32 on the tensor cores, dense, H100 SXM data sheet. Kernels S and R compute each FP32
# product as three TF32 MMAs (3xTF32), so their bound is 3 x flops at this rate.
H100_TF32_FLOPS = 495e12
H100_BYTES_PER_S = 3.35e12
REPLACES = {
    "S": ("puzzlefusion_plusplus_tpu_torch/csrc/sa_cached.cu",
          "puzzlefusion_plusplus_tpu/ops/sa_fused_pallas.py:271"),
    "F": ("puzzlefusion_plusplus_tpu_torch/csrc/fps.cu",
          "puzzlefusion_plusplus_tpu/ops/fps.py:104"),
    "G": ("puzzlefusion_plusplus_tpu_torch/csrc/gather.cu",
          "puzzlefusion_plusplus_tpu/ops/gather_pallas.py:55"),
    "N": ("puzzlefusion_plusplus_tpu_torch/csrc/nn.cu",
          "puzzlefusion_plusplus_tpu/ops/chamfer_pallas.py:68"),
    "M": ("puzzlefusion_plusplus_tpu_torch/csrc/nn.cu",
          "puzzlefusion_plusplus_tpu/ops/chamfer_pallas.py:163"),
    "A": ("puzzlefusion_plusplus_tpu_torch/csrc/gather.cu",
          "puzzlefusion_plusplus_tpu/ops/gather_pallas.py:139"),
    "B": ("puzzlefusion_plusplus_tpu_torch/csrc/scatter_add.cu",
          "puzzlefusion_plusplus_tpu/ops/gather_pallas.py:182"),
    "R": ("puzzlefusion_plusplus_tpu_torch/csrc/sa_raw.cu",
          "puzzlefusion_plusplus_tpu/ops/sa_fused_pallas.py:123"),
    "P": ("puzzlefusion_plusplus_tpu_torch/csrc/fps.cu",
          "puzzlefusion_plusplus_tpu/ops/fps.py:167"),
    # S's 'int8' gather mode, and the quantization the JAX package runs outside its kernel
    "S int8": ("puzzlefusion_plusplus_tpu_torch/csrc/sa_cached.cu",
               "puzzlefusion_plusplus_tpu/ops/sa_fused_pallas.py:271"),
    "S int8 quantize": ("puzzlefusion_plusplus_tpu_torch/csrc/sa_cached.cu",
                        "puzzlefusion_plusplus_tpu/ops/sa_fused_pallas.py:317"),
}
INFERENCE_KERNELS, TRAIN_KERNELS = "SFGNMP", "FGNAB"
MERGE_ONLY_KERNELS = "MP"  # launched only when a merge fires (the merge phase)
ENCODER_MODE_KERNELS, DENOISER_KERNELS = "RSGA", "SFGNA"
VERIFIER_GEN_KERNELS, SERVE_KERNELS = "SFGN", "SFGN"
DP_KERNELS = "SFGNAB"  # the three trainers and the b8 engine batch, data-parallel
BF16_KERNELS = "SFGNA"  # bf16 denoiser training (F, G, A) and the bf16 engine (S, F, G, N)
# the matcher's training step, its test-mode forward in the writer, and the engine serving
# the written matching data
MATCHING_KERNELS, MATCHING_GEN_KERNELS, MATCHING_SERVE_KERNELS = "FGB", "FG", "SFGN"
# the overfit proof: VQ-VAE training (F, G, A, B, N), the overfit step's composable encode
# (F, G, A), the sampler and the engine (S, F, G, N; M and P only when a merge fires)
OVERFIT_KERNELS, OVERFIT_REQUIRED = "SFGNABMP", "SFGNAB"
# the overfit phase's cut in depth (its widths are Config()'s): steps of the VQ-VAE (batch
# 1), of the denoiser (batch 64) and of the verifier, and the evaluation cadence
OVERFIT_CUT = {"steps_ae": 300, "steps_dn": 150, "steps_vf": 400, "eval_every": 50}
# the learning check: the loss on the held draws at the last evaluation over its value
# after step 1 (fixed before the first run on the card, PERF.md §6)
OVERFIT_MSE_FRACTION = 0.5
# the matcher_eval phase: scripts/matcher_train_eval.py at make_model()'s widths and the
# driver's 2000 points, batch 4 and POS_WEIGHT, cut in depth only: 8 + 4 shapes, 2 epochs
# (MAT_EPOCH 0, RIG_EPOCH 1: all three losses), validated after each; the diagnosis over
# MATCHER_EVAL_DIAG_SHAPES shapes a split; stage B's 1000 points (kernels phase only)
MATCHER_EVAL = {"n_train": 8, "n_val": 4, "epochs": 2, "batch": 4, "num_points": 2000,
                "val_every": 1, "pos_weight": 4.0, "mat_epoch": 0, "rig_epoch": 1}
MATCHER_EVAL_DIAG_SHAPES, STAGE_B_POINTS = 4, 1000
# its engine serves the 4 held-out shapes (15, 2, 12 and 20 parts) in one batch bucketed to
# P = 20, so M = 4 x 20 = 80 clouds (the phase checks the bucket against this)
MATCHER_EVAL_SERVE_PARTS = 20
MATCHER_EVAL_SERVE_CLOUDS = MATCHER_EVAL["n_val"] * MATCHER_EVAL_SERVE_PARTS
# the CPU's own float error in regime C, beside the card's: s_oracle scaled by 1 + 1e-6 u
# (u uniform in [-1, 1], seeded) and the Sinkhorn in float64
ORACLE_JITTER = 1e-6
MATCHER_EVAL_KERNELS, MATCHER_EVAL_REQUIRED = "SFGNBMP", "SFGNB"  # M, P when a merge fires
PATH_KERNELS = {"inference": INFERENCE_KERNELS, "train": TRAIN_KERNELS,
                "encoder_modes": ENCODER_MODE_KERNELS, "train_denoiser": DENOISER_KERNELS,
                "verifier_gen": VERIFIER_GEN_KERNELS, "train_verifier": "",
                "serve": SERVE_KERNELS, "dp": DP_KERNELS, "train_matching": MATCHING_KERNELS,
                "matching_gen": MATCHING_GEN_KERNELS,
                "matching_serve": MATCHING_SERVE_KERNELS, "bf16": BF16_KERNELS,
                "int8": ("S", "S int8", "S int8 quantize", "F", "G", "N"),
                "overfit": OVERFIT_KERNELS, "matcher_eval": MATCHER_EVAL_KERNELS}
MAIN_PATH = {"A": "train", "B": "train", "R": "encoder_modes", "S int8": "int8",
             "S int8 quantize": "int8"}  # the rest: "inference"
SUMMED = ("S", "R", "A", "B", "S int8", "S int8 quantize")  # one step's shapes, summed
# the int8 S's other times at each shape, kept in the kernels line's per_shape
INT8_EXTRA = ("exact_kernel_ms", "stage_ms", "exact_stage_ms")


def matcher_gathers(n: int) -> tuple:
    """The matcher's gathers a shape of ``n`` points (N, C, index shape): sa1's xyz grouping,
    then those with a gradient (kernel B): sa2-sa4's feature groupings, fp4 and fp1, the
    PointTransformer's."""
    return ((n, 3, (1024, 32)), (1024, 96, (256, 32)), (256, 256, (64, 32)), (64, 512, (16, 32)),
            (16, 1024, (64, 3)), (1024, 128, (n, 3)), (n, 128, (n, 16)))


# synthetic shapes of 3-12 parts: 7 to train on (seed 18), 1 to validate on (seed 20) and 1
# to write matching data for (seed 19: 5 parts, which the engine serves bucketed to P = 8,
# so M = 8 clouds). Written at 5000 points, random weights call nearly every point a
# fracture point, and the host Hungarian over [5000, 5000] (scipy) takes 83-129 s a shape
# on the host of an H100 machine, so one shape is written
MATCHING_SHAPES, MATCHING_VAL_SHAPES, MATCHING_GEN_SHAPES = 7, 1, 1
MATCHING_SERVE_PARTS = 8
MATCHING_SERVE_CLOUDS = MATCHING_GEN_SHAPES * MATCHING_SERVE_PARTS
MATCHING_POINTS = 5000  # train_matching's and the eval entry's default: every shape's cloud


def dp_plan() -> dict:
    """The dp phase's layout: NCCL over 4 cards where there are 4 or more, else over 2 (2
    or 3 cards), or 2 ranks on one card over gloo; global batches and each rank's clouds
    (the kernels phase holds the kernels at the per-rank shapes that no other path gives
    them). Every global batch is a multiple of the world size."""
    import torch

    cards = torch.cuda.device_count()
    world = 4 if cards >= 4 else 2
    vqvae_batch = 64 if world >= 4 else 8 * world  # the config's 64: 16 shapes a card
    denoiser_batch = 64 if cards >= 2 else 16
    return {"cards": cards, "world": world, "share_card": cards < 2,
            "backend": "nccl" if cards >= 2 else "gloo", "vqvae_batch": vqvae_batch,
            "denoiser_batch": denoiser_batch, "verifier_batch": 64, "engine_batch": 8,
            "train_clouds": sorted({vqvae_batch // world * 20, denoiser_batch // world * 20}
                                   - {160}),  # M = 160: the train path's, held already
            "engine_clouds": 8 // world * 12}  # the b8 batch is bucketed to P = 12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def sm_clock_mhz() -> float:
    """The card's max SM clock (nvidia-smi), the clock of the issue-slot bounds."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return float(out.stdout.strip().splitlines()[0])


def nn_engine_clouds(gen, B: int, P: int, N: int = 1000):
    """Kernel N's input at the engine's shape_cd call, built by ``utils/metrics.py::
    shape_cd_clouds`` as the engine builds it: B shapes of 3 to P valid parts of N points
    (each part a blob around its own centre), the padded parts at 1e3, two random poses."""
    import torch

    from puzzlefusion_plusplus_tpu_torch.utils.metrics import shape_cd_clouds
    from puzzlefusion_plusplus_tpu_torch.utils.transforms import quat_normalize

    dev = gen.device
    r = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    pts = 0.4 * r(B, P, 1, 3) + 0.1 * r(B, P, N, 3)
    valids = (torch.arange(P, device=dev) < torch.linspace(3, P, B, device=dev).round()[:, None])
    poses = [(0.2 * r(B, P, 3), quat_normalize(r(B, P, 4))) for _ in range(2)]
    return shape_cd_clouds(pts, poses[0][0], poses[1][0], poses[0][1], poses[1][1],
                           valids.float())


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, CUDA events, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``reps`` calls captured in one CUDA graph and replayed,
    CUDA events: the card's time for them without the host's gaps between launches."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float, rate: float = H100_FP32_FLOPS) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_3xtf32(nbytes: float, flops: float) -> tuple[float, str]:
    """Bound of FP32-accurate products on the tensor cores: three TF32 MMAs per product."""
    return bound(nbytes, 3 * flops, H100_TF32_FLOPS)


# kernel S's three stages at the full VQ-VAE width: S, K, N2, D (the features' width),
# C1, C2, C3
S_STAGES = {"SA1": (256, 32, 0, 0, 64, 64, 128),
            "SA2": (128, 64, 256, 128, 128, 128, 256),
            "SA3": (25, 64, 128, 256, 256, 256, 512)}


def record_kernel(results: dict, phase: str, name, shape, err, ms, plain_ms, nbytes, flops,
                  library_ms=None, path="inference", tensor_cores=False, computed=None,
                  **extra) -> None:
    """One kernel's line at one shape: its error against the plain version, its times and
    its bound from the bytes and operations of the work; kept in ``results`` for the final
    kernels line."""
    b_ms, b_by = (bound_3xtf32 if tensor_cores else bound)(nbytes, flops)
    row = {"phase": phase, "kernel": name, "path": path, "shape": shape,
           "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": library_ms, **extra}
    if tensor_cores:  # worked out, not measured; kept out of the final kernels line
        fp32_ms, fp32_by = bound(nbytes, flops)  # the same work on the CUDA cores
        computed = {"bound_fp32_ms": fp32_ms, "bound_fp32_by": fp32_by, **(computed or {})}
    if computed:
        row["computed"] = computed
    emit(row)
    results.setdefault(name, []).append(row)


def l2_weights(rows_per_block, M, S, K, weight_floats):
    """Rows per block and the weight bytes the blocks of one launch read from L2, worked
    out from the block count (every block streams all of its layers' weights once)."""
    def nbytes(rows):
        return 4 * weight_floats * M * -(-S // (rows // K))
    return {"rows_per_block": rows_per_block, "l2_weight_bytes": nbytes(rows_per_block),
            "l2_weight_bytes_64_rows": nbytes(64)}


# ------------------------------------------------------------------------------- phases


def sass_inner_loops(lib_path: str) -> dict:
    """Per kernel of N and M in a built library: the instructions of its innermost loop that
    computes distances (the smallest backward branch whose body holds FMULs) per pair, a pair
    being 3 FMULs (``cuobjdump -sass``); {} without cuobjdump."""
    import re
    from collections import Counter

    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    out = {}
    for body in sass.split("Function : ")[1:]:
        name = re.search(r"(nn_kernel|masked_pair_kernel)(?:ILi(\d)ELi(\d)E)?", body)
        if name is None:
            continue
        ins = []  # (address, opcode, branch target or None)
        for a, text in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body):
            op = re.sub(r"^@!?U?P\w+\s+", "", text).split(" ")[0].split(".")[0]
            target = re.search(r"0x([0-9a-f]+)", text) if op == "BRA" else None
            ins.append((int(a, 16), op, int(target.group(1), 16) if target else None))
        at = {a: k for k, (a, _, _) in enumerate(ins)}
        loops = []
        for k, (a, op, target) in enumerate(ins):
            if target is not None and target < a and target in at:
                ops = Counter(o for _, o, _ in ins[at[target]:k + 1])
                if ops["FMUL"] >= 3:
                    loops.append((k + 1 - at[target], ops))
        if loops:
            n, ops = min(loops, key=lambda lo: lo[0])
            key = name.group(1) + ("<{},{}>".format(*name.group(2, 3)) if name.group(2) else "")
            out[key] = {"loop_instructions": n, "pairs": ops["FMUL"] // 3,
                        "instructions_a_pair": 3 * n / ops["FMUL"],
                        "by_op": dict(ops.most_common(8))}
    return out


def phase_build() -> None:
    from puzzlefusion_plusplus_tpu_torch.ops import cuda_build
    from puzzlefusion_plusplus_tpu_torch.utils import native

    t0 = time.perf_counter()
    cuda_build.build_all()
    for name in cuda_build.SIGNATURES:
        cuda_build.library(name)
    _check(native.available(), f"the native host core did not build: {native.build_error}")
    ptxas = {}
    for name in cuda_build.SIGNATURES:
        path = os.path.join(cuda_build.BUILD_DIR, f"{name}.log")
        if os.path.exists(path):
            with open(path) as fh:
                ptxas[name] = [l.strip() for l in fh if "registers" in l or "spill" in l]
    card = card_line()
    print(card, flush=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_seconds": cuda_build.build_seconds, "card": card, "ptxas": ptxas,
          "native_route": native.route(), "native_threads": native.get_lib().pfpp_num_threads(),
          "nn_sass": sass_inner_loops(os.path.join(cuda_build.BUILD_DIR, "libnn.so"))})


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def phase_kernels(results: dict) -> None:
    """Each kernel against its plain version at the main path's shapes."""
    import torch

    from puzzlefusion_plusplus_tpu_torch.ops import chamfer, cuda_build, fps, gather, sa_fused

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    plan = dp_plan()

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def record(*args, **kwargs):
        record_kernel(results, "kernels", *args, **kwargs)

    def emit_l2_step(name):
        """The L2 weight bytes of each path's step (worked out, not measured)."""
        step = {}
        for r in results[name]:
            into = step.setdefault(r["path"], dict.fromkeys(
                ("l2_weight_bytes", "l2_weight_bytes_64_rows"), 0))
            for key in into:
                into[key] += r["computed"][key]
        emit({"phase": "kernels", "kernel": name, "shape": "step", "computed": step})

    sa_rows = cuda_build.function("sa_cached", "pfpp_sa_cached_rows")
    raw_rows = cuda_build.function("sa_raw", "pfpp_sa_raw_rows")

    # S: the three SA stages of one denoise step at M = 96 clouds (b8 x P12), then of the
    # denoiser validation's frozen encode at M = 1280 (64 shapes x 20 slots) and of verifier
    # generation's denoise step at M = 20 (one shape at the 20-part pad; both listed apart
    # from the step's sum), then a data-parallel engine rank's and the engine's serving the
    # matcher-written data and of the matcher_eval phase's engine
    for M, path, reps, plain_reps, (stage, (S, K, N2, D, C1, C2, C3)) in (
            [(96, "inference", 20, 3, st) for st in S_STAGES.items()]
            + [(1280, "train_denoiser", 5, 1, st) for st in S_STAGES.items()]
            + [(20, "verifier_gen", 20, 3, st) for st in S_STAGES.items()]
            + [(plan["engine_clouds"], "dp", 20, 3, st) for st in S_STAGES.items()]
            + [(MATCHING_SERVE_CLOUDS, "matching_serve", 20, 3, st)
               for st in S_STAGES.items()]
            + [(MATCHER_EVAL_SERVE_CLOUDS, "matcher_eval", 20, 3, st)
               for st in S_STAGES.items()]):
        t0 = time.perf_counter()
        g = randn(M, S, K, 3, scale=0.1)
        w_eff = randn(M, 3, C1, scale=3 ** -0.5)
        feats = randn(M, N2, D).relu() if D else None
        gidx = (torch.randint(0, N2, (M, S, K), generator=gen, device=dev, dtype=torch.int32)
                if D else None)
        k1f = randn(D, C1, scale=D ** -0.5) if D else None
        b1, b2, b3 = randn(C1, scale=0.1), randn(C2, scale=0.1), randn(C3, scale=0.1)
        w2, w3 = randn(C1, C2, scale=C1 ** -0.5), randn(C2, C3, scale=C2 ** -0.5)
        args = (g, w_eff, feats, gidx, k1f, b1, w2, b2, w3, b3)
        out = sa_fused.sa_stage_fused_cached(*args)
        proj = None if feats is None else torch.matmul(feats, k1f)
        ref = sa_fused.sa_stage_plain(g, w_eff, proj, gidx, b1, w2, b2, w3, b3)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        rel = err / max(ref.abs().max().item(), 1e-30)
        _check(rel <= 1e-4, f"S {stage}: relative error {rel}")
        flops = 2 * M * S * K * (3 * C1 + C1 * C2 + C2 * C3) + 2 * M * N2 * D * C1
        nbytes = 4 * (g.numel() + w_eff.numel() + (feats.numel() + gidx.numel()
                      + k1f.numel() if D else 0) + C1 + C1 * C2 + C2 + C2 * C3 + C3
                      + M * S * C3)
        del out, ref, proj
        again = sa_fused.sa_stage_fused_cached(*args)
        _check(torch.equal(again, sa_fused.sa_stage_fused_cached(*args)),
               f"S {stage}: two launches differ")
        del again
        record("S", f"{stage} M={M}", err,
               cuda_ms(lambda: sa_fused.sa_stage_fused_cached(*args), reps),
               cuda_ms(lambda: sa_fused.sa_stage_plain(
                   g, w_eff, None if feats is None else torch.matmul(feats, k1f), gidx, b1,
                   w2, b2, w3, b3), plain_reps),
               nbytes, flops, path=path, tensor_cores=True, max_rel_err=rel,
               computed=l2_weights(sa_rows(K, C1, C2, 0), M, S, K, C1 * C2 + C2 * C3),
               seconds=time.perf_counter() - t0)
    emit_l2_step("S")

    # R: the three SA stages of the 'always' encode of the engine batch's M = 96 clouds
    M = 96
    for stage, (N, Cin, S, K, widths) in {
        "SA1": (1000, 3, 256, 32, (64, 64, 128)),
        "SA2": (256, 131, 128, 64, (128, 128, 256)),
        "SA3": (128, 259, 25, 64, (256, 256, 512)),
    }.items():
        t0 = time.perf_counter()
        pts = randn(M, N, Cin)
        fidx = torch.randint(0, N, (M, S), generator=gen, device=dev, dtype=torch.int32)
        gidx = torch.randint(0, N, (M, S, K), generator=gen, device=dev, dtype=torch.int32)
        weights, cin = [], Cin
        for c in widths:
            weights.append((randn(cin, c, scale=cin ** -0.5), randn(c, scale=0.1)))
            cin = c
        out = sa_fused.sa_stage_fused(pts, fidx, gidx, weights)
        ref = sa_fused.sa_stage_fused_plain(pts, fidx, gidx, weights)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        rel = err / max(ref.abs().max().item(), 1e-30)
        _check(rel <= 1e-4, f"R {stage}: relative error {rel}")
        _check(torch.equal(out, sa_fused.sa_stage_fused(pts, fidx, gidx, weights)),
               f"R {stage}: two launches differ")
        C1, C2, C3 = widths
        weight_floats = (Cin - 3) * C1 + C1 * C2 + C2 * C3
        # layer 1 is linear before its ReLU: the feature block's product is needed once per
        # point, and recentring only touches the 3 xyz rows (counted as for S)
        flops = 2 * M * S * K * (3 * C1 + C1 * C2 + C2 * C3) + 2 * M * N * (Cin - 3) * C1
        nbytes = 4 * (pts.numel() + fidx.numel() + gidx.numel()
                      + sum(w.numel() + b.numel() for w, b in weights) + M * S * C3)
        record("R", stage, err,
               cuda_ms(lambda: sa_fused.sa_stage_fused(pts, fidx, gidx, weights), 20),
               cuda_ms(lambda: sa_fused.sa_stage_fused_plain(pts, fidx, gidx, weights), 3),
               nbytes, flops, path="encoder_modes", tensor_cores=True, max_rel_err=rel,
               computed=l2_weights(raw_rows(K, Cin, C1, C2), M, S, K, weight_floats),
               seconds=time.perf_counter() - t0)
    emit_l2_step("R")

    def fps_check(name, fn, B, N, npoint, xyz, mask, ref):
        """Kernel F or P against the plain indices, twice (two launches bit-equal)."""
        out = fn(xyz, npoint, mask)
        match = bool(torch.equal(out, ref))
        _check(match, f"{name} [{B},{N}]->{npoint}: indices differ from the plain version")
        _check(torch.equal(out, fn(xyz, npoint, mask)), f"{name} [{B},{N}]->{npoint}: two "
                                                         "launches differ")
        if mask is not None:  # a cloud with a valid point picks only valid points
            _check(bool((mask.gather(1, out.long()) | ~mask.any(1, keepdim=True)).all()),
                   f"{name} picked a masked point")
        return match

    # F: the inference cache build's three stages at M = 96 clouds and the widest merge pad
    # (partial mask; the streaming variant), then the three SA stages of a training step at
    # M = 160 clouds, then verifier generation's cache build at M = 20, then a data-parallel
    # engine rank's cache build and each training rank's stages, then the cache build of the
    # engine serving the matcher-written data and of the matcher_eval phase's engine
    for B, N, npoint, masked, path in ((96, 1000, 256, False, "inference"),
                                       (96, 256, 128, False, "inference"),
                                       (96, 128, 25, False, "inference"),
                                       (10, 20000, 1000, True, "inference"),
                                       (160, 1000, 256, False, "train"),
                                       (160, 256, 128, False, "train"),
                                       (160, 128, 25, False, "train"),
                                       (20, 1000, 256, False, "verifier_gen"),
                                       (20, 256, 128, False, "verifier_gen"),
                                       (20, 128, 25, False, "verifier_gen"),
                                       *((m, n, k, False, "dp")
                                         for m in [plan["engine_clouds"], *plan["train_clouds"]]
                                         for n, k in ((1000, 256), (256, 128), (128, 25))),
                                       *((MATCHING_SERVE_CLOUDS, n, k, False, "matching_serve")
                                         for n, k in ((1000, 256), (256, 128), (128, 25))),
                                       *((MATCHER_EVAL_SERVE_CLOUDS, n, k, False, "matcher_eval")
                                         for n, k in ((1000, 256), (256, 128), (128, 25))),
                                       # the overfit step's composable encode, M = 1280
                                       *((1280, n, k, False, "overfit")
                                         for n, k in ((1000, 256), (256, 128), (128, 25)))):
        t0 = time.perf_counter()
        xyz = randn(B, N, 3)
        mask = (torch.rand((B, N), generator=gen, device=dev) < 0.6) if masked else None
        ref = fps.farthest_point_sample_plain(xyz, npoint, mask)
        match = fps_check("F", fps.farthest_point_sample, B, N, npoint, xyz, mask, ref)
        nbytes = 4 * B * N * 3 + (B * N if masked else 0) + 4 * B * npoint
        ms = cuda_ms(lambda: fps.farthest_point_sample(xyz, npoint, mask), 5)
        ppt, threads = fps.block_shape(N)
        record("F", f"[{B},{N}]->{npoint}" + (" masked" if masked else ""), 0.0, ms,
               cuda_ms(lambda: fps.farthest_point_sample_plain(xyz, npoint, mask), 1),
               nbytes, 9.0 * B * N * npoint, path=path, indices_equal=match,
               computed={"us_per_selection": ms * 1e3 / npoint, "points_a_thread": ppt,
                         "threads": threads},
               seconds=time.perf_counter() - t0)

    # F: the matcher's four SA stages of one flat cloud a shape, masked by the point validity
    # (every point valid as in a real batch): at batch 1 and 5000 points (the first also 60%
    # valid), then matcher_eval's batch 4 at 2000 points and stage B's 1000-point cloud, where
    # SA1 selects more centres than there are points (the first valid index repeats)
    matcher_n = MATCHER_EVAL["num_points"]
    for B, N, npoint, share, path in (
            *((1, N, k, v, "train_matching") for N, k, v in (
                (MATCHING_POINTS, 1024, 1.0), (MATCHING_POINTS, 1024, 0.6), (1024, 256, 1.0),
                (256, 64, 1.0), (64, 16, 1.0))),
            *((MATCHER_EVAL["batch"], N, k, 1.0, "matcher_eval") for N, k in (
                (matcher_n, 1024), (1024, 256), (256, 64), (64, 16), (STAGE_B_POINTS, 1024)))):
        t0 = time.perf_counter()
        xyz = randn(B, N, 3, scale=0.3)
        mask = torch.rand((B, N), generator=gen, device=dev) < share
        ref = fps.farthest_point_sample_plain(xyz, npoint, mask)
        match = fps_check("F", fps.farthest_point_sample, B, N, npoint, xyz, mask, ref)
        ms = cuda_ms(lambda: fps.farthest_point_sample(xyz, npoint, mask), 5)
        ppt, threads = fps.block_shape(N)
        record("F", f"[{B},{N}]->{npoint} masked, {share:.0%} valid", 0.0, ms,
               cuda_ms(lambda: fps.farthest_point_sample_plain(xyz, npoint, mask), 1),
               B * (4 * N * 3 + N + 4 * npoint), 9.0 * B * N * npoint, path=path,
               indices_equal=match,
               computed={"us_per_selection": ms * 1e3 / npoint, "points_a_thread": ppt,
                         "threads": threads},
               seconds=time.perf_counter() - t0)

    # P: the cache build's first stage, then the merge resample at the forced-merge batch's
    # pad (2 shapes x K = 4 clouds of P = 8 parts), at the b8 engine batch's pad (8 shapes x
    # K = 6 clouds of P = 12 parts, the resample that trained weights hit) and at the widest
    # pad (K = 10, P = 20); indices equal to the plain version and to F, whose time is taken
    # beside P's
    for B, N, npoint, masked in ((96, 1000, 256, False), (8, 8000, 1000, True),
                                 (48, 12000, 1000, True), (10, 20000, 1000, True)):
        t0 = time.perf_counter()
        xyz = randn(B, N, 3)
        mask = (torch.rand((B, N), generator=gen, device=dev) < 0.6) if masked else None
        ref = fps.farthest_point_sample_plain(xyz, npoint, mask)
        match = fps_check("P", fps.farthest_point_sample_per_cloud, B, N, npoint, xyz, mask,
                          ref)
        match_f = bool(torch.equal(fps.farthest_point_sample_per_cloud(xyz, npoint, mask),
                                   fps.farthest_point_sample(xyz, npoint, mask)))
        _check(match_f, f"P [{B},{N}]->{npoint}: indices differ from F's")
        nbytes = 4 * B * N * 3 + (B * N if masked else 0) + 4 * B * npoint
        ms = cuda_ms(lambda: fps.farthest_point_sample_per_cloud(xyz, npoint, mask), 5)
        f_ms = cuda_ms(lambda: fps.farthest_point_sample(xyz, npoint, mask), 5)
        cl, ppt, threads = fps.cluster_shape(N)
        record("P", f"[{B},{N}]->{npoint}" + (" masked" if masked else ""), 0.0, ms,
               cuda_ms(lambda: fps.farthest_point_sample_per_cloud_plain(xyz, npoint, mask), 1),
               nbytes, 9.0 * B * N * npoint, indices_equal=match, indices_equal_f=match_f,
               f_ms=f_ms,
               computed={"us_per_selection": ms * 1e3 / npoint,
                         "f_us_per_selection": f_ms * 1e3 / npoint, "blocks_a_cloud": cl,
                         "points_a_thread": ppt, "threads": threads},
               seconds=time.perf_counter() - t0)

    def gather_row(name, fn, B, N, C, idx_shape, path, reps, dtype=torch.float32):
        """G or A against the plain version; bytes: the source read once, idx read, the
        output written; the library call is one torch.gather on int64 indices. ``ms`` is the
        call as callers make it, ``kernel_ms`` the bare launch on int32 indices into an
        output made beforehand."""
        t0 = time.perf_counter()
        pts = randn(B, N, C).to(dtype)
        idx = torch.randint(0, N, (B,) + idx_shape, generator=gen, device=dev,
                            dtype=torch.int32)
        match = bool(torch.equal(fn(pts, idx), gather.gather_points_plain(pts, idx)))
        _check(match, f"{name} [{B},{N},{C}] by {idx_shape}: gathered values differ")
        idx64 = idx.reshape(B, -1).long()[..., None].expand(-1, -1, C)
        flat = idx.reshape(B, -1)
        out = torch.empty((B, flat.shape[1], C), dtype=dtype, device=dev)
        bare = lambda: gather._launch_gather(pts, flat, out)  # noqa: E731
        library = lambda: torch.gather(pts, 1, idx64)  # noqa: E731
        es = pts.element_size()
        dt = "" if dtype == torch.float32 else " bf16"
        record(name, f"[{B},{N},{C}]{dt} by [{B},{','.join(map(str, idx_shape))}]", 0.0,
               cuda_ms(lambda: fn(pts, idx), reps),
               cuda_ms(lambda: gather.gather_points_plain(pts, idx), reps),
               es * pts.numel() + 4 * idx.numel() + es * idx.numel() * C, 0.0,
               library_ms=cuda_ms(library, reps), path=path,
               kernel_ms=cuda_ms(bare, reps), kernel_graph_ms=graph_ms(bare, reps),
               library_graph_ms=graph_ms(library, reps),
               unit_values=gather.gather_width(C, pts.data_ptr(), es), values_equal=match,
               seconds=time.perf_counter() - t0)
        del out

    # G: the largest grouping gather of the cache build (SA1 neighbourhoods), then the
    # neighbourhood xyz gathers of a training step's SA1, SA2 and SA3 at M = 160, then
    # verifier generation's SA1 neighbourhoods at M = 20, then a data-parallel engine rank's
    # SA1 neighbourhoods and each training rank's gathers, then the SA1 neighbourhoods of the
    # engine serving the matcher-written data and of the matcher_eval phase's engine
    gather_row("G", gather.gather_points, 96, 1000, 3, (256, 32), "inference", 50)
    for N, S, K in ((1000, 256, 32), (256, 128, 64), (128, 25, 64)):
        gather_row("G", gather.gather_points, 160, N, 3, (S, K), "train", 50)
    gather_row("G", gather.gather_points, 20, 1000, 3, (256, 32), "verifier_gen", 50)
    gather_row("G", gather.gather_points, plan["engine_clouds"], 1000, 3, (256, 32), "dp", 50)
    for M in plan["train_clouds"]:  # a data-parallel training rank's
        for N, S, K in ((1000, 256, 32), (256, 128, 64), (128, 25, 64)):
            gather_row("G", gather.gather_points, M, N, 3, (S, K), "dp", 50)
    gather_row("G", gather.gather_points, MATCHING_SERVE_CLOUDS, 1000, 3, (256, 32),
               "matching_serve", 50)
    gather_row("G", gather.gather_points, MATCHER_EVAL_SERVE_CLOUDS, 1000, 3, (256, 32),
               "matcher_eval", 50)
    # the overfit proof: its VQ-VAE step's SA2 and SA3 xyz gathers at M = 20 (batch 1 x 20
    # slots), then the overfit step's composable encode at M = 1280
    for M, shapes in ((20, ((256, 128, 64), (128, 25, 64))),
                      (1280, ((1000, 256, 32), (256, 128, 64), (128, 25, 64)))):
        for N, S, K in shapes:
            gather_row("G", gather.gather_points, M, N, 3, (S, K), "overfit",
                       50 if M == 20 else 5)

    # G: the matcher's gathers at batch 1 and 5000 points, then at matcher_eval's batch 4 and
    # 2000 points: sa1's ball grouping of the flat cloud, the feature groupings of sa2-sa4,
    # fp4's and fp1's 3-NN interpolation and the PointTransformer's kNN keys and values
    for B, n, path in ((1, MATCHING_POINTS, "train_matching"),
                       (MATCHER_EVAL["batch"], matcher_n, "matcher_eval")):
        for N, C, shape in matcher_gathers(n):
            gather_row("G", gather.gather_points, B, N, C, shape, path, 20)

    # N: part_acc clouds, the b8 engine's shape_cd clouds (engine-shaped: 12 parts of 1000
    # points, padded parts at 1e3, two poses), the widest pad's shape_cd clouds (random), then
    # a training step's chamfer loss, then verifier generation's per-part labels (20 parts),
    # then a data-parallel engine rank's part_acc and shape_cd clouds and each training rank's
    # chamfer loss, then those of the engine serving the matcher-written data, of the overfit
    # proof's engine and of the matcher_eval phase's engine
    sms, clock_mhz = torch.cuda.get_device_properties(0).multi_processor_count, sm_clock_mhz()

    def issue(pairs, ms):
        """Worked out, not measured: the 8 unfused FP32 operations of a pair, one issue slot
        each on 128 lanes an SM at the card's max SM clock, and the measured ms in slots."""
        lanes_per_ms = sms * 128 * clock_mhz * 1e3
        return {"issue_bound_ms": 8.0 * pairs / lanes_per_ms, "clock_mhz": clock_mhz,
                "slots_a_pair": ms * lanes_per_ms / pairs}

    for B, N, path, engine_shaped in ((96, 1000, "inference", False),
                                      (8, 12000, "inference", True),
                                      (8, 20000, "inference", False),
                                      (160, 1000, "train", False),
                                      (20, 1000, "verifier_gen", False),
                                      (plan["engine_clouds"], 1000, "dp", False),
                                      (8 // plan["world"], 12000, "dp", True),
                                      *((m, 1000, "dp", False) for m in plan["train_clouds"]),
                                      (MATCHING_SERVE_CLOUDS, 1000, "matching_serve", False),
                                      (MATCHING_GEN_SHAPES, 1000 * MATCHING_SERVE_PARTS,
                                       "matching_serve", True),
                                      (1, 20000, "overfit", True),
                                      (MATCHER_EVAL_SERVE_CLOUDS, 1000, "matcher_eval", False),
                                      (MATCHER_EVAL["n_val"], 1000 * MATCHER_EVAL_SERVE_PARTS,
                                       "matcher_eval", True)):
        t0 = time.perf_counter()
        x, y = (nn_engine_clouds(gen, B, N // 1000) if engine_shaped
                else (randn(B, N, 3), randn(B, N, 3)))
        d, i = chamfer.nn_distance(x, y)
        dr, ir = chamfer.nn_distance_plain(x, y)
        err = (d - dr).abs().max().item()
        match = bool(torch.equal(i, ir)) and bool(torch.equal(d, dr))
        again = chamfer.nn_distance(x, y)
        _check(match, f"N [{B},{N}]: distances or indices differ from the plain version")
        _check(torch.equal(d, again[0]) and torch.equal(i, again[1]),
               f"N [{B},{N}]: two launches differ")
        dist, idx = torch.empty_like(d), torch.empty_like(i)
        bare = lambda: chamfer._launch_nn(x, y, dist, idx)  # noqa: E731
        ms = cuda_ms(lambda: chamfer.nn_distance(x, y), 5)
        kernel_ms = cuda_ms(bare, 5)
        record("N", f"[{B},{N}]^2" + (" engine-shaped" if engine_shaped else ""), err, ms,
               cuda_ms(lambda: chamfer.nn_distance_plain(x, y), 1),
               4 * (2 * B * N * 3 + 2 * B * N), 8.0 * B * N * N,
               library_ms=cuda_ms(lambda: torch.cdist(x, y).min(-1), 3), path=path,
               kernel_ms=kernel_ms, kernel_graph_ms=graph_ms(bare, 5), bit_equal=match,
               computed=issue(B * N * N, kernel_ms),
               seconds=time.perf_counter() - t0)
    # A: the feature gathers of one training step's SA2 and SA3 at M = 160 clouds, then of
    # the denoiser step's frozen encode at M = 1280 (listed apart from the step's sum)
    for N, C, S, K in ((256, 128, 128, 64), (128, 256, 25, 64)):
        gather_row("A", gather.gather_points_approx, 160, N, C, (S, K), "train", 20)
    for N, C, S, K in ((256, 128, 128, 64), (128, 256, 25, 64)):
        gather_row("A", gather.gather_points_approx, 1280, N, C, (S, K), "train_denoiser", 5)
    for M in plan["train_clouds"]:
        for N, C, S, K in ((256, 128, 128, 64), (128, 256, 25, 64)):
            gather_row("A", gather.gather_points_approx, M, N, C, (S, K), "dp", 10)
    for N, C, S, K in ((256, 128, 128, 64), (128, 256, 25, 64)):  # the overfit VQ-VAE's
        gather_row("A", gather.gather_points_approx, 20, N, C, (S, K), "overfit", 20)
    # G and A on bf16 rows (trainer.precision=bf16): the denoiser step's frozen encode, SA2's
    # and SA3's feature gathers at M = 1280
    for name, fn in (("G", gather.gather_points), ("A", gather.gather_points_approx)):
        for N, C, S, K in ((256, 128, 128, 64), (128, 256, 25, 64)):
            gather_row(name, fn, 1280, N, C, (S, K), "bf16", 5, torch.bfloat16)

    # B: the backward of those gathers and the chamfer loss's target side, at M = 160, then
    # the chamfer case with every row to one index (listed apart from the step's sum), then
    # the backward of the matcher's feature gathers at batch 1 (its R = 80000
    # PointTransformer case on the CSR route) and at matcher_eval's batch 4 (R = 32000).
    # Tolerance 1e-5 of the largest sum: the plain version's index_add_ on the card adds
    # with atomics in no fixed order; the kernel adds in row order and is deterministic.
    step_shapes = ((1000, 3, 1000, False), (256, 128, 128 * 64, False),
                   (128, 256, 25 * 64, False))
    for M, path, (N, C, R, skewed) in (
            [(160, "train", sh) for sh in step_shapes + ((1000, 3, 1000, True),)]
            + [(m, "dp", sh) for m in plan["train_clouds"] for sh in step_shapes]
            + [(20, "overfit", sh) for sh in step_shapes]
            + [(1, "train_matching", (N, C, math.prod(shape), False))
               for N, C, shape in matcher_gathers(MATCHING_POINTS)[1:]]
            + [(MATCHER_EVAL["batch"], "matcher_eval", (N, C, math.prod(shape), False))
               for N, C, shape in matcher_gathers(matcher_n)[1:]]):
        t0 = time.perf_counter()
        g = randn(M, R, C)
        idx = (torch.zeros((M, R), device=dev, dtype=torch.int32) if skewed else
               torch.randint(0, N, (M, R), generator=gen, device=dev, dtype=torch.int32))
        out = gather.scatter_add(g, idx, N)
        again = gather.scatter_add(g, idx, N)
        ref = gather.scatter_add_plain(g, idx, N)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        scale = ref.abs().max().item()
        deterministic = bool(torch.equal(out, again))
        _check(err <= 1e-5 * scale and deterministic,
               f"B [{M},{R},{C}]->{N}: err {err} (scale {scale}), deterministic "
               f"{deterministic}")
        rows = (idx.long() + N * torch.arange(M, device=dev)[:, None]).reshape(-1)
        g2, acc = g.reshape(-1, C), torch.zeros((M * N, C), device=dev)
        dst = torch.empty((M, N, C), device=dev)
        ints = gather.scatter_scratch_ints(M, R, N, C)
        scratch = torch.empty(ints, dtype=torch.int32, device=dev) if ints else None
        launch = lambda: gather._launch_scatter_add(g, idx, dst, scratch)  # noqa: E731
        library = lambda: acc.zero_().index_add_(0, rows, g2)  # noqa: E731
        record("B", f"[{M},{R},{C}]->[{M},{N},{C}]" + (" every row to n=0" if skewed else ""),
               err,
               cuda_ms(lambda: gather.scatter_add(g, idx, N), 10),
               cuda_ms(lambda: gather.scatter_add_plain(g, idx, N), 10),
               4 * (g.numel() + idx.numel() + M * N * C), float(g.numel()),
               library_ms=cuda_ms(library, 10), path=path, kernel_ms=cuda_ms(launch, 10),
               kernel_graph_ms=graph_ms(launch, 10), library_graph_ms=graph_ms(library, 10),
               max_rel_err=err / scale, deterministic=deterministic, skewed=skewed,
               launches_a_call=1 if ints == 0 else 2,
               seconds=time.perf_counter() - t0)

    # M: at the b8 engine's pad (B = 8, P = 12) with two symmetric active pairs a sample (a
    # count assumed, not taken from a merge), then one merge step's pairs at P = 20, N = 1000,
    # 3 active pairs (last: the kernels line's row)
    for B, P, pairs in ((8, 12, tuple((b, i, j) for b in range(8)
                                      for i, j in ((b % 3, 7), (7, b % 3), (4, 9), (9, 4)))),
                        (1, 20, ((0, 0, 1), (0, 1, 0), (0, 2, 5)))):
        t0 = time.perf_counter()
        N = 1000
        pts = randn(B, P, N, 3, scale=0.3)
        mask = torch.zeros((B, P, P), dtype=torch.bool, device=dev)
        for b, i, j in pairs:
            mask[b, i, j] = True
        with torch.no_grad():
            out = chamfer.masked_pairwise_nn(pts, mask)
            ref = chamfer.masked_pairwise_nn_plain(pts, mask)
            match = bool(torch.equal(out, ref))
            _check(match, f"M B={B} P={P}: differs from the plain version")
            _check(torch.equal(out, chamfer.masked_pairwise_nn(pts, mask)),
                   f"M B={B} P={P}: two launches differ")
        err = (out - ref).abs().max().item()
        xa = torch.stack([pts[b, i] for b, i, _ in pairs])
        xb = torch.stack([pts[b, j] for b, _, j in pairs])
        dst = torch.empty_like(out)
        bare = lambda: chamfer._launch_masked(pts, mask, dst)  # noqa: E731
        kernel_ms = cuda_ms(bare, 20)
        record("M", f"B={B} P={P} N={N}, {len(pairs)} active pairs", err,
               cuda_ms(lambda: chamfer.masked_pairwise_nn(pts, mask), 20),
               cuda_ms(lambda: chamfer.masked_pairwise_nn_plain(pts, mask), 3),
               4 * (B * P * N * 3 + B * P * P * N) + B * P * P, 8.0 * len(pairs) * N * N,
               library_ms=cuda_ms(lambda: torch.cdist(xa, xb).min(-1), 20),
               kernel_ms=kernel_ms, kernel_graph_ms=graph_ms(bare, 20), bit_equal=match,
               computed=issue(len(pairs) * N * N, kernel_ms),
               seconds=time.perf_counter() - t0)
    torch.cuda.empty_cache()  # the plain versions at M = 1280 held tens of GB


def phase_fps_shapes() -> None:
    """Kernels F and P at every block shape they can take, at the shapes of phase 2: one line
    per shape with the CUDA-event ms of each (blocks a cloud, points a thread, threads), each
    checked bit-equal to the plain version, and the shape the wrapper chooses."""
    import torch

    from puzzlefusion_plusplus_tpu_torch.ops import fps

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    for name, B, N, npoint, masked in (("F", 96, 1000, 256, False), ("F", 160, 1000, 256, False),
                                       ("F", 96, 256, 128, False), ("F", 96, 128, 25, False),
                                       ("P", 8, 8000, 1000, True), ("P", 48, 12000, 1000, True),
                                       ("P", 10, 20000, 1000, True)):
        t0 = time.perf_counter()
        xyz = torch.randn((B, N, 3), generator=gen, device=dev)
        mask = (torch.rand((B, N), generator=gen, device=dev) < 0.6) if masked else None
        ref = fps.farthest_point_sample_plain(xyz, npoint, mask)
        times, errors = {}, {}
        for cl, ppt, threads in fps.launch_shapes(N, (1,) if name == "F" else (1, 2, 4, 8)):
            key = f"cl={cl},ppt={ppt},threads={threads}"

            def run():
                return fps._launch(xyz, npoint, mask, cl, ppt, threads, per_cloud=name == "P")
            try:
                _check(torch.equal(run(), ref), f"{name} {key}: indices differ")
            except RuntimeError as exc:  # a shape the card refuses to launch
                errors[key] = str(exc)[:200]
                continue
            times[key] = cuda_ms(run, 5)
        chosen = ((1, *fps.block_shape(N)) if name == "F" else fps.cluster_shape(N))
        emit({"phase": "fps_shapes", "kernel": name,
              "shape": f"[{B},{N}]->{npoint}" + (" masked" if masked else ""),
              "ms_by_shape": times, "refused": errors,
              "chosen": "cl={},ppt={},threads={}".format(*chosen),
              "fastest": min(times, key=times.get), "seconds": time.perf_counter() - t0})


def _full_config(data_root: str):
    from puzzlefusion_plusplus_tpu_torch.utils.config import Config

    cfg = Config()
    cfg.trainer.num_devices = 1  # one card; the dp phase sets its own
    cfg.data.data_val_dir = os.path.join(data_root, "pc_data", "val")
    cfg.data.matching_data_path = os.path.join(data_root, "matching_data")
    cfg.inference.batch_size = 8
    cfg.inference.save_trajectories = False
    return cfg


def phase_engine(data_root: str) -> dict:
    import numpy as np

    from puzzlefusion_plusplus_tpu_torch import ops
    from puzzlefusion_plusplus_tpu_torch.inference.run import build_engine_fn, run_inference

    t0 = time.perf_counter()
    cfg = _full_config(data_root)
    engine = build_engine_fn(cfg, "cuda")
    walls = []
    for call in range(2):  # call 0 warms cuBLAS and the allocator; call 1 is counted
        if call == 1:
            ops.reset_launch_counts()  # the main path's run starts here
        t1 = time.perf_counter()
        agg = run_inference(cfg, engine=engine)
        walls.append(time.perf_counter() - t1)
    counts = ops.launch_counts()
    vals = [agg[f"eval/{k}"] for k in ("part_acc", "shape_cd", "rmse_r", "rmse_t")]
    _check(all(np.isfinite(vals)), f"non-finite metrics {agg}")
    _check(all(counts[k] > 0 for k in "SFGN"), f"a kernel never launched: {counts}")
    row = {"phase": "engine", "seconds": time.perf_counter() - t0, "batch": 8,
           "num_samples": agg["num_samples"], "wall_s_per_call": walls,
           "assemblies_per_s": agg["num_samples"] / walls[-1],
           "part_acc": agg["eval/part_acc"], "shape_cd": agg["eval/shape_cd"],
           "rmse_r": agg["eval/rmse_r"], "rmse_t": agg["eval/rmse_t"],
           "n_iters": agg["n_iters"], "n_merged_pairs": agg["n_merged_pairs"],
           "launches": counts}
    emit(row)
    return row


def phase_merge(data_root: str) -> dict:
    import numpy as np
    import torch

    from puzzlefusion_plusplus_tpu_torch import ops
    from puzzlefusion_plusplus_tpu_torch.data.bucketing import part_bucket, slice_batch_parts
    from puzzlefusion_plusplus_tpu_torch.data.datasets import DenoiserDataset
    from puzzlefusion_plusplus_tpu_torch.data.loader import Loader
    from puzzlefusion_plusplus_tpu_torch.inference.engine import draw_noise
    from puzzlefusion_plusplus_tpu_torch.inference.run import (
        agg_config,
        build_engine_fn,
        make_models,
    )

    t0 = time.perf_counter()
    cfg = _full_config(data_root)
    cfg.verifier.threshold = 0.0
    cfg.inference.batch_size = 2
    ds = DenoiserDataset(cfg.data.data_val_dir, mode="test",
                         matching_data_path=cfg.data.matching_data_path)
    batch = next(iter(Loader(ds, 2, shuffle=False, drop_last=False)))
    batch = slice_batch_parts(batch, part_bucket(int(np.max(batch["num_parts"]))))
    batch["ref_part"] = np.zeros_like(batch["ref_part"])
    B, P = batch["part_valids"].shape
    noise = draw_noise(agg_config(cfg), B, P, torch.Generator().manual_seed(3), "cpu")

    vq, den, ver = make_models(cfg)
    with torch.no_grad():  # damped denoiser: a contractive recurrence, comparable runs
        for p in den.parameters():
            p.mul_(0.05)
    sds = {"vqvae": vq.state_dict(), "denoiser": den.state_dict(),
           "verifier": ver.state_dict()}
    before = ops.launch_counts()
    gpu = build_engine_fn(cfg, "cuda", state_dicts=sds)(
        batch, noise=tuple(n.cuda() for n in noise))
    counts = {k: v - before[k] for k, v in ops.launch_counts().items()}
    t_gpu = time.perf_counter() - t0
    cpu = build_engine_fn(cfg, "cpu", state_dicts=sds)(batch, noise=noise)
    _check(int(gpu["n_merged_pairs"].sum()) > 0, f"no merge fired: {gpu['n_merged_pairs']}")
    _check(counts["M"] > 0 and counts["P"] > 0, f"merge kernels not launched: {counts}")
    same = {k: bool(np.array_equal(gpu[k], cpu[k]))
            for k in ("n_iters", "n_merged_pairs", "acc_per_part")}
    traj_err = float(np.abs(gpu["trajectory"] - cpu["trajectory"]).max())
    row = {"phase": "merge", "seconds": time.perf_counter() - t0, "gpu_seconds": t_gpu,
           "batch_parts": P, "merge_fps_clouds": B * (P // 2),
           "merge_fps_points": P * batch["part_pcs"].shape[2],
           "n_merged_pairs": gpu["n_merged_pairs"].tolist(),
           "n_iters": int(gpu["n_iters"][0]), "launches": counts,
           "gpu_vs_cpu_equal": same, "gpu_vs_cpu_max_traj_err": traj_err}
    emit(row)
    _check(all(same.values()) and traj_err <= 1e-3, f"GPU and CPU engines disagree: {row}")
    return row


TRAIN_SHAPES = 16  # synthetic train split of the training phases (seed 11, 3-12 parts)


def _train_config(data_root: str, out_dir: str):
    """Config() at full width; batch 8 shapes x max_num_part 20 = 160 clouds per step."""
    from puzzlefusion_plusplus_tpu_torch.utils.config import Config

    cfg = Config()
    cfg.trainer.num_devices = 1  # one card; the dp phase sets its own
    cfg.data.data_dir = cfg.data.data_val_dir = os.path.join(data_root, "pc_data", "train")
    cfg.data.batch_size = 8
    cfg.data.part_bucket_multiple = 0
    cfg.trainer.output_dir = out_dir
    cfg.trainer.log_every = 1
    return cfg


def _loader_seconds(dataset, batch: int) -> float:
    """Host seconds to build one training batch (the work ``prefetch_batches`` moves off
    the step, except for each epoch's first batch)."""
    from puzzlefusion_plusplus_tpu_torch.data import Loader

    t1 = time.perf_counter()
    next(iter(Loader(dataset, batch, seed=1)))
    return time.perf_counter() - t1


def phase_train(data_root: str) -> dict:
    """Six steps of the trainer's entry point on the card (the first warms up); per-step
    times from its metrics stream, whose records end in a host sync."""
    import shutil

    import numpy as np
    import torch

    from puzzlefusion_plusplus_tpu_torch import ops
    from puzzlefusion_plusplus_tpu_torch.data import VQVAEDataset
    from puzzlefusion_plusplus_tpu_torch.training.vqvae import METRIC_KEYS, train
    from puzzlefusion_plusplus_tpu_torch.utils import native

    t0 = time.perf_counter()
    out_dir = os.path.join(REPO, ".smoke", "train_out")
    shutil.rmtree(out_dir, ignore_errors=True)
    cfg = _train_config(data_root, out_dir)
    steps = 6
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()  # the training path's run starts here
    state = train(cfg, max_steps=steps, device="cuda")
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(out_dir, cfg.trainer.experiment_name, "vqvae",
                           "metrics.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    _check(state.step == steps and len(recs) == steps, f"{state.step} steps, {len(recs)} logs")
    _check(all(np.isfinite(r[k]) for r in recs for k in METRIC_KEYS), f"non-finite: {recs}")
    _check(all(counts[k] > 0 for k in TRAIN_KERNELS), f"a kernel never launched: {counts}")
    timed_s = recs[-1]["wall_s"] - recs[0]["wall_s"]
    row = {"phase": "train", "seconds": time.perf_counter() - t0, "batch_shapes": 8,
           "steps_per_epoch": TRAIN_SHAPES // 8,
           "loader_s_per_batch": _loader_seconds(VQVAEDataset(cfg.data.data_dir), 8),
           "loader_route": native.route(),  # "native" or "numpy"
           "clouds_per_step": 8 * cfg.data.max_num_part, "timed_steps": steps - 1,
           "steps_per_s": (steps - 1) / timed_s,
           "valid_parts_per_s": sum(r["valid_parts"] for r in recs[1:]) / timed_s,
           "step_wall_s": [b["wall_s"] - a["wall_s"] for a, b in zip(recs, recs[1:])],
           "per_step": [{k: r[k] for k in ("step", "cd_loss", "embedding_loss",
                                             "perplexity")} for r in recs],
           "max_memory_allocated_bytes": peak, "launches": counts}
    emit(row)
    return row


def phase_train_parity(data_root: str) -> dict:
    """One train_step on the card and one on the CPU from the same weights and batch (2
    shapes, M = 40 clouds), compared by ``training/parity.py``; raises on a mismatch."""
    import torch

    from puzzlefusion_plusplus_tpu_torch.data import Loader, VQVAEDataset
    from puzzlefusion_plusplus_tpu_torch.training import parity
    from puzzlefusion_plusplus_tpu_torch.training.vqvae import make_model

    t0 = time.perf_counter()
    cfg = _train_config(data_root, os.path.join(REPO, ".smoke", "train_out"))
    batch = next(iter(Loader(VQVAEDataset(cfg.data.data_dir), 2, shuffle=False)))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.trainer.seed)
        model = make_model(cfg)
    parity.spread_codebook(model)
    sd = model.state_dict()
    gpu = parity.step_on(lambda: make_model(cfg), sd, batch, "cuda")
    t_gpu = time.perf_counter() - t0
    cpu = parity.step_on(lambda: make_model(cfg), sd, batch, "cpu")
    errs = parity.compare(cpu, gpu)
    row = {"phase": "train_parity", "seconds": time.perf_counter() - t0, "gpu_seconds": t_gpu,
           "clouds": int(batch["part_valids"].size), "loss_gpu": gpu["metrics"]["total_loss"],
           "loss_cpu": cpu["metrics"]["total_loss"], "errors": errs}
    emit(row)
    return row


# A launches G's kernel, so a profile shows their time as one group
KERNEL_NAMES = {"sa_cached_kernel": "S", "fps_kernel": "F", "pfpp_gather_rows_kernel": "G+A",
                "pfpp_gather_staged_kernel": "G+A", "nn_kernel": "N",
                "masked_pair_kernel": "M", "sa_raw_kernel": "R", "fps_cluster_kernel": "P",
                "pfpp_scatter_fused_kernel": "B", "pfpp_scatter_csr_kernel": "B",
                "pfpp_scatter_sum_kernel": "B"}


def _profile(fn, warmups: int = 1) -> dict:
    """torch.profiler over one call of ``fn`` after ``warmups`` calls: self device time
    grouped into the port's kernels, matrix products and the rest, and the program's spans
    (``utils/profiling.py::snapshot``: per name, its count and host ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from puzzlefusion_plusplus_tpu_torch.utils import profiling

    for _ in range(warmups):
        fn()
    torch.cuda.synchronize()
    profiling.profiling_on()  # reads False: the probe below starts the span registry afresh
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiling.profiling_on()
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    groups: dict[str, float] = {}
    top = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue  # operator rows repeat the time of the kernels they launch
        us = e.self_device_time_total
        if us <= 0:
            continue
        top.append((us, e.key, e.count))
        group = next((f"kernel {v}" for k, v in KERNEL_NAMES.items() if k in e.key), None)
        if group is None:
            low = e.key.lower()
            group = "matmul (cuBLAS)" if ("gemm" in low or "cutlass" in low) else "other"
        groups[group] = groups.get(group, 0.0) + us / 1e3
    device_ms = sum(groups.values())
    top.sort(reverse=True)
    spans = {n: {"count": v["count"], "host_ms": v["total_s"] * 1e3}
             for n, v in sorted(profiling.snapshot()["spans"].items())}
    return {"wall_ms_under_profiler": wall_ms, "device_ms": device_ms, "spans": spans,
            "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
            "top": [{"name": k[:90], "ms": us / 1e3, "count": c} for us, k, c in top[:12]]}


def phase_profile(data_root: str) -> dict:
    """Where one engine call's device time goes (one full-width call)."""
    from puzzlefusion_plusplus_tpu_torch.inference.run import build_engine_fn, run_inference

    t0 = time.perf_counter()
    cfg = _full_config(data_root)
    engine = build_engine_fn(cfg, "cuda")
    row = {"phase": "profile", **_profile(lambda: run_inference(cfg, engine=engine))}
    row["seconds"] = time.perf_counter() - t0
    emit(row)
    return row


def phase_profile_train(data_root: str) -> dict:
    """Where one full-width training step's device time goes (M = 160 clouds)."""
    import torch

    from puzzlefusion_plusplus_tpu_torch.data import Loader, VQVAEDataset
    from puzzlefusion_plusplus_tpu_torch.training.state import adamw_multistep
    from puzzlefusion_plusplus_tpu_torch.training.vqvae import make_model, to_device, train_step

    t0 = time.perf_counter()
    cfg = _train_config(data_root, os.path.join(REPO, ".smoke", "train_out"))
    batch = to_device(next(iter(Loader(VQVAEDataset(cfg.data.data_dir), 8, seed=1))), "cuda")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.trainer.seed)
        model = make_model(cfg).cuda()
    state = adamw_multistep(model, cfg.ae.lr, (), cfg.ae.lr_gamma, cfg.ae.weight_decay)
    row = {"phase": "profile_train", **_profile(lambda: train_step(state, batch))}
    row["seconds"] = time.perf_counter() - t0
    emit(row)
    return row


def phase_encoder_modes(data_root: str) -> dict:
    """The frozen encoder's three modes on the engine batch's clouds at full width (phase 9)."""
    import numpy as np
    import torch

    from puzzlefusion_plusplus_tpu_torch import ops
    from puzzlefusion_plusplus_tpu_torch.data.bucketing import part_bucket, slice_batch_parts
    from puzzlefusion_plusplus_tpu_torch.data.datasets import DenoiserDataset
    from puzzlefusion_plusplus_tpu_torch.data.loader import Loader
    from puzzlefusion_plusplus_tpu_torch.inference.run import make_models
    from puzzlefusion_plusplus_tpu_torch.inference.sampler import FUSED_MODES, make_frozen_encoder
    from puzzlefusion_plusplus_tpu_torch.training import parity
    from puzzlefusion_plusplus_tpu_torch.utils.masking import compact_parts, compaction_indices
    from puzzlefusion_plusplus_tpu_torch.utils.transforms import quat_normalize, quat_to_matrix

    t0 = time.perf_counter()
    cfg = _full_config(data_root)
    vq = make_models(cfg)[0]
    parity.spread_codebook(vq)  # codes of unit scale, so that a tie within 1e-5 is rare
    encs = {mode: make_frozen_encoder(vq.cuda(), mode) for mode in FUSED_MODES}
    ds = DenoiserDataset(cfg.data.data_val_dir, mode="test",
                         matching_data_path=cfg.data.matching_data_path)
    batch = next(iter(Loader(ds, 8, shuffle=False, drop_last=False)))
    batch = slice_batch_parts(batch, part_bucket(int(np.max(batch["num_parts"]))))
    pcs = torch.from_numpy(batch["part_pcs"]).cuda()
    B, P, N, _ = pcs.shape
    _, src, _ = compaction_indices(torch.from_numpy(batch["part_valids"]).cuda())
    flat = compact_parts(pcs, src).reshape(B * P, N, 3)  # the engine's compacted clouds
    gen = torch.Generator(device="cuda").manual_seed(5)
    rot = quat_to_matrix(quat_normalize(torch.randn((B * P, 4), generator=gen, device="cuda")))
    rotated = torch.einsum("mnd,med->mne", flat, rot).contiguous()
    with torch.no_grad():
        idx, geom = encs["cached"].grouping(flat)  # on the unrotated clouds
    calls = {"always": lambda: encs["always"].apply(rotated, idx),
             "never": lambda: encs["never"].apply(rotated, idx),
             "cached": lambda: encs["cached"].apply(flat, idx, geom, rot)}
    ops.reset_launch_counts()  # the encoder-modes path's run starts here
    outs = {mode: fn() for mode, fn in calls.items()}
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    _check(counts["R"] == 3 and counts["S"] == 3, f"R/S launches {counts}")
    ref = outs["never"]["z_e"]
    scale = ref.abs().max().item()
    z_err = {m: (outs[m]["z_e"] - ref).abs().max().item() / scale for m in ("always", "cached")}
    xyz_err = {m: (outs[m]["xyz"] - outs["never"]["xyz"]).abs().max().item()
               for m in ("always", "cached")}
    codebook = encs["never"].w["codebook"]
    d = torch.cdist(ref.reshape(-1, 16), codebook) ** 2
    two = d.topk(2, dim=-1, largest=False).values
    near = (two[:, 1] - two[:, 0]) <= 1e-5
    codes = {m: torch.cdist(outs[m]["z_e"].reshape(-1, 16), codebook).argmin(-1)
             for m in FUSED_MODES}
    differ = {m: int(((codes[m] != codes["never"]) & ~near).sum()) for m in ("always", "cached")}
    row = {"phase": "encoder_modes", "clouds": B * P, "z_e_max_rel_err_vs_never": z_err,
           "xyz_max_abs_err_vs_never": xyz_err, "codes": int(near.numel()),
           "codes_within_1e-5_of_a_tie": int(near.sum()),
           "codes_differing_elsewhere": differ,
           "ms_per_encode": {m: cuda_ms(fn, 5) for m, fn in calls.items()},
           "launches": counts, "seconds": time.perf_counter() - t0}
    emit(row)
    _check(max(z_err.values()) <= 1e-4 and not any(differ.values()),
           f"encoder modes disagree: {row}")
    return row


DENOISER_SHAPES, DENOISER_BATCH = 64, 64  # per split; shapes a step (x 20 part slots)


def _denoiser_config(data_root: str, out_dir: str, encoder_ckpt: str):
    """Config() at full width: batch 64 shapes x max_num_part 20 = 1280 encoder clouds a
    step; one step an epoch on 64 shapes, so epoch 6 ends in the validation pass."""
    from puzzlefusion_plusplus_tpu_torch.utils.config import Config

    cfg = Config()
    cfg.trainer.num_devices = 1  # one card; the dp phase sets its own
    cfg.data.data_dir = os.path.join(data_root, "pc_data", "train")
    cfg.data.data_val_dir = os.path.join(data_root, "pc_data", "val")
    cfg.data.batch_size = cfg.data.val_batch_size = DENOISER_BATCH
    cfg.trainer.output_dir = out_dir
    cfg.trainer.log_every = 1
    cfg.denoiser.epochs = cfg.denoiser.val_every = 6
    cfg.denoiser.encoder_ckpt_path = encoder_ckpt
    return cfg


def _vqvae_checkpoint(trained: bool) -> str:
    """Phase 6's checkpoint directory, or "" (a seeded encoder) when phase 6 did not run in
    this invocation (a checkpoint left by an earlier one is not used)."""
    path = os.path.join(REPO, ".smoke", "train_out", "everyday", "vqvae", "ckpt")
    return path if trained and os.path.isdir(path) else ""


def phase_train_denoiser(data_root: str, vqvae_trained: bool) -> dict:
    """Six steps and a validation pass of the denoiser trainer, then one step with the
    cached-geometry encode (phase 10); per-step times from its metrics stream."""
    import shutil

    import numpy as np
    import torch

    from puzzlefusion_plusplus_tpu_torch import ops
    from puzzlefusion_plusplus_tpu_torch.data import DenoiserDataset
    from puzzlefusion_plusplus_tpu_torch.training.denoiser import EVAL_KEYS, train
    from puzzlefusion_plusplus_tpu_torch.utils import native

    t0 = time.perf_counter()
    out_dir = os.path.join(REPO, ".smoke", "denoiser_out")
    shutil.rmtree(out_dir, ignore_errors=True)
    cfg = _denoiser_config(data_root, out_dir, _vqvae_checkpoint(vqvae_trained))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()  # the denoiser training path's run starts here
    state = train(cfg, device="cuda")
    t_cached = time.perf_counter()
    cfg.denoiser.epochs, cfg.denoiser.train_encode_cached = 7, True
    state = train(cfg, max_steps=7, device="cuda")  # resumes at step 6
    torch.cuda.synchronize()
    t_cached = time.perf_counter() - t_cached
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    run_dir = os.path.join(out_dir, cfg.trainer.experiment_name, "denoiser")
    with open(os.path.join(run_dir, "metrics.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    steps = [r for r in recs if "mse_loss" in r]
    evals = [r for r in recs if "eval_part_acc" in r]
    _check(state.step == 7 and len(steps) == 7 and len(evals) == 1,
           f"{state.step} steps, {len(steps)} step logs, {len(evals)} eval logs")
    _check(all(np.isfinite(r["mse_loss"]) for r in steps), f"non-finite loss: {steps}")
    _check(all(np.isfinite(evals[0][f"eval_{k}"]) for k in EVAL_KEYS), f"eval: {evals}")
    _check(all(counts[k] > 0 for k in DENOISER_KERNELS), f"a kernel never launched: {counts}")
    timed_s = steps[5]["wall_s"] - steps[0]["wall_s"]
    loader_s = _loader_seconds(DenoiserDataset(cfg.data.data_dir, mode="train"),
                               DENOISER_BATCH)
    row = {"phase": "train_denoiser", "seconds": time.perf_counter() - t0,
           "steps_per_epoch": DENOISER_SHAPES // DENOISER_BATCH, "loader_s_per_batch": loader_s,
           "loader_route": native.route(),  # "native" or "numpy"
           "encoder_ckpt": cfg.denoiser.encoder_ckpt_path or "seeded (phase train not run)",
           "batch_shapes": DENOISER_BATCH, "clouds_per_step": DENOISER_BATCH * 20,
           "timed_steps": 5, "steps_per_s": 5 / timed_s,
           "shapes_per_s": 5 * DENOISER_BATCH / timed_s,
           "step_wall_s": [b["wall_s"] - a["wall_s"] for a, b in zip(steps[:6], steps[1:6])],
           "validation_wall_s": evals[0]["wall_s"] - steps[5]["wall_s"],
           "cached_encode_call_s": t_cached,
           "per_step": [{"step": r["step"], "mse_loss": r["mse_loss"]} for r in steps],
           "eval": {k: evals[0][f"eval_{k}"] for k in EVAL_KEYS},
           "max_memory_allocated_bytes": peak, "launches": counts,
           "checkpoints": sorted(d for d in os.listdir(os.path.join(run_dir, "ckpt"))
                                 if d.startswith("step_"))}
    emit(row)
    return row


def _make_ae(cfg):
    """The stage-1 model in ``trainer.precision``'s compute dtype, as the denoiser trainer's
    frozen encoder builds it."""
    from puzzlefusion_plusplus_tpu_torch.models.denoiser import compute_dtype
    from puzzlefusion_plusplus_tpu_torch.training.vqvae import make_model

    return make_model(cfg).with_dtype(compute_dtype(cfg))


def _denoiser_parts(data_root: str, n: int, precision: str = "fp32"):
    """(config without dropout, a batch of n train shapes, the frozen-encoder maker). The
    encoder is the seeded one with its codebook spread to unit scale, so that no code sits
    within float error of a tie (``training/parity.py``)."""
    import functools

    from puzzlefusion_plusplus_tpu_torch.data import DenoiserDataset, Loader
    from puzzlefusion_plusplus_tpu_torch.training import parity
    from puzzlefusion_plusplus_tpu_torch.training.denoiser import load_frozen_encoder

    cfg = _denoiser_config(data_root, os.path.join(REPO, ".smoke", "denoiser_out"), "")
    cfg.denoiser.dropout = cfg.denoiser.pe_dropout = 0.0
    cfg.trainer.precision = precision
    batch = next(iter(Loader(DenoiserDataset(cfg.data.data_dir, mode="train"), n,
                             shuffle=False)))
    ae = load_frozen_encoder(cfg, "cpu").model
    parity.spread_codebook(ae)
    return cfg, batch, parity.encoder_maker(functools.partial(_make_ae, cfg), ae.state_dict())


def phase_denoiser_parity(data_root: str) -> dict:
    """One denoiser train_step on the card and one on the CPU (phase 11)."""
    import torch

    from puzzlefusion_plusplus_tpu_torch.training import parity
    from puzzlefusion_plusplus_tpu_torch.training.denoiser import make_model

    t0 = time.perf_counter()
    cfg, batch, make_encoder = _denoiser_parts(data_root, 2)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.trainer.seed)
        sd = make_model(cfg).state_dict()
    gen = torch.Generator().manual_seed(2)
    timesteps = torch.randint(0, 1000, (2,), generator=gen)
    noise = torch.randn(batch["part_trans"].shape[:2] + (7,), generator=gen)
    args = (lambda: make_model(cfg), sd, make_encoder, batch)
    gpu = parity.denoiser_step_on(*args, "cuda", timesteps, noise)
    t_gpu = time.perf_counter() - t0
    cpu = parity.denoiser_step_on(*args, "cpu", timesteps, noise)
    row = {"phase": "denoiser_parity", "gpu_seconds": t_gpu,
           "clouds": int(batch["part_valids"].size), "timesteps": timesteps.tolist(),
           "loss_gpu": gpu["metrics"]["mse_loss"], "loss_cpu": cpu["metrics"]["mse_loss"],
           "code_margin_gpu": gpu["code_margin"], "code_margin_cpu": cpu["code_margin"]}
    row["errors"] = parity.compare(cpu, gpu, ("mse_loss",))
    row["seconds"] = time.perf_counter() - t0
    emit(row)
    return row


def phase_profile_denoiser(data_root: str) -> dict:
    """Where one full-width denoiser training step's device time goes (phase 12)."""
    import torch

    from puzzlefusion_plusplus_tpu_torch.models.scheduler import DDPMParams
    from puzzlefusion_plusplus_tpu_torch.training.denoiser import make_model, train_step
    from puzzlefusion_plusplus_tpu_torch.training.state import adamw_reference
    from puzzlefusion_plusplus_tpu_torch.training.vqvae import to_device

    t0 = time.perf_counter()
    cfg, batch, make_encoder = _denoiser_parts(data_root, DENOISER_BATCH)
    batch = to_device(batch, "cuda")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.trainer.seed)
        model = make_model(cfg).cuda()
    d = cfg.denoiser
    state = adamw_reference(model, d.lr, d.b1, d.b2, d.weight_decay)
    encoder, ddpm = make_encoder("cuda"), DDPMParams.piecewise()
    gen = torch.Generator(device="cuda").manual_seed(0)
    row = {"phase": "profile_denoiser",
           **_profile(lambda: train_step(state, batch, encoder, ddpm, gen))}
    row["seconds"] = time.perf_counter() - t0
    emit(row)
    return row


def _denoiser_checkpoint(trained: bool) -> str:
    """Phase 10's checkpoint directory, or "" when phase 10 did not run in this invocation."""
    path = os.path.join(REPO, ".smoke", "denoiser_out", "everyday", "denoiser", "ckpt")
    return path if trained and os.path.isdir(path) else ""


VERIFIER_GEN_SHAPES = 8  # synthetic train shapes of 3-12 parts (seed 15), one round each


def phase_verifier_gen(data_root: str, vqvae_trained: bool, denoiser_trained: bool) -> dict:
    """Verifier data from the full-width denoiser (phase 13): 8 shapes at the 20-part pad
    through ``data/verifier_gen.py``, the denoiser and encoder loaded from phases 10 and 6's
    checkpoints (seeded when those did not run)."""
    import shutil

    import numpy as np
    import torch

    from puzzlefusion_plusplus_tpu_torch import ops
    from puzzlefusion_plusplus_tpu_torch.data import VerifierDataset, verifier_gen
    from puzzlefusion_plusplus_tpu_torch.utils.config import Config

    t0 = time.perf_counter()
    cfg = Config()
    cfg.trainer.num_devices = 1  # one card; the dp phase sets its own
    cfg.denoiser.encoder_ckpt_path = _vqvae_checkpoint(vqvae_trained)
    cfg.denoiser.ckpt_path = _denoiser_checkpoint(denoiser_trained)
    out_dir = os.path.join(REPO, ".smoke", "verifier_gen_out")
    shutil.rmtree(out_dir, ignore_errors=True)
    sample_fn = verifier_gen.denoiser_sample_fn(cfg, "cuda")
    sample_s = []

    def timed_sample(batch, generator):
        t1 = time.perf_counter()
        out = sample_fn(batch, generator)
        torch.cuda.synchronize()
        sample_s.append(time.perf_counter() - t1)
        return out

    ops.reset_launch_counts()  # the verifier-generation path's run starts here
    t1 = time.perf_counter()
    written = verifier_gen.generate_verifier_data(
        timed_sample, os.path.join(data_root, "pc_data", "train"),
        os.path.join(data_root, "matching_data"), out_dir, cfg.data.max_num_part,
        seed=cfg.trainer.seed, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = ops.launch_counts()
    files = sorted(os.listdir(out_dir))
    _check(written == len(files) == VERIFIER_GEN_SHAPES, f"{written} written, files {files}")
    read = [VerifierDataset(out_dir, mode) for mode in ("train", "val")]
    _check(sum(len(d) for d in read) == VERIFIER_GEN_SHAPES, "VerifierDataset lost files")
    items = [d.get(i, None) for d in read for i in range(len(d))]
    _check(all(np.isfinite(it["edge_features"]).all() for it in items), "non-finite features")
    _check(all(counts[k] > 0 for k in VERIFIER_GEN_KERNELS), f"a kernel never launched: {counts}")
    labels = [np.load(os.path.join(out_dir, f))["cls_gt"] for f in files]
    row = {"phase": "verifier_gen", "seconds": time.perf_counter() - t0, "shapes": written,
           "denoiser_ckpt": cfg.denoiser.ckpt_path or "seeded (phase train_denoiser not run)",
           "encoder_ckpt": cfg.denoiser.encoder_ckpt_path or "seeded (phase train not run)",
           "wall_s": wall, "seconds_per_shape": wall / written, "sample_s": sample_s,
           "edges": int(sum(len(x) for x in labels)),
           "positive_edges": int(sum(int(x.sum()) for x in labels)), "launches": counts}
    emit(row)
    return row


VERIFIER_FILES, VERIFIER_BATCH = 160, 64  # 128 train + 32 val files; the config's batch


def _verifier_files(root: str) -> None:
    """160 synthetic verifier files (``data/synthetic.py::make_verifier_data_npz``) over 8
    fractured shapes of 3-12 parts, 20 draws of the edge labels each (seed 16)."""
    import numpy as np

    from puzzlefusion_plusplus_tpu_torch.data.synthetic import (
        fracture_shape,
        make_matching_data_npz,
        make_verifier_data_npz,
    )

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(16)
    pool = []
    for _ in range(8):
        shape = fracture_shape(rng, int(rng.integers(3, 13)), n_points=1000, n_dense=40000)
        pool.append((shape, make_matching_data_npz(shape, rng)))
    for i in range(VERIFIER_FILES):
        shape, matching = pool[i % len(pool)]
        np.savez(os.path.join(root, f"{i:05d}.npz"),
                 **make_verifier_data_npz(shape, matching, rng))


def _verifier_config(data_dir: str, out_dir: str):
    """Config() at full verifier width (256/6/8, 7 features, 190 edges), batch 64: two steps
    an epoch on 128 train files, validation at the end of epoch 3 on the 32 val files."""
    from puzzlefusion_plusplus_tpu_torch.utils.config import Config

    cfg = Config()
    cfg.trainer.num_devices = 1  # one card; the dp phase sets its own
    cfg.data.verifier_data_path = data_dir
    cfg.data.batch_size = cfg.data.val_batch_size = VERIFIER_BATCH
    cfg.trainer.output_dir = out_dir
    cfg.trainer.log_every = 1
    cfg.verifier.epochs = cfg.trainer.ckpt_every_epochs = 3
    return cfg


def phase_train_verifier(data_dir: str) -> dict:
    """Six steps and a validation pass of the verifier trainer (phase 14); per-step times
    from its metrics stream."""
    import shutil

    import numpy as np
    import torch

    from puzzlefusion_plusplus_tpu_torch import ops
    from puzzlefusion_plusplus_tpu_torch.data import Loader, VerifierDataset
    from puzzlefusion_plusplus_tpu_torch.training.verifier import METRIC_KEYS, train

    t0 = time.perf_counter()
    out_dir = os.path.join(REPO, ".smoke", "verifier_out")
    shutil.rmtree(out_dir, ignore_errors=True)
    cfg = _verifier_config(data_dir, out_dir)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()  # the verifier training path's run starts here
    state = train(cfg, device="cuda")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    run_dir = os.path.join(out_dir, cfg.trainer.experiment_name, "verifier")
    with open(os.path.join(run_dir, "metrics.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    steps = [r for r in recs if "cls_loss" in r]
    evals = [r for r in recs if "val_cls_acc" in r]
    _check(state.step == 6 and len(steps) == 6 and len(evals) == 1,
           f"{state.step} steps, {len(steps)} step logs, {len(evals)} eval logs")
    _check(all(np.isfinite(r[k]) for r in steps for k in METRIC_KEYS), f"non-finite: {steps}")
    _check(all(np.isfinite(evals[0][f"val_{k}"]) for k in METRIC_KEYS), f"eval: {evals}")
    # the valid edges of the timed steps 1-5, from the trainer's own batch order
    loader = Loader(VerifierDataset(data_dir, "train"), VERIFIER_BATCH, seed=cfg.trainer.seed)
    edges = [float(b["edge_valids"].sum()) for _ in range(3) for b in loader]
    timed_s = steps[5]["wall_s"] - steps[0]["wall_s"]
    row = {"phase": "train_verifier", "seconds": time.perf_counter() - t0,
           "files": VERIFIER_FILES, "batch": VERIFIER_BATCH, "timed_steps": 5,
           "steps_per_s": 5 / timed_s, "edges_per_s": sum(edges[1:6]) / timed_s,
           "step_wall_s": [b["wall_s"] - a["wall_s"] for a, b in zip(steps, steps[1:])],
           "validation_wall_s": evals[0]["wall_s"] - steps[5]["wall_s"],
           "per_step": [{"step": r["step"], "cls_loss": r["cls_loss"], "cls_acc": r["cls_acc"]}
                        for r in steps],
           "eval": {k: evals[0][f"val_{k}"] for k in METRIC_KEYS},
           "max_memory_allocated_bytes": peak, "launches": counts,
           "checkpoints": sorted(d for d in os.listdir(os.path.join(run_dir, "ckpt"))
                                 if d.startswith("step_"))}
    emit(row)
    return row


def phase_verifier_parity(data_dir: str) -> dict:
    """One verifier train_step on the card and one on the CPU (phase 15), full width, the
    config's batch of 64 files, dropout off."""
    import torch

    from puzzlefusion_plusplus_tpu_torch.data import Loader, VerifierDataset
    from puzzlefusion_plusplus_tpu_torch.training import parity
    from puzzlefusion_plusplus_tpu_torch.training.verifier import make_model

    t0 = time.perf_counter()
    cfg = _verifier_config(data_dir, os.path.join(REPO, ".smoke", "verifier_out"))
    batch = next(iter(Loader(VerifierDataset(data_dir, "train"), VERIFIER_BATCH,
                             shuffle=False)))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.trainer.seed)
        sd = make_model(cfg).state_dict()
    args = (lambda: make_model(cfg, dropout=0.0), sd, batch)
    gpu = parity.verifier_step_on(*args, "cuda")
    t_gpu = time.perf_counter() - t0
    cpu = parity.verifier_step_on(*args, "cpu")
    row = {"phase": "verifier_parity", "gpu_seconds": t_gpu,
           "edges": int(batch["edge_valids"].sum()),
           "loss_gpu": gpu["metrics"]["cls_loss"], "loss_cpu": cpu["metrics"]["cls_loss"],
           "cls_acc_gpu": gpu["metrics"]["cls_acc"], "cls_acc_cpu": cpu["metrics"]["cls_acc"]}
    row["errors"] = parity.compare(cpu, gpu, ("cls_loss",))
    row["seconds"] = time.perf_counter() - t0
    emit(row)
    return row


def _serve_checkpoints(vqvae_trained: bool, denoiser_trained: bool,
                       verifier_trained: bool) -> dict:
    """The checkpoints of phases 6, 10 and 14; a phase that did not run in this invocation
    is stood in for by its seeded model saved under ``.smoke/serve_ckpt``."""
    import torch

    from puzzlefusion_plusplus_tpu_torch.inference.run import make_models
    from puzzlefusion_plusplus_tpu_torch.training.state import adamw_reference, save_checkpoint
    from puzzlefusion_plusplus_tpu_torch.utils.config import Config

    import shutil

    shutil.rmtree(os.path.join(REPO, ".smoke", "serve_ckpt"), ignore_errors=True)
    paths = {"vqvae": _vqvae_checkpoint(vqvae_trained),
             "denoiser": _denoiser_checkpoint(denoiser_trained),
             "verifier": os.path.join(REPO, ".smoke", "verifier_out", "everyday", "verifier",
                                      "ckpt") if verifier_trained else ""}
    models = dict(zip(("vqvae", "denoiser", "verifier"), make_models(Config())))
    for name, path in paths.items():
        if not path:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(17)  # other weights than the seeded engine's
                for p in models[name].parameters():
                    p.data.add_(0.01 * torch.randn_like(p))
            paths[name] = save_checkpoint(os.path.join(REPO, ".smoke", "serve_ckpt", name),
                                          adamw_reference(models[name], 1e-4))
    return paths


def phase_serve(data_root: str, paths: dict) -> dict:
    """The b8 engine batch served through ``build_engine_fn`` with the three checkpoints named
    by ``*.ckpt_path`` (phase 16), then with the same weights passed as ``state_dicts``
    under the same generator seed: the results must be equal."""
    import numpy as np

    from puzzlefusion_plusplus_tpu_torch import ops
    from puzzlefusion_plusplus_tpu_torch.inference.run import build_engine_fn, run_inference
    from puzzlefusion_plusplus_tpu_torch.training.state import load_model_state

    t0 = time.perf_counter()
    cfg = _full_config(data_root)
    cfg.denoiser.encoder_ckpt_path = paths["vqvae"]
    cfg.denoiser.ckpt_path = paths["denoiser"]
    cfg.verifier.ckpt_path = paths["verifier"]
    engine = build_engine_fn(cfg, "cuda")
    ops.reset_launch_counts()  # the serving path's run starts here
    t1 = time.perf_counter()
    served = run_inference(cfg, engine=engine)
    wall_ckpt = time.perf_counter() - t1
    counts = ops.launch_counts()
    sds = {name: load_model_state(path, name) for name, path in paths.items()}
    plain = _full_config(data_root)
    given_engine = build_engine_fn(plain, "cuda", state_dicts=sds)
    t1 = time.perf_counter()
    given = run_inference(plain, engine=given_engine)
    wall_given = time.perf_counter() - t1
    _check(all(counts[k] > 0 for k in SERVE_KERNELS), f"a kernel never launched: {counts}")
    vals = [served[f"eval/{k}"] for k in ("part_acc", "shape_cd", "rmse_r", "rmse_t")]
    _check(all(np.isfinite(vals)), f"non-finite metrics {served}")
    row = {"phase": "serve", "seconds": time.perf_counter() - t0, "checkpoints": paths,
           "num_samples": served["num_samples"], "wall_s_checkpoints": wall_ckpt,
           "wall_s_state_dicts": wall_given,
           "assemblies_per_s": served["num_samples"] / wall_ckpt,
           "assemblies_per_s_state_dicts": given["num_samples"] / wall_given,
           "part_acc": served["eval/part_acc"], "shape_cd": served["eval/shape_cd"],
           "n_iters": served["n_iters"], "n_merged_pairs": served["n_merged_pairs"],
           "equal_to_state_dicts": served == given, "launches": counts}
    emit(row)
    _check(served == given, f"checkpoint-loaded engine differs: {served} vs {given}")
    return row




def _matching_split(root: str, split: str) -> str:
    return os.path.join(root, "pc_data", split)


def phase_train_matching(root: str) -> dict:
    """The matcher's entry ``matching.train.train_matching`` at its defaults (the reference
    jigsaw_4x4_128_512_250e width: PointNet++ MSG (1024, 256, 64, 16), 128/512 features, 8
    heads, 16 kNN samples, Sinkhorn 20 x 0.05, 5000 points, 20 parts, batch 1, Adam 1e-3
    under cosine decay) with ``mat_epoch = rig_epoch = 0``, so all three losses run: one
    epoch of 7 shapes (a warm-up step and 6 timed), then one validation pass over 1 shape
    (Hungarian on the host) and a top-k checkpoint. Random weights: val ``mat_f1`` measures
    nothing here."""
    import shutil

    import numpy as np
    import torch

    from puzzlefusion_plusplus_tpu_torch import ops
    from puzzlefusion_plusplus_tpu_torch.matching.dataset import AllPieceMatchingDataset
    from puzzlefusion_plusplus_tpu_torch.matching.train import METRIC_KEYS, train_matching

    t0 = time.perf_counter()
    out_dir = os.path.join(REPO, ".smoke", "matching_out")
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()  # the matcher's training path starts here
    state = train_matching(_matching_split(root, "train"), out_dir=out_dir, epochs=1,
                           mat_epoch=0, rig_epoch=0,
                           val_data_dir=_matching_split(root, "val_train"), log_every=1,
                           device="cuda")
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(out_dir, "metrics.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    steps, val = recs[:MATCHING_SHAPES], recs[MATCHING_SHAPES:]
    _check(state.step == MATCHING_SHAPES and len(steps) == MATCHING_SHAPES and len(val) == 1,
           f"{state.step} steps, {len(recs)} records")
    _check(all(np.isfinite(r[k]) for r in steps for k in METRIC_KEYS), f"non-finite: {steps}")
    _check(all(counts[k] > 0 for k in MATCHING_KERNELS), f"a kernel never launched: {counts}")
    _check(os.path.isfile(os.path.join(out_dir, "ckpt", "topk.json")), "no top-k checkpoint")
    timed_s = steps[-1]["wall_s"] - steps[0]["wall_s"]
    row = {"phase": "train_matching", "seconds": time.perf_counter() - t0,
           "num_points": MATCHING_POINTS, "batch_shapes": 1, "timed_steps": len(steps) - 1,
           "steps_per_s": (len(steps) - 1) / timed_s,
           "points_per_s": MATCHING_POINTS * (len(steps) - 1) / timed_s,
           "step_wall_s": [b["wall_s"] - a["wall_s"] for a, b in zip(steps, steps[1:])],
           "per_step": [{k: r[k] for k in ("step", "loss", "cls_loss", "mat_loss", "rig_loss")}
                        for r in steps],
           "val_s": val[0]["wall_s"] - steps[-1]["wall_s"],
           "val_mat_f1": val[0]["val_mat_f1"],
           "val_mat_f1_note": "random weights after 7 steps: measures nothing",
           "loader_s_per_batch": _loader_seconds(AllPieceMatchingDataset(
               _matching_split(root, "train")), 1),
           "max_memory_allocated_bytes": peak, "launches": counts}
    emit(row)
    return row


def _matching_batch(root: str, shapes: int, num_points: int = MATCHING_POINTS) -> dict:
    from puzzlefusion_plusplus_tpu_torch.data import Loader
    from puzzlefusion_plusplus_tpu_torch.matching.dataset import AllPieceMatchingDataset

    ds = AllPieceMatchingDataset(_matching_split(root, "train"), num_points=num_points)
    return next(iter(Loader(ds, shapes, shuffle=False)))


def _matching_state_dict() -> dict:
    import torch

    from puzzlefusion_plusplus_tpu_torch.matching.train import make_model

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return make_model().state_dict()


def phase_matching_parity(root: str) -> dict:
    """One full-width matcher train_step on the card and one on the CPU from the same
    weights and shape (all three losses, Adam), compared by ``training/parity.py`` with its
    ``MATCHING`` tolerances."""
    from puzzlefusion_plusplus_tpu_torch.matching.train import METRIC_KEYS, make_model
    from puzzlefusion_plusplus_tpu_torch.training import parity

    t0 = time.perf_counter()
    batch = _matching_batch(root, 1)
    sd = _matching_state_dict()
    gpu = parity.matching_step_on(make_model, sd, batch, "cuda")
    t_gpu = time.perf_counter() - t0
    cpu = parity.matching_step_on(make_model, sd, batch, "cpu")
    row = {"phase": "matching_parity", "gpu_seconds": t_gpu,
           "cpu_seconds": time.perf_counter() - t0 - t_gpu, "num_points": MATCHING_POINTS,
           "loss_gpu": gpu["metrics"]["loss"], "loss_cpu": cpu["metrics"]["loss"]}
    row["errors"] = parity.compare(cpu, gpu, METRIC_KEYS, parity.MATCHING)
    row["seconds"] = time.perf_counter() - t0
    emit(row)
    return row


def phase_profile_matching(root: str) -> dict:
    """Where one full-width matcher training step's device time goes (5000 points, all
    three losses)."""
    import torch

    from puzzlefusion_plusplus_tpu_torch.matching.train import make_model, train_step
    from puzzlefusion_plusplus_tpu_torch.training.state import adam_cosine
    from puzzlefusion_plusplus_tpu_torch.training.vqvae import to_device

    t0 = time.perf_counter()
    batch = to_device(_matching_batch(root, 1), "cuda")
    model = make_model()
    model.load_state_dict(_matching_state_dict())
    state = adam_cosine(model.cuda(), 1e-3, 1000)
    row = {"phase": "profile_matching", **_profile(lambda: train_step(state, batch, 1.0, 1.0))}
    row["seconds"] = time.perf_counter() - t0
    emit(row)
    return row


def phase_matching_gen(root: str, trained: bool) -> dict:
    """The eval entry ``matching.eval`` writes matching_data for the val shape at its
    default 5000 points from the train_matching checkpoint (a saved seeded model when that
    phase did not run), then ``run_inference`` serves those shapes from it with the
    full-width engine (seeded weights): the matcher -> matching_data -> engine round trip on
    the card. The oracle mode runs once."""
    import shutil

    import numpy as np

    from puzzlefusion_plusplus_tpu_torch import ops
    from puzzlefusion_plusplus_tpu_torch.data.bucketing import part_bucket
    from puzzlefusion_plusplus_tpu_torch.inference.run import build_engine_fn, run_inference
    from puzzlefusion_plusplus_tpu_torch.matching import eval as meval
    from puzzlefusion_plusplus_tpu_torch.matching.train import make_model
    from puzzlefusion_plusplus_tpu_torch.training.state import adam_cosine, save_checkpoint

    t0 = time.perf_counter()
    base = os.path.join(REPO, ".smoke", "matching_gen_out")
    shutil.rmtree(base, ignore_errors=True)
    ckpt = os.path.join(REPO, ".smoke", "matching_out", "ckpt")
    if not trained:
        model = make_model()
        model.load_state_dict(_matching_state_dict())
        ckpt = os.path.dirname(save_checkpoint(os.path.join(base, "ckpt"),
                                               adam_cosine(model, 1e-3, 1)))
    val_dir, out = _matching_split(root, "val"), os.path.join(base, "matching_data")
    ops.reset_launch_counts()  # the writer's path starts here
    t1 = time.perf_counter()
    results = meval.main([f"data_dir={val_dir}", f"ckpt={ckpt}", f"out_dir={out}"])
    wall_gen = time.perf_counter() - t1
    counts_gen = ops.launch_counts()
    files = sorted(os.listdir(out))
    _check(len(results) == len(files) == MATCHING_GEN_SHAPES, f"files written: {files}")
    _check(all(counts_gen[k] > 0 for k in MATCHING_GEN_KERNELS),
           f"a kernel never launched: {counts_gen}")
    t1 = time.perf_counter()
    oracle = meval.main([f"data_dir={val_dir}", "oracle=1"])
    oracle_s = time.perf_counter() - t1
    cfg = _full_config(root)
    cfg.data.matching_data_path = out
    cfg.trainer.output_dir = os.path.join(base, "serve")
    parts = max(len(r["global_transforms"]) for r in results)
    _check(part_bucket(parts, cfg.inference.part_bucket_multiple, cfg.data.max_num_part)
           == MATCHING_SERVE_PARTS, f"the served batch is not the kernels phase's: {parts}")
    engine = build_engine_fn(cfg, "cuda")
    ops.reset_launch_counts()  # the engine's run over the written data starts here
    t1 = time.perf_counter()
    served = run_inference(cfg, engine=engine)
    wall_serve = time.perf_counter() - t1
    counts_serve = ops.launch_counts()
    vals = [served[f"eval/{k}"] for k in ("part_acc", "shape_cd", "rmse_r", "rmse_t")]
    _check(served["num_samples"] == MATCHING_GEN_SHAPES and all(np.isfinite(vals)),
           f"serving the written data: {served}")
    _check(all(counts_serve[k] > 0 for k in MATCHING_SERVE_KERNELS),
           f"a kernel never launched: {counts_serve}")
    row = {"phase": "matching_gen", "seconds": time.perf_counter() - t0,
           "checkpoint": ckpt if trained else "seeded (phase train_matching not run)",
           "shapes": len(files), "num_points": MATCHING_POINTS, "wall_s": wall_gen,
           "seconds_per_shape": wall_gen / len(files),
           "edges": [r["num_edges"] for r in results],
           "critical_points": [r["n_critical_total"] for r in results],
           "oracle": oracle, "oracle_s": oracle_s, "serve_wall_s": wall_serve,
           "part_acc": served["eval/part_acc"], "shape_cd": served["eval/shape_cd"],
           "n_iters": served["n_iters"], "launches": counts_gen,
           "launches_serve": counts_serve}
    emit(row)
    return row


def _dp_train(module, cfg, plan: dict, steps: int) -> dict:
    """``steps`` steps of a trainer's entry point on the dp plan's ranks -> the rank-0
    metrics records, per-rank peak memory and the launches summed over the ranks."""
    import shutil

    from puzzlefusion_plusplus_tpu_torch.parallel import launch
    from puzzlefusion_plusplus_tpu_torch.training import parity

    shutil.rmtree(cfg.trainer.output_dir, ignore_errors=True)
    cfg.trainer.num_devices, cfg.trainer.log_every = plan["world"], 1
    out = launch.run(parity.measured,
                     (launch.discard_result, (module.train, cfg, steps, "cuda")),
                     plan["world"], "cuda", share_card=plan["share_card"])
    name = module.__name__.rsplit(".", 1)[1]
    with open(os.path.join(cfg.trainer.output_dir, cfg.trainer.experiment_name, name,
                           "metrics.jsonl")) as fh:
        out["records"] = [json.loads(line) for line in fh]
    _check(len(out["records"]) == steps, f"{name}: {len(out['records'])} records")
    return out


def phase_dp(train_root: str, den_root: str, ver_root: str, data_root: str,
             match_root: str) -> dict:
    """Data parallelism (``parallel/``), phase 17: one VQ-VAE, denoiser and verifier step
    and the b8 engine batch at the dp plan's world size, each held to the one-process
    result; then each trainer's entry for 6 steps (the first warms up) and the engine for
    two calls (the second timed) at that world size."""
    import functools
    import gc
    import shutil

    import numpy as np
    import torch

    from puzzlefusion_plusplus_tpu_torch.data import (
        DenoiserDataset,
        Loader,
        VerifierDataset,
        VQVAEDataset,
    )
    from puzzlefusion_plusplus_tpu_torch.inference import run as R
    from puzzlefusion_plusplus_tpu_torch.matching import train as match_train
    from puzzlefusion_plusplus_tpu_torch.parallel import launch
    from puzzlefusion_plusplus_tpu_torch.training import denoiser, parity, verifier, vqvae

    t0 = time.perf_counter()
    plan = dp_plan()
    W = plan["world"]
    emit({"phase": "dp", "world_size": W, "backend": plan["backend"], "cards": plan["cards"],
          "ranks_share_a_card": plan["share_card"]})
    gc.collect()
    torch.cuda.empty_cache()  # the ranks' processes need the card's memory

    # one step of each trainer at world W against the one-process step, 2 shapes a rank
    tcfg = _train_config(train_root, os.path.join(REPO, ".smoke", "train_out"))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(tcfg.trainer.seed)
        ae = vqvae.make_model(tcfg)
    parity.spread_codebook(ae)
    dcfg, dbatch, make_encoder = _denoiser_parts(den_root, 2 * W)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(dcfg.trainer.seed)
        den_sd = denoiser.make_model(dcfg).state_dict()
    gen = torch.Generator().manual_seed(2)
    vcfg = _verifier_config(ver_root, os.path.join(REPO, ".smoke", "verifier_out"))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(vcfg.trainer.seed)
        ver_sd = verifier.make_model(vcfg).state_dict()
    cases = {
        "vqvae": dict(kind="vqvae", make_model=functools.partial(vqvae.make_model, tcfg),
                      state_dict=ae.state_dict(),
                      batch=next(iter(Loader(VQVAEDataset(tcfg.data.data_dir), 2 * W,
                                             shuffle=False)))),
        "denoiser": dict(kind="denoiser",
                         make_model=functools.partial(denoiser.make_model, dcfg),
                         state_dict=den_sd, batch=dbatch, make_encoder=make_encoder,
                         timesteps=torch.randint(0, 1000, (2 * W,), generator=gen),
                         noise=torch.randn(dbatch["part_trans"].shape[:2] + (7,),
                                           generator=gen)),
        "verifier": dict(kind="verifier",
                         make_model=functools.partial(verifier.make_model, vcfg, dropout=0.0),
                         state_dict=ver_sd,
                         batch=next(iter(Loader(VerifierDataset(ver_root, "train"),
                                                VERIFIER_BATCH, shuffle=False)))),
        # the full-width matcher, one 5000-point shape a rank
        "matching": dict(kind="matching", make_model=match_train.make_model,
                         state_dict=_matching_state_dict(), batch=_matching_batch(match_root, W)),
    }
    one = parity.dp_steps(cases, 1, "cuda")
    t1 = time.perf_counter()
    many = parity.dp_steps(cases, W, "cuda", share_card=plan["share_card"])
    row = {"phase": "dp_parity", "world_size": W, "backend": plan["backend"],
           "seconds_world": time.perf_counter() - t1}
    for name, keys, tol in (("vqvae", vqvae.METRIC_KEYS, parity.Tolerances()),
                            ("denoiser", ("mse_loss",), parity.Tolerances()),
                            ("verifier", verifier.METRIC_KEYS, parity.Tolerances()),
                            ("matching", match_train.METRIC_KEYS, parity.MATCHING)):
        row[name] = {"loss_world": many[name]["metrics"][keys[0]],
                     "loss_one": one[name]["metrics"][keys[0]],
                     "errors": parity.compare(one[name], many[name], keys, tol)}
    bufs = many["vqvae"]["rank_buffers"]
    row["bn_stats_equal_across_ranks"] = all(
        torch.equal(b[n], bufs[0][n]) for b in bufs for n in bufs[0])
    emit(row)
    _check(row["bn_stats_equal_across_ranks"], "BatchNorm statistics differ across ranks")
    del one, many, cases
    gc.collect()
    torch.cuda.empty_cache()

    # the trainers' entries at world W
    launches = dict.fromkeys(DP_KERNELS, 0)
    rows = {}
    for name, module, cfg, batch, clouds in (
            ("vqvae", vqvae,
             _train_config(den_root, os.path.join(REPO, ".smoke", "dp_vqvae_out")),
             plan["vqvae_batch"], 20),
            ("denoiser", denoiser,
             _denoiser_config(den_root, os.path.join(REPO, ".smoke", "dp_denoiser_out"), ""),
             plan["denoiser_batch"], 20),
            ("verifier", verifier,
             _verifier_config(ver_root, os.path.join(REPO, ".smoke", "dp_verifier_out")),
             plan["verifier_batch"], 0)):
        cfg.data.batch_size = cfg.data.val_batch_size = batch
        if name == "denoiser":
            cfg.denoiser.val_every = 1000  # training steps only
        t1 = time.perf_counter()
        out = _dp_train(module, cfg, plan, 6)
        recs = out["records"]
        timed_s = recs[-1]["wall_s"] - recs[0]["wall_s"]
        loss_key = {"vqvae": "total_loss", "denoiser": "mse_loss", "verifier": "cls_loss"}[name]
        _check(all(np.isfinite(r[loss_key]) for r in recs), f"{name}: non-finite {recs}")
        ds = (VQVAEDataset(cfg.data.data_dir) if name == "vqvae" else
              VerifierDataset(ver_root, "train") if name == "verifier" else
              DenoiserDataset(cfg.data.data_dir, mode="train"))
        rows[name] = {"phase": "dp_train", "trainer": name, "world_size": W,
                      "backend": plan["backend"], "global_batch": batch,
                      "shapes_per_card": batch // W,
                      "clouds_per_card": batch // W * clouds or None,
                      "steps_per_s": (len(recs) - 1) / timed_s,
                      "step_wall_s": [b["wall_s"] - a["wall_s"] for a, b in zip(recs, recs[1:])],
                      "peak_bytes_per_card": out["peak_bytes"],
                      "loader_s_per_global_batch": _loader_seconds(ds, batch),
                      "losses": [r[loss_key] for r in recs], "launches": out["launches"],
                      "seconds": time.perf_counter() - t1}
        emit(rows[name])
        for k in launches:
            launches[k] += out["launches"][k]
        gc.collect()
        torch.cuda.empty_cache()

    # the b8 engine batch at world W against one process
    t1 = time.perf_counter()
    cfg = _full_config(data_root)
    cfg.inference.save_breakdown = True
    cfg.trainer.output_dir = os.path.join(REPO, ".smoke", "dp_engine_out")
    cfg.inference.inference_dir = "one"
    shutil.rmtree(cfg.trainer.output_dir, ignore_errors=True)
    one_out = parity.serving(cfg, "cuda", 2)  # a warm-up call, then the timed one
    one = one_out["result"]
    gc.collect()
    torch.cuda.empty_cache()
    cfg.trainer.num_devices, cfg.inference.inference_dir = W, "world"
    out = launch.run(parity.serving, (cfg, "cuda", 2), W, "cuda",
                     share_card=plan["share_card"])
    many = out["result"]
    base = os.path.join(cfg.trainer.output_dir, cfg.trainer.experiment_name, "inference")
    recs = {}
    for d in ("one", "world"):  # two calls each, appended
        with open(os.path.join(base, d, "breakdown.jsonl")) as fh:
            recs[d] = [json.loads(line) for line in fh]
    n = many["num_samples"]
    metric_err = max(abs(many[f"eval/{k}"] - one[f"eval/{k}"]) / max(abs(one[f"eval/{k}"]), 1e-30)
                     for k in R.METRIC_KEYS)
    row = {"phase": "dp_engine", "world_size": W, "backend": plan["backend"], "batch": 8,
           "shapes_per_card": 8 // W, "num_samples": n, "wall_s_per_call": out["seconds"],
           "assemblies_per_s": n / out["seconds"][-1],
           "wall_s_per_call_one_process": one_out["seconds"],
           "assemblies_per_s_one_process": n / one_out["seconds"][-1],
           "peak_bytes_per_card": out["peak_bytes"],
           "records_equal": len(recs["one"]) == 2 * n and recs["world"] == recs["one"],
           "n_iters_equal": many["n_iters"] == one["n_iters"],
           "max_rel_metric_diff": metric_err, "launches": out["launches"],
           "seconds": time.perf_counter() - t1}
    emit(row)
    for k in launches:
        launches[k] += out["launches"][k]
    _check(n == one["num_samples"] and row["records_equal"] and row["n_iters_equal"],
           f"the engine at world {W} differs from one process: {row}")
    _check(metric_err <= 1e-3, f"engine metrics at world {W} differ by {metric_err}")
    _check(all(launches[k] > 0 for k in DP_KERNELS), f"a kernel never launched: {launches}")
    emit({"phase": "dp_total", "seconds": time.perf_counter() - t0, "launches": launches})
    return {"launches": launches}


BENCH_DATA = os.path.join(REPO, ".smoke", "bench_data")


def start_bench_data():
    """Make the bench's 32 shapes in a background process, so that phase 21 finds them."""
    code = ("from puzzlefusion_plusplus_tpu_torch import bench; "
            f"bench.ensure_data({BENCH_DATA!r})")
    return subprocess.Popen([sys.executable, "-c", code], cwd=REPO)


def phase_bench(data_proc, engine_row: dict | None) -> dict:
    """The port's benchmark entry in a subprocess at fp32, at bf16 and with --serving
    (phase 21): one JSON line each, parsed, none suspect."""
    import torch

    t0 = time.perf_counter()
    _check(data_proc.wait() == 0, "making the bench data failed")
    torch.cuda.empty_cache()  # the bench runs in its own process on the same card
    runs = {}
    for name, env, args in (("fp32", {}, []), ("bf16", {"PFPP_BENCH_PRECISION": "bf16"}, []),
                            ("serving", {"PFPP_BENCH_REPEATS": "1"}, ["--serving"])):
        t1 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "puzzlefusion_plusplus_tpu_torch.bench", *args],
            cwd=REPO, env={**os.environ, "PFPP_BENCH_DATA": BENCH_DATA, **env},
            capture_output=True, text=True, timeout=600)
        _check(out.returncode == 0, f"bench {name} failed:\n{out.stderr[-3000:]}")
        line = json.loads(out.stdout.strip().splitlines()[-1])
        _check(line["value"] > 0 and not line["extra"]["timing_suspect"],
               f"bench {name}: {line}")
        runs[name] = {**line, "process_s": time.perf_counter() - t1}
    row = {"phase": "bench", "seconds": time.perf_counter() - t0, "runs": runs,
           "fp32_assemblies_per_s": runs["fp32"]["value"],
           "engine_phase_assemblies_per_s": engine_row and engine_row["assemblies_per_s"]}
    emit(row)
    return row


def phase_bf16(den_root: str, data_root: str, vqvae_trained: bool,
               fp32_row: dict | None, engine_row: dict | None) -> dict:
    """trainer.precision=bf16 (phase 22): the full-width denoiser trainer for 6 steps, one
    step on the card held to the CPU, the b8 engine batch; launch counts of the path."""
    import shutil

    import numpy as np
    import torch

    from puzzlefusion_plusplus_tpu_torch import ops
    from puzzlefusion_plusplus_tpu_torch.inference.run import build_engine_fn, run_inference
    from puzzlefusion_plusplus_tpu_torch.training import parity
    from puzzlefusion_plusplus_tpu_torch.training.denoiser import make_model, train

    t0 = time.perf_counter()
    out_dir = os.path.join(REPO, ".smoke", "denoiser_bf16_out")
    shutil.rmtree(out_dir, ignore_errors=True)
    cfg = _denoiser_config(den_root, out_dir, _vqvae_checkpoint(vqvae_trained))
    cfg.trainer.precision = "bf16"
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()  # the bf16 path's run starts here
    state = train(cfg, max_steps=6, device="cuda")
    peak = torch.cuda.max_memory_allocated()
    _check(state.model.dtype is torch.bfloat16, "the denoiser does not compute in bf16")
    with open(os.path.join(out_dir, cfg.trainer.experiment_name, "denoiser",
                           "metrics.jsonl")) as fh:
        steps = [json.loads(line) for line in fh]
    _check(len(steps) == 6 and all(np.isfinite(r["mse_loss"]) for r in steps),
           f"bf16 steps: {steps}")
    timed_s = steps[5]["wall_s"] - steps[0]["wall_s"]

    ecfg = _full_config(data_root)
    ecfg.trainer.precision = "bf16"
    engine = build_engine_fn(ecfg, "cuda")
    walls = []
    for _ in range(2):  # the first warms up
        t1 = time.perf_counter()
        agg = run_inference(ecfg, engine=engine)
        walls.append(time.perf_counter() - t1)
    counts = ops.launch_counts()
    _check(all(np.isfinite([agg[f"eval/{k}"] for k in ("part_acc", "shape_cd", "rmse_r",
                                                         "rmse_t")])), f"bf16 engine: {agg}")
    _check(all(counts[k] > 0 for k in BF16_KERNELS), f"a kernel never launched: {counts}")

    t1 = time.perf_counter()
    pcfg, batch, make_encoder = _denoiser_parts(den_root, 2, "bf16")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(pcfg.trainer.seed)
        sd = make_model(pcfg).state_dict()
    gen = torch.Generator().manual_seed(2)
    timesteps = torch.randint(0, 1000, (2,), generator=gen)
    noise = torch.randn(batch["part_trans"].shape[:2] + (7,), generator=gen)
    args = (lambda: make_model(pcfg), sd, make_encoder, batch)
    gpu = parity.denoiser_step_on(*args, "cuda", timesteps, noise)
    cpu = parity.denoiser_step_on(*args, "cpu", timesteps, noise)
    errors = parity.compare(cpu, gpu, ("mse_loss",), parity.BF16)
    row = {"phase": "bf16", "seconds": time.perf_counter() - t0,
           "train": {"batch_shapes": DENOISER_BATCH, "timed_steps": 5,
                     "steps_per_s": 5 / timed_s,
                     "step_wall_s": [b["wall_s"] - a["wall_s"]
                                     for a, b in zip(steps[:5], steps[1:])],
                     "mse_loss": [r["mse_loss"] for r in steps],
                     "max_memory_allocated_bytes": peak,
                     "fp32_steps_per_s": fp32_row and fp32_row["steps_per_s"],
                     "fp32_max_memory_allocated_bytes":
                         fp32_row and fp32_row["max_memory_allocated_bytes"]},
           "engine": {"wall_s_per_call": walls, "assemblies_per_s": agg["num_samples"] / walls[-1],
                      "fp32_assemblies_per_s": engine_row and engine_row["assemblies_per_s"],
                      **{k: agg[f"eval/{k}"] for k in ("part_acc", "shape_cd", "rmse_r",
                                                        "rmse_t")}},
           "parity": {"seconds": time.perf_counter() - t1, "loss_gpu": gpu["metrics"]["mse_loss"],
                      "loss_cpu": cpu["metrics"]["mse_loss"], "errors": errors},
           "launches": counts}
    emit(row)
    return row


def phase_int8(results: dict, data_root: str, data_proc, engine_row: dict | None) -> dict:
    """Kernel S's int8 gather mode, ``PFPP_SA_GATHER=int8`` (phase 23): the quantize kernel
    bit-equal to its plain version and S's int8 instantiation within 1e-4 relative of its
    plain version at the engine's SA2 and SA3 shapes (M = 96), then the b8 engine under the
    variable (launch counts of its counted call: path "int8"), z_e of the int8 encode against
    the exact one on the engine batch, and the bench entry under the variable."""
    import numpy as np
    import torch

    from puzzlefusion_plusplus_tpu_torch import ops
    from puzzlefusion_plusplus_tpu_torch.data.bucketing import part_bucket, slice_batch_parts
    from puzzlefusion_plusplus_tpu_torch.data.datasets import DenoiserDataset
    from puzzlefusion_plusplus_tpu_torch.data.loader import Loader
    from puzzlefusion_plusplus_tpu_torch.inference.run import (
        build_engine_fn,
        make_models,
        run_inference,
    )
    from puzzlefusion_plusplus_tpu_torch.inference.sampler import make_frozen_encoder
    from puzzlefusion_plusplus_tpu_torch.ops import cuda_build, sa_fused
    from puzzlefusion_plusplus_tpu_torch.utils.masking import compact_parts, compaction_indices
    from puzzlefusion_plusplus_tpu_torch.utils.transforms import quat_normalize, quat_to_matrix

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)
    sa_rows = cuda_build.function("sa_cached", "pfpp_sa_cached_rows")
    int8_launch = cuda_build.function("sa_cached", "pfpp_sa_cached_int8")
    exact_launch = cuda_build.function("sa_cached", "pfpp_sa_cached")

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    M = 96
    for stage in ("SA2", "SA3"):
        S, K, N2, D, C1, C2, C3 = S_STAGES[stage]
        t1 = time.perf_counter()
        feats = randn(M, N2, D).relu()
        k1f = randn(D, C1, scale=D ** -0.5)
        k1f[:, 3] = 0  # an all-zero column of every cloud's projection
        proj = torch.matmul(feats, k1f)
        q, scale = sa_fused.sa_quantize(proj)
        q_ref, scale_ref = sa_fused.sa_quantize_plain(proj)
        equal = bool(torch.equal(q, q_ref)) and bool(torch.equal(scale, scale_ref))
        _check(equal, f"S int8 quantize {stage}: codes or scales differ from the plain version")
        _check(bool((q[:, :, 3] == 0).all()) and bool((scale[:, 3] == np.float32(1e-30)).all()),
               f"S int8 quantize {stage}: the all-zero column")
        _check(int(q.abs().max()) == 127, f"S int8 quantize {stage}: no code at 127")
        n = M * N2 * C1
        record_kernel(results, "int8", "S int8 quantize", f"{stage} [{M},{N2},{C1}]", 0.0,
                      cuda_ms(lambda: sa_fused.sa_quantize(proj), 20),
                      cuda_ms(lambda: sa_fused.sa_quantize_plain(proj), 20),
                      4 * n + n + 4 * M * C1, 3.0 * n, path="int8", bit_equal=equal,
                      seconds=time.perf_counter() - t1)

        t1 = time.perf_counter()
        g = randn(M, S, K, 3, scale=0.1)
        w_eff = randn(M, 3, C1, scale=3 ** -0.5)
        gidx = torch.randint(0, N2, (M, S, K), generator=gen, device=dev, dtype=torch.int32)
        b1, b2, b3 = randn(C1, scale=0.1), randn(C2, scale=0.1), randn(C3, scale=0.1)
        w2, w3 = randn(C1, C2, scale=C1 ** -0.5), randn(C2, C3, scale=C2 ** -0.5)
        tail = (gidx, b1, w2, b2, w3, b3)
        out = sa_fused.sa_stage_cached_int8(g, w_eff, q, scale, *tail)
        table = q.float() * scale[:, None, :]
        ref = sa_fused.sa_stage_plain(g, w_eff, table, *tail)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        rel = err / max(ref.abs().max().item(), 1e-30)
        _check(rel <= 1e-4, f"S int8 {stage}: relative error {rel}")
        _check(torch.equal(out, sa_fused.sa_stage_cached_int8(g, w_eff, q, scale, *tail)),
               f"S int8 {stage}: two launches differ")
        exact = sa_fused.sa_stage_plain(g, w_eff, proj, gidx, b1, w2, b2, w3, b3)
        quant_err = (ref - exact).abs().max().item()  # what the 8-bit codes move
        buf = torch.empty_like(out)
        dims = (M, S, K, N2, C1, C2, C3)
        ptrs = [t.data_ptr() for t in (gidx, b1, w2, b2, w3, b3, buf)]
        stream = cuda_build.stream_ptr(g)
        bare = lambda: int8_launch(g.data_ptr(), w_eff.data_ptr(), q.data_ptr(),  # noqa: E731
                                   scale.data_ptr(), *ptrs, *dims, stream)
        bare_exact = lambda: exact_launch(g.data_ptr(), w_eff.data_ptr(),  # noqa: E731
                                          proj.data_ptr(), *ptrs, *dims, stream)
        flops = 2 * M * S * K * (3 * C1 + C1 * C2 + C2 * C3)
        nbytes = (4 * (g.numel() + w_eff.numel() + scale.numel() + gidx.numel() + C1
                       + C1 * C2 + C2 + C2 * C3 + C3 + M * S * C3) + q.numel())
        stage_args = (g, w_eff, feats, gidx, k1f, b1, w2, b2, w3, b3)
        record_kernel(
            results, "int8", "S int8", f"{stage} M={M}", err,
            cuda_ms(lambda: sa_fused.sa_stage_cached_int8(g, w_eff, q, scale, *tail), 20),
            cuda_ms(lambda: sa_fused.sa_stage_plain(g, w_eff, q.float() * scale[:, None, :],
                                                    *tail), 3),
            nbytes, flops, path="int8", tensor_cores=True, max_rel_err=rel,
            kernel_ms=cuda_ms(bare, 20), exact_kernel_ms=cuda_ms(bare_exact, 20),
            stage_ms=cuda_ms(lambda: sa_fused.sa_stage_fused_cached(
                *stage_args, gather_impl="int8"), 20),
            exact_stage_ms=cuda_ms(lambda: sa_fused.sa_stage_fused_cached(
                *stage_args, gather_impl="onehot"), 20),
            quantization_max_abs=quant_err,
            computed=l2_weights(sa_rows(K, C1, C2, 1), M, S, K, C1 * C2 + C2 * C3),
            seconds=time.perf_counter() - t1)
        del out, ref, exact, table, buf

    # the b8 engine under the variable, which the engine reads when it is built
    t1 = time.perf_counter()
    cfg = _full_config(data_root)
    os.environ["PFPP_SA_GATHER"] = "int8"
    try:
        engine = build_engine_fn(cfg, "cuda")
    finally:
        del os.environ["PFPP_SA_GATHER"]
    _check(engine.sa_gather == "int8", f"the engine's gather mode is {engine.sa_gather}")
    walls = []
    for call in range(2):  # call 0 warms up; call 1 is counted
        if call == 1:
            ops.reset_launch_counts()  # the int8 path's run starts here
        t2 = time.perf_counter()
        agg = run_inference(cfg, engine=engine)
        walls.append(time.perf_counter() - t2)
    counts = ops.launch_counts()
    vals = [agg[f"eval/{k}"] for k in ("part_acc", "shape_cd", "rmse_r", "rmse_t")]
    _check(all(np.isfinite(vals)), f"int8 engine: non-finite metrics {agg}")
    _check(all(counts[k] > 0 for k in PATH_KERNELS["int8"]),
           f"a kernel never launched: {counts}")
    _check(counts["S int8"] == counts["S int8 quantize"] == 2 * counts["S"],
           f"int8 engine: SA1 exact, SA2 and SA3 int8 a step: {counts}")
    engine_s = time.perf_counter() - t1

    # z_e of the int8 encode against the exact one on the engine batch's clouds
    vq = make_models(cfg)[0].cuda()
    encs = {m: make_frozen_encoder(vq, "cached", m) for m in ("onehot", "int8")}
    ds = DenoiserDataset(cfg.data.data_val_dir, mode="test",
                         matching_data_path=cfg.data.matching_data_path)
    batch = next(iter(Loader(ds, 8, shuffle=False, drop_last=False)))
    batch = slice_batch_parts(batch, part_bucket(int(np.max(batch["num_parts"]))))
    pcs = torch.from_numpy(batch["part_pcs"]).cuda()
    B, P, N, _ = pcs.shape
    _, src, _ = compaction_indices(torch.from_numpy(batch["part_valids"]).cuda())
    flat = compact_parts(pcs, src).reshape(B * P, N, 3)
    rot = quat_to_matrix(quat_normalize(torch.randn((B * P, 4), generator=gen, device=dev)))
    with torch.no_grad():
        idx, geom = encs["onehot"].grouping(flat)
        z = {m: enc.apply(flat, idx, geom, rot) for m, enc in encs.items()}
    z_err = (z["int8"]["z_e"] - z["onehot"]["z_e"]).abs().max().item()
    z_scale = z["onehot"]["z_e"].abs().max().item()
    same_codes = (z["int8"]["z_q"] == z["onehot"]["z_q"]).all(-1).float().mean().item()

    # the bench entry under the variable
    t1 = time.perf_counter()
    if data_proc is not None:
        _check(data_proc.wait() == 0, "making the bench data failed")
    else:
        from puzzlefusion_plusplus_tpu_torch import bench

        bench.ensure_data(BENCH_DATA)
    torch.cuda.empty_cache()  # the bench runs in its own process on the same card
    out = subprocess.run(
        [sys.executable, "-m", "puzzlefusion_plusplus_tpu_torch.bench"], cwd=REPO,
        env={**os.environ, "PFPP_BENCH_DATA": BENCH_DATA, "PFPP_SA_GATHER": "int8"},
        capture_output=True, text=True, timeout=600)
    _check(out.returncode == 0, f"bench under int8 failed:\n{out.stderr[-3000:]}")
    line = json.loads(out.stdout.strip().splitlines()[-1])
    _check(line["value"] > 0 and not line["extra"]["timing_suspect"]
           and line["extra"]["sa_gather"] == "int8", f"bench under int8: {line}")
    row = {"phase": "int8", "seconds": time.perf_counter() - t0,
           "engine": {"seconds": engine_s, "wall_s_per_call": walls,
                      "assemblies_per_s": agg["num_samples"] / walls[-1],
                      "exact_assemblies_per_s": engine_row and engine_row["assemblies_per_s"],
                      **{k: agg[f"eval/{k}"] for k in ("part_acc", "shape_cd", "rmse_r",
                                                        "rmse_t")},
                      "n_iters": agg["n_iters"]},
           "z_e": {"clouds": B * P, "max_abs_dev_vs_exact": z_err,
                   "max_rel_dev_vs_exact": z_err / z_scale,
                   "codes_equal_share": same_codes},
           "bench": {"value": line["value"], "sa_gather": line["extra"]["sa_gather"],
                     "runs_s": line["extra"]["runs_s"],
                     "process_s": time.perf_counter() - t1},
           "launches": counts}
    emit(row)
    return row


def phase_overfit() -> dict:
    """The overfit proof at ``OVERFIT_CUT`` (phase 24): its curve, both engine rows, the
    learning check and the engine's checkpoints."""
    import shutil

    import numpy as np

    from puzzlefusion_plusplus_tpu_torch import ops
    from puzzlefusion_plusplus_tpu_torch.scripts import overfit_proof
    from puzzlefusion_plusplus_tpu_torch.utils.config import Config

    t0 = time.perf_counter()
    root = os.path.join(REPO, ".smoke", "chip_smoke_overfit")
    evidence_dir = os.path.join(REPO, ".smoke", "evidence")
    shutil.rmtree(root, ignore_errors=True)  # overfit_proof resumes from what it finds
    ops.reset_launch_counts()  # the overfit path's run starts here
    summary = overfit_proof.run(Config(), root, num_shapes=1, device="cuda",
                                evidence_dir=evidence_dir, **OVERFIT_CUT)
    counts = ops.launch_counts()
    curve, engine = summary["curve"], summary["engine"]
    held = [p["mse_held"] for p in curve]
    row = {"phase": "overfit", "seconds": time.perf_counter() - t0, "cut": OVERFIT_CUT,
           "curve": curve, "engine": engine, "mse_held_ratio": held[-1] / held[0],
           "mse_held_fraction_bar": OVERFIT_MSE_FRACTION,
           "stage_seconds": summary["seconds"],
           **{k: summary[k] for k in ("steps", "batch", "denoiser_s_per_step", "wall_s",
                                      "peak_memory_bytes", "checkpoints")},
           "launches": counts}
    emit(row)
    _check(all(np.isfinite(v) for p in curve for v in p.values()), f"non-finite curve {curve}")
    _check(all(np.isfinite(r[k]) for r in engine.values()
               for k in ("part_acc", "shape_cd", "rmse_r", "rmse_t")), f"engine {engine}")
    _check(held[-1] <= OVERFIT_MSE_FRACTION * held[0],
           f"the held-draw loss fell from {held[0]} to {held[-1]}, not below "
           f"{OVERFIT_MSE_FRACTION} of it")
    ckpts = summary["checkpoints"]
    _check(all(path.startswith(root) and os.path.isdir(path) for path in ckpts.values())
           and engine["full"]["verifier"] == ckpts["verifier"],
           f"the engine did not serve the phase's checkpoints: {ckpts}, {engine}")
    _check(all(counts[k] > 0 for k in OVERFIT_REQUIRED), f"a kernel never launched: {counts}")
    return row


def oracle_witness(batches: list) -> dict:
    """The CPU's own float error in regimes C and D over one split's CPU batches (the numpy
    arrays of ``matcher_diagnosis.oracle_regimes``): each regime's F1 as computed, with C's
    Sinkhorn in float64 over the same s_oracle, and with s_oracle scaled by 1 +
    ``ORACLE_JITTER`` u (u uniform in [-1, 1], seeded); and C's scores under each against
    the float32 ones as computed, relative to the largest cross-piece entry (the card's
    differ by what the bars of the phase's checks allow)."""
    import numpy as np
    import torch

    from puzzlefusion_plusplus_tpu_torch.matching.sinkhorn import sinkhorn_log
    from puzzlefusion_plusplus_tpu_torch.scripts import matcher_diagnosis as diag

    rng = np.random.default_rng(0)
    counts = dict.fromkeys(("C", "C_f64", "C_jitter", "D", "D_jitter"), 0.0)
    scores_err = dict.fromkeys(("C_f64", "C_jitter"), 0.0)
    for regimes in batches:
        (c32, n, gtp, cross), s = regimes["C"], regimes["D"][0]
        t_n = torch.from_numpy(n)

        def sinkhorn(x):  # oracle_regimes' iterations and tau
            return sinkhorn_log(torch.from_numpy(x), t_n, t_n, 20, 0.05).numpy()

        s_jit = np.where(cross, (s * (1 + ORACLE_JITTER * rng.uniform(-1, 1, s.shape)))
                         .astype(np.float32), s)
        scores = {"C": c32, "C_f64": sinkhorn(s.astype(np.float64)),
                  "C_jitter": sinkhorn(s_jit), "D": s, "D_jitter": s_jit}
        for key, value in scores.items():
            counts[key] = counts[key] + diag.regime_counts(value, n, gtp, cross)
        for key in scores_err:
            scores_err[key] = max(scores_err[key], float(np.abs(scores[key] - c32).max()
                                                         / np.abs(c32[cross]).max()))
    return {**{k: diag.f1(v) for k, v in counts.items()},
            **{f"{k}_scores_rel_err": v for k, v in scores_err.items()}}


def phase_matcher_eval(paths: dict) -> dict:
    """``scripts/matcher_train_eval.py::run`` at ``MATCHER_EVAL`` (phase 25), its engine
    comparison served from ``paths`` (the checkpoints of phases 6, 10 and 14, or their seeded
    stand-ins) laid out as the run root's ``out/everyday/*/ckpt``; then
    ``scripts/matcher_diagnosis.py`` on its checkpoint over both splits and
    ``scripts/matching_sensitivity_probe.py`` on the written data against the GT-synthetic
    data. Regimes C and D, which no weight enters, run again on the CPU over the same
    batches and must agree with the card's (see the checks' comment for the bars)."""
    import shutil

    import numpy as np
    import torch

    from puzzlefusion_plusplus_tpu_torch import ops
    from puzzlefusion_plusplus_tpu_torch.data.bucketing import part_bucket
    from puzzlefusion_plusplus_tpu_torch.data.datasets import DenoiserDataset
    from puzzlefusion_plusplus_tpu_torch.matching.train import METRIC_KEYS
    from puzzlefusion_plusplus_tpu_torch.scripts import matcher_diagnosis as diag
    from puzzlefusion_plusplus_tpu_torch.scripts import matcher_train_eval as mte
    from puzzlefusion_plusplus_tpu_torch.scripts import matching_sensitivity_probe as probe
    from puzzlefusion_plusplus_tpu_torch.training.vqvae import to_device
    from puzzlefusion_plusplus_tpu_torch.utils.config import Config

    t0 = time.perf_counter()
    root = os.path.join(REPO, ".smoke", "chip_smoke_matcher_eval")
    evidence_dir = os.path.join(REPO, ".smoke", "evidence")
    shutil.rmtree(root, ignore_errors=True)
    for stage, path in paths.items():  # a ckpt dir, or a stand-in's step dir
        ckpt = os.path.dirname(path) if os.path.basename(path).startswith("step_") else path
        os.makedirs(os.path.join(root, "out", "everyday", stage))
        os.symlink(ckpt, os.path.join(root, "out", "everyday", stage, "ckpt"))
    n, cfg = MATCHER_EVAL["num_points"], MATCHER_EVAL
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()  # the matcher_eval path's run starts here
    summary = mte.run(Config(), root, log_every=1, device="cuda", evidence_dir=evidence_dir,
                      **cfg)
    peak = torch.cuda.max_memory_allocated()
    t1 = time.perf_counter()
    diag_kw = dict(num_points=n, max_parts=20, batch=cfg["batch"],
                   n_shapes=MATCHER_EVAL_DIAG_SHAPES)
    decomposition = diag.run(root, summary["matcher_out"] + "/ckpt", pc_feat=128,
                             aff_feat=512, sa_npoints=(1024, 256, 64, 16),
                             out_tag="chip_smoke_matcher_eval", device="cuda",
                             evidence_dir=evidence_dir, **diag_kw)
    diag_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    sens = probe.run(Config(), root, n_train=cfg["n_train"], device="cuda",
                     evidence_dir=evidence_dir)
    probe_s = time.perf_counter() - t1
    counts = ops.launch_counts()

    # the engine served the 4 held-out shapes in one batch at the kernels phase's pad
    val_parts = DenoiserDataset(os.path.join(root, "pc_data", "val"), mode="train",
                                max_num_part=20).num_parts_list()
    serve_pad = part_bucket(int(max(val_parts)), Config().inference.part_bucket_multiple, 20)
    _check(len(val_parts) == cfg["n_val"] <= 8 and serve_pad == MATCHER_EVAL_SERVE_PARTS,
           f"the engine's batch is not the kernels phase's: {list(val_parts)}, P = {serve_pad}")

    # regimes C and D (no weight enters them) on the card and on the CPU over the same batches
    splits = ("val", "train")
    arrays = {dev: {split: [] for split in splits} for dev in ("cuda", "cpu")}

    def oracle_on(dev, split):
        def fn(batch):
            regimes = {k: tuple(a.cpu().numpy() for a in v) for k, v in
                       diag.oracle_regimes(to_device(batch, dev)).items()}
            arrays[dev][split].append(regimes)
            return regimes, None
        return fn

    oracle = {dev: {split: diag.split_stats(os.path.join(root, "pc_data", split),
                                            oracle_on(dev, split), **diag_kw)
                    for split in splits} for dev in arrays}
    gaps = {f"{split}/{k}/{m}": abs(oracle["cuda"][split][k][m] - oracle["cpu"][split][k][m])
            for split in splits for k in "CD" for m in ("precision", "recall", "f1")}
    t1 = time.perf_counter()
    witness = {split: oracle_witness(arrays["cpu"][split]) for split in splits}
    witness_s = time.perf_counter() - t1
    score_err, discrete_equal = {"C": 0.0, "D": 0.0}, True
    for card, cpu in zip(*(sum(arrays[dev].values(), []) for dev in ("cuda", "cpu"))):
        for k in "CD":
            (sc, *rest), (sc_cpu, *rest_cpu) = card[k], cpu[k]
            discrete_equal &= all(np.array_equal(a, b) for a, b in zip(rest, rest_cpu))
            cross = rest_cpu[2].astype(bool)
            score_err[k] = max(score_err[k], float(np.abs(sc - sc_cpu).max()
                                                   / np.abs(sc_cpu[cross]).max()))
    with open(os.path.join(summary["matcher_out"], "metrics.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    steps = [r for r in recs if "loss" in r]
    vals = [r for r in recs if "val_mat_f1" in r]
    step_s = [b["wall_s"] - a["wall_s"] for a, b in zip(steps, steps[1:])
              if a["epoch"] == b["epoch"]]
    # a validation: its record's time after the epoch's last step
    val_s = [v["wall_s"] - max(r["wall_s"] for r in steps if r["step"] < v["step"]) for v in vals]
    comparison = summary["comparison"] or {}
    f1s = [decomposition[split][k][m] for split in ("val", "train") for k in (*"ABCD", "cls")
           for m in ("precision", "recall", "f1")]
    row = {"phase": "matcher_eval", "seconds": time.perf_counter() - t0, "cut": cfg,
           "num_points": n, "batch_shapes": cfg["batch"],
           "steps_per_s": len(step_s) / sum(step_s),
           "points_per_s": n * cfg["batch"] * len(step_s) / sum(step_s),
           "step_wall_s": step_s, "val_wall_s": val_s,
           "losses": [{k: r[k] for k in ("step", "loss", "cls_loss", "mat_loss", "rig_loss")}
                      for r in steps],
           "val_mat_f1": [v["val_mat_f1"] for v in vals], "oracle": summary["oracle"],
           "driver_seconds": summary["seconds"],
           "write_s_per_shape": summary["seconds"]["write"] / max(summary["written"], 1),
           "written": summary["written"], "edges": summary["edges"],
           "comparison": comparison, "decomposition": {k: decomposition[k] for k in
                                                       ("val", "train")},
           "oracle_regimes": oracle, "oracle_regimes_f1_gaps": gaps,
           "oracle_scores_rel_err": score_err, "oracle_discrete_equal": discrete_equal,
           "oracle_witness": witness, "witness_s": witness_s,
           "serve_parts": [int(p) for p in val_parts],
           "diagnosis_s": diag_s, "probe_s": probe_s, "probe_verdict": sens["verdict"],
           "probe_shapes": sens["n_shapes"], "probe_merged_pairs": sens["total_merged_pairs"],
           "max_memory_allocated_bytes": peak, "launches": counts}
    emit(row)
    _check(len(steps) == cfg["epochs"] * cfg["n_train"] // cfg["batch"]
           and all(np.isfinite(r[k]) for r in steps for k in METRIC_KEYS),
           f"{len(steps)} steps, losses {row['losses']}")
    _check(len(vals) == cfg["epochs"] and all(0 <= v <= 1 for v in row["val_mat_f1"]),
           f"val mat_f1 {row['val_mat_f1']}")
    written = [f for f in os.listdir(summary["matching_data"]) if f.endswith(".npz")]
    _check(summary["written"] == len(written) == cfg["n_val"], f"written: {written}")
    _check(set(comparison) == {"model", "gt-synthetic"}
           and all(np.isfinite(agg[f"eval/{k}"]) for agg in comparison.values()
                   for k in ("part_acc", "shape_cd", "rmse_r", "rmse_t")),
           f"engine comparison {comparison}")
    _check(all(0 <= v <= 1 for v in f1s), f"decomposition {decomposition}")
    # the card computes C's and D's inputs as the CPU does: critical sets, GT permutations and
    # cross masks equal; D's scores (-d², float32 expanded form) within 1e-4 of the largest,
    # C's (20 Sinkhorn iterations at tau 0.05 over them) within 1e-3. D's F1 (the Hungarian on
    # -d²) agrees to 1e-3. C's F1 is held to 5e-3, because float32 fixes it no closer: on the
    # CPU alone, C's Sinkhorn in float64, or s_oracle scaled by 1 + 1e-6 u, moves C's scores
    # less than the card does and its F1 by more (the row's "oracle_witness"; ROADMAP §3)
    _check(discrete_equal and score_err["D"] <= 1e-4 and score_err["C"] <= 1e-3,
           f"regimes C and D, card against CPU: equal {discrete_equal}, scores {score_err}")
    _check(max(v for k, v in gaps.items() if "/D/" in k) <= 1e-3
           and max(gaps.values()) <= 5e-3, f"regimes C and D, card against CPU: {gaps}")
    _check(sens["n_shapes"] == cfg["n_val"], f"the probe covered {sens['n_shapes']} shapes")
    _check(all(counts[k] > 0 for k in MATCHER_EVAL_REQUIRED), f"a kernel never launched: {counts}")
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="build,kernels,fps_shapes,engine,merge,profile,train,"
                                        "train_parity,profile_train,encoder_modes,"
                                        "train_denoiser,denoiser_parity,profile_denoiser,"
                                        "verifier_gen,train_verifier,verifier_parity,serve,"
                                        "train_matching,matching_parity,profile_matching,"
                                        "matching_gen,dp,bench,bf16,int8,overfit,"
                                        "matcher_eval")
    phases = ap.parse_args().phases.split(",")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from puzzlefusion_plusplus_tpu_torch import ops
    from puzzlefusion_plusplus_tpu_torch.data.synthetic import generate_dataset
    from puzzlefusion_plusplus_tpu_torch.inference.run import resolve_device

    resolve_device("cuda")  # also turns TF32 off for the comparisons
    t_start = time.perf_counter()
    results: dict = {}
    bench_data = start_bench_data() if {"bench", "int8"} & set(phases) else None
    if bench_data is not None:  # stopped if a phase fails before phase 21 waits for it
        atexit.register(lambda: bench_data.poll() is None and bench_data.kill())
    rows: dict = {}  # phases whose numbers later phases print beside their own
    if "build" in phases:
        phase_build()
    if "kernels" in phases:
        phase_kernels(results)
    if "fps_shapes" in phases:
        phase_fps_shapes()
    launches = {}  # per path: the counts of its own run
    data_root = os.path.join(REPO, ".smoke", "chip_smoke_data")
    if {"engine", "merge", "profile", "encoder_modes", "serve", "dp", "bf16",
        "int8"} & set(phases):
        t0 = time.perf_counter()
        generate_dataset(data_root, num_shapes=8, seed=7, split="val", min_parts=3,
                         max_parts=12)
        emit({"phase": "data", "seconds": time.perf_counter() - t0})
    if "engine" in phases or "merge" in phases:
        ops.reset_launch_counts()  # phase_engine resets again after its warm-up call
        if "engine" in phases:
            rows["engine"] = phase_engine(data_root)
        if "merge" in phases:
            phase_merge(data_root)  # its GPU run closes the main path's run
        launches["inference"] = ops.launch_counts()
        expected = [k for k in INFERENCE_KERNELS
                    if "merge" in phases or k not in MERGE_ONLY_KERNELS]
        _check(all(launches["inference"][k] > 0 for k in expected),
               f"kernel never launched: {launches['inference']}")
    if "profile" in phases:
        phase_profile(data_root)
    train_root = os.path.join(REPO, ".smoke", "chip_smoke_train_data")
    if {"train", "train_parity", "profile_train", "dp"} & set(phases):
        t0 = time.perf_counter()
        generate_dataset(train_root, num_shapes=TRAIN_SHAPES, seed=11, split="train",
                         min_parts=3, max_parts=12)
        emit({"phase": "train_data", "seconds": time.perf_counter() - t0})
        if "train" in phases:
            launches["train"] = phase_train(train_root)["launches"]
        if "train_parity" in phases:
            phase_train_parity(train_root)
        if "profile_train" in phases:
            phase_profile_train(train_root)
    if "encoder_modes" in phases:
        launches["encoder_modes"] = phase_encoder_modes(data_root)["launches"]
    den_root = os.path.join(REPO, ".smoke", "chip_smoke_denoiser_data")
    if {"train_denoiser", "denoiser_parity", "profile_denoiser", "dp", "bf16"} & set(phases):
        t0 = time.perf_counter()
        for split, seed in (("train", 13), ("val", 14)):
            generate_dataset(den_root, num_shapes=DENOISER_SHAPES, seed=seed, split=split,
                             min_parts=3, max_parts=12)
        emit({"phase": "denoiser_data", "seconds": time.perf_counter() - t0})
        if "train_denoiser" in phases:
            rows["train_denoiser"] = phase_train_denoiser(den_root, "train" in phases)
            launches["train_denoiser"] = rows["train_denoiser"]["launches"]
        if "denoiser_parity" in phases:
            phase_denoiser_parity(den_root)
        if "profile_denoiser" in phases:
            phase_profile_denoiser(den_root)
    if "verifier_gen" in phases:
        t0 = time.perf_counter()
        gen_root = os.path.join(REPO, ".smoke", "chip_smoke_verifier_gen_data")
        generate_dataset(gen_root, num_shapes=VERIFIER_GEN_SHAPES, seed=15, split="train",
                         min_parts=3, max_parts=12, with_verifier=False)
        emit({"phase": "verifier_gen_data", "seconds": time.perf_counter() - t0})
        launches["verifier_gen"] = phase_verifier_gen(
            gen_root, "train" in phases, "train_denoiser" in phases)["launches"]
    ver_root = os.path.join(REPO, ".smoke", "chip_smoke_verifier_data")
    if {"train_verifier", "verifier_parity", "dp"} & set(phases):
        t0 = time.perf_counter()
        _verifier_files(ver_root)
        emit({"phase": "verifier_data", "seconds": time.perf_counter() - t0})
        if "train_verifier" in phases:
            launches["train_verifier"] = phase_train_verifier(ver_root)["launches"]
        if "verifier_parity" in phases:
            phase_verifier_parity(ver_root)
    if "serve" in phases:
        launches["serve"] = phase_serve(data_root, _serve_checkpoints(
            "train" in phases, "train_denoiser" in phases,
            "train_verifier" in phases))["launches"]
    match_root = os.path.join(REPO, ".smoke", "chip_smoke_matching_data")
    if {"train_matching", "matching_parity", "profile_matching", "matching_gen",
        "dp"} & set(phases):
        t0 = time.perf_counter()
        for split, n, seed in (("train", MATCHING_SHAPES, 18), ("val", MATCHING_GEN_SHAPES, 19),
                               ("val_train", MATCHING_VAL_SHAPES, 20)):
            generate_dataset(match_root, num_shapes=n, seed=seed, split=split, min_parts=3,
                             max_parts=12, with_matching=False, with_verifier=False)
        emit({"phase": "matching_data", "seconds": time.perf_counter() - t0})
        if "train_matching" in phases:
            launches["train_matching"] = phase_train_matching(match_root)["launches"]
        if "matching_parity" in phases:
            phase_matching_parity(match_root)
        if "profile_matching" in phases:
            phase_profile_matching(match_root)
        if "matching_gen" in phases:
            gen = phase_matching_gen(match_root, "train_matching" in phases)
            launches["matching_gen"] = gen["launches"]
            launches["matching_serve"] = gen["launches_serve"]
    if "dp" in phases:
        launches["dp"] = phase_dp(train_root, den_root, ver_root, data_root,
                                  match_root)["launches"]
    if "bench" in phases:
        phase_bench(bench_data, rows.get("engine"))
    if "bf16" in phases:
        launches["bf16"] = phase_bf16(den_root, data_root, "train" in phases,
                                      rows.get("train_denoiser"), rows.get("engine"))["launches"]
    if "int8" in phases:
        launches["int8"] = phase_int8(results, data_root, bench_data,
                                      rows.get("engine"))["launches"]
    if "overfit" in phases:
        launches["overfit"] = phase_overfit()["launches"]
    if "matcher_eval" in phases:
        launches["matcher_eval"] = phase_matcher_eval(_serve_checkpoints(
            "train" in phases, "train_denoiser" in phases,
            "train_verifier" in phases))["launches"]

    if results:
        rows = []
        for name, recs in results.items():
            # S, R, A, B: the sum over one step's shapes (of the first path; B's skewed case
            # apart); F, G, N, M, P: the largest shape of the first path; every shape under
            # "per_shape"
            step = [r for r in recs if r["path"] == recs[0]["path"] and not r.get("skewed")]
            main_rec = step[-1]
            agg = (lambda key: sum(r[key] for r in step)) if name in SUMMED else (
                lambda key: main_rec[key])
            timed = tuple(k for k in ("ms", "kernel_ms", "kernel_graph_ms",
                                      "library_graph_ms") if k in main_rec)
            source, replaces = REPLACES[name]
            per_path = {path: counts[name] for path, counts in launches.items()
                        if name in PATH_KERNELS[path]}
            row = {
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                # each kernel's count on its own path (training for A and B, the encoder
                # modes for R, inference for the rest)
                "launches": per_path.get(MAIN_PATH.get(name, "inference")),
                "launches_per_path": per_path,
                "max_abs_err": max(r["max_abs_err"] for r in recs),
                **{k: agg(k) for k in timed}, "plain_ms": agg("plain_ms"),
                "bound_ms": agg("bound_ms"),
                "bound_by": main_rec["bound_by"],
                "library_ms": agg("library_ms") if main_rec["library_ms"] is not None else None,
                "shape": {"S": "SA1+SA2+SA3 of one denoise step at M=96",
                          "R": "SA1+SA2+SA3 of one 'always' encode",
                          "A": "SA2+SA3 feature gathers of one VQ-VAE training step",
                          "B": "chamfer + SA2 + SA3 backward of one training step",
                          "S int8": "SA2+SA3 of one int8 denoise step at M=96",
                          "S int8 quantize": "SA2+SA3 projections of one int8 denoise step "
                                             "at M=96"}.get(
                              name, main_rec["shape"]),
                "per_shape": [{k: r[k] for k in ("path", "shape", "max_abs_err", *timed,
                                                 "plain_ms", "bound_ms", "library_ms")
                               + (("f_ms",) if name == "P" else ())
                               + (INT8_EXTRA if name == "S int8" else ())}
                              for r in recs],
            }
            if name == "P":
                row["f_ms"] = main_rec["f_ms"]  # kernel F on the same input
            rows.append(row)
        print(json.dumps({"kernels": rows}), flush=True)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
