#!/usr/bin/env python3
"""Smoke test of the PyTorch port (fitv2_tpu_torch) on one NVIDIA H100.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):
  1. device   - a CUDA card of compute capability 9.0; its name and power
                limit as nvidia-smi reports them; TF32 off for fp32 phases.
  2. build    - nvcc builds the kernel library from fitv2_tpu_torch/kernels/
                csrc/ (sm_90a); the build seconds; ptxas registers and
                spills of every instantiation of K1, K2 (vector), the bf16
                attention kernel, the bf16 K5, K6 and K7, a line a family.
  3. kernels  - each CUDA kernel against its plain PyTorch version at the
                sampler's shapes (CFG batch 16, N 256, D 1152, H 16, Dh 72),
                bf16 and fp32, with the error against the stated tolerance
                and both median times (CUDA events), beside the kernel's
                bound (bytes over 3.35 TB/s or operations over the peak of
                their type, the larger); K1 and K2 also L2-cold (a 128 MiB
                write, then a 128 MiB read, between the calls: the time
                their bound is held against) and after the write alone
                (dirty); the attention kernel's four
                variant/mask cases also beside torch's
                scaled_dot_product_attention on the same inputs (checked
                against the plain version, timed as the yardstick, used
                nowhere in the package); K5 beside the unfused pair it
                replaces (K2 + K4 on the same qkv); one case each of K4 and
                K5 at Dh 32 (configs/fitv2_small_cifar.yaml); K6 at its
                three sites (qkv, proj, fc2) and K7 at fc1, for M = 4096
                and 2048 (CFG and conditional-only batches), K6 bit for
                bit, with TOP/s.
  4. parity   - FiTv2-XL/2 (depth 36) fp32, random seeded weights with the
                zero-init leaves perturbed, batch 1, one CFG Euler step: the
                port on CUDA (kernels) against the port on the CPU (plain
                versions) on the same weights and noise; relative L2.
  5. main     - the user's path: build_sampler on XL/2 in bf16 with a random
                SD-VAE decoder, batch 8, 250 steps at 256x256, VAE, uint8,
                save_npz. Checks the npz, the latents and the exact launch
                count of every kernel; prints the denoise-only and the full
                pipeline images/s.
  6. int8     - the int8 W8A8 serving path: the same weights in
                FiT(gemm_precision='int8'), built-in calibration, batch 8,
                250 steps, VAE, npz; the one-step velocity's cosine against
                the bf16 model; exact launch counts (K6 3 and K7 1 per
                block); denoise and full-pipeline images/s.
  7. serving-max - int8 with CFG only for t in [0.3, 0.9] and quadratic
                velocity extrapolation every 2 steps; exact launch counts
                from the forwards the ladder implies; images/s.
  8. fused    - FiT(attn_impl='fused') on the padded 160x320 bucket (200 of
                256 tokens valid), batch 8, 250 steps, VAE, npz of
                (8, 160, 320, 3); K5 in every block, K2-K4 never; the one
                -step velocity against the unfused path; images/s.
  9. hr       - FiTv2-HR-XL/2 (configs/fitv2_hr_xl.yaml's widths: context
                1024, online decoupled NTK RoPE trained at 16 x 16; the
                same seeded weights): K1, K2 (per-sample online tables)
                and K4 (no mask, 800 of 1024 keys valid) at N 1024 against
                their plain versions; the fp32 one-step velocity at 512x512,
                batch 1, CUDA vs CPU; then in bf16, batch 4, 250 steps, CFG
                1.5, VAE, npz: 512x512 ('keep', N 1024 unmasked) and
                320x640 (800 of 1024 tokens valid); then XL/2 through
                BucketedSampler at 320x320 ('ntkpro2', context grown to
                400), batch 8; exact launch counts and images/s of each.
 10. eval     - InceptionV3 with seeded pytorch-fid-layout weights, on the
                card against the CPU on 8 images (TF32 off); activation
                images/s at batch 64 over 512 seeded 256x256 images;
                cli/evaluate with --device cuda on phase 5's and phase 9's
                npz files: finite FID, sFID, IS, precision and recall.
 11. train    - (a) each kernel's autograd Function (K1, K2, K3/K4 without
                a mask and with 200/256 keys valid, K5) at the training
                shapes (batch 32, N 256), bf16 and fp32: its forward output
                against the plain version's at phase 3's gates, then its
                gradients against autograd of the plain version on the
                same card inputs (fp32 1e-5, bf16 3e-2 of the largest
                |grad|), with each side's forward and backward times;
                (b) XL width, depth 4, fp32, batch 2: one flow loss and
                backward on CUDA against the CPU, every parameter's
                gradient within 1e-4 relative L2 (none missing); (c)
                cli/train.py's build_trainer on configs/fitv2_xl.yaml (batch
                32, bf16 compute over fp32 masters, bf16 mu, fp32 EMA, the
                native loader) on 512 synthetic shards padded to 256
                tokens, its depth cut to 6: 30 steps with a checkpoint at
                20, then a new trainer resumed from 20 to 30, deterministic
                algorithms on; every loss (the first near 2.0), ms a step
                (synced every step), peak memory, exact launch counts a
                step (K1 13, K2 6, K4 6, the rest 0) and the resumed
                run's parameters, EMA and moments bit-identical to the
                uninterrupted run's; then the rate, ms a step and images/s,
                at the config's depth 36, from a third run with
                deterministic algorithms off and the metrics read every 8
                steps: steps 9-16, from a sync to a sync.
 12. fitv1    - FiTv1-XL/2 (configs/fit_xl.yaml: depth 28, SwiGLU-large,
                adaLN 'normal', learn_sigma, no q/k norm): (a) K2 in its
                RoPE-only mode at (16, 256, 16, 72), bf16 and fp32, against
                its plain version at phase 3's gates, with its times and
                bound (K3 unmasked at this shape: phase 3's case, cited),
                and its autograd Function in that mode at the training
                shape (32, 256, 16, 72), bf16 and fp32, forward and
                backward against autograd of the plain version at phase
                11's gates; (b) fp32, seeded weights with the zero-init leaves
                perturbed, batch 1: one DDPM p_mean_variance at the middle
                of the 250-step respaced ladder, CUDA vs CPU, the mean and
                the log-variance within 1e-4 relative L2; (c) bf16, batch
                8, 256x256, CFG 1.5, 250 respaced DDPM steps, then DDIM,
                each: the denoise rate (the median of V1_RATE_CALLS calls,
                with their range), then VAE, uint8, npz with exact
                launch counts (a forward: K1 57, K2 28, K3 28; K4-K7 0);
                (d) (in 11 (c)'s child process, for phase 18's CAME run)
                cli/train.py's build_trainer on the config with its
                depth cut to 4 (batch 32, the ddpm objective) on phase
                11's shards: 10 steps with a checkpoint at 6, a new
                trainer resumed from 6, deterministic algorithms on;
                finite losses, the first mse near 1 (an untrained FiT
                outputs 0), exact launch counts a step, ms a step, peak
                memory, and the resumed run bit-identical.
 13. lwd      - the LwD family, seeded weights with every adaLN output
                layer and final projection perturbed: (a) one segment's
                forward_run_layer in fp32 (batch 2, the middle segment),
                CUDA vs CPU, the velocity and the REPA projection within
                1e-4 relative L2, for configs/fitv2_xl_lwd.yaml (FiTLwD-XL:
                K 12 segments of 3 blocks, 12 REPA blocks) and
                configs/bfm_xl.yaml (BFM-XL's widths, RMSNorm q/k, its depth
                cut to an 8-block shared encoder and K 6 decoders of 2
                blocks; the config: 20 and 6 of 5); each
                model's weights then written as a port checkpoint
                (checkpoint-0/train_state.pt, ema_params) and sampled in
                bf16 at batch 8 (a merged YAML sets dtype: bfloat16) through
                cli/sample_lwd.main with phase 5's random VAE decoder, to a
                256x256 uint8 npz, with exact launch counts: (b) FiTLwD-XL
                sample_cfg, CFG 1.4, 21 sub-steps a segment (a CFG eval: K1
                7, K2 3, K4 3); (c) BFM-XL sample_maruyama_cfg with
                --self-guidance, CFG 1.4 for t in GUIDANCE, 42 sub-steps a
                segment (an eval: K1 16 in the encoder, the decoders' and
                final layer's conditioning per token; K3 10; K2 and K4 0);
                (d) FiTLwD-XL's sample_multiscale (N 16 -> 64 -> 256, no
                CFG, 21 sub-steps), then K1, K2 and K4 at each of its grids,
                N 16, 64 and 256 (batch 8), BFM's K1 (D 384) and K2 + K4
                (Dh 64) and BFM-XL's K3 on RMSNorm'd q/k against their
                plain versions at phase 3's gates, bf16 and fp32, with
                times and bounds. Each path's denoise rate is the library
                sampler's (the median of V1_RATE_CALLS calls); the CLI
                samples V1_RATE_CALLS batches, and the full-pipeline rate
                is the median of its batches (denoise, VAE, uint8, the copy
                to the host), beside the call's total with the npz.
 14. lwd train - LwD / BFM training: (a) K1, K2 and K4 inside their
                autograd Functions at the multi-scale training tiers'
                grids (N 16 and 64, batch 32, XL widths) and K3's at
                BFM-XL's shape (RMSNorm'd q/k, batch 32, N 256), bf16 and
                fp32, at phase 11's gates; (b) one fp32 FiTLwD-XL reflow
                segment update (configs/fitv2_xl_lwd.yaml cut to depth
                LWD_DET_DEPTH as (c)'s run, for phase 18's CAME run,
                batch 4, label drops) on CUDA against the CPU on the same
                weights and draws: the loss, the gradient norm, every
                updated master and first moment within 1e-4 relative L2;
                (c) the main path, cli/train_lwd.py's build_trainer on
                configs/fitv2_xl_lwd.yaml with a merged bf16 YAML (bf16
                compute over fp32 masters, mu and EMA, a constant lr,
                batch 32, the native loader over 128 square synthetic
                shards; the model built on the CPU): cut to depth 12 (12
                segments of 1 block, 12 REPA blocks; phase 18's time), 3
                batches of 3 segment updates with a checkpoint at 2 (the
                one checkpoint the two runs write), then a new trainer
                resumed from it, in a child process with deterministic
                algorithms on: exact launch counts (an update: K1 5, K2 2,
                K4 2), the resumed run's segments, losses, parameters, EMA
                and moments bit-identical; then the rate from a third run
                at the config's depth (0.899 B parameters; determinism
                off, a sync after each batch: the median of 3
                batches after 2), images/s, segment updates/s and peak
                memory; then cli/sample_lwd on that checkpoint; (d) one
                multi-scale update per tier (segments 0, 2, 7: N 16, 64,
                256); (f) a torch.profiler window over one segment update,
                its busy time split into forward, backward, the update
                over every parameter and the rest; (e) configs/bfm.yaml as
                it stands (fp32, batch 32): a reflow update, one finetune
                update per mode (the shared encoder bit-equal after it),
                a distillation update from a seeded FiT teacher of depth 2
                (XL widths, 8 Euler sub-steps), and a reflow update at
                BFM-XL's widths cut to 2 encoder blocks and 6 decoders of
                1 (K3's Function backward on a model path), each with
                exact launch counts.
 15. hr train  - from raw images to a trained HR-XL: (a) the remat policies
                at FiTv2-HR-XL/2's widths (online decoupled NTK RoPE, N
                1024, 1024 and 800 tokens valid) cut to depth 2, fp32: one
                flow loss and backward under none, full, dots, dots_all
                and dots_offload on the card and none on the CPU, every
                gradient within 1e-4 relative L2 of the card's no-remat
                one, dots_offload's bit-identical to dots' with its bytes
                to the host and back those of the saved products, and
                each policy's exact K1/K2/K4 launches (the recompute
                relaunches K1 twice, K2 and K4 once a block); (b)
                cli/prepare_latents' encode_routed (no PIL) with the
                SD-VAE encoder at its real
                widths (seeded): card vs CPU in fp32, then 16 uint8 images
                of mixed sizes routed at 1024 tokens (10 native, 6 larger:
                512 x 512 resize and crop versions) into shards, fp32 and
                bf16, with the bucket counts and the encode rate; (c)
                cli/train on configs/fitv2_hr_xl.yaml as shipped (remat
                dots, depth 36, batch 8 x 1024 tokens, bf16 over fp32
                masters) on (b)'s shards: 8 steps, finite losses, exact
                launches a step (K1 73 + 72, K2 36 + 36, K4 36 + 36), ms a
                step, images/s and peak memory; an InlineEvalHook at step 8
                (EMA -> its copy of the compute model, 24 Euler steps,
                CFG 1.5, batch 4, 512 x 512, phase 5's random VAE decoder and phase 10's
                InceptionV3 against phase 9's npz) writing its preview and
                inline_fid, its launches counted apart; then the same
                trainer under remat dots_offload for 5 steps (the same
                numbers; its bytes to pinned host memory and back a step,
                7,025,412,096; the link's measured rates each way; its
                peak at least 3.5 GB below dots' and its ms a step below
                dots' plus the copies' serial time) and under full for 5;
                (d) an fp32 CAME update at XL width
                (depth 2) card vs CPU, every master and state tensor within
                1e-5 relative L2, then cli/train --came on
                configs/fitv2_xl.yaml (depth 36, batch 32): ms a step and
                peak memory beside phase 11's AdamW; (e) DINOv2-B/14 and
                CLIP-B/16 (seeded) card vs CPU in fp32 and their bf16
                images/s at batch 64.
 16. int8 lwd, buckets, gan - (a) FiTLwD-XL (configs/fitv2_xl_lwd.yaml,
                full width, depth 36, K 12) in bf16 and, on the same
                weights, with gemm_precision='int8': calibrated through
                the model's forward (init_all, every segment's training
                forward) on the CFG batch at each segment's middle t, then
                prequantized; sample_cfg (CFG 1.4, one sub-step a segment,
                batch 8) within 0.1 relative L2 of bf16's, exact launches
                (a CFG eval: K6 9 and K7 3 = 3 and 1 a block, K1 7, K2 3,
                K4 3; calibration launches neither), int8 and bf16
                images/s interleaved; K6 (qkv, proj, fc2) and K7 (fc1) at
                M 4096 against their plain versions; (b) an int8 XL/2
                BucketedSampler over 256 x 256, 320 x 320, 256 x 256 (10
                steps, CFG 1.5, batch 8): the two 256 x 256 runs and a
                sampler of that bucket alone on another model bit-
                identical, the int8 weights quantized once and shared,
                each bucket binding its own scales; (c) the GAN student's
                K1, K2 and K4 Functions at (64, 256, 6 heads of 64),
                unmasked, bf16 and fp32, against autograd of their plain
                versions; one fp32 generator + discriminator step at
                full widths (batch 4) card vs CPU; then
                cli/train_cifar_gan on a synthetic cifar-10-batches-py
                (random uint8 pickles written here: no download), batch
                64, 30 steps, --disc-start 10: finite losses and BN
                statistics, the adversarial terms gated, exact launches
                (a step: K1 14, K2 6, K4 6), ms a step, images/s, peak
                memory.
 17. captures, data parallel - (a) phase 4's XL/2 weights (depth 36,
                fp32) in FiT(save_attention=True), batch 1, one forward:
                every block's (1, 16, 256, 256) map on the card against
                the CPU's (1e-5), exact launches (K1 73, K2 36, K4 36),
                the forward's ms with and without the capture; (b)
                add_rel_pe_to_v at XL width, depth 4, fp32, batch 2 on
                the padded bucket: card vs CPU (1e-5 relative L2), K2
                never launched; (c) bf16 XL/2 256x256, batch 8, 50 steps
                with build_sampler(return_trajectory=True): traj[-1]
                decodes to the latents bit for bit, which equal the
                sampler's without the trajectory; exact launches; (d)
                cli/train.py's path under torchrun, 2 processes on the
                one card over gloo (`--dp-child train DIR`:
                init_distributed, build_trainer on configs/fitv2_xl.yaml
                cut to depth 4, fp32, global batch 32 on phase 11's
                shards, 3 steps, each rank seeded apart), then the same
                run in this process: the first step's reduced gradient
                within 1e-5 relative L2 of one process's, the ranks'
                parameters bit-identical, exact launches a rank, the ms a
                step of each; (e) cli/sample --data-parallel under
                torchrun, 2 processes, XL/2 depth 4 from a seeded
                reference-layout checkpoint, 16 images, 10 steps: each
                rank's batches equal this process's sampler on that
                rank's draws, bit for bit.
 18. model sharding - one torchrun call of SH_WORLD processes (gloo on
                the one card, NCCL with a card each; `--shard-child all
                DIR`) runs, through cli/train.py / cli/train_lwd.py: (a)
                fsdp at FiTv2-3B widths (configs/fitv2_3b.yaml cut to
                depth SH_DEPTH, 2 on one card: depth 4 took the phase
                to 319 s; fp32, global batch SH_BATCH, remat dots);
                (b) tensor (12 heads a rank); (c) sequence at HR-3B
                widths (configs/fitv2_hr_3b.yaml, N 1024, depth
                SH_HR_DEPTH); (d) stage with pp_microbatches 4; (e) the
                LwDTrainer under fsdp at BFM-XL widths (K3, one segment
                update); (g) cli/train.py --came under tensor (fp32, 2
                steps from the seeded weights, weight decay 0), with an
                InlineEvalHook at step 2 (batch 2, 4 Euler steps, CFG
                1.5, no VAE; sampling Trainer.one_process_model from the
                gathered EMA, each rank under its own folder); then (f)
                an fsdp run in bf16 interrupted and
                resumed against its uninterrupted twin, whose steps 2-3
                give (a)'s bf16 rate. This process runs (a)-(e) and (g)
                alone first ((a), (b) and (d) share one run). (g) holds
                the sharded run's parameters and its checkpoint's CAME
                state (the one-process layout) against one process's
                after 2 steps, and its preview against a one-process
                hook's on that checkpoint's EMA, each within
                TOL_SHARD_CAME relative L2, process 0 alone writing it;
                its hook's launches are counted apart. The models'
                all-zero parameters start random from one seed: at the
                zero init the first gradient lies in the final layer's
                linear alone, which the tensor and stage ranks compute
                on the whole batch. Each sharded run's first reduced
                gradient within 1e-5 relative L2 of one process's
                (fp32), whole and in the trunk's blocks alone (a nonzero
                share of its norm), the ranks agree on a checksum of
                the gathered parameters, exact K1-K4 launches a rank at
                the local shapes, each rank's peak memory and parameter
                + state bytes against one process's (fsdp <= 0.55), ms a
                step; the resume bit-identical; which path (device, or
                the host under gloo) each collective took. (0): K1, K2,
                K4 and K3 in their Functions at the per-rank shapes
                against autograd of their plain versions.
The deterministic trainer runs of 11 (c) and 12 (d) (one child process)
and of 14 (c) (another) run in child processes of this script (`--child
NAMES DIR`) with
CUBLAS_WORKSPACE_CONFIG=:4096:8, which deterministic algorithms require
and which cuBLAS reads once when it starts: set for the whole process, it
made every sampler step's host side 2.0-2.4x slower. Everything else runs
here without it.
Each path's counts are set to 0 just before it runs and read just after.
The line before the last is the JSON list of kernels (K1-K5 with their
Functions' forward and backward times and gradient errors; K2's RoPE-only
case; each path's launches, K3's apart where K4 was counted; phase 13's
cases with their `path`, phase 14's and phase 16's Function cases in
`train_cases` with theirs, phase 16's K6 / K7 sites in `sites`); each
phase group prints its seconds ([time]);
the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

SEED = 0
BATCH = 8            # images per sampler call
STEPS = 250
CFG_SCALE = 1.5
N, D, H, DH = 256, 1152, 16, 72
N_VALID = 200        # padded bucket: 200 of 256 tokens valid (160x320 px)
REPS = 20

# tolerances (kernel vs its plain version on the same card)
TOL_FP32_REL = 1e-5  # max |kernel - plain| / max |plain|: fp32 sums in
                     # another order
TOL_BF16_ULPS = 2    # K1/K2 in bf16: within 2 bf16 ulps of the output's
                     # largest magnitude (one rounding of an fp32 value that
                     # differs in the last bits may flip)
TOL_BF16_ATTN = 2e-2 # attention in bf16, absolute: the kernels round p to
                     # bf16 before p @ v, as the TPU kernels do; the plain
                     # versions keep it in fp32
TOL_SLICE_REL_L2 = 1e-4  # phase 4, velocity relative L2, fp32
# K6 (fp32 and bf16 out) must equal its plain version bit for bit: the s32
# accumulator is exact and both sides run the same unfused f32 epilogue
# (multiply, then add, then one rounding to the output dtype)
TOL_SWIGLU_FLIPS = 1e-3   # K7: share of s8 outputs off by one level (a
                          # rounding tie flipped by a 1-ulp sigmoid)
MIN_INT8_COSINE = 0.99    # phase 6: int8 vs bf16 velocity (the JAX
                          # package's own bound, tests/test_quant.py)
MAX_FUSED_REL_L2 = 0.1    # phase 8: fused vs unfused velocity in bf16; the
                          # two round p at different points in 36 blocks,
                          # a wiring fault gives O(1)
GUIDANCE = (0.3, 0.9)     # phase 7, as bench.py's serving-max mode
# the H100 SXM's published peaks (dense), for each kernel's bound
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {'bf16': 989e12, 'int8': 1979e12, 'fp32': 67e12}
EVAL_EVERY, EXTRAP_ORDER = 2, 2
PADDED_HW = (160, 320)    # phase 8: 10 x 20 = 200 of 256 tokens
COLD_BYTES = 128 << 20    # flushed before each cold call: 2.7x the 50 MB L2

XL = dict(context_size=256, patch_size=2, in_channels=4, hidden_size=1152,
          depth=36, num_heads=16, mlp_ratio=4.0, class_dropout_prob=0.1,
          num_classes=1000, learn_sigma=False, use_sit=True, use_swiglu=True,
          q_norm='layernorm', k_norm='layernorm', qk_norm_weight=False,
          rel_pos_embed='rope', adaln_type='lora', adaln_lora_dim=288)
# FiTv2-HR-XL/2 (configs/fitv2_hr_xl.yaml): XL's parameters, a 1024-token
# context and online decoupled NTK RoPE trained at a 16 x 16 grid
HR_XL = dict(XL, context_size=1024, online_rope=True, custom_freqs='ntk-aware',
             decouple=True, ori_max_pe_len=16, max_cached_len=1024)
HR_BATCH = 4
HR_N = 1024
HR_BUCKETS = ((512, 512), (320, 640))  # 1024 and 800 of 1024 tokens
EXTRAP_HW = (320, 320)  # XL/2 (16 x 16) at 20 x 20 through BucketedSampler
TOL_INCEPTION_REL = 1e-4  # phase 10: card vs CPU, fp32 without TF32, of the
                          # largest magnitude (cuDNN sums in another order)
EVAL_IMAGES, EVAL_BATCH = 512, 64
# phase 11 (training): configs/fitv2_xl.yaml's per-host batch; steps, the
# checkpoint the second trainer resumes from; synthetic shards; the depth of
# the CUDA-vs-CPU gradient check; an untrained FiT outputs 0, so the first
# loss is E|x1 - x0|^2 = 2 per valid element, within sampling noise
TRAIN_BATCH = 32
TRAIN_STEPS, TRAIN_RESUME = 30, 20
TRAIN_RESUME_DEPTH = 6  # the deterministic resume runs' depth (the rate's
                        # run keeps the config's 36)
TRAIN_TIMED = 8  # the rate's window: steps TRAIN_TIMED + 1 to 2 TRAIN_TIMED
TRAIN_SHARDS = 512
TRAIN_PARITY_DEPTH = 4
TRAIN_FIRST_LOSS = (1.9, 2.1)
TOL_GRAD_BF16 = 3e-2  # a Function's bf16 gradients vs autograd of the plain
                      # version, of the largest |grad|: that autograd rounds
                      # its bf16 intermediates (K2's RoPE products, K5's p),
                      # the backward functions keep fp32 to the end
# phase 12 (FiTv1-XL/2, configs/fit_xl.yaml): the respaced ladder's index
# of the parity step (mid-ladder of STEPS); the trainer's steps and the
# checkpoint the second run resumes from; an untrained FiT outputs 0, so
# the first eps-MSE is E[eps^2] = 1 per valid element (batch 32 of padded
# grids: its standard deviation is ~0.013)
V1_CONFIG = 'configs/fit_xl.yaml'
V1_PARITY_INDEX = STEPS // 2
V1_TRAIN_STEPS, V1_TRAIN_RESUME = 10, 6
V1_TRAIN_DEPTH = 4  # the ddpm trainer's depth in the smoke (the config: 28)
V1_FIRST_MSE = (0.9, 1.1)
V1_RATE_CALLS = 2  # timed 250-step denoise calls a mode (the host's spread;
                   # 2, not 3, for phase 18's time)
# phase 13 (the LwD family): FiTLwD-XL (K 12 segments of 3 blocks) and
# BFM-XL (a 20-block shared encoder, K 6 decoders of 5 blocks); sub-steps a
# segment such that each path makes 252 velocity evals, the main path's 250
# steps rounded up to a multiple of K; cli/sample_lwd's default CFG scale
LWD_CONFIG = 'configs/fitv2_xl_lwd.yaml'
BFM_XL_CONFIG = 'configs/bfm_xl.yaml'
LWD_STEPS_PER_FLOW, BFM_STEPS_PER_FLOW = 21, 42
LWD_CFG_SCALE = 1.4
# BFM-XL's depth in the smoke: 8 encoder blocks and 6 decoders of 2 (the
# config: 20 and 6 of 5), at its widths
BFM_XL_CUT = dict(depth=12, number_of_representation_blocks=8)
# phase 14 (LwD training): the multi-scale tiers' grids (N) whose Functions
# are checked; the CUDA-vs-CPU update's batch; the main path's square
# shards, batches (3 segment updates each), the checkpoint the resumed run
# starts from, the timed run's warm-up and timed batches; the multi-scale
# tiers' boundaries and a segment of each; the distillation teacher's
# depth (XL widths) and Euler sub-steps
LWD_TRAIN_GRIDS = (16, 64)
LWD_PARITY_BATCH = 4
LWD_SHARDS = 128
LWD_TRAIN_BATCHES, LWD_TRAIN_RESUME = 3, 2
LWD_DET_DEPTH = 12  # the deterministic resume run's trunk (the config: 36)
LWD_TRAIN_WARM, LWD_TRAIN_TIMED = 2, 3
LWD_MS_INDICES, LWD_MS_SEGMENTS = (2, 7), (0, 2, 7)
LWD_TEACHER_DEPTH, LWD_SOLVER_STEPS = 2, 8
LWD_TRAIN_REPS = 5  # timed calls a side of each (a) case (each behind a
                    # 25 ms device sleep)
# phase 15 (raw images to a trained HR-XL): (a) the remat policies' depth
# and token grids (1024 and 800 of HR_N valid); (b) the images routed by
# prepare_latents at the HR config's target length, (w, h) native sizes:
# PREP_SMALL fit it (multiples of 16 px), the rest are larger (their resize
# and crop arrays 512 x 512); (c) the HR-XL trainer's steps, the steps
# before the timed median, the inline eval's Euler steps and batch; (d)
# CAME's card-vs-CPU depth and updates (fp32: the same elementwise math in
# another order, 1e-5); (e) the teachers' timed batch
SAC_DEPTH = 2
SAC_GRIDS = ((32, 32), (20, 40))
PREP_TARGET_LEN = 1024
PREP_SIZES = ((512, 512), (512, 384), (384, 512), (640, 320), (320, 640),
              (256, 256), (496, 512), (352, 464), (1024, 256), (272, 368),
              (1024, 768), (768, 1024), (800, 800), (1280, 720),
              (2048, 1536), (600, 1200))
PREP_SMALL = 10
PREP_LARGE_HW = 512  # the side of a larger image's resize and crop arrays
HR_TRAIN_STEPS, HR_TRAIN_WARM = 8, 3
# phase 15 (c)'s trainer under dots_offload, then full: steps, and the
# untimed first ones (the first dots_offload step pins the host buffers)
HR_MORE_STEPS, HR_MORE_WARM = 5, 2
OFFLOAD_PEAK_DROP = 3.5e9  # bytes: half of the saved products a step
LINK_BYTES, LINK_REPS = 1 << 30, 5  # the link's rate: copies of 1 GiB
HOOK_STEPS, HOOK_BATCH = 24, 4
CAME_PARITY_DEPTH, CAME_PARITY_STEPS = 2, 2
TOL_CAME_REL = 1e-5
TEACHER_BATCH = 64


# phase 16 (int8 LwD serving, per-bucket int8, GAN-guided LwD training):
# (a) FiTLwD-XL int8: the sub-steps a segment of the held and timed
# sample_cfg calls, the timed calls a side, the relative L2 bound against
# bf16 (tests/test_lwd_overfit_e2e.py's drift bound), SwiGLU's hidden width
INT8_LWD_STEPS_PER_FLOW, INT8_LWD_RATE_CALLS = 1, 3
MAX_INT8_LWD_REL_L2 = 0.1
LWD_MLP_H = 3072
# (b) the int8 buckets (A, B) and the sampler's steps
INT8_BUCKETS = ((256, 256), (320, 320))
INT8_BUCKET_STEPS = 10
# (c) cli/train_cifar_gan: batch, steps, --disc-start, the steps before the
# timed median; the card-vs-CPU step's batch and bound; the student's
# widths (hidden 384, 6 heads of 64, 16 x 16 tokens)
GAN_BATCH, GAN_STEPS, GAN_DISC_START, GAN_WARM = 64, 30, 10, 5
GAN_PARITY_BATCH, TOL_GAN_REL = 4, 1e-4
GAN_D, GAN_H, GAN_DH, GAN_N = 384, 6, 64, 256


def say(*args):
    print(*args, flush=True)


@contextlib.contextmanager
def _clock(label):
    """Prints the seconds the block took."""
    t0 = time.perf_counter()
    yield
    say(f'[time] {label}: {time.perf_counter() - t0:.1f} s')


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device; this smoke needs an '
                         'H100')
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f'chip_smoke: need compute capability 9.0 (Hopper),'
                         f' got {cap}')
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f'[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}'
        f' cuda {torch.version.cuda}')
    say(f'[device] nvidia-smi name, power.limit: {card}')
    return card


# kernel families whose ptxas registers and spills the build phase prints:
# (label, pattern over the mangled name, the instantiation's description)
PTXAS_FAMILIES = (
    ('K1 adaln_kernel_vec', r'adaln_kernel_vecI(13__nv_bfloat16|f)Li(\d+)E',
     lambda m: f'{_ptx_dtype(m[1])} D {128 * int(m[2])}'),
    ('K2 qk_rope_kernel_vec', r'qk_rope_kernel_vecI(13__nv_bfloat16|f)Li(\d+)E',
     lambda m: f'{_ptx_dtype(m[1])} Dh {m[2]}'),
    ('K3/K4 attention_mma_kernel (bf16)',
     r'(?<!fused_)attention_mma_kernelILi(\d+)ELb([01])ELb([01])E',
     lambda m: f'Dh {m[1]} {"bounded" if m[2] == "1" else "online"} '
               f'{"mask" if m[3] == "1" else "no mask"}'),
    ('K5 fused_attention_mma_kernel (bf16)',
     r'fused_attention_mma_kernelILi(\d+)ELb([01])E',
     lambda m: f'Dh {m[1]} {"mask" if m[2] == "1" else "no mask"}'),
    ('K6 int8_gemm_wgmma_kernel', r'int8_gemm_wgmma_kernelI(13__nv_bfloat16|f)E',
     lambda m: f'{_ptx_dtype(m[1])} out'),
    ('K7 int8_gemm_swiglu_kernel', r'int8_gemm_swiglu_kernel',
     lambda m: 's8 out'),
)


def _ptx_dtype(code):
    return 'fp32' if code == 'f' else 'bf16'


def _ptxas_entries(report):
    """(mangled name, registers, spill stores/loads in bytes) of every
    kernel in nvcc's -Xptxas -v report."""
    lines = report.splitlines()
    for i, ln in enumerate(lines):
        if 'Compiling entry' not in ln:
            continue
        name = ln.split("'")[1] if "'" in ln else ln.strip()
        used = next((u for u in lines[i + 1:i + 4] if 'Used' in u), '')
        spill = next((u for u in lines[i + 1:i + 4] if 'spill' in u), '')
        regs = re.search(r'Used (\d+) registers', used)
        spills = re.findall(r'(\d+) bytes spill', spill)
        yield name, regs[1] if regs else '?', '/'.join(spills) or '?'


def phase_build():
    """Build the kernel library; returns the seconds and, by kernel family
    (PTXAS_FAMILIES), each instantiation's ptxas registers and spills."""
    from fitv2_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    path, report = _build.build()
    secs = time.perf_counter() - t0
    _build.library()
    (path.parent / 'ptxas.txt').write_text(report)
    say(f'[build] nvcc {len(_build.sources())} sources -> {path} in '
        f'{secs:.3f} s{" (already built)" if not report else ""}; '
        f'ptxas report {path.parent / "ptxas.txt"}')
    families = {label: [] for label, _, _ in PTXAS_FAMILIES}
    for name, regs, spills in _ptxas_entries(report):
        if spills not in ('0/0', '?'):
            say(f'[build] ptxas spills in {name}: {spills} bytes '
                '(stores/loads)')
        for label, pattern, describe in PTXAS_FAMILIES:
            m = re.search(pattern, name)
            if m:
                families[label].append(
                    f'{describe(m)}: {regs} registers, spill {spills} B')
                break
    for label, found in families.items():  # spill: stores/loads
        if found:
            say(f'[build] ptxas {label} (+ dynamic shared memory, set at '
                f'launch): {"; ".join(found)}')
    return secs, families


def _time_ms(fn, reps=REPS, flush=None):
    """Median device time of one call (CUDA events), after two warmups.

    Each timed call is enqueued behind a ~25 ms device sleep, so the host's
    launch overhead (Python, ctypes, allocation) is hidden and the events
    bracket device time only; the inputs stay L2-warm, as in the model.
    `flush` enqueues work after the sleep and before the start event, so
    that the call reads its inputs from device memory, not from the 50 MB
    L2: 'write', a COLD_BYTES write to a scratch buffer (which leaves the
    L2 full of dirty lines, so the call also pays their write-back as its
    own lines evict them); 'clean', that write and then a COLD_BYTES read
    of a second buffer (the L2 then holds clean lines, and the call's
    device memory traffic is its own)."""
    import torch
    if flush:
        scratch = torch.empty(COLD_BYTES, dtype=torch.uint8, device='cuda')
    if flush == 'clean':
        ones = torch.ones(COLD_BYTES // 4, device='cuda')
        total = torch.empty((), device='cuda')
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)  # cycles: ~25 ms at 1.98 GHz
        if flush:
            scratch.fill_(1)
        if flush == 'clean':
            torch.sum(ones, 0, out=total)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _bound_ms(nbytes, ops, kind):
    """The least time the card could take: bytes over the memory rate or
    operations over the peak of their type, the larger; and which."""
    by_bytes = nbytes / PEAK_BYTES_S * 1e3
    by_ops = ops / PEAK_OPS_S[kind] * 1e3
    return (by_bytes, 'bytes') if by_bytes >= by_ops else (by_ops,
                                                           'operations')


def _bf16_ulp_err(out, ref):
    """max |out - ref| in bf16 ulps of max |ref|."""
    import math
    scale = ref.float().abs().max().item()
    ulp = 2.0 ** (math.floor(math.log2(scale)) - 7)
    return (out.float() - ref.float()).abs().max().item() / ulp


def _compare(name, dtype, out, ref, kind):
    """Check a kernel output against its plain version; returns max abs."""
    import torch
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    worst_abs = 0.0
    for o, r in zip(outs, refs):
        if not torch.isfinite(o).all():
            raise AssertionError(f'{name} {dtype}: non-finite kernel output')
        abs_err = (o.float() - r.float()).abs().max().item()
        worst_abs = max(worst_abs, abs_err)
        if dtype == torch.float32:
            rel = abs_err / r.float().abs().max().item()
            ok, msg = rel <= TOL_FP32_REL, f'rel {rel:.3e} <= {TOL_FP32_REL}'
        elif kind == 'attention':
            ok, msg = abs_err <= TOL_BF16_ATTN, \
                f'abs {abs_err:.3e} <= {TOL_BF16_ATTN}'
        else:
            ulps = _bf16_ulp_err(o, r)
            ok, msg = ulps <= TOL_BF16_ULPS, \
                f'{ulps:.2f} bf16 ulps <= {TOL_BF16_ULPS}'
        say(f'[kernels] {name} {str(dtype)[6:]}: max abs {abs_err:.3e}, '
            f'{msg}: {"ok" if ok else "FAIL"}')
        if not ok:
            raise AssertionError(f'{name} {dtype}: {msg} violated')
    return worst_abs


def _k6_site(K, dev, gen, site, m, k, n, dtype):
    """K6 at one (M, K) x (N, K) site against its plain version: bit for
    bit, then both median times and the bound."""
    import torch
    xq = torch.randint(-127, 128, (m, k), device=dev, dtype=torch.int8,
                       generator=gen)
    wq = torch.randint(-127, 128, (n, k), device=dev, dtype=torch.int8,
                       generator=gen)
    scale = torch.rand(n, device=dev, generator=gen) * 1e-4 + 1e-5
    bias = torch.randn(n, device=dev, generator=gen)
    out = K.int8_gemm_bias(xq, wq, scale, bias, dtype)
    ref = K.int8_gemm_bias_reference(xq, wq, scale, bias, dtype)
    err = (out.float() - ref.float()).abs().max().item()
    ok = torch.equal(out, ref) and bool(torch.isfinite(out).all())
    label = f'int8_gemm_bias[{site}, M {m}] {str(dtype)[6:]}'
    say(f'[kernels] {label}: max abs {err:.3e}, bit for bit: '
        f'{"ok" if ok else "FAIL"}')
    if not ok:
        raise AssertionError(f'{label}: differs from its plain version')
    ms = _time_ms(lambda: K.int8_gemm_bias(xq, wq, scale, bias, dtype))
    pms = _time_ms(lambda: K.int8_gemm_bias_reference(xq, wq, scale, bias,
                                                      dtype))
    top_s = 2 * m * k * n / ms / 1e9
    # s8 operands, f32 scale and bias, the output in `dtype`
    bound, by = _bound_ms(m * k + n * k + 8 * n + m * n * out.element_size(),
                          2 * m * k * n, 'int8')
    say(f'[kernels] {label} ({m},{k})x({n},{k}): kernel {ms * 1e3:.1f} us, '
        f'plain {pms * 1e3:.1f} us ({top_s:.1f} TOP/s), bound '
        f'{bound * 1e3:.1f} us ({by})')
    return dict(site=site, shape=[m, k, n], dtype=str(dtype)[6:],
                max_abs_err=err, us=ms * 1e3, plain_us=pms * 1e3,
                top_s=top_s, bound_us=bound * 1e3, bound_by=by)


def _norm_case(label, dtype, kernel, plain, nbytes, ops, time_plain):
    """K1 or K2 on one set of inputs: against its plain version, then the
    kernel's median time L2-warm, L2-cold (the time the bound is held to)
    and after a write alone (dirty; see _time_ms), the plain version's
    (unless not `time_plain`) and the bound."""
    import torch
    err = _compare(label, dtype, kernel(), plain(), 'norm')
    ms = _time_ms(kernel)
    cold = _time_ms(kernel, flush='clean')
    dirty = _time_ms(kernel, flush='write')
    pms = _time_ms(plain) if time_plain else None
    kind = 'bf16' if dtype == torch.bfloat16 else 'fp32'
    bound, by = _bound_ms(nbytes, ops, 'fp32')
    plain_say = f'plain {pms * 1e3:.1f} us, ' if time_plain else ''
    say(f'[kernels] {label} {kind}: kernel {ms * 1e3:.1f} us warm, '
        f'{cold * 1e3:.1f} us cold, {dirty * 1e3:.1f} us dirty, {plain_say}'
        f'bound {bound * 1e3:.1f} us ({by}; cold at {bound / cold:.0%} of '
        'it)')
    return dict(dtype=kind, max_abs_err=err, us=ms * 1e3,
                cold_us=cold * 1e3, dirty_us=dirty * 1e3,
                plain_us=pms * 1e3 if time_plain else None,
                bound_us=bound * 1e3, bound_by=by)


def _adaln_case(K, x, shift, scale, time_plain=True):
    """K1 at x (B, N, D) with shift/scale (B, D) rows; see _norm_case."""
    (b, n, d), es = x.shape, x.element_size()
    case = _norm_case(
        f'adaln ({b},{n},{d})', x.dtype,
        lambda: K.fused_adaln_norm(x, shift, scale),
        lambda: K.adaln_norm_reference(x, shift, scale),
        # x in, out, shift and scale; ~8 fp32 operations an element
        (2 * x.numel() + 2 * b * d) * es, 8 * x.numel(), time_plain)
    return dict(shape=[b, n, d], **case)


def _qk_rope_case(K, q, k, cos, sin, time_plain=True, norm=True):
    """K2 at q, k (B, N, H, Dh) with (B, N, Dh) fp32 tables, with the q/k
    LayerNorm or (norm False, FiTv1's mode) the rotation alone; see
    _norm_case."""
    b, n, h, dh = q.shape
    label = 'qk_rope' if norm else 'qk_rope RoPE-only'
    case = _norm_case(
        f'{label} ({b},{n},{h},{dh})', q.dtype,
        lambda: K.fused_qk_rope(q, k, cos, sin, norm_q=norm, norm_k=norm),
        lambda: K.qk_norm_rope_reference(q, k, cos, sin, norm_q=norm,
                                         norm_k=norm),
        # q and k in and out, the fp32 cos/sin tables; ~10 fp32
        # operations an element with the LayerNorm, 3 for the rotation
        4 * q.numel() * q.element_size() + 2 * cos.numel() * 4,
        (20 if norm else 6) * q.numel(), time_plain)
    return dict(shape=[b, n, h, dh], mode='ln_rope' if norm else 'rope_only',
                **case)


def _attention_case(K, dtype, q, k, v, mask, bounded, time_plain=True):
    """One variant/mask case of the attention kernel: against its plain
    version, then kernel, plain (unless not `time_plain`) and
    scaled_dot_product_attention times (the last on (B, H, N, Dh) views with
    a boolean (B, 1, 1, N) key mask, checked against the plain version
    first) beside the bound. The mask's valid keys come first."""
    import torch
    import torch.nn.functional as F
    plain = K.attention_bounded_reference if bounded else K.attention_reference
    variant = 'bounded' if bounded else 'online'
    n_valid = q.shape[1] if mask is None else int((mask[0] > 0).sum())
    masked = (f'mask {n_valid}/{q.shape[1]}' if mask is not None
              else 'no mask')
    label = f'attention[{variant},{masked}]'
    out = K.flash_masked_attention(q, k, v, mask, bounded)
    ref = plain(q, k, v, mask)
    err = _compare(label, dtype, out, ref, 'attention')  # padded rows too
    attn_mask = None if mask is None else (mask > 0)[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=attn_mask)
    lib_err = _compare(label + ' scaled_dot_product_attention', dtype,
                       library().transpose(1, 2), ref, 'attention')
    ms = _time_ms(lambda: K.flash_masked_attention(q, k, v, mask, bounded))
    pms = _time_ms(lambda: plain(q, k, v, mask)) if time_plain else None
    lms = _time_ms(library)
    b, n, h, dh = q.shape
    nbytes = 4 * q.numel() * q.element_size() + (
        0 if mask is None else mask.numel() * mask.element_size())
    kind = 'bf16' if dtype == torch.bfloat16 else 'fp32'
    # Q K^T and P V over each row's valid keys: a masked key adds nothing
    keys = b * n if mask is None else int((mask > 0).sum())
    bound, by = _bound_ms(nbytes, 4 * h * n * keys * dh, kind)
    plain_max = ref.float().abs().max().item()
    plain_say = f'plain {pms * 1e3:.1f} us, ' if time_plain else ''
    say(f'[kernels] {label} {kind} ({b},{n},{h},{dh}): kernel '
        f'{ms * 1e3:.1f} us, {plain_say}'
        f'scaled_dot_product_attention {lms * 1e3:.1f} us, bound '
        f'{bound * 1e3:.1f} us ({by}); max abs err {err:.3e} of max '
        f'|plain| {plain_max:.3e}')
    return dict(variant=variant, mask=mask is not None, dtype=kind,
                max_abs_err=err, plain_max_abs=plain_max, us=ms * 1e3,
                plain_us=pms * 1e3 if time_plain else None,
                library_us=lms * 1e3, library_max_abs_err=lib_err,
                bound_us=bound * 1e3, bound_by=by)


def _fused_attention_case(K, qkv, cos, sin, mask, h):
    """K5 on the flat (B, N, 3C) qkv: against its plain version (padded
    query rows exactly 0), then the kernel's, the plain version's and the
    unfused pair's median times beside the bound.
    The pair is what the unfused path runs on the same qkv: K2 (q/k
    LayerNorm + RoPE) and K4 (bounded attention), then the padded query
    rows zeroed, as the fused wrapper zeroes them; it is checked against
    the same plain version first."""
    import torch
    b, n, c3 = qkv.shape
    c = c3 // 3
    dh = c // h
    dtype = qkv.dtype
    n_valid = n if mask is None else int((mask[0] > 0).sum())
    masked = f'mask {n_valid}/{n}' if mask is not None else 'no mask'
    label = f'fused_attention[{masked}, Dh {dh}]'
    out = K.fused_qkln_rope_attention(qkv, cos, sin, mask, h)
    ref = K.fused_qkln_rope_attention_reference(qkv, cos, sin, mask, h)
    err = _compare(label, dtype, out, ref, 'attention')
    if mask is not None and not (out[mask == 0] == 0).all():
        raise AssertionError(f'{label}: padded query rows not 0')
    q, k, v = qkv.view(b, n, 3, h, dh).unbind(2)

    def pair():
        qn, kn = K.fused_qk_rope(q, k, cos, sin)
        o = K.flash_masked_attention(qn, kn, v, mask, True).reshape(b, n, c)
        return o if mask is None else o * mask.to(o.dtype)[..., None]
    _compare(label + ' unfused K2 + K4', dtype, pair(), ref, 'attention')
    ms = _time_ms(lambda: K.fused_qkln_rope_attention(qkv, cos, sin, mask,
                                                      h))
    pms = _time_ms(lambda: K.fused_qkln_rope_attention_reference(
        qkv, cos, sin, mask, h))
    pair_ms = _time_ms(pair)
    kind = 'bf16' if dtype == torch.bfloat16 else 'fp32'
    # qkv in, out, the fp32 cos/sin tables, the mask; Q K^T and P V for
    # each row's valid queries over its valid keys (padded query rows are 0)
    pairs = (b * n * n if mask is None
             else int(((mask > 0).sum(1).double() ** 2).sum()))
    bound, by = _bound_ms(
        (qkv.numel() + out.numel()) * qkv.element_size() + 2 * cos.numel() * 4
        + (0 if mask is None else mask.numel() * 4),
        4 * h * pairs * dh, kind)
    say(f'[kernels] {label} {kind} ({b},{n},{c3}): kernel {ms * 1e3:.1f} us,'
        f' plain {pms * 1e3:.1f} us, unfused K2 + K4 {pair_ms * 1e3:.1f} us, '
        f'bound {bound * 1e3:.1f} us ({by})')
    return dict(shape=[b, n, c3], heads=h, mask=mask is not None, dtype=kind,
                max_abs_err=err, us=ms * 1e3, plain_us=pms * 1e3,
                unfused_pair_us=pair_ms * 1e3, bound_us=bound * 1e3,
                bound_by=by)


def _k7_site(K, dev, gen, m, k, h):
    """K7 (SwiGLU fc1 + requantization) at (M, K) x (2H, K) against its
    plain version (at most one level off, on at most TOL_SWIGLU_FLIPS of
    the s8 outputs), then both median times and the bound."""
    import torch
    xq = torch.randint(-127, 128, (m, k), device=dev, dtype=torch.int8,
                       generator=gen)
    wq = torch.randint(-127, 128, (2 * h, k), device=dev, dtype=torch.int8,
                       generator=gen)
    scale = torch.rand(2 * h, device=dev, generator=gen) * 3e-5 + 1e-6
    bias = 0.1 * torch.randn(2 * h, device=dev, generator=gen)
    osr = 20.0
    out = K.int8_gemm_swiglu_quant(xq, wq, scale, bias, osr)
    ref = K.int8_gemm_swiglu_quant_reference(xq, wq, scale, bias, osr)
    diff = (out.int() - ref.int()).abs()
    flips = (diff > 0).float().mean().item()
    nonzero = (ref != 0).float().mean().item()
    ok = diff.max().item() <= 1 and flips <= TOL_SWIGLU_FLIPS and nonzero > 0.5
    label = f'int8_gemm_swiglu_quant[fc1, M {m}]'
    say(f'[kernels] {label}: max |diff| {diff.max().item()} level, '
        f'{flips:.2e} of outputs differ <= {TOL_SWIGLU_FLIPS} '
        f'({nonzero:.2f} nonzero): {"ok" if ok else "FAIL"}')
    if not ok:
        raise AssertionError(f'{label} disagrees with its plain version')
    ms = _time_ms(lambda: K.int8_gemm_swiglu_quant(xq, wq, scale, bias, osr))
    pms = _time_ms(lambda: K.int8_gemm_swiglu_quant_reference(
        xq, wq, scale, bias, osr))
    top_s = 2 * m * k * 2 * h / ms / 1e9
    # s8 operands, f32 scale and bias, the s8 output
    bound, by = _bound_ms(xq.numel() + wq.numel() + 16 * h + out.numel(),
                          2 * m * k * 2 * h, 'int8')
    say(f'[kernels] {label} ({m},{k})x({2 * h},{k}): kernel {ms * 1e3:.1f} '
        f'us, plain {pms * 1e3:.1f} us ({top_s:.1f} TOP/s), bound '
        f'{bound * 1e3:.1f} us ({by})')
    return dict(site='fc1', shape=[m, k, 2 * h], max_abs_err=float(
        diff.max().item()), flips=flips, us=ms * 1e3, plain_us=pms * 1e3,
                top_s=top_s, bound_us=bound * 1e3, bound_by=by)


def phase_kernels():
    """Each kernel against its plain version at the slice's shapes."""
    import torch
    from fitv2_tpu_torch import kernels as K
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(SEED)
    b2 = 2 * BATCH
    results = {}
    k6_sites = []
    attention_cases = []
    fused_cases = []
    norm_cases = {'adaln': [], 'qk_rope': []}

    for dtype in (torch.bfloat16, torch.float32):
        # a large common offset, as the residual stream carries
        x = (torch.randn(b2, N, D, device=dev, generator=gen) * 2 + 3
             ).to(dtype)
        mod = (0.5 * torch.randn(b2, 6 * D, device=dev, generator=gen)
               ).to(dtype)
        shift, scale = mod.chunk(6, dim=-1)[:2]  # strided, as in a block
        norm_cases['adaln'].append(_adaln_case(K, x, shift, scale))

        qkv = torch.randn(b2, N, 3, H, DH, device=dev, generator=gen
                          ).to(dtype)
        q, k, v = qkv.unbind(2)  # token stride 3C, as in a block
        ang = torch.rand(b2, N, DH, device=dev, generator=gen) * 6.3
        cos, sin = torch.cos(ang), torch.sin(ang)
        norm_cases['qk_rope'].append(_qk_rope_case(K, q, k, cos, sin))

        # attention inputs: LayerNormed q/k (the bounded-logit contract)
        qn, kn = K.qk_norm_rope_reference(q, k, cos, sin)
        mask = torch.zeros(b2, N, device=dev)
        mask[:, :N_VALID] = 1.0
        for bounded in (True, False):
            for m in (None, mask):
                attention_cases.append(dict(
                    _attention_case(K, dtype, qn, kn, v, m, bounded),
                    shape=[b2, N, H, DH]))

        # K5 on the flat qkv projection, as the fused path runs it
        qkv_flat = qkv.reshape(b2, N, 3 * D)
        for m in (mask, None):
            fused_cases.append(_fused_attention_case(K, qkv_flat, cos, sin,
                                                     m, H))

        # K6 at the int8 path's three GEMM sites, out in this dtype, for
        # the CFG batch (M = 4096) and the conditional-only one (2048)
        for m_rows in (b2 * N, BATCH * N):
            for site, k, n in (('qkv', D, 3 * D), ('proj', D, D),
                               ('fc2', 3072, D)):
                k6_sites.append(_k6_site(K, dev, gen, site, m_rows, k, n,
                                         dtype))
        torch.cuda.synchronize()

    # Dh 32 (configs/fitv2_small_cifar.yaml: hidden 128, 4 heads, 64
    # tokens), bf16, 48 of 64 tokens valid (a 6 x 8 bucket): K4 and K5
    n32, h32, dh32 = 64, 4, 32
    qkv32 = torch.randn(b2, n32, 3, h32, dh32, device=dev, generator=gen
                        ).to(torch.bfloat16)
    ang32 = torch.rand(b2, n32, dh32, device=dev, generator=gen) * 6.3
    cos32, sin32 = torch.cos(ang32), torch.sin(ang32)
    mask32 = torch.zeros(b2, n32, device=dev)
    mask32[:, :48] = 1.0
    q32, k32, v32 = qkv32.unbind(2)
    qn32, kn32 = K.qk_norm_rope_reference(q32, k32, cos32, sin32)
    case = _attention_case(K, torch.bfloat16, qn32, kn32, v32, mask32, True)
    attention_cases.append(dict(case, shape=[b2, n32, h32, dh32]))
    fused_cases.append(_fused_attention_case(
        K, qkv32.reshape(b2, n32, 3 * h32 * dh32), cos32, sin32, mask32,
        h32))

    # K7 (its output is int8 whatever the model dtype), for the CFG batch
    # and the conditional-only one
    k7_sites = [_k7_site(K, dev, gen, m_rows, D, 3072)
                for m_rows in (b2 * N, BATCH * N)]
    torch.cuda.synchronize()
    for name, cases in norm_cases.items():
        xl = cases[0]  # bf16: the top-level numbers; the bound against cold
        results[name] = dict(
            max_abs_err=max(c['max_abs_err'] for c in cases),
            ms=xl['us'] / 1e3, cold_ms=xl['cold_us'] / 1e3,
            plain_ms=xl['plain_us'] / 1e3, bound_ms=xl['bound_us'] / 1e3,
            bound_by=xl['bound_by'], library_ms=None, cases=cases)
    main_site = k6_sites[0]  # qkv, M = 4096, bf16: the top-level numbers
    results['int8_gemm_bias'] = dict(
        max_abs_err=max(st['max_abs_err'] for st in k6_sites),
        ms=main_site['us'] / 1e3, plain_ms=main_site['plain_us'] / 1e3,
        bound_ms=main_site['bound_us'] / 1e3, bound_by=main_site['bound_by'],
        library_ms=None, sites=k6_sites)
    xl = fused_cases[0]  # bf16, 200/256 valid: the fused path's variant
    results['fused_attention'] = dict(
        max_abs_err=max(c['max_abs_err'] for c in fused_cases),
        ms=xl['us'] / 1e3, plain_ms=xl['plain_us'] / 1e3,
        unfused_pair_ms=xl['unfused_pair_us'] / 1e3,
        bound_ms=xl['bound_us'] / 1e3, bound_by=xl['bound_by'],
        library_ms=None, cases=fused_cases)
    xl = k7_sites[0]  # M = 4096: the top-level numbers
    results['int8_gemm_swiglu_quant'] = dict(
        max_abs_err=max(st['max_abs_err'] for st in k7_sites),
        ms=xl['us'] / 1e3, plain_ms=xl['plain_us'] / 1e3,
        bound_ms=xl['bound_us'] / 1e3, bound_by=xl['bound_by'],
        library_ms=None, sites=k7_sites)
    xl = attention_cases[0]  # bf16, bounded, no mask: the XL path's variant
    results['attention'] = dict(
        max_abs_err=max(c['max_abs_err'] for c in attention_cases),
        ms=xl['us'] / 1e3, plain_ms=xl['plain_us'] / 1e3,
        bound_ms=xl['bound_us'] / 1e3, bound_us=xl['bound_us'],
        bound_by=xl['bound_by'], library_ms=xl['library_us'] / 1e3,
        cases=attention_cases)
    return results


def _xl_model_fp32(depth=XL['depth'], **options):
    """XL/2 on the CPU in fp32 (built with `options`), seeded init,
    zero-init leaves perturbed (an untrained FiT outputs velocity exactly 0
    and would make parity vacuous)."""
    import torch
    from fitv2_tpu_torch.models import FiT
    torch.manual_seed(SEED)
    model = FiT(**dict(XL, depth=depth, **options))
    gen = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if 'adaLN_modulation.fc_out' in name or 'final_layer.linear' in name:
                p.add_(0.02 * torch.randn(p.shape, generator=gen))
    return model.eval()


def xl_model_bf16(**options):
    """_xl_model_fp32's weights on the card in bf16, built with `options`
    (for example gemm_precision='int8')."""
    import torch
    model = _xl_model_fp32().to('cuda', torch.bfloat16)
    return _xl_variant(model, **options) if options else model


def phase_parity(model_cpu):
    """One CFG Euler step of XL in fp32: CUDA (kernels) vs CPU (plain)."""
    import torch
    from fitv2_tpu_torch.sample import SamplingConfig, build_sampler
    scfg = SamplingConfig(num_sampling_steps=1, cfg_scale=CFG_SCALE,
                          per_device_batch=1, dtype=torch.float32)
    z = torch.randn(1, N, 16, generator=torch.Generator().manual_seed(SEED))
    labels = torch.tensor([207])
    model_gpu = copy.deepcopy(model_cpu).to('cuda')
    # one Euler step over [0, 1]: latents = unpatchify(z) + v
    z_img = model_cpu.unpatchify(z, (32, 32))
    t0 = time.perf_counter()
    v_cpu = build_sampler(model_cpu, scfg)(labels, z=z) - z_img
    t_cpu = time.perf_counter() - t0
    v_gpu = build_sampler(model_gpu, scfg)(labels, z=z).cpu() - z_img
    if not torch.isfinite(v_gpu).all():
        raise AssertionError('parity: non-finite velocity on CUDA')
    norm = v_cpu.norm().item()
    if norm == 0.0:
        raise AssertionError('parity: zero velocity (vacuous comparison)')
    rel = (v_gpu - v_cpu).norm().item() / norm
    say(f'[parity] XL fp32 depth 36, batch 1 (CFG 2), 1 Euler step: '
        f'|v| {norm:.4e}, relative L2 CUDA vs CPU {rel:.3e} <= '
        f'{TOL_SLICE_REL_L2}: {"ok" if rel <= TOL_SLICE_REL_L2 else "FAIL"}'
        f' (CPU step {t_cpu:.1f} s)')
    if not rel <= TOL_SLICE_REL_L2:
        raise AssertionError(f'parity: relative L2 {rel} > {TOL_SLICE_REL_L2}')
    return model_gpu, rel


def _expected_counts(forwards, depth, **per_block):
    """Launch counts of `forwards` FiT forwards: K1 twice per block and once
    in the final layer, each other kernel `per_block` times per block."""
    from fitv2_tpu_torch import kernels as K
    want = {w.__name__: 0 for w in K.KERNEL_WRAPPERS}
    want['fused_adaln_norm'] = forwards * (2 * depth + 1)
    for name, n in per_block.items():
        want[name] = forwards * depth * n
    return want


def _reset_counts():
    from fitv2_tpu_torch import kernels as K
    for w in K.KERNEL_WRAPPERS:
        w.launches = 0
    K.flash_masked_attention.bounded_launches = 0


def _read_counts():
    from fitv2_tpu_torch import kernels as K
    return {w.__name__: w.launches for w in K.KERNEL_WRAPPERS}


def phase_main(model_gpu, vae, card, out_dir):
    """The main path in bf16: sampler -> VAE -> uint8 -> npz (kept in
    out_dir for phase 10), counted."""
    import numpy as np
    import torch
    from fitv2_tpu_torch.sample import (
        SamplingConfig, build_sampler, save_npz)

    model = model_gpu.to(torch.bfloat16)
    scfg = SamplingConfig(num_sampling_steps=STEPS, cfg_scale=CFG_SCALE,
                          per_device_batch=BATCH, dtype=torch.bfloat16)
    labels = torch.arange(BATCH) * 111 % 1000
    z = torch.randn(BATCH, N, 16, generator=torch.Generator().manual_seed(
        SEED + 3))

    # warm-up: two steps through every kernel, cuBLAS and cuDNN
    warm = SamplingConfig(num_sampling_steps=2, cfg_scale=CFG_SCALE,
                          per_device_batch=BATCH, dtype=torch.bfloat16)
    build_sampler(model, warm, vae)(labels, z=z)
    torch.cuda.synchronize()

    denoise = build_sampler(model, scfg)
    t0 = time.perf_counter()
    latents = denoise(labels, z=z)
    torch.cuda.synchronize()
    t_denoise = time.perf_counter() - t0
    z_img = model.unpatchify(z.cuda(), (32, 32)).float()
    moved = (latents - z_img).norm().item() / z_img.norm().item()
    if not torch.isfinite(latents).all() or not moved > 1e-3:
        raise AssertionError(f'main: latents not finite or not moved '
                             f'(relative change {moved})')

    sample = build_sampler(model, scfg, vae)
    _reset_counts()
    t0 = time.perf_counter()
    images = sample(labels, z=z)
    path = os.path.join(out_dir, 'main.npz')
    save_npz(path, images.cpu().numpy())
    t_full = time.perf_counter() - t0
    arr = np.load(path)['arr_0']
    counts = _read_counts()
    if arr.shape != (BATCH, 256, 256, 3) or arr.dtype != np.uint8:
        raise AssertionError(f'main: npz holds {arr.shape} {arr.dtype}')
    want = _expected_counts(STEPS, model.depth, fused_qk_rope=1,
                            flash_masked_attention=1)
    if counts != want:
        raise AssertionError(f'main: launch counts {counts} != {want}')
    say(f'[main] latents finite, relative change from noise {moved:.3f}; '
        f'npz {arr.shape} {arr.dtype}, pixel mean {arr.mean():.2f}')
    say(f'[main] launches {counts} == expected')
    say(f'[main] XL/2 bf16 256x256 batch {BATCH}, {STEPS} steps, CFG '
        f'{CFG_SCALE}: denoise {t_denoise:.3f} s = '
        f'{BATCH / t_denoise:.4f} images/s; full pipeline (denoise + VAE + '
        f'uint8 + npz) {t_full:.3f} s = {BATCH / t_full:.4f} images/s '
        f'[{card}]')
    return counts


def _xl_variant(model_bf16, **options):
    """XL/2 in bf16 on the card, built with other options, holding
    model_bf16's weights."""
    import torch
    from fitv2_tpu_torch.models import FiT
    with torch.device('cuda'):
        model = FiT(**XL, dtype=torch.bfloat16, **options)
    model.load_state_dict(model_bf16.state_dict())
    return model.eval()


def _one_step_velocity(model, z, labels, hw=(256, 256)):
    """v of one CFG Euler step over [0, 1] (latents = z + v), float32."""
    import torch
    from fitv2_tpu_torch.sample import SamplingConfig, build_sampler
    scfg = SamplingConfig(image_height=hw[0], image_width=hw[1],
                          num_sampling_steps=1, cfg_scale=CFG_SCALE,
                          per_device_batch=BATCH, dtype=torch.bfloat16)
    n = hw[0] * hw[1] // 256
    z_img = model.unpatchify(z[:, :n].cuda(), (hw[0] // 8, hw[1] // 8))
    return (build_sampler(model, scfg)(labels, z=z) - z_img.float()).float()


def _counted_pipeline(tag, model, scfg, vae, labels, z, want, build=None,
                      out_dir=None):
    """Warm up (2 steps), then the user's call: build_sampler with the VAE
    (or `build(scfg)`), sample, uint8 -> npz (`tag`.npz, kept in out_dir
    when given), with every count set to 0 just before and read just
    after. Checks the npz and the counts; returns the seconds."""
    import numpy as np
    import torch
    from fitv2_tpu_torch.sample import build_sampler, save_npz
    if build is None:
        def build(cfg):
            return build_sampler(model, cfg, vae)
    warm = dataclasses.replace(scfg, num_sampling_steps=2)
    build(warm)(labels, z=z)
    torch.cuda.synchronize()
    sample = build(scfg)
    with contextlib.ExitStack() as stack:
        folder = out_dir or stack.enter_context(tempfile.TemporaryDirectory())
        path = os.path.join(folder, f'{tag}.npz')
        _reset_counts()
        t0 = time.perf_counter()
        images = sample(labels, z=z)
        save_npz(path, images.cpu().numpy())
        secs = time.perf_counter() - t0
        arr = np.load(path)['arr_0']
        counts = _read_counts()
    shape = (len(labels), scfg.image_height, scfg.image_width, 3)
    if arr.shape != shape or arr.dtype != np.uint8:
        raise AssertionError(f'{tag}: npz holds {arr.shape} {arr.dtype}, '
                             f'want {shape} uint8')
    if counts != want:
        raise AssertionError(f'{tag}: launch counts {counts} != {want}')
    say(f'[{tag}] npz {arr.shape} {arr.dtype}, pixel mean {arr.mean():.2f};'
        f' launches {counts} == expected')
    return secs


def _cosine(a, b):
    a, b = a.double().ravel(), b.double().ravel()
    return (a @ b / (a.norm() * b.norm())).item()


def phase_int8(model_bf16, vae, card):
    """The int8 W8A8 serving path, with built-in calibration."""
    import torch
    from fitv2_tpu_torch.sample import SamplingConfig, build_sampler
    model = _xl_variant(model_bf16, gemm_precision='int8')
    labels = torch.arange(BATCH) * 111 % 1000
    z = torch.randn(BATCH, N, 16, generator=torch.Generator().manual_seed(
        SEED + 3))
    scfg = SamplingConfig(num_sampling_steps=STEPS, cfg_scale=CFG_SCALE,
                          per_device_batch=BATCH, dtype=torch.bfloat16)

    v_bf16 = _one_step_velocity(model_bf16, z, labels)
    v_int8 = _one_step_velocity(model, z, labels)
    cos = _cosine(v_int8, v_bf16)
    say(f'[int8] one-step velocity, int8 vs bf16 (same weights, same z): '
        f'cosine {cos:.6f} > {MIN_INT8_COSINE}: '
        f'{"ok" if cos > MIN_INT8_COSINE else "FAIL"}')
    if not cos > MIN_INT8_COSINE or not torch.isfinite(v_int8).all():
        raise AssertionError(f'int8: velocity cosine {cos}')

    _reset_counts()
    t0 = time.perf_counter()
    denoise = build_sampler(model, scfg)  # calibrates and prequantizes
    t_calib = time.perf_counter() - t0
    calib = _read_counts()
    if calib['int8_gemm_bias'] or calib['int8_gemm_swiglu_quant']:
        raise AssertionError(f'int8: calibration launched {calib}')
    t0 = time.perf_counter()
    latents = denoise(labels, z=z)
    torch.cuda.synchronize()
    t_denoise = time.perf_counter() - t0
    if not torch.isfinite(latents).all():
        raise AssertionError('int8: latents not finite')

    want = _expected_counts(STEPS, model.depth, fused_qk_rope=1,
                            flash_masked_attention=1, int8_gemm_bias=3,
                            int8_gemm_swiglu_quant=1)
    t_full = _counted_pipeline('int8', model, scfg, vae, labels, z, want)
    say(f'[int8] XL/2 int8 W8A8 256x256 batch {BATCH}, {STEPS} steps, CFG '
        f'{CFG_SCALE}: calibration + prequantization {t_calib:.3f} s; '
        f'denoise {t_denoise:.3f} s = {BATCH / t_denoise:.4f} images/s; '
        f'full pipeline {t_full:.3f} s = {BATCH / t_full:.4f} images/s '
        f'[{card}]')
    return model, _read_counts(), cos


def serving_max_forwards(steps, low, high, every):
    """FiT forwards of the composed sampler, from the ladder alone: the
    steps split into runs of equal guidance (CFG or conditional only), and
    each run of r steps evaluates the model ceil(r / every) times."""
    import numpy as np
    cfg_on = [low <= t <= high
              for t in np.linspace(0.0, 1.0, steps + 1)[:-1]]
    forwards, start = 0, 0
    for i in range(1, steps + 1):
        if i == steps or cfg_on[i] != cfg_on[start]:
            forwards += -(-(i - start) // every)
            start = i
    return forwards


def phase_serving_max(model_int8, vae, card):
    """int8 + guidance interval + quadratic velocity extrapolation."""
    import torch
    from fitv2_tpu_torch.sample import SamplingConfig
    labels = torch.arange(BATCH) * 111 % 1000
    z = torch.randn(BATCH, N, 16, generator=torch.Generator().manual_seed(
        SEED + 3))
    scfg = SamplingConfig(num_sampling_steps=STEPS, cfg_scale=CFG_SCALE,
                          per_device_batch=BATCH, dtype=torch.bfloat16,
                          guidance_low=GUIDANCE[0], guidance_high=GUIDANCE[1],
                          velocity_eval_every=EVAL_EVERY,
                          velocity_extrap_order=EXTRAP_ORDER)
    forwards = serving_max_forwards(STEPS, *GUIDANCE, EVAL_EVERY)
    want = _expected_counts(forwards, model_int8.depth, fused_qk_rope=1,
                            flash_masked_attention=1, int8_gemm_bias=3,
                            int8_gemm_swiglu_quant=1)
    secs = _counted_pipeline('serving-max', model_int8, scfg, vae, labels, z,
                             want)
    say(f'[serving-max] int8, CFG for t in {list(GUIDANCE)}, velocity '
        f'extrapolation order {EXTRAP_ORDER} every {EVAL_EVERY} steps: '
        f'{forwards} forwards for {STEPS} steps; full pipeline {secs:.3f} s '
        f'= {BATCH / secs:.4f} images/s [{card}]')
    return _read_counts()


def phase_fused(model_bf16, vae, card):
    """attn_impl='fused' on the padded 160x320 bucket."""
    import torch
    from fitv2_tpu_torch.sample import SamplingConfig
    model = _xl_variant(model_bf16, attn_impl='fused')
    if not all(b.attn.fused for b in model.blocks):
        raise AssertionError('fused: XL is not eligible for the fused path')
    labels = torch.arange(BATCH) * 111 % 1000
    z = torch.randn(BATCH, N, 16, generator=torch.Generator().manual_seed(
        SEED + 4))
    v_unfused = _one_step_velocity(model_bf16, z, labels, PADDED_HW)
    v_fused = _one_step_velocity(model, z, labels, PADDED_HW)
    rel = ((v_fused - v_unfused).norm() / v_unfused.norm()).item()
    say(f'[fused] one-step velocity on the padded bucket, fused vs unfused '
        f'(bf16, same weights): relative L2 {rel:.3e} <= '
        f'{MAX_FUSED_REL_L2}: {"ok" if rel <= MAX_FUSED_REL_L2 else "FAIL"}')
    if not rel <= MAX_FUSED_REL_L2 or not torch.isfinite(v_fused).all():
        raise AssertionError(f'fused: velocity relative L2 {rel}')
    scfg = SamplingConfig(image_height=PADDED_HW[0],
                          image_width=PADDED_HW[1], num_sampling_steps=STEPS,
                          cfg_scale=CFG_SCALE, per_device_batch=BATCH,
                          dtype=torch.bfloat16)
    want = _expected_counts(STEPS, model.depth, fused_qkln_rope_attention=1)
    secs = _counted_pipeline('fused', model, scfg, vae, labels, z, want)
    say(f'[fused] XL/2 bf16 attn_impl=fused {PADDED_HW[0]}x{PADDED_HW[1]} '
        f'(200 of 256 tokens valid) batch {BATCH}, {STEPS} steps, CFG '
        f'{CFG_SCALE}: full pipeline {secs:.3f} s = {BATCH / secs:.4f} '
        f'images/s [{card}]')
    return _read_counts()


def _hr_model(model, dtype, device):
    """FiTv2-HR-XL/2 holding `model`'s weights (XL/2's parameters: the
    context and the RoPE config hold no weights) in `dtype` on `device`."""
    import torch
    from fitv2_tpu_torch.models import FiT
    with torch.device(device):
        hr = FiT(**HR_XL, dtype=dtype)
    hr.load_state_dict(model.state_dict())
    return hr.eval()


def hr_model_bf16():
    """_xl_model_fp32's weights as FiTv2-HR-XL/2 on the card in bf16."""
    import torch
    return _hr_model(_xl_model_fp32(), torch.bfloat16, 'cuda')


def _hr_grid(sizes):
    """Per-sample (grid (B, 2, HR_N), size (B, 1, 2)) of (h, w) token grids,
    each padded to HR_N, on the card."""
    import numpy as np
    import torch
    from fitv2_tpu_torch.models.grid_utils import make_grid
    grid = np.zeros((len(sizes), 2, HR_N), np.int64)
    for i, (h, w) in enumerate(sizes):
        grid[i, :, :h * w] = make_grid(h, w)
    size = torch.tensor(sizes, dtype=torch.int64).reshape(len(sizes), 1, 2)
    return torch.from_numpy(grid).cuda(), size.cuda()


def _hr_kernel_cases(K, rope_cfg):
    """K1, K2 and K4 at the HR path's shapes (CFG batch 8, N 1024, bf16)
    against their plain versions: K2 with per-sample online NTK tables
    (half the batch at 32 x 32, half at 20 x 40), K4 without a mask and
    with 800 of 1024 keys valid."""
    import torch
    from fitv2_tpu_torch.models import rope as rope_lib
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    b2 = 2 * HR_BATCH
    x = (torch.randn(b2, HR_N, D, device=dev, generator=gen) * 2 + 3
         ).to(torch.bfloat16)
    mod = (0.5 * torch.randn(b2, 6 * D, device=dev, generator=gen)
           ).to(torch.bfloat16)
    shift, scale = mod.chunk(6, dim=-1)[:2]
    adaln = _adaln_case(K, x, shift, scale)
    grid, size = _hr_grid([(32, 32)] * HR_BATCH + [(20, 40)] * HR_BATCH)
    cos, sin = rope_lib.online_rope_from_grid(rope_cfg, grid, size)
    if torch.equal(cos[0], cos[-1]):
        raise AssertionError('hr: the per-sample tables do not differ')
    qkv = torch.randn(b2, HR_N, 3, H, DH, device=dev, generator=gen
                      ).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    qk_rope = _qk_rope_case(K, q, k, cos, sin)
    qn, kn = K.qk_norm_rope_reference(q, k, cos, sin)
    mask = torch.zeros(b2, HR_N, device=dev)
    mask[:, :800] = 1.0
    attention = [dict(_attention_case(K, torch.bfloat16, qn, kn, v, m, True),
                      shape=[b2, HR_N, H, DH]) for m in (None, mask)]
    torch.cuda.synchronize()
    return {'adaln': [adaln], 'qk_rope': [qk_rope], 'attention': attention}


def phase_hr(model_cpu, model_bf16, vae, card, out_dir):
    """The HR path and an extrapolated XL bucket; returns the kernel cases
    and each path's counts."""
    import torch
    from fitv2_tpu_torch import kernels as K
    from fitv2_tpu_torch.sample import (
        BucketedSampler, SamplingConfig, build_sampler)
    hr_cpu = _hr_model(model_cpu, torch.float32, 'cpu')
    cases = _hr_kernel_cases(K, hr_cpu.rope_config)

    # fp32 one CFG Euler step at 512x512, batch 1: CUDA vs CPU
    scfg = SamplingConfig(image_height=512, image_width=512,
                          num_sampling_steps=1, cfg_scale=CFG_SCALE,
                          per_device_batch=1, dtype=torch.float32,
                          interpolation='keep')
    z = torch.randn(1, HR_N, 16, generator=torch.Generator().manual_seed(
        SEED + 5))
    labels = torch.tensor([207])
    z_img = hr_cpu.unpatchify(z, (64, 64))
    t0 = time.perf_counter()
    v_cpu = build_sampler(hr_cpu, scfg)(labels, z=z) - z_img
    t_cpu = time.perf_counter() - t0
    hr_gpu = copy.deepcopy(hr_cpu).to('cuda')
    del hr_cpu
    v_gpu = build_sampler(hr_gpu, scfg)(labels, z=z).cpu() - z_img
    del hr_gpu
    norm = v_cpu.norm().item()
    if not torch.isfinite(v_gpu).all() or norm == 0.0:
        raise AssertionError('hr parity: non-finite or zero velocity')
    rel = (v_gpu - v_cpu).norm().item() / norm
    say(f'[hr] HR-XL fp32 depth {HR_XL["depth"]}, 512x512 (N 1024, online '
        f'NTK), batch 1 (CFG 2), 1 Euler step: |v| {norm:.4e}, relative L2 CUDA vs CPU '
        f'{rel:.3e} <= {TOL_SLICE_REL_L2}: '
        f'{"ok" if rel <= TOL_SLICE_REL_L2 else "FAIL"} (CPU step '
        f'{t_cpu:.1f} s)')
    if not rel <= TOL_SLICE_REL_L2:
        raise AssertionError(f'hr parity: relative L2 {rel}')

    hr = _hr_model(model_bf16, torch.bfloat16, 'cuda')
    labels = torch.arange(HR_BATCH) * 111 % 1000
    z = torch.randn(HR_BATCH, HR_N, 16,
                    generator=torch.Generator().manual_seed(SEED + 6))
    counts = {}
    want = _expected_counts(STEPS, hr.depth, fused_qk_rope=1,
                            flash_masked_attention=1)
    for h, w in HR_BUCKETS:
        tag = f'hr_{h}x{w}'
        scfg = SamplingConfig(image_height=h, image_width=w,
                              num_sampling_steps=STEPS, cfg_scale=CFG_SCALE,
                              per_device_batch=HR_BATCH,
                              dtype=torch.bfloat16, interpolation='keep')
        secs = _counted_pipeline(tag, hr, scfg, vae, labels, z, want,
                                 out_dir=out_dir)
        counts[tag] = _read_counts()
        say(f'[hr] HR-XL/2 bf16 {h}x{w} ({h * w // 256} of {HR_N} tokens '
            f'valid), online NTK, batch {HR_BATCH}, {STEPS} steps, CFG '
            f'{CFG_SCALE}: full pipeline {secs:.3f} s = '
            f'{HR_BATCH / secs:.4f} images/s [{card}]')
    del hr

    h, w = EXTRAP_HW
    tag = f'xl_{h}x{w}'
    base = SamplingConfig(image_height=h, image_width=w,
                          num_sampling_steps=STEPS, cfg_scale=CFG_SCALE,
                          per_device_batch=BATCH, dtype=torch.bfloat16)
    bucket_cfg = BucketedSampler(model_bf16, base, vae).config_for(h, w)
    if bucket_cfg.interpolation != 'ntkpro2':
        raise AssertionError(f'{tag}: bucket config {bucket_cfg}')
    n_tok = (h // 16) * (w // 16)  # > 256: the context grows to n_tok
    z = torch.randn(BATCH, n_tok, 16,
                    generator=torch.Generator().manual_seed(SEED + 7))
    secs = _counted_pipeline(
        tag, model_bf16, base, vae, torch.arange(BATCH) * 111 % 1000, z,
        _expected_counts(STEPS, model_bf16.depth, fused_qk_rope=1,
                         flash_masked_attention=1),
        build=lambda cfg: BucketedSampler(model_bf16, cfg, vae).get(h, w))
    counts[tag] = _read_counts()
    say(f'[hr] XL/2 bf16 through BucketedSampler at {h}x{w} (ntkpro2, '
        f'context {n_tok}), batch {BATCH}, {STEPS} steps, CFG {CFG_SCALE}: '
        f'full pipeline {secs:.3f} s = {BATCH / secs:.4f} images/s [{card}]')
    return cases, counts


def phase_eval(card, out_dir):
    """InceptionV3 on the card against the CPU, its activation rate, and
    cli/evaluate on the card over phase 5's and phase 9's npz files."""
    import numpy as np
    import torch
    from fitv2_tpu_torch.cli import evaluate
    from fitv2_tpu_torch.eval import inception as inc
    wpath = os.path.join(out_dir, 'pt_inception.pt')
    torch.save(inc.random_fid_state_dict(SEED), wpath)
    main_npz = os.path.join(out_dir, 'main.npz')
    hr_npz = os.path.join(out_dir, 'hr_512x512.npz')
    imgs = torch.from_numpy(np.load(main_npz)['arr_0'])
    with torch.no_grad():  # TF32 is off since phase 1
        on_card = inc.load_inception(wpath, 'cuda')(
            inc.preprocess_uint8(imgs.cuda()))
        on_cpu = inc.load_inception(wpath, 'cpu')(inc.preprocess_uint8(imgs))
    for key in ('pool3', 'spatial', 'logits'):
        got, ref = on_card[key].cpu().double(), on_cpu[key].double()
        rel = ((got - ref).abs().max() / ref.abs().max()).item()
        say(f'[eval] InceptionV3 {key} {tuple(got.shape)}, card vs CPU '
            f'(fp32, TF32 off) on {len(imgs)} images: {rel:.3e} of the '
            f'largest <= {TOL_INCEPTION_REL}: '
            f'{"ok" if rel <= TOL_INCEPTION_REL else "FAIL"}')
        if not rel <= TOL_INCEPTION_REL or not torch.isfinite(got).all():
            raise AssertionError(f'eval: {key} card vs CPU {rel}')

    model = inc.load_inception(wpath, 'cuda')
    many = np.random.default_rng(SEED).integers(
        0, 256, (EVAL_IMAGES, 256, 256, 3), dtype=np.uint8)
    inc.compute_activations(model, many[:EVAL_BATCH], EVAL_BATCH)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acts = inc.compute_activations(model, many, EVAL_BATCH)
    secs = time.perf_counter() - t0
    if acts['pool3'].shape != (EVAL_IMAGES, 2048):
        raise AssertionError(f'eval: pool3 {acts["pool3"].shape}')
    rate = EVAL_IMAGES / secs
    say(f'[eval] InceptionV3 activations (uint8 256x256 -> resize -> pool3,'
        f' spatial, softmax on the host) at batch {EVAL_BATCH}: '
        f'{EVAL_IMAGES} images in {secs:.3f} s = {rate:.1f} images/s; a '
        f'FID-50K batch plus its reference batch at this rate: '
        f'{2 * 50_000 / rate:.1f} s [{card}]')

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        evaluate.main([main_npz, hr_npz, '--inception-weights', wpath,
                       '--device', 'cuda'])
    metrics = json.loads(buf.getvalue().strip().splitlines()[-1])
    keys = ('fid', 'sfid', 'inception_score', 'precision', 'recall')
    if not all(k in metrics and math.isfinite(metrics[k]) for k in keys):
        raise AssertionError(f'eval: cli/evaluate printed {metrics}')
    say(f'[eval] cli/evaluate --device cuda main.npz ({len(imgs)} x 256^2) '
        f'vs hr_512x512.npz: {json.dumps(metrics)} (seeded weights: '
        'comparable across this pipeline only)')


def _grad_case(label, dtype, function, plain, arrays, seed, gate,
               reps=REPS):
    """A kernel's autograd Function (its kernel forward, then its
    ``*_backward``) against autograd of its plain version on the same card
    inputs: first the Function's forward output, recorded by autograd as
    the trainer records it, against the plain output at phase 3's gates
    (_compare with `gate`, 'norm' or 'attention'); then the gradients
    (fp32: within TOL_FP32_REL of the largest |grad|; bf16:
    TOL_GRAD_BF16); then the median times (of `reps` calls) of each side's
    forward
    (autograd recording) and of its backward alone (the graph kept between
    calls). `function` and `plain` take `arrays` (leaf tensors)."""
    import torch
    gen = torch.Generator(device='cuda').manual_seed(seed)
    with torch.no_grad():
        out = plain(*arrays)
    outs = out if isinstance(out, tuple) else (out,)
    cots = [torch.randn(o.shape, device='cuda', generator=gen).to(o.dtype)
            for o in outs]

    def grads(fn):
        leaves = [a.detach().requires_grad_(True) for a in arrays]
        got = fn(*leaves)
        got = got if isinstance(got, tuple) else (got,)
        if not all(g.grad_fn is not None for g in got):
            raise AssertionError(f'{label}: an output without a grad_fn')
        return got, torch.autograd.grad(got, leaves, cots)

    kernel_out, kernel_grads = grads(function)
    fwd_err = _compare(f'{label} Function forward', dtype,
                       tuple(o.detach() for o in kernel_out), outs, gate)
    del kernel_out
    worst = worst_rel = 0.0
    for o, r in zip(kernel_grads, grads(plain)[1]):
        if not torch.isfinite(o).all():
            raise AssertionError(f'{label} {dtype}: non-finite gradient')
        err = (o.float() - r.float()).abs().max().item()
        rel = err / r.float().abs().max().item()
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
    tol = TOL_FP32_REL if dtype == torch.float32 else TOL_GRAD_BF16
    kind = 'bf16' if dtype == torch.bfloat16 else 'fp32'
    ok = worst_rel <= tol
    say(f'[train] {label} {kind} gradients vs autograd of the plain version:'
        f' max abs {worst:.3e}, {worst_rel:.3e} of the largest <= {tol}: '
        f'{"ok" if ok else "FAIL"}')
    if not ok:
        raise AssertionError(f'{label} {kind}: gradients {worst_rel} > {tol}')
    times = {}
    for side, fn in (('', function), ('plain_', plain)):
        leaves = [a.detach().requires_grad_(True) for a in arrays]
        out = fn(*leaves)
        outs = out if isinstance(out, tuple) else (out,)
        times[side + 'fwd_us'] = _time_ms(lambda: fn(*leaves), reps) * 1e3
        times[side + 'bwd_us'] = _time_ms(lambda: torch.autograd.grad(
            outs, leaves, cots, retain_graph=True), reps) * 1e3
        del out, outs
    say(f'[train] {label} {kind}: Function forward {times["fwd_us"]:.1f} us '
        f'(the kernel) + backward {times["bwd_us"]:.1f} us; plain autograd '
        f'forward {times["plain_fwd_us"]:.1f} + backward '
        f'{times["plain_bwd_us"]:.1f} us')
    return dict(case=label, dtype=kind, fwd_max_abs_err=fwd_err,
                max_abs_err=worst, rel_err=worst_rel,
                us=times['fwd_us'] + times['bwd_us'],
                plain_us=times['plain_fwd_us'] + times['plain_bwd_us'],
                **times)


def phase_train_kernels():
    """Phase 11 (a): each Function on the card at the training shapes (XL,
    batch TRAIN_BATCH, N 256), bf16 and fp32; the attention without a mask
    and with N_VALID of N keys valid. Returns the cases by kernel."""
    import torch
    from fitv2_tpu_torch import kernels as K
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    b = TRAIN_BATCH
    mask = torch.zeros(b, N, device=dev)
    mask[:, :N_VALID] = 1.0
    cases = {'adaln': [], 'qk_rope': [], 'attention': [],
             'fused_attention': []}
    for dtype in (torch.bfloat16, torch.float32):
        x = (torch.randn(b, N, D, device=dev, generator=gen) * 2 + 3
             ).to(dtype)
        mod = (0.5 * torch.randn(b, 6 * D, device=dev, generator=gen)
               ).to(dtype)

        def adaln(fn):
            return lambda a, m: fn(a, *m.chunk(6, dim=-1)[:2])
        cases['adaln'].append(_grad_case(
            f'adaln ({b},{N},{D})', dtype, adaln(K.adaln_norm),
            adaln(K.adaln_norm_reference), [x, mod], 1, 'norm'))

        qkv = torch.randn(b, N, 3, H, DH, device=dev, generator=gen
                          ).to(dtype)
        ang = torch.rand(b, N, DH, device=dev, generator=gen) * 6.3
        cos, sin = torch.cos(ang), torch.sin(ang)

        def qk(fn):
            return lambda a: fn(*a.unbind(2)[:2], cos, sin)
        cases['qk_rope'].append(_grad_case(
            f'qk_rope ({b},{N},{H},{DH})', dtype, qk(K.qk_norm_rope),
            qk(K.qk_norm_rope_reference), [qkv], 2, 'norm'))

        q, k, v = qkv.unbind(2)
        qn, kn = K.qk_norm_rope_reference(q, k, cos, sin)
        qkv_n = torch.stack([qn, kn, v], dim=2)  # LayerNormed q and k
        for bounded in (True, False):
            plain = (K.attention_bounded_reference if bounded
                     else K.attention_reference)
            for m in (None, mask):
                tag = ('no mask' if m is None
                       else f'mask {N_VALID}/{N}')
                cases['attention'].append(dict(_grad_case(
                    f'attention[{"bounded" if bounded else "online"},{tag}]',
                    dtype,
                    lambda a, m=m, bd=bounded: K.masked_attention(
                        *a.unbind(2), m, bounded_logits=bd),
                    lambda a, m=m, p=plain: p(*a.unbind(2), m), [qkv_n], 3,
                    'attention'),
                    variant='bounded' if bounded else 'online',
                    mask=m is not None))

        flat = qkv.reshape(b, N, 3 * D)
        for m in (mask, None):
            tag = 'no mask' if m is None else f'mask {N_VALID}/{N}'
            cases['fused_attention'].append(dict(_grad_case(
                f'fused_attention[{tag}] ({b},{N},{3 * D})', dtype,
                lambda a, m=m: K.qkln_rope_attention(a, cos, sin, m, H),
                lambda a, m=m: K.fused_qkln_rope_attention_reference(
                    a, cos, sin, m, H), [flat], 4, 'attention'),
                mask=m is not None))
        torch.cuda.synchronize()
    return cases


def phase_train_parity():
    """Phase 11 (b): FiTv2 at XL width, depth TRAIN_PARITY_DEPTH, fp32,
    batch 2 (a padded 10 x 20 grid), one flow loss and backward on the same
    weights, batch and draws: CUDA (kernels and their backward functions)
    against the CPU (plain versions under autograd). Every parameter must
    get a gradient on CUDA, each within TOL_SLICE_REL_L2 relative L2."""
    import torch
    from fitv2_tpu_torch.flow import create_transport
    from fitv2_tpu_torch.models.grid_utils import make_grid_mask_size
    from fitv2_tpu_torch.train import flow_loss
    depth = TRAIN_PARITY_DEPTH
    model = _xl_model_fp32(depth)
    gen = torch.Generator().manual_seed(SEED + 12)
    grid, mask, size = make_grid_mask_size(2, 10, 20, N)
    batch = dict(feature=torch.randn(2, N, 16, generator=gen), grid=grid,
                 mask=mask, label=torch.tensor([207, 360]), size=size)
    draws = dict(t=torch.tensor([0.3, 0.75]),
                 x0=torch.randn(2, N, 16, generator=gen),
                 drop_ids=torch.tensor([0, 1]))
    transport = create_transport('Linear', 'velocity', snr_type='lognorm')
    out = {}
    for device in ('cpu', 'cuda'):
        m = copy.deepcopy(model).to(device).train()
        _reset_counts()
        loss, _ = flow_loss(m, transport,
                            {k: v.to(device) for k, v in batch.items()},
                            draws={k: v.to(device) for k, v in draws.items()})
        loss.backward()
        out[device] = (loss.item(), _read_counts(),
                       {n: p.grad for n, p in m.named_parameters()})
    (loss_cpu, _, g_cpu), (loss_gpu, counts, g_gpu) = out['cpu'], out['cuda']
    want = _expected_counts(1, depth, fused_qk_rope=1,
                            flash_masked_attention=1)
    if counts != want:
        raise AssertionError(f'train parity: launch counts {counts} != {want}')
    missing = [n for n, g in g_gpu.items() if g is None]
    if missing:
        raise AssertionError(f'train parity: no gradient on CUDA for '
                             f'{missing[:5]} ({len(missing)} parameters)')
    rel_loss = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    rels = {n: ((g.cpu() - g_cpu[n]).norm() / g_cpu[n].norm()).item()
            for n, g in g_gpu.items()}
    worst = max(rels, key=rels.get)
    ok = rel_loss <= TOL_SLICE_REL_L2 and rels[worst] <= TOL_SLICE_REL_L2
    say(f'[train] XL width depth {depth} fp32 batch 2, one flow loss + '
        f'backward, CUDA vs CPU: loss {loss_gpu:.6f} vs {loss_cpu:.6f} '
        f'(relative {rel_loss:.3e}); all {len(g_gpu)} parameters have a '
        f'gradient; worst gradient relative L2 {rels[worst]:.3e} ({worst}) '
        f'<= {TOL_SLICE_REL_L2}: {"ok" if ok else "FAIL"}; launches '
        f'{counts} == expected')
    if not ok:
        raise AssertionError(f'train parity: loss {rel_loss}, {worst} '
                             f'{rels[worst]}')
    return rels[worst]


def _train_run(cli, cfg, args, resume, log_every=1, write=True, mses=None,
               extra_hook=None, trainer=None):
    """One Trainer run of phase 11 (c), 12 (d) or 15 from cli/train.py's
    build_trainer (or `trainer`'s next run, from its masters with a fresh
    optimizer state: phase 15 (c)), reading the metrics every `log_every`
    steps: every step's loss (and its mse into `mses` when given), the
    wall time at each logged step (after a sync; then `extra_hook(step,
    metrics, trainer)` runs, when given), the checkpoint saves (none are
    written unless `write`), the peak device memory and the launch counts
    of the run."""
    import torch
    from fitv2_tpu_torch import kernels as K
    if trainer is None:
        torch.manual_seed(SEED)  # the initial weights
        trainer = cli.build_trainer(cfg, args)
    trainer.cfg.log_every = log_every
    if (trainer.model.dtype != torch.bfloat16 or any(
            p.dtype != torch.float32 for p in trainer.master_model.parameters())
            or trainer.optimizer_config.mu_dtype != torch.bfloat16
            or trainer.cfg.loader_backend != 'native'):
        raise AssertionError('train: expected bf16 compute, fp32 masters, '
                             'a bf16 first moment and the native loader')
    losses, stamps, saves = [], {}, []
    step_fn, save_fn = trainer._train_step, trainer.ckpt.save

    def step(state, batch, generator):
        state, metrics = step_fn(state, batch, generator)
        losses.append(metrics['loss'])
        if mses is not None:
            mses.append(metrics['mse'])
        return state, metrics

    def save(step, state_dict):
        t0 = time.perf_counter()
        path = save_fn(step, state_dict) if write else None
        saves.append((step, time.perf_counter() - t0))
        return path

    def hook(step, metrics):
        torch.cuda.synchronize()
        stamps[step] = time.perf_counter()
        if extra_hook is not None:
            extra_hook(step, metrics, trainer)

    trainer._train_step, trainer.ckpt.save = step, save
    trainer.state = None  # a next run's state takes the last one's place
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    state = trainer.train(max_steps=args.max_steps, resume=resume,
                          metric_hook=hook)
    torch.cuda.synchronize()
    trainer._train_step, trainer.ckpt.save = step_fn, save_fn
    counts = dict(_read_counts(), flash_masked_attention_bounded=(
        K.flash_masked_attention.bounded_launches))
    peak = torch.cuda.max_memory_allocated()
    losses = [v.item() for v in losses]
    if mses is not None:
        mses[:] = [v.item() for v in mses]
    return trainer, state, losses, stamps, saves, counts, peak


def _snapshot(state):
    """A train state's parameters, EMA and optimizer moments on the host."""
    snap = {key: {n: t.detach().cpu() for n, t in getattr(state, key).items()}
            for key in ('params', 'ema_params')}
    snap['moments'] = [{k: v.cpu() for k, v in st.items()} for st in
                       state.optimizer.state_dict()['state'].values()]
    return snap


def _differ(state, snap):
    """(name, max abs difference) of every tensor of `state` that is not
    bit-identical to `snap`'s."""
    import torch
    differ = []
    for key in ('params', 'ema_params'):
        for n, t in getattr(state, key).items():
            if not torch.equal(t.detach().cpu(), snap[key][n]):
                differ.append((f'{key}.{n}', (t.detach().cpu() - snap[key][n]
                                              ).abs().max().item()))
    for i, st in enumerate(state.optimizer.state_dict()['state'].values()):
        for k, v in st.items():
            want = snap['moments'][i][k]
            if not torch.equal(v.cpu(), want):
                differ.append((f'{k}[{i}]', (v.cpu().float() - want.float()
                                             ).abs().max().item()))
    return differ


def phase_train_deterministic(card, out_dir):
    """Phase 11 (c), in a child process with DETERMINISTIC_ENV: cli/train.
    py's build_trainer on configs/fitv2_xl.yaml (its depth cut to
    TRAIN_RESUME_DEPTH, the per-host batch 32, bf16 compute over fp32
    masters, a bf16 first moment, fp32 EMA, the native loader) on
    TRAIN_SHARDS synthetic shards (written to
    out_dir/latents) with non-square grids padded to 256: TRAIN_STEPS
    steps with a checkpoint at TRAIN_RESUME, then a new trainer resumed
    from TRAIN_RESUME to TRAIN_STEPS, deterministic algorithms on (and the
    metrics read every step). Returns the launch counts of both runs and
    the step times."""
    import shutil
    import torch
    from fitv2_tpu_torch.cli import train as cli
    from fitv2_tpu_torch.data import make_synthetic_latent_shards
    shards = os.path.join(out_dir, 'latents')
    make_synthetic_latent_shards(shards, n=TRAIN_SHARDS, target_len=N,
                                 seed=SEED)
    cfg = _train_config('configs/fitv2_xl.yaml', out_dir, TRAIN_RESUME,
                        TRAIN_RESUME_DEPTH)
    run_dir = os.path.join(out_dir, 'train')
    args = cli.parse_args(['--cfgdir', 'configs/fitv2_xl.yaml',
                           '--output-dir', run_dir, '--max-steps',
                           str(TRAIN_STEPS), '--device', 'cuda'])
    torch.use_deterministic_algorithms(True)
    # no NaN fill of every new tensor (a debugging aid of deterministic
    # mode that would add a kernel to each allocation and to the step time)
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        trainer, state, losses, stamps, saves, counts, peak = _train_run(
            cli, cfg, args, False)
        batch = trainer.cfg.global_batch_size
        depth = trainer.model.depth
        final = _snapshot(state)
        del trainer, state
        torch.cuda.empty_cache()
        ckpts = sorted(os.listdir(os.path.join(run_dir, 'checkpoints')))
        if ckpts != [f'checkpoint-{TRAIN_RESUME}',
                     f'checkpoint-{TRAIN_STEPS}']:
            raise AssertionError(f'train: checkpoints {ckpts}')
        shutil.rmtree(os.path.join(run_dir, 'checkpoints',
                                   f'checkpoint-{TRAIN_STEPS}'))
        trainer, state, losses_b, _, saves_b, counts_b, _ = _train_run(
            cli, cfg, args, True)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill

    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f'train: losses {losses}')
    first_ok = TRAIN_FIRST_LOSS[0] <= losses[0] <= TRAIN_FIRST_LOSS[1]
    say(f'[train] XL/2 depth {depth} bf16 (fp32 masters, bf16 mu, fp32 EMA)'
        f', batch {batch}, {TRAIN_STEPS} steps, native loader over '
        f'{TRAIN_SHARDS} shards: losses '
        f'{", ".join(f"{v:.4f}" for v in losses)}')
    say(f'[train] first loss {losses[0]:.4f} in {TRAIN_FIRST_LOSS} (an '
        f'untrained FiT outputs 0: E|x1 - x0|^2 per valid element is 2): '
        f'{"ok" if first_ok else "FAIL"}')
    if not first_ok:
        raise AssertionError(f'train: first loss {losses[0]}')
    # the wall time of each logged step after step 5, ended by a sync;
    # the step after a checkpoint save carries the save, and is left out
    saved = {s for s, _ in saves}
    step_ms = [(stamps[s] - stamps[s - 1]) * 1e3 for s in sorted(stamps)
               if s > 5 and s - 1 in stamps and s - 1 not in saved]
    det_ms = statistics.median(step_ms)
    say(f'[train] deterministic algorithms on, metrics read and a sync every '
        f'step: step wall time median of {len(step_ms)} steps after step 5 '
        f'{det_ms:.2f} ms; range {min(step_ms):.2f}-{max(step_ms):.2f} ms; '
        'peak device memory '
        f'{peak / 2 ** 30:.2f} GiB (max_memory_allocated); checkpoint saves '
        f'{", ".join(f"step {s}: {t:.2f} s" for s, t in saves)} [{card}]')

    for label, got, steps in (('uninterrupted', counts, TRAIN_STEPS),
                              ('resumed', counts_b,
                               TRAIN_STEPS - TRAIN_RESUME)):
        want = dict(_expected_counts(steps, depth, fused_qk_rope=1,
                                     flash_masked_attention=1),
                    flash_masked_attention_bounded=steps * depth)
        if got != want:
            raise AssertionError(f'train {label}: launches {got} != {want}')
        say(f'[train] {label} run, {steps} steps: launches {got} == expected '
            f'(a step: K1 {2 * depth + 1}, K2 {depth}, K4 {depth}; K3, K5, '
            'K6, K7 0)')

    if losses_b != losses[TRAIN_RESUME:]:
        raise AssertionError(f'train: resumed losses {losses_b} != '
                             f'{losses[TRAIN_RESUME:]}')
    differ = _differ(state, final)
    if differ:
        say(f'[train] resumed vs uninterrupted: {len(differ)} tensors '
            f'differ, e.g. {differ[:5]}')
        raise AssertionError('train: the resumed run is not bit-identical')
    say(f'[train] resumed from step {TRAIN_RESUME} to {TRAIN_STEPS}: losses '
        f'equal, and parameters, EMA, mu and nu bit-identical to the '
        f'uninterrupted run (deterministic algorithms on; saves '
        f'{saves_b})')
    return dict(counts=counts, counts_resumed=counts_b, batch=batch,
                depth=depth, deterministic_ms_per_step=det_ms,
                peak_bytes=peak, first_loss=losses[0], losses=losses)


def _train_config(path, out_dir, checkpointing_steps, depth=None):
    """The YAML at `path` with phase 11's shards and a checkpoint cadence,
    its network's depth cut to `depth` when given."""
    from fitv2_tpu_torch.utils import load_config
    cfg = load_config([path])
    cfg['data']['params']['train']['data_path'] = os.path.join(out_dir,
                                                               'latents')
    cfg['accelerate']['checkpointing_steps'] = checkpointing_steps
    if depth is not None:
        cfg['diffusion']['network_config']['params']['depth'] = depth
    return cfg


def phase_train(card, out_dir):
    """Phase 11 (c): the deterministic runs and the resume check in a child
    process (phase_train_deterministic); then, here, the rate: a third
    run, deterministic algorithms off, reading the metrics every
    TRAIN_TIMED steps as a trainer's log cadence does and writing no
    checkpoint; the window is steps TRAIN_TIMED + 1 to 2 TRAIN_TIMED,
    loader included, from a sync to a sync. Returns the launch counts of
    the first two runs and the rate."""
    import torch
    from fitv2_tpu_torch.cli import train as cli
    torch.cuda.empty_cache()  # the child's trainer gets the card's memory
    # 12 (d) runs in the same child: one process start less
    both = _run_child_phase(('train', 'fitv1_train'), out_dir)
    det = both['train']
    batch = det['batch']
    timed = 2 * TRAIN_TIMED
    cfg = _train_config('configs/fitv2_xl.yaml', out_dir, TRAIN_RESUME)
    args = cli.parse_args(['--cfgdir', 'configs/fitv2_xl.yaml',
                           '--output-dir', os.path.join(out_dir, 'timed'),
                           '--max-steps', str(timed), '--device', 'cuda'])
    trainer, _, losses_t, stamps, _, counts_t, peak_t = _train_run(
        cli, cfg, args, False, log_every=TRAIN_TIMED, write=False)
    depth = trainer.model.depth
    del trainer
    want = dict(_expected_counts(timed, depth, fused_qk_rope=1,
                                 flash_masked_attention=1),
                flash_masked_attention_bounded=timed * depth)
    if counts_t != want or not all(map(math.isfinite, losses_t)):
        raise AssertionError(f'train timed run: launches {counts_t}, losses '
                             f'{losses_t}')
    ms = (stamps[timed] - stamps[TRAIN_TIMED]) * 1e3 / TRAIN_TIMED
    say(f'[train] rate, XL/2 depth {depth}, deterministic algorithms off, '
        f'metrics read every {TRAIN_TIMED} steps: steps {TRAIN_TIMED + 1}-'
        f'{timed} (loader included, from a sync to a sync) {ms:.2f} ms a '
        f'step = {batch / ms * 1e3:.2f} images/s; peak '
        f'{peak_t / 2 ** 30:.2f} GiB; launches {counts_t} == '
        f'expected [{card}]')
    return det['counts'], det['counts_resumed'], dict(
        det, fitv1_train=both['fitv1_train'], ms_per_step=ms,
        images_per_s=batch / ms * 1e3,
        peak_gib=peak_t / 2 ** 30)


def _v1_model_fp32():
    """FiTv1-XL/2 (configs/fit_xl.yaml's network: depth 28, SwiGLU-large,
    adaLN 'normal', learn_sigma, no q/k norm) on the CPU in fp32, seeded
    init, zero-init leaves perturbed (an untrained FiT outputs exactly 0:
    eps 0 and the mid-range variance, which would make parity vacuous)."""
    import torch
    from fitv2_tpu_torch.utils import config_to_model, load_config
    torch.manual_seed(SEED + 8)
    model = config_to_model(load_config([V1_CONFIG])['diffusion'][
        'network_config'])
    gen = torch.Generator().manual_seed(SEED + 9)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if 'adaLN_modulation.fc_out' in name or 'final_layer.linear' in name:
                p.add_(0.02 * torch.randn(p.shape, generator=gen))
    return model.eval()


def _v1_diffusion_config():
    from fitv2_tpu_torch.cli.sample import _diffusion_config
    from fitv2_tpu_torch.utils import load_config
    return _diffusion_config(load_config([V1_CONFIG])['diffusion'])


def phase_fitv1_kernels(attention_cases):
    """Phase 12 (a): K2 in FiTv1's RoPE-only mode at the sampler's shape,
    bf16 and fp32, against its plain version at phase 3's gates, with its
    times and bound; then its Function (QKNormRope, norm_q=norm_k=False:
    the kernel forward, qk_norm_rope_backward) at the training shape
    (TRAIN_BATCH, N, H, DH) against autograd of the plain version
    (_grad_case). K3 without a mask at the sampler's shape is phase 3's
    attention[online, no mask] case, cited. Returns the kernel cases and
    the Function cases."""
    import torch
    from fitv2_tpu_torch import kernels as K
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    b2 = 2 * BATCH
    cases, grad_cases = [], []
    for dtype in (torch.bfloat16, torch.float32):
        qkv = torch.randn(b2, N, 3, H, DH, device=dev, generator=gen
                          ).to(dtype)
        q, k, _ = qkv.unbind(2)  # token stride 3C, as in a block
        ang = torch.rand(b2, N, DH, device=dev, generator=gen) * 6.3
        cases.append(dict(_qk_rope_case(K, q, k, torch.cos(ang),
                                        torch.sin(ang), norm=False),
                          path='fitv1'))
        qkv = torch.randn(TRAIN_BATCH, N, 3, H, DH, device=dev,
                          generator=gen).to(dtype)
        ang = torch.rand(TRAIN_BATCH, N, DH, device=dev, generator=gen) * 6.3
        cos, sin = torch.cos(ang), torch.sin(ang)

        def qk(fn, cos=cos, sin=sin):
            return lambda a: fn(*a.unbind(2)[:2], cos, sin, norm_q=False,
                                norm_k=False)
        grad_cases.append(dict(_grad_case(
            f'qk_rope RoPE-only ({TRAIN_BATCH},{N},{H},{DH})', dtype,
            qk(K.qk_norm_rope), qk(K.qk_norm_rope_reference), [qkv], 5,
            'norm'), mode='rope_only', path='fitv1'))
    for c in attention_cases:
        if (c['variant'], c['mask'], c['shape']) == ('online', False,
                                                     [b2, N, H, DH]):
            say(f'[fitv1] K3 (online softmax, no mask) at ({b2},{N},{H},'
                f'{DH}) {c["dtype"]}: phase 3\'s case, kernel '
                f'{c["us"]:.1f} us, plain {c["plain_us"]:.1f} us, bound '
                f'{c["bound_us"]:.1f} us, max abs err {c["max_abs_err"]:.3e}')
    torch.cuda.synchronize()
    return cases, grad_cases


def phase_fitv1_parity(model_cpu):
    """Phase 12 (b): one DDPM p_mean_variance of FiTv1-XL/2 in fp32 at the
    respaced ladder's mid index, batch 1, conditional: CUDA (kernels)
    against the CPU (plain versions) on the same weights and input; the
    mean's and the log-variance's relative L2."""
    import torch
    from fitv2_tpu_torch.models.grid_utils import make_grid_mask_size
    from fitv2_tpu_torch.sched import create_diffusion
    diffusion = create_diffusion(timestep_respacing=str(STEPS),
                                 **_v1_diffusion_config())
    g = torch.Generator().manual_seed(SEED + 11)
    x = torch.randn(1, N, 16, generator=g)
    t = torch.tensor([V1_PARITY_INDEX])
    outs = []
    for device in ('cpu', 'cuda'):
        model = model_cpu if device == 'cpu' else copy.deepcopy(
            model_cpu).to(device)
        grid, _, size = make_grid_mask_size(1, 16, 16, N, device)
        y = torch.tensor([207], device=device)

        def model_fn(xt, t_int, model=model, grid=grid, size=size, y=y):
            return model(xt, t_int.float(), y, grid, None, size)
        t0 = time.perf_counter()
        with torch.no_grad():
            out = diffusion.p_mean_variance(model_fn, x.to(device),
                                            t.to(device), clip_denoised=False)
        outs.append({k: v.cpu() for k, v in out.items()})
        secs = time.perf_counter() - t0
        if device == 'cpu':
            t_cpu = secs
        else:
            del model
    rels = {}
    for key in ('mean', 'log_variance'):
        want, got = outs[0][key], outs[1][key]
        if not torch.isfinite(got).all() or want.norm() == 0:
            raise AssertionError(f'fitv1 parity: {key} non-finite or zero')
        rels[key] = ((got - want).norm() / want.norm()).item()
    ok = all(r <= TOL_SLICE_REL_L2 for r in rels.values())
    say(f'[fitv1] FiTv1-XL fp32 depth {model_cpu.depth}, batch 1, '
        f'p_mean_variance at respaced index {V1_PARITY_INDEX} of {STEPS} '
        f'(model t {int(diffusion.timestep_map[V1_PARITY_INDEX])}): '
        f'relative L2 CUDA vs CPU mean {rels["mean"]:.3e}, log-variance '
        f'{rels["log_variance"]:.3e} <= {TOL_SLICE_REL_L2}: '
        f'{"ok" if ok else "FAIL"} (CPU {t_cpu:.1f} s)')
    if not ok:
        raise AssertionError(f'fitv1 parity: relative L2 {rels}')
    return rels


def phase_fitv1_sampling(model_bf16, vae, card, out_dir):
    """Phase 12 (c): FiTv1-XL/2 bf16, batch 8, 256x256, CFG 1.5, STEPS
    respaced steps, DDPM then DDIM: the denoise rate (no VAE; the median
    of V1_RATE_CALLS calls), then the
    user's call counted (VAE, uint8, npz): 57 K1, 28 K2 (RoPE only) and 28
    K3 launches a forward, no K4-K7."""
    import numpy as np
    import torch
    from fitv2_tpu_torch import kernels as K
    from fitv2_tpu_torch.sample import SamplingConfig, build_sampler
    labels = torch.arange(BATCH) * 111 % 1000
    z = torch.randn(BATCH, N, 16, generator=torch.Generator().manual_seed(
        SEED + 12))
    depth = model_bf16.depth
    want = _expected_counts(STEPS, depth, fused_qk_rope=1,
                            flash_masked_attention=1)
    counts, rates = {}, {}
    for mode in ('ddpm', 'ddim'):
        scfg = SamplingConfig(num_sampling_steps=STEPS, cfg_scale=CFG_SCALE,
                              per_device_batch=BATCH, dtype=torch.bfloat16,
                              sampler_mode=mode,
                              diffusion_config=_v1_diffusion_config())
        build_sampler(model_bf16, dataclasses.replace(
            scfg, num_sampling_steps=2))(labels, z=z)  # warm-up
        torch.cuda.synchronize()
        denoise = build_sampler(model_bf16, scfg)
        walls = []
        for _ in range(V1_RATE_CALLS):
            t0 = time.perf_counter()
            latents = denoise(labels, z=z,
                              generator=torch.Generator().manual_seed(1))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        t_denoise = statistics.median(walls)
        z_img = model_bf16.unpatchify(z.cuda(), (32, 32)).float()
        moved = ((latents - z_img).norm() / z_img.norm()).item()
        if not torch.isfinite(latents).all() or not moved > 1e-3:
            raise AssertionError(f'fitv1 {mode}: latents not finite or not '
                                 f'moved ({moved})')
        tag = f'fitv1_{mode}'
        t_full = _counted_pipeline(
            tag, model_bf16, scfg, vae, labels, z, want, out_dir=out_dir,
            build=lambda cfg: (lambda lab, z: build_sampler(
                model_bf16, cfg, vae)(lab, z=z, generator=torch.Generator(
                ).manual_seed(1))))
        counts[tag] = dict(_read_counts(), flash_masked_attention_bounded=(
            K.flash_masked_attention.bounded_launches))
        if counts[tag]['flash_masked_attention_bounded']:
            raise AssertionError(f'{tag}: K4 launched on a FiTv1 path')
        rates[mode] = dict(denoise=BATCH / t_denoise, full=BATCH / t_full,
                           denoise_range=[BATCH / max(walls),
                                          BATCH / min(walls)])
        say(f'[fitv1] FiTv1-XL/2 bf16 256x256 batch {BATCH}, {mode} {STEPS} '
            f'respaced steps, CFG {CFG_SCALE}: latents moved {moved:.3f}; '
            f'launches a forward K1 {2 * depth + 1}, K2 (RoPE only) {depth}, '
            f'K3 {depth}, K4-K7 0; denoise, the median of {len(walls)} '
            f'calls, {t_denoise:.3f} s = {BATCH / t_denoise:.4f} images/s '
            f'(calls {BATCH / max(walls):.4f}-{BATCH / min(walls):.4f}); '
            f'full pipeline, one counted call, {t_full:.3f} s = '
            f'{BATCH / t_full:.4f} images/s [{card}]')
    return counts, rates


def phase_fitv1_train(card, out_dir):
    """Phase 12 (d), in a child process with DETERMINISTIC_ENV:
    cli/train.py's build_trainer on configs/fit_xl.yaml with its depth cut
    to V1_TRAIN_DEPTH (batch 32, learn_sigma -> the ddpm objective over
    1000 steps, bf16 compute over fp32 masters) on phase 11's shards:
    V1_TRAIN_STEPS steps with a checkpoint at V1_TRAIN_RESUME, then a new
    trainer resumed from there, deterministic algorithms on; finite
    losses, the first mse in V1_FIRST_MSE, exact launch counts a step, ms
    a step (synced every step), peak memory, and the resumed run
    bit-identical to the uninterrupted one."""
    import shutil
    import torch
    from fitv2_tpu_torch.cli import train as cli
    cfg = _train_config(V1_CONFIG, out_dir, V1_TRAIN_RESUME, V1_TRAIN_DEPTH)
    run_dir = os.path.join(out_dir, 'train_fitv1')
    args = cli.parse_args(['--cfgdir', V1_CONFIG, '--output-dir', run_dir,
                           '--max-steps', str(V1_TRAIN_STEPS), '--device',
                           'cuda'])
    torch.use_deterministic_algorithms(True)
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.utils.deterministic.fill_uninitialized_memory = False
    mses = []
    try:
        trainer, state, losses, stamps, saves, counts, peak = _train_run(
            cli, cfg, args, False, mses=mses)
        if trainer.cfg.objective != 'ddpm':
            raise AssertionError(f'fitv1 train: objective '
                                 f'{trainer.cfg.objective}')
        batch, depth = trainer.cfg.global_batch_size, trainer.model.depth
        final = _snapshot(state)
        del trainer, state
        torch.cuda.empty_cache()
        shutil.rmtree(os.path.join(run_dir, 'checkpoints',
                                   f'checkpoint-{V1_TRAIN_STEPS}'))
        trainer, state, losses_b, _, _, counts_b, _ = _train_run(
            cli, cfg, args, True)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill
    if (len(losses) != V1_TRAIN_STEPS
            or not all(map(math.isfinite, losses + mses))):
        raise AssertionError(f'fitv1 train: losses {losses}, mse {mses}')
    first_ok = V1_FIRST_MSE[0] <= mses[0] <= V1_FIRST_MSE[1]
    say(f'[fitv1] FiTv1-XL/2 train (ddpm), depth {depth}, batch {batch}, '
        f'{V1_TRAIN_STEPS} steps: losses '
        f'{", ".join(f"{v:.4f}" for v in losses)}; mse '
        f'{", ".join(f"{v:.4f}" for v in mses)}')
    say(f'[fitv1] first mse {mses[0]:.4f} in {V1_FIRST_MSE} (an untrained '
        f'FiT outputs 0: E[eps^2] = 1): {"ok" if first_ok else "FAIL"}')
    if not first_ok:
        raise AssertionError(f'fitv1 train: first mse {mses[0]}')
    for label, got, steps in (('uninterrupted', counts, V1_TRAIN_STEPS),
                              ('resumed', counts_b,
                               V1_TRAIN_STEPS - V1_TRAIN_RESUME)):
        want = dict(_expected_counts(steps, depth, fused_qk_rope=1,
                                     flash_masked_attention=1),
                    flash_masked_attention_bounded=0)
        if got != want:
            raise AssertionError(f'fitv1 train {label}: launches {got} != '
                                 f'{want}')
        say(f'[fitv1] train {label} run, {steps} steps: launches {got} == '
            f'expected (a step: K1 {2 * depth + 1}, K2 {depth}, K3 {depth}; '
            'K4-K7 0)')
    if losses_b != losses[V1_TRAIN_RESUME:]:
        raise AssertionError(f'fitv1 train: resumed losses {losses_b} != '
                             f'{losses[V1_TRAIN_RESUME:]}')
    differ = _differ(state, final)
    if differ:
        say(f'[fitv1] resumed vs uninterrupted: {len(differ)} tensors '
            f'differ, e.g. {differ[:5]}')
        raise AssertionError('fitv1 train: the resumed run is not '
                             'bit-identical')
    saved = {st for st, _ in saves}
    step_ms = [(stamps[st] - stamps[st - 1]) * 1e3 for st in sorted(stamps)
               if st > 2 and st - 1 in stamps and st - 1 not in saved]
    ms = statistics.median(step_ms)
    say(f'[fitv1] resumed from step {V1_TRAIN_RESUME} to {V1_TRAIN_STEPS}: '
        'losses equal, parameters, EMA, mu and nu bit-identical')
    say(f'[fitv1] train step wall (deterministic algorithms on, a sync every '
        f'step) median of {len(step_ms)} steps after step 2 {ms:.2f} ms = '
        f'{batch / ms * 1e3:.2f} images/s; range {min(step_ms):.2f}-'
        f'{max(step_ms):.2f} ms; peak device memory {peak / 2 ** 30:.2f} GiB;'
        f' checkpoint saves '
        f'{", ".join(f"step {st}: {t:.2f} s" for st, t in saves)} [{card}]')
    return dict(counts=counts, counts_resumed=counts_b, ms_per_step=ms,
                peak_bytes=peak, first_mse=mses[0], losses=losses)


def _lwd_model_fp32(config, **overrides):
    """`config`'s network (the LwD family; `overrides` replace its params)
    built on the card in fp32 from the seeded CUDA generator (the host's
    init takes ~10 s at 0.9 B parameters), every adaLN output layer and
    final projection perturbed (untrained, its velocity is exactly 0 and
    parity would be vacuous)."""
    import torch
    from fitv2_tpu_torch.utils import config_to_model, load_config
    torch.manual_seed(SEED + 13)
    with torch.device('cuda'):
        model = config_to_model(load_config([config])['diffusion'][
            'network_config'], **overrides)
    gen = torch.Generator().manual_seed(SEED + 14)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if 'adaLN_modulation.fc_out' in name or (
                    name.startswith('final_layers.') and '.linear.' in name):
                p.add_(0.02 * torch.randn(p.shape, generator=gen).cuda())
    return model.cpu().eval()


def _lwd_parity(tag, model_cpu):
    """Phase 13 (a): one segment's forward_run_layer (the middle one, t in
    it), fp32, batch 2 (a class and the null class), full 16 x 16 grid: the
    port on CUDA (kernels) against the CPU (plain versions), the velocity
    and the REPA projection each within TOL_SLICE_REL_L2 relative L2.
    Returns the card's fp32 copy of the model."""
    import torch
    from fitv2_tpu_torch.models.grid_utils import make_grid_mask_size
    seg = model_cpu.number_of_perflow // 2
    sig = model_cpu.sigmas
    gen = torch.Generator().manual_seed(SEED + 15)
    x = torch.randn(2, N, 16, generator=gen)
    t = torch.tensor([0.25, 0.75]) * float(sig[seg + 1] - sig[seg]) \
        + float(sig[seg])
    y = torch.tensor([207, model_cpu.num_classes])
    grid, _, size = make_grid_mask_size(2, 16, 16, N)
    model_gpu = copy.deepcopy(model_cpu).to('cuda')
    with torch.no_grad():
        t0 = time.perf_counter()
        ref = model_cpu.forward_run_layer(x, t, y, seg, grid, None, size)
        t_cpu = time.perf_counter() - t0
        out = model_gpu.forward_run_layer(x.cuda(), t.cuda(), y.cuda(), seg,
                                          grid.cuda(), None, size.cuda())
    for what, o, r in zip(('velocity', 'REPA projection'), out, ref):
        if not torch.isfinite(o).all():
            raise AssertionError(f'{tag} parity: non-finite {what} on CUDA')
        norm = r.norm().item()
        if norm == 0.0:
            raise AssertionError(f'{tag} parity: zero {what} (vacuous)')
        rel = (o.cpu() - r).norm().item() / norm
        say(f'[lwd] {tag} fp32 forward_run_layer, segment {seg} of '
            f'{model_cpu.number_of_perflow}, batch 2: {what} |.| '
            f'{norm:.4e}, relative L2 CUDA vs CPU {rel:.3e} <= '
            f'{TOL_SLICE_REL_L2}: '
            f'{"ok" if rel <= TOL_SLICE_REL_L2 else "FAIL"} (CPU '
            f'{t_cpu:.1f} s)')
        if not rel <= TOL_SLICE_REL_L2:
            raise AssertionError(f'{tag} parity: {what} relative L2 {rel}')
    return model_gpu


def _lwd_counts(evals, per_eval):
    """Launch counts of `evals` velocity evals with `per_eval` launches of
    each named wrapper (the others 0); 'flash_masked_attention_bounded' is
    K4's share of the attention wrapper's."""
    from fitv2_tpu_torch import kernels as K
    want = {w.__name__: 0 for w in K.KERNEL_WRAPPERS}
    want['flash_masked_attention_bounded'] = 0
    want.update({name: evals * n for name, n in per_eval.items()})
    return want


def _lwd_read_counts():
    from fitv2_tpu_torch import kernels as K
    return dict(_read_counts(), flash_masked_attention_bounded=(
        K.flash_masked_attention.bounded_launches))


def _lwd_inputs(path):
    """Phase 13's starting tokens (on the CPU, seeded) and labels for
    `path` (the multi-scale sampler starts on the 4 x 4 grid)."""
    import torch
    n = N // 16 if path == 'lwd_multiscale' else N
    z = torch.randn(BATCH, n, 16,
                    generator=torch.Generator().manual_seed(SEED + 17))
    return z, torch.arange(BATCH) * 111 % 1000


def _lwd_sub_steps(path):
    return BFM_STEPS_PER_FLOW if path == 'bfm_xl' else LWD_STEPS_PER_FLOW


def _lwd_call(path, model, z, y, sub=None):
    """One sampler call of phase 13's `path`, `sub` sub-steps a segment
    (default the path's own); the same call as _lwd_cli_flags(path) asks
    of cli/sample_lwd. Returns the final tokens."""
    import torch
    sub = sub or _lwd_sub_steps(path)
    if path == 'lwd_xl':
        return model.sample_cfg(z, y, LWD_CFG_SCALE, sub)
    if path == 'lwd_multiscale':
        return model.sample_multiscale(
            z, y, sub, generator=torch.Generator().manual_seed(1))
    return model.sample_maruyama_cfg(
        z, y, LWD_CFG_SCALE, sub, *GUIDANCE, True,
        generator=torch.Generator().manual_seed(1))


def _lwd_cli_flags(path):
    """cli/sample_lwd's sampler flags for phase 13's `path` (_lwd_call's
    call)."""
    return ['--steps-per-flow', str(_lwd_sub_steps(path)), *{
        'lwd_xl': ['--sampler', 'cfg', '--cfg-scale', str(LWD_CFG_SCALE)],
        'lwd_multiscale': ['--sampler', 'multiscale'],
        'bfm_xl': ['--sampler', 'maruyama', '--self-guidance',
                   '--cfg-scale', str(LWD_CFG_SCALE), '--guidance-low',
                   str(GUIDANCE[0]), '--guidance-high', str(GUIDANCE[1])],
    }[path]]


def _lwd_denoise(path, model, z, y, calls=V1_RATE_CALLS):
    """A warm-up call of one sub-step a segment, then the median wall of
    `calls` timed _lwd_call(path, ...)s (each ended by a sync); checks the
    tokens are finite and moved. Returns (seconds, walls)."""
    import torch
    _lwd_call(path, model, z, y, 1)
    torch.cuda.synchronize()
    walls = []
    for _ in range(calls):
        t0 = time.perf_counter()
        out = _lwd_call(path, model, z, y)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    # the multi-scale sampler ends on a grid 16 times finer than z's
    moved = (((out - z).norm() / z.norm()).item() if out.shape == z.shape
             else float(out.shape == (len(z), N, z.shape[-1])))
    if not torch.isfinite(out).all() or not moved > 1e-3:
        raise AssertionError(f'{path}: tokens not finite, not moved or of '
                             f'the wrong shape ({moved}, {out.shape})')
    return statistics.median(walls), walls


def _lwd_cli(tag, argv, want, out_dir, batches=V1_RATE_CALLS):
    """Phase 13's user call: cli/sample_lwd.main(argv) on `batches`
    batches of BATCH, with every count set to 0 just before and read just
    after; checks the counts (`want` a batch) and the npz (uint8 256x256
    images). Returns (counts, the CLI's batch seconds: median, min, max,
    its whole sampling seconds with the npz, the call's wall)."""
    import numpy as np
    from fitv2_tpu_torch.cli import sample_lwd
    path = os.path.join(out_dir, f'{tag}.npz')
    n = batches * BATCH
    want = {name: batches * c for name, c in want.items()}
    buf = io.StringIO()
    _reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        sample_lwd.main([*argv, '--num-fid-samples', str(n),
                         '--per-device-batch', str(BATCH), '--out', path])
    wall = time.perf_counter() - t0
    counts = _lwd_read_counts()
    for line in buf.getvalue().splitlines():
        say(f'[lwd] {tag} cli: {line}')
    m = re.search(r'sampled \d+ in ([0-9.]+) s .*median ([0-9.]+) s, '
                  r'([0-9.]+)-([0-9.]+) s', buf.getvalue())
    secs, med, lo, hi = (float(v) for v in m.groups())
    arr = np.load(path)['arr_0']
    if arr.shape != (n, 256, 256, 3) or arr.dtype != np.uint8:
        raise AssertionError(f'{tag}: npz holds {arr.shape} {arr.dtype}')
    if counts != want:
        raise AssertionError(f'{tag}: launch counts {counts} != {want}')
    say(f'[lwd] {tag}: npz {arr.shape} {arr.dtype}, pixel mean '
        f'{arr.mean():.2f}; launches {counts} == expected')
    return counts, (med, lo, hi), secs, wall


def _lwd_kernel_cases(K):
    """Phase 13 (d): the kernels at the LwD paths' new shapes against their
    plain versions, bf16 and fp32, with times and bounds: K1, K2 and K4 at
    each grid of the multi-scale sampler (batch 8, no CFG, N 16, 64 and
    256, XL widths, every token valid); BFM's K1 (D 384) and K2 + K4 (6
    heads of Dh 64) at the CFG batch 16, N 256; BFM-XL's K3 on RMSNorm'd
    q/k (XL heads, CFG batch 16, N 256, unmasked)."""
    import torch
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    cases = {'adaln': [], 'qk_rope': [], 'attention': []}

    def norm_and_attention(path, dtype, b, n, d, h, dh):
        x = (torch.randn(b, n, d, device=dev, generator=gen) * 2 + 3
             ).to(dtype)
        mod = (0.5 * torch.randn(b, 6 * d, device=dev, generator=gen)
               ).to(dtype)
        shift, scale = mod.chunk(6, dim=-1)[:2]
        cases['adaln'].append(dict(_adaln_case(K, x, shift, scale),
                                   path=path))
        qkv = torch.randn(b, n, 3, h, dh, device=dev, generator=gen
                          ).to(dtype)
        q, k, v = qkv.unbind(2)
        ang = torch.rand(b, n, dh, device=dev, generator=gen) * 6.3
        cos, sin = torch.cos(ang), torch.sin(ang)
        cases['qk_rope'].append(dict(_qk_rope_case(K, q, k, cos, sin),
                                     path=path))
        qn, kn = K.qk_norm_rope_reference(q, k, cos, sin)
        cases['attention'].append(dict(
            _attention_case(K, dtype, qn, kn, v, None, True),
            shape=[b, n, h, dh], path=path))
        return q, k, v

    for dtype in (torch.bfloat16, torch.float32):
        for n in (16, 64, N):
            norm_and_attention('lwd_multiscale', dtype, BATCH, n, D, H, DH)
        norm_and_attention('bfm', dtype, 2 * BATCH, N, 384, 6, 64)
        q, k, v = (torch.randn(2 * BATCH, N, H, DH, device=dev,
                               generator=gen).to(dtype) for _ in range(3))

        def rms(a):  # BFM-XL's q/k norm (RMSNorm, its weight at 1)
            a32 = a.float()
            return (a32 * torch.rsqrt((a32 * a32).mean(-1, keepdim=True)
                                      + 1e-6)).to(dtype)
        cases['attention'].append(dict(
            _attention_case(K, dtype, rms(q), rms(k), v, None, False),
            shape=[2 * BATCH, N, H, DH], path='bfm_xl', qk_norm='rmsnorm'))
    torch.cuda.synchronize()
    return cases


def phase_lwd(card, out_dir, vae_path):
    """Phase 13: the LwD family on the card (see the module docstring).
    Returns the kernel cases and each path's counts."""
    import torch
    from fitv2_tpu_torch import kernels as K
    from fitv2_tpu_torch.ckpt import CheckpointManager
    bf16_yaml = os.path.join(out_dir, 'lwd_bf16.yaml')
    with open(bf16_yaml, 'w') as f:
        f.write('diffusion:\n  network_config:\n    params:\n'
                '      dtype: bfloat16\n')
    bfm_yaml = os.path.join(out_dir, 'bfm_xl_cut.yaml')
    with open(bfm_yaml, 'w') as f:
        f.write('diffusion:\n  network_config:\n    params:\n'
                '      dtype: bfloat16\n' + ''.join(
                    f'      {k}: {v}\n' for k, v in BFM_XL_CUT.items()))
    counts = {}

    def write_ckpt(tag, model_cpu):
        ckpt_dir = os.path.join(out_dir, f'{tag}_run')
        t0 = time.perf_counter()
        path = CheckpointManager(ckpt_dir).save(0, {
            'step': 0, 'ema_params': model_cpu.state_dict()})
        n = sum(p.numel() for p in model_cpu.parameters())
        say(f'[lwd] {tag}: a checkpoint of {n / 1e9:.3f} B fp32 parameters '
            f'written in {time.perf_counter() - t0:.1f} s')
        return path

    def run(path, cfgdir, model, ckpt, what, per_eval):
        """`path`'s denoise rate on `model`, then its CLI call on `ckpt`
        with exact counts (`per_eval` a velocity eval)."""
        z, y = (a.cuda() for a in _lwd_inputs(path))
        evals = model.number_of_perflow * _lwd_sub_steps(path)
        t_den, walls = _lwd_denoise(path, model, z, y)
        counts[path], (med, lo, hi), secs, wall = _lwd_cli(path, [
            '--cfgdir', *cfgdir, '--ckpt', ckpt, '--global-seed',
            str(SEED), '--vae', vae_path, '--device', 'cuda',
            *_lwd_cli_flags(path)], _lwd_counts(evals, per_eval), out_dir)
        n = V1_RATE_CALLS * BATCH
        say(f'[lwd] {path} bf16 256x256 batch {BATCH}, {what}: {evals} '
            f'velocity evals; denoise, the median of {len(walls)} calls, '
            f'{t_den:.3f} s = {BATCH / t_den:.4f} images/s (calls '
            f'{BATCH / max(walls):.4f}-{BATCH / min(walls):.4f}), '
            f'{t_den / evals * 1e3:.2f} ms an eval; full pipeline '
            f'(cli/sample_lwd: denoise + VAE + uint8 + the copy to the '
            f'host), the median of {V1_RATE_CALLS} batches, {med:.3f} s = '
            f'{BATCH / med:.4f} images/s (batches {BATCH / hi:.4f}-'
            f'{BATCH / lo:.4f}); the CLI\'s {n} images with the npz '
            f'{secs:.3f} s = {n / secs:.4f} images/s; the CLI call with the '
            f'model build and checkpoint load {wall:.1f} s [{card}]')

    # (a) + (b): FiTLwD-XL (configs/fitv2_xl_lwd.yaml), sample_cfg
    model_cpu = _lwd_model_fp32(LWD_CONFIG)
    model = _lwd_parity('lwd_xl', model_cpu)
    ckpt = write_ckpt('lwd_xl', model_cpu)
    del model_cpu
    model = model.to(torch.bfloat16)
    K_seg = model.number_of_perflow
    per_eval = dict(fused_adaln_norm=7, fused_qk_rope=3,
                    flash_masked_attention=3, flash_masked_attention_bounded=3)
    run('lwd_xl', [LWD_CONFIG, bf16_yaml], model, ckpt,
        f'sample_cfg, CFG {LWD_CFG_SCALE}, {K_seg} segments x '
        f'{LWD_STEPS_PER_FLOW} sub-steps; a CFG eval (batch {2 * BATCH}): '
        'K1 7, K2 3, K4 3', per_eval)
    # (d) the multi-scale sampler on the same model: 4x4 -> 8x8 -> 16x16
    run('lwd_multiscale', [LWD_CONFIG, bf16_yaml], model, ckpt,
        f'sample_multiscale, no CFG, N 16 -> 64 -> 256 over {K_seg} '
        f'segments x {LWD_STEPS_PER_FLOW} sub-steps; an eval (batch '
        f'{BATCH}): K1 7, K2 3, K4 3', per_eval)
    del model
    shutil.rmtree(os.path.dirname(ckpt))
    torch.cuda.empty_cache()

    # (a) + (c): BFM-XL (configs/bfm_xl.yaml cut to BFM_XL_CUT),
    # sample_maruyama_cfg with representation self-guidance in the guidance
    # window
    model_cpu = _lwd_model_fp32(BFM_XL_CONFIG, **BFM_XL_CUT)
    model = _lwd_parity('bfm_xl', model_cpu)
    ckpt = write_ckpt('bfm_xl', model_cpu)
    del model_cpu
    model = model.to(torch.bfloat16)
    depth_enc = model.number_of_representation_blocks
    depth_dec = model.layers_per_flow
    run('bfm_xl', [BFM_XL_CONFIG, bfm_yaml], model, ckpt,
        f'sample_maruyama_cfg, CFG {LWD_CFG_SCALE} and self-guidance for t '
        f'in {list(GUIDANCE)}, {model.number_of_perflow} segments x '
        f'{BFM_STEPS_PER_FLOW} sub-steps; an eval (batch {2 * BATCH}): K1 '
        f'{2 * depth_enc} (the encoder; the decoders and final layer take '
        f'per-token conditioning), K3 {depth_enc + depth_dec}, K2 and K4 0 '
        '(RMSNorm q/k)', dict(fused_adaln_norm=2 * depth_enc,
                              flash_masked_attention=depth_enc + depth_dec))
    del model
    shutil.rmtree(os.path.dirname(ckpt))
    torch.cuda.empty_cache()

    cases = _lwd_kernel_cases(K)
    return cases, counts


# -- phase 14: LwD training ---------------------------------------------------

def _lwd_train_yaml(out_dir, resume_step, depth=None):
    """The YAML merged after configs/fitv2_xl_lwd.yaml on phase 14's main
    path: bf16 compute, the synthetic shards, a checkpoint at
    `resume_step`; with `depth`, the trunk cut to it (12 segments of
    depth / 12 blocks)."""
    path = os.path.join(out_dir, f'lwd_train_{depth}.yaml')
    with open(path, 'w') as f:
        f.write('diffusion:\n  network_config:\n    params:\n'
                '      dtype: bfloat16\n'
                + (f'      depth: {depth}\n' if depth else '') +
                'data:\n  params:\n    train:\n'
                f'      data_path: {os.path.join(out_dir, "lwd_latents")}\n'
                f'accelerate:\n  checkpointing_steps: {resume_step}\n')
    return [LWD_CONFIG, path]


def _lwd_update_counts(model, recipe='reflow', teacher_depth=0,
                       solver_steps=0):
    """Exact launch counts of one segment update's forward (the wrappers
    count forward launches; the backward passes are PyTorch): K1 twice a
    block with (B, D) conditioning and once in such a final layer; K2 and
    K4 once a block with no-affine LayerNorm q/k, K3 with RMSNorm q/k; a
    distillation teacher's forwards (a FiT of `teacher_depth`, K1 K2 K4)
    `solver_steps` times."""
    from fitv2_tpu_torch.models import FiTLwDSharedEncSepDec
    if isinstance(model, FiTLwDSharedEncSepDec):
        enc, dec = model.number_of_representation_blocks, \
            model.layers_per_flow
        mid = model.number_of_mid_blocks
        k1, blocks = 2 * enc, enc + dec
        if recipe == 'finetune':  # the encoder and a decoder twice
            k1, blocks = 4 * enc, 2 * enc + mid + 2 * dec
    else:
        blocks = (model.layers_per_flow + model.rep_layers_per_flow
                  + model.number_of_shared_blocks)
        k1 = 2 * blocks + 1
    block = model.segments[0][0].attn
    ln = block.bounded
    want = {'fused_adaln_norm': k1, 'fused_qk_rope': blocks if ln else 0,
            'flash_masked_attention': blocks,
            'flash_masked_attention_bounded': blocks if ln else 0}
    if teacher_depth:
        for k, n in (('fused_adaln_norm', 2 * teacher_depth + 1),
                     ('fused_qk_rope', teacher_depth),
                     ('flash_masked_attention', teacher_depth),
                     ('flash_masked_attention_bounded', teacher_depth)):
            want[k] += solver_steps * n
    return want


def phase_lwd_train_kernels():
    """Phase 14 (a): K1, K2 and K4 inside their autograd Functions at the
    multi-scale training tiers' grids (N 16 and 64, batch TRAIN_BATCH, XL
    widths, every token valid) and K3's at BFM-XL's shape (RMSNorm'd q/k,
    batch TRAIN_BATCH, N 256, 16 heads of 72, unmasked), bf16 and fp32,
    with phase 11's _grad_case (forward at phase 3's gates, gradients
    against plain autograd: fp32 1e-5, bf16 3e-2 of the largest; the
    times the median of LWD_TRAIN_REPS calls)."""
    import torch
    from fitv2_tpu_torch import kernels as K
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    b = TRAIN_BATCH
    cases = {'adaln': [], 'qk_rope': [], 'attention': []}
    for dtype in (torch.bfloat16, torch.float32):
        for n in LWD_TRAIN_GRIDS:
            path = 'lwd_multiscale_train'
            x = (torch.randn(b, n, D, device=dev, generator=gen) * 2 + 3
                 ).to(dtype)
            mod = (0.5 * torch.randn(b, 6 * D, device=dev, generator=gen)
                   ).to(dtype)

            def adaln(fn):
                return lambda a, m: fn(a, *m.chunk(6, dim=-1)[:2])
            cases['adaln'].append(dict(_grad_case(
                f'adaln ({b},{n},{D})', dtype, adaln(K.adaln_norm),
                adaln(K.adaln_norm_reference), [x, mod], 1, 'norm',
                LWD_TRAIN_REPS), path=path))
            qkv = torch.randn(b, n, 3, H, DH, device=dev, generator=gen
                              ).to(dtype)
            ang = torch.rand(b, n, DH, device=dev, generator=gen) * 6.3
            cos, sin = torch.cos(ang), torch.sin(ang)

            def qk(fn):
                return lambda a: fn(*a.unbind(2)[:2], cos, sin)
            cases['qk_rope'].append(dict(_grad_case(
                f'qk_rope ({b},{n},{H},{DH})', dtype, qk(K.qk_norm_rope),
                qk(K.qk_norm_rope_reference), [qkv], 2, 'norm',
                LWD_TRAIN_REPS), path=path))
            q, k, v = qkv.unbind(2)
            qkv_n = torch.stack([*K.qk_norm_rope_reference(q, k, cos, sin),
                                 v], dim=2)
            cases['attention'].append(dict(_grad_case(
                f'attention[bounded,no mask] ({b},{n},{H},{DH})', dtype,
                lambda a: K.masked_attention(*a.unbind(2), None,
                                             bounded_logits=True),
                lambda a: K.attention_bounded_reference(*a.unbind(2)),
                [qkv_n], 3, 'attention', LWD_TRAIN_REPS), variant='bounded',
                mask=False, path=path))
        qkv = torch.randn(b, N, 3, H, DH, device=dev, generator=gen)
        qkv[:, :, :2] *= torch.rsqrt((qkv[:, :, :2] ** 2).mean(
            -1, keepdim=True) + 1e-6)  # RMSNorm, its weight at 1
        cases['attention'].append(dict(_grad_case(
            f'attention[online,no mask,RMSNorm q/k] ({b},{N},{H},{DH})',
            dtype, lambda a: K.masked_attention(*a.unbind(2), None,
                                                bounded_logits=False),
            lambda a: K.attention_reference(*a.unbind(2), None),
            [qkv.to(dtype)], 4, 'attention', LWD_TRAIN_REPS),
            variant='online', mask=False, path='bfm_xl_train',
            qk_norm='rmsnorm'))
    torch.cuda.synchronize()
    return cases


def phase_lwd_train_parity():
    """Phase 14 (b): one fp32 FiTLwD-XL reflow segment update
    (configs/fitv2_xl_lwd.yaml cut to LWD_DET_DEPTH, 12 segments of one
    block, as (c)'s deterministic run; perturbed seeded weights,
    batch LWD_PARITY_BATCH on the 16 x 16 grid, the middle segment, label
    drops) on CUDA (kernels, their Functions' backward, the update over
    every parameter) and on the CPU (plain versions) with the same draws:
    the loss and gradient norm, every updated master and every first
    moment (0.1 g) within TOL_SLICE_REL_L2 relative L2."""
    import torch
    from fitv2_tpu_torch.models.grid_utils import make_grid_mask_size
    from fitv2_tpu_torch.train import (
        OptimizerConfig, create_train_state, make_lwd_train_step)
    with _clock('phase 14 (b) FiTLwD-XL built'):
        model = _lwd_model_fp32(LWD_CONFIG, depth=LWD_DET_DEPTH)
    seg = model.number_of_perflow // 2
    b = LWD_PARITY_BATCH
    gen = torch.Generator().manual_seed(SEED + 31)
    grid, mask, size = make_grid_mask_size(b, 16, 16, N)
    batch = dict(feature=torch.randn(b, N, 16, generator=gen), grid=grid,
                 mask=mask, label=torch.tensor([207, 360, 1, 999][:b]),
                 size=size)
    draws = dict(x0=torch.randn(b, N, 16, generator=gen),
                 r=torch.rand(b, generator=gen),
                 drop_ids=torch.tensor([0, 1, 0, 0][:b]))
    models = {'cuda': copy.deepcopy(model).to('cuda'), 'cpu': model}
    out = {}
    for device in ('cuda', 'cpu'):
        m = models.pop(device)
        state = create_train_state(m, OptimizerConfig(learning_rate=1e-4))
        step = make_lwd_train_step(m)
        _reset_counts()
        t0 = time.perf_counter()
        _, metrics = step(state, {k: v.to(device) for k, v in batch.items()},
                          seg, draws={k: v.to(device)
                                      for k, v in draws.items()})
        if device == 'cuda':
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out[device] = (metrics, state, _lwd_read_counts(), secs)
        del m, step
    (m_gpu, s_gpu, counts, t_gpu), (m_cpu, s_cpu, _, t_cpu) = \
        out['cuda'], out['cpu']
    want = _lwd_counts(1, _lwd_update_counts(model))
    if counts != want:
        raise AssertionError(f'lwd train parity: launches {counts} != {want}')
    rels = {}
    for key in ('loss', 'grad_norm'):
        a, r = m_gpu[key].item(), m_cpu[key].item()
        rels[key] = abs(a - r) / abs(r)
    worst = {'masters': (0.0, ''), 'mu': (0.0, '')}
    for n, p in s_cpu.params.items():
        q = s_gpu.params[n]
        pairs = (('masters', q, p), ('mu', s_gpu.optimizer.state[q]['mu'],
                                     s_cpu.optimizer.state[p]['mu']))
        for what, o, r in pairs:
            norm = r.norm().item()
            rel = (o.cpu() - r).norm().item() / norm if norm else \
                o.abs().max().item()
            worst[what] = max(worst[what], (rel, n))
    ok = (max(rels.values()) <= TOL_SLICE_REL_L2
          and all(v <= TOL_SLICE_REL_L2 for v, _ in worst.values()))
    touched = sum(1 for p in s_cpu.params.values()
                  if s_cpu.optimizer.state[p]['mu'].any())
    n_params = sum(p.numel() for p in s_cpu.params.values())
    say(f'[lwd-train] FiTLwD-XL fp32 (depth {model.depth}, '
        f'{n_params / 1e9:.3f} B parameters), one reflow '
        f'update of segment {seg}, batch {b}, CUDA vs CPU: loss '
        f'{m_gpu["loss"].item():.6f} vs {m_cpu["loss"].item():.6f} '
        f'(relative {rels["loss"]:.3e}), grad norm relative '
        f'{rels["grad_norm"]:.3e}; worst master relative L2 '
        f'{worst["masters"][0]:.3e} ({worst["masters"][1]}), worst first '
        f'moment (0.1 g) {worst["mu"][0]:.3e} ({worst["mu"][1]}) <= '
        f'{TOL_SLICE_REL_L2}: {"ok" if ok else "FAIL"}; {touched} of '
        f'{len(s_cpu.params)} tensors got a nonzero gradient; launches '
        f'{counts} == expected; the update took {t_gpu:.2f} s on CUDA '
        f'(first call), {t_cpu:.1f} s on the CPU')
    if not ok:
        raise AssertionError(f'lwd train parity: {rels}, {worst}')
    return dict(rels, masters=worst['masters'][0], mu=worst['mu'][0])


def _lwd_train_run(cli, cfg, args, resume, log_every=1, write=True,
                   skip=()):
    """One LwDTrainer run of phase 14 (c) from cli/train_lwd.py's
    build_trainer: the segments and losses of every update, the wall time
    at each logged batch (after a sync), the checkpoint saves (none are
    written unless `write`, and none at the batches in `skip`), the peak
    device memory and the launch counts.
    Checks bf16 compute over fp32 masters, an fp32 first moment and a
    constant learning rate (JAX's make_optimizer)."""
    import torch
    torch.manual_seed(SEED)  # the initial weights
    with _clock('phase 14 (c) cli/train_lwd build_trainer'):
        trainer = cli.build_trainer(cfg, args)
    trainer.cfg.log_every = log_every
    if (trainer.model.dtype != torch.bfloat16 or any(
            p.dtype != torch.float32
            for p in trainer.master_model.parameters())
            or trainer.optimizer_config.mu_dtype is not None
            or trainer.optimizer_config.lr_schedule is not None):
        raise AssertionError('lwd train: expected bf16 compute over fp32 '
                             'masters, an fp32 mu and a constant lr')
    segments, losses, stamps, saves = [], [], {}, []
    step_fn, save_fn = trainer._train_step, trainer.ckpt.save

    def step(state, batch, seg, generator=None, draws=None):
        segments.append(seg)
        state, metrics = step_fn(state, batch, seg, generator, draws)
        losses.append(metrics['loss'])
        return state, metrics

    def save(step, state_dict):
        t0 = time.perf_counter()
        path = save_fn(step, state_dict) if write and step not in skip \
            else None
        saves.append((step, time.perf_counter() - t0))
        return path

    def hook(step, metrics):
        torch.cuda.synchronize()
        stamps[step] = time.perf_counter()

    trainer._train_step, trainer.ckpt.save = step, save
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    stamps[0] = time.perf_counter()
    with _clock(f'phase 14 (c) train ({"resumed" if resume else "from 0"})'):
        state = trainer.train(max_steps=args.max_steps, resume=resume,
                              metric_hook=hook)
        torch.cuda.synchronize()
    counts = _lwd_read_counts()
    peak = torch.cuda.max_memory_allocated()
    return (trainer, state, segments, [v.item() for v in losses], stamps,
            saves, counts, peak)


def phase_lwd_train_deterministic(card, out_dir):
    """Phase 14 (c), in a child process with DETERMINISTIC_ENV:
    cli/train_lwd.py's build_trainer on configs/fitv2_xl_lwd.yaml with a
    merged bf16 YAML (FiTLwD-XL cut to LWD_DET_DEPTH: 12 segments of 1
    block, 12 REPA blocks,
    batch 32, the native loader) on LWD_SHARDS synthetic square shards:
    LWD_TRAIN_BATCHES batches of 3 segment updates with a checkpoint at
    LWD_TRAIN_RESUME, then a new trainer resumed from it, deterministic
    algorithms on: the segments, losses, exact launch counts, and the
    resumed run's parameters, EMA and moments bit-identical to the
    uninterrupted run's."""
    import torch
    from fitv2_tpu_torch.cli import train_lwd as cli
    from fitv2_tpu_torch.data import make_synthetic_latent_shards
    from fitv2_tpu_torch.utils import load_config
    make_synthetic_latent_shards(os.path.join(out_dir, 'lwd_latents'),
                                 n=LWD_SHARDS, target_len=N, seed=SEED,
                                 square=True)
    cfgdir = _lwd_train_yaml(out_dir, LWD_TRAIN_RESUME,
                             depth=LWD_DET_DEPTH)
    run_dir = os.path.join(out_dir, 'lwd_train')
    args = cli.parse_args(['--cfgdir', *cfgdir, '--output-dir', run_dir,
                           '--max-steps', str(LWD_TRAIN_BATCHES),
                           '--device', 'cuda'])
    cfg = load_config(cfgdir)
    torch.use_deterministic_algorithms(True)
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        # the uninterrupted run writes only the checkpoint the resumed run
        # starts from (the trainer's last save is the resumed run's)
        trainer, state, segs, losses, stamps, saves, counts, peak = \
            _lwd_train_run(cli, cfg, args, False,
                           skip=(LWD_TRAIN_BATCHES,))
        spp = trainer.cfg.segments_per_step
        batch = trainer.cfg.global_batch_size
        per_update = _lwd_update_counts(trainer.model)
        n_params = sum(p.numel() for p in state.params.values())
        with _clock('phase 14 (c) the state to the host'):
            final, state_step = _snapshot(state), state.step
        del trainer, state
        torch.cuda.empty_cache()
        ckpts = sorted(os.listdir(os.path.join(run_dir, 'checkpoints')))
        if ckpts != [f'checkpoint-{LWD_TRAIN_RESUME}']:
            raise AssertionError(f'lwd train: checkpoints {ckpts}')
        # cli/sample_lwd reads checkpoint-LWD_TRAIN_RESUME: the resumed
        # run's last save is not written either
        _, state_b, segs_b, losses_b, _, _, counts_b, _ = \
            _lwd_train_run(cli, cfg, args, True, skip=(LWD_TRAIN_BATCHES,))
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill
    updates = LWD_TRAIN_BATCHES * spp
    if (len(losses) != updates or not all(map(math.isfinite, losses))
            or state_step != updates):
        raise AssertionError(f'lwd train: losses {losses}, step {state_step}')
    say(f'[lwd-train] FiTLwD-XL bf16 (fp32 masters, fp32 mu, fp32 EMA; '
        f'{n_params / 1e9:.3f} B parameters), batch {batch}, '
        f'{LWD_TRAIN_BATCHES} batches x {spp} segment updates, native loader '
        f'over {LWD_SHARDS} square shards: segments {segs}, losses '
        f'{", ".join(f"{v:.4f}" for v in losses)}; peak device memory '
        f'{peak / 2 ** 30:.2f} GiB; the checkpoint at batch '
        f'{LWD_TRAIN_RESUME} written in {dict(saves)[LWD_TRAIN_RESUME]:.2f} s '
        f'[{card}]')
    for label, got, n in (('uninterrupted', counts, updates),
                          ('resumed', counts_b,
                           (LWD_TRAIN_BATCHES - LWD_TRAIN_RESUME) * spp)):
        want = _lwd_counts(n, per_update)
        if got != want:
            raise AssertionError(f'lwd train {label}: launches {got} != '
                                 f'{want}')
        say(f'[lwd-train] {label} run, {n} segment updates: launches {got} '
            f'== expected (an update: {per_update})')
    resumed_from = LWD_TRAIN_RESUME * spp
    if segs_b != segs[resumed_from:] or losses_b != losses[resumed_from:]:
        raise AssertionError(f'lwd train: resumed segments {segs_b} / '
                             f'losses {losses_b} != {segs[resumed_from:]} / '
                             f'{losses[resumed_from:]}')
    with _clock('phase 14 (c) the states compared'):
        differ = _differ(state_b, final)
    if differ:
        say(f'[lwd-train] resumed vs uninterrupted: {len(differ)} tensors '
            f'differ, e.g. {differ[:5]}')
        raise AssertionError('lwd train: the resumed run is not '
                             'bit-identical')
    say(f'[lwd-train] resumed from batch {LWD_TRAIN_RESUME} to '
        f'{LWD_TRAIN_BATCHES}: the segment stream replayed ({segs_b}), '
        f'losses equal, and parameters, EMA, mu and nu bit-identical to the '
        f'uninterrupted run (deterministic algorithms on)')
    return dict(counts=counts, counts_resumed=counts_b, peak_bytes=peak,
                losses=losses, segments=segs)


def _busy_split(step, model):
    """torch.profiler over one call of `step` (a segment update), its device
    busy time (the union of kernel and copy intervals) split by the phase
    that launched the work: forward (the model's forward_run_layer),
    backward (loss.backward()), the update (what follows the backward: the
    gradients into the masters, the zero gradients, norm, clip, AdamW, EMA)
    and the rest (the draws, the master -> bf16 copy, the loss). Each part
    ends with a synchronisation inside its range, so its device work lies
    within it. Returns (ms by part, the profiled wall ms, launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    forward, backward = model.forward_run_layer, torch.Tensor.backward

    def fwd(*a, **k):
        torch.cuda.synchronize()
        with record_function('phase14:forward'):
            out = forward(*a, **k)
            torch.cuda.synchronize()
        return out

    def bwd(self, *a, **k):
        torch.cuda.synchronize()
        with record_function('phase14:backward'):
            backward(self, *a, **k)
            torch.cuda.synchronize()

    model.forward_run_layer, torch.Tensor.backward = fwd, bwd
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with record_function('phase14:step'):
                step()
                torch.cuda.synchronize()
            window = (time.perf_counter() - t0) * 1e3
    finally:
        del model.forward_run_layer
        torch.Tensor.backward = backward
    ranges, spans = {}, []
    for evt in prof.events():
        if evt.name.startswith('phase14:'):  # the host's range, not the
            if evt.device_type == torch.autograd.DeviceType.CPU:  # device's
                ranges[evt.name[len('phase14:'):]] = (evt.time_range.start,
                                                      evt.time_range.end)
        elif evt.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((evt.time_range.start, evt.time_range.end))
    if not spans or set(ranges) != {'forward', 'backward', 'step'}:
        raise RuntimeError(f'busy split: no device activity or ranges '
                           f'{sorted(ranges)}')

    def part(start):
        if ranges['forward'][0] <= start < ranges['forward'][1]:
            return 'forward'
        if ranges['backward'][0] <= start < ranges['backward'][1]:
            return 'backward'
        if ranges['backward'][1] <= start < ranges['step'][1]:
            return 'update'
        return 'rest'

    busy, ends, launches = {}, {}, 0
    for start, stop in sorted(spans):
        p = part(start)
        launches += 1
        end = ends.get(p, float('-inf'))
        if stop > end:
            busy[p] = busy.get(p, 0.0) + (stop - max(start, end)) / 1e3
            ends[p] = stop
    return {p: busy.get(p, 0.0) for p in ('forward', 'backward', 'update',
                                          'rest')}, window, launches


def phase_lwd_train(card, out_dir):
    """Phase 14 (see the module docstring). Returns the kernel cases and
    each path's counts."""
    import numpy as np
    import torch
    from fitv2_tpu_torch.cli import sample_lwd
    from fitv2_tpu_torch.cli import train_lwd as cli
    from fitv2_tpu_torch.data import INLatentLoader
    from fitv2_tpu_torch.train import (
        OptimizerConfig, create_train_state, make_lwd_distill_step,
        make_lwd_finetune_step, make_lwd_multiscale_train_step,
        make_lwd_train_step)
    from fitv2_tpu_torch.train.lwd_train_step import FINETUNE_MODES
    from fitv2_tpu_torch.train.trainer import step_generator
    from fitv2_tpu_torch.utils import load_config
    with _clock('phase 14 (a) Functions'):
        cases = phase_lwd_train_kernels()
    with _clock('phase 14 (b) parity'):
        parity = phase_lwd_train_parity()
    torch.cuda.empty_cache()
    with _clock('phase 14 (c) the deterministic child'):
        det = _run_child_phase(('lwd_train',), out_dir)['lwd_train']
    counts = {'lwd_train': det['counts'],
              'lwd_train_resumed': det['counts_resumed']}

    # (c) the rate: a third run, deterministic algorithms off, a sync
    # after every batch, no checkpoint written
    cfgdir = _lwd_train_yaml(out_dir, LWD_TRAIN_RESUME)
    timed = LWD_TRAIN_WARM + LWD_TRAIN_TIMED
    args = cli.parse_args(['--cfgdir', *cfgdir, '--output-dir',
                           os.path.join(out_dir, 'lwd_timed'),
                           '--max-steps', str(timed), '--device', 'cuda'])
    trainer, state, segs, losses, stamps, _, counts_t, peak = \
        _lwd_train_run(cli, load_config(cfgdir), args, False, write=False)
    spp, batch = trainer.cfg.segments_per_step, trainer.cfg.global_batch_size
    per_update = _lwd_update_counts(trainer.model)
    if counts_t != _lwd_counts(timed * spp, per_update) or not all(
            map(math.isfinite, losses)):
        raise AssertionError(f'lwd train timed run: launches {counts_t}, '
                             f'losses {losses}')
    walls = [(stamps[s] - stamps[s - 1]) * 1e3
             for s in range(LWD_TRAIN_WARM + 1, timed + 1)]
    ms = statistics.median(walls)
    say(f'[lwd-train] rate, deterministic algorithms off, a sync after '
        f'every batch: batches {LWD_TRAIN_WARM + 1}-{timed}, the median '
        f'batch of {spp} segment updates {ms:.2f} ms (range '
        f'{min(walls):.2f}-{max(walls):.2f}) = {batch / ms * 1e3:.2f} '
        f'images/s = {spp / ms * 1e3:.2f} segment updates/s; peak device '
        f'memory {peak / 2 ** 30:.2f} GiB; launches {counts_t} == expected '
        f'[{card}]')
    counts['lwd_train_timed'] = counts_t

    # cli/sample_lwd on the deterministic run's checkpoint
    ckpt = os.path.join(out_dir, 'lwd_train', 'checkpoints',
                        f'checkpoint-{LWD_TRAIN_RESUME}')
    npz = os.path.join(out_dir, 'lwd_train_samples.npz')
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf), _clock(
            'phase 14 (c) cli/sample_lwd'):
        sample_lwd.main(['--cfgdir', *_lwd_train_yaml(
                            out_dir, LWD_TRAIN_RESUME, depth=LWD_DET_DEPTH),
                         '--ckpt', ckpt, '--sampler',
                         'cfg', '--cfg-scale', str(LWD_CFG_SCALE),
                         '--steps-per-flow', '1', '--num-fid-samples',
                         str(BATCH), '--per-device-batch', str(BATCH),
                         '--global-seed', str(SEED), '--device', 'cuda',
                         '--out', npz])
    arr = np.load(npz)['arr_0']
    if arr.shape != (BATCH, 32, 32, 4) or not np.isfinite(arr).all():
        raise AssertionError(f'lwd train: sampled {arr.shape}')
    say(f'[lwd-train] cli/sample_lwd on checkpoint-{LWD_TRAIN_RESUME} '
        f'(its ema_params, bf16, sample_cfg, one sub-step a segment): '
        f'latents {arr.shape}, finite, std {arr.std():.4f}, in '
        f'{time.perf_counter() - t0:.1f} s with the checkpoint read '
        f'(depth {LWD_DET_DEPTH})')

    # (d) one multi-scale update per tier on the timed run's state
    loader = INLatentLoader(os.path.join(out_dir, 'lwd_latents'), N,
                            batch_size=batch, num_workers=4)
    batch_t = {k: torch.from_numpy(v).cuda() for k, v in next(iter(
        loader.train_dataloader(batch, 1, 0, SEED))).items()}
    model = trainer.model
    ms_step = make_lwd_multiscale_train_step(
        model, multi_scale_indices=LWD_MS_INDICES)
    _reset_counts()
    tiers = []
    for seg in LWD_MS_SEGMENTS:
        _, m = ms_step(state, batch_t, seg, step_generator(SEED, state.step))
        tiers.append((seg, int(m['tier'].item()), m['loss'].item()))
    counts['lwd_multiscale_train'] = _lwd_read_counts()
    want = _lwd_counts(len(LWD_MS_SEGMENTS), per_update)
    if counts['lwd_multiscale_train'] != want or [t for _, t, _ in tiers] \
            != list(range(len(LWD_MS_SEGMENTS))) or not all(
            math.isfinite(v) for *_, v in tiers):
        raise AssertionError(f'lwd multiscale train: {tiers}, '
                             f'{counts["lwd_multiscale_train"]}')
    say(f'[lwd-train] multi-scale, one update per tier (segment, tier, '
        f'loss): {tiers} at N 16, 64, 256; launches '
        f'{counts["lwd_multiscale_train"]} == expected')

    # (f) the busy split of one FiTLwD-XL reflow update (bf16, batch 32)
    step = trainer._train_step
    seg = model.number_of_perflow // 2
    split, window, launches = _busy_split(lambda: step(
        state, batch_t, seg, step_generator(SEED, state.step)), model)
    busy = sum(split.values())
    say(f'[lwd-train] busy split of one FiTLwD-XL segment update (bf16, '
        f'batch {batch}, segment {seg}; torch.profiler, a sync closing '
        f'each part): forward {split["forward"]:.3f} ms, backward '
        f'{split["backward"]:.3f} ms, the update over all '
        f'{sum(p.numel() for p in state.params.values()) / 1e9:.3f} B '
        f'parameters {split["update"]:.3f} ms, the rest {split["rest"]:.3f}'
        f' ms; busy {busy:.3f} of a {window:.3f} ms window, {launches} '
        f'device records [{card}]')
    del trainer, state, model, step, ms_step
    torch.cuda.empty_cache()

    t_e = time.perf_counter()
    # (e) configs/bfm.yaml as it stands (fp32): a reflow update, one
    # finetune update per mode (the shared encoder unchanged), a
    # distillation update from a seeded FiT teacher of depth 2 (XL widths)
    bfm = _lwd_model_fp32('configs/bfm.yaml').cuda()
    teacher = _xl_model_fp32(LWD_TEACHER_DEPTH).cuda().requires_grad_(False)

    def teacher_apply(x, t, b):
        return teacher(x, t, b['label'], b['grid'], b['mask'],
                       b['size']).float()

    runs = [('reflow', make_lwd_train_step(bfm), {})]
    runs += [(f'finetune {mode}', make_lwd_finetune_step(bfm, mode=mode),
              {'recipe': 'finetune'}) for mode in FINETUNE_MODES]
    runs.append(('distillation', make_lwd_distill_step(
        bfm, teacher_apply, LWD_SOLVER_STEPS), dict(
            teacher_depth=LWD_TEACHER_DEPTH, solver_steps=LWD_SOLVER_STEPS)))
    seg = bfm.number_of_perflow // 2
    bfm_counts = {}
    for label, fn, kw in runs:
        state = create_train_state(bfm, OptimizerConfig(learning_rate=1e-4))
        enc = {n: p.detach().clone() for n, p in bfm.named_parameters()
               if n.startswith('shared_rep_blocks.')}
        _reset_counts()
        _, m = fn(state, batch_t, seg, step_generator(SEED, 0))
        got = _lwd_read_counts()
        want = _lwd_counts(1, _lwd_update_counts(bfm, **kw))
        if got != want or not math.isfinite(m['loss'].item()):
            raise AssertionError(f'bfm {label}: launches {got} != {want}, '
                                 f'loss {m["loss"]}')
        if kw.get('recipe') == 'finetune' and not all(
                torch.equal(p, enc[n]) for n, p in bfm.named_parameters()
                if n in enc):
            raise AssertionError(f'bfm {label}: the shared encoder moved')
        bfm_counts[label] = got
        say(f'[lwd-train] BFM (configs/bfm.yaml, fp32, batch {batch}) '
            f'{label} update of segment {seg}: loss {m["loss"].item():.4f}, '
            f'grad norm {m["grad_norm"].item():.4f}'
            + ('; the shared encoder unchanged'
               if kw.get('recipe') == 'finetune' else '')
            + f'; launches {got} == expected')
    counts['bfm_train'] = {k: sum(c[k] for c in bfm_counts.values())
                           for k in bfm_counts['reflow']}
    del bfm, teacher, runs, state
    torch.cuda.empty_cache()

    # K3's Function backward on a model path: BFM-XL's widths (RMSNorm q/k,
    # 'normal' adaLN) cut to 2 encoder blocks and 6 decoders of 1 block
    bfm_xl = _lwd_model_fp32(BFM_XL_CONFIG, depth=6,
                             number_of_representation_blocks=2).cuda()
    state = create_train_state(bfm_xl, OptimizerConfig(learning_rate=1e-4))
    _reset_counts()
    _, m = make_lwd_train_step(bfm_xl)(state, batch_t, 3,
                                       step_generator(SEED, 0))
    counts['bfm_xl_train'] = _lwd_read_counts()
    want = _lwd_counts(1, _lwd_update_counts(bfm_xl))
    if counts['bfm_xl_train'] != want or not math.isfinite(m['loss'].item()):
        raise AssertionError(f'bfm_xl train: {counts["bfm_xl_train"]}')
    say(f'[lwd-train] BFM-XL widths (RMSNorm q/k), depth cut to 2 encoder '
        f'blocks + 6 decoders of 1, fp32, batch {batch}: one reflow update '
        f'(K3 forward and its Function backward in 3 blocks), loss '
        f'{m["loss"].item():.4f}; launches {counts["bfm_xl_train"]} == '
        f'expected')
    del bfm_xl, state
    torch.cuda.empty_cache()
    say(f'[time] phase 14 (e) BFM recipes: {time.perf_counter() - t_e:.1f} s')
    return cases, counts, dict(parity=parity, ms_per_batch=ms,
                               busy_split=split)


def _rel_l2(got, ref):
    """|got - ref| / |ref| over a tensor, in fp64 on the host."""
    got, ref = got.detach().double().cpu(), ref.detach().double().cpu()
    return ((got - ref).norm() / ref.norm()).item()


def _hr_train_batch(gen):
    """Phase 15 (a)'s batch on the CPU: a full 32 x 32 grid and a padded
    20 x 40 one (800 of HR_N tokens), and fixed draws."""
    import torch
    from fitv2_tpu_torch.models.grid_utils import make_grid
    grid = torch.zeros(2, 2, HR_N, dtype=torch.int64)
    mask = torch.zeros(2, HR_N)
    for i, (h, w) in enumerate(SAC_GRIDS):
        grid[i, :, :h * w] = torch.from_numpy(make_grid(h, w))
        mask[i, :h * w] = 1.0
    size = torch.tensor(SAC_GRIDS, dtype=torch.int64).reshape(2, 1, 2)
    batch = dict(feature=torch.randn(2, HR_N, 16, generator=gen)
                 * mask[..., None], grid=grid, mask=mask,
                 label=torch.tensor([207, 360]), size=size)
    draws = dict(t=torch.tensor([0.3, 0.75]),
                 x0=torch.randn(2, HR_N, 16, generator=gen),
                 drop_ids=torch.tensor([0, 1]))
    return batch, draws


def phase_sac():
    """Phase 15 (a): FiTv2-HR-XL/2's widths (online decoupled NTK RoPE, N
    HR_N) at depth SAC_DEPTH in fp32, one flow loss and backward on the
    same weights, batch and draws under each remat policy on the card
    (none, full, dots, dots_all, dots_offload) and without remat on the
    CPU: every gradient of each policy against no remat on the card, and
    the card against the CPU, within TOL_SLICE_REL_L2 relative L2;
    dots_offload's gradients bit-identical to dots', its bytes copied to
    the host and back those of the blocks' saved products
    (`_offload_bytes`); the exact K1/K2/K4 launches of each (the recompute
    relaunches each kernel once a block; dots_offload's equal dots').
    Returns the counts by policy."""
    import torch
    from fitv2_tpu_torch.flow import create_transport
    from fitv2_tpu_torch.models import FiT, remat
    from fitv2_tpu_torch.train import flow_loss
    from fitv2_tpu_torch import kernels as K
    d = SAC_DEPTH
    base = _xl_model_fp32(d).state_dict()
    batch, draws = _hr_train_batch(torch.Generator().manual_seed(SEED + 15))
    transport = create_transport('Linear', 'velocity', snr_type='lognorm')
    grads, counts = {}, {}
    for device, policy in (('cpu', 'none'), ('cuda', 'none'),
                           ('cuda', 'full'), ('cuda', 'dots'),
                           ('cuda', 'dots_all'), ('cuda', 'dots_offload')):
        model = FiT(**dict(HR_XL, depth=d, use_checkpoint=policy != 'none',
                           remat_policy='full' if policy == 'none'
                           else policy))
        model.load_state_dict(base)
        model = model.to(device).train()
        _reset_counts()
        remat.reset_counts()
        loss, _ = flow_loss(model, transport,
                            {k: v.to(device) for k, v in batch.items()},
                            draws={k: v.to(device) for k, v in draws.items()})
        loss.backward()
        if device == 'cuda':
            torch.cuda.synchronize()
            counts[policy] = dict(_read_counts(), flash_masked_attention_bounded=(
                K.flash_masked_attention.bounded_launches))
        grads[device, policy] = {n: p.grad.detach().cpu()
                                 for n, p in model.named_parameters()}
        del model
        if policy == 'dots_offload':
            want = _offload_bytes(HR_XL, d, 2, HR_N, 4)
            moved = dict(remat.counts)
            if moved['d2h_bytes'] != want or moved['h2d_bytes'] != want \
                    or moved['d2h_copies'] != 6 * d:
                raise AssertionError(f'sac dots_offload: moved {moved}, '
                                     f'want {want} bytes each way')
            same = all(torch.equal(t, grads['cuda', 'dots'][n])
                       for n, t in grads['cuda', policy].items())
            say(f'[sac] dots_offload: {moved["d2h_copies"]} products '
                f'({want} bytes) to pinned host memory and back, == the '
                f'blocks\' mm/addmm outputs; gradients bit-identical to '
                f'dots\': {"yes" if same else "NO"}')
            if not same:
                raise AssertionError('sac dots_offload: gradients differ '
                                     'from dots\'')
    ref = grads['cuda', 'none']
    worst = {}
    for key, g in grads.items():
        if key == ('cuda', 'none'):
            continue
        rels = {n: _rel_l2(t, ref[n]) for n, t in g.items()}
        name = max(rels, key=rels.get)
        same = all(torch.equal(t, ref[n]) for n, t in g.items())
        worst[key] = rels[name]
        ok = rels[name] <= TOL_SLICE_REL_L2
        say(f'[sac] HR-XL widths depth {d} fp32, batch 2 (1024 and 800 of '
            f'{HR_N} tokens): {key[0]} {key[1]} vs cuda none, {len(g)} '
            f'gradients: worst relative L2 {rels[name]:.3e} ({name}) <= '
            f'{TOL_SLICE_REL_L2}: {"ok" if ok else "FAIL"}; bit-identical: '
            f'{"yes" if same else "no"}')
        if not ok:
            raise AssertionError(f'sac {key}: {name} {rels[name]}')
    for policy, got in counts.items():
        rerun = policy != 'none'
        want = _expected_counts(1, d, fused_qk_rope=1 + rerun,
                                flash_masked_attention=1 + rerun)
        want['fused_adaln_norm'] += 2 * d * rerun
        want['flash_masked_attention_bounded'] = d * (1 + rerun)
        if got != want or (policy == 'dots_offload'
                           and got != counts['dots']):
            raise AssertionError(f'sac {policy}: launches {got} != {want}')
        say(f'[sac] {policy}: launches {got} == expected (the recompute '
            f'relaunches K1 twice, K2 and K4 once a block: '
            f'{"yes" if rerun else "no remat"})')
    return counts


def _offload_bytes(widths, depth, batch, tokens, itemsize):
    """The bytes of the products that 'dots' saves a forward: in each
    block qkv, proj and SwiGLU fc1 / fc2 over the tokens, the adaLN-LoRA
    pair over the batch rows."""
    d = widths['hidden_size']
    hidden = int(d * widths.get('mlp_ratio', 4.0)) * 2 // 3
    per_token = 3 * d + d + 2 * hidden + d
    per_row = widths['adaln_lora_dim'] + 6 * d
    return depth * (batch * tokens * per_token + batch * per_row) * itemsize


def phase_prepare(card, out_dir):
    """Phase 15 (b): cli/prepare_latents' routing and encoding function
    (encode_routed, no PIL) with the SD-VAE encoder at its real widths,
    seeded: the encoder on the card against the CPU (fp32, a 256 x 256
    flip pair), then PREP_SIZES' images: PREP_SMALL fit PREP_TARGET_LEN
    tokens, the larger ones come as PREP_LARGE_HW square arrays for both
    their resize and crop versions; into shards, fp32 (the shards (c) trains on) and bf16, with
    the bucket counts and the encode rate. Returns the fp32 shard dir."""
    import numpy as np
    import torch
    from fitv2_tpu_torch.cli.prepare_latents import (
        encode_routed, make_encode_fn)
    from fitv2_tpu_torch.vae import AutoencoderKL
    torch.manual_seed(SEED + 16)
    vae = AutoencoderKL().eval()
    rng = np.random.default_rng(SEED + 16)
    pair = rng.uniform(-1, 1, (2, 256, 256, 3)).astype(np.float32)
    t0 = time.perf_counter()
    on_cpu = make_encode_fn(vae, 'cpu')(pair)
    t_cpu = time.perf_counter() - t0
    vae_gpu = copy.deepcopy(vae).to('cuda')
    on_card = make_encode_fn(vae_gpu, 'cuda')(pair)
    rel = float(np.linalg.norm(on_card - on_cpu) / np.linalg.norm(on_cpu))
    ok = rel <= TOL_SLICE_REL_L2
    say(f'[prep] SD-VAE encoder (128-512 wide, seeded), fp32 256x256 flip '
        f'pair: scaled mean {on_card.shape}, card vs CPU relative L2 '
        f'{rel:.3e} <= {TOL_SLICE_REL_L2}: {"ok" if ok else "FAIL"} (CPU '
        f'{t_cpu:.1f} s)')
    if not ok or not np.isfinite(on_card).all():
        raise AssertionError(f'prep: encoder card vs CPU {rel}')
    samples = []
    for i, (w, h) in enumerate(PREP_SIZES):
        if (w // 16) * (h // 16) <= PREP_TARGET_LEN:
            arrays = {'native': rng.integers(0, 256, (h, w, 3), np.uint8)}
        else:
            arrays = {k: rng.integers(0, 256, (PREP_LARGE_HW,) * 2 + (3,),
                                      np.uint8) for k in ('resize', 'crop')}
        samples.append((f'{i:06d}.safetensors', i % 1000, (w, h),
                        arrays.__getitem__))
    out = {}
    for tag, model in (('fp32', vae_gpu), ('bf16', copy.deepcopy(vae_gpu).to(
            torch.bfloat16))):
        encode = make_encode_fn(model, 'cuda')
        encode(pair)  # warm-up
        torch.cuda.synchronize()
        shards = os.path.join(out_dir, f'hr_latents_{tag}')
        t0 = time.perf_counter()
        counts = encode_routed(samples, encode, shards, PREP_TARGET_LEN, 2,
                               log_every=0)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        files = {d: len(os.listdir(os.path.join(shards, d)))
                 for d in sorted(os.listdir(shards))}
        want = {'small': PREP_SMALL, 'large': len(PREP_SIZES) - PREP_SMALL}
        if counts != want or sorted(files.values()) != sorted(
                [want['small'], want['large'], want['large']]):
            raise AssertionError(f'prep {tag}: counts {counts}, files {files}')
        images = 2 * (want['small'] + 2 * want['large'])  # flip pairs
        say(f'[prep] {tag}: {len(samples)} images ({want["small"]} fit '
            f'{PREP_TARGET_LEN} tokens, {want["large"]} larger: resize + '
            f'crop) -> {counts}, shards {files}; {images} encoded images '
            f'(flip pairs, at their bucket size, shard writes included) in '
            f'{secs:.3f} s = {images / secs:.1f} images/s [{card}]')
        out[tag] = shards
    return out['fp32']


def _hr_train_cfg(shards):
    """configs/fitv2_hr_xl.yaml as shipped (remat dots), reading
    `shards`."""
    from fitv2_tpu_torch.utils import load_config
    cfg = load_config(['configs/fitv2_hr_xl.yaml'])
    cfg['data']['params']['train']['data_path'] = shards
    return cfg


def _link_gb_s():
    """The card's copy rates to and from pinned host memory, GB/s: the
    median of LINK_REPS copies of LINK_BYTES each way (CUDA events), after
    one more."""
    import torch
    host = torch.empty(LINK_BYTES, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(LINK_BYTES, dtype=torch.uint8, device='cuda')
    rates = {}
    for name, dst, src in (('d2h', host, dev), ('h2d', dev, host)):
        ms = []
        for _ in range(LINK_REPS + 1):
            start, stop = (torch.cuda.Event(enable_timing=True)
                           for _ in range(2))
            start.record()
            dst.copy_(src, non_blocking=True)
            stop.record()
            stop.synchronize()
            ms.append(start.elapsed_time(stop))
        rates[name] = LINK_BYTES / statistics.median(ms[1:]) / 1e6
    del host, dev
    return rates


def phase_train_hr(card, out_dir, shards, ref_npz, inception_weights):
    """Phase 15 (c): cli/train's build_trainer on configs/fitv2_hr_xl.yaml
    as shipped (remat 'dots', depth 36, batch 8 at 1024 tokens, bf16 over
    fp32 masters, the native loader) on (b)'s shards, HR_TRAIN_STEPS
    steps, a sync every step: finite losses, exact launches a step, ms a
    step (the median after HR_TRAIN_WARM), images/s and peak memory (over
    the timed steps); an InlineEvalHook at the last step (HOOK_STEPS Euler
    steps, batch 4, CFG 1.5 at 512 x 512, the smoke's random VAE decoder
    and InceptionV3, against `ref_npz`) writing its preview and
    inline_fid; then the same trainer under remat 'dots_offload' and then
    'full', HR_MORE_STEPS steps each from its masters (timed after
    HR_MORE_WARM): the same numbers, and for dots_offload the bytes copied
    to the host and back a step (those of the saved products,
    `_offload_bytes`), its peak at least OFFLOAD_PEAK_DROP below dots',
    the link's measured rates and the serial time of its copies at
    them, which its ms a step must stay below dots' plus (the copies
    overlap compute). Returns the counts by path and the numbers."""
    import numpy as np
    import torch
    from fitv2_tpu_torch.cli import train as cli
    from fitv2_tpu_torch.models import remat
    from fitv2_tpu_torch.sample import SamplingConfig
    from fitv2_tpu_torch.train.eval_hook import InlineEvalHook
    from fitv2_tpu_torch.vae import AutoencoderKL
    torch.manual_seed(SEED + 2)
    vae = AutoencoderKL().to(device='cuda', dtype=torch.bfloat16).eval()
    preview_dir = os.path.join(out_dir, 'previews')
    results, by_path, hook_state = {}, {}, {}
    args = cli.parse_args(['--cfgdir', 'configs/fitv2_hr_xl.yaml',
                           '--output-dir', os.path.join(out_dir, 'hr'),
                           '--max-steps', str(HR_TRAIN_STEPS),
                           '--device', 'cuda'])
    torch.manual_seed(SEED)  # the initial weights
    t0 = time.perf_counter()
    trainer = cli.build_trainer(_hr_train_cfg(shards), args)
    run_secs = {'build': time.perf_counter() - t0}
    if trainer.model.remat_policy != 'dots' or not \
            trainer.model.use_checkpoint:
        raise AssertionError('hr train: the config\'s remat dots not in '
                             'effect')
    for policy, steps, warm in (('dots', HR_TRAIN_STEPS, HR_TRAIN_WARM),
                                ('dots_offload', HR_MORE_STEPS, HR_MORE_WARM),
                                ('full', HR_MORE_STEPS, HR_MORE_WARM)):
        peaks = {}

        def extra(step, metrics, trainer, policy=policy, steps=steps,
                  warm=warm, peaks=peaks):
            if step == warm:
                torch.cuda.reset_peak_memory_stats()
            if step != steps:
                return
            peaks['timed'] = torch.cuda.max_memory_allocated()
            if policy != 'dots':
                return
            hook = InlineEvalHook(
                trainer.model, SamplingConfig(
                    image_height=512, image_width=512,
                    num_sampling_steps=HOOK_STEPS, cfg_scale=CFG_SCALE,
                    per_device_batch=HOOK_BATCH, interpolation='keep',
                    dtype=torch.bfloat16),
                every=HR_TRAIN_STEPS, ref_images=ref_npz,
                inception_weights=inception_weights, vae=vae,
                out_dir=preview_dir, seed=SEED)
            hook.attach(lambda: trainer.state.ema_params)
            before = _counts_now()
            t0 = time.perf_counter()
            hook(step, metrics)
            torch.cuda.synchronize()
            hook_state['secs'] = time.perf_counter() - t0
            hook_state['counts'] = _counts_minus(_counts_now(), before)
            hook_state['metrics'] = dict(metrics)
        trainer.model.remat_policy = policy
        run_args = copy.copy(args)
        run_args.max_steps = steps
        remat.reset_counts()
        t0 = time.perf_counter()
        trainer, state, losses, stamps, _, counts, _ = _train_run(
            cli, None, run_args, False, write=False, extra_hook=extra,
            trainer=trainer)
        run_secs[policy] = time.perf_counter() - t0
        moved = dict(remat.counts)
        del state
        depth, batch = trainer.model.depth, trainer.cfg.global_batch_size
        if policy == 'dots':
            counts = _counts_minus(counts, hook_state['counts'])
        want = dict(_expected_counts(steps, depth, fused_qk_rope=2,
                                     flash_masked_attention=2),
                    flash_masked_attention_bounded=steps * 2 * depth)
        want['fused_adaln_norm'] += steps * 2 * depth
        if counts != want or not all(map(math.isfinite, losses)):
            raise AssertionError(f'hr train {policy}: launches {counts} != '
                                 f'{want}, losses {losses}')
        step_ms = [(stamps[s] - stamps[s - 1]) * 1e3 for s in sorted(stamps)
                   if s > warm and s - 1 in stamps]
        ms = statistics.median(step_ms)
        peak = peaks['timed']
        results[policy] = dict(ms_per_step=ms, images_per_s=batch / ms * 1e3,
                               peak_gib=peak / 2 ** 30, losses=losses)
        by_path[f'hr_train_{policy}'] = counts
        say(f'[hr train] configs/fitv2_hr_xl.yaml, remat {policy}, depth '
            f'{depth}, batch {batch} x {PREP_TARGET_LEN} tokens, bf16 over '
            f'fp32 masters: losses {", ".join(f"{v:.4f}" for v in losses)}; '
            f'a step (synced), median of steps {warm + 1}-{steps}: '
            f'{ms:.2f} ms (range {min(step_ms):.2f}-{max(step_ms):.2f}) = '
            f'{batch / ms * 1e3:.2f} images/s; peak over those steps '
            f'{peak / 2 ** 30:.2f} GiB; launches a step: K1 '
            f'{2 * depth + 1} + {2 * depth} (recompute), K2 {depth} + '
            f'{depth}, K4 {depth} + {depth} == expected [{card}]')
        if policy != 'dots_offload':
            if moved['d2h_copies']:
                raise AssertionError(f'hr train {policy}: offloaded {moved}')
            continue
        per_step = _offload_bytes(HR_XL, depth, batch, PREP_TARGET_LEN, 2)
        if (moved['d2h_bytes'] != steps * per_step
                or moved['h2d_bytes'] != steps * per_step):
            raise AssertionError(f'hr train dots_offload: moved {moved}, '
                                 f'want {per_step} bytes a step each way')
        t0 = time.perf_counter()
        rates = _link_gb_s()
        run_secs[policy] += time.perf_counter() - t0
        serial_ms = per_step / 1e6 * (1 / rates['d2h'] + 1 / rates['h2d'])
        dots = results['dots']
        drop = (dots['peak_gib'] - results[policy]['peak_gib']) * 2 ** 30
        limit = dots['ms_per_step'] + serial_ms
        results[policy].update(
            offloaded_bytes_per_step=per_step, link_gb_s=rates,
            serial_copy_ms=serial_ms, peak_drop_bytes=drop,
            pinned_bytes=remat.PINNED.reserved)
        say(f'[hr train] dots_offload: {per_step} bytes ({per_step / 1e9:.3f}'
            f' GB) of saved products to pinned host memory a step and back '
            f'({moved["d2h_copies"] // steps} copies each way; '
            f'{remat.PINNED.reserved / 2 ** 30:.1f} GiB pinned); the link: '
            f'device->host {rates["d2h"]:.2f} GB/s, host->device '
            f'{rates["h2d"]:.2f} GB/s, so the copies alone take '
            f'{serial_ms:.1f} ms a step; {results[policy]["ms_per_step"]:.2f}'
            f' ms a step against dots\' {dots["ms_per_step"]:.2f} + '
            f'{serial_ms:.1f} = {limit:.2f} (the copies overlap compute: '
            f'{"yes" if results[policy]["ms_per_step"] < limit else "NO"}); '
            f'peak {results[policy]["peak_gib"]:.2f} GiB against dots\' '
            f'{dots["peak_gib"]:.2f}: {drop / 1e9:.2f} GB lower (at least '
            f'{OFFLOAD_PEAK_DROP / 1e9:.1f}) [{card}]')
        if drop < OFFLOAD_PEAK_DROP or results[policy]['ms_per_step'] >= limit:
            raise AssertionError(f'hr train dots_offload: peak {drop} bytes '
                                 f'below dots\', ms a step '
                                 f'{results[policy]["ms_per_step"]} >= {limit}')
    del trainer
    remat.PINNED.clear()
    torch.cuda.empty_cache()
    say(f'[hr train] the runs\' seconds: the trainer\'s build '
        f'{run_secs["build"]:.1f} (once: the full run shares it), dots '
        f'{run_secs["dots"]:.1f} ({HR_TRAIN_STEPS} steps and the inline '
        f'eval), dots_offload {run_secs["dots_offload"]:.1f} '
        f'({HR_MORE_STEPS} steps, the pinning and the link\'s rates), full '
        f'{run_secs["full"]:.1f} ({HR_MORE_STEPS} steps)')
    hc, hm = hook_state['counts'], hook_state['metrics']
    want = _expected_counts(HOOK_STEPS, depth, fused_qk_rope=1,
                            flash_masked_attention=1)
    want['flash_masked_attention_bounded'] = HOOK_STEPS * depth
    preview = np.load(os.path.join(preview_dir,
                                   f'preview_{HR_TRAIN_STEPS}.npz'))['arr_0']
    if (hc != want or preview.shape != (HOOK_BATCH, 512, 512, 3)
            or preview.dtype != np.uint8
            or not math.isfinite(hm.get('inline_fid', math.nan))
            or not math.isfinite(hm.get('inline_is', math.nan))):
        raise AssertionError(f'inline eval: launches {hc} (want {want}), '
                             f'preview {preview.shape}, metrics {hm}')
    by_path['inline_eval'] = hc
    say(f'[hr train] InlineEvalHook at step {HR_TRAIN_STEPS}: EMA -> the '
        f"hook's copy of the bf16 model, {HOOK_STEPS} Euler steps CFG "
        f'{CFG_SCALE} batch '
        f'{HOOK_BATCH} at 512x512, VAE, preview {preview.shape} written, '
        f'inline_fid {hm["inline_fid"]:.3f} inline_is {hm["inline_is"]:.3f} '
        f'against {os.path.basename(ref_npz)} (seeded weights); '
        f'{hook_state["secs"]:.2f} s; launches {hc} == expected [{card}]')
    return by_path, results


def _counts_now():
    from fitv2_tpu_torch import kernels as K
    return dict(_read_counts(), flash_masked_attention_bounded=(
        K.flash_masked_attention.bounded_launches))


def _counts_minus(a, b):
    return {k: a[k] - b.get(k, 0) for k in a}


def phase_came(card, out_dir, adamw):
    """Phase 15 (d): an fp32 CAME update at XL width, depth
    CAME_PARITY_DEPTH, over the JAX counterpart's leaves (scanned blocks),
    on the card against the CPU on the same masters and gradients
    (CAME_PARITY_STEPS updates): every master and state tensor within
    TOL_CAME_REL relative L2; then cli/train --came on
    configs/fitv2_xl.yaml (depth 36, batch 32, phase 11's shards): the rate
    over steps TRAIN_TIMED + 1 to 2 TRAIN_TIMED as phase 11 times AdamW,
    and the peak memory, beside phase 11's (`adamw`: its ms_per_step and
    peak_gib, None where not run). Returns the counts and the numbers."""
    import torch
    from fitv2_tpu_torch.ckpt import jax_leaves
    from fitv2_tpu_torch.cli import train as cli
    from fitv2_tpu_torch.train.came import CAME
    base = _xl_model_fp32(CAME_PARITY_DEPTH)
    gen = torch.Generator().manual_seed(SEED + 17)
    grads = [[torch.randn(p.shape, generator=gen) for p in base.parameters()]
             for _ in range(CAME_PARITY_STEPS)]
    out = {}
    for device in ('cpu', 'cuda'):
        model = copy.deepcopy(base).to(device)
        masters = dict(model.named_parameters())
        opt = CAME(masters, jax_leaves(model), lr=1e-4, weight_decay=0.01)
        for step_grads in grads:
            for p, g in zip(masters.values(), step_grads):
                p.grad = g.to(device)
            opt.step()
        out[device] = ({n: p.detach().cpu() for n, p in masters.items()},
                       [{k: v.cpu() for k, v in
                         opt.state[opt.leaf_params(leaf)[0]].items()}
                        for leaf in opt.leaves])
    rels = {n: _rel_l2(t, out['cpu'][0][n]) for n, t in out['cuda'][0].items()}
    for i, st in enumerate(out['cuda'][1]):
        for k, v in st.items():
            rels[f'state[{i}].{k}'] = _rel_l2(v, out['cpu'][1][i][k])
    worst = max(rels, key=rels.get)
    ok = rels[worst] <= TOL_CAME_REL
    say(f'[came] XL width depth {CAME_PARITY_DEPTH} fp32, '
        f'{CAME_PARITY_STEPS} CAME updates over {len(out["cpu"][1])} JAX '
        f'leaves (wd 0.01), card vs CPU: worst relative L2 {rels[worst]:.3e} '
        f'({worst}) of {len(rels)} masters and state tensors <= '
        f'{TOL_CAME_REL}: {"ok" if ok else "FAIL"}')
    if not ok:
        raise AssertionError(f'came parity: {worst} {rels[worst]}')
    timed = 2 * TRAIN_TIMED
    cfg = _train_config('configs/fitv2_xl.yaml', out_dir, TRAIN_RESUME)
    args = cli.parse_args(['--cfgdir', 'configs/fitv2_xl.yaml', '--came',
                           '--output-dir', os.path.join(out_dir, 'came'),
                           '--max-steps', str(timed), '--device', 'cuda'])
    trainer, _, losses, stamps, _, counts, peak = _train_run(
        cli, cfg, args, False, log_every=TRAIN_TIMED, write=False)
    depth, batch = trainer.model.depth, trainer.cfg.global_batch_size
    if not isinstance(trainer.state.optimizer, CAME):
        raise AssertionError('came: the trainer does not run CAME')
    del trainer
    torch.cuda.empty_cache()
    want = dict(_expected_counts(timed, depth, fused_qk_rope=1,
                                 flash_masked_attention=1),
                flash_masked_attention_bounded=timed * depth)
    if counts != want or not all(map(math.isfinite, losses)):
        raise AssertionError(f'came run: launches {counts}, losses {losses}')
    ms = (stamps[timed] - stamps[TRAIN_TIMED]) * 1e3 / TRAIN_TIMED
    beside = ('' if adamw is None else
              f'; AdamW (phase 11, the same window): '
              f'{adamw["ms_per_step"]:.2f} ms, peak '
              f'{adamw["peak_gib"]:.2f} GiB')
    say(f'[came] cli/train --came configs/fitv2_xl.yaml, depth {depth}, '
        f'batch {batch}: steps {TRAIN_TIMED + 1}-{timed} {ms:.2f} ms a step '
        f'= {batch / ms * 1e3:.2f} images/s, peak {peak / 2 ** 30:.2f} GiB'
        f'{beside}; launches == expected [{card}]')
    return counts, dict(ms_per_step=ms, images_per_s=batch / ms * 1e3,
                        peak_gib=peak / 2 ** 30, parity_rel_l2=rels[worst])


def phase_teachers(card):
    """Phase 15 (e): the REPA teachers DINOv2-B/14 and CLIP-B/16 at their
    seeded random init (load_encoders): fp32 tokens on the card against the
    CPU on 2 images at 224 x 224 within TOL_SLICE_REL_L2 relative L2; then
    bf16 images/s at TEACHER_BATCH (the median of REPS calls, CUDA events
    behind a device sleep, preprocessing included)."""
    import numpy as np
    import torch
    from fitv2_tpu_torch.encoders import load_encoders
    rng = np.random.default_rng(SEED + 18)
    small = torch.from_numpy(rng.integers(0, 256, (2, 224, 224, 3), np.uint8))
    many = torch.from_numpy(rng.integers(
        0, 256, (TEACHER_BATCH, 224, 224, 3), np.uint8)).cuda()
    out = {}
    for enc, arch in (('dinov2-vit-b', 'vit_base'), ('clip-vit-b', 'vit_base')):
        model, pre = load_encoders(enc, arch=arch)

        def feats(m, x):
            return (m.forward_features(pre(x)) if enc.startswith('clip')
                    else m(pre(x)))
        with torch.no_grad():
            ref = feats(model, small)
            gpu = model.to('cuda')
            got = feats(gpu, small.cuda())
            rel = _rel_l2(got, ref)
            ok = rel <= TOL_SLICE_REL_L2 and torch.isfinite(got).all()
            say(f'[teachers] {enc} ({arch}, seeded) fp32 tokens '
                f'{tuple(got.shape)}, card vs CPU relative L2 {rel:.3e} <= '
                f'{TOL_SLICE_REL_L2}: {"ok" if ok else "FAIL"}')
            if not ok:
                raise AssertionError(f'teachers {enc}: {rel}')
            bf16 = gpu.to(torch.bfloat16)
            ms = _time_ms(lambda: feats(bf16, many))
        rate = TEACHER_BATCH / ms * 1e3
        out[enc] = dict(rel_l2=rel, ms=ms, images_per_s=rate)
        say(f'[teachers] {enc} bf16 at batch {TEACHER_BATCH}, 224x224: '
            f'{ms:.2f} ms a batch = {rate:.1f} images/s [{card}]')
        del model, gpu, bf16
    return out


# cuBLAS's fixed workspace, which deterministic algorithms require of a
# cuBLAS call: cuBLAS reads it once, when it starts, and it makes every
# sampler step's host side 2.0-2.4x slower (PERF.md §5, PR 9), so only the
# child processes of the deterministic trainer runs (CHILD_PHASES) set it
# -- phase 16: int8 LwD serving, per-bucket int8, GAN-guided LwD training ----

def phase_int8_lwd(card):
    """Phase 16 (a): FiTLwD-XL in int8 (see the module docstring). Returns
    the counted run's launches and the K6 / K7 sites at its shapes."""
    import torch
    from fitv2_tpu_torch import kernels as K
    from fitv2_tpu_torch.kernels.quant import (
        calibrate_quant_scales, int8_layers, prequantize_weights)
    from fitv2_tpu_torch.models.grid_utils import make_grid_mask_size
    from fitv2_tpu_torch.utils import config_to_model, load_config
    bf16 = _lwd_model_fp32(LWD_CONFIG).to('cuda', torch.bfloat16).eval()
    with torch.device('cuda'):
        model = config_to_model(load_config([LWD_CONFIG])['diffusion'][
            'network_config'], gemm_precision='int8', dtype='bfloat16')
    model.load_state_dict(bf16.state_dict())
    model.eval()
    B, k_seg, blocks = BATCH, model.number_of_perflow, model.layers_per_flow
    gen = torch.Generator().manual_seed(SEED + 40)
    z = torch.randn(B, N, 16, generator=gen).cuda()
    y = (torch.arange(B) * 111 % 1000).cuda()
    # calibration: the model's forward (init_all: every segment's training
    # forward, the labels dropped as in training) on the CFG batch, t at
    # each segment's middle in turn
    grid, _, size = make_grid_mask_size(2 * B, 16, 16, N, 'cuda')
    y2 = torch.cat([y, torch.full_like(y, 1000)])
    xc = torch.randn(2 * B, N, 16, generator=gen).cuda()
    batches = [(xc, torch.full((2 * B,), (i + 0.5) / k_seg, device='cuda'),
                y2, grid, None, size, None,
                torch.Generator().manual_seed(SEED + 41 + i))
               for i in range(k_seg)]
    _reset_counts()
    t0 = time.perf_counter()
    calibrate_quant_scales(model, batches)
    prequantize_weights(model)
    torch.cuda.synchronize()
    t_calib = time.perf_counter() - t0
    calib = _read_counts()
    if calib['int8_gemm_bias'] or calib['int8_gemm_swiglu_quant']:
        raise AssertionError(f'int8 LwD: calibration launched {calib}')
    n_layers = len(int8_layers(model))

    def call(m):
        out = m.sample_cfg(z, y, LWD_CFG_SCALE, INT8_LWD_STEPS_PER_FLOW)
        torch.cuda.synchronize()
        return out
    ref = call(bf16)
    call(model)  # warm-up
    _reset_counts()
    out = call(model)
    counts = _lwd_read_counts()
    evals = k_seg * INT8_LWD_STEPS_PER_FLOW
    want = _lwd_counts(evals, dict(
        fused_adaln_norm=2 * blocks + 1, fused_qk_rope=blocks,
        flash_masked_attention=blocks, flash_masked_attention_bounded=blocks,
        int8_gemm_bias=3 * blocks, int8_gemm_swiglu_quant=blocks))
    if counts != want:
        raise AssertionError(f'int8 LwD: launch counts {counts} != {want}')
    rel = _rel_l2(out, ref)
    ok = rel < MAX_INT8_LWD_REL_L2 and bool(torch.isfinite(out).all())
    say(f'[int8 lwd] FiTLwD-XL int8 W8A8 ({n_layers} Int8Linear sites; '
        f'calibrated through forward = init_all over {k_seg} batches at '
        f'each segment\'s middle t, then prequantized: {t_calib:.2f} s), '
        f'sample_cfg {k_seg} segments x {INT8_LWD_STEPS_PER_FLOW} sub-step, '
        f'batch {B}: relative L2 against bf16 on the same weights and z '
        f'{rel:.4f} < {MAX_INT8_LWD_REL_L2}: {"ok" if ok else "FAIL"}; '
        f'launches {counts} == expected (a CFG eval: K6 {3 * blocks} = 3 '
        f'x {blocks} blocks, K7 {blocks}, K1 {2 * blocks + 1}, K2 and K4 '
        f'{blocks})')
    if not ok:
        raise AssertionError(f'int8 LwD: relative L2 {rel} against bf16')
    walls = {'int8': [], 'bf16': []}
    for _ in range(INT8_LWD_RATE_CALLS):
        for tag, m in (('int8', model), ('bf16', bf16)):
            t0 = time.perf_counter()
            call(m)
            walls[tag].append(time.perf_counter() - t0)
    med = {t: statistics.median(w) for t, w in walls.items()}
    rate = {t: B / m for t, m in med.items()}
    say(f'[int8 lwd] sample_cfg ({evals} CFG evals at batch {2 * B}), the '
        f'median of {INT8_LWD_RATE_CALLS} calls each, interleaved: int8 '
        f'{rate["int8"]:.4f} images/s ({med["int8"] / evals * 1e3:.2f} ms '
        f'an eval), bf16 {rate["bf16"]:.4f} images/s '
        f'({med["bf16"] / evals * 1e3:.2f} ms an eval) [{card}]')
    del model, bf16
    torch.cuda.empty_cache()
    # K6 at qkv / proj / fc2 and K7 at fc1 at this path's M (the CFG batch)
    dev = torch.device('cuda')
    kgen = torch.Generator(device=dev).manual_seed(SEED + 42)
    m = 2 * B * N
    k6 = [dict(_k6_site(K, dev, kgen, site, m, kk, nn, torch.bfloat16),
               path='int8_lwd')
          for site, kk, nn in (('qkv', D, 3 * D), ('proj', D, D),
                               ('fc2', LWD_MLP_H, D))]
    k7 = [dict(_k7_site(K, dev, kgen, m, D, LWD_MLP_H), path='int8_lwd')]
    return counts, k6, k7, rate


def phase_int8_buckets(card):
    """Phase 16 (b): an int8 FiT-XL/2 BucketedSampler over two buckets in
    the order A, B, A (see the module docstring)."""
    import torch
    from fitv2_tpu_torch.kernels.quant import int8_layers
    from fitv2_tpu_torch.sample import BucketedSampler, SamplingConfig
    bf16 = xl_model_bf16()
    cfg = SamplingConfig(num_sampling_steps=INT8_BUCKET_STEPS,
                         cfg_scale=CFG_SCALE, per_device_batch=BATCH,
                         dtype=torch.bfloat16)
    labels = torch.arange(BATCH) * 111 % 1000

    def sample(buckets, hw):
        out = buckets.sample(labels, *hw, generator=torch.Generator(
        ).manual_seed(SEED + 43))
        torch.cuda.synchronize()
        return out

    def scales(model):
        return [m.act_absmax for m in int8_layers(model).values()]
    a, b = INT8_BUCKETS
    model = _xl_variant(bf16, gemm_precision='int8')
    buckets = BucketedSampler(model, cfg)
    t0 = time.perf_counter()
    runs = [sample(buckets, a)]
    weights = [m.weight_q for m in int8_layers(model).values()]
    scales_a = scales(model)
    runs.append(sample(buckets, b))
    scales_b = scales(model)
    runs.append(sample(buckets, a))
    secs = time.perf_counter() - t0
    shared = all(m.weight_q is w for m, w in zip(
        int8_layers(model).values(), weights))
    own = (all(x is y for x, y in zip(scales(model), scales_a))
           and any(not torch.equal(x, y) for x, y in zip(scales_a,
                                                           scales_b)))
    ref = sample(BucketedSampler(_xl_variant(bf16, gemm_precision='int8'),
                                 cfg), a)
    same = torch.equal(runs[0], runs[2]) and torch.equal(runs[0], ref)
    finite = all(bool(torch.isfinite(r).all()) for r in runs)
    shapes = [tuple(r.shape) for r in runs]
    ok = same and finite and shared and own and \
        shapes[1] == (BATCH, 4, b[0] // 8, b[1] // 8)
    say(f'[int8 buckets] XL/2 int8, one BucketedSampler over {a}, {b}, '
        f'{a} ({INT8_BUCKET_STEPS} steps, CFG {CFG_SCALE}, batch {BATCH}; '
        f'each bucket calibrated at its own shape): outputs {shapes}; '
        f'the int8 weights quantized once and shared: {shared}; each '
        f'bucket binds its own scales: {own}; the two {a} runs and a '
        f'sampler of {a} alone (another model, the same weights) bit-'
        f'identical: {same}: {"ok" if ok else "FAIL"} ({secs:.2f} s for '
        f'the three calls with both bucket builds) [{card}]')
    if not ok:
        raise AssertionError('int8 buckets: A, B, A is not A alone, or the '
                             'weights or scales are not per bucket as they '
                             'should be')
    del model, bf16, buckets
    torch.cuda.empty_cache()


def _synthetic_cifar(root, n=256):
    """A cifar-10-batches-py folder of random uint8 images (seeded): the
    format cli/train_cifar_gan reads; no download."""
    import pickle
    import numpy as np
    folder = os.path.join(root, 'cifar-10-batches-py')
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(SEED + 44)
    for i in range(1, 6):
        with open(os.path.join(folder, f'data_batch_{i}'), 'wb') as f:
            pickle.dump({b'data': rng.integers(0, 256, (n, 3072),
                                               dtype=np.uint8),
                         b'labels': rng.integers(0, 10, n).tolist()}, f)
    return root


def phase_gan_kernels():
    """Phase 16 (c): K1, K2 and K4 inside their autograd Functions at the
    GAN student's shapes (batch GAN_BATCH, N 256, D 384, 6 heads of 64,
    unmasked), bf16 and fp32, with phase 11's _grad_case."""
    import torch
    from fitv2_tpu_torch import kernels as K
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(SEED + 45)
    b, n, d, h, dh = GAN_BATCH, GAN_N, GAN_D, GAN_H, GAN_DH
    cases = {'adaln': [], 'qk_rope': [], 'attention': []}
    path = 'gan_train'
    for dtype in (torch.bfloat16, torch.float32):
        x = (torch.randn(b, n, d, device=dev, generator=gen) * 2 + 3
             ).to(dtype)
        mod = (0.5 * torch.randn(b, 6 * d, device=dev, generator=gen)
               ).to(dtype)

        def adaln(fn):
            return lambda a, m: fn(a, *m.chunk(6, dim=-1)[:2])
        cases['adaln'].append(dict(_grad_case(
            f'adaln ({b},{n},{d})', dtype, adaln(K.adaln_norm),
            adaln(K.adaln_norm_reference), [x, mod], 1, 'norm',
            LWD_TRAIN_REPS), path=path))
        qkv = torch.randn(b, n, 3, h, dh, device=dev, generator=gen
                          ).to(dtype)
        ang = torch.rand(b, n, dh, device=dev, generator=gen) * 6.3
        cos, sin = torch.cos(ang), torch.sin(ang)

        def qk(fn):
            return lambda a: fn(*a.unbind(2)[:2], cos, sin)
        cases['qk_rope'].append(dict(_grad_case(
            f'qk_rope ({b},{n},{h},{dh})', dtype, qk(K.qk_norm_rope),
            qk(K.qk_norm_rope_reference), [qkv], 2, 'norm',
            LWD_TRAIN_REPS), path=path))
        q, k, v = qkv.unbind(2)
        qkv_n = torch.stack([*K.qk_norm_rope_reference(q, k, cos, sin), v],
                            dim=2)
        cases['attention'].append(dict(_grad_case(
            f'attention[bounded,no mask] ({b},{n},{h},{dh})', dtype,
            lambda a: K.masked_attention(*a.unbind(2), None,
                                         bounded_logits=True),
            lambda a: K.attention_bounded_reference(*a.unbind(2)),
            [qkv_n], 3, 'attention', LWD_TRAIN_REPS), variant='bounded',
            mask=False, path=path))
    torch.cuda.synchronize()
    return cases


def phase_gan_parity():
    """Phase 16 (c): one fp32 generator + discriminator step of
    cli/train_cifar_gan's networks (full widths, batch GAN_PARITY_BATCH,
    segment 1, the adversarial terms live) on the card against the same
    step on the CPU, on the same weights, batch and draws: the losses
    within 1e-5 relative, every generator master, moment and EMA and every
    discriminator parameter, running statistic and moment within
    TOL_GAN_REL relative L2."""
    import torch
    from fitv2_tpu_torch.cli import train_cifar_gan as cli
    from fitv2_tpu_torch.losses import (
        LPIPSWithDiscriminator2D, NLayerDiscriminator)
    from fitv2_tpu_torch.train import (
        OptimizerConfig, create_disc_state, create_train_state, disc_adam,
        make_gan_steps)
    from fitv2_tpu_torch.train.lwd_train_step import _segment_params
    torch.manual_seed(SEED + 46)
    model0 = cli.build_model()
    disc0 = NLayerDiscriminator(input_nc=3, ndf=64, n_layers=3)
    gen = torch.Generator().manual_seed(SEED + 47)
    with torch.no_grad():  # adaLN-zero: perturb, or the velocity is 0
        for name, p in model0.named_parameters():
            if 'adaLN_modulation.fc_out' in name or '.linear.' in name:
                p.add_(0.02 * torch.randn(p.shape, generator=gen))
    b = GAN_PARITY_BATCH
    batch = dict(image=torch.rand(b, 32, 32, 3, generator=gen) * 2 - 1,
                 label=torch.arange(b) * 3 % 10)
    draws = dict(x0=torch.randn(b, 256, 12, generator=gen),
                 r=torch.rand(b, generator=gen),
                 drop_ids=torch.tensor([0, 1] * (b // 2)))
    runs = {}
    for device in ('cpu', 'cuda'):
        model = copy.deepcopy(model0).to(device).train()
        disc = copy.deepcopy(disc0).to(device).train()
        state = create_train_state(model, OptimizerConfig(
            learning_rate=1e-4))
        dstate = create_disc_state(disc, lambda p: disc_adam(p, 1e-4))
        loss_fn = cli.make_generator_loss(model, b, device)
        gen_step, disc_step = make_gan_steps(
            loss_fn, model, LPIPSWithDiscriminator2D(disc_weight=0.1),
            required=_segment_params(model))
        bd = {k: v.to(device) for k, v in batch.items()}
        dd = {k: v.to(device) for k, v in draws.items()}
        before = _counts_now()
        state, gm = gen_step(state, dstate, bd, None, dd, segment_idx=1)
        with torch.no_grad():
            _, fake = loss_fn(model, bd, None, dd, 1)
        dstate, dm = disc_step(dstate, bd['image'], fake, state.step)
        runs[device] = (state, dstate, {**gm, **dm},
                        _counts_minus(_counts_now(), before))
    (cpu, dcpu, mcpu, _), (gpu, dgpu, mgpu, launched) = runs['cpu'], \
        runs['cuda']
    if not (launched['fused_adaln_norm'] and launched['fused_qk_rope']
            and launched['flash_masked_attention_bounded']):
        raise AssertionError(f'GAN parity: the card step launched {launched}')
    worst_loss = max(abs(mgpu[k].item() - mcpu[k].item()) / max(
        abs(mcpu[k].item()), 1e-12) for k in ('loss', 'base_loss',
                                               'g_loss', 'd_loss'))
    pairs = []
    for n, p in cpu.params.items():
        pairs += [(gpu.params[n], p), (gpu.ema_params[n], cpu.ema_params[n])]
        pairs += [(gpu.optimizer.state[gpu.params[n]][k],
                   cpu.optimizer.state[p][k]) for k in ('mu', 'nu')]
    dp = dict(dgpu.disc.named_parameters())
    for n, p in dcpu.disc.named_parameters():
        pairs += [(dp[n], p)] + [
            (dgpu.optimizer.state[dp[n]][k], dcpu.optimizer.state[p][k])
            for k in ('mu', 'nu')]
    sd = dgpu.disc.state_dict()
    pairs += [(sd[n], t) for n, t in dcpu.disc.state_dict().items()
              if 'running' in n]
    worst = max(_rel_l2(o, w) for o, w in pairs if w.abs().max() > 0)
    ok = worst_loss <= 1e-5 and worst <= TOL_GAN_REL
    say(f'[gan] one fp32 generator + discriminator step (batch {b}, '
        f'segment 1, full widths): card vs CPU, losses within '
        f'{worst_loss:.2e} relative <= 1e-5, {len(pairs)} tensors (masters, '
        f'EMA, moments, D params, statistics and moments) within '
        f'{worst:.2e} relative L2 <= {TOL_GAN_REL}: '
        f'{"ok" if ok else "FAIL"}; the card step launched K1 '
        f'{launched["fused_adaln_norm"]}, K2 {launched["fused_qk_rope"]}, '
        f'K4 {launched["flash_masked_attention_bounded"]}')
    if not ok:
        raise AssertionError(f'GAN parity: {worst_loss}, {worst}')


def phase_gan(card, out_dir):
    """Phase 16 (c): cli/train_cifar_gan on the card (see the module
    docstring). Returns the run's launches."""
    import numpy as np
    import torch
    from fitv2_tpu_torch.cli import train_cifar_gan
    cifar = _synthetic_cifar(os.path.join(out_dir, 'cifar'))
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    out = train_cifar_gan.main([
        '--cifar', cifar, '--steps', str(GAN_STEPS), '--batch',
        str(GAN_BATCH), '--disc-start', str(GAN_DISC_START), '--seed',
        str(SEED)])
    torch.cuda.synchronize()
    counts = _lwd_read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    hist = out['history']
    # a step: the segment's training forward, then the fake recomputed
    # with the updated generator: 3 blocks each (12 / 4 segments)
    blocks = out['model'].layers_per_flow
    want = _lwd_counts(2 * GAN_STEPS, dict(
        fused_adaln_norm=2 * blocks + 1, fused_qk_rope=blocks,
        flash_masked_attention=blocks, flash_masked_attention_bounded=blocks))
    if counts != want:
        raise AssertionError(f'GAN: launch counts {counts} != {want}')
    finite = all(np.isfinite(list(h.values())).all() for h in hist)
    stats = [t for n, t in out['disc_state'].disc.state_dict().items()
             if 'running' in n]
    finite = finite and all(bool(torch.isfinite(t).all()) for t in stats)
    adv = all(h['loss'] != h['base_loss'] and h['d_loss'] != 0.0
              for h in hist[GAN_DISC_START:])
    gated = all(h['loss'] == h['base_loss'] and h['d_loss'] == 0.0
                for h in hist[:GAN_DISC_START - 1])
    ms = statistics.median(h['ms'] for h in hist[GAN_WARM:])
    ok = finite and adv and gated
    say(f'[gan] cli/train_cifar_gan on the card: FiTLwD student (hidden '
        f'384, depth 12, 6 heads of 64, K 4, 256 tokens of 2x2x3) + '
        f'PatchGAN (ndf 64, 3 layers, BatchNorm), fp32, batch {GAN_BATCH}, '
        f'{GAN_STEPS} steps, --disc-start {GAN_DISC_START}: losses and BN '
        f'statistics finite, the adversarial terms 0 before step '
        f'{GAN_DISC_START} and live from it: {"ok" if ok else "FAIL"}; '
        f'first step gen {hist[0]["loss"]:.4f} d {hist[0]["d_loss"]:.4f}, '
        f'last gen {hist[-1]["loss"]:.4f} (base {hist[-1]["base_loss"]:.4f},'
        f' g {hist[-1]["g_loss"]:.4f}) d {hist[-1]["d_loss"]:.4f}; '
        f'launches {counts} == expected (a step: the training forward and '
        f'the recomputed fake, each K1 {2 * blocks + 1}, K2 and K4 '
        f'{blocks}; their backward passes are PyTorch); a step (gen step + '
        f'fake + disc step, a sync at its end) {ms:.2f} ms, the median of '
        f'steps {GAN_WARM}-{GAN_STEPS - 1} = {GAN_BATCH / ms * 1e3:.1f} '
        f'images/s; peak memory {peak:.2f} GiB [{card}]')
    if not ok:
        raise AssertionError('GAN: a loss or statistic not finite, or the '
                             'disc_start gate wrong')
    return counts, ms, peak


# phase 17 (the captures, data parallel): the capture's and rel-PE's card
# vs CPU bounds (fp32); rel-PE's depth; the trajectory's Euler steps; the
# data-parallel runs' ranks (torchrun processes sharing the one card over
# gloo), the trainer's depth, global batch and steps, and the gradient
# bound against one process; the sampling CLI's depth, images, steps and
# per-process batch
TOL_CAPTURE = 1e-5
REL_PE_DEPTH = 4
TRAJ_STEPS = 50
DP_WORLD = 2
DP_DEPTH, DP_BATCH, DP_STEPS = 4, 32, 3
TOL_DP_GRAD = 1e-5
DP_SAMPLES, DP_SAMPLE_STEPS, DP_SAMPLE_BATCH = 16, 10, 4


def _xl_capture_pair(model_cpu):
    """model_cpu's weights in FiT(save_attention=True) on the CPU (the same
    tensors, built on the meta device: no init) and a copy on the card."""
    import torch
    from fitv2_tpu_torch.models import FiT
    with torch.device('meta'):
        cap = FiT(**XL, save_attention=True)
    cap.load_state_dict(model_cpu.state_dict(), assign=True)
    return cap.eval(), copy.deepcopy(cap).to('cuda')


def _cuda_ms(fn, reps=3, warm=True):
    """The median host time of `reps` calls of fn, each from a sync to a
    sync, after one call unless `warm` is False."""
    import torch
    if warm:
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_capture(model_cpu, card):
    """Phase 17 (a): XL/2 (depth 36) fp32 with save_attention, batch 1, one
    forward on the full 16 x 16 grid: every block's map, card vs CPU;
    exact launches; the forward's time with and without the capture."""
    import numpy as np
    import torch
    from fitv2_tpu_torch.eval.attention_viz import run_with_attention
    from fitv2_tpu_torch.models import FiT
    from fitv2_tpu_torch.models.grid_utils import make_grid_mask_size
    cap_cpu, cap_gpu = _xl_capture_pair(model_cpu)
    gen = torch.Generator().manual_seed(SEED + 70)
    x = torch.randn(1, N, 16, generator=gen)
    t, y = torch.tensor([0.6]), torch.tensor([207])
    grid, _, size = make_grid_mask_size(1, 16, 16, N)
    args_cpu = (x, t, y, grid, None, size)
    args_gpu = tuple(None if a is None else a.cuda() for a in args_cpu)
    _reset_counts()
    out_gpu, maps_gpu = run_with_attention(cap_gpu, *args_gpu)
    torch.cuda.synchronize()
    counts = _lwd_read_counts()
    want = _lwd_counts(1, dict(
        fused_adaln_norm=2 * XL['depth'] + 1, fused_qk_rope=XL['depth'],
        flash_masked_attention=XL['depth'],
        flash_masked_attention_bounded=XL['depth']))
    t0 = time.perf_counter()
    out_cpu, maps_cpu = run_with_attention(cap_cpu, *args_cpu)
    t_cpu = time.perf_counter() - t0
    err = max(float(np.abs(a - b).max()) for a, b in zip(maps_gpu, maps_cpu))
    rel = ((out_gpu.cpu() - out_cpu).norm() / out_cpu.norm()).item()
    rows = max(float(np.abs(m.sum(-1) - 1).max()) for m in maps_gpu)
    shapes = {m.shape for m in maps_gpu}
    with torch.device('meta'):
        plain = FiT(**XL)
    plain.load_state_dict(cap_gpu.state_dict(), assign=True)
    plain.eval()
    with torch.no_grad():
        ms_plain = _cuda_ms(lambda: plain(*args_gpu))
    ms_cap = _cuda_ms(lambda: run_with_attention(cap_gpu, *args_gpu))
    ok = (len(maps_gpu) == XL['depth'] and shapes == {(1, H, N, N)}
          and err <= TOL_CAPTURE and rel <= TOL_SLICE_REL_L2
          and counts == want)
    say(f'[capture] XL/2 depth {XL["depth"]} fp32 save_attention, batch 1, '
        f'one forward (16 x 16 tokens): {len(maps_gpu)} maps {shapes}, rows '
        f'sum to 1 within {rows:.1e}; card vs CPU: maps max |diff| '
        f'{err:.3e} <= {TOL_CAPTURE}, output relative L2 {rel:.3e}: '
        f'{"ok" if ok else "FAIL"}; launches {counts} == expected (K1 '
        f'{2 * XL["depth"] + 1}, K2 {XL["depth"]}, K4 {XL["depth"]}); the '
        f'forward {ms_cap:.2f} ms with the capture (maps copied to the '
        f'host), {ms_plain:.2f} ms without (CPU {t_cpu:.1f} s) [{card}]')
    if not ok:
        raise AssertionError(f'capture: maps {err}, output {rel}, counts '
                             f'{counts}')
    del cap_gpu, plain
    torch.cuda.empty_cache()
    return counts, err


def phase_rel_pe_v(card):
    """Phase 17 (b): add_rel_pe_to_v at XL width, depth REL_PE_DEPTH, fp32,
    batch 2 on the padded 10 x 20 bucket, one forward card vs CPU; K2 never
    (q/k take the plain LayerNorm and the interleaved RoPE, v too)."""
    import torch
    from fitv2_tpu_torch.models.grid_utils import make_grid_mask_size
    model = _xl_model_fp32(REL_PE_DEPTH, add_rel_pe_to_v=True)
    if model.rope_config.layout != 'interleaved':
        raise AssertionError('rel-PE on v: the tables must be interleaved')
    gen = torch.Generator().manual_seed(SEED + 71)
    grid, mask, size = make_grid_mask_size(2, 10, 20, N)
    args = (torch.randn(2, N, 16, generator=gen), torch.tensor([0.3, 0.8]),
            torch.tensor([207, 1000]), grid, mask, size)
    gpu = copy.deepcopy(model).to('cuda')
    args_gpu = tuple(a.cuda() for a in args)
    with torch.no_grad():
        ref = model(*args)
        _reset_counts()
        out = gpu(*args_gpu)
        torch.cuda.synchronize()
        counts = _lwd_read_counts()
        ms = _cuda_ms(lambda: gpu(*args_gpu))
    want = _lwd_counts(1, dict(
        fused_adaln_norm=2 * REL_PE_DEPTH + 1,
        flash_masked_attention=REL_PE_DEPTH,
        flash_masked_attention_bounded=REL_PE_DEPTH))
    rel = ((out.cpu() - ref).norm() / ref.norm()).item()
    ok = rel <= TOL_CAPTURE and counts == want and ref.norm() > 0
    say(f'[rel-pe v] XL width depth {REL_PE_DEPTH} fp32 add_rel_pe_to_v, '
        f'batch 2, 200 of 256 tokens valid, one forward card vs CPU: '
        f'relative L2 {rel:.3e} <= {TOL_CAPTURE}: {"ok" if ok else "FAIL"}; '
        f'launches {counts} == expected (K2 0: plain q/k LayerNorm and '
        f'interleaved RoPE on q, k and v); {ms:.2f} ms [{card}]')
    if not ok:
        raise AssertionError(f'rel-pe v: {rel}, counts {counts}')
    return counts, rel


def phase_trajectory(model_cpu, card):
    """Phase 17 (c): bf16 XL/2 256 x 256, batch 8, TRAJ_STEPS Euler steps
    with return_trajectory: every step's state kept, the last one the
    latents decoded bit for bit, the same latents as the sampler without
    the trajectory; exact launches; both calls' times."""
    import torch
    from fitv2_tpu_torch.sample import SamplingConfig, build_sampler
    model = copy.deepcopy(model_cpu).to('cuda', torch.bfloat16)
    scfg = SamplingConfig(num_sampling_steps=TRAJ_STEPS, cfg_scale=CFG_SCALE,
                          per_device_batch=BATCH, dtype=torch.bfloat16)
    labels = torch.arange(BATCH) * 111 % 1000
    z = torch.randn(BATCH, N, 16, generator=torch.Generator().manual_seed(
        SEED + 72))
    plain = build_sampler(model, scfg)
    traced = build_sampler(model, scfg, return_trajectory=True)
    out_plain = plain(labels, z=z)  # also the warm-up
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, traj = traced(labels, z=z)
    torch.cuda.synchronize()
    ms_traj = (time.perf_counter() - t0) * 1e3
    counts = _lwd_read_counts()
    ms_plain = _cuda_ms(lambda: plain(labels, z=z), reps=1, warm=False)
    want = _lwd_counts(TRAJ_STEPS, dict(
        fused_adaln_norm=2 * XL['depth'] + 1, fused_qk_rope=XL['depth'],
        flash_masked_attention=XL['depth'],
        flash_masked_attention_bounded=XL['depth']))
    last = model.unpatchify(traj[-1][:, :N], (32, 32), channel_last=True)
    last = last[..., :model.in_channels].permute(0, 3, 1, 2)
    same = torch.equal(last, out) and torch.equal(out, out_plain)
    ok = (same and counts == want and traj.dtype == torch.float32
          and tuple(traj.shape) == (TRAJ_STEPS, BATCH, N, 16)
          and bool(torch.isfinite(traj).all()))
    say(f'[trajectory] XL/2 bf16 256x256 batch {BATCH}, {TRAJ_STEPS} steps, '
        f'CFG {CFG_SCALE}, return_trajectory: traj {tuple(traj.shape)} '
        f'{traj.dtype}, finite; traj[-1] decodes to the latents bit for bit '
        f'and they equal the sampler without the trajectory: {same}: '
        f'{"ok" if ok else "FAIL"}; launches {counts} == expected; '
        f'{ms_traj:.1f} ms with the trajectory, {ms_plain:.1f} ms without '
        f'[{card}]')
    if not ok:
        raise AssertionError(f'trajectory: same {same}, counts {counts}')
    del model, traj
    torch.cuda.empty_cache()
    return counts


TORCHRUN_ECHO = 40  # the lines of a torchrun call's output echoed


def _torchrun(argv, env=None, timeout=600, nproc=None):
    """`python -m torch.distributed.run` with `nproc` (DP_WORLD) processes
    on this host (static rendezvous on a free localhost port) running
    argv; its output is echoed, a failure raises."""
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, '-m', 'torch.distributed.run', '--nnodes', '1',
           '--nproc_per_node', str(nproc or DP_WORLD), '--master_addr',
           '127.0.0.1',
           '--master_port', str(port), *argv]
    # gloo binds the loopback interface: the machine has no other network
    env = dict(os.environ, GLOO_SOCKET_IFNAME='lo', **(env or {}))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True,
                          timeout=timeout)
    secs = time.perf_counter() - t0
    for line in proc.stdout.splitlines()[-TORCHRUN_ECHO:]:
        say(f'  | {line}')
    if proc.returncode != 0:
        raise AssertionError(f'torchrun {argv}: exited {proc.returncode}')
    return secs


def _dp_train_cfg(out_dir, world):
    """The YAMLs of phase 17 (d): configs/fitv2_xl.yaml with a merged one
    that cuts the depth, sets the per-process batch of a DP_BATCH global
    batch on `world` processes, phase 11's shards and no warm-up."""
    import yaml
    path = os.path.join(out_dir, f'dp_train_{world}.yaml')
    with open(path, 'w') as f:
        yaml.safe_dump({
            'diffusion': {'network_config': {'params': {'depth': DP_DEPTH}}},
            'data': {'params': {'train': {
                'data_path': os.path.join(out_dir, 'latents'),
                'loader': {'batch_size': DP_BATCH // world,
                           'num_workers': 4}}}},
            'accelerate': {'lr_warmup_steps': 0,
                           'checkpointing_steps': 1000}}, f)
    return ['configs/fitv2_xl.yaml', path]


def dp_train_run(out_dir, world):
    """cli/train.py's path on this process (one of `world` under torchrun,
    or alone): init_distributed, build_trainer on _dp_train_cfg, in fp32
    (mixed_precision 'no'), each rank's weights seeded by its rank (a fresh
    run starts from rank 0's); DP_STEPS steps. Writes, per rank, the ms a
    step, the launches and whether the ranks' parameters are bit-identical
    after the run, and rank 0 the first step's gradient (reduced and
    clipped, as the optimizer took it)."""
    import torch
    from fitv2_tpu_torch.cli import train as cli
    from fitv2_tpu_torch.parallel import init_distributed
    from fitv2_tpu_torch.train.trainer import Trainer
    from fitv2_tpu_torch.utils import load_config
    from fitv2_tpu_torch.utils.misc import check_cross_process_consistency
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run_dir = os.path.join(out_dir, f'dp_run_{world}')
    args = cli.parse_args(['--cfgdir', *_dp_train_cfg(out_dir, world),
                           '--output-dir', run_dir, '--max-steps',
                           str(DP_STEPS), '--no-resume', '--device', 'cuda'])
    rank, got_world = init_distributed(args.device)
    if got_world != world:
        raise AssertionError(f'dp train: {got_world} processes, not {world}')
    torch.manual_seed(SEED + rank)
    built = cli.build_trainer(load_config(args.cfgdir), args)
    trainer = Trainer(built.master_model, dataclasses.replace(
        built.cfg, mixed_precision='no'), transport=built.transport)
    del built
    grads, times = [], []
    init_state, train_step = trainer.init_state, trainer._train_step

    def capturing_init():
        state = init_state()
        step = state.optimizer.step

        def capture_then_step():
            if not grads:
                grads.append(torch.cat([p.grad.reshape(-1) for p in
                                        state.params.values()]).cpu())
            step()
        state.optimizer.step = capture_then_step
        return state

    def timed_step(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train_step(*a, **k)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return out

    trainer.init_state, trainer._train_step = capturing_init, timed_step
    _reset_counts()
    state = trainer.train(max_steps=DP_STEPS, resume=False)
    torch.cuda.synchronize()
    counts = _lwd_read_counts()
    params = torch.cat([p.reshape(-1) for p in state.params.values()])
    same = check_cross_process_consistency(params, 'parameters')
    if rank == 0:
        torch.save(grads[0], os.path.join(out_dir, f'dp_grad_{world}.pt'))
    with open(os.path.join(out_dir, f'dp_train_{world}_{rank}.json'),
              'w') as f:
        json.dump(dict(ms=times, counts=counts, same=same,
                       batch=trainer.cfg.global_batch_size), f)


def phase_dp_train(card, out_dir):
    """Phase 17 (d): cli/train.py under torchrun, DP_WORLD processes on the
    one card over gloo (dp_train_run in each), then the same run in this
    one process: the reduced gradient against one process's, the ranks'
    parameters bit-identical, the ms a step of each."""
    import torch
    torch.cuda.empty_cache()
    secs = _torchrun([os.path.abspath(__file__), '--dp-child', 'train',
                      out_dir])
    dp_train_run(out_dir, 1)
    ranks = []
    for r in range(DP_WORLD):
        with open(os.path.join(out_dir, f'dp_train_{DP_WORLD}_{r}.json')) as f:
            ranks.append(json.load(f))
    with open(os.path.join(out_dir, 'dp_train_1_0.json')) as f:
        one = json.load(f)
    g2, g1 = (torch.load(os.path.join(out_dir, f'dp_grad_{w}.pt'))
              for w in (DP_WORLD, 1))
    rel = ((g2 - g1).norm() / g1.norm()).item()
    want = _lwd_counts(DP_STEPS, dict(
        fused_adaln_norm=2 * DP_DEPTH + 1, fused_qk_rope=DP_DEPTH,
        flash_masked_attention=DP_DEPTH,
        flash_masked_attention_bounded=DP_DEPTH))
    ms2 = statistics.median(ranks[0]['ms'][1:])
    ms1 = statistics.median(one['ms'][1:])
    ok = (rel <= TOL_DP_GRAD and all(r['same'] for r in ranks)
          and all(r['counts'] == want for r in ranks)
          and one['counts'] == want and ranks[0]['batch'] == DP_BATCH
          and one['batch'] == DP_BATCH)
    say(f'[dp train] cli/train.py under torchrun, {DP_WORLD} processes on '
        f'the one card (gloo), XL width depth {DP_DEPTH} fp32, global batch '
        f'{DP_BATCH} ({DP_BATCH // DP_WORLD} a process), {DP_STEPS} steps, '
        f'each rank seeded apart (the run starts from rank 0\'s weights): '
        f'the first step\'s reduced gradient vs one process on the whole '
        f'batch: relative L2 {rel:.3e} <= {TOL_DP_GRAD}; the ranks\' '
        f'parameters bit-identical after the run: '
        f'{[r["same"] for r in ranks]}; launches a rank {ranks[0]["counts"]}'
        f' == expected: {"ok" if ok else "FAIL"}; ms a step (steps 2-'
        f'{DP_STEPS}, from a sync to a sync, the gradient all-reduce '
        f'through the host included): {DP_WORLD} processes '
        f'{ms2:.1f} ms ({ranks[0]["ms"]}), one process {ms1:.1f} ms '
        f'({one["ms"]}); the torchrun call {secs:.1f} s [{card}]')
    if not ok:
        raise AssertionError(f'dp train: gradient {rel}, ranks {ranks}')
    return ranks[0]['counts'], dict(grad_rel_l2=rel, ms_dp=ms2, ms_one=ms1)


def _reference_checkpoint(path, depth, seed):
    """A seeded random XL/2 (depth `depth`) in the reference layout (the
    names cli/sample's --ckpt reads; SwiGLU's fc1 as fc1_g and fc1_x), as
    a torch .pt; every leaf N(0, 0.02), so the velocity is not 0."""
    import torch
    from fitv2_tpu_torch.models import FiT
    with torch.device('meta'):
        model = FiT(**dict(XL, depth=depth))
    renames = ((r'^t_embedder\.mlp_(\d)', r't_embedder.mlp.\1'),
               (r'^y_embedder\.embedding_table$',
                'y_embedder.embedding_table.weight'),
               (r'adaLN_modulation\.fc1\.', 'adaLN_modulation.1.'),
               (r'^(blocks\.\d+\.)adaLN_modulation\.fc_out\.',
                r'\1adaLN_modulation.2.'),
               (r'adaLN_modulation\.fc_out\.', 'adaLN_modulation.1.'))
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for name, p in model.named_parameters():
        for pat, rep in renames:
            name = re.sub(pat, rep, name)
        value = 0.02 * torch.randn(p.shape, generator=gen)
        if '.mlp.fc1.' in name:
            g, v = value.chunk(2, dim=0)
            sd[name.replace('fc1', 'fc1_g')] = g.clone()
            sd[name.replace('fc1', 'fc1_x')] = v.clone()
        else:
            sd[name] = value
    torch.save(sd, path)


def phase_dp_sample(card, out_dir):
    """Phase 17 (e): cli/sample --data-parallel under torchrun, DP_WORLD
    processes on the one card, XL/2 at depth 4 from a reference-layout
    checkpoint, DP_SAMPLES images, DP_SAMPLE_STEPS steps: rank r's images
    equal this process's sampler called with rank r's draws."""
    import numpy as np
    import torch
    import yaml
    from fitv2_tpu_torch.ckpt import load_fit_checkpoint
    from fitv2_tpu_torch.sample import SamplingConfig, build_sampler
    from fitv2_tpu_torch.sample.pipeline import _batch_inputs
    from fitv2_tpu_torch.utils import config_to_model
    depth = DP_DEPTH
    net = {'target': 'fitv2_tpu.models.fit.FiT',
           'params': dict(XL, depth=depth)}
    cfg_path = os.path.join(out_dir, 'dp_sample.yaml')
    with open(cfg_path, 'w') as f:
        yaml.safe_dump({'diffusion': {'network_config': net}}, f)
    ckpt = os.path.join(out_dir, 'dp_sample.pt')
    _reference_checkpoint(ckpt, depth, SEED + 73)
    npz = os.path.join(out_dir, 'dp_sample.npz')
    secs = _torchrun(['-m', 'fitv2_tpu_torch.cli.sample', '--cfgdir',
                      cfg_path, '--ckpt', ckpt, '--num-fid-samples',
                      str(DP_SAMPLES), '--per-device-batch',
                      str(DP_SAMPLE_BATCH), '--num-sampling-steps',
                      str(DP_SAMPLE_STEPS), '--global-seed', str(SEED),
                      '--data-parallel', '--device', 'cuda', '--out', npz])
    arr = np.load(npz)['arr_0']
    model = config_to_model(net)
    load_fit_checkpoint(ckpt, model)
    fn = build_sampler(model.to('cuda').eval(), SamplingConfig(
        num_sampling_steps=DP_SAMPLE_STEPS,
        per_device_batch=DP_SAMPLE_BATCH))
    per = DP_SAMPLES // DP_WORLD
    same = []
    for r in range(DP_WORLD):
        for b in range(per // DP_SAMPLE_BATCH):
            labels, gen = _batch_inputs(SEED, b, DP_SAMPLE_BATCH, 1000, r)
            want = fn(labels, generator=gen).cpu().numpy()
            lo = r * per + b * DP_SAMPLE_BATCH
            same.append(bool(np.array_equal(arr[lo:lo + DP_SAMPLE_BATCH],
                                            want)))
    moved = float(np.abs(arr).mean())
    ok = (arr.shape == (DP_SAMPLES, 4, 32, 32) and all(same)
          and np.isfinite(arr).all())
    say(f'[dp sample] cli/sample --data-parallel under torchrun, {DP_WORLD} '
        f'processes on the one card, XL/2 depth {depth} (a reference-layout '
        f'checkpoint), {DP_SAMPLES} images, {DP_SAMPLE_STEPS} steps, batch '
        f'{DP_SAMPLE_BATCH}: npz {arr.shape} (mean |latent| {moved:.3f}); '
        f'each rank\'s batch equals this process\'s sampler on that rank\'s '
        f'draws, bit for bit: {same}: {"ok" if ok else "FAIL"}; the '
        f'torchrun call {secs:.1f} s [{card}]')
    if not ok:
        raise AssertionError(f'dp sample: {arr.shape}, {same}')
    del model, fn
    torch.cuda.empty_cache()


def dp_child_main(name, out_dir):
    """A process of phase 17's torchrun (`--dp-child NAME DIR`)."""
    if name != 'train':
        raise SystemExit(f'chip_smoke --dp-child: unknown {name!r}')
    dp_train_run(out_dir, DP_WORLD)


DETERMINISTIC_ENV = {'CUBLAS_WORKSPACE_CONFIG': ':4096:8'}
CHILD_PHASES = {'train': phase_train_deterministic,
                'fitv1_train': phase_fitv1_train,
                'lwd_train': phase_lwd_train_deterministic}


# phase 18 (model sharding): the processes of the torchrun call (gloo on
# the one card, NCCL with a card each), the FiTv2-3B runs' depth, global
# batch and steps, HR-3B's depth and batch, the pipeline's microbatches,
# BFM-XL's depth and batch, the bf16 rate run's steps, the gradient bound
# and the fsdp bytes bound against one process
SH_WORLD = int(os.environ.get('CHIP_SMOKE_SHARD_WORLD', '2'))
# depth 2 keeps the phase near 200 s on one card (depth 4: 319 s); the
# stage run needs a block a stage at least
SH_DEPTH, SH_BATCH, SH_STEPS = max(2, SH_WORLD), 8, 2
SH_HR_DEPTH, SH_HR_BATCH = 2, max(2, SH_WORLD)  # a row a process at least
SH_MICRO = 4
SH_LWD_DEPTH, SH_LWD_BATCH = 6, 4
SH_RESUME_DEPTH = SH_DEPTH  # (f) in bf16 also gives (a)'s rate
TOL_SHARD_GRAD = TOL_DP_GRAD
SH_FSDP_BYTES = 0.55
TOL_SHARD_CAME = 1e-5
SH_HOOK = dict(image_height=256, image_width=256, num_sampling_steps=4,
               cfg_scale=1.5, per_device_batch=2)
SH_RUNS = {  # name -> (config, its mesh keys under SH_WORLD processes)
    'fsdp': ('configs/fitv2_3b.yaml', dict(mesh_fsdp=SH_WORLD)),
    'tensor': ('configs/fitv2_3b.yaml', dict(mesh_tensor=SH_WORLD)),
    'came': ('configs/fitv2_3b.yaml', dict(mesh_tensor=SH_WORLD)),
    'sequence': ('configs/fitv2_hr_3b.yaml',
                 dict(mesh_sequence=SH_WORLD)),
    'stage': ('configs/fitv2_3b.yaml', dict(mesh_stage=SH_WORLD,
                                            pp_microbatches=SH_MICRO)),
    'lwd': ('configs/bfm_xl.yaml', dict(mesh_fsdp=SH_WORLD)),
}


def _shard_yaml(out_dir, name, world, precision='no', depth=None):
    """The YAML merged after run `name`'s config: its depth cut, the
    per-process batch of its global batch on `world` processes, the
    synthetic shards, no warm-up, and its mesh keys (all 1 in one
    process). `precision` names the file only: the CLI reads no
    precision key (`_build_trainer` sets it)."""
    import yaml
    config, mesh = SH_RUNS[name]
    keys = dict(mesh_fsdp=1, mesh_tensor=1, mesh_sequence=1, mesh_stage=1)
    if world > 1:
        keys.update(mesh)
    if name == 'lwd':
        params = dict(depth=SH_LWD_DEPTH,
                      number_of_representation_blocks=SH_LWD_DEPTH)
        batch, data = SH_LWD_BATCH, 'sh_lwd_latents'
    elif name == 'sequence':
        params, batch, data = dict(depth=SH_HR_DEPTH), SH_HR_BATCH, \
            'sh_hr_latents'
    else:
        params, batch, data = dict(depth=depth or SH_DEPTH), SH_BATCH, \
            'sh_latents'
    # a file a process: the ranks write theirs at once
    path = os.path.join(out_dir, f'shard_{name}_{world}_{precision}_'
                        f'{os.environ.get("RANK", "0")}.yaml')
    with open(path, 'w') as f:
        yaml.safe_dump({
            'diffusion': {'network_config': {'params': params}},
            'data': {'params': {'train': {
                'data_path': os.path.join(out_dir, data),
                'loader': {'batch_size': batch // world,
                           'num_workers': 2}}}},
            'accelerate': dict(keys, lr_warmup_steps=0,
                               checkpointing_steps=1000)}, f)
    return [config, path]


def _shard_expected(name, steps):
    """Exact launches a rank of `steps` steps of run `name`: under
    'dots' each block's K1 (twice), K2 and K4 run again in the backward's
    recompute, the final layer's K1 once; a stage runs depth/S blocks on
    each of SH_MICRO microbatches; an LwD step is one segment update."""
    if name == 'lwd':
        return None  # from the trainer's model (_lwd_update_counts)
    L = SH_HR_DEPTH if name == 'sequence' else SH_DEPTH
    per = L // SH_WORLD * SH_MICRO if name == 'stage' else L
    k1 = (4 * per + 1) * steps
    k2 = 2 * per * steps
    return {'fused_adaln_norm': k1, 'fused_qk_rope': k2,
            'flash_masked_attention': k2,
            'flash_masked_attention_bounded': k2}


@contextlib.contextmanager
def _models_built(precision=None, randomise_zeros=False):
    """While open, cli/train.py's trainer computes in `precision` ('no':
    fp32; the CLI reads no such key) and, with `randomise_zeros`, every
    model the CLIs build has its all-zero parameters (the adaLN-zero
    layers, the final layer, the biases) drawn N(0, 0.02^2) from one
    seed, the same in every process: at the zero init only the final
    layer's linear has a gradient at step 1, which every rank of the
    tensor and stage runs computes on the whole batch, so the gradient
    check would not see the trunk's sharding."""
    import torch
    from fitv2_tpu_torch import utils
    from fitv2_tpu_torch.train import trainer as tr
    from fitv2_tpu_torch.utils import config as ucfg
    build, config = ucfg.config_to_model, tr.TrainerConfig

    def randomised(*a, **k):
        model = build(*a, **k)
        gen = torch.Generator().manual_seed(SEED + 18)
        with torch.no_grad():
            for p in model.parameters():
                if not p.any():
                    p.copy_(0.02 * torch.randn(p.shape, generator=gen))
        return model
    try:
        if randomise_zeros:
            utils.config_to_model = ucfg.config_to_model = randomised
        if precision is not None:
            tr.TrainerConfig = lambda **kw: config(
                **kw, mixed_precision=precision)
        yield
    finally:
        utils.config_to_model = ucfg.config_to_model = build
        tr.TrainerConfig = config


def _trunk(model):
    """The names of `model`'s parameters that lie in its FiT blocks."""
    from fitv2_tpu_torch.models.modules import FiTBlock
    return {f'{bn}.{pn}' for bn, b in model.named_modules()
            if isinstance(b, FiTBlock) for pn, _ in b.named_parameters()}


def _state_bytes(state):
    """This rank's parameter + state bytes: masters, EMA, the optimizer's
    state (Adam's moments; CAME's m and statistics)."""
    n = sum(2 * p.numel() * p.element_size()  # the master and its EMA
            for p in state.params.values())
    for st in state.optimizer.state.values():
        n += sum(t.numel() * t.element_size() for t in st.values()
                 if hasattr(t, 'numel'))
    return n


def _shard_ref(name):
    """The tag of the one-process run that run `name` is held against."""
    return f'{"fsdp" if name in ("tensor", "stage") else name}_1_no'


def shard_train_run(out_dir, name, world, steps=SH_STEPS, precision='no',
                    depth=None, tag=None):
    """Run `name`'s CLI path on this process (one of `world` under
    torchrun, or alone): init_distributed, build_trainer on _shard_yaml,
    `steps` steps, the checkpoint writes skipped ((f) checks them; a 3B
    state is GBs of the machine's disk). Writes, per rank, the ms a step,
    the launches, the parameter + state bytes, the peak memory, the step
    losses and whether the ranks' gathered parameters agree. The first
    update's gradient (reduced and clipped, in the one-process layout):
    alone, written to disk; sharded, rank 0 holds it against that file's
    (relative L2, in its JSON), the whole and the trunk's blocks alone,
    with the blocks' share of its norm. The all-zero parameters start
    random (`_models_built`), so that the blocks have a gradient."""
    import torch
    from fitv2_tpu_torch.parallel import init_distributed, process_index
    from fitv2_tpu_torch.utils import load_config
    from fitv2_tpu_torch.utils.misc import check_cross_process_consistency
    if name == 'lwd':
        from fitv2_tpu_torch.cli import train_lwd as cli
    else:
        from fitv2_tpu_torch.cli import train as cli
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag = tag or f'{name}_{world}_{precision}'
    came = name == 'came'
    args = cli.parse_args([
        '--cfgdir', *_shard_yaml(out_dir, name, world, precision, depth),
        '--output-dir', os.path.join(out_dir, f'shard_run_{tag}'),
        '--max-steps', str(steps), '--no-resume', '--device', 'cuda']
        + (['--came'] if came else []))
    rank, got = init_distributed(args.device)
    if got != world:
        raise AssertionError(f'shard {name}: {got} processes, not {world}')
    torch.manual_seed(SEED + 18)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _models_built(None if name == 'lwd' else precision, True):
        trainer = cli.build_trainer(load_config(args.cfgdir), args)
    t_build = time.perf_counter() - t0
    saved = {}

    def save(step, state_dict):  # (g) keeps its checkpoint in memory
        if came:
            saved['sd'] = state_dict
    trainer.ckpt.save = save
    if name == 'lwd':  # one segment update a batch (the config: 3)
        trainer.cfg.segments_per_step = 1
    metric_hook, hook_counts = None, {}
    if came and world > 1:
        hook = _shard_hook(trainer, out_dir, f'shard_previews_{rank}')
        hook.attach(trainer.gathered_ema)
        trainer.cfg.log_every = 1  # the metric hook runs at logged steps

        def metric_hook(step, metrics):
            before = _counts_now()
            hook(step, metrics)
            hook_counts[step] = _counts_minus(_counts_now(), before)
    layout = trainer.layout
    names = layout.names if layout is not None else list(
        dict(trainer.master_model.named_parameters()))
    trunk = _trunk(trainer.master_model)
    grads, times, losses = [], [], []
    init_state = trainer.init_state

    def capturing_init():
        state = init_state()
        step = state.optimizer.step

        def capture_then_step():
            if not grads:
                if layout is None:
                    full = [p.grad.reshape(-1) for p in state.params.values()]
                else:
                    full = [layout.to_full(n, state.params[n].grad if n in
                                           state.params else None
                                           ).reshape(-1)
                            for n in layout.names]
                grads.append(torch.cat(full).cpu())
                grads.append(torch.cat([  # the trunk's blocks
                    torch.full((f.numel(),), n in trunk, dtype=torch.bool)
                    for n, f in zip(names, full)]))
            step()
        state.optimizer.step = capture_then_step
        return state

    inner = trainer._train_step

    def timed_step(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*a, **k)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(out[1]['loss']))
        return out

    trainer.init_state, trainer._train_step = capturing_init, timed_step
    _reset_counts()
    t0 = time.perf_counter()
    state = trainer.train(max_steps=steps, resume=False,
                          metric_hook=metric_hook)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    counts = _lwd_read_counts()
    for hc in hook_counts.values():  # the preview's launches apart
        counts = _counts_minus(counts, hc)
    want = _shard_expected(name, steps)
    if want is None:
        want = {k: v * steps for k, v in
                _lwd_update_counts(trainer.model).items()}
    full = torch.cat([(layout.to_full(n, state.params.get(n))
                       if layout is not None else state.params[n]
                       ).reshape(-1) for n in (layout.names if layout
                                               else state.params)])
    # the ranks compare a checksum of the gathered parameters' bits (the
    # sum, and the sum weighted by position mod 8191), not 3B parameters
    bits = full.view(torch.int32).long()
    weight = torch.arange(bits.numel(), device=bits.device) % 8191 + 1
    agree = check_cross_process_consistency(
        torch.stack([bits.sum(), (bits * weight).sum()]).cpu(),
        'parameters')
    rel = rel_trunk = share = None
    if world == 1:
        torch.save(grads[0], os.path.join(out_dir, f'shard_grad_{tag}.pt'))
    elif process_index() == 0:
        ref = torch.load(os.path.join(
            out_dir, f'shard_grad_{_shard_ref(name)}.pt'), mmap=True)
        got, mask = grads
        rel = ((got - ref).norm() / ref.norm()).item()
        rel_trunk = ((got[mask] - ref[mask]).norm()
                     / ref[mask].norm()).item()
        share = (ref[mask].norm() / ref.norm()).item()
    result = dict(ms=times, counts=counts, want=want, losses=losses,
                  bytes=_state_bytes(state), agree=agree,
                  peak=torch.cuda.max_memory_allocated(),
                  batch=trainer.cfg.global_batch_size, grad_rel_l2=rel,
                  grad_rel_l2_trunk=rel_trunk, trunk_share=share,
                  build_s=t_build, train_s=t_train)
    if came and world == 1:  # what (g) is held against
        sd = saved['sd']
        torch.save({'params': {n: t.cpu() for n, t in sd['params'].items()},
                    'state': {i: {k: v.cpu() for k, v in st.items()}
                              for i, st in
                              sd['optimizer']['state'].items()}},
                   os.path.join(out_dir, 'shard_came_one.pt'))
    elif came and process_index() == 0:
        result['came'] = _shard_came_check(trainer, saved['sd'], out_dir,
                                           steps, hook_counts)
    with open(os.path.join(out_dir, f'shard_{tag}_{rank}.json'), 'w') as f:
        json.dump(result, f)
    del trainer, state, full
    torch.cuda.empty_cache()
    return result


def _shard_hook(trainer, out_dir, folder):
    """(g)'s InlineEvalHook: SH_HOOK's sampling in fp32 (no VAE: latents)
    with a one-process copy of the trainer's model, at step SH_STEPS."""
    import torch
    from fitv2_tpu_torch.sample import SamplingConfig
    from fitv2_tpu_torch.train.eval_hook import InlineEvalHook
    return InlineEvalHook(trainer.one_process_model, SamplingConfig(
        **SH_HOOK, dtype=torch.float32), every=SH_STEPS, seed=SEED + 18,
        device=trainer.device, out_dir=os.path.join(out_dir, folder))


def _shard_came_check(trainer, sd, out_dir, steps, hook_counts):
    """(g) on process 0: the checkpoint `sd` (the one-process layout)
    against the one-process CAME run's parameters and state, then a
    one-process hook on `sd`'s EMA against the sharded run's preview;
    relative L2 each, whether another rank wrote a preview, the hook's
    launches."""
    import numpy as np
    import torch
    one = torch.load(os.path.join(out_dir, 'shard_came_one.pt'), mmap=True)

    def rel(a, b):
        a, b = a.double(), b.double()
        return ((a - b).norm() / b.norm()).item()

    def flat(ts):  # on the card: 0.2 B parameters and their moments
        return torch.cat([t.reshape(-1).to('cuda', torch.float32)
                          for t in ts])
    names = list(one['params'])
    params = rel(flat(sd['params'][n] for n in names),
                 flat(one['params'][n] for n in names))
    got, want = sd['optimizer']['state'], one['state']
    if got.keys() != want.keys():
        raise AssertionError(f'came state: leaves {sorted(got)} != '
                             f'{sorted(want)}')
    state = {k: rel(flat(got[i][k] for i in sorted(got) if k in got[i]),
                    flat(want[i][k] for i in sorted(want) if k in want[i]))
             for k in ('m', 'r_row', 'r_col', 's_row', 's_col', 'r_full')}
    hook = _shard_hook(trainer, out_dir, 'shard_previews_one')
    hook.attach(lambda: sd['ema_params'])
    hook(steps, {})
    preview = [np.load(os.path.join(out_dir, d, f'preview_{steps}.npz'))[
        'arr_0'] for d in ('shard_previews_0', 'shard_previews_one')]
    return dict(params_rel=params, state_rel=state,
                preview_rel=rel(*(torch.from_numpy(p) for p in preview)),
                preview_shape=list(preview[0].shape),
                others_wrote=sorted(
                    d for d in os.listdir(out_dir)
                    if d.startswith('shard_previews_')
                    and d not in ('shard_previews_0', 'shard_previews_one')),
                hook_counts=hook_counts.get(steps))


def shard_resume_run(out_dir):
    """(f): the fsdp run of (a) in bf16: 3 steps uninterrupted, writing
    only its checkpoint at step 2 (its steps 2-3 give (a)'s bf16 rate),
    then a new trainer resumed from it to 3; rank 0 writes whether the
    two final one-process states are bit-identical, and the ms a step."""
    import torch
    from fitv2_tpu_torch.cli import train as cli
    from fitv2_tpu_torch.parallel import process_index
    from fitv2_tpu_torch.utils import load_config
    torch.use_deterministic_algorithms(True)
    states = []
    for resume in (False, True):
        cfg = _shard_yaml(out_dir, 'fsdp', SH_WORLD, 'bf16',
                          depth=SH_RESUME_DEPTH)
        args = cli.parse_args([
            '--cfgdir', *cfg, '--output-dir',
            os.path.join(out_dir, 'shard_resume'), '--max-steps', '3',
            '--device', 'cuda'] + ([] if resume else ['--no-resume']))
        torch.manual_seed(SEED + 18)
        loaded = load_config(args.cfgdir)
        loaded['accelerate']['checkpointing_steps'] = 2
        trainer = cli.build_trainer(loaded, args)  # bf16, the default
        save = trainer.ckpt.save
        trainer.ckpt.save = (lambda step, state_dict, save=save:
                             save(step, state_dict) if step == 2 else None)
        if not resume:
            inner, times = trainer._train_step, []

            def timed(*a, inner=inner, times=times, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = inner(*a, **k)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                return out
            trainer._train_step = timed
            _reset_counts()
            torch.cuda.reset_peak_memory_stats()
        state = trainer.train(max_steps=3, resume=resume)
        if not resume:
            counts, want = _lwd_read_counts(), _shard_expected('fsdp', 3)
            peak = torch.cuda.max_memory_allocated()
        states.append(trainer.layout.full_state_dict(state))
        del trainer, state
        torch.cuda.empty_cache()
    if process_index() == 0:
        a, b = states
        same = (a['step'] == b['step'] == 3 and all(
            torch.equal(a[k][n], b[k][n]) for k in ('params', 'ema_params')
            for n in a[k]) and all(
            torch.equal(a['optimizer']['state'][i][m],
                        b['optimizer']['state'][i][m])
            for i in a['optimizer']['state'] for m in ('mu', 'nu')))
        with open(os.path.join(out_dir, 'shard_resume.json'), 'w') as f:
            json.dump(dict(same=bool(same), step=b['step'], ms=times,
                           counts=counts, want=want, peak=peak), f)


def shard_child_main(out_dir):
    """A process of phase 18's torchrun (`--shard-child all DIR`): the
    runs (a)-(e), then (f), whose uninterrupted run gives (a)'s bf16
    rate."""
    import faulthandler
    faulthandler.enable()  # a crash in a collective prints its stack
    from fitv2_tpu_torch.parallel import comms, init_distributed
    init_distributed('cuda')
    for name in ('fsdp', 'tensor', 'came', 'sequence', 'stage', 'lwd'):
        with _clock(f'phase 18 {name} (a rank)'):
            shard_train_run(out_dir, name, SH_WORLD)
    with _clock('phase 18 resume and rate (a rank)'):
        shard_resume_run(out_dir)
    import torch.distributed as dist
    if dist.get_rank() == 0:
        with open(os.path.join(out_dir, 'shard_paths.json'), 'w') as f:
            json.dump({op: comms.collective_path(op) for op in (
                'all_reduce', 'all_gather', 'reduce_scatter', 'all_to_all',
                'send', 'recv', 'broadcast')} | {
                'backend': dist.get_backend()}, f)
    dist.destroy_process_group()


def _shard_ranks(out_dir, tag):
    out = []
    for r in range(SH_WORLD):
        with open(os.path.join(out_dir, f'shard_{tag}_{r}.json')) as f:
            out.append(json.load(f))
    return out


def phase_shard_kernels():
    """Phase 18 (0): K1, K2, K4 and K3 inside their Functions against
    autograd of their plain versions at the per-rank shapes the axes make
    (bf16 and fp32): K1 at D 2304 on a rank's batch (fsdp) and on N/S of
    HR-3B's tokens (sequence); K2 at Dh 96 with 24/W heads (tensor) and on
    N/S tokens with 24 (sequence); K4 over all 1024 keys with 24/W heads
    after Ulysses' exchange (800 valid) and with 24/W heads at N 256
    (tensor); K3 at BFM-XL's rank batch (fsdp). Returns the cases by
    kernel, each marked `path: 'shard'`."""
    import torch
    from fitv2_tpu_torch import kernels as K
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    W, D3, DH3 = SH_WORLD, 2304, 96
    H3 = 24 // W
    hr_n = 1024
    cases = {'adaln': [], 'qk_rope': [], 'attention': []}

    def rand(*shape, dtype):
        return torch.randn(*shape, device=dev, generator=gen).to(dtype)

    for dtype in (torch.bfloat16, torch.float32):
        for label, b, n in (('fsdp', SH_BATCH // W, N),
                            ('sequence', SH_HR_BATCH, hr_n // W)):
            x = rand(b, n, D3, dtype=dtype) * 2 + 3
            mod = rand(b, 6 * D3, dtype=dtype) * 0.5
            cases['adaln'].append(dict(_grad_case(
                f'adaln {label} ({b},{n},{D3})', dtype,
                lambda a, m: K.adaln_norm(a, *m.chunk(6, dim=-1)[:2]),
                lambda a, m: K.adaln_norm_reference(
                    a, *m.chunk(6, dim=-1)[:2]), [x, mod], 1, 'norm'),
                path='shard'))
        for label, b, n, h in (('tensor', SH_BATCH, N, H3),
                               ('sequence', SH_HR_BATCH, hr_n // W, 24)):
            qkv = rand(b, n, 3, h, DH3, dtype=dtype)
            ang = torch.rand(b, n, DH3, device=dev, generator=gen) * 6.3
            cos, sin = torch.cos(ang), torch.sin(ang)
            cases['qk_rope'].append(dict(_grad_case(
                f'qk_rope {label} ({b},{n},{h},{DH3})', dtype,
                lambda a, c=cos, s=sin: K.qk_norm_rope(*a.unbind(2)[:2], c,
                                                       s),
                lambda a, c=cos, s=sin: K.qk_norm_rope_reference(
                    *a.unbind(2)[:2], c, s), [qkv], 2, 'norm'),
                path='shard'))
        for label, b, n, h, valid in (
                ('sequence, after the exchange', SH_HR_BATCH, hr_n, H3,
                 800), ('tensor', SH_BATCH, N, H3, N_VALID)):
            q, k, v = (rand(b, n, h, DH3, dtype=dtype) for _ in range(3))
            q, k = K.qk_norm_rope_reference(
                q, k, torch.ones(b, n, DH3, device=dev),
                torch.zeros(b, n, DH3, device=dev))
            mask = torch.zeros(b, n, device=dev)
            mask[:, :valid] = 1.0
            qkv = torch.stack([q, k, v], dim=2)
            cases['attention'].append(dict(_grad_case(
                f'attention[bounded] {label} ({b},{n},{h},{DH3}, '
                f'{valid} valid)', dtype,
                lambda a, m=mask: K.masked_attention(*a.unbind(2), m,
                                                     bounded_logits=True),
                lambda a, m=mask: K.attention_bounded_reference(
                    *a.unbind(2), m), [qkv], 3, 'attention'),
                variant='bounded', mask=True, path='shard'))
        b = SH_LWD_BATCH // W
        qkv = rand(b, N, 3, 16, 72, dtype=dtype)
        cases['attention'].append(dict(_grad_case(
            f'attention[online] BFM-XL fsdp ({b},{N},16,72)', dtype,
            lambda a: K.masked_attention(*a.unbind(2), None,
                                         bounded_logits=False),
            lambda a: K.attention_reference(*a.unbind(2), None), [qkv], 3,
            'attention'), variant='online', mask=False, path='shard'))
    torch.cuda.synchronize()
    return cases


def phase_shard(card, out_dir):
    """Phase 18: the sharded runs under torchrun (`shard_child_main`),
    then the one-process runs here; the checks of each. Returns rank 0's
    launches by run and the numbers PERF.md keeps."""
    import torch
    from fitv2_tpu_torch.data import make_synthetic_latent_shards
    for sub, n, square in (('sh_latents', 256, False),
                           ('sh_hr_latents', 1024, False),
                           ('sh_lwd_latents', 256, True)):
        make_synthetic_latent_shards(os.path.join(out_dir, sub), n=32,
                                     target_len=n, n_classes=1000, seed=18,
                                     square=square)
    # one process first: (a), (b) and (d) share the 3B run; (c); (e)
    with _clock('phase 18 one-process runs'):
        one = {name: shard_train_run(out_dir, name, 1)
               for name in ('fsdp', 'sequence', 'lwd', 'came')}
    one.update(tensor=one['fsdp'], stage=one['fsdp'])
    torch.cuda.empty_cache()
    # (f)'s bit-identical resume: cuBLAS's deterministic workspace, which
    # it reads once when it starts (so for the whole call)
    secs = _torchrun([os.path.abspath(__file__), '--shard-child', 'all',
                      out_dir], env={'CUBLAS_WORKSPACE_CONFIG': ':4096:8'},
                     nproc=SH_WORLD, timeout=900)
    with open(os.path.join(out_dir, 'shard_paths.json')) as f:
        paths = json.load(f)
    ok, report = True, {}
    for name in ('fsdp', 'tensor', 'came', 'sequence', 'stage', 'lwd'):
        ranks = _shard_ranks(out_dir, f'{name}_{SH_WORLD}_no')
        rel, rel_trunk = ranks[0]['grad_rel_l2'], \
            ranks[0]['grad_rel_l2_trunk']
        share = ranks[0]['trunk_share']
        ref = one[name]
        bytes_ratio = [r['bytes'] / ref['bytes'] for r in ranks]
        peak_ratio = [r['peak'] / ref['peak'] for r in ranks]
        counts_ok = all(
            all(r['counts'][k] == v for k, v in r['want'].items())
            for r in ranks)
        run_ok = (rel <= TOL_SHARD_GRAD and rel_trunk <= TOL_SHARD_GRAD
                  and share > 0 and counts_ok
                  and all(r['agree'] for r in ranks)
                  and all(r['losses'] == ranks[0]['losses'] for r in ranks)
                  and (name not in ('fsdp', 'lwd')
                       or max(bytes_ratio) <= SH_FSDP_BYTES))
        came = ranks[0].get('came')
        if came is not None:
            run_ok = run_ok and (
                came['params_rel'] <= TOL_SHARD_CAME
                and max(came['state_rel'].values()) <= TOL_SHARD_CAME
                and came['preview_rel'] <= TOL_SHARD_CAME
                and came['preview_shape'] == [SH_HOOK['per_device_batch'],
                                              4, 32, 32]
                and not came['others_wrote'])
            say(f'[shard came] (g) cli/train --came under tensor, '
                f'{SH_STEPS} steps: parameters vs one process relative '
                f'L2 {came["params_rel"]:.3e}, the checkpoint\'s CAME '
                f'state {came["state_rel"]} <= {TOL_SHARD_CAME}; the '
                f'InlineEvalHook at step {SH_STEPS} ({SH_HOOK}): preview '
                f'{came["preview_shape"]} vs a one-process hook on the '
                f'checkpoint\'s EMA {came["preview_rel"]:.3e}, other '
                f'ranks\' previews {came["others_wrote"]}, its launches '
                f'{came["hook_counts"]} (counted apart) [{card}]')
        ok = ok and run_ok
        ms = statistics.median(ranks[0]['ms'][1:] or ranks[0]['ms'])
        ms1 = statistics.median(ref['ms'][1:] or ref['ms'])
        report[name] = dict(grad_rel_l2=rel, grad_rel_l2_trunk=rel_trunk,
                            trunk_share=share, ms=ms, ms_one=ms1,
                            losses=ranks[0]['losses'],
                            losses_one=ref['losses'],
                            build_s=ranks[0]['build_s'],
                            train_s=ranks[0]['train_s'],
                            bytes_ratio=bytes_ratio, peak_ratio=peak_ratio,
                            peak_gb=[r['peak'] / 1e9 for r in ranks],
                            launches_rank=ranks[0]['counts'], came=came)
        say(f'[shard {name}] {SH_RUNS[name][0]} {SH_RUNS[name][1]} on '
            f'{SH_WORLD} processes ({paths["backend"]}), global batch '
            f'{ranks[0]["batch"]}: the first reduced gradient vs one process '
            f'relative L2 {rel:.3e}, the trunk\'s blocks {rel_trunk:.3e} '
            f'(their share of its norm {share:.3e} > 0) <= '
            f'{TOL_SHARD_GRAD}; ranks agree on '
            f'the gathered parameters {[r["agree"] for r in ranks]} and '
            f'the losses {ranks[0]["losses"]} (one process '
            f'{ref["losses"]}); build {ranks[0]["build_s"]:.1f} s, train '
            f'{ranks[0]["train_s"]:.1f} s; launches a rank '
            f'{[r["counts"] for r in ranks]} == {ranks[0]["want"]}: '
            f'{counts_ok}; parameter + state bytes a rank / one process '
            f'{[f"{x:.3f}" for x in bytes_ratio]}, peak memory '
            f'{[f"{r["peak"] / 1e9:.2f}" for r in ranks]} GB vs '
            f'{ref["peak"] / 1e9:.2f} GB; ms a step {ms:.1f} (one process '
            f'{ms1:.1f}): {"ok" if run_ok else "FAIL"} [{card}]')
    with open(os.path.join(out_dir, 'shard_resume.json')) as f:
        resume = json.load(f)
    ms = statistics.median(resume['ms'][1:])
    report['fsdp_bf16'] = dict(ms=ms, images_per_s=SH_BATCH / ms * 1e3,
                               peak_gb=resume['peak'] / 1e9)
    rate_ok = all(resume['counts'][k] == v
                  for k, v in resume['want'].items())
    ok = ok and rate_ok and resume['same']
    say(f'[shard rate] (a) in bf16 (the uninterrupted run of (f)), steps '
        f'2-3: {ms:.1f} ms a step, {SH_BATCH / ms * 1e3:.2f} images/s at '
        f'depth {SH_DEPTH}, launches {resume["counts"]} == '
        f'{resume["want"]}: {rate_ok}; [shard resume] (f) fsdp depth '
        f'{SH_RESUME_DEPTH} bf16: '
        f'resumed at step 2 to {resume["step"]}, bit-identical to the '
        f'uninterrupted run: {resume["same"]}; the collectives\' paths '
        f'{paths}; the torchrun call {secs:.1f} s [{card}]')
    if not ok:
        raise AssertionError(f'shard: {report}, resume {resume}')
    counts = {f'shard_{k}_rank0': v['launches_rank']
              for k, v in report.items() if 'launches_rank' in v}
    report.update(paths=paths, torchrun_s=secs)
    return counts, report


def _run_child(argv, env):
    """`python3 argv...` in a child process with `env` added to this
    process's environment: its output is echoed, its result is the JSON
    object on its last line; a child that fails raises."""
    proc = subprocess.run([sys.executable, *argv],
                          env=dict(os.environ, **env),
                          stdout=subprocess.PIPE, text=True, timeout=1200)
    lines = proc.stdout.splitlines()
    for line in lines[:-1]:
        say(line)
    if proc.returncode != 0 or not lines:
        raise AssertionError(f'{argv}: the child process exited '
                             f'{proc.returncode}; its last line: {lines[-1:]}')
    return json.loads(lines[-1])


def _run_child_phase(names, out_dir):
    """CHILD_PHASES[name](card, out_dir) for each of `names`, in order, in
    one child process of this script with DETERMINISTIC_ENV (_run_child):
    their results by name."""
    return _run_child([os.path.abspath(__file__), '--child', ','.join(names),
                       out_dir], DETERMINISTIC_ENV)


def child_main(names, out_dir):
    """The child process of _run_child_phase: the phases of CHILD_PHASES
    named in `names` (comma-separated), their results by name printed as
    the last line."""
    import torch
    if os.environ.get('CUBLAS_WORKSPACE_CONFIG') != \
            DETERMINISTIC_ENV['CUBLAS_WORKSPACE_CONFIG']:
        raise SystemExit('chip_smoke --child: needs DETERMINISTIC_ENV')
    card = phase_device()
    out = {}
    for name in names.split(','):
        out[name] = CHILD_PHASES[name](card, out_dir)
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main():
    t_start = time.perf_counter()
    card = phase_device()
    import torch
    from fitv2_tpu_torch.vae import AutoencoderKL
    with _clock('phases 2-3 (build, kernels)'):
        _, ptxas = phase_build()
        results = phase_kernels()
    results['fused_attention']['ptxas'] = ptxas[
        'K5 fused_attention_mma_kernel (bf16)']
    results['int8_gemm_swiglu_quant']['ptxas'] = ptxas[
        'K7 int8_gemm_swiglu_kernel']
    with _clock('phase 4 (parity)'):
        model_cpu = _xl_model_fp32()
        model_gpu, _ = phase_parity(model_cpu)
    torch.manual_seed(SEED + 2)
    vae = AutoencoderKL().to(device='cuda', dtype=torch.bfloat16).eval()
    with tempfile.TemporaryDirectory() as out_dir:
        # model_gpu is bf16 from here on
        with _clock('phases 5-8 (main, int8, serving-max, fused)'):
            counts = phase_main(model_gpu, vae, card, out_dir)
            model_int8, int8_counts, _ = phase_int8(model_gpu, vae, card)
            serving_counts = phase_serving_max(model_int8, vae, card)
            del model_int8
            fused_counts = phase_fused(model_gpu, vae, card)
        with _clock('phase 9 (hr)'):
            hr_cases, hr_counts = phase_hr(model_cpu, model_gpu, vae, card,
                                           out_dir)
        with _clock('phase 10 (eval)'):
            phase_eval(card, out_dir)
        del model_gpu, vae
        torch.cuda.empty_cache()
        with _clock('phase 11 (train)'):
            train_cases = phase_train_kernels()
            phase_train_parity()
            train_counts, resumed_counts, adamw = phase_train(card, out_dir)
        # phase 12: FiTv1-XL/2 (configs/fit_xl.yaml)
        with _clock('phase 12 (fitv1)'):
            v1_k2_cases, v1_k2_grad_cases = phase_fitv1_kernels(
                results['attention']['cases'])
            v1_model = _v1_model_fp32()
            phase_fitv1_parity(v1_model)
            v1_model = v1_model.to('cuda', torch.bfloat16)
            torch.manual_seed(SEED + 2)
            vae = AutoencoderKL().to(device='cuda', dtype=torch.bfloat16
                                     ).eval()
            v1_counts, _ = phase_fitv1_sampling(v1_model, vae, card, out_dir)
            del v1_model, vae
            torch.cuda.empty_cache()
            v1_train = adamw['fitv1_train']  # 11 (c)'s child ran it
        v1_train_counts = v1_train['counts']
        v1_resumed_counts = v1_train['counts_resumed']
        # phase 13: the LwD family, sampled through cli/sample_lwd with
        # phase 5's random VAE decoder written where --vae reads it
        with _clock('phase 13 (lwd)'):
            vae_path = os.path.join(out_dir, 'vae.pt')
            torch.manual_seed(SEED + 2)
            torch.save(AutoencoderKL().state_dict(), vae_path)
            lwd_cases, lwd_counts = phase_lwd(card, out_dir, vae_path)
        # phase 14: LwD training (cli/train_lwd on FiTLwD-XL, the recipes)
        with _clock('phase 14 (lwd train)'):
            lwd_train_cases, lwd_train_counts, _ = phase_lwd_train(
                card, out_dir)
        # phase 15: raw images -> latent shards -> HR-XL training under
        # 'dots' with the inline eval; CAME; the REPA teachers
        torch.cuda.empty_cache()
        with _clock('phase 15 (a) remat policies'):
            sac_counts = phase_sac()
        with _clock('phase 15 (b) prepare_latents'):
            hr_shards = phase_prepare(card, out_dir)
        with _clock('phase 15 (c) HR-XL training + inline eval'):
            hr_train_counts, _ = phase_train_hr(
                card, out_dir, hr_shards,
                os.path.join(out_dir, 'hr_512x512.npz'),
                os.path.join(out_dir, 'pt_inception.pt'))
        with _clock('phase 15 (d) CAME'):
            came_counts, _ = phase_came(card, out_dir, adamw)
        with _clock('phase 15 (e) teachers'):
            phase_teachers(card)
        # phase 16: int8 LwD serving, per-bucket int8, GAN-guided LwD
        # training on CIFAR pixels
        torch.cuda.empty_cache()
        with _clock('phase 16 (int8 LwD, int8 buckets, GAN)'):
            with _clock('phase 16 (a) int8 LwD-XL'):
                int8_lwd_counts, k6_lwd, k7_lwd, _ = phase_int8_lwd(card)
            with _clock('phase 16 (b) int8 buckets'):
                phase_int8_buckets(card)
            with _clock('phase 16 (c) GAN'):
                gan_cases = phase_gan_kernels()
                phase_gan_parity()
                gan_counts, _, _ = phase_gan(card, out_dir)
        # phase 17: the analysis captures on phase 4's weights, data
        # parallel training and sampling under torchrun
        torch.cuda.empty_cache()
        with _clock('phase 17 (captures, data parallel)'):
            with _clock('phase 17 (a)-(c) captures'):
                capture_counts, _ = phase_capture(model_cpu, card)
                rel_pe_counts, _ = phase_rel_pe_v(card)
                traj_counts = phase_trajectory(model_cpu, card)
            del model_cpu
            with _clock('phase 17 (d) data-parallel training'):
                dp_train_counts, _ = phase_dp_train(card, out_dir)
            with _clock('phase 17 (e) data-parallel sampling'):
                phase_dp_sample(card, out_dir)
        # phase 18: model sharding under torchrun (fsdp, tensor, sequence,
        # stage, the LwDTrainer under fsdp, the rate, the resume)
        torch.cuda.empty_cache()
        with _clock('phase 18 (model sharding)'):
            shard_cases = phase_shard_kernels()
            shard_counts, shard_report = phase_shard(card, out_dir)
    for name, cases in lwd_cases.items():
        results[name]['cases'] += cases
    for name, cases in hr_cases.items():
        results[name]['cases'] += [dict(c, path='hr') for c in cases]
    # each Function's forward + backward on the training shapes: the
    # training path's case (bf16, N_VALID of N valid where it has a mask)
    for name, cases in train_cases.items():
        main_case = next(c for c in cases if c['dtype'] == 'bf16'
                         and c.get('mask', True)
                         and c.get('variant', 'bounded') == 'bounded')
        results[name].update(
            train_ms=main_case['us'] / 1e3,
            train_plain_ms=main_case['plain_us'] / 1e3,
            backward_ms=main_case['bwd_us'] / 1e3,
            backward_plain_ms=main_case['plain_bwd_us'] / 1e3,
            grad_max_abs_err=max(c['max_abs_err'] for c in cases),
            train_fwd_max_abs_err=max(c['fwd_max_abs_err'] for c in cases),
            train_cases=cases)
    # phase 14's Functions at the multi-scale tiers and BFM-XL's K3, phase
    # 16's at the GAN student's shapes (Dh 64)
    for name, cases in [*lwd_train_cases.items(), *gan_cases.items()]:
        results[name]['train_cases'] += cases
        results[name]['grad_max_abs_err'] = max(
            results[name]['grad_max_abs_err'],
            *(c['max_abs_err'] for c in cases))
        results[name]['train_fwd_max_abs_err'] = max(
            results[name]['train_fwd_max_abs_err'],
            *(c['fwd_max_abs_err'] for c in cases))
    # phase 18's Functions at the per-rank shapes of the sharded runs
    for name, cases in shard_cases.items():
        results[name]['train_cases'] += cases
        results[name]['grad_max_abs_err'] = max(
            results[name]['grad_max_abs_err'],
            *(c['max_abs_err'] for c in cases))
        results[name]['train_fwd_max_abs_err'] = max(
            results[name]['train_fwd_max_abs_err'],
            *(c['fwd_max_abs_err'] for c in cases))
    # K6 and K7 at the int8 LwD path's shapes (phase 16 (a))
    results['int8_gemm_bias']['sites'] += k6_lwd
    results['int8_gemm_swiglu_quant']['sites'] += k7_lwd
    for name in ('int8_gemm_bias', 'int8_gemm_swiglu_quant'):
        results[name]['max_abs_err'] = max(
            st['max_abs_err'] for st in results[name]['sites'])
    for name in ('int8_gemm_bias', 'int8_gemm_swiglu_quant'):  # no backward
        results[name].update(train_ms=None, train_plain_ms=None,
                             backward_ms=None, backward_plain_ms=None,
                             grad_max_abs_err=None,
                             train_fwd_max_abs_err=None)
    # K2 in FiTv1's RoPE-only mode (phase 12), bf16 the top-level numbers:
    # the kernel at the sampler's shape, its Function at the training shape
    rope_only, rope_only_train = v1_k2_cases[0], v1_k2_grad_cases[0]
    results['qk_rope']['cases'] += v1_k2_cases
    results['qk_rope']['train_cases'] += v1_k2_grad_cases
    results['qk_rope'].update(
        rope_only_ms=rope_only['us'] / 1e3,
        rope_only_cold_ms=rope_only['cold_us'] / 1e3,
        rope_only_plain_ms=rope_only['plain_us'] / 1e3,
        rope_only_bound_ms=rope_only['bound_us'] / 1e3,
        rope_only_max_abs_err=max(c['max_abs_err'] for c in v1_k2_cases),
        rope_only_train_ms=rope_only_train['us'] / 1e3,
        rope_only_train_plain_ms=rope_only_train['plain_us'] / 1e3,
        rope_only_backward_ms=rope_only_train['bwd_us'] / 1e3,
        rope_only_backward_plain_ms=rope_only_train['plain_bwd_us'] / 1e3,
        rope_only_train_fwd_max_abs_err=max(
            c['fwd_max_abs_err'] for c in v1_k2_grad_cases),
        rope_only_grad_max_abs_err=max(
            c['max_abs_err'] for c in v1_k2_grad_cases))
    by_path = {'main': counts, 'int8': int8_counts,
               'serving_max': serving_counts, 'fused': fused_counts,
               **hr_counts, 'train': train_counts,
               'train_resumed': resumed_counts, **v1_counts,
               'fitv1_train': v1_train_counts,
               'fitv1_train_resumed': v1_resumed_counts, **lwd_counts,
               **lwd_train_counts,
               **{f'sac_{p}': c for p, c in sac_counts.items()},
               **hr_train_counts, 'came_train': came_counts,
               'int8_lwd': int8_lwd_counts, 'gan_train': gan_counts,
               'capture': capture_counts, 'rel_pe_v': rel_pe_counts,
               'trajectory': traj_counts, 'dp_train_rank0': dp_train_counts,
               **shard_counts}
    # the attention wrapper launches K4 (bounded) or K3 (online softmax):
    # K3's share on each path that counted K4 apart
    results['attention']['k3_launches_by_path'] = {
        path: c['flash_masked_attention'] - c['flash_masked_attention_bounded']
        for path, c in by_path.items()
        if 'flash_masked_attention_bounded' in c}
    src = 'fitv2_tpu_torch/kernels/csrc/'
    meta = [
        ('adaln', 'fused_adaln_norm', counts, src + 'adaln.cu',
         'fitv2_tpu/ops/fused_adaln.py:28'),
        ('qk_rope', 'fused_qk_rope', counts, src + 'qk_rope.cu',
         'fitv2_tpu/ops/fused_qk_rope.py:29'),
        ('attention', 'flash_masked_attention', counts, src + 'attention.cu',
         'fitv2_tpu/ops/attention_core.py:51 (bounded, K4) and '
         'fitv2_tpu/ops/flash_attention.py:44 (online, K3)'),
        ('fused_attention', 'fused_qkln_rope_attention', fused_counts,
         src + 'fused_attention.cu', 'fitv2_tpu/ops/fused_attention.py:52'),
        ('int8_gemm_bias', 'int8_gemm_bias', int8_counts,
         src + 'int8_gemm_wgmma.cu', 'fitv2_tpu/ops/int8_gemm.py:72'),
        ('int8_gemm_swiglu_quant', 'int8_gemm_swiglu_quant', int8_counts,
         src + 'int8_gemm.cu', 'fitv2_tpu/ops/int8_gemm.py:125'),
    ]
    # `launches`: the kernel's own path (as before); `launches_by_path`:
    # every counted path's run
    kernels = [dict(name=name, route='cuda', source=source, replaces=rep,
                    launches=path_counts[wrapper],
                    launches_by_path={p: c[wrapper]
                                      for p, c in by_path.items()},
                    **results[name])
               for name, wrapper, path_counts, source, rep in meta]
    say(f'[time] the smoke: {time.perf_counter() - t_start:.1f} s')
    say(card)  # nvidia-smi's name, power.limit line
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    if len(sys.argv) == 4 and sys.argv[1] == '--child':
        sys.exit(child_main(sys.argv[2], sys.argv[3]))
    if len(sys.argv) == 4 and sys.argv[1] == '--dp-child':
        sys.exit(dp_child_main(sys.argv[2], sys.argv[3]))
    if len(sys.argv) == 4 and sys.argv[1] == '--shard-child':
        sys.exit(shard_child_main(sys.argv[3]))
    sys.exit(main())
