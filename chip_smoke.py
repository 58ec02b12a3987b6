#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py            # from the repo root, on the card
    python3 chip_smoke.py --flash-host       # flash's host cost per call
    python3 chip_smoke.py --flash-serve      # flash at the serve shapes
    python3 chip_smoke.py --flash-bwd        # its backward, train shape
    python3 chip_smoke.py --flash-ablation   # what bounds the flash kernel
    python3 chip_smoke.py --ssd-ablation     # what bounds the SSD kernel
    python3 chip_smoke.py --lstm-ablation    # what bounds the LSTM kernels
    python3 chip_smoke.py --decode           # the [decode] phase alone
    python3 chip_smoke.py --dense            # the [dense] phase alone
    python3 chip_smoke.py --moe              # the [moe] phase alone
    python3 chip_smoke.py --audio            # the [audio] phase alone
    python3 chip_smoke.py --train-zoo        # the [train-zoo] phase alone
    python3 chip_smoke.py --train-ssm        # the [train-ssm] phase alone
    python3 chip_smoke.py --ssd-bwd          # the SSD backward, train shapes
    python3 chip_smoke.py --ssd-bwd-ablation # what bounds the SSD backward

It builds the hand-written CUDA kernels from the sources in the checkout
(one ``nvcc`` per library, all started together), shows from the flash
(forward and backward) and SSD libraries' SASS that their bf16 kernels
issue wgmma (HGMMA) and TMA loads (UTMALDG), and that the backward's
CUDA-core kernels exist in fp32 alone, and holds each kernel against its plain PyTorch
version on the card: the LSTM layer's forward (T steps in one launch,
from a zero or a given carry, with the local-SGD worker dim; a step is
the same launch at T = 1) and its backward (the same T steps in reverse
in one launch; a T-step launch bit for bit T chained launches at
T = 1), the EVL loss with its dL/du in one launch (a row of W = 4 bit
for bit the row alone), flash attention
(the JAX kernel tests' sweep and masks, and head dim 80; fp32 on the
CUDA-core kernel, bf16 on the tensor-core one) and the Mamba2 SSD chunk
scan (the JAX sweep, the reduced config's and the serving path's
shapes, at fast, slow and clipped decay; fp32 on the CUDA-core kernel,
bf16 on the tensor-core one; at a clip mid-chunk, kernel and plain
version each against float64). It checks the forecaster's bitwise
step == replay == generate contract (T = 1 launches against T = 20
ones) and that a training step puts real gradients on every LSTM
weight. Then it drives the port's main
paths: serving the paper LSTM (full width, random weights from seed 0)
through ``ServingEngine`` and the ``repro_torch.launch.serve`` CLI;
training it (serial, and asynchronous local SGD with 4 workers at tau 0
and 1, EVL on) through ``repro_torch.training`` and the
``repro_torch.launch.train`` CLI; the checkpoint bridge (``train
--save`` then ``serve --checkpoint``, a reload whose predictions are
bitwise the saved model's, and Mamba2-370M at full width through the
registry's ``save_bytes``/``load_bytes`` with its dtypes and a flush
bitwise kept); the paper's event-driven simulator (Table II's
homogeneous runs at n = 1, 2, 5, 10, K = 2000, EVL on: speedup rising
with n, 5 paper-kernel launches a local step); the online path
(``repro_torch.launch.online``: a trainer thread publishing every
round's average into the registry while the engine serves 400 req/s,
the two threads' launches adding up exactly, every request answered
across at least 3 versions, the final version the trainer's weights and
a bitwise reload); and serving the zoo's
Qwen1.5-4B at
full width and depth (bf16) through ``ServingEngine`` (a burst of short
prompts, then one of 2048-token prompts) and the serve CLI, with the
same model cut to 2 layers in fp32 held against the port on the CPU;
and the same for the zoo's Mamba2-370M, whose every layer runs the SSD
kernel; and for the zoo's hybrid Zamba2-2.7B (54 Mamba2 layers through
the SSD kernel, the shared attention block after every 6th through the
flash kernel), with a third burst of one 133,120-token request, whose
attention takes the long-context window of 4096 keys, and its card-vs-
CPU copy cut to one stage (6 layers); both kernels are held against
their plain versions at Zamba2's shapes, the windowed launch on query
slices. Then the zoo's decode path (``[decode]``): each of the three
at full width and half depth in bf16, 8 prompts of 2048 tokens
prefilled into the KV and SSM caches through ``build_model(cfg).prefill``
(20 flash launches for Qwen, 24 SSD for Mamba2, 30 SSD + 5 flash for
Zamba2) and 320 teacher-forced one-token ``decode_step``s with
``flush_recent`` every 256 tokens, each step's logits held against
``lm_forward``'s at the JAX test's bound and launching no kernel; for
Zamba2 also a 133,120-token prompt into the ring of its 4096-key window
and 32 steps; each model's fp32 copy (2 layers, Zamba2 one stage)
against the forward and the CPU; ``ssd_chunk``, the port of the TPU
kernel's single-chunk entry from a given state, against its plain
version, and ``ssd_chunked(initial_state=...)`` through the kernel at
the prefills' shapes. Then the rest of the dense zoo and the VLM
(``[dense]``): Nemotron-4-15B, Granite-20B, Qwen2.5-32B and
Chameleon-34B, one at a time on the card, each at full width in bf16
cut to 8 layers, served through ``ServingEngine`` (bursts A and B, one flash
launch per layer a flush, at GQA 48/8, MQA 48/1, GQA 40/8 and 64/8),
8 prompts of 2048 tokens prefilled and 32 steps decoded, each step
held against the forward and against an fp32 forward made one layer at
a time; each one's 1-layer fp32 copy against the CPU, forward and
decode; the flash kernel at each one's shapes; Granite also through
the serve CLI; the memory allocated on the card back to where it was
after each model. Then the MoE family (``[moe]``): Mixtral-8x7B and
Qwen3-MoE-235B-A22B, one at a time, at full width in bf16 but cut in
depth (12 of 32 and 7 of 94 layers), served
through ``ServingEngine`` (one flash launch per layer a flush, at GQA
32/8 with Mixtral's window and 64/4), 8 prompts of 2048 tokens
prefilled and 32 steps decoded at the published capacity factor, the
decode held against the forward and an fp32 forward at the no-drop
factor with its router flips counted, Mixtral's 16,384-token prompt
into its 4096-slot ring (the flash kernel's windowed launch at GQA,
timed beside SDPA with a mask), each one's 2-layer fp32 copy against
the CPU (1 layer: logits and the load-balance loss), Mixtral's reduced config
through the serve CLI. Then the audio family (``[audio]``):
Whisper-medium at full width and depth in bf16 on the stub frames,
served through ``ServingEngine`` (bursts of 32 and 448 tokens, each
flush 24 encoder launches of the flash kernel without a mask over 1500
frames, 24 causal decoder ones and 24 cross-attention ones without a
mask), 8 prompts of 64 tokens prefilled with their frames and 288 steps
decoded, each step 24 flash launches (cross-attention at one query over
the cached 1500 frames) and held against the forward and an fp32
forward, its 2 + 2-layer fp32 copy against the CPU, its reduced config
through the serve CLI, the flash kernel timed at each of those shapes
and masks beside SDPA with the same mask. Then zoo training
(``[train-zoo]``): Qwen1.5-4B at full width in bf16 cut to 16 layers,
remat on, step 0's loss and gradient (``launch.specs.loss_and_grad``)
bitwise the same in two runs, then Adam steps of ``make_train_step``
on 8 x 512 tokens, every flash launch through the kernels (2 forward
launches a layer, the forward and its recomputation, and 1 launch of
the hand-written backward), each loss finite, ms a step, tokens/s,
peak memory and a profiled step's busy share; its 2-layer fp32 copy
against the CPU (loss, every gradient leaf, one Adam step); the flash
backward against its plain version over GQA, MQA, windowed and
unmasked cases and edges inside the bf16 kernels' tiles, every head
dim, fp32 and bf16 (two launches bitwise, the rows of B = 1 launches
bitwise the batch's), and timed beside SDPA's backward at the train
path's shape, 4 x 2048 causal and Whisper's 8 x 1500 without a mask,
with its Delta pass alone. Then the SSM families' training
(``[train-ssm]``): Mamba2-370M at full width and depth (48 layers) and
Zamba2-2.7B at full width cut to 12 layers (two stages), bf16, remat on,
8 x 512 tokens: step 0's loss and gradient bitwise the same in two runs,
Adam steps (4 and a profiled one for Mamba2, 2 for Zamba2), every SSD
launch through the kernels (2 forward launches a Mamba2 layer and 1 of
the hand-written backward; Zamba2's shared block 2 flash forward and 1
backward a stage), each loss finite, ms a step, tokens/s, peak memory
and the profiled step's busy share and the SSD backward's share of it;
each one's fp32 copy (Mamba2 2 layers, Zamba2 one stage) against the
CPU (loss and every gradient leaf); ``train --arch mamba2-370m --steps
2`` through the CLI; the SSD backward against its plain version over
ragged shapes, every bf16 chunk, Mamba2's and Zamba2's instantiations
and the path's, fp32 and bf16, with and without a final-state
cotangent (two launches bitwise, the rows of B = 1 launches bitwise the
batch's, a mid-chunk clip against float64), and timed at the path's
shapes beside its plain version and its bound.
Every kernel launch counter is set to 0 just before each path and read
just after, and no plain version may run on a card tensor. It times
each kernel beside its plain version, a PyTorch yardstick where one
exists, and its bound, reads the device's busy share on each path with
``torch.profiler``, and prints each phase's seconds. Any failed phase
exits non-zero. The last two lines are a JSON object per kernel and
``{"ok": true, "device": {...}}``. With ``--flash-host``,
``--flash-serve``, ``--flash-bwd``, ``--flash-ablation``,
``--ssd-ablation``, ``--lstm-ablation``, ``--evl-ablation``,
``--ssd-bwd`` or ``--ssd-bwd-ablation`` it runs only that probe
(``flash_host``, ``flash_serve``, ``flash_bwd_probe``, ``flash_ablation``,
``ssd_ablation``, ``lstm_ablation``, ``evl_ablation``, ``ssd_bwd_probe``,
``ssd_bwd_ablation``) and prints no result; with ``--decode``,
``--dense``, ``--moe``, ``--audio``,
``--train-zoo`` or ``--train-ssm``, the build and the ``[decode]``,
``[dense]``, ``[moe]``, ``[audio]``, ``[train-zoo]`` or ``[train-ssm]``
phase alone (``[train-ssm]`` with the SSD library's SASS check), and no
result.

Without a CUDA device, or without the package beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet), at a 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12          # float32 outside the tensor cores
RTOL, ATOL = 1e-5, 1e-6         # LSTM kernels vs plain, as tests/test_kernels.py
EVL_RTOL, EVL_ATOL = 1e-5, 1e-7  # EVL kernel vs plain, as tests/test_kernels.py
# torch.lstm (cuDNN), the LSTM layer's yardstick, against the plain
# version: cuDNN computes the gates in its own order and with its own
# activation routines, off by up to 5.7e-6 at (1, 8, 1, 5, 64) (an H100
# 80GB HBM3, 700 W), past the kernels' 1e-5 / 1e-6; it is held at the
# whole-model bound below (FC_RTOL, FC_ATOL) instead
FC_RTOL, FC_ATOL = 1e-4, 1e-5   # card vs CPU over the whole model
# Training on the card vs the port on the CPU, from the same weights and
# batches: fp32 on both sides, the kernels' sums in another order than
# oneDNN's, so the two drift apart a little more with every SGD step.
# The bound is the whole-model bound above, applied to each loss of the
# first ~20 iterations and, per leaf, to one step's gradient relative to
# the leaf's largest entry.
TRAIN_RTOL = 1e-4
# The weight gradients dwx = x^T dgates, dwh = h_prev^T dgates and
# db = sum dgates sum B x T products whose signs differ (one product over
# the window, where autograd of the plain layer sums one per step), and
# the kernel's dgates differ from autograd's in the last bits. Where the
# sum cancels, its error is relative to the sum of the terms' magnitudes,
# not to the result, so these three are held to |kernel - plain| <=
# ATOL + RTOL * (|x|^T |dgates|) (and likewise for h_prev and the bias)
# instead of RTOL * |result|.
# (W, B, I, H) of a single step (the layer kernel at T = 1) on the serving
# path: one model (W = 1); the decode lane (B = 8), the slot state (64),
# the request batch (max_batch = 32); I = 5 for layer 1 and 64 for layer 2
PATH_SHAPES = [(1, 8, 5, 64), (1, 8, 64, 64), (1, 32, 5, 64),
               (1, 32, 64, 64), (1, 64, 64, 64)]
# (W, B, I, H) the training path gives the layer and its backward: the
# serial baseline (W = 1) and 4 local-SGD workers, batch 32, over a
# window of WINDOW steps (T = 1: the cell under autograd)
TRAIN_SHAPES = [(W, 32, I, 64) for W in (1, 4) for I in (5, 64)]
WINDOW = 20
# (W, B, T, I, H) of the layer kernel: a predict flush (B 32, T 20), a
# replay at the decode width (B 8), a training step (W 1 and 4, T 20),
# each at layer 1 (I 5) and layer 2 (I 64)
LAYER_SHAPES = ([(1, B, 20, I, 64) for B in (32, 8) for I in (5, 64)]
                + [(W, 32, WINDOW, I, 64) for W in (1, 4) for I in (5, 64)])
# the odd (B, I, H) of the JAX package's kernel sweep
ODD_SHAPES = [(1, 5, 64), (13, 5, 64), (32, 7, 32), (8, 16, 128),
              (3, 9, 24), (7, 3, 40), (1, 1, 8), (9, 11, 48), (5, 5, 16)]
# (W, N) the training path gives the EVL loss: one row per worker, N the
# batch; and a row longer than a block
EVL_SHAPES = [(1, 32), (4, 32)]
EVL_EPS = 1e-7
EVL_EDGES = [0.0, EVL_EPS, float(np.float32(1.0 - EVL_EPS)), 1.0]
# sha256 of (h', c') from the LSTM cell kernel of the serving slice (the
# port's first version, before the worker dim; commit 18fdff0) at the
# serving shapes, on ``bits_inputs(B, I, H)``: a W = 1 launch must give
# them bit for bit. Taken by that kernel on an H100 80GB HBM3 (700 W).
SERVING_SLICE_DIGESTS = {
    "8x5x64": "b33af6c0d958079e3f21c3096ffaf7a42c3d8ef56aec6b01f755d7129d878016",
    "8x64x64": "c5d71f1ec59528f4d5823f330bbbbbb440d5f7760aa45dcf464328ce6a9865fb",
    "32x5x64": "b46ead90d913392c4050d5d191ed385f8726984080ccaa3e211127c8d9dd08ec",
    "32x64x64": "72efe52a6d4959c3e5d4edd78e9a6a8958ec0f352b550e5a5eb235967ced05de",
    "64x64x64": "ecd8f29e5a126d3901f477e395ac7befb5484ff75b1d4ccf975ec68983d61740"}
# flash attention: the JAX kernel tests' sweep (B, S, Hq, Hkv, D) (MHA,
# GQA with a ragged S, MQA, S below a block; and head dim 80, which the
# bf16 kernel pads to two 64-column slabs), its masks, and its fp32
# tolerances, rtol 2e-4 / atol 2e-5. In bf16 the kernel and the plain
# version both work in fp32 on the same bf16 inputs (the kernel's P.V on
# two bf16 halves of P, good to about 2^-17) and round the output once,
# so they differ by at most one bf16 step of the output, 2^-7 of its
# size: rtol 1e-2, with atol 1e-4 for outputs near 0 (a row of the
# 2048-token path has outputs of size about 0.04). The JAX tests' 0.08
# is kept for scaled_dot_product_attention only, which rounds P to bf16.
FLASH_SHAPES = [(1, 128, 4, 4, 64), (2, 200, 4, 2, 64), (1, 300, 8, 1, 32),
                (2, 64, 6, 2, 128), (2, 77, 4, 4, 80)]
FLASH_MASKS = [dict(causal=True), dict(causal=False),
               dict(causal=True, window=37), dict(causal=True, q_offset=29)]
# Whisper-medium's launches without a mask (B, Sq, Skv, Hq, Hkv, D):
# cross-attention with fewer queries than keys (1, 32, 77 and 448 over
# 300 and 1500: every query tile visits every key tile, the last one
# ragged at 1500 = 11 x 128 + 92, and the query tile is larger than Sq
# below 128) and the encoder's 1500 x 1500
FLASH_CROSS = ([(2, sq, skv, 16, 16, 64) for sq in (1, 32, 77, 448)
                for skv in (300, 1500)] + [(2, 1500, 1500, 16, 16, 64)])
FLASH_RTOL, FLASH_ATOL = 2e-4, 2e-5
FLASH_BF16_RTOL, FLASH_BF16_ATOL = 1e-2, 1e-4
LIBRARY_BF16_TOL = 0.08
BF16_OPS_PER_S = 989e12         # tensor cores, dense bf16
# device-kernel names: the bf16 flash kernel (wgmma, TMA), which the zoo's
# bf16 path must run, and the fp32 CUDA-core one, which it must not
FLASH_SYMBOL, FLASH_FP32_SYMBOL = "flash_fwd_wgmma", "flash_kernel"
# the zoo's serving path: Qwen1.5-4B at full width and depth (bf16,
# random weights from seed 0) behind ServingEngine, two bursts of
# (requests, prompt length, max_batch)
ZOO_ARCH = "qwen1.5-4b"
ZOO_BURSTS = [(64, 32, 8), (8, 2048, 4)]
# the card against the CPU port on the same weights: Qwen1.5-4B at full
# width, 2 layers, fp32 (TF32 off). Both sides sum 2560- and 6912-long
# products in their own order; the logits (|logit| up to ~6) are held at
# the whole-model bound of 1e-4, and the greedy tokens must be equal.
ZOO_CPU_RTOL, ZOO_CPU_ATOL = 1e-4, 1e-4
# the SSD chunk scan: the JAX kernel tests' sweep (B, L, H, P, N, chunk),
# the reduced Mamba2's (16 heads of 32, state 32, chunk 16: a ragged L
# and the serving window), and Mamba2-370M's serving path (32 heads of
# 64, state 128, chunk 128: 8 x 32 and 4 x 2048 tokens)
SSD_SWEEP = [(1, 64, 2, 16, 8, 16), (2, 96, 3, 16, 8, 32),
             (1, 100, 1, 32, 16, 32), (2, 128, 4, 64, 32, 128)]
SSD_REDUCED = [(1, 20, 16, 32, 32, 16), (8, 32, 16, 32, 32, 16)]
SSD_PATH = [(8, 32, 32, 64, 128, 128), (4, 2048, 32, 64, 128, 128)]
# three draws of the decay a: the JAX tests' -U(0.01, 0.5), under which
# the state carried from chunk to chunk decays to nothing; a slow
# -U(1e-4, 1e-2), where it dominates y; and slow with the last step of
# every chunk at dt's clip of 100 (a = -100), where exp above the
# diagonal overflows to inf and only a select keeps NaN out.
SSD_DRAWS = ("sweep", "slow", "clip")
# a fourth, ``clip-mid``: a clipped step at a random row of the chunk.
# The rows after it share |cum| ~ 100, and cum_i - cum_j keeps only the
# digits those share, so the fp32 rounding of cum alone moves y by some
# 1e-5, in the kernel and in the plain version alike: their difference
# is no measure of either. Both are read against a float64 run of the
# plain version on the same inputs instead, and the kernel's error must
# stay within SSD_F64_FACTOR times the plain fp32 version's own (plus
# SSD_F64_FLOOR, so that a case the plain version gets exactly cannot
# fail on one rounding).
SSD_F64_FACTOR, SSD_F64_FLOOR = 3.0, 1e-7
# fp32: the JAX kernel tests' bound; bf16 y: one bf16 step (both sides
# work in fp32 on the same bf16 inputs and round y once); the state is
# fp32 in both cases
SSD_RTOL, SSD_ATOL = 1e-4, 1e-5
SSD_BF16_RTOL, SSD_BF16_ATOL = 1e-2, 1e-4
# device-kernel names: the bf16 SSD kernel (wgmma, TMA), which Mamba2's
# bf16 path must run, and the fp32 CUDA-core one, which it must not
SSD_SYMBOL, SSD_FP32_SYMBOL = "ssd_chunk_wgmma", "ssd_kernel"
# the zoo's SSM: Mamba2-370M at full width and depth (bf16, random
# weights from seed 0), through the same two bursts; its card-vs-CPU
# copy (2 layers, fp32) noises the leaves the init sets to constants
MAMBA_ARCH = "mamba2-370m"
MAMBA_NOISE = {"A_log": 0.5, "dt_bias": 0.5, "conv_b": 0.2, "D": 0.2,
               "norm_w": 0.2, "w": 0.2}
# the zoo's hybrid: Zamba2-2.7B at full width and depth (bf16, random
# weights from seed 0; 54 Mamba2 layers, 80 SSD heads of 64, state 64,
# chunk 128, and one shared attention + MLP block of 32 MHA heads of 80
# after every 6th layer), through the same two bursts and then one
# request of 133,120 tokens: 1,040 chunks of 128, and 2,048 tokens past
# the 131,072 beyond which the shared block attends within the
# long-context window (4096 keys). Its card-vs-CPU copy is one stage (6
# Mamba2 layers, then the shared block), fp32, noised as Mamba2's (the
# shared block's two norms are "w" leaves too).
ZAMBA_ARCH = "zamba2-2.7b"
LONG_CONTEXT_FROM = 131072
ZAMBA_LONG = 133120
ZAMBA_BURSTS = ZOO_BURSTS + [(1, ZAMBA_LONG, 1)]
ZAMBA_CPU_LAYERS = 6
# the kernels at Zamba2's shapes: flash (B, Sq, Skv, Hq, Hkv, D[,
# window]) causal, and the SSD scan (B, L, H, P, N, chunk); the windowed
# flash launch is held against its plain version on FLASH_SLICE query
# rows at its end and in its middle, each over the keys its window
# reaches
ZAMBA_FLASH = [(8, 32, 32, 32, 32, 80), (4, 2048, 2048, 32, 32, 80),
               (1, ZAMBA_LONG, ZAMBA_LONG, 32, 32, 80, 4096)]
ZAMBA_SSD = [(8, 32, 80, 64, 64, 128), (4, 2048, 80, 64, 64, 128),
             (1, ZAMBA_LONG, 80, 64, 64, 128)]
FLASH_SLICE = 512
# the largest [Sq, Skv] boolean window mask handed to
# scaled_dot_product_attention to time a windowed launch beside a
# library call (Mixtral's 16,384 tokens: 268 MB; Zamba2's 133,120 would
# be 17.7 GB)
SDPA_MASK_MAX = 1 << 28
# the zoo's decode path ([decode]): each zoo arch at full width (bf16,
# random weights from seed 0) and half its depth, DECODE_LAYERS (Qwen 20
# of 40, Mamba2 24 of 48, Zamba2 30 of 54: 5 stages; at full depth the
# phase ran 148 s of the smoke (PERF.md), a decode step host bound at
# ~130 eager ops an attention layer, so its time goes with the depth),
# DECODE_BATCH prompts of DECODE_PROMPT tokens (burst B's length)
# prefilled into the KV and SSM
# caches, then DECODE_STEPS teacher-forced one-token decode steps
# (Qwen's full-mode cache flushes its 256 recent slots once mid-run and
# ends with 64 in them); Zamba2 also one prompt of ZAMBA_LONG tokens into
# the ring of its long-context window and DECODE_LONG_STEPS steps. Each
# step's logits are held against lm_forward's at the same position at
# the JAX test's bound (tests/test_arch_smoke.py: max |got - want| /
# max |want| < 0.05 a step); step times are medians after
# DECODE_WARMUP steps.
DECODE_ARCHS = (ZOO_ARCH, MAMBA_ARCH, ZAMBA_ARCH)
DECODE_LAYERS = {ZOO_ARCH: 20, MAMBA_ARCH: 24, ZAMBA_ARCH: 30}
DECODE_BATCH, DECODE_PROMPT, DECODE_STEPS = 8, 2048, 320
DECODE_LONG_STEPS = 32
DECODE_WARMUP = 16
DECODE_BOUND = 0.05
# At full depth the bf16 forward itself lies several % of max |logit|
# from the forward of an fp32 copy of the same weights (the [decode]
# lines print how far), so two bf16 computations of one step differ by
# about that much: the bf16 decode is also read against that fp32
# forward, and may be no further from it than this factor times the
# bf16 forward is.
DECODE_FP32_REF_FACTOR = 1.25
# each arch's fp32 copy (TF32 off): full width, 2 layers (Zamba2 one
# stage of 6), (batch, prompt, steps, decode_buffer), so that flushes
# land in the run; held against lm_forward on the card and against the
# port on the CPU with the same weights at 1e-4 of max |want|
DECODE_FP32 = (2, 48, 24, 16)
DECODE_FP32_BOUND = 1e-4
# the leaves the init sets to a constant: Mamba2's, the QKV biases,
# LayerNorm's bias b and the QK-norm weights (LayerNorm's and RMSNorm's
# weights are "w" leaves, in MAMBA_NOISE)
DECODE_NOISE = dict(MAMBA_NOISE, bq=0.2, bk=0.2, bv=0.2, b=0.2, q_norm=0.2,
                    k_norm=0.2)
# the rest of the dense zoo and the VLM ([dense]): each at full width in
# bf16 (random weights from seed 0), cut in depth to DENSE_LAYERS, the
# smallest first, one model on the card at a time: Nemotron-4-15B (GQA
# 48/8, LayerNorm, squared ReLU), Granite-20B (MQA 48/1, LayerNorm,
# tanh-GELU), Qwen2.5-32B (GQA 40/8, QKV bias) and the VLM Chameleon-34B
# (GQA 64/8, QK norm). At full depth (32, 52, 64, 48 layers: 29.1, 37.8,
# 61.0 and 63.9 GiB of weights) they served and decoded on the card one
# at a time, Chameleon's peak 70.74 GiB (PERF.md), and the phase
# took ~260 s of the smoke's time limit; 8 layers each keep every layer
# kind, head layout and the LM head at full width for a third of that.
# Each serves bursts A and B, prefills DECODE_BATCH x DECODE_PROMPT
# tokens and decodes DENSE_DECODE_STEPS steps (the 320-step run and its
# flush at full depth stay Qwen1.5-4B's, in [decode]). The serve CLI runs
# Granite alone, at full depth, to keep the phase short. Each one's fp32
# copy against the CPU: DENSE_FP32_LAYERS layer, the LM head (up to
# 256k x 6144 for Nemotron) the CPU half's largest part.
DENSE_ARCHS = ("nemotron-4-15b", "granite-20b", "qwen2.5-32b",
               "chameleon-34b")
DENSE_LAYERS = 8
DENSE_FP32_LAYERS = 1
DENSE_DECODE_STEPS = 32
DENSE_CLI_ARCH = "granite-20b"
# the fp32 reference of a dense decode casts one layer at a time to fp32
# (a whole fp32 copy is twice the model's bytes) and runs the first this
# many of the decode's sequences through it: with all 8 (1.1 PFLOP for
# Chameleon, TF32 off on the CUDA cores) the decode part took 23-49 s a
# model, most of the phase
DENSE_FP32_ROWS = 4
# the MoE family ([moe]): Mixtral-8x7B (8 experts top-2 of d_ff 14,336,
# GQA 32/8, its own 4096-key window) then Qwen3-MoE-235B-A22B (128
# experts top-8 of d_ff 1536, GQA 64/4, QK norm), one at a time on the
# card, at full width in bf16 (random weights from seed 0, the router
# fp32) and the published capacity factor, 1.25. Neither fits one card
# (87.0 and 437.9 GiB in bf16), so each is cut in depth, never in width:
# from param_count(), a Mixtral layer is 2.70 GiB beside 0.49 GiB of
# embedding and LM head, a Qwen3-MoE layer 4.63 GiB beside 2.32 GiB. 24
# of 32 layers are 65.4 GiB, 13 of 94 62.6 GiB, near Chameleon-34B's
# 63.9 (its peak 70.74 GiB at 8 x 2048); each run's activations (burst
# B's logits, 2.5 GiB at Qwen3-MoE's vocab, or one layer's fp32 copy in
# the fp32 reference forward, 5.4 and 9.3 GiB) must fit beside them,
# under about 75 GiB in all: PERF.md records those depths served and
# decoded. The smoke runs half of each, 12 and 7 layers, to keep
# within its time limit beside [train-zoo]; the fp32 copies against the
# CPU 1 layer each (DECODE_FP32_LAYERS). Burst B's batch and the
# 2048-token prompt are not cut.
MOE_ARCHS = ("mixtral-8x7b", "qwen3-moe-235b-a22b")
MOE_LAYERS = {"mixtral-8x7b": 12, "qwen3-moe-235b-a22b": 7}
MOE_DECODE_STEPS = 32
# The decode at the published factor is held against nothing: a step's
# group is its B tokens (capacity 2 for Mixtral and 1 for Qwen3-MoE at B
# 8) where the forward's groups are 512 tokens (capacity 160 and 40), so
# a step keeps or drops other pairs than the forward does, in both
# packages (the JAX package's own decode test sets the capacity to the
# whole group). The decode is held against the forward at the no-drop
# factor n_experts / top_k instead, on the same weights, where every
# expert has a slot for every token of its group: every token then
# runs through every expert slot of its group (16 x the published work
# for Qwen3-MoE, E x g x s x D x 2 bytes of expert input, 4.5 GiB at
# 2 x 2080 tokens before the chunking of moe_apply), and so does the
# fp32 reference forward, on the CUDA cores: batch 2 keeps both short.
MOE_NODROP_BATCH = 2
# Mixtral's long request: 16,384 tokens into its 4096-slot ring, the
# flash kernel's windowed launch at GQA 32/8, then MOE_DECODE_STEPS
# steps, at the no-drop factor, held against the forward
MOE_LONG = 16384
MOE_CLI_ARCH = "mixtral-8x7b"
# the audio family ([audio]): Whisper-medium (24 encoder layers over 1500
# frames + 24 decoder layers, d_model 1024, 16 MHA heads of 64, GELU,
# LayerNorm, QKV bias; 0.81 B parameters, 1.51 GiB in bf16) at full width
# and depth, random weights from seed 0, on the stub frames. Burst A as
# the others'; burst B at 448 tokens, Whisper's published decoder
# context, in place of 2048. Every flush runs the encoder over its
# batch's 1500 frames: 3 x 24 flash launches. The decode: AUDIO_DECODE
# (batch, prompt, steps): 8 prompts of 64 tokens prefilled with 8 x
# 1500 frames, then 288 teacher-forced steps, 352 tokens in all (the
# recent buffer of 256 flushes once, at 320), each step 24 flash
# launches (cross-attention at one query over 1500 frames)
AUDIO_ARCH = "whisper-medium"
AUDIO_BURSTS = [(64, 32, 8), (8, 448, 4)]
AUDIO_DECODE = (8, 64, 288)
# burst A's cross-attention launch, whose rows are held bitwise against
# their B = 1 launches
AUDIO_CROSS = (8, 32, 1500, 16, 16, 64)
# zoo training ([train-zoo]): Qwen1.5-4B at full width (20 MHA heads of
# 128, d_ff 6912, vocab 151,936) in bf16, remat on, random weights from
# seed 0, cut in depth to TRAIN_ZOO_LAYERS: the port's Adam is eager
# tree_maps, and a step holds the bf16 params, gradients and clipped
# gradients, the fp32 copy of the gradients, old and new mu and nu and
# the fp32 updates, about 32 bytes a parameter at its peak (3.95 B at
# full depth: 120 GiB), and the update's fp32 temporaries of the largest
# leaf (the embedding and the LM head, 389 M each: 1.56 GB a
# temporary) beside them. A layer is 79.3 M parameters beside 778 M of
# embedding and LM head: 20 layers (2.36 B) ran out of the card's 79.18
# GiB in the first step's update, 68.78 GiB allocated and 9.05 reserved
# beside it (PERF.md); 16 layers, 2.05 B, about 66 GiB at the
# peak, under TRAIN_ZOO_PEAK_GIB. TRAIN_ZOO_STEPS Adam steps (lr
# TRAIN_ZOO_LR) of TRAIN_ZOO_BATCH (batch, seq) synthetic tokens, step
# i on synthetic_token_batch(seed=i), then one more under the profiler.
# Per step: 2 flash forward launches a layer (the forward, then its
# recomputation under remat) and 1 backward launch a layer.
TRAIN_ZOO_ARCH = "qwen1.5-4b"
TRAIN_ZOO_LAYERS = 16
TRAIN_ZOO_BATCH = (8, 512)
TRAIN_ZOO_STEPS = 4
TRAIN_ZOO_LR = 1e-4
TRAIN_ZOO_PEAK_GIB = 75.0
# its fp32 copy, 2 layers at full width (TF32 off), noised as the
# card-vs-CPU copies: (batch, seq) and the bound of the card against the
# CPU for the loss, each gradient leaf and Adam's moments after one step
# (of each leaf's max |value|: cuBLAS against oneDNN, the flash kernels
# against the plain version, summed in other orders); the parameters
# after the step as tests/test_torch_zoo_train.py holds them (at most 1 in
# 1,000 elements beyond rtol 1e-4 / atol 1e-6, none beyond 2 lr: where a
# gradient element is rounding noise, Adam's m / (sqrt(v) + eps) turns
# it into a step of up to lr either way)
TRAIN_FP32_BATCH = (2, 64)
TRAIN_FP32_TOL = 1e-4
# the flash backward against its plain version on the card: (B, Sq, Skv,
# Hq, Hkv, D, mask), each in fp32 (rtol 2e-4 / atol 2e-5, the forward's)
# and bf16 (within FLASH_BWD_BF16_REL of max |grad|: the gradients stored
# in bf16, 2^-9 of an element, after fp32 sums in another order, P and
# dS rounded once to bf16 by the tensor-core kernels): GQA 4 over 4 key
# tiles with a ragged edge (200 = 3 x 64 + 8) and GQA 16/4 over 5, where
# a dk or dv that lost a head of its group would miss by a quarter; MQA
# windowed; no mask at Sq < Skv and Sq = Skv; every head dim; the train
# path's shape. Then edges inside the bf16 kernels' tiles (128 keys or
# queries a block, 64 a stage): 190 and 129 tokens at D 128 (the second
# block's last 64 keys or queries wholly past the end, or all but one),
# MQA 16/1 over 3 key blocks, a window edge inside a 64-query tile, no
# mask at Sq > Skv, and Whisper's cross-attention shape
FLASH_BWD_CASES = [
    (2, 200, 200, 8, 2, 128, dict(causal=True)),
    (1, 300, 300, 16, 4, 128, dict(causal=True)),
    (2, 333, 333, 4, 1, 64, dict(causal=True, window=100)),
    (2, 77, 300, 4, 4, 80, dict(causal=False)),
    (2, 150, 150, 4, 2, 32, dict(causal=False)),
    (1, 64, 64, 4, 4, 128, dict(causal=True)),
    (2, 96, 96, 32, 32, 80, dict(causal=True, window=40)),
    (8, 512, 512, 20, 20, 128, dict(causal=True)),
    (2, 190, 190, 8, 2, 128, dict(causal=True)),
    (3, 129, 129, 4, 4, 128, dict(causal=True)),
    (1, 300, 300, 16, 1, 128, dict(causal=True)),
    (2, 256, 256, 8, 8, 128, dict(causal=True, window=50)),
    (2, 300, 77, 4, 4, 80, dict(causal=False)),
    (2, 448, 1500, 16, 16, 64, dict(causal=False))]
FLASH_BWD_BF16_REL = 1e-2
# where the bf16 backward is timed beyond the train path's launches:
# the long prompt's shape (Qwen1.5-4B, 4 x 2048), Whisper's encoder
# (8 x 1500, no mask), and Granite-20B's MQA 48/1 at the train path's 8 x
# 512, where the dK/dV blocks are B x Hkv x 4 = 32 on 132 SMs, each
# walking 48 query heads (B, Sq, Skv, Hq, Hkv, D, causal)
FLASH_BWD_TIMED = [(4, 2048, 2048, 20, 20, 128, True),
                   (8, 1500, 1500, 16, 16, 64, False),
                   (8, 512, 512, 48, 1, 128, True)]
# zoo training of the SSM families ([train-ssm]): Mamba2-370M at full
# width and depth (48 layers, d 1024, 32 SSD heads of 64, state 128,
# chunk 128; 0.37 B parameters, ~12 GB at Adam's ~32 bytes a parameter)
# and Zamba2-2.7B at full width cut to TRAIN_ZAMBA_LAYERS (2 stages of 6
# Mamba2 layers, 80 SSD heads of 64, state 64, each stage followed by the
# shared attention block of 32 heads of 80; a depth must be a multiple of
# 6), bf16, remat on, random weights from seed 0, TRAIN_ZOO_BATCH
# tokens, Adam at TRAIN_ZOO_LR. Per step: 2 SSD forward launches a
# Mamba2 layer (the forward and its recomputation under remat) and 1
# backward launch; Zamba2 also 2 flash forward and 1 flash backward
# launches a stage. Mamba2 takes TRAIN_ZOO_STEPS steps and one more under
# the profiler, Zamba2 TRAIN_ZAMBA_STEPS; each one's fp32 copy (Mamba2 2
# layers, Zamba2 one stage) at TRAIN_FP32_BATCH against the CPU: the loss
# and every gradient leaf within TRAIN_FP32_TOL of the leaf's max.
TRAIN_SSM_ARCH = MAMBA_ARCH
TRAIN_ZAMBA_LAYERS = 12
# the training CLI's default (--batch, --seq) for a zoo arch
TRAIN_CLI_BATCH = (32, 128)
TRAIN_ZAMBA_STEPS = 2
# device-kernel names of the SSD backward's bf16 route (the states' walk,
# the chunks, da, the head groups' sum of dB and dC), which a bf16 step
# must run; the first two are wgmma fed by TMA, one instantiation a chunk
# and number of 64-column slabs of the state (1 or 2)
SSD_BWD_SYMBOLS = ("ssd_wgmma_bwd_states", "ssd_wgmma_bwd_chunks",
                   "ssd_wgmma_bwd_da", "ssd_wgmma_bwd_sum")
SSD_BWD_WGMMA = SSD_BWD_SYMBOLS[:2]
# and of its fp32 route on the CUDA cores (each chunk's C B^T, the
# states' sweep, the chunks, the heads' sum), which a bf16 step must not
SSD_BWD_FP32_SYMBOLS = ("ssd_bwd_scores", "ssd_bwd_states",
                        "ssd_bwd_chunk", "ssd_bwd_sum_heads")
# the SSD backward against its plain version on the card, (B, L, H, P, N,
# chunk): the JAX sweep's ragged shapes, every bf16 chunk at a ragged L,
# Mamba2-370M's and Zamba2's instantiations (states 128 and 64) at a
# ragged L of 300, the [train-ssm] fp32 copies' launches (2 x 64 tokens,
# one ragged chunk) and the training path's two, each at the three
# decays in fp32 (within SSD_BWD_FP32_REL of each gradient's max |grad|:
# the same fp32 sums in another order) and bf16 (SSD_BWD_BF16_REL: the
# gradients stored in bf16, 2^-9 of an element, after fp32 sums in
# another order, as the flash backward is held), with and without a
# final-state cotangent in turn
SSD_TRAIN = [(8, 512, 32, 64, 128, 128), (8, 512, 80, 64, 64, 128)]
SSD_BWD_CASES = ([(1, 100, 1, 32, 16, 32), (2, 96, 3, 16, 8, 32)]
                 + [(2, 100, 3, 32, 32, K) for K in (16, 32, 64, 128)]
                 + [(2, 300, 4, 64, 128, 128), (2, 300, 4, 64, 64, 128),
                    (2, 64, 32, 64, 128, 128), (2, 64, 80, 64, 64, 128)]
                 + SSD_TRAIN)
SSD_BWD_FP32_REL, SSD_BWD_BF16_REL = 1e-4, 1e-2
# each arch's fp32 copy: 2 layers, but Zamba2's one stage of 6, and 1
# for the [dense] and [moe] models, whose CPU halves (the LM head at full
# width, up to 256k x 6144) took 110.5 s of the smoke at 2 (PERF.md)
DECODE_FP32_LAYERS = dict({ZOO_ARCH: 2, MAMBA_ARCH: 2, AUDIO_ARCH: 2,
                           ZAMBA_ARCH: ZAMBA_CPU_LAYERS},
                          **{arch: DENSE_FP32_LAYERS
                             for arch in DENSE_ARCHS + MOE_ARCHS})
# the SSD scan from a given state: ssd_chunk at (K, P, N), the JAX
# entry's test shape and a full chunk of Mamba2-370M's; and
# ssd_chunked(initial_state=...) at the decode prefills' SSD shapes
# (B, L, H, P, N, chunk)
SSD_CHUNK_SHAPES = [(32, 16, 8), (128, 64, 128)]
SSD_FROM_STATE = [(8, 2048, 32, 64, 128, 128), (8, 2048, 80, 64, 64, 128)]
# the paper-LSTM training runs of the main path (CLI defaults: AAPL,
# 1430 days, batch 32, seed 0; EVL weight 0.5)
SERIAL_ITERATIONS = 300
LOCAL_SGD_ITERATIONS = 800
COMPARE_SERIAL = 20             # the first iterations held against the CPU
COMPARE_LOCAL_SGD = 28          # W = 4: rounds of 8 and 20 iterations
# the paper's simulator, Table II's homogeneous runs: K iterations for
# each number of clients (benchmarks/bench_speedup.py's K and n)
SIM_K = 2000
SIM_CLIENTS = (1, 2, 5, 10)
# the online path: train and serve in one process, the paper LSTM at full
# width, W = 4 workers, EVL on, a publish every round
ONLINE_ARGS = ["--workers", "4", "--iterations", "400", "--evl-weight",
               "0.5", "--requests", "400", "--rps", "400", "--max-batch",
               "16", "--calib-windows", "64", "--min-publish-interval-ms",
               "0"]


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


# the kernels of the paper LSTM's paths (a training step launches each)
PAPER_KERNELS = ("lstm_layer", "lstm_layer_bwd", "evl")


def counters():
    """Every kernel launch counter of the port, by kernel name."""
    from repro_torch.kernels.attention import kernel as attn_kernel
    from repro_torch.kernels.evl import kernel as evl_kernel
    from repro_torch.kernels.lstm import kernel as lstm_kernel
    from repro_torch.kernels.ssd import kernel as ssd_kernel

    return {"lstm_layer": lstm_kernel.LAUNCHES,
            "lstm_layer_bwd": lstm_kernel.LAYER_BWD_LAUNCHES,
            "evl": evl_kernel.EVL_LAUNCHES,
            "flash_attention": attn_kernel.FLASH_LAUNCHES,
            "flash_attention_bwd": attn_kernel.FLASH_BWD_LAUNCHES,
            "ssd_scan": ssd_kernel.SSD_LAUNCHES,
            "ssd_scan_bwd": ssd_kernel.SSD_BWD_LAUNCHES,
            "ssd_chunk": ssd_kernel.SSD_CHUNK_LAUNCHES}


def paper_counts() -> dict:
    """Launches so far of the paper LSTM's kernels."""
    return {k: c.total for k, c in counters().items() if k in PAPER_KERNELS}


def reset_counters() -> None:
    for c in counters().values():
        c.reset()


def read_counters() -> dict:
    return {name: dict(c.by_shape) for name, c in counters().items()}


@contextlib.contextmanager
def flash_windows():
    """Record the window and the mask of every flash launch: (shape,
    window, causal), the shape (B, Sq, Skv, Hq, Hkv, D); the caller
    reads the list."""
    from repro_torch.kernels.attention import kernel as attn_kernel

    launch = attn_kernel.flash_attention_cuda
    seen: list = []

    def record(q, k, v, causal, window, q_offset, kv_valid, **kw):
        out = launch(q, k, v, causal, window, q_offset, kv_valid, **kw)
        seen.append((tuple(q.shape[:2]) + (k.shape[1],)
                     + tuple(q.shape[2:3]) + (k.shape[2], q.shape[3]),
                     window, bool(causal)))
        return out

    attn_kernel.flash_attention_cuda = record
    try:
        yield seen
    finally:
        attn_kernel.flash_attention_cuda = launch


@contextlib.contextmanager
def no_plain_version_on_the_card():
    """Record every call of a plain version from the kernel wrappers with
    a tensor on the card; the caller checks that there was none."""
    import repro_torch.kernels.attention.ops as attn_ops
    import repro_torch.kernels.evl.ops as evl_ops
    import repro_torch.kernels.lstm.ops as lstm_ops
    import repro_torch.kernels.ssd.ops as ssd_ops
    import repro_torch.kernels.ssd.ref as ssd_ref

    names = [(lstm_ops, "lstm_cell_ref"), (lstm_ops, "lstm_layer_ref"),
             (evl_ops, "evl_loss_ref"), (evl_ops, "evl_loss_and_grad_ref"),
             (attn_ops, "attention_ref"), (ssd_ops, "ssd_scan_ref"),
             (ssd_ops, "ssd_chunk_ref"), (ssd_ref, "ssd_scan_ref"),
             (ssd_ref, "ssd_scan_bwd_ref")]
    calls: list[str] = []
    saved = {(m, n): getattr(m, n) for m, n in names}
    for (mod, name), fn in saved.items():
        def guard(*args, _fn=fn, _name=name, **kwargs):
            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                calls.append(_name)
            return _fn(*args, **kwargs)
        setattr(mod, name, guard)
    try:
        yield calls
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def cell_inputs(W, B, I, H, seed=0):
    g = torch.Generator().manual_seed(seed * 1_000_003 + W * 7_919
                                      + B * 10_007 + I * 101 + H)

    def r(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g)).cuda()

    return (r(W, B, I), r(W, B, H), r(W, B, H), r(W, I, 4 * H, scale=0.1),
            r(W, H, 4 * H, scale=0.1), r(W, 4 * H, scale=0.1))


def bits_inputs(B, I, H):
    """numpy-seeded unstacked inputs for the bitwise check against the
    serving slice's kernel."""
    rng = np.random.default_rng(B * 10_007 + I * 101 + H)
    f = lambda *s, scale=1.0: torch.from_numpy(
        (scale * rng.standard_normal(s)).astype(np.float32)).cuda()
    return (f(B, I), f(B, H), f(B, H), f(I, 4 * H, scale=0.1),
            f(H, 4 * H, scale=0.1), f(4 * H, scale=0.1))


def cell_digest(h, c) -> str:
    return hashlib.sha256(h.cpu().numpy().tobytes()
                          + c.cpu().numpy().tobytes()).hexdigest()


def bound(nbytes: int, ops: int):
    """Least time (ms) for work that moves ``nbytes`` and does ``ops``
    float32 operations, and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def layer_bound(W, B, T, I, H):
    """The layer forward over T steps: each input read once (x, h0, c0,
    the weights and the bias) and each output written once (hs, hT, cT),
    fp32; the two products plus the gate math per step (each
    transcendental counted as one operation)."""
    nbytes = 4 * W * (B * T * I + 2 * B * H + I * 4 * H + H * 4 * H + 4 * H
                      + B * T * H + 2 * B * H)
    ops = W * T * (2 * B * 4 * H * (I + H) + 4 * B * H + 9 * B * H)
    return bound(nbytes, ops)


def layer_bwd_bound(W, B, T, I, H, need_dx: bool):
    """The backward kernel over T steps: reads dhs, the gates, c_t, c0,
    dhT, dcT and wh once, writes dgates, dh0 and dc0 (fp32); about 25
    operations per (row, step, unit) for dgates and dc, and the product
    dgates wh^T per step. With ``need_dx`` it also reads wx, writes dxs
    and does dgates wx^T; without (the first layer, whose input is data)
    it touches none of these."""
    nbytes = 4 * W * (B * T * H + B * T * 4 * H + B * T * H + 3 * B * H
                      + H * 4 * H + B * T * 4 * H + 2 * B * H
                      + (I * 4 * H + B * T * I if need_dx else 0))
    ops = W * T * (25 * B * H + 2 * B * 4 * H * (H + (I if need_dx else 0)))
    return bound(nbytes, ops)


def evl_bound(W, N):
    """The fused EVL launch as training makes it (mean, with the
    gradient): reads u and v once, writes the W losses and the W x N
    gradients; about 45 operations per element (each log, pow and
    division counted as one)."""
    return bound(4 * (2 * W * N + W + W * N), 45 * W * N)


def graph_ms(fn, inner=50, reps=21):
    """Median device time (ms) of one ``fn()`` call: ``inner`` calls are
    captured in a CUDA graph, the graph is replayed ``reps`` times
    between CUDA events. Host launch overhead is left out; the weights
    stay warm in L2, as on both paths, which reuse them every step."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # an empty capture (work that went to another stream) would time
    # nothing: PyTorch only warns, so make that warning an error
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        with torch.cuda.graph(graph):
            for _ in range(inner):
                fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / inner)
    return statistics.median(times)


def eager_ms(fn, n=200):
    """Time (ms) per eager ``fn()`` call, host launch overhead included:
    what one call costs the path."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / n


def ptxas_report(name: str, sources, symbols) -> list[str]:
    """What ``ptxas -v`` said of the kernels named by ``symbols`` when
    ``build`` built library ``name`` (its log beside the library): one
    line a kernel and instantiation (its dtype, or its template's
    integers) with its registers and spills."""
    from repro_torch.kernels import build

    # per entry: "Compiling entry function '<name>'", "Function
    # properties for <name>" (and for each function it calls), "<n> bytes
    # stack frame, <n> bytes spill stores, <n> bytes spill loads", "Used
    # <n> registers, ..."
    report, fn, props, spill = [], None, None, "spills not reported"
    for line in build.ptxas_log(name, sources).read_text().splitlines():
        if "Compiling entry function" in line:
            fn, spill = line.split("'")[1], "spills not reported"
        elif "Function properties for" in line:
            props = line.split("Function properties for", 1)[1].strip()
        elif fn and props == fn and "spill stores" in line:
            spill = line.strip()
        elif fn and "Used" in line and "registers" in line:
            sym = next((k for k in symbols if k in fn), None)
            if sym:
                regs = line.split("Used", 1)[1].split("registers")[0].strip()
                ints = re.findall(r"Li(\d+)E", fn)
                kind = ("bf16" if "bfloat16" in fn else
                        "<" + ", ".join(ints) + ">" if ints else "fp32")
                report.append(f"{sym} {kind}: {regs} registers, {spill}")
            fn = None
    return report


def build_kernels() -> None:
    """Phase 1: build every kernel library from the checkout, one nvcc
    each, all at once; print the SSD backward's ``ptxas_report``."""
    from repro_torch.kernels import build
    from repro_torch.kernels.attention import kernel as attn_kernel
    from repro_torch.kernels.evl import kernel as evl_kernel
    from repro_torch.kernels.lstm import kernel as lstm_kernel
    from repro_torch.kernels.ssd import kernel as ssd_kernel

    libs = {**lstm_kernel.LIBRARIES, **evl_kernel.LIBRARIES,
            **attn_kernel.LIBRARIES, **ssd_kernel.LIBRARIES}
    cached = {n: build.library_path(n, s).exists() for n, s in libs.items()}
    t0 = time.perf_counter()
    paths = build.build_all(libs)
    lstm_kernel._library()                 # loads each library
    lstm_kernel._bwd_library()
    evl_kernel._library()
    attn_kernel._library()
    attn_kernel._bwd_library()
    ssd_kernel._library()
    ssd_kernel._bwd_library()
    for name, path in paths.items():
        print(f"[build] {name}: {'cached' if cached[name] else 'built'} -> "
              f"{path.relative_to(ROOT)}")
    report = ptxas_report("ssd_scan_bwd", ssd_kernel.BWD_SOURCES,
                          SSD_BWD_SYMBOLS + SSD_BWD_FP32_SYMBOLS)
    want = (2 * len(ssd_kernel.BF16_CHUNKS) * len(SSD_BWD_WGMMA)
            + len(SSD_BWD_SYMBOLS) - len(SSD_BWD_WGMMA)
            + len(SSD_BWD_FP32_SYMBOLS))
    check(len(report) == want,
          f"ptxas -v reported {len(report)} kernels of the SSD backward, "
          f"not {want}")
    print(f"[build] {len(libs)} libraries in "
          f"{time.perf_counter() - t0:.2f} s; the SSD backward's ptxas -v: "
          + "; ".join(report))


def sass_counts(library: str, sources) -> dict:
    """The library's SASS (``cuobjdump --dump-sass``): the (HGMMA,
    UTMALDG) counts of every function by its mangled name."""
    from repro_torch.kernels import build

    lib = build.library_path(library, sources)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "--dump-sass", str(lib)],
                         capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed on {lib}: {out.stderr}")
    counts: dict[str, list[int]] = {}
    fn = None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = [0, 0]
        elif fn is not None:
            counts[fn][0] += "HGMMA" in line
            counts[fn][1] += "UTMALDG" in line
    return counts


def check_sass(label: str, library: str, sources, symbol: str,
               instantiations: int) -> dict:
    """Phases 1b and 1c: a bf16 kernel runs on the tensor cores, fed by
    TMA: ``sass_counts`` finds wgmma (HGMMA) and TMA loads (UTMALDG) in
    each of the ``instantiations`` of the kernel whose name holds
    ``symbol``. Returns the library's ``sass_counts``."""
    counts = sass_counts(library, sources)
    hgmma = sum(c[0] for c in counts.values())
    utmaldg = sum(c[1] for c in counts.values())
    bf16 = {f: c for f, c in counts.items() if symbol in f}
    print(f"[sass] {library} library: HGMMA {hgmma}, UTMALDG {utmaldg} "
          f"instructions; in the {label} kernel's {len(bf16)} "
          f"instantiations (HGMMA, UTMALDG): "
          f"{sorted(map(tuple, bf16.values()))}")
    check(hgmma > 0 and utmaldg > 0,
          f"the {library} library issues no wgmma ({hgmma}) or no TMA load "
          f"({utmaldg})")
    check(len(bf16) == instantiations
          and all(h > 0 and u > 0 for h, u in bf16.values()),
          f"an instantiation of {symbol} lacks wgmma or TMA, or one of "
          f"{instantiations} is missing: {bf16}")
    return counts


def check_flash_sass() -> None:
    """Phase 1b: the bf16 flash kernel, one instantiation a head dim; the
    bf16 backward's wgmma kernel, one a head dim and mask (causal or
    none); and the backward's CUDA-core kernels in fp32 only (one each a
    head dim, none instantiated for bf16)."""
    from repro_torch.kernels.attention import kernel as attn_kernel

    n = len(attn_kernel.HEAD_DIMS)
    check_sass("bf16 flash", "flash_attention", attn_kernel.SOURCES,
               FLASH_SYMBOL, n)
    counts = check_sass("bf16 flash backward", "flash_attention_bwd",
                        attn_kernel.BWD_SOURCES, FLASH_BWD_WGMMA, 2 * n)
    fp32 = [f for f in counts if any(s in f for s in FLASH_BWD_SYMBOLS)]
    print(f"[sass] flash_attention_bwd library: {len(fp32)} CUDA-core "
          f"kernel instantiations, none for bf16: {sorted(fp32)}")
    check(len(fp32) == len(FLASH_BWD_SYMBOLS) * n
          and not any("bfloat16" in f for f in fp32),
          f"the backward's CUDA-core kernels are not fp32 alone, one each "
          f"a head dim: {fp32}")


def check_ssd_sass() -> None:
    """Phase 1c: the bf16 SSD kernel, one instantiation a chunk and
    number of 64-column slabs of the state (1 or 2); the bf16 backward's
    states' walk and chunks the same, each with wgmma and TMA; the
    backward's CUDA-core kernels in fp32 only (one instantiation each,
    none for bf16)."""
    from repro_torch.kernels.ssd import kernel as ssd_kernel

    n = 2 * len(ssd_kernel.BF16_CHUNKS)
    check_sass("bf16 SSD", "ssd_scan", ssd_kernel.SOURCES, SSD_SYMBOL, n)
    counts = {}
    for sym in SSD_BWD_WGMMA:
        counts = check_sass("bf16 SSD backward", "ssd_scan_bwd",
                            ssd_kernel.BWD_SOURCES, sym, n)
    fns = list(counts)
    fp32 = {s: [f for f in fns if s in f] for s in SSD_BWD_FP32_SYMBOLS}
    check(all(len(f) == 1 and "bfloat16" not in f[0]
              for f in fp32.values()),
          f"the SSD backward's CUDA-core kernels are not fp32 alone, one "
          f"instantiation each: {fp32}")
    print(f"[sass] ssd_scan_bwd library: {len(fns)} functions; the "
          f"CUDA-core kernels fp32 only, none for bf16: "
          f"{sorted(f for v in fp32.values() for f in v)}")


def layer_inputs(W, B, T, I, H, carry=True, seed=0):
    """Worker-stacked layer inputs on the card from a seeded generator: xs
    [W, B, T, I], a carry (zero unless ``carry``) and the weights."""
    g = torch.Generator().manual_seed(seed * 1_000_003 + W * 7_919
                                      + B * 10_007 + T * 503 + I * 101 + H)

    def r(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g)).cuda()

    xs, h0, c0 = r(W, B, T, I), r(W, B, H), r(W, B, H)
    if not carry:
        h0, c0 = torch.zeros_like(h0), torch.zeros_like(c0)
    return (xs, h0, c0, r(W, I, 4 * H, scale=0.1), r(W, H, 4 * H, scale=0.1),
            r(W, 4 * H, scale=0.1))


def check_forward() -> float:
    """Phase 2a: the layer kernel against its plain version over T steps
    from a zero and a given carry (the paths' shapes, the JAX sweep at
    T 20, where H 128 at I 16 reads its weights from device memory) and as
    the cell at T = 1; a T-step launch bit for bit T chained launches at
    T = 1; its rows' bits independent of B and of W; and a W = 1 cell
    launch bit for bit the serving slice's kernel. Returns the largest
    |kernel - plain|."""
    from repro_torch.kernels.lstm.ops import lstm_cell, lstm_layer
    from repro_torch.kernels.lstm.ref import lstm_cell_ref, lstm_layer_ref

    max_err = 0.0

    def hold(label, got, want):
        nonlocal max_err
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        max_err = max(max_err, err)
        ok = all(torch.allclose(a, b, rtol=RTOL, atol=ATOL)
                 for a, b in zip(got, want))
        print(f"[check] {label}: max |kernel - plain| {err:.3e} (rtol "
              f"{RTOL}, atol {ATOL}) {'ok' if ok else 'MISMATCH'}")
        check(ok, f"{label}: the kernel disagrees with its plain version")

    shapes = LAYER_SHAPES + [(1, B, 20, I, H) for B, I, H in ODD_SHAPES]
    for W, B, T, I, H in shapes:
        for carry in (False, True):
            args = layer_inputs(W, B, T, I, H, carry)
            if W == 1:                   # the unstacked (serving) form
                args = tuple(a[0] for a in args)
            hold(f"lstm_layer W={W} B={B} T={T} I={I} H={H} "
                 f"{'carry' if carry else 'zero carry'}",
                 lstm_layer(*args), lstm_layer_ref(*args))
    for W, B, I, H in PATH_SHAPES + TRAIN_SHAPES + [(1,) + s
                                                    for s in ODD_SHAPES]:
        args = cell_inputs(W, B, I, H)
        if W == 1:
            args = tuple(a[0] for a in args)
        hold(f"lstm_layer as the cell (T=1) W={W} B={B} I={I} H={H}",
             lstm_cell(*args), lstm_cell_ref(*args))
    for I in (5, 64):
        xs, h0, c0, wx, wh, b = (a[0] for a in layer_inputs(1, 32, 20, I, 64,
                                                            seed=1))
        hs, hT, cT = lstm_layer(xs, h0, c0, wx, wh, b)
        h, c = h0, c0
        for t in range(20):
            h, c = lstm_cell(xs[:, t].contiguous(), h, c, wx, wh, b)
            check(torch.equal(hs[:, t], h),
                  f"step {t} of a T=20 launch differs from {t + 1} chained "
                  f"T=1 launches (I={I})")
        check(torch.equal(hT, h) and torch.equal(cT, c),
              f"(hT, cT) of a T=20 launch differ from 20 chained T=1 "
              f"launches (I={I})")
        args = tuple(a[0] for a in layer_inputs(1, 64, 20, I, 64, seed=2))
        out64 = lstm_layer(*args)
        for lo in range(0, 64, 8):
            out8 = lstm_layer(*(a[lo:lo + 8].contiguous() if n < 3 else a
                                for n, a in enumerate(args)))
            check(all(torch.equal(a, b[lo:lo + 8])
                      for a, b in zip(out8, out64)),
                  f"rows {lo}..{lo + 7} of a B=64 T=20 launch differ from a "
                  f"B=8 launch of the same rows (I={I})")
        for T in (20, 1):
            args4 = layer_inputs(4, 32, T, I, 64, seed=3)
            out4 = lstm_layer(*args4)
            for w in range(4):
                out1 = lstm_layer(*(a[w] for a in args4))
                check(all(torch.equal(a, b[w]) for a, b in zip(out1, out4)),
                      f"worker {w} of a W=4 T={T} launch differs from its "
                      f"W=1 launch (I={I})")
    print("[check] lstm_layer: step t of a T=20 launch == t + 1 chained T=1 "
          "launches (hs, hT, cT); rows of B=8 launches == the same rows of "
          "a B=64 launch; the rows of a W=4 launch == four W=1 launches "
          "(T=20 and T=1); all bitwise, I=5 and I=64")
    digests = {}
    for _, B, I, H in PATH_SHAPES:
        digests[f"{B}x{I}x{H}"] = cell_digest(*lstm_cell(*bits_inputs(B, I,
                                                                      H)))
    check(digests == SERVING_SLICE_DIGESTS,
          f"a W = 1 launch is not bit for bit the serving slice's kernel: "
          f"{digests} != {SERVING_SLICE_DIGESTS}")
    print("[check] lstm_layer at T=1, W=1 == the serving slice's cell kernel "
          "bit for bit at the serving shapes (sha256 of h', c')")
    return max_err


def layer_cotangents(W, B, T, H, seed=0):
    """(dhs, dhT, dcT) on the card from a seeded generator."""
    g = torch.Generator().manual_seed(seed * 31 + W * 7 + B + T + H)
    return tuple(torch.randn(*shape, generator=g).cuda()
                 for shape in ((W, B, T, H), (W, B, H), (W, B, H)))


def weight_grad_scales(xs, h0, hs, dgates):
    """|x|^T |dgates|, |h_prev|^T |dgates| and the sum of |dgates| over
    the window's B x T rows (see TRAIN_RTOL)."""
    W, B, T, G = dgates.shape
    rows = dgates.abs().reshape(W, B * T, G)
    h_prev = torch.cat([h0.unsqueeze(2), hs[:, :, :-1]], dim=2).abs()
    return {"wx": torch.bmm(xs.abs().reshape(W, B * T, -1).transpose(1, 2),
                            rows),
            "wh": torch.bmm(h_prev.reshape(W, B * T, -1).transpose(1, 2),
                            rows),
            "b": rows.sum(dim=1)}


def check_backward() -> float:
    """Phase 2b: the layer backward kernel against the plain version of
    its own function (dgates, dxs, dh0, dc0) at the training shapes at
    T 1 and 20 and the JAX sweep at T 20 (H 128 at I 16 reads its weights
    from device memory), from the forward kernel's saved gates and c,
    which are held against the plain forward and change no bit of hs,
    hT, cT; the layer's gradient on the card (the autograd Function: one
    forward launch, one backward launch, the weight gradients by bmm)
    against torch autograd through the plain layer, for all six
    operands; and a T = 20 backward launch bit for bit 20 chained
    launches at T = 1. Returns the largest |kernel - plain| of the
    kernel against its plain version."""
    from repro_torch.kernels.lstm import kernel
    from repro_torch.kernels.lstm.ops import lstm_layer
    from repro_torch.kernels.lstm.ref import (lstm_layer_bwd_ref,
                                              lstm_layer_fwd_ref,
                                              lstm_layer_ref)

    max_err = 0.0
    worst = {}
    shapes = ([(W, B, T, I, H) for T in (1, WINDOW)
               for W, B, I, H in TRAIN_SHAPES]
              + [(1, B, WINDOW, I, H) for B, I, H in ODD_SHAPES])
    for W, B, T, I, H in shapes:
        args = layer_inputs(W, B, T, I, H, seed=3)
        xs, h0, c0, wx, wh, b = args
        saved = kernel.lstm_layer_cuda(*args, save_gates=True)
        plain = lstm_layer_fwd_ref(*args)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b_) for a, b_ in
                  zip(saved[:3], kernel.lstm_layer_cuda(*args))),
              f"saving the gates and c changed the forward's bits at "
              f"W={W} B={B} T={T} I={I} H={H}")
        check(all(torch.allclose(a, b_, rtol=RTOL, atol=ATOL)
                  for a, b_ in zip(saved, plain)),
              f"the forward's saved gates or c disagree with the plain "
              f"version at W={W} B={B} T={T} I={I} H={H}")
        _, _, _, gates, cs = saved
        dhs, dhT, dcT = layer_cotangents(W, B, T, H, seed=T)
        for need_dx in (True, False):
            got = kernel.lstm_layer_bwd_cuda(dhs, dhT, dcT, gates, cs, c0,
                                             wx, wh, need_dx=need_dx)
            want = lstm_layer_bwd_ref(dhs, dhT, dcT, gates, cs, c0, wx, wh,
                                      need_dx=need_dx)
            torch.cuda.synchronize()
            check((got[1] is None) == (not need_dx),
                  "the backward wrote dxs where it was not asked to")
            for name, a, b_ in zip(("dgates", "dxs", "dh0", "dc0"), got,
                                   want):
                if a is None:
                    continue
                err = float((a - b_).abs().max())
                max_err = max(max_err, err)
                check(torch.allclose(a, b_, rtol=RTOL, atol=ATOL),
                      f"lstm_layer backward kernel: {name} disagrees with "
                      f"the plain version at W={W} B={B} T={T} I={I} H={H}"
                      f": max err {err}")
        t1 = [a.clone().requires_grad_(True) for a in args]
        t2 = [a.clone().requires_grad_(True) for a in args]
        n_bwd = kernel.LAYER_BWD_LAUNCHES.total
        hs1, _, cT1 = lstm_layer(*t1)
        g1 = torch.autograd.grad((hs1, cT1), t1, (dhs, dcT))
        hs2, _, cT2 = lstm_layer_ref(*t2)
        g2 = torch.autograd.grad((hs2, cT2), t2, (dhs, dcT))
        torch.cuda.synchronize()
        check(kernel.LAYER_BWD_LAUNCHES.total == n_bwd + 1,
              "the layer's gradient on the card was not one backward "
              "launch")
        dgates = lstm_layer_bwd_ref(dhs, None, dcT, gates, cs, c0, wx,
                                    wh)[0]
        scale = weight_grad_scales(xs, h0, saved[0], dgates)
        errs = []
        for name, a, b_ in zip(("x", "h", "c", "wx", "wh", "b"), g1, g2):
            err = float((a - b_).abs().max())
            errs.append(f"d{name} {err:.2e}")
            worst[name] = max(worst.get(name, 0.0), err)
            if name in scale:
                ok = bool(((a - b_).abs()
                           <= ATOL + RTOL * scale[name]).all())
            else:
                ok = torch.allclose(a, b_, rtol=RTOL, atol=ATOL)
            check(ok,
                  f"lstm_layer gradient d{name} on the card disagrees with "
                  f"autograd of the plain layer at W={W} B={B} T={T} I={I} "
                  f"H={H}: max err {err}")
        print(f"[check] lstm_layer backward W={W} B={B} T={T} I={I} H={H}: "
              f"vs autograd of the plain layer {', '.join(errs)} (rtol "
              f"{RTOL}, atol {ATOL}; dwx, dwh, db against the terms' "
              f"magnitudes) ok")
    for I in (5, 64):
        args = layer_inputs(4, 32, WINDOW, I, 64, seed=6)
        _, _, _, gates, cs = kernel.lstm_layer_cuda(*args, save_gates=True)
        c0, wx, wh = args[2], args[3], args[4]
        dhs, dhT, dcT = layer_cotangents(4, 32, WINDOW, 64, seed=1)
        dgates, dxs, dh0, dc0 = kernel.lstm_layer_bwd_cuda(
            dhs, dhT, dcT, gates, cs, c0, wx, wh)
        dh, dc = dhT, dcT
        for t in reversed(range(WINDOW)):
            c_prev = c0 if t == 0 else cs[:, :, t - 1].contiguous()
            dg, dx, dh, dc = kernel.lstm_layer_bwd_cuda(
                dhs[:, :, t:t + 1].contiguous(), dh, dc,
                gates[:, :, t:t + 1].contiguous(),
                cs[:, :, t:t + 1].contiguous(), c_prev, wx, wh)
            check(torch.equal(dg[:, :, 0], dgates[:, :, t])
                  and torch.equal(dx[:, :, 0], dxs[:, :, t]),
                  f"step {t} of a T={WINDOW} backward launch differs from "
                  f"{WINDOW - t} chained T=1 launches (I={I})")
        check(torch.equal(dh, dh0) and torch.equal(dc, dc0),
              f"(dh0, dc0) of a T={WINDOW} backward launch differ from "
              f"{WINDOW} chained T=1 launches (I={I})")
    print(f"[check] lstm_layer backward: step t of a T={WINDOW} launch == "
          f"{WINDOW} - t chained T=1 launches (dgates, dxs, dh0, dc0), "
          f"bitwise, W=4, I=5 and I=64; largest |kernel - plain| over "
          f"dgates, dxs, dh0, dc0 {max_err:.3e}; largest gradient error by "
          f"operand {json.dumps({k: float(f'{v:.3e}') for k, v in worst.items()})}")
    return max_err


def check_evl() -> float:
    """Phase 2c: the fused EVL kernel (mean, sum, none; u at 0, eps,
    1 - eps and 1; v at 0 and 1; gamma 2 and 1.5, where the weight's
    shared power is not exact; W = 40, two blocks with the last one
    partly empty): its loss and du_unit against
    ``evl_loss_and_grad_ref``, the wrapper's gradient (one launch, the
    backward a multiply) against autograd of the plain loss, a call
    without grad against the plain loss; a row of W = 4 bit for bit the
    row launched alone; the same bits over 10 runs. Returns the largest
    |kernel - plain|."""
    from repro_torch.kernels.evl import kernel
    from repro_torch.kernels.evl.ops import evl_loss
    from repro_torch.kernels.evl.ref import (evl_loss_and_grad_ref,
                                             evl_loss_ref, reduce_rows)

    err = 0.0

    def close(a, b):
        return torch.allclose(a, b, rtol=EVL_RTOL, atol=EVL_ATOL)

    cases = [(W, N, gamma) for W, N in EVL_SHAPES + [(2, 300), (40, 32)]
             for gamma in (2.0, 1.5)]
    for W, N, gamma in cases:
        betas = (0.93, 0.07, gamma)
        g = torch.Generator().manual_seed(W * 1000 + N)
        u = torch.rand(W, N, generator=g)
        u[:, :4] = torch.tensor(EVL_EDGES)
        u[:, 4:8] = torch.tensor(EVL_EDGES)
        v = (torch.rand(W, N, generator=g) < 0.3).float()
        v[:, :4] = 0.0
        v[:, 4:8] = 1.0
        u, v = u.cuda(), v.cuda()
        for reduce in ("mean", "sum", "none"):
            out, du = kernel.evl_cuda(u, v, *betas, EVL_EPS, reduce, True)
            want, dwant = evl_loss_and_grad_ref(u, v, *betas, EVL_EPS,
                                                reduce)
            alone, no_du = kernel.evl_cuda(u, v, *betas, EVL_EPS, reduce,
                                           False)
            uk = u.clone().requires_grad_(True)
            ur = u.clone().requires_grad_(True)
            before = kernel.EVL_LAUNCHES.total
            got = evl_loss(uk, v, *betas, EVL_EPS, reduce)
            ref = reduce_rows(evl_loss_ref(ur, v, *betas, EVL_EPS), reduce)
            gout = torch.rand(got.shape, generator=g).cuda() + 0.5
            (dk,) = torch.autograd.grad(got, uk, gout)
            (dr,) = torch.autograd.grad(ref, ur, gout)
            launched = kernel.EVL_LAUNCHES.total - before
            torch.cuda.synchronize()
            ef = max(float((out - want).abs().max()),
                     float((alone - want).abs().max()),
                     float((got - ref).detach().abs().max()))
            eb = max(float((du - dwant).abs().max()),
                     float((dk - dr).abs().max()))
            err = max(err, ef, eb)
            ok = (close(out, want) and close(du, dwant) and close(alone, want)
                  and close(got, ref) and close(dk, dr) and no_du is None)
            print(f"[check] evl W={W} N={N} gamma={gamma} {reduce}: max "
                  f"|kernel - plain| "
                  f"loss {ef:.3e}, du_unit and the wrapper's dL/du {eb:.3e} "
                  f"(rtol {EVL_RTOL}, atol {EVL_ATOL}); forward + backward "
                  f"{launched} launch {'ok' if ok else 'MISMATCH'}")
            check(ok, f"the evl kernel disagrees with the plain version at "
                      f"W={W} N={N} gamma={gamma} reduce={reduce}")
            check(launched == 1, f"evl forward + backward made {launched} "
                                 f"launches, not 1")
            check(bool((du[:, 0] == 0).all() and (du[:, 3] == 0).all()
                       and (du[:, 1] != 0).all() and (du[:, 2] != 0).all()),
                  "evl dL/du at the clip's edges")
    betas = (0.93, 0.07, 2.0)
    for reduce in ("mean", "sum", "none"):
        u = torch.rand(4, 32, generator=torch.Generator().manual_seed(5))
        u[:, :4] = torch.tensor(EVL_EDGES)
        u, v = u.cuda(), (u > 0.7).float().cuda()
        out, du = kernel.evl_cuda(u, v, *betas, EVL_EPS, reduce, True)
        for w in range(4):
            one, done = kernel.evl_cuda(u[w:w + 1].contiguous(),
                                        v[w:w + 1].contiguous(), *betas,
                                        EVL_EPS, reduce, True)
            check(torch.equal(one[0], out[w]) and torch.equal(done[0], du[w]),
                  f"evl {reduce}: row {w} of a W = 4 launch differs from "
                  f"the row launched alone")
    print("[check] evl: every row of a W = 4 launch bit for bit the row "
          "launched alone (loss and du_unit; mean, sum, none)")
    u = torch.rand(4, 32, generator=torch.Generator().manual_seed(9)).cuda()
    v = (u > 0.7).float()
    first = kernel.evl_cuda(u, v, *betas, EVL_EPS, "mean", True)
    check(all(torch.equal(a, b) for _ in range(10) for a, b in zip(
        kernel.evl_cuda(u, v, *betas, EVL_EPS, "mean", True), first)),
          "the evl loss or its gradient changed between runs")
    print("[check] evl loss and du_unit bitwise the same over 10 runs (no "
          "atomics)")
    return err


def training_data():
    """The CLI's default data: synthetic AAPL, 1430 days."""
    from repro_torch.data import load_stock, make_windows, train_test_split

    tr, te = train_test_split(load_stock("AAPL", n_days=1430, seed=0))
    return make_windows(tr), make_windows(te)


def check_gradients(train_ds) -> None:
    """Phase 2d: one local-SGD step of the paper LSTM on the card, W = 4
    workers, EVL on: every LSTM weight of every worker gets a nonzero
    gradient, equal to the CPU port's (plain path) to TRAIN_RTOL of the
    leaf's largest entry, and all four kernels launched."""
    from repro_torch.checkpoint.convert import params_to, stack_workers
    from repro_torch.configs.paper_lstm import CONFIG
    from repro_torch.core.async_local_sgd import to_device, value_and_grad
    from repro_torch.models.rnn import init_rnn
    from repro_torch.training import loop

    params = stack_workers(init_rnn(torch.Generator().manual_seed(0), CONFIG,
                                    device="cpu"), 4)
    idx = np.random.default_rng(0).permutation(len(train_ds))[:4 * 32]
    batch = tuple(np.stack(parts) for parts in zip(*(
        loop._batch_arrays(train_ds, idx[w * 32:(w + 1) * 32])
        for w in range(4))))
    loss_fn = loop._loss_fn_for(train_ds, CONFIG, 0.5)
    reset_counters()
    with no_plain_version_on_the_card() as plain_calls:
        loss_g, grads_g = value_and_grad(loss_fn, params_to(params, "cuda"),
                                         to_device(batch, "cuda"))
        torch.cuda.synchronize()
    launched = paper_counts()
    loss_c, grads_c = value_and_grad(loss_fn, params, to_device(batch, "cpu"))
    check(not plain_calls, f"plain versions ran on the card: {plain_calls}")
    check(all(n > 0 for n in launched.values()),
          f"a training step did not launch every kernel: {launched}")
    worst = 0.0
    for layer, (lg, lc) in enumerate(zip(grads_g["lstm"], grads_c["lstm"])):
        for name in ("wx", "wh", "b"):
            g, c = lg[name].cpu(), lc[name]
            for w in range(4):
                check(bool(torch.count_nonzero(g[w]) > 0),
                      f"worker {w}: lstm[{layer}].{name} got no gradient "
                      f"on the card")
            err = float((g - c).abs().max() / c.abs().max())
            worst = max(worst, err)
            check(err <= TRAIN_RTOL,
                  f"lstm[{layer}].{name} gradient card vs CPU: max error "
                  f"{err:.3e} of the leaf's largest entry")
    dloss = float(((loss_g.cpu() - loss_c).abs() / loss_c.abs()).max())
    check(dloss <= TRAIN_RTOL, f"training loss card vs CPU: {dloss:.3e}")
    print(f"[check] one training step, W=4, full width, EVL on: nonzero "
          f"gradients on every LSTM weight of every worker; card vs CPU: "
          f"loss {dloss:.3e} relative, LSTM gradients {worst:.3e} of each "
          f"leaf's largest entry (bound {TRAIN_RTOL}); launches {launched}")


def check_forecaster():
    """Phase 3: the paper LSTM on the card: step == replay == generate
    bitwise, steps and generate at T = 1 launches and replay at one T = 20
    launch per layer, and predict against the same port on the CPU.
    Returns the forecaster."""
    from repro_torch.kernels.lstm import kernel as lstm_kernel
    from repro_torch.checkpoint.convert import params_to
    from repro_torch.launch import serve
    from repro_torch.serving import LSTMForecaster, build_lstm_forecaster

    fc = build_lstm_forecaster(seed=0, device="cuda")
    check(fc.device.type == "cuda", f"forecaster on {fc.device}")
    streams = serve._traffic_datasets(3, fc.window, seed=7)
    w = np.stack([ds.x[0] for ds in streams])              # [3, 20, 5]
    carry = fc.init_carry(1)
    lstm_kernel.LAUNCHES.reset()
    for t in range(fc.window):
        ys, ps, carry = fc.step(w[0:1, t], carry)
    n_step = lstm_kernel.LAUNCHES.total
    yr, pr, cr = fc.replay(w[0:1])
    by_T = {}
    for (_, _, T, _, _), n in lstm_kernel.LAUNCHES.by_shape.items():
        by_T[T] = by_T.get(T, 0) + n
    n_layers = len(fc.params["lstm"])
    check(n_step == n_layers * fc.window
          and by_T == {1: n_step, fc.window: n_layers},
          f"steps and replay did not run the layer kernel at T = 1 and at "
          f"one T = {fc.window} launch per layer: {by_T}")
    slots = fc.init_slots(64)
    lanes = (5, 17, 42)                 # three different lane chunks
    for lane in lanes:
        fc.insert(slots, lane, fc.init_carry(1))
    for t in range(fc.window):
        xs = np.zeros((slots.num_slots, fc.feature_dim), np.float32)
        for s, lane in enumerate(lanes):
            xs[lane] = w[s, t]
        yg, pg, _ = fc.generate(slots, xs, lanes=list(lanes))
    torch.cuda.synchronize()
    same = (np.array_equal(ys, yr) and np.array_equal(ps, pr)
            and ys[0] == yg[lanes[0]] and ps[0] == pg[lanes[0]])
    for (h1, c1), (h2, c2), (hs, cs) in zip(carry, cr, slots.carry):
        same = same and torch.equal(h1, h2) and torch.equal(c1, c2) \
            and torch.equal(h1[0], hs[lanes[0]]) \
            and torch.equal(c1[0], cs[lanes[0]])
    check(same, "step, replay and generate disagree bitwise on the card")
    for s in (1, 2):
        y1, p1, _ = fc.replay(w[s:s + 1])
        check(y1[0] == yg[lanes[s]] and p1[0] == pg[lanes[s]],
              f"generate lane {lanes[s]} != replay of its session")
    print(f"[forecaster] step == replay == generate bitwise on the card "
          f"(y {float(ys[0]):+.6f}, p {float(ps[0]):.6f}): {n_step} launches "
          f"at T=1 for the steps, {n_layers} at T={fc.window} for the "
          f"replay")
    windows = np.concatenate([ds.x[:16] for ds in streams])  # [48, 20, 5]
    y_gpu, p_gpu = fc.predict(windows)
    cpu = LSTMForecaster(cfg=fc.cfg, params=params_to(fc.params, "cpu"),
                         tail=fc.tail, eps=fc.eps, device="cpu")
    y_cpu, p_cpu = cpu.predict(windows)
    check(np.all(np.isfinite(y_gpu)) and np.all(np.isfinite(p_gpu))
          and y_gpu.shape == (48,), "predict on the card: bad output")
    dy = float(np.abs(y_gpu - y_cpu).max())
    dp = float(np.abs(p_gpu - p_cpu).max())
    check(np.allclose(y_gpu, y_cpu, rtol=FC_RTOL, atol=FC_ATOL)
          and np.allclose(p_gpu, p_cpu, rtol=FC_RTOL, atol=FC_ATOL),
          f"predict on the card vs on the CPU: max |dy| {dy}, |dp| {dp}")
    print(f"[forecaster] predict card vs CPU (plain path, same params), 48 "
          f"windows: max |dy| {dy:.3e}, |dp| {dp:.3e} (rtol {FC_RTOL}, "
          f"atol {FC_ATOL})")
    return fc


def serve_main_path(fc, tag: str):
    """Phase 4, the serving path: 128 windowed requests from 32 clients,
    then 20 ticks of ``submit_step`` from 8 clients, through
    ``ServingEngine``. Kernel launch counts are zeroed just before and
    read just after. Returns (launches by kernel and shape, payloads,
    sessions)."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.lstm import kernel as lstm_kernel
    from repro_torch.launch import serve
    from repro_torch.serving import (BatcherConfig, ModelRegistry,
                                     ServingEngine)

    registry = ModelRegistry()
    registry.register("paper-lstm", fc)
    traffic = serve._traffic_datasets(32, fc.window, seed=0)
    payloads = [traffic[i % 32].x[i % len(traffic[i % 32])]
                for i in range(128)]
    sessions = serve._traffic_datasets(8, fc.window, seed=1)
    engine = ServingEngine(registry, BatcherConfig(
        max_batch=32, max_wait_ms=2.0, length_buckets=(fc.window,)))
    with engine:
        engine.warmup("paper-lstm", lengths=(fc.window,))
        engine.telemetry.reset_clock()
        reset_counters()
        with dispatch.counting() as counts, \
                no_plain_version_on_the_card() as plain_calls:
            t0 = time.perf_counter()
            futs = [engine.submit("paper-lstm", p,
                                  client_id=f"client-{i % 32}")
                    for i, p in enumerate(payloads)]
            results = [f.result(timeout=120.0) for f in futs]
            wall = time.perf_counter() - t0
            traffic_snap = engine.telemetry.snapshot()
            n_predict = lstm_kernel.LAUNCHES.total
            step_results = []
            t0s = time.perf_counter()
            for t in range(fc.window):
                futs = [engine.submit_step("paper-lstm", f"client-{c}",
                                           ds.x[0][t])
                        for c, ds in enumerate(sessions)]
                step_results.append([f.result(timeout=60.0) for f in futs])
            wall_s = time.perf_counter() - t0s
        launches = read_counters()
    snap = engine.telemetry.snapshot()
    n_generate = sum(launches["lstm_layer"].values()) - n_predict
    flushes, step_flushes = traffic_snap["batches"], snap["step_batches"]
    check(not plain_calls, f"plain versions ran on the card: {plain_calls}")
    check(len(results) == 128 and all(np.isfinite(v) for r in results
                                      for v in r),
          "a served request did not resolve to finite values")
    check(traffic_snap["requests"] == 128, "served request count")
    check(snap["step_requests"] == 8 * fc.window, "served step count")
    check(counts["predict"] == flushes,
          f"{counts['predict']} predict dispatches for {flushes} flushes")
    check(counts["slots_generate"] == step_flushes,
          f"{counts['slots_generate']} slots_generate for {step_flushes} "
          f"step flushes: not one per flush")
    check(counts["decode_many"] == 0 and counts["decode_step"] == 0,
          "step flushes left the slot path")
    check(n_predict > 0 and n_generate > 0,
          f"kernel launches: {n_predict} on predict, {n_generate} on "
          f"generate: the path did not run the kernel on both")
    n_layers = len(fc.params["lstm"])
    check(n_predict == n_layers * flushes,
          f"{n_predict} forward launches for {flushes} predict flushes: not "
          f"one per layer per flush ({n_layers})")
    y_ref, p_ref = fc.predict(np.stack(payloads))
    got = np.asarray(results, np.float32)
    check(np.allclose(got[:, 0], y_ref, rtol=FC_RTOL, atol=FC_ATOL)
          and np.allclose(got[:, 1], p_ref, rtol=FC_RTOL, atol=FC_ATOL),
          "served forecasts disagree with one predict of the same windows")
    for c, ds in enumerate(sessions):
        y1, p1, _ = fc.replay(ds.x[0][None])
        check(step_results[-1][c] == (float(y1[0]), float(p1[0])),
              f"session client-{c}: served steps != its replay, bitwise")
    print(f"[serve] {tag}: 128 requests from 32 clients in "
          f"{wall * 1e3:.1f} ms: {traffic_snap['throughput_rps']:.1f} req/s, "
          f"p50 {traffic_snap['p50_ms']:.3f} ms, p95 "
          f"{traffic_snap['p95_ms']:.3f} ms, {flushes} predict flushes, "
          f"{n_predict} kernel launches = {n_predict / flushes:.1f} per "
          f"predict flush")
    print(f"[serve] {tag}: {8 * fc.window} session steps from 8 clients in "
          f"{wall_s * 1e3:.1f} ms: {step_flushes} step flushes, "
          f"{counts['slots_generate']} slots_generate, step p50 "
          f"{snap['step_p50_ms']:.3f} ms p95 {snap['step_p95_ms']:.3f} ms, "
          f"{n_generate} kernel launches = {n_generate / step_flushes:.1f} "
          f"per generate flush; served steps == replay, bitwise; no plain "
          f"version on the card")
    print(f"[serve] dispatch counts {counts.by_op()}; kernel launches by "
          f"(W, B, T, I, H) {launches['lstm_layer']}")
    return launches, payloads, sessions


def train_main_path(data, tag: str):
    """Phase 5, the training path: the serial baseline and asynchronous
    local SGD with W = 4 workers (linear schedule, tau 0 and 1), EVL on,
    full width, through ``repro_torch.training``. Every launch counter is
    zeroed just before and read just after. The first iterations' losses
    are held against the same runs of the port on the CPU, and each
    run's test MSE (the kernel over the whole test set in one launch per
    step) against the CPU's plain path on the trained weights. Returns
    the launches by kernel and shape, and each run's wall ms a local
    step."""
    from repro_torch.checkpoint.convert import params_to
    from repro_torch.configs.paper_lstm import CONFIG
    from repro_torch.models.rnn import init_rnn
    from repro_torch.training.loop import (evaluate, train_rnn_local_sgd,
                                           train_rnn_serial)
    from repro_torch.tree import tree_leaves

    train_ds, test_ds = data
    init = init_rnn(torch.Generator().manual_seed(0), CONFIG, device="cpu")
    step_ms = {}
    runs = [("serial", train_rnn_serial, {}, SERIAL_ITERATIONS,
             COMPARE_SERIAL),
            ("local SGD W=4 tau=0", train_rnn_local_sgd,
             {"n_workers": 4, "tau": 0}, LOCAL_SGD_ITERATIONS,
             COMPARE_LOCAL_SGD),
            ("local SGD W=4 tau=1", train_rnn_local_sgd,
             {"n_workers": 4, "tau": 1}, LOCAL_SGD_ITERATIONS,
             COMPARE_LOCAL_SGD)]
    common = dict(cfg=CONFIG, batch=32, evl_weight=0.5, seed=0,
                  init_params=init)
    # two short runs first: the same inputs must give the same bits (no
    # float atomics anywhere on the path), and the first-call costs of
    # the allocator and cuBLAS stay out of the timed runs
    a, b = (train_rnn_local_sgd(train_ds, test_ds, iterations=28,
                                n_workers=4, tau=1, device="cuda", **common)
            for _ in range(2))
    same = a.loss_history == b.loss_history and all(
        torch.equal(x, y) for x, y in zip(tree_leaves(a.params),
                                          tree_leaves(b.params)))
    check(same, "two identical training runs on the card differ")
    print(f"[train] two identical local-SGD runs (W=4, tau=1, 28 "
          f"iterations) on the card: loss histories and weights bitwise "
          f"equal ({a.loss_history})")
    reset_counters()
    with no_plain_version_on_the_card() as plain_calls:
        for name, fn, kw, iters, n_cmp in runs:
            before = paper_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(train_ds, test_ds, iterations=iters, device="cuda",
                     **kw, **common)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = {k: n - before[k] for k, n in paper_counts().items()}
            hist = np.asarray(res.loss_history)
            check(np.all(np.isfinite(hist)) and np.isfinite(res.test_mse),
                  f"{name}: non-finite loss or test MSE")
            k = max(len(hist) // 10, 1)
            check(hist[-k:].mean() < hist[:k].mean(),
                  f"{name}: the loss did not fall ({hist[:k].mean():.5f} -> "
                  f"{hist[-k:].mean():.5f})")
            steps = res.iterations // kw.get("n_workers", 1)
            step_ms[name] = wall / steps * 1e3
            # each local step: the layer forward and backward once per
            # layer at T = window, the EVL loss with its dL/du once;
            # then evaluate's forward, once per layer
            n_layers = len(res.params["lstm"])
            want = {"lstm_layer": n_layers * (steps + 1),
                    "lstm_layer_bwd": n_layers * steps, "evl": steps}
            check(launched == want,
                  f"{name}: launches {launched}, not {want}: not "
                  f"{2 * n_layers + 1} per local step")
            cpu = fn(train_ds, test_ds, iterations=n_cmp, device="cpu",
                     **kw, **common)
            n = len(cpu.loss_history)
            drift = float(np.max(np.abs(hist[:n] - cpu.loss_history)
                                 / np.abs(cpu.loss_history)))
            check(drift <= TRAIN_RTOL,
                  f"{name}: the first {n_cmp} iterations' losses drift "
                  f"{drift:.3e} from the CPU port's (bound {TRAIN_RTOL})")
            mse_cpu = evaluate(params_to(res.params, "cpu"), CONFIG,
                               test_ds)[0]
            dmse = abs(res.test_mse - mse_cpu) / mse_cpu
            check(dmse <= FC_RTOL,
                  f"{name}: test MSE on the card {res.test_mse} vs the CPU's "
                  f"plain path on the same weights {mse_cpu}: {dmse:.3e}")
            print(f"[train] {tag}: {name}: {res.iterations} iterations in "
                  f"{wall:.3f} s = {wall / res.iterations * 1e3 * 1e3:.1f} ms "
                  f"per 1000 iterations, {res.iterations / wall:.1f} "
                  f"iterations/s, {steps} local steps "
                  f"({wall / steps * 1e3:.3f} ms each); communications "
                  f"{res.communications}, comm bytes {res.comm_bytes}; test "
                  f"MSE {res.test_mse:.6f}; loss {hist[0]:.5f} -> "
                  f"{hist[-1]:.5f} over {len(hist)} "
                  f"{'rounds' if 'n_workers' in kw else 'iterations'}; "
                  f"first {n_cmp} iterations ({n} losses) vs the CPU port: "
                  f"max relative drift {drift:.3e} (bound {TRAIN_RTOL}); "
                  f"test MSE vs the CPU on the same weights {dmse:.3e} "
                  f"relative (bound {FC_RTOL}); "
                  f"launches {launched} = {2 * n_layers + 1} per local "
                  f"step + {n_layers} for evaluate")
        launches = read_counters()
    check(not plain_calls, f"plain versions ran on the card: {plain_calls}")
    print(f"[train] kernel launches on the training path by shape: "
          f"{launches}; no plain version on the card")
    return launches, step_ms


def run_clis(window: int) -> None:
    """Phase 6: the serving and training CLIs on the card."""
    from repro_torch.launch import serve, train

    out = serve.main(["--model", "paper-lstm", "--clients", "32",
                      "--requests", "128", "--max-batch", "32",
                      "--sessions", "--device", "cuda"])
    check(out["traffic"]["requests"] == 128
          and out["sessions"]["step_requests"] == 8 * window,
          "python -m repro_torch.launch.serve did not serve everything")
    print("[cli] repro_torch.launch.serve --sessions --device cuda: ok")
    reset_counters()
    res = train.main(["--arch", "paper-lstm", "--workers", "4",
                      "--iterations", "200", "--evl-weight", "0.5",
                      "--device", "cuda"])
    launched = paper_counts()
    check(np.isfinite(res.test_mse) and res.communications > 0,
          "python -m repro_torch.launch.train gave no trained model")
    check(all(n > 0 for n in launched.values()),
          f"the train CLI did not launch every kernel: {launched}")
    print(f"[cli] repro_torch.launch.train --workers 4 --iterations 200 "
          f"--evl-weight 0.5 --device cuda: ok, launches {launched}")


def merge_launches(*paths) -> dict:
    """Launch counts by kernel and shape summed over several paths."""
    out: dict = {}
    for launches in paths:
        for name, by_shape in launches.items():
            mine = out.setdefault(name, {})
            for shape, n in by_shape.items():
                mine[shape] = mine.get(shape, 0) + n
    return out


def check_reload(loaded, saved, version: int, windows, what: str) -> int:
    """A serving checkpoint reloaded onto the card against the forecaster
    that was saved: the same version, config and calibration, and
    predictions and alert probabilities on ``windows`` bitwise the same
    (the same weights through the same kernels). Returns the number of
    predictions compared."""
    check(loaded.version == version,
          f"{what}: loaded v{loaded.version}, saved v{version}")
    check(loaded.tail == saved.tail and loaded.eps == saved.eps
          and loaded.cfg == saved.cfg,
          f"{what}: the loaded forecaster's calibration or config differs")
    y1, p1 = loaded.predict(windows)
    y0, p0 = saved.predict(windows)
    check(np.array_equal(y1, y0) and np.array_equal(p1, p0)
          and np.all(np.isfinite(y1)),
          f"{what}: predictions after the reload differ from the saved "
          f"model's")
    return len(y1)


def checkpoint_main_path(data, tag: str) -> dict:
    """Phase 6b, the checkpoint bridge: ``repro_torch.launch.train
    --save`` (W = 4, 200 iterations, EVL 0.5) then ``serve --checkpoint``
    on the card; in process, ``ModelRegistry().load`` of the file, whose
    predictions and alert probabilities on the test windows must be
    bitwise those of the forecaster that was saved (the same weights
    through the same kernels), at the version max(communications, 1);
    then Mamba2-370M at full width through ``save_bytes`` /
    ``load_bytes`` on the card: bf16 leaves come back bf16, dt_bias and
    A_log fp32, every leaf bitwise, and one predict flush bitwise the
    same. Every counter is zeroed just before and read just after.
    Returns the launches by kernel and shape."""
    import os
    import tempfile

    from repro_torch.configs.paper_lstm import CONFIG
    from repro_torch.data.tokens import synthetic_token_batch
    from repro_torch.launch import serve, train
    from repro_torch.serving import (LSTMForecaster, ModelRegistry,
                                     build_zoo_forecaster)
    from repro_torch.tree import tree_flatten_with_path

    train_ds, test_ds = data
    reset_counters()
    with tempfile.TemporaryDirectory() as tmp, \
            no_plain_version_on_the_card() as plain_calls:
        path = os.path.join(tmp, "trained.npz")
        res = train.main(["--arch", "paper-lstm", "--workers", "4",
                          "--iterations", "200", "--evl-weight", "0.5",
                          "--save", path, "--device", "cuda"])
        out = serve.main(["--checkpoint", path, "--clients", "32",
                          "--requests", "128", "--max-batch", "32",
                          "--device", "cuda"])
        check(out["traffic"]["requests"] == 128,
              "serve --checkpoint did not serve every request")
        lstm_size = os.path.getsize(path)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = ModelRegistry().load(path, key="trained", device="cuda")
        torch.cuda.synchronize()
        lstm_load_s = time.perf_counter() - t0
        saved = LSTMForecaster(cfg=CONFIG, params=res.params,
                               device="cuda").calibrate(train_ds.x)
        reg = ModelRegistry()
        reg.register("trained", saved, version=max(res.communications, 1))
        t0 = time.perf_counter()
        reg.save("trained", os.path.join(tmp, "again.npz"))
        lstm_save_s = time.perf_counter() - t0
        n_pred = check_reload(loaded, saved, max(res.communications, 1),
                              test_ds.x, "train --save")
        print(f"[checkpoint] {tag}: train --save (W=4, 200 iterations, "
              f"{res.communications} communications) -> serve "
              f"--checkpoint: 128 requests served; reload v"
              f"{loaded.version}: {n_pred} test predictions and alert "
              f"probabilities bitwise equal to the saved model's; file "
              f"{lstm_size} bytes, save {lstm_save_s * 1e3:.2f} ms, load "
              f"{lstm_load_s * 1e3:.2f} ms")

        fc = build_zoo_forecaster(MAMBA_ARCH, seed=0, reduced=False,
                                  device="cuda")
        reg.register(MAMBA_ARCH, fc)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blob = reg.save_bytes(MAMBA_ARCH)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = ModelRegistry().load_bytes(blob, key=MAMBA_ARCH,
                                          device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        want = dict(tree_flatten_with_path(fc.params))
        dtypes = {}
        for key, leaf in tree_flatten_with_path(back.params):
            ref = want[key]
            check(leaf.is_cuda and leaf.dtype == ref.dtype
                  and torch.equal(leaf, ref),
                  f"{MAMBA_ARCH} leaf {'/'.join(map(str, key))} differs "
                  f"after save_bytes / load_bytes")
            dtypes[key[-1]] = str(leaf.dtype).removeprefix("torch.")
        fp32 = sorted(k for k, d in dtypes.items() if d == "float32")
        check(fp32 == ["A_log", "dt_bias"]
              and set(dtypes.values()) == {"bfloat16", "float32"},
              f"{MAMBA_ARCH} dtypes after the round trip: {dtypes}")
        toks = synthetic_token_batch(8, 32, fc.cfg.vocab, seed=11)
        tok1, prob1 = back.predict(toks)
        tok0, prob0 = fc.predict(toks)
        check(np.array_equal(tok1, tok0) and np.array_equal(prob1, prob0),
              f"{MAMBA_ARCH}: a predict flush differs after the round trip")
        print(f"[checkpoint] {tag}: {MAMBA_ARCH} full width "
              f"({len(want)} leaves, bf16 but {', '.join(fp32)} fp32): "
              f"save_bytes {len(blob)} bytes in {save_s:.3f} s, load_bytes "
              f"onto the card {load_s:.3f} s; every leaf bitwise, one "
              f"predict flush (8 x 32 tokens) bitwise equal")
        del fc, back, blob
        torch.cuda.synchronize()
        launches = read_counters()
    check(not plain_calls, f"plain versions ran on the card: {plain_calls}")
    totals = {k: sum(v.values()) for k, v in launches.items()}
    check(all(totals[k] > 0 for k in (*PAPER_KERNELS, "ssd_scan")),
          f"the checkpoint path did not launch every kernel it runs: "
          f"{totals}")
    print(f"[checkpoint] launches {totals}; no plain version on the card")
    return launches


def simulator_main_path(data, tag: str) -> dict:
    """Phase 6c, the paper's simulator (Table II, homogeneous speeds):
    ``repro_torch.core.simulator.AsyncSimulator`` with
    ``benchmarks/bench_speedup.py``'s settings (K = SIM_K, batch 32,
    server cost 0.02, network delay (0.005, 0.02), iid client splits)
    for each n of SIM_CLIENTS, the paper LSTM at full width with EVL
    0.5, from one seeded init. Speedup must rise with n and each run's
    final evaluation MSE be finite; every local step launches the layer
    kernel and its backward once per layer and EVL once, and each
    evaluation the layer kernel once per layer. Every counter is zeroed
    just before and read just after. Returns the launches by kernel and
    shape."""
    from repro_torch.configs.paper_lstm import CONFIG
    from repro_torch.core.simulator import AsyncSimulator, SimConfig
    from repro_torch.data.sharding import client_splits
    from repro_torch.models.rnn import init_rnn
    from repro_torch.optim.optimizers import sgd
    from repro_torch.training import loop

    train_ds, test_ds = data
    init = init_rnn(torch.Generator().manual_seed(0), CONFIG, device="cpu")
    loss_fn = loop._loss_fn_for(train_ds, CONFIG, 0.5)
    n_layers = CONFIG.num_layers

    def client(idx):
        def gen(rng, h, batch):
            b = [rng.choice(idx, size=batch) for _ in range(h)]
            return (np.stack([train_ds.x[i] for i in b]),
                    np.stack([train_ds.y[i] for i in b]),
                    np.stack([train_ds.v.astype(np.float32)[i] for i in b]),
                    np.ones((h, batch), np.float32))
        return gen

    speedups = []
    reset_counters()
    with no_plain_version_on_the_card() as plain_calls:
        for n in SIM_CLIENTS:
            sim = AsyncSimulator(
                loss_fn, sgd(), init,
                [client(s) for s in client_splits(len(train_ds), n, "iid")],
                SimConfig(n_clients=n, total_iterations=SIM_K, batch_size=32,
                          heterogeneous_speeds=False, server_cost=0.02,
                          net_delay=(0.005, 0.02)),
                eval_fn=lambda p: loop.evaluate(p, CONFIG, test_ds)[0],
                device="cuda")
            before = paper_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s = sim.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = {k: c - before[k] for k, c in paper_counts().items()}
            steps, evals = s["iterations"], len(s["eval_log"])
            want = {"lstm_layer": n_layers * (steps + evals),
                    "lstm_layer_bwd": n_layers * steps, "evl": steps}
            check(launched == want,
                  f"simulator n={n}: launches {launched}, not {want}: not "
                  f"{2 * n_layers + 1} per local step + {n_layers} per "
                  f"evaluation")
            mse = s["eval_log"][-1][1]
            check(np.isfinite(mse), f"simulator n={n}: final MSE {mse}")
            speedups.append(s["speedup"])
            print(f"[simulator] {tag}: n={n}: speedup {s['speedup']:.4f}, "
                  f"communications {s['communications']}, max staleness "
                  f"{s['max_staleness']}, makespan {s['makespan']:.4f}, "
                  f"final MSE {mse:.6f}; {steps} local steps + {evals} "
                  f"evaluations in {wall:.3f} s wall "
                  f"({wall / steps * 1e3:.3f} ms a step); launches "
                  f"{launched}")
        launches = read_counters()
    check(not plain_calls, f"plain versions ran on the card: {plain_calls}")
    check(all(a < b for a, b in zip(speedups, speedups[1:])),
          f"speedup does not rise with n: {speedups}")
    print(f"[simulator] Table II (homogeneous, K={SIM_K}): speedups "
          f"{dict(zip(SIM_CLIENTS, (round(x, 4) for x in speedups)))}; no "
          f"plain version on the card")
    return launches


def online_main_path(alone_ms: float, tag: str) -> dict:
    """Phase 6d, training and serving at once: ``repro_torch.launch.online``
    in process (``run``, ONLINE_ARGS, ``--save``): the trainer thread runs
    asynchronous local SGD (W = 4, EVL 0.5) and publishes every round's
    average, re-calibrated on 64 windows, into the registry the engine's
    flush thread serves from, while this thread plays 400 req/s of client
    traffic. The launch counters are zeroed after the engine's warmup
    (``on_serving``) and read when ``run`` returns; the two threads'
    launches must add up exactly. Every request must be answered, across
    at least 3 versions; the final version must hold the trainer's final
    weights, serve them as a fresh forecaster does, carry the calibration
    a fresh ``calibrate`` gives, and reload from ``--save`` bitwise.
    ``alone_ms`` is ``train_main_path``'s W = 4 local step alone, printed
    beside the trainer's step under traffic. Returns the launches by
    kernel and shape."""
    import os
    import tempfile

    from repro_torch.configs.paper_lstm import CONFIG
    from repro_torch.kernels import dispatch
    from repro_torch.launch import online
    from repro_torch.serving import LSTMForecaster, ModelRegistry
    from repro_torch.tree import tree_leaves

    predicts_before = []

    def on_serving():
        reset_counters()
        predicts_before.append(counts["predict"])

    with tempfile.TemporaryDirectory() as tmp, \
            no_plain_version_on_the_card() as plain_calls, \
            dispatch.counting() as counts:
        path = os.path.join(tmp, "online.npz")
        args = online.parse_args([*ONLINE_ARGS, "--save", path,
                                  "--device", "cuda"])
        out = online.run(args, on_serving=on_serving)
        torch.cuda.synchronize()
        launches = read_counters()
        n_predict = counts["predict"] - predicts_before[0]
        snap, res, registry = out["snapshot"], out["result"], out["registry"]
        published = out["publisher"]["published"]
        train_ds, test_ds = out["data"]
        # one local step runs all W workers: each LSTM layer's forward and
        # backward once and EVL once, whatever W
        check(res.iterations % args.workers == 0,
              f"{res.iterations} iterations over {args.workers} workers")
        steps = res.iterations // args.workers
        flushes = snap["batches"]
        n_layers = len(res.params["lstm"])
        totals = {k: sum(v.values()) for k, v in launches.items()}
        want = dict(dict.fromkeys(counters(), 0),
                    lstm_layer=n_layers * (steps + published + flushes + 1),
                    lstm_layer_bwd=n_layers * steps, evl=steps)
        check(totals == want,
              f"online launches {totals}, not {want}: {steps} local steps, "
              f"{published} publishes (a calibration predict each), "
              f"{flushes} serving flushes and one evaluate, "
              f"{n_layers} layers")
        check(n_predict == flushes + published,
              f"{n_predict} predict dispatches for {flushes} flushes and "
              f"{published} calibrations")
        check(out["served"] >= 400 and snap["requests"] == out["served"],
              f"served {out['served']}, the engine answered "
              f"{snap['requests']}")
        by_version = snap["requests_by_version"]
        check(len(by_version) >= 3,
              f"requests served by {len(by_version)} versions: {by_version}")
        check(snap["swaps"] == published,
              f"{snap['swaps']} swaps for {published} publishes")
        final_v = registry.version(online.KEY)
        check(final_v == 1 + published
              and out["publisher"]["last_version"] == final_v,
              f"final version v{final_v} after {published} publishes")
        final = registry.get(online.KEY)
        for got, want_p in zip(tree_leaves(final.params),
                               tree_leaves(res.params)):
            check(got.is_cuda and not got.requires_grad
                  and torch.allclose(got, want_p, rtol=1e-6, atol=0),
                  "the final served weights differ from the trainer's")
        fresh = LSTMForecaster(cfg=CONFIG, params=final.params,
                               tail=final.tail, eps=final.eps,
                               gamma=final.gamma, device="cuda")
        y1, p1 = final.predict(test_ds.x)
        y0, p0 = fresh.predict(test_ds.x)
        check(np.array_equal(y1, y0) and np.array_equal(p1, p0)
              and np.all(np.isfinite(y1)),
              "the final version predicts otherwise than a fresh forecaster "
              "on its weights")
        recal = LSTMForecaster(cfg=CONFIG, params=final.params,
                               device="cuda").calibrate(out["calib"])
        check(recal.tail == final.tail and recal.eps == final.eps,
              f"the final version's calibration {final.tail} {final.eps} "
              f"!= a fresh calibrate's {recal.tail} {recal.eps}")
        n_pred = check_reload(
            ModelRegistry().load(path, key=online.KEY, device="cuda"),
            final, final_v, test_ds.x, "online --save")
    check(not plain_calls, f"plain versions ran on the card: {plain_calls}")
    pubs = out["publish_s"]
    under_ms = (out["train_s"] - sum(pubs)) / steps * 1e3
    print(f"[online] {tag}: W=4, {res.iterations} iterations ({steps} local "
          f"steps, {res.communications} rounds), EVL 0.5, while serving: "
          f"{out['served']} requests in {out['wall_s']:.3f} s wall, "
          f"{snap['throughput_rps']:.1f} req/s served, {flushes} flushes, "
          f"p50 {snap['p50_ms']:.3f} ms, p95 {snap['p95_ms']:.3f} ms, p99 "
          f"{snap['p99_ms']:.3f} ms; staleness at serve p50 "
          f"{snap['staleness_p50_s'] * 1e3:.2f} ms, p95 "
          f"{snap['staleness_p95_s'] * 1e3:.2f} ms")
    print(f"[online] {tag}: {published} publishes (calibrate on 64 windows "
          f"+ swap): median {statistics.median(pubs) * 1e3:.3f} ms, max "
          f"{max(pubs) * 1e3:.3f} ms; requests by version "
          f"{dict(sorted(by_version.items()))}; final v{final_v}")
    print(f"[online] {tag}: the trainer's local step under traffic "
          f"{under_ms:.3f} ms (trainer wall {out['train_s']:.3f} s less "
          f"the publishes), alone {alone_ms:.3f} ms (train_main_path, W=4 "
          f"tau=0, this call)")
    print(f"[online] launches {totals} = {n_layers} x ({steps} local "
          f"steps + {published} publishes + {flushes} flushes + 1 evaluate) "
          f"forward, {n_layers} x {steps} backward, {steps} EVL; final "
          f"weights "
          f"within rtol 1e-6 of the trainer's, {len(y1)} test predictions "
          f"bitwise a fresh forecaster's, calibration bitwise a fresh "
          f"calibrate's, --save reload bitwise ({n_pred} predictions); no "
          f"plain version on the card")
    return launches


def time_kernels(serve_launches: dict, train_launches: dict, tag: str):
    """Phase 7: each kernel at every shape of the paper LSTM's paths
    (serving; training, the checkpoint bridge, the simulator and the
    online path, summed in ``train_launches``), held against
    its plain version on the same inputs, then its device time beside
    the plain version's, its PyTorch yardstick (never called by the port)
    and its bound. Returns rows by kernel and shape, the launches on the
    main paths, and the largest |kernel - plain| by kernel."""
    from repro_torch.kernels.evl import kernel as evl_kernel
    from repro_torch.kernels.evl.ops import evl_loss
    from repro_torch.kernels.evl.ref import evl_loss_and_grad_ref
    from repro_torch.kernels.lstm import kernel as lstm_kernel
    from repro_torch.kernels.lstm.ops import (layer_grads, lstm_cell,
                                              lstm_layer)
    from repro_torch.kernels.lstm.ref import (lstm_layer_bwd_ref,
                                              lstm_layer_ref)

    rows = {name: {} for name in PAPER_KERNELS}
    errs = {name: 0.0 for name in PAPER_KERNELS}

    def hold(name, shape, got, want, rtol, atol):
        """|kernel - plain| at one shape of the path, within tolerance."""
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        errs[name] = max(errs[name], err)
        check(all(torch.allclose(a, b, rtol=rtol, atol=atol)
                  for a, b in zip(got, want)),
              f"{name} kernel disagrees with its plain version at the "
              f"path's shape {shape}: max err {err}")

    lib_err = 0.0                  # largest |torch.lstm - plain|
    lib_bwd_err = 0.0              # the same of its gradients
    fwd_shapes = (set(LAYER_SHAPES) | {(1, 1, 1, 1, 8)}
                  | set(serve_launches["lstm_layer"])
                  | set(train_launches["lstm_layer"]))
    for W, B, T, I, H in sorted(fwd_shapes):
        args = layer_inputs(W, B, T, I, H, seed=2)
        hold("lstm_layer", (W, B, T, I, H), lstm_kernel.lstm_layer_cuda(*args),
             lstm_layer_ref(*args), RTOL, ATOL)
        # torch.lstm (cuDNN) for one layer over the same window, one call
        # per worker, through nn.LSTM so that its weights are one flat
        # buffer: weights as [4H, K], b_ih = b and b_hh = 0
        xs, h0, c0, wx, wh, b = args
        lstms = []
        for w in range(W):
            m = torch.nn.LSTM(I, H, batch_first=True).cuda()
            with torch.no_grad():
                m.weight_ih_l0.copy_(wx[w].t())
                m.weight_hh_l0.copy_(wh[w].t())
                m.bias_ih_l0.copy_(b[w])
                m.bias_hh_l0.zero_()
            m.flatten_parameters()
            lstms.append(m)

        @torch.no_grad()
        def library():
            return [m(xs[w], (h0[w][None], c0[w][None]))
                    for w, m in enumerate(lstms)]

        want = lstm_layer_ref(*args)
        for w, (hl, (hTl, cTl)) in enumerate(library()):
            got = (hl, hTl[0], cTl[0])
            err = max(float((a - r[w]).abs().max())
                      for a, r in zip(got, want))
            check(all(torch.allclose(a, r[w], rtol=FC_RTOL, atol=FC_ATOL)
                      for a, r in zip(got, want)),
                  f"torch.lstm is not the same function at "
                  f"{W, B, T, I, H}: max |torch.lstm - plain| {err:.3e}")
            lib_err = max(lib_err, err)
        # the wrapper as the path calls it: a window through lstm_layer,
        # a step through lstm_cell; unstacked for one model
        one = tuple(a[0] for a in args) if W == 1 else args
        if T == 1:
            step = (one[0][..., 0, :].contiguous(),) + one[1:]
            wrapper = lambda: lstm_cell(*step)
        else:
            wrapper = lambda: lstm_layer(*one)
        bnd, by = layer_bound(W, B, T, I, H)
        rows["lstm_layer"][(W, B, T, I, H)] = {
            "ms": graph_ms(lambda: lstm_kernel.lstm_layer_cuda(*args)),
            "plain_ms": graph_ms(lambda: lstm_layer_ref(*args)),
            "library_ms": graph_ms(library),
            "eager_ms": eager_ms(wrapper),
            "bound_ms": bnd, "bound_by": by}
    bwd_shapes = ({(W, B, WINDOW, I, H) for W, B, I, H in TRAIN_SHAPES}
                  | set(train_launches["lstm_layer_bwd"]))
    for W, B, T, I, H in sorted(bwd_shapes):
        args = layer_inputs(W, B, T, I, H, seed=4)
        xs, h0, c0, wx, wh, b = args
        hs, _, _, gates, cs = lstm_kernel.lstm_layer_cuda(*args,
                                                          save_gates=True)
        dhs, dhT, dcT = layer_cotangents(W, B, T, H, seed=4)
        need_dx = I != 5          # the first layer's input is data
        need = (need_dx, False, False, True, True, True)

        def kernel_bwd():
            return lstm_kernel.lstm_layer_bwd_cuda(
                dhs, dhT, dcT, gates, cs, c0, wx, wh, need_dx=need_dx)

        def plain_bwd():
            return lstm_layer_bwd_ref(dhs, dhT, dcT, gates, cs, c0, wx, wh,
                                      need_dx=need_dx)

        got, want = kernel_bwd(), plain_bwd()
        hold("lstm_layer_bwd", (W, B, T, I, H),
             [t for t in got if t is not None],
             [t for t in want if t is not None], RTOL, ATOL)

        def fwd_bwd():            # the kernels plus the weight gradients
            out = lstm_kernel.lstm_layer_cuda(*args, save_gates=True)
            return layer_grads((xs, h0, c0, wx, wh, out[0], out[3],
                                out[4]), dhs, dhT, dcT, need,
                               lstm_kernel.lstm_layer_bwd_cuda)

        # torch.lstm (cuDNN) forward and backward over the same window,
        # one nn.LSTM per worker (weights as in the forward's yardstick):
        # the gradients of (hs, hT, cT) for h0, c0 and, where the path
        # needs dx, x; with the weight gradients, also wx, wh and b
        lstms = []
        for w in range(W):
            m = torch.nn.LSTM(I, H, batch_first=True).cuda()
            with torch.no_grad():
                m.weight_ih_l0.copy_(wx[w].t())
                m.weight_hh_l0.copy_(wh[w].t())
                m.bias_ih_l0.copy_(b[w])
                m.bias_hh_l0.zero_()
            m.flatten_parameters()
            lstms.append(m)
        leaves = [t.clone().requires_grad_(need or need_dx)
                  for need, t in ((False, xs), (True, h0), (True, c0))]
        weights = [p for m in lstms for p in m.parameters()]
        wrt = leaves if need_dx else leaves[1:]

        def library_fwd():
            return [m(leaves[0][w], (leaves[1][w][None],
                                     leaves[2][w][None]))
                    for w, m in enumerate(lstms)]

        def library_fwd_bwd(inputs):
            outs = library_fwd()
            return torch.autograd.grad(
                [t for hl, (hT, cT) in outs for t in (hl, hT, cT)], inputs,
                [t for w in range(W) for t in (dhs[w], dhT[w][None],
                                               dcT[w][None])])

        lib = library_fwd_bwd(wrt + weights)
        t2 = [a.clone().requires_grad_(True) for a in args]
        hs2, hT2, cT2 = lstm_layer_ref(*t2)
        ref = torch.autograd.grad((hs2, hT2, cT2), t2, (dhs, dhT, dcT))
        lib_in = dict(zip(("x", "h", "c") if need_dx else ("h", "c"),
                          lib[:len(wrt)]))
        lib_w = lib[len(wrt):]
        # per worker: weight_ih, weight_hh, bias_ih, bias_hh of nn.LSTM
        lib_in["wx"] = torch.stack([lib_w[4 * w].t() for w in range(W)])
        lib_in["wh"] = torch.stack([lib_w[4 * w + 1].t() for w in range(W)])
        lib_in["b"] = torch.stack([lib_w[4 * w + 2] for w in range(W)])
        scale = weight_grad_scales(xs, h0, hs, got[0])
        for name, r in zip(("x", "h", "c", "wx", "wh", "b"), ref):
            if name not in lib_in:
                continue
            a = lib_in[name].reshape(r.shape)
            err = float((a - r).abs().max())
            lib_bwd_err = max(lib_bwd_err, err)
            ok = (bool(((a - r).abs() <= FC_ATOL + FC_RTOL * scale[name])
                       .all()) if name in scale
                  else torch.allclose(a, r, rtol=FC_RTOL, atol=FC_ATOL))
            check(ok, f"torch.lstm's backward is not the same function at "
                      f"{W, B, T, I, H}: d{name} max |torch.lstm - plain| "
                      f"{err:.3e}")
        bnd, by = layer_bwd_bound(W, B, T, I, H, need_dx)
        lib_fwd = graph_ms(lambda: library_fwd())
        rows["lstm_layer_bwd"][(W, B, T, I, H)] = {
            "ms": graph_ms(kernel_bwd),
            "plain_ms": graph_ms(plain_bwd),
            "library_ms": graph_ms(lambda: library_fwd_bwd(wrt)) - lib_fwd,
            "fwd_bwd_ms": graph_ms(fwd_bwd),
            "library_fwd_bwd_ms": graph_ms(
                lambda: library_fwd_bwd(wrt + weights)),
            "eager_ms": eager_ms(kernel_bwd),
            "bound_ms": bnd, "bound_by": by}
    betas = (0.93, 0.07, 2.0)
    for W, N in sorted(set(EVL_SHAPES) | set(train_launches["evl"])):
        g = torch.Generator().manual_seed(W + N)
        u = torch.rand(W, N, generator=g).cuda()
        v = (torch.rand(W, N, generator=g) < 0.1).float().cuda()
        ug = u.clone().requires_grad_(True)
        # the launch as training makes it: the loss and dL/du, mean
        kfn = lambda: evl_kernel.evl_cuda(u, v, *betas, EVL_EPS, "mean", True)
        pfn = lambda: evl_loss_and_grad_ref(u, v, *betas, EVL_EPS, "mean")
        hold("evl", (W, N), kfn(), pfn(), EVL_RTOL, EVL_ATOL)
        bnd, by = evl_bound(W, N)
        # eager: without grad (the loss alone), and under autograd (with
        # dL/du, as a training step calls it)
        rows["evl"][(W, N)] = {
            "ms": graph_ms(kfn), "plain_ms": graph_ms(pfn),
            "library_ms": None,
            "eager_ms": eager_ms(lambda: evl_loss(u, v, *betas, EVL_EPS)),
            "eager_grad_ms": eager_ms(
                lambda: evl_loss(ug, v, *betas, EVL_EPS)),
            "bound_ms": bnd, "bound_by": by}
    print(f"[check] {tag}: torch.lstm (cuDNN) against the plain layer at "
          f"every timed shape: max |torch.lstm - plain| {lib_err:.3e}, of "
          f"its gradients {lib_bwd_err:.3e} (rtol {FC_RTOL}, atol "
          f"{FC_ATOL}; dwx, dwh, db against the terms' magnitudes)")
    floor = rows["lstm_layer"][(1, 1, 1, 1, 8)]
    print(f"[time] {tag}: launch floor (layer kernel at W=1 B=1 T=1 I=1 "
          f"H=8): "
          f"{floor['ms'] * 1e3:.2f} us per launch in a CUDA graph, "
          f"{floor['eager_ms'] * 1e3:.2f} us per eager wrapper call")
    every = {k: {**serve_launches.get(k, {})} for k in rows}
    for k, by_shape in train_launches.items():
        for s, n in by_shape.items():
            every[k][s] = every[k].get(s, 0) + n
    for name, by_shape in rows.items():
        for shape, r in by_shape.items():
            extra = (f", the forward kernel + the backward kernel + the "
                     f"weight gradients (2 bmm + sum) "
                     f"{r['fwd_bwd_ms'] * 1e3:.2f} us against torch.lstm's "
                     f"forward + backward "
                     f"{r['library_fwd_bwd_ms'] * 1e3:.2f} us"
                     if "fwd_bwd_ms" in r else "")
            if "eager_grad_ms" in r:
                extra += (f", eager wrapper call under autograd "
                          f"{r['eager_grad_ms'] * 1e3:.2f} us")
            lib = ("none" if r["library_ms"] is None
                   else f"{r['library_ms'] * 1e3:.2f} us")
            print(f"[time] {tag}: {name} {shape}: kernel "
                  f"{r['ms'] * 1e3:.2f} us (eager "
                  f"{'binding' if name == 'lstm_layer_bwd' else 'wrapper'} "
                  f"call "
                  f"{r['eager_ms'] * 1e3:.2f} us){extra}, plain "
                  f"{r['plain_ms'] * 1e3:.2f} us, library {lib}, bound "
                  f"{r['bound_ms'] * 1e3:.4f} us ({r['bound_by']}); "
                  f"{every[name].get(shape, 0)} launches on the main paths")
    print(f"[check] {tag}: every kernel held against its plain version "
          f"at every shape of the main paths: max |kernel - plain| "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})}")
    return rows, every, errs


def profile(label: str, drive, tag: str):
    """The device's busy share (kernel time from ``torch.profiler`` over
    wall time) while ``drive()`` runs. Only the device's own events are
    summed: a CPU op (``aten::bmm``, an autograd node) also carries the
    device time of the kernels it launched, and adding it too would count
    those kernels twice. Returns (wall us, busy us, [(us, count, kernel
    name)] largest first)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        drive()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return busy_share(label, prof, wall_us, tag)


def busy_share(label: str, prof, wall_us: float, tag: str):
    """``profile``'s reading of a finished profiler over ``wall_us``."""
    from torch.autograd import DeviceType

    kernels = sorted(((e.self_device_time_total, e.count, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0), reverse=True)
    device_us = sum(k[0] for k in kernels)
    check(0 < device_us <= wall_us,
          f"{label}: device busy {device_us:.1f} us of {wall_us:.0f} us")
    top = "; ".join(f"{us:.1f} us x{n} {key[:48]}"
                    for us, n, key in kernels[:5])
    print(f"[profile] {tag}: {label}: wall {wall_us:.0f} us, device "
          f"busy {device_us:.1f} us = {100 * device_us / wall_us:.2f} % "
          f"(idle {100 - 100 * device_us / wall_us:.2f} %); top: {top}")
    return wall_us, device_us, kernels


def profile_serving(fc, payloads, sessions, tag: str) -> None:
    """Phase 8a, where the serving time goes."""
    from repro_torch.serving import (BatcherConfig, ModelRegistry,
                                     ServingEngine)

    def ticks():
        for t in range(fc.window):
            for f in [engine.submit_step("paper-lstm", f"p{c}", ds.x[0][t])
                      for c, ds in enumerate(sessions)]:
                f.result(timeout=60.0)

    registry = ModelRegistry()
    registry.register("paper-lstm", fc)
    with ServingEngine(registry, BatcherConfig(
            max_batch=32, max_wait_ms=2.0,
            length_buckets=(fc.window,))) as engine:
        engine.warmup("paper-lstm", lengths=(fc.window,))
        profile("128 requests, 32 clients", lambda: [
            f.result(timeout=120.0) for f in
            [engine.submit("paper-lstm", p) for p in payloads]], tag)
        profile("20 ticks of 8 session steps", ticks, tag)


def profile_training(train_ds, tag: str) -> None:
    """Phase 8b, where the training time goes: 3 rounds of 5 local steps
    of W = 4 workers (EVL on), after 2 rounds of warm-up."""
    from repro_torch.configs.paper_lstm import CONFIG
    from repro_torch.core.async_local_sgd import (AsyncLocalSGD,
                                                  LocalSGDConfig)
    from repro_torch.models.rnn import init_rnn
    from repro_torch.optim.optimizers import sgd
    from repro_torch.training import loop

    trainer = AsyncLocalSGD(loop._loss_fn_for(train_ds, CONFIG, 0.5), sgd(),
                            LocalSGDConfig(n_workers=4))
    state = list(trainer.init(init_rnn(torch.Generator().manual_seed(1),
                                       CONFIG, device="cuda")))
    rng = np.random.default_rng(1)
    rounds = []
    for _ in range(5):
        idx = rng.integers(0, len(train_ds), size=(4, 5, 32))
        rounds.append((train_ds.x[idx], train_ds.y[idx],
                       train_ds.v[idx].astype(np.float32),
                       np.ones(idx.shape, np.float32)))

    def run(batches):
        for b in batches:
            state[:2] = trainer.run_round(state[0], state[1], b)[:2]

    run(rounds[:2])
    reset_counters()
    profile("3 local-SGD rounds, W=4, 5 local steps each",
            lambda: run(rounds[2:]), tag)
    n = sum(c.total for c in counters().values())
    paper = paper_counts()
    # a local step: each layer's forward and backward, and the EVL loss
    # with its dL/du, once
    n_layers = CONFIG.num_layers
    want = {"lstm_layer": 15 * n_layers, "lstm_layer_bwd": 15 * n_layers,
            "evl": 15}
    check(paper == want and n == 15 * (2 * n_layers + 1),
          f"15 profiled local steps launched {read_counters()}, not "
          f"{want}: not {2 * n_layers + 1} per local step")
    print(f"[profile] {tag}: {n} kernel launches in 15 local steps = "
          f"{n / 15:.1f} per local step ({read_counters()})")


def profile_online(tag: str) -> None:
    """Phase 8c, where the online path's time goes: the device's busy
    share over ``repro_torch.launch.online.run`` (ONLINE_ARGS, no
    ``--save``) from the engine's warmup to its return, the trainer's,
    the flush thread's and the calibrations' kernels together."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from repro_torch.launch import online

    prof = torch_profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA])
    t0 = []

    def on_serving():
        prof.start()
        t0.append(time.perf_counter())

    out = online.run(online.parse_args([*ONLINE_ARGS, "--device", "cuda"]),
                     on_serving=on_serving)
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0[0]) * 1e6
    prof.stop()
    busy_share(f"online, W=4 training + {out['served']} requests "
               f"({out['publisher']['published']} publishes)", prof,
               wall_us, tag)


def attn_inputs(B, Sq, Skv, Hq, Hkv, D, dtype, seed=0):
    """q [B, Sq, Hq, D], k, v [B, Skv, Hkv, D] from a seeded generator
    on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(B, s, h, D, generator=g,
                             device="cuda").to(dtype)
                 for s, h in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv)))


def flash_ops(B, Sq, Skv, Hq, Hkv, D, window=None, causal=True):
    """Flash attention's operations (q_offset 0): 4 B Hq D per (query,
    key) pair it attends, two for q . k and two for p v. Causal, query i
    attends keys [0, i]; with a window only those in (i - window, i];
    without the causal mask (and no window) every one of the Sq x Skv
    pairs."""
    if not causal and window is None:
        return 4 * B * Hq * D * Sq * Skv
    check(causal, "flash_ops counts no window without the causal mask")
    pos = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(pos + 1, Skv)
    lo = np.zeros_like(pos) if window is None else np.maximum(
        pos + 1 - window, 0)
    return 4 * B * Hq * D * int(np.maximum(hi - lo, 0).sum())


def flash_bound(B, Sq, Skv, Hq, Hkv, D, window=None, causal=True,
                itemsize=2):
    """Flash attention (causal, windowed or without a mask) at the bf16
    tensor-core peak; q, k, v read once and o written once at the
    memory rate."""
    ops = flash_ops(B, Sq, Skv, Hq, Hkv, D, window, causal)
    nbytes = itemsize * (2 * B * Sq * Hq * D + 2 * B * Skv * Hkv * D)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_rows_alone(shape, causal: bool = True) -> None:
    """The rows of a bf16 flash launch at (B, Sq, Skv, Hq, Hkv, D), causal
    or not, bit for bit the launches of each row alone (B = 1)."""
    from repro_torch.kernels.attention.ops import flash_attention

    B = shape[0]
    q, k, v = attn_inputs(*shape, torch.bfloat16, seed=99)
    full = flash_attention(q, k, v, causal=causal)
    for b in range(B):
        one = flash_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                              causal=causal)
        check(torch.equal(one[0], full[b]),
              f"flash attention at {shape} causal={causal}: row {b} of "
              f"the B={B} launch != its B=1 launch")


def check_flash() -> float:
    """Phase 9: flash attention against its plain version on the card,
    over the JAX kernel tests' sweep with the causal, non-causal,
    window=37, q_offset and kv_valid masks, and over Whisper's
    cross-attention and encoder shapes without a mask (FLASH_CROSS), in
    fp32 and bf16; and rows of B = 1 launches bit for bit the rows of a
    B = 8 launch at the short prompt's shape and at Whisper's burst-A
    cross-attention. Returns the largest |kernel - plain| (fp32)."""
    from repro_torch.kernels.attention.ops import flash_attention
    from repro_torch.kernels.attention.ref import attention_ref

    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    cases = [((B, S, S, Hq, Hkv, D), mask)
             for B, S, Hq, Hkv, D in FLASH_SHAPES
             for mask in FLASH_MASKS + [dict(causal=False, kv_valid=S - 13)]]
    cases += [(shape, dict(causal=False)) for shape in FLASH_CROSS]
    n = 0
    for shape, mask in cases:
        for dt in worst:
            n += 1
            q, k, v = attn_inputs(*shape, dt, seed=n)
            got = flash_attention(q, k, v, **mask).float()
            want = attention_ref(q, k, v, **mask).float()
            err = float((got - want).abs().max())
            worst[dt] = max(worst[dt], err)
            rtol, atol = ((FLASH_RTOL, FLASH_ATOL) if dt == torch.float32
                          else (FLASH_BF16_RTOL, FLASH_BF16_ATOL))
            check(torch.allclose(got, want, rtol=rtol, atol=atol),
                  f"flash attention disagrees with its plain version at "
                  f"{shape} {mask} {dt}: max err {err}")
    flash_rows_alone((8, 32, 32, 20, 20, 128))
    flash_rows_alone(AUDIO_CROSS, causal=False)
    print(f"[check] flash attention vs plain over {n} cases (the JAX sweep "
          f"and D 80 x causal, full, window 37, q_offset 29, kv_valid; "
          f"Whisper's non-causal (B, Sq, Skv, Hq, Hkv, D) {FLASH_CROSS}; "
          f"x fp32 on the CUDA-core kernel, bf16 on the wgmma one): "
          f"max |kernel - plain| fp32 {worst[torch.float32]:.3e} (rtol "
          f"{FLASH_RTOL}, atol {FLASH_ATOL}), bf16 "
          f"{worst[torch.bfloat16]:.3e} (rtol {FLASH_BF16_RTOL}, atol "
          f"{FLASH_BF16_ATOL}); rows of B=1 "
          f"launches == rows of a B=8 launch bitwise (8x32x20x128 causal "
          f"and {AUDIO_CROSS} non-causal, bf16)")
    return worst[torch.float32]


def ssd_inputs(B, L, H, P, N, kind, dtype, chunk, seed=0):
    """xd [B, L, H, P], a [B, L, H] (fp32), B_, C_ [B, L, N] from a seeded
    generator on the card, a drawn as ``kind`` (``SSD_DRAWS``)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    lo, hi = (0.01, 0.5) if kind == "sweep" else (1e-4, 1e-2)
    a = -(lo + (hi - lo) * torch.rand(B, L, H, generator=g, device="cuda"))
    if kind == "clip":                  # each chunk's last row
        a[:, chunk - 1::chunk] = -100.0
        a[:, L - 1] = -100.0
    if kind == "clip-mid":              # a random row of every 128
        offset = int(torch.randint(0, min(L, 128), (1,), generator=g,
                                   device="cuda"))
        a[:, offset::128] = -100.0
    xd = 0.1 * torch.randn(B, L, H, P, generator=g, device="cuda")
    Bm = 0.3 * torch.randn(B, L, N, generator=g, device="cuda")
    Cm = 0.3 * torch.randn(B, L, N, generator=g, device="cuda")
    return xd.to(dtype), a, Bm.to(dtype), Cm.to(dtype)


def ssd_bound(B, L, H, P, N, K, itemsize=2):
    """The SSD scan: xd and y, B_ and C_ (``itemsize`` bytes), a and the
    final state (fp32) each moved once at the memory rate; the products
    this L needs, chunk by chunk over its r valid rows: C B^T and the
    masked mix with xd on the r (r + 1) / 2 pairs j <= i, C state^T and
    the state update (2 r N P each), at the tensor cores' bf16 peak (the
    fp32 peak for fp32 inputs)."""
    nbytes = itemsize * (2 * B * L * H * P + 2 * B * L * N) \
        + 4 * (B * L * H + B * H * P * N)
    ops = 0
    for t0 in range(0, L, K):
        r = min(K, L - t0)
        pairs = r * (r + 1) // 2
        ops += B * H * (2 * pairs * (N + P) + 4 * r * N * P)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / (BF16_OPS_PER_S if itemsize == 2 else FP32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ssd_case(args, chunk):
    """|kernel - plain|, the RMS of the plain output and the largest
    share of the bound (|kernel - plain| / (atol + rtol |plain|)), for y
    and the state, through the wrapper the path runs; checks both against
    their bounds and for finite values."""
    from repro_torch.kernels.ssd.ops import ssd_scan
    from repro_torch.kernels.ssd.ref import ssd_scan_ref

    y, s = ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    want_y, want_s = ssd_scan_ref(*args, chunk)
    y, want_y = y.float(), want_y.float()
    bf16 = args[0].dtype == torch.bfloat16
    rtol, atol = ((SSD_BF16_RTOL, SSD_BF16_ATOL) if bf16
                  else (SSD_RTOL, SSD_ATOL))
    out = {"y": (float((y - want_y).abs().max()),
                 float(want_y.pow(2).mean().sqrt()),
                 float(((y - want_y).abs() / (atol + rtol * want_y.abs()))
                       .max())),
           "state": (float((s - want_s).abs().max()),
                     float(want_s.pow(2).mean().sqrt()),
                     float(((s - want_s).abs()
                            / (SSD_ATOL + SSD_RTOL * want_s.abs())).max()))}
    L = args[0].shape[1]
    if L > 2048:
        tail = slice(L - ((L - 1) % chunk + 1), L)
        out["last"] = float((y[:, tail] - want_y[:, tail]).abs().max())
    shape = tuple(args[0].shape) + (args[2].shape[-1], chunk)
    check(bool(torch.isfinite(y).all() and torch.isfinite(s).all()),
          f"ssd_scan {shape} {args[0].dtype}: a value is not finite")
    check(torch.allclose(y, want_y, rtol=rtol, atol=atol),
          f"ssd_scan y disagrees with its plain version at {shape} "
          f"{args[0].dtype}: max err {out['y'][0]} (rtol {rtol}, atol {atol})")
    check(torch.allclose(s, want_s, rtol=SSD_RTOL, atol=SSD_ATOL),
          f"ssd_scan state disagrees with its plain version at {shape} "
          f"{args[0].dtype}: max err {out['state'][0]}")
    return out


def ssd_f64_case(args, chunk):
    """The kernel's and the plain version's max errors against a float64
    run of the plain version on the same inputs, for y and the state,
    beside the RMS of the float64 values; the kernel's must stay within
    SSD_F64_FACTOR times the plain version's, plus SSD_F64_FLOOR."""
    from repro_torch.kernels.ssd.ops import ssd_scan
    from repro_torch.kernels.ssd.ref import ssd_scan_ref

    got = ssd_scan(*args, chunk=chunk)
    plain = ssd_scan_ref(*args, chunk)
    exact = ssd_scan_ref(*(t.double() for t in args), chunk)
    torch.cuda.synchronize()
    shape = tuple(args[0].shape) + (args[2].shape[-1], chunk)
    out = {}
    for i, part in enumerate(("y", "state")):
        kern = float((got[i].double() - exact[i]).abs().max())
        ref = float((plain[i].double() - exact[i]).abs().max())
        out[part] = (kern, ref, float(exact[i].pow(2).mean().sqrt()))
        check(bool(torch.isfinite(got[i]).all()),
              f"ssd_scan {shape} {args[0].dtype}: {part} is not finite at "
              f"a mid-chunk clip")
        check(kern <= SSD_F64_FACTOR * ref + SSD_F64_FLOOR,
              f"ssd_scan {part} at a mid-chunk clip {shape} {args[0].dtype}:"
              f" {kern:.3e} from float64, past {SSD_F64_FACTOR} x the plain "
              f"version's {ref:.3e} + {SSD_F64_FLOOR}")
    return out


def check_ssd_shapes(shapes, seed0: int = 0):
    """The SSD scan against its plain version on the card at ``shapes``
    (B, L, H, P, N, chunk), through ``ops.ssd_scan``: at the three
    decays, in fp32 and bf16, each error printed beside the RMS of what
    it compares (and, past 2048 tokens, the last chunk's y error, after
    every earlier chunk's carried state); then at a mid-chunk clip,
    kernel and plain version each read against float64. Returns the
    largest |kernel - plain|, the largest share of the bound and the
    number of cases."""
    worst, share, n = 0.0, 0.0, 0
    for B, L, H, P, N, K in shapes:
        parts = []
        for kind in SSD_DRAWS:
            for dt in (torch.float32, torch.bfloat16):
                n += 1
                errs = ssd_case(ssd_inputs(B, L, H, P, N, kind, dt, K,
                                           seed=seed0 + n), K)
                worst = max(worst, errs["y"][0], errs["state"][0])
                share = max(share, errs["y"][2], errs["state"][2])
                last = (f", last chunk's y {errs['last']:.2e}"
                        if "last" in errs else "")
                parts.append(
                    f"{kind} {str(dt)[6:]} y {errs['y'][0]:.2e} (rms "
                    f"{errs['y'][1]:.2e}, {100 * errs['y'][2]:.1f} % of the "
                    f"bound{last}) state {errs['state'][0]:.2e} (rms "
                    f"{errs['state'][1]:.2e}, {100 * errs['state'][2]:.1f} "
                    f"%)")
        print(f"[check] ssd_scan {(B, L, H, P, N, K)} max |kernel - plain|: "
              + "; ".join(parts))
    # a clipped step mid-chunk, both sides read against float64 (see
    # SSD_F64_FACTOR)
    for B, L, H, P, N, K in shapes:
        parts = []
        for dt in (torch.float32, torch.bfloat16):
            errs = ssd_f64_case(ssd_inputs(B, L, H, P, N, "clip-mid", dt, K,
                                           seed=200 + L + len(parts)), K)
            parts.append(f"{str(dt)[6:]} " + " ".join(
                f"{part} {k:.2e} (plain {r:.2e}, rms {rms:.2e}; "
                f"{100 * k / (SSD_F64_FACTOR * r + SSD_F64_FLOOR):.1f} % of "
                f"the bound)" for part, (k, r, rms) in errs.items()))
        print(f"[check] ssd_scan {(B, L, H, P, N, K)} at a mid-chunk clip, "
              f"max |x - float64| of the kernel (and of the plain version): "
              + "; ".join(parts))
    return worst, share, n


def check_ssd() -> float:
    """Phase 9b: the SSD scan against its plain version on the card,
    through ``ops.ssd_scan`` (``check_ssd_shapes``): the JAX kernel
    tests' sweep (a ragged L included), the reduced Mamba2's shapes and
    the serving path's two; and rows of B = 1 launches bit for bit the
    rows of a B = 8 launch. Returns the largest |kernel - plain|."""
    from repro_torch.kernels.ssd.ops import ssd_scan

    worst, share, n = check_ssd_shapes(SSD_SWEEP + SSD_REDUCED + SSD_PATH)
    for L in (32, 160):                 # one ragged chunk; two chunks
        args = ssd_inputs(8, L, 32, 64, 128, "slow", torch.bfloat16, 128,
                          seed=100 + L)
        y, s = ssd_scan(*args, chunk=128)
        for b in range(8):
            one_y, one_s = ssd_scan(*(t[b:b + 1] for t in args), chunk=128)
            check(torch.equal(one_y[0], y[b]) and torch.equal(one_s[0], s[b]),
                  f"ssd_scan row {b} of a B=8 launch != its B=1 launch "
                  f"(L {L})")
    print(f"[check] ssd_scan vs plain over {n} cases (bounds: fp32 rtol "
          f"{SSD_RTOL} atol {SSD_ATOL}; bf16 y rtol {SSD_BF16_RTOL} atol "
          f"{SSD_BF16_ATOL}, state fp32): max |kernel - plain| {worst:.3e}, "
          f"at most {100 * share:.1f} % of the bound; "
          f"rows of B=1 launches == rows of a B=8 launch bitwise (y and "
          f"state, 8 x 32 and 8 x 160 x 32 x 64 x 128 bf16)")
    return worst


def time_ssd(launches: dict, tag: str, shapes=SSD_PATH):
    """Phase 13b: the SSD scan at every shape of a serving path
    (Mamba2-370M's, Zamba2-2.7B's), held against its plain version there
    through the wrapper in bf16 and on fp32 copies of the same inputs;
    then its device time
    (bf16) beside the plain version's and its bound (no single PyTorch
    call computes this scan). Returns rows by shape and the largest
    |kernel - plain|."""
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.kernels.ssd.ref import ssd_scan_ref

    rows, worst = {}, 0.0
    for shape in sorted(set(launches) | set(shapes)):
        B, L, H, P, N, K = shape
        xd, a, Bm, Cm = ssd_inputs(B, L, H, P, N, "sweep", torch.bfloat16,
                                   K, seed=B * 7 + L)
        errs = {dt: ssd_case((xd.to(dt), a, Bm.to(dt), Cm.to(dt)), K)
                for dt in (torch.bfloat16, torch.float32)}
        err = max(v[part][0] for v in errs.values()
                  for part in ("y", "state"))
        worst = max(worst, err)
        inner, reps = ((1, 3) if L > LONG_CONTEXT_FROM else (3, 5)
                       if L >= 1024 else (50, 21))
        bnd, by = ssd_bound(*shape)
        rows[shape] = {
            "ms": graph_ms(lambda: ssd_kernel.ssd_scan_cuda(xd, a, Bm, Cm, K),
                           inner, reps),
            "plain_ms": graph_ms(lambda: ssd_scan_ref(xd, a, Bm, Cm, K),
                                 inner, reps),
            "library_ms": None, "bound_ms": bnd, "bound_by": by,
            "max_abs_err": err}
        r = rows[shape]
        e16, e32 = errs[torch.bfloat16], errs[torch.float32]
        print(f"[time] {tag}: ssd_scan {shape} bf16: kernel "
              f"{r['ms'] * 1e3:.2f} us, plain {r['plain_ms'] * 1e3:.2f} us, "
              f"bound {r['bound_ms'] * 1e3:.3f} us ({by}) = "
              f"{100 * r['bound_ms'] / r['ms']:.2f} % of the kernel's time; "
              f"|kernel - plain| bf16 y {e16['y'][0]:.3e} (rms "
              f"{e16['y'][1]:.3e}), fp32 y {e32['y'][0]:.3e} (rms "
              f"{e32['y'][1]:.3e}), state {e16['state'][0]:.3e} / "
              f"{e32['state'][0]:.3e} (rms {e32['state'][1]:.3e}); "
              f"{launches.get(shape, 0)} launches on the main path")
    return rows, worst


def named_leaves(tree, name=None):
    """(key, tensor) for every leaf of a params nest, the key the leaf's
    own name in its dict."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in named_leaves(v, k)]
    return [(name, tree)]


def describe(cfg) -> str:
    ssm = (f"d_model {cfg.d_model}, d_inner {cfg.d_inner}, "
           f"{cfg.ssm_heads} SSD heads of {cfg.ssm_head_dim}, state "
           f"{cfg.ssm_state}, conv {cfg.ssm_conv}, chunk {cfg.ssm_chunk}")
    vocab = f"vocab {cfg.vocab} padded to {cfg.padded_vocab}"
    if cfg.family == "ssm":
        return f"{cfg.n_layers} layers, {ssm}, {vocab}"
    if cfg.family == "hybrid":
        return (f"{cfg.n_layers} Mamba2 layers, {ssm}; one shared attention "
                f"+ MLP block after every {cfg.attn_every}th layer: "
                f"{cfg.n_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff} "
                f"{cfg.activation}{'' if cfg.gated_mlp else ' ungated'}; "
                f"{vocab}; cfg.param_count() estimates "
                f"{cfg.param_count()}, counting the shared MLP as gated")
    heads = (f"{cfg.n_heads} heads" if cfg.n_kv_heads == cfg.n_heads else
             f"{cfg.n_heads} query heads over {cfg.n_kv_heads} KV "
             f"head{'s' if cfg.n_kv_heads > 1 else ''}")
    extras = [x for x, on in (("QKV bias", cfg.qkv_bias),
                              ("QK norm", cfg.qk_norm)) if on]
    if cfg.window is not None:
        extras.append(f"window {cfg.window}")
    ffn = (f"d_ff {cfg.d_ff} {cfg.activation}"
           f"{'' if cfg.gated_mlp else ' ungated'}")
    if cfg.n_experts:
        ffn = (f"{cfg.n_experts} experts of {ffn}, top-{cfg.top_k}, groups "
               f"of {cfg.moe_group_size} at capacity factor "
               f"{cfg.moe_capacity_factor}")
    if cfg.family == "audio":
        return (f"audio, {cfg.encoder_layers} encoder layers over "
                f"{cfg.n_frames} frames (learned positions, no mask) + "
                f"{cfg.n_layers} decoder layers (causal self-attention "
                f"with RoPE, then cross-attention), d_model {cfg.d_model}, "
                f"{heads} of {cfg.head_dim}, {cfg.norm}, {ffn}"
                f"{''.join(', ' + x for x in extras)}, {vocab}; "
                f"cfg.param_count() estimates {cfg.param_count()}")
    return (f"{cfg.family}, {cfg.n_layers} layers, d_model {cfg.d_model}, "
            f"{heads} of {cfg.head_dim}, {cfg.norm}, {ffn}"
            f"{''.join(', ' + x for x in extras)}, {vocab}; "
            f"cfg.param_count() estimates {cfg.param_count()}")


def path_kernels(cfg) -> dict:
    """Launches of each kernel per predict flush (and per prefill) of a
    zoo arch: flash attention once per attention (each dense or VLM
    layer; the hybrid's shared block once per stage; Whisper's encoder
    layers, and each decoder layer's self- and cross-attention), the SSD
    scan once per Mamba2 layer."""
    L = cfg.n_layers
    if cfg.family in ("dense", "vlm", "moe"):   # the VLM and MoE run the
        return {"flash_attention": L}           # dense path
    if cfg.family == "audio":
        return {"flash_attention": cfg.encoder_layers + 2 * L}
    if cfg.family == "ssm":
        return {"ssd_scan": L}
    check(cfg.family == "hybrid" and L % cfg.attn_every == 0,
          f"no kernel path for {cfg.name}")
    return {"ssd_scan": L, "flash_attention": L // cfg.attn_every}


def non_causal_launches(cfg) -> int:
    """Of ``path_kernels``' flash launches, those without the causal mask:
    Whisper's encoder and cross-attention."""
    return cfg.encoder_layers + cfg.n_layers if cfg.family == "audio" else 0


def step_kernels(cfg) -> dict:
    """Launches of each kernel per decode step: Whisper's cross-attention
    at one query, a flash launch a decoder layer; no other family's step
    launches a kernel of the port."""
    return {"flash_attention": cfg.n_layers} if cfg.family == "audio" \
        else {}


def cut_depth(cfg, n_layers: int):
    """``cfg`` cut to ``n_layers`` layers, an encoder's too."""
    import dataclasses

    over = {"encoder_layers": n_layers} if cfg.encoder_layers else {}
    return dataclasses.replace(cfg, n_layers=n_layers, **over)


def expected_window(cfg, seq_len: int):
    """The window the zoo's attention must take at ``seq_len``: the
    arch's own, else the long-context window past LONG_CONTEXT_FROM
    tokens for any family with attention."""
    if cfg.window is not None:
        return cfg.window
    return cfg.long_context_window if seq_len > LONG_CONTEXT_FROM else None


def flash_key(shape, window, causal: bool = True):
    """A flash row's key: the launch's (B, Sq, Skv, Hq, Hkv, D), with the
    window appended when there is one and ``NON_CAUSAL`` when the launch
    has no causal mask (the launch counter's key, ``launch_key``, with
    the window)."""
    from repro_torch.kernels.attention.kernel import NON_CAUSAL

    return tuple(shape) + ((window,) if window is not None else ()) \
        + (() if causal else (NON_CAUSAL,))


def flash_row(key):
    """(shape, window, causal) of a flash row's key."""
    from repro_torch.kernels.attention.kernel import NON_CAUSAL

    rest = key[6:]
    window = next((x for x in rest if x != NON_CAUSAL), None)
    return tuple(key[:6]), window, NON_CAUSAL not in rest


def flash_keys(windows) -> dict:
    """``flash_windows``' record counted by ``flash_key``."""
    out: dict = {}
    for shape, window, causal in windows:
        key = flash_key(shape, window, causal)
        out[key] = out.get(key, 0) + 1
    return out


def zoo_serve_main_path(arch: str, tag: str, bursts=ZOO_BURSTS, cfg=None):
    """Phase 10, a zoo serving path: ``arch`` (Qwen1.5-4B, Mamba2-370M,
    then Zamba2-2.7B) at full width and depth (bf16, but for the leaves
    the JAX init keeps in fp32; random weights from seed 0), or ``cfg``,
    the arch's config cut in depth (the MoE family: drawn and calibrated
    here as ``build_zoo_forecaster`` does, which takes no config), behind
    ``ServingEngine``, one burst of (requests, prompt length,
    max_batch) after another: 64 requests of 32 tokens (max_batch 8),
    then 8 of 2048 (max_batch 4), then for Zamba2 one of 133,120
    (Whisper-medium: ``bursts`` AUDIO_BURSTS, on the stub frames).
    Launch counts are zeroed just before each burst and read just after;
    each kernel of the arch's path (``path_kernels``) must run its
    number of launches per predict flush, with the window the sequence
    length asks for (``expected_window``) and ``non_causal_launches``
    of them without the causal mask, no other kernel at all, and no
    plain version on a card tensor. Returns the forecaster, each
    kernel's launches by row key (``flash_key`` for flash), and the
    init's seconds."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_token_batch
    from repro_torch.models.transformer import init_lm
    from repro_torch.serving import (BatcherConfig, ModelRegistry,
                                     ServingEngine, ZooForecaster,
                                     build_zoo_forecaster)

    want_cfg = get_config(arch) if cfg is None else cfg
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if cfg is None:
        fc = build_zoo_forecaster(arch, seed=0, reduced=False, device="cuda")
    else:
        fc = ZooForecaster(cfg=cfg, params=init_lm(cfg, torch.Generator(
            device="cuda").manual_seed(0)), device="cuda")
        fc.calibrate(synthetic_token_batch(8, fc.window, cfg.vocab, seed=0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = fc.cfg
    per_flush = path_kernels(cfg)
    leaves = named_leaves(fc.params)
    n_params = sum(t.numel() for _, t in leaves)
    like = named_leaves(init_lm(cfg, None))      # the init's dtypes
    fp32 = sorted({k for k, t in like if t.dtype == torch.float32})
    want_fp32 = {"ssm": {"dt_bias", "A_log"}, "hybrid": {"dt_bias", "A_log"},
                 "moe": {"router"}}.get(cfg.family, set())
    check(cfg == want_cfg and cfg.dtype == "bfloat16"
          and [(k, t.shape, t.dtype) for k, t in leaves]
          == [(k, t.shape, t.dtype) for k, t in like]
          and all(t.is_cuda for _, t in leaves)
          and set(fp32) == want_fp32,
          f"{arch} is not served at full width in bf16 on the card")
    print(f"[zoo] {arch}: {n_params} parameters ({describe(cfg)}, bf16"
          f"{'; ' + ', '.join(fp32) + ' fp32' if fp32 else ''}) drawn "
          f"on the card and calibrated in {init_s:.2f} s; device memory "
          f"allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    registry = ModelRegistry()
    registry.register(arch, fc)
    launches: dict = {k: {} for k in per_flush}
    for i, (n_req, plen, max_batch) in enumerate(bursts):
        toks = synthetic_token_batch(n_req, plen, cfg.vocab, seed=i)
        with ServingEngine(registry, BatcherConfig(
                max_batch=max_batch, max_wait_ms=2.0,
                length_buckets=(plen,))) as engine:
            t0 = time.perf_counter()
            n_warm = engine.warmup(arch, lengths=(plen,))
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            engine.telemetry.reset_clock()
            torch.cuda.reset_peak_memory_stats()
            reset_counters()
            with no_plain_version_on_the_card() as plain_calls, \
                    flash_windows() as windows:
                t0 = time.perf_counter()
                futs = [engine.submit(arch, t, client_id=f"client-{j}")
                        for j, t in enumerate(toks)]
                results = [f.result(timeout=600.0) for f in futs]
                wall = time.perf_counter() - t0
            got = read_counters()
            snap = engine.telemetry.snapshot()
        flushes = snap["batches"]
        n_kern = {k: sum(got[k].values()) for k in per_flush}
        res = np.asarray(results, np.float64)
        check(not plain_calls, f"plain versions ran on the card: "
                               f"{plain_calls}")
        check(snap["requests"] == n_req and res.shape == (n_req, 2),
              f"burst {i}: {snap['requests']} of {n_req} requests served")
        for k, n in per_flush.items():
            check(n_kern[k] == n * flushes,
                  f"burst {i}: {n_kern[k]} {k} launches for {flushes} "
                  f"predict flushes, {n} a flush expected")
        check(all(n == 0 for k, v in got.items() if k not in per_flush
                  for n in v.values()), f"other kernels launched: {got}")
        by_window = flash_keys(windows)
        check(all(w == expected_window(cfg, shape[1])
                  for shape, w, _ in windows)
              and len(windows) == n_kern.get("flash_attention", 0)
              and sum(not c for *_, c in windows)
              == non_causal_launches(cfg) * flushes,
              f"burst {i}: flash launches {by_window}, not with the "
              f"window and the masks that {plen} tokens ask for")
        if "flash_attention" in per_flush:
            got["flash_attention"] = by_window
        check(np.all(np.isfinite(res)) and np.all(res[:, 0] == np.round(
            res[:, 0])) and np.all((res[:, 0] >= 0) & (res[:, 0] < cfg.vocab))
              and np.all((res[:, 1] >= 0) & (res[:, 1] <= 1)),
              f"burst {i}: a reply is not a token and a probability")
        peak = torch.cuda.max_memory_allocated() / 2**30
        same = "not compared (partial flushes)"
        if flushes * max_batch == n_req:
            # every flush was full: flush j served requests [j*mb, (j+1)*mb)
            direct = np.concatenate([np.stack(fc.predict(
                toks[j:j + max_batch]), 1) for j in range(0, n_req,
                                                          max_batch)])
            check(np.array_equal(direct[:, 0], res[:, 0])
                  and np.allclose(direct[:, 1], res[:, 1], atol=1e-6),
                  f"burst {i}: served replies != predict of the same "
                  f"batches")
            bits = np.array_equal(direct, res)
            same = (f"== predict of the same batches (tokens equal, p "
                    f"{'bitwise' if bits else 'within 1e-6'})")
        for k in per_flush:
            for shape, n in got[k].items():
                launches[k][shape] = launches[k].get(shape, 0) + n
        kern = ", ".join(f"{n_kern[k]} {k} launches = "
                         f"{n_kern[k] / flushes:.1f} per flush by shape "
                         f"{got[k]}" for k in per_flush)
        print(f"[zoo] {tag}: {arch} burst {i}: {n_req} requests of {plen} "
              f"tokens "
              f"(max_batch {max_batch}) in {wall * 1e3:.1f} ms: "
              f"{snap['throughput_rps']:.2f} req/s, {n_req * plen / wall:.0f} "
              f"prompt tokens/s, p50 {snap['p50_ms']:.1f} ms, p95 "
              f"{snap['p95_ms']:.1f} ms; {flushes} predict flushes, "
              f"{kern}; "
              f"replies {same}; no plain version on the card; warmup "
              f"({n_warm} shapes) {warm_s:.2f} s; distinct tokens "
              f"{len(set(res[:, 0]))}, p in [{res[:, 1].min():.4f}, "
              f"{res[:, 1].max():.4f}]; device memory peak {peak:.2f} GiB")
    return fc, launches, init_s


@contextlib.contextmanager
def stub_frames_as(frames):
    """Serve an audio arch on ``frames`` (moved to the forecaster's
    device) in place of its stub draw; nothing with ``frames`` None."""
    from repro_torch.serving import forecaster as fmod

    draw = fmod.stub_frames
    if frames is not None:
        fmod.stub_frames = lambda cfg, batch, device: frames.to(device)
    try:
        yield
    finally:
        fmod.stub_frames = draw


def zoo_card_vs_cpu(arch: str, tag: str, noise=None, n_layers=2) -> float:
    """Phase 11: ``arch`` at full width, ``n_layers`` layers (Zamba2: one
    stage; Whisper: as many encoder layers too, over its 1500 frames),
    fp32: the same weights served on the card and by the port on the
    CPU give the same greedy tokens and logits within the stated
    tolerance, over 8 windows of 32 tokens, and the card's forward
    launches each of the path's kernels (their fp32 versions). ``noise``
    (leaf name -> scale) adds seeded noise on the card to the leaves the
    init sets to constants first. An audio arch reads the card's stub
    frames on both sides. Returns the largest |logit difference|."""
    import dataclasses

    from repro_torch.checkpoint.convert import params_to
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_token_batch
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serving import ZooForecaster
    from repro_torch.serving.forecaster import stub_frames

    cfg = dataclasses.replace(cut_depth(get_config(arch), n_layers),
                              dtype="float32")
    model = build_model(cfg)
    g = torch.Generator(device="cuda").manual_seed(1)
    params = model.init(g)
    for name, t in named_leaves(params):
        if noise and name in noise:
            t.add_(noise[name] * torch.randn(t.shape, generator=g,
                                             device="cuda"))
    cpu_params = params_to(params, "cpu")
    toks = synthetic_token_batch(8, 32, cfg.vocab, seed=3)
    frames = stub_frames(cfg, len(toks), "cuda") \
        if cfg.family == "audio" else None
    tok_g, _ = ZooForecaster(cfg=cfg, params=params, device="cuda").predict(
        toks)
    with stub_frames_as(frames):
        tok_c, _ = ZooForecaster(cfg=cfg, params=cpu_params,
                                 device="cpu").predict(toks)
    reset_counters()
    logits_g, aux_g = model.forward(params, torch.as_tensor(
        toks, dtype=torch.long, device="cuda"), frames)
    logits_g, aux_g = logits_g.cpu(), aux_g.cpu()
    got = read_counters()
    logits_c, aux_c = model.forward(cpu_params, torch.as_tensor(
        toks, dtype=torch.long), None if frames is None else frames.cpu())
    err = float((logits_g - logits_c).abs().max())
    check(np.array_equal(tok_g, tok_c),
          f"greedy tokens on the card {tok_g} != on the CPU {tok_c}")
    check(torch.allclose(logits_g, logits_c, rtol=ZOO_CPU_RTOL,
                         atol=ZOO_CPU_ATOL),
          f"logits on the card vs the CPU: max |diff| {err}")
    aux = ""
    if cfg.n_experts:
        # the MoE load-balance loss, summed over the layers
        aux_err = float((aux_g - aux_c).abs())
        check(aux_g.dtype == torch.float32 and torch.allclose(
            aux_g, aux_c, rtol=ZOO_CPU_RTOL, atol=ZOO_CPU_ATOL),
              f"the MoE aux on the card {float(aux_g)} vs the CPU "
              f"{float(aux_c)}")
        aux = (f"; MoE aux card {float(aux_g):.6f}, CPU {float(aux_c):.6f}, "
               f"|diff| {aux_err:.3e}")
    kernels = path_kernels(cfg)
    check(all(sum(got[k].values()) > 0 for k in kernels),
          f"the fp32 forward on the card did not launch {list(kernels)}: "
          f"{got}")
    print(f"[zoo] {tag}: {arch} full width, {n_layers} layers, fp32, same "
          f"weights "
          f"{'(noised: ' + ', '.join(noise) + ') ' if noise else ''}"
          f"on the card and the CPU port, 8 windows of 32 tokens: greedy "
          f"tokens equal {tok_g.astype(int).tolist()}; logits max |diff| "
          f"{err:.3e} (max |logit| {float(logits_c.abs().max()):.2f}; rtol "
          f"{ZOO_CPU_RTOL}, atol {ZOO_CPU_ATOL}){aux}; the card's forward "
          f"launched " + ", ".join(f"{k} {got[k]}" for k in kernels))
    return err


def zoo_cli(arch: str, kernels, full: bool = True) -> None:
    """Phase 12: the serve CLI with a full-width zoo arch on the card
    (``--no-reduced``), or with the CLI's reduced default where the full
    model does not fit one card, through each of its kernels."""
    from repro_torch.launch import serve

    size = ["--no-reduced"] if full else []
    reset_counters()
    out = serve.main(["--model", arch, *size, "--requests", "16",
                      "--max-batch", "8", "--device", "cuda"])
    n = {k: counters()[k].total for k in kernels}
    flags = " ".join(["--model", arch, *size])
    check(out["traffic"]["requests"] == 16 and all(n.values()),
          f"python -m repro_torch.launch.serve {flags} did not serve every "
          f"request through {kernels} ({n} launches)")
    print(f"[cli] repro_torch.launch.serve {flags} --requests 16 "
          f"--max-batch 8 --device cuda: ok, "
          + ", ".join(f"{v} {k}" for k, v in n.items()) + " launches")


def windowed_plain(q, k, v, window: int, rows: int = FLASH_SLICE):
    """Causal attention with a sliding window by its plain version, one
    block of ``rows`` queries at a time over the keys that block's
    window reaches: the whole function, without the [Sq, Skv] scores
    that one call of the plain version would hold."""
    from repro_torch.kernels.attention.ref import attention_ref

    outs = []
    for s0 in range(0, q.shape[1], rows):
        k0 = max(0, s0 - window + 1)
        outs.append(attention_ref(
            q[:, s0:s0 + rows], k[:, k0:s0 + rows], v[:, k0:s0 + rows],
            causal=True, window=window, q_offset=s0 - k0))
    return torch.cat(outs, 1)


def time_flash_windowed(shape, n_launches: int, tag: str):
    """Phase 13, a windowed launch (B, S, S, Hq, Hkv, D, window) as the
    path runs it, through the wrapper, in bf16 and on fp32 copies of the
    same inputs. Its rows are held on FLASH_SLICE query rows at the end
    and in the middle: against the plain version over the keys their
    window reaches (from one key before it, a key-tile boundary, so that
    the kernel walks the same tiles), and bit for bit against the
    kernel's launch on just those rows and keys (``q_offset`` relative
    to the slice). Then the bf16 launch's device time beside the plain
    version's over the whole sequence (``windowed_plain``) and its
    bound; no PyTorch call takes a window (``scaled_dot_product_attention``
    would need a [S, S] mask). Returns the row and the largest |kernel -
    plain|."""
    from repro_torch.kernels.attention import kernel as attn_kernel
    from repro_torch.kernels.attention.ops import flash_attention
    from repro_torch.kernels.attention.ref import attention_ref

    B, Sq, Skv, Hq, Hkv, D, w = shape
    q, k, v = attn_inputs(B, Sq, Skv, Hq, Hkv, D, torch.bfloat16,
                          seed=B * 7 + Sq)
    starts = (Sq - FLASH_SLICE, Sq // 2 // 128 * 128)
    check(all(s0 % 128 == 0 and s0 >= w for s0 in starts) and w % 128 == 0,
          f"the slices {starts} of {shape} do not start on key tiles")
    errs = {}
    for dt, rtol, atol in ((torch.bfloat16, FLASH_BF16_RTOL,
                            FLASH_BF16_ATOL),
                           (torch.float32, FLASH_RTOL, FLASH_ATOL)):
        a, b, c = (t.to(dt) for t in (q, k, v))
        full = flash_attention(a, b, c, causal=True, window=w)
        errs[dt] = 0.0
        for s0 in starts:
            rows, keys = slice(s0, s0 + FLASH_SLICE), slice(s0 - w,
                                                            s0 + FLASH_SLICE)
            got = full[:, rows]
            want = attention_ref(a[:, rows], b[:, keys], c[:, keys],
                                 causal=True, window=w, q_offset=w).float()
            err = float((got.float() - want).abs().max())
            errs[dt] = max(errs[dt], err)
            check(torch.allclose(got.float(), want, rtol=rtol, atol=atol),
                  f"flash attention disagrees with its plain version at "
                  f"{shape} on rows {s0}.. in {dt}: max err {err} (rtol "
                  f"{rtol}, atol {atol})")
            part = flash_attention(a[:, rows], b[:, keys], c[:, keys],
                                   causal=True, window=w, q_offset=w)
            check(torch.equal(part, got),
                  f"flash attention at {shape} in {dt}: rows {s0}.. of the "
                  f"full launch != the launch on their slice")
        del a, b, c, full
    err = max(errs.values())
    bnd, by = flash_bound(*shape)
    row = {"ms": graph_ms(lambda: attn_kernel.flash_attention_cuda(
               q, k, v, True, w, 0, Skv), 3, 5),
           "plain_ms": graph_ms(lambda: windowed_plain(q, k, v, w), 1, 3),
           "library_ms": None, "bound_ms": bnd, "bound_by": by,
           "max_abs_err": err}
    lib = "no library call (SDPA would need a [S, S] mask of " \
        f"{Sq * Skv / 1e9:.1f} GB)"
    if Sq * Skv <= SDPA_MASK_MAX:
        row["library_ms"], lib = sdpa_windowed(q, k, v, w, starts)
    tflops = flash_ops(*shape) / (row["ms"] * 1e-3) / 1e12
    print(f"[time] {tag}: flash_attention {shape[:6]} bf16 causal, window "
          f"{w}: kernel {row['ms'] * 1e3:.2f} us = {tflops:.1f} TFLOP/s "
          f"(the bound's operations, the window's pairs only, over its "
          f"time), plain by blocks of {FLASH_SLICE} queries "
          f"{row['plain_ms'] * 1e3:.2f} us, bound {bnd * 1e3:.3f} us ({by}) = "
          f"{100 * bnd / row['ms']:.2f} % of the kernel's time; {lib}; rows "
          f"{starts[0]}.. and {starts[1]}.. (x {FLASH_SLICE}): |kernel - "
          f"plain| bf16 {errs[torch.bfloat16]:.3e} (rtol {FLASH_BF16_RTOL}, "
          f"atol {FLASH_BF16_ATOL}), fp32 {errs[torch.float32]:.3e} (rtol "
          f"{FLASH_RTOL}, atol {FLASH_ATOL}), == the launch on the slice "
          f"bitwise; {n_launches} launches on the main path")
    return row, err


def sdpa_windowed(q, k, v, window: int, starts):
    """``scaled_dot_product_attention`` at a windowed causal launch, with
    the window as an explicit boolean [Sq, Skv] mask, on the
    memory-efficient backend (the one that takes a mask; the math
    backend would hold every score), over k and v repeated to Hq heads
    before the timed call: that backend refuses ``enable_gqa`` ("No
    available kernel", torch 2.11 on an H100). Held against the plain
    version on FLASH_SLICE query rows from each of ``starts``. Returns
    its device time (ms) and what it ran."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.attention.ref import attention_ref

    Sq, Skv, Hq, Hkv = q.shape[1], k.shape[1], q.shape[2], k.shape[2]
    pos = torch.arange(Sq, device="cuda")[:, None]
    key = torch.arange(Skv, device="cuda")[None, :]
    mask = (key <= pos) & (key > pos - window)
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (t.transpose(1, 2).repeat_interleave(Hq // Hkv, 1).contiguous()
              for t in (k, v))

    def call():
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

    out = call().transpose(1, 2)
    lib_err = 0.0
    for s0 in starts:
        rows, keys = slice(s0, s0 + FLASH_SLICE), slice(s0 - window,
                                                        s0 + FLASH_SLICE)
        want = attention_ref(q[:, rows], k[:, keys], v[:, keys], causal=True,
                             window=window, q_offset=window).float()
        lib_err = max(lib_err, float((out[:, rows].float() - want).abs()
                                     .max()))
    check(lib_err <= LIBRARY_BF16_TOL,
          f"scaled_dot_product_attention with a window mask is not the "
          f"same function: max err {lib_err}")
    del out
    ms = graph_ms(call, 3, 5)
    return ms, (f"scaled_dot_product_attention with a [{Sq} x {Skv}] bool "
                f"mask ({Sq * Skv / 1e6:.0f} MB), memory-efficient backend, "
                f"k and v repeated to {Hq} heads: {ms * 1e3:.2f} us, |sdpa - "
                f"plain| {lib_err:.3e} on the slices")


def time_flash(launches: dict, tag: str, shapes=((8, 32, 32, 20, 20, 128),
                                                (4, 2048, 2048, 20, 20, 128))):
    """Phase 13: flash attention at every row key of a zoo path, under
    the mask the key names (causal, or none for a ``NON_CAUSAL`` key; a
    key with a window shorter than its keys goes to
    ``time_flash_windowed``), held against its plain version there
    through the wrapper the path runs, in bf16 and on fp32 copies of the
    same inputs; then its device time (bf16) beside the plain
    version's, one ``scaled_dot_product_attention`` call's under the
    same mask (never called by the port; ``enable_gqa`` where Hkv < Hq)
    and its bound. Returns rows by key and the largest |kernel -
    plain|."""
    import torch.nn.functional as F

    from repro_torch.kernels.attention import kernel as attn_kernel
    from repro_torch.kernels.attention.ops import flash_attention
    from repro_torch.kernels.attention.ref import attention_ref

    rows, worst = {}, 0.0
    for key in sorted(set(launches) | set(shapes), key=str):
        shape, w, causal = flash_row(key)
        if w is not None and w < shape[2]:
            rows[key], err = time_flash_windowed(
                key, launches.get(key, 0), tag)
            worst = max(worst, err)
            continue
        # a window that reaches every key (Mixtral's 4096 at a shorter
        # prompt) is causal attention: timed so, launched with it
        B, Sq, Skv, Hq, Hkv, D = shape
        q, k, v = attn_inputs(B, Sq, Skv, Hq, Hkv, D, torch.bfloat16,
                              seed=B * 7 + Sq)
        errs = {}
        for dt, rtol, atol in ((torch.bfloat16, FLASH_BF16_RTOL,
                                FLASH_BF16_ATOL),
                               (torch.float32, FLASH_RTOL, FLASH_ATOL)):
            a, b, c = (t.to(dt) for t in (q, k, v))
            got = flash_attention(a, b, c, causal=causal, window=w).float()
            want = attention_ref(a, b, c, causal=causal,
                                 window=w).float()
            errs[dt] = float((got - want).abs().max())
            check(torch.allclose(got, want, rtol=rtol, atol=atol),
                  f"flash attention disagrees with its plain version at the "
                  f"path's {key} in {dt}: max err {errs[dt]} (rtol "
                  f"{rtol}, atol {atol})")
            if dt == torch.bfloat16:
                want_bf16 = want
            del a, b, c, got, want
        err = max(errs.values())
        worst = max(worst, err)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        gqa = Hq != Hkv
        lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                             enable_gqa=gqa)
        lib_err = float((lib.transpose(1, 2).float() - want_bf16).abs().max())
        check(lib_err <= LIBRARY_BF16_TOL,
              f"scaled_dot_product_attention is not the same function at "
              f"{key}: max err {lib_err}")
        del lib, want_bf16
        big = Sq >= 1024
        inner, reps = (3, 5) if big else (50, 21)
        bnd, by = flash_bound(*shape, w, causal)
        rows[key] = {
            "ms": graph_ms(lambda: attn_kernel.flash_attention_cuda(
                q, k, v, causal, w, 0, Skv), inner, reps),
            "plain_ms": graph_ms(lambda: attention_ref(
                q, k, v, causal=causal, window=w), inner, reps),
            "library_ms": graph_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=gqa), inner,
                reps),
            "bound_ms": bnd, "bound_by": by, "max_abs_err": err}
        r = rows[key]
        tflops = flash_ops(*shape, w, causal) / (r["ms"] * 1e-3) / 1e12
        print(f"[time] {tag}: flash_attention {shape} bf16 "
              f"{'causal' if causal else 'non-causal'}"
              f"{f' (window {w}, every key)' if w else ''}: kernel "
              f"{r['ms'] * 1e3:.2f} us = {tflops:.1f} TFLOP/s (the bound's "
              f"operations over its time), plain "
              f"{r['plain_ms'] * 1e3:.2f} us, "
              f"scaled_dot_product_attention {r['library_ms'] * 1e3:.2f} us, "
              f"bound {r['bound_ms'] * 1e3:.3f} us ({by}) = "
              f"{100 * r['bound_ms'] / r['ms']:.2f} % of the kernel's time; "
              f"|kernel - plain| bf16 {errs[torch.bfloat16]:.3e} (rtol "
              f"{FLASH_BF16_RTOL}, atol {FLASH_BF16_ATOL}), fp32 "
              f"{errs[torch.float32]:.3e} (rtol {FLASH_RTOL}, atol "
              f"{FLASH_ATOL}); |sdpa - plain| bf16 {lib_err:.3e}; "
              f"{launches.get(key, 0)} "
              f"launches on the main path")
    return rows, worst


# the serving paths' flash shapes that ``--flash-serve`` re-times: the
# short and long prompts at D 128 (Qwen1.5-4B) and D 80 (Zamba2)
FLASH_SERVE_SHAPES = [(8, 32, 32, 20, 20, 128), (4, 2048, 2048, 20, 20, 128),
                      (8, 32, 32, 32, 32, 80), (4, 2048, 2048, 32, 32, 80)]


def flash_serve(tag: str) -> None:
    """``--flash-serve``: the bf16 flash forward as serving launches it
    (causal, no logsumexp) at FLASH_SERVE_SHAPES: device us a launch
    (``graph_ms``) and a digest of the output's bytes on seeded inputs.
    Uses only the binding every version of the package has, so that a
    copy of this script in an earlier ``git archive`` checkout times
    that one's kernel in the same call (turns: earlier, this, this,
    earlier), and equal digests show the same output bits. Prints one
    JSON line."""
    from repro_torch.kernels.attention import kernel as attn_kernel

    out = {}
    for shape in FLASH_SERVE_SHAPES:
        B, Sq, Skv, Hq, Hkv, D = shape
        q, k, v = attn_inputs(*shape, torch.bfloat16, seed=B * 7 + Sq)
        o = attn_kernel.flash_attention_cuda(q, k, v, True, None, 0, Skv)
        torch.cuda.synchronize()
        digest = hashlib.sha256(o.view(torch.int16).cpu().numpy()
                                .tobytes()).hexdigest()[:16]
        inner, reps = (10, 11) if Sq >= 1024 else (50, 21)
        us = 1e3 * graph_ms(lambda: attn_kernel.flash_attention_cuda(
            q, k, v, True, None, 0, Skv), inner, reps)
        out["x".join(map(str, shape))] = {"us": us, "digest": digest}
    print(json.dumps({"flash_serve": tag, "root": str(ROOT), "shapes": out}))


def flash_host(tag: str, shape=(8, 32, 32, 20, 20, 128), n=500, reps=15):
    """Host microseconds per eager flash call at the short prompt's
    shape (bf16, causal): through the wrapper the path calls (checks,
    route, binding) and through the binding alone. Read on the host's
    clock over ``n`` calls with no sync between them, fewer than the
    launch queue holds, so that the kernels cannot hold the host back;
    ``reps`` such runs, the wrapper's and the binding's in turns, give
    the least (the call's own cost: other work on the shared host only
    adds) and the median. Uses only what the package had before its
    bf16 kernel ran on the tensor cores, so that it also times an
    earlier checkout (``--flash-host``)."""
    from repro_torch.kernels.attention import kernel as attn_kernel
    from repro_torch.kernels.attention.ops import flash_attention

    B, Sq, Skv, Hq, Hkv, D = shape
    q, k, v = attn_inputs(*shape, torch.bfloat16, seed=B * 7 + Sq)
    calls = {"wrapper": lambda: flash_attention(q, k, v, causal=True),
             "binding": lambda: attn_kernel.flash_attention_cuda(
                 q, k, v, True, None, 0, Skv)}
    times: dict = {name: [] for name in calls}
    for _ in range(reps):
        for name, fn in calls.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            times[name].append((time.perf_counter() - t0) / n * 1e6)
            torch.cuda.synchronize()
    us = {name: (min(ts), statistics.median(ts))
          for name, ts in times.items()}
    print(f"[host] {tag}: flash_attention {shape} bf16 causal, us of host "
          f"time per call, least / median of {reps} x {n} calls: wrapper "
          f"{us['wrapper'][0]:.2f} / {us['wrapper'][1]:.2f}, binding "
          f"{us['binding'][0]:.2f} / {us['binding'][1]:.2f}")
    return us


def ablation_entries(library: str, sources, ablations: dict, entry: str,
                     argtypes) -> dict:
    """The C entry point ``entry`` of the library and of a copy of it per
    ablation, by name ("kernel" for the library itself): each copy is
    the library's sources with the last one (the kernel's) edited by the
    ablation's text substitutions, each of which must apply exactly once.
    All are built from the checkout at once and bound here with
    ``argtypes``, outside the package."""
    import ctypes

    from repro_torch.kernels import build

    out_dir = build.BUILD_ROOT / f"{library}_ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = sources[-1].read_text()
    libs = {"kernel": (library, list(sources))}
    for name, subs in ablations.items():
        src = text
        for old, new in subs:
            check(src.count(old) == 1,
                  f"ablation {name!r} does not apply once: {old!r}")
            src = src.replace(old, new)
        tag = f"{library}_ablation_" + name.replace(" ", "_")
        path = out_dir / f"{tag}.cu"
        path.write_text(src)
        libs[name] = (tag, list(sources[:-1]) + [path])
    build.build_all(dict(libs.values()))
    fns = {}
    for name, (tag, srcs) in libs.items():
        fn = getattr(build.load(tag, srcs), entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


# what bounds the bf16 flash kernel (``--flash-ablation``): copies of
# flash_attention_wgmma.cu with one step taken out, as text
# substitutions, each of which must apply exactly once. An ablated
# kernel computes a wrong result by design: it is timed, never checked
# or used.
FLASH_ABLATIONS = {
    # P.V from P_hi alone: 4 products per (query, key, dim), not 6
    "no P_lo": [("""    wgmma_rs_t(o, &lo[4 * kk], dv, 1);
""", "")],
    # the scores go to P.V as they are: no mask, max, exp, sums or rescale
    "no softmax": [("""                                               int wg_first) {
""", """                                               int wg_first) {
  if (k0 >= 0) return make_float2(1.0f, 1.0f);
""")],
    # the two consumers issue their products without handing the tensor
    # cores to each other
    "no turns": [
        ('asm volatile("bar.sync %0, 256;" :: "r"(1 + wg) : "memory");',
         "(void)wg;"),
        ('asm volatile("bar.arrive %0, 256;" :: "r"(2 - wg) : "memory");',
         "(void)wg;")],
}


def flash_ablation(card: str) -> None:
    """``--flash-ablation``: the bf16 flash kernel's device time beside
    each ablation's (``FLASH_ABLATIONS``) and
    ``scaled_dot_product_attention``'s, at the serving path's shapes
    (Qwen1.5-4B: 4 x 2048 and 8 x 32, 20 heads of 128, causal) and at 6 x
    32, where the 120 blocks take one round of the SMs. Each library is
    built from the checkout and called through a binding of its own,
    outside the package; timed with ``graph_ms`` in turns (the kernel,
    the ablations, then the same reversed). Prints one line per shape and
    a JSON object of every time (us)."""
    import ctypes

    import torch.nn.functional as F

    from repro_torch.kernels.attention import kernel as attn_kernel

    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fns = ablation_entries(
        "flash_attention", attn_kernel.SOURCES, FLASH_ABLATIONS,
        "flash_attention_forward",
        [P] * 5 + [L] * 12 + [I] * 11 + [ctypes.c_float, P])

    def launch(fn, q, k, v, out):
        B, S, H, D = q.shape
        strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None, *strides, B, S, S, H, H, D, 1, 1, 0, 0, S, D ** -0.5,
                torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"flash ablation launch failed: {rc}")

    order = list(fns) + list(fns)[::-1]
    times: dict = {}
    for B, S in ((4, 2048), (8, 32), (6, 32)):
        shape = (B, S, S, 20, 20, 128)
        q, k, v = attn_inputs(*shape, torch.bfloat16, seed=B * 7 + S)
        out = torch.empty_like(q)
        inner, reps = (10, 11) if S >= 1024 else (50, 21)
        row: dict = {n: [] for n in fns}
        for n in order:
            row[n].append(1e3 * graph_ms(
                lambda: launch(fns[n], q, k, v, out), inner, reps))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        row["sdpa"] = [1e3 * graph_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=True),
            inner, reps)]
        times["x".join(map(str, shape))] = row
        print(f"[ablation] {card}: {shape} bf16 causal, bound "
              f"{1e3 * flash_bound(*shape)[0]:.3f} us: " + "; ".join(
                  f"{n} {' / '.join(f'{t:.2f}' for t in ts)} us"
                  for n, ts in row.items()))
    print(json.dumps({"card": card, "us": times}))


# what bounds the bf16 SSD kernel (``--ssd-ablation``): copies of
# ssd_scan_wgmma.cu with one step taken out or cut down, as text
# substitutions, each of which must apply exactly once. An ablated kernel
# computes a wrong result by design: it is timed, never checked or used.
SSD_ABLATIONS = {
    # M = S o L without the exp: S's mask alone
    "no exp in M": [("sc[j] * fast_exp(ci - cj.x)", "sc[j]"),
                    ("sc[j + 1] * fast_exp(ci - cj.y)", "sc[j + 1]")],
    # the exp of M by expf, as the producer's, not the MUFU unit's
    "expf in M": [("sc[j] * fast_exp(ci - cj.x)", "sc[j] * expf(ci - cj.x)"),
                  ("sc[j + 1] * fast_exp(ci - cj.y)",
                   "sc[j + 1] * expf(ci - cj.y)")],
    # B o decay in two bf16 pieces, not three
    "two pieces of B o decay": [("constexpr int BD_PIECES = 3;",
                                 "constexpr int BD_PIECES = 2;")],
    # one bf16 piece of each fp32 operand: 40 products a chunk and
    # consumer, not 72 (in units of 64 x 64 x 16)
    "one piece each": [("constexpr int M_PIECES = 2;",
                        "constexpr int M_PIECES = 1;"),
                       ("constexpr int ST_PIECES = 2;",
                        "constexpr int ST_PIECES = 1;"),
                       ("constexpr int BD_PIECES = 3;",
                        "constexpr int BD_PIECES = 1;")],
    # the state update's operands are formed, its products not issued
    "no dS products": [
        ("wgmma_rs_t(ds, &bd[q][4 * kk],",
         "if (kk < 0) wgmma_rs_t(ds, &bd[q][4 * kk],")],
}


def ssd_ablation(card: str) -> None:
    """``--ssd-ablation``: the bf16 SSD kernel's device time beside each
    ablation's (``SSD_ABLATIONS``) at the serving path's shapes
    (Mamba2-370M: 4 x 2048 and 8 x 32, 32 heads of 64, state 128, chunk
    128) and at 4 x 32, whose 128 blocks take one round of the 132 SMs.
    Each library is built from the checkout and called through a binding
    of its own, outside the package; timed with ``graph_ms`` in turns
    (the kernel, the ablations, then the same reversed). Prints one line
    per shape and a JSON object of every time (us)."""
    import ctypes

    from repro_torch.kernels.ssd import kernel as ssd_kernel

    P, I = ctypes.c_void_p, ctypes.c_int
    fns = ablation_entries("ssd_scan", ssd_kernel.SOURCES, SSD_ABLATIONS,
                           "ssd_scan_forward", [P] * 6 + [I] * 7 + [P])

    def launch(fn, xd, a, Bm, Cm, y, state, K):
        B, L, H, Pd = xd.shape
        rc = fn(xd.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                y.data_ptr(), state.data_ptr(), B, L, H, Pd, Bm.shape[-1],
                K, 1, torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"SSD ablation launch failed: {rc}")

    order = list(fns) + list(fns)[::-1]
    times: dict = {}
    for B, L in ((4, 2048), (8, 32), (4, 32)):
        shape = (B, L, 32, 64, 128, 128)
        xd, a, Bm, Cm = ssd_inputs(*shape[:5], "sweep", torch.bfloat16, 128,
                                   seed=B * 7 + L)
        y = torch.empty_like(xd)
        state = torch.empty(B, 32, 64, 128, device="cuda")
        inner, reps = (10, 11) if L >= 1024 else (50, 21)
        row: dict = {n: [] for n in fns}
        for n in order:
            row[n].append(1e3 * graph_ms(
                lambda: launch(fns[n], xd, a, Bm, Cm, y, state, 128), inner,
                reps))
        times["x".join(map(str, shape))] = row
        print(f"[ablation] {card}: SSD {shape} bf16, bound "
              f"{1e3 * ssd_bound(*shape)[0]:.3f} us: " + "; ".join(
                  f"{n} {' / '.join(f'{t:.2f}' for t in ts)} us"
                  for n, ts in row.items()))
    print(json.dumps({"card": card, "us": times}))


# what bounds the bf16 SSD backward (``--ssd-bwd-ablation``): copies of
# ssd_scan_bwd_wgmma.cu with a part taken out, as text substitutions,
# each of which must apply exactly once. An ablated kernel computes a
# wrong result by design (and the compiler may drop the work that fed
# what was taken out): it is timed, never checked or used.
SSD_BWD_ABLATIONS = {
    # the chunk blocks' products with a state (dy S; xd dS and B dS^T)
    "no state products": [
        ("        wgmma_ss(ds, sw128_desc(ys + 64 * wg * ROW_BYTES + kk * 32,"
         " 16, 1024),",
         "        if (i < 0) wgmma_ss(ds, sw128_desc(ys + 64 * wg * ROW_BYTES"
         " + kk * 32, 16, 1024),"),
        ("        wgmma_ss(xds,", "        if (i < 0) wgmma_ss(xds,"),
        ("        wgmma_ss_t(dx,", "        if (i < 0) wgmma_ss_t(dx,")],
    # the chunk blocks' intra-chunk column blocks (C B^T, D, D B; their
    # transposes)
    "no intra-chunk products": [
        ("for (int kb = 0; kb <= wg; ++kb)", "for (int kb = 0; kb < 0; ++kb)"),
        ("for (int qb = wg; qb < C::NW; ++qb)",
         "for (int qb = wg; qb < 0; ++qb)")],
    # one head a chunk block (of each group of HEADS): each block's fixed
    # cost (B_ and C_, the groups' stores) beside a head's
    "one head a chunk block": [
        (f"nh = min(HEADS, p.H - h0);\n\n  {after}",
         f"nh = min(1, p.H - h0);\n\n  {after}")
        for after in ("float dc[", "float db[", "if (threadIdx.x == 0)")],
    # a launch without the chunk blocks, and one without the states' walk
    "no chunk kernel": [("  ssd_wgmma_bwd_chunks<K, NB>\n      <<<",
                         "  if (p.K < 0) ssd_wgmma_bwd_chunks<K, NB>\n"
                         "      <<<")],
    "no states' walk": [("  ssd_wgmma_bwd_states<K, NB>\n      <<<",
                         "  if (p.K < 0) ssd_wgmma_bwd_states<K, NB>\n"
                         "      <<<")],
}


def ssd_bwd_ablation(card: str) -> None:
    """``--ssd-bwd-ablation``: the bf16 SSD backward's device time beside
    each ablation's (``SSD_BWD_ABLATIONS``) at both train shapes, in
    turns (the kernel, the ablations, then the same reversed), each
    library built from the checkout and called through a binding of its
    own; then each of its four kernels' device time by name
    (``torch.profiler``, 10 launches). Prints one line per shape and a
    JSON object of every time (us)."""
    import ctypes

    from torch.profiler import ProfilerActivity, profile as torch_profile

    from repro_torch.kernels.ssd import kernel as ssd_kernel

    P, I = ctypes.c_void_p, ctypes.c_int
    fns = ablation_entries("ssd_scan_bwd", ssd_kernel.BWD_SOURCES,
                           SSD_BWD_ABLATIONS, "ssd_scan_backward",
                           [P] * 11 + [I] * 7 + [P])
    order = list(fns) + list(fns)[::-1]
    times: dict = {}
    for shape in SSD_TRAIN:
        B, L, H, Pd, N, K = shape
        xd, a, Bm, Cm, dy, _ = ssd_bwd_inputs(B, L, H, Pd, N, "sweep",
                                              torch.bfloat16, K, 1, False)
        grads = [torch.empty_like(t) for t in (xd, a, Bm, Cm)]
        scratch = torch.empty(ssd_kernel.bwd_scratch_floats(
            B, L, H, Pd, N, K, bf16=True), dtype=torch.float32,
            device="cuda")

        def launch(fn):
            rc = fn(xd.data_ptr(), a.data_ptr(), Bm.data_ptr(),
                    Cm.data_ptr(), dy.data_ptr(), None, scratch.data_ptr(),
                    *(g.data_ptr() for g in grads), B, L, H, Pd, N, K, 1,
                    torch.cuda.current_stream().cuda_stream)
            check(rc == 0, f"SSD backward ablation launch failed: {rc}")

        row: dict = {n: [] for n in fns}
        for n in order:
            row[n].append(1e3 * graph_ms(lambda: launch(fns[n]), 10, 11))
        for _ in range(3):
            launch(fns["kernel"])
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                launch(fns["kernel"])
            torch.cuda.synchronize()
        split = {sym: sum(e.device_time_total for e in prof.key_averages()
                          if sym in e.key) / 10 for sym in SSD_BWD_SYMBOLS}
        times["x".join(map(str, shape))] = dict(row, split=split)
        print(f"[ablation] {card}: SSD backward {shape} bf16, bound "
              f"{1e3 * ssd_bwd_bound(*shape)[0][0]:.3f} us: " + "; ".join(
                  f"{n} {' / '.join(f'{t:.2f}' for t in ts)} us"
                  for n, ts in row.items()) + "; the kernel's launches by "
              "name: " + "; ".join(f"{k} {v:.2f} us" for k, v in
                                   split.items()))
        del xd, a, Bm, Cm, dy, grads, scratch
    print(json.dumps({"card": card, "us": times}))


# what the LSTM layer kernel's weight staging costs (``--lstm-ablation``):
# copies of lstm_layer.cu, as text substitutions, each of which must apply
# exactly once
LSTM_ABLATIONS = {
    # every shape reads its weights from device memory, as a layer whose
    # weights do not fit shared memory does: the same loop, the same bits
    "weights in device memory": [
        ("  return smem_floats(I, H, true) * sizeof(float) <= "
         "(size_t)kMaxSmem;", "  return false;")],
    # the weights' shared memory is read but never filled: the staging
    # taken out (wrong results by design: timed, never checked)
    "no weight staging": [("  if (resident) {", "  if (resident && T < 0) {")],
    # staged for a window, read from device memory for a single step
    "device memory at T = 1": [
        ("  const bool resident = weights_fit(I, H);",
         "  const bool resident = weights_fit(I, H) && T > 1;")],
}
# the paths' shapes (LAYER_SHAPES) and a session step's (B 8 and B 64)
LSTM_ABLATION_SHAPES = LAYER_SHAPES + [(1, 8, 1, 5, 64), (1, 8, 1, 64, 64),
                                       (1, 64, 1, 64, 64)]


# what bounds the LSTM layer backward kernel (also ``--lstm-ablation``):
# copies of lstm_layer_bwd.cu, in the same way
LSTM_BWD_ABLATIONS = {
    # one batch row per block: a block reads the weights out of shared
    # memory for one row a step, not two (the same loop, the same bits)
    "one row a block": [("constexpr int ROWS = 2;", "constexpr int ROWS = 1;")],
    # the products taken out: a step's elementwise part, its loads and the
    # barrier alone (wrong results by design: timed, never checked)
    "no products": [("        const float acc = dot_row(d, w, G);",
                     "        const float acc = d[k % G] + w[0];")],
}
# the training path's shapes
LSTM_BWD_ABLATION_SHAPES = [(W, 32, WINDOW, I, 64) for W in (1, 4)
                            for I in (5, 64)]


def ablation_times(card, label, dims, fns, shapes, setup, launch, bound_us,
                   unchecked) -> dict:
    """Each of ``fns`` (the kernel and its ablations) at each shape
    (``dims`` names its entries):
    ``setup(shape)`` gives (inputs, {name: outputs}), ``launch(fn, ins,
    outs, shape)`` one launch. The copies not in ``unchecked`` must give
    the kernel's bits. Timed with ``graph_ms`` in turns (the kernel, the
    ablations, then the same reversed); prints one line per shape and
    returns every time (us) by shape and name."""
    order = list(fns) + list(fns)[::-1]
    times: dict = {}
    for shape in shapes:
        ins, outs = setup(shape)
        for n, fn in fns.items():
            launch(fn, ins, outs[n], shape)
        torch.cuda.synchronize()
        for n in fns:
            check(n in unchecked
                  or all(a is None or torch.equal(a, b)
                         for a, b in zip(outs[n], outs["kernel"])),
                  f"{label}: {n} changes the bits at {shape}")
        row: dict = {n: [] for n in fns}
        for n in order:
            row[n].append(1e3 * graph_ms(
                lambda: launch(fns[n], ins, outs[n], shape)))
        times[f"{label} " + "x".join(map(str, shape))] = row
        print(f"[ablation] {card}: {label} {dims} {shape}, bound "
              f"{bound_us(shape):.4f} us: " + "; ".join(
                  f"{n} {' / '.join(f'{t:.2f}' for t in ts)} us"
                  for n, ts in row.items()))
    return times


def lstm_ablation(card: str) -> None:
    """``--lstm-ablation``: the LSTM layer kernel's device time beside
    each ablation's (``LSTM_ABLATIONS``) at ``LSTM_ABLATION_SHAPES``, and
    the backward kernel's beside its ablations' (``LSTM_BWD_ABLATIONS``)
    at ``LSTM_BWD_ABLATION_SHAPES`` (``ablation_times``). Each library is
    built from the checkout and called through a binding of its own,
    outside the package; the copies that keep the loop (all but "no
    weight staging" and "no products") must give the kernel's bits.
    Prints one line per shape and a JSON object of every time (us)."""
    import ctypes

    from repro_torch.kernels.lstm import kernel as lstm_kernel

    P, I = ctypes.c_void_p, ctypes.c_int
    fns = ablation_entries("lstm_layer", lstm_kernel.SOURCES, LSTM_ABLATIONS,
                           "lstm_layer_forward", [P] * 11 + [I] * 5 + [P])
    bwd_fns = ablation_entries(
        "lstm_layer_bwd", lstm_kernel.BWD_SOURCES, LSTM_BWD_ABLATIONS,
        "lstm_layer_backward", [P] * 12 + [I] * 5 + [P])

    def launch(fn, ins, outs, shape):
        rc = fn(*(t.data_ptr() for t in ins + outs), None, None, *shape,
                torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"LSTM ablation launch failed: {rc}")

    def setup(shape):
        W, B, T, _, H = shape
        return layer_inputs(*shape, seed=5), {
            n: tuple(torch.empty(W, B, *dims, device="cuda")
                     for dims in ((T, H), (H,), (H,))) for n in fns}

    def launch_bwd(fn, ins, outs, shape):
        rc = fn(*(None if t is None else t.data_ptr() for t in ins + outs),
                *shape, torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"LSTM backward ablation launch failed: {rc}")

    def setup_bwd(shape):
        W, B, T, I_, H = shape
        args = layer_inputs(*shape, seed=5)
        _, _, _, gates, cs = lstm_kernel.lstm_layer_cuda(*args,
                                                         save_gates=True)
        ins = (*layer_cotangents(W, B, T, H, seed=5), gates, cs, args[2],
               args[3], args[4])
        return ins, {n: (torch.empty_like(gates),
                         (torch.empty(W, B, T, I_, device="cuda")
                          if I_ != 5 else None),      # layer 1: no dx
                         torch.empty_like(args[2]),
                         torch.empty_like(args[2])) for n in bwd_fns}

    times = ablation_times(card, "lstm_layer", "(W, B, T, I, H)", fns,
                           LSTM_ABLATION_SHAPES,
                           setup, launch,
                           lambda s: 1e3 * layer_bound(*s)[0],
                           {"no weight staging"})
    times.update(ablation_times(
        card, "lstm_layer_bwd", "(W, B, T, I, H)", bwd_fns,
        LSTM_BWD_ABLATION_SHAPES, setup_bwd,
        launch_bwd, lambda s: 1e3 * layer_bwd_bound(*s, s[3] != 5)[0],
        {"no products"}))
    print(json.dumps({"card": card, "us": times}))


# what a launch of the fused EVL kernel costs on the training path
# (``--evl-ablation``): a copy of evl.cu launched with Programmatic
# Dependent Launch (cudaLaunchKernelEx with programmatic stream
# serialization; the kernel waits on cudaGridDependencySynchronize()
# before it reads u), so that it may start while the kernel before it
# drains. It computes the same bits.
EVL_ABLATIONS = {
    "PDL": [
        ("""  if (row >= W) return;  // row is the same across a warp
""", """  if (row >= W) return;  // row is the same across a warp
  cudaGridDependencySynchronize();
"""),
        ("""  evl_fused_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      u, v, out, du, W, N, p, reduce);
""", """  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, evl_fused_kernel, u, v, out, du, W, N, p,
                     reduce);
""")],
}


def evl_ablation(card: str) -> None:
    """``--evl-ablation``: at the training path's shapes (W, N) = (1, 32)
    and (4, 32), the fused kernel with the gradient after a
    ``torch.sigmoid`` of the same [W, N] in one CUDA graph (the kernel),
    beside the same with the PDL copy (``EVL_ABLATIONS``), which must
    give the kernel's bits (``ablation_times``); then the launch floor,
    the kernel at (1, 1) without the gradient, and the backward's
    multiply alone, each in two turns. Prints one line per shape and a
    JSON object of every time (us)."""
    from repro_torch.kernels.evl import kernel as evl_kernel

    betas = (0.93, 0.07, 2.0)
    fns = ablation_entries("evl", evl_kernel.SOURCES, EVL_ABLATIONS,
                           "evl_fused", evl_kernel.ARGTYPES)

    def call(fn, u, v, out, du):
        rc = fn(u.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if du is None else du.data_ptr(), *u.shape,
                *evl_kernel.scalars(*betas, EVL_EPS),
                evl_kernel.REDUCE["mean"],
                torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"EVL ablation launch failed: {rc}")

    def launch(fn, ins, outs, shape):
        x, u, v = ins
        torch.sigmoid(x, out=u)
        call(fn, u, v, *outs)

    def setup(shape):
        g = torch.Generator(device="cuda").manual_seed(sum(shape))
        x = torch.randn(*shape, generator=g, device="cuda")
        v = (torch.rand(*shape, generator=g, device="cuda") < 0.1).float()
        return (x, torch.empty_like(x), v), {
            n: (torch.empty(shape[0], device="cuda"), torch.empty_like(x))
            for n in fns}

    times = ablation_times(card, "evl after a sigmoid", "(W, N)", fns,
                           EVL_SHAPES, setup, launch,
                           lambda s: 1e3 * evl_bound(*s)[0], set())
    one = torch.full((1, 1), 0.5, device="cuda")
    one_out = torch.empty(1, device="cuda")
    du = torch.rand(4, 32, device="cuda")
    gin = torch.rand(4, device="cuda")
    alone = {"floor (1, 1) no gradient": lambda: call(
                 fns["kernel"], one, one, one_out, None),
             "multiply (4, 32)": lambda: du * gin[:, None]}
    row = {n: [] for n in alone}
    for n in list(alone) + list(alone)[::-1]:
        row[n].append(1e3 * graph_ms(alone[n]))
    times["evl alone"] = row
    print(f"[ablation] {card}: evl alone: " + "; ".join(
        f"{n} {' / '.join(f'{t:.2f}' for t in ts)} us"
        for n, ts in row.items()))
    print(json.dumps({"card": card, "us": times}))


def profile_zoo(fc, symbols: dict, tag: str, absent=(),
                bursts=ZOO_BURSTS) -> None:
    """Phase 14, where a zoo flush's time goes: one predict flush at each
    burst's shape, the device's busy share, and the shares of each of
    the model's kernels (``symbols``: kernel -> a string in its device
    kernel's name) and of the matrix products. Fails if no device kernel
    of a flush holds a symbol (a renamed kernel must not read as 0 %),
    or one holds a string of ``absent``."""
    from repro_torch.data.tokens import synthetic_token_batch

    for n_req, plen, max_batch in bursts:
        toks = synthetic_token_batch(max_batch, plen, fc.cfg.vocab, seed=5)
        fc.predict(toks)
        wall, busy, kernels = profile(
            f"one predict flush of {max_batch} x {plen} tokens",
            lambda: fc.predict(toks), tag)
        own = {k: sum(us for us, _, name in kernels if sym in name)
               for k, sym in symbols.items()}
        check(all(own.values()),
              f"{fc.cfg.name} flush of {max_batch} x {plen}: no device "
              f"kernel's name holds one of {symbols}: "
              f"{[name for _, _, name in kernels]}")
        check(not any(a in name for a in absent for _, _, name in kernels),
              f"{fc.cfg.name} flush of {max_batch} x {plen} ran one of "
              f"{absent}")
        gemm = sum(us for us, _, name in kernels
                   if not any(sym in name for sym in symbols.values())
                   and any(w in name.lower() for w in (
                       "nvjet", "gemm", "cutlass", "xmma")))
        rest = busy - sum(own.values()) - gemm
        print(f"[profile] {tag}: {fc.cfg.name} flush of {max_batch} x "
              f"{plen}: " + ", ".join(
                  f"{k} {us:.1f} us = {100 * us / busy:.2f} %"
                  for k, us in own.items())
              + f" of the busy time, matrix products (projections, MLP, LM "
              f"head) {gemm:.1f} us = {100 * gemm / busy:.2f} %, the rest "
              f"{rest:.1f} us = {100 * rest / busy:.2f} %")


# ----------------------------------------------------------- [decode] --

def grow_main(cache, longer):
    """A prefill cache moved into a longer empty one (``init_cache`` at
    the whole sequence's length), as the JAX test's ``place`` does: each
    leaf of the same shape taken as it is, main's k and v copied into
    the longer main's first rows. A full-mode flush past main's end
    would be clamped onto valid keys (ROADMAP Queue 3)."""
    out = dict(longer)
    for k, src in cache.items():
        dst = longer[k]
        if dst.shape == src.shape:
            out[k] = src
        else:
            check(dst.dim() == src.dim() and dst.shape[2] > src.shape[2],
                  f"cache leaf {k}: {tuple(src.shape)} does not grow into "
                  f"{tuple(dst.shape)}")
            dst[:, :, :src.shape[2]].copy_(src)
    return out


def row_rel(got, want):
    """max |got - want| over each row of [steps, B, V] logits, over max
    |want| of its step: a numpy [steps, B], compared 32 steps at a time
    in fp32; one host read."""
    out = []
    for s0 in range(0, got.shape[0], 32):
        g = got[s0:s0 + 32].float()
        w = want[s0:s0 + 32].float()
        out.append((g - w).abs().amax(dim=2)
                   / w.abs().amax(dim=(1, 2))[:, None].clamp_min(1e-30))
    return torch.cat(out).cpu().numpy()


def decode_steps(cfg, model, params, toks, prompt: int, cache, on_step=None):
    """Teacher-forced decode of toks[:, prompt:] from ``cache``, with
    ``flush_recent`` whenever len - flushed reaches ``decode_buffer``
    (the serving loop's rule; the host counts the tokens, so it reads
    no counter off the card). ``on_step(t)`` runs after each step.
    Returns the logits [steps, B, V], the cache and the flushes."""
    from repro_torch.models import transformer as tfm

    flushed = prompt if "kr" in cache else None
    logits, flushes = [], 0
    for t in range(toks.shape[1] - prompt):
        lg, cache = model.decode_step(params, toks[:, prompt + t], cache)
        logits.append(lg)
        if flushed is not None and prompt + t + 1 - flushed >= \
                cfg.decode_buffer:
            cache = tfm.flush_recent(cfg, cache)
            flushed, flushes = prompt + t + 1, flushes + 1
        if on_step is not None:
            on_step(t)
    return torch.stack(logits), cache, flushes


def decode_run(cfg, params, toks, prompt: int, label: str, tag: str,
               bound: float, keep: bool = False,
               fp32_reference: bool = False, fp32_forward=None,
               against_forward: bool = True, routes=None,
               frames=None) -> dict:
    """One run of the decode path on the card, under ``torch.no_grad``:
    ``prefill`` of toks[:, :prompt] (and ``frames``, an audio arch's;
    launch counts zeroed just before and read just after: the path's
    kernels, ``path_kernels`` each, with the window the prompt's length
    asks for and ``non_causal_launches`` without the causal mask,
    nothing else and no plain version on a card tensor), the cache moved
    into ``init_cache`` at the whole length (``grow_main``), then one
    ``decode_step`` a token with ``flush_recent`` every
    ``decode_buffer`` tokens (counts zeroed again: a step launches
    ``step_kernels``, no kernel of the port but Whisper's
    cross-attention, a flash launch a layer; the card's sync-debug mode
    counts the host syncs). Then ``lm_forward`` over all the tokens: the prefill's
    logits and each step's within ``bound`` of its rows (max |got -
    want| / max |want|). Times: the prefill on the host's clock after a
    sync, each step between CUDA events (median after DECODE_WARMUP
    steps); without ``keep``, three more steps under ``torch.profiler``
    give the device's busy share, and the cache is freed before the
    forward. With ``keep`` the logits and the cache come back instead.
    With ``fp32_reference`` (a bf16 model) both the bf16 forward and the
    bf16 decode are read against the forward of an fp32 copy of the
    same weights too: the decode must be no further from it than
    DECODE_FP32_REF_FACTOR times the bf16 forward's own distance. The
    copy is the whole tree cast to fp32, or where one is given
    ``fp32_forward(params, toks, prompt)``'s logits at positions
    prompt.., for the sequences it ran (the first ones). Without
    ``against_forward`` (an MoE model at a capacity factor that drops:
    a step routes its own B tokens, the forward groups of 512) no
    forward is run and nothing is held against one. ``routes`` (an MoE
    model, a ``moe_routes`` recorder) reads each layer's top-k experts
    in the prefill, the steps and the forward: a (step, sequence) row
    whose experts differ from the forward's at some layer (a near-tie
    flipped by bf16 rounding, a discontinuity of the function) may
    miss the bounds, and is counted; every other row must meet them."""
    from repro_torch.models.model_zoo import build_model
    from repro_torch.tree import tree_map

    model = build_model(cfg)
    B, total = toks.shape
    steps = total - prompt
    per_prefill = path_kernels(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out: dict = {}
    with torch.no_grad():
        reset_counters()
        with no_plain_version_on_the_card() as plain_calls, \
                flash_windows() as windows:
            route_phase(routes, "prefill")
            t0 = time.perf_counter()
            first, cache = model.prefill(params, toks[:, :prompt], frames)
            torch.cuda.synchronize()
            out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        pre = read_counters()
        check(not plain_calls, f"{label}: plain versions ran on the card "
                               f"in the prefill: {plain_calls}")
        for k, v in pre.items():
            check(sum(v.values()) == per_prefill.get(k, 0),
                  f"{label}: the prefill made {v} {k} launches, "
                  f"{per_prefill.get(k, 0)} expected")
        check(all(w == expected_window(cfg, prompt) for _, w, _ in windows)
              and sum(not c for *_, c in windows)
              == non_causal_launches(cfg),
              f"{label}: flash windows and masks {windows} at {prompt} "
              f"tokens")
        out["prefill_launches"] = pre
        if "flash_attention" in per_prefill:
            out["prefill_launches"]["flash_attention"] = flash_keys(windows)
        cache = grow_main(cache, model.init_cache(B, total))
        torch.cuda.synchronize()
        # the first switch of the sync-debug mode in a process reports a
        # sync at the switch itself (torch/cuda/__init__.py, in the
        # first decode run), before any step: switch it once outside
        # the counted window, and say what that reported
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            torch.cuda.set_sync_debug_mode("default")
        switch = [f"{Path(w.filename).name}:{w.lineno}" for w in caught
                  if "synchroniz" in str(w.message)]
        reset_counters()
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(steps + 1)]
        with warnings.catch_warnings(record=True) as caught, \
                no_plain_version_on_the_card() as plain_calls:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                route_phase(routes, "decode")
                t0 = time.perf_counter()
                events[0].record()
                logits, cache, flushes = decode_steps(
                    cfg, model, params, toks, prompt, cache,
                    lambda t: events[t + 1].record())
            finally:
                torch.cuda.set_sync_debug_mode("default")
                route_phase(routes, None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        dec = read_counters()
        where: dict = {}
        for w in caught:
            if "synchroniz" in str(w.message):
                at = f"{Path(w.filename).name}:{w.lineno}"
                where[at] = where.get(at, 0) + 1
        syncs = sum(where.values())
        check(not plain_calls, f"{label}: plain versions ran on the card "
                               f"in decode: {plain_calls}")
        check(syncs <= steps, f"{label}: {syncs} host syncs in {steps} "
                              f"decode steps, more than one a step: {where}")
        per_step = step_kernels(cfg)
        check(all(sum(v.values()) == per_step.get(k, 0) * steps
                  for k, v in dec.items()),
              f"{label}: decode launched {dec}, {per_step} a step "
              f"expected")
        out["decode_launches"] = {k: dec[k] for k in per_step}
        check(int(cache["len"]) == total,
              f"{label}: the cache's len {int(cache['len'])} != {total}")
        if "flushed" in cache:
            flushed = prompt + flushes * cfg.decode_buffer
            check(int(cache["flushed"]) == flushed,
                  f"{label}: flushed {int(cache['flushed'])} != {flushed}")
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        ms = [events[i].elapsed_time(events[i + 1]) for i in range(steps)]
        warm = DECODE_WARMUP if steps > 2 * DECODE_WARMUP else steps // 2
        out["step_ms"] = statistics.median(ms[warm:])
        out["step_ms_range"] = (min(ms[warm:]), max(ms[warm:]))
        out["tokens_per_s"] = B * 1e3 / out["step_ms"]
        out["decode_wall_s"] = wall
        out["flushes"], out["syncs"] = flushes, syncs
        if not keep:
            # where a step's time goes: three more steps (past the
            # compared ones) under the profiler
            def more(c=cache, tok=toks[:, -1]):
                for _ in range(3):
                    _, c = model.decode_step(params, tok, c)
            out["busy"] = profile(f"{label}: 3 more decode steps", more,
                                  tag)[:2]
            del more
        # the cache goes before the forwards that check the steps, so
        # that it never shares the card with them
        kept = (logits, cache) if keep else None
        del cache
        if not against_forward:
            del logits
            out["kept"] = kept
            print(f"[decode] {tag}: {label}: "
                  f"{decode_line(out, B, prompt, steps, warm, where, switch)}"
                  f"; not held against lm_forward (at this capacity factor "
                  f"a step's group, its {B} tokens, drops other pairs than "
                  f"the forward's groups do)")
            return out
        route_phase(routes, "forward")
        want = model.forward(params, toks, frames)[0]
        route_phase(routes, None)
        want = want[:, prompt - 1:].transpose(0, 1)
        # rows [steps + 1, B]: the prefill's last logits, then each step
        rel_rows = row_rel(torch.cat([first[None], logits]), want)
        flipped = np.zeros(rel_rows.shape, bool)
        if routes is not None:
            flipped, out["prefill_flips"] = route_flips(routes, prompt, B)
        if fp32_reference:
            import dataclasses

            # a copy: the slice would keep the whole sequence's logits
            want = want[1:].clone()
            if fp32_forward is None:
                cfg32 = dataclasses.replace(cfg, dtype="float32")
                want32 = build_model(cfg32).forward(
                    tree_map(lambda t: t.float(), params), toks, frames)[0]
                want32 = want32[:, prompt:]
            else:
                want32 = fp32_forward(params, toks, prompt)
            want32 = want32.transpose(0, 1)
            n32 = want32.shape[1]           # the sequences it ran
            ref_rows = row_rel(logits[:, :n32], want32)
            ref = (float(row_rel(want[:, :n32], want32).max()),
                   float(ref_rows.max()),
                   float(ref_rows[~flipped[1:, :n32]].max(initial=0.0)))
            del want32
            out["fp32_reference"] = ref
            out["fp32_rows"] = (f"all {B} sequences" if n32 == B else
                                f"the first {n32} of the {B} sequences")
            check(min(ref[1], ref[2]) <= DECODE_FP32_REF_FACTOR * ref[0],
                  f"{label}: the bf16 decode is {ref[1]:.3e} ({ref[2]:.3e} "
                  f"on the rows without a router flip) from an fp32 "
                  f"forward of the same weights, over "
                  f"{DECODE_FP32_REF_FACTOR} x the bf16 forward's own "
                  f"{ref[0]:.3e}")
        del want, logits
    # the run's peak with the forwards that check it
    out["check_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    rel_first, rel = float(rel_rows[0].max()), rel_rows[1:].max(1).tolist()
    out["rel_prefill"], out["rel_max"] = rel_first, max(rel)
    out["rel_last"] = rel[-1]
    missed = rel_rows >= bound
    out["flipped_rows"] = int(flipped.sum())
    out["rel_unflipped"] = float(rel_rows[~flipped].max(initial=0.0))
    check(np.all(np.isfinite(rel_rows)) and not np.any(missed & ~flipped),
          f"{label}: decode logits vs the forward's, max |got - want| / "
          f"max |want| {max(rel):.3e} (prefill {rel_first:.3e}) over "
          f"{bound}: {[round(r, 5) for r in rel[:8]]} ... on "
          f"{int((missed & ~flipped).sum())} rows without a router flip")
    flips = ""
    if routes is not None:
        flips = (f"; router top-k sets against the forward's: "
                 f"{out['flipped_rows']} of {flipped.size} (step, "
                 f"sequence) rows with a flip at some layer, "
                 f"{int((missed & flipped).sum())} of them over the bound, "
                 f"the rest max {out['rel_unflipped']:.3e}; "
                 f"{out['prefill_flips']} flipped (layer, prompt token) "
                 f"pairs in the prefill")
    fp32_ref = ""
    if fp32_reference:
        fp32_ref = ("; vs an fp32 forward of the same weights ({}), max "
                    "over the steps: the bf16 forward {:.3e}, the bf16 "
                    "decode {:.3e} ({:.3e} without the flipped rows)"
                    .format(out["fp32_rows"], *out["fp32_reference"]))
    print(f"[decode] {tag}: {label}: "
          f"{decode_line(out, B, prompt, steps, warm, where, switch)}; "
          f"vs lm_forward max |got - "
          f"want| / max |want| prefill {rel_first:.3e}, decode max "
          f"{max(rel):.3e} (step 0 {rel[0]:.3e}, median "
          f"{statistics.median(rel):.3e}, last {rel[-1]:.3e}; bound "
          f"{bound}){fp32_ref}{flips}; peak device memory with the checking "
          f"forwards {out['check_peak_gib']:.2f} GiB")
    out["kept"] = kept
    return out


def decode_line(out, B, prompt, steps, warm, where, switch) -> str:
    """A decode run's times, launches, syncs and memory, as printed."""
    launched = ", ".join(f"{k} {v}" for k, v in
                         out["decode_launches"].items() if v) or \
        "0 kernel launches"
    return (f"prefill {B} x {prompt} tokens {out['prefill_ms']:.1f} ms ("
            + ", ".join(f"{k} {v}" for k, v in
                        out["prefill_launches"].items() if v) + "); "
            f"{steps} decode steps ({out['flushes']} flushes) in "
            f"{out['decode_wall_s']:.2f} s: {out['step_ms']:.3f} ms a step "
            f"(median after {warm}; {out['step_ms_range'][0]:.3f}-"
            f"{out['step_ms_range'][1]:.3f}), {out['tokens_per_s']:.1f} "
            f"tokens/s; {launched} in decode; {out['syncs']} host "
            f"syncs in {steps} steps{' ' + str(where) if where else ''}"
            f"{'; the mode switch before them ' + str(switch) if switch else ''}"
            f"; peak device memory {out['peak_gib']:.2f} GiB")


def decode_full(arch: str, tag: str) -> dict:
    """The [decode] phase at full width and DECODE_LAYERS[arch] layers,
    bf16, random weights from seed 0 drawn on the card: DECODE_BATCH
    prompts of DECODE_PROMPT
    tokens, DECODE_STEPS teacher-forced steps; for Zamba2 also one
    prompt of ZAMBA_LONG tokens (the ring of its 4096-key window) and
    DECODE_LONG_STEPS steps. Returns the runs by label."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_token_batch
    from repro_torch.models.transformer import init_lm

    cfg = cut_depth(get_config(arch), DECODE_LAYERS[arch])
    check(cfg.dtype == "bfloat16", f"{arch} is not bf16")
    params = init_lm(cfg, torch.Generator(device="cuda").manual_seed(0))
    runs = {}
    shapes = [(DECODE_BATCH, DECODE_PROMPT, DECODE_STEPS)]
    if cfg.family == "hybrid":
        shapes.append((1, ZAMBA_LONG, DECODE_LONG_STEPS))
    for B, prompt, steps in shapes:
        toks = torch.as_tensor(synthetic_token_batch(
            B, prompt + steps, cfg.vocab, seed=prompt), dtype=torch.long,
            device="cuda")
        label = f"{arch} ({cfg.n_layers} layers) {B} x {prompt} + {steps}"
        runs[label] = decode_run(cfg, params, toks, prompt, label, tag,
                                 DECODE_BOUND,
                                 fp32_reference=prompt == DECODE_PROMPT)
        del toks
    del params
    torch.cuda.empty_cache()
    return runs


def decode_fp32_copy(arch: str, tag: str, overrides=None,
                     against_forward: bool = True, cpu: bool = True,
                     n_layers=None) -> float:
    """``arch`` at full width, cut to DECODE_FP32_LAYERS[arch] layers,
    fp32 (TF32 off), ``decode_buffer`` DECODE_FP32[3] so that flushes
    land in the run, noised as the card-vs-CPU copies: prefill and
    decode on the card held against the card's ``lm_forward`` within
    DECODE_FP32_BOUND (unless not ``against_forward``: an MoE model at a
    capacity factor that drops), and with ``cpu`` against the port on
    the CPU with the same weights (each step's logits, and every leaf
    of the final cache). An audio arch keeps as many encoder layers and
    reads the same seeded frames on both sides. ``overrides``: config fields to set (an MoE
    model's capacity factor); ``n_layers`` in place of
    DECODE_FP32_LAYERS[arch]. Returns the largest relative difference
    card vs CPU, or the card's against the forward without ``cpu``."""
    import dataclasses

    from repro_torch.checkpoint.convert import params_to
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import (synthetic_embedding_batch,
                                         synthetic_token_batch)
    from repro_torch.models.model_zoo import build_model

    B, prompt, steps, R = DECODE_FP32
    cfg = dataclasses.replace(
        cut_depth(get_config(arch), n_layers or DECODE_FP32_LAYERS[arch]),
        dtype="float32", decode_buffer=R, **(overrides or {}))
    model = build_model(cfg)
    g = torch.Generator(device="cuda").manual_seed(2)
    params = model.init(g)
    for name, t in named_leaves(params):
        if name in DECODE_NOISE:
            t.add_(DECODE_NOISE[name] * torch.randn(t.shape, generator=g,
                                                    device="cuda"))
    toks = torch.as_tensor(synthetic_token_batch(B, prompt + steps,
                                                 cfg.vocab, seed=11),
                           dtype=torch.long)
    frames = torch.from_numpy(synthetic_embedding_batch(
        B, cfg.n_frames, cfg.d_model, seed=12)) \
        if cfg.family == "audio" else None
    label = (f"{arch} fp32 {cfg.n_layers} layers {B} x {prompt} + {steps} "
             f"(decode_buffer {R}"
             + (f", capacity factor {cfg.moe_capacity_factor}"
                if cfg.n_experts else "") + ")")
    card = decode_run(cfg, params, toks.cuda(), prompt, label, tag,
                      DECODE_FP32_BOUND, keep=True,
                      against_forward=against_forward,
                      frames=None if frames is None else frames.cuda())
    if not cpu:
        rel = max(card["rel_max"], card["rel_prefill"])
        del card, params
        return rel
    logits_g, cache_g = card["kept"]
    cpu_params = params_to(params, "cpu")
    with torch.no_grad():
        first_c, cache_c = model.prefill(cpu_params, toks[:, :prompt],
                                         frames)
        cache_c = grow_main(cache_c, model.init_cache(B, prompt + steps,
                                                      device="cpu"))
        logits_c, cache_c, _ = decode_steps(cfg, model, cpu_params, toks,
                                            prompt, cache_c)
    rel = row_rel(logits_g.cpu(), logits_c).max(1).tolist()
    leaves = {}
    for k, c in cache_c.items():
        gk = cache_g[k].cpu()
        if k in ("len", "flushed"):
            check(torch.equal(gk, c), f"{label}: {k} card {gk} != CPU {c}")
            continue
        leaves[k] = float((gk - c).abs().max()
                          / c.abs().max().clamp_min(1e-30))
    worst = max(rel + list(leaves.values()))
    check(worst < DECODE_FP32_BOUND,
          f"{label}: card vs CPU, max relative difference {worst:.3e} "
          f"(steps {max(rel):.3e}, cache {leaves}) over {DECODE_FP32_BOUND}")
    print(f"[decode] {tag}: {label}: card vs the CPU port, same weights: "
          f"logits max |card - cpu| / max |cpu| over {steps} steps "
          f"{max(rel):.3e}; final cache leaves " + ", ".join(
              f"{k} {v:.3e}" for k, v in leaves.items())
          + f" (bound {DECODE_FP32_BOUND})")
    return worst


def chunk_bound(K, P, N):
    """``ssd_chunk`` in fp32: xd, a, B_, C_ and the given state read
    once, y and the new state written once; C B^T and the masked mix
    with xd on the K (K + 1) / 2 pairs j <= i, C state^T and the state
    update (2 K N P each), at the fp32 peak (the CUDA-core kernel)."""
    nbytes = 4 * (2 * K * P + K + 2 * K * N + 2 * P * N)
    ops = 2 * (K * (K + 1) // 2) * (N + P) + 4 * K * N * P
    return bound(nbytes, ops)


def ssd_from_state(tag: str):
    """The SSD scan from a given state: ``ssd_chunk`` (the counterpart of
    the TPU kernel's single-chunk entry ``ssd_chunk_fused``; no path of
    either package calls it but its tests) driven at SSD_CHUNK_SHAPES
    (K, P, N) in fp32 at the sweep and slow decays, launch counts zeroed
    just before and read just after, each result held against its plain
    version (``ssd_chunk_ref``) on the same inputs; then
    ``ssd_chunked(initial_state=...)`` through the kernel against its
    plain version (the plain scan, the same fold) at the decode
    prefills' SSD shapes, bf16 and fp32. Times ``ssd_chunk`` (the launch
    and the fold) beside its plain version and its bound. Returns the
    entry's rows by (K, P, N), its launches and its largest |kernel -
    plain|."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.ssd.ref import (fold_state, ssd_chunk_ref,
                                             ssd_scan_ref)
    from repro_torch.models import ssm

    inputs = {}
    for i, (K, P, N) in enumerate(SSD_CHUNK_SHAPES):
        for kind in ("sweep", "slow"):
            xd, a, Bm, Cm = ssd_inputs(1, K, 1, P, N, kind, torch.float32,
                                       K, seed=300 + 10 * i + len(kind))
            g = torch.Generator(device="cuda").manual_seed(400 + i)
            state = 0.5 * torch.randn(P, N, generator=g, device="cuda")
            inputs[(K, P, N, kind)] = (xd[0, :, 0].contiguous(),
                                       a[0, :, 0].contiguous(),
                                       Bm[0].contiguous(),
                                       Cm[0].contiguous(), state)
    reset_counters()
    with torch.no_grad(), no_plain_version_on_the_card() as plain_calls, \
            dispatch.counting() as counts:
        outs = {key: dispatch.ssd_chunk(*args)
                for key, args in inputs.items()}
        torch.cuda.synchronize()
    got = read_counters()
    check(not plain_calls, f"ssd_chunk ran a plain version: {plain_calls}")
    launches = got["ssd_chunk"]
    check(sum(launches.values()) == len(inputs) == counts["ssd_chunk"]
          and sum(got["ssd_scan"].values()) == len(inputs),
          f"ssd_chunk: {launches} launches, {counts} dispatches for "
          f"{len(inputs)} calls")
    worst, parts = 0.0, []
    for key, args in inputs.items():
        want = ssd_chunk_ref(*args)
        errs = [float((o - w).abs().max()) for o, w in zip(outs[key], want)]
        for o, w, part in zip(outs[key], want, ("y", "state")):
            check(bool(torch.isfinite(o).all())
                  and torch.allclose(o, w, rtol=SSD_RTOL, atol=SSD_ATOL),
                  f"ssd_chunk {part} disagrees with ssd_chunk_ref at {key}:"
                  f" max err {float((o - w).abs().max())}")
        worst = max(worst, *errs)
        parts.append(f"{key}: y {errs[0]:.2e} state {errs[1]:.2e}")
    chunk_err = worst
    print(f"[decode] ssd_chunk driven {len(inputs)} times (launches "
          f"{launches}; dispatches {counts.by_op()}), max |kernel - "
          f"plain| (rtol {SSD_RTOL}, atol {SSD_ATOL}): " + "; ".join(parts))
    for shape in SSD_FROM_STATE:
        B, L, H, P, N, K = shape
        parts = []
        for dt in (torch.bfloat16, torch.float32):
            xd, a, Bm, Cm = ssd_inputs(B, L, H, P, N, "slow", dt, K,
                                       seed=500 + H)
            g = torch.Generator(device="cuda").manual_seed(600 + H)
            s0 = 0.5 * torch.randn(B, H, P, N, generator=g, device="cuda")
            with torch.no_grad():
                y, s = ssm.ssd_chunked(xd, a, Bm, Cm, chunk=K,
                                       initial_state=s0)
                wy, ws = fold_state(*ssd_scan_ref(xd, a, Bm, Cm, K), a, Cm,
                                    s0)
                zy, _ = ssd_scan_ref(xd, a, Bm, Cm, K)
            torch.cuda.synchronize()
            rtol, atol = ((SSD_BF16_RTOL, SSD_BF16_ATOL)
                          if dt == torch.bfloat16 else (SSD_RTOL, SSD_ATOL))
            ey = float((y.float() - wy.float()).abs().max())
            es = float((s - ws).abs().max())
            weight = float((wy.float() - zy.float()).abs().max())
            # y from zero comes out of the kernel in xd's dtype and is
            # rounded again after the fold: its error is bounded by its
            # own magnitude, not by that of the sum, which may cancel
            y_ok = bool(((y.float() - wy.float()).abs() <= atol + rtol * (
                zy.float().abs() + wy.float().abs())).all())
            check(y_ok and torch.allclose(s, ws, rtol=SSD_RTOL,
                                          atol=SSD_ATOL),
                  f"ssd_chunked(initial_state) at {shape} {dt}: y err {ey} "
                  f"(bound atol {atol} + rtol {rtol} (|y from zero| + |y|))"
                  f", state err {es}")
            worst = max(worst, ey, es)
            parts.append(f"{str(dt)[6:]} y {ey:.2e} state {es:.2e} (the "
                         f"state's share of y up to {weight:.2e})")
            del xd, a, Bm, Cm, y, s, wy, ws, zy
        print(f"[decode] ssd_chunked(initial_state) {shape} through the "
              f"kernel vs its plain version: " + "; ".join(parts))
    from repro_torch.kernels.ssd.ops import ssd_chunk

    rows = {}
    for K, P, N in SSD_CHUNK_SHAPES:
        args = inputs[(K, P, N, "slow")]
        bnd, by = chunk_bound(K, P, N)
        rows[(K, P, N)] = {
            "ms": graph_ms(lambda: ssd_chunk(*args)),
            "plain_ms": graph_ms(lambda: ssd_chunk_ref(*args)),
            "library_ms": None, "bound_ms": bnd, "bound_by": by,
            "max_abs_err": chunk_err}
        r = rows[(K, P, N)]
        print(f"[time] {tag}: ssd_chunk (K, P, N) {(K, P, N)} fp32 (the "
              f"scan kernel at chunk K and the fold): {r['ms'] * 1e3:.2f} "
              f"us, plain {r['plain_ms'] * 1e3:.2f} us, bound "
              f"{bnd * 1e3:.4f} us ({by}) = "
              f"{100 * bnd / r['ms']:.3f} % of its time; no library call")
    return rows, launches, chunk_err


def decode_main_path(tag: str) -> dict:
    """The [decode] phase: the zoo's decode path (``build_model(cfg)``'s
    ``prefill``, ``init_cache`` and ``decode_step``, and
    ``flush_recent``) for Qwen1.5-4B (full-mode cache: a flush lands
    mid-run), Mamba2-370M and Zamba2-2.7B (also the 133,120-token ring)
    at full width and half depth in bf16 (``decode_full``), each one's fp32
    copy held against the forward and the CPU (``decode_fp32_copy``),
    and the SSD scan from a given state (``ssd_from_state``). Returns
    the runs, the prefills' kernel launches by kernel and row key, and
    ``ssd_chunk``'s rows, launches and largest error."""
    runs, launches = {}, {}
    for arch in DECODE_ARCHS:
        runs.update(decode_full(arch, tag))
        decode_fp32_copy(arch, tag)
    for run in runs.values():
        launches = merge_launches(launches, run["prefill_launches"])
    rows, chunk_launches, err = ssd_from_state(tag)
    return {"runs": runs, "launches": launches, "ssd_chunk": (
        rows, chunk_launches, err)}


# ------------------------------------------------------------ [dense] --

def dense_forward_fp32(cfg, params, toks, start: int):
    """``lm_forward`` of an fp32 copy of a dense, VLM or MoE model's bf16
    weights, with the copy made one layer at a time (a whole one is
    twice the model's bytes and would not fit beside it): the walk of
    ``lm_forward`` (the embedding, ``transformer._decoder_block`` on each
    layer, the final norm and the LM head), the LM head at positions
    ``start``.. only. Returns their fp32 logits [B, S - start, V]."""
    import dataclasses

    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import apply_norm
    from repro_torch.tree import tree_map

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    check(cfg.family in ("dense", "vlm", "moe"),
          f"{cfg.name} is not a dense decoder")
    B, S = toks.shape
    x = params["embed"][toks].float()
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    window = tfm._effective_window(cfg32, S)
    for i in range(cfg.n_layers):
        lp = tree_map(lambda t: t[i].float(), params["layers"])
        x = tfm._decoder_block(cfg32, lp, x, positions, window)[0]
        del lp
    norm = tree_map(lambda t: t.float(), params["final_norm"])
    x = apply_norm(x[:, start:], norm, cfg.norm)
    return x @ params["lm_head"].float()


def settled_memory() -> int:
    """The memory allocated on the card once what the smoke no longer
    holds is dropped: ``gc``, cuBLAS's workspaces (kept per stream) and
    the caching allocator's free blocks."""
    import gc

    gc.collect()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def release(baseline: int, what: str) -> None:
    """Check that the memory allocated on the card is back to
    ``baseline`` after ``what``."""
    now = settled_memory()
    check(now == baseline, f"{what}: {now} bytes allocated on the card "
                           f"after it, {baseline} before")


def dense_model(arch: str, tag: str, baseline: int):
    """One model of the [dense] phase, alone on the card: (a) served at
    full width in bf16, DENSE_LAYERS layers, through ``ServingEngine``
    (``zoo_serve_main_path``: bursts A and B, exactly ``n_layers`` flash
    launches a flush, no plain version on the card), burst B's flush's
    busy share (``profile_zoo``); (c) DECODE_BATCH prompts of DECODE_PROMPT
    tokens prefilled with the same weights (exactly ``n_layers`` flash
    launches) and DENSE_DECODE_STEPS teacher-forced steps, each held
    against the forward and an fp32 forward (``dense_forward_fp32``);
    the model freed, and for Granite the serve CLI at full width and
    depth; (b) the DENSE_FP32_LAYERS-layer fp32 copy against the CPU
    (``zoo_card_vs_cpu``) and (d) its decode (``decode_fp32_copy``);
    (e) the flash kernel at the
    model's shapes (``time_flash``; the rows of its 8 x 32 launch bit
    for bit each row's launch alone). Only the long flush is profiled
    and the serve CLI runs Granite alone, to keep the phase short. The
    memory allocated on the card is back to ``baseline`` after each part
    that held a model. Returns the flash launches by row key, the flash
    rows and their largest |kernel - plain|."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_token_batch

    t0 = time.perf_counter()
    fc, launches, init_s = timed(
        f"{arch}: serve", zoo_serve_main_path, arch, tag, ZOO_BURSTS,
        cut_depth(get_config(arch), DENSE_LAYERS))
    serve_peak = torch.cuda.max_memory_allocated() / 2**30
    timed(f"{arch}: profile serving", profile_zoo, fc,
          {"flash_attention": FLASH_SYMBOL}, tag, (FLASH_FP32_SYMBOL,),
          ZOO_BURSTS[1:])
    cfg, params = fc.cfg, fc.params
    B, prompt, steps = DECODE_BATCH, DECODE_PROMPT, DENSE_DECODE_STEPS
    toks = torch.as_tensor(synthetic_token_batch(
        B, prompt + steps, cfg.vocab, seed=prompt), dtype=torch.long,
        device="cuda")
    label = f"{arch} {B} x {prompt} + {steps}"
    run = timed(f"{arch}: decode", decode_run, cfg, params, toks, prompt,
                label, tag, DECODE_BOUND, False, True,
                lambda p, t, s: dense_forward_fp32(
                    cfg, p, t[:DENSE_FP32_ROWS], s))
    check(run["syncs"] == 0, f"{label}: {run['syncs']} host syncs in "
                             f"{steps} decode steps")
    del fc, params, toks
    release(baseline, f"{arch} at full width")
    if arch == DENSE_CLI_ARCH:
        timed(f"{arch}: serve CLI", zoo_cli, arch, ("flash_attention",))
        release(baseline, f"the serve CLI with {arch}")
    cpu_err = timed(f"{arch}: card vs CPU", zoo_card_vs_cpu, arch, tag,
                    DECODE_NOISE, DECODE_FP32_LAYERS[arch])
    fp32_err = timed(f"{arch}: fp32 decode copy", decode_fp32_copy, arch,
                     tag)
    release(baseline, f"{arch}'s fp32 copies")
    launches = merge_launches(launches, run["prefill_launches"])
    flash = launches["flash_attention"]
    rows, err = timed(f"{arch}: time flash_attention", time_flash, flash,
                      tag, ())
    short = next(s for s in flash if s[:3] == (8, 32, 32))
    flash_rows_alone(short)
    release(baseline, f"{arch}'s flash timing")
    seconds = time.perf_counter() - t0
    print(f"[dense] {tag}: {arch} cut to {cfg.n_layers} layers: "
          f"{describe(cfg)}; served bursts A and B "
          f"with {cfg.n_layers} flash launches a flush (peak "
          f"{serve_peak:.2f} GiB), decode batch {B} (not cut) x {prompt} + "
          f"{steps}: prefill {run['prefill_ms']:.1f} ms, "
          f"{run['step_ms']:.3f} ms a step, {run['tokens_per_s']:.1f} "
          f"tokens/s, peak {run['peak_gib']:.2f} GiB, decode vs forward "
          f"max {run['rel_max']:.3e}, vs fp32 forward: bf16 forward "
          f"{run['fp32_reference'][0]:.3e}, decode "
          f"{run['fp32_reference'][1]:.3e}; {DECODE_FP32_LAYERS[arch]}-"
          f"layer fp32 copy vs CPU {cpu_err:.3e}, its decode "
          f"{fp32_err:.3e}; flash at "
          f"{sorted(flash)}: max |kernel - plain| {err:.3e}, rows of "
          f"{short} == B=1 launches bitwise; memory back to "
          f"{baseline / 2**30:.3f} GiB after each part; init "
          f"{init_s:.2f} s; {seconds:.2f} s")
    return launches, rows, err


def dense_main_path(tag: str) -> dict:
    """The [dense] phase: ``dense_model`` for each of DENSE_ARCHS, the
    smallest first, with nothing else of the smoke on the card (at most
    1 GiB allocated when it starts). Returns the flash launches by row
    key, the flash rows and the largest |kernel - plain|."""
    baseline = settled_memory()
    check(baseline < 2**30, f"[dense] starts with {baseline / 2**30:.2f} "
                            f"GiB allocated on the card")
    launches, rows, worst = {}, {}, 0.0
    for arch in DENSE_ARCHS:
        got, new_rows, err = timed(f"[dense] {arch}", dense_model, arch, tag,
                                   baseline)
        launches = merge_launches(launches, got)
        rows.update(new_rows)
        worst = max(worst, err)
    return {"launches": launches, "rows": rows, "err": worst}


# -------------------------------------------------------------- [moe] --

class MoERoutes:
    """What ``moe_routes`` records: ``calls[phase]``, one [B, S, k]
    tensor of expert indices (ascending) per MoE layer call made while
    ``phase`` was set (``route_phase``)."""

    def __init__(self):
        self.phase = None
        self.calls: dict = {}


@contextlib.contextmanager
def moe_routes():
    """Record each MoE layer's top-k experts: the port's own
    ``mlp.moe_route`` (the same groups, the same fp32 router product)
    run again on the layer's input, on the card, no host read."""
    from repro_torch.models import mlp
    from repro_torch.models import transformer as tfm

    apply = tfm.moe_apply
    rec = MoERoutes()

    def record(p, x, *, top_k, group_size, **kwargs):
        if rec.phase is not None:
            idx = mlp.moe_route(p["router"], x, top_k=top_k,
                                group_size=group_size)[3]
            B, S = x.shape[:2]
            idx = idx.reshape(-1, top_k)[:B * S].reshape(B, S, top_k)
            rec.calls.setdefault(rec.phase, []).append(
                torch.sort(idx, dim=-1).values)
        return apply(p, x, top_k=top_k, group_size=group_size, **kwargs)

    tfm.moe_apply = record
    try:
        yield rec
    finally:
        tfm.moe_apply = apply


def route_phase(routes, phase) -> None:
    if routes is not None:
        routes.phase = phase


def route_flips(routes, prompt: int, B: int):
    """Where a decode run's routes differ from the forward's: (a numpy
    bool [steps + 1, B], row 0 the prefill's last token and row 1 + t
    step t, true where some layer's top-k set differs from the
    forward's at that position; the number of (layer, sequence, prompt
    token) triples whose set differs in the prefill)."""
    fwd = torch.stack(routes.calls.pop("forward"))       # [L, B, S, k]
    L, k = fwd.shape[0], fwd.shape[-1]
    pre = torch.stack(routes.calls.pop("prefill"))       # [L, B, prompt, k]
    dec = torch.stack(routes.calls.pop("decode")).reshape(-1, L, B, k)
    pre_diff = (pre != fwd[:, :, :prompt]).any(-1)       # [L, B, prompt]
    dec_diff = (dec != fwd[:, :, prompt:].permute(2, 0, 1, 3)).any(-1)
    flipped = torch.cat([pre_diff[:, :, -1].any(0)[None], dec_diff.any(1)])
    return flipped.cpu().numpy(), int(pre_diff.sum())


def cpu_copy_layers(cfg, want: int) -> tuple[int, str]:
    """The depth of a model's fp32 copies that the host holds: ``want``
    layers if MemAvailable covers 1.5 x their fp32 bytes (the CPU
    params and what the runs hold beside them), else 1."""
    import dataclasses

    need = 1.5 * 4 * dataclasses.replace(cfg, n_layers=want).param_count()
    avail = 0
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            avail = int(line.split()[1]) * 1024
    if avail >= need:
        return want, (f"{want} layers ({need / 2**30:.1f} GiB needed, "
                      f"{avail / 2**30:.1f} GiB available on the host)")
    return 1, (f"1 layer: {want} would need {need / 2**30:.1f} GiB, the host "
               f"has {avail / 2**30:.1f} GiB available")


def moe_model(arch: str, tag: str, baseline: int):
    """One model of the [moe] phase, alone on the card, at full width in
    bf16 and MOE_LAYERS[arch] layers (random weights from seed 0, the
    router fp32): (a) served through ``ServingEngine``
    (``zoo_serve_main_path``: bursts A and B, exactly the cut depth's
    flash launches a flush, no plain version on the card), burst B's
    flush profiled; (c) DECODE_BATCH x DECODE_PROMPT tokens prefilled
    (the cut depth's flash launches) and MOE_DECODE_STEPS teacher-forced
    steps at the published capacity factor (0 launches, 0 host syncs a
    step), held against nothing: a step's group is its own 8 tokens;
    (d) the same weights at the no-drop factor ``n_experts / top_k``,
    MOE_NODROP_BATCH x DECODE_PROMPT + MOE_DECODE_STEPS, each step held
    against the forward and an fp32 forward (``dense_forward_fp32``),
    the router flips counted (``moe_routes``); (f) Mixtral: MOE_LONG
    tokens into its 4096-slot ring and MOE_DECODE_STEPS steps, at the
    no-drop factor, against the forward; the model freed, the serve CLI
    with Mixtral's reduced default; (b) the 2-layer fp32 copy against
    the CPU at the published factor, logits and aux
    (``zoo_card_vs_cpu``); (e) its decode at the published factor
    against the CPU's decode, and at the no-drop factor against the
    forward (``decode_fp32_copy``); (g) the flash kernel at the model's
    shapes (``time_flash``). The memory allocated on the card is back to
    ``baseline`` after each part that held a model. Returns the flash
    launches by row key, the flash rows and their largest |kernel -
    plain|."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_token_batch

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), n_layers=MOE_LAYERS[arch])
    fc, launches, init_s = timed(f"{arch}: serve", zoo_serve_main_path,
                                 arch, tag, ZOO_BURSTS, cfg)
    serve_peak = torch.cuda.max_memory_allocated() / 2**30
    n_params = sum(t.numel() for _, t in named_leaves(fc.params))
    check(n_params == cfg.param_count() + (2 * cfg.n_layers * cfg.head_dim
                                           if cfg.qk_norm else 0),
          f"{arch}: {n_params} parameters drawn, param_count() "
          f"{cfg.param_count()}")
    timed(f"{arch}: profile serving", profile_zoo, fc,
          {"flash_attention": FLASH_SYMBOL}, tag, (FLASH_FP32_SYMBOL,),
          ZOO_BURSTS[1:])
    params = fc.params
    prompt, steps = DECODE_PROMPT, MOE_DECODE_STEPS

    def tokens(B, n, seed):
        return torch.as_tensor(synthetic_token_batch(B, n, cfg.vocab,
                                                     seed=seed),
                               dtype=torch.long, device="cuda")

    B = DECODE_BATCH
    label = (f"{arch} ({cfg.n_layers} layers) {B} x {prompt} + {steps}, "
             f"capacity factor {cfg.moe_capacity_factor}")
    run = timed(f"{arch}: decode", decode_run, cfg, params,
                tokens(B, prompt + steps, prompt), prompt, label, tag,
                DECODE_BOUND, False, False, None, False)
    check(run["syncs"] == 0, f"{label}: {run['syncs']} host syncs in "
                             f"{steps} decode steps")
    nodrop = dataclasses.replace(
        cfg, moe_capacity_factor=cfg.n_experts / cfg.top_k)
    Bn = MOE_NODROP_BATCH
    label = (f"{arch} ({cfg.n_layers} layers) {Bn} x {prompt} + {steps}, "
             f"no-drop capacity factor {nodrop.moe_capacity_factor}")
    with moe_routes() as routes:
        nd = timed(f"{arch}: decode at the no-drop factor", decode_run,
                   nodrop, params, tokens(Bn, prompt + steps, prompt + 1),
                   prompt, label, tag, DECODE_BOUND, False, True,
                   lambda p, t, s: dense_forward_fp32(
                       nodrop, p, t[:DENSE_FP32_ROWS], s), True, routes)
    check(nd["syncs"] == 0, f"{label}: {nd['syncs']} host syncs in "
                            f"{steps} decode steps")
    runs = [run, nd]
    if cfg.window is not None:
        label = (f"{arch} ({cfg.n_layers} layers) 1 x {MOE_LONG} + {steps}, "
                 f"ring of {cfg.window}, no-drop capacity factor "
                 f"{nodrop.moe_capacity_factor}")
        with moe_routes() as routes:
            runs.append(timed(
                f"{arch}: decode {MOE_LONG} tokens", decode_run, nodrop,
                params, tokens(1, MOE_LONG + steps, MOE_LONG), MOE_LONG,
                label, tag, DECODE_BOUND, False, False, None, True, routes))
    del fc, params
    release(baseline, f"{arch} at full width, {cfg.n_layers} layers")
    if arch == MOE_CLI_ARCH:
        timed(f"{arch}: serve CLI (reduced)", zoo_cli, arch,
              ("flash_attention",), False)
        release(baseline, f"the serve CLI with {arch}")
    layers, why = cpu_copy_layers(cfg, DECODE_FP32_LAYERS[arch])
    print(f"[moe] {tag}: {arch}: fp32 copies of {why}")
    cpu_err = timed(f"{arch}: card vs CPU", zoo_card_vs_cpu, arch, tag,
                    DECODE_NOISE, layers)
    fp32_err = timed(f"{arch}: fp32 decode copy vs CPU", decode_fp32_copy,
                     arch, tag, None, False, True, layers)
    fp32_fwd = timed(f"{arch}: fp32 decode copy vs the forward, no drop",
                     decode_fp32_copy, arch, tag,
                     {"moe_capacity_factor": nodrop.moe_capacity_factor},
                     True, False, layers)
    release(baseline, f"{arch}'s fp32 copies")
    for r in runs:
        launches = merge_launches(launches, r["prefill_launches"])
    flash = launches["flash_attention"]
    rows, err = timed(f"{arch}: time flash_attention", time_flash, flash,
                      tag, ())
    short = next(s for s in flash if s[:3] == (8, 32, 32))
    flash_rows_alone(short[:6])
    release(baseline, f"{arch}'s flash timing")
    seconds = time.perf_counter() - t0
    long = (f"; 1 x {MOE_LONG} into the ring: prefill "
            f"{runs[2]['prefill_ms']:.1f} ms, {runs[2]['step_ms']:.3f} ms a "
            f"step, vs forward max {runs[2]['rel_max']:.3e}, "
            f"{runs[2]['flipped_rows']} flipped rows"
            if len(runs) > 2 else "")
    print(f"[moe] {tag}: {arch}: {describe(cfg)}; {n_params} parameters "
          f"drawn (param_count() of the {cfg.n_layers}-layer config "
          f"{cfg.param_count()}, plus the QK norms' "
          f"{n_params - cfg.param_count()}); served bursts A and B with "
          f"{cfg.n_layers} flash launches a flush (peak {serve_peak:.2f} "
          f"GiB); decode batch {B} x {prompt} + {steps} at factor "
          f"{cfg.moe_capacity_factor}: prefill {run['prefill_ms']:.1f} ms, "
          f"{run['step_ms']:.3f} ms a step, {run['tokens_per_s']:.1f} "
          f"tokens/s, peak {run['peak_gib']:.2f} GiB, 0 host syncs; the "
          f"no-drop check at batch {Bn} (factor "
          f"{nodrop.moe_capacity_factor}): decode vs forward max "
          f"{nd['rel_max']:.3e} ({nd['flipped_rows']} of "
          f"{(steps + 1) * Bn} rows with a router flip, the others max "
          f"{nd['rel_unflipped']:.3e}), vs fp32 forward: bf16 forward "
          f"{nd['fp32_reference'][0]:.3e}, decode "
          f"{nd['fp32_reference'][1]:.3e}, peak {nd['peak_gib']:.2f} GiB "
          f"({nd['check_peak_gib']:.2f} with the fp32 forward)"
          f"{long}; {layers}-layer fp32 copy vs CPU {cpu_err:.3e}, its "
          f"decode vs the CPU's {fp32_err:.3e}, at no drop vs the forward "
          f"{fp32_fwd:.3e}; flash at {sorted(flash)}: max |kernel - plain| "
          f"{err:.3e}; memory back to {baseline / 2**30:.3f} GiB after each "
          f"part; init {init_s:.2f} s; {seconds:.2f} s")
    return launches, rows, err


def moe_main_path(tag: str) -> dict:
    """The [moe] phase: ``moe_model`` for each of MOE_ARCHS, Mixtral
    first, with nothing else of the smoke on the card (at most 1 GiB
    allocated when it starts). Returns the flash launches by row key,
    the flash rows and the largest |kernel - plain|."""
    baseline = settled_memory()
    check(baseline < 2**30, f"[moe] starts with {baseline / 2**30:.2f} GiB "
                            f"allocated on the card")
    launches, rows, worst = {}, {}, 0.0
    for arch in MOE_ARCHS:
        got, new_rows, err = timed(f"[moe] {arch}", moe_model, arch, tag,
                                   baseline)
        launches = merge_launches(launches, got)
        rows.update(new_rows)
        worst = max(worst, err)
    return {"launches": launches, "rows": rows, "err": worst}


# ------------------------------------------------------------ [audio] --

def audio_main_path(tag: str) -> dict:
    """The [audio] phase: Whisper-medium at full width and depth in bf16
    (random weights from seed 0), alone on the card (at most 1 GiB
    allocated when it starts): (a) served through ``ServingEngine`` on
    the stub frames (``zoo_serve_main_path``: AUDIO_BURSTS, exactly 3 x
    24 flash launches a flush, 48 of them without a mask, no plain
    version on the card), each burst's flush profiled (``profile_zoo``);
    (b) AUDIO_DECODE: 8 prompts of 64 tokens prefilled with 8 x 1500
    stub frames (72 flash launches) and 288 teacher-forced steps with a
    flush at 320 tokens, exactly 24 flash launches and 0 host syncs a
    step, each step held against the forward and against an fp32
    forward of the same weights; the model freed; (c) the serve CLI
    with the reduced config; (d) the 2 + 2-layer fp32 copy against the
    CPU (``zoo_card_vs_cpu``: predict and the forward on the same
    frames) and its decode (``decode_fp32_copy``); (e) the flash kernel
    at every (shape, mask) the phase launched (``time_flash``). The
    memory allocated on the card is back to the baseline after each
    part that held a model. Returns the flash launches by row key (the
    decode steps' included), the flash rows and their largest |kernel -
    plain|."""
    from repro_torch.data.tokens import synthetic_token_batch
    from repro_torch.serving.forecaster import stub_frames

    t0 = time.perf_counter()
    baseline = settled_memory()
    check(baseline < 2**30, f"[audio] starts with {baseline / 2**30:.2f} "
                            f"GiB allocated on the card")
    fc, launches, init_s = timed(f"{AUDIO_ARCH}: serve", zoo_serve_main_path,
                                 AUDIO_ARCH, tag, AUDIO_BURSTS)
    serve_peak = torch.cuda.max_memory_allocated() / 2**30
    timed(f"{AUDIO_ARCH}: profile serving", profile_zoo, fc,
          {"flash_attention": FLASH_SYMBOL}, tag, (FLASH_FP32_SYMBOL,),
          AUDIO_BURSTS)
    cfg, params = fc.cfg, fc.params
    B, prompt, steps = AUDIO_DECODE
    toks = torch.as_tensor(synthetic_token_batch(
        B, prompt + steps, cfg.vocab, seed=prompt), dtype=torch.long,
        device="cuda")
    frames = stub_frames(cfg, B, "cuda")
    label = f"{AUDIO_ARCH} {B} x {prompt} + {steps}"
    run = timed(f"{AUDIO_ARCH}: decode", decode_run, cfg, params, toks,
                prompt, label, tag, DECODE_BOUND, False, True, None, True,
                None, frames)
    check(run["syncs"] == 0, f"{label}: {run['syncs']} host syncs in "
                             f"{steps} decode steps")
    del fc, params, toks, frames
    release(baseline, f"{AUDIO_ARCH} at full width")
    timed(f"{AUDIO_ARCH}: serve CLI (reduced)", zoo_cli, AUDIO_ARCH,
          ("flash_attention",), False)
    release(baseline, f"the serve CLI with {AUDIO_ARCH}")
    cpu_err = timed(f"{AUDIO_ARCH}: card vs CPU", zoo_card_vs_cpu,
                    AUDIO_ARCH, tag, DECODE_NOISE)
    fp32_err = timed(f"{AUDIO_ARCH}: fp32 decode copy", decode_fp32_copy,
                     AUDIO_ARCH, tag)
    release(baseline, f"{AUDIO_ARCH}'s fp32 copies")
    launches = merge_launches(launches, run["prefill_launches"],
                              run["decode_launches"])
    flash = launches["flash_attention"]
    rows, err = timed(f"{AUDIO_ARCH}: time flash_attention", time_flash,
                      flash, tag, ())
    release(baseline, f"{AUDIO_ARCH}'s flash timing")
    seconds = time.perf_counter() - t0
    print(f"[audio] {tag}: {AUDIO_ARCH}: {describe(cfg)}; served bursts "
          f"{AUDIO_BURSTS} with {path_kernels(cfg)['flash_attention']} "
          f"flash launches a flush ({non_causal_launches(cfg)} without a "
          f"mask; peak {serve_peak:.2f} GiB), decode batch {B} x {prompt} "
          f"+ {steps}: prefill {run['prefill_ms']:.1f} ms, "
          f"{run['step_ms']:.3f} ms a step, {run['tokens_per_s']:.1f} "
          f"tokens/s, {step_kernels(cfg)['flash_attention']} flash launches "
          f"and 0 host syncs a step, peak {run['peak_gib']:.2f} GiB, decode "
          f"vs forward max {run['rel_max']:.3e}, vs fp32 forward: bf16 "
          f"forward {run['fp32_reference'][0]:.3e}, decode "
          f"{run['fp32_reference'][1]:.3e}; 2 + 2-layer fp32 copy vs CPU "
          f"{cpu_err:.3e}, its decode {fp32_err:.3e}; flash at "
          f"{sorted(flash, key=str)}: max |kernel - plain| {err:.3e}; "
          f"memory back to {baseline / 2**30:.3f} GiB after each part; "
          f"init {init_s:.2f} s; {seconds:.2f} s")
    return {"launches": launches, "rows": rows, "err": err}


# --------------------------------------------------------- [train-zoo] --

# the backward's device kernels: the fp32 CUDA-core ones, which a bf16
# launch must not reach, and the bf16 ones (the Delta pass, then the
# wgmma kernel of the dK/dV and dQ blocks, one instantiation a head dim
# and mask: bwd_wgmma<D, causal>, "bwd_wgmmaILi" in its mangled name)
FLASH_BWD_SYMBOLS = ("delta_kernel", "dkdv_kernel", "dq_kernel")
FLASH_BWD_BF16_SYMBOLS = ("delta_bf16", "bwd_wgmma<")
FLASH_BWD_WGMMA = "bwd_wgmmaILi"


def flash_bwd_inputs(B, Sq, Skv, Hq, Hkv, D, mask, dtype, seed):
    """q, k, v, the forward's output and logsumexp (from the forward
    kernel, as the training forward launches it) and a cotangent, on
    the card."""
    from repro_torch.kernels.attention import kernel as attn_kernel

    q, k, v = attn_inputs(B, Sq, Skv, Hq, Hkv, D, dtype, seed=seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    dout = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device="cuda")
    out = attn_kernel.flash_attention_cuda(
        q, k, v, mask["causal"], mask.get("window"), 0, Skv, lse=lse)
    return q, k, v, out, dout, lse


def flash_bwd_err(got, want, dtype, what) -> float:
    """The backward's (dq, dk, dv) against the plain version's: fp32 at
    the forward's rtol / atol, bf16 within FLASH_BWD_BF16_REL of each
    one's max |grad|. Returns the largest |kernel - plain| over max
    |grad| (bf16) or the largest |kernel - plain| (fp32)."""
    worst = 0.0
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        check(g.dtype == dtype and g.shape == w.shape,
              f"flash backward {what}: {name} {g.dtype} {tuple(g.shape)}")
        err = float((g.float() - w.float()).abs().max())
        if dtype == torch.float32:
            check(torch.allclose(g, w.float(), rtol=FLASH_RTOL,
                                 atol=FLASH_ATOL),
                  f"flash backward disagrees with its plain version at "
                  f"{what} fp32: {name} max err {err}")
            worst = max(worst, err)
        else:
            top = float(w.float().abs().max())
            check(err <= FLASH_BWD_BF16_REL * top,
                  f"flash backward disagrees with its plain version at "
                  f"{what} bf16: {name} max err {err}, max |grad| {top}")
            worst = max(worst, err / top)
    return worst


def check_flash_bwd() -> dict:
    """The flash backward kernel against ``attention_bwd_ref`` on the
    card, on the same inputs and cotangent, over FLASH_BWD_CASES in fp32
    and bf16, through the autograd Function the path runs (its forward
    launch with the logsumexp, then the backward launch); the forward's
    logsumexp against ``logsumexp_ref`` and its output bitwise the
    serving launch's; a second backward launch bitwise the first, and
    the rows of B = 1 launches (the first and the last row) bitwise the
    whole batch's. Returns the largest |kernel - plain| (fp32) and
    relative (bf16)."""
    from repro_torch.kernels.attention import kernel as attn_kernel
    from repro_torch.kernels.attention.ops import flash_attention
    from repro_torch.kernels.attention.ref import (attention_bwd_ref,
                                                   logsumexp_ref)

    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    lse_err = 0.0
    n = 0
    for B, Sq, Skv, Hq, Hkv, D, mask in FLASH_BWD_CASES:
        for dt in worst:
            n += 1
            what = f"({B}, {Sq}, {Skv}, {Hq}, {Hkv}, {D}) {mask}"
            q, k, v, out, dout, lse = flash_bwd_inputs(
                B, Sq, Skv, Hq, Hkv, D, mask, dt, seed=100 + n)
            serve = attn_kernel.flash_attention_cuda(
                q, k, v, mask["causal"], mask.get("window"), 0, Skv)
            check(torch.equal(out, serve),
                  f"flash forward at {what} {dt}: the output with the "
                  f"logsumexp differs from the serving launch's")
            f32 = [t.float() for t in (q, k, v, out, dout)]
            want_lse = logsumexp_ref(f32[0], f32[1], causal=mask["causal"],
                                     window=mask.get("window"))
            lse_err = max(lse_err, float((lse - want_lse).abs().max()))
            check(torch.allclose(lse, want_lse, rtol=1e-4, atol=1e-4),
                  f"flash forward's logsumexp at {what} {dt}: max err "
                  f"{float((lse - want_lse).abs().max())}")
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            before = attn_kernel.FLASH_BWD_LAUNCHES.total
            flash_attention(*leaves, **mask).backward(dout)
            check(attn_kernel.FLASH_BWD_LAUNCHES.total == before + 1,
                  f"flash backward at {what}: not one launch")
            got = [t.grad for t in leaves]
            again = attn_kernel.flash_attention_bwd_cuda(
                q, k, v, out, dout, lse, mask["causal"], mask.get("window"))
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"flash backward at {what} {dt}: two launches differ")
            for i in sorted({0, B - 1} if B > 1 else ()):
                one = attn_kernel.flash_attention_bwd_cuda(
                    *(t[i:i + 1].contiguous()
                      for t in (q, k, v, out, dout, lse)),
                    mask["causal"], mask.get("window"))
                torch.cuda.synchronize()
                check(all(torch.equal(a, b[i:i + 1])
                          for a, b in zip(one, got)),
                      f"flash backward at {what} {dt}: row {i} of a B = 1 "
                      f"launch differs from the B = {B} launch's")
            want = attention_bwd_ref(*f32, want_lse, causal=mask["causal"],
                                     window=mask.get("window"))
            worst[dt] = max(worst[dt], flash_bwd_err(got, want, dt, what))
            del q, k, v, out, dout, lse, leaves, got, again, want, f32
    print(f"[check] flash backward vs attention_bwd_ref over {n} cases "
          f"(B, Sq, Skv, Hq, Hkv, D, mask) "
          f"{[c[:6] + (c[6],) for c in FLASH_BWD_CASES]} x fp32, bf16, "
          f"through the autograd Function: max |kernel - plain| fp32 "
          f"{worst[torch.float32]:.3e} (rtol {FLASH_RTOL}, atol "
          f"{FLASH_ATOL}), bf16 {worst[torch.bfloat16]:.3e} of max |grad| "
          f"(bound {FLASH_BWD_BF16_REL}); the forward's logsumexp vs "
          f"logsumexp_ref max {lse_err:.3e} (1e-4), its output bitwise "
          f"the serving launch's; a second backward launch bitwise the "
          f"first, the rows of B = 1 launches bitwise the batch's")
    return worst


def flash_bwd_bound(B, Sq, Skv, Hq, Hkv, D, window=None, causal=True,
                    itemsize=2):
    """The flash backward at the bf16 tensor-core peak: 10 D operations
    per attended (query, key) pair and head (s again, dP, dV, dQ, dK:
    two each), 2.5 x the forward's; q, k, v, o, dout read once, the
    logsumexp (fp32) read once, dq, dk, dv written once."""
    ops = flash_ops(B, Sq, Skv, Hq, Hkv, D, window, causal) * 10 // 4
    nbytes = (itemsize * (4 * B * Sq * Hq * D + 4 * B * Skv * Hkv * D)
              + 4 * B * Hq * Sq)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_bwd_delta_ms(out, dout, lse, inner: int, reps: int) -> float:
    """Device ms of the bf16 backward's Delta pass alone (its own C entry,
    ``flash_attention_bwd_delta``: Delta and lse in log2 units into the
    scratch the backward takes)."""
    from repro_torch.kernels.attention import kernel as attn_kernel

    fn = attn_kernel._bwd_library().flash_attention_bwd_delta
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    B, Sq, Hq, D = out.shape
    pad = attn_kernel.BWD_ROW_PAD
    scratch = torch.empty((2, B, Hq, -(-Sq // pad) * pad),
                          dtype=torch.float32, device="cuda")

    def run():
        rc = fn(out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                scratch.data_ptr(), B, Sq, Hq, D,
                torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"the flash backward's Delta pass failed: {rc}")

    return graph_ms(run, inner, reps)


def time_flash_bwd(launches: dict, tag: str, extra=FLASH_BWD_TIMED):
    """The backward kernels at each row key of the train path (bf16), and
    at ``extra``'s (FLASH_BWD_TIMED's) shapes: their device time
    (``graph_ms``) beside the Delta pass's alone, the plain version's
    (``attention_bwd_ref``),
    the library's (one ``scaled_dot_product_attention`` forward +
    backward, less its forward; never called by the port) and the bound;
    held against the plain version there first. Returns rows by key and
    the largest relative |kernel - plain|."""
    import torch.nn.functional as F

    from repro_torch.kernels.attention import kernel as attn_kernel
    from repro_torch.kernels.attention.ref import attention_bwd_ref

    rows, worst = {}, 0.0
    shapes = [flash_row(key) for key in sorted(launches, key=str)] + [
        (t[:6], None, t[6]) for t in extra]
    for shape, w, causal in shapes:
        B, Sq, Skv, Hq, Hkv, D = shape
        key = flash_key(shape, w, causal)
        mask = dict(causal=causal, window=w)
        q, k, v, out, dout, lse = flash_bwd_inputs(
            *shape, mask, torch.bfloat16, seed=B * 7 + Sq)
        got = attn_kernel.flash_attention_bwd_cuda(q, k, v, out, dout, lse,
                                                   causal, w)
        want = attention_bwd_ref(*(t.float() for t in (q, k, v, out, dout)),
                                 lse, causal=causal, window=w)
        err = flash_bwd_err(got, want, torch.bfloat16, str(key))
        worst = max(worst, err)
        del got, want
        gqa = Hq != Hkv
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        dot = dout.transpose(1, 2).contiguous()

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=gqa)

        def sdpa_fwd_bwd():
            return torch.autograd.grad(sdpa(), (qt, kt, vt), dot)

        inner, reps = (10, 11)
        lib_fwd = graph_ms(lambda: sdpa().detach(), inner, reps)
        bnd, by = flash_bwd_bound(*shape, w, causal)
        rows[key] = {
            "ms": graph_ms(lambda: attn_kernel.flash_attention_bwd_cuda(
                q, k, v, out, dout, lse, causal, w), inner, reps),
            "delta_ms": flash_bwd_delta_ms(out, dout, lse, inner, reps),
            "plain_ms": graph_ms(lambda: attention_bwd_ref(
                q, k, v, out, dout, lse, causal=causal, window=w), inner,
                reps),
            "library_ms": graph_ms(sdpa_fwd_bwd, inner, reps) - lib_fwd,
            "bound_ms": bnd, "bound_by": by, "max_abs_err": err}
        r = rows[key]
        tflops = (flash_ops(*shape, w, causal) * 10 // 4
                  / (r["ms"] * 1e-3) / 1e12)
        print(f"[time] {tag}: flash_attention_bwd {shape} bf16 "
              f"{'causal' if causal else 'non-causal'}"
              f"{f' window {w}' if w else ''}: kernel "
              f"{r['ms'] * 1e3:.2f} us = {tflops:.1f} TFLOP/s (the "
              f"bound's operations over its time), its Delta pass alone "
              f"{r['delta_ms'] * 1e3:.2f} us, plain "
              f"{r['plain_ms'] * 1e3:.2f} us, scaled_dot_product_attention "
              f"forward + backward less its forward "
              f"{r['library_ms'] * 1e3:.2f} us (its forward "
              f"{lib_fwd * 1e3:.2f} us; the kernel "
              f"{r['ms'] / r['library_ms']:.2f}x its time), bound "
              f"{r['bound_ms'] * 1e3:.3f} us ({by}) = "
              f"{100 * r['bound_ms'] / r['ms']:.2f} % of the kernel's time; "
              f"|kernel - plain| {err:.3e} of max |grad|; "
              f"{launches.get(key, 0)} launches on the main path")
        del q, k, v, out, dout, lse, qt, kt, vt, dot
    return rows, worst


# the train path's backward launch, which ``--flash-bwd`` re-times
FLASH_BWD_PROBE = (8, 512, 512, 20, 20, 128)


def flash_bwd_probe(tag: str) -> None:
    """``--flash-bwd``: the bf16 flash backward as training launches it
    (causal, from the forward's output and logsumexp) at the train
    path's shape: device us a launch (``graph_ms``) and a digest of dq,
    dk and dv's bytes on seeded inputs. Uses only the binding every
    version since the backward has (``flash_attention_bwd_cuda``, the
    forward with ``lse``), so that a copy of this script in an earlier
    ``git archive`` checkout times that one's kernels in the same call
    (turns: earlier, this, this, earlier). Prints one JSON line."""
    from repro_torch.kernels.attention import kernel as attn_kernel

    B, Sq, Skv, Hq, Hkv, D = FLASH_BWD_PROBE
    g = torch.Generator(device="cuda").manual_seed(B * 7 + Sq)
    q, dout = (torch.randn((B, Sq, Hq, D), generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((B, Skv, Hkv, D), generator=g, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device="cuda")
    out = attn_kernel.flash_attention_cuda(q, k, v, True, None, 0, Skv,
                                           lse=lse)
    grads = attn_kernel.flash_attention_bwd_cuda(q, k, v, out, dout, lse,
                                                 True, None)
    torch.cuda.synchronize()
    digest = hashlib.sha256(b"".join(
        t.view(torch.int16).cpu().numpy().tobytes()
        for t in grads)).hexdigest()[:16]
    us = 1e3 * graph_ms(lambda: attn_kernel.flash_attention_bwd_cuda(
        q, k, v, out, dout, lse, True, None), 10, 11)
    print(json.dumps({"flash_bwd": tag, "root": str(ROOT),
                      "shape": "x".join(map(str, FLASH_BWD_PROBE)),
                      "us": us, "digest": digest}))


def train_fp32_copy(arch: str, n_layers: int, tag: str, phase: str):
    """``arch`` at full width cut to ``n_layers``, fp32 (TF32 off), remat
    on, noised as the card-vs-CPU copies: ``lm_loss`` and every gradient
    leaf (``launch.specs.loss_and_grad``) on the card (through the fp32
    kernels, forward and backward, exactly ``train_launches``) and on
    the CPU (the plain versions) from the same weights on the same
    TRAIN_FP32_BATCH tokens (the SSD scan's one ragged chunk): the loss
    and each gradient leaf within TRAIN_FP32_TOL of the leaf's max
    |value|. Returns the largest relative difference of the loss and the
    gradients, and the config with each device's (parameters, gradient)
    for ``fp32_adam_step``."""
    import dataclasses

    from repro_torch.checkpoint.convert import params_to
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_token_batch
    from repro_torch.launch.specs import loss_and_grad
    from repro_torch.models.transformer import init_lm

    cfg = dataclasses.replace(cut_depth(get_config(arch), n_layers),
                              dtype="float32")
    g = torch.Generator(device="cuda").manual_seed(1)
    params = init_lm(cfg, g)
    for name, t in named_leaves(params):
        if name in DECODE_NOISE:
            t.add_(DECODE_NOISE[name] * torch.randn(t.shape, generator=g,
                                                    device="cuda"))
    toks = torch.as_tensor(synthetic_token_batch(
        *TRAIN_FP32_BATCH, cfg.vocab, seed=21), dtype=torch.long)
    want = train_launches(cfg, *TRAIN_FP32_BATCH)
    runs, loss = {}, {}
    for dev in ("cuda", "cpu"):
        p = params if dev == "cuda" else params_to(params, "cpu")
        reset_counters()
        with no_plain_version_on_the_card() as plain_calls:
            loss[dev], grads = loss_and_grad(cfg, p, toks.to(dev))
        if dev == "cuda":
            check(not plain_calls, f"plain versions ran on the card: "
                                   f"{plain_calls}")
            launches_ok(read_counters(), want,
                        f"{arch} fp32 copy's gradient on the card")
        runs[dev] = (p, grads)
    del params
    rel = abs(float(loss["cuda"]) - float(loss["cpu"])) / abs(
        float(loss["cpu"]))
    check(rel <= TRAIN_FP32_TOL, f"{arch} fp32 copy's loss: card "
                                 f"{float(loss['cuda'])} vs CPU "
                                 f"{float(loss['cpu'])}")
    grad_err = leaves_close(f"{arch} fp32 copy's gradient",
                            runs["cuda"][1], runs["cpu"][1])
    print(f"[{phase}] {tag}: {arch} fp32 copy, full width, {n_layers} "
          f"layers, batch {TRAIN_FP32_BATCH}: card vs CPU, same weights: "
          f"loss {float(loss['cuda']):.6f} vs {float(loss['cpu']):.6f} (rel "
          f"{rel:.3e}); max |card - cpu| / max |cpu| over the gradient's "
          f"leaves {grad_err:.3e} (bound {TRAIN_FP32_TOL}); the card's "
          f"gradient launched "
          f"{ {k: sum(v.values()) for k, v in want.items()} } (fp32), no "
          f"plain version")
    return max(rel, grad_err), (cfg, runs)


def leaves_close(label: str, got, want) -> float:
    """Each leaf of the tree ``got`` (on the card) within TRAIN_FP32_TOL
    of the same leaf of ``want`` (on the CPU), relative to that leaf's
    max |value|. Returns the largest such difference."""
    from repro_torch.tree import tree_flatten_with_path

    got = dict(tree_flatten_with_path(got))
    worst = 0.0
    for path, c in tree_flatten_with_path(want):
        top = float(c.abs().max())
        err = float((got[path].cpu() - c).abs().max()) / max(top, 1e-30)
        worst = max(worst, err)
        check(err <= TRAIN_FP32_TOL, f"{label} {path}: card vs CPU "
                                     f"{err:.3e} of max |value| {top:.3e}")
    return worst


def fp32_adam_step(copy, tag: str, phase: str) -> None:
    """One Adam step of ``make_optimizer`` (``make_train_step``'s step at
    one microbatch) on ``train_fp32_copy``'s gradient, on the card and
    on the CPU: Adam's moments within TRAIN_FP32_TOL of each leaf's max
    |value|, the parameters as TRAIN_FP32_TOL's comment says."""
    from repro_torch.launch.specs import make_optimizer
    from repro_torch.optim import apply_updates
    from repro_torch.tree import tree_flatten_with_path

    cfg, runs = copy
    opt = make_optimizer(cfg)
    out = {}
    for dev, (p, grads) in runs.items():
        updates, state = opt.update(grads, opt.init(p), p, TRAIN_ZOO_LR)
        out[dev] = (state.mu, state.nu, apply_updates(p, updates))
    label = f"{cfg.name} fp32 copy's"
    mu = leaves_close(f"{label} Adam mu", out["cuda"][0], out["cpu"][0])
    nu = leaves_close(f"{label} Adam nu", out["cuda"][1], out["cpu"][1])
    stepped = dict(tree_flatten_with_path(out["cuda"][2]))
    off = n = 0
    step_max = 0.0
    for path, c in tree_flatten_with_path(out["cpu"][2]):
        diff = (stepped[path].cpu() - c).abs()
        off += int((diff > 1e-6 + 1e-4 * c.abs()).sum())
        n += diff.numel()
        step_max = max(step_max, float(diff.max()))
    check(off <= n * 1e-3 and step_max <= 2 * TRAIN_ZOO_LR,
          f"{label} parameters after one Adam step: {off} of {n} elements "
          f"beyond rtol 1e-4 / atol 1e-6, max |diff| {step_max}")
    print(f"[{phase}] {tag}: {label} Adam step, card vs CPU: max |card - "
          f"cpu| / max |cpu| over the leaves: mu {mu:.3e}, nu {nu:.3e} "
          f"(bound {TRAIN_FP32_TOL}); parameters after the step: {off} of "
          f"{n} elements beyond rtol 1e-4 / atol 1e-6, max |diff| "
          f"{step_max:.3e} (lr {TRAIN_ZOO_LR})")

def train_cli(phase: str, arch: str, reduced: bool, steps: int,
              batch_seq=None) -> None:
    """The training CLI's zoo mode on the card: ``train --arch <arch>
    [--reduced] --steps <steps> [--batch B --seq S] --device cuda``
    (``batch_seq`` (B, S), else the CLI's defaults, TRAIN_CLI_BATCH),
    each step exactly ``train_launches`` (remat), nothing else."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced as reduce_cfg
    from repro_torch.launch import train as train_cli_main

    cfg = reduce_cfg(get_config(arch)) if reduced else get_config(arch)
    args = (["--arch", arch] + (["--reduced"] if reduced else [])
            + ["--steps", str(steps)]
            + ([] if batch_seq is None else
               ["--batch", str(batch_seq[0]), "--seq", str(batch_seq[1])])
            + ["--device", "cuda"])
    reset_counters()
    losses = train_cli_main.main(args)
    want = {k: {s: steps * n for s, n in v.items()} for k, v in
            train_launches(cfg, *(batch_seq or TRAIN_CLI_BATCH)).items()}
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"train {' '.join(args)}: losses {losses}")
    launches_ok(read_counters(), want, f"train {' '.join(args)}")
    print(f"[{phase}] train {' '.join(args)}: losses "
          f"{[round(x, 4) for x in losses]}, launches {want} ({cfg.n_layers} "
          f"layers, remat, {steps} steps), nothing else")


def train_zoo_main_path(tag: str) -> dict:
    """The [train-zoo] phase: ``train_zoo_model`` for Qwen1.5-4B at full
    width, TRAIN_ZOO_LAYERS layers (TRAIN_ZOO_STEPS steps and a profiled
    one: 2 flash forward and 1 backward launches a layer); then
    ``train_fp32_copy``, the training CLI, ``check_flash_bwd`` and
    ``time_flash_bwd`` at the path's shape, and the forward there
    (``time_flash``). Returns the flash forward and backward launches by
    row key, both kernels' rows at the path's shape, the forward's
    largest |kernel - plain| there and the backward's in fp32 over
    ``check_flash_bwd``."""
    t_phase = time.perf_counter()
    launches = train_zoo_model(TRAIN_ZOO_ARCH, TRAIN_ZOO_LAYERS,
                               TRAIN_ZOO_STEPS, tag, "train-zoo", True)
    baseline = settled_memory()
    cpu_err, copy = timed("train-zoo: fp32 copy vs CPU", train_fp32_copy,
                          TRAIN_ZOO_ARCH, 2, tag, "train-zoo")
    timed("train-zoo: fp32 copy's Adam step vs CPU", fp32_adam_step, copy,
          tag, "train-zoo")
    del copy
    release(baseline, "the fp32 copy")
    timed("train-zoo: the train CLI", train_cli, "train-zoo", TRAIN_ZOO_ARCH,
          True, 3, (8, 64))
    release(baseline, "the train CLI")
    errs = timed("check flash_attention_bwd", check_flash_bwd)
    rows, time_err = timed("time flash_attention_bwd", time_flash_bwd,
                           launches["flash_attention_bwd"], tag)
    fwd_rows, fwd_err = timed("time flash_attention at the train shape",
                              time_flash, launches["flash_attention"], tag,
                              ())
    release(baseline, "the flash backward's checks")
    print(f"[train-zoo] {tag}: phase {time.perf_counter() - t_phase:.2f} s; "
          f"fp32 copy vs CPU {cpu_err:.3e}")
    return {"launches": launches, "rows": rows, "fwd_rows": fwd_rows,
            "fwd_err": fwd_err, "bwd_err": errs[torch.float32]}


SSD_GRADS = ("dxd", "da", "dB", "dC")


def ssd_bwd_inputs(B, L, H, P, N, kind, dtype, chunk, seed, with_state):
    """``ssd_inputs`` and the cotangents on the card: dy [B, L, H, P] in
    ``dtype``, dstate [B, H, P, N] fp32 (None unless ``with_state``)."""
    xd, a, Bm, Cm = ssd_inputs(B, L, H, P, N, kind, dtype, chunk, seed=seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    dy = torch.randn(xd.shape, generator=g, device="cuda").to(dtype)
    ds = (torch.randn((B, H, P, N), generator=g, device="cuda")
          if with_state else None)
    return xd, a, Bm, Cm, dy, ds


def ssd_bwd_err(got, want, dtype, what) -> float:
    """The backward's (dxd, da, dB, dC) against the plain version's: each
    in its input's dtype, finite, and within SSD_BWD_FP32_REL (fp32) or
    SSD_BWD_BF16_REL (bf16) of its max |grad|. Returns the largest
    |kernel - plain| over max |grad|, and the largest |kernel - plain|."""
    rel = SSD_BWD_FP32_REL if dtype == torch.float32 else SSD_BWD_BF16_REL
    worst = worst_abs = 0.0
    for name, g, w in zip(SSD_GRADS, got, want):
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"ssd backward {what}: {name} {g.dtype} {tuple(g.shape)}, "
              f"plain {w.dtype} {tuple(w.shape)}")
        check(bool(torch.isfinite(g).all()),
              f"ssd backward {what}: {name} is not finite")
        err = float((g.float() - w.float()).abs().max())
        top = float(w.float().abs().max())
        check(err <= rel * top,
              f"ssd backward disagrees with its plain version at {what}: "
              f"{name} max err {err}, max |grad| {top} (bound {rel})")
        worst = max(worst, err / max(top, 1e-30))
        worst_abs = max(worst_abs, err)
    return worst, worst_abs


def check_ssd_bwd() -> dict:
    """The SSD backward kernel against ``ssd_scan_bwd_ref`` on the card,
    on the same inputs and cotangents, over SSD_BWD_CASES at the three
    decays, fp32 and bf16, with and without dstate in turn, through the
    autograd Function the path runs (one forward and one backward
    launch); a second launch bitwise the first, and the rows of B = 1
    launches (the first and the last) bitwise the batch's; then a
    mid-chunk clip at Mamba2's instantiation, kernel and plain version
    each read against float64. Returns the largest |kernel - plain| over
    max |grad| by dtype, and "abs", the largest |kernel - plain| in
    fp32."""
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.kernels.ssd.ops import ssd_scan
    from repro_torch.kernels.ssd.ref import ssd_scan_bwd_ref

    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    fp32_abs = 0.0
    n = 0
    for B, L, H, P, N, K in SSD_BWD_CASES:
        for kind in SSD_DRAWS:
            for dt in worst:
                n += 1
                what = f"({B}, {L}, {H}, {P}, {N}, {K}) {kind} {dt}"
                xd, a, Bm, Cm, dy, ds = ssd_bwd_inputs(
                    B, L, H, P, N, kind, dt, K, 300 + 7 * n, n % 2 == 0)
                leaves = [t.clone().requires_grad_() for t in (xd, a, Bm, Cm)]
                before = (ssd_kernel.SSD_LAUNCHES.total,
                          ssd_kernel.SSD_BWD_LAUNCHES.total)
                y, s = ssd_scan(*leaves, chunk=K)
                torch.autograd.backward((y, s) if ds is not None else y,
                                        (dy, ds) if ds is not None else dy)
                check((ssd_kernel.SSD_LAUNCHES.total,
                       ssd_kernel.SSD_BWD_LAUNCHES.total)
                      == (before[0] + 1, before[1] + 1),
                      f"ssd backward at {what}: not one forward and one "
                      f"backward launch")
                got = [t.grad for t in leaves]
                want = ssd_scan_bwd_ref(xd, a, Bm, Cm, K, dy, ds)
                rel, err = ssd_bwd_err(got, want, dt, what)
                worst[dt] = max(worst[dt], rel)
                if dt == torch.float32:
                    fp32_abs = max(fp32_abs, err)
                again = ssd_kernel.ssd_scan_bwd_cuda(xd, a, Bm, Cm, K, dy, ds)
                torch.cuda.synchronize()
                check(all(torch.equal(g, h) for g, h in zip(got, again)),
                      f"ssd backward at {what}: two launches differ")
                for i in sorted({0, B - 1} if B > 1 else ()):
                    one = ssd_kernel.ssd_scan_bwd_cuda(
                        *(t[i:i + 1].contiguous()
                          for t in (xd, a, Bm, Cm)), K,
                        dy[i:i + 1].contiguous(),
                        None if ds is None else ds[i:i + 1].contiguous())
                    torch.cuda.synchronize()
                    check(all(torch.equal(o[0], g[i])
                              for o, g in zip(one, got)),
                          f"ssd backward at {what}: row {i} of a B = 1 "
                          f"launch differs from the B = {B} launch's")
                del xd, a, Bm, Cm, dy, ds, leaves, y, s, got, want, again
    parts = []
    for dt in worst:
        args = ssd_bwd_inputs(2, 300, 4, 64, 128, "clip-mid", dt, 128, 977,
                              True)
        got = ssd_kernel.ssd_scan_bwd_cuda(*args[:4], 128, *args[4:])
        plain = ssd_scan_bwd_ref(*args[:4], 128, *args[4:])
        exact = ssd_scan_bwd_ref(*(t.double() for t in args[:4]), 128,
                                 args[4].double(), args[5].double())
        for name, g, p, e in zip(SSD_GRADS, got, plain, exact):
            kern = float((g.double() - e).abs().max())
            ref = float((p.double() - e).abs().max())
            top = float(e.abs().max())
            check(kern <= SSD_F64_FACTOR * ref + 1e-6 * top,
                  f"ssd backward {name} at a mid-chunk clip {dt}: "
                  f"{kern:.3e} from float64, past {SSD_F64_FACTOR} x the "
                  f"plain version's {ref:.3e} + 1e-6 of {top:.3e}")
            parts.append(f"{str(dt)[6:]} {name} {kern / top:.2e} (plain "
                         f"{ref / top:.2e})")
    print(f"[check] ssd backward vs ssd_scan_bwd_ref over {n} cases "
          f"(B, L, H, P, N, chunk) {SSD_BWD_CASES} x {SSD_DRAWS} x fp32, "
          f"bf16, dstate in turn, through the autograd Function: max "
          f"|kernel - plain| / max |grad| fp32 {worst[torch.float32]:.3e} "
          f"(bound {SSD_BWD_FP32_REL}), bf16 {worst[torch.bfloat16]:.3e} "
          f"(bound {SSD_BWD_BF16_REL}); a second launch bitwise the first, "
          f"the rows of B = 1 launches bitwise the batch's; at a mid-chunk "
          f"clip (2, 300, 4, 64, 128, 128), |x - float64| / max |grad| of "
          f"the kernel (and of the plain version): " + "; ".join(parts))
    return dict(worst, abs=fp32_abs)


def ssd_bwd_bytes(B, L, H, P, N, K, itemsize=2):
    """The bytes the SSD backward must move: xd, dy and dxd, B_, C_, dB
    and dC (``itemsize`` bytes), a and da (fp32), each once."""
    return itemsize * (3 * B * L * H * P + 4 * B * L * N) + 4 * 2 * B * L * H


def ssd_bwd_bound(B, L, H, P, N, K, itemsize=2):
    """The SSD backward at the card's peak: xd, dy and dxd, B_, C_, dB
    and dC (``itemsize`` bytes), a and da (fp32) each moved once at the
    memory rate; the products this L needs, chunk by chunk over its r
    valid rows on the r (r + 1) / 2 pairs j <= i: C B^T once, the heads
    share it (2 N a pair); per head D = (dy xd^T) o Lmat, then (scores
    o Lmat)^T dy, D B and D^T C (2 (2 N + 2 P) a pair in all), and the
    five with a state (the states' recomputation, dS's walk, B dS^T, dy
    S and xd dS: 10 r N P), at the tensor cores' bf16 peak (the fp32
    peak for fp32 inputs)."""
    nbytes = ssd_bwd_bytes(B, L, H, P, N, K, itemsize)
    ops = 0
    for t0 in range(0, L, K):
        r = min(K, L - t0)
        pairs = r * (r + 1) // 2
        ops += B * (2 * pairs * N
                    + H * (2 * pairs * (2 * N + 2 * P) + 10 * r * N * P))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / (BF16_OPS_PER_S if itemsize == 2 else FP32_OPS_PER_S) * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"),
            ops)


def time_ssd_bwd(launches: dict, tag: str, shapes=SSD_TRAIN):
    """The SSD backward (bf16) at every shape of the train path and at
    ``shapes``: held against its plain version there first, then its
    device time (``graph_ms``) beside the plain version's and its bound
    (no single PyTorch call computes this gradient). Returns rows by
    shape and the largest relative |kernel - plain|."""
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.kernels.ssd.ref import ssd_scan_bwd_ref

    rows, worst = {}, 0.0
    for shape in sorted(set(launches) | set(shapes)):
        B, L, H, P, N, K = shape
        xd, a, Bm, Cm, dy, _ = ssd_bwd_inputs(
            B, L, H, P, N, "sweep", torch.bfloat16, K, B * 7 + L, False)
        err = ssd_bwd_err(ssd_kernel.ssd_scan_bwd_cuda(xd, a, Bm, Cm, K, dy),
                          ssd_scan_bwd_ref(xd, a, Bm, Cm, K, dy),
                          torch.bfloat16, str(shape))[0]
        worst = max(worst, err)
        (bnd, by), ops = ssd_bwd_bound(*shape)
        scratch = 4 * ssd_kernel.bwd_scratch_floats(*shape, bf16=True)
        rows[shape] = {
            "ms": graph_ms(lambda: ssd_kernel.ssd_scan_bwd_cuda(
                xd, a, Bm, Cm, K, dy), 3, 7),
            "plain_ms": graph_ms(lambda: ssd_scan_bwd_ref(
                xd, a, Bm, Cm, K, dy), 3, 5),
            "library_ms": None, "bound_ms": bnd, "bound_by": by,
            "max_abs_err": err}
        r = rows[shape]
        print(f"[time] {tag}: ssd_scan_bwd {shape} bf16: kernel "
              f"{r['ms'] * 1e3:.2f} us = {ops / (r['ms'] * 1e-3) / 1e12:.2f} "
              f"TFLOP/s (the bound's operations over its time), plain "
              f"{r['plain_ms'] * 1e3:.2f} us, bound "
              f"{r['bound_ms'] * 1e3:.3f} us ({by}; {ops / 1e9:.2f} GFLOP) "
              f"= {100 * r['bound_ms'] / r['ms']:.2f} % of the kernel's "
              f"time; scratch {scratch:,} bytes written and read back "
              f"(the bound's {ssd_bwd_bytes(*shape):,} bytes moved); "
              f"|kernel - plain| {err:.3e} of max |grad|; no library "
              f"call; {launches.get(shape, 0)} launches on the main path")
        del xd, a, Bm, Cm, dy
    return rows, worst


def ssd_bwd_probe(tag: str) -> None:
    """``--ssd-bwd``: the bf16 SSD backward as Mamba2-370M's and
    Zamba2-2.7B's training launch it, at SSD_TRAIN: device us a launch
    (``graph_ms``) beside its plain version's, and a digest of dxd, da,
    dB and dC's bytes on seeded inputs. Prints one JSON line; the keys of
    Mamba2's shape are those of the probe's first form (one shape)."""
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.kernels.ssd.ref import ssd_scan_bwd_ref

    out = {"ssd_bwd": tag, "root": str(ROOT)}
    for i, shape in enumerate(SSD_TRAIN):
        B, L, H, P, N, K = shape
        xd, a, Bm, Cm, dy, _ = ssd_bwd_inputs(B, L, H, P, N, "sweep",
                                              torch.bfloat16, K, B * 7 + L,
                                              False)
        grads = ssd_kernel.ssd_scan_bwd_cuda(xd, a, Bm, Cm, K, dy)
        torch.cuda.synchronize()
        row = {"shape": "x".join(map(str, shape)),
               "us": 1e3 * graph_ms(lambda: ssd_kernel.ssd_scan_bwd_cuda(
                   xd, a, Bm, Cm, K, dy), 3, 11),
               "plain_us": 1e3 * graph_ms(lambda: ssd_scan_bwd_ref(
                   xd, a, Bm, Cm, K, dy), 3, 5),
               "digest": hashlib.sha256(b"".join(
                   t.contiguous().view(torch.uint8).cpu().numpy().tobytes()
                   for t in grads)).hexdigest()[:16]}
        if i == 0:
            out.update(row)
        else:
            out.setdefault("more", []).append(row)
        del xd, a, Bm, Cm, dy, grads
    print(json.dumps(out))


def train_launches(cfg, B: int, S: int) -> dict:
    """The kernel launches of one training step (a gradient) of a zoo
    config under remat, by kernel and shape as ``read_counters``: 2
    forward launches and 1 backward of the flash kernel an attention
    layer (the hybrid's: a run of the shared block, one a stage), and of
    the SSD scan a Mamba2 layer."""
    L = cfg.n_layers
    want = {}
    if cfg.family in ("ssm", "hybrid"):
        ssd = (B, S, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
               cfg.ssm_chunk)
        want = {"ssd_scan": {ssd: 2 * L}, "ssd_scan_bwd": {ssd: L}}
    attn = {"ssm": 0, "hybrid": L // max(cfg.attn_every, 1)}.get(cfg.family,
                                                                 L)
    if attn:
        key = flash_key((B, S, S, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim),
                        None)
        want.update(flash_attention={key: 2 * attn},
                    flash_attention_bwd={key: attn})
    return want


def launches_ok(got: dict, want: dict, what: str) -> None:
    check(all(got[k] == want.get(k, {}) for k in got),
          f"{what}: launches {got}, {want} expected, nothing else")


# the bf16 device kernels a training step's launches run, by counter (the
# tensor-core forwards and the backwards' kernels), and those it must not
# run (the fp32 CUDA-core ones)
STEP_SYMBOLS = {"flash_attention": (FLASH_SYMBOL,),
                "flash_attention_bwd": FLASH_BWD_BF16_SYMBOLS,
                "ssd_scan": (SSD_SYMBOL,), "ssd_scan_bwd": SSD_BWD_SYMBOLS}
STEP_FP32_SYMBOLS = (FLASH_BWD_SYMBOLS + SSD_BWD_FP32_SYMBOLS
                     + (FLASH_FP32_SYMBOL, SSD_FP32_SYMBOL))


def train_zoo_model(arch: str, n_layers: int, steps: int, tag: str,
                    phase: str, profiled: bool) -> dict:
    """One model of a training phase (``phase``: [train-zoo],
    [train-ssm]), alone on the card (at most 1 GiB allocated when it
    starts): ``arch`` at full width cut to ``n_layers`` (bf16, remat,
    random weights from seed 0). (a) Step 0's loss and gradient
    (``launch.specs.loss_and_grad``) twice: bitwise the same, with
    exactly ``train_launches`` and no other kernel; (b) ``steps`` steps
    of ``make_train_step`` (Adam, clip 1.0) on TRAIN_ZOO_BATCH tokens,
    the counts zeroed before each and read after it (the same counts a
    step; no plain version on the card), each loss finite, ms a step and
    tokens/s (the median after step 0), the peak memory under
    TRAIN_ZOO_PEAK_GIB; (c) with ``profiled``, one more step under the
    profiler: the device's busy share, each launched kernel's share
    (STEP_SYMBOLS; none of STEP_FP32_SYMBOLS may run) and the matrix
    products'. Returns the launches by kernel and shape of (b) and
    (c)."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_token_batch
    from repro_torch.launch.specs import loss_and_grad, make_train_step
    from repro_torch.models.transformer import init_lm
    from repro_torch.tree import tree_leaves

    baseline = settled_memory()
    check(baseline < 2**30, f"[{phase}] {arch} starts with "
                            f"{baseline / 2**30:.2f} GiB allocated")
    cfg = cut_depth(get_config(arch), n_layers)
    check(cfg.dtype == "bfloat16" and cfg.remat,
          f"{cfg.name} is not trained in bf16 with remat")
    t0 = time.perf_counter()
    params = init_lm(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in named_leaves(params))
    B, S = TRAIN_ZOO_BATCH
    batches = [torch.as_tensor(synthetic_token_batch(B, S, cfg.vocab,
                                                     seed=i),
                               dtype=torch.long, device="cuda")
               for i in range(steps + profiled)]
    want = train_launches(cfg, B, S)
    # (a) step 0's gradient twice, its peak apart from the earlier phases'
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    with no_plain_version_on_the_card() as plain_calls:
        loss_a, grads_a = loss_and_grad(cfg, params, batches[0])
        torch.cuda.synchronize()
        launches_ok(read_counters(), want, f"{arch} step 0's gradient")
        loss_b, grads_b = loss_and_grad(cfg, params, batches[0])
        torch.cuda.synchronize()
    check(not plain_calls, f"plain versions ran on the card: {plain_calls}")
    leaves_a, leaves_b = tree_leaves(grads_a), tree_leaves(grads_b)
    check(torch.equal(loss_a, loss_b) and len(leaves_a) == len(leaves_b)
          and all(torch.equal(a, b) for a, b in zip(leaves_a, leaves_b)),
          f"{arch}: step 0's loss and gradients differ between two runs")
    check(all(float(g.abs().max()) > 0 for g in leaves_a),
          f"{arch}: a gradient leaf of step 0 is all zeros")
    grad_peak = torch.cuda.max_memory_allocated() / 2**30
    loss0 = float(loss_a)
    del loss_a, loss_b, grads_a, grads_b, leaves_a, leaves_b
    # (b) the steps, from an empty cache: the gradient runs' freed
    # activations would otherwise split the blocks Adam's updates need
    settled_memory()
    step, opt = make_train_step(cfg, lr=TRAIN_ZOO_LR)
    state = opt.init(params)
    torch.cuda.reset_peak_memory_stats()
    losses, times, launches = [], [], {}
    for i in range(steps):
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with no_plain_version_on_the_card() as plain_calls:
            params, state, loss = step(params, state, batches[i])
            losses.append(float(loss))
        times.append(time.perf_counter() - t0)
        got = read_counters()
        check(not plain_calls, f"{arch} step {i}: plain versions ran on the "
                               f"card: {plain_calls}")
        launches_ok(got, want, f"{arch} step {i}")
        launches = merge_launches(launches, {k: got[k] for k in want})
    peak = torch.cuda.max_memory_allocated() / 2**30
    reserved = torch.cuda.max_memory_reserved() / 2**30
    check(all(np.isfinite(losses)), f"{arch} losses {losses}")
    check(losses[0] == loss0,
          f"{arch} step 0's loss {losses[0]} != its gradient run's {loss0}")
    check(peak < TRAIN_ZOO_PEAK_GIB, f"{arch}: a step's peak {peak:.2f} GiB")
    step_ms = 1e3 * statistics.median(times[1:])
    prof = ""
    if profiled:
        box = [params, state]

        def drive():
            box[0], box[1], _ = step(box[0], box[1], batches[steps])

        reset_counters()
        wall, busy, kernels = profile(
            f"{cfg.name} ({cfg.n_layers} layers) train step {B} x {S}",
            drive, tag)
        got = read_counters()
        launches_ok(got, want, f"{arch} profiled step")
        launches = merge_launches(launches, {k: got[k] for k in want})
        fp32 = [name for _, _, name in kernels
                if any(s in name for s in STEP_FP32_SYMBOLS)]
        check(not fp32, f"the bf16 step ran fp32 CUDA-core kernels: {fp32}")
        shares = []
        for k in want:
            parts = [sum(us for us, _, name in kernels if s in name)
                     for s in STEP_SYMBOLS[k]]
            check(all(parts), f"the profiled step ran no {k} kernel "
                              f"{STEP_SYMBOLS[k]}: "
                              f"{[name for _, _, name in kernels][:20]}")
            shares.append(f"{k} {sum(parts):.1f} us = "
                          f"{100 * sum(parts) / busy:.2f} %"
                          + (f" ({', '.join(f'{x:.1f}' for x in parts)} us "
                             f"in {', '.join(STEP_SYMBOLS[k])})"
                             if len(parts) > 1 else ""))
        gemm = sum(us for us, _, name in kernels
                   if any(w in name.lower() for w in ("nvjet", "gemm",
                                                      "cutlass", "xmma")))
        prof = (f"; profiled step: wall {wall / 1e3:.1f} ms, busy "
                f"{100 * busy / wall:.2f} %; of the busy time "
                f"{'; '.join(shares)}; matrix products {gemm:.1f} us = "
                f"{100 * gemm / busy:.2f} %")
        del box
    del params, state, batches, loss
    release(baseline, f"{cfg.name} training")
    print(f"[{phase}] {tag}: {arch} at {cfg.n_layers} layers: "
          f"{describe(cfg)}; {n_params} parameters, bf16, remat, drawn on "
          f"the card in {init_s:.2f} s; batch {B} x {S}; step 0's loss "
          f"{loss0:.6f} and every gradient leaf bitwise equal in two runs "
          f"(peak {grad_peak:.2f} GiB); {steps} Adam steps (lr "
          f"{TRAIN_ZOO_LR}, clip 1.0): losses {[round(x, 6) for x in losses]}"
          f", each step exactly {want}, nothing else, no plain version on "
          f"the card; {step_ms:.1f} ms a step (median of steps 1.."
          f"{steps - 1}; {[round(1e3 * t, 1) for t in times]}), "
          f"{B * S / (step_ms / 1e3):.0f} tokens/s; peak {peak:.2f} GiB "
          f"allocated (bound {TRAIN_ZOO_PEAK_GIB}), {reserved:.2f} GiB "
          f"reserved{prof}; memory back to {baseline / 2**30:.3f} GiB")
    return launches


def train_ssm_main_path(tag: str) -> dict:
    """The [train-ssm] phase: ``train_zoo_model`` for Mamba2-370M at full
    depth (TRAIN_ZOO_STEPS steps and a profiled one) and Zamba2-2.7B at
    TRAIN_ZAMBA_LAYERS (TRAIN_ZAMBA_STEPS steps); each one's fp32 copy
    against the CPU (``train_fp32_copy``: Mamba2 2 layers, Zamba2 one
    stage); the training CLI (``train_cli``) at Mamba2's full config;
    ``check_ssd_bwd``,
    ``time_ssd_bwd`` at the path's shapes, and the forward kernels at
    the path's shapes (``time_ssd``; Zamba2's shared block through
    ``time_flash`` and ``time_flash_bwd``). Returns the launches by
    kernel and shape, the kernels' rows and their largest errors."""
    t_phase = time.perf_counter()
    launches = merge_launches(
        train_zoo_model(TRAIN_SSM_ARCH, 48, TRAIN_ZOO_STEPS, tag,
                        "train-ssm", True),
        train_zoo_model(ZAMBA_ARCH, TRAIN_ZAMBA_LAYERS, TRAIN_ZAMBA_STEPS,
                        tag, "train-ssm", False))
    baseline = settled_memory()
    cpu_err = max(
        timed("train-ssm: Mamba2 fp32 copy vs CPU", train_fp32_copy,
              TRAIN_SSM_ARCH, 2, tag, "train-ssm")[0],
        timed("train-ssm: Zamba2 fp32 copy vs CPU", train_fp32_copy,
              ZAMBA_ARCH, ZAMBA_CPU_LAYERS, tag, "train-ssm")[0])
    release(baseline, "the fp32 copies")
    timed("train-ssm: the train CLI", train_cli, "train-ssm", TRAIN_SSM_ARCH,
          False, 2)
    release(baseline, "the train CLI")
    errs = timed("check ssd_scan_bwd", check_ssd_bwd)
    rows, time_err = timed("time ssd_scan_bwd", time_ssd_bwd,
                           launches["ssd_scan_bwd"], tag)
    fwd_rows, fwd_err = timed("time ssd_scan at the train shapes", time_ssd,
                              launches["ssd_scan"], tag, ())
    flash_rows, flash_err = timed(
        "time flash_attention at Zamba2's train shape", time_flash,
        launches["flash_attention"], tag, ())
    flash_bwd_rows, flash_bwd_err = timed(
        "time flash_attention_bwd at Zamba2's train shape", time_flash_bwd,
        launches["flash_attention_bwd"], tag, ())
    release(baseline, "the SSD backward's checks")
    print(f"[train-ssm] {tag}: phase {time.perf_counter() - t_phase:.2f} s; "
          f"fp32 copies vs CPU {cpu_err:.3e}")
    return {"launches": launches, "rows": rows, "fwd_rows": fwd_rows,
            "fwd_err": fwd_err, "flash_rows": flash_rows,
            "flash_err": flash_err, "flash_bwd_rows": flash_bwd_rows,
            "bwd_err": errs["abs"]}


def kernel_entry(name, source, replaces, rows, launches, max_err) -> dict:
    """One kernel's line of the report: times weighted by its launches at
    each shape on the main paths. ``library_ms`` is weighted over the
    launches whose shape has a library call; where some shapes have none
    (flash with a window), ``library_launches`` says how many launches
    it covers. The backward's line adds the forward and backward kernels
    plus the weight gradients beside torch.lstm's forward and
    backward."""
    n = sum(launches.values())

    def weighted(key, over=launches):
        if any(rows[s][key] is None for s in over):
            return None
        return sum(k * rows[s][key] for s, k in over.items()) / sum(
            over.values())

    lib = {s: k for s, k in launches.items()
           if rows[s]["library_ms"] is not None}
    entry = {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": n, "max_abs_err": max_err,
        "ms": weighted("ms"), "plain_ms": weighted("plain_ms"),
        "bound_ms": weighted("bound_ms"),
        "bound_by": rows[max(launches, key=launches.get)]["bound_by"],
        "library_ms": weighted("library_ms", lib) if lib else None}
    if lib and len(lib) < len(launches):
        entry["library_launches"] = sum(lib.values())
    for key in ("fwd_bwd_ms", "library_fwd_bwd_ms"):
        if all(key in rows[s] for s in launches):
            entry[key] = weighted(key)
    entry["shapes"] = {"x".join(map(str, s[:6])) + "".join(
        f" window {w}" if isinstance(w, int) else f" {w}" for w in s[6:]): k
        for s, k in launches.items()}
    return entry


def timed(label: str, fn, *args):
    """Run one phase and print its seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[phase] {label}: {time.perf_counter() - t0:.2f} s")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs on the card only")
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # cuDNN's RNNs (the torch.lstm yardstick) read a precision of their
    # own, which allow_tf32 does not set in every version
    torch.backends.cudnn.rnn.fp32_precision = "ieee"

    t_start = time.perf_counter()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    tag = f"{name} | {card}"
    probes = {"--flash-host": lambda: flash_host(tag),
              "--flash-ablation": lambda: flash_ablation(card),
              "--ssd-ablation": lambda: ssd_ablation(card),
              "--ssd-bwd-ablation": lambda: ssd_bwd_ablation(card),
              "--lstm-ablation": lambda: lstm_ablation(card),
              "--evl-ablation": lambda: evl_ablation(card),
              "--decode": lambda: (build_kernels(), decode_main_path(tag)),
              "--dense": lambda: (build_kernels(), dense_main_path(tag)),
              "--moe": lambda: (build_kernels(), moe_main_path(tag)),
              "--audio": lambda: (build_kernels(), audio_main_path(tag)),
              "--train-zoo": lambda: (build_kernels(),
                                      train_zoo_main_path(tag)),
              "--train-ssm": lambda: (build_kernels(), check_ssd_sass(),
                                      train_ssm_main_path(tag)),
              "--flash-serve": lambda: flash_serve(tag),
              "--flash-bwd": lambda: flash_bwd_probe(tag),
              "--ssd-bwd": lambda: ssd_bwd_probe(tag)}
    if sys.argv[1:]:
        check(len(sys.argv) == 2 and sys.argv[1] in probes,
              f"arguments {sys.argv[1:]}: give none, or one of "
              f"{sorted(probes)}")
        probes[sys.argv[1]]()
        return
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    timed("build", build_kernels)
    timed("flash SASS", check_flash_sass)
    timed("SSD SASS", check_ssd_sass)
    errs = {"lstm_layer": timed("check lstm_layer", check_forward),
            "lstm_layer_bwd": timed("check lstm_layer_bwd",
                                    check_backward)}
    errs["evl"] = timed("check evl", check_evl)
    errs["flash_attention"] = timed("check flash_attention", check_flash)
    errs["ssd_scan"] = timed("check ssd_scan", check_ssd)
    data = timed("training data", training_data)
    timed("check gradients", check_gradients, data[0])
    fc = timed("check forecaster", check_forecaster)
    serve_launches, payloads, sessions = timed(
        "serve paper-lstm", serve_main_path, fc, tag)
    train_launches, train_step_ms = timed("train paper-lstm",
                                          train_main_path, data, tag)
    timed("paper-lstm CLIs", run_clis, fc.window)
    ckpt_launches = timed("checkpoint bridge", checkpoint_main_path, data,
                          tag)
    sim_launches = timed("simulator (Table II)", simulator_main_path, data,
                         tag)
    online_launches = timed("online (train + serve)", online_main_path,
                            train_step_ms["local SGD W=4 tau=0"], tag)
    paper_launches = {k: v for k, v in merge_launches(
        train_launches, ckpt_launches, sim_launches,
        online_launches).items() if k in PAPER_KERNELS}
    rows, every, path_errs = timed("time paper-lstm kernels", time_kernels,
                                   serve_launches, paper_launches, tag)
    errs = {k: max(errs[k], path_errs.get(k, 0.0)) for k in errs}
    timed("profile paper-lstm serving", profile_serving, fc, payloads,
          sessions, tag)
    timed("profile paper-lstm training", profile_training, data[0], tag)
    timed("profile online", profile_online, tag)
    zoo_fc, qwen_launches, init_s = timed(
        f"serve {ZOO_ARCH}", zoo_serve_main_path, ZOO_ARCH, tag)
    timed(f"{ZOO_ARCH} card vs CPU", zoo_card_vs_cpu, ZOO_ARCH, tag)
    timed(f"{ZOO_ARCH} CLI", zoo_cli, ZOO_ARCH, ("flash_attention",))
    rows["flash_attention"], flash_err = timed(
        "time flash_attention", time_flash, qwen_launches["flash_attention"],
        tag)
    errs["flash_attention"] = max(errs["flash_attention"], flash_err)
    timed("flash host cost", flash_host, tag)
    timed(f"profile {ZOO_ARCH} serving", profile_zoo, zoo_fc,
          {"flash_attention": FLASH_SYMBOL}, tag, (FLASH_FP32_SYMBOL,))
    print(f"[zoo] {ZOO_ARCH} init (draw on the card + calibrate): "
          f"{init_s:.2f} s")
    del zoo_fc
    mamba_fc, mamba_launches, mamba_init_s = timed(
        f"serve {MAMBA_ARCH}", zoo_serve_main_path, MAMBA_ARCH, tag)
    timed(f"{MAMBA_ARCH} card vs CPU", zoo_card_vs_cpu, MAMBA_ARCH, tag,
          MAMBA_NOISE)
    timed(f"{MAMBA_ARCH} CLI", zoo_cli, MAMBA_ARCH, ("ssd_scan",))
    ssd_launches = merge_launches(mamba_launches,
                                  ckpt_launches)["ssd_scan"]
    rows["ssd_scan"], ssd_err = timed("time ssd_scan", time_ssd,
                                      ssd_launches, tag)
    errs["ssd_scan"] = max(errs["ssd_scan"], ssd_err)
    timed(f"profile {MAMBA_ARCH} serving", profile_zoo, mamba_fc,
          {"ssd_scan": SSD_SYMBOL}, tag, (SSD_FP32_SYMBOL,))
    print(f"[zoo] {MAMBA_ARCH} init (draw on the card + calibrate): "
          f"{mamba_init_s:.2f} s")
    del mamba_fc
    zamba_fc, zamba_launches, zamba_init_s = timed(
        f"serve {ZAMBA_ARCH}", zoo_serve_main_path, ZAMBA_ARCH, tag,
        ZAMBA_BURSTS)
    timed(f"{ZAMBA_ARCH} card vs CPU", zoo_card_vs_cpu, ZAMBA_ARCH, tag,
          MAMBA_NOISE, ZAMBA_CPU_LAYERS)
    timed(f"{ZAMBA_ARCH} CLI", zoo_cli, ZAMBA_ARCH,
          ("ssd_scan", "flash_attention"))
    errs["ssd_scan"] = max(errs["ssd_scan"], timed(
        f"check ssd_scan at {ZAMBA_ARCH}'s shapes", check_ssd_shapes,
        ZAMBA_SSD, 500)[0])
    zamba_rows, flash_err = timed(
        f"time flash_attention at {ZAMBA_ARCH}'s shapes", time_flash,
        zamba_launches["flash_attention"], tag, ZAMBA_FLASH)
    rows["flash_attention"].update(zamba_rows)
    errs["flash_attention"] = max(errs["flash_attention"], flash_err)
    zamba_rows, ssd_err = timed(
        f"time ssd_scan at {ZAMBA_ARCH}'s shapes", time_ssd,
        zamba_launches["ssd_scan"], tag, ZAMBA_SSD)
    rows["ssd_scan"].update(zamba_rows)
    errs["ssd_scan"] = max(errs["ssd_scan"], ssd_err)
    timed(f"profile {ZAMBA_ARCH} serving", profile_zoo, zamba_fc,
          {"ssd_scan": SSD_SYMBOL, "flash_attention": FLASH_SYMBOL}, tag,
          (SSD_FP32_SYMBOL, FLASH_FP32_SYMBOL), ZAMBA_BURSTS)
    print(f"[zoo] {ZAMBA_ARCH} init (draw on the card + calibrate): "
          f"{zamba_init_s:.2f} s")
    del zamba_fc
    every.update(merge_launches(qwen_launches, {"ssd_scan": ssd_launches},
                                zamba_launches))
    decode = timed("decode (prefill, decode steps, flush)", decode_main_path,
                   tag)
    for k, timer in (("flash_attention", time_flash), ("ssd_scan", time_ssd)):
        new = {s: n for s, n in decode["launches"][k].items()
               if s not in rows[k]}
        new_rows, err = timed(f"time {k} at the decode prefills' shapes",
                              timer, new, tag, ())
        rows[k].update(new_rows)
        errs[k] = max(errs[k], err)
    every = merge_launches(every, {k: decode["launches"][k] for k in (
        "flash_attention", "ssd_scan")})
    dense = timed("dense zoo and VLM (serve, decode)", dense_main_path, tag)
    rows["flash_attention"].update(dense["rows"])
    errs["flash_attention"] = max(errs["flash_attention"], dense["err"])
    every = merge_launches(every, dense["launches"])
    moe = timed("MoE family (serve, decode)", moe_main_path, tag)
    rows["flash_attention"].update(moe["rows"])
    errs["flash_attention"] = max(errs["flash_attention"], moe["err"])
    every = merge_launches(every, moe["launches"])
    audio = timed("audio family (serve, decode)", audio_main_path, tag)
    rows["flash_attention"].update(audio["rows"])
    errs["flash_attention"] = max(errs["flash_attention"], audio["err"])
    every = merge_launches(every, audio["launches"])
    train = timed("zoo training (train-zoo)", train_zoo_main_path, tag)
    rows["flash_attention"].update(train["fwd_rows"])
    errs["flash_attention"] = max(errs["flash_attention"], train["fwd_err"])
    every = merge_launches(every, train["launches"])
    rows["flash_attention_bwd"] = train["rows"]
    errs["flash_attention_bwd"] = train["bwd_err"]
    ssm = timed("SSM training (train-ssm)", train_ssm_main_path, tag)
    rows["ssd_scan"].update(ssm["fwd_rows"])
    errs["ssd_scan"] = max(errs["ssd_scan"], ssm["fwd_err"])
    rows["flash_attention"].update(ssm["flash_rows"])
    errs["flash_attention"] = max(errs["flash_attention"], ssm["flash_err"])
    rows["flash_attention_bwd"].update(ssm["flash_bwd_rows"])
    every = merge_launches(every, ssm["launches"])
    rows["ssd_scan_bwd"] = ssm["rows"]
    errs["ssd_scan_bwd"] = ssm["bwd_err"]
    rows["ssd_chunk"], every["ssd_chunk"], errs["ssd_chunk"] = \
        decode["ssd_chunk"]
    csrc = "src/repro_torch/kernels/{}/csrc/{}"
    meta = {
        "lstm_layer": (csrc.format("lstm", "lstm_layer.cu"),
                       "src/repro/kernels/lstm/kernel.py:21"),
        "lstm_layer_bwd": (csrc.format("lstm", "lstm_layer_bwd.cu"),
                           "src/repro/kernels/lstm/kernel.py:21"),
        "evl": (csrc.format("evl", "evl.cu"),
                "src/repro/kernels/evl/kernel.py:20"),
        "flash_attention": (csrc.format("attention",
                                        "flash_attention_wgmma.cu"),
                            "src/repro/kernels/attention/kernel.py:34"),
        "flash_attention_bwd": (csrc.format("attention",
                                            "flash_attention_bwd_wgmma.cu"),
                                "src/repro/kernels/attention/kernel.py:34"),
        "ssd_scan": (csrc.format("ssd", "ssd_scan_wgmma.cu"),
                     "src/repro/kernels/ssd/kernel.py:27"),
        "ssd_scan_bwd": (csrc.format("ssd", "ssd_scan_bwd_wgmma.cu"),
                         "src/repro/kernels/ssd/kernel.py:27"),
        "ssd_chunk": (csrc.format("ssd", "ssd_scan.cu"),
                      "src/repro/kernels/ssd/ops.py:36")}
    entries = [kernel_entry(k, *meta[k], rows[k], every[k], errs[k])
               for k in meta]
    print(f"[phase] total: {time.perf_counter() - t_start:.2f} s")
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
