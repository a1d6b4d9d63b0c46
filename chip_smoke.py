#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it.

Run from the repository root: `python3 chip_smoke.py`.  Seventeen phases,
any failure exits nonzero:

1. gate: a CUDA device must be present (there is no CPU path); prints the
   card's name and power limit as nvidia-smi reports them;
2. build: compiles the CUDA kernels from multimodal_transformer_tpu_torch/csrc
   and prints registers, shared memory and spills of kernel 11's wgmma path,
   kernel B's stages and kernel A's wgmma path (its row chain and attention
   kernels) and of kernels 4 and 5's wgmma path (csrc/encoder_bwd.cu) and
   kernel 3's (kernel A's row chain in its training instantiation, kernel
   4's attention forward without row statistics): any spill in enc_wgmma
   or enc_bwd fails the run, and so does a build log without a spill report
   for each of their kernels; and whether their SASS holds HGMMA (and
   UTMALDG where they load by TMA): kernel A's and kernels 3, 4 and 5's
   wgmma kernels must, and the run fails when cuobjdump cannot read them;
   likewise the
   ptxas lines of kernel 7's stages (csrc/mfn_train.cu) and of kernel B's
   (csrc/mfn.cu, namespace mfn_staged: every instantiation, those of
   kernel 6 and rows 8 and 9 among them), and of kernel
   10's wgmma route (namespace wembed_tc, every instantiated width) and its
   fp32 160-channel tile, where any spill fails the run; kernel 10's wgmma
   route must hold HGMMA and UTMALDG;
3. kernels: each serving kernel against its plain PyTorch version on the
   card, at the main path's shapes, fp32 and bf16, within the competitive
   bound err(kernel - fp64 plain) <= 2 * err(plain - fp64 plain) + 1e-6:
   the encoder stack (B=32 at T = 160, 137 and 544; in bf16 also d_k = 16
   (D = 128), one video at T = 1, 37, 100 and 512 (the wgmma path's score
   tiles of 64 to 256 keys) and the emotient encoder's D = 16 (d_k = 2, the
   FMA path), each bf16 case also bit-identical when called again, then the
   device time of each of its kernels at B=32, T=160 from torch.profiler),
   the MFN recurrence
   (kernel B, also at a ragged
   shape, with the emotient modality, at B=2, T=1,120 and at B=1, T=37,
   bit-identical when called again, and each of its three stages' device
   time at B=32, T=160 from torch.profiler) and its packed and aligned
   variants, rows 8 and 9, which launch kernel B's stages on views of
   their packed and padded tensors (also at the ragged and emotient
   shapes; packed bit-identical to kernel B, aligned on a workspace filled
   with NaN, also at the TPU kernel's padding of 128, and within the MFN
   bench's tolerance of kernel B; both bit-identical when called again;
   then their stages' device time), the window embed at
   the front end's four shapes (bf16 on the wgmma route, bit-identical when
   called again, each with its device ms per launch from torch.profiler
   beside its burst time; also at B=1, T=37) and a ragged one (the tiles
   route), plus the gradients of its autograd Function (bf16 forward on the
   wgmma route), and flash attention (kernel 11) at
   the long-video buckets' shapes, a ragged case with d_k = 2 and videos
   with no key, and its Function's gradients;
4. slice: ValencePredictor at full MFT A+V+L widths (random weights from a
   seed) answers 3 requests of 20 videos; traces are checked for length,
   finiteness, determinism and against the plain fp32 forward; the launch
   counters of the three kernels on that path must show the main path went
   through them; B=32, T=160 bf16 forwards are timed;
5. MFN variants: bench_mfn_kernel.py's four candidates (plain recurrence,
   kernel B, aligned, packed, each with the head) for MFT A+V+L and B3-MFN
   A+V+L at B=32, T=160, fp32 and bf16, timed and held against the plain
   fp32 output; one forward of each kernel candidate launches its kernel
   once and no other, and the variants agree with kernel B;
6. families: ValencePredictor answers one request of 20 videos for each of
   SFT, B2-Trans, B3-MFN and B1-LSTM (A+V+L), B1-LSTM legacy (L) and MFT
   (L), with the same checks, each family's launch counts and tolerance,
   and timed B=32, T=160 bf16 forwards on both paths;
7. legacy heads and tools: MultiEDLSTM and MultiARLSTM at their default
   widths (embed 128, h 512), B=32, T=160, fp32, within 1e-4 of the same
   modules on the CPU, ms a forward; three MFT A+V+L serving forwards
   (B=32, T=160, bf16) inside `engine.profiling.trace`, whose exported
   Chrome trace must hold every CUDA kernel of every launch of kernels A, B
   and 10 that the launch counters count (found/expected printed, beside
   the runtime's launch events); StepTimer over ten forwards and
   device_memory_stats(); the native SENDv1 parser (native/fastload.cpp)
   built here with g++ and reading a split; the walkthrough (`python -m
   multimodal_transformer_tpu_torch.walkthrough`, 2 epochs) as a
   subprocess: exit 0, its checkpoint, PerfSave, PredSave and served
   traces, its wall time;
8. long videos: one request of 16 videos of 520-1,100 windows (buckets
   544-1,120) for MFT A+V+L, SFT A+V+L, B2-Trans A+V+L and MFT L in bf16,
   with the same checks: every encoder takes the flash route (kernel 11 six
   times per encoder and batch, kernel A never); the MFT A+V+L request is
   profiled; then the B=32 encoder stack through kernel A and through the
   flash route at T = 137, 160, 544, 640 and 1,024, bf16 and fp32,
   alternated;
9. evaluation: Engine.evaluate_per_video and evaluate_batched at full MFT
   A+V+L widths over 24 videos of 20-1,100 windows, fp32 and (batched)
   eval_dtype=bf16: exact launch counts, the per-video CCCs of both paths
   within their tolerance and equal to `ccc` on the returned predictions,
   the `Evaluation` line printed; a "query"-mode per-video evaluation
   launches no encoder kernel;
10. train kernels: the five training kernels (encoder stack forward, layer
   backward and whole-stack backward, MFN forward and reverse recurrence)
   against their plain versions at B=32, T=160 and T=400, and at p = 0
   (the dropout-free route) at T=160, fp32 and bf16, the bound applied to
   every output tensor (dx and each gradient included), the whole-stack
   backward (kernel 5) also bit-identical to six calls of the layer
   backward (kernel 4), the stack forward (kernel 3) bit-identical when
   called again; kernels 3, 4 and 5's bf16 wgmma path also at d_k 16 and
   32, T in {1, 137, 160, 400} and p in {0.1, 0}, and their bf16 FMA path
   at the emotient encoder's D = 16 (d_k = 2), T = 160, p in {0.1, 0}
   (kernels 3 and 5 on 2 layers), each on its path and bit-identical when
   called again; kernels 6 and 7 (the MFN's forward and reverse
   recurrence) bit-identical when called again at every case, also at
   T=400 with p = 0 and at small shapes with L alone and
   emotient+acoustic, both rates, and kernel 6 at B=1, T=37 and B=2,
   T=1,120; then kernels 6 and 7's device ms per stage and kernel 3's and
   kernel 4's device ms per launch name at B=32, T=160 (torch.profiler),
   bf16 and fp32;
11. train: Engine.train_epoch at full MFT A+V+L widths, bf16 mixed with fp32
   masters, dropout on, over 100 synthetic videos of 20-400 windows at
   batch size 25 (launch counters exact, every loss finite), then the same
   epoch with encoder_backward="stack" (kernel 5 in place of kernel 4,
   counted the same way); one fp32 step
   of the kernel path against the plain path from the same parameters,
   batch and seeds (loss within 1e-4 relative, every gradient within 1e-3
   relative L2), read again with the plain front end in place of kernel 10
   and with kernel 10's autograd Function on the plain forward; the same
   step twice gives bit-identical gradients; B=32, T=160 mixed steps are
   timed on both paths and profiled;
12. dropout-free training: fp32 steps without seeds for MFT A+V+L and
   B3-MFN A+V+L at B=32, T=160: the training kernels at p = 0 and never
   kernel A or B, exact launches, every parameter with a gradient that is
   not all zero, loss and gradients within the train phase's limits of the
   plain path; kernels A and B called directly under autograd raise;
13. query mode: an MFT A+V+L forward and one training step in the
   reference's default "query" mask mode, which no encoder kernel takes:
   the encoder kernels' counters stay at 0 while the MFN and window-embed
   kernels launch;
14. families train: Engine steps of SFT (A+V+L and A), B2-Trans A+V+L,
   B3-MFN (A+V+L and A), B1-LSTM A+V+L, B1-LSTM legacy L and MFT L at full
   widths, B=32, T=160: the fp32 kernel-path step against the plain path
   (the train phase's limits), a repeated step bit-identical, the same step
   on the "stack" encoder backward bit-identical to "perlayer", exact
   launch counts per step on both routes; bf16 mixed ms/step from a batch
   on the card and from a host batch; one "query"-mode step;
15. parallel: 2 ranks started by `parallel.spawn` after the build (NCCL
   with a card each, else gloo with both on cuda:0), against one process
   on the same weights and global batches (padded to the ranks as the
   ranks pad them): an fp32 data-parallel epoch of MFT A+V+L, 3 steps of
   the bench recipe (B = 32, 32 and 31, T = 160, dropout on): each step's
   loss within 1e-4, each step's summed gradients and the final
   parameters within the train phase's limits, every rank's parameters
   equal; the same epoch bf16 mixed against the one-process bf16 epoch
   (losses within 1e-4, finite; each step's summed gradients within 16
   times the train limits at step 0 and 100 times at the later steps,
   beside the control of the one-process bf16 step against the fp32
   step); exact
   launches of kernels 3, 4, 6, 7 and 10 on every rank;
   Engine.evaluate_per_video and evaluate_batched over 8 videos of
   20-400 windows and one of 600, CCCs within 1e-4 and exact launches of
   A, B and 10 per rank, and of 11 for the video past 512 windows; the
   tensor-parallel eval forward of B2-Trans and MFT A+V+L over a 1 x 2
   ("data", "model") mesh, B=32, T=160, fp32, within 1e-4 of the one-card
   forward, kernel 11 counted on every rank; ms per bf16 DP step at 2
   ranks and in one process, ms per gradient all_reduce (with the copies
   into and out of the flat buffer, and the collective alone), the
   phase's wall time, each beside the card's name and power limit;
16. CLI: `python -m multimodal_transformer_tpu_torch.train` on the
   synthetic SENDv1 tree that --synthetic_data writes (8/3/3 videos of
   45-75 s, GloVe and BERT features), in a temporary directory: MFT A+V+L
   trained 2 epochs in bf16 mixed precision, key_query, as a subprocess;
   resumed in process for a third epoch (it must log "Resumed from ... at
   epoch 3"; launches exact: kernels 3, 4, 6, 7 and 10 in the step, A, B
   and 10 in the validation); `--eval` and `--test --fast_eval` of the
   `.pth` (exact launches of A, B and 10); `--perf` (14 PerfSave rows); a
   B2-Trans `--resident_train` epoch (kernels 3, 4 and 10); every logged
   loss and CCC finite; the reader, the checkpoint files and epochs with
   and without the prefetcher timed; every split of the training run read
   by the native parser (the CLI's log), and the Train split read with
   the native and the Python parser, alternated;
   `ValencePredictor.from_checkpoint`'s
   Test traces within the slice's bf16 tolerance of the plain fp32 forward
   of the same weights; seconds per epoch and per evaluation pass;
17. train A/B: the MFT A+V+L mixed step with encoder_backward "perlayer"
   and "stack", alternated, ms/step and launches (kernel 5 three times per
   step on "stack", kernel 4 never).

The line before the last is a JSON object with each kernel's launches
(the variants' from phase 5),
error, times, bound (the least time an H100 SXM could take, from the
check's shapes) and, for kernel 11, the time of PyTorch's
scaled_dot_product_attention on the same inputs; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import json
import logging
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

AVL = ("acoustic", "image", "linguistic")
FRAMES = {"acoustic": 4, "image": 4, "linguistic": 32}
# bf16 serving against the plain fp32 forward, absolute, on valence outputs
# of magnitude ~0.06 at this random init: the all-bf16 plain path differs by
# ~1e-3 on the CPU, and the kernel path keeps more of its math in fp32.
SLICE_TOL = 3e-3
REQUESTS, VIDEOS, MIN_WINDOWS, MAX_WINDOWS = 3, 20, 20, 400
BENCH_B, BENCH_T = 32, 160
TRAIN_VIDEOS, TRAIN_BATCH = 100, 25
TRAIN_T = (160, 400)
# one fp32 step, kernel path against plain path: the masks are bit-identical,
# so only the order of float32 sums differs.  A gradient passes when
# |g_kernel - g_plain| <= GRAD_RTOL |g_plain| + GRAD_FLOOR |all grads|: the
# floor covers the k-projection biases, whose gradients are mathematically
# zero (softmax row gradients sum to zero) and so are pure rounding noise.
LOSS_RTOL, GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-3, 1e-6
# The families-train phase's configurations: (name, family, modalities,
# variant).  Their kernels per step follow from the module: kernel 3 and
# kernel 4 (x6) or 5 once per encoder, kernels 6 and 7 for B3-MFN's MFN,
# kernel 10 once per modality but for B1's ReLU Highway.
TRAIN_FAMILIES = (
    ("SFT A+V+L", "SFT", AVL, "default"),
    ("SFT A", "SFT", ("acoustic",), "default"),
    ("B2-Trans A+V+L", "B2-Trans", AVL, "default"),
    ("B3-MFN A+V+L", "B3-MFN", AVL, "default"),
    ("B3-MFN A", "B3-MFN", ("acoustic",), "default"),
    ("B1-LSTM A+V+L", "B1-LSTM", AVL, "default"),
    ("B1-LSTM L legacy", "B1-LSTM", ("linguistic",), "legacy"),
    ("MFT L", "MFT", ("linguistic",), "default"),
)
AB_ROUNDS = 4
# the front end's (frames, mod dim, window embed) at full widths: MFT's
# acoustic, the SFT/B2/B3 acoustic, image and linguistic
WINDOW_EMBED_SHAPES = ((4, 88, 88), (4, 88, 256), (4, 1000, 256),
                       (32, 300, 300))
# (B, T, frames, mod dim, window embed) off the main path: windows longer
# than one 128-row tile and an odd mod dim (the kernel's value-by-value
# copies)
WINDOW_EMBED_RAGGED = (3, 7, 200, 33, 45)
MFT_WINDOW_EMBED = ((4, 88, 88), (4, 1000, 256), (32, 300, 300))
# (B, T) of the long-video phase's front ends: LONG_VIDEOS videos padded to
# 1,120 windows, where kernel 10's wgmma route runs a block's tiles in more
# than one group (all but MFT's acoustic front end)
WINDOW_EMBED_LONG = (16, 1120)
# The serving configurations of the families phase: (name, family,
# modalities, variant, kernel launches per batch, tolerance of the bf16
# kernel path against the plain fp32 forward, absolute, on outputs of
# magnitude ~0.1 at the seeded init).  B3-MFN's MFN keeps its state and
# sums in fp32, like the MFT slice (3e-3).  B2-Trans reads each step's output
# straight off the bf16 encoder output through its MLP, with no recurrence
# to average the rounding (its all-bf16 plain path is itself ~4e-3 off):
# 1e-2.  The LSTM recurrences (UniTransformer decoder, MultiLSTM) run in
# plain PyTorch in bf16, rounding h and c at every one of up to 416 steps;
# on an H100 they stayed within 1.3e-3 of fp32 (PERF.md), and the limit
# keeps ~4x of room: 5e-3.
FAMILIES = (
    ("SFT A+V+L", "SFT", AVL, "default",
     {"window_embed_highway": 3, "encoder_stack_fused": 1}, 5e-3),
    ("B2-Trans A+V+L", "B2-Trans", AVL, "default",
     {"window_embed_highway": 3, "encoder_stack_fused": 1}, 1e-2),
    ("B3-MFN A+V+L", "B3-MFN", AVL, "default",
     {"window_embed_highway": 3, "mfn_scan_fused": 1}, 3e-3),
    ("B1-LSTM A+V+L", "B1-LSTM", AVL, "default", {}, 5e-3),
    ("B1-LSTM L legacy", "B1-LSTM", ("linguistic",), "legacy",
     {"window_embed_highway": 1}, 5e-3),
    ("MFT L", "MFT", ("linguistic",), "default",
     {"window_embed_highway": 1, "encoder_stack_fused": 1}, 5e-3),
)
# kernel 11's checks, (B, h, T, d_k, videos with no key): the long-video
# buckets at D = 256 (d_k = 32) up to the largest (1,120), a ragged T with
# videos with no key, d_k = 16 (the other TMA + wgmma instance), and a
# ragged T with d_k = 2 (the emotient encoder, D = 16); its Function's
# gradients at (B, h, T, d_k)
FLASH_SHAPES = ((32, 8, 544, 32, 0), (32, 8, 640, 32, 0),
                (32, 8, 1024, 32, 0), (32, 8, 1120, 32, 0),
                (32, 8, 601, 32, 2), (32, 8, 544, 16, 0), (5, 8, 601, 2, 2))
FLASH_GRAD = (4, 8, 544, 32)
# long videos: one request of LONG_VIDEOS videos of LONG_MIN..LONG_MAX
# windows, every bucket past 512; (name, family, modalities, kernel
# launches per batch, tolerance against the plain fp32 forward as in the
# families phase).  Each encoder runs kernel 11 once per layer.
LONG_VIDEOS, LONG_MIN, LONG_MAX = 16, 520, 1100
LONG_FAMILIES = (
    ("MFT A+V+L", "MFT", AVL, {"window_embed_highway": 3, "mfn_scan_fused": 1,
                               "flash_attention_masked": 3 * 6}, SLICE_TOL),
    ("SFT A+V+L", "SFT", AVL, {"window_embed_highway": 3,
                               "flash_attention_masked": 6}, 5e-3),
    ("B2-Trans A+V+L", "B2-Trans", AVL, {"window_embed_highway": 3,
                                         "flash_attention_masked": 6}, 1e-2),
    ("MFT L", "MFT", ("linguistic",), {"window_embed_highway": 1,
                                       "flash_attention_masked": 6}, 5e-3),
)
CROSSOVER_T = (137, 160, 544, 640, 1024)
# the long-video route's first bucket: kernel 11's line in the JSON
FLASH_MAIN_T = 544
# kernel A's checks besides B=32 at T in {160, 137, 544}, bf16 only:
# (B, T, D, path) at d_k = D / 8: the wgmma path at d_k = 16 and at one
# video (per-video evaluation: one score tile of 64 keys at T = 37 and 1,
# two online tiles of 256 at T = 512, one tile of 128 at T = 100), and the
# FMA path at the emotient encoder's D = 16 (d_k = 2)
ENCODER_BF16_SHAPES = ((BENCH_B, BENCH_T, 128, "wgmma"),
                       (1, 37, 256, "wgmma"), (1, 1, 256, "wgmma"),
                       (1, 100, 256, "wgmma"), (1, 512, 256, "wgmma"),
                       (BENCH_B, BENCH_T, 16, "fma"))
# evaluation: EVAL_VIDEOS videos of MIN_WINDOWS..LONG_MAX windows with
# unit-normal targets.  The batched CCCs against the per-video ones,
# absolute: fp32 differs only in the order of float32 sums, 1e-4.  In bf16
# the predictions move by at most SLICE_TOL (the slice's bf16 serving
# tolerance); moving a prediction by d moves the covariance with the target
# by at most std(target) * rms(d), and the denominator of the CCC is at least
# var(target), so a CCC moves by at most ~2 * SLICE_TOL / std(target).
EVAL_VIDEOS = 24
EVAL_FP32_TOL = 1e-4
SOURCES = {
    "encoder_stack_fused": ("multimodal_transformer_tpu_torch/csrc/encoder.cu",
                            "multimodal_transformer_tpu/ops/pallas/encoder.py:313"),
    "mfn_scan_fused": ("multimodal_transformer_tpu_torch/csrc/mfn.cu",
                       "multimodal_transformer_tpu/ops/pallas/mfn_kernel.py:145"),
    "encoder_stack_train_fwd": (
        "multimodal_transformer_tpu_torch/csrc/encoder.cu",
        "multimodal_transformer_tpu/ops/pallas/encoder.py:1179"),
    "encoder_layer_bwd": (
        "multimodal_transformer_tpu_torch/csrc/encoder_train.cu",
        "multimodal_transformer_tpu/ops/pallas/encoder.py:1284"),
    "encoder_stack_bwd": (
        "multimodal_transformer_tpu_torch/csrc/encoder_train.cu",
        "multimodal_transformer_tpu/ops/pallas/encoder.py:1469"),
    "mfn_train_fwd": ("multimodal_transformer_tpu_torch/csrc/mfn_train.cu",
                      "multimodal_transformer_tpu/ops/pallas/mfn_train.py:147"),
    "mfn_train_bwd": ("multimodal_transformer_tpu_torch/csrc/mfn_train.cu",
                      "multimodal_transformer_tpu/ops/pallas/mfn_train.py:435"),
    "window_embed_highway": (
        "multimodal_transformer_tpu_torch/csrc/window_embed.cu",
        "multimodal_transformer_tpu/ops/pallas/window_embed.py:63"),
    "flash_attention_masked": (
        "multimodal_transformer_tpu_torch/csrc/flash_attention.cu",
        "multimodal_transformer_tpu/ops/pallas/attention.py:58"),
    "mfn_scan_packed": ("multimodal_transformer_tpu_torch/csrc/mfn_variants.cu",
                        "multimodal_transformer_tpu/ops/pallas/mfn_kernel.py:372"),
    "mfn_scan_aligned": (
        "multimodal_transformer_tpu_torch/csrc/mfn_variants.cu",
        "multimodal_transformer_tpu/ops/pallas/mfn_kernel.py:543"),
}
# the MFN variants' checks: (B, T, modalities) off the main path, a ragged
# case and one with the emotient modality (H = 16, the narrowest pad); the
# aligned variant also at the TPU kernel's padding
MFN_VARIANT_SHAPES = ((3, 7, ("linguistic", "acoustic")),
                      (4, 9, ("emotient", "acoustic")))
TPU_HP = 128
# kernel B's checks besides the main path's and the variants' shapes: a
# long-video bucket and one video (evaluate_per_video)
MFN_B_SHAPES = MFN_VARIANT_SHAPES + ((2, 1120, AVL), (1, 37, AVL))
# the dropout-free training phase's configurations: (name, family)
FREE_TRAIN = (("MFT A+V+L", "MFT"), ("B3-MFN A+V+L", "B3-MFN"))


class SmokeFailure(Exception):
    pass


_START = time.perf_counter()
_PHASE = ["start"]  # the running phase, named in a failure's last line


def phase(name: str) -> None:
    """Starts a phase: its name and the seconds since the script started
    (the run has a time limit; the stamps show which phase spends it)."""
    _PHASE[0] = name
    print(f"== {name} (at {time.perf_counter() - _START:.1f} s)", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        raise SmokeFailure(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# kernel 11's bf16 path at d_k in {16, 32} (TMA + wgmma), by its symbol
FLASH_WGMMA = "flash_wgmma_kernel"
# kernel B's stages (csrc/mfn.cu; also kernel 6's and rows 8 and 9's), by
# their namespace and the kernels whose ptxas report the spill gate
# requires: each scan's eval and training instantiations, the softmax and
# the GEMMs
MFN_STAGED = "mfn_staged"
MFN_STAGED_KERNELS = tuple(f"{k}I{t}Lb{b}E" for k in ("16lstm_scan_kernel",
                                                      "15mem_scan_kernel")
                           for t in ("f", "13__nv_bfloat16")
                           for b in (0, 1)) + ("attend_kernel",
                                               "ff_gemm_kernel")
# kernel A's wgmma path (csrc/encoder.cu), by namespace and kernel
ENC_WGMMA = "enc_wgmma"
ENC_WGMMA_SASS = (("enc_wgmma12chain_kernel", ("HGMMA",)),
                  ("enc_wgmma16attention_kernel", ("HGMMA", "UTMALDG")))
# kernel 3's bf16 wgmma path: kernel A's row chain in its training
# instantiation (csrc/encoder.cu) and kernel 4's attention forward without
# its row statistics (csrc/encoder_bwd.cu), by their mangled names
ENC_TRAIN_FWD_CHAINS = tuple(f"enc_wgmma12chain_kernelILi{D}ELi128ELb1E"
                             for D in (128, 256))
ENC_TRAIN_FWD_ATTN = tuple(f"enc_bwd15attn_fwd_kernelILi{dk}ELb0E"
                           for dk in (16, 32))
ENC_TRAIN_FWD_SASS = tuple((k, ("HGMMA", "UTMALDG"))
                           for k in ENC_TRAIN_FWD_CHAINS + ENC_TRAIN_FWD_ATTN)
# kernels 4 and 5's bf16 wgmma path (csrc/encoder_bwd.cu), by namespace and
# kernel: each product kernel (the sums kernel has none)
ENC_BWD = "enc_bwd"
ENC_BWD_SASS = tuple((f"enc_bwd{len(k)}{k}", wanted) for k, wanted in (
    ("front_kernel", ("HGMMA", "UTMALDG")), ("attn_fwd_kernel", ("HGMMA", "UTMALDG")),
    ("mid_kernel", ("HGMMA", "UTMALDG")), ("attn_dq_kernel", ("HGMMA", "UTMALDG")),
    ("attn_dkv_kernel", ("HGMMA", "UTMALDG")), ("back_kernel", ("HGMMA", "UTMALDG")),
    ("wgrad_kernel", ("HGMMA",))))
# kernel 7's stages (csrc/mfn_train.cu, namespace mfnt; its GEMMs are
# mfn_staged::ff_gemm_kernel instances on mfnt epilogues), by the kernels
# whose ptxas report the spill gate requires
MFN_TRAIN = "mfnt"
MFN_TRAIN_KERNELS = ("prep_kernel", "cell_kernel", "attend_kernel",
                     "mem_bwd_kernel", "attend_bwd_kernel", "lstm_bwd_kernel",
                     "ff_gemm_kernel", "wgrad_kernel", "wgrad_sum_kernel")
# kernel 10's wgmma route (csrc/window_embed.cu, namespace wembed_tc), by
# the instantiations whose ptxas report the spill gate requires, and its
# tiles route (namespace wembed), whose fp32 tile of 160 channels once spilled
# past 255 registers on hoisted weight addresses
WE_WGMMA = "wembed_tc"
WE_WGMMA_KERNELS = tuple(f"window_embed_wgmma_kernelILi{nc}E"
                         for nc in (1, 2, 3, 8, 10))
WE_TILES = "window_embed_kernelI"
WE_TILES_KERNELS = tuple(f"window_embed_kernelIfLi{en}E"
                         for en in (96, 128, 160)) + (
    "window_embed_kernelI13__nv_bfloat16Li128E",)
# kernels 6 and 7's checks besides the model's (B=32, T 160 and 400, p the
# model's and 0): (B, T, modalities) at small shapes, L alone and
# emotient+acoustic (H = 16, the narrowest), both rates; kernel 6 also at
# kernel B's long-video bucket and one video, at the model's rate
MFN_BWD_SMALL = ((4, 9, ("linguistic",)), (3, 7, ("emotient", "acoustic")))
MFN_FWD_MORE = ((1, 37, AVL), (2, 1120, AVL))
# kernels 3, 4 and 5's bf16 checks besides the model's (d_k 32 at T 160 and 400,
# and at p = 0 at T 160): (T, d_k, p, path) at D = 8 d_k, bit-identical on
# repeat; the wgmma path at both head widths and the FMA path at d_k 2
ENC_BWD_CASES = tuple(
    (T, d_k, p, "wgmma") for T in (1, 137, 160, 400) for d_k in (16, 32)
    for p in (0.1, 0.0)
    if not (d_k == 32 and (T, p) in ((160, 0.1), (400, 0.1), (160, 0.0)))
) + tuple((160, 2, p, "fma") for p in (0.1, 0.0))


def ptxas_lines(log: str, symbol: str) -> list:
    """nvcc -Xptxas -v's lines for the kernels whose symbol contains
    `symbol`: the entry, its stack and spills, its registers."""
    lines, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line or \
                "Function properties for" in line:
            keep = symbol in line
        if keep:
            lines.append(line.strip())
    return lines


def spill_gate(log: str, symbol: str, kernels) -> int:
    """The spill bytes that ptxas reports for the kernels whose symbol
    contains `symbol`; raises unless the log has an entry and a spill line
    for each of `kernels` (a log without them checks nothing)."""
    lines = ptxas_lines(log, symbol)
    entries = [l for l in lines if "Compiling entry function" in l]
    missing = [k for k in kernels if not any(k in e for e in entries)]
    if missing or sum("spill stores" in l for l in lines) < len(entries):
        raise SmokeFailure(f"the build log has no ptxas spill report for "
                           f"{missing or symbol}: the spill gate cannot check")
    return spill_bytes(lines)


def spill_bytes(lines) -> int:
    """The spill stores and loads, in bytes, that ptxas_lines report."""
    total = 0
    for line in lines:
        if "spill stores" in line:
            parts = line.replace(",", "").split()
            total += int(parts[parts.index("spill") - 2])
            total += int(parts[parts.index("loads") - 3])
    return total


def find_cuobjdump():
    """cuobjdump from the CUDA toolkit or from Triton's package, or None."""
    cands = [Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin"
             / "cuobjdump"]
    try:
        import triton
        cands.append(Path(triton.__file__).parent / "backends" / "nvidia"
                     / "bin" / "cuobjdump")
    except ImportError:
        pass
    found = [str(c) for c in cands if c.is_file()]
    return found[0] if found else shutil.which("cuobjdump")


@functools.lru_cache(maxsize=None)
def _sass(lib_path) -> tuple:
    """(the library's SASS, or None, and why not): one cuobjdump a library
    (each takes ~20 s, and the build phase reads many kernels)."""
    tool = find_cuobjdump()
    if tool is None:
        return None, "not checked (no cuobjdump)"
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        return None, (f"not checked (cuobjdump failed: "
                      f"{out.stderr.strip()[:200]})")
    return out.stdout, ""


def sass_check(lib_path, symbol: str, wanted=("HGMMA", "UTMALDG")) -> str:
    """Whether the SASS of each kernel whose symbol contains `symbol` holds
    each of `wanted`, or "not checked" without cuobjdump."""
    sass, why_not = _sass(lib_path)
    if sass is None:
        return why_not
    found = []
    for fn in sass.split("Function : ")[1:]:
        name = fn.split(None, 1)[0]
        if symbol in name:
            found.append(name + ": " + ", ".join(
                f"{w} {'yes' if w in fn else 'NO'}" for w in wanted))
    return "; ".join(found) if found else f"no function matching {symbol}"


def n_batches(lens, batch_size: int, time_multiple: int) -> int:
    buckets: dict = {}
    for n in lens:
        b = -(-max(int(n), 1) // time_multiple)
        buckets[b] = buckets.get(b, 0) + 1
    return sum(-(-c // batch_size) for c in buckets.values())


def kernel_counters():
    """name -> (module, counter attribute) of every kernel's launch count."""
    from multimodal_transformer_tpu_torch.ops.cuda import encoder as enc_k
    from multimodal_transformer_tpu_torch.ops.cuda import encoder_train as enct
    from multimodal_transformer_tpu_torch.ops.cuda import flash_attention as fa_k
    from multimodal_transformer_tpu_torch.ops.cuda import mfn as mfn_k
    from multimodal_transformer_tpu_torch.ops.cuda import mfn_train as mfnt
    from multimodal_transformer_tpu_torch.ops.cuda import mfn_variants as mfnv
    from multimodal_transformer_tpu_torch.ops.cuda import window_embed as we_k
    return {"encoder_stack_fused": (enc_k, "launches"),
            "mfn_scan_fused": (mfn_k, "launches"),
            "window_embed_highway": (we_k, "launches"),
            "flash_attention_masked": (fa_k, "launches"),
            "encoder_stack_train_fwd": (enct, "fwd_launches"),
            "encoder_layer_bwd": (enct, "bwd_launches"),
            "encoder_stack_bwd": (enct, "stack_bwd_launches"),
            "mfn_train_fwd": (mfnt, "fwd_launches"),
            "mfn_train_bwd": (mfnt, "bwd_launches"),
            "mfn_scan_packed": (mfnv, "packed_launches"),
            "mfn_scan_aligned": (mfnv, "aligned_launches")}


def reset_counters() -> None:
    for mod, _ in kernel_counters().values():
        mod.reset_launches()


def read_counters() -> dict:
    return {name: getattr(mod, attr)
            for name, (mod, attr) in kernel_counters().items()}


def run_kernel_checks(torch, device):
    from multimodal_transformer_tpu_torch.ops.cuda import encoder as enc_k
    from multimodal_transformer_tpu_torch.ops.cuda import mfn as mfn_k
    from multimodal_transformer_tpu_torch.ops.cuda import mfn_variants as mfnv_k
    from multimodal_transformer_tpu_torch.ops.cuda import verify
    from multimodal_transformer_tpu_torch.ops.cuda import window_embed as we_k

    checks = []
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        for T in (160, 137, 544):
            checks.append(verify.check_encoder(BENCH_B, T, dtype,
                                               device=device, repeat=bf16))
            print(checks[-1].line(), flush=True)
        for B, T, D, path in ENCODER_BF16_SHAPES if bf16 else ():
            want = {"wgmma": enc_k.PATH_WGMMA, "fma": enc_k.PATH_FMA}[path]
            if enc_k.kernel_path(dtype, D // 8, D, 128) != want:
                raise SmokeFailure(f"kernel A at D={D}: not the {path} path")
            checks.append(verify.check_encoder(B, T, dtype, device=device, D=D,
                                               repeat=True))
            print(checks[-1].line(), flush=True)
        if bf16:
            kernels = verify.encoder_kernel_ms(BENCH_B, BENCH_T, dtype,
                                               device=device)
            print(f"encoder_stack_fused kernels, B={BENCH_B} T={BENCH_T} "
                  "bfloat16, device ms per stack (torch.profiler): "
                  + ", ".join(f"{k} {v:.4f}" for k, v in kernels.items()),
                  flush=True)
        for check in (verify.check_mfn, verify.check_mfn_packed,
                      verify.check_mfn_aligned):
            checks.append(check(BENCH_B, BENCH_T, dtype, device=device))
            print(checks[-1].line(), flush=True)
            kernel_b = check is verify.check_mfn
            for B, T, mods in MFN_B_SHAPES if kernel_b else MFN_VARIANT_SHAPES:
                checks.append(check(B, T, dtype, device=device, mods=mods,
                                    reps=3 if kernel_b else 0))
                print(checks[-1].line(), flush=True)
        for B, T, mods in ((BENCH_B, BENCH_T, AVL),) + MFN_VARIANT_SHAPES:
            checks.append(verify.check_mfn_aligned(
                B, T, dtype, device=device, mods=mods, hp=TPU_HP,
                reps=3 if B == BENCH_B else 0))
            print(checks[-1].line(), flush=True)
        front = "wgmma" if bf16 else "tiles"
        grouped = 0
        for Fr, D, E in WINDOW_EMBED_SHAPES:
            sizes = ((BENCH_B, BENCH_T, 7), (1, 37, 0))
            if bf16:
                sizes += ((*WINDOW_EMBED_LONG, 0),)
            for B, T, reps in sizes:
                with window_embed_route(front):
                    checks.append(verify.check_window_embed(
                        B, T, Fr, D, E, dtype, device=device, reps=reps,
                        repeat=True))
                line = checks[-1].line()
                if reps:
                    ms = verify.window_embed_kernel_ms(B, T, Fr, D, E, dtype,
                                                       device=device)
                    line += " device ms: " + ", ".join(
                        f"{k} {v:.4f}" for k, v in ms.items())
                if bf16:
                    plan = we_k.tiled_plan(B * T, Fr, D, E)
                    grouped += plan["group"] < plan["tiles_per_block"]
                    line += (f" plan: {plan['tiles_per_block']} tiles a block"
                             f" in groups of {plan['group']}")
                print(line, flush=True)
        if bf16 and not grouped:
            raise SmokeFailure("kernel 10: no checked shape ran a block's "
                               "tiles in more than one group")
        with window_embed_route("tiles"):
            checks.append(verify.check_window_embed(*WINDOW_EMBED_RAGGED,
                                                    dtype, device=device,
                                                    reps=0, repeat=True))
        print(checks[-1].line(), flush=True)
        with window_embed_route(front):
            checks.append(verify.check_window_embed_grad(
                4, 20, 32, 300, 300, dtype, device=device))
        print(checks[-1].line(), flush=True)
        for B, h, T, d_k, all_masked in FLASH_SHAPES:
            checks.append(verify.check_flash_attention(
                B, h, T, d_k, dtype, device=device, all_masked=all_masked))
            print(checks[-1].line(), flush=True)
        checks.append(verify.check_flash_attention_grad(*FLASH_GRAD, dtype,
                                                        device=device))
        print(checks[-1].line(), flush=True)
    for dtype in (torch.bfloat16, torch.float32):
        for name, scan in (("mfn_scan_fused", mfn_k.mfn_scan_fused),
                           ("mfn_scan_packed", mfnv_k.mfn_scan_packed),
                           ("mfn_scan_aligned", mfnv_k.mfn_scan_aligned)):
            stages = verify.mfn_stage_ms(BENCH_B, BENCH_T, dtype,
                                         device=device, scan=scan)
            print(f"{name} stages, B={BENCH_B} T={BENCH_T} "
                  f"{str(dtype).split('.')[-1]}, device ms per call (torch."
                  "profiler): " + ", ".join(f"{k} {v:.4f}"
                                            for k, v in stages.items())
                  + f"; in all {sum(stages.values()):.4f}", flush=True)
    bad = [c for c in checks if not c.ok]
    if bad:
        raise SmokeFailure(f"{len(bad)} kernel check(s) outside the bound")
    return checks


@contextlib.contextmanager
def plain_front_end():
    """The front end's plain conv + Highway in place of kernel 10, every other
    kernel kept: isolates kernel 10's share of a forward."""
    from multimodal_transformer_tpu_torch.models import frontend
    use_kernel = frontend.use_kernel
    frontend.use_kernel = lambda x: False
    try:
        yield
    finally:
        frontend.use_kernel = use_kernel


@contextlib.contextmanager
def window_embed_route(route: str):
    """Fails unless every kernel-10 launch inside took `route`."""
    from multimodal_transformer_tpu_torch.ops.cuda import window_embed as we_k
    before = dict(we_k.launches_by_route)
    yield
    got = {k: v - before[k] for k, v in we_k.launches_by_route.items()}
    if got[route] < 1 or sum(got.values()) != got[route]:
        raise SmokeFailure(f"kernel 10: launches by route {got}, expected "
                           f"every one on the {route} route")


def check_front_end_routes(name: str) -> None:
    """A bf16 serving phase's front ends: each kernel-10 launch since the
    counters' reset took the wgmma route."""
    from multimodal_transformer_tpu_torch.ops.cuda import window_embed as we_k
    if we_k.launches_by_route["wgmma"] != we_k.launches:
        raise SmokeFailure(f"{name}: kernel 10 launches by route "
                           f"{we_k.launches_by_route}, expected all wgmma")


def run_slice(torch, np, device):
    from multimodal_transformer_tpu_torch import (ValencePredictor, build_model,
                                                  default_config)
    from multimodal_transformer_tpu_torch.ops.cuda.verify import time_ms

    cfg = default_config("MFT", AVL, mask_mode="key_query")
    module = build_model(cfg, generator=torch.Generator().manual_seed(0))
    predictor = ValencePredictor(cfg, module, device=device, bf16=True)
    print(f"model: MFT A+V+L, mod dims {[cfg.mod_dimension[m] for m in AVL]}, "
          f"window embeds {[cfg.window_embed_size[m] for m in AVL]}, frames "
          f"{[FRAMES[m] for m in AVL]}, "
          f"{sum(p.numel() for p in module.parameters())} params", flush=True)
    rng = np.random.default_rng(0)
    requests = []
    for _ in range(REQUESTS):
        lens = rng.integers(MIN_WINDOWS, MAX_WINDOWS + 1, size=VIDEOS)
        W = int(lens.max())
        data = {m: rng.standard_normal((VIDEOS, W, FRAMES[m], cfg.mod_dimension[m]),
                                       dtype=np.float32) for m in AVL}
        requests.append((data, lens))
    expected = sum(n_batches(lens, predictor.batch_size, predictor.time_multiple)
                   for _, lens in requests)

    reset_counters()
    t0 = time.perf_counter()
    answers = [predictor.predict_padded(data, lens) for data, lens in requests]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {k: v for k, v in read_counters().items() if v}
    want = {"encoder_stack_fused": 3 * expected, "mfn_scan_fused": expected,
            "window_embed_highway": 3 * expected}
    print(f"served {len(requests)} requests x {VIDEOS} videos in {wall:.3f} s "
          f"(first use, {expected} batches); launches {got}", flush=True)
    if got != want:
        raise SmokeFailure(f"expected launches {want} on the main path")
    check_front_end_routes("slice")

    for (data, lens), traces in zip(requests, answers):
        for tr, n in zip(traces, lens):
            if tr.shape != (int(n),) or not np.isfinite(tr).all():
                raise SmokeFailure(f"trace of length {tr.shape} for a "
                                   f"{n}-window video, or not finite")
    again = predictor.predict_padded(*requests[0])
    if any(not np.array_equal(a, b) for a, b in zip(answers[0], again)):
        raise SmokeFailure("two calls on the same request differ")

    ref_module = copy.deepcopy(module).to(device=device,
                                          dtype=torch.float32).eval()
    data, lens = requests[0]
    worst = 0.0
    for vi in sorted({int(np.argmin(lens)), int(np.argmax(lens)), VIDEOS // 2}):
        n = int(lens[vi])
        inputs = {m: torch.from_numpy(data[m][vi:vi + 1, :n]).to(device)
                  for m in AVL}
        mask = torch.ones(1, n, 1, device=device)
        with torch.inference_mode():
            ref = ref_module(inputs, mask, mask_mode="key_query", plain=True)
        err = float(np.abs(answers[0][vi] - ref[0, :, 0].cpu().numpy()).max())
        worst = max(worst, err)
        print(f"video {vi} (T={n}): |bf16 kernel path - fp32 plain| = "
              f"{err:.3e} (tol {SLICE_TOL:.0e})", flush=True)
    if worst > SLICE_TOL:
        raise SmokeFailure("bf16 serving path outside the tolerance")

    B, T = BENCH_B, BENCH_T
    gen = torch.Generator().manual_seed(1)
    inputs = {m: torch.randn(B, T, FRAMES[m], cfg.mod_dimension[m],
                             generator=gen).to(device=device,
                                               dtype=torch.bfloat16)
              for m in AVL}
    mask = torch.ones(B, T, 1, device=device, dtype=torch.bfloat16)
    mod = predictor.module
    fwd = lambda: mod(inputs, mask, mask_mode="key_query")
    with torch.inference_mode():
        ms = time_ms(fwd, reps=9)
        plain_ms = time_ms(lambda: mod(inputs, mask, mask_mode="key_query",
                                       plain=True), reps=5)
        # kernel 10 against the plain front end, alternated on this card
        ab = {"kernel": [], "plain front end": []}
        for side in ("kernel", "plain front end") * 2 + ("plain front end",
                                                        "kernel") * 2:
            with (plain_front_end() if side != "kernel"
                  else contextlib.nullcontext()):
                ab[side].append(time_ms(fwd, reps=9))
    print(f"forward B={B} T={T} bf16: kernel path {ms:.3f} ms = "
          f"{B * 1000.0 / ms:.1f} seq/s; plain path {plain_ms:.3f} ms = "
          f"{B * 1000.0 / plain_ms:.1f} seq/s (median, CUDA events); "
          "alternated, kernel path with kernel 10 "
          f"{[round(v, 3) for v in ab['kernel']]} ms, with the plain front "
          f"end {[round(v, 3) for v in ab['plain front end']]} ms", flush=True)
    return got


def run_mfn_variants(torch, device) -> dict:
    """bench_mfn_kernel.py's four MFN candidates on the card (B=32, T=160,
    MFT A+V+L and B3-MFN A+V+L, fp32 and bf16); then one forward of each
    kernel candidate with the counters at 0: exact launches, and the
    variants' outputs against kernel B's.  Returns the variants' launches."""
    from multimodal_transformer_tpu_torch import bench_mfn_kernel as bench

    rows = bench.run(device, BENCH_B, BENCH_T, reps=5, plain_reps=2)
    if not all(r.ok for r in rows):
        raise SmokeFailure("an MFN candidate disagrees with the plain fp32 "
                           "forward")
    kernel_of = {"kernel B": "mfn_scan_fused", "aligned": "mfn_scan_aligned",
                 "packed": "mfn_scan_packed"}
    total: dict = {}
    for config in bench.CONFIGS:
        for dname, dtype in bench.DTYPES.items():
            case, x = bench.make_case(config, BENCH_B, BENCH_T, dtype, device)
            outs = {}
            for name, kernel in kernel_of.items():
                reset_counters()
                with torch.inference_mode():
                    outs[name] = case(x, bench.CANDIDATES[name]).float()
                torch.cuda.synchronize()
                got = {k: v for k, v in read_counters().items() if v}
                if got != {kernel: 1}:
                    raise SmokeFailure(f"MFN variants, {config} {dname} "
                                       f"{name}: launches {got}, expected "
                                       f"{ {kernel: 1} }")
                total[kernel] = total.get(kernel, 0) + 1
            diffs = {n: (outs[n] - outs["kernel B"]).abs().max().item()
                     for n in ("aligned", "packed")}
            ms = {r.candidate: round(r.ms, 3) for r in rows
                  if (r.config, r.dtype) == (config, dname)}
            print(f"MFN variants, {config} {dname}: ms/forward {ms}; |variant "
                  f"- kernel B| {diffs} (tol {bench.TOLERANCE[dname]:.0e}); "
                  "one launch of the variant per forward, kernel B none",
                  flush=True)
            if max(diffs.values()) > bench.TOLERANCE[dname]:
                raise SmokeFailure(f"MFN variants, {config} {dname}: a "
                                   "variant disagrees with kernel B")
    return {k: v for k, v in total.items() if k != "mfn_scan_fused"}


def run_train_kernel_checks(torch, device):
    from multimodal_transformer_tpu_torch.ops.cuda import encoder as enc_k
    from multimodal_transformer_tpu_torch.ops.cuda import verify

    fns = (verify.check_encoder_train_fwd, verify.check_encoder_layer_bwd,
           verify.check_encoder_stack_bwd, verify.check_mfn_train_fwd,
           verify.check_mfn_train_bwd)
    mfn_fns = (verify.check_mfn_train_fwd, verify.check_mfn_train_bwd)
    checks = []
    # (T, dropout rate): the model's rates at both T, timed at the main
    # path's shape only; p = 0 at T = 160, the dropout-free training route
    cases = [(T, None) for T in TRAIN_T] + [(BENCH_T, 0.0)]

    def report(c):
        checks.append(c)
        print(c.line(), flush=True)
        if not c.ok:
            for name, (e, pe) in c.parts.items():
                print(f"    {name}: err {e:.3e} plain err {pe:.3e}", flush=True)

    for dtype in (torch.float32, torch.bfloat16):
        for T, p in cases:
            for fn in fns:
                kw = ({"repeat": True} if fn in mfn_fns
                      + (verify.check_encoder_train_fwd,) else {})
                report(fn(32, T, dtype, device=device, p=p,
                          reps=5 if (T, p) == (BENCH_T, None) else 0, **kw))
        # kernels 6 and 7 also at T = 400 without dropout, and at small
        # shapes with other modality sets, kernel 6 also at B=1, T=37 and
        # B=2, T=1,120; each bit-identical on repeat
        for fn in mfn_fns:
            report(fn(32, 400, dtype, device=device, p=0.0, reps=0,
                      repeat=True))
            for B, T, mods in MFN_BWD_SMALL:
                for p in (None, 0.0):
                    report(fn(B, T, dtype, device=device, mods=mods, p=p,
                              reps=0, repeat=True))
        for B, T, mods in MFN_FWD_MORE:
            report(verify.check_mfn_train_fwd(B, T, dtype, device=device,
                                              mods=mods, reps=0, repeat=True))
    # kernels 3, 4 and 5's bf16 wgmma path at both head widths, one key to
    # seven key tiles, both rates (kernels 3 and 5 on a stack of 2: the
    # 6-layer stack is checked above); then their bf16 FMA path at the
    # emotient encoder's widths (D = 16, d_k = 2); all bit-identical on
    # repeat
    for T, d_k, p, path in ENC_BWD_CASES:
        D = 8 * d_k
        want = {"wgmma": enc_k.PATH_WGMMA, "fma": enc_k.PATH_FMA}[path]
        if enc_k.kernel_path(torch.bfloat16, d_k, D, 128) != want:
            raise SmokeFailure(f"encoder training kernels d_k={d_k} D={D}: "
                               f"not on the {path} path")
        report(verify.check_encoder_train_fwd(
            32, T, torch.bfloat16, device=device, p=p, reps=0, D=D,
            n_layers=2, repeat=True))
        report(verify.check_encoder_layer_bwd(
            32, T, torch.bfloat16, device=device, p=p, reps=0, D=D,
            repeat=True))
        report(verify.check_encoder_stack_bwd(
            32, T, torch.bfloat16, device=device, p=p, reps=0, D=D,
            n_layers=2, repeat=True))
    for dtype in (torch.bfloat16, torch.float32):
        for name, stage_ms in (("mfn_train_fwd", verify.mfn_train_fwd_stage_ms),
                               ("mfn_train_bwd",
                                verify.mfn_train_bwd_stage_ms)):
            stages = stage_ms(BENCH_B, BENCH_T, dtype, device=device)
            print(f"{name} stages, B={BENCH_B} T={BENCH_T} "
                  f"{str(dtype).split('.')[-1]}, device ms per call (torch."
                  "profiler): " + ", ".join(f"{k} {v:.4f}"
                                            for k, v in stages.items()),
                  flush=True)
    for dtype in (torch.bfloat16, torch.float32):
        ms = verify.encoder_train_fwd_kernel_ms(BENCH_B, BENCH_T, dtype,
                                                device=device, calls=5)
        print(f"encoder_stack_train_fwd kernels, B={BENCH_B} T={BENCH_T} "
              f"{str(dtype).split('.')[-1]}, device ms per stack (torch."
              f"profiler, events captured over 5 calls), "
              f"{sum(v for v, _ in ms.values()):.4f} in all: "
              + ", ".join(f"{k} {v:.4f} ({n})" for k, (v, n) in ms.items()),
              flush=True)
        ms = verify.encoder_bwd_kernel_ms(BENCH_B, BENCH_T, dtype,
                                          device=device, calls=5)
        print(f"encoder_layer_bwd kernels, B={BENCH_B} T={BENCH_T} "
              f"{str(dtype).split('.')[-1]}, device ms per call (torch."
              f"profiler, events captured over 5 calls), "
              f"{sum(v for v, _ in ms.values()):.4f} in all: "
              + ", ".join(f"{k} {v:.4f} ({n})" for k, (v, n) in ms.items()),
              flush=True)
    bad = [c for c in checks if not c.ok]
    if bad:
        raise SmokeFailure(f"{len(bad)} train kernel check(s) outside the "
                           "bound")
    return checks


class _Losses(logging.Handler):
    """Collects the running losses of the Engine's `Batch:` lines."""

    def __init__(self):
        super().__init__()
        self.values = []

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("Batch:"):
            self.values.append(float(msg.split("Loss:")[1]))


def _bench_batch(np, Batch, cfg, B, T, seed):
    """bench.py's training batch: lengths T - (i % 5), random targets."""
    rs = np.random.RandomState(seed)
    data = {m: rs.randn(B, T, FRAMES[m], cfg.mod_dimension[m]).astype(
        np.float32) for m in cfg.modalities}
    target = rs.randn(B, T, 1).astype(np.float32)
    lens = [T - (i % 5) for i in range(B)]
    mask = np.zeros((B, T, 1), np.float32)
    for i, n in enumerate(lens):
        mask[i, :n] = 1.0
    return Batch(data, target, mask, lens)


def _grads(torch, engine, batch, seeds, plain):
    params = [p for _, p in engine.module.named_parameters()]
    loss = engine.batch_loss(batch, seeds, plain=plain)
    # the single-modality SFT creates its fusion layer and never uses it
    grads = torch.autograd.grad(loss / float(sum(batch.lengths)), params,
                                allow_unused=True)
    return float(loss.detach()), [torch.zeros_like(p) if g is None else g
                                  for p, g in zip(params, grads)]


def _grad_norm(torch, grads) -> float:
    return torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).item()


def _worst_grad(names, grads, want, total):
    """(text, worst): the gradient furthest into its limit, GRAD_RTOL of its
    own norm plus GRAD_FLOOR of the whole gradient's norm `total`."""
    worst, at = 0.0, ("", 0.0, 0.0)
    for name, a, b in zip(names, grads, want):
        diff = (a.double() - b.double()).norm().item()
        norm = b.double().norm().item()
        if diff / (GRAD_RTOL * norm + GRAD_FLOOR * total) > worst:
            worst = diff / (GRAD_RTOL * norm + GRAD_FLOOR * total)
            at = (name, diff, norm)
    return (f"worst gradient {at[0]}: {worst:.3f} of its limit (|diff| "
            f"{at[1]:.3e}, |grad| {at[2]:.3e})"), worst


def _on_card(torch, Batch, batch, device):
    """The batch's arrays on the card, inputs and mask in bf16 (the mixed
    recipe casts them so itself)."""
    return Batch({m: torch.from_numpy(v).to(device, torch.bfloat16)
                  for m, v in batch.data.items()},
                 torch.from_numpy(batch.target).to(device),
                 torch.from_numpy(batch.mask).to(device, torch.bfloat16),
                 batch.lengths)


def _profile(torch, step, n: int):
    """Device time by kernel over n steps, and the device's busy share: the
    union of the intervals in which a kernel or a copy ran, over the host's
    wall time.  User annotations (e.g. the optimizer's step range) are not
    device work and are left out."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    cpu_names = {e.name for e in events if not str(e.device_type).endswith("CUDA")}
    dev = [e for e in events if str(e.device_type).endswith("CUDA")
           and not getattr(e, "is_user_annotation", False)
           and e.name not in cpu_names]
    busy, end = 0.0, -math.inf
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in dev):
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name: dict = {}
    for e in dev:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.end - e.time_range.start, c + 1)
    print(f"profile: {n} steps, wall {wall_us / 1e3 / n:.3f} ms/step, device "
          f"busy {busy / 1e3 / n:.3f} ms/step = {busy / wall_us:.3f} of the "
          f"wall time ({sum(t for t, _ in by_name.values()) / 1e3 / n:.3f} "
          "ms/step of kernels and copies summed)", flush=True)
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:16]:
        print(f"  {t / 1e3 / n:9.3f} ms/step {c // n:5d} calls/step "
              f"{name[:90]}", flush=True)


def run_train(torch, np, device):
    from multimodal_transformer_tpu_torch import default_config
    from multimodal_transformer_tpu_torch.data import Batch
    from multimodal_transformer_tpu_torch.engine import Engine
    from multimodal_transformer_tpu_torch.ops.cuda.verify import time_ms

    cfg = default_config("MFT", AVL, mask_mode="key_query")
    engine = Engine(cfg, seed=0, train_dtype=torch.bfloat16, device=device)
    losses = _Losses()
    log = logging.getLogger("chip_smoke.train")
    log.setLevel(logging.INFO)
    log.addHandler(losses)
    engine.logger = log
    rng = np.random.default_rng(2)
    lens = rng.integers(MIN_WINDOWS, MAX_WINDOWS + 1, size=TRAIN_VIDEOS)
    W = int(lens.max())
    data = {m: rng.standard_normal((TRAIN_VIDEOS, W, FRAMES[m],
                                    cfg.mod_dimension[m]), dtype=np.float32)
            for m in AVL}
    target = rng.standard_normal((TRAIN_VIDEOS, W), dtype=np.float32)
    steps = -(-TRAIN_VIDEOS // TRAIN_BATCH)

    reset_counters()
    t0 = time.perf_counter()
    epoch_loss = engine.train_epoch(data, target, list(lens),
                                    batch_size=TRAIN_BATCH,
                                    rng=np.random.RandomState(0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {k: v for k, v in read_counters().items() if v}
    want = {"encoder_stack_train_fwd": 3 * steps,
            "encoder_layer_bwd": 3 * 6 * steps,
            "mfn_train_fwd": steps, "mfn_train_bwd": steps,
            "window_embed_highway": 3 * steps}
    print(f"trained 1 epoch of {TRAIN_VIDEOS} videos ({steps} steps of "
          f"batch {TRAIN_BATCH}, bf16 mixed, dropout on) in {wall:.3f} s "
          f"(first use); running losses {losses.values}, epoch loss "
          f"{epoch_loss:.5f}; launches {got}", flush=True)
    if got != want:
        raise SmokeFailure(f"expected launches {want} on the training path")
    if len(losses.values) != steps or not all(
            math.isfinite(v) for v in losses.values + [epoch_loss]):
        raise SmokeFailure("a training loss is not finite")

    # the same epoch on the "stack" encoder backward: kernel 5 once per
    # encoder and step in place of kernel 4 once per layer
    engine.encoder_backward = "stack"
    losses.values.clear()
    reset_counters()
    t0 = time.perf_counter()
    stack_loss = engine.train_epoch(data, target, list(lens),
                                    batch_size=TRAIN_BATCH,
                                    rng=np.random.RandomState(0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stack_got = {k: v for k, v in read_counters().items() if v}
    want = {**{k: v for k, v in want.items() if k != "encoder_layer_bwd"},
            "encoder_stack_bwd": 3 * steps}
    print(f"the same epoch with encoder_backward=\"stack\" in {wall:.3f} s; "
          f"running losses {losses.values}, epoch loss {stack_loss:.5f}; "
          f"launches {stack_got}", flush=True)
    if stack_got != want:
        raise SmokeFailure(f"expected launches {want} on the \"stack\" "
                           "training path")
    if not all(math.isfinite(v) for v in losses.values + [stack_loss]):
        raise SmokeFailure("a training loss is not finite")
    got["encoder_stack_bwd"] = stack_got["encoder_stack_bwd"]

    # one fp32 step, kernel path against plain path
    from multimodal_transformer_tpu_torch.ops.seeds import DropoutSeeds

    B, T = BENCH_B, BENCH_T
    batch = _bench_batch(np, Batch, cfg, B, T, seed=3)
    f32 = Engine(cfg, seed=1, device=device)
    seeds = DropoutSeeds.draw(f32.module.dropout_sites(), T,
                              torch.Generator().manual_seed(4))
    loss_k, g_k = _grads(torch, f32, batch, seeds, plain=False)
    loss_p, g_p = _grads(torch, f32, batch, seeds, plain=True)
    _, g_k2 = _grads(torch, f32, batch, seeds, plain=False)
    # the same step with every kernel but kernel 10, then with kernel 10's
    # autograd Function on the plain forward: splits the gradients'
    # difference between kernel 10's output, its Function's backward and the
    # rest of the path
    with plain_front_end():
        loss_f, g_f = _grads(torch, f32, batch, seeds, plain=False)
    from multimodal_transformer_tpu_torch.ops.cuda import window_embed as we_k
    kernel_fwd = we_k.window_embed_highway
    we_k.window_embed_highway = we_k.window_embed_highway_plain
    try:
        loss_v, g_v = _grads(torch, f32, batch, seeds, plain=False)
    finally:
        we_k.window_embed_highway = kernel_fwd
    names = [n for n, _ in f32.module.named_parameters()]
    total = _grad_norm(torch, g_p)
    worst_of = lambda grads: _worst_grad(names, grads, g_p, total)

    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    same = all(torch.equal(a, b) for a, b in zip(g_k, g_k2))
    text, worst = worst_of(g_k)
    print(f"fp32 step B={B} T={T}: loss kernel {loss_k:.6f} plain "
          f"{loss_p:.6f} (rel {loss_rel:.2e}, tol {LOSS_RTOL:.0e}); {text}; "
          f"limit {GRAD_RTOL:.0e} rel L2 + {GRAD_FLOOR:.0e} of |all grads| = "
          f"{total:.4e}; repeated step bit-identical: {same}; with the plain "
          f"front end in place of kernel 10: loss {loss_f:.6f}, "
          f"{worst_of(g_f)[0]}; with kernel 10's Function on the plain "
          f"forward: loss {loss_v:.6f}, {worst_of(g_v)[0]}", flush=True)
    if loss_rel > LOSS_RTOL or worst > 1.0:
        raise SmokeFailure("the fp32 kernel-path step disagrees with the "
                           "plain path")
    if not same:
        raise SmokeFailure("the same step twice gave different gradients")

    mixed = Engine(cfg, seed=1, train_dtype=torch.bfloat16, device=device)
    on_card = _on_card(torch, Batch, batch, device)
    ms = time_ms(lambda: mixed.train_step(batch), reps=9)
    card_ms = time_ms(lambda: mixed.train_step(on_card), reps=9)
    plain_ms = time_ms(lambda: mixed.train_step(on_card, plain=True),
                       reps=3, warmup=1)
    print(f"train step B={B} T={T} bf16 mixed (fwd + bwd + Adam), median, "
          f"CUDA events: kernel path {ms:.3f} ms/step from a host batch, "
          f"{card_ms:.3f} ms/step from a batch on the card; plain path "
          f"{plain_ms:.3f} ms/step from a batch on the card", flush=True)
    for what, b in (("host batch", batch), ("batch on the card", on_card)):
        print(f"profile of the kernel path, {what}:", flush=True)
        try:
            _profile(torch, lambda: mixed.train_step(b), 5)
        except Exception as e:  # the profiler is a reading, not a check
            print(f"profile: not available ({type(e).__name__}: {e})",
                  flush=True)
    return got


def run_dropout_free_train(torch, np, device) -> None:
    """fp32 steps without seeds (dropout-free training, as `jax.grad` of the
    JAX apply with rng=None) at full width, B=32, T=160: the encoders take
    kernels 3 and 4 at p = 0 and the MFN kernels 6 and 7, never kernel A or
    B; every parameter gets a gradient (autograd.grad without allow_unused)
    that is not all zero, within the train phase's limits of the plain
    path.  Then kernels A and B, called directly under autograd, raise."""
    from multimodal_transformer_tpu_torch import default_config
    from multimodal_transformer_tpu_torch.data import Batch
    from multimodal_transformer_tpu_torch.engine import Engine
    from multimodal_transformer_tpu_torch.ops.cuda import encoder as enc_k
    from multimodal_transformer_tpu_torch.ops.cuda import mfn as mfn_k
    from multimodal_transformer_tpu_torch.ops.mfn_core import hoisted_inputs

    B, T = BENCH_B, BENCH_T
    heads = {}
    for i, (name, family) in enumerate(FREE_TRAIN):
        cfg = default_config(family, AVL, mask_mode="key_query")
        batch = _bench_batch(np, Batch, cfg, B, T, seed=20 + i)
        f32 = Engine(cfg, seed=1, device=device)
        names, params = zip(*f32.module.named_parameters())

        def grads(plain: bool):
            loss = f32.batch_loss(batch, None, plain=plain)
            try:
                g = torch.autograd.grad(loss / float(sum(batch.lengths)),
                                        params)
            except RuntimeError as e:  # a parameter the loss does not reach
                raise SmokeFailure(f"{name}, no seeds: {e}") from e
            return float(loss.detach()), g

        reset_counters()
        loss_k, g_k = grads(False)
        torch.cuda.synchronize()
        counts = {k: v for k, v in read_counters().items() if v}
        loss_p, g_p = grads(True)
        want = _train_launches(f32.module, "perlayer")
        zero = [n for n, g in zip(names, g_k) if not bool(g.ne(0).any())]
        text, worst = _worst_grad(names, g_k, g_p, _grad_norm(torch, g_p))
        loss_rel = abs(loss_k - loss_p) / abs(loss_p)
        print(f"{name} dropout-free fp32 step B={B} T={T}: launches {counts}; "
              f"loss kernel {loss_k:.6f} plain {loss_p:.6f} (rel "
              f"{loss_rel:.2e}, tol {LOSS_RTOL:.0e}); {text}; {len(names)} "
              f"parameters, all-zero gradients {zero}", flush=True)
        if counts != want:
            raise SmokeFailure(f"{name}, no seeds: launches {counts}, "
                               f"expected {want}")
        if zero:
            raise SmokeFailure(f"{name}, no seeds: all-zero gradients {zero}")
        if loss_rel > LOSS_RTOL or worst > 1.0:
            raise SmokeFailure(f"{name}, no seeds: the fp32 kernel-path step "
                               "disagrees with the plain path")
        heads[family] = f32.module.Transformer

    mft = heads["MFT"]  # its encoders and MFN, called directly
    x = torch.randn(2, 8, 256, device=device, requires_grad=True)
    mask = torch.ones(2, 8, 1, device=device)
    mfn = mft.mfn
    xps = hoisted_inputs(mfn, {m: x for m in AVL})
    whhs = [getattr(mfn, f"lstm_{m}").weight_hh for m in AVL]
    calls = {"encoder_stack_fused": lambda: enc_k.encoder_stack_fused(
                 mft.transformer_acoustic, x, mask),
             "mfn_scan_fused": lambda: mfn_k.mfn_scan_fused(
                 xps, whhs, mfn.gate_tensors())}
    for what, call in calls.items():
        reset_counters()
        try:
            call()
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
            print(f"{what} under autograd raises: {e}", flush=True)
        else:
            raise SmokeFailure(f"{what} ran under autograd with inputs that "
                               "require grad")
        if any(read_counters().values()):
            raise SmokeFailure(f"{what} launched under autograd")


def _train_launches(module, backward: str) -> dict:
    """The kernel launches of one training step of `module` on the card in
    "key_query" mode."""
    sites = module.dropout_sites()
    cfg = module.cfg
    n_enc, mfn = len(sites.encoders), int(sites.mfn)
    fronts = 0 if module.relu_proj else len(cfg.modalities)
    want = {"encoder_stack_train_fwd": n_enc,
            "encoder_layer_bwd": 6 * n_enc if backward == "perlayer" else 0,
            "encoder_stack_bwd": n_enc if backward == "stack" else 0,
            "mfn_train_fwd": mfn, "mfn_train_bwd": mfn,
            "window_embed_highway": fronts}
    return {k: v for k, v in want.items() if v}


def run_families_train(torch, np, device):
    """Train each configuration of TRAIN_FAMILIES through Engine on the
    card.  Returns {name: (ms/step from a card batch, from a host batch)}."""
    from multimodal_transformer_tpu_torch import default_config
    from multimodal_transformer_tpu_torch.data import Batch
    from multimodal_transformer_tpu_torch.engine import Engine
    from multimodal_transformer_tpu_torch.ops.cuda.verify import time_ms
    from multimodal_transformer_tpu_torch.ops.seeds import DropoutSeeds

    B, T = BENCH_B, BENCH_T
    times = {}
    for i, (name, family, mods, variant) in enumerate(TRAIN_FAMILIES):
        cfg = default_config(family, mods, mask_mode="key_query",
                             variant=variant)
        batch = _bench_batch(np, Batch, cfg, B, T, seed=10 + i)
        f32 = Engine(cfg, seed=1, device=device)
        seeds = DropoutSeeds.draw(f32.module.dropout_sites(), T,
                                  torch.Generator().manual_seed(4))
        counts, grads, losses = {}, {}, {}
        for route in ("perlayer", "stack"):
            f32.encoder_backward = route
            reset_counters()
            losses[route], grads[route] = _grads(torch, f32, batch, seeds,
                                                 plain=False)
            torch.cuda.synchronize()
            counts[route] = {k: v for k, v in read_counters().items() if v}
            want = _train_launches(f32.module, route)
            if counts[route] != want:
                raise SmokeFailure(f"{name}: launches {counts[route]} on the "
                                   f"{route!r} route, expected {want}")
        f32.encoder_backward = "perlayer"
        _, g_k2 = _grads(torch, f32, batch, seeds, plain=False)
        loss_p, g_p = _grads(torch, f32, batch, seeds, plain=True)
        names = [n for n, _ in f32.module.named_parameters()]
        loss_k, g_k = losses["perlayer"], grads["perlayer"]
        text, worst = _worst_grad(names, g_k, g_p, _grad_norm(torch, g_p))
        loss_rel = abs(loss_k - loss_p) / abs(loss_p)
        same = all(torch.equal(a, b) for a, b in zip(g_k, g_k2))
        stack_same = all(torch.equal(a, b)
                         for a, b in zip(g_k, grads["stack"]))

        mixed = Engine(cfg, seed=1, train_dtype=torch.bfloat16, device=device)
        on_card = _on_card(torch, Batch, batch, device)
        card_ms = time_ms(lambda: mixed.train_step(on_card), reps=9)
        host_ms = time_ms(lambda: mixed.train_step(batch), reps=9)
        times[name] = (card_ms, host_ms)

        query = Engine(default_config(family, mods, variant=variant), seed=0,
                       train_dtype=torch.bfloat16, device=device)
        reset_counters()
        q_loss = query.train_step(_bench_batch(np, Batch, cfg, 8, 64, seed=6))
        torch.cuda.synchronize()
        q_counts = {k: v for k, v in read_counters().items() if v}
        q_want = {k: v for k, v in _train_launches(query.module,
                                                   "perlayer").items()
                  if not k.startswith("encoder_")}
        print(f"{name} train B={B} T={T}: launches per step {counts}; fp32 "
              f"loss kernel {loss_k:.6f} plain {loss_p:.6f} (rel "
              f"{loss_rel:.2e}, tol {LOSS_RTOL:.0e}); {text}; repeated step "
              f"bit-identical: {same}; \"stack\" bit-identical to "
              f"\"perlayer\": {stack_same}; bf16 mixed {card_ms:.3f} ms/step "
              f"from a batch on the card, {host_ms:.3f} from a host batch "
              f"(median of 9, CUDA events); query-mode step B=8 T=64 loss "
              f"{q_loss:.5f}, launches {q_counts}", flush=True)
        if loss_rel > LOSS_RTOL or worst > 1.0:
            raise SmokeFailure(f"{name}: the fp32 kernel-path step disagrees "
                               "with the plain path")
        if not (same and stack_same):
            raise SmokeFailure(f"{name}: a repeated step, or the \"stack\" "
                               "route, changed the gradients' bits")
        if q_counts != q_want or not math.isfinite(q_loss):
            raise SmokeFailure(f"{name}: query-mode step launches {q_counts} "
                               f"(expected {q_want}) or a loss not finite")
    return times


# the parallel phase: 2 ranks (NCCL on a card each, else gloo with both on
# cuda:0); MFT A+V+L batches of the bench recipe, the last of 31 videos (a
# pad row over 2 ranks); 8 evaluation videos of 20-400 windows and one of
# PAR_LONG_VIDEO, past kernel A's 512; the TP configurations with their
# launches per forward on each rank
PAR_RANKS = 2
PAR_BATCHES = ((BENCH_B, 20), (BENCH_B, 21), (BENCH_B - 1, 22))
# the bf16 mixed DP epoch against the one-process bf16 epoch: losses within
# the train phase's LOSS_RTOL; each step's summed gradients within
# PAR_BF16_GRAD_SCALE times the fp32 limits (GRAD_RTOL, GRAD_FLOOR), at
# step 0 (equal parameters) and at the later steps (after Adam has turned
# rounding-level gradient differences into +-lr steps).  Each scale lies
# between the largest reading of DP against one process and the smallest of
# the control, the one-process bf16 step against the fp32 step (the
# readings are in PERF.md)
PAR_BF16_GRAD_SCALE = (16.0, 100.0)
PAR_EVAL_VIDEOS = 8
PAR_LONG_VIDEO = 600
PAR_TIMED_STEPS = 9
PAR_TP = (("B2-Trans A+V+L", "B2-Trans",
           {"flash_attention_masked": 6, "window_embed_highway": 3}),
          ("MFT A+V+L", "MFT", {"flash_attention_masked": 18,
                                "mfn_scan_fused": 1,
                                "window_embed_highway": 3}))
PAR_TP_TOL = 1e-4


def _par_batches(np, Batch, cfg):
    return [_bench_batch(np, Batch, cfg, b, BENCH_T, seed)
            for b, seed in PAR_BATCHES]


def _par_eval_set(np, cfg):
    rng = np.random.default_rng(31)
    lens = np.append(rng.integers(MIN_WINDOWS, MAX_WINDOWS + 1,
                                  size=PAR_EVAL_VIDEOS), PAR_LONG_VIDEO)
    W = int(lens.max())
    data = {m: rng.standard_normal((len(lens), W, FRAMES[m],
                                    cfg.mod_dimension[m]), dtype=np.float32)
            for m in cfg.modalities}
    target = rng.standard_normal((len(lens), W), dtype=np.float32) * (
        np.arange(W)[None, :] < lens[:, None])
    return data, target.astype(np.float32), [int(v) for v in lens]


def _par_epoch(torch, engine, batches) -> tuple:
    """(each step's loss, {kernel: launches}, each step's gradients as the
    optimizer takes them, summed over the ranks, on the CPU) of train_step
    over batches."""
    grads = []
    step = engine.optimizer.step

    def recorded(*args, **kwargs):
        grads.append([p.grad.detach().cpu() for p in
                      engine.module.parameters()])
        return step(*args, **kwargs)

    engine.optimizer.step = recorded
    reset_counters()
    try:
        losses = [engine.train_step(b) for b in batches]
        torch.cuda.synchronize()
    finally:
        del engine.optimizer.step  # the optimizer's own method again
    return losses, {k: v for k, v in read_counters().items() if v}, grads


def _par_ms(torch, fn, barrier) -> float:
    """Host ms per call of fn over PAR_TIMED_STEPS calls after 2 warm-up
    calls (all ranks start together when barrier is given)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    if barrier:
        barrier()
    t0 = time.perf_counter()
    for _ in range(PAR_TIMED_STEPS):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / PAR_TIMED_STEPS


def _parallel_rank(rank: int, device_type: str) -> dict:
    """One rank of the parallel phase: DP training (fp32 and bf16 mixed,
    the summed gradients recorded) and evaluation on a 1-D mesh over both
    ranks, ms per DP step and per gradient all_reduce (with the copies into
    and out of the flat buffer, and the collective alone), then the TP
    forwards on a 1 x 2 mesh.  Returns what the parent compares."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from multimodal_transformer_tpu_torch import build_model, default_config
    from multimodal_transformer_tpu_torch.data import Batch
    from multimodal_transformer_tpu_torch.engine import Engine
    from multimodal_transformer_tpu_torch.parallel import (make_mesh,
                                                           make_mesh_2d,
                                                           shard_params_tp)
    from multimodal_transformer_tpu_torch.parallel import mesh as dp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = (torch.device("cuda", torch.cuda.current_device())
              if device_type == "cuda" else torch.device(device_type))
    mesh = make_mesh(PAR_RANKS, device_type)
    cfg = default_config("MFT", AVL, mask_mode="key_query")
    batches = _par_batches(np, Batch, cfg)
    out = {"rank": rank}

    f32 = Engine(cfg, seed=1, device=device, mesh=mesh)
    out["fp32_losses"], out["train_launches"], grads = _par_epoch(
        torch, f32, batches)
    out["params"] = [p.detach().cpu() for p in f32.module.parameters()]
    mixed = Engine(cfg, seed=1, train_dtype=torch.bfloat16, device=device,
                   mesh=mesh)
    out["bf16_losses"], out["bf16_launches"], bf16_grads = _par_epoch(
        torch, mixed, batches)
    if rank == 0:
        out["grads"], out["bf16_grads"] = grads, bf16_grads
    del grads, bf16_grads

    data, target, lens = _par_eval_set(np, cfg)
    reset_counters()
    per = f32.evaluate_per_video(data, target, lens)
    torch.cuda.synchronize()
    out["per_video"] = (per[0], per[3], {k: v for k, v in
                                         read_counters().items() if v})
    reset_counters()
    bat = f32.evaluate_batched(data, target, lens)
    torch.cuda.synchronize()
    out["batched"] = (bat[0], bat[1], {k: v for k, v in
                                       read_counters().items() if v})

    barrier = lambda: dp.barrier(mesh)
    out["dp_step_ms"] = _par_ms(torch, lambda: mixed.train_step(batches[0]),
                                barrier)
    flat = [torch.zeros_like(p) for p in mixed.module.parameters()]
    buffer = dp.FlatBuffer()
    out["all_reduce_ms"] = _par_ms(
        torch, lambda: dp.all_reduce_flat(flat, mesh, buffer), barrier)
    out["collective_ms"] = _par_ms(torch, lambda: dist.all_reduce(
        buffer.flat, group=mesh.get_group()), barrier)
    out["all_reduce_mb"] = buffer.flat.numel() * 4 / 1e6
    del f32, mixed

    mesh2 = make_mesh_2d(1, PAR_RANKS, device_type)
    out["tp"] = {}
    for i, (name, family, _) in enumerate(PAR_TP):
        cfg = default_config(family, AVL, mask_mode="key_query")
        module = build_model(cfg, generator=torch.Generator().manual_seed(
            40 + i)).to(device).eval()
        tp, _ = shard_params_tp(module, mesh2)
        batch = _bench_batch(np, Batch, cfg, BENCH_B, BENCH_T, seed=50 + i)
        reset_counters()
        with torch.inference_mode():
            pred = tp({m: torch.from_numpy(v).to(device)
                       for m, v in batch.data.items()},
                      torch.from_numpy(batch.mask).to(device))
        torch.cuda.synchronize()
        out["tp"][name] = (pred.cpu(), {k: v for k, v in
                                        read_counters().items() if v})
    return out


def run_parallel(torch, np, device) -> None:
    """The parallel phase: PAR_RANKS ranks against one process on the
    same batches and weights."""
    from multimodal_transformer_tpu_torch import build_model, default_config
    from multimodal_transformer_tpu_torch.data import Batch
    from multimodal_transformer_tpu_torch.engine import Engine
    from multimodal_transformer_tpu_torch.parallel import (pad_batch_rows,
                                                           spawn)
    from multimodal_transformer_tpu_torch.parallel.mesh import \
        default_backend

    t_phase = time.perf_counter()
    card = card_line()
    backend = default_backend(device.type, PAR_RANKS)
    print(f"parallel: {PAR_RANKS} ranks, {backend} "
          f"({torch.cuda.device_count()} card(s) for {PAR_RANKS} ranks); "
          f"torch {torch.__version__}", flush=True)
    ranks = spawn(_parallel_rank, PAR_RANKS, device.type,
                  device_type=device.type)

    cfg = default_config("MFT", AVL, mask_mode="key_query")
    # one process on the global batches padded as the ranks pad them, so
    # the MFN head's `out` site indexes the same B_pad rows
    pad = lambda b: Batch({m: pad_batch_rows(v, PAR_RANKS)
                           for m, v in b.data.items()},
                          pad_batch_rows(b.target, PAR_RANKS),
                          pad_batch_rows(b.mask, PAR_RANKS), b.lengths)
    batches = [pad(b) for b in _par_batches(np, Batch, cfg)]
    f32 = Engine(cfg, seed=1, device=device)
    losses, _, grads = _par_epoch(torch, f32, batches)
    names = [n for n, _ in f32.module.named_parameters()]
    params = [p.detach().cpu() for p in f32.module.parameters()]
    mixed = Engine(cfg, seed=1, train_dtype=torch.bfloat16, device=device)
    bf16_losses, _, bf16_grads = _par_epoch(torch, mixed, batches)
    steps = len(batches)
    control_rel = max(abs(a - b) / abs(b) for a, b in zip(bf16_losses, losses))
    want_train = {"encoder_stack_train_fwd": 3 * steps,
                  "encoder_layer_bwd": 3 * 6 * steps,
                  "mfn_train_fwd": steps, "mfn_train_bwd": steps,
                  "window_embed_highway": 3 * steps}
    for r in ranks:
        rank = r["rank"]
        loss_rel = max(abs(a - b) / abs(b)
                       for a, b in zip(r["fp32_losses"], losses))
        bf16_rel = max(abs(a - b) / abs(b)
                       for a, b in zip(r["bf16_losses"], bf16_losses))
        p_text, p_worst = _worst_grad(names, r["params"], params,
                                      _grad_norm(torch, params))
        print(f"parallel rank {rank}: fp32 DP losses {r['fp32_losses']} vs "
              f"one process {losses} (max rel {loss_rel:.2e}, tol "
              f"{LOSS_RTOL:.0e}); parameters after {steps} steps: "
              f"{p_text.replace('gradient', 'parameter')}; bf16 mixed DP "
              f"losses {r['bf16_losses']} vs {bf16_losses} (max rel "
              f"{bf16_rel:.2e}, tol {LOSS_RTOL:.0e}; control, one process "
              f"bf16 vs fp32: {control_rel:.2e}); launches "
              f"fp32 {r['train_launches']}, bf16 {r['bf16_launches']}",
              flush=True)
        if loss_rel > LOSS_RTOL or p_worst > 1.0:
            raise SmokeFailure(f"parallel rank {rank}: the fp32 DP epoch "
                               "disagrees with one process")
        if bf16_rel > LOSS_RTOL or not all(
                math.isfinite(v) for v in r["bf16_losses"]):
            raise SmokeFailure(f"parallel rank {rank}: the bf16 DP epoch's "
                               "losses")
        if r["train_launches"] != want_train or \
                r["bf16_launches"] != want_train:
            raise SmokeFailure(f"parallel rank {rank}: expected launches "
                               f"{want_train} on the DP training path")
        if any(not torch.equal(a, b)
               for a, b in zip(r["params"], ranks[0]["params"])):
            raise SmokeFailure(f"parallel rank {rank}: parameters differ "
                               "from rank 0's")
    # each step's summed gradients against one process's, read at the fp32
    # limits; bf16 held to PAR_BF16_GRAD_SCALE of them, beside the control:
    # the one-process bf16 step against the one-process fp32 step
    total = _grad_norm(torch, grads[0])
    for what, got_grads, want_grads, scales in (
            ("fp32", ranks[0]["grads"], grads, (1.0, 1.0)),
            ("bf16 mixed", ranks[0]["bf16_grads"], bf16_grads,
             PAR_BF16_GRAD_SCALE)):
        for i, (got, want) in enumerate(zip(got_grads, want_grads)):
            scale = scales[min(i, 1)]
            text, worst = _worst_grad(names, got, want, total)
            if what == "fp32":
                control = ""
            else:
                control = (f"; control, one-process bf16 vs fp32: "
                           f"{_worst_grad(names, want, grads[i], total)[0]}")
            print(f"parallel step {i} {what}: all_reduced gradients vs one "
                  f"process at the fp32 limits: {text}; held to {scale:g} "
                  f"of the limits{control}", flush=True)
            if worst > scale:
                raise SmokeFailure(f"parallel step {i}: the {what} summed "
                                   "gradients disagree with one process")

    data, target, lens = _par_eval_set(np, cfg)
    per = f32.evaluate_per_video(data, target, lens)
    bat = f32.evaluate_batched(data, target, lens)
    n_b = n_batches(lens, 32, 32)
    # batches past 512 windows: kernel 11 in each encoder layer, not kernel A
    n_long = n_batches([n for n in lens if -(-n // 32) * 32 > 512], 32, 32)

    def launches(videos: int, long: int) -> dict:
        want = {"encoder_stack_fused": 3 * (videos - long),
                "flash_attention_masked": 18 * long,
                "mfn_scan_fused": videos, "window_embed_highway": 3 * videos}
        return {k: v for k, v in want.items() if v}

    for r in ranks:
        mine = lens[r["rank"]::PAR_RANKS]
        for what, (cccs, loss, got), ref, want in (
                ("evaluate_per_video", r["per_video"], per,
                 launches(len(mine), sum(n > 512 for n in mine))),
                ("evaluate_batched", r["batched"], bat,
                 launches(n_b, n_long))):
            ref_cccs = ref[0]
            ref_loss = ref[3] if what == "evaluate_per_video" else ref[1]
            diff = max(abs(a - b) for a, b in zip(cccs, ref_cccs))
            print(f"parallel rank {r['rank']} {what}: {len(lens)} videos of "
                  f"{min(lens)}-{max(lens)} windows, fp32; max |CCC - one "
                  f"process| = {diff:.3e} (tol {EVAL_FP32_TOL:.0e}); loss "
                  f"{loss:.6f} vs {ref_loss:.6f}; launches {got}", flush=True)
            if len(cccs) != len(lens) or diff > EVAL_FP32_TOL or \
                    abs(loss - ref_loss) > EVAL_FP32_TOL * abs(ref_loss):
                raise SmokeFailure(f"parallel {what}: rank {r['rank']} "
                                   "disagrees with one process")
            if got != want:
                raise SmokeFailure(f"parallel {what}: rank {r['rank']} "
                                   f"launched {got}, expected {want}")

    for i, (name, family, want) in enumerate(PAR_TP):
        tcfg = default_config(family, AVL, mask_mode="key_query")
        module = build_model(tcfg, generator=torch.Generator().manual_seed(
            40 + i)).to(device).eval()
        batch = _bench_batch(np, Batch, tcfg, BENCH_B, BENCH_T, seed=50 + i)
        with torch.inference_mode():
            ref = module({m: torch.from_numpy(v).to(device)
                          for m, v in batch.data.items()},
                         torch.from_numpy(batch.mask).to(device)).cpu()
        for r in ranks:
            pred, got = r["tp"][name]
            err = (pred - ref).abs().max().item()
            print(f"parallel TP {name} over {PAR_RANKS} model ranks, rank "
                  f"{r['rank']}: B={BENCH_B} T={BENCH_T} fp32 eval forward, "
                  f"max |TP - one card| = {err:.3e} (tol {PAR_TP_TOL:.0e}); "
                  f"launches {got}", flush=True)
            if err > PAR_TP_TOL or not torch.isfinite(pred).all():
                raise SmokeFailure(f"parallel TP {name}: rank {r['rank']} "
                                   "disagrees with the one-card forward")
            if got != want:
                raise SmokeFailure(f"parallel TP {name}: rank {r['rank']} "
                                   f"launched {got}, expected {want}")

    one_ms = _par_ms(torch, lambda: mixed.train_step(batches[0]), None)
    mb = ranks[0]["all_reduce_mb"]
    flat_ms = max(r["all_reduce_ms"] for r in ranks)
    alone_ms = max(r["collective_ms"] for r in ranks)
    print(f"parallel timing ({card}): bf16 mixed MFT A+V+L train_step of a "
          f"host batch B={BENCH_B} T={BENCH_T}, {PAR_TIMED_STEPS} steps: "
          f"{max(r['dp_step_ms'] for r in ranks):.3f} ms/step at "
          f"{PAR_RANKS} ranks ({backend}), {one_ms:.3f} ms/step in one "
          f"process; gradient all_reduce of {mb:.1f} MB ({backend}): "
          f"{flat_ms:.3f} ms with the copies into and out of the flat "
          f"buffer, {alone_ms:.3f} ms for the collective alone on the "
          f"buffer ({mb / alone_ms:.2f} GB/s of buffer); "
          + ("ranks that share one card give no scaling figure"
             if torch.cuda.device_count() < PAR_RANKS else
             "one card per rank"), flush=True)
    print(f"parallel phase wall time {time.perf_counter() - t_phase:.1f} s "
          f"(target 90 s; {card})", flush=True)


# the CLI phase: the synthetic SENDv1 tree of --synthetic_data (60-s
# videos), the MFT A+V+L training run and the kernels each CLI run must
# launch
CLI_SUBSETS = {"Train": 8, "Valid": 3, "Test": 3}
CLI_TRAIN_KERNELS = ("encoder_stack_train_fwd", "encoder_layer_bwd",
                     "mfn_train_fwd", "mfn_train_bwd", "window_embed_highway")
CLI_EVAL_KERNELS = ("encoder_stack_fused", "mfn_scan_fused",
                    "window_embed_highway")


def _log_numbers(path: Path) -> list:
    """Every loss and CCC a CLI log line reports."""
    import re
    pat = re.compile(r"(?:Loss|CCC|CCC\(std\)|SINGLE_BEST|BEST): "
                     r"(-?[0-9.eE+-]+|nan|inf|-inf)")
    return [float(v) for v in pat.findall(path.read_text())]


class _Timed:
    """Wraps Engine methods to sum the synchronised seconds of their calls."""

    def __init__(self, torch, engine_cls, names):
        self.torch, self.cls, self.names = torch, engine_cls, names
        self.seconds = {n: [] for n in names}

    def __enter__(self):
        self.orig = {n: getattr(self.cls, n) for n in self.names}
        for n, fn in self.orig.items():
            def timed(*a, _fn=fn, _n=n, **kw):
                self.torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _fn(*a, **kw)
                self.torch.cuda.synchronize()
                self.seconds[_n].append(time.perf_counter() - t0)
                return out
            setattr(self.cls, n, timed)
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.cls, n, fn)


def run_cli(torch, np, device) -> None:
    """`python -m multimodal_transformer_tpu_torch.train` on the synthetic
    SENDv1 tree: train MFT A+V+L (a subprocess), resume, --eval, --test
    --fast_eval, --perf, a resident B2-Trans epoch; launches, the
    checkpoint's traces against the plain fp32 forward, finite logs."""
    import tempfile

    from multimodal_transformer_tpu_torch import ValencePredictor, build_model
    from multimodal_transformer_tpu_torch import train as cli
    from multimodal_transformer_tpu_torch.data import (
        generate_synthetic_send, load_send)
    from multimodal_transformer_tpu_torch.engine import (Engine, load_model,
                                                         save_checkpoint)

    here = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        data_dir = tmp / "SENDv1-data"
        generate_synthetic_send(str(data_dir), CLI_SUBSETS, duration_s=60.0)
        generate_synthetic_send(str(data_dir), CLI_SUBSETS, duration_s=60.0,
                                modalities=("linguistic",),
                                linguistic_variant="bert")

        def flags(log: str, *extra):
            return ["--data_dir", str(data_dir),
                    "--save_dir", str(tmp / "ModelSave"),
                    "--pred_save_dir", str(tmp / "PredSave"),
                    "--perf_save_dir", str(tmp / "PerfSave"),
                    "--log_file", str(tmp / log), "--mask_mode", "key_query",
                    "--device", str(device), *extra]

        train = ("--family", "MFT", "--comb", "VAL", "--save_freq", "1",
                 "--mixed_precision")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(here)] + [p for p in [env.get("PYTHONPATH")] if p])
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "multimodal_transformer_tpu_torch.train",
             *flags("train.log", *train, "--epochs", "2")],
            cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise SmokeFailure(f"the training CLI exited {proc.returncode}: "
                               f"{proc.stderr[-2000:]}")
        ckpt = tmp / "ModelSave" / "MFT" / "MFT-VAL.pth"
        if not ckpt.exists() or not ckpt.with_suffix(".pth.state").exists():
            raise SmokeFailure(f"no {ckpt} or its .state after training")
        print(f"CLI train (subprocess): MFT A+V+L, 2 epochs of "
              f"{CLI_SUBSETS['Train']} videos, {wall:.1f} s wall", flush=True)
        read = native_files((tmp / "train.log").read_text().splitlines())
        print(f"CLI reader: {read} (split, files read by the native parser, "
              "files)", flush=True)
        if ({r[0] for r in read} != {"Train", "Valid"}
                or any(n != total for _, n, total in read)):
            raise SmokeFailure("the CLI did not read Train and Valid with the "
                               "native parser")

        parse = lambda *a: cli.build_arg_parser().parse_args(list(a))
        mods = ("acoustic", "image", "linguistic")
        n_valid, steps = CLI_SUBSETS["Valid"], -(-CLI_SUBSETS["Train"] // 25)
        reset_counters()
        with _Timed(torch, Engine, ("train_epoch", "evaluate_per_video")) as tm:
            cli.main(parse(*flags("resume.log", *train, "--epochs", "3",
                                  "--resume")))
        got = {k: v for k, v in read_counters().items() if v}
        want = {"encoder_stack_train_fwd": 3 * steps,
                "encoder_layer_bwd": 18 * steps, "mfn_train_fwd": steps,
                "mfn_train_bwd": steps,
                "window_embed_highway": 3 * steps + 3 * n_valid,
                "encoder_stack_fused": 3 * n_valid, "mfn_scan_fused": n_valid}
        log = (tmp / "resume.log").read_text()
        epoch_s = tm.seconds["train_epoch"][0]
        valid_s = tm.seconds["evaluate_per_video"][0]
        print(f"CLI resume (in process): epoch 3, {epoch_s:.3f} s per epoch "
              f"({steps} step), validation {valid_s:.3f} s; launches {got}",
              flush=True)
        if "Resumed from" not in log or "at epoch 3" not in log:
            raise SmokeFailure("the resumed run did not log 'Resumed from "
                               "... at epoch 3'")
        if got != want:
            raise SmokeFailure(f"expected launches {want} in the resumed "
                               "epoch and its validation")

        _, _, _, test_lens = cli.prepare_data(
            load_model(str(ckpt), "MFT", "key_query")[0], str(data_dir),
            "Test")
        n_test = len(test_lens)
        batches = n_batches(test_lens, 32, 32)
        for name, extra, want in (
                ("--eval", ("--eval",), {"encoder_stack_fused": 3 * n_valid,
                                         "mfn_scan_fused": n_valid,
                                         "window_embed_highway": 3 * n_valid}),
                ("--test --fast_eval", ("--test", "--fast_eval"),
                 {"encoder_stack_fused": 3 * batches,
                  "mfn_scan_fused": batches,
                  "window_embed_highway": 3 * batches})):
            reset_counters()
            t0 = time.perf_counter()
            with _Timed(torch, Engine, ("evaluate_per_video",
                                        "evaluate_batched")) as tm:
                stats = cli.main(parse(*flags("eval.log", "--family", "MFT",
                                              "--load", str(ckpt), *extra)))
            wall = time.perf_counter() - t0
            got = {k: v for k, v in read_counters().items() if v}
            passes = tm.seconds["evaluate_per_video"] + \
                tm.seconds["evaluate_batched"]
            print(f"CLI {name}: CCC {stats['ccc']:.6f}, evaluation pass "
                  f"{passes[0]:.3f} s, {wall:.3f} s wall with loading; "
                  f"launches {got}", flush=True)
            if got != want or not math.isfinite(stats["ccc"]):
                raise SmokeFailure(f"{name}: expected launches {want} and a "
                                   "finite CCC")
            if any(not math.isfinite(v) for v in
                   _log_numbers(tmp / "eval.log")):
                raise SmokeFailure(f"{name}: a logged value is not finite")

        t0 = time.perf_counter()
        cli.main(parse(*flags("perf.log", "--perf", "--model_save",
                              str(tmp / "ModelSave" / "MFT"))))
        rows = (tmp / "PerfSave" / "MFT.csv").read_text().splitlines()[1:]
        n_rows = sum(CLI_SUBSETS.values())
        print(f"CLI --perf: {len(rows)} PerfSave rows in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        if len(rows) != n_rows or any(
                not math.isfinite(float(r.split(",")[-1])) for r in rows):
            raise SmokeFailure(f"--perf wrote {len(rows)} rows, not "
                               f"{n_rows} finite ones")

        reset_counters()
        t0 = time.perf_counter()
        cli.main(parse(*flags("resident.log", "--family", "B2-Trans",
                              "--resident_train", "--epochs", "1",
                              "--mixed_precision")))
        got = {k: v for k, v in read_counters().items() if v}
        print(f"CLI --resident_train B2-Trans: 1 epoch in "
              f"{time.perf_counter() - t0:.3f} s with loading; launches "
              f"{got}", flush=True)
        if not all(got.get(k) for k in ("encoder_stack_train_fwd",
                                         "encoder_layer_bwd",
                                         "window_embed_highway")):
            raise SmokeFailure("the resident epoch did not launch kernels "
                               "3, 4 and 10")

        for log in ("train.log", "resume.log", "perf.log", "resident.log"):
            values = _log_numbers(tmp / log)
            if not values or any(not math.isfinite(v) for v in values):
                raise SmokeFailure(f"{log}: a logged loss or CCC is not "
                                   "finite, or none was logged")

        # the host layers under the CLI: the reader and windowing, the
        # checkpoint files, and epochs with and without the prefetcher,
        # alternated (bf16 mixed MFT A+V+L, one step an epoch)
        cfg, state = load_model(str(ckpt), "MFT", "key_query")
        t0 = time.perf_counter()
        _, x, y, lens = cli.prepare_data(cfg, str(data_dir), "Train")
        read_s = time.perf_counter() - t0
        reads = {True: [], False: []}
        for native in (True, False, False, True, True, False):
            t0 = time.perf_counter()
            load_send(mods, str(data_dir), "Train", use_native=native)
            reads[native].append(time.perf_counter() - t0)
        print(f"CLI reader: Train split read, s, native parser "
              f"{[round(v, 4) for v in reads[True]]}, Python parser "
              f"{[round(v, 4) for v in reads[False]]} (alternated) on "
              f"{card_line()}", flush=True)
        eng = Engine(cfg, train_dtype=torch.bfloat16, device=device)
        io = {}
        for what, fn in (
                ("restore_state", lambda: eng.restore_state(
                    str(ckpt) + ".state")),
                ("save_state", lambda: eng.save_state(str(tmp / "t.state"))),
                ("save_checkpoint", lambda: save_checkpoint(
                    cfg, eng.module.state_dict(), str(tmp / "t.pth"))),
                ("load_model", lambda: load_model(str(tmp / "t.pth"), "MFT"))):
            t0 = time.perf_counter()
            fn()
            io[what] = time.perf_counter() - t0
        epochs = {2: [], 0: []}
        rng = np.random.RandomState(1)
        for depth in (2, 0, 0, 2, 2, 0):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.train_epoch(x, y, lens, rng=rng, prefetch=depth)
            torch.cuda.synchronize()
            epochs[depth].append(time.perf_counter() - t0)
        print(f"CLI layers: Train split read and windowed in {read_s:.3f} s "
              f"({len(lens)} videos, {sum(lens)} windows); "
              + ", ".join(f"{k} {v:.3f} s" for k, v in io.items())
              + f"; epoch s, prefetch 2 {[round(v, 4) for v in epochs[2]]}, "
              f"none {[round(v, 4) for v in epochs[0]]} (alternated)",
              flush=True)

        predictor = ValencePredictor.from_checkpoint(str(ckpt), "MFT",
                                                     device=device)
        traces = predictor.predict_dataset(load_send(mods, str(data_dir),
                                                     "Test"))
        ref = build_model(cfg)
        ref.load_state_dict({k: torch.from_numpy(v)
                             for k, v in state.items()})
        ref = ref.to(device).eval()
        ds, x, _, lens = cli.prepare_data(cfg, str(data_dir), "Test")
        worst = 0.0
        for vi, sid in enumerate(cli.seq_id_strings(ds.seq_ids)):
            n = int(lens[vi])
            inputs = {m: torch.from_numpy(x[m][vi:vi + 1, :n]).to(device)
                      for m in mods}
            with torch.inference_mode():
                want = ref(inputs, torch.ones(1, n, 1, device=device),
                           mask_mode="key_query", plain=True)
            worst = max(worst, float(np.abs(
                traces[sid] - want[0, :, 0].cpu().numpy()).max()))
        print(f"CLI phase on {card_line()}: {epoch_s:.3f} s per epoch, "
              f"{valid_s:.3f} s per validation pass", flush=True)
        print(f"ValencePredictor.from_checkpoint: {len(traces)} Test traces, "
              f"|bf16 kernel path - fp32 plain| = {worst:.3e} "
              f"(tol {SLICE_TOL:.0e})", flush=True)
        if len(traces) != n_test or worst > SLICE_TOL:
            raise SmokeFailure("the checkpoint's traces are outside the "
                               "serving tolerance")


def run_train_ab(torch, np, device) -> None:
    """The MFT A+V+L mixed step on each encoder backward, alternated."""
    from multimodal_transformer_tpu_torch import default_config
    from multimodal_transformer_tpu_torch.data import Batch
    from multimodal_transformer_tpu_torch.engine import Engine
    from multimodal_transformer_tpu_torch.ops.cuda.verify import time_ms

    cfg = default_config("MFT", AVL, mask_mode="key_query")
    engine = Engine(cfg, seed=1, train_dtype=torch.bfloat16, device=device)
    batch = _on_card(torch, Batch, _bench_batch(np, Batch, cfg, BENCH_B,
                                                BENCH_T, seed=3), device)
    counts = {}
    for route in ("stack", "perlayer"):
        engine.encoder_backward = route
        reset_counters()
        engine.train_step(batch)
        torch.cuda.synchronize()
        counts[route] = {k: v for k, v in read_counters().items() if v}
        if counts[route] != _train_launches(engine.module, route):
            raise SmokeFailure(f"train A/B: launches {counts[route]} on the "
                               f"{route!r} route")
    ms = {"perlayer": [], "stack": []}
    for _ in range(AB_ROUNDS // 2):
        for route in ("perlayer", "stack", "stack", "perlayer"):
            engine.encoder_backward = route
            ms[route].append(time_ms(lambda: engine.train_step(batch), reps=9))
    print(f"train A/B, MFT A+V+L B={BENCH_B} T={BENCH_T} bf16 mixed, batch on "
          f"the card, ms/step (median of 9, CUDA events), alternated: "
          f"perlayer {[round(v, 3) for v in ms['perlayer']]}, stack "
          f"{[round(v, 3) for v in ms['stack']]}; launches per step "
          f"{counts}", flush=True)


def _request(np, cfg, rng):
    """VIDEOS videos of MIN_WINDOWS..MAX_WINDOWS windows at the config's
    widths."""
    lens = rng.integers(MIN_WINDOWS, MAX_WINDOWS + 1, size=VIDEOS)
    W = int(lens.max())
    data = {m: rng.standard_normal((VIDEOS, W, FRAMES[m], cfg.mod_dimension[m]),
                                   dtype=np.float32) for m in cfg.modalities}
    return data, lens


def _fp32_errors(torch, np, module, data, lens, answers, device):
    """max |served trace - plain fp32 forward| over three videos (the
    shortest, the longest and one in the middle), and the same for the
    plain path in bf16 (the drift of bf16 itself, for reference)."""
    ref = copy.deepcopy(module).to(device=device, dtype=torch.float32).eval()
    low = copy.deepcopy(module).to(device=device, dtype=torch.bfloat16).eval()
    worst, worst_plain = 0.0, 0.0
    for vi in sorted({int(np.argmin(lens)), int(np.argmax(lens)),
                      len(lens) // 2}):
        n = int(lens[vi])
        x = {m: torch.from_numpy(v[vi:vi + 1, :n]).to(device)
             for m, v in data.items()}
        mask = torch.ones(1, n, 1, device=device)
        with torch.inference_mode():
            want = ref(x, mask, mask_mode="key_query", plain=True)[0, :, 0]
            bf = low({m: v.bfloat16() for m, v in x.items()}, mask.bfloat16(),
                     mask_mode="key_query", plain=True)[0, :, 0]
        want = want.cpu().numpy()
        worst = max(worst, float(np.abs(answers[vi] - want).max()))
        worst_plain = max(worst_plain, float(np.abs(
            bf.float().cpu().numpy() - want).max()))
    return worst, worst_plain


def run_families(torch, np, device):
    """Serve each configuration of FAMILIES through ValencePredictor."""
    from multimodal_transformer_tpu_torch import (ValencePredictor, build_model,
                                                  default_config)
    from multimodal_transformer_tpu_torch.ops.cuda.verify import time_ms

    rng = np.random.default_rng(5)
    for name, family, mods, variant, per_batch, tol in FAMILIES:
        cfg = default_config(family, mods, mask_mode="key_query",
                             variant=variant)
        module = build_model(cfg, generator=torch.Generator().manual_seed(0))
        predictor = ValencePredictor(cfg, module, device=device, bf16=True)
        data, lens = _request(np, cfg, rng)
        batches = n_batches(lens, predictor.batch_size,
                            predictor.time_multiple)
        reset_counters()
        t0 = time.perf_counter()
        traces = predictor.predict_padded(data, lens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: v for k, v in read_counters().items() if v}
        want = {k: n * batches for k, n in per_batch.items()}
        if got != want:
            raise SmokeFailure(f"{name}: launches {got}, expected {want}")
        check_front_end_routes(name)
        for tr, n in zip(traces, lens):
            if tr.shape != (int(n),) or not np.isfinite(tr).all():
                raise SmokeFailure(f"{name}: trace of length {tr.shape} for a "
                                   f"{n}-window video, or not finite")
        again = predictor.predict_padded(data, lens)
        if any(not np.array_equal(a, b) for a, b in zip(traces, again)):
            raise SmokeFailure(f"{name}: two calls on the same request differ")
        err, err_plain = _fp32_errors(torch, np, module, data, lens, traces,
                                      device)
        gen = torch.Generator().manual_seed(1)
        inputs = {m: torch.randn(BENCH_B, BENCH_T, FRAMES[m],
                                 cfg.mod_dimension[m], generator=gen).to(
            device=device, dtype=torch.bfloat16) for m in mods}
        mask = torch.ones(BENCH_B, BENCH_T, 1, device=device,
                          dtype=torch.bfloat16)
        mod = predictor.module
        with torch.inference_mode():
            ms = time_ms(lambda: mod(inputs, mask, mask_mode="key_query"),
                         reps=5)
            plain_ms = time_ms(lambda: mod(inputs, mask, mask_mode="key_query",
                                           plain=True), reps=3)
        print(f"{name}: {VIDEOS} videos in {batches} batches, {wall:.3f} s "
              f"(first use); launches {got}; |bf16 kernel path - fp32 plain| "
              f"= {err:.3e} (tol {tol:.0e}; bf16 plain path {err_plain:.3e}); "
              f"forward B={BENCH_B} T={BENCH_T} bf16: kernel path {ms:.3f} ms "
              f"= {BENCH_B * 1000.0 / ms:.1f} seq/s, plain path "
              f"{plain_ms:.3f} ms", flush=True)
        if err > tol:
            raise SmokeFailure(f"{name}: bf16 serving outside the tolerance")


# the legacy heads and tools phase: the heads at their default widths (the
# families smoke's 108 input features: acoustic + emotient), fp32, held to
# the same module on the CPU
LEGACY_B, LEGACY_T, LEGACY_WE = 32, 160, 108
LEGACY_TOL = 1e-4
TRACE_FORWARDS, TIMER_FORWARDS = 3, 10
WALKTHROUGH_EPOCHS = 2


@contextlib.contextmanager
def reader_log():
    """The SENDv1 reader's log lines ("mmtx.data": which parser read each
    split's files), whatever handlers its parent logger has."""
    lines = []

    class Handler(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    lg, h = logging.getLogger("mmtx.data"), Handler()
    level = lg.level
    lg.addHandler(h)
    lg.setLevel(logging.INFO)
    try:
        yield lines
    finally:
        lg.removeHandler(h)
        lg.setLevel(level)


def native_files(lines) -> list:
    """(split, files read natively, files) of each reader log line."""
    import re
    pat = re.compile(r"SENDv1 (\w+): (\d+) of (\d+) files read by the "
                     r"native parser")
    return [(m.group(1), int(m.group(2)), int(m.group(3)))
            for m in map(pat.search, lines) if m]


def trace_kernel_counts(path: Path) -> tuple:
    """(kernel events by name, runtime launch events, the least lag in us
    of a kernel's GPU start after its launch on the host: negative where
    the GPU timestamps run early, the places in launch order of the
    launches whose kernel the trace lacks) of a Chrome trace from
    torch.profiler; the throwaway kernels of engine.profiling.pad_window
    are counted under the name "pad"."""
    from multimodal_transformer_tpu_torch.engine.profiling import \
        PAD_KERNEL_MARK

    events = json.loads(path.read_text())["traceEvents"]
    kernels: dict = {}
    starts, launched = {}, {}
    for e in events:
        if e.get("cat") == "kernel":
            name = "pad" if PAD_KERNEL_MARK in e["name"] else e["name"]
            kernels[name] = kernels.get(name, 0) + 1
            starts[e["args"].get("correlation")] = e["ts"]
        elif (e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "LaunchKernel" in e.get("name", "")):
            launched[e["args"].get("correlation")] = e["ts"]
    lags = [t - launched[c] for c, t in starts.items() if c in launched]
    order = sorted(launched, key=launched.get)
    lost = [i for i, c in enumerate(order) if c not in starts]
    return kernels, len(launched), min(lags, default=math.nan), lost


def run_legacy_and_tools(torch, np, device) -> None:
    """The legacy ED/AR heads on the card against the CPU; a user's `trace`
    of three MFT A+V+L serving forwards holding every counted launch of
    kernels A, B and 10; StepTimer and device_memory_stats; the native
    SENDv1 parser built here; the walkthrough as a user runs it."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from multimodal_transformer_tpu_torch import ValencePredictor, build_model
    from multimodal_transformer_tpu_torch import default_config
    from multimodal_transformer_tpu_torch.data import (
        generate_synthetic_send, load_send, native_loader)
    from multimodal_transformer_tpu_torch.engine.profiling import (
        PAD_KERNELS, StepTimer, device_memory_stats, trace)
    from multimodal_transformer_tpu_torch.models.families import ENCODER_LAYERS
    from multimodal_transformer_tpu_torch.models.legacy_lstm import (
        MultiARLSTM, MultiEDLSTM)
    from multimodal_transformer_tpu_torch.ops.cuda.verify import time_ms

    # the legacy heads, fp32 (TF32 off since the gate), card against CPU
    rng = np.random.default_rng(19)
    x = rng.standard_normal((LEGACY_B, LEGACY_T, LEGACY_WE), dtype=np.float32)
    lens = rng.integers(LEGACY_T // 4, LEGACY_T + 1, size=LEGACY_B)
    lens[0] = LEGACY_T
    mask = (np.arange(LEGACY_T)[None, :] < lens[:, None]).astype(
        np.float32)[..., None]
    for name, cls in (("MultiEDLSTM", MultiEDLSTM),
                      ("MultiARLSTM", MultiARLSTM)):
        module = cls(LEGACY_WE, gen=torch.Generator().manual_seed(3)).eval()
        card = copy.deepcopy(module).to(device)
        xc, mc = torch.from_numpy(x).to(device), torch.from_numpy(mask).to(
            device)
        with torch.no_grad():
            want = module(torch.from_numpy(x), torch.from_numpy(mask))
            got = card(xc, mc)
            ms = time_ms(lambda: card(xc, mc), reps=5)
        err = float((got.cpu() - want).abs().max())
        finite = bool(torch.isfinite(got).all())
        print(f"{name} (embed 128, h 512) B={LEGACY_B} T={LEGACY_T} fp32: "
              f"|card - CPU| = {err:.3e} (tol {LEGACY_TOL:.0e}), "
              f"{ms:.3f} ms a forward on {card_line()}", flush=True)
        if err > LEGACY_TOL or not finite:
            raise SmokeFailure(f"{name}: the card's forward is not within "
                               f"{LEGACY_TOL} of the CPU's, or not finite")

    # a user's trace of the main path's serving forward
    cfg = default_config("MFT", AVL, mask_mode="key_query")
    predictor = ValencePredictor(
        cfg, build_model(cfg, generator=torch.Generator().manual_seed(0)),
        device=device, bf16=True)
    mod = predictor.module
    gen = torch.Generator().manual_seed(2)
    inputs = {m: torch.randn(BENCH_B, BENCH_T, FRAMES[m],
                             cfg.mod_dimension[m], generator=gen).to(
        device=device, dtype=torch.bfloat16) for m in AVL}
    bmask = torch.ones(BENCH_B, BENCH_T, 1, device=device,
                       dtype=torch.bfloat16)

    def forward():
        with torch.inference_mode():
            return mod(inputs, bmask, mask_mode="key_query")

    forward()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        reset_counters()
        with trace(tmp):
            for _ in range(TRACE_FORWARDS):
                forward()
        counts = read_counters()
        files = list(Path(tmp).glob("*.pt.trace.json"))
        if len(files) != 1:
            raise SmokeFailure(f"trace wrote {files}, not one Chrome trace")
        kernels, runtime_launches, lag, lost = trace_kernel_counts(files[0])
        # the same forwards in a session without the padding, for the
        # record: events it drops are those the padding keeps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(TRACE_FORWARDS):
                forward()
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(Path(tmp) / "control.json"))
        control = trace_kernel_counts(Path(tmp) / "control.json")
    # CUDA kernels a counted launch makes: kernel A's bf16 path 2 a layer +
    # 1, kernel B one LSTM scan and one memory scan (and its GEMMs), kernel
    # 10's wgmma route one
    per_launch = {"encoder_stack_fused": ("enc_wgmma::",
                                          2 * ENCODER_LAYERS + 1),
                  "mfn_scan_fused": (("lstm_scan_kernel", "mem_scan_kernel"),
                                     2),
                  "window_embed_highway": ("window_embed_wgmma_kernel", 1)}
    found_all = []
    for name, (keys, n) in per_launch.items():
        keys = (keys,) if isinstance(keys, str) else keys
        found = sum(c for k, c in kernels.items()
                    if "mmtx::" in k and any(key in k for key in keys))
        expected = n * counts[name]
        found_all.append((name, found, expected))
    pad = kernels.pop("pad", 0)
    print(f"trace of {TRACE_FORWARDS} MFT A+V+L serving forwards (B={BENCH_B} "
          f"T={BENCH_T} bf16): "
          + "; ".join(f"{k} {f} of {e} kernel events ({counts[k]} launches)"
                      for k, f, e in found_all)
          + f"; the forwards' kernel events {sum(kernels.values())} of "
          f"{runtime_launches - PAD_KERNELS} launches, {pad} of "
          f"{PAD_KERNELS} throwaway kernels, the earliest GPU start "
          f"{lag:.1f} us after its launch, lost launches at places "
          f"{lost[:20]} in launch order; without the padding "
          f"{sum(control[0].values())} of {control[1]}, {control[2]:.1f} us, "
          f"lost {control[3][:20]}", flush=True)
    if any(f != e or e == 0 for _, f, e in found_all):
        raise SmokeFailure("the trace does not hold every counted launch of "
                           "kernels A, B and 10")

    timer = StepTimer("serve")
    for _ in range(TIMER_FORWARDS):
        with timer:
            forward()
    print(f"StepTimer over {TIMER_FORWARDS} forwards: {timer.summary()}; "
          f"device_memory_stats(): {device_memory_stats()}", flush=True)
    stats = device_memory_stats()
    if timer.summary()["n"] != TIMER_FORWARDS or str(device) not in stats:
        raise SmokeFailure("StepTimer or device_memory_stats() is wrong")

    # the native parser, built on this host, read a split
    fresh = not native_loader.library_path().is_file()
    t0 = time.perf_counter()
    built = native_loader.available()
    build_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        generate_synthetic_send(tmp, {"Train": 2}, duration_s=20.0, seed=4)
        with reader_log() as lines:
            load_send(list(AVL), tmp, "Train")
    read = native_files(lines)
    print(f"native SENDv1 parser: {native_loader.library_path().name} "
          f"{'built' if fresh else 'found'} in {build_s:.3f} s "
          f"({native_loader.build_error or 'no error'}); reader: {lines}",
          flush=True)
    if not built or not read or any(n != total for _, n, total in read):
        raise SmokeFailure("the native SENDv1 parser was not built here or "
                           "did not read the split")

    # the walkthrough, as a user runs it
    here = Path(__file__).resolve().parent
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(here)] + [p for p in [env.get("PYTHONPATH")] if p])
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m",
             "multimodal_transformer_tpu_torch.walkthrough", "--workdir",
             str(tmp), "--epochs", str(WALKTHROUGH_EPOCHS), "--device",
             str(device)],
            cwd=tmp, env=env, capture_output=True, text=True, timeout=300)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise SmokeFailure(f"the walkthrough exited {proc.returncode}: "
                               f"{proc.stderr[-2000:]}")
        perf = (tmp / "PerfSave" / "B3-MFN.csv").read_text().splitlines()
        preds = list((tmp / "PredSave").glob("B3-MFN*.csv"))
        ckpt = tmp / "ModelSave" / "B3-MFN" / "B3-MFN-AL.pth"
        served = [ln for ln in proc.stdout.splitlines()
                  if "videos served" in ln]
        print(f"walkthrough, {WALKTHROUGH_EPOCHS} epochs: exit 0, "
              f"{wall:.1f} s wall; {ckpt.name} {ckpt.is_file()}, PerfSave "
              f"{len(perf) - 1} rows, PredSave {[p.name for p in preds]}; "
              f"{served}", flush=True)
        if (not ckpt.is_file() or perf[0] != "Model,Combination,VidID,Set,CCC"
                or len(perf) != 4 or len(preds) != 1
                or preds[0].read_text().splitlines()[0] != "time,pred,actual"
                or not served or not served[0].strip().startswith("3 videos")):
            raise SmokeFailure("the walkthrough's artifacts are missing: "
                               f"{proc.stdout[-2000:]}")


def run_query_mode(torch, np, device):
    """The MFT A+V+L in "query" mask mode: one eval forward, one train step."""
    from multimodal_transformer_tpu_torch import default_config
    from multimodal_transformer_tpu_torch.data import Batch
    from multimodal_transformer_tpu_torch.engine import Engine

    cfg = default_config("MFT", AVL)  # mask_mode "query", the default
    engine = Engine(cfg, seed=0, train_dtype=torch.bfloat16, device=device)
    batch = _bench_batch(np, Batch, cfg, 8, 64, seed=6)
    inputs = {m: torch.from_numpy(v).to(device, torch.bfloat16)
              for m, v in batch.data.items()}
    mask = torch.from_numpy(batch.mask).to(device, torch.bfloat16)
    fwd = copy.deepcopy(engine.module).to(torch.bfloat16).eval()
    reset_counters()
    with torch.inference_mode():
        pred = fwd(inputs, mask)
    eval_counts = {k: v for k, v in read_counters().items() if v}
    reset_counters()
    loss = engine.train_step(batch)
    torch.cuda.synchronize()
    train_counts = {k: v for k, v in read_counters().items() if v}
    print(f"query mode, MFT A+V+L B=8 T=64 bf16: forward launches "
          f"{eval_counts}, finite {bool(torch.isfinite(pred).all())}; train "
          f"step loss {loss:.5f}, launches {train_counts}", flush=True)
    if eval_counts != {"mfn_scan_fused": 1, "window_embed_highway": 3}:
        raise SmokeFailure("query-mode forward: unexpected launches")
    if train_counts != {"mfn_train_fwd": 1, "mfn_train_bwd": 1,
                        "window_embed_highway": 3}:
        raise SmokeFailure("query-mode train step: unexpected launches")
    if not (torch.isfinite(pred).all() and math.isfinite(loss)):
        raise SmokeFailure("query mode: a value is not finite")


def run_long_videos(torch, np, device):
    """Serve one request of long videos through each of LONG_FAMILIES; every
    bucket is past 512 windows, so every encoder takes the flash route.
    Returns the MFT A+V+L run's launch counts."""
    from multimodal_transformer_tpu_torch import (ValencePredictor, build_model,
                                                  default_config)

    rng = np.random.default_rng(11)
    lens = rng.integers(LONG_MIN, LONG_MAX + 1, size=LONG_VIDEOS)
    W = int(lens.max())
    data = {m: rng.standard_normal((LONG_VIDEOS, W, FRAMES[m], dim),
                                   dtype=np.float32)
            for m, dim in default_config("MFT", AVL).mod_dimension.items()
            if m in AVL}
    mft_counts = None
    for name, family, mods, per_batch, tol in LONG_FAMILIES:
        cfg = default_config(family, mods, mask_mode="key_query")
        module = build_model(cfg, generator=torch.Generator().manual_seed(0))
        predictor = ValencePredictor(cfg, module, device=device, bf16=True)
        request = {m: data[m] for m in mods}
        batches = n_batches(lens, predictor.batch_size,
                            predictor.time_multiple)
        reset_counters()
        t0 = time.perf_counter()
        traces = predictor.predict_padded(request, lens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: v for k, v in read_counters().items() if v}
        want = {k: n * batches for k, n in per_batch.items()}
        if got != want:
            raise SmokeFailure(f"{name}, long videos: launches {got}, "
                               f"expected {want}")
        check_front_end_routes(f"{name}, long videos")
        if mft_counts is None:
            mft_counts = got
            print(f"profile of the {name} long-video request:", flush=True)
            try:
                _profile(torch, lambda: predictor.predict_padded(request,
                                                                 lens), 1)
            except Exception as e:  # the profiler is a reading, not a check
                print(f"profile: not available ({type(e).__name__}: {e})",
                      flush=True)
        for tr, n in zip(traces, lens):
            if tr.shape != (int(n),) or not np.isfinite(tr).all():
                raise SmokeFailure(f"{name}: trace of length {tr.shape} for a "
                                   f"{n}-window video, or not finite")
        t0 = time.perf_counter()
        again = predictor.predict_padded(request, lens)
        warm = time.perf_counter() - t0
        if any(not np.array_equal(a, b) for a, b in zip(traces, again)):
            raise SmokeFailure(f"{name}: two calls on the same request differ")
        err, err_plain = _fp32_errors(torch, np, module, request, lens,
                                      traces, device)
        print(f"{name}, long videos: {LONG_VIDEOS} videos of {int(lens.min())}"
              f"-{W} windows in {batches} batches, {wall:.3f} s first use, "
              f"{warm:.3f} s again; launches {got}; |bf16 kernel path - fp32 "
              f"plain| = {err:.3e} (tol {tol:.0e}; bf16 plain path "
              f"{err_plain:.3e})", flush=True)
        if err > tol:
            raise SmokeFailure(f"{name}: bf16 long-video serving outside the "
                               "tolerance")
    return mft_counts


def run_crossover(torch, device):
    """The B=32 encoder stack (D=256, 6 layers) through kernel A and through
    the flash route, alternated (A, flash, flash, A), bf16 and fp32."""
    from multimodal_transformer_tpu_torch.ops.attention import \
        encoder_stack_flash
    from multimodal_transformer_tpu_torch.ops.cuda.encoder import \
        encoder_stack_fused
    from multimodal_transformer_tpu_torch.ops.cuda.verify import (
        random_encoder, time_ms)

    gen = torch.Generator().manual_seed(7)
    enc32 = random_encoder(gen).to(device)
    for dtype in (torch.bfloat16, torch.float32):
        enc = copy.deepcopy(enc32).to(dtype)
        for T in CROSSOVER_T:
            x = torch.randn(BENCH_B, T, 256, generator=gen).to(device, dtype)
            mask = torch.ones(BENCH_B, T, 1, device=device, dtype=dtype)
            route = {"kernel A": lambda: encoder_stack_fused(enc, x, mask),
                     "flash route": lambda: encoder_stack_flash(enc, x, mask)}
            ms = {k: [] for k in route}
            with torch.inference_mode():
                for k in ("kernel A", "flash route", "flash route",
                          "kernel A"):
                    ms[k].append(time_ms(route[k], reps=5))
            print(f"crossover B={BENCH_B} T={T} D=256 6 layers "
                  f"{str(dtype).split('.')[-1]}: kernel A "
                  f"{[round(v, 3) for v in ms['kernel A']]} ms, flash route "
                  f"{[round(v, 3) for v in ms['flash route']]} ms "
                  "(median of 5, CUDA events)", flush=True)


def _eval_set(np, cfg, rng, n: int):
    """n videos of MIN_WINDOWS..LONG_MAX windows, targets zero past each
    video's length (as the SENDv1 reader pads them)."""
    lens = rng.integers(MIN_WINDOWS, LONG_MAX + 1, size=n)
    W = int(lens.max())
    data = {m: rng.standard_normal((n, W, FRAMES[m], cfg.mod_dimension[m]),
                                   dtype=np.float32) for m in cfg.modalities}
    target = rng.standard_normal((n, W), dtype=np.float32) * (
        np.arange(W)[None, :] < lens[:, None])
    return data, target.astype(np.float32), [int(v) for v in lens]


def run_evaluation(torch, np, device):
    """Engine.evaluate_per_video and evaluate_batched at full MFT A+V+L
    widths; a "query"-mode per-video evaluation."""
    from multimodal_transformer_tpu_torch import default_config
    from multimodal_transformer_tpu_torch.engine import Engine
    from multimodal_transformer_tpu_torch.ops.metrics import ccc

    cfg = default_config("MFT", AVL, mask_mode="key_query")
    log = logging.getLogger("chip_smoke.eval")
    log.setLevel(logging.INFO)
    log.propagate = False
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter("%(message)s"))
    log.addHandler(handler)
    engine = Engine(cfg, seed=0, device=device, logger=log)
    data, target, lens = _eval_set(np, cfg, np.random.default_rng(9),
                                   EVAL_VIDEOS)
    V = len(lens)
    n_long = sum(n > 512 for n in lens)
    if not 0 < n_long < V:
        raise SmokeFailure("the evaluation set needs short and long videos")

    def counted(fn):
        reset_counters()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return out, {k: v for k, v in read_counters().items() if v}, wall

    per, got, wall = counted(lambda: engine.evaluate_per_video(data, target,
                                                               lens))
    cccs, preds, actuals, loss, stats, best = per
    want = {"flash_attention_masked": 18 * n_long,
            "encoder_stack_fused": 3 * (V - n_long), "mfn_scan_fused": V,
            "window_embed_highway": 3 * V}
    print(f"evaluate_per_video: {V} videos of {min(lens)}-{max(lens)} "
          f"windows ({n_long} past 512), fp32, {wall:.3f} s (first use); "
          f"launches {got}; loss {loss:.6f}, CCC {stats['ccc']:.6f} "
          f"(std {stats['ccc_std']:.6f}, max {stats['max_ccc']:.6f})",
          flush=True)
    if got != want:
        raise SmokeFailure(f"evaluate_per_video: launches {got}, expected "
                           f"{want}")
    again = [ccc(a, p) for a, p in zip(actuals, preds)]
    if len(cccs) != V or any(len(p) != n for p, n in zip(preds, lens)) or \
            max(abs(a - b) for a, b in zip(again, cccs)) > 1e-12 or \
            not all(math.isfinite(c) for c in cccs + [loss]):
        raise SmokeFailure("evaluate_per_video: CCCs do not follow from the "
                           "returned predictions, or a value is not finite")

    bounds = sorted({-(-n // 32) * 32 for n in lens})
    long_batches = sum(b > 512 for b in bounds)
    tols = {"float32": EVAL_FP32_TOL, "bfloat16": 2 * SLICE_TOL / min(
        float(np.std(target[i, :n])) for i, n in enumerate(lens))}
    for dtype in (None, torch.bfloat16):
        engine.eval_dtype = dtype
        name = "float32" if dtype is None else "bfloat16"
        (b_cccs, b_loss, b_stats), got, wall = counted(
            lambda: engine.evaluate_batched(data, target, lens))
        want = {"flash_attention_masked": 18 * long_batches,
                "encoder_stack_fused": 3 * (len(bounds) - long_batches),
                "mfn_scan_fused": len(bounds),
                "window_embed_highway": 3 * len(bounds)}
        diff = max(abs(a - b) for a, b in zip(b_cccs, cccs))
        print(f"evaluate_batched {name}: {len(bounds)} buckets of 32 videos "
              f"({long_batches} past 512), {wall:.3f} s (first use); launches "
              f"{got}; loss {b_loss:.6f} (per video {loss:.6f}), CCC "
              f"{b_stats['ccc']:.6f}; max |CCC - per-video CCC| = "
              f"{diff:.3e} (tol {tols[name]:.1e})", flush=True)
        if got != want:
            raise SmokeFailure(f"evaluate_batched {name}: launches {got}, "
                               f"expected {want}")
        if diff > tols[name] or not math.isfinite(b_loss):
            raise SmokeFailure(f"evaluate_batched {name}: CCCs outside the "
                               "tolerance of the per-video ones")
    engine.eval_dtype = None

    qcfg = default_config("MFT", AVL)  # "query", the reference's mode
    query = Engine(qcfg, seed=0, device=device)
    q_idx = [int(i) for i in np.argsort(lens)[[0, 1, -2, -1]]]
    q_lens = [lens[i] for i in q_idx]
    (q_cccs, *_), got, _ = counted(lambda: query.evaluate_per_video(
        {m: v[q_idx] for m, v in data.items()}, target[q_idx], q_lens))
    print(f"query-mode evaluate_per_video: 4 videos of {q_lens} windows; "
          f"launches {got}; CCCs {[round(float(c), 6) for c in q_cccs]}",
          flush=True)
    if got != {"mfn_scan_fused": 4, "window_embed_highway": 12} or \
            not all(math.isfinite(c) for c in q_cccs):
        raise SmokeFailure("query-mode evaluation: unexpected launches or a "
                           "value that is not finite")


def _json_entry(name, checks, launches):
    """The kernel's line: its bf16 main-path check (kernel 11's at the first
    long-video bucket, T = 544), and for the window embed the sum over the
    three front ends of one MFT A+V+L forward."""
    if name == "flash_attention_masked":
        cs = [c for c in checks if c.name == name and c.dtype == "bfloat16"
              and c.shape == f"B={BENCH_B} h=8 T={FLASH_MAIN_T} dk=32"]
    elif name == "encoder_stack_fused":
        cs = [c for c in checks if c.name == name and c.dtype == "bfloat16"
              and c.shape == f"B={BENCH_B} T={BENCH_T} D=256"]
    elif name == "window_embed_highway":
        cs = [c for c in checks if c.name == name and c.dtype == "bfloat16"
              and any(c.shape == f"B={BENCH_B} T={BENCH_T} F={f} D={d} E={e}"
                      for f, d, e in MFT_WINDOW_EMBED)]
    else:
        cs = [c for c in checks if c.name == name and c.dtype == "bfloat16"
              and c.shape.startswith(f"B={BENCH_B} T={BENCH_T} ")]
    # one launch per check: the bounds add up, and the larger share names
    # what bounds the sum
    ops_ms = sum(c.bound_ms for c in cs if c.bound_by == "operations")
    bytes_ms = sum(c.bound_ms for c in cs if c.bound_by == "bytes")
    source, replaces = SOURCES[name]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(c.err for c in cs),
            "ms": sum(c.ms for c in cs), "plain_ms": sum(c.plain_ms for c in cs),
            "bound_ms": ops_ms + bytes_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": (None if any(math.isnan(c.library_ms) for c in cs)
                           else sum(c.library_ms for c in cs))}


def main() -> int:
    import torch

    phase("gate")
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device; chip_smoke.py runs only on a GPU",
              file=sys.stderr)
        return 1
    print(card_line(), flush=True)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import numpy as np

    here = Path(__file__).resolve().parent
    if not (here / "multimodal_transformer_tpu_torch" / "csrc").is_dir():
        raise SmokeFailure(f"run from a checkout of the repository: {here} "
                           "holds no multimodal_transformer_tpu_torch/csrc")
    sys.path.insert(0, str(here))
    from multimodal_transformer_tpu_torch.ops.cuda import _build

    phase("build")
    t0 = time.perf_counter()
    lib_path = _build.build(verbose=True)
    _build.load()
    print(f"built {lib_path.name} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for symbol in (FLASH_WGMMA, MFN_STAGED, MFN_TRAIN, ENC_WGMMA, ENC_BWD,
                   WE_WGMMA, WE_TILES):
        for line in ptxas_lines(_build.build_log, symbol):
            print(f"ptxas {line}", flush=True)
    spills = spill_gate(_build.build_log, ENC_BWD,
                        [k for k, _ in ENC_BWD_SASS] + ["enc_bwd10sum_kernel"]
                        + list(ENC_TRAIN_FWD_ATTN))
    if spills:
        raise SmokeFailure(f"kernels 3/4/5's enc_bwd kernels spill {spills} "
                           "bytes")
    spills = spill_gate(_build.build_log, ENC_WGMMA, ENC_TRAIN_FWD_CHAINS)
    if spills:
        raise SmokeFailure(f"kernels A/3's enc_wgmma kernels spill {spills} "
                           "bytes")
    spills = spill_gate(_build.build_log, MFN_TRAIN, MFN_TRAIN_KERNELS)
    if spills:
        raise SmokeFailure(f"kernel 7's stages spill {spills} bytes")
    spills = spill_gate(_build.build_log, MFN_STAGED, MFN_STAGED_KERNELS)
    if spills:
        raise SmokeFailure(f"kernel B's stages (kernels B and 6, rows 8 and "
                           f"9) spill {spills} bytes")
    spills = spill_gate(_build.build_log, WE_WGMMA, WE_WGMMA_KERNELS)
    if spills:
        raise SmokeFailure(f"kernel 10's wgmma route spills {spills} bytes")
    spills = spill_gate(_build.build_log, WE_TILES, WE_TILES_KERNELS)
    if spills:
        raise SmokeFailure(f"kernel 10's tiles route spills {spills} bytes")
    print(f"SASS of {FLASH_WGMMA}: {sass_check(lib_path, FLASH_WGMMA)}",
          flush=True)
    for symbol, wanted in (ENC_WGMMA_SASS + ENC_BWD_SASS + ENC_TRAIN_FWD_SASS
                           + (("window_embed_wgmma_kernel",
                               ("HGMMA", "UTMALDG")),)):
        sass = sass_check(lib_path, symbol, wanted)
        print(f"SASS of {symbol}: {sass}", flush=True)
        if " NO" in sass or sass.startswith(("not checked", "no function")):
            raise SmokeFailure(f"{symbol}: {sass}")

    phase("kernels against their plain versions")
    checks = run_kernel_checks(torch, device)

    phase("slice")
    launches = run_slice(torch, np, device)

    phase("MFN variants")
    launches.update(run_mfn_variants(torch, device))

    phase("families")
    run_families(torch, np, device)

    phase("legacy heads and tools")
    run_legacy_and_tools(torch, np, device)

    phase("long videos")
    long_counts = run_long_videos(torch, np, device)
    launches["flash_attention_masked"] = long_counts[
        "flash_attention_masked"]
    run_crossover(torch, device)

    phase("evaluation")
    run_evaluation(torch, np, device)

    phase("train kernels against their plain versions")
    checks += run_train_kernel_checks(torch, device)

    phase("train")
    train_launches = run_train(torch, np, device)
    del train_launches["window_embed_highway"]  # counted on the serving path
    launches.update(train_launches)

    phase("dropout-free training")
    run_dropout_free_train(torch, np, device)

    phase("query mode")
    run_query_mode(torch, np, device)

    phase("families train")
    train_ms = run_families_train(torch, np, device)
    print("families train, bf16 mixed ms/step (card batch, host batch): "
          + "; ".join(f"{k} {a:.3f}, {b:.3f}" for k, (a, b) in
                      train_ms.items()), flush=True)

    phase("parallel")
    run_parallel(torch, np, device)

    phase("CLI")
    run_cli(torch, np, device)

    phase("train A/B")
    run_train_ab(torch, np, device)

    print(json.dumps({"kernels": [_json_entry(name, checks, launches)
                                  for name in SOURCES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"FAIL in phase {_PHASE[0]!r}: {e}", file=sys.stderr)
        sys.exit(1)
    except Exception:
        # a CUDA error's device-side messages can fill the end of stderr:
        # the phase goes last, after the traceback
        import traceback
        traceback.print_exc()
        print(f"FAIL in phase {_PHASE[0]!r} at "
              f"{time.perf_counter() - _START:.1f} s (traceback above)",
              file=sys.stderr, flush=True)
        sys.exit(1)
