#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Drives the HOBFLOPS CNN inference path at the paper's MobileNets
14x14x512 width in hobflops9, quantized-weight LM serving at
qwen2-0.5b's, olmoe-1b-7b's, mamba2-2.7b's and seamless-m4t-medium's
full width, jamba-v0.1-52b and internvl2-26b at full width from
hobflops9 weights, qwen2-0.5b prefill at 32768 tokens, and LM training at
qwen2-0.5b's full width (on one card and on a one-card device mesh),
through the entry points a user calls, and holds every hand-written
CUDA kernel against its plain torch version:

1. prints the card's name and power limit, builds the kernels with
   ``nvcc`` (one process per source, started together) and prints
   each kernel's registers, shared memory and spills from
   ``-Xptxas -v``, the MAC kernels' blocks at the main path's shapes,
   the blockwise attention kernels that bf16 and float32 inputs launch
   (traced: the tensor-core route and the FFMA route), and the
   dependent-LOP3 latency L from a ``clock64()`` microbenchmark;
2. answers three requests (batch 1, 2, 4) through the linear stack
   (3x3 512->512 conv, two 1x1 512->512 convs, ReLU after each) with the
   default ``cuda_fused`` backend and again with ``cuda``: the two must
   be bit-identical; prints each request's time and its relative error
   against a float32 conv chain;
3. runs the residual graph (maxpool, residual add, strided 3x3 at
   e5m5, avgpool head) once on each backend, bit-identical, and against
   its per-layer f32-boundary oracle, bit-identical;
3b. serves the stack through the lane-batched engine
   (``repro_torch.serve_conv.ConvServeEngine``, ``cuda_fused``,
   ``max_batch`` derived from the card's free memory) with its
   hobflops8 variant registered for overload: a scripted queue of 24
   requests (singles and mini-batches of 2 and 4, in arrival groups that
   close ragged, padded waves on a 5 ms deadline) with one injected
   transient wave error, then an overload burst of 48 4-image requests
   that degrades to hobflops8 and two single requests that recover.
   Every response must equal ``graph.run`` on that request alone at its
   precision (int32 bit patterns); any request quarantined, expired or
   rejected, or a wave failure other than the injected one, fails the
   run.  Then one wave at each bucket of the ladder (median of 5 after a
   warm-up: wave ms, images/s, GMAC/s), one traced wave at bucket 1 and
   one at the largest bucket (busy share, device ms and launches of
   ``fused_mac``, the torch ops and the copies), and the engine's
   ``stats()`` summary;
4. compares each kernel with its plain version, bit-exact, on the 1x1
   512->512 layer and on the 3x3 layer at cin 64;
5. times each kernel with CUDA events at the main path's shapes, and
   the stack's steady requests; for both MAC kernels also the
   serial-chain bound (C steps x the add-only chain's accumulator-path
   depth a step x L at the SM clock), the share of the larger bound and
   the cycles a MAC step, and for the interpreter its design's
   shared-memory floor (four accesses a warp-gate);
6. traces requests of batch 1 and 4 with ``torch.profiler``: the
   device's busy share and device time and launches by kernel group;
7. serves qwen2-0.5b (24 layers, d_model 896, vocab 151936; random
   weights from ``torch.Generator().manual_seed(--seed)``) through
   ``serve_demo`` at batch 4, 128 prompt tokens, 16 generated, once with
   float32 weights and once with hobflops9 bitplane weights, each after
   a 2-token warm-up call with the same weights: quantize time,
   footprint, prefill and decode times, tokens/s, greedy agreement;
   logits must be finite and layer 0's ``w_up`` dequantized on the card
   must equal a numpy decode of its codes bit for bit; one prefill and
   three decode steps of each are traced with ``torch.profiler`` (host
   time, device busy time, kernel launches); each prefill launches the
   blockwise attention forward kernel;
7b. serves the other LM families at full width and depth, each tree
   drawn on the card by a CUDA generator: olmoe-1b-7b (64 experts
   top-8) and mamba2-2.7b (SSD, 320-token prompts: its 256-token chunk
   pads and carries) through ``serve_demo`` at batch 4, 8 tokens, with
   float32 and hobflops9 weights after a 2-token warm-up each;
   seamless-m4t-medium (enc-dec, 128 frames and 128 prompt tokens) with
   float32 weights.  olmoe's layer-0 dispatch ``moe`` at capacity 8.0
   is held against ``moe_dense_ref`` on the card, and one decode step of
   each weight format is traced (and mamba2-2.7b's float32 one).  On
   mamba2-2.7b at float32 compute a ``decode_step`` after a 319-token
   ``prefill`` is held against ``forward_logits``, and ``ServeEngine``
   serves a queue of 6 requests in 4 slots (one stopping at its EOS)
   and, in one slot, equals the plain prefill/decode loop token for
   token.  jamba-v0.1-52b and
   internvl2-26b, which need 209.5 and 79.5 GB at full depth and float32,
   run as smoke twins: decode after prefill against the forward.  Every
   prefill (the enc-dec encoder and cross-attention among them) runs the
   blockwise attention forward kernel;
7c. serves jamba-v0.1-52b (SSD at 8192 heads of width 1, 16 experts
   top-2, attention every 8th layer; drawn at its full 32 layers, served
   at 16 cut from that draw: ``FULL_LAYERS``) and internvl2-26b (512
   prefix rows, 48
   layers) at full width from hobflops9 weights that no float32 tree
   precedes:
   each leaf is drawn on the card in ``init_params``' order from its
   CUDA generator and quantized (``quantize_params``' rule, a layer
   slice at a time, in chunks) before the next is drawn; on both smoke
   twins that draw must equal ``quantize_params(init_params(...))``
   bit for bit (every plane word, scale and dense leaf).  Each config:
   stored bytes, draw seconds and peak, free memory (the draw's and the
   serve's peak must leave ``FULL_MIN_FREE_GB`` free); ``serve_demo`` at
   batch 2, 64 prompt tokens, 4 generated (first calls, no warm-up):
   prefill ms, decode ms a step, tokens/s, peak, launches (the attention
   forward kernel must be among them); the attention kernel against its
   plain version on a prefill's first attention layer's bf16 inputs (D
   128; G 4, or G 6 beside the prefix rows) and on normal draws of their
   shapes, at step 10a's bounds; one decode step traced (busy share,
   launches, top kernels); decode after prefill against the forward
   through the same dequant hook within ``DECODE_TOL``;
8. trains qwen2-0.5b at full width and depth through ``train_loop``
   (parameters drawn on the card; bf16 compute, float32 parameters and
   moments; sequence 4096, global batch 8 in 4 remat'd micro-batches of
   2, train_4k's batch of 256 cut for one card and the time limit):
   4 steps with a checkpoint every 2 into a temporary directory and a
   simulated crash after step 2, then a second run that restores step 1
   and replays steps 2-3.  Losses and gradient norms must be finite (the
   norms > 0), and the resumed step 2's loss within ``RESUME_TOL`` of
   the first run's.  Prints the steady step's ms, tokens/s and model
   TFLOP/s, the peak memory, the host's batch ms, each checkpoint's
   bytes and device->host and file seconds, the restore's seconds, one
   traced step (busy share, launches, top kernels); then the remat
   check: at sequence 512, batch 1, gradients with remat against those
   without, within ``REMAT_TOL`` of a leaf's largest.  Every attention
   layer runs the blockwise attention kernels, forward (twice, with
   remat) and backward; the run fails if either is not launched;
9. runs the distribution layer on a one-card mesh: (9a) starts a
   one-rank NCCL group with ``launch.mesh.host_mesh``; (9b) trains step
   8's configuration for 2 steps through ``train_loop(mesh=)`` (state
   and batches as DTensors, the activation anchors on) and holds each
   loss to step 8's first run within ``RESUME_TOL``, printing its steady
   step beside step 8's and its ``max_memory_allocated``; (9c) traces
   the same step with ``launch.dryrun.build`` on meta tensors and holds
   the predicted per-device peak to ``DRY_PEAK_RANGE`` times 9b's (above
   what the process held before) and the counted matmul FLOPs to
   ``dense_train_flops`` within ``DRY_FLOP_TOL``, printing the H100
   roofline's step time beside 9b's (no claim); (9d) runs 3 rounds of
   int8 error-feedback ``compress_grads`` over the embedding leaf on the
   card, bit for bit against the CPU, and ``compressed_psum`` over the
   one-rank group against ``dequantize_int8(*quantize_int8(x))``;
10. the blockwise attention kernels (``csrc/flash_attention.cu``; the
   reference computes ``_flash`` with ``jnp``): (10a) at step 8's
   attention (batch 2, sequence 4096, 14 query heads over 2 kv heads,
   head 64, bf16, causal: the tensor-core route) forward and backward,
   and at one 32768-token layer the forward, against the plain versions
   on the same CUDA tensors within ``FLASH_TOL`` and with at most
   ``FLASH_BITS_OFF`` of each bf16 output's elements not bit-equal to
   the plain version's; two calls of each equal bit for bit; the float32
   (FFMA) route at a small shape within ``FLASH_F32_TOL``; timed with
   CUDA events beside three bounds (the tensor cores over the bf16
   half-products the function needs, ``exp``, and the f32 FFMA bound of
   the FFMA design), the bytes at 3.35 TB/s,
   the FFMA design's times (PERF.md run F3, not measured in the run),
   the plain version and ``scaled_dot_product_attention`` in float32 (a
   yardstick on no path); (10b) qwen2-0.5b prefill of 32768 tokens
   (prefill_32k's length, batch 1) through ``make_prefill_step``: ms,
   ``max_memory_allocated``, finite last logits, 24 launches a prefill;
   at 4096 tokens and float32 compute its last logits against the same
   prefill with the plain version within ``PREFILL_TOL``; (10c) step
   8's step time, peak, traced busy share and top kernels beside its
   reading before these kernels (PERF.md run D8);
11. runs the dequant matmul through its entry point at each quantized
   projection shape of that model, at M = 512 (a prefill's rows) and
   M = 4 (a decode step's), on layer 0's weights packed in hobflops9:
   held against its plain version within the float32 summation bound,
   and at most ``DQ_SPLIT_MARGIN`` of the error of a single-TF32 product
   (the plain version on x rounded to TF32), and timed (median of 20
   launches after 3 warm-ups) beside its FMA route (the route it keeps
   for w_f > 10), its bound (two TF32 products, each weight decoded
   once, the bytes) and the f32-FMA bound, the plain version and
   ``torch.matmul`` on the decoded weight;
12. prints one JSON ``kernels`` line and, last, the ``ok`` line.

Launch counts are zeroed just before steps 2-3, 3b (its queue, fault
and burst), 7, 7b, 7c (each config's ``serve_demo``), 8, 9b, 10b and 11
and read just after each; they
count CUDA kernels (the dequant matmul's tensor-core route launches up
to three a call, the attention backward four; their rows
also give the calls).
Earlier designs' times are printed from PERF.md, marked so, and are not
in the JSON line.  Any mismatch or failure exits non-zero.  Conv weights and
images come from ``numpy.random.default_rng(--seed)``.
``scripts/torch_fused_regfile.py``, ``scripts/torch_fused_probe.py`` and
``scripts/torch_dequant_probe.py`` import the card query, the
``-Xptxas -v`` parser, the timers and the LOP3 microbenchmark from
here.

Run from the repository root: ``python3 chip_smoke.py``.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
TF32_FLOPS_PER_S = 495e12      # H100 SXM data sheet, dense TF32
INT32_LANES_PER_SM = 64        # 32-bit integer/logic results per clock per SM
FP32_LANES_PER_SM = 128        # float32 FMA lanes per SM (2 flops each)
HW, WIDTH = 14, 512            # MobileNets' 14x14x512 stage
REPS = 20                      # timed calls after the warm-up
TRACED_REQS = 10               # requests under the profiler, per batch
# The serving phase: its scripted queue's arrival groups (images a
# request), the overload burst (requests of 4 images), the wave deadline
# and the timed waves at each bucket.
SERVE_GROUPS = ((1, 2, 1, 4, 1), (2, 2, 1), (4, 1, 2), (1,),
                (4, 4, 2, 1, 1, 2), (1, 2, 4), (2, 1, 1))
SERVE_FAULT_GROUP = 2           # the group whose wave gets the injected error
SERVE_BURST = 48
SERVE_DEADLINE_MS = 5.0
SERVE_REPS = 5
LM_ARCH = "qwen2-0.5b"
LM_BATCH, LM_PROMPT, LM_GEN = 4, 128, 16
DQ_MS = (LM_BATCH * LM_PROMPT, LM_BATCH)   # prefill rows, decode-step rows
# Step 7b: the other LM families.  Batch and tokens of each serve_demo
# call; mamba2-2.7b's prompt is 320 so its 256-token chunk pads and
# carries across two chunks.
FAM_BATCH, FAM_GEN = 4, 8
FAM_PROMPT = {"olmoe-1b-7b": 128, "mamba2-2.7b": 320,
              "seamless-m4t-medium": 128}
# The engine's queue on mamba2-2.7b: (prompt tokens, max_new) a request,
# the one given an EOS, and the slots.
ENGINE_QUEUE = ((16, 4), (128, 8), (48, 6), (96, 8), (32, 5), (64, 7))
ENGINE_EOS_AT, ENGINE_SLOTS = 1, 4
# float32 bounds of step 7b, as a share of the largest reference value:
# dispatch moe against moe_dense_ref (the reference's own test allows
# 1e-4 relative), and a decode step after prefill against the full
# forward (the reference allows 3e-2; the path difference measured on
# the CPU is ~1e-6 of the largest logit).
MOE_TOL, DECODE_TOL = 1e-4, 1e-3
# Step 7c: jamba-v0.1-52b and internvl2-26b served at full width from
# hobflops9 weights drawn and quantized leaf by leaf on the card: batch,
# prompt tokens (internvl2 adds its num_prefix prefix rows) and tokens
# generated, once each, no warm-up (first-call times).  The draw holds
# one float32 leaf at a time; QUANT_CHUNK elements of a layer's slice are
# encoded at a time (quantize's temporaries take ~70 B an element:
# jamba's draw peaks at 80.18 GB with 2^26-element chunks, 76.65 GB with
# 2^24, on an H100 80GB HBM3; PERF.md runs K2, K4).  The draw's and each
# serve's peak must leave FULL_MIN_FREE_GB of the card free.  On the
# smoke twins, chunks of TWIN_CHUNK elements, the result must equal
# quantize_params on init_params bit for bit.  The decode-after-prefill
# check runs at capacity factor FULL_CAPACITY, where the forward drops no
# token that decode keeps.  jamba is drawn at full depth (59.72 GB
# stored), then served at FULL_LAYERS layers, the first 2 of the 4
# repeats of its 8-layer period cut from that draw (every width full):
# the hook decodes an expert slice (3.76 GB float32) through 8x that in
# temporaries (30.06 GB on an H100 80GB HBM3, PERF.md run K1) while the
# two slices before it are held, more than the card holds beside 59.72
# GB (K1: out of memory at a 78.55 GB peak).  The attention kernel is
# held to its plain version on the inputs of a prefill's first attention
# layer and on normal draws of their shape, as step 10a holds it.
FULL_ARCHS = ("internvl2-26b", "jamba-v0.1-52b")
FULL_LAYERS = {"jamba-v0.1-52b": 16}
FULL_BATCH, FULL_PROMPT, FULL_GEN = 2, 64, 4
FULL_CAPACITY = 8.0
FULL_MIN_FREE_GB = 4.0
QUANT_FMT, QUANT_CHUNK, TWIN_CHUNK = "hobflops9", 1 << 24, 4096
# Step 8: qwen2-0.5b trained at full width and depth.  Sequence 4096 is
# train_4k's; its global batch of 256 is cut to 8 (micro-batches of 2,
# accumulated 4 times) for one card and the script's time limit.  Four
# steps, a checkpoint every 2, a crash after step 2, then a resumed run;
# the resumed step 2 must give the first run's loss within RESUME_TOL
# relative (the embedding's backward adds with atomics on the card, so
# the loss is not bit-stable).  The remat check runs at sequence 512,
# micro-batch 1, where the kept activations fit: gradients with remat
# within REMAT_TOL * max|leaf| of those without.
TRAIN_ARCH = "qwen2-0.5b"
TRAIN_SEQ, TRAIN_MICRO, TRAIN_N_MICRO = 4096, 2, 4
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_KILL_AT = 4, 2, 2
REMAT_SEQ = 512
RESUME_TOL, REMAT_TOL = 1e-3, 1e-4
# Step 9: step 8's configuration on a one-card mesh for DIST_STEPS steps;
# the dry run's predicted peak must lie in DRY_PEAK_RANGE times the
# measured one (above what the process held before), its matmul FLOPs
# within DRY_FLOP_TOL of the analytic count; COMPRESS_ROUNDS rounds of
# int8 error-feedback compression, bit for bit against the CPU.
DIST_STEPS = 2
DRY_PEAK_RANGE, DRY_FLOP_TOL = (0.75, 1.25), 0.01
COMPRESS_ROUNDS = 3
# Step 10: the blockwise attention kernels.  10a at step 8's attention
# (batch 2, sequence 4096, 14 query heads over 2 kv heads, head 64, bf16
# inputs, causal) forward and backward, and at one FLASH_LONG-token
# layer (prefill_32k's length, batch 1) the forward, each against its
# plain version on the card: within FLASH_TOL of the plain version's
# largest value (o, dq, dk, dv are bf16: one bf16 rounding of the
# largest is 2^-7 of it), lse within 1e-6; two calls of each kernel
# equal bit for bit.  The products are exact on both sides, the f32 sums
# differ in order and in wgmma's accumulation, so most bf16 outputs
# round to the plain version's bits: at most FLASH_BITS_OFF of each
# output's elements may differ.  On the H100 the builds of the source
# (every dK/dV run length and warpgroup count) differ in 0.15-2.15% an
# output at step 8's shape; one bf16 half-product a split product (P, dS
# rounded to bf16) in 40-43% (PERF.md run H1): the bound is a quarter of
# that.  A 2-term split (no lo) is not seen (0.34-0.71%).  The bf16
# route's bound is the largest of: the bf16 half-products the function
# needs a tile pair (launch/cost.py's FLASH_HALF_PRODUCTS, each 2 D
# FLOPs a score element; the design issues FLASH_ISSUED, printed beside) at
# BF16_FLOPS_A_CLOCK an SM at the SM clock, as the exp and FFMA peaks
# (the data sheet's 989 TFLOP/s is at 1830 MHz; printed beside); one exp
# a causal score element at EXP_PER_SM a cycle an SM; the bytes at
# HBM_BYTES_PER_S.
# Beside it, the FFMA design's bound: f32 FFMA at FFMA_LANES a cycle an SM
# (2 FLOPs each) over the causal FLOPs, 4 B Hq D S (S + 1) / 2 forward
# and twice that backward.  The float32 route at FLASH_F32_CASE (B, Sq,
# Sk, Hkv, G, D; causal) within FLASH_F32_TOL of the largest value (o;
# gradients): the same float32 operations in another order.  10b: qwen2-0.5b
# prefill at FLASH_LONG tokens; at PREFILL_CHECK tokens and float32
# compute its last logits with the kernel against the plain version
# within PREFILL_TOL of the largest |logit| (the same float32 operations
# in another order).  10c: step 8 beside its reading before these
# kernels (PERF.md run D8).
FLASH_SHAPE = (2, 4096, 14, 2, 64)      # B, S, Hq, Hkv, D
FLASH_LONG, PREFILL_CHECK = 32768, 4096
FLASH_TOL, PREFILL_TOL = 2.0 ** -7, 1e-4
FFMA_LANES = 128
FLASH_BITS_OFF = 0.1
BF16_FLOPS_A_CLOCK = 4096      # dense bf16 wgmma FLOPs a clock an SM
BF16_FLOPS_PER_S = 989e12      # H100 SXM data sheet, dense bf16
EXP_PER_SM = 16                # MUFU exp2 results per clock per SM
FLASH_ISSUED = {"fwd": 4, "bwd": 13}
FLASH_F32_CASE, FLASH_F32_TOL = (2, 300, 300, 2, 7, 64), (1e-5, 1e-4)
STEP8_D8 = {"step_ms": 3849.9, "peak_gb": 41.88}
# The earlier designs' times on an H100 80GB HBM3 at 700 W, as PERF.md
# gives them: fused_mac before its warp-specialised redesign and
# bitslice_mac before its redesign as a grouped interpreter, at batch 1
# (1x1 and 3x3 layers), and the dequant matmul's f32 FMA tiles summed
# over the 8 points.
# Printed, marked as not measured in this run.
EARLIER_FUSED_MS = {"1x1": 0.428, "3x3": 4.526}
EARLIER_INTERP_MS = {"1x1": 63.750, "3x3": 574.461}
EARLIER_DQ_MS = 1.958
# The blockwise attention's f32 FFMA design (PERF.md run F3) at step 8's
# attention, forward and backward, and one 32768-token forward.
EARLIER_FLASH_MS = {"fwd": 2.284, "bwd": 7.826, "fwd_32k": 70.232}
# The dequant matmul's largest error against its plain version, in units
# of the float32 summation bound, may be at most this share of that of a
# single-TF32 product (x rounded to TF32): the x_lo half must count.
DQ_SPLIT_MARGIN = 0.1


def nvidia_smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def ptxas_report(log: str) -> dict[str, dict]:
    """``{mangled entry: {"regs", "smem", "spill_stores", "spill_loads"}}``
    from a ``-Xptxas -v`` report (``smem`` is the static shared memory;
    both kernels' tiles are dynamic)."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = out.setdefault(m.group(1), {"smem": 0})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["regs"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", ln)
        if m:
            cur["smem"] = int(m.group(1))
    return out


LOP3_N = 512
MICRO = r"""
#include <cstdint>
#include <cuda_runtime.h>
#define L3(x, y, z) asm volatile("lop3.b32 %0, %0, %1, %2, 0x96;" \
                                 : "+r"(x) : "r"(y), "r"(z))
__global__ void lop3_dep(uint32_t* out, long long* cyc, uint32_t a,
                         uint32_t b) {
  uint32_t x = threadIdx.x;
  __syncwarp();
  const long long t0 = clock64();
#pragma unroll
  for (int i = 0; i < %N%; ++i) L3(x, a, b);
  const long long t1 = clock64();
  out[threadIdx.x] = x;
  if ((threadIdx.x & 31) == 0) cyc[threadIdx.x / 32] = t1 - t0;
}
__global__ void lop3_ilp8(uint32_t* out, long long* cyc, uint32_t a,
                          uint32_t b) {
  uint32_t x0 = threadIdx.x, x1 = x0 + 1, x2 = x0 + 2, x3 = x0 + 3,
           x4 = x0 + 4, x5 = x0 + 5, x6 = x0 + 6, x7 = x0 + 7;
  __syncwarp();
  const long long t0 = clock64();
#pragma unroll
  for (int i = 0; i < %N%; ++i) {
    L3(x0, a, b); L3(x1, a, b); L3(x2, a, b); L3(x3, a, b);
    L3(x4, a, b); L3(x5, a, b); L3(x6, a, b); L3(x7, a, b);
  }
  const long long t1 = clock64();
  out[threadIdx.x] = x0 ^ x1 ^ x2 ^ x3 ^ x4 ^ x5 ^ x6 ^ x7;
  if ((threadIdx.x & 31) == 0) cyc[threadIdx.x / 32] = t1 - t0;
}
extern "C" int lop3_probe(uint32_t* out, long long* cyc, int ilp,
                          int warps) {
  if (ilp) lop3_ilp8<<<1, 32 * warps>>>(out, cyc, 0x1234u, 0x5678u);
  else lop3_dep<<<1, 32 * warps>>>(out, cyc, 0x1234u, 0x5678u);
  return (int)cudaGetLastError();
}
""".replace("%N%", str(LOP3_N))


def lop3_readings(_build) -> dict:
    """Cycles a ``lop3.b32`` a warp, by ``clock64()`` in one block: a
    dependent chain (``dependent_<w>w``: the latency L) and 8 independent
    chains (``ilp8_<w>w``: the issue interval), for w = 1, 4, 8 warps."""
    lib = _build.build([("lop3_probe", MICRO)])[0].lib
    fn = _build.bind(lib, "lop3_probe", [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_int, ctypes.c_int])
    out = torch.empty(256, dtype=torch.int32, device="cuda")
    cyc = torch.zeros(8, dtype=torch.int64, device="cuda")
    res = {}
    for ilp in (0, 1):
        for warps in (1, 4, 8):
            for _ in range(3):                      # warm, keep the last
                _build.check(fn(_build.ptr(out), _build.ptr(cyc), ilp,
                                warps), "lop3_probe")
                torch.cuda.synchronize()
            n = LOP3_N * (8 if ilp else 1)
            per = cyc[:warps].double().mean().item() / n
            res[f"{'ilp8' if ilp else 'dependent'}_{warps}w"] = per
    return res


def acc_depth(graph) -> int:
    """Gate depth of the longest path from the ``acc`` input bus to the
    ``out`` bus (inputs depth 0)."""
    from repro_torch.core.circuit import OP_INPUT
    depth = {}
    for nid, n in enumerate(graph.nodes):
        if n.op == OP_INPUT:
            depth[nid] = 0 if n.aux[0] == "acc" else None
            continue
        kids = [c for c in (n.a, n.b, n.c) if c is not None and c >= 0]
        ds = [depth.get(c) for c in kids]
        ds = [d for d in ds if d is not None]
        depth[nid] = max(ds) + 1 if ds else None
    outs = [depth.get(w) for w in graph.outputs["out"]]
    return max(d for d in outs if d is not None)



def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> float32 rounded to TF32's 10 fraction bits, to nearest
    with ties away from zero (``cvt.rna.tf32.f32``)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def dq_decode_ops(nbits: int) -> int:
    """Integer operations a weight of the dequant matmul's tensor-core
    decoder (``csrc/dequant_matmul.cu``): a funnel shift and a LOP3 for
    each code bit, then about 6 to bias, flush, select and store."""
    return 2 * nbits + 6


class SmokeFailure(RuntimeError):
    """A phase of the smoke run disagreed with its reference."""


def require(ok, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def bits(t):
    """float32 tensor -> int32 bit patterns (so -0 != +0)."""
    return t.contiguous().view(torch.int32)


def same_bits(a, b) -> bool:
    return a.shape == b.shape and bool((bits(a) == bits(b)).all())


def held(name, got, want, tol):
    """The largest error of ``got`` against the plain version's
    ``want``, which must be at most ``tol`` of ``want``'s largest
    magnitude, in the same shape and type."""
    top = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    require(got.shape == want.shape and got.dtype == want.dtype
            and err <= tol * top,
            f"{name}: {err:.3e} against the plain version's largest "
            f"{top:.3e} (bound {tol} of it)")
    return err


def bits_held(name, got, want):
    """The share of ``got``'s bf16 elements whose bits differ from the
    plain version's; at most ``FLASH_BITS_OFF``."""
    as16 = lambda t: t.contiguous().view(torch.int16)  # noqa: E731
    off = float((as16(got) != as16(want)).float().mean())
    require(off <= FLASH_BITS_OFF,
            f"{name}: {off:.4%} of the elements differ from the plain "
            f"version's in their bits (bound {FLASH_BITS_OFF})")
    return off


def he_kernels(rng, shape):
    kh, kw, cin, _ = shape
    return (rng.standard_normal(shape) * np.sqrt(2.0 / (kh * kw * cin))) \
        .astype(np.float32)


def time_cuda(fn, reps: int) -> float:
    """Milliseconds per call of ``fn`` between CUDA events, after three
    warm-up calls."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_event(fn):
    """``fn()`` once between CUDA events: (its result, ms)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def median_device_ms(fn, reps: int = REPS, warm: int = 3) -> float:
    """Median device milliseconds of one call of ``fn`` over ``reps``
    calls after ``warm``.  Each call is bracketed by CUDA events behind
    a ``torch.cuda._sleep`` that keeps the card busy while the host
    enqueues it, so the events see the device's time, not the host's."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in times)


def device_time_us(evt) -> float:
    """Self device time of a profiler average (``self_cuda_time_total``
    in older torch)."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    raise AttributeError("profiler event carries no device time")


def trace_requests(fn, reqs: int) -> dict:
    """``reqs`` calls of ``fn`` under ``torch.profiler``: the host time
    of the traced window and the device's busy time a call (every kernel
    and copy; one stream, so they do not overlap), and device ms and
    launches a call by group: the two MAC kernels by name, the copies
    between host and card, every other kernel one of the stages' torch
    ops."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reqs):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / reqs
    groups = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = next((k for k in ("fused_mac", "bitslice_mac")
                     if f"{k}_kernel" in e.key),
                    "copies" if "Memcpy" in e.key else "torch ops")
        ms, n = groups.get(name, (0.0, 0.0))
        groups[name] = (ms + device_time_us(e) / 1e3 / reqs,
                        n + e.count / reqs)
    return {"host_ms": host_ms,
            "busy_ms": sum(ms for ms, _ in groups.values()),
            "groups": groups}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2

    from repro_torch import _build
    from repro_torch.core.bitslice import unpack_planes
    from repro_torch.core.fpformat import HOBFLOPS_FORMATS, RNE, FPFormat
    from repro_torch.core.softfloat import decode_torch
    from repro_torch.core.fused_backend import kernel as fused
    from repro_torch.kernels import build_kernels
    from repro_torch.kernels.bitslice_mac import kernel as interp
    from repro_torch.kernels.bitslice_mac.ops import encode_weight_planes
    from repro_torch.kernels.conv2d_bitslice.network import (
        ConvLayerSpec, HobflopsNetwork, NetworkGraph)
    from repro_torch.kernels.conv2d_bitslice.ops import (
        activation_patch_masks, encode_activations, hobflops_conv2d)
    from repro_torch.kernels.conv2d_bitslice.ref import (
        conv2d_f32, hobflops_conv2d_ref)

    dev = torch.device("cuda")
    card = nvidia_smi("name,power.limit")
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    int32_peak = n_sm * INT32_LANES_PER_SM * clock_mhz * 1e6   # derived
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{n_sm} SMs, max SM clock {clock_mhz:.0f} MHz -> derived "
          f"32-bit logic peak {int32_peak / 1e12:.2f} Tops/s")

    fmt = HOBFLOPS_FORMATS["hobflops9"]
    hi = FPFormat(fmt.w_e, fmt.w_f + 2)
    rng = np.random.default_rng(args.seed)
    hw, c = HW, WIDTH

    # -- models -------------------------------------------------------
    stack_k = [he_kernels(rng, s) for s in
               [(3, 3, c, c), (1, 1, c, c), (1, 1, c, c)]]
    nets = {b: HobflopsNetwork([ConvLayerSpec(k, fmt, relu=True)
                                for k in stack_k], backend=b)
            for b in ("cuda_fused", "cuda")}
    res_k = {"c1": he_kernels(rng, (3, 3, c, c)),
             "c2": he_kernels(rng, (1, 1, c, c)),
             "c3": he_kernels(rng, (1, 1, c, c)),
             "d": he_kernels(rng, (3, 3, c, c))}

    def residual_graph(backend):
        g = NetworkGraph(fmt, backend=backend)
        c1 = g.conv("c1", g.input_name, res_k["c1"], relu=True)
        p1 = g.maxpool2d("p1", c1, window=2)
        c2 = g.conv("c2", p1, res_k["c2"], relu=True)
        c3 = g.conv("c3", c2, res_k["c3"])
        r = g.relu("r", g.add("res", c3, p1))
        d = g.conv("d", r, res_k["d"], hi, stride=2)
        return g.output(g.avgpool2d("head", d, window=2))

    graphs = {b: residual_graph(b) for b in ("cuda_fused", "cuda")}
    # The serving phase's degraded variant: the stack in hobflops8.
    serve_g8 = nets["cuda_fused"].graph.with_precision(
        HOBFLOPS_FORMATS["hobflops8"])

    # -- 1. build -----------------------------------------------------
    variants = nets["cuda_fused"].graph.fused_variants() | \
        graphs["cuda_fused"].fused_variants() | serve_g8.fused_variants()
    t0 = time.perf_counter()
    libs = build_kernels(variants)
    print(f"built {len(libs)} libraries ({len(variants)} fused variants) "
          f"in {time.perf_counter() - t0:.1f} s")
    for lib in libs:
        print(f"ptxas [{lib.name}]:")
        for entry, rep in ptxas_report(lib.ptxas_log).items():
            print(f"    {entry}: {rep.get('regs')} registers, "
                  f"{rep['smem']} B static shared, spill stores/loads "
                  f"{rep.get('spill_stores')}/{rep.get('spill_loads')} B")
    blk = _build.launch_blocks(hw * hw, c, c // 32)
    p, m, ik = blk["p_block"], blk["m_block"], blk["c_unroll"]
    pw = _build.INTERP_PRODUCERS
    progs = interp.device_programs(fmt, ik, False, RNE, interp.LIB, "cuda")
    gs = interp.lanes_a_pair(p, m, pw)
    ct = interp.ring_slot(progs, fmt.nbits, p, m, blk["c_block"], ik, pw,
                          gs)
    print(f"bitslice_mac at the main path's blocks {blk}: {p * m} chains, "
          f"{gs} lanes a pair of them, "
          f"{interp.block_threads(p, m, pw, gs)} threads, ring slot {ct} "
          f"channels, "
          f"{interp.smem_bytes(progs, fmt.nbits, p, m, ct, pw, gs)} B "
          f"dynamic shared memory; {interp.LIB} programs: add-only chain "
          f"{progs.add.n} gates in {progs.add.groups} groups, "
          f"{progs.add.nrows} rows; multiplier {progs.mul.n} gates in "
          f"{progs.mul.groups} groups, {progs.mul.nrows} rows "
          f"({progs.program_bytes} B)")
    fblk = _build.launch_blocks(hw * hw, c, c // 32, kernel="fused_mac")
    fk = fused.fused_chain_k(fmt)
    fp, fm = fblk["p_block"], fblk["m_block"]
    fct = fused.ring_slot(fblk["c_block"], fk, fmt.nbits,
                          fmt.mult_out().nbits, fp, fm)
    print(f"fused_mac at the main path's blocks {fblk}: chain depth {fk}, "
          f"{fused.block_threads(fp, fm)} threads ({fp * fm} chains), ring "
          f"slot {fct} channels, "
          f"{fused.smem_bytes(fmt.nbits, fmt.mult_out().nbits, fp, fm, fct)}"
          f" B dynamic shared memory")
    flash_route_trace(dev)
    lop3 = lop3_readings(_build)
    lop3_l = lop3["dependent_1w"]
    print(f"dependent LOP3 latency L = {lop3_l:.2f} cycles; one warp issues "
          f"a LOP3 every {lop3['ilp8_1w']:.2f} cycles "
          f"({lop3['ilp8_8w']:.2f} with 8 warps in the block)")

    # -- 2./3. the main path, counted ----------------------------------
    requests = [rng.standard_normal((b, hw, hw, c)).astype(np.float32)
                for b in (1, 2, 4)]
    res_img = rng.standard_normal((1, hw, hw, c)).astype(np.float32)
    zero_launches()
    outs, res_outs, req_ms = {}, {}, {}
    for backend in ("cuda_fused", "cuda"):
        for img in requests:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = nets[backend](img)
            torch.cuda.synchronize()
            req_ms[(backend, img.shape[0])] = (time.perf_counter() - t0) * 1e3
            outs[(backend, img.shape[0])] = out
        res_outs[backend] = graphs[backend].run(res_img)
    torch.cuda.synchronize()
    launches = kernel_launches()
    print(f"conv path launches: {launches}")
    require(launches["bitslice_mac"] > 0 and launches["fused_mac"] > 0,
            f"a kernel was not launched on the conv path: {launches}")

    for img in requests:
        b = img.shape[0]
        a, o = outs[("cuda_fused", b)], outs[("cuda", b)]
        require(a.shape == (b, hw, hw, c) and bool(torch.isfinite(a).all()),
                f"batch {b}: output {tuple(a.shape)} not finite NHWC")
        require(same_bits(a, o), f"batch {b}: cuda_fused != cuda")
        ref = torch.as_tensor(img, device=dev)
        for k in stack_k:
            ref = torch.relu(conv2d_f32(ref, k))
        rel = float((a - ref).abs().max() / ref.abs().max())
        print(f"stack batch {b}: cuda_fused {req_ms[('cuda_fused', b)]:.1f}"
              f" ms, cuda {req_ms[('cuda', b)]:.1f} ms (first call), "
              f"bit-identical, rel err vs f32 conv chain (TF32 off) "
              f"{rel:.4f}")
    ra, ro = res_outs["cuda_fused"], res_outs["cuda"]
    require(ra.shape == graphs["cuda"].out_shape(res_img.shape)
            and bool(torch.isfinite(ra).all()),
            f"residual graph: output {tuple(ra.shape)} not finite")
    require(same_bits(ra, ro), "residual graph: cuda_fused != cuda")
    require(same_bits(ra, graphs["cuda_fused"].run_roundtrip(res_img)),
            "residual graph: resident != per-layer oracle")
    print(f"residual graph {tuple(ra.shape)}: cuda_fused == cuda == "
          f"per-layer f32-boundary oracle (bit-identical)")

    # A small input against the numpy code-level oracle.
    small_img = rng.standard_normal((1, 5, 5, 8)).astype(np.float32)
    small_k = he_kernels(rng, (3, 3, 8, 8))
    want = hobflops_conv2d_ref(small_img, small_k, fmt, relu=True)
    for backend in ("cuda_fused", "cuda"):
        got = hobflops_conv2d(small_img, small_k, fmt=fmt, relu=True,
                              backend=backend).cpu().numpy()
        require((got.view(np.int32) ==
                 want.astype(np.float32).view(np.int32)).all(),
                f"5x5x8 conv on {backend} != numpy softfloat oracle")
    print("5x5x8 conv: cuda_fused == cuda == numpy softfloat oracle")

    # -- 3b. the stack served through the lane-batched engine ---------
    serve = serve_phase(args.seed, nets["cuda_fused"].graph, serve_g8)

    # -- 4./5. kernels against their plain versions, and timed ---------
    def layer_operands(kh, cin):
        img = torch.as_tensor(rng.standard_normal((1, hw, hw, cin))
                              .astype(np.float32), device=dev)
        act = encode_activations(img, fmt)
        i_masks, _ = activation_patch_masks(act, kh, kh)
        w = torch.as_tensor(he_kernels(rng, (kh, kh, cin, c)), device=dev)
        return i_masks, encode_weight_planes(w.reshape(-1, c), fmt)

    # Both wrappers at their defaults, as the main path launches them.
    k_fused = fk
    kernels = {
        "bitslice_mac": dict(
            route="cuda", source="src/repro_torch/csrc/bitslice_mac.cu",
            replaces="src/repro/kernels/bitslice_mac/kernel.py:140",
            k=ik, launch=lambda i, w:
                interp.bitslice_mac_cuda(i, w, fmt=fmt),
            plain=lambda i, w: interp._bitslice_mac_torch(
                i, w, fmt=fmt, extended=False, rounding=RNE)),
        "fused_mac": dict(
            route="cuda",
            source="src/repro_torch/csrc/fused_mac.cuh",
            replaces="src/repro/core/pallas_backend/kernel.py:98",
            k=k_fused, launch=lambda i, w: fused.fused_mac_cuda(
                i, w, fmt=fmt, relu=True),
            plain=lambda i, w: fused._fused_mac_torch(
                i, w, fmt=fmt, extended=False, rounding=RNE, k=k_fused,
                relu=True)),
    }
    def max_abs_err(got, want):
        """Largest |difference| of the decoded accumulator values (NaN
        against NaN counts as equal, NaN against a number as inf)."""
        a, b = (decode_torch(unpack_planes(t), fmt.mult_out())
                for t in (got, want))
        same = (a == b) | (torch.isnan(a) & torch.isnan(b))
        diff = torch.where(same, torch.zeros_like(a), (a - b).abs())
        return float(torch.nan_to_num(diff, nan=float("inf")).max())

    print(f"clocks.sm, power.draw, temperature.gpu before timing: "
          f"{nvidia_smi('clocks.sm,power.draw,temperature.gpu')}")
    pw_ops = layer_operands(1, c)          # the 1x1 512->512 layer
    for name, kd in kernels.items():
        kd["max_abs_err"] = 0.0
        for label, (i_m, w_p) in (("1x1 K=512", pw_ops),
                                  ("3x3 cin 64 K=576",
                                   layer_operands(3, 64))):
            got = kd["launch"](i_m, w_p)
            want, plain_ms = time_event(lambda: kd["plain"](i_m, w_p))
            torch.cuda.synchronize()
            mism = int((got != want).sum())
            err = max_abs_err(got, want)
            kd["max_abs_err"] = max(kd["max_abs_err"], err)
            require(mism == 0, f"{name} {label}: {mism} words differ "
                    f"(max abs err {err})")
            print(f"{name} vs plain version, {label}: bit-exact, max abs "
                  f"err {err} (plain {plain_ms:.0f} ms)")
            if label.startswith("1x1"):
                kd["plain_ms"] = plain_ms

    # Times at the main path's shapes (batch 1): 1x1 K=512 and 3x3
    # K=4608, with the bounds beside each.  The work of either kernel is
    # counted as the fewest 3-input LOP3 cells per channel: the
    # avx512-mapped 4-step chain's cells over 4.  The fused kernel's
    # serial-chain bound: each (row, lane word) chain folds C channels in
    # order, each step at least the accumulator path's gate depth of
    # dependent LOP3s, L cycles each, at the SM clock read after timing.
    gates = fused.fused_chain_lowered(fmt, 4, False, RNE).gate_count()
    step_depth = acc_depth(fused.fused_add_lowered(fmt, fk, False,
                                                 RNE).graph) / fk
    rows = []
    conv_ops = {"1x1": pw_ops, "3x3": layer_operands(3, c)}
    for name, kd in kernels.items():
        for shape, (i_m, w_p) in conv_ops.items():
            P, C, _ = i_m.shape
            Mw = w_p.shape[2]
            ms = time_cuda(lambda: kd["launch"](i_m, w_p), REPS)
            ops = gates * P * Mw * C / 4
            nbytes = 4 * (i_m.numel() + w_p.numel()
                          + fmt.mult_out().nbits * P * Mw)
            ops_ms = ops / int32_peak * 1e3
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            kd[shape] = dict(ms=ms, bound_ms=max(ops_ms, bytes_ms),
                             bound_by="operations" if ops_ms >= bytes_ms
                             else "bytes", P=P, C=C, Mw=Mw)
            print(f"{name} (chain depth {kd['k']}) {shape} P={P} C={C} "
                  f"Mw={Mw}: {ms:.3f} ms; bound {max(ops_ms, bytes_ms):.4f}"
                  f" ms ({ops:.3e} LOP3 ops, {nbytes / 1e6:.1f} MB)")
    sm_mhz = float(nvidia_smi("clocks.sm").split()[0])
    # The interpreter's own floor, a property of its design: each gate of
    # a warp of 32 lane words costs at least four shared-memory accesses
    # (three operands, one result), one 128-byte wavefront each a cycle
    # an SM.
    add_depth = acc_depth(fused.fused_add_lowered(fmt, ik, False, RNE)
                          .graph) / ik
    for name, kd in kernels.items():
        extra = {}
        if name == "bitslice_mac":
            for shape in conv_ops:
                d = kd[shape]
                warp_gates = d["P"] * d["Mw"] / 32 * (
                    d["C"] / ik * progs.add.n + d["C"] * progs.mul.n)
                d["smem_floor_ms"] = 4 * warp_gates / (n_sm * sm_mhz * 1e3)
                d["chain_bound_ms"] = d["C"] * add_depth * lop3_l / \
                    (sm_mhz * 1e3)
                d["cycles_a_mac"] = d["ms"] * sm_mhz * 1e3 / d["C"]
                top = max(d["bound_ms"], d["chain_bound_ms"])
                print(f"bitslice_mac {shape}: {d['ms']:.4f} ms; operations "
                      f"bound {d['bound_ms']:.4f} ms, serial-chain bound "
                      f"{d['chain_bound_ms']:.4f} ms ({d['C']} steps x "
                      f"{add_depth:.1f} gates x L {lop3_l:.2f} at "
                      f"{sm_mhz:.0f} MHz), share of the larger "
                      f"{top / d['ms']:.3f}; the design's shared-memory "
                      f"floor {d['smem_floor_ms']:.4f} ms ({warp_gates:.4g} "
                      f"warp-gates x 4 accesses, {n_sm} SMs); "
                      f"{d['cycles_a_mac']:.0f} cycles a MAC step")
            print(f"bitslice_mac before its redesign (PERF.md, not this "
                  f"run): {EARLIER_INTERP_MS['1x1']:.3f} / "
                  f"{EARLIER_INTERP_MS['3x3']:.3f} ms")
            extra = {"chain_bound_ms": kd["1x1"]["chain_bound_ms"],
                     "chain_bound_ms_3x3": kd["3x3"]["chain_bound_ms"],
                     "cycles_a_mac_3x3": kd["3x3"]["cycles_a_mac"],
                     "smem_floor_ms": kd["1x1"]["smem_floor_ms"],
                     "smem_floor_ms_3x3": kd["3x3"]["smem_floor_ms"],
                     "sm_mhz": sm_mhz}
        if name == "fused_mac":
            for shape in conv_ops:
                d = kd[shape]
                d["chain_bound_ms"] = d["C"] * step_depth * lop3_l / \
                    (sm_mhz * 1e3)
                d["cycles_a_mac"] = d["ms"] * sm_mhz * 1e3 / d["C"]
                top = max(d["bound_ms"], d["chain_bound_ms"])
                print(f"fused_mac {shape}: {d['ms']:.4f} ms; operations "
                      f"bound {d['bound_ms']:.4f} ms, serial-chain bound "
                      f"{d['chain_bound_ms']:.4f} ms ({d['C']} steps x "
                      f"{step_depth:.1f} gates x L {lop3_l:.2f} at "
                      f"{sm_mhz:.0f} MHz); share of the larger "
                      f"{top / d['ms']:.3f}; {d['cycles_a_mac']:.0f} cycles "
                      f"a MAC step")
            print(f"fused_mac before its redesign (PERF.md, not this run): "
                  f"1x1 {EARLIER_FUSED_MS['1x1']} ms, 3x3 "
                  f"{EARLIER_FUSED_MS['3x3']} ms")
            extra = {"chain_bound_ms": kd["1x1"]["chain_bound_ms"],
                     "chain_bound_ms_3x3": kd["3x3"]["chain_bound_ms"],
                     "cycles_a_mac_3x3": kd["3x3"]["cycles_a_mac"],
                     "lop3_latency_cycles": lop3_l, "sm_mhz": sm_mhz}
        rows.append({
            "name": name, "route": kd["route"], "source": kd["source"],
            "replaces": kd["replaces"], "launches": launches[name],
            "launches_serve_conv": serve["launches"][name],
            "max_abs_err": kd["max_abs_err"], "bit_mismatches": 0,
            "ms": kd["1x1"]["ms"], "plain_ms": kd["plain_ms"],
            "bound_ms": kd["1x1"]["bound_ms"],
            "bound_by": kd["1x1"]["bound_by"], "library_ms": None,
            "shape": "1x1 512->512, 14x14, batch 1",
            "ms_3x3": kd["3x3"]["ms"], "bound_ms_3x3": kd["3x3"]["bound_ms"],
            **extra,
        })

    # Steady-state request times (warm), cuda_fused.
    steady = {}
    for img in requests:
        x = torch.as_tensor(img, device=dev)
        ms = steady[img.shape[0]] = time_cuda(lambda: nets["cuda_fused"](x),
                                              REPS)
        print(f"stack batch {img.shape[0]} cuda_fused steady: {ms:.3f} ms "
              f"({nets['cuda_fused'].macs(img.shape) / ms / 1e6:.2f} "
              f"GMAC/s)")
    print(f"(ops counted at {gates} avx512 cells per 4 channels)")

    # Where a steady request's time goes, traced.
    for img in (requests[0], requests[2]):
        x = torch.as_tensor(img, device=dev)
        tr = trace_requests(lambda: nets["cuda_fused"](x), TRACED_REQS)
        if tr["busy_ms"] == 0.0:
            print(f"traced batch {img.shape[0]}: the trace holds no device "
                  f"time; busy share not measured")
            continue
        b = img.shape[0]
        print(f"traced batch {b}: host {tr['host_ms']:.3f} ms a request "
              f"(traced window), device busy {tr['busy_ms']:.3f} ms = "
              f"{100 * tr['busy_ms'] / steady[b]:.1f}% of the untraced "
              f"steady request")
        for g, (ms, n) in sorted(tr["groups"].items(),
                                 key=lambda kv: -kv[1][0]):
            print(f"    {g:12s} {ms:8.3f} ms device, {n:6.1f} launches")
    print(f"clocks.sm, power.draw, temperature.gpu after timing: "
          f"{nvidia_smi('clocks.sm,power.draw,temperature.gpu')}")

    params = lm_phase(args.seed, dev)
    t0 = time.perf_counter()
    lm_families_phase(args.seed, dev)
    print(f"step 7b wall time: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    full_width_phase(args.seed, dev, card)
    print(f"step 7c wall time: {time.perf_counter() - t0:.1f} s ({card})")
    t0 = time.perf_counter()
    step8 = train_phase(args.seed, dev, card)
    print(f"step 8 wall time: {time.perf_counter() - t0:.1f} s ({card})")
    t0 = time.perf_counter()
    dist_phase(args.seed, dev, card, step8)
    print(f"step 9 wall time: {time.perf_counter() - t0:.1f} s ({card})")
    t0 = time.perf_counter()
    flash_row = flash_phase(args.seed, dev, card, params)
    step8_beside_d8(step8, card, flash_row)
    print(f"step 10 wall time: {time.perf_counter() - t0:.1f} s ({card})")
    rows.append(dequant_phase(args.seed, dev, params, n_sm, clock_mhz))
    rows.append(flash_row)
    print(f"clocks.sm, power.draw, temperature.gpu after the LM phases: "
          f"{nvidia_smi('clocks.sm,power.draw,temperature.gpu')}")

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def serve_phase(seed: int, g, g8) -> dict:
    """The stack ``g`` (and its hobflops8 variant ``g8``) served through
    ``ConvServeEngine`` on the card; raises :class:`SmokeFailure` on any
    response that differs from ``graph.run`` alone or any unplanned
    failure.  Returns the launches of the counted run."""
    from repro_torch.serve_conv import (ConvRequest, ConvServeEngine,
                                        FaultInjector, FaultPlan,
                                        ServePolicy)
    from repro_torch.serve_conv.engine import wave_bytes
    hwc = (HW, HW, WIDTH)
    rng = np.random.default_rng(seed)
    faults = FaultInjector(FaultPlan(), seed=seed)
    policy = ServePolicy(wave_deadline_ms=SERVE_DEADLINE_MS,
                         max_wave_retries=2, retry_backoff_s=1e-3,
                         degrade_queue_factor=1.0, degrade_patience=2,
                         recover_patience=2)
    eng = ConvServeEngine(g, hwc, policy=policy, faults=faults)
    eng.register_degraded(g8, "hobflops8")
    mb = eng.max_batch
    free, total = torch.cuda.mem_get_info()
    print(f"serve_conv: max_batch {mb} derived on the card ("
          f"{wave_bytes(g, hwc):,} B an image, {free / 1e9:.1f} of "
          f"{total / 1e9:.1f} GB free), buckets {eng.buckets}, "
          f"{eng.macs_per_image:,} MACs an image")
    require(mb > 4, f"serve_conv: max_batch {mb} is the TPU rule's, not "
            f"the card's")
    pool = rng.standard_normal((mb,) + hwc).astype(np.float32)
    slices = {}                     # rid -> (first pool image, count)

    def submit(n):
        rid = len(slices)
        start = (sum(c for _, c in slices.values())) % (mb - n + 1)
        slices[rid] = (start, n)
        img = pool[start] if n == 1 else pool[start:start + n]
        req = ConvRequest(rid, img)
        eng.submit(req)
        return req

    def drain():
        while eng.pending_images():
            if not eng.wave_ready():
                time.sleep(max(0.0, eng.next_deadline() - time.monotonic()))
            eng.step()

    # The counted run: the scripted queue, the injected fault, the burst
    # and the recovery.
    reqs = []
    zero_launches()
    for i, group in enumerate(SERVE_GROUPS):
        if i == SERVE_FAULT_GROUP:
            faults.plan.wave_errors = 1
        group_reqs = [submit(n) for n in group]
        reqs += group_reqs
        drain()
        if i == SERVE_FAULT_GROUP:
            fault_reqs = group_reqs
    scripted_waves = eng.waves
    burst = [submit(4) for _ in range(SERVE_BURST)]
    drain()
    recovery = []
    for _ in range(2):              # light traffic: cold, cold -> recover
        recovery.append(submit(1))
        drain()
    torch.cuda.synchronize()
    launches = kernel_launches()
    reqs += burst + recovery
    st = eng.stats()
    print(f"serve_conv launches ({eng.waves} waves): {launches}")
    require(launches["fused_mac"] == 3 * eng.waves
            and launches["bitslice_mac"] == 0,
            f"serve_conv: {launches} for {eng.waves} waves of 3 convs")

    # Nothing but the injected fault may fail.
    require(faults.injected_wave_errors == 1
            and all(r.attempts == 2 for r in fault_reqs),
            "serve_conv: the injected wave error did not fire or retry")
    bad = {k: st[k] for k in ("waves_failed", "requests_failed",
                              "requests_expired", "requests_rejected",
                              "requests_shed", "queued_images")}
    require(not any(bad.values()) and not eng.quarantined
            and not eng.expired and st["wave_exec_failures"] == 1
            and all(r.status == "served" for r in reqs),
            f"serve_conv: unplanned failures {bad}, "
            f"{st['wave_exec_failures']} failed executions")
    degraded = [r for r in burst + recovery if r.degraded]
    require(degraded and eng.controller.level == 0
            and recovery[-1].precision == "full"
            and st["degradation"]["activations"] == 1,
            f"serve_conv: overload did not degrade and recover: "
            f"{st['degradation']}")
    solo = {}
    for r in reqs:
        start, n = slices[r.rid]
        key = (start, n, r.level)
        if key not in solo:
            solo[key] = (g8 if r.degraded else g).run(
                pool[start:start + n]).cpu()
        want = solo[key][0] if n == 1 else solo[key]
        require(r.out.shape == tuple(want.shape) and
                (r.out.view(np.int32) == want.numpy().view(np.int32)).all(),
                f"serve_conv request {r.rid} ({n} images, "
                f"{r.precision}) != graph.run alone")
    occ = st["mean_occupancy"]
    print(f"serve_conv: {len(reqs)} requests ({st['images_served']} images) "
          f"in {eng.waves} waves ({scripted_waves} scripted; wave "
          f"{fault_reqs[0].wave} retried after the injected error), "
          f"{len(degraded)} requests served at hobflops8 and recovered; "
          f"every response == graph.run alone at its precision "
          f"(int32 bit patterns); 0 quarantined, expired, rejected")
    print(f"serve_conv stats: p50 {st['p50_latency_ms']:.3f} ms, p99 "
          f"{st['p99_latency_ms']:.3f} ms, mean occupancy {occ:.3f}, "
          f"runner cache {st['runner_cache']}, waves by level "
          f"{st['degradation']['images_by_level']} images, retries "
          f"{st['wave_retries']}")

    # One wave at each bucket: median of SERVE_REPS after a warm-up.
    def wave(b):
        n = 4 if b >= 4 else 1
        served = eng.images_served
        for j in range(0, b, n):
            eng.submit(ConvRequest(-1, pool[j] if n == 1
                                   else pool[j:j + n]))
        done = eng.run_wave()
        require(eng.images_served == served + b,
                f"serve_conv: the bucket-{b} wave was not served")
        return done, eng.wave_seconds[-1]

    sweep = {}
    for b in eng.buckets:
        wave(b)
        ms = statistics.median(wave(b)[1] for _ in range(SERVE_REPS)) * 1e3
        sweep[b] = ms
        print(f"serve_conv bucket {b:3d}: wave {ms:9.3f} ms, "
              f"{b / ms * 1e3:9.1f} images/s, "
              f"{b * eng.macs_per_image / ms / 1e6:8.2f} GMAC/s")
    done, _ = wave(mb)
    got = np.concatenate([r.out for r in done])
    require((got.view(np.int32) ==
             g.run(pool).cpu().numpy().view(np.int32)).all(),
            f"serve_conv: a bucket-{mb} wave != graph.run on its images")

    # Two waves traced (after one untraced profile: the first profile of
    # a process pays the tracer's set-up).
    trace_requests(lambda: wave(1), 1)
    for b in (1, mb):
        tr = trace_requests(lambda: wave(b), 1)
        if tr["busy_ms"] == 0.0:
            print(f"traced bucket-{b} wave: no device time in the trace; "
                  f"busy share not measured")
            continue
        print(f"traced bucket-{b} wave: host {tr['host_ms']:.3f} ms, device "
              f"busy {tr['busy_ms']:.3f} ms = "
              f"{100 * tr['busy_ms'] / tr['host_ms']:.1f}% of it")
        for grp, (ms, n) in sorted(tr["groups"].items(),
                                   key=lambda kv: -kv[1][0]):
            print(f"    {grp:12s} {ms:8.3f} ms device, {n:6.1f} launches")
    return {"launches": launches, "max_batch": mb, "sweep_ms": sweep}


def kernel_launches() -> dict:
    """CUDA kernels launched by each wrapper since the last
    :func:`zero_launches` (each MAC wrapper and the attention forward
    launch one a call, the attention backward four), and the
    dequant matmul's and the attention backward's calls."""
    from repro_torch.core.fused_backend import kernel as fused
    from repro_torch.kernels.bitslice_mac import kernel as interp
    from repro_torch.kernels.dequant_matmul import kernel as dq
    from repro_torch.kernels.flash_attention import kernel as fa
    return {"bitslice_mac": interp.bitslice_mac_cuda.launches,
            "fused_mac": fused.fused_mac_cuda.launches,
            "dequant_matmul": dq.dequant_matmul_cuda.kernel_launches,
            "dequant_matmul_calls": dq.dequant_matmul_cuda.launches,
            "flash_fwd": fa.flash_fwd_cuda.launches,
            "flash_bwd": fa.flash_bwd_cuda.kernel_launches,
            "flash_bwd_calls": fa.flash_bwd_cuda.launches}


def zero_launches() -> None:
    from repro_torch.core.fused_backend import kernel as fused
    from repro_torch.kernels.bitslice_mac import kernel as interp
    from repro_torch.kernels.dequant_matmul import kernel as dq
    from repro_torch.kernels.flash_attention import kernel as fa
    interp.bitslice_mac_cuda.launches = 0
    fused.fused_mac_cuda.launches = 0
    dq.dequant_matmul_cuda.launches = 0
    dq.dequant_matmul_cuda.kernel_launches = 0
    fa.flash_fwd_cuda.launches = 0
    fa.flash_bwd_cuda.launches = 0
    fa.flash_bwd_cuda.kernel_launches = 0


def trace_lm_steps(cfg, params, deq, seed: int, dev, steps: int = 3):
    """One prefill and ``steps`` greedy decode steps of the LM under
    ``torch.profiler``: for each phase the host time (synchronised), the
    device's busy time, the kernel launches and the kernels with the
    most device time."""
    from repro_torch.serve.steps import make_decode_step, make_prefill_step
    gen = torch.Generator().manual_seed(seed)
    prompt = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                           generator=gen).to(dev)
    prefill = make_prefill_step(cfg, LM_PROMPT + LM_GEN, deq=deq)
    step = make_decode_step(cfg, deq=deq)
    cache, lg, length = prefill(params, {"tokens": prompt})
    tok, lg, cache = step(params, lg.argmax(-1).to(torch.int32), length,
                          cache)                          # warm
    torch.cuda.synchronize()

    def decode_steps():
        nonlocal tok, lg, cache
        for i in range(steps):
            tok, lg, cache = step(params, tok, length + 1 + i, cache)
    return {"prefill": profile_calls(
                lambda: prefill(params, {"tokens": prompt}), 1),
            "decode": profile_calls(decode_steps, steps)}


def profile_calls(fn, n: int) -> dict:
    """``fn()`` (``n`` steps of work) under ``torch.profiler``: a step's
    host time (synchronised), the device's busy time, the kernel
    launches and the four kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / n
    kern = [(device_time_us(e) / 1e3 / n, e.count / n, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"host_ms": host_ms, "busy_ms": sum(k[0] for k in kern),
            "launches": sum(k[1] for k in kern),
            "top": sorted(kern, reverse=True)[:4]}


def lm_phase(seed: int, dev) -> dict:
    """qwen2-0.5b served at full width with float32 and with hobflops9
    weights; returns the float32 parameters."""
    from repro_torch.configs import get_config
    from repro_torch.core.bitslice import unpack_planes_np
    from repro_torch.core.softfloat import decode_storage_np, flush_subnormal
    from repro_torch.launch.serve import serve_demo
    from repro_torch.models import model_schema
    from repro_torch.models.schema import init_params, param_count
    from repro_torch.quant.apply import make_deq, quantize_params
    from repro_torch.quant.storage import dequantize

    cfg = get_config(LM_ARCH)
    schema = model_schema(cfg)
    t0 = time.perf_counter()
    params = init_params(schema, torch.Generator().manual_seed(seed), dev)
    torch.cuda.synchronize()
    print(f"{LM_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}: {param_count(schema)} parameters, "
          f"initialised in {time.perf_counter() - t0:.1f} s")
    serve = dict(batch=LM_BATCH, prompt_len=LM_PROMPT, gen_len=LM_GEN,
                 seed=seed, params=params, device=dev,
                 print_fn=lambda m: print(f"    {m}"))
    for quant in (None, "hobflops9"):
        print(f"serve_demo warm-up ({quant or 'float32'} weights, 2 tokens;"
              f" not reported):")
        serve_demo(cfg, quant=quant, **{**serve, "gen_len": 2})
    runs = {}
    zero_launches()
    for quant in (None, "hobflops9"):
        print(f"serve_demo {LM_ARCH}, {quant or 'float32'} weights, batch "
              f"{LM_BATCH}, prompt {LM_PROMPT}, {LM_GEN} tokens:")
        st = {}
        runs[quant] = (serve_demo(cfg, quant=quant, stats=st, **serve), st)
        require(bool(torch.isfinite(st["logits"]).all()),
                f"serve_demo ({quant}): logits not finite")
        require(st["logits"].shape == (LM_GEN, LM_BATCH, cfg.vocab_padded),
                f"serve_demo ({quant}): logits {tuple(st['logits'].shape)}")
        line = (f"    prefill {st['prefill_ms']:.3f} ms, decode "
                f"{st['decode_ms_per_step']:.3f} ms/step, "
                f"{st['tok_s']:.1f} tok/s")
        if quant:
            q, d = st["quantized_bytes"]
            line += (f"; quantize_params {st['quantize_s'] * 1e3:.1f} ms, "
                     f"{q} B of planes and scales against {d} B in bf16 "
                     f"({q / d:.4f})")
        print(line)
    launches = kernel_launches()
    print(f"LM path launches (the attention forward kernel in each "
          f"prefill; the dequant hook decodes with torch ops, as the "
          f"reference's does): {launches}")
    require(launches["flash_fwd"] > 0,
            f"the prefills did not launch the attention kernel: {launches}")
    a, b = runs[None][0], runs["hobflops9"][0]
    print(f"greedy agreement float32 vs hobflops9: "
          f"{(a == b).mean():.4f} of {a.size} tokens (untrained weights; "
          f"informational)")

    # Layer 0's w_up decoded on the card against a numpy decode of its
    # codes.
    qparams, _ = quantize_params(params, cfg, "hobflops9")
    qt = qparams["blocks"]["b0"]["mlp"]["w_up"].layer(0)
    got = dequantize(qt).cpu().numpy()
    n = int(np.prod(qt.shape))
    codes = unpack_planes_np(qt.data.cpu().numpy(), n, lane_bits=32)
    scale = np.float32(qt.scale.cpu().numpy())
    vals = flush_subnormal(decode_storage_np(codes, qt.sfmt), np)
    want = flush_subnormal(vals.reshape(qt.shape) * scale, np)
    require(got.view(np.int32).tolist() == want.view(np.int32).tolist(),
            "layer 0 w_up: card dequantize != numpy decode")
    print(f"layer 0 w_up {qt.shape}: dequantized on the card == numpy "
          f"decode of its {qt.sfmt.nbits}-bit codes, bit for bit")

    # Where a serving step's time goes, traced.
    for quant, (ps, deq) in (("float32", (params, None)),
                             ("hobflops9", (qparams, make_deq()))):
        for phase, tr in trace_lm_steps(cfg, ps, deq, seed, dev).items():
            print(f"traced {LM_ARCH} {quant} {phase} (a step): host "
                  f"{tr['host_ms']:.3f} ms, device busy {tr['busy_ms']:.3f}"
                  f" ms ({100 * tr['busy_ms'] / tr['host_ms']:.1f}%), "
                  f"{tr['launches']:.0f} kernel launches")
            for ms, n, name in tr["top"]:
                print(f"    {ms:8.3f} ms {n:6.0f}x  {name[:90]}")
    return params


def serve_pair(cfg, params, prompt_len: int, quants, seed: int) -> dict:
    """``serve_demo`` on ``params`` at batch ``FAM_BATCH`` and
    ``FAM_GEN`` tokens for each weight format in ``quants``, each after
    a 2-token warm-up call; prints and returns each run's stats.  Logits
    must be finite and of the right shape."""
    from repro_torch.launch.serve import serve_demo
    serve = dict(batch=FAM_BATCH, prompt_len=prompt_len, seed=seed,
                 params=params, device=params["embed"]["table"].device,
                 print_fn=lambda m: None)
    out = {}
    for quant in quants:
        serve_demo(cfg, quant=quant, **{**serve, "gen_len": 2})
        st = out[quant] = {}
        serve_demo(cfg, quant=quant, gen_len=FAM_GEN, stats=st, **serve)
        require(bool(torch.isfinite(st["logits"]).all()),
                f"{cfg.name} serve_demo ({quant}): logits not finite")
        require(st["logits"].shape == (FAM_GEN, FAM_BATCH, cfg.vocab_padded),
                f"{cfg.name} serve_demo ({quant}): logits "
                f"{tuple(st['logits'].shape)}")
        line = (f"serve_demo {cfg.name}, {quant or 'float32'} weights, "
                f"batch {FAM_BATCH}, prompt {prompt_len}, {FAM_GEN} tokens: "
                f"prefill {st['prefill_ms']:.3f} ms, decode "
                f"{st['decode_ms_per_step']:.3f} ms/step, "
                f"{st['tok_s']:.1f} tok/s")
        if quant:
            q, d = st["quantized_bytes"]
            line += (f"; quantize_params {st['quantize_s']:.3f} s, {q} B of "
                     f"planes and scales against {d} B in bf16 "
                     f"({q / d:.4f})")
        print(line)
    return out


def traced_decode(cfg, params, deq, seed: int, dev) -> None:
    """Prints one traced decode step of ``cfg`` (``trace_lm_steps``):
    host ms, device busy ms and share, launches, the top kernels."""
    tr = trace_lm_steps(cfg, params, deq, seed, dev, steps=1)["decode"]
    print(f"traced {cfg.name} {'hobflops9' if deq else 'float32'} decode "
          f"step (batch {LM_BATCH}, {LM_PROMPT}-token prompt): host "
          f"{tr['host_ms']:.3f} ms, device busy {tr['busy_ms']:.3f} ms "
          f"({100 * tr['busy_ms'] / tr['host_ms']:.1f}%), "
          f"{tr['launches']:.0f} kernel launches")
    for ms, n, name in tr["top"]:
        print(f"    {ms:8.3f} ms {n:6.0f}x  {name[:90]}")


def full_init(cfg, seed: int, dev):
    """``cfg``'s parameters drawn on the card by a CUDA generator."""
    from repro_torch.models import model_schema
    from repro_torch.models.schema import init_params, param_count
    schema = model_schema(cfg)
    t0 = time.perf_counter()
    params = init_params(schema, torch.Generator(device=dev).manual_seed(seed),
                         dev)
    torch.cuda.synchronize()
    n = param_count(schema)
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
          f"{cfg.vocab}: {n} parameters ({n * 4 / 1e9:.1f} GB float32), "
          f"initialised on the card in {time.perf_counter() - t0:.1f} s")
    return params


def decode_against_forward(cfg, params, batch: dict, dev,
                           deq=None) -> float:
    """At float32 compute: ``decode_step`` of the last token after a
    ``prefill`` of the others against ``forward_logits`` at that
    position, and the prefill's own last logits against the position
    before, all three through the dequant hook ``deq`` when given.
    Returns the larger error as a share of the largest logit, which must
    be at most ``DECODE_TOL``."""
    from repro_torch.models import decode_step, forward_logits, prefill
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    torch.backends.cuda.matmul.allow_tf32 = False
    tokens = batch["tokens"]
    S = tokens.shape[1]
    full, _ = forward_logits(params, batch, cfg, deq=deq)
    cache, lg_pre, length = prefill(
        params, dict(batch, tokens=tokens[:, :S - 1]), cfg,
        S + cfg.num_prefix, dtype=torch.float32, deq=deq)
    lg_dec, _ = decode_step(params, tokens[:, S - 1], cache, length, cfg,
                            deq=deq)
    top = float(full[:, -2:].abs().max())
    err = max(float((lg_dec - full[:, -1]).abs().max()),
              float((lg_pre - full[:, -2]).abs().max())) / top
    require(bool(torch.isfinite(full).all()) and err <= DECODE_TOL,
            f"{cfg.name}: decode after prefill against the forward: "
            f"{err:.3e} of the largest logit {top:.3f}, bound {DECODE_TOL}")
    print(f"{cfg.name} float32 compute{', hobflops9 weights' if deq else ''}"
          f", {S - 1}-token prefill + decode_step against forward_logits at "
          f"position {S - 1} (and prefill's last logits at {S - 2}): max "
          f"err {err:.3e} of the largest logit {top:.3f} (bound "
          f"{DECODE_TOL})")
    return err


def engine_queue(cfg, params, dev, seed: int) -> None:
    """``ServeEngine`` on ``cfg``: the ``ENGINE_QUEUE`` requests in
    ``ENGINE_SLOTS`` slots, once to learn the EOS request's second token
    and again with it as that request's EOS; every request must
    complete, the EOS one at its EOS.  Then the ``n_slots=1`` engine on
    one prompt against the plain prefill/decode loop, token for token."""
    from repro_torch.models import decode_step, prefill
    from repro_torch.serve import Request, ServeEngine
    rng = np.random.default_rng(seed + 2)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n, _ in ENGINE_QUEUE]
    max_len = max(n for n, _ in ENGINE_QUEUE) + max(m for _, m in
                                                    ENGINE_QUEUE)

    def serve(eos_id=None, slots=ENGINE_SLOTS, queue=ENGINE_QUEUE):
        eng = ServeEngine(cfg, params, n_slots=slots, max_len=max_len)
        reqs = [Request(i, prompts[i], max_new=m,
                        eos_id=eos_id if i == ENGINE_EOS_AT else None)
                for i, (_, m) in enumerate(queue)]
        for r in reqs:
            eng.submit(r)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        return done, eng, (time.perf_counter() - t0) * 1e3

    probe, _, _ = serve()
    eos = probe[ENGINE_EOS_AT].out[1]
    done, eng, ms = serve(eos)
    for r, (n, m) in zip(done, ENGINE_QUEUE):
        stop = (r.eos_id is not None and r.out[-1] == r.eos_id)
        require(r.done and (len(r.out) == m or (stop and len(r.out) < m)),
                f"engine request {r.rid}: {len(r.out)} of {m} tokens, done "
                f"{r.done}")
    r = done[ENGINE_EOS_AT]
    require(r.out == probe[ENGINE_EOS_AT].out[:len(r.out)]
            and r.out[-1] == eos and len(r.out) < ENGINE_QUEUE[
                ENGINE_EOS_AT][1],
            f"engine: the EOS request gave {r.out}, probe "
            f"{probe[ENGINE_EOS_AT].out}, EOS {eos}")
    print(f"ServeEngine {cfg.name} ({ENGINE_SLOTS} slots, cache float32): "
          f"{len(done)} requests (prompts "
          f"{[n for n, _ in ENGINE_QUEUE]}, max_new "
          f"{[m for _, m in ENGINE_QUEUE]}) all complete, request "
          f"{ENGINE_EOS_AT} at its EOS after {len(r.out)} tokens; "
          f"{eng.total_decode_steps} decode steps, {eng.total_tokens} "
          f"decoded tokens, {ms:.1f} ms")

    one, eng1, _ = serve(slots=1, queue=ENGINE_QUEUE[:1])
    tokens = torch.from_numpy(prompts[0]).long()[None].to(dev)
    cache, lg, pos = prefill(params, {"tokens": tokens}, cfg, max_len,
                             dtype=torch.float32)
    tok = torch.argmax(lg, -1).to(torch.int32)
    loop = [int(tok[0])]
    for i in range(ENGINE_QUEUE[0][1] - 1):
        lg, cache = decode_step(params, tok, cache, pos + i, cfg)
        tok = torch.argmax(lg, -1).to(torch.int32)
        loop.append(int(tok[0]))
    require(one[0].out == loop, f"engine n_slots=1 {one[0].out} != plain "
                                f"loop {loop}")
    print(f"ServeEngine n_slots=1 == the plain prefill/decode loop on a "
          f"{ENGINE_QUEUE[0][0]}-token prompt: {loop}")


def lm_families_phase(seed: int, dev) -> None:
    """Step 7b: the MoE, SSM, enc-dec, hybrid and VLM families.  MoE
    dispatch and the SSD scan are torch ops, as the reference's are jnp
    ops; every prefill's attention, the enc-dec model's encoder and
    cross-attention among them, runs the blockwise attention forward
    kernel, and the run fails if it was not launched."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models.moe import moe, moe_dense_ref
    from repro_torch.quant.apply import make_deq, quantize_params

    zero_launches()
    torch.backends.cuda.matmul.allow_tf32 = False

    # olmoe-1b-7b, full width and depth.
    cfg = get_config("olmoe-1b-7b")
    params = full_init(cfg, seed, dev)
    serve_pair(cfg, params, FAM_PROMPT[cfg.name], (None, "hobflops9"), seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    x = torch.randn((FAM_BATCH, FAM_PROMPT[cfg.name], cfg.d_model),
                    generator=gen, device=dev)
    mp = {k: v[0] for k, v in params["blocks"]["b0"]["moe"].items()}
    wide = dataclasses.replace(cfg, moe_capacity_factor=8.0)
    y, aux = moe(mp, x, wide)
    want = moe_dense_ref(mp, x, wide)
    err = float((y - want).abs().max()) / float(want.abs().max())
    require(bool(torch.isfinite(y).all()) and err <= MOE_TOL,
            f"olmoe layer 0 moe vs moe_dense_ref: {err:.3e} of the largest "
            f"output, bound {MOE_TOL}")
    print(f"olmoe-1b-7b layer 0 dispatch moe (capacity 8.0, nothing dropped)"
          f" against moe_dense_ref on the card, x {tuple(x.shape)} float32: "
          f"max err {err:.3e} of the largest output (bound {MOE_TOL}); aux "
          f"{float(aux):.4f}")
    traced_decode(cfg, params, None, seed, dev)
    qparams, _ = quantize_params(params, cfg, "hobflops9")
    traced_decode(cfg, qparams, make_deq(), seed, dev)
    del params, qparams, mp, x, y, want
    torch.cuda.empty_cache()

    # mamba2-2.7b, full width and depth.
    cfg = get_config("mamba2-2.7b")
    params = full_init(cfg, seed, dev)
    S = FAM_PROMPT[cfg.name]
    serve_pair(cfg, params, S, (None, "hobflops9"), seed)
    traced_decode(cfg, params, None, seed, dev)
    tokens = torch.randint(0, cfg.vocab, (FAM_BATCH, S), generator=gen,
                           device=dev)
    decode_against_forward(cfg, params, {"tokens": tokens}, dev)
    engine_queue(cfg, params, dev, seed)
    del params
    torch.cuda.empty_cache()

    # seamless-m4t-medium, full width and depth.
    cfg = get_config("seamless-m4t-medium")
    params = full_init(cfg, seed, dev)
    serve_pair(cfg, params, FAM_PROMPT[cfg.name], (None,), seed)
    del params
    torch.cuda.empty_cache()

    # jamba-v0.1-52b and internvl2-26b as smoke twins: at full depth and
    # float32 they need 209.5 GB and 79.5 GB, more than one card holds.
    for name in ("jamba-v0.1-52b", "internvl2-26b"):
        cfg = dataclasses.replace(smoke_config(name), moe_capacity_factor=8.0)
        params = full_init(cfg, seed, dev)
        batch = {"tokens": torch.randint(0, cfg.vocab, (2, 32),
                                         generator=gen, device=dev)}
        if cfg.frontend != "none":
            batch["prefix"] = torch.randn(
                (2, cfg.num_prefix, cfg.frontend_dim), generator=gen,
                device=dev)
        decode_against_forward(cfg, params, batch, dev)
    launches = kernel_launches()
    print(f"step 7b launches: {launches}")
    require(launches["flash_fwd"] > 0,
            f"step 7b's prefills did not launch the attention kernel: "
            f"{launches}")


def _nest(path, leaf):
    for k in reversed(path):
        leaf = {k: leaf}
    return leaf


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _schema_paths(tree, path=()):
    """(path, leaf) of a schema in ``init_params``' sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _schema_paths(tree[k], path + (k,))]
    return [(path, tree)]


def quantize_slice(w, sfmt, data, scale, chunk: int) -> None:
    """``quantize(w, sfmt, layout="bitplane")`` into ``data`` [nbits,
    n/32] and the 0-d ``scale``, ``chunk`` elements of ``w`` at a time
    (a multiple of 32: a chunk's codes fill whole lane words).  The
    scale is quantize's own, from the largest magnitude of the flushed
    weights, taken over the chunks; each chunk then goes through
    ``quantize`` with that scale."""
    from repro_torch.core.softfloat import flush_subnormal
    from repro_torch.quant.storage import quantize
    flat = w.reshape(-1)
    n = flat.numel()
    amax = torch.stack([flush_subnormal(flat[i:i + chunk]).abs().max()
                        for i in range(0, n, chunk)]).max()
    sc = torch.clamp(amax, min=1e-30) / 2.0 ** (sfmt.emax - sfmt.bias - 1)
    for i in range(0, n, chunk):
        q = quantize(flat[i:i + chunk], sfmt, layout="bitplane", scale=sc)
        data[:, i // 32:i // 32 + q.data.shape[1]] = q.data
    scale.copy_(q.scale)


def quantized_init(cfg, seed: int, dev, chunk: int = QUANT_CHUNK):
    """``quantize_params(init_params(schema, Generator(dev).manual_seed(
    seed), dev), cfg, QUANT_FMT)`` without the float32 tree: each leaf is
    drawn by ``init_params``' own ``_leaf_init`` in its order from the
    same generator, and a weight that ``quantize_params`` stores in
    planes (its rule, asked on a meta tensor of the leaf's shape) is
    quantized layer slice by slice (``quantize_slice``) into the planes
    and scales it would make, before the next leaf is drawn.  Returns
    (the tree, the bytes of planes and scales, the bytes kept dense)."""
    from repro_torch._build import synchronize
    from repro_torch.models import model_schema
    from repro_torch.models.schema import _leaf_init
    from repro_torch.quant.apply import quantize_params
    from repro_torch.quant.storage import QuantizedTensor
    gen = torch.Generator(device=dev).manual_seed(seed)
    tree, planes, dense = {}, 0, 0
    for path, p in _schema_paths(model_schema(cfg)):
        w = _leaf_init(p, gen, torch.float32, dev)
        shape, _ = quantize_params(
            _nest(path, torch.empty(p.shape, device="meta")), cfg, QUANT_FMT)
        q = _at(shape, path)
        if isinstance(q, QuantizedTensor):
            data = torch.empty(q.data.shape, dtype=q.data.dtype, device=dev)
            scale = torch.empty(q.scale.shape, dtype=q.scale.dtype,
                                device=dev)
            if data.ndim == 2:
                quantize_slice(w, q.sfmt, data, scale, chunk)
            for i in range(data.shape[0] if data.ndim == 3 else 0):
                quantize_slice(w[i], q.sfmt, data[i], scale[i], chunk)
            w = dataclasses.replace(q, data=data, scale=scale)
            planes += data.numel() * 4 + scale.numel() * 4
        else:
            dense += w.numel() * w.element_size()
        sub = tree
        for k in path[:-1]:
            sub = sub.setdefault(k, {})
        sub[path[-1]] = w
        del w
    synchronize(torch.device(dev))
    return tree, planes, dense


def same_quantized(a, b, where: str = "") -> None:
    """Two parameter trees equal leaf by leaf: a quantized leaf's planes
    and scales and a dense leaf's values bit for bit, shapes and
    formats too."""
    from repro_torch.quant.storage import QuantizedTensor
    if isinstance(a, dict):
        require(isinstance(b, dict) and sorted(a) == sorted(b),
                f"{where}: keys differ")
        for k in a:
            same_quantized(a[k], b[k], f"{where}/{k}")
        return
    if isinstance(a, QuantizedTensor):
        require(isinstance(b, QuantizedTensor) and a.shape == b.shape
                and a.sfmt == b.sfmt and a.layout == b.layout
                and a.data.shape == b.data.shape
                and a.scale.shape == b.scale.shape, f"{where}: layout")
        require(torch.equal(a.data, b.data), f"{where}: planes differ")
        require(same_bits(a.scale, b.scale), f"{where}: scales differ")
        return
    require(a.shape == b.shape and same_bits(a, b),
            f"{where}: dense leaf differs")


def free_margin(what: str, free0: int, held0: int) -> float:
    """GB the card had free at the peak since the last reset: what was
    free or held by this process's allocator (``free0``, ``held0``)
    before, less the peak allocated.  At least ``FULL_MIN_FREE_GB``."""
    margin = (free0 + held0 - torch.cuda.max_memory_allocated()) / 1e9
    require(margin >= FULL_MIN_FREE_GB,
            f"{what}: {margin:.2f} GB of the card free at the peak, below "
            f"{FULL_MIN_FREE_GB} GB")
    return margin


def full_draw(cfg, seed: int, dev, card: str):
    """``quantized_init`` of ``cfg`` on an empty card; prints its stored
    bytes, seconds, peak and the free memory before, at the peak and
    after, and returns the tree."""
    from repro_torch.models import model_schema
    from repro_torch.models.schema import param_count
    torch.cuda.reset_peak_memory_stats()
    free0, total = torch.cuda.mem_get_info()
    held0 = torch.cuda.memory_reserved()
    alloc0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params, planes, dense = quantized_init(cfg, seed, dev)
    init_s = time.perf_counter() - t0
    free1, _ = torch.cuda.mem_get_info()
    margin = free_margin(f"{cfg.name} draw", free0, held0)
    n = param_count(model_schema(cfg))
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {n} "
          f"parameters ({n * 4 / 1e9:.1f} GB float32): drawn and quantized "
          f"to {QUANT_FMT} leaf by leaf on the card in {init_s:.1f} s; "
          f"stored {planes / 1e9:.3f} GB of planes and scales + "
          f"{dense / 1e9:.3f} GB dense = {(planes + dense) / 1e9:.3f} GB; "
          f"peak of the draw {torch.cuda.max_memory_allocated() / 1e9:.2f} "
          f"GB allocated, {torch.cuda.max_memory_reserved() / 1e9:.2f} GB "
          f"reserved ({alloc0 / 1e9:.2f} GB allocated before); free "
          f"{free0 / 1e9:.2f} -> {free1 / 1e9:.2f} of "
          f"{total / 1e9:.2f} GB, {margin:.2f} GB at the peak (at least "
          f"{FULL_MIN_FREE_GB}) ({card})")
    return params


def _layout(tree):
    """A parameter tree's leaves as their storage shapes."""
    from repro_torch.quant.storage import QuantizedTensor
    if isinstance(tree, dict):
        return {k: _layout(v) for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor):
        return (tree.layout, tree.shape, tuple(tree.data.shape),
                tuple(tree.scale.shape))
    return tuple(tree.shape)


def keep_repeats(params, cut) -> None:
    """``params`` cut in place to ``cut``'s depth: each stacked leaf of
    ``params["blocks"]`` keeps its first repeats, copied, and its full
    leaf is freed before the next is cut.  The tree's layout must then
    be the one ``quantize_params`` gives ``cut``."""
    from repro_torch.models import model_schema
    from repro_torch.models.schema import abstract_params
    from repro_torch.quant.apply import quantize_params
    from repro_torch.quant.storage import QuantizedTensor
    schema = model_schema(cut)
    n = _schema_paths(schema["blocks"])[0][1].shape[0]
    for path, _ in _schema_paths(schema["blocks"]):
        sub = _at(params["blocks"], path[:-1])
        w = sub.pop(path[-1])
        if isinstance(w, QuantizedTensor):
            sub[path[-1]] = dataclasses.replace(
                w, data=w.data[:n].clone(), scale=w.scale[:n].clone())
        else:
            sub[path[-1]] = w[:n].clone()
        del w
    want, _ = quantize_params(abstract_params(schema), cut, QUANT_FMT)
    require(_layout(params) == _layout(want),
            f"{cut.name} cut to {cut.n_layers} layers: not its layout")


def flash_on_path(name, q, k, v, kw, gen) -> str:
    """``flash_fwd_cuda`` against ``flash_fwd_ref`` on a prefill's
    attention inputs and on normal draws of their shapes: o within
    ``FLASH_TOL`` of the plain version's largest value, lse within 1e-6,
    at most ``FLASH_BITS_OFF`` of o's elements not bit-equal.  Returns
    the readings as text."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention.ref import flash_fwd_ref
    require(q.dtype == torch.bfloat16 and kw["causal"],
            f"{name}: attention inputs {q.dtype}, {kw}")
    drawn = [torch.randn(t.shape, generator=gen, device=t.device).to(t.dtype)
             for t in (q, k, v)]
    out = []
    for what, (qq, kk, vv) in (("inputs", (q, k, v)), ("draws", drawn)):
        o, lse = fa.flash_fwd_cuda(qq, kk, vv, **kw)
        ro, rl = flash_fwd_ref(qq, kk, vv, **kw)
        err = held(f"{name} o on the {what}", o, ro, FLASH_TOL)
        lerr = held(f"{name} lse on the {what}", lse, rl, 1e-6)
        off = bits_held(f"{name} o on the {what}", o, ro)
        out.append(f"{what}: o max err {err:.3e}, lse {lerr:.3e}, "
                   f"{off:.4%} not bit-equal")
    B, S, Hkv, G, D = q.shape
    return (f"B {B}, S {S}, Hkv {Hkv}, G {G}, D {D}, bf16, causal; "
            + "; ".join(out) + f" (bounds {FLASH_TOL} of the largest o, "
            f"1e-6 of the largest lse, {FLASH_BITS_OFF:.0%} of o)")


def full_width_phase(seed: int, dev, card: str) -> None:
    """Step 7c: ``FULL_ARCHS`` at full width from hobflops9 weights.
    First the leaf-by-leaf draw against the two-pass path on each smoke
    twin, bit for bit; then each config drawn and quantized on the card
    (``quantized_init``; jamba at full depth, then cut to
    ``FULL_LAYERS``), served by ``serve_demo`` (first calls), one decode
    step traced after a prefill whose first attention layer's inputs
    hold the kernel to its plain version, and decode after prefill held
    to the forward through the same dequant hook."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.serve import serve_demo
    from repro_torch.models import model_schema
    from repro_torch.models.schema import init_params
    from repro_torch.quant.apply import make_deq, quantize_params
    from repro_torch.serve.steps import make_decode_step, make_prefill_step

    for name in FULL_ARCHS:
        cfg = smoke_config(name)
        two, _ = quantize_params(init_params(
            model_schema(cfg), torch.Generator(device=dev).manual_seed(seed),
            dev), cfg, QUANT_FMT)
        one, planes, dense = quantized_init(cfg, seed, dev, TWIN_CHUNK)
        same_quantized(two, one, cfg.name)
        print(f"{cfg.name}: drawn and quantized leaf by leaf ({TWIN_CHUNK}-"
              f"element chunks) == quantize_params(init_params(...)), every "
              f"plane word, scale and dense leaf bit for bit ({planes} B of "
              f"planes and scales, {dense} B dense)")
        del two, one
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    for name in FULL_ARCHS:
        t_step = time.perf_counter()
        cfg = get_config(name)
        params = full_draw(cfg, seed, dev, card)
        if name in FULL_LAYERS:
            cfg = dataclasses.replace(cfg, n_layers=FULL_LAYERS[name])
            keep_repeats(params, cfg)
            torch.cuda.empty_cache()
            print(f"{name} served at {cfg.n_layers} of "
                  f"{get_config(name).n_layers} layers, the first repeats "
                  f"of its period cut from the draw, every width full: "
                  f"decoding an expert slice needs 8x its float32 bytes "
                  f"beside the full depth's stored weights; "
                  f"{torch.cuda.memory_allocated() / 1e9:.3f} GB held")

        torch.cuda.reset_peak_memory_stats()
        free0, _ = torch.cuda.mem_get_info()
        held0 = torch.cuda.memory_reserved()
        zero_launches()
        st = {}
        serve_demo(cfg, batch=FULL_BATCH, prompt_len=FULL_PROMPT,
                   gen_len=FULL_GEN, quant=QUANT_FMT, seed=seed,
                   params=params, device=dev, stats=st,
                   print_fn=lambda m: None)
        launches = kernel_launches()
        margin = free_margin(f"{cfg.name} serve_demo", free0, held0)
        require(bool(torch.isfinite(st["logits"]).all()),
                f"{cfg.name} serve_demo: logits not finite")
        require(st["logits"].shape == (FULL_GEN, FULL_BATCH,
                                       cfg.vocab_padded),
                f"{cfg.name} serve_demo: logits "
                f"{tuple(st['logits'].shape)}")
        require(launches["flash_fwd"] > 0,
                f"{cfg.name}: the prefill did not launch the attention "
                f"kernel: {launches}")
        print(f"serve_demo {cfg.name}, {QUANT_FMT} weights, batch "
              f"{FULL_BATCH}, prompt {FULL_PROMPT}"
              f"{f' + {cfg.num_prefix} prefix rows' if cfg.num_prefix else ''}"
              f", {FULL_GEN} tokens, first calls (no warm-up): prefill "
              f"{st['prefill_ms']:.1f} ms, decode "
              f"{st['decode_ms_per_step']:.1f} ms/step, {st['tok_s']:.3f} "
              f"tok/s; peak {torch.cuda.max_memory_allocated() / 1e9:.2f} "
              f"GB, {margin:.2f} GB free at the peak; launches {launches} "
              f"({card})")

        # A prefill of a new prompt, its first attention layer's inputs
        # kept; one decode step after it traced.
        batch = {"tokens": torch.randint(0, cfg.vocab, (FULL_BATCH,
                                                        FULL_PROMPT),
                                         generator=gen, device=dev)}
        if cfg.num_prefix:
            batch["prefix"] = torch.randn(
                (FULL_BATCH, cfg.num_prefix, cfg.frontend_dim),
                generator=gen, device=dev)
        deq = make_deq()
        prefill = make_prefill_step(cfg, FULL_PROMPT + cfg.num_prefix + 1,
                                    deq=deq)
        step = make_decode_step(cfg, deq=deq)
        kernel_fn, first = fa_ops.flash_fwd_cuda, []

        def keep_first(q, k, v, **kw):
            if not first:
                first.append((q, k, v, kw))
            return kernel_fn(q, k, v, **kw)
        fa_ops.flash_fwd_cuda = keep_first
        try:
            cache, lg, length = prefill(params, batch)
        finally:
            fa_ops.flash_fwd_cuda = kernel_fn
        require(bool(first), f"{cfg.name}: no attention in the prefill")
        print(f"step 7c {cfg.name} attention kernel against its plain "
              f"version at the prefill's first attention layer: "
              f"{flash_on_path(f'step 7c {cfg.name}', *first[0], gen)}")
        del first
        tok = lg.argmax(-1).to(torch.int32)
        tr = profile_calls(lambda: step(params, tok, length, cache), 1)
        print(f"traced {cfg.name} {QUANT_FMT} decode step (batch "
              f"{FULL_BATCH}, after a {FULL_PROMPT}-token prefill): host "
              f"{tr['host_ms']:.1f} ms, device busy {tr['busy_ms']:.1f} ms "
              f"({100 * tr['busy_ms'] / tr['host_ms']:.1f}%), "
              f"{tr['launches']:.0f} kernel launches ({card})")
        for ms, k, kname in tr["top"]:
            print(f"    {ms:8.3f} ms {k:6.0f}x  {kname[:90]}")
        del cache, lg, tok

        wide = dataclasses.replace(cfg, moe_capacity_factor=FULL_CAPACITY)
        decode_against_forward(wide, params, batch, dev, deq=deq)
        del params, batch
        torch.cuda.empty_cache()
        print(f"step 7c {cfg.name} wall time: "
              f"{time.perf_counter() - t_step:.1f} s ({card})")


def remat_check(cfg, params, seed: int, dev) -> float:
    """Gradients of ``lm_loss`` with remat against those without, on one
    ``REMAT_SEQ``-token sequence; returns the largest error as a share
    of its leaf's largest gradient, which must be at most
    ``REMAT_TOL``."""
    from repro_torch.data.pipeline import make_batch, place_batch
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import lm_loss
    from repro_torch.models.schema import _leaves, _unflatten
    batch = place_batch(make_batch(SyntheticLM(cfg.vocab, REMAT_SEQ, 1,
                                               seed=seed), 0), dev)
    grads = {}
    for remat in (True, False):
        live = [p.detach().requires_grad_() for p in _leaves(params)]
        loss, _ = lm_loss(_unflatten(params, live), batch, cfg,
                          remat=remat)
        grads[remat] = torch.autograd.grad(loss, live)
        del loss, live
    worst = 0.0
    for a, b in zip(grads[True], grads[False]):
        require(bool(torch.isfinite(a).all()), "remat gradients not finite")
        worst = max(worst, float((a - b).abs().max()) /
                    max(float(b.abs().max()), 1e-30))
    require(worst <= REMAT_TOL, f"remat against no remat: {worst:.3e} of a "
                                f"leaf's largest gradient, bound {REMAT_TOL}")
    return worst


def trace_train_step(step_fn, state, batch) -> dict:
    """One train step under ``torch.profiler``: host ms (synchronised),
    device busy ms, kernel launches and the kernels with the most device
    time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(state, batch)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    kern = [(device_time_us(e) / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"host_ms": host_ms, "busy_ms": sum(k[0] for k in kern),
            "launches": sum(k[1] for k in kern),
            "top": sorted(kern, reverse=True)[:8]}


def train_phase(seed: int, dev, card: str) -> dict:
    """Step 8: qwen2-0.5b trained at full width and depth through
    ``train_loop`` (bf16 compute, float32 parameters and moments),
    crashed after step ``TRAIN_KILL_AT`` and resumed from its
    checkpoint; the remat check; readings.  Every attention layer runs
    the blockwise attention kernels, forward (and remat's recompute) and
    backward: the run fails if either was not launched.  Returns the
    first run's losses, the steady step's ms, the peak, the traced step
    and the launches for steps 9 and 10c."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import dataset_for, make_batch, place_batch
    from repro_torch.launch.train import train_loop
    from repro_torch.models import model_schema
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.schema import param_count
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainConfig, make_train_step

    cfg = get_config(TRAIN_ARCH)
    n_params = param_count(model_schema(cfg))
    batch_size = TRAIN_MICRO * TRAIN_N_MICRO
    shape = ShapeConfig("train_4k, batch cut", TRAIN_SEQ, batch_size, "train")
    tc = TrainConfig(opt=OptConfig(warmup_steps=20, total_steps=TRAIN_STEPS),
                     n_micro=TRAIN_N_MICRO)
    tokens = TRAIN_SEQ * batch_size
    attn_flops = 12 * cfg.n_layers * TRAIN_SEQ ** 2 *         cfg.n_heads * cfg.head_dim * batch_size
    flops = 6 * n_params * tokens + attn_flops
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_train_")
    free = shutil.disk_usage(ckpt).free
    print(f"step 8: {TRAIN_ARCH} training at full width and depth "
          f"({n_params} parameters), bf16 compute, float32 parameters and "
          f"moments; sequence {TRAIN_SEQ} (train_4k's), global batch "
          f"{batch_size} = {TRAIN_N_MICRO} micro-batches of {TRAIN_MICRO} "
          f"(train_4k's 256 cut for one card and the time limit), "
          f"{tokens} tokens a step; checkpoints in {ckpt} "
          f"({free / 1e9:.1f} GB free)")
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        logs, first, second = [], {}, {}

        def log(m):
            logs.append(m)
            print(f"    {m}")

        run = dict(steps=TRAIN_STEPS, tc=tc, ckpt_dir=ckpt,
                   ckpt_every=TRAIN_CKPT_EVERY, hb_dir=f"{ckpt}/hb",
                   device=dev, seed=seed, log_every=1, print_fn=log)
        _, losses1 = train_loop(cfg, shape, kill_at=TRAIN_KILL_AT,
                                stats=first, **run)
        torch.cuda.empty_cache()
        state, losses2 = train_loop(cfg, shape, stats=second, **run)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        launches = kernel_launches()
        gnorms = first["grad_norm"] + second["grad_norm"]
        require(all(np.isfinite(losses1 + losses2)),
                f"train losses not finite: {losses1} {losses2}")
        require(all(np.isfinite(gnorms)) and min(gnorms) > 0,
                f"grad norms {gnorms}")
        require(len(losses1) == TRAIN_KILL_AT + 1 and
                any(f"resuming at {TRAIN_KILL_AT}" in m for m in logs) and
                second["restored_step"] == TRAIN_KILL_AT - 1,
                f"the resumed run did not resume at {TRAIN_KILL_AT}")
        rel = abs(losses2[0] - losses1[-1]) / abs(losses1[-1])
        require(rel <= RESUME_TOL,
                f"resumed step {TRAIN_KILL_AT} loss {losses2[0]} against "
                f"{losses1[-1]}: {rel:.3e} relative, bound {RESUME_TOL}")
        print(f"step 8 resume: step {TRAIN_KILL_AT} loss {losses1[-1]:.6f} "
              f"in the first run, {losses2[0]:.6f} resumed ({rel:.3e} "
              f"relative, bound {RESUME_TOL}); losses {losses1} then "
              f"{losses2}; grad norms {gnorms}")

        steady = first["step_ms"][1:] + second["step_ms"][1:]
        step_ms = statistics.median(steady)
        print(f"step 8 steady step ({card}): {step_ms:.1f} ms (median of "
              f"{[round(x, 1) for x in steady]}; first steps "
              f"{first['step_ms'][0]:.1f} / {second['step_ms'][0]:.1f} ms), "
              f"{tokens / step_ms * 1e3:.0f} tokens/s, model "
              f"{flops / step_ms / 1e9:.1f} TFLOP/s ({flops / 1e12:.2f} "
              f"TFLOP a step = 6 N T with N {n_params}, T {tokens}: "
              f"{6 * n_params * tokens / 1e12:.2f}, plus attention's "
              f"12 L S^2 (H dh) B = 12 x {cfg.n_layers} x {TRAIN_SEQ}^2 x "
              f"{cfg.n_heads * cfg.head_dim} x {batch_size}: "
              f"{attn_flops / 1e12:.2f}; remat's recompute not counted)")
        print(f"step 8 peak memory ({card}; max_memory_allocated over both "
              f"runs): {peak / 1e9:.2f} GB; host make_batch + place_batch "
              f"{statistics.median(first['batch_ms'] + second['batch_ms']):.1f}"
              f" ms a step (median)")
        for name, st in (("first run", first), ("resumed run", second)):
            for sv in st["saves"]:
                print(f"step 8 checkpoint save ({card}; {name}, step "
                      f"{sv['step']}): {sv['bytes']} B, device->host "
                      f"{sv['d2h_s']:.2f} s, files {sv['files_s']:.2f} s")
        print(f"step 8 restore of step {second['restored_step']} ({card}): "
              f"{second['restore_s']:.2f} s")
        print(f"step 8 launches: {launches}")
        require(launches["flash_fwd"] > 0 and launches["flash_bwd"] > 0,
                f"step 8 did not launch the attention kernels: {launches}")

        # One more step, traced.
        ds = dataset_for(cfg, shape, seed)
        batch = place_batch(make_batch(ds, TRAIN_STEPS), dev)
        tr = trace_train_step(make_train_step(cfg, tc), state, batch)
        print(f"step 8 traced step ({card}): host {tr['host_ms']:.1f} ms, "
              f"device busy {tr['busy_ms']:.1f} ms "
              f"({100 * tr['busy_ms'] / tr['host_ms']:.1f}%), "
              f"{tr['launches']} kernel launches; top kernels:")
        for ms, n, name in tr["top"]:
            print(f"    {ms:9.2f} ms {n:6d}x  {name[:240]}")
        worst = remat_check(cfg, state["params"], seed, dev)
        print(f"step 8 remat check ({card}; sequence {REMAT_SEQ}, batch 1): "
              f"max err "
              f"{worst:.3e} of a leaf's largest gradient (bound "
              f"{REMAT_TOL})")
        del state
        return {"losses": losses1, "step_ms": step_ms, "tc": tc,
                "shape": shape, "flops": flops, "peak": peak,
                "trace": tr, "launches": launches}
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        torch.cuda.empty_cache()


def dist_phase(seed: int, dev, card: str, step8: dict) -> None:
    """Step 9: the distribution layer on a one-card mesh.  9a starts a
    one-rank NCCL group (``host_mesh``); 9b trains step 8's
    configuration for ``DIST_STEPS`` steps with ``mesh=`` (state and
    batches as DTensors, the activation anchors on) and holds each loss
    to step 8's first run; 9c traces the same step with the dry run's
    ``build`` on meta tensors and holds its per-device peak to 9b's and
    its matmul FLOPs to ``dense_train_flops``; 9d holds int8 gradient
    compression on the card to the CPU, bit for bit."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed.compression import (
        compress_grads, compressed_psum, dequantize_int8,
        make_error_feedback, quantize_int8)
    from repro_torch.launch.dryrun import (build, dense_train_flops,
                                           roofline_terms)
    from repro_torch.launch.mesh import host_mesh
    from repro_torch.launch.train import train_loop

    cfg = get_config(TRAIN_ARCH)
    shape, tc = step8["shape"], step8["tc"]
    mesh = host_mesh("cuda")
    print(f"step 9a: {mesh} over a one-rank {dist.get_backend()} group")

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    stats: dict = {}
    state, losses = train_loop(cfg, shape, steps=DIST_STEPS, tc=tc,
                               mesh=mesh, seed=seed, log_every=1,
                               stats=stats,
                               print_fn=lambda m: print(f"    {m}"))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    own = peak - base
    launches = kernel_launches()
    for i, loss in enumerate(losses):
        rel = abs(loss - step8["losses"][i]) / abs(step8["losses"][i])
        require(rel <= RESUME_TOL,
                f"mesh run step {i} loss {loss} against step 8's "
                f"{step8['losses'][i]}: {rel:.3e} relative, bound "
                f"{RESUME_TOL}")
    mesh_ms = stats["step_ms"][-1]
    print(f"step 9b mesh-run losses {losses} against step 8's "
          f"{step8['losses'][:DIST_STEPS]} (each within {RESUME_TOL} "
          f"relative); steady step ({card}) {mesh_ms:.1f} ms on the mesh "
          f"against step 8's {step8['step_ms']:.1f} ms (first step "
          f"{stats['step_ms'][0]:.1f} ms); max_memory_allocated "
          f"{peak / 1e9:.2f} GB after reset_peak_memory_stats, "
          f"{own / 1e9:.2f} GB above the {base / 1e9:.2f} GB held "
          f"before; launches: {launches}")

    t0 = time.perf_counter()
    rec = build(TRAIN_ARCH, shape, "host", {"n_micro": TRAIN_N_MICRO},
                mesh=mesh)
    want = dense_train_flops(cfg, shape.global_batch, shape.seq_len)
    got = rec["cost"]["flops"]
    pred = rec["memory"]["peak_bytes"]
    ratio = pred / own
    roof = roofline_terms(rec["cost"], rec["links"])
    print(f"step 9c dry run of the same step on meta tensors "
          f"({time.perf_counter() - t0:.1f} s): predicted peak "
          f"{pred / 1e9:.2f} GB (arguments "
          f"{rec['memory']['argument_bytes'] / 1e9:.2f}, rest "
          f"{rec['memory']['rest_bytes'] / 1e9:.2f}) = {ratio:.3f} x the "
          f"measured {own / 1e9:.2f} GB (bound {DRY_PEAK_RANGE}); matmul "
          f"FLOPs {got:.6e} against the analytic {sum(want.values()):.6e} "
          f"= {want['dense']:.6e} (6 T N_mm) + {want['attention']:.6e} "
          f"(12 L S^2 H dh B) + {want['remat']:.6e} (remat's recompute); "
          f"elementwise {rec['cost']['elem_flops']:.4e}, bytes "
          f"{rec['cost']['bytes']:.4e}, collective bytes "
          f"{rec['cost']['coll_bytes']:.4e}")
    print(f"step 9c roofline (H100 SXM5 data sheet, no claim): compute "
          f"{roof['compute_s'] * 1e3:.1f} ms, memory "
          f"{roof['memory_s'] * 1e3:.1f} ms, collective "
          f"{roof['collective_s'] * 1e3:.1f} ms -> {roof['dominant']}, "
          f"{roof['step_s_max'] * 1e3:.1f} ms a step, against 9b's "
          f"measured {mesh_ms:.1f} ms ({card})")
    require(DRY_PEAK_RANGE[0] <= ratio <= DRY_PEAK_RANGE[1],
            f"dry-run peak {pred} against measured {own}: {ratio:.3f}")
    require(abs(got - sum(want.values())) <= DRY_FLOP_TOL * sum(
        want.values()), f"dry-run FLOPs {got} against {want}")

    table = state["params"]["embed"]["table"].full_tensor().detach()
    del state
    grads = {"table": table}
    ef_dev, ef_cpu = make_error_feedback(grads), make_error_feedback(
        {"table": table.cpu()})
    for r in range(COMPRESS_ROUNDS):
        out_dev, ef_dev = compress_grads(grads, ef_dev)
        out_cpu, ef_cpu = compress_grads({"table": table.cpu()}, ef_cpu)
        require(same_bits(out_dev["table"].cpu(), out_cpu["table"]) and
                same_bits(ef_dev["table"].cpu(), ef_cpu["table"]),
                f"compress_grads round {r}: the card differs from the CPU")
    psum = compressed_psum(table, mesh.get_group("data"))
    require(same_bits(psum, dequantize_int8(*quantize_int8(table))),
            "compressed_psum over one rank != dequantize(quantize(x))")
    print(f"step 9d int8 error-feedback compression of the "
          f"{list(table.shape)} embedding leaf, {COMPRESS_ROUNDS} rounds "
          f"on the card: equal to the CPU's bit for bit; "
          f"compressed_psum over the one-rank group equals "
          f"dequantize(quantize(x)) bit for bit")
    del table, grads, ef_dev, out_dev, psum
    dist.destroy_process_group()
    torch.cuda.empty_cache()


def flash_route_trace(dev) -> None:
    """The blockwise attention kernels each input dtype launches, traced:
    bf16 operands must reach the three tensor-core kernels and float32
    ones none (the FFMA kernels), with the Dv pass and the runs' sum on
    both.  Run before the other phases: after them the tracer has come
    back empty from such a short window."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention import kernel as fa
    gen = torch.Generator(device=dev).manual_seed(0)
    b, sq, sk, hkv, g, d = FLASH_F32_CASE
    kw = dict(causal=True, q_block=512, kv_block=512)
    names = {}
    for dt in (torch.bfloat16, torch.float32):
        q, do = (torch.randn(b, sq, hkv, g, d, generator=gen,
                             device=dev).to(dt) for _ in range(2))
        k, v = (torch.randn(b, sk, hkv, d, generator=gen, device=dev).to(dt)
                for _ in range(2))
        o, lse = fa.flash_fwd_cuda(q, k, v, **kw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # The tracer can miss a window's first kernels.
            torch.ones(1, device=dev).add_(1)
            torch.cuda.synchronize()
            time.sleep(0.1)
            for _ in range(2):
                fa.flash_fwd_cuda(q, k, v, **kw)
                fa.flash_bwd_cuda(do, q, k, v, o, lse, **kw)
            torch.cuda.synchronize()
        names[dt] = {
            e.key for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "flash" in e.key}
    tc, ffma = names[torch.bfloat16], names[torch.float32]
    require(len(tc) == 5 and len(ffma) == 5
            and sum("_tc_kernel" in n for n in tc) == 3
            and not any("_tc_kernel" in n for n in ffma),
            f"attention kernels by route: bf16 {sorted(tc)}, float32 "
            f"{sorted(ffma)}")
    short = lambda ns: sorted(re.search(r"flash_\w+", n).group(0)
                              for n in ns)
    print(f"blockwise attention routes, traced: bf16 -> {short(tc)}; "
          f"float32 -> {short(ffma)}")


def flash_phase(seed: int, dev, card: str, params: dict) -> dict:
    """Steps 10a-10b: the blockwise attention kernels against their
    plain versions on the card and timed beside their bounds and
    ``scaled_dot_product_attention`` (10a); qwen2-0.5b prefill of
    ``FLASH_LONG`` tokens from ``params`` (its float32 weights), and at
    ``PREFILL_CHECK`` tokens its last logits against the plain version
    (10b).  Returns the ``kernels`` row, whose ``launches`` are 10b's
    until :func:`step8_beside_d8` gives step 8's."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (flash_bwd_ref,
                                                         flash_fwd_ref)
    from repro_torch.launch.cost import FLASH_HALF_PRODUCTS
    from repro_torch.serve.steps import make_prefill_step

    torch.backends.cuda.matmul.allow_tf32 = False
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    peak = n_sm * FFMA_LANES * 2 * clock_mhz * 1e6
    exp_rate = n_sm * EXP_PER_SM * clock_mhz * 1e6
    tc_rate = n_sm * BF16_FLOPS_A_CLOCK * clock_mhz * 1e6
    B, S, Hq, Hkv, D = FLASH_SHAPE
    G = Hq // Hkv
    gen = torch.Generator(device=dev).manual_seed(seed)
    kw = dict(causal=True, q_block=512, kv_block=512)

    def draw(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def causal_elems(b, s):
        return b * Hq * s * (s + 1) // 2

    def bounds(elems, moved, which):
        """ms of each bound of a call over ``elems`` causal score
        elements; ``bound`` is the largest of the tensor, exp and bytes
        bounds, ``by`` what sets it.  ``tensor_989`` is the tensor bound
        at the data sheet's rate, ``tensor_issued`` at the half-products
        the design issues: printed, neither sets ``bound``."""
        mult = 1 if which == "fwd" else 2
        flops = 2 * elems * D
        out = {"ffma": mult * 4 * elems * D / peak * 1e3,
               "tensor": FLASH_HALF_PRODUCTS[which] * flops / tc_rate * 1e3,
               "tensor_989": FLASH_HALF_PRODUCTS[which] * flops
               / BF16_FLOPS_PER_S * 1e3,
               "tensor_issued": FLASH_ISSUED[which] * flops / tc_rate * 1e3,
               "exp": elems / exp_rate * 1e3,
               "bytes": moved / HBM_BYTES_PER_S * 1e3}
        out["bound"] = max(out["tensor"], out["exp"], out["bytes"])
        out["by"] = "bytes" if out["bound"] == out["bytes"] else "operations"
        return out

    def bound_text(bd, ms):
        return (f"bound {bd['bound']:.3f} ms ({bd['by']}; tensor "
                f"{bd['tensor']:.3f}, exp {bd['exp']:.3f}, bytes "
                f"{bd['bytes']:.3f}), share {bd['bound'] / ms:.3f}; tensor "
                f"at 989 TFLOP/s {bd['tensor_989']:.3f} ms, share "
                f"{bd['tensor_989'] / ms:.3f}; tensor over the half-products "
                f"issued {bd['tensor_issued']:.3f} ms, share "
                f"{bd['tensor_issued'] / ms:.3f}; f32 FFMA bound "
                f"{bd['ffma']:.3f} ms, share {bd['ffma'] / ms:.3f}")

    # -- 10a. at step 8's attention shape, forward and backward ---------
    print(f"step 10a: blockwise attention ({card}); bf16 tensor cores "
          f"{n_sm} SMs x {BF16_FLOPS_A_CLOCK} x {clock_mhz:.0f} MHz = "
          f"{tc_rate / 1e12:.1f} TFLOP/s (data sheet "
          f"{BF16_FLOPS_PER_S / 1e12:.0f}); exp {n_sm} SMs x "
          f"{EXP_PER_SM} x {clock_mhz:.0f} MHz = {exp_rate / 1e12:.3f} T/s; "
          f"f32 FFMA peak {n_sm} SMs x {FFMA_LANES} lanes x 2 x "
          f"{clock_mhz:.0f} MHz = {peak / 1e12:.1f} TFLOP/s; HBM "
          f"{HBM_BYTES_PER_S / 1e12} TB/s")
    q, k, v = draw(B, S, Hkv, G, D), draw(B, S, Hkv, D), draw(B, S, Hkv, D)
    do = draw(B, S, Hkv, G, D)
    o, lse = fa.flash_fwd_cuda(q, k, v, **kw)
    grads = fa.flash_bwd_cuda(do, q, k, v, o, lse, **kw)
    ro, rl = flash_fwd_ref(q, k, v, **kw)
    want = flash_bwd_ref(do, q, k, v, ro, rl, **kw)
    torch.cuda.synchronize()
    err = held("step 10a o", o, ro, FLASH_TOL)
    held("step 10a lse", lse, rl, 1e-6)
    gerr = {n: held(f"step 10a d{n}", a, b, FLASH_TOL)
            for n, a, b in zip("qkv", grads, want)}
    bits_off = {"o": bits_held("step 10a o", o, ro)}
    bits_off.update({f"d{n}": bits_held(f"step 10a d{n}", a, b)
                     for n, a, b in zip("qkv", grads, want)})
    o2, lse2 = fa.flash_fwd_cuda(q, k, v, **kw)
    grads2 = fa.flash_bwd_cuda(do, q, k, v, o, lse, **kw)
    require(same_bits(o, o2) and same_bits(lse, lse2),
            "step 10a: two forward calls differ")
    require(all(same_bits(a, b) for a, b in zip(grads, grads2)),
            "step 10a: two backward calls differ")
    del o2, lse2, grads2
    fwd_ms = median_device_ms(lambda: fa.flash_fwd_cuda(q, k, v, **kw))
    bwd_ms = median_device_ms(
        lambda: fa.flash_bwd_cuda(do, q, k, v, o, lse, **kw))
    plain_fwd_ms = time_cuda(lambda: flash_fwd_ref(q, k, v, **kw), 3)
    plain_bwd_ms = time_cuda(
        lambda: flash_bwd_ref(do, q, k, v, ro, rl, **kw), 3)
    elems = causal_elems(B, S)
    bd_fwd = bounds(elems, nbytes(q, k, v, o, lse), "fwd")
    bd_bwd = bounds(elems, nbytes(q, k, v, o, do, lse, *grads), "bwd")
    # The yardstick, on no path of the port: float32, causal, GQA.
    qs = q.reshape(B, S, Hq, D).transpose(1, 2).float()
    ks, vs = (t.transpose(1, 2).float() for t in (k, v))
    dos = do.reshape(B, S, Hq, D).transpose(1, 2).float()
    sdpa_ms = median_device_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True, enable_gqa=True))
    qg, kg, vg = (t.detach().requires_grad_() for t in (qs, ks, vs))

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                             enable_gqa=True)
        torch.autograd.grad(out, (qg, kg, vg), dos)

    sdpa_fb_ms = median_device_ms(sdpa_fwd_bwd, reps=5)
    print(f"step 10a B {B}, S {S}, Hq {Hq}, Hkv {Hkv}, D {D}, bf16 inputs, "
          f"causal (step 8's attention; {elems * 4 * D / 1e9:.2f} GFLOP "
          f"causal forward): forward {fwd_ms:.3f} ms, "
          f"{bound_text(bd_fwd, fwd_ms)}, plain {plain_fwd_ms:.3f} ms; "
          f"backward (Dv, dK/dV, sum, dQ) {bwd_ms:.3f} ms, "
          f"{bound_text(bd_bwd, bwd_ms)}, plain {plain_bwd_ms:.3f} ms; "
          f"max abs err against the plain version: o {err:.3e}, "
          + ", ".join(f"d{n} {e:.3e}" for n, e in gerr.items())
          + f" (bound {FLASH_TOL} of each largest value); elements not "
          f"bit-equal to the plain version's: "
          + ", ".join(f"{n} {x:.4%}" for n, x in bits_off.items())
          + f" (bound {FLASH_BITS_OFF:.0%}); two calls of "
          f"each equal bit for bit; scaled_dot_product_attention float32 "
          f"(yardstick, on no path): forward {sdpa_ms:.3f} ms, forward + "
          f"backward {sdpa_fb_ms:.3f} ms; the FFMA design (PERF.md run F3, "
          f"not measured in this run): forward {EARLIER_FLASH_MS['fwd']} "
          f"ms, backward {EARLIER_FLASH_MS['bwd']} ms")
    del o, lse, grads, ro, rl, want, qs, ks, vs, dos, qg, kg, vg

    # -- 10a. the float32 route at a small shape -------------------------
    fb, fsq, fsk, fhkv, fg, fd = FLASH_F32_CASE
    q, k, v, do = (draw(fb, fsq, fhkv, fg, fd, dtype=torch.float32),
                   draw(fb, fsk, fhkv, fd, dtype=torch.float32),
                   draw(fb, fsk, fhkv, fd, dtype=torch.float32),
                   draw(fb, fsq, fhkv, fg, fd, dtype=torch.float32))
    o, lse = fa.flash_fwd_cuda(q, k, v, **kw)
    grads = fa.flash_bwd_cuda(do, q, k, v, o, lse, **kw)
    ro, rl = flash_fwd_ref(q, k, v, **kw)
    want = flash_bwd_ref(do, q, k, v, ro, rl, **kw)
    torch.cuda.synchronize()
    f32_err = held("step 10a float32 o", o, ro, FLASH_F32_TOL[0])
    held("step 10a float32 lse", lse, rl, 1e-6)
    f32_gerr = max(held(f"step 10a float32 d{n}", a, b,
                            FLASH_F32_TOL[1])
                   for n, a, b in zip("qkv", grads, want))
    print(f"step 10a float32 route (FFMA) at B {fb}, Sq {fsq}, Sk {fsk}, "
          f"Hkv {fhkv}, G {fg}, D {fd}, causal: max abs err o "
          f"{f32_err:.3e}, gradients {f32_gerr:.3e} (bounds "
          f"{FLASH_F32_TOL} of the largest value)")
    del q, k, v, do, o, lse, grads, ro, rl, want

    # -- 10a. one FLASH_LONG-token layer, forward ------------------------
    q, k, v = (draw(1, FLASH_LONG, Hkv, G, D), draw(1, FLASH_LONG, Hkv, D),
               draw(1, FLASH_LONG, Hkv, D))
    o, lse = fa.flash_fwd_cuda(q, k, v, **kw)
    (ro, rl), plain_long_ms = time_event(
        lambda: flash_fwd_ref(q, k, v, **kw))
    err_long = held(f"step 10a o at {FLASH_LONG}", o, ro, FLASH_TOL)
    held(f"step 10a lse at {FLASH_LONG}", lse, rl, 1e-6)
    bits_off["o_32k"] = bits_held(f"step 10a o at {FLASH_LONG}", o, ro)
    del ro, rl
    long_ms = median_device_ms(lambda: fa.flash_fwd_cuda(q, k, v, **kw),
                               reps=5, warm=1)
    e_long = causal_elems(1, FLASH_LONG)
    bd_long = bounds(e_long, nbytes(q, k, v, o, lse), "fwd")
    qs = q.reshape(1, FLASH_LONG, Hq, D).transpose(1, 2).float()
    ks, vs = (t.transpose(1, 2).float().repeat_interleave(G, dim=1)
              for t in (k, v))
    try:
        # The math backend would hold two 60 GB score tensors.
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            sdpa_long = median_device_ms(
                lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                       is_causal=True),
                reps=3, warm=1)
    except RuntimeError as e:
        sdpa_long = None
        print(f"    scaled_dot_product_attention at {FLASH_LONG}: not "
              f"measured ({str(e)[:120]})")
    print(f"step 10a one {FLASH_LONG}-token layer (batch 1, bf16, causal; "
          f"{e_long * 4 * D / 1e12:.3f} TFLOP): forward {long_ms:.3f} ms, "
          f"{bound_text(bd_long, long_ms)}, plain {plain_long_ms:.1f} ms "
          f"(one call); max abs err o {err_long:.3e}, "
          f"{bits_off['o_32k']:.4%} of o not bit-equal to the plain "
          f"version's; "
          f"scaled_dot_product_attention float32 (memory-efficient "
          f"backend, kv heads repeated): "
          + (f"{sdpa_long:.3f} ms" if sdpa_long is not None
             else "not measured")
          + f"; the FFMA design (PERF.md run F3, not measured in this run): "
          f"{EARLIER_FLASH_MS['fwd_32k']} ms")
    del q, k, v, o, lse, qs, ks, vs
    torch.cuda.empty_cache()

    # -- 10b. qwen2-0.5b prefill at FLASH_LONG tokens ---------------------
    cfg = get_config(LM_ARCH)
    toks = torch.randint(0, cfg.vocab, (1, FLASH_LONG), generator=gen,
                         device=dev)
    step = make_prefill_step(cfg, FLASH_LONG)
    torch.cuda.synchronize()
    held_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    prefill_ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        cache, lg, length = step(params, {"tokens": toks})
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
        del cache
    launches = kernel_launches()
    prefill_peak = torch.cuda.max_memory_allocated()
    require(launches["flash_fwd"] == 2 * cfg.n_layers,
            f"10b: {launches['flash_fwd']} attention launches in two "
            f"prefills of {cfg.n_layers} layers")
    require(lg.shape == (1, cfg.vocab_padded) and length == FLASH_LONG
            and bool(torch.isfinite(lg).all()),
            f"10b: last logits {tuple(lg.shape)} not finite")
    print(f"step 10b {LM_ARCH} prefill of {FLASH_LONG} tokens ({card}; "
          f"prefill_32k's length, its batch of 32 cut to 1; float32 "
          f"weights, bf16 compute; make_prefill_step): "
          f"{prefill_ms[0]:.1f} ms first, {prefill_ms[1]:.1f} ms second; "
          f"max_memory_allocated {prefill_peak / 1e9:.2f} GB "
          f"({(prefill_peak - held_before) / 1e9:.2f} GB above the "
          f"{held_before / 1e9:.2f} GB held); last logits finite, max "
          f"|logit| {float(lg.abs().max()):.3f}; launches {launches}")
    del lg
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    step32 = make_prefill_step(cfg32, PREFILL_CHECK)
    batch = {"tokens": toks[:, :PREFILL_CHECK]}
    _, lg_k, _ = step32(params, batch)
    kernel_fn = fa_ops.flash_fwd_cuda
    fa_ops.flash_fwd_cuda = flash_fwd_ref     # the plain version, this call
    try:
        _, lg_p, _ = step32(params, batch)
    finally:
        fa_ops.flash_fwd_cuda = kernel_fn
    top = float(lg_p.abs().max())
    perr = float((lg_k - lg_p).abs().max()) / top
    require(bool(torch.isfinite(lg_k).all()) and perr <= PREFILL_TOL,
            f"10b: prefill's last logits with the kernel against the plain "
            f"version: {perr:.3e} of the largest {top:.3f}, bound "
            f"{PREFILL_TOL}")
    print(f"step 10b {LM_ARCH} prefill of {PREFILL_CHECK} tokens at float32 "
          f"compute: last logits with the kernel against the plain "
          f"version: max err {perr:.3e} of the largest |logit| {top:.3f} "
          f"(bound {PREFILL_TOL})")
    del lg_k, lg_p
    torch.cuda.empty_cache()

    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/models/attention.py:77 (_flash, jnp; no "
                    "Pallas kernel)",
        "launches": launches["flash_fwd"],
        "launches_prefill_32k": launches["flash_fwd"],
        "max_abs_err": err, "max_abs_err_bwd": max(gerr.values()),
        "max_abs_err_32k": err_long,
        "max_abs_err_f32_route": max(f32_err, f32_gerr),
        "bits_off": bits_off,
        "ms": fwd_ms, "plain_ms": plain_fwd_ms, "bound_ms": bd_fwd["bound"],
        "bound_by": bd_fwd["by"], "library_ms": sdpa_ms,
        "bounds_ms": {k: v for k, v in bd_fwd.items() if k != "by"},
        "shape": f"B {B}, S {S}, Hq {Hq}, Hkv {Hkv}, D {D}, bf16, causal "
                 f"(step 8's attention), forward",
        "bwd_ms": bwd_ms, "bwd_plain_ms": plain_bwd_ms,
        "bwd_bound_ms": bd_bwd["bound"],
        "bwd_bounds_ms": {k: v for k, v in bd_bwd.items() if k != "by"},
        "bwd_library_ms": sdpa_fb_ms - sdpa_ms,
        "ms_32k": long_ms, "plain_ms_32k": plain_long_ms,
        "bound_ms_32k": bd_long["bound"], "library_ms_32k": sdpa_long,
        "prefill_32k_ms": prefill_ms[-1],
        "prefill_32k_peak_gb": prefill_peak / 1e9,
        "prefill_check_err": perr,
    }


def step8_beside_d8(step8: dict, card: str, row: dict) -> None:
    """Step 10c: step 8's step time, peak, traced busy share and top
    kernels with the attention kernels on its path, beside its reading
    before them (PERF.md run D8); sets ``row``'s launches to step 8's
    (forward calls plus backward kernels)."""
    tr, s8 = step8["trace"], step8["launches"]
    print(f"step 10c ({card}): step 8 with the attention kernels on its "
          f"path: steady step {step8['step_ms']:.1f} ms against "
          f"{STEP8_D8['step_ms']} ms before them (PERF.md run D8) "
          f"({step8['step_ms'] / STEP8_D8['step_ms']:.3f} x); peak "
          f"{step8['peak'] / 1e9:.2f} GB against {STEP8_D8['peak_gb']} GB; "
          f"traced step busy {tr['busy_ms']:.1f} of {tr['host_ms']:.1f} ms "
          f"({100 * tr['busy_ms'] / tr['host_ms']:.1f}%); attention "
          f"launches {s8['flash_fwd']} forward, {s8['flash_bwd']} backward "
          f"kernels ({s8['flash_bwd_calls']} calls); top kernels:")
    for ms, n, name in tr["top"]:
        print(f"    {ms:9.2f} ms {n:6d}x  {name[:160]}")
    row["launches"] = s8["flash_fwd"] + s8["flash_bwd"]
    row["launches_step8"] = {"fwd": s8["flash_fwd"], "bwd": s8["flash_bwd"],
                             "bwd_calls": s8["flash_bwd_calls"]}


def dequant_phase(seed: int, dev, params: dict, n_sm: int,
                  clock_mhz: float) -> dict:
    """The dequant matmul at qwen2-0.5b's quantized projection shapes:
    counted run through the entry point, then each point against its
    plain version and timed.  Returns the kernel's JSON row."""
    from repro_torch.core.fpformat import StorageFormat
    from repro_torch.kernels.dequant_matmul import kernel as dqk
    from repro_torch.kernels.dequant_matmul.ops import (dequant_matmul,
                                                        pack_weights)
    from repro_torch.kernels.dequant_matmul.ref import dequant_matmul_ref
    from repro_torch.quant.storage import dequantize

    torch.backends.cuda.matmul.allow_tf32 = False
    fp32_peak = n_sm * FP32_LANES_PER_SM * 2 * clock_mhz * 1e6  # derived
    int32_peak = n_sm * INT32_LANES_PER_SM * clock_mhz * 1e6    # derived
    sfmt = StorageFormat(5, 3)                                  # hobflops9
    b0 = params["blocks"]["b0"]
    shapes = {"wq/wo": b0["attn"]["wq"][0], "wk/wv": b0["attn"]["wk"][0],
              "w_gate/w_up": b0["mlp"]["w_gate"][0],
              "w_down": b0["mlp"]["w_down"][0]}
    packed = {name: pack_weights(w, sfmt) for name, w in shapes.items()}
    gen = torch.Generator().manual_seed(seed + 1)
    xs = {(name, M): torch.randn((M, qt.shape[0]), generator=gen).to(dev)
          for name, qt in packed.items() for M in DQ_MS}
    torch.cuda.synchronize()

    zero_launches()
    outs = {key: dequant_matmul(x, packed[key[0]]) for key, x in xs.items()}
    torch.cuda.synchronize()
    launches = kernel_launches()
    print(f"dequant_matmul path launches: {launches}")
    # The tensor-core route launches the x split and the main kernel, and
    # the chunk sum when it splits K over more than one chunk.
    plans = {key: dqk.plan(key[1], packed[key[0]].shape[0], sfmt)
             for key in xs}
    want_kernels = sum(2 + (p["split"] and p["chunks"] > 1)
                       for p in plans.values())
    require(launches["dequant_matmul_calls"] == len(xs) and
            launches["dequant_matmul"] == want_kernels,
            f"dequant_matmul: {launches['dequant_matmul_calls']} calls and "
            f"{launches['dequant_matmul']} kernels for {len(xs)} calls and "
            f"{want_kernels} kernels")

    print(f"derived float32 FMA peak {fp32_peak / 1e12:.2f} TFLOP/s "
          f"({n_sm} SMs x {FP32_LANES_PER_SM} lanes x 2 x {clock_mhz:.0f} "
          f"MHz)")
    points, max_ratio, max_err = [], 0.0, 0.0
    for (name, M), x in xs.items():
        qt = packed[name]
        K, N = qt.shape
        got = outs[(name, M)]
        want = dequant_matmul_ref(x, qt.data, qt.scale, sfmt, N)
        w = dequantize(qt)
        bound = 2 * K * 2.0 ** -24 * (x.abs() @ w.abs())
        diff = (got - want).abs()
        require(bool(torch.isfinite(got).all()) and
                bool((diff <= bound).all()),
                f"dequant_matmul {name} M={M}: outside the float32 "
                f"summation bound")
        ratio = float((diff / bound.clamp(min=1e-30)).max())
        # The control: one TF32 product, x's low half dropped.
        ctrl = dequant_matmul_ref(tf32_round(x), qt.data, qt.scale, sfmt, N)
        ctrl_ratio = float(((ctrl - want).abs() / bound.clamp(min=1e-30))
                           .max())
        require(ratio <= DQ_SPLIT_MARGIN * ctrl_ratio,
                f"dequant_matmul {name} M={M}: error {ratio:.4f} of the "
                f"bound, more than {DQ_SPLIT_MARGIN} of a single-TF32 "
                f"product's {ctrl_ratio:.4f}")
        max_ratio, max_err = max(max_ratio, ratio), max(max_err,
                                                        float(diff.max()))
        # The FMA route (w_f > 10 formats), uncounted.
        fma_out = torch.empty_like(got)
        fma_ms = median_device_ms(lambda: dqk.launch(
            x, qt.data, qt.scale, fma_out, sfmt))
        ms = median_device_ms(lambda: dequant_matmul(x, qt))
        plain_ms = median_device_ms(
            lambda: dequant_matmul_ref(x, qt.data, qt.scale, sfmt, N))
        lib_ms = median_device_ms(lambda: torch.matmul(x, w))
        nbytes = 4 * (x.numel() + qt.data.numel() + M * N)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        # The function's work: two TF32 products (x_hi, x_lo) and each
        # weight decoded once.  This kernel decodes each weight once per
        # row tile of n_width rows: its design's cost, not the bound.
        plan = plans[(name, M)]
        row_tiles = -(-M // plan["n_width"])
        tf32_ms = 2 * 2 * M * K * N / TF32_FLOPS_PER_S * 1e3
        decode_ms = K * N * dq_decode_ops(sfmt.nbits) / int32_peak * 1e3
        ops_ms = max(tf32_ms, decode_ms)
        fma_bound = max(2 * M * K * N / fp32_peak * 1e3, bytes_ms)
        pt = dict(shape=name, M=M, K=K, N=N, ms=ms, fma_ms=fma_ms,
                  plain_ms=plain_ms, library_ms=lib_ms,
                  bound_ms=max(ops_ms, bytes_ms),
                  bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                  tf32_ms=tf32_ms, decode_ms=decode_ms, bytes_ms=bytes_ms,
                  design_decode_ms=decode_ms * row_tiles,
                  fma_bound_ms=fma_bound, plan=plan, max_bound_ratio=ratio,
                  single_tf32_bound_ratio=ctrl_ratio)
        points.append(pt)
        print(f"dequant_matmul {name} M={M} K={K} N={N} {plan}: {ms:.4f} ms "
              f"(FMA route {fma_ms:.4f} ms); bound {pt['bound_ms']:.4f} ms "
              f"({pt['bound_by']}: TF32 {tf32_ms:.4f}, decode once "
              f"{decode_ms:.4f}, bytes {bytes_ms:.4f}), share "
              f"{pt['bound_ms'] / ms:.3f}; this design decodes "
              f"{row_tiles}x: {decode_ms * row_tiles:.4f} ms; f32-FMA bound "
              f"{fma_bound:.4f} ms, share {fma_bound / ms:.3f}; plain "
              f"{plain_ms:.4f} ms; torch.matmul on the decoded weight "
              f"{lib_ms:.4f} ms; max |err| / bound {ratio:.4f} (single "
              f"TF32 {ctrl_ratio:.4f})")
    print(f"dequant_matmul vs plain version: within the float32 summation "
          f"bound at all {len(points)} points, largest ratio "
          f"{max_ratio:.4f}, max abs err {max_err:.3e}; each at most "
          f"{DQ_SPLIT_MARGIN} of the single-TF32 control's")
    print(f"dequant_matmul's FMA tiles before the tensor-core route, summed "
          f"over the 8 points (PERF.md, not this run): {EARLIER_DQ_MS} ms")
    by = {b: sum(p["bound_ms"] for p in points if p["bound_by"] == b)
          for b in ("operations", "bytes")}
    return {
        "name": "dequant_matmul", "route": "cuda",
        "source": "src/repro_torch/csrc/dequant_matmul.cu",
        "replaces": "src/repro/kernels/dequant_matmul/kernel.py:64",
        "launches": launches["dequant_matmul"],
        "calls": launches["dequant_matmul_calls"], "max_abs_err": max_err,
        "ms": sum(p["ms"] for p in points),
        "fma_ms": sum(p["fma_ms"] for p in points),
        "fma_bound_ms": sum(p["fma_bound_ms"] for p in points),
        "plain_ms": sum(p["plain_ms"] for p in points),
        "bound_ms": sum(p["bound_ms"] for p in points),
        "bound_by": max(by, key=by.get),
        "library_ms": sum(p["library_ms"] for p in points),
        "shape": f"sum over {LM_ARCH}'s 4 projection shapes x M "
                 f"{DQ_MS}, hobflops9",
        "max_bound_ratio": max_ratio,
        "max_single_tf32_ratio": max(p["single_tf32_bound_ratio"]
                                     for p in points),
        "points": points,
    }


if __name__ == "__main__":
    sys.exit(main())
