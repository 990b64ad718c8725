#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the repository root on a machine with an NVIDIA H100 and the
CUDA toolkit: ``python3 chip_smoke.py``. The first run builds the CUDA
kernels from source into ``build/repro_torch/``. Phases, in order; any
failure exits non-zero:

1. device — the card's name, power limit and compute capability
   (must be 9.0);
2. build  — every kernel of the port (K1-K10, nine sources) compiled
   with ``nvcc`` (sm_90a), one process per source, all started
   together; each one's registers and shared memory printed;
3. kernel — each kernel against its plain torch version on the card,
   bit for bit, on seeded inputs, timed with CUDA events (20 launches
   after a warm-up) beside its bound:
   the wave-step kernel (K1) at ``K1_SHAPES`` (WAR aliasing, clipped
   gathers, NaN payloads): an image of 2**24 + 1 words with 2**20 lanes
   x 8 steps, an L2-resident image (64 steps, where barriers weigh
   more), and the launches of bnn, RAWloop, hist+add, filter_pipe,
   WARloop and stream_dot, each printed with the path it took (resident
   in one block's shared memory, or wide) and timed as K2 is (the whole
   call, the card alone, the host per call) beside its bytes and
   sector-aware bounds,
   each also with two barriers a step of its path timed alone at its
   blocks; and one 8-lane step; the hazard frontier kernel (K2) at K=4
   rows, S=D=65536, and
   at fused_raw_loops' K=1, S=D=2**20, both sides (monotonic rows with
   equal-address runs and negative addresses, the whole wrapper call
   timed beside ``torch.searchsorted`` (the median of 7 runs of 20
   calls), with the card's time alone and the host's per call beside it;
   one unsorted row at K=4 in a third case, timed too); the forwarding
   kernel (K3) at
   S=D=2**20 over a float64 memory of 2**24 + 1 words, about 30% of the
   producers invalid, ``lookback=min_lookback(src)``, timed as K2 is
   beside its bytes and sector-aware bounds; the ELL SpMV
   kernel (K4) on a seeded CSR of 2**20 rows (lengths 1..16, columns
   sorted and distinct in each row over 2**20), float32, timed beside
   one cuSPARSE product (``torch.mv`` on a sparse CSR tensor), timed as
   K2 is, and at matpower's shape (512 rows at 8x, W=4, float64 x); the
   histogram kernel (K5) at N=2**26 with 32 bins (about 1% of the data
   -1 and 1% past the last bin) beside ``torch.bincount``, and at
   N=2**24 with 2**16 bins on its global-memory path; the flash
   attention kernel (K6) at qwen3-14b's heads (H=40 over Hk=8, D=128),
   causal at S=4096 and at the serve path's prefill (B=4, S=128), and a
   ragged non-causal case (S=1000) in the reference's layout; K6 with
   gemma3-4b's sliding window (1024) at its heads (8 over 4, D=256),
   S=4096, beside causal K6 at that shape and SDPA with a boolean window
   mask, its bound counting the keys inside the window; the decode
   attention kernel (K7) at batch 32 over a cache of 8192 positions
   (frontiers seeded in [1, 8192]; two calls the same bits; then one row
   at lengths 0) and at the serve path's shape (B=4 over 161 positions,
   every frontier 1-160); K6 and K7 at zamba2-7b's shared attention (32
   over 32 heads of 112) at the serve path's prefill and step; K6 and K7
   at gemma3-4b's heads at its paths' shapes (K6 with the window at B=4,
   S=128 and at B=2, S=1088; K7 at the serve step and over a ring of 1024
   slots at every length to 1088); K6 at the shapes minicpm3-4b's MLA
   gives it, q and k 96 wide and v 64 (40 heads over 40, causal, at the
   serve prefill, B=4, S=128, and at B=1, S=4096), and whisper-tiny's (6
   heads of 64, non-causal: the encoder at B=4, S=1500, the prefill's
   cross attention at S=128 over 1500); K6 and K7 at whisper-tiny's
   decode steps (K6 with one query over 1500 frames, non-causal, and over
   one key, causal; K7 at the serve step, every frontier 1-160); all
   within a stated float32 bound of their
   plain versions, at both shapes the whole call timed as K2's (median
   of 7 runs of 20, the card's time alone, the host's per call) beside
   ``scaled_dot_product_attention`` and the bound; the selective-scan
   kernel (K8) at falcon-mamba-7b's widths (B=4, S=4096, di=8192, n=16),
   a ragged case (S=1000, di=8096), a continuation from a nonzero h0 and
   the serve path's prefill shape (B=4, S=128), y and the final state
   within a stated float32 bound, at falcon's widths and at the serve
   shape the whole call timed as K2's beside its bytes and exponentials
   bounds; the Mamba-1 decode-step kernel (K10) at falcon-mamba-7b's
   widths and the decode cell's batch (B=512, di=8192, n=16, K=4) and at
   a ragged width (B=3, di=8095), three steps in a row with the window and
   state carried in place, y and the state within a stated float32 bound
   and the window bit for bit, at B=512 the whole call timed as K2's
   beside its bytes bound and the plain step; the grouped matmul kernel (K9, float32 in 3xTF32 on the
   tensor cores) at phi3.5-moe's prefill (T_pad=3072 from
   ``monotonic_dispatch`` of seeded router logits, 4096 -> 6400 and
   6400 -> 4096) and at block_t=16, within the float32 dot-product
   bound and a tighter TF32 limit that one TF32 pass misses, both
   projections timed as K2's beside the 3xTF32 operations
   bound and one cuBLAS product of equal FLOPs; for training, K6 with
   its rows' log-sum-exp at qwen3-14b's heads (B=4, S=1024), gemma3-4b's
   window (S=2048) and minicpm3-4b's 96/64 (its output the same bits
   as without, the lse and ``flash_mha``'s gradients within 1e-4 of the
   plain loop's and of autograd through ``attention_ref``; SDPA timed
   beside it), and ``selective_scan``'s Function at falcon-mamba-7b's
   width (B=1, S=512, four chunks of the backward): y and h_final
   against the plain scan, the gradients within 1e-5 + 1e-4·|plain| of
   autograd through it;
4. main path — the nine Table-1 programs at ``--scale-mult 8`` through
   ``executor.execute(..., backend="torch")`` on the card, each final
   array bit-identical to the port's sequential oracle, plus one
   ``run_sequential`` baseline; the wave kernel's launch count is read
   around this phase only, every launch whose image and lanes fit one
   block must take the resident path and every other the wide one,
   and K1 is checked again at the largest launch of the phase;
5. DU path — the port's ``frontier_crosschecks`` on the card over the
   main path's plans: RAWloop/WARloop/WAWloop waves from K2 and
   ``wave_partition`` equal the plan's, tanh+spmv's guarded forwarding
   through K3 is bit-identical to the plan's ``ld_vv`` values; then
   ``fused_raw_loops`` on a seeded guarded RAW pair at S=D=2**20 against
   the sequential loops' result; K2/K3 launches are read around this
   phase and must equal the calls made;
6. substrate path — ``hist_add`` on hist+add's data at 8x, bit-identical
   to the oracle's ``hsum``, and four chained ``spmv_from_csr`` on
   matpower's matrix at 8x, within a stated float32 error bound of the
   oracle's A^3 x and A^4 x; K4/K5 launches are read around this phase
   and must equal the calls made;
7. speculation path — the four speculative programs at
   ``BENCH_SPEC.json``'s scales (8x) through ``executor.execute(...,
   speculation="auto", backend="torch")``, each final array
   bit-identical to the oracle and to the hand-written oracles of
   ``kernels/dynloop/ref.py``; K1 launches read around it, the one-block
   ones on the resident path;
8. streaming path — the three streaming programs at their default
   scales through ``execute(..., fifo_depth=d, backend="torch")`` for
   d in 1, 2, 4, arrays bit-identical to both oracles, wave counts
   non-increasing in depth; K1 launches read around it, the one-block
   ones on the resident path;
9. simulate — the nine Table-1 programs at the reference benchmark's
   1x scales through ``simulator.simulate`` (event engine) in STA, LSQ,
   FUS1 and FUS2, every result's arrays bit-identical to the oracle and
   FUS2's to ``execute(backend="torch")`` on the card; cycles, the
   speedups of FUS2 over STA and LSQ, and host seconds; then the
   speculative programs at 8x in STA and in FUS2 under each predictor,
   cycles equal to the reference's;
10. HLS analysis and DSE — host code in both packages, but for the hint
    sanitizer: ``python -m repro_torch.analysis.lint --all`` equal to
    the committed fixture byte for byte; the two contradictory-hint
    programs through ``execute(..., validate_hints=True)`` on the card
    and ``simulate(mode="FUS2")`` under both engines, raising
    ``HintViolation`` at the same op, instance and address (no K1
    launch: the check precedes the first step), and the hint that
    admits the reset passing and running through K1; the reference
    benchmark's evidence sweep (nine kernels x STA/FUS1/FUS2 x three
    trace modes x six sizings, plus an STA cycle-engine grid: 594
    points) at 1x with a worker a core up to 8, one point of each group
    and every FUS2 point of hist+add held against a standalone
    ``simulate()``, a 2-way shard plus merge against the whole, a warm
    resume that executes nothing; ``dse.calibrate`` at
    ``BENCH_CALIB.json``'s scales equal to that record's fit; counts
    and host seconds beside the card line;
11. the LM paths, one model on the card at a time, 4 prompts of 128
    tokens and 32 new, float32, weights drawn on the card from a seed;
    prefill seconds, decode ms per step beside its bytes bound, tokens/s,
    peak memory and a profile of 4 decode steps for each:
    serve path — qwen3-14b at full width and depth (40 layers, 59.07
    GB): the prefill step's last-token logits (40 K6 launches) against
    128 teacher-forced decode steps (5120 K7 launches) within the
    reference's decode-against-forward tolerance, then ``serve_batch``
    (6400 K7 launches);
    SSM path — falcon-mamba-7b at full width and depth (64 layers, 28.02
    GB): the prefill's logits (64 K8 launches) against 128
    teacher-forced steps (16384 K10 launches, two a layer step), then
    ``serve_batch`` (20480 K10 launches);
    MoE path — phi3.5-moe at full width, 12 of its 32 layers (63.47
    GB): the prefill (12 K6 launches, the capacity path), then each
    layer's dropless MoE (3 K9 launches) against its capacity path with
    room for every assignment on the prefill's hidden states, routing
    equal, then ``serve_batch`` (1920 K7 launches);
    hybrid path — zamba2-7b whole (81 Mamba-2 layers in plain torch and
    13 applications of its shared attention block, 27.00 GB): the
    prefill (13 K6 launches) against 128 teacher-forced steps (1664 K7
    launches) within ``HYBRID_GAP_LIMIT`` times the tolerance (this
    random stack amplifies rounding past the tolerance itself), and
    every unit (Mamba-2 layer or shared-block application) within the
    tolerance, its decode step fed the prefill's own inputs at each of
    the 128 positions (13 K6, 1664 K7; ``check_hybrid_units``); then
    ``serve_batch`` (2080 K7 launches);
    sliding-window path — gemma3-4b whole (34 layers, 29 of them local at
    window 1024, tied embeddings, 15.52 GB): the prefill (34 K6 launches)
    against 128 teacher-forced steps (4352 K7 launches), then
    ``serve_batch`` (5440 K7 launches);
    ring check — gemma3-4b at full width cut to 6 layers (5 local, 1
    global), 2 prompts of 1088 tokens: the prefill (6 K6 launches, the
    window binding) against 1088 teacher-forced steps (6528 K7 launches),
    the local rings of 1024 positions wrapping for the last 64;
    MLA path — minicpm3-4b whole (62 MLA layers, 16.30 GB): the prefill
    (62 K6 launches, the latent expanded to K of 96 and V of 64) against
    128 teacher-forced steps of the absorbed latent-space decode (plain
    torch, no kernel), then ``serve_batch`` (no kernel);
    encoder-decoder path — whisper-tiny whole (4 encoder and 4 decoder
    layers of 384, 0.146 GB) over 1500 stub frames drawn from a seed
    (scaled by 0.02): the prefill (12 K6 launches: 4 encoder layers, each
    decoder layer's self and cross attention) against 128 teacher-forced
    steps given the encoder's output (512 K7 and 512 K6 launches: each
    step's cross attention over the 1500 frames on K6); then, as the
    reference serves it, without the encoder's output: 128 teacher-forced
    steps (the cross layer attends each token to itself; 512 K7, 512 K6)
    whose argmax ``serve_batch``'s first tokens must equal (640 K7, 640
    K6);
12. the training path — ``launch/train``'s loop (``train.run``, the
    record behind ``train.main``) on qwen3-14b at full width **cut to 4
    of its 40 layers** (46 GB of parameters, gradients and AdamW moments
    in float32), 5 steps of 4 x 1024 tokens with no checkpoint written:
    every loss finite, the first within 3 of ln(151936), no recovery, 8
    K6 launches a step (4 forward, 4 in the recomputed backward) and no
    other kernel; the first step again with ``attention_ref`` in K6's
    place (loss within 1e-5, gradient norm within 1e-4, relative); step
    seconds (the median of steps 2-5), tokens/s, peak GB and the share
    of the float32 bound (8·N·T over the weights that enter products,
    less the recompute of each layer's last product, which the checkpoint
    never runs, plus the attention's), one step profiled (the products, K6, AdamW,
    the rest); then a reduced qwen3-14b's 10 straight steps against 5 +
    resume + 5 at rtol 1e-4;
13. distribution and the account — (a) the training path's model
    (qwen3-14b at full width, **4 of its 40 layers** as there, B=4,
    S=1024, float32) through 3 steps of ``make_train_step`` in the
    fault-tolerant loop, first on plain tensors, then on DTensors over a
    (1, 1) ``("data", "model")`` mesh under NCCL with a world of 1
    (params, moments and batches distributed by ``partition``, the mesh
    context and the layer-boundary sharding set): losses and gradient
    norms within 1e-6 relative, 8 K6 launches a step, each on local
    shards, no recovery, step seconds and peak GB beside the unsharded
    run's; (b) the same step through the dry run's account on a fake (1,
    1) mesh: dot FLOPs within 2% of ``_train_flops``, peak bytes within
    10% of (a)'s ``max_memory_allocated``, the compute term at the card's
    float32 rate over (a)'s step; (c) ``run_cell`` of qwen3-14b
    ``train_4k`` and falcon-mamba-7b ``long_500k`` on the 16x16 mesh (fake,
    256 ranks): per-device peak GB against the card's, the three terms and
    the dominant one;
14. the script's seconds, the card line, the ``{"kernels": [...]}`` line, and last
    ``{"ok": true, "device": {...}}``.

Exits non-zero without a result where no CUDA device is present, and
where the port's package is missing. Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402

if __name__ != "__mp_main__":
    # a DSE worker that the sweep spawns from this script imports it
    # under that name; it runs host code only, so it starts without torch
    import torch  # noqa: E402

# the Table-1 scales of the reference benchmark, times 8
SCALES_8X = {
    "RAWloop": 16384, "WARloop": 16384, "WAWloop": 16384,
    "bnn": 512, "pagerank": 768, "fft": 2048, "matpower": 512,
    "hist+add": 8192, "tanh+spmv": 2048,
}
# the reference benchmark's 1x scales (benchmarks/paper_table1.py)
SCALES_1X = {
    "RAWloop": 2048, "WARloop": 2048, "WAWloop": 2048,
    "bnn": 64, "pagerank": 96, "fft": 256, "matpower": 64,
    "hist+add": 1024, "tanh+spmv": 256,
}
MODES = ("STA", "LSQ", "FUS1", "FUS2")
SEQ_PROGRAM, SEQ_STEPS = "hist+add", 256
# the DSE phase: the reference benchmark's evidence sweep
# (benchmarks/sweep.py's SIZINGS and build_spec) at SCALES_1X, with a
# worker a core up to 8, into a cache it starts empty; the linter's
# fixture and the JAX package's calibration record are read as data
DSE_SIZINGS = {
    "base": {},
    "narrow": {"burst_size": 4, "dram_latency": 100},
    "deep": {"burst_size": 32, "dram_latency": 400},
    "sta-ii-120": {"sta_mem_dep_ii": 120},
    "sta-ii-240": {"sta_mem_dep_ii": 240},
    "fwd-4": {"forward_latency": 4},
}
DSE_WORKERS = min(8, os.cpu_count() or 1)
DSE_CACHE = os.path.join(ROOT, "build", "dse_cache")
LINT_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "lint_all.txt")
CALIB_RECORD = os.path.join(ROOT, "BENCH_CALIB.json")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
L2_BYTES = 50 * 2**20  # H100 SXM L2 cache
INT32_LANES_PER_SM = 64  # Hopper: INT32 operations per SM per clock
BIG_M, BIG_W, BIG_S = 2**24 + 1, 2**20, 8
L2_M, L2_W, L2_S = 2**18 + 1, 2**18, 64
SYNC_STEPS = (100, 1100)
# K1's timed shapes (M, S, W): the kernel phase's, an L2-resident image,
# and launches of the main and streaming paths (their image sizes and
# run.segments): bnn's largest, RAWloop's, hist+add's longest,
# filter_pipe's at FIFO depth 1 (one block), and WARloop's and
# stream_dot's widest (wide launches on either side of four lanes a
# thread)
K1_SHAPES = {
    "kernel_phase": (BIG_M, BIG_S, BIG_W), "l2_resident": (L2_M, L2_S, L2_W),
    "bnn": (66049, 16, 8192), "RAWloop": (32769, 3, 16384),
    "hist+add": (97, 515, 64), "filter_pipe": (2050, 2049, 8),
    "WARloop": (32769, 1, 32768), "stream_dot": (4354, 1, 8192),
}
K2_K, K2_S, K2_D = 4, 65536, 65536
K2_BIG = 2**20  # fused_raw_loops' shape on the DU path: K=1, S=D=2**20
K3_S = K3_D = 2**20
K3_M = 2**24 + 1
K3_INVALID = 0.3
REPS = 20
TRIALS = 7  # K2 and K4 against their library calls: median of 7 runs
K4_N = K4_M = 2**20
K4_MAX_ROW, K4_BLOCK_R = 16, 128
K5_N, K5_BINS = 2**26, 32
K5G_N, K5G_BINS = 2**24, 2**16
K5_OUT_OF_RANGE = 0.01  # share of the data at -1, and again past the bins
F32_UNIT = 2.0**-24  # unit roundoff of float32
F64_UNIT = 2.0**-53
# the speculative programs at BENCH_SPEC.json's scales (its --scale-mult 8)
SPEC_SCALES_8X = {"spmv_ldtrip": 1024, "bfs_front": 2048, "chase_sum": 2048,
                  "strided_scan": 2048}
PREDICTORS = ("last", "stride", "context", "auto")
# simulate() cycles (event engine) of the JAX package's simulator at
# SPEC_SCALES_8X with its default SimParams: STA, then FUS2 under each
# predictor. The FUS2 cycles equal BENCH_SPEC.json's; its STA cycles
# predate the calibrated SimParams (sta_mem_dep_ii 224, dram_latency 200).
SPEC_CYCLES = {
    "spmv_ldtrip": {"STA": 1844576, "last": 460724, "stride": 460722,
                    "context": 460719, "auto": 460725},
    "bfs_front": {"STA": 467645, "last": 2488, "stride": 2488,
                  "context": 2488, "auto": 2488},
    "chase_sum": {"STA": 1376476, "last": 1339622, "stride": 1339622,
                  "context": 452082, "auto": 452300},
    "strided_scan": {"STA": 458972, "last": 446694, "stride": 3788,
                     "context": 446694, "auto": 4006},
}
FIFO_DEPTHS = (1, 2, 4)
# attention at qwen3-14b's head geometry: K6 at a prefill length, K7 over
# a cache of 8192 positions (launch/shapes.py's decode_32k, batch 128 and
# 32768 positions, cut to batch 32 and 8192)
K6_B, K6_H, K6_HK, K6_S, K6_D = 1, 40, 8, 4096, 128
K6R_BH, K6R_S = 40, 1000  # the ragged non-causal case, reference layout
K7_B, K7_H, K7_HK, K7_C, K7_D = 32, 40, 8, 8192, 128
# kernel against plain version, float32: the sums run in another order
# (tiles of 32 keys, K7's splits merged, K6's products in 3xTF32, each
# term within ~2**-21 of its float32 product) over at most a few thousand
# terms of size ~1, so the outputs (convex combinations of N(0, 1)
# values) differ by ~1e-6; 1e-4 is the reference's own bound for Pallas
# against its oracle
ATTN_ATOL = 1e-4
FP32_LANES_PER_SM = 128  # Hopper: FP32 FMA lanes per SM
TF32_FLOPS_PER_S = 495e12  # H100 SXM data sheet, dense TF32 tensor cores
# the serve path: qwen3-14b at full width and depth in float32, as
# serve.main computes max_seq
SERVE_ARCH, SERVE_B, SERVE_P, SERVE_NEW = "qwen3-14b", 4, 128, 32
SERVE_MAX_SEQ = SERVE_P + SERVE_NEW + 1
# logits of prefill against teacher-forced decode: the reference's own
# tolerance for decode against forward (tests/test_arch_smoke.py)
SERVE_ATOL, SERVE_RTOL = 2e-3, 1e-3
# the SSM path: falcon-mamba-7b at full width and depth (28.02 GB in
# float32); the MoE path: phi3.5-moe at full width, 12 of its 32 layers
# (5.20 GB a layer: 63.47 GB, where all 32 would be 167.5 GB)
SSM_ARCH = "falcon-mamba-7b"
MOE_ARCH, MOE_LAYERS = "phi3.5-moe-42b-a6.6b", 12
SFU_PER_SM = 16  # Hopper: special-function (exp2) results per SM per clock
# the hybrid path: zamba2-7b whole (27.00 GB in float32); the
# sliding-window path: gemma3-4b whole (15.52 GB); the ring check:
# gemma3-4b at full width, one local-global period of 6 layers, a prompt
# of the window + 64 tokens, so the local rings wrap (1088 steps; the
# depth is cut for their time, not the width)
HYBRID_ARCH, WINDOW_ARCH = "zamba2-7b", "gemma3-4b"
# zamba2-7b's whole-model gap, prefill against teacher-forced decode, in
# units of SERVE_ATOL + SERVE_RTOL·|logit|: its random 81-layer stack
# amplifies rounding so far that half an ulp of noise on the embeddings
# alone moves the logits 2.40 units, and the gap reads 6.17 (an H100,
# PERF.md section 6); so no float32 evaluation in another order meets 1
# unit there. The limit is 4x that floor; a fault in the wiring of
# segments, shared-KV slots or the remaining layers moves the logits by
# O(1). Each unit alone is held at 1 unit (check_hybrid_units).
HYBRID_GAP_LIMIT = 10.0
RING_LAYERS, RING_B, RING_EXTRA = 6, 2, 64
# the MLA path: minicpm3-4b whole (16.30 GB in float32); the
# encoder-decoder path: whisper-tiny whole (0.146 GB), its stub frames
# N(0, 1) * 0.02 as the reference's tests draw them
MLA_ARCH, ENC_DEC_ARCH, FRAME_SCALE = "minicpm3-4b", "whisper-tiny", 0.02
# K6 at minicpm3's MLA prefill (40 heads over 40, q and k 64 + 32 wide, v
# 64) and whisper's attention (6 heads of 64 over 1500 frames)
MLA_H, MLA_DK, MLA_DV = 40, 96, 64
WHISPER_H, WHISPER_D, WHISPER_FRAMES = 6, 64, 1500
# K6 with gemma3-4b's window at its heads, and zamba2-7b's shared
# attention heads (K6 at the serve prefill, K7 at the serve step)
K6W_B, K6W_S, K6W_H, K6W_HK, K6W_D, K6W_WINDOW = 1, 4096, 8, 4, 256, 1024
ZAMBA_H, ZAMBA_HK, ZAMBA_D = 32, 32, 112
# K8 at falcon-mamba-7b's widths, and a ragged case
K8_B, K8_S, K8_DI, K8_N = 4, 4096, 8192, 16
K8R_S, K8R_DI = 1000, 8192 - 96
# K8 against its plain version: the reference's kernel bound (rtol = atol
# = 1e-4); the exponentials (expf against torch's exp) and the state sums
# round differently, by ~1e-7 relative, and the decay keeps it from growing
SCAN_ATOL = SCAN_RTOL = 1e-4
# K10, one Mamba-1 decode step at falcon-mamba-7b's widths and the decode
# cell's batch, and a ragged width that no block size (256, 64) divides
K10_B, K10_DI, K10_N, K10_K = 512, 8192, 16, 4
K10R_B, K10R_DI = 3, 8192 - 97
K10_STEPS = 3  # steps in a row, the window and state carried
# K10 against its plain version: the projections' 8192-term sums run in
# another order than cuBLAS's and expf rounds apart from torch's exp, by
# ~1e-6 relative; the state's decay keeps that from growing over steps
MSTEP_ATOL = MSTEP_RTOL = 1e-4
# K9 at phi3.5-moe's prefill: 16 experts, top-2, d 4096, d_ff 6400
K9_E, K9_TOP_K, K9_D, K9_FF = 16, 2, 4096, 6400
K9_BLOCK_T, K9_SMALL_BT = 128, 16
# the MoE layer's dropless path (K9) against its capacity path with room
# for every assignment, float32: both sum 4096- and 6400-term products in
# different orders (errors ~1e-6 on outputs of size ~1); 1e-4 is the
# reference's own bound for its dropless FFN against a dense oracle
MOE_ATOL, MOE_RTOL = 1e-4, 1e-4
# the training path: qwen3-14b at full width cut to 4 of its 40 layers
# (0.330 B parameters a layer, 1.556 B in the embedding and the untied
# head: 2.877 B, at 16 bytes a parameter in float32 for the parameters,
# their gradients and AdamW's two moments about 46.0 GB; 6 layers would
# be 56.6 GB before the activations, all 40 about 235 GB), 4 sequences of
# 1024 tokens, 5 steps, no checkpoint written (the state is 46 GB)
TRAIN_ARCH, TRAIN_LAYERS, TRAIN_B, TRAIN_S, TRAIN_STEPS = (
    "qwen3-14b", 4, 4, 1024, 5)
# the first step with K6 against the same step with attention_ref on the
# card: the loss is one float32 mean over 4096 tokens and the norm a sum
# over 2.9 B squares; K6 differs from the plain softmax by ~1e-6 a row
# (3xTF32), so each moves by far less than these bounds
TRAIN_LOSS_RTOL, TRAIN_NORM_RTOL = 1e-5, 1e-4
# the products a traced training step launches (torch.profiler's FLOPs of
# its aten products) against _train_flops's weight term plus flash_bwd's
# block products, and those it records but never runs against the
# recompute the term leaves out: each pair counts the same shapes, so
# they differ only by a product the model misses; a recomputed last
# product a layer would move the first by 4.4% at the training shape
TRAIN_WITNESS_RTOL = 1e-3
# the distribution phase: the training path's model and batch, 3 steps of
# make_train_step on DTensors over a (1, 1) ("data", "model") mesh (NCCL,
# world 1) against the same steps on plain tensors. Every shard is the
# whole tensor, so the two compute the same products in the same order;
# the embedding's gradient sums with atomics on the card unsharded (an
# index) and in a sort sharded (F.embedding), so they may differ by
# rounding, far under this bound
DIST_STEPS, DIST_RTOL = 3, 1e-6
# the dry run's account of the same step against the card: its dot FLOPs
# against _train_flops (the plain flash loop computes every block pair, 4
# of 4 at S=1024 in the forward and its recompute, 3 of 4 in the backward,
# against the causal pairs: about 0.8% more), its peak bytes against
# torch.cuda.max_memory_allocated
DIST_FLOPS_RTOL, DIST_PEAK_RTOL = 0.02, 0.10
# one production cell of each kind the account covers on the card's
# machine: a train cell on the 16x16 mesh and a long-context decode
DIST_CELLS = (("qwen3-14b", "train_4k"), ("falcon-mamba-7b", "long_500k"))
# 10 straight steps against 5 + resume + 5 on the card: the reference's
# tolerance (tests/test_system.py); the embedding's backward sums with
# atomics on the card, so the two runs agree to rounding, not bit for bit
RESUME_RTOL = 1e-4
# K6's lse and flash_mha's gradients at the training shapes: qwen3's heads
# at the path's B=4, S=1024; gemma3's window at S=2048; minicpm3's 96/64
K6T_WINDOW_S, K6T_MLA_S = 2048, 1024
# K8's gradients at falcon-mamba-7b's width, one sequence of 512: four
# chunks of the backward, whose start states come from K8 (three
# launches), so the gradients differ from autograd of the plain scan by
# K8's rounding of the carried state and where the chunks split the sums
K8G_B, K8G_S = 1, 512
SCAN_GRAD_ATOL, SCAN_GRAD_RTOL = 1e-5, 1e-4


def _smi(query: str, fmt: str = "csv,noheader") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _card_line() -> str:
    return _smi("name,power.limit")


def _int32_ops_per_s() -> float:
    """The card's peak INT32 rate: SMs x 64 lanes x the maximum SM
    clock, both read from the card."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(_smi("clocks.max.sm", "csv,noheader,nounits"))
    return sms * INT32_LANES_PER_SM * mhz * 1e6


def _f32_flops_per_s() -> float:
    """The card's peak float32 rate outside the tensor cores: SMs x 128
    FMA lanes x 2 flops x the maximum SM clock, both read from the card
    (67 TFLOP/s on the H100 SXM's data sheet)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(_smi("clocks.max.sm", "csv,noheader,nounits"))
    return sms * FP32_LANES_PER_SM * 2 * mhz * 1e6


def _wave_bytes(writes: np.ndarray) -> int:
    """Bytes the wave steps must move: per lane its address (4), write
    flag (1), gathered word read (8) and written out (8); per write lane
    its store value read (8) and its scattered word written (8)."""
    return writes.size * (4 + 1 + 8 + 8) + int(writes.sum()) * (8 + 8)


def _wave_sector_bytes(m: int, writes: np.ndarray) -> int:
    """``_wave_bytes`` with each random gather and scatter charged a whole
    32-byte sector where the image (``m`` words) exceeds L2: the DRAM
    traffic of the same work."""
    if m * 8 <= L2_BYTES:
        return _wave_bytes(writes)
    return writes.size * (4 + 1 + 32 + 8) + int(writes.sum()) * (8 + 32)


def _sync_us(grid: int) -> float:
    """Microseconds one grid barrier of the wave kernel's wide path costs
    at ``grid`` blocks, measured apart from memory traffic: the barrier
    kernel's time at SYNC_STEPS[1] steps less its time at SYNC_STEPS[0],
    over the extra barriers (two per step)."""
    from repro_torch.kernels.wave_exec import kernel

    lo, hi = (_time_ms(lambda n=n: kernel.grid_sync(grid, n), 10)
              for n in SYNC_STEPS)
    return (hi - lo) * 1e3 / (2 * (SYNC_STEPS[1] - SYNC_STEPS[0]))


def _resident_sync_us(kernel, threads: int) -> float:
    """Microseconds one block barrier of the wave kernel's resident path
    costs in a block of ``threads`` threads, measured as ``_sync_us``
    is."""
    lo, hi = (_time_ms(lambda n=n: kernel.resident_sync(threads, n), 10)
              for n in SYNC_STEPS)
    return (hi - lo) * 1e3 / (2 * (SYNC_STEPS[1] - SYNC_STEPS[0]))


def time_wave_case(kernel, wave_loop_ref, random_tables, seed, m, s, w, *,
                   plain=True):
    """K1 (``kernel``, this tree's or another's) against ``wave_loop_ref``
    on seeded tables, bit for bit, then the whole call timed
    (``_call_times``) beside its bounds: bytes, sector-aware, and each
    with the path's barriers (two a step, each timed alone at this
    launch's blocks). Returns a result dict naming the path."""
    dev = torch.device("cuda")
    mem, addrs, writes, svals = random_tables(np.random.default_rng(seed),
                                              m, s, w)
    mem_d = torch.from_numpy(mem).to(dev)
    tabs = [torch.from_numpy(t).to(dev) for t in (addrs, writes, svals)]
    k_mem, k_vals = kernel.wave_loop(mem_d.clone(), *tabs)
    r_mem, r_vals = wave_loop_ref(mem_d.clone(), *tabs)
    torch.cuda.synchronize()
    if not (torch.equal(k_mem, r_mem) and torch.equal(k_vals, r_vals)):
        raise AssertionError(f"wave kernel != plain version at M={m} S={s} "
                             f"W={w}")
    err = max((k_mem - r_mem).abs().max().item(),
              (k_vals - r_vals).abs().max().item())
    del k_mem, k_vals, r_mem, r_vals
    out = {"M": m, "S": s, "W": w, "max_abs_err": float(err)}
    if hasattr(kernel, "launch_path"):
        path = kernel.launch_path(m, w, dev)
        out.update(path=path.kind, blocks=path.blocks, threads=path.threads,
                   lanes=path.lanes)
    else:  # a tree from before the resident path
        out.update(path="wide", blocks=kernel.launch_grid(w, dev))
    if out["path"] == "resident":
        out["sync_us"] = _resident_sync_us(kernel, out["threads"])
    else:
        out["sync_us"] = _sync_us(out["blocks"])
    scratch = mem_d.clone()
    out.update(_call_times(lambda: kernel.wave_loop(scratch, *tabs),
                           _wave_bytes(writes) / HBM_BYTES_PER_S * 1e3))
    syncs_ms = 2 * s * out["sync_us"] * 1e-3
    out["sector_bound_ms"] = (_wave_sector_bytes(m, writes)
                              / HBM_BYTES_PER_S * 1e3)
    out["bound_with_syncs_ms"] = out["bound_ms"] + syncs_ms
    out["sector_bound_with_syncs_ms"] = out["sector_bound_ms"] + syncs_ms
    out["syncs_bound_share"] = (out["sector_bound_with_syncs_ms"]
                                / out["device_ms"])
    if plain:
        out["plain_ms"] = _time_ms(lambda: wave_loop_ref(scratch, *tabs), 5)
    return out


def _time_ms(fn, reps: int, trials: int = 1) -> float:
    """Milliseconds a call takes back to back, by CUDA events around
    ``reps`` calls after a warm-up; with ``trials`` > 1 the median of that
    many such runs, which a stall of the shared host in one run does not
    move."""
    fn()  # warm-up
    torch.cuda.synchronize()
    runs = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / reps)
    return float(np.median(runs))


def check_wave_kernel(seed, m, s, w):
    """This tree's K1 through ``time_wave_case``."""
    from repro_torch.kernels.wave_exec import kernel
    from repro_torch.kernels.wave_exec.ref import random_tables, wave_loop_ref

    return time_wave_case(kernel, wave_loop_ref, random_tables, seed, m, s, w)


def _bits_equal(got: dict, want: dict) -> bool:
    return all(got[k].tobytes() == want[k].tobytes() for k in want)


def _device_ms(fn, reps: int) -> float:
    """Milliseconds of card time a call takes, launch gaps included but
    not the host's cost: the card first runs a ~2 ms elementwise pass
    while the host queues ``reps`` calls behind it, and CUDA events time
    the queued calls. Where ``_time_ms`` (which times back-to-back calls)
    exceeds this, the host bounds the call."""
    fn()
    busy = torch.empty(2**27, device="cuda")
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(4):
        busy.mul_(1.0)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _enqueue_us(fn, reps: int) -> float:
    """Host microseconds a call takes to return (launches enqueued, the
    card not waited for): where it nears a call's CUDA-event time, the
    host, not the card, bounds back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    took = time.perf_counter() - t0
    torch.cuda.synchronize()
    return took / reps * 1e6


def _call_times(fn, bound_ms) -> dict:
    """A wrapper call timed three ways (``_time_ms``, median of TRIALS
    runs of REPS; ``_device_ms``; ``_enqueue_us``) beside its bound."""
    ms = _time_ms(fn, REPS, TRIALS)
    return {"ms": ms, "device_ms": _device_ms(fn, REPS),
            "host_us": _enqueue_us(fn, REPS), "bound_ms": bound_ms,
            "bound_share": bound_ms / ms}


def k2_inputs(seed, k, s, d, *, unsorted_row):
    """``(k, s)`` src rows, non-decreasing with equal-address runs and
    negative addresses (the last row shuffled when ``unsorted_row``),
    and ``(k, d)`` dst rows, a fifth of them on src addresses and some
    outside the rows' range; int32 tensors on the card."""
    rng = np.random.default_rng(seed)
    src = np.sort(rng.integers(-2**20, 2**20, (k, s)), axis=1)
    src[:, 1::4] = src[:, 0::4]
    if unsorted_row:
        rng.shuffle(src[-1])
    dst = rng.integers(-2**20 - 64, 2**20 + 64, (k, d))
    on = rng.integers(0, s, (k, d // 5))
    dst[:, ::5][:, :on.shape[1]] = np.take_along_axis(src, on, axis=1)
    return (torch.from_numpy(src.astype(np.int32)).cuda(),
            torch.from_numpy(dst.astype(np.int32)).cuda())


def check_hazard_kernel(seed, k, s, d, *, unsorted_row, plain_reps=REPS):
    """K2 against ``hazard_frontier_batch_ref`` on both sides, bit for
    bit, each side's whole wrapper call timed (CUDA events, and the
    host's enqueue time) beside the plain version (``plain_reps`` 0: not
    timed) and, on monotonic rows, ``torch.searchsorted``, which must
    agree. The bytes bound is the function's; with an unsorted row the
    compare bound of counting that row is given too."""
    from repro_torch.kernels.du_hazard import kernel
    from repro_torch.kernels.du_hazard.ref import hazard_frontier_batch_ref

    src, dst = k2_inputs(seed, k, s, d, unsorted_row=unsorted_row)
    # the function: each row's src and dst read once, frontiers out
    bound_ms = (s + 2 * d) * 4 * k / HBM_BYTES_PER_S * 1e3
    out = {"K": k, "S": s, "D": d, "unsorted_row": unsorted_row,
           "bound_ms": bound_ms}
    if unsorted_row:
        # the counting path: a compare and an add per (src, dst) pair
        out["unsorted_compare_bound_ms"] = (
            2 * s * d / _int32_ops_per_s() * 1e3
        )
    for side in ("right", "left"):
        got = kernel.hazard_frontier_batch(src, dst, side=side)
        want = hazard_frontier_batch_ref(src, dst, side=side)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"hazard kernel != plain version ({side}, "
                                 f"K={k} S={s}, unsorted_row="
                                 f"{unsorted_row})")
        err = float((got - want).abs().max().item())
        del want
        run = lambda: kernel.hazard_frontier_batch(src, dst, side=side)
        row = {"max_abs_err": err, **_call_times(run, bound_ms)}
        if plain_reps:
            row["plain_ms"] = _time_ms(
                lambda: hazard_frontier_batch_ref(src, dst, side=side),
                plain_reps)
        if not unsorted_row:
            right = side == "right"
            lib = torch.searchsorted(src, dst, right=right, out_int32=True)
            if not torch.equal(lib, got):
                raise AssertionError(f"searchsorted != kernel ({side})")
            lib_run = lambda: torch.searchsorted(src, dst, right=right,
                                                 out_int32=True)
            row["library_ms"] = _time_ms(lib_run, REPS, TRIALS)
            row["library_device_ms"] = _device_ms(lib_run, REPS)
        out[side] = row
    return out


def k3_inputs(seed):
    """A guarded producer stream and its consumers, as numpy arrays:
    ``S`` non-decreasing producer addresses with equal-address runs over
    ``[0, M)``, float64 values, valid bits (about ``K3_INVALID`` of them
    0), ``D`` consumer addresses in ``[0, M)``, half of them on producer
    addresses, and a float64 memory of ``M`` words."""
    rng = np.random.default_rng(seed)
    src = np.sort(rng.integers(0, K3_M, K3_S))
    src[1::3] = src[0::3][:len(src[1::3])]
    valid = (rng.random(K3_S) >= K3_INVALID).astype(np.int32)
    val = rng.standard_normal(K3_S)
    dst = rng.integers(0, K3_M, K3_D)
    on = rng.random(K3_D) < 0.5
    dst[on] = src[rng.integers(0, K3_S, int(on.sum()))]
    memory = rng.standard_normal(K3_M)
    return (src.astype(np.int32), val, valid, dst.astype(np.int32), memory)


def _forward_bytes(s, d, m, lb, hits, word):
    """K3's bytes bound and its sector-aware bound. Bytes: per consumer
    its frontier and address (4 + 4), value and hit out (word + 1); each
    producer's address, valid bit and value (4 + 4 + word) at most once;
    per miss the memory word (word). Sector-aware: where an array that
    is read at random exceeds L2, each random read of it costs a 32-byte
    sector: the memory gather of a miss, and (for producers past L2) the
    window's address, valid bit and the forwarded value."""
    consumers = d * (4 + 4 + word + 1)
    producers = min(s, d * lb) * (4 + 4 + word)
    misses = d - hits
    nbytes = consumers + producers + misses * word
    sectors = consumers + (misses * (32 if m * word > L2_BYTES else word))
    if s * (4 + 4 + word) > L2_BYTES:
        sectors += d * lb * (32 + 32) + hits * 32
    else:
        sectors += producers
    return (nbytes / HBM_BYTES_PER_S * 1e3, sectors / HBM_BYTES_PER_S * 1e3)


def time_forward_case(kernel, fused_stream_ref, min_lookback, *,
                      plain=True):
    """K3 (``kernel``, this tree's or another's) against
    ``fused_stream_ref`` on the card at S=D=2**20 over a float64 memory of
    2**24 + 1 words, bit for bit on the float64 words, the whole call
    timed (``_call_times``) beside both bounds."""
    src, val, valid, dst, memory = (torch.from_numpy(x).cuda()
                                    for x in k3_inputs(6))
    frontier = torch.searchsorted(src, dst, right=True, out_int32=True)
    lb = min_lookback(src)
    args = (src, val, frontier, dst, memory, valid)
    got_v, got_h = kernel.fused_stream(*args, lookback=lb)
    want_v, want_h = fused_stream_ref(*args, lookback=lb)
    torch.cuda.synchronize()
    if not (torch.equal(got_v.view(torch.int64), want_v.view(torch.int64))
            and torch.equal(got_h, want_h)):
        raise AssertionError("forwarding kernel != plain version")
    hits = int(got_h.sum().item())
    if not 0 < hits < K3_D:
        raise AssertionError(f"degenerate forwarding case: {hits} hits")
    bound_ms, sector_ms = _forward_bytes(K3_S, K3_D, K3_M, lb, hits, 8)
    out = {
        "S": K3_S, "D": K3_D, "M": K3_M, "dtype": "float64",
        "lookback": lb, "hits": hits,
        "invalid": int((valid == 0).sum().item()),
        "max_abs_err": float((got_v - want_v).abs().max().item()),
        "sector_bound_ms": sector_ms,
        **_call_times(lambda: kernel.fused_stream(*args, lookback=lb),
                      bound_ms),
    }
    out["sector_bound_share"] = sector_ms / out["device_ms"]
    if plain:
        out["plain_ms"] = _time_ms(
            lambda: fused_stream_ref(*args, lookback=lb), REPS)
    return out


def check_forward_kernel():
    """This tree's K3 through ``time_forward_case``."""
    from repro_torch.kernels.fused_stream import kernel
    from repro_torch.kernels.fused_stream.ops import min_lookback
    from repro_torch.kernels.fused_stream.ref import fused_stream_ref

    return time_forward_case(kernel, fused_stream_ref, min_lookback)


def k4_inputs(seed):
    """A seeded CSR matrix of ``K4_N`` rows over ``K4_M`` columns: row
    lengths uniform in 1..K4_MAX_ROW, the p-th entry of a row in the
    p-th of K4_MAX_ROW equal strata of the columns (so columns are sorted
    and distinct within a row), float32 values, and a float32 ``x``."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, K4_MAX_ROW + 1, K4_N)
    rp = np.concatenate([[0], np.cumsum(lens)])
    nnz = int(rp[-1])
    pos = np.arange(nnz) - np.repeat(rp[:-1], lens)
    stratum = K4_M // K4_MAX_ROW
    cols = pos * stratum + rng.integers(0, stratum, nnz)
    vals = rng.standard_normal(nnz).astype(np.float32)
    x = rng.standard_normal(K4_M).astype(np.float32)
    return rp, cols, vals, x


def _csr_abs_matvec(rp, cols, vals, x):
    """``|A| @ |x|`` in float64 on the host, for error bounds."""
    row = np.repeat(np.arange(len(rp) - 1), np.diff(rp))
    return np.bincount(row, weights=np.abs(vals) * np.abs(x[cols]),
                       minlength=len(rp) - 1)


def _gamma(n, unit):
    """The rounding-error factor n·u / (1 - n·u) of n roundings."""
    return n * unit / (1 - n * unit)


def matpower_csr():
    """matpower's matrix at 8x (the substrate path's shape): CSR arrays,
    float64 values, and its float64 ``x``."""
    from repro_torch.core import programs

    _, arrays, _ = programs.get("matpower").make(SCALES_8X["matpower"])
    rp = np.asarray(arrays["rp"], dtype=np.int64)
    return (rp, np.asarray(arrays["cidx"], dtype=np.int64),
            np.asarray(arrays["val"], dtype=np.float64),
            np.asarray(arrays["x"], dtype=np.float64))


def check_spmv_kernel(rp, ci, vv, x, block_r):
    """K4 against ``csr_spmv_ref`` on the card, bit for bit, and one
    cuSPARSE product (``torch.mv`` on a sparse CSR tensor of ``vv``'s and
    ``x``'s dtype) within twice the float32 matvec bound γ_{W+3}·|A||x|
    (W products and sums, the rounding of vals and x): each sum order is
    within the bound of the exact product, so two orders are within twice
    it. The whole wrapper call (CUDA events, and the host's enqueue time),
    the plain version and cuSPARSE timed."""
    from repro_torch.kernels.csr_spmv import kernel
    from repro_torch.kernels.csr_spmv.ref import csr_spmv_ref, csr_to_ell

    n, m = len(rp) - 1, len(x)
    cols, vals = csr_to_ell(rp, ci, vv, n, block_r)
    c, v, xd = (torch.from_numpy(a).cuda() for a in (cols, vals, x))
    got = kernel.csr_spmv(c, v, xd, block_r=block_r)
    want = csr_spmv_ref(c, v, xd)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"csr_spmv kernel != plain version at N={n}")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        lib_a = torch.sparse_csr_tensor(
            torch.from_numpy(rp).cuda(), torch.from_numpy(ci).cuda(),
            torch.from_numpy(vv).cuda(), size=(n, m),
            check_invariants=False,
        )
        lib = torch.mv(lib_a, xd)
    w = cols.shape[1]
    slack = 2 * _gamma(w + 3, F32_UNIT) * _csr_abs_matvec(rp, ci, vv, x)
    lib_err = (lib - got[:n]).abs().double().cpu().numpy()
    if not (lib_err <= slack).all():
        raise AssertionError("cuSPARSE and the K4 kernel differ by more "
                             "than the float32 matvec bound")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        library_ms = _time_ms(lambda: torch.mv(lib_a, xd), REPS, TRIALS)
        library_device_ms = _device_ms(lambda: torch.mv(lib_a, xd), REPS)
    run = lambda: kernel.csr_spmv(c, v, xd, block_r=block_r)
    # the ELL arrays read once, y written once, x read once (it stays in
    # L2 for the gathers)
    bound_ms = (cols.size * 8 + (c.shape[0] + m) * x.itemsize
                ) / HBM_BYTES_PER_S * 1e3
    return {
        "N": n, "N_pad": c.shape[0], "M": m, "W": w, "nnz": int(rp[-1]),
        "x_dtype": str(x.dtype), "vector_loads": kernel.vector_loads(c, v, xd),
        "max_abs_err": float((got - want).abs().max().item()),
        "library_max_abs_err": float(lib_err.max()),
        "library_max_err_over_bound": float((lib_err / slack).max()),
        **_call_times(run, bound_ms),
        "plain_ms": _time_ms(lambda: csr_spmv_ref(c, v, xd), REPS),
        "library_ms": library_ms, "library_device_ms": library_device_ms,
    }


def k5_inputs(seed, n, bins):
    """``n`` int32 bin indices made on the card from ``seed``: uniform in
    ``[0, bins)``, then about ``K5_OUT_OF_RANGE`` of them set to -1 and as
    many to bins at or past ``bins``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    d = torch.randint(0, bins, (n,), generator=g, device="cuda",
                      dtype=torch.int32)
    u = torch.rand(n, generator=g, device="cuda")
    d[u < K5_OUT_OF_RANGE] = -1
    far = (u >= K5_OUT_OF_RANGE) & (u < 2 * K5_OUT_OF_RANGE)
    d[far] = bins + d[far] % 7
    return d


def check_histogram_kernel(seed, n, bins):
    """K5 against ``histogram_ref`` on the card, bit for bit, and
    ``torch.bincount`` of the in-range data, which must equal it after the
    cast; all three timed beside the bytes bound."""
    from repro_torch.kernels.histogram import kernel
    from repro_torch.kernels.histogram.ref import histogram_ref

    d = k5_inputs(seed, n, bins)
    got = kernel.histogram(d, n_bins=bins)
    want = histogram_ref(d, n_bins=bins)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"histogram kernel != plain version at N={n}, "
                             f"{bins} bins")
    inside = d[(d >= 0) & (d < bins)]
    if not torch.equal(torch.bincount(inside, minlength=bins).float(), got):
        raise AssertionError("torch.bincount != histogram kernel")
    dropped = n - inside.numel()
    if not 0 < dropped < n:
        raise AssertionError(f"degenerate histogram case: {dropped} dropped")
    return {
        "N": n, "n_bins": bins, "dropped": dropped,
        "path": "shared" if bins <= kernel.MAX_SHARED_BINS else "global",
        "max_abs_err": float((got - want).abs().max().item()),
        "ms": _time_ms(lambda: kernel.histogram(d, n_bins=bins), REPS),
        "plain_ms": _time_ms(lambda: histogram_ref(d, n_bins=bins), REPS),
        "library_ms": _time_ms(
            lambda: torch.bincount(inside, minlength=bins), REPS),
        # the data read once, the histogram written once
        "bound_ms": (n * 4 + bins * 4) / HBM_BYTES_PER_S * 1e3,
    }


def _randn(g, *shape):
    return torch.randn(shape, generator=g, device="cuda")


def _within(got, want, what, atol=ATTN_ATOL) -> float:
    err = float((got.float() - want.float()).abs().max().item())
    if not err <= atol:
        raise AssertionError(f"{what}: max abs err {err} above {atol}")
    return err


def _flash_bounds(b, s, h, hk, d, window=0, *, s_kv=None, dv=None,
                  causal=True) -> dict:
    """K6's bounds: the operations at the accuracy kept (3xTF32: three
    TF32 products a multiply-add, at 495 TFLOP/s), beside the float32
    CUDA cores' (the earlier design's) and the bytes (q, k, v read once, o
    written once). Each (query, key) pair takes 2 d flops in Q.K and 2 dv
    in P.V (dv, V's head dim, defaults to d). Causal (S_kv = S): i + 1
    keys for query row i, min(i + 1, window) with a window; non-causal:
    all S_kv keys."""
    s_kv = s if s_kv is None else s_kv
    dv = d if dv is None else dv
    w = window or s
    if not causal:
        pairs = s * s_kv
    elif s <= w:  # causal (query, key) pairs
        pairs = s * (s + 1) // 2
    else:
        pairs = w * (w + 1) // 2 + (s - w) * w
    flops = 2 * b * h * (d + dv) * pairs
    nbytes = 4 * (b * s * h * (d + dv) + b * s_kv * hk * (d + dv))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"gflop": flops / 1e9, "bytes_ms": bytes_ms,
            "bound_ms": max(3 * flops / TF32_FLOPS_PER_S * 1e3, bytes_ms),
            "f32_cuda_core_bound_ms": max(flops / _f32_flops_per_s() * 1e3,
                                          bytes_ms)}


def check_flash_kernel():
    """K6 against its plain versions on the card: at qwen3-14b's heads
    (H=40 over Hk=8, D=128) causal in the model's layout, against
    ``flash_mha``'s blocked loop, at S=4096 and at the serve path's
    prefill (B=SERVE_B, S=SERVE_P); a ragged non-causal case
    (S=S_kv=1000, no tile divides it) in the reference's layout, against
    the full-score oracle. Within ``ATTN_ATOL`` each. At both causal
    shapes the whole call (``_call_times``), beside
    ``scaled_dot_product_attention`` (a yardstick the port never calls)
    and the operations bound of 3xTF32."""
    import torch.nn.functional as F
    from repro_torch.kernels.attention import kernel
    from repro_torch.kernels.attention.ref import (flash_attention_ref,
                                                   flash_gqa_ref)

    g = torch.Generator(device="cuda").manual_seed(11)
    q = _randn(g, K6_B, K6_S, K6_H, K6_D)
    k, v = (_randn(g, K6_B, K6_S, K6_HK, K6_D) for _ in "kv")
    got = kernel.flash_attention_gqa(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = _within(got, flash_gqa_ref(q, k, v, causal=True), "K6 causal")
    qs = _randn(g, SERVE_B, SERVE_P, K6_H, K6_D)
    ks, vs = (_randn(g, SERVE_B, SERVE_P, K6_HK, K6_D) for _ in "kv")
    got_s = kernel.flash_attention_gqa(qs, ks, vs, causal=True)
    torch.cuda.synchronize()
    err_s = _within(got_s, flash_gqa_ref(qs, ks, vs, causal=True),
                    "K6 causal at the serve path's prefill shape")
    qr, kr, vr = (_randn(g, K6R_BH, K6R_S, K6_D) for _ in "qkv")
    scale = K6_D ** -0.5
    got_r = kernel.flash_attention(qr, kr, vr, causal=False, sm_scale=scale)
    torch.cuda.synchronize()
    err_r = _within(got_r, flash_attention_ref(qr, kr, vr, causal=False,
                                               sm_scale=scale),
                    "K6 ragged non-causal")

    def sdpa(q, k, v):
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)

    lib, lib_s = sdpa(q, k, v), sdpa(qs, ks, vs)
    lib_err = float((lib().transpose(1, 2) - got).abs().max().item())
    bounds = _flash_bounds(K6_B, K6_S, K6_H, K6_HK, K6_D)
    bounds_s = _flash_bounds(SERVE_B, SERVE_P, K6_H, K6_HK, K6_D)
    serve = {"B": SERVE_B, "S": SERVE_P, "max_abs_err": err_s, **bounds_s,
             **_call_times(lambda: kernel.flash_attention_gqa(qs, ks, vs),
                           bounds_s["bound_ms"]),
             "library_ms": _time_ms(lib_s, REPS, TRIALS),
             "library_device_ms": _device_ms(lib_s, REPS)}
    return {
        "B": K6_B, "H": K6_H, "Hk": K6_HK, "S": K6_S, "D": K6_D,
        "causal": True, "dtype": "float32", "products": "3xTF32",
        "max_abs_err": max(err, err_s, err_r), "causal_max_abs_err": err,
        "serve_shape": serve,
        "ragged_noncausal": {"BH": K6R_BH, "S": K6R_S, "S_kv": K6R_S,
                             "D": K6_D, "max_abs_err": err_r},
        "library_max_abs_err": lib_err, **bounds,
        **_call_times(lambda: kernel.flash_attention_gqa(q, k, v),
                      bounds["bound_ms"]),
        "plain_ms": _time_ms(lambda: flash_gqa_ref(q, k, v), 3),
        "library_ms": _time_ms(lib, REPS),
        "library_device_ms": _device_ms(lib, REPS),
    }


def check_flash_window():
    """K6 with gemma3-4b's sliding window at its heads (8 over 4, D=256),
    B=1, S=4096, window 1024, against ``flash_attention_gqa``'s plain
    version within ``ATTN_ATOL``; the whole call (``_call_times``) beside
    its bound over the keys inside the window, causal K6 at the same
    shape, and ``scaled_dot_product_attention`` with a boolean window
    mask (a yardstick the port never calls)."""
    import torch.nn.functional as F
    from repro_torch.kernels.attention import kernel
    from repro_torch.kernels.attention.ref import flash_gqa_ref

    b, s, h, hk, d, w = K6W_B, K6W_S, K6W_H, K6W_HK, K6W_D, K6W_WINDOW
    g = torch.Generator(device="cuda").manual_seed(13)
    q = _randn(g, b, s, h, d)
    k, v = (_randn(g, b, s, hk, d) for _ in "kv")
    run = lambda: kernel.flash_attention_gqa(q, k, v, window=w)  # noqa: E731
    got = run()
    torch.cuda.synchronize()
    err = _within(got, flash_gqa_ref(q, k, v, causal=True, window=w),
                  "K6 with gemma3's window")
    i = torch.arange(s, device="cuda")
    mask = (i[:, None] >= i[None, :]) & (i[None, :] > i[:, None] - w)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask, enable_gqa=True)
    lib_err = float((lib().transpose(1, 2) - got).abs().max().item())
    bounds = _flash_bounds(b, s, h, hk, d, window=w)
    causal = _flash_bounds(b, s, h, hk, d)
    return {
        "B": b, "S": s, "H": h, "Hk": hk, "D": d, "window": w,
        "max_abs_err": err, "library_max_abs_err": lib_err, **bounds,
        **_call_times(run, bounds["bound_ms"]),
        "causal_ms": _time_ms(lambda: kernel.flash_attention_gqa(q, k, v),
                              REPS, TRIALS),
        "causal_bound_ms": causal["bound_ms"],
        "plain_ms": _time_ms(lambda: flash_gqa_ref(q, k, v, window=w), 3),
        "library_ms": _time_ms(lib, REPS, TRIALS),
        "library_device_ms": _device_ms(lib, REPS),
    }


def check_zamba2_attention():
    """K6 and K7 at zamba2-7b's shared attention (32 query heads over 32
    kv heads of D=112) at the serve path's shapes: K6 causal at B=4,
    S=128, K7 at B=4 over 161 positions at every frontier 1-160, each
    within ``ATTN_ATOL`` of its plain version; each whole call
    (``_call_times``, K7 at frontier 160) beside its bound, its plain
    version and ``scaled_dot_product_attention``."""
    import torch.nn.functional as F
    from repro_torch.kernels.attention import kernel
    from repro_torch.kernels.attention.ref import decode_gqa_ref, flash_gqa_ref

    b, h, hk, d = SERVE_B, ZAMBA_H, ZAMBA_HK, ZAMBA_D
    scale = d ** -0.5
    g = torch.Generator(device="cuda").manual_seed(14)
    q = _randn(g, b, SERVE_P, h, d)
    k, v = (_randn(g, b, SERVE_P, hk, d) for _ in "kv")
    got = kernel.flash_attention_gqa(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = _within(got, flash_gqa_ref(q, k, v, causal=True),
                  "K6 at zamba2's serve prefill")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True)
    bounds = _flash_bounds(b, SERVE_P, h, hk, d)
    flash = {"B": b, "S": SERVE_P, "H": h, "Hk": hk, "D": d,
             "max_abs_err": err, **bounds,
             **_call_times(lambda: kernel.flash_attention_gqa(q, k, v),
                           bounds["bound_ms"]),
             "plain_ms": _time_ms(lambda: flash_gqa_ref(q, k, v), 5),
             "library_ms": _time_ms(lib, REPS, TRIALS),
             "library_device_ms": _device_ms(lib, REPS)}

    qd = _randn(g, b, h, d)
    kc, vc = (_randn(g, b, SERVE_MAX_SEQ, hk, d) for _ in "kv")
    last = SERVE_P + SERVE_NEW
    err_d = 0.0
    for t in range(1, last + 1):
        lens = torch.full((b,), t, dtype=torch.int32, device="cuda")
        got_d = kernel.decode_attention_gqa(qd, kc, vc, lens, sm_scale=scale)
        err_d = max(err_d, _within(
            got_d, decode_gqa_ref(qd, kc, vc, lens, sm_scale=scale),
            f"K7 at zamba2's serve step, frontier {t}"))
    mask = (torch.arange(SERVE_MAX_SEQ, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    lib_d = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qd[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2),
        attn_mask=mask, scale=scale)
    bound_d = _decode_bound_bytes_ms(b, h, hk, d, b * last)
    decode = {"B": b, "C": SERVE_MAX_SEQ, "H": h, "Hk": hk, "D": d,
              "frontiers": [1, last], "timed_frontier": last,
              "max_abs_err": err_d,
              **_call_times(lambda: kernel.decode_attention_gqa(
                  qd, kc, vc, lens, sm_scale=scale), bound_d),
              "plain_ms": _time_ms(lambda: decode_gqa_ref(
                  qd, kc, vc, lens, sm_scale=scale), 5),
              "library_ms": _time_ms(lib_d, REPS, TRIALS),
              "library_device_ms": _device_ms(lib_d, REPS)}
    return {"flash": flash, "decode": decode}


def check_gemma3_attention():
    """K6 and K7 at gemma3-4b's heads (8 over 4, D=256) at the shapes its
    paths give them, each within ``ATTN_ATOL`` of its plain version: K6
    with the window of 1024 at the serve prefill (B=4, S=128, where it
    does not bind) and at the ring check's (B=2, S=1088, where it binds);
    K7 at the serve step (B=4 over 161 positions) at every frontier
    1-160; K7 over a ring of 1024 slots at the ring check's B=2, position
    t written at slot t % 1024 and attended over min(t + 1, 1024) slots
    as ``_decode_gqa`` does, at every length 1-1088, against the plain
    version on the same ring and on the window's positions in order (the
    ring's slot order must not matter)."""
    from repro_torch.kernels.attention import kernel
    from repro_torch.kernels.attention.ref import decode_gqa_ref, flash_gqa_ref

    h, hk, d, w = K6W_H, K6W_HK, K6W_D, K6W_WINDOW
    scale = d ** -0.5
    n = w + RING_EXTRA
    g = torch.Generator(device="cuda").manual_seed(15)
    flash = {}
    for b, s in ((SERVE_B, SERVE_P), (RING_B, n)):
        q = _randn(g, b, s, h, d)
        k, v = (_randn(g, b, s, hk, d) for _ in "kv")
        got = kernel.flash_attention_gqa(q, k, v, window=w)
        torch.cuda.synchronize()
        flash[f"B={b}, S={s}"] = _within(
            got, flash_gqa_ref(q, k, v, causal=True, window=w),
            f"K6 at gemma3's heads, B={b}, S={s}, window {w}")

    def decode(q, kc, vc, m, what, *plain):
        lens = torch.full((q.shape[0],), m, dtype=torch.int32, device="cuda")
        got = kernel.decode_attention_gqa(q, kc, vc, lens, sm_scale=scale)
        return max(_within(got, decode_gqa_ref(q, kc_, vc_, lens,
                                               sm_scale=scale), what)
                   for kc_, vc_ in plain or ((kc, vc),))

    qd = _randn(g, SERVE_B, h, d)
    kc, vc = (_randn(g, SERVE_B, SERVE_MAX_SEQ, hk, d) for _ in "kv")
    last = SERVE_P + SERVE_NEW
    err_d = max(decode(qd, kc, vc, t, f"K7 at gemma3's serve step, "
                                      f"frontier {t}")
                for t in range(1, last + 1))
    qr = _randn(g, RING_B, n, h, d)
    kp, vp = (_randn(g, RING_B, n, hk, d) for _ in "kv")
    kr, vr = (torch.zeros(RING_B, w, hk, d, device="cuda") for _ in "kv")
    err_ring = 0.0
    for t in range(n):
        kr[:, t % w], vr[:, t % w] = kp[:, t], vp[:, t]
        m = min(t + 1, w)
        err_ring = max(err_ring, decode(
            qr[:, t], kr, vr, m, f"K7 over gemma3's ring, length {t + 1}",
            (kr, vr), (kp[:, t + 1 - m:t + 1], vp[:, t + 1 - m:t + 1])))
    return {
        "flash": {"H": h, "Hk": hk, "D": d, "window": w,
                  "max_abs_err_by_shape": flash,
                  "max_abs_err": max(flash.values())},
        "decode": {"H": h, "Hk": hk, "D": d,
                   "serve_shape": {"B": SERVE_B, "C": SERVE_MAX_SEQ,
                                   "frontiers": [1, last],
                                   "max_abs_err": err_d},
                   "ring": {"B": RING_B, "slots": w, "lengths": [1, n],
                            "wrapped_lengths": n - w,
                            "max_abs_err": err_ring},
                   "max_abs_err": max(err_d, err_ring)},
    }


def check_mla_whisper_attention():
    """K6 at the shapes minicpm3-4b's and whisper-tiny's paths give it,
    each within ``ATTN_ATOL`` of its plain version and each whole call
    (``_call_times``) beside its bound, its plain version and
    ``scaled_dot_product_attention`` (a yardstick the port never calls;
    it takes V's own head dim): minicpm3's MLA
    prefill (40 heads over 40, q and k 96 wide, v 64, causal) at the serve
    prefill (B=4, S=128) and at B=1, S=4096; whisper's encoder (B=4,
    S=1500, 6 heads of 64, non-causal) and its prefill's cross attention
    (B=4, S=128 over 1500 frames, non-causal)."""
    import torch.nn.functional as F
    from repro_torch.kernels.attention import kernel
    from repro_torch.kernels.attention.ref import flash_gqa_ref

    cases = [
        ("minicpm3 serve prefill", SERVE_B, SERVE_P, SERVE_P, MLA_H, MLA_DK,
         MLA_DV, True),
        ("minicpm3 prefill at S=4096", K6_B, K6_S, K6_S, MLA_H, MLA_DK,
         MLA_DV, True),
        ("whisper encoder", SERVE_B, WHISPER_FRAMES, WHISPER_FRAMES,
         WHISPER_H, WHISPER_D, WHISPER_D, False),
        ("whisper cross attention at the prefill", SERVE_B, SERVE_P,
         WHISPER_FRAMES, WHISPER_H, WHISPER_D, WHISPER_D, False),
    ]
    g = torch.Generator(device="cuda").manual_seed(17)
    out = {}
    for name, b, s, s_kv, h, dk, dv, causal in cases:
        q = _randn(g, b, s, h, dk)
        k, v = _randn(g, b, s_kv, h, dk), _randn(g, b, s_kv, h, dv)
        run = lambda: kernel.flash_attention_gqa(  # noqa: E731
            q, k, v, causal=causal)
        got = run()
        torch.cuda.synchronize()
        err = _within(got, flash_gqa_ref(q, k, v, causal=causal),
                      f"K6 at {name}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=causal)
        bounds = _flash_bounds(b, s, h, h, dk, s_kv=s_kv, dv=dv,
                               causal=causal)
        out[name] = {
            "B": b, "S": s, "S_kv": s_kv, "H": h, "Hk": h, "Dk": dk, "Dv": dv,
            "causal": causal, "max_abs_err": err,
            "library_max_abs_err": float(
                (lib().transpose(1, 2) - got).abs().max().item()),
            **bounds, **_call_times(run, bounds["bound_ms"]),
            "plain_ms": _time_ms(lambda: flash_gqa_ref(q, k, v,
                                                       causal=causal), 3),
            "library_ms": _time_ms(lib, REPS, TRIALS),
            "library_device_ms": _device_ms(lib, REPS)}
    return out


def check_whisper_decode_attention():
    """K6 and K7 at the shapes whisper-tiny's decode steps give them (6
    heads over 6, D=64), each within ``ATTN_ATOL`` of its plain version:
    K6 with one query over the 1500 encoder frames, non-causal (a
    teacher-forced step's cross attention, ``_cross_decode``) and with one
    query over one key, causal (a ``serve_batch`` step's cross attention,
    which is given no encoder output); K7 at the serve step (B=4 over 161
    positions) at every frontier 1-160. Each K6 call is timed beside its
    bound, its plain version and ``scaled_dot_product_attention`` (a
    yardstick the port never calls)."""
    import torch.nn.functional as F
    from repro_torch.kernels.attention import kernel
    from repro_torch.kernels.attention.ref import decode_gqa_ref, flash_gqa_ref

    h, d, b = WHISPER_H, WHISPER_D, SERVE_B
    scale = d ** -0.5
    g = torch.Generator(device="cuda").manual_seed(19)
    flash = {}
    for name, s_kv, causal in (
            ("cross attention at a teacher-forced step", WHISPER_FRAMES,
             False),
            ("cross attention at a serve_batch step", 1, True)):
        q = _randn(g, b, 1, h, d)
        k, v = (_randn(g, b, s_kv, h, d) for _ in "kv")
        run = lambda: kernel.flash_attention_gqa(  # noqa: E731
            q, k, v, causal=causal)
        got = run()
        torch.cuda.synchronize()
        err = _within(got, flash_gqa_ref(q, k, v, causal=causal),
                      f"K6 at whisper's {name}")
        bounds = _flash_bounds(b, 1, h, h, d, s_kv=s_kv, causal=causal)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=causal)
        flash[name] = {"B": b, "S": 1, "S_kv": s_kv, "H": h, "Hk": h,
                       "D": d, "causal": causal, "max_abs_err": err,
                       **bounds, **_call_times(run, bounds["bound_ms"]),
                       "plain_ms": _time_ms(lambda: flash_gqa_ref(
                           q, k, v, causal=causal), 3),
                       "library_ms": _time_ms(lib, REPS, TRIALS),
                       "library_device_ms": _device_ms(lib, REPS)}

    qd = _randn(g, b, h, d)
    kc, vc = (_randn(g, b, SERVE_MAX_SEQ, h, d) for _ in "kv")
    last = SERVE_P + SERVE_NEW
    err_d = 0.0
    for t in range(1, last + 1):
        lens = torch.full((b,), t, dtype=torch.int32, device="cuda")
        got_d = kernel.decode_attention_gqa(qd, kc, vc, lens, sm_scale=scale)
        err_d = max(err_d, _within(
            got_d, decode_gqa_ref(qd, kc, vc, lens, sm_scale=scale),
            f"K7 at whisper's serve step, frontier {t}"))
    return {
        "flash": {"by_shape": flash,
                  "max_abs_err": max(c["max_abs_err"]
                                     for c in flash.values())},
        "decode": {"B": b, "C": SERVE_MAX_SEQ, "H": h, "Hk": h, "D": d,
                   "frontiers": [1, last], "max_abs_err": err_d},
    }


def _decode_bound_bytes_ms(b, h, hk, d, committed) -> float:
    """K7's bytes bound: the committed K and V rows read once, q read and
    the output written once (float32)."""
    return 4 * (committed * hk * d * 2 + 2 * b * h * d) / HBM_BYTES_PER_S * 1e3


def check_decode_kernel():
    """K7 against its plain version on the card at qwen3-14b's heads over
    a cache of C=8192 positions, batch 32, frontiers seeded in [1, C]
    with 1 and C among them; then one row with nothing committed
    (lengths 0: the uniform average of the whole cache); then at the
    serve path's shape (B=SERVE_B over SERVE_MAX_SEQ positions, which no
    tile divides) at every frontier the path reaches, 1 to
    SERVE_P + SERVE_NEW. Within ``ATTN_ATOL``; two calls the same bits.
    At C=8192 and at the serve shape's last frontier the whole call
    (``_call_times``), beside ``scaled_dot_product_attention`` with a
    boolean frontier mask and the bytes bound of the committed rows."""
    import torch.nn.functional as F
    from repro_torch.kernels.attention import kernel
    from repro_torch.kernels.attention.ref import decode_gqa_ref

    g = torch.Generator(device="cuda").manual_seed(12)
    q = _randn(g, K7_B, K7_H, K7_D)
    kc, vc = (_randn(g, K7_B, K7_C, K7_HK, K7_D) for _ in "kv")
    lengths = torch.randint(1, K7_C + 1, (K7_B,), generator=g, device="cuda",
                            dtype=torch.int32)
    lengths[0], lengths[1] = 1, K7_C
    scale = K7_D ** -0.5
    run = lambda lens: kernel.decode_attention_gqa(  # noqa: E731
        q, kc, vc, lens, sm_scale=scale)
    got = run(lengths)
    torch.cuda.synchronize()
    err = _within(got, decode_gqa_ref(q, kc, vc, lengths, sm_scale=scale),
                  "K7")
    if not torch.equal(got, run(lengths)):
        raise AssertionError("K7: two calls on the same inputs differ")
    empty = lengths.clone()
    empty[2] = 0
    got_0 = run(empty)
    torch.cuda.synchronize()
    err_0 = _within(got_0, decode_gqa_ref(q, kc, vc, empty, sm_scale=scale),
                    "K7 with a row at lengths 0")
    rep = K7_H // K7_HK
    uniform = vc[2].mean(dim=0).repeat_interleave(rep, dim=0)
    _within(got_0[2], uniform, "K7 lengths 0 against the cache's mean")
    qs = _randn(g, SERVE_B, K7_H, K7_D)
    ks, vs = (_randn(g, SERVE_B, SERVE_MAX_SEQ, K7_HK, K7_D) for _ in "kv")
    err_s = 0.0
    last = SERVE_P + SERVE_NEW
    for t in range(1, last + 1):
        lens = torch.full((SERVE_B,), t, dtype=torch.int32, device="cuda")
        got_s = kernel.decode_attention_gqa(qs, ks, vs, lens, sm_scale=scale)
        err_s = max(err_s, _within(
            got_s, decode_gqa_ref(qs, ks, vs, lens, sm_scale=scale),
            f"K7 at the serve path's shape, frontier {t}"))

    def sdpa(q, kc, vc, lens):
        mask = (torch.arange(kc.shape[1], device="cuda")[None, :]
                < lens[:, None])[:, None, None, :]
        qt, kt, vt = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=scale, enable_gqa=True)

    lib = sdpa(q, kc, vc, lengths)
    lib_s = sdpa(qs, ks, vs, lens)
    lib_err = float((lib()[:, :, 0] - got).abs().max().item())
    committed = int(lengths.clamp(max=K7_C).sum().item())
    bound_ms = _decode_bound_bytes_ms(K7_B, K7_H, K7_HK, K7_D, committed)
    bound_s = _decode_bound_bytes_ms(SERVE_B, K7_H, K7_HK, K7_D,
                                     SERVE_B * last)
    serve = {"B": SERVE_B, "C": SERVE_MAX_SEQ, "frontiers": [1, last],
             "timed_frontier": last, "max_abs_err": err_s,
             "n_split_and_len": kernel.decode_splits(
                 SERVE_B, SERVE_MAX_SEQ, K7_HK, kernel.sm_count(0)),
             **_call_times(lambda: kernel.decode_attention_gqa(
                 qs, ks, vs, lens, sm_scale=scale), bound_s),
             "library_ms": _time_ms(lib_s, REPS, TRIALS),
             "library_device_ms": _device_ms(lib_s, REPS)}
    return {
        "B": K7_B, "H": K7_H, "Hk": K7_HK, "C": K7_C, "D": K7_D,
        "dtype": "float32", "committed_rows": committed,
        "lengths_min_max": [int(lengths.min()), int(lengths.max())],
        "n_split_and_len": kernel.decode_splits(K7_B, K7_C, K7_HK,
                                                kernel.sm_count(0)),
        "max_abs_err": max(err, err_0, err_s), "lengths0_max_abs_err": err_0,
        "serve_shape": serve,
        "library_max_abs_err": lib_err,
        **_call_times(lambda: run(lengths), bound_ms),
        "plain_ms": _time_ms(
            lambda: decode_gqa_ref(q, kc, vc, lengths, sm_scale=scale), 5),
        "library_ms": _time_ms(lib, REPS),
        "library_device_ms": _device_ms(lib, REPS),
    }


def _sfu_per_s() -> float:
    """The card's peak rate of special-function results (exp2, the
    exponential's scarce unit): SMs x 16 a clock x the maximum SM clock,
    both read from the card."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(_smi("clocks.max.sm", "csv,noheader,nounits"))
    return sms * SFU_PER_SM * mhz * 1e6


def scan_inputs(seed, b, s, di, n, *, with_h0=False):
    """Seeded scan inputs on the card, as the reference's kernel test
    draws them: xi, B, C ~ N(0, 0.25), dt = softplus(N(0, 1)), a_neg =
    -exp(0.3 N(0, 1)); h0 ~ N(0, 1) or None."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    xi = _randn(g, b, s, di) * 0.5
    dt = torch.nn.functional.softplus(_randn(g, b, s, di))
    bm, cm = _randn(g, b, s, n) * 0.5, _randn(g, b, s, n) * 0.5
    a_neg = -torch.exp(_randn(g, di, n) * 0.3)
    h0 = _randn(g, b, di, n) if with_h0 else None
    return xi, dt, bm, cm, a_neg, h0


def _scan_err(got, want, what) -> float:
    """Max abs error of ``got``, held within SCAN_ATOL + SCAN_RTOL·|want|."""
    diff = (got.float() - want.float()).abs()
    if not bool((diff <= SCAN_ATOL + SCAN_RTOL * want.float().abs()).all()):
        raise AssertionError(f"{what}: max abs err {diff.max().item()} above "
                             f"{SCAN_ATOL} + {SCAN_RTOL}|want|")
    return float(diff.max().item())


def _scan_bounds(b, s, di, n) -> dict:
    """K8's bounds from a zero state: the bytes (x, dt and y once in
    float32, B and C, a_neg and h_final once) and the B·S·di·n
    exponentials at the card's special-function rate; the larger of the
    two bounds it."""
    nbytes = 4 * (3 * b * s * di + 2 * b * s * n + di * n + b * di * n)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    sfu_ms = b * s * di * n / _sfu_per_s() * 1e3
    return {"bytes_bound_ms": bytes_ms, "sfu_bound_ms": sfu_ms,
            "bound_ms": max(bytes_ms, sfu_ms),
            "bound_by": "bytes" if bytes_ms >= sfu_ms else "operations"}


def check_scan_kernel():
    """K8 against ``selective_scan_ref`` on the card, y and the final
    state: at falcon-mamba-7b's widths (B=4, S=4096, di=8192, n=16); a
    ragged case (S=1000, di=8192-96, no chunk or slab divides them); a
    continuation from a nonzero h0; the serve path's prefill shape (B=4,
    S=128). At the first and the last the whole call (``_call_times``)
    beside the larger of its bytes bound and its exponentials' bound."""
    from repro_torch.kernels.ssm_scan import kernel
    from repro_torch.kernels.ssm_scan.ref import selective_scan_ref

    cases = {"full": (K8_B, K8_S, K8_DI, False),
             "ragged": (K8_B, K8R_S, K8R_DI, False),
             "carried_h0": (K8_B, SERVE_P, K8_DI, True),
             "serve_shape": (SERVE_B, SERVE_P, K8_DI, False)}
    out, timed = {}, {}
    for i, (name, (b, s, di, with_h0)) in enumerate(cases.items()):
        args = scan_inputs(30 + i, b, s, di, K8_N, with_h0=with_h0)
        y, h = kernel.selective_scan(*args)
        y_ref, h_ref = selective_scan_ref(*args)
        torch.cuda.synchronize()
        out[name] = {"B": b, "S": s, "di": di, "n": K8_N, "h0": with_h0,
                     "max_abs_err": _scan_err(y, y_ref, f"K8 {name} y"),
                     "h_final_max_abs_err": _scan_err(h, h_ref,
                                                      f"K8 {name} h_final")}
        if name in ("full", "serve_shape"):
            timed[name] = args
        del args, y, h, y_ref, h_ref
    bounds_s = _scan_bounds(SERVE_B, SERVE_P, K8_DI, K8_N)
    out["serve_shape"].update(bounds_s, **_call_times(
        lambda: kernel.selective_scan(*timed["serve_shape"]),
        bounds_s["bound_ms"]))
    bounds = _scan_bounds(K8_B, K8_S, K8_DI, K8_N)
    full = timed["full"]
    out.update({
        "max_abs_err": max(c["max_abs_err"] for c in out.values()),
        "h_final_max_abs_err": max(c["h_final_max_abs_err"]
                                   for c in out.values()),
        **bounds,
        **_call_times(lambda: kernel.selective_scan(*full),
                      bounds["bound_ms"]),
        "plain_ms": _time_ms(lambda: selective_scan_ref(*full), 2),
    })
    return out


def mamba_step_inputs(seed, b, di, n, k):
    """Seeded inputs of one Mamba-1 step on the card, in ``mamba_step``'s
    order: xz, the window and the state ~ N(0, 1); the layer's parameters
    at the model's init scales, with the biases, the skip and the decays
    drawn around their init values so that every term counts."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    a_log = (torch.log(torch.arange(1, n + 1, device="cuda",
                                    dtype=torch.float32))[None]
             + 0.1 * _randn(g, di, n))
    return [_randn(g, b, 2 * di), _randn(g, b, k - 1, di), _randn(g, b, di, n),
            0.5 * _randn(g, k, di), 0.1 * _randn(g, di),
            di ** -0.5 * _randn(g, di, 2 * n), di ** -0.5 * _randn(g, di, 1),
            0.5 * _randn(g, di) - 1.0, a_log.contiguous(),
            1.0 + 0.1 * _randn(g, di)]


def _mamba_step_bytes(b, di, n, k) -> int:
    """The bytes one step must move: the state and the window read and
    written once, xz read, y written, the parameters read (float32)."""
    return 4 * (2 * b * di * n + 2 * b * (k - 1) * di + 3 * b * di
                + di * (k + 2 * n + n + 4))


def _step_err(got, want, what) -> float:
    """Max abs error of ``got``, held within MSTEP_ATOL + MSTEP_RTOL·|want|."""
    diff = (got - want).abs()
    if not bool((diff <= MSTEP_ATOL + MSTEP_RTOL * want.abs()).all()):
        raise AssertionError(f"{what}: max abs err {diff.max().item()} above "
                             f"{MSTEP_ATOL} + {MSTEP_RTOL}|want|")
    return float(diff.max().item())


def check_mamba_step_kernel():
    """K10 against ``mamba_step_ref`` on the card, ``K10_STEPS`` steps in a
    row from one state, the window and state carried in place by each: y
    and the state within MSTEP_ATOL + MSTEP_RTOL·|plain|, the window bit
    for bit, at falcon-mamba-7b's widths and the decode cell's batch, and
    at a ragged width; at the first the whole call (``_call_times``)
    beside its bytes bound and the plain step."""
    from repro_torch.kernels.mamba_step import kernel
    from repro_torch.kernels.mamba_step.ref import mamba_step_ref

    out = {}
    cases = {"full": (K10_B, K10_DI), "ragged": (K10R_B, K10R_DI)}
    for i, (name, (b, di)) in enumerate(cases.items()):
        args = mamba_step_inputs(50 + i, b, di, K10_N, K10_K)
        plain = [t.clone() for t in args[:3]] + args[3:]
        ptrs = [t.data_ptr() for t in args[1:3]]
        before = kernel.mamba_step.launches
        err_y = err_h = 0.0
        g = torch.Generator(device="cuda").manual_seed(60 + i)
        for step in range(K10_STEPS):
            y = kernel.mamba_step(*args)
            y_ref = mamba_step_ref(*plain)
            torch.cuda.synchronize()
            err_y = max(err_y, _step_err(y, y_ref, f"K10 {name} y {step}"))
            err_h = max(err_h, _step_err(args[2], plain[2],
                                         f"K10 {name} h {step}"))
            if not torch.equal(args[1], plain[1]):
                raise AssertionError(f"K10 {name}: the window differs from "
                                     f"the plain step's at step {step}")
            args[0].copy_(_randn(g, b, 2 * di))
            plain[0].copy_(args[0])
        if [t.data_ptr() for t in args[1:3]] != ptrs:
            raise AssertionError(f"K10 {name}: the state moved")
        out[name] = {"B": b, "di": di, "n": K10_N, "K": K10_K,
                     "steps": K10_STEPS, "max_abs_err": err_y,
                     "h_max_abs_err": err_h,
                     "launches": kernel.mamba_step.launches - before}
        if name == "full":
            full, full_plain = args, plain
        else:
            del args, plain
    nbytes = _mamba_step_bytes(K10_B, K10_DI, K10_N, K10_K)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    state_ms = (4 * (2 * K10_B * K10_DI * K10_N + 2 * K10_B * (K10_K - 1)
                     * K10_DI) / HBM_BYTES_PER_S * 1e3)
    out.update({
        "max_abs_err": max(c["max_abs_err"] for c in out.values()),
        "h_max_abs_err": max(c["h_max_abs_err"] for c in out.values()),
        "bytes": nbytes, "bound_ms": bound_ms, "bound_by": "bytes",
        "state_and_window_bound_ms": state_ms,
        **_call_times(lambda: kernel.mamba_step(*full), bound_ms),
        "plain_ms": _time_ms(lambda: mamba_step_ref(*full_plain), 5),
    })
    return out


def check_training_kernels():
    """The kernels on the training path, each against its plain version on
    the card. K6 with ``return_lse`` at qwen3-14b's heads (B=4, S=1024,
    causal, the training path's shape), gemma3-4b's window (8/4 heads of
    256, window 1024, S=2048) and minicpm3-4b's MLA (40/40, q and k 96, v
    64, S=1024): its output the same bits as without the lse, the lse
    within ``ATTN_ATOL`` of the plain loop's, and ``flash_mha``'s
    gradients (q, k, v; the autograd Function: K6 forward, the blockwise
    recompute backward) within ``ATTN_ATOL`` of autograd through
    ``attention_ref``; K6 with the lse timed as a whole call beside its
    bound, without it, the plain loop (with its lse), the backward, the
    Function's forward and backward through autograd, and
    ``scaled_dot_product_attention`` (a yardstick the port never calls;
    a boolean mask for the window) forward and forward plus backward.
    K8 at falcon-mamba-7b's width (B=1, S=512, di=8192, n=16; four chunks
    of the backward): the Function's y and h_final within the scan's
    tolerances of ``selective_scan_ref``'s, and its gradients (xi, dt, B,
    C, a_neg; K8 forward, the chunked plain recompute backward from K8's
    chunk start states) within ``SCAN_GRAD_ATOL + SCAN_GRAD_RTOL·|plain|``
    of autograd through ``selective_scan_ref``, the backward timed."""
    import torch.nn.functional as F
    from repro_torch.kernels.attention import kernel
    from repro_torch.kernels.attention.ref import flash_gqa_ref
    from repro_torch.kernels.ssm_scan import kernel as k8
    from repro_torch.kernels.ssm_scan.ref import selective_scan_ref
    from repro_torch.models import flash

    cases = [
        ("qwen3 at the training shape", TRAIN_B, TRAIN_S, K6_H, K6_HK, K6_D,
         K6_D, 0),
        ("gemma3's window", 1, K6T_WINDOW_S, K6W_H, K6W_HK, K6W_D, K6W_D,
         K6W_WINDOW),
        ("minicpm3's MLA", 1, K6T_MLA_S, MLA_H, MLA_H, MLA_DK, MLA_DV, 0),
    ]
    g = torch.Generator(device="cuda").manual_seed(23)
    out = {}
    for name, b, s, h, hk, dk, dv, window in cases:
        q = _randn(g, b, s, h, dk)
        k, v = _randn(g, b, s, hk, dk), _randn(g, b, s, hk, dv)
        do = _randn(g, b, s, h, dv)
        with_lse = lambda: kernel.flash_attention_gqa(  # noqa: E731
            q, k, v, window=window, return_lse=True)
        o, lse = with_lse()
        o_plain = kernel.flash_attention_gqa(q, k, v, window=window)
        o_ref, lse_ref = flash_gqa_ref(q, k, v, window=window,
                                       return_lse=True)
        torch.cuda.synchronize()
        if not torch.equal(o, o_plain):
            raise AssertionError(f"K6 at {name}: the output's bits change "
                                 f"when the lse is written")
        lse_err = _within(lse, lse_ref, f"K6's lse at {name}")
        out_err = _within(o, o_ref, f"K6 at {name}")

        def grads(fn):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            return torch.autograd.grad(fn(*leaves, window=window), leaves,
                                       do)

        got = grads(flash.flash_mha)
        want = grads(flash.attention_ref)
        torch.cuda.synchronize()
        grad_err = max(_within(a, w, f"flash_mha's d{n} at {name}")
                       for n, a, w in zip("qkv", got, want))
        del got, want
        qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
        mask = None
        if window:
            i = torch.arange(s, device="cuda")
            mask = (i[:, None] >= i[None, :]) & (i[None, :] > i[:, None]
                                                 - window)
        lib = lambda *x: F.scaled_dot_product_attention(  # noqa: E731
            *x, attn_mask=mask, is_causal=mask is None, enable_gqa=hk != h)
        lib_err = float((lib(qt, kt, vt).transpose(1, 2) - o).abs().max())

        def lib_grads():
            leaves = [t.clone().requires_grad_() for t in (qt, kt, vt)]
            return torch.autograd.grad(lib(*leaves), leaves, dot)

        bounds = _flash_bounds(b, s, h, hk, dk, window, dv=dv)
        out[name] = {
            "B": b, "S": s, "H": h, "Hk": hk, "Dk": dk, "Dv": dv,
            "causal": True, "window": window, "lse_max_abs_err": lse_err,
            "max_abs_err": out_err, "grad_max_abs_err": grad_err,
            "output_bits_equal_without_lse": True, **bounds,
            **_call_times(with_lse, bounds["bound_ms"]),
            "without_lse_ms": _time_ms(
                lambda: kernel.flash_attention_gqa(q, k, v, window=window),
                REPS, TRIALS),
            "plain_ms": _time_ms(lambda: flash_gqa_ref(
                q, k, v, window=window, return_lse=True), 3),
            "backward_ms": _time_ms(lambda: flash.flash_bwd(
                q, k, v, o, lse, do, True, window), 3),
            "forward_backward_ms": _time_ms(lambda: grads(flash.flash_mha),
                                            3),
            "library": "scaled_dot_product_attention"
                       + (" with a boolean window mask" if window else ""),
            "library_max_abs_err": lib_err,
            "library_ms": _time_ms(lambda: lib(qt, kt, vt), REPS, TRIALS),
            "library_forward_backward_ms": _time_ms(lib_grads, 3)}
        del q, k, v, do, o, lse, o_plain, o_ref, lse_ref, qt, kt, vt, dot
        torch.cuda.empty_cache()

    args = scan_inputs(41, K8G_B, K8G_S, K8_DI, K8_N)[:5]
    gy, gh = _randn(g, K8G_B, K8G_S, K8_DI), _randn(g, K8G_B, K8_DI, K8_N)

    def scan_grads(fn, outputs=None):
        leaves = [t.clone().requires_grad_() for t in args]
        y, h = fn(*leaves)
        if outputs is not None:
            outputs.extend(t.detach() for t in (y, h))
        return torch.autograd.grad((y, h), leaves, (gy, gh))

    got_out, want_out = [], []
    got = scan_grads(k8.selective_scan, got_out)
    want = scan_grads(selective_scan_ref, want_out)
    torch.cuda.synchronize()
    y_err = _scan_err(got_out[0], want_out[0], "selective_scan's y")
    h_err = _scan_err(got_out[1], want_out[1], "selective_scan's h_final")
    del got_out, want_out
    scan_err = 0.0
    for name, a, w in zip(("xi", "dt", "B", "C", "a_neg"), got, want):
        diff = (a - w).abs()
        if not bool((diff <= SCAN_GRAD_ATOL + SCAN_GRAD_RTOL
                     * w.abs()).all()):
            raise AssertionError(
                f"selective_scan's d{name}: max abs err {diff.max().item()} "
                f"above {SCAN_GRAD_ATOL} + {SCAN_GRAD_RTOL}|plain|")
        scan_err = max(scan_err, float(diff.max().item()))
    scan = {"B": K8G_B, "S": K8G_S, "di": K8_DI, "n": K8_N,
            "backward_chunks": -(-K8G_S // k8.BWD_CHUNK),
            "max_abs_err": y_err, "h_final_max_abs_err": h_err,
            "grad_max_abs_err": scan_err,
            "tolerance": f"{SCAN_GRAD_ATOL} + {SCAN_GRAD_RTOL}|plain|",
            "backward_ms": _time_ms(lambda: k8.scan_bwd(*args, None, gy, gh),
                                    2),
            "plain_autograd_ms": _time_ms(lambda: scan_grads(
                selective_scan_ref), 2)}
    return {"flash": out, "scan": scan,
            "lse_max_abs_err": max(c["lse_max_abs_err"]
                                   for c in out.values()),
            "grad_max_abs_err": max(c["grad_max_abs_err"]
                                    for c in out.values())}


def gmm_inputs(seed, block_t):
    """phi3.5-moe's prefill through the dispatch: router logits for
    SERVE_B x SERVE_P tokens over 16 experts, top-2, then
    ``monotonic_dispatch``; x_sorted (T_pad, 4096) with the tokens at
    their slots (pads 0), w_in (16, 4096, 6400), w_out (16, 6400, 4096)
    and an h (T_pad, 6400), all seeded on the card."""
    from repro_torch.kernels.moe_group_mm.ops import monotonic_dispatch, route

    g = torch.Generator(device="cuda").manual_seed(seed)
    t = SERVE_B * SERVE_P
    _, top_e = route(_randn(g, t, K9_E), K9_TOP_K)
    flat_e = top_e.reshape(-1).to(torch.int32)
    n = flat_e.shape[0]
    _, slot, be, _, _ = monotonic_dispatch(flat_e, K9_E, block_t)
    t_pad = (n // block_t + K9_E) * block_t
    x = torch.zeros(t_pad, K9_D, device="cuda")
    x[slot.long()] = _randn(g, t, K9_D)[torch.arange(n, device="cuda")
                                        // K9_TOP_K]
    w_in = _randn(g, K9_E, K9_D, K9_FF) * K9_D ** -0.5
    w_out = _randn(g, K9_E, K9_FF, K9_D) * K9_FF ** -0.5
    h = _randn(g, t_pad, K9_FF)
    return x, w_in, w_out, h, be, int(torch.unique(be[:t_pad // block_t])
                                       .numel())


def _tf32_walk(d_in) -> float:
    """K9's second limit on float32 inputs, as a multiple of (|x||w|):
    2**-10 / sqrt(d_in), the size that one TF32 pass's operand roundings
    (2**-11 relative each) reach as a random walk over d_in products. The
    largest error of one pass over an output lies above it, about twice
    (``tests/test_torch_moe_tf32.py``, TF32 emulated on the CPU), while
    3xTF32 on the tensor cores reads well under it; the float32 bound
    2·γ_{d_in} alone would pass either."""
    return 2.0**-10 / d_in ** 0.5


def _gmm_err(x, w, be, block_t, got, want, what):
    """``(max abs error, max share of the TF32 limit)`` of ``got`` on
    float32 inputs: the error held within twice the float32 dot-product
    bound γ_{d_in}·(|x||w|) (each sum order is within it of the exact
    product, so two orders are within twice it) and within
    ``_tf32_walk(d_in)``·(|x||w|), which a one-pass TF32 kernel misses."""
    from repro_torch.kernels.moe_group_mm.ref import group_matmul_ref

    mag = group_matmul_ref(x.abs(), w.abs(), be, block_t=block_t)
    diff = (got - want).abs()
    if not bool((diff <= 2 * _gamma(x.shape[1], F32_UNIT) * mag).all()):
        raise AssertionError(f"{what}: error above the float32 bound")
    limit = (_tf32_walk(x.shape[1]) * mag).clamp_min(
        torch.finfo(torch.float32).tiny)
    share = float((diff / limit).max().item())
    if not share <= 1:
        raise AssertionError(f"{what}: error {share} of the TF32 limit "
                             "(one TF32 pass, not three?)")
    return float(diff.max().item()), share


def _gmm_bounds(t_pad, d_in, d_out, experts) -> dict:
    """K9's bounds: the operations at the accuracy kept (3xTF32: three
    TF32 tensor-core products a multiply-add, at 495 TFLOP/s) beside the
    float32 CUDA cores' (the earlier design's) and the bytes (x once, the
    weights of the ``experts`` the row blocks name once, out once)."""
    flops = 2 * t_pad * d_in * d_out
    nbytes = 4 * (t_pad * d_in + experts * d_in * d_out + t_pad * d_out)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 3 * flops / TF32_FLOPS_PER_S * 1e3
    return {"gflop": flops / 1e9, "bytes_bound_ms": bytes_ms,
            "ops_bound_ms": ops_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "f32_cuda_core_bound_ms": max(flops / _f32_flops_per_s() * 1e3,
                                          bytes_ms)}


def check_gmm_kernel():
    """K9 against ``group_matmul_ref`` on the card at phi3.5-moe's prefill
    (4 x 128 tokens, top-2 of 16 experts, block_t=128: T_pad=3072),
    d_model 4096 -> d_ff 6400 (w_in) and 6400 -> 4096 (w_out), and at
    block_t=16, each within twice the float32 dot-product bound and
    within the TF32 limit that a one-pass kernel misses (``_gmm_err``,
    ``_tf32_walk``); both
    projections timed as whole calls (``_call_times``) beside the 3xTF32
    operations bound and one cuBLAS float32 product of equal FLOPs,
    ``(3072, 4096) @ (4096, 6400)`` (a size yardstick: no single PyTorch
    call computes the grouped product)."""
    from repro_torch.kernels.moe_group_mm import kernel
    from repro_torch.kernels.moe_group_mm.ref import group_matmul_ref

    x, w_in, w_out, h, be, experts = gmm_inputs(40, K9_BLOCK_T)
    t_pad = x.shape[0]
    run = lambda: kernel.group_matmul(x, w_in, be,  # noqa: E731
                                      block_t=K9_BLOCK_T)
    run_o = lambda: kernel.group_matmul(h, w_out, be,  # noqa: E731
                                        block_t=K9_BLOCK_T)
    got = run()
    want = group_matmul_ref(x, w_in, be, block_t=K9_BLOCK_T)
    torch.cuda.synchronize()
    err_in, share_in = _gmm_err(x, w_in, be, K9_BLOCK_T, got, want,
                                "K9 w_in")
    got_o = run_o()
    want_o = group_matmul_ref(h, w_out, be, block_t=K9_BLOCK_T)
    torch.cuda.synchronize()
    err_out, share_out = _gmm_err(h, w_out, be, K9_BLOCK_T, got_o, want_o,
                                  "K9 w_out")
    del got, want, got_o, want_o
    xs, _, _, _, bes, _ = gmm_inputs(41, K9_SMALL_BT)
    got_s = kernel.group_matmul(xs, w_in, bes, block_t=K9_SMALL_BT)
    want_s = group_matmul_ref(xs, w_in, bes, block_t=K9_SMALL_BT)
    torch.cuda.synchronize()
    err_s, share_s = _gmm_err(xs, w_in, bes, K9_SMALL_BT, got_s, want_s,
                              f"K9 at block_t={K9_SMALL_BT}")
    del got_s, want_s
    dense_w = w_in[0]
    bounds = _gmm_bounds(t_pad, K9_D, K9_FF, experts)
    bounds_o = _gmm_bounds(t_pad, K9_FF, K9_D, experts)
    return {
        "T_pad": t_pad, "d_in": K9_D, "d_out": K9_FF, "E": K9_E,
        "block_t": K9_BLOCK_T, "experts_used": experts,
        "products": "3xTF32 (float32 inputs)",
        "max_abs_err": max(err_in, err_out, err_s), "w_in_max_abs_err": err_in,
        "w_out_max_abs_err": err_out,
        "tf32_limit_share": {"w_in": share_in, "w_out": share_out,
                             "small_block_t": share_s},
        "small_block_t": {"block_t": K9_SMALL_BT, "T_pad": xs.shape[0],
                          "max_abs_err": err_s},
        **bounds, **_call_times(run, bounds["bound_ms"]),
        "w_out": {"d_in": K9_FF, "d_out": K9_D, **bounds_o,
                  **_call_times(run_o, bounds_o["bound_ms"])},
        "plain_ms": _time_ms(lambda: group_matmul_ref(x, w_in, be,
                                                      block_t=K9_BLOCK_T), 5),
        "dense_product_ms": _time_ms(lambda: x @ dense_w, REPS),
    }


def _param_bytes(params) -> int:
    return sum(_param_bytes(v) if isinstance(v, dict)
               else v.numel() * v.element_size() for v in params.values())


def profile_decode(step, params, cfg, tok, n_steps=4):
    """``n_steps`` decode steps at the serve path's last frontier, run
    twice from the same state: first without the profiler (the host
    clock of the steps), then under ``torch.profiler`` (their kernels).
    Returns the device's busy share (the traced kernel time over the
    profiler-free wall time of the same steps; None where the profiler
    reports no device time), the kernel launches per step and per
    layer, K7's device ms per step, and the kernels that take the most
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import layers as L, transformer as T

    cache = T.init_cache(cfg, SERVE_B, SERVE_MAX_SEQ, L.FP32, device="cuda")
    start = SERVE_P + SERVE_NEW - n_steps

    def run():
        c = cache
        lens = torch.full((SERVE_B,), start, dtype=torch.int32,
                          device="cuda")
        t0 = time.perf_counter()
        for _ in range(n_steps):
            _, c, lens = step(params, tok, c, lens)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run()  # warm-up
    wall = run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_traced = run()
    # kernel rows only: an operator's row repeats its kernels' time
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    launches = sum(r[2] for r in rows)
    k7_us = sum(r[1] for r in rows if "decode_kernel" in r[0])
    return {
        "steps": n_steps, "wall_ms_per_step": wall / n_steps * 1e3,
        "traced_wall_ms_per_step": wall_traced / n_steps * 1e3,
        "kernel_ms_per_step": busy_us / n_steps / 1e3,
        "k7_ms_per_step": k7_us / n_steps / 1e3,
        "device_busy_share": busy_us * 1e-6 / wall if busy_us else None,
        "kernels_per_step": launches / n_steps,
        "kernels_per_layer_step": launches / n_steps / cfg.n_layers,
        "top_kernels_ms_per_step": [(k[:80], us / n_steps / 1e3, n / n_steps)
                                    for k, us, n in rows[:6]],
    }


def _launch_counts() -> dict:
    """The launch counters of the LM kernels K6-K9."""
    from repro_torch.kernels.attention import kernel as attn
    from repro_torch.kernels.mamba_step import kernel as k10
    from repro_torch.kernels.moe_group_mm import kernel as k9
    from repro_torch.kernels.ssm_scan import kernel as k8

    return {"k6": attn.flash_attention.launches,
            "k7": attn.decode_attention.launches,
            "k8": k8.ssm_scan.launches, "k9": k9.group_matmul.launches,
            "k10": k10.mamba_step.launches}


def _zero_launch_counts():
    from repro_torch.kernels.attention import kernel as attn
    from repro_torch.kernels.mamba_step import kernel as k10
    from repro_torch.kernels.moe_group_mm import kernel as k9
    from repro_torch.kernels.ssm_scan import kernel as k8

    for counted in (attn.flash_attention, attn.decode_attention,
                    k8.ssm_scan, k9.group_matmul, k10.mamba_step):
        counted.launches = 0


def _decode_bound_ms(cfg, params, steps_run, batch=SERVE_B,
                     enc_frames=0) -> float:
    """The bytes bound of one decode step, averaged over ``steps_run``
    steps from an empty cache: every weight a step uses read once
    (zamba2's shared block once an application: no on-chip memory holds
    its 0.82 GB between them; the embedding table only where it is not
    the head: then its ``batch`` rows are gathered; tied, it is the head
    and read whole; whisper's encoder weights not at all), and the caches:

    - each Mamba layer's conv window and state read and written (Mamba-2's
      ``(nh, 64, n)`` state holds ``d_inner * n`` words, as Mamba-1's);
    - each attention layer, or zamba2's shared block at each of its
      applications, reads its committed K/V rows (``min(t + 1, window)``
      at step t for gemma3's local layers on their rings) and writes one;
      an MLA layer reads and writes rows of its latent and rotary key
      (``kv_lora_rank + qk_rope_dim`` words a position);
    - given ``enc_frames``, each of whisper's decoder layers reads the
      encoder output (``enc_frames`` rows of ``d_model``) once a step, as
      ``_cross_decode`` recomputes its cross K/V from it (the
      ``"cross_kv"`` cache, never read, is not counted).
    """
    weights = _param_bytes(params)
    if cfg.enc_dec:  # a decode step never runs the encoder
        weights -= (_param_bytes(params["enc_layers"])
                    + params["enc_norm"].numel() * 4)
    if cfg.shared_attn_every:  # the shared block, read at each application
        weights += ((cfg.n_layers // cfg.shared_attn_every - 1)
                    * _param_bytes(params["shared_attn"]))
    if not cfg.tie_embeddings:
        weights += (batch - params["embed"].shape[0]) * cfg.d_model * 4
    cache = 0
    if cfg.ssm:
        di = cfg.expand * cfg.d_model
        state = (cfg.d_conv - 1) * di + di * cfg.ssm_state
        cache += 2 * 4 * cfg.n_layers * batch * state * steps_run
    if cfg.shared_attn_every:
        windows = [0] * (cfg.n_layers // cfg.shared_attn_every)
    elif cfg.ssm:
        windows = []
    else:
        from repro_torch.models.transformer import _window_schedule
        windows = _window_schedule(cfg)
    row = (4 * (cfg.kv_lora_rank + cfg.qk_rope_dim) if cfg.attn_type == "mla"
           else cfg.n_kv_heads * cfg.resolved_head_dim * 4 * 2)
    for w in windows:
        rows = sum(min(t + 1, w or t + 1) for t in range(steps_run))
        cache += row * batch * (rows + steps_run)
    cache += (cfg.n_layers * batch * enc_frames * cfg.d_model * 4
              * steps_run)
    return (steps_run * weights + cache) / HBM_BYTES_PER_S / steps_run * 1e3


def plain_scan_prefill(cfg, params, prompts):
    """The prefill's last-token logits with K8 swapped for its plain
    version, a diagnostic only (the port never runs the plain version on
    the card): against the K8 prefill and the teacher-forced decode, it
    shows how much of the gap between the two K8 accounts for."""
    from repro_torch.kernels.ssm_scan.ref import selective_scan_ref
    from repro_torch.models import layers as L, ssm as S, transformer as T

    saved = S.selective_scan
    S.selective_scan = selective_scan_ref
    try:
        logits, _ = T.prefill(params, prompts, cfg, L.FP32,
                              max_seq=SERVE_MAX_SEQ)
    finally:
        S.selective_scan = saved
    return logits


def check_moe_layers(cfg, params, prompts):
    """For each layer, its MoE weights on the prefill's final hidden
    states: the dropless path (``moe_apply(use_kernel=True)``, three K9
    launches) against the capacity path with room for every assignment
    (``capacity_factor = E / k``, so ``cap = T``), within MOE_ATOL +
    MOE_RTOL·|capacity|; each path's host seconds, summed over the
    layers (the first layer's include the card's warm-up). Both route alike: the capacity path keeps every
    assignment, and each assignment's buffer row (``slot // cap``) and
    its row block's expert in the monotonic dispatch name the expert
    ``route`` chose."""
    from repro_torch.kernels.moe_group_mm.ops import monotonic_dispatch, route
    from repro_torch.models import layers as L, transformer as T

    hidden = T.forward_hidden(params, prompts, cfg, L.FP32, inference=True)
    flat = hidden.reshape(-1, cfg.d_model)
    t, e, k = flat.shape[0], cfg.n_experts, cfg.top_k
    errs, margins, out_max, over_tol = [], [], 0.0, 0.0
    dropless_s = roomy_s = 0.0
    for i in range(cfg.n_layers):
        lp = T.layer_params(params["layers"], i)["moe"]
        probs = torch.softmax(flat @ lp["router"], dim=-1)
        _, top_e = route(flat @ lp["router"], k)
        flat_e = top_e.reshape(-1)
        slot, keep = L.capacity_slots(flat_e, e, t)
        _, slot_d, be, _, _ = monotonic_dispatch(flat_e.to(torch.int32), e,
                                                 K9_BLOCK_T)
        dropless_e = be.long()[slot_d.long() // K9_BLOCK_T]
        if not (bool(keep.all()) and torch.equal(slot // t, flat_e)
                and torch.equal(dropless_e, flat_e)):
            raise AssertionError(f"MoE layer {i}: the two paths route "
                                 f"differently")
        srt = torch.sort(probs, dim=-1, descending=True).values
        margins.append(float((srt[:, k - 1] - srt[:, k]).min().item()))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dropless = L.moe_apply(lp, hidden, cfg, use_kernel=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        roomy = L.moe_apply(lp, hidden, cfg, capacity_factor=e / k)
        torch.cuda.synchronize()
        dropless_s += t1 - t0
        roomy_s += time.perf_counter() - t1
        diff = (dropless - roomy).abs()
        if not bool((diff <= MOE_ATOL + MOE_RTOL * roomy.abs()).all()):
            raise AssertionError(f"MoE layer {i}: dropless (K9) and capacity "
                                 f"paths differ by {diff.max().item()}")
        errs.append(float(diff.max().item()))
        out_max = max(out_max, float(roomy.abs().max().item()))
        over_tol = max(over_tol, float(
            (diff / (MOE_ATOL + MOE_RTOL * roomy.abs())).max().item()))
    return {"layers": cfg.n_layers, "tokens": t,
            "max_abs_err": max(errs), "max_abs_err_per_layer": errs,
            "max_err_over_tol": over_tol,
            "dropless_s": dropless_s, "capacity_s": roomy_s,
            "min_top_k_margin": min(margins), "output_abs_max": out_max}


def _over_tol(got, want) -> float:
    """max |got - want| / (SERVE_ATOL + SERVE_RTOL·|want|)."""
    return float(((got - want).abs() / (SERVE_ATOL + SERVE_RTOL * want.abs()))
                 .max().item())


def _forward_vs_decode(what, fwd, dec, limit=1.0) -> dict:
    """Prefill logits ``fwd`` against teacher-forced decode's ``dec``:
    raises where the error over SERVE_ATOL + SERVE_RTOL·|fwd| passes
    ``limit`` (1, the tolerance itself, but for ``HYBRID_GAP_LIMIT``)."""
    if not bool(torch.isfinite(fwd).all() and torch.isfinite(dec).all()):
        raise AssertionError(f"{what}: non-finite logits")
    diff = (dec - fwd).abs()
    row = {
        "max_abs_err": float(diff.max().item()),
        "max_rel_err": float((diff / fwd.abs().clamp(min=1e-6)).max()
                             .item()),
        "max_err_over_tol": _over_tol(dec, fwd),
        "top1_agree": float((dec.argmax(-1) == fwd.argmax(-1)).float()
                            .mean().item()),
        "logit_abs_max": float(fwd.abs().max().item()),
    }
    if limit != 1:
        row["limit_over_tol"] = limit
    if not row["max_err_over_tol"] <= limit:
        raise AssertionError(f"{what}: prefill and teacher-forced decode "
                             f"logits differ: {row}")
    return row


def check_hybrid_units(cfg, params, prompts) -> dict:
    """zamba2's prefill and decode forms held unit by unit (each Mamba-2
    layer, each application of the shared block), teacher-forced at every
    unit: the prefill's hidden states entering a unit are fed to its
    decode step one position at a time (the SSD step on its carried conv
    window and state; the shared block through K7 on that application's
    K/V cache), and each output is held against the unit's prefill output
    (the chunked SSD; K6) at every position, within SERVE_ATOL +
    SERVE_RTOL·|prefill| — the decode tolerance, without the stack's
    amplification of rounding from one unit to the next."""
    from repro_torch.models import layers as L, transformer as T

    b, p_len = prompts.shape
    segments, rest = T._segments(cfg)
    units = []
    for app, seg in enumerate(segments):
        units += [("ssm", i) for i in seg] + [("attn", app)]
    units += [("ssm", i) for i in rest]
    pos = torch.arange(p_len, device="cuda")[None, :].expand(b, p_len)
    shared = params["shared_attn"]
    xs = [params["embed"][prompts.long()]]
    for kind, i in units:  # the prefill, one unit at a time
        xs.append(T._scan_ssm(params["layers"], xs[-1], cfg, [i])
                  if kind == "ssm" else
                  T._attn_mlp_block(shared, xs[-1], cfg, positions=pos,
                                    inference=True))
    cache = T.init_cache(cfg, b, SERVE_MAX_SEQ, L.FP32, device="cuda")
    sk, sv = cache["shared_kv"]
    lens = torch.zeros(b, dtype=torch.int32, device="cuda")
    worst = torch.zeros(len(units), device="cuda")
    t0 = time.perf_counter()
    for t in range(p_len):
        for u, (kind, i) in enumerate(units):
            x = xs[u][:, t:t + 1]
            y = (T._ssm_decode(params, x, cache, cfg, [i]) if kind == "ssm"
                 else T._attn_mlp_decode(shared, x, cfg, (sk[i], sv[i]),
                                         lens, lens[:, None]))
            want = xs[u + 1][:, t:t + 1]
            worst[u] = torch.maximum(worst[u], (
                (y - want).abs() / (SERVE_ATOL + SERVE_RTOL * want.abs()))
                .max())
        lens += 1
    torch.cuda.synchronize()
    worst = worst.tolist()
    u_max = int(np.argmax(worst))
    row = {"units": len(units), "positions": p_len,
           "max_err_over_tol": worst[u_max], "worst_unit": list(units[u_max]),
           "max_err_over_tol_ssm": max(w for w, u in zip(worst, units)
                                       if u[0] == "ssm"),
           "max_err_over_tol_shared_block": max(
               w for w, u in zip(worst, units) if u[0] == "attn"),
           "host_s": time.perf_counter() - t0}
    if not row["max_err_over_tol"] <= 1:
        raise AssertionError(f"hybrid: a unit's prefill and decode forms "
                             f"differ: {row}")
    return row


def run_lm_path(arch, *, n_layers=None):
    """One LM at full width in float32 on the card, weights drawn from a
    seeded generator, 4 prompts of 128 tokens: (a) ``make_prefill_step``'s
    last-token logits, held (except for MoE) against the same prompts fed
    by 128 teacher-forced ``make_serve_step`` steps within the reference's
    decode-against-forward tolerance; for MoE, where a prompt and a decode
    step compute different functions (capacity drops), ``check_moe_layers``
    instead; (b) ``serve_batch`` for ``SERVE_NEW`` tokens, its first
    tokens equal to (a)'s argmax wherever the top-2 margin exceeds twice
    the tolerance, timed beside the decode step's bytes bound; (c)
    ``profile_decode``. The K6-K9 launches of each run are read around it
    and must equal the family's counts. ``n_layers`` cuts the depth.

    The encoder-decoder (whisper) prefills over stub frames drawn from a
    seed (``FRAME_SCALE``) and its teacher-forced steps are given the
    encoder's output (``T._encode``, its launches read apart); since
    ``serve_batch`` gives none, as the reference's does, its first tokens
    are held against a second teacher-forced run without it."""
    from repro_torch.configs import base as configs
    from repro_torch.launch import serve, steps
    from repro_torch.models import layers as L, transformer as T

    cfg = configs.get(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    n = cfg.n_layers
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = T.init_params(gen, cfg, L.FP32, device=dev)
    gen.manual_seed(1)
    prompts = torch.randint(3, cfg.vocab, (SERVE_B, SERVE_P), generator=gen,
                            device=dev, dtype=torch.int32)
    batch = {"tokens": prompts}
    if cfg.enc_dec:  # the stub frontend's frame embeddings
        gen.manual_seed(2)
        batch["frontend"] = FRAME_SCALE * torch.randn(
            (SERVE_B, cfg.frontend_len, cfg.d_model), generator=gen,
            device=dev)
    torch.cuda.synchronize()
    out = {"arch": cfg.name, "n_layers": n,
           "n_layers_of": configs.get(arch).n_layers, "d_model": cfg.d_model,
           "batch": SERVE_B, "prompt_len": SERVE_P, "max_new": SERVE_NEW,
           "max_seq": SERVE_MAX_SEQ, "dtype": "float32",
           "init_s": time.perf_counter() - t0,
           "param_bytes": _param_bytes(params)}
    steps_run = SERVE_P + SERVE_NEW
    zero = {"k6": 0, "k7": 0, "k8": 0, "k9": 0, "k10": 0}
    # attention layers, or zamba2's applications of its shared block
    n_attn = n // cfg.shared_attn_every if cfg.shared_attn_every else n
    if cfg.ssm == "mamba1":  # K10 twice a layer step
        expect = {"prefill": {**zero, "k8": n},
                  "teacher_forced": {**zero, "k10": 2 * n * SERVE_P},
                  "serve": {**zero, "k10": 2 * n * steps_run}}
    elif cfg.is_moe:
        expect = {"prefill": {**zero, "k6": n},
                  "moe_check": {**zero, "k6": n, "k9": 3 * n},
                  "serve": {**zero, "k7": n * steps_run}}
    elif cfg.attn_type == "mla":  # the absorbed decode is plain torch
        expect = {"prefill": {**zero, "k6": n}, "teacher_forced": zero,
                  "serve": zero}
    elif cfg.enc_dec:  # K6 for the encoder, each decoder layer's self and
        # cross attention; a step's cross attention on K6 (S=1) as well
        expect = {"prefill": {**zero, "k6": cfg.n_enc_layers + 2 * n},
                  "encode": {**zero, "k6": cfg.n_enc_layers},
                  **{run: {**zero, "k6": n * SERVE_P, "k7": n * SERVE_P}
                     for run in ("teacher_forced",
                                 "teacher_forced_without_enc_out")},
                  "serve": {**zero, "k6": n * steps_run,
                            "k7": n * steps_run}}
    else:  # dense, sliding-window, or the hybrid (no kernel for Mamba-2)
        expect = {"prefill": {**zero, "k6": n_attn},
                  "teacher_forced": {**zero, "k7": n_attn * SERVE_P},
                  "serve": {**zero, "k7": n_attn * steps_run}}
    if cfg.shared_attn_every:  # its check beside the whole model's
        expect["unit_check"] = {**zero, "k6": n_attn, "k7": n_attn * SERVE_P}
    launches = {}

    # (a) prefill, against teacher-forced decode or the MoE layer check
    _zero_launch_counts()
    t0 = time.perf_counter()
    fwd, _ = steps.make_prefill_step(cfg, L.FP32, max_seq=SERVE_MAX_SEQ)(
        params, batch)
    torch.cuda.synchronize()
    out["prefill_s"] = time.perf_counter() - t0
    launches["prefill"] = _launch_counts()
    if not bool(torch.isfinite(fwd).all()):
        raise AssertionError(f"{arch}: non-finite prefill logits")
    step = steps.make_serve_step(cfg, L.FP32)
    dec = None
    if cfg.is_moe:
        _zero_launch_counts()
        out["moe_check"] = check_moe_layers(cfg, params, prompts)
        launches["moe_check"] = _launch_counts()
    else:
        enc_out = None
        if cfg.enc_dec:
            _zero_launch_counts()
            enc_out = T._encode(params, batch["frontend"], cfg, L.FP32)
            launches["encode"] = _launch_counts()

        def teacher_forced(run, enc_out):
            cache = T.init_cache(cfg, SERVE_B, SERVE_MAX_SEQ, L.FP32,
                                 device=dev)
            lens = torch.zeros(SERVE_B, dtype=torch.int32, device=dev)
            _zero_launch_counts()
            t0 = time.perf_counter()
            for t in range(SERVE_P):
                logits, cache, lens = step(params, prompts[:, t:t + 1], cache,
                                           lens, enc_out)
            torch.cuda.synchronize()
            out[f"{run}_s"] = time.perf_counter() - t0
            out[f"{run}_ms_per_step"] = out[f"{run}_s"] / SERVE_P * 1e3
            launches[run] = _launch_counts()
            return logits

        dec = teacher_forced("teacher_forced", enc_out)
        if cfg.enc_dec:
            out["teacher_forced_bound_ms_per_step"] = _decode_bound_ms(
                cfg, params, SERVE_P, enc_frames=cfg.frontend_len)
            # serve_batch's first tokens are held against steps run as it
            # runs them, without the encoder's output
            dec_serve = teacher_forced("teacher_forced_without_enc_out",
                                       None)
            out["without_enc_out_vs_with"] = {
                "max_abs_logit_diff": float((dec_serve - dec).abs().max()
                                            .item()),
                "top1_agree": float((dec_serve.argmax(-1) == dec.argmax(-1))
                                    .float().mean().item())}
            del enc_out
        if cfg.shared_attn_every:
            _zero_launch_counts()
            out["unit_check"] = check_hybrid_units(cfg, params, prompts)
            launches["unit_check"] = _launch_counts()
        out["forward_vs_decode"] = _forward_vs_decode(
            arch, fwd, dec, HYBRID_GAP_LIMIT if cfg.shared_attn_every else 1)
        tol = SERVE_ATOL + SERVE_RTOL * fwd.abs()
        if cfg.ssm == "mamba1":
            plain = plain_scan_prefill(cfg, params, prompts)
            out["forward_vs_decode"]["plain_scan_prefill"] = {
                "max_abs_err_vs_k8_prefill":
                    float((plain - fwd).abs().max().item()),
                "max_abs_err_vs_decode":
                    float((plain - dec).abs().max().item()),
                "max_err_over_tol_vs_decode":
                    float(((plain - dec).abs() / tol).max().item()),
            }

    # (b) serve_batch
    _zero_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = serve.serve_batch(cfg, params, prompts, max_new=SERVE_NEW,
                             max_seq=SERVE_MAX_SEQ)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches["serve"] = _launch_counts()
    if toks.shape != (SERVE_B, SERVE_NEW) or not bool(
            ((toks >= 0) & (toks < cfg.vocab)).all()):
        raise AssertionError(f"{arch}: serve_batch returned "
                             f"{tuple(toks.shape)} tokens or tokens out of "
                             f"range")
    if dec is not None:
        if cfg.enc_dec:
            dec = dec_serve
        top = torch.topk(dec, 2, dim=-1).values
        sure = (top[:, 0] - top[:, 1]) > 2 * (SERVE_ATOL
                                              + SERVE_RTOL * top[:, 0].abs())
        first = dec.argmax(-1).to(torch.int32)
        if not bool((toks[:, 0] == first)[sure].all()):
            raise AssertionError(f"{arch}: serve_batch's first tokens differ "
                                 f"from the teacher-forced argmax")
        out["first_tokens_checked"] = int(sure.sum().item())
    out.update({
        "serve_s": serve_s, "serve_steps": steps_run,
        "decode_ms_per_step": serve_s / steps_run * 1e3,
        "decode_bound_ms_per_step": _decode_bound_ms(cfg, params, steps_run),
        "decode_bound_basis": "bytes: the weights a step uses once (a tied "
                              "embedding whole), the caches' rows and "
                              "states",
        "generated_tokens_per_s": SERVE_B * SERVE_NEW / serve_s,
        "step_tokens_per_s": SERVE_B * steps_run / serve_s,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "tokens_head": toks[:2, :8].tolist(),
    })
    out["decode_profile"] = profile_decode(step, params, cfg, toks[:, -1:])
    out["launches"] = launches
    if launches != expect:
        raise AssertionError(f"{arch}: launches {launches}, expected "
                             f"{expect}")
    del params
    torch.cuda.empty_cache()
    return out


def run_ring_check():
    """gemma3-4b at full width cut to RING_LAYERS (one local-global period:
    5 local layers at window 1024, then 1 global), RING_B prompts of the
    window + RING_EXTRA tokens, max_seq one more: the prefill's
    last-token logits (one K6 launch a layer, the window binding on the
    local ones) against as many teacher-forced steps (one K7 launch a
    layer a step), whose local rings of 1024 positions wrap for the last
    RING_EXTRA steps, within the reference's decode-against-forward
    tolerance. The K6/K7 launches of each run are read around it."""
    from repro_torch.configs import base as configs
    from repro_torch.launch import steps
    from repro_torch.models import layers as L, transformer as T

    cfg = dataclasses.replace(configs.get(WINDOW_ARCH), n_layers=RING_LAYERS)
    windows = T._window_schedule(cfg)
    p_len = cfg.sliding_window + RING_EXTRA
    max_seq = p_len + 1
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = T.init_params(gen, cfg, L.FP32, device=dev)
    gen.manual_seed(1)
    prompts = torch.randint(3, cfg.vocab, (RING_B, p_len), generator=gen,
                            device=dev, dtype=torch.int32)
    zero = {"k6": 0, "k7": 0, "k8": 0, "k9": 0, "k10": 0}
    expect = {"prefill": {**zero, "k6": RING_LAYERS},
              "teacher_forced": {**zero, "k7": RING_LAYERS * p_len}}
    launches = {}
    _zero_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fwd, _ = steps.make_prefill_step(cfg, L.FP32, max_seq=max_seq)(
        params, {"tokens": prompts})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches["prefill"] = _launch_counts()
    step = steps.make_serve_step(cfg, L.FP32)
    cache = T.init_cache(cfg, RING_B, max_seq, L.FP32, device=dev)
    ring = cache["local_kv"][0].shape[2]
    lens = torch.zeros(RING_B, dtype=torch.int32, device=dev)
    _zero_launch_counts()
    t0 = time.perf_counter()
    for t in range(p_len):
        dec, cache, lens = step(params, prompts[:, t:t + 1], cache, lens)
    torch.cuda.synchronize()
    tf_s = time.perf_counter() - t0
    launches["teacher_forced"] = _launch_counts()
    out = {"arch": cfg.name, "n_layers": RING_LAYERS,
           "n_layers_of": configs.get(WINDOW_ARCH).n_layers,
           "windows": windows, "d_model": cfg.d_model, "batch": RING_B,
           "prompt_len": p_len, "max_seq": max_seq, "ring_positions": ring,
           "wrapped_steps": p_len - ring, "dtype": "float32",
           "param_bytes": _param_bytes(params), "prefill_s": prefill_s,
           "teacher_forced_s": tf_s,
           "decode_ms_per_step": tf_s / p_len * 1e3,
           "decode_bound_ms_per_step": _decode_bound_ms(cfg, params, p_len,
                                                        batch=RING_B),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "forward_vs_decode": _forward_vs_decode("ring check", fwd, dec),
           "launches": launches}
    if ring != cfg.sliding_window or not p_len > ring:
        raise AssertionError(f"ring check: {ring} ring positions for "
                             f"{p_len} steps do not wrap")
    if launches != expect:
        raise AssertionError(f"ring check: launches {launches}, expected "
                             f"{expect}")
    del params, cache
    torch.cuda.empty_cache()
    return out


def _train_argv(ckpt_dir, *extra):
    return ["--arch", TRAIN_ARCH, "--ckpt-dir", ckpt_dir, *extra]


def _train_flops(cfg, b, s) -> dict:
    """The float32 operations a training step of the dense GQA ``cfg``
    must do on ``b`` x ``s`` tokens: 8·N·T for the N weights that enter a
    product (the forward, the forward again where the layer or the CE
    chunk is recomputed, the two products of the backward; the head, or
    embed.T when tied, but not the input embedding, a gather), less the
    recompute of each layer's last product (the MLP's w_out:
    ``torch.utils.checkpoint`` stops a layer's recompute once every tensor
    its backward saved is back, and nothing saves that product's output),
    and the attention's own products over the causal pairs: Q·K and P·V in
    the forward and again in the recompute (4·dk + 4·dv a pair and head),
    and the backward's Q·K, dV, dP, dQ and dK (6·dk + 4·dv)."""
    n_mm = cfg.n_params() - (0 if cfg.tie_embeddings
                             else cfg.vocab * cfg.d_model)
    hd = cfg.resolved_head_dim
    heads_pairs = cfg.n_layers * cfg.n_heads * b * s * (s + 1) // 2
    skipped = 2 * cfg.n_layers * cfg.d_ff * cfg.d_model * b * s
    weights = 8 * n_mm * b * s - skipped
    k6 = heads_pairs * (4 * hd + 4 * hd)
    backward = heads_pairs * (6 * hd + 4 * hd)
    return {"product_params": n_mm, "weight_flops": weights,
            "recompute_not_run_flops": skipped,
            "attention_k6_flops": k6, "attention_backward_flops": backward,
            "flops": weights + k6 + backward}


def _flash_bwd_block_flops(cfg, b, s, block=512) -> int:
    """The products ``flash.flash_bwd`` runs for the causal dense ``cfg``
    at ``b`` x ``s`` over every layer: per block pair it computes (the
    blocks wholly above the diagonal skipped, the diagonal's whole), Q·K,
    dV, dP, dQ and dK (6·dk + 4·dv a pair and head), and D = rowsum(dO·O)
    (2·dv a row and head)."""
    hd = cfg.resolved_head_dim
    pairs = sum(min(block, s - q0) * min(block, s - k0)
                for q0 in range(0, s, block) for k0 in range(0, s, block)
                if k0 < q0 + block)
    return cfg.n_layers * b * cfg.n_heads * (pairs * 10 * hd + 2 * s * hd)


# the aten products whose FLOPs torch.profiler counts (``with_flops``)
PRODUCT_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")


def _train_inputs(cfg):
    """The training path's seeded parameters (requiring grad) and first
    batch on the card, as ``train.run`` draws them."""
    from repro_torch import pytree
    from repro_torch.data.pipeline import DataConfig, ShardedLoader
    from repro_torch.models import layers as L, transformer as T

    gen = torch.Generator(device="cuda").manual_seed(0)
    params = T.init_params(gen, cfg, L.FP32, device="cuda")
    batch = next(ShardedLoader(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S,
                                          global_batch=TRAIN_B)))
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    leaves = pytree.leaves(params)
    for p in leaves:
        p.requires_grad_()
    return params, leaves, batch


def first_step_with_attention_ref(cfg, params, leaves, batch):
    """The training path's first step (``_train_inputs``) with
    ``flash_mha`` replaced by the plain ``attention_ref`` on the card: the
    loss and the gradient's global norm, and the K6 launches it made
    (none)."""
    from repro_torch import pytree
    from repro_torch.models import flash, transformer as T
    from repro_torch.optim import adamw

    kernel_path = T.flash_mha
    T.flash_mha = lambda q, k, v, *, causal=True, window=0, **_: (
        flash.attention_ref(q, k, v, causal=causal, window=window))
    before = _launch_counts()["k6"]
    try:
        loss = T.loss_fn(params, batch, cfg)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        T.flash_mha = kernel_path
    by_id = {id(p): g for p, g in zip(leaves, grads)}
    norm = float(adamw.global_norm(pytree.map_leaves(lambda p: by_id[id(p)],
                                                     params)))
    return float(loss.detach()), norm, _launch_counts()["k6"] - before


def profile_train_step(cfg, params, leaves, batch, flops):
    """Where a training step's time goes: steps of the training path's
    arithmetic (``make_train_step``'s, on ``_train_inputs``) with the loss
    and its gradients and the AdamW update timed apart by CUDA events, the
    first a warm-up, the second timed, the third under ``torch.profiler``
    (its kernels: the products, K6, the rest, the most costly); the
    device's busy share is the traced kernel time over the second step's
    wall time, and the products' rate their FLOPs (``flops``,
    ``_train_flops``: the weights' and the attention backward's, which
    cuBLAS runs) over their device time.

    The traced step also witnesses ``_train_flops``'s weight term on the
    card: the FLOPs that ``torch.profiler`` gives each aten product
    (``PRODUCT_OPS``, from its shapes, ``with_flops``), split into the
    calls that launched a kernel and those that launched none. A
    recomputed layer's last product is such a call: the checkpoint's
    early stop raises as the product saves its inputs, before it runs, so
    the profiler records the call but the card never runs it. The launched
    products (everything the step runs but K6's forward) are held against
    the weight term plus ``flash_bwd``'s block products, and the others
    against the term's ``recompute_not_run_flops``, each within
    ``TRAIN_WITNESS_RTOL``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import pytree
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw

    opt = adamw.init_state(params)
    opt_cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=5,
                                total_steps=TRAIN_STEPS)

    def step():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        t0 = time.perf_counter()
        ev[0].record()
        loss = T.loss_fn(params, batch, cfg)
        grads = torch.autograd.grad(loss, leaves)
        ev[1].record()
        by_id = {id(p): g for p, g in zip(leaves, grads)}
        del grads
        for p in leaves:
            p.requires_grad_(False)
        adamw.apply_updates(params, pytree.map_leaves(lambda p: by_id[id(p)],
                                                      params), opt, opt_cfg)
        ev[2].record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for p in leaves:
            p.requires_grad_(True)
        return wall, ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])

    step()  # warm-up
    wall, grad_ms, adamw_ms = step()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_flops=True) as prof:
        traced_wall, _, _ = step()
    events = prof.key_averages()
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in events if e.device_type == DeviceType.CUDA]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    gemm_us = sum(r[1] for r in rows if "gemm" in r[0].lower())
    k6_us = sum(r[1] for r in rows if "flash_kernel" in r[0])
    products = [e for e in prof.events() if e.name in PRODUCT_OPS]
    ran = [e for e in products if e.device_time_total > 0]
    not_run = [e for e in products if e.device_time_total <= 0]
    ran_flops = sum(e.flops for e in ran)
    not_run_flops = sum(e.flops for e in not_run)
    want_ran = flops["weight_flops"] + _flash_bwd_block_flops(cfg, TRAIN_B,
                                                              TRAIN_S)
    want_not_run = flops["recompute_not_run_flops"]
    witness = {
        "launched_product_calls": len(ran),
        "launched_product_flops": ran_flops,
        "expected_launched_flops": want_ran,
        "launched_rel_diff": (ran_flops - want_ran) / want_ran,
        "product_calls_launching_nothing": len(not_run),
        "their_flops": not_run_flops,
        "expected_flops_launching_nothing": want_not_run,
        "not_run_rel_diff": (not_run_flops - want_not_run) / want_not_run,
        "gemm_kernels": sum(n for k, _, n in rows if "gemm" in k.lower())}
    if (abs(witness["launched_rel_diff"]) > TRAIN_WITNESS_RTOL
            or abs(witness["not_run_rel_diff"]) > TRAIN_WITNESS_RTOL):
        raise AssertionError(f"training step's traced products: {witness}")
    return {
        "step_s": wall, "traced_step_s": traced_wall,
        "loss_and_gradients_ms": grad_ms, "adamw_ms": adamw_ms,
        "kernel_ms": busy_us / 1e3,
        "device_busy_share": busy_us * 1e-6 / wall if busy_us else None,
        "kernels": sum(r[2] for r in rows),
        "products_ms": gemm_us / 1e3,
        "products_tflop_per_s": (
            (flops["weight_flops"] + flops["attention_backward_flops"])
            / (gemm_us * 1e-6) / 1e12 if gemm_us else None),
        "k6_ms": k6_us / 1e3,
        "other_kernels_ms": (busy_us - gemm_us - k6_us) / 1e3,
        "top_kernels_ms": [(k[:80], us / 1e3, n) for k, us, n in rows[:10]],
        "products_witness": witness,
    }


def run_train_path():
    """The training phase: ``train.run`` (the port's ``train.main`` with
    its whole record) on qwen3-14b at full width, ``TRAIN_LAYERS`` of its
    40 layers, ``TRAIN_STEPS`` steps of ``TRAIN_B`` x ``TRAIN_S`` tokens in
    float32, the K6-K9 counts read around it; every loss finite, the
    first within 3 of ln(vocab), no recovery, two K6 launches a layer a
    step (forward and recomputed backward), no other kernel. Then the
    first step again with ``attention_ref`` in K6's place (its loss within
    ``TRAIN_LOSS_RTOL``, its gradient norm within ``TRAIN_NORM_RTOL``), and
    the resume check on a reduced qwen3-14b (10 straight steps against 5 +
    resume + 5 at ``RESUME_RTOL``). Step seconds are the median of steps
    2-5, beside the bound ``_train_flops`` / the card's float32 rate, and
    where one step's time goes (``profile_train_step``)."""
    import shutil

    from repro_torch.configs import base as configs
    from repro_torch.launch import train

    ckpt = os.path.join(ROOT, "build", "train_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    t0 = time.perf_counter()
    run = train.run(_train_argv(
        os.path.join(ckpt, "full"), "--n-layers", str(TRAIN_LAYERS),
        "--batch", str(TRAIN_B), "--seq", str(TRAIN_S), "--steps",
        str(TRAIN_STEPS), "--ckpt-every", str(TRAIN_STEPS + 1)))
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = _launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg, losses = run.cfg, run.losses
    want = {"k6": 2 * TRAIN_LAYERS * TRAIN_STEPS, "k7": 0, "k8": 0, "k9": 0,
            "k10": 0}
    if launches != want:
        raise AssertionError(f"training path launched {launches}, expected "
                             f"{want}")
    if run.recoveries:
        raise AssertionError(f"training path: {run.recoveries} recoveries")
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"training path: losses {losses}")
    if abs(losses[0] - math.log(cfg.vocab)) > 3.0:
        raise AssertionError(f"training path: first loss {losses[0]} not "
                             f"within 3 of ln({cfg.vocab})")
    torch.cuda.empty_cache()
    inputs = _train_inputs(cfg)
    ref_loss, ref_norm, ref_k6 = first_step_with_attention_ref(cfg, *inputs)
    first = run.metrics[0]
    loss_rel = abs(first["loss"] - ref_loss) / abs(ref_loss)
    norm_rel = abs(first["grad_norm"] - ref_norm) / abs(ref_norm)
    if ref_k6 or loss_rel > TRAIN_LOSS_RTOL or norm_rel > TRAIN_NORM_RTOL:
        raise AssertionError(
            f"training path's first step against attention_ref: loss "
            f"{first['loss']} vs {ref_loss} ({loss_rel}), grad norm "
            f"{first['grad_norm']} vs {ref_norm} ({norm_rel}), {ref_k6} K6 "
            f"launches in the plain step")
    torch.cuda.empty_cache()
    flops = _train_flops(cfg, TRAIN_B, TRAIN_S)
    breakdown = profile_train_step(cfg, *inputs, flops)
    del inputs
    torch.cuda.empty_cache()

    reduced = ["--reduced", "--batch", "2", "--seq", "64", "--ckpt-every",
               "5"]
    straight = train.main(_train_argv(os.path.join(ckpt, "a"), *reduced,
                                      "--steps", "10"))
    train.main(_train_argv(os.path.join(ckpt, "b"), *reduced, "--steps", "5",
                           "--total-steps", "10"))
    resumed = train.main(_train_argv(os.path.join(ckpt, "b"), *reduced,
                                     "--steps", "10", "--resume"))
    resume_rel = max(abs(a - b) / abs(a)
                     for a, b in zip(straight[5:], resumed))
    if len(resumed) != 5 or resume_rel > RESUME_RTOL:
        raise AssertionError(f"resume on the card: {straight[5:]} against "
                             f"{resumed}")
    shutil.rmtree(ckpt, ignore_errors=True)

    step_s = float(np.median(run.step_seconds[1:]))
    n_params = cfg.n_params()
    tokens = TRAIN_B * TRAIN_S
    f32 = _f32_flops_per_s()
    bound_s = flops["flops"] / f32
    return {
        "arch": cfg.name,
        "layers": f"{TRAIN_LAYERS} of {configs.get(TRAIN_ARCH).n_layers} "
                  f"(depth "
                  f"cut to fit params, grads and AdamW's moments in "
                  f"float32 on one card)",
        "batch": TRAIN_B, "seq": TRAIN_S, "steps": TRAIN_STEPS,
        "params": n_params, "losses": losses,
        "first_loss_minus_ln_vocab": losses[0] - math.log(cfg.vocab),
        "grad_norms": [m["grad_norm"] for m in run.metrics],
        "recoveries": run.recoveries, "launches": launches,
        "k6_launches_per_step": launches["k6"] / TRAIN_STEPS,
        "step_seconds": run.step_seconds,
        "step_s_median_of_2_to_5": step_s,
        "tokens_per_s": tokens / step_s, "peak_gb": peak_gb,
        "flop_bound": {**flops, "basis": "8·N·T over the weights that "
                       "enter products (not the input embedding, a gather): "
                       "forward, recomputed forward (less each layer's "
                       "last product, whose recompute the checkpoint stops "
                       "before) and backward; plus the attention's products "
                       "over the causal pairs",
                       "f32_flops_per_s": f32, "bound_s": bound_s,
                       "share": bound_s / step_s},
        "step_breakdown": breakdown,
        "first_step_against_attention_ref": {
            "loss": first["loss"], "ref_loss": ref_loss,
            "loss_rel_err": loss_rel, "grad_norm": first["grad_norm"],
            "ref_grad_norm": ref_norm, "grad_norm_rel_err": norm_rel},
        "resume": {"arch": TRAIN_ARCH + " reduced", "straight": straight,
                   "resumed": resumed, "max_rel_err": resume_rel},
        "host_s": host_s, "card": _card_line(),
    }


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _dist_run(cfg, mesh=None):
    """``DIST_STEPS`` steps of ``make_train_step`` through the
    fault-tolerant loop from the training path's seeded state and batches
    (``train.run``'s), on plain tensors or, with ``mesh``, on DTensors
    distributed by ``partition`` with the mesh context and the
    layer-boundary sharding set (the loop given the state's shardings).
    Returns the metrics, step seconds, peak bytes, K6-K9 launches, K6's
    calls on local shards and the loop's recoveries."""
    import tempfile

    from repro_torch.data.pipeline import DataConfig, ShardedLoader
    from repro_torch.distributed import partition
    from repro_torch.distributed.fault import FaultConfig, FaultTolerantLoop
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train
    from repro_torch.models import flash, layers as L, shardctx
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = train.build_state(cfg, L.FP32, device="cuda")
    shardings = None
    if mesh is not None:
        shardctx.set_mesh_ctx(mesh, ("data",))
        T.set_activation_sharding(partition.P(("data",), "model", None))
        specs = partition.validate_divisibility(
            partition.param_specs(state["params"]), state["params"], mesh)
        specs = {"params": specs,
                 "opt": {"m": specs, "v": specs, "step": partition.P()}}
        state = partition.distribute(state, specs, mesh)
        shardings = partition.shardings_of(specs, mesh)
    bspec = None if mesh is None else partition.batch_spec(mesh)
    step = steps_lib.make_train_step(cfg, adamw.AdamWConfig(), L.FP32)
    seconds = []

    def step_fn(st, batch):
        t0 = time.perf_counter()
        b = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
        if bspec is not None:
            b = partition.distribute(b, bspec, mesh)
        params, opt, m = step(st["params"], st["opt"], b)
        m = {k: float(v) for k, v in m.items()}
        seconds.append(time.perf_counter() - t0)
        return {"params": params, "opt": opt}, m

    loader = ShardedLoader(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S,
                                      global_batch=TRAIN_B))
    _zero_launch_counts()
    flash._flash_sharded.calls = 0
    try:
        with tempfile.TemporaryDirectory() as d:
            loop = FaultTolerantLoop(
                step_fn, state, loader,
                FaultConfig(checkpoint_dir=d,
                            checkpoint_every=DIST_STEPS + 1),
                state_shardings=shardings)
            metrics = loop.run(DIST_STEPS)
        torch.cuda.synchronize()
        sharded_leaves = sum(type(x).__name__ == "DTensor"
                             for x in _leaves(loop.state))
        return {"metrics": metrics, "step_seconds": seconds,
                "peak_bytes": torch.cuda.max_memory_allocated(),
                "launches": _launch_counts(),
                "k6_local_shard_calls": flash._flash_sharded.calls,
                "dtensor_leaves": sharded_leaves,
                "recoveries": loop.recoveries}
    finally:
        shardctx.clear_mesh_ctx()
        T.set_activation_sharding(None)
        del state
        torch.cuda.empty_cache()


def _leaves(tree):
    from repro_torch import pytree
    return pytree.leaves(tree)


def run_distribution_path():
    """The distribution-and-account phase.

    (a) The training path's model (qwen3-14b at full width, 4 of its 40
    layers, B=4, S=1024, float32) through ``DIST_STEPS`` steps of
    ``make_train_step`` unsharded, then on a (1, 1) ``("data", "model")``
    mesh under NCCL with a world of 1 (params, moments and batches
    distributed by ``partition``, ``set_mesh_ctx`` and the activation
    sharding set): losses and gradient norms within ``DIST_RTOL``, 8 K6
    launches a step, each on local shards, no recovery; step seconds and
    peak GB beside the unsharded run's. The process group is destroyed
    before (b).
    (b) The same step through the dry run's account (``lower_cell`` on a
    fake (1, 1) mesh, float32): its dot FLOPs within ``DIST_FLOPS_RTOL``
    of ``_train_flops``, its peak bytes within ``DIST_PEAK_RTOL`` of (a)'s
    measured peak, and its compute term at the card's float32 rate against
    (a)'s measured step (a ratio, no limit).
    (c) ``DIST_CELLS`` through ``run_cell`` on the 16x16 production mesh
    (fake, 256 ranks): per-device peak GB against the card's memory, the
    three roofline terms and the dominant one."""
    import dataclasses as dc

    import torch.distributed as dist

    from repro_torch.configs import base as configs
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.models import layers as L

    cfg = dc.replace(configs.get(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    plain = _dist_run(cfg)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = mesh_lib.make_mesh((1, 1), ("data", "model"), "cuda")
        sharded = _dist_run(cfg, mesh)
    finally:
        dist.destroy_process_group()
    pairs = [(a[k], b[k]) for a, b in zip(plain["metrics"],
                                          sharded["metrics"])
             for k in ("loss", "grad_norm")]
    rel = max(abs(a - b) / abs(a) for a, b in pairs)
    want = {"k6": 2 * TRAIN_LAYERS * DIST_STEPS, "k7": 0, "k8": 0, "k9": 0,
            "k10": 0}
    for run in (plain, sharded):
        if run["launches"] != want or run["recoveries"]:
            raise AssertionError(f"distribution phase: launches "
                                 f"{run['launches']} (expected {want}), "
                                 f"{run['recoveries']} recoveries")
    if (sharded["k6_local_shard_calls"] != want["k6"]
            or not sharded["dtensor_leaves"] or plain["dtensor_leaves"]):
        raise AssertionError(f"distribution phase: {sharded['k6_local_shard_calls']} "
                             f"K6 calls on local shards, "
                             f"{sharded['dtensor_leaves']} DTensor leaves")
    if not all(math.isfinite(a) for a, _ in pairs) or rel > DIST_RTOL:
        raise AssertionError(f"distribution phase: sharded steps {pairs} "
                             f"differ by {rel} > {DIST_RTOL}")
    step_s = float(np.median(sharded["step_seconds"][1:]))
    plain_step_s = float(np.median(plain["step_seconds"][1:]))

    # (b) the account of the same step, on a fake (1, 1) mesh
    shape = ShapeSpec("train_b4_s1024", TRAIN_S, TRAIN_B, "train")
    with mesh_lib.fake_world(1):
        acct = dryrun.lower_cell(cfg, shape, mesh_lib.make_mesh(
            (1, 1), ("data", "model"), "cpu"), dt=L.FP32)
    flops = _train_flops(cfg, TRAIN_B, TRAIN_S)
    dot = acct["roofline"]["flops_per_device"]
    flops_rel = (dot - flops["flops"]) / flops["flops"]
    peak_acct = acct["memory"]["peak_bytes_per_device_est"]
    peak_rel = (peak_acct - sharded["peak_bytes"]) / sharded["peak_bytes"]
    compute_s = dot / _f32_flops_per_s()
    if abs(flops_rel) > DIST_FLOPS_RTOL or abs(peak_rel) > DIST_PEAK_RTOL:
        raise AssertionError(
            f"distribution phase: the account's dot FLOPs {dot} against "
            f"{flops['flops']} ({flops_rel}), its peak {peak_acct} against "
            f"the card's {sharded['peak_bytes']} ({peak_rel})")

    # (c) production cells on the 16x16 mesh
    cells = {}
    for arch, shape_name in DIST_CELLS:
        t0 = time.perf_counter()
        res = dryrun.run_cell(arch, shape_name, False,
                              os.path.join(ROOT, "build", "dryrun"))
        if "error" in res or "skipped" in res:
            raise AssertionError(f"dry run {arch} {shape_name}: "
                                 f"{dryrun.status(res)}")
        r = res["roofline"]
        cells[f"{arch} {shape_name} 16x16"] = {
            "peak_gb_per_device":
                res["memory"]["peak_bytes_per_device_est"] / 1e9,
            "card_gb": torch.cuda.get_device_properties(0).total_memory / 1e9,
            "state_gb_per_device":
                res["memory"]["argument_size_in_bytes"] / 1e9,
            **{k: r[k] for k in ("compute_s", "memory_s", "collective_s",
                                 "dominant", "flops_per_device",
                                 "bytes_per_device",
                                 "collective_bytes_per_device",
                                 "collective_per_op",
                                 "useful_flops_ratio")},
            "account_s": time.perf_counter() - t0}
    return {
        "arch": cfg.name, "layers": TRAIN_LAYERS, "batch": TRAIN_B,
        "seq": TRAIN_S, "steps": DIST_STEPS, "mesh": "1x1 (NCCL, world 1)",
        "losses": [m["loss"] for m in sharded["metrics"]],
        "grad_norms": [m["grad_norm"] for m in sharded["metrics"]],
        "max_rel_err": rel, "rtol": DIST_RTOL,
        "k6_launches": sharded["launches"]["k6"],
        "k6_launches_per_step": sharded["launches"]["k6"] / DIST_STEPS,
        "k6_local_shard_calls": sharded["k6_local_shard_calls"],
        "dtensor_leaves": sharded["dtensor_leaves"],
        "recoveries": sharded["recoveries"],
        "step_s": step_s, "plain_step_s": plain_step_s,
        "step_seconds": sharded["step_seconds"],
        "plain_step_seconds": plain["step_seconds"],
        "peak_gb": sharded["peak_bytes"] / 1e9,
        "plain_peak_gb": plain["peak_bytes"] / 1e9,
        "account": {
            "dot_flops": dot, "train_flops": flops["flops"],
            "dot_flops_rel_diff": flops_rel,
            "attention_blocks_note": "the plain flash loop computes all 4 "
                                     "block pairs of the forward (and its "
                                     "recompute) where the causal bound "
                                     "counts S(S+1)/2 pairs, and the plain "
                                     "backward 3 of 4",
            "peak_gb": peak_acct / 1e9, "peak_rel_diff": peak_rel,
            "state_gb": acct["memory"]["argument_size_in_bytes"] / 1e9,
            "bytes": acct["roofline"]["bytes_per_device"],
            "compute_s_at_f32_rate": compute_s,
            "compute_s_over_step_s": compute_s / step_s,
            "account_s": acct["setup_s"] + acct["run_s"]},
        "production_cells": cells,
        "card": _card_line(),
    }


def sequential_raw_ref(src, val, valid, dst, memory):
    """The producer loop, then the consumer loop, in program order: each
    landed store overwrites its word, the last one winning, and each
    consumer then reads its word (``dst`` in range). Returns
    ``(values, hits)``, a hit being a word some landed store wrote."""
    order = torch.arange(src.shape[0], device=src.device)
    landed = valid == 1
    last = torch.full(memory.shape, -1, dtype=torch.int64,
                      device=src.device)
    last.scatter_reduce_(0, src[landed].long(), order[landed], "amax")
    after = torch.where(last >= 0, val[last.clamp(min=0)], memory)
    a = dst.long()
    return after[a], last[a] >= 0


def run_du_path(plans):
    """The DU-kernel cross-checks over the main path's plans, then
    ``fused_raw_loops`` end to end; returns a result dict with the K2
    and K3 calls made."""
    from repro_torch.crosschecks import frontier_crosschecks
    from repro_torch.kernels.fused_stream.ops import fused_raw_loops

    out = {"checks": {}, "k2_calls": 0, "k3_calls": 0}
    for name, (plan, arrays) in plans.items():
        checks = frontier_crosschecks(name, plan, arrays)
        if not checks:
            raise AssertionError(f"{name}: no cross-check ran")
        out["checks"][name] = checks
        out["k2_calls"] += len(checks)
        out["k3_calls"] += sum(c.startswith("fused_stream") for c in checks)
    src, val, valid, dst, memory = k3_inputs(7)
    t0 = time.perf_counter()
    vals, hits = fused_raw_loops(src, val, dst, memory, valid)
    torch.cuda.synchronize()
    out["fused_raw_loops_s"] = time.perf_counter() - t0
    out["k2_calls"] += 1
    out["k3_calls"] += 1
    want_v, want_h = sequential_raw_ref(
        *(torch.from_numpy(x).cuda() for x in (src, val, valid, dst, memory))
    )
    if not (torch.equal(vals.view(torch.int64), want_v.view(torch.int64))
            and torch.equal(hits, want_h)):
        raise AssertionError("fused_raw_loops != the sequential loops")
    out["fused_raw_loops"] = {"S": K3_S, "D": K3_D, "M": K3_M,
                              "hits": int(hits.sum().item())}
    return out


def run_substrate_path(device="cuda"):
    """hist+add and matpower at 8x through the substrate ops: ``hist_add``
    on the program's ``d1``/``d2`` must give the oracle's ``hsum`` bit for
    bit (counts far below 2**24), and four chained ``spmv_from_csr`` the
    oracle's final ``y`` (A^3 x0) and ``x`` (A^4 x0) within the float32
    bound of a k-fold chained matvec, ((1 + γ)^k - 1)·|A|^k|x0| with
    γ = γ_{W+3} (W products and sums, the rounding of vals and of x), plus
    the float64 oracle's own, much smaller, bound. Returns a result dict
    with the K4 and K5 calls made."""
    from repro_torch.core import loopir as ir, programs
    from repro_torch.kernels.csr_spmv.ops import spmv_from_csr
    from repro_torch.kernels.histogram.ops import hist_add

    out = {"k4_calls": 0, "k5_calls": 0}
    prog, arrays, params = programs.get("hist+add").make(SCALES_8X["hist+add"])
    oracle = ir.interpret(prog, arrays, params)
    h = hist_add(arrays["d1"], arrays["d2"], n_bins=params["bins"],
                 device=device)
    out["k5_calls"] += 2
    if h.double().cpu().numpy().tobytes() != oracle["hsum"].tobytes():
        raise AssertionError("hist_add != the oracle's hsum")
    out["hist_add"] = {"n": params["n"], "bins": params["bins"],
                       "max_bin": float(h.max().item())}

    prog, arrays, params = programs.get("matpower").make(SCALES_8X["matpower"])
    oracle = ir.interpret(prog, arrays, params)
    rp, ci, val = arrays["rp"], arrays["cidx"], arrays["val"]
    w = int(np.diff(rp).max())
    mag = np.abs(arrays["x"])
    cur = torch.as_tensor(arrays["x"], device=device)
    rel_err = {}
    for k in range(1, 2 * params["powers"] + 1):
        cur = spmv_from_csr(rp, ci, val, cur, device=device)
        out["k4_calls"] += 1
        mag = _csr_abs_matvec(rp, ci, val, mag)
        want = {3: oracle["y"], 4: oracle["x"]}.get(k)
        if want is None:
            continue
        tol = ((1 + _gamma(w + 3, F32_UNIT)) ** k - 1
               + (1 + _gamma(w, F64_UNIT)) ** k - 1) * mag
        err = np.abs(cur.cpu().numpy() - want)
        if not (err <= tol).all():
            raise AssertionError(f"matpower A^{k} x: float32 error above "
                                 f"its bound")
        rel_err[f"A^{k}x"] = float((err / tol).max())
    out["matpower"] = {"nodes": params["nodes"], "W": w,
                       "max_err_over_bound": rel_err}
    return out


def spec_oracle(name, arrays, params):
    """The final arrays of a speculative program from the hand-written
    oracles of ``kernels/dynloop/ref.py``."""
    from repro_torch.kernels.dynloop import ref

    if name == "spmv_ldtrip":
        rowlen, y = ref.spmv_ldtrip_ref(arrays["deg"], arrays["rp"],
                                        arrays["cidx"], arrays["val"],
                                        arrays["x"])
        return {"rowlen": rowlen, "y": y}
    if name == "bfs_front":
        foff, visit = ref.bfs_front_ref(arrays["off0"], arrays["front"],
                                        arrays["nodeval"],
                                        len(arrays["visit"]))
        return {"foff": foff, "visit": visit}
    if name == "chase_sum":
        return {"out": ref.chase_sum_ref(arrays["nxt"], arrays["w"],
                                         params["steps"])}
    return {"out": ref.strided_scan_ref(arrays["ptr"], arrays["w"],
                                        params["n"])}


def stream_oracle(name, arrays, params):
    """The final arrays of a streaming program from the hand-written
    oracles of ``kernels/dynloop/ref.py``."""
    from repro_torch.kernels.dynloop import ref

    if name == "stream_dot":
        return {"out": ref.stream_dot_ref(arrays["a"], arrays["bv"],
                                          arrays["out"], params["nb"],
                                          params["k"])}
    if name == "filter_pipe":
        return {"y": ref.filter_pipe_ref(arrays["x"], arrays["y"])}
    return {"z": ref.stream_join_ref(arrays["u"], arrays["w"], arrays["z"])}


def run_spec_path(device="cuda"):
    """The four speculative programs at 8x through ``execute`` on the
    card, bit-identical to both oracles. Returns the rows and the (M, S,
    W) of every wave segment the runs report."""
    from repro_torch.core import executor, loopir as ir, programs

    rows, shapes = [], []
    for name in programs.SPEC_KERNELS:
        prog, arrays, params = programs.get(name).make(SPEC_SCALES_8X[name])
        res = executor.execute(prog, arrays, params, speculation="auto",
                               backend="torch", device=device)
        if not _bits_equal(res.arrays, ir.interpret(prog, arrays, params)):
            raise AssertionError(f"{name}: differs from the oracle")
        if not _bits_equal(res.arrays, spec_oracle(name, arrays, params)):
            raise AssertionError(f"{name}: differs from kernels/dynloop/ref.py")
        run = res.run
        row = {
            "program": name, "scale": SPEC_SCALES_8X[name],
            "n_requests": res.stats.n_requests, "n_waves": res.stats.n_waves,
            "n_steps": run.n_steps, "n_segments": run.n_segments,
            "resolve_s": run.resolve_s, "device_s": run.device_s,
        }
        print(json.dumps(row), flush=True)
        rows.append(row)
        shapes.extend((res.plan.mem_size + 1, s, w) for s, w in run.segments)
    return rows, shapes


def run_stream_path(device="cuda"):
    """The three streaming programs at their default scales through
    ``execute`` at FIFO depths 1, 2 and 4, bit-identical to both oracles,
    wave counts non-increasing in depth. Returns the rows and the (M, S,
    W) of every wave segment the runs report."""
    from repro_torch.core import executor, loopir as ir, programs

    rows, shapes = [], []
    for name in programs.STREAM_KERNELS:
        bench = programs.get(name)
        prog, arrays, params = bench.make(bench.default_scale)
        oracle = ir.interpret(prog, arrays, params)
        hand = stream_oracle(name, arrays, params)
        waves = []
        for depth in FIFO_DEPTHS:
            res = executor.execute(prog, arrays, params, fifo_depth=depth,
                                   backend="torch", device=device)
            if not (_bits_equal(res.arrays, oracle)
                    and _bits_equal(res.arrays, hand)):
                raise AssertionError(f"{name}@{depth}: differs from an oracle")
            waves.append(res.stats.n_waves)
            shapes.extend((res.plan.mem_size + 1, s, w)
                          for s, w in res.run.segments)
            row = {
                "program": name, "scale": bench.default_scale,
                "fifo_depth": depth, "n_requests": res.stats.n_requests,
                "n_waves": res.stats.n_waves, "n_steps": res.run.n_steps,
                "n_segments": res.run.n_segments,
                "resolve_s": res.run.resolve_s, "device_s": res.run.device_s,
            }
            print(json.dumps(row), flush=True)
            rows.append(row)
        if waves != sorted(waves, reverse=True):
            raise AssertionError(f"{name}: waves grow with depth: {waves}")
    return rows, shapes


def run_spec_simulate():
    """The four speculative programs at 8x through ``simulate()`` (event
    engine) in STA and in FUS2 under each predictor: arrays bit-identical
    to the oracle, cycles equal to the reference's (``SPEC_CYCLES``)."""
    from repro_torch.core import loopir as ir, programs, simulator

    rows = []
    for name in programs.SPEC_KERNELS:
        prog, arrays, params = programs.get(name).make(SPEC_SCALES_8X[name])
        oracle = ir.interpret(prog, arrays, params)
        row = {"program": name, "scale": SPEC_SCALES_8X[name], "host_s": 0.0}
        for key in ("STA",) + PREDICTORS:
            mode, pred = ("STA", "auto") if key == "STA" else ("FUS2", key)
            t0 = time.perf_counter()
            res = simulator.simulate(prog, arrays, params, mode=mode,
                                     engine="event", speculation="auto",
                                     predictor=pred)
            row["host_s"] += time.perf_counter() - t0
            if not _bits_equal(res.arrays, oracle):
                raise AssertionError(f"simulate {name}/{key} != oracle")
            row[key] = res.cycles
        if {k: row[k] for k in SPEC_CYCLES[name]} != SPEC_CYCLES[name]:
            raise AssertionError(f"simulate {name}: cycles differ from the "
                                 f"reference's {SPEC_CYCLES[name]}")
        row["fus2_vs_sta"] = {p: row["STA"] / row[p] for p in PREDICTORS}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def run_simulate():
    """The nine Table-1 programs at 1x through ``simulate()`` in the four
    modes (event engine), arrays bit-identical to the oracle, FUS2's
    also to ``execute(backend="torch")`` on the card. Returns the
    per-program rows and the wave segments the executions reported."""
    from repro_torch.core import executor, loopir as ir, programs, simulator

    rows, segments = [], 0
    for name in programs.TABLE1:
        prog, arrays, params = programs.get(name).make(SCALES_1X[name])
        oracle = ir.interpret(prog, arrays, params)
        row = {"program": name, "scale": SCALES_1X[name], "host_s": 0.0}
        for mode in MODES:
            t0 = time.perf_counter()
            res = simulator.simulate(prog, arrays, params, mode=mode,
                                     engine="event")
            row["host_s"] += time.perf_counter() - t0
            if not _bits_equal(res.arrays, oracle):
                raise AssertionError(f"simulate {name}/{mode} != oracle")
            row[mode] = res.cycles
        row["forwards"] = res.forwards
        ex = executor.execute(prog, arrays, params, backend="torch")
        if not _bits_equal(ex.arrays, res.arrays):
            raise AssertionError(f"{name}: execute(torch) != simulate FUS2")
        segments += ex.run.n_segments
        row["fus2_vs_sta"] = row["STA"] / row["FUS2"]
        row["fus2_vs_lsq"] = row["LSQ"] / row["FUS2"]
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows, segments


def run_lint():
    """``python -m repro_torch.analysis.lint --all``, in this process:
    exit 0 and its output byte for byte the committed fixture."""
    import contextlib
    import io

    from repro_torch.analysis import lint

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = lint.main(["--all"])
    host_s = time.perf_counter() - t0
    with open(LINT_FIXTURE, encoding="utf-8") as f:
        same = buf.getvalue() == f.read()
    if rc != 0 or not same:
        raise AssertionError(f"lint --all: exit {rc}, output equal to the "
                             f"fixture: {same}")
    return {"exit": rc, "equal_to_fixture": same,
            "summary": buf.getvalue().splitlines()[-1], "host_s": host_s}


def _lying_hint_program(n=8):
    """Address (n-1)-i strictly decreases inside the innermost loop while
    the hint swears it is monotonic."""
    from repro_torch.core import loopir as ir

    hint = ir.MonotonicHint(innermost_monotonic=True)
    loop = ir.Loop("i", ir.Const(n), (
        ir.Load("ld_a", "A", ir.Bin("-", ir.Const(n - 1), ir.Var("i")),
                hint=hint),
        ir.Store("st_o", "out", ir.Var("i"), ir.LoadVal("ld_a")),
    ))
    arrays = {"A": np.arange(n, dtype=np.float64),
              "out": np.zeros(n, dtype=np.float64)}
    return ir.Program("lying_hint", loops=(loop,)), arrays, {}


def _omitted_reset_program(outer=3, inner=4, resets=frozenset()):
    """Address j resets every outer iteration; the hint's explicit
    ``non_monotonic_outer`` omits depth 1 (unless ``resets`` admits it),
    so every reset is a lie."""
    from repro_torch.core import loopir as ir

    hint = ir.MonotonicHint(innermost_monotonic=True,
                            non_monotonic_outer=resets)
    loop = ir.Loop("i", ir.Const(outer), (
        ir.Loop("j", ir.Const(inner), (
            ir.Load("ld_a", "A", ir.Var("j"), hint=hint),
            ir.Store("st_o", "out", ir.Var("i") * inner + ir.Var("j"),
                     ir.LoadVal("ld_a")),
        )),
    ))
    arrays = {"A": np.arange(inner, dtype=np.float64),
              "out": np.zeros(outer * inner, dtype=np.float64)}
    return ir.Program("omitted_reset", loops=(loop,)), arrays, {}


def run_hint_sanitizer(kernel, device="cuda"):
    """The two contradictory-hint programs through ``execute(...,
    validate_hints=True)`` on the card and ``simulate(mode="FUS2")`` under
    both engines: each raises ``HintViolation`` at the same op, address
    and previous address, and at the same instance once execute's stream
    position is mapped through the op's trace. The sanitizer checks the
    plan before its first step, so these launch the wave kernel no time.
    Then the hint that admits the reset: the sanitizer passes and the
    program runs through the wave kernel, arrays equal to the oracle.
    Returns the rows and the (M, S, W) of that run's segments."""
    from repro_torch.analysis import deps
    from repro_torch.core import dae, executor, loopir as ir, schedule
    from repro_torch.core import simulator

    def violation(fn):
        try:
            fn()
        except deps.HintViolation as e:
            return e.op_id, e.instance, e.addr, e.prev_addr
        raise AssertionError("no HintViolation raised")

    rows = []
    for make in (_lying_hint_program, _omitted_reset_program):
        prog, arrays, params = make()
        before = kernel.wave_loop.launches
        op, pos, addr, prev = violation(lambda: executor.execute(
            prog, arrays, params, validate_hints=True, device=device))
        if kernel.wave_loop.launches != before:
            raise AssertionError(f"{prog.name}: launched before the check")
        trace = schedule.trace_program(prog, dae.decouple(prog), arrays,
                                       params, mode="auto")[op]
        want = (op, tuple(int(v) for v in trace.sched[pos]), addr, prev)
        if int(trace.addr[pos]) != addr:
            raise AssertionError(f"{prog.name}: position {pos} is not at "
                                 f"address {addr}")
        for engine in ("event", "cycle"):
            got = violation(lambda: simulator.simulate(
                prog, arrays, params, mode="FUS2", engine=engine,
                validate_hints=True))
            if got != want:
                raise AssertionError(f"{prog.name}: {engine} engine raised "
                                     f"at {got}, execute at {want}")
        rows.append({"program": prog.name, "op": op, "position": int(pos),
                     "instance": list(want[1]), "addr": addr,
                     "prev_addr": prev, "engines": ["event", "cycle"]})
    prog, arrays, params = _omitted_reset_program(resets=frozenset({1}))
    res = executor.execute(prog, arrays, params, validate_hints=True,
                           device=device)
    if not _bits_equal(res.arrays, ir.interpret(prog, arrays, params)):
        raise AssertionError("admitted reset: arrays differ from the oracle")
    rows.append({"program": "omitted_reset, reset admitted",
                 "sanitizer": "passed", "n_segments": res.run.n_segments})
    m = res.plan.mem_size + 1
    return rows, [(m, s, w) for s, w in res.run.segments]


def build_dse_spec(dse, programs, scales):
    """The evidence sweep: nine kernels x (STA/FUS1/FUS2 x three trace
    modes x six sizings), plus an STA grid on the cycle engine (STA
    ignores the engine, so the planner folds it)."""
    kernels = list(programs.TABLE1)
    return dse.SweepSpec(
        kernels=kernels, scales=scales, modes=("STA", "FUS1", "FUS2"),
        trace_modes=("auto", "compiled", "interp"), sizings=DSE_SIZINGS,
        extra=(dse.SweepSpec(
            kernels=kernels, scales=scales, modes=("STA",),
            engines=("cycle",), trace_modes=("auto", "interp"),
            sizings=DSE_SIZINGS,
        ),),
    )


def _sim_sig(res) -> tuple:
    return (res.cycles, res.dram_bursts, res.dram_requests, res.forwards,
            res.squashed,
            tuple(sorted((k, v.dtype.str, v.shape, v.tobytes())
                         for k, v in res.arrays.items())))


def _sweep_sigs(res) -> list:
    volatile = ("cached", "run_wall_s")
    rows = [{k: v for k, v in r.items() if k not in volatile}
            for r in res.rows()]
    return [json.dumps(rows, sort_keys=True, default=str)] + [
        _sim_sig(pr.result) for pr in res.points]


def run_dse_sweep(scales=SCALES_1X, workers=DSE_WORKERS, cache=DSE_CACHE):
    """The evidence sweep, cold into an empty cache; one point of each
    group and every FUS2 point of hist+add against a standalone
    ``simulate()``; a 2-way shard plus merge against the whole; and a
    warm resume that must execute nothing."""
    import shutil

    from repro_torch import dse
    from repro_torch.core import programs, simulator
    from repro_torch.launch import analysis

    shutil.rmtree(cache, ignore_errors=True)
    spec = build_dse_spec(dse, programs, scales)
    points = spec.points()
    whole_dir = os.path.join(cache, "whole")
    t0 = time.perf_counter()
    cold = dse.sweep(spec, cache_dir=whole_dir, workers=workers)
    cold_s = time.perf_counter() - t0

    groups = dse.plan(points)
    held = {g.runs[0].point_indices[0] for g in groups}
    held |= {i for i, p in enumerate(points)
             if p.kernel == "hist+add" and p.mode == "FUS2"}
    t0 = time.perf_counter()
    for i in sorted(held):
        p = points[i]
        prog, arrays, params = programs.get(p.kernel).make(p.scale)
        alone = simulator.simulate(
            prog, arrays, params, mode=p.mode, sim=p.sim_params(),
            engine=p.engine, trace_mode=p.trace_mode,
            speculation=p.speculation, predictor=p.predictor,
            static_prune=p.static_prune,
        )
        if _sim_sig(cold.points[i].result) != _sim_sig(alone):
            raise AssertionError(f"sweep point {p.point_id} differs from "
                                 "standalone simulate()")
    standalone_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    merged = dse.merge_results([
        dse.sweep_shard(spec, i, 2, workers=workers,
                        cache_dir=os.path.join(cache, f"shard{i}"))
        for i in range(2)
    ])
    shard_s = time.perf_counter() - t0
    if _sweep_sigs(merged) != _sweep_sigs(cold):
        raise AssertionError("2-way shard + merge differs from the whole")

    t0 = time.perf_counter()
    warm = dse.sweep(spec, cache_dir=whole_dir, workers=workers, resume=True)
    warm_s = time.perf_counter() - t0
    ws = warm.stats
    if ws.n_executed != 0 or ws.n_cache_hits != ws.n_unique_runs:
        raise AssertionError(f"warm resume executed {ws.n_executed} runs")
    if _sweep_sigs(warm) != _sweep_sigs(cold):
        raise AssertionError("warm resume differs from the cold sweep")
    return {
        "points": cold.stats.n_points, "unique_runs": cold.stats.n_unique_runs,
        "groups": len(groups), "cold_cache_hits": cold.stats.n_cache_hits,
        "warm_cache_hits": ws.n_cache_hits, "warm_executed": ws.n_executed,
        "workers": workers, "scales": scales, "cold_s": cold_s,
        "warm_s": warm_s, "shard_merge_2_s": shard_s,
        "standalone_points": len(held), "standalone_s": standalone_s,
        "speedups": analysis.summarize_sweep(cold.rows())["speedups"]["hmean"],
        "card": _card_line(),
    }


def _curves_equal(got: dict, rec: dict) -> bool:
    """Fit curves equal to the record's: every label, best point and
    cycles per iteration exactly, each point's mean relative error to 2
    ulps. The record was written by a Python before 3.12, whose ``sum()``
    of floats rounds each addition where 3.12's compensates; on 3.12 the
    JAX package's ``calibrate`` moves the same two points by one ulp."""
    if got.keys() != rec.keys():
        return False
    for field, g in got.items():
        r = rec[field]
        if g["best"] != r["best"] or g["curve"].keys() != r["curve"].keys():
            return False
        for label, point in g["curve"].items():
            want = r["curve"][label]
            if point["cpi"] != want["cpi"] or (
                    abs(point["err"] - want["err"]) > 2 * math.ulp(want["err"])):
                return False
    return True


def run_calibration(workers=DSE_WORKERS):
    """``dse.calibrate`` at the record's scales with the default grids:
    the fitted fields, the mean relative error (both rounded as the
    record is), the per-kernel results, the iteration counts and both
    fit curves (``_curves_equal``) equal the JAX package's
    ``BENCH_CALIB.json``."""
    from repro_torch import dse

    with open(CALIB_RECORD) as f:
        rec = json.load(f)
    t0 = time.perf_counter()
    fit = dse.calibrate(scales=rec["scales"], workers=workers)
    host_s = time.perf_counter() - t0
    checks = {
        "fitted": fit.fitted == rec["fitted"],
        "mean_rel_err": fit.mean_rel_err == rec["mean_rel_err"],
        "per_kernel": fit.per_kernel == rec["per_kernel"],
        "iters": fit.iters == rec["iters_per_kernel"],
        "fit_curves": _curves_equal(fit.per_field, rec["fit_curves"]),
    }
    if not all(checks.values()):
        raise AssertionError(f"calibration differs from the record: "
                             f"{checks}, fitted {fit.fitted}, mean "
                             f"relative error {fit.mean_rel_err}")
    return {"fitted": fit.fitted, "mean_rel_err": fit.mean_rel_err,
            "scales": fit.scales, "equal_to_record": checks,
            "host_s": host_s, "card": _card_line()}


def _hmean(xs):
    return len(xs) / sum(1.0 / x for x in xs)


def _zero_wave_counts(kernel):
    kernel.wave_loop.launches = 0
    kernel.wave_loop.wide_launches = 0


def _wave_launches(kernel, what: str, shapes) -> dict:
    """The wave kernel's launches since ``_zero_wave_counts``, split by
    path. ``shapes`` holds the (M, S, W) of every segment the runs
    report: one launch each, the ones whose image fits one block's
    shared memory and whose lanes fit its threads on the resident path,
    every other on the wide path."""
    lim = kernel.limits(torch.cuda.current_device())
    one_block = sum(
        m <= lim.words_per_block
        and w <= kernel.RESIDENT_THREADS * kernel.RESIDENT_LANES[-1]
        for m, _, w in shapes)
    got = {"launches": kernel.wave_loop.launches,
           "wide": kernel.wave_loop.wide_launches}
    want = {"launches": len(shapes), "wide": len(shapes) - one_block}
    if got != want or got["launches"] == 0:
        raise AssertionError(f"{what}: wave launches {got}, its segments "
                             f"call for {want}")
    return got


def run_main_path():
    """The nine Table-1 programs through the port's entry point on the
    card, each checked bit for bit against the oracle. Returns the rows,
    the launch shapes, and the plans of the programs the DU path
    cross-checks."""
    from repro_torch.core import executor, loopir as ir, programs
    from repro_torch.crosschecks import FORWARD_PROGRAM, WAVE_PAIRS
    from repro_torch.kernels import wave_exec

    rows, shapes, plans = [], [], {}
    for name in programs.TABLE1:
        prog, arrays, params = programs.get(name).make(SCALES_8X[name])
        res = executor.execute(prog, arrays, params, backend="torch")
        oracle = ir.interpret(prog, arrays, params)
        for k in oracle:
            if res.arrays[k].tobytes() != oracle[k].tobytes():
                raise AssertionError(f"{name}: '{k}' differs from the oracle")
        run = res.run
        row = {
            "program": name, "scale": SCALES_8X[name],
            "n_requests": res.stats.n_requests, "n_steps": run.n_steps,
            "n_segments": run.n_segments, "resolve_s": run.resolve_s,
            "device_s": run.device_s,
        }
        print(json.dumps(row), flush=True)
        rows.append(row)
        m = res.plan.mem_size + 1
        shapes.extend((m, s, w) for s, w in run.segments)
        if name in WAVE_PAIRS or name == FORWARD_PROGRAM:
            plans[name] = (res.plan, arrays)
    prog, arrays, params = programs.get(SEQ_PROGRAM).make(
        SCALES_8X[SEQ_PROGRAM]
    )
    plan = executor.build_wave_plan(prog, arrays, params)
    seq = wave_exec.run_sequential(plan, arrays, max_steps=SEQ_STEPS,
                                   check=True)
    if seq.n_steps != SEQ_STEPS or seq.complete:
        raise AssertionError("run_sequential did not stop at max_steps")
    row = {
        "program": SEQ_PROGRAM, "sequential": True, "n_steps": seq.n_steps,
        "n_segments": seq.n_segments, "resolve_s": seq.resolve_s,
        "device_s": seq.device_s,
    }
    print(json.dumps(row), flush=True)
    rows.append(row)
    shapes.extend((plan.mem_size + 1, s, w) for s, w in seq.segments)
    return rows, shapes, plans


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch import _build
    from repro_torch.kernels.du_hazard import kernel as k2
    from repro_torch.kernels.csr_spmv import kernel as k4
    from repro_torch.kernels.fused_stream import kernel as k3
    from repro_torch.kernels.histogram import kernel as k5
    from repro_torch.kernels.wave_exec import kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    card = _card_line()
    cap = torch.cuda.get_device_capability(0)
    print(f"device: {card}, capability {cap[0]}.{cap[1]}", flush=True)
    if cap != (9, 0):
        raise AssertionError(f"expected a Hopper card (9.0), got {cap}")

    # 2. build, every nvcc at once
    t0 = time.perf_counter()
    took = _build.build_all()
    print(f"build: all {len(took)} kernels in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, sec in took.items():
        print(f"build: {name} nvcc {sec:.2f} s")
        log = _build.library_path(name).with_suffix(".log")
        if log.exists():
            print(log.read_text().strip())

    # 3. kernels against their plain versions (launches here not counted)
    waves = {}
    for seed, (name, (m, s, w)) in enumerate(K1_SHAPES.items()):
        waves[name] = check_wave_kernel(20 + seed, m, s, w)
        print(f"wave kernel, {name}:", json.dumps(waves[name]), flush=True)
    small = check_wave_kernel(1, 9, 1, 8)
    print("wave kernel, one 8-lane step:", json.dumps(small), flush=True)
    hz = check_hazard_kernel(4, K2_K, K2_S, K2_D, unsorted_row=False)
    print("hazard kernel:", json.dumps(hz), flush=True)
    hz_big = check_hazard_kernel(11, 1, K2_BIG, K2_BIG, unsorted_row=False,
                                 plain_reps=0)
    print("hazard kernel, fused_raw_loops' shape:", json.dumps(hz_big),
          flush=True)
    hz_unsorted = check_hazard_kernel(5, K2_K, K2_S, K2_D, unsorted_row=True,
                                      plain_reps=0)
    print("hazard kernel, one unsorted row:", json.dumps(hz_unsorted),
          flush=True)
    fw = check_forward_kernel()
    print("forwarding kernel:", json.dumps(fw), flush=True)
    sp = check_spmv_kernel(*k4_inputs(8), K4_BLOCK_R)
    print("ELL SpMV kernel:", json.dumps(sp), flush=True)
    sp_mp = check_spmv_kernel(*matpower_csr(), K4_BLOCK_R)
    print("ELL SpMV kernel, matpower's shape:", json.dumps(sp_mp),
          flush=True)
    hi = check_histogram_kernel(9, K5_N, K5_BINS)
    print("histogram kernel:", json.dumps(hi), flush=True)
    hi_global = check_histogram_kernel(10, K5G_N, K5G_BINS)
    print("histogram kernel, global-memory path:", json.dumps(hi_global),
          flush=True)
    fl = check_flash_kernel()
    print("flash attention kernel:", json.dumps(fl), flush=True)
    fw_win = check_flash_window()
    print("flash attention kernel, gemma3's window:", json.dumps(fw_win),
          flush=True)
    de = check_decode_kernel()
    print("decode attention kernel:", json.dumps(de), flush=True)
    zamba = check_zamba2_attention()
    print("flash and decode attention, zamba2's shared block:",
          json.dumps(zamba), flush=True)
    gemma = check_gemma3_attention()
    print("flash and decode attention, gemma3's paths:", json.dumps(gemma),
          flush=True)
    mlaw = check_mla_whisper_attention()
    print("flash attention, minicpm3's MLA and whisper's shapes:",
          json.dumps(mlaw), flush=True)
    wdec = check_whisper_decode_attention()
    print("flash and decode attention, whisper's decode steps:",
          json.dumps(wdec), flush=True)
    sc = check_scan_kernel()
    print("selective scan kernel:", json.dumps(sc), flush=True)
    mst = check_mamba_step_kernel()
    print("Mamba-1 decode-step kernel:", json.dumps(mst), flush=True)
    gm = check_gmm_kernel()
    print("grouped matmul kernel:", json.dumps(gm), flush=True)
    trk = check_training_kernels()
    print("flash attention's lse and gradients, the scan's gradients:",
          json.dumps(trk), flush=True)
    torch.cuda.empty_cache()

    # 4. main path, with the wave kernel's counts read around it alone
    _zero_wave_counts(kernel)
    rows, shapes, plans = run_main_path()
    main_split = _wave_launches(kernel, "main path", shapes)
    launches = main_split["launches"]
    expected = sum(r["n_segments"] for r in rows)
    if launches != expected:
        raise AssertionError(
            f"main path launched the wave kernel {launches} times, "
            f"its runs report {expected} segments"
        )
    print("main path:", json.dumps({"wave_launches": main_split}),
          flush=True)
    m, s, w = max(shapes, key=lambda t: t[1] * t[2])
    main_shape = check_wave_kernel(2, m, s, w)
    print("wave kernel at the main path's largest launch:",
          json.dumps(main_shape), flush=True)

    # 5. DU path, with the K2 and K3 counts read around it alone
    k2.hazard_frontier_batch.launches = 0
    k3.fused_stream.launches = 0
    du = run_du_path(plans)
    k2_launches = k2.hazard_frontier_batch.launches
    k3_launches = k3.fused_stream.launches
    print("DU path:", json.dumps(du), flush=True)
    if (k2_launches, k3_launches) != (du["k2_calls"], du["k3_calls"]) or (
        0 in (k2_launches, k3_launches)
    ):
        raise AssertionError(
            f"DU path launched K2 {k2_launches} and K3 {k3_launches} "
            f"times for {du['k2_calls']} and {du['k3_calls']} calls"
        )

    # 6. substrate path, with the K4 and K5 counts read around it alone
    k4.csr_spmv.launches = 0
    k5.histogram.launches = 0
    sub = run_substrate_path()
    k4_launches = k4.csr_spmv.launches
    k5_launches = k5.histogram.launches
    print("substrate path:", json.dumps(sub), flush=True)
    if (k4_launches, k5_launches) != (sub["k4_calls"], sub["k5_calls"]) or (
        0 in (k4_launches, k5_launches)
    ):
        raise AssertionError(
            f"substrate path launched K4 {k4_launches} and K5 {k5_launches} "
            f"times for {sub['k4_calls']} and {sub['k5_calls']} calls"
        )

    # 7. speculation path, with the wave kernel's count read around it
    _zero_wave_counts(kernel)
    t0 = time.perf_counter()
    spec_rows, spec_shapes = run_spec_path()
    spec_split = _wave_launches(kernel, "speculation path", spec_shapes)
    spec_launches = spec_split["launches"]
    print("speculation path:", json.dumps({
        "wave_launches": spec_split, "host_s": time.perf_counter() - t0,
    }), flush=True)

    # 8. streaming path, with the wave kernel's count read around it
    _zero_wave_counts(kernel)
    t0 = time.perf_counter()
    stream_rows, stream_shapes = run_stream_path()
    stream_split = _wave_launches(kernel, "streaming path", stream_shapes)
    stream_launches = stream_split["launches"]
    print("streaming path:", json.dumps({
        "wave_launches": stream_split, "host_s": time.perf_counter() - t0,
    }), flush=True)

    # 9. simulate, with the wave kernel's count read around it
    kernel.wave_loop.launches = 0
    sim_rows, sim_segments = run_simulate()
    if kernel.wave_loop.launches != sim_segments:
        raise AssertionError("simulate phase: wave launches != segments")
    spec_sim = run_spec_simulate()
    summary = {
        "simulate_host_s": sum(r["host_s"] for r in sim_rows),
        "FUS2_vs_STA_hmean": _hmean([r["fus2_vs_sta"] for r in sim_rows]),
        "FUS2_vs_LSQ_hmean": _hmean([r["fus2_vs_lsq"] for r in sim_rows]),
        "wave_launches": sim_segments,
        "spec_simulate_host_s": sum(r["host_s"] for r in spec_sim),
    }
    print("simulate:", json.dumps(summary), flush=True)

    # 10. HLS analysis and DSE. The linter, the sweep and the calibration
    # are host code in both packages (numpy and simulate(), no kernel),
    # so they take no device argument: this is not a fallback to the
    # CPU. The hint sanitizer's programs run through execute() on the
    # card, with the wave kernel's counts read around them alone.
    t0 = time.perf_counter()
    lint_row = run_lint()
    print("lint:", json.dumps(lint_row), flush=True)
    _zero_wave_counts(kernel)
    hint_rows, hint_shapes = run_hint_sanitizer(kernel)
    hint_split = _wave_launches(kernel, "hint sanitizer", hint_shapes)
    print("hint sanitizer:", json.dumps({"programs": hint_rows,
                                         "wave_launches": hint_split}),
          flush=True)
    dse_row = run_dse_sweep()
    print("DSE sweep:", json.dumps(dse_row), flush=True)
    calib_row = run_calibration()
    print("calibration:", json.dumps(calib_row), flush=True)
    print("HLS analysis and DSE:", json.dumps({
        "host_s": time.perf_counter() - t0, "card": _card_line(),
    }), flush=True)

    # 11. the LM paths, one model at a time, with the K6-K9 counts read
    # around each run: dense GQA (K6, K7), Mamba-1 (K8), MoE (K6, K7, K9)
    sv = run_lm_path(SERVE_ARCH)
    print("serve path:", json.dumps(sv), flush=True)
    ssm = run_lm_path(SSM_ARCH)
    print("SSM path:", json.dumps(ssm), flush=True)
    moe = run_lm_path(MOE_ARCH, n_layers=MOE_LAYERS)
    print("MoE path:", json.dumps(moe), flush=True)
    # the Mamba-2 hybrid (K6, K7 on the shared block), gemma3's sliding
    # window (K6 with the window, K7 over rings), and its rings wrapping
    hyb = run_lm_path(HYBRID_ARCH)
    print("hybrid path:", json.dumps(hyb), flush=True)
    win = run_lm_path(WINDOW_ARCH)
    print("sliding-window path:", json.dumps(win), flush=True)
    ring = run_ring_check()
    print("ring check:", json.dumps(ring), flush=True)
    # MLA (K6 with V's own head dim on the prefill, a plain latent-space
    # decode) and the encoder-decoder (K6 for the encoder and cross
    # attention, K7 for the decoder's self attention)
    mla = run_lm_path(MLA_ARCH)
    print("MLA path:", json.dumps(mla), flush=True)
    encdec = run_lm_path(ENC_DEC_ARCH)
    print("encoder-decoder path:", json.dumps(encdec), flush=True)

    # 12. the training path: train.main's loop on qwen3-14b at full width,
    # 4 of its 40 layers, with the K6-K9 counts read around it
    tr = run_train_path()
    print("training path:", json.dumps(tr), flush=True)

    # 13. distribution and the account: the sharded step on the card
    # (K6 on local shards), its account, and two production cells
    t0 = time.perf_counter()
    ds = run_distribution_path()
    ds["host_s"] = time.perf_counter() - t0
    print("distribution path:", json.dumps(ds), flush=True)

    # 14. result lines
    big = waves["kernel_phase"]
    wave_entry = {
        "name": "wave_loop", "route": "cuda",
        "source": "src/repro_torch/kernels/wave_exec/csrc/wave_exec.cu",
        "replaces": "src/repro/kernels/wave_exec/kernel.py:61",
        "launches": launches,
        "launches_on_paths": {"speculation": spec_launches,
                              "streaming": stream_launches},
        "wide_launches_on_paths": {"main": main_split["wide"],
                                   "speculation": spec_split["wide"],
                                   "streaming": stream_split["wide"]},
        "tolerance": "bit-exact (torch.equal on image and gathered words)",
        "max_abs_err": max(c["max_abs_err"]
                           for c in (*waves.values(), small, main_shape)),
        "ms": big["ms"], "plain_ms": big["plain_ms"],
        "device_ms": big["device_ms"], "host_us": big["host_us"],
        "bound_ms": big["bound_ms"], "bound_by": "bytes",
        "sector_bound_ms": big["sector_bound_ms"],
        "bound_with_syncs_ms": big["bound_with_syncs_ms"],
        "sync_us": big["sync_us"], "path": big["path"],
        "library_ms": None,
        "library": "none: no single torch call gathers against the "
                   "pre-step image, then scatters",
        "shape": {"M": BIG_M, "S": BIG_S, "W": BIG_W},
        "shapes": {k: v for k, v in waves.items() if k != "kernel_phase"},
        "main_path_largest_launch": main_shape,
        "one_8_lane_step": small,
    }
    hazard_entry = {
        "name": "hazard_frontier", "route": "cuda",
        "source": "src/repro_torch/kernels/du_hazard/csrc/du_hazard.cu",
        "replaces": "src/repro/kernels/du_hazard/kernel.py:99",
        "launches": k2_launches,
        "tolerance": "bit-exact (torch.equal on int32 frontiers)",
        "max_abs_err": max(c[side]["max_abs_err"]
                           for c in (hz, hz_big, hz_unsorted)
                           for side in ("right", "left")),
        "ms": hz["right"]["ms"], "plain_ms": hz["right"]["plain_ms"],
        "bound_ms": hz["bound_ms"], "bound_by": "bytes",
        "bound_share": hz["right"]["bound_share"],
        "library_ms": hz["right"]["library_ms"],
        "library": "torch.searchsorted(right=True) on the monotonic rows",
        "side_left": hz["left"],
        "shape": {"K": K2_K, "S": K2_S, "D": K2_D},
        "fused_raw_loops_shape": hz_big,
        "unsorted_row": hz_unsorted,
    }
    forward_entry = {
        "name": "fused_stream", "route": "cuda",
        "source": "src/repro_torch/kernels/fused_stream/csrc/fused_stream.cu",
        "replaces": "src/repro/kernels/fused_stream/kernel.py:95",
        "launches": k3_launches,
        "tolerance": "bit-exact (torch.equal on float64 words and hits)",
        "max_abs_err": fw["max_abs_err"],
        "ms": fw["ms"], "plain_ms": fw["plain_ms"],
        "device_ms": fw["device_ms"], "host_us": fw["host_us"],
        "bound_ms": fw["bound_ms"], "bound_by": "bytes",
        "sector_bound_ms": fw["sector_bound_ms"],
        "sector_bound_share": fw["sector_bound_share"],
        "library_ms": None,
        "library": "none: no single torch call forwards",
        "shape": {k: fw[k] for k in ("S", "D", "M", "lookback", "hits")},
    }
    spmv_entry = {
        "name": "csr_spmv", "route": "cuda",
        "source": "src/repro_torch/kernels/csr_spmv/csrc/csr_spmv.cu",
        "replaces": "src/repro/kernels/csr_spmv/kernel.py:44",
        "launches": k4_launches,
        "tolerance": "bit-exact (torch.equal) against the plain version; "
                     "cuSPARSE within 2*gamma_(W+3)*|A||x|",
        "max_abs_err": max(sp["max_abs_err"], sp_mp["max_abs_err"]),
        "ms": sp["ms"], "plain_ms": sp["plain_ms"],
        "bound_ms": sp["bound_ms"], "bound_by": "bytes",
        "bound_share": sp["bound_share"],
        "library_ms": sp["library_ms"],
        "library": "torch.mv on a sparse CSR tensor (cuSPARSE)",
        "library_max_abs_err": sp["library_max_abs_err"],
        "shape": {k: sp[k] for k in ("N", "M", "W", "nnz")},
        "matpower_shape": sp_mp,
    }
    hist_entry = {
        "name": "histogram", "route": "cuda",
        "source": "src/repro_torch/kernels/histogram/csrc/histogram.cu",
        "replaces": "src/repro/kernels/histogram/kernel.py:47",
        "launches": k5_launches,
        "tolerance": "bit-exact (torch.equal on float32 counts)",
        "max_abs_err": max(hi["max_abs_err"], hi_global["max_abs_err"]),
        "ms": hi["ms"], "plain_ms": hi["plain_ms"],
        "bound_ms": hi["bound_ms"], "bound_by": "bytes",
        "library_ms": hi["library_ms"],
        "library": "torch.bincount on the in-range data",
        "shape": {k: hi[k] for k in ("N", "n_bins", "dropped", "path")},
        "global_path": hi_global,
    }
    flash_entry = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/attention/csrc/attention.cu",
        "replaces": "src/repro/kernels/attention/kernel.py:88",
        "launches": sv["launches"]["prefill"]["k6"],
        "launches_on_paths": {"serve prefill": sv["launches"]["prefill"]["k6"],
                              "MoE prefill": moe["launches"]["prefill"]["k6"],
                              "MoE check": moe["launches"]["moe_check"]["k6"],
                              "hybrid prefill":
                                  hyb["launches"]["prefill"]["k6"],
                              "sliding-window prefill":
                                  win["launches"]["prefill"]["k6"],
                              "ring check prefill":
                                  ring["launches"]["prefill"]["k6"],
                              "MLA prefill":
                                  mla["launches"]["prefill"]["k6"],
                              **{f"encoder-decoder {run}":
                                 encdec["launches"][run]["k6"]
                                 for run in ("prefill", "encode",
                                             "teacher_forced",
                                             "teacher_forced_without_enc_out",
                                             "serve")},
                              "training (forward and recomputed backward)":
                                  tr["launches"]["k6"],
                              "distribution (sharded step, on local "
                              "shards)": ds["k6_launches"]},
        "distribution_local_shard_calls": ds["k6_local_shard_calls"],
        "sharded_step_max_rel_err": ds["max_rel_err"],
        "tolerance": f"max abs err <= {ATTN_ATOL} against the plain "
                     "version (float32 inputs, products in 3xTF32 on the "
                     "tensor cores; the sum order differs)",
        "max_abs_err": max(fl["max_abs_err"], fw_win["max_abs_err"],
                           zamba["flash"]["max_abs_err"],
                           gemma["flash"]["max_abs_err"],
                           wdec["flash"]["max_abs_err"],
                           *(c["max_abs_err"] for c in mlaw.values())),
        "ms": fl["ms"], "plain_ms": fl["plain_ms"],
        "device_ms": fl["device_ms"], "host_us": fl["host_us"],
        "bound_ms": fl["bound_ms"], "bound_by": "operations",
        "bound_share": fl["bound_share"],
        "bound_basis": "3xTF32: 3 TF32 tensor-core products a multiply-add "
                       "at 495 TFLOP/s",
        "f32_cuda_core_bound_ms": fl["f32_cuda_core_bound_ms"],
        "library_ms": fl["library_ms"],
        "library": "scaled_dot_product_attention(is_causal=True, "
                   "enable_gqa=True)",
        "library_max_abs_err": fl["library_max_abs_err"],
        "shape": {k: fl[k] for k in ("B", "H", "Hk", "S", "D", "causal")},
        "ragged_noncausal": fl["ragged_noncausal"],
        "serve_shape": fl["serve_shape"],
        "window": fw_win,
        "zamba2_serve_shape": zamba["flash"],
        "gemma3_path_shapes": gemma["flash"],
        "mla_and_whisper_shapes": mlaw,
        "whisper_decode_shapes": wdec["flash"],
        "lse_max_abs_err": trk["lse_max_abs_err"],
        "grad_max_abs_err": trk["grad_max_abs_err"],
        "training_shapes": trk["flash"],
    }
    decode_entry = {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/attention/csrc/attention.cu",
        "replaces": "src/repro/kernels/attention/kernel.py:153",
        "launches": sv["launches"]["serve"]["k7"],
        "teacher_forced_launches": sv["launches"]["teacher_forced"]["k7"],
        "launches_on_paths": {
            "MoE serve_batch": moe["launches"]["serve"]["k7"],
            "hybrid teacher-forced": hyb["launches"]["teacher_forced"]["k7"],
            "hybrid serve_batch": hyb["launches"]["serve"]["k7"],
            "sliding-window teacher-forced":
                win["launches"]["teacher_forced"]["k7"],
            "sliding-window serve_batch": win["launches"]["serve"]["k7"],
            "ring check teacher-forced":
                ring["launches"]["teacher_forced"]["k7"],
            **{f"encoder-decoder {run}": encdec["launches"][run]["k7"]
               for run in ("teacher_forced",
                           "teacher_forced_without_enc_out", "serve")}},
        "tolerance": f"max abs err <= {ATTN_ATOL} against the plain "
                     "version (float32; the sum order differs)",
        "max_abs_err": max(de["max_abs_err"],
                           zamba["decode"]["max_abs_err"],
                           gemma["decode"]["max_abs_err"],
                           wdec["decode"]["max_abs_err"]),
        "ms": de["ms"], "plain_ms": de["plain_ms"],
        "device_ms": de["device_ms"], "host_us": de["host_us"],
        "bound_ms": de["bound_ms"], "bound_by": "bytes",
        "bound_share": de["bound_share"],
        "n_split_and_len": de["n_split_and_len"],
        "library_ms": de["library_ms"],
        "library": "scaled_dot_product_attention with a boolean frontier "
                   "mask, enable_gqa=True",
        "library_max_abs_err": de["library_max_abs_err"],
        "shape": {k: de[k] for k in ("B", "H", "Hk", "C", "D",
                                     "committed_rows")},
        "lengths0_max_abs_err": de["lengths0_max_abs_err"],
        "serve_shape": de["serve_shape"],
        "zamba2_serve_shape": zamba["decode"],
        "gemma3_path_shapes": gemma["decode"],
        "whisper_serve_shape": wdec["decode"],
    }
    scan_entry = {
        "name": "ssm_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan/kernel.py:79",
        "launches": ssm["launches"]["prefill"]["k8"],
        "tolerance": f"|err| <= {SCAN_ATOL} + {SCAN_RTOL}|plain| on y and "
                     "h_final (float32; exp and the state sum round "
                     "differently)",
        "max_abs_err": max(sc["max_abs_err"], sc["h_final_max_abs_err"]),
        "ms": sc["ms"], "plain_ms": sc["plain_ms"],
        "device_ms": sc["device_ms"], "host_us": sc["host_us"],
        "bound_ms": sc["bound_ms"], "bound_by": sc["bound_by"],
        "bound_share": sc["bound_share"],
        "bytes_bound_ms": sc["bytes_bound_ms"],
        "sfu_bound_ms": sc["sfu_bound_ms"],
        "library_ms": None,
        "library": "none: no single torch call runs a selective scan",
        "shape": {"B": K8_B, "S": K8_S, "di": K8_DI, "n": K8_N},
        "cases": {k: sc[k] for k in ("ragged", "carried_h0", "serve_shape")},
        "grad_max_abs_err": trk["scan"]["grad_max_abs_err"],
        "gradient": trk["scan"],
    }
    step_entry = {
        "name": "mamba_step", "route": "cuda",
        "source": "src/repro_torch/kernels/mamba_step/csrc/mamba_step.cu",
        "replaces": "none: the port's own kernel (the reference's step is "
                    "plain JAX, src/repro/models/ssm.py _mamba1_step)",
        "launches": ssm["launches"]["serve"]["k10"],
        "tolerance": f"|err| <= {MSTEP_ATOL} + {MSTEP_RTOL}|plain| on y and "
                     "the state (float32; the projections' sums and exp "
                     "round differently), the window bit for bit",
        "max_abs_err": max(mst["max_abs_err"], mst["h_max_abs_err"]),
        "ms": mst["ms"], "plain_ms": mst["plain_ms"],
        "device_ms": mst["device_ms"], "host_us": mst["host_us"],
        "bound_ms": mst["bound_ms"], "bound_by": mst["bound_by"],
        "bound_share": mst["bound_share"],
        "state_and_window_bound_ms": mst["state_and_window_bound_ms"],
        "library_ms": None,
        "library": "none: no single torch call runs a Mamba step",
        "shape": {"B": K10_B, "di": K10_DI, "n": K10_N, "K": K10_K},
        "cases": {k: mst[k] for k in ("full", "ragged")},
    }
    gmm_entry = {
        "name": "group_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/moe_group_mm/csrc/"
                  "moe_group_mm.cu",
        "replaces": "src/repro/kernels/moe_group_mm/kernel.py:60",
        "launches": moe["launches"]["moe_check"]["k9"],
        "tolerance": "|err| <= 2*gamma_(d_in)*(|x||w|) against the plain "
                     f"version; the MoE layer within {MOE_ATOL} + "
                     f"{MOE_RTOL}|capacity path|",
        "max_abs_err": gm["max_abs_err"],
        "ms": gm["ms"], "plain_ms": gm["plain_ms"],
        "device_ms": gm["device_ms"], "host_us": gm["host_us"],
        "bound_ms": gm["bound_ms"], "bound_by": gm["bound_by"],
        "bound_share": gm["bound_share"],
        "bound_basis": "3xTF32: 3 TF32 tensor-core products a multiply-add "
                       "at 495 TFLOP/s",
        "f32_cuda_core_bound_ms": gm["f32_cuda_core_bound_ms"],
        "library_ms": None,
        "library": "none: no single torch call computes a grouped product",
        "dense_product_of_equal_flops_ms": gm["dense_product_ms"],
        "w_out": gm["w_out"],
        "moe_layer_max_abs_err": moe["moe_check"]["max_abs_err"],
        "shape": {k: gm[k] for k in ("T_pad", "d_in", "d_out", "E",
                                     "block_t", "experts_used")},
        "small_block_t": gm["small_block_t"],
    }
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all",
          flush=True)
    print(_card_line())
    print(json.dumps({"kernels": [wave_entry, hazard_entry, forward_entry,
                                  spmv_entry, hist_entry, flash_entry,
                                  decode_entry, scan_entry, gmm_entry,
                                  step_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
