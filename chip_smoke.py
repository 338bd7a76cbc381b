#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

(``python3 chip_smoke.py --chain-noise N`` instead runs only the
calibration of phase 26's default-mode bar: ``chain_noise``.)

Phases, each of which stops the run with a non-zero exit if it fails:

1. the card: its name and power limit as nvidia-smi gives them; no CUDA
   device means an immediate non-zero exit;
2. build: every CUDA kernel of the port from ``ops/kernels/csrc`` (one
   ``nvcc`` per source, all started together; timed);
3. kernels against their plain PyTorch versions on the card, at the shapes
   the main paths give them, with kernel, plain, library and bound times:
   the CIN forward (each layer's launches timed by the profiler, and its
   shrink toward zero against f64 of the same bf16 operands), the CIN
   backward (whose outputs must also be the same bits on three runs; each
   of its four launches timed by the profiler),
   and the field-attention forward and backward (the backward twice, the
   same bits, and each shape's instance named; where the forward takes its
   warp or L-64 instance, its block instance is held beside it, and both
   are timed at AutoInt's shape by events and on the device; so is the
   backward's block instance beside the L-64 one; whether the forward has
   the plain version's bits is printed at every shape and must hold at
   DMIN's), also at the two edges of their gate, at AutoInt's L with Dh 13
   and a ragged B, at SIM's top-8 ESU and at (B 1001, Lq 64, Lk 48) on the
   L-64 instances, with a random key mask and one batch row whose keys are
   all masked (uniform weights over all keys), and at the sequence tier's
   two shapes, every key valid: DSIN's sessions (B 16,384, L 8, H 2, Dh 8;
   the warp instances, the forward's block instance timed beside) and
   DMIN's refiner (B 4096, L 64, H 2, Dh 8; the L-64 instances, the block
   ones timed beside), and at FiGNN's field attention (B 4096 and 16,384,
   L 26, H 2, Dh 4; the warp instances), each direction also timed on the
   device;
4. serving: full-width xDeepFM on the Criteo schema (26 fields of 100k ids,
   dim 8, CIN (128, 128), MLP (256, 128)) with seeded random weights,
   exported and scored through ``load_scorer`` → ``Scorer.predict_proba`` on
   the card by default. The scores must be finite probabilities, the CIN
   forward kernel must have launched twice a batch, and the scores must agree
   with the same model whose CIN runs the plain version;
5. training: the same model built by ``get_model`` on the card by default.
   (a) 5 Adam steps at B 4096 with the CIN on its kernels, then from the
   same weights with both directions forced onto the plain versions: the
   loss traces agree to 1e-3 and the step-1 gradients of every parameter
   to 1e-3·max|g| (or one bf16 step, where both are bf16 values: weight
   gradients are rounded to bf16), with two launches of each kernel a
   step; (b) training
   examples/s at B 4096 (median of 20 steps, host clock), device time per
   step (CUDA events) and peak memory; (c) ``fit`` on 262,144 rows (100 ids
   a field, otherwise full width), 3 epochs with an eval each epoch and the
   best restored: held-out AUC above 0.65 and two launches of each kernel a
   train step;
6. AutoInt serving, with ``ML_FUNCTION_TPU_FIELD_ATTN=1`` (set by this
   script): full-width AutoInt (the same schema, dim 8, 2 layers of 2 heads
   of 16) exported, loaded and scored as in 4, with two launches of the
   field-attention forward a batch and scores within 1e-4 of the plain
   version; examples/s and one forward's device time, with the flag and
   without it (the plain small-L route);
7. AutoInt training, as 5 with the field-attention kernels: 5 Adam steps
   against the plain versions, the rates, and a ``fit`` on the learning
   cell to held-out AUC above 0.6;
8. the (AU)GRU kernels and the merge-scatter kernel against their plain
   versions: gru_fwd and gru_bwd with attention gates and with ones at
   DIEN's shape (B 4096, L 64, H 16, the masks of real histories), at
   SIM's two (B 512 and B 8, timed beside DIEN's by events and on the
   device; each shape names its instances), at (B 300, L 7, H 64) and
   (B 301, L 9, H 13) with ragged masks, one row masked at every step (its
   seq must be h0) and a non-zero h0, and at (B 1, L 1, H 8); wherever H ≤ 16
   the forward's warp instance and its block instance must give the same
   bits (the block instance timed beside it at DIEN's shape); merge_scatter
   (int32 ids sorted stably, ct unsorted and read through the sort's
   permutation) at DIEN's two sequence lookups (N 262,144 ids of width 8
   into 5,202 rows; a quarter of the item ids are the pad id), at SIM's
   three a train step (B 512), with all ids equal, with none and with ids
   at V − 1, twice each and once through the whole backward (the same
   bits), and at HPMN's and MIMN's two a train step (B 2048 and B 1024 on
   the bench's behavior batch). Kernel, sort, whole-backward, plain and
   library times (cuDNN's ``nn.GRU``; ``index_add_``) and bounds;
9. DIEN serving: full-width DIEN (the JAX package's headline shape: 5,000
   items, 100 categories, histories of 64, dim 8, GRU hidden 16, MLP
   (200, 80)) from ``get_model`` exported and scored through
   ``load_scorer`` with ``kernel = 'pallas'`` set on ``gru1`` and ``gru2``:
   finite probabilities, two gru_fwd launches a batch and no other, scores
   within 1e-4 of the plain versions and of the 'scan' route; examples/s
   and one forward's device time on both routes;
10. DIEN training with the kernel route and ``_USE_MERGE_SCATTER`` set: 5
    Adam steps against all three kernels' plain versions (losses to 1e-3,
    step-1 gradients to 1e-3·max|g|, 2 + 2 + 2 launches a step), the rates
    on this route and on the 'scan' route without the flag, and ``fit`` on
    the JAX package's DIEN protocol (120,000 rows, 40 items, 10 categories,
    histories of 32, split 80/20, B 4096, Adam 1e-3, 3 epochs) on both
    routes: held-out AUC above 0.55 (or above the scan route's less 0.01,
    where that one is lower) and within 0.01 of the scan route's;
11. the flash-attention kernels (forward, dQ, dK/dV) against their plain
    versions at SIM's flash-ESU shape (B 8, H 2, Lq = Lk = 16,384, Dh 8,
    the key mask of phase 13's batch: every key valid) and at ragged edges
    (streams of random length, right-padded; causal with
    Lq ≠ Lk, Dh 64, Lq 1, the tensor-core tiles' edges (Lq, Lk not
    multiples of 16 or 8, Lk < 8), each with a batch row whose keys are
    all masked, pinned to mean(V)), every kernel twice (the same bits);
    kernel, plain and library (``scaled_dot_product_attention``, f32,
    memory-efficient) times at the path's shape, and two bounds: the
    split-TF32 tensor cores, the SFU's exponentials and the bytes, and the
    f32 rate of the CUDA cores (``bound_f32_ms``);
12. SIM at the JAX package's production board shape (the bench's behavior
    batch: 5,000 items, 100 categories, histories of 64, a 16,384-id
    ``hist_long``, dim 8; soft search keeping the top 256, MLP (200, 80),
    B 512), the DIEN core on the (AU)GRU kernels and the merge-scatter
    gradient: exported and scored through ``load_scorer`` (2 gru_fwd
    launches a batch, no K5; scores within 1e-4 of the plain versions),
    5 Adam steps against the plain run (2 + 2 of K4 and 3 of K1 a step),
    the rates;
13. SIM at the flash-ESU board shape: hard search over the whole raw
    stream (all 16,384 ids valid, as the bench draws it), B 8: the same
    checks, with 1 flash_fwd launch a scored batch and 1 + 1 + 1 of K5 a
    train step, and the plain run against itself with only the plain
    attention's chunking changed (the witness of the gradient bar's bf16
    step);
14. learning: ``fit`` SIM (soft search, top 8) on the JAX test's planted
    lifelong data (2,400 rows, 8 epochs of B 128, Adam 1e-2), its ESU over
    the 8 kept keys on the field-attention kernels (the flag set for 6):
    held-out AUC above 0.64;
15. F6, the wide instances: cin_fwd and cin_bwd at (D 8, B 4096, F 26,
    O 128) with H 384 and H 512 (both wide) and at the edge (D 8, B 1000,
    F 39, H 1024), against their plain versions (the backward three times,
    the same bits), and at H 176, the widest H at which each direction's
    block instance is the faster one, the two instances against each other
    (the largest difference printed); gru_fwd and gru_bwd on the wide instances at
    (B 4096, L 64, H 128 and 256), (B 300, L 7, H 65) and (B 37, L 5,
    H 1100) with ragged masks, one row masked at every step (its seq must be
    h0) and a non-zero h0, with attention gates and with ones: the forward
    the plain version's bits, the backward within its bars and the same bits
    on two runs. Each shape names its instance; kernel, plain, library and
    bound times;
16. xDeepFM with CIN (512, 128) at Criteo width: scored through
    ``load_scorer`` (2 cin_fwd a batch, the second on ``cin_fwd_wide``;
    scores within 1e-4 of the plain route) and 5 Adam steps against the
    plain route (2 + 2 a step, each direction's second layer on its wide
    instance), and the training rates;
17. DIEN at dim 64 (GRU hidden kd = 128), ``kernel = 'pallas'`` on gru1
    and gru2: scored through ``load_scorer`` (2 gru_fwd a batch, on
    ``gru_fwd_wide``; within 1e-4 of the plain versions) and 5 Adam steps
    against the plain route (2 + 2 a step), and the rates;
    (in phases 18 to 21 each model's CPU side, the same weights scored and
    trained on the CPU, runs in worker processes beside the card's part,
    ``cpu_checks``; each comparison prints when its CPU side is done, the
    last ones after phase 22)
18. the interaction models, DLRM, FiBiNET, LR, FM, FNN, FFM, FwFM, PNN,
    DeepCross, Wide&Deep, DCN (v1 and v2), NFM and AFM, MMoE, ESMM and
    PLE, and CCPM, FGCNN, FLEN, ONN, FAT-DeepFFM, FiGNN, MLR and OENN, at
    the JAX board's width (26 fields of 100k ids, 13 dense, dim 8, default
    hyperparameters), each built on the card by ``get_model``: scored
    through ``load_scorer`` at B 4096 on features alone (finite
    probabilities; with f32 matmuls on both devices within 1e-4 of the same
    weights scored on the CPU, on the bf16 path the logits within one bf16
    step, 2^-8, of their max; no kernel launched), 2 Adam steps on the card
    against the same 2 on the CPU (``CPU_CHECK_STEPS``) (phase 5's bars with f32 matmuls on both;
    on the bf16 path the losses to 1e-3 and the gradients at one bf16 step
    of max|g|; the CPU's first step takes the card's ReLU decisions, each
    overridden pre-activation within 1e-5 of its layer's max of 0), the
    multi-task models' second-task BCE (their batches carry ``click``)
    card against CPU to 1e-3, and training examples/s, device time a step
    and peak memory at B 16,384 (phases 18 and 19 take their rates at
    ``BOARD_RATES_DEPTH``); FiGNN's attention under the flag launches
    1 field_attn_fwd a forward and 1 field_attn_bwd a step, and its scores
    and 5 Adam steps are held against the same model on K3's plain
    versions, FiGNN's logits compared where its probabilities saturate;
    FFM, ONN and FAT-DeepFFM are held against the CPU at 10k ids a field
    (the same widths, a tenth of the rows: their 270 M-parameter tables'
    CPU side would hold the run past 600 s) and timed at 100k;
19. the behavior-sequence tier, BST, DSIN, SeqFM, DSTN, DMIN and MIND, on
    the JAX bench's behavior batch (5,000 items, 100 categories, histories
    of 64 random ids, dim 8, default hyperparameters; DSIN at the board's
    B 2048 with sessions (8, 8), the others at B 4096), each as a model of
    18 (scores and 2 Adam steps card against CPU, the CPU's first step
    taking the card's ReLU and PReLU decisions, the aux terms, the rates
    at its batch), with the field-attention flag: DSIN, SeqFM and DMIN
    launch 1 field_attn_fwd a forward and 1 field_attn_bwd a step, and
    their scores and 5 Adam steps are held against the same model on K3's
    plain versions (phase 5's bars), DSIN's also on a ragged
    ``make_behavior_data`` batch whose fully padded sessions reach K3; BST
    (65 positions, past the gate), DSTN and MIND launch nothing; then HPMN
    (B 2048), MIMN (B 1024) and DTS on that batch, BST on LSH attention, and
    SIM with the LSH exact search unit at its soft-search board shape (B
    512, a 16,384-id stream, the top 256), each likewise, LSH bucket ids
    compared card against CPU (a row past the bar must hold a key on
    another bucket, each such key within rounding of a tie, and the CPU's
    first training step takes the card's buckets), HPMN's and MIMN's
    training also with the merge-scatter flag's attribute set against the
    same steps without it (2 merge_scatter launches a step), and the
    busy share of HPMN's, MIMN's and DTS's train steps by the profiler;
20. DSSM and DeepMCP on that behavior batch and DICM on
    ``make_image_ctr_data`` at its shape with 64-wide images (B 4096,
    default hyperparameters), each as a model of 18; DICM's training also
    with the merge-scatter flag's attribute set (2 merge_scatter launches a
    step) against the same steps with ``fused_gather``'s plain version, and
    K1 timed at its two lookups; then one cold-start meta step over DeepFM
    at the Criteo width (B 4096 pairs), its meta-loss and generator
    gradient (second-order term included) and one Adam meta step card
    against CPU;
21. the store: a mixed-width DeepFM (C1-C13 at dim 8 over 100k ids,
    C14-C26 at dim 4 over 1M ids) as a model of 18; the sparse-row step
    (RowAdagrad) against the dense Adagrad step at 26 fields of 100k ids,
    B 32768 (3 steps with f32 matmuls, every parameter within 1e-5, no
    (V, ·) tensor in the dense optimizer's state, no kernel launched with
    the merge-scatter flag's attribute set), and both steps and the record
    pass timed with peak memory there and at 26 fields of 1M ids; DeepFM
    scored from int8 tables against f32 at 26 x 100k, B 8192 (largest
    probability gap within 0.02, AUC within 2e-3, table bytes, rates);
22. train from files and resume: both native loaders built with g++ from
    the port's copies (``ml_function_tpu_torch/native/*.cpp``, timed; a
    failed build stops the run); a headerless Criteo TSV written from a
    seed (36 × 4096 rows, 13 counts and 26 categorical fields of about
    100k values, some empty; the last 16,384 rows a held-out file), the
    held-out file parsed whole by ``load_criteo`` (26 × 100k buckets; rows
    and MiB a second, and the training file's) and its first 2,048 rows
    held against ``py_reference_parse`` (ids, labels and raw counts bit for
    bit, the log1p counts within one f32 ulp, ROADMAP.md R12); xDeepFM at
    phase 4's width trained from the file through ``CriteoFileIterator``
    at B 4096 with Adam (2 cin_fwd and 2 cin_bwd a step; host clock and
    CUDA events a step), checkpoints after steps 8, 16 and 24 (keep 3;
    bytes, save seconds), the newest truncated, ``restore_latest`` into a
    fresh model and optimizer on the card (step 16's, the same bits as a
    host copy taken then; step 24's renamed ``.corrupt``; restore
    seconds), steps 17-24 replayed against the uninterrupted losses
    (``FILE_REPLAY_RTOL``), the resumed model exported and the held-out
    file scored through ``load_scorer`` (within 1e-6 of the live model;
    AUC); then a behavior CSV from ``make_behavior_data`` at DIEN's
    headline shape (8 × 4096 rows) read by ``BehaviorFileIterator``
    (native, buckets that map every id one to one; the ids the written
    arrays' after the encode, bit for bit), DIEN on the kernel route with
    the merge-scatter flag trained 4 steps (2 gru_fwd, 2 gru_bwd and 2
    merge_scatter a step), its checkpoint restored into a fresh model and
    optimizer with the same bits, and one more step on both;
23. row-sharded tables over ``torch.distributed``: the card has one H100,
    so NCCL runs at world size 1, from a ``FileStore`` group of this
    process, at xDeepFM's full width. (a) ``ShardedLookup`` called directly
    at a model group of 1, psum and a2a, bf16-compressed, at the a2a
    capacity of the slice's unique ids (lossless) and one below it (one id
    dropped and counted), against ``index_select`` (f32 rows the same bits,
    the bf16 ones the bf16 cast's; the table gradient within 1e-6 of the
    max, and under compression each element within bf16's unit roundoff
    2^-8 a rounding of its id's summed |cotangent|, one rounding for psum
    and two for the a2a; times by events); (b)
    ``ShardedScorer`` over phase 4's 13,288 rows at B 4096, the same bits as
    ``Scorer`` on the same model, 2 cin_fwd a batch; (c) the CLI's ``run``
    on the card: 32 Adam steps of xDeepFM on ``make_criteo_like`` data (26
    × 100k ids) with a sharded checkpoint every 16 steps, then a second
    run that resumes from step 16's (its losses against the uninterrupted
    run's, ``FILE_REPLAY_RTOL``; step 17's the same bits), 2 + 2 CIN
    launches a step and 2 cin_fwd an eval batch; the step's host clock
    and CUDA events, the checkpoint's bytes, save and restore seconds; (d)
    two CPU gloo ranks of a (1, 2) mesh (spawned first, beside (a) to (c),
    on 3 cores each) train the card's seeded
    weights 3 Adam steps at B 1024 with f32 matmuls and write a sharded
    checkpoint, which the card restores by stitching into its (1, 1)
    state: the parameters the ranks' gathered ones bit for bit, and the
    held rows' scores within 1e-4 of the ranks' (f32 matmuls on the card
    too). Each part's wall time is printed;
24. item 8b over ``torch.distributed``, NCCL at world size 1 again: (a)
    ``seq_sharded_soft_search`` called directly at SIM's board row (B 512,
    16,384 keys, top 256) against the unsharded soft search's choice on the
    same table, stream and candidates (the same positions; flips counted
    with their score gaps); (b) dist and ring attention at (B 8, 2 heads,
    256 queries, 16,384 keys, Dh 8), output and dq, dk, dv within 1e-5 of
    a dense softmax's max; (c) ``make_pipeline`` at one stage and 4
    microbatches on AutoInt at phase 3's width with 4 blocks, K3 under the
    flag: logits and every parameter after one SGD step within 1e-5 of the
    sequential stack's (f32 matmuls), 16 + 16 K3 launches a step; (d) two
    CPU gloo ranks of a (1, 2) mesh (spawned first, beside (a), (b) and
    phase 25) take one SGD step of SIM with ``seq_shard`` (B 64, a
    1,024-long stream, top 32) and of AutoInt with ``pp_microbatches=2`` (4
    blocks over 2 stages, B 1024) from the card's seeded weights; the
    card's unsharded steps on the same weights and batch give the loss,
    the logits and every parameter within 1e-4 (f32 matmuls on both).
    Times by events, beside the card's name and power limit;
25. graph pretraining on the card, on a planted-partition graph of 20,000
    nodes and 200,000 edges (4 communities): DeepWalk (the port's native
    walks, the walk rate printed, then word2vec), LINE and SDNE for a
    bounded number of steps, DeepWalk and LINE above the JAX tests'
    community-separation bars (0.3, 0.2); 20 word2vec steps from the same
    tables and draws on the card and on the CPU within 1e-4; each trainer's
    step time by events, beside the card's name and power limit;
26. the chained train step: ``fit(steps_per_call=8)`` on xDeepFM and
    AutoInt (the field-attention flag) at phase 4's Criteo width, DIEN on
    its kernel route with the merge-scatter flag at phase 10's headline
    shape (one group's rows drawn and repeated) and SIM's flash ESU at
    phase 13's shape. Parity, under ``torch.use_deterministic_algorithms``:
    a chained ``fit`` from the same weights as two unchained ones over 4
    groups of 8 batches and a padded tail batch, Adam: one CUDA graph
    replay a group after the first (the eager one), every kernel's
    launches those of the unchained runs, a replay's those of 8 unchained
    steps, and the train metrics and every parameter the unchained fits'
    bits. Rates, in the default mode, over 10 groups and the tail: fit's
    host-clock examples/s, two unchained fits (their mean) and a chained
    one, whose train logloss and AUC lie within four times the larger of
    the unchained pair's gap and a calibration run's largest; then the
    captured graph's kernel nodes (each kernel's device functions in it the
    count a replay adds to its counter times the functions a launch runs in
    the same 8 steps one at a time), the profiler over replays of a chained
    step (each kernel seen running inside them; each kernel's device time a
    step there and one step at a time) and over the same 8 steps one at a
    time, the card's busy share of both, a group's host time (its rows, the chained call, the wait; the
    replay's launch alone) and a replay's device time by events, beside
    the card's name and power limit;
27. collective accounting of the sharded step (``utils/hlo_stats.py``) on
    phase 23's NCCL group of one rank: (a) one recorded step of the CLI's
    sharded xDeepFM step at phase 23 (c)'s width and batch (2 cin_fwd and
    2 cin_bwd inside it, every group of one, 0 wire bytes) and DeepFM's,
    each timed by events; (b) the steps phase 23 (d)'s CPU ranks recorded
    (their first psum step on the (1, 2) mesh, an a2a step and a (2, 1)
    psum step after their checkpoint), each kind's bytes held to its
    formula from the shapes; (c) the floor of one NCCL call, a 4-byte
    all-reduce at world size 1 (the median of 50 by events); (d) the
    projected efficiency at 2 cards from (a)'s step time and (b)'s
    formulas at the card's batch on the NVLink model (data-sheet rate),
    beside the card's name and power limit;
28. one ``{"kernels": [...]}`` line (each kernel with its instances and the
    shapes each took; a kernel's ``launches`` are those of the newest path
    that runs it whose counts its wrapper made, phase 26's last unchained
    rate fits), then ``{"ok": true, "device":
    ...}`` last. The run's wall time is printed before them.

Numerics: TF32 is off for matmuls and cuDNN, so every f32 product outside
the kernels is a full f32 product. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

BATCH = 4096
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12     # H100 SXM f32 rate outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 rate
PEAK_TF32_FLOPS = 495e12   # H100 SXM dense TF32 tensor-core rate
SPLIT_TF32_PASSES = 3      # hi·hi + hi·lo + lo·hi: an f32-accurate product
# exponentials a second: 132 SMs × 16 a clock an SM on the SFU (CUDA C
# Programming Guide, arithmetic instruction throughput, compute capability
# 9.0) × the H100 SXM's 1.98 GHz boost clock (NVIDIA's data sheet)
H100_SMS, SFU_EXP_PER_CLOCK, H100_CLOCK_HZ = 132, 16, 1.98e9
SFU_EXP_RATE = H100_SMS * SFU_EXP_PER_CLOCK * H100_CLOCK_HZ
KERNELS = ("cin_fwd", "cin_bwd", "field_attn_fwd", "field_attn_bwd", "gru_fwd",
           "gru_bwd", "merge_scatter", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# AutoInt's attention at Criteo width: 26 fields + the dense pseudo-field,
# 2 heads of 16; then the gate's two edges (lq·lk = 4096, Dh 64; Lk 4096)
FA_MAIN = (BATCH, 27, 27, 2, 16)
# the gate's two edges (the block instances), then the warp instance's
# 4-byte copies at AutoInt's L with a ragged B, SIM's top-8 ESU, and the
# L-64 instances with Lq ≠ Lk and a B not a multiple of their 2 batch rows
# a block
FA_EDGES = ((512, 64, 64, 2, 64), (300, 1, 4096, 2, 8), (1001, 27, 27, 2, 13),
            (129, 8, 8, 2, 4), (1001, 64, 48, 2, 8))
# the sequence tier's attention under the flag (phase 19): DSIN's sessions at
# the board's row (B 2048 · 8 sessions of 8, 2 heads of 8; the warp
# instances) and DMIN's refiner at L 64 (exactly 4096 scores; the L-64
# instances); every key valid, as in the board's histories
# FiGNN's field attention at the board's width (phase 18: 26 fields, dim 8,
# 2 heads of 4, no mask; the warp instances) at its scoring and its
# training batch
FA_SEQ = ((2048 * 8, 8, 8, 2, 8), (BATCH, 64, 64, 2, 8), (BATCH, 26, 26, 2, 4),
          (16384, 26, 26, 2, 4))
RTOL = 1e-3                # same rounding sites; only the f32 summation order differs
# The models whose init logits pass f32's sigmoid range (FiGNN's reach ±90:
# at the board's width 5,870 of 13,288 probabilities are exactly 0 or 1),
# so a probability says nothing of its logit: their scoring checks compare
# the logits of ``scorer.model`` instead, where the others compare
# probabilities within 1e-4 (with f32 matmuls). The logits' bar bounds the
# probabilities' at 1e-4, as the sigmoid's slope is at most 1/4.
SATURATING = ("fignn",)
SATURATED_LOGIT_BAR = 4e-4
# The step-1 gradient bar, as a share of a parameter's max|g|, of a model
# trained with bf16 matmul inputs on the card against the CPU: each
# ``bf16_matmul`` rounds its input cotangent to bf16, and the two devices'
# f32 sums can put it one bf16 step (2^-8 of itself) apart; that step flows
# on, summed, into every parameter below the tower (FiBiNET's embedding
# table: 1.26e-3 of max|g| in every run, against 1.4e-6 with f32 matmuls).
BF16_PATH_RTOL = 2.0 ** -8
# Ids per field of the learning phase. At 1,000 the 262,144 rows overfit
# from the first epoch on, DeepFM (which runs no kernel) as much as xDeepFM:
# each of the 26,000 embedding rows is seen about 210 times an epoch
# (``python3 -m ml_function_tpu_torch.tools.learning_curve``).
LEARN_VOCAB = 100
# DIEN at the JAX package's headline shape (bench.py's DIEN entry): 5,000
# items and 100 categories, histories of 64 (lengths 32..64), dim 8, so
# both recurrences run at H = 2·8 = 16
DIEN_DATA = dict(n_items=5000, n_cates=100, seq_len=64, embed_dim=8, seed=0)
# the JAX package's DIEN learning protocol (CONVERGENCE.md, DIEN parity)
DIEN_LEARN = dict(n_rows=120_000, n_items=40, n_cates=10, seq_len=32, seed=0)
DIEN_AUC_BAR = 0.55
# (B, L, H, what): DIEN's recurrences, SIM's at its two board shapes (B 512
# and B 8, timed beside DIEN's), then the edges: H 64 (the block instances)
# and H 13 (three padded units of the warp instances), each with a B that is
# not a multiple of a block's rows
GRU_SHAPES = ((BATCH, 64, 16, "path"), (512, 64, 16, "sim"), (8, 64, 16, "sim"),
              (300, 7, 64, "ragged"), (301, 9, 13, "ragged"), (1, 1, 8, "tiny"))
# K5 off the path: ragged causal Lq ≠ Lk, Dh 64, Lq 1, then the tensor-core
# tiles' edges: Lq and Lk not multiples of 16 or 8, Lk < 8, one 16-row causal
# tile (B, H, Lq, Lk, Dh, causal); batch row 1 of each has every key masked
FLASH_EDGES = ((3, 2, 1000, 777, 16, True), (2, 2, 600, 900, 64, False),
               (4, 2, 1, 2000, 8, False), (2, 1, 17, 5, 8, True),
               (1, 2, 33, 7, 16, False), (2, 2, 16, 16, 8, True))
SIM_AUC_BAR = 0.64         # tests/test_models_longseq.py:225
# The depth of the (AU)GRU plain versions' times, each call tens to
# hundreds of ms (64 steps of small ops): phase 8's at the path's shapes
# 3 samples of 1 call after 1 (5 of 2 after 3 until phase 26 came, with
# cuDNN's yardstick at 25 of 10, now 5 of 2), F6's wide ones 1 of 1 after 1
# (2 of 1 after 1 until then)
PLAIN_GRU_DEPTH = dict(reps=3, inner=1, warmup=1)
# The depth of phase 3's times (CIN's and K3's kernels, plain versions and
# library calls at each shape) and of K1's at each case: 10 samples of 5
# calls (event_ms's 25 of 10 until the chained step's phase came)
KERNEL_RATES_DEPTH = dict(reps=10, inner=5)
PLAIN_WIDE_GRU_DEPTH = dict(reps=1, inner=1, warmup=1)


T_START = time.perf_counter()


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cin_bound(d: int, b: int, h: int, f: int, o: int, backward: bool = False):
    """Least time of one CIN layer on the card: bf16 products over the
    tensor-core rate against each input read and each output written once.
    Forward: 2·D·B·H·F·O flops; f32 xk, x0, w1 in and y out. Backward: three
    products of that size (U, dxk, dW); xk, x0, w1, dy in and dxk, dx0, dW
    out."""
    if backward:
        flops = 6 * d * b * h * f * o
        nbytes = 4 * (2 * d * b * h + 2 * d * b * f + d * b * o + 2 * h * f * o)
    else:
        flops = 2 * d * b * h * f * o
        nbytes = 4 * (d * b * h + d * b * f + h * f * o + d * b * o)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def _layer_inputs(gen, d, b, h, f, o):
    xk = torch.randn(d, b, h, device="cuda", generator=gen)
    x0 = torch.randn(d, b, f, device="cuda", generator=gen) * 0.05
    w1 = torch.randn(h, f * o, device="cuda", generator=gen) * (2.0 / (h * f + o)) ** 0.5
    return xk, x0, w1


def _check_close(what: str, got, ref) -> tuple:
    """rtol 1e-3 with atol 1e-3·max|ref|; returns (max |err|, atol)."""
    err = (got - ref).abs()
    atol = RTOL * ref.abs().max().item()
    if not bool((err <= atol + RTOL * ref.abs()).all()):
        fail(f"{what} disagrees with its plain version: max |err| "
             f"{err.max().item()} (atol {atol})")
    return err.max().item(), atol


def _entry(name: str, replaces: str, shapes: list, calls: str) -> dict:
    """One kernels-line entry: the numbers summed over the main path's calls
    (the shapes marked ``path``: the CIN's two layers, DIEN's two
    recurrences or its two sequence lookups), every shape's beside."""
    main = [s for s in shapes if s["path"]]
    return {
        "name": name, "route": "cuda",
        "source": f"ml_function_tpu_torch/ops/kernels/csrc/{name}.cu",
        "replaces": replaces,
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        **{k: sum(s[k] for s in main)
           for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
        "bound_by": max(main, key=lambda s: s["bound_ms"])["bound_by"],
        "kernel_ms": sum(s["ms"] for s in main),
        "per": f"the {len(main)} calls of one pass of the main path",
        "library_calls": calls, "per_shape": shapes,
    }


def check_cin_kernel(cin_mod) -> dict:
    """cin_layer_t against cin_layer_t_reference at the two layer shapes of
    the main path (D 8, B 4096, F 26, O 128; H 26 then 128)."""
    from ml_function_tpu_torch.tools.timing import event_ms

    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = []
    for h in (26, 128):
        d, b, f, o = 8, BATCH, 26, 128
        xk, x0, w1 = _layer_inputs(gen, d, b, h, f, o)
        got = cin_mod.cin_layer_t(xk, x0, w1)
        torch.cuda.synchronize()
        err, atol = _check_close(f"cin_fwd at H={h}", got,
                                 cin_mod.cin_layer_t_reference(xk, x0, w1))
        xk_b, w1_b, x0_b = xk.bfloat16(), w1.bfloat16(), x0.bfloat16()
        bound_ms, bound_by = cin_bound(d, b, h, f, o)
        # the shrink toward zero against f64 of the same bf16 operands
        y64 = (torch.matmul(xk_b.double(), w1_b.double()).view(d, b, f, o)
               * x0.double().unsqueeze(-1)).sum(dim=2)
        shrink = (((got.double() - y64) * y64.sign()).mean() / y64.abs().mean()).item()
        del y64
        shapes.append({
            "shape": {"D": d, "B": b, "H": h, "F": f, "O": o}, "path": True,
            "max_abs_err": err, "atol": atol, "shrink": shrink,
            "launch_ms": launch_ms(lambda: cin_mod.cin_layer_t(xk, x0, w1)),
            "ms": event_ms(lambda: cin_mod.cin_layer_t(xk, x0, w1), **KERNEL_RATES_DEPTH),
            "plain_ms": event_ms(lambda: cin_mod.cin_layer_t_reference(xk, x0, w1),
                                 **KERNEL_RATES_DEPTH),
            # two calls: a bf16 GEMM and the F-reduce; no one call computes a CIN layer
            "library_ms": event_ms(lambda: torch.einsum(
                "dbfo,dbf->dbo", torch.matmul(xk_b, w1_b).view(d, b, f, o), x0_b),
                **KERNEL_RATES_DEPTH),
            "bound_ms": bound_ms, "bound_by": bound_by,
        })
    for s in shapes:
        print(f"cin_fwd layer {s['shape']}: max_abs_err {s['max_abs_err']:.3e} "
              f"(atol {s['atol']:.3e}), shrink {s['shrink']:.3e}, kernel {s['ms']:.4f} ms ("
              + ", ".join(f"{k} {v:.4f}" for k, v in s["launch_ms"].items())
              + f" on the device), plain {s['plain_ms']:.4f} ms, library (2 calls) "
              f"{s['library_ms']:.4f} ms, bound {s['bound_ms']:.4f} ms ({s['bound_by']})")
    return _entry("cin_fwd", "ml_function_tpu/ops/kernels/cin.py:49", shapes,
                  "torch.matmul (bf16) + torch.einsum F-reduce, per shape")


def launch_ms(fn, n: int = 20) -> dict:
    """Device ms a call of each kernel ``fn`` launches, by ``torch.profiler``,
    keyed by the kernel's name without its namespace and arguments."""
    from ml_function_tpu_torch.tools.timing import profile_device

    by_name, _, _ = profile_device(fn, n)
    out = {}
    for name, ms in by_name.items():
        short = re.search(r"(\w+_kernel)\b(<[^>]*>)?", name)
        key = short.group(0) if short else name[:60]
        out[key] = out.get(key, 0.0) + ms
    return out


def check_cin_bwd_kernel(cin_mod) -> dict:
    """cin_layer_t_backward against cin_layer_t_backward_reference at the
    main path's two layer shapes, all three outputs; twice more, which must
    give the same bits (fixed split-K partials, no atomics). Times: the
    whole call by events, each of its launches by the profiler."""
    from ml_function_tpu_torch.tools.timing import event_ms

    gen = torch.Generator(device="cuda").manual_seed(2)
    shapes = []
    for h in (26, 128):
        d, b, f, o = 8, BATCH, 26, 128
        xk, x0, w1 = _layer_inputs(gen, d, b, h, f, o)
        dy = torch.randn(d, b, o, device="cuda", generator=gen)
        got = cin_mod.cin_layer_t_backward(xk, x0, w1, dy)
        runs = [cin_mod.cin_layer_t_backward(xk, x0, w1, dy) for _ in range(2)]
        torch.cuda.synchronize()
        ref = cin_mod.cin_layer_t_backward_reference(xk, x0, w1, dy)
        errs = [_check_close(f"cin_bwd {name} at H={h}", g, r)
                for name, g, r in zip(("dxk", "dx0", "dW"), got, ref)]
        if not all(torch.equal(a, b) for again in runs for a, b in zip(got, again)):
            fail(f"cin_bwd differs between three runs at H={h}")
        # three calls: bf16 GEMMs for dxk and dW on a du already in memory,
        # and an einsum for dx0; no one call computes this backward
        xk_b, w1_b, dy_b = xk.bfloat16(), w1.bfloat16(), dy.bfloat16()
        du_b = (x0.unsqueeze(-1) * dy.unsqueeze(2)).reshape(d * b, f * o).bfloat16()
        w3_b = w1_b.view(h, f, o)

        def library():
            torch.matmul(du_b, w1_b.t())
            torch.matmul(xk_b.view(d * b, h).t(), du_b)
            torch.einsum("dbh,hfo,dbo->dbf", xk_b, w3_b, dy_b)

        bound_ms, bound_by = cin_bound(d, b, h, f, o, backward=True)
        shapes.append({
            "shape": {"D": d, "B": b, "H": h, "F": f, "O": o}, "path": True,
            "max_abs_err": max(e for e, _ in errs),
            "max_abs_err_dxk_dx0_dw": [e for e, _ in errs],
            "atol_dxk_dx0_dw": [a for _, a in errs],
            "ms": event_ms(lambda: cin_mod.cin_layer_t_backward(xk, x0, w1, dy),
                           **KERNEL_RATES_DEPTH),
            "plain_ms": event_ms(
                lambda: cin_mod.cin_layer_t_backward_reference(xk, x0, w1, dy),
                **KERNEL_RATES_DEPTH),
            "library_ms": event_ms(library, **KERNEL_RATES_DEPTH),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "launch_ms": launch_ms(lambda: cin_mod.cin_layer_t_backward(xk, x0, w1, dy)),
        })
    for s in shapes:
        print(f"cin_bwd {s['shape']}: max_abs_err dxk/dx0/dW "
              + "/".join(f"{e:.3e}" for e in s["max_abs_err_dxk_dx0_dw"])
              + " (atol " + "/".join(f"{a:.3e}" for a in s["atol_dxk_dx0_dw"])
              + f"), the same bits on three runs, kernel {s['ms']:.4f} ms ("
              + ", ".join(f"{k} {v:.4f}" for k, v in s["launch_ms"].items())
              + f"), plain {s['plain_ms']:.4f} ms, library (3 calls) "
              f"{s['library_ms']:.4f} ms, bound {s['bound_ms']:.4f} ms "
              f"({s['bound_by']})")
    entry = _entry("cin_bwd", "ml_function_tpu/ops/kernels/cin.py:62", shapes,
                   "torch.matmul (bf16) for dxk and for dW + torch.einsum for "
                   "dx0, per shape")
    # each launch's device time, summed over the two layers (whose dW
    # kernels are two instances of one template)
    names = dict.fromkeys(k for s in shapes for k in s["launch_ms"])
    entry["launch_ms"] = {k: sum(s["launch_ms"].get(k, 0.0) for s in shapes) for k in names}
    return entry


def fa_bound(b: int, lq: int, lk: int, h: int, dh: int, backward: bool = False):
    """Least time of one field-attention call on the card: f32 products over
    the f32 CUDA-core rate against each input read and each output written
    once. Forward: 4·B·H·Lq·Lk·Dh flops; q, k, v, bias in, o out. Backward:
    10·B·H·Lq·Lk·Dh (the weights recomputed, dA, dV, dQ, dK); q, k, v, bias,
    dO in, dQ, dK, dV out."""
    n_q, n_k = b * lq * h * dh, b * lk * h * dh
    if backward:
        flops = 10 * b * h * lq * lk * dh
        nbytes = 4 * (2 * n_q + 2 * n_k + b * lk + n_q + 2 * n_k)
    else:
        flops = 4 * b * h * lq * lk * dh
        nbytes = 4 * (n_q + 2 * n_k + b * lk + n_q)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def _fa_inputs(gen, b, lq, lk, h, dh, masked):
    """q, k, v, dO from the generator; with ``masked``, a random key mask
    that keeps key 0, and batch row 1 with every key masked."""
    q, do = (torch.randn(b, lq, h, dh, device="cuda", generator=gen) for _ in range(2))
    k, v = (torch.randn(b, lk, h, dh, device="cuda", generator=gen) for _ in range(2))
    bias = torch.zeros(b, lk, device="cuda")
    if masked:
        mask = torch.rand(b, lk, device="cuda", generator=gen) > 0.3
        mask[:, 0] = True
        mask[1] = False
        bias = torch.where(mask, 0.0, -1e9)
    return q, k, v, bias, do, 1.0 / dh ** 0.5


def check_field_attn_kernels(fa_mod) -> list:
    """field_attention and field_attention_backward against their plain
    versions at AutoInt's shape, the gate's edges and the sequence tier's
    shapes, with times, and whether the forward has the plain version's
    bits (it must at DMIN's shape, ``FA_SEQ[1]``). Where the wrapper picks
    another instance than the block one, the block instance is held and
    timed beside it (the backward's beside the L-64 instance). The library
    yardstick is ``scaled_dot_product_attention`` in f32 with the bias as
    its mask: its forward, and its forward plus backward through
    ``torch.autograd.grad`` less the forward."""
    import torch.nn.functional as F

    from ml_function_tpu_torch.tools.timing import event_ms

    gen = torch.Generator(device="cuda").manual_seed(4)
    fwd_shapes, bwd_shapes = [], []
    for shape in (FA_MAIN,) + FA_EDGES + FA_SEQ:
        b, lq, lk, h, dh = shape
        masked = shape in FA_EDGES
        timed = not masked     # the paths' shapes: on the device too
        q, k, v, bias, do, scale = _fa_inputs(gen, b, lq, lk, h, dh, masked)
        got = fa_mod.field_attention(q, k, v, bias, scale)
        grads = fa_mod.field_attention_backward(q, k, v, bias, do, scale)
        torch.cuda.synchronize()
        where = f"(B={b}, Lq={lq}, Lk={lk}, H={h}, Dh={dh})"
        ref = fa_mod.field_attention_reference(q, k, v, bias, scale)
        err, atol = _check_close(f"field_attn_fwd at {where}", got, ref)
        plain_bits = torch.equal(got, ref)
        if shape == FA_SEQ[1] and not plain_bits:
            fail(f"field_attn_fwd at DMIN's {where} lacks the plain version's bits "
                 f"(max |err| {err})")
        if masked:
            _check_close(f"field_attn_fwd's all-masked row at {where}", got[1],
                         v[1].mean(dim=0, keepdim=True).expand(lq, -1, -1))
        errs = [_check_close(f"field_attn_bwd {name} at {where}", g, r)
                for name, g, r in zip(("dq", "dk", "dv"), grads,
                                      fa_mod.field_attention_backward_reference(
                                          q, k, v, bias, do, scale))]
        again = fa_mod.field_attention_backward(q, k, v, bias, do, scale)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(grads, again)):
            fail(f"field_attn_bwd differs between two runs at {where}")

        # the forward's block instance (which takes every shape of the
        # gate) where the wrapper picks the warp or the L-64 one
        instance = fa_mod.forward_instance(q, k, v, bias)
        block = None
        if instance != "field_attn_fwd":
            block_o = fa_mod.field_attention_forward(q, k, v, bias, scale,
                                                    instance="field_attn_fwd")
            torch.cuda.synchronize()
            block = {"max_abs_err": _check_close(
                f"field_attn_fwd (block instance) at {where}", block_o,
                fa_mod.field_attention_reference(q, k, v, bias, scale))[0]}
            if masked:
                _check_close(f"field_attn_fwd's all-masked row (block instance) at {where}",
                             block_o[1], v[1].mean(dim=0, keepdim=True).expand(lq, -1, -1))
            if timed:
                block["ms"] = event_ms(lambda: fa_mod.field_attention_forward(
                    q, k, v, bias, scale, instance="field_attn_fwd"), **KERNEL_RATES_DEPTH)
                block["device_ms"] = launch_ms(lambda: fa_mod.field_attention_forward(
                    q, k, v, bias, scale, instance="field_attn_fwd"))

        # the backward's block instance where the wrapper picks the L-64 one
        bwd_instance = fa_mod.backward_instance(q, k, v, bias)
        bwd_block = None
        if bwd_instance.endswith("_l64"):
            block_g = fa_mod.field_attention_backward(q, k, v, bias, do, scale,
                                                      instance="field_attn_bwd")
            torch.cuda.synchronize()
            bwd_block = {"max_abs_err": max(
                _check_close(f"field_attn_bwd {name} (block instance) at {where}", g, r)[0]
                for name, g, r in zip(("dq", "dk", "dv"), block_g,
                                      fa_mod.field_attention_backward_reference(
                                          q, k, v, bias, do, scale)))}
            bwd_block["ms"] = event_ms(lambda: fa_mod.field_attention_backward(
                q, k, v, bias, do, scale, instance="field_attn_bwd"), **KERNEL_RATES_DEPTH)
            if timed:
                bwd_block["device_ms"] = launch_ms(lambda: fa_mod.field_attention_backward(
                    q, k, v, bias, do, scale, instance="field_attn_bwd"))

        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
        mask4 = bias[:, None, None, :]
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask4, scale=scale)
        with torch.no_grad():
            sdpa_err = (sdpa().transpose(1, 2) - got).abs().max().item()
            sdpa_fwd_ms = event_ms(sdpa, **KERNEL_RATES_DEPTH)
        do_t = do.transpose(1, 2)
        sdpa_both_ms = event_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), do_t),
                                **KERNEL_RATES_DEPTH)
        common = {"shape": {"B": b, "Lq": lq, "Lk": lk, "H": h, "Dh": dh},
                  "masked": masked}
        fb, fby = fa_bound(b, lq, lk, h, dh)
        fwd_shapes.append({
            **common, "instance": instance, "max_abs_err": err, "atol": atol,
            "plain_bits": plain_bits,
            "ms": event_ms(lambda: fa_mod.field_attention(q, k, v, bias, scale),
                           **KERNEL_RATES_DEPTH),
            "device_ms": (launch_ms(lambda: fa_mod.field_attention(q, k, v, bias, scale))
                          if timed else None),
            "block_instance": block,
            "plain_ms": event_ms(
                lambda: fa_mod.field_attention_reference(q, k, v, bias, scale),
                **KERNEL_RATES_DEPTH),
            "library_ms": sdpa_fwd_ms, "library_max_abs_diff": sdpa_err,
            "bound_ms": fb, "bound_by": fby})
        bb, bby = fa_bound(b, lq, lk, h, dh, backward=True)
        bwd_shapes.append({
            **common, "instance": bwd_instance, "block_instance": bwd_block,
            "max_abs_err": max(e for e, _ in errs),
            "max_abs_err_dq_dk_dv": [e for e, _ in errs],
            "atol_dq_dk_dv": [a for _, a in errs],
            "ms": event_ms(lambda: fa_mod.field_attention_backward(
                q, k, v, bias, do, scale), **KERNEL_RATES_DEPTH),
            "device_ms": (launch_ms(lambda: fa_mod.field_attention_backward(
                q, k, v, bias, do, scale)) if shape in FA_SEQ else None),
            "plain_ms": event_ms(lambda: fa_mod.field_attention_backward_reference(
                q, k, v, bias, do, scale), **KERNEL_RATES_DEPTH),
            "library_ms": sdpa_both_ms - sdpa_fwd_ms,
            "bound_ms": bb, "bound_by": bby})
    for s in fwd_shapes:
        print(f"field_attn_fwd {s['shape']} masked={s['masked']} ({s['instance']}): "
              f"max_abs_err {s['max_abs_err']:.3e} (atol {s['atol']:.3e}), the plain "
              f"version's bits {s['plain_bits']}, kernel "
              f"{s['ms']:.4f} ms (on the device {s['device_ms']}), plain "
              f"{s['plain_ms']:.4f} ms, library (SDPA f32) {s['library_ms']:.4f} ms "
              f"(max |diff| {s['library_max_abs_diff']:.3e}), bound "
              f"{s['bound_ms']:.4f} ms ({s['bound_by']}); block instance {s['block_instance']}")
    for s in bwd_shapes:
        print(f"field_attn_bwd {s['shape']} masked={s['masked']} ({s['instance']}): "
              "the same bits on a second run, max_abs_err dq/dk/dv "
              + "/".join(f"{e:.3e}" for e in s["max_abs_err_dq_dk_dv"])
              + " (atol " + "/".join(f"{a:.3e}" for a in s["atol_dq_dk_dv"])
              + f"), kernel {s['ms']:.4f} ms (on the device {s['device_ms']}), plain "
              f"{s['plain_ms']:.4f} ms, library "
              f"(SDPA f32 forward+backward less forward) {s['library_ms']:.4f} ms, "
              f"bound {s['bound_ms']:.4f} ms ({s['bound_by']}); block instance "
              f"{s['block_instance']}")
    replaces = "ml_function_tpu/ops/kernels/field_attention.py"
    return [_fa_entry("field_attn_fwd", f"{replaces}:77", fwd_shapes,
                      "torch.nn.functional.scaled_dot_product_attention (f32, "
                      "attn_mask = bias), forward"),
            _fa_entry("field_attn_bwd", f"{replaces}:82", bwd_shapes,
                      "scaled_dot_product_attention (f32, attn_mask = bias): "
                      "torch.autograd.grad of its forward, less the forward")]


def _fa_entry(name: str, replaces: str, shapes: list, calls: str,
              per: str = "one call at the main shape (2 a pass)") -> dict:
    """One kernels-line entry: the numbers of one call at the main shape
    (AutoInt's: two calls, one a layer, per forward or backward); every
    shape's beside."""
    main = shapes[0]
    return {
        "name": name, "route": "cuda",
        "source": f"ml_function_tpu_torch/ops/kernels/csrc/{name}.cu",
        "replaces": replaces,
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        **{k: main[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
        **{k: main[k] for k in ("bound_term", "bound_f32_ms", "bound_f32_by") if k in main},
        "kernel_ms": main["ms"], "per": per,
        "library_calls": calls, "per_shape": shapes,
    }


def gru_bound(b: int, l: int, h: int, backward: bool = False):
    """Least time of one (AU)GRU recurrence on the card: f32 work over the
    f32 rate against each input read and each output written once.
    Forward: 2·H·3H for h·wh and about 20 a unit for the gates, per step and
    row; xw, mask, att, h0 in and seq out. Backward: the recomputed h·wh,
    wh·dhh and the dwh product, and about 40 a unit for the gates; xw, seq,
    dseq, mask, att, h0 in and dxw, da, dh0 (and the small dwh) out."""
    steps = b * l
    if backward:
        flops = steps * (18 * h * h + 40 * h)
        nbytes = 4 * (steps * (3 * h + 2 * h + 2 + 3 * h + 1) + 2 * b * h + 3 * h * h)
    else:
        flops = steps * (6 * h * h + 20 * h)
        nbytes = 4 * (steps * (3 * h + 2 + h) + b * h + 3 * h * h)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def _gru_inputs(gen, b, l, h, what, hist_mask):
    """xw, wh, mask, att (and ones), h0, dseq on the card. The path shape
    takes the masks of real histories; 'ragged' draws lengths 1..L, masks
    row 1 at every step and gives a non-zero h0."""
    xw = torch.randn(b, l, 3 * h, device="cuda", generator=gen) * 0.5
    wh = torch.randn(h, 3 * h, device="cuda", generator=gen) / h ** 0.5
    att = torch.rand(b, l, device="cuda", generator=gen)
    dseq = torch.randn(b, l, h, device="cuda", generator=gen)
    h0 = torch.zeros(b, h, device="cuda")
    if what == "path":
        mask = hist_mask.float()
    else:
        lens = torch.randint(1, l + 1, (b,), device="cuda", generator=gen)
        mask = (torch.arange(l, device="cuda")[None, :] < lens[:, None]).float()
        if what == "ragged":
            mask[1] = 0.0
            h0 = torch.randn(b, h, device="cuda", generator=gen) * 0.5
    return xw, wh, mask, att, h0, dseq


def check_gru_kernels(gru_mod, hist_mask) -> list:
    """gru_sequence and gru_sequence_backward against their plain versions,
    with attention gates (gru2, the AUGRU) and with ones (gru1), at DIEN's
    shape and the edges, with times at DIEN's shape. The library yardstick
    is cuDNN's ``torch.nn.GRU`` (f32, TF32 off) with input size 3H and
    hidden H over full-length sequences: the plain GRU once its update gate
    is negated and b_hn is zero, with no mask and no attention gate, so a
    yardstick and never on the path; its backward is forward plus backward
    through ``torch.autograd.grad`` less the forward."""
    from ml_function_tpu_torch.tools.timing import event_ms

    gen = torch.Generator(device="cuda").manual_seed(6)
    fwd_shapes, bwd_shapes = [], []
    for b, l, h, what in GRU_SHAPES:
        xw, wh, mask, att, h0, dseq = _gru_inputs(gen, b, l, h, what, hist_mask)
        lib_fwd_ms = lib_bwd_ms = None
        if what in ("path", "sim"):      # the timed shapes
            rnn = torch.nn.GRU(3 * h, h, batch_first=True).cuda()
            x_in = xw.clone().requires_grad_()
            with torch.no_grad():
                lib_fwd_ms = event_ms(lambda: rnn(x_in), reps=5, inner=2)
            lib_both_ms = event_ms(lambda: torch.autograd.grad(
                rnn(x_in)[0], (x_in, *rnn.parameters()), dseq), reps=5, inner=2)
            lib_bwd_ms = lib_both_ms - lib_fwd_ms
        for gate, a in (("att", att), ("ones", torch.ones_like(att))):
            args = (xw, wh, mask, a, h0)
            where = f"(B={b}, L={l}, H={h}, {what}, {gate})"
            seq = gru_mod.gru_sequence(*args)
            grads = gru_mod.gru_sequence_backward(*args, seq, dseq)
            again = gru_mod.gru_sequence_backward(*args, seq, dseq)
            torch.cuda.synchronize()
            ref_seq = gru_mod.gru_sequence_reference(*args)
            err, atol = _check_close(f"gru_fwd at {where}", seq, ref_seq)
            instance = gru_mod.forward_instance(h)
            block = None
            if instance != "gru_fwd":   # the block instance takes every H
                block_seq = gru_mod.gru_sequence_forward(*args, instance="gru_fwd")
                torch.cuda.synchronize()
                if not torch.equal(block_seq, seq):
                    fail(f"gru_fwd at {where}: {instance} and the block instance differ "
                         f"by up to {(block_seq - seq).abs().max().item()}")
                block = {"same_bits": True}
                if what == "path":
                    block["ms"] = event_ms(lambda: gru_mod.gru_sequence_forward(
                        *args, instance="gru_fwd"))
                    block["device_ms"] = launch_ms(lambda: gru_mod.gru_sequence_forward(
                        *args, instance="gru_fwd"))
            if what == "ragged" and not torch.equal(seq[1], h0[1].expand(l, -1)):
                fail(f"gru_fwd at {where}: the row masked at every step does not "
                     "carry h0")
            ref = gru_mod.gru_sequence_backward_reference(*args, seq, dseq)
            errs = [_check_close(f"gru_bwd {name} at {where}", g, r) for name, g, r
                    in zip(("dxw", "dwh", "da", "dh0"), grads, ref)]
            if not torch.equal(grads[1], again[1]):
                fail(f"gru_bwd dwh differs between two runs at {where}")
            common = {"shape": {"B": b, "L": l, "H": h}, "case": what, "gate": gate,
                      "path": what == "path"}
            fb, fby = gru_bound(b, l, h)
            bb, bby = gru_bound(b, l, h, backward=True)
            timed = what in ("path", "sim")
            fwd_shapes.append({
                **common, "instance": instance, "max_abs_err": err, "atol": atol,
                "ms": event_ms(lambda: gru_mod.gru_sequence(*args)) if timed else None,
                "device_ms": launch_ms(lambda: gru_mod.gru_sequence(*args)) if timed else None,
                "block_instance": block,
                "plain_ms": (event_ms(lambda: gru_mod.gru_sequence_reference(*args),
                                      **PLAIN_GRU_DEPTH) if timed else None),
                "library_ms": lib_fwd_ms, "bound_ms": fb, "bound_by": fby})
            bwd_shapes.append({
                **common, "max_abs_err": max(e for e, _ in errs),
                "max_abs_err_dxw_dwh_da_dh0": [e for e, _ in errs],
                "atol_dxw_dwh_da_dh0": [t for _, t in errs],
                "instance": gru_mod.backward_instance(h),
                "ms": (event_ms(lambda: gru_mod.gru_sequence_backward(*args, seq, dseq))
                       if timed else None),
                "device_ms": (launch_ms(lambda: gru_mod.gru_sequence_backward(
                    *args, seq, dseq)) if timed else None),
                "plain_ms": (event_ms(lambda: gru_mod.gru_sequence_backward_reference(
                    *args, seq, dseq), **PLAIN_GRU_DEPTH) if timed else None),
                "library_ms": lib_bwd_ms, "bound_ms": bb, "bound_by": bby})
    for s in fwd_shapes:
        print(f"gru_fwd {s['shape']} {s['case']} {s['gate']} ({s['instance']}): "
              f"max_abs_err {s['max_abs_err']:.3e} (atol {s['atol']:.3e}); kernel "
              f"{s['ms']} ms (on the device {s['device_ms']}), plain {s['plain_ms']} ms, "
              f"library (cuDNN GRU f32) {s['library_ms']} ms, bound {s['bound_ms']:.4f} ms "
              f"({s['bound_by']}); block instance {s['block_instance']}")
    for s in bwd_shapes:
        print(f"gru_bwd {s['shape']} {s['case']} {s['gate']} ({s['instance']}): "
              "max_abs_err dxw/dwh/da/dh0 "
              + "/".join(f"{e:.3e}" for e in s["max_abs_err_dxw_dwh_da_dh0"])
              + " (atol " + "/".join(f"{t:.3e}" for t in s["atol_dxw_dwh_da_dh0"])
              + f"), dwh bit-identical on a second run; kernel {s['ms']} ms (on the "
              f"device {s['device_ms']}), plain "
              f"{s['plain_ms']} ms, library (cuDNN GRU backward) {s['library_ms']} ms, "
              f"bound {s['bound_ms']:.4f} ms ({s['bound_by']})")
    replaces = "ml_function_tpu/ops/kernels/gru.py"
    return [_entry("gru_fwd", f"{replaces}:54", fwd_shapes,
                   "torch.nn.GRU (cuDNN, f32, input 3H, hidden H) forward, "
                   "once a recurrence"),
            _entry("gru_bwd", f"{replaces}:76", bwd_shapes,
                   "torch.nn.GRU (cuDNN, f32): torch.autograd.grad of its "
                   "forward less the forward, once a recurrence")]


def ms_bound(n: int, d: int, v: int):
    """Least time of one merge-scatter on the card: it must read the ids and
    the f32 cotangents once and write the (V, D) gradient (the sort's
    scratch is not counted); its adds (N·D) are far below the f32 rate."""
    t_bytes = (8 * n + 4 * n * d + 4 * v * d) / PEAK_BYTES
    t_ops = n * d / PEAK_F32_FLOPS
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def _ms_times(eg_mod, ids, ct, s_ids, order, v: int) -> dict:
    """Times of merge_scatter at one lookup: the kernel alone on sorted ids
    and its permutation, the sort alone, the whole backward (sort, kernel),
    the plain version and the library's ``zeros.index_add_`` on the
    unsorted ids by events, the last two also by the profiler."""
    from ml_function_tpu_torch.tools.timing import event_ms

    d = ct.shape[1]
    return dict(
        ms=event_ms(lambda: eg_mod.merge_scatter(s_ids, order, ct, v), **KERNEL_RATES_DEPTH),
        sort_ms=event_ms(lambda: eg_mod._sort(ids), **KERNEL_RATES_DEPTH),
        whole_backward_ms=event_ms(lambda: eg_mod.dense_grad_from_updates(ids, ct, v),
                                   **KERNEL_RATES_DEPTH),
        plain_ms=event_ms(lambda: eg_mod.merge_scatter_reference(s_ids, order, ct, v),
                          **KERNEL_RATES_DEPTH),
        library_ms=event_ms(lambda: torch.zeros(v, d, device="cuda").index_add_(0, ids, ct),
                            **KERNEL_RATES_DEPTH),
        # the same two by the profiler: the card's own time, without the
        # host's, which the events above see at these sizes
        whole_backward_device_ms=sum(launch_ms(
            lambda: eg_mod.dense_grad_from_updates(ids, ct, v)).values()),
        library_device_ms=sum(launch_ms(
            lambda: torch.zeros(v, d, device="cuda").index_add_(0, ids, ct)).values()),
        pad_share=float((ids == ids.min()).float().mean()))


def _print_ms_shape(s: dict) -> None:
    times = (f"; kernel {s['ms']:.4f} ms, sort {s['sort_ms']:.4f} ms, whole backward "
             f"(sort + kernel) {s['whole_backward_ms']:.4f} ms (device "
             f"{s['whole_backward_device_ms']:.4f}), plain {s['plain_ms']:.4f} ms, library "
             f"(index_add_) {s['library_ms']:.4f} ms (device {s['library_device_ms']:.4f}), "
             f"share of the hottest id {s['pad_share']:.3f}" if s["lookup_of"] else "")
    print(f"merge_scatter {s['case']} (N={s['N']}, D={s['D']}, V={s['V']}): "
          f"max_abs_err {s['max_abs_err']:.3e} (atol {s['atol']:.3e}), the same "
          f"bits on a second run{times}; bound {s['bound_ms']:.4f} ms "
          f"({s['bound_by']})")


MS_STEP_KEYS = ("ms", "sort_ms", "whole_backward_ms", "library_ms", "plain_ms", "bound_ms",
                "whole_backward_device_ms", "library_device_ms")


def _print_ms_step(entry: dict, what: str, p: str) -> None:
    print(f"merge_scatter {what}: kernel {entry[p + 'ms']:.4f} ms, sort "
          f"{entry[p + 'sort_ms']:.4f} ms, whole backward "
          f"{entry[p + 'whole_backward_ms']:.4f} ms (device "
          f"{entry[p + 'whole_backward_device_ms']:.4f}), index_add_ "
          f"{entry[p + 'library_ms']:.4f} ms (device {entry[p + 'library_device_ms']:.4f})")


def check_merge_scatter(eg_mod, lookups: dict, num_rows: int, path_lookups: dict) -> dict:
    """merge_scatter against merge_scatter_reference (its plain version: the
    same int32 sort and permutation, ``index_add_`` of ``ct[order]``) at
    DIEN's two sequence lookups (``lookups``: name → (N,) global ids on the
    card, as a train step flattens them), at the other paths' lookups a
    train step (``path_lookups``: path → (lookups, table rows); SIM's three,
    HPMN's and MIMN's two), with all N ids equal (one hot row), with N 0 and
    with ids at V − 1; the kernel twice and the whole backward once, which
    must give the same bits. Times at the lookups: the kernel alone on sorted ids
    and its permutation, the sort alone, the whole backward (sort, kernel),
    the plain version and the library's ``zeros.index_add_`` on the
    unsorted ids, the last two also by the profiler (device time alone)."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    n_path = next(iter(lookups.values())).numel()
    cases = {**{k: (v, "dien", num_rows) for k, v in lookups.items()},
             **{f"{p}_{k}": (v, p, rows) for p, (lk, rows) in path_lookups.items()
                for k, v in lk.items()},
             "all_equal": (torch.full((n_path,), 17, device="cuda"), None, num_rows),
             "empty": (torch.zeros(0, dtype=torch.int64, device="cuda"), None, num_rows),
             "last_row": (torch.randint(num_rows - 3, num_rows, (4096,), device="cuda",
                                        generator=gen), None, num_rows)}
    shapes = []
    for what, (ids, path, v) in cases.items():
        d = 8
        ct = (torch.ones(ids.numel(), d, device="cuda") if what == "all_equal"
              else torch.randn(ids.numel(), d, device="cuda", generator=gen))
        s_ids, order = eg_mod._sort(ids)
        got = eg_mod.merge_scatter(s_ids, order, ct, v)
        again = eg_mod.merge_scatter(s_ids, order, ct, v)
        whole = eg_mod.dense_grad_from_updates(ids, ct, v)
        torch.cuda.synchronize()
        ref = eg_mod.merge_scatter_reference(s_ids, order, ct, v)
        if what == "empty":
            if got.abs().max().item() != 0.0:
                fail("merge_scatter of no ids is not zero")
            err, atol = 0.0, 0.0
        else:
            err, atol = _check_close(f"merge_scatter ({what})", got, ref)
        if not (torch.equal(got, again) and torch.equal(got, whole)):
            fail(f"merge_scatter ({what}) differs between runs")
        if what == "all_equal" and (got[17, 0].item() != float(n_path)
                                    or got[:17].any() or got[18:].any()):
            fail(f"merge_scatter's hot row sums to {got[17, 0].item()}, not {n_path}, "
                 "or another row is not zero")
        bound_ms, bound_by = ms_bound(ids.numel(), d, v)
        entry = {"case": what, "path": path == "dien", "lookup_of": path, "N": ids.numel(),
                 "D": d, "V": v, "max_abs_err": err, "atol": atol, "bound_ms": bound_ms,
                 "bound_by": bound_by, "ms": None, "plain_ms": None, "library_ms": None}
        if path:
            entry.update(_ms_times(eg_mod, ids, ct, s_ids, order, v))
        shapes.append(entry)
    for s in shapes:
        _print_ms_shape(s)
    entry = _entry("merge_scatter", "ml_function_tpu/ops/kernels/embedding_grad.py:59",
                   shapes, "torch.zeros(V, D).index_add_(0, ids, ct) on the unsorted "
                   "ids, once a sequence lookup")
    # the sort and the whole backward beside the kernel, summed over DIEN's
    # two lookups; all five times summed over each other path's lookups
    device = ("whole_backward_device_ms", "library_device_ms")
    for k in ("sort_ms", "whole_backward_ms", *device):
        entry[k] = sum(s[k] for s in shapes if s["lookup_of"] == "dien")
    for p in path_lookups:
        for k in MS_STEP_KEYS:
            entry[f"{p}_step_{k}"] = sum(s[k] for s in shapes if s["lookup_of"] == p)
    for what, p in (("a DIEN step (2 lookups)", ""),
                    *((f"a {q.upper()} step ({len(lk)} lookups)", f"{q}_step_")
                      for q, (lk, _) in path_lookups.items())):
        _print_ms_step(entry, what, p)
    return entry


def plain_gru(gru_mod):
    """The (AU)GRU recurrence on its plain versions in both directions, on
    the card: a hook of this script, not an option of the package."""

    class PlainGRU(torch.autograd.Function):
        @staticmethod
        def forward(ctx, xw, wh, mask, att, h0):
            seq = gru_mod.gru_sequence_reference(xw, wh, mask, att, h0)
            ctx.save_for_backward(xw, wh, mask, att, h0, seq)
            return seq

        @staticmethod
        def backward(ctx, dseq):
            dxw, dwh, da, dh0 = gru_mod.gru_sequence_backward_reference(
                *ctx.saved_tensors, dseq)
            return dxw, dwh, None, da, dh0

    return PlainGRU.apply


def plain_fused_gather(eg_mod):
    """``fused_gather`` with the plain dense gradient, on the card: a hook
    of this script, not an option of the package."""

    class PlainFusedGather(torch.autograd.Function):
        @staticmethod
        def forward(ctx, table, flat_ids):
            ctx.save_for_backward(flat_ids)
            ctx.num_rows = table.shape[0]
            return table.index_select(0, flat_ids)

        @staticmethod
        def backward(ctx, ct):
            (ids,) = ctx.saved_tensors
            return eg_mod.dense_grad_reference(ids, ct, ctx.num_rows), None

    return PlainFusedGather.apply


def plain_field_attention(fa_mod):
    """Field attention on its plain versions in both directions, on the
    card: a hook of this script, not an option of the package."""

    class PlainFieldAttention(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, bias, scale):
            ctx.save_for_backward(q, k, v, bias)
            ctx.scale = scale
            return fa_mod.field_attention_reference(q, k, v, bias, scale)

        @staticmethod
        def backward(ctx, do):
            return (*fa_mod.field_attention_backward_reference(
                *ctx.saved_tensors, do, ctx.scale), None, None)

    return PlainFieldAttention.apply


@contextlib.contextmanager
def swapped(module, attr: str, plain):
    """``module.attr`` is ``plain`` inside the block."""
    real = getattr(module, attr)
    setattr(module, attr, plain)
    try:
        yield
    finally:
        setattr(module, attr, real)


def _rows(data: dict, n) -> dict:
    """The first n rows of a dataset (or the rows of an index array),
    ``seq`` included."""
    take = slice(n) if isinstance(n, int) else n
    return {k: _rows(v, n) if isinstance(v, dict) else v[take] for k, v in data.items()}


def expect(**counts) -> dict:
    """Launch counts of every kernel, 0 where not given."""
    return {name: counts.get(name, 0) for name in KERNELS}


def plain_cin_layer(cin_mod):
    """The CIN layer on its plain versions in both directions, on the card:
    a hook of this script, not an option of the package."""

    class PlainCIN(torch.autograd.Function):
        @staticmethod
        def forward(ctx, xk_t, x0_t, w1):
            ctx.save_for_backward(xk_t, x0_t, w1)
            return cin_mod.cin_layer_t_reference(xk_t, x0_t, w1)

        @staticmethod
        def backward(ctx, dy_t):
            return cin_mod.cin_layer_t_backward_reference(*ctx.saved_tensors, dy_t)

    return PlainCIN.apply


def _adam_steps(model, init: dict, batches) -> tuple:
    """Adam steps from the weights ``init``, one a batch: (losses, step-1
    gradients)."""
    from ml_function_tpu_torch.train.loop import make_train_step
    from ml_function_tpu_torch.train.optimizers import make_optimizer

    model.load_state_dict(init)
    step = make_train_step(model, make_optimizer("adam", 1e-3).init(model))
    losses, grads = [], None
    for b in batches:
        losses.append(step(b)["loss"].item())
        if grads is None:   # AutoInt's unread linear table has no gradient
            grads = {n: p.grad.detach().clone()
                     for n, p in model.named_parameters() if p.grad is not None}
    return losses, grads


def _bf16_step(x):
    """One bf16 step at each element of the bf16-valued tensor ``x``:
    2^(e - 8) for |x| in [2^(e-1), 2^e); 0 at 0."""
    _, e = torch.frexp(x)
    return torch.where(x == 0, 0.0, torch.ldexp(torch.ones_like(x), e - 8))


def _one_bf16_step(g, r):
    """Where ``g`` and ``r`` are both bf16 values (R3: a weight gradient
    through ``bf16_matmul`` is rounded to bf16), the elements that are
    neighbouring bf16 values; None where either tensor is not bf16."""
    if not all(bool((t == t.bfloat16().float()).all()) for t in (g, r)):
        return None
    return (g - r).abs() <= torch.maximum(_bf16_step(g), _bf16_step(r))


def parity_steps(name: str, model, batches, plain_route, drive, launches_by_path,
                 path: str, per_step: dict, block_scaled: tuple = ()) -> None:
    """Adam steps on the kernels, one a batch of ``batches`` (5 on most
    paths), against the same steps from the same weights on the plain
    versions (``plain_route()`` forces every kernel of
    the model there, both directions): losses within 1e-3 relative, step-1
    gradients within 1e-3·max|g| of their own parameter, and ``per_step``
    launches a step. A weight gradient is rounded to bf16 (R3), so an f32
    difference far below the bar can land an element on the neighbouring
    bf16 value, 2^-8 of itself away: two bf16 neighbours count as agreeing,
    and the run says how many elements needed that. For the parameters
    under a prefix in ``block_scaled`` max|g| is the block's: the gradients
    of DIEN's target-attention MLP biases are residues of sums that cancel
    (the softmax over steps does not see a shift of every score, so its
    head bias's gradient is zero but for rounding)."""
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    losses, grads = drive(path, lambda: _adam_steps(model, init, batches))
    with plain_route():
        ref_losses, ref_grads = _adam_steps(model, init, batches)
    model.load_state_dict(init)
    compare_runs(name, losses, grads, ref_losses, ref_grads, "the plain run",
                 block_scaled, f"launches {launches_by_path[path]}",
                 len(batches[0]["label"]))
    if launches_by_path[path] != expect(**{k: len(batches) * v for k, v in per_step.items()}):
        fail(f"expected {per_step} launches per train step")


def compare_runs(name: str, losses, grads, ref_losses, ref_grads, ref_name: str,
                 block_scaled: tuple = (), note: str = "", b: int = BATCH,
                 grad_rtol: float = RTOL, model_scaled: tuple = ()) -> None:
    """Two runs of 5 Adam steps from the same weights: losses within 1e-3
    relative, step-1 gradients within ``grad_rtol``·max|g| (+ 1e-3·|g|) of
    their own parameter (two bf16 neighbours agreeing, as ``parity_steps``
    says); max|g| is the block's under a prefix in ``block_scaled`` and the
    whole model's under one in ``model_scaled`` (blocks whose gradients are
    rounding residues many orders below the model's, whose own max|g| and
    gap are printed)."""
    rel = [abs(a - r) / abs(r) for a, r in zip(losses, ref_losses)]
    print(f"{name} training parity, {len(losses)} Adam steps at B={b}: losses {losses}, "
          f"{ref_name} {ref_losses}, max rel diff {max(rel):.3e}; {note}")
    if not all(np.isfinite(losses)) or max(rel) > 1e-3:
        fail(f"{name} training losses differ from {ref_name} by more than 1e-3")
    if grads.keys() != ref_grads.keys():
        fail(f"{name}: the two runs give gradients to different parameters")
    worst, bad, stepped = 0.0, [], []
    block_max = {p: max(r.abs().max().item() for n, r in ref_grads.items()
                        if n.startswith(p)) for p in block_scaled}
    model_max = max(r.abs().max().item() for r in ref_grads.values())
    for p in model_scaled:
        own = max(ref_grads[n].abs().max().item() for n in ref_grads if n.startswith(p))
        gap = max((grads[n] - ref_grads[n].to(grads[n].device)).abs().max().item()
                  for n in ref_grads if n.startswith(p))
        print(f"{name}: {p}* gradients, own max|g| {own:.3e}, largest gap {gap:.3e}, "
              f"held at the model's max|g| {model_max:.3e}")
    block_max.update({p: model_max for p in model_scaled})
    for n, g in grads.items():
        r = ref_grads[n].to(g.device)
        scale = next((v for p, v in block_max.items() if n.startswith(p)),
                     r.abs().max().item())
        atol = grad_rtol * scale
        err = (g - r).abs()
        ok = err <= atol + RTOL * r.abs()
        near = _one_bf16_step(g, r)
        if near is not None and not bool(ok.all()):
            stepped.append(f"{n} {int((near & ~ok).sum())}")
            ok |= near
        if not bool(ok.all()):
            bad.append(f"{n}: max |err| {err.max().item()} (atol {atol}, own max|g| "
                       f"{r.abs().max().item()})")
        worst = max(worst, err.max().item() / max(scale, 1e-30))
    if bad:
        fail(f"step-1 gradients differ from {ref_name}: " + "; ".join(bad))
    print(f"step-1 gradients of {len(grads)} parameters against {ref_name}: "
          f"max |err|/max|g| {worst:.3e} (bar {grad_rtol:.3e}); elements past the "
          f"bar but one bf16 step apart: {', '.join(stepped) or 'none'}")


def order_witness(model, batch, plain_route, fl_mod) -> None:
    """The plain run against itself, only the plain flash attention's chunk
    of query rows changed from ``PLAIN_CHUNK`` to a sixteenth of it, so
    only the f32 summation order differs: each step-1 gradient's largest
    gap to its own max|g|, and whether every differing element of a bf16
    gradient is one bf16 step away. It shows what the parity bar's bf16
    step stands for; it checks nothing."""
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    runs = []
    for chunk in (fl_mod.PLAIN_CHUNK, fl_mod.PLAIN_CHUNK >> 4):
        with plain_route(), swapped(fl_mod, "PLAIN_CHUNK", chunk):
            runs.append(_adam_steps(model, init, [batch])[1])
    model.load_state_dict(init)
    parts = []
    for n, g in runs[0].items():
        gap = (g - runs[1][n]).abs().max().item() / max(g.abs().max().item(), 1e-30)
        near = _one_bf16_step(g, runs[1][n])
        kind = ("bf16 neighbours" if near is not None and bool(near.all())
                else "not bf16 neighbours")
        parts.append((gap, f"{n} {gap:.3e} ({kind})"))
    print("order witness (the plain run with a sixteenth of the chunk of query "
          "rows): largest step-1 gradient gaps to their own max|g|: "
          + ", ".join(t for _, t in sorted(parts, reverse=True)[:4]))


@contextlib.contextmanager
def quiet_host():
    """Within the block every process this script started and that still
    runs (``cpu_checks``' workers, CPU gloo ranks) is stopped, and it goes
    on at the block's end, whatever fails: a rate taken inside reads the
    host as a run with no CPU side beside it does (phases 4 to 17, and
    every earlier log ``tools/step_times`` pairs with this one)."""
    import multiprocessing
    import signal

    stopped = []
    try:
        for p in multiprocessing.active_children():
            try:
                os.kill(p.pid, signal.SIGSTOP)
                stopped.append(p.pid)
            except ProcessLookupError:
                pass
        yield
    finally:
        for pid in stopped:
            try:
                os.kill(pid, signal.SIGCONT)
            except ProcessLookupError:
                pass


def step_rates(name: str, model, batches, what: str, host_steps: int = 20,
               event_reps: tuple = (10, 5), profile: bool = False) -> None:
    """Training examples/s at the batches' size (median of ``host_steps``
    steps, host clock, each batch from the host), device time per step (CUDA
    events, batch on the card: the median of ``event_reps[0]`` samples of
    ``event_reps[1]`` steps each) and peak memory; with ``profile``, the
    card's busy time and its share of the window of one step under
    ``torch.profiler``, and the kernels that take most of it. Taken with
    no CPU side running (``quiet_host``)."""
    from ml_function_tpu_torch.models.base import as_tensors
    from ml_function_tpu_torch.tools.timing import event_ms, profile_device
    from ml_function_tpu_torch.train.loop import make_train_step
    from ml_function_tpu_torch.train.optimizers import make_optimizer

    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    step = make_train_step(model, make_optimizer("adam", 1e-3).init(model))
    on_card = as_tensors(batches[0], torch.device("cuda"))
    reps, inner = event_reps
    with quiet_host():
        for b in batches[:3]:
            step(b)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for i in range(host_steps):
            t = time.perf_counter()
            step(batches[i % len(batches)])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        peak = torch.cuda.max_memory_allocated() / 2**20
        step_ms = event_ms(lambda: step(on_card), reps=reps, inner=inner)
        if profile:
            by_kernel, busy, window = profile_device(lambda: step(on_card), 1)
    if profile:
        top = ", ".join(f"{k[:48]} {v:.3f}" for k, v in list(by_kernel.items())[:4])
        print(f"{name} training at B={len(batches[0]['label'])}, profiled: busy "
              f"{busy:.3f} ms of a {window:.3f} ms window a step ({100 * busy / window:.1f}% "
              f"busy), {sum(1 for _ in by_kernel)} kernel names; most: {top} ms")
    wall = statistics.median(walls)
    model.load_state_dict(init)
    b = len(batches[0]["label"])
    print(f"{name} training at B={b} ({what}): {wall * 1e3:.3f} ms a step, "
          f"{b / wall:.1f} examples/s (median of {host_steps}, host clock, batch from "
          f"host); device time per step {step_ms:.4f} ms (CUDA events, median of "
          f"{reps} samples of {inner} steps, batch on the card, "
          f"{b / step_ms * 1e3:.1f} examples/s); peak memory {peak:.1f} MiB")


def fit_run(name: str, model, tr, te, drive, launches_by_path, path: str,
            per_step: dict, per_eval: dict, batch_size: int = BATCH, **fit_kw):
    """``fit`` on a learning cell with the launches it must make: per_step a
    train step and per_eval an eval batch. Returns its FitResult."""
    from ml_function_tpu_torch.train.loop import fit

    t = time.perf_counter()
    ts, res = drive(path, lambda: fit(model, tr, batch_size=batch_size, eval_data=te,
                                      seed=0, **fit_kw))
    fit_s = time.perf_counter() - t
    evals = (len(res.history.records) if res.history else 0) + 1   # and the last
    eval_batches = evals * -(-len(te["label"]) // batch_size)
    got = launches_by_path[path]
    by_epoch = res.history.series("auc") if res.history else None
    print(f"{name} fit: {res.steps} steps of B={batch_size} in {fit_s:.1f} s, "
          f"{res.examples_per_sec:.1f} examples/s (fit's timer); held-out AUC by "
          f"epoch {by_epoch}, best at step {res.best_step}; train "
          f"{res.train_metrics}; eval {res.eval_metrics}; launches {got}")
    want = expect(**{k: per_step.get(k, 0) * res.steps + per_eval.get(k, 0) * eval_batches
                     for k in set(per_step) | set(per_eval)})
    if got != want:
        fail(f"{name} fit launched {got}; expected {want} ({res.steps} steps, "
             f"{eval_batches} eval batches)")
    return res


def train_phase(model_name: str, plain_route, kernels: tuple, paths: tuple,
                auc_bar: float, drive, launches_by_path) -> None:
    """xDeepFM or AutoInt at Criteo width: (a) ``parity_steps``, (b)
    ``step_rates``, (c) ``fit`` on the learning cell. ``kernels`` are the
    model's forward and backward kernels, each launched twice a step;
    ``paths`` name the parity and fit runs in ``launches_by_path``."""
    from ml_function_tpu_torch.features.synthetic import make_criteo_like
    from ml_function_tpu_torch.models import get_model
    from ml_function_tpu_torch.train.loop import iter_batches, train_test_split

    fwd, bwd = kernels
    parity_path, fit_path = paths
    fs, data = make_criteo_like(n_rows=5 * BATCH, vocab_size=100_000, seed=0)
    model = get_model(model_name, fs, generator=torch.Generator().manual_seed(0))
    if next(model.parameters()).device.type != "cuda":
        fail("get_model did not place the model on the card by default")
    batches = list(iter_batches(data, BATCH))
    parity_steps(model_name, model, batches, plain_route, drive, launches_by_path,
                 parity_path, {fwd: 2, bwd: 2})
    step_rates(model_name, model, batches, "Criteo width, vocab 100k")
    del model

    # learning through fit, with the reference's early-stopping recipe: an
    # eval each epoch, patience 2, the best epoch's weights restored
    fs, data = make_criteo_like(n_rows=262_144, vocab_size=LEARN_VOCAB, seed=0)
    tr, te = train_test_split(data, 0.2, seed=1)
    model = get_model(model_name, fs, generator=torch.Generator().manual_seed(0))
    steps_per_epoch = -(-len(tr["label"]) // BATCH)
    res = fit_run(model_name, model, tr, te, drive, launches_by_path, fit_path,
                  {fwd: 2, bwd: 2}, {fwd: 2}, epochs=3, learning_rate=5e-3,
                  eval_every=steps_per_epoch, patience=2)
    auc = res.eval_metrics["auc"]
    print(f"{model_name} held-out AUC {auc:.4f}")
    if not auc > auc_bar:
        fail(f"{model_name} held-out AUC {auc} is not above {auc_bar}")


def score_phase(name: str, scorer, data, drive, launches_by_path, plain_route,
                per_batch: dict, route: str = "kernel", event_reps: tuple = (25, 10),
                saturates: bool = False) -> dict:
    """Score ``data`` through ``predict_proba`` on the card: finite
    probabilities in (0, 1), ``per_batch`` launches a batch and none of any
    other kernel, and scores within 1e-4 of the same scorer on the plain
    route; with ``saturates`` (a model whose logits pass f32's sigmoid
    range) probabilities in [0, 1] and the logits of ``scorer.model`` on the
    two routes within ``SATURATED_LOGIT_BAR``. Then examples/s over full
    batches and one forward's device time (``score_rates``). Returns the
    scores and the batch that forward was timed on, already on the card."""
    if next(scorer.model.parameters()).device.type != "cuda":
        fail("load_scorer did not place the model on the card by default")
    n_rows, b = len(data["label"]), scorer.batch_size
    scores = drive(name, lambda: scorer.predict_proba(data))
    launches = launches_by_path[name]
    n_batches = -(-n_rows // b)
    print(f"{name}: {n_rows} rows in {n_batches} batches of {b}, "
          f"launches {launches}")
    if scores.shape != (n_rows,) or not np.isfinite(scores).all():
        fail(f"scores not finite or of shape {scores.shape}")
    if not (((scores >= 0) & (scores <= 1)) if saturates else ((scores > 0) & (scores < 1))).all():
        fail("scores outside " + ("[0, 1]" if saturates else "(0, 1)"))
    want = expect(**{k: v * n_batches for k, v in per_batch.items()})
    if launches != want:
        fail(f"{name} launched {launches}, expected {want}")

    # the same model with its kernel forced through the plain version
    if saturates:
        logits = scorer_logits(scorer, data)
        with plain_route():
            ref_logits = scorer_logits(scorer, data)
        diff = float(np.abs(logits - ref_logits).max())
        print(f"{name} vs the plain version: max |logit diff| {diff:.3e} ("
              f"{int(((scores == 0) | (scores == 1)).sum())} probabilities at exactly 0 or 1)")
        if diff > SATURATED_LOGIT_BAR:
            fail(f"logits differ from the plain version's by {diff}")
    else:
        with plain_route():
            ref_scores = scorer.predict_proba(data)
        diff = float(np.abs(scores - ref_scores).max())
        print(f"{name} vs the plain version: max |score diff| {diff:.3e}")
        if diff > 1e-4:
            fail(f"scores differ from the plain version's by {diff}")
    batch = score_rates(name, scorer, data, route, event_reps)
    return scores, batch


def score_rates(name: str, scorer, data, route: str, event_reps: tuple = (25, 10)
                ) -> dict:
    """Scoring rate at the scorer's batch size over 3 full batches (host
    batching, copies and the forward, as a caller of predict_proba sees it)
    and one forward's device time on a batch already on the card (the
    median of ``event_reps[0]`` samples of ``event_reps[1]`` forwards),
    which is returned. Taken with no CPU side running (``quiet_host``)."""
    from ml_function_tpu_torch.models.base import as_tensors
    from ml_function_tpu_torch.tools.timing import event_ms

    b = scorer.batch_size
    full = _rows(data, 3 * b)
    batch = as_tensors(_rows(data, b), torch.device("cuda"))
    with quiet_host():
        scorer.predict_proba(full)
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            scorer.predict_proba(full)
            walls.append(time.perf_counter() - t)
        with torch.inference_mode():
            fwd_ms = event_ms(lambda: scorer.model(batch), reps=event_reps[0],
                              inner=event_reps[1])
    wall = statistics.median(walls)
    print(f"{name} at B={b} ({route} route): predict_proba {wall * 1e3:.3f} ms for "
          f"{3 * b} rows, {3 * b / wall:.1f} examples/s; one forward on "
          f"the card {fwd_ms:.4f} ms ({b / fwd_ms * 1e3:.1f} examples/s); "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    return batch


def scorer_logits(scorer, data) -> np.ndarray:
    """The logits whose sigmoid ``scorer.predict_proba(data)`` returns, in
    f64 on the host."""
    from ml_function_tpu_torch.train.loop import iter_batches

    out = []
    with torch.inference_mode():
        for batch in iter_batches(data, scorer.batch_size):
            out.append(scorer.model(batch, train=False)[0].double().cpu())
    return torch.cat(out).numpy()[:len(data["label"])]


@contextlib.contextmanager
def dien_route(model, kernel: bool):
    """DIEN on the kernel route (``kernel = 'pallas'`` on ``gru1`` and
    ``gru2``, and the merge-scatter flag's module attribute set, since the
    flag is read at import) or on the reference's default ('scan', flag
    off) inside the block."""
    from ml_function_tpu_torch.ops import embedding

    saved = (model.gru1.kernel, model.gru2.kernel, embedding._USE_MERGE_SCATTER)
    model.gru1.kernel = model.gru2.kernel = "pallas" if kernel else "scan"
    embedding._USE_MERGE_SCATTER = kernel
    try:
        yield
    finally:
        model.gru1.kernel, model.gru2.kernel, embedding._USE_MERGE_SCATTER = saved


def dien_phases(drive, launches_by_path) -> list:
    """Phases 8-10: the (AU)GRU and merge-scatter kernels against their plain
    versions, then DIEN serving and training at full width. Returns the
    three kernels' entries."""
    from ml_function_tpu_torch.features.synthetic import make_behavior_data
    from ml_function_tpu_torch.models import get_model
    from ml_function_tpu_torch.ops import embedding, recurrent
    from ml_function_tpu_torch.ops.kernels import _build
    from ml_function_tpu_torch.ops.kernels import embedding_grad as eg_mod
    from ml_function_tpu_torch.ops.kernels import gru as gru_mod
    from ml_function_tpu_torch.serving import export_model, load_scorer
    from ml_function_tpu_torch.tools.profile_scoring import SIM_SHAPES, sim_batch
    from ml_function_tpu_torch.train.loop import iter_batches, train_test_split

    t = time.perf_counter()
    fs, data = make_behavior_data(n_rows=5 * BATCH, **DIEN_DATA)
    print(f"DIEN data: {5 * BATCH} rows in {time.perf_counter() - t:.1f} s, "
          f"table {fs.total_vocab} rows")

    # 8. the kernels at the path's shapes: the masks and ids of a batch
    head = _rows(data, BATCH)["seq"]
    hist_mask = torch.as_tensor(head["hist_item"] != 0, device="cuda")
    lookups = {name: torch.as_tensor(ids.reshape(-1).astype(np.int64)
                                     + fs.seq_offset(name), device="cuda")
               for name, ids in head.items()}
    # SIM's three lookups a train step at its production shape (B 512): the
    # two short histories and the re-gather of the top 256 of the stream (its
    # first 256 ids stand in for them)
    sim_fs, sim_data = sim_batch(SIM_SHAPES["production"][0])
    sim_seq = dict(sim_data["seq"], hist_long=sim_data["seq"]["hist_long"][:, :256])
    sim_lookups = {name: torch.as_tensor(ids.reshape(-1).astype(np.int64)
                                         + sim_fs.seq_offset(name), device="cuda")
                   for name, ids in sim_seq.items()}
    # HPMN's and MIMN's two at the board's rows (B 2048 and B 1024, every id
    # of the bench's behavior batch valid)
    path_lookups = {"sim": (sim_lookups, sim_fs.total_vocab)}
    for label, b in (("hpmn", 2048), ("mimn", 1024)):
        b_fs, b_data = seq_board_batch(b)
        path_lookups[label] = ({name: torch.as_tensor(
            ids.reshape(-1).astype(np.int64) + b_fs.seq_offset(name), device="cuda")
            for name, ids in b_data["seq"].items()}, b_fs.total_vocab)
    entries = [*check_gru_kernels(gru_mod, hist_mask),
               check_merge_scatter(eg_mod, lookups, fs.total_vocab, path_lookups)]

    @contextlib.contextmanager
    def plain_dien():
        with swapped(recurrent, "gru_sequence", plain_gru(gru_mod)), \
                swapped(embedding, "fused_gather", plain_fused_gather(eg_mod)):
            yield

    # 9. serving, through the gru_fwd kernel
    model = get_model("dien", fs, generator=torch.Generator().manual_seed(0))
    with tempfile.TemporaryDirectory(dir=_build.BUILD) as tmp:
        export_model(tmp, "dien", fs, model, hyperparams={})
        del model
        scorer = load_scorer(tmp, batch_size=BATCH)
    serve = _rows(data, 3 * BATCH + 1000)
    with dien_route(scorer.model, kernel=True):
        scores, _ = score_phase("dien_serving", scorer, serve, drive, launches_by_path,
                                plain_dien, {"gru_fwd": 2})
    with dien_route(scorer.model, kernel=False):
        scan_scores = drive("dien_serving_scan", lambda: scorer.predict_proba(serve))
        diff = float(np.abs(scores - scan_scores).max())
        print(f"dien_serving vs the 'scan' route: max |score diff| {diff:.3e}; "
              f"launches {launches_by_path['dien_serving_scan']}")
        if diff > 1e-4 or launches_by_path["dien_serving_scan"] != expect():
            fail(f"DIEN's kernel route scores differ from the 'scan' route's by {diff}, "
                 "or the scan route launched a kernel")
        # the 'scan' route's rates at BOARD_RATES_DEPTH (a forward takes 42 ms
        # and a step 150 ms there): a cut of depth that keeps the run under
        # 600 s with phases 20 and 21
        score_rates("dien_serving", scorer, serve, "scan", BOARD_RATES_DEPTH["event_reps"])
    del scorer

    # 10. training: parity and rates at full width, then fit on both routes
    per_step = {"gru_fwd": 2, "gru_bwd": 2, "merge_scatter": 2}
    model = get_model("dien", fs, generator=torch.Generator().manual_seed(0))
    batches = list(iter_batches(data, BATCH))
    with dien_route(model, kernel=True):
        parity_steps("dien", model, batches, plain_dien, drive, launches_by_path,
                     "dien_training_parity", per_step, block_scaled=("attn.",))
        step_rates("dien", model, batches, "kernel route, merge-scatter on")
    with dien_route(model, kernel=False):
        step_rates("dien", model, batches, "'scan' route, flag off", **BOARD_RATES_DEPTH)
    del model, batches

    fs, data = make_behavior_data(**DIEN_LEARN)
    tr, te = train_test_split(data, 0.2, seed=0)
    auc = {}
    for kernel, path in ((True, "dien_fit"), (False, "dien_fit_scan")):
        model = get_model("dien", fs, generator=torch.Generator().manual_seed(0))
        with dien_route(model, kernel):
            res = fit_run(path, model, tr, te, drive, launches_by_path, path,
                          per_step if kernel else {}, {"gru_fwd": 2} if kernel else {},
                          epochs=3, learning_rate=1e-3)
        auc[kernel] = res.eval_metrics["auc"]
        print(f"{path}: held-out AUC {auc[kernel]:.4f}, GAUC "
              f"{res.eval_metrics['gauc']:.4f}")
        del model
    bar = DIEN_AUC_BAR if auc[False] >= DIEN_AUC_BAR else auc[False] - 0.01
    if not (auc[True] > bar and abs(auc[True] - auc[False]) <= 0.01):
        fail(f"DIEN held-out AUC {auc[True]} (kernel route) is not above {bar} or "
             f"not within 0.01 of the 'scan' route's {auc[False]}")
    return entries

def needed_pairs(mask, lq: int, causal: bool) -> int:
    """(batch row, query, key) triples the function needs: each query's
    valid keys (up to its own position when causal); all Lk keys for a
    query with none valid, whose output is their mean. A masked key adds
    exactly 0 to any other row."""
    lk = mask.shape[1]
    if causal:
        upto = torch.arange(lq, device=mask.device).clamp(max=lk - 1)
        cnt = mask.long().cumsum(dim=1)[:, upto]
    else:
        cnt = mask.long().sum(dim=1, keepdim=True).expand(-1, lq)
    return int(torch.where(cnt > 0, cnt, lk).sum().item())


def flash_bound(b: int, h: int, lq: int, lk: int, dh: int, pairs: int, kind: str):
    """Least time of one flash-attention call on the card, counting the
    ``pairs`` (batch row, query, key) triples the function needs (every one
    at the path's shape, whose keys are all valid) and each input read and
    each output written once. fwd: 4·pairs·H·Dh flops; q, k, v, bias in, o
    and lse out. dq: 6·…; q, k, v, bias, lse, dO, δ in, dQ out. dkv: 8·…;
    the same in, dK and dV out. One exponential a pair in each.

    Returns (bound_ms, bound_by, bound_term, bound_f32_ms, bound_f32_by):
    the bound of f32-accurate work as the kernels do it, the largest of
    three split-TF32 tensor-core passes of the products, the exponentials on
    the SFU and the bytes (``bound_term`` names which); and the old bound,
    the flops at the CUDA cores' f32 rate against the bytes."""
    work = pairs * h * dh
    nq, nk, rows = b * h * lq * dh, b * h * lk * dh, b * h * lq
    flops, floats = {"fwd": (4 * work, 2 * nq + 2 * nk + b * lk + rows),
                     "dq": (6 * work, 3 * nq + 2 * nk + b * lk + 2 * rows),
                     "dkv": (8 * work, 2 * nq + 4 * nk + b * lk + 2 * rows)}[kind]
    t_bytes = 4 * floats / PEAK_BYTES
    terms = {"tensor cores": SPLIT_TF32_PASSES * flops / PEAK_TF32_FLOPS,
             "SFU": pairs * h / SFU_EXP_RATE, "bytes": t_bytes}
    term = max(terms, key=terms.get)
    t_f32 = flops / PEAK_F32_FLOPS
    return (terms[term] * 1e3, "bytes" if term == "bytes" else "operations", term,
            max(t_f32, t_bytes) * 1e3, "operations" if t_f32 > t_bytes else "bytes")


def _sdpa_ms(q, k, v, bias, do, scale, o):
    """The library yardstick: ``scaled_dot_product_attention`` in f32 with
    the bias as an additive mask on its memory-efficient backend (the math
    backend would form the 17 GB score matrix): its forward, and forward
    plus backward through ``torch.autograd.grad`` less the forward, with its
    max |diff| from the kernel's o. (None, None, None) where that backend
    refuses the call."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from ml_function_tpu_torch.tools.timing import event_ms

    qt, kt, vt = (t.clone().requires_grad_() for t in (q, k, v))
    mask4 = bias[:, None, None, :]
    try:
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=mask4, scale=scale)
            with torch.no_grad():
                diff = (sdpa() - o).abs().max().item()
                fwd = event_ms(sdpa, reps=5, inner=2)
            both = event_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), do),
                            reps=5, inner=2)
    except RuntimeError as e:
        print(f"SDPA yardstick refused: {str(e).splitlines()[0]}")
        return None, None, None
    return fwd, both - fwd, diff


def check_flash_kernels(fl_mod, path_mask) -> list:
    """The three flash-attention kernels against their plain versions at
    SIM's flash-ESU shape (B 8, H 2, Lq = Lk = 16,384, Dh 8, the key mask
    ``path_mask`` of phase 13's batch) and at ``FLASH_EDGES``, with ragged
    key masks and a batch row 1 whose keys are all masked (mean(V) over
    the Lk keys, where the batch has a row 1); each kernel twice, which
    must give the same bits. The backward kernels take the plain forward's lse and δ, so each
    is held alone. Times, the plain versions' and SDPA's at the path's
    shape."""
    from ml_function_tpu_torch.tools.timing import event_ms

    gen = torch.Generator(device="cuda").manual_seed(10)
    b0, l0 = path_mask.shape
    out = {"fwd": [], "dq": [], "dkv": []}
    for shape in ((b0, 2, l0, l0, 8, False),) + FLASH_EDGES:
        b, h, lq, lk, dh, causal = shape
        path = not out["fwd"]
        q, do = (torch.randn(b, h, lq, dh, device="cuda", generator=gen) for _ in range(2))
        k, v = (torch.randn(b, h, lk, dh, device="cuda", generator=gen) for _ in range(2))
        if path:
            mask = path_mask
        else:
            lens = torch.randint(lk // 2, lk + 1, (b,), device="cuda", generator=gen)
            mask = torch.arange(lk, device="cuda")[None, :] < lens[:, None]
            if b > 1:
                mask[1] = False
        bias = torch.where(mask, 0.0, fl_mod.NEG_INF)
        scale = 1.0 / dh ** 0.5
        where = f"(B={b}, H={h}, Lq={lq}, Lk={lk}, Dh={dh}, causal={causal})"
        fwd_args = (q, k, v, bias, scale, causal)
        o, lse = fl_mod.flash_attention_forward(*fwd_args)
        o2, lse2 = fl_mod.flash_attention_forward(*fwd_args)
        torch.cuda.synchronize()
        if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
            fail(f"flash_fwd differs between two runs at {where}")
        o_ref, lse_ref = fl_mod.flash_attention_reference(*fwd_args)
        err, atol = _check_close(f"flash_fwd o at {where}", o, o_ref)
        live = mask.any(dim=1)
        err_lse, _ = _check_close(f"flash_fwd lse at {where}", lse[live], lse_ref[live])
        if not path and b > 1:
            _check_close(f"flash_fwd's all-masked row at {where}", o[1],
                         v[1].mean(dim=1, keepdim=True).expand(-1, lq, -1))
        delta = (do * o_ref).sum(dim=-1)
        bwd_args = (q, k, v, bias, lse_ref, do, delta, scale, causal)
        dq = fl_mod.flash_attention_backward_dq(*bwd_args)
        dkv = fl_mod.flash_attention_backward_dkv(*bwd_args)
        again = (fl_mod.flash_attention_backward_dq(*bwd_args),
                 *fl_mod.flash_attention_backward_dkv(*bwd_args))
        torch.cuda.synchronize()
        ref = fl_mod.flash_attention_backward_reference(*bwd_args)
        err_dq = _check_close(f"flash_bwd_dq at {where}", dq, ref[0])
        err_kv = [_check_close(f"flash_bwd_dkv {n} at {where}", g, r)
                  for n, g, r in zip(("dk", "dv"), dkv, ref[1:])]
        if not all(torch.equal(x, y) for x, y in zip((dq, *dkv), again)):
            fail(f"flash backward kernels differ between two runs at {where}")
        pairs = needed_pairs(mask, lq, causal)
        common = {"shape": {"B": b, "H": h, "Lq": lq, "Lk": lk, "Dh": dh},
                  "causal": causal, "path": path,
                  "valid_keys": int(mask.sum().item()), "needed_pairs": pairs}
        timed = dict.fromkeys(("ms", "plain_ms", "library_ms"))
        t = {k: dict(timed) for k in out}
        if path:
            t["fwd"]["ms"] = event_ms(lambda: fl_mod.flash_attention_forward(*fwd_args),
                                      reps=10, inner=3)
            t["dq"]["ms"] = event_ms(lambda: fl_mod.flash_attention_backward_dq(*bwd_args),
                                     reps=10, inner=3)
            t["dkv"]["ms"] = event_ms(
                lambda: fl_mod.flash_attention_backward_dkv(*bwd_args), reps=10, inner=3)
            t["fwd"]["plain_ms"] = event_ms(
                lambda: fl_mod.flash_attention_reference(*fwd_args), reps=3, inner=1, warmup=1)
            # one plain function computes dq, dk and dv together: its time
            # stands beside each backward kernel
            t["dq"]["plain_ms"] = t["dkv"]["plain_ms"] = event_ms(
                lambda: fl_mod.flash_attention_backward_reference(*bwd_args),
                reps=3, inner=1, warmup=1)
            lib_fwd, lib_bwd, lib_diff = _sdpa_ms(q, k, v, bias, do, scale, o)
            t["fwd"]["library_ms"] = lib_fwd
            t["dq"]["library_ms"] = t["dkv"]["library_ms"] = lib_bwd
            common["library_max_abs_diff"] = lib_diff
        for kind, errs in (("fwd", [(err, atol), (err_lse, None)]), ("dq", [err_dq]),
                           ("dkv", err_kv)):
            bound, by, term, bound_f32, by_f32 = flash_bound(b, h, lq, lk, dh, pairs, kind)
            out[kind].append({**common, **t[kind],
                              "max_abs_err": max(e for e, _ in errs),
                              "max_abs_err_parts": [e for e, _ in errs],
                              "bound_ms": bound, "bound_by": by, "bound_term": term,
                              "bound_f32_ms": bound_f32, "bound_f32_by": by_f32})
    for kind, shapes in out.items():
        for s_ in shapes:
            times = (f"; kernel {s_['ms']:.4f} ms, plain {s_['plain_ms']:.4f} ms, "
                     f"library (SDPA f32, memory-efficient) {s_['library_ms']} ms"
                     if s_["path"] else "")
            print(f"flash_{kind} {s_['shape']} causal={s_['causal']}: max_abs_err "
                  + "/".join(f"{e:.3e}" for e in s_["max_abs_err_parts"])
                  + f", the same bits on a second run{times}; bound "
                  f"{s_['bound_ms']:.4f} ms ({s_['bound_term']}), at the f32 rate "
                  f"{s_['bound_f32_ms']:.4f} ms")
    replaces = "ml_function_tpu/ops/kernels/flash_attention.py"
    per = "one call at SIM's flash-ESU shape (1 a forward, or a train step)"
    return [_fa_entry("flash_fwd", f"{replaces}:53", out["fwd"],
                      "scaled_dot_product_attention (f32, memory-efficient, "
                      "attn_mask = bias), forward", per),
            _fa_entry("flash_bwd_dq", f"{replaces}:99", out["dq"],
                      "scaled_dot_product_attention (f32, memory-efficient): "
                      "torch.autograd.grad of its forward less the forward, dq, "
                      "dk and dv together; the plain time is also all three", per),
            _fa_entry("flash_bwd_dkv", f"{replaces}:143", out["dkv"],
                      "the same SDPA backward as flash_bwd_dq's, all three "
                      "gradients; the plain time is also all three", per)]


@contextlib.contextmanager
def plain_flash(fl_mod):
    """The three flash-attention wrappers swapped for their plain versions
    on the card: a hook of this script, not an option of the package.
    ``FlashAttention`` calls the wrappers by their module names, so both
    directions take the plain route; each backward wrapper runs the whole
    plain backward and keeps its part."""
    ref = fl_mod.flash_attention_backward_reference
    with swapped(fl_mod, "flash_attention_forward", fl_mod.flash_attention_reference), \
            swapped(fl_mod, "flash_attention_backward_dq", lambda *a: ref(*a)[0]), \
            swapped(fl_mod, "flash_attention_backward_dkv", lambda *a: ref(*a)[1:]):
        yield


def planted_longseq_data(n_rows=2400, n_items=60, L=96, n_plant=6, seed=0):
    """A copy of ``_planted_longseq_data`` (tests/test_models_longseq.py):
    half the rows carry the candidate item n_plant times in a noise stream
    of L items, and the label follows that repeat-click signal; the short
    history is noise, so only a model that searches the stream can tell the
    classes apart."""
    from ml_function_tpu_torch.features.schema import FeatureSet, SeqSpec, SparseSpec

    rng = np.random.default_rng(seed)
    iv = n_items + 1
    cand = rng.integers(1, iv, n_rows).astype(np.int32)
    hist_long = rng.integers(1, iv, (n_rows, L)).astype(np.int32)
    planted = rng.random(n_rows) < 0.5
    for i in np.where(planted)[0]:
        pos = rng.choice(L, n_plant, replace=False)
        hist_long[i, pos] = cand[i]
    label = np.where(planted, rng.random(n_rows) < 0.85,
                     rng.random(n_rows) < 0.15).astype(np.float32)
    hist_short = rng.integers(1, iv, (n_rows, 8)).astype(np.int32)
    fs = FeatureSet(
        sparse=(SparseSpec("item", iv, vocab_name="item", dim=8),),
        seq=(SeqSpec("hist_item", iv, 8, vocab_name="item", dim=8),
             SeqSpec("hist_long", iv, L, vocab_name="item", dim=8)))
    data = {"dense": np.zeros((n_rows, 0), np.float32), "sparse": cand[:, None],
            "seq": {"hist_item": hist_short, "hist_long": hist_long}, "label": label}
    return fs, data


def sim_phases(drive, launches_by_path) -> list:
    """Phases 11-14: the flash-attention kernels against their plain
    versions, SIM serving and training at the production and the flash-ESU
    shapes (the DIEN core on the (AU)GRU kernels with the merge-scatter
    gradient), and SIM learning the planted lifelong signal. Returns the
    three flash kernels' entries."""
    from ml_function_tpu_torch.models import get_model
    from ml_function_tpu_torch.ops import embedding, recurrent
    from ml_function_tpu_torch.ops.kernels import _build
    from ml_function_tpu_torch.ops.kernels import embedding_grad as eg_mod
    from ml_function_tpu_torch.ops.kernels import flash_attention as fl_mod
    from ml_function_tpu_torch.ops.kernels import gru as gru_mod
    from ml_function_tpu_torch.serving import export_model, load_scorer
    from ml_function_tpu_torch.tools.profile_scoring import SIM_SHAPES, sim_batch
    from ml_function_tpu_torch.train.loop import iter_batches, train_test_split

    # the JAX board's two SIM rows (bench.py:756-769) on the bench's behavior
    # batch, MLP (200, 80): 'production' soft search keeping the top 256 at
    # B 512, 'flash' hard search over the whole stream at B 8
    t = time.perf_counter()
    data = {shape: sim_batch(5 * b) for shape, (b, _) in SIM_SHAPES.items()}
    print(f"SIM data: {sum(len(d['label']) for _, d in data.values())} rows in "
          f"{time.perf_counter() - t:.1f} s")

    # 11. the flash kernels, at the key mask of phase 13's first batch
    _, flash_data = data["flash"]
    path_mask = torch.as_tensor(flash_data["seq"]["hist_long"][:SIM_SHAPES["flash"][0]] != 0,
                                device="cuda")
    entries = check_flash_kernels(fl_mod, path_mask)

    @contextlib.contextmanager
    def plain_sim():
        with swapped(recurrent, "gru_sequence", plain_gru(gru_mod)), \
                swapped(embedding, "fused_gather", plain_fused_gather(eg_mod)), \
                plain_flash(fl_mod):
            yield

    # 12.-13. serving and training at both shapes: per batch 2 gru_fwd (and 1
    # flash_fwd through the flash ESU); per train step 2 + 2 of K4, 3 of K1
    # (the stream's lookup, soft search's re-gather of the top k, and the two
    # short histories' lookups: 1 + 2) and 1 + 1 + 1 of K5 through the flash ESU
    for shape, (b, hp) in SIM_SHAPES.items():
        fs, d = data[shape]
        tag = f"sim_{shape}"
        flash = hp["search"] == "hard"
        k5 = dict.fromkeys(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), 1) if flash else {}
        model = get_model("sim", fs, generator=torch.Generator().manual_seed(0),
                          hidden=(200, 80), **hp)
        with tempfile.TemporaryDirectory(dir=_build.BUILD) as tmp:
            export_model(tmp, "sim", fs, model, hyperparams=hp)
            del model
            scorer = load_scorer(tmp, batch_size=b)
        with dien_route(scorer.model.dien, kernel=True):
            score_phase(f"{tag}_serving", scorer, _rows(d, 3 * b + b // 2 + 1), drive,
                        launches_by_path, plain_sim,
                        {"gru_fwd": 2, **({"flash_fwd": 1} if flash else {})})
        del scorer
        model = get_model("sim", fs, generator=torch.Generator().manual_seed(0),
                          hidden=(200, 80), **hp)
        batches = list(iter_batches(d, b))
        per_step = {"gru_fwd": 2, "gru_bwd": 2, "merge_scatter": 3, **k5}
        with dien_route(model.dien, kernel=True):
            parity_steps(tag, model, batches, plain_sim, drive, launches_by_path,
                         f"{tag}_training_parity", per_step,
                         block_scaled=("attn.", "dien.attn."))
            if flash:
                order_witness(model, batches[0], plain_sim, fl_mod)
            step_rates(tag, model, batches, f"{hp['search']} search, kernel routes")
        del model, batches

    # 14. learning: the JAX test's protocol on its planted lifelong data; the
    # ESU over the top 8 (head dim 4) takes the field-attention kernel under
    # ML_FUNCTION_TPU_FIELD_ATTN=1, which this script sets for AutoInt
    fs, d = planted_longseq_data()
    tr, te = train_test_split(d, test_frac=0.2, seed=0)
    model = get_model("sim", fs, generator=torch.Generator().manual_seed(0), hidden=(16, 8),
                      search="soft", top_k=8, candidate=("item",), behavior=("hist_item",),
                      long_behavior=("hist_long",))
    with dien_route(model.dien, kernel=True):
        res = fit_run("sim_fit", model, tr, te, drive, launches_by_path, "sim_fit",
                      {"gru_fwd": 2, "gru_bwd": 2, "merge_scatter": 2,
                       "field_attn_fwd": 1, "field_attn_bwd": 1},
                      {"gru_fwd": 2, "field_attn_fwd": 1},
                      batch_size=128, epochs=8, learning_rate=1e-2, eval_every=60)
    auc = res.eval_metrics["auc"]
    print(f"sim_fit: held-out AUC {auc:.4f} on the planted lifelong signal")
    if not auc > SIM_AUC_BAR:
        fail(f"SIM held-out AUC {auc} is not above {SIM_AUC_BAR}")
    return entries


# F6's shapes: the CIN layer past the block instances at Criteo width
# (D 8, B 4096, F 26, O 128; H 384 and 512), the edge (B 1000, F 39, H 1024),
# and H 176, the widest the block backward takes (its 128-row tiles), which
# both instances of each kernel take. The main path's H 26 and 128 are on
# the block instances' side.
CIN_WIDE = ((8, BATCH, 384, 26, 128), (8, BATCH, 512, 26, 128), (8, 1000, 1024, 39, 128))
CIN_BOTH = (8, BATCH, 176, 26, 128)
# (B, L, H): DIEN's recurrences at kd 128 and 256, and two edges of the wide
# instances (H 65, the first; H 1100, five blocks and wh from the L2)
GRU_WIDE = ((BATCH, 64, 128), (BATCH, 64, 256), (300, 7, 65), (37, 5, 1100))
# DIEN at dim 64: kd = 2·64 = 128, both recurrences on the wide instances
DIEN_WIDE_DATA = dict(DIEN_DATA, embed_dim=64)
INTERACTION_TRAIN_BATCH = 16384   # the JAX board's smallest batch (bench.py:97)
# (label, registry name, hyperparameters): every interaction model of the
# port, the registry's defaults but for DCN's cross network, taken both ways
INTERACTION_MODELS = (
    ("dlrm", "dlrm", {}), ("fibinet", "fibinet", {}), ("lr", "lr", {}),
    ("fm", "fm", {}), ("fnn", "fnn", {}), ("ffm", "ffm", {}), ("fwfm", "fwfm", {}),
    ("pnn", "pnn", {}), ("deepcross", "deepcross", {}), ("wide_deep", "wide_deep", {}),
    ("dcn", "dcn", {}), ("dcn_v2", "dcn", {"version": 2}), ("nfm", "nfm", {}),
    ("afm", "afm", {}), ("mmoe", "mmoe", {}), ("esmm", "esmm", {}), ("ple", "ple", {}),
    ("ccpm", "ccpm", {}), ("fgcnn", "fgcnn", {}), ("flen", "flen", {}),
    ("onn", "onn", {}), ("fat_deepffm", "fat_deepffm", {}), ("fignn", "fignn", {}),
    ("mlr", "mlr", {}), ("oenn", "oenn", {}))
# K3 launches a forward under the flag: FiGNN's field self-attention
INTERACTION_K3 = {"fignn": 1}
# the largest |z|, over its layer's max, of a ReLU decision the CPU's
# bf16-path step may take from the card (``card_against_cpu``): FGCNN's
# tower sits behind its bf16-rounded recombination layers, whose inputs can
# round to neighbouring bf16 values on the two devices (R3), so its bar is
# one bf16 step, as phase 19's; the other models keep 1e-5
INTERACTION_DECISION_BAR = {"fgcnn": BF16_PATH_RTOL}
# Ids a field of the card-against-CPU check of FFM, ONN and FAT-DeepFFM,
# whose CPU side would otherwise hold the run past 600 s (their (V, 26·4)
# field-aware tables hold 270 M parameters at 100k ids, whose export and
# CPU Adam steps take 30 s to a minute a model; FFM joined them when phase
# 22 came, the whole run taking 595.5 s on an H100 with FFM at 100k): the
# same widths, a tenth of the rows. All three's B-16,384 rates are taken at
# the board's 100k ids.
CPU_CHECK_VOCAB = {"ffm": 10_000, "onn": 10_000, "fat_deepffm": 10_000}
# the depth of the rates of phases 18 to 21, to keep the run under 600 s:
# training (``step_rates``), the host clock's one step and the events' one
# sample of 1 step (the earlier phases' 20 and 10 × 5; 8 and 5 × 2 until
# phase 23 came, 4 and 3 × 2 until phases 24 and 25 came, when a run from a
# `git archive` took 593.8 s; 2 and 2 × 1 until a run from a `git archive`
# took 624.9 s on a host whose phases 18 to 21 took 302 s against an
# earlier run's 247); one forward (``score_rates``), the events' 1 sample
# of 1 (their 25 × 10)
BOARD_RATES_DEPTH = dict(host_steps=1, event_reps=(1, 1))


def check_wide_cin(cin_mod) -> tuple:
    """F6, CIN: cin_layer_t and its backward against the plain versions at
    ``CIN_WIDE`` (the backward three times, the same bits), each shape's
    instances named and timed; at ``CIN_BOTH`` the two instances of each
    direction against each other. Returns the per-shape records of the
    forward and of the backward."""
    from ml_function_tpu_torch.tools.timing import event_ms

    gen = torch.Generator(device="cuda").manual_seed(11)
    fwd, bwd = [], []
    for d, b, h, f, o in CIN_WIDE:
        xk, x0, w1 = _layer_inputs(gen, d, b, h, f, o)
        dy = torch.randn(d, b, o, device="cuda", generator=gen)
        where = f"(D={d}, B={b}, H={h}, F={f}, O={o})"
        fi, bi = cin_mod.forward_instance(h, f), cin_mod.backward_instance(h, f)
        if (fi, bi) != ("cin_fwd_wide", "cin_bwd_wide"):
            fail(f"CIN at {where} takes {fi} and {bi}, not the wide instances")
        cin_mod.instance_launches.clear()
        y = cin_mod.cin_layer_t(xk, x0, w1)
        got = cin_mod.cin_layer_t_backward(xk, x0, w1, dy)
        runs = [cin_mod.cin_layer_t_backward(xk, x0, w1, dy) for _ in range(2)]
        torch.cuda.synchronize()
        if cin_mod.instance_launches != {fi: 1, bi: 3}:
            fail(f"CIN at {where} launched {cin_mod.instance_launches}, not {fi} and {bi}")
        err, atol = _check_close(f"{fi} at {where}", y, cin_mod.cin_layer_t_reference(xk, x0, w1))
        ref = cin_mod.cin_layer_t_backward_reference(xk, x0, w1, dy)
        errs = [_check_close(f"{bi} {n} at {where}", g, r)
                for n, g, r in zip(("dxk", "dx0", "dW"), got, ref)]
        del ref
        if not all(torch.equal(a, c) for again in runs for a, c in zip(got, again)):
            fail(f"{bi} differs between three runs at {where}")
        library_fwd, library_bwd = _cin_library(xk, x0, w1, dy)
        shape = {"D": d, "B": b, "H": h, "F": f, "O": o}
        fb, fby = cin_bound(d, b, h, f, o)
        bb, bby = cin_bound(d, b, h, f, o, backward=True)
        fwd.append({
            "shape": shape, "path": False, "instance": fi, "max_abs_err": err, "atol": atol,
            "ms": event_ms(lambda: cin_mod.cin_layer_t(xk, x0, w1), reps=10, inner=3),
            "plain_ms": event_ms(lambda: cin_mod.cin_layer_t_reference(xk, x0, w1),
                                 reps=3, inner=1, warmup=1),
            "library_ms": event_ms(library_fwd, reps=5, inner=2),
            "bound_ms": fb, "bound_by": fby})
        bwd.append({
            "shape": shape, "path": False, "instance": bi,
            "max_abs_err": max(e for e, _ in errs),
            "max_abs_err_dxk_dx0_dw": [e for e, _ in errs],
            "atol_dxk_dx0_dw": [a for _, a in errs],
            "ms": event_ms(lambda: cin_mod.cin_layer_t_backward(xk, x0, w1, dy),
                           reps=5, inner=2),
            "plain_ms": event_ms(
                lambda: cin_mod.cin_layer_t_backward_reference(xk, x0, w1, dy),
                reps=3, inner=1, warmup=1),
            "library_ms": event_ms(library_bwd, reps=5, inner=2),
            "bound_ms": bb, "bound_by": bby})
        del got, runs, library_fwd, library_bwd
    for s in fwd:
        print(f"cin_fwd F6 {s['shape']} ({s['instance']}): max_abs_err "
              f"{s['max_abs_err']:.3e} (atol {s['atol']:.3e}), kernel {s['ms']:.4f} ms, plain "
              f"{s['plain_ms']:.4f} ms, library (2 calls) {s['library_ms']:.4f} ms, bound "
              f"{s['bound_ms']:.4f} ms ({s['bound_by']})")
    for s in bwd:
        print(f"cin_bwd F6 {s['shape']} ({s['instance']}): max_abs_err dxk/dx0/dW "
              + "/".join(f"{e:.3e}" for e in s["max_abs_err_dxk_dx0_dw"])
              + " (atol " + "/".join(f"{a:.3e}" for a in s["atol_dxk_dx0_dw"])
              + f"), the same bits on three runs, kernel {s['ms']:.4f} ms, plain "
              f"{s['plain_ms']:.4f} ms, library (3 calls) {s['library_ms']:.4f} ms, bound "
              f"{s['bound_ms']:.4f} ms ({s['bound_by']})")

    # both instances at one shape, where the wrappers take the block ones
    d, b, h, f, o = CIN_BOTH
    if (cin_mod.forward_instance(h, f), cin_mod.backward_instance(h, f)) != ("cin_fwd", "cin_bwd"):
        fail(f"CIN at H {h}, F {f} does not take the block instances")
    xk, x0, w1 = _layer_inputs(gen, d, b, h, f, o)
    dy = torch.randn(d, b, o, device="cuda", generator=gen)
    both = {}
    for fi, bi in (("cin_fwd", "cin_bwd"), ("cin_fwd_wide", "cin_bwd_wide")):
        both[fi] = cin_mod._launch_fwd(xk, x0, w1, instance=fi)
        both[bi] = cin_mod.cin_layer_t_backward(xk, x0, w1, dy, instance=bi)
        both[fi + "_ms"] = event_ms(lambda: cin_mod._launch_fwd(xk, x0, w1, instance=fi),
                                    reps=10, inner=3)
        both[bi + "_ms"] = event_ms(
            lambda: cin_mod.cin_layer_t_backward(xk, x0, w1, dy, instance=bi), reps=5, inner=2)
    torch.cuda.synchronize()
    _check_close(f"cin_fwd_wide at H {h}", both["cin_fwd_wide"],
                 cin_mod.cin_layer_t_reference(xk, x0, w1))
    fdiff = (both["cin_fwd"] - both["cin_fwd_wide"]).abs().max().item()
    bdiff = max((a - c).abs().max().item()
                for a, c in zip(both["cin_bwd"], both["cin_bwd_wide"]))
    print(f"CIN at {CIN_BOTH} (D, B, H, F, O), both instances: cin_fwd vs cin_fwd_wide "
          f"max |diff| {fdiff:.3e} ({both['cin_fwd_ms']:.4f} and {both['cin_fwd_wide_ms']:.4f} "
          f"ms), cin_bwd vs cin_bwd_wide max |diff| {bdiff:.3e} ({both['cin_bwd_ms']:.4f} "
          f"and {both['cin_bwd_wide_ms']:.4f} ms)")
    library_fwd, library_bwd = _cin_library(xk, x0, w1, dy)
    rec = {"shape": dict(zip("DBHFO", CIN_BOTH)), "max_abs_diff_fwd": fdiff,
           "max_abs_diff_bwd": bdiff,
           **{k: v for k, v in both.items() if k.endswith("_ms")},
           "library_fwd_ms": event_ms(library_fwd, reps=5, inner=2),
           "library_bwd_ms": event_ms(library_bwd, reps=5, inner=2),
           "bound_fwd_ms": cin_bound(d, b, h, f, o)[0],
           "bound_bwd_ms": cin_bound(d, b, h, f, o, backward=True)[0]}
    print(f"CIN at {CIN_BOTH}: library (2 calls) {rec['library_fwd_ms']:.4f} ms, bound "
          f"{rec['bound_fwd_ms']:.4f} ms; backward library (3 calls) "
          f"{rec['library_bwd_ms']:.4f} ms, bound {rec['bound_bwd_ms']:.4f} ms")
    return fwd, bwd, rec


def _cin_library(xk, x0, w1, dy):
    """The library yardsticks of one CIN layer at the kernels' bf16 inputs:
    the forward's GEMM and einsum, the backward's two GEMMs and einsum."""
    d, b, h = xk.shape
    f, o = x0.shape[2], dy.shape[2]
    xk_b, w1_b, x0_b, dy_b = xk.bfloat16(), w1.bfloat16(), x0.bfloat16(), dy.bfloat16()
    du_b = (x0.unsqueeze(-1) * dy.unsqueeze(2)).reshape(d * b, f * o).bfloat16()

    def library_fwd():
        torch.einsum("dbfo,dbf->dbo", torch.matmul(xk_b, w1_b).view(d, b, f, o), x0_b)

    def library_bwd():
        torch.matmul(du_b, w1_b.t())
        torch.matmul(xk_b.view(d * b, h).t(), du_b)
        torch.einsum("dbh,hfo,dbo->dbf", xk_b, w1_b.view(h, f, o), dy_b)

    return library_fwd, library_bwd


def check_wide_gru(gru_mod) -> tuple:
    """F6, (AU)GRU: gru_sequence and its backward against the plain versions
    at ``GRU_WIDE``, with attention gates and with ones, ragged masks, row 1
    masked at every step (its seq must be h0) and a non-zero h0. The
    forward must give the plain version's bits, the backward the same bits
    on two runs. Times (kernel, plain, cuDNN's ``nn.GRU``, bound) with
    attention gates. Returns the forward's and the backward's records."""
    from ml_function_tpu_torch.tools.timing import event_ms

    gen = torch.Generator(device="cuda").manual_seed(12)
    fwd, bwd = [], []
    for b, l, h in GRU_WIDE:
        xw, wh, mask, att, h0, dseq = _gru_inputs(gen, b, l, h, "ragged", None)
        for gate, a in (("att", att), ("ones", torch.ones_like(att))):
            args = (xw, wh, mask, a, h0)
            where = f"(B={b}, L={l}, H={h}, {gate})"
            gru_mod.instance_launches.clear()
            seq = gru_mod.gru_sequence(*args)
            grads = gru_mod.gru_sequence_backward(*args, seq, dseq)
            again = gru_mod.gru_sequence_backward(*args, seq, dseq)
            torch.cuda.synchronize()
            fi, bi = gru_mod.forward_instance(h), gru_mod.backward_instance(h)
            if gru_mod.instance_launches != {fi: 1, bi: 2} or fi != "gru_fwd_wide":
                fail(f"(AU)GRU at {where} launched {gru_mod.instance_launches}")
            ref_seq = gru_mod.gru_sequence_reference(*args)
            if not torch.equal(seq, ref_seq):
                fail(f"gru_fwd_wide at {where} is not the plain version's bits: max |err| "
                     f"{(seq - ref_seq).abs().max().item()}")
            if not torch.equal(seq[1], h0[1].expand(l, -1)):
                fail(f"gru_fwd_wide at {where}: the row masked at every step does not carry h0")
            ref = gru_mod.gru_sequence_backward_reference(*args, seq, dseq)
            errs = [_check_close(f"gru_bwd_wide {n} at {where}", g, r)
                    for n, g, r in zip(("dxw", "dwh", "da", "dh0"), grads, ref)]
            if not all(torch.equal(g, r) for g, r in zip(grads, again)):
                fail(f"gru_bwd_wide differs between two runs at {where}")
            common = {"shape": {"B": b, "L": l, "H": h}, "case": "F6", "gate": gate,
                      "path": False}
            fb, fby = gru_bound(b, l, h)
            bb, bby = gru_bound(b, l, h, backward=True)
            timed = gate == "att"
            lib_f = lib_b = None
            if timed:
                rnn = torch.nn.GRU(3 * h, h, batch_first=True).cuda()
                x_in = xw.clone().requires_grad_()
                with torch.no_grad():
                    lib_f = event_ms(lambda: rnn(x_in), reps=5, inner=2)
                lib_b = event_ms(lambda: torch.autograd.grad(
                    rnn(x_in)[0], (x_in, *rnn.parameters()), dseq), reps=5, inner=2) - lib_f
                del rnn, x_in
            fwd.append({
                **common, "instance": fi, "max_abs_err": 0.0, "same_bits_as_plain": True,
                "ms": event_ms(lambda: gru_mod.gru_sequence(*args), reps=5, inner=2)
                if timed else None,
                "plain_ms": event_ms(lambda: gru_mod.gru_sequence_reference(*args),
                                     **PLAIN_WIDE_GRU_DEPTH) if timed else None,
                "library_ms": lib_f, "bound_ms": fb, "bound_by": fby})
            bwd.append({
                **common, "instance": bi, "max_abs_err": max(e for e, _ in errs),
                "dwh_partials": gru_mod._lib("gru_bwd").gru_bwd_wide_partials(b, h),
                "max_abs_err_dxw_dwh_da_dh0": [e for e, _ in errs],
                "atol_dxw_dwh_da_dh0": [t for _, t in errs],
                "ms": event_ms(lambda: gru_mod.gru_sequence_backward(*args, seq, dseq),
                               reps=5, inner=2) if timed else None,
                "plain_ms": event_ms(lambda: gru_mod.gru_sequence_backward_reference(
                    *args, seq, dseq), **PLAIN_WIDE_GRU_DEPTH) if timed else None,
                "library_ms": lib_b, "bound_ms": bb, "bound_by": bby})
    for s in fwd:
        print(f"gru_fwd F6 {s['shape']} {s['gate']} ({s['instance']}): the plain version's "
              f"bits, row 1 carries h0; kernel {s['ms']} ms, plain {s['plain_ms']} ms, "
              f"library (cuDNN GRU f32) {s['library_ms']} ms, bound {s['bound_ms']:.4f} ms "
              f"({s['bound_by']})")
    for s in bwd:
        print(f"gru_bwd F6 {s['shape']} {s['gate']} ({s['instance']}): max_abs_err "
              "dxw/dwh/da/dh0 " + "/".join(f"{e:.3e}" for e in s["max_abs_err_dxw_dwh_da_dh0"])
              + " (atol " + "/".join(f"{t:.3e}" for t in s["atol_dxw_dwh_da_dh0"])
              + f"), the same bits on two runs, {s['dwh_partials']} dwh partials; kernel "
              f"{s['ms']} ms, plain {s['plain_ms']} ms, "
              f"library (cuDNN GRU backward) {s['library_ms']} ms, bound "
              f"{s['bound_ms']:.4f} ms ({s['bound_by']})")
    return fwd, bwd


def wide_cin_phase(drive, launches_by_path, instances_by_path, plain_cin) -> None:
    """xDeepFM at Criteo width with CIN (512, 128): scoring through
    ``load_scorer`` (2 cin_fwd a batch, the second on the wide instance) and
    5 Adam steps against the plain route (2 + 2 a step, the second layer's
    on the wide instances)."""
    from ml_function_tpu_torch.features.schema import criteo_feature_set
    from ml_function_tpu_torch.features.synthetic import make_criteo_like
    from ml_function_tpu_torch.models import get_model
    from ml_function_tpu_torch.ops.kernels import _build
    from ml_function_tpu_torch.serving import export_model, load_scorer
    from ml_function_tpu_torch.train.loop import iter_batches

    fs = criteo_feature_set([100_000] * 26, n_dense=13, embed_dim=8)
    _, data = make_criteo_like(n_rows=5 * BATCH, vocab_size=100_000, seed=3)
    hp = {"cin_hidden": [512, 128], "hidden": [256, 128]}
    model = get_model("xdeepfm", fs, generator=torch.Generator().manual_seed(0),
                      **{k: tuple(v) for k, v in hp.items()})
    with tempfile.TemporaryDirectory(dir=_build.BUILD) as tmp:
        export_model(tmp, "xdeepfm", fs, model, hyperparams=hp)
        scorer = load_scorer(tmp, batch_size=BATCH)
    serve = _rows(data, 3 * BATCH + 1000)
    score_phase("xdeepfm_wide_cin_serving", scorer, serve, drive, launches_by_path,
                plain_cin, {"cin_fwd": 2})
    n_batches = -(-len(serve["label"]) // BATCH)
    if instances_by_path["xdeepfm_wide_cin_serving"] != {"cin_fwd": n_batches,
                                                         "cin_fwd_wide": n_batches}:
        fail(f"xDeepFM (512, 128) scoring took the instances "
             f"{instances_by_path['xdeepfm_wide_cin_serving']}")
    del scorer
    batches = list(iter_batches(data, BATCH))
    parity_steps("xdeepfm_wide_cin", model, batches, plain_cin, drive, launches_by_path,
                 "xdeepfm_wide_cin_training_parity", {"cin_fwd": 2, "cin_bwd": 2})
    want = {"cin_fwd": 5, "cin_fwd_wide": 5, "cin_bwd": 5, "cin_bwd_wide": 5}
    if instances_by_path["xdeepfm_wide_cin_training_parity"] != want:
        fail(f"xDeepFM (512, 128) training took the instances "
             f"{instances_by_path['xdeepfm_wide_cin_training_parity']}, not {want}")
    print(f"xdeepfm_wide_cin instances: serving "
          f"{instances_by_path['xdeepfm_wide_cin_serving']}, 5 train steps {want}")
    step_rates("xdeepfm_wide_cin", model, batches, "CIN (512, 128), Criteo width")


@contextlib.contextmanager
def gru_kernels(model):
    """DIEN's two recurrences on the kernel route, the merge-scatter flag as it is."""
    saved = (model.gru1.kernel, model.gru2.kernel)
    model.gru1.kernel = model.gru2.kernel = "pallas"
    try:
        yield
    finally:
        model.gru1.kernel, model.gru2.kernel = saved


def dien_wide_phase(drive, launches_by_path, instances_by_path) -> None:
    """DIEN at dim 64 (kd 128): scoring through ``load_scorer`` with
    ``kernel = 'pallas'`` on gru1 and gru2 (2 gru_fwd a batch, on the wide
    instance; scores within 1e-4 of the plain versions) and 5 Adam steps
    against the plain route (2 + 2 a step)."""
    from ml_function_tpu_torch.features.synthetic import make_behavior_data
    from ml_function_tpu_torch.models import get_model
    from ml_function_tpu_torch.ops import recurrent
    from ml_function_tpu_torch.ops.kernels import _build
    from ml_function_tpu_torch.ops.kernels import gru as gru_mod
    from ml_function_tpu_torch.serving import export_model, load_scorer
    from ml_function_tpu_torch.train.loop import iter_batches

    fs, data = make_behavior_data(n_rows=5 * BATCH, **DIEN_WIDE_DATA)

    def plain_dien():
        return swapped(recurrent, "gru_sequence", plain_gru(gru_mod))

    model = get_model("dien", fs, generator=torch.Generator().manual_seed(0))
    print(f"DIEN at dim {fs.embed_dim}: GRU hidden {model.gru1.wh.shape[0]}")
    with tempfile.TemporaryDirectory(dir=_build.BUILD) as tmp:
        export_model(tmp, "dien", fs, model, hyperparams={})
        scorer = load_scorer(tmp, batch_size=BATCH)
    serve = _rows(data, 3 * BATCH + 1000)
    with gru_kernels(scorer.model):
        score_phase("dien_kd128_serving", scorer, serve, drive, launches_by_path,
                    plain_dien, {"gru_fwd": 2})
    n_batches = -(-len(serve["label"]) // BATCH)
    if instances_by_path["dien_kd128_serving"] != {"gru_fwd_wide": 2 * n_batches}:
        fail(f"DIEN kd 128 scoring took the instances "
             f"{instances_by_path['dien_kd128_serving']}")
    del scorer
    batches = list(iter_batches(data, BATCH))
    with gru_kernels(model):
        parity_steps("dien_kd128", model, batches, plain_dien, drive, launches_by_path,
                     "dien_kd128_training_parity", {"gru_fwd": 2, "gru_bwd": 2},
                     block_scaled=("attn.",))
        want = {"gru_fwd_wide": 10, "gru_bwd_wide": 10}
        if instances_by_path["dien_kd128_training_parity"] != want:
            fail(f"DIEN kd 128 training took the instances "
                 f"{instances_by_path['dien_kd128_training_parity']}, not {want}")
        step_rates("dien_kd128", model, batches, "kernel route, kd 128")


@contextlib.contextmanager
def relu_decisions(model, masks: dict, impose: bool, flips: list):
    """Within the block, the first forward through each ReLU or PReLU
    ``Activation`` of ``model`` either records which pre-activations are
    positive into ``masks`` (``impose=False``) or takes those decisions
    from ``masks`` (``impose=True``: the output is the input where the
    recorded mask is set and 0, or alpha times the input for a PReLU,
    elsewhere: the same function and gradient wherever the two devices
    agree), appending to ``flips`` each layer's count of pre-activations on
    the other side and the largest of their |z| over the layer's max |z|."""
    from ml_function_tpu_torch.ops.core import Activation

    def hook(i):
        def fn(mod, inputs, out):
            if i in seen:
                return None
            seen.add(i)
            z = inputs[0].detach()
            if not impose:
                masks[i] = z > 0
                return None
            m = masks[i].to(z.device)
            other = (z > 0) != m
            flips.append((int(other.sum()), float(z.abs()[other].max() / z.abs().max())
                          if bool(other.any()) else 0.0))
            if mod.kind == "prelu":
                return torch.where(m, inputs[0], mod.alpha * inputs[0])
            return inputs[0] * m.to(z.dtype)
        return fn

    seen = set()
    acts = [m for m in model.modules()
            if isinstance(m, Activation) and m.kind in ("relu", "prelu")]
    hooks = [m.register_forward_hook(hook(i)) for i, m in enumerate(acts)]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


# The largest margin, over the key's largest |projection|, of an LSH bucket
# that the CPU's first training step takes from the card: f32 rounding with
# f32 matmuls; on the bf16 path a key whose projections' inputs round to
# another bf16 value on the two devices (R3) moves by a few bf16 steps
LSH_MARGIN_BAR = {"1": 1e-5, "0": 2.0 ** -6}
# The largest gap, rank by rank, between the scores two devices' top-k
# choices of SIM's soft search picked, over the row's largest |score|: the
# scores are f32 sums of 8 products (no bf16 site), so only ties within
# their rounding may be broken otherwise
TOPK_GAP_BAR = 1e-5


@contextlib.contextmanager
def lsh_buckets(model, calls: list, impose: list = None, flips: list = None):
    """Within the block, every ``LSHSelfAttention.buckets`` call of
    ``model`` appends (bucket ids, margin) to ``calls``, the margin of a key
    being the gap between its two largest projections over the largest
    |projection|. With ``impose`` (another device's ``calls``) the first
    call of each module and round returns that device's ids instead, and
    ``flips`` gets (keys on another bucket, their largest margin here)."""
    from ml_function_tpu_torch.ops.attention import LSHSelfAttention

    mods = [m for m in model.modules() if isinstance(m, LSHSelfAttention)]
    taken = set()

    def wrap(mod, i):
        real = mod.buckets

        def buckets(qk, r=0):
            ids = real(qk, r)
            proj = qk @ getattr(mod, f"rotation{r}")
            top = torch.cat([proj, -proj], dim=-1).topk(2, dim=-1).values
            margin = (top[..., 0] - top[..., 1]) / top[..., 0].abs().clamp_min(1e-30)
            if impose is not None and (i, r) not in taken:
                taken.add((i, r))
                want = impose[len(calls)][0].to(ids.device)
                other = want != ids
                flips.append((int(other.sum()), float(margin[other].max())
                              if bool(other.any()) else 0.0))
                ids = want
            calls.append((ids.detach().cpu(), margin.detach().cpu()))
            return ids
        return buckets

    for i, m in enumerate(mods):
        m.buckets = wrap(m, i)
    try:
        yield bool(mods)
    finally:
        for m in mods:
            del m.buckets


def bucket_flips(card: list, cpu: list, rows_per_call: int, heads: int, skip: set):
    """Keys whose LSH bucket differs between two devices' ``lsh_buckets``
    records of one scoring pass: (count, largest margin on the CPU, the
    set of data rows they belong to). Rows in ``skip`` (whose attention
    input differs: another top-k choice) count, but their margins do not."""
    n, worst, rows = 0, 0.0, set()
    for i, ((a, _), (b, m)) in enumerate(zip(card, cpu)):
        other = a != b
        if bool(other.any()):
            n += int(other.sum())
            keys = other.nonzero()
            data_rows = i * rows_per_call + keys[:, 0] // heads
            rows.update(data_rows.tolist())
            held = torch.tensor([int(r) not in skip for r in data_rows], dtype=torch.bool)
            if bool(held.any()):
                worst = max(worst, float(m[keys[held, 0], keys[held, 1]].max()))
    return n, worst, rows


@contextlib.contextmanager
def topk_decisions(calls: list, impose: list = None, gaps: list = None):
    """Within the block, every top-k choice of SIM's soft search
    (``models.longseq.top_k_indices``) appends (indices, the scores at them)
    to ``calls``. With ``impose`` (another device's ``calls``) the first
    choice returns that device's indices instead, and ``gaps`` gets (rows
    chosen otherwise, the largest gap rank by rank between the scores here
    at this device's and at that device's choice, over the row's largest
    |score|)."""
    from ml_function_tpu_torch.models import longseq

    real = longseq.top_k_indices

    def top_k(scores, k):
        idx = real(scores, k)
        if impose is not None and not calls:
            want = impose[0][0].to(idx.device)
            other = (want != idx).any(dim=1)
            gap = _score_gap(scores.gather(1, want), scores.gather(1, idx), scores)
            gaps.append((int(other.sum()), float(gap.max())))
            idx = want
        calls.append((idx.detach().cpu(), scores.gather(1, idx).detach().cpu()))
        return idx

    longseq.top_k_indices = top_k
    try:
        yield
    finally:
        longseq.top_k_indices = real


def _score_gap(a, b, scores):
    """Rank by rank, the largest |a − b| of two rows of chosen scores over
    the row's largest finite |score| (masked keys score −inf: equal ones
    give no gap, a masked key against a valid one an infinite gap)."""
    scale = torch.where(torch.isfinite(scores), scores.abs(), 0.0).amax(dim=1)
    diff = torch.where(a == b, 0.0, (a - b).abs())
    return diff.amax(dim=1) / scale.clamp_min(1e-30)


def topk_flips(card: list, cpu: list, rows_per_call: int):
    """Rows whose top-k choice differs between two devices' ``topk_decisions``
    records of one scoring pass: (the set of rows, the largest gap rank by
    rank between the two devices' chosen scores over the row's largest
    |score|)."""
    rows, worst = set(), 0.0
    for i, ((ia, va), (ib, vb)) in enumerate(zip(card, cpu)):
        other = (ia != ib).any(dim=1)
        if bool(other.any()):
            gap = _score_gap(va, vb, vb)
            worst = max(worst, float(gap[other].max()))
            rows.update((i * rows_per_call + other.nonzero()[:, 0]).tolist())
    return rows, worst


# Phases 18 to 22 take the CPU side of ``card_against_cpu`` (the same weights
# scored and trained on the CPU) in CPU_WORKERS spawned processes, while the
# card goes on to its next part and model; each comparison runs when its CPU
# side is done. A worker runs as many threads as this process (a CPU
# reduction's order follows the thread count, and the bf16 path's bars were
# set on this process's order), on all cores but CARD_CORES, which it leaves
# to this process's Python, with OpenMP's threads sleeping when idle
CPU_WORKERS = 2
CARD_CORES = 2
_CPU_SIDE = {}


def _cpu_worker_init(threads: int, cores) -> None:
    if cores:
        os.sched_setaffinity(0, cores)
    torch.set_num_threads(threads)


@contextlib.contextmanager
def cpu_checks():
    """Within the block ``card_against_cpu`` hands its CPU side to the
    worker processes and returns once the card's part is done; its
    comparisons run as the CPU sides finish (``finish_cpu_checks``), and
    the block's end waits for every one of them, in order."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from ml_function_tpu_torch.ops.kernels import _build

    mine = sorted(os.sched_getaffinity(0))
    cores = set(mine[CARD_CORES:]) if len(mine) > 2 * CARD_CORES else None
    wait_policy = os.environ.get("OMP_WAIT_POLICY")
    os.environ["OMP_WAIT_POLICY"] = "PASSIVE"    # read by the workers at their start
    with tempfile.TemporaryDirectory(dir=_build.BUILD) as tmp:
        pool = ProcessPoolExecutor(CPU_WORKERS, mp_context=multiprocessing.get_context("spawn"),
                                   initializer=_cpu_worker_init,
                                   initargs=(torch.get_num_threads(), cores))
        _CPU_SIDE.update(pool=pool, tmp=tmp, pending=[], jobs=0)
        try:
            yield
            finish_cpu_checks(wait=True)
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
            _CPU_SIDE.clear()
            if wait_policy is None:
                os.environ.pop("OMP_WAIT_POLICY")
            else:
                os.environ["OMP_WAIT_POLICY"] = wait_policy


def finish_cpu_checks(wait: bool) -> None:
    """Run the comparisons of the CPU sides that are done (with ``wait``:
    of all of them), in the order their models came."""
    pending = _CPU_SIDE.get("pending", [])
    while pending and (wait or pending[0][0].done()):
        fut, finish = pending.pop(0)
        finish(fut.result())


class _Wire:
    """A CPU tensor as a numpy array for the pipe to and from the workers
    (torch's own pickling of a tensor goes through shared memory, whose
    size the card machine does not promise); bfloat16 as its int16 bits."""

    def __init__(self, t: torch.Tensor):
        t = t.detach().cpu().contiguous()
        self.bf16 = t.dtype == torch.bfloat16
        self.a = (t.view(torch.int16) if self.bf16 else t).numpy()

    def tensor(self) -> torch.Tensor:
        t = torch.from_numpy(self.a)
        return t.view(torch.bfloat16) if self.bf16 else t


def _wire(x, to_wire: bool):
    """``x`` with every tensor in its dicts, lists and tuples made a
    ``_Wire`` (``to_wire``) or made a tensor again."""
    if isinstance(x, dict):
        return {k: _wire(v, to_wire) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_wire(v, to_wire) for v in x)
    if to_wire and isinstance(x, torch.Tensor):
        return _Wire(x)
    if not to_wire and isinstance(x, _Wire):
        return x.tensor()
    return x


def _cpu_side_wired(job: dict) -> dict:
    return _wire(_cpu_side(_wire(job, False)), True)


def _checksums(state: dict) -> dict:
    """Each tensor's shape and the int64 sum of its elements' bits (exact,
    in any order), to hold two copies of the same weights to each other on
    two devices without moving them."""
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = {}
    for k, v in state.items():
        v = v.detach().contiguous()
        bits = v.view(ints[v.element_size()]) if v.is_floating_point() else v
        out[k] = (tuple(v.shape), int(bits.to(torch.int64).sum()))
    return out


def _cpu_side(job: dict) -> dict:
    """The CPU side of ``card_against_cpu``: the exported model loaded on
    the CPU and scored on both matmul paths (its LSH buckets, top-k choices
    and tower inputs recorded), then the same Adam steps as the card's from
    the card's initial weights, each first step taking the card's (P)ReLU,
    LSH and top-k decisions, then the aux terms."""
    from ml_function_tpu_torch.serving import load_scorer

    t0 = time.perf_counter()
    scorer = load_scorer(job["dir"], batch_size=job["batch_size"], device="cpu")
    model = scorer.model
    out = {"scoring": {}, "training": {}}
    for f32 in ("1", "0"):
        os.environ["ML_FUNCTION_TPU_F32_MATMUL"] = f32
        taps = []
        if job["tower"]:
            hook = dict(model.named_modules())[job["tower"]].register_forward_hook(
                lambda mod, inp, o: taps.append(inp[0].detach().bfloat16().cpu()))
        cpu_b, cpu_k = [], []
        with lsh_buckets(model, cpu_b), topk_decisions(cpu_k):
            ref = scorer.predict_proba(job["serve"])
        if job["tower"]:
            hook.remove()
        out["scoring"][f32] = {
            "ref": ref, "cpu_b": cpu_b, "cpu_k": cpu_k, "taps": taps,
            "logits": scorer_logits(scorer, job["serve"]) if job["saturates"] else None}
    # the card's initial weights are the exported ones: each tensor's
    # checksum must be the card's
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    sums = _checksums(init)
    if sums != job["init_sums"]:
        bad = sorted(k for k in sums.keys() | job["init_sums"].keys()
                     if sums.get(k) != job["init_sums"].get(k))
        raise RuntimeError(f"the exported weights are not the card's initial ones: {bad[:5]}")
    cpu_s = 0.0
    for f32 in ("1", "0"):
        os.environ["ML_FUNCTION_TPU_F32_MATMUL"] = f32
        card = job["decisions"][f32]
        flips, cpu_b, b_flips, cpu_k, k_gaps = [], [], [], [], []
        with relu_decisions(model, card["masks"], True, flips), \
                lsh_buckets(model, cpu_b, card["card_b"], b_flips) as lsh, \
                topk_decisions(cpu_k, card["card_k"], k_gaps):
            t = time.perf_counter()
            losses, grads = _adam_steps(model, init, job["batches"])
            cpu_s += time.perf_counter() - t
        out["training"][f32] = {"losses": losses, "grads": grads, "flips": flips,
                                "b_flips": b_flips, "k_gaps": k_gaps, "lsh": lsh}
    os.environ.pop("ML_FUNCTION_TPU_F32_MATMUL")
    model.load_state_dict(init)
    with torch.no_grad():
        out["aux"] = {k: float(v) for k, v in model(job["batches"][0])[2].items()}
    out["cpu_s"] = cpu_s
    out["seconds"] = time.perf_counter() - t0
    return out


def card_against_cpu(label: str, name: str, fs, hp: dict, serve: dict, batches: list,
                     drive, launches_by_path, per_batch: dict, per_step: dict,
                     route: str = "no kernel", block_scaled: tuple = (),
                     tower: str = "", decision_bf16_bar: float = 1e-5,
                     model_scaled: tuple = ()):
    """One model built on the card by ``get_model`` against the same weights
    on the CPU: exported and scored through ``load_scorer`` on features
    alone (finite probabilities, ``per_batch`` launches a batch; with f32
    matmuls on both devices the scores within 1e-4 of the CPU's, on the
    bf16 path the logits within one bf16 step of their max), then an Adam
    step a batch of ``batches`` on the card against the same on the CPU (with
    f32 matmuls and on the bf16 path, ``per_step`` launches a step; the
    CPU's first step takes the card's ReLU and PReLU decisions; max|g| is
    the block's for the parameters under a prefix in ``block_scaled``, as
    ``parity_steps`` says), and each aux term other than ``emb_l2`` card
    against CPU. Returns the model and its scorer on the card, at the
    weights they were built with. It runs inside ``cpu_checks``: the CPU
    side (``_cpu_side``) runs in a worker process and the comparisons when
    it is done.

    ``tower`` names the ``Dense`` whose input is the model's tower input
    (a pooled sequence, whose f32 sums on the two devices can differ by
    more than an ulp after earlier bf16 sites): on the bf16 path a row whose
    logit is past one bf16 step of the max must then be one whose tower
    input rounds to another bf16 value on the card than on the CPU, and
    such rows at most 1% of them. ``decision_bf16_bar`` is the largest |z|,
    over its layer's max, of a decision the CPU's bf16-path step takes from
    the card (1e-5 with f32 matmuls).

    The probabilities are in (0, 1); for a model in ``SATURATING`` they
    are in [0, 1] and the logits of the two scorers' models are compared
    instead (with f32 matmuls within ``SATURATED_LOGIT_BAR``). ``model_scaled``
    prefixes name blocks whose step-1 gradients are held at the model's
    largest max|g| (see ``compare_runs``). For a model with LSH attention
    the bucket ids, and for SIM the soft search's top-k choices, are compared
    card against CPU: a row past the bar must hold a key on another bucket
    or another top-k choice, each within rounding of a tie (``LSH_MARGIN_BAR``;
    ``TOPK_GAP_BAR``), and the CPU's first training step takes the card's
    choices."""
    from ml_function_tpu_torch.models import get_model
    from ml_function_tpu_torch.serving import export_model, load_scorer

    t0 = time.perf_counter()
    model = get_model(name, fs, generator=torch.Generator().manual_seed(0), **hp)
    if next(model.parameters()).device.type != "cuda":
        fail(f"get_model did not place {label} on the card by default")
    if not _CPU_SIDE:
        raise RuntimeError("card_against_cpu runs inside cpu_checks()")
    _CPU_SIDE["jobs"] += 1
    tmp = os.path.join(_CPU_SIDE["tmp"], f"{_CPU_SIDE['jobs']:03d}_{label}")
    os.makedirs(tmp)
    export_model(tmp, name, fs, model, hyperparams=hp)
    scorer = load_scorer(tmp, batch_size=len(batches[0]["label"]))
    times = [time.perf_counter()]
    if next(scorer.model.parameters()).device.type != "cuda":
        fail(f"load_scorer did not place {label} on the card by default")
    n_rows = len(serve["label"])
    n_batches = -(-n_rows // scorer.batch_size)
    saturates = name in SATURATING
    lsh_heads = next((m.num_heads for m in scorer.model.modules() if hasattr(m, "rotation0")),
                     None)
    device = next(scorer.model.parameters()).device
    # the card's part: scores on both matmul paths, with what the CPU's
    # will be held against
    card_scoring = {}
    for f32 in ("1", "0"):
        os.environ["ML_FUNCTION_TPU_F32_MATMUL"] = f32
        path = f"{label}_serving" + ("_f32" if f32 == "1" else "")
        taps = []
        if tower:
            hook = dict(scorer.model.named_modules())[tower].register_forward_hook(
                lambda mod, inp, out: taps.append(inp[0].detach().bfloat16().cpu()))
        card_b, card_k = [], []
        with lsh_buckets(scorer.model, card_b) as lsh, topk_decisions(card_k):
            scores = drive(path, lambda: scorer.predict_proba(serve))
        if tower:
            hook.remove()
        want = expect(**{k: v * n_batches for k, v in per_batch.items()})
        if launches_by_path[path] != want:
            fail(f"{label} scoring launched {launches_by_path[path]}, expected {want}")
        in_range = ((scores >= 0) & (scores <= 1)) if saturates else ((scores > 0) & (scores < 1))
        if scores.shape != (len(serve["label"]),) or not np.isfinite(scores).all() \
                or not in_range.all():
            fail(f"{label} scores are not finite probabilities")
        card_scoring[f32] = {"scores": scores, "taps": taps, "card_b": card_b,
                             "card_k": card_k, "lsh": lsh, "path": path,
                             "launches": launches_by_path[path], "device": device,
                             "rows_per_call": scorer.batch_size,
                             "logits": scorer_logits(scorer, serve) if saturates else None}
    os.environ.pop("ML_FUNCTION_TPU_F32_MATMUL")
    times.append(time.perf_counter())
    score_rates(f"{label}_serving", scorer, serve, route, BOARD_RATES_DEPTH["event_reps"])
    times.append(time.perf_counter())

    # the card's Adam steps on both matmul paths, recording the decisions
    # the CPU's first step takes from them (see the comparison below)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    card_training, decisions = {}, {}
    for f32 in ("1", "0"):
        os.environ["ML_FUNCTION_TPU_F32_MATMUL"] = f32
        path = f"{label}_training" + ("_f32" if f32 == "1" else "")
        masks, card_b, card_k = {}, [], []
        with relu_decisions(model, masks, False, []), lsh_buckets(model, card_b), \
                topk_decisions(card_k):
            losses, grads = drive(path, lambda: _adam_steps(model, init, batches))
        want = expect(**{k: len(batches) * v for k, v in per_step.items()})
        if launches_by_path[path] != want:
            fail(f"{label} training launched {launches_by_path[path]}, expected {want}")
        card_training[f32] = {"losses": losses, "grads": {n: g.cpu() for n, g in grads.items()},
                              "n_decisions": sum(m.numel() for m in masks.values()),
                              "n_keys": card_b[0][0].numel() if card_b else 0,
                              "path": path, "launches": launches_by_path[path]}
        decisions[f32] = {"masks": {i: m.cpu() for i, m in masks.items()},
                          "card_b": card_b, "card_k": card_k}
    os.environ.pop("ML_FUNCTION_TPU_F32_MATMUL")
    model.load_state_dict(init)
    with torch.no_grad():
        card_aux = {k: float(v) for k, v in model(batches[0])[2].items()}
    times.append(time.perf_counter())
    job = {"dir": tmp, "batch_size": scorer.batch_size, "serve": serve, "batches": batches,
           "tower": tower, "saturates": saturates, "init_sums": _checksums(init),
           "decisions": decisions}

    def finish(cpu: dict) -> None:
        compare_card_cpu(label, serve, n_rows, saturates, lsh_heads, tower, block_scaled,
                         model_scaled, decision_bf16_bar, len(batches[0]["label"]),
                         card_scoring, card_training, card_aux, cpu)
        print(f"{label} card against CPU: the card's part {times[-1] - t0:.1f} s (build, "
              f"export and loads {times[0] - t0:.1f}, scoring {times[1] - times[0]:.1f}, rates "
              f"{times[2] - times[1]:.1f}, training {times[3] - times[2]:.1f}); the CPU's "
              f"{cpu['seconds']:.1f} s, of it its steps {cpu['cpu_s']:.1f} (in a worker "
              f"process)")

    fut = _CPU_SIDE["pool"].submit(_cpu_side_wired, _wire(job, True))
    _CPU_SIDE["pending"].append((fut, lambda cpu: finish(_wire(cpu, False))))
    finish_cpu_checks(wait=False)
    return model, scorer


def compare_card_cpu(label, serve, n_rows, saturates, lsh_heads, tower, block_scaled,
                     model_scaled, decision_bf16_bar, b, card_scoring, card_training,
                     card_aux, cpu) -> None:
    """``card_against_cpu``'s comparisons of the card's part with the CPU
    side's (``_cpu_side``)."""
    # with f32 matmuls the two devices compute one f32 function in
    # another summation order; on the bf16 path an f32 value a few ulps
    # apart can round to the neighbouring bf16 value (ROADMAP.md R3),
    # which moves a logit by up to one bf16 step of its terms
    for f32 in ("1", "0"):
        c, r = card_scoring[f32], cpu["scoring"][f32]
        scores, ref, path = c["scores"], r["ref"], c["path"]
        lsh_rows = np.zeros(n_rows, bool)
        if c["card_k"]:
            rows, worst_gap = topk_flips(c["card_k"], r["cpu_k"], c["rows_per_call"])
            lsh_rows[[i for i in rows if i < n_rows]] = True
            print(f"{path}: soft search's top-k choices, card against CPU: {len(rows)} rows "
                  f"chose otherwise, largest gap of the chosen scores {worst_gap:.3e} of "
                  f"the row's largest (bar {TOPK_GAP_BAR:.1e})")
            if worst_gap > TOPK_GAP_BAR:
                fail(f"{label}: a top-k choice differs between card and CPU by {worst_gap}")
        if c["lsh"]:
            n_flip, worst_margin, rows = bucket_flips(
                c["card_b"], r["cpu_b"], c["rows_per_call"], lsh_heads,
                set(np.nonzero(lsh_rows)[0].tolist()))
            lsh_rows[[i for i in rows if i < n_rows]] = True
            print(f"{path}: LSH bucket ids, card against CPU: {n_flip} of "
                  f"{sum(a.numel() for a, _ in c['card_b'])} keys on another bucket, in "
                  f"{int(lsh_rows.sum())} rows, largest margin of a flipped key "
                  f"{worst_margin:.3e} (bar {LSH_MARGIN_BAR[f32]:.1e})")
            if worst_margin > LSH_MARGIN_BAR[f32]:
                fail(f"{label}: an LSH bucket flips between card and CPU at margin "
                     f"{worst_margin}")
        if tower:
            x, y = (torch.cat(t)[:n_rows] for t in (c["taps"], r["taps"]))
            flipped = (x != y).reshape(n_rows, -1).any(dim=1).numpy()
        diff = float(np.abs(scores - ref).max())
        if saturates:
            lg, ref_lg = c["logits"], r["logits"]
        else:
            lg, ref_lg = (np.log(p.astype(np.float64)) - np.log1p(-p.astype(np.float64))
                          for p in (scores, ref))
        gaps = np.abs(lg - ref_lg) / np.abs(ref_lg).max()
        lg_gap = float(gaps.max())
        mode = "f32 matmuls" if f32 == "1" else "bf16 matmul inputs"
        print(f"{path} ({mode}): {len(scores)} rows on {c['device']}, vs the same weights on "
              f"the CPU: max |score diff| {diff:.3e}, max |logit diff|/max|logit| "
              f"{lg_gap:.3e} (99th percentile {np.quantile(gaps, 0.99):.3e}, rows "
              f"past 1e-4 {int((gaps > 1e-4).sum())}, past 2^-8 "
              f"{int((gaps > BF16_PATH_RTOL).sum())}); launches {c['launches']}"
              + (f"; logits of the models, max |diff| {np.abs(lg - ref_lg).max():.3e} "
                 f"(probabilities at exactly 0 or 1: {int(((scores == 0) | (scores == 1)).sum())})"
                 if saturates else "")
              + (f"; rows whose tower input rounds to another bf16 value on the "
                 f"card: {int(flipped.sum())}" if tower else ""))
        # a row past the bar must be one of the at most 1% whose tower input
        # (``tower``), an LSH bucket or a top-k choice differs between the devices
        witnessed = lsh_rows | (flipped if tower and f32 == "0" else False)
        if f32 == "0":
            past = gaps > BF16_PATH_RTOL
        elif saturates:
            past = np.abs(lg - ref_lg) > SATURATED_LOGIT_BAR
        else:
            past = np.abs(scores - ref) > 1e-4
        if (tower and f32 == "0") or c["lsh"] or c["card_k"]:
            if (past & ~witnessed).any() or past.sum() > max(1, n_rows // 100):
                fail(f"{label} scores differ from the CPU's past the bar in "
                     f"{int(past.sum())} rows (max |score diff| {diff}, logits {lg_gap} "
                     f"of their max), {int((past & ~witnessed).sum())} of them with the "
                     "same tower input and buckets")
        elif past.any():
            fail(f"{label} scores on the card differ from the CPU's ({mode}) in "
                 f"{int(past.sum())} rows: max |score diff| {diff}, logits {lg_gap} of "
                 "their max")

    # with f32 matmuls phase 5's bars hold every parameter; on the bf16
    # path the two devices' f32 sums can round a bf16 input cotangent of
    # the towers one bf16 step apart (ROADMAP.md R3), and the gradients
    # below it are held at that step (BF16_PATH_RTOL). A ReLU
    # pre-activation within rounding of 0 can fall on either side on the
    # two devices, which moves the gradients of its example's rows (PNN:
    # one of 524,288); the CPU's first step takes the card's decisions,
    # and the run fails if one it overrides is not within 1e-5 of 0
    for f32 in ("1", "0"):
        c, r = card_training[f32], cpu["training"][f32]
        path = c["path"]
        if r["k_gaps"]:
            n_rows_k, gap = r["k_gaps"][0]
            print(f"{path}: top-k choices the CPU's step 1 took from the card: {n_rows_k} "
                  f"rows, largest gap {gap:.3e} (bar {TOPK_GAP_BAR:.1e})")
            if gap > TOPK_GAP_BAR:
                fail(f"{label}: a top-k choice differs between card and CPU by {gap}")
        if r["lsh"]:
            worst_margin = max(m for _, m in r["b_flips"])
            print(f"{path}: LSH buckets the CPU's step 1 took from the card: "
                  f"{sum(n for n, _ in r['b_flips'])} of {c['n_keys']} keys, largest "
                  f"margin {worst_margin:.3e} (bar {LSH_MARGIN_BAR[f32]:.1e})")
            if worst_margin > LSH_MARGIN_BAR[f32]:
                fail(f"{label}: an LSH bucket flips between card and CPU at margin "
                     f"{worst_margin}")
        flips = r["flips"]
        n_flips = sum(n for n, _ in flips)
        worst_z = max((z for _, z in flips), default=0.0)
        mode = "f32 matmuls" if f32 == "1" else "bf16 matmul inputs"
        dev = "cuda" if torch.cuda.is_available() else "cpu"
        grads = {n: g.to(dev) for n, g in c["grads"].items()}
        ref_grads = {n: g.to(dev) for n, g in r["grads"].items()}
        compare_runs(f"{label} ({mode})", c["losses"], grads, r["losses"], ref_grads,
                     "the CPU run", block_scaled, model_scaled=model_scaled,
                     note=f"launches {c['launches']}; "
                     f"(P)ReLU pre-activations the CPU's step 1 took from the card: "
                     f"{n_flips} of {c['n_decisions']} "
                     f"(largest |z| {worst_z:.2e} of its layer's max)",
                     b=b, grad_rtol=RTOL if f32 == "1" else BF16_PATH_RTOL)
        z_bar = 1e-5 if f32 == "1" else decision_bf16_bar
        if worst_z > z_bar:
            fail(f"{label}: a (P)ReLU pre-activation at {worst_z} of its layer's max "
                 f"falls on another side on the card than on the CPU (bar {z_bar})")
    for k in sorted(set(card_aux) - {"emb_l2"}):
        got, ref = card_aux[k], cpu["aux"][k]
        print(f"{label} {k} on the card {got:.7f}, on the CPU {ref:.7f}, "
              f"rel diff {abs(got - ref) / abs(ref):.3e}")
        if not abs(got - ref) <= RTOL * abs(ref):
            fail(f"{label}'s {k} differs from the CPU's by more than {RTOL}")


def interaction_phases(drive, launches_by_path, plain_fa) -> None:
    """Every interaction model of the port (``INTERACTION_MODELS``) at the JAX
    board's width (bench.py:35-40: 26 fields of 100k ids, 13 dense, dim 8;
    default hyperparameters), built on the card by ``get_model``:
    ``card_against_cpu`` at B 4096 (no kernel launched but FiGNN's K3 under
    the flag, 1 field_attn_fwd a forward and 1 field_attn_bwd a step, whose
    scores and 5 Adam steps are also held against the same model on K3's
    plain versions; FFM, ONN and FAT-DeepFFM at ``CPU_CHECK_VOCAB`` ids), and the
    training rates and peak memory at B 16384. The models share one
    dataset, whose ``click`` (max(label, Bernoulli(0.3)), as bench.py:65-69
    draws it) the multi-task models' batches carry (ESMM's ``label`` is then
    a conversion seen only on a click); their second task's BCE is held card
    against CPU too."""
    from ml_function_tpu_torch.features.schema import criteo_feature_set
    from ml_function_tpu_torch.features.synthetic import make_criteo_like
    from ml_function_tpu_torch.models import get_model
    from ml_function_tpu_torch.train.loop import iter_batches

    def dataset(vocab):
        fs = criteo_feature_set([vocab] * 26, n_dense=13, embed_dim=8)
        n_rows = 2 * INTERACTION_TRAIN_BATCH
        _, data = make_criteo_like(n_rows=n_rows, vocab_size=vocab, seed=4)
        bern = np.random.default_rng(4).uniform(size=n_rows) < 0.3
        data["click"] = np.maximum(data["label"], bern.astype(np.float32))
        serve = {k: v for k, v in _rows(data, 3 * BATCH + 1000).items() if k != "click"}
        return fs, serve, list(iter_batches(data, BATCH))[:5], data

    fs, serve, batches, data = dataset(100_000)
    big = list(iter_batches(data, INTERACTION_TRAIN_BATCH))
    second_task = {"mmoe": "click_bce", "ple": "click_bce", "esmm": "ctr_bce"}
    for label, name, hp in INTERACTION_MODELS:
        t = time.perf_counter()
        k3 = INTERACTION_K3.get(name, 0)
        per_batch = {"field_attn_fwd": k3} if k3 else {}
        per_step = {"field_attn_fwd": k3, "field_attn_bwd": k3} if k3 else {}
        vocab = CPU_CHECK_VOCAB.get(name)
        check = dataset(vocab) if vocab else (fs, serve, batches, data)
        if vocab:
            print(f"{label}: card against CPU at {vocab} ids a field")
        model, scorer = card_against_cpu(
            label, name, check[0], hp, check[1], check[2][:CPU_CHECK_STEPS], drive,
            launches_by_path,
            per_batch, per_step, "field-attention kernel" if k3 else "no kernel",
            decision_bf16_bar=INTERACTION_DECISION_BAR.get(name, 1e-5))
        if k3:
            score_phase(f"{label}_serving_kernel", scorer, serve, drive, launches_by_path,
                        plain_fa, per_batch, event_reps=BOARD_RATES_DEPTH["event_reps"],
                        saturates=name in SATURATING)
            parity_steps(label, model, batches, plain_fa, drive, launches_by_path,
                         f"{label}_kernel_parity", per_step)
        del scorer
        if name in second_task:
            with torch.no_grad():
                aux = model(batches[0])[2]
            if second_task[name] not in aux:
                fail(f"{label}'s batches carry click but its aux has no "
                     f"{second_task[name]}")
        if vocab:
            del model, check
            model = get_model(name, fs, generator=torch.Generator().manual_seed(0), **hp)
        step_rates(label, model, big, "the JAX board's width and smallest batch",
                   **BOARD_RATES_DEPTH)
        del model
        print(f"{label}: {time.perf_counter() - t:.1f} s")


# The board's behavior-sequence tier (bench.py:737-741) on the bench's
# behavior batch: (label, registry name, hyperparameters, batch, K3 launches
# a forward under the flag, target-attention prefixes whose MLP gradients
# are held at the block's max|g|). DSIN at the board's B 2048 with sessions
# (8, 8), the others at DIN/DIEN's B 4096; default hyperparameters. BST's
# blocks see 65 positions (the candidate appended): 65² > 4096, so its
# attention takes the einsum route and launches nothing
SEQUENCE_MODELS = (
    ("bst", "bst", {}, BATCH, 0, ()),
    ("dsin", "dsin", {"session_shape": (8, 8)}, 2048, 1, ("attn_i.", "attn_l.")),
    ("seqfm", "seqfm", {}, BATCH, 1, ()),
    ("dstn", "dstn", {}, BATCH, 0, ("attn0.",)),
    ("dmin", "dmin", {}, BATCH, 1, ("attn0.", "attn1.")),
    ("mind", "mind", {}, BATCH, 0, ()),
    # the long-sequence tier: HPMN and MIMN at the board's rows
    # (bench.py:742-743), DTS at DIN's batch, BST's blocks on LSH attention,
    # and SIM's exact search unit on LSH attention at its soft-search board
    # shape (bench.py:754-760: B 512, a 16,384-id stream, the top 256)
    ("hpmn", "hpmn", {}, 2048, 0, ("attn.",)),
    ("mimn", "mimn", {}, 1024, 0, ("attn_mem.", "attn_ch.")),
    ("dts", "dts", {}, BATCH, 0, ("attn.",)),
    ("bst_lsh", "bst", {"attention": "lsh"}, BATCH, 0, ()),
    ("sim_lsh", "sim", {"search": "soft", "top_k": 256, "long_behavior": ("hist_long",),
                        "esu_attention": "lsh"}, 512, 0, ("attn.", "dien.attn.")))
# the models whose two sequence lookups also train 2 steps (5 until phases 24
# and 25 came, 3 until the 624.9 s run above) with the merge-scatter flag's
# attribute set, against the same steps without it
MERGE_SCATTER_MODELS = ("hpmn", "mimn")
MERGE_SCATTER_STEPS = 2
# the step loops whose training step's busy share the profiler reads; their
# steps take hundreds of ms, so their rates take one host-clock step and one
# sample of 1 step by events (4 and 3 × 2 until phases 24 and 25 came, 2
# and 2 × 1 until the 624.9 s run above)
PROFILED_MODELS = ("hpmn", "mimn", "dts")
STEP_LOOP_RATES_DEPTH = dict(host_steps=1, event_reps=(1, 1))
# MIMN's target attentions over its 4 memory slots and 4 channels read
# slots that its 64 erase/add writes and channel updates have made nearly
# equal, so at the board's batch their MLPs' step-1 gradients are rounding
# residues some nine orders below the model's largest (about 1e-9 against
# 5, of either sign on the two devices, with f32 matmuls too):
# ``card_against_cpu`` holds them at the model's max|g|, which any such
# residue passes, and prints their own. Against their own block's max|g|
# they are held only by the CPU tests against JAX
# (``tests/test_torch_longseq_tier.py``)
NOISE_BLOCKS = {"mimn": ("attn_mem.", "attn_ch.")}
# the Dense that takes each model's tower input (``card_against_cpu``)
SEQUENCE_TOWERS = {"seqfm": "head"}
SEQ_LEN = 64
# the interaction models' and the sequence tier's steps card against CPU
# (phases 18 and 19): 2, cut from 5 and then from 3 as phases joined the run,
# to keep it under 600 s (the CPU's steps took 71.9 and 89.6 s of the two
# phases at 5, and 129.8 s of both at 3; the third went for phase 23); every
# step-1 gradient and the losses of both steps stay held, the kernel parity
# steps stay at 5, and phases 20 and 21 take 5
CPU_CHECK_STEPS = 2


def seq_board_batch(n_rows: int, session_shape=None, seed: int = 1):
    """The JAX bench's behavior batch (bench.py:146-186: item and cate
    candidates of 5,000 items and 100 categories, histories of 64 random
    ids, every one valid, dim 8, labels Bernoulli 0.4) drawn with numpy.
    Returns (FeatureSet, data)."""
    from ml_function_tpu_torch.features.schema import FeatureSet, SeqSpec, SparseSpec

    iv, cv = 5001, 101
    fs = FeatureSet(
        sparse=(SparseSpec("item", iv, vocab_name="item", dim=8),
                SparseSpec("cate", cv, vocab_name="cate", dim=8)),
        seq=(SeqSpec("hist_item", iv, SEQ_LEN, vocab_name="item", dim=8,
                     session_shape=session_shape),
             SeqSpec("hist_cate", cv, SEQ_LEN, vocab_name="cate", dim=8,
                     session_shape=session_shape)))
    rng = np.random.default_rng(seed)
    data = {"dense": np.zeros((n_rows, 0), np.float32),
            "sparse": np.stack([rng.integers(1, iv, n_rows), rng.integers(1, cv, n_rows)],
                               axis=1).astype(np.int32),
            "seq": {"hist_item": rng.integers(1, iv, (n_rows, SEQ_LEN), dtype=np.int32),
                    "hist_cate": rng.integers(1, cv, (n_rows, SEQ_LEN), dtype=np.int32)},
            "label": (rng.random(n_rows) < 0.4).astype(np.float32)}
    return fs, data


def sequence_phases(drive, launches_by_path, plain_fa) -> None:
    """The sequence tier (``SEQUENCE_MODELS``) at the board's shapes, with
    ``ML_FUNCTION_TPU_FIELD_ATTN=1`` (set since phase 6): ``card_against_cpu``
    on each (its K3 launches held: 1 field_attn_fwd a forward and 1
    field_attn_bwd a step for DSIN, SeqFM and DMIN, none for the others),
    then for the three on K3 the scores and 5 Adam steps against the same
    model with K3's plain versions swapped in (DSIN also on a ragged
    ``make_behavior_data`` batch, whose fully padded sessions reach K3
    through ``safe_mask``), for HPMN and MIMN 2 Adam steps with the
    merge-scatter flag's attribute set against the same steps without it (2
    merge_scatter launches a step), and the training rates and peak memory
    at each model's batch (``BOARD_RATES_DEPTH``). SIM's batch is the bench's
    lifelong one (``profile_scoring.sim_batch``); the aux terms (HPMN's
    ``cov_reg``, MIMN's ``util_reg``, DTS's ``guide_loss``, SIM's
    ``aux_loss``) are held card against CPU."""
    from ml_function_tpu_torch.features.synthetic import make_behavior_data
    from ml_function_tpu_torch.models import get_model
    from ml_function_tpu_torch.ops.kernels import _build
    from ml_function_tpu_torch.serving import export_model, load_scorer
    from ml_function_tpu_torch.tools.profile_scoring import sim_batch
    from ml_function_tpu_torch.train.loop import iter_batches

    for label, name, hp, b, k3, attn in SEQUENCE_MODELS:
        t = time.perf_counter()
        fs, data = (sim_batch(5 * b) if name == "sim"
                    else seq_board_batch(5 * b, hp.get("session_shape")))
        serve = _rows(data, 3 * b + b // 4)
        batches = list(iter_batches(data, b))
        per_batch = {"field_attn_fwd": k3} if k3 else {}
        per_step = {"field_attn_fwd": k3, "field_attn_bwd": k3} if k3 else {}
        route = "field-attention kernel" if k3 else "no kernel"
        model, scorer = card_against_cpu(
            label, name, fs, hp, serve, batches[:CPU_CHECK_STEPS], drive, launches_by_path,
            per_batch, per_step, route, attn, SEQUENCE_TOWERS.get(name, "mlp.layer0.dense"),
            BF16_PATH_RTOL, NOISE_BLOCKS.get(name, ()))
        if k3:
            score_phase(f"{label}_serving_kernel", scorer, serve, drive, launches_by_path,
                        plain_fa, per_batch, event_reps=BOARD_RATES_DEPTH["event_reps"])
            parity_steps(label, model, batches, plain_fa, drive, launches_by_path,
                         f"{label}_kernel_parity", per_step, attn)
        if name in MERGE_SCATTER_MODELS:
            with merge_scatter_flag(True):
                parity_steps(label, model, batches[:MERGE_SCATTER_STEPS],
                             lambda: merge_scatter_flag(False), drive,
                             launches_by_path, f"{label}_merge_scatter_parity",
                             {"merge_scatter": 2}, attn)
        del scorer
        step_rates(label, model, batches, "the board's behavior batch",
                   **(STEP_LOOP_RATES_DEPTH if name in PROFILED_MODELS else BOARD_RATES_DEPTH),
                   profile=name in PROFILED_MODELS)
        del model
        print(f"{label}: {time.perf_counter() - t:.1f} s")

    # DSIN on ragged histories (lengths 32..64): sessions 5 to 8 of a short
    # history are fully padded, so safe_mask's rows reach K3
    t = time.perf_counter()
    hp = {"session_shape": (8, 8)}
    b = 2048
    fs, data = make_behavior_data(n_rows=5 * b, n_items=5000, n_cates=100,
                                  seq_len=SEQ_LEN, embed_dim=8, seed=3, **hp)
    padded = int((~(data["seq"]["hist_item"].reshape(-1, 8, 8) != 0).any(axis=2)).sum())
    print(f"dsin_ragged: {padded} of {5 * b * 8} sessions fully padded")
    if not padded:
        fail("the ragged DSIN batch has no fully padded session")
    model = get_model("dsin", fs, generator=torch.Generator().manual_seed(0), **hp)
    with tempfile.TemporaryDirectory(dir=_build.BUILD) as tmp:
        export_model(tmp, "dsin", fs, model, hyperparams=hp)
        scorer = load_scorer(tmp, batch_size=b)
    score_phase("dsin_ragged_serving", scorer, _rows(data, 3 * b + b // 4), drive,
                launches_by_path, plain_fa, {"field_attn_fwd": 1},
                event_reps=BOARD_RATES_DEPTH["event_reps"])
    del scorer
    parity_steps("dsin_ragged", model, list(iter_batches(data, b)), plain_fa, drive,
                 launches_by_path, "dsin_ragged_kernel_parity",
                 {"field_attn_fwd": 1, "field_attn_bwd": 1}, ("attn_i.", "attn_l."))
    print(f"dsin_ragged: {time.perf_counter() - t:.1f} s")


# The last three registry models (phase 20): (label, name, hyperparameters,
# target-attention prefixes whose MLP gradients are held at the block's
# max|g|, the Dense that takes the tower input). Default hyperparameters;
# DICM's images are 64 wide, as its constructor's default ``img_dim``
LAST_MODELS = (
    ("dssm", "dssm", {}, (), "u_mlp.layer0.dense"),
    ("deepmcp", "deepmcp", {}, (), "pred.layer0.dense"),
    ("dicm", "dicm", {}, ("id_attn.", "img_attn."), "mlp.layer0.dense"))
# the board's behavior shape (bench.py:146-186): 5,000 items, 100
# categories, histories of 64, dim 8; DICM's images 64 wide
BEHAVIOR_DATA = dict(n_items=5000, n_cates=100, seq_len=64, embed_dim=8, seed=0)
IMAGE_DIM = 64
# the meta step: DeepFM at the Criteo width, B 4096 pairs; 50,000 rows of
# 100k ids a field give about 9,000 pairs of one target id
META_ROWS = 50_000


@contextlib.contextmanager
def merge_scatter_flag(on: bool):
    """The merge-scatter flag's attribute (read at import) inside the block."""
    from ml_function_tpu_torch.ops import embedding

    saved = embedding._USE_MERGE_SCATTER
    embedding._USE_MERGE_SCATTER = on
    try:
        yield
    finally:
        embedding._USE_MERGE_SCATTER = saved


def dicm_merge_scatter(eg_mod, entry: dict, seq: dict, fs) -> None:
    """K1 at DICM's two history lookups a train step (N = B·64 ids of width
    8 into the fused table): against its plain version, timed as
    ``check_merge_scatter`` times a path's lookups; added to K1's entry."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    v = fs.total_vocab
    for name, ids in seq.items():
        ids = torch.as_tensor(ids.reshape(-1).astype(np.int64) + fs.seq_offset(name),
                              device="cuda")
        ct = torch.randn(ids.numel(), 8, device="cuda", generator=gen)
        s_ids, order = eg_mod._sort(ids)
        got = eg_mod.merge_scatter(s_ids, order, ct, v)
        whole = eg_mod.dense_grad_from_updates(ids, ct, v)
        err, atol = _check_close(f"merge_scatter (dicm {name})", got,
                                 eg_mod.merge_scatter_reference(s_ids, order, ct, v))
        if not torch.equal(got, whole):
            fail(f"merge_scatter (dicm {name}) differs between runs")
        bound_ms, bound_by = ms_bound(ids.numel(), 8, v)
        shape = {"case": f"dicm_{name}", "path": False, "lookup_of": "dicm",
                 "N": ids.numel(), "D": 8, "V": v, "max_abs_err": err, "atol": atol,
                 "bound_ms": bound_ms, "bound_by": bound_by,
                 **_ms_times(eg_mod, ids, ct, s_ids, order, v)}
        _print_ms_shape(shape)
        entry["per_shape"].append(shape)
    for k in MS_STEP_KEYS:
        entry[f"dicm_step_{k}"] = sum(s[k] for s in entry["per_shape"]
                                      if s["lookup_of"] == "dicm")
    entry["max_abs_err"] = max(s["max_abs_err"] for s in entry["per_shape"])
    _print_ms_step(entry, f"a DICM step ({len(seq)} lookups)", "dicm_step_")


def meta_step_phase(drive, launches_by_path) -> None:
    """One cold-start meta step over DeepFM at the Criteo width (26 fields
    of 100k ids, 13 dense, dim 8, hidden (256, 128, 64), B 4096 pairs of one
    target id from ``make_meta_batch_pairs``), card against the same
    weights on the CPU: the meta-loss within 1e-5 and the generator's
    gradient (through the inner SGD step, second-order term included)
    within 1e-3·max|g| with f32 matmuls, one bf16 step of max|g| on the bf16
    path; then one Adam meta step on each, the generator's parameters
    within 1e-5 (f32 matmuls); no kernel launched; the step's time by
    events."""
    from ml_function_tpu_torch.features.schema import criteo_feature_set
    from ml_function_tpu_torch.features.synthetic import make_criteo_like
    from ml_function_tpu_torch.models import get_model
    from ml_function_tpu_torch.models.coldstart import (MetaEmbedding,
                                                        make_meta_batch_pairs,
                                                        make_meta_train_step)
    from ml_function_tpu_torch.tools.timing import event_ms
    from ml_function_tpu_torch.train.optimizers import make_optimizer

    t = time.perf_counter()
    fs = criteo_feature_set([100_000] * 26, n_dense=13, embed_dim=8)
    _, data = make_criteo_like(n_rows=META_ROWS, vocab_size=100_000, seed=6)
    ba, bb = next(make_meta_batch_pairs(data, fs, "C1", BATCH, seed=0))
    models = {dev: get_model("deepfm", fs, device=dev,
                             generator=torch.Generator().manual_seed(0))
              for dev in ("cuda", "cpu")}
    metas = {dev: MetaEmbedding(fs, "C1", device=dev) for dev in ("cuda", "cpu")}
    gen0 = {k: v.detach().clone() for k, v in metas["cpu"].state_dict().items()}
    for f32 in ("1", "0"):
        os.environ["ML_FUNCTION_TPU_F32_MATMUL"] = f32
        path = "meta_step" + ("_f32" if f32 == "1" else "")
        out = {}
        for dev in ("cuda", "cpu"):
            meta = metas[dev]
            run = lambda: meta.meta_loss(models[dev], ba, bb)   # noqa: E731
            loss = drive(path, run) if dev == "cuda" else run()
            grads = torch.autograd.grad(loss, list(meta.parameters()))
            out[dev] = (loss.item(), {n: g.cpu() for (n, _), g in
                                      zip(meta.named_parameters(), grads)})
        if launches_by_path[path] != expect():
            fail(f"the meta step launched {launches_by_path[path]}")
        (loss, grads), (ref_loss, ref_grads) = out["cuda"], out["cpu"]
        rel = abs(loss - ref_loss) / abs(ref_loss)
        bar = RTOL if f32 == "1" else BF16_PATH_RTOL
        worst = max(((grads[n] - r).abs() / max(r.abs().max().item(), 1e-30)).max().item()
                    for n, r in ref_grads.items())
        stepped = [n for n, r in ref_grads.items()
                   if (_one_bf16_step(grads[n], r) is not None)]
        mode = "f32 matmuls" if f32 == "1" else "bf16 matmul inputs"
        print(f"meta step ({mode}): meta-loss on the card {loss:.7f}, on the CPU "
              f"{ref_loss:.7f} (rel diff {rel:.3e}); generator gradients of "
              f"{len(grads)} parameters, max |err|/max|g| {worst:.3e} (bar {bar:.3e}); "
              f"launches {launches_by_path[path]}")
        if rel > 1e-5 or worst > bar and f32 == "1":
            fail(f"the meta step differs from the CPU's ({mode}): loss {rel}, "
                 f"gradients {worst}")
        if f32 == "0":
            for n, r in ref_grads.items():
                near = _one_bf16_step(grads[n], r)
                ok = (grads[n] - r).abs() <= bar * r.abs().max() + RTOL * r.abs()
                if near is not None:
                    ok |= near
                if not bool(ok.all()):
                    fail(f"the meta step's {n} gradient on the bf16 path differs from the "
                         f"CPU's by {(grads[n] - r).abs().max().item()}")
    os.environ["ML_FUNCTION_TPU_F32_MATMUL"] = "1"
    for dev in ("cuda", "cpu"):
        metas[dev].load_state_dict({k: v.to(dev) for k, v in gen0.items()})
        make_meta_train_step(metas[dev], models[dev], make_optimizer("adam", 1e-2))(ba, bb)
    gap = max((a.detach().cpu() - b.detach()).abs().max().item()
              for a, b in zip(metas["cuda"].parameters(), metas["cpu"].parameters()))
    step = make_meta_train_step(metas["cuda"], models["cuda"], make_optimizer("adam", 1e-2))
    step_ms = event_ms(lambda: step(ba, bb), reps=5, inner=2)
    os.environ.pop("ML_FUNCTION_TPU_F32_MATMUL")
    print(f"meta step: the generator after one Adam meta step, card against CPU, max "
          f"|diff| {gap:.3e} (bar 1e-5); a meta step at B={BATCH} {step_ms:.4f} ms by "
          f"events (f32 matmuls); {time.perf_counter() - t:.1f} s")
    if gap > 1e-5:
        fail(f"the meta step's generator differs from the CPU's by {gap}")


def last_models_phase(drive, launches_by_path, kernels: list) -> None:
    """Phase 20: DSSM and DeepMCP on the board's behavior batch
    (``make_behavior_data`` at ``BEHAVIOR_DATA``, B 4096) and DICM on
    ``make_image_ctr_data`` at the same shape with 64-wide images, each as a
    model of phase 18 (``card_against_cpu``: scores through ``load_scorer``
    and 5 Adam steps card against CPU on both matmul paths, the aux terms,
    the rates); DICM's training also with the merge-scatter flag's
    attribute set, 2 merge_scatter launches a step, against the same steps
    with ``fused_gather``'s plain version, and K1 timed at its lookups; then
    one meta step over DeepFM (``meta_step_phase``)."""
    from ml_function_tpu_torch.features.synthetic import (make_behavior_data,
                                                          make_image_ctr_data)
    from ml_function_tpu_torch.ops import embedding
    from ml_function_tpu_torch.ops.kernels import embedding_grad as eg_mod
    from ml_function_tpu_torch.train.loop import iter_batches

    for label, name, hp, attn, tower in LAST_MODELS:
        t = time.perf_counter()
        if name == "dicm":
            fs, data = make_image_ctr_data(n_rows=5 * BATCH, img_dim=IMAGE_DIM,
                                           **BEHAVIOR_DATA)
        else:
            fs, data = make_behavior_data(n_rows=5 * BATCH, **BEHAVIOR_DATA)
        serve = _rows(data, 3 * BATCH + BATCH // 4)
        batches = list(iter_batches(data, BATCH))
        model, scorer = card_against_cpu(
            label, name, fs, hp, serve, batches, drive, launches_by_path, {}, {},
            "no kernel", attn, tower, BF16_PATH_RTOL)
        del scorer
        if name == "dicm":
            entry = next(k for k in kernels if k["name"] == "merge_scatter")
            dicm_merge_scatter(eg_mod, entry, _rows(data, BATCH)["seq"], fs)
            with merge_scatter_flag(True):
                parity_steps(label, model, batches,
                             lambda: swapped(embedding, "fused_gather",
                                             plain_fused_gather(eg_mod)),
                             drive, launches_by_path, f"{label}_merge_scatter_parity",
                             {"merge_scatter": 2}, attn)
                step_rates(label, model, batches, "merge-scatter flag on",
                           **BOARD_RATES_DEPTH, profile=True)
        step_rates(label, model, batches, "the board's behavior batch", **BOARD_RATES_DEPTH,
                   profile=True)
        del model
        print(f"{label}: {time.perf_counter() - t:.1f} s")
    meta_step_phase(drive, launches_by_path)


# The store (phase 21). Mixed widths, the slice's own shape (the board has
# no mixed-width row): a Criteo-shaped DeepFM, C1-C13 at dim 8 over 100k
# ids, C14-C26 at dim 4 over 1M ids, 13 dense
MIXED_SPLIT = ((13, 100_000, 8), (13, 1_000_000, 4))
# the sparse-row path at bench_sparse_path's scales (bench.py:251-300,
# :788-794): DeepFM, 26 fields of 100k and of 1M ids, dim 8, hidden
# (256, 128, 64), B 32768, Adagrad at 0.05
SPARSE_SCALES = (100_000, 1_000_000)
SPARSE_BATCH = 32768
SPARSE_LR = 0.05
SPARSE_STEPS = 3
# int8 scoring at the board's shape (bench.py:776-786): DeepFM at 26 x 100k,
# B 8192, trained INT8_STEPS Adam steps first so that its scores rank
INT8_BATCH = 8192
INT8_STEPS = 8


def mixed_width_data(n_rows: int, seed: int):
    """(FeatureSet, data) of the mixed-width DeepFM: ``make_criteo_like`` at
    100k ids, its last 13 columns redrawn over 1M ids."""
    from ml_function_tpu_torch.features.schema import DenseSpec, FeatureSet, SparseSpec
    from ml_function_tpu_torch.features.synthetic import make_criteo_like

    _, data = make_criteo_like(n_rows=n_rows, vocab_size=MIXED_SPLIT[0][1], seed=seed)
    (n0, v0, d0), (n1, v1, d1) = MIXED_SPLIT
    rng = np.random.default_rng(seed)
    data["sparse"][:, n0:] = rng.integers(1, v1, (n_rows, n1), dtype=np.int32)
    fs = FeatureSet(
        dense=tuple(DenseSpec(f"I{i + 1}") for i in range(13)),
        sparse=tuple(SparseSpec(f"C{i + 1}", v0 if i < n0 else v1,
                                dim=d0 if i < n0 else d1) for i in range(n0 + n1)))
    return fs, data


def sparse_path_phase(drive, launches_by_path) -> None:
    """The sparse-row step against the dense Adagrad step on the card at
    ``SPARSE_SCALES``: at 100k ids, ``SPARSE_STEPS`` steps from the same
    weights with f32 matmuls, every parameter within 1e-5 (+ 1e-5·|p|), no
    (V, ·) tensor in the dense optimizer's state, no kernel launched even
    with the merge-scatter flag's attribute set; at each scale both steps
    and the record pass alone timed by events, with peak memory."""
    from ml_function_tpu_torch.features.schema import criteo_feature_set
    from ml_function_tpu_torch.models import get_model
    from ml_function_tpu_torch.models.base import as_tensors
    from ml_function_tpu_torch.ops.embedding import RowTape, row_tape
    from ml_function_tpu_torch.tools.timing import event_ms, profile_device
    from ml_function_tpu_torch.train.loop import make_train_step
    from ml_function_tpu_torch.train.optimizers import make_optimizer
    from ml_function_tpu_torch.train.sparse import (RowAdagrad, create_sparse_train_state,
                                                    make_sparse_train_step)

    for vocab in SPARSE_SCALES:
        t = time.perf_counter()
        fs = criteo_feature_set([vocab] * 26, n_dense=13, embed_dim=8)
        rng = np.random.default_rng(7)
        batches = [as_tensors({
            "dense": rng.uniform(0, 1, (SPARSE_BATCH, 13)).astype(np.float32),
            "sparse": rng.integers(1, vocab, (SPARSE_BATCH, 26), dtype=np.int32),
            "label": (rng.uniform(size=SPARSE_BATCH) < 0.3).astype(np.float32),
            "weight": np.ones(SPARSE_BATCH, np.float32)}, torch.device("cuda"))
            for _ in range(SPARSE_STEPS)]
        dense_m = get_model("deepfm", fs, generator=torch.Generator().manual_seed(0))
        sparse_m = get_model("deepfm", fs, generator=torch.Generator().manual_seed(0))
        dense_step = make_train_step(dense_m, make_optimizer("adagrad", SPARSE_LR).init(dense_m))
        ts = create_sparse_train_state(sparse_m, make_optimizer("adagrad", SPARSE_LR),
                                       RowAdagrad(SPARSE_LR))
        sparse_step = make_sparse_train_step(ts)
        v_rows = fs.total_vocab
        label = f"sparse_path_{vocab // 1000}k"
        if vocab == SPARSE_SCALES[0]:
            os.environ["ML_FUNCTION_TPU_F32_MATMUL"] = "1"
            with merge_scatter_flag(True):
                d_loss = drive(f"dense_step_{vocab // 1000}k",
                               lambda: [dense_step(b)["loss"].item() for b in batches])
                s_loss = drive(label, lambda: [sparse_step(b)["loss"].item() for b in batches])
            os.environ.pop("ML_FUNCTION_TPU_F32_MATMUL")
            if launches_by_path[label] != expect():
                fail(f"the sparse-row step launched {launches_by_path[label]}")
            held = [x for st in ts.dense.state.values() for x in st.values()
                    if torch.is_tensor(x)]
            if any(x.dim() == 2 and x.shape[0] == v_rows for x in held):
                fail("the sparse-row step's dense optimizer holds a (V, ·) tensor")
            worst, where = 0.0, ""
            dense_p = dict(dense_m.named_parameters())
            for n, p in sparse_m.named_parameters():
                err = ((p - dense_p[n]).abs() - 1e-5 * dense_p[n].abs()).max().item()
                if err > worst:
                    worst, where = err, n
            print(f"{label}: {SPARSE_STEPS} RowAdagrad steps at B={SPARSE_BATCH} against "
                  f"the dense Adagrad steps (f32 matmuls, merge-scatter flag set): losses "
                  f"{s_loss} against {d_loss}; largest |diff| − 1e-5·|p| {worst:.3e} "
                  f"({where or 'none'}; bar 1e-5); dense optimizer state: {len(held)} "
                  f"tensors, none (V, ·); launches {launches_by_path[label]}")
            if worst > 1e-5:
                fail(f"the sparse-row step's parameters differ from the dense step's "
                     f"by {worst} at {where}")
        else:
            sparse_step(batches[0])
            dense_step(batches[0])
        times = {}
        for what, fn in (("dense", lambda: dense_step(batches[0])),
                         ("sparse", lambda: sparse_step(batches[0]))):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times[what] = event_ms(fn, reps=5, inner=2)
            times[what + "_peak"] = torch.cuda.max_memory_allocated() / 2**20

        def record():
            with torch.no_grad(), row_tape(RowTape("record")):
                sparse_m(batches[0], train=True)

        times["record"] = event_ms(record, reps=5, inner=2)
        for what, fn in (("dense", lambda: dense_step(batches[0])),
                         ("sparse", lambda: sparse_step(batches[0]))):
            _, busy, window = profile_device(fn, 1)
            print(f"{label}: a {what} step busy {busy:.3f} ms of a {window:.3f} ms window "
                  f"({100 * busy / window:.1f}% busy, profiler)")
        print(f"{label} (26 x {vocab} ids, {v_rows * 9 * 4 / 2**20:.1f} MiB of tables): "
              f"a dense Adagrad step {times['dense']:.4f} ms (peak {times['dense_peak']:.1f} "
              f"MiB), a sparse-row step {times['sparse']:.4f} ms (peak "
              f"{times['sparse_peak']:.1f} MiB), of it the record pass "
              f"{times['record']:.4f} ms ({100 * times['record'] / times['sparse']:.1f}%); "
              f"dense/sparse {times['dense'] / times['sparse']:.3f} (CUDA events, median of 5 "
              f"samples of 2 steps); {time.perf_counter() - t:.1f} s")
        del dense_m, sparse_m, ts, dense_step, sparse_step, batches


def int8_phase(drive, launches_by_path) -> None:
    """DeepFM at 26 x 100k ids, trained ``INT8_STEPS`` Adam steps at B 8192,
    exported and scored at B 8192 by ``load_scorer`` f32 and
    ``quantize='int8'`` over 4 batches of ``make_criteo_like`` rows: the
    largest gap of the probabilities (bar 0.02), the AUC of both on the
    labels (within 2e-3), the tables' bytes, and both scorers' rates."""
    from ml_function_tpu_torch.features.schema import criteo_feature_set
    from ml_function_tpu_torch.features.synthetic import make_criteo_like
    from ml_function_tpu_torch.models import get_model
    from ml_function_tpu_torch.ops.kernels import _build
    from ml_function_tpu_torch.serving import export_model, load_scorer
    from ml_function_tpu_torch.train.loop import iter_batches, make_train_step
    from ml_function_tpu_torch.train.metrics import gauc
    from ml_function_tpu_torch.train.optimizers import make_optimizer

    t = time.perf_counter()
    fs = criteo_feature_set([100_000] * 26, n_dense=13, embed_dim=8)
    _, data = make_criteo_like(n_rows=(INT8_STEPS + 4) * INT8_BATCH, vocab_size=100_000,
                               seed=5)
    batches = list(iter_batches(data, INT8_BATCH))
    model = get_model("deepfm", fs, generator=torch.Generator().manual_seed(0))
    step = make_train_step(model, make_optimizer("adam", 1e-2).init(model))
    for b in batches[:INT8_STEPS]:
        step(b)
    serve = _rows({k: v[INT8_STEPS * INT8_BATCH:] for k, v in data.items()}, 4 * INT8_BATCH)
    with tempfile.TemporaryDirectory(dir=_build.BUILD) as tmp:
        export_model(tmp, "deepfm", fs, model, hyperparams={})
        del model, step
        f32 = load_scorer(tmp, batch_size=INT8_BATCH)
        q = load_scorer(tmp, batch_size=INT8_BATCH, quantize="int8")
    p_f = drive("deepfm_serving_f32_tables", lambda: f32.predict_proba(serve))
    p_q = drive("deepfm_serving_int8_tables", lambda: q.predict_proba(serve))
    for path in ("deepfm_serving_f32_tables", "deepfm_serving_int8_tables"):
        if launches_by_path[path] != expect():
            fail(f"{path} launched {launches_by_path[path]}")
    emb = q.model.embedding
    f32_bytes = sum(p.numel() * 4 for n, p in f32.model.embedding.named_parameters())
    q_bytes = emb.qpl.numel() * emb.qpl.element_size()
    gap = float(np.abs(p_f - p_q).max())
    one_group = np.zeros(len(p_f))
    aucs = [gauc(serve["label"], p, one_group)[0] for p in (p_f, p_q)]
    print(f"int8 tables: {q_bytes / 2**20:.1f} MiB packed (V, D+3) int8 against "
          f"{f32_bytes / 2**20:.1f} MiB f32 ({f32_bytes / q_bytes:.2f}x); over "
          f"{len(p_f)} rows the largest |p_int8 − p_f32| {gap:.3e} (bar 0.02), AUC f32 "
          f"{aucs[0]:.5f}, int8 {aucs[1]:.5f} (|diff| {abs(aucs[0] - aucs[1]):.2e}, bar "
          f"2e-3)")
    if not np.isfinite(p_q).all() or gap > 0.02 or abs(aucs[0] - aucs[1]) > 2e-3:
        fail(f"int8 scores differ from f32: gap {gap}, AUCs {aucs}")
    for label, scorer in (("deepfm_serving_f32_tables", f32),
                          ("deepfm_serving_int8_tables", q)):
        score_rates(label, scorer, serve, "no kernel", BOARD_RATES_DEPTH["event_reps"])
    print(f"int8 scoring: {time.perf_counter() - t:.1f} s")


def store_phase(drive, launches_by_path) -> None:
    """Phase 21: the mixed-width DeepFM (``MIXED_SPLIT``) card against CPU
    as a model of phase 18, the sparse-row path (``sparse_path_phase``) and
    int8 scoring (``int8_phase``)."""
    from ml_function_tpu_torch.train.loop import iter_batches

    t = time.perf_counter()
    fs, data = mixed_width_data(5 * BATCH, seed=8)
    batches = list(iter_batches(data, BATCH))
    model, scorer = card_against_cpu("deepfm_mixed", "deepfm", fs, {},
                                     _rows(data, 3 * BATCH + 1000), batches, drive,
                                     launches_by_path, {}, {})
    del scorer
    step_rates("deepfm_mixed", model, batches, "the slice's mixed widths",
               **BOARD_RATES_DEPTH, profile=True)
    del model
    print(f"deepfm_mixed: {time.perf_counter() - t:.1f} s")
    del data
    sparse_path_phase(drive, launches_by_path)
    int8_phase(drive, launches_by_path)


# Training from files (phase 22): the Criteo width of phase 4 from a TSV the
# script writes from a seed, and DIEN's headline shape from a behavior CSV
FILE_BATCHES = 36                 # Criteo rows: 36 × 4096, the last 16,384 held out
FILE_HELDOUT = 16384
FILE_VALUES = 100_000             # distinct values drawn a categorical field
FILE_BUCKETS = 100_000            # hash buckets a field
FILE_SAVES = (8, 16, 24)          # steps after which a checkpoint is written
FILE_REPLAY = range(17, 25)       # the steps replayed from step 16's checkpoint
FILE_REF_ROWS = 2048              # rows held against the Python reference parse
BEHAVIOR_FILE_BATCHES = 8
BEHAVIOR_FILE_STEPS = 4
# The replayed losses against the uninterrupted run's. The step after a
# restore sees the same bits (its forward is deterministic); from then on
# the embedding table's gradient is index_select's backward, whose atomic
# adds sum each row's terms in an order that varies from run to run, so
# the tables differ by f32 roundings, and Adam's first moments amplify a
# rounding near 0 into an update of up to lr. Over 8 steps that moves the
# mean loss by orders of magnitude less than 1e-4 of itself.
FILE_REPLAY_RTOL = 1e-4


def _auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """ROC AUC by ranks (Mann-Whitney), ties broken by order."""
    order = np.argsort(scores, kind="stable")
    ranks = np.empty(len(scores), np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    pos = labels > 0.5
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def write_criteo_tsv(path: str, n_rows: int, seed: int) -> None:
    """A headerless Criteo TSV from a numpy seed: label, 13 integer counts
    (a tenth empty) and 26 categorical hex strings over FILE_VALUES values a
    field (a twentieth empty). The label is drawn from the log counts of
    I1 and I2 (a planted signal for the held-out AUC)."""
    rng = np.random.default_rng(seed)
    counts = np.array([str(v) for v in range(10_000)] + [""], dtype=object)
    values = np.array([f"{v:08x}" for v in rng.permutation(1 << 24)[:FILE_VALUES]]
                      + [""], dtype=object)
    dense = rng.integers(0, 10_000, (n_rows, 13))
    dense[rng.random((n_rows, 13)) < 0.1] = 10_000
    cats = rng.integers(0, FILE_VALUES, (n_rows, 26))
    cats[rng.random((n_rows, 26)) < 0.05] = FILE_VALUES
    # each field hashes with its own salt, so one value list serves all 26
    z = np.log1p(np.where(dense[:, :2] == 10_000, 0, dense[:, :2]))
    z = (z - z.mean(0)) / z.std(0)
    logit = 1.5 * z[:, 0] - 1.0 * z[:, 1] - 1.1
    label = np.where(rng.random(n_rows) < 1 / (1 + np.exp(-logit)), "1", "0").astype(object)
    cols = np.concatenate([label[:, None], counts[dense], values[cats]], axis=1)
    with open(path, "w") as f:
        f.write("\n".join("\t".join(r) for r in cols.tolist()))
        f.write("\n")


def write_behavior_csv(path: str, data: dict) -> None:
    """``label,item,cate,hist_item,hist_cate`` with '|'-joined histories
    (the padding zeros left out), as ``tests/fixtures/behavior_tiny.csv``."""
    def lists(a):
        return ["|".join(map(str, row[row != 0])) for row in a]

    sp, seq = data["sparse"], data["seq"]
    rows = zip(data["label"].astype(int).tolist(), sp[:, 0].tolist(), sp[:, 1].tolist(),
               lists(seq["hist_item"]), lists(seq["hist_cate"]))
    with open(path, "w") as f:
        f.write("label,item,cate,hist_item,hist_cate\n")
        f.write("\n".join(f"{a},{b},{c},{d},{e}" for a, b, c, d, e in rows))
        f.write("\n")


def _same_state(a: dict, b: dict) -> list:
    """Keys whose arrays differ in dtype, shape or any bit."""
    if sorted(a) != sorted(b):
        return sorted(set(a) ^ set(b))
    return [k for k in a if a[k].dtype != b[k].dtype or a[k].tobytes() != b[k].tobytes()]


def criteo_file_phase(drive, launches_by_path, tmp: str) -> None:
    """Phase 22 (b): xDeepFM at the Criteo width trained from a TSV through
    ``CriteoFileIterator``, checkpoints with a torn newest one, the
    fallback's restore and replay, and the exported model's held-out
    scores."""
    from ml_function_tpu_torch.features import native_loader as nl
    from ml_function_tpu_torch.features.schema import criteo_feature_set
    from ml_function_tpu_torch.models import get_model
    from ml_function_tpu_torch.ops.kernels import cin as cin_mod
    from ml_function_tpu_torch.serving import Scorer, export_model, load_scorer
    from ml_function_tpu_torch.train import checkpoint as ckpt
    from ml_function_tpu_torch.train.loop import TrainState, make_train_step
    from ml_function_tpu_torch.train.optimizers import make_optimizer

    t = time.perf_counter()
    whole = os.path.join(tmp, "criteo.tsv")
    write_criteo_tsv(whole, FILE_BATCHES * BATCH, seed=0)
    with open(whole, "rb") as f:
        text = f.read()
    cut = 0
    for _ in range((FILE_BATCHES * BATCH) - FILE_HELDOUT):
        cut = text.index(b"\n", cut) + 1
    train_path, held_path = os.path.join(tmp, "train.tsv"), os.path.join(tmp, "heldout.tsv")
    with open(train_path, "wb") as f:
        f.write(text[:cut])
    with open(held_path, "wb") as f:
        f.write(text[cut:])
    print(f"criteo file: {FILE_BATCHES * BATCH} rows, {len(text) / 2**20:.1f} MiB written "
          f"in {time.perf_counter() - t:.1f} s ({FILE_HELDOUT} held out)")

    # the parse: the held-out file whole, then the training file's rate
    t = time.perf_counter()
    held = nl.load_criteo(held_path, hash_buckets=FILE_BUCKETS)
    held_s = time.perf_counter() - t
    t = time.perf_counter()
    nl.load_criteo(train_path, hash_buckets=FILE_BUCKETS)
    train_s = time.perf_counter() - t
    held_mb, train_mb = os.path.getsize(held_path) / 2**20, os.path.getsize(train_path) / 2**20
    print(f"native parse (load_criteo, {nl._threads(None)} threads): held-out "
          f"{FILE_HELDOUT} rows in {held_s * 1e3:.2f} ms ({FILE_HELDOUT / held_s:.1f} "
          f"rows/s, {held_mb / held_s:.1f} MiB/s); training file "
          f"{len(text[:cut].splitlines())} rows in {train_s * 1e3:.2f} ms "
          f"({(FILE_BATCHES * BATCH - FILE_HELDOUT) / train_s:.1f} rows/s, "
          f"{train_mb / train_s:.1f} MiB/s)")
    if held["sparse"].shape != (FILE_HELDOUT, 26) or held["dense"].shape != (FILE_HELDOUT, 13):
        fail(f"held-out parse has shapes {held['sparse'].shape}, {held['dense'].shape}")
    # the first rows against the Python reference: ids and labels bit for
    # bit, the raw counts bit for bit, their log1p within one f32 ulp (the
    # C++ takes log1pf, the reference numpy's f64 log1p; ROADMAP.md R12)
    head = b"".join(text[cut:].splitlines(keepends=True)[:FILE_REF_ROWS]).decode()
    ref = nl.py_reference_parse(head, hash_buckets=FILE_BUCKETS)
    raw_ref = nl.py_reference_parse(head, hash_buckets=FILE_BUCKETS, log1p=False)
    raw = nl.parse_buffer(head.encode(), hash_buckets=FILE_BUCKETS, log1p=False)
    n = FILE_REF_ROWS
    exact = (held["sparse"][:n].tobytes() == ref["sparse"].tobytes()
             and held["label"][:n].tobytes() == ref["label"].tobytes()
             and raw["dense"].tobytes() == raw_ref["dense"].tobytes())
    ulps = int(np.abs(held["dense"][:n].view(np.int32).astype(np.int64)
                      - ref["dense"].view(np.int32).astype(np.int64)).max())
    print(f"native parse against py_reference_parse, first {n} rows: ids, labels and "
          f"raw counts bit for bit {exact}; log1p counts within {ulps} f32 ulp")
    if not exact or ulps > 1:
        fail("the native Criteo parse differs from py_reference_parse")

    # xDeepFM trained from the file, checkpoints after steps 8, 16 and 24
    fs = criteo_feature_set([FILE_BUCKETS] * 26, n_dense=13, embed_dim=8)
    hp = {"cin_hidden": [128, 128], "hidden": [256, 128]}
    thp = {k: tuple(v) for k, v in hp.items()}

    def fresh(seed):
        model = get_model("xdeepfm", fs, device="cuda",
                          generator=torch.Generator().manual_seed(seed), **thp)
        return model, make_optimizer("adam", 1e-3).init(model)

    model, opt = fresh(0)
    step = make_train_step(model, opt)
    ck_dir = os.path.join(tmp, "ckpt")
    losses, kept, saves, host16, per_step = {}, {}, [], None, []
    walls, events = [], []

    def cin_counts():
        return cin_mod.cin_fwd_launches, cin_mod.cin_bwd_launches

    def run():
        nonlocal host16
        it = nl.CriteoFileIterator(train_path, BATCH, hash_buckets=FILE_BUCKETS,
                                   chunk_bytes=16 << 20)
        n_steps = 0
        t_prev = time.perf_counter()
        for batch in it:
            n_steps += 1
            before = cin_counts()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = step(batch)
            e1.record()
            per_step.append(tuple(a - b for a, b in zip(cin_counts(), before)))
            losses[n_steps] = out["loss"]
            events.append((e0, e1))
            if n_steps in FILE_REPLAY:
                kept[n_steps] = batch
            if n_steps in FILE_SAVES:
                torch.cuda.synchronize()
                t = time.perf_counter()
                ts = TrainState(model, opt, n_steps)
                ckpt.save_checkpoint(ck_dir, ts, keep=3)
                saves.append(time.perf_counter() - t)
                if n_steps == 16:
                    host16 = ckpt.state_arrays(ts)
                t_prev = time.perf_counter()
                continue
            now = time.perf_counter()
            walls.append(now - t_prev)
            t_prev = now
        torch.cuda.synchronize()
        return n_steps

    n_steps = drive("criteo_file_training", run)
    want_steps = FILE_BATCHES - FILE_HELDOUT // BATCH
    got = launches_by_path["criteo_file_training"]
    if n_steps != want_steps or got != expect(cin_fwd=2 * n_steps, cin_bwd=2 * n_steps) \
            or any(c != (2, 2) for c in per_step):
        fail(f"xDeepFM from the file: {n_steps} steps (want {want_steps}), launches {got}, "
             f"per step {sorted(set(per_step))}")
    dev_ms = [a.elapsed_time(b) for a, b in events[1:]]
    wall = statistics.median(walls[1:])
    print(f"xdeepfm from the file: {n_steps} steps at B={BATCH}, 2 cin_fwd + 2 cin_bwd a "
          f"step; {wall * 1e3:.3f} ms a step by the host clock (median, parse and the "
          f"iterator's thread included: {BATCH / wall:.1f} examples/s), "
          f"{statistics.median(dev_ms):.4f} ms by CUDA events (median over steps 2-"
          f"{n_steps}); loss step 1 {float(losses[1]):.5f}, step {n_steps} "
          f"{float(losses[n_steps]):.5f}")
    size = os.path.getsize(os.path.join(ck_dir, "ckpt_0000000016", "arrays.npz"))
    print(f"checkpoint: {size} bytes ({size / 2**20:.1f} MiB, {len(host16)} arrays); save "
          f"{', '.join(f'{s:.3f}' for s in saves)} s")

    # the newest checkpoint torn: the restore falls back to step 16
    arrays = os.path.join(ck_dir, "ckpt_0000000024", "arrays.npz")
    with open(arrays, "r+b") as f:
        f.truncate(os.path.getsize(arrays) // 2)
    model2, opt2 = fresh(1)
    torch.cuda.synchronize()
    t = time.perf_counter()
    ts2, _, path = ckpt.restore_latest(ck_dir, TrainState(model2, opt2, 0))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    names = sorted(os.listdir(ck_dir))
    diff = _same_state(ckpt.state_arrays(ts2), host16) if ts2 is not None else ["none"]
    print(f"torn newest checkpoint: restored {os.path.basename(path)} (step "
          f"{ts2.step if ts2 else None}) in {restore_s:.3f} s; directory {names}; "
          f"state the same bits as step 16's: {not diff}")
    if (ts2 is None or ts2.step != 16 or not path.endswith("ckpt_0000000016")
            or "ckpt_0000000024.corrupt" not in names or diff
            or not all(p.is_cuda for p in model2.parameters())):
        fail(f"the fallback past the torn checkpoint failed: {path}, {names}, {diff[:3]}")

    # replay steps 17..24 from the restored state
    step2 = make_train_step(model2, opt2)
    replay = drive("criteo_file_replay", lambda: {i: step2(kept[i])["loss"]
                                                  for i in FILE_REPLAY})
    rel = max(abs(float(replay[i]) - float(losses[i])) / abs(float(losses[i]))
              for i in FILE_REPLAY)
    same_first = float(replay[17]) == float(losses[17])
    print(f"replay of steps 17-24 from step 16's checkpoint: largest relative loss gap "
          f"{rel:.3e} (bar {FILE_REPLAY_RTOL}); step 17's loss the same bits: {same_first}")
    if rel > FILE_REPLAY_RTOL or not same_first \
            or launches_by_path["criteo_file_replay"] != expect(cin_fwd=16, cin_bwd=16):
        fail(f"the replayed losses leave the uninterrupted run's by {rel}")

    # the resumed model exported and scored on the held-out file
    exp = os.path.join(tmp, "export")
    export_model(exp, "xdeepfm", fs, model2, hyperparams=hp)
    scorer = load_scorer(exp, batch_size=BATCH)
    scores = drive("criteo_file_scoring", lambda: scorer.predict_proba(held))
    live = Scorer(model2, BATCH).predict_proba(held)
    gap = float(np.abs(scores - live).max())
    n_batches = -(-FILE_HELDOUT // BATCH)
    print(f"held-out scores from the export (load_scorer, cuda): max |gap| to the live "
          f"model {gap:.3e}; AUC {_auc(held['label'], scores):.4f} over {FILE_HELDOUT} "
          f"rows (the label planted on I1 and I2)")
    if gap > 1e-6 or not np.isfinite(scores).all() \
            or launches_by_path["criteo_file_scoring"] != expect(cin_fwd=2 * n_batches):
        fail(f"the export's held-out scores leave the live model's by {gap}")
    del model, opt, model2, opt2, scorer


def behavior_file_phase(drive, launches_by_path, tmp: str) -> None:
    """Phase 22 (c): DIEN on the kernel route trained from a behavior CSV
    through ``BehaviorFileIterator``, its checkpoint round trip and one more
    step on both copies."""
    from ml_function_tpu_torch.features import behavior_stream as bs
    from ml_function_tpu_torch.features.synthetic import make_behavior_data
    from ml_function_tpu_torch.models import get_model
    from ml_function_tpu_torch.train import checkpoint as ckpt
    from ml_function_tpu_torch.train.loop import TrainState, make_train_step
    from ml_function_tpu_torch.train.optimizers import make_optimizer

    t = time.perf_counter()
    n_rows = BEHAVIOR_FILE_BATCHES * BATCH
    _, data = make_behavior_data(n_rows=n_rows, **DIEN_DATA)
    path = os.path.join(tmp, "behavior.csv")
    write_behavior_csv(path, data)
    print(f"behavior file: {n_rows} rows, {os.path.getsize(path) / 2**20:.1f} MiB written "
          f"in {time.perf_counter() - t:.1f} s")
    # id → id % (buckets − 1) + 1 is one to one on 1..n while buckets ≥ n + 2
    items, cates = DIEN_DATA["n_items"] + 2, DIEN_DATA["n_cates"] + 2
    it = bs.BehaviorFileIterator(path, BATCH, seq_len=DIEN_DATA["seq_len"],
                                 item_buckets=items, cate_buckets=cates, engine="native")
    fs = it.feature_set(embed_dim=DIEN_DATA["embed_dim"])

    def model_on_kernels(seed):
        model = get_model("dien", fs, device="cuda",
                          generator=torch.Generator().manual_seed(seed))
        model.gru1.kernel = model.gru2.kernel = "pallas"
        return model, make_optimizer("adam", 1e-3).init(model)

    model, opt = model_on_kernels(0)
    step = make_train_step(model, opt)
    parsed, spare = [], []

    def run():
        for i, batch in enumerate(it):
            parsed.append(batch)
            if i < BEHAVIOR_FILE_STEPS:
                step(batch)
            elif i == BEHAVIOR_FILE_STEPS:
                spare.append(batch)
        torch.cuda.synchronize()

    with merge_scatter_flag(True):
        drive("behavior_file_training", run)
    enc = lambda a, b: bs.encode_int_ids(a.astype(np.int64), b)  # noqa: E731
    want = {"sparse": np.stack([enc(data["sparse"][:, 0], items),
                                enc(data["sparse"][:, 1], cates)], axis=1),
            "hist_item": enc(data["seq"]["hist_item"], items),
            "hist_cate": enc(data["seq"]["hist_cate"], cates),
            "label": data["label"]}
    got = {"sparse": np.concatenate([b["sparse"] for b in parsed]),
           "hist_item": np.concatenate([b["seq"]["hist_item"] for b in parsed]),
           "hist_cate": np.concatenate([b["seq"]["hist_cate"] for b in parsed]),
           "label": np.concatenate([b["label"] for b in parsed])}
    bad = [k for k in want if want[k].dtype != got[k].dtype
           or want[k].tobytes() != got[k].tobytes()]
    one_to_one = len(np.unique(want["hist_item"])) == len(np.unique(data["seq"]["hist_item"]))
    per = BEHAVIOR_FILE_STEPS
    launches = launches_by_path["behavior_file_training"]
    print(f"behavior stream (native): {len(parsed)} batches of {BATCH}, ids the written "
          f"arrays' after the encode bit for bit: {not bad} (one to one: {one_to_one}); "
          f"DIEN {per} steps on the kernel route, launches {launches}")
    if bad or not one_to_one or len(parsed) != BEHAVIOR_FILE_BATCHES \
            or launches != expect(gru_fwd=2 * per, gru_bwd=2 * per, merge_scatter=2 * per):
        fail(f"the behavior stream's ids differ ({bad}) or DIEN's launches are {launches}")

    ck_dir = os.path.join(tmp, "dien_ckpt")
    t = time.perf_counter()
    path_ck = ckpt.save_checkpoint(ck_dir, TrainState(model, opt, per))
    save_s = time.perf_counter() - t
    model2, opt2 = model_on_kernels(1)
    t = time.perf_counter()
    ts2, _ = ckpt.restore_checkpoint(path_ck, TrainState(model2, opt2, 0))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    diff = _same_state(ckpt.state_arrays(ts2), ckpt.state_arrays(TrainState(model, opt, per)))
    size = os.path.getsize(os.path.join(path_ck, "arrays.npz"))
    print(f"DIEN checkpoint: {size} bytes, save {save_s:.3f} s, restore {restore_s:.3f} s; "
          f"restored state the same bits: {not diff}")
    if diff or ts2.step != per:
        fail(f"DIEN's checkpoint round trip differs at {diff[:3]}")

    def both():
        return [make_train_step(m, o)(spare[0]) for m, o in ((model, opt), (model2, opt2))]

    with merge_scatter_flag(True):
        outs = drive("behavior_file_resumed_step", both)
    gap = abs(float(outs[0]["loss"]) - float(outs[1]["loss"]))
    with torch.no_grad():
        pgap = max(float((p - q).abs().max()) / max(float(p.abs().max()), 1e-30)
                   for p, q in zip(model.parameters(), model2.parameters()))
    print(f"one more step on both: loss gap {gap:.3e} (bar {FILE_REPLAY_RTOL} of the loss), "
          f"largest parameter gap after it {pgap:.3e} of max|p|")
    if gap > FILE_REPLAY_RTOL * abs(float(outs[0]["loss"])) \
            or launches_by_path["behavior_file_resumed_step"] != expect(
                gru_fwd=4, gru_bwd=4, merge_scatter=4):
        fail(f"the resumed DIEN's step leaves the original's by {gap}")
    del model, opt, model2, opt2


def file_phase(drive, launches_by_path) -> None:
    """Phase 22: train from files and resume. Both loaders built with g++
    from the port's copies (timed), then ``criteo_file_phase`` and
    ``behavior_file_phase``."""
    from concurrent.futures import ThreadPoolExecutor

    from ml_function_tpu_torch import native
    from ml_function_tpu_torch.features import behavior_stream as bs
    from ml_function_tpu_torch.features import native_loader as nl
    from ml_function_tpu_torch.ops.kernels import _build

    t = time.perf_counter()
    try:
        with ThreadPoolExecutor(2) as pool:
            libs = list(pool.map(native.build, ("criteo_loader", "behavior_loader")))
        nl.get_lib()
        bs._get_blib()
    except Exception as e:  # noqa: BLE001 (a failed build stops the run)
        fail(f"the native loaders did not build or load: {e}")
    print(f"native loaders: g++ build {time.perf_counter() - t:.2f} s "
          f"({', '.join(os.path.basename(str(p)) for p in libs)})")
    with tempfile.TemporaryDirectory(dir=_build.BUILD) as tmp:
        criteo_file_phase(drive, launches_by_path, tmp)
        behavior_file_phase(drive, launches_by_path, tmp)


# Row-sharded tables over torch.distributed (phase 23). The card machine has
# one H100, so NCCL runs at world size 1 (a FileStore group of this process);
# the collective code paths run on the card, but no rank splits a table
# there. Two CPU gloo ranks of a (1, 2) mesh do split one (part d).
SHARD_STEPS = 32                  # CLI steps at B 4096 (test_frac 0.2 of 163,840 rows)
SHARD_SAVE = 16                   # the sharded checkpoint the second run resumes from
CPU_RANKS = 2
CPU_RANK_BATCH = 1024             # a multiple of 256: the CIN kernel route on the card
CPU_RANK_STEPS = 3
CPU_RANK_THREADS = 3              # 8 cores: 3 for each CPU rank, 2 for parts (a)-(c)
SHARD_SCORE_BAR = 1e-4            # the card's scores against the CPU ranks'
XDFM_HP = {"cin_hidden": (128, 128), "hidden": (256, 128)}


def _flat_tree(tree, prefix="params/") -> dict:
    """A gathered parameter tree's leaves under their ``weights.npz`` keys."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_flat_tree(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _cpu_rank(rank: int, io_dir: str) -> None:
    """One of the CPU gloo ranks of part (d): a (1, 2) mesh, the card's
    xDeepFM weights (``weights.npz``) sharded, 3 Adam steps with f32
    matmuls, a sharded checkpoint, and the scores of the held rows."""
    os.environ["ML_FUNCTION_TPU_F32_MATMUL"] = "1"
    from ml_function_tpu_torch.bridge import sharded_params_to_numpy
    from ml_function_tpu_torch.features.schema import criteo_feature_set
    from ml_function_tpu_torch.models import get_model
    from ml_function_tpu_torch.parallel.context import sharded_embeddings
    from ml_function_tpu_torch.parallel.mesh import make_mesh
    from ml_function_tpu_torch.parallel.train import (create_sharded_state,
                                                      make_sharded_train_step, shard_batch)
    from ml_function_tpu_torch.train.checkpoint import save_checkpoint
    from ml_function_tpu_torch.train.optimizers import make_optimizer

    fs = criteo_feature_set([100_000] * 26, n_dense=13, embed_dim=8)
    mesh = make_mesh(1, CPU_RANKS, device="cpu")
    with np.load(os.path.join(io_dir, "weights.npz")) as w:
        init = dict(w)
    with np.load(os.path.join(io_dir, "batches.npz")) as d:
        batches = [{k: d[f"{k}{i}"] for k in ("dense", "sparse", "label")}
                   for i in range(CPU_RANK_STEPS + 1)]
    from ml_function_tpu_torch.utils.hlo_stats import record_collectives

    model = get_model("xdeepfm", fs, device="cpu", **XDFM_HP)
    ts = create_sharded_state(model, make_optimizer("adam", 1e-3), mesh, init_params=init)
    step = make_sharded_train_step(ts.model, ts.optimizer, mesh)
    # phase 27 (b) reads the first step's collectives
    with record_collectives() as first:
        losses = [float(step(shard_batch(batches[0], mesh))["loss"])]
    losses += [float(step(shard_batch(b, mesh))["loss"]) for b in batches[1:CPU_RANK_STEPS]]
    ts.step = CPU_RANK_STEPS
    save_checkpoint(os.path.join(io_dir, "ckpt"), ts)
    with torch.no_grad(), sharded_embeddings(mesh):
        probs = torch.sigmoid(ts.model(batches[-1])[0]).numpy()
    full = _flat_tree(sharded_params_to_numpy(ts.model, ts.layout, mesh))
    records = {"psum (1, 2)": _records(first), **_account_steps(ts, fs, batches[0], mesh)}
    if rank == 0:
        np.savez(os.path.join(io_dir, "cpu_ranks.npz"), probs=probs,
                 losses=np.asarray(losses), **full)
        with open(os.path.join(io_dir, "records.json"), "w") as f:
            json.dump(records, f)


def _records(stats) -> list:
    """A recorder's records as [op, bytes, group size, group kind, dtype]."""
    return [[i.op, i.bytes, i.group_size, i.group, i.dtype] for i in stats.instrs]


def _account_steps(ts, fs, batch, mesh) -> dict:
    """Phase 27 (b)'s further steps on the CPU ranks, after phase 23 (d)'s
    checkpoint and scores: one a2a step of ``ts`` on ``mesh``, then one psum
    step of a fresh xDeepFM on a (2, 1) mesh of the same ranks (every
    parameter replicated, so the step sums every gradient over a data group
    of 2). Their records by name."""
    from ml_function_tpu_torch.models import get_model
    from ml_function_tpu_torch.parallel.mesh import make_mesh
    from ml_function_tpu_torch.parallel.train import (create_sharded_state,
                                                      make_sharded_train_step, shard_batch)
    from ml_function_tpu_torch.train.optimizers import make_optimizer
    from ml_function_tpu_torch.utils.hlo_stats import collective_stats

    out = {}
    step = make_sharded_train_step(ts.model, ts.optimizer, mesh, exchange="a2a")
    out[f"a2a (1, {mesh.model})"] = _records(collective_stats(step, shard_batch(batch, mesh)))
    dp = make_mesh(mesh.size, 1, device="cpu")
    model = get_model("xdeepfm", fs, device="cpu", generator=torch.Generator().manual_seed(0),
                      **XDFM_HP)
    dts = create_sharded_state(model, make_optimizer("adam", 1e-3), dp)
    step = make_sharded_train_step(dts.model, dts.optimizer, dp)
    out[f"psum ({mesh.size}, 1)"] = _records(collective_stats(step, shard_batch(batch, dp)))
    return out


def shard_lookup_part(table, gids, mesh, fs) -> None:
    """(a) ShardedLookup in both modes, bf16-compressed, and at a finite
    capacity (the slice's unique ids: lossless; one fewer: one id
    dropped), over NCCL at a model group of 1, against ``index_select``."""
    from ml_function_tpu_torch.parallel.embedding import ShardedLookup
    from ml_function_tpu_torch.tools.timing import event_ms

    flat = gids.reshape(-1)
    want = table.index_select(0, flat).reshape(*gids.shape, table.shape[1])
    ct = torch.randn(want.shape, generator=torch.Generator("cuda").manual_seed(0),
                     device="cuda")
    t = table.detach().clone().requires_grad_()
    t.index_select(0, flat).reshape(want.shape).mul(ct).sum().backward()
    want_grad = t.grad
    # each table element's summed cotangent magnitudes over its ids' occurrences
    ct_abs = torch.zeros_like(want_grad).index_add_(
        0, flat, ct.abs().reshape(-1, table.shape[1]))
    hit = ct_abs > 0
    uniq = int(torch.unique(flat).numel())
    lib_ms = event_ms(lambda: table.index_select(0, flat), reps=10, inner=5)
    print(f"sharded lookup: {flat.numel()} ids ({uniq} unique) into {table.shape[0]} rows "
          f"of width {table.shape[1]}; index_select {lib_ms:.4f} ms (events)")
    for mode, compress, cap in (("psum", None, None), ("a2a", None, None),
                                ("psum", "bf16", None), ("a2a", "bf16", None),
                                ("a2a", None, uniq), ("a2a", None, uniq - 1)):
        sl = ShardedLookup(mesh, fs, mode=mode, capacity=cap, compress=compress)
        got = sl.lookup(table, gids)
        ref = want if compress is None else want.bfloat16().float()
        overflow = sl.overflow_count(gids)
        t = table.detach().clone().requires_grad_()
        sl.lookup(t, gids).mul(ct).sum().backward()
        diff = (t.grad - want_grad).abs()
        if compress:
            # the bf16 wire rounds the cotangent, each time within bf16's
            # unit roundoff 2^-8 of it: psum each occurrence's once, the a2a
            # each occurrence's and then each deduped slot's sum. So an
            # element's error stays within 2^-8 a rounding of the summed
            # magnitudes of its id's occurrences (a duplicated id adds up
            # their roundings), with 2^-6 of that for the f32 sums
            roundings = 2 if mode == "a2a" else 1
            gerr = float((diff[hit] / ct_abs[hit]).max())
            gbar = roundings * 2.0 ** -8 * (1 + 2.0 ** -6)
            of = "of its summed |cotangent|"
        else:
            gerr = float(diff.max()) / float(want_grad.abs().max())
            gbar, of = 1e-6, "of its max"
        ms = event_ms(lambda: sl.lookup(table, gids), reps=10, inner=5)
        same = bool(torch.equal(got, ref))
        print(f"sharded lookup {mode} compress={compress} capacity={cap}: rows the same bits "
              f"as index_select{' (bf16-cast)' if compress else ''}: {same}; overflow "
              f"{overflow}; table gradient within {gerr:.3e} of index_select's "
              f"backward ({of}; bar {gbar:.3e}); {ms:.4f} ms (events)")
        dropped = cap is not None and cap < uniq
        if dropped:
            if same or overflow != uniq - cap:
                fail(f"the a2a at capacity {cap} of {uniq} unique ids dropped {overflow}")
        elif not same or overflow != 0 or gerr > gbar:
            fail(f"ShardedLookup {mode} {compress} {cap} differs from index_select "
                 f"(rows {same}, overflow {overflow}, gradient {gerr})")


def shard_scorer_part(model, data, mesh, drive, launches_by_path) -> None:
    """(b) ShardedScorer against Scorer on the same model: the same bits, 2
    cin_fwd launches a batch."""
    from ml_function_tpu_torch.serving import Scorer, ShardedScorer

    Scorer(model, BATCH).predict_proba(data)          # warm
    t = time.perf_counter()
    want = Scorer(model, BATCH).predict_proba(data)
    plain_s = time.perf_counter() - t
    scorer = ShardedScorer(model, mesh, batch_size=BATCH)
    t = time.perf_counter()
    got = drive("sharded_scoring", lambda: scorer.predict_proba(data))
    sharded_s = time.perf_counter() - t
    n_batches = -(-len(data["label"]) // BATCH)
    launches = launches_by_path["sharded_scoring"]
    same = bool(np.array_equal(got, want))
    print(f"ShardedScorer (1, 1) over NCCL: {len(got)} rows in {n_batches} batches, the "
          f"same bits as Scorer: {same}; launches {launches}; {sharded_s:.3f} s against "
          f"Scorer's {plain_s:.3f} s (host clock, one call each after a warm one)")
    if not same or launches != expect(cin_fwd=2 * n_batches):
        fail(f"ShardedScorer differs from Scorer ({same}) or launched {launches}")


def shard_cli_part(tmp, drive, launches_by_path) -> None:
    """(c) The CLI's ``run`` on the card: 32 Adam steps of xDeepFM on
    ``make_criteo_like`` data with a sharded checkpoint every 16, then a
    second run that resumes from step 16's; the resumed losses against the
    uninterrupted run's, 2 + 2 CIN launches a step."""
    from ml_function_tpu_torch.ops.kernels import cin as cin_mod
    from ml_function_tpu_torch.train import cli

    n_rows = SHARD_STEPS * BATCH * 5 // 4
    argv = ["--config.model.name=xdeepfm", "--config.model.hidden=(256,128)",
            "--config.model.extra.cin_hidden=[128,128]", "--config.model.embed_dim=8",
            f"--config.data.n_rows={n_rows}", "--config.data.vocab_size=100000",
            "--config.data.test_frac=0.2", f"--config.train.batch_size={BATCH}",
            "--config.train.optimizer=adam", "--config.train.learning_rate=1e-3",
            f"--config.train.checkpoint_every={SHARD_SAVE}", "--config.train.log_every=0"]
    timings = {"save": [], "restore": []}
    real_save, real_restore = cli.save_checkpoint, cli.restore_latest

    def timed(kind, fn):
        def call(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            timings[kind].append(time.perf_counter() - t)
            return out
        return call

    def one_run(ck_dir, label):
        cfg, _ = cli.parse_args(argv + [f"--config.train.checkpoint_dir={ck_dir}"])
        losses, per_step, marks = {}, [], []
        last = [0, 0]           # drive zeroes the counts before the run

        def on_step(i, out):
            now = (cin_mod.cin_fwd_launches, cin_mod.cin_bwd_launches)
            per_step.append((now[0] - last[0], now[1] - last[1]))
            last[:] = now
            losses[i] = out["loss"]
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append((i, time.perf_counter(), e))

        with swapped(cli, "save_checkpoint", timed("save", real_save)), \
                swapped(cli, "restore_latest", timed("restore", real_restore)):
            res = drive(label, lambda: cli.run(cfg, device="cuda", on_step=on_step))
        torch.cuda.synchronize()
        host = [(b[1] - a[1]) * 1e3 for a, b in zip(marks, marks[1:])
                if a[0] % SHARD_SAVE and b[0] % SHARD_SAVE]
        dev = [a[2].elapsed_time(b[2]) for a, b in zip(marks, marks[1:])
               if a[0] % SHARD_SAVE and b[0] % SHARD_SAVE]
        return res, {i: float(v) for i, v in losses.items()}, per_step, host, dev

    dir_a, dir_b = os.path.join(tmp, "cli_a"), os.path.join(tmp, "cli_b")
    t = time.perf_counter()
    res_a, loss_a, steps_a, host, dev = one_run(dir_a, "cli_training")
    print(f"CLI run on the card (xdeepfm, (1, 1) mesh, NCCL): {res_a['steps']} steps at "
          f"B {BATCH} in {time.perf_counter() - t:.1f} s; the sharded step "
          f"{statistics.median(host):.3f} ms by the host clock and "
          f"{statistics.median(dev):.3f} ms by CUDA events (medians, steps between "
          f"checkpoints); eval AUC {res_a['eval']['auc']:.4f} over "
          f"{int(res_a['eval']['count'])} rows")
    step16 = os.path.join(dir_a, f"ckpt_{SHARD_SAVE:010d}")
    with open(os.path.join(step16, "manifest.json")) as f:
        manifest = json.load(f)
    size = sum(os.path.getsize(os.path.join(step16, n)) for n in os.listdir(step16))
    print(f"sharded checkpoint: {size} bytes ({size / 2**20:.1f} MiB, format "
          f"{manifest['format']}, {len(manifest['keys'])} arrays); save "
          f"{', '.join(f'{s:.3f}' for s in timings['save'])} s")
    n_eval = -(-int(res_a["eval"]["count"]) // BATCH)
    if (res_a["steps"] != SHARD_STEPS or manifest["format"] != "sharded"
            or any(c != (2, 2) for c in steps_a)
            or launches_by_path["cli_training"] != expect(
                cin_fwd=2 * SHARD_STEPS + 2 * n_eval, cin_bwd=2 * SHARD_STEPS)):
        fail(f"the CLI run: {res_a['steps']} steps, format {manifest['format']}, launches "
             f"{launches_by_path['cli_training']}, per step {sorted(set(steps_a))}")

    os.makedirs(dir_b)
    shutil.copytree(step16, os.path.join(dir_b, os.path.basename(step16)))
    res_b, loss_b, steps_b, _, _ = one_run(dir_b, "cli_resumed")
    rel = max(abs(loss_b[i] - loss_a[i]) / abs(loss_a[i]) for i in loss_b)
    first = loss_b[SHARD_SAVE + 1] == loss_a[SHARD_SAVE + 1]
    print(f"CLI resumed from step {SHARD_SAVE}'s sharded checkpoint (restore "
          f"{timings['restore'][-1]:.3f} s): steps {sorted(loss_b)[0]}-{sorted(loss_b)[-1]}, "
          f"largest relative loss gap to the uninterrupted run {rel:.3e} (bar "
          f"{FILE_REPLAY_RTOL}), step {SHARD_SAVE + 1} the same bits: {first}; eval AUC "
          f"{res_b['eval']['auc']:.4f}")
    if (sorted(loss_b) != list(range(SHARD_SAVE + 1, SHARD_STEPS + 1)) or not first
            or rel > FILE_REPLAY_RTOL or any(c != (2, 2) for c in steps_b)
            or launches_by_path["cli_resumed"] != expect(
                cin_fwd=2 * (SHARD_STEPS - SHARD_SAVE) + 2 * n_eval,
                cin_bwd=2 * (SHARD_STEPS - SHARD_SAVE))):
        fail(f"the resumed CLI run leaves the uninterrupted one by {rel} (launches "
             f"{launches_by_path['cli_resumed']})")


def start_cpu_ranks(fs, data, tmp, pool):
    """Start part (d)'s two CPU gloo ranks on ``pool``: they take the seeded
    xDeepFM weights and the first rows of ``data`` from files and need
    nothing of the card, so they train while parts (a) to (c) run. Returns
    (their directory, the future of their wall seconds)."""
    from ml_function_tpu_torch.bridge import flat_params
    from ml_function_tpu_torch.models import get_model
    from ml_function_tpu_torch.parallel.launch import spawn

    io_dir = os.path.join(tmp, "cpu_ranks")
    os.makedirs(io_dir)
    seeded = get_model("xdeepfm", fs, device="cpu",
                       generator=torch.Generator().manual_seed(0), **XDFM_HP)
    np.savez(os.path.join(io_dir, "weights.npz"), **flat_params(seeded))
    b = CPU_RANK_BATCH
    np.savez(os.path.join(io_dir, "batches.npz"),
             **{f"{k}{i}": data[k][i * b:(i + 1) * b]
                for i in range(CPU_RANK_STEPS + 1) for k in ("dense", "sparse", "label")})

    def run() -> float:
        t = time.perf_counter()
        spawn(_cpu_rank, CPU_RANKS, (io_dir,), store_dir=io_dir, threads=CPU_RANK_THREADS)
        return time.perf_counter() - t

    return io_dir, pool.submit(run)


def shard_cpu_ranks_part(fs, data, io_dir, ranks, drive, launches_by_path) -> None:
    """(d) Two CPU gloo ranks of a (1, 2) mesh (``start_cpu_ranks``) train
    the card's weights 3 steps and write a sharded checkpoint; the card
    restores it by stitching into its (1, 1) state and scores the held
    rows."""
    from ml_function_tpu_torch.bridge import flat_params
    from ml_function_tpu_torch.models import get_model
    from ml_function_tpu_torch.serving import Scorer
    from ml_function_tpu_torch.train import checkpoint as ckpt
    from ml_function_tpu_torch.train.loop import TrainState
    from ml_function_tpu_torch.train.optimizers import make_optimizer

    b = CPU_RANK_BATCH
    ranks_s = ranks.result()
    print(f"CPU gloo ranks (1, {CPU_RANKS}): {CPU_RANK_STEPS} steps at B {b}, a sharded "
          f"checkpoint and the held rows' scores in {ranks_s:.1f} s, beside parts (a) to (c)")
    with np.load(os.path.join(io_dir, "cpu_ranks.npz")) as r:
        cpu = dict(r)
    path = os.path.join(io_dir, "ckpt", f"ckpt_{CPU_RANK_STEPS:010d}")
    files = sorted(os.listdir(path))
    model = get_model("xdeepfm", fs, device="cuda",
                      generator=torch.Generator().manual_seed(7), **XDFM_HP)
    opt = make_optimizer("adam", 1e-3).init(model)
    t = time.perf_counter()
    ts, _ = ckpt.restore_checkpoint(path, TrainState(model, opt, 0))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    mine = flat_params(model)
    same = all(np.array_equal(mine[k], cpu[k]) for k in mine) and sorted(mine) == sorted(
        k for k in cpu if k.startswith("params/"))
    held = {k: data[k][CPU_RANK_STEPS * b:(CPU_RANK_STEPS + 1) * b]
            for k in ("dense", "sparse", "label")}
    os.environ["ML_FUNCTION_TPU_F32_MATMUL"] = "1"
    try:
        probs = drive("cpu_ranks_restored_scoring",
                      lambda: Scorer(model, b).predict_proba(held))
    finally:
        os.environ.pop("ML_FUNCTION_TPU_F32_MATMUL")
    gap = float(np.abs(probs - cpu["probs"]).max())
    print(f"the CPU ranks' sharded checkpoint ({files}) restored on the card by stitching "
          f"into (1, 1) in {restore_s:.3f} s: step {ts.step}, parameters the ranks' gathered "
          f"ones bit for bit: {same}; scores of {b} held rows within {gap:.3e} of the CPU "
          f"ranks' (bar {SHARD_SCORE_BAR}; f32 matmuls on both); CPU losses "
          f"{', '.join(f'{x:.5f}' for x in cpu['losses'])}")
    if (ts.step != CPU_RANK_STEPS or not same or gap > SHARD_SCORE_BAR
            or files != ["manifest.json", "shards_00000.npz", "shards_00001.npz"]
            or launches_by_path["cpu_ranks_restored_scoring"] != expect(cin_fwd=2)):
        fail(f"the card's restore of the CPU ranks' checkpoint: step {ts.step}, params "
             f"{same}, gap {gap}, files {files}")


# Collective accounting of the sharded step (phase 27), on phase 23's NCCL
# group of one rank and the steps phase 23 (d)'s CPU ranks recorded
FLOOR_CALLS = 50                  # 4-byte all-reduces timed for the call floor
ACCOUNT_TIMING = dict(reps=10, inner=5, warmup=2)
DEEPFM_HP = {"hidden": (256, 128, 64)}


def account_formulas(name: str, b_loc: int, f: int, d: int, m: int, n_data: int,
                     param_bytes: int) -> list:
    """The collectives one rank of a (n_data, m) mesh issues in one xDeepFM
    step of exchange ``name`` ('psum' or 'a2a') at ``b_loc`` rows a rank, F
    fields of width D: [op, bytes, group size, group, dtype, formula] each.
    Two lookups read the tables, the rows (width D) and the linear weights
    (width 1). psum: each an all-reduce of B_loc·F·W·4 over 'model' (its
    backward issues none); a model axis of 1 takes the local gather. a2a:
    each ships its ids as int32 (m·cap·4, cap = S = ⌈B_loc·F/m⌉, the
    lossless capacity), the rows back (m·cap·W·4), gathers them (m·S·W·4)
    and sends their cotangent back in the backward (m·cap·W·4). Over
    'data': the weight sum (4), every parameter's gradient in one flat
    all-reduce where the data axis is above 1 (``param_bytes``), the loss
    pair (8)."""
    n = b_loc * f
    s_ = -(-n // m)
    out = []
    for w, what in ((d, "rows"), (1, "linear weights")):
        if m == 1:
            continue
        if name == "psum":
            out.append(["all-reduce", n * w * 4, m, "model", "float32",
                        f"psum of the {what}: B_loc·F·{w}·4"])
        else:
            out += [["all-to-all", m * s_ * 4, m, "model", "int32",
                     f"int32 id request of the {what}: m·cap·4"],
                    ["all-to-all", m * s_ * w * 4, m, "model", "float32",
                     f"the {what} back: m·cap·{w}·4"],
                    ["all-gather", m * s_ * w * 4, m, "model", "float32",
                     f"the {what} gathered: m·S·{w}·4"],
                    ["all-to-all", m * s_ * w * 4, m, "model", "float32",
                     f"the {what}' cotangent: m·cap·{w}·4"]]
    out.append(["all-reduce", 4, n_data, "data", "float32", "the weight sum: 4"])
    if n_data > 1:
        out.append(["all-reduce", param_bytes, n_data, "data", "float32",
                    "the flat gradient: every parameter's bytes"])
    out.append(["all-reduce", 8, n_data, "data", "float32", "the loss pair: 8"])
    return out


def _key(r) -> tuple:
    return tuple(r[:5])


def account_card_part(mesh, data, drive, launches_by_path) -> dict:
    """Phase 27 (a): one recorded step of the CLI's sharded xDeepFM step
    (psum, the CLI's default) and of DeepFM's at phase 23 (c)'s width and
    batch on the card, each step's time by events. Returns the step times
    and xDeepFM's parameter bytes."""
    from ml_function_tpu_torch.features.schema import criteo_feature_set
    from ml_function_tpu_torch.models import get_model
    from ml_function_tpu_torch.models.base import as_tensors
    from ml_function_tpu_torch.parallel.train import create_sharded_state, make_sharded_train_step
    from ml_function_tpu_torch.tools.timing import event_ms
    from ml_function_tpu_torch.train.optimizers import make_optimizer
    from ml_function_tpu_torch.utils.hlo_stats import collective_stats

    fs = criteo_feature_set([100_000] * 26, n_dense=13, embed_dim=8)
    batch = as_tensors({k: data[k][:BATCH] for k in ("dense", "sparse", "label")}, "cuda")
    out = {}
    for name, hp in (("xdeepfm", XDFM_HP), ("deepfm", DEEPFM_HP)):
        model = get_model(name, fs, device="cuda", generator=torch.Generator().manual_seed(0),
                          **hp)
        ts = create_sharded_state(model, make_optimizer("adam", 1e-3), mesh)
        step = make_sharded_train_step(ts.model, ts.optimizer, mesh)
        step(batch)
        torch.cuda.synchronize()
        path = f"accounted_{name}_step"
        stats = drive(path, lambda: collective_stats(step, batch))
        ms = event_ms(lambda: step(batch), **ACCOUNT_TIMING)
        kinds = sorted({(i.op, i.group, i.group_size, i.dtype) for i in stats.instrs})
        print(f"phase 27 (a) {name} sharded step on the card (NCCL, mesh {mesh.data}x"
              f"{mesh.model}, B {BATCH}): {stats.total_count} collectives, counts "
              f"{stats.counts}, bytes {stats.bytes}, total {stats.total_bytes} bytes; kinds "
              f"(op, group, size, dtype) {kinds}; records {_records(stats)}; wire bytes "
              f"{stats.wire_bytes()}; launches {launches_by_path[path]}; the step "
              f"{ms:.4f} ms by CUDA events ({ACCOUNT_TIMING['reps']} samples of "
              f"{ACCOUNT_TIMING['inner']} steps back to back, the batch on the card)")
        want = expect(cin_fwd=2, cin_bwd=2) if name == "xdeepfm" else expect()
        if (launches_by_path[path] != want or stats.wire_bytes() != 0.0 or not stats.instrs
                or any(i.group_size != 1 for i in stats.instrs)):
            fail(f"phase 27 (a): the recorded {name} step launched {launches_by_path[path]} "
                 f"(expected {want}) or recorded {_records(stats)}")
        out[name] = ms
        if name == "xdeepfm":
            out["param_bytes"] = sum(p.numel() * p.element_size()
                                     for p in ts.model.parameters())
        del model, ts, step
    return out


def call_floor_ms(mesh) -> float:
    """Phase 27 (c): the median of ``FLOOR_CALLS`` 4-byte all-reduces over
    the mesh's data group (one rank), each between two CUDA events."""
    from ml_function_tpu_torch.parallel import comm

    x = torch.ones(1, device="cuda")
    times = []
    for i in range(FLOOR_CALLS + 5):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        comm.all_reduce_(x, mesh.data_group)
        b.record()
        b.synchronize()
        if i >= 5:
            times.append(a.elapsed_time(b))
    return statistics.median(times)


def account_phase(mesh, data, io_dir, smi: str, drive, launches_by_path) -> None:
    """Phase 27: (a) the card's recorded steps, (b) the CPU ranks' records
    against their formulas, (c) the NCCL call floor, (d) the projection."""
    from ml_function_tpu_torch.utils.hlo_stats import (CollectiveInstr, LinkModel,
                                                       projected_efficiency)

    t = time.perf_counter()
    card = account_card_part(mesh, data, drive, launches_by_path)
    with open(os.path.join(io_dir, "records.json")) as f:
        ranks = json.load(f)
    shapes = {"psum (1, 2)": ("psum", 1, CPU_RANKS), "a2a (1, 2)": ("a2a", 1, CPU_RANKS),
              "psum (2, 1)": ("psum", CPU_RANKS, 1)}
    if sorted(ranks) != sorted(shapes):
        fail(f"phase 27 (b): the CPU ranks recorded {sorted(ranks)}")
    for name, (kind, n_data, m) in shapes.items():
        want = account_formulas(kind, CPU_RANK_BATCH // n_data, 26, 8, m, n_data,
                                card["param_bytes"])
        got = ranks[name]
        same = sorted(map(_key, got)) == sorted(map(_key, want))
        print(f"phase 27 (b) the CPU gloo ranks' {name} step (xDeepFM, B {CPU_RANK_BATCH}): "
              f"{len(got)} collectives, the formulas' {len(want)}, each kind's bytes equal to "
              f"its formula: {same}")
        for r in want:
            print(f"    {r[0]} over '{r[3]}' (size {r[2]}, {r[4]}): {r[1]} bytes = {r[5]}")
        if not same:
            fail(f"phase 27 (b): the {name} step recorded {sorted(map(_key, got))}, the "
                 f"formulas give {sorted(map(_key, want))}")
    floor = call_floor_ms(mesh)
    print(f"phase 27 (c) the floor of one NCCL call on this card: a 4-byte all-reduce at "
          f"world size 1, {floor:.4f} ms (the median of {FLOOR_CALLS}, CUDA events; {smi})")
    link = LinkModel(latency_s=floor * 1e-3)
    for name, (kind, n_data, m) in shapes.items():
        # the formulas held in (b), at the card's batch
        recs = account_formulas(kind, BATCH, 26, 8, m, n_data, card["param_bytes"])
        wire = sum(CollectiveInstr(r[0], r[1], r[2]).wire_bytes() for r in recs)
        eff = [projected_efficiency(card["xdeepfm"] * 1e-3, wire, len(recs), link,
                                    overlap=o) for o in (0.0, 0.5)]
        print(f"phase 27 (d) xDeepFM at 2 cards, {name}: {len(recs)} collectives, "
              f"{wire:.0f} wire bytes a step at B {BATCH} a card, "
              f"{1e3 * eff[0]['t_comm_s']:.4f} ms of "
              f"communication on NVLink 4 at {link.gbps_per_direction:.0f} GB/s a direction "
              f"(data sheet) and {floor:.4f} ms a call; the card's step "
              f"{card['xdeepfm']:.4f} ms: projected efficiency {eff[0]['efficiency']:.4%} "
              f"exposed, {eff[1]['efficiency']:.4%} at 50% overlap ({smi})")
    print(f"phase 27 step times for tools/scaling_report: "
          f"{json.dumps({k: card[k] for k in ('xdeepfm', 'deepfm')})}")
    print(f"wall time of phase 27: {time.perf_counter() - t:.1f} s", flush=True)


@contextlib.contextmanager
def sharded_ranks():
    """Phase 23's data and part (d)'s two CPU gloo ranks, started on entry
    (they need nothing of the card, so they train beside whatever the card
    runs meanwhile) and joined on exit, whatever fails, before their
    directory goes. Yields (fs, data, tmp, io_dir, the ranks' future)."""
    from concurrent.futures import ThreadPoolExecutor

    from ml_function_tpu_torch.features.schema import criteo_feature_set
    from ml_function_tpu_torch.features.synthetic import make_criteo_like
    from ml_function_tpu_torch.ops.kernels import _build

    fs = criteo_feature_set([100_000] * 26, n_dense=13, embed_dim=8)
    _, data = make_criteo_like(n_rows=3 * BATCH + 1000, vocab_size=100_000, seed=0)
    with tempfile.TemporaryDirectory(dir=_build.BUILD) as tmp, ThreadPoolExecutor(1) as pool:
        io_dir, ranks = start_cpu_ranks(fs, data, tmp, pool)
        yield fs, data, tmp, io_dir, ranks


def sharded_phase(drive, launches_by_path, smi: str, started) -> None:
    """Phase 23: row-sharded tables over torch.distributed at xDeepFM's full
    width: (a) the collective lookups, (b) ShardedScorer, (c) the CLI with a
    sharded checkpoint and a resume, (d) two CPU gloo ranks that split a
    table (``started``: what ``sharded_ranks`` yields, entered before phase
    22; they train beside the card's parts), restored on the card; then
    phase 27 (``account_phase``) on the same group, with the ranks'
    records."""
    from ml_function_tpu_torch.models import get_model
    from ml_function_tpu_torch.parallel.launch import init_single
    from ml_function_tpu_torch.parallel.mesh import make_mesh

    fs, data, tmp, io_dir, ranks = started
    t = time.perf_counter()
    init_single(tmp)
    mesh = make_mesh(device="cuda")
    print(f"process group: NCCL at world size 1, mesh {mesh}")
    try:
        model = get_model("xdeepfm", fs, device="cuda",
                          generator=torch.Generator().manual_seed(0), **XDFM_HP)
        gids = (torch.as_tensor(data["sparse"][:BATCH], device="cuda").long()
                + torch.as_tensor(fs.sparse_offsets(), device="cuda")[None, :])
        with torch.no_grad():
            table = model.embedding.table.detach()
        shard_lookup_part(table, gids, mesh, fs)
        print(f"wall time of phase 23 (a): {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        shard_scorer_part(model, data, mesh, drive, launches_by_path)
        del model
        print(f"wall time of phase 23 (b): {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        shard_cli_part(tmp, drive, launches_by_path)
        print(f"wall time of phase 23 (c): {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        shard_cpu_ranks_part(fs, data, io_dir, ranks, drive, launches_by_path)
        print(f"wall time of phase 23 (d): {time.perf_counter() - t:.1f} s")
        account_phase(mesh, data, io_dir, smi, drive, launches_by_path)
    finally:
        torch.distributed.destroy_process_group()



# Item 8b over torch.distributed (phase 24). NCCL at world size 1 again, so
# the sequence-parallel and pipeline routes run on the card with a model
# group of 1; two CPU gloo ranks of a (1, 2) mesh split the stream and the
# block stack (part d).
SEARCH_8B = (512, 256)             # SIM's board row (bench.py:749-758): B 512, top 256 of 16,384
# (B, H, Lq, Lk, Dh): the flash row's 8 rows of 16,384 keys (2 heads of 8),
# 256 queries (a dense softmax over 16,384 queries would hold 17 GB of scores)
ATTN_8B = (8, 2, 256, 16384, 8)
ATTN_8B_BAR = 1e-5                 # of the dense softmax's max |value|, output and gradients
PIPE_8B = dict(n_layers=4, micro=4)   # AutoInt at phase 3's width, one stage
PIPE_8B_BAR = 1e-5                 # of the sequential stack's max |value| (f32 matmuls)
RANKS_8B_SIM = dict(n_rows=64, L=1024, top_k=32)   # reduced depth: L divides by 2
RANKS_8B_AUTOINT_ROWS = 1024
RANKS_8B_LR = 0.05                 # SGD: the update is linear in the gradient
# One step's parameter changes held against each other, leaf by leaf, each
# over its own largest change, floored at UPDATE_FLOOR of the model's
# largest: a leaf whose gradient is zero but for rounding (an attention
# MLP's output bias, under the softmax) moves by noise alone. A stage
# gradient left unsummed or summed twice moves a leaf's change by all of it
# (1.0); f32 rounding of the parameters after the step is ulp(|p|) over the
# floor, up to 2e-3 here.
UPDATE_FLOOR = 1e-3
UPDATE_8B_BAR = 1e-2


def sim_long_batch(n_rows: int, L: int, seed: int):
    """The bench's behavior schema (``profile_scoring.sim_batch``: 5,000
    items, 100 categories, histories of 64, dim 8) with an L-long stream,
    one id in ten a pad (0)."""
    from ml_function_tpu_torch.tools.profile_scoring import sim_batch
    fs, data = sim_batch(n_rows, seed=seed)
    rng = np.random.default_rng(seed + 1)
    spec = fs.seq_spec("hist_long")
    long = rng.integers(1, spec.vocab_size, (n_rows, L), dtype=np.int32)
    long[rng.random((n_rows, L)) < 0.1] = 0
    fs = fs.replace(seq=tuple(dataclasses.replace(s, max_len=L) if s is spec else s
                              for s in fs.seq))
    data["seq"]["hist_long"] = long
    return fs, data


def ranks_8b_cases():
    """(name, model, feature set, hyperparameters, flags, batch) of part
    (d): a ``seq_shard`` SIM step and a pipelined AutoInt step (4 blocks
    over 2 stages, 2 microbatches)."""
    from ml_function_tpu_torch.features.schema import criteo_feature_set
    from ml_function_tpu_torch.features.synthetic import make_criteo_like
    s = RANKS_8B_SIM
    fs, data = sim_long_batch(s["n_rows"], s["L"], seed=3)
    sim = ("sim_seq_shard", "sim", fs, dict(search="soft", top_k=s["top_k"],
                                            long_behavior=("hist_long",), hidden=(200, 80)),
           dict(seq_shard=True), data)
    afs = criteo_feature_set([100_000] * 26, n_dense=13, embed_dim=8)
    _, adata = make_criteo_like(n_rows=RANKS_8B_AUTOINT_ROWS, vocab_size=100_000, seed=5)
    auto = ("autoint_pp2", "autoint", afs, dict(n_layers=4, num_heads=2, head_dim=16),
            dict(pp_microbatches=2), adata)
    return [sim, auto]


def _cpu_rank_8b(rank: int, io_dir: str) -> None:
    """One of part (d)'s CPU gloo ranks: for each case the card's seeded
    weights (``weights_<name>.npz``) sharded over a (1, 2) mesh, one SGD
    step with the case's flag and f32 matmuls; rank 0 writes the loss, the
    logits and the gathered parameters after it."""
    os.environ["ML_FUNCTION_TPU_F32_MATMUL"] = "1"
    from ml_function_tpu_torch.bridge import sharded_params_to_numpy
    from ml_function_tpu_torch.models import get_model
    from ml_function_tpu_torch.parallel import comm
    from ml_function_tpu_torch.parallel.mesh import make_mesh
    from ml_function_tpu_torch.parallel.train import (create_sharded_state,
                                                      make_sharded_train_step, shard_batch)
    from ml_function_tpu_torch.train.optimizers import make_optimizer

    mesh = make_mesh(1, CPU_RANKS, device="cpu")
    for name, model_name, fs, hp, flags, data in ranks_8b_cases():
        with np.load(os.path.join(io_dir, f"weights_{name}.npz")) as w:
            init = dict(w)
        model = get_model(model_name, fs, device="cpu", **hp)
        ts = create_sharded_state(model, make_optimizer("sgd", RANKS_8B_LR), mesh,
                                  init_params=init)
        out = make_sharded_train_step(ts.model, ts.optimizer, mesh, **flags)(
            shard_batch(data, mesh))
        logits = comm.all_gather_tensor(out["logits"], mesh.data_group).numpy()
        full = _flat_tree(sharded_params_to_numpy(ts.model, ts.layout, mesh))
        if rank == 0:
            np.savez(os.path.join(io_dir, f"ranks_{name}.npz"), loss=float(out["loss"]),
                     logits=logits, **full)


def start_cpu_ranks_8b(tmp, pool):
    """Start part (d)'s ranks on ``pool`` after writing each case's seeded
    weights; returns (their directory, the future of their wall seconds)."""
    from ml_function_tpu_torch.bridge import flat_params
    from ml_function_tpu_torch.models import get_model
    from ml_function_tpu_torch.parallel.launch import spawn

    io_dir = os.path.join(tmp, "cpu_ranks_8b")
    os.makedirs(io_dir)
    for name, model_name, fs, hp, _, _ in ranks_8b_cases():
        seeded = get_model(model_name, fs, device="cpu",
                           generator=torch.Generator().manual_seed(0), **hp)
        np.savez(os.path.join(io_dir, f"weights_{name}.npz"), **flat_params(seeded))

    def run() -> float:
        t = time.perf_counter()
        spawn(_cpu_rank_8b, CPU_RANKS, (io_dir,), store_dir=io_dir, threads=CPU_RANK_THREADS)
        return time.perf_counter() - t

    return io_dir, pool.submit(run)


def seq_search_part(mesh, smi: str) -> None:
    """(a) ``seq_sharded_soft_search`` at SIM's board row, called directly
    (a model group of 1 takes SIM's unsharded route), against the
    unsharded soft search's choice on the same table, stream and candidates:
    the same positions, flips counted with their score gaps."""
    from ml_function_tpu_torch.models.longseq import top_k_indices
    from ml_function_tpu_torch.parallel.longseq import seq_sharded_soft_search
    from ml_function_tpu_torch.tools.profile_scoring import sim_batch
    from ml_function_tpu_torch.tools.timing import event_ms

    b, k = SEARCH_8B
    fs, data = sim_batch(b)
    gen = torch.Generator("cuda").manual_seed(0)
    table = torch.randn((fs.total_vocab, fs.embed_dim), generator=gen, device="cuda") * 0.05
    ids = torch.as_tensor(data["seq"]["hist_long"], device="cuda")
    item = (torch.as_tensor(data["sparse"][:, fs.sparse_index("item")], device="cuda").long()
            + fs.sparse_offsets()[fs.sparse_index("item")])
    cand = table[item]
    mask = ids != 0

    def unsharded():
        rows = table[ids.long() + fs.seq_offset("hist_long")] * mask[..., None]
        scores = torch.where(mask, torch.einsum("bld,bd->bl", rows, cand), -torch.inf)
        return top_k_indices(scores, k), scores

    def sharded():
        return seq_sharded_soft_search(mesh, fs, ("hist_long",), k, table,
                                       {"hist_long": ids}, cand)

    want, scores = unsharded()
    got, red = sharded()
    other = (got != want).any(dim=1)
    gap = float(_score_gap(scores.gather(1, got), scores.gather(1, want), scores).max())
    same_mask = bool(torch.equal(red, mask.gather(1, want)))
    ms, plain_ms = event_ms(sharded, reps=5, inner=2), event_ms(unsharded, reps=5, inner=2)
    print(f"sequence-sharded search at B {b}, {ids.shape[1]} keys, top {k} (model group "
          f"of 1, NCCL): {int(other.sum())} of {b} rows choose otherwise than the "
          f"unsharded soft search (largest score gap {gap:.3e} of the row's max |score|), "
          f"masks the same: {same_mask}; {ms:.3f} ms against the unsharded search's "
          f"{plain_ms:.3f} ms (events; {smi})")
    if bool(other.any()) or not same_mask:
        fail(f"the sequence-sharded search chose otherwise in {int(other.sum())} rows")


def seq_attention_part(mesh, smi: str) -> None:
    """(b) Ring and dist attention at the flash row's keys, against a dense
    softmax over the same inputs: the output and dq, dk, dv of <out, ct>."""
    from ml_function_tpu_torch.parallel.seq_parallel import (NEG_INF,
                                                             make_seq_parallel_attention)
    from ml_function_tpu_torch.tools.timing import event_ms

    b, h, lq, lk, dh = ATTN_8B
    gen = torch.Generator("cuda").manual_seed(1)
    q = torch.randn((b, h, lq, dh), generator=gen, device="cuda")
    k, v = (torch.randn((b, h, lk, dh), generator=gen, device="cuda") for _ in range(2))
    ct = torch.randn((b, h, lq, dh), generator=gen, device="cuda")
    mask = torch.rand((b, lk), generator=gen, device="cuda") > 0.3
    mask[:, 0] = True
    mask[1, 8:] = False                 # a row with 8 valid keys
    bias = torch.where(mask, 0.0, NEG_INF)[:, None, None, :]

    def dense(q, k, v, mask=None):
        s = torch.einsum("bhqd,bhkd->bhqk", q, k) / float(np.sqrt(dh)) + bias
        return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v)

    def with_grads(fn):
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        out = fn(qq, kk, vv, mask)
        (out * ct).sum().backward()
        return [out.detach(), qq.grad, kk.grad, vv.grad]

    ref = with_grads(dense)
    dense_ms = event_ms(lambda: dense(q, k, v), reps=5, inner=2)
    for mode in ("dist", "ring"):
        attn = make_seq_parallel_attention(mesh, mode=mode)
        got = with_grads(attn)
        errs = [float((g - r).abs().max()) / float(r.abs().max()) for g, r in zip(got, ref)]
        ms = event_ms(lambda: attn(q, k, v, mask), reps=5, inner=2)
        print(f"{mode} attention at (B, H, Lq, Lk, Dh) {ATTN_8B} (model group of 1, NCCL): "
              f"output, dq, dk, dv within {', '.join(f'{e:.3e}' for e in errs)} of the dense "
              f"softmax's max (bar {ATTN_8B_BAR}); forward {ms:.3f} ms against the dense "
              f"softmax's {dense_ms:.3f} ms (events; {smi})")
        if max(errs) > ATTN_8B_BAR or not all(bool(torch.isfinite(g).all()) for g in got):
            fail(f"{mode} attention leaves the dense softmax by {errs}")


def update_gap(init, got, want):
    """(the worst leaf's |Δgot − Δwant| over its max |Δwant|, that leaf),
    Δ a parameter's change from ``init`` (in f64), each max floored at
    ``UPDATE_FLOOR`` of the largest change of any leaf."""
    delta = {k: (got[k].astype(np.float64) - init[k], want[k].astype(np.float64) - init[k])
             for k in init}
    floor = UPDATE_FLOOR * max(float(np.abs(dw).max(initial=0.0)) for _, dw in delta.values())
    gaps = {k: float(np.abs(dg - dw).max(initial=0.0))
            / max(float(np.abs(dw).max(initial=0.0)), floor, 1e-30)
            for k, (dg, dw) in delta.items()}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def pipeline_part(mesh, fs, data, drive, launches_by_path, smi: str) -> None:
    """(c) ``make_pipeline`` at one stage and 4 microbatches on AutoInt at
    phase 3's width with 4 blocks, K3 under the flag: the forward and one
    SGD step against the sequential stack's, 16 + 16 K3 launches a step."""
    from ml_function_tpu_torch.models import get_model
    from ml_function_tpu_torch.models.base import as_tensors
    from ml_function_tpu_torch.tools.timing import event_ms
    from ml_function_tpu_torch.train.metrics import bce_with_logits
    from ml_function_tpu_torch.train.optimizers import make_optimizer

    n_layers, micro = PIPE_8B["n_layers"], PIPE_8B["micro"]
    batch = as_tensors(_rows(data, BATCH), "cuda")
    runs = {}
    os.environ["ML_FUNCTION_TPU_F32_MATMUL"] = "1"
    try:
        for route in ("sequential", "pipeline"):
            model = get_model("autoint", fs, device="cuda", n_layers=n_layers,
                              generator=torch.Generator().manual_seed(0))
            opt = make_optimizer("sgd", RANKS_8B_LR).init(model)
            # the model's own forward, its block stack through its own pipeline
            # branch (every block one stage's) or block after block
            forward = ((lambda b: model.pipelined_forward(b, mesh, micro))
                       if route == "pipeline" else model)

            def step():
                opt.zero_grad(set_to_none=True)
                logits = forward(batch)[0]
                bce_with_logits(logits, batch["label"]).mean().backward()
                opt.step()
                return logits.detach()

            init = {n: p.detach().cpu().numpy().astype(np.float64)
                    for n, p in model.named_parameters()}
            logits = drive(f"autoint_{route}_8b", step)
            params = {n: p.detach().clone() for n, p in model.named_parameters()}
            # the step's time after the compared one, the first step's costs gone
            runs[route] = (logits, params, event_ms(step, reps=3, inner=1, warmup=1))
    finally:
        os.environ.pop("ML_FUNCTION_TPU_F32_MATMUL")
    (lw, pw, sw), (lg, pg, sg) = runs["sequential"], runs["pipeline"]
    ferr = float((lg - lw).abs().max()) / float(lw.abs().max())
    perr = max(float((pg[n] - pw[n]).abs().max()) / max(float(pw[n].abs().max()), 1e-30)
               for n in pw)
    uerr, uleaf = update_gap(init, {n: t.cpu().numpy() for n, t in pg.items()},
                             {n: t.cpu().numpy() for n, t in pw.items()})
    launches = launches_by_path["autoint_pipeline_8b"]
    print(f"make_pipeline on AutoInt ({n_layers} blocks, one stage, {micro} microbatches, "
          f"B {BATCH}, K3 under the flag, f32 matmuls): logits within {ferr:.3e} and every "
          f"parameter after one SGD step within {perr:.3e} of the sequential stack's (of "
          f"each one's max; bar {PIPE_8B_BAR}), every parameter's change in it within "
          f"{uerr:.3e} (of its largest, at {uleaf}; bar {UPDATE_8B_BAR}); launches a step "
          f"{launches} (sequential {launches_by_path['autoint_sequential_8b']}); a later "
          f"step {sg:.3f} ms against {sw:.3f} ms (events; {smi})")
    want = n_layers * micro
    if (ferr > PIPE_8B_BAR or perr > PIPE_8B_BAR or uerr > UPDATE_8B_BAR
            or launches != expect(field_attn_fwd=want, field_attn_bwd=want)):
        fail(f"the pipeline leaves the sequential stack by {ferr}, {perr}, {uerr} or "
             f"launched {launches}")


def ranks_8b_part(io_dir, ranks, drive, launches_by_path, smi: str) -> None:
    """(d) The CPU ranks' sequence-sharded SIM step and pipelined AutoInt
    step against the card's unsharded step on the same weights and batch:
    the loss, the logits and every parameter after it within
    ``SHARD_SCORE_BAR``, and every parameter's change in the step within
    ``UPDATE_8B_BAR`` of its largest (f32 matmuls on both)."""
    from ml_function_tpu_torch.bridge import flat_params, params_from_numpy
    from ml_function_tpu_torch.models import get_model
    from ml_function_tpu_torch.train.loop import make_train_step
    from ml_function_tpu_torch.train.optimizers import make_optimizer

    print(f"CPU gloo ranks (1, {CPU_RANKS}) of item 8b: both steps in "
          f"{ranks.result():.1f} s, beside parts (a), (b) and phase 25 ({smi})")
    per_step = {"sim_seq_shard": expect(field_attn_fwd=1, field_attn_bwd=1),
                "autoint_pp2": expect(field_attn_fwd=4, field_attn_bwd=4)}
    os.environ["ML_FUNCTION_TPU_F32_MATMUL"] = "1"
    try:
        for name, model_name, fs, hp, flags, data in ranks_8b_cases():
            with np.load(os.path.join(io_dir, f"weights_{name}.npz")) as w:
                init = dict(w)
            with np.load(os.path.join(io_dir, f"ranks_{name}.npz")) as r:
                cpu = dict(r)
            model = get_model(model_name, fs, device="cuda", **hp)
            params_from_numpy(model, init)
            step = make_train_step(model, make_optimizer("sgd", RANKS_8B_LR).init(model))
            out = drive(f"ranks_8b_{name}_card", lambda: step(data))
            mine = flat_params(model)
            loss_gap = abs(float(out["loss"]) - float(cpu["loss"]))
            logit_gap = float(np.abs(out["logits"].cpu().numpy() - cpu["logits"]).max())
            param_gap = max(float(np.abs(mine[k] - cpu[k]).max()) for k in mine)
            same_keys = sorted(mine) == sorted(k for k in cpu if k.startswith("params/"))
            uerr, uleaf = (update_gap({k: init[k].astype(np.float64) for k in mine}, cpu, mine)
                           if same_keys else (float("inf"), None))
            launches = launches_by_path[f"ranks_8b_{name}_card"]
            print(f"{name} ({flags}) on two CPU ranks against the card's unsharded step: "
                  f"loss {float(cpu['loss']):.6f} against {float(out['loss']):.6f} (gap "
                  f"{loss_gap:.3e}), logits within {logit_gap:.3e}, every parameter after "
                  f"one SGD step within {param_gap:.3e} (bar {SHARD_SCORE_BAR}), every "
                  f"parameter's change in it within {uerr:.3e} of its largest (at {uleaf}; "
                  f"bar {UPDATE_8B_BAR}); the card's launches {launches} ({smi})")
            if (not same_keys or max(loss_gap, logit_gap, param_gap) > SHARD_SCORE_BAR
                    or uerr > UPDATE_8B_BAR or launches != per_step[name]):
                fail(f"{name}: the CPU ranks' step leaves the card's by {loss_gap}, "
                     f"{logit_gap}, {param_gap}, {uerr} (keys {same_keys}, launches "
                     f"{launches})")
    finally:
        os.environ.pop("ML_FUNCTION_TPU_F32_MATMUL")


def item_8b_phase(drive, launches_by_path, smi: str, then=None) -> None:
    """Phase 24: the sequence-sharded search, ring and dist attention and the
    pipeline on the card over NCCL at world size 1, and two CPU gloo ranks
    that split SIM's stream and AutoInt's blocks (started first, they train
    beside parts (a), (b) and ``then``, phase 25; part (c) runs last)."""
    from concurrent.futures import ThreadPoolExecutor

    from ml_function_tpu_torch.features.schema import criteo_feature_set
    from ml_function_tpu_torch.features.synthetic import make_criteo_like
    from ml_function_tpu_torch.ops.kernels import _build
    from ml_function_tpu_torch.parallel.launch import init_single
    from ml_function_tpu_torch.parallel.mesh import make_mesh

    with tempfile.TemporaryDirectory(dir=_build.BUILD) as tmp, ThreadPoolExecutor(1) as pool:
        t = time.perf_counter()
        io_dir, ranks = start_cpu_ranks_8b(tmp, pool)
        init_single(tmp)
        mesh = make_mesh(device="cuda")
        try:
            seq_search_part(mesh, smi)
            print(f"wall time of phase 24 (a): {time.perf_counter() - t:.1f} s")
            t = time.perf_counter()
            seq_attention_part(mesh, smi)
            print(f"wall time of phase 24 (b): {time.perf_counter() - t:.1f} s")
            if then is not None:
                then()
            t = time.perf_counter()
            ranks_8b_part(io_dir, ranks, drive, launches_by_path, smi)
            print(f"wall time of phase 24 (d) after the ranks: {time.perf_counter() - t:.1f} s")
            # last, so that the kernels line's K3 launches are the pipeline's
            t = time.perf_counter()
            fs = criteo_feature_set([100_000] * 26, n_dense=13, embed_dim=8)
            _, data = make_criteo_like(n_rows=BATCH, vocab_size=100_000, seed=0)
            pipeline_part(mesh, fs, data, drive, launches_by_path, smi)
            print(f"wall time of phase 24 (c): {time.perf_counter() - t:.1f} s")
        finally:
            torch.distributed.destroy_process_group()



# Graph pretraining on the card (phase 25): a planted-partition graph of the
# JAX bench's walk-engine size (bench.py:672: 20,000 nodes, 200,000 edges,
# taken undirected) with 4 communities, 9 edges in 10 inside one.
GRAPH_25 = dict(n_nodes=20_000, n_edges=200_000, communities=4, p_intra=0.9, seed=0)
DEEPWALK_25 = dict(num_walks=2, walk_length=10, window=2, dim=64)
# LINE's loss is a batch mean, so its learning rate is a sample's times B:
# 400 at B 4096 is about 0.1 a sample. At the paper's 0.025 a sample the
# 1,500 steps (about 300 edge samples a node) left the communities mixed
# (separation 0.06 to 0.19 in CPU runs of this graph; 0.30 at this setting)
LINE_25 = dict(dim=64, order="second", steps=1500, batch_size=4096, learning_rate=400.0)
SDNE_25 = dict(hidden=(256, 128), epochs=1)
# the JAX tests' community-separation bars (tests/test_embedding_pretrain.py:65-77)
SEPARATION_BARS = {"deepwalk": 0.3, "line": 0.2}
W2V_PARITY_STEPS = 20
W2V_PARITY_BAR = 1e-4      # Adam: the card's and the CPU's summation orders differ


def planted_graph(n_nodes, n_edges, communities, p_intra, seed):
    """(CSRGraph, each node id's community): edges from a uniform source to
    a node of its community with probability ``p_intra``, else to any node."""
    from ml_function_tpu_torch.embedding_pretrain import from_edges
    rng = np.random.default_rng(seed)
    comm = np.arange(n_nodes) % communities
    src = rng.integers(0, n_nodes, n_edges)
    same = rng.integers(0, n_nodes // communities, n_edges) * communities + comm[src]
    dst = np.where(rng.random(n_edges) < p_intra, same, rng.integers(0, n_nodes, n_edges))
    g = from_edges([(str(s), str(d), 1.0) for s, d in zip(src.tolist(), dst.tolist())],
                   undirected=True)
    return g, comm[np.array([int(name) for name in g.node_names])]


def separation(emb, labels, per: int = 1000, seed: int = 0) -> float:
    """The JAX tests' ``intra_inter_ratio`` on 1,000 nodes of each of
    communities 0 and 1: the two mean intra-community cosines minus twice
    the mean cosine across (on the card)."""
    rng = np.random.default_rng(seed)
    pick = np.concatenate([rng.choice(np.nonzero(labels == c)[0], per, replace=False)
                           for c in (0, 1)])
    x = torch.as_tensor(emb[pick], device="cuda")
    x = x / (x.norm(dim=1, keepdim=True) + 1e-9)
    sim = x @ x.T
    k = per
    intra = ((sim[:k, :k].sum() - k) / (k * k - k)
             + (sim[k:, k:].sum() - k) / (k * k - k))
    return float(intra - sim[:k, k:].mean() * 2)


def _timed(fn):
    """(fn's result, its CUDA-event ms)."""
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def graph_phase(drive, launches_by_path, smi: str) -> None:
    """Phase 25: DeepWalk (the port's native walks, then word2vec), LINE and
    SDNE on the card for a bounded number of steps, the first two held to
    the JAX tests' community-separation bars; word2vec from the same tables
    and draws on the card and on the CPU."""
    from ml_function_tpu_torch.embedding_pretrain.line import LineConfig, train_line
    from ml_function_tpu_torch.embedding_pretrain.native_walks import deepwalk_walks_native
    from ml_function_tpu_torch.embedding_pretrain.sdne import SDNEConfig, train_sdne
    from ml_function_tpu_torch.embedding_pretrain.walks import walks_to_skipgram_pairs
    from ml_function_tpu_torch.embedding_pretrain.word2vec import (Word2VecConfig,
                                                                    train_word2vec)

    t = time.perf_counter()
    g, labels = planted_graph(**GRAPH_25)
    print(f"planted-partition graph: {g.num_nodes} nodes, {g.num_edges} directed edges, "
          f"{GRAPH_25['communities']} communities in {time.perf_counter() - t:.1f} s ({smi})")
    dw = DEEPWALK_25
    deepwalk_walks_native(g, 1, 2, seed=1)               # the build, and a warm call
    t = time.perf_counter()
    walks = deepwalk_walks_native(g, dw["num_walks"], dw["walk_length"], seed=0)
    walk_s = time.perf_counter() - t
    t = time.perf_counter()
    pairs = walks_to_skipgram_pairs(walks, dw["window"], seed=0)
    pair_s = time.perf_counter() - t
    cfg = Word2VecConfig(dim=dw["dim"], seed=0)
    per_epoch = len(pairs) // cfg.batch_size
    steps = per_epoch * max(cfg.epochs, -(-cfg.min_steps // per_epoch))
    emb, w2v_ms = _timed(lambda: drive("deepwalk_word2vec", lambda: train_word2vec(
        pairs, g.num_nodes, cfg, device="cuda")))
    sep = {"deepwalk": separation(emb, labels)}
    print(f"DeepWalk: native walks {walks.shape} at {walks.size / walk_s:.4g} steps/s "
          f"({walk_s:.3f} s, {os.cpu_count()} threads), {len(pairs)} skip-gram pairs in "
          f"{pair_s:.2f} s (host), word2vec {steps} Adam steps at B {cfg.batch_size} in "
          f"{w2v_ms:.1f} ms, {w2v_ms / steps:.4f} ms a step (events); separation "
          f"{sep['deepwalk']:.4f} (bar {SEPARATION_BARS['deepwalk']}); launches "
          f"{launches_by_path['deepwalk_word2vec']} ({smi})")

    lcfg = LineConfig(seed=0, **LINE_25)
    emb, line_ms = _timed(lambda: train_line(g, lcfg, device="cuda"))
    sep["line"] = separation(emb, labels)
    print(f"LINE ({lcfg.order} order): {lcfg.steps} SGD steps at B {lcfg.batch_size} in "
          f"{line_ms:.1f} ms, {line_ms / lcfg.steps:.4f} ms a step (events, the host's "
          f"alias draws included); separation {sep['line']:.4f} (bar "
          f"{SEPARATION_BARS['line']}) ({smi})")

    scfg = SDNEConfig(seed=0, **SDNE_25)
    emb, sdne_ms = _timed(lambda: train_sdne(g, scfg, device="cuda"))
    sdne_steps = scfg.epochs * (g.num_nodes // scfg.batch_size)
    print(f"SDNE {scfg.hidden}: {sdne_steps} Adam steps at B {scfg.batch_size} over "
          f"{g.num_nodes}-wide adjacency rows and the final encoding in {sdne_ms:.1f} ms, "
          f"{sdne_ms / sdne_steps:.4f} ms a step (events, the host's rows included); "
          f"embeddings {emb.shape}, finite: {bool(np.isfinite(emb).all())}, separation "
          f"{separation(emb, labels):.4f} ({smi})")

    # word2vec from bridged tables and replayed draws, card against CPU
    rng = np.random.default_rng(7)
    init = ((rng.normal(size=(g.num_nodes, 64)) * 0.5 / 64).astype(np.float32),
            np.zeros((g.num_nodes, 64), np.float32))
    slots = [rng.integers(0, 1 << 20, (cfg.batch_size, cfg.negatives))
             for _ in range(W2V_PARITY_STEPS)]
    sub = pairs[:W2V_PARITY_STEPS * cfg.batch_size]
    pcfg = Word2VecConfig(dim=64, seed=0, min_steps=0)
    tables = {}
    for dev in ("cuda", "cpu"):
        replay = iter(slots)
        tables[dev] = train_word2vec(sub, g.num_nodes, pcfg, init=init,
                                     sampler=lambda b, k: next(replay), device=dev)
    gap = float(np.abs(tables["cuda"] - tables["cpu"]).max())
    print(f"word2vec {W2V_PARITY_STEPS} Adam steps from the same tables and draws: the "
          f"card's table within {gap:.3e} of the CPU's (bar {W2V_PARITY_BAR}; {smi})")
    if (any(sep[k] <= SEPARATION_BARS[k] for k in SEPARATION_BARS) or gap > W2V_PARITY_BAR
            or not np.isfinite(emb).all()):
        fail(f"graph pretraining: separation {sep}, word2vec card against CPU {gap}")


# The chained train step (phase 26): fit(steps_per_call=K) on the four
# paths of the slice, each from the same weights as two unchained fits.
# K 8 (a graph of DIEN's 8 steps is 61 ms of device time). The parity fits
# take 4 full groups and a padded tail batch, the rate fits 10 and the tail:
# an eager group, a captured one (replayed), eight replays in fit's timer,
# and one single step. DIEN's rows are one group's drawn and repeated
# (drawing them all took 25 s)
CHAIN_K = 8
CHAIN_GROUPS = 10
CHAIN_PARITY_GROUPS = 4
# The parity fits run under torch.use_deterministic_algorithms, where the
# embedding gradient's index_add_ sums in a fixed order: a replay runs the
# same kernels with the same arguments as the eager steps, so the chained
# fit must give the unchained fits' bits. In the default mode index_add_'s
# atomics reorder its sums from run to run, so the rate fits, in that mode,
# hold the train logloss and AUC: CHAIN_DEFAULT_FITS unchained fits, then
# the chained one, whose metrics must lie within CHAIN_DEFAULT_FACTOR times
# the larger of the unchained fits' largest pair gap in this run and
# CHAIN_PAIR_GAP, the largest gap between two fits of the same function
# seen on an H100 (calibration runs of 6 unchained fits a path, 15 pairs,
# and of 16 unchained and 16 chained fits a path, ``--chain-noise 16``;
# PERF.md, the chained train step): DIEN's index_add_ moves its logloss by
# up to 4.3e-5 and its AUC by 1.4e-4; xDeepFM's metrics moved by one f32
# step (2^-24 at these values) in both calibrations, but its AUC by six
# (3.576e-7) between a chained and an unchained fit in one run of this
# script on another H100, whose parity fits had the same bits: its binned
# AUC moves in steps when an example crosses a bin. AutoInt's, whose
# parameters moved by 2.8e-8 of a tensor's largest, are given one step;
# SIM's fits were bitwise alike, so its bar is bitwise while its unchained
# fits agree. The parameters' gaps are printed beside the metrics
F32_STEP = 2.0 ** -24      # one f32 step of a value in [0.5, 1)
CHAIN_DEFAULT_FITS = 2
CHAIN_DEFAULT_FACTOR = 4.0
CHAIN_PAIR_GAP = {"xdeepfm": {"logloss": F32_STEP, "auc": 6 * F32_STEP},
                  "autoint": {"logloss": F32_STEP, "auc": F32_STEP},
                  "dien": {"logloss": 4.292e-5, "auc": 1.373e-4},
                  "sim_flash": {"logloss": 0.0, "auc": 0.0}}
# paths whose counts a graph replay moved (``ops/kernels/launches.py``), not
# the wrappers: phase 26's chained fits; the result line takes no count
# from them
REPLAYED_PATHS = set()
# path → (kernels a train step launches, and how many of each)
CHAINED_PATHS = {
    "xdeepfm": {"cin_fwd": 2, "cin_bwd": 2},
    "autoint": {"field_attn_fwd": 2, "field_attn_bwd": 2},
    "dien": {"gru_fwd": 2, "gru_bwd": 2, "merge_scatter": 2},
    "sim_flash": {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1, "gru_fwd": 2,
                  "gru_bwd": 2, "merge_scatter": 3},
}
# each kernel's device functions, as the profiler names them (demangled)
# and as a graph's description does (mangled: a length before the name)
_NAME = r"(?<![A-Za-z_])"
KERNEL_FUNCTIONS = {
    "cin_fwd": _NAME + r"cin_fwd(_wide)?_kernel", "cin_bwd": _NAME + r"cin_bwd_(rows|dw)",
    "field_attn_fwd": _NAME + "field_attn_fwd", "field_attn_bwd": _NAME + "field_attn_bwd",
    "gru_fwd": _NAME + "gru_fwd", "gru_bwd": _NAME + "gru_bwd",
    "merge_scatter": _NAME + "chunk_kernel", "flash_fwd": _NAME + "flash_fwd_kernel",
    "flash_bwd_dq": _NAME + "flash_bwd_dq_kernel",
    "flash_bwd_dkv": _NAME + "flash_bwd_dkv_kernel"}


_CUDA_GRAPH = torch.cuda.CUDAGraph    # the class, whatever a block swaps in


def kept_graph():
    """A CUDA graph that keeps its captured description for ``debug_dump``."""
    graph = _CUDA_GRAPH(keep_graph=True)
    graph.enable_debug_mode()
    return graph


def graph_kernels(graph) -> list:
    """The description (``cudaGraphDebugDotPrint``) of each kernel node of a
    graph made by ``kept_graph``: every kernel a replay launches, once."""
    from ml_function_tpu_torch.ops.kernels import _build

    with tempfile.TemporaryDirectory(dir=_build.BUILD) as tmp:
        path = os.path.join(tmp, "graph.dot")
        graph.debug_dump(path)
        if not os.path.exists(path):
            fail("a kept CUDA graph wrote no description (debug_dump)")
        with open(path) as f:
            text = f.read()
    nodes = [r for r in re.split(r'\n(?=\s*"graph_)', text) if "KERNEL" in r]
    if not nodes:
        fail(f"a CUDA graph's description holds no kernel node: {text[:400]!r}")
    return nodes


def chained_model(path: str):
    """(model, data, batch size, route) of one chained path at full width:
    xDeepFM and AutoInt at the Criteo width of phases 4-7, DIEN at the
    headline shape of phase 10 and SIM at the flash-ESU shape of phase 13;
    ``route`` is the block inside which it runs on its kernels."""
    from ml_function_tpu_torch.features.schema import criteo_feature_set
    from ml_function_tpu_torch.features.synthetic import make_behavior_data, make_criteo_like
    from ml_function_tpu_torch.models import get_model
    from ml_function_tpu_torch.tools.profile_scoring import SIM_SHAPES, sim_batch

    gen = torch.Generator().manual_seed(0)
    if path == "sim_flash":
        b, hp = SIM_SHAPES["flash"]
        fs, data = sim_batch(CHAIN_GROUPS * CHAIN_K * b + b // 2)
        model = get_model("sim", fs, generator=gen, hidden=(200, 80), **hp)
        return model, data, b, lambda: dien_route(model.dien, kernel=True)
    n_rows = CHAIN_GROUPS * CHAIN_K * BATCH + BATCH // 2
    if path == "dien":
        fs, data = make_behavior_data(n_rows=CHAIN_K * BATCH, **DIEN_DATA)
        data = _rows(data, np.arange(n_rows) % (CHAIN_K * BATCH))
        model = get_model("dien", fs, generator=gen)
        return model, data, BATCH, lambda: dien_route(model, kernel=True)
    fs = criteo_feature_set([100_000] * 26, n_dense=13, embed_dim=8)
    _, data = make_criteo_like(n_rows=n_rows, vocab_size=100_000, seed=0)
    hp = ({"cin_hidden": (128, 128), "hidden": (256, 128)} if path == "xdeepfm"
          else {"n_layers": 2, "num_heads": 2, "head_dim": 16})
    model = get_model(path, fs, generator=gen, **hp)
    return model, data, BATCH, contextlib.nullcontext


def chained_fit(path: str, tag: str, model, data, b: int, route, drive, launches_by_path,
                **fit_kw):
    """``fit`` over ``data`` (one epoch at batch ``b``, seed 0) on the path's
    route as path ``{path}_{tag}``: its result, its parameters and the
    device's time of each graph replay it made and of the gap after each
    but the last (CUDA events around every replay); fails unless each
    kernel launched its count a step and a chained fit replayed one graph a
    group after the first."""
    from ml_function_tpu_torch.train.loop import fit

    marks = []
    real_replay = torch.cuda.CUDAGraph.replay

    def timed(graph):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        real_replay(graph)
        end.record()
        marks.append((start, end))

    with route(), swapped(torch.cuda.CUDAGraph, "replay", timed):
        _, res = drive(f"{path}_{tag}", lambda: fit(model, data, epochs=1, batch_size=b,
                                                    seed=0, **fit_kw))
    torch.cuda.synchronize()
    steps = -(-len(data["label"]) // b)
    want = expect(**{k: n * steps for k, n in CHAINED_PATHS[path].items()})
    if res.steps != steps or launches_by_path[f"{path}_{tag}"] != want:
        fail(f"{path} {tag} fit took {res.steps} steps and launched "
             f"{launches_by_path[f'{path}_{tag}']}; expected {steps} and {want}")
    groups = steps // fit_kw["steps_per_call"]
    if marks:
        REPLAYED_PATHS.add(f"{path}_{tag}")
    if fit_kw["steps_per_call"] > 1 and len(marks) != groups - 1:
        fail(f"{path} {tag} fit replayed {len(marks)} graphs for {groups} groups; "
             f"expected one a group after the first")
    timeline = ([s.elapsed_time(e) for s, e in marks],
                [marks[i][1].elapsed_time(marks[i + 1][0]) for i in range(len(marks) - 1)])
    return res, [p.detach().clone() for p in model.parameters()], timeline


def chained_path(path: str, drive, launches_by_path, smi: str) -> dict:
    """One path of phase 26. Parity: two unchained fits and a chained one
    from the same weights over CHAIN_PARITY_GROUPS groups and a tail batch,
    with Adam, under ``torch.use_deterministic_algorithms``: one graph
    replay a full group after the first, the same launches, and the same
    bits in the train metrics and every parameter. Rates, in the default
    mode: fit's examples/s over CHAIN_GROUPS groups, CHAIN_DEFAULT_FITS
    unchained fits (their median) and a chained one, whose train logloss and
    AUC must lie within the unchained fits' bar (CHAIN_PAIR_GAP); then the
    captured graph's kernel nodes (each kernel's device functions in it
    must be the count a replay adds to its counter times the functions a
    launch runs in the same 8 steps one at a time, by the profiler); the
    profiler over replays of a chained step and over the same steps one at
    a time (each kernel seen in both; each kernel's device time a step in
    both; the card's busy share of both) and a group's host time: its rows, the chained call
    (staging and the replay's launch), the wait. Returns the rates."""
    from ml_function_tpu_torch.models.base import as_tensors
    from ml_function_tpu_torch.ops.kernels import launches
    from ml_function_tpu_torch.tools.timing import event_ms, profile_device
    from ml_function_tpu_torch.train.loop import (iter_batches, iter_groups,
                                                  make_chained_train_step, make_train_step,
                                                  stack_batches)
    from ml_function_tpu_torch.train.optimizers import make_optimizer

    t = time.perf_counter()
    model, data, b, route = chained_model(path)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    per_step = CHAINED_PATHS[path]
    parity = _rows(data, CHAIN_PARITY_GROUPS * CHAIN_K * b + b // 2)
    runs = {}
    torch.use_deterministic_algorithms(True)
    try:
        for tag, spc in (("a", 1), ("b", 1), ("chained", CHAIN_K)):
            model.load_state_dict(init)
            runs[tag] = chained_fit(path, f"parity_{tag}", model, parity, b, route, drive,
                                    launches_by_path, learning_rate=1e-3, steps_per_call=spc)
    finally:
        torch.use_deterministic_algorithms(False)
    (ra, pa, _), (rb, pb, _), (rc, pc, _) = runs["a"], runs["b"], runs["chained"]
    for what, x, y in (("the unchained pair", (rb, pb), (ra, pa)),
                       ("the chained fit", (rc, pc), (ra, pa))):
        same = x[0].train_metrics == y[0].train_metrics and all(
            torch.equal(p, q) for p, q in zip(x[1], y[1]))
        if not same:
            gap = max(float((p - q).abs().max()) for p, q in zip(x[1], y[1]))
            fail(f"{path}: {what} under deterministic algorithms is not the unchained "
                 f"fit's bits: train {x[0].train_metrics} against {y[0].train_metrics}, "
                 f"largest parameter gap {gap}")
    print(f"{path} chained fit against the unchained under deterministic algorithms "
          f"({CHAIN_PARITY_GROUPS} groups and a tail, Adam): the same bits in the train "
          f"metrics {rc.train_metrics} and every parameter")
    # the rate fits, in the default mode: CHAIN_DEFAULT_FITS unchained, then
    # the chained one
    fits = [(f"rate_unchained_{i}", 1) for i in range(CHAIN_DEFAULT_FITS)]
    res, params, rates_u = {}, {}, []
    for tag, spc in fits + [("rate_chained", CHAIN_K)]:
        model.load_state_dict(init)
        res[tag], params[tag], timeline = chained_fit(
            path, tag, model, data, b, route, drive, launches_by_path,
            learning_rate=1e-3, steps_per_call=spc)
        if spc == 1:
            rates_u.append(res[tag].examples_per_sec)
    rates = {"chained": res["rate_chained"].examples_per_sec,
             "unchained": statistics.median(rates_u)}
    replay_dev, replay_gaps = timeline
    unchained = [tag for tag, _ in fits]
    pairs = [(x, y) for i, x in enumerate(unchained) for y in unchained[i + 1:]]

    def drift(x, y):    # parameters: the largest gap over a tensor's largest
        return max(float((p - q).abs().max() / q.abs().max().clamp_min(1e-30))
                   for p, q in zip(params[x], params[y]))

    readings = {}
    for m in ("logloss", "auc"):
        got = {tag: res[tag].train_metrics[m] for tag in unchained + ["rate_chained"]}
        pair = max(abs(got[x] - got[y]) for x, y in pairs)
        gap = max(abs(got["rate_chained"] - got[x]) for x in unchained)
        bar = CHAIN_DEFAULT_FACTOR * max(pair, CHAIN_PAIR_GAP[path][m])
        readings[m] = {"values": got, "pair_gap": pair, "chained_gap": gap, "bar": bar}
        print(f"{path} rate fits in the default mode (Adam, {CHAIN_GROUPS} groups and a "
              f"tail): train {m} {got}; the unchained fits' largest pair gap {pair:.3e}, "
              f"the chained fit's largest gap to them {gap:.3e}, bar {bar:.3e}")
        if gap > bar:
            fail(f"{path}: the chained fit's train {m} ends {gap:.3e} from the unchained "
                 f"fits', past {CHAIN_DEFAULT_FACTOR} x max({pair:.3e}, "
                 f"{CHAIN_PAIR_GAP[path][m]:.3e})")
    drift_c = max(drift("rate_chained", x) for x in unchained)
    drift_u = max(drift(x, y) for x, y in pairs)
    print(f"{path} rate fits' parameters: the chained fit's end within {drift_c:.3e} of a "
          f"tensor's largest of the unchained fits', the unchained fits' within "
          f"{drift_u:.3e} of each other; the chained fit's replays "
          f"{[round(x, 3) for x in replay_dev]} ms on the card, the card idle "
          f"{[round(x, 3) for x in replay_gaps]} ms between them")

    # the profiler over replays, and over the same steps one at a time
    model.load_state_dict(init)
    batches = list(iter_batches(data, b))[:2 * CHAIN_K]
    groups = [stack_batches(batches[i:i + CHAIN_K]) for i in (0, CHAIN_K)]
    with route():
        chained = make_chained_train_step(model, make_optimizer("adam", 1e-3).init(model),
                                          CHAIN_K)
        chained(groups[0])
        with swapped(torch.cuda, "CUDAGraph", kept_graph):
            chained(groups[1])
        nodes = graph_kernels(chained.graph)
        per_replay = {attr[:-len("_launches")]: n for (_, attr, name), n
                      in chained.launches.items() if name is None}
        if per_replay != {k: n * CHAIN_K for k, n in per_step.items()}:
            fail(f"{path}: a replay launches {per_replay}; expected {CHAIN_K} x {per_step}")
        one = make_train_step(model, make_optimizer("adam", 1e-3).init(model))
        on_card = [as_tensors(x, torch.device("cuda")) for x in batches[:CHAIN_K]]

        def ran(seen, k):    # a kernel's device functions in a trace
            return sum(n for f, n in seen.items() if re.search(KERNEL_FUNCTIONS[k], f))

        # What a replay launches, counted exactly: each kernel node of the
        # captured graph, from its description. A wrapper's launch runs one
        # or more device functions (CIN's backward two: its rows and dW
        # functions), read from the profiler over the 8 steps one at a time,
        # whose wrappers count the warm call and the profiled one; the
        # graph must hold that many for each launch the replay adds to the
        # counters. The profiler must also see each kernel run inside two
        # replays, never more often than the graph holds it: a trace has
        # missed a record or two of a kernel after the earlier phases (2 of
        # cin_fwd's 16 in the 8 steps in one run), so its counts are printed
        # and not held to equality
        functions = {k: sum(1 for node in nodes if re.search(KERNEL_FUNCTIONS[k], node))
                     for k in per_step}
        before = launches.snapshot()
        by_kernel_1, busy_1, window_1, seen_1 = profile_device(
            lambda: [one(x) for x in on_card], 1, counts=True)
        wrapped = {attr[:-len("_launches")]: n / 2 for (_, attr, name), n
                   in launches.since(before).items() if name is None}
        by_kernel, busy, window, seen = profile_device(lambda: chained(groups[1]), 2,
                                                       counts=True)
        device_launches = {}
        for k in per_step:
            d = {"steps": ran(seen_1, k), "wrapper": wrapped.get(k, 0),
                 "graph": functions[k], "replay": ran(seen, k) / 2}
            d["each"] = round(d["steps"] / d["wrapper"]) if d["wrapper"] else 0
            device_launches[k] = d
            if (d["each"] < 1 or d["graph"] != per_replay[k] * d["each"]
                    or not 0 < d["steps"] <= d["wrapper"] * d["each"]
                    or not 0 < d["replay"] <= d["graph"]):
                fail(f"{path}: {k}'s {d['wrapper']:g} wrapper launches in {CHAIN_K} steps "
                     f"one at a time ran {d['steps']} device functions (the profiler); "
                     f"the captured graph holds {d['graph']} for the {per_replay[k]} "
                     f"launches a replay adds to its counter, and a replay ran "
                     f"{d['replay']:g} (the profiler)")
        print(f"{path} launches a replay: " + ", ".join(
            f"{k} {d['graph']} device functions in the graph for {per_replay[k]} launches "
            f"({d['each']} a launch; the profiler saw {d['replay']:g} a replay, and "
            f"{d['steps']} in {CHAIN_K} steps one at a time through {d['wrapper']:g} "
            f"wrapper launches)" for k, d in device_launches.items()))
        # each kernel's device ms a step, inside a replay and one step at a time
        kernel_ms = {k: [sum(ms for n, ms in got.items() if re.search(KERNEL_FUNCTIONS[k], n))
                         / CHAIN_K for got in (by_kernel, by_kernel_1)] for k in per_step}
        print(f"{path} each kernel's device ms a step (the profiler), inside a replay and "
              f"one step at a time: " + ", ".join(f"{k} {a:.4f} and {b:.4f}"
                                                  for k, (a, b) in kernel_ms.items()))
        # where a group's host time goes, as fit spends it (without its
        # prefetch thread): the group's rows (iter_groups), the chained call
        # (the staging copies and the replay's launch), the wait for the
        # card; and a replay's launch alone
        it = iter_groups(data, b, CHAIN_K, shuffle=True, seed=1)
        host, launch = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            _, group = next(it)
            t1 = time.perf_counter()
            chained(group)
            t2 = time.perf_counter()
            torch.cuda.synchronize()
            host.append((t1 - t0, t2 - t1, time.perf_counter() - t2))
            t0 = time.perf_counter()
            chained.graph.replay()
            launch.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
        replay_ms = event_ms(chained.graph.replay, reps=3, inner=1, warmup=1)
    host_ms = [1e3 * statistics.median(h[i] for h in host) for i in range(3)]
    launch_host_ms = 1e3 * statistics.median(launch)
    print(f"{path} a group's host time (median of 3, ms): its rows {host_ms[0]:.3f}, the "
          f"chained call {host_ms[1]:.3f} (of it the replay's launch {launch_host_ms:.3f}), "
          f"then the card {host_ms[2]:.3f}; a replay alone by events {replay_ms:.3f} ms "
          f"({replay_ms / CHAIN_K:.3f} ms a step)")
    del chained, one
    out = {"chained": rates["chained"], "unchained": rates["unchained"],
           "busy_chained": busy / window, "busy_unchained": busy_1 / window_1,
           "ms_chained": window / CHAIN_K, "ms_unchained": window_1 / CHAIN_K,
           "replay_ms_a_step": replay_ms / CHAIN_K, "host_ms_a_group": host_ms,
           "launch_ms": launch_host_ms, "replays_ms": replay_dev, "replay_gaps_ms": replay_gaps,
           "default_mode": readings, "drift_chained": drift_c, "drift_unchained": drift_u,
           "kernel_ms_a_step": kernel_ms, "device_launches_a_replay": device_launches}
    print(f"{path} chained fit (K {CHAIN_K}, B {b}, Adam, {CHAIN_GROUPS} groups), {smi}: "
          f"{rates['chained']:.1f} examples/s chained against {rates['unchained']:.1f} "
          f"unchained (fit's host clock); profiled, a group's "
          f"replay keeps the card busy {busy:.3f} ms of a {window:.3f} ms window "
          f"({100 * busy / window:.1f}%), the same {CHAIN_K} steps one at a time "
          f"{busy_1:.3f} ms of {window_1:.3f} ms ({100 * busy_1 / window_1:.1f}%); "
          f"kernels inside the replay: {sorted(per_step)}; {time.perf_counter() - t:.1f} s")
    return out


def chained_phase(drive, launches_by_path, smi: str) -> None:
    """Phase 26: the chained train step on xDeepFM, AutoInt, DIEN and SIM's
    flash ESU at full width (``chained_path``)."""
    rates = {path: chained_path(path, drive, launches_by_path, smi)
             for path in CHAINED_PATHS}
    print("chained fit rates: " + json.dumps(rates))


def card_settings() -> None:
    """f32 products without TF32; AutoInt's attention takes the
    field-attention kernel only with the reference's opt-in switch, read at
    call time."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["ML_FUNCTION_TPU_FIELD_ATTN"] = "1"


def make_drive(launches_by_path: dict, instances_by_path: dict):
    """``drive(path, fn)``: runs one main path with every kernel's count at
    0 and keeps the counts it ends with (and the CIN and (AU)GRU instances
    it launched) under ``path``."""
    from ml_function_tpu_torch.ops.kernels import cin as cin_mod
    from ml_function_tpu_torch.ops.kernels import embedding_grad as eg_mod
    from ml_function_tpu_torch.ops.kernels import field_attention as fa_mod
    from ml_function_tpu_torch.ops.kernels import flash_attention as fl_mod
    from ml_function_tpu_torch.ops.kernels import gru as gru_mod

    modules = {"cin_fwd": cin_mod, "cin_bwd": cin_mod, "field_attn_fwd": fa_mod,
               "field_attn_bwd": fa_mod, "gru_fwd": gru_mod, "gru_bwd": gru_mod,
               "merge_scatter": eg_mod, "flash_fwd": fl_mod, "flash_bwd_dq": fl_mod,
               "flash_bwd_dkv": fl_mod}
    counters = {name: (modules[name], f"{name}_launches") for name in KERNELS}

    def drive(path, fn):
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        cin_mod.instance_launches.clear()
        gru_mod.instance_launches.clear()
        out = fn()
        launches_by_path[path] = {name: getattr(mod, attr)
                                  for name, (mod, attr) in counters.items()}
        instances_by_path[path] = {**cin_mod.instance_launches,
                                   **gru_mod.instance_launches}
        return out

    return drive


def chain_noise(n_fits: int) -> int:
    """The calibration of CHAIN_PAIR_GAP, run as ``python3 chip_smoke.py
    --chain-noise N``: on each chained path, N unchained and N chained rate
    fits of phase 26 (the default mode, Adam 1e-3, from the same weights,
    the two kinds taken in turn), and one JSON line a path with each fit's
    train logloss and AUC and the largest gap between two unchained fits,
    between two chained fits and between a chained and an unchained one."""
    from ml_function_tpu_torch.ops.kernels import _build

    if not torch.cuda.is_available():
        fail("no CUDA device")
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    print(smi)
    card_settings()
    _build.build_all()
    launches_by_path = {}
    drive = make_drive(launches_by_path, {})
    for path in CHAINED_PATHS:
        t = time.perf_counter()
        model, data, b, route = chained_model(path)
        init = {k: v.detach().clone() for k, v in model.state_dict().items()}
        got = {"unchained": [], "chained": []}
        for _ in range(n_fits):
            for kind, spc in (("unchained", 1), ("chained", CHAIN_K)):
                model.load_state_dict(init)
                res, _, _ = chained_fit(path, f"noise_{kind}", model, data, b, route, drive,
                                        launches_by_path, learning_rate=1e-3,
                                        steps_per_call=spc)
                got[kind].append({m: res.train_metrics[m] for m in ("logloss", "auc")})
        gaps = {}
        for m in ("logloss", "auc"):
            u = [r[m] for r in got["unchained"]]
            c = [r[m] for r in got["chained"]]
            gaps[m] = {"unchained_pairs": max(abs(x - y) for x in u for y in u),
                       "chained_pairs": max(abs(x - y) for x in c for y in c),
                       "chained_to_unchained": max(abs(x - y) for x in c for y in u)}
        print(json.dumps({"path": path, "fits": n_fits, "gaps": gaps, "metrics": got,
                          "seconds": time.perf_counter() - t, "card": smi}), flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        fail("no CUDA device")
    from ml_function_tpu_torch.features.schema import criteo_feature_set
    from ml_function_tpu_torch.features.synthetic import make_criteo_like
    from ml_function_tpu_torch.models import get_model
    from ml_function_tpu_torch.ops import attention, interactions
    from ml_function_tpu_torch.ops.kernels import _build
    from ml_function_tpu_torch.ops.kernels import cin as cin_mod
    from ml_function_tpu_torch.ops.kernels import field_attention as fa_mod
    from ml_function_tpu_torch.ops.kernels import gru as gru_mod
    from ml_function_tpu_torch.serving import export_model, load_scorer
    from ml_function_tpu_torch.tools.timing import event_ms

    card_settings()

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s for {sorted(logs) or 'cached'}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    def lap(what):
        """The wall time since the last lap, by phase."""
        now = time.perf_counter()
        print(f"wall time of {what}: {now - laps[-1]:.1f} s (run so far "
              f"{now - T_START:.1f} s)", flush=True)
        laps.append(now)

    laps = [time.perf_counter()]
    # 3. kernels against their plain versions
    kernels = [check_cin_kernel(cin_mod), check_cin_bwd_kernel(cin_mod),
               *check_field_attn_kernels(fa_mod)]
    launches_by_path, instances_by_path = {}, {}
    drive = make_drive(launches_by_path, instances_by_path)

    # the plain versions, forced in both directions (hooks of this script,
    # not options of the package)
    def plain_cin():
        return swapped(interactions, "cin_layer_t", plain_cin_layer(cin_mod))

    def plain_fa():
        return swapped(attention, "field_attention", plain_field_attention(fa_mod))

    fs = criteo_feature_set([100_000] * 26, n_dense=13, embed_dim=8)
    n_rows = 3 * BATCH + 1000
    _, data = make_criteo_like(n_rows=n_rows, vocab_size=100_000, seed=0)

    lap("phase 3")
    # 4. serving xDeepFM
    hp = {"cin_hidden": [128, 128], "hidden": [256, 128]}
    model = get_model("xdeepfm", fs, device="cuda",
                      generator=torch.Generator().manual_seed(0),
                      **{k: tuple(v) for k, v in hp.items()})
    with tempfile.TemporaryDirectory(dir=_build.BUILD) as tmp:
        export_model(tmp, "xdeepfm", fs, model, hyperparams=hp)
        del model
        scorer = load_scorer(tmp, batch_size=BATCH)
    score_phase("serving", scorer, data, drive, launches_by_path, plain_cin,
                {"cin_fwd": 2})

    # 5. training xDeepFM
    del scorer
    train_phase("xdeepfm", plain_cin, ("cin_fwd", "cin_bwd"),
                ("training_parity", "training_fit"), 0.65, drive, launches_by_path)

    lap("phases 4-5")
    # 6. serving AutoInt, through the field-attention kernel
    hp = {"n_layers": 2, "num_heads": 2, "head_dim": 16}
    model = get_model("autoint", fs, generator=torch.Generator().manual_seed(0), **hp)
    with tempfile.TemporaryDirectory(dir=_build.BUILD) as tmp:
        export_model(tmp, "autoint", fs, model, hyperparams=hp)
        del model
        scorer = load_scorer(tmp, batch_size=BATCH)
    _, batch = score_phase("autoint_serving", scorer, data, drive, launches_by_path,
                           plain_fa, {"field_attn_fwd": 2})
    os.environ.pop("ML_FUNCTION_TPU_FIELD_ATTN")
    with torch.inference_mode():
        small_ms = event_ms(lambda: scorer.model(batch))
    os.environ["ML_FUNCTION_TPU_FIELD_ATTN"] = "1"
    print(f"autoint one forward on the card without the flag (the plain small-L "
          f"route): {small_ms:.4f} ms ({BATCH / small_ms * 1e3:.1f} examples/s)")

    # 7. training AutoInt
    train_phase("autoint", plain_fa, ("field_attn_fwd", "field_attn_bwd"),
                ("autoint_training_parity", "autoint_fit"), 0.6, drive,
                launches_by_path)

    lap("phases 6-7")
    # 8.-10. DIEN: its kernels, serving and training
    del scorer, batch
    kernels += dien_phases(drive, launches_by_path)
    lap("phases 8-10")

    # 11.-14. SIM: the flash kernels, serving and training at both board
    # shapes, learning
    kernels += sim_phases(drive, launches_by_path)
    lap("phases 11-14")

    # 15. F6: the wide CIN and (AU)GRU instances against their plain versions
    t = time.perf_counter()
    by_name = {k["name"]: k for k in kernels}
    cin_f, cin_b, both = check_wide_cin(cin_mod)
    gru_f, gru_b = check_wide_gru(gru_mod)
    for name, extra in (("cin_fwd", cin_f), ("cin_bwd", cin_b), ("gru_fwd", gru_f),
                        ("gru_bwd", gru_b)):
        by_name[name]["per_shape"] += extra
        by_name[name]["max_abs_err"] = max(s["max_abs_err"] for s in by_name[name]["per_shape"])
    by_name["cin_fwd"]["both_instances_at_h256"] = both
    print(f"F6 kernels: {time.perf_counter() - t:.1f} s")

    # 16. xDeepFM with CIN (512, 128): serving and training on the wide instances
    wide_cin_phase(drive, launches_by_path, instances_by_path, plain_cin)
    # 17. DIEN at kd 128: serving and training on the wide (AU)GRU instances
    dien_wide_phase(drive, launches_by_path, instances_by_path)
    lap("phases 15-17")
    # 18.-21.: each model's CPU side in worker processes beside the card's
    # part (cpu_checks); the block's end, after phase 22, waits for the last
    # comparisons. Phase 23 (d)'s CPU ranks start before phase 22 and are
    # joined after phase 27
    with contextlib.ExitStack() as ranks_23:
        with cpu_checks():
            # 18. the interaction models and MMoE at the board's width, card
            # against CPU
            t = time.perf_counter()
            interaction_phases(drive, launches_by_path, plain_fa)
            print(f"interaction models: {time.perf_counter() - t:.1f} s")
            lap("phase 18")
            # 19. the sequence tier at the board's shapes, card against CPU,
            # and DSIN, SeqFM and DMIN on K3 against its plain versions
            t = time.perf_counter()
            sequence_phases(drive, launches_by_path, plain_fa)
            print(f"sequence tier: {time.perf_counter() - t:.1f} s")
            lap("phase 19")
            # 20. DSSM, DeepMCP and DICM (DICM's training also on K1), and
            # the meta step over DeepFM
            last_models_phase(drive, launches_by_path, kernels)
            lap("phase 20")
            # 21. the store: mixed widths, the sparse-row path, int8 scoring
            store_phase(drive, launches_by_path)
            lap("phase 21")
            started_23 = ranks_23.enter_context(sharded_ranks())
            # 22. train from files and resume: xDeepFM from a Criteo TSV
            # (CIN), DIEN from a behavior CSV ((AU)GRU, merge-scatter),
            # checkpoints, while the workers finish the last CPU sides
            file_phase(drive, launches_by_path)
            lap("phase 22")
            t = time.perf_counter()
        print(f"phases 18-21: the last CPU sides and comparisons after phase 22 took "
              f"{time.perf_counter() - t:.1f} s")
        lap("phases 18-21's last CPU sides")
        # 23. row-sharded tables over torch.distributed: the collective
        # lookups, ShardedScorer, the CLI with a sharded checkpoint and a
        # resume (CIN), and two CPU gloo ranks' sharded checkpoint restored
        # on the card, then
        # 27. collective accounting of the sharded step, on phase 23's
        # group and its CPU ranks' records: printed after phase 23's parts
        sharded_phase(drive, launches_by_path, smi, started_23)
    lap("phases 23 and 27")
    # 24. item 8b over NCCL at world size 1: the sequence-sharded search,
    # ring and dist attention, the pipeline on AutoInt (K3, 16 + 16 a step),
    # and two CPU gloo ranks that split SIM's stream and AutoInt's blocks,
    # which train while the card runs (a) to (c) and
    # 25. graph pretraining: DeepWalk on the native walks, LINE and SDNE

    def phase_25():
        t = time.perf_counter()
        graph_phase(drive, launches_by_path, smi)
        print(f"wall time of phase 25: {time.perf_counter() - t:.1f} s")

    item_8b_phase(drive, launches_by_path, smi, then=phase_25)
    lap("phases 24-25")
    # 26. the chained train step: fit(steps_per_call=8) as one CUDA graph
    # replay a group on xDeepFM, AutoInt, DIEN and SIM's flash ESU
    chained_phase(drive, launches_by_path, smi)
    lap("phase 26")

    # 28. result lines: each kernel's launches are those of the newest path
    # that runs it whose counts its wrapper made (phase 26's last unchained
    # rate fits; the chained fits' counts, which their replays added and the
    # profiler checked, ride along with every path's own),
    # and each instance (C function) with the shapes it took here
    for k in kernels:
        runs = [p for p, c in launches_by_path.items()
                if c[k["name"]] and p not in REPLAYED_PATHS]
        k["launches"] = launches_by_path[runs[-1]][k["name"]]
        k["launches_path"] = runs[-1]
        k["launches_by_path"] = {p: c[k["name"]] for p, c in launches_by_path.items()}
        shapes = {}
        for sh in k.get("per_shape", []):
            shapes.setdefault(sh.get("instance", k["name"]), []).append(sh.get("shape"))
        k["instances"] = shapes
    print("instances by path: " + json.dumps(
        {p: c for p, c in instances_by_path.items() if c}))
    print(f"wall time of the run: {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--chain-noise"]:
        sys.exit(chain_noise(int(sys.argv[2])))
    sys.exit(main())
