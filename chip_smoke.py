#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path on one GPU and hold every kernel of
that path against its plain PyTorch version.

    python3 chip_smoke.py                  # full size: n=50,000, d=512
    python3 chip_smoke.py --n 8192 --naive-budget 50 --lazy-budget 200 \
        --mf-n 65536 --mf-lazy-budget 200 --reps 5   # a short check

Fourteen paths run, each with its launch counts set to 0 just before it and
read just after:

- the main path, the paper's core loop: ``create_kernel`` (CUDA similarity
  kernel) -> ``FacilityLocation`` -> NaiveGreedy and LazyGreedy through
  ``SelectionSpec`` + ``solve()`` (CUDA FL-sweep kernel, full and gathered).
  The ground set is CIFAR-10-sized: n items with d features drawn from
  ``--seed`` as a 100-component Gaussian mixture, cosine similarity.
- the matrix-free path: ``FacilityLocationMF`` and ``GraphCutMF`` built from
  features, through the same ``solve()`` (CUDA flmf and gcmf sweeps, full
  and gathered), on the same features and on a million-point candidate set.
- the dense pairwise path: ``GraphCut`` on the main path's S (CUDA gc
  sweeps, full and gathered) and ``DisparitySum`` / ``DisparityMin`` /
  ``DisparityMinSum`` on the JAX package's diversity distances
  ``1 / max(S_euclidean, 1e-6) - 1`` (CUDA dsum and dmin sweeps).
- the coverage path: ``FeatureBased`` on post-ReLU features and
  ``SetCover`` / ``ProbabilisticSetCover`` on a 1,000-concept tagger over
  the million-point candidate set (CUDA fb sweeps, full and gathered, and
  sc and psc sweeps).
- the guided path: the fused dot similarity + FL sweep along a
  ``FacilityLocationMF`` selection over the million-point set, clustered
  FacilityLocation on the main path's S masked by ``kmeans`` labels (CUDA
  FL sweeps) and its matrix-free form, and the information measures (FL,
  GC, LogDet, Concave-Over-Modular) with a query and a private set;
  ``gccg`` runs the CUDA gc sweeps.
- the wave path: B selection problems as one wave through
  ``solve(specs, mode="batched")`` / ``BatchedEngine`` (one ``fl_gains``
  launch a NaiveGreedy step and one ``fl_gains_at`` launch a LazyGreedy
  level for the whole wave), every other kernel family in a wave, and the
  sparse k-NN sources.
- the served path: mixed requests of twelve families through
  ``SelectionServer`` (per-group queues, padded waves of the batched
  engine), ``AsyncSelectionServer`` and sessions, every answer bit-equal
  to the request's sequential ``solve()``.
- the remaining optimizers: StochasticGreedy, LazierThanLazyGreedy,
  SieveStreaming, ThresholdGreedy, the constrained greedies and the host
  heap greedy on the main path's S (CUDA FL sweeps, full and gathered, the
  sieves on a member-stride-0 wave), streaming requests served and a
  streaming session (the FB sweeps too).
- the sharded path: the distributed engine on ``torch.distributed``, a
  world of 1 on NCCL in this process and a 2x2 world of four ranks on the
  one card over gloo: the partition greedies and sharded waves of every
  family through ``solve(specs, mesh=mesh)``, each member bit-equal to its
  sequential solve (the FL, FB, SC and PSC sweeps per shard).
- the mesh-served path: ``SelectionServer(mesh=)``,
  ``AsyncSelectionServer(mesh=)`` and a session on a world of 1 on NCCL,
  and a 2x2 mesh of four ranks on the one card over gloo where rank 0
  serves and the others follow its waves; then the training pipeline's
  selection stage (``SubmodularSelector`` on a qwen3-0.6b-wide pool and its
  ``selection_step`` on the mesh).
- the training path: ``repro_torch.launch.train.run`` at qwen3-0.6b's full
  width: a pool of examples embedded by the model being trained, a
  FacilityLocation coreset picked by ``SubmodularSelector`` (the CUDA
  similarity and FL-sweep kernels), AdamW steps on it, a checkpoint and a
  resumed run.
- the other families' training path: the same ``run()`` at mamba2-370m's
  full width (the Mamba2 / SSD mixer), and deepseek-v2 (MLA and MoE),
  whisper-small (encoder-decoder) and jamba (the hybrid period) through the
  model entry points.
- training on a mesh and the dry run: ``make_train_step`` on DTensors placed
  by ``distributed/sharding.py``'s rules under ``activation_sharding``, the
  sharded checkpoint's elastic restore, and ``launch/dryrun.py``'s count of
  a step on a fake process group (it launches none of the kernels), the
  selection cells among them.
- the selection cells' path: ``launch/dryrun.py``'s ``build_selection_step``
  (the distributed FL greedy, dense or stochastic, on an fp32 or bf16 kernel)
  run for real on one rank's full-width share (CUDA FL sweeps, full and
  gathered, through the registered ``torch.ops.repro_torch`` operators).

Phases, each of which raises on failure (the exit code is then non-zero):
  1 device   CUDA present; the card's name and power limit
  2 build    nvcc every kernel source for sm_90a; ptxas registers/spills
             (a cached library's from the report its build kept); the
             pipelined SGEMM kernels (similarity, fused, flmf) spill nothing,
             and the resident blocks per SM of similarity's and fused's
  3 kernels  each kernel against its plain version at small and ragged shapes
             (the fused sweep in fp32 and bf16, with its column-slice bit
             identity; dmin and gcmf at the selection sizes where their
             branches and column blocks change; gc, gc_at and dsum bit-equal
             to their plain versions at |A| across the warp's lanes, the
             staged chunk and every column; similarity, the fused
             sweep, flmf and sc on rows that are not 16-byte aligned,
             bit-equal to the same call on aligned rows; fl_gains and
             fl_gains_at past the 8,388,480 rows the first design took,
             with int32 and int64 ids; on a bf16 S, single and in waves,
             bit-equal to the fp32 kernel on the widened S), and the mask
             compaction against torch.nonzero at n = 2^20
  4 main     the main path at full size, its launch counts (fl_gains_at's
             also by width k), and the same solves on the plain path,
             compared step by step
  5 times    each kernel, its plain version and the library call, timed
             with CUDA events at its path's shapes (fl_gains_at and
             fb_gains_at at every width phases 4 and 8 (f) launched, with
             the engine's int64 ids, and the host's cost of one call at
             k = 8 beside its event time; both on S rounded to bf16, bit-equal
             to the fp32 kernel on the widened S; the sweeps over the selected columns
             beside their selected-columns library call and sector floor,
             dmin, gc and dsum bit-equal to their plain versions)
  6 mf       the matrix-free path: (a) FacilityLocationMF on phase 4's
             features, held against phase 4's dense selection and under a
             1 GB peak; (b) FacilityLocationMF over --mf-n candidates and
             MF_U represented rows (rbf); (c) GraphCutMF on phase 4's
             features; each against its plain (use_kernel=False) path
  7 dense    the dense pairwise path on phase 4's features: (d) GraphCut on
             phase 4's S; (e) DisparitySum, DisparityMin, DisparityMinSum
             on the distances; each against its plain path; after its counts
             are read, the first lazy level where (d)'s LazyGreedy n_evals
             part between the two paths
  8 coverage the coverage path over --mf-n candidates, d features: (f)
             FeatureBased on relu(x), sqrt (fb_gains_at's launches counted
             by width k); (g) SetCover on the tags
             p > 0.5 and (h) ProbabilisticSetCover on p of the tagger
             p = sigmoid(x W + b); each against its plain (use_kernel=False)
             path, SetCover exactly (ids, gains, n_evals)
  9 guided   (i) the fused sweep at every state of a FacilityLocationMF (dot)
             NaiveGreedy over --mf-n unit relu(mixture) rows, bit-equal to
             flmf_gains, in fp32 and bf16, and against its plain version;
             (j) kmeans on phase 4's features, dense clustered FL on phase
             4's S (rebuilt), NaiveGreedy 250 / LazyGreedy 2,500, against
             its plain path, and the matrix-free
             clustered FL against the dense one; (k) FLQMI / FLVMI / FLCG /
             FLCMI, gccg (against its plain path), GCMI, COM, LogDet and
             logdet_mi on S with 100 query and 100 private items, budget 50
  10 wave    (l) FacilityLocation waves of --wave-b members at n = --wave-n
             and a quarter of them at 2x (cosine S of mixtures from the seed
             + member index, budgets 50..75), NaiveGreedy and LazyGreedy,
             through solve(specs, mode="batched"), in turns W S S W with the
             B sequential solves: every member of every run bit-equal to its
             first sequential solve, one fl sweep launch a step / level over all members, the
             wave kernels against B single launches; (m) a zero-padded wave
             (n_i from --wave-n to 2x) through BatchedEngine(valid=...),
             bit-equal to the unpadded sequential solves; (n) GraphCut,
             DisparitySum / Min, FeatureBased, SetCover, PSC, FLMF and GCMF
             in waves of 4 (NaiveGreedy 50, LazyGreedy 75), bit-equal; (o)
             knn_from_features on phase 4's features (top-k rows checked),
             FacilityLocationMF.from_knn against a dense FL over its
             to_dense() and run twice with equal bits, random neighbours over
             --mf-n items, GraphCutMF.from_knn
  11 served  (p) SERVE_REQUESTS 48 requests (the JAX package's serve CLI
             families fl, gc, fb, sc, psc, dsum, dmin, flqmi, gcmi, logdet,
             and FLMF / GCMF over a cosine FeatureSource; mixtures from
             --seed + SERVE_SEED + i at d, n from SERVE_N, budgets 50..100,
             half NaiveGreedy, half LazyGreedy, use_kernel=None) through
             SelectionServer(max_wave=SERVE_MAX_WAVE), a warm-up and a
             steady round: every answer bit-equal to its sequential solve on
             the route that solve takes (the padded requests under
             KERNEL_MIN_N stay on the torch sweeps in the bucket above it),
             the 15 kernels of the path launched; (q) the same through
             AsyncSelectionServer, depth and timer triggers both firing; (r)
             a FacilityLocationMF session fed uneven deltas to SESSION_N
             rows, against one extend and a direct solve(), and a dense
             FacilityLocation session in indices mode against a direct solve
             on its active set; (s) an injected "kernel" fault opening the FL
             breaker: the FL requests fail typed, a GraphCut request in the
             same flush is answered, and after the cooldown a probe wave
             closes the breaker with answers equal to the sequential solves;
             (p)-(r) fail on any failed or retried request or open breaker
  12 remaining  on phase 4's S rebuilt, each solve on the kernel route
             (use_kernel=None) and the plain route (use_kernel=False), equal
             ids and n_evals, gains within FL_TOL: 12.1 StochasticGreedy and
             LazierThanLazyGreedy 1,000, eps 0.01 (s = 231), seed 0,
             with their values over phase 4's LazyGreedy 5,000 value; 12.2
             SieveStreaming 100, eps 0.1, seed None and 0, ThresholdGreedy
             100, buffer 64, with fl_gains_at's launches an arrival; 12.3
             knapsack_greedy, matroid_greedy (labels: the mixture component
             mod 10, caps 10) and cover_greedy, max_steps 300, and the
             Sieve under that matroid; 12.4 host_lazy_greedy 300, whose ids
             must be phase 4's NaiveGreedy ids; 12.5 24 SieveStreaming /
             ThresholdGreedy requests over FL and FeatureBased at n in
             SERVE_N through SelectionServer, each bit-equal to its
             sequential solve, and a FeatureBased session of 5 deltas
             bit-equal to the direct solve; after the path's counts are
             read, fl_gains_at on a member-stride-0 wave of S against its
             plain version; 12.6 the threefry draws and the ladders' exp /
             log on the card bit-equal to the CPU's
  13 distributed  (t) a world of 1 on NCCL: distributed_fl_greedy
             --naive-budget on phase 4's S (rebuilt), its ids phase 4's
             NaiveGreedy ids up to the first near-tie, called twice (the
             first call sets up the communicators); FL waves B = 4 at n =
             8,192 (NaiveGreedy and LazyGreedy 150 / 90) and FB / SC / PSC
             waves (20 / 10) through solve(specs, mesh=mesh), each run twice
             beside mode="batched" and the sequential solves, every member
             bit-equal, the FL waves' launches the batched wave's, the
             collectives counted; (u) four ranks of this script
             (--rank-2x2) on the card over gloo, a 2x2 ("batch", "data")
             mesh: the 13 families with a shard rule at n = 4,096, B = 4,
             NaiveGreedy and LazyGreedy 20 / 10, every member bit-equal to
             rank 0's sequential solve and the batch the same on every
             rank; on ("data", "model") distributed_fl_greedy 250 at phase
             4's n (each rank's block cut from S built on one rank at a
             time) against (t)'s first ids, the stochastic and FLQMI partition greedies
             at n = 8,192 against plain references; each rank's peak memory
  14 mesh    (v) on 13 (t)'s world of 1: 26 requests of the 13 families with
             a shard rule (n 3,072..8,192, budgets 50..100, half
             LazyGreedy) through SelectionServer(mesh=), the first 8 through
             AsyncSelectionServer(mesh=), an FB session, every answer
             bit-equal to its sequential solve and no fallback; one wave
             under dispatch faults on the mesh, served degraded
             ("single-device"), bit-equal and counted; (w) four ranks of
             this script (--rank-mesh) on the card over gloo, a 2x2
             ("batch", "data") mesh: rank 0 serves 32 requests at n 2,048 /
             4,096 (two FL requests of n = 4,097 on the kernels, NaiveGreedy
             and LazyGreedy, each padded to 4,098), the others follow; every
             answer bit-equal to rank 0's sequential solve, each follower's
             waves and results digest rank 0's, batch pads counted, the
             plans' bytes and broadcast share; (x) SubmodularSelector at
             n = 16,384, d = 1,024, budget 512: the four objectives under
             LazyGreedy on the kernel route against the plain route, and
             selection_step against a single-device FL NaiveGreedy on its
             kernel
  15 train   (y) launch.train.run at qwen3-0.6b's full width (28 layers, d
             1,024, bf16), batch 16 x 256: a pool of 4,096 examples embedded,
             a 1,024 coreset (FL LazyGreedy, euclidean kernel, at the kernel
             gate), 8 AdamW steps and a checkpoint; the step-0 loss within
             (0.2, 3.0) x log(vocab), every grad norm finite and positive;
             the pool's S from similarity.cu within the euclidean bar of its
             plain version and the coreset's ids the plain route's up to a
             stated near-tie; a second run resumed from the checkpoint, its
             losses finite; make_train_step on one fixed batch lowering the
             loss by 0.5 in 8 steps, and its state saved and restored bit
             for bit (bf16 params and moments, the step); walls, tokens/s and
             peak memory beside the card's name and power limit
  16 other   (z) launch.train.run at mamba2-370m's full width and depth (48
             layers, d 1,024, 32 SSM heads, N 128, chunk 256, bf16), as
             (y): 8 steps, a checkpoint, a resumed run whose restored state
             is the saved one bit for bit (zero-size d_ff = 0 leaves
             included), the coreset the plain route's; 8 steps on one batch
             (every gradient finite, the loss down by 0.5), a profiled step;
             in fp32, prefill of 255 tokens + decode_step against the
             no-cache forward of 256 (rtol / atol 2e-2); (z') deepseek-v2 at
             its published widths, 2 layers (5.19 B parameters): bf16
             embed_examples, prefill and 8 absorbed decodes timed, the share
             of (token, k) slots dropped at capacity 1.0; in fp32 with the
             capacity at the group size, 8 decodes each against a prefill of
             the extended tokens; (z'') whisper-small full width: the
             encoder's mean embedding, 6 steps on one batch, fp32 decode
             against prefill; (z''') jamba reduced in bf16: decode against
             the no-cache forward, 3 steps
  17 mesh training  (aa) qwen3-0.6b at phase 15's width, depth and batch:
             two make_train_step steps unsharded, then on DTensors placed
             by param_shardings on an NCCL (1, 1) mesh under
             activation_sharding, fsdp and dp, every loss and leaf bit-equal;
             the dry run of the cell on a fake (1, 1) mesh: its argument
             bytes the real local bytes exactly, its flops over the median
             step as TFLOP/s, its peak against max_memory_allocated within
             0.5-2x; (bb) four ranks of this script (--rank-shard), one
             NCCL rank a card on four cards, four gloo ranks on one card
             (tools/gloo_cuda_probe.py's unrepaired functional all-gather of
             CUDA tensors, run beside (aa), printed first; make_mesh
             installs the port's repair), the ranks running beside (cc):
             two steps of qwen3-0.6b at 2 layers in fp32 on a 2x2
             ("data", "model") mesh under fsdp (activations split over
             "model": Megatron-SP, head TP) and under dp (not split) against
             the unsharded steps (tests/test_torch_sharded_steps.py's bars),
             each rank's collectives equal to the dry run's on a fake (2, 2)
             mesh, each rank's first step's peak against the dry run's
             within 0.5-2x, deepseek-v2's MoE layer at its published widths
             at tp_size 2, groups and experts split, against whole tensors;
             the initial fsdp state saved sharded and restored onto (4, 1),
             (1, 4) and a world of 1, each block bit-equal; any rank's error
             fails the phase; (cc)
             launch/dryrun.py's qwen3-0.6b train_4k on 256 fake ranks, its
             record printed, and the selection cells (select_1m, _stoch,
             _bf16, _stoch_bf16 on 256 fake ranks, select_1m on 512), their
             argument bytes, 2,048 all-reduces and bytes and the FL
             sweeps' kernel bytes exact; (dd) on
             an NCCL world of 1, one rank's full-width share of each
             selection cell (a 1,024 x 65,536 block of ops.similarity over
             a mixture at d = 1,024, fp32 and bf16, budget 512): walls,
             512 sweep launches a run, the peak against the dry run's
             arguments + temp within 0.5-2x, each bf16 run bit-equal to
             the fp32 run on the widened block; fl_gains and fl_gains_at
             (k = 1,024, int64 ids) on those blocks within FL_TOL of their
             plain versions at two states, and select_1m's ids equal to
             the plain path's NaiveGreedy up to a near-tie
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Details go to chiprun_out/chip_smoke.json.
Without a CUDA device, or without the repo's ``src/`` beside it, the script
exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import itertools
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# published H100 SXM peaks at 700 W (NVIDIA data sheet): fp32 off the tensor
# cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

SIM_TOL = {  # (rtol, atol) of the JAX package's similarity tests
    "dot": (1e-4, 1e-3),
    "cosine": (1e-4, 1e-3),
    "euclidean": (1e-3, 5e-2),
    "rbf": (1e-3, 5e-2),
}
FL_TOL = (1e-5, 1e-4)  # fl_gains kernel vs plain: fp32 sums of <= 50k terms
# flmf / gcmf kernel vs plain: the same sums, over similarities that the
# kernel's fmaf chain and the plain version's matmul may round differently.
# Euclidean raises only the absolute bar, to the JAX package's own
# matrix-free bar (tests/test_matrix_free.py:76): a self pair's d2 ~ 0 comes
# out of cancellation, and 1 / (1 + sqrt(d2)) turns its rounding into an
# absolute error of ~1e-3 in one term of the sum.
MF_TOL = {"dot": (2e-5, 1e-4), "cosine": (2e-5, 1e-4), "rbf": (2e-5, 1e-4),
          "euclidean": (2e-5, 2e-3)}
# phase 6 (b): the million-point shape's represented rows and budgets (the
# budgets stay below MF_U: the representatives are candidates too)
MF_U = 512
MF_NAIVE_BUDGET = 100  # also phase 6 (a) and (c)
MF_BIG_LAZY_BUDGET = 256
MF_PEAK_LIMIT = 1 << 30  # phase 6 (a): peak device bytes of the kernel path's selection
NEAR_TIE_REL = 1e-4  # top-two gains this close (relative) may flip the pick
GAIN_RTOL = 1e-5  # kernel-path vs plain-path gains over the agreeing prefix
# gc / dsum kernel vs plain: fp32 row sums of <= 50k terms (the two are
# built to agree bit for bit; the bar is the tolerance they are held to)
DENSE_TOL = (1e-5, 1e-5)
# phase 7 (d): GraphCut's trade-off (the matrix-free GC cell's) and its gain
# bar, the JAX package's for its gc kernel (tests/test_kernels.py:197-212)
GC_LAM = 0.4
GC_GAIN_RTOL = 1e-4
# phase 7 (d): LazyGreedy's n_evals, kernel path against plain path.  Each
# level compares the best fresh gain with the largest stale bound left; the
# two paths sum in other orders, so a decision that sits within rounding of
# its threshold can go either way without changing any id (on an H100 at
# n = 50,000: 233,728 against 233,680 at 1,000 steps).  The bar: about
# twice the largest difference seen.  ``_lazy_levels_apart`` finds the first
# level where the paths' decisions part and holds it to such a knife edge.
NEVALS_RTOL = 4e-4
DMIN_SUM_BUDGET = 100  # phase 7 (e): DisparityMinSum, torch path only
CONCAVES = ("sqrt", "log", "inverse")
# fb / fb_at / sc / psc kernel vs plain: fp32 sums of <= 1,000 terms in
# one order (built to agree bit for bit; log1p is CUDA's log1pf on both)
COVER_TOL = (1e-5, 1e-5)
# phase 8 (g, h): the tagger's concepts and logit bias.  x W has variance
# |x|^2 / d ~ 2 for the mixture's rows (centre and noise each N(0, 1)), so
# p > 0.5 on P(N(0, 2) > 2.9) ~ 2% of the concepts: ~20 tags per item
TAGS = 1000
TAG_BIAS = -2.9
# phase 3: the fused sweep at tests/test_kernels.py's FUSED_SHAPES (u, n, d)
# and ragged ones; held to the matrix-free dot bar against its plain version
FUSED_SHAPES = [(40, 60, 16), (300, 700, 128), (256, 512, 300), (513, 1025, 80)]
FUSED_RAGGED = [(129, 1, 8), (1, 300, 13), (700, 5000, 512)]
# phase 9 (i): kernel vs plain version on unit rows, whose dot products lie
# in [0, 1]: fp32 sums of 512 terms in two orders
FUSED_PLAIN_TOL = (1e-5, 1e-4)
# phase 2: the sources on the pipelined SGEMM mainloop (csrc/sgemm_pipe.cuh)
PIPE_SOURCES = ("similarity.cu", "fused_fl_sweep.cu", "flmf_gains.cu")
# phase 3: widths for rows that are not 16-byte aligned (below one 32-k strip,
# not a multiple of it, a multiple of it) and row counts below one 128 tile
UNALIGNED_D = (1, 13, 72, 130, 512)
UNALIGNED_ROWS = (37, 101)
# phase 3: rows past the 65,535 x 128 that the first fl_gains design's grid took
FL_ROWS_PAST_LIMIT = 65_535 * 128 + 1
# phase 5: the host's cost of a call, HOST_BATCHES runs of HOST_CALLS calls
HOST_CALLS, HOST_BATCHES = 200, 5
CLUSTERS, KMEANS_ITERS = 100, 25  # phase 9 (j): the mixture's component count
GUIDED = 100  # phase 9 (k): |Q| = |P|
GUIDED_BUDGET = 50  # phase 9 (k): the FL, GC and COM measures' NaiveGreedy budget
CLUSTERED_MF_BUDGET = 50  # phase 9 (j): the matrix-free clustered FL
CLUSTERED_BUDGETS = (250, 2500)  # phase 9 (j): the dense clustered FL's Naive / LazyGreedy
LOGDET_BUDGET = 100  # phase 9 (k): well under the cosine S's rank d + 1
# phase 10 (l), (m): the members' budgets, spread evenly over this range, and
# LazyGreedy's screen width
WAVE_BUDGETS = (50, 75)
WAVE_SCREEN_K = 8
# phase 10 (n): members per family, and the NaiveGreedy / LazyGreedy budgets
FAMILY_B = 4
FAMILY_BUDGETS = (50, 75)
# phase 10 (o): neighbours per row and knn_from_features' row batch on phase
# 4's features; the million-point shape's random neighbours (the JAX
# package's tests/test_matrix_free.py:285-296); NaiveGreedy / LazyGreedy
# budgets of each, and GraphCutMF's NaiveGreedy budget
KNN_K, KNN_BATCH = 10, 2048
KNN_MILLION_K = 8
KNN_BUDGETS = ((500, 1000), (100, 1000))
GC_KNN_BUDGET = 100
# phase 11: the served workload's families (the JAX package's serve CLI ten,
# src/repro/launch/serve.py:971-1025, and FLMF / GCMF over a FeatureSource),
# budgets, seed offset and query rows; AsyncSelectionServer's triggers;
# the FLMF session's final n, its seed rows and uneven deltas (as given at
# 8,192 rows, scaled for another SESSION_N), its LazyGreedy budget; the
# kernel fault's n and the breaker's cooldown
SERVE_REQUESTS = 48  # two rounds of the 12 families, each NaiveGreedy and LazyGreedy
SERVE_N = (3072, 4096, 6144, 8192)
SERVE_MAX_WAVE = 64
SERVE_KINDS = ("fl", "gc", "fb", "sc", "psc", "dsum", "dmin", "flqmi", "gcmi", "logdet",
               "flmf", "gcmf")
KERNEL_FAMILIES = ("FacilityLocation", "GraphCut", "FeatureBased", "SetCover",
                   "ProbabilisticSetCover", "DisparitySum", "DisparityMin", "FacilityLocationMF",
                   "GraphCutMF")
SERVED_KERNELS = ("similarity", "fl_gains", "fl_gains_at", "flmf_gains", "flmf_gains_at",
                  "gc_gains", "gc_gains_at", "gcmf_gains", "gcmf_gains_at", "fb_gains",
                  "fb_gains_at", "sc_gains", "psc_gains", "dsum_gains", "dmin_gains")
SERVE_BUDGETS = (50, 100)
SERVE_SEED = 7000
SERVE_QUERIES = 16
SERVE_MAX_PENDING, SERVE_FLUSH_INTERVAL = 2, 0.05
SESSION_N = 8192
SESSION_DELTAS = (1000, 37, 2048, 1)
SESSION_BUDGET = 100
FAULT_N = (4096, 6144)
FAULT_COOLDOWN_S = 60.0  # on the breaker board's own clock, which (s) moves


def log(msg: str) -> None:
    print(msg, flush=True)


def max_err(got, want) -> float:
    return float((got.double() - want.double()).abs().max()) if got.numel() else 0.0


def check_close(what: str, got, want, rtol: float, atol: float, quiet: bool = False) -> float:
    """Raise unless |got - want| <= atol + rtol * |want| everywhere; logs
    the check unless ``quiet``."""
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    g, w = got.double(), want.double()
    bad = (g - w).abs() > atol + rtol * w.abs()
    err = max_err(got, want)
    if not bool(g.isfinite().all()):
        raise AssertionError(f"{what}: non-finite values")
    if bool(bad.any()):
        raise AssertionError(
            f"{what}: {int(bad.sum())} elements outside rtol={rtol} atol={atol}; max abs err {err:.3e}"
        )
    if not quiet:
        log(f"  ok  {what}: max abs err {err:.3e} (rtol {rtol}, atol {atol})")
    return err


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of one call in ms, CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_us(torch, fn, calls: int = HOST_CALLS, batches: int = HOST_BATCHES) -> float:
    """Host microseconds per call, on a host clock: the median over
    ``batches`` runs of ``calls`` calls with no sync between them, and a
    sync between runs.  A run's backlog stays far below the depth of the
    launch queue, so the host never waits for the card, even where a call's
    device time is above its host time."""
    fn()
    per_call = []
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per_call.append(1e6 * (time.perf_counter() - t0) / calls)
    torch.cuda.synchronize()
    return statistics.median(per_call)


def counting_widths(ops, name: str, pos: int, widths: collections.Counter):
    """Replace ``ops.<name>`` by a wrapper that counts its calls by the
    width of its positional argument ``pos`` (the ids); returns the
    original, for the caller to put back."""
    fn = getattr(ops, name)

    def counted(*args, **kw):
        widths[int(args[pos].shape[0])] += 1
        return fn(*args, **kw)

    setattr(ops, name, counted)
    return fn


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """Least time (ms) the card could take, and what sets it."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes")


def gaussian_mixture(seed: int, n: int, d: int, components: int = 100) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(components, d)).astype(np.float32)
    labels = rng.integers(0, components, size=n)
    return centers[labels] + rng.normal(size=(n, d)).astype(np.float32)


def gaussian_mixture_cuda(torch, seed: int, n: int, d: int, components: int = 100):
    """The same kind of mixture, drawn on the card (a million rows in ms)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    centers = torch.randn((components, d), generator=gen, device="cuda")
    labels = torch.randint(0, components, (n,), generator=gen, device="cuda")
    return centers[labels] + torch.randn((n, d), generator=gen, device="cuda")


# ---------------------------------------------------------------------------


def phase_device(torch) -> dict:
    log("== phase 1: device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    name = torch.cuda.get_device_name(0)
    log(f"torch.cuda.get_device_name(0) = {name}; device_count = {torch.cuda.device_count()}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    return {"kind": name, "count": torch.cuda.device_count(), "nvidia_smi": smi}


def _ptxas_functions(report: list[str], sources) -> list[dict]:
    """Registers and spill bytes of every function ptxas compiled from
    ``sources``, read from the build's ``-Xptxas -v`` report."""
    funcs, cur = [], None
    for line in report:
        src = line.split(":", 1)[0]
        if src not in sources:
            continue
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            cur = {"source": src, "function": m.group(1)}
            funcs.append(cur)
        elif cur is not None and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                                                 line)):
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        elif cur is not None and (m := re.search(r"Used (\d+) registers", line)):
            cur["registers"] = int(m.group(1))
    return funcs


def _pipe_blocks_per_sm() -> dict:
    """Resident blocks per SM of the pipelined kernels' variants, from the
    CUDA occupancy calculator at their dynamic shared memory."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.similarity_kernel import _METRIC_CODE

    lib, b, out = _build.load(), ctypes.c_int(), {}
    for metric, vec in itertools.product(("dot", "rbf"), (1, 0)):
        _build.check(lib.similarity_blocks_per_sm(_METRIC_CODE[metric], vec, ctypes.byref(b)),
                     "similarity occupancy")
        out[f"similarity {metric} vec={vec}"] = b.value
    for (xb, yb), vec in itertools.product(((0, 0), (1, 1), (0, 1), (1, 0)), (1, 0)):
        _build.check(lib.fused_fl_sweep_blocks_per_sm(xb, yb, vec, ctypes.byref(b)),
                     "fused occupancy")
        out[f"fused x={'bf16' if xb else 'fp32'} y={'bf16' if yb else 'fp32'} vec={vec}"] = b.value
    return out


def phase_build() -> dict:
    from repro_torch.kernels import _build

    log("== phase 2: build")
    _build.load()
    info = dict(_build.BUILD_INFO)
    log(f"built {info['library']} in {info['seconds']:.1f} s (cached: {info['cached']})")
    for line in info["ptxas"]:
        if "ptxas info" in line or "spill" in line or "error" in line.lower():
            log("  " + line)
    # a cached library's report is the one its build wrote beside it
    pipe = _ptxas_functions(info["ptxas"], PIPE_SOURCES)
    spilled = [f["function"] for f in pipe if f.get("spill_stores", 1) or f.get("spill_loads", 1)]
    if not pipe or spilled:
        raise AssertionError(f"pipelined SGEMM kernels spill (or report nothing): {spilled}")
    info["pipe_functions"] = pipe
    regs = {src: sorted({f["registers"] for f in pipe if f["source"] == src})
            for src in PIPE_SOURCES}
    log(f"  pipelined SGEMM kernels: no spills; registers per thread {json.dumps(regs)}")
    info["pipe_blocks_per_sm"] = _pipe_blocks_per_sm()
    log("  resident blocks per SM: " + json.dumps(info["pipe_blocks_per_sm"]))
    return info


def _offset_rows(torch, t):
    """A copy of the 2-D tensor ``t`` one element into a flat buffer: no row
    of it starts 16-byte aligned, so the pipelined kernels take their
    element-wise path (4-byte copies for fp32, element loads for bf16)."""
    view = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    view.copy_(t)
    if view.data_ptr() % 16 == 0:
        raise AssertionError("an offset copy is 16-byte aligned")
    return view


def phase_kernels(torch, seed: int) -> None:
    from repro_torch.common import NEG_INF
    from repro_torch.kernels import ops
    from repro_torch.kernels.fl_gains import fl_gains_at_plain, fl_gains_plain
    from repro_torch.kernels.similarity_kernel import (
        _normalize, inv_two_sigma_sq, launch_rows, similarity_plain,
    )

    log("== phase 3: kernels vs plain, small and ragged shapes")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    for n, m, d in [(4096, 4096, 512), (1000, 777, 130)]:
        x = torch.randn((n, d), generator=gen, device=dev)
        y = torch.randn((m, d), generator=gen, device=dev)
        for metric, (rtol, atol) in SIM_TOL.items():
            got = ops.similarity(x, y, metric)
            torch.cuda.synchronize()
            check_close(f"similarity {metric} ({n},{m},{d})", got,
                        similarity_plain(x, y, metric), rtol, atol)
    # unaligned rows: the public call against the plain version, and the
    # kernel on the rows it is given (cosine pre-normalised: ops.similarity
    # normalises into new tensors with a norm whose order may follow the
    # alignment) bit-equal to the kernel on aligned rows
    n, m = UNALIGNED_ROWS
    worst = 0.0
    for d in UNALIGNED_D:
        x = torch.randn((n, d), generator=gen, device=dev)
        y = torch.randn((m, d), generator=gen, device=dev)
        inv2s2 = inv_two_sigma_sq(d, None)
        for metric, (rtol, atol) in SIM_TOL.items():
            got = ops.similarity(_offset_rows(torch, x), _offset_rows(torch, y), metric)
            torch.cuda.synchronize()
            worst = max(worst, check_close(f"similarity {metric} ({n},{m},{d}) unaligned", got,
                                           similarity_plain(x, y, metric), rtol, atol, quiet=True))
            xk, yk = (_normalize(x), _normalize(y)) if metric == "cosine" else (x, y)
            if not torch.equal(launch_rows(_offset_rows(torch, xk), _offset_rows(torch, yk),
                                           metric, inv2s2), launch_rows(xk, yk, metric, inv2s2)):
                raise AssertionError(f"similarity {metric} ({n},{m},{d}): unaligned rows are not "
                                     "bit-equal to aligned ones")
    log(f"  ok  similarity on unaligned rows, ({n},{m}) at d in {UNALIGNED_D}, every metric: "
        f"the kernel bit-equal on aligned rows, max abs err {worst:.3e} against the plain version")
    # FL_ROWS_PAST_LIMIT: more rows than the first design's grid took; at
    # n = 8 every k runs the full sweep and a gather, at n = 40 k = 1 takes
    # the gathered kernel by its own rule
    for u, n in [(4096, 4096), (1000, 777), (333, 5000), (129, 1), (FL_ROWS_PAST_LIMIT, 8),
                 (FL_ROWS_PAST_LIMIT, 40)]:
        sim = torch.rand((u, n), generator=gen, device=dev)
        cm = 0.8 * torch.rand((u,), generator=gen, device=dev)
        full = ops.fl_gains(sim, cm)
        torch.cuda.synchronize()
        check_close(f"fl_gains ({u},{n})", full, fl_gains_plain(sim, cm), *FL_TOL)
        for k in (1, 8, 100, 777):
            idx = torch.randint(0, n, (k,), generator=gen, device=dev)
            idx[::7] = -1  # padding slots, the first among them
            got = ops.fl_gains_at(sim, cm, idx)
            torch.cuda.synchronize()
            keep = idx >= 0
            if not torch.equal(got[keep], full[idx[keep]]):
                raise AssertionError(f"fl_gains_at ({u},{n}) k={k}: not bit-equal to fl_gains")
            if not bool((got[~keep] == NEG_INF).all()):
                raise AssertionError(f"fl_gains_at ({u},{n}) k={k}: pads are not NEG_INF")
            if not torch.equal(ops.fl_gains_at(sim, cm, idx.to(torch.int32)), got):
                raise AssertionError(f"fl_gains_at ({u},{n}) k={k}: int32 ids differ from int64")
            check_close(f"fl_gains_at ({u},{n}) k={k} (bit-equal to fl_gains, int32 = int64 ids, "
                        "pads NEG_INF)", got, fl_gains_at_plain(sim, cm, idx), *FL_TOL)
        del sim
    _bf16_fl_kernels(torch, gen)


def _bits_equal(torch, what: str, got, want) -> None:
    if got.shape != want.shape or not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError(f"{what}: not bit-equal")


def _bf16_fl_kernels(torch, gen) -> None:
    """A bf16 S (the TPU kernel takes either type): every sweep, single and
    as a wave of 3, int32 and int64 ids, on both sides of the crossover,
    bit-equal to the fp32 kernel on the widened S and close to its plain
    version, the gathered sweep bit-equal to the full one."""
    from repro_torch.common import NEG_INF
    from repro_torch.kernels import ops
    from repro_torch.kernels.fl_gains import fl_gains_at_plain, fl_gains_plain

    for u, n in [(1000, 777), (333, 5000), (129, 1)]:
        for lead in ((), (3,)):
            sim = torch.rand(lead + (u, n), generator=gen, device="cuda").bfloat16()
            wide = sim.float()
            cm = 0.8 * torch.rand(lead + (u,), generator=gen, device="cuda")
            what = f"fl_gains bf16 {tuple(sim.shape)}"
            full = ops.fl_gains(sim, cm)
            _bits_equal(torch, f"{what} vs fp32 on the widened S", full, ops.fl_gains(wide, cm))
            check_close(what, full, fl_gains_plain(sim, cm), *FL_TOL, quiet=True)
            for b in range(lead[0] if lead else 0):
                _bits_equal(torch, f"{what} member {b}", full[b], ops.fl_gains(sim[b], cm[b]))
            for k in (1, 8, 100, 777):
                idx = torch.randint(-1, n, lead + (k,), generator=gen, device="cuda")
                got = ops.fl_gains_at(sim, cm, idx)
                _bits_equal(torch, f"{what} at k={k} vs fp32", got, ops.fl_gains_at(wide, cm, idx))
                _bits_equal(torch, f"{what} at k={k} int32", got,
                            ops.fl_gains_at(sim, cm, idx.to(torch.int32)))
                want = torch.where(idx < 0, NEG_INF, full.gather(-1, idx.clamp(min=0)))
                _bits_equal(torch, f"{what} at k={k} vs the full sweep", got, want)
                check_close(f"{what} at k={k}", got, fl_gains_at_plain(sim, cm, idx), *FL_TOL,
                            quiet=True)
    log("  ok  fl_gains / fl_gains_at on a bf16 S, single and waves of 3, k in (1, 8, 100, 777):"
        " bit-equal to the fp32 kernel on the widened S and to the full sweep, int32 = int64 "
        "ids, within FL_TOL of the plain versions")


def _check_subset(what: str, torch, got, full, idx) -> None:
    """A gathered sweep must equal the full sweep bit for bit, pads NEG_INF."""
    from repro_torch.common import NEG_INF

    keep = idx >= 0
    if not torch.equal(got[keep], full[idx[keep].long()]):
        raise AssertionError(f"{what}: not bit-equal to the full sweep")
    if not bool((got[~keep] == NEG_INF).all()):
        raise AssertionError(f"{what}: pads are not NEG_INF")


def phase_mf_kernels(torch, seed: int) -> None:
    from repro_torch.core import feature_source
    from repro_torch.kernels import ops
    from repro_torch.kernels.flmf_gains import flmf_gains_at_plain, flmf_gains_plain
    from repro_torch.kernels.gcmf_gains import gcmf_gains_at_plain, gcmf_gains_plain
    from repro_torch.kernels.similarity_kernel import _normalize

    log("== phase 3: matrix-free kernels vs plain, small and ragged shapes")
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    dev = "cuda"
    lam = torch.tensor(0.4, device=dev)
    for u, n, d in [(1000, 777, 130), (300, 1500, 512), (129, 1, 8), (1, 300, 13)]:
        x = torch.randn((u, d), generator=gen, device=dev)
        y = torch.randn((n, d), generator=gen, device=dev)
        cm = 0.8 * torch.rand((u,), generator=gen, device=dev)
        mask = (torch.rand((n,), generator=gen, device=dev) < 0.1).float()
        total = n * torch.rand((n,), generator=gen, device=dev)
        diag = torch.rand((n,), generator=gen, device=dev)
        sets = []
        for k in (1, 8, 100, 777):
            idx = torch.randint(0, n, (k,), generator=gen, device=dev)
            idx[::7] = -1  # padding slots, the first among them
            sets.append(idx)
        for metric in SIM_TOL:
            xm, ym = (_normalize(x), _normalize(y)) if metric == "cosine" else (x, y)
            xx, yy = (xm * xm).sum(1), (ym * ym).sum(1)
            full = ops.flmf_gains(xm, ym, xx, yy, cm, metric)
            torch.cuda.synchronize()
            check_close(f"flmf_gains {metric} ({u},{n},{d})", full,
                        flmf_gains_plain(xm, ym, xx, yy, cm, metric), *MF_TOL[metric])
            gfull = ops.gcmf_gains(ym, yy, mask, total, diag, lam, metric)
            torch.cuda.synchronize()
            check_close(f"gcmf_gains {metric} ({n},{d})", gfull,
                        gcmf_gains_plain(ym, yy, mask, total, diag, lam, metric), *MF_TOL[metric])
            for idx in sets:
                k = idx.shape[0]
                got = ops.flmf_gains_at(xm, ym, xx, yy, cm, idx, metric)
                torch.cuda.synchronize()
                _check_subset(f"flmf_gains_at {metric} k={k}", torch, got, full, idx)
                check_close(f"flmf_gains_at {metric} ({u},{n},{d}) k={k} (bit-equal to flmf_gains)",
                            got, flmf_gains_at_plain(xm, ym, xx, yy, cm, idx, metric),
                            *MF_TOL[metric])
                got = ops.gcmf_gains_at(ym, yy, mask, total, diag, lam, idx, metric)
                torch.cuda.synchronize()
                _check_subset(f"gcmf_gains_at {metric} k={k}", torch, got, gfull, idx)
                check_close(f"gcmf_gains_at {metric} ({n},{d}) k={k} (bit-equal to gcmf_gains)",
                            got, gcmf_gains_at_plain(ym, yy, mask, total, diag, lam, idx, metric),
                            *MF_TOL[metric])
    # gcmf at the edges of its 128-column blocks of selected columns: a
    # column lost or added at a block edge would move a gain by a whole term.
    # d = 130 (ragged across the 8-wide K strips), as tests/test_torch_gpu.py.
    # At d = 512 the two versions' fp32 roundings alone part beyond MF_TOL on
    # a few gains, whatever the block edges: signed dot products that cancel
    # to a gain near 0 (4.9e-4 at |A| = 128), and the euclidean self pair,
    # whose d2 residual 1 / (1 + sqrt(d2)) amplifies (4.4e-3 at |A| = 1);
    # PERF.md, open questions.
    n, d = 300, 130
    y = torch.randn((n, d), generator=gen, device=dev)
    total = n * torch.rand((n,), generator=gen, device=dev)
    diag = torch.rand((n,), generator=gen, device=dev)
    sets = []
    for k in (1, 8, 100, 777):
        idx = torch.randint(0, n, (k,), generator=gen, device=dev)
        idx[::7] = -1
        sets.append(idx)
    for metric in SIM_TOL:
        ym = _normalize(y) if metric == "cosine" else y
        yy = (ym * ym).sum(1)
        for a in (0, 1, 127, 128, 129, n):
            mask = _count_mask(torch, gen, n, a)
            args = (ym, yy, mask, total, diag, lam)
            gfull = ops.gcmf_gains(*args, metric)
            torch.cuda.synchronize()
            check_close(f"gcmf_gains {metric} ({n},{d}) |A| = {a}", gfull,
                        gcmf_gains_plain(*args, metric), *MF_TOL[metric], quiet=True)
            if a == 0 and not torch.equal(gfull, total - lam * diag):
                raise AssertionError(f"gcmf_gains {metric} ({n},{d}): |A| = 0 must give "
                                     "total - lam * diag")
            for idx in sets:
                got = ops.gcmf_gains_at(*args, idx, metric)
                torch.cuda.synchronize()
                _check_subset(f"gcmf_gains_at {metric} ({n},{d}) |A| = {a} k={idx.shape[0]}",
                              torch, got, gfull, idx)
                check_close(f"gcmf_gains_at {metric} |A| = {a} k={idx.shape[0]}", got,
                            gcmf_gains_at_plain(*args, idx, metric), *MF_TOL[metric], quiet=True)
    log(f"  ok  gcmf_gains / gcmf_gains_at ({n},{d}), every metric, |A| = 0, 1, 127, 128, 129, "
        f"{n}: within MF_TOL of their plain versions, gathered bit-equal to full at k = 1, 8, "
        "100, 777 with pads; total - lam * diag at |A| = 0")
    # flmf on rows that are not 16-byte aligned (the pipelined mainloop's
    # element-wise copies): bit-equal to the same sweep on aligned rows (the
    # 16-byte copies where d % 4 == 0), full and gathered
    u, n = UNALIGNED_ROWS
    for d in UNALIGNED_D:
        x = torch.randn((u, d), generator=gen, device=dev)
        y = torch.randn((n, d), generator=gen, device=dev)
        cm = 0.8 * torch.rand((u,), generator=gen, device=dev)
        idx = torch.randint(0, n, (77,), generator=gen, device=dev)
        idx[::7] = -1
        for metric in SIM_TOL:
            xm, ym = (_normalize(x), _normalize(y)) if metric == "cosine" else (x, y)
            xx, yy = (xm * xm).sum(1), (ym * ym).sum(1)
            xo, yo = _offset_rows(torch, xm), _offset_rows(torch, ym)
            full = ops.flmf_gains(xo, yo, xx, yy, cm, metric)
            got = ops.flmf_gains_at(xo, yo, xx, yy, cm, idx, metric)
            torch.cuda.synchronize()
            if not (torch.equal(full, ops.flmf_gains(xm, ym, xx, yy, cm, metric))
                    and torch.equal(got, ops.flmf_gains_at(xm, ym, xx, yy, cm, idx, metric))):
                raise AssertionError(f"flmf_gains {metric} ({u},{n},{d}): unaligned rows are not "
                                     "bit-equal to aligned ones")
            _check_subset(f"flmf_gains_at {metric} ({u},{n},{d}) unaligned", torch, got, full, idx)
    log(f"  ok  flmf_gains / flmf_gains_at on unaligned rows, ({u},{n}) at d in {UNALIGNED_D}, "
        "every metric: bit-equal to the same sweeps on aligned rows, gathered bit-equal to full")
    # the torch path of FeatureSource: subset sweeps bit-equal on the card too
    x = torch.randn((300, 130), generator=gen, device=dev)
    y = torch.randn((1500, 130), generator=gen, device=dev)
    cm = 0.5 * torch.rand((300,), generator=gen, device=dev)
    idx = torch.randint(0, 1500, (777,), generator=gen, device=dev)
    idx[::7] = -1
    for metric in SIM_TOL:
        src = feature_source(x, y, metric)
        _check_subset(f"FeatureSource.fl_gains_at {metric}", torch, src.fl_gains_at(cm, idx),
                      src.fl_gains(cm), idx)
    log("  ok  FeatureSource torch path: fl_gains_at bit-equal to fl_gains, all metrics")


def _replay_check(torch, name, fn_plain, kern, plain, max_steps=None,
                  gain_rtol=GAIN_RTOL) -> dict:
    """Hold the kernel path's ids against the plain path's.

    They must agree at every step before the first step where the plain
    path's top two gains lie within NEAR_TIE_REL of each other, and their
    gains must agree to ``gain_rtol`` over the agreeing prefix.  An exact
    tie (the Disparity family's all-zero first step) where both paths pick
    the same id is no near-tie: both take its first index.  The plain
    path's top two gains are found by replaying its selections through its
    own gains() sweep, up to the first disagreement; where there is none,
    up to ``max_steps`` steps (all of them by default)."""
    from repro_torch.common import NEG_INF

    ko, po = kern.order.cpu().numpy(), plain.order.cpu().numpy()
    kg, pg = kern.gains.cpu().numpy(), plain.gains.cpu().numpy()
    diff = np.nonzero(ko != po)[0]
    t_dis = int(diff[0]) if diff.size else None
    state = fn_plain.init_state()
    selected = torch.zeros((fn_plain.n,), dtype=torch.bool, device="cuda")
    t_tie, gap = None, None
    steps = int((po >= 0).sum())
    if t_dis is None and max_steps is not None:
        steps = min(steps, max_steps)
    for t in range(steps):
        g = torch.where(selected, NEG_INF, fn_plain.gains(state))
        g1, g2 = (float(v) for v in torch.topk(g, 2).values)
        if g1 - g2 <= NEAR_TIE_REL * abs(g1) and (g1 != g2 or t == t_dis):
            t_tie, gap = t, g1 - g2
            break
        if t_dis is not None and t >= t_dis:
            break
        j = int(po[t])
        state = fn_plain.update(state, torch.tensor([j], device="cuda"))
        selected[j] = True
    agree = len(ko) if t_dis is None else t_dis
    if t_dis is not None and (t_tie is None or t_dis < t_tie):
        raise AssertionError(
            f"{name}: kernel path picks {ko[t_dis]} at step {t_dis}, plain path {po[t_dis]}, "
            f"before any near-tie (first near-tie: {t_tie})"
        )
    rel = np.abs(kg[:agree] - pg[:agree]) > gain_rtol * np.abs(pg[:agree])
    if rel.any():
        t = int(np.nonzero(rel)[0][0])
        raise AssertionError(f"{name}: gains differ beyond rtol {gain_rtol} at step {t}: {kg[t]} vs {pg[t]}")
    log(f"  ok  {name}: ids agree over {agree} steps; first near-tie of the plain path "
        f"(top two within {NEAR_TIE_REL} rel): "
        f"{('none in ' + str(steps) + ' steps') if t_tie is None else t_tie}"
        + ("" if gap is None else f" (gap {gap:.3e})")
        + f"; first disagreement: "
        + ("none" if t_dis is None else f"{t_dis} (gains {kg[t_dis]!r} / {pg[t_dis]!r})"))
    return {"first_near_tie": t_tie, "near_tie_gap": gap, "first_disagreement": t_dis,
            "agreeing_steps": agree, "replayed_steps": steps,
            # the picks' gains where the paths part, kernel path first
            "gains_at_first_disagreement": None if t_dis is None else [float(kg[t_dis]), float(pg[t_dis])]}


def _timed_solve(torch, spec) -> tuple:
    from repro_torch.core import solve

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = solve(spec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, wall, torch.cuda.max_memory_allocated()


def phase_main(torch, args) -> dict:
    from repro_torch.core import (
        FacilityLocation, SelectionSpec, backend_name, create_kernel,
    )
    from repro_torch.kernels import ops
    from repro_torch.kernels.similarity_kernel import similarity_plain

    n, d = args.n, args.d
    log(f"== phase 4: main path, n={n}, d={d}, cosine, NaiveGreedy {args.naive_budget}, "
        f"LazyGreedy {args.lazy_budget}")
    x = gaussian_mixture(args.seed, n, d)
    out = {"n": n, "d": d, "naive_budget": args.naive_budget, "lazy_budget": args.lazy_budget}

    # ---- the main path, counted: counts to 0 just before, read just after
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    S = create_kernel(x, metric="cosine", use_pallas=True)
    torch.cuda.synchronize()
    out["create_kernel_s"] = time.perf_counter() - t0
    fn = FacilityLocation.from_kernel(S, use_kernel=None)
    name = backend_name(fn)
    if name != "cuda-fl":
        raise AssertionError(f"backend_name is {name!r}, expected 'cuda-fl'")
    runs = {}
    # fl_gains_at's launches by width k (LazyGreedy's levels), beside its count
    widths = collections.Counter()
    fl_gains_at = counting_widths(ops, "fl_gains_at", 2, widths)
    try:
        for opt, budget in (("NaiveGreedy", args.naive_budget), ("LazyGreedy", args.lazy_budget)):
            runs[opt] = _timed_solve(torch, SelectionSpec(fn, budget, opt))
    finally:
        ops.fl_gains_at = fl_gains_at
    launches = {k: ops.LAUNCHES[k] for k in ("similarity", "fl_gains", "fl_gains_at")}
    log(f"  backend_name = {name}; launches on the main path: {launches}")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main path")
    out["launches"] = launches
    out["fl_gains_at_widths"] = dict(sorted(widths.items()))
    if sum(widths.values()) != launches["fl_gains_at"]:
        raise AssertionError(f"fl_gains_at widths {out['fl_gains_at_widths']} do not add up to "
                             f"its {launches['fl_gains_at']} launches")
    log(f"  fl_gains_at launches by width k: {out['fl_gains_at_widths']}")
    log(f"  create_kernel: {out['create_kernel_s']:.3f} s (host clock, synchronized)")

    # ---- outputs: S against the plain version on its first and last rows
    rows = min(1024, n)
    for label, sl in (("first", slice(0, rows)), ("last", slice(n - rows, n))):
        want = similarity_plain(torch.as_tensor(x[sl], device="cuda"),
                                torch.as_tensor(x, device="cuda"), "cosine")
        out[f"S_{label}_rows_err"] = check_close(
            f"S {label} {rows} rows vs similarity_plain", S[sl], want, 0.0, 1e-5)
        del want
    out["S_max_abs_err"] = max(out["S_first_rows_err"], out["S_last_rows_err"])

    # ---- the same solves on the plain path, compared step by step
    fn_plain = FacilityLocation.from_kernel(S, use_kernel=False)
    before = dict(ops.LAUNCHES)
    for opt, budget in (("NaiveGreedy", args.naive_budget), ("LazyGreedy", args.lazy_budget)):
        kern, wall, peak = runs[opt]
        plain, pwall, ppeak = _timed_solve(torch, SelectionSpec(fn_plain, budget, opt))
        for r in (kern, plain):
            if not (bool(r.gains.isfinite().all()) and r.order.shape == (budget,)):
                raise AssertionError(f"{opt}: malformed result")
        info = _replay_check(torch, opt, fn_plain, kern, plain)
        info.update(
            n_evals=int(kern.n_evals), value=float(kern.value), wall_s=wall, peak_bytes=peak,
            plain_n_evals=int(plain.n_evals), plain_value=float(plain.value),
            plain_wall_s=pwall, plain_peak_bytes=ppeak,
            selected=int((kern.order >= 0).sum()),
        )
        log(f"  {opt}: kernel path n_evals={info['n_evals']} f(A)={info['value']:.6f} "
            f"wall={wall:.3f} s peak={peak / 2**30:.2f} GiB; plain path "
            f"n_evals={info['plain_n_evals']} f(A)={info['plain_value']:.6f} "
            f"wall={pwall:.3f} s peak={ppeak / 2**30:.2f} GiB")
        out[opt] = info
    if ops.LAUNCHES != before:
        raise AssertionError("the plain path launched a kernel")

    naive_ids = runs["NaiveGreedy"][0].order.cpu().numpy()
    lazy_ids = runs["LazyGreedy"][0].order.cpu().numpy()
    common = min(len(naive_ids), len(lazy_ids))
    diff = np.nonzero(naive_ids[:common] != lazy_ids[:common])[0]
    out["lazy_vs_naive_first_difference"] = int(diff[0]) if diff.size else None
    log(f"  LazyGreedy vs NaiveGreedy over the first {common} steps: first difference at "
        f"{'none' if not diff.size else int(diff[0])}")
    log(f"  NaiveGreedy ids[:{common}] = {naive_ids[:common].tolist()}")
    log(f"  LazyGreedy  ids[:{common}] = {lazy_ids[:common].tolist()}")
    out["naive_ids"] = naive_ids.tolist()
    out["naive_gains"] = runs["NaiveGreedy"][0].gains.cpu().tolist()
    out["lazy_ids"] = lazy_ids.tolist()
    return out, fn, runs["NaiveGreedy"][0]


def _bf16_fl_times(torch, sim, cm, gen, reps: int) -> tuple[dict, dict]:
    """Rows 2 and 3 on phase 4's S rounded to bf16 (u = n): the full sweep
    and the gathered one at k = 8, each against its plain version, bit-equal
    to the fp32 kernel on the widened S, single and as a wave of two members
    over the one S (member stride 0), timed beside their byte bound (S read
    at 2 bytes an element)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.fl_gains import fl_gains_at_plain, fl_gains_plain

    n = sim.shape[1]
    sim16 = sim.bfloat16()
    wide = sim16.float()
    wave, wcm = sim16.expand(2, -1, -1), cm.expand(2, -1)
    full = ops.fl_gains(sim16, cm)
    _bits_equal(torch, "fl_gains bf16 at u = n vs fp32 on the widened S", full,
                ops.fl_gains(wide, cm))
    err = check_close(f"fl_gains bf16 ({n},{n}) vs fl_gains_plain", full,
                      fl_gains_plain(sim16, cm), *FL_TOL)
    _bits_equal(torch, "fl_gains bf16 wave of 2", ops.fl_gains(wave, wcm), full.expand(2, -1))
    b_ms, b_by = bound(3.0 * n * n, 2.0 * n * n + 4.0 * 2 * n)
    full_row = {"shape": f"sim ({n},{n}) bf16, curmax ({n},) -> ({n},)", "max_abs_err": err,
                "ms": cuda_ms(torch, lambda: ops.fl_gains(sim16, cm), reps),
                "plain_ms": cuda_ms(torch, lambda: fl_gains_plain(sim16, cm),
                                    max(2, reps // 10), warmup=1),
                "wave2_ms": cuda_ms(torch, lambda: ops.fl_gains(wave, wcm), max(2, reps // 5)),
                "bound_ms": b_ms, "bound_by": b_by, "bit_equal_to_fp32_on_widened": True}
    sets = [torch.randperm(n, generator=gen, device="cuda")[:8] for _ in range(64)]
    got = ops.fl_gains_at(sim16, cm, sets[0])
    _bits_equal(torch, "fl_gains_at bf16 k=8 vs fp32 on the widened S", got,
                ops.fl_gains_at(wide, cm, sets[0]))
    _bits_equal(torch, "fl_gains_at bf16 k=8 vs the full sweep", got, full[sets[0]])
    err = check_close(f"fl_gains_at bf16 ({n},{n}) k=8 vs fl_gains_at_plain", got,
                      fl_gains_at_plain(sim16, cm, sets[0]), *FL_TOL)
    wsets = [s.expand(2, -1) for s in sets]
    _bits_equal(torch, "fl_gains_at bf16 wave of 2", ops.fl_gains_at(wave, wcm, wsets[0]),
                got.expand(2, -1))
    it, wit = itertools.cycle(sets), itertools.cycle(wsets)
    b_ms, b_by = bound(3.0 * n * 8, 2.0 * n * 8 + 4.0 * n + 12.0 * 8)
    at_row = {"shape": f"sim ({n},{n}) bf16, curmax ({n},), idx (8,) int64 -> (8,)",
              "max_abs_err": err, "ms": cuda_ms(torch, lambda: ops.fl_gains_at(sim16, cm, next(it)),
                                                reps),
              "plain_ms": cuda_ms(torch, lambda: fl_gains_at_plain(sim16, cm, next(it)),
                                  max(2, reps // 10), warmup=1),
              "wave2_ms": cuda_ms(torch, lambda: ops.fl_gains_at(wave, wcm, next(wit)), reps),
              "bound_ms": b_ms, "bound_by": b_by, "bit_equal_to_fp32_on_widened": True}
    for name, r in (("fl_gains", full_row), ("fl_gains_at k=8", at_row)):
        log(f"  {name} bf16 {n}x{n}: kernel {r['ms']:.4f} ms (a wave of 2 over the one S "
            f"{r['wave2_ms']:.4f}), plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']}); bit-equal to the fp32 kernel on the widened S")
    return full_row, at_row


def phase_times(torch, args, fn, naive_res, main: dict) -> list[dict]:
    from repro_torch.core import FacilityLocation, FLState
    from repro_torch.kernels import ops
    from repro_torch.kernels.fl_gains import (
        FULL_SWEEP_RATIO, fl_gains_at_plain, fl_gains_plain, sweeps_every_column,
    )
    from repro_torch.kernels.similarity_kernel import _normalize, similarity_plain

    log("== phase 5: times at the main path's shapes (CUDA events)")
    n, d = args.n, args.d
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    x = torch.as_tensor(gaussian_mixture(args.seed, n, d), device="cuda")
    reps = args.reps
    sim = fn.sim
    launches = main["launches"]

    # similarity: the main path's cosine; library = one addmm on normalised rows
    sim_ms = cuda_ms(torch, lambda: ops.similarity(x, x, "cosine"), max(2, reps // 10), warmup=1)
    plain_ms = cuda_ms(torch, lambda: similarity_plain(x, x, "cosine"), max(2, reps // 10), warmup=1)
    xn = _normalize(x)
    half = torch.full((1, 1), 0.5, device="cuda")
    lib_ms = cuda_ms(torch, lambda: torch.addmm(half, xn, xn.T, beta=1.0, alpha=0.5),
                     max(2, reps // 10), warmup=1)
    dot_ms = cuda_ms(torch, lambda: ops.similarity(x, x, "dot"), max(2, reps // 10), warmup=1)
    matmul_ms = cuda_ms(torch, lambda: torch.matmul(x, x.T), max(2, reps // 10), warmup=1)
    del xn
    b_ms, b_by = bound(2.0 * n * n * d, 4.0 * (2 * n * d + n * n))
    rows = [{
        "name": "similarity", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/similarity.cu",
        "replaces": "src/repro/kernels/similarity_kernel.py:73",
        "shape": f"({n},{d})x({n},{d})->({n},{n}) cosine",
        "launches": launches["similarity"], "launches_on_path": launches["similarity"],
        "max_abs_err": main["S_max_abs_err"],
        "ms": sim_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms, "library_call": "torch.addmm(0.5, xn, xn.T, alpha=0.5)",
        "dot_ms": dot_ms, "dot_library_ms": matmul_ms,
    }]
    log(f"  similarity cosine {n}x{n}x{d}: kernel {sim_ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"addmm {lib_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}); dot: kernel {dot_ms:.3f} ms, "
        f"matmul {matmul_ms:.3f} ms")

    # fl_gains at u = n: curmax of the naive selection, a state the path reaches
    order = naive_res.order[naive_res.order >= 0].long()
    cm = sim[:, order].amax(dim=1).contiguous()
    full = ops.fl_gains(sim, cm)
    fl_err = check_close(f"fl_gains ({n},{n}) vs fl_gains_plain", full, fl_gains_plain(sim, cm), *FL_TOL)
    fl_ms = cuda_ms(torch, lambda: ops.fl_gains(sim, cm), reps)
    fl_plain_ms = cuda_ms(torch, lambda: fl_gains_plain(sim, cm), max(2, reps // 10), warmup=1)
    fn_plain, state = FacilityLocation(sim=sim, n=n, use_kernel=False), FLState(cm, n)
    torch_ms = cuda_ms(torch, lambda: fn_plain.gains(state), max(2, reps // 10), warmup=1)
    b_ms, b_by = bound(3.0 * n * n, 4.0 * (n * n + 2 * n))
    rows.append({
        "name": "fl_gains", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fl_gains.cu",
        "replaces": "src/repro/kernels/fl_gains.py:51",
        "shape": f"sim ({n},{n}), curmax ({n},) -> ({n},)",
        "launches": launches["fl_gains"], "launches_on_path": launches["fl_gains"],
        "max_abs_err": fl_err, "bit_equal_to_plain": bool(torch.equal(full, fl_gains_plain(sim, cm))),
        "ms": fl_ms, "plain_ms": fl_plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "torch_backend_ms": torch_ms,
    })
    log(f"  fl_gains {n}x{n}: kernel {fl_ms:.3f} ms, plain {fl_plain_ms:.3f} ms, torch backend "
        f"sweep {torch_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})")

    # fl_gains_at: a fresh random index set per launch, so L2 holds no column;
    # int64 ids (the engine's, taken as they are) and int32 ids
    at = {}
    for k in (8, 512):
        sets = [torch.randperm(n, generator=gen, device="cuda")[:k] for _ in range(64)]
        got = ops.fl_gains_at(sim, cm, sets[0])
        err = check_close(f"fl_gains_at ({n},{n}) k={k} vs fl_gains_at_plain", got,
                          fl_gains_at_plain(sim, cm, sets[0]), *FL_TOL)
        if not torch.equal(got, full[sets[0]]):
            raise AssertionError(f"fl_gains_at k={k}: not bit-equal to fl_gains")
        it = itertools.cycle(sets)
        k_ms = cuda_ms(torch, lambda: ops.fl_gains_at(sim, cm, next(it)), reps)
        it32 = itertools.cycle([s.to(torch.int32) for s in sets])
        k_ms32 = cuda_ms(torch, lambda: ops.fl_gains_at(sim, cm, next(it32)), reps)
        k_plain = cuda_ms(torch, lambda: fl_gains_at_plain(sim, cm, next(it)),
                          max(2, reps // 10), warmup=1)
        kb_ms, kb_by = bound(3.0 * n * k, 4.0 * (n * k + n + 3 * k))
        at[k] = {"ms": k_ms, "ms_int32": k_ms32, "plain_ms": k_plain, "bound_ms": kb_ms,
                 "bound_by": kb_by, "max_abs_err": err}
        if k == 8:  # the host's cost of one call, beside its device time
            at[k]["host_us"] = host_us(torch, lambda: ops.fl_gains_at(sim, cm, sets[0]))
        log(f"  fl_gains_at {n}x{n} k={k}: kernel {k_ms:.4f} ms (int64 ids; int32 {k_ms32:.4f})"
            + (f", host {at[k]['host_us']:.1f} us per call" if k == 8 else "")
            + f", plain {k_plain:.3f} ms, bound {kb_ms:.5f} ms ({kb_by}); bit-equal to fl_gains")
    # every width phase 4's LazyGreedy launched, with its int64 ids: launches x
    # time per width, against the full sweep's time past the crossover
    by_width = {}
    for k, count in main["fl_gains_at_widths"].items():
        sets = [torch.randperm(n, generator=gen, device="cuda")[:k] for _ in range(16)]
        if not torch.equal(ops.fl_gains_at(sim, cm, sets[0]), full[sets[0]]):
            raise AssertionError(f"fl_gains_at k={k}: not bit-equal to fl_gains")
        it = itertools.cycle(sets)
        kb_ms, kb_by = bound(3.0 * n * k, 4.0 * (n * k + n + 3 * k))
        k_ms = cuda_ms(torch, lambda: ops.fl_gains_at(sim, cm, next(it)), max(3, reps // 5))
        by_width[k] = {"launches": count, "ms": k_ms, "bound_ms": kb_ms, "bound_by": kb_by,
                       "sweeps_every_column": sweeps_every_column(k, n)}
    log("  fl_gains_at by width k on phase 4's LazyGreedy, int64 ids (launches x ms = total ms): "
        + "; ".join(f"k={k}: {w['launches']} x {w['ms']:.4f} = {w['launches'] * w['ms']:.1f}"
                    for k, w in by_width.items())
        + f"; in all {sum(w['launches'] * w['ms'] for w in by_width.values()):.1f} ms, of it over "
        f"the bound {sum(w['launches'] * (w['ms'] - w['bound_ms']) for w in by_width.values()):.1f} ms")
    wide = {k: w["ms"] / fl_ms for k, w in by_width.items() if k >= 4096}
    log(f"  fl_gains_at past k = 4096 against the full sweep's {fl_ms:.3f} ms: "
        + ", ".join(f"k={k}: {r:.3f}x" for k, r in wide.items())
        + f"; the crossover rule (a constant): the full sweep and a gather from k >= "
        f"{FULL_SWEEP_RATIO} n")
    rows.append({
        "name": "fl_gains_at", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fl_gains.cu",
        "replaces": "src/repro/kernels/fl_gains.py:93",
        "shape": f"sim ({n},{n}), curmax ({n},), idx (8,) int64 -> (8,)",
        "launches": launches["fl_gains_at"], "launches_on_path": launches["fl_gains_at"],
        "max_abs_err": at[8]["max_abs_err"],
        "ms": at[8]["ms"], "plain_ms": at[8]["plain_ms"], "bound_ms": at[8]["bound_ms"],
        "bound_by": at[8]["bound_by"], "library_ms": None, "ms_int32": at[8]["ms_int32"],
        "host_us": at[8]["host_us"], "k512": at[512], "by_width": by_width,
    })
    rows[-2]["bf16"], rows[-1]["bf16"] = _bf16_fl_times(torch, sim, cm, gen, reps)

    # the KERNEL_MIN_N gate: kernel vs the torch backend's sweep at n = 4096
    g_n = 4096
    gsim = torch.rand((g_n, g_n), generator=gen, device="cuda")
    gcm = 0.8 * torch.rand((g_n,), generator=gen, device="cuda")
    gate_k = cuda_ms(torch, lambda: ops.fl_gains(gsim, gcm), reps)
    gfn, gstate = FacilityLocation(sim=gsim, n=g_n, use_kernel=False), FLState(gcm, g_n)
    gate_t = cuda_ms(torch, lambda: gfn.gains(gstate), reps)
    gate_p = cuda_ms(torch, lambda: fl_gains_plain(gsim, gcm), max(2, reps // 10))
    log(f"  KERNEL_MIN_N gate, fl_gains at u=n={g_n}: kernel {gate_k:.4f} ms, torch backend "
        f"sweep {gate_t:.4f} ms, fl_gains_plain {gate_p:.3f} ms")
    main["kernel_min_n_gate"] = {"n": g_n, "kernel_ms": gate_k, "torch_ms": gate_t,
                                 "plain_ms": gate_p}
    return rows


def _mf_bytes(*tensors) -> float:
    return float(sum(4 * t.numel() for t in tensors))


def _time_subsets(torch, name, kernel, plain, library, full, n, reps, gen, work, tol,
                  work_all=None, library_selected=None):
    """Time a gathered sweep at k = 8 and 512 on fresh index sets (so no
    candidate row stays in L2), held bit-equal to the full sweep.  ``work(k)``
    gives the (operations, bytes) the function needs, ``work_all(k)`` those
    of a sweep over every column where the data lets it need fewer;
    ``library_selected`` is a second library call, over the selected
    columns only."""
    out = {}
    for k in (8, 512):
        sets = [torch.randperm(n, generator=gen, device="cuda")[:k].to(torch.int32)
                for _ in range(64)]
        got = kernel(sets[0])
        _check_subset(f"{name} k={k}", torch, got, full, sets[0])
        err = check_close(f"{name} k={k} vs plain", got, plain(sets[0]), *tol)
        it = itertools.cycle(sets)
        b_ms, b_by = bound(*work(k))
        out[k] = {"ms": cuda_ms(torch, lambda: kernel(next(it)), reps),
                  "plain_ms": cuda_ms(torch, lambda: plain(next(it)), 2, warmup=1),
                  "library_ms": cuda_ms(torch, lambda: library(next(it)), max(2, reps // 10)),
                  "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err}
        if work_all is not None:
            out[k]["bound_all_columns_ms"] = bound(*work_all(k))[0]
        if library_selected is not None:
            check_close(f"{name} k={k}: the selected-columns library call", library_selected(sets[0]),
                        got, *tol, quiet=True)
            out[k]["selected_library_ms"] = cuda_ms(torch, lambda: library_selected(next(it)), reps)
        log(f"  {name} k={k}: kernel {out[k]['ms']:.4f} ms, plain {out[k]['plain_ms']:.3f} ms, "
            f"library {out[k]['library_ms']:.4f} ms"
            + ("" if library_selected is None
               else f", over the selected columns {out[k]['selected_library_ms']:.4f} ms")
            + f", bound {b_ms:.5f} ms ({b_by}"
            + ("" if work_all is None else f"; all columns {out[k]['bound_all_columns_ms']:.5f} ms")
            + "); bit-equal to the full sweep")
    return out


def phase_mf_times(torch, args, naive_res) -> list[dict]:
    from repro_torch.core import FacilityLocationMF, GraphCutMF, feature_source
    from repro_torch.kernels import ops
    from repro_torch.kernels.flmf_gains import flmf_gains_at_plain, flmf_gains_plain
    from repro_torch.kernels.gcmf_gains import gcmf_gains_at_plain, gcmf_gains_plain
    from repro_torch.kernels.select_cols import select_cols
    from repro_torch.kernels.similarity_kernel import inv_two_sigma_sq, metric_epilogue

    log("== phase 5 (matrix-free kernels): times at the matrix-free path's shapes")
    n, d, reps = args.n, args.d, args.reps
    big = max(3, reps // 10)  # launches of the kernels that take tens of ms
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 3)
    x = torch.as_tensor(gaussian_mixture(args.seed, n, d), device="cuda")
    # a state the path reaches: the first picks of phase 4's NaiveGreedy
    picks = naive_res.order[naive_res.order >= 0][: MF_NAIVE_BUDGET].long()

    # ---- flmf at the million-point shape (phase 6 b), first sweep
    y = gaussian_mixture_cuda(torch, args.seed, args.mf_n, d)
    src = feature_source(y[:: args.mf_n // MF_U][: MF_U], y, "rbf")
    u = src.n_rows
    cm0 = torch.zeros((u,), device="cuda")
    fl_args = (src.x, src.y, src.xx, src.yy, cm0, "rbf")
    full = ops.flmf_gains(*fl_args)
    big_err = check_close(f"flmf_gains ({u},{args.mf_n},{d}) rbf vs plain", full,
                          flmf_gains_plain(*fl_args), *MF_TOL["rbf"])
    big_t = {"ms": cuda_ms(torch, lambda: ops.flmf_gains(*fl_args), reps),
             "plain_ms": cuda_ms(torch, lambda: flmf_gains_plain(*fl_args), 1, warmup=1),
             "library_ms": cuda_ms(torch, lambda: src.fl_gains(cm0), big, warmup=1)}
    big_t["bound_ms"], big_t["bound_by"] = bound(
        2.0 * u * args.mf_n * d, _mf_bytes(src.x, src.y, src.xx, src.yy, cm0) + 4.0 * args.mf_n)
    log(f"  flmf_gains rbf u={u} n={args.mf_n}: kernel {big_t['ms']:.3f} ms, plain "
        f"{big_t['plain_ms']:.1f} ms, torch path (library) {big_t['library_ms']:.3f} ms, bound "
        f"{big_t['bound_ms']:.3f} ms ({big_t['bound_by']})")
    del y, src, full

    # ---- flmf at u = n (phase 6 a), with the curmax of the first picks
    fl = FacilityLocationMF.from_features(x, metric="cosine", use_kernel=False)
    state = fl.init_state()
    for j in picks:
        state = fl.update(state, j.reshape(1))
    src, cm = fl.src, state.curmax
    fl_args = (src.x, src.y, src.xx, src.yy, cm, "cosine")
    full = ops.flmf_gains(*fl_args)
    err = check_close(f"flmf_gains ({n},{n},{d}) cosine vs plain", full, flmf_gains_plain(*fl_args),
                      *MF_TOL["cosine"])
    sq = {"ms": cuda_ms(torch, lambda: ops.flmf_gains(*fl_args), big),
          "plain_ms": cuda_ms(torch, lambda: flmf_gains_plain(*fl_args), 1, warmup=1),
          "library_ms": cuda_ms(torch, lambda: src.fl_gains(cm), big, warmup=1),
          "max_abs_err": err}
    sq["bound_ms"], sq["bound_by"] = bound(2.0 * n * n * d, _mf_bytes(src.x, cm) + 4.0 * n)
    log(f"  flmf_gains cosine u=n={n}: kernel {sq['ms']:.3f} ms, plain {sq['plain_ms']:.1f} ms, "
        f"torch path (library) {sq['library_ms']:.3f} ms, bound {sq['bound_ms']:.3f} ms "
        f"({sq['bound_by']})")
    fl_at = _time_subsets(
        torch, f"flmf_gains_at ({n},{n},{d}) cosine",
        lambda idx: ops.flmf_gains_at(*fl_args[:5], idx, "cosine"),
        lambda idx: flmf_gains_at_plain(*fl_args[:5], idx, "cosine"),
        lambda idx: src.fl_gains_at(cm, idx), full, n, reps, gen,
        work=lambda k: (2.0 * n * d * k, _mf_bytes(src.x, cm) + 4.0 * (d + 2) * k),
        tol=MF_TOL["cosine"])

    # ---- the MF_KERNEL_MIN_N gate: flmf kernel vs the torch path, u = n
    gate = {}
    for g_n in (1024, 4096):
        gsrc = feature_source(torch.randn((g_n, d), generator=gen, device="cuda"), metric="cosine")
        gcm = 0.5 * torch.rand((g_n,), generator=gen, device="cuda")
        gate[g_n] = {
            "kernel_ms": cuda_ms(torch, lambda: ops.flmf_gains(
                gsrc.x, gsrc.y, gsrc.xx, gsrc.yy, gcm, "cosine"), reps),
            "torch_ms": cuda_ms(torch, lambda: gsrc.fl_gains(gcm), reps),
        }
        log(f"  MF_KERNEL_MIN_N gate, flmf_gains cosine u=n={g_n}, d={d}: kernel "
            f"{gate[g_n]['kernel_ms']:.4f} ms, torch path {gate[g_n]['torch_ms']:.4f} ms")

    # ---- gcmf at n (phase 6 c), with the mask of the same picks
    gc = GraphCutMF.from_features(x, lam=0.4, metric="cosine", use_kernel=False)
    mask = torch.zeros((n,), device="cuda").index_fill_(0, picks, 1.0)
    gsrc = gc.src
    gc_args = (gsrc.y, gsrc.yy, mask, gc.total, gc.diag, gc.lam, "cosine")
    gfull = ops.gcmf_gains(*gc_args)
    gerr = check_close(f"gcmf_gains ({n},{d}) cosine vs plain", gfull, gcmf_gains_plain(*gc_args),
                       *MF_TOL["cosine"])
    inv = inv_two_sigma_sq(d, None)

    def gc_library(rows=None):
        # one torch.mm of the candidate rows against the ground, then the masked sum
        yj = gsrc.y if rows is None else gsrc.y[rows]
        yyj = gsrc.yy if rows is None else gsrc.yy[rows]
        s = metric_epilogue(torch.mm(yj, gsrc.y.T), yyj, gsrc.yy, "cosine", inv)
        tot = gc.total if rows is None else gc.total[rows]
        dg = gc.diag if rows is None else gc.diag[rows]
        return tot - gc.lam * (2.0 * (s @ mask) + dg)

    def gc_library_selected(rows=None):
        # one torch.mm of the candidate rows against the selected rows only,
        # then the mask-weighted sum over them
        yj = gsrc.y if rows is None else gsrc.y[rows]
        yyj = gsrc.yy if rows is None else gsrc.yy[rows]
        s = metric_epilogue(torch.mm(yj, gsrc.y[picks].T), yyj, gsrc.yy[picks], "cosine", inv)
        tot = gc.total if rows is None else gc.total[rows]
        dg = gc.diag if rows is None else gc.diag[rows]
        return tot - gc.lam * (2.0 * (s @ mask[picks]) + dg)

    check_close("the selected-columns library call vs the gcmf kernel", gc_library_selected(),
                gfull, *MF_TOL["cosine"])
    n_sel = int(picks.numel())
    gq = {"ms": cuda_ms(torch, lambda: ops.gcmf_gains(*gc_args), big),
          "plain_ms": cuda_ms(torch, lambda: gcmf_gains_plain(*gc_args), 1, warmup=1),
          "library_ms": cuda_ms(torch, gc_library, big, warmup=1),
          "selected_library_ms": cuda_ms(torch, gc_library_selected, reps),
          "select_cols_ms": cuda_ms(torch, lambda: select_cols(mask, "nonzero"), reps),
          "max_abs_err": gerr, "selected": n_sel}
    # the function needs the |A| selected columns only
    gq["bound_ms"], gq["bound_by"] = bound(
        2.0 * n * n_sel * d, _mf_bytes(gsrc.y, mask, gc.total, gc.diag) + 4.0 * n)
    gq["bound_full_ms"] = bound(2.0 * n * n * d, 0.0)[0]
    log(f"  gcmf_gains cosine n={n}, |A|={n_sel}: kernel {gq['ms']:.4f} ms, plain "
        f"{gq['plain_ms']:.1f} ms, torch.mm + mask sum (library) {gq['library_ms']:.3f} ms, "
        f"over the selected columns {gq['selected_library_ms']:.4f} ms, bound "
        f"{gq['bound_ms']:.4f} ms ({gq['bound_by']}; all n columns: {gq['bound_full_ms']:.3f} ms); "
        f"of its time the compaction {gq['select_cols_ms']:.4f} ms")
    gc_at = _time_subsets(
        torch, f"gcmf_gains_at ({n},{d}) cosine",
        lambda idx: ops.gcmf_gains_at(*gc_args[:6], idx, "cosine"),
        lambda idx: gcmf_gains_at_plain(*gc_args[:6], idx, "cosine"),
        lambda idx: gc_library(idx.long()), gfull, n, reps, gen,
        work=lambda k: (2.0 * n_sel * d * k, _mf_bytes(mask) + 4.0 * n_sel * d + 4.0 * (d + 4) * k),
        tol=MF_TOL["cosine"], library_selected=lambda idx: gc_library_selected(idx.long()))

    def row(name, cu, line, shape, t, extra):
        return {"name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{cu}",
                "replaces": f"src/repro/kernels/{line}", "shape": shape, "launches": None,
                "max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"], **extra}

    big_t["max_abs_err"] = big_err
    return [
        row("flmf_gains", "flmf_gains.cu", "flmf_gains.py:92",
            f"x ({u},{d}), y ({args.mf_n},{d}), rbf -> ({args.mf_n},)", big_t,
            {"library_call": "FeatureSource.fl_gains (torch.matmul tiles + clamp + sum)",
             "u_eq_n": {"shape": f"({n},{d}) both sides, cosine", **sq},
             "mf_kernel_min_n_gate": gate}),
        row("flmf_gains_at", "flmf_gains.cu", "flmf_gains.py:148",
            f"x ({n},{d}), y ({n},{d}), cosine, idx (8,) -> (8,)", fl_at[8],
            {"library_call": "FeatureSource.fl_gains_at", "k512": fl_at[512]}),
        row("gcmf_gains", "gcmf_gains.cu", "gcmf_gains.py:98",
            f"y ({n},{d}), cosine, |A| = {n_sel} -> ({n},)", gq,
            {"library_call": "torch.mm(y, y.T) + epilogue + masked sum",
             "selected_library_call": "torch.mm(y, y[A].T) + epilogue + @ m[A]",
             **{k: gq[k] for k in ("selected_library_ms", "select_cols_ms", "bound_full_ms")}}),
        row("gcmf_gains_at", "gcmf_gains.cu", "gcmf_gains.py:163",
            f"y ({n},{d}), cosine, |A| = {n_sel}, idx (8,) -> (8,)", gc_at[8],
            {"library_call": "torch.mm(y[idx], y.T) + epilogue + masked sum",
             "selected_library_call": "torch.mm(y[idx], y[A].T) + epilogue + @ m[A]",
             "selected_library_ms": gc_at[8]["selected_library_ms"], "k512": gc_at[512]}),
    ]


def _solve_pair(torch, label, fn_kern, fn_plain, budget, opt, max_replay, gain_rtol=GAIN_RTOL,
             **stops) -> tuple[dict, object, object]:
    """Solve on the kernel path and on the plain path (stop rules ``stops``
    over the family's defaults), and hold them together."""
    from repro_torch.core import SelectionSpec, backend_name
    from repro_torch.kernels import ops

    if backend_name(fn_plain) != "torch" or not backend_name(fn_kern).startswith("cuda-"):
        raise AssertionError(f"{label}: backends {backend_name(fn_kern)} / {backend_name(fn_plain)}")
    start = dict(ops.LAUNCHES)
    kern, wall, peak = _timed_solve(torch, SelectionSpec(fn_kern, budget, opt, **stops))
    before = dict(ops.LAUNCHES)
    plain, pwall, ppeak = _timed_solve(torch, SelectionSpec(fn_plain, budget, opt, **stops))
    for r in (kern, plain):
        if not (bool(r.gains.isfinite().all()) and r.order.shape == (budget,)):
            raise AssertionError(f"{label}: malformed result")
    info = _replay_check(torch, label, fn_plain, kern, plain, max_steps=max_replay,
                         gain_rtol=gain_rtol)
    if ops.LAUNCHES != before:
        raise AssertionError(f"{label}: the plain path launched a kernel")
    info.update(
        launches={k: v - start[k] for k, v in before.items() if v != start[k]},
        backend=backend_name(fn_kern), n_evals=int(kern.n_evals), value=float(kern.value),
        wall_s=wall, peak_bytes=peak, plain_n_evals=int(plain.n_evals),
        plain_value=float(plain.value), plain_wall_s=pwall, plain_peak_bytes=ppeak,
        selected=int((kern.order >= 0).sum()),
    )
    log(f"  {label}: kernel path ({info['backend']}, launches {info['launches']}) "
        f"n_evals={info['n_evals']} "
        f"f(A)={info['value']:.6f} wall={wall:.3f} s peak={peak / 2**20:.1f} MiB; plain path "
        f"n_evals={info['plain_n_evals']} f(A)={info['plain_value']:.6f} wall={pwall:.3f} s "
        f"peak={ppeak / 2**20:.1f} MiB")
    return info, kern, plain


def _lazy_levels_apart(torch, label, fns, budget, screen_k=8, must_part=True) -> dict | None:
    """Find the first lazy level where two LazyGreedy runs decide apart.

    Reruns each of ``fns`` with its sweeps recorded, rebuilds every step's
    levels (the stale bounds, the best fresh gain ``best`` and the largest
    stale bound left ``rest`` after each level) exactly as the engine
    computes them, and checks that the rebuilt accept tests (``best >= rest
    - 1e-6``) end each step where the engine ended it.  Returns the first
    step whose level count differs between the runs, with both runs' accept
    tests at the level where one of them stopped; on both, best and rest
    must lie within GC_GAIN_RTOL of each other there (a decision within the
    gains' bar of its threshold, not a gain apart).  Where no step's level
    count differs, raises, or returns None when not ``must_part``."""
    from repro_torch.common import NEG_INF
    from repro_torch.core import SelectionSpec, solve
    from repro_torch.core.optimizers import greedy

    full, part, stop = greedy.full_sweep_wave, greedy.partial_sweep_wave, greedy._should_stop
    runs = []
    for fn in fns:
        rec = {"levels": [[]]}  # per step, the (idx, gains) of each level

        # a sequential solve is the engine's one-member wave
        def rec_full(f, s, rec=rec):
            g = full(f, s)
            rec.setdefault("init", g[0].float().cpu())  # the engine's initial bounds
            return g

        def rec_part(f, s, idx, rec=rec):
            g = part(f, s, idx)
            rec["levels"][-1].append((idx[0].long().cpu(), g[0].float().cpu()))
            return g

        def rec_stop(*a, rec=rec):
            rec["levels"].append([])
            return stop(*a)

        greedy.full_sweep_wave, greedy.partial_sweep_wave, greedy._should_stop = (
            rec_full, rec_part, rec_stop)
        try:
            res = solve(SelectionSpec(fn, budget, "LazyGreedy", screen_k=screen_k))
        finally:
            greedy.full_sweep_wave, greedy.partial_sweep_wave, greedy._should_stop = (
                full, part, stop)
        order = res.order.cpu()
        ub, n = rec["init"].clone(), rec["init"].shape[0]
        selected = torch.zeros((n,), dtype=torch.bool)
        steps = []
        for i, levels in enumerate(rec["levels"][: int((order >= 0).sum())]):
            sv = torch.sort(torch.where(selected, NEG_INF, ub), descending=True).values
            best, hi, tests = torch.tensor(NEG_INF), 0, []
            for idx, g in levels:
                g = torch.where(selected[idx], NEG_INF, g)
                best = torch.maximum(best, g.max())
                hi += idx.numel()
                rest = sv[hi] if hi < n else torch.tensor(NEG_INF)
                tests.append((float(best), float(rest), bool(best >= rest - 1e-6)))
                ub[idx] = g
            ends = [t[2] for t in tests]
            if not (hi == n or ends[-1]) or any(ends[:-1]):
                raise AssertionError(f"{label}: rebuilt accept tests do not end step {i} where the "
                                     f"engine did: {tests}")
            steps.append(tests)
            selected[int(order[i])] = True
        runs.append(steps)
    kern, plain = runs
    for i, (a, b) in enumerate(zip(kern, plain)):
        if len(a) != len(b):
            lvl = min(len(a), len(b)) - 1
            info = {"step": i, "levels": [len(a), len(b)], "level": lvl,
                    # (best fresh gain, largest stale bound left, accepted), kernel path first
                    "kernel": a[lvl], "plain": b[lvl]}
            log(f"  {label}: per-step evaluations equal over the first {i} steps; at step {i} "
                f"the kernel path runs {len(a)} levels, the plain path {len(b)}; at level {lvl} "
                f"(best, rest, accepted) kernel {a[lvl]}, plain {b[lvl]}")
            for best, rest, _ in (a[lvl], b[lvl]):
                if abs(best - rest) > GC_GAIN_RTOL * abs(best):
                    raise AssertionError(f"{label}: the runs part at step {i}, level {lvl}, on an "
                                         f"accept test that is not within rtol {GC_GAIN_RTOL} of "
                                         f"its threshold: {info}")
            return info
    if must_part:
        raise AssertionError(f"{label}: n_evals differ but no step's level count does")
    log(f"  {label}: per-step evaluations equal over the first {budget} steps")
    return None


def phase_matrix_free(torch, args, main: dict) -> dict:
    import dataclasses

    from repro_torch.core import FacilityLocationMF, GraphCutMF
    from repro_torch.kernels import ops

    n, d = args.n, args.d
    log(f"== phase 6: matrix-free path: (a) FacilityLocationMF n={n}, d={d}, cosine; "
        f"(b) FacilityLocationMF u={MF_U}, n={args.mf_n}, rbf; (c) GraphCutMF n={n}, "
        f"cosine, lambda=0.4")
    x = torch.as_tensor(gaussian_mixture(args.seed, n, d), device="cuda")
    out = {}
    replay = 100  # plain-path sweeps spent looking for a near-tie where the paths agree

    # ---- counts to 0 just before the path, read just after
    ops.reset_launches()

    # (a) FLMF on phase 4's features: against its plain path and phase 4's dense ids
    fl = FacilityLocationMF.from_features(x, metric="cosine", use_kernel=True)
    fl_plain = dataclasses.replace(fl, use_kernel=False)
    a = {}
    for opt, budget in (("NaiveGreedy", MF_NAIVE_BUDGET), ("LazyGreedy", args.mf_lazy_budget)):
        a[opt], res, _ = _solve_pair(torch, f"(a) FLMF {opt} {budget}", fl, fl_plain, budget, opt,
                                  replay)
        if a[opt]["peak_bytes"] >= MF_PEAK_LIMIT:
            raise AssertionError(f"(a) FLMF {opt}: peak {a[opt]['peak_bytes']} bytes >= 1 GB")
        if opt == "NaiveGreedy":
            a["vs_dense"] = _vs_dense(res, main, budget)
    out["a"] = a

    # (b) the million-point shape: u stride-sampled representatives, rbf
    y = gaussian_mixture_cuda(torch, args.seed, args.mf_n, d)
    fb = FacilityLocationMF.from_features(
        y[:: args.mf_n // MF_U][: MF_U], y, metric="rbf", use_kernel=True)
    fb_plain = dataclasses.replace(fb, use_kernel=False)
    b = {"u": fb.src.n_rows, "n": args.mf_n}
    for opt, budget in (("NaiveGreedy", MF_NAIVE_BUDGET),
                        ("LazyGreedy", MF_BIG_LAZY_BUDGET)):
        b[opt], _, _ = _solve_pair(torch, f"(b) FLMF {opt} {budget}", fb, fb_plain, budget, opt, 20)
    out["b"] = b
    del y, fb, fb_plain

    # (c) GraphCutMF: the stateless gcmf sweep every step vs the memoized torch path
    gc = GraphCutMF.from_features(x, lam=0.4, metric="cosine", use_kernel=True)
    gc_plain = dataclasses.replace(gc, use_kernel=False)
    c = {}
    for opt, budget in (("NaiveGreedy", MF_NAIVE_BUDGET), ("LazyGreedy", args.mf_lazy_budget)):
        c[opt], _, _ = _solve_pair(torch, f"(c) GCMF {opt} {budget}", gc, gc_plain, budget, opt,
                                replay)
    out["c"] = c

    launches = {k: v for k, v in ops.LAUNCHES.items() if k.startswith(("flmf", "gcmf"))}
    log(f"  launches on the matrix-free path: {launches}")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} was not launched on the matrix-free path")
    out["launches"] = launches

    # ---- after the counts are read: where (c)'s LazyGreedy n_evals part,
    # over the steps where the two paths' ids agree
    lazy = c["LazyGreedy"]
    if lazy["n_evals"] != lazy["plain_n_evals"]:
        lazy["levels_apart"] = _lazy_levels_apart(
            torch, "(c) GCMF LazyGreedy", (gc, gc_plain), max(1, lazy["agreeing_steps"]),
            must_part=False)
    return out


def _vs_dense(res, main: dict, budget: int) -> dict:
    """FLMF's NaiveGreedy ids against phase 4's dense NaiveGreedy ids, up to
    the dense plain path's first near-tie; gains to GAIN_RTOL before it."""
    return _vs_reference("(a) FLMF NaiveGreedy vs phase 4's dense NaiveGreedy", res,
                         main["naive_ids"][:budget], main["naive_gains"][:budget],
                         main["NaiveGreedy"]["first_near_tie"])


def _vs_reference(label: str, res, ref_ids, ref_gains, t_tie) -> dict:
    """A selection's ids against a reference run's, up to the reference's
    first near-tie ``t_tie`` (None: none seen); gains to GAIN_RTOL before it."""
    ko = res.order.cpu().numpy()
    kg = res.gains.cpu().numpy()
    do = np.asarray(ref_ids)
    dg = np.asarray(ref_gains, dtype=np.float32)
    steps = min(len(ko), len(do))
    diff = np.nonzero(ko[:steps] != do[:steps])[0]
    t_dis = int(diff[0]) if diff.size else None
    if t_dis is not None and (t_tie is None or t_dis < t_tie):
        raise AssertionError(f"{label}: ids differ at step {t_dis}, before the reference's first "
                             f"near-tie ({t_tie})")
    agree = steps if t_dis is None else t_dis
    rel = np.abs(kg[:agree] - dg[:agree]) > GAIN_RTOL * np.abs(dg[:agree])
    if rel.any():
        t = int(np.nonzero(rel)[0][0])
        raise AssertionError(f"{label}: gains differ beyond rtol {GAIN_RTOL} at step {t}")
    log(f"  ok  {label}: ids agree over {agree} of {steps} steps (reference's first near-tie: "
        f"{t_tie}; first disagreement: {t_dis}); gains within rtol {GAIN_RTOL}")
    return {"agreeing_steps": agree, "first_disagreement": t_dis, "reference_first_near_tie": t_tie}


def phase_dense_kernels(torch, seed: int) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.kernels.disp_gains import dmin_gains_plain, dsum_gains_plain
    from repro_torch.kernels.gc_gains import gc_gains_at_plain, gc_gains_plain
    from repro_torch.kernels.row_reduce import SEL_CHUNK

    log("== phase 3: dense pairwise kernels vs plain, small and ragged shapes")
    gen = torch.Generator(device="cuda").manual_seed(seed + 4)
    lam = torch.tensor(GC_LAM, device="cuda")

    def exact(what, got, want):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: not bit-equal to its plain version "
                                 f"(max abs err {max_err(got, want):.3g})")

    def sums(s, mask, total, label):
        """gc, gc_at and dsum against their plain versions, bit for bit."""
        full = ops.gc_gains(s, mask, total, lam)
        exact(f"gc_gains ({n},{n}) {label}", full, gc_gains_plain(s, mask, total, lam))
        for k in (1, 8, 100, 777):
            idx = torch.randint(0, n + 3, (k,), generator=gen, device="cuda")
            idx[::7] = -1  # padding slots, the first among them
            idx[1::5] = idx[0]  # duplicates; idx >= n reads row n - 1
            got = ops.gc_gains_at(s, mask, total, lam, idx)
            torch.cuda.synchronize()
            _check_subset(f"gc_gains_at ({n},{n}) {label} k={k}", torch, got, full,
                          torch.clamp(idx, max=n - 1))
            exact(f"gc_gains_at ({n},{n}) {label} k={k}", got,
                  gc_gains_at_plain(s, mask, total, lam, idx))
        exact(f"dsum_gains ({n},{n}) {label}", ops.dsum_gains(s, mask), dsum_gains_plain(s, mask))

    checked = {}
    # 9000: a ragged n whose rows span 35 passes of dmin's block (9000 = 35 * 256 + 40);
    # none is a multiple of the staged chunk of gc / dsum's list
    for n in (8, 100, 257, 4096, 9000):
        s = torch.rand((n, n), generator=gen, device="cuda")
        mask = (torch.rand((n,), generator=gen, device="cuda") < 0.3).float()
        total = s.sum(dim=0)
        sums(s, mask, total, "random 30%")
        # |A| across a warp's lanes and the staged chunk, up to every column
        counts = {0, 1, 31, 32, 33, n // 8, SEL_CHUNK - 1, SEL_CHUNK, SEL_CHUNK + 1,
                  2 * SEL_CHUNK + 1, n}
        checked[n] = sorted(c for c in counts if c <= n)
        for k in checked[n]:
            sums(s, _count_mask(torch, gen, n, k), total, f"|A| = {k}")
        log(f"  ok  gc_gains, gc_gains_at, dsum_gains ({n},{n}): bit-equal to their plain versions "
            f"at a random mask and at |A| = {checked[n]}")
        count, curmin = mask.sum().to(torch.int32), torch.tensor(0.05, device="cuda")
        got = ops.dmin_gains(s, mask, count, curmin)
        torch.cuda.synchronize()
        if not torch.equal(got, dmin_gains_plain(s, mask, count, curmin)):
            raise AssertionError(f"dmin_gains ({n},{n}): not bit-equal to its plain version")
        empty = ops.dmin_gains(s, torch.zeros_like(mask), torch.zeros_like(count),
                               torch.zeros_like(curmin))
        if not bool((empty == 0).all()):
            raise AssertionError(f"dmin_gains ({n},{n}): |A| = 0 must give all zeros")
        # the gather / stream crossover at 8 |A| = n, and every item selected
        for k in sorted({1, n // 8 - 1, n // 8, n // 8 + 1, n} - {0}):
            kmask = _count_mask(torch, gen, n, k)
            kcount = torch.tensor(k, dtype=torch.int32, device="cuda")
            got = ops.dmin_gains(s, kmask, kcount, curmin)
            torch.cuda.synchronize()
            if not torch.equal(got, dmin_gains_plain(s, kmask, kcount, curmin)):
                raise AssertionError(f"dmin_gains ({n},{n}) |A| = {k} "
                                     f"({'gather' if 8 * k < n else 'stream'}): not bit-equal "
                                     "to its plain version")
        log(f"  ok  dmin_gains ({n},{n}): bit-equal to its plain version at a random mask and at "
            f"|A| = 1, n/8 - 1, n/8, n/8 + 1, n (both branches); all zeros at |A| = 0")
    return checked


def _count_mask(torch, gen, n: int, k: int):
    """A 0/1 fp32 mask of k items in random places, on the card."""
    mask = torch.zeros((n,), device="cuda")
    mask[torch.randperm(n, generator=gen, device="cuda")[:k]] = 1.0
    return mask


def phase_select_cols(torch, seed: int) -> dict:
    """The mask compaction that the dmin and gcmf kernels read their
    selected columns through, against torch.nonzero at n = 2^20."""
    from repro_torch.kernels.select_cols import select_cols

    log("== phase 3: the mask compaction vs torch.nonzero, n = 2^20")
    gen = torch.Generator(device="cuda").manual_seed(seed + 6)
    n = 1 << 20
    r = torch.rand((n,), generator=gen, device="cuda")
    masks = {"empty": torch.zeros((n,), device="cuda"), "one": _count_mask(torch, gen, n, 1),
             "1%": torch.where(r < 0.01, 1.0, 0.0), "signed 50%": torch.where(r < 0.5, r - 0.25, 0.0),
             "full": torch.ones((n,), device="cuda")}
    counts = {}
    for label, mask in masks.items():
        for pred in ("positive", "nonzero"):
            sel, count = select_cols(mask, pred)
            again, _ = select_cols(mask, pred)
            want = torch.nonzero(mask > 0 if pred == "positive" else mask != 0).flatten()
            k = int(count)
            if k != want.numel() or not torch.equal(sel[:k].long(), want):
                raise AssertionError(f"select_cols {pred} {label}: not torch.nonzero")
            if not torch.equal(again[:k], sel[:k]):
                raise AssertionError(f"select_cols {pred} {label}: differs on a rerun")
            counts[f"{pred} {label}"] = k
    log(f"  ok  select_cols: equal to torch.nonzero and the same on a rerun, counts {counts}")
    return counts


def phase_dense_pairwise(torch, args, S) -> tuple[dict, object]:
    import dataclasses

    from repro_torch.core import (
        DisparityMin, DisparityMinSum, DisparitySum, GraphCut, SelectionSpec, create_kernel, solve,
    )
    from repro_torch.kernels import ops
    from repro_torch.kernels.similarity_kernel import similarity_plain

    n, d = args.n, args.d
    log(f"== phase 7: dense pairwise path, n={n}, d={d}: (d) GraphCut on phase 4's S, "
        f"lambda={GC_LAM}; (e) DisparitySum, DisparityMin, DisparityMinSum on 1 / max(S_euclidean, "
        "1e-6) - 1")
    x = torch.as_tensor(gaussian_mixture(args.seed, n, d), device="cuda")
    out = {}
    replay = 100
    peaks = []

    # ---- counts to 0 just before the path, read just after
    ops.reset_launches()

    # (d) GraphCut on phase 4's cosine S: gc_gains every naive step, gc_gains_at every lazy level
    gc = GraphCut.from_kernel(S, lam=GC_LAM, use_kernel=True)
    gc_plain = dataclasses.replace(gc, use_kernel=False)
    dd = {}
    for opt, budget in (("NaiveGreedy", MF_NAIVE_BUDGET), ("LazyGreedy", args.mf_lazy_budget)):
        dd[opt], kern, _ = _solve_pair(torch, f"(d) GraphCut {opt} {budget}", gc, gc_plain, budget,
                                    opt, replay, gain_rtol=GC_GAIN_RTOL)
        peaks.append(dd[opt]["peak_bytes"])
        if opt == "NaiveGreedy":
            dd["picks"] = kern.order[kern.order >= 0].tolist()
    lazy = dd["LazyGreedy"]
    ne, pe = lazy["n_evals"], lazy["plain_n_evals"]
    log(f"  (d) GraphCut LazyGreedy n_evals: kernel path {ne}, plain path {pe} "
        f"(difference {ne - pe})")
    if abs(ne - pe) > NEVALS_RTOL * pe:
        raise AssertionError(f"(d) GraphCut LazyGreedy: n_evals {ne} on the kernel path, {pe} on "
                             f"the plain path, beyond rtol {NEVALS_RTOL}")
    out["d"] = dd

    # (e) the diversity distances of the JAX package's selection stage
    # (src/repro/data/selection.py:67-70), inverted in place: one more n x n
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    D = create_kernel(x, metric="euclidean", use_pallas=True)
    D.clamp_(min=1e-6).reciprocal_().sub_(1.0)
    torch.cuda.synchronize()
    e = {"distances_s": time.perf_counter() - t0}
    rows = min(1024, n)
    want = 1.0 / torch.clamp(similarity_plain(x[:rows], x, "euclidean"), min=1e-6) - 1.0
    e["D_first_rows_err"] = check_close(f"D first {rows} rows vs the plain similarity, inverted",
                                        D[:rows], want, 1e-4, 5e-2)
    del want, x

    ds = DisparitySum.from_distance(D, use_kernel=True)
    e["DisparitySum"], kern, _ = _solve_pair(
        torch, f"(e) DisparitySum NaiveGreedy {args.naive_budget}", ds,
        dataclasses.replace(ds, use_kernel=False), args.naive_budget, "NaiveGreedy", replay)
    e["DisparitySum"]["picks"] = kern.order[kern.order >= 0].tolist()
    # the surrogate gain min_{k in A} d_jk - f(A) is negative from the third
    # pick on: the dispersion greedy runs to its budget regardless
    dm = DisparityMin.from_distance(D, use_kernel=True)
    e["DisparityMin"], kern, plain = _solve_pair(
        torch, f"(e) DisparityMin NaiveGreedy {args.naive_budget}", dm,
        dataclasses.replace(dm, use_kernel=False), args.naive_budget, "NaiveGreedy", replay,
        stopIfNegativeGain=False)
    if not (torch.equal(kern.order, plain.order) and torch.equal(kern.gains, plain.gains)):
        raise AssertionError("(e) DisparityMin: kernel path's ids and gains not bit-equal to the plain path's")
    log("  ok  (e) DisparityMin: ids and gains bit-equal to the plain path's at every step")
    e["DisparityMin"]["picks"] = kern.order[kern.order >= 0].tolist()
    peaks += [e["DisparitySum"]["peak_bytes"], e["DisparityMin"]["peak_bytes"]]

    dms = DisparityMinSum.from_distance(D)
    res, wall, peak = _timed_solve(
        torch, SelectionSpec(dms, DMIN_SUM_BUDGET, stopIfNegativeGain=False))
    sel = res.order[res.order >= 0]
    if not (bool(res.gains.isfinite().all()) and res.order.shape == (DMIN_SUM_BUDGET,)):
        raise AssertionError("(e) DisparityMinSum: malformed result")
    mask = torch.zeros((n,), dtype=torch.bool, device="cuda").index_fill_(0, sel.long(), True)
    value, direct = float(res.value), float(dms.evaluate(mask))
    if abs(value - direct) > 1e-4 * abs(direct):
        raise AssertionError(f"(e) DisparityMinSum: telescoped f(A) {value} != evaluate {direct}")
    e["DisparityMinSum"] = {"wall_s": wall, "peak_bytes": peak, "selected": int(sel.numel()),
                            "value": value, "evaluate": direct}
    peaks.append(peak)
    log(f"  (e) DisparityMinSum NaiveGreedy {DMIN_SUM_BUDGET} (torch path): wall={wall:.3f} s "
        f"peak={peak / 2**30:.2f} GiB; f(A)={value:.6f} telescoped, {direct:.6f} evaluated")
    out["e"] = e

    launches = {k: ops.LAUNCHES[k] for k in ("gc_gains", "gc_gains_at", "dsum_gains", "dmin_gains")}
    log(f"  launches on the dense pairwise path: {launches}; peak device memory "
        f"{max(peaks) / 2**30:.2f} GiB (S and D resident)")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} was not launched on the dense pairwise path")
    out["launches"] = launches
    out["peak_bytes"] = max(peaks)

    # ---- after the counts are read: where (d)'s LazyGreedy n_evals part
    if ne != pe:
        lazy["levels_apart"] = _lazy_levels_apart(
            torch, "(d) GraphCut LazyGreedy", (gc, gc_plain), args.mf_lazy_budget)
    return out, D


def phase_dense_times(torch, args, S, D, dense: dict) -> list[dict]:
    from repro_torch.core import DisparityMin
    from repro_torch.kernels import ops
    from repro_torch.kernels.disp_gains import dmin_finish, dmin_gains_plain, dsum_gains_plain
    from repro_torch.kernels.gc_gains import gc_gains_at_plain, gc_gains_plain
    from repro_torch.kernels.select_cols import select_cols

    log("== phase 5 (dense pairwise kernels): times at phase 7's shapes")
    n, reps = S.shape[0], args.reps
    few = max(3, reps // 10)
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 5)

    def mask_of(picks):
        ids = torch.tensor(picks, dtype=torch.long, device="cuda")
        return ids, torch.zeros((n,), device="cuda").index_fill_(0, ids, 1.0)

    def timed(name, kernel, plain, library, tol, exact, a, extra):
        got = kernel()
        want = plain()
        err = check_close(f"{name} ({n},{n}) vs plain, |A| = {a}", got, want, *tol)
        if exact and not torch.equal(got, want):
            raise AssertionError(f"{name}: not bit-equal to its plain version at full size")
        t = {"ms": cuda_ms(torch, kernel, reps), "plain_ms": cuda_ms(torch, plain, few, warmup=1),
             "library_ms": cuda_ms(torch, library, reps), "max_abs_err": err,
             "bit_equal_to_plain": bool(torch.equal(got, want)), "selected": a}
        # this mask needs the |A| selected columns (and the n-vectors); a
        # sweep over every column reads all of the n x n matrix
        t["bound_ms"], t["bound_by"] = bound(3.0 * n * a, 4.0 * (n * a + extra * n))
        t["bound_all_columns_ms"] = bound(3.0 * n * n, 4.0 * (n * n + extra * n))[0]
        log(f"  {name} ({n},{n}), |A|={a}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.3f} ms, "
            f"library {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}; "
            f"all columns {t['bound_all_columns_ms']:.4f} ms)")
        return t, got

    def selected(name, t, mask, call, want):
        """The selected-columns library call, the sector floor and the
        compaction's share, beside the all-column call of ``timed``."""
        a = t["selected"]
        check_close(f"{name}: the selected-columns library call", call(), want, *DENSE_TOL, quiet=True)
        t["selected_library_ms"] = cuda_ms(torch, call, reps)
        # each gathered 4-byte element costs a 32-byte sector: 32 n |A| bytes
        t["sector_floor_ms"] = 1e3 * 32.0 * n * a / PEAK_BYTES_PER_S
        t["select_cols_ms"] = cuda_ms(torch, lambda: select_cols(mask, "nonzero"), reps)
        log(f"  {name}: over the selected columns the library takes {t['selected_library_ms']:.4f} "
            f"ms, the kernel {t['ms']:.4f} ms ({t['selected_library_ms'] / t['ms']:.2f}x); sector "
            f"floor {t['sector_floor_ms']:.4f} ms; the compaction alone (select_cols, n = {n}, "
            f"host-bound: at most its share) {t['select_cols_ms']:.4f} ms")

    # gc at the mask of (d)'s NaiveGreedy picks
    gids, gmask = mask_of(dense["d"]["picks"])
    a = int(gids.numel())
    lam = torch.tensor(GC_LAM, device="cuda")
    total = S.sum(dim=0)
    diag = torch.diagonal(S)
    two = 2.0 * gmask
    gc_args = (S, gmask, total, lam)
    gq, gfull = timed("gc_gains", lambda: ops.gc_gains(*gc_args), lambda: gc_gains_plain(*gc_args),
                      lambda: total - lam * (torch.mv(S, two) + diag), DENSE_TOL, True, a, 4)
    two_a = two[gids]
    selected("gc_gains", gq, gmask,
             lambda: total - lam * (torch.mv(S.index_select(1, gids), two_a) + diag), gfull)
    gc_at = _time_subsets(
        torch, f"gc_gains_at ({n},{n}), |A|={a}",
        lambda idx: ops.gc_gains_at(*gc_args, idx), lambda idx: gc_gains_at_plain(*gc_args, idx),
        lambda idx: total[idx.long()] - lam * (torch.mv(S.index_select(0, idx), two)
                                               + diag[idx.long()]),
        gfull, n, reps, gen,
        work=lambda k: (3.0 * k * a, 4.0 * (k * a + 4 * k + n)),
        tol=DENSE_TOL, work_all=lambda k: (3.0 * k * n, 4.0 * (k * n + 3 * k + n)),
        library_selected=lambda idx: total[idx.long()] - lam * (
            torch.mv(S[idx.long()[:, None], gids[None, :]], two_a) + diag[idx.long()]))

    # dsum at the mask of (e)'s DisparitySum picks
    sids, smask = mask_of(dense["e"]["DisparitySum"]["picks"])
    sq, sfull = timed("dsum_gains", lambda: ops.dsum_gains(D, smask),
                      lambda: dsum_gains_plain(D, smask), lambda: torch.mv(D, smask), DENSE_TOL,
                      True, int(sids.numel()), 2)
    ones_a = smask[sids]
    selected("dsum_gains", sq, smask, lambda: torch.mv(D.index_select(1, sids), ones_a), sfull)

    # dmin at the state of (e)'s DisparityMin picks
    mids, mmask = mask_of(dense["e"]["DisparityMin"]["picks"])
    count = torch.tensor(int(mids.numel()), dtype=torch.int32, device="cuda")
    curmin = DisparityMin(dist=D, n=n).evaluate(mmask.bool()).reshape(())
    mq, _ = timed("dmin_gains", lambda: ops.dmin_gains(D, mmask, count, curmin),
                  lambda: dmin_gains_plain(D, mmask, count, curmin),
                  lambda: dmin_finish(D.index_select(1, mids).amin(dim=1), count, curmin),
                  (0.0, 0.0), True, int(mids.numel()), 2)
    # the kernel gathers the |A| selected columns (8 |A| < n): each 4-byte
    # element costs a 32-byte sector, so its floor is 32 n |A| bytes
    mq["sector_floor_ms"] = 1e3 * 32.0 * n * mq["selected"] / PEAK_BYTES_PER_S
    mq["branch"] = "gather" if 8 * mq["selected"] < n else "stream"
    mq["select_cols_ms"] = cuda_ms(torch, lambda: select_cols(mmask, "positive"), reps)
    log(f"  dmin_gains: {mq['branch']} branch; sector floor {mq['sector_floor_ms']:.4f} ms; "
        f"of its time the compaction (select_cols, n = {n}) {mq['select_cols_ms']:.4f} ms")

    def row(name, cu, line, shape, t, extra):
        return {"name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{cu}",
                "replaces": f"src/repro/kernels/{line}", "shape": shape, "launches": None,
                "max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"], "bound_all_columns_ms": t["bound_all_columns_ms"],
                **extra}

    return [
        row("gc_gains", "gc_gains.cu", "gc_gains.py:67",
            f"sim ({n},{n}) cosine, |A| = {a} -> ({n},)", gq,
            {"library_call": "total - lam * (torch.mv(S, 2 m) + diag)",
             "selected_library_call": "total - lam * (torch.mv(S.index_select(1, A), 2 m[A]) + diag)",
             **{k: gq[k] for k in ("bit_equal_to_plain", "selected_library_ms", "sector_floor_ms",
                                   "select_cols_ms")}}),
        row("gc_gains_at", "gc_gains.cu", "gc_gains.py:125",
            f"sim ({n},{n}), |A| = {a}, idx (8,) -> (8,)", gc_at[8],
            {"library_call": "index_select + torch.mv + diag",
             "selected_library_call": "torch.mv(S[idx][:, A], 2 m[A]) + diag",
             "selected_library_ms": gc_at[8]["selected_library_ms"], "k512": gc_at[512]}),
        row("dsum_gains", "disp_gains.cu", "disp_gains.py:56",
            f"dist ({n},{n}), |A| = {sq['selected']} -> ({n},)", sq,
            {"library_call": "torch.mv(D, m)",
             "selected_library_call": "torch.mv(D.index_select(1, A), m[A])",
             **{k: sq[k] for k in ("bit_equal_to_plain", "selected_library_ms", "sector_floor_ms",
                                   "select_cols_ms")}}),
        row("dmin_gains", "disp_gains.cu", "disp_gains.py:106",
            f"dist ({n},{n}), |A| = {mq['selected']} -> ({n},)", mq,
            {"library_call": "D.index_select(1, A).amin(1) + finish",
             **{k: mq[k] for k in ("sector_floor_ms", "branch", "select_cols_ms")}}),
    ]


def phase_cover_kernels(torch, seed: int) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.kernels.fb_gains import fb_gains_at_plain, fb_gains_plain
    from repro_torch.kernels.sc_gains import psc_gains_plain, sc_gains_plain

    log("== phase 3: coverage kernels vs plain, small and ragged shapes")
    gen = torch.Generator(device="cuda").manual_seed(seed + 6)
    bit_equal = {f"fb_gains {c}": True for c in CONCAVES}
    bit_equal.update(sc_gains=True, psc_gains=True)
    worst = {}

    def hold(what, key, got, want):
        err = check_close(what, got, want, *COVER_TOL, quiet=True)
        worst[key] = max(worst.get(key, 0.0), err)
        if not torch.equal(got, want):
            bit_equal[key] = False

    shapes = list(itertools.product((1, 7, 257, 4097), (1, 33, 255, 257, 1000)))
    for n, F in shapes:
        feats = torch.rand((n, F), generator=gen, device="cuda")
        acc = 3.0 * torch.rand((F,), generator=gen, device="cuda")
        w = 0.5 + torch.rand((F,), generator=gen, device="cuda")
        sets = []
        for k in (1, 8, 100, 777):
            idx = torch.randint(0, n + 3, (k,), generator=gen, device="cuda")
            idx[::7] = -1  # padding slots, the first among them
            idx[1::5] = idx[0]  # duplicates; idx >= n reads row n - 1
            sets.append(idx)
        for concave in CONCAVES:
            full = ops.fb_gains(feats, acc, w, concave)
            torch.cuda.synchronize()
            hold(f"fb_gains {concave} ({n},{F})", f"fb_gains {concave}", full,
                 fb_gains_plain(feats, acc, w, concave))
            for idx in sets:
                got = ops.fb_gains_at(feats, acc, w, idx, concave)
                torch.cuda.synchronize()
                what = f"fb_gains_at {concave} ({n},{F}) k={idx.shape[0]}"
                _check_subset(what, torch, got, full, torch.clamp(idx, max=n - 1))
                err = check_close(what, got, fb_gains_at_plain(feats, acc, w, idx, concave),
                                  *COVER_TOL, quiet=True)
                worst["fb_gains_at"] = max(worst.get("fb_gains_at", 0.0), err)
        cover = (torch.rand((n, F), generator=gen, device="cuda") < 0.3).float()
        covered = torch.rand((F,), generator=gen, device="cuda")  # fractional
        got = ops.sc_gains(cover, covered, w)
        torch.cuda.synchronize()
        hold(f"sc_gains ({n},{F})", "sc_gains", got, sc_gains_plain(cover, covered, w))
        # a base that is not 16-byte aligned takes the element loads: the same bits
        if not torch.equal(ops.sc_gains(_offset_rows(torch, cover), covered, w), got):
            raise AssertionError(f"sc_gains ({n},{F}): an unaligned cover is not bit-equal")
        miss = torch.rand((F,), generator=gen, device="cuda")
        got = ops.psc_gains(feats, miss, w)
        torch.cuda.synchronize()
        hold(f"psc_gains ({n},{F})", "psc_gains", got, psc_gains_plain(feats, w * miss))
    log(f"  ok  fb_gains, fb_gains_at, sc_gains, psc_gains at {len(shapes)} shapes, n in (1, 7, "
        f"257, 4097) x F in (1, 33, 255, 257, 1000), three concaves, k in (1, 8, 100, 777) with "
        f"pads, duplicates and idx >= n: within rtol {COVER_TOL[0]} atol {COVER_TOL[1]}; max abs "
        f"err {json.dumps(worst)}; fb_gains_at bit-equal to fb_gains; sc_gains on an unaligned "
        "cover bit-equal to the aligned one")
    log(f"  bit-equal to their plain versions at every shape: {bit_equal}")
    return {"bit_equal": bit_equal, "max_abs_err": worst}


def _tag_probs(torch, x, seed: int):
    """The tagger's membership probabilities sigmoid(x W + b), W (d, TAGS) ~
    N(0, 1/d) from the seed's generator, formed in place on the logits."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    w = torch.randn((x.shape[1], TAGS), generator=gen, device="cuda") / float(np.sqrt(x.shape[1]))
    return torch.matmul(x, w).add_(TAG_BIAS).sigmoid_()


def phase_coverage(torch, args) -> tuple[dict, dict]:
    import dataclasses

    from repro_torch.core import FeatureBased, ProbabilisticSetCover, SetCover
    from repro_torch.kernels import ops

    n, d = args.mf_n, args.d
    log(f"== phase 8: coverage path, n={n}, d={d}: (f) FeatureBased on relu(x), sqrt; (g) SetCover "
        f"and (h) ProbabilisticSetCover on a {TAGS}-concept tagger sigmoid(x W {TAG_BIAS:+})")
    x = gaussian_mixture_cuda(torch, args.seed, n, d)
    out, fns, replay = {}, {}, 100

    # ---- counts to 0 just before the path, read just after
    ops.reset_launches()

    # (f) FeatureBased over post-ReLU activations: fb_gains every naive step,
    # fb_gains_at every lazy level
    fb = FeatureBased.from_features(torch.relu(x), concave="sqrt", use_kernel=True)
    fb_plain = dataclasses.replace(fb, use_kernel=False)
    f = {"feats_bytes": fb.feats.numel() * 4}
    # fb_gains_at's launches by width k (LazyGreedy's levels), beside its count
    widths = collections.Counter()
    fb_gains_at = counting_widths(ops, "fb_gains_at", 3, widths)
    try:
        for opt, budget in (("NaiveGreedy", MF_NAIVE_BUDGET),
                            ("LazyGreedy", args.mf_lazy_budget)):
            f[opt], kern, _ = _solve_pair(torch, f"(f) FeatureBased {opt} {budget}", fb,
                                          fb_plain, budget, opt, replay)
            f[opt]["picks"] = kern.order[kern.order >= 0].tolist()
    finally:
        ops.fb_gains_at = fb_gains_at
    f["fb_gains_at_widths"] = dict(sorted(widths.items()))
    if sum(widths.values()) != ops.LAUNCHES["fb_gains_at"]:
        raise AssertionError(f"fb_gains_at widths {f['fb_gains_at_widths']} do not add up to its "
                             f"{ops.LAUNCHES['fb_gains_at']} launches")
    log(f"  (f) fb_gains_at launches by width k: {f['fb_gains_at_widths']}")
    picks = f["LazyGreedy"]["picks"]
    state = fb.init_state()
    for j in picks:
        state = fb.update(state, j)
    mask = torch.zeros((n,), dtype=torch.bool, device="cuda")
    mask[torch.tensor(picks, device="cuda")] = True
    f["evaluate_state"], f["evaluate"] = float(fb.evaluate_state(state)), float(fb.evaluate(mask))
    if abs(f["evaluate_state"] - f["evaluate"]) > GAIN_RTOL * abs(f["evaluate"]):
        raise AssertionError(f"(f) FeatureBased: evaluate_state {f['evaluate_state']} != evaluate "
                             f"{f['evaluate']} on the LazyGreedy selection")
    log(f"  ok  (f) FeatureBased evaluate_state {f['evaluate_state']:.6f}, evaluate "
        f"{f['evaluate']:.6f} on the LazyGreedy selection (rtol {GAIN_RTOL})")
    out["f"], fns["fb"] = f, (fb, fb_plain)
    del state, mask

    # (g), (h): the tagger's probabilities; SetCover on the tags p > 0.5
    p = _tag_probs(torch, x, args.seed)
    del x
    sc = SetCover.from_cover((p > 0.5).float(), use_kernel=True)
    psc = ProbabilisticSetCover.from_probs(p, use_kernel=True)
    del p
    tags = sc.cover.sum(dim=1)
    g = {"tags_per_item_mean": float(tags.mean()), "tags_per_item_max": float(tags.max()),
         "concepts_carried": int((sc.cover.amax(dim=0) > 0).sum())}
    del tags
    log(f"  tagger: {g['tags_per_item_mean']:.2f} tags per item on average (p > 0.5; max "
        f"{g['tags_per_item_max']:.0f}); {g['concepts_carried']} of {TAGS} concepts carried by "
        "some item")
    sc_plain = dataclasses.replace(sc, use_kernel=False)
    for opt, budget in (("NaiveGreedy", MF_NAIVE_BUDGET), ("LazyGreedy", args.mf_lazy_budget)):
        g[opt], kern, plain = _solve_pair(torch, f"(g) SetCover {opt} {budget}", sc, sc_plain,
                                          budget, opt, replay)
        # unit weights, binary cover: integer gains, exact in any order
        if not (torch.equal(kern.order, plain.order) and torch.equal(kern.gains, plain.gains)
                and int(kern.n_evals) == int(plain.n_evals)):
            raise AssertionError(f"(g) SetCover {opt}: kernel path not equal to the torch path in "
                                 "ids, gains and n_evals")
        g[opt]["picks"] = kern.order[kern.order >= 0].tolist()
        log(f"  ok  (g) SetCover {opt}: ids, gains and n_evals equal to the torch path's at every "
            f"step; {g[opt]['selected']} picks, f(A) = {g[opt]['value']:.0f} of {TAGS} concepts")
    out["g"], fns["sc"] = g, (sc, sc_plain)

    psc_plain = dataclasses.replace(psc, use_kernel=False)
    h = {}
    for opt, budget in (("NaiveGreedy", MF_NAIVE_BUDGET), ("LazyGreedy", args.mf_lazy_budget)):
        h[opt], kern, _ = _solve_pair(torch, f"(h) ProbabilisticSetCover {opt} {budget}", psc,
                                      psc_plain, budget, opt, replay)
        h[opt]["picks"] = kern.order[kern.order >= 0].tolist()
    out["h"], fns["psc"] = h, (psc, psc_plain)

    launches = {k: ops.LAUNCHES[k] for k in ("fb_gains", "fb_gains_at", "sc_gains", "psc_gains")}
    peaks = [r[o]["peak_bytes"] for r in (f, g, h) for o in ("NaiveGreedy", "LazyGreedy")]
    log(f"  launches on the coverage path: {launches}; peak device memory "
        f"{max(peaks) / 2**30:.2f} GiB")
    # at least one full sweep per NaiveGreedy step that ran, one gathered sweep
    least = {"fb_gains": f["NaiveGreedy"]["selected"], "sc_gains": g["NaiveGreedy"]["selected"],
             "psc_gains": h["NaiveGreedy"]["selected"], "fb_gains_at": 1}
    for k, v in launches.items():
        if v < least[k]:
            raise AssertionError(f"kernel {k} launched {v} times on the coverage path, fewer than "
                                 f"{least[k]}")
    out["launches"], out["peak_bytes"] = launches, max(peaks)

    # ---- after the counts are read: LazyGreedy n_evals across the two paths
    for label, key, pair in (("(f) FeatureBased", "f", fns["fb"]),
                             ("(h) ProbabilisticSetCover", "h", fns["psc"])):
        lazy = out[key]["LazyGreedy"]
        ne, pe = lazy["n_evals"], lazy["plain_n_evals"]
        log(f"  {label} LazyGreedy n_evals: kernel path {ne}, plain path {pe} (difference {ne - pe})")
        if abs(ne - pe) > NEVALS_RTOL * pe:
            raise AssertionError(f"{label} LazyGreedy: n_evals {ne} on the kernel path, {pe} on the "
                                 f"plain path, beyond rtol {NEVALS_RTOL}")
        if ne != pe:
            lazy["levels_apart"] = _lazy_levels_apart(torch, f"{label} LazyGreedy", pair,
                                                      args.mf_lazy_budget)
    return out, fns


def phase_cover_times(torch, args, fns: dict, cover: dict) -> list[dict]:
    import dataclasses

    from repro_torch.kernels import ops
    from repro_torch.kernels.fb_gains import fb_gains_at_plain, fb_gains_plain
    from repro_torch.kernels.sc_gains import psc_gains_plain, sc_gains_plain

    log("== phase 5 (coverage kernels): times at phase 8's shapes")
    reps = args.reps
    few = max(3, reps // 10)
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 8)

    def state_after(fn, picks):
        state = fn.init_state()
        for j in picks:
            state = fn.update(state, j)
        return state

    def timed(name, kernel, plain, library, torch_path, flops, nbytes):
        got, want = kernel(), plain()
        err = check_close(f"{name} vs plain", got, want, *COVER_TOL)
        t = {"ms": cuda_ms(torch, kernel, reps), "plain_ms": cuda_ms(torch, plain, few, warmup=1),
             "library_ms": None if library is None else cuda_ms(torch, library, reps),
             "torch_backend_ms": cuda_ms(torch, torch_path, few, warmup=1),
             "max_abs_err": err, "bit_equal_to_plain": bool(torch.equal(got, want))}
        t["bound_ms"], t["bound_by"] = bound(flops, nbytes)
        log(f"  {name}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.3f} ms, library "
            + ("none" if library is None else f"{t['library_ms']:.4f} ms")
            + f", torch backend {t['torch_backend_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}); bit-equal to plain: {t['bit_equal_to_plain']}")
        return t, got

    # fb, every concave, at the state of (f)'s NaiveGreedy picks
    fb, _ = fns["fb"]
    n, F = fb.feats.shape
    fpicks = cover["f"]["NaiveGreedy"]["picks"]
    state = state_after(fb, fpicks)
    # per element: add, max, concave, subtract, multiply, add
    fb_work = (6.0 * n * F, 4.0 * (n * F + 3 * F + n))

    def fb_work_at(k):
        return 6.0 * k * F, 4.0 * (k * F + 3 * F + 2 * k)

    fbt = {}
    for concave in CONCAVES:
        fn = dataclasses.replace(fb, concave=concave)
        fb_args = (fn.feats, state.acc, fn.w, concave)
        fbt[concave], full = timed(
            f"fb_gains {concave} ({n},{F}), |A|={len(fpicks)}",
            lambda: ops.fb_gains(*fb_args), lambda: fb_gains_plain(*fb_args), None,
            lambda: fn.gains(state), *fb_work)
        if concave == "sqrt":
            fb_at = _time_subsets(
                torch, f"fb_gains_at ({n},{F}) sqrt",
                lambda idx: ops.fb_gains_at(*fb_args[:3], idx, "sqrt"),
                lambda idx: fb_gains_at_plain(*fb_args[:3], idx, "sqrt"),
                lambda idx: fn.gains_at(state, idx), full, n, reps, gen,
                work=fb_work_at, tol=COVER_TOL)
            # every width (f)'s LazyGreedy launched, with int64 ids (the
            # engine's): launches x time per width; the host's cost at k = 8
            by_width = {}
            for k, count in cover["f"]["fb_gains_at_widths"].items():
                sets = [torch.randperm(n, generator=gen, device="cuda")[:k] for _ in range(16)]
                if not torch.equal(ops.fb_gains_at(*fb_args[:3], sets[0], "sqrt"), full[sets[0]]):
                    raise AssertionError(f"fb_gains_at k={k}: not bit-equal to fb_gains")
                it = itertools.cycle(sets)
                kb_ms, kb_by = bound(*fb_work_at(k))
                by_width[k] = {"launches": count, "bound_ms": kb_ms, "bound_by": kb_by,
                               "ms": cuda_ms(torch, lambda: ops.fb_gains_at(
                                   *fb_args[:3], next(it), "sqrt"), max(3, reps // 5))}
            idx8 = torch.randperm(n, generator=gen, device="cuda")[:8]
            fb_at[8]["host_us"] = host_us(
                torch, lambda: ops.fb_gains_at(*fb_args[:3], idx8, "sqrt"))
            log("  fb_gains_at by width k on (f)'s LazyGreedy, int64 ids (launches x ms = total "
                "ms): " + "; ".join(f"k={k}: {w['launches']} x {w['ms']:.4f} = "
                                    f"{w['launches'] * w['ms']:.1f}" for k, w in by_width.items())
                + f"; in all {sum(w['launches'] * w['ms'] for w in by_width.values()):.1f} ms; "
                f"host {fb_at[8]['host_us']:.1f} us per call at k = 8")

    # sc at the state of (g)'s NaiveGreedy picks: binary covered, unit weights
    sc, _ = fns["sc"]
    m = sc.cover.shape[1]
    spicks = cover["g"]["NaiveGreedy"]["picks"]
    sstate = state_after(sc, spicks)
    sc_args = (sc.cover, sstate.covered, sc.w)
    # sum_u w_u max(G_ju - c_u, 0) = G @ (w (1 - c)) for a binary G and c
    wfree = sc.w * (1.0 - sstate.covered)
    sct, _ = timed(f"sc_gains ({n},{m}), |A|={len(spicks)}",
                   lambda: ops.sc_gains(*sc_args), lambda: sc_gains_plain(*sc_args),
                   lambda: torch.mv(sc.cover, wfree), lambda: sc.gains(sstate),
                   3.0 * n * m, 4.0 * (n * m + 2 * m + n))
    check_close("sc_gains vs torch.mv(G, w (1 - covered)), binary G and covered",
                ops.sc_gains(*sc_args), torch.mv(sc.cover, wfree), 0.0, 0.0)

    # psc at the state of (h)'s NaiveGreedy picks
    psc, _ = fns["psc"]
    ppicks = cover["h"]["NaiveGreedy"]["picks"]
    pstate = state_after(psc, ppicks)
    psc_args = (psc.probs, pstate.miss, psc.w)
    wm = psc.w * pstate.miss
    pst, _ = timed(f"psc_gains ({n},{m}), |A|={len(ppicks)}",
                   lambda: ops.psc_gains(*psc_args), lambda: psc_gains_plain(psc.probs, wm),
                   lambda: torch.mv(psc.probs, wm), lambda: psc.gains(pstate),
                   2.0 * n * m, 4.0 * (n * m + 2 * m + n))

    def row(name, cu, line, shape, t, extra):
        return {"name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{cu}",
                "replaces": f"src/repro/kernels/{line}", "shape": shape, "launches": None,
                "max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"], **extra}

    return [
        row("fb_gains", "fb_gains.cu", "fb_gains.py:52", f"feats ({n},{F}) relu, sqrt -> ({n},)",
            fbt["sqrt"], {"library_call": None, "torch_backend_ms": fbt["sqrt"]["torch_backend_ms"],
                          "bit_equal_to_plain": fbt["sqrt"]["bit_equal_to_plain"],
                          "log": fbt["log"], "inverse": fbt["inverse"]}),
        row("fb_gains_at", "fb_gains.cu", "fb_gains.py:86",
            f"feats ({n},{F}), sqrt, idx (8,) -> (8,)", fb_at[8],
            {"library_call": "FeatureBased.gains_at (the torch path)", "k512": fb_at[512],
             "host_us": fb_at[8]["host_us"], "by_width": by_width}),
        row("sc_gains", "sc_gains.cu", "sc_gains.py:46", f"cover ({n},{m}) binary, unit w -> ({n},)",
            sct, {"library_call": "torch.mv(G, w * (1 - covered)), binary G and covered",
                  "torch_backend_ms": sct["torch_backend_ms"],
                  "bit_equal_to_plain": sct["bit_equal_to_plain"]}),
        row("psc_gains", "sc_gains.cu", "sc_gains.py:91", f"probs ({n},{m}) -> ({n},)", pst,
            {"library_call": "torch.mv(P, w * miss)", "torch_backend_ms": pst["torch_backend_ms"],
             "bit_equal_to_plain": pst["bit_equal_to_plain"]}),
    ]


def phase_fused_kernels(torch, seed: int) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_fl_sweep import fused_fl_sweep_plain

    log("== phase 3: fused FL sweep vs plain, fp32 and bf16, small and ragged shapes")
    gen = torch.Generator(device="cuda").manual_seed(seed + 9)
    worst = {}
    bits = {"bf16_equals_widened_fp32": True, "fp32_equals_flmf_dot": True}
    shapes = FUSED_SHAPES + FUSED_RAGGED
    for (u, n, d), dtype in itertools.product(shapes, (torch.float32, torch.bfloat16)):
        x = torch.randn((u, d), generator=gen, device="cuda").to(dtype)
        y = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
        cm = 3.0 * torch.rand((u,), generator=gen, device="cuda")
        got = ops.fused_fl_sweep(x, y, cm)
        torch.cuda.synchronize()
        key = str(dtype).split(".")[-1]
        err = check_close(f"fused_fl_sweep {key} ({u},{n},{d})", got,
                          fused_fl_sweep_plain(x, y, cm), *MF_TOL["dot"], quiet=True)
        worst[key] = max(worst.get(key, 0.0), err)
        xf, yf = x.float(), y.float()
        if dtype == torch.bfloat16:
            bits["bf16_equals_widened_fp32"] &= bool(torch.equal(got, ops.fused_fl_sweep(xf, yf, cm)))
        else:
            bits["fp32_equals_flmf_dot"] &= bool(torch.equal(got, ops.flmf_gains(
                xf, yf, (xf * xf).sum(1), (yf * yf).sum(1), cm, "dot")))
        # a column's value does not depend on where it sits: slices and gathers
        idx = torch.randint(0, n, (min(n, 777),), generator=gen, device="cuda")
        for what, ys, want in (("slice", y[n // 3 :], got[n // 3 :]),
                               ("tail", y[max(n - 130, 0) :], got[max(n - 130, 0) :]),
                               ("gather", y[idx], got[idx])):
            if not torch.equal(ops.fused_fl_sweep(x, ys.contiguous(), cm), want):
                raise AssertionError(f"fused_fl_sweep {key} ({u},{n},{d}): a {what} of y is not "
                                     "bit-equal to the full sweep")
    log(f"  ok  fused_fl_sweep at {len(shapes)} shapes (tests/test_kernels.py's FUSED_SHAPES + "
        f"ragged), fp32 and bf16: within rtol {MF_TOL['dot'][0]} atol {MF_TOL['dot'][1]} of the "
        f"plain version, max abs err {json.dumps(worst)}; slices and gathers of y bit-equal to "
        f"the full sweep; {json.dumps(bits)}")
    u, n = UNALIGNED_ROWS
    unaligned = {}
    for d, dtype in itertools.product(UNALIGNED_D, (torch.float32, torch.bfloat16)):
        x = torch.randn((u, d), generator=gen, device="cuda").to(dtype)
        y = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
        cm = 3.0 * torch.rand((u,), generator=gen, device="cuda")
        got = ops.fused_fl_sweep(_offset_rows(torch, x), _offset_rows(torch, y), cm)
        torch.cuda.synchronize()
        key = str(dtype).split(".")[-1]
        if not (torch.equal(got, ops.fused_fl_sweep(x, y, cm))
                and torch.equal(got, ops.fused_fl_sweep(x, _offset_rows(torch, y), cm))):
            raise AssertionError(f"fused_fl_sweep {key} ({u},{n},{d}): unaligned rows are not "
                                 "bit-equal to aligned ones")
        unaligned[key] = max(unaligned.get(key, 0.0), check_close(
            f"fused_fl_sweep {key} ({u},{n},{d}) unaligned", got, fused_fl_sweep_plain(x, y, cm),
            *MF_TOL["dot"], quiet=True))
    log(f"  ok  fused_fl_sweep on unaligned rows, ({u},{n}) at d in {UNALIGNED_D}, fp32 and "
        f"bf16: bit-equal to aligned rows, max abs err {json.dumps(unaligned)} against the plain "
        "version")
    return {"max_abs_err": worst, "unaligned_max_abs_err": unaligned, **bits}


def _unit_relu_rows(torch, seed: int, n: int, d: int):
    """relu(mixture) rows scaled to unit length, drawn on the card: dot
    similarities lie in [0, 1]."""
    y = gaussian_mixture_cuda(torch, seed, n, d).relu_()
    return y.div_(torch.linalg.norm(y, dim=1, keepdim=True).clamp_(min=1e-12))


def _fused_replay(torch, label: str, fl, x, y, res) -> tuple[dict, object]:
    """Replay a FacilityLocationMF (dot) NaiveGreedy run: at every state it
    reached, ``fused_fl_sweep(x, y)`` against ``flmf_gains`` on the run's own
    source within MF_TOL["dot"], and the same first argmax over unselected
    candidates (the run's pick) up to the first near-tie of the flmf gains."""
    from repro_torch.common import NEG_INF
    from repro_torch.kernels import ops

    src, state = fl.src, fl.init_state()
    picks = res.order[res.order >= 0].tolist()
    selected = torch.zeros((fl.n,), dtype=torch.bool, device="cuda")
    worst, t_tie, gap = 0.0, None, None
    for t, j in enumerate(picks):
        gf = ops.fused_fl_sweep(x, y, state.curmax)
        gm = ops.flmf_gains(src.x, src.y, src.xx, src.yy, state.curmax, "dot")
        worst = max(worst, check_close(f"{label} state {t}", gf, gm, *MF_TOL["dot"], quiet=True))
        if not torch.equal(gf, gm):  # the same fmaf chains and sums on the two mainloops
            raise AssertionError(f"{label}: at state {t} fused_fl_sweep and flmf_gains(dot) "
                                 "differ in their bits")
        if t_tie is None:
            top = torch.topk(torch.where(selected, NEG_INF, gm), 2)
            g1, g2 = (float(v) for v in top.values)
            if g1 - g2 <= NEAR_TIE_REL * abs(g1):
                t_tie, gap = t, g1 - g2
            else:
                jf = int(torch.argmax(torch.where(selected, NEG_INF, gf)))
                if not jf == int(top.indices[0]) == j:
                    raise AssertionError(f"{label}: at state {t} the fused sweep's argmax is {jf}, "
                                         f"flmf's {int(top.indices[0])}, the run picked {j}")
        state = fl.update(state, torch.tensor([j], device="cuda"))
        selected[j] = True
    log(f"  ok  {label}: fused_fl_sweep against flmf_gains(dot) at all {len(picks)} states of the "
        f"run, max abs err {worst:.3e} (rtol {MF_TOL['dot'][0]}, atol {MF_TOL['dot'][1]}), "
        f"bit-equal at every state; argmax = the run's pick up to the first near-tie "
        f"({'none' if t_tie is None else t_tie}"
        + ("" if gap is None else f", gap {gap:.3e}") + ")")
    return ({"states": len(picks), "max_abs_err": worst, "bit_equal_to_flmf": True,
             "first_near_tie": t_tie, "near_tie_gap": gap}, state)


def phase_fused(torch, args) -> tuple[dict, dict]:
    import dataclasses

    from repro_torch.core import FacilityLocationMF, SelectionSpec, backend_name
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_fl_sweep import fused_fl_sweep_plain

    n, d, u = args.mf_n, args.d, MF_U
    log(f"== phase 9 (i): fused sweep along FacilityLocationMF (dot) NaiveGreedy "
        f"{MF_NAIVE_BUDGET}, u={u}, n={n}, d={d}, unit relu(mixture) rows, fp32 and bf16")
    y = _unit_relu_rows(torch, args.seed, n, d)
    x = y[:: n // u][:u].contiguous()
    y16, x16 = y.bfloat16(), x.bfloat16()
    out, states = {}, {}

    # ---- counts to 0 just before the path, read just after
    ops.reset_launches()
    for key, (xk, yk) in (("float32", (x, y)), ("bfloat16", (x16, y16))):
        # the bf16 run selects over the widened features, the fused sweep reads bf16
        fl = FacilityLocationMF.from_features(xk.float(), yk.float(), metric="dot", use_kernel=True)
        if backend_name(fl) != "cuda-flmf":
            raise AssertionError(f"(i) FLMF backend {backend_name(fl)!r}, expected 'cuda-flmf'")
        res, wall, peak = _timed_solve(torch, SelectionSpec(fl, MF_NAIVE_BUDGET, "NaiveGreedy"))
        if not (bool(res.gains.isfinite().all()) and res.order.shape == (MF_NAIVE_BUDGET,)):
            raise AssertionError("(i) FLMF NaiveGreedy: malformed result")
        out[key], final = _fused_replay(torch, f"(i) {key}", fl, xk, yk, res)
        out[key].update(wall_s=wall, peak_bytes=peak, selected=int((res.order >= 0).sum()),
                        value=float(res.value))
        states[key] = (xk, yk, fl.init_state().curmax, final.curmax)
        del fl
    launches = {k: ops.LAUNCHES[k] for k in ("fused_fl_sweep", "flmf_gains")}
    log(f"  launches on the fused path: {launches}")
    if launches["fused_fl_sweep"] < MF_NAIVE_BUDGET:
        raise AssertionError(f"fused_fl_sweep launched {launches['fused_fl_sweep']} times, fewer "
                             f"than {MF_NAIVE_BUDGET}")
    out["launches"] = launches

    # ---- after the counts are read: the plain version, and the times
    for key, (xk, yk, cm0, cm1) in states.items():
        for label, cm in (("first", cm0), ("last", cm1)):
            out[key][f"plain_{label}_state_err"] = check_close(
                f"(i) {key} fused_fl_sweep vs plain at the {label} state",
                ops.fused_fl_sweep(xk, yk, cm), fused_fl_sweep_plain(xk, yk, cm), *FUSED_PLAIN_TOL)
    reps = max(3, args.reps // 5)
    cm = states["float32"][3]
    t = {"ms": cuda_ms(torch, lambda: ops.fused_fl_sweep(x, y, cm), reps),
         "bf16_ms": cuda_ms(torch, lambda: ops.fused_fl_sweep(x16, y16, states["bfloat16"][3]), reps),
         "flmf_dot_ms": cuda_ms(torch, lambda: ops.flmf_gains(
             x, y, (x * x).sum(1), (y * y).sum(1), cm, "dot"), reps),
         "plain_ms": cuda_ms(torch, lambda: fused_fl_sweep_plain(x, y, cm), 1, warmup=1),
         "library_ms": cuda_ms(torch, lambda: (x @ y.T - cm[:, None]).clamp_min(0).sum(0), 3,
                               warmup=1)}
    t["bound_ms"], t["bound_by"] = bound(2.0 * u * n * d, 4.0 * (u * d + n * d + u + n))
    t["bf16_bound_ms"] = bound(2.0 * u * n * d, 2.0 * (u * d + n * d) + 4.0 * (u + n))[0]
    log(f"  fused_fl_sweep u={u} n={n} d={d}: fp32 {t['ms']:.3f} ms, bf16 {t['bf16_ms']:.3f} ms, "
        f"flmf_gains(dot) {t['flmf_dot_ms']:.3f} ms, plain {t['plain_ms']:.1f} ms, "
        f"(x @ y.T - cm).clamp_min(0).sum(0) (library) {t['library_ms']:.3f} ms, bound "
        f"{t['bound_ms']:.3f} ms ({t['bound_by']})")
    row = {"name": "fused_fl_sweep", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/fused_fl_sweep.cu",
           "replaces": "src/repro/kernels/fused_fl_sweep.py:59",
           "shape": f"x ({u},{d}), y ({n},{d}) fp32, unit rows -> ({n},)",
           "launches": launches["fused_fl_sweep"], "launches_on_path": launches["fused_fl_sweep"],
           "max_abs_err": max(out["float32"]["plain_first_state_err"],
                              out["float32"]["plain_last_state_err"]),
           "library_call": "(x @ y.T - cm[:, None]).clamp_min(0).sum(0), no TF32", **t}
    out["times"] = t
    del y, x, y16, x16, states
    return out, row


def _mixture_draw(seed: int, d: int, component: int, count: int, rng) -> np.ndarray:
    """``count`` fresh points of one component of ``gaussian_mixture(seed)``
    (its centres are the generator's first draw), noise from ``rng``."""
    centers = np.random.default_rng(seed).normal(size=(100, d)).astype(np.float32)
    return centers[component] + rng.normal(size=(count, d)).astype(np.float32)


def phase_clustered(torch, args, S) -> dict:
    import dataclasses

    from repro_torch.core import (
        FacilityLocation, FacilityLocationMF, SelectionSpec, backend_name, clustered,
        clustered_matrix_free, kmeans,
    )
    from repro_torch.kernels import ops

    n, d = args.n, args.d
    log(f"== phase 9 (j): clustered mode, n={n}, d={d}: kmeans k={CLUSTERS}, dense clustered FL "
        f"NaiveGreedy {CLUSTERED_BUDGETS[0]} / LazyGreedy {CLUSTERED_BUDGETS[1]}, matrix-free "
        f"clustered FL NaiveGreedy {CLUSTERED_MF_BUDGET}")
    x = torch.as_tensor(gaussian_mixture(args.seed, n, d), device="cuda")
    out = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    labels = kmeans(x, CLUSTERS, KMEANS_ITERS)
    torch.cuda.synchronize()
    sizes = torch.bincount(labels, minlength=CLUSTERS)
    out["kmeans"] = {"seconds": time.perf_counter() - t0, "k": CLUSTERS, "iters": KMEANS_ITERS,
                     "nonempty": int((sizes > 0).sum()), "largest": int(sizes.max()),
                     "smallest_nonempty": int(sizes[sizes > 0].min())}
    if labels.shape != (n,) or int(labels.min()) < 0 or int(labels.max()) >= CLUSTERS:
        raise AssertionError("(j) kmeans: malformed labels")
    log(f"  kmeans(k={CLUSTERS}, iters={KMEANS_ITERS}): {out['kmeans']['seconds']:.3f} s; "
        f"{out['kmeans']['nonempty']} clusters non-empty, sizes {out['kmeans']['smallest_nonempty']}"
        f"..{out['kmeans']['largest']}")

    # ---- counts to 0 just before the path, read just after
    ops.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fn = clustered(FacilityLocation.from_kernel, S, labels, use_kernel=True)
    torch.cuda.synchronize()
    out["build_s"], out["build_peak_bytes"] = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    log(f"  clustered(FacilityLocation.from_kernel, S, labels): {out['build_s']:.3f} s, peak "
        f"{out['build_peak_bytes'] / 2**30:.2f} GiB (S, the mask and the masked S)")
    if backend_name(fn) != "cuda-fl":
        raise AssertionError(f"(j) clustered FL backend {backend_name(fn)!r}, expected 'cuda-fl'")
    fn_plain = dataclasses.replace(fn, use_kernel=False)
    for opt, budget in zip(("NaiveGreedy", "LazyGreedy"), CLUSTERED_BUDGETS):
        out[opt], kern, _ = _solve_pair(torch, f"(j) clustered FL {opt} {budget}", fn, fn_plain,
                                        budget, opt, 100)
        if opt == "NaiveGreedy":
            naive = kern
    launches = {k: ops.LAUNCHES[k] for k in ("fl_gains", "fl_gains_at")}
    log(f"  launches on the dense clustered path: {launches}")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} was not launched on the dense clustered path")
    out["launches"] = launches
    lazy = out["LazyGreedy"]
    ne, pe = lazy["n_evals"], lazy["plain_n_evals"]
    log(f"  (j) LazyGreedy n_evals: kernel path {ne}, plain path {pe} (difference {ne - pe})")
    if abs(ne - pe) > NEVALS_RTOL * pe:
        raise AssertionError(f"(j) clustered FL LazyGreedy: n_evals {ne} / {pe} beyond rtol "
                             f"{NEVALS_RTOL}")
    del fn, fn_plain

    # the matrix-free clustered mixture (torch path), against the dense one
    mf = clustered_matrix_free(FacilityLocationMF.from_features, x, labels, metric="cosine")
    res, wall, peak = _timed_solve(torch, SelectionSpec(mf, CLUSTERED_MF_BUDGET, "NaiveGreedy"))
    if not bool(res.gains.isfinite().all()):
        raise AssertionError("(j) clustered FLMF: non-finite gains")
    info = _vs_reference("(j) clustered FLMF NaiveGreedy vs the dense clustered NaiveGreedy", res,
                         naive.order[:CLUSTERED_MF_BUDGET].tolist(),
                         naive.gains[:CLUSTERED_MF_BUDGET].tolist(),
                         out["NaiveGreedy"]["first_near_tie"])
    out["matrix_free"] = {**info, "backend": backend_name(mf), "wall_s": wall, "peak_bytes": peak}
    log(f"  (j) clustered FLMF NaiveGreedy {CLUSTERED_MF_BUDGET} ({backend_name(mf)} path): wall "
        f"{wall:.3f} s, peak {peak / 2**20:.1f} MiB")
    out["peak_bytes"] = max(out["build_peak_bytes"], out["NaiveGreedy"]["peak_bytes"],
                            out["LazyGreedy"]["peak_bytes"])
    return out


def _run(torch, label, fn, budget, **stops) -> tuple[dict, object]:
    """One timed NaiveGreedy solve, checked for shape and finite gains."""
    from repro_torch.core import SelectionSpec

    res, wall, peak = _timed_solve(torch, SelectionSpec(fn, budget, "NaiveGreedy", **stops))
    if not (bool(res.gains.isfinite().all()) and res.order.shape == (budget,)):
        raise AssertionError(f"{label}: malformed result")
    sel = res.order[res.order >= 0]
    info = {"wall_s": wall, "peak_bytes": peak, "selected": int(sel.numel()),
            "value": float(res.value), "min_gain": float(res.gains[: sel.numel()].min())}
    log(f"  {label}: {info['selected']} picks, f(A) = {info['value']:.6f}, smallest gain "
        f"{info['min_gain']:.3e}, wall {wall:.3f} s, peak {peak / 2**30:.2f} GiB")
    return info, res


def _mask_of(torch, res, n):
    return torch.zeros((n,), dtype=torch.bool, device="cuda").index_fill_(
        0, res.order[res.order >= 0].long(), True)


def phase_guided(torch, args, S) -> dict:
    import dataclasses

    from repro_torch.core import (
        FLCG, FLCMI, FLQMI, FLVMI, GCMI, ConcaveOverModular, LogDet, create_kernel, gccg,
        logdet_mi,
    )
    from repro_torch.kernels import ops

    n, d = args.n, args.d
    rng = np.random.default_rng(args.seed + 9)
    cq, cp = (int(c) for c in rng.choice(100, size=2, replace=False))
    log(f"== phase 9 (k): guided selection on phase 4's S, n={n}: Q = {GUIDED} items of mixture "
        f"component {cq}, P = {GUIDED} of component {cp}")
    x = torch.as_tensor(gaussian_mixture(args.seed, n, d), device="cuda")
    Q = torch.as_tensor(_mixture_draw(args.seed, d, cq, GUIDED, rng), device="cuda")
    P = torch.as_tensor(_mixture_draw(args.seed, d, cp, GUIDED, rng), device="cuda")
    out = {"query_component": cq, "private_component": cp}

    def kern(a, b):
        return create_kernel(a, b, metric="cosine", use_pallas=True)

    S_vq, S_vp, S_qq = kern(x, Q), kern(x, P), kern(Q, Q)
    S_qv = S_vq.T.contiguous()
    del x

    # ---- counts to 0 just before the path, read just after
    ops.reset_launches()
    for label, fn in (("FLQMI", FLQMI.build(S_qv)), ("FLVMI", FLVMI.build(S, S_vq)),
                      ("FLCG", FLCG.build(S, S_vp)), ("FLCMI", FLCMI.build(S, S_vq, S_vp))):
        out[label], res = _run(torch, f"(k) {label} NaiveGreedy {GUIDED_BUDGET}", fn,
                               GUIDED_BUDGET, stopIfZeroGain=False)
        direct = float(fn.evaluate(_mask_of(torch, res, n)))
        out[label]["evaluate"] = direct
        if abs(direct - out[label]["value"]) > 1e-4 * abs(direct):
            raise AssertionError(f"(k) {label}: telescoped f(A) {out[label]['value']} != evaluate "
                                 f"{direct}")
        if label == "FLVMI":
            vmi = res
        if label == "FLQMI":
            qmi_fn, qmi = fn, res
    log("  ok  (k) FL measures: telescoped f(A) equals evaluate within rtol 1e-4")

    # identities of the JAX tests, on the card
    empty = torch.zeros((n, 1), device="cuda")
    _, cmi = _run(torch, f"(k) FLCMI with an empty P NaiveGreedy {GUIDED_BUDGET}",
                  FLCMI.build(S, S_vq, empty), GUIDED_BUDGET, stopIfZeroGain=False)
    if not (torch.equal(cmi.order, vmi.order[:GUIDED_BUDGET])
            and torch.equal(cmi.gains, vmi.gains[:GUIDED_BUDGET])):
        raise AssertionError("(k) FLCMI with an empty P: not FLVMI's ids and gains")
    log(f"  ok  (k) FLCMI with an empty P: FLVMI's ids and gains, bit for bit, over "
        f"{GUIDED_BUDGET} steps (tests/test_info.py:274)")
    state, mask = qmi_fn.init_state(), torch.zeros((n,), dtype=torch.bool, device="cuda")
    worst = 0.0
    for j in qmi.order[:5].tolist():
        g, oracle = float(qmi_fn.gains(state)[j]), float(qmi_fn.marginal_gain(mask, j))
        worst = max(worst, abs(g - oracle) / max(abs(oracle), 1e-30))
        state, mask[j] = qmi_fn.update(state, torch.tensor([j], device="cuda")), True
    _, sat = _run(torch, f"(k) FLQMI eta=0 NaiveGreedy {2 * GUIDED}", FLQMI.build(S_qv, eta=0.0),
                  2 * GUIDED, stopIfZeroGain=False)
    g0, gq = float(sat.gains[0]), float(sat.gains[GUIDED])
    if worst > 1e-4 or not gq < 0.25 * g0 + 1e-6:
        raise AssertionError(f"(k) FLQMI: gain identity off by {worst:.3e} relative, or eta = 0 "
                             f"gains do not saturate ({gq} after |Q| picks against {g0})")
    out["FLQMI"].update(gain_identity_max_rel=worst, eta0_first_gain=g0, eta0_gain_after_Q=gq)
    log(f"  ok  (k) FLQMI: gains(state)[j] = f(A + j) - f(A) within {worst:.3e} relative over 5 "
        f"picks; at eta = 0 the gain after |Q| = {GUIDED} picks is {gq:.4f} against {g0:.4f} "
        "first (tests/test_info.py:235)")

    # gccg: a GraphCut, kernel path against plain path
    gc = gccg(S, S_vp, lam=GC_LAM, nu=1.0, use_kernel=True)
    gc_plain = dataclasses.replace(gc, use_kernel=False)
    out["gccg"] = {}
    for opt, budget in (("NaiveGreedy", MF_NAIVE_BUDGET), ("LazyGreedy", args.mf_lazy_budget)):
        out["gccg"][opt], _, _ = _solve_pair(torch, f"(k) gccg {opt} {budget}", gc, gc_plain,
                                             budget, opt, 100, gain_rtol=GC_GAIN_RTOL)
    launches = {k: ops.LAUNCHES[k] for k in ("gc_gains", "gc_gains_at")}
    log(f"  launches on the guided path: {launches}")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} was not launched on the guided path")
    out["launches"] = launches
    # ---- after the counts are read: where the two LazyGreedy runs' n_evals
    # part.  gccg's gains (~2.5e4) have ulps far above the engine's 1e-6
    # accept margin, so the two summation orders decide some levels apart;
    # the first such level must be a knife edge (see _lazy_levels_apart)
    lazy = out["gccg"]["LazyGreedy"]
    ne, pe = lazy["n_evals"], lazy["plain_n_evals"]
    log(f"  (k) gccg LazyGreedy n_evals: kernel path {ne}, plain path {pe} (difference {ne - pe})")
    if ne != pe:
        lazy["levels_apart"] = _lazy_levels_apart(torch, "(k) gccg LazyGreedy", (gc, gc_plain),
                                                  args.mf_lazy_budget)
    del gc, gc_plain

    # the modular and concave measures (bare-tensor states)
    gcmi = GCMI.build(S_vq, lam=0.5)
    out["GCMI"], res = _run(torch, f"(k) GCMI NaiveGreedy {GUIDED_BUDGET}", gcmi, GUIDED_BUDGET)
    top = torch.sort(-gcmi.qsum, stable=True).indices[:GUIDED_BUDGET]
    if not torch.equal(res.order.long(), top):
        raise AssertionError("(k) GCMI: the picks are not the top query sums (pure retrieval)")
    com = ConcaveOverModular.build(S_vq, eta=1.0, concave="sqrt")
    out["COM"], res = _run(torch, f"(k) COM sqrt NaiveGreedy {GUIDED_BUDGET}", com, GUIDED_BUDGET)
    direct = float(com.evaluate(_mask_of(torch, res, n)))
    if abs(direct - out["COM"]["value"]) > 1e-4 * abs(direct):
        raise AssertionError(f"(k) COM: telescoped f(A) {out['COM']['value']} != evaluate {direct}")
    log("  ok  (k) GCMI picks the top query sums; COM's telescoped f(A) equals evaluate")

    # LogDet and logdet_mi on the cosine S (rank <= d + 1), against float64 log dets
    for label, fn in (("LogDet", LogDet.from_kernel(S, LOGDET_BUDGET)),
                      ("logdet_mi", logdet_mi(S, S_vq, S_qq, eta=1.0, max_select=LOGDET_BUDGET))):
        out[label], res = _run(torch, f"(k) {label} NaiveGreedy {LOGDET_BUDGET}", fn, LOGDET_BUDGET,
                               stopIfZeroGain=False, stopIfNegativeGain=False)
        a = res.order[res.order >= 0].long()
        S64 = S[a][:, a].double()
        want = float(torch.linalg.slogdet(S64)[1])
        if label == "logdet_mi":
            vq = S_vq[a].double()
            schur = S64 - vq @ torch.linalg.solve(S_qq.double() + 1e-6 * torch.eye(
                GUIDED, dtype=torch.float64, device="cuda"), vq.T)
            want -= float(torch.linalg.slogdet(schur)[1])
        out[label]["float64"] = want
        err = abs(out[label]["value"] - want)
        out[label]["float64_abs_err"] = err
        if err > 1e-3 * abs(want) + 1e-2:
            raise AssertionError(f"(k) {label}: f(A) {out[label]['value']} against the float64 log "
                                 f"det {want}")
        log(f"  ok  (k) {label}: f(A) {out[label]['value']:.6f}, float64 log det of the picks "
            f"{want:.6f} (abs err {err:.3e}; smallest gain {out[label]['min_gain']:.3e})")
    out["peak_bytes"] = max(v["peak_bytes"] for v in out.values()
                            if isinstance(v, dict) and "peak_bytes" in v)
    return out


def phase_slice5(torch, args) -> tuple[dict, dict]:
    """Phase 9: the fused sweep (i), clustered mode (j) and guided selection
    (k); S is rebuilt with the similarity kernel once phases 6-8 are done."""
    from repro_torch.core import create_kernel

    t0 = time.perf_counter()
    out = {}
    out["i"], row = phase_fused(torch, args)
    x = torch.as_tensor(gaussian_mixture(args.seed, args.n, args.d), device="cuda")
    S = create_kernel(x, metric="cosine", use_pallas=True)
    del x
    out["j"] = phase_clustered(torch, args, S)
    out["k"] = phase_guided(torch, args, S)
    del S
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 9: {out['seconds']:.1f} s; peak device memory (j) {out['j']['peak_bytes'] / 2**30:.2f}"
        f" GiB, (k) {out['k']['peak_bytes'] / 2**30:.2f} GiB")
    return out, row


# ---------------------------------------------------------------------------
# phase 10: the wave path


def _same_bits(torch, label: str, got, want) -> None:
    """Raise unless two results agree bit for bit: ids, gains, n_evals and
    the value."""
    go, wo = got.order.cpu(), want.order.cpu()
    gg, wg = got.gains.cpu(), want.gains.cpu()
    if go.shape != wo.shape or not (torch.equal(go, wo)
                                    and torch.equal(gg.view(torch.int32), wg.view(torch.int32))):
        raise AssertionError(f"{label}: ids or gains part from the sequential solve")
    if int(got.n_evals) != int(want.n_evals):
        raise AssertionError(f"{label}: n_evals {int(got.n_evals)} != {int(want.n_evals)}")
    if np.float32(float(got.value)).tobytes() != np.float32(float(want.value)).tobytes():
        raise AssertionError(f"{label}: value {float(got.value)!r} != {float(want.value)!r}")


def _timed(torch, fn) -> tuple:
    """(result, host seconds, peak device bytes, launches by kernel) of one
    synchronized call, its launch counts set to 0 just before it."""
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, wall, torch.cuda.max_memory_allocated(), {
        k: v for k, v in ops.LAUNCHES.items() if v}


def _wave_turns(torch, label: str, specs) -> dict:
    """The wave (``solve(specs, mode="batched")``) and the B sequential
    solves in turns (wave, sequential, sequential, wave); every member of
    every run bit-equal to its first sequential solve.  During a wave the fl
    sweeps' calls are recorded by their member count."""
    from repro_torch.core import solve
    from repro_torch.kernels import ops

    calls = collections.Counter()
    originals = {name: getattr(ops, name) for name in ("fl_gains", "fl_gains_at")}

    def recorder(name):
        def call(sim, *args):
            calls[f"{name} x{sim.shape[0] if sim.dim() == 3 else 1}"] += 1
            return originals[name](sim, *args)
        return call

    out, runs = {"wave_s": [], "sequential_s": []}, {"wave": [], "sequential": []}
    for turn in ("wave", "sequential", "sequential", "wave"):
        if turn == "wave":
            calls.clear()
            for name in originals:
                setattr(ops, name, recorder(name))
            try:
                res, wall, peak, launches = _timed(torch, lambda: solve(specs, mode="batched"))
            finally:
                for name, fn in originals.items():
                    setattr(ops, name, fn)
            out["wave_calls"] = dict(sorted(calls.items()))
        else:
            res, wall, peak, launches = _timed(torch, lambda: [solve(s) for s in specs])
        runs[turn].append(res)
        out[f"{turn}_s"].append(wall)
        out[f"{turn}_peak_bytes"], out[f"{turn}_launches"] = peak, launches
    seq = runs["sequential"][0]
    for res in runs["wave"] + runs["sequential"][1:]:
        for b, (w, s) in enumerate(zip(res, seq)):
            _same_bits(torch, f"{label} member {b}", w, s)
    out["n_evals"] = [int(r.n_evals) for r in seq]
    out["picks"] = [r.order[r.order >= 0].tolist() for r in seq]
    log(f"  ok  {label}: every member bit-equal to its sequential solve (ids, gains, n_evals, "
        f"value); wave {' / '.join(f'{t:.3f}' for t in out['wave_s'])} s against the "
        f"sequential solves' {' / '.join(f'{t:.3f}' for t in out['sequential_s'])} s (turns "
        f"W S S W); launches wave {out['wave_launches']}, sequential "
        f"{out['sequential_launches']}; wave calls {out['wave_calls']}; peak wave "
        f"{out['wave_peak_bytes'] / 2**30:.2f} / sequential "
        f"{out['sequential_peak_bytes'] / 2**30:.2f} GiB")
    return out


def _mixture_fl(torch, seed: int, n: int, d: int):
    """FacilityLocation (backend by the decision table) over the cosine S,
    built by the similarity kernel, of a 100-component mixture from ``seed``."""
    from repro_torch.core import FacilityLocation, create_kernel

    x = torch.as_tensor(gaussian_mixture(seed, n, d), device="cuda")
    return FacilityLocation.from_kernel(create_kernel(x, metric="cosine", use_pallas=True),
                                        use_kernel=None)


def _wave_budgets(B: int) -> list[int]:
    """B budgets spread evenly over WAVE_BUDGETS."""
    lo, hi = WAVE_BUDGETS
    return [lo + (hi - lo) * b // max(B - 1, 1) for b in range(B)]


def _wave_kernel_times(torch, args, fns, picks) -> dict:
    """fl_gains and fl_gains_at (k = 8, 64; int64 ids) over a wave's one
    stacked S, against B single-member launches at the same state: each
    member's curmax after its first 10 NaiveGreedy picks."""
    from repro_torch.common import stacked_view
    from repro_torch.core import BatchedEngine
    from repro_torch.kernels import ops

    members = BatchedEngine(fns).members
    B, (u, n) = len(members), members[0].sim.shape
    cms = []
    for m, p in zip(members, picks):
        st = m.init_state()
        for j in p[:10]:
            st = m.update(st, torch.tensor([j], device="cuda"))
        cms.append(st.curmax)
    sim, cm = stacked_view([m.sim for m in members]), torch.stack(cms)
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 10)
    out = {"shape": [B, u, n]}
    full = ops.fl_gains(sim, cm)
    for b in range(B):
        if not torch.equal(full[b], ops.fl_gains(members[b].sim, cms[b])):
            raise AssertionError(f"wave fl_gains: member {b} != its own launch")
    out["fl_gains_ms"] = cuda_ms(torch, lambda: ops.fl_gains(sim, cm), args.reps)
    out["fl_gains_members_ms"] = cuda_ms(
        torch, lambda: [ops.fl_gains(m.sim, c) for m, c in zip(members, cms)], args.reps)
    out["fl_gains_bound_ms"], out["fl_gains_bound_by"] = bound(
        3.0 * B * u * n, 4.0 * B * (u * n + u + n))
    for k in (8, 64):
        ids = torch.randint(0, n, (B, k), generator=gen, device="cuda")
        if not torch.equal(ops.fl_gains_at(sim, cm, ids), torch.gather(full, 1, ids)):
            raise AssertionError(f"wave fl_gains_at k={k} != the wave's full sweep")
        out[f"fl_gains_at_k{k}_ms"] = cuda_ms(torch, lambda: ops.fl_gains_at(sim, cm, ids),
                                              args.reps)
        out[f"fl_gains_at_k{k}_members_ms"] = cuda_ms(
            torch, lambda: [ops.fl_gains_at(m.sim, c, i) for m, c, i in zip(members, cms, ids)],
            args.reps)
        out[f"fl_gains_at_k{k}_bound_ms"], out[f"fl_gains_at_k{k}_bound_by"] = bound(
            3.0 * B * u * k, 4.0 * B * (u * k + u + k) + 8.0 * B * k)
    log(f"  wave kernels over the stacked S {out['shape']} (CUDA events): fl_gains "
        f"{out['fl_gains_ms']:.4f} ms against {B} single launches {out['fl_gains_members_ms']:.4f}"
        f" ms (bound {out['fl_gains_bound_ms']:.4f}); fl_gains_at k=8 "
        f"{out['fl_gains_at_k8_ms']:.4f} / {out['fl_gains_at_k8_members_ms']:.4f} ms (bound "
        f"{out['fl_gains_at_k8_bound_ms']:.5f}), k=64 {out['fl_gains_at_k64_ms']:.4f} / "
        f"{out['fl_gains_at_k64_members_ms']:.4f} ms")
    return out


def phase_wave_fl(torch, args) -> dict:
    """(l) FacilityLocation waves through solve(specs, mode="batched") and
    (m) a zero-padded wave through BatchedEngine(fns, valid=...)."""
    from repro_torch.core import (
        BatchedEngine, FacilityLocation, OptimizerSpec, SelectionSpec, solve,
    )

    d, out = args.d, {}
    for B, n in ((args.wave_b, args.wave_n), (max(args.wave_b // 4, 1), 2 * args.wave_n)):
        label = f"(l) B={B} n={n}"
        fns = [_mixture_fl(torch, args.seed + b, n, d) for b in range(B)]
        budgets = _wave_budgets(B)
        cell = {"B": B, "n": n, "budgets": budgets, "stacked_bytes": B * n * n * 4}
        for opt, kw in (("NaiveGreedy", {}), ("LazyGreedy", {"screen_k": WAVE_SCREEN_K})):
            r = cell[opt] = _wave_turns(
                torch, f"{label} {opt}", [SelectionSpec(f, b, opt, **kw) for f, b in zip(fns, budgets)])
            # one launch a NaiveGreedy step, one a LazyGreedy level, each over all B members
            if any(not key.endswith(f" x{B}") for key in r["wave_calls"]) or (
                    r["wave_calls"].get(f"fl_gains x{B}") != (max(budgets) if opt == "NaiveGreedy" else 1)):
                raise AssertionError(f"{label} {opt}: wave calls {r['wave_calls']}")
            for name in ("fl_gains", "fl_gains_at"):
                if r["wave_launches"].get(name, 0) != r["wave_calls"].get(f"{name} x{B}", 0):
                    raise AssertionError(f"{label} {opt}: {name} launches {r['wave_launches']} "
                                         f"!= its wave calls {r['wave_calls']}")
        cell["kernels"] = _wave_kernel_times(torch, args, fns, cell["NaiveGreedy"]["picks"])
        out[f"l_B{B}_n{n}"] = cell
        del fns
        torch.cuda.empty_cache()

    # (m) members of n_i from wave_n to 2 wave_n, S zero-padded to 2 wave_n
    B, n_pad = max(args.wave_b // 4, 1), 2 * args.wave_n
    sizes = [args.wave_n + (n_pad - args.wave_n) * b // max(B - 1, 1) for b in range(B)]
    label = f"(m) padded wave, B={B}, n_i {sizes[0]}..{sizes[-1]} -> {n_pad}"
    fns = [_mixture_fl(torch, args.seed + 500 + b, s, d) for b, s in enumerate(sizes)]
    padded, valid = [], torch.zeros((B, n_pad), dtype=torch.bool, device="cuda")
    for b, f in enumerate(fns):
        Sp = torch.zeros((n_pad, n_pad), device="cuda")
        Sp[: f.n, : f.n] = f.sim
        padded.append(FacilityLocation(sim=Sp, n=n_pad, use_kernel=None))
        valid[b, : f.n] = True
    engine = BatchedEngine(padded, valid=valid)
    del padded, Sp
    budgets = _wave_budgets(B)
    cell = {"B": B, "sizes": sizes, "n_pad": n_pad, "budgets": budgets}
    for opt, kw in (("NaiveGreedy", {}), ("LazyGreedy", {"screen_k": WAVE_SCREEN_K})):
        res, wall, peak, launches = _timed(
            torch, lambda: engine.run(budgets, OptimizerSpec(opt, **kw)))
        seq = [solve(SelectionSpec(f, b, opt, **kw)) for f, b in zip(fns, budgets)]
        for b, (w, s) in enumerate(zip(res, seq)):
            _same_bits(torch, f"{label} {opt} member {b}", w, s)
        if launches.get("fl_gains") != (max(budgets) if opt == "NaiveGreedy" else 1):
            raise AssertionError(f"{label} {opt}: launches {launches}")
        cell[opt] = {"wall_s": wall, "peak_bytes": peak, "launches": launches,
                     "n_evals": [int(r.n_evals) for r in res]}
        log(f"  ok  {label} {opt}: every member bit-equal to its unpadded sequential solve "
            f"(ids, gains, n_evals, value); wave {wall:.3f} s, launches {launches}, peak "
            f"{peak / 2**30:.2f} GiB")
    out["m"] = cell
    del engine, fns
    torch.cuda.empty_cache()
    return out


def _family_members(torch, args, b: int) -> dict:
    """One member of every other kernel family, at n = wave_n, over a
    mixture from the seed + 2,000 + b (use_kernel=True)."""
    from repro_torch.core import (
        DisparityMin, DisparitySum, FacilityLocationMF, FeatureBased, GraphCut, GraphCutMF,
        ProbabilisticSetCover, SetCover, create_kernel,
    )

    x = gaussian_mixture_cuda(torch, args.seed + 2000 + b, args.wave_n, args.d)
    S = create_kernel(x, metric="cosine", use_pallas=True)
    D = create_kernel(x, metric="euclidean", use_pallas=True)
    D.clamp_(min=1e-6).reciprocal_().sub_(1.0)
    p = _tag_probs(torch, x, args.seed + 2000 + b)
    return {
        "GraphCut": GraphCut.from_kernel(S, lam=GC_LAM, use_kernel=True),
        "DisparitySum": DisparitySum.from_distance(D, use_kernel=True),
        "DisparityMin": DisparityMin.from_distance(D, use_kernel=True),
        "FeatureBased": FeatureBased.from_features(torch.relu(x), concave="sqrt", use_kernel=True),
        "SetCover": SetCover.from_cover((p > 0.5).float(), use_kernel=True),
        "ProbabilisticSetCover": ProbabilisticSetCover.from_probs(p, use_kernel=True),
        "FacilityLocationMF": FacilityLocationMF.from_features(x, metric="cosine", use_kernel=True),
        "GraphCutMF": GraphCutMF.from_features(x, lam=GC_LAM, metric="cosine", use_kernel=True),
    }


def phase_wave_families(torch, args) -> dict:
    """(n) every other kernel family in a wave of FAMILY_B members: each
    member bit-equal to its sequential solve; per-member launches and ms a
    step, wave against the sequential solves."""
    from repro_torch.core import SelectionSpec, backend_name

    members = [_family_members(torch, args, b) for b in range(FAMILY_B)]
    out = {}
    for family in members[0]:
        fns = [m[family] for m in members]
        cell = {"backend": backend_name(fns[0])}
        for (opt, kw), budget in zip((("NaiveGreedy", {}), ("LazyGreedy", {"screen_k": 8})),
                                     FAMILY_BUDGETS):
            r = _wave_turns(torch, f"(n) {family} {opt} {budget}",
                            [SelectionSpec(f, budget, opt, **kw) for f in fns])
            # a wave sweeps every member at every level any member still needs
            r["per_member_launches"] = {k: v / FAMILY_B for k, v in r["wave_launches"].items()}
            r["wave_ms_per_step"] = 1e3 * min(r["wave_s"]) / budget
            r["sequential_ms_per_step"] = 1e3 * min(r["sequential_s"]) / budget
            if not r["wave_launches"]:
                raise AssertionError(f"(n) {family} {opt}: no kernel launched in the wave")
            log(f"  (n) {family} {opt}: launches per member {r['per_member_launches']} (wave) / "
                f"{ {k: v / FAMILY_B for k, v in r['sequential_launches'].items()} } "
                f"(sequential); {r['wave_ms_per_step']:.3f} ms a step in the wave against "
                f"{r['sequential_ms_per_step']:.3f} for the {FAMILY_B} sequential solves")
            del r["picks"]
            cell[opt] = r
        out[family] = cell
    del members
    torch.cuda.empty_cache()
    return out


def _check_topk_rows(torch, label, src, fsrc, lo, hi) -> None:
    """Rows lo .. hi - 1 (one of knn_from_features' row batches, so that the
    similarity is computed at the same shapes) hold the k largest entries of
    their similarity rows, descending, ties to the lower column index."""
    import dataclasses

    block = dataclasses.replace(fsrc, x=fsrc.x[lo:hi], xx=fsrc.xx[lo:hi], n_rows=hi - lo)
    sim = torch.cat([s[:, :w] for _, w, s in block._tiles()], dim=1)
    idx, w = src.indices[lo:hi].long(), src.weights[lo:hi]
    if not torch.equal(sim.gather(1, idx), w):
        raise AssertionError(f"{label}: weights are not the rows' similarities")
    thr = w[:, -1:]
    # everything above the k-th value is kept, and ties at it go to the
    # lowest columns
    if not torch.equal((sim > thr).sum(1), (w > thr).sum(1)):
        raise AssertionError(f"{label}: a larger similarity was left out")
    tied = (sim == thr).cumsum(1) * (sim == thr)
    need = (w == thr).sum(1, keepdim=True)
    want_tied = (tied > 0) & (tied <= need)
    got_tied = torch.zeros_like(want_tied).scatter_(1, idx, w == thr)
    if not torch.equal(got_tied, want_tied):
        raise AssertionError(f"{label}: ties at the k-th value not taken by the lowest columns")
    ordered = (w[:, 1:] < w[:, :-1]) | ((w[:, 1:] == w[:, :-1]) & (idx[:, 1:] > idx[:, :-1]))
    if not bool(ordered.all()):
        raise AssertionError(f"{label}: a row's neighbours are not in (value desc, index asc) order")


def phase_wave_knn(torch, args) -> dict:
    """(o) the k-NN sources: knn_from_features on phase 4's features,
    FacilityLocationMF.from_knn against a dense FacilityLocation over the
    source's to_dense() and run twice; the million-point shape; and
    GraphCutMF.from_knn."""
    from repro_torch.core import (
        FacilityLocation, FacilityLocationMF, GraphCut, GraphCutMF, SelectionSpec,
        feature_source, knn_from_features, solve,
    )

    n, d, out = args.n, args.d, {}
    x = torch.as_tensor(gaussian_mixture(args.seed, n, d), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    src = knn_from_features(x, KNN_K, metric="cosine", batch=KNN_BATCH)
    torch.cuda.synchronize()
    out["knn_from_features_s"] = time.perf_counter() - t0
    fsrc = feature_source(x, metric="cosine")
    last = (n - 1) // KNN_BATCH * KNN_BATCH
    for lo in sorted({0, last}):
        _check_topk_rows(torch, "(o) knn_from_features", src, fsrc, lo, min(lo + KNN_BATCH, n))
    del fsrc, x
    log(f"  ok  (o) knn_from_features n={n} k={KNN_K} cosine: "
        f"{out['knn_from_features_s']:.3f} s; the first and last row batches (rows 0.."
        f"{min(KNN_BATCH, n) - 1}, {last}..{n - 1}) hold their k largest similarities, "
        "descending, ties to the lower column")

    fn = FacilityLocationMF.from_knn(src.indices, src.weights)
    dense = FacilityLocation.from_kernel(src.to_dense(), use_kernel=True)
    for opt, budget in (("NaiveGreedy", KNN_BUDGETS[0][0]), ("LazyGreedy", KNN_BUDGETS[0][1])):
        spec = SelectionSpec(fn, budget, opt)
        first, wall, peak, launches = _timed(torch, lambda: solve(spec))
        again, wall2, _, _ = _timed(torch, lambda: solve(spec))
        _same_bits(torch, f"(o) FacilityLocationMF.from_knn {opt} {budget}, second run", again,
                   first)
        ref, dwall, _, _ = _timed(torch, lambda: solve(SelectionSpec(dense, budget, opt)))
        info = _replay_check(torch, f"(o) FLMF k-NN {opt} {budget} vs dense FL over to_dense()",
                             dense, first, ref, max_steps=KNN_BUDGETS[0][0])
        info.update(wall_s=[wall, wall2], dense_wall_s=dwall, peak_bytes=peak, launches=launches,
                    n_evals=int(first.n_evals), dense_n_evals=int(ref.n_evals))
        log(f"  (o) FLMF k-NN {opt} {budget}: {wall:.3f} / {wall2:.3f} s (two runs, equal bits), "
            f"n_evals {info['n_evals']}, peak {peak / 2**30:.2f} GiB; dense FL {dwall:.3f} s, "
            f"n_evals {info['dense_n_evals']}")
        out[f"flmf_{opt}"] = info
    del dense
    torch.cuda.empty_cache()
    gc = GraphCutMF.from_knn(src.indices, src.weights, lam=GC_LAM)
    gc_dense = GraphCut.from_kernel(src.to_dense(), lam=GC_LAM)
    res, wall, peak, _ = _timed(torch, lambda: solve(SelectionSpec(gc, GC_KNN_BUDGET)))
    ref = solve(SelectionSpec(gc_dense, GC_KNN_BUDGET))
    info = _replay_check(torch, f"(o) GraphCutMF.from_knn NaiveGreedy {GC_KNN_BUDGET} vs dense "
                         "GraphCut", gc_dense, res, ref, gain_rtol=GC_GAIN_RTOL)
    info.update(wall_s=wall, peak_bytes=peak)
    out["gcmf_NaiveGreedy"] = info
    log(f"  (o) GraphCutMF k-NN NaiveGreedy {GC_KNN_BUDGET}: {wall:.3f} s")
    del gc, gc_dense, src
    torch.cuda.empty_cache()

    # the JAX package's million-point shape: random neighbours
    m = args.mf_n
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 3000)
    indices = torch.randint(0, m, (m, KNN_MILLION_K), generator=gen, device="cuda",
                            dtype=torch.int32)
    weights = torch.rand((m, KNN_MILLION_K), generator=gen, device="cuda")
    big = FacilityLocationMF.from_knn(indices, weights, n_cols=m)
    for opt, budget in (("NaiveGreedy", KNN_BUDGETS[1][0]), ("LazyGreedy", KNN_BUDGETS[1][1])):
        res, wall, peak, _ = _timed(torch, lambda: solve(SelectionSpec(big, budget, opt)))
        picks = res.order[res.order >= 0]
        gains = res.gains[: picks.shape[0]]
        if (picks.shape[0] != budget or picks.unique().shape[0] != budget
                or not bool(gains.isfinite().all()) or bool((gains[1:] > gains[:-1] + 1e-3).any())):
            raise AssertionError(f"(o) million-point k-NN {opt}: malformed selection")
        out[f"million_{opt}"] = {"wall_s": wall, "peak_bytes": peak, "n_evals": int(res.n_evals)}
        log(f"  ok  (o) FLMF k-NN n={m} k={KNN_MILLION_K} random neighbours {opt} {budget}: "
            f"{wall:.3f} s, n_evals {int(res.n_evals)}, peak {peak / 2**30:.2f} GiB; "
            f"{budget} distinct picks, gains non-increasing")
    del big, indices, weights
    torch.cuda.empty_cache()
    return out


def phase_wave(torch, args) -> dict:
    """Phase 10: the wave path, (l)-(o)."""
    t0 = time.perf_counter()
    log(f"== phase 10: the wave path: (l) FacilityLocation waves B={args.wave_b} n={args.wave_n}"
        f" and B={max(args.wave_b // 4, 1)} n={2 * args.wave_n}, budgets {WAVE_BUDGETS[0]}.."
        f"{WAVE_BUDGETS[1]}; (m) a zero-padded wave; (n) every other kernel family, "
        f"B={FAMILY_B}; (o) the k-NN sources")
    out = phase_wave_fl(torch, args)
    out["n"] = phase_wave_families(torch, args)
    out["o"] = phase_wave_knn(torch, args)
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 10: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 11: the served path


def _served_function(torch, kind: str, seed: int, n: int, d: int):
    """One request's function (use_kernel=None: the decision table's choice)
    over a 100-component mixture from ``seed`` at width ``d``: the JAX
    package's serve CLI families on phase 10's cosine S, fb on relu(x), sc /
    psc on phase 8's tagger, dsum / dmin on phase 7's distances, and FLMF /
    GCMF over the cosine FeatureSource."""
    from repro_torch.core import (
        FLQMI, GCMI, DisparityMin, DisparitySum, FacilityLocation, FacilityLocationMF,
        FeatureBased, GraphCut, GraphCutMF, LogDet, ProbabilisticSetCover, SetCover,
        create_kernel,
    )

    x = gaussian_mixture_cuda(torch, seed, n, d)

    def cos(a, b=None):
        return create_kernel(a, b, metric="cosine", use_pallas=True)

    if kind == "fl":
        return FacilityLocation.from_kernel(cos(x), use_kernel=None)
    if kind == "gc":
        return GraphCut.from_kernel(cos(x), lam=GC_LAM, use_kernel=None)
    if kind == "fb":
        return FeatureBased.from_features(torch.relu(x), concave="sqrt", use_kernel=None)
    if kind in ("sc", "psc"):
        p = _tag_probs(torch, x, seed)
        if kind == "sc":
            return SetCover.from_cover((p > 0.5).float(), use_kernel=None)
        return ProbabilisticSetCover.from_probs(p, use_kernel=None)
    if kind in ("dsum", "dmin"):
        D = create_kernel(x, metric="euclidean", use_pallas=True)
        D.clamp_(min=1e-6).reciprocal_().sub_(1.0)
        cls = DisparitySum if kind == "dsum" else DisparityMin
        return cls.from_distance(D, use_kernel=None)
    q = gaussian_mixture_cuda(torch, seed + 1, SERVE_QUERIES, d)
    if kind == "flqmi":
        return FLQMI.build(cos(q, x))
    if kind == "gcmi":
        return GCMI.build(cos(x, q), lam=GC_LAM)
    if kind == "logdet":
        S = cos(x)
        S.diagonal().add_(0.5)
        return LogDet.from_kernel(S, max_select=SERVE_BUDGETS[1])
    if kind == "flmf":
        return FacilityLocationMF.from_features(x, metric="cosine", use_kernel=None)
    if kind == "gcmf":
        return GraphCutMF.from_features(x, lam=GC_LAM, metric="cosine", use_kernel=None)
    raise KeyError(kind)


def _served_specs(torch, args) -> list:
    """The workload: request i is family SERVE_KINDS[(i // 2) % 12], n drawn
    from SERVE_N by --seed + i, a budget in SERVE_BUDGETS, NaiveGreedy
    for even i and LazyGreedy (screen_k 8) for odd i.  Dispersion requests
    keep selecting past negative gains, as the serve CLI has them."""
    from repro_torch.core import SelectionSpec

    specs = []
    for i in range(SERVE_REQUESTS):
        rng = np.random.default_rng(args.seed + SERVE_SEED + i)
        kind = SERVE_KINDS[(i // 2) % len(SERVE_KINDS)]
        n = int(rng.choice(SERVE_N))
        budget = int(rng.integers(SERVE_BUDGETS[0], SERVE_BUDGETS[1] + 1))
        opt, kw = (("NaiveGreedy", {}) if i % 2 == 0
                   else ("LazyGreedy", {"screen_k": WAVE_SCREEN_K}))
        fn = _served_function(torch, kind, args.seed + SERVE_SEED + i, n, args.d)
        specs.append(SelectionSpec(fn, budget, opt, **kw,
                                   stopIfNegativeGain=kind not in ("dsum", "dmin")))
    return specs


def _launch_counts() -> dict:
    from repro_torch.kernels import ops

    return {k: v for k, v in ops.LAUNCHES.items() if v}


def _latency_summary(responses) -> dict:
    lat = sorted(r.latency_s for r in responses)
    return {"p50_s": lat[max(0, -(-len(lat) // 2) - 1)],
            "p99_s": lat[max(0, -(-99 * len(lat) // 100) - 1)]}


def _serve_round(torch, specs, max_wave: int) -> dict:
    """One round through a fresh SelectionServer: submit every spec, flush;
    the launch counts are set to 0 just before it and read just after."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import SelectionServer

    server = SelectionServer(max_wave=max_wave)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    rids = [server.submit_spec(s) for s in specs]
    out = server.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    responses = [out[r] for r in rids]
    snap = server.stats.snapshot()
    return {"server": server, "responses": responses, "wall_s": wall,
            "qps": len(specs) / wall, "launches": _launch_counts(),
            "waves": snap["counters"]["waves"], "slots": snap["counters"]["slots"],
            "wave_s": snap["wave_s"], "queue_s": snap["queue_s"],
            "latency": _latency_summary(responses), "snapshot": snap}


def _held(torch, label, got, want) -> None:
    _same_bits(torch, label, getattr(got, "result", got), getattr(want, "result", want))


def _no_trouble(label, server, responses) -> None:
    """(p)-(r) fail on any failed or retried request or opened breaker."""
    bad = [r.rid for r in responses if r.attempts != 1]
    failed = server.take_failures()
    counters = server.metrics.counters
    opened = {k: v for k, v in server.breakers.states().items() if v != "closed"}
    if bad or failed or opened or counters["retries_total"] or counters["flush_errors"]:
        raise AssertionError(f"{label}: retried responses {bad}, failures {failed}, "
                             f"breakers {opened}, counters {counters}")


def phase_served_async(torch, specs, sequential, max_wave) -> dict:
    """(q) the same requests through AsyncSelectionServer: depth-triggered
    (max_pending 2) and timer-triggered flushes, each answer bit-equal."""
    import collections as _c

    from repro_torch.launch.async_serve import AsyncSelectionServer
    from repro_torch.launch.serve import SelectionServer

    triggers = _c.Counter()
    server = SelectionServer(max_wave=max_wave)
    front = AsyncSelectionServer(server, max_pending=SERVE_MAX_PENDING,
                                 flush_interval=SERVE_FLUSH_INTERVAL)
    due = front._due_groups

    def counted(now):  # called under the front's lock: tally each group's trigger
        keys, wake = due(now)
        depth = {key: dep for key, dep, _, _ in server.group_states()}
        for key in keys:
            triggers["depth" if depth[key] >= front.max_pending else "timer"] += 1
        return keys, wake

    front._due_groups = counted
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    futures = [front.submit(s) for s in specs]
    responses = [f.result(timeout=600) for f in futures]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    front.close()
    for i, (r, want) in enumerate(zip(responses, sequential)):
        _held(torch, f"(q) async request {i}", r, want)
    _no_trouble("(q)", server, responses)
    if not (triggers["depth"] and triggers["timer"]):
        raise AssertionError(f"(q) flush triggers {dict(triggers)}: want depth and timer both")
    out = {"wall_s": wall, "qps": len(specs) / wall, "triggers": dict(triggers),
           "flushes": front.flushes, "latency": _latency_summary(responses)}
    log(f"  ok  (q) AsyncSelectionServer (max_pending {SERVE_MAX_PENDING}, flush_interval "
        f"{SERVE_FLUSH_INTERVAL} s): {len(specs)} requests in {wall:.3f} s "
        f"({out['qps']:.1f} q/s), triggers {out['triggers']}, {front.flushes} flushes; every "
        "answer bit-equal to its sequential solve")
    return out


def phase_served_sessions(torch, args) -> dict:
    """(r) a FacilityLocationMF session over a cosine FeatureSource fed
    uneven deltas up to SESSION_N rows, against one extend of the
    stream and a direct solve(); a dense FacilityLocation session in indices
    mode, against a direct solve on its active set."""
    from repro_torch.core import FacilityLocation, FacilityLocationMF, SelectionSpec, solve
    from repro_torch.launch.serve import SelectionServer

    n, d, out = SESSION_N, args.d, {}
    x = gaussian_mixture_cuda(torch, args.seed + SERVE_SEED - 1, n, d)
    sizes = [max(1, s * n // 8192) for s in SESSION_DELTAS]  # as given at n = 8,192
    lo, deltas = sizes[0], []
    for s in sizes[1:]:
        deltas.append(x[lo : lo + s])
        lo += s
    deltas.append(x[lo:])

    def spec(rows):
        return SelectionSpec(FacilityLocationMF.from_features(rows, metric="cosine",
                                                              use_kernel=None),
                             SESSION_BUDGET, "LazyGreedy", screen_k=WAVE_SCREEN_K)

    server = SelectionServer()
    t0 = time.perf_counter()
    sess = server.open_session(spec(x[: sizes[0]]))
    updates = [sess.extend(features=dlt) for dlt in deltas]
    torch.cuda.synchronize()
    out["uneven_s"] = time.perf_counter() - t0
    one = SelectionServer().open_session(spec(x[: sizes[0]])).extend(features=x[sizes[0]:])
    direct = solve(spec(x))
    last = updates[-1]
    _held(torch, "(r) FLMF session, uneven deltas vs one extend", last.result, one.result)
    _held(torch, "(r) FLMF session vs direct solve()", last.result, direct)
    if last.n_total != n or last.response.backend != "cuda-flmf":
        raise AssertionError(f"(r) FLMF session: n {last.n_total}, backend {last.response.backend}")
    _no_trouble("(r) FLMF session", server, [u.response for u in updates])
    out["flmf"] = {"deltas": [int(dl.shape[0]) for dl in deltas], "seed_rows": sizes[0],
                   "backends": [u.response.backend for u in updates],
                   "n_evals": int(direct.n_evals), "churn": [u.churn for u in updates]}
    log(f"  ok  (r) FacilityLocationMF session (cosine FeatureSource, seed {sizes[0]} rows, "
        f"deltas {out['flmf']['deltas']} -> n = {n}): bit-equal to one extend and to a direct "
        f"solve(); backends {out['flmf']['backends']}; {out['uneven_s']:.3f} s")
    del x, deltas, updates, one, direct, sess

    # indices mode over a dense S of n items
    uni = _served_function(torch, "fl", args.seed + SERVE_SEED - 2, n, d)
    gen = torch.Generator().manual_seed(args.seed + SERVE_SEED)
    order = torch.randperm(n, generator=gen).tolist()
    unlocks = [order[: n // 4], order[n // 4 : n // 2] + order[:8], order[n // 2 : 5 * n // 8]]
    server = SelectionServer()
    sess = server.open_session(SelectionSpec(uni, SESSION_BUDGET))
    updates = [sess.extend(indices=u) for u in unlocks]
    active = order[: 5 * n // 8]
    direct = solve(SelectionSpec(FacilityLocation.from_kernel(
        uni.sim.index_select(1, torch.tensor(active, device="cuda")), use_kernel=None),
        SESSION_BUDGET))
    ids = [j for j, _ in updates[-1].selection]
    want = [active[j] for j in direct.order.tolist() if j >= 0]
    if ids != want:
        raise AssertionError(f"(r) indices session: universe ids part from the direct solve")
    _held(torch, "(r) indices session vs direct solve on the active set", updates[-1].result, direct)
    _no_trouble("(r) indices session", server, [u.response for u in updates])
    out["indices"] = {"active": len(active), "backend": updates[-1].response.backend,
                      "n_bucket": updates[-1].response.n_bucket}
    log(f"  ok  (r) FacilityLocation session in indices mode over S of {n} items: "
        f"{len(active)} active, universe ids and gains equal to a direct solve on the active "
        f"set (backend {out['indices']['backend']}, bucket {out['indices']['n_bucket']})")
    del uni
    return out


def phase_served_fault(torch, args) -> dict:
    """(s) an injected "kernel" fault on cuda-* for FacilityLocation opens
    its breaker: the FL requests fail typed (breaker_open; the port serves
    no answer off the kernels), a GraphCut request in the same flush is
    answered bit-equal, and once the cooldown has passed on the board's
    clock a probe wave closes the breaker, its answers bit-equal to the
    sequential kernel-route solves."""
    from repro_torch.core import SelectionSpec, backend_name, solve
    from repro_torch.launch import faults
    from repro_torch.launch.resilience import BreakerBoard, BreakerOpen, RetryPolicy
    from repro_torch.launch.serve import SelectionServer

    specs = []
    for i, n in enumerate(FAULT_N):
        fn = _served_function(torch, "fl", args.seed + SERVE_SEED - 10 - i, n, args.d)
        specs.append(SelectionSpec(fn, 50, ("NaiveGreedy", "LazyGreedy")[i % 2]))
    gc = SelectionSpec(_served_function(torch, "gc", args.seed + SERVE_SEED - 20, FAULT_N[0],
                                        args.d), 50)
    want = [solve(s) for s in specs]
    want_gc = solve(gc)
    now = [0.0]
    server = SelectionServer(retry_policy=RetryPolicy(max_attempts=2, backoff_s=0.0, jitter=0.0),
                             breakers=BreakerBoard(threshold=1, cooldown_s=FAULT_COOLDOWN_S,
                                                   clock=lambda: now[0]))
    rids = [server.submit_spec(s) for s in specs]
    rid_gc = server.submit_spec(gc)
    plan = faults.FaultPlan([faults.FaultSpec(site="kernel", family="FacilityLocation",
                                              backend="cuda-*", times=None)])
    with faults.inject(plan):
        out = server.flush()
    fails = server.take_failures()
    if set(out) != {rid_gc} or set(fails) != set(rids):
        raise AssertionError(f"(s) answered {sorted(out)}, failed {sorted(fails)}")
    _held(torch, "(s) GraphCut beside the open FL breaker", out[rid_gc], want_gc)
    if out[rid_gc].backend != backend_name(gc.fn):
        raise AssertionError(f"(s) GraphCut served by {out[rid_gc].backend}")
    for rid in rids:
        err = fails[rid]
        if err.reason != "breaker_open" or not isinstance(err.__cause__, BreakerOpen):
            raise AssertionError(f"(s) request {rid}: {err!r}")
    opened = server.breakers.states()
    if opened.get("FacilityLocation/kernel") != "open":
        raise AssertionError(f"(s) breakers {opened}")
    now[0] = FAULT_COOLDOWN_S  # the fault is gone: a probe wave closes it
    rids = [server.submit_spec(s) for s in specs]
    out = server.flush()
    for rid, w, s in zip(rids, want, specs):
        if out[rid].backend != "cuda-fl":
            raise AssertionError(f"(s) probe n={s.fn.n}: backend {out[rid].backend}")
        _held(torch, f"(s) probe n={s.fn.n} {s.optimizer.name}", out[rid], w)
    closed = server.breakers.states()
    if closed.get("FacilityLocation/kernel") != "closed":
        raise AssertionError(f"(s) breakers after the probe {closed}")
    res = {"fired": plan.counts()[0]["fired"], "failed": {str(r): fails[r].reason for r in fails},
           "breakers_open": opened, "breakers_after_probe": closed,
           "counters": {k: server.metrics.counters[k]
                        for k in ("retries_total", "fallbacks_total", "flush_errors")}}
    log(f"  ok  (s) injected kernel faults on cuda-* for FacilityLocation (n {list(FAULT_N)}): "
        f"breaker opened, the FL requests failed typed (breaker_open), the GraphCut request "
        f"beside them bit-equal; after the cooldown the probe wave closed it, answers bit-equal "
        f"to the sequential kernel-route solves; {res}")
    return res


def phase_served(torch, args) -> dict:
    """Phase 11: (p) SelectionServer, two rounds; (q) AsyncSelectionServer;
    (r) sessions; (s) a kernel fault through the breaker."""
    from repro_torch.core import backend_name, solve
    from repro_torch.core.optimizers.backends import KERNEL_MIN_N, MF_KERNEL_MIN_N
    from repro_torch.kernels import ops

    t_start = time.perf_counter()
    log(f"== phase 11: the served path: {SERVE_REQUESTS} requests over "
        f"{len(SERVE_KINDS)} families, n in {list(SERVE_N)}, d = {args.d}, budgets "
        f"{SERVE_BUDGETS[0]}..{SERVE_BUDGETS[1]}, max_wave {SERVE_MAX_WAVE}")
    ops.reset_launches()
    t0 = time.perf_counter()
    specs = _served_specs(torch, args)
    torch.cuda.synchronize()
    build = {"s": time.perf_counter() - t0, "launches": _launch_counts()}
    routes = [backend_name(s.fn) for s in specs]
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sequential = [solve(s) for s in specs]
    torch.cuda.synchronize()
    seq = {"wall_s": time.perf_counter() - t0, "launches": _launch_counts()}
    seq["qps"] = len(specs) / seq["wall_s"]
    rounds = {}
    for label in ("warm-up", "steady"):
        r = _serve_round(torch, specs, SERVE_MAX_WAVE)
        for i, (resp, want, route) in enumerate(zip(r["responses"], sequential, routes)):
            _held(torch, f"(p) {label} request {i} ({type(specs[i].fn).__name__} "
                  f"n={specs[i].fn.n})", resp, want)
            if resp.backend != route:
                raise AssertionError(f"(p) request {i}: served by {resp.backend}, its "
                                     f"sequential solve by {route}")
        _no_trouble(f"(p) {label}", r["server"], r["responses"])
        del r["server"]
        rounds[label] = r
    steady = rounds["steady"]
    crossing = [i for i, s in enumerate(specs) if s.fn.n < KERNEL_MIN_N
                and steady["responses"][i].n_bucket >= KERNEL_MIN_N]
    if not crossing:
        raise AssertionError("(p) no request was padded across KERNEL_MIN_N")
    on_card = sorted({r for r in routes if r.startswith("cuda-")})
    for s, route in zip(specs, routes):  # the kernel families take their kernels past the gates
        gate = {"FacilityLocationMF": MF_KERNEL_MIN_N, "GraphCutMF": MF_KERNEL_MIN_N}.get(
            type(s.fn).__name__, KERNEL_MIN_N)
        if type(s.fn).__name__ in KERNEL_FAMILIES and route.startswith("cuda-") != (s.fn.n >= gate):
            raise AssertionError(f"(p) {type(s.fn).__name__} n={s.fn.n} routed to {route}")
    if "similarity" not in build["launches"]:
        raise AssertionError(f"(p) building the requests launched {build['launches']}")
    missing = [k for k in SERVED_KERNELS if k != "similarity" and not steady["launches"].get(k)]
    if missing:
        raise AssertionError(f"(p) kernels of the served path not launched: {missing}")
    for label, r in rounds.items():
        log(f"  ok  (p) {label} round: {len(specs)} requests in {r['wall_s']:.3f} s "
            f"({r['qps']:.2f} q/s), {r['waves']} waves, {r['slots']} slots; "
            f"ServerMetrics wave_s p50 "
            f"{r['wave_s']['p50']} p99 {r['wave_s']['p99']} s, queue_s p50 "
            f"{r['queue_s']['p50']} p99 {r['queue_s']['p99']} s; latency p50 "
            f"{r['latency']['p50_s']:.4f} p99 {r['latency']['p99_s']:.4f} s; launches "
            f"{r['launches']}; every answer bit-equal to its sequential solve (ids, gains, "
            "n_evals, value) on the route that solve takes")
    log(f"  (p) the {len(specs)} sequential solves: {seq['wall_s']:.3f} s ({seq['qps']:.2f} "
        f"q/s), launches {seq['launches']}; building the requests {build['s']:.3f} s, "
        f"launches {build['launches']}; {len(crossing)} requests below KERNEL_MIN_N padded "
        f"across it kept their torch route; kernel routes {on_card}")
    out = {"build": build, "sequential": seq, "routes": routes, "crossing": crossing,
           "kinds": [type(s.fn).__name__ for s in specs], "n": [s.fn.n for s in specs],
           "budgets": [s.budget for s in specs], "optimizers": [s.optimizer.name for s in specs]}
    for label, r in rounds.items():
        del r["responses"]
        out[label] = r
    out["q"] = phase_served_async(torch, specs, sequential, SERVE_MAX_WAVE)
    del specs, sequential
    torch.cuda.empty_cache()
    out["r"] = phase_served_sessions(torch, args)
    out["s"] = phase_served_fault(torch, args)
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_start
    log(f"phase 11: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 12: the remaining optimizers
# ---------------------------------------------------------------------------

SAMPLED_BUDGET = 1000
SAMPLED_EPS = 0.01  # s = 231 at n = 50,000 and budget 1,000
SAMPLED_SEEDS = (0,)  # one seed: a second repeats the same check at the script's time cost
STREAM_BUDGET = 100
STREAM_EPS = 0.1
STREAM_BUFFER = 64
CONSTRAINED_STEPS = 300
MATROID_PARTS, MATROID_CAP = 10, 10
KNAPSACK_BUDGET = 60.0
COVER_PREFIX = 100  # cover_greedy's target: 0.999 f(phase 4's first 100 picks)
HOST_LAZY_BUDGET = 300
STREAM_REQUESTS = 24
STREAM_SERVE_BUDGETS = (20, 100)
STREAM_SESSION_N = 8192
STREAM_SESSION_DELTAS = 5
DRAW_CASES = ((0, 0, 1), (1, 7, 1000), (12345, 3, 4096), (2**31 - 1, 4999, 50_000))
STRIDE0_MEMBERS, STRIDE0_K = 8, 1024


def mixture_labels(seed: int, n: int, d: int, components: int = 100) -> np.ndarray:
    """The component of each row of ``gaussian_mixture(seed, n, d)``."""
    rng = np.random.default_rng(seed)
    rng.normal(size=(components, d))
    return rng.integers(0, components, size=n)


def _routes(torch, label, run, fn_kern, fn_plain, tol=FL_TOL, want_ids=None) -> dict:
    """``run(fn)`` on the kernel route, then on the plain route (which must
    launch nothing): equal ids and n_evals, gains within ``tol``; each wall
    on the host clock, synchronized, and the kernel route's launches."""
    from repro_torch.kernels import ops

    before = dict(ops.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kern = run(fn_kern)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES if ops.LAUNCHES[k] != before[k]}
    before = dict(ops.LAUNCHES)
    t0 = time.perf_counter()
    plain = run(fn_plain)
    torch.cuda.synchronize()
    pwall = time.perf_counter() - t0
    if ops.LAUNCHES != before:
        raise AssertionError(f"{label}: the plain route launched a kernel")

    def parts(r):
        if isinstance(r, tuple):  # host_lazy_greedy's (order, gains, n_evals)
            return np.asarray(r[0], np.int64), np.asarray(r[1], np.float64), int(r[2]), None
        return (r.order.cpu().numpy().astype(np.int64), r.gains.cpu().numpy(), int(r.n_evals),
                float(r.value))

    ko, kg, ke, kv = parts(kern)
    po, pg, pe, pv = parts(plain)
    if not np.isfinite(kg).all() or not np.array_equal(ko, po):
        first = np.nonzero(ko[: min(len(ko), len(po))] != po[: min(len(ko), len(po))])[0]
        raise AssertionError(f"{label}: ids part between the kernel and plain routes at "
                             f"{first[:1].tolist()}")
    if ke != pe:
        raise AssertionError(f"{label}: n_evals {ke} (kernel) != {pe} (plain)")
    check_close(f"{label} gains, kernel vs plain route", torch.as_tensor(kg),
                torch.as_tensor(pg), *tol, quiet=True)
    ids = [int(j) for j in ko if j >= 0]
    if want_ids is not None and ids != list(want_ids):
        raise AssertionError(f"{label}: ids part from the reference ids")
    out = {"wall_s": wall, "plain_wall_s": pwall, "n_evals": ke, "picked": len(ids),
           "value": kv if kv is not None else float(np.sum(kg)), "plain_value": pv,
           "launches": launches}
    log(f"  ok  {label}: {len(ids)} picks, n_evals {ke}, f(A) {out['value']:.6f}; kernel "
        f"route {wall:.3f} s (launches {launches}), plain route {pwall:.3f} s; ids and "
        f"n_evals equal, gains within {tol}")
    return out


def _stream_served(torch, args) -> dict:
    """12.5: STREAM_REQUESTS SieveStreaming / ThresholdGreedy requests over FL
    and FeatureBased at n in SERVE_N through SelectionServer, each bit-equal to
    its sequential solve; a FeatureBased session of STREAM_SESSION_DELTAS
    deltas, bit-equal to the direct solve."""
    from repro_torch.core import FeatureBased, SelectionSpec, backend_name, solve
    from repro_torch.launch.serve import SelectionServer

    specs = []
    for i in range(STREAM_REQUESTS):
        rng = np.random.default_rng(args.seed + SERVE_SEED + 500 + i)
        kind = ("fl", "fb")[i % 2]
        n = int(rng.choice(SERVE_N))
        budget = int(rng.integers(STREAM_SERVE_BUDGETS[0], STREAM_SERVE_BUDGETS[1] + 1))
        opt = ("SieveStreaming", "ThresholdGreedy")[(i // 2) % 2]
        kw = {"epsilon": STREAM_EPS, "seed": None if i % 3 else i}
        if opt == "ThresholdGreedy":
            kw["buffer_size"] = STREAM_BUFFER
        fn = _served_function(torch, kind, args.seed + SERVE_SEED + 500 + i, n, args.d)
        specs.append(SelectionSpec(fn, budget, opt, **kw))
    routes = [backend_name(s.fn) for s in specs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sequential = [solve(s) for s in specs]
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    # one round through a fresh server (the path's launch counts run on)
    server = SelectionServer(max_wave=SERVE_MAX_WAVE)
    t0 = time.perf_counter()
    rids = [server.submit_spec(s) for s in specs]
    flushed = server.flush()
    torch.cuda.synchronize()
    r = {"server": server, "responses": [flushed[i] for i in rids],
         "wall_s": time.perf_counter() - t0,
         "waves": server.stats.snapshot()["counters"]["waves"]}
    for i, (resp, want) in enumerate(zip(r["responses"], sequential)):
        _held(torch, f"12.5 request {i} ({type(specs[i].fn).__name__} n={specs[i].fn.n} "
              f"{specs[i].optimizer.name})", resp, want)
        if resp.backend != routes[i]:
            raise AssertionError(f"12.5 request {i}: served by {resp.backend}, its sequential "
                                 f"solve by {routes[i]}")
    _no_trouble("12.5 served streaming", r["server"], r["responses"])
    out = {"requests": len(specs), "sequential_s": seq_s, "served_s": r["wall_s"],
           "waves": r["waves"], "routes": sorted(set(routes))}
    log(f"  ok  12.5 {len(specs)} streaming requests (FL / FeatureBased, n in {list(SERVE_N)}): "
        f"served in {r['wall_s']:.3f} s over {r['waves']} waves (sequential {seq_s:.3f} s), "
        f"every answer bit-equal to its sequential solve; routes {out['routes']}")
    del specs, sequential, r

    x = torch.relu(gaussian_mixture_cuda(torch, args.seed + SERVE_SEED + 499, STREAM_SESSION_N,
                                         args.d))
    cuts = np.linspace(0, STREAM_SESSION_N, STREAM_SESSION_DELTAS + 2).astype(int)[1:]

    def spec(rows):
        return SelectionSpec(FeatureBased.from_features(rows, use_kernel=None), STREAM_BUDGET,
                             "SieveStreaming", epsilon=STREAM_EPS)

    server = SelectionServer()
    t0 = time.perf_counter()
    sess = server.open_session(spec(x[: cuts[0]]))
    updates = [sess.extend(features=x[a:b]) for a, b in zip(cuts[:-1], cuts[1:])]
    torch.cuda.synchronize()
    sess_s = time.perf_counter() - t0
    _held(torch, "12.5 FeatureBased streaming session vs direct solve", updates[-1].result,
          solve(spec(x)))
    _no_trouble("12.5 session", server, [u.response for u in updates])
    out["session"] = {"deltas": len(updates), "n": int(updates[-1].n_total), "s": sess_s,
                      "backends": sorted({u.response.backend for u in updates})}
    log(f"  ok  12.5 FeatureBased SieveStreaming session, {len(updates)} deltas to n = "
        f"{updates[-1].n_total}: bit-equal to the direct solve; {sess_s:.3f} s, backends "
        f"{out['session']['backends']}")
    return out


def _draws_on_card(torch) -> dict:
    """12.6: the threefry draws and the ladders' exp / log on the card equal
    the CPU's bit for bit (the CPU's equal jax.random / XLA's, tests)."""
    from repro_torch.core.optimizers import _threefry
    from repro_torch.core.optimizers._fp32 import exp32, log32

    for seed, step, n in DRAW_CASES:
        key = _threefry.fold_in(_threefry.prng_key(seed), step)
        for what, f in (("uniform", lambda dev: _threefry.uniform(key, n, dev)),
                        ("step block", lambda dev: _threefry.step_bits(key, range(4), n, dev)),
                        ("arrival uniforms", lambda dev: _threefry.fold_in_uniforms(key, n, dev))):
            if not torch.equal(f("cuda").cpu(), f("cpu")):
                raise AssertionError(f"12.6 {what} (seed {seed}, step {step}, n {n}) parts "
                                     "between the card and the CPU")
    gen = torch.Generator().manual_seed(12)
    x = torch.empty(1 << 20).uniform_(-90, 90, generator=gen)
    m = torch.exp(torch.empty(1 << 20).uniform_(-80, 80, generator=gen))
    if not (torch.equal(exp32(x.cuda()).cpu(), exp32(x))
            and torch.equal(log32(m.cuda()).cpu(), log32(m))):
        raise AssertionError("12.6 exp32 / log32 part between the card and the CPU")
    log(f"  ok  12.6 threefry draws at (seed, step, n) {list(DRAW_CASES)} and the ladders' "
        f"exp / log over 2^20 inputs: bit-equal on the card and the CPU")
    return {"cases": [list(c) for c in DRAW_CASES], "fp32_inputs": 1 << 20}


def phase_remaining(torch, args, main: dict | None) -> dict:
    """Phase 12: StochasticGreedy, LazierThanLazyGreedy, SieveStreaming,
    ThresholdGreedy, the constrained greedies and the host heap greedy on
    phase 4's S, each on the kernel and the plain route; served and session
    streaming; the seeded draws on the card."""
    from repro_torch.common import stacked_view
    from repro_torch.core import (
        FacilityLocation, PartitionMatroid, SelectionSpec, backend_name,
        cover_greedy, create_kernel, host_lazy_greedy, knapsack_greedy, matroid_greedy,
        naive_greedy, solve,
    )
    from repro_torch.kernels import ops
    from repro_torch.kernels.fl_gains import fl_gains_at_plain

    t_start = time.perf_counter()
    n, d = args.n, args.d
    log(f"== phase 12: the remaining optimizers on phase 4's S (n={n}, d={d}, cosine)")
    x = gaussian_mixture(args.seed, n, d)
    labels = tuple(int(v) % MATROID_PARTS for v in mixture_labels(args.seed, n, d))
    out = {}
    ops.reset_launches()  # the path's counts: the kernel route's runs below
    S = create_kernel(x, metric="cosine", use_pallas=True)
    kern = FacilityLocation.from_kernel(S, use_kernel=None)
    plain = FacilityLocation.from_kernel(S, use_kernel=False)
    if backend_name(kern) != "cuda-fl":
        raise AssertionError(f"phase 12: backend {backend_name(kern)!r}, expected 'cuda-fl'")
    if main is None:  # phase 12 alone: phase 4's NaiveGreedy ids, LazyGreedy value
        naive = naive_greedy(kern, args.naive_budget)
        main = {"naive_ids": naive.order.cpu().tolist(),
                "naive_gains": naive.gains.cpu().tolist(), "LazyGreedy": None}

    # 12.1 the sampled greedies
    lazy_value = main["LazyGreedy"]["value"] if main.get("LazyGreedy") else None
    for opt in ("StochasticGreedy", "LazierThanLazyGreedy"):
        for seed in SAMPLED_SEEDS:
            label = f"12.1 {opt} {SAMPLED_BUDGET}, eps {SAMPLED_EPS}, seed {seed}"
            r = _routes(torch, label, lambda f: solve(SelectionSpec(
                f, SAMPLED_BUDGET, opt, seed=seed, epsilon=SAMPLED_EPS)), kern, plain)
            r["vs_lazy_value"] = None if lazy_value is None else r["value"] / lazy_value
            out[f"{opt}_seed{seed}"] = r
    log(f"  12.1 values over phase 4's LazyGreedy {args.lazy_budget} value: "
        f"{ {k: v['vs_lazy_value'] for k, v in out.items()} }")

    # 12.2 the streaming ladders
    cons = PartitionMatroid(labels, (MATROID_CAP,) * MATROID_PARTS)
    streams = [("SieveStreaming", {"seed": None}), ("SieveStreaming", {"seed": 0}),
               ("ThresholdGreedy", {"buffer_size": STREAM_BUFFER}),
               ("SieveStreaming", {"constraint": cons})]
    for opt, kw in streams:
        tag = "12.3" if "constraint" in kw else "12.2"
        label = (f"{tag} {opt} {STREAM_BUDGET}, eps {STREAM_EPS}, "
                 + ", ".join(f"{k} {'PartitionMatroid' if k == 'constraint' else v}"
                             for k, v in kw.items()))
        r = _routes(torch, label, lambda f: solve(SelectionSpec(
            f, STREAM_BUDGET, opt, epsilon=STREAM_EPS, **kw)), kern, plain)
        r["fl_gains_at_per_arrival"] = r["launches"].get("fl_gains_at", 0) / n
        out[label.split(" ", 1)[1]] = r

    # 12.3 the constrained greedies
    rng = np.random.default_rng(args.seed + 12)
    costs = rng.uniform(0.5, 2.0, n).astype(np.float32)
    coverage = 0.999 * float(np.sum(np.asarray(main["naive_gains"][:COVER_PREFIX], np.float64)))
    out["knapsack_greedy"] = _routes(torch, f"12.3 knapsack_greedy (budget {KNAPSACK_BUDGET})",
                                     lambda f: knapsack_greedy(f, KNAPSACK_BUDGET,
                                                               CONSTRAINED_STEPS, costs),
                                     kern, plain)
    out["matroid_greedy"] = _routes(torch, f"12.3 matroid_greedy ({MATROID_PARTS} parts, caps "
                                    f"{MATROID_CAP})",
                                    lambda f: matroid_greedy(f, cons, CONSTRAINED_STEPS),
                                    kern, plain)
    out["cover_greedy"] = _routes(torch, f"12.3 cover_greedy (coverage {coverage:.3f})",
                                  lambda f: cover_greedy(f, coverage, CONSTRAINED_STEPS),
                                  kern, plain)

    # 12.4 the host heap greedy: phase 4's NaiveGreedy ids
    want = main["naive_ids"][:HOST_LAZY_BUDGET]
    out["host_lazy_greedy"] = _routes(torch, f"12.4 host_lazy_greedy {HOST_LAZY_BUDGET}",
                                      lambda f: host_lazy_greedy(f, HOST_LAZY_BUDGET),
                                      kern, plain, want_ids=want)

    # 12.5 served and session streaming
    out["served"] = _stream_served(torch, args)
    torch.cuda.synchronize()
    out["launches"] = _launch_counts()
    for k in ("similarity", "fl_gains", "fl_gains_at", "fb_gains_at"):
        if not out["launches"].get(k):
            raise AssertionError(f"phase 12: kernel {k} was not launched on the path")
    log(f"  phase 12 launches on the path: {out['launches']}")

    # the sieves' member-stride-0 wave against its plain version
    # (comparison launches, after the path's counts were read)
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 12)
    wave = stacked_view([S] * STRIDE0_MEMBERS)
    cm = 0.5 * torch.rand((STRIDE0_MEMBERS, n), generator=gen, device="cuda")
    idx = torch.randint(0, n, (STRIDE0_MEMBERS, STRIDE0_K), generator=gen, device="cuda")
    got = ops.fl_gains_at(wave, cm, idx)
    if not (wave.stride(0) == 0 and torch.equal(got, fl_gains_at_plain(wave, cm, idx))
            and torch.equal(got[1], ops.fl_gains_at(S, cm[1], idx[1]))):
        raise AssertionError("fl_gains_at on a member-stride-0 wave parts from its plain version")
    log(f"  ok  fl_gains_at on a member-stride-0 wave of {STRIDE0_MEMBERS} x {n} x {n}, "
        f"k = {STRIDE0_K}: bit-equal to its plain version and to one member's call")
    del wave, cm, idx, got, S, kern, plain
    torch.cuda.empty_cache()

    out["draws"] = _draws_on_card(torch)
    out["seconds"] = time.perf_counter() - t_start
    log(f"phase 12: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 13: the distributed engine
# ---------------------------------------------------------------------------

DIST_SEED = 13000
DIST_KINDS = ("fl", "gc", "fb", "sc", "psc", "dsum", "dmin", "gcmi", "logdet", "flqmi", "flvmi",
              "flcg", "flcmi")
DIST_N = 4096  # (u): every family's n, at the kernel gate
DIST_B = 4
DIST_BUDGETS = (20, 10)  # (u) and (t)'s FB / SC / PSC waves: members alternate
DIST_2X2_FL_BUDGET = 250  # (u): the 2x2 distributed_fl_greedy, against (t)'s first picks
DIST_FL_N = 8192  # (t): the FL waves
DIST_FL_BUDGETS = (150, 90)
DIST_PART_N = 8192  # (u): the stochastic and FLQMI partition greedies
DIST_PART_BUDGET = 100
DIST_SAMPLE = 1024
DIST_PG_TIMEOUT_S = 120  # every process group's timeout in phase 13
DIST_JOIN_TIMEOUT_S = 420  # (u): the parent kills the world after this
SHARDED_KERNELS = ("fl_gains", "fl_gains_at", "fb_gains", "fb_gains_at", "sc_gains", "psc_gains")


def _dist_function(torch, kind: str, seed: int, n: int, d: int):
    """A member of phase 13's waves: phase 11's served family (the
    memoized GC / DSum / DMin, use_kernel=False, as a mesh takes them), or
    an FL measure over the cosine S with SERVE_QUERIES query and private
    items."""
    import dataclasses

    from repro_torch.core import FLCG, FLCMI, FLVMI, create_kernel

    if kind not in ("flvmi", "flcg", "flcmi"):
        fn = _served_function(torch, kind, seed, n, d)
        return dataclasses.replace(fn, use_kernel=False) if kind in ("gc", "dsum", "dmin") else fn
    x = gaussian_mixture_cuda(torch, seed, n, d)
    S = create_kernel(x, metric="cosine", use_pallas=True)
    q = create_kernel(x, gaussian_mixture_cuda(torch, seed + 1, SERVE_QUERIES, d),
                      metric="cosine", use_pallas=True)
    p = create_kernel(x, gaussian_mixture_cuda(torch, seed + 2, SERVE_QUERIES, d),
                      metric="cosine", use_pallas=True)
    if kind == "flvmi":
        return FLVMI.build(S, q)
    return FLCG.build(S, p) if kind == "flcg" else FLCMI.build(S, q, p)


def _dist_specs(fns, opt: str, kind: str, budgets) -> list:
    from repro_torch.core import SelectionSpec

    kw = {"screen_k": WAVE_SCREEN_K} if opt == "LazyGreedy" else {}
    return [SelectionSpec(f, b, opt, **kw, stopIfNegativeGain=kind not in ("dsum", "dmin"))
            for f, b in zip(fns, budgets)]


def _dist_timed(torch, fn) -> tuple:
    """(result, host seconds, launches) of one synchronized call, its launch
    counts set to 0 just before it (the peak-memory record is left alone)."""
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, _launch_counts()


def _digest(results) -> str:
    import hashlib

    h = hashlib.sha256()
    for r in results:
        for t in (r.order, r.gains, r.n_evals, r.value):
            h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def _digest_of(digests) -> str:
    import hashlib

    return hashlib.sha256("".join(digests).encode()).hexdigest()


def _agree_to_near_tie(label: str, ids, gains, ref_ids, ref_gains) -> dict:
    """Ids equal to a reference's up to their first difference, where the
    two picks' gains must be a near-tie (NEAR_TIE_REL); gains to GAIN_RTOL
    before it."""
    a, b = np.asarray(ids), np.asarray(ref_ids)
    ga, gb = np.asarray(gains, np.float64), np.asarray(ref_gains, np.float64)
    steps = min(len(a), len(b))
    diff = np.nonzero(a[:steps] != b[:steps])[0]
    t = int(diff[0]) if diff.size else steps
    if t < steps and abs(ga[t] - gb[t]) > NEAR_TIE_REL * abs(gb[t]):
        raise AssertionError(f"{label}: ids differ at step {t} without a near-tie "
                             f"({ga[t]!r} against {gb[t]!r})")
    if (np.abs(ga[:t] - gb[:t]) > GAIN_RTOL * np.abs(gb[:t])).any():
        raise AssertionError(f"{label}: gains differ beyond rtol {GAIN_RTOL} before step {t}")
    log(f"  ok  {label}: ids agree over {t} of {steps} steps; gains within rtol {GAIN_RTOL}")
    return {"agreeing_steps": t, "steps": steps}


@contextlib.contextmanager
def _counting_collectives():
    """Counts of the torch.distributed collectives called inside, by name."""
    import torch.distributed as dist

    counts = collections.Counter()
    names = ("all_reduce", "all_gather_into_tensor")
    originals = {name: getattr(dist, name) for name in names}

    def counted(name):
        def call(*a, **k):
            counts[name] += 1
            return originals[name](*a, **k)
        return call

    for name in names:
        setattr(dist, name, counted(name))
    try:
        yield counts
    finally:
        for name, fn in originals.items():
            setattr(dist, name, fn)


# phases 13 (t) and 14 (v), (x): the world of 1 on NCCL in this process and its
# two meshes, made on first use and torn down at the end of phase 14
_WORLD1: dict = {}


def _world_of_one() -> dict:
    import datetime
    import tempfile

    import torch.distributed as dist

    from repro_torch.core import make_mesh

    if not _WORLD1:
        timeout = datetime.timedelta(seconds=DIST_PG_TIMEOUT_S)
        store = Path(tempfile.mkdtemp()) / "store"
        dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1,
                                timeout=timeout)
        _WORLD1.update(timeout=timeout,
                       dm=make_mesh((1, 1), ("data", "model"), timeout=timeout),
                       bd=make_mesh((1, 1), ("batch", "data"), timeout=timeout))
    return _WORLD1


def _close_world_of_one() -> None:
    import torch.distributed as dist

    if _WORLD1:
        _WORLD1.clear()
        dist.destroy_process_group()


def _dist_world_of_one(torch, args, main: dict) -> dict:
    """(t) A world of 1 on NCCL in this process (left up for phase 14)."""
    import types

    from repro_torch.core import create_kernel, distributed_fl_greedy, solve

    out = {}
    totals = collections.Counter()
    world = _world_of_one()
    # t.1 the partition greedy on phase 4's S
    mesh_dm = world["dm"]
    S = create_kernel(gaussian_mixture(args.seed, args.n, args.d), metric="cosine",
                      use_pallas=True)
    # the first call also sets up the NCCL communicators of its groups
    (order, gains), cold, launches = _dist_timed(
        torch, lambda: distributed_fl_greedy(S, args.naive_budget, mesh_dm))
    totals.update(launches)
    (again, _), wall, _ = _dist_timed(
        torch, lambda: distributed_fl_greedy(S, args.naive_budget, mesh_dm))
    if not torch.equal(again, order):
        raise AssertionError("13 (t) distributed_fl_greedy: a second call picks other ids")
    del S
    torch.cuda.empty_cache()
    out["fl_partition"] = {"cold_wall_s": cold, "wall_s": wall, "launches": launches,
                           "ids": order.cpu().tolist(), "gains": gains.cpu().tolist()}
    out["fl_partition"].update(_vs_reference(
        f"13 (t) distributed_fl_greedy {args.naive_budget} vs phase 4's NaiveGreedy",
        types.SimpleNamespace(order=order, gains=gains), main["naive_ids"],
        main["naive_gains"], main.get("first_near_tie")))
    log(f"  13 (t) distributed_fl_greedy: {cold:.3f} s (first call), {wall:.3f} s "
        f"(again), launches {launches}")

    # t.2 waves through solve(specs, mesh=mesh), beside mode="batched"
    mesh = world["bd"]
    groups = [("fl", DIST_FL_N, DIST_FL_BUDGETS), ("fb", DIST_FL_N, DIST_BUDGETS),
              ("sc", DIST_FL_N, DIST_BUDGETS), ("psc", DIST_FL_N, DIST_BUDGETS)]
    for k, (kind, n, budgets) in enumerate(groups):
        fns = [_mixture_fl(torch, args.seed + DIST_SEED + 10 * k + b, n, args.d)
               if kind == "fl" else
               _dist_function(torch, kind, args.seed + DIST_SEED + 10 * k + b, n, args.d)
               for b in range(DIST_B)]
        for opt in ("NaiveGreedy", "LazyGreedy"):
            label = f"13 (t) {kind} wave B={DIST_B} n={n} {opt} {budgets[0]}"
            specs = _dist_specs(fns, opt, kind, budgets * (DIST_B // 2))
            seq, seq_wall, _ = _dist_timed(torch, lambda: [solve(s) for s in specs])
            batched, b_wall, b_launch = _dist_timed(torch, lambda: solve(specs,
                                                                         mode="batched"))
            # twice: the first wave also sets up the mesh's NCCL communicators
            s_walls = []
            for turn in range(2):
                with _counting_collectives() as colls:
                    sharded, s_wall, s_launch = _dist_timed(torch, lambda: solve(specs,
                                                                                 mesh=mesh))
                s_walls.append(s_wall)
                for b, (got, want) in enumerate(zip(sharded, seq)):
                    _same_bits(torch, f"{label} member {b} (sharded, turn {turn})", got, want)
            totals.update(s_launch)
            for b, (bat, want) in enumerate(zip(batched, seq)):
                _same_bits(torch, f"{label} member {b} (batched)", bat, want)
            if kind == "fl" and opt == "NaiveGreedy" and s_launch.get("fl_gains") != budgets[0]:
                raise AssertionError(f"{label}: {s_launch.get('fl_gains')} fl_gains launches, "
                                     f"not one a step ({budgets[0]})")
            if kind == "fl" and s_launch != b_launch:
                raise AssertionError(f"{label}: sharded launches {s_launch} differ from the "
                                     f"batched wave's {b_launch}")
            out[label] = {"sharded_s": s_walls, "batched_s": b_wall, "sequential_s": seq_wall,
                          "sharded_launches": s_launch, "batched_launches": b_launch,
                          "collectives": dict(colls)}
            log(f"  ok  {label}: every member bit-equal to its sequential solve; sharded "
                f"{' / '.join(f'{t:.3f}' for t in s_walls)} s (turns 1 / 2), batched "
                f"{b_wall:.3f} s, sequential {seq_wall:.3f} s; "
                f"launches sharded {s_launch}, batched {b_launch}; collectives {dict(colls)}")
        del fns
        torch.cuda.empty_cache()
    out["launches"] = dict(totals)
    return out


def _stochastic_reference(torch, S, budget: int, key, s: int, shards: int):
    """The stochastic partition greedy's semantics on one device, plainly:
    each column shard's sample of fold_in(fold_in(key, i), shard), the
    gains of the sampled columns over every row, the best of each shard,
    the best of those (the lowest id on a tie)."""
    from repro_torch.common import NEG_INF, relu_col_sums
    from repro_torch.core.optimizers import _threefry
    from repro_torch.core.optimizers.greedy import _draw_keys, _sample_unselected

    U, n = S.shape
    V = n // shards
    rev = 0xFFFFFFFF - torch.arange(V, dtype=torch.int64, device=S.device)
    curmax = torch.zeros((U,), device=S.device)
    selected = torch.zeros((n,), dtype=torch.bool, device=S.device)
    ids, gains = [], []
    for i in range(budget):
        best = None
        for c in range(shards):
            sub = _threefry.fold_in(_threefry.fold_in(key, i), c)
            keys = _draw_keys(_threefry.random_bits(sub, V, S.device) >> 9, rev)
            cand = _sample_unselected(keys, selected[c * V : (c + 1) * V], rev, s) + c * V
            g = torch.where(selected[cand], NEG_INF, relu_col_sums(S, curmax, cand))
            bi = int(torch.argmax(g))
            if best is None or float(g[bi]) > best[0]:
                best = (float(g[bi]), int(cand[bi]))
        ids.append(best[1])
        gains.append(best[0])
        curmax = torch.maximum(curmax, S[:, best[1]])
        selected[best[1]] = True
    return ids, gains


def _partition_2x2(torch, args, mesh, rank: int) -> dict:
    """(u) The partition greedies on the ("data", "model") mesh: FL at
    phase 4's n, each rank's block cut from S built on one rank at a time;
    the stochastic and FLQMI ones at DIST_PART_N, with rank 0's plain
    references."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.core import (
        FLQMI, create_kernel, distributed_fl_greedy, distributed_flqmi_greedy,
        distributed_stochastic_fl_greedy, naive_greedy,
    )
    from repro_torch.core.optimizers import _threefry

    out, totals = {}, collections.Counter()
    data, model = mesh.get_coordinate()
    h = args.n // 2
    block = None
    x = gaussian_mixture(args.seed, args.n, args.d)  # on the host, the ranks at once
    for r in range(dist.get_world_size()):  # one rank's 10 GB S at a time
        if r == rank:
            S = create_kernel(x, metric="cosine", use_pallas=True)
            block = S[model * h : (model + 1) * h, data * h : (data + 1) * h].clone()
            del S
            torch.cuda.empty_cache()
        dist.barrier()
    sim = DTensor.from_local(block, mesh, [Shard(1), Shard(0)])
    (order, gains), wall, launches = _dist_timed(torch, lambda: distributed_fl_greedy(
        sim, DIST_2X2_FL_BUDGET, mesh, row_axes=("model",), col_axes=("data",)))
    totals.update(launches)
    out["fl"] = {"ids": order.cpu().tolist(), "gains": gains.cpu().tolist(), "wall_s": wall,
                 "launches": launches}
    del sim, block
    torch.cuda.empty_cache()

    x = gaussian_mixture_cuda(torch, args.seed + DIST_SEED + 500, DIST_PART_N, args.d)
    S = create_kernel(x, metric="cosine", use_pallas=True)
    sim_qv = create_kernel(gaussian_mixture_cuda(torch, args.seed + DIST_SEED + 501,
                                                 SERVE_QUERIES, args.d), x, metric="cosine",
                           use_pallas=True)
    modular = sim_qv.amax(dim=0)
    key = _threefry.prng_key(args.seed)
    runs = {
        "stochastic": lambda: distributed_stochastic_fl_greedy(
            S, DIST_PART_BUDGET, mesh, key, sample_per_shard=DIST_SAMPLE),
        "flqmi": lambda: distributed_flqmi_greedy(sim_qv, modular, DIST_PART_BUDGET, mesh),
    }
    for name, run in runs.items():
        (order, gains), wall, launches = _dist_timed(torch, run)
        totals.update(launches)
        out[name] = {"ids": order.cpu().tolist(), "gains": gains.cpu().tolist(), "wall_s": wall,
                     "launches": launches}
    if rank == 0:  # the plain references
        out["stochastic"]["ref"] = _stochastic_reference(torch, S, DIST_PART_BUDGET, key,
                                                         DIST_SAMPLE, 2)
        ref = naive_greedy(FLQMI(sim_qv=sim_qv, modular=modular, n=DIST_PART_N),
                           DIST_PART_BUDGET, False, False)
        out["flqmi"]["ref"] = (ref.order.cpu().tolist(), ref.gains.cpu().tolist())
    out["launches"] = dict(totals)
    return out


def _rank_2x2(args) -> int:
    """One rank of (u)'s 2x2 world on the one card, over gloo: every family's
    waves on ("batch", "data"), then the partition greedies on ("data",
    "model"); its results go to DIR/rank{r}.json."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.core import make_mesh, solve

    rank, tmp = args.rank_2x2, Path(args.dir_2x2)
    timeout = datetime.timedelta(seconds=DIST_PG_TIMEOUT_S)
    dist.init_process_group("gloo", init_method=f"file://{tmp / 'store'}", rank=rank,
                            world_size=DIST_B, timeout=timeout)
    try:
        out = {"rank": rank, "failures": [], "families": {}}
        totals = collections.Counter()
        mesh = make_mesh((2, 2), ("batch", "data"), timeout=timeout)
        t_fam = time.perf_counter()
        for k, kind in enumerate(DIST_KINDS):
            fns = [_dist_function(torch, kind, args.seed + DIST_SEED + 100 + 10 * k + b,
                                  DIST_N, args.d) for b in range(DIST_B)]
            for opt in ("NaiveGreedy", "LazyGreedy"):
                label = f"13 (u) {kind} B={DIST_B} n={DIST_N} {opt} {DIST_BUDGETS[0]}"
                specs = _dist_specs(fns, opt, kind, DIST_BUDGETS * (DIST_B // 2))
                seq = [solve(s) for s in specs] if rank == 0 else None
                res, wall, launches = _dist_timed(torch, lambda: solve(specs, mesh=mesh))
                totals.update(launches)
                for b in range(DIST_B if rank == 0 else 0):
                    try:
                        _same_bits(torch, f"{label} member {b}", res[b], seq[b])
                    except AssertionError as e:  # reported once every rank is done
                        out["failures"].append(str(e))
                out["families"][label] = {"wall_s": wall, "launches": launches,
                                          "digest": _digest(res)}
            del fns
            torch.cuda.empty_cache()
        out["families_s"] = time.perf_counter() - t_fam
        mesh_dm = make_mesh((2, 2), ("data", "model"), timeout=timeout)
        t_part = time.perf_counter()
        out["partition"] = _partition_2x2(torch, args, mesh_dm, rank)
        out["partition_s"] = time.perf_counter() - t_part
        totals.update(out["partition"]["launches"])
        out["launches"] = dict(totals)
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        (tmp / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()
    return 0


def _dist_2x2(torch, args, t_out: dict) -> dict:
    """(u) Four ranks on the one card over gloo, spawned and joined here."""
    import tempfile

    tmp = Path(tempfile.mkdtemp())
    argv = [sys.executable, str(ROOT / "chip_smoke.py"), "--n", str(args.n), "--d", str(args.d),
            "--seed", str(args.seed), "--naive-budget", str(args.naive_budget),
            "--dir-2x2", str(tmp)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(argv + ["--rank-2x2", str(r)], stdout=open(tmp / f"rank{r}.out", "w"),
                              stderr=subprocess.STDOUT) for r in range(DIST_B)]
    try:
        for p in procs:
            p.wait(timeout=max(1.0, DIST_JOIN_TIMEOUT_S - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError(f"13 (u): the 2x2 world did not finish in {DIST_JOIN_TIMEOUT_S} s")
    finally:
        for p in procs:
            p.wait()
    bad = [f"rank {r} exit {p.returncode}:\n{(tmp / f'rank{r}.out').read_text()[-3000:]}"
           for r, p in enumerate(procs) if p.returncode]
    if bad:
        raise AssertionError("13 (u): " + "\n".join(bad))
    ranks = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(DIST_B)]
    wall = time.perf_counter() - t0
    failures = [f for r in ranks for f in r["failures"]]
    if failures:
        raise AssertionError("13 (u): " + "\n".join(failures))
    for label, fam in ranks[0]["families"].items():
        if any(r["families"][label]["digest"] != fam["digest"] for r in ranks[1:]):
            raise AssertionError(f"{label}: the ranks' batches differ")
        log(f"  ok  {label}: every member bit-equal to rank 0's sequential solve, the same "
            f"batch on every rank; {fam['wall_s']:.3f} s, rank 0's launches {fam['launches']}")
    out = {"seconds": wall, "families_s": [r["families_s"] for r in ranks],
           "partition_s": [r["partition_s"] for r in ranks],
           "peak_bytes": [r["peak_bytes"] for r in ranks],
           "families": ranks[0]["families"]}
    part = [r["partition"] for r in ranks]
    for name in ("fl", "stochastic", "flqmi"):
        if any(p[name]["ids"] != part[0][name]["ids"] for p in part[1:]):
            raise AssertionError(f"13 (u) {name} partition greedy: the ranks' ids differ")
    t_fl = t_out["fl_partition"]
    out["fl_partition"] = _agree_to_near_tie(
        f"13 (u) distributed_fl_greedy {DIST_2X2_FL_BUDGET} on 2x2 (rows over model) vs (t)",
        part[0]["fl"]["ids"], part[0]["fl"]["gains"], t_fl["ids"], t_fl["gains"])
    for name in ("stochastic", "flqmi"):
        ids, gains = part[0][name]["ref"]
        out[name] = _agree_to_near_tie(
            f"13 (u) distributed_{name} {DIST_PART_BUDGET} at n={DIST_PART_N} vs its plain "
            f"reference", part[0][name]["ids"], part[0][name]["gains"], ids, gains)
    out["partition_walls_s"] = {name: part[0][name]["wall_s"]
                                for name in ("fl", "stochastic", "flqmi")}
    launches = collections.Counter()
    for r in ranks:
        launches.update(r["launches"])
    out["launches"] = dict(launches)
    log(f"  13 (u): {wall:.1f} s in all; families {out['families_s']} s, partition "
        f"{out['partition_s']} s by rank; peak per rank "
        f"{[round(b / 2**30, 2) for b in out['peak_bytes']]} GiB; launches {out['launches']}")
    return out


def phase_distributed(torch, args, main: dict | None) -> dict:
    """Phase 13: the distributed engine, (t) a world of 1 on NCCL in this
    process and (u) a spawned 2x2 world of four ranks on the card over
    gloo."""
    from repro_torch.core import FacilityLocation, create_kernel, naive_greedy

    t_start = time.perf_counter()
    log(f"== phase 13: the distributed engine (n={args.n}, d={args.d})")
    if main is None:  # phase 13 alone: phase 4's NaiveGreedy ids and gains
        S = create_kernel(gaussian_mixture(args.seed, args.n, args.d), metric="cosine",
                          use_pallas=True)
        naive = naive_greedy(FacilityLocation.from_kernel(S, use_kernel=None), args.naive_budget)
        main = {"naive_ids": naive.order.cpu().tolist(),
                "naive_gains": naive.gains.cpu().tolist()}
        del S, naive
        torch.cuda.empty_cache()
    else:
        main = dict(main, first_near_tie=main["NaiveGreedy"]["first_near_tie"])
    out = {"t": _dist_world_of_one(torch, args, main)}
    torch.cuda.empty_cache()
    out["u"] = _dist_2x2(torch, args, out["t"])
    launches = collections.Counter(out["t"]["launches"])
    launches.update(out["u"]["launches"])
    out["launches"] = dict(launches)
    for k in SHARDED_KERNELS:
        if not launches.get(k):
            raise AssertionError(f"phase 13: kernel {k} was not launched on the sharded path")
    out["seconds"] = time.perf_counter() - t_start
    log(f"  phase 13 launches on the sharded path (t) + (u): {out['launches']}")
    log(f"phase 13: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 14: serving on a mesh, and the training pipeline's selection stage
# ---------------------------------------------------------------------------

MESH_SEED = 14000
MESH_REQUESTS = 26  # (v): each of the 13 families with a shard rule, NaiveGreedy and LazyGreedy
MESH_N = SERVE_N  # (v): n in {3,072, 4,096, 6,144, 8,192}
MESH_BUDGETS = (50, 100)
MESH_ASYNC = 8  # (v): the first requests again, through AsyncSelectionServer
MESH_SESSION_N, MESH_SESSION_DELTAS = 3072, (1000, 37, 2048)  # (v): an FB session
MESH_2X2_REQUESTS = 32  # (w)
MESH_2X2_N = (2048, 4096)
MESH_2X2_ODD_N = 4097  # (w): FL requests the data axis of 2 does not divide, at the kernel gate
MESH_CONTROL_S = 60  # (w): the control group's timeout (idle headers every 15 s)
MESH_JOIN_TIMEOUT_S = 300  # (w): the parent kills the world after this
SELECT_ARCH = "qwen3-0.6b"  # (x): the pool's width is its d_model, 1,024
SELECT_N = 16384  # (x): launch/dryrun.py's represented rows
SELECT_BUDGET = 512
SELECT_EXTRA = 100  # (x): query and private items
SELECT_OBJECTIVES = ("representative", "targeted", "diverse", "privacy")
MESH_KERNELS = SHARDED_KERNELS + ("similarity",)


def _mesh_specs(torch, args, count: int, ns, budgets, seed: int, odd_n=None) -> list:
    """Requests of the 13 families with a shard rule (GraphCut and Disparity*
    memoized, use_kernel=False, as a mesh takes them): request i is family
    DIST_KINDS[(i // 2) % 13], n drawn from ``ns`` by ``seed`` + i, a budget
    in ``budgets``, NaiveGreedy for even i and LazyGreedy for odd i;
    ``odd_n`` replaces the n of requests 0 and 1 (FL, NaiveGreedy and
    LazyGreedy)."""
    specs = []
    for i in range(count):
        rng = np.random.default_rng(seed + i)
        kind = DIST_KINDS[(i // 2) % len(DIST_KINDS)]
        n = int(rng.choice(ns)) if i > 1 or odd_n is None else odd_n
        budget = int(rng.integers(budgets[0], budgets[1] + 1))
        fn = _dist_function(torch, kind, seed + i, n, args.d)
        specs += _dist_specs([fn], ("NaiveGreedy", "LazyGreedy")[i % 2], kind, [budget])
    return specs


def _mesh_served_checks(torch, label, server, responses, sequential) -> dict:
    """Every answer bit-equal to its sequential solve, none degraded, no
    retry, failure or breaker; rank 0's mesh waves are the server's waves."""
    for i, (resp, want) in enumerate(zip(responses, sequential)):
        _held(torch, f"{label} request {i}", resp, want)
        if resp.degraded is not None:
            raise AssertionError(f"{label} request {i}: served {resp.degraded}")
    _no_trouble(label, server, responses)
    summary = server.stats.summary()
    if summary["fallbacks_total"]:
        raise AssertionError(f"{label}: {summary['fallbacks_total']} waves fell back")
    mesh = server.mesh_stats
    if mesh["waves"] != summary["waves"]:
        raise AssertionError(f"{label}: {mesh['waves']} mesh waves of {summary['waves']}")
    return {"summary": summary, "mesh_waves": mesh["waves"], "plan_bytes": mesh["plan_bytes"],
            "broadcast_s": mesh["broadcast_s"]}


def _mesh_world_of_one(torch, args) -> dict:
    """(v) A world of 1 on NCCL: SelectionServer, AsyncSelectionServer and an
    FB session on a (1, 1) mesh, then a wave under a dispatch fault."""
    from repro_torch.core import FeatureBased, SelectionSpec, solve
    from repro_torch.kernels import ops
    from repro_torch.launch import faults
    from repro_torch.launch.async_serve import AsyncSelectionServer
    from repro_torch.launch.resilience import BreakerBoard, RetryPolicy
    from repro_torch.launch.serve import SelectionServer

    mesh = _world_of_one()["bd"]
    totals, out = collections.Counter(), {}
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    specs = _mesh_specs(torch, args, MESH_REQUESTS, MESH_N, MESH_BUDGETS, args.seed + MESH_SEED)
    torch.cuda.synchronize()
    out["build"] = {"s": time.perf_counter() - t0, "launches": _launch_counts()}
    totals.update(out["build"]["launches"])
    seq, seq_wall, _ = _dist_timed(torch, lambda: [solve(s) for s in specs])
    server = SelectionServer(mesh=mesh)
    responses, wall, launches = _dist_timed(torch, lambda: server.select(specs))
    totals.update(launches)
    out["sync"] = _mesh_served_checks(torch, "14 (v) mesh server", server, responses, seq)
    out["sync"].update(wall_s=wall, sequential_s=seq_wall, launches=launches,
                       latency=_latency_summary(responses))
    server.close()
    log(f"  ok  14 (v) SelectionServer(mesh=(1, 1) NCCL): {len(specs)} requests in {wall:.3f} s "
        f"(sequential {seq_wall:.3f} s), {out['sync']['summary']['waves']} mesh waves, "
        f"{out['sync']['plan_bytes']} plan bytes; latency p50 "
        f"{out['sync']['latency']['p50_s']:.4f} p99 {out['sync']['latency']['p99_s']:.4f} s; "
        f"launches {launches}; every answer bit-equal to its sequential solve, 0 fallbacks")

    front = AsyncSelectionServer(mesh=mesh, max_pending=SERVE_MAX_PENDING,
                                 flush_interval=SERVE_FLUSH_INTERVAL)
    sub = specs[:MESH_ASYNC]

    def run_async():
        futures = [front.submit(s) for s in sub]
        return [f.result(timeout=600) for f in futures]

    responses, wall, launches = _dist_timed(torch, run_async)
    totals.update(launches)
    out["async"] = _mesh_served_checks(torch, "14 (v) mesh async", front._server, responses,
                                       seq[:MESH_ASYNC])
    out["async"].update(wall_s=wall, launches=launches, flushes=front.flushes)
    front.close()
    log(f"  ok  14 (v) AsyncSelectionServer(mesh=): {len(sub)} requests in {wall:.3f} s, "
        f"{front.flushes} flushes, launches {launches}; every answer bit-equal")

    x = torch.relu(gaussian_mixture_cuda(torch, args.seed + MESH_SEED - 1,
                                          MESH_SESSION_N + sum(MESH_SESSION_DELTAS), args.d))
    server = SelectionServer(mesh=mesh)
    cuts = list(itertools.accumulate((MESH_SESSION_N,) + MESH_SESSION_DELTAS))

    def spec(rows):
        return SelectionSpec(FeatureBased.from_features(rows, concave="sqrt", use_kernel=None),
                             SESSION_BUDGET, "LazyGreedy", screen_k=WAVE_SCREEN_K)

    def run_session():
        sess = server.open_session(spec(x[: cuts[0]]))
        return [sess.extend(features=x[lo:hi]) for lo, hi in zip(cuts, cuts[1:])]

    updates, wall, launches = _dist_timed(torch, run_session)
    totals.update(launches)
    for upd, hi in zip(updates, cuts[1:]):
        _held(torch, f"14 (v) mesh FB session at n = {hi}", upd.result, solve(spec(x[:hi])))
    out["session"] = _mesh_served_checks(torch, "14 (v) mesh session", server,
                                         [u.response for u in updates], [])
    out["session"].update(wall_s=wall, launches=launches, n=cuts)
    server.close()
    log(f"  ok  14 (v) FB session on the mesh, n {cuts}: every update bit-equal to solve() "
        f"over the stream so far; {wall:.3f} s")

    server = SelectionServer(mesh=mesh, retry_policy=RetryPolicy(max_attempts=2, backoff_s=0.0,
                                                                 jitter=0.0),
                             breakers=BreakerBoard(threshold=1))
    plan = faults.FaultPlan([faults.FaultSpec(site="dispatch", mesh=True, times=None)])

    def run_fault():
        with faults.inject(plan):
            return server.select(specs[:1])

    (resp,), wall, launches = _dist_timed(torch, run_fault)
    totals.update(launches)
    _held(torch, "14 (v) the degraded wave", resp, seq[0])
    fallbacks = server.stats.summary()["fallbacks_total"]
    state = server.breakers.states().get(f"{type(specs[0].fn).__name__}/mesh")
    if resp.degraded != "single-device" or fallbacks != 1 or state != "open":
        raise AssertionError(f"14 (v) dispatch fault on the mesh: degraded {resp.degraded}, "
                             f"fallbacks {fallbacks}, mesh breaker {state}")
    out["fault"] = {"degraded": resp.degraded, "fallbacks_total": fallbacks, "attempts":
                    resp.attempts, "fired": plan.counts()[0]["fired"], "wall_s": wall}
    server.close()
    log(f"  ok  14 (v) dispatch faults on the mesh: the mesh breaker opened, the wave came back "
        f"degraded={resp.degraded!r}, bit-equal, counted (fallbacks_total {fallbacks})")
    out["launches"] = dict(totals)
    del specs, seq, x
    torch.cuda.empty_cache()
    return out


def _rank_mesh(args) -> int:
    """One rank of (w)'s 2x2 ("batch", "data") world on the one card over
    gloo: rank 0 serves MESH_2X2_REQUESTS requests through a mesh server
    and holds each against its sequential solve; the others follow.  Its
    results go to DIR/rank{r}.json."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.core import make_mesh, solve
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import SelectionServer

    rank, tmp = args.rank_mesh, Path(args.dir_mesh)
    timeout = datetime.timedelta(seconds=DIST_PG_TIMEOUT_S)
    dist.init_process_group("gloo", init_method=f"file://{tmp / 'store'}", rank=rank,
                            world_size=4, timeout=timeout)
    try:
        mesh = make_mesh((2, 2), ("batch", "data"), timeout=timeout)
        wave_digests = []  # each mesh wave's whole batch, on every rank
        server = SelectionServer(mesh=mesh,
                                 control_timeout=datetime.timedelta(seconds=MESH_CONTROL_S),
                                 on_mesh_wave=lambda res: wave_digests.append(_digest(res)))
        out = {"rank": rank, "failures": []}
        if server.is_follower:
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            server.follow()
            torch.cuda.synchronize()
            out.update(followed=True, follow_s=time.perf_counter() - t0,
                       launches=_launch_counts())
        else:
            specs = _mesh_specs(torch, args, MESH_2X2_REQUESTS, MESH_2X2_N, DIST_BUDGETS[::-1],
                                args.seed + MESH_SEED + 500, odd_n=MESH_2X2_ODD_N)
            seq, seq_wall, _ = _dist_timed(torch, lambda: [solve(s) for s in specs])
            try:
                responses, wall, launches = _dist_timed(torch, lambda: server.select(specs))
            finally:
                server.close()
            for i, (resp, want) in enumerate(zip(responses, seq)):
                try:
                    _held(torch, f"14 (w) request {i}", resp, want)
                except AssertionError as e:  # reported once every rank is done
                    out["failures"].append(str(e))
            mesh_stats = server.mesh_stats
            out.update(wall_s=wall, sequential_s=seq_wall, launches=launches,
                       summary=server.stats.summary(), plans=mesh_stats["plans"],
                       plan_bytes=mesh_stats["plan_bytes"], broadcast_s=mesh_stats["broadcast_s"],
                       odd=[[specs[i].fn.n, responses[i].n_bucket, responses[i].backend]
                            for i in (0, 1)],
                       degraded=[r.degraded for r in responses if r.degraded],
                       latency=_latency_summary(responses))
        out.update(waves=server.mesh_stats["waves"], digest=_digest_of(wave_digests),
                   peak_bytes=torch.cuda.max_memory_allocated())
        (tmp / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()
    return 0


def _mesh_2x2(torch, args) -> dict:
    """(w) Four ranks on the one card over gloo, spawned and joined here."""
    import tempfile

    tmp = Path(tempfile.mkdtemp())
    argv = [sys.executable, str(ROOT / "chip_smoke.py"), "--d", str(args.d), "--seed",
            str(args.seed), "--dir-mesh", str(tmp)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(argv + ["--rank-mesh", str(r)], stdout=open(tmp / f"rank{r}.out", "w"),
                              stderr=subprocess.STDOUT) for r in range(4)]
    try:
        for p in procs:
            p.wait(timeout=max(1.0, MESH_JOIN_TIMEOUT_S - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError(f"14 (w): the 2x2 world did not finish in {MESH_JOIN_TIMEOUT_S} s")
    finally:
        for p in procs:
            p.wait()
    bad = [f"rank {r} exit {p.returncode}:\n{(tmp / f'rank{r}.out').read_text()[-3000:]}"
           for r, p in enumerate(procs) if p.returncode]
    if bad:
        raise AssertionError("14 (w): " + "\n".join(bad))
    ranks = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(4)]
    wall = time.perf_counter() - t0
    lead = ranks[0]
    if lead["failures"]:
        raise AssertionError("14 (w): " + "\n".join(lead["failures"]))
    for r in ranks[1:]:
        if not r.get("followed") or r["waves"] != lead["waves"] or r["digest"] != lead["digest"]:
            raise AssertionError(f"14 (w) rank {r['rank']}: followed {r.get('followed')}, "
                                 f"{r['waves']} waves of rank 0's {lead['waves']}, digest "
                                 f"{'equal' if r['digest'] == lead['digest'] else 'differs'}")
    s = lead["summary"]
    if s["fallbacks_total"] or lead["degraded"] or s["padded_slots"] < 1:
        raise AssertionError(f"14 (w): fallbacks {s['fallbacks_total']}, degraded "
                             f"{lead['degraded']}, padded slots {s['padded_slots']}")
    if (any(n != MESH_2X2_ODD_N or bucket != n + 1 or backend == "torch"
            for n, bucket, backend in lead["odd"])
            or not (lead["launches"].get("fl_gains") and lead["launches"].get("fl_gains_at"))):
        raise AssertionError(f"14 (w): the odd FL requests (n, bucket, backend) {lead['odd']} "
                             f"with rank 0's launches {lead['launches']}")
    plans = lead["plans"]
    share = sum(p["broadcast_s"] for p in plans) / max(sum(p["wave_s"] for p in plans), 1e-9)
    launches = collections.Counter()
    for r in ranks:
        launches.update(r["launches"])
    out = {"seconds": wall, "wall_s": lead["wall_s"], "sequential_s": lead["sequential_s"],
           "waves": lead["waves"], "padded_slots": s["padded_slots"], "slots": s["slots"],
           "fallbacks_total": s["fallbacks_total"], "plan_bytes": lead["plan_bytes"],
           "broadcast_s": lead["broadcast_s"], "broadcast_share": share,
           "plans": [[p["bytes"], round(p["broadcast_s"], 6), round(p["wave_s"], 6)]
                     for p in plans],
           "latency": lead["latency"], "follow_s": [r["follow_s"] for r in ranks[1:]],
           "peak_bytes": [r["peak_bytes"] for r in ranks], "launches": dict(launches),
           "odd_fl": lead["odd"]}
    log(f"  ok  14 (w) 2x2 mesh over gloo on one card: {MESH_2X2_REQUESTS} requests in "
        f"{lead['wall_s']:.3f} s (sequential {lead['sequential_s']:.3f} s), {lead['waves']} mesh "
        f"waves, padded slots {s['padded_slots']} of {s['slots']}, fallbacks "
        f"{s['fallbacks_total']}; the FL requests (n, bucket, backend) {lead['odd']}; every "
        f"answer bit-equal to rank 0's sequential solve; each "
        f"follower ran rank 0's {lead['waves']} waves (digests equal) and ended at close()")
    log(f"  14 (w) plans: {lead['plan_bytes']} bytes in all, per plan "
        f"{min(p['bytes'] for p in plans)}..{max(p['bytes'] for p in plans)}; broadcast "
        f"{lead['broadcast_s']:.3f} s, {100 * share:.1f}% of the waves' wall; peak per rank "
        f"{[round(b / 2**30, 2) for b in out['peak_bytes']]} GiB; {wall:.1f} s in all; "
        f"launches {out['launches']}")
    return out


def _unit_rows(torch, x):
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


def _selector_parting(torch, label, fn, plain_fn, ids, ref) -> dict:
    """Ids of the kernel route equal the plain route's up to their first
    difference, where the two picks must be a near-tie within twice what the
    two routes' gains differ by at that state (each route's kernel)."""
    parted = np.nonzero(np.asarray(ids) != np.asarray(ref))[0]
    t = int(parted[0]) if parted.size else len(ids)
    if not parted.size:
        log(f"  ok  {label}: ids equal to the plain route's over all {t} picks")
        return {"agreeing_steps": t, "steps": len(ids)}
    state, pstate = fn.init_state(), plain_fn.init_state()
    for j in ids[:t]:
        jt = torch.tensor([int(j)], device="cuda")
        state, pstate = fn.update(state, jt), plain_fn.update(pstate, jt)
    g, pg = fn.gains(state).float(), plain_fn.gains(pstate).float()
    a, b = int(ids[t]), int(ref[t])
    spread = float((g - pg).abs().max())
    gaps = (float(g[a] - g[b]), float(pg[b] - pg[a]))
    if not all(0.0 <= gap <= 2 * spread for gap in gaps):
        raise AssertionError(f"{label}: ids part at step {t} ({a} against {b}) with top-two "
                             f"gaps {gaps} beyond twice the routes' spread {spread}")
    log(f"  ok  {label}: ids equal to the plain route's over {t} of {len(ids)} picks, then a "
        f"near-tie (top-two gaps {gaps}, the routes' gains {spread} apart)")
    return {"agreeing_steps": t, "steps": len(ids), "top_two_gap": gaps, "spread": spread}


def _selector(torch, args) -> dict:
    """(x) SubmodularSelector on a qwen3-0.6b-wide pool: the four objectives
    under LazyGreedy on the kernel route against the plain route, then
    selection_step on the world of 1 against a single-device FL NaiveGreedy
    on the same S."""
    from repro_torch.configs.base import get_config
    from repro_torch.core import FacilityLocation, SelectionSpec, create_kernel, solve
    from repro_torch.data.selection import SelectorConfig, SubmodularSelector

    cfg = get_config(SELECT_ARCH)
    d, seed = cfg.d_model, args.seed + MESH_SEED + 900
    pool = _unit_rows(torch, gaussian_mixture_cuda(torch, seed, SELECT_N, d))
    q = _unit_rows(torch, gaussian_mixture_cuda(torch, seed + 1, SELECT_EXTRA, d))
    p = _unit_rows(torch, gaussian_mixture_cuda(torch, seed + 2, SELECT_EXTRA, d))
    totals, out = collections.Counter(), {"d": d, "n": SELECT_N, "budget": SELECT_BUDGET}
    for objective in SELECT_OBJECTIVES:
        def selector(kernels):
            return SubmodularSelector(cfg, SelectorConfig(objective=objective,
                                                          budget=SELECT_BUDGET,
                                                          use_pallas_kernel=kernels))

        kern, plain = selector(True), selector(False)
        ids, wall, launches = _dist_timed(torch, lambda: kern.select(pool, q, p))
        totals.update(launches)
        ref, plain_wall, plain_launches = _dist_timed(torch, lambda: plain.select(pool, q, p))
        if plain_launches:
            raise AssertionError(f"14 (x) {objective}: the plain route launched {plain_launches}")
        if len(ids) != SELECT_BUDGET or len(set(ids.tolist())) != len(ids):
            raise AssertionError(f"14 (x) {objective}: {len(ids)} ids, "
                                 f"{len(set(ids.tolist()))} distinct")
        label = f"14 (x) {objective} LazyGreedy {SELECT_BUDGET} (kernel vs plain route)"
        out[objective] = _selector_parting(torch, label, kern.build_function(pool, q, p),
                                           plain.build_function(pool, q, p), ids, ref)
        out[objective].update(wall_s=wall, plain_s=plain_wall, launches=launches)
        log(f"  14 (x) {objective}: {wall:.3f} s (plain route {plain_wall:.3f} s), launches "
            f"{launches}")
        torch.cuda.empty_cache()
    mesh = _world_of_one()["dm"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sel = SubmodularSelector(cfg, SelectorConfig(budget=SELECT_BUDGET))
    (order, gains), wall, launches = _dist_timed(torch, lambda: sel.selection_step(pool, mesh))
    peak = torch.cuda.max_memory_allocated()
    totals.update(launches)
    S = create_kernel(pool, metric="euclidean", use_pallas=True)
    # distributed_fl_greedy stops at a zero gain and never at a negative one
    ref, direct_wall, _ = _dist_timed(torch, lambda: solve(SelectionSpec(
        FacilityLocation.from_kernel(S, use_kernel=True), SELECT_BUDGET, "NaiveGreedy",
        stopIfZeroGain=True, stopIfNegativeGain=False)))
    o2, g2 = ref.order.to(order.device), ref.gains.to(gains.device)
    if not (torch.equal(order, o2) and torch.equal(gains.view(torch.int32), g2.view(torch.int32))):
        raise AssertionError("14 (x) selection_step parts from the single-device FL NaiveGreedy "
                             "on its S")
    out["selection_step"] = {"wall_s": wall, "single_device_s": direct_wall,
                             "launches": launches, "peak_bytes": peak,
                             "picked": int((order >= 0).sum())}
    log(f"  ok  14 (x) selection_step on the world of 1 ({SELECT_BUDGET} picks of {SELECT_N}): "
        f"{wall:.3f} s, ids and gains bit-equal to a single-device FL NaiveGreedy on its kernel "
        f"({direct_wall:.3f} s); peak {peak / 2**30:.2f} GiB; launches {launches}")
    out["launches"] = dict(totals)
    del pool, q, p, S
    torch.cuda.empty_cache()
    return out


def phase_mesh_served(torch, args) -> dict:
    """Phase 14: (v) serving on a (1, 1) NCCL mesh, (w) a 2x2 mesh of four
    ranks over gloo, (x) the selection stage."""
    t_start = time.perf_counter()
    log(f"== phase 14: serving on a mesh and the selection stage (d = {args.d})")
    out = {}
    try:
        out["v"] = _mesh_world_of_one(torch, args)
        out["x"] = _selector(torch, args)
    finally:
        _close_world_of_one()
    out["w"] = _mesh_2x2(torch, args)
    launches = collections.Counter()
    for part in ("v", "w", "x"):
        launches.update(out[part]["launches"])
    out["launches"] = dict(launches)
    missing = [k for k in MESH_KERNELS if not launches.get(k)]
    if missing:
        raise AssertionError(f"phase 14: kernels not launched on the mesh-served path: {missing}")
    out["seconds"] = time.perf_counter() - t_start
    log(f"  phase 14 launches on the mesh-served path (v) + (w) + (x): {out['launches']}")
    log(f"phase 14: {out['seconds']:.1f} s")
    return out


TRAIN_ARCH = "qwen3-0.6b"  # phase 15: the reference's config, full width
TRAIN_BATCH = 16
TRAIN_SEQ = 256
TRAIN_SELECT_EVERY = 64  # a coreset of 1,024 from a pool of 4,096 (KERNEL_MIN_N)
TRAIN_POOL_FACTOR = 4
TRAIN_STEPS = 8  # (y) the first run: one selection round, a checkpoint at its end
TRAIN_RESUME_STEPS = 12  # the second run resumes at 8: a fresh round, 4 steps
FIXED_STEPS = 8  # (y) make_train_step on one fixed batch
FIXED_SCHEDULE = (1e-3, 2, 1000)  # cosine_schedule(base_lr, warmup, total)
TRAIN_KERNELS = ("similarity", "fl_gains", "fl_gains_at")
BF16_PEAK_FLOPS = 989e12  # H100 SXM dense bf16


class _TrainProbe:
    """Instruments ``repro_torch.launch.train`` from outside while ``run()``
    runs: CUDA events around each ``embed_examples`` call, a synchronized
    host clock around each selection, train step, checkpoint save and
    restore (``run()`` reads each step's loss at once anyway); each round's
    pool embeddings and chosen ids, the state a save wrote and the state a
    restore gave are kept for the checks after the path's counts are read."""

    NAMES = ("embed_examples", "SubmodularSelector", "make_train_step", "ckpt")

    def __init__(self, torch, tr):
        self.torch, self.tr = torch, tr
        self.embed_events, self.selects, self.steps = [], [], []
        self.saves, self.restores = [], []
        self.saved = {}

    def _timed(self, fn, *a, **kw):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(*a, **kw)
        self.torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def __enter__(self):
        import types

        torch, tr, probe = self.torch, self.tr, self
        self.saved = {k: getattr(tr, k) for k in self.NAMES}
        embed, selector_cls, make_step, ckpt = (self.saved[k] for k in self.NAMES)

        def embed_examples(cfg, params, batch):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = embed(cfg, params, batch)
            ev[1].record()
            probe.embed_events.append(ev)
            return out

        class Selector(selector_cls):
            def select(self, pool_emb, *a, **kw):
                ids, wall = probe._timed(super().select, pool_emb, *a, **kw)
                probe.selects.append({"wall_s": wall, "emb": pool_emb.clone(),
                                      "ids": np.asarray(ids)})
                return ids

        def make_train_step(cfg, *a, **kw):
            step = make_step(cfg, *a, **kw)

            def timed(state, batch):
                (state, metrics), wall = probe._timed(step, state, batch)
                probe.steps.append({"wall_s": wall, "loss": float(metrics["loss"]),
                                    "grad_norm": float(metrics["grad_norm"])})
                return state, metrics

            return timed

        def save(ckpt_dir, step, tree, *a, **kw):
            path, wall = probe._timed(ckpt.save, ckpt_dir, step, tree, *a, **kw)
            probe.saves.append({"wall_s": wall, "step": step, "state": tree})
            return path

        def restore(ckpt_dir, like, *a, **kw):
            (tree, meta), wall = probe._timed(ckpt.restore, ckpt_dir, like, *a, **kw)
            probe.restores.append({"wall_s": wall, "step": meta["step"], "state": tree})
            return tree, meta

        tr.embed_examples, tr.SubmodularSelector = embed_examples, Selector
        tr.make_train_step = make_train_step
        tr.ckpt = types.SimpleNamespace(save=save, restore=restore,
                                        latest_step=ckpt.latest_step)
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            setattr(self.tr, k, v)

    def embed_s(self) -> float:
        self.torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.embed_events) / 1e3


def _forward_flops(cfg, layer_weights: int, tokens: int, seq: int) -> dict:
    """Matmul operations of one forward pass over ``tokens`` tokens: 2 per
    layer weight, the attention products over every key position (4 seq hd
    per head and token: the reference's dense attention masks, it does not
    skip) and the head's 2 d V."""
    attn = 4 * seq * cfg.n_heads * cfg.head_dim_ * cfg.n_layers * tokens
    return {"layers": 2 * layer_weights * tokens + attn,
            "head": 2 * cfg.d_model * cfg.vocab * tokens}


def _train_run(torch, tr, label, tag="15 (y)", **kw) -> dict:
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    with _TrainProbe(torch, tr) as probe:
        losses = tr.run(**kw)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    out = {"wall_s": wall, "losses": losses, "launches": launches, "steps": probe.steps,
           "embed_s": probe.embed_s(), "embed_calls": len(probe.embed_events),
           "select_s": [s["wall_s"] for s in probe.selects]}
    if len(losses) != len(probe.steps) or not losses:
        raise AssertionError(f"{tag} {label}: {len(losses)} losses, {len(probe.steps)} steps")
    if not np.isfinite(losses).all():
        raise AssertionError(f"{tag} {label}: non-finite losses {losses}")
    norms = [s["grad_norm"] for s in probe.steps]
    if not all(np.isfinite(g) and g > 0 for g in norms):
        raise AssertionError(f"{tag} {label}: grad norms {norms}")
    log(f"  {tag} {label}: {len(losses)} steps in {wall:.3f} s; losses {losses[0]:.4f} .. "
        f"{losses[-1]:.4f}; grad norms {min(norms):.4f} .. {max(norms):.4f}; launches "
        f"{launches}")
    return out, probe


def _device_profile(torch, fn, top: int = 8) -> dict:
    """One synchronized call of ``fn`` under ``torch.profiler``: its wall,
    the device's busy time (the kernels' summed time; one stream), the idle
    share, and the ops that launched the most device time.  Where the trace
    holds no device time it says so ("not measured") rather than a share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    ops_ = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in ops_) / 1e3
    out = {"wall_ms": wall * 1e3}
    if busy <= 0:
        out["device"] = "not measured: the trace holds no device time"
        return out
    ops_.sort(key=dev_us, reverse=True)
    out.update(busy_ms=busy, idle_share=max(0.0, 1.0 - busy / (wall * 1e3)),
               top=[{"op": e.key, "ms": dev_us(e) / 1e3, "calls": e.count} for e in ops_[:top]],
               launches=sum(e.count for e in prof.key_averages()
                            if e.device_type == DeviceType.CUDA))
    return out


def _log_profile(label: str, prof: dict, tag: str = "15 (y)") -> None:
    if "busy_ms" not in prof:
        log(f"  {tag} {label}: {prof['wall_ms']:.1f} ms; {prof['device']}")
        return
    top = "; ".join(f"{t['op']} {t['ms']:.1f} ms x{t['calls']}" for t in prof["top"])
    log(f"  {tag} {label} under the profiler: wall {prof['wall_ms']:.1f} ms, device busy "
        f"{prof['busy_ms']:.1f} ms (idle {100 * prof['idle_share']:.1f}%), "
        f"{prof['launches']} kernels; by op: {top}")


def _leaf_bits_equal(torch, a, b) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape or a.device != b.device:
        return False
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return bool(torch.equal(a, b))


def phase_train(torch, args, device: dict) -> dict:
    """Phase 15: (y) the training testbed's path at qwen3-0.6b's full width
    through ``repro_torch.launch.train.run``: embed a pool of 4,096, pick a
    1,024 coreset on the CUDA similarity and FL kernels, AdamW steps, a
    checkpoint, and a resumed run whose restored state must be the saved one
    bit for bit; then make_train_step on one fixed batch, profiled."""
    import shutil
    import statistics as st
    import tempfile

    import repro_torch.launch.train as tr
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs.base import get_config
    from repro_torch.core import create_kernel
    from repro_torch.data.pipeline import SyntheticTokens, embed_examples
    from repro_torch.data.selection import SelectorConfig, SubmodularSelector
    from repro_torch.kernels import ops
    from repro_torch.kernels.fl_gains import fl_gains_at_plain, fl_gains_plain
    from repro_torch.kernels.similarity_kernel import similarity_plain
    from repro_torch.train.optim import cosine_schedule
    from repro_torch.train.train_step import init_train_state, make_train_step
    from repro_torch.tree import tree_leaves

    t_start = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    pool_n = TRAIN_BATCH * TRAIN_SELECT_EVERY * TRAIN_POOL_FACTOR
    budget = TRAIN_BATCH * TRAIN_SELECT_EVERY
    log(f"== phase 15: the training testbed, {TRAIN_ARCH} full width ({cfg.n_layers} layers, "
        f"d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, vocab {cfg.vocab}, "
        f"{cfg.param_dtype}): batch {TRAIN_BATCH} x {TRAIN_SEQ}, pool {pool_n} -> coreset "
        f"{budget}")
    tmp = Path(tempfile.mkdtemp())
    out = {"arch": TRAIN_ARCH, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "pool": pool_n,
           "budget": budget}
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kw = dict(arch=TRAIN_ARCH, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                  select_every=TRAIN_SELECT_EVERY, pool_factor=TRAIN_POOL_FACTOR,
                  ckpt_dir=str(tmp / "run"), ckpt_every=TRAIN_STEPS, reduced=False,
                  seed=args.seed, log_every=4, device="cuda")
        first, probe = _train_run(torch, tr, "run", steps=TRAIN_STEPS, **kw)
        lo, hi = 0.2 * np.log(cfg.vocab), 3.0 * np.log(cfg.vocab)
        if not lo < first["losses"][0] < hi:
            raise AssertionError(f"15 (y) step-0 loss {first['losses'][0]} outside "
                                 f"({lo:.3f}, {hi:.3f})")
        log(f"  ok  15 (y) step-0 loss {first['losses'][0]:.4f} in (0.2, 3.0) x log(vocab) = "
            f"({lo:.3f}, {hi:.3f})")
        missing = [k for k in TRAIN_KERNELS if not first["launches"].get(k)]
        if missing:
            raise AssertionError(f"15 (y): kernels not launched on the training path: {missing}")
        if [sv["step"] for sv in probe.saves] != [TRAIN_STEPS] or \
                ckpt.latest_step(str(tmp / "run")) != TRAIN_STEPS:
            raise AssertionError(f"15 (y): not one checkpoint, at step {TRAIN_STEPS}")
        saved = probe.saves[0]
        # the kernels against their plain versions on this path's inputs
        emb, ids = probe.selects[0]["emb"], probe.selects[0]["ids"]
        S = create_kernel(emb, metric="euclidean", use_pallas=True)
        S_plain = similarity_plain(emb, emb, "euclidean")
        err = check_close(f"15 (y) similarity.cu on the pool's embeddings ({pool_n} x "
                          f"{cfg.d_model}, euclidean) vs plain", S, S_plain,
                          *SIM_TOL["euclidean"])
        sel = lambda kernels: SubmodularSelector(  # noqa: E731
            cfg, SelectorConfig(budget=budget, use_pallas_kernel=kernels))
        ref = sel(False).select(emb)
        parting = _selector_parting(torch, f"15 (y) the coreset's {budget} ids, kernel route",
                                    sel(True).build_function(emb),
                                    sel(False).build_function(emb), ids, ref)
        curmax = torch.zeros(pool_n, device="cuda")
        idx = torch.as_tensor(ids[:8].astype(np.int64), device="cuda")
        sim_ms = cuda_ms(torch, lambda: ops.similarity(emb, emb, "euclidean"), args.reps)
        sim_plain_ms = cuda_ms(torch, lambda: similarity_plain(emb, emb, "euclidean"), args.reps)
        fl_ms = cuda_ms(torch, lambda: ops.fl_gains(S, curmax), args.reps)
        fl_plain_ms = cuda_ms(torch, lambda: fl_gains_plain(S, curmax), args.reps)
        at_ms = cuda_ms(torch, lambda: ops.fl_gains_at(S, curmax, idx), args.reps)
        at_plain_ms = cuda_ms(torch, lambda: fl_gains_at_plain(S, curmax, idx), args.reps)
        n2 = pool_n * pool_n
        out["kernels"] = {
            "similarity": {"shape": f"({pool_n},{cfg.d_model}) both sides, euclidean",
                           "ms": sim_ms, "plain_ms": sim_plain_ms, "max_abs_err": err,
                           "bound_ms": bound(2.0 * n2 * cfg.d_model,
                                             4.0 * (2 * pool_n * cfg.d_model + n2))[0]},
            "fl_gains": {"shape": f"sim ({pool_n},{pool_n})", "ms": fl_ms,
                         "plain_ms": fl_plain_ms,
                         "bound_ms": bound(2.0 * n2, 4.0 * (n2 + 2 * pool_n))[0]},
            "fl_gains_at": {"shape": f"sim ({pool_n},{pool_n}), idx (8,)", "ms": at_ms,
                            "plain_ms": at_plain_ms,
                            "bound_ms": bound(2.0 * 8 * pool_n,
                                              4.0 * (8 * pool_n + pool_n + 8))[0]}}
        log(f"  15 (y) kernel launches on the training path: {first['launches']}; on its "
            f"shapes similarity {sim_ms:.4f} ms (plain {sim_plain_ms:.4f}), fl_gains "
            f"{fl_ms:.4f} ms (plain {fl_plain_ms:.4f}), fl_gains_at k = 8 {at_ms:.4f} ms "
            f"(plain {at_plain_ms:.4f})")
        del S, S_plain, emb, curmax
        # the resumed run: the saved state restored, a fresh selection round
        second, probe = _train_run(torch, tr, "resumed run", steps=TRAIN_RESUME_STEPS, **kw)
        if len(second["losses"]) != TRAIN_RESUME_STEPS - TRAIN_STEPS:
            raise AssertionError(f"15 (y) the resumed run ran {len(second['losses'])} steps")
        (restored,) = probe.restores
        leaves, back = tree_leaves(saved["state"]), tree_leaves(restored["state"])
        if restored["step"] != TRAIN_STEPS or len(leaves) != len(back) or not all(
                _leaf_bits_equal(torch, a, b) for a, b in zip(leaves, back)):
            raise AssertionError("15 (y) the restored state is not the saved one bit for bit")
        ckpt_bytes = sum(p.numel() * p.element_size() for p in leaves)
        dtypes = sorted({str(p.dtype).replace("torch.", "") for p in leaves})
        save_s, restore_s = saved["wall_s"], restored["wall_s"]
        log(f"  ok  15 (y) the resumed run's restored state equals the one saved at step "
            f"{TRAIN_STEPS} bit for bit: {len(leaves)} leaves ({', '.join(dtypes)}; params, "
            f"both moments, step), {ckpt_bytes / 2**30:.2f} GiB")
        del saved, restored, leaves, back, probe
        shutil.rmtree(tmp / "run")
        # make_train_step on one fixed batch
        state = init_train_state(cfg, args.seed, "cuda")
        layer_weights = sum(p.numel() for p in tree_leaves(state.params["layers"]))
        step = make_train_step(cfg, cosine_schedule(*FIXED_SCHEDULE))
        batch = SyntheticTokens(cfg, TRAIN_SEQ, seed=args.seed, device="cuda").batch(
            range(TRAIN_BATCH))
        fixed = []
        for _ in range(FIXED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            loss = float(m["loss"])
            fixed.append({"loss": loss, "wall_s": time.perf_counter() - t0})
        fl = [f["loss"] for f in fixed]
        if not (np.isfinite(fl).all() and fl[-1] < fl[0] - 0.5):
            raise AssertionError(f"15 (y) the fixed batch's loss did not fall by 0.5: {fl}")
        log(f"  ok  15 (y) one fixed batch, cosine_schedule{FIXED_SCHEDULE}: loss {fl[0]:.4f} "
            f"-> {fl[-1]:.4f} over {FIXED_STEPS} steps")
        # where a step's and an embedding call's time goes (one more step)
        holder = {}
        out["step_profile"] = _device_profile(
            torch, lambda: holder.update(r=step(state, batch)))
        state = holder.pop("r")[0]
        with torch.inference_mode():
            out["embed_profile"] = _device_profile(
                torch, lambda: embed_examples(cfg, state.params, batch))
        _log_profile("a train step", out["step_profile"])
        _log_profile(f"an embedding call ({TRAIN_BATCH} x {TRAIN_SEQ})", out["embed_profile"])
        peak = torch.cuda.max_memory_allocated()
        del state, batch
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    tokens_step = TRAIN_BATCH * TRAIN_SEQ
    pool_tokens = pool_n * TRAIN_SEQ
    walls = [s["wall_s"] for s in first["steps"][1:]] + [f["wall_s"] for f in fixed[1:]]
    median_step = st.median(walls)
    embed_flops = _forward_flops(cfg, layer_weights, pool_tokens, TRAIN_SEQ)["layers"]
    # a step: the forward, its per-layer and loss recompute, and a backward
    # of twice the forward
    step_flops = 4 * sum(_forward_flops(cfg, layer_weights, tokens_step, TRAIN_SEQ).values())
    out.update(
        run=first, resumed=second, fixed_losses=fl, fixed_schedule=list(FIXED_SCHEDULE),
        parting=parting, step0_loss=first["losses"][0],
        embed_s=first["embed_s"], embed_tokens_per_s=pool_tokens / first["embed_s"],
        embed_tflops=embed_flops / first["embed_s"] / 1e12,
        select_s=first["select_s"][0], median_step_s=median_step,
        step_tokens_per_s=tokens_step / median_step,
        step_tflops=step_flops / median_step / 1e12, save_s=save_s, restore_s=restore_s,
        ckpt_bytes=ckpt_bytes, peak_bytes=peak, nvidia_smi=device["nvidia_smi"],
        launches={k: first["launches"].get(k, 0) + second["launches"].get(k, 0)
                  for k in set(first["launches"]) | set(second["launches"])})
    out["seconds"] = time.perf_counter() - t_start
    log(f"  15 (y) on {device['nvidia_smi']}: embedding {pool_n} x {TRAIN_SEQ} tokens "
        f"{out['embed_s']:.3f} s ({out['embed_tokens_per_s']:.0f} tokens/s, "
        f"{out['embed_tflops']:.1f} TFLOP/s); selection {out['select_s']:.3f} s; median step "
        f"after the first {median_step:.4f} s ({out['step_tokens_per_s']:.0f} tokens/s, "
        f"{out['step_tflops']:.1f} TFLOP/s with the per-layer recompute, of "
        f"{BF16_PEAK_FLOPS / 1e12:.0f} bf16); checkpoint save {save_s:.3f} s, restore "
        f"{restore_s:.3f} s ({ckpt_bytes / 2**30:.2f} GiB); peak device memory "
        f"{peak / 2**30:.2f} GiB")
    log(f"phase 15: {out['seconds']:.1f} s")
    return out


OTHER_ARCH = "mamba2-370m"  # phase 16 (z): the ssm family, full width and depth
OTHER_STEPS = 8  # (z) the first run: one selection round, a checkpoint at its end
OTHER_RESUME_STEPS = 10  # the resumed run at 8: a fresh round, 2 steps
OTHER_FIXED_STEPS = 8  # (z) make_train_step on one fixed batch
OTHER_PAIR_B = 2  # (z)-(z''): the fp32 prefill / decode checks' batch
OTHER_TOL = 2e-2  # tests/test_archs.py:118's rtol / atol for decode against a forward
DEEPSEEK_LAYERS = 2  # (z') the dense layer 0 and one MoE layer at the published widths
DEEPSEEK_DECODES = 8
WHISPER_STEPS = 6
JAMBA_STEPS = 3
JAMBA_SEQ = 64


def _finite(torch, label: str, t) -> None:
    if not bool(torch.isfinite(t.float()).all()):
        raise AssertionError(f"{label}: non-finite values")


def _fp32_copy(torch, cfg, params):
    """An fp32 config and the same weights widened to fp32 (exact)."""
    import dataclasses

    from repro_torch.tree import tree_map

    return (dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32"),
            tree_map(lambda t: t.float(), params))


def _forward_last_logits(cfg, params, batch):
    """The no-cache forward (the backbone, the final norm, the head) at the
    last position: the reference's logits that a prefill + decode must
    reproduce."""
    from repro_torch.models import model

    tokens = batch["tokens"]
    B, L = tokens.shape
    x = model._backbone(cfg, params, model._embed(cfg, params, tokens),
                        model._positions(B, L, tokens.device))
    x = model.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return model._logits(cfg, params, x[:, -1:])


def _decode_against(torch, label, cfg, params, batch, reference, decodes=1) -> dict:
    """``prefill`` of the batch's tokens but the last ``decodes``, then one
    ``decode_step`` a token; each decode's logits against
    ``reference(batch with the tokens so far)`` at its last position, within
    OTHER_TOL.  Returns the largest difference and the decodes' walls."""
    from repro_torch.models.model import decode_step, prefill

    tokens = batch["tokens"]
    L = tokens.shape[1]
    first = L - decodes
    head = {**batch, "tokens": tokens[:, :first]}
    logits, caches = prefill(cfg, params, head, max_len=L)
    _finite(torch, f"{label} prefill logits", logits)
    worst = 0.0
    for i in range(decodes):
        pos = first + i
        logits, caches = decode_step(cfg, params, caches, tokens[:, pos: pos + 1], pos)
        want = reference(cfg, params, {**batch, "tokens": tokens[:, : pos + 1]})
        worst = max(worst, check_close(f"{label} decode at {pos} vs {reference.__name__}",
                                       logits[:, 0], want[:, 0], OTHER_TOL, OTHER_TOL,
                                       quiet=True))
    log(f"  ok  {label}: prefill of {first} + {decodes} decode_step(s) against "
        f"{reference.__name__} over the extended tokens, max |diff| {worst:.3g} (rtol / atol "
        f"{OTHER_TOL})")
    return {"prefill_tokens": first, "decodes": decodes, "max_abs_err": worst}


def _prefill_reference(cfg, params, batch):
    from repro_torch.models.model import prefill

    return prefill(cfg, params, batch)[0]


def _fixed_steps(torch, label, cfg, state, batch, steps, must_fall=0.5) -> tuple:
    """``make_train_step`` on one batch: every gradient leaf finite before the
    first step (value_and_grad), every grad norm finite and positive (so
    every gradient finite, each step), the loss down by ``must_fall``."""
    from repro_torch.train.optim import cosine_schedule
    from repro_torch.train.train_step import make_train_step, value_and_grad
    from repro_torch.tree import flatten_with_names

    _, grads = value_and_grad(cfg, state.params, batch)
    bad = [n for n, g in flatten_with_names(grads) if not bool(torch.isfinite(g.float()).all())]
    if bad:
        raise AssertionError(f"{label}: non-finite gradient leaves {bad}")
    n_leaves = len(flatten_with_names(grads))
    del grads
    step = make_train_step(cfg, cosine_schedule(*FIXED_SCHEDULE))
    fixed = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        fixed.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                      "wall_s": time.perf_counter() - t0})
    losses = [f["loss"] for f in fixed]
    norms = [f["grad_norm"] for f in fixed]
    if not (np.isfinite(losses).all() and all(np.isfinite(g) and g > 0 for g in norms)):
        raise AssertionError(f"{label}: losses {losses}, grad norms {norms}")
    if not losses[-1] < losses[0] - must_fall:
        raise AssertionError(f"{label}: the loss did not fall by {must_fall}: {losses}")
    log(f"  ok  {label}: {n_leaves} gradient leaves finite; {steps} steps on one batch, "
        f"cosine_schedule{FIXED_SCHEDULE}: loss {losses[0]:.4f} -> {losses[-1]:.4f}, grad "
        f"norms {min(norms):.4f} .. {max(norms):.4f}, all finite")
    return state, step, fixed


def _other_mamba(torch, args, device) -> dict:
    """(z) mamba2-370m at full width and depth through launch.train.run,
    as phase 15 drives qwen3-0.6b."""
    import shutil
    import statistics as st
    import tempfile

    import repro_torch.launch.train as tr
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs.base import get_config
    from repro_torch.core import create_kernel
    from repro_torch.data.pipeline import SyntheticTokens, embed_examples
    from repro_torch.data.selection import SelectorConfig, SubmodularSelector
    from repro_torch.kernels.similarity_kernel import similarity_plain
    from repro_torch.train.train_step import init_train_state
    from repro_torch.tree import flatten_with_names, tree_leaves

    tag = "16 (z)"
    cfg = get_config(OTHER_ARCH)
    pool_n = TRAIN_BATCH * TRAIN_SELECT_EVERY * TRAIN_POOL_FACTOR
    budget = TRAIN_BATCH * TRAIN_SELECT_EVERY
    log(f"  {tag} {OTHER_ARCH} full width ({cfg.n_layers} layers, d {cfg.d_model}, d_inner "
        f"{cfg.d_inner}, {cfg.n_ssm_heads} SSM heads of {cfg.ssm_head_dim}, N {cfg.ssm_state}, "
        f"chunk {cfg.ssm_chunk}, vocab {cfg.vocab}, {cfg.param_dtype}): batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ}, pool {pool_n} -> coreset {budget}")
    tmp = Path(tempfile.mkdtemp())
    out = {"arch": OTHER_ARCH, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "pool": pool_n,
           "budget": budget}
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kw = dict(arch=OTHER_ARCH, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                  select_every=TRAIN_SELECT_EVERY, pool_factor=TRAIN_POOL_FACTOR,
                  ckpt_dir=str(tmp / "run"), ckpt_every=OTHER_STEPS, reduced=False,
                  seed=args.seed, log_every=4, device="cuda")
        first, probe = _train_run(torch, tr, "run", tag=tag, steps=OTHER_STEPS, **kw)
        lo, hi = 0.2 * np.log(cfg.vocab), 3.0 * np.log(cfg.vocab)
        if not lo < first["losses"][0] < hi:
            raise AssertionError(f"{tag} step-0 loss {first['losses'][0]} outside "
                                 f"({lo:.3f}, {hi:.3f})")
        missing = [k for k in TRAIN_KERNELS if not first["launches"].get(k)]
        if missing:
            raise AssertionError(f"{tag}: kernels not launched on the path: {missing}")
        if [sv["step"] for sv in probe.saves] != [OTHER_STEPS] or \
                ckpt.latest_step(str(tmp / "run")) != OTHER_STEPS:
            raise AssertionError(f"{tag}: not one checkpoint, at step {OTHER_STEPS}")
        log(f"  ok  {tag} step-0 loss {first['losses'][0]:.4f} in ({lo:.3f}, {hi:.3f}); "
            f"kernels launched {first['launches']}")
        saved = probe.saves[0]
        emb, ids = probe.selects[0]["emb"], probe.selects[0]["ids"]
        S = create_kernel(emb, metric="euclidean", use_pallas=True)
        err = check_close(f"{tag} similarity.cu on the pool's embeddings ({pool_n} x "
                          f"{cfg.d_model}, euclidean) vs plain", S,
                          similarity_plain(emb, emb, "euclidean"), *SIM_TOL["euclidean"])
        sel = lambda kernels: SubmodularSelector(  # noqa: E731
            cfg, SelectorConfig(budget=budget, use_pallas_kernel=kernels))
        parting = _selector_parting(torch, f"{tag} the coreset's {budget} ids, kernel route",
                                    sel(True).build_function(emb),
                                    sel(False).build_function(emb), ids, sel(False).select(emb))
        del S, emb
        second, probe = _train_run(torch, tr, "resumed run", tag=tag, steps=OTHER_RESUME_STEPS,
                                   **kw)
        if len(second["losses"]) != OTHER_RESUME_STEPS - OTHER_STEPS:
            raise AssertionError(f"{tag} the resumed run ran {len(second['losses'])} steps")
        (restored,) = probe.restores
        named = flatten_with_names(saved["state"])
        leaves, back = [v for _, v in named], tree_leaves(restored["state"])
        empty = [n for n, v in named if v.numel() == 0]
        if restored["step"] != OTHER_STEPS or len(leaves) != len(back) or not all(
                _leaf_bits_equal(torch, a, b) for a, b in zip(leaves, back)):
            raise AssertionError(f"{tag} the restored state is not the saved one bit for bit")
        if not empty:
            raise AssertionError(f"{tag}: no zero-size leaf in the state (d_ff = 0's FFN)")
        ckpt_bytes = sum(p.numel() * p.element_size() for p in leaves)
        log(f"  ok  {tag} the resumed run's restored state equals the one saved at step "
            f"{OTHER_STEPS} bit for bit: {len(leaves)} leaves, {len(empty)} of them zero-size "
            f"({', '.join(empty[:3])}, ...), {ckpt_bytes / 2**30:.2f} GiB")
        save_s, restore_s = saved["wall_s"], restored["wall_s"]
        del saved, restored, leaves, back, named, probe
        shutil.rmtree(tmp / "run")
        # make_train_step on one fixed batch, then one profiled step
        state = init_train_state(cfg, args.seed, "cuda")
        batch = SyntheticTokens(cfg, TRAIN_SEQ, seed=args.seed, device="cuda").batch(
            range(TRAIN_BATCH))
        state, step, fixed = _fixed_steps(torch, f"{tag} fixed batch", cfg, state, batch,
                                          OTHER_FIXED_STEPS)
        holder = {}
        out["step_profile"] = _device_profile(torch, lambda: holder.update(r=step(state, batch)))
        state = holder.pop("r")[0]
        _log_profile("a train step", out["step_profile"], tag)
        peak = torch.cuda.max_memory_allocated()
        # prefill + decode against the no-cache forward, in fp32
        cfg32, params32 = _fp32_copy(torch, cfg, state.params)
        del state
        pair = {"tokens": batch["tokens"][:OTHER_PAIR_B]}
        with torch.inference_mode():
            out["decode"] = _decode_against(torch, f"{tag} fp32", cfg32, params32, pair,
                                            _forward_last_logits)
        del params32, batch
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    tokens_step = TRAIN_BATCH * TRAIN_SEQ
    pool_tokens = pool_n * TRAIN_SEQ
    walls = [s["wall_s"] for s in first["steps"][1:]] + [f["wall_s"] for f in fixed[1:]]
    median_step = st.median(walls)
    out.update(run=first, resumed=second, fixed=fixed, parting=parting,
               similarity_err=err, step0_loss=first["losses"][0], embed_s=first["embed_s"],
               embed_tokens_per_s=pool_tokens / first["embed_s"],
               select_s=first["select_s"][0], median_step_s=median_step,
               step_tokens_per_s=tokens_step / median_step, save_s=save_s,
               restore_s=restore_s, ckpt_bytes=ckpt_bytes, peak_bytes=peak,
               launches={k: first["launches"].get(k, 0) + second["launches"].get(k, 0)
                         for k in set(first["launches"]) | set(second["launches"])})
    log(f"  {tag} on {device['nvidia_smi']}: embedding {pool_n} x {TRAIN_SEQ} tokens "
        f"{out['embed_s']:.3f} s ({out['embed_tokens_per_s']:.0f} tokens/s); selection "
        f"{out['select_s']:.3f} s; median step after the first {median_step:.4f} s "
        f"({out['step_tokens_per_s']:.0f} tokens/s); checkpoint save {save_s:.3f} s, restore "
        f"{restore_s:.3f} s ({ckpt_bytes / 2**30:.2f} GiB); peak device memory "
        f"{peak / 2**30:.2f} GiB")
    return out


class _DropProbe:
    """Counts the (token, k) slots that found room in their expert's
    capacity, by wrapping ``models.moe.dispatch_combine`` while it is on."""

    def __init__(self):
        self.kept = self.slots = 0

    def __enter__(self):
        from repro_torch.models import moe

        self.moe, self.saved = moe, moe.dispatch_combine

        def counted(*a, **kw):
            dispatch, combine, kept = self.saved(*a, **kw)
            self.kept += int(kept.sum())
            self.slots += kept.numel()
            return dispatch, combine, kept

        moe.dispatch_combine = counted
        return self

    def __exit__(self, *exc):
        self.moe.dispatch_combine = self.saved


def _other_deepseek(torch, args) -> dict:
    """(z') deepseek-v2-236b at its published widths, depth cut to 2 (the
    dense MLA layer 0 and one MoE layer), forward only: the bf16 run at the
    published capacity factor timed, with its dropped slots; the prefill /
    absorbed-decode consistency in fp32 with the capacity raised to the
    group size."""
    import dataclasses
    import math

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticTokens, embed_examples
    from repro_torch.models.model import decode_step, init_params, prefill
    from repro_torch.tree import tree_leaves

    tag = "16 (z')"
    cfg = dataclasses.replace(get_config("deepseek-v2-236b"), n_layers=DEEPSEEK_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    params, init_s, _ = _dist_timed(torch, lambda: init_params(cfg, args.seed, "cuda"))
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"  {tag} deepseek-v2-236b at its published widths, {DEEPSEEK_LAYERS} layers (d "
        f"{cfg.d_model}, {cfg.n_heads} MLA heads, kv_lora {cfg.kv_lora_rank}, q_lora "
        f"{cfg.q_lora_rank}, {cfg.n_experts} experts top-{cfg.top_k} + {cfg.n_shared_experts} "
        f"shared of {cfg.d_expert_}): {n_params / 1e9:.3f} B parameters, bf16, drawn in "
        f"{init_s:.3f} s")
    batch = SyntheticTokens(cfg, TRAIN_SEQ, seed=args.seed, device="cuda").batch(
        range(TRAIN_BATCH))
    out = {"params": n_params, "init_s": init_s}
    with torch.inference_mode():
        emb, out["embed_s"], _ = _dist_timed(torch, lambda: embed_examples(cfg, params, batch))
        if emb.shape != (TRAIN_BATCH, cfg.d_model):
            raise AssertionError(f"{tag} embed_examples shape {tuple(emb.shape)}")
        _finite(torch, f"{tag} embed_examples", emb)
        with _DropProbe() as drops:
            (logits, caches), out["prefill_s"], _ = _dist_timed(
                torch, lambda: prefill(cfg, params, batch, max_len=TRAIN_SEQ + DEEPSEEK_DECODES))
        _finite(torch, f"{tag} bf16 prefill", logits)
        decode_s = []
        for i in range(DEEPSEEK_DECODES):
            nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            (logits, caches), wall, _ = _dist_timed(
                torch, lambda: decode_step(cfg, params, caches, nxt, TRAIN_SEQ + i))
            _finite(torch, f"{tag} bf16 decode {i}", logits)
            decode_s.append(wall)
    out.update(decode_s=decode_s, dropped_share=1.0 - drops.kept / drops.slots,
               slots=drops.slots, bf16_peak_bytes=torch.cuda.max_memory_allocated())
    del caches, logits, emb, batch
    log(f"  {tag} bf16 on {TRAIN_BATCH} x {TRAIN_SEQ}: embed_examples {out['embed_s']:.3f} s "
        f"({TRAIN_BATCH * TRAIN_SEQ / out['embed_s']:.0f} tokens/s); prefill "
        f"{out['prefill_s']:.3f} s; {DEEPSEEK_DECODES} absorbed decodes, median "
        f"{statistics.median(decode_s) * 1e3:.1f} ms; at capacity_factor "
        f"{cfg.capacity_factor} the prefill dropped {100 * out['dropped_share']:.2f}% of its "
        f"{drops.slots} (token, k) slots; peak {out['bf16_peak_bytes'] / 2**30:.2f} GiB")
    # fp32, capacity raised so that cap >= the group: no slot drops, and a
    # prefill's tokens route as a single decoded token does
    cfg32, params32 = _fp32_copy(torch, cfg, params)
    del params
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg32, capacity_factor=float(math.ceil(cfg.n_experts /
                                                                        cfg.top_k)))
    L = TRAIN_SEQ + DEEPSEEK_DECODES
    if int(L * cfg.top_k * cfg32.capacity_factor / cfg.n_experts) < L:
        raise AssertionError(f"{tag}: capacity under the group size")
    pair = SyntheticTokens(cfg, L, seed=args.seed, device="cuda").batch(range(OTHER_PAIR_B))
    with torch.inference_mode(), _DropProbe() as drops32:
        out["decode"] = _decode_against(
            torch, f"{tag} fp32 (capacity_factor {cfg32.capacity_factor})", cfg32, params32,
            pair, _prefill_reference, decodes=DEEPSEEK_DECODES)
    if drops32.kept != drops32.slots:
        raise AssertionError(f"{tag}: the fp32 check dropped slots")
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    del params32
    torch.cuda.empty_cache()
    return out


def _other_whisper(torch, args) -> dict:
    """(z'') whisper-small at full width and depth: the encoder's mean as the
    selection embedding, steps on one batch, prefill / decode."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticTokens, embed_examples
    from repro_torch.train.train_step import init_train_state
    from repro_torch.tree import tree_leaves

    tag = "16 (z'')"
    cfg = get_config("whisper-small")
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, args.seed, "cuda")
    batch = SyntheticTokens(cfg, TRAIN_SEQ, seed=args.seed, device="cuda").batch(
        range(TRAIN_BATCH))
    log(f"  {tag} whisper-small full width ({cfg.enc_layers} + {cfg.n_layers} layers, d "
        f"{cfg.d_model}, {cfg.enc_positions} frames, vocab {cfg.vocab}, bf16): "
        f"{sum(t.numel() for t in tree_leaves(state.params)) / 1e6:.1f} M parameters")
    out = {}
    with torch.inference_mode():
        emb, out["embed_s"], _ = _dist_timed(
            torch, lambda: embed_examples(cfg, state.params, batch))
    if emb.shape != (TRAIN_BATCH, cfg.d_model):
        raise AssertionError(f"{tag} embed_examples shape {tuple(emb.shape)}")
    _finite(torch, f"{tag} embed_examples", emb)
    state, _, fixed = _fixed_steps(torch, f"{tag} fixed batch", cfg, state, batch,
                                   WHISPER_STEPS)
    out.update(fixed=fixed, median_step_s=statistics.median(f["wall_s"] for f in fixed[1:]),
               peak_bytes=torch.cuda.max_memory_allocated())
    cfg32, params32 = _fp32_copy(torch, cfg, state.params)
    del state
    pair = {k: v[:OTHER_PAIR_B] for k, v in batch.items()}
    with torch.inference_mode():
        out["decode"] = _decode_against(torch, f"{tag} fp32", cfg32, params32, pair,
                                        _prefill_reference)
    log(f"  {tag}: embed_examples (the encoder's mean) {out['embed_s']:.3f} s for "
        f"{TRAIN_BATCH} x {cfg.enc_positions} frames; median step {out['median_step_s']:.4f} "
        f"s; peak {out['peak_bytes'] / 2**30:.2f} GiB")
    return out


def _other_jamba(torch, args) -> dict:
    """(z''') jamba-1.5-large-398b at its reduced() widths in bf16 (its
    published width fits no card): prefill / decode against the no-cache
    forward, then steps."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.train.optim import cosine_schedule
    from repro_torch.train.train_step import init_train_state, make_train_step

    tag = "16 (z''')"
    cfg = dataclasses.replace(get_config("jamba-1.5-large-398b").reduced(),
                              param_dtype="bfloat16", compute_dtype="bfloat16")
    state = init_train_state(cfg, args.seed, "cuda")
    batch = SyntheticTokens(cfg, JAMBA_SEQ, seed=args.seed, device="cuda").batch(
        range(TRAIN_BATCH))
    log(f"  {tag} jamba-1.5-large-398b reduced ({cfg.n_layers} layers: one period, attention "
        f"at {cfg.attn_offset}, MoE every {cfg.moe_every}; d {cfg.d_model}, bf16)")
    with torch.inference_mode():
        out = {"decode": _decode_against(torch, f"{tag} bf16", cfg, state.params,
                                         {"tokens": batch["tokens"][:OTHER_PAIR_B]},
                                         _forward_last_logits)}
    step = make_train_step(cfg, cosine_schedule(*FIXED_SCHEDULE))
    losses = []
    for _ in range(JAMBA_STEPS):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        if not np.isfinite([losses[-1], float(m["grad_norm"])]).all():
            raise AssertionError(f"{tag}: step loss {losses[-1]}, grad norm {m['grad_norm']}")
    log(f"  ok  {tag}: {JAMBA_STEPS} steps, losses {losses[0]:.4f} .. {losses[-1]:.4f}, grad "
        f"norms finite")
    out["losses"] = losses
    return out


def phase_other(torch, args, device: dict) -> dict:
    """Phase 16: the training testbed's other families.  (z), the slice's
    main path, is mamba2-370m through ``launch.train.run`` (its counts set
    to 0 before each run and read after); (z'), (z''), (z''') drive
    deepseek-v2 (MLA + MoE), whisper-small and jamba through the model
    entry points."""
    t_start = time.perf_counter()
    log("== phase 16: the training testbed's other families")
    out = {"z": _other_mamba(torch, args, device)}
    out["z1"] = _other_deepseek(torch, args)
    out["z2"] = _other_whisper(torch, args)
    out["z3"] = _other_jamba(torch, args)
    out["launches"] = out["z"]["launches"]
    out["seconds"] = time.perf_counter() - t_start
    log(f"  phase 16 launches on the path (z): {out['launches']}")
    log(f"phase 16: {out['seconds']:.1f} s")
    return out


SHARD_ARCH = TRAIN_ARCH  # phase 17 (aa): phase 15's config and batch
SHARD_STEPS = 2  # (aa) train steps of the unsharded run and of each policy
SHARD_POLICIES = ("fsdp", "dp")
SHARD_PEAK_RATIO = (0.5, 2.0)  # (aa) the dry run's peak over the measured one
SHARD_2X2_LAYERS = 2  # (bb) qwen3-0.6b's width, depth cut to 2, in fp32
SHARD_2X2_BATCH = 4
SHARD_2X2_SEQ = 128
SHARD_2X2_STEPS = 2
SHARD_2X2_POLICIES = ("fsdp", "dp")
# tests/test_torch_sharded_steps.py's LOSS_RTOL, LEAF_RTOL / LEAF_ATOL and MOE_ATOL
SHARD_LOSS_RTOL = 1e-5
SHARD_LEAF_RTOL, SHARD_LEAF_ATOL = 1e-4, 1e-7
SHARD_MOE_ATOL = 1e-5
SHARD_MOE_ARCH = "deepseek-v2-236b"  # (bb) its MoE layer at the published widths, fp32
SHARD_MOE_BATCH = 2
SHARD_MOE_SEQ = 1536  # 3 groups of 512; 4 at tp_size 2
SHARD_PG_TIMEOUT_S = 120
SHARD_JOIN_TIMEOUT_S = 420
SHARD_SEED = 17000
DRYRUN_CELL = ("qwen3-0.6b", "train_4k", "single")  # (cc)
# (cc) the selection cells: every variant on 256 fake ranks, select_1m on 512
SELECT_CELLS = (("select_1m", "single"), ("select_1m_stoch", "single"),
                ("select_1m_bf16", "single"), ("select_1m_stoch_bf16", "single"),
                ("select_1m", "multi"))
SELECT_STEPS = 512  # launch/dryrun.py's build_selection_step budget
SELECT_ROWS_LOC = (1 << 14) // 16  # its rows over "model"
SELECT_SAMPLE = 1024  # its stochastic variants' columns a shard and step
SELECT_POOL_D = 1024  # (dd) the mixture's width (the JAX package's embeddings)


def _placed(tree, mesh, policy: str, batch: bool = False):
    from repro_torch.distributed.sharding import (
        batch_specs, distribute, param_shardings, shardings_of,
    )

    if batch:
        return distribute(tree, shardings_of(tree, batch_specs(tree, mesh, policy=policy), mesh))
    return distribute(tree, param_shardings(tree, mesh, policy))


def _shard_world_of_one(torch, args) -> dict:
    """(aa) qwen3-0.6b at phase 15's width, depth and batch: the unsharded
    steps, then the same steps on DTensors on an NCCL (1, 1) mesh under each
    policy, bit for bit; the dry run of the cell on a fake (1, 1) mesh."""
    import datetime
    import statistics as st
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.distributed.act_sharding import activation_sharding
    from repro_torch.launch.dryrun import fake_world, local_bytes, trace_cell
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.specs import ShapeCell
    from repro_torch.train.train_step import init_train_state, make_train_step
    from repro_torch.tree import flatten_with_names

    cfg = get_config(SHARD_ARCH)
    cell = ShapeCell("phase15", "train", TRAIN_SEQ, TRAIN_BATCH)
    dry = {}
    with fake_world(1):
        fmesh = make_test_mesh((1, 1))
        for policy in SHARD_POLICIES:
            dry[policy] = trace_cell(cfg, cell, fmesh, policy)
            log(f"  17 (aa) dry run of {SHARD_ARCH} {TRAIN_BATCH} x {TRAIN_SEQ} on a fake (1, 1) "
                f"mesh, {policy}: {dry[policy]['flops_per_device']:.4e} flops, arguments "
                f"{dry[policy]['memory']['argument_size_in_bytes']} B, temp "
                f"{dry[policy]['memory']['temp_size_in_bytes']} B, traced in "
                f"{dry[policy]['trace_s']} s")
    batches = [SyntheticTokens(cfg, TRAIN_SEQ, seed=args.seed + SHARD_SEED + s,
                               device="cuda").batch(range(TRAIN_BATCH))
               for s in range(SHARD_STEPS)]
    step = make_train_step(cfg)
    state = init_train_state(cfg, args.seed, "cuda")
    args_bytes = local_bytes((state, batches[0]))
    want_losses, walls = [], []
    for i, b in enumerate(batches):
        torch.cuda.synchronize()
        if i == 0:
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        want_losses.append(m["loss"])
        if i == 0:
            # the step's own peak: what it allocated above everything alive
            # before it, plus its arguments
            peak = torch.cuda.max_memory_allocated() - before + args_bytes
    want = dict(flatten_with_names(state))
    del state
    out = {"unsharded_walls_s": walls, "peak_bytes": peak, "args_bytes": args_bytes,
           "losses": [float(x) for x in want_losses]}
    store = Path(tempfile.mkdtemp()) / "store"
    timeout = datetime.timedelta(seconds=SHARD_PG_TIMEOUT_S)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1,
                            timeout=timeout)
    try:
        mesh = make_test_mesh((1, 1), timeout=timeout)
        for policy in SHARD_POLICIES:
            state = _placed(init_train_state(cfg, args.seed, "cuda"), mesh, policy)
            placed = [_placed(b, mesh, policy, batch=True) for b in batches]
            real = local_bytes((state, placed[0]))
            if real != dry[policy]["memory"]["argument_size_in_bytes"]:
                raise AssertionError(f"17 (aa) {policy}: the dry run's argument bytes "
                                     f"{dry[policy]['memory']['argument_size_in_bytes']} are "
                                     f"not the real local bytes {real}")
            sharded_walls = []
            for b, want_loss in zip(placed, want_losses):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with activation_sharding(mesh, policy=policy):
                    state, m = step(state, b)
                torch.cuda.synchronize()
                sharded_walls.append(time.perf_counter() - t0)
                if not torch.equal(m["loss"].full_tensor(), want_loss):
                    raise AssertionError(f"17 (aa) {policy}: loss {float(m['loss'].full_tensor())}"
                                         f" is not the unsharded {float(want_loss)}")
            leaves = flatten_with_names(state)
            bad = [n for n, leaf in leaves if not _leaf_bits_equal(torch, leaf.full_tensor(),
                                                                   want[n])]
            if bad:
                raise AssertionError(f"17 (aa) {policy}: leaves not bit-equal: {bad[:5]}")
            log(f"  ok  17 (aa) {policy} on an NCCL (1, 1) mesh: {SHARD_STEPS} steps' losses and "
                f"all {len(leaves)} leaves bit-equal to the unsharded steps; the dry run's "
                f"argument bytes {real} exact; walls {[round(w, 4) for w in sharded_walls]} s "
                f"(unsharded {[round(w, 4) for w in walls]})")
            out[policy] = {"walls_s": sharded_walls, "args_bytes": real}
            del state, placed
    finally:
        dist.destroy_process_group()
    median = st.median(walls[1:])  # the first step's wall holds its set-up
    flops = dry["fsdp"]["flops_per_device"]
    predicted = dry["fsdp"]["memory"]["argument_size_in_bytes"] + \
        dry["fsdp"]["memory"]["temp_size_in_bytes"]
    ratio = predicted / peak
    out.update(dry=dry, median_step_s=median, tflops=flops / median / 1e12,
               predicted_peak_bytes=predicted, peak_ratio=ratio)
    log(f"  17 (aa) the dry run's {flops:.4e} flops over the unsharded median step after the "
        f"first {median:.4f} s:"
        f" {out['tflops']:.1f} TFLOP/s of {BF16_PEAK_FLOPS / 1e12:.0f} bf16")
    if not SHARD_PEAK_RATIO[0] <= ratio <= SHARD_PEAK_RATIO[1]:
        raise AssertionError(f"17 (aa) the dry run's peak {predicted} B over the measured "
                             f"{peak} B is {ratio:.3f}, outside {SHARD_PEAK_RATIO}")
    log(f"  ok  17 (aa) the dry run's peak (arguments + temp) {predicted / 2**30:.2f} GiB against "
        f"the step's measured {peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated): ratio "
        f"{ratio:.3f} in {SHARD_PEAK_RATIO}")
    return out


def _shard_cfg():
    import dataclasses

    from repro_torch.configs.base import get_config

    return dataclasses.replace(get_config(SHARD_ARCH), n_layers=SHARD_2X2_LAYERS,
                               param_dtype="float32", compute_dtype="float32")


_MOE_NAMES = {"router": 1, "w_gate": 2, "w_up": 3, "w_down": 4, "shared_gate": 5,
              "shared_up": 6, "shared_down": 7}


def _moe_weight(torch, name: str, shape, rows, seed: int):
    """Rows ``rows`` of MoE matrix ``name`` (an expert each, or for a dense
    matrix the whole of it at ``rows`` None), 0.02 N(0, 1) in fp32, each
    expert from its own seed on the card: a rank draws only its experts."""
    gen = torch.Generator(device="cuda")
    if rows is None:
        gen.manual_seed(seed * 100 + _MOE_NAMES[name])
        return torch.randn(shape, generator=gen, device="cuda").mul_(0.02)
    out = torch.empty((len(rows),) + tuple(shape), device="cuda")
    for i, e in enumerate(rows):
        gen.manual_seed((seed * 100 + _MOE_NAMES[name]) * 1000 + e)
        torch.randn(shape, generator=gen, device="cuda", out=out[i])
    return out.mul_(0.02)


def _moe_2x2(torch, args, mesh, rank: int) -> dict:
    """(bb) deepseek-v2's MoE layer at its published widths (160 experts of
    5,120 x 1,536, 2 shared, top 6) in fp32 on the 2x2 mesh, where
    tp_size() is 2; rank 0 also runs it on whole tensors in the same
    context (the same group count)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.configs.base import get_config
    from repro_torch.distributed.act_sharding import (
        activation_sharding, splits_activations, tp_size,
    )
    from repro_torch.distributed.sharding import local_box, param_specs, to_placements
    from repro_torch.models.moe import moe_ffn

    cfg = get_config(SHARD_MOE_ARCH)
    D, E, F = cfg.d_model, cfg.n_experts, cfg.d_expert_
    Fs = cfg.n_shared_experts * F
    shapes = {"router": (D, E), "w_gate": (E, D, F), "w_up": (E, D, F), "w_down": (E, F, D),
              "shared_gate": (D, Fs), "shared_up": (D, Fs), "shared_down": (Fs, D)}
    specs = param_specs({"moe": {k: torch.empty(s, device="meta") for k, s in shapes.items()}},
                        mesh, "fsdp")["moe"]
    seed = args.seed + SHARD_SEED + 20
    placed = {}
    for k, s in shapes.items():
        pl = to_placements(specs[k], mesh)
        shape, off = local_box(s, mesh, pl)
        if len(s) == 3:  # this rank's experts, then its slice of them
            block = _moe_weight(torch, k, s[1:], range(off[0], off[0] + shape[0]), seed)
            off, shape = (0,) + off[1:], (block.shape[0],) + shape[1:]
        else:
            block = _moe_weight(torch, k, s, None, seed)
        local = block[tuple(slice(o, o + n) for o, n in zip(off, shape))].contiguous()
        del block
        placed[k] = DTensor.from_local(local, mesh, pl, run_check=False, shape=torch.Size(s),
                                       stride=torch.empty(s, device="meta").stride())
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((SHARD_MOE_BATCH, SHARD_MOE_SEQ, D), generator=gen, device="cuda")
    xd = _placed({"x": x}, mesh, "fsdp", batch=True)["x"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with activation_sharding(mesh, policy="fsdp"):
        ts, split = tp_size(), splits_activations()
        y = moe_ffn(cfg, placed, xd).full_tensor()
    torch.cuda.synchronize()
    out = {"tp_size": ts, "tp_activations": split, "sharded_s": time.perf_counter() - t0}
    del placed
    torch.cuda.empty_cache()
    if rank == 0:
        whole = {k: _moe_weight(torch, k, s[1:], range(E), seed) if len(s) == 3 else
                 _moe_weight(torch, k, s, None, seed) for k, s in shapes.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with activation_sharding(mesh, policy="fsdp"):
            y0 = moe_ffn(cfg, whole, x)
        torch.cuda.synchronize()
        out.update(whole_s=time.perf_counter() - t0, err=float((y - y0).abs().max()),
                   scale=float(y0.abs().max()))
        del whole, y0
    return out


def _shard_steps(torch, args, mesh, policy: str, rank: int) -> dict:
    """Two steps of qwen3-0.6b at ``SHARD_2X2_LAYERS`` layers on DTensors
    placed by ``policy`` against this rank's own unsharded steps, each
    step's collectives counted; whether activations were split over the
    model axis, and the first step's own peak (what it allocated above
    everything alive before it, plus its arguments, as in (aa))."""
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.distributed.act_sharding import activation_sharding, splits_activations
    from repro_torch.distributed.sharding import local_box
    from repro_torch.launch.dryrun import CostCounter, local_bytes
    from repro_torch.train.train_step import init_train_state, make_train_step
    from repro_torch.tree import flatten_with_names

    cfg = _shard_cfg()
    batches = [SyntheticTokens(cfg, SHARD_2X2_SEQ, seed=args.seed + SHARD_SEED + 10 + s,
                               device="cuda").batch(range(SHARD_2X2_BATCH))
               for s in range(SHARD_2X2_STEPS)]
    step = make_train_step(cfg)
    ref, ref_losses = init_train_state(cfg, args.seed, "cuda"), []
    for b in batches:
        ref, m = step(ref, b)
        ref_losses.append(float(m["loss"]))
    ref = dict(flatten_with_names(ref))
    state = _placed(init_train_state(cfg, args.seed, "cuda"), mesh, policy)
    out = {"failures": [], "losses": [], "collectives": [], "walls_s": [],
           "ref_losses": ref_losses}
    for i, b in enumerate(batches):
        b = _placed(b, mesh, policy, batch=True)
        counter = CostCounter(memory=False)
        torch.cuda.synchronize()
        if i == 0:
            torch.cuda.reset_peak_memory_stats()
            before, args_bytes = torch.cuda.memory_allocated(), local_bytes((state, b))
        t0 = time.perf_counter()
        with activation_sharding(mesh, policy=policy), counter:
            out["tp_activations"] = splits_activations()
            state, m = step(state, b)
        torch.cuda.synchronize()
        if i == 0:
            out["peak_bytes"] = torch.cuda.max_memory_allocated() - before + args_bytes
        out["losses"].append(float(m["loss"].full_tensor()))
        out["walls_s"].append(time.perf_counter() - t0)
        out["collectives"].append(counter.collectives())
    for s, (got, want) in enumerate(zip(out["losses"], ref_losses)):
        if abs(got - want) > SHARD_LOSS_RTOL * abs(want):
            out["failures"].append(f"rank {rank} {policy} step {s}: loss {got} against {want}")
    # each rank holds its own block to the same box of the unsharded leaf
    # (the blocks cover every leaf), with no collective
    out["worst_leaf"] = 0.0
    for n, leaf in flatten_with_names(state):
        want = ref[n]
        shape, off = local_box(leaf.shape, leaf.device_mesh, leaf.placements)
        box = want[tuple(slice(o, o + k) for o, k in zip(off, shape))]
        if not box.numel():
            continue
        err = float((leaf.to_local().double() - box.double()).abs().max())
        tol = SHARD_LEAF_ATOL + SHARD_LEAF_RTOL * float(want.abs().max())
        out["worst_leaf"] = max(out["worst_leaf"], err / tol)
        if err > tol:
            out["failures"].append(f"rank {rank} {policy} {n}: {err:.3e} past {tol:.3e}")
    return out


def _shard_full(torch, args, meshes: dict, tmp: Path, rank: int) -> dict:
    """(bb)'s whole job on one rank: the steps under each policy, the
    checkpoint, the MoE layer; an error ends the rank, and so the phase."""
    walls, t0 = {}, time.perf_counter()
    out = {"policies": {}, "walls_s": walls}
    for p in SHARD_2X2_POLICIES:
        out["policies"][p] = _shard_steps(torch, args, meshes["2x2"], p, rank)
        walls[p], t0 = time.perf_counter() - t0, time.perf_counter()
    out["failures"] = [f for r in out["policies"].values() for f in r.get("failures", [])]
    ck = _shard_ckpt(torch, args, meshes, tmp, rank)
    walls["ckpt"], t0 = time.perf_counter() - t0, time.perf_counter()
    out["failures"] += ck.pop("failures")
    out.update(ck)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out["moe"] = _moe_2x2(torch, args, meshes["2x2"], rank)
    out["moe"]["peak_bytes"] = torch.cuda.max_memory_allocated()
    walls["moe"] = time.perf_counter() - t0
    return out


def _shard_ckpt(torch, args, meshes: dict, tmp: Path, rank: int) -> dict:
    """(bb)'s checkpoint, checked without a collective: the initial state
    placed by fsdp on the 2x2 mesh, saved sharded and restored onto (4, 1)
    and (1, 4); every restored local block bit-equal to the same box of the
    whole state this rank draws itself."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.distributed.sharding import local_box, param_shardings
    from repro_torch.train.train_step import init_train_state
    from repro_torch.tree import flatten_with_names, leaves_like

    out = {"failures": [], "restored": {}}
    cfg = _shard_cfg()
    whole = init_train_state(cfg, args.seed, "cuda")
    state = _placed(whole, meshes["2x2"], "fsdp")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt.save(str(tmp / "ck"), 1, state)
    out["save_s"] = time.perf_counter() - t0
    ref = dict(flatten_with_names(whole))
    for name in ("4x1", "1x4"):
        want = param_shardings(state, meshes[name], "fsdp")
        t0 = time.perf_counter()
        got, meta = ckpt.restore(str(tmp / "ck"), state, shardings=want)
        wall = time.perf_counter() - t0
        leaves = flatten_with_names(got)
        placed = all(t.device_mesh is m and tuple(t.placements) == tuple(p)
                     for (_, t), (m, p) in zip(leaves, leaves_like(state, want)))
        equal = True
        for n, t in leaves:
            shape, off = local_box(t.shape, t.device_mesh, t.placements)
            box = ref[n][tuple(slice(o, o + k) for o, k in zip(off, shape))]
            equal &= _leaf_bits_equal(torch, t.to_local(), box.contiguous())
        if not (placed and equal and meta["step"] == 1):
            out["failures"].append(f"rank {rank} restore onto {name}: placed {placed}, "
                                   f"bit-equal {equal}")
        out["restored"][name] = {"placed": placed, "equal": equal, "restore_s": wall}
        del got, leaves
    return out


def _rank_shard(args) -> int:
    """One rank of (bb)'s 2x2 world over ``--backend-shard`` (gloo on one
    card, NCCL on four), running :func:`_shard_full`; its results go to
    DIR/rank{r}.json."""
    import datetime
    import logging

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    from repro_torch.launch.mesh import make_test_mesh

    rank, tmp = args.rank_shard, Path(args.dir_shard)
    timeout = datetime.timedelta(seconds=SHARD_PG_TIMEOUT_S)
    dist.init_process_group(args.backend_shard, init_method=f"file://{tmp / 'store'}", rank=rank,
                            world_size=4, timeout=timeout)
    try:
        out = {"rank": rank, "failures": []}
        meshes = {name: make_test_mesh(shape, timeout=timeout)
                  for name, shape in (("2x2", (2, 2)), ("4x1", (4, 1)), ("1x4", (1, 4)))}
        out.update(_shard_full(torch, args, meshes, tmp, rank))
        (tmp / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()
    return 0


def _start_shard(args, backend: str) -> dict:
    """Four ranks of this script over ``backend``, started: their dir,
    processes and start time, for :func:`_join_shard`."""
    import tempfile

    tmp = Path(tempfile.mkdtemp())
    argv = [sys.executable, str(ROOT / "chip_smoke.py"), "--seed", str(args.seed),
            "--dir-shard", str(tmp), "--backend-shard", backend]
    procs = [subprocess.Popen(argv + ["--rank-shard", str(r)], stdout=open(tmp / f"rank{r}.out", "w"),
                              stderr=subprocess.STDOUT) for r in range(4)]
    return {"tmp": tmp, "procs": procs, "t0": time.perf_counter(), "backend": backend}


def _join_shard(world: dict, timeout_s: float) -> tuple[Path, list, list]:
    """The ranks of :func:`_start_shard` joined, killed at ``timeout_s`` from
    their start: (dir, exit codes, each rank's results or None)."""
    tmp, procs = world["tmp"], world["procs"]
    try:
        for p in procs:
            p.wait(timeout=max(1.0, timeout_s - (time.perf_counter() - world["t0"])))
    except subprocess.TimeoutExpired:
        pass
    finally:
        _stop(procs)
    codes = [p.returncode for p in procs]
    ranks = [json.loads((tmp / f"rank{r}.json").read_text()) if not codes[r] else None
             for r in range(4)]
    return tmp, codes, ranks


def _stop(procs) -> None:
    """Every process of ``procs`` ended: killed where still running."""
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()


def _gloo_probe_start():
    """tools/gloo_cuda_probe.py's ``funcol_all_gather`` case started: a
    functional all-gather of CUDA tensors by four gloo ranks on this card,
    in a world of its own."""
    return subprocess.Popen([sys.executable, str(ROOT / "tools" / "gloo_cuda_probe.py"),
                             "funcol_all_gather"], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _gloo_probe_result(proc) -> dict:
    """The probe's JSON line (exit codes, rank 0's result or where it died)."""
    stdout, stderr = proc.communicate(timeout=300)
    lines = [json.loads(l) for l in stdout.splitlines() if l.startswith("{")]
    case = [l for l in lines if l.get("case") == "funcol_all_gather"]
    if proc.returncode or not case:
        raise AssertionError(f"17 (bb) the gloo probe: exit {proc.returncode}\n"
                             f"{stdout[-2000:]}\n{stderr[-2000:]}")
    return case[0]


def _world1_restore(torch, args, tmp: Path) -> dict:
    """The 2x2 save restored onto a world of 1, held to the initial state,
    drawn here again."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.train.train_step import init_train_state
    from repro_torch.tree import tree_leaves

    t0 = time.perf_counter()
    got, meta = ckpt.restore(str(tmp / "ck"), init_train_state(_shard_cfg(), args.seed + 1,
                                                                "cuda"))
    restore_s = time.perf_counter() - t0
    want = tree_leaves(init_train_state(_shard_cfg(), args.seed, "cuda"))
    equal = all(_leaf_bits_equal(torch, a, b) for a, b in zip(tree_leaves(got), want))
    if meta["step"] != 1 or not equal:
        raise AssertionError("17 (bb) the 2x2 save restored onto a world of 1 is not the saved "
                             "state bit for bit")
    n_files = len(list((tmp / "ck" / "step_0000000001").glob("shard_*.npz")))
    log(f"  ok  17 (bb) the 2x2 save ({n_files} shard files) restored onto a world of 1 in "
        f"{restore_s:.3f} s, every leaf the saved one bit for bit")
    return {"world1_restore_s": restore_s, "shard_files": n_files}


def _shard_dry() -> dict:
    """(bb)'s cell traced by the dry run on a fake (2, 2) mesh, by policy."""
    from repro_torch.launch.dryrun import fake_world, trace_cell
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.specs import ShapeCell

    cell = ShapeCell("bb", "train", SHARD_2X2_SEQ, SHARD_2X2_BATCH)
    out = {}
    for policy in SHARD_2X2_POLICIES:
        with fake_world(4):
            out[policy] = trace_cell(_shard_cfg(), cell, make_test_mesh((2, 2)), policy)
    return out


def _shard_2x2_full(torch, args, world: dict, drys: dict) -> dict:
    """(bb) in full, the ranks of :func:`_start_shard` joined: under each
    policy the sharded steps against the unsharded and each rank's
    collectives and peak against the dry run on a fake (2, 2) mesh
    (``drys``, :func:`_shard_dry`), the elastic checkpoint, the MoE layer;
    a rank's error fails the phase."""
    backend = world["backend"]
    tmp, codes, ranks = _join_shard(world, SHARD_JOIN_TIMEOUT_S)
    if any(codes):
        bad = [f"rank {r} exit {c}:\n{(tmp / f'rank{r}.out').read_text()[-3000:]}"
               for r, c in enumerate(codes) if c]
        raise AssertionError("17 (bb): " + "\n".join(bad))
    failures = [f for r in ranks for f in r["failures"]]
    if failures:
        raise AssertionError("17 (bb): " + "\n".join(failures))
    out = {"ranks": ranks, "backend": backend, "dry": drys}
    for policy in SHARD_2X2_POLICIES:
        dry = drys[policy]
        got = [r["policies"][policy] for r in ranks]
        log(f"  ok  17 (bb) {SHARD_ARCH} at {SHARD_2X2_LAYERS} layers, fp32, {SHARD_2X2_BATCH} x "
            f"{SHARD_2X2_SEQ}, {policy} on a 2x2 {backend} mesh: {SHARD_2X2_STEPS} steps' losses "
            f"{got[0]['losses']} within rtol {SHARD_LOSS_RTOL} of the unsharded "
            f"{got[0]['ref_losses']} on every rank, each rank's block of every leaf within "
            f"{SHARD_LEAF_ATOL} + {SHARD_LEAF_RTOL} x the leaf's scale (worst "
            f"{max(g['worst_leaf'] for g in got):.3f} of it); walls "
            f"{[[round(w, 3) for w in g['walls_s']] for g in got]} s")
        split = [g["tp_activations"] for g in got]
        if split != [policy != "dp"] * 4 or dry["tp_activations"] != (policy != "dp"):
            raise AssertionError(f"17 (bb) {policy}: activations split over the model axis on "
                                 f"the ranks {split}, in the dry run {dry['tp_activations']}")
        for r, g in enumerate(got):
            for s, coll in enumerate(g["collectives"]):
                if coll != dry["collectives"]:
                    raise AssertionError(f"17 (bb) {policy} rank {r} step {s}: collectives "
                                         f"{coll} are not the dry run's {dry['collectives']}")
        log(f"  ok  17 (bb) {policy}: activations {'split' if split[0] else 'not split'} over "
            f"the model axis on every rank and in the dry run; every rank's collectives, every "
            f"step, equal the dry run's on a fake (2, 2) mesh: counts "
            f"{dry['collectives']['counts']}, bytes {dry['collectives']['total']}")
        predicted = (dry["memory"]["argument_size_in_bytes"]
                     + dry["memory"]["temp_size_in_bytes"])
        ratios = [predicted / g["peak_bytes"] for g in got]
        if not all(SHARD_PEAK_RATIO[0] <= x <= SHARD_PEAK_RATIO[1] for x in ratios):
            raise AssertionError(f"17 (bb) {policy}: the dry run's peak {predicted} B over each "
                                 f"rank's first step's {[g['peak_bytes'] for g in got]} B is "
                                 f"{ratios}, outside {SHARD_PEAK_RATIO}")
        log(f"  ok  17 (bb) {policy}: the dry run's peak (arguments + temp) {predicted} B against "
            f"each rank's first step's {[g['peak_bytes'] for g in got]} B "
            f"(torch.cuda.max_memory_allocated): ratios {[round(x, 3) for x in ratios]} in "
            f"{SHARD_PEAK_RATIO}")
    for r in ranks:
        for name, got in r["restored"].items():
            log(f"  ok  17 (bb) rank {r['rank']}: the fsdp state saved on 2x2 restored onto "
                f"{name} with the asked placements, every local block bit-equal to its box of "
                f"the whole state, in {got['restore_s']:.3f} s")
    out.update(_world1_restore(torch, args, tmp))
    log(f"  17 (bb) each rank's walls (s): " + "; ".join(
        f"rank {r['rank']} " + ", ".join(f"{k} {v:.1f}" for k, v in r["walls_s"].items())
        for r in ranks))
    moe = [r["moe"] for r in ranks]
    out["moe"] = moe[0]
    tol = SHARD_MOE_ATOL * max(1.0, moe[0]["scale"])
    if (any(m["tp_size"] != 2 or not m["tp_activations"] for m in moe)
            or moe[0]["err"] > tol):
        raise AssertionError(f"17 (bb) MoE: {moe}, bar {tol:.3e}")
    log(f"  ok  17 (bb) {SHARD_MOE_ARCH}'s MoE layer at its published widths, fp32, "
        f"{SHARD_MOE_BATCH} x {SHARD_MOE_SEQ}, on the 2x2 mesh (tp_size 2, activations split "
        f"over the model axis on every rank: groups, then experts): within "
        f"{moe[0]['err']:.3e} of the whole tensors at the same group count (bar {tol:.3e}); "
        f"{moe[0]['sharded_s']:.3f} s sharded, {moe[0]['whole_s']:.3f} s whole; each rank's "
        f"peak {[round(m['peak_bytes'] / 2**30, 2) for m in moe]} GiB")
    return out


def _selection_counts(shape: str, mesh_kind: str) -> dict:
    """A selection cell's exact local counts: the block's argument bytes,
    the 4 all-reduces a step (the gains' psum over "model", the winner's
    fp32 pmax and int64 pmin, its column's psum) with their bytes, and the
    FL sweeps' bytes by their kernel's formula (u·n·elt + 4u + 4n, or for
    the gathered k columns u·k·elt + 4u + k·(4 + 8))."""
    v_loc = (1 << 20) // (32 if mesh_kind == "multi" else 16)
    u, elt, stoch = SELECT_ROWS_LOC, 2 if "bf16" in shape else 4, "stoch" in shape
    gains = SELECT_SAMPLE if stoch else v_loc
    sweep = (u * SELECT_SAMPLE * elt + 4 * u + 12 * SELECT_SAMPLE if stoch
             else u * v_loc * elt + 4 * u + 4 * v_loc)
    return {"args": u * v_loc * elt, "all_reduces": 4 * SELECT_STEPS,
            "all_reduce_bytes": SELECT_STEPS * (4 * gains + 4 + 8 + 4 * u),
            "kernel_bytes": {"fl_gains_at" if stoch else "fl_gains": SELECT_STEPS * sweep}}


def _shard_dryrun(torch) -> tuple[dict, dict]:
    """(cc) The dry run's production cells: qwen3-0.6b train_4k on 256 fake
    ranks, the four selection cells there and select_1m on 512, their
    argument bytes and all-reduces exact."""
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    rec = dryrun.run_cell(*DRYRUN_CELL, str(OUT_DIR / "dryrun"))
    if rec["n_devices"] != 256 or rec["policy"] != "dp" or not rec["flops_per_device"] > 0:
        raise AssertionError(f"17 (cc) the record: {rec}")
    log(f"  ok  17 (cc) dry run {' '.join(DRYRUN_CELL)} on 256 fake ranks: traced in "
        f"{rec['trace_s']} s, the cell {time.perf_counter() - t0:.1f} s")
    cells = {}
    for shape, mesh_kind in SELECT_CELLS:
        t0 = time.perf_counter()
        r = dryrun.run_cell("selection", shape, mesh_kind, str(OUT_DIR / "dryrun"))
        want, coll = _selection_counts(shape, mesh_kind), r["collectives"]
        got = {"args": r["memory"]["argument_size_in_bytes"],
               "all_reduces": coll["counts"]["all-reduce"], "all_reduce_bytes": coll["all-reduce"],
               "kernel_bytes": r["kernel_bytes"]}
        if got != want or coll["total"] != coll["all-reduce"] or r["flops_per_device"] != 0:
            raise AssertionError(f"17 (cc) selection {shape} {mesh_kind}: {got} != {want} "
                                 f"(collectives {coll})")
        cells[f"{shape}__{mesh_kind}"] = r
        log(f"  ok  17 (cc) selection {shape} on {r['n_devices']} fake ranks: arguments "
            f"{got['args']} B, {got['all_reduces']} all-reduces of {got['all_reduce_bytes']} B, "
            f"FL sweeps {got['kernel_bytes']} B, exact; {r['bytes_per_device']:.6e} bytes a "
            f"device, temp "
            f"{r['memory']['temp_size_in_bytes']} B; traced in {r['trace_s']} s, the cell "
            f"{time.perf_counter() - t0:.1f} s")
    return rec, cells


def _selection_kernels(torch, args, blocks: dict, ids, gains) -> dict:
    """(dd) Rows 2 and 3 at the cells' shapes, on the runs' own card
    tensors: fl_gains on the fp32 and the bf16 block at the first step's
    curmax (0) and at the dense run's after half its picks, fl_gains_at at
    a stochastic step's k = 1,024 int64 ids, each within FL_TOL of its plain
    version, the gathered sweep bit-equal to the full one and each bf16
    sweep bit-equal to the fp32 kernel on the widened block; then the dense
    run's ids against the plain path's NaiveGreedy on the fp32 block, equal
    up to a near-tie, the gains within FL_TOL that far."""
    from repro_torch.core import FacilityLocation, SelectionSpec, solve
    from repro_torch.kernels import ops
    from repro_torch.kernels.fl_gains import fl_gains_at_plain, fl_gains_plain

    u, pool = blocks["fp32"].shape
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    idx = torch.randperm(pool, generator=gen, device="cuda")[:SELECT_SAMPLE]
    half = ids[: SELECT_STEPS // 2].to("cuda")
    errs = {}
    for name in ("fp32", "bf16"):
        sim = blocks[name]
        wide = blocks["widened" if name == "bf16" else "fp32"]
        for state, cm in (("of the first step", torch.zeros(u, device="cuda")),
                          (f"after {len(half)} picks", wide[:, half].amax(dim=1).contiguous())):
            what = f"17 (dd) {name} block ({u} x {pool}), curmax {state}"
            full = ops.fl_gains(sim, cm)
            errs[f"fl_gains {name} {state}"] = check_close(
                f"{what}: fl_gains vs fl_gains_plain", full, fl_gains_plain(sim, cm), *FL_TOL)
            at = ops.fl_gains_at(sim, cm, idx)
            errs[f"fl_gains_at {name} {state}"] = check_close(
                f"{what}: fl_gains_at k={SELECT_SAMPLE} int64 vs fl_gains_at_plain", at,
                fl_gains_at_plain(sim, cm, idx), *FL_TOL)
            _bits_equal(torch, f"{what}: fl_gains_at vs the full sweep", at, full[idx])
            if name == "bf16":
                _bits_equal(torch, f"{what}: fl_gains vs fp32 on the widened block", full,
                            ops.fl_gains(wide, cm))
                _bits_equal(torch, f"{what}: fl_gains_at vs fp32 on the widened block", at,
                            ops.fl_gains_at(wide, cm, idx))
    log("  ok  17 (dd) each bf16 sweep bit-equal to the fp32 kernel on the widened block, each "
        "gathered sweep to the full one")
    S = blocks["fp32"]
    before = dict(ops.LAUNCHES)
    t0 = time.perf_counter()
    ref = solve(SelectionSpec(FacilityLocation.from_kernel(S, use_kernel=False), SELECT_STEPS,
                              "NaiveGreedy", stopIfZeroGain=True, stopIfNegativeGain=False))
    plain_s = time.perf_counter() - t0
    if dict(ops.LAUNCHES) != before:
        raise AssertionError("17 (dd) the plain path's NaiveGreedy launched a kernel")
    ref_ids = ref.order.cpu()
    parting = _selector_parting(
        torch, f"17 (dd) select_1m's ids on the fp32 block vs the plain path's NaiveGreedy "
        f"{SELECT_STEPS}", FacilityLocation.from_kernel(S, use_kernel=True),
        FacilityLocation.from_kernel(S, use_kernel=False), ids.tolist(), ref_ids.tolist())
    t = parting["agreeing_steps"]
    check_close(f"17 (dd) select_1m's gains over its first {t} picks vs the plain path's",
                gains[:t], ref.gains[:t].cpu(), *FL_TOL)
    parting["plain_s"] = plain_s
    return {"max_abs_err": errs, "plain_greedy": parting}


def _selection_world_of_one(torch, args, cells: dict) -> dict:
    """(dd) One rank's full-width share of each selection cell on an NCCL
    world of 1: a (1,024 x 65,536) block of ops.similarity (cosine) over a
    mixture at d = 1,024, fp32 and its bf16 rounding, through
    build_selection_step's step at budget 512; walls, launches, the peak
    against the 256-rank dry run's arguments + temp; each bf16 run's ids
    and gains bit-equal to the fp32 step on the widened block; the kernels
    at these shapes and the dense run's ids against the plain versions
    (:func:`_selection_kernels`)."""
    import datetime
    import tempfile

    import torch.distributed as dist

    from repro_torch.core.optimizers import _threefry
    from repro_torch.core.optimizers.distributed import _axis, psum
    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import SELECTION_SHAPES, build_selection_step
    from repro_torch.launch.mesh import make_test_mesh

    u, pool = SELECT_ROWS_LOC, (1 << 20) // 16
    x = gaussian_mixture_cuda(torch, args.seed + SHARD_SEED + 1, pool, SELECT_POOL_D)
    rows = x[torch.randperm(pool, generator=torch.Generator(device="cuda").manual_seed(
        args.seed), device="cuda")[:u]].contiguous()
    S = ops.similarity(rows, x, "cosine")
    del x, rows
    blocks = {"fp32": S, "bf16": S.bfloat16()}
    blocks["widened"] = blocks["bf16"].float()
    store = Path(tempfile.mkdtemp()) / "store"
    timeout = datetime.timedelta(seconds=SHARD_PG_TIMEOUT_S)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1,
                            timeout=timeout)
    out, runs = {}, {}
    try:
        mesh = make_test_mesh((1, 1), ("data", "model"), timeout=timeout)
        for axes in (("model",), ("data",)):  # each group's communicator, before the walls
            psum(torch.zeros(1, device="cuda"), _axis(mesh, axes))
        plan = [(shape, SELECTION_SHAPES[shape], "bf16" if "bf16" in shape else "fp32")
                for shape, mesh_kind in SELECT_CELLS if mesh_kind == "single"]
        plan += [(None, "dense", "widened"), (None, "stochastic", "widened")]
        for shape, variant, block in plan:
            fn, _, _ = build_selection_step(mesh, pool=pool, variant=variant)
            sim = blocks[block]
            key = (_threefry.prng_key(args.seed),) if "stochastic" in variant else ()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            ops.reset_launches()
            t0 = time.perf_counter()
            order, gains = fn(sim, *key)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - before + sim.nbytes
            launches = {k: ops.LAUNCHES[k] for k in ("fl_gains", "fl_gains_at")}
            runs[(variant, block)] = (order.cpu(), gains.cpu())
            ids = order.cpu()
            if not (bool((ids >= 0).all()) and len(set(ids.tolist())) == SELECT_STEPS
                    and bool(gains.isfinite().all())):
                raise AssertionError(f"17 (dd) {variant} on {block}: ids {ids[:8].tolist()}.., "
                                     f"gains finite {bool(gains.isfinite().all())}")
            sweep = "fl_gains_at" if "stochastic" in variant else "fl_gains"
            if launches != {k: SELECT_STEPS if k == sweep else 0 for k in launches}:
                raise AssertionError(f"17 (dd) {variant}: launches {launches}")
            run = {"variant": variant, "block": block, "wall_s": wall, "launches": launches,
                   "peak_bytes": peak, "step_ms": 1e3 * wall / SELECT_STEPS}
            if shape is not None:
                dry = cells[f"{shape}__single"]["memory"]
                if sim.nbytes != dry["argument_size_in_bytes"]:
                    raise AssertionError(f"17 (dd) {shape}: the block's {sim.nbytes} B are not "
                                         f"the dry run's arguments {dry}")
                predicted = dry["argument_size_in_bytes"] + dry["temp_size_in_bytes"]
                run.update(predicted_peak_bytes=predicted, peak_ratio=predicted / peak)
                if not SHARD_PEAK_RATIO[0] <= predicted / peak <= SHARD_PEAK_RATIO[1]:
                    raise AssertionError(f"17 (dd) {shape}: the dry run's peak {predicted} B "
                                         f"over the measured {peak} B is outside "
                                         f"{SHARD_PEAK_RATIO}")
            out[shape or f"{variant}_widened"] = run
            log(f"  ok  17 (dd) {shape or variant} on the {block} block ({u} x {pool}), NCCL "
                f"world of 1: {wall:.3f} s ({run['step_ms']:.3f} ms a step), launches "
                f"{launches}, peak {peak} B"
                + (f", the dry run's arguments + temp {run['predicted_peak_bytes']} B (ratio "
                   f"{run['peak_ratio']:.3f})" if shape is not None else ""))
    finally:
        dist.destroy_process_group()
    for bf16, fp32 in (("bf16", "dense"), ("stochastic_bf16", "stochastic")):
        got, want = runs[(bf16, "bf16")], runs[(fp32, "widened")]
        if not (torch.equal(got[0], want[0])
                and torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))):
            raise AssertionError(f"17 (dd) the {bf16} run is not the {fp32} run on the widened "
                                 "block")
    log("  ok  17 (dd) each bf16 run's ids and gains bit-equal to the fp32 step on the widened "
        "block")
    out["plain"] = _selection_kernels(torch, args, blocks, *runs[("dense", "fp32")])
    launches = collections.Counter()  # the four cells' runs: the path's
    for shape in SELECTION_SHAPES:
        launches.update(out[shape]["launches"])
    out["launches"] = dict(launches)
    return out


def phase_sharded_training(torch, args) -> dict:
    """Phase 17: training on a mesh and the dry run.  (aa) a world of 1 on
    NCCL: DTensor steps bit-equal to the unsharded ones and the dry run's
    exact arguments and its peak; (bb) four ranks: sharded steps against
    unsharded, collectives and peaks against the dry run, the elastic
    checkpoint, the MoE layer at a model axis of 2; (cc) the dry run at
    production scale; (dd) one rank's share of each selection cell."""
    import logging

    t_start = time.perf_counter()
    log("== phase 17: training on a mesh and the dry run")
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    # (bb): four ranks, one NCCL rank a card on four cards, else four gloo
    # ranks on this one, after the probe's unrepaired functional all-gather
    # (printed; make_mesh installs the port's repair).  The probe's
    # processes run beside (aa), (bb)'s ranks beside (cc) on the host
    backend = "nccl" if torch.cuda.device_count() >= 4 else "gloo"
    probe = _gloo_probe_start() if backend == "gloo" else None
    world = None
    try:
        out = {"aa": _shard_world_of_one(torch, args)}
        torch.cuda.empty_cache()  # (bb)'s four ranks share the card
        if probe is not None:
            # the fault that make_mesh's gather_without_work answers: once
            # this case exits 0 on every rank, the repair goes with it
            out["probe"] = _gloo_probe_result(probe)
            log(f"  17 (bb) the unrepaired functional all-gather of CUDA tensors over gloo "
                f"(tools/gloo_cuda_probe.py funcol_all_gather, torch {torch.__version__}): "
                f"{json.dumps(out['probe'])}")
        world = _start_shard(args, backend)
        drys = _shard_dry()
        out["cc"], out["cc_selection"] = _shard_dryrun(torch)
        out["bb"] = _shard_2x2_full(torch, args, world, drys)
        out["bb"]["seconds"] = time.perf_counter() - world["t0"]
    finally:
        _stop(([probe] if probe is not None else []) + (world["procs"] if world else []))
    out["dd"] = _selection_world_of_one(torch, args, out["cc_selection"])
    out["seconds"] = time.perf_counter() - t_start
    log(f"phase 17: {out['seconds']:.1f} s")
    return out


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n", type=int, default=50_000)
    p.add_argument("--d", type=int, default=512)
    p.add_argument("--naive-budget", type=int, default=500)
    p.add_argument("--lazy-budget", type=int, default=5_000)
    p.add_argument("--reps", type=int, default=50, help="timed launches per kernel")
    p.add_argument("--mf-n", type=int, default=1 << 20,
                   help="candidates of phases 6 (b), 8 and 9 (i), the million-point shape")
    p.add_argument("--mf-lazy-budget", type=int, default=1_000,
                   help="LazyGreedy budget of phases 6 (a) and (c), 7 (d), 8 and 9 (k)")
    p.add_argument("--wave-b", type=int, default=64,
                   help="phase 10 (l): members of the first wave (the second has a quarter)")
    p.add_argument("--wave-n", type=int, default=4096,
                   help="phase 10: n of the first wave and of (n); the second wave has 2x")
    # phase 13 (u) starts its ranks as this script with these
    p.add_argument("--rank-2x2", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--dir-2x2", default=None, help=argparse.SUPPRESS)
    # phase 14 (w) likewise
    p.add_argument("--rank-mesh", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--dir-mesh", default=None, help=argparse.SUPPRESS)
    # phase 17 (bb) likewise
    p.add_argument("--rank-shard", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--dir-shard", default=None, help=argparse.SUPPRESS)
    p.add_argument("--backend-shard", default="gloo", help=argparse.SUPPRESS)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch/ not found beside this script", file=sys.stderr)
        return 2
    if args.rank_2x2 is not None:
        return _rank_2x2(args)
    if args.rank_mesh is not None:
        return _rank_mesh(args)
    if args.rank_shard is not None:
        return _rank_shard(args)
    sys.path.insert(0, str(ROOT / "src"))
    # the plain versions run in full fp32 on the card: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import ops

    t_start = time.perf_counter()
    device = phase_device(torch)
    build = phase_build()
    phase_kernels(torch, args.seed)
    phase_mf_kernels(torch, args.seed)
    dense_bits = phase_dense_kernels(torch, args.seed)
    select_counts = phase_select_cols(torch, args.seed)
    cover_bits = phase_cover_kernels(torch, args.seed)
    fused_bits = phase_fused_kernels(torch, args.seed)
    main_out, fn, naive_res = phase_main(torch, args)
    kernels = phase_times(torch, args, fn, naive_res, main_out)
    dense_out, D = phase_dense_pairwise(torch, args, fn.sim)
    dense_out["phase3_bit_equal_at_counts"] = dense_bits
    dense_out["phase3_select_cols_counts"] = select_counts
    dense_rows = phase_dense_times(torch, args, fn.sim, D, dense_out)
    del fn, D  # phase 6 holds its peak memory against a budget: S and D (n x n) go
    mf_rows = phase_mf_times(torch, args, naive_res)
    mf_out = phase_matrix_free(torch, args, main_out)
    t_cover = time.perf_counter()
    cover_out, cover_fns = phase_coverage(torch, args)
    cover_out["phase3"] = cover_bits
    cover_rows = phase_cover_times(torch, args, cover_fns, cover_out)
    del cover_fns
    cover_out["seconds"] = time.perf_counter() - t_cover
    log(f"phase 8 and its times: {cover_out['seconds']:.1f} s")
    guided_out, fused_row = phase_slice5(torch, args)
    guided_out["phase3"] = fused_bits
    wave_out = phase_wave(torch, args)
    served = phase_served(torch, args)
    remaining = phase_remaining(torch, args, main_out)
    distributed = phase_distributed(torch, args, main_out)
    mesh_served = phase_mesh_served(torch, args)
    train = phase_train(torch, args, device)
    other = phase_other(torch, args, device)
    sharded_training = phase_sharded_training(torch, args)
    for rows, path in ((mf_rows, mf_out), (dense_rows, dense_out), (cover_rows, cover_out)):
        for r in rows:
            r["launches"] = r["launches_on_path"] = path["launches"][r["name"]]
    kernels += mf_rows + dense_rows + cover_rows + [fused_row]
    # rows 2 and 3 also carry the first wave's launches (phase 10 (l)) and
    # times over its stacked S
    first = wave_out[f"l_B{args.wave_b}_n{args.wave_n}"]
    waves = first["kernels"]
    for r in kernels:
        if r["name"] == "fl_gains":
            r["wave"] = {"shape": waves["shape"], "launches": first["NaiveGreedy"]["wave_launches"]
                         .get("fl_gains", 0), "ms": waves["fl_gains_ms"],
                         "members_ms": waves["fl_gains_members_ms"],
                         "bound_ms": waves["fl_gains_bound_ms"]}
        if r["name"] == "fl_gains_at":
            r["wave"] = {"shape": waves["shape"] + [8], "launches": first["LazyGreedy"]
                         ["wave_launches"].get("fl_gains_at", 0), "ms": waves["fl_gains_at_k8_ms"],
                         "members_ms": waves["fl_gains_at_k8_members_ms"],
                         "bound_ms": waves["fl_gains_at_k8_bound_ms"]}
    # every row also carries its launches on the served path (phase 11's
    # steady round; similarity's while the requests were built)
    for r in kernels:
        src = served["build"] if r["name"] == "similarity" else served["steady"]
        r["served"] = {"launches": src["launches"].get(r["name"], 0)}
        # and on the remaining optimizers' path (phase 12)
        r["remaining"] = {"launches": remaining["launches"].get(r["name"], 0)}
        # and on the sharded path (phase 13 (t) and (u))
        r["sharded"] = {"launches": distributed["launches"].get(r["name"], 0)}
        # and on the mesh-served path (phase 14 (v), (w)'s four ranks and (x))
        r["served_mesh"] = {"launches": mesh_served["launches"].get(r["name"], 0)}
        # and on the training path (phase 15's two runs), with the times of
        # the path's kernels at its shapes
        r["train"] = {"launches": train["launches"].get(r["name"], 0),
                      **train["kernels"].get(r["name"], {})}
        # and on the other families' training path (phase 16 (z)'s two runs)
        r["other_families"] = {"launches": other["launches"].get(r["name"], 0)}
        # and on the selection cells' path (phase 17 (dd): one rank's share of each)
        r["selection_cells"] = {"launches": sharded_training["dd"]["launches"].get(r["name"], 0)}
    missing = set(ops.LAUNCHES) ^ {r["name"] for r in kernels}
    if missing:
        raise AssertionError(f"kernels line and LAUNCHES differ: {sorted(missing)}")
    record = {"device": device, "build": {k: build[k] for k in ("seconds", "cached")},
              "main": main_out, "matrix_free": mf_out, "dense_pairwise": dense_out,
              "coverage": cover_out, "guided": guided_out, "wave": wave_out, "served": served,
              "remaining": remaining, "distributed": distributed, "mesh_served": mesh_served,
              "train": train, "other_families": other, "sharded_training": sharded_training,
              "kernels": kernels,
              "seconds": time.perf_counter() - t_start}
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    log(f"total {record['seconds']:.1f} s; details in {OUT_DIR / 'chip_smoke.json'}")
    log(device["nvidia_smi"])
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device["kind"],
                                             "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
