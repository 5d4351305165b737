#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run on any miss:

1. build      -- compile the seven CUDA kernel libraries from the sources
                 in this checkout (one ``nvcc`` per source, all at once,
                 for ``sm_90a`` into ``build/``): ``lqt_combine`` (pairwise),
                 ``lqt_scan`` (a whole scan in one launch),
                 ``lqt_scan_wide`` (states 9 to NX_WIDE wide), and two
                 variants each of ``flash_attention`` and ``ssd_chunked``
                 (``mma``: bf16 tensor cores; ``simt``: float32 CUDA
                 cores), with ptxas's register and spill counts per
                 instantiation and the HMMA/HGMMA count of each ``mma``
                 library's SASS (``cuobjdump``);
2. kernels    -- each kernel against its plain PyTorch version on the
                 card: ``lqt_combine`` on random element pairs with PSD
                 C/J, nx in {2, 4, 5, 8}, lane counts {1, 7, 4097, 2**20},
                 float32 and float64; the scan kernel against the plain
                 scan at every nx in 1..8 (n in {1, 2, 17, 513, 2049}
                 at the paths' nx = 4, 5; n in {1, 2, 17, 513} at the
                 others), records {1, 64}, float32 and float64, both
                 directions, and
                 ``kernel_suffix_scan`` against the core suffix scan; the
                 wide kernel against the plain scan at l96-batch64's scan
                 (513 elements x 64 records, nx = 40, both directions,
                 float64 and float32, its launches a scan) and its
                 pairwise entry against the plain combine at a block
                 fold's 32768 pairs;
                 ``flash_attention`` and
                 ``ssd_chunked`` in float32 and bfloat16 on the reference's
                 small test cases, at D = 80 (hubert's and danube's
                 shapes, ragged edges), and at every LM path's prefill or
                 training-microbatch shape (hymba-1.5b, granite-moe-3b,
                 the zoo's waves: the errors the report gives each path),
                 plus bfloat16 cases for the tensor-core tiling, each
                 case naming the variant it ran; the SSD ``mma`` kernel's
                 stage-2 chunk states against the staged plain version;
3. estimation -- ``Estimator(method="parallel_kernel").solve`` on the
                 Wiener velocity model (paper section 5.1) at T = 2048
                 blocks x nsub = 10 (N = 20480) in float64, for one record
                 and for 64 stacked records, held against the port's
                 ``parallel_rts`` on the card and its ``sequential_rts`` on
                 the CPU, with the launch count of the scan kernel (one
                 per solve's backward scan), the median solve time and one
                 profiled solve per cell;
3a. cache/AOT -- the estimation cell through a private
                 ``ExecutableCache``: a fresh single solve and a hit, the
                 same for stacked64, each layout's
                 ``est.lower(problem).compile()`` entry called with the
                 problem's tensors (bit for bit the solve's result), the
                 ragged cell twice (a new entry per bucket, then every
                 bucket a hit); exact hit, miss and scan-launch counts, one
                 ``cache.compile_seconds`` sample per fresh entry, and the
                 fresh and cached solve times;
3b. nonlinear -- the paper's Fig.-2 experiment: the iterated Taylor
                 smoother (5 passes) on the coordinated-turn model
                 (section 5.2) at T = 512 blocks x nsub = 10 (N = 5120) in
                 ``mode="euler"``, float64, one record and 64 stacked
                 records from the port's ``simulate_nonlinear``:
                 ``parallel_kernel`` (the scan kernel at nx = 5, one launch
                 per pass) against
                 ``parallel_rts`` and ``sequential_rts`` on the card, the
                 two-filter smoother (``discrete``) against ``parallel_rts``
                 (``discrete``), the cost traces, median solve times of the
                 three methods, one profiled solve per cell, and the solve in
                 float32 (its distance from float64 printed, not gated);
3b'. Lorenz-96 -- one wave of l96-batch64 (64 records of 5120
                 intervals, N = 40, 5 passes) through ``TrajectoryEngine``
                 after a warm wave, every launch counter zeroed just
                 before it: the wide kernel's launches a pass, the
                 pairwise entry's in-block steps, no ``lqt_scan`` or
                 ``lqt_combine`` launch, the telemetry counters alike;
                 four records against ``parallel_rts`` (1e-8);
3c. sigma point -- ``method="sigma_point"`` (the posterior-linearisation
                 smoother, section 5.2's model) on the nonlinear phase's
                 records: unscented SLR on one record and on 64, cubature
                 on one, 5 passes each with the scan kernel as the inner
                 method (one launch per pass), against the same options
                 with ``parallel_rts`` on the card, the cost traces beside
                 the Taylor IEKS's costs, median solve times and one
                 profiled solve per cell;
3d. ragged    -- 64 Wiener records of 2560..20480 intervals (seeded
                 draws, prefixes of the estimation phase's records) as one
                 ``Problem.ragged`` through ``parallel_kernel``: one stacked
                 solve and one scan launch per bucket, the padding report
                 against the lengths, every record against ``parallel_rts``
                 on the card and each bucket's shortest record, unpadded,
                 against ``sequential_rts`` on the CPU, the median solve
                 time and one profile;
3e. trajectory engine -- the ragged cell's 64 records submitted from the
                 host in draw order to ``TrajectoryEngine(batch=16,
                 method="parallel_kernel")`` and drained: waves per bucket
                 (ceil(records / 16)), one scan launch per wave, the
                 recycled rows, every record against the port's
                 ``parallel_rts`` ragged solve on the card; drain
                 records/s, record latency p50/p99, occupancy, padding
                 waste (``repro_torch.obs``) and one profiled wave;
3f. streaming, linear -- 256 Wiener tracks of 400 intervals through
                 ``StreamingEngine(lag=64, batch=64,
                 method="parallel_kernel")`` in round-robin chunks of 20
                 with a drain after each round (the reference's streaming
                 benchmark workload at 16x its tracks), after a warm-up
                 pass on other tracks: one scan launch per wave, four
                 tracks' final windows against an offline ``parallel_rts``
                 solve of the whole record; windows/s, window latency
                 p50/p99, eviction counters and one profiled wave; then a
                 late pass (lag 10, reorder slack 20, 10 % of the
                 measurements one round late): no late drops and the same
                 offline bound;
3g. streaming, sigma point -- 64 coordinated-turn tracks of 200
                 intervals through two ``StreamingEngine(method=
                 "sigma_point")``s (inner ``parallel_kernel`` and
                 ``parallel_rts``) on the same pushes: the scan launched
                 once per pass of each wave, the final estimates within
                 1e-8 of each other; windows/s and latency;
3h. time-sharded -- ``Estimator(method="distributed")`` on meshes of
                 P x cuda:0 (P = 2, 4, 8: every shard's scan, carry
                 exchange and fix-up, on one card) for the estimation
                 cell's single record and 64 records (2049 scan elements:
                 the head/tail stitch) and a 20470-interval record (2048:
                 divisible), against ``parallel_rts`` (1e-9) and
                 ``parallel_kernel`` (1e-8) on the card and
                 ``sequential_rts`` (1e-7) on the CPU; 2P counted shards
                 and the ``distributed_scan`` span per solve, no kernel
                 launch (the plain combine, as the reference), median
                 solve times beside ``parallel_rts``'s; a float32 solve
                 with a float64 carry scan (other bits than the
                 float32-carry solve; its error printed); the
                 default mesh's fallback (``"auto"`` equals
                 ``parallel_rts``, ``"error"`` raises) on one card;
3i. batch-sharded -- records split over a mesh's batch axis: stacked64
                 through ``parallel_kernel`` on a batch axis of 4 (one
                 scan launch per shard, < 1e-8 of the unsharded solve),
                 ``distributed`` on a 4 x 2 (time x batch) mesh (< 1e-9 of
                 ``parallel_rts``), the ragged cell's records through
                 ``TrajectoryEngine(batch=16)`` on a batch axis of 2
                 (launches = waves x 2, < 1e-8 of the ragged
                 ``parallel_rts`` solve), and 64 Wiener tracks through
                 ``StreamingEngine(lag=64, batch=64)`` on a batch axis of
                 2 (launches = waves x 2, final windows < 1e-9 x scale of
                 offline);
3i'. user scans -- ``scan_combine_fn()``, the pairwise ``lqt_combine``
                 kernel as the combine of ``core.pscan`` scans, on the
                 estimation cell's single record: in ``parallel_rts``
                 (one launch per combine of the suffix scan's tree: 21)
                 against the default ``parallel_rts`` (max|dx| < 1e-8),
                 and in ``sharded_scan`` at P = 4 on a time mesh of
                 cuda:0 (4 local scans, 3 carry combines, 3 fix-ups and a
                 stitch: 75) against the plain suffix scan (normwise
                 < 1e-8); exact launches predicted from T, ms a path
                 beside the plain combine's;
3j. lqt timing -- the scan kernel at every path's scans
                 (CUDA events around a CUDA-graph replay of back-to-back
                 scans, eager calls beside), its bound, the per-launch bound
                 of the tree's combines it replaces, the plain scan, and a
                 depth sweep over one record (its slope is the latency per
                 tree level); the pairwise kernel at the launch shapes the
                 per-level scan had (graph replay, eager calls, profiler),
                 beside its plain version and bound, summed over the user
                 scans' launches (its row in the report) and over the
                 per-level scan's shapes of the estimation paths; the
                 wide kernel at the Lorenz-96 wave's scans and its
                 pairwise entry at the wave's fold and value steps, each
                 beside its plain version and its bound (two report rows);
3k. long grid -- (after 3i') the Wiener velocity model with a
                 time-varying noise Q(t) = Q (1 + 0.5 sin t) (Q stays
                 singular), float64: one record of 16384 blocks x nsub =
                 10 (163840 intervals) and 64 stacked records of the
                 estimation cell's grid (1.31 M points), both past the
                 ~31000 4 x 4 matrices cuSOLVER's batched ``eigh`` takes
                 in one call (probed at n = 2, 4, 8, 32;
                 ``core.sde.EIGH_CHUNK`` must lie below it):
                 ``simulate_linear`` on the card (the square roots of
                 Q(t), their eigendecompositions in chunks of
                 EIGH_CHUNK), ``parallel_kernel`` (one scan launch) against
                 ``parallel_rts`` (1e-8), a finite ``om_cost_grid``, the
                 chunked square roots against the same grid factored on
                 the CPU (normwise 1e-12), and each grid factorisation's
                 (eigh, pinv, cholesky, inv) ms at the chunk sizes of
                 ``FACTOR_SWEEP``;
3l. collector -- (after 5e'') with Python's cyclic garbage collector
                 disabled: one Wiener single solve (a private executable
                 cache) and one smollm-135m prefill plus decode at full
                 width and depth; ``torch.cuda.memory_allocated()`` back
                 to its value before them once every result is deleted,
                 and no tensor among what ``gc.collect()`` then finds
                 (``gc.DEBUG_SAVEALL``);
4. serving    -- ``ServeEngine.generate`` on hymba-1.5b at full width in
                 bfloat16 (random weights from a seeded generator): 16
                 requests of 2048 prompt tokens and 32 new tokens in two
                 waves of 8, with the launch counts of both LM kernels
                 (32 each per wave, all of the ``mma`` variant), prefill
                 ms per wave, decode ms per
                 step and tokens/s from CUDA events, and one profiled
                 prefill and decode step;
5. cross-path -- the same weights in float32, one wave of 8 x 2048
                 tokens: prefill logits of the kernel path against the
                 plain path, and their first generated tokens;
5a. pipeline  -- ``pipeline_forward`` over hymba-1.5b's 32 layers (the
                 serving phase's bf16 weights) in 4 stages of 8 on a
                 ``("pipe",)`` mesh of 4 x cuda:0, 4 microbatches of 2 x
                 2048 embedded tokens through the kernels: 128 ``mma``
                 launches of each LM kernel, the output bit for bit the
                 unpipelined stack run per microbatch (on a difference,
                 each kernel is probed for repeat-determinism and the gate
                 becomes 2e-2 x max|out| only if one varies), wall times;
5b. training   -- ``Trainer.run`` on hymba-1.5b at full width and depth
                 in bfloat16 (random weights from a seeded generator): 8 x
                 2048 tokens a step in two microbatches for 6 steps, with
                 each step's ms (CUDA events), tokens/s, loss, grad_norm and
                 lr, the peak memory, the launch counts of both LM kernels
                 (``remat_forwards`` x microbatches per step, all ``mma``),
                 the step-6 checkpoint's size, save and restore seconds and
                 a bit-exact restore, the AdamW update's own time and one
                 profiled step; then a new trainer resumes from the
                 checkpoint and runs to step 8;
5c. training cross-path -- hymba-1.5b's widths at 2 layers in float32, 2 x
                 2048 tokens: ``train_loss`` and every gradient leaf through
                 the kernels (``simt``, under the autograd Functions)
                 against the plain path, normwise within 1e-3;
5d. compressed data-parallel -- ``make_compressed_dp_step`` on hymba-1.5b
                 at full width and 8 layers over a ``("data",)`` mesh of 2
                 x cuda:0, 2 x 2048 tokens a shard, AdamW, both LM kernels
                 under autograd: the step-1 compressed gradient mean within
                 2^-8 (normwise per leaf) of the exact float32 mean, 40
                 compressions of a constant float32 tree within the
                 reference's 0.05 / 2e-3 error-feedback bounds, 3 steps
                 beside 3 uncompressed ones from the same weights and data
                 (finite losses), launches, ms a step and peak memory;
5e. sharded training -- ``make_train_step`` on ShardedTensors
                 (``repro_torch.distributed.spmd``): hymba-1.5b at full
                 width and 8 layers on a ("data", "model") mesh of 2 x 2
                 cuda:0 (q/k/v on ``head``, attention at full heads a data
                 group; the SSM's ``ssm_x`` weights gathered), 2 x 2048
                 tokens a data shard, zero1, 3 bf16 AdamW steps: finite
                 losses, the step-1 loss within 1e-2 of the single-device
                 loss, exact ``mma`` launches, ms and tokens/s a step, peak
                 memory (and what is allocated when the peak is reset),
                 the collective log (counts and bytes by kind);
                 first its float32 gate at 2 layers, 2 x 512 tokens, one
                 step against the single-device step at the reference
                 test's tolerances (loss, gradients, params outside
                 AdamW's eps band); in hymba's cell a sharded checkpoint
                 of (params, opt) after step 2 (bytes, seconds, GB/s;
                 every shard equal to the file), restored onto the same
                 mesh (every shard bit for bit) and step 3 run from it
                 (within 1e-2 of the uninterrupted step 3, the exact
                 difference printed), and a float32 gate: a save after
                 one 2 x 2 step at 2 layers, the second step resumed on a
                 (4, 1) mesh and on one device against the uninterrupted
                 one at the reference test's tolerances, with exact
                 ``simt`` launches; the same for granite-moe-3b after 5h
                 on a 2 x 4 mesh (expert parallelism, 10 experts a shard;
                 head-local attention, 6/2 heads a shard); then hymba's
                 cell again with ``seq_parallel`` (the residual stream
                 split by sequence over the model axis between the
                 layers): the same gates, its step ms and log beside the
                 non-SP cell's, the log entries that moved;
5e'. sharded serving -- ``ServeEngine.generate`` on ShardedTensor params
                 under their mesh's ``mesh_context`` (sharded prefill and
                 decode on ``cache_pspecs``'s layouts): hymba-1.5b at full
                 width and depth on a 2 x 2 (data, model) mesh of cuda:0
                 (kv split over ``hd``, the SSM state over heads, the conv
                 tail over channels), the serving cell's 16 requests in
                 waves of 8; exact ``mma`` launches (2 data groups x 32
                 layers = 64 attention + 64 SSD a wave), finite bf16
                 logits, prefill ms a wave, decode ms a step and new
                 tokens/s beside the single-device engine's, the greedy
                 tokens' agreement with it, the collective log of a
                 prefill wave and a decode step, peak memory; first a
                 float32 gate at 2 layers, 2 x 512 tokens: prefill logits
                 and every cache shard, then 4 decode steps, against the
                 single-device run at rtol 2e-4 / atol 2e-4 with the same
                 greedy tokens; the same for granite-moe-3b after 5h on a
                 2 x 4 mesh (head-local attention, kv over heads, expert
                 parallelism: 2 x 4 x 32 = 256 attention launches a wave
                 at (4, 6, 2, 2048, 2048, 64));
5e''. dp-only -- smollm-135m at full width and depth (30 layers) under
                 ``parallel_policy="dp_only"`` on a 2 x 4 (data, model)
                 mesh of cuda:0, the batch over both axes (8 data groups
                 of one position; every weight replicated but the tied
                 table, split 4 ways over vocab): after 5b for smollm on
                 one card (the single-device engine), 5e's float32 gates
                 at 2 layers with 8 x 512 tokens (a row a group), 3 bf16
                 AdamW steps of 8 x 2 x 2048 tokens (zero1 over all 8
                 positions; 8 x ``remat_forwards`` x 3 attention
                 launches), and the serving cell through the sharded
                 ``ServeEngine`` (waves of 8, a row a group: 8 attention
                 launches a layer a wave), beside the single-device run
                 (after 5h);
5f. MoE serving -- ``ServeEngine.generate`` on granite-moe-3b-a800m (40
                 experts, top 8) at full width and depth in bfloat16, the
                 hymba cell's shape: 32 ``mma`` attention launches per
                 wave and no SSD, prefill ms per wave, decode ms per step,
                 tokens/s, the dropped fraction of expert assignments per
                 layer at prefill (the layer's own rank and capacity), and
                 one profiled prefill and decode step with the MoE layer's
                 share of busy time;
5g. MoE cross-path -- granite's weights at 2 layers in float32, one wave:
                 the kernel path's last logits against the plain path's
                 within 1e-3 and the same first tokens, with the expert
                 choices the two paths route differently per layer;
5h. MoE training -- ``Trainer.run`` on granite-moe-3b at full width and 16
                 of its 32 layers in bfloat16, 8 x 2048 tokens a step in 2
                 microbatches for 4 steps: finite losses (the router
                 balance term included), ``remat_forwards`` x 2 ``mma``
                 attention launches a step, the peak memory, and a nonzero
                 router gradient in every layer; then 5c on granite's
                 widths with the routing differences of the forward;
5i. the zoo   -- the other eight architectures (mamba2, smollm, qwen3,
                 danube, starcoder2, hubert, llava, phi3.5) at full width
                 and 2 layers: 5c at 2 x 2048 tokens (embeddings for
                 hubert and llava), and for each token-input decoder one
                 bfloat16 ``ServeEngine`` wave of 2 x 2048 prompts and 4
                 new tokens, every attention (D = 64, 80, 128) and SSD
                 (S = 128) launch of the ``mma`` variant, finite logits;
5j. dry-run  -- ``python -m repro_torch.launch.dryrun`` (no card: meshes of
                 ``meta`` devices) for five cells of the single-pod mesh
                 (16 x 16) at once, one process each: hymba-1.5b
                 ``decode_32k`` and ``long_500k``, granite-moe-3b
                 ``prefill_32k``, smollm-135m ``train_4k`` under the tp
                 and the dp-only policy; each record ``ok``, its seconds
                 printed, the phase under 90 s;
6. LM kernels -- each LM kernel's time at every LM path's shapes (hymba's
                 serving and training, granite's serving and training,
                 smollm's serving and dp-only paths, the zoo's waves),
                 beside the simt design at the same shape (timed in
                 turns), its plain version, the PyTorch library
                 call where there is one, its bound, and each SSD stage's
                 time;
7. report     -- one JSON line of per-kernel numbers, the card's name and
                 power limit, and the final status line.

It needs a CUDA card: without one it exits non-zero and prints no result.
``--phases long-grid,sharded2x2,collector,wide`` (any of them, in the
order given) runs only those phases after the build, and prints no
report; ``wide`` (2's wide checks, 3b' and the wide rows of 3j) prints
its two rows.
It imports only the port, never the JAX reference package.
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import functools
import importlib
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate, the non-tensor-core
# float rates, and the dense bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12,
              torch.bfloat16: 989e12}

N_BLOCKS, NSUB, RECORDS = 2048, 10, 64
SEED = 0
# coordinated-turn cell: the top of the reference's Fig.-2 harness
# (benchmarks/fig2_nonlinear.py:19), 5 passes in euler mode
NL_BLOCKS, NL_ITERS, NL_MODE = 512, 5, "euler"
# nonlinear gates: kernel vs plain combine on the same arithmetic up to the
# combine's pivoting; euler-mode parallel vs sequential and two-filter vs
# RTS at the reference's own bounds (tests/test_nonlinear.py:
# test_euler_mode_ieks, test_two_filter_ieks)
NL_KERNEL_TOL, NL_SEQ_TOL, NL_TF_TOL = 1e-8, 5e-2, 1e-5
# sequential_rts's timed runs a problem: its timed gate solve alone (12-25
# s each on the card's host; with the long-grid and collector phases the
# script's 1200 s limit leaves no room for more)
NL_SEQ_RUNS = 1
# ragged cell: record lengths drawn uniformly from these interval counts
# (256 to 2048 blocks of nsub = 10), mostly not multiples of nsub
RAGGED_LENGTHS = (2560, 20480)
# trajectory-engine cell: the ragged cell's records through the engine in
# waves of ENGINE_BATCH
ENGINE_BATCH = 16
# streaming cells: the reference's streaming benchmark workload (lag 64,
# chunks of 20; benchmarks/streaming_latency.py:136) at 256 tracks of 400
# intervals in waves of 64; sigma point: 64 tracks of 200 intervals
STREAM_TRACKS, STREAM_N, STREAM_LAG, STREAM_CHUNK, STREAM_BATCH = (
    256, 400, 64, 20, 64)
SP_STREAM_TRACKS, SP_STREAM_N = 64, 200
# sharded paths: time shards of method="distributed" on meshes that repeat
# card 0, gated against parallel_rts at the reference's own bound (1e-9,
# tests/test_distributed_method.py), against the kernel path (1e-8) and
# sequential_rts (1e-7); record-axis shards of the stacked kernel solve;
# the streaming pass's track length
TIME_SHARDS = (2, 4, 8)
DIST_TOL, DIST_KERNEL_TOL, DIST_SEQ_TOL = 1e-9, 1e-8, 1e-7
BATCH_SHARDS = 4
# the pairwise kernel in user scans: sharded_scan's time shards
USER_SCAN_SHARDS = 4
SHARD_STREAM_N = 200
# kernel vs plain version: normwise relative error bound per dtype.  The
# unpivoted Gauss-Jordan and the pivoted solve differ by round-off times
# the conditioning of M = I + C1 J2 (at most a few hundred for these
# operands), so float64 stays far below 1e-10 and float32 below 1e-3.
KERNEL_RTOL = {torch.float64: 1e-10, torch.float32: 1e-3}
# scan kernel vs plain scan, normwise: the same tree and combine order, each
# combine differing by the combine's round-off (above), compounded over the
# tree's levels
SCAN_RTOL = {torch.float64: 1e-9, torch.float32: 1e-3}
SCAN_SWEEP = (2, 3, 5, 9, 17, 33, 65, 129, 257, 513, 1025, 2049)
# scan check sizes: the paths' state sizes (nx = 4, 5) up to their longest
# scan; the rest of 1 <= nx <= 8 (no path runs them) at fewer sizes
PATH_NX = (4, 5)
SCAN_CHECK_N = {True: (1, 2, 17, N_BLOCKS // 4 + 1, N_BLOCKS + 1),
                False: (1, 2, 17, N_BLOCKS // 4 + 1)}
# Lorenz-96 cell (l96-batch64): 512 blocks of the configuration's nsub in
# waves of RECORDS, state 40 wide (the wide kernel's path)
L96_BLOCKS, L96_NX = 512, 40

# hymba-1.5b serving cell: two waves of 8 prompts of 2048 tokens.  2048 is
# a multiple of the 1024 window, the 256 SSD chunk and chunked_mha's 512
# chunk, so the rolling cache is placed as decode expects.
LM_ARCH, LM_BATCH, LM_PROMPT, LM_NEW, LM_REQUESTS = (
    "hymba-1.5b", 8, 2048, 32, 16)
LM_MAX_LEN = LM_PROMPT + LM_NEW
# LM kernels vs plain versions, from the reference's own test tolerances
# (tests/test_kernels.py): attention allclose at 2e-5 (float32) / 2e-2
# (bfloat16); SSD max abs error within 2e-5 (float32) / 0.04 (bfloat16)
# of the output's magnitude.  The SSD rule is normwise because each output
# sums up to Q * S products (256 * 128 at the largest case) of terms much
# larger than the smallest outputs, in another order than the plain
# version: float32 round-off scales with those terms, not elementwise.
FA_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SSD_TOL = {torch.float32: 2e-5, torch.bfloat16: 0.04}
# kernel path vs plain path on the whole model, float32: the two differ
# by float32 sums in another order through 32 layers.
CROSS_RTOL = 1e-3
# hymba-1.5b training cell: 8 sequences of 2048 tokens a step in two
# microbatches from seeded random weights, 6 steps with a checkpoint at
# step 6, then a new trainer resumes from it and runs to step 8
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS, TRAIN_TOTAL = (
    8, 2048, 2, 6, 8)
# training, kernel path vs plain path in float32: hymba-1.5b's widths at 2
# layers, 2 sequences of 2048 tokens; the loss and each gradient leaf
# (normwise) within the float32 forward check's bound (CROSS_RTOL)
TRAIN_CHECK_LAYERS, TRAIN_CHECK_BATCH = 2, 2
# granite-moe-3b-a800m: served at full width and depth in the hymba serving
# cell's shape; trained at full width with the depth cut from 32 to 16
# layers (AdamW state and gradient buffers take ~20 B a parameter: 66 GB at
# 32 layers), 8 x 2048 tokens a step in 2 microbatches, 4 steps; its
# float32 checks at 2 layers (serving: one wave of 8 x 2048; training:
# 2 x 2048, as hymba's)
MOE_ARCH = "granite-moe-3b-a800m"
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = 16, 4
# the zoo: the other eight architectures at full width, depth cut to 2
# layers (llava and phi3.5 do not fit the card whole): train_loss in
# float32 through the kernels against the plain path, 2 x 2048 tokens; a
# serving wave of 2 x 2048 prompts and 4 new tokens in bfloat16 for each
# token-input decoder
ZOO = ("mamba2-370m", "smollm-135m", "qwen3-4b", "h2o-danube-1.8b",
       "starcoder2-15b", "hubert-xlarge", "llava-next-34b",
       "phi3.5-moe-42b-a6.6b")
ZOO_LAYERS, ZOO_BATCH, ZOO_NEW = 2, 2, 4
# pipeline path: hymba-1.5b's 32 layers in 4 stages of 8 on a ("pipe",)
# mesh of 4 x cuda:0, 4 microbatches of 2 x 2048 tokens
PIPE_STAGES, PIPE_MICRO, PIPE_BATCH = 4, 4, 2
# compressed data-parallel path: hymba-1.5b at full width, depth cut to 8
# layers (the phase exercises the all-reduce, not depth), a ("data",) mesh
# of 2 x cuda:0, 2 x 2048 tokens a shard, 3 steps; error feedback over 40
# compressions (tests/test_distributed.py's own count)
DP_LAYERS, DP_SHARDS, DP_BATCH, DP_STEPS, EF_STEPS = 8, 2, 2, 3, 40
# sharded training path: the model at full width, depth cut from 32 to 8
# layers (every shard's params, grads and optimizer state share one card),
# on a ("data", "model") mesh repeating cuda:0 (hymba 2 x 2, granite 2 x 4),
# 2 x 2048 tokens a data shard, 3 AdamW steps, zero1; its float32 check at 2
# layers, 2 x 512 tokens, one step against the single-device step at the
# reference test's tolerances (tests/test_distributed.py: loss rtol 1e-5 /
# atol 1e-6, params rtol 5e-4 / atol 5e-5, the gradients at the params'
# rtol of each leaf's largest magnitude), the params outside the band
# |g| < 100 eps where AdamW's first update lr g / (|g| + eps) turns a
# float32 gradient noise d into up to lr d / eps; the bf16 step-1 loss
# within SHARD_BF16_RTOL of the single-device loss (bf16 sums in another
# order, stated before the first run)
SHARD_MESHES = {LM_ARCH: (2, 2), MOE_ARCH: (2, 4)}
SHARD_LAYERS, SHARD_BATCH, SHARD_STEPS = 8, 2, 3
SHARD_CHECK_LAYERS, SHARD_CHECK_SEQ = 2, 512
SHARD_LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
SHARD_PARAM_TOL = dict(rtol=5e-4, atol=5e-5)
SHARD_ADAM_BAND = 100       # times AdamW's eps
SHARD_BF16_RTOL = 1e-2
# sharded checkpoint: hymba's 2 x 2 cell saves (params, opt) after step
# SHARD_CKPT_STEP of its SHARD_STEPS, restores it onto the same mesh (every
# shard bit for bit) and runs the next step from the file (its loss within
# SHARD_BF16_RTOL of the uninterrupted one); the float32 gate at
# SHARD_CHECK_LAYERS layers, SHARD_CKPT_ROWS x SHARD_CHECK_SEQ tokens: a
# save after one step on 2 x 2, the second step resumed on each mesh of
# SHARD_CKPT_TARGETS (None: one device) against the uninterrupted second
# step on 2 x 2 at SHARD_LOSS_TOL / SHARD_PARAM_TOL
SHARD_CKPT_STEP, SHARD_CKPT_ROWS = 2, 4
SHARD_CKPT_TARGETS = ((4, 1), None)
# sharded serving path: the serving cell on SHARD_MESHES at full width and
# depth; its float32 gate at 2 layers, 2 x 512 tokens and 4 decode steps
# against the single-device run at tests/test_torch_lm.py's TOL
SERVE_CHECK_STEPS = 4
SERVE_TOL = dict(rtol=2e-4, atol=2e-4)
# the dp-only path: smollm-135m (134.5 M parameters, too small to
# amortise tensor parallelism) at full width and depth under
# parallel_policy="dp_only" on a 2 x 4 (data, model) mesh of cuda:0, the
# batch over both axes: 8 data groups of one position, every weight
# replicated but the tied table (vocab over the model axis's 4).  Its
# float32 gates at 2 layers with 8 x 512 tokens (a row a group), at the
# reference tests' tolerances; 3 bf16 AdamW steps of 8 groups x 2 x 2048
# tokens, zero1 (over all 8 positions); the serving cell through the
# sharded ServeEngine, waves of 8 (a row a group), beside the
# single-device engine's
DP_ONLY_ARCH, DP_ONLY_MESH = "smollm-135m", (2, 4)
# the seq_parallel variant of hymba's sharded2x2-8layers cell: the
# residual stream split by sequence over the model axis between the layers
# (training only, as in the reference), the same float32 gate, steps and
# report, beside the non-SP cell's
# the dry-run phase: five cells of the single-pod mesh (smollm train_4k
# under dp-only too), one process each, all at once; the phase's bound
DRYRUN_CELLS = (("hymba-1.5b", "decode_32k", ()),
                ("hymba-1.5b", "long_500k", ()),
                ("granite-moe-3b-a800m", "prefill_32k", ()),
                ("smollm-135m", "train_4k", ()),
                ("smollm-135m", "train_4k", ("parallel_policy=dp_only",)))
DRYRUN_LIMIT_S = 90.0
# long-grid cell: the Wiener velocity model with a time-varying noise
# Q(t) = Q (1 + 0.5 sin t) (Q stays singular: eigh and pinv), float64, one
# record of LONG_BLOCKS x NSUB intervals at the estimation cell's step
# (past the ~31000 4 x 4 matrices cuSOLVER's batched eigh takes in one
# call) and RECORDS stacked records of the estimation cell's grid; the
# chunked square roots within LONG_SQRT_RTOL (normwise) of the CPU's, the
# kernel path within 1e-8 of parallel_rts, and each grid factorisation
# timed at the chunk sizes of FACTOR_SWEEP (None: the whole grid in one
# call)
LONG_BLOCKS = 16384
LONG_SQRT_RTOL = 1e-12
FACTOR_SWEEP = (8192, 16384, 32768, 65536, 131071, None)
# the matrix sizes at which the largest batch cuSOLVER's batched eigh
# accepts is probed (the port's state sizes are 1..8); EIGH_CHUNK must
# stay within it at each
EIGH_PROBE_N = (2, 4, 8, 32)
# the collector phase: with Python's cyclic garbage collector disabled,
# one Wiener single solve (a private executable cache) and one prefill
# plus decode of COLLECT_ARCH at full width and depth (bf16, a wave of
# COLLECT_BATCH x LM_PROMPT prompts, COLLECT_NEW new tokens): the card's
# allocated bytes back to where they were once the results are deleted,
# and no tensor among what the collector then finds
COLLECT_ARCH, COLLECT_BATCH, COLLECT_NEW = "smollm-135m", 8, 4
# the single-device serving phases' numbers, for the sharded ones
SERVED = {}
# the sharded training phases' step ms and collective logs, by cell
SHARDED = {}
# name fragments of the port's kernels in a profiler trace
PORT_KERNELS = ("flash_attn", "ssd_", "lqt_combine", "lqt_scan")


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str):
    torch.cuda.synchronize()
    log(f"== {name} (at {time.perf_counter() - _STARTED:.1f} s)")


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    global _CARD
    if _CARD is None:
        _CARD = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    return _CARD


_CARD = None
_STARTED = time.perf_counter()


def random_pairs(nx, B, dtype, g):
    """Lane-major operand 5-tuples ``(nx, nx, B)``/``(nx, B)`` with PSD
    C and J (every Gauss-Jordan pivot >= 1)."""
    dev = "cuda"

    def r(*s):
        return torch.randn(*s, generator=g, device=dev, dtype=torch.float64)

    def psd():
        A = r(B, nx, nx)
        return (A @ A.transpose(-1, -2) / nx
                + 0.1 * torch.eye(nx, device=dev, dtype=torch.float64))

    def side():
        A, b, C, e, J = r(B, nx, nx) * 0.6, r(B, nx), psd(), r(B, nx), psd()
        return tuple(x.to(dtype).contiguous() for x in (
            A.permute(1, 2, 0), b.T, C.permute(1, 2, 0), e.T,
            J.permute(1, 2, 0)))

    return side(), side()


def random_elems(n, R, nx, dtype, g):
    """Natural-layout elements ``(n, nx, nx)`` (R = 1) or ``(n, R, nx, nx)``
    with PSD C and J."""
    sh = (n,) if R == 1 else (n, R)

    def r(*s):
        return torch.randn(*s, generator=g, device="cuda", dtype=torch.float64)

    def psd():
        A = r(*sh, nx, nx)
        return (A @ A.transpose(-1, -2) / nx
                + 0.1 * torch.eye(nx, device="cuda", dtype=torch.float64))

    from repro_torch.core.types import LQTElement
    return LQTElement(*(x.to(dtype) for x in (
        r(*sh, nx, nx) * 0.6, r(*sh, nx), psd(), r(*sh, nx), psd())))


def compare(got, want):
    """(max abs error, normwise relative error) over the output tuple."""
    abs_err = max(float((a.double() - b.double()).abs().max()) for a, b in
                  zip(got, want))
    scale = max(float(b.double().abs().max()) for b in want)
    return abs_err, abs_err / max(scale, 1e-300)


def combine_flops(nx: int) -> int:
    """Floating-point operations of one eq.-(42) combine in the kernel."""
    mm, mv = 2 * nx ** 3 - nx ** 2, 2 * nx ** 2 - nx
    gauss_jordan = nx * (1 + 2 * nx + (nx - 1) * 4 * nx)
    return (9 * mm + 6 * mv + gauss_jordan
            + nx + 2 * nx + 3 * nx + 2 * 3 * nx ** 2)


def combine_bytes(nx: int, itemsize: int) -> int:
    """Each input read once, each output written once, per pair."""
    values = 2 * (3 * nx * nx + 2 * nx) + (3 * nx * nx + 2 * nx)
    return values * itemsize


def scan_bytes(n: int, R: int, nx: int, itemsize: int) -> int:
    """A whole scan: each input element read once, each output written
    once."""
    return 2 * n * R * (3 * nx * nx + 2 * nx) * itemsize


def cuda_time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back runs, by CUDA
    events around one replay of a CUDA graph that holds the ``reps`` runs:
    the launches follow each other without the host's per-call cost, so
    this is the card's time even where one call's host work outlasts its
    kernel."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()                                            # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def scan_time_ms(fn, reps: int) -> tuple:
    """``(ms, method)``: the graph-replay time of ``fn`` where a CUDA graph
    can capture it (``"graph"``), else CUDA events around back-to-back eager
    calls (``"eager"``, host launch cost included), with a line saying why."""
    try:
        return graph_time_ms(fn, reps), "graph"
    except Exception as exc:               # capture refused on this CUDA
        torch.cuda.synchronize()
        log(f"  CUDA-graph capture refused ({type(exc).__name__}: "
            f"{str(exc)[:120]}); timing eager calls")
        return cuda_time_ms(fn, reps), "eager"


def device_time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs: the summed self
    time of the CUDA kernels it ran, from ``torch.profiler``.  Where the
    profiler records no device time, the CUDA-event time of the same runs
    stands in (it includes host launch overhead) and a line says so."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in device_ops(prof))
    if total <= 0:
        log("  torch.profiler recorded no device time; using CUDA events")
        return cuda_time_ms(fn, reps)
    return total / 1e3 / reps


def device_ops(prof) -> list:
    """The device operations of a profile's ``key_averages()``: kernels,
    copies and fills.  A ``record_function`` range (every ``trace_span``
    and ``trace_range`` of the port while a profiler records) also shows
    on the device timeline, as a user annotation whose device time is its
    whole elapsed span; it is left out."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def kernel_name(key: str) -> str:
    """A port kernel's name (with template arguments) in a trace key."""
    m = re.search(r"\w*(?:%s)\w*(?:<[^>]*>)?" % "|".join(PORT_KERNELS), key)
    return m.group(0) if m else key[:60]


def profile_summary(label: str, fn, wall_ms: float,
                    share_of: str | None = None) -> float:
    """One profiled call: device kernels, busy time against ``wall_ms``
    (the call's CUDA-event time without the profiler), top kernels, and
    with ``share_of`` the device time of the kernels launched inside the
    ``record_function`` ranges of that name.  Returns the busy ms."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = device_ops(prof)
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    count = sum(e.count for e in kern)
    log(f"  {label}: {count} device kernels, device busy {busy:.3f} ms of "
        f"a {wall_ms:.3f} ms call (idle share "
        f"{max(0.0, 1 - busy / wall_ms):.3f})")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms  "
            f"x{e.count:<5d} {e.key[:90]}")
    if share_of is not None:
        ranges = [e for e in prof.events() if e.name == share_of
                  and e.device_type == torch.autograd.DeviceType.CPU]
        t = sum(e.device_time_total for e in ranges) / 1e3
        log(f"    {len(ranges)} {share_of} ranges: {t:.3f} ms of device "
            f"time, {t / busy:.3f} of busy")
    ours = [e for e in kern if any(n in e.key for n in PORT_KERNELS)]
    if ours:
        t = sum(e.self_device_time_total for e in ours) / 1e3
        log(f"    the port's kernels: {t:.3f} ms ({t / busy:.3f} of busy): "
            + ", ".join(f"{kernel_name(e.key)} x{e.count} "
                        f"{e.self_device_time_total / 1e3:.3f} ms"
                        for e in ours))
    return busy


def scan_lane_counts(n: int, records: int) -> list:
    """Lane count of every combine the kernel scan launches for ``n`` scan
    elements of ``records`` records (the same tree the kernel scan in ``ops.py`` runs)."""
    from repro_torch.core.pscan import associative_scan

    counts = []

    def fn(a, b):
        counts.append(a[0].shape[-1] * records)
        return a

    associative_scan(fn, (torch.zeros(n),), axis=-1)
    return counts


def bound(nbytes: float, flops: float, dtype) -> tuple:
    """(bound ms, "bytes" or "operations") on an H100 SXM."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    f_ms = flops / PEAK_FLOPS[dtype] * 1e3
    return max(b_ms, f_ms), ("bytes" if b_ms >= f_ms else "operations")


# ---------------------------------------------------------------------------
# 1. build
# ---------------------------------------------------------------------------

def cuobjdump() -> str | None:
    """The toolkit's ``cuobjdump``, or None."""
    import shutil

    from torch.utils.cpp_extension import CUDA_HOME

    tool = Path(CUDA_HOME or "/nonexistent") / "bin" / "cuobjdump"
    return str(tool) if tool.exists() else shutil.which("cuobjdump")


def tensor_core_counts(library: str) -> dict | None:
    """``HMMA``/``HGMMA`` instructions in a library's SASS, or None without
    ``cuobjdump``."""
    tool = cuobjdump()
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", library], capture_output=True,
                          text=True, check=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass))
            for op in ("HMMA", "HGMMA")}


def build_all(jobs: dict) -> None:
    """One ``nvcc`` per source, all started together.  ``jobs`` maps a
    label to a function that builds one library; labels ending in ``mma``
    are the tensor-core kernels, whose SASS must hold HMMA or HGMMA."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        futures = {name: ex.submit(fn) for name, fn in jobs.items()}
        infos = {name: f.result() for name, f in futures.items()}
    log(f"built {len(infos)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s wall")
    for name, info in infos.items():
        log(f"{name}: built in {info['seconds']:.1f} s "
            f"(cached={info['cached']}) -> {info['library']}")
        if not info["ptxas"]:
            raise AssertionError(f"{name}: ptxas reported no kernel")
        for row in info["ptxas"]:
            inst = " ".join(f"{k}={v}" for k, v in row.items()
                            if k not in ("registers", "spill_stores",
                                         "spill_loads"))
            log(f"  ptxas {name} {inst}: {row.get('registers')} registers, "
                f"{row.get('spill_stores')} B spill stores, "
                f"{row.get('spill_loads')} B spill loads")
        if name.endswith("mma"):
            counts = tensor_core_counts(info["library"])
            if counts is None:
                log(f"  {name}: no cuobjdump in this toolkit; the source "
                    f"issues mma.sync.m16n8k16 (ptxas compiled it above)")
            else:
                log(f"  {name} SASS: {counts['HMMA']} HMMA, "
                    f"{counts['HGMMA']} HGMMA instructions")
                if counts["HMMA"] + counts["HGMMA"] == 0:
                    raise AssertionError(f"{name}: no tensor-core "
                                         f"instruction in the SASS")


# ---------------------------------------------------------------------------
# 2. kernels vs plain versions
# ---------------------------------------------------------------------------

def check_lqt(g, lqt_kernel, lqt_ref) -> None:
    from repro_torch.core import suffix_scan
    from repro_torch.core.combine import lqt_combine
    from repro_torch.core.types import LQTElement
    from repro_torch.kernels.lqt_combine.ops import kernel_suffix_scan

    for dtype in (torch.float32, torch.float64):
        for nx in (2, 4, 5, 8):
            for B in (1, 7, 4097, 2 ** 20):
                ops1, ops2 = random_pairs(nx, B, dtype, g)
                got = lqt_kernel.lqt_combine_lanes(ops1, ops2)
                want = lqt_ref.lqt_combine_lanes_ref(ops1, ops2)
                torch.cuda.synchronize()
                abs_err, rel_err = compare(got, want)
                ok = rel_err < KERNEL_RTOL[dtype]
                log(f"  lqt_combine {str(dtype)[6:]} nx={nx} B={B}: "
                    f"max abs err {abs_err:.3e}, normwise rel err "
                    f"{rel_err:.3e} (tol {KERNEL_RTOL[dtype]:.0e}) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(
                        f"lqt_combine kernel disagrees with its plain "
                        f"version: {dtype} nx={nx} B={B}")
                del ops1, ops2, got, want
    torch.cuda.empty_cache()

    n_elems = N_BLOCKS + 1
    e = random_pairs(4, n_elems, torch.float64, g)[0]
    elems = LQTElement(e[0].permute(2, 0, 1), e[1].T, e[2].permute(2, 0, 1),
                       e[3].T, e[4].permute(2, 0, 1))
    got = kernel_suffix_scan(elems)
    want = suffix_scan(lqt_combine, elems)
    torch.cuda.synchronize()
    abs_err, rel_err = compare(got, want)
    log(f"  kernel_suffix_scan vs plain suffix_scan, {n_elems} elements "
        f"nx=4 float64: max abs err {abs_err:.3e}, normwise rel err "
        f"{rel_err:.3e} (tol 1e-9)")
    if not rel_err < 1e-9:
        raise AssertionError("kernel_suffix_scan disagrees with suffix_scan")


def check_scan(g, lqt_scan, lqt_ref) -> None:
    """The scan kernel against the plain scan (the same tree in the kernel's
    schedule, pivoted solves), one launch per call."""
    for dtype in (torch.float64, torch.float32):
        for nx in range(1, 9):
            for n in SCAN_CHECK_N[nx in PATH_NX]:
                worst, cases = 0.0, 0
                for R in (1, RECORDS):
                    for rev in (False, True):
                        e = random_elems(n, R, nx, dtype, g)
                        before = lqt_scan.launch_count()
                        got = lqt_scan.lqt_scan(e, reverse=rev)
                        launched = lqt_scan.launch_count() - before
                        want = lqt_ref.lqt_scan_ref(e, reverse=rev)
                        torch.cuda.synchronize()
                        _, rel = compare(got, want)
                        finite = all(bool(torch.isfinite(x).all())
                                     for x in got)
                        if not (launched == 1 and finite
                                and rel < SCAN_RTOL[dtype]):
                            raise AssertionError(
                                f"lqt_scan {dtype} nx={nx} n={n} R={R} "
                                f"rev={rev}: {launched} launches, normwise "
                                f"rel err {rel:.3e}, finite {finite}")
                        worst, cases = max(worst, rel), cases + 1
                        del e, got, want
                log(f"  lqt_scan {str(dtype)[6:]} nx={nx} n={n}: {cases} cases"
                    f" (records 1 and {RECORDS}, both directions), one launch "
                    f"each, worst normwise rel err {worst:.3e} (tol "
                    f"{SCAN_RTOL[dtype]:.0e}) ok")
    torch.cuda.empty_cache()



def check_wide(g, lqt_scan, lqt_ref) -> None:
    """The wide kernel against the plain scan at l96-batch64's scan (513
    elements x 64 records, nx = 40, both directions, float64 and
    float32: ``wide_launches(513)`` launches, none of the register
    kernel), and its pairwise entry against the plain combine at a block
    fold's step (32768 pairs: substeps 0 and 1 of 512 blocks x 64
    records, read in place from strided views), one launch."""
    from repro_torch.core.types import LQTElement

    n, nx = L96_BLOCKS + 1, L96_NX
    for dtype in (torch.float64, torch.float32):
        for rev in (False, True):
            e = random_elems(n, RECORDS, nx, dtype, g)
            before = lqt_scan.wide_launch_count(), lqt_scan.launch_count()
            got = lqt_scan.lqt_scan_wide(e, reverse=rev)
            launched = (lqt_scan.wide_launch_count() - before[0],
                        lqt_scan.launch_count() - before[1])
            want = lqt_ref.lqt_scan_ref(e, reverse=rev)
            torch.cuda.synchronize()
            _, rel = compare(got, want)
            finite = all(bool(torch.isfinite(x).all()) for x in got)
            ok = (launched == (lqt_scan.wide_launches(n), 0) and finite
                  and rel < SCAN_RTOL[dtype])
            log(f"  lqt_scan_wide {str(dtype)[6:]} nx={nx} n={n} "
                f"R={RECORDS} reverse={rev}: {launched[0]} launches "
                f"(lqt_scan {launched[1]}), normwise rel err {rel:.3e} "
                f"(tol {SCAN_RTOL[dtype]:.0e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(
                    f"lqt_scan_wide {dtype} reverse={rev}: launches "
                    f"{launched}, rel err {rel:.3e}, finite {finite}")
            del e, got, want
        sub = random_elems(L96_BLOCKS, RECORDS * 2, nx, dtype, g)
        sub = LQTElement(*(x.reshape((L96_BLOCKS, RECORDS, 2) + x.shape[2:])
                           for x in sub))
        a, b = (LQTElement(*(x[:, :, l] for x in sub)) for l in (0, 1))
        before = lqt_scan.pair_launch_count()
        got = lqt_scan.lqt_combine_wide(a, b)
        launched = lqt_scan.pair_launch_count() - before
        want = lqt_ref.lqt_combine_ref(*a, *b)
        torch.cuda.synchronize()
        _, rel = compare(got, want)
        ok = launched == 1 and rel < KERNEL_RTOL[dtype]
        log(f"  lqt_combine_wide {str(dtype)[6:]} nx={nx} "
            f"{L96_BLOCKS * RECORDS} pairs: {launched} launch, normwise rel "
            f"err {rel:.3e} (tol {KERNEL_RTOL[dtype]:.0e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"lqt_combine_wide {dtype}: {launched} "
                                 f"launches, rel err {rel:.3e}")
        del sub, a, b, got, want
    torch.cuda.empty_cache()


def lorenz96_path(lqt_kernel, lqt_scan) -> dict:
    """One wave of l96-batch64: 64 Lorenz-96 records of 5120 intervals
    (``simulate_nonlinear`` on the card) through
    ``TrajectoryEngine(batch=64, method="parallel_kernel")`` with the
    configuration's options, after a warm wave, with every launch counter
    zeroed just before it: ``wide_launches(513)`` wide-kernel launches a
    pass, the in-block steps' pairwise launches (nsub - 1 folds, nsub
    value steps and the recovery's maps a pass), no ``lqt_scan`` or
    ``lqt_combine`` launch, the telemetry counters alike; four records
    against ``parallel_rts`` with the core's steps on the card."""
    from repro_torch import obs
    from repro_torch.configs import lorenz96
    from repro_torch.core import (
        Estimator,
        IteratedOptions,
        KernelOptions,
        ParallelOptions,
        Problem,
        simulate_nonlinear,
        time_grid,
    )
    from repro_torch.serving import TrajectoryEngine

    cfg = lorenz96.config()
    model = cfg.model(device="cuda")
    N = L96_BLOCKS * cfg.nsub
    ts = time_grid(cfg.t0, cfg.tf, N, dtype=torch.float64, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    _, y = simulate_nonlinear(model, ts[:, None].expand(-1, RECORDS), gen)
    host = [(ts.cpu().numpy(), y[:, i].cpu().numpy()) for i in range(RECORDS)]

    def opts(inner):
        return IteratedOptions(inner=inner(nsub=cfg.nsub, mode="discrete"),
                               iterations=cfg.iterations)

    eng = TrajectoryEngine(model, batch=RECORDS, method="parallel_kernel",
                           options=opts(KernelOptions))

    def wave():
        tickets = [eng.submit(t, yi) for t, yi in host]
        eng.run()
        torch.cuda.synchronize()
        return tickets

    t0 = time.perf_counter()
    wave()
    warm_s = time.perf_counter() - t0
    for reset in (lqt_kernel.reset_launch_count, lqt_scan.reset_launch_count,
                  lqt_scan.reset_wide_launch_count,
                  lqt_scan.reset_pair_launch_count):
        reset()
    obs.reset()
    obs.enable()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tickets = wave()
    wave_s = time.perf_counter() - t0
    counters = obs.snapshot()["counters"]
    obs.disable()
    got = dict(eng.collect(tickets=tickets))
    passes, T = cfg.iterations, L96_BLOCKS
    want = {"wide": passes * lqt_scan.wide_launches(T + 1),
            "pairs": passes * 2 * cfg.nsub, "lqt_scan": 0, "lqt_combine": 0}
    counts = {"wide": lqt_scan.wide_launch_count(),
              "pairs": lqt_scan.pair_launch_count(),
              "lqt_scan": lqt_scan.launch_count(),
              "lqt_combine": lqt_kernel.launch_count()}
    telemetry = (counters.get("scan.kernel.wide", 0),
                 counters.get("scan.kernel.regs", 0))
    log(f"Lorenz-96 (N = 40), {RECORDS} records x {N} intervals, "
        f"{passes} passes, TrajectoryEngine(batch={RECORDS}, "
        f"'parallel_kernel', discrete, float64) on {card()}: warm wave "
        f"{warm_s:.2f} s, counted wave {wave_s:.2f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
        f"{counts} (want {want}); counters scan.kernel.wide / .regs "
        f"{telemetry}")
    if counts != want or telemetry != (want["wide"], 0):
        raise AssertionError(f"Lorenz-96 wave: launches {counts}, counters "
                             f"{telemetry}; want {want}")
    xs = torch.stack([got[t].x for t in tickets[:4]])
    ref = Estimator(model, method="parallel_rts",
                    options=opts(ParallelOptions)).solve(
        Problem.stacked(model, ts, y[:, :4].movedim(1, 0))).x
    gap = float((xs - ref).abs().max() / ref.abs().max())
    ok = bool(torch.isfinite(xs).all()) and gap < NL_KERNEL_TOL
    log(f"  four records, engine (the wide kernel) vs Estimator "
        f"parallel_rts (the core's steps): normwise gap {gap:.3e} (tol "
        f"{NL_KERNEL_TOL:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"Lorenz-96 wave: gap {gap:.3e} to "
                             f"parallel_rts")
    del eng, got, xs, ref, y
    torch.cuda.empty_cache()
    return {"wave_s": wave_s, "scans": passes, "launches": counts["wide"],
            "pairs": counts["pairs"], "fold_steps": passes * (2 * cfg.nsub - 1),
            "map_steps": passes}


def wide_timing(g, lqt_scan, lqt_ref, wave: dict) -> list:
    """The report rows of ``lqt_scan_wide`` and ``lqt_combine_wide`` at a
    Lorenz-96 wave's launches (CUDA events around a CUDA-graph replay, or
    eager calls where capture is refused), beside the plain scan and
    combine and each kernel's bound from its inputs: the scan summed over
    the wave's scans, the pairwise entry over its fold and value steps
    (32768 pairs each; the recovery's maps, one launch a pass over every
    point, are not timed)."""
    from repro_torch.core.types import LQTElement

    n, nx, R = L96_BLOCKS + 1, L96_NX, RECORDS
    e = random_elems(n, R, nx, torch.float64, g)
    err = compare(lqt_scan.lqt_scan_wide(e, reverse=True),
                  lqt_ref.lqt_scan_ref(e, reverse=True))[0]
    ms, how = scan_time_ms(lambda: lqt_scan.lqt_scan_wide(e, reverse=True), 5)
    eager = cuda_time_ms(lambda: lqt_scan.lqt_scan_wide(e, reverse=True), 5)
    plain = cuda_time_ms(lambda: lqt_ref.lqt_scan_ref(e, reverse=True), 3)
    combines = sum(scan_lane_counts(n, R))
    nbytes, flops = scan_bytes(n, R, nx, 8), combines * combine_flops(nx)
    b_ms, b_by = bound(nbytes, flops, torch.float64)
    log(f"  lqt_scan_wide, a scan of {n} elements x {R} records (nx={nx}, "
        f"float64, {combines} combines, {lqt_scan.wide_launches(n)} "
        f"launches): {ms:.3f} ms ({how}; eager calls {eager:.3f} ms), plain "
        f"scan {plain:.3f} ms, bound {b_ms:.4f} ms ({b_by}: "
        f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), {b_ms / ms:.4f} "
        f"of the bound; x{wave['scans']} a wave")
    k = wave["scans"]
    rows = [{"name": "lqt_scan_wide", "route": "cuda",
             "source": "src/repro_torch/kernels/lqt_combine/csrc/"
                       "lqt_scan_wide.cu",
             "replaces": "src/repro/kernels/lqt_combine/kernel.py:115",
             "launches": wave["launches"], "max_abs_err": err,
             "ms": k * ms, "eager_ms": k * eager, "plain_ms": k * plain,
             "bound_ms": k * b_ms, "bound_by": b_by, "library_ms": None,
             "timing": how, "per_scan_ms": ms, "per_scan_plain_ms": plain,
             "per_scan_bound_ms": b_ms,
             "note": f"a Lorenz-96 wave's {k} scans of {n} x {R} at nx {nx}"}]
    del e
    sub = random_elems(L96_BLOCKS, R * 2, nx, torch.float64, g)
    sub = LQTElement(*(x.reshape((L96_BLOCKS, R, 2) + x.shape[2:])
                       for x in sub))
    a, b = (LQTElement(*(x[:, :, l] for x in sub)) for l in (0, 1))
    B = L96_BLOCKS * R
    err = compare(lqt_scan.lqt_combine_wide(a, b),
                  lqt_ref.lqt_combine_ref(*a, *b))[0]
    ms, how = scan_time_ms(lambda: lqt_scan.lqt_combine_wide(a, b), 10)
    eager = cuda_time_ms(lambda: lqt_scan.lqt_combine_wide(a, b), 10)
    plain = cuda_time_ms(lambda: lqt_ref.lqt_combine_ref(*a, *b), 3)
    nbytes, flops = B * combine_bytes(nx, 8), B * combine_flops(nx)
    b_ms, b_by = bound(nbytes, flops, torch.float64)
    steps = wave["pairs"] - wave["map_steps"]
    log(f"  lqt_combine_wide, a fold step of {B} pairs (nx={nx}, float64): "
        f"{ms:.3f} ms ({how}; eager calls {eager:.3f} ms), plain combine "
        f"{plain:.3f} ms, bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} "
        f"MB, {flops / 1e9:.2f} GFLOP), {b_ms / ms:.4f} of the bound; "
        f"x{steps} a wave (folds and value steps)")
    rows.append({"name": "lqt_combine_wide", "route": "cuda",
                 "source": "src/repro_torch/kernels/lqt_combine/csrc/"
                           "lqt_scan_wide.cu",
                 "replaces": "src/repro/kernels/lqt_combine/kernel.py:115",
                 "launches": wave["pairs"], "max_abs_err": err,
                 "ms": steps * ms, "eager_ms": steps * eager,
                 "plain_ms": steps * plain, "bound_ms": steps * b_ms,
                 "bound_by": b_by, "library_ms": None, "timing": how,
                 "per_launch_ms": ms, "per_launch_plain_ms": plain,
                 "per_launch_bound_ms": b_ms,
                 "note": f"a Lorenz-96 wave's {steps} fold and value steps "
                         f"of {B} pairs at nx {nx}; its {wave['map_steps']} "
                         f"recovery-map launches are not timed"})
    del sub, a, b
    torch.cuda.empty_cache()
    return rows


# (B, Hq, Hkv, Lq, Lk, D, causal, window): the reference's five test cases,
# two ragged-edge cases, hymba-1.5b's prefill (batch 8) and training
# microbatch (batch 4), granite-moe-3b's (the same batches), the zoo's
# prefill waves of 2 x 2048 (smollm 9/3 heads; qwen3 and phi3.5 32/8 at
# D = 128; danube 32/8 at D = 80 with its 4096 window; starcoder2 48/4 at
# D = 128) and hubert's non-causal MHA at D = 80, granite's head-local
# shard on a model axis of 4 (6/2 heads, a data shard of 2 x 2048), and
# two ragged-edge cases at D = 80, in both dtypes; then
# bfloat16 cases for the tensor-core kernel's tiling: D in {16, 32, 80,
# 128}, Lq < Lk (decode alignment), Lq and Lk off the 64-row tiles, windows
# off the tiles, and no causal mask.
FA_CASES = [
    (2, 4, 2, 64, 64, 16, True, None),
    (1, 6, 2, 32, 32, 32, True, 24),
    (2, 4, 4, 16, 64, 16, True, None),
    (1, 2, 1, 64, 64, 8, False, None),
    (1, 8, 1, 128, 128, 16, True, 32),
    (1, 4, 2, 100, 300, 128, True, None),
    (1, 4, 2, 200, 200, 64, True, 70),
    (8, 25, 5, 2048, 2048, 64, True, 1024),
    (4, 25, 5, 2048, 2048, 64, True, 1024),
    (2, 25, 5, 2048, 2048, 64, True, 1024),
    (8, 24, 8, 2048, 2048, 64, True, None),
    (4, 24, 8, 2048, 2048, 64, True, None),
    (2, 9, 3, 2048, 2048, 64, True, None),
    (8, 9, 3, 2048, 2048, 64, True, None),
    (1, 9, 3, 2048, 2048, 64, True, None),
    (2, 32, 8, 2048, 2048, 128, True, None),
    (2, 32, 8, 2048, 2048, 80, True, 4096),
    (2, 48, 4, 2048, 2048, 128, True, None),
    (2, 16, 16, 2048, 2048, 80, False, None),
    (2, 6, 2, 2048, 2048, 64, True, None),
    (4, 6, 2, 2048, 2048, 64, True, None),
    (1, 4, 2, 100, 300, 80, True, None),
    (1, 6, 2, 200, 200, 80, True, 70),
]
FA_MMA_CASES = [
    (2, 4, 2, 128, 128, 16, True, None),
    (1, 6, 2, 96, 160, 32, True, 40),
    (2, 8, 2, 100, 300, 128, True, 70),
    (1, 4, 1, 1, 300, 64, True, None),
    (3, 4, 2, 7, 1000, 64, True, 130),
    (1, 25, 5, 200, 200, 64, True, 100),
    (1, 4, 2, 80, 130, 32, False, None),
    (1, 4, 2, 64, 200, 128, False, 50),
    (1, 4, 1, 1, 300, 80, True, None),
    (3, 4, 2, 7, 1000, 80, True, 130),
    (1, 4, 4, 80, 130, 80, False, None),
]
# (BH, L, P, S, chunk): the reference's four test shapes (heads folded in),
# two more, hymba-1.5b's prefill (8 x 50 heads), training microbatch
# (4 x 50 heads) and pipeline / data-parallel shard (2 x 50 heads), and
# mamba2-370m's prefill wave in the zoo (2 x 32 heads, state 128), in both
# dtypes; then
# bfloat16 cases for the chunk-parallel kernel's tiling: S in {8, 64, 128},
# P in {16, 128}, chunks of 64, 100 and 256.
SSD_CASES = [
    (8, 64, 16, 8, 16),
    (6, 48, 32, 16, 16),
    (4, 40, 8, 4, 8),
    (2, 128, 64, 64, 64),
    (4, 512, 128, 128, 256),
    (3, 300, 64, 16, 100),
    (400, 2048, 64, 16, 256),
    (200, 2048, 64, 16, 256),
    (100, 2048, 64, 16, 256),
    (64, 2048, 64, 128, 256),
]
SSD_MMA_CASES = [
    (4, 512, 16, 8, 256),
    (3, 300, 128, 64, 100),
    (2, 256, 128, 128, 64),
    (5, 200, 16, 128, 100),
    (6, 768, 128, 8, 256),
    (3, 512, 16, 64, 64),
]
# stage-2 chunk states of the tensor-core SSD kernel against the staged
# plain version, max abs error over max |state|: float32 scans of states
# whose increments carry the 2^-16 hi/lo split of exp(total - cum) dtx.
SSD_STATE_TOL = 1e-4


def fa_inputs(case, dtype, g):
    B, Hq, Hkv, Lq, Lk, D, _, _ = case
    return tuple(torch.randn(s, generator=g, device="cuda").to(dtype)
                 for s in ((B, Hq, Lq, D), (B, Hkv, Lk, D), (B, Hkv, Lk, D)))


def ssd_inputs(case, dtype, g):
    BH, L, P, S, _ = case
    l = -torch.rand(BH, L, generator=g, device="cuda") * 0.2
    return (l,) + tuple(
        torch.randn(s, generator=g, device="cuda").to(dtype)
        for s in ((BH, L, P), (BH, L, S), (BH, L, S)))


def launched(kernel, call) -> tuple:
    """``(result, variant)``: ``call()``'s result and the one variant whose
    launch count it moved (it must move exactly one, by one)."""
    before = {v: kernel.launch_count(v) for v in kernel.VARIANTS}
    out = call()
    moved = [v for v in kernel.VARIANTS
             if kernel.launch_count(v) != before[v]]
    if len(moved) != 1 or kernel.launch_count(moved[0]) != (
            before[moved[0]] + 1):
        after = {v: kernel.launch_count(v) for v in before}
        raise AssertionError(f"{kernel.__name__}: one call moved the "
                             f"launch counts {before} -> {after}")
    return out, moved[0]


def check_fa(g, fa_kernel, fa_ref) -> dict:
    """Returns ``{case: max abs error}`` of the bfloat16 cases."""
    errs_bf16 = {}
    cases = ([(dtype, c) for dtype in (torch.float32, torch.bfloat16)
              for c in FA_CASES]
             + [(torch.bfloat16, c) for c in FA_MMA_CASES])
    for dtype, case in cases:
        causal, window = case[6], case[7]
        q, k, v = fa_inputs(case, dtype, g)
        got, which = launched(fa_kernel, lambda: fa_kernel.flash_attention(
            q, k, v, causal=causal, window=window))
        if which != fa_kernel.variant(dtype, case[5]):
            raise AssertionError(f"flash_attention {dtype} {case} ran "
                                 f"{which}, the rule names "
                                 f"{fa_kernel.variant(dtype, case[5])}")
        want = fa_ref.mha_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        tol = FA_TOL[dtype]
        err = float((got.float() - want.float()).abs().max())
        rel = err / max(float(want.float().abs().max()), 1e-30)
        ok = bool(torch.allclose(got.float(), want.float(), rtol=tol,
                                 atol=tol))
        log(f"  flash_attention {which} {str(dtype)[6:]} {case}: max abs err "
            f"{err:.3e}, rel {rel:.3e} (allclose rtol=atol={tol:.0e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_attention kernel disagrees with "
                                 f"its plain version: {dtype} {case}")
        if dtype == torch.bfloat16:
            errs_bf16[case] = err
        del q, k, v, got, want
    torch.cuda.empty_cache()
    return errs_bf16


def check_ssd(g, ssd_kernel, ssd_ref) -> dict:
    """Returns ``{case: max abs error}`` of the bfloat16 cases."""
    errs_bf16 = {}
    cases = ([(dtype, c) for dtype in (torch.float32, torch.bfloat16)
              for c in SSD_CASES]
             + [(torch.bfloat16, c) for c in SSD_MMA_CASES])
    for dtype, case in cases:
        chunk = case[-1]
        ins = ssd_inputs(case, dtype, g)
        got, which = launched(ssd_kernel, lambda: ssd_kernel.ssd_chunked(
            *ins, chunk=chunk))
        if which != ssd_kernel.variant(dtype, case[2]):
            raise AssertionError(f"ssd_chunked {dtype} {case} ran {which}, "
                                 f"the rule names "
                                 f"{ssd_kernel.variant(dtype, case[2])}")
        want = ssd_ref.ssd_chunked_ref(*ins, chunk=chunk)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        scale = max(float(want.float().abs().max()), 1e-30)
        ok = err <= SSD_TOL[dtype] * scale
        rule = f"abs <= {SSD_TOL[dtype]:.0e} max|want|"
        states = ""
        if which == "mma":
            # the entering chunk states of stage 2, against the staged plain
            # version: a fault shows at its stage
            _, st, _ = ssd_kernel._run_mma(*ins, chunk)
            _, want_st = ssd_ref.ssd_staged_ref(*ins, chunk=chunk)
            st_err = float((st - want_st).abs().max()) / max(
                float(want_st.abs().max()), 1e-30)
            ok = ok and st_err <= SSD_STATE_TOL
            states = (f"; stage-2 states rel err {st_err:.3e} (tol "
                      f"{SSD_STATE_TOL:.0e})")
            del st, want_st
        log(f"  ssd_chunked {which} {str(dtype)[6:]} {case}: max abs err "
            f"{err:.3e}, rel {err / scale:.3e} ({rule}){states} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"ssd kernel disagrees with its plain "
                                 f"version: {dtype} {case}")
        if dtype == torch.bfloat16:
            errs_bf16[case] = err
        del ins, got, want
        torch.cuda.empty_cache()
    return errs_bf16


# ---------------------------------------------------------------------------
# 3. estimation path
# ---------------------------------------------------------------------------

def timed_solve(est, problem) -> tuple:
    """One solve and its time in ms by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    sol = est.solve(problem)
    stop.record()
    torch.cuda.synchronize()
    return sol, start.elapsed_time(stop)


def median_solve_ms(est, problem, runs: int = 5, warm_up: bool = True,
                    taken: tuple = ()) -> float:
    """Median of ``runs`` solves by CUDA events, after one warm-up (the
    caller may have made it already); ``taken`` are the times of solves
    the caller has already timed, counted among the ``runs``."""
    if warm_up:
        est.solve(problem)
    times = list(taken)
    while len(times) < runs:
        times.append(timed_solve(est, problem)[1])
    return statistics.median(times)


def estimation_path(lqt_kernel, lqt_scan) -> tuple:
    """Returns the scan kernel's launch count and scans (elements, records)
    on the path, and the launch shapes the per-level scan had; and the
    cell (model, time grid, the 64 records' measurements)."""
    from repro_torch.configs.wiener_velocity import WienerVelocityConfig
    from repro_torch.core import (
        Estimator,
        KernelOptions,
        ParallelOptions,
        Problem,
        SequentialOptions,
        simulate_linear,
        time_grid,
    )

    cfg = WienerVelocityConfig()
    model = cfg.model(dtype=torch.float64, device="cuda")
    N = N_BLOCKS * NSUB
    ts = time_grid(cfg.t0, cfg.tf, N, device="cuda")
    gm = torch.Generator(device="cuda").manual_seed(SEED)
    _, y1 = simulate_linear(model, ts, gm)                       # (N, ny)
    _, yb = simulate_linear(model, ts[:, None].expand(-1, RECORDS), gm)
    problems = {"single": Problem.single(model, ts, y1),
                "stacked64": Problem.stacked(model, ts, yb.movedim(1, 0))}
    seq_x = {}
    torch.cuda.synchronize()
    log(f"Wiener velocity, T={N_BLOCKS} blocks x nsub={NSUB} (N={N}), "
        f"float64, records: single and {RECORDS} stacked")

    kopts = KernelOptions(nsub=NSUB, mode="discrete")
    est_k = Estimator(model, method="parallel_kernel", options=kopts)
    est_p = Estimator(model, method="parallel_rts",
                      options=ParallelOptions(nsub=NSUB, mode="discrete"))
    est_s = Estimator(model, method="sequential_rts",
                      options=SequentialOptions(mode="discrete"),
                      device="cpu")

    lqt_kernel.reset_launch_count()
    lqt_scan.reset_launch_count()
    sols = {k: est_k.solve(p) for k, p in problems.items()}
    torch.cuda.synchronize()
    launches = lqt_scan.launch_count()
    log(f"main path launches: lqt_scan {launches} (one per backward scan), "
        f"lqt_combine {lqt_kernel.launch_count()}")
    if launches != len(problems) or lqt_kernel.launch_count():
        raise AssertionError(f"expected {len(problems)} lqt_scan launches "
                             f"and no lqt_combine launch on the main path, "
                             f"counted {launches} and "
                             f"{lqt_kernel.launch_count()}")

    for name, p in problems.items():
        sol = sols[name]
        for f in ("x", "S", "v", "cost"):
            t = getattr(sol, f)
            if t.device.type != "cuda" or not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{name}: {f} not finite on cuda")
        want_shape = ((N + 1, 4) if name == "single"
                      else (RECORDS, N + 1, 4))
        if tuple(sol.x.shape) != want_shape:
            raise AssertionError(f"{name}: x shape {tuple(sol.x.shape)}")
        refs = {"parallel_rts (cuda)": est_p.solve(p),
                "sequential_rts (cpu reference)": est_s.solve(p)}
        seq_x[name] = refs["sequential_rts (cpu reference)"].x
        for ref_name, ref in refs.items():
            dx = float((sol.x.cpu() - ref.x.cpu()).abs().max())
            ok = dx < 1e-8
            for f in ("S", "v"):
                a, b = getattr(sol, f).cpu(), getattr(ref, f).cpu()
                ok = ok and torch.allclose(a, b, rtol=1e-9, atol=1e-8)
            log(f"  {name}: parallel_kernel vs {ref_name}: max|dx| "
                f"{dx:.3e} (tol 1e-8), S/v within rtol 1e-9 atol 1e-8: "
                f"{ok}")
            if not ok:
                raise AssertionError(f"{name}: parallel_kernel disagrees "
                                     f"with {ref_name}")

    solve_ms = {}
    for name, p in problems.items():
        for label, est in (("parallel_kernel", est_k),
                           ("parallel_rts", est_p)):
            solve_ms[(name, label)] = median_solve_ms(est, p)
            log(f"  solve {name} {label}: median {solve_ms[(name, label)]:.3f}"
                f" ms over 5 runs (CUDA events, after one warm-up)")

    phase("estimation profile")
    for name, p in problems.items():
        profile_summary(f"{name} parallel_kernel", lambda: est_k.solve(p),
                        solve_ms[(name, "parallel_kernel")])

    shapes = (scan_lane_counts(N_BLOCKS + 1, 1)
              + scan_lane_counts(N_BLOCKS + 1, RECORDS))
    return ({"launches": launches, "shapes": shapes, "nx": 4,
             "scans": [(N_BLOCKS + 1, 1), (N_BLOCKS + 1, RECORDS)],
             "pairwise_launches": lqt_kernel.launch_count()},
            {"model": model, "ts": ts, "yb": yb, "y1": y1, "seq_x": seq_x})


# ---------------------------------------------------------------------------
# 3a. cache/AOT path: the executable cache and Estimator.lower
# ---------------------------------------------------------------------------

def same_solution(a, b) -> bool:
    """Every field of two solutions equal bit for bit."""
    for f in ("x", "S", "v", "cov", "cost"):
        x, y = getattr(a, f), getattr(b, f)
        if (x is None) != (y is None) or (
                x is not None and not torch.equal(x, y)):
            return False
    return True


def cache_path(lqt_kernel, lqt_scan, cell: dict) -> dict:
    """The estimation cell through a private ``ExecutableCache``: a fresh
    single solve and a hit, the same for stacked64, each layout's
    ``est.lower(problem).compile()`` entry called with the problem's
    tensors (bit for bit the solve's result), then the ragged cell solved
    twice (one new entry per bucket, then every bucket a hit).  Exact hit,
    miss and launch counts per step and one ``cache.compile_seconds``
    sample per fresh entry; the fresh and cached solve times.  Returns the
    scan kernel's launches and scans on the path."""
    from repro_torch import obs
    from repro_torch.core import (
        Estimator,
        ExecutableCache,
        KernelOptions,
        Problem,
        bucket_length,
    )

    model, ts = cell["model"], cell["ts"]
    problems = {"single": Problem.single(model, ts, cell["y1"]),
                "stacked64": Problem.stacked(model, ts,
                                             cell["yb"].movedim(1, 0))}
    lengths, records = ragged_records(cell)
    ragged = Problem.ragged(model, records)
    cache = ExecutableCache()
    est = Estimator(model, method="parallel_kernel", cache=cache,
                    options=KernelOptions(nsub=NSUB, mode="discrete"))
    log(f"Wiener velocity, T={N_BLOCKS} x nsub={NSUB}, float64, "
        f"parallel_kernel through a private ExecutableCache, obs enabled; "
        f"on {card()}")

    def counted(label, call, hits, misses, launches):
        """``call()`` timed by CUDA events, held to exact deltas of the
        cache's hits and misses and of the scan's launches."""
        before = (cache.hits, cache.misses, lqt_scan.launch_count())
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = call()
        stop.record()
        torch.cuda.synchronize()
        got = (cache.hits - before[0], cache.misses - before[1],
               lqt_scan.launch_count() - before[2])
        log(f"  {label}: {start.elapsed_time(stop):.3f} ms; hits +{got[0]}, "
            f"misses +{got[1]}, lqt_scan launches +{got[2]} (want "
            f"+{hits}, +{misses}, +{launches})")
        if got != (hits, misses, launches):
            raise AssertionError(f"cache path, {label}: hits/misses/launches "
                                 f"{got}, want {(hits, misses, launches)}")
        return out, start.elapsed_time(stop)

    obs.reset()
    obs.enable()
    lqt_kernel.reset_launch_count()
    lqt_scan.reset_launch_count()
    fresh_ms, scans = {}, []
    for name, p in problems.items():
        R = 1 if name == "single" else RECORDS
        sol, fresh_ms[name] = counted(f"{name}: fresh solve",
                                      lambda: est.solve(p), 0, 1, 1)
        hit, _ = counted(f"{name}: cached solve", lambda: est.solve(p),
                         1, 0, 1)
        compiled, _ = counted(f"{name}: est.lower(problem).compile()",
                              lambda: est.lower(p).compile(), 1, 0, 0)
        aot, _ = counted(f"{name}: the Compiled entry called with the "
                         f"problem's tensors",
                         lambda: compiled(p.ts, p.y), 0, 0, 1)
        ok = same_solution(aot, hit)
        log(f"  {name}: Compiled result vs solve, every field bit for bit: "
            f"{ok}; fresh vs cached solve bit for bit: "
            f"{same_solution(sol, hit)}")
        if not ok:
            raise AssertionError(f"cache path, {name}: the Compiled entry's "
                                 f"solution differs from solve's")
        scans += 3 * [(N_BLOCKS + 1, R)]
    entries = len(cache)
    n = len({bucket_length(n, NSUB) for n in lengths})
    sols, _ = counted(f"ragged64: first solve, a new entry for each of its "
                      f"{n} buckets", lambda: est.solve(ragged), 0, n, n)
    again, _ = counted("ragged64: second solve, every bucket entry a hit",
                       lambda: est.solve(ragged), n, 0, n)
    buckets = [(b.n_pad, b.batch) for b in sols[0].padding.buckets]
    log(f"  ragged64 buckets (n_pad, rows): {buckets}")
    if not all(same_solution(a, b) for a, b in zip(sols, again)):
        raise AssertionError("cache path: the ragged solve's hits differ "
                             "from its first solve")
    scans += 2 * [(n_pad // NSUB + 1, rows) for n_pad, rows in buckets]
    launches = lqt_scan.launch_count()
    snap = obs.snapshot()
    compile_s = snap["histograms"].get("cache.compile_seconds", {})
    want_fresh = len(problems) + len(buckets)
    log(f"main path launches: lqt_scan {launches}, lqt_combine "
        f"{lqt_kernel.launch_count()}; cache entries {entries} + "
        f"{len(buckets)}, hits {cache.hits}, misses {cache.misses}, "
        f"evictions {cache.evictions}; cache.compile_seconds: "
        f"{compile_s.get('count')} samples (want {want_fresh}), sum "
        f"{compile_s.get('sum', 0):.4f} s, max {compile_s.get('max', 0):.4f}"
        f" s; spans compile {snap['histograms']['span.estimator.solve.compile']['count']}"
        f", execute {snap['histograms']['span.estimator.solve.execute']['count']}")
    if (compile_s.get("count") != want_fresh or lqt_kernel.launch_count()
            or launches != len(scans) or len(cache) != want_fresh):
        raise AssertionError(
            f"cache path: compile_seconds {compile_s.get('count')} samples, "
            f"{launches} scan launches for {len(scans)} scans, "
            f"{len(cache)} entries; want {want_fresh} fresh entries")

    for name, p in problems.items():
        cached = median_solve_ms(est, p, warm_up=False)
        obs.disable()
        hot = median_solve_ms(est, p, warm_up=False)
        # a second fresh entry, on the hot path: no obs instrument is
        # created in it, unlike the first solve after obs.reset() above
        _, fresh_hot = timed_solve(Estimator(
            model, method="parallel_kernel", cache=ExecutableCache(),
            options=KernelOptions(nsub=NSUB, mode="discrete")), p)
        obs.enable()
        log(f"  {name}: fresh entry's solve {fresh_ms[name]:.3f} ms, cached "
            f"solve median {cached:.3f} ms over 5 (obs on: both spans end "
            f"with a synchronise); hot path (obs off): a fresh entry "
            f"{fresh_hot:.3f} ms, cached median {hot:.3f} ms; CUDA events, "
            f"on {card()}")
    obs.disable()
    shapes = [c for n, r in scans for c in scan_lane_counts(n, r)]
    return {"launches": launches, "shapes": shapes, "nx": 4,
            "scans": scans, "pairwise_launches": lqt_kernel.launch_count()}


# ---------------------------------------------------------------------------
# 3b. nonlinear path: the iterated smoother on the coordinated turn
# ---------------------------------------------------------------------------

def nonlinear_path(lqt_kernel, lqt_scan) -> tuple:
    """The paper's Fig.-2 cell through ``Estimator.solve``; returns the scan
    kernel's launch count and scans on the path, and the launch shapes the
    per-level scan had; and the cell (model, problems, IEKS costs)."""
    from repro_torch.configs.coordinated_turn import CoordinatedTurnConfig
    from repro_torch.core import (
        Estimator,
        IteratedOptions,
        KernelOptions,
        ParallelOptions,
        Problem,
        SequentialOptions,
        TwoFilterOptions,
        simulate_nonlinear,
        time_grid,
    )

    cfg = CoordinatedTurnConfig()
    N = NL_BLOCKS * cfg.nsub
    model = cfg.model(dtype=torch.float64, device="cuda")
    ts = time_grid(cfg.t0, cfg.tf, N, device="cuda")
    gm = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    _, y1 = simulate_nonlinear(model, ts, gm)                    # (N, ny)
    _, yb = simulate_nonlinear(model, ts[:, None].expand(-1, RECORDS), gm)
    torch.cuda.synchronize()
    log(f"coordinated turn, T={NL_BLOCKS} blocks x nsub={cfg.nsub} "
        f"(N={N}), mode={NL_MODE}, {NL_ITERS} iterations, float64, records: "
        f"single and {RECORDS} stacked; measurements simulated in "
        f"{time.perf_counter() - t0:.2f} s")
    problems = {"single": Problem.single(model, ts, y1),
                "stacked64": Problem.stacked(model, ts, yb.movedim(1, 0))}

    def est(method, inner, m=model):
        return Estimator(m, method=method, options=IteratedOptions(
            inner=inner, iterations=NL_ITERS))

    nsub = cfg.nsub
    ests = {"parallel_kernel": est("parallel_kernel",
                                   KernelOptions(nsub=nsub, mode=NL_MODE)),
            "parallel_rts": est("parallel_rts",
                                ParallelOptions(nsub=nsub, mode=NL_MODE)),
            "sequential_rts": est("sequential_rts",
                                  SequentialOptions(mode=NL_MODE))}
    est_rd = est("parallel_rts", ParallelOptions(nsub=nsub, mode="discrete"))
    est_tf = est("parallel_two_filter",
                 TwoFilterOptions(nsub=nsub, mode="discrete"))

    lqt_kernel.reset_launch_count()
    lqt_scan.reset_launch_count()
    sols = {k: ests["parallel_kernel"].solve(p) for k, p in problems.items()}
    torch.cuda.synchronize()
    launches = lqt_scan.launch_count()
    log(f"nonlinear path launches: lqt_scan {launches} (one per pass and "
        f"record layout), lqt_combine {lqt_kernel.launch_count()}")
    shapes = NL_ITERS * (scan_lane_counts(NL_BLOCKS + 1, 1)
                         + scan_lane_counts(NL_BLOCKS + 1, RECORDS))
    scans = NL_ITERS * [(NL_BLOCKS + 1, 1), (NL_BLOCKS + 1, RECORDS)]
    if launches != len(scans) or lqt_kernel.launch_count():
        raise AssertionError(f"nonlinear path: {launches} lqt_scan and "
                             f"{lqt_kernel.launch_count()} lqt_combine "
                             f"launches, expected {len(scans)} and 0")

    def max_dx(a, b):
        return float((a.x - b.x).abs().max())

    seq_gate_ms = {}
    for name, p in problems.items():
        sol = sols[name]
        lead = () if name == "single" else (RECORDS,)
        for f, shape in (("x", lead + (N + 1, 5)), ("S", lead + (N + 1, 5, 5)),
                         ("cost", lead), ("cost_trace", lead + (NL_ITERS,)),
                         ("step_norms", lead + (NL_ITERS,))):
            t = getattr(sol, f)
            if (tuple(t.shape) != shape or t.device.type != "cuda"
                    or not bool(torch.isfinite(t).all())):
                raise AssertionError(f"{name}: {f} {tuple(t.shape)} on "
                                     f"{t.device} not finite or misshapen")
        trace = sol.cost_trace
        if not (torch.equal(sol.cost, trace[..., -1])
                and bool((trace[..., -1] < trace[..., 0]).all())):
            raise AssertionError(f"{name}: cost trace {trace} does not end "
                                 f"at cost below its start")
        log(f"  {name}: cost trace (record 0) "
            f"{[round(float(c), 3) for c in trace.reshape(-1, NL_ITERS)[0]]}"
            f", step norms {[f'{float(c):.2e}' for c in sol.step_norms.reshape(-1, NL_ITERS)[0]]}")
        seq_sol, seq_gate_ms[name] = timed_solve(ests["sequential_rts"], p)
        gates = (
            ("parallel_kernel vs parallel_rts (cuda)", max_dx(
                sol, ests["parallel_rts"].solve(p)), NL_KERNEL_TOL),
            (f"parallel_kernel vs sequential_rts (cuda, {NL_MODE})",
             max_dx(sol, seq_sol), NL_SEQ_TOL),
            ("parallel_two_filter vs parallel_rts (cuda, discrete)",
             max_dx(est_tf.solve(p), est_rd.solve(p)), NL_TF_TOL))
        for label, dx, tol in gates:
            ok = dx < tol
            log(f"  {name}: {label}: max|dx| {dx:.3e} (tol {tol:.0e}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name}: {label} max|dx| {dx:.3e} >= "
                                     f"{tol:.0e}")

    # sequential_rts takes 12-20 s a solve (~5120 eager steps a pass): its
    # timed gate solve above is the first of its NL_SEQ_RUNS runs on each
    # problem
    solve_ms = {}
    for name, p in problems.items():
        for label, e in ests.items():
            seq = label == "sequential_rts"
            runs = NL_SEQ_RUNS if seq else 5
            solve_ms[(name, label)] = median_solve_ms(
                e, p, runs=runs, warm_up=not seq,
                taken=(seq_gate_ms[name],) if seq else ())
            log(f"  solve {name} {label}: median "
                f"{solve_ms[(name, label)]:.3f} ms over {runs} runs (CUDA "
                f"events, "
                f"{'the first its gate solve' if seq else 'after one warm-up'})")
        log(f"  {name}: sequential_rts / parallel_kernel = "
            f"{solve_ms[(name, 'sequential_rts')] / solve_ms[(name, 'parallel_kernel')]:.2f}")

    phase("nonlinear profile")
    for name, p in problems.items():
        profile_summary(f"{name} parallel_kernel ({NL_ITERS} passes)",
                        lambda: ests["parallel_kernel"].solve(p),
                        solve_ms[(name, "parallel_kernel")])

    phase("nonlinear path in float32")
    model32 = cfg.model(dtype=torch.float32, device="cuda")
    est32 = est("parallel_kernel", KernelOptions(nsub=nsub, mode=NL_MODE),
                m=model32)
    for name, p in problems.items():
        p32 = (Problem.single(model32, ts, y1) if name == "single" else
               Problem.stacked(model32, ts, yb.movedim(1, 0)))
        sol32 = est32.solve(p32)
        dx = float((sol32.x.double() - sols[name].x).abs().max())
        log(f"  {name}: float32 parallel_kernel vs float64: max|dx| "
            f"{dx:.3e}, finite {bool(torch.isfinite(sol32.x).all())} "
            f"(reported, not gated); solve median "
            f"{median_solve_ms(est32, p32):.3f} ms")
    return ({"launches": launches, "shapes": shapes, "nx": 5, "scans": scans,
             "pairwise_launches": lqt_kernel.launch_count()},
            {"model": model, "nsub": nsub, "problems": problems,
             "ieks_cost": {k: sol.cost for k, sol in sols.items()}})


# ---------------------------------------------------------------------------
# 3c. sigma-point path: the posterior-linearisation smoother
# ---------------------------------------------------------------------------

def sigma_point_path(lqt_kernel, lqt_scan, cell: dict) -> dict:
    """``method="sigma_point"`` on the nonlinear cell's records: unscented
    SLR on one record and on 64, cubature on one, each with the scan kernel
    as the inner method, against the same options with ``parallel_rts``;
    returns the scan kernel's launch count and scans on the path."""
    from repro_torch.core import (
        Estimator,
        KernelOptions,
        ParallelOptions,
        SigmaPointOptions,
    )

    model, nsub, problems = cell["model"], cell["nsub"], cell["problems"]

    def est(lin, inner_method, inner):
        return Estimator(model, method="sigma_point", options=(
            SigmaPointOptions(linearization=lin, inner_method=inner_method,
                              inner=inner, iterations=NL_ITERS)))

    kernel = {lin: est(lin, "parallel_kernel",
                       KernelOptions(nsub=nsub, mode=NL_MODE))
              for lin in ("unscented", "cubature")}
    plain = {lin: est(lin, "parallel_rts",
                      ParallelOptions(nsub=nsub, mode=NL_MODE))
             for lin in ("unscented", "cubature")}
    # (linearisation, problem) per solve
    cases = {"single": ("unscented", "single"),
             "stacked64": ("unscented", "stacked64"),
             "single cubature": ("cubature", "single")}
    log(f"sigma points: {model.nx} states -> unscented "
        f"{kernel['unscented'].options.linearization.num_points(model.nx)} "
        f"and cubature "
        f"{kernel['cubature'].options.linearization.num_points(model.nx)} "
        f"points per grid point; {NL_ITERS} passes, {NL_MODE}, float64, on "
        f"{card()}")

    lqt_kernel.reset_launch_count()
    lqt_scan.reset_launch_count()
    sols, per_solve = {}, {}
    for name, (lin, pname) in cases.items():
        before = lqt_scan.launch_count()
        sols[name] = kernel[lin].solve(problems[pname])
        torch.cuda.synchronize()
        per_solve[name] = lqt_scan.launch_count() - before
    launches = lqt_scan.launch_count()
    log(f"sigma-point path launches: lqt_scan {per_solve} (one per pass), "
        f"lqt_combine {lqt_kernel.launch_count()}")
    if (any(n != NL_ITERS for n in per_solve.values())
            or lqt_kernel.launch_count()):
        raise AssertionError(f"sigma-point path: lqt_scan launches per "
                             f"solve {per_solve}, lqt_combine "
                             f"{lqt_kernel.launch_count()}; expected "
                             f"{NL_ITERS} each and 0")

    solve_ms = {}
    for name, (lin, pname) in cases.items():
        sol, p = sols[name], problems[pname]
        lead = () if pname == "single" else (RECORDS,)
        N = NL_BLOCKS * nsub
        for f, shape in (("x", lead + (N + 1, 5)), ("cost", lead),
                         ("cost_trace", lead + (NL_ITERS,))):
            t = getattr(sol, f)
            if (tuple(t.shape) != shape or t.device.type != "cuda"
                    or not bool(torch.isfinite(t).all())):
                raise AssertionError(f"sigma point {name}: {f} "
                                     f"{tuple(t.shape)} on {t.device} not "
                                     f"finite or misshapen")
        dx = float((sol.x - plain[lin].solve(p).x).abs().max())
        ok = dx < NL_KERNEL_TOL
        log(f"  {name}: parallel_kernel inner vs parallel_rts inner (cuda): "
            f"max|dx| {dx:.3e} (tol {NL_KERNEL_TOL:.0e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"sigma point {name}: max|dx| {dx:.3e}")
        taylor = cell["ieks_cost"][pname]
        below = int((sol.cost <= taylor * (1 + 1e-6)).sum())
        log(f"  {name}: cost trace (record 0) "
            f"{[round(float(c), 3) for c in sol.cost_trace.reshape(-1, NL_ITERS)[0]]}"
            f"; final cost mean {float(sol.cost.mean()):.3f} against the "
            f"Taylor IEKS's {float(taylor.mean()):.3f} ({below} of "
            f"{sol.cost.numel()} records at or below it; printed, not gated)")
        solve_ms[name] = median_solve_ms(kernel[lin], p)
        log(f"  solve {name} sigma_point (parallel_kernel inner): median "
            f"{solve_ms[name]:.3f} ms over 5 runs (CUDA events, after one "
            f"warm-up) on {card()}")

    phase("sigma-point profile")
    for name in ("single", "stacked64"):
        lin, pname = cases[name]
        profile_summary(f"{name} sigma_point {lin} ({NL_ITERS} passes)",
                        lambda: kernel[lin].solve(problems[pname]),
                        solve_ms[name])
    records = [1 if cases[k][1] == "single" else RECORDS for k in cases]
    scans = NL_ITERS * [(NL_BLOCKS + 1, r) for r in records]
    shapes = NL_ITERS * [c for r in records
                         for c in scan_lane_counts(NL_BLOCKS + 1, r)]
    return {"launches": launches, "shapes": shapes, "nx": 5, "scans": scans,
            "pairwise_launches": lqt_kernel.launch_count()}


# ---------------------------------------------------------------------------
# 3d. ragged path: records of unequal lengths by pad-and-bucket
# ---------------------------------------------------------------------------

def ragged_records(cell: dict) -> tuple:
    """The ragged cell: RECORDS lengths drawn uniformly from RAGGED_LENGTHS
    intervals, and the prefixes of the estimation cell's records that
    long."""
    ts, yb = cell["ts"], cell["yb"]
    lengths = [int(n) for n in np.random.default_rng(SEED).integers(
        *RAGGED_LENGTHS, size=RECORDS, endpoint=True)]
    return lengths, [(ts[:n + 1], yb[:n, i]) for i, n in enumerate(lengths)]


def ragged_path(lqt_kernel, lqt_scan, cell: dict) -> dict:
    """64 Wiener records of lengths drawn uniformly from RAGGED_LENGTHS
    intervals (prefixes of the estimation cell's 64 records) as one ragged
    problem through ``parallel_kernel``: one stacked solve and one scan
    launch per bucket; returns the scan kernel's launch count and scans on
    the path."""
    from repro_torch.core import (
        Estimator,
        KernelOptions,
        ParallelOptions,
        Problem,
        SequentialOptions,
    )

    model = cell["model"]
    lengths, records = ragged_records(cell)
    problem = Problem.ragged(model, records)

    def n_pad_of(n):
        """The default bucket rule, written out: nsub * 2^ceil(log2(blocks))
        with blocks = ceil(n / nsub)."""
        return NSUB * 2 ** int(np.ceil(np.log2(-(-n // NSUB))))

    bucket = {}
    for i, n in enumerate(lengths):
        bucket.setdefault(n_pad_of(n), []).append(i)
    want = [(n_pad, len(idx), 2 ** int(np.ceil(np.log2(len(idx)))))
            for n_pad, idx in sorted(bucket.items())]
    log(f"Wiener velocity, {RECORDS} records of {min(lengths)}..."
        f"{max(lengths)} intervals ({sum(n % NSUB != 0 for n in lengths)} "
        f"not multiples of nsub={NSUB}), discrete, float64, default buckets "
        f"(n_pad, records, batch rows) {want}, on {card()}")

    est_k = Estimator(model, method="parallel_kernel",
                      options=KernelOptions(nsub=NSUB, mode="discrete"))
    est_p = Estimator(model, method="parallel_rts",
                      options=ParallelOptions(nsub=NSUB, mode="discrete"))
    est_s = Estimator(model, method="sequential_rts",
                      options=SequentialOptions(mode="discrete"),
                      device="cpu")

    lqt_kernel.reset_launch_count()
    lqt_scan.reset_launch_count()
    sols = est_k.solve(problem)
    torch.cuda.synchronize()
    launches = lqt_scan.launch_count()
    report = sols[0].padding
    got = [(b.n_pad, b.records, b.batch) for b in report.buckets]
    log(f"ragged path launches: lqt_scan {launches} (one per bucket), "
        f"lqt_combine {lqt_kernel.launch_count()}")
    if (launches != len(want) or lqt_kernel.launch_count()
            or got != want or report.records != RECORDS
            or report.lengths != tuple(lengths)
            or report.real_intervals != sum(lengths)
            or any(s.padding is not report for s in sols)):
        raise AssertionError(f"ragged path: {launches} lqt_scan and "
                             f"{lqt_kernel.launch_count()} lqt_combine "
                             f"launches, buckets {got}; expected "
                             f"{len(want)}, 0 and {want}")
    for b in report.buckets:
        real = sum(lengths[i] for i in bucket[b.n_pad])
        log(f"  bucket n_pad={b.n_pad} ({b.n_pad // NSUB} blocks): "
            f"{b.records} records in {b.batch} rows ({b.recycled_rows} "
            f"recycled), interval utilisation {real / (b.n_pad * b.batch):.4f}")
    log(f"  report: {report.records} records, {report.real_intervals} real of "
        f"{report.solved_intervals} solved intervals (utilisation "
        f"{report.interval_utilisation:.4f}), row utilisation "
        f"{report.row_utilisation:.4f}")

    for i, (sol, n) in enumerate(zip(sols, lengths)):
        for f in ("x", "S", "v", "cost"):
            t = getattr(sol, f)
            if t.device.type != "cuda" or not bool(torch.isfinite(t).all()):
                raise AssertionError(f"ragged record {i}: {f} not finite "
                                     f"on cuda")
        if tuple(sol.x.shape) != (n + 1, 4):
            raise AssertionError(f"ragged record {i}: x shape "
                                 f"{tuple(sol.x.shape)}")
    ref = est_p.solve(problem)
    dx = max(float((a.x - b.x).abs().max()) for a, b in zip(sols, ref))
    ok = dx < 1e-8
    log(f"  every record, parallel_kernel vs parallel_rts (cuda, the same "
        f"ragged problem): max|dx| {dx:.3e} (tol 1e-8) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"ragged path: max|dx| {dx:.3e} against "
                             f"parallel_rts")
    for b in report.buckets:
        i = min(bucket[b.n_pad], key=lambda i: lengths[i])
        ts_i, y_i = records[i]
        seq = est_s.solve(Problem.single(model, ts_i.cpu(), y_i.cpu()))
        dx = float((sols[i].x.cpu() - seq.x).abs().max())
        ok = dx < 1e-6
        log(f"  bucket n_pad={b.n_pad}: shortest record ({lengths[i]} "
            f"intervals, padded by {b.n_pad - lengths[i]}) vs sequential_rts "
            f"on the CPU, unpadded: max|dx| {dx:.3e} (tol 1e-6) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"ragged record {i}: max|dx| {dx:.3e} "
                                 f"against unpadded sequential_rts")

    ms = median_solve_ms(est_k, problem)
    log(f"  ragged solve parallel_kernel: median {ms:.3f} ms over 5 runs "
        f"(CUDA events around the whole solve: padding, {len(want)} stacked "
        f"solves, slicing; after one warm-up) on {card()}")
    phase("ragged profile")
    profile_summary(f"ragged {RECORDS} records parallel_kernel",
                    lambda: est_k.solve(problem), ms)
    scans = [(n_pad // NSUB + 1, rows) for n_pad, _, rows in want]
    shapes = [c for n, r in scans for c in scan_lane_counts(n, r)]
    return {"launches": launches, "shapes": shapes, "nx": 4, "scans": scans,
            "pairwise_launches": lqt_kernel.launch_count()}


# ---------------------------------------------------------------------------
# 3e-3g. the estimation serving engines
# ---------------------------------------------------------------------------

def recording_solves(estimator) -> list:
    """Wrap ``estimator.solve`` so that every call appends its problem's
    ``(records, intervals)``: the shape of each wave's stacked solve."""
    shapes, solve = [], estimator.solve

    def recorded(problem):
        shapes.append(tuple(problem.y.shape[:2]))
        return solve(problem)

    estimator.solve = recorded
    return shapes


def wave_path(launches: int, shapes, passes: int, nx: int) -> dict:
    """A path's scan record for the timing phase: the scans ``(elements,
    records)`` that the waves of ``shapes`` launch, and the launch shapes
    the per-level scan would have had for them."""
    scans = [(n // NSUB + 1, b) for b, n in shapes for _ in range(passes)]
    return {"launches": launches, "scans": scans, "nx": nx,
            "shapes": [c for n, r in scans for c in scan_lane_counts(n, r)],
            "pairwise_launches": 0}


def latency_line(name: str) -> str:
    from repro_torch import obs

    h = obs.histogram(name).summary()
    return (f"{name} p50 {h['p50'] * 1e3:.3f} ms, p99 {h['p99'] * 1e3:.3f} "
            f"ms over {h['count']} (obs histogram, bucket-interpolated)")


def profile_wave(label: str, step) -> None:
    """Time one wave (``step()``) by CUDA events, then profile another."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    step()
    stop.record()
    torch.cuda.synchronize()
    profile_summary(label, step, start.elapsed_time(stop))


def trajectory_engine_path(lqt_kernel, lqt_scan, cell: dict) -> dict:
    """The ragged cell's 64 records submitted in draw order to a
    ``TrajectoryEngine`` (``parallel_kernel``, waves of ENGINE_BATCH) and
    drained: waves per bucket, one scan launch per wave, every record
    against the port's ragged ``parallel_rts`` solve on the card."""
    from repro_torch import obs
    from repro_torch.core import (
        Estimator,
        KernelOptions,
        ParallelOptions,
        Problem,
    )
    from repro_torch.serving import TrajectoryEngine

    model, ts, yb = cell["model"], cell["ts"], cell["yb"]
    lengths = [int(n) for n in np.random.default_rng(SEED).integers(
        *RAGGED_LENGTHS, size=RECORDS, endpoint=True)]
    records = [(ts[:n + 1], yb[:n, i]) for i, n in enumerate(lengths)]
    # records arrive from the host, as a client would submit them
    host = [(t.cpu().numpy(), y.cpu().numpy()) for t, y in records]
    counts = {}
    for n in lengths:
        n_pad = NSUB * 2 ** int(np.ceil(np.log2(-(-n // NSUB))))
        counts[n_pad] = counts.get(n_pad, 0) + 1
    want_waves = {n_pad: -(-c // ENGINE_BATCH) for n_pad, c in counts.items()}
    want_recycled = sum(w * ENGINE_BATCH - counts[n]
                        for n, w in want_waves.items())
    log(f"Wiener velocity, the ragged cell's {RECORDS} records submitted in "
        f"draw order to TrajectoryEngine(batch={ENGINE_BATCH}, "
        f"method='parallel_kernel', discrete, float64), buckets (n_pad: "
        f"records) {dict(sorted(counts.items()))}, on {card()}")

    opts = KernelOptions(nsub=NSUB, mode="discrete")
    eng = TrajectoryEngine(model, batch=ENGINE_BATCH,
                           method="parallel_kernel", options=opts)
    shapes = recording_solves(eng.estimator)
    obs.reset()
    obs.enable()
    lqt_kernel.reset_launch_count()
    lqt_scan.reset_launch_count()
    t0 = time.perf_counter()
    tickets = [eng.submit(t, y) for t, y in host]
    eng.run()
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    launches = lqt_scan.launch_count()
    got = dict(eng.collect(tickets=tickets))
    snap = obs.snapshot()
    waves = {}
    for _, n in shapes:
        waves[n] = waves.get(n, 0) + 1
    log(f"trajectory engine launches: lqt_scan {launches} ({eng.waves} "
        f"waves), lqt_combine {lqt_kernel.launch_count()}; waves per bucket "
        f"{dict(sorted(waves.items()))}")
    c = snap["counters"]
    if (waves != want_waves or launches != eng.waves
            or lqt_kernel.launch_count() or len(got) != RECORDS
            or c.get("engine.completed") != RECORDS
            or c.get("engine.recycled_rows") != want_recycled
            or eng.recycled_rows != want_recycled):
        raise AssertionError(
            f"trajectory engine: waves {waves} (want {want_waves}), "
            f"{launches} lqt_scan launches for {eng.waves} waves, "
            f"{lqt_kernel.launch_count()} lqt_combine, completed "
            f"{c.get('engine.completed')}, recycled rows "
            f"{c.get('engine.recycled_rows')} (want {want_recycled})")
    ref = Estimator(model, method="parallel_rts",
                    options=ParallelOptions(nsub=NSUB, mode="discrete")
                    ).solve(Problem.ragged(model, records))
    cell["ragged_ref"] = [r.x for r in ref]
    dx = 0.0
    for t, n, r in zip(tickets, lengths, ref):
        sol = got[t]
        if (tuple(sol.x.shape) != (n + 1, 4) or sol.x.device.type != "cuda"
                or not bool(torch.isfinite(sol.x).all())):
            raise AssertionError(f"trajectory engine ticket {t}: x "
                                 f"{tuple(sol.x.shape)} on {sol.x.device}")
        dx = max(dx, float((sol.x - r.x).abs().max()))
    ok = dx < 1e-8
    log(f"  every record, engine (parallel_kernel) vs Estimator "
        f"parallel_rts on Problem.ragged (cuda): max|dx| {dx:.3e} (tol "
        f"1e-8) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"trajectory engine: max|dx| {dx:.3e}")
    occ = snap["histograms"]["engine.wave_occupancy"]
    log(f"  drain: {RECORDS} records in {drain_s * 1e3:.3f} ms wall "
        f"(submit + run, obs on) = {RECORDS / drain_s:.1f} records/s; "
        f"{latency_line('engine.record_latency_seconds')}; mean wave "
        f"occupancy {occ['mean']:.4f}; padding waste "
        f"{snap['gauges']['engine.padding_waste']:.4f}; on {card()}")
    obs.disable()
    # one profiled wave of the largest bucket
    big = max(counts)
    wave = [r for r, n in zip(host, lengths) if n > big // 2][:ENGINE_BATCH]

    def one_wave():
        for t, y in wave:
            eng.submit(t, y)
        eng.step()
        eng.collect()
        torch.cuda.synchronize()

    phase("trajectory engine profile")
    profile_wave(f"one engine wave ({len(wave)} records, n_pad={big})",
                 one_wave)
    return wave_path(launches, shapes[:launches], 1, 4)


def stream_pass(eng, ts, ys, late=None):
    """Round-robin STREAM_CHUNK-interval pushes of every track, draining
    after each round; ``late`` (a per-track boolean mask over the
    intervals) holds those measurements back one round.  Returns the track
    ids, windows solved and push summaries."""
    N = ys[0].shape[0]
    tids = [eng.open_track(float(ts[0])) for _ in ys]
    windows, totals = 0, {"merged": 0, "dropped_late": 0, "offered": 0}
    rounds = range(0, N + (STREAM_CHUNK if late is not None else 0),
                   STREAM_CHUNK)
    for i in rounds:
        for k, (tid, y) in enumerate(zip(tids, ys)):
            if late is None:
                idx = np.arange(i, min(i + STREAM_CHUNK, N))
            else:
                prev = np.arange(max(0, i - STREAM_CHUNK), i)
                cur = np.arange(i, min(i + STREAM_CHUNK, N))
                idx = np.sort(np.concatenate(
                    [prev[late[k][prev]], cur[~late[k][cur]]]))
            if idx.size:
                res = eng.push(tid, ts[idx + 1], y[idx])
                totals["offered"] += idx.size
                totals["merged"] += res["merged"]
                totals["dropped_late"] += res["dropped_late"]
        windows += eng.run()
    return tids, windows, totals


def streaming_linear_path(lqt_kernel, lqt_scan) -> dict:
    """STREAM_TRACKS Wiener tracks of STREAM_N intervals through a
    ``StreamingEngine`` (lag STREAM_LAG, waves of STREAM_BATCH,
    ``parallel_kernel``): a warm-up pass on other tracks, the measured
    in-order pass, then the late pass; each against offline solves."""
    from repro_torch import obs
    from repro_torch.configs.wiener_velocity import WienerVelocityConfig
    from repro_torch.core import (
        Estimator,
        KernelOptions,
        ParallelOptions,
        Problem,
        simulate_linear,
        time_grid,
    )
    from repro_torch.serving import StreamingEngine

    model = WienerVelocityConfig(p0=1.0).model(device="cuda")
    N, dt = STREAM_N, 0.1
    tsd = time_grid(0.0, N * dt, N, device="cuda")
    gm = torch.Generator(device="cuda").manual_seed(SEED)
    _, yd = simulate_linear(model, tsd[:, None].expand(-1, STREAM_TRACKS),
                            gm)
    _, yw = simulate_linear(model, tsd[:, None].expand(-1, STREAM_BATCH), gm)
    ts = tsd.cpu().numpy()
    ys = [y.numpy() for y in yd.movedim(1, 0).cpu()]
    warm = [y.numpy() for y in yw.movedim(1, 0).cpu()]
    opts = KernelOptions(nsub=NSUB, mode="discrete")
    offline = Estimator(model, method="parallel_rts",
                        options=ParallelOptions(nsub=NSUB, mode="discrete"))
    gate = list(range(0, STREAM_TRACKS, STREAM_TRACKS // 4))
    refs = {k: offline.solve(Problem.single(model, tsd, yd[:, k])).x.cpu()
            for k in gate}
    out = wave_path(0, [], 1, 4)

    def measured(label, eng, keep, late=None):
        shapes = recording_solves(eng.estimator)
        obs.reset()
        obs.enable()
        lqt_kernel.reset_launch_count()
        lqt_scan.reset_launch_count()
        t0 = time.perf_counter()
        tids, windows, totals = stream_pass(eng, ts, ys, late=late)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = lqt_scan.launch_count()
        snap = obs.snapshot()
        c = snap["counters"]
        log(f"{label}: {windows} windows in {eng.waves} waves "
            f"({len(shapes)} solves), {wall * 1e3:.3f} ms wall = "
            f"{windows / wall:.1f} windows/s; "
            f"{latency_line('stream.window_latency_seconds')}; lqt_scan "
            f"{launches}, lqt_combine {lqt_kernel.launch_count()}; waves per "
            f"bucket {dict(sorted(collections.Counter(n for _, n in shapes).items()))}"
            f"; evicted {c.get('stream.evicted_intervals', 0)}, late merges "
            f"{c.get('stream.late_merges', 0)}, late drops "
            f"{c.get('stream.late_drops', 0)}, deferred evictions "
            f"{c.get('stream.deferred_evictions', 0)}, padding waste "
            f"{snap['gauges']['stream.padding_waste']:.4f}, mean occupancy "
            f"{snap['histograms']['stream.wave_occupancy']['mean']:.4f}; "
            f"on {card()}")
        if (launches != eng.waves or launches != len(shapes)
                or lqt_kernel.launch_count()
                or c.get("stream.late_drops", 0)):
            raise AssertionError(
                f"{label}: {launches} lqt_scan launches for {eng.waves} "
                f"waves, {lqt_kernel.launch_count()} lqt_combine, late drops "
                f"{c.get('stream.late_drops', 0)}")
        worst = 0.0
        for k in gate:
            x = eng.estimate(tids[k]).x
            ref = refs[k]
            if (tuple(x.shape) != tuple(ref.shape)
                    or not bool(torch.isfinite(x).all())):
                raise AssertionError(f"{label} track {k}: x "
                                     f"{tuple(x.shape)}")
            err = float((x[-keep - 1:] - ref[-keep - 1:]).abs().max())
            worst = max(worst, err / float(ref.abs().max()))
        ok = worst < 1e-9
        log(f"  final {keep + 1} states of tracks {gate} vs offline "
            f"parallel_rts of the whole {N}-interval record (cuda): max "
            f"|dx| / max|x| {worst:.3e} (tol 1e-9) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label}: window vs offline {worst:.3e}")
        obs.disable()
        done = wave_path(launches, shapes, 1, 4)
        for key in ("launches", "scans", "shapes"):
            out[key] += done[key]
        return eng, tids

    log(f"Wiener velocity (p0 = 1), {STREAM_TRACKS} tracks of {N} "
        f"intervals (dt = {dt}), StreamingEngine(lag={STREAM_LAG}, "
        f"batch={STREAM_BATCH}, method='parallel_kernel', discrete, "
        f"float64), round-robin chunks of {STREAM_CHUNK} intervals, a drain "
        f"after each round")
    eng = StreamingEngine(model, lag=STREAM_LAG, batch=STREAM_BATCH,
                          method="parallel_kernel", options=opts)
    t0 = time.perf_counter()
    wtids, wwin, _ = stream_pass(eng, ts, warm)
    for tid in wtids:
        eng.close(tid)
    torch.cuda.synchronize()
    log(f"  warm-up pass: {len(warm)} other tracks, {wwin} windows in "
        f"{time.perf_counter() - t0:.2f} s")
    eng.waves = 0
    eng, tids = measured("in-order pass", eng, STREAM_LAG)

    phase("streaming engine profile")
    nxt = [(tid, y) for tid, y in zip(tids, ys)][:STREAM_BATCH]
    extra = [0]

    def one_wave():
        # one more chunk for STREAM_BATCH tracks, past their records' end
        t1 = ts[-1] + dt * (1 + np.arange(STREAM_CHUNK) + extra[0])
        extra[0] += STREAM_CHUNK
        for tid, y in nxt:
            eng.push(tid, t1, y[:STREAM_CHUNK])
        eng.step()
        torch.cuda.synchronize()

    profile_wave(f"one streaming wave ({STREAM_BATCH} windows of "
                 f"~{STREAM_LAG + STREAM_CHUNK} intervals)", one_wave)

    phase("streaming engine, late pass")
    late_lag, slack = STREAM_CHUNK // 2, STREAM_CHUNK
    rng = np.random.default_rng(SEED + 1)
    held = [rng.random(N) < 0.10 for _ in ys]
    log(f"late pass: lag {late_lag}, reorder_slack {slack}, 10 % of each "
        f"track's measurements ({sum(int(h.sum()) for h in held)} in all) "
        f"held back one round")
    eng = StreamingEngine(model, lag=late_lag, batch=STREAM_BATCH,
                          method="parallel_kernel", options=opts,
                          reorder_slack=slack)
    measured("late pass", eng, late_lag + slack, late=held)
    return out


def streaming_sigma_point_path(lqt_kernel, lqt_scan) -> dict:
    """SP_STREAM_TRACKS coordinated-turn tracks through two
    ``StreamingEngine(method="sigma_point")``s, the inner method
    ``parallel_kernel`` and ``parallel_rts``, on the same pushes."""
    from repro_torch import obs
    from repro_torch.configs.coordinated_turn import CoordinatedTurnConfig
    from repro_torch.core import (
        KernelOptions,
        ParallelOptions,
        simulate_nonlinear,
        time_grid,
    )
    from repro_torch.serving import StreamingEngine
    from repro_torch.serving.waves import robust_default_options

    cfg = CoordinatedTurnConfig()
    model = cfg.model(device="cuda")
    N = SP_STREAM_N
    tsd = time_grid(cfg.t0, cfg.tf, N, device="cuda")
    gm = torch.Generator(device="cuda").manual_seed(SEED)
    _, yd = simulate_nonlinear(
        model, tsd[:, None].expand(-1, SP_STREAM_TRACKS), gm)
    ts = tsd.cpu().numpy()
    ys = [y.numpy() for y in yd.movedim(1, 0).cpu()]
    base = robust_default_options("sigma_point")
    passes = base.iterations
    log(f"coordinated turn, {SP_STREAM_TRACKS} tracks of {N} intervals "
        f"(dt = {(cfg.tf - cfg.t0) / N}), StreamingEngine(lag={STREAM_LAG}, "
        f"batch={STREAM_BATCH}, method='sigma_point', unscented, {passes} "
        f"passes, discrete inner mode, float64), chunks of {STREAM_CHUNK}")
    est = {}
    for inner_method, inner in (
            ("parallel_kernel", KernelOptions(nsub=NSUB, mode="discrete")),
            ("parallel_rts", ParallelOptions(nsub=NSUB, mode="discrete"))):
        eng = StreamingEngine(
            model, lag=STREAM_LAG, batch=STREAM_BATCH, method="sigma_point",
            options=base.replace(inner_method=inner_method, inner=inner))
        shapes = recording_solves(eng.estimator)
        obs.reset()
        obs.enable()
        lqt_kernel.reset_launch_count()
        lqt_scan.reset_launch_count()
        t0 = time.perf_counter()
        tids, windows, _ = stream_pass(eng, ts, ys)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = lqt_scan.launch_count()
        log(f"{inner_method} inner: {windows} windows in {eng.waves} waves, "
            f"{wall * 1e3:.3f} ms wall = {windows / wall:.1f} windows/s; "
            f"{latency_line('stream.window_latency_seconds')}; lqt_scan "
            f"{launches}, lqt_combine {lqt_kernel.launch_count()}; on "
            f"{card()}")
        want = eng.waves * passes if inner_method == "parallel_kernel" else 0
        if launches != want or lqt_kernel.launch_count():
            raise AssertionError(
                f"sigma-point streaming ({inner_method}): {launches} "
                f"lqt_scan launches, expected {want}; lqt_combine "
                f"{lqt_kernel.launch_count()}")
        obs.disable()
        est[inner_method] = [eng.estimate(t).x for t in tids]
        if inner_method == "parallel_kernel":
            out = wave_path(launches, shapes, passes, 5)
    dx = 0.0
    for k, r in zip(est["parallel_kernel"], est["parallel_rts"]):
        if tuple(k.shape) != (N + 1, 5) or not bool(torch.isfinite(k).all()):
            raise AssertionError(f"sigma-point streaming: x {tuple(k.shape)}")
        dx = max(dx, float((k - r).abs().max()))
    ok = dx < NL_KERNEL_TOL
    log(f"  every track's final estimate, parallel_kernel inner vs "
        f"parallel_rts inner: max|dx| {dx:.3e} (tol {NL_KERNEL_TOL}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"sigma-point streaming: max|dx| {dx:.3e}")
    return out


# ---------------------------------------------------------------------------
# 3h-3i. the sharded paths: time axis (method="distributed"), record axis
# ---------------------------------------------------------------------------

def repeated_mesh(time=1, batch=1):
    """A mesh of ``time x batch`` entries that all name card 0: every
    shard's scan, carry exchange and fix-up runs as on a mesh of cards."""
    from repro_torch.distributed import MeshSpec

    return MeshSpec(time=time, batch=batch).build(
        [torch.device("cuda", 0)] * (time * batch))


def span_names(snap) -> set:
    names = set()

    def walk(nodes):
        for nd in nodes:
            names.add(nd["name"])
            walk(nd.get("children", []))

    walk(snap["span_trees"])
    return names


def time_sharded_path(lqt_kernel, lqt_scan, cell: dict) -> None:
    """``Estimator(method="distributed")`` on meshes of P x cuda:0 for P in
    TIME_SHARDS, on the estimation cell's single record and 64 records
    (2049 elements: the head/tail stitch at every P) and a 20470-interval
    record (2048 elements: divisible), against ``parallel_rts`` and
    ``parallel_kernel`` on the card and ``sequential_rts`` on the CPU; the
    shard counts and span, solve times, a float32 solve with a float64
    carry scan, and the default mesh's fallback."""
    from repro_torch import obs
    from repro_torch.core import (
        DistributedOptions,
        Estimator,
        KernelOptions,
        ParallelOptions,
        Problem,
        SequentialOptions,
    )

    model, ts, yb, y1 = cell["model"], cell["ts"], cell["yb"], cell["y1"]
    N = N_BLOCKS * NSUB
    Nd = N - NSUB
    problems = {"single": Problem.single(model, ts, y1),
                "stacked64": Problem.stacked(model, ts, yb.movedim(1, 0)),
                "single, 2048 elements": Problem.single(model, ts[:Nd + 1],
                                                        y1[:Nd])}
    dopts = DistributedOptions(nsub=NSUB, mode="discrete")
    est_p = Estimator(model, method="parallel_rts",
                      options=ParallelOptions(nsub=NSUB, mode="discrete"))
    est_k = Estimator(model, method="parallel_kernel",
                      options=KernelOptions(nsub=NSUB, mode="discrete"))
    log(f"Wiener velocity, T={N_BLOCKS} blocks x nsub={NSUB} "
        f"({N_BLOCKS + 1} scan elements) and T={Nd // NSUB} "
        f"({Nd // NSUB + 1}), float64, discrete; meshes of "
        f"P x cuda:0 for P in {TIME_SHARDS}; torch.cuda.device_count() "
        f"{torch.cuda.device_count()}; on {card()}")
    refs = {}
    for name, p in problems.items():
        refs[name] = {"parallel_rts (cuda)": (est_p.solve(p).x, DIST_TOL),
                      "parallel_kernel (cuda)": (est_k.solve(p).x,
                                                 DIST_KERNEL_TOL)}
    seq = Estimator(model, method="sequential_rts",
                    options=SequentialOptions(mode="discrete"), device="cpu")
    refs["single"]["sequential_rts (cpu)"] = (cell["seq_x"]["single"],
                                              DIST_SEQ_TOL)
    refs["stacked64"]["sequential_rts (cpu)"] = (cell["seq_x"]["stacked64"],
                                                 DIST_SEQ_TOL)
    p = problems["single, 2048 elements"]
    refs["single, 2048 elements"]["sequential_rts (cpu)"] = (
        seq.solve(Problem.single(model, p.ts.cpu(), p.y.cpu())).x,
        DIST_SEQ_TOL)
    torch.cuda.synchronize()

    base_ms = {name: median_solve_ms(est_p, p)
               for name, p in problems.items()}
    solve_ms = {}
    for P in TIME_SHARDS:
        est = Estimator(model, method="distributed", options=dopts,
                        mesh=repeated_mesh(time=P))
        for name, p in problems.items():
            obs.reset()
            obs.enable()
            lqt_kernel.reset_launch_count()
            lqt_scan.reset_launch_count()
            sol = est.solve(p)
            snap = obs.snapshot(include_trees=True)
            obs.disable()
            c = snap["counters"]
            shards, spans = c.get("distributed.shards"), span_names(snap)
            if (shards != 2 * P or "distributed_scan" not in spans
                    or lqt_scan.launch_count() or lqt_kernel.launch_count()):
                raise AssertionError(
                    f"distributed P={P} {name}: distributed.shards {shards} "
                    f"(want {2 * P}), span distributed_scan "
                    f"{'distributed_scan' in spans}, kernel launches "
                    f"{lqt_scan.launch_count()} / "
                    f"{lqt_kernel.launch_count()} (want 0: the plain "
                    f"combine, as the reference)")
            if (sol.x.device.type != "cuda" or sol.x.dtype != torch.float64
                    or not bool(torch.isfinite(sol.x).all())):
                raise AssertionError(f"distributed P={P} {name}: x on "
                                     f"{sol.x.device}, {sol.x.dtype}")
            errs = []
            for ref_name, (x, tol) in refs[name].items():
                dx = float((sol.x.cpu() - x.cpu()).abs().max())
                ok = bool(torch.allclose(sol.x.cpu(), x.cpu(), rtol=tol,
                                         atol=tol))
                errs.append(f"vs {ref_name} max|dx| {dx:.3e} (rtol=atol "
                            f"{tol:.0e}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"distributed P={P} {name}: "
                                         f"max|dx| {dx:.3e} vs {ref_name}")
            ms = median_solve_ms(est, p)
            solve_ms[(P, name)] = ms
            log(f"  P={P} {name}: distributed.shards {shards}, carry bytes "
                f"{c.get('distributed.carry_bytes')}; " + "; ".join(errs)
                + f"; median {ms:.3f} ms (parallel_rts {base_ms[name]:.3f} ms"
                f"; 5 runs, CUDA events)")

    phase("time-sharded profile")
    P = TIME_SHARDS[-1]
    for name in ("single", "stacked64"):
        profile_summary(f"{name} distributed, P={P} x cuda:0",
                        lambda: est.solve(problems[name]),
                        solve_ms[(P, name)])

    phase("time-sharded path in float32, float64 carry scan")
    m32 = model.to(dtype=torch.float32)
    p32 = Problem.single(m32, ts, y1)
    e32 = Estimator(m32, method="distributed", mesh=repeated_mesh(time=4),
                    options=DistributedOptions(nsub=NSUB, mode="discrete",
                                               carry_dtype="float64"))
    x32 = e32.solve(p32).x
    if x32.dtype != torch.float32 or tuple(x32.shape) != (N + 1, 4):
        raise AssertionError(f"float32 distributed solve: x {x32.dtype} "
                             f"{tuple(x32.shape)}")
    # the float32 carry scan (carry_dtype left at its default) must give
    # other bits: the float64 carry really ran
    x32_own = Estimator(m32, method="distributed", mesh=repeated_mesh(time=4),
                        options=DistributedOptions(nsub=NSUB,
                                                   mode="discrete")).solve(
        p32).x
    if torch.equal(x32, x32_own):
        raise AssertionError("carry_dtype='float64' left the float32 solve "
                             "bit-identical to the float32-carry solve")
    x64 = refs["single"]["parallel_rts (cuda)"][0]
    err = float((x32.double() - x64).abs().max())
    err_own = float((x32_own.double() - x64).abs().max())
    log(f"  P=4 single, float32 elements, carry_dtype='float64': x stays "
        f"float32, finite {bool(torch.isfinite(x32).all())}, differs from "
        f"the float32-carry solve; max|dx| vs the float64 solve {err:.3e} "
        f"(float32 carry {err_own:.3e}; max|x| "
        f"{float(x64.abs().max()):.3e}; printed, not gated)")

    phase("time-sharded path: the default mesh")
    n = torch.cuda.device_count()
    p = problems["single"]
    auto = Estimator(model, method="distributed", options=dopts)
    if n < 2:
        sd, sp = auto.solve(p), est_p.solve(p)
        same = all(torch.equal(getattr(sd, f), getattr(sp, f))
                   for f in ("x", "S", "v"))
        log(f"  {n} visible card: the default mesh has < 2 time shards; "
            f"fallback='auto' equals parallel_rts bit for bit: {same}")
        if not same:
            raise AssertionError("fallback='auto' differs from parallel_rts")
        try:
            Estimator(model, method="distributed",
                      options=DistributedOptions(nsub=NSUB, mode="discrete",
                                                 fallback="error")).solve(p)
        except RuntimeError as exc:
            log(f"  fallback='error' raises: {exc}")
        else:
            raise AssertionError("fallback='error' did not raise")
    else:
        obs.reset()
        obs.enable()
        dx = float((auto.solve(p).x - refs["single"][
            "parallel_rts (cuda)"][0]).abs().max())
        shards = obs.snapshot()["counters"].get("distributed.shards")
        obs.disable()
        log(f"  {n} visible cards: the default mesh shards over them: "
            f"distributed.shards {shards}, max|dx| {dx:.3e}")
        if shards != 2 * n or dx > DIST_TOL:
            raise AssertionError(f"default mesh over {n} cards: shards "
                                 f"{shards}, max|dx| {dx:.3e}")


def batch_sharded_path(lqt_kernel, lqt_scan, cell: dict) -> dict:
    """Records split over a mesh's batch axis: stacked64 through
    ``parallel_kernel`` on ``MeshSpec(batch=4)`` (one scan launch per
    shard), ``distributed`` on ``MeshSpec(time=4, batch=2)``, the ragged
    cell's records through ``TrajectoryEngine(batch=16)`` on a batch axis
    of 2 (a launch per wave and shard), and a short ``StreamingEngine``
    pass on a batch axis of 2.  Returns the scan kernel's launch count and
    scans on the path."""
    from repro_torch import obs
    from repro_torch.configs.wiener_velocity import WienerVelocityConfig
    from repro_torch.core import (
        DistributedOptions,
        Estimator,
        KernelOptions,
        ParallelOptions,
        Problem,
        simulate_linear,
        time_grid,
    )
    from repro_torch.serving import StreamingEngine, TrajectoryEngine

    model, ts, yb = cell["model"], cell["ts"], cell["yb"]
    stacked = Problem.stacked(model, ts, yb.movedim(1, 0))
    kopts = KernelOptions(nsub=NSUB, mode="discrete")
    est_k = Estimator(model, method="parallel_kernel", options=kopts)
    est_s = Estimator(model, method="parallel_kernel", options=kopts,
                      mesh=repeated_mesh(batch=BATCH_SHARDS))
    out = {"launches": 0, "scans": [], "nx": 4, "shapes": [],
           "pairwise_launches": 0}

    def add(launches, scans):
        out["launches"] += launches
        out["scans"] += scans
        out["shapes"] += [c for n, r in scans for c in scan_lane_counts(n, r)]

    log(f"stacked64 through parallel_kernel on a batch axis of "
        f"{BATCH_SHARDS} x cuda:0, on {card()}")
    lqt_kernel.reset_launch_count()
    lqt_scan.reset_launch_count()
    sol = est_s.solve(stacked)
    torch.cuda.synchronize()
    launches = lqt_scan.launch_count()
    if launches != BATCH_SHARDS or lqt_kernel.launch_count():
        raise AssertionError(f"batch-sharded stacked64: {launches} lqt_scan "
                             f"launches (want {BATCH_SHARDS}), "
                             f"{lqt_kernel.launch_count()} lqt_combine")
    add(launches, [(N_BLOCKS + 1, RECORDS // BATCH_SHARDS)] * BATCH_SHARDS)
    want = est_k.solve(stacked)
    dx = float((sol.x - want.x).abs().max())
    ok = (dx < 1e-8 and tuple(sol.x.shape) == tuple(want.x.shape)
          and all(torch.allclose(getattr(sol, f), getattr(want, f),
                                 rtol=1e-9, atol=1e-8) for f in ("S", "v")))
    ms, ms0 = median_solve_ms(est_s, stacked), median_solve_ms(est_k, stacked)
    log(f"  lqt_scan {launches} (one per shard of {RECORDS // BATCH_SHARDS} "
        f"records), lqt_combine 0; vs the unsharded solve: max|dx| "
        f"{dx:.3e} (tol 1e-8), S/v rtol 1e-9 {'ok' if ok else 'FAIL'}; "
        f"median {ms:.3f} ms (unsharded {ms0:.3f} ms; 5 runs, CUDA events)")
    if not ok:
        raise AssertionError(f"batch-sharded stacked64: max|dx| {dx:.3e}")
    profile_summary(f"stacked64 parallel_kernel on a batch axis of "
                    f"{BATCH_SHARDS}", lambda: est_s.solve(stacked), ms)

    phase("batch-sharded path: distributed on a 4 x 2 mesh")
    est_d = Estimator(model, method="distributed", mesh=repeated_mesh(4, 2),
                      options=DistributedOptions(nsub=NSUB, mode="discrete"))
    obs.reset()
    obs.enable()
    lqt_scan.reset_launch_count()
    sol = est_d.solve(stacked)
    shards = obs.snapshot()["counters"].get("distributed.shards")
    obs.disable()
    ref = Estimator(model, method="parallel_rts", options=ParallelOptions(
        nsub=NSUB, mode="discrete")).solve(stacked)
    dx = float((sol.x - ref.x).abs().max())
    ok = (bool(torch.allclose(sol.x, ref.x, rtol=DIST_TOL, atol=DIST_TOL))
          and shards == 2 * 4 * 2 and not lqt_scan.launch_count())
    ms = median_solve_ms(est_d, stacked)
    log(f"  MeshSpec(time=4, batch=2): distributed.shards {shards} (2 scans "
        f"x 4 shards x 2 batch shards), lqt_scan {lqt_scan.launch_count()}; "
        f"vs parallel_rts max|dx| {dx:.3e} (rtol=atol {DIST_TOL:.0e}) "
        f"{'ok' if ok else 'FAIL'}; median {ms:.3f} ms")
    if not ok:
        raise AssertionError(f"2-D mesh: max|dx| {dx:.3e}, shards {shards}")

    phase("batch-sharded path: trajectory engine on a batch axis of 2")
    lengths = [int(n) for n in np.random.default_rng(SEED).integers(
        *RAGGED_LENGTHS, size=RECORDS, endpoint=True)]
    host = [(ts[:n + 1].cpu().numpy(), yb[:n, i].cpu().numpy())
            for i, n in enumerate(lengths)]
    eng = TrajectoryEngine(model, batch=ENGINE_BATCH, method="parallel_kernel",
                           options=kopts, mesh=repeated_mesh(batch=2))
    shapes = recording_solves(eng.estimator)
    lqt_kernel.reset_launch_count()
    lqt_scan.reset_launch_count()
    t0 = time.perf_counter()
    tickets = [eng.submit(t, y) for t, y in host]
    eng.run()
    torch.cuda.synchronize()
    drain = time.perf_counter() - t0
    launches = lqt_scan.launch_count()
    got = dict(eng.collect(tickets=tickets))
    dx = max(float((got[t].x - r).abs().max())
             for t, r in zip(tickets, cell["ragged_ref"]))
    ok = (launches == 2 * eng.waves and not lqt_kernel.launch_count()
          and len(got) == RECORDS and dx < 1e-8)
    log(f"  {eng.waves} waves of {ENGINE_BATCH}: lqt_scan {launches} (want "
        f"waves x 2), lqt_combine {lqt_kernel.launch_count()}; every record "
        f"vs the ragged parallel_rts solve: max|dx| {dx:.3e} (tol 1e-8) "
        f"{'ok' if ok else 'FAIL'}; drain {drain * 1e3:.3f} ms wall")
    if not ok:
        raise AssertionError(f"sharded trajectory engine: {launches} "
                             f"launches for {eng.waves} waves, max|dx| "
                             f"{dx:.3e}")
    add(launches, [(n // NSUB + 1, b // 2) for b, n in shapes for _ in (0, 1)])

    phase("batch-sharded path: streaming engine on a batch axis of 2")
    smodel = WienerVelocityConfig(p0=1.0).model(device="cuda")
    N, dt = SHARD_STREAM_N, 0.1
    tsd = time_grid(0.0, N * dt, N, device="cuda")
    gm = torch.Generator(device="cuda").manual_seed(SEED + 2)
    _, yd = simulate_linear(smodel, tsd[:, None].expand(-1, STREAM_BATCH), gm)
    sts = tsd.cpu().numpy()
    ys = [y.numpy() for y in yd.movedim(1, 0).cpu()]
    eng = StreamingEngine(smodel, lag=STREAM_LAG, batch=STREAM_BATCH,
                          method="parallel_kernel", options=kopts,
                          mesh=repeated_mesh(batch=2))
    shapes = recording_solves(eng.estimator)
    lqt_kernel.reset_launch_count()
    lqt_scan.reset_launch_count()
    t0 = time.perf_counter()
    tids, windows, _ = stream_pass(eng, sts, ys)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = lqt_scan.launch_count()
    offline = Estimator(smodel, method="parallel_rts",
                        options=ParallelOptions(nsub=NSUB, mode="discrete"))
    worst = 0.0
    for k in range(0, STREAM_BATCH, STREAM_BATCH // 4):
        x = eng.estimate(tids[k]).x
        r = offline.solve(Problem.single(smodel, tsd, yd[:, k])).x.cpu()
        err = float((x[-STREAM_LAG - 1:] - r[-STREAM_LAG - 1:]).abs().max())
        worst = max(worst, err / float(r.abs().max()))
    ok = (launches == 2 * eng.waves == 2 * len(shapes)
          and not lqt_kernel.launch_count() and worst < 1e-9)
    log(f"  {STREAM_BATCH} tracks x {N} intervals, lag {STREAM_LAG}, chunks "
        f"of {STREAM_CHUNK}: {windows} windows in {eng.waves} waves, "
        f"{wall * 1e3:.3f} ms wall; lqt_scan {launches} (want waves x 2); "
        f"final windows vs offline parallel_rts: max|dx| / max|x| "
        f"{worst:.3e} (tol 1e-9) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"sharded streaming engine: {launches} "
                             f"launches for {eng.waves} waves, window error "
                             f"{worst:.3e}")
    add(launches, [(n // NSUB + 1, b // 2) for b, n in shapes for _ in (0, 1)])
    return out


# ---------------------------------------------------------------------------
# 3i'. the pairwise kernel as the combine of user scans (scan_combine_fn)
# ---------------------------------------------------------------------------

def user_scan_path(lqt_kernel, cell: dict) -> dict:
    """``scan_combine_fn()`` (the pairwise ``lqt_combine`` kernel as a
    ``core.pscan`` combine) in the two user scans it opens, on the
    estimation cell's single record (nx = 4, float64, 2049 scan
    elements): ``parallel_rts(..., combine_fn=scan_combine_fn())`` against
    the default ``parallel_rts`` (max|dx| < 1e-8, S and v at rtol 1e-9 /
    atol 1e-8), and ``sharded_scan(scan_combine_fn(), ...)`` of the
    backward pass's elements at P = USER_SCAN_SHARDS on a time mesh of
    cuda:0 against the plain ``suffix_scan`` (normwise < 1e-8); the exact
    kernel launches of each, predicted from T, and ms a path beside the
    plain combine's.  Returns each path's launch shapes for the kernel's
    report row."""
    from repro_torch.core import grid_lqt_from_linear
    from repro_torch.core.combine import lqt_combine
    from repro_torch.core.elements import (
        discrete_block_elements,
        terminal_element,
    )
    from repro_torch.core.parallel import parallel_rts
    from repro_torch.core.pscan import sharded_scan, suffix_scan
    from repro_torch.core.types import LQTElement
    from repro_torch.kernels.lqt_combine import scan_combine_fn

    grid = grid_lqt_from_linear(cell["model"], cell["ts"], cell["y1"])
    n = N_BLOCKS + 1
    P = USER_SCAN_SHARDS
    cut, local = n // P * P, n // P
    tail = n - cut
    shapes = {
        "parallel_rts": scan_lane_counts(n, 1),
        "sharded_scan": (P * scan_lane_counts(local, 1) + [1] * (P - 1)
                         + [local] * (P - 1) + scan_lane_counts(tail, 1)
                         + ([cut] if tail else []))}
    log(f"Wiener single record, T={N_BLOCKS} blocks x nsub={NSUB}, "
        f"discrete, float64: {n} scan elements; predicted lqt_combine "
        f"launches: parallel_rts one per combine of the suffix scan's tree "
        f"({len(shapes['parallel_rts'])}), sharded_scan at P = {P}: "
        f"{P} local scans of {local} ({P} x "
        f"{len(scan_lane_counts(local, 1))}), {P - 1} carry combines, "
        f"{P - 1} fix-ups, {'one stitch of the ' + str(tail) + '-element tail' if tail else 'no tail'} "
        f"({len(shapes['sharded_scan'])})")
    out = {}

    def counted(fn):
        lqt_kernel.reset_launch_count()
        got = fn()
        torch.cuda.synchronize()
        return got, lqt_kernel.launch_count()

    def rts_kernel():
        return parallel_rts(grid, NSUB, "discrete",
                            combine_fn=scan_combine_fn())

    def rts_plain():
        return parallel_rts(grid, NSUB, "discrete")

    sol, launches = counted(rts_kernel)
    ref = rts_plain()
    dx = float((sol.x - ref.x).abs().max())
    sv = all(torch.allclose(getattr(sol, f), getattr(ref, f), rtol=1e-9,
                            atol=1e-8) for f in ("S", "v"))
    ms, plain_ms = cuda_time_ms(rts_kernel, 5), cuda_time_ms(rts_plain, 5)
    log(f"  parallel_rts(combine_fn=scan_combine_fn()): lqt_combine "
        f"launches {launches} (predicted {len(shapes['parallel_rts'])}); "
        f"vs the default parallel_rts: max|dx| {dx:.3e} (tol 1e-8), S/v "
        f"within rtol 1e-9 atol 1e-8: {sv}; {ms:.3f} ms a solve vs "
        f"{plain_ms:.3f} ms with the plain combine (CUDA events, mean of 5 "
        f"after a warm-up)")
    if launches != len(shapes["parallel_rts"]) or not (dx < 1e-8 and sv):
        raise AssertionError("parallel_rts with the kernel combine: "
                             f"launches {launches}, max|dx| {dx:.3e}, S/v "
                             f"{sv}")
    out["user scans: parallel_rts"] = {
        "shapes": shapes["parallel_rts"], "nx": 4,
        "pairwise_launches": launches, "path_ms": ms,
        "path_plain_ms": plain_ms}

    blocks, _ = discrete_block_elements(grid, NSUB)
    last = terminal_element(grid)
    elems = LQTElement(*(torch.cat([a, t[None]]) for a, t in zip(blocks,
                                                                last)))
    mesh = repeated_mesh(time=P)

    def sharded_kernel():
        return sharded_scan(scan_combine_fn(), elems, mesh=mesh,
                            axis_name="time", reverse=True)

    def sharded_plain():
        return sharded_scan(lqt_combine, elems, mesh=mesh, axis_name="time",
                            reverse=True)

    got, launches = counted(sharded_kernel)
    want = suffix_scan(lqt_combine, elems)
    _, rel = compare(got, want)
    _, rel_plain = compare(sharded_plain(), want)
    ms, plain_ms = (cuda_time_ms(sharded_kernel, 5),
                    cuda_time_ms(sharded_plain, 5))
    scan_ms = cuda_time_ms(lambda: suffix_scan(lqt_combine, elems), 5)
    log(f"  sharded_scan(scan_combine_fn(), P = {P} on cuda:0): "
        f"lqt_combine launches {launches} (predicted "
        f"{len(shapes['sharded_scan'])}); vs the plain suffix_scan: "
        f"normwise {rel:.3e} (tol 1e-8; the plain combine sharded: "
        f"{rel_plain:.3e}); {ms:.3f} ms a scan vs {plain_ms:.3f} ms sharded "
        f"with the plain combine and {scan_ms:.3f} ms unsharded (CUDA "
        f"events, mean of 5 after a warm-up)")
    if launches != len(shapes["sharded_scan"]) or not rel < 1e-8:
        raise AssertionError(f"sharded_scan with the kernel combine: "
                             f"launches {launches}, normwise {rel:.3e}")
    out["user scans: sharded_scan"] = {
        "shapes": shapes["sharded_scan"], "nx": 4,
        "pairwise_launches": launches, "path_ms": ms,
        "path_plain_ms": plain_ms}
    return out


# ---------------------------------------------------------------------------
# 3k. time-varying Q on a long grid: the chunked grid factorisations
# ---------------------------------------------------------------------------

def factor_ms(fn, grid, chunk) -> str:
    """``fn`` over the matrices of ``grid`` in calls of at most ``chunk``
    matrices (None: the whole grid in one call): the median ms of 3 by
    CUDA events after a warm-up, or what the solver says when it refuses
    the batch (a measurement of its limit, not a gate)."""
    flat = grid.reshape((-1,) + grid.shape[-2:])

    def run():
        return [fn(part) for part in flat.split(chunk or flat.shape[0])]

    try:
        run()
    except RuntimeError as err:
        return f"refused ({str(err).splitlines()[0][:96]})"
    return f"{cuda_time_ms(run, 3):.3f}"


def eigh_batch_limit(n: int, dtype) -> int:
    """The largest batch of n x n matrices ``torch.linalg.eigh`` takes in
    one call on the card (bisection up to 2**16; a refusal is the
    solver's argument check, before any work)."""
    def takes(batch: int) -> bool:
        a = torch.eye(n, dtype=dtype, device="cuda").expand(batch, n, n)
        try:
            torch.linalg.eigh(a.contiguous())
        except RuntimeError:
            return False
        return True

    lo, hi = 1, 2 ** 16 + 1          # takes(lo); hi: past the probe
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if takes(mid) else (lo, mid)
    return lo


def long_grid_path(lqt_kernel, lqt_scan) -> dict:
    """The Wiener velocity model with Q(t) = Q (1 + 0.5 sin t), float64:
    (a) one record of LONG_BLOCKS x NSUB intervals, (b) RECORDS stacked
    records of N_BLOCKS x NSUB.  For each, ``simulate_linear`` on the card
    (the chunked square roots of Q(t)), ``Estimator.solve`` with
    ``parallel_kernel`` (one ``lqt_scan`` launch) and ``parallel_rts``
    (within 1e-8, S and v at rtol 1e-9 / atol 1e-8), ``om_cost_grid``
    (finite); the chunked square roots against the same Q grid factored
    on the CPU (normwise within LONG_SQRT_RTOL); each grid factorisation's
    ms at FACTOR_SWEEP's chunk sizes.  Returns the scans for the kernel's
    report row."""
    from repro_torch.configs.wiener_velocity import WienerVelocityConfig
    from repro_torch.core import (
        Estimator,
        KernelOptions,
        ParallelOptions,
        Problem,
        grid_lqt_from_linear,
        om_cost_grid,
        simulate_linear,
        time_grid,
    )
    from repro_torch.core import sde

    cfg = WienerVelocityConfig()
    base = cfg.model(dtype=torch.float64, device="cuda")
    Q0 = base.Q
    model = dataclasses.replace(
        base, Q=lambda t: Q0 * (1.0 + 0.5 * torch.sin(t)))
    step = (cfg.tf - cfg.t0) / (N_BLOCKS * NSUB)
    cells = {"single": (LONG_BLOCKS, 1),
             f"stacked{RECORDS}": (N_BLOCKS, RECORDS)}
    est_k = Estimator(model, method="parallel_kernel",
                      options=KernelOptions(nsub=NSUB, mode="discrete"))
    est_p = Estimator(model, method="parallel_rts",
                      options=ParallelOptions(nsub=NSUB, mode="discrete"))
    log(f"Wiener velocity with Q(t) = Q (1 + 0.5 sin t) (singular), "
        f"float64, dt {step:.4e}; on {card()}")
    t0 = time.perf_counter()
    limits = {n: eigh_batch_limit(n, torch.float64) for n in EIGH_PROBE_N}
    log(f"  the largest batch torch.linalg.eigh takes in one call, float64: "
        + ", ".join(f"n={n} {b}" for n, b in limits.items())
        + f" (probed up to {2 ** 16}; {time.perf_counter() - t0:.1f} s)")
    short = {k: v for k, v in limits.items() if v < sde.EIGH_CHUNK}
    if short:
        raise AssertionError(f"EIGH_CHUNK = {sde.EIGH_CHUNK} is past the "
                             f"batched eigh's limit at {short}")
    launches = 0
    for name, (blocks, R) in cells.items():
        N = blocks * NSUB
        ts = time_grid(cfg.t0, cfg.t0 + N * step, N, device="cuda")
        tsr = ts if R == 1 else ts[:, None].expand(-1, R)
        Qg = model._eval(model.Q, tsr[:-1])
        Rg = (base.R * (1.0 + 0.25 * torch.cos(tsr[:-1]))[..., None, None]
              ).contiguous()
        t0 = time.perf_counter()
        for label, fn, g in (("eigh of Q", torch.linalg.eigh, Qg),
                             ("pinv of Q", torch.linalg.pinv, Qg),
                             ("cholesky of R", torch.linalg.cholesky, Rg),
                             ("inv of R", torch.linalg.inv, Rg)):
            log(f"  {name}: {label}, {N * R} matrices, ms by chunk size "
                f"(EIGH_CHUNK = {sde.EIGH_CHUNK}): "
                + "; ".join(f"{c or 'whole grid'} {factor_ms(fn, g, c)}"
                            for c in FACTOR_SWEEP))
        log(f"  {name}: the sweep took {time.perf_counter() - t0:.1f} s")
        gm = torch.Generator(device="cuda").manual_seed(SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, y = simulate_linear(model, tsr, gm)
        torch.cuda.synchronize()
        sim_s = time.perf_counter() - t0
        problem = (Problem.single(model, ts, y) if R == 1 else
                   Problem.stacked(model, ts, y.movedim(1, 0)))
        log(f"  {name}: {N} intervals x {R} records ({N * R} grid "
            f"points), simulate_linear {sim_s:.2f} s (wall)")
        lqt_kernel.reset_launch_count()
        lqt_scan.reset_launch_count()
        sol, kernel_ms = timed_solve(est_k, problem)
        torch.cuda.synchronize()
        n_scan = lqt_scan.launch_count()
        launches += n_scan
        if n_scan != 1 or lqt_kernel.launch_count():
            raise AssertionError(
                f"{name}: expected 1 lqt_scan launch and no lqt_combine, "
                f"counted {n_scan} and {lqt_kernel.launch_count()}")
        ref, rts_ms = timed_solve(est_p, problem)
        dx = float((sol.x - ref.x).abs().max())
        ok = dx < 1e-8 and all(torch.allclose(
            getattr(sol, f), getattr(ref, f), rtol=1e-9, atol=1e-8)
            for f in ("S", "v"))
        grid = grid_lqt_from_linear(model, tsr, y)
        x = sol.x if R == 1 else sol.x.movedim(0, 1)        # (N+1, *R, nx)
        t0 = time.perf_counter()
        cost = om_cost_grid(grid, x)
        torch.cuda.synchronize()
        cost_ms = (time.perf_counter() - t0) * 1e3
        finite = all(bool(torch.isfinite(t).all())
                     for t in (sol.x, sol.S, sol.v, sol.cost, cost))
        log(f"  {name}: parallel_kernel {kernel_ms:.1f} ms, parallel_rts "
            f"{rts_ms:.1f} ms (first solves, CUDA events); max|dx| "
            f"{dx:.3e} (tol 1e-8), S/v within rtol 1e-9 atol 1e-8: {ok}; "
            f"om_cost_grid {cost_ms:.1f} ms (wall), cost "
            f"{float(cost.sum()):.6e} (the solve's "
            f"{float(sol.cost.sum()):.6e}), finite: {finite}")
        if not (ok and finite):
            raise AssertionError(f"{name}: the time-varying-Q solve failed "
                                 f"its gates")
        sqrt_ms = cuda_time_ms(lambda: sde._psd_sqrt(Qg), 3)
        got = sde._psd_sqrt(Qg)
        want = sde._psd_sqrt(Qg.cpu())
        rel = float((got.cpu() - want).abs().max() / want.abs().max())
        log(f"  {name}: _psd_sqrt (eigh in chunks of EIGH_CHUNK = "
            f"{sde.EIGH_CHUNK}) {sqrt_ms:.3f} ms on the card; vs the CPU: "
            f"normwise {rel:.3e} (tol {LONG_SQRT_RTOL:.0e})")
        if not rel <= LONG_SQRT_RTOL:
            raise AssertionError(f"{name}: chunked _psd_sqrt off the CPU's "
                                 f"by {rel:.3e}")
        del sol, ref, grid, x, cost, Qg, Rg, got, want, y, problem
        torch.cuda.empty_cache()
    return {"launches": launches, "nx": 4,
            "scans": [(LONG_BLOCKS + 1, 1), (N_BLOCKS + 1, RECORDS)],
            "shapes": (scan_lane_counts(LONG_BLOCKS + 1, 1)
                       + scan_lane_counts(N_BLOCKS + 1, RECORDS)),
            "pairwise_launches": 0}


# ---------------------------------------------------------------------------
# 3l. no tensor left to the garbage collector
# ---------------------------------------------------------------------------

def collector_path() -> None:
    """With Python's cyclic garbage collector disabled for the phase: one
    Wiener single solve (``parallel_kernel``, a private executable cache)
    and one COLLECT_ARCH prefill plus decode (``ServeEngine.generate``,
    full width and depth, bf16, seeded random weights made in the phase).
    Once every result (solution, estimator, cache, weights, engine, the
    generated requests) is deleted, ``torch.cuda.memory_allocated()`` is
    back at its value before them, and ``gc.collect()`` under
    ``gc.DEBUG_SAVEALL`` finds no tensor."""
    import gc

    from repro_torch.config import get_config
    from repro_torch.configs.wiener_velocity import WienerVelocityConfig
    from repro_torch.core import (
        Estimator,
        ExecutableCache,
        KernelOptions,
        Problem,
        simulate_linear,
        time_grid,
    )
    from repro_torch.models import transformer
    from repro_torch.serving import Request, ServeEngine

    wcfg = WienerVelocityConfig()
    model = wcfg.model(dtype=torch.float64, device="cuda")
    N = N_BLOCKS * NSUB
    ts = time_grid(wcfg.t0, wcfg.tf, N, device="cuda")
    _, y = simulate_linear(model, ts,
                           torch.Generator(device="cuda").manual_seed(SEED))
    cfg = get_config(COLLECT_ARCH)
    reqs = lm_requests(cfg, Request, COLLECT_BATCH, COLLECT_NEW)
    gc.collect()
    gc.disable()
    try:
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        est = Estimator(model, method="parallel_kernel",
                        options=KernelOptions(nsub=NSUB, mode="discrete"),
                        cache=ExecutableCache())
        sol = est.solve(Problem.single(model, ts, y))
        params = transformer.init(
            cfg, torch.Generator(device="cuda").manual_seed(SEED))
        engine = ServeEngine(cfg, params, batch=COLLECT_BATCH,
                             max_len=LM_PROMPT + COLLECT_NEW)
        done = engine.generate(reqs)
        torch.cuda.synchronize()
        during = torch.cuda.memory_allocated()
        ok = bool(torch.isfinite(sol.x).all()) and all(
            r.out.shape == (COLLECT_NEW,) for r in done)
        del est, sol, params, engine, done
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
        gc.set_debug(gc.DEBUG_SAVEALL)
        found = gc.collect()
        tensors = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
        n_tensors = len(tensors)
        del tensors
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    log(f"  gc disabled: a Wiener single solve and a {cfg.name} prefill of "
        f"{COLLECT_BATCH} x {LM_PROMPT} plus {COLLECT_NEW} tokens; "
        f"memory_allocated before {before} B, with the results {during} B, "
        f"after deleting them {after} B (difference {after - before} B); "
        f"gc.collect() then found {found} objects, {n_tensors} of them "
        f"tensors")
    if not (ok and after == before and n_tensors == 0):
        raise AssertionError(
            f"collector phase: outputs ok {ok}, {after - before} B still "
            f"allocated, {n_tensors} tensors left to the collector")


# ---------------------------------------------------------------------------
# 3j. the scan kernel at the paths' scans; lqt_combine at the per-level shapes
# ---------------------------------------------------------------------------

def per_level_suffix_scan(elems):
    """The per-level design the scan kernel replaces, as the port ran it
    before: lane-major copies of the elements, a flip, one pairwise-kernel
    launch per tree level over dense copies of the level's slices
    (``core.pscan.associative_scan`` over the lane axis), interleaves, and
    the flip and layout back."""
    from repro_torch.core.pscan import associative_scan
    from repro_torch.kernels.lqt_combine import ops

    lanes = tuple(torch.flip(a, (-1,)) for a in ops._to_lanes(elems))
    out = associative_scan(
        lambda a, b: ops._combine_lanes(b, a, block_size=128), lanes,
        axis=-1)
    return ops._from_lanes(tuple(torch.flip(a, (-1,)) for a in out))


def scan_timing(g, lqt_scan, lqt_ref, paths: dict) -> dict:
    """The report row of ``lqt_scan``: its time summed over every path's
    scans (CUDA events around a CUDA-graph replay of back-to-back scans, or
    around eager calls where capture is refused), beside eager calls, the
    plain scan, its own bound and the summed per-launch bound of the tree's
    combines (the per-level design's yardstick); per path too.  Then a depth
    sweep over one record."""
    row = {"name": "lqt_scan", "route": "cuda",
           "source": "src/repro_torch/kernels/lqt_combine/csrc/lqt_scan.cu",
           "replaces": "src/repro/kernels/lqt_combine/kernel.py:115",
           "launches": 0, "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
           "bound_ms": 0.0, "bound_by": None, "library_ms": None,
           "eager_ms": 0.0, "per_combine_bound_ms": 0.0, "timing": None,
           "paths": {}}
    def measure_scan(n, R, nx):
        e = random_elems(n, R, nx, torch.float64, g)
        got = lqt_scan.lqt_scan(e, reverse=True)
        want = lqt_ref.lqt_scan_ref(e, reverse=True)
        err = compare(got, want)[0]
        grid = dict(lqt_scan.last_launch)

        def kern():
            return lqt_scan.lqt_scan(e, reverse=True)

        def plain():
            return lqt_ref.lqt_scan_ref(e, reverse=True)

        def per_level():
            return per_level_suffix_scan(e)

        ms, how = scan_time_ms(kern, 20)
        eager = cuda_time_ms(kern, 20)
        plain_ms = cuda_time_ms(plain, 3)
        old_ms, old_how = scan_time_ms(per_level, 5)
        old_eager = cuda_time_ms(per_level, 5)
        return (err, grid, ms, how, eager, plain_ms, old_ms, old_how,
                old_eager)

    methods, measured = set(), {}
    for path, info in paths.items():
        nx = info["nx"]
        t = dict.fromkeys(("ms", "eager_ms", "plain_ms", "bound_ms",
                           "per_level_ms", "per_level_eager_ms",
                           "max_abs_err"), 0.0)
        bound_by = set()
        for n, R in sorted(set(info["scans"])):
            mult = info["scans"].count((n, R))
            if (n, R, nx) not in measured:      # a scan another path ran
                measured[n, R, nx] = measure_scan(n, R, nx)
            (err, grid, ms, how, eager, plain_ms, old_ms, old_how,
             old_eager) = measured[n, R, nx]
            combines = sum(scan_lane_counts(n, R))
            nbytes = scan_bytes(n, R, nx, 8)
            b_ms, b_by = bound(nbytes, combines * combine_flops(nx),
                               torch.float64)
            log(f"  {path}: scan of {n} elements x {R} records (nx={nx}, "
                f"float64, {combines} combines), x{mult} on the path: "
                f"{ms:.5f} ms ({how}; eager calls {eager:.5f} ms), plain "
                f"scan {plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}: "
                f"{nbytes / 1e6:.2f} MB, "
                f"{combines * combine_flops(nx) / 1e6:.1f} MFLOP), "
                f"{b_ms / ms:.3f} of the bound; grid {grid}; the per-level "
                f"design (launches and copies) {old_ms:.5f} ms ({old_how}; "
                f"eager calls {old_eager:.5f} ms)")
            methods.add(how)
            bound_by.add(b_by)
            t["ms"] += mult * ms
            t["eager_ms"] += mult * eager
            t["plain_ms"] += mult * plain_ms
            t["per_level_ms"] += mult * old_ms
            t["per_level_eager_ms"] += mult * old_eager
            t["bound_ms"] += mult * b_ms
            t["max_abs_err"] = max(t["max_abs_err"], err)
        shapes = info["shapes"]
        pc_ms, _ = bound(sum(B * combine_bytes(nx, 8) for B in shapes),
                         sum(B * combine_flops(nx) for B in shapes),
                         torch.float64)
        by = "bytes" if "bytes" in bound_by else "operations"
        log(f"    {path} path, {info['launches']} scans: {t['ms']:.4f} ms "
            f"(eager calls {t['eager_ms']:.4f} ms), plain {t['plain_ms']:.4f}"
            f" ms, bound {t['bound_ms']:.5f} ms ({by}; "
            f"{t['bound_ms'] / t['ms']:.3f} reached), the per-level design's "
            f"bound (its {len(shapes)} launches' combines) {pc_ms:.5f} ms; "
            f"the per-level design itself {t['per_level_ms']:.4f} ms (eager "
            f"calls {t['per_level_eager_ms']:.4f} ms)")
        row["paths"][path] = {"launches": info["launches"], "ms": t["ms"],
                              "eager_ms": t["eager_ms"],
                              "plain_ms": t["plain_ms"],
                              "bound_ms": t["bound_ms"], "bound_by": by,
                              "per_combine_bound_ms": pc_ms,
                              "per_level_ms": t["per_level_ms"],
                              "per_level_eager_ms": t["per_level_eager_ms"]}
        row["launches"] += info["launches"]
        row["max_abs_err"] = max(row["max_abs_err"], t["max_abs_err"])
        for k in ("ms", "eager_ms", "plain_ms", "bound_ms"):
            row[k] += t[k]
        row["per_combine_bound_ms"] += pc_ms
        row["bound_by"] = ("bytes" if "bytes" in (row["bound_by"], by)
                           else by)
    row["timing"] = "+".join(sorted(methods))
    for nx in (4, 5):
        pts = []
        for n in SCAN_SWEEP:
            e = random_elems(n, 1, nx, torch.float64, g)
            ms, how = scan_time_ms(lambda: lqt_scan.lqt_scan(e, reverse=True),
                                   30)
            pts.append((n, ms))
        levels = np.array([n.bit_length() - 1 for n, _ in pts], float)
        slope, icept = np.polyfit(levels, np.array([ms for _, ms in pts]), 1)
        log(f"  depth sweep, one record, nx={nx}, float64 ({how}): "
            + ", ".join(f"n={n} {ms:.5f}" for n, ms in pts)
            + f" ms; least-squares slope {slope * 1e3:.3f} us per tree level"
            f" (a down and an up phase), intercept {icept * 1e3:.3f} us")
        row[f"sweep_us_per_level_nx{nx}"] = slope * 1e3
    return row


def combine_timing(g, lqt_kernel, lqt_ref, paths: dict) -> dict:
    """The report row of the pairwise ``lqt_combine``, summed over the
    launch shapes of each path (CUDA events around a CUDA-graph replay of
    back-to-back launches), beside the same launches called eagerly, the
    profiler's summed kernel time, the plain version and the bound.  The
    row's own numbers are those of the paths that launch it (the user
    scans of ``scan_combine_fn``); the estimation paths run their scans
    through ``lqt_scan`` (0 launches), and their per-level scan's shapes
    are summed under ``per_level_*``."""
    row = {"name": "lqt_combine", "route": "cuda",
           "source": "src/repro_torch/kernels/lqt_combine/csrc/"
                     "lqt_combine.cu",
           "replaces": "src/repro/kernels/lqt_combine/kernel.py:115",
           "launches": 0, "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
           "bound_ms": 0.0, "bound_by": None, "library_ms": None,
           "eager_ms": 0.0, "profiler_ms": 0.0, "per_level_ms": 0.0,
           "per_level_plain_ms": 0.0, "per_level_bound_ms": 0.0,
           "note": "launched by scan_combine_fn's user scans; the "
                   "estimation paths' scans run in lqt_scan, and "
                   "per_level_* time the pairwise kernel at the per-level "
                   "scan's launch shapes there",
           "paths": {}}
    for path, info in paths.items():
        shapes, nx = info["shapes"], info["nx"]
        t = dict.fromkeys(("ms", "eager_ms", "profiler_ms", "plain_ms",
                           "bytes", "flops", "max_abs_err"), 0.0)
        for B in sorted(set(shapes)):
            mult = shapes.count(B)
            ops1, ops2 = random_pairs(nx, B, torch.float64, g)
            got = lqt_kernel.lqt_combine_lanes(ops1, ops2)
            want = lqt_ref.lqt_combine_lanes_ref(ops1, ops2)
            t["max_abs_err"] = max(t["max_abs_err"], compare(got, want)[0])

            def kern():
                return lqt_kernel.lqt_combine_lanes(ops1, ops2)

            def plain():
                return lqt_ref.lqt_combine_lanes_ref(ops1, ops2)

            t["ms"] += mult * graph_time_ms(kern, 50)
            t["eager_ms"] += mult * cuda_time_ms(kern, 50)
            t["profiler_ms"] += mult * device_time_ms(kern, 20)
            t["plain_ms"] += mult * cuda_time_ms(plain, 10)
            t["bytes"] += mult * B * combine_bytes(nx, 8)
            t["flops"] += mult * B * combine_flops(nx)
            del ops1, ops2, got, want
        b_ms, b_by = bound(t["bytes"], t["flops"], torch.float64)
        log(f"  {path} path's per-level shapes (nx={nx}, float64): "
            f"{len(shapes)} launches, lanes per launch {sorted(set(shapes))}")
        log(f"    summed over those launches: kernel {t['ms']:.4f} ms "
            f"(CUDA events, graph replay; eager calls {t['eager_ms']:.4f} "
            f"ms; profiler {t['profiler_ms']:.4f} ms), plain version "
            f"{t['plain_ms']:.4f} ms, bound {b_ms:.5f} ms ({b_by}; "
            f"{t['bytes']:.0f} B, {t['flops']:.0f} FLOP): "
            f"{b_ms / t['ms']:.3f} of the bound")
        row["paths"][path] = {
            "launches": info["pairwise_launches"],
            "per_level_launches": len(shapes), "ms": t["ms"],
            "eager_ms": t["eager_ms"], "profiler_ms": t["profiler_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": b_ms, "bound_by": b_by}
        for k in ("path_ms", "path_plain_ms"):
            if k in info:
                row["paths"][path][k] = info[k]
        row["max_abs_err"] = max(row["max_abs_err"], t["max_abs_err"])
        if not info["pairwise_launches"]:
            row["per_level_ms"] += t["ms"]
            row["per_level_plain_ms"] += t["plain_ms"]
            row["per_level_bound_ms"] += b_ms
            continue
        row["launches"] += info["pairwise_launches"]
        for k in ("ms", "eager_ms", "profiler_ms", "plain_ms"):
            row[k] += t[k]
        row["bound_ms"] += b_ms
        row["bound_by"] = ("bytes" if "bytes" in (row["bound_by"], b_by)
                           else b_by)
    for nx, B in ((5, 65536), (4, 65536), (4, 1024), (4, 1)):
        ops1, ops2 = random_pairs(nx, B, torch.float64, g)

        def kern():
            return lqt_kernel.lqt_combine_lanes(ops1, ops2)

        ms = graph_time_ms(kern, 100)
        nbytes = B * combine_bytes(nx, 8)
        log(f"  one launch, nx={nx}, B={B} lanes: {ms:.5f} ms (graph "
            f"replay; eager {cuda_time_ms(kern, 100):.5f} ms, profiler "
            f"{device_time_ms(kern, 50):.5f} ms), bound "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.5f} ms "
            f"({nbytes / ms / 1e9:.3f} TB/s achieved)")
    return row


# ---------------------------------------------------------------------------
# 4-6. language-model serving path
# ---------------------------------------------------------------------------

def lm_requests(cfg, Request, n=LM_REQUESTS, new=LM_NEW):
    rng = np.random.default_rng(SEED)
    return [Request(prompt=rng.integers(0, cfg.vocab_size, LM_PROMPT)
                    .astype(np.int32), max_new_tokens=new)
            for _ in range(n)]


def lm_kernel_launches(cfg, runs: int) -> dict:
    """Each LM kernel's launches when every layer's mixer runs ``runs``
    times in all: attention for attn and hybrid mixers, SSD for ssm and
    hybrid ones."""
    return {"flash_attention": runs if cfg.mixer in ("attn", "hybrid") else 0,
            "ssd_chunked": runs if cfg.mixer in ("ssm", "hybrid") else 0}


def counted_launches(fa_kernel, ssd_kernel, want: dict, variant: str,
                     label: str) -> dict:
    """The two LM kernels' launches since their counts were reset, held to
    ``want`` (``{kernel: launches}``), every one of ``variant``."""
    launches = {"flash_attention": fa_kernel.launch_count(),
                "ssd_chunked": ssd_kernel.launch_count()}
    of_variant = {"flash_attention": fa_kernel.launch_count(variant),
                  "ssd_chunked": ssd_kernel.launch_count(variant)}
    log(f"{label} launches: {launches}, of the {variant} variant "
        f"{of_variant}; expected {want}")
    if launches != want or of_variant != want:
        raise AssertionError(f"{label}: launches {launches} ({variant} "
                             f"{of_variant}), expected {want}, all {variant}")
    return launches


@contextlib.contextmanager
def moe_calls(routings: dict | None = None, label: str | None = None,
              replay: dict | None = None):
    """While active, each call of ``models.moe.moe_forward`` records its
    routing (``moe.route`` run again on the call's input, outside the
    layer) in ``routings`` under its layer's key (the address of its
    router weight), and runs inside a ``record_function`` range named
    ``label``.  With ``replay``, routings recorded so on another pass, each
    call takes that pass's expert choices for its layer instead of its own
    top k (its gates still come from its own router), so that two paths
    are compared at the same routing and a near-tie that flips an expert
    choice does not move their difference."""
    from repro_torch.models import moe

    forward = moe.moe_forward

    def wrapped(params, x, cfg):
        key = params["router"].data_ptr()
        if routings is not None:
            with torch.no_grad():
                routings[key] = moe.route(
                    params, x.detach().reshape(-1, x.shape[-1]), cfg)
        idx = None if replay is None else replay[key].idx
        if label is None:
            return forward(params, x, cfg, idx)
        with torch.profiler.record_function(label):
            return forward(params, x, cfg, idx)

    moe.moe_forward = wrapped
    try:
        yield
    finally:
        moe.moe_forward = forward


def routing_flips(a: dict, b: dict, experts: int) -> list:
    """Per MoE layer: how many (token, k) expert choices of routing ``a``
    routing ``b`` did not make."""
    out = []
    for ra, rb in zip(a.values(), b.values(), strict=True):
        ma = torch.zeros(ra.idx.shape[0], experts, device=ra.idx.device)
        ma.scatter_(1, ra.idx, 1.0)
        mb = torch.zeros_like(ma).scatter_(1, rb.idx, 1.0)
        out.append(int((ma > mb).sum()))
    return out


def serving_path(cfg, params, fa_kernel, ssd_kernel) -> dict:
    """Returns the launch counts of the two LM kernels on the path."""
    from repro_torch.serving import Request, ServeEngine

    engine = ServeEngine(cfg, params, batch=LM_BATCH, max_len=LM_MAX_LEN)
    reqs = lm_requests(cfg, Request)
    waves = -(-LM_REQUESTS // LM_BATCH)
    fa_kernel.reset_launch_count()
    ssd_kernel.reset_launch_count()
    t0 = time.perf_counter()
    done = engine.generate(reqs)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    # bf16 at these widths: every launch is the tensor-core variant
    launches = counted_launches(
        fa_kernel, ssd_kernel, lm_kernel_launches(
            cfg, cfg.num_layers * waves), "mma",
        f"main path ({waves} waves)")
    log(f"  first generate (kernels already built) {first_s:.2f} s")
    for r in done:
        if r.out.shape != (LM_NEW,) or not (
                (r.out >= 0) & (r.out < cfg.vocab_size)).all():
            raise AssertionError(f"bad output tokens {r.out}")
    log(f"  {len(done)} requests, {LM_NEW} tokens each; first request's "
        f"tokens {r.out[:8].tolist()}...")

    # timed second run of the whole path (everything warm)
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    done = engine.generate(lm_requests(cfg, Request))
    stop.record()
    torch.cuda.synchronize()
    gen_ms = start.elapsed_time(stop)
    new_tokens = sum(len(r.out) for r in done)
    log(f"  generate: {gen_ms:.1f} ms for {LM_REQUESTS} requests x "
        f"{LM_PROMPT} prompt tokens, {new_tokens} new tokens -> "
        f"{new_tokens / gen_ms * 1e3:.1f} new tokens/s, "
        f"{(LM_REQUESTS * LM_PROMPT + new_tokens) / gen_ms * 1e3:.0f} "
        f"tokens/s with the prompts (CUDA events)")

    toks = torch.as_tensor(np.stack([r.prompt for r in done[:LM_BATCH]]),
                           dtype=torch.int64, device="cuda")
    times = []
    for _ in range(3):
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        start.record()
        logits, caches = engine._prefill(toks)
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    prefill_ms = statistics.median(times)
    if tuple(logits.shape) != (LM_BATCH, 1, cfg.padded_vocab) or not bool(
            torch.isfinite(logits[..., :cfg.vocab_size]).all()):
        raise AssertionError("prefill logits not finite or misshapen")
    log(f"  prefill: median {prefill_ms:.3f} ms per wave of {LM_BATCH} x "
        f"{LM_PROMPT} tokens over 3 runs ({LM_BATCH * LM_PROMPT / prefill_ms * 1e3:.0f} "
        f"tokens/s)")
    cur = torch.argmax(logits[:, -1], dim=-1)
    first_logits = logits[:, -1].float().cpu()
    steps = []
    for _ in range(LM_NEW - 1):
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        start.record()
        logits, caches = engine._decode(cur, caches)
        cur = torch.argmax(logits, dim=-1)
        stop.record()
        torch.cuda.synchronize()
        steps.append(start.elapsed_time(stop))
    decode_ms = statistics.median(steps)
    log(f"  decode: median {decode_ms:.3f} ms per step of {LM_BATCH} tokens "
        f"over {len(steps)} steps (min {min(steps):.3f}, max "
        f"{max(steps):.3f}; {LM_BATCH / decode_ms * 1e3:.1f} tokens/s)")
    SERVED[cfg.name] = {"prefill_ms": prefill_ms, "decode_ms": decode_ms,
                        "new_per_s": new_tokens / gen_ms * 1e3,
                        "tokens": [r.out for r in done],
                        "logits": first_logits}

    if cfg.is_moe:
        routings = {}
        with moe_calls(routings):
            engine._prefill(toks)
        drops = [float((~r.keep).float().mean()) for r in routings.values()]
        r = next(iter(routings.values()))
        log(f"  MoE dispatch at prefill ({LM_BATCH * LM_PROMPT} tokens, "
            f"top {cfg.moe_topk} of {cfg.moe_experts}, capacity factor "
            f"{cfg.moe_capacity_factor}): {r.cap} slots per expert; dropped "
            f"fraction of assignments per layer "
            f"{[round(d, 5) for d in drops]}, mean "
            f"{statistics.mean(drops):.5f}, max {max(drops):.5f}")
        del routings, r

    phase("serving profile")
    share = "moe_forward" if cfg.is_moe else None
    with moe_calls(label=share):
        profile_summary("prefill (one wave)", lambda: engine._prefill(toks),
                        prefill_ms, share)
        profile_summary("decode step", lambda: engine._decode(cur, caches),
                        decode_ms, share)
    return launches


def first_layers(tree: dict, n: int) -> dict:
    """The first ``n`` layers of a tree stacked over layers (views)."""
    return {k: (first_layers(v, n) if isinstance(v, dict) else v[:n])
            for k, v in tree.items()}


def cross_path(cfg, params, layers: int | None = None) -> None:
    """Kernel path vs plain path on the same weights in float32 (the first
    ``layers`` layers when given), one wave; for an MoE model the plain
    path takes the kernel path's expert choices (``moe_calls``), and the
    expert choices that its own routing would make otherwise are counted
    per layer."""
    from repro_torch.models import transformer
    from repro_torch.serving import Request

    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                num_layers=layers or cfg.num_layers)

    def to32(tree):
        return ({k: to32(v) for k, v in tree.items()}
                if isinstance(tree, dict) else tree.float())

    if layers is not None:
        params = {**params, "layers": first_layers(params["layers"], layers)}
    p32 = to32(params)
    reqs = lm_requests(cfg, Request)[:LM_BATCH]
    toks = torch.as_tensor(np.stack([r.prompt for r in reqs]),
                           dtype=torch.int64, device="cuda")
    out, routings = {}, {}
    for use_kernel in (True, False):
        routings[use_kernel] = {}
        with moe_calls(routings[use_kernel] if cfg.is_moe else None,
                       replay=None if use_kernel else routings[True]):
            logits, _ = transformer.prefill(p32, {"tokens": toks}, cfg32,
                                            LM_MAX_LEN, use_kernel=use_kernel)
        out[use_kernel] = logits[:, -1, :cfg.vocab_size]
        torch.cuda.synchronize()
    if cfg.is_moe:
        log(f"  routing, kernel path vs plain path: expert choices that "
            f"differ per layer {routing_flips(routings[True], routings[False], cfg.moe_experts)} "
            f"of {LM_BATCH * LM_PROMPT * cfg.moe_topk} (the plain path "
            f"takes the kernel path's)")
    err = float((out[True] - out[False]).abs().max())
    scale = float(out[False].abs().max())
    tok_k = torch.argmax(out[True], dim=-1)
    tok_p = torch.argmax(out[False], dim=-1)
    same = bool((tok_k == tok_p).all())
    log(f"  float32 prefill logits, kernel path vs plain path, "
        f"{LM_BATCH} x {LM_PROMPT} tokens: max abs err {err:.3e}, "
        f"relative to max|logit| {err / scale:.3e} (tol {CROSS_RTOL:.0e}); "
        f"first tokens equal: {same} ({tok_k.tolist()})")
    if not (err <= CROSS_RTOL * scale and same):
        raise AssertionError("kernel path disagrees with the plain path")


# ---------------------------------------------------------------------------
# 5b-5c. language-model training path
# ---------------------------------------------------------------------------

def remat_forwards(cfg) -> int:
    """How many times each layer's forward runs in one ``train_loss`` and
    its backward pass: L layers once, again for ``remat`` or the group
    checkpoint (its recompute), and L - L / g more for both together (a
    group's recompute stops at its last layer's input, then each layer's
    own checkpoint recomputes it).  The group checkpoint is taken when
    ``remat_group`` divides and is below the depth and the layers are not
    unrolled."""
    n, g = cfg.num_layers, cfg.remat_group
    grouped = bool(g) and n % g == 0 and n > g and not cfg.unroll_layers
    runs = n * (2 if cfg.remat or grouped else 1)
    if cfg.remat and grouped:
        runs += n - n // g
    return runs


class _TimedPipeline:
    """The LM pipeline with a CUDA event recorded as each step asks for
    its batch (the step's start on the card's stream)."""

    def __init__(self, pipe, starts):
        self.pipe, self.starts = pipe, starts

    def batch_at(self, step):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.starts[step + 1] = ev
        return self.pipe.batch_at(step)


def _step_recorder(ends, metrics):
    """A ``Trainer.on_step`` that keeps each step's metrics and records a
    CUDA event after its update (before any checkpoint)."""
    def on_step(step, m):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        ends[step], metrics[step] = ev, m
    return on_step


def _trainer_log(lines):
    def log_fn(msg):
        lines.append(msg)
        log(f"    {msg}")
    return log_fn


def training_path(cfg, fa_kernel, ssd_kernel, workdir: Path) -> dict:
    """``Trainer.run`` on hymba-1.5b at full width and depth in bf16, then
    a resume; returns the two LM kernels' launches on the path."""
    import shutil
    import tempfile

    from repro_torch import tree
    from repro_torch.config import TrainConfig
    from repro_torch.models import transformer
    from repro_torch.train import (Trainer, adamw_update, cosine_schedule,
                                   make_train_step)
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.data import LMDataPipeline

    tcfg = TrainConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                       microbatches=TRAIN_MICRO, learning_rate=3e-4,
                       warmup_steps=1, total_steps=TRAIN_TOTAL, log_every=1,
                       checkpoint_every=TRAIN_STEPS, keep_checkpoints=1,
                       seed=SEED)
    pipe = LMDataPipeline(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                          global_batch=TRAIN_BATCH, seed=SEED)
    tokens = TRAIN_SEQ * TRAIN_BATCH
    per_step = TRAIN_MICRO * remat_forwards(cfg)
    log(f"{cfg.name}: {cfg.param_count() / 1e9:.3f} B parameters, "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} = {tokens} tokens a step in "
        f"{TRAIN_MICRO} microbatches; remat per layer and in groups of "
        f"{cfg.remat_group}: each layer's forward runs "
        f"{remat_forwards(cfg) / cfg.num_layers:.3f} times per "
        f"microbatch, so each LM kernel launches {per_step} times a step")
    ckpt_dir = Path(tempfile.mkdtemp(prefix="train_ckpt_", dir=workdir))
    total_mem = torch.cuda.get_device_properties(0).total_memory
    try:
        starts, ends, step_metrics = {}, {}, {}
        fa_kernel.reset_launch_count()
        ssd_kernel.reset_launch_count()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = Trainer(cfg=cfg, tcfg=tcfg,
                          pipeline=_TimedPipeline(pipe, starts),
                          ckpt_dir=str(ckpt_dir), log_fn=_trainer_log([]),
                          device="cuda",
                          on_step=_step_recorder(ends, step_metrics))
        params, opt, metrics = trainer.run(steps=TRAIN_STEPS)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = counted_launches(
            fa_kernel, ssd_kernel,
            lm_kernel_launches(cfg, per_step * TRAIN_STEPS), "mma",
            f"main path ({TRAIN_STEPS} steps)")
        log(f"  Trainer.run {run_s:.1f} s (init and the checkpoint "
            f"included)")
        if sorted(step_metrics) != list(range(1, TRAIN_STEPS + 1)):
            raise AssertionError(f"steps run: {sorted(step_metrics)}")
        ms = {}
        for n, m in sorted(step_metrics.items()):
            loss, gnorm, lr = (float(m[k]) for k in ("loss", "grad_norm",
                                                     "lr"))
            ms[n] = starts[n].elapsed_time(ends[n])
            log(f"  step {n}: {ms[n]:.1f} ms (CUDA events), "
                f"{tokens / ms[n] * 1e3:.0f} tokens/s, loss {loss:.4f}, "
                f"grad_norm {gnorm:.4f}, lr {lr:.2e}")
            if not (np.isfinite(loss) and np.isfinite(gnorm)):
                raise AssertionError(f"step {n}: loss {loss}, grad_norm "
                                     f"{gnorm}")
        later = [ms[n] for n in range(2, TRAIN_STEPS + 1)]
        step_ms = statistics.median(later)
        log(f"  steps 2..{TRAIN_STEPS}: median {step_ms:.1f} ms (min "
            f"{min(later):.1f}, max {max(later):.1f}), "
            f"{tokens / step_ms * 1e3:.0f} tokens/s; peak memory "
            f"{peak / 1e9:.2f} GB of {total_mem / 1e9:.2f} GB")
        if peak >= total_mem:
            raise AssertionError("peak memory exceeds the card")

        path = ckpt.latest_checkpoint(str(ckpt_dir))
        save_s = [round(sec, 2) for _, _, sec in trainer.saves]
        nbytes = os.path.getsize(path)
        t0 = time.perf_counter()
        step, (p2, o2) = ckpt.restore_checkpoint(path, (params, opt))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        same = step == TRAIN_STEPS and all(
            a.dtype == b.dtype and torch.equal(a, b) for a, b in
            zip(tree.leaves((params, opt)), tree.leaves((p2, o2))))
        log(f"  checkpoint {Path(path).name}: {nbytes / 1e9:.3f} GB, saved "
            f"in {save_s} s, restored in {restore_s:.2f} s; step "
            f"{step}, params and optimizer state equal bit for bit: {same}")
        if not same:
            raise AssertionError("restored checkpoint differs from the "
                                 "trained state")
        del p2, o2
        torch.cuda.empty_cache()

        # the AdamW update alone, on float32 gradients of the params' shape
        grads = tree.tree_map(
            lambda p: torch.full(p.shape, 1e-3, dtype=torch.float32,
                                 device=p.device), params)
        sched = cosine_schedule(tcfg)
        adamw_ms = cuda_time_ms(lambda: adamw_update(grads, opt, tcfg, sched),
                                3)
        state_bytes = sum(t.numel() * t.element_size()
                          for t in tree.leaves((params, opt, grads)))
        log(f"  AdamW update: {adamw_ms:.2f} ms (CUDA events, mean of 3) over "
            f"{state_bytes / 1e9:.2f} GB of params, state and gradients "
            f"(one read of each: {state_bytes / HBM_BYTES_PER_S * 1e3:.2f} "
            f"ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
        del grads

        phase("training profile")
        step_fn = make_train_step(cfg, tcfg, lambda p, b: transformer.
                                  train_loss(p, b, cfg, use_kernel=True))
        batch = tree.tree_map(lambda t: t.cuda(), pipe.batch_at(TRAIN_STEPS))
        busy = profile_summary("train step",
                               lambda: step_fn(params, opt, batch), step_ms)
        del params, opt, metrics, step_fn, batch
        torch.cuda.empty_cache()
        calls = cfg.num_layers * TRAIN_MICRO
        for name, ms_ in plain_backward_ms(
                cfg, TRAIN_BATCH // TRAIN_MICRO).items():
            log(f"  {name}: {ms_:.2f} ms a call (CUDA events), x{calls} a "
                f"step = {ms_ * calls:.1f} ms, {ms_ * calls / busy:.3f} of "
                f"the profiled step's busy time")
        torch.cuda.empty_cache()

        phase("training path: resume from the step-6 checkpoint")
        lines2, later = [], {}
        resumer = Trainer(cfg=cfg, tcfg=tcfg, pipeline=pipe,
                          ckpt_dir=str(ckpt_dir), log_fn=_trainer_log(lines2),
                          device="cuda", on_step=_step_recorder({}, later))
        _, opt, metrics = resumer.run()
        resumed = (resumer.start_step == TRAIN_STEPS
                   and any("resumed" in x for x in lines2))
        log(f"  resumed: {resumed}; steps {sorted(later)}; "
            f"opt.step {int(opt.step)}; checkpoints left "
            f"{sorted(os.listdir(ckpt_dir))}")
        if not (resumed and int(opt.step) == TRAIN_TOTAL
                and sorted(later) == list(
                    range(TRAIN_STEPS + 1, TRAIN_TOTAL + 1))
                and all(bool(torch.isfinite(m["loss"]))
                        and bool(torch.isfinite(m["grad_norm"]))
                        for m in later.values())):
            raise AssertionError("the resumed run did not continue to "
                                 f"step {TRAIN_TOTAL}")
        del opt, metrics
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def plain_backward_ms(cfg, B: int) -> dict:
    """Per call, at batch ``B`` of the training shape: the backward passes
    of ``attention_trainable`` and ``ssd_trainable`` (autograd through
    ``mha_ref`` and ``ssd_scan_chunked``, their forward recomputed) alone,
    by CUDA events."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import mha_ref
    from repro_torch.kernels.ssd import ssd_scan_chunked

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def r(*shape, dtype=torch.bfloat16, fn=lambda t: t):
        return fn(torch.randn(shape, generator=gen, device="cuda")).to(
            dtype).requires_grad_()

    L = TRAIN_SEQ
    q = r(B, cfg.num_heads, L, cfg.hd)
    k, v = (r(B, cfg.num_kv_heads, L, cfg.hd) for _ in range(2))
    go = r(B, cfg.num_heads, L, cfg.hd).detach()
    H, P, G, S = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups,
                  cfg.ssm_state)
    ins = (r(B, L, H, P), r(B, L, H, fn=F.softplus),
           r(H, dtype=torch.float32, fn=lambda t: -torch.exp(0.5 * t)),
           r(B, L, G, S), r(B, L, G, S), r(H))
    gy = r(B, L, H, P).detach()
    return {
        "attention backward (mha_ref)": cuda_time_ms(
            lambda: torch.autograd.grad(mha_ref(
                q, k, v, causal=True, window=cfg.window), (q, k, v), go), 3),
        "SSD backward (ssd_scan_chunked)": cuda_time_ms(
            lambda: torch.autograd.grad(ssd_scan_chunked(
                *ins, cfg.ssm_chunk), ins, gy), 3)}


def loss_and_grads(params, batch, cfg, use_kernel: bool) -> tuple:
    """``train_loss`` and the gradient of every leaf (zeros for a leaf the
    loss does not use: an embeddings-input model's token table)."""
    from repro_torch.models import transformer
    from repro_torch.train.trainer import value_and_grad

    return value_and_grad(functools.partial(
        transformer.train_loss, cfg=cfg, use_kernel=use_kernel),
        params, batch)


def lm_batch(cfg, batch: int, step: int = 0) -> dict:
    """The synthetic LM pipeline's batch on the card (with frame or patch
    embeddings for an embeddings-input model)."""
    from repro_torch import tree
    from repro_torch.train.data import LMDataPipeline

    return tree.tree_map(lambda t: t.cuda(), LMDataPipeline(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=batch,
        seed=SEED, embed_dim=cfg.d_model if cfg.input_mode == "embeddings"
        else 0).batch_at(step))


def training_cross_path(cfg, fa_kernel, ssd_kernel,
                        batch_size: int = TRAIN_CHECK_BATCH) -> None:
    """``train_loss`` and its gradients in float32 through the kernels
    (the simt variants under the autograd Functions) and through the plain
    path (``chunked_mha``, ``ssd_scan_chunked``), at ``cfg``'s widths over
    TRAIN_CHECK_LAYERS layers.  For an MoE model the plain path takes the
    kernel path's expert choices (``moe_calls``), and the expert choices
    that its own routing would make otherwise are counted per layer."""
    from repro_torch import tree
    from repro_torch.models import transformer

    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                num_layers=TRAIN_CHECK_LAYERS)
    params = transformer.init(
        cfg32, torch.Generator(device="cuda").manual_seed(SEED))
    batch = lm_batch(cfg32, batch_size)
    out, routings = {}, {}
    for use_kernel in (True, False):
        fa_kernel.reset_launch_count()
        ssd_kernel.reset_launch_count()
        routings[use_kernel] = {}
        with moe_calls(routings[use_kernel] if cfg.is_moe else None,
                       replay=None if use_kernel else routings[True]):
            out[use_kernel] = loss_and_grads(params, batch, cfg32,
                                             use_kernel)
        torch.cuda.synchronize()
        counted_launches(
            fa_kernel, ssd_kernel, lm_kernel_launches(
                cfg32, remat_forwards(cfg32) if use_kernel else 0), "simt",
            f"  use_kernel={use_kernel}")
    (lk, gk), (lp, gp) = out[True], out[False]
    loss_err = abs(float(lk) - float(lp)) / abs(float(lp))
    errs = {"/".join(map(str, path)): float(
        (a - b).norm() / b.norm().clamp_min(1e-30))
        for (path, _), a, b in zip(tree.flatten(params), gk, gp)}
    worst = max(errs, key=errs.get)
    log(f"  float32, {TRAIN_CHECK_LAYERS} layers, {batch_size} x "
        f"{TRAIN_SEQ} tokens: loss {float(lk):.6f} (kernel path) vs "
        f"{float(lp):.6f} (plain), relative {loss_err:.3e}; gradients of "
        f"{len(errs)} leaves, normwise relative error max {errs[worst]:.3e} "
        f"({worst}), median {statistics.median(errs.values()):.3e} "
        f"(tol {CROSS_RTOL:.0e})")
    del out, gk, gp
    if cfg.is_moe:
        log(f"  routing, kernel path vs plain path: expert choices that "
            f"differ per layer "
            f"{routing_flips(routings[True], routings[False], cfg.moe_experts)}"
            f" of {batch_size * TRAIN_SEQ * cfg.moe_topk} (the plain path "
            f"takes the kernel path's)")
    if not (loss_err <= CROSS_RTOL and errs[worst] <= CROSS_RTOL):
        raise AssertionError("training: kernel path disagrees with the "
                             "plain path")


def moe_training_path(cfg, fa_kernel, ssd_kernel, workdir: Path) -> tuple:
    """``Trainer.run`` on ``cfg`` at full width and MOE_TRAIN_LAYERS layers
    in bf16; returns the config it trained and the two LM kernels'
    launches on the path."""
    import shutil
    import tempfile

    from repro_torch.config import TrainConfig
    from repro_torch.models import transformer
    from repro_torch.train import Trainer
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.data import LMDataPipeline

    cfg = dataclasses.replace(cfg, num_layers=MOE_TRAIN_LAYERS)
    tcfg = TrainConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                       microbatches=TRAIN_MICRO, learning_rate=3e-4,
                       warmup_steps=1, total_steps=MOE_TRAIN_STEPS,
                       log_every=1, checkpoint_every=MOE_TRAIN_STEPS,
                       keep_checkpoints=1, seed=SEED)
    pipe = LMDataPipeline(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                          global_batch=TRAIN_BATCH, seed=SEED)
    tokens = TRAIN_SEQ * TRAIN_BATCH
    per_step = TRAIN_MICRO * remat_forwards(cfg)
    log(f"{cfg.name} at {cfg.num_layers} layers: "
        f"{cfg.param_count() / 1e9:.3f} B parameters "
        f"({cfg.active_param_count() / 1e9:.3f} B active a token), "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} = {tokens} tokens a step in "
        f"{TRAIN_MICRO} microbatches; remat per layer and in groups of "
        f"{cfg.remat_group}: attention launches {per_step} times a step")
    ckpt_dir = Path(tempfile.mkdtemp(prefix="moe_ckpt_", dir=workdir))
    total_mem = torch.cuda.get_device_properties(0).total_memory
    try:
        starts, ends, step_metrics = {}, {}, {}
        fa_kernel.reset_launch_count()
        ssd_kernel.reset_launch_count()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = Trainer(cfg=cfg, tcfg=tcfg,
                          pipeline=_TimedPipeline(pipe, starts),
                          ckpt_dir=str(ckpt_dir), log_fn=_trainer_log([]),
                          device="cuda",
                          on_step=_step_recorder(ends, step_metrics))
        params, opt, _ = trainer.run(steps=MOE_TRAIN_STEPS)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = counted_launches(
            fa_kernel, ssd_kernel,
            lm_kernel_launches(cfg, per_step * MOE_TRAIN_STEPS), "mma",
            f"main path ({MOE_TRAIN_STEPS} steps)")
        log(f"  Trainer.run {run_s:.1f} s (init and the step-"
            f"{MOE_TRAIN_STEPS} checkpoint included; saved in "
            f"{[round(x, 2) for _, _, x in trainer.saves]} s)")
        if sorted(step_metrics) != list(range(1, MOE_TRAIN_STEPS + 1)):
            raise AssertionError(f"steps run: {sorted(step_metrics)}")
        ms = {}
        for n, m in sorted(step_metrics.items()):
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            ms[n] = starts[n].elapsed_time(ends[n])
            log(f"  step {n}: {ms[n]:.1f} ms (CUDA events), "
                f"{tokens / ms[n] * 1e3:.0f} tokens/s, loss {loss:.4f} (the "
                f"router balance term included), grad_norm {gnorm:.4f}")
            if not (np.isfinite(loss) and np.isfinite(gnorm)):
                raise AssertionError(f"step {n}: loss {loss}, grad_norm "
                                     f"{gnorm}")
        later = [ms[n] for n in range(2, MOE_TRAIN_STEPS + 1)]
        step_ms = statistics.median(later)
        log(f"  steps 2..{MOE_TRAIN_STEPS}: median {step_ms:.1f} ms, "
            f"{tokens / step_ms * 1e3:.0f} tokens/s; peak memory "
            f"{peak / 1e9:.2f} GB of {total_mem / 1e9:.2f} GB")
        path = ckpt.latest_checkpoint(str(ckpt_dir))
        log(f"  checkpoint {Path(path).name}: "
            f"{os.path.getsize(path) / 1e9:.3f} GB")
        del opt
        torch.cuda.empty_cache()

        # the trained routers' gradient on one microbatch: nonzero in
        # every layer (through the gates, and the aux term in layer 0)
        router = params["layers"]["moe"]["router"].detach().requires_grad_()
        layers = dict(params["layers"], moe=dict(params["layers"]["moe"],
                                                 router=router))
        loss = transformer.train_loss(
            dict(params, layers=layers),
            lm_batch(cfg, TRAIN_BATCH // TRAIN_MICRO, MOE_TRAIN_STEPS), cfg,
            use_kernel=True)
        (g,) = torch.autograd.grad(loss, router)
        norms = [float(x) for x in g.float().flatten(1).norm(dim=1)]
        log(f"  router gradient norm per layer (one microbatch after step "
            f"{MOE_TRAIN_STEPS}): min {min(norms):.3e}, max {max(norms):.3e}")
        if not (bool(torch.isfinite(g).all()) and min(norms) > 0):
            raise AssertionError("the router's gradient is zero or not "
                                 "finite")
        del params, layers, router, g, loss
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return cfg, launches


def zoo_path(name: str, fa_kernel, ssd_kernel) -> tuple:
    """One architecture of the zoo at full width and ZOO_LAYERS layers: the
    float32 training cross path, then (a token-input decoder) one serving
    wave in bf16.  Returns the config and the wave's launches (None
    without a wave)."""
    from repro_torch.config import get_config
    from repro_torch.models import transformer
    from repro_torch.serving import Request, ServeEngine

    full = get_config(name)
    cfg = dataclasses.replace(full, num_layers=ZOO_LAYERS)
    log(f"{name}: {full.num_layers} layers cut to {ZOO_LAYERS}, d_model "
        f"{cfg.d_model}, {cfg.mixer} mixer, heads {cfg.num_heads}/"
        f"{cfg.num_kv_heads} of {cfg.hd}, "
        f"{'MoE ' + str(cfg.moe_experts) + ' top ' + str(cfg.moe_topk) if cfg.is_moe else cfg.mlp_type + ' MLP'}, "
        f"input {cfg.input_mode}; {full.param_count() / 1e9:.3f} B "
        f"parameters whole, {cfg.param_count() / 1e9:.3f} B here")
    training_cross_path(cfg, fa_kernel, ssd_kernel, ZOO_BATCH)
    torch.cuda.empty_cache()
    if cfg.input_mode != "tokens":
        log(f"  no serving wave: {name} takes {cfg.input_mode} inputs and "
            f"the engine prefills from token prompts")
        return cfg, None
    params = transformer.init(
        cfg, torch.Generator(device="cuda").manual_seed(SEED))
    engine = ServeEngine(cfg, params, batch=ZOO_BATCH,
                         max_len=LM_PROMPT + ZOO_NEW)
    reqs = lm_requests(cfg, Request, ZOO_BATCH, ZOO_NEW)
    fa_kernel.reset_launch_count()
    ssd_kernel.reset_launch_count()
    t0 = time.perf_counter()
    done = engine.generate(reqs)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = counted_launches(fa_kernel, ssd_kernel,
                                lm_kernel_launches(cfg, cfg.num_layers),
                                "mma", f"  bf16 serving wave")
    toks = torch.as_tensor(np.stack([r.prompt for r in done]),
                           dtype=torch.int64, device="cuda")
    logits, _ = engine._prefill(toks)
    finite = bool(torch.isfinite(logits[..., :cfg.vocab_size]).all())
    log(f"  {ZOO_BATCH} x {LM_PROMPT} prompts, {ZOO_NEW} new tokens each in "
        f"{gen_s:.2f} s (host clock, first call); prefill logits finite: "
        f"{finite}; first request's tokens {done[0].out.tolist()}")
    if not finite or any(r.out.shape != (ZOO_NEW,) or not (
            (r.out >= 0) & (r.out < cfg.vocab_size)).all() for r in done):
        raise AssertionError(f"{name}: bad serving output")
    del engine, params, logits
    torch.cuda.empty_cache()
    return cfg, launches


# ---------------------------------------------------------------------------
# 5a, 5d. pipeline and compressed data-parallel paths on meshes of cuda:0
# ---------------------------------------------------------------------------

def deterministic(call) -> bool:
    """Two calls of ``call`` on the same inputs give the same bits."""
    a = call()
    return bool(torch.equal(a, call()))


def pipeline_path(cfg, params, fa_kernel, fa_ref, ssd_kernel, g) -> dict:
    """``pipeline_forward`` over ``cfg``'s layers cut into PIPE_STAGES
    stages on a ``("pipe",)`` mesh that repeats cuda:0, PIPE_MICRO
    microbatches of PIPE_BATCH x 2048 embedded tokens, each stage's layers
    through the kernels; against the unpipelined stack run microbatch by
    microbatch on the same card.  Returns the LM kernels' launches."""
    from repro_torch import tree
    from repro_torch.distributed import Mesh, pipeline_forward
    from repro_torch.models import transformer

    S, M, B, L = PIPE_STAGES, PIPE_MICRO, PIPE_BATCH, LM_PROMPT
    per = cfg.num_layers // S
    stage_params = tree.tree_map(
        lambda a: a.reshape(S, per, *a.shape[1:]), params["layers"])
    positions = torch.arange(L, dtype=torch.float32, device="cuda")

    def layers(p, x, n):
        for layer in transformer._unstack(p, n):
            x = transformer._layer_forward(layer, x, cfg, positions, True)
        return x

    rng = np.random.default_rng(SEED)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (M * B, L)),
                             device="cuda")
    with torch.no_grad():
        x_micro = transformer._embed_in(params, {"tokens": tokens}, cfg)
        x_micro = x_micro.reshape(M, B, L, cfg.d_model)
    mesh = Mesh(["cuda:0"] * S, ("pipe",))
    log(f"{cfg.name}: {cfg.num_layers} layers in {S} stages of {per} on "
        f"{mesh}, {M} microbatches of {B} x {L} tokens, bf16, seeded "
        f"weights; on {card()}")

    fa_kernel.reset_launch_count()
    ssd_kernel.reset_launch_count()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = pipeline_forward(lambda p, x: layers(p, x, per), stage_params,
                               x_micro, mesh)
    torch.cuda.synchronize()
    pipe_s = time.perf_counter() - t0
    launches = counted_launches(
        fa_kernel, ssd_kernel, lm_kernel_launches(cfg, cfg.num_layers * M),
        "mma", f"main path ({cfg.num_layers} layers x {M} microbatches)")
    t0 = time.perf_counter()
    with torch.no_grad():
        ref = torch.stack([layers(params["layers"], x, cfg.num_layers)
                           for x in x_micro])
    torch.cuda.synchronize()
    flat_s = time.perf_counter() - t0
    if (tuple(out.shape) != (M, B, L, cfg.d_model) or out.dtype != ref.dtype
            or not bool(torch.isfinite(out).all())):
        raise AssertionError(f"pipeline path: output {tuple(out.shape)} "
                             f"{out.dtype}, finite "
                             f"{bool(torch.isfinite(out).all())}")
    diff = float((out.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    log(f"  pipeline_forward {pipe_s * 1e3:.1f} ms wall, the unpipelined "
        f"stack per microbatch {flat_s * 1e3:.1f} ms wall (host clock, "
        f"synchronised); output {tuple(out.shape)}, max|out| {scale:.3e}, "
        f"max|pipelined - unpipelined| {diff:.3e}")
    if diff:
        # the same kernels at the same shapes: a difference means a kernel
        # gives other bits on a repeat; then hold the result to the bf16
        # kernel tolerance
        case = (B, cfg.num_heads, cfg.num_kv_heads, L, L, cfg.hd, True,
                cfg.window)
        q, k, v = fa_inputs(case, torch.bfloat16, g)
        ins = ssd_inputs((B * cfg.ssm_heads, L, cfg.ssm_head_dim,
                          cfg.ssm_state, cfg.ssm_chunk), torch.bfloat16, g)
        varying = [name for name, call in (
            ("flash_attention", lambda: fa_kernel.flash_attention(
                q, k, v, causal=True, window=cfg.window)),
            ("ssd_chunked", lambda: ssd_kernel.ssd_chunked(
                *ins, chunk=cfg.ssm_chunk))) if not deterministic(call)]
        tol = FA_TOL[torch.bfloat16] * scale
        log(f"  kernels whose repeat gives other bits: {varying or 'none'}; "
            f"gate max|diff| <= {FA_TOL[torch.bfloat16]} x max|out| = "
            f"{tol:.3e}")
        if not varying or diff > tol:
            raise AssertionError(f"pipeline path: max|diff| {diff:.3e} with "
                                 f"nondeterministic kernels {varying}")
    return launches


def compressed_dp_path(cfg, fa_kernel, ssd_kernel) -> dict:
    """``make_compressed_dp_step`` on ``cfg`` at full width and DP_LAYERS
    layers over a ``("data",)`` mesh of DP_SHARDS x cuda:0, DP_BATCH x 2048
    tokens a shard, AdamW (``adamw_update``), both LM kernels under
    autograd.  Gates: the first step's compressed gradient mean against the
    exact float32 mean (normwise per leaf, 2^-8); error feedback on a
    constant float32 gradient tree (EF_STEPS compressions, the reference's
    0.05 / 2e-3 bounds); DP_STEPS steps with compression beside DP_STEPS
    without (``make_train_step`` on the whole batch) from the same weights
    and data, finite losses.  Returns the LM kernels' launches in the
    compressed steps."""
    from repro_torch import tree
    from repro_torch.config import TrainConfig
    from repro_torch.distributed import (Mesh, compressed_psum,
                                         init_error_state,
                                         make_compressed_dp_step)
    from repro_torch.models import transformer
    from repro_torch.train import (adamw_init, adamw_update, cosine_schedule,
                                   make_train_step)
    from repro_torch.train.trainer import value_and_grad

    n, k = DP_SHARDS, DP_BATCH
    cfg8 = dataclasses.replace(cfg, num_layers=DP_LAYERS)
    mesh = Mesh(["cuda:0"] * n, ("data",))
    tcfg = TrainConfig(seq_len=TRAIN_SEQ, global_batch=n * k,
                       learning_rate=3e-4, warmup_steps=1,
                       total_steps=DP_STEPS, seed=SEED)
    schedule = cosine_schedule(tcfg)
    params0 = transformer.init(
        cfg8, torch.Generator(device="cuda").manual_seed(SEED))
    loss_fn = functools.partial(transformer.train_loss, cfg=cfg8,
                                use_kernel=True)
    batches = [lm_batch(cfg8, n * k, step) for step in range(DP_STEPS)]
    n_params = sum(t.numel() for t in tree.leaves(params0))
    log(f"{cfg8.name} at {DP_LAYERS} of {cfg.num_layers} layers (depth cut; "
        f"full width), {n_params / 1e9:.3f} B parameters, bf16, on {mesh}: "
        f"{k} x {TRAIN_SEQ} tokens a shard, AdamW; on {card()}")

    # (a) the first step's gradients: compressed mean vs exact float32 mean
    grads = []
    for j in range(n):
        b_j = tree.tree_map(lambda a: a[j * k:(j + 1) * k], batches[0])
        grads.append(tree.unflatten(params0,
                                    value_and_grad(loss_fn, params0, b_j)[1]))
    means, _ = compressed_psum(grads, [init_error_state(params0)] * n, mesh,
                               "data")
    worst = 0.0
    for c, *gs in zip(tree.leaves(means[0]), *map(tree.leaves, grads)):
        exact = sum(x.float() for x in gs) / n
        norm = float(exact.norm())
        rel = float((c - exact).norm()) / norm if norm else float(c.norm())
        worst = max(worst, rel)
    log(f"  (a) step-1 gradients, compressed mean vs exact float32 mean: max "
        f"normwise difference per leaf {worst:.3e} (gate 2^-8 = "
        f"{2 ** -8:.3e}; the shards' gradients are bf16, so one bf16 "
        f"rounding of each is exact)")
    if worst > 2 ** -8:
        raise AssertionError(f"compressed DP (a): {worst:.3e} > 2^-8")
    del grads, means

    # (b) error feedback on a constant float32 gradient tree
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    const = [tree.tree_map(lambda a: torch.randn(
        a.shape, generator=gen, device="cuda"), params0) for _ in range(n)]
    exact = [sum(xs) / n for xs in zip(*map(tree.leaves, const))]
    err = [init_error_state(params0)] * n
    tot, q_err = None, 0.0
    for i in range(EF_STEPS):
        means, err = compressed_psum(const, err, mesh, "data")
        m = tree.leaves(means[0])
        if i == 0:
            q_err = max(float((a - b).abs().max()) for a, b in zip(m, exact))
        tot = m if tot is None else [a + b for a, b in zip(tot, m)]
    drift = max(float((a / EF_STEPS - b).abs().max())
                for a, b in zip(tot, exact))
    log(f"  (b) {EF_STEPS} compressions of a constant float32 N(0, 1) tree "
        f"of the params' shapes per shard: first mean max|err| {q_err:.3e} "
        f"(gate 0.05), running mean max drift {drift:.3e} (gate 2e-3)")
    if q_err >= 0.05 or drift >= 2e-3:
        raise AssertionError(f"compressed DP (b): {q_err:.3e}, {drift:.3e}")
    del const, exact, err, tot, means

    # (c) DP_STEPS steps with compression beside DP_STEPS without
    def update(g, opt, params):
        return adamw_update(g, opt, tcfg, schedule)[:2]

    step = make_compressed_dp_step(loss_fn, update, mesh, "data")
    params, opt = params0, adamw_init(params0)
    err = [init_error_state(params0) for _ in range(n)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa_kernel.reset_launch_count()
    ssd_kernel.reset_launch_count()
    losses, ms = [], []
    for batch in batches:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt, err, loss = step(params, opt, err, batch)
        stop.record()
        torch.cuda.synchronize()
        losses.append(float(loss))
        ms.append(start.elapsed_time(stop))
    peak = torch.cuda.max_memory_allocated()
    launches = counted_launches(
        fa_kernel, ssd_kernel,
        lm_kernel_launches(cfg8, n * remat_forwards(cfg8) * DP_STEPS),
        "mma", f"main path ({DP_STEPS} compressed steps x {n} shards)")
    del params, opt, err
    plain = make_train_step(cfg8, tcfg, loss_fn)
    params, opt = params0, adamw_init(params0)
    plain_losses = []
    for batch in batches:
        params, opt, metrics = plain(params, opt, batch)
        plain_losses.append(float(metrics["loss"]))
    for i, (a, b) in enumerate(zip(losses, plain_losses)):
        log(f"  (c) step {i + 1}: compressed DP loss {a:.6f}, uncompressed "
            f"(one device, whole batch) {b:.6f}, difference {a - b:.3e}; "
            f"compressed step {ms[i]:.1f} ms (CUDA events)")
    log(f"  compressed DP step: median {statistics.median(ms):.1f} ms "
        f"({n * k * TRAIN_SEQ} tokens), peak memory {peak / 1e9:.2f} GB; on "
        f"{card()}")
    if not all(np.isfinite(losses + plain_losses)):
        raise AssertionError(f"compressed DP (c): losses {losses} / "
                             f"{plain_losses}")
    return launches


def shard_mesh(shape):
    from repro_torch.distributed import Mesh

    return Mesh(np.array(["cuda:0"] * int(np.prod(shape)),
                         dtype=object).reshape(shape), ("data", "model"))


def policy_context(cfg, mesh):
    """``mesh_context(mesh)`` under ``cfg.parallel_policy`` (dp-only: the
    batch over every axis)."""
    from repro_torch.distributed import mesh_context
    from repro_torch.distributed import sharding as shd

    return mesh_context(mesh, **shd.policy_kw(cfg.parallel_policy))


def data_groups(cfg, shape) -> int:
    """The data groups of a (data, model) mesh of ``shape``: the data axis,
    or every position under dp-only."""
    return shape[0] * (shape[1] if cfg.parallel_policy == "dp_only" else 1)


def shard_state(cfg, tcfg, mesh, params) -> tuple:
    """``params`` and a fresh AdamW state laid out for ``mesh`` by
    ``make_shardings`` (ShardedTensors) under ``cfg``'s policy."""
    from repro_torch.distributed import spmd
    from repro_torch.train import adamw_init
    from repro_torch.train.trainer import make_shardings

    with policy_context(cfg, mesh):
        p_sh, o_sh = make_shardings(cfg, tcfg, mesh)
        opt = spmd.device_put(adamw_init(params), o_sh)
        return spmd.device_put(params, p_sh), opt


def sharded_steps(cfg, tcfg, mesh, params, opt, batches, loss_fn,
                  on_step=None, on_state=None) -> tuple:
    """``make_train_step`` on sharded ``params`` and ``opt`` over
    ``batches`` (split over the data axis); ``on_step(i, None)`` before and
    ``on_step(i, metrics)`` after step ``i``, then ``on_state(i, params,
    opt)``.  Returns the params, the optimizer state and each step's
    metrics."""
    from repro_torch import tree
    from repro_torch.distributed import spmd
    from repro_torch.distributed import sharding as shd
    from repro_torch.train import make_train_step

    out = []
    with policy_context(cfg, mesh):
        b_sh = tree.tree_map(lambda x: shd.named_sharding(
            x.shape, ("batch",) + (None,) * (x.dim() - 1)), batches[0])
        step = make_train_step(cfg, tcfg, loss_fn)
        for i, batch in enumerate(batches):
            if on_step is not None:
                on_step(i, None)
            params, opt, m = step(params, opt, spmd.device_put(batch, b_sh))
            out.append(m)
            if on_step is not None:
                on_step(i, m)
            if on_state is not None:
                on_state(i, params, opt)
    return params, opt, out


def sharded_check(cfg, shape) -> None:
    """The float32 gate: one sharded step of ``cfg`` at full width and
    SHARD_CHECK_LAYERS layers, a row of SHARD_CHECK_SEQ tokens a data
    group, through the kernels, against the single-device step on the
    same weights and batch: the loss, every gradient (from AdamW's first
    moment) and the params (outside the AdamW eps band) at the reference
    test's tolerances."""
    from repro_torch import tree
    from repro_torch.config import TrainConfig
    from repro_torch.models import transformer
    from repro_torch.train import adamw_init, make_train_step
    from repro_torch.train.data import LMDataPipeline

    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                num_layers=SHARD_CHECK_LAYERS)
    tcfg = TrainConfig(total_steps=4, warmup_steps=1, zero1=True)
    loss_fn = functools.partial(transformer.train_loss, cfg=cfg32,
                                use_kernel=True)
    params = transformer.init(
        cfg32, torch.Generator(device="cuda").manual_seed(SEED))
    rows = data_groups(cfg, shape)
    batch = tree.tree_map(lambda t: t.cuda(), LMDataPipeline(
        vocab_size=cfg.vocab_size, seq_len=SHARD_CHECK_SEQ,
        global_batch=rows, seed=SEED).batch_at(0))
    copy = tree.tree_map(lambda t: t.clone(), params)
    p1, o1, m1 = make_train_step(cfg32, tcfg, loss_fn)(
        copy, adamw_init(copy), batch)
    del copy
    mesh = shard_mesh(shape)
    p2, o2, (m2,) = sharded_steps(cfg32, tcfg, mesh, *shard_state(
        cfg32, tcfg, mesh, params), [batch], loss_fn)
    del params
    l1, l2 = float(m1["loss"]), float(m2["loss"])
    ok = abs(l2 - l1) <= SHARD_LOSS_TOL["atol"] + SHARD_LOSS_TOL["rtol"] * abs(l1)
    g_err, miss, band, band_miss = state_errors(p2, o2, p1, o1, tcfg, 1)
    log(f"  float32 check, {SHARD_CHECK_LAYERS} layers, {rows} x "
        f"{SHARD_CHECK_SEQ} tokens, one step: loss {l2:.7f} sharded vs "
        f"{l1:.7f} single-device (rtol {SHARD_LOSS_TOL['rtol']:.0e}); "
        f"gradients max|diff| / max|g| per leaf {g_err:.3e} (tol "
        f"{SHARD_PARAM_TOL['rtol']:.0e}); params outside rtol 5e-4 / atol "
        f"5e-5: {miss} (gate 0) of {sum(x.numel() for x in tree.leaves(p1))},"
        f" and {band_miss} more among the {band} whose |g| < "
        f"{SHARD_ADAM_BAND} eps (not gated)")
    if not (ok and g_err <= SHARD_PARAM_TOL["rtol"] and miss == 0):
        raise AssertionError("sharded float32 step disagrees with the "
                             "single-device step")


def equal_to_file(state, path) -> tuple:
    """``(equal, shards compared)``: every shard of ``state`` (a tree of
    ShardedTensors or tensors) against its slice of the checkpoint at
    ``path`` (mapped, not read whole), bit for bit, on the shard's
    device."""
    from repro_torch import tree
    from repro_torch.distributed import spmd

    saved = torch.load(path, map_location="cpu", weights_only=True,
                       mmap=True)["leaves"]
    n = 0
    for x, want in zip(tree.leaves(state), saved):
        parts = ([(x.index(pos), x.shards[pos])
                  for pos in np.ndindex(x.shards.shape)]
                 if isinstance(x, spmd.ShardedTensor) else [((), x)])
        for sl, t in parts:
            n += 1
            if t.dtype != want.dtype or not torch.equal(
                    t, want[sl].to(t.device)):
                return False, n
    return True, n


def state_errors(p, o, p_ref, o_ref, tcfg, t: int) -> tuple:
    """A training state (ShardedTensors or tensors) against a reference
    state after step ``t``: ``(gradient error, params outside
    SHARD_PARAM_TOL, params in AdamW's eps band, of them outside the
    tolerance)``.  The gradient error is each leaf's first-moment
    max|diff| / max|m|; the band is sqrt(v_hat) < SHARD_ADAM_BAND eps,
    where a float32 noise d in the gradient moves the update by up to
    lr d / eps."""
    from repro_torch import tree
    from repro_torch.distributed import spmd

    def full(x):
        return (spmd.gather(x, "cuda") if isinstance(x, spmd.ShardedTensor)
                else x)

    eps = tcfg.eps * SHARD_ADAM_BAND
    g_err, band, band_miss, miss = 0.0, 0, 0, 0
    for a, b, ma, mb, vb in zip(*(tree.leaves(x) for x in (
            p, p_ref, o.m, o_ref.m, o_ref.v))):
        a, b, ma, mb, vb = map(full, (a, b, ma, mb, vb))
        g_err = max(g_err, float((ma - mb).abs().max()
                                 / mb.abs().max().clamp_min(1e-30)))
        out = (a - b).abs() > (SHARD_PARAM_TOL["atol"]
                               + SHARD_PARAM_TOL["rtol"] * b.abs())
        near = (vb / (1 - tcfg.b2 ** t)).sqrt() < eps
        band += int(near.sum())
        band_miss += int((out & near).sum())
        miss += int((out & ~near).sum())
    return g_err, miss, band, band_miss


def sharded_resume_check(cfg, shape, workdir: Path, fa_kernel,
                         ssd_kernel) -> None:
    """The float32 checkpoint gate: ``cfg`` at full width and
    SHARD_CHECK_LAYERS layers, SHARD_CKPT_ROWS x SHARD_CHECK_SEQ tokens a
    step, through the kernels: one step on a ``shape`` mesh, a save, the
    uninterrupted second step there, and the second step resumed from the
    file on each of SHARD_CKPT_TARGETS (a (4, 1) mesh: ZeRO-1 over four,
    nothing on the model axis, so every leaf's layout changes; one
    device), each restore bit for bit the file and each resumed step
    against the uninterrupted one at the reference test's tolerances, with
    its exact ``simt`` launches of each LM kernel."""
    import shutil
    import tempfile

    from repro_torch import tree
    from repro_torch.config import TrainConfig
    from repro_torch.distributed import spmd
    from repro_torch.models import transformer
    from repro_torch.train import adamw_init, make_train_step
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.data import LMDataPipeline
    from repro_torch.train.trainer import make_shardings

    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                num_layers=SHARD_CHECK_LAYERS)
    tcfg = TrainConfig(total_steps=4, warmup_steps=1, zero1=True)
    loss_fn = functools.partial(transformer.train_loss, cfg=cfg32,
                                use_kernel=True)
    params = transformer.init(
        cfg32, torch.Generator(device="cuda").manual_seed(SEED))
    pipe = LMDataPipeline(vocab_size=cfg.vocab_size, seq_len=SHARD_CHECK_SEQ,
                          global_batch=SHARD_CKPT_ROWS, seed=SEED)
    batches = [tree.tree_map(lambda t: t.cuda(), pipe.batch_at(i))
               for i in range(2)]
    mesh = shard_mesh(shape)
    p, o, (m1,) = sharded_steps(cfg32, tcfg, mesh, *shard_state(
        cfg32, tcfg, mesh, params), batches[:1], loss_fn)
    like = (params, adamw_init(params))
    workdir.mkdir(parents=True, exist_ok=True)
    ckdir = tempfile.mkdtemp(prefix="shard_ckpt32_", dir=workdir)
    try:
        path = ckpt.save_checkpoint(ckdir, 1, (p, o))
        same, n = equal_to_file((p, o), path)
        p2, o2, (m2,) = sharded_steps(cfg32, tcfg, mesh, p, o, batches[1:],
                                      loss_fn)
        want = float(m2["loss"])
        log(f"  float32 resume check, {SHARD_CHECK_LAYERS} layers, "
            f"{SHARD_CKPT_ROWS} x {SHARD_CHECK_SEQ} tokens a step: saved "
            f"after step 1 on {shape[0]} x {shape[1]} "
            f"({os.path.getsize(path) / 1e6:.1f} MB; {n} shards equal to "
            f"the file bit for bit: {same}); uninterrupted step 2 loss "
            f"{want:.7f}")
        ok = same
        for target in SHARD_CKPT_TARGETS:
            fa_kernel.reset_launch_count()
            ssd_kernel.reset_launch_count()
            if target is None:
                label, runs = "one device", remat_forwards(cfg32)
                _, (rp, ro) = ckpt.restore_checkpoint(path, like)
                exact, n = equal_to_file((rp, ro), path)
                rp, ro, m = make_train_step(cfg32, tcfg, loss_fn)(
                    rp, ro, batches[1])
                attn = runs
            else:
                label = f"a {target[0]} x {target[1]} mesh"
                tmesh = shard_mesh(target)
                with policy_context(cfg32, tmesh):
                    shardings = make_shardings(cfg32, tcfg, tmesh)
                _, (rp, ro) = ckpt.restore_checkpoint(path, like, shardings)
                exact, n = equal_to_file((rp, ro), path)
                moved = sum((a.sharding.spec, a.shards.flat[0].shape)
                            != (b.sharding.spec, b.shards.flat[0].shape)
                            for a, b in zip(tree.leaves((rp, ro)),
                                            tree.leaves((p, o))))
                label += (f" ({moved} of {len(tree.leaves(like))} leaves "
                          f"in another spec or shard shape)")
                rp, ro, (m,) = sharded_steps(cfg32, tcfg, tmesh, rp, ro,
                                             batches[1:], loss_fn)
                m_ = target[1]
                runs = data_groups(cfg32, target) * remat_forwards(cfg32)
                head_local = (cfg.num_heads % m_ == 0
                              and cfg.num_kv_heads % m_ == 0)
                attn = runs * (m_ if head_local else 1)
            want_l = lm_kernel_launches(cfg32, runs)
            if want_l["flash_attention"]:
                want_l["flash_attention"] = attn
            got = counted_launches(fa_kernel, ssd_kernel, want_l, "simt",
                                   f"  resumed step 2 on {label}")
            loss = float(m["loss"])
            lok = abs(loss - want) <= (SHARD_LOSS_TOL["atol"]
                                       + SHARD_LOSS_TOL["rtol"] * abs(want))
            g_err, miss, band, band_miss = state_errors(rp, ro, p2, o2,
                                                        tcfg, 2)
            log(f"  resumed on {label}: {n} shards restored bit for bit: "
                f"{exact}; step 2 loss {loss:.7f} vs {want:.7f} "
                f"uninterrupted (rtol {SHARD_LOSS_TOL['rtol']:.0e}); "
                f"gradients (first moments) max|diff| / max|m| per leaf "
                f"{g_err:.3e} (tol {SHARD_PARAM_TOL['rtol']:.0e}); params "
                f"outside rtol 5e-4 / atol 5e-5: {miss} (gate 0), and "
                f"{band_miss} more among the {band} whose sqrt(v_hat) < "
                f"{SHARD_ADAM_BAND} eps (not gated); launches {got}")
            ok = ok and exact and lok and g_err <= SHARD_PARAM_TOL[
                "rtol"] and miss == 0
            del rp, ro, m
        if not ok:
            raise AssertionError("a float32 resume from the sharded "
                                 "checkpoint disagrees with the "
                                 "uninterrupted step")
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)


def sharded_resume(cfg, tcfg, mesh, like, saved: dict, batches, loss_fn,
                   losses: list) -> None:
    """The bf16 checkpoint gates of a sharded training cell: the save
    after step SHARD_CKPT_STEP (``saved``: its file, seconds and the
    shards' comparison with the file), its size and rate; the file
    restored onto the same mesh, every shard bit for bit; the next step
    from it against the uninterrupted one (``losses``)."""
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.trainer import make_shardings

    path, k = saved["path"], SHARD_CKPT_STEP
    nbytes = os.path.getsize(path)
    log(f"  sharded checkpoint after step {k} (every leaf gathered on the "
        f"host from one copy of each slice): {nbytes / 1e9:.3f} GB saved "
        f"in {saved['save_s']:.2f} s ({nbytes / saved['save_s'] / 1e9:.2f} "
        f"GB/s, fsync included; the host gather alone "
        f"{saved['gather_s']:.2f} s, "
        f"{nbytes / saved['gather_s'] / 1e9:.2f} GB/s); {saved['n']} "
        f"shards equal to the file bit for bit: {saved['same']}")
    with policy_context(cfg, mesh):
        shardings = make_shardings(cfg, tcfg, mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step, state = ckpt.restore_checkpoint(path, like, shardings)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    same, n = equal_to_file(state, path)
    log(f"  restored onto the same mesh in {restore_s:.2f} s "
        f"({nbytes / restore_s / 1e9:.2f} GB/s of file, each position "
        f"copying its own slice; the file was just written: a warm read); "
        f"step {step}; {n} shards equal to the saved ones bit for bit: "
        f"{same}")
    if not (saved["same"] and same and step == k):
        raise AssertionError("the sharded checkpoint does not restore the "
                             "saved shards")
    _, _, (m,) = sharded_steps(cfg, tcfg, mesh, *state, batches[k:k + 1],
                               loss_fn)
    loss, want = float(m["loss"]), losses[k]
    rel = abs(loss - want) / abs(want)
    log(f"  step {k + 1} from the restored state: loss {loss!r} vs {want!r} "
        f"uninterrupted, difference {loss - want!r} (relative {rel:.3e}, "
        f"bound {SHARD_BF16_RTOL:.0e}); identical: {loss == want}")
    if not rel <= SHARD_BF16_RTOL:
        raise AssertionError(f"resumed step {k + 1}: loss {loss}, "
                             f"uninterrupted {want}")


def sharded_training_path(cfg, fa_kernel, ssd_kernel, shape=None,
                          layers: int = SHARD_LAYERS,
                          workdir: Path | None = None) -> tuple:
    """The sharded training step (``repro_torch.distributed.spmd``) on
    ``cfg`` (its policy and ``seq_parallel``) at full width: the float32
    gate, then SHARD_STEPS bf16 AdamW steps at ``layers`` layers on a
    ``shape`` mesh of cuda:0 (default: its SHARD_MESHES mesh), SHARD_BATCH
    x 2048 tokens a data group: finite losses, the step-1 loss within
    SHARD_BF16_RTOL of the single-device loss, exact launches of each LM
    kernel (per data group and remat forward: one, or one per model shard
    where attention is head-local), ms and tokens/s a step, peak memory
    and the collective log per step (kept in SHARDED).  With ``workdir``,
    the sharded checkpoint too: its float32 gate
    (:func:`sharded_resume_check`), a save after step SHARD_CKPT_STEP
    under ``workdir`` between the timed steps, and after them the restore
    and the resumed step (:func:`sharded_resume`).  Returns the config a
    launch runs at (heads per shard), the batch per launch and the
    launches."""
    import shutil
    import tempfile

    from repro_torch import tree
    from repro_torch.config import TrainConfig
    from repro_torch.distributed import spmd
    from repro_torch.models import transformer
    from repro_torch.train import checkpoint as ckpt

    shape = shape or SHARD_MESHES[cfg.name]
    m = shape[1]
    d = data_groups(cfg, shape)
    sharded_check(cfg, shape)
    torch.cuda.empty_cache()
    if workdir is not None:
        sharded_resume_check(cfg, shape, workdir, fa_kernel, ssd_kernel)
        torch.cuda.empty_cache()

    cfg8 = dataclasses.replace(cfg, num_layers=layers)
    tcfg = TrainConfig(seq_len=TRAIN_SEQ, global_batch=d * SHARD_BATCH,
                       learning_rate=3e-4, warmup_steps=1,
                       total_steps=SHARD_STEPS, zero1=True, seed=SEED)
    loss_fn = functools.partial(transformer.train_loss, cfg=cfg8,
                                use_kernel=True)
    params = transformer.init(
        cfg8, torch.Generator(device="cuda").manual_seed(SEED))
    batches = [lm_batch(cfg8, d * SHARD_BATCH, step)
               for step in range(SHARD_STEPS)]
    with torch.no_grad():
        single = float(loss_fn(params, batches[0]))
    dp_only = cfg.parallel_policy == "dp_only"
    head_local = (not dp_only and cfg.num_heads % m == 0
                  and cfg.num_kv_heads % m == 0)
    attn = d * (m if head_local else 1) * remat_forwards(cfg8) * SHARD_STEPS
    want = lm_kernel_launches(cfg8, d * remat_forwards(cfg8) * SHARD_STEPS)
    want["flash_attention"] = attn if want["flash_attention"] else 0
    tokens = d * SHARD_BATCH * TRAIN_SEQ
    depth = (f"{layers} of {cfg.num_layers} layers (depth cut; full width)"
             if layers < cfg.num_layers else
             f"full width and depth ({layers} layers)")
    policy = (f"dp-only: the batch over both axes, {d} data groups, the "
              f"table split over the model axis" if dp_only else
              "seq_parallel: the residual stream split by sequence over "
              "the model axis" if cfg.seq_parallel else "tp")
    log(f"{cfg.name} at {depth}, bf16, a (data, model) mesh of "
        f"{shape[0]} x {m} cuda:0 ({policy}), {SHARD_BATCH} x {TRAIN_SEQ} "
        f"tokens a data group, zero1, {SHARD_STEPS} AdamW steps; attention "
        f"{'head-local, ' + str(cfg.num_heads // m) + '/' + str(cfg.num_kv_heads // m) + ' heads a shard' if head_local else 'at full heads a data group'}; "
        f"single-device step-1 loss {single:.5f}; on {card()}")
    starts, ends = [], []

    def on_step(i, metrics):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        (starts if metrics is None else ends).append(ev)

    saved = {}

    def on_state(i, p, o):
        """Save after step SHARD_CKPT_STEP, between the timed steps; the
        host gather alone is timed first (its copies are then dropped)."""
        if i != SHARD_CKPT_STEP - 1:
            return
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = [spmd.gather(x, "cpu") for x in tree.leaves((p, o))]
        saved["gather_s"] = time.perf_counter() - t0
        del host
        t0 = time.perf_counter()
        saved["path"] = ckpt.save_checkpoint(saved["dir"], i + 1, (p, o))
        saved["save_s"] = time.perf_counter() - t0
        saved["same"], saved["n"] = equal_to_file((p, o), saved["path"])

    if workdir is not None:
        saved["dir"] = tempfile.mkdtemp(prefix="shard_ckpt_", dir=workdir)
    mesh = shard_mesh(shape)
    p, o = shard_state(cfg8, tcfg, mesh, params)
    del params
    fa_kernel.reset_launch_count()
    ssd_kernel.reset_launch_count()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    at_reset = torch.cuda.memory_allocated()
    p, o, metrics = sharded_steps(cfg8, tcfg, mesh, p, o, batches, loss_fn,
                                  on_step,
                                  on_state if workdir is not None else None)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = counted_launches(fa_kernel, ssd_kernel, want, "mma",
                                f"main path ({SHARD_STEPS} sharded steps)")
    ms = [a.elapsed_time(b) for a, b in zip(starts, ends)]
    losses = [float(x["loss"]) for x in metrics]
    for i, (x, t) in enumerate(zip(metrics, ms)):
        log(f"  step {i + 1}: {t:.1f} ms (CUDA events), "
            f"{tokens / t * 1e3:.0f} tokens/s, loss {losses[i]:.5f}, "
            f"grad_norm {float(x['grad_norm']):.4f}")
    by_kind = metrics[0]["collectives"].by_kind()
    log(f"  collectives a step (one device's schedule): "
        + ", ".join(f"{k} {n} ({b / 1e6:.2f} MB)"
                    for k, (n, b) in sorted(by_kind.items()))
        + f"; {sum(b for _, b in by_kind.values()) / 1e6:.2f} MB in all")
    sizes = collections.Counter(metrics[0]["collectives"])
    log("  largest: " + "; ".join(
        f"{n} x {c.kind} of {c.bytes / 1e6:.2f} MB over {c.group}"
        for c, n in sorted(sizes.items(), key=lambda cn: -cn[0].bytes
                           * cn[1])[:6]))
    step_ms = statistics.median(ms[1:])
    rel = abs(losses[0] - single) / abs(single)
    log(f"  steps 2..{SHARD_STEPS}: median {step_ms:.1f} ms, "
        f"{tokens / step_ms * 1e3:.0f} tokens/s; memory allocated at "
        f"reset_peak_memory_stats() {at_reset / 1e9:.3f} GB, peak "
        f"{peak / 1e9:.3f} GB; step-1 loss sharded {losses[0]:.5f} vs "
        f"single-device {single:.5f}: relative {rel:.3e} (bound "
        f"{SHARD_BF16_RTOL:.0e}); on {card()}")
    if not (np.isfinite(losses).all() and rel <= SHARD_BF16_RTOL):
        raise AssertionError(f"sharded training: losses {losses}, single "
                             f"{single}")
    SHARDED[cfg.name, cfg.parallel_policy, cfg.seq_parallel] = {
        "ms": step_ms, "tokens_per_s": tokens / step_ms * 1e3, "peak": peak,
        "at_reset": at_reset, "log": metrics[0]["collectives"]}
    if workdir is not None:
        try:
            sharded_resume(cfg8, tcfg, mesh, (p, o), saved, batches,
                           loss_fn, losses)
        finally:
            shutil.rmtree(saved["dir"], ignore_errors=True)
    del p, o
    at = (dataclasses.replace(cfg8, name=f"{cfg.name} head-local",
                              num_heads=cfg.num_heads // m,
                              num_kv_heads=cfg.num_kv_heads // m)
          if head_local else cfg8)
    return at, SHARD_BATCH, launches

def seq_parallel_report(cfg) -> None:
    """The seq_parallel cell's step ms and log a step beside the non-SP
    cell's (SHARDED), with the entries that moved: each row-parallel
    all-reduce of the stream becomes a reduce-scatter and an all-gather."""
    base = SHARDED[cfg.name, cfg.parallel_policy, False]
    sp = SHARDED[cfg.name, cfg.parallel_policy, True]
    mb = {k: sum(c.bytes for c in v["log"]) / 1e6 for k, v in (
        ("base", base), ("sp", sp))}
    log(f"  seq_parallel vs not: {sp['ms']:.1f} vs {base['ms']:.1f} ms a "
        f"step ({sp['tokens_per_s']:.0f} vs {base['tokens_per_s']:.0f} "
        f"tokens/s), log {mb['sp']:.2f} vs {mb['base']:.2f} MB a step, peak "
        f"{sp['peak'] / 1e9:.2f} vs {base['peak'] / 1e9:.2f} GB; on {card()}")
    a, b = collections.Counter(sp["log"]), collections.Counter(base["log"])
    for sign, diff in (("+", a - b), ("-", b - a)):
        log(f"  entries {'added' if sign == '+' else 'gone'} under SP: "
            + "; ".join(f"{n} x {c.kind} of {c.bytes / 1e6:.3f} MB over "
                        f"{c.group}" for c, n in sorted(
                            diff.items(), key=lambda cn: -cn[0].bytes
                            * cn[1])))
    if a == b:
        raise AssertionError("seq_parallel ran the non-SP program")


def serving_check(cfg, shape) -> None:
    """The sharded serving path's float32 gate: ``cfg`` at full width and
    SHARD_CHECK_LAYERS layers, 2 x SHARD_CHECK_SEQ tokens through the
    kernels, sharded prefill and SERVE_CHECK_STEPS decode steps on a
    ``shape`` mesh of cuda:0 against the single-device run on the same
    weights: the logits, every cache shard against its slice of the
    single-device cache, and the greedy tokens."""
    from repro_torch import tree
    from repro_torch.config import TrainConfig
    from repro_torch.distributed import spmd
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import transformer
    from repro_torch.train.trainer import make_shardings

    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                num_layers=SHARD_CHECK_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = transformer.init(cfg32, gen)
    rows = data_groups(cfg, shape)
    toks = torch.randint(0, cfg.vocab_size, (rows, SHARD_CHECK_SEQ),
                         generator=gen, device="cuda")
    max_len = SHARD_CHECK_SEQ + SERVE_CHECK_STEPS
    worst = {"logits": 0.0, "caches": 0.0}
    miss = []

    def close(a, b, what):
        a, b = a.float(), b.float()
        err = float(((a - b).abs() / (SERVE_TOL["atol"] + SERVE_TOL["rtol"]
                                      * b.abs())).max())
        worst[what] = max(worst[what], err)
        if err > 1.0:
            miss.append(what)

    def caches_close(sharded, single):
        for (path, x), (_, y) in zip(tree.flatten(sharded),
                                     tree.flatten(single)):
            for pos in np.ndindex(x.shards.shape):
                close(x.shards[pos], y[x.index(pos)], "caches")

    mesh = shard_mesh(shape)
    with policy_context(cfg, mesh):
        p_sh, _ = make_shardings(cfg32, TrainConfig(), mesh)
        sp = spmd.device_put(params, p_sh)
        l1, c1 = transformer.prefill(params, {"tokens": toks}, cfg32,
                                     max_len, use_kernel=True)
        l2, c2 = transformer.prefill(sp, {"tokens": spmd.device_put(
            toks, shd.named_sharding(toks.shape, ("batch", None)))}, cfg32,
            max_len, use_kernel=True)
        close(spmd.gather(l2, "cuda"), l1, "logits")
        caches_close(c2, c1)
        cur1 = torch.argmax(l1[:, -1], dim=-1)
        cur2 = torch.argmax(spmd.gather(l2, "cuda")[:, -1], dim=-1)
        same = [bool(torch.equal(cur1, cur2))]
        for _ in range(SERVE_CHECK_STEPS):
            l1, c1 = transformer.decode_step(params, cur1, c1, cfg32)
            l2, c2 = transformer.decode_step(sp, spmd.device_put(
                cur2, shd.named_sharding(cur2.shape, ("batch",))), c2, cfg32)
            g2 = spmd.gather(l2, "cuda")
            close(g2, l1, "logits")
            cur1, cur2 = torch.argmax(l1, dim=-1), torch.argmax(g2, dim=-1)
            same.append(bool(torch.equal(cur1, cur2)))
        caches_close(c2, c1)
    log(f"  float32 check, {SHARD_CHECK_LAYERS} layers, {rows} x "
        f"{SHARD_CHECK_SEQ} tokens, prefill + {SERVE_CHECK_STEPS} decode "
        f"steps: worst |diff| / (atol + rtol |single|) logits "
        f"{worst['logits']:.3e}, every cache shard {worst['caches']:.3e} "
        f"(gate 1 at rtol {SERVE_TOL['rtol']:.0e} / atol "
        f"{SERVE_TOL['atol']:.0e}); greedy tokens equal at each step: "
        f"{same}")
    if miss or not all(same):
        raise AssertionError(f"sharded float32 serving disagrees with the "
                             f"single-device run: {sorted(set(miss))}, "
                             f"tokens {same}")


def sharded_serving_path(cfg, fa_kernel, ssd_kernel, shape=None) -> tuple:
    """``ServeEngine.generate`` on ``cfg`` at full width and depth, its
    params laid out for a ``shape`` mesh of cuda:0 (default: its
    SHARD_MESHES mesh; the engine under the mesh's ``mesh_context`` of
    ``cfg``'s policy), the serving cell's requests: the float32
    gate, exact launches (per data group and layer one, or one per model
    shard where attention is head-local), finite logits, prefill ms a wave
    and decode ms a step (CUDA events around each call of the engine's
    prefill and decode), new tokens/s, all beside the single-device
    engine's; the greedy tokens' agreement with it; the collective log of
    a prefill wave and a decode step; peak memory.  Returns the config a
    launch runs at, the batch per launch and the launches."""
    from repro_torch.config import TrainConfig
    from repro_torch.distributed import spmd
    from repro_torch.models import transformer
    from repro_torch.serving import Request, ServeEngine
    from repro_torch.train.trainer import make_shardings

    shape = shape or SHARD_MESHES[cfg.name]
    m = shape[1]
    d = data_groups(cfg, shape)
    serving_check(cfg, shape)
    torch.cuda.empty_cache()
    params = transformer.init(
        cfg, torch.Generator(device="cuda").manual_seed(SEED))
    mesh = shard_mesh(shape)
    calls = {"prefill": [], "decode": []}
    first_logits = {}
    bad = []

    def timed(kind, fn):
        def call(*args):
            log_ = spmd.CollectiveLog()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            with spmd.recording(log_):
                logits, caches = fn(*args)
            ev[1].record()
            if not bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()):
                bad.append(kind)
            if not calls[kind]:
                first_logits[kind] = logits.reshape(
                    logits.shape[0], -1)[:, :cfg.vocab_size].float().cpu()
            calls[kind].append((ev, log_))
            return logits, caches
        return call

    waves = -(-LM_REQUESTS // LM_BATCH)
    head_local = (cfg.parallel_policy != "dp_only" and cfg.num_heads % m == 0
                  and cfg.num_kv_heads % m == 0)
    want = lm_kernel_launches(cfg, waves * d * cfg.num_layers)
    if want["flash_attention"] and head_local:
        want["flash_attention"] *= m
    with policy_context(cfg, mesh):
        p_sh, _ = make_shardings(cfg, TrainConfig(), mesh)
        sp = spmd.device_put(params, p_sh)
        del params
        engine = ServeEngine(cfg, sp, batch=LM_BATCH, max_len=LM_MAX_LEN)
        engine._prefill = timed("prefill", engine._prefill)
        engine._decode = timed("decode", engine._decode)
        reqs = lm_requests(cfg, Request)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fa_kernel.reset_launch_count()
        ssd_kernel.reset_launch_count()
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        start.record()
        done = engine.generate(reqs)
        stop.record()
        torch.cuda.synchronize()
    launches = counted_launches(fa_kernel, ssd_kernel, want, "mma",
                                f"main path ({waves} sharded waves)")
    peak = torch.cuda.max_memory_allocated()
    del engine, sp
    gen_ms = start.elapsed_time(stop)
    new = sum(len(r.out) for r in done)
    pre = [ev[0].elapsed_time(ev[1]) for ev, _ in calls["prefill"]]
    dec = [ev[0].elapsed_time(ev[1]) for ev, _ in calls["decode"]]
    single = SERVED[cfg.name]
    agree = [float(np.mean(r.out == t))
             for r, t in zip(done, single["tokens"])]
    first = sum(int(r.out[0] == t[0]) for r, t in zip(done, single["tokens"]))
    log(f"{cfg.name} at full width and depth, bf16, a (data, model) mesh of "
        f"{shape[0]} x {m} cuda:0 ({d} data groups, policy "
        f"{cfg.parallel_policy}); attention "
        f"{'head-local, ' + str(cfg.num_heads // m) + '/' + str(cfg.num_kv_heads // m) + ' heads a shard' if head_local else 'at full heads a data group'}; "
        f"on {card()}")
    log(f"  generate: {gen_ms:.1f} ms for {LM_REQUESTS} requests, {new} new "
        f"tokens -> {new / gen_ms * 1e3:.1f} new tokens/s (single-device "
        f"engine {single['new_per_s']:.1f})")
    log(f"  prefill: {', '.join(f'{t:.1f}' for t in pre)} ms per wave of "
        f"{LM_BATCH} x {LM_PROMPT} (single-device median "
        f"{single['prefill_ms']:.1f}); decode: median "
        f"{statistics.median(dec):.1f} ms per step of {LM_BATCH} tokens over "
        f"{len(dec)} steps (min {min(dec):.1f}, max {max(dec):.1f}; "
        f"single-device median {single['decode_ms']:.1f})")
    ref = single["logits"][:, :cfg.vocab_size]
    diff = float((first_logits["prefill"] - ref).norm() / ref.norm())
    top2 = torch.topk(ref, 2, dim=-1).values
    log(f"  greedy tokens equal to the single-device engine's: "
        f"{statistics.mean(agree):.4f} of all (per request min "
        f"{min(agree):.4f}), first tokens {first} of {len(done)} (bf16 sums "
        f"in another order; not gated); the first wave's last logits differ "
        f"by {diff:.3e} normwise from the single-device engine's, whose "
        f"top-2 gaps are median {float((top2[:, 0] - top2[:, 1]).median()):.3e} "
        f"of a max |logit| {float(ref.abs().max()):.3e}")
    for kind in ("prefill", "decode"):
        by_kind = calls[kind][0][1].by_kind()
        log(f"  collectives of one {kind} {'wave' if kind == 'prefill' else 'step'} "
            f"(one device's schedule): "
            + ", ".join(f"{k} {n} ({b / 1e6:.2f} MB)"
                        for k, (n, b) in sorted(by_kind.items()))
            + f"; {sum(b for _, b in by_kind.values()) / 1e6:.2f} MB in all")
    log(f"  peak memory {peak / 1e9:.2f} GB; on {card()}")
    if bad or any(r.out.shape != (LM_NEW,) for r in done):
        raise AssertionError(f"sharded serving: non-finite logits in {bad} "
                             f"or short outputs")
    at = (dataclasses.replace(cfg, name=f"{cfg.name} head-local",
                              num_heads=cfg.num_heads // m,
                              num_kv_heads=cfg.num_kv_heads // m)
          if head_local else cfg)
    return at, LM_BATCH // d, launches


def dryrun_path() -> None:
    """The dry-run on meshes of ``meta`` devices: DRYRUN_CELLS at once, one
    ``python -m repro_torch.launch.dryrun`` process each (no card; a cell's
    ``--set`` overrides also name its ``--tag``), each record ``ok``, the
    phase within DRYRUN_LIMIT_S."""
    out = ROOT / "build" / "dryrun"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    t0 = time.perf_counter()
    def tag(sets):
        return "-".join(kv.replace("=", "_") for kv in sets)

    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--out", str(out), "--tag", tag(sets)]
        + [a for kv in sets for a in ("--set", kv)], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for arch, shape, sets in DRYRUN_CELLS]
    wall, fails = {}, []
    try:
        for cell, p in zip(DRYRUN_CELLS, procs):
            left = DRYRUN_LIMIT_S - (time.perf_counter() - t0)
            text, _ = p.communicate(timeout=max(left, 1.0))
            wall[cell] = time.perf_counter() - t0
            if p.returncode != 0:
                fails.append((cell, text[-2000:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    took = time.perf_counter() - t0
    for arch, shape, sets in DRYRUN_CELLS:
        suffix = f"-{tag(sets)}" if sets else ""
        rec = json.loads((out / f"pod256--{arch}--{shape}{suffix}.json")
                         .read_text())
        if rec["status"] != "ok":
            fails.append((arch, shape, sets, rec.get("error")))
            continue
        c = rec["collectives"]
        log(f"  {arch} {shape} {' '.join(sets)}: {rec['status']}, "
            f"{rec['lower_s']} s in the run, "
            f"{wall[arch, shape, sets]:.1f} s to the process's end; flops "
            f"{rec['cost_analysis']['flops']:.4g} (one device), collectives "
            f"{c['total_bytes'] / 1e6:.2f} MB out, "
            f"{c['total_wire_bytes'] / 1e6:.2f} MB on the wire "
            f"({', '.join(f'{k} {n}' for k, n in c['counts'].items() if n)}), "
            f"arguments {rec['memory_analysis']['argument_size_in_bytes'] / 1e9:.3f} GB"
            f" a device")
    log(f"  dry-run phase: {took:.1f} s for {len(DRYRUN_CELLS)} cells at once "
        f"(bound {DRYRUN_LIMIT_S:.0f} s)")
    if fails or took > DRYRUN_LIMIT_S:
        raise AssertionError(f"dry-run: {fails}, {took:.1f} s")


def in_turns(fns: dict, reps: dict, rounds: int = 2) -> dict:
    """``{name: (ms, profiler ms)}`` per call of each function, timed in
    turns (a, b, ..., then again) so that the card's state is shared: CUDA
    events around back-to-back calls (the kernels here run longer than
    their host launch), and beside it the profiler's summed kernel time."""
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            times[name].append((cuda_time_ms(fn, reps[name]),
                                device_time_ms(fn, reps[name])))
    return {name: tuple(statistics.mean(x) for x in zip(*t))
            for name, t in times.items()}


def _fa_at(B, cfg, fa_kernel, fa_ref, g) -> dict:
    """Per-launch numbers of flash attention at batch ``B`` of an LM path's
    prefill shape: q (B, Hq, 2048, D), k/v (B, Hkv, 2048, D), the model's
    mask.  The library call is ``scaled_dot_product_attention`` with the
    causal flag, or with the band as a mask where the window cuts it."""
    import torch.nn.functional as F

    bf16 = torch.bfloat16
    causal = cfg.causal and not cfg.is_encoder
    case = (B, cfg.num_heads, cfg.num_kv_heads, LM_PROMPT, LM_PROMPT,
            cfg.hd, causal, cfg.window)
    q, k, v = fa_inputs(case, bf16, g)
    _, Hq, Hkv, L, _, D, _, W = case
    which = fa_kernel.variant(bf16, D)
    t = in_turns({
        which: lambda: fa_kernel.flash_attention(q, k, v, causal=causal,
                                                 window=W),
        "simt": lambda: fa_kernel._run("simt", q, k, v, causal=causal,
                                       window=W)},
        {which: 20, "simt": 5})
    rows_ = torch.arange(L, device="cuda")[:, None]
    cols = torch.arange(L, device="cuda")[None, :]
    band = torch.ones(L, L, dtype=torch.bool, device="cuda")
    if causal:
        band &= rows_ >= cols
    if W is not None:
        band &= rows_ - cols < W
    mask = band if W is not None and W < L else None
    out = {"case": case, "variant": which,
           "ms": t[which][0], "profiler_ms": t[which][1],
           "prev_design_ms": t["simt"][0], "prev_profiler_ms": t["simt"][1],
           "plain_ms": cuda_time_ms(lambda: fa_ref.mha_ref(
               q, k, v, causal=causal, window=W), 3),
           "library_ms": cuda_time_ms(
               lambda: F.scaled_dot_product_attention(
                   q, k, v, attn_mask=mask, is_causal=causal and mask is None,
                   enable_gqa=True), 5)}
    out["flops"] = 4 * D * int(band.sum()) * B * Hq   # QK^T, PV in the band
    out["bytes"] = 2 * (2 * B * Hq * L * D + 2 * B * Hkv * L * D)
    out["bound_ms"], out["bound_by"] = bound(out["bytes"], out["flops"], bf16)
    return out


def _ssd_at(B, cfg, ssd_kernel, ssd_ref, g, stages: bool) -> dict:
    """Per-call numbers of the chunked SSD at batch ``B`` of an LM path's
    prefill shape: l (B H, 2048) f32, dtx (B H, 2048, P), B/C (B H, 2048,
    S); with ``stages``, each stage of the mma kernel alone."""
    bf16 = torch.bfloat16
    case = (B * cfg.ssm_heads, LM_PROMPT, cfg.ssm_head_dim, cfg.ssm_state,
            cfg.ssm_chunk)
    ins = ssd_inputs(case, bf16, g)
    BH, L, P, S, Q = case
    which = ssd_kernel.variant(bf16, P)
    t = in_turns({
        which: lambda: ssd_kernel.ssd_chunked(*ins, chunk=Q),
        "simt": lambda: ssd_kernel._run_simt(*ins, Q)},
        {which: 20, "simt": 5})
    tri = Q * (Q + 1) // 2
    out = {"case": case, "variant": which,
           "ms": t[which][0], "profiler_ms": t[which][1],
           "prev_design_ms": t["simt"][0], "prev_profiler_ms": t["simt"][1],
           "plain_ms": cuda_time_ms(lambda: ssd_ref.ssd_chunked_ref(
               *ins, chunk=Q), 3), "library_ms": None,
           "flops": BH * (L // Q) * (2 * Q * P * S        # C . state
                                     + 2 * tri * S        # C B^T, triangle
                                     + 2 * tri * P        # (M o G) dtx
                                     + 2 * Q * P * S),    # state increment
           "bytes": BH * L * (4 + 2 * (2 * P + 2 * S))}
    out["bound_ms"], out["bound_by"] = bound(out["bytes"], out["flops"], bf16)
    if stages:   # each stage alone; bytes each moves (inputs once, outputs once)
        _, _, _, args = ssd_kernel._mma_stages(*ins, Q)
        stream = torch.cuda.current_stream().cuda_stream
        calls = {st: (lambda st=st: ssd_kernel._launch_stage(
            st, args[st], stream)) for st in ssd_kernel.STAGES}
        nc, st_bytes = L // Q, BH * (L // Q) * (P * S + 1) * 4
        out["stage_bytes"] = {
            "chunk_state": BH * L * (4 + 2 * (P + S)) + st_bytes,
            "state_pass": BH * nc * (2 * P * S + 1) * 4,
            "chunk_scan": BH * L * (4 + 2 * (2 * P + 2 * S))
            + st_bytes - BH * nc * 4}
        out["stage_ms"] = {}
        for stage in ssd_kernel.STAGES:
            for prior in ssd_kernel.STAGES[:ssd_kernel.STAGES.index(stage)]:
                calls[prior]()                # the stage's inputs, fresh
            out["stage_ms"][stage] = cuda_time_ms(calls[stage], 50)
    return out


def lm_kernel_timing(paths, fa_kernel, fa_ref, ssd_kernel, ssd_ref,
                     g, errs) -> list:
    """Report rows of the two LM kernels: on each LM path (``paths``:
    ``{name: (model config, batch per launch, {kernel: launches})}``) that
    launches the kernel, the tensor-core kernel the path runs, the simt
    design at the same shape (called by variant: the paths never take it),
    the plain version, the library call where there is one, and the bound,
    per launch; each row sums them over the paths' launches.  ``errs``:
    ``{kernel: {case: max abs error}}`` from the bfloat16 checks against
    the plain version; each path's shape must be among them."""
    rows = []
    for name, at, src, replaces, unit in (
            ("flash_attention",
             lambda cfg, B, first: _fa_at(B, cfg, fa_kernel, fa_ref, g),
             "flash_attention/csrc/flash_attention_mma.cu",
             "src/repro/kernels/flash_attention/kernel.py:92", "launch"),
            ("ssd_chunked",
             lambda cfg, B, first: _ssd_at(B, cfg, ssd_kernel, ssd_ref, g,
                                           first),
             "ssd/csrc/ssd_mma.cu", "src/repro/kernels/ssd/kernel.py:73",
             "call")):
        per_path, total, measured = {}, collections.Counter(), {}
        ran = [(path, cfg, B, launches[name])
               for path, (cfg, B, launches) in paths.items()
               if launches[name]]
        for i, (path, cfg, B, n) in enumerate(ran):
            if (cfg.name, B) not in measured:   # a shape another path ran
                measured[cfg.name, B] = at(cfg, B, i == 0)
            r = measured[cfg.name, B]
            if r["case"] not in errs[name]:
                raise AssertionError(f"{name}: the {path} path's shape "
                                     f"{r['case']} was not checked against "
                                     f"the plain version")
            per_path[path] = {"launches": n, "case": r["case"],
                              "max_abs_err": errs[name][r["case"]],
                              "bound_by": r["bound_by"],
                              **{k: r[k] * n for k in (
                                  "ms", "plain_ms", "bound_ms",
                                  "prev_design_ms", "profiler_ms")}}
            if r["library_ms"] is not None:
                per_path[path]["library_ms"] = r["library_ms"] * n
            if "stage_ms" in r:
                per_path[path]["stage_ms"] = {
                    k: v * n for k, v in r["stage_ms"].items()}
            total.update({k: v for k, v in per_path[path].items()
                          if isinstance(v, (int, float))
                          and k != "max_abs_err"})
            lib = ("none" if r["library_ms"] is None else
                   f"{r['library_ms']:.4f} ms")
            log(f"  {name} at the {path} path's shape {r['case']} bf16, per "
                f"{unit} (CUDA events): kernel ({r['variant']}) "
                f"{r['ms']:.4f} ms (profiler {r['profiler_ms']:.4f} ms), the "
                f"simt design {r['prev_design_ms']:.4f} ms (profiler "
                f"{r['prev_profiler_ms']:.4f} ms), plain {r['plain_ms']:.4f} "
                f"ms, library call {lib}, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}: {r['flops'] / 1e9:.2f} GFLOP, "
                f"{r['bytes'] / 1e6:.1f} MB; {r['bound_ms'] / r['ms']:.3f} "
                f"of the bound); max abs err vs plain at this shape "
                f"{errs[name][r['case']]:.3e}; x{n} launches on the path")
            for stage, sms in r.get("stage_ms", {}).items():
                log(f"    stage {stage} (CUDA events): {sms:.4f} ms, "
                    f"{r['stage_bytes'][stage] / 1e6:.1f} MB moved, "
                    f"{r['stage_bytes'][stage] / sms / 1e9:.3f} TB/s")
            torch.cuda.empty_cache()
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/{src}", "replaces": replaces,
            "launches": total["launches"], "paths": per_path,
            "max_abs_err": max(p["max_abs_err"]
                               for p in per_path.values()),
            "ms": total["ms"],
            "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
            "bound_by": max(per_path.values(),
                            key=lambda p: p["bound_ms"])["bound_by"],
            "library_ms": total["library_ms"] if "library_ms" in total
            else None, "variant": r["variant"],
            "prev_design_ms": total["prev_design_ms"],
            "profiler_ms": total["profiler_ms"]})
    return rows


# the phases ``--phases`` can run alone, after the build (for trying them
# on the card; the script's own run takes no arguments and runs them all)
SELECTABLE = ("long-grid", "collector", "sharded2x2", "wide")


def selected_phases(argv) -> list | None:
    """The phases named by ``--phases a,b`` in order, or None (all)."""
    if not argv:
        return None
    names = argv[1].split(",") if len(argv) == 2 else []
    if argv[0] != "--phases" or not names or not set(names) <= set(
            SELECTABLE):
        raise SystemExit(f"usage: chip_smoke.py [--phases "
                         f"{','.join(SELECTABLE)}]")
    return names


def run_selected(names, lqt_kernel, lqt_scan, fa_kernel, ssd_kernel) -> int:
    """Run the named phases alone; no report line (``wide`` prints its
    two kernels' rows)."""
    from repro_torch.config import get_config
    from repro_torch.kernels.lqt_combine import ref as lqt_ref

    for name in names:
        if name == "long-grid":
            phase("time-varying Q on a long grid")
            long_grid_path(lqt_kernel, lqt_scan)
        elif name == "collector":
            phase("no tensor left to the collector")
            collector_path()
        elif name == "wide":
            g = torch.Generator(device="cuda").manual_seed(SEED)
            phase("wide kernels vs plain versions")
            check_wide(g, lqt_scan, lqt_ref)
            phase("Lorenz-96 wave: the wide kernels on the engine's path")
            rows = wide_timing(g, lqt_scan, lqt_ref,
                               lorenz96_path(lqt_kernel, lqt_scan))
            print(json.dumps({"kernels": rows}))
        else:
            phase(f"sharded training path: {LM_ARCH}, {SHARD_LAYERS} layers "
                  f"on a 2 x 2 (data, model) mesh of cuda:0")
            sharded_training_path(get_config(LM_ARCH), fa_kernel, ssd_kernel,
                                  workdir=ROOT / "build")
        torch.cuda.empty_cache()
    log(f"phases {', '.join(names)} passed (no report: run without "
        f"arguments for the whole script)")
    return 0


def main() -> int:
    phases = selected_phases(sys.argv[1:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # torch imports torch._inductor (with torch._dynamo) lazily, at the
    # first profiler or checkpoint call; the import runs torch.fx.wrap,
    # which keeps its own frame, and so the whole calling stack with every
    # tensor in it, in a reference cycle until the garbage collector runs.
    # Imported here, the stack it keeps holds no tensor.
    importlib.import_module("torch._inductor")

    from repro_torch import tree
    from repro_torch.config import get_config
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.lqt_combine import kernel as lqt_kernel
    from repro_torch.kernels.lqt_combine import ref as lqt_ref
    from repro_torch.kernels.lqt_combine import scan as lqt_scan
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.kernels.ssd import ref as ssd_ref
    from repro_torch.models import transformer

    t_start = time.perf_counter()
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")

    phase("build")
    build_all({"lqt_combine": lqt_kernel.build,
               "lqt_scan": lqt_scan.build,
               "lqt_scan_wide": lqt_scan.build_wide,
               **{f"flash_attention {v}": (lambda v=v: fa_kernel.build(v))
                  for v in fa_kernel.VARIANTS},
               **{f"ssd_chunked {v}": (lambda v=v: ssd_kernel.build(v))
                  for v in ssd_kernel.VARIANTS}})
    if phases is not None:
        return run_selected(phases, lqt_kernel, lqt_scan, fa_kernel,
                            ssd_kernel)

    phase("kernel vs plain version")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    check_lqt(g, lqt_kernel, lqt_ref)
    check_scan(g, lqt_scan, lqt_ref)
    check_wide(g, lqt_scan, lqt_ref)
    errs = {"flash_attention": check_fa(g, fa_kernel, fa_ref),
            "ssd_chunked": check_ssd(g, ssd_kernel, ssd_ref)}

    phase("estimation path")
    paths, cells = {}, {}
    paths["estimation"], cells["estimation"] = estimation_path(lqt_kernel,
                                                               lqt_scan)
    torch.cuda.empty_cache()
    phase("cache/AOT path: ExecutableCache, Estimator.lower")
    paths["cache"] = cache_path(lqt_kernel, lqt_scan, cells["estimation"])
    torch.cuda.empty_cache()

    phase(f"nonlinear path: coordinated turn, {NL_MODE}, {NL_ITERS} "
          f"iterations")
    paths["nonlinear"], cells["nonlinear"] = nonlinear_path(lqt_kernel,
                                                            lqt_scan)
    torch.cuda.empty_cache()
    phase("Lorenz-96 wave: the wide kernels on the engine's path")
    l96_wave = lorenz96_path(lqt_kernel, lqt_scan)

    phase(f"sigma-point path: coordinated turn, {NL_MODE}, {NL_ITERS} "
          f"iterations")
    t0 = time.perf_counter()
    paths["sigma_point"] = sigma_point_path(lqt_kernel, lqt_scan,
                                            cells["nonlinear"])
    torch.cuda.empty_cache()
    phase("ragged path: Wiener velocity, pad-and-bucket")
    paths["ragged"] = ragged_path(lqt_kernel, lqt_scan, cells["estimation"])
    torch.cuda.empty_cache()
    log(f"sigma-point and ragged phases: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    phase("trajectory engine: the ragged cell's records in waves")
    paths["trajectory_engine"] = trajectory_engine_path(
        lqt_kernel, lqt_scan, cells["estimation"])
    torch.cuda.empty_cache()
    phase("streaming engine, linear")
    paths["streaming"] = streaming_linear_path(lqt_kernel, lqt_scan)
    torch.cuda.empty_cache()
    phase("streaming engine, sigma point")
    paths["streaming_sigma_point"] = streaming_sigma_point_path(
        lqt_kernel, lqt_scan)
    torch.cuda.empty_cache()
    log(f"engine phases: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    phase("time-sharded path: method='distributed' on P x cuda:0")
    time_sharded_path(lqt_kernel, lqt_scan, cells["estimation"])
    torch.cuda.empty_cache()
    phase("batch-sharded path: stacked64 on a batch axis")
    paths["batch_sharded"] = batch_sharded_path(lqt_kernel, lqt_scan,
                                                cells["estimation"])
    torch.cuda.empty_cache()
    log(f"sharded phases: {time.perf_counter() - t0:.1f} s")
    phase("kernel combine in user scans: scan_combine_fn")
    user_scans = user_scan_path(lqt_kernel, cells["estimation"])
    del cells
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase(f"time-varying Q on a long grid: {LONG_BLOCKS} x {NSUB} and "
          f"{RECORDS} x {N_BLOCKS} x {NSUB}")
    paths["long_grid"] = long_grid_path(lqt_kernel, lqt_scan)
    torch.cuda.empty_cache()
    log(f"long-grid phase: {time.perf_counter() - t0:.1f} s")

    phase("lqt_scan timing at the estimation paths' scans")
    kernels = [scan_timing(g, lqt_scan, lqt_ref, paths)]
    torch.cuda.empty_cache()
    phase("lqt_scan_wide and lqt_combine_wide timing at a Lorenz-96 "
          "wave's launches")
    kernels += wide_timing(g, lqt_scan, lqt_ref, l96_wave)
    phase("lqt_combine timing at the user scans' and the per-level "
          "scan's launch shapes")
    kernels.append(combine_timing(
        g, lqt_kernel, lqt_ref,
        {k: paths[k] for k in ("estimation", "nonlinear")} | user_scans))
    torch.cuda.empty_cache()

    phase(f"serving path: {LM_ARCH}, bfloat16, full width")
    cfg = get_config(LM_ARCH)
    params = transformer.init(
        cfg, torch.Generator(device="cuda").manual_seed(SEED))
    n_params = sum(t.numel() for t in tree.leaves(params))
    log(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{n_params / 1e9:.3f} B parameters ({cfg.param_count() / 1e9:.3f} B "
        f"by the config's count), random weights (seed {SEED})")
    launches = serving_path(cfg, params, fa_kernel, ssd_kernel)
    torch.cuda.empty_cache()

    phase("kernel path vs plain path, float32")
    cross_path(cfg, params)
    torch.cuda.empty_cache()
    phase(f"pipeline path: {LM_ARCH}, {PIPE_STAGES} stages on "
          f"{PIPE_STAGES} x cuda:0")
    pipe_launches = pipeline_path(cfg, params, fa_kernel, fa_ref,
                                  ssd_kernel, g)
    del params
    torch.cuda.empty_cache()

    phase(f"training path: {LM_ARCH}, bfloat16, full width")
    t0 = time.perf_counter()
    train_launches = training_path(cfg, fa_kernel, ssd_kernel,
                                   ROOT / "build")
    phase("training: kernel path vs plain path, float32")
    training_cross_path(cfg, fa_kernel, ssd_kernel)
    torch.cuda.empty_cache()
    log(f"training phases: {time.perf_counter() - t0:.1f} s")
    phase(f"compressed data-parallel path: {LM_ARCH}, {DP_LAYERS} layers "
          f"on {DP_SHARDS} x cuda:0")
    dp_launches = compressed_dp_path(cfg, fa_kernel, ssd_kernel)
    torch.cuda.empty_cache()
    phase(f"sharded training path: {LM_ARCH}, {SHARD_LAYERS} layers on a "
          f"{' x '.join(map(str, SHARD_MESHES[LM_ARCH]))} (data, model) "
          f"mesh of cuda:0")
    t0 = time.perf_counter()
    hymba_sharded = sharded_training_path(cfg, fa_kernel, ssd_kernel,
                                          workdir=ROOT / "build")
    torch.cuda.empty_cache()
    log(f"sharded training phase ({LM_ARCH}): "
        f"{time.perf_counter() - t0:.1f} s")
    phase(f"sharded training path, seq_parallel: {LM_ARCH}, {SHARD_LAYERS} "
          f"layers on a {' x '.join(map(str, SHARD_MESHES[LM_ARCH]))} "
          f"(data, model) mesh of cuda:0")
    t0 = time.perf_counter()
    hymba_sp = sharded_training_path(
        dataclasses.replace(cfg, seq_parallel=True), fa_kernel, ssd_kernel)
    seq_parallel_report(cfg)
    torch.cuda.empty_cache()
    log(f"sharded training phase, seq_parallel ({LM_ARCH}): "
        f"{time.perf_counter() - t0:.1f} s")
    phase(f"sharded serving path: {LM_ARCH}, full width and depth on a "
          f"{' x '.join(map(str, SHARD_MESHES[LM_ARCH]))} (data, model) "
          f"mesh of cuda:0")
    t0 = time.perf_counter()
    hymba_serve_sharded = sharded_serving_path(cfg, fa_kernel, ssd_kernel)
    torch.cuda.empty_cache()
    log(f"sharded serving phase ({LM_ARCH}): "
        f"{time.perf_counter() - t0:.1f} s")
    micro = TRAIN_BATCH // TRAIN_MICRO
    lm_paths = {"serving": (cfg, LM_BATCH, launches),
                "training": (cfg, micro, train_launches),
                "pipeline": (cfg, PIPE_BATCH, pipe_launches),
                "compressed data-parallel": (cfg, DP_BATCH, dp_launches),
                "sharded training": hymba_sharded,
                "sharded training, seq_parallel": hymba_sp,
                "sharded serving": hymba_serve_sharded}

    t0 = time.perf_counter()
    phase(f"serving path: {MOE_ARCH}, bfloat16, full width and depth")
    mcfg = get_config(MOE_ARCH)
    params = transformer.init(
        mcfg, torch.Generator(device="cuda").manual_seed(SEED))
    n_params = sum(t.numel() for t in tree.leaves(params))
    log(f"{mcfg.name}: {mcfg.num_layers} layers, d_model {mcfg.d_model}, "
        f"{mcfg.moe_experts} experts top {mcfg.moe_topk} of d_ff "
        f"{mcfg.d_ff}, {n_params / 1e9:.3f} B parameters "
        f"({mcfg.param_count() / 1e9:.3f} B by the config's count, "
        f"{mcfg.active_param_count() / 1e9:.3f} B active a token; "
        f"{n_params * 2 / 1e9:.2f} GB in bf16), random weights (seed {SEED})")
    lm_paths["granite serving"] = (
        mcfg, LM_BATCH, serving_path(mcfg, params, fa_kernel, ssd_kernel))
    torch.cuda.empty_cache()
    phase(f"{MOE_ARCH}: kernel path vs plain path, float32, "
          f"{TRAIN_CHECK_LAYERS} layers")
    cross_path(mcfg, params, TRAIN_CHECK_LAYERS)
    del params
    torch.cuda.empty_cache()
    phase(f"training path: {MOE_ARCH}, bfloat16, full width, "
          f"{MOE_TRAIN_LAYERS} layers")
    mcfg16, moe_train_launches = moe_training_path(
        mcfg, fa_kernel, ssd_kernel, ROOT / "build")
    lm_paths["granite training"] = (mcfg16, micro, moe_train_launches)
    phase(f"{MOE_ARCH} training: kernel path vs plain path, float32")
    training_cross_path(mcfg, fa_kernel, ssd_kernel)
    torch.cuda.empty_cache()
    phase(f"sharded training path: {MOE_ARCH}, {SHARD_LAYERS} layers on a "
          f"{' x '.join(map(str, SHARD_MESHES[MOE_ARCH]))} (data, model) "
          f"mesh of cuda:0")
    t1 = time.perf_counter()
    lm_paths["granite sharded training"] = sharded_training_path(
        mcfg, fa_kernel, ssd_kernel)
    torch.cuda.empty_cache()
    log(f"sharded training phase ({MOE_ARCH}): "
        f"{time.perf_counter() - t1:.1f} s")
    phase(f"sharded serving path: {MOE_ARCH}, full width and depth on a "
          f"{' x '.join(map(str, SHARD_MESHES[MOE_ARCH]))} (data, model) "
          f"mesh of cuda:0")
    t1 = time.perf_counter()
    lm_paths["granite sharded serving"] = sharded_serving_path(
        mcfg, fa_kernel, ssd_kernel)
    torch.cuda.empty_cache()
    log(f"sharded serving phase ({MOE_ARCH}): "
        f"{time.perf_counter() - t1:.1f} s")
    log(f"{MOE_ARCH} phases: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    phase(f"dp-only path: {DP_ONLY_ARCH} on a "
          f"{' x '.join(map(str, DP_ONLY_MESH))} (data, model) mesh of "
          f"cuda:0, batch over both")
    scfg = get_config(DP_ONLY_ARCH)
    params = transformer.init(
        scfg, torch.Generator(device="cuda").manual_seed(SEED))
    n_params = sum(t.numel() for t in tree.leaves(params))
    log(f"{scfg.name}: {scfg.num_layers} layers, d_model {scfg.d_model}, "
        f"{scfg.num_heads}/{scfg.num_kv_heads} heads, vocab "
        f"{scfg.padded_vocab} (tied; split {DP_ONLY_MESH[1]} ways under "
        f"dp-only), {n_params / 1e6:.1f} M parameters "
        f"({scfg.param_count() / 1e6:.1f} M by the config's count), random "
        f"weights (seed {SEED}); first the single-device engine")
    lm_paths["smollm serving"] = (scfg, LM_BATCH, serving_path(
        scfg, params, fa_kernel, ssd_kernel))
    del params
    torch.cuda.empty_cache()
    dcfg = dataclasses.replace(scfg, parallel_policy="dp_only")
    lm_paths["smollm dp-only training"] = sharded_training_path(
        dcfg, fa_kernel, ssd_kernel, DP_ONLY_MESH, scfg.num_layers)
    torch.cuda.empty_cache()
    lm_paths["smollm dp-only serving"] = sharded_serving_path(
        dcfg, fa_kernel, ssd_kernel, DP_ONLY_MESH)
    torch.cuda.empty_cache()
    log(f"dp-only phases ({DP_ONLY_ARCH}): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase(f"no tensor left to the collector: a Wiener solve and a "
          f"{COLLECT_ARCH} prefill plus decode with gc disabled")
    collector_path()
    torch.cuda.empty_cache()
    log(f"collector phase: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    for name in ZOO:
        phase(f"the zoo: {name}, full width, {ZOO_LAYERS} layers")
        zcfg, zoo_launches = zoo_path(name, fa_kernel, ssd_kernel)
        if zoo_launches is not None:
            lm_paths[f"{name} serving"] = (zcfg, ZOO_BATCH, zoo_launches)
    log(f"zoo phases: {time.perf_counter() - t0:.1f} s")

    phase(f"dry-run: {len(DRYRUN_CELLS)} cells of the single-pod mesh on "
          f"meta devices")
    dryrun_path()

    phase("LM kernel timing at the serving and training paths' shapes")
    kernels += lm_kernel_timing(lm_paths, fa_kernel, fa_ref, ssd_kernel,
                                ssd_ref, g, errs)

    phase("report")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
