#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (a failed phase exits non-zero; nothing is caught and
passed over):

  1. device and versions, with the card's name and power limit;
  2. build the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc each,
     all at once), timed, with ptxas's registers and spills per kernel of
     ``cache_scan.cu``, ``stack_distance.cu``, ``dram_scan.cu``,
     ``dram_scan_full.cu``, ``rrip_scan.cu``, ``flash_attention.cu``,
     ``mamba2_ssd.cu`` and ``embedding_bag.cu``;
  3. the latency of one dependent step, timed by the probes of
     ``csrc/latency_probe.cu``; then each kernel against its plain torch
     version on the card: K1 cache scan and K2 stack distance on the
     full-size set-group buckets that ``simulate`` produces and on edge
     geometries (K2 also with sets out of range and valid tags of -1), D1
     DRAM scan on the full-size chunk rows, D2 FIFO/SRRIP row scans on the
     full-size calls of the on-chip cache (srrip, fifo: the short route,
     one launch) and of a FIFO TLB with an L2 behind spm (the chunked
     route, speculate + fix-up, with its re-run count against the chunked
     plain version's) and on edge rows (ways 1 to 64, both routes), D1
     also on phase 9's C stream (4 sources, per_core/table_rank) with its
     aggregates on the card against the host's, finish matrix included,
     timed beside the one-source row,
     bitwise; kernel times warm (mean of 20 back-to-back launches) and with
     the L2 cache flushed before each, K1's and K2's per bucket, D2's per
     call with its route, virtual rows, blocks and re-runs, with ns per
     longest-set access (K1, K2) and per chunk (D1), each one's share of its
     chain bound (D2: its own design's and the serial one of a lane per row) and the
     blocks resident per SM; plain times. Then the full-width DLRM-RMC2
     model (60 x 1M x 128 f32 table, filled on the card) and the embedding
     kernels K3 bag, K4 gather and K5 hot-pinned pool on the inputs its
     first request gives them, against their plain versions (bitwise; allclose where K5's hot
     table spans several tiles) and at edge shapes (K3: D 3 to 512, L 1 to
     300, a table view off 16 bytes); kernel, plain and library-call times
     with the L2 cache flushed before each launch, K3 and K5 with their
     share of the bound and their ratio to ``F.embedding_bag``. Then
     the LM kernels K6 flash attention, K7 decode attention and K8 Mamba2
     SSD at the shapes the Zamba2-2.7B serving path gives them and at edge
     shapes (GQA/MQA, d 16/64/72/80/128/256, ragged S and S_max, a q tile
     straddling S, a k whose stride TMA cannot read, valid_len 1 / at a
     chunk's end / one past it / mid-block / S_max, f32 and bf16, causal or
     not, chunk 16/64/128, N = 128, a ragged last chunk), against their
     plain versions at the reference's tolerances, with kernel, plain and
     library-call times (the library call's kernels named from the
     profiler: SDPA's backend); K6's routes (bf16: ``wgmma``, f32: 3xTF32)
     and K8's (bf16: ``mma``, f32: 3xTF32 ``tf32``) are checked on every
     call, K6's TFLOP/s (f32 also beside its f32-accurate product bound at
     the dense TF32 rate) and K7's and K8's TB/s
     printed beside their bounds (K8 with its P-slice and resident blocks
     per SM, f32 also beside its f32-accurate product bound; K5 with its
     share of the bound and F.embedding_bag's time), K7
     held bitwise equal across two calls with NaN past valid_len; then K6
     and K7 at phase 11's shapes: MLA's q/k width 192 with v 128 (padded by
     ``ops.flash_attention``), Whisper-base's encoder (S 1,500, not causal)
     and cross-attention (64 queries over 1,500 keys; one token over 1,500
     positions on K7), Sk one past a tile, one query row, arctic's group of
     7 and granite's MQA group of 48 (K7 at the chunk ``kernel_chunk``
     finds);
  4. ``simulate`` on the full DLRM-RMC2 workload (60 tables x 1M rows x dim
     128, 120 lookups, batch 32, 2 batches) x ``tpuv6e()`` for every
     policy/backend pair, with launch counts reset just before and read
     just after each run (D2: exactly 1 per srrip/fifo ``stack`` or
     ``stack_pallas`` run); results bitwise equal across backends of one
     policy, srrip and fifo equal to the reference's totals; three runs
     with address translation (lru + LRU TLB, srrip + FIFO TLB, spm + FIFO
     TLB; 64 entries of 4 ways, an L2 of 1,024) equal to the reference's
     totals and walks, D2 launched 4 more times per FIFO TLB (L1 and L2,
     each a speculate and a fix-up launch); one K1, one
     K2, one srrip/stack and one spm + FIFO TLB run under
     ``torch.profiler`` for the device's busy share and the device time of
     D1, K1, K2 and D2 in it; small runs on the card equal to the same runs
     on the CPU (every pair, and the translation runs);
  6. the full-width DLRM-RMC2 forward: 4 requests of 32 from
     ``dlrm_batch`` (zipf 1.10), each through the plain path (K3) and the
     hot-pinned path (K5 + K4, the request's own top-256 rows pinned), with
     launch counts reset just before and read just after each forward; the
     two paths agree to 1e-4; a small model on the card equals the same
     model on the CPU; one plain forward (K3's device time) and one pinned
     forward under ``torch.profiler``;
  7. Zamba2-2.7B served at full width (54 Mamba2 layers, d_model 2560, one
     shared attention block applied 9 times, bf16, random weights drawn on
     the card): ``ServingEngine.generate`` on 8 prompts of 1024 tokens from
     ``lm_batch``, 32 new tokens, max_seq 1064; then prefill and each decode
     step apart, with launch counts reset just before and read just after
     each (exactly K8 = 54, K6 = 9, K4 = 1 per prefill and K7 = 9, K4 = 1 per
     step); a teacher-forced check (the step at position 1023 after a
     1023-token prefill against the 1024-token prefill's last logits),
     printed in bf16 and held at 1e-3 / 2e-3 with the same weights in f32; a
     smoke-size Zamba2 on the card against the same model on the CPU (f32
     held at 2e-4 / 2e-3, bf16 at 8e-2); one decode step and one prefill
     under ``torch.profiler``;
  8. the DSE sweep at full width: ``sweep`` of the phase-4 workload x
     ``tpuv6e()`` over spm, lru, srrip, fifo and pinning x 32 and 128 MiB x 8
     and 16 ways x translation off / the phase-4 FIFO TLB (40
     configurations), with launch counts reset just before and read just
     after (D1 and D2, D2 by route; K1 and K2 none under ``stack``); wall s
     per configuration and per memo key and the ``profiling.collect()``
     stages, with the card's name and power limit; four entries bitwise equal
     to independent ``simulate`` calls on the card, with their wall s per
     configuration beside the sweep's; the entries phase 4 pins to the
     reference's totals; on the 128 MiB sub-grid, ``devices=2`` (two shard
     threads on the one card, each on its own stream) timed against the
     unsharded sweep in the order unsharded, sharded, sharded, unsharded,
     and a checkpointed run killed after its first cadence round (an
     injected torn journal append) and resumed, all bitwise equal to the
     grid's entries; a lru sub-grid (32, 64 and 128 MiB x 8 and 16 ways,
     whose configurations share shape buckets) under ``pallas`` (K1) and
     ``stack_pallas`` (K2) equal to ``stack``, with exactly one launch per
     shape bucket across its configurations (fewer than their buckets one
     by one); one sweep of the grid under ``torch.profiler`` for the card's
     busy share;
  9. the multi-core cluster at full width over the phase-4 workload, with
     launch counts reset just before and read just after each run and held
     to the counts the host computes from the shards (K1/K2: the shape
     buckets of each core's lane stream; D2: each core's srrip row tables,
     the central MMU's two FIFO levels; D1: 1 per ``simulate``, and in
     the sweep one per ``dram_timing_many`` dispatch group of its
     requests), with D2 first held bitwise against its plain versions on
     those shards' srrip row tables and the MMU's two FIFO levels: A, 4
     private cores of 32 MiB (``tpuv6e()``'s 128 MiB split four ways),
     batch sharding, lru under ``stack``, ``pallas`` (K1) and
     ``stack_pallas`` (K2), bitwise equal, and srrip/``stack`` (D2); B, 4
     cores behind one shared 128 MiB LLC, lru/``stack``, its hits, misses
     and off-chip reads equal to phase 4's single-core run; C, spm over 4
     table-hash shards placed ``per_core``/``table_rank`` and
     ``per_table``/``hot_replicate``, with C's per-core DRAM finish; D, A's
     lru with phase 4's FIFO TLB (the central MMU over the merged miss
     stream, D2 chunked); A, B, C and D against the reference's totals
     (``REF_CLUSTER``); wall s and ``profiling.collect()`` stages (``place``,
     ``source_finish`` among them) per run; E, the sweep over private/shared
     x symmetric/per_core x interleave/table_rank at A's shape (8
     configurations, 2 classification keys), its private/symmetric/
     interleave entry bitwise equal to A's lru/stack; three small clusters
     on the card equal to the CPU; A under ``torch.profiler`` for the
     card's busy share;
 10. the request-level serving simulator at full width over the phase-4
     workload's embedding op on ``tpuv6e()`` (``SERVING``): steady_off
     (Poisson, 128 requests, popularity drift, 32 slots, every policy off)
     under lru ``stack``, ``pallas`` (K1) and ``stack_pallas`` (K2), bitwise
     equal, and srrip/``stack`` (D2); overload_storm (bursty, 96 requests,
     16 slots, admission, deadline, retries, ``hot_rows_only``) under
     lru/``pallas`` and srrip/``stack``; deadline_retry (48 requests, 8
     slots, a deadline under one batch's service, 3 retries), its event
     clock never going backwards; launch counts reset just before and read
     just after each run, D1 held to one launch per ``simulate_embedding``
     call the oracle makes (1 on the all-off path, one a served batch in a
     closed loop), K1/K2/D2 printed; every run equal to the JAX package's
     results (``REF_SERVING``), its replay through ``ReplayOracle`` equal,
     and its ``batch_stats`` equal to one plain ``simulate_embedding`` over
     the batches the replay composed (the all-off path also over the
     arrival-order chunks); wall s and ``profiling.collect()`` stages per
     run, p50/p95/p99 in simulated TPUv6e µs; the closed loop rerun from a
     fresh memory system, equal, under ``torch.profiler``; a serving sweep
     (spm, lru x steady_off, overload_storm cut to 32 requests) equal to
     direct ``simulate_serving`` calls, ``devices=2`` and a killed and
     resumed checkpointed run equal to it; the JAX tests' small spec on the
     card equal to the CPU for every scenario (batches of no lookup and one
     among them); ``shard_lookup_cores_device``, ``classify_device`` and
     ``translate_device`` on phase 4's trace equal to the host versions;
 11. the remaining LM architectures on the card (bf16, random weights drawn
     on the card, each model freed before the next loads):
     DeepSeek-V2-Lite-16B at full width and depth (27 layers of MLA + 64
     routed experts top-6 + 2 shared) and Whisper-base at full width (its
     encoder over 8 x 1,500 random frames, then a 64-token prompt), arctic
     (1 layer), chameleon (2) and granite-34b (2) at full width:
     ``ServingEngine.generate`` of 32 new tokens for 8 prompts (1024 tokens
     but Whisper's), its launches held to the prefill's and steps' counts
     (K6 once a layer per prefill, twice for Whisper; K7 once a layer per
     step, twice for Whisper, never for MLA's absorbed decode), a second
     generate giving the same greedy tokens, the prefill and each step apart,
     timed; DeepSeek's decode step and prefill under ``torch.profiler`` and
     beside their device bounds; the six at their smoke size on the card
     against the CPU, teacher-forced, and each step after a prefill against
     the forward;
 12. training on the card, no kernel launched (the train step runs the
     reference's plain route, ``use_pallas=False``; launch counts reset
     before and read after each part): stablelm-3b at full width and depth
     (32 layers, d_model 2560, bf16, 2.8 B parameters), default AdamW,
     remat, batch 8 x 1,024 of ``lm_batch``, 6 steps of one batch, the loss
     falling and finite, step s, tokens/s, peak memory and the product bound
     (8 x N x tokens / 989 TFLOP/s) beside the card's name and power limit,
     one more step under ``torch.profiler`` for the busy share; mamba2-130m
     at full width and depth (seq 256) through the sequential SSD
     recurrence: ``launch/train.py`` under deterministic algorithms run
     straight for 6 steps (each timed), and again stopped by SIGTERM after
     its second step (it saves at the end of the step it is in) and
     resumed, its final state bitwise the straight run's; one f32 train step of six families' smoke configs on
     the card against the CPU (loss, grad norm, gradients, updated
     parameters); a cached step of 4 new tokens after a prefill (stablelm,
     zamba2; f32 and bf16) on the card against the CPU;
 13. the last slice on the card: (a) D3, the per-access DRAM scan with
     arrival times, bitwise against its plain version at 4, 16 and 32 rows
     x L of 1, 100 and 2,048 (8 banks, the registers route with its
     pre-pass's codes and hits held too, and 17, the shared route; a
     non-zero interval, start, both, fractional values), then
     ``simulate_dram`` with (interval 0.5) and (interval 2.0, start 1,000)
     over phase 4's lru/stack miss trace (both batches, 3,254,576 lines),
     one launch of D3 and one of its pre-pass each and no other kernel,
     equal to the JAX package's ``REF_D3``, and its host stages timed one
     by one; D3 at that width against its plain version, the scan and the
     pre-pass timed apart (warm and L2 flushed), the scan beside its chain
     bound;
     (b) ``ring_matmul`` and ``psum_matmul`` on a one-rank NCCL group at
     stablelm-3b's MLP down projection (x 8,192 x 6,912 @ w 6,912 x 2,560,
     f32 and bf16) against ``x @ w`` at 1e-5 / 8e-2, timed beside
     ``torch.matmul``; (c) the smoke stablelm-3b train state saved and
     restored with ``shardings=`` (``param_specs`` on a (1, 1) mesh of the
     card): every leaf a DTensor on the card, bitwise what was saved;
 14. the dry run (``launch/dryrun.py``) at full width on the production
     meshes, in a process of its own started beside phase 2's build (its
     fake process group of 256 or 512 ranks never meets phase 13's NCCL
     group): stablelm-3b ``train_4k`` on ``pod`` and DeepSeek-V2-Lite-16B
     ``decode_32k`` on ``multipod``, fake tensors on the card; each
     record's status, per-device FLOPs, bytes, collective bytes by kind,
     memory and ``total_s`` printed beside the card's name and power limit;
     it fails unless both are ``ok`` and no kernel was launched;
  5. (printed last) each kernel's bound: the largest of its bytes over the
     HBM rate, its matrix-product FLOPs over the bf16 tensor-core rate, its
     other operations over the peak scalar rate, and its longest chain of
     dependent steps times the probed step latency.

Then it prints the ``nvidia-smi`` name/power line, one ``{"kernels": ...}``
JSON line (K1, K2 and D1 also with their launches in phase 8's sweeps,
``sweep_launches``, on their first entry; D2's, by route, on
``rrip_scan[srrip]``; K1's, K2's, D2's and D1's entries with their
launches in the phase-9 runs of ``CLUSTER_RUNS``, D1's in every run on
``dram_scan[spm 4 cores]`` only, ``cluster_launches``; K1, K2, D1 and D2
with their launches in each phase-10 run, ``serving_launches``, on
``cache_scan[lru]``, ``stack_distance[lru]``, ``dram_scan[spm]`` and
``rrip_scan[srrip]``; D3's and its pre-pass's launches in phase 13's first
``simulate_dram``; K6 f32's in phase 7's f32 teacher-forced check)
and, last,
``{"ok": true, "device": {...}}``.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet), used for the bounds below.
HBM_BYTES_PER_S = 3.35e12
# Scalar (non-tensor-core) rate; the kernels' integer and f32 work is
# counted against it.
SCALAR_OPS_PER_S = 67e12
# Dense bf16 tensor-core rate: the matrix products of the LM kernels (K6,
# K7, K8) could run there, so their FLOPs are counted against it.
TENSOR_FLOPS_PER_S = 989e12
# Dense TF32 tensor-core rate: the f32 routes of K6 and K8 run 3 TF32
# products for each of their products (3xTF32), the least they could take
# at f32 accuracy. Phase 3 prints that product bound beside the kernels
# line's bound_ms, which keeps one definition for every kernel.
TF32_FLOPS_PER_S = 494.7e12
# The kernels are chains of dependent steps, so their operations also bound
# them through latency: longest chain x one step's latency, measured in this
# run by the probes of csrc/latency_probe.cu. ``bound_ms`` is the largest of
# bytes / HBM rate, operations / peak rate and that chain; ``bound_by`` says
# "operations" when either of the last two wins.
PROBE_STEPS = (1 << 16, 1 << 20)

RUNS = [
    ("spm", "stack"),
    ("lru", "stack"),
    ("lru", "pallas"),
    ("lru", "stack_pallas"),
    ("lru", "scan"),
    ("srrip", "stack"),
    ("srrip", "stack_pallas"),
    ("srrip", "pallas"),
    ("srrip", "scan"),
    ("fifo", "stack"),
    ("fifo", "pallas"),
    ("fifo", "scan"),
]
# The kernel each (policy, backend) pair's classification launches, and
# how often per simulate where that is fixed (D2: one call per
# classification, its rows short: one launch).
PAIR_KERNEL = {("lru", "pallas"): "cache_scan", ("srrip", "pallas"): "cache_scan",
               ("fifo", "pallas"): "cache_scan", ("lru", "stack_pallas"): "stack_distance",
               ("srrip", "stack"): "rrip_scan", ("srrip", "stack_pallas"): "rrip_scan",
               ("fifo", "stack"): "rrip_scan"}
RRIP_LAUNCHES = 1
# D2's launches per FIFO-TLB charge with an L2: the L1's and the L2's rows
# both take the chunked route (speculate + fix-up).
TLB_LAUNCHES = 4
# The reference's full-width totals (the JAX package run on the CPU; this
# script imports nothing of JAX): srrip and fifo under any backend,
# and three runs with translation(entries=64, ways=4, l2_entries=1024,
# replacement=R): (on-chip policy, R) -> (total_cycles, tlb_walks, D2's
# launches in the run).
REF_TOTAL = {"srrip": 188579.2791375, "fifo": 188774.5291375}
TRANSLATION = dict(entries=64, ways=4, l2_entries=1024)
REF_TRANSLATION = {("lru", "lru"): (44106659.2791375, 406646, 0),
                   ("srrip", "fifo"): (44109683.2791375, 406674, RRIP_LAUNCHES + TLB_LAUNCHES),
                   ("spm", "fifo"): (49056511.9041375, 452077, TLB_LAUNCHES)}
# The DSE sweep of phase 8: these axes x translation off / the FIFO TLB of
# phase 4 over the phase-4 workload, 40 configurations; journal rounds of
# SWEEP_CADENCE memo keys in its kill-and-resume check.
SWEEP_POLICIES = ("spm", "lru", "srrip", "fifo", "pinning")
SWEEP_CAPACITIES = (32 << 20, 128 << 20)
SWEEP_WAYS = (8, 16)
LRU_SUB_CAPACITIES = (32 << 20, 64 << 20, 128 << 20)
SWEEP_CADENCE = 4
# Phase 9, the multi-core cluster over the phase-4 workload: A is tpuv6e()'s
# 128 MiB split four ways (the equal-silicon comparison of the JAX package's
# examples/multicore_scaling.py), B one shared 128 MiB LLC, C spm over
# table-hash shards under two NUMA placements, D A's lru behind phase 4's
# FIFO TLB (the central MMU), E the sweep over topology x affinity x
# placement. REF_CLUSTER holds the reference's full-width (total_cycles,
# offchip_reads) of six of those runs (the JAX package on the CPU,
# cache_backend "stack").
CLUSTER_CORES = 4
CLUSTER_CAPACITY = 32 << 20
REF_CLUSTER = {"A lru/stack": (198927.5291375, 3545276),
               "B lru/stack": (188579.2791375, 3353596),
               "C per_core/table_rank": (793598.8807, 3785420),
               "C per_table/hot_replicate": (696120.2557, 3785420),
               "A srrip/stack": (198927.5291375, 3545316),
               "D lru/stack + FIFO TLB": (46703539.5291375, 3545276)}
# The phase-9 runs whose launches each scan kernel's JSON entry reports; an
# entry with no phase-4 run takes its "launches" from the first. D1's are
# reported once, on its 4-source entry, for every run.
CLUSTER_RUNS = {"cache_scan[lru]": ("A lru/pallas",),
                "stack_distance[lru]": ("A lru/stack_pallas",),
                "rrip_scan[srrip]": ("A srrip/stack",),
                "rrip_scan[tlb fifo]": ("D lru/stack + FIFO TLB",),
                "dram_scan[spm 4 cores]": (
                    "C per_core/table_rank", "C per_table/hot_replicate", "A lru/stack",
                    "A lru/pallas", "A lru/stack_pallas", "A srrip/stack", "B lru/stack",
                    "D lru/stack + FIFO TLB", "E sweep")}
# Phase 10, the request-level serving simulator over the phase-4 workload's
# embedding op (60 tables x 1M rows x dim 128, 120 lookups a table, every
# table in every request) on tpuv6e(). The all-off stream's service is
# 1,025.95 cycles a request (the JAX package on the CPU, lru and srrip under
# "stack": batches of 32 served in 41,599, 32,603, 28,560 and 28,560
# cycles), so steady_off arrives every ~2x that and the overload streams
# every ~0.1x. Shapes follow the JAX package's examples/dlrm_serve.py and
# scripts/serving_smoke.py; request counts are the cut (depth).
SERVICE_PER_REQUEST = 1_025.95
STEADY_GAP = 2_000.0
OVERLOAD_GAP = 100.0
_OVERLOAD = dict(pattern="bursty", mean_gap_cycles=OVERLOAD_GAP, num_requests=96, seed=23,
                 burst_len=16, zipf_s=1.10)
SERVING = {
    "steady_off": dict(
        traffic=dict(pattern="poisson", mean_gap_cycles=STEADY_GAP, num_requests=128, seed=42,
                     zipf_s=1.10, zipf_drift=0.3, drift_period=32),
        policy={}, batch_slots=32),
    # A deadline of ~2 batch services of 16, a backoff of ~one. Degradation
    # arms at a queue of 4 left behind a launch: admission caps the queue
    # at 24, so a batch of 16 leaves at most 8 (dlrm_serve.py's 12 is for
    # batches of 8).
    "overload_storm": dict(
        traffic=_OVERLOAD,
        policy=dict(admission_watermark=24, deadline_cycles=36_000, max_retries=2,
                    retry_backoff_cycles=16_000.0, degrade_mode="hot_rows_only",
                    degrade_watermark=4, hot_fraction=0.1),
        batch_slots=16),
    # A deadline under one batch's service (~8,200 cycles for 8), a short
    # backoff: expired attempts reschedule from instants the clock passed.
    "deadline_retry": dict(
        traffic={**_OVERLOAD, "num_requests": 48},
        policy=dict(deadline_cycles=6_000, max_retries=3, retry_backoff_cycles=1_000.0),
        batch_slots=8),
}
# The JAX package's results of these scenarios at full width (on the CPU,
# cache_backend "stack"; the fields of ``serving_pins``), by (scenario,
# on-chip policy).
REF_SERVING = {
    ("steady_off", "lru"): dict(
        offered=128, completed=128, shed=0, timed_out=0, retries=0, abandoned=0,
        degraded_batches=0, num_batches=4, makespan_cycles=276903, p50_cycles=65729.5,
        p99_cycles=106182.15, batch_cycles='131320.578125', dram_cycles='114803.03515625',
        cache_hits=5232104),
    ("steady_off", "srrip"): dict(
        offered=128, completed=128, shed=0, timed_out=0, retries=0, abandoned=0,
        degraded_batches=0, num_batches=4, makespan_cycles=276903, p50_cycles=65729.5,
        p99_cycles=106182.15, batch_cycles='131320.578125', dram_cycles='114803.03515625',
        cache_hits=5232112),
    ("deadline_retry", "lru"): dict(
        offered=48, completed=32, shed=0, timed_out=112, retries=96, abandoned=16,
        degraded_batches=0, num_batches=4, makespan_cycles=45682, p50_cycles=30296.0,
        p99_cycles=45360.14, batch_cycles='45557.3505859375', dram_cycles='45557.3505859375',
        cache_hits=1047432),
    ("overload_storm", "lru"): dict(
        offered=96, completed=88, shed=104, timed_out=8, retries=104, abandoned=8,
        degraded_batches=2, num_batches=6, makespan_cycles=101752, p50_cycles=53386.0,
        p99_cycles=97629.02, batch_cycles='97066.5498046875', dram_cycles='95634.24609375',
        cache_hits=3212392),
    ("overload_storm", "srrip"): dict(
        offered=96, completed=88, shed=104, timed_out=8, retries=104, abandoned=8,
        degraded_batches=2, num_batches=6, makespan_cycles=101752, p50_cycles=53386.0,
        p99_cycles=97629.02, batch_cycles='97066.5498046875', dram_cycles='95634.24609375',
        cache_hits=3212680),
}
# Phase 13 (a): D3, ``simulate_dram`` with arrival times over phase 4's
# lru/stack miss trace (both batches as one trace, 3,254,576 lines). The
# JAX package's results on the CPU (``repro.core.memory.dram.simulate_dram``
# on the same lines), by (issue interval, start cycle): (finish_cycle,
# total_latency_cycles, row_hits, row_misses, accesses).
D3_ARRIVALS = ((0.5, 0.0), (2.0, 1000.0))
REF_D3 = {(0.5, 0.0): (1637923.0, 94614490752.0, 2847804, 406772, 3254576),
          (2.0, 1000.0): (6519970.0, 375807299200.0, 2847804, 406772, 3254576)}
# D3 against its plain version at small sizes: rows x slots, 8 banks, and
# (interval, start) pairs covering each arrival form.
D3_SMALL_ROWS = (4, 16, 32)
D3_SMALL_L = (1, 100, 2048)
D3_SMALL_ARRIVALS = ((0.5, 0.0), (0.0, 1000.0), (2.0, 1000.0), (0.37, 13.3))
# D3's routes by banks: at most 16 the registers route (the pre-pass, then
# the scan), 17 the shared route.
D3_SMALL_BANKS = (8, 17)
# Phase 13 (b): stablelm-3b's MLP down projection, x (tokens, d_ff) @ w
# (d_ff, d_model), for a batch of 8 x 1,024 tokens.
CMM_SHAPE = (8 * 1024, 6912, 2560)
CMM_TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-2}
# The serving sweep of phase 10: these policies x steady_off and
# overload_storm with their request counts cut to SWEEP_SERVING_REQUESTS.
SWEEP_SERVING_POLICIES = ("spm", "lru")
SWEEP_SERVING_REQUESTS = 32
# The JAX tests' small spec (tests/test_serving_sim.py): card against CPU.
SMALL_SERVING_SPEC = dict(num_tables=4, rows_per_table=1000, dim=32, lookups_per_sample=4,
                          dtype_bytes=4)
EDGE_GEOMETRIES = [(1, 1), (1, 4), (3, 2), (7, 5), (16, 7), (16, 16), (4, 32), (2, 33), (2, 64)]
KERNEL_SOURCES = {
    "cache_scan": ("src/repro_torch/csrc/cache_scan.cu", "src/repro/kernels/cache_scan.py:44"),
    "stack_distance": ("src/repro_torch/csrc/stack_distance.cu", "src/repro/kernels/stack_distance.py:31"),
    "dram_scan": ("src/repro_torch/csrc/dram_scan.cu", "src/repro/core/memory/dram.py:315"),
    "dram_scan_full": ("src/repro_torch/csrc/dram_scan_full.cu",
                       "src/repro/core/memory/dram.py:259"),
    "dram_prepass": ("src/repro_torch/csrc/dram_scan_full.cu",
                     "src/repro/core/memory/dram.py:259"),
    "rrip_scan": ("src/repro_torch/csrc/rrip_scan.cu", "src/repro/core/memory/rrip.py:137"),
    "embedding_bag": ("src/repro_torch/csrc/embedding_bag.cu",
                      "src/repro/kernels/embedding_bag.py:36"),
    "embedding_gather": ("src/repro_torch/csrc/embedding_bag.cu",
                         "src/repro/kernels/embedding_bag.py:83"),
    "vmem_gather_pool": ("src/repro_torch/csrc/embedding_bag.cu",
                         "src/repro/kernels/embedding_bag.py:113"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:27"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:23"),
    "mamba2_ssd": ("src/repro_torch/csrc/mamba2_ssd.cu", "src/repro/kernels/mamba2_ssd.py:28"),
}
# Hot rows pinned on the DLRM path (examples/dlrm_serve.py pins 256).
N_HOT = 256
DLRM_STEPS = 4
# Zamba2-2.7B serving (phase 7): batch, prompt, new tokens, cache length
# (launch/serve.py's max_seq = prompt + new + 8).
LM_BATCH, LM_PROMPT, LM_NEW = 8, 1024, 32
LM_MAX_SEQ = LM_PROMPT + LM_NEW + 8
# Whisper-base serving (phase 11): the encoder's 1,500 frames, a prompt of
# 64 tokens, LM_NEW new ones, batch LM_BATCH.
WHISPER_FRAMES, WHISPER_PROMPT = 1500, 64
# Phase 11's full-width models with their depth cut (layers kept), so that
# each fits one card beside nothing else.
CUT_DEPTH = {"arctic_480b": 1, "chameleon_34b": 2, "granite_34b": 2}
# The phase-11 run whose launches each of its report entries gives.
PHASE11_RUN = {"flash_attention[mla d192]": "deepseek",
               "flash_attention[whisper encoder]": "whisper",
               "flash_attention[whisper cross]": "whisper",
               "flash_attention[whisper self]": "whisper",
               "flash_attention[arctic g7]": "arctic_480b",
               "flash_attention[chameleon g8]": "chameleon_34b",
               "flash_attention[granite mqa g48]": "granite_34b",
               "decode_attention[whisper cross]": "whisper",
               "decode_attention[whisper self]": "whisper",
               "decode_attention[granite mqa g48]": "granite_34b",
               "decode_attention[arctic g7]": "arctic_480b",
               "decode_attention[chameleon g8]": "chameleon_34b"}
# The reference's tolerances (tests/test_kernels.py, tests/test_decode_kernel.py).
# K8's bf16 output is rounded once from f32 on both routes, so there the two
# may differ by one bf16 step, 2^-7 relative, besides the reference's 2e-4.
LM_TOL = {
    ("flash_attention", torch.float32): dict(atol=2e-5, rtol=2e-5),
    ("flash_attention", torch.bfloat16): dict(atol=3e-2, rtol=0.0),
    ("decode_attention", torch.float32): dict(atol=2e-5, rtol=2e-5),
    ("decode_attention", torch.bfloat16): dict(atol=4e-2, rtol=0.0),
    ("mamba2_ssd", torch.float32): dict(atol=2e-4, rtol=2e-3),
    ("mamba2_ssd", torch.bfloat16): dict(atol=2e-4, rtol=2.0 ** -7),
}


def serving_pins(res) -> dict:
    """The fields of a ``ServingResult`` that ``REF_SERVING`` pins: counters,
    batches, makespan, p50/p99 cycles, the repr of the summed per-batch
    cycles and DRAM cycles, and the summed cache hits (these two tell the
    on-chip policies apart where the service is vector-bound)."""
    keys = ("offered", "completed", "shed", "timed_out", "retries", "abandoned",
            "degraded_batches", "num_batches", "makespan_cycles")
    pins = {k: getattr(res, k) for k in keys}
    pins.update(p50_cycles=res.p50_cycles, p99_cycles=res.p99_cycles,
                batch_cycles=repr(sum(st.cycles for st in res.batch_stats)),
                dram_cycles=repr(sum(st.dram_cycles for st in res.batch_stats)),
                cache_hits=sum(st.cache_hits for st in res.batch_stats))
    return pins


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean device ms of ``fn()`` over ``reps`` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_cold_ms(fn, reps: int, flush) -> float:
    """Mean device ms of ``fn()`` with the L2 cache flushed (``flush``
    overwrites a buffer larger than it) before each of ``reps`` runs, after
    one warm-up."""
    fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def device_busy(events, wall: float, kernels=(), top: int = 6) -> str:
    """Busy share of the card from a profiler's events: device events
    (kernels, copies, fills) merged into busy intervals, the ``top`` names
    by device time; plus the summed device time of the events whose names
    hold each of ``kernels``."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return "device busy not measured (the profiler recorded no device events)"
    busy_us, end, by_name = 0.0, -math.inf, {}
    for a, b, name in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    named = {k: round(sum(t for n, t in by_name.items() if k in n), 3) for k in kernels}
    return (f"device busy {busy_us / 1e6!r} s ({100 * busy_us / 1e6 / wall!r}% busy) over "
            f"{len(spans)} device events; top device time (us): "
            f"{json.dumps([[n[:60], round(t, 3)] for n, t in top])}"
            f"{f'; device time (us) of {json.dumps(named)}' if kernels else ''}")


def device_kernels(fn, top: int = 3) -> str:
    """The device kernels one call of ``fn`` runs (a library call's backend,
    read from the profiler), by device time, longest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    times = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            times[e.name] = times.get(e.name, 0.0) + e.time_range.end - e.time_range.start
    if not times:
        return "kernels not measured: the profiler recorded no device events"
    names = sorted(times, key=lambda n: -times[n])[:top]
    return "kernels " + "; ".join(n[:90] for n in names)


def probe_step_ms(launch, inp, out, want) -> float:
    """Device ms per step of a latency probe: two chain lengths, timed with
    CUDA events, differenced (launch overhead cancels)."""
    stream = torch.cuda.current_stream(inp.device).cuda_stream
    times = []
    for n in PROBE_STEPS:
        def run():
            err = launch(inp.data_ptr(), n, out.data_ptr(), stream)
            if err != 0:
                fail(f"latency probe launch failed with CUDA error {err}")
        times.append(time_ms(run, 5))
        if not torch.equal(out, torch.full_like(out, want(n))):
            fail(f"latency probe gave {out.tolist()} after {n} steps")
    return (times[1] - times[0]) / (PROBE_STEPS[1] - PROBE_STEPS[0])


def ptxas_report(log: str):
    """``name: registers, spills`` for each kernel of an ``nvcc -Xptxas -v``
    log (the kernel named by its mangled symbol's readable middle)."""
    out, name, spill = [], None, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            for word in ("flash_wgmma_kernel", "flash_tf32_kernel", "ssd_mma_kernel",
                         "ssd_cumsum_kernel", "ssd_kernel", "pool_kernel", "bag_kernel", "gather_kernel",
                         "cache_scan_kernel", "stack_distance_kernel", "dram_scan_kernel",
                         "dram_scan_full_kernel", "dram_scan_regs_kernel", "dram_prepass_kernel",
                         "rrip_scan_walk_kernel", "rrip_scan_fixup_kernel"):
                if word in name:
                    name = word + name.split(word, 1)[1][:24]
                    break
        elif "spill stores" in ln:
            spill = ln.strip()
        elif "Used" in ln and name is not None:
            out.append(f"{name}: {ln.split('Used')[1].strip()} ({spill})")
            name = None
    return out


def max_abs_err(a, b) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max())


def bitwise_equal(a, b) -> bool:
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    if a.dtype == torch.bfloat16:
        return torch.equal(a.view(torch.int16), b.view(torch.int16))
    return torch.equal(a, b)


def d2_against_plain(name: str, policy: str, tags_h, valid_h, table, dev):
    """Run D2 on one row table of a call ``simulate`` makes and hold it
    bitwise against its plain versions on the rows gathered into a matrix:
    the serial one (timed), and on the chunked route the chunked one (hits
    and re-run count). Returns the tags and mask on the card, the kernel's hits,
    the largest difference, the plain version's ms and the kernel's re-run count."""
    from repro_torch.kernels.rrip_scan import PLAIN, rrip_scan_chunked_plain, rrip_scan_flat

    w = table.ways
    t_d, v_d = torch.from_numpy(tags_h).to(dev), torch.from_numpy(valid_h).to(dev)
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    h = rrip_scan_flat(t_d, v_d, table, policy, reruns=count)
    at = torch.from_numpy(table.off).to(dev)[:, None] + torch.arange(
        table.max_len, device=dev)[None, :]
    inr = at < torch.from_numpy(table.off + table.length).to(dev)[:, None]
    at = at.clamp(max=table.total - 1)
    t_m, v_m = t_d[at], v_d[at] & inr
    t1 = time.perf_counter()
    hp = PLAIN[policy](t_m, v_m, w)
    torch.cuda.synchronize()
    p_ms = (time.perf_counter() - t1) * 1e3
    if not torch.equal(h[at[inr]], hp[inr]):
        fail(f"{name} differs from its plain version on {table.rows} rows, {w} ways")
    reruns = int(count)
    if table.chunked:
        hc, rc = rrip_scan_chunked_plain(t_m, v_m, w, policy, lengths=table.length,
                                         chunk=table.chunk, warmup=table.warmup)
        if not torch.equal(h[at[inr]], hc[inr]) or rc != reruns:
            fail(f"{name} differs from its chunked plain version: re-runs {reruns}, "
                 f"plain {rc}")
    return t_d, v_d, h, max_abs_err(h[at[inr]], hp[inr]), p_ms, reruns


def hot_ids_of(sparse: np.ndarray, rows_per_table: int, n_hot: int) -> np.ndarray:
    """The ``n_hot`` most looked-up global row ids of a batch, sorted (the
    paper's Profiling policy, as examples/dlrm_serve.py profiles them)."""
    glob = (np.arange(sparse.shape[1])[None, :, None] * rows_per_table + sparse).reshape(-1)
    uniq, counts = np.unique(glob, return_counts=True)
    return np.sort(uniq[np.argsort(-counts)][:n_hot]).astype(np.int64)


def check_lm_kernels(dev, flush, f32_op_ms):
    """Phase 3 for K6, K7 and K8: each kernel against its plain version at
    the shapes and layouts the Zamba2-2.7B serving path gives it (random
    inputs: q, k and a transposed view for v; x a transposed view and B, C
    column slices of one projection; dt = softplus of a normal draw, A as
    the model's -linspace(1, 16)) and at edge shapes. Returns the report
    entries of the main-path shapes."""
    import torch.nn.functional as F
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.kernels.decode_attention import (
        CHUNK, _fns as k7_fns, decode_attention_kernel, decode_attention_plain,
        kernel_chunk as kernel_chunk7)
    from repro_torch.kernels.flash_attention import flash_attention_kernel, flash_attention_plain
    from repro_torch.kernels.mamba2_ssd import (
        blocks_per_sm, kernel_chunk, mamba2_ssd_kernel, mamba2_ssd_plain, mma_widths, p_slice)

    gen = torch.Generator(device=dev).manual_seed(2)
    smem7 = k7_fns()[1]

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def flash_inputs(B, Hq, Hkv, S, d, dtype, Sk=None, dv=None):
        Sk = S if Sk is None else Sk
        return (randn(B, Hq, S, d, dtype=dtype), randn(B, Hkv, Sk, d, dtype=dtype),
                randn(B, Sk, Hkv, dv or d, dtype=dtype).transpose(1, 2))

    def decode_inputs(B, Hq, Hkv, S_max, d, dtype):
        return (randn(B, Hq, d, dtype=dtype), randn(B, Hkv, S_max, d, dtype=dtype),
                randn(B, Hkv, S_max, d, dtype=dtype))

    def ssd_inputs(B, H, S, P, N, dtype, pad=0):
        xbc = randn(B, S, pad + H * P + 2 * N, dtype=dtype)[..., pad:]
        x = xbc[..., :H * P].reshape(B, S, H, P).transpose(1, 2)
        dt = F.softplus(randn(B, S, H)).transpose(1, 2)
        adt = -torch.linspace(1.0, 16.0, H, device=dev)[None, :, None] * dt
        return x, adt, dt, xbc[..., H * P:H * P + N], xbc[..., H * P + N:]

    def check(label, name, kernel, plain, library, args, dtype, reps=10):
        reset_launch_counts()
        got, want = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        if name == "flash_attention":
            # the dtype picks K6's route: bf16 wgmma, f32 3xTF32 mma.sync
            route = "wgmma" if dtype == torch.bfloat16 else "tf32"
            if flash_attention_kernel.routes != {"wgmma": 0, "tf32": 0, route: 1}:
                fail(f"{label}: routes {flash_attention_kernel.routes}, expected one {route}")
            label += f" [{route} route]"
        if name == "mamba2_ssd":
            # bf16 runs ssd_mma_kernel, f32 ssd_tf32_kernel (3xTF32)
            route = "mma" if dtype == torch.bfloat16 else "tf32"
            if mamba2_ssd_kernel.routes != {"mma": 0, "tf32": 0, route: 1}:
                fail(f"{label}: routes {mamba2_ssd_kernel.routes}, expected one {route}")
            label += f" [{route} route]"
        tol = LM_TOL[(name, dtype)]
        err = max_abs_err(got, want)
        if not torch.allclose(got.float(), want.float(), **tol):
            fail(f"{label} differs from its plain version (max abs err {err!r}, tolerance {tol})")
        lib_ms, backend = None, ""
        if library is not None:
            if not torch.allclose(library().reshape(want.shape).float(), want.float(), **tol):
                fail(f"{label}: the library call does not compute the kernel's function")
            lib_ms = time_cold_ms(library, reps, flush)
            backend = f" ({device_kernels(library)})"
        k_ms = time_cold_ms(lambda: kernel(*args), reps, flush)
        p_ms = time_cold_ms(lambda: plain(*args), 2, flush)
        print(f"[3] {label}: allclose {tol} to plain, max abs err {err!r}; kernel {k_ms!r} ms, "
              f"plain {p_ms!r} ms, library {lib_ms!r} ms{backend} (L2 flushed before each "
              f"launch)", flush=True)
        return err, k_ms, p_ms, lib_ms, backend

    def sdpa(q, k, v, causal):
        def call():
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)
        try:
            call()
        except RuntimeError as exc:     # no SDPA backend takes the shape
            print(f"[3] SDPA refuses q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                  f"{tuple(v.shape)}: {str(exc).splitlines()[0][:120]}", flush=True)
            return None
        return call

    def sdpa_decode(q, k, v, valid):
        return lambda: F.scaled_dot_product_attention(
            q[:, :, None], k[:, :, :valid], v[:, :, :valid], enable_gqa=True)

    def log2c(n):
        return max(1, math.ceil(math.log2(max(n, 2))))

    def rates(label, e, nbytes, mm_flops, lib_ms):
        """Achieved rates of a main-shape check beside its bounds."""
        ms = e[1]
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        mm_ms = mm_flops / TENSOR_FLOPS_PER_S * 1e3
        print(f"[3] {label}: {mm_flops / ms / 1e9!r} TFLOP/s of products (bound "
              f"{mm_ms!r} ms at {TENSOR_FLOPS_PER_S / 1e12:.0f}), {nbytes / ms / 1e9!r} TB/s "
              f"(bound {bytes_ms!r} ms at {HBM_BYTES_PER_S / 1e12:.2f}); kernel {ms!r} ms = "
              f"{ms / max(bytes_ms, mm_ms)!r} x its bound, {ms / lib_ms!r} x the library call",
              flush=True)

    entries = {}
    # K6, the prefill of the shared attention block: causal, GQA-free at Zamba2.
    # The bf16 rows go through the wgmma route, the f32 rows through 3xTF32;
    # the f32 main shape is timed as fully as the bf16 one. Every row is
    # timed beside SDPA in its dtype, and SDPA's kernels are named.
    for B, Hq, Hkv, S, d, causal, dtype, main in (
            (LM_BATCH, 32, 32, LM_PROMPT, 80, True, torch.bfloat16, True),
            (LM_BATCH, 32, 32, LM_PROMPT, 80, True, torch.float32, False),
            (2, 8, 2, 300, 64, True, torch.float32, False),
            (1, 4, 1, 200, 128, False, torch.float32, False),
            (2, 8, 2, 129, 80, False, torch.bfloat16, False),
            (2, 8, 2, 129, 80, True, torch.bfloat16, False),
            (1, 4, 1, 1000, 80, True, torch.bfloat16, False),
            (1, 3, 3, 200, 72, True, torch.bfloat16, False),
            (2, 4, 4, 256, 128, False, torch.bfloat16, False),
            (1, 2, 2, 77, 256, True, torch.bfloat16, False),
            (1, 3, 3, 1, 16, True, torch.bfloat16, False),
            (1, 2, 2, 1, 64, True, torch.float32, False)):
        q, k, v = flash_inputs(B, Hq, Hkv, S, d, dtype)
        full = main or S == LM_PROMPT
        e = check(f"flash_attention (B, Hq, Hkv, S, d)={(B, Hq, Hkv, S, d)} causal={causal} "
                  f"{dtype}{' (main path)' if main else ''}", "flash_attention",
                  lambda q, k, v: flash_attention_kernel(q, k, v, causal=causal),
                  lambda q, k, v: flash_attention_plain(q, k, v, causal=causal),
                  sdpa(q, k, v, causal), (q, k, v), dtype, reps=10 if full else 3)
        if full:
            pairs = S * (S + 1) // 2 if causal else S * S
            nbytes = (2 * B * Hq * S * d + 2 * B * Hkv * S * d) * q.element_size()
            rates(f"K6 {dtype} at the main shape, {'wgmma' if main else '3xTF32'} route",
                  e, nbytes, 4 * B * Hq * pairs * d, e[3])
        if full and not main:
            tf32_ms = 3 * 4 * B * Hq * pairs * d / TF32_FLOPS_PER_S * 1e3
            print(f"[3] K6 f32 at the main shape: {e[1] / tf32_ms!r} x its f32-accurate product "
                  f"bound {tf32_ms!r} ms (3 x {4 * B * Hq * pairs * d / 1e9!r} GFLOP at "
                  f"{TF32_FLOPS_PER_S / 1e12} TFLOP/s dense TF32), {e[1] / e[3]!r} x SDPA f32"
                  f"{e[4]}", flush=True)
            entries["flash_attention[f32 zamba2]"] = dict(
                kind="flash_attention", err=e[0], ms=e[1], plain_ms=e[2], library_ms=e[3],
                nbytes=nbytes, mm_flops=4 * B * Hq * pairs * d, ops=5 * B * Hq * pairs,
                lat_ms=(log2c(S) + log2c(d)) * f32_op_ms, shapes=[(B, Hq, Hkv, S, d), "f32"])
        if main:
            entries["flash_attention"] = dict(
                kind="flash_attention", err=e[0], ms=e[1], plain_ms=e[2], library_ms=e[3],
                nbytes=nbytes, mm_flops=4 * B * Hq * pairs * d, ops=5 * B * Hq * pairs,
                lat_ms=(log2c(S) + log2c(d)) * f32_op_ms, shapes=[(B, Hq, Hkv, S, d)])
    # A k whose s-stride (84 elements, 168 bytes) breaks TMA's 16-byte rule:
    # the wrapper copies it, and the tensor-core route runs.
    q, _, v = flash_inputs(2, 4, 4, 300, 80, torch.bfloat16)
    k = randn(2, 4, 300, 84, dtype=torch.bfloat16)[..., :80]
    check("flash_attention (B, Hq, Hkv, S, d)=(2, 4, 4, 300, 80) causal=True bf16, k s-stride "
          "168 bytes", "flash_attention",
          lambda q, k, v: flash_attention_kernel(q, k, v, causal=True),
          lambda q, k, v: flash_attention_plain(q, k, v, causal=True), None, (q, k, v),
          torch.bfloat16, reps=3)
    # K6 on the shapes of phase 11's paths: MLA's prefill (q, k 192 wide, v
    # 128 wide, padded by ops.flash_attention to 192 and sliced back: the
    # function the path calls, timed pad included, against the plain version
    # on the unpadded v), Whisper-base's encoder (S 1,500, not causal), its
    # prompt's cross-attention (64 queries over 1,500 keys) and causal self-
    # attention, the prompts of arctic (a group of 7), chameleon (a group of
    # 8) and granite (MQA, a group of 48); and edges: Sk one past a tile, one
    # query row, the groups of 7 and 48 at a small S.
    from repro_torch.kernels import ops as lm_ops
    for B, Hq, Hkv, S, Sk, d, dv, causal, dtype, entry in (
            (LM_BATCH, 16, 16, LM_PROMPT, LM_PROMPT, 192, 128, True, torch.bfloat16,
             "flash_attention[mla d192]"),
            (LM_BATCH, 8, 8, WHISPER_FRAMES, WHISPER_FRAMES, 64, 64, False, torch.bfloat16,
             "flash_attention[whisper encoder]"),
            (LM_BATCH, 8, 8, WHISPER_PROMPT, WHISPER_FRAMES, 64, 64, False, torch.bfloat16,
             "flash_attention[whisper cross]"),
            (LM_BATCH, 8, 8, WHISPER_PROMPT, WHISPER_PROMPT, 64, 64, True, torch.bfloat16,
             "flash_attention[whisper self]"),
            (LM_BATCH, 56, 8, LM_PROMPT, LM_PROMPT, 128, 128, True, torch.bfloat16,
             "flash_attention[arctic g7]"),
            (LM_BATCH, 64, 8, LM_PROMPT, LM_PROMPT, 128, 128, True, torch.bfloat16,
             "flash_attention[chameleon g8]"),
            (LM_BATCH, 48, 1, LM_PROMPT, LM_PROMPT, 128, 128, True, torch.bfloat16,
             "flash_attention[granite mqa g48]"),
            (2, 16, 16, 300, 300, 192, 128, True, torch.float32, None),
            (2, 16, 16, 300, 300, 192, 192, False, torch.bfloat16, None),
            (1, 4, 2, 100, 129, 64, 64, False, torch.bfloat16, None),
            (1, 4, 2, 100, 129, 64, 64, False, torch.float32, None),
            (2, 8, 8, 1, WHISPER_FRAMES, 64, 64, False, torch.bfloat16, None),
            (2, 8, 8, 1, WHISPER_FRAMES, 64, 64, False, torch.float32, None),
            (1, 4, 2, 130, 64, 80, 80, False, torch.bfloat16, None),
            (1, 56, 8, 256, 256, 128, 128, True, torch.bfloat16, None),
            (1, 48, 1, 256, 256, 128, 128, True, torch.bfloat16, None),
            (1, 48, 1, 100, 100, 128, 128, True, torch.float32, None)):
        q, k, v = flash_inputs(B, Hq, Hkv, S, d, dtype, Sk=Sk, dv=dv)
        e = check(f"flash_attention (B, Hq, Hkv, S, Sk, d, dv)={(B, Hq, Hkv, S, Sk, d, dv)} "
                  f"causal={causal} {dtype}{f' ({entry})' if entry else ''}", "flash_attention",
                  lambda q, k, v: lm_ops.flash_attention(q, k, v, causal=causal),
                  lambda q, k, v: flash_attention_plain(q, k, v, causal=causal),
                  sdpa(q, k, v, causal), (q, k, v), dtype, reps=10 if entry else 3)
        if entry:
            pairs = S * (S + 1) // 2 if causal else S * Sk
            nbytes = (B * Hq * S * (d + dv) + B * Hkv * Sk * (d + dv)) * q.element_size()
            rates(f"K6 {dtype} at phase 11's {entry}", e, nbytes,
                  2 * B * Hq * pairs * (d + dv), e[3] or math.nan)
            entries[entry] = dict(
                kind="flash_attention", err=e[0], ms=e[1], plain_ms=e[2], library_ms=e[3],
                nbytes=nbytes, mm_flops=2 * B * Hq * pairs * (d + dv), ops=5 * B * Hq * pairs,
                lat_ms=(log2c(Sk) + log2c(d)) * f32_op_ms,
                shapes=[(B, Hq, Hkv, S, Sk, d, dv), causal])
            if e[3] is None:
                entries[entry]["library_none"] = "no SDPA backend takes dv != dq at this shape"
    # K7, every decode step of the shared block; the main path's largest
    # valid length is the last step's, prompt + new tokens. The kernel splits
    # the cache into chunks of CHUNK positions: valid_len at a chunk's end,
    # one past it and 1 are its edges.
    print(f"[3] decode_attention: chunks of {CHUNK} positions, "
          f"{-(-LM_MAX_SEQ // CHUNK)} per (b, kv head) at S_max {LM_MAX_SEQ}", flush=True)
    for B, Hq, Hkv, S_max, d, valid, dtype, main in (
            (LM_BATCH, 32, 32, LM_MAX_SEQ, 80, LM_PROMPT + LM_NEW, torch.bfloat16, True),
            (LM_BATCH, 32, 32, LM_MAX_SEQ, 80, LM_PROMPT + LM_NEW, torch.float32, False),
            (2, 32, 32, LM_MAX_SEQ, 80, CHUNK, torch.bfloat16, False),
            (2, 32, 32, LM_MAX_SEQ, 80, CHUNK + 1, torch.float32, False),
            (2, 32, 32, LM_MAX_SEQ, 80, 1, torch.bfloat16, False),
            (2, 8, 2, 300, 64, 1, torch.float32, False),
            (2, 8, 2, 300, 64, 100, torch.bfloat16, False),
            (2, 4, 1, 1000, 128, 1000, torch.float32, False),
            (1, 32, 4, 77, 80, 77, torch.bfloat16, False),
            (1, 16, 1, 64, 256, 64, torch.float32, False)):
        q, k, v = decode_inputs(B, Hq, Hkv, S_max, d, dtype)
        e = check(f"decode_attention (B, Hq, Hkv, S_max, d)={(B, Hq, Hkv, S_max, d)} "
                  f"valid_len={valid} {dtype}{' (main path)' if main else ''}", "decode_attention",
                  lambda q, k, v: decode_attention_kernel(q, k, v, valid),
                  lambda q, k, v: decode_attention_plain(q, k, v, valid),
                  sdpa_decode(q, k, v, valid), (q, k, v), dtype, reps=20 if main else 3)
        if main:
            # K7 is bitwise stable across calls (no float atomics) and never
            # reads the cache past valid_len.
            first = decode_attention_kernel(q, k, v, valid)
            k[:, :, valid:] = float("nan")
            v[:, :, valid:] = float("nan")
            if not torch.equal(decode_attention_kernel(q, k, v, valid), first):
                fail("decode_attention: two calls differ, or the cache past valid_len was read")
            nbytes = (2 * B * Hq * d + 2 * B * Hkv * valid * d) * q.element_size()
            rates("K7 bf16 at the main shape (bitwise equal across calls, NaN past valid_len "
                  "unread)", e, nbytes, 4 * B * Hq * valid * d, e[3])
            entries["decode_attention"] = dict(
                kind="decode_attention", err=e[0], ms=e[1], plain_ms=e[2], library_ms=e[3],
                nbytes=nbytes,
                mm_flops=4 * B * Hq * valid * d, ops=5 * B * Hq * valid,
                lat_ms=(log2c(valid) + log2c(d)) * f32_op_ms,
                shapes=[(B, Hq, d), (B, Hkv, S_max, d), valid])
    # K7 on phase 11's decode shapes: Whisper-base's cross-attention of one
    # token (all 1,500 encoder positions valid) and its self-attention,
    # granite's MQA (48 query heads of 128 on one kv head: the chunk
    # kernel_chunk finds), arctic's group of 7 and chameleon's of 8, at the
    # last step's valid length in the cache phase 11 serves with.
    for B, Hq, Hkv, S_max, d, valid, dtype, entry in (
            (LM_BATCH, 8, 8, WHISPER_FRAMES, 64, WHISPER_FRAMES, torch.bfloat16,
             "decode_attention[whisper cross]"),
            (LM_BATCH, 48, 1, LM_MAX_SEQ, 128, LM_PROMPT + LM_NEW, torch.bfloat16,
             "decode_attention[granite mqa g48]"),
            (LM_BATCH, 56, 8, LM_MAX_SEQ, 128, LM_PROMPT + LM_NEW, torch.bfloat16,
             "decode_attention[arctic g7]"),
            (LM_BATCH, 64, 8, LM_MAX_SEQ, 128, LM_PROMPT + LM_NEW, torch.bfloat16,
             "decode_attention[chameleon g8]"),
            (LM_BATCH, 8, 8, WHISPER_PROMPT + LM_NEW + 8, 64, WHISPER_PROMPT + LM_NEW,
             torch.bfloat16, "decode_attention[whisper self]"),
            (2, 48, 1, 300, 128, 257, torch.float32, None),
            (2, 56, 8, 300, 128, 1, torch.float32, None),
            (2, 8, 8, WHISPER_FRAMES, 64, WHISPER_FRAMES, torch.float32, None)):
        q, k, v = decode_inputs(B, Hq, Hkv, S_max, d, dtype)
        chunk = kernel_chunk7(Hq // Hkv, d, dtype, smem7)
        e = check(f"decode_attention (B, Hq, Hkv, S_max, d)={(B, Hq, Hkv, S_max, d)} "
                  f"valid_len={valid} {dtype}, chunk {chunk}{f' ({entry})' if entry else ''}",
                  "decode_attention",
                  lambda q, k, v: decode_attention_kernel(q, k, v, valid),
                  lambda q, k, v: decode_attention_plain(q, k, v, valid),
                  sdpa_decode(q, k, v, valid), (q, k, v), dtype, reps=20 if entry else 3)
        if entry:
            nbytes = (2 * B * Hq * d + 2 * B * Hkv * valid * d) * q.element_size()
            rates(f"K7 bf16 at phase 11's {entry}", e, nbytes, 4 * B * Hq * valid * d, e[3])
            entries[entry] = dict(
                kind="decode_attention", err=e[0], ms=e[1], plain_ms=e[2], library_ms=e[3],
                nbytes=nbytes, mm_flops=4 * B * Hq * valid * d, ops=5 * B * Hq * valid,
                lat_ms=(log2c(valid) + log2c(d)) * f32_op_ms,
                shapes=[(B, Hq, d), (B, Hkv, S_max, d), valid, chunk])
    # K8, the prompt pass of every Mamba2 layer (80 heads of 64, N = 64). The
    # bf16 rows run ssd_mma_kernel (P-slices, hi/lo bf16 split products), the
    # f32 rows ssd_tf32_kernel (3xTF32); a view shifted by ``pad`` columns
    # puts rows off 16 bytes, which both routes copy. The f32 main shape is
    # timed as fully as the bf16 one.
    for B, H, S, P, N, chunk, dtype, main, pad in (
            (LM_BATCH, 80, LM_PROMPT, 64, 64, 128, torch.bfloat16, True, 0),
            (LM_BATCH, 80, LM_PROMPT, 64, 64, 128, torch.float32, False, 0),
            (2, 4, 300, 32, 128, 128, torch.float32, False, 0),
            (2, 4, 300, 32, 128, 128, torch.bfloat16, False, 0),
            (1, 3, 100, 16, 16, 16, torch.float32, False, 0),
            (1, 3, 100, 16, 16, 16, torch.bfloat16, False, 0),
            (2, 8, 200, 64, 64, 64, torch.bfloat16, False, 0),
            (2, 8, 200, 64, 64, 64, torch.bfloat16, False, 4),
            (2, 8, 200, 64, 64, 64, torch.float32, False, 1),
            (1, 2, 130, 64, 64, 128, torch.float32, False, 0),
            (1, 2, 130, 64, 64, 128, torch.bfloat16, False, 0),
            (1, 2, 5, 64, 64, 128, torch.float32, False, 0),
            (1, 2, 5, 64, 64, 128, torch.bfloat16, False, 0)):
        args = ssd_inputs(B, H, S, P, N, dtype, pad)
        Q = kernel_chunk(chunk, S, P, N, dtype)
        full = main or S == LM_PROMPT
        e = check(f"mamba2_ssd (B, H, S, P, N)={(B, H, S, P, N)} chunk={chunk} (kernel's {Q}) "
                  f"{dtype}{f', rows {args[0].element_size() * pad} bytes off 16' if pad else ''}"
                  f"{' (main path)' if main else ''}", "mamba2_ssd",
                  lambda *a: mamba2_ssd_kernel(*a, chunk=chunk),
                  lambda *a: mamba2_ssd_plain(*a, chunk), None, args, dtype,
                  reps=10 if full else 3)
        if full:
            nbytes = ((2 * B * H * S * P + 2 * B * S * N) * args[0].element_size()
                      + 2 * B * H * S * 4)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            lens = [min(Q, S - c0) for c0 in range(0, S, Q)]
            tri = sum(q * (q + 1) // 2 for q in lens)
            # C.B^T once per batch row (it does not depend on the head); per
            # head: the decayed scores times x, C.state and the update
            mm_flops = 2 * B * N * tri + 2 * B * H * (P * tri + 2 * S * N * P)
            ps = p_slice(mma_widths(P, N)[0])
            label = "bf16" if main else "f32"
            print(f"[3] K8 {label} at the main shape: {nbytes / e[1] / 1e9!r} TB/s (byte bound "
                  f"{bytes_ms!r} ms at {HBM_BYTES_PER_S / 1e12:.2f}), kernel {e[1]!r} ms = "
                  f"{e[1] / bytes_ms!r} x the bound; chunk {Q}, P-slice {ps} "
                  f"({B * H * P // ps} blocks), {blocks_per_sm(Q, P, N, dtype)} resident blocks "
                  f"per SM", flush=True)
            entry = dict(
                kind="mamba2_ssd", err=e[0], ms=e[1], plain_ms=e[2], library_ms=None,
                library_none="no one PyTorch call computes a chunked SSD scan",
                nbytes=nbytes, mm_flops=mm_flops,
                ops=3 * B * H * tri + 6 * B * H * S,
                lat_ms=len(lens) * (log2c(Q) + 3) * f32_op_ms,
                shapes=[(B, H, S, P), (B, S, N), chunk])
            if main:
                entries["mamba2_ssd"] = entry
            else:
                tf32_ms = 3 * mm_flops / TF32_FLOPS_PER_S * 1e3
                print(f"[3] K8 f32 at the main shape: {e[1] / tf32_ms!r} x its f32-accurate "
                      f"product bound {tf32_ms!r} ms (3 x {mm_flops / 1e9!r} GFLOP at "
                      f"{TF32_FLOPS_PER_S / 1e12} TFLOP/s dense TF32); {bytes_ms / e[1]!r} of "
                      f"the byte bound, {tf32_ms / e[1]!r} of the product bound", flush=True)
                entries["mamba2_ssd[f32 zamba2]"] = dict(entry, shapes=entry["shapes"] + ["f32"])
    return entries


def teacher_forced(engine_a, engine_b, prompts, forced, dev_a, dev_b, kv_a=None, kv_b=None):
    """Prefill and each decode step of two engines on the same prompts, fed
    the same tokens (the audio family also the cross k, v of its encoder's
    output, ``whisper.cross_kv``, on each side); returns their logits as
    (a, b) pairs on the CPU."""
    from repro_torch.serving import init_cache

    with torch.inference_mode():
        args_a = () if kv_a is None else (kv_a,)
        args_b = () if kv_b is None else (kv_b,)
        ca = init_cache(engine_a.cfg, engine_a.scfg, device=dev_a)
        cb = init_cache(engine_b.cfg, engine_b.scfg, device=dev_b)
        la, ca = engine_a.prefill(engine_a.params, torch.from_numpy(prompts).to(dev_a), ca,
                                  *args_a)
        lb, cb = engine_b.prefill(engine_b.params, torch.from_numpy(prompts).to(dev_b), cb,
                                  *args_b)
        pairs = [(la.cpu(), lb.cpu())]
        for i in range(forced.shape[1]):
            tok = torch.from_numpy(forced[:, i:i + 1])
            la, ca = engine_a.step(engine_a.params, tok.to(dev_a), prompts.shape[1] + i, ca,
                                   *args_a)
            lb, cb = engine_b.step(engine_b.params, tok.to(dev_b), prompts.shape[1] + i, cb,
                                   *args_b)
            pairs.append((la.cpu(), lb.cpu()))
    return pairs


def serve_zamba2(dev, K):
    """Phase 7: Zamba2-2.7B served at full width. Returns (the launch counts
    of the main run, K4's report entry at the prompt's shapes, the launch
    counts of the f32 teacher-forced check)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import LMDataConfig, lm_batch
    from repro_torch.kernels.embedding_bag import embedding_gather_kernel, embedding_gather_plain
    from repro_torch.models import get_config, get_smoke_config, hybrid, param_count
    from repro_torch.serving import ServeConfig, ServingEngine, init_cache

    cfg = get_config("zamba2_2p7b")
    scfg = ServeConfig(batch=LM_BATCH, max_seq=LM_MAX_SEQ)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)     # > the 50 MB L2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = hybrid.init_lm(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    if n_params != param_count(cfg):
        fail(f"Zamba2: {n_params} parameters, param_count says {param_count(cfg)}")
    print(f"[7] Zamba2-2.7B at full width: {cfg.n_layers} Mamba2 layers, d_model {cfg.d_model}, "
          f"shared block x {cfg.n_layers // cfg.hybrid.attn_every}, {n_params} parameters, "
          f"{weight_bytes} B of {cfg.dtype} weights drawn on the card in {init_s:.3f} s", flush=True)
    prompts = lm_batch(LMDataConfig(vocab=cfg.vocab, seq_len=LM_PROMPT, global_batch=LM_BATCH),
                       0)["tokens"]
    engine = ServingEngine(cfg, params, scfg)
    t0 = time.perf_counter()
    engine.generate(prompts, max_new_tokens=2)                 # warm-up
    print(f"[7] warm-up generate (2 tokens) {time.perf_counter() - t0:.3f} s", flush=True)

    # The main path, once, through the entry point a user calls.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = engine.generate(prompts, max_new_tokens=LM_NEW)
    gen_s = time.perf_counter() - t0
    main_counts = K.launch_counts()
    groups = cfg.n_layers // cfg.hybrid.attn_every
    expect = {"mamba2_ssd": cfg.n_layers, "flash_attention": groups,
              "decode_attention": LM_NEW * groups, "embedding_gather": 1 + LM_NEW}
    if main_counts != {k: expect.get(k, 0) for k in main_counts}:
        fail(f"Zamba2 generate: launches {main_counts}; expected {expect} and no other kernel")
    if K.flash_attention_kernel.routes != {"wgmma": groups, "tf32": 0}:
        fail(f"Zamba2 generate: K6 routes {K.flash_attention_kernel.routes}; expected every "
             "launch on the bf16 (wgmma) route")
    if K.mamba2_ssd_kernel.routes != {"mma": cfg.n_layers, "tf32": 0}:
        fail(f"Zamba2 generate: K8 routes {K.mamba2_ssd_kernel.routes}; expected every "
             "launch on the tensor-core route")
    if out.shape != (LM_BATCH, LM_NEW) or out.min() < 0 or out.max() >= cfg.vocab:
        fail(f"Zamba2 generate: tokens of shape {out.shape} in [{out.min()}, {out.max()}]")
    print(f"[7] generate: {LM_BATCH} x {LM_PROMPT} prompt tokens, {LM_NEW} new each, in "
          f"{gen_s!r} s ({LM_BATCH * LM_NEW / gen_s!r} generated tokens/s end to end); launches "
          f"{ {k: n for k, n in main_counts.items() if n} }, K8 routes "
          f"{K.mamba2_ssd_kernel.routes}, K6 routes "
          f"{K.flash_attention_kernel.routes}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} B; first tokens {out[0, :8].tolist()}", flush=True)

    # Prefill and each decode step apart, with their launch counts.
    per_prefill = {"mamba2_ssd": cfg.n_layers, "flash_attention": groups, "embedding_gather": 1}
    per_step = {"decode_attention": groups, "embedding_gather": 1}
    tokens = torch.from_numpy(prompts).to(dev)

    def timed(fn, want, label):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = K.launch_counts()
        if counts != {k: want.get(k, 0) for k in counts}:
            fail(f"Zamba2 {label}: launches {counts}; expected {want} and no other kernel")
        logits = res[0]
        if not bool(torch.isfinite(logits).all()) or logits.shape[-1] != cfg.vocab:
            fail(f"Zamba2 {label}: logits {tuple(logits.shape)} not finite")
        return res, ms

    with torch.inference_mode():
        caches = init_cache(cfg, scfg, device=dev)
        (full_logits, caches), prefill_ms = timed(
            lambda: engine.prefill(params, tokens, caches), per_prefill, "prefill")
        tok = full_logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
        steps, step_ms = [tok], []
        for i in range(LM_NEW):
            (logits, caches), ms = timed(
                lambda: engine.step(params, tok, LM_PROMPT + i, caches), per_step, f"step {i}")
            step_ms.append(ms)
            tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
            steps.append(tok)
        same = np.array_equal(torch.cat(steps[:-1], dim=1).cpu().numpy(), out)
        print(f"[7] prefill {prefill_ms!r} ms ({LM_BATCH * LM_PROMPT / prefill_ms * 1e3!r} prompt "
              f"tokens/s); decode per step (batch {LM_BATCH}) min {min(step_ms)!r} ms, median "
              f"{float(np.median(step_ms))!r} ms, max {max(step_ms)!r} ms "
              f"({LM_BATCH * 1e3 / float(np.median(step_ms))!r} tokens/s at the median); "
              f"launches per prefill {per_prefill}, per step {per_step}, exact; tokens equal to "
              f"generate's: {same}", flush=True)

        # The step at position 1023 after a 1023-token prefill against the
        # 1024-token prefill's last logits.
        caches2 = init_cache(cfg, scfg, device=dev)
        _, caches2 = engine.prefill(params, tokens[:, :-1], caches2)
        last, _ = engine.step(params, tokens[:, -1:], LM_PROMPT - 1, caches2)
        tf_err = max_abs_err(last[:, -1], full_logits[:, -1])
        agree = float((last[:, -1].argmax(-1) == full_logits[:, -1].argmax(-1)).float().mean())
        print(f"[7] teacher-forced: decode step at position {LM_PROMPT - 1} vs the "
              f"{LM_PROMPT}-token prefill's last logits: max abs err {tf_err!r} (logits up to "
              f"{float(full_logits.float().abs().max())!r}), argmax agrees on {agree!r} of rows",
              flush=True)
        del caches2

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tprof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.step(params, tok, LM_PROMPT + LM_NEW, caches)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        print(f"[7] profiled decode step: wall {wall!r} s, {device_busy(tprof.events(), wall)}",
              flush=True)
        caches3 = init_cache(cfg, scfg, device=dev)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tprof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.prefill(params, tokens, caches3)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        print(f"[7] profiled prefill: wall {wall!r} s, "
              f"{device_busy(tprof.events(), wall, ('ssd_mma_kernel', 'ssd_cumsum_kernel'))}",
              flush=True)
        del caches3

        # K4 on the prompt's token ids (B x S rows of the 32000 x 2560 table).
        table = params["embed"]["table"]
        ids = tokens.reshape(-1).contiguous()
        got, want = embedding_gather_kernel(table, ids), embedding_gather_plain(table, ids)
        torch.cuda.synchronize()
        if not bitwise_equal(got, want):
            fail("embedding_gather differs from its plain version on the Zamba2 prompt")
        k_ms = time_cold_ms(lambda: embedding_gather_kernel(table, ids), 20, flush)
        p_ms = time_cold_ms(lambda: embedding_gather_plain(table, ids), 3, flush)
        l_ms = time_cold_ms(lambda: torch.index_select(table, 0, ids.long()), 20, flush)
        distinct = int(torch.unique(ids).numel())
        print(f"[7] embedding_gather (N, D)={(ids.numel(), cfg.d_model)} bf16 (the prompt's "
              f"{distinct} distinct tokens): bitwise equal to plain; kernel {k_ms!r} ms, plain "
              f"{p_ms!r} ms, library {l_ms!r} ms", flush=True)
        k4 = dict(kind="embedding_gather", err=0.0, ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                  nbytes=(distinct + ids.numel()) * cfg.d_model * table.element_size()
                  + ids.numel() * 4, ops=0, lat_ms=0.0, shapes=[(ids.numel(), cfg.d_model)],
                  launches=main_counts["embedding_gather"])
    print(f"[7] max_memory_allocated over serving {torch.cuda.max_memory_allocated()} B "
          f"(weights {weight_bytes} B)", flush=True)
    del params, engine, caches, table, flush
    torch.cuda.empty_cache()

    # The teacher-forced check again at full width in f32 (9.7 GB of
    # weights, drawn from the same seed), where bf16's rounding does not
    # hide a wrong layout. The reference's 2e-4 / 2e-3 is sized for its
    # 4-layer smoke model: at this depth and width the two routes' f32
    # rounding alone parts by more (the plain torch route on the CPU too),
    # and an H100 read 3.9e-4 over 8 rows in a first run. So it is held at
    # atol 1e-3 / rtol 2e-3; a wrong layout moves logits by tenths.
    cfg32 = cfg.replace(dtype="float32")
    params32 = hybrid.init_lm(cfg32, device=dev,
                              generator=torch.Generator(device=dev).manual_seed(0))
    engine32 = ServingEngine(cfg32, params32, scfg)
    with torch.inference_mode():
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t32 = time.perf_counter()
        full32, _ = engine32.prefill(params32, tokens, init_cache(cfg32, scfg, device=dev))
        _, c32 = engine32.prefill(params32, tokens[:, :-1], init_cache(cfg32, scfg, device=dev))
        last32, _ = engine32.step(params32, tokens[:, -1:], LM_PROMPT - 1, c32)
        torch.cuda.synchronize()
        t32 = time.perf_counter() - t32
        counts32 = K.launch_counts()
        want32 = {k: 2 * per_prefill.get(k, 0) + per_step.get(k, 0) for k in counts32}
        if counts32 != want32:
            fail(f"Zamba2 f32 teacher-forced: launches {counts32}; expected {want32}")
        routes32 = (dict(K.mamba2_ssd_kernel.routes), dict(K.flash_attention_kernel.routes))
        if routes32 != ({"mma": 0, "tf32": 2 * cfg.n_layers}, {"wgmma": 0, "tf32": 2 * groups}):
            fail(f"Zamba2 f32 teacher-forced: K8 routes {routes32[0]}, K6 routes {routes32[1]}; "
                 "expected every launch on the f32 (tf32) routes")
        a32, b32 = last32[:, -1], full32[:, -1]
        err32 = max_abs_err(a32, b32)
        if a32.dtype != torch.float32 or not torch.allclose(a32, b32, atol=1e-3, rtol=2e-3):
            fail(f"Zamba2 f32 teacher-forced: decode step at position {LM_PROMPT - 1} differs "
                 f"from the {LM_PROMPT}-token prefill by {err32!r} (allclose 1e-3 / 2e-3)")
        agree32 = float((a32.argmax(-1) == b32.argmax(-1)).float().mean())
    print(f"[7] teacher-forced, f32 at full width: decode step at position {LM_PROMPT - 1} vs "
          f"the {LM_PROMPT}-token prefill's last logits: max abs err {err32!r} (logits up to "
          f"{float(b32.abs().max())!r}; allclose 1e-3 / 2e-3), argmax agrees on {agree32!r} of "
          f"rows; two prefills and the step {t32!r} s (host clock), launches "
          f"{ {k: n for k, n in counts32.items() if n} }, K8 routes {routes32[0]}, K6 routes "
          f"{routes32[1]}", flush=True)
    del params32, engine32, c32, full32, last32, a32, b32
    torch.cuda.empty_cache()

    # A smoke-size Zamba2 on the card against the same model on the CPU,
    # held in f32 at the reference's 2e-4 / 2e-3 and in bf16 at its 8e-2
    # (tests/test_serving.py).
    for dtype in ("float32", "bfloat16"):
        scfg_s = get_smoke_config("zamba2_2p7b").replace(dtype=dtype)
        serve_s = ServeConfig(batch=2, max_seq=80)
        cpu_params = hybrid.init_lm(scfg_s, device="cpu")
        card_params = hybrid.init_lm(scfg_s, device=dev)
        card_params.load_state_dict(cpu_params.state_dict())
        p_s = lm_batch(LMDataConfig(vocab=scfg_s.vocab, seq_len=64, global_batch=2), 0)["tokens"]
        cpu_engine = ServingEngine(scfg_s, cpu_params, serve_s)
        forced = cpu_engine.generate(p_s, max_new_tokens=6)
        K.reset_launch_counts()
        pairs = teacher_forced(ServingEngine(scfg_s, card_params, serve_s), cpu_engine, p_s,
                               forced, dev, "cpu")
        if not all(K.launch_counts()[k] for k in ("mamba2_ssd", "flash_attention",
                                                  "decode_attention")):
            fail(f"smoke Zamba2 on the card did not launch every LM kernel: {K.launch_counts()}")
        worst = max(max_abs_err(a, b) for a, b in pairs)
        tol = dict(atol=2e-4, rtol=2e-3) if dtype == "float32" else dict(atol=8e-2, rtol=0.0)
        if not all(torch.allclose(a.float(), b.float(), **tol) for a, b in pairs):
            fail(f"smoke Zamba2 {dtype} on the card differs from the CPU by {worst!r} ({tol})")
        print(f"[7] smoke Zamba2 {dtype} on the card vs the CPU, teacher-forced (prefill of 64 + "
              f"6 steps): max abs diff {worst!r} (allclose {tol})", flush=True)
    return main_counts, k4, counts32


def serve_model(K, label, cfg, params, prompts, new, per_prefill, per_step, enc_out=None,
                profile_step=False):
    """One model's serving on the card: a warm-up ``generate``; the main
    run (``generate`` through the engine, launch counts reset just before
    and read just after, held to ``per_prefill`` + ``new`` x ``per_step``,
    every K6 launch on the tensor-core route); a second ``generate`` whose
    greedy tokens must equal the first's; then the prefill and each step
    apart, timed, each held to its counts. Returns (the main run's counts,
    the prefill's ms, the steps' ms)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import whisper
    from repro_torch.serving import ServeConfig, ServingEngine, init_cache

    B, Sp = prompts.shape
    scfg = ServeConfig(batch=B, max_seq=Sp + new + 8)
    engine = ServingEngine(cfg, params, scfg)
    kw = {} if enc_out is None else {"enc_out": enc_out}
    t0 = time.perf_counter()
    engine.generate(prompts, max_new_tokens=2, **kw)               # warm-up
    warm_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = engine.generate(prompts, max_new_tokens=new, **kw)
    gen_s = time.perf_counter() - t0
    main = K.launch_counts()
    want = {k: per_prefill.get(k, 0) + new * per_step.get(k, 0) for k in main}
    if main != want:
        fail(f"{label} generate: launches {main}; expected {want}")
    if K.flash_attention_kernel.routes["tf32"] != 0:
        fail(f"{label} generate: K6 routes {K.flash_attention_kernel.routes}; expected every "
             "launch on the bf16 (wgmma) route")
    if out.shape != (B, new) or out.min() < 0 or out.max() >= cfg.vocab:
        fail(f"{label} generate: tokens of shape {out.shape} in [{out.min()}, {out.max()}]")
    again = engine.generate(prompts, max_new_tokens=new, **kw)
    if not np.array_equal(out, again):
        fail(f"{label}: two generate calls gave different greedy tokens")
    print(f"[11] {label} generate: {B} x {Sp} prompt tokens, {new} new each, in {gen_s!r} s "
          f"({B * new / gen_s!r} generated tokens/s end to end; warm-up of 2 tokens "
          f"{warm_s:.3f} s); launches { {k: n for k, n in main.items() if n} }, K6 routes "
          f"{K.flash_attention_kernel.routes}; a second generate gave the same tokens; first "
          f"tokens {out[0, :8].tolist()}", flush=True)

    def timed(fn, want, what):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = K.launch_counts()
        if counts != {k: want.get(k, 0) for k in counts}:
            fail(f"{label} {what}: launches {counts}; expected {want} and no other kernel")
        if not bool(torch.isfinite(res[0]).all()) or res[0].shape[-1] != cfg.vocab:
            fail(f"{label} {what}: logits {tuple(res[0].shape)} not finite")
        return res, ms

    with torch.inference_mode():
        args = () if enc_out is None else (whisper.cross_kv(params, enc_out, cfg),)
        caches = init_cache(cfg, scfg, device=engine.device)
        tokens = torch.from_numpy(prompts).to(engine.device)
        (logits, caches), prefill_ms = timed(
            lambda: engine.prefill(params, tokens, caches, *args), per_prefill, "prefill")
        tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
        steps, step_ms = [tok], []
        for i in range(new):
            (logits, caches), ms = timed(
                lambda: engine.step(params, tok, Sp + i, caches, *args), per_step,
                f"step {i}")
            step_ms.append(ms)
            tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
            steps.append(tok)
        same = np.array_equal(torch.cat(steps[:-1], dim=1).cpu().numpy(), out)
        if not same:
            fail(f"{label}: the prefill and steps apart gave other tokens than generate")
        med = float(np.median(step_ms))
        print(f"[11] {label} prefill {prefill_ms!r} ms ({B * Sp / prefill_ms * 1e3!r} prompt "
              f"tokens/s); decode per step (batch {B}) min {min(step_ms)!r} ms, median {med!r} "
              f"ms, max {max(step_ms)!r} ms ({B * 1e3 / med!r} tokens/s at the median); "
              f"launches per prefill {per_prefill}, per step {per_step}, exact; tokens equal to "
              f"generate's", flush=True)
        if profile_step:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tprof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                engine.step(params, tok, Sp + new, caches, *args)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            print(f"[11] {label} profiled decode step: wall {wall!r} s, "
                  f"{device_busy(tprof.events(), wall, top=12)}", flush=True)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tprof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                engine.prefill(params, tokens, init_cache(cfg, scfg, device=tokens.device),
                               *args)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            print(f"[11] {label} profiled prefill: wall {wall!r} s, "
                  f"{device_busy(tprof.events(), wall, ('flash_wgmma_kernel',), top=12)}",
                  flush=True)
    return main, prefill_ms, step_ms


def serve_phase(dev, K):
    """Phase 11: the MoE, MLA, GELU, vlm and audio architectures on the card.
    DeepSeek-V2-Lite-16B (MLA + MoE) at full width and depth and
    Whisper-base at full width are served; arctic, chameleon and granite at
    full width with the depth of ``CUT_DEPTH``; then the six smoke models on
    the card against the CPU. Returns the launch counts of each main run."""
    from repro_torch.data import LMDataConfig, lm_batch
    from repro_torch.models import family_module, get_config, get_smoke_config, param_count
    from repro_torch.models import whisper
    from repro_torch.serving import ServeConfig, ServingEngine, init_cache

    runs = {}

    def load(cfg, label):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mod = family_module(cfg)
        init = mod.init_model if cfg.family == "audio" else mod.init_lm
        t0 = time.perf_counter()
        params = init(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n = sum(p.numel() for p in params.parameters())
        nbytes = sum(p.numel() * p.element_size() for p in params.parameters())
        # param_count is the reference's analytic count, which leaves out the
        # GELU MLPs' biases (and whisper's layer norms' shifts)
        if cfg.family != "audio" and cfg.mlp_type == "swiglu" and n != param_count(cfg):
            fail(f"{label}: {n} parameters, param_count says {param_count(cfg)}")
        print(f"[11] {label}: {cfg.n_layers} layers, d_model {cfg.d_model}, {n} parameters, "
              f"{nbytes} B of {cfg.dtype} weights drawn on the card in {init_s:.3f} s "
              f"(max_memory_allocated {torch.cuda.max_memory_allocated()} B)", flush=True)
        return params, nbytes

    def prompts_of(cfg, S):
        return lm_batch(LMDataConfig(vocab=cfg.vocab, seq_len=S, global_batch=LM_BATCH),
                        0)["tokens"]

    # DeepSeek-V2-Lite-16B, full width and depth: MLA prefill through K6
    # (v padded to 192), the absorbed decode and the MoE in plain torch.
    cfg = get_config("deepseek_v2_lite_16b")
    params, wbytes = load(cfg, "DeepSeek-V2-Lite-16B")
    L = cfg.n_layers
    m, moe = cfg.mla, cfg.moe
    T = LM_BATCH * LM_PROMPT

    def groups_capacity(tokens):
        """The reference's dispatch groups G and capacity C for ``tokens``."""
        G = moe.dispatch_groups if tokens % moe.dispatch_groups == 0 else 1
        return G, max(1, int(tokens // G * moe.top_k * moe.capacity_factor) // moe.num_experts)

    print(f"[11] DeepSeek MoE dispatch (groups G, capacity C per expert and group): prefill "
          f"{groups_capacity(T)}, decode {groups_capacity(LM_BATCH)} for "
          f"{LM_BATCH * moe.top_k} assignments a step over {moe.num_experts} experts (the "
          "reference's drops)", flush=True)
    main, pre_ms, step_ms = serve_model(
        K, "DeepSeek-V2-Lite-16B", cfg, params, prompts_of(cfg, LM_PROMPT), LM_NEW,
        {"flash_attention": L, "embedding_gather": 1}, {"embedding_gather": 1},
        profile_step=True)
    runs["deepseek"] = main
    table = params["embed"]["table"]
    cache_bytes = L * LM_BATCH * (LM_PROMPT + LM_NEW) * (m.kv_lora_rank + m.qk_rope_head_dim) * 2
    step_bytes = wbytes - table.numel() * table.element_size() + cache_bytes
    step_bound = step_bytes / HBM_BYTES_PER_S * 1e3
    active = cfg.active_param_count() - table.numel()
    pre_bound = max(wbytes / HBM_BYTES_PER_S, 2 * active * T / TENSOR_FLOPS_PER_S) * 1e3
    print(f"[11] DeepSeek device bounds: a decode step reads every expert's weights and the "
          f"latent cache, {step_bytes} B / {HBM_BYTES_PER_S / 1e12:.2f} TB/s = {step_bound!r} ms "
          f"(median step {float(np.median(step_ms))!r} ms = "
          f"{float(np.median(step_ms)) / step_bound!r} x); prefill max(weights / HBM, "
          f"2 x {active} active parameters x {T} tokens / {TENSOR_FLOPS_PER_S / 1e12:.0f} "
          f"TFLOP/s) = {pre_bound!r} ms (prefill {pre_ms!r} ms = {pre_ms / pre_bound!r} x)",
          flush=True)
    del params, table
    torch.cuda.empty_cache()

    # Whisper-base, full width: the encoder over 1,500 random frames (K6,
    # not causal), then generate with its output (K6 for the prompt's self-
    # and cross-attention, K7 for a step's).
    cfg = get_config("whisper_base")
    params, wbytes = load(cfg, "Whisper-base")
    L = cfg.n_layers
    frames = torch.randn((LM_BATCH, cfg.encdec.encoder_seq, cfg.d_model), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1)).bfloat16()
    with torch.inference_mode():
        whisper.encode(params, frames, cfg)                          # warm-up
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        enc = whisper.encode(params, frames, cfg)
        torch.cuda.synchronize()
        enc_ms = (time.perf_counter() - t0) * 1e3
        enc_counts = K.launch_counts()
    if enc_counts != {k: {"flash_attention": cfg.encdec.encoder_layers}.get(k, 0)
                      for k in enc_counts}:
        fail(f"Whisper encode: launches {enc_counts}")
    if not bool(torch.isfinite(enc).all()):
        fail("Whisper encode: states not finite")
    print(f"[11] Whisper-base encode of {LM_BATCH} x {cfg.encdec.encoder_seq} frames: "
          f"{enc_ms!r} ms ({LM_BATCH * cfg.encdec.encoder_seq / enc_ms * 1e3!r} frames/s); "
          f"launches { {k: n for k, n in enc_counts.items() if n} }", flush=True)
    main, _, step_ms = serve_model(
        K, "Whisper-base", cfg, params, prompts_of(cfg, WHISPER_PROMPT), LM_NEW,
        {"flash_attention": 2 * L, "embedding_gather": 1},
        {"decode_attention": 2 * L, "embedding_gather": 1}, enc_out=enc)
    runs["whisper"] = {k: n + enc_counts[k] for k, n in main.items()}

    def tree_bytes(tree):
        return sum(p.numel() * p.element_size() for p in tree.parameters())

    # The encoder's bound: its weights, the frames read and the states written
    # over HBM, against 2 x its stacked products' weights (the 3-dim leaves) x
    # tokens plus QK^T and PV (4 x B x H x S^2 x dh a layer) at the tensor-core
    # rate. A step's: the decoder's weights, the tied head's table (the
    # logits read all of it), the self caches up to the last step's valid
    # length and every layer's cross k, v over HBM.
    S_enc, H, dh = cfg.encdec.encoder_seq, cfg.n_heads, cfg.attn_head_dim
    act_bytes = 2 * LM_BATCH * S_enc * cfg.d_model * enc.element_size()
    enc_flops = (2 * sum(p.numel() for p in params["enc_layers"].parameters() if p.dim() == 3)
                 * LM_BATCH * S_enc + 4 * cfg.encdec.encoder_layers * LM_BATCH * H * S_enc ** 2
                 * dh)
    enc_bound = max((tree_bytes(params["enc_layers"]) + act_bytes) / HBM_BYTES_PER_S,
                    enc_flops / TENSOR_FLOPS_PER_S) * 1e3
    valid = WHISPER_PROMPT + LM_NEW
    kv_bytes = 2 * L * LM_BATCH * cfg.n_kv_heads * (valid + S_enc) * dh * enc.element_size()
    step_bytes = (tree_bytes(params["dec_layers"]) + tree_bytes(params["embed"])
                  + tree_bytes(params["dec_norm"]) + kv_bytes)
    step_bound = step_bytes / HBM_BYTES_PER_S * 1e3
    med = float(np.median(step_ms))
    print(f"[11] Whisper device bounds: encode max(({tree_bytes(params['enc_layers'])} B of "
          f"weights + {act_bytes} B of frames and states) / {HBM_BYTES_PER_S / 1e12:.2f} TB/s, "
          f"{enc_flops} FLOP / {TENSOR_FLOPS_PER_S / 1e12:.0f} TFLOP/s) = {enc_bound!r} ms "
          f"(encode {enc_ms!r} ms = {enc_ms / enc_bound!r} x); a decode step reads the "
          f"decoder's weights, the tied table, the self caches and the cross k, v, {step_bytes} "
          f"B / {HBM_BYTES_PER_S / 1e12:.2f} TB/s = {step_bound!r} ms (median step {med!r} ms = "
          f"{med / step_bound!r} x)", flush=True)
    del params, enc, frames
    torch.cuda.empty_cache()

    # Full width, depth cut: arctic (128 experts top-2 beside a dense
    # residual MLP, a group of 7), chameleon (vlm, a group of 8), granite
    # (MQA, a group of 48, the GELU MLP).
    for arch, layers in CUT_DEPTH.items():
        cfg = get_config(arch).replace(n_layers=layers)
        params, _ = load(cfg, f"{arch} (depth {layers})")
        main, _, _ = serve_model(
            K, f"{arch} (depth {layers})", cfg, params, prompts_of(cfg, LM_PROMPT), LM_NEW,
            {"flash_attention": layers, "embedding_gather": 1},
            {"decode_attention": layers, "embedding_gather": 1})
        runs[arch] = main
        del params
        torch.cuda.empty_cache()

    # The six at their smoke size on the card against the CPU, teacher-
    # forced (f32 at the reference's 2e-4 / 2e-3, bf16 at 8e-2; the smoke
    # MoEs are dropless), then each step after a prefill against the
    # forward on the card (tests/test_serving.py's 8e-2).
    for arch in ("deepseek_v2_lite_16b", "arctic_480b", "chameleon_34b", "granite_34b",
                 "granite_20b", "whisper_base"):
        worst = {}
        for dtype in ("float32", "bfloat16"):
            cfg = get_smoke_config(arch).replace(dtype=dtype)
            mod = family_module(cfg)
            init = mod.init_model if cfg.family == "audio" else mod.init_lm
            on_cpu = init(cfg, device="cpu")
            on_card = init(cfg, device=dev)
            on_card.load_state_dict(on_cpu.state_dict())
            scfg = ServeConfig(batch=2, max_seq=40)
            p_s = lm_batch(LMDataConfig(vocab=cfg.vocab, seq_len=24, global_batch=2),
                           0)["tokens"]
            enc_cpu = kv_cpu = kv_card = frames = None
            if cfg.family == "audio":
                frames = torch.randn((2, cfg.encdec.encoder_seq, cfg.d_model),
                                     generator=torch.Generator().manual_seed(0)).to(
                    getattr(torch, dtype))
                with torch.inference_mode():
                    enc_cpu = mod.encode(on_cpu, frames, cfg)
                    kv_cpu = mod.cross_kv(on_cpu, enc_cpu, cfg)
                    kv_card = mod.cross_kv(on_card, mod.encode(on_card, frames.to(dev), cfg), cfg)
            cpu_engine = ServingEngine(cfg, on_cpu, scfg)
            forced = cpu_engine.generate(p_s, max_new_tokens=6,
                                         **({} if enc_cpu is None else {"enc_out": enc_cpu}))
            pairs = teacher_forced(ServingEngine(cfg, on_card, scfg), cpu_engine, p_s, forced,
                                   dev, "cpu", kv_card, kv_cpu)
            tol = dict(atol=2e-4, rtol=2e-3) if dtype == "float32" else dict(atol=8e-2, rtol=0.0)
            worst[dtype] = max(max_abs_err(a, b) for a, b in pairs)
            if not all(torch.allclose(a.float(), b.float(), **tol) for a, b in pairs):
                fail(f"smoke {arch} {dtype} on the card differs from the CPU by "
                     f"{worst[dtype]!r} ({tol})")
            with torch.inference_mode():
                toks = torch.from_numpy(np.concatenate([p_s, forced[:, :1]], axis=1)).to(dev)
                S = toks.shape[1]
                args = () if frames is None else (frames.to(dev),)
                full = mod.forward(on_card, toks, *args, cfg)
                card_engine = ServingEngine(cfg, on_card, scfg)
                e_args = () if kv_card is None else (kv_card,)
                caches = init_cache(cfg, scfg, device=dev)
                _, caches = card_engine.prefill(on_card, toks[:, :S - 1], caches, *e_args)
                last, _ = card_engine.step(on_card, toks[:, S - 1:], S - 1, caches, *e_args)
                fwd_err = max_abs_err(last[:, -1], full[:, -1])
            if fwd_err >= 8e-2:
                fail(f"smoke {arch} {dtype} on the card: the step after a prefill differs from "
                     f"the forward by {fwd_err!r} (>= 8e-2)")
            worst[dtype + " step vs forward"] = fwd_err
        print(f"[11] smoke {arch} on the card vs the CPU, teacher-forced (prefill of 24 + 6 "
              f"steps), max abs diff {worst} (f32 allclose 2e-4 / 2e-3, bf16 8e-2; step vs "
              f"forward < 8e-2)", flush=True)
    return runs


# Phase 12, training: stablelm-3b at full width and depth on TRAIN_BATCH x
# TRAIN_SEQ tokens for TRAIN_STEPS steps of one batch; mamba2-130m at full
# width and depth, SSM_SEQ tokens a sequence, through the launcher, killed
# and resumed.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 1024, 6
SSM_SEQ, SSM_STEPS = 256, 6
TRAIN_ARCHS = ("stablelm_3b", "deepseek_v2_lite_16b", "mamba2_130m", "zamba2_2p7b",
               "chameleon_34b", "whisper_base")
# The launcher run with deterministic kernels: cuBLAS's workspace fixed
# before CUDA starts, then torch.use_deterministic_algorithms (the
# embedding's backward is a scatter-add, in no fixed order otherwise).
DETERMINISTIC_LAUNCH = ("import runpy, sys, torch; torch.use_deterministic_algorithms(True); "
                        "sys.argv = ['train'] + sys.argv[1:]; "
                        "runpy.run_module('repro_torch.launch.train', run_name='__main__')")


# Phase 14's cells, and the process that runs them: the dry run's fake
# tensors live on the card, and nothing may launch a kernel.
DRYRUN_CELLS = (("stablelm_3b", "train_4k", "pod"),
                ("deepseek_v2_lite_16b", "decode_32k", "multipod"))
DRYRUN_RUN = ("import json, sys; from repro_torch import kernels as K; "
              "from repro_torch.launch import dryrun; "
              "recs = [dryrun.run_cell(a, s, m, save=False, device='cuda') "
              "for a, s, m in json.loads(sys.argv[1])]; "
              "print(json.dumps({'records': recs, 'launches': K.launch_counts()}))")
DRYRUN_TIMEOUT_S = 600


def start_dryrun():
    """Phase 14's process, started early so that it runs beside the build;
    killed at exit if still running."""
    import atexit
    import os

    proc = subprocess.Popen([sys.executable, "-c", DRYRUN_RUN, json.dumps(DRYRUN_CELLS)],
                            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def dryrun_phase(proc, name_power: str) -> None:
    """Phase 14: wait for the dry run's process and check its records."""
    t0 = time.perf_counter()
    try:
        out, err = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"[14] dry run: no exit within {DRYRUN_TIMEOUT_S} s")
    if proc.returncode != 0:
        fail(f"[14] dry run exited {proc.returncode}: {err[-3000:]}")
    res = json.loads(out.strip().splitlines()[-1])
    if any(res["launches"].values()):
        fail(f"[14] dry run: launches {res['launches']}; it runs no kernel")
    for rec in res["records"]:
        cell = f"{rec['arch']} {rec['shape']} on {rec['mesh']} {tuple(rec['mesh_shape'])}"
        if rec["status"] != "ok":
            fail(f"[14] dry run {cell}: {rec.get('error')}\n{rec.get('traceback', '')[-2000:]}")
        hlo = rec["hlo"]
        print(f"[14] {name_power}: dry run {cell}, {rec['device']}: {rec['status']} in "
              f"total_s {rec['total_s']!r} (lower {rec['lower_s']!r} s, trace {rec['trace_s']!r} "
              f"s, {hlo['ops']} ops); per device: flops {hlo['flops_per_device']!r}, bytes "
              f"{hlo['bytes_per_device']!r}, collective bytes "
              f"{hlo['collective_bytes_per_device']}, memory {rec['memory']}", flush=True)
    print(f"[14] no kernel launched; waited {time.perf_counter() - t0:.1f} s for the process",
          flush=True)


def no_launches(K, what: str) -> None:
    counts = K.launch_counts()
    if any(counts.values()):
        fail(f"{what}: launches {counts}; the training route runs no kernel")


def train_phase(dev, K, name_power: str) -> None:
    """Phase 12: training on the card. (a) stablelm-3b at full width and
    depth, timed, its device busy share profiled; (b) mamba2-130m at full
    width and depth through ``launch/train.py`` (straight, then SIGTERM after
    its second step and ``--resume auto``), the final states bitwise equal;
    (c) one step of each family's f32 smoke config on the card against the
    CPU; (d) a cached step of 4 new tokens on the card against the CPU.
    No kernel launches in (a)-(c): the train step runs the reference's plain
    route (``use_pallas=False``)."""
    import os
    import signal
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import tree as T
    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
    from repro_torch.data import LMDataConfig, lm_batch
    from repro_torch.models import family_module, get_config, get_smoke_config, param_count
    from repro_torch.models import transformer as TT
    from repro_torch.training import TrainConfig, build_loss_fn, build_train_step, init_state
    from repro_torch.training.optimizer import lr_schedule
    from repro_torch.training.train_step import value_and_grad

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"[12] {name_power}; memory_allocated at the phase's start "
          f"{torch.cuda.memory_allocated()} B", flush=True)

    # (a) stablelm-3b, full width and depth: default AdamW, remat, no
    # compression, one repeated batch.
    cfg = get_config("stablelm_3b")
    tcfg = TrainConfig()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_state(0, cfg, tcfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = sum(p.numel() for p in T.leaves(state["params"]))
    if n != param_count(cfg):
        fail(f"stablelm-3b: {n} parameters, param_count says {param_count(cfg)}")
    state_bytes = torch.cuda.memory_allocated()
    batch = {k: torch.from_numpy(v).to(dev) for k, v in lm_batch(
        LMDataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH), 0).items()}
    step = build_train_step(cfg, tcfg)
    losses, gnorms, step_s = [], [], []
    K.reset_launch_counts()
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
        gnorms.append(float(m["grad_norm"]))
    no_launches(K, "stablelm-3b train steps")
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses + gnorms):
        fail(f"stablelm-3b training: losses {losses}, grad norms {gnorms} not all finite")
    if not losses[-1] < losses[0]:
        fail(f"stablelm-3b training: the loss did not fall from step 1 to {TRAIN_STEPS}: {losses}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    med = float(np.median(step_s[1:]))
    bound_s = 8 * n * tokens / TENSOR_FLOPS_PER_S
    print(f"[12] stablelm-3b train (32 layers, d_model 2560, {n} bf16 parameters, state drawn "
          f"in {init_s:.3f} s, {state_bytes} B: params, f32 moments; default AdamW, remat, "
          f"batch {TRAIN_BATCH} x {TRAIN_SEQ}): losses {losses}, grad norms {gnorms}; step s "
          f"{step_s} (first with warm-up); median of steps 2-{TRAIN_STEPS} {med!r} s = "
          f"{tokens / med!r} tokens/s; max_memory_allocated {peak} B; product bound 8 x {n} x "
          f"{tokens} / {TENSOR_FLOPS_PER_S / 1e12:.0f} TFLOP/s = {bound_s!r} s "
          f"({med / bound_s!r} x); no kernel launched; {name_power}", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tprof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(f"[12] stablelm-3b profiled train step: wall {wall!r} s, "
          f"{device_busy(tprof.events(), wall, top=10)}", flush=True)
    del state, batch, step, m, tprof
    torch.cuda.empty_cache()

    # (b) mamba2-130m, full width and depth, through the launcher: the SSM
    # trains through the sequential recurrence (mamba2_ssd_ref), a Python
    # loop of S steps a layer, so its steps (the straight run's, timed by
    # the launcher) are host-bound launches.
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUBLAS_WORKSPACE_CONFIG=":4096:8")

    def launch(ckpt, *extra):
        return subprocess.Popen(
            [sys.executable, "-c", DETERMINISTIC_LAUNCH, "--arch", "mamba2_130m", "--device",
             dev.type, "--steps", str(SSM_STEPS), "--seq", str(SSM_SEQ), "--batch",
             str(TRAIN_BATCH), "--log-every", "1", "--save-every", "1000",
             "--checkpoint-dir", ckpt, *extra],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def finish(proc, what):
        try:
            out, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            fail(f"launcher {what}: no exit within 300 s")
        if proc.returncode != 0:
            fail(f"launcher {what} exited {proc.returncode}: {err[-2000:]}")
        return out

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        straight = finish(launch(f"{tmp}/straight"), "straight run")
        straight_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        proc = launch(f"{tmp}/resumed")
        head = []
        for line in proc.stdout:
            head.append(line)
            if line.startswith("step     1"):
                proc.send_signal(signal.SIGTERM)
                break
        killed = "".join(head) + finish(proc, "stopped by SIGTERM")
        saved = CheckpointManager(CheckpointConfig(directory=f"{tmp}/resumed")).all_steps()
        if len(saved) != 1 or not 2 <= saved[0] < SSM_STEPS:
            fail(f"launcher SIGTERM: checkpoints {saved}; expected one at step 2..{SSM_STEPS - 1}")
        resumed = finish(launch(f"{tmp}/resumed", "--resume", "auto"), "resumed")
        kill_s = time.perf_counter() - t0
        if f"resumed from step {saved[0]}" not in resumed:
            fail(f"launcher resume: {resumed[-500:]}")
        a = CheckpointManager(CheckpointConfig(directory=f"{tmp}/straight")).restore()
        b = CheckpointManager(CheckpointConfig(directory=f"{tmp}/resumed")).restore()
    if a["step"] != SSM_STEPS or b["step"] != SSM_STEPS or a["names"] != b["names"]:
        fail(f"launcher checkpoints: steps {a['step']}, {b['step']}")
    differ = [nm for nm, x, y in zip(a["names"], a["leaves"], b["leaves"])
              if not bitwise_equal(x, y)]
    if differ:
        fail(f"launcher kill-and-resume: {len(differ)} of {len(a['names'])} leaves differ from "
             f"the straight run's, first {differ[:5]}")
    step_ms = [float(ln.rsplit(" ", 2)[1]) for ln in straight.splitlines()
               if ln.startswith("step ")]
    print(f"[12] launch/train.py --arch mamba2_130m --device cuda (24 layers, d_model 768, "
          f"{SSM_STEPS} steps, batch {TRAIN_BATCH} x {SSM_SEQ}, the recurrence {SSM_SEQ} steps a "
          f"layer, deterministic algorithms): straight run {straight_s:.1f} s (step ms {step_ms}: "
          f"{TRAIN_BATCH * SSM_SEQ * 1e3 / float(np.median(step_ms[1:]))!r} tokens/s at the "
          f"median of steps 2-{SSM_STEPS}); SIGTERM after step 2 saved step {saved[0]}, resumed to "
          f"{SSM_STEPS}: {kill_s:.1f} s for both processes; the {len(a['names'])} leaves of the "
          f"final state bitwise equal to the straight run's; straight losses "
          f"{[ln.split()[2] for ln in straight.splitlines() if ln.startswith('step ')]}, "
          f"resumed {[ln.split()[2] for ln in (killed + resumed).splitlines() if ln.startswith('step ')]}",
          flush=True)

    # (c) one train step of each family's f32 smoke config, card against CPU,
    # from one state: loss rtol 1e-5, grad norm 1e-4, each gradient leaf at
    # 1e-4 of its largest magnitude; the updated parameters within 2 x lr
    # (+1e-6 relative): Adam's first step moves an element by +-lr by the
    # sign of its gradient, which two sums of a near-zero gradient may
    # differ on.
    worst = {}
    for arch in TRAIN_ARCHS:
        cfg = get_smoke_config(arch).replace(dtype="float32")
        tc = TrainConfig(loss_chunk=16)
        cpu_state = init_state(0, cfg, tc, device="cpu")
        card_state = T.unflatten(cpu_state, [t.to(dev) for t in T.leaves(cpu_state)])
        b = lm_batch(LMDataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4), 0)
        if cfg.family == "audio":
            b["frames"] = (np.random.default_rng(0).standard_normal(
                (4, cfg.encdec.encoder_seq, cfg.d_model)) * 0.5).astype(np.float32)
        runs = {}
        K.reset_launch_counts()
        for where, st in (("cpu", cpu_state), (dev, card_state)):
            batch = {k: torch.from_numpy(v).to(where) for k, v in b.items()}
            _, grads = value_and_grad(build_loss_fn(cfg, tc), st["params"], batch)
            st, m = build_train_step(cfg, tc)(st, batch)
            runs[str(where)] = (float(m["loss"]), float(m["grad_norm"]),
                           [g.cpu() for g in T.leaves(grads)], [p.cpu() for p in
                                                                T.leaves(st["params"])])
        no_launches(K, f"smoke {arch} train steps")
        (l_c, n_c, g_c, p_c), (l_g, n_g, g_g, p_g) = runs["cpu"], runs[str(dev)]
        lr1 = float(lr_schedule(tc.adamw, torch.tensor(1)))
        g_err = max(max_abs_err(x, y) / max(float(x.abs().max()), 1e-30) for x, y in zip(g_c, g_g))
        p_err = max(max_abs_err(x, y) for x, y in zip(p_c, p_g))
        if not (abs(l_c - l_g) <= 1e-5 * abs(l_c) and abs(n_c - n_g) <= 1e-4 * n_c
                and all(torch.allclose(y, x, rtol=1e-4, atol=1e-4 * float(x.abs().max()))
                        for x, y in zip(g_c, g_g))
                and all(torch.allclose(y, x, rtol=1e-6, atol=2 * lr1) for x, y in zip(p_c, p_g))):
            fail(f"smoke {arch} train step on the card differs from the CPU: loss {l_g!r} vs "
                 f"{l_c!r}, grad norm {n_g!r} vs {n_c!r}, grads {g_err!r} of the leaf max, "
                 f"params {p_err!r}")
        worst[arch] = (abs(l_c - l_g), abs(n_c - n_g) / n_c, g_err, p_err)
    print(f"[12] one f32 smoke train step, card vs CPU (|loss|, grad norm rel, grads / leaf max, "
          f"params abs; 2 x lr = {2 * lr1!r}): {worst}; no kernel launched", flush=True)

    # (d) a cached step of 4 new tokens after a prefill of 24: the
    # reference's full-cache attention (and the hybrid's sequential SSD
    # steps), plain torch on the card; phase 11's tolerances.
    errs = {}
    for arch in ("stablelm_3b", "zamba2_2p7b"):
        for dtype in ("float32", "bfloat16"):
            cfg = get_smoke_config(arch).replace(dtype=dtype)
            mod = family_module(cfg)
            on_cpu = mod.init_lm(cfg, device="cpu")
            on_card = mod.init_lm(cfg, device=dev)
            on_card.load_state_dict(on_cpu.state_dict())
            toks = lm_batch(LMDataConfig(vocab=cfg.vocab, seq_len=28, global_batch=2),
                            1)["tokens"]
            out = {}
            with torch.inference_mode():
                for where, params in (("cpu", on_cpu), (dev, on_card)):
                    tt = torch.from_numpy(toks).to(where)
                    if cfg.family == "hybrid":
                        _, caches = mod.prefill_with_state(params, tt[:, :24], cfg, max_seq=40)
                    else:
                        caches = TT.init_kv_cache(cfg, 2, 40, device=where)
                        _, caches = TT.prefill(params, tt[:, :24], caches, cfg)
                    K.reset_launch_counts()
                    logits, _ = mod.decode_step(params, tt[:, 24:], 24, caches, cfg)
                    counts = K.launch_counts()
                    want = {"embedding_gather": 1} if torch.device(where).type == "cuda" else {}
                    if counts != {k: want.get(k, 0) for k in counts}:
                        fail(f"{arch} {dtype} 4-token step on {where}: launches {counts}")
                    out[str(where)] = logits.cpu()
            tol = dict(atol=2e-4, rtol=2e-3) if dtype == "float32" else dict(atol=8e-2, rtol=0.0)
            card = out[str(dev)]
            if card.shape != (2, 4, cfg.vocab) or not torch.allclose(
                    card.float(), out["cpu"].float(), **tol):
                fail(f"{arch} {dtype}: a cached step of 4 tokens on the card differs from the "
                     f"CPU by {max_abs_err(card, out['cpu'])!r} ({tol})")
            errs[f"{arch} {dtype}"] = max_abs_err(card, out["cpu"])
    print(f"[12] a cached step of 4 new tokens after a prefill of 24, card vs CPU, max abs "
          f"diff {errs} (f32 2e-4 / 2e-3, bf16 8e-2); K4 its one launch", flush=True)


def sweep_phase(dev, K, wl):
    """Phase 8: the DSE sweep on the card at full width (the phase-4
    workload x ``tpuv6e()``: policies x 2 capacities x 2 ways x translation
    off / the FIFO TLB of phase 4, 40 configurations), with its checks.
    Returns the launches of each scan kernel in the sweep's runs (D1, D2:
    the grid; K1, K2: the lru sub-grid under ``pallas``/``stack_pallas``)."""
    import shutil
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import (FaultEvent, FaultPlan, SweepCheckpoint, TranslationConfig,
                                  profiling, simulate, sweep, tpuv6e)
    from repro_torch.core.engine import build_embedding_traces
    from repro_torch.core.faults import InjectedKill
    from repro_torch.core.memory.cache import bucket_rows
    from repro_torch.core.memory.system import lane_geometry
    from repro_torch.distributed import sweep_shard
    from repro_torch.kernels.rrip_scan import rrip_scan_flat

    tlb = TranslationConfig(replacement="fifo", **TRANSLATION)
    axes = dict(policies=SWEEP_POLICIES, capacities=SWEEP_CAPACITIES, ways=SWEEP_WAYS,
                translations=(None, tlb), zipf_s=0.8, seed=0)
    big, small = max(SWEEP_CAPACITIES), min(SWEEP_CAPACITIES)
    sub_axes = dict(axes, capacities=(big,))

    def records(entries):
        return [(e.config, dataclasses.asdict(e.result)) for e in entries]

    def timed_sweep(**kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sweep(wl, device=dev, **kw)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    # The grid, with the launch counts reset just before and read just after,
    # under profiling.collect() for its stages (as phase 4 times simulate).
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with profiling.collect() as prof:
        main = sweep(wl, tpuv6e(), device=dev, **axes)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, d2_routes = K.launch_counts(), dict(rrip_scan_flat.routes)
    n, keys = main.num_configs, main.distinct_memo_keys
    if n != len(SWEEP_POLICIES) * len(SWEEP_CAPACITIES) * len(SWEEP_WAYS) * 2:
        fail(f"sweep: {n} configurations")
    for e in main.entries:
        summ = e.result.summary()
        if len(e.result.batches) != wl.num_batches or not e.result.total_cycles > 0 or not all(
                math.isfinite(v) for v in summ.values() if isinstance(v, float)):
            fail(f"sweep {e.config.label}: malformed result {summ}")
    for kname, c in counts.items():
        should = kname in ("dram_scan", "rrip_scan")
        if should and c == 0:
            fail(f"sweep: kernel {kname} was not launched")
        if not should and c != 0:
            fail(f"sweep: kernel {kname} launched {c} times off the stack backend's path")
    by = {(e.config.policy, e.config.capacity_bytes, e.config.ways,
           e.config.translation is not None): e for e in main.entries}
    stages = {k: round(v, 4) for k, v in prof.breakdown(wall).items()}
    print(f"[8] sweep of {n} configurations ({keys} memo keys) of {wl.name} on {dev} "
          f"({smi('name,power.limit')}): wall {wall!r} s, {wall / n!r} s per configuration, "
          f"{wall / keys!r} s per memo key; launches {counts}, D2 by route {d2_routes}; stages "
          f"{json.dumps(stages)}", flush=True)

    # 1. Entries against independent simulate calls on the card.
    picks = [("lru", big, 16, False), ("srrip", small, 8, True),
             ("fifo", big, 16, False), ("pinning", small, 8, False)]
    sim_s = []
    for pol, cap, w, tr in picks:
        hw = tpuv6e().with_policy(pol, capacity_bytes=cap, ways=w).with_translation(
            tlb if tr else None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = simulate(wl, hw, device=dev)
        torch.cuda.synchronize()
        sim_s.append(time.perf_counter() - t0)
        if dataclasses.asdict(by[(pol, cap, w, tr)].result) != dataclasses.asdict(want):
            fail(f"sweep entry {by[(pol, cap, w, tr)].config.label} differs from simulate()")
    mean_sim = sum(sim_s) / len(sim_s)
    print(f"[8] 4 entries bitwise equal to independent simulate() calls on {dev} "
          f"({[by[p].config.label for p in picks]}): simulate wall {sim_s} s, mean "
          f"{mean_sim!r} s per configuration against the sweep's {wall / n!r} "
          f"({mean_sim * n / wall!r} x)", flush=True)

    # 2. The reference's totals of phase 4 (tpuv6e() is 128 MiB, 16 ways).
    pins = {("srrip", 128 << 20, 16, False): (REF_TOTAL["srrip"], None),
            ("fifo", 128 << 20, 16, False): (REF_TOTAL["fifo"], None),
            ("srrip", 128 << 20, 16, True): REF_TRANSLATION[("srrip", "fifo")][:2]}
    pins.update({("spm", c, w, True): REF_TRANSLATION[("spm", "fifo")][:2]
                 for c in SWEEP_CAPACITIES for w in SWEEP_WAYS})
    for key, (cycles, walks) in pins.items():
        r = by[key].result
        if r.total_cycles != cycles or (walks is not None and r.tlb_walks != walks):
            fail(f"sweep entry {by[key].config.label}: total_cycles {r.total_cycles!r}, "
                 f"tlb_walks {r.tlb_walks}; the reference's {cycles!r}, {walks}")
    print(f"[8] {len(pins)} entries equal the reference's totals of phase 4", flush=True)

    want_sub = records([e for e in main.entries if e.config.capacity_bytes == big])

    # 3. Two shards on the one card, each on a stream of its own, against the
    # unsharded sweep of the same sub-grid, timed in the order unsharded,
    # sharded, sharded, unsharded. (The shards' streams are read inside the
    # workers' device context.)
    on_device = sweep_shard._on_shard_device
    walls = {"unsharded": [], "sharded": []}
    for kind in ("unsharded", "sharded", "sharded", "unsharded"):
        seen = set()

        @contextlib.contextmanager
        def recording(device, seen=seen):
            with on_device(device):
                seen.add((threading.get_ident(), torch.cuda.current_stream().cuda_stream))
                yield

        K.reset_launch_counts()
        sweep_shard._on_shard_device = recording
        try:
            got, s_wall = timed_sweep(base_hw=tpuv6e(), devices=2 if kind == "sharded" else None,
                                      **sub_axes)
        finally:
            sweep_shard._on_shard_device = on_device
        walls[kind].append(s_wall)
        if records(got.entries) != want_sub:
            fail(f"{kind} sweep of the {big >> 20} MiB sub-grid differs from the grid's entries")
        want_streams = 2 if kind == "sharded" else 0
        if len({st for _, st in seen}) != want_streams:
            fail(f"{kind} sweep: the shard workers ran on streams {seen}, not "
                 f"{want_streams} of their own")
        if kind == "sharded":
            sharded, streams, s_counts = got, sorted(seen), K.launch_counts()
    plan = sweep_shard.resolve_shard_plan(2, dev)
    print(f"[8] devices=2 on {plan.devices} ({sharded.device_count} distinct device(s); "
          f"(worker thread, stream) {streams}): {sharded.num_configs} configurations bitwise "
          f"equal to the unsharded sweep; wall s in the order unsharded, sharded, sharded, "
          f"unsharded: {walls['unsharded'][0]!r}, {walls['sharded'][0]!r}, "
          f"{walls['sharded'][1]!r}, {walls['unsharded'][1]!r} (mean unsharded / sharded "
          f"{sum(walls['unsharded']) / sum(walls['sharded'])!r} x); launches {s_counts}; shards "
          f"{json.dumps(sharded.telemetry.to_dict()['shards'])}", flush=True)

    # 4. Killed after its first cadence round (a torn journal append), then resumed.
    ckdir = ROOT / "build" / "sweep_smoke"
    shutil.rmtree(ckdir, ignore_errors=True)
    path = str(ckdir / "sweep.ckpt")
    plan = FaultPlan(events=(FaultEvent("torn_write", round=1),))
    ck = SweepCheckpoint(path, cadence=SWEEP_CADENCE)
    killed = False
    try:
        sweep(wl, tpuv6e(), checkpoint=ck, fault_plan=plan, device=dev, **sub_axes)
    except InjectedKill:
        killed = True
    ck.close()
    if not killed:
        fail("sweep: the injected kill did not stop the checkpointed run")
    resumed, r_wall = timed_sweep(base_hw=tpuv6e(), checkpoint=path, **sub_axes)
    shutil.rmtree(ckdir, ignore_errors=True)
    if records(resumed.entries) != want_sub:
        fail("sweep: the resumed run differs from the uninterrupted one")
    if not 0 < resumed.resumed_keys < resumed.distinct_memo_keys:
        fail(f"sweep: resumed {resumed.resumed_keys} of {resumed.distinct_memo_keys} memo keys")
    print(f"[8] killed after its first round of {SWEEP_CADENCE} memo keys, then resumed: "
          f"{resumed.resumed_keys} of {resumed.distinct_memo_keys} keys restored, the rest "
          f"re-evaluated in {r_wall!r} s; bitwise equal to the uninterrupted sweep", flush=True)

    # 5. A lru sub-grid under the K1 and K2 backends, against stack. Its
    # capacities add 64 MiB to the grid's, whose lane geometries share shape
    # buckets with the others' (64 MiB/8 ways with 128 MiB/8 ways, 64 MiB/16
    # ways with 128 MiB/16 ways), so one launch per bucket across the
    # configurations is fewer than the configurations' buckets one by one.
    lru_axes = dict(policies=("lru",), capacities=LRU_SUB_CAPACITIES, ways=SWEEP_WAYS,
                    zipf_s=0.8, seed=0)
    etrace = build_embedding_traces(wl, None, 0, 0.8)[0]
    lanes = [lane_geometry(tpuv6e().with_policy("lru", capacity_bytes=c, ways=w), etrace.spec)
             for c in LRU_SUB_CAPACITIES for w in SWEEP_WAYS]
    shared = len(list(bucket_rows([etrace.vec_ids] * len(lanes), lanes)))
    alone = sum(len(list(bucket_rows([etrace.vec_ids], [g]))) for g in lanes)
    if not shared < alone:
        fail(f"lru sub-grid: {shared} shape buckets across the configurations, {alone} one by "
             f"one; the launch count could not tell the two apart")
    stack_lru, st_wall = timed_sweep(base_hw=tpuv6e(), **lru_axes)
    want_lru = records(stack_lru.entries)
    if [r for r in want_lru if r[0].capacity_bytes in SWEEP_CAPACITIES] != records(
            [e for e in main.entries if e.config.policy == "lru" and e.config.translation is None]):
        fail("sweep lru sub-grid under stack differs from the grid's lru entries")
    backend_launches = {}
    for backend, kname in (("pallas", "cache_scan"), ("stack_pallas", "stack_distance")):
        K.reset_launch_counts()
        got, b_wall = timed_sweep(base_hw=tpuv6e().with_cache_backend(backend), **lru_axes)
        c = K.launch_counts()
        if records(got.entries) != want_lru:
            fail(f"sweep lru sub-grid under {backend} differs from stack")
        if c[kname] != shared:
            fail(f"sweep lru sub-grid under {backend}: {c[kname]} {kname} launches, expected "
                 f"one per shape bucket across configurations, {shared} ({alone} one by one)")
        backend_launches[kname] = c[kname]
        print(f"[8] lru sub-grid ({len(lanes)} configurations, {len(want_lru)} entries) under "
              f"{backend}: bitwise equal to stack (wall {st_wall!r} s); {kname} {c[kname]} "
              f"launches, one per shape bucket across the configurations (their buckets one "
              f"by one: {alone}); wall {b_wall!r} s; launches {c}", flush=True)

    # The card's busy time in a profiled sweep of the grid.
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tprof:
        t0 = time.perf_counter()
        sweep(wl, tpuv6e(), device=dev, **axes)
        torch.cuda.synchronize()
        p_wall = time.perf_counter() - t0
    print(f"[8] profiled sweep of the grid: wall {p_wall!r} s, "
          f"{device_busy(tprof.events(), p_wall, ('dram_scan', 'rrip_scan'))}", flush=True)
    return {"dram_scan": counts["dram_scan"], "rrip_scan": d2_routes, **backend_launches}


def cluster_phase(dev, K, wl, single_lru):
    """Phase 9: the multi-core cluster on the card at full width (the
    phase-4 workload; runs A-E of ``REF_CLUSTER``'s note), with its checks.
    ``single_lru`` is phase 4's lru/stack result as a dict. Returns the
    launches of each run, by run name."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import (TranslationConfig, dlrm_rmc2_small, profiling, simulate, sweep,
                                  tpuv6e)
    from repro_torch.core.engine import build_embedding_traces
    from repro_torch.core.memory.cache import bucket_rows
    from repro_torch.core.memory.dram import dispatch_groups
    from repro_torch.core.memory.rrip import row_plan
    from repro_torch.core.memory.system import EmbeddingTrace, lane_geometry, memory_system_for
    from repro_torch.core.memory.tlb import classify_tlb, tlb_pages
    from repro_torch.core.trace import shard_trace

    n = CLUSTER_CORES
    hw_a = tpuv6e().with_onchip(capacity_bytes=CLUSTER_CAPACITY).with_cluster(n, "private", "batch")
    hw_c = tpuv6e().with_cluster(n, "private", "table_hash")
    tlb = TranslationConfig(replacement="fifo", **TRANSLATION)
    runs = {
        "A lru/stack": hw_a.with_policy("lru"),
        "A lru/pallas": hw_a.with_policy("lru").with_cache_backend("pallas"),
        "A lru/stack_pallas": hw_a.with_policy("lru").with_cache_backend("stack_pallas"),
        "A srrip/stack": hw_a.with_policy("srrip"),
        "B lru/stack": tpuv6e().with_policy("lru").with_cluster(n, "shared", "batch"),
        "C per_core/table_rank": hw_c.with_placement("per_core", "table_rank"),
        "C per_table/hot_replicate": hw_c.with_placement("per_table", "hot_replicate"),
        "D lru/stack + FIFO TLB": hw_a.with_policy("lru").with_translation(tlb),
    }

    # The launches each run must make, computed on the host from the shards:
    # K1/K2 one per shape bucket of each core's lane stream, D2 one per
    # short-route row table (two per chunked one) of each core's srrip rows
    # and of the central MMU's two FIFO levels, D1 one per simulate and, in
    # the sweep E, one per dispatch group of its requests (built here as the
    # sweep builds them: a classification per topology, a placement each).
    etrace = build_embedding_traces(wl)[0]
    lane = lane_geometry(hw_a, etrace.spec)
    shard_vecs = [EmbeddingTrace.from_concat(etrace.spec, sh.concat).vec_ids
                  for sh in shard_trace(etrace.concat, n, "batch") if len(sh)]
    buckets = sum(len(list(bucket_rows([v], [lane]))) for v in shard_vecs)

    def d2_launches(plans):
        return sum(2 if table.chunked else 1 for _, _, groups in plans for _, table in groups)

    srrip_plans = [row_plan(v, lane.num_sets, lane.ways, "srrip") for v in shard_vecs]
    clas = memory_system_for(runs["D lru/stack + FIFO TLB"], dev).classify_for_pending(etrace)
    tr = runs["D lru/stack + FIFO TLB"].translation
    pages = tlb_pages(clas.merged.miss_lines, hw_a.onchip.line_bytes, tr.page_bytes)
    l1 = classify_tlb(pages, tr.num_sets, tr.ways, "fifo", device=dev)
    tlb_plans = [row_plan(pages, tr.num_sets, tr.ways, "fifo"),
                 row_plan(pages[~l1], tr.l2_num_sets, tr.l2_ways, "fifo")]
    srrip_d2, tlb_d2 = d2_launches(srrip_plans), d2_launches(tlb_plans)
    e_cells = [(topo, aff, plc) for topo in ("private", "shared")
               for aff in ("symmetric", "per_core") for plc in ("interleave", "table_rank")]
    e_class, e_requests = {}, []
    for topo, aff, plc in e_cells:
        ms = memory_system_for(tpuv6e().with_policy(
            "lru", capacity_bytes=CLUSTER_CAPACITY, ways=16).with_cluster(n, topo).with_placement(
            aff, plc), dev)
        if topo not in e_class:
            e_class[topo] = ms.classify_for_pending(etrace)
        e_requests.append(ms.pending_from(etrace, e_class[topo]).request)
    sweep_d1 = len(dispatch_groups(e_requests))
    expect = {"A lru/pallas": {"cache_scan": buckets},
              "A lru/stack_pallas": {"stack_distance": buckets},
              "A srrip/stack": {"rrip_scan": srrip_d2},
              "D lru/stack + FIFO TLB": {"rrip_scan": tlb_d2}}
    print(f"[9] expected launches from the host ({len(shard_vecs)} non-empty shards, lane "
          f"geometry {lane.num_sets} sets x {lane.ways} ways): K1/K2 {buckets} (shape buckets "
          f"summed over the shards), D2 srrip {srrip_d2}, D2 for the MMU's FIFO L1 + L2 over "
          f"the merged miss stream ({pages.size} translations) {tlb_d2}, D1 1 per run and "
          f"{sweep_d1} in the sweep E (dispatch groups of its {len(e_requests)} requests)",
          flush=True)

    # D2 at the shapes this path gives it, against its plain versions: each
    # core's srrip row table (A) and the MMU's FIFO L1 and L2 (D). These
    # launches are made before any run's counts are reset.
    for label, policy, plans in (("A's srrip shard", "srrip", srrip_plans),
                                 ("D's FIFO TLB level", "fifo", tlb_plans)):
        checked = []
        for i, (tags_h, valid_h, groups) in enumerate(plans):
            (_, table), = groups
            *_, err, p_ms, reruns = d2_against_plain(f"rrip_scan on {label} {i}", policy,
                                                     tags_h, valid_h, table, dev)
            checked.append(f"{table.rows} rows x {table.ways} ways, "
                           f"{'chunked' if table.chunked else 'short'}, re-runs {reruns}, "
                           f"plain {p_ms:.2f} ms")
        print(f"[9] rrip_scan bitwise equal to its plain version on {label}s "
              f"({'; '.join(checked)})", flush=True)

    results, launches = {}, {}
    for name, hw_run in runs.items():
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        with profiling.collect() as prof:
            res = simulate(wl, hw_run, device=dev)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
        want = {"dram_scan": 1, **expect.get(name, {})}
        if counts != {k: want.get(k, 0) for k in counts}:
            fail(f"cluster {name}: launches {counts}; expected {want} and no other kernel")
        summ = res.summary()
        if (res.num_cores, len(res.batches)) != (n, wl.num_batches) or not res.total_cycles > 0 \
                or not all(math.isfinite(v) for v in summ.values() if isinstance(v, float)):
            fail(f"cluster {name}: malformed result {summ}")
        if name in REF_CLUSTER and (res.total_cycles, res.offchip_reads) != REF_CLUSTER[name]:
            fail(f"cluster {name}: total_cycles {res.total_cycles!r}, offchip_reads "
                 f"{res.offchip_reads}; the reference's {REF_CLUSTER[name]}")
        results[name], launches[name] = dataclasses.asdict(res), counts
        stages = {k: round(v, 4) for k, v in prof.breakdown(wall).items()}
        acc = res.cache_hits + res.cache_misses
        print(f"[9] {name} ({n} cores, {hw_run.topology.value}, {hw_run.lookup_sharding.value}, "
              f"{hw_run.onchip.capacity_bytes >> 20} MiB "
              f"{'shared' if hw_run.topology.value == 'shared' else 'a core'}, "
              f"{hw_run.channel_affinity}/"
              f"{hw_run.placement}) on {dev} ({smi('name,power.limit')}): wall {wall!r} s, "
              f"total_cycles {res.total_cycles!r}, offchip_reads {res.offchip_reads}, hit rate "
              f"{res.cache_hits / max(acc, 1)!r}, launches {counts}, stages "
              f"{json.dumps(stages)}", flush=True)
    lru = [results[k] for k in ("A lru/stack", "A lru/pallas", "A lru/stack_pallas")]
    if any(r != lru[0] for r in lru[1:]):
        fail("cluster A: lru under stack, pallas (K1) and stack_pallas (K2) differ")
    single = {k: sum(b[k] for b in single_lru["batches"])
              for k in ("cache_hits", "cache_misses", "offchip_reads")}
    shared = {k: sum(b[k] for b in results["B lru/stack"]["batches"]) for k in single}
    if shared != single:
        fail(f"cluster B: a shared LLC's counts {shared} differ from one core's {single}")
    print(f"[9] A's three lru backends bitwise equal; B's counts equal phase 4's single-core "
          f"lru/stack ({single}); A, B, C and D equal the reference's totals {REF_CLUSTER}",
          flush=True)

    # The per-core detail of C: each core's DRAM finish under contention,
    # the slowest bounding the batch.
    stats = memory_system_for(runs["C per_core/table_rank"], dev).simulate_embedding(etrace)
    for b, st in enumerate(stats):
        fins = [pc.dram_finish_cycles for pc in st.per_core]
        if len(fins) != n or not all(f > 0 for f in fins) or st.dram_cycles != max(fins):
            fail(f"cluster C batch {b}: per-core DRAM finish {fins}, batch {st.dram_cycles!r}")
    print(f"[9] C per_core/table_rank per-core DRAM finish by batch: "
          f"{[[pc.dram_finish_cycles for pc in st.per_core] for st in stats]}; lookups "
          f"{[[pc.lookups for pc in st.per_core] for st in stats]}", flush=True)

    # E: the sweep over topology x affinity x placement at A's shape.
    axes = dict(policies=("lru",), capacities=(CLUSTER_CAPACITY,), ways=(16,), num_cores=(n,),
                topologies=("private", "shared"), channel_affinities=("symmetric", "per_core"),
                placements=("interleave", "table_rank"), zipf_s=0.8, seed=0)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with profiling.collect() as prof:
        sw = sweep(wl, tpuv6e(), device=dev, **axes)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    class_keys = {e.memo_key[:-3] for e in sw.entries}
    if (sw.num_configs, len(class_keys)) != (8, 2):
        fail(f"cluster sweep: {sw.num_configs} configurations, {len(class_keys)} class keys")
    if counts != {k: sweep_d1 if k == "dram_scan" else 0 for k in counts}:
        fail(f"cluster sweep: launches {counts}; expected {sweep_d1} of dram_scan and no other")
    base = next(e for e in sw.entries if (e.config.topology, e.config.channel_affinity,
                                          e.config.placement) == ("private", "symmetric",
                                                                  "interleave"))
    if dataclasses.asdict(base.result) != results["A lru/stack"]:
        fail(f"cluster sweep: entry {base.config.label} differs from A's lru/stack run")
    launches["E sweep"] = counts
    stages = {k: round(v, 4) for k, v in prof.breakdown(wall).items()}
    print(f"[9] E: sweep of {sw.num_configs} cluster configurations ({sw.distinct_memo_keys} memo "
          f"keys, {len(class_keys)} classification keys) on {dev} ({smi('name,power.limit')}): "
          f"wall {wall!r} s, {wall / sw.num_configs!r} s per configuration; launches {counts}; "
          f"entry {base.config.label} bitwise equal to A's lru/stack; embedding cycles by "
          f"(topology, affinity, placement) "
          f"{ {(e.config.topology, e.config.channel_affinity, e.config.placement): e.result.embedding_cycles for e in sw.entries} }; "
          f"stages {json.dumps(stages)}", flush=True)

    # Small clusters on the card against the same runs on the CPU.
    small_wl = dlrm_rmc2_small(num_tables=2, rows_per_table=300, batch_size=2, num_batches=2)
    for hw_small in (
            tpuv6e().with_policy("lru", capacity_bytes=1 << 14).with_cache_backend("pallas")
            .with_cluster(2, "private", "table_hash").with_placement("per_core", "table_rank"),
            tpuv6e().with_policy("srrip", capacity_bytes=1 << 14).with_cluster(2, "shared"),
            tpuv6e().with_policy("fifo", capacity_bytes=1 << 14).with_cache_backend(
                "stack_pallas").with_cluster(2, "private", "batch").with_placement(
                "per_table", "hot_replicate").with_translation(
                replacement="fifo", entries=16, ways=4, l2_entries=64)):
        on_card = dataclasses.asdict(simulate(small_wl, hw_small, device=dev))
        if on_card != dataclasses.asdict(simulate(small_wl, hw_small, device="cpu")):
            fail(f"small cluster {hw_small.onchip.policy.value}/{hw_small.topology.value}: the "
                 f"card differs from the CPU")
    print("[9] small clusters on the card equal the same runs on the CPU (lru/pallas per_core/"
          "table_rank, srrip shared, fifo/stack_pallas per_table/hot_replicate + FIFO TLB)",
          flush=True)

    # The card's busy share in a profiled run of A.
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tprof:
        t0 = time.perf_counter()
        simulate(wl, runs["A lru/stack"], device=dev)
        torch.cuda.synchronize()
        p_wall = time.perf_counter() - t0
    print(f"[9] profiled A lru/stack: wall {p_wall!r} s, "
          f"{device_busy(tprof.events(), p_wall, ('dram_scan',))}", flush=True)
    return launches


def serving_phase(dev, K, wl, etrace):
    """Phase 10: the request-level serving simulator on the card at full
    width (the phase-4 workload's embedding op, ``SERVING``'s scenarios),
    with its checks; then the device-side helpers on phase 4's trace
    ``etrace``. Returns the launches of each run, by run name."""
    import shutil
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import (EmbeddingOpSpec, SweepCheckpoint, TrafficConfig, Workload,
                                  profiling, sweep, tpuv6e)
    from repro_torch.core.memory.policies import PolicyContext, get_policy
    from repro_torch.core.memory.system import EmbeddingTrace, memory_system_for
    from repro_torch.core.requests import generate_requests, lower_batch
    from repro_torch.core.trace import (ConcatTrace, FullTrace, shard_lookup_cores,
                                        shard_lookup_cores_device, translate, translate_device)
    from repro_torch.serving import (ReplayOracle, RobustnessPolicy, ServingScenario,
                                     simulate_serving)

    spec = wl.embedding_ops[0]
    name_power = smi("name,power.limit")

    def scenario(name, num_requests=None):
        d = SERVING[name]
        traffic = dict(d["traffic"], **({"num_requests": num_requests} if num_requests else {}))
        return ServingScenario(name=name, traffic=TrafficConfig(**traffic),
                               policy=RobustnessPolicy(**d["policy"]),
                               batch_slots=d["batch_slots"])

    class Counting:
        """A memory system that counts its ``simulate_embedding`` calls."""

        def __init__(self, ms):
            self.ms, self.hw, self.calls = ms, ms.hw, 0

        def simulate_embedding(self, etrace):
            self.calls += 1
            return self.ms.simulate_embedding(etrace)

    class Recording(ReplayOracle):
        """A replay that keeps each served batch's lowered trace."""

        def __init__(self, stats):
            super().__init__(stats)
            self.traces = []

        def service(self, full):
            self.traces.append(full)
            return super().service(full)

    def plain_stats(hw, traces):
        """One plain fixed-trace ``simulate_embedding`` over the batches."""
        return memory_system_for(hw, dev).simulate_embedding(
            EmbeddingTrace.from_concat(spec, ConcatTrace.from_traces(traces)))

    def stats_dicts(stats):
        return [dataclasses.asdict(st) for st in stats]

    streams, results, launches, walls = {}, {}, {}, {}
    hws = {"lru/stack": tpuv6e().with_policy("lru"),
           "lru/pallas": tpuv6e().with_policy("lru").with_cache_backend("pallas"),
           "lru/stack_pallas": tpuv6e().with_policy("lru").with_cache_backend("stack_pallas"),
           "srrip/stack": tpuv6e().with_policy("srrip")}
    runs = [("steady_off", b) for b in ("lru/stack", "lru/pallas", "lru/stack_pallas",
                                        "srrip/stack")]
    runs += [("overload_storm", "lru/pallas"), ("overload_storm", "srrip/stack"),
             ("deadline_retry", "lru/pallas")]
    run_kernel = {"lru/pallas": "cache_scan", "lru/stack_pallas": "stack_distance",
                  "srrip/stack": "rrip_scan"}
    # Each scenario's stream, generated once (host numpy) and timed apart, so
    # each run's wall is its scheduling and pricing alone.
    for sname in SERVING:
        t0 = time.perf_counter()
        streams[sname] = generate_requests(spec, scenario(sname).traffic)
        print(f"[10] {sname}: {len(streams[sname])} requests of "
              f"{streams[sname][0].num_lookups} lookups generated in "
              f"{time.perf_counter() - t0!r} s", flush=True)
    for sname, backend in runs:
        sc, hw = scenario(sname), hws[backend]
        ms = Counting(memory_system_for(hw, dev))
        log = []
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        with profiling.collect() as prof:
            res = simulate_serving(ms, spec, sc, requests=streams[sname], event_log=log)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
        run = f"{sname} {backend}"
        want_calls = 1 if sc.policy.all_off else res.num_batches
        if ms.calls != want_calls or counts["dram_scan"] != ms.calls:
            fail(f"serving {run}: {ms.calls} simulate_embedding calls (expected {want_calls}), "
                 f"D1 launched {counts['dram_scan']} times (expected one a call)")
        scan = run_kernel.get(backend)
        if scan and counts[scan] == 0:
            fail(f"serving {run}: {scan} was not launched ({counts})")
        others = {k: c for k, c in counts.items() if c and k not in ("dram_scan", scan)}
        if others:
            fail(f"serving {run}: kernels off its path launched: {others}")
        pins = serving_pins(res)
        ref = REF_SERVING[(sname, backend.split("/")[0])]
        if pins != ref:
            fail(f"serving {run}: {pins} differs from the reference's {ref}")
        if any(b < a for a, b in zip(log, log[1:])):
            fail(f"serving {run}: the event clock went backwards")
        if not (res.latency_cycles.size == res.completed and np.all(res.latency_cycles > 0)
                and math.isfinite(res.p99_cycles) and res.makespan_cycles > 0):
            fail(f"serving {run}: malformed result {res.summary()}")
        # Replay through the recorded stats composes the same batches, and
        # one plain simulate_embedding over the batches gives the same stats:
        # the arrival-order chunks when every policy is off (the identity),
        # else the batches the replay composed (the prefix re-pricing).
        rec = Recording(res.batch_stats)
        replayed = simulate_serving(ms, spec, sc, requests=streams[sname], oracle=rec)
        if replayed.diff(res) != {}:
            fail(f"serving {run}: the replay differs: {replayed.diff(res)}")
        batches = rec.traces
        if sc.policy.all_off:
            reqs, B = streams[sname], sc.batch_slots
            batches = [lower_batch(reqs[i:i + B], spec).full for i in range(0, len(reqs), B)]
        if stats_dicts(plain_stats(hw, batches)) != stats_dicts(res.batch_stats):
            fail(f"serving {run}: batch_stats differ from the plain simulate_embedding over "
                 f"the same lowered batches")
        results[run], launches[run], walls[run] = res, counts, wall
        us = res.cycles_to_us
        stages = {k: round(v, 4) for k, v in prof.breakdown(wall).items()}
        print(f"[10] {run} on {dev} ({name_power}): wall {wall!r} s, {ms.calls} "
              f"simulate_embedding call(s); launches D1 {counts['dram_scan']}, K1 "
              f"{counts['cache_scan']}, K2 {counts['stack_distance']}, D2 {counts['rrip_scan']}; "
              f"{res.offered} offered, {res.completed} completed, {res.shed} shed, "
              f"{res.timed_out} timed out, {res.retries} retries, {res.abandoned} abandoned, "
              f"{res.degraded_batches} degraded batches ({res.dropped_cold_rows} cold rows "
              f"dropped), {res.num_batches} batches; simulated TPUv6e latency p50/p95/p99 "
              f"{us(res.p50_cycles)!r} / {us(res.p95_cycles)!r} / {us(res.p99_cycles)!r} us, "
              f"goodput {res.goodput!r}, sustained {res.sustained_qps!r} req/s (simulated); "
              f"{len(log)} clock events, never backwards; equal to the reference's pins, the "
              f"replay and the plain simulate_embedding; stages {json.dumps(stages)}",
              flush=True)
    steady = [results[f"steady_off {b}"] for b in ("lru/stack", "lru/pallas", "lru/stack_pallas")]
    if any(r.diff(steady[0]) != {} for r in steady[1:]):
        fail("serving steady_off: lru under stack, pallas (K1) and stack_pallas (K2) differ")
    # A rerun of the closed loop from a fresh memory system, under
    # torch.profiler for the card's busy share.
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tprof:
        t0 = time.perf_counter()
        again = simulate_serving(memory_system_for(hws["lru/pallas"], dev), spec,
                                 scenario("overload_storm"), requests=streams["overload_storm"])
        torch.cuda.synchronize()
        p_wall = time.perf_counter() - t0
    if again.diff(results["overload_storm lru/pallas"]) != {}:
        fail("serving overload_storm: a rerun from a fresh memory system differs")
    print(f"[10] steady_off lru bitwise equal under stack, pallas (K1) and stack_pallas (K2); "
          f"overload_storm lru/pallas rerun from a fresh memory system bitwise equal, profiled: "
          f"wall {p_wall!r} s, {device_busy(tprof.events(), p_wall, ('dram_scan', 'cache_scan'))}"
          f"; wall of the closed loop (overload_storm lru/pallas, "
          f"{results['overload_storm lru/pallas'].num_batches} prefixes re-priced) "
          f"{walls['overload_storm lru/pallas']!r} s against the all-off path's (steady_off "
          f"lru/pallas, the stream priced once) {walls['steady_off lru/pallas']!r} s", flush=True)

    # A serving sweep: its entries against direct simulate_serving calls,
    # two shards on the one card, and a checkpointed run killed after its
    # first round and resumed.
    swl = Workload(name=wl.name, embedding_ops=(spec,))
    scs = [scenario(n, SWEEP_SERVING_REQUESTS) for n in ("steady_off", "overload_storm")]
    axes = dict(policies=SWEEP_SERVING_POLICIES, capacities=(128 << 20,), ways=(16,),
                scenarios=scs)

    def recs(sr):
        return [(e.config, e.result.summary(), stats_dicts(e.result.batch_stats),
                 e.result.latency_cycles.tolist()) for e in sr.entries]

    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    sw = sweep(swl, tpuv6e(), device=dev, **axes)
    torch.cuda.synchronize()
    sw_wall = time.perf_counter() - t0
    sw_counts = K.launch_counts()
    want = recs(sw)
    for e in sw.entries:
        sc_e = next(x for x in scs if x.name == e.config.scenario)
        direct = simulate_serving(memory_system_for(tpuv6e().with_policy(e.config.policy), dev),
                                  spec, sc_e)
        if direct.diff(e.result) != {}:
            fail(f"serving sweep entry {e.config.label} differs from simulate_serving")
    t0 = time.perf_counter()
    sharded = sweep(swl, tpuv6e(), device=dev, devices=2, **axes)
    torch.cuda.synchronize()
    sh_wall = time.perf_counter() - t0
    if not sharded.sharded or recs(sharded) != want:
        fail("serving sweep: devices=2 differs from the unsharded sweep")
    ckdir = ROOT / "build" / "serving_smoke"
    shutil.rmtree(ckdir, ignore_errors=True)
    path = str(ckdir / "serving.ckpt")

    class KillAfterFirstRound(SweepCheckpoint):
        def record(self, slice_id, res):
            super().record(slice_id, res)
            raise KeyboardInterrupt("killed after the first round")

    ck = KillAfterFirstRound(path, cadence=2)
    try:
        sweep(swl, tpuv6e(), device=dev, checkpoint=ck, **axes)
        fail("serving sweep: the checkpointed run was not killed")
    except KeyboardInterrupt:
        pass
    ck.close()
    resumed = sweep(swl, tpuv6e(), device=dev, checkpoint=path, **axes)
    shutil.rmtree(ckdir, ignore_errors=True)
    if recs(resumed) != want or resumed.resumed_keys != 2 or resumed.distinct_memo_keys != 4:
        fail(f"serving sweep: the resumed run differs ({resumed.resumed_keys} keys restored)")
    print(f"[10] serving sweep {SWEEP_SERVING_POLICIES} x steady_off/overload_storm cut to "
          f"{SWEEP_SERVING_REQUESTS} requests ({sw.num_configs} entries, {sw.distinct_memo_keys} "
          f"memo keys) on {dev}: wall {sw_wall!r} s, launches {sw_counts}; each entry bitwise "
          f"equal to simulate_serving; devices=2 bitwise equal ({sh_wall!r} s); killed after its "
          f"first round of 2 keys and resumed, 2 restored, bitwise equal", flush=True)
    launches["sweep"] = sw_counts

    # A small case: every scenario of the JAX tests' spec on the card against
    # the CPU, degraded batches with no lookup or one among them.
    sspec = EmbeddingOpSpec(**SMALL_SERVING_SPEC)
    small = [ServingScenario(name="steady", traffic=TrafficConfig(
                 pattern="poisson", mean_gap_cycles=700.0, num_requests=48, seed=11)),
             ServingScenario(name="storm", traffic=TrafficConfig(
                 pattern="bursty", mean_gap_cycles=40.0, num_requests=80, seed=23, burst_len=10),
                 policy=RobustnessPolicy(admission_watermark=12, deadline_cycles=25_000,
                                         max_retries=2, retry_backoff_cycles=2_000.0))]
    for mode, seed in (("hot_rows_only", 0), ("cache_bypass", 1)):
        small.append(ServingScenario(name=f"edge_{mode}", traffic=TrafficConfig(
            pattern="poisson", mean_gap_cycles=700.0, num_requests=12, seed=seed,
            tables_per_request=1, lookups_per_table=1), policy=RobustnessPolicy(
            degrade_mode=mode, degrade_watermark=0, hot_fraction=0.001, bypass_keep_tables=0.25),
            batch_slots=1))
    n_small = 0
    for policy, backend in (("lru", "pallas"), ("lru", "stack_pallas"), ("srrip", "stack"),
                            ("fifo", "stack"), ("spm", "stack"), ("pinning", "stack")):
        hw_s = tpuv6e().with_policy(policy).with_cache_backend(backend)
        for sc_s in small:
            on_card = simulate_serving(memory_system_for(hw_s, dev), sspec, sc_s)
            on_cpu = simulate_serving(memory_system_for(hw_s, "cpu"), sspec, sc_s)
            if on_card.diff(on_cpu) != {}:
                fail(f"small serving {sc_s.name} {policy}/{backend}: the card differs from the "
                     f"CPU: {on_card.diff(on_cpu)}")
            n_small += 1
    print(f"[10] small serving runs ({SMALL_SERVING_SPEC}): {n_small} scenario x backend pairs "
          f"on the card bitwise equal to the CPU, batches with no lookup and with one among "
          f"them", flush=True)

    # The device-side helpers on phase 4's concatenated trace.
    concat = etrace.concat
    for mode in ("batch", "table_hash"):
        for cores in (2, 4, 8):
            got = shard_lookup_cores_device(concat, cores, mode, device=dev)
            if got.device.type != "cuda" or not np.array_equal(
                    got.cpu().numpy(), shard_lookup_cores(concat, cores, mode)):
                fail(f"shard_lookup_cores_device {mode} x {cores} differs from the host's")
    lines = etrace.address_trace(tpuv6e().onchip.line_bytes).lines
    lines_d = torch.from_numpy(lines).to(dev)
    for pname in ("spm", "pinning"):
        pol = get_policy(pname)
        ctx = pol.prepare(lines, PolicyContext.from_hardware(tpuv6e(), device=dev))
        got = pol.classify_device(lines_d, ctx)
        if got.device.type != "cuda" or not np.array_equal(got.cpu().numpy(),
                                                           pol.classify(lines, ctx)):
            fail(f"classify_device {pname} differs from the host's classify")
    try:
        translate_device(torch.from_numpy(concat.table_ids).to(dev),
                         torch.from_numpy(concat.row_ids).to(dev), spec, 64)
        fail(f"translate_device took the {spec.num_tables * spec.table_bytes}-byte spec")
    except ValueError:
        pass
    # The widest spec under 2**31 bytes at these widths: 60 tables of 69,904
    # rows of 512 bytes.
    wide = EmbeddingOpSpec(num_tables=spec.num_tables,
                           rows_per_table=(2**31 - 1) // (spec.num_tables * spec.vector_bytes),
                           dim=spec.dim, lookups_per_sample=spec.lookups_per_sample,
                           dtype_bytes=spec.dtype_bytes)
    rows = concat.row_ids % wide.rows_per_table
    full = FullTrace(concat.table_ids, rows, sum(concat.batch_sizes), wide.num_tables,
                     wide.lookups_per_sample)
    got = translate_device(torch.from_numpy(concat.table_ids).to(dev),
                           torch.from_numpy(rows).to(dev), wide, 64)
    if not np.array_equal(got.cpu().numpy(), translate(full, wide, 64).lines):
        fail("translate_device differs from translate on the widest spec under 2**31 bytes")
    print(f"[10] device helpers on phase 4's trace ({len(concat)} lookups, {lines.size} lines): "
          f"shard_lookup_cores_device (batch, table_hash x 2/4/8 cores) and classify_device "
          f"(spm, pinning) equal the host versions; translate_device raises for the "
          f"{spec.num_tables * spec.table_bytes}-byte spec and equals translate on "
          f"{wide.num_tables} x {wide.rows_per_table} rows "
          f"({wide.num_tables * wide.table_bytes} bytes)", flush=True)
    return launches


def d3_chain(bk_m: np.ndarray, va_m: np.ndarray) -> int:
    """Dependent f32 operations on D3's longest row: two an access (the max
    with the bus-free cycle and the bus add), one more where it follows a
    valid access to its own bank. There the bank-free and bus-free cycles
    are both the step before's ``done``, so ``max(a, done) + occ`` is at
    least ``done`` and the max with the bus-free cycle is exact: the chain
    is the max with the arrival, the activation add and the bus add."""
    same = np.zeros_like(va_m)
    for r in range(bk_m.shape[0]):
        b = bk_m[r][va_m[r]]
        same[r, :b.size] = np.concatenate(([False], b[1:] == b[:-1]))
    return int((2 * va_m.sum(axis=1) + same.sum(axis=1)).max())


def d3_host_split(lines, dm, interval, start, dev) -> dict:
    """``simulate_dram``'s arrival route stage by stage, host clock in ms:
    the address decomposition, the FR-FCFS order, ``arrival_rows`` whole
    (both of those and the padded rows), the copies to the card, D3 (the
    pre-pass and the scan), and the row sums and reductions copied back."""
    from repro_torch.core.memory.dram import _frfcfs_order, arrival_rows, xla_row_sum
    from repro_torch.kernels.dram_scan import dram_scan_full

    out = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) * 1e3
        return r
    ch, bk, _ = timed("decompose", lambda: dm.decompose(lines))
    timed("FR-FCFS order", lambda: _frfcfs_order(ch, bk, lines // dm.lines_per_block,
                                                   dm.banks_per_channel, dm.channels))
    st = timed("arrival_rows (decompose, order, rows)",
               lambda: arrival_rows(lines, dm, interval, start))
    args = timed("copies to the card", lambda: [torch.from_numpy(st[k]).to(dev)
                                                for k in ("bk_m", "row_m", "ar_m", "va_m")])
    done, lat, hits = timed("D3 (pre-pass + scan)", lambda: dram_scan_full(
        *args, dm.banks_per_channel, float(dm.t_cas), float(dm.t_rp + dm.t_rcd),
        float(dm.line_bytes / dm.chan_bytes_per_cycle)))
    timed("row sums, max, hit count, copies back",
          lambda: (xla_row_sum(lat).cpu().numpy(), float(done.max()), int(hits.sum())))
    # decompose and the order are inside arrival_rows: count them once
    out["arrival_rows (decompose, order, rows)"] -= out["decompose"] + out["FR-FCFS order"]
    out["arrival_rows: the padded rows"] = out.pop("arrival_rows (decompose, order, rows)")
    return out


def distributed_phase(dev, K, name_power, hw, etrace, f32_op_ms):
    """Phase 13: (a) D3 against its plain version, small and at full width,
    then ``simulate_dram`` with arrivals over phase 4's lru/stack miss trace
    against the JAX package's ``REF_D3``; (b) the collective matmul on a
    one-rank NCCL group at stablelm-3b's MLP down projection; (c) the smoke
    stablelm-3b train state saved and restored with ``shardings=`` onto a
    (1, 1) mesh of the card. Returns the report entries of D3 and its
    pre-pass."""
    import tempfile
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch import tree as T
    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
    from repro_torch.core.memory.dram import DramModel, arrival_rows, simulate_dram
    from repro_torch.core.memory.system import MemorySystem
    from repro_torch.distributed import param_specs, tree_shardings
    from repro_torch.distributed.collective_matmul import psum_matmul, ring_matmul
    from repro_torch.kernels.dram_scan import (
        REG_MAX_BANKS, _f32, _regs_launcher, dram_prepass, dram_prepass_plain, dram_scan_full,
        dram_scan_full_plain)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import get_smoke_config
    from repro_torch.training import TrainConfig, init_state

    print(f"[13] {name_power}", flush=True)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)     # > the 50 MB L2
    # (a) D3, small: every (rows, slots) x arrival form x route, bitwise
    rng = np.random.default_rng(13)
    for banks in D3_SMALL_BANKS:
        for R in D3_SMALL_ROWS:
            for L in D3_SMALL_L:
                for interval, start in D3_SMALL_ARRIVALS:
                    valid = rng.random((R, L)) < 0.85
                    valid[:, L - L // 4:] = False
                    bk = np.repeat(rng.integers(0, banks, size=(R, L // 8 + 1)), 8, axis=1)[:, :L]
                    args = [torch.from_numpy(a).to(dev) for a in (
                        bk.astype(np.int32), rng.integers(0, 3, size=(R, L)).astype(np.int32),
                        (start + np.arange(R * L, dtype=np.float32).reshape(R, L) * interval
                         ).astype(np.float32), valid)]
                    got = dram_scan_full(*args, banks, 22.0, 44.0, 0.6016)
                    want = dram_scan_full_plain(*args, banks, 22.0, 44.0, 0.6016)
                    if not all(bitwise_equal(a, b) for a, b in zip(got, want)):
                        fail(f"dram_scan_full differs from its plain version at (R, L)={(R, L)}, "
                             f"{banks} banks, interval {interval}, start {start}")
                    if banks <= REG_MAX_BANKS and not all(bitwise_equal(a, b) for a, b in zip(
                            dram_prepass(args[0], args[1], args[3], banks),
                            dram_prepass_plain(args[0], args[1], args[3], banks))):
                        fail(f"dram_prepass differs from its plain version at (R, L)={(R, L)}")
    print(f"[13] dram_scan_full: bitwise equal to plain at rows {D3_SMALL_ROWS} x L "
          f"{D3_SMALL_L}, banks {D3_SMALL_BANKS} (the registers route, its pre-pass's codes "
          f"and hits bitwise too, and the shared route), (interval, start) "
          f"{D3_SMALL_ARRIVALS}", flush=True)

    # (a) D3 at full width: the main path, then its kernel apart
    t0 = time.perf_counter()
    lines = MemorySystem.from_hardware(hw.with_policy("lru"), "cuda").prepare_embedding(
        etrace).request.lines
    dm = DramModel.from_hardware(hw)
    print(f"[13] lru/stack miss trace: {lines.size} lines in {time.perf_counter() - t0:.3f} s",
          flush=True)
    launches = {}
    for interval, start in D3_ARRIVALS:
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        res = simulate_dram(lines, dm, issue_interval_cycles=interval, start_cycle=start)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
        launches[(interval, start)] = counts
        if (counts != {k: int(k in ("dram_scan_full", "dram_prepass")) for k in counts}
                or dram_scan_full.routes != {"registers": 1, "shared": 0}):
            fail(f"simulate_dram({interval}, {start}): launches {counts}, D3's routes "
                 f"{dram_scan_full.routes}; expected one of D3's registers route and one of "
                 f"its pre-pass")
        got = (res.finish_cycle, res.total_latency_cycles, res.row_hits, res.row_misses,
               res.accesses)
        if got != REF_D3[(interval, start)]:
            fail(f"simulate_dram({interval}, {start}) gave {got}; the reference "
                 f"{REF_D3[(interval, start)]}")
        print(f"[13] simulate_dram(interval {interval}, start {start}): "
              f"{dataclasses.asdict(res)} equal to REF_D3; wall {wall!r} s; launches "
              f"{counts['dram_scan_full']} of D3 (registers route), {counts['dram_prepass']} of "
              f"its pre-pass", flush=True)
        split = d3_host_split(lines, dm, interval, start, dev)
        print(f"[13] simulate_dram({interval}, {start}) stage by stage (host clock, ms): "
              f"{json.dumps(split)}; {sum(split.values())!r} ms in all", flush=True)
    st = arrival_rows(lines, dm, *D3_ARRIVALS[0])
    args = [torch.from_numpy(st[k]).to(dev) for k in ("bk_m", "row_m", "ar_m", "va_m")]
    scal = (dm.banks_per_channel, float(dm.t_cas), float(dm.t_rp + dm.t_rcd),
            float(dm.line_bytes / dm.chan_bytes_per_cycle))
    got = dram_scan_full(*args, *scal)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    want = dram_scan_full_plain(*args, *scal)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t1) * 1e3
    if not all(bitwise_equal(a, b) for a, b in zip(got, want)):
        fail("dram_scan_full differs bitwise from its plain version at full width")
    err = max(max_abs_err(a, b) for a, b in zip(got, want))
    bk, row, ar, va = args
    code, hit = dram_prepass(bk, row, va, scal[0])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pcode, phit = dram_prepass_plain(bk, row, va, scal[0])
    torch.cuda.synchronize()
    pre_plain_ms = (time.perf_counter() - t1) * 1e3
    if not (bitwise_equal(code, pcode) and bitwise_equal(hit, phit)):
        fail("dram_prepass differs bitwise from its plain version at full width")
    R, L = bk.shape
    done, lat = torch.empty_like(ar), torch.empty_like(ar)
    regs = _regs_launcher()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def scan_alone():
        e = regs(code.data_ptr(), ar.data_ptr(), R, L, *(_f32(x) for x in scal[1:]),
                 done.data_ptr(), lat.data_ptr(), stream)
        if e:
            fail(f"dram_scan_regs launch failed with CUDA error {e}")
    scan_alone()
    torch.cuda.synchronize()
    if not (bitwise_equal(done, want[0]) and bitwise_equal(lat, want[1])):
        fail("D3's scan alone differs bitwise from the plain version at full width")
    k_ms = time_ms(scan_alone, 10)
    cold_ms = time_cold_ms(scan_alone, 10, flush)
    pre_ms = time_ms(lambda: dram_prepass(bk, row, va, scal[0]), 10)
    pre_cold = time_cold_ms(lambda: dram_prepass(bk, row, va, scal[0]), 10, flush)
    both_ms = time_ms(lambda: dram_scan_full(*args, *scal), 10)
    chain = d3_chain(st["bk_m"], st["va_m"])
    n_valid = int(st["va_m"].sum())
    print(f"[13] dram_scan_full, registers route: bitwise equal to plain at (R, L)={(R, L)} "
          f"(longest channel {L} accesses, {n_valid} in all); the scan {k_ms!r} ms ({cold_ms!r} "
          f"L2 flushed), {k_ms * 1e6 / L!r} ns per access, {chain * f32_op_ms / k_ms!r} of its "
          f"chain bound {chain * f32_op_ms!r} ms ({chain} dependent f32 ops x "
          f"{f32_op_ms * 1e6:.4f} ns); the pre-pass apart {pre_ms!r} ms ({pre_cold!r} L2 "
          f"flushed), codes and hits bitwise its plain version's ({pre_plain_ms:.1f} ms); the "
          f"wrapper, both launches, {both_ms!r} ms; plain {plain_ms:.1f} ms", flush=True)
    entry = dict(kind="dram_scan_full", err=err, ms=k_ms, plain_ms=plain_ms,
                 nbytes=R * L * (4 + 4 + 4 + 1) + R * L * (4 + 4 + 1),
                 ops=8 * n_valid, lat_ms=chain * f32_op_ms, shapes=[(R, L)],
                 launches=launches[D3_ARRIVALS[0]]["dram_scan_full"],
                 library_none="no one PyTorch call computes it")
    # The pre-pass: bank, row, valid in, codes and hits out; a warp's walk of
    # its segment carries the bank's last update from one chunk of 32 to the
    # next (a shared store and load).
    seg = -(-L // (32 * 128)) * 128
    pre_entry = dict(kind="dram_prepass", err=0.0, ms=pre_ms, plain_ms=pre_plain_ms,
                     nbytes=R * L * (4 + 4 + 1) + R * L * (4 + 1), ops=24 * R * L,
                     lat_ms=2 * (seg // 32) * f32_op_ms, shapes=[(R, L)],
                     launches=launches[D3_ARRIVALS[0]]["dram_prepass"],
                     library_none="no one PyTorch call computes it")
    del flush, args, got, want, code, hit, pcode, phit, done, lat

    # (b) the collective matmul on a one-rank NCCL group
    store_dir = tempfile.TemporaryDirectory()
    store = dist.FileStore(str(Path(store_dir.name) / "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        M, Kd, N = CMM_SHAPE
        gen = torch.Generator(device=dev).manual_seed(13)
        for dtype, tol in CMM_TOL.items():
            x = torch.randn(M, Kd, generator=gen, device=dev).to(dtype)
            w = (torch.randn(Kd, N, generator=gen, device=dev) / math.sqrt(Kd)).to(dtype)
            ref = x @ w
            times = {}
            for name, fn in (("ring_matmul", ring_matmul), ("psum_matmul", psum_matmul)):
                y = fn(x, w)
                diff = max_abs_err(y, ref)
                if tuple(y.shape) != (M, N) or not diff <= tol:
                    fail(f"{name} {dtype}: shape {tuple(y.shape)}, max abs diff {diff!r} > {tol}")
                times[name] = (time_ms(lambda fn=fn: fn(x, w), 10), diff)
            mm_ms = time_ms(lambda: x @ w, 10)
            # the ring's tail on its own: the all-gather of the reduced chunk
            # and the concatenation, what a one-rank ring adds to the product
            gathered = [torch.empty_like(ref)]

            def ring_tail():
                dist.all_gather(gathered, ref)
                return torch.cat(gathered, dim=-1)
            gather_ms = time_ms(ring_tail, 10)
            print(f"[13] {dtype} x {tuple(x.shape)} @ w {tuple(w.shape)} on a one-rank NCCL "
                  f"group: ring_matmul {times['ring_matmul'][0]!r} ms (max abs diff "
                  f"{times['ring_matmul'][1]!r}), psum_matmul {times['psum_matmul'][0]!r} ms "
                  f"({times['psum_matmul'][1]!r}), torch.matmul {mm_ms!r} ms, the ring's "
                  f"all-gather + concatenation alone {gather_ms!r} ms; tolerance {tol}",
                  flush=True)

        # (c) the smoke stablelm-3b train state restored onto a (1, 1) mesh
        cfg = get_smoke_config("stablelm_3b")
        state = init_state(0, cfg, TrainConfig(), device=dev)
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")
        with tempfile.TemporaryDirectory() as tmp:
            mgr = CheckpointManager(CheckpointConfig(directory=tmp, async_save=False))
            mgr.save(1, state)
            t0 = time.perf_counter()
            step, _, restored = mgr.restore(
                target_tree=state, shardings=tree_shardings(mesh, param_specs(state, mesh)))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        got, want = T.leaves(restored), T.leaves(state)
        for (name, a), b in zip(T.flatten_with_paths(restored), want):
            if not isinstance(a, DTensor) or a.device.type != "cuda" or a.device_mesh is not mesh:
                fail(f"restore(shardings=): {name} is {type(a).__name__} on {a.device}")
            if not bitwise_equal(a.to_local(), b):
                fail(f"restore(shardings=): {name} differs from what was saved")
        print(f"[13] smoke stablelm-3b state: {len(got)} leaves restored with shardings= onto "
              f"{mesh}, each a DTensor on the card, bitwise what was saved (step {step}, "
              f"{wall!r} s)", flush=True)
    finally:
        dist.destroy_process_group()
        store_dir.cleanup()
    return entry, pre_entry


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this script needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels as K
    from repro_torch.core import dlrm_rmc2_small, simulate, tpuv6e
    from repro_torch.core import profiling
    from repro_torch.core.engine import build_embedding_traces
    from repro_torch.core.memory.cache import bucket_rows
    from repro_torch.core.memory.dram import chunk_rows, simulate_dram_contended
    from repro_torch.core.memory.system import MemorySystem, lane_geometry, memory_system_for
    from repro_torch.kernels import _build
    from repro_torch.kernels.cache_scan import (
        blocks_per_sm as k1_blocks_per_sm, cache_scan_groups, cache_scan_plain, team_lanes)
    from repro_torch.kernels.dram_scan import (
        blocks_per_sm as d1_blocks_per_sm, dram_scan_chunked, dram_scan_plain)
    from repro_torch.kernels.stack_distance import (
        blocks_per_sm as k2_blocks_per_sm, stack_distance_groups, stack_distance_plain)
    from repro_torch.core.memory.rrip import row_plan
    from repro_torch.core.memory.tlb import classify_tlb, tlb_pages
    from repro_torch.kernels.rrip_scan import (
        PLAIN as RRIP_PLAIN, blocks_per_sm as rrip_blocks_per_sm, rrip_scan_chunked_plain,
        rrip_scan_flat, rrip_scan_rows, state_ints)
    from repro_torch.kernels import ops as emb_ops
    from repro_torch.kernels.embedding_bag import (
        embedding_bag_kernel, embedding_bag_plain, embedding_gather_kernel,
        embedding_gather_plain, vmem_gather_pool_kernel, vmem_gather_pool_plain, vmem_tile_rows)
    from repro_torch.convert import dlrm_params_from_jax
    from repro_torch.core.trace import REUSE_LEVELS
    from repro_torch.data import DLRMDataConfig, dlrm_batch
    from repro_torch.models import DLRM, DLRMConfig, smoke_config
    import torch.nn.functional as F

    if any(m == "jax" or m.startswith(("jax.", "repro.")) or m == "repro" for m in sys.modules):
        fail("the port imported JAX or the JAX package")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_script = time.perf_counter()

    # ---- 1. device and versions ------------------------------------------
    name_power = smi("name,power.limit")
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda}: "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; "
          f"{name_power}; max SM clock {clock_mhz} MHz", flush=True)

    # ---- 2. build (and phase 14's process beside it) ------------------------
    dry_proc = start_dryrun()
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    regs = []
    for name, path in libs.items():
        log = path.with_suffix(".log")
        used = [ln.split("Used")[1].strip() for ln in log.read_text().splitlines()
                if "Used" in ln] if log.exists() else []
        regs.append(f"{name}: {'; '.join(used) or 'cached'}")
    print(f"[2] built {sorted(p.name for p in libs.values())} in {build_s:.3f} s "
          f"({' | '.join(regs)})", flush=True)
    for lib, word in (("cache_scan", ""), ("stack_distance", ""), ("dram_scan", ""),
                      ("dram_scan_full", ""), ("rrip_scan", ""), ("flash_attention", ""), ("mamba2_ssd", ""),
                      ("embedding_bag", "")):
        log = libs[lib].with_suffix(".log")
        if log.exists():
            rep = [r for r in ptxas_report(log.read_text()) if word in r]
            print(f"[2] {lib}.cu, ptxas per kernel: {'; '.join(rep)}", flush=True)

    # ---- 3. latency probes, then kernels against their plain versions -----
    probe = _build.load_library("latency_probe")
    for fn in (probe.vote_chain_launch, probe.f32_chain_launch):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    # vote: tag = lane, x = 0; the first match walks lanes 0, 1, 3, 7, 15, 31
    # and x settles at 63. f32: x = max(x, 0) + 0.5, exact in f32 here.
    vote_in = torch.cat([torch.arange(32), torch.zeros(32)]).to(torch.int32).to(dev)
    f32_in = torch.cat([torch.zeros(32), torch.full((32,), 0.5), torch.zeros(32)]).to(dev)
    vote_step_ms = probe_step_ms(probe.vote_chain_launch, vote_in,
                                 torch.empty(32, dtype=torch.int32, device=dev), lambda n: 63)
    f32_op_ms = probe_step_ms(probe.f32_chain_launch, f32_in,
                              torch.empty(32, device=dev), lambda n: 0.5 * n) / 2
    print(f"[3] latency probes: compare-vote-ffs step {vote_step_ms * 1e6:.4f} ns, "
          f"dependent f32 op {f32_op_ms * 1e6:.4f} ns", flush=True)

    wl = dlrm_rmc2_small(num_batches=2)
    hw = tpuv6e()
    t0 = time.perf_counter()
    etrace = build_embedding_traces(wl)[0]
    print(f"[3] full-size trace: {len(etrace.concat)} lookups in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    lane = lane_geometry(hw, etrace.spec)
    buckets = [
        tuple(torch.from_numpy(a).to(dev) for a in (s_b, t_b, v_b)) + (S, W)
        for _, s_b, t_b, v_b, S, W in bucket_rows([etrace.vec_ids], [lane])
    ]
    print(f"[3] full-size buckets (B, L), sets, ways: "
          f"{[(tuple(b[0].shape), b[3], b[4]) for b in buckets]}", flush=True)
    # Sets (and rows) are independent state machines, so the longest chain
    # of dependent steps is the most valid accesses any one (row, set) sees.
    # (A design with one warp per row walks the row's whole valid length in
    # sequence; printed for comparison.)
    bucket_chains, row_chain = [], 0
    for s_d, _, v_d, S, _ in buckets:
        rows = torch.arange(s_d.shape[0], device=dev)[:, None] * S
        bucket_chains.append(int(torch.bincount((rows + s_d)[v_d]).max()))
        row_chain = max(row_chain, int(v_d.sum(dim=1).max()))
    chain = max(bucket_chains)
    print(f"[3] longest dependent chain: {chain} accesses to one set, per bucket "
          f"{bucket_chains} (longest row: {row_chain} valid accesses)", flush=True)
    entries = {}
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)     # > the 50 MB L2

    def bucket_bound(kind):
        nbytes = sum(b[0].numel() * (4 + 4 + 1) + b[0].numel() * (2 if kind == "cache_scan" else 5)
                     for b in buckets)
        ops = sum(int(b[2].sum()) * b[4] * 3 for b in buckets)
        return nbytes, ops, chain * vote_step_ms

    for policy in ("lru", "srrip", "fifo"):
        err, k_ms, cold_ms, p_ms, per_bucket = 0.0, 0.0, 0.0, 0.0, []
        for (s_d, t_d, v_d, S, W), b_chain in zip(buckets, bucket_chains):
            h, e = cache_scan_groups(s_d, t_d, v_d, S, W, policy)
            t1 = time.perf_counter()
            hp, ep = cache_scan_plain(s_d, t_d, v_d, S, W, policy)
            torch.cuda.synchronize()
            p_ms += (time.perf_counter() - t1) * 1e3
            if not (torch.equal(h, hp) and torch.equal(e, ep)):
                fail(f"cache_scan[{policy}] differs from its plain version at {tuple(s_d.shape)}")
            err = max(err, max_abs_err(h, hp), max_abs_err(e, ep))

            def run(s_d=s_d, t_d=t_d, v_d=v_d, S=S, W=W):
                return cache_scan_groups(s_d, t_d, v_d, S, W, policy)
            b_ms, b_cold = time_ms(run, 20), time_cold_ms(run, 20, flush)
            k_ms, cold_ms = k_ms + b_ms, cold_ms + b_cold
            per_bucket.append(
                f"{tuple(s_d.shape)}: {b_ms!r} ms ({b_cold!r} L2 flushed), longest set "
                f"{b_chain} accesses, {b_ms * 1e6 / b_chain!r} ns each, "
                f"{k1_blocks_per_sm(s_d.shape[1], S, W, policy)} blocks of "
                f"{S * team_lanes(W)} threads resident per SM")
        nbytes, ops, lat_ms = bucket_bound("cache_scan")
        entries[f"cache_scan[{policy}]"] = dict(
            kind="cache_scan", err=err, ms=k_ms, plain_ms=p_ms, nbytes=nbytes, ops=ops,
            lat_ms=lat_ms, shapes=[tuple(b[0].shape) for b in buckets])
        print(f"[3] cache_scan[{policy}]: equal to plain; kernel {k_ms!r} ms per classification "
              f"({cold_ms!r} L2 flushed), {k_ms * 1e6 / chain!r} ns per longest-set access, "
              f"{lat_ms / k_ms!r} of its chain bound {lat_ms!r} ms; plain {p_ms:.2f} ms; per "
              f"bucket: {'; '.join(per_bucket)}", flush=True)

    err, k_ms, cold_ms, p_ms, per_bucket = 0.0, 0.0, 0.0, 0.0, []
    for (s_d, t_d, v_d, S, W), b_chain in zip(buckets, bucket_chains):
        d, e = stack_distance_groups(s_d, t_d, v_d, S, W)
        t1 = time.perf_counter()
        dp, ep = stack_distance_plain(s_d, t_d, v_d, S, W)
        torch.cuda.synchronize()
        p_ms += (time.perf_counter() - t1) * 1e3
        if not (torch.equal(d, dp) and torch.equal(e, ep)):
            fail(f"stack_distance differs from its plain version at {tuple(s_d.shape)}")
        err = max(err, max_abs_err(d, dp), max_abs_err(e, ep))

        def run(s_d=s_d, t_d=t_d, v_d=v_d, S=S, W=W):
            return stack_distance_groups(s_d, t_d, v_d, S, W)
        b_ms, b_cold = time_ms(run, 20), time_cold_ms(run, 20, flush)
        k_ms, cold_ms = k_ms + b_ms, cold_ms + b_cold
        per_bucket.append(
            f"{tuple(s_d.shape)}: {b_ms!r} ms ({b_cold!r} L2 flushed), longest set "
            f"{b_chain} accesses, {b_ms * 1e6 / b_chain!r} ns each, "
            f"{k2_blocks_per_sm(s_d.shape[1], S, W)} blocks of "
            f"{S * team_lanes(W)} threads resident per SM")
    nbytes, ops, lat_ms = bucket_bound("stack_distance")
    entries["stack_distance[lru]"] = dict(
        kind="stack_distance", err=err, ms=k_ms, plain_ms=p_ms, nbytes=nbytes, ops=ops,
        lat_ms=lat_ms, shapes=[tuple(b[0].shape) for b in buckets])
    print(f"[3] stack_distance[lru]: equal to plain; kernel {k_ms!r} ms per classification "
          f"({cold_ms!r} L2 flushed), {k_ms * 1e6 / chain!r} ns per longest-set access, "
          f"{lat_ms / k_ms!r} of its chain bound {lat_ms!r} ms; plain {p_ms:.2f} ms; per "
          f"bucket: {'; '.join(per_bucket)}", flush=True)

    rng = np.random.default_rng(0)
    for S, W in EDGE_GEOMETRIES:
        B, L = 3, 160
        s_d = torch.from_numpy(rng.integers(0, S, size=(B, L)).astype(np.int32)).to(dev)
        t_d = torch.from_numpy(rng.integers(0, S * W * 2 + 1, size=(B, L)).astype(np.int32)).to(dev)
        v_np = rng.random((B, L)) < 0.9
        v_np[:, 130:] = False
        v_d = torch.from_numpy(v_np).to(dev)
        for policy in ("lru", "srrip", "fifo"):
            got = cache_scan_groups(s_d, t_d, v_d, S, W, policy)
            want = cache_scan_plain(s_d, t_d, v_d, S, W, policy)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                fail(f"cache_scan[{policy}] differs from its plain version at (sets, ways)={(S, W)}")
        # K2 also with sets out of range (padding) and valid tags of -1 (the
        # reference sums the positions of every empty way they match)
        s_x, t_x = s_d.clone(), t_d.clone()
        s_x[:, ::7] = -1
        s_x[:, 3::11] = S
        t_x[:, :6] = -1
        t_x[:, 60:63] = -1
        for rows in ((s_d, t_d, v_d), (s_x, t_x, v_d)):
            got = stack_distance_groups(*rows, S, W)
            want = stack_distance_plain(*rows, S, W)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                fail(f"stack_distance differs from its plain version at (sets, ways)={(S, W)}")
    print(f"[3] edge geometries {EDGE_GEOMETRIES}: kernels equal plain versions (K2 also with "
          f"sets out of range and valid tags of -1)", flush=True)

    # D1 on the full-size SPM miss stream (every lookup misses: the largest
    # DRAM scan of the slice), then on a small ragged input.
    spm = MemorySystem.from_hardware(hw.with_policy("spm"), "cuda")
    req = spm.prepare_embedding(etrace).request
    st = chunk_rows(req.lines, req.seg, req.src, req.num_segments, req.num_sources, req.model)
    args = [torch.from_numpy(st[k]).to(dev) for k in ("bk_m", "row_m", "k_m", "va_m")]
    scal = (req.model.banks_per_channel, st["k_max"], float(req.model.t_rp + req.model.t_rcd),
            float(req.model.t_cas), st["bus_cyc"])
    (lat, hit, dmax), (done0, rh) = dram_scan_chunked(*args, *scal)
    t1 = time.perf_counter()
    (lat_p, hit_p, dmax_p), (done0_p, rh_p) = dram_scan_plain(*args, *scal)
    torch.cuda.synchronize()
    d1_plain_ms = (time.perf_counter() - t1) * 1e3
    pairs = [(lat, lat_p), (hit, hit_p), (dmax, dmax_p), (done0, done0_p), (rh, rh_p)]
    if not all(bitwise_equal(a, b) for a, b in pairs):
        fail("dram_scan differs bitwise from its plain version at full size")
    d1_err = max(max_abs_err(a, b) for a, b in pairs)
    d1_ms = time_ms(lambda: dram_scan_chunked(*args, *scal), 20)
    d1_cold = time_cold_ms(lambda: dram_scan_chunked(*args, *scal), 20, flush)
    R, Lc = args[0].shape
    kv = st["k_m"][st["va_m"]].astype(np.int64)
    # A row's bus chain per valid chunk: one f32 max, then k dependent adds.
    d1_chain = int(((st["k_m"].astype(np.int64) + 1) * st["va_m"]).sum(axis=1).max())
    entries["dram_scan[spm]"] = dict(
        kind="dram_scan", err=d1_err, ms=d1_ms, plain_ms=d1_plain_ms,
        nbytes=R * Lc * (4 * 3 + 1) + R * Lc * (4 + 1) + R * 12,
        ops=int((2 * (kv - 1) + 6).sum()),
        lat_ms=d1_chain * f32_op_ms, shapes=[(R, Lc)])
    print(f"[3] dram_scan: bitwise equal to plain at (R, Lc)={(R, Lc)}, "
          f"{int(st['va_m'].sum())} chunks, longest bus chain {d1_chain} dependent f32 ops; "
          f"kernel {d1_ms!r} ms ({d1_cold!r} L2 flushed), {d1_ms * 1e6 / Lc!r} ns per chunk, "
          f"{d1_chain * f32_op_ms / d1_ms!r} of its chain bound {d1_chain * f32_op_ms!r} ms, "
          f"{d1_blocks_per_sm(scal[0])} block(s) of 32 rows resident per SM; "
          f"plain {d1_plain_ms:.2f} ms", flush=True)
    Rs, Ls = 5, 96
    small = [torch.from_numpy(a).to(dev) for a in (
        rng.integers(0, 8, size=(Rs, Ls)).astype(np.int32),
        rng.integers(0, 3, size=(Rs, Ls)).astype(np.int32),
        rng.integers(1, 9, size=(Rs, Ls)).astype(np.int32),
        rng.random((Rs, Ls)) < 0.8)]
    got = dram_scan_chunked(*small, 8, 8, 44.0, 22.0, 0.6016)
    want = dram_scan_plain(*small, 8, 8, 44.0, 22.0, 0.6016)
    if not all(bitwise_equal(a, b) for a, b in zip(got[0] + got[1], want[0] + want[1])):
        fail("dram_scan differs bitwise from its plain version on the ragged input")
    print("[3] dram_scan: bitwise equal to plain on a ragged (5, 96) input", flush=True)

    # D1 on config C's merged miss stream: spm over 4 table-hash shards,
    # placed per_core/table_rank, one source a core. Run boundaries fold the
    # source, so the stream has more, shorter runs; the per-source finish is
    # built on the host from the scan's chunk results (aggregate "device")
    # and held against the per-access expansion (aggregate "host").
    hw_c = hw.with_cluster(CLUSTER_CORES, "private", "table_hash").with_placement(
        "per_core", "table_rank")
    req4 = memory_system_for(hw_c, "cuda").prepare_embedding(etrace).request
    st4 = chunk_rows(req4.lines, req4.seg, req4.src, req4.num_segments, req4.num_sources,
                     req4.model)
    if req4.num_sources != CLUSTER_CORES or st4["k_max"] > 8:
        fail(f"dram_scan on C: {req4.num_sources} sources, k_max {st4['k_max']}")
    args4 = [torch.from_numpy(st4[k]).to(dev) for k in ("bk_m", "row_m", "k_m", "va_m")]
    scal4 = scal[:1] + (st4["k_max"],) + scal[2:4] + (st4["bus_cyc"],)
    got4 = dram_scan_chunked(*args4, *scal4)
    t1 = time.perf_counter()
    want4 = dram_scan_plain(*args4, *scal4)
    torch.cuda.synchronize()
    d1c_plain_ms = (time.perf_counter() - t1) * 1e3
    pairs4 = list(zip(got4[0] + got4[1], want4[0] + want4[1]))
    if not all(bitwise_equal(a, b) for a, b in pairs4):
        fail("dram_scan differs bitwise from its plain version on C's 4-source stream")
    dram_args = (req4.lines, req4.seg, req4.src, req4.num_segments, req4.num_sources, req4.model)
    with profiling.collect() as d1prof:
        res_dev, fin_dev = simulate_dram_contended(*dram_args, aggregate="device", device=dev)
    res_host, fin_host = simulate_dram_contended(*dram_args, aggregate="host", device=dev)
    if ([dataclasses.asdict(r) for r in res_dev] != [dataclasses.asdict(r) for r in res_host]
            or not np.array_equal(fin_dev, fin_host)):
        fail("dram_scan on C: aggregate 'device' differs from 'host' (results or finish)")
    if not (np.all(fin_dev > 0) and np.array_equal(fin_dev.max(axis=1),
                                                   [r.finish_cycle for r in res_dev])):
        fail(f"dram_scan on C: per-source finish {fin_dev.tolist()} against the segments' "
             f"{[r.finish_cycle for r in res_dev]}")
    d1c_ms = time_ms(lambda: dram_scan_chunked(*args4, *scal4), 20)
    d1c_cold = time_cold_ms(lambda: dram_scan_chunked(*args4, *scal4), 20, flush)
    R4, Lc4 = args4[0].shape
    kv4 = st4["k_m"][st4["va_m"]].astype(np.int64)
    d1c_chain = int(((st4["k_m"].astype(np.int64) + 1) * st4["va_m"]).sum(axis=1).max())
    entries["dram_scan[spm 4 cores]"] = dict(
        kind="dram_scan", err=max(max_abs_err(a, b) for a, b in pairs4), ms=d1c_ms,
        plain_ms=d1c_plain_ms, nbytes=R4 * Lc4 * (4 * 3 + 1) + R4 * Lc4 * (4 + 1) + R4 * 12,
        ops=int((2 * (kv4 - 1) + 6).sum()), lat_ms=d1c_chain * f32_op_ms, shapes=[(R4, Lc4)])
    d1c_stages = {k: round(v, 4) for k, v in d1prof.breakdown().items()}
    print(f"[3] dram_scan on C's merged stream ({req4.num_sources} sources, per_core/table_rank): "
          f"bitwise equal to plain at (R, Lc)={(R4, Lc4)}; {st4['nr']} runs, "
          f"{st4['n_chunks']} chunks, k_max {st4['k_max']} (one source: {st['nr']} runs, "
          f"{st['n_chunks']} chunks); aggregate 'device' equals 'host', finish matrix "
          f"included ({fin_dev.tolist()}); kernel {d1c_ms!r} ms ({d1c_cold!r} L2 flushed) "
          f"beside one source's {d1_ms!r} ms ({d1_cold!r}); longest bus chain {d1c_chain}, "
          f"{d1c_chain * f32_op_ms / d1c_ms!r} of its chain bound; plain {d1c_plain_ms:.2f} ms; "
          f"the call's host stages {json.dumps(d1c_stages)}", flush=True)

    # D2 on the calls simulate makes: the lane stream of the on-chip cache
    # under srrip and fifo (one call each, the short route), and the page
    # streams of a FIFO TLB (L1, then an L2 that sees the L1 misses; the
    # chunked route) behind spm, the run of phase 4 whose launches the TLB
    # entry reads. Then edge rows on both routes.
    hw_tr = hw.with_policy("spm").with_translation(replacement="fifo", **TRANSLATION)
    tr = hw_tr.translation
    cs = MemorySystem.from_hardware(hw_tr, "cuda").classify_embedding(etrace)
    pages = tlb_pages(cs.miss_lines, hw.onchip.line_bytes, tr.page_bytes)
    l1_hits = classify_tlb(pages, tr.num_sets, tr.ways, "fifo", device="cuda")
    d2_sets = {
        "rrip_scan[srrip]": ("srrip", [row_plan(etrace.vec_ids, lane.num_sets, lane.ways, "srrip")],
                             "per simulate", "src/repro/core/memory/rrip.py:162"),
        "rrip_scan[fifo]": ("fifo", [row_plan(etrace.vec_ids, lane.num_sets, lane.ways, "fifo")],
                            "per simulate", "src/repro/core/memory/rrip.py:137"),
        "rrip_scan[tlb fifo]": ("fifo", [row_plan(pages, tr.num_sets, tr.ways, "fifo"),
                                         row_plan(pages[~l1_hits], tr.l2_num_sets, tr.l2_ways,
                                                  "fifo")],
                                "per TLB charge (L1 + L2)", "src/repro/core/memory/rrip.py:137"),
    }
    for name, (policy, plans, per, replaces) in d2_sets.items():
        err, k_ms, cold_ms, p_ms, per_call = 0.0, 0.0, 0.0, 0.0, []
        nbytes, ops, lat_ms, chain_ms, kept = 0, 0, 0.0, 0.0, 0
        for tags_h, valid_h, groups in plans:
            (_, table), = groups
            w = table.ways
            t_d, v_d, h, t_err, t_p_ms, reruns = d2_against_plain(name, policy, tags_h,
                                                                  valid_h, table, dev)
            err, p_ms = max(err, t_err), p_ms + t_p_ms
            out = torch.empty_like(h)

            def run(t_d=t_d, v_d=v_d, table=table, out=out):
                return rrip_scan_flat(t_d, v_d, table, policy, out=out)
            b_ms, b_cold = time_ms(run, 20), time_cold_ms(run, 20, flush)
            k_ms, cold_ms = k_ms + b_ms, cold_ms + b_cold
            # Bounds. A step's chain is at least a compare, an OR tree over
            # the ways and a select: 2 + log2(ways held) dependent integer
            # ops. The serial bound: the longest row walked in sequence. This
            # design's own: its longest virtual row (a chunk and its
            # warm-up), then the fix-up, whose warp compares 32 chunks of a
            # row at once: a round of a compare, an AND tree over the state's
            # ints and a ballot for each 32 chunks after the first, and the
            # steps of the chunks that ran again in sequence (at the least
            # the re-runs spread evenly over the rows). Launches run one
            # after another, so chains add up, as their times do. Bytes: the
            # tags of the valid steps, the whole valid mask read and the
            # whole hit array written.
            per_row = np.add.reduceat(valid_h.astype(np.int64), table.off)
            longest = int(per_row.max())
            chain_ops = 2 + (max(w, 1) - 1).bit_length()
            b_chain = longest * chain_ops * f32_op_ms
            if table.chunked:
                rounds = -(-(int((-(-table.length // table.chunk)).max()) - 1) // 32)
                cmp_ops = 2 + (state_ints(w, policy) - 1).bit_length()
                redo = -(-reruns // table.rows) * table.chunk * chain_ops
                b_lat = (min(longest, table.chunk + table.warmup) * chain_ops
                         + rounds * cmp_ops + redo) * f32_op_ms
            else:
                b_lat = b_chain
            nbytes += int(valid_h.sum()) * 4 + tags_h.size * (1 + 1)
            ops += int(valid_h.sum()) * (4 * w + 8)
            lat_ms += b_lat
            chain_ms += b_chain
            kept += int(valid_h.sum())
            steps = table.max_steps
            per_call.append(
                f"{table.rows} rows (longest {longest} valid steps) x {w} ways, "
                f"{'chunked' if table.chunked else 'short'} route: {table.virtual_rows} virtual "
                f"rows of at most {steps} steps, {table.blocks} blocks "
                f"({rrip_blocks_per_sm(steps, w, policy)} per SM), re-runs {reruns}: {b_ms!r} ms "
                f"({b_cold!r} L2 flushed), {b_ms / b_lat!r} x its bound {b_lat!r} ms, "
                f"{b_chain / b_ms!r} of the serial chain bound {b_chain!r} ms")
        entries[name] = dict(
            kind="rrip_scan", err=err, ms=k_ms, plain_ms=p_ms, nbytes=nbytes, ops=ops,
            lat_ms=lat_ms, shapes=[(int(p[0].size),) for p in plans], replaces=replaces,
            library_none="no one PyTorch call computes a FIFO/SRRIP set scan")
        print(f"[3] {name}: bitwise equal to plain on {len(plans)} call(s), {kept} kept accesses; "
              f"kernel {k_ms!r} ms {per} ({cold_ms!r} L2 flushed); its bound {lat_ms!r} ms "
              f"(the chains of this design, summed over the calls; byte bound "
              f"{nbytes / HBM_BYTES_PER_S * 1e3!r} ms), {k_ms / lat_ms!r} x it; the serial chain "
              f"bound {chain_ms!r} ms, {chain_ms / k_ms!r} of it; plain {p_ms:.2f} ms; per call: "
              f"{'; '.join(per_call)}", flush=True)
    edge_reruns = {}
    for policy in ("fifo", "srrip"):
        for w in (1, 2, 3, 4, 5, 7, 8, 13, 16, 17, 31, 32, 33, 63, 64):
            B, L = 37, 200
            tags_h = rng.integers(0, 2 * w + 2, size=(B, L)).astype(np.int32)
            tags_h[rng.random((B, L)) < 0.03] = -1
            valid_h = (np.arange(L)[None, :] < rng.integers(0, L + 1, size=B)[:, None]) \
                & (rng.random((B, L)) < 0.95)
            valid_h[B // 2] = False
            tags_h[~valid_h] = -2
            t_d, v_d = torch.from_numpy(tags_h).to(dev), torch.from_numpy(valid_h).to(dev)
            want = RRIP_PLAIN[policy](t_d, v_d, w)
            if not torch.equal(rrip_scan_rows(t_d, v_d, w, policy), want):
                fail(f"rrip_scan[{policy}] differs from its plain version on edge rows, {w} ways")
            # The chunked route on the same rows: chunks of 32, warm-ups of
            # 16 and 0 (no warm-up: the fix-up re-runs chunks).
            for warmup in (16, 0):
                count = torch.zeros(1, dtype=torch.int32, device=dev)
                got = rrip_scan_rows(t_d, v_d, w, policy, reruns=count, chunk=32, warmup=warmup,
                                     long_row=64)
                _, rc = rrip_scan_chunked_plain(t_d, v_d, w, policy, chunk=32, warmup=warmup)
                if not torch.equal(got, want) or int(count) != rc or (
                        warmup == 0 and w > 1 and rc == 0):
                    fail(f"rrip_scan[{policy}] chunked route differs on edge rows, {w} ways, "
                         f"warm-up {warmup}: re-runs {int(count)}, plain {rc}")
                edge_reruns[(policy, warmup)] = edge_reruns.get((policy, warmup), 0) + rc
    print(f"[3] rrip_scan: bitwise equal to plain on edge rows (37 x 200, ragged lengths, an "
          f"all-padding row, valid tags of -1) at ways 1 to 64, short route and chunked (chunks "
          f"of 32; re-runs, summed over the ways: "
          f"{ {f'{p} K={k}': n for (p, k), n in edge_reruns.items()} })", flush=True)

    # K3, K4, K5 on the inputs the DLRM path gives them: the full-width
    # DLRM-RMC2 table (filled on the card, freed at the end of this phase and
    # built again, from the same seed, in phase 6) and request 0's lookups.
    cfg = DLRMConfig()
    R, D, L = cfg.rows_per_table, cfg.dim, cfg.lookups_per_table
    dcfg = DLRMDataConfig(cfg.num_tables, R, L, batch_size=32,
                          zipf_s=REUSE_LEVELS["reuse_high"])

    def build_dlrm():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = DLRM(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        return m, time.perf_counter() - t0

    model, init_s = build_dlrm()
    table = model.tables
    print(f"[3] DLRM-RMC2 at full width: table {tuple(table.shape)} {table.dtype}, "
          f"{table.numel() * table.element_size()} B, filled on the card in {init_s:.3f} s",
          flush=True)
    batch0 = dlrm_batch(dcfg, 0)
    hot_ids = hot_ids_of(batch0["sparse"], R, N_HOT)
    pos0, mask0 = emb_ops.split_hot_cold(batch0["sparse"], hot_ids, R)
    B, T = batch0["sparse"].shape[:2]
    flat0 = (torch.from_numpy(batch0["sparse"]).to(dev)
             + torch.arange(T, dtype=torch.int32, device=dev)[None, :, None] * R).contiguous()
    pos_d, mask_d = torch.from_numpy(pos0).to(dev), torch.from_numpy(mask0).to(dev)
    hot_table = emb_ops.embedding_gather(table, torch.from_numpy(hot_ids).to(dev))
    cold0 = flat0.masked_fill(mask_d == 1, 0).reshape(-1)
    N = flat0.numel()

    def check_embedding(label, kernel, plain, library, args, exact, tol, reps=20):
        """Kernel against its plain version (bitwise, or allclose at ``tol``)
        and the library call against the plain version (allclose at
        ``tol``); returns (max abs err, kernel, plain, library ms)."""
        got, want = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        same = bitwise_equal(got, want) if exact else torch.allclose(
            got.float(), want.float(), atol=tol, rtol=tol)
        err = max_abs_err(got, want)
        if not same:
            fail(f"{label} differs from its plain version (max abs err {err!r})")
        lib = library().reshape(want.shape).float()
        if not torch.allclose(lib, want.float(), atol=tol, rtol=tol):
            fail(f"{label}: the library call does not compute the kernel's function")
        k_ms = time_cold_ms(lambda: kernel(*args), reps, flush)
        p_ms = time_cold_ms(lambda: plain(*args), 3, flush)
        l_ms = time_cold_ms(library, reps, flush)
        print(f"[3] {label}: {'bitwise equal' if exact else f'allclose ({tol})'} to plain, "
              f"max abs err {err!r}; kernel {k_ms!r} ms, plain {p_ms!r} ms, library "
              f"{l_ms!r} ms (L2 flushed before each launch)", flush=True)
        return err, k_ms, p_ms, l_ms

    def offsets(n, length):
        return torch.arange(0, n, max(length, 1), device=dev)

    if vmem_tile_rows(D * table.element_size()) < N_HOT:
        fail(f"the main path's hot table ({N_HOT} x {D}) does not fit one K5 tile")
    flat_l, cold_l, pos_l = flat0.reshape(-1).long(), cold0.long(), pos_d.reshape(-1).long()
    w_hot = mask_d.reshape(-1).to(hot_table.dtype)
    e3 = check_embedding(
        f"embedding_bag (B, T, L, D)={(B, T, L, D)} f32", embedding_bag_kernel,
        embedding_bag_plain, lambda: F.embedding_bag(flat_l, table, offsets(N, L), mode="sum"),
        (table, flat0), True, 1e-5)
    e4 = check_embedding(
        f"embedding_gather (N, D)={(N, D)} f32 (the pinned path's cold stream)",
        embedding_gather_kernel, embedding_gather_plain,
        lambda: torch.index_select(table, 0, cold_l), (table, cold0), True, 0.0)
    e5 = check_embedding(
        f"vmem_gather_pool (H, D)={(N_HOT, D)} (B, T, L)={(B, T, L)} f32, one tile",
        vmem_gather_pool_kernel, vmem_gather_pool_plain,
        lambda: F.embedding_bag(pos_l, hot_table, offsets(N, L), mode="sum",
                                per_sample_weights=w_hot),
        (hot_table, pos_d, mask_d), True, 1e-5)
    # 64-bit offsets: the last row of the stacked table (row * D = 7.68e9)
    # and a row just past 2^31 elements, through K3 and K4.
    far = torch.tensor([table.shape[0] - 1, 0, (1 << 31) // D + 5, table.shape[0] // 2, -1],
                       dtype=torch.int32, device=dev)
    if not (bitwise_equal(embedding_gather_kernel(table, far), embedding_gather_plain(table, far))
            and bitwise_equal(embedding_bag_kernel(table, far.view(1, 1, -1)),
                              embedding_bag_plain(table, far.view(1, 1, -1)))):
        fail("K3/K4 differ from their plain versions at rows past 2^31 elements")
    print(f"[3] K3/K4 bitwise equal to plain at rows {far.tolist()} (row x D up to "
          f"{(table.shape[0] - 1) * D})", flush=True)

    gen = torch.Generator(device=dev).manual_seed(1)

    def rand_table(rows, d, dtype):
        return torch.randn((rows, d), generator=gen, device=dev).to(dtype)

    def rand_ints(hi, shape):
        return torch.randint(0, hi, shape, generator=gen, device=dev, dtype=torch.int32)

    # K3's edges: scalar columns (D % 4, or a table view off 16 bytes), D
    # past one 128-column pass, L across blocks of 32 indices.
    for dtype, d, lx, off in ((torch.float32, 200, 9, 0), (torch.float32, 128, 1, 0),
                              (torch.bfloat16, 128, 40, 0), (torch.bfloat16, 200, 7, 0),
                              (torch.float32, 512, 33, 0), (torch.float32, 3, 31, 0),
                              (torch.bfloat16, 100, 300, 0), (torch.float32, 128, 120, 1),
                              (torch.bfloat16, 256, 32, 1)):
        tb = rand_table(5001, d, dtype).view(-1)[off:off + 5000 * d].view(5000, d)
        ix = rand_ints(5000, (32, 8, lx)) - 2
        check_embedding(f"edge embedding_bag D={d} L={lx} {dtype}"
                        f"{', table view off 16 bytes' if off else ''}", embedding_bag_kernel,
                        embedding_bag_plain,
                        lambda: F.embedding_bag(ix.reshape(-1).long().remainder(5000), tb,
                                                offsets(ix.numel(), lx), mode="sum"),
                        (tb, ix), True, 1e-5 if dtype == torch.float32 else 5e-2, reps=5)
    for dtype, d in ((torch.float32, 200), (torch.bfloat16, 33)):
        tb, ix = rand_table(5000, d, dtype), rand_ints(5000, (4096,))
        check_embedding(f"edge embedding_gather D={d} {dtype}", embedding_gather_kernel,
                        embedding_gather_plain, lambda: torch.index_select(tb, 0, ix.long()),
                        (tb, ix), True, 0.0, reps=5)
    for dtype, h, d, lx in ((torch.float32, 1024, 128, 40), (torch.bfloat16, 1024, 128, 40),
                            (torch.float32, 37, 200, 9), (torch.float32, 256, 128, 1)):
        hb, px = rand_table(h, d, dtype), rand_ints(h, (32, 8, lx))
        mx = rand_ints(2, (32, 8, lx))
        tiles = -(-h // vmem_tile_rows(d * hb.element_size()))
        check_embedding(f"edge vmem_gather_pool H={h} D={d} L={lx} {dtype}, {tiles} tile(s)",
                        vmem_gather_pool_kernel, vmem_gather_pool_plain,
                        lambda: F.embedding_bag(px.reshape(-1).long(), hb, offsets(px.numel(), lx),
                                                mode="sum",
                                                per_sample_weights=mx.reshape(-1).to(dtype)),
                        (hb, px, mx), tiles == 1, 1e-5 if dtype == torch.float32 else 5e-2,
                        reps=5)

    # Bound terms. Zipf reuse repeats rows and the L2 serves the repeats, so
    # the bytes a gather must move are its distinct rows, plus its indices
    # (and mask) and its output. K5 needs its hot table once: the kernel's
    # blocks each stage it, but after the first they read it from the L2.
    itemsize = table.element_size()
    distinct3 = int(torch.unique(flat0).numel())
    distinct4 = int(torch.unique(cold0).numel())
    out_bytes = B * T * D * itemsize
    for name, e, nbytes, nops, lat, shapes in (
            ("embedding_bag", e3, distinct3 * D * itemsize + N * 4 + out_bytes, N * D,
             L * f32_op_ms, [(B, T, L, D)]),
            ("embedding_gather", e4, distinct4 * D * itemsize + N * 4 + N * D * itemsize, 0, 0.0,
             [(N, D)]),
            ("vmem_gather_pool", e5, N_HOT * D * itemsize + 2 * N * 4 + out_bytes,
             2 * N * D, L * f32_op_ms, [(N_HOT, D), (B, T, L)])):
        entries[name] = dict(kind=name, err=e[0], ms=e[1], plain_ms=e[2], library_ms=e[3],
                             nbytes=nbytes, ops=nops, lat_ms=lat, shapes=shapes)
    k3 = entries["embedding_bag"]
    k3_bound = max(k3["nbytes"] / HBM_BYTES_PER_S * 1e3, k3["ops"] / SCALAR_OPS_PER_S * 1e3,
                   k3["lat_ms"])
    print(f"[3] K3 at request 0 (one warp per bag): kernel {e3[1]!r} ms, F.embedding_bag "
          f"{e3[3]!r} ms ({e3[1] / e3[3]!r} x the library call); bound {k3_bound!r} ms "
          f"(bytes of the distinct rows, indices and output {k3['nbytes'] / HBM_BYTES_PER_S * 1e3!r}), "
          f"{k3_bound / e3[1]!r} of its bound", flush=True)
    k5 = entries["vmem_gather_pool"]
    k5_bound = max(k5["nbytes"] / HBM_BYTES_PER_S * 1e3, k5["ops"] / SCALAR_OPS_PER_S * 1e3,
                   k5["lat_ms"])
    print(f"[3] K5 at request 0 (one warp per bag): kernel {e5[1]!r} ms, F.embedding_bag "
          f"{e5[3]!r} ms ({e5[1] / e5[3]!r} x the library call); bound {k5_bound!r} ms "
          f"(bytes {k5['nbytes'] / HBM_BYTES_PER_S * 1e3!r}, chain of {L} adds "
          f"{k5['lat_ms']!r}), kernel = {e5[1] / k5_bound!r} x its bound", flush=True)
    print(f"[3] request 0: {N} lookups touch {distinct3} distinct rows ({distinct4} in the "
          f"pinned path's cold stream, hot lookups sent to row 0)", flush=True)
    del model, table, hot_table, flush
    torch.cuda.empty_cache()

    # K6, K7, K8 at the Zamba2 serving path's shapes and at edge shapes.
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    lm_entries = check_lm_kernels(dev, flush, f32_op_ms)
    del flush
    torch.cuda.empty_cache()

    # ---- 4. simulate on every policy/backend pair ------------------------
    results, launches = {}, {}
    for policy, backend in RUNS:
        hw_run = tpuv6e().with_policy(policy).with_cache_backend(backend)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        with profiling.collect() as prof:
            res = simulate(wl, hw_run)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
        summ = res.summary()
        if len(res.batches) != 2 or not all(
                math.isfinite(v) for v in summ.values() if isinstance(v, float)):
            fail(f"{policy}/{backend}: malformed result {summ}")
        if not res.total_cycles > 0:
            fail(f"{policy}/{backend}: total_cycles {res.total_cycles}")
        for kname, n in counts.items():
            should = kname in ("dram_scan", PAIR_KERNEL.get((policy, backend)))
            if should and n == 0:
                fail(f"{policy}/{backend}: kernel {kname} was not launched on the main path")
            if not should and n != 0:
                fail(f"{policy}/{backend}: kernel {kname} launched {n} times off its path")
        if counts["dram_scan"] != 1:
            fail(f"{policy}/{backend}: {counts['dram_scan']} DRAM scan launches, expected 1")
        if PAIR_KERNEL.get((policy, backend)) == "rrip_scan" and counts["rrip_scan"] != RRIP_LAUNCHES:
            fail(f"{policy}/{backend}: {counts['rrip_scan']} row-scan launches, expected "
                 f"{RRIP_LAUNCHES} (one per classification)")
        if policy in REF_TOTAL and res.total_cycles != REF_TOTAL[policy]:
            fail(f"{policy}/{backend}: total_cycles {res.total_cycles!r}, the reference's "
                 f"{REF_TOTAL[policy]!r}")
        results[(policy, backend)] = dataclasses.asdict(res)
        launches[(policy, backend)] = counts
        acc = res.cache_hits + res.cache_misses
        stages = {k: round(v, 4) for k, v in prof.breakdown(wall).items()}
        print(f"[4] {policy}/{backend}: wall {wall:.3f} s, total_cycles {res.total_cycles!r}, "
              f"hit_rate {res.cache_hits / max(acc, 1)!r}, launches {counts}, "
              f"max_memory_allocated {torch.cuda.max_memory_allocated()} B, stages {json.dumps(stages)}",
              flush=True)
    for policy in sorted({p for p, _ in RUNS}):
        same = [results[k] for k in results if k[0] == policy]
        if any(r != same[0] for r in same[1:]):
            fail(f"{policy}: results differ across backends")
    print(f"[4] results bitwise equal across backends for every policy; srrip and fifo "
          f"total_cycles equal the reference's {REF_TOTAL}", flush=True)

    # Address translation: three runs with a TLB (L1 + L2), against the
    # reference's totals and walks; D2 runs the FIFO TLB's two levels.
    for (policy, repl), (ref_cycles, ref_walks, n_rrip) in REF_TRANSLATION.items():
        hw_run = tpuv6e().with_policy(policy).with_translation(replacement=repl, **TRANSLATION)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        with profiling.collect() as prof:
            res = simulate(wl, hw_run)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
        if (res.total_cycles, res.tlb_walks) != (ref_cycles, ref_walks):
            fail(f"{policy} + {repl} TLB: total_cycles {res.total_cycles!r}, tlb_walks "
                 f"{res.tlb_walks}; the reference's {ref_cycles!r}, {ref_walks}")
        if counts["rrip_scan"] != n_rrip or counts["dram_scan"] != 1:
            fail(f"{policy} + {repl} TLB: launches {counts}; expected rrip_scan {n_rrip}, "
                 f"dram_scan 1")
        launches[(policy, "tlb " + repl)] = counts
        stages = {k: round(v, 4) for k, v in prof.breakdown(wall).items()}
        print(f"[4] {policy}/stack + {repl} TLB {TRANSLATION}: wall {wall:.3f} s, total_cycles "
              f"{res.total_cycles!r}, tlb_walks {res.tlb_walks}, translation_cycles "
              f"{res.translation_cycles!r}, launches {counts}, stages {json.dumps(stages)}; "
              f"equal to the reference", flush=True)

    # Device busy share of one run of the K1 path.
    from torch.profiler import ProfilerActivity, profile
    hw_run = tpuv6e().with_policy("lru").with_cache_backend("pallas")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tprof:
        t0 = time.perf_counter()
        simulate(wl, hw_run)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(f"[4] profiled lru/pallas: wall {wall!r} s, "
          f"{device_busy(tprof.events(), wall, ('dram_scan', 'cache_scan'))}", flush=True)
    hw_run = tpuv6e().with_policy("lru").with_cache_backend("stack_pallas")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tprof:
        t0 = time.perf_counter()
        simulate(wl, hw_run)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(f"[4] profiled lru/stack_pallas: wall {wall!r} s, "
          f"{device_busy(tprof.events(), wall, ('dram_scan', 'stack_distance'))}", flush=True)
    for policy, tlb in (("srrip", None), ("spm", "fifo")):
        hw_run = tpuv6e().with_policy(policy)
        if tlb:
            hw_run = hw_run.with_translation(replacement=tlb, **TRANSLATION)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tprof:
            t0 = time.perf_counter()
            simulate(wl, hw_run)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        print(f"[4] profiled {policy}/stack{' + FIFO TLB' if tlb else ''}: wall {wall!r} s, "
              f"{device_busy(tprof.events(), wall, ('dram_scan', 'rrip_scan'))}", flush=True)

    small_wl = dlrm_rmc2_small(num_tables=2, rows_per_table=300, batch_size=2, num_batches=2)
    small_tr = dict(entries=16, ways=4, l2_entries=64)
    small_runs = [(p, b, None) for p, b in RUNS] + [
        (p, "stack", repl) for p, repl in REF_TRANSLATION]
    for policy, backend, repl in small_runs:
        hw_small = tpuv6e().with_policy(policy, capacity_bytes=1 << 14).with_cache_backend(backend)
        if repl:
            hw_small = hw_small.with_translation(replacement=repl, **small_tr)
        on_card = dataclasses.asdict(simulate(small_wl, hw_small))
        on_cpu = dataclasses.asdict(simulate(small_wl, hw_small, device="cpu"))
        if on_card != on_cpu:
            fail(f"{policy}/{backend} (TLB {repl}): small run on the card differs from the CPU")
    print("[4] small runs on the card equal the same runs on the CPU (every pair, and the "
          "three translation runs)", flush=True)

    # ---- 6. the full-width DLRM-RMC2 forward, plain and hot-pinned -------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model, init_s = build_dlrm()
    init_peak = torch.cuda.max_memory_allocated()
    path_kernels = {"plain": {"embedding_bag": 1},
                    "pinned": {"vmem_gather_pool": 1, "embedding_gather": 1}}
    dlrm_launches = dict.fromkeys(K.launch_counts(), 0)

    def request(step):
        """Host batch prep (the request's batch and its copies to the card),
        then pinning: the request's own top-N_HOT rows are profiled, split
        hot/cold and gathered into the hot table. dlrm_batch draws every
        step's rows under a new permutation, so another request's profile
        finds (almost) none of them; the share it would find is returned too."""
        t0 = time.perf_counter()
        b = dlrm_batch(dcfg, step)
        dense, sparse = (torch.from_numpy(b[k]).to(dev) for k in ("dense", "sparse"))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ids = hot_ids_of(b["sparse"], R, N_HOT)
        pos, mask = emb_ops.split_hot_cold(b["sparse"], ids, R)
        hot = emb_ops.embedding_gather(model.tables, torch.from_numpy(ids).to(dev))
        pinned = {"hot_table": hot, "positions": torch.from_numpy(pos).to(dev),
                  "mask": torch.from_numpy(mask).to(dev)}
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        share0 = float(emb_ops.split_hot_cold(b["sparse"], hot_ids, R)[1].mean())
        return (dense, sparse, pinned, float(mask.mean()), share0, (t1 - t0) * 1e3,
                (t2 - t1) * 1e3)

    def forward(dense, sparse, pinned=None):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        out = model(dense, sparse, pinned)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3, K.launch_counts()

    with torch.inference_mode():
        dense, sparse, pinned = request(0)[:3]
        forward(dense, sparse)                                  # warm-up
        forward(dense, sparse, pinned)
        for step in range(DLRM_STEPS):
            dense, sparse, pinned, hot_share, share0, prep_ms, pin_ms = request(step)
            if not hot_share > 0:
                fail(f"DLRM request {step}: no lookup hits the pinned rows")
            res = {"plain": forward(dense, sparse), "pinned": forward(dense, sparse, pinned)}
            for path, (logits, _, counts) in res.items():
                if counts != {k: path_kernels[path].get(k, 0) for k in counts}:
                    fail(f"DLRM request {step}, {path} path: launches {counts}; expected "
                         f"{path_kernels[path]} and no other kernel")
                for k, n in counts.items():
                    dlrm_launches[k] += n
                if logits.shape != (dcfg.batch_size,) or not bool(torch.isfinite(logits).all()):
                    fail(f"DLRM request {step}, {path} path: logits {tuple(logits.shape)}, "
                         f"finite {bool(torch.isfinite(logits).all())}")
            diff = max_abs_err(res["plain"][0], res["pinned"][0])
            if diff > 1e-4:
                fail(f"DLRM request {step}: pinned and plain logits differ by {diff!r} > 1e-4")
            print(f"[6] request {step}: batch prep {prep_ms!r} ms (host), pinning {pin_ms!r} ms "
                  f"(profile + split on the host, hot-table gather on the card); forward plain "
                  f"{res['plain'][1]!r} ms, pinned {res['pinned'][1]!r} ms (host clock + "
                  f"synchronize); pinned vs plain max abs diff {diff!r}; hot share of lookups "
                  f"{hot_share!r} (under request 0's profile {share0!r}); launches plain "
                  f"{ {k: n for k, n in res['plain'][2].items() if n} }, pinned "
                  f"{ {k: n for k, n in res['pinned'][2].items() if n} }", flush=True)
        print(f"[6] init {init_s!r} s (max_memory_allocated {init_peak} B); "
              f"max_memory_allocated over the forwards {torch.cuda.max_memory_allocated()} B",
              flush=True)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tprof:
            t0 = time.perf_counter()
            model(dense, sparse)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        print(f"[6] profiled plain forward (request {DLRM_STEPS - 1}): wall {wall!r} s, "
              f"{device_busy(tprof.events(), wall, ('bag_kernel',))}", flush=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tprof:
            t0 = time.perf_counter()
            model(dense, sparse, pinned)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        print(f"[6] profiled pinned forward (request {DLRM_STEPS - 1}): wall {wall!r} s, "
              f"{device_busy(tprof.events(), wall, ('pool_kernel',))}", flush=True)
    del model, pinned
    torch.cuda.empty_cache()
    print(f"[6] full-width model freed: memory_allocated {torch.cuda.memory_allocated()} B",
          flush=True)

    # A small model on the card against the same model on the CPU, with one
    # set of weights carried over by the weight converter.
    scfg = smoke_config()
    rng = np.random.default_rng(0)

    def mlp(dims, d):
        layers = []
        for n_out in dims:
            layers.append({"w": rng.standard_normal((d, n_out)) / math.sqrt(d),
                           "b": rng.standard_normal(n_out) * 0.01})
            d = n_out
        return layers

    state = dlrm_params_from_jax(
        {"tables": rng.standard_normal((scfg.num_tables * scfg.rows_per_table, scfg.dim)) * 0.01,
         "bottom": mlp(scfg.bottom_mlp, scfg.dense_features),
         "top": mlp(scfg.top_mlp, scfg.interact_dim)}, scfg)
    sb = dlrm_batch(DLRMDataConfig(scfg.num_tables, scfg.rows_per_table,
                                   scfg.lookups_per_table, batch_size=16,
                                   zipf_s=REUSE_LEVELS["reuse_high"]), 0)
    s_hot = hot_ids_of(sb["sparse"], scfg.rows_per_table, 16)
    s_pos, s_mask = emb_ops.split_hot_cold(sb["sparse"], s_hot, scfg.rows_per_table)
    logits = {}
    with torch.inference_mode():
        for where in ("cuda", "cpu"):
            m = DLRM(scfg, device=where)
            m.load_state_dict(state)
            args = [torch.from_numpy(sb[k]).to(where) for k in ("dense", "sparse")]
            pinned = {"hot_table": emb_ops.embedding_gather(m.tables, torch.from_numpy(s_hot).to(where)),
                      "positions": torch.from_numpy(s_pos).to(where),
                      "mask": torch.from_numpy(s_mask).to(where)}
            logits[where] = (m(*args).cpu(), m(*args, pinned).cpu())
    for i, path in enumerate(("plain", "pinned")):
        if not torch.allclose(logits["cuda"][i], logits["cpu"][i], atol=1e-4, rtol=1e-4):
            fail(f"smoke_config {path} forward on the card differs from the CPU")
    print(f"[6] smoke_config forward on the card equals the CPU (allclose 1e-4): max abs diff "
          f"plain {max_abs_err(*[logits[w][0] for w in ('cuda', 'cpu')])!r}, pinned "
          f"{max_abs_err(*[logits[w][1] for w in ('cuda', 'cpu')])!r}", flush=True)

    # ---- 7. Zamba2-2.7B serving at full width ---------------------------
    lm_counts, k4_lm, lm32_counts = serve_zamba2(dev, K)

    # ---- 8. the DSE sweep at full width ------------------------------------
    sweep_launches = sweep_phase(dev, K, wl)

    # ---- 9. the multi-core cluster at full width ---------------------------
    cluster_launches = cluster_phase(dev, K, wl, results[("lru", "stack")])

    # ---- 10. the request-level serving simulator at full width -------------
    t0 = time.perf_counter()
    serving_launches = serving_phase(dev, K, wl, etrace)
    print(f"[10] phase wall {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 11. the remaining LM architectures served on the card -------------
    t0 = time.perf_counter()
    serve_runs = serve_phase(dev, K)
    print(f"[11] phase wall {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 12. training on the card -------------------------------------------
    t0 = time.perf_counter()
    train_phase(dev, K, name_power)
    print(f"[12] phase wall {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 13. D3, the collective matmul and the sharded restore ---------------
    t0 = time.perf_counter()
    entries["dram_scan_full[lru arrivals]"], entries["dram_prepass[lru arrivals]"] = (
        distributed_phase(dev, K, name_power, hw, etrace, f32_op_ms))
    print(f"[13] phase wall {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 14. the dry run over the production meshes ----------------------------
    dryrun_phase(dry_proc, name_power)

    # ---- report ----------------------------------------------------------
    main_run = {"cache_scan[lru]": ("lru", "pallas"), "cache_scan[srrip]": ("srrip", "pallas"),
                "cache_scan[fifo]": ("fifo", "pallas"), "stack_distance[lru]": ("lru", "stack_pallas"),
                "dram_scan[spm]": ("spm", "stack"), "rrip_scan[srrip]": ("srrip", "stack"),
                "rrip_scan[fifo]": ("fifo", "stack"), "rrip_scan[tlb fifo]": ("spm", "tlb fifo")}
    for name, e in entries.items():
        runs = CLUSTER_RUNS.get(name, ())
        if name in main_run:
            e["launches"] = launches[main_run[name]][e["kind"]]
        elif runs:
            e["launches"] = cluster_launches[runs[0]][e["kind"]]
        elif "launches" not in e:
            e["launches"] = dlrm_launches[e["kind"]]
        if name in ("cache_scan[lru]", "stack_distance[lru]", "dram_scan[spm]",
                    "rrip_scan[srrip]"):
            e["sweep_launches"] = sweep_launches[e["kind"]]
        if runs:
            e["cluster_launches"] = {run: cluster_launches[run][e["kind"]] for run in runs}
        if name in ("cache_scan[lru]", "stack_distance[lru]", "dram_scan[spm]",
                    "rrip_scan[srrip]"):
            e["serving_launches"] = {run: c[e["kind"]] for run, c in serving_launches.items()}
    for name, e in lm_entries.items():
        run = PHASE11_RUN.get(name)
        # K6's f32 route: its launches in phase 7's f32 teacher-forced check
        counts = (lm32_counts if name in ("flash_attention[f32 zamba2]", "mamba2_ssd[f32 zamba2]")
                  else lm_counts)
        e["launches"] = (serve_runs[run] if run else counts)[e["kind"]]
        if e["launches"] == 0:
            fail(f"{name}: no launch in its main run")
    entries.update(lm_entries)
    entries["embedding_gather[zamba2 prompt]"] = k4_lm
    out = []
    for name, e in entries.items():
        bytes_ms = e["nbytes"] / HBM_BYTES_PER_S * 1e3
        mm_ms = e.get("mm_flops", 0) / TENSOR_FLOPS_PER_S * 1e3
        ops_ms = e["ops"] / SCALAR_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, mm_ms, ops_ms, e["lat_ms"])
        print(f"[5] bound {name}: bytes {bytes_ms!r} ms, matrix products at the tensor-core "
              f"rate {mm_ms!r} ms, other operations at peak rate {ops_ms!r} ms, dependent "
              f"chain {e['lat_ms']!r} ms -> {bound_ms!r} ms"
              f"{'; library: null, ' + e['library_none'] if 'library_none' in e else ''}",
              flush=True)
        src, replaces = KERNEL_SOURCES[e["kind"]]
        replaces = e.get("replaces", replaces)
        out.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": e["launches"],
            "max_abs_err": e["err"], "ms": e["ms"], "plain_ms": e["plain_ms"],
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= bound_ms else "operations",
            "library_ms": e.get("library_ms"), "shapes": e["shapes"],
            **({"sweep_launches": e["sweep_launches"]} if "sweep_launches" in e else {}),
            **({"cluster_launches": e["cluster_launches"]} if "cluster_launches" in e else {}),
            **({"serving_launches": e["serving_launches"]} if "serving_launches" in e else {}),
        })
    print(f"[5] script wall {time.perf_counter() - t_script:.1f} s", flush=True)
    print(name_power, flush=True)
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
