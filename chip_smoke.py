#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --only int8
    python3 chip_smoke.py --only leaf
    python3 chip_smoke.py --only telemetry
    python3 chip_smoke.py --only wallclock
    python3 chip_smoke.py --only socket
    python3 chip_smoke.py --only obs
    python3 chip_smoke.py --only families
    python3 chip_smoke.py --only dist
    python3 chip_smoke.py --only plan

Phases, in order; any failure exits non-zero (``--only int8`` runs the
int8 kernels' checks and times of phase 2, the card's read, write and copy
times at the same size, phase 6 and the int8 build report, in that order,
and prints no contract lines; ``--only leaf`` the same for the per-leaf
kernels: their checks and times of phase 2 with the 43-leaf correction
pass, the card's rates, phase 4 and the leaf build report; ``--only
telemetry`` builds the packed sweeps and times a packed server's commit
calls without and with telemetry, and the pieces telemetry adds; ``--only
wallclock`` builds the packed sweeps and runs the wall-clock phase,
``--only socket`` the socket phase, and ``--only obs`` the obs phase with
its untraced twins run in it; ``--only families`` the flash kernels'
build report, flash_attention_fwd's checks and times and the families
phase; ``--only dist`` the dist phase; ``--only plan`` the plan phase):
  1. build every CUDA source of ``src/repro_torch/csrc`` (one nvcc each, in
     parallel) and print the build seconds and the compiler's report; for
     the flash kernels, each one's registers, shared memory and spills
     from ``-Xptxas -v``, and its instruction counts from ``cuobjdump
     -sass``: at every padded width (32, 64, 128, 192, 256) every bf16
     kernel must hold HGMMA (wgmma) and UTMALDG (TMA loads), every fp32
     kernel HMMA (3xTF32 ``mma.sync``) and UTMALDG, and every one zero
     spills; the same for
     the int8 quantize and dequantize kernels, and the per-leaf
     correct_apply (one block, stacked) and outer_update kernels, each of
     which must hold 128-bit global loads and stores (LDG/STG .128), with
     the resident CTAs an SM of the leaf kernels;
  2. at the slice's shape (full-width tinygpt-15m packed: R = 125,128 rows
     in 43 blocks) hold each kernel against its plain PyTorch version
     (plain, stats and in-place variants; the accumulator kernel under a
     delayed-Nesterov boundary table and a FedBuff non-boundary one; the
     int8 sweeps on per-block scales with a block on exact .5 ties, an
     all-zero block and a clipped one; the K-stacked multi sweeps of the
     batched commit path at K = 4, plain, stats and in place, also bit for
     bit against four back-to-back launches of the matching single-arrival
     kernel, the accumulator one under a per-delta table whose second slot
     is a delayed-Nesterov boundary; the multi-Gram sweep's per-row and
     per-block sums; the per-leaf kernels of ``csrc/leaf.cu`` on the
     largest leaf, the tied embedding (50257 x 256): block_stats within
     TOL_SUM, correct_apply and outer_update_2d bit for bit (outer_update_2d
     also in place), each also on four stacked blocks (L = 4, of n / 4 and
     of 4097; for correct_apply one block in each branch of Alg. 2: keep,
     anti, weak, degenerate), on an odd length, on views offset by 1-3
     elements and on lengths 15-17) and time both with CUDA events
     (median of 30 runs after a warm-up; the per-leaf and int8 kernels and
     their yardsticks with each input rotating over copies that together
     exceed L2), beside one PyTorch library call where there is one
     (``quantize_per_channel`` and ``quantize_per_tensor`` beside the int8
     quant sweeps, with how many int8 values they give otherwise; one
     fake-quantize call against the int8 quant + dequant pair's sum; one
     ``torch.bmm`` over a
     pre-stacked basis for the Gram; ``torch.mm(S, S.T)`` over a pre-stacked
     (2, n) S for block_stats; ``torch.add(u, v, alpha=cv)`` for
     correct_apply with cu = 1; ``torch._fused_sgd_`` with Nesterov and
     dampening mu for outer_update_2d with rho = 1), and time the 43-leaf
     correction pass;
  3. run the slice's scenarios through ``repro_torch.scenarios`` at full
     tinygpt-15m width, batch 4 x 128, on cuda: ``paper_hetero_severe``
     (HeLoCo), the outer-method baselines ``delayed_nesterov``,
     ``fedbuff``, ``dcasgd``, ``poly_stale`` and ``sync_baseline``, then
     the engine axes ``noniid_dirichlet`` (Dirichlet mixtures),
     ``crash_rejoin``, ``elastic_membership`` and ``int8_dylu`` (DyLU with
     packed int8 compression and error feedback), then the batched commit
     path (``commit_batch = 4``): ``hogwild_rampup`` and ``trace_paced``,
     and ``fedbuff``, ``delayed_nesterov`` and ``dcasgd`` overridden with
     ``commit_batch=4``, then the decentralized topologies ``gossip_ring``
     and ``gossip_random`` (per-worker replicas and a pairwise peer mean,
     which launch no kernel), each at its golden's full depth. Before each
     run
     every launch count is set to 0 and read after it: the arrivals must
     equal the committed golden trace's exactly (for the three overridden
     baselines, which have no golden, a CPU run of the port of the same
     override at smoke width: arrivals do not depend on width); each
     applied arrival committed on its own (barrier round) must launch the
     run's single-arrival kernels once, each fused run of K >= 2 arrivals
     exactly one multi sweep (plus one multi-Gram sweep for HeLoCo), and
     no other kernel may launch (a crashed worker's lost round launches
     nothing); every tensor must stay on the card, and the eval losses
     must be finite. Last, ``paper_hetero_severe`` once more with the
     engine's server swapped for a per-leaf kernel server
     (``Synchronizer(packed=False, use_kernel=True)``): arrivals equal to the
     golden's, block_stats and correct_apply launched once per leaf of each
     applied arrival and no other kernel, evals within 1e-3 of the packed
     run's. Telemetry: ``paper_hetero_severe``, ``fedbuff`` with
     ``commit_batch=4``, ``hogwild_rampup`` and ``int8_dylu`` each run
     four times more, in turns without, with, with and without a
     ``TelemetryRecorder`` (a live JSONL sink under build/telemetry, a
     "runtime" record per commit): the same launch counts, each held to
     the contract above, the final parameters, momentum and accumulator
     bit for bit, the same arrivals and evals, finite stats on every
     arrival record, and the stream decoded by the port's
     ``StreamDecoder`` with nothing skipped; one line per scenario gives
     the server and commit ms per arrival of each run. Run control
     (``run_control_phase``): ``paper_hetero_severe`` and
     ``delayed_nesterov`` checkpointed every 6 commits, the file at 6 held
     bit for bit to the state it saved and to its recomputed content hash,
     restored into a fresh engine bit for bit and run on to 12 (each
     applied arrival launching the run's kernels once, arrivals equal to
     the same save and resume on the CPU at smoke width), with the save,
     restore and ``AsyncSaver`` ms and the MB written; then the ``smoke``
     sweep with the full-width model (8 cells, each stopping where the
     same cell stops on the CPU, the report written). The wall-clock
     phase (``wallclock_phase``): ``wallclock_hetero``, the three method
     twins, ``chaos_lossy``, ``chaos_corrupt`` and ``int8_dylu`` on the
     deterministic threaded runtime at full width, each beside a sim run
     of its config from the same bits: the golden's and the sim's
     arrivals, the final parameters' fingerprint within rtol 1e-5 and
     atol 1e-6 of the sim's (the digests' equality printed), the chaos
     twins with ``wallclock_hetero``'s digest and their fault counters
     non-zero, each applied arrival launching the server's kernels once
     and each worker round (from its thread) the int8 sweeps once, with
     ``stats_summary()``'s numbers; ``payload_crc`` timed alone on one
     full-width pseudo-gradient, and ``wallclock_hetero`` once more with
     the checksum a constant (what it costs end to end); then
     ``wallclock_free`` and ``chaos_partition`` inside the goldens' bands
     at smoke width and at full width (every arrival committed, finite
     evals, the partitioned worker declared dead). The socket phase
     (``socket_phase``): ``socket_hetero``, ``int8_dylu`` and
     ``chaos_lossy`` on the deterministic runtime over spawned worker
     processes at full width, each beside its sim twin and its threaded
     twin from the same bits, then ``socket_hetero`` with worker 0's process
     SIGKILLed after 3 commits: the golden's and the sim's arrivals, the
     fingerprint within TOL_FP of the sim's (digest equality printed),
     ``chaos_lossy`` with ``socket_hetero``'s digest, the server's kernels
     once per applied arrival in the parent and the int8 sweeps once per
     round in the children (their own counts, from their stats frames);
     ms per arrival beside both twins, the spawn and rendezvous seconds, the
     wire's pieces on one full-width task and result; then
     ``chaos_partition`` over processes in free mode at full width, twice,
     each with a recorder (so the children ship obs frames), the
     partitioned worker declared dead, the deaths outside the partition
     and the host's memory after the run printed. The obs phase
     (``obs_phase``): ``paper_hetero_severe`` on the simulator,
     ``wallclock_hetero`` on the threaded runtime and ``socket_hetero``
     over worker processes at full width, each traced by
     a ``SpanTracer`` with a live telemetry stream, held to its untraced
     run of the phases before (the golden's arrivals, the same digest and
     launches, a valid trace, a process row and a final obs report from
     every child, the console's and the dashboard's panels), with the
     ms per arrival traced and untraced and each span's ms per arrival;
  4. the single-tensor path: ``kernels.ops.outer_update_block`` over the 43
     leaves of a full-width state, one outer_update_2d launch a leaf, each
     bit for bit against the plain version;
  5. a replay: eight pseudo-gradients from inner rounds on the card, at
     staleness up to 3 with ``drop_stale_after=2``, fed to a packed server
     and a per-leaf kernel server, both with telemetry: the same arrivals
     dropped, p and m within 3e-5 after every arrival, and each arrival's
     moments (the packed sweep's per-row stats output, summed) within
     TOL_SUM of the per-leaf server's ``reference_moments``;
  6. the per-tensor int8 entry points: ``kernels.ops.quantize_block`` and
     ``dequantize_block`` over the 43 leaves of a full-width state, one
     absmax, quantize_2d and dequantize_2d launch a leaf, each leaf bit for
     bit against ``kernels/ref.py``'s ``ref_quantize``/``ref_dequantize``;
     the pass's device and host time (the three kernels themselves are held
     to their plain versions in the kernel phase, and timed there with
     their inputs rotating over copies that exceed L2, on the largest leaf: a
     block on exact .5 ties, an all-zero tensor, a clipped element, a NaN,
     an odd and an unaligned length, lengths 15-17, q offset by 1-3 bytes,
     quotients next to half-integers;
     flash_attention_fwd there too, bf16 within 2e-2 and fp32
     within 2e-5 of its plain version at the serve shape (BH 32, S 1024,
     D 32), the prompt-128 shape, at (BH 16, S 4096, D 128) and on a
     rectangular 128 x 384, at padded widths: D 16 (ragged 200), 80
     (128 x 384) and 256 (384 x 128), and at each family's serve shape
     (D 64, 80, 128, 256), causal and not, timed beside
     ``scaled_dot_product_attention``, with each case's ratio to it and
     its share of the bound);
  7. serving: full-width tinygpt-15m in its compute dtype (bf16), prefill
     of 4 prompts of 128 tokens and 24 greedy tokens over the KV cache,
     then one prefill at 1024 (each timed 5 times, medians, and behind a
     hold for the device's share): each prefill launches
     flash_attention_fwd once per layer (4) and nothing else, decode
     launches no kernel, logits are finite; fed the kernel path's greedy
     tokens, the plain path (the flash kernel's plain version, on the card)
     gives logits within 2e-2 of their largest |value| at every step, and
     each greedy token is its argmax or tied with it within one bf16 step;
  8. the model families (``families_phase``), bf16: serving at full
     width, qwen2-7b, granite-moe-1b-a400m, paligemma-3b (256 patches,
     then the prompt), hubert-xlarge (frame features, prefill only),
     zamba2-2.7b (54 Mamba2 layers, its shared attention block at 9 sites)
     and xlstm-125m (12 mLSTM/sLSTM blocks) at full depth, granite-3-8b,
     command-r-35b, starcoder2-15b and llama4-scout-17b-a16e cut to 2
     layers, each drawn on the card and freed before the next: 4 prompts
     of 128 tokens and 24 greedy tokens (3 runs, medians), each prefill one
     flash_attention_fwd launch an attention layer or shared-block site
     (xlstm none) and nothing else, decode none, finite logits, both paths
     held to each other as in 7 (xlstm has no kernel path: it says so);
     prefill ms, decode ms a token, peak memory and init seconds printed.
     Then ``paper_hetero_severe`` at full width with granite-moe cut to 4
     of 24 layers, xlstm-125m whole and zamba2-2.7b cut to 12 of 54: the
     golden's arrivals, each applied arrival one packed_row_stats and one
     packed_correct_outer launch and nothing else, finite evals, every
     tensor on the card;
  9. the dist path (``dist_phase``, ``--only dist``): the sharding rules
     over full-width granite-moe-1b-a400m and qwen2-7b on meta tensors;
     ``dist.steps``' train step on granite-moe at full width and 4 of 24
     layers, batch 4 x 128, inside a one-card mesh: the dry-run plan's
     grad_accum=4 in bf16; with one microbatch's tokens a dispatch group,
     grad_accum=4 held to grad_accum=1 on the same batch in fp32 (loss
     within rtol 1e-5, the step under ``step_rule``) and in bf16 (within
     BF16_FACTOR times bf16's own distance from fp32); the
     multi-pod step with two pods on the card (identical pods bit for bit
     equal, different batches part, pod 0 the single step's bits); the
     prefill and decode steps bit-equal to ``Model``'s on full-width
     tinygpt-15m with 4 flash launches a prefill; the HeLoCo outer
     exchange on granite-moe at full width and depth (1.33 B parameters),
     without and with int8: block_stats, correct_apply and outer_update_2d
     (and absmax, quantize_2d, dequantize_2d) once a leaf and nothing
     else, held leaf by leaf to the plain path on the card (TOL_DIST of
     each leaf's largest |value|, no branch flip, the int8 round trip bit
     for bit); the phase's seconds and peak device memory;
 10. the training memory plan (``plan_phase``, ``--only plan``) at
     train_4k's 4096 tokens, the card's name and power limit beside every
     line: granite-moe-1b-a400m's attention alone, the chunked Function
     against the plain attend in fp32 and bf16 (saved bytes, peaks,
     parity); a full-depth (24-layer) granite-moe bf16 train step at 4 x
     4096 through ``dist.steps.make_train_step`` with the plan's
     grad_accum and q_chunk and remat on (finite, seconds, peak);
     ``paper_hetero_severe`` through the engine with granite-moe at 4
     layers and 4096 tokens (the golden's arrivals, one packed_row_stats
     and one packed_correct_outer an applied arrival); zamba2-2.7b at 12
     layers, 8 x 4096, remat on against off (loss and gradients
     bit-equal, else within TOL_PLAN_GRAD);
 11. print the card's name and power limit, the kernel summary line, and
     the ``{"ok": true, ...}`` line last.

Without a CUDA device, or without the rest of the repository, it exits
non-zero before printing any result: run alone, in a directory that holds
no ``src/repro_torch``, it prints why to stderr and exits 3.
"""
from __future__ import annotations

import gc
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# Datasheet peaks (NVIDIA H100 data sheet; dense, no sparsity): memory
# bytes/s, fp32 (non-tensor-core) flop/s, bf16 and TF32 tensor-core flop/s,
# by product name fragment.
PEAKS = {"PCIe": (2.0e12, 51e12, 756e12, 378e12),
         "NVL": (3.9e12, 60e12, 835e12, 417e12),
         "": (3.35e12, 67e12, 989e12, 495e12)}

ITERS = 30
# time_ms's hold before each timed run: ~0.5 ms at the H100's ~2 GHz clock;
# ~25 ms for a whole prefill or decode step or a 43-leaf pass, whose
# dispatch takes milliseconds
HOLD_CYCLES = 1_000_000
# the H100's L2 (50 MB): timed inputs rotate over copies larger than it
L2_BYTES = 50e6
SERVE_HOLD_CYCLES = 50_000_000
# the batched commit path's flush depth in the kernel phase
K_MULTI = 4
# the reference's per-arrival band between the per-leaf and packed servers
# (tests/test_packed.py:163-168), and the full-width band of eval losses
# between two runs of the same trace (the slow lane's)
TOL_SERVERS = 3e-5
TOL_EVAL = 1e-3
# per-row / per-block sums (fp32, another summation order): each entry within
# TOL_SUM of its own scale, sqrt(uu*vv) for a dot product (Cauchy-Schwarz
# bounds it) and the value itself for a sum of squares
TOL_SUM = 1e-5

# The slice: each scenario at full width, batch 4 x 128 (the launcher's
# --full-width), with the overrides named, the kernels each arrival that
# commits on its own (barrier round) launches once, and the kernels each
# fused run of K >= 2 arrivals launches once. None of these runs drops an
# arrival, so int8_dylu's worker rounds (three compression sweeps each)
# are its applied arrivals too.
HELOCO = ("packed_row_stats", "packed_correct_outer")
HELOCO_MULTI = ("packed_multi_gram", "packed_multi_correct_outer")
INT8 = ("packed_rowabs", "packed_quant", "packed_dequant")
ACC, ACC_MULTI = ("packed_correct_outer_acc",), (
    "packed_multi_correct_outer_acc",)
BATCHED = {"commit_batch": 4}
SLICE = (
    ("paper_hetero_severe", {}, HELOCO, ()),
    ("delayed_nesterov", {}, ACC, ()),
    ("fedbuff", {}, ACC, ()),
    ("dcasgd", {}, ("packed_correct_outer_quad",), ()),
    ("poly_stale", {}, ("packed_correct_outer",), ()),
    ("sync_baseline", {}, ("packed_correct_outer",), ()),
    ("noniid_dirichlet", {}, HELOCO, ()),
    ("crash_rejoin", {}, HELOCO, ()),
    ("elastic_membership", {}, HELOCO, ()),
    ("int8_dylu", {}, HELOCO + INT8, ()),
    ("hogwild_rampup", {}, HELOCO, HELOCO_MULTI),
    ("trace_paced", {}, HELOCO, HELOCO_MULTI),
    ("fedbuff", BATCHED, ACC, ACC_MULTI),
    ("delayed_nesterov", BATCHED, ACC, ACC_MULTI),
    ("dcasgd", BATCHED, ("packed_correct_outer_quad",),
     ("packed_multi_correct_outer_quad",)),
    # the decentralized topologies: per-worker replicas and a pairwise peer
    # mean in plain torch, no kernel (as the reference computes them)
    ("gossip_ring", {}, (), ()),
    ("gossip_random", {}, (), ()),
)
# --only telemetry: timed commit calls of each server
TELEMETRY_REPS = 30
# the telemetry phase: each run with a TelemetryRecorder against the same
# run without one (same launches, same parameter bits)
TELEMETRY = (
    ("paper_hetero_severe", {}, HELOCO, ()),
    ("fedbuff", BATCHED, ACC, ACC_MULTI),
    ("hogwild_rampup", {}, HELOCO, HELOCO_MULTI),
    ("int8_dylu", {}, HELOCO + INT8, ()),
)
# the run-control phase: each run checkpointed every RC_CKPT commits at full
# width and resumed from the first checkpoint (delayed_nesterov's file holds
# its accumulator too), with the kernels each applied arrival launches once
RC_CKPT = 6
RUN_CONTROL = (("paper_hetero_severe", HELOCO), ("delayed_nesterov", ACC))
# the wall-clock phase: each deterministic run on the threaded runtime at
# full width beside a sim run of the same config from the same bits (its
# twin: engine "sim", no faults), with the kernels each applied arrival
# launches once; int8_dylu's int8 sweeps run in the worker threads, once a
# round. The chaos twins must commit wallclock_hetero's bits.
WALLCLOCK = (
    ("wallclock_hetero", {}, HELOCO),
    ("delayed_nesterov_wallclock", {}, ACC),
    ("fedbuff_wallclock", {}, ACC),
    ("dcasgd_wallclock", {}, ("packed_correct_outer_quad",)),
    ("chaos_lossy", {}, HELOCO),
    ("chaos_corrupt", {}, HELOCO),
    ("int8_dylu", {"engine": "wallclock"}, HELOCO + INT8),
)
CHAOS_TWINS = {"chaos_lossy": ("injected_drops", "retries"),
               "chaos_corrupt": ("injected_corruptions", "checksum_rejects")}
# the free-running scenarios, and chaos_partition's black-holed worker
WALLCLOCK_FREE = ("wallclock_free", "chaos_partition")
PARTITIONED = 3
# trace._cmp_fingerprint's band between the runtime's and the sim's final
# parameters (per-leaf sum and l2)
TOL_FP = dict(rtol=1e-5, atol=1e-6)
# payload_crc's host time on one full-width pseudo-gradient: median of
CRC_REPS = 5
# the socket phase: each deterministic run over worker processes at full
# width beside its sim twin and its threaded twin from the same bits, with
# the kernels each applied arrival launches once in the parent and those
# each round launches once in the children; chaos_lossy must commit
# socket_hetero's bits
SOCKET = (
    ("socket_hetero", {}, HELOCO, ()),
    ("int8_dylu", {"engine": "wallclock", "transport": "socket"}, HELOCO,
     INT8),
    ("chaos_lossy", {"transport": "socket"}, HELOCO, ()),
)
# socket_hetero once more with worker 0's process SIGKILLed after this many
# commits, and chaos_partition over processes in free mode this many times
SOCKET_KILL_AFTER = 3
SOCKET_PARTITION_RUNS = 2
# the wire pieces' host times on one full-width task and result: median of
WIRE_REPS = 5
# the obs phase: each run traced with a live telemetry sink on its engine
# beside its untraced twin, with the kernels each applied arrival launches
OBS = (("paper_hetero_severe", "sim"),
       ("wallclock_hetero", "threaded runtime"),
       ("socket_hetero", "worker processes"))
REPLACES = {
    "packed_row_stats": "src/repro/kernels/packed.py:59",
    "packed_correct_outer": "src/repro/kernels/packed.py:175",
    "packed_correct_outer_quad": "src/repro/kernels/packed.py:262",
    "packed_correct_outer_acc": "src/repro/kernels/packed.py:355",
    "packed_rowabs": "src/repro/kernels/packed.py:710",
    "packed_quant": "src/repro/kernels/packed.py:731",
    "packed_dequant": "src/repro/kernels/packed.py:753",
    "packed_multi_correct_outer": "src/repro/kernels/packed.py:461",
    "packed_multi_correct_outer_quad": "src/repro/kernels/packed.py:529",
    "packed_multi_correct_outer_acc": "src/repro/kernels/packed.py:603",
    "packed_multi_gram": "src/repro/kernels/packed.py:664",
    "block_stats": "src/repro/kernels/heloco_correct.py:38",
    "correct_apply": "src/repro/kernels/heloco_correct.py:63",
    "outer_update_2d": "src/repro/kernels/outer_update.py:32",
    "absmax": "src/repro/kernels/quantize.py:19",
    "quantize_2d": "src/repro/kernels/quantize.py:45",
    "dequantize_2d": "src/repro/kernels/quantize.py:63",
    "flash_attention_fwd": "src/repro/kernels/flash_attention.py:71",
}
SOURCE = {**dict.fromkeys(("block_stats", "correct_apply", "outer_update_2d"),
                          "leaf"),
          **dict.fromkeys(("absmax", "quantize_2d", "dequantize_2d"),
                          "quantize"),
          "flash_attention_fwd": "flash_attention"}
INT8_KERNELS = ("absmax", "quantize_2d", "dequantize_2d")
# the reference's flash tolerances (tests/test_kernels.py:125-160), and the
# prefill logits of the kernel path against the plain path's, as a share of
# their largest |value| (bf16 compute; tests/test_torch_serve.py's bound)
TOL_FLASH = {"float32": 2e-5, "bfloat16": 2e-2}
TOL_LOGITS = 2e-2
# flash_attention_fwd's cases: (BH, Sq, Skv, D), the serve shape first
# (batch 4 x 8 heads, prompt 1024, tinygpt's head dim), the serve phase's
# other prefill (prompt 128), and the rectangular one of the reference's
# tests with q_chunk 32
FLASH_SHAPES = ((32, 1024, 1024, 32), (32, 128, 128, 32),
                (16, 4096, 4096, 128), (2, 128, 384, 64))
# head dims the kernel runs at a padded width (16: every smoke config, 80:
# hubert, 256: paligemma), ragged, Sq < Skv and Sq > Skv; then each
# family's prefill at
# the families phase's serve shape (batch 4 x heads, prompt 128; paligemma
# 256 patches + 128 tokens), by D: granite-moe 64, hubert 80 (the encoder:
# its own case is not causal), qwen2-7b 128 (the other 128-wide configs
# differ in BH only), paligemma 256
FLASH_PADDED_SHAPES = ((16, 200, 200, 16), (2, 128, 384, 80),
                       (2, 384, 128, 256))
FLASH_FAMILY_SHAPES = {"granite-moe-1b-a400m": (64, 128, 128, 64),
                       "hubert-xlarge": (64, 128, 128, 80),
                       "zamba2-2.7b": (128, 128, 128, 80),
                       "qwen2-7b": (112, 128, 128, 128),
                       "paligemma-3b": (32, 384, 384, 256)}
# the flash kernels' mangled names (type, padded width, 64-row q tiles per
# CTA); and a SASS line's opcode
FLASH_KERNEL = re.compile(r"flash_kernelI(13__nv_bfloat16|f)Li(\d+)ELi(\d)E")
# the per-tensor int8 sweeps' kernel names in the compiler's report and SASS
INT8_SWEEP = re.compile(r"\d(quant_kernel|dequant_kernel)E")
# the per-leaf elementwise sweeps' kernel names (correct_apply's template
# argument: stacked blocks or not)
LEAF_SWEEP = re.compile(r"\d(correct_apply_kernel|outer_update_kernel)"
                        r"(?:ILb([01])E)?E")
SASS_OP = re.compile(
    r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")
# the serve phase: batch x prompt, greedy tokens, then one long prefill;
# each timed as the median of ``repeats`` runs
SERVE = dict(batch=4, prompt=128, gen=24, long_prompt=1024, repeats=5)
# the families phase: each family's config at full width, at full depth
# (None) or cut to the layers given (35 B and 109 B do not fit one card;
# the others at 2 layers to keep the phase short), served at SERVE's batch,
# prompt and tokens, timed as the median of FAMILY_REPEATS runs; the
# recurrent families last (zamba2-2.7b, 9.3 GB in fp32, whole)
FAMILIES = (("qwen2-7b", None), ("granite-moe-1b-a400m", None),
            ("paligemma-3b", None), ("hubert-xlarge", None),
            ("granite-3-8b", 2), ("command-r-35b", 2),
            ("starcoder2-15b", 2), ("llama4-scout-17b-a16e", 2),
            ("zamba2-2.7b", None), ("xlstm-125m", None))
FAMILY_REPEATS = 3
# the families' band: at least TOL_LOGITS, else this many times the
# reference arithmetic's own distance from the plain path (hold_to_plain)
FLOOR_FACTOR = 1.5
# and its training runs: (scenario, arch, layers), at full width:
# granite-moe cut to 4 of its 24 layers, xlstm-125m whole, zamba2-2.7b cut
# to 12 of its 54 layers (two super blocks: the shared block's gradient
# sums over two sites)
FAMILY_TRAIN = (("paper_hetero_severe", "granite-moe-1b-a400m", 4),
                ("paper_hetero_severe", "xlstm-125m", None),
                ("paper_hetero_severe", "zamba2-2.7b", 12))
# tinygpt-15m's 43 leaves: the per-leaf HeLoCo arrival launches the two
# correction kernels once per leaf
N_LEAVES = 43
PER_LEAF = {"block_stats": N_LEAVES, "correct_apply": N_LEAVES}
# (s_i, worker) of the replay's eight arrivals at t = 0..7: staleness 0, 1,
# 2, 3, 2, 3, 1, 3; with drop_stale_after=2 those at t = 3, 5 and 7 drop
REPLAY = ((0, 0), (0, 1), (0, 2), (0, 3), (2, 0), (2, 1), (5, 2), (4, 3))
# (am, bm, ab, cg, cm, ca) of a delayed-Nesterov boundary arrival and of a
# FedBuff non-boundary one (cg = 0: the parameters come back unchanged)
ACC_TABLES = {"dn_boundary": (0.9, 0.025, 0.0, 1.0, 0.9, 0.0),
              "fedbuff_hold": (1.0, 0.0, 1.0, 0.0, 0.0, 0.0)}
# the multi accumulator sweep's per-delta table: delayed-Nesterov
# non-boundary rows, the second one a boundary
DN_HOLD = (1.0, 0.0, 1.0, 1.0, 0.9, 0.0)
MULTI_ACC_TABLE = tuple(zip(*[DN_HOLD, ACC_TABLES["dn_boundary"]]
                             + [DN_HOLD] * (K_MULTI - 2)))


def peaks_for(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return val
    raise AssertionError("unreachable")


def time_ms(fn, iters=ITERS, warmup=3, hold=None):
    """Median device milliseconds of ``fn`` over ``iters`` runs, each
    bracketed by its own CUDA events. Before each run the stream is held
    busy for about 0.5 ms (``torch.cuda._sleep``), longer than the host
    takes to dispatch a call of a few launches, so the events time the
    device's work and not the host's dispatch gaps; a call whose dispatch
    outlasts the hold (a loop of many launches) is timed with its host
    gaps, unless ``hold`` (cycles) outlasts it. Runs follow each other as
    in a stream of calls: the writes of one drain from L2 during the next.
    Inputs larger than the 50 MB L2 are read from memory; a caller whose
    inputs fit L2 passes an ``fn`` that rotates over copies of them
    (``rotating``), or the run reads what the run before left in L2."""
    import torch
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(hold or HOLD_CYCLES)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def rotating(t, copies):
    """A callable that returns ``t`` and ``copies - 1`` clones of it in
    turn: timed calls that take their input from it find it in memory, not
    in L2, when the copies together exceed the L2."""
    ring = itertools.cycle([t] + [t.clone() for _ in range(copies - 1)])
    return lambda: next(ring)


def cold(t):
    """``rotating(t, n)`` with the fewest copies (at least 2) that together
    hold more than twice the L2, so that each timed call reads ``t`` from
    memory whatever the call before it left in L2."""
    return rotating(t, max(2, math.ceil(2 * L2_BYTES / (t.numel()
                                                        * t.element_size()))
                           + 1))


def sum_errors(got, want):
    """Entry by entry, the absolute difference of two stacks of rows of
    (dot, uu, vv[, more sums of squares]) and the scale TOL_SUM is taken
    of: sqrt(uu*vv) for the dot product, the value itself for a sum of
    squares."""
    got = got.reshape(-1, got.shape[-1]).double()
    want = want.reshape(-1, want.shape[-1]).double()
    scale = want.abs()
    scale[:, 0] = (want[:, 1] * want[:, 2]).sqrt()
    return got, want, (got - want).abs(), scale


def rel_sum_err(got, want):
    """The largest difference over its own scale, the quantity check_sums
    holds to TOL_SUM (0 where both are 0)."""
    _, _, diff, scale = sum_errors(got, want)
    return (diff / scale).nan_to_num(nan=0.0).max().item()


def check_sums(name, got, want):
    """Rows of (dot, uu, vv[, more sums of squares]) held entry by entry to
    TOL_SUM of their own scale (a (K, R, n) stack row by row). Returns the
    largest absolute difference."""
    got, want, diff, scale = sum_errors(got, want)
    bad = (diff > TOL_SUM * scale).nonzero()
    assert not len(bad), (f"{name}: {len(bad)} sums off, first at "
                          f"{bad[0].tolist()}: got {got[tuple(bad[0])].item()} "
                          f"want {want[tuple(bad[0])].item()}")
    return diff.max().item()


def check_update(name, torch, fn, state, want, stats_want):
    """``fn(*state, **kw)`` against the plain version's outputs ``want``:
    plain and stats variants and the in-place update bit for bit, the stats
    within TOL_SUM. Returns the largest stats difference."""
    got = fn(*state)
    with_stats = fn(*state, with_stats=True)
    copies = tuple(t.clone() for t in state)
    fn(*copies, out=copies)
    torch.cuda.synchronize()
    for label, outs in (("kernel", got), ("stats variant", with_stats),
                        ("in-place", copies)):
        for i, (g, w) in enumerate(zip(outs, want)):
            assert torch.equal(g, w), (
                f"{name} {label} output {i} differs from the plain version by "
                f"{(g - w).abs().max().item()}")
    return check_sums(f"{name} stats", with_stats[-1], stats_want)


def bound_of(bw, flops):
    """``bound(nbytes, nflops, peak=None)``: (ms, what bounds it), bytes over
    the memory rate ``bw`` against operations over the peak (fp32 FMA,
    ``flops``, unless ``peak`` names another, the bf16 tensor cores')."""
    def bound(nbytes, nflops, peak=None):
        t_b, t_f = nbytes / bw, nflops / (peak or flops)
        return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")
    return bound


def kernel_phase(torch, pk, compression, layout, specs, dev, bw, flops,
                 bf16_flops, tf32_flops):
    from repro_torch.configs.base import HeLoCoConfig
    R, B = layout.n_rows, layout.n_blocks
    gen = torch.Generator(device=dev).manual_seed(0)
    d, m, p, b = (torch.randn((R, 128), generator=gen, device=dev)
                  for _ in range(4))
    cu = torch.rand(B, generator=gen, device=dev) + 0.5
    cv = torch.rand(B, generator=gen, device=dev) - 0.5
    cq = -0.3 * torch.rand(B, generator=gen, device=dev)
    rb, _ = layout.device_tables(dev)
    eta, mu, rho = 0.7, 0.9, 0.5
    f4 = 4

    # -- packed_row_stats
    got = pk.packed_row_stats(d, m)
    want = pk.packed_row_stats_ref(d, m)
    torch.cuda.synchronize()
    err_rs = check_sums("packed_row_stats", got, want)
    blocks = pk.packed_stats(d, m, layout)
    again = pk.packed_stats(d, m, layout)
    assert torch.equal(blocks, again), "packed_stats is not deterministic"
    plain_blocks = torch.stack([want[a:b].sum(0)
                                for a, b in layout.block_row_ranges])
    err_ps = check_sums("packed_stats", blocks, plain_blocks)

    # -- the fused sweeps: plain, stats and in-place variants
    def co(*s, **kw):
        return pk.packed_correct_outer(*s, d, cu, cv, rb, eta, mu, rho, **kw)

    def quad(*s, **kw):
        return pk.packed_correct_outer_quad(*s, d, cu, cv, cq, rb, 0.07, mu,
                                            rho, **kw)

    def acc(table):
        def call(*s, **kw):
            return pk.packed_correct_outer_acc(*s, d, cu, cv, rb, eta, rho,
                                               *ACC_TABLES[table], **kw)
        return call

    ref = pk.packed_correct_outer_ref(p, m, d, cu, cv, rb, eta, mu, rho,
                                      with_stats=True)
    err_st = check_update("packed_correct_outer", torch, co, (p, m), ref[:2],
                          ref[2])
    ref = pk.packed_correct_outer_quad_ref(p, m, d, cu, cv, cq, rb, 0.07, mu,
                                           rho, with_stats=True)
    err_q = check_update("packed_correct_outer_quad", torch, quad, (p, m),
                         ref[:2], ref[2])
    err_a = 0.0
    for table in ACC_TABLES:
        ref = pk.packed_correct_outer_acc_ref(p, m, b, d, cu, cv, rb, eta,
                                              rho, *ACC_TABLES[table],
                                              with_stats=True)
        err_a = max(err_a, check_update(f"packed_correct_outer_acc[{table}]",
                                        torch, acc(table), (p, m, b),
                                        ref[:3], ref[3]))
    assert torch.equal(acc("fedbuff_hold")(p, m, b)[0], p), \
        "a FedBuff non-boundary arrival moved the parameters"
    print(f"kernels agree: row_stats err {err_rs:.3e}, block stats err "
          f"{err_ps:.3e}; correct_outer, quad and acc (both tables) "
          f"bit-identical to their plain versions in p'/m'/b', plain, stats "
          f"and in place; stats err {max(err_st, err_q, err_a):.3e} (each "
          f"sum within {TOL_SUM} of its own scale)")

    # -- the int8 sweeps, on the scales the compression path computes
    x, scale = int8_inputs(torch, compression, d, layout, dev)
    absmax = pk.packed_rowabs(x)
    q = pk.packed_quant(x, scale, rb)
    dec = pk.packed_dequant(q, scale, rb)
    torch.cuda.synchronize()
    for name, got, want in (
            ("packed_rowabs", absmax, pk.packed_rowabs_ref(x)),
            ("packed_quant", q, pk.packed_quant_ref(x, scale, rb)),
            ("packed_dequant", dec, pk.packed_dequant_ref(q, scale, rb))):
        assert got.dtype == want.dtype and torch.equal(got, want), (
            f"{name} differs from the plain version in "
            f"{(got != want).sum().item()} entries")
    ties = layout.block_row_ranges[0]
    assert scale[0].item() == 0.5 and torch.equal(
        q[ties[0], 1:5].cpu(), torch.tensor([-62, -62, -60, -60],
                                            dtype=torch.int8)), \
        "packed_quant does not round half to even"
    assert (q[slice(*layout.block_row_ranges[-1])].abs() == 127).any(), \
        "the clipped block has no clipped value"
    print("int8 sweeps agree: rowabs, quant and dequant bit-identical to "
          "their plain versions (ties to even, zero block, clip)")

    bound = bound_of(bw, flops)
    multi_rows = multi_phase(torch, pk, layout, dev, p, m, b, bound)
    leaf_rows = leaf_phase(torch, specs, dev, bound)
    int8_rows = int8_kernel_phase(torch, specs, dev, bound)
    # fp32 runs 3xTF32: three TF32 products per operation, or one fp32 FMA
    # where that would be faster
    flash_rows = flash_phase(torch, dev, bound, bf16_flops,
                             max(flops, tf32_flops / 3))

    n = R * 128
    plane, table_bytes = n * f4, R * 4
    outs = (torch.empty_like(p), torch.empty_like(m), torch.empty_like(b))
    # the library yardsticks of the int8 sweeps, timed only: one call each
    # for rowabs, quant and dequant (int8 times fp32 promotes to fp32), and
    # one fake-quantize call for the quant + dequant pair, set against the
    # pair's sum. quant's is torch.quantize_per_channel on the same (R, 128)
    # x with its per-row scales, made on the card before the timing; qint8
    # clamps at -128 where the kernel clips at -127 (the last block's clip)
    s_rows = scale[rb.long()].contiguous()
    zeros = torch.zeros(R, dtype=torch.int32, device=dev)
    s_double, row_zeros = s_rows.double(), zeros.long()
    # every timed call, the plain versions' and the yardsticks' too, takes
    # its large inputs from rotations of copies that exceed L2 (``cold``)
    ds, ms_, ps, bs, xs, qs = (cold(t) for t in (d, m, p, b, x, q))
    per_channel, pc_call, pc_differ = quantized_yardstick(
        lambda: torch.quantize_per_channel(xs(), s_double, row_zeros, 0,
                                           torch.qint8),
        "torch.quantize_per_channel(x, s[:, None], 0, 0, torch.qint8)", q)
    library = {
        "packed_rowabs": lambda: torch.linalg.vector_norm(
            xs(), float("inf"), dim=1),
        "packed_quant": per_channel,
        "packed_dequant": lambda: torch.mul(qs(), s_rows[:, None]),
    }
    calls = {
        "packed_rowabs": "torch.linalg.vector_norm(x, inf, dim=1)",
        "packed_quant": pc_call,
        "packed_dequant": "torch.mul(q, s[:, None])"}
    assert torch.equal(library["packed_dequant"](),
                       pk.packed_dequant_ref(q, scale, rb)), \
        "the dequant yardstick computes another function"
    pair = {"pair_ms": time_ms(lambda: pk.packed_dequant(
                pk.packed_quant(xs(), scale, rb), scale, rb)),
            "library_pair_ms": time_ms(
                lambda: torch.fake_quantize_per_channel_affine(
                    xs(), s_rows, zeros, 0, -127, 127)),
            "library_pair_call": "torch.fake_quantize_per_channel_affine"}
    int8_bytes = plane + n + table_bytes + B * f4   # fp32 + int8 + map/scales
    rows = []
    for name, fn, plain, nbytes, nflops, err in (
            ("packed_row_stats", lambda: pk.packed_row_stats(ds(), ms_()),
             lambda: pk.packed_row_stats_ref(ds(), ms_()),
             2 * plane + R * 3 * f4, 6 * n, err_rs),
            ("packed_correct_outer",
             lambda: pk.packed_correct_outer(ps(), ms_(), ds(), cu, cv, rb,
                                             eta, mu, rho, out=outs[:2]),
             lambda: pk.packed_correct_outer_ref(ps(), ms_(), ds(), cu, cv, rb,
                                                 eta, mu, rho),
             5 * plane + table_bytes + 2 * B * f4, 11 * n, 0.0),
            ("packed_correct_outer_quad",
             lambda: pk.packed_correct_outer_quad(
                 ps(), ms_(), ds(), cu, cv, cq, rb, 0.07, mu, rho,
                 out=outs[:2]),
             lambda: pk.packed_correct_outer_quad_ref(
                 ps(), ms_(), ds(), cu, cv, cq, rb, 0.07, mu, rho),
             5 * plane + table_bytes + 3 * B * f4, 15 * n, 0.0),
            ("packed_correct_outer_acc",
             lambda: pk.packed_correct_outer_acc(
                 ps(), ms_(), bs(), ds(), cu, cv, rb, eta, rho,
                 *ACC_TABLES["dn_boundary"], out=outs),
             lambda: pk.packed_correct_outer_acc_ref(
                 ps(), ms_(), bs(), ds(), cu, cv, rb, eta, rho,
                 *ACC_TABLES["dn_boundary"]),
             7 * plane + table_bytes + 2 * B * f4, 16 * n, 0.0),
            ("packed_rowabs", lambda: pk.packed_rowabs(xs()),
             lambda: pk.packed_rowabs_ref(xs()), plane + R * f4, 2 * n, 0.0),
            ("packed_quant", lambda: pk.packed_quant(xs(), scale, rb),
             lambda: pk.packed_quant_ref(xs(), scale, rb), int8_bytes, 5 * n,
             0.0),
            ("packed_dequant", lambda: pk.packed_dequant(qs(), scale, rb),
             lambda: pk.packed_dequant_ref(qs(), scale, rb), int8_bytes,
             2 * n, 0.0)):
        ms, plain_ms = time_ms(fn), time_ms(plain)
        b_ms, by = bound(nbytes, nflops)
        lib = library.get(name)
        rows.append({"name": name, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": by, "max_abs_err": err,
                     "library_ms": time_ms(lib) if lib else None,
                     "library_call": calls.get(name),
                     **(pair if name in ("packed_quant", "packed_dequant")
                        else {}),
                     **({"library_int8_differ": pc_differ}
                        if name == "packed_quant" else {}),
                     "bytes": nbytes, "flops": nflops, "R": R, "blocks": B})
    # off the main path or around the kernels: reported, not in the summary
    st_bytes = 5 * plane + table_bytes + 2 * B * f4 + R * 4 * f4
    print(json.dumps({
        "kernel": "packed_correct_outer(with_stats)",
        "kernel_ms": time_ms(lambda: pk.packed_correct_outer(
            ps(), ms_(), ds(), cu, cv, rb, eta, mu, rho, with_stats=True,
            out=outs[:2])),
        "plain_ms": time_ms(lambda: pk.packed_correct_outer_ref(
            ps(), ms_(), ds(), cu, cv, rb, eta, mu, rho, with_stats=True)),
        "bound_ms": bound(st_bytes, 17 * n)[0], "bytes": st_bytes,
        "on_main_path": False}))
    print(json.dumps({
        "kernel": "packed_correct_outer_acc[fedbuff_hold]",
        "kernel_ms": time_ms(lambda: pk.packed_correct_outer_acc(
            ps(), ms_(), bs(), ds(), cu, cv, rb, eta, rho,
            *ACC_TABLES["fedbuff_hold"], out=outs)),
        "on_main_path": True}))
    parts = pk.packed_row_stats(d, m)
    seg = layout.device_tables(dev)[1]
    print(json.dumps({
        "op": "packed_int8_roundtrip = rowabs + block max + scale + quant + "
              "dequant",
        "ms": time_ms(lambda: compression.packed_int8_roundtrip(xs(),
                                                                layout)),
        **pair}))
    print(json.dumps({
        "op": "packed_stats = row stats kernel + segment sum",
        "ms": time_ms(lambda: pk.packed_stats(ds(), ms_(), layout)),
        "segment_sum_ms": time_ms(lambda: torch.segment_reduce(
            parts.t().reshape(-1), "sum", lengths=seg)),
        "branch_scalars_ms": time_ms(lambda: pk.branch_scalars(
            blocks, HeLoCoConfig())),
    }))
    return rows + multi_rows + leaf_rows + int8_rows + flash_rows


def check_gram(name, got, want, k):
    """Per-row (or per-block) Gram columns in the (a <= b) pair order, each
    within TOL_SUM of sqrt(G_aa * G_bb) (Cauchy-Schwarz bounds the entry).
    Returns the largest absolute difference."""
    from repro_torch.kernels.packed import gram_pairs
    pairs = gram_pairs(k)
    got, want = got.double(), want.double()
    diag = {a: want[:, c] for c, (a, b) in enumerate(pairs) if a == b}
    scale = want.new_empty(want.shape)
    for c, (a, b) in enumerate(pairs):
        scale[:, c] = (diag[a] * diag[b]).sqrt()
    diff = (got - want).abs()
    bad = (diff > TOL_SUM * scale).nonzero()
    assert not len(bad), (f"{name}: {len(bad)} sums off, first at "
                          f"{bad[0].tolist()}")
    return diff.max().item()


def multi_phase(torch, pk, layout, dev, p, m, b, bound):
    """The batched commit path's four kernels at K = K_MULTI: each held to
    its plain version (plain, stats, in place), each multi sweep bit for
    bit to K back-to-back launches of its single-arrival kernel, the Gram
    rows and blocks to the plain sums; then timed. Returns their rows."""
    k, R, B = K_MULTI, layout.n_rows, layout.n_blocks
    gen = torch.Generator(device=dev).manual_seed(1)
    D = torch.randn((k, R, 128), generator=gen, device=dev)
    CU = torch.rand((k, B), generator=gen, device=dev) + 0.5
    CV = torch.rand((k, B), generator=gen, device=dev) - 0.5
    CQ = -0.3 * torch.rand((k, B), generator=gen, device=dev)
    rb, _ = layout.device_tables(dev)
    eta, mu = 0.7, 0.9
    rhos = [0.5 / math.sqrt(1.0 + j) for j in range(k)]

    def multi(*s, **kw):
        return pk.packed_multi_correct_outer(*s, D, CU, CV, rb, eta, mu,
                                             rhos, **kw)

    def quad(*s, **kw):
        return pk.packed_multi_correct_outer_quad(*s, D, CU, CV, CQ, rb, 0.07,
                                                  mu, rhos, **kw)

    def acc(*s, **kw):
        return pk.packed_multi_correct_outer_acc(*s, D, CU, CV, rb, eta, rhos,
                                                 *MULTI_ACC_TABLE, **kw)

    def seq_multi(*s, D=D):
        for j in range(k):
            s = pk.packed_correct_outer(*s, D[j], CU[j], CV[j], rb, eta, mu,
                                        rhos[j])
        return s

    def seq_quad(*s, D=D):
        for j in range(k):
            s = pk.packed_correct_outer_quad(*s, D[j], CU[j], CV[j], CQ[j],
                                             rb, 0.07, mu, rhos[j])
        return s

    def seq_acc(*s, D=D):
        for j in range(k):
            s = pk.packed_correct_outer_acc(*s, D[j], CU[j], CV[j], rb, eta,
                                            rhos[j],
                                            *(c[j] for c in MULTI_ACC_TABLE))
        return s

    errs = []
    checks = (
        ("packed_multi_correct_outer", multi, seq_multi, (p, m),
         pk.packed_multi_correct_outer_ref(p, m, D, CU, CV, rb, eta, mu, rhos,
                                           with_stats=True)),
        ("packed_multi_correct_outer_quad", quad, seq_quad, (p, m),
         pk.packed_multi_correct_outer_quad_ref(p, m, D, CU, CV, CQ, rb, 0.07,
                                                mu, rhos, with_stats=True)),
        ("packed_multi_correct_outer_acc", acc, seq_acc, (p, m, b),
         pk.packed_multi_correct_outer_acc_ref(p, m, b, D, CU, CV, rb, eta,
                                               rhos, *MULTI_ACC_TABLE,
                                               with_stats=True)))
    for name, fn, seq, state, ref in checks:
        n = len(state)
        errs.append(check_update(name, torch, fn, state, ref[:n], ref[n]))
        chained = seq(*state)
        got = fn(*state)
        torch.cuda.synchronize()
        for i, (g, w) in enumerate(zip(got, chained)):
            assert torch.equal(g, w), (
                f"{name} output {i} differs from {k} sequential launches of "
                f"the single-arrival kernel by {(g - w).abs().max().item()}")
    # the moments of the sequential launches against the multi stats
    s, moments = (p, m), []
    for j in range(k):
        out = pk.packed_correct_outer(*s, D[j], CU[j], CV[j], rb, eta, mu,
                                      rhos[j], with_stats=True)
        s, moments = out[:2], moments + [out[2]]
    stats_bitwise = torch.equal(multi(p, m, with_stats=True)[2],
                                torch.stack(moments))
    gram_rows = pk.packed_multi_gram(m, D)
    gram_want = pk.packed_multi_gram_ref(m, D)
    torch.cuda.synchronize()
    err_g = check_gram("packed_multi_gram", gram_rows, gram_want, k)
    blocks = pk.multi_gram_blocks(m, D, layout)
    assert torch.equal(blocks, pk.multi_gram_blocks(m, D, layout)), \
        "multi_gram_blocks is not deterministic"
    plain_blocks = torch.stack([gram_want[a:e].sum(0)
                                for a, e in layout.block_row_ranges])
    pairs = pk.gram_pairs(k)
    got_blocks = torch.stack([blocks[:, a, c] for a, c in pairs], dim=1)
    err_gb = check_gram("multi_gram_blocks", got_blocks, plain_blocks, k)
    # the library yardstick: one bmm over the pre-stacked basis (R, K+1,
    # 128), which gives every row's whole Gram matrix; the stack itself is
    # not timed
    basis = torch.cat([m[:, None], D.transpose(0, 1)], dim=1).contiguous()
    bmm = torch.bmm(basis, basis.transpose(1, 2))
    ai = torch.tensor([a for a, _ in pairs], device=dev)
    bi = torch.tensor([c for _, c in pairs], device=dev)
    check_gram("torch.bmm yardstick", bmm[:, ai, bi], gram_want, k)
    print(f"multi sweeps agree at K = {k}: plain, quad and acc (per-delta "
          f"table, a boundary in slot 1) bit-identical to their plain "
          f"versions and to {k} back-to-back single-arrival launches in "
          f"p'/m'/b', plain, stats and in place; stats err "
          f"{max(errs):.3e}, bitwise equal to the single kernel's: "
          f"{stats_bitwise}; Gram rows err {err_g:.3e}, blocks err "
          f"{err_gb:.3e} (each within {TOL_SUM} of sqrt(G_aa * G_bb))")

    f4, n = 4, R * 128
    plane, table_bytes = n * f4, R * 4
    coef = k * B * f4
    outs = (torch.empty_like(p), torch.empty_like(m), torch.empty_like(b))
    n_pairs = len(pairs)
    # each timed call takes its inputs from rotations of copies that exceed
    # L2
    ps, ms_, bs, Ds, bases = (cold(t) for t in (p, m, b, D, basis))

    def bmm():
        x = bases()
        return torch.bmm(x, x.transpose(1, 2))

    rows = []
    for name, fn, plain, seq_fn, nbytes, nflops, err, lib in (
            ("packed_multi_correct_outer",
             lambda: pk.packed_multi_correct_outer(
                 ps(), ms_(), Ds(), CU, CV, rb, eta, mu, rhos, out=outs[:2]),
             lambda: pk.packed_multi_correct_outer_ref(
                 ps(), ms_(), Ds(), CU, CV, rb, eta, mu, rhos),
             lambda: seq_multi(ps(), ms_(), D=Ds()),
             (4 + k) * plane + table_bytes + 2 * coef + 3 * k * f4,
             11 * k * n, errs[0], None),
            ("packed_multi_correct_outer_quad",
             lambda: pk.packed_multi_correct_outer_quad(
                 ps(), ms_(), Ds(), CU, CV, CQ, rb, 0.07, mu, rhos,
                 out=outs[:2]),
             lambda: pk.packed_multi_correct_outer_quad_ref(
                 ps(), ms_(), Ds(), CU, CV, CQ, rb, 0.07, mu, rhos),
             lambda: seq_quad(ps(), ms_(), D=Ds()),
             (4 + k) * plane + table_bytes + 3 * coef + 3 * k * f4,
             15 * k * n, errs[1], None),
            ("packed_multi_correct_outer_acc",
             lambda: pk.packed_multi_correct_outer_acc(
                 ps(), ms_(), bs(), Ds(), CU, CV, rb, eta, rhos,
                 *MULTI_ACC_TABLE, out=outs),
             lambda: pk.packed_multi_correct_outer_acc_ref(
                 ps(), ms_(), bs(), Ds(), CU, CV, rb, eta, rhos,
                 *MULTI_ACC_TABLE),
             lambda: seq_acc(ps(), ms_(), bs(), D=Ds()),
             (6 + k) * plane + table_bytes + 2 * coef + 8 * k * f4,
             16 * k * n, errs[2], None),
            ("packed_multi_gram", lambda: pk.packed_multi_gram(ms_(), Ds()),
             lambda: pk.packed_multi_gram_ref(ms_(), Ds()), None,
             (1 + k) * plane + n_pairs * R * f4, 2 * n_pairs * n, err_g,
             bmm)):
        b_ms, by = bound(nbytes, nflops)
        rows.append({
            "name": name, "ms": time_ms(fn), "plain_ms": time_ms(plain),
            "bound_ms": b_ms, "bound_by": by, "max_abs_err": err,
            "library_ms": time_ms(lib) if lib else None,
            "library_call": ("torch.bmm over a pre-stacked (R, K+1, 128) "
                             "basis (the stack not timed)" if lib else None),
            "sequential_ms": time_ms(seq_fn) if seq_fn else None,
            "K": k, "bytes": nbytes, "flops": nflops, "R": R, "blocks": B})
    print(json.dumps({
        "kernel": f"packed_multi_correct_outer(with_stats), K = {k}",
        "kernel_ms": time_ms(lambda: pk.packed_multi_correct_outer(
            ps(), ms_(), Ds(), CU, CV, rb, eta, mu, rhos, with_stats=True,
            out=outs[:2])),
        "on_main_path": False}))
    print(json.dumps({
        "op": "multi_gram_blocks = multi-Gram kernel + segment sum + "
              "symmetric expand",
        "ms": time_ms(lambda: pk.multi_gram_blocks(ms_(), Ds(), layout))}))
    return rows


def branch_blocks(torch, u4, gen):
    """Momentum blocks against the four stacked blocks of ``u4`` that land
    in the four branches of Alg. 2: keep (c near 1), anti (c near -1), weak
    (c near 0.1) and degenerate (a zero momentum)."""
    noise = torch.randn(u4.shape, generator=gen, device=u4.device)
    return torch.stack([2.0 * u4[0] + 0.1 * noise[0],
                        -u4[1] + 0.1 * noise[1],
                        0.1 * u4[2] + noise[2],
                        torch.zeros_like(u4[3])])


def leaf_phase(torch, specs, dev, bound):
    """The per-leaf kernels of ``csrc/leaf.cu`` on the largest leaf (the
    tied embedding) held to their plain versions: block_stats within
    TOL_SUM, correct_apply and outer_update_2d bit for bit (outer_update_2d
    also in place, its outputs p and m themselves), as one block, as four
    stacked blocks (one in each branch of Alg. 2 for the correction) of the
    embedding's n / 4 and of an odd 4097 elements (the sweeps' float4
    straddle the blocks' boundaries), on an odd length, on views offset by
    1-3 elements (no 16-byte alignment: the element-by-element path) and on
    lengths 15, 16 and 17 (around one 16-element unit of the sweeps'
    body); then timed, with the library yardsticks, each input rotating
    over three copies that together exceed the 50 MB L2, and the 43-leaf
    correction pass. Returns their rows."""
    from repro_torch.configs.base import HeLoCoConfig
    from repro_torch.core.heloco import block_correct
    from repro_torch.kernels import heloco_correct as hk
    from repro_torch.kernels import outer_update as ok
    from repro_torch.kernels.packed import branch_scalars
    h = HeLoCoConfig()
    shape = tuple(max(specs.values(), key=lambda t: t.numel()).shape)
    n = math.prod(shape)
    gen = torch.Generator(device=dev).manual_seed(2)
    u, v, p, m, g = (torch.randn(n + 3, generator=gen, device=dev)
                     for _ in range(5))
    eta, mu, rho = 0.7, 0.9, 0.5
    # label: (blocks, block length, offset of the views in elements)
    cases = {"one block": (1, n, 0), "4 stacked blocks": (4, n // 4, 0),
             "4 stacked blocks of 4097": (4, 4097, 0),
             "odd length": (1, n - 3, 0),
             **{f"offset by {o}": (1, n, o) for o in (1, 2, 3)},
             **{f"length {k}": (1, k, 0) for k in (15, 16, 17)}}
    errs, rels = [], []
    for label, (blocks, k, off) in cases.items():
        sl = slice(off, off + blocks * k)
        U, V = u[sl].view(blocks, k), v[sl].view(blocks, k)
        if blocks == 4:
            V = branch_blocks(torch, U, gen)
        stats = hk.block_stats(U, V)
        again = hk.block_stats(U, V)
        torch.cuda.synchronize()
        assert torch.equal(stats, again), "block_stats is not deterministic"
        want = hk.block_stats_ref(U, V)
        errs.append(check_sums(f"block_stats ({label})", stats, want))
        rels.append(rel_sum_err(stats, want))
        cu, cv = branch_scalars(stats, h)
        if blocks == 4:
            c = (stats[:, 0] / (stats[:, 1] * stats[:, 2]).sqrt()).tolist()
            assert (c[0] >= h.c_ok and c[1] < 0.0 and 0.0 <= c[2] < h.c_ok
                    and stats[3, 2].item() == 0.0), c
            # anti damps along v (cv > 0 against c < 0), weak rotates
            assert (cu[1].item() == 1.0 and cv[1].item() > 0.0
                    and cu[2].item() != 1.0), (cu, cv)
        got = hk.correct_apply(U, V, cu, cv)
        torch.cuda.synchronize()
        assert torch.equal(got, hk.correct_apply_ref(U, V, cu, cv)), \
            f"correct_apply ({label}) differs from the plain version"
        args = [t[sl].view(blocks, k) for t in (p, m, g)]
        if label == "one block":
            args = [t.view(shape) for t in args]
        got = ok.outer_update_2d(*args, eta, mu, rho)
        pm = [t.clone() for t in args[:2]]
        ok.outer_update_2d(*pm, args[2], eta, mu, rho, out=pm)
        torch.cuda.synchronize()
        want = ok.outer_update_2d_ref(*args, eta, mu, rho)
        for how, outs in (("", got), (" in place", pm)):
            assert all(torch.equal(a, b) for a, b in zip(outs, want)), \
                f"outer_update_2d{how} ({label}) is not its plain version"
    print(f"leaf kernels agree on {shape} = {n} elements, as one block, four "
          "stacked blocks (keep, anti, weak, degenerate) of n / 4 and of "
          f"4097, an odd length, views offset by 1-3 elements and lengths "
          f"15-17: block_stats err {max(errs):.3e} absolute, "
          f"{max(rels):.3e} of its own scale (each sum within {TOL_SUM} of "
          "it), correct_apply and outer_update_2d (also in place) "
          "bit-identical to their plain versions")

    # timed on the embedding as one block; correct_apply at cu = 1, the
    # function of one torch.add (keep, anti and degenerate have cu = 1)
    U, V = u[:n].view(1, n), v[:n].view(1, n)
    cu = torch.ones(1, device=dev)
    cv = torch.full((1,), -0.3, device=dev)
    S = torch.stack([U[0], V[0]])
    gram = torch.mm(S, S.T)
    check_sums("torch.mm yardstick", torch.stack(
        [gram[0, 1], gram[0, 0], gram[1, 1]])[None], hk.block_stats(U, V))
    lib_add = torch.add(U[0], V[0], alpha=-0.3)
    assert torch.allclose(lib_add, hk.correct_apply(U, V, cu, cv)[0],
                          rtol=1e-6, atol=1e-6), \
        "the correct_apply yardstick computes another function"
    P, M, G = (t[:n].view(shape) for t in (p, m, g))
    # outer_update_2d at rho = 1 is one Nesterov SGD step with dampening mu:
    # m' = mu m + (1 - mu) g, p' = p - eta (g + mu m'), in place on p and m
    # (the same 3 reads and 2 writes); ATen's fused kernel takes its scalars
    # in double, so it is held to the plain version within a few ulps
    P1, M1 = P.clone(), M.clone()
    torch._fused_sgd_([P1], [G], [M1], weight_decay=0.0, momentum=mu, lr=eta,
                      dampening=mu, nesterov=True, maximize=False,
                      is_first_step=False)
    for got, want in zip((P1, M1), ok.outer_update_2d_ref(P, M, G, eta, mu,
                                                          1.0)):
        assert torch.allclose(got, want, rtol=1e-6, atol=1e-6), \
            "the outer_update_2d yardstick computes another function"
    # each timed call takes its inputs from rotations of three copies, so
    # that it reads them from memory, as the bounds count them
    us, vs, ss = rotating(U, 3), rotating(V, 3), rotating(S, 3)
    ps, ms, gs = rotating(P, 3), rotating(M, 3), rotating(G, 3)
    ps1, ms1 = rotating(P1, 3), rotating(M1, 3)

    def fused_sgd():
        torch._fused_sgd_([ps1()], [gs()], [ms1()], weight_decay=0.0,
                          momentum=mu, lr=eta, dampening=mu, nesterov=True,
                          maximize=False, is_first_step=False)

    def mm():
        x = ss()
        return torch.mm(x, x.T)

    f4 = 4
    rows = []
    for name, fn, plain, lib, call, nbytes, nflops, err in (
            ("block_stats", lambda: hk.block_stats(us(), vs()),
             lambda: hk.block_stats_ref(us(), vs()), mm,
             "torch.mm(S, S.T) over a pre-stacked (2, n) S = [u; v] (the "
             "stack not timed)", 2 * n * f4 + 3 * f4, 6 * n, max(errs)),
            ("correct_apply", lambda: hk.correct_apply(us(), vs(), cu, cv),
             lambda: hk.correct_apply_ref(us(), vs(), cu, cv),
             lambda: torch.add(us()[0], vs()[0], alpha=-0.3),
             "torch.add(u, v, alpha=cv), the same function at cu = 1",
             3 * n * f4 + 2 * f4, 3 * n, 0.0),
            ("outer_update_2d", lambda: ok.outer_update_2d(
                ps(), ms(), gs(), eta, mu, rho),
             lambda: ok.outer_update_2d_ref(ps(), ms(), gs(), eta, mu, rho),
             fused_sgd,
             "torch._fused_sgd_ (nesterov, dampening = momentum = mu, "
             "lr = eta) in place on clones of p and m, the same function at "
             "rho = 1", 5 * n * f4, 8 * n, 0.0)):
        b_ms, by = bound(nbytes, nflops)
        rows.append({"name": name, "ms": time_ms(fn),
                     "plain_ms": time_ms(plain), "bound_ms": b_ms,
                     "bound_by": by, "max_abs_err": err,
                     "library_ms": time_ms(lib) if lib else None,
                     "library_call": call, "bytes": nbytes, "flops": nflops,
                     "n": n, "L": 1})
    rows[0]["max_rel_err"] = max(rels)
    del S, gram, lib_add, P1, M1, us, vs, ss, ps, ms, gs, ps1, ms1
    # the 43-leaf correction pass of one per-leaf HeLoCo arrival
    delta = {k: torch.randn(t.shape, generator=gen, device=dev)
             for k, t in specs.items()}
    mom = {k: torch.randn(t.shape, generator=gen, device=dev)
           for k, t in specs.items()}

    def kernels_only():
        for k, d in delta.items():
            a, b = d.view(1, -1), mom[k].view(1, -1)
            hk.block_stats(a, b)
            hk.correct_apply(a, b, cu, cv)

    def device_ms(fn):
        """Device time of a pass whose dispatch outlasts the default hold."""
        return time_ms(fn, iters=10, warmup=1, hold=SERVE_HOLD_CYCLES)

    print(json.dumps({
        "op": f"block_correct over {len(specs)} leaves = block_stats + "
              "branch_scalars + correct_apply per leaf (device time)",
        "ms": device_ms(lambda: block_correct(delta, mom, h, use_kernel=True)),
        "plain_ms": device_ms(lambda: block_correct(delta, mom, h)),
        "kernels_only_ms": device_ms(kernels_only),
        "elements": sum(t.numel() for t in specs.values())}))
    return rows


def int8_inputs(torch, compression, d, layout, dev):
    """A buffer and per-block scales for the int8 sweeps: ``d`` with block 0
    on exact .5 ties at scale 0.5 ((n + 0.5) * 0.5 with |max| 63.5) and
    block 1 all zero (the 1e-12 scale floor), the scales of the compression
    path, and the last block's cut to a quarter so that x / s leaves
    [-127, 127] (the clip)."""
    x = d.clone()
    (s0, e0), (s1, e1) = layout.block_row_ranges[:2]
    x[s0:e0] = (torch.arange(-64, 64, device=dev, dtype=torch.float32)
                + 0.5) * 0.5
    x[s0, 0] = 63.5
    x[s1:e1] = 0.0
    scale = compression.block_scales(x, layout)
    scale[-1] *= 0.25
    return x, scale


def cpu_arrivals(scn):
    """The arrival rows, inner steps (tokens over batch x sequence) and
    final time of the port's run of ``scn`` at smoke width on the CPU: the
    target of a card run that has no golden."""
    from repro_torch.scenarios import registry, run
    smoke = registry.get_scenario(scn.name).overridden(
        commit_batch=scn.commit_batch)
    _eng, hist = run.run(smoke, "cpu")
    return (run.arrival_rows(hist),
            hist.tokens // (smoke.batch_size * smoke.seq_len),
            hist.final_time)


def run_scenario(torch, kernels, name, overrides, single, fused,
                 per_leaf=False, recorder=None, result=None, layers=None):
    """One slice scenario at full width on cuda, through the scenario layer,
    with ``overrides``. ``single``: the kernels an arrival committed on its
    own launches once (or a mapping of kernel to launches per arrival);
    ``fused``: those a fused run of K >= 2 arrivals launches once.
    ``per_leaf``: the engine's server swapped for a per-leaf kernel server
    before the run. ``recorder``: a TelemetryRecorder the run streams into.
    ``layers``: the model cut to this depth (the engine built from the
    scenario's materialized config with the cut). Arrivals are held to the
    golden's unless ``overrides`` set more than the arch and the sequence
    length (``seq_len``), which do not change them; then to the port's CPU
    run of the override at smoke width. Returns the launch counts of this
    run, the applied arrivals committed on their own, the fused arrivals,
    the eval means and the median server
    ms of an arrival committed on its own; ``result`` (a dict) also
    receives the final state's tensors, the history and the printed line."""
    import dataclasses
    from repro_torch.async_engine.engine import make_engine, make_eval_fn
    from repro_torch.async_engine.server import Synchronizer
    from repro_torch.launch.train import FULL_WIDTH
    from repro_torch.scenarios import registry, run

    scn = registry.get_scenario(name).overridden(**{**FULL_WIDTH,
                                                    **overrides})
    if layers:
        m = scn.materialize()
        run_cfg = dataclasses.replace(m.run_cfg, model=dataclasses.replace(
            m.run_cfg.model, n_layers=layers))
        eng = make_engine(run_cfg, m.engine, device="cuda",
                          failures=m.failures, elastic=m.elastic,
                          **m.engine_kw)
    else:
        # with a recorder, a "runtime" record after every commit (the
        # launcher's cadence with --telemetry)
        eng = scn.build(device="cuda", telemetry=recorder,
                        runtime_record_every=None if recorder is None else 1)
    if per_leaf:
        eng.server = Synchronizer(eng.server.state.params, eng.cfg.outer,
                                  eng.cfg.n_workers, packed=False,
                                  use_kernel=True)
    per_arrival = single if isinstance(single, dict) else dict.fromkeys(
        single, 1)
    spans = {"inner_round": [], "server_step": [], "eval": [], "commit": []}
    flush_ms = {}                   # server ms of a fused run, by K
    fused_runs = []

    def timed(fn, bucket):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spans[bucket].append(1e3 * (time.perf_counter() - t0))
            return out
        return wrapper

    def fused_step(deltas, rhos, taus,
                   _fn=getattr(eng.server, "_step_update_multi", None)):
        """Times one fused run and holds it to one launch of each kernel in
        ``fused`` and of no other."""
        before = kernels.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = _fn(deltas, rhos, taus)
        torch.cuda.synchronize()
        flush_ms.setdefault(len(deltas), []).append(
            1e3 * (time.perf_counter() - t0))
        after = kernels.launch_counts()
        diff = {k: after[k] - before[k] for k in after
                if after[k] != before[k]}
        assert diff == {k: 1 for k in fused}, \
            f"{name}: a fused run of {len(deltas)} launched {diff}"
        fused_runs.append(len(deltas))
        return out

    eng._execute = timed(eng._execute, "inner_round")
    # the engine's whole commit: the server step and, with a recorder, the
    # records it writes
    eng._commit = timed(eng._commit, "commit")
    eng._commit_batch = timed(eng._commit_batch, "commit")
    eng.server.on_arrival = timed(eng.server.on_arrival, "server_step")
    eng.server.on_sync_round = timed(eng.server.on_sync_round, "server_step")
    if hasattr(eng.server, "_step_update_multi"):
        eng.server._step_update_multi = fused_step
    eval_fn = timed(make_eval_fn(eng, batch=scn.eval_batch), "eval")
    target = cpu_arrivals(scn) if set(overrides) - {"arch", "seq_len"} \
        else None
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    hist = eng.run(eval_every=scn.eval_cadence, eval_fn=eval_fn)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()

    if target is None:
        bad = run.compare(scn, hist)
        assert not bad, f"{name}: {bad}"
    else:
        rows = run.arrival_rows(hist)
        assert rows == target[0], f"{name} {overrides}: arrivals differ " \
            "from the port's CPU run at smoke width"
        steps = hist.tokens // (scn.batch_size * scn.seq_len)
        assert (steps, hist.final_time) == target[1:], \
            f"{name} {overrides}: inner steps or final time differ"
    applied = sum(not a["dropped"] for a in hist.arrivals)
    n_fused = sum(fused_runs)
    singles = applied - n_fused
    assert (len(fused_runs) > 0) == bool(fused), (name, fused_runs)
    want = {k: singles * per_arrival.get(k, 0)
            + len(fused_runs) * (k in fused) for k in counts}
    assert counts == want, f"{name}: launch counts {counts}, want {want}"
    srv = eng.server
    state = srv.state
    tensors = [*state.params.values(), *state.momentum.values(),
               *(state.aux or {}).values()]
    if srv.packed:
        tensors += [srv._pbuf, srv._mbuf]
    for replicas in (getattr(srv, "_p", {}), getattr(srv, "_m", {})):
        for rep in replicas.values():           # a PeerMixer's replicas
            tensors += list(rep.values())
    for w in eng.workers.values():
        tensors += [*w.opt.mu.values(), *w.opt.nu.values()]
        if w.ef is not None:                    # packed int8 error feedback
            tensors.append(w.ef)
    for task in eng._pending.values():          # rounds still in flight
        tensors += [*task.params.values(), *task.opt.mu.values()]
    assert all(t.device.type == "cuda" for t in tensors), \
        f"{name}: a tensor left the card"
    means = [e["mean"] for e in hist.evals]
    assert means and all(math.isfinite(x) for x in means), (name, means)
    server_ms_by_k = {1: statistics.median(spans["server_step"])} \
        if spans["server_step"] else {}
    server_ms_by_k.update({k: statistics.median(v)
                           for k, v in sorted(flush_ms.items())})
    line = {
        "scenario": name, "overrides": overrides, "method": scn.method,
        "server": ("per-leaf, use_kernel" if per_leaf else "packed"
                   if scn.topology == "hub"
                   else f"peer mixer ({scn.topology})"),
        "config": f"{eng.cfg.model.name} full width"
                  f"{f', {layers} layers' if layers else ''}, "
                  f"{scn.n_workers} workers "
                  f"{scn.paces}, H={scn.inner_steps}, batch "
                  f"{scn.batch_size} x {scn.seq_len}, "
                  f"commit_batch {scn.commit_batch}",
        "params": sum(t.numel() for t in state.params.values()),
        "arrivals": len(hist.arrivals), "applied": applied,
        "fused_runs": fused_runs, "committed_alone": singles,
        "arrivals_equal": "golden" if target is None else
                          "port CPU run at smoke width",
        "launches": counts,
        "flush_totals": getattr(srv, "flush_totals", None),
        "wall_s": wall, "wall_ms_per_arrival": 1e3 * wall / len(hist.arrivals),
        "median_ms": {k: statistics.median(v) for k, v in spans.items() if v},
        "first_ms": {k: v[0] for k, v in spans.items() if v},
        "server_ms_by_k": server_ms_by_k,
        "server_ms_all_by_k": {k: v for k, v in sorted(flush_ms.items())},
        "commit_ms_per_arrival": sum(spans["commit"]) / len(hist.arrivals),
        "server_ms_per_arrival": (sum(spans["server_step"])
                                  + sum(map(sum, flush_ms.values())))
        / len(hist.arrivals),
        "telemetry": recorder is not None,
        "eval_means": means,
        "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    print(json.dumps(line))
    if result is not None:
        result.update(line=line, history=hist, state={
            f"{part}/{k}": v.clone() for part, tree in
            (("p", state.params), ("m", state.momentum),
             ("a", state.aux or {})) for k, v in tree.items()})
    return counts, singles, n_fused, means, server_ms_by_k.get(1)


def slice_phase(torch, kernels, untraced):
    """Every slice scenario, then ``paper_hetero_severe`` on a per-leaf
    kernel server, its evals held to the packed run's; returns per kernel
    (launches, arrivals of the runs it served: committed alone for a
    single-arrival kernel, fused for a multi one). The packed
    ``paper_hetero_severe`` run goes into ``untraced`` for the obs phase."""
    totals = {k: [0, 0] for k in REPLACES}
    runs = [(*entry, False) for entry in SLICE]
    runs.append(("paper_hetero_severe", {}, PER_LEAF, (), True))
    packed_run = {}
    for name, overrides, single, fused, per_leaf in runs:
        obs_twin = name in dict(OBS) and not overrides and not per_leaf
        result = {} if obs_twin else None
        counts, singles, n_fused, means, server_ms = run_scenario(
            torch, kernels, name, overrides, single, fused, per_leaf,
            result=result)
        if obs_twin:
            from repro_torch.scenarios import trace
            line = result["line"]
            untraced[name] = {
                "digest": trace.param_digest(
                    {k[2:]: v for k, v in result["state"].items()
                     if k.startswith("p/")}),
                "launches": dict(counts), "child_launches": {},
                "ms_per_arrival": line["wall_ms_per_arrival"],
                "ms_per_arrival_after_first": None,
                "phase": "slice (spans synchronised around each call)"}
        for k in single:
            totals[k][0] += counts[k]
            totals[k][1] += singles
        for k in fused:
            totals[k][0] += counts[k]
            totals[k][1] += n_fused
        if name == "paper_hetero_severe" and not per_leaf:
            packed_run = {"means": means, "server_ms": server_ms}
        if per_leaf:
            diff = max(abs(a - b) for a, b in zip(means, packed_run["means"]))
            assert len(means) == len(packed_run["means"]) and \
                diff <= TOL_EVAL, (f"{name} on the per-leaf server: evals "
                                   f"{means} against the packed run's "
                                   f"{packed_run['means']}")
            print(json.dumps({
                "per_leaf_vs_packed": name,
                "server_ms_per_arrival": {"per_leaf": server_ms,
                                          "packed": packed_run["server_ms"]},
                "eval_max_abs_diff": diff, "band": TOL_EVAL}))
        gc.collect()
        torch.cuda.empty_cache()
    return totals


def telemetry_phase(torch, kernels):
    """Each TELEMETRY run four times at full width, in turns without, with,
    with and without a TelemetryRecorder streaming to a live sink under
    build/telemetry: every run the launch counts (each held to the slice's
    contract by ``run_scenario``), the final parameters, momentum and
    accumulator bit for bit, the arrivals and the evals of the first;
    every arrival record of a run with telemetry carries finite stats, and
    its sink decodes with the port's StreamDecoder with nothing skipped.
    Prints one line per scenario: the server and commit ms per arrival of
    each run without and with telemetry, the records by kind and the mean
    cos_align."""
    from collections import Counter
    from repro_torch.telemetry import TelemetryRecorder, schema
    strip = ("cos_align", "corrected_frac", "delta_norm", "momentum_norm")

    def facts(arrivals):
        return [{k: v for k, v in a.items() if k not in strip}
                for a in arrivals]

    out_dir = ROOT / "build" / "telemetry"
    out_dir.mkdir(parents=True, exist_ok=True)
    for name, overrides, single, fused in TELEMETRY:
        tag = "_".join([name] + [f"{k}{v}" for k, v in overrides.items()])
        sink = out_dir / f"{tag}.jsonl"
        first = None
        ms = {"off": [], "on": []}
        commit_ms = {"off": [], "on": []}
        for on in (False, True, True, False):
            rec = TelemetryRecorder(sink=str(sink)) if on else None
            res = {}
            counts = run_scenario(torch, kernels, name, overrides, single,
                                  fused, recorder=rec, result=res)[0]
            key = "on" if on else "off"
            ms[key].append(res["line"]["server_ms_per_arrival"])
            commit_ms[key].append(res["line"]["commit_ms_per_arrival"])
            hist = res["history"]
            if first is None:
                first = (counts, res["state"], hist)
                assert all(a[k] is None for a in hist.arrivals
                           for k in strip)
            else:
                assert counts == first[0], (f"{name}: launches {first[0]} "
                                            f"-> {counts} (telemetry {on})")
                changed = [k for k, v in res["state"].items()
                           if not torch.equal(v, first[1][k])]
                assert not changed and res["state"].keys() == \
                    first[1].keys(), f"{name}: the bits of {changed} moved"
                assert facts(hist.arrivals) == facts(first[2].arrivals), \
                    f"{name}: the arrivals moved"
                assert hist.evals == first[2].evals, f"{name}: evals moved"
            if rec is not None:
                rec.close()
                arrivals = rec.arrivals()
                assert len(arrivals) == len(hist.arrivals)
                assert all(math.isfinite(getattr(a, k)) for a in arrivals
                           for k in strip), f"{name}: an arrival without stats"
                dec = schema.StreamDecoder(strict=True)
                kinds = Counter(schema.kind_of(dec.decode(line))
                                for line in sink.read_text().splitlines())
                assert dec.drift_report() == [] and dec.bad_lines == 0, \
                    dec.drift_report()
                assert kinds["arrival"] == len(arrivals) and \
                    kinds["meta"] == 1, kinds
                summary = rec.summary()
            del res
            gc.collect()
            torch.cuda.empty_cache()
        print(json.dumps({
            "telemetry": name, "overrides": overrides,
            "order": "off, on, on, off",
            "launches_equal": True, "params_bit_equal": True,
            "server_ms_per_arrival": ms,
            "commit_ms_per_arrival": commit_ms,
            "records": dict(sorted(kinds.items())),
            "stream_skipped": 0,
            "mean_cos_align": summary["mean_cos_align"],
            "mean_corrected_frac": summary["mean_corrected_frac"]}))


def content_hash(flat):
    """sha256 over the sorted keys and each array's bytes: the checkpoint
    manifest's ``hash``, recomputed here."""
    import hashlib
    h = hashlib.sha256()
    for k in sorted(flat):
        h.update(k.encode())
        h.update(flat[k].tobytes())
    return h.hexdigest()


def host_tree(eng):
    """The engine's outer state as the checkpoint's keys and host arrays
    (the step a 0-d int32); asserts every tensor lies on ``eng.device``."""
    out = {}
    for part, tree in eng.server_tree().items():
        if part == "step":
            out[part] = np.asarray(tree, np.int32)
            continue
        for k, t in tree.items():
            assert t.device.type == eng.device.type, f"{part}/{k} left it"
            out[f"{part}/{k}"] = t.detach().cpu().numpy()
    return out


def load_checkpoint(path):
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    with open(path + ".manifest.json") as f:
        return flat, json.load(f)


def assert_same_arrays(got, want, what):
    assert got.keys() == want.keys(), (what, set(got) ^ set(want))
    bad = [k for k in want if got[k].dtype != want[k].dtype
           or not np.array_equal(got[k], want[k])]
    assert not bad, f"{what}: {bad[:3]} differ"


def cpu_resume(name, ckpt_dir):
    """The arrival rows, inner steps and final time of the port's CPU run
    of ``name`` at smoke width, checkpointed every RC_CKPT commits and
    resumed from the first checkpoint in a fresh engine: the target of the
    same save and resume on the card (arrivals depend only on paces, H and
    the schedule)."""
    from repro_torch.scenarios import registry, run
    scn = registry.get_scenario(name)
    scn.build(device="cpu").run(ckpt_every=RC_CKPT, ckpt_dir=ckpt_dir)
    eng = scn.build(device="cpu")
    eng.restore(os.path.join(ckpt_dir, f"step_{RC_CKPT}.npz"))
    hist = eng.run()
    return (run.arrival_rows(hist),
            hist.tokens // (scn.batch_size * scn.seq_len), hist.final_time)


def run_control_phase(torch, kernels, dev="cuda"):
    """Run control at full width on ``dev``.

    (a) Each RUN_CONTROL scenario runs with a checkpoint every RC_CKPT
    commits; the file at RC_CKPT holds the state at that commit bit for bit
    and its recomputed content hash is the manifest's. A fresh engine of
    the scenario restores it (params, momentum, accumulator and step bit
    for bit) and runs on to the scenario's last commit, with the counts set
    to 0 just before: each applied arrival launches the run's kernels once
    and no other kernel launches, the arrivals, inner steps and final time
    are those of the same save and resume on the CPU at smoke width, and
    the evals are finite. Then a save through ``AsyncSaver``, whose file
    has the hash of a synchronous save of the same state. Prints the save
    and restore ms, the MB written and how long ``submit`` holds the loop.

    (b) The registered ``smoke`` sweep with one more axis, smoke=False: the
    full-width model with the scenarios' own batch 2 x 16 (FULL_WIDTH's
    batch 4 x 128 is 1024 tokens a round, so each 512-token cell would end
    at its first arrival), 2 methods x 2 scenarios x 2 budgets. Each cell
    stops at the arrival count, tokens and final time of the same cell on
    the CPU at smoke width; the HeLoCo cells' applied arrivals launch row
    stats and the fused sweep once each, the Nesterov cells' the fused
    sweep, and nothing else launches; the report's files are written.
    Prints each cell's wall seconds and final loss.

    Returns per kernel (launches, arrivals of the runs it served)."""
    import dataclasses
    import tempfile
    from repro_torch.async_engine.engine import make_eval_fn
    from repro_torch.checkpoint import ckpt
    from repro_torch.launch.train import FULL_WIDTH
    from repro_torch.scenarios import registry, run
    from repro_torch.sweeps import SweepAxis, cache, get_sweep, run_sweep

    def timed(fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    totals = {k: [0, 0] for k in HELOCO + ACC}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for name, single in RUN_CONTROL:
            scn = registry.get_scenario(name).overridden(**FULL_WIDTH)
            eng = scn.build(device=dev)
            saves, at_save = [], {}
            checkpoint = eng.checkpoint

            def timed_checkpoint(ckpt_dir, eng=eng, checkpoint=checkpoint,
                                 saves=saves, at_save=at_save):
                if eng.server.t == RC_CKPT:
                    at_save.update(host_tree(eng))
                path, ms = timed(checkpoint, ckpt_dir)
                saves.append(ms)
                return path

            eng.checkpoint = timed_checkpoint
            ckpt_dir = os.path.join(tmp, name)
            eng.run(ckpt_every=RC_CKPT, ckpt_dir=ckpt_dir)
            path = os.path.join(ckpt_dir, f"step_{RC_CKPT}.npz")
            flat, manifest = load_checkpoint(path)
            assert content_hash(flat) == manifest["hash"], \
                f"{name}: the file's content hash is not its manifest's"
            assert_same_arrays(flat, at_save, f"{name}: the saved file")
            assert ("aux/" + next(iter(eng.server.state.params)) in flat) \
                == (name == "delayed_nesterov")
            fresh = scn.build(device=dev)
            _, restore_ms = timed(fresh.restore, path)
            assert_same_arrays(host_tree(fresh), flat,
                               f"{name}: the restored state")
            assert fresh.restored_arrivals == RC_CKPT
            eval_fn = make_eval_fn(fresh, batch=scn.eval_batch)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            hist = fresh.run(eval_every=scn.eval_cadence, eval_fn=eval_fn)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = kernels.launch_counts()
            applied = sum(not a["dropped"] for a in hist.arrivals)
            want = {k: applied * (k in single) for k in counts}
            assert counts == want, f"{name} resumed: {counts}, want {want}"
            for k in single:
                totals[k][0] += counts[k]
                totals[k][1] += applied
            target = cpu_resume(name, os.path.join(tmp, f"{name}_cpu"))
            rows = run.arrival_rows(hist)
            assert rows == target[0], (f"{name} resumed: arrivals differ "
                                       "from the port's CPU run")
            assert (hist.tokens // (scn.batch_size * scn.seq_len),
                    hist.final_time) == target[1:], \
                f"{name} resumed: inner steps or final time differ"
            means = [e["mean"] for e in hist.evals]
            assert fresh.server.t == scn.outer_steps and means and all(
                math.isfinite(x) for x in means), (name, means)
            saver = ckpt.AsyncSaver()
            async_path = os.path.join(tmp, f"{name}_async.npz")
            _, submit_ms = timed(saver.submit, async_path,
                                 fresh.server_tree(), {})
            _, wait_ms = timed(saver.wait)
            sync_path, sync_ms = timed(fresh.checkpoint, ckpt_dir)
            saves.append(sync_ms)
            assert load_checkpoint(async_path)[1]["hash"] == \
                load_checkpoint(sync_path)[1]["hash"], \
                f"{name}: AsyncSaver wrote another state"
            print(json.dumps({
                "run_control": name, "config": "tinygpt-15m full width, "
                f"batch 4 x 128, a checkpoint every {RC_CKPT} commits",
                "save_ms": saves, "restore_ms": restore_ms,
                "mb_written": os.path.getsize(path) / 1e6,
                "async_submit_ms": submit_ms,
                "async_submit_to_written_ms": submit_ms + wait_ms,
                "resumed_arrivals": len(hist.arrivals), "applied": applied,
                "arrivals_equal": "port CPU run at smoke width",
                "launches": counts, "resumed_wall_s": wall,
                "eval_means": means}))
            del eng, fresh, at_save, flat
            gc.collect()
            torch.cuda.empty_cache()

        base = get_sweep("smoke")
        spec = dataclasses.replace(base, axes=(SweepAxis("smoke", (False,)),))
        cache.RESULTS_DIR = os.path.join(tmp, "runs")
        out_dir = str(ROOT / "build" / "sweeps")
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        doc = run_sweep(spec, out_dir=out_dir, force=True, verbose=False,
                        device=dev)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        cpu_doc = run_sweep(base, out_dir=os.path.join(tmp, "cpu"),
                            force=True, verbose=False, device="cpu")
    facts = ("tokens", "final_time", "arrivals", "n_dropped")
    assert len(doc["cells"]) == len(cpu_doc["cells"]) == 8
    applied = dict.fromkeys(base.methods, 0)
    for row, want in zip(doc["cells"], cpu_doc["cells"]):
        assert row["cell_id"] == want["cell_id"] + "__smoke-False", \
            (row["cell_id"], want["cell_id"])
        assert [row[k] for k in facts] == [want[k] for k in facts], \
            f"{row['cell_id']}: {[row[k] for k in facts]} against the CPU's " \
            f"{[want[k] for k in facts]}"
        assert math.isfinite(row["final_loss"]), row
        applied[row["method"]] += row["arrivals"] - row["n_dropped"]
    want = dict.fromkeys(counts, 0)
    want["packed_row_stats"] = applied["heloco"]
    want["packed_correct_outer"] = applied["heloco"] + applied["nesterov"]
    assert counts == want, f"smoke sweep: launches {counts}, want {want}"
    for k in HELOCO:
        totals[k][0] += counts[k]
    totals["packed_row_stats"][1] += applied["heloco"]
    totals["packed_correct_outer"][1] += applied["heloco"] + \
        applied["nesterov"]
    for f in ("report.md", "tables.json", "staleness_alignment.json"):
        assert (Path(out_dir) / "smoke" / f).stat().st_size > 0, f
    print(json.dumps({
        "sweep": "smoke + axis smoke=False (tinygpt-15m full width, batch "
                 "2 x 16)", "device": doc["device"], "cells": [
            {k: r[k] for k in ("cell_id", "arrivals", "tokens", "final_time",
                               "final_loss", "wall_seconds")}
            for r in doc["cells"]],
        "stops_equal": "port CPU sweep at smoke width",
        "launches": {k: v for k, v in counts.items() if v},
        "report": f"{out_dir}/smoke/report.md"}))
    return totals


def runtime_line(eng, hist, wall, check_ms, sim_wall=None):
    """The runtime's ``stats_summary()`` numbers of one run, with the host
    ms a round takes and the server thread's delivery checks (the CRC of
    every result frame) per arrival."""
    s = eng.stats_summary()
    line = {k: s[k] for k in ("mode", "arrivals", "rounds", "wall_seconds",
                              "arrivals_per_sec", "server_occupancy",
                              "compute_parallelism", "overlap_mean",
                              "overlap_max", "queue_depth_max")}
    line["delivery"] = {k: v for k, v in s["delivery"].items() if v}
    line["ms_per_arrival"] = 1e3 * wall / len(hist.arrivals)
    line["round_host_ms"] = 1e3 * s["compute_seconds_total"] / max(
        s["rounds"], 1)
    line["server_delivery_check_ms_per_arrival"] = sum(check_ms) / len(
        hist.arrivals)
    if sim_wall is not None:
        line["sim_ms_per_arrival"] = 1e3 * sim_wall / len(hist.arrivals)
    return line


def crc_timing(torch, params):
    """``payload_crc``'s host ms on one full-width pseudo-gradient (random
    values shaped as ``params``), timed alone: the whole call, then its two
    parts, the device-to-host copies and the CRC over the host bytes, and
    the CRC over ``tobytes()`` copies (the reference's way) for scale."""
    import zlib
    from repro_torch.async_engine.transport import host_bytes, payload_crc
    gen = torch.Generator(device=next(iter(params.values())).device)
    gen.manual_seed(5)
    delta = {k: torch.randn(v.shape, generator=gen, device=v.device)
             for k, v in params.items()}

    def med(fn):
        times = []
        for _ in range(CRC_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times)

    host = [v.cpu().numpy() for v in delta.values()]
    return {"crc_bytes": sum(v.numel() * v.element_size()
                             for v in delta.values()),
            "payload_crc_ms": med(lambda: payload_crc(delta)),
            "device_to_host_ms": med(lambda: [v.cpu()
                                              for v in delta.values()]),
            "crc32_memoryview_ms": med(lambda: [zlib.crc32(host_bytes(h))
                                                for h in host]),
            "crc32_tobytes_ms": med(lambda: [zlib.crc32(h.tobytes())
                                             for h in host]),
            "reps": CRC_REPS}


def host_memory():
    """GiB: this process' resident memory and the machine's available
    memory, from ``/proc``."""
    def kib(path, key):
        with open(path) as f:
            for ln in f:
                if ln.startswith(key + ":"):
                    return int(ln.split()[1])
        return 0
    return {"rss_gib": kib("/proc/self/status", "VmRSS") / 2**20,
            "available_gib": kib("/proc/meminfo", "MemAvailable") / 2**20}


def run_timed(torch, kernels, eng, scn, reset=False):
    """Run ``eng`` with ``scn``'s eval cadence to a synchronised end: its
    history, wall seconds, the ms of each delivery check on the server
    thread (on the runtime) and the host clock at each commit. ``reset``:
    every launch count set to 0 just before the run."""
    from repro_torch.async_engine.engine import make_eval_fn
    check_ms, commits = [], []
    tracker = getattr(eng, "_delivery", None)
    if tracker is not None:
        process = tracker.process

        def timed_process(env):
            t0 = time.perf_counter()
            out = process(env)
            check_ms.append(1e3 * (time.perf_counter() - t0))
            return out
        tracker.process = timed_process
    for hook in ("_commit", "_commit_batch"):
        inner = getattr(eng, hook)

        def stamped(*a, _inner=inner, **k):
            out = _inner(*a, **k)
            commits.append(time.perf_counter())
            return out
        setattr(eng, hook, stamped)
    eval_fn = make_eval_fn(eng, batch=scn.eval_batch)
    torch.cuda.synchronize()
    if reset:
        kernels.reset_launch_counts()
    t0 = time.perf_counter()
    hist = eng.run(eval_every=scn.eval_cadence, eval_fn=eval_fn)
    torch.cuda.synchronize()
    return hist, time.perf_counter() - t0, check_ms, commits


def wallclock_phase(torch, kernels, untraced, dev="cuda"):
    """The wall-clock runtime (``async_engine/runtime.py``) on the card.

    (a) Each WALLCLOCK run at full width, batch 4 x 128, on the
    deterministic runtime (worker threads, the device's default stream)
    beside its sim twin run from the same initial bits: the arrivals equal
    the golden's and the twin's, the final parameters' fingerprint within
    TOL_FP of the twin's (whether the digests are bit-equal is printed,
    and each differing leaf's largest difference when they are not), the
    chaos twins with wallclock_hetero's digest and their fault counters
    non-zero; with the counts set to 0 just before the runtime's run, each
    applied arrival launches the run's server kernels once, each round the
    int8 sweeps once, and nothing else launches. Prints
    ``stats_summary()``'s numbers and the ms per arrival of both engines.

    (b) ``payload_crc`` on one full-width pseudo-gradient, timed alone.

    (c) wallclock_free and chaos_partition at their own smoke width on the
    card through ``trace.verify``'s bands, then at full width: every
    arrival committed with the HeLoCo kernels once each, finite evals, and
    in chaos_partition the partitioned worker declared dead; the liveness
    deaths and revivals by worker and the heartbeat misses are printed.

    Returns per kernel (launches, arrivals or rounds of the runs it
    served); ``wallclock_hetero``'s run goes into ``untraced`` for the obs
    phase."""
    from repro_torch import bridge
    from repro_torch.launch.train import FULL_WIDTH
    from repro_torch.scenarios import registry, run, trace
    from repro_torch.telemetry import TelemetryRecorder

    def timed_run(eng, scn, reset=False):
        hist, wall, check_ms, commits = run_timed(torch, kernels, eng, scn,
                                                  reset)
        if reset and scn.name in dict(OBS) and scn.name not in untraced:
            untraced[scn.name] = untraced_entry(
                eng, hist, wall, commits, kernels.launch_counts(),
                "wall-clock")
        return hist, wall, check_ms

    # a short sim run first, so that no timed run pays the first launches
    timed_run(registry.get_scenario("wallclock_hetero").overridden(
        **FULL_WIDTH, engine="sim", outer_steps=2).build(device=dev),
        registry.get_scenario("wallclock_hetero"))
    totals = {k: [0, 0] for k in HELOCO + ACC + INT8
              + ("packed_correct_outer_quad",)}
    twins, digests = {}, {}
    for name, overrides, single in WALLCLOCK:
        scn = registry.get_scenario(name).overridden(**FULL_WIDTH,
                                                     **overrides)
        twin = scn.overridden(name="sim twin", description="", engine="sim",
                              faults=None)
        if twin not in twins:
            sim = twin.build(device=dev)
            init = bridge.to_numpy(sim.server.state.params)
            sim_hist, sim_wall, _ = timed_run(sim, twin)
            state = sim.server.state.params
            twins[twin] = (init, run.arrival_rows(sim_hist), sim_wall,
                           trace.param_fingerprint(state),
                           trace.param_digest(state),
                           {k: v.clone() for k, v in state.items()})
            del sim, state
        init, sim_rows, sim_wall, sim_fp, sim_digest, sim_params = \
            twins[twin]
        eng = scn.build(device=dev, init_params=init)
        hist, wall, check_ms = timed_run(eng, scn, reset=True)
        counts = kernels.launch_counts()
        bad = run.compare(scn, hist)
        assert not bad, f"{name} on the runtime: {bad}"
        assert run.arrival_rows(hist) == sim_rows, \
            f"{name}: the runtime's arrivals are not its sim twin's"
        params = eng.server.state.params
        fails = []
        trace._cmp_fingerprint(fails, trace.param_fingerprint(params),
                               sim_fp, **TOL_FP)
        assert not fails, f"{name}: fingerprint off the sim twin's: {fails}"
        digest = digests[name] = trace.param_digest(params)
        leaf_diff = {k: (v - sim_params[k]).abs().max().item()
                     for k, v in params.items()
                     if not torch.equal(v, sim_params[k])}
        s = eng.stats_summary()
        rounds = s["rounds"]
        applied = sum(not a["dropped"] for a in hist.arrivals)
        want = dict.fromkeys(counts, 0)
        for k in single:
            want[k] = rounds if k in INT8 else applied
        assert counts == want, \
            f"{name} on the runtime: launches {counts}, want {want}"
        assert rounds >= applied, (name, rounds, applied)
        for k in single:
            totals[k][0] += counts[k]
            totals[k][1] += rounds if k in INT8 else applied
        if name in CHAOS_TWINS:
            assert digest == digests["wallclock_hetero"], \
                f"{name}: not wallclock_hetero's bits"
            assert all(s["delivery"][k] > 0 for k in CHAOS_TWINS[name]), \
                (name, s["delivery"])
        means = [e["mean"] for e in hist.evals]
        assert means and all(math.isfinite(x) for x in means), (name, means)
        print(json.dumps({
            "wallclock": name, "overrides": overrides,
            "config": f"tinygpt-15m full width, {scn.n_workers} workers "
                      f"{scn.paces}, H={scn.inner_steps}, batch "
                  f"{scn.batch_size} x {scn.seq_len}, "
                      "deterministic commit order",
            "arrivals_equal": "golden and sim twin",
            "digest_equal_sim": digest == sim_digest,
            "max_abs_diff_by_leaf": leaf_diff,
            "launches": {k: v for k, v in counts.items() if v},
            "applied": applied,
            **runtime_line(eng, hist, wall, check_ms, sim_wall),
            "eval_means": means}))
        del eng, params
        gc.collect()
        torch.cuda.empty_cache()
    init, *_, sim_params = next(iter(twins.values()))
    print(json.dumps({
        "payload_crc": "tinygpt-15m full-width delta, 43 fp32 leaves",
        **crc_timing(torch, sim_params)}))
    twins.clear()
    # what the checksum costs end to end: wallclock_hetero once more with
    # payload_crc a constant on both sides (a diagnostic run: no fault is
    # injected, so nothing rides on the checksum)
    from repro_torch.async_engine import faults as faults_lib
    from repro_torch.async_engine import runtime as runtime_lib
    scn = registry.get_scenario("wallclock_hetero").overridden(**FULL_WIDTH)
    saved = runtime_lib.payload_crc, faults_lib.payload_crc
    runtime_lib.payload_crc = faults_lib.payload_crc = lambda payload: 0
    try:
        eng = scn.build(device=dev, init_params=init)
        hist, wall, check_ms = timed_run(eng, scn)
    finally:
        runtime_lib.payload_crc, faults_lib.payload_crc = saved
    assert trace.param_digest(eng.server.state.params) == \
        digests["wallclock_hetero"], "the run without a CRC ended elsewhere"
    print(json.dumps({"wallclock_without_crc": "wallclock_hetero",
                      **runtime_line(eng, hist, wall, check_ms)}))
    del eng

    for name in WALLCLOCK_FREE:
        res = trace.verify(registry.get_scenario(name), device=dev)
        assert res.ok, res.report()
        s = res.details["stats"]
        print(json.dumps({
            "wallclock_free_smoke": name, "golden": "within FREE_BANDS",
            **{k: s[k] for k in ("arrivals", "wall_seconds",
                                 "compute_parallelism", "overlap_mean",
                                 "server_occupancy")},
            "delivery": {k: v for k, v in s["delivery"].items() if v}}))
    for name in WALLCLOCK_FREE:
        scn = registry.get_scenario(name).overridden(**FULL_WIDTH)
        rec = TelemetryRecorder()
        eng = scn.build(device=dev, telemetry=rec)
        hist, wall, check_ms = timed_run(eng, scn, reset=True)
        counts = kernels.launch_counts()
        applied = sum(not a["dropped"] for a in hist.arrivals)
        assert len(hist.arrivals) == scn.outer_steps, (name, hist.arrivals)
        want = dict.fromkeys(counts, 0)
        want.update(dict.fromkeys(HELOCO, applied))
        assert counts == want, f"{name}: launches {counts}, want {want}"
        for k in HELOCO:
            totals[k][0] += counts[k]
            totals[k][1] += applied
        means = [e["mean"] for e in hist.evals]
        assert means and all(math.isfinite(x) for x in means), (name, means)
        deaths = [f.wid for f in rec.faults() if f.event == "liveness_dead"]
        if scn.faults is not None:
            assert PARTITIONED in deaths, \
                f"{name}: worker {PARTITIONED} never declared dead ({deaths})"
        # a death outside the partition is a false one (a heartbeat thread
        # starved of the GIL); each should be followed by its revival
        events = [(f.event, f.wid) for f in rec.faults()
                  if f.event in ("liveness_dead", "liveness_revive")]
        false_deaths = [(i, wid) for i, (ev, wid) in enumerate(events)
                        if ev == "liveness_dead" and wid != PARTITIONED]
        unrevived = [wid for i, wid in false_deaths
                     if ("liveness_revive", wid) not in events[i + 1:]]
        print(json.dumps({
            "wallclock_free": name, "config": "tinygpt-15m full width, "
            f"{scn.n_workers} workers {scn.paces}, H={scn.inner_steps}, "
            f"batch 4 x 128, pace_scale {scn.pace_scale}",
            "launches": {k: v for k, v in counts.items() if v},
            "liveness_deaths_by_wid": deaths,
            "revivals_by_wid": [f.wid for f in rec.faults()
                                if f.event == "liveness_revive"],
            "false_deaths_by_wid": [wid for _, wid in false_deaths],
            "false_deaths_unrevived": unrevived,
            **runtime_line(eng, hist, wall, check_ms), "eval_means": means}))
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return totals


def wallclock_only(torch, kernels, specs, dev, bound, log, lib):
    """``--only wallclock``: the wall-clock phase alone (packed.cu built)."""
    wallclock_phase(torch, kernels, {}, dev)


def wire_timing(torch, task, res, dev):
    """The socket transport's pieces on one full-width task and one result
    (``async_engine/proc.py``), each timed alone on the host clock, median
    of WIRE_REPS: the copy to the host (``host_task``/``host_result``), the
    pickle, the concatenation with the header, the frame's CRC32, one frame
    through a socket pair (``_send_frame`` on one end, ``_recv_frame`` on a
    reader thread: all of the above, the transfer, the receiver's CRC and
    unpickle), the unpickle alone, the pickle into its pieces as
    ``_send_frame`` makes it (no array copied), the copy back to the card
    (``device_task``/``device_result``) and, for the result, the server's
    ``payload_crc`` of its host form."""
    import pickle
    import socket
    import threading
    import zlib
    from repro_torch.async_engine import proc
    from repro_torch.async_engine.transport import Envelope, payload_crc

    def med(fn):
        times = []
        for _ in range(WIRE_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times)

    def through_socket(frame):
        a, b = socket.socketpair()
        got = {}
        reader = threading.Thread(
            target=lambda: got.setdefault("f", proc._recv_frame(b)))
        reader.start()
        proc._send_frame(a, threading.Lock(), frame)
        reader.join()
        a.close()
        b.close()
        return got["f"]

    out = {}
    for label, host, back, frame_of in (
            ("task", lambda: proc.host_task(task),
             lambda w: proc.device_task(w, dev),
             lambda h: ("task", h, (None, 0.0))),
            ("result", lambda: proc.host_result(res),
             lambda w: proc.device_result(w, dev),
             lambda h: ("msg", Envelope(wid=0, generation=0, seq=1,
                                        kind="result", payload=h, crc=0)))):
        h = host()
        frame = frame_of(h)
        data = pickle.dumps(frame, protocol=pickle.HIGHEST_PROTOCOL)
        hdr = proc._HDR.pack(len(data), zlib.crc32(data))
        row = {
            "frame_bytes": len(data) + len(hdr),
            "host_copy_ms": med(host),
            "pickle_ms": med(lambda: pickle.dumps(
                frame, protocol=pickle.HIGHEST_PROTOCOL)),
            "header_concat_ms": med(lambda: hdr + data),
            "frame_crc_ms": med(lambda: zlib.crc32(data)),
            "socket_frame_ms": med(lambda: through_socket(frame)),
            "unpickle_ms": med(lambda: pickle.loads(data)),
            "pickle_pieces_ms": med(lambda: proc._pickle_pieces(frame)),
        }
        wire = pickle.loads(data)
        row["copy_back_ms"] = med(lambda: back(wire[1] if label == "task"
                                               else wire[1].payload))
        if label == "result":
            row["payload_crc_host_ms"] = med(lambda: payload_crc(h))
        out[label] = row
    return out


def socket_phase(torch, kernels, untraced, dev="cuda"):
    """The runtime over worker processes (``async_engine/proc.py``) on the
    card.

    (a) Each SOCKET run at full width, batch 4 x 128, on the deterministic
    runtime over spawned worker processes, beside its sim twin and its
    threaded twin (the same scenario on ``transport="inproc"``) from the
    same initial bits: arrivals equal to the golden's and the twin's, the
    final parameters' fingerprint within TOL_FP of the sim twin's (whether
    the digests are bit-equal printed), chaos_lossy with socket_hetero's
    digest and its children's fault counters non-zero; with the counts set
    to 0 just before the run, the parent launches the server's kernels once
    per applied arrival and nothing else, and the children (their counts,
    from their ``stats`` frames) the int8 sweeps once per round. Then
    socket_hetero with worker 0's process SIGKILLed after SOCKET_KILL_AFTER
    commits: respawned, the golden's arrivals and the sim twin's
    fingerprint. Prints each run's ms per arrival (whole run, and after its
    first commit) beside its twins', the spawn and rendezvous seconds and
    ``stats_summary()``'s numbers.

    (b) ``wire_timing`` on one full-width task and its result.

    (c) chaos_partition over worker processes in free mode at full width,
    SOCKET_PARTITION_RUNS times: every arrival committed, the partitioned
    worker declared dead; prints the deaths outside the partition
    (``false_deaths_by_wid``) and those never revived.

    Returns per kernel (launches, arrivals or rounds of the runs it
    served); ``socket_hetero``'s run (not the SIGKILL one) goes into
    ``untraced`` for the obs phase."""
    import os
    import signal
    import threading
    from repro_torch import bridge
    from repro_torch.launch.train import FULL_WIDTH
    from repro_torch.scenarios import registry, run, trace
    from repro_torch.telemetry import TelemetryRecorder

    def per_arrival(wall, commits, n):
        return {"ms_per_arrival": 1e3 * wall / n,
                "ms_per_arrival_after_first":
                    1e3 * (commits[-1] - commits[0]) / max(len(commits) - 1,
                                                           1)}

    def spawn_line(eng):
        secs = sorted(eng._pool.spawn_seconds.values())
        return {"processes_spawned": len(secs),
                "spawn_rendezvous_s": secs}

    def parent_wire(eng):
        """Time the parent's side of the wire during the run: each frame
        body its reader threads read (over 1 MB), each task the server
        thread frames and sends (``pool.submit``), each result it puts
        back on the card (``device_result``), and each delivered round's
        own compute time in its child. Returns a function that summarises
        them and restores the originals."""
        from repro_torch.async_engine import proc
        from repro_torch.async_engine import runtime as runtime_lib
        spans = {"frame_body_read_ms": [], "submit_ms": [],
                 "result_to_device_ms": [], "child_round_ms": []}
        saved = proc._read_exact, runtime_lib.device_result

        def timed(fn, key, keep=lambda *a: True):
            def call(*a, **k):
                t0 = time.perf_counter()
                out = fn(*a, **k)
                if keep(*a):
                    spans[key].append(1e3 * (time.perf_counter() - t0))
                return out
            return call
        proc._read_exact = timed(saved[0], "frame_body_read_ms",
                                 lambda sock, n: n > 1 << 20)
        to_device = timed(saved[1], "result_to_device_ms")

        def device_result(res, device):
            spans["child_round_ms"].append(1e3 * res.compute_seconds)
            return to_device(res, device)
        runtime_lib.device_result = device_result
        eng._pool.submit = timed(eng._pool.submit, "submit_ms")

        def done():
            proc._read_exact, runtime_lib.device_result = saved
            return {k: {"n": len(v), "median": statistics.median(v),
                        "max": max(v), "sum": sum(v)} if v else None
                    for k, v in spans.items()}
        return done

    totals = {k: [0, 0] for k in HELOCO + INT8}
    twins, threaded_ms, digests = {}, {}, {}
    wire_inputs = None
    runs = [(name, ov, single, child, False)
            for name, ov, single, child in SOCKET]
    runs.append(("socket_hetero", {}, HELOCO, (), True))
    for name, overrides, single, child, kill in runs:
        scn = registry.get_scenario(name).overridden(**FULL_WIDTH,
                                                     **overrides)
        twin = scn.overridden(name="sim twin", description="", engine="sim",
                              faults=None, transport="inproc")
        if twin not in twins:
            sim = twin.build(device=dev)
            init = bridge.to_numpy(sim.server.state.params)
            if wire_inputs is None:
                # one full-width task and its result, from an engine of
                # their own
                other = twin.build(device=dev, init_params=init)
                task = other._make_task(other.workers[0])
                wire_inputs = (task, other._execute(task))
                del other
            sim_hist, sim_wall, _, sim_commits = run_timed(
                torch, kernels, sim, twin)
            state = sim.server.state.params
            twins[twin] = (init, run.arrival_rows(sim_hist),
                           trace.param_fingerprint(state),
                           trace.param_digest(state),
                           per_arrival(sim_wall, sim_commits,
                                       len(sim_hist.arrivals)))
            del sim, state
        init, sim_rows, sim_fp, sim_digest, sim_ms = twins[twin]
        inproc = scn.overridden(transport="inproc")
        if inproc not in threaded_ms:
            threaded = inproc.build(device=dev, init_params=init)
            th_hist, th_wall, _, th_commits = run_timed(
                torch, kernels, threaded, inproc)
            assert run.arrival_rows(th_hist) == sim_rows, name
            threaded_ms[inproc] = per_arrival(th_wall, th_commits,
                                              len(th_hist.arrivals))
            del threaded
        th_ms = threaded_ms[inproc]
        eng = scn.build(device=dev, init_params=init)
        killed = {}
        if kill:
            def killer():
                deadline = time.monotonic() + 300
                while time.monotonic() < deadline:
                    if len(eng.history.arrivals) >= SOCKET_KILL_AFTER:
                        p = eng._pool._procs.get(0)
                        if p is not None and p.is_alive():
                            os.kill(p.pid, signal.SIGKILL)
                            killed["after"] = len(eng.history.arrivals)
                            return
                    time.sleep(0.002)
            threading.Thread(target=killer, daemon=True).start()
        wire_done = parent_wire(eng)
        try:
            hist, wall, check_ms, commits = run_timed(torch, kernels, eng,
                                                      scn, reset=True)
        finally:
            parent_spans = wire_done()
        counts = kernels.launch_counts()
        label = f"{name} over processes" + (" (SIGKILL)" if kill else "")
        bad = run.compare(scn, hist)
        assert not bad, f"{label}: {bad}"
        assert run.arrival_rows(hist) == sim_rows, \
            f"{label}: the arrivals are not the sim twin's"
        params = eng.server.state.params
        fails = []
        trace._cmp_fingerprint(fails, trace.param_fingerprint(params),
                               sim_fp, **TOL_FP)
        assert not fails, f"{label}: fingerprint off the sim twin's: {fails}"
        digest = trace.param_digest(params)
        s = eng.stats_summary()
        rounds = s["rounds"]
        applied = sum(not a["dropped"] for a in hist.arrivals)
        want = dict.fromkeys(counts, 0)
        want.update(dict.fromkeys(single, applied))
        assert counts == want, \
            f"{label}: parent launches {counts}, want {want}"
        child_want = dict.fromkeys(child, rounds)
        assert s["child_launches"] == child_want, \
            f"{label}: child launches {s['child_launches']}, want {child_want}"
        assert s["transport"] == "socket" and rounds >= applied, s
        for k in single:
            totals[k][0] += counts[k]
            totals[k][1] += applied
        for k in child:
            totals[k][0] += s["child_launches"][k]
            totals[k][1] += rounds
        if kill:
            assert killed and s["proc_restarts"] >= 1, (killed, s)
        else:
            digests[name] = digest
            if name in dict(OBS) and not overrides:
                untraced[name] = untraced_entry(eng, hist, wall, commits,
                                                counts, "socket")
        if name == "chaos_lossy":
            assert digest == digests["socket_hetero"], \
                f"{label}: not socket_hetero's bits"
            assert all(s["delivery"][k] > 0
                       for k in CHAOS_TWINS[name]), s["delivery"]
        means = [e["mean"] for e in hist.evals]
        assert means and all(math.isfinite(x) for x in means), (name, means)
        print(json.dumps({
            "socket": label, "overrides": overrides,
            "config": f"tinygpt-15m full width, {scn.n_workers} worker "
                      f"processes {scn.paces}, H={scn.inner_steps}, batch "
                      "4 x 128, deterministic commit order",
            "arrivals_equal": "golden and sim twin",
            "digest_equal_sim": digest == sim_digest,
            "launches_parent": {k: v for k, v in counts.items() if v},
            "launches_children": s["child_launches"], "applied": applied,
            "killed_after_commits": killed.get("after"),
            "proc_exits": s["proc_exits"],
            "proc_restarts": s["proc_restarts"],
            **spawn_line(eng),
            **per_arrival(wall, commits, len(hist.arrivals)),
            "threaded_twin": th_ms, "sim_twin": sim_ms,
            "parent_wire": parent_spans,
            **{k: v for k, v in runtime_line(eng, hist, wall,
                                             check_ms).items()
               if k != "ms_per_arrival"},
            "eval_means": means}))
        del eng, params
        gc.collect()
        torch.cuda.empty_cache()
    task, res = wire_inputs
    print(json.dumps({"socket_wire": "tinygpt-15m full width: params + "
                                     "AdamW m, v out; delta + m, v back",
                      "reps": WIRE_REPS,
                      **wire_timing(torch, task, res, dev)}))
    del task, res, wire_inputs
    twins.clear()

    def beacon_clock(eng):
        """Each beacon the server thread takes in: its worker, its send
        instant (the child's clock) and the instant it was taken in."""
        seen = []
        note = eng._note_heartbeat

        def noted(env):
            seen.append((env.wid, env.sent_time, time.monotonic()))
            return note(env)
        eng._note_heartbeat = noted
        return seen

    def beacon_line(seen, interval):
        """Per worker outside the partition: the largest gap between two
        beacons' send instants (where the child could not send) and the
        lag from send to intake (where the parent had not yet read)."""
        out = {}
        for wid in sorted({w for w, _, _ in seen} - {PARTITIONED}):
            sent = sorted(t for w, t, _ in seen if w == wid)
            lag = sorted(1e3 * (r - t) for w, t, r in seen if w == wid)
            gaps = [1e3 * (b - a) for a, b in zip(sent, sent[1:])]
            out[wid] = {"beacons": len(sent),
                        "send_gap_ms_max": max(gaps, default=0.0),
                        "send_gaps_over_threshold": sum(
                            g >= 3e3 * interval for g in gaps),
                        "lag_ms_median": lag[len(lag) // 2],
                        "lag_ms_max": lag[-1]}
        return out

    scn = registry.get_scenario("chaos_partition").overridden(
        **FULL_WIDTH, transport="socket")
    for i in range(SOCKET_PARTITION_RUNS):
        rec = TelemetryRecorder()
        eng = scn.build(device=dev, telemetry=rec)
        seen = beacon_clock(eng)
        wire_done = parent_wire(eng)
        try:
            hist, wall, check_ms, commits = run_timed(torch, kernels, eng,
                                                      scn, reset=True)
        finally:
            parent_spans = wire_done()
        counts = kernels.launch_counts()
        applied = sum(not a["dropped"] for a in hist.arrivals)
        assert len(hist.arrivals) == scn.outer_steps, hist.arrivals
        want = dict.fromkeys(counts, 0)
        want.update(dict.fromkeys(HELOCO, applied))
        assert counts == want, f"chaos_partition: launches {counts}"
        for k in HELOCO:
            totals[k][0] += counts[k]
            totals[k][1] += applied
        means = [e["mean"] for e in hist.evals]
        assert means and all(math.isfinite(x) for x in means), means
        deaths = [f.wid for f in rec.faults() if f.event == "liveness_dead"]
        assert PARTITIONED in deaths, \
            f"chaos_partition: worker {PARTITIONED} never declared dead"
        events = [(f.event, f.wid) for f in rec.faults()
                  if f.event in ("liveness_dead", "liveness_revive")]
        false_deaths = [(j, wid) for j, (ev, wid) in enumerate(events)
                        if ev == "liveness_dead" and wid != PARTITIONED]
        unrevived = [wid for j, wid in false_deaths
                     if ("liveness_revive", wid) not in events[j + 1:]]
        s = eng.stats_summary()
        print(json.dumps({
            "socket_free": "chaos_partition", "run": i,
            "config": "tinygpt-15m full width, "
            f"{scn.n_workers} worker processes {scn.paces}, "
            f"H={scn.inner_steps}, batch 4 x 128, pace_scale "
            f"{scn.pace_scale}, beats every "
            f"{scn.faults.heartbeat_interval} s, dead after "
            f"{scn.faults.liveness_misses} misses",
            "launches_parent": {k: v for k, v in counts.items() if v},
            "liveness_deaths_by_wid": deaths,
            "revivals_by_wid": [f.wid for f in rec.faults()
                                if f.event == "liveness_revive"],
            "false_deaths_by_wid": [wid for _, wid in false_deaths],
            "false_deaths_unrevived": unrevived,
            "beacons_by_wid": beacon_line(seen,
                                          scn.faults.heartbeat_interval),
            "delivery_channels": s["delivery_channels"],
            "parent_wire": parent_spans,
            "host_memory_after": host_memory(),
            **spawn_line(eng),
            **per_arrival(wall, commits, len(hist.arrivals)),
            **{k: v for k, v in runtime_line(eng, hist, wall,
                                             check_ms).items()
               if k != "ms_per_arrival"},
            "eval_means": means}))
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return totals


def socket_only(torch, kernels, specs, dev, bound, log, lib):
    """``--only socket``: the socket phase alone (packed.cu built)."""
    t0 = time.perf_counter()
    socket_phase(torch, kernels, {}, dev)
    print(f"socket phase: {time.perf_counter() - t0:.1f}s")


def untraced_entry(eng, hist, wall, commits, counts, phase):
    """What the obs phase holds a traced run to: an untraced run's digest,
    launches (the children's too) and ms per arrival, and where it ran."""
    from repro_torch.scenarios import trace
    n = len(hist.arrivals)
    s = eng.stats_summary() if hasattr(eng, "stats_summary") else {}
    return {"digest": trace.param_digest(eng.server.state.params),
            "launches": dict(counts),
            "child_launches": s.get("child_launches", {}),
            "ms_per_arrival": 1e3 * wall / n,
            "ms_per_arrival_after_first":
                1e3 * (commits[-1] - commits[0]) / max(len(commits) - 1, 1),
            "phase": phase}


def span_table(events, n):
    """Count, total ms, ms per arrival (of ``n``), median and largest ms of
    each span name."""
    by = {}
    for name, _cat, ph, _start, dur, _tid, _args in events:
        if ph == "X":
            by.setdefault(name, []).append(1e3 * dur)
    return {name: {"count": len(ms), "total_ms": sum(ms),
                   "ms_per_arrival": sum(ms) / n,
                   "median_ms": statistics.median(ms), "max_ms": max(ms)}
            for name, ms in sorted(by.items(), key=lambda kv: -sum(kv[1]))}


def obs_phase(torch, kernels, untraced, dev="cuda"):
    """Observability (``repro_torch.obs``) at full width on the card.

    Each OBS run traced (a ``SpanTracer``) with a ``TelemetryRecorder``
    streaming live to ``build/obs/<name>.jsonl`` (a "runtime" record after
    every commit), beside its untraced twin: the one an earlier phase ran
    (``untraced``, filled by the slice, wall-clock and socket phases) or,
    when no phase did (``--only obs``), one run here first. Checks: the
    golden's arrivals; the parameter digest bit-equal to the twin's; the
    launches (the children's too) the twin's; the written trace valid by
    ``validate_chrome_trace``; over processes a process row of child spans
    and a final obs report from every worker (``assert_child_reports``) and
    a "transport" record from each child pid; the console's render and the
    dashboard's panels of the stream non-empty where the run feeds them
    (arrivals and their rate, staleness, quality, per-language loss,
    workers, runtime health; transport over processes), the two views
    equal, the stream drift-free. Prints per run the ms per arrival traced
    and untraced, each span name's count and ms per arrival (the parent's
    and the children's apart), the trace's events and bytes and, over
    processes, the obs frames per child and the merged wire counters. The
    simulator's run once more traced without telemetry (the same bits):
    its ``server_commit`` spans beside the first run's, what the server's
    stats path adds to a commit.
    Returns per kernel (launches, applied arrivals)."""
    from repro_torch.launch.train import FULL_WIDTH
    from repro_torch.obs import web
    from repro_torch.obs.console import ConsoleState, render
    from repro_torch.obs.spans import SpanTracer, validate_chrome_trace
    from repro_torch.obs.tail import read_complete_lines
    from repro_torch.scenarios import registry, run
    from repro_torch.scenarios import trace as trace_lib
    from repro_torch.telemetry import StreamDecoder, TelemetryRecorder, schema

    out_dir = ROOT / "build" / "obs"
    out_dir.mkdir(parents=True, exist_ok=True)
    totals = {k: [0, 0] for k in HELOCO}
    if len(untraced) < len(OBS):
        # no timed run pays the first launches
        warm = registry.get_scenario("paper_hetero_severe").overridden(
            **FULL_WIDTH, outer_steps=2)
        run_timed(torch, kernels, warm.build(device=dev), warm)
    for name, engine in OBS:
        scn = registry.get_scenario(name).overridden(**FULL_WIDTH)
        twin = untraced.get(name)
        if twin is None:
            eng = scn.build(device=dev)
            hist, wall, _, commits = run_timed(torch, kernels, eng, scn,
                                               reset=True)
            twin = untraced_entry(eng, hist, wall, commits,
                                  kernels.launch_counts(), "obs phase")
            del eng
            gc.collect()
            torch.cuda.empty_cache()
        sink = out_dir / f"{name}.jsonl"
        rec, tr = TelemetryRecorder(sink=str(sink)), SpanTracer()
        eng = scn.build(device=dev, telemetry=rec, tracer=tr,
                        runtime_record_every=1)
        try:
            hist, wall, _, commits = run_timed(torch, kernels, eng, scn,
                                               reset=True)
        finally:
            rec.close()
        counts = kernels.launch_counts()
        label = f"{name} traced ({engine})"
        bad = run.compare(scn, hist)
        assert not bad, f"{label}: {bad}"
        traced = untraced_entry(eng, hist, wall, commits, counts, "obs")
        assert traced["digest"] == twin["digest"], \
            f"{label}: not the untraced run's bits"
        assert counts == twin["launches"], \
            f"{label}: launches {counts}, untraced {twin['launches']}"
        assert traced["child_launches"] == twin["child_launches"], label
        applied = sum(not a["dropped"] for a in hist.arrivals)
        for k in HELOCO:
            assert counts[k] == applied, (label, counts)
            totals[k][0] += counts[k]
            totals[k][1] += applied
        path = tr.write(str(out_dir / f"{name}.trace.json"))
        with open(path) as f:
            doc = json.load(f)
        problems = validate_chrome_trace(doc)
        assert not problems, f"{label}: trace invalid: {problems[:4]}"
        n = len(hist.arrivals)
        line = {"obs": name, "engine": engine,
                "config": f"tinygpt-15m full width, {scn.n_workers} workers "
                          f"{scn.paces}, H={scn.inner_steps}, batch 4 x 128",
                "arrivals": n, "arrivals_equal": "golden",
                "digest_equal_untraced": True, "untraced_from": twin["phase"],
                "launches": {k: v for k, v in counts.items() if v},
                "ms_per_arrival": {"traced": traced["ms_per_arrival"],
                                   "untraced": twin["ms_per_arrival"]},
                "ms_per_arrival_after_first": {
                    "traced": traced["ms_per_arrival_after_first"],
                    "untraced": twin["ms_per_arrival_after_first"]},
                "spans": span_table(tr._events, n),
                "trace_events": len(doc["traceEvents"]),
                "trace_bytes": os.path.getsize(path)}
        lines = read_complete_lines(str(sink))
        dec = StreamDecoder(strict=True)
        kinds = {}
        for ln in lines:
            kind = schema.kind_of(dec.decode(ln))
            kinds[kind] = kinds.get(kind, 0) + 1
        assert dec.drift_report() == [], dec.drift_report()
        state = ConsoleState()
        for ln in lines:
            state.add_line(ln)
        text = render(state, width=78, color=False)
        panels = web.snapshot_panels(str(sink))
        assert panels == state.panels(), f"{label}: console and web differ"
        needles = ["arrivals", "staleness histogram", "cos(D,m)",
                   "per-language loss", "workers", "runtime health"]
        want = ["arrivals", "staleness", "quality", "per_language",
                "workers", "runtime"]
        if engine == "worker processes":
            needles.append("transport (per worker process)")
            want.append("transport")
        missing = [x for x in needles if x not in text]
        assert not missing, f"{label}: console lacks {missing}:\n{text}"
        empty = [k for k in want if not panels[k]]
        assert not empty, f"{label}: empty panels {empty}"
        assert panels["arrivals"]["commits"] == n and \
            panels["arrivals"]["rate_per_sec"] > 0, panels["arrivals"]
        line.update(stream_records=kinds, console_lines=len(text.splitlines()),
                    panels=sorted(k for k, v in panels.items() if v))
        if engine == "worker processes":
            eng.assert_child_reports()
            report = eng.stats_summary()["child_obs"]
            wids = list(range(scn.n_workers))
            assert report["final"] == wids, report
            rows = sorted(e["args"]["name"] for e in doc["traceEvents"]
                          if e["name"] == "process_name" and e["pid"])
            assert rows == sorted(f"heloco-worker-{w} (pid {p})"
                                  for w, p in eng._child_wire), rows
            assert sorted(w for w, _ in eng._child_wire) == wids, rows
            tps = {r.pid for r in map(StreamDecoder().decode, lines)
                   if isinstance(r, schema.TransportMetrics)}
            assert tps == {p for _, p in eng._child_wire}, tps
            assert len(panels["transport"]["workers"]) >= scn.n_workers
            child = [e for row in tr._foreign.values()
                     for e in row["events"]]
            line.update(child_rows=rows,
                        child_spans=span_table(child, n),
                        obs_frames_by_wid=report["reports"],
                        obs_final=report["final"], wire=report["wire"])
        if engine == "sim":
            bare = SpanTracer()
            other = scn.build(device=dev, tracer=bare)
            run_timed(torch, kernels, other, scn, reset=True)
            assert trace_lib.param_digest(other.server.state.params) == \
                twin["digest"], f"{name} traced without telemetry"
            assert kernels.launch_counts() == counts, name

            def commit_ms(events):
                return statistics.median(1e3 * e[4] for e in events
                                         if e[0] == "server_commit")
            line["server_commit_ms_median"] = {
                "telemetry": commit_ms(tr._events),
                "no_telemetry": commit_ms(bare._events)}
            del other
        print(json.dumps(line))
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return totals


def obs_only(torch, kernels, specs, dev, bound, log, lib):
    """``--only obs``: the obs phase alone (packed.cu built), each untraced
    twin run in it."""
    t0 = time.perf_counter()
    obs_phase(torch, kernels, {}, dev)
    print(f"obs phase: {time.perf_counter() - t0:.1f}s")


def single_tensor_phase(torch, kernels, specs, dev):
    """The single-tensor entry point: one per-leaf Nesterov step through
    ``ops.outer_update_block`` on each leaf of a full-width state, with the
    counts set to 0 just before and read just after; each leaf bit for bit
    against the plain version. Returns outer_update_2d's launches."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import outer_update as ok
    gen = torch.Generator(device=dev).manual_seed(3)
    state = {k: [torch.randn(t.shape, generator=gen, device=dev)
                 for _ in range(3)] for k, t in specs.items()}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = {k: ops.outer_update_block(*pmg, 0.7, 0.9, 0.5)
           for k, pmg in state.items()}
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = dict.fromkeys(counts, 0)
    want["outer_update_2d"] = len(specs)
    assert counts == want, f"single-tensor path launched {counts}"
    for k, pmg in state.items():
        plain = ok.outer_update_2d_ref(*pmg, 0.7, 0.9, 0.5)
        assert all(torch.equal(a, b) for a, b in zip(out[k], plain)), k
    print(f"single-tensor path: outer_update_block over {len(specs)} "
          f"leaves, {counts['outer_update_2d']} outer_update_2d launches, "
          "each leaf bit-identical to the plain version")
    return counts["outer_update_2d"]


def replay_phase(torch):
    """Eight pseudo-gradients from inner rounds on the card (each from the
    packed server's look-ahead at that step), fed to a packed server and a
    per-leaf kernel server with ``drop_stale_after=2`` at the staleness of
    REPLAY, both with telemetry: the same drops, p and m within TOL_SERVERS
    after every arrival, and each arrival's moments (the packed sweep's
    with_stats output summed) within TOL_SUM of the per-leaf server's
    ``telemetry/stats.reference_moments`` of the same delta and momentum."""
    import dataclasses
    from repro_torch.async_engine.server import Synchronizer
    from repro_torch.core import packing
    from repro_torch.launch.train import FULL_WIDTH
    from repro_torch.scenarios import registry

    scn = registry.get_scenario("paper_hetero_severe").overridden(
        **FULL_WIDTH)
    eng = scn.build(device="cuda")
    cfg = dataclasses.replace(eng.cfg.outer, drop_stale_after=2)
    init = eng.server.state.params
    packed = Synchronizer(init, cfg, eng.cfg.n_workers, telemetry=True)
    leaf = Synchronizer(init, cfg, eng.cfg.n_workers, packed=False,
                        use_kernel=True, telemetry=True)
    eng.server = packed                 # rounds start from its look-ahead
    worst, dropped, worst_moment = 0.0, [], 0.0
    for s_i, wid in REPLAY:
        delta = eng._execute(eng._make_task(eng.workers[wid])).delta
        a = packed.on_arrival(delta, s_i, wid)
        b = leaf.on_arrival(delta, s_i, wid)
        assert a.dropped == b.dropped, (a, b)
        dropped.append(a.dropped)
        got = packed._last_moments.double()
        want = leaf._last_moments.double()
        dot, dd, mm, ee = want.tolist()
        scale = torch.tensor([math.sqrt(max(dd * mm, 0.0)), dd, mm, ee],
                             dtype=torch.float64, device=want.device)
        err = ((got - want).abs() / scale.clamp_min(1e-30)).max().item()
        assert err <= TOL_SUM, (f"replay step {packed.t}: moments "
                                f"{got.tolist()} against {want.tolist()}")
        worst_moment = max(worst_moment, err)
        for name, buf, tree in (("p", packed._pbuf, leaf.state.params),
                                ("m", packed._mbuf, leaf.state.momentum)):
            got = packing.pack(packed.layout, tree)
            assert torch.allclose(got, buf, rtol=TOL_SERVERS,
                                  atol=TOL_SERVERS), (
                f"replay step {packed.t}: per-leaf {name} off the packed "
                f"server's by {(got - buf).abs().max().item()}")
            worst = max(worst, (got - buf).abs().max().item())
    assert dropped == [False, False, False, True, False, True, False, True]
    print(json.dumps({"replay": "paper_hetero_severe full width, "
                                "drop_stale_after=2",
                      "arrivals": len(REPLAY), "dropped": dropped,
                      "max_abs_diff_p_m": worst, "band": TOL_SERVERS,
                      "moments_max_rel_err": worst_moment,
                      "moments_band": TOL_SUM}))


def int8_kernel_phase(torch, specs, dev, bound):
    """The per-tensor int8 kernels of ``csrc/quantize.cu`` on the largest
    leaf (the tied embedding) held to their plain versions bit for bit: a
    block on exact .5 ties (max|x| 63.5, so the scale is 0.5), an all-zero
    tensor (the 1e-12 scale floor), a clipped case (quantize_2d given an
    absmax of 2, a third of the elements beyond it), a NaN element, an odd
    length, an x offset by one element, lengths 15, 16 and 17 (around one
    16-element unit of the vector body), q offset by 1, 2 and 3 bytes
    (the kernels' element-by-element tail and path) and quotients next to
    every half-integer at two scales (``quantize.near_half_quotients``);
    then timed, with the library yardsticks (``quantize_per_tensor`` for
    quantize_2d, and the count of int8 values where it differs). Each
    timed call takes its input from a rotation of copies (x: 3 of 51.5 MB,
    q: 8 of 12.9 MB), so that it reads it from memory, as the bounds count
    it, and not from L2, where the call before would leave q. Returns their
    rows."""
    from repro_torch.kernels import quantize as qk
    n = max(t.numel() for t in specs.values())
    gen = torch.Generator(device=dev).manual_seed(4)
    x = 2.0 * torch.randn(n, generator=gen, device=dev)
    x[:128] = (torch.arange(-64, 64, device=dev, dtype=torch.float32)
               + 0.5) * 0.5
    x[0] = 63.5

    def same(a, b):
        """Equal dtype, shape and values, NaN where the other has NaN."""
        nan = a.isnan() & b.isnan()
        return a.dtype == b.dtype and a.shape == b.shape and bool(
            ((a == b) | nan).all())

    def check(label, t, amax=None):
        got = qk.absmax(t)
        q, s = qk.quantize_2d(t, amax if amax is not None else got)
        back = qk.dequantize_2d(q, s)
        torch.cuda.synchronize()
        want_q, want_s = qk.quantize_2d_ref(t, amax)
        for name, a, b in (("absmax", got, qk.absmax_ref(t)),
                           ("quantize_2d q", q, want_q),
                           ("quantize_2d scale", s, want_s),
                           ("dequantize_2d", back,
                            qk.dequantize_2d_ref(want_q, want_s))):
            assert same(a, b), (f"{name} ({label}) differs from the plain "
                                f"version in {(a != b).sum().item()} entries")
        return q, s

    q, s = check("embedding, a tie block", x)
    assert s.item() == 0.5 and q[1:5].tolist() == [-62, -62, -60, -60], \
        "quantize_2d does not round half to even"
    q0, s0 = check("all zero", torch.zeros(n, device=dev))
    assert not q0.any() and s0.item() == (
        torch.tensor(1e-12) / torch.tensor(127.0)).item(), s0
    qc, _ = check("clipped", x, amax=torch.full((1,), 2.0, device=dev))
    assert (qc.abs() == 127).sum().item() > 1000, "nothing clipped"
    xn = x.clone()
    xn[n // 2] = float("nan")
    qn, sn = check("a NaN", xn)
    assert sn.isnan().all() and not qn.any()
    check("odd length", x[:n - 3])
    check("unaligned view", x[1:])
    for m in (15, 16, 17):                   # around one 16-element unit
        check(f"length {m}", x[:m])
    for off in (1, 2, 3):                    # q not 16-byte aligned
        view = q[off:]
        assert same(qk.dequantize_2d(view, s),
                    qk.dequantize_2d_ref(view, s)), \
            f"dequantize_2d (q offset by {off} bytes) differs"
    # quotients next to every half-integer: where the body's x * (1/s)
    # hands over to the IEEE division
    for sv in (0.37, 7.77e-9):
        check(f"quotients near half-integers, s {sv}",
              qk.near_half_quotients(sv, dev),
              torch.full((1,), 127.0 * sv, device=dev))
    print(f"int8 kernels agree on {n} elements: absmax, quantize_2d and "
          "dequantize_2d bit-identical to their plain versions (ties to "
          "even, zero tensor, clip, NaN, odd length, unaligned x, lengths "
          "15-17, q offset by 1-3 bytes, quotients near half-integers)")

    amax = qk.absmax(x)
    q, s = qk.quantize_2d(x, amax)
    s0d = s.reshape(())
    lib_deq = torch.mul(q, s0d)
    assert same(lib_deq, qk.dequantize_2d_ref(q, s)), \
        "the dequantize yardstick computes another function"
    xs, qs = rotating(x, 3), rotating(q, 8)
    pair = {"pair_ms": time_ms(lambda: qk.dequantize_2d(
                *qk.quantize_2d(xs(), amax))),
            "library_pair_ms": time_ms(
                lambda: torch.fake_quantize_per_tensor_affine(
                    xs(), s0d, torch.zeros((), dtype=torch.int32, device=dev),
                    -127, 127)),
            "library_pair_call": "torch.fake_quantize_per_tensor_affine"}
    # quantize_2d's yardstick: torch.quantize_per_tensor, the scale handed
    # over as a host value read before the timing; PyTorch multiplies by a
    # rounded 1/s where the kernel divides, so the int8 values may differ
    s_host = s.item()
    per_tensor, call, differ = quantized_yardstick(
        lambda: torch.quantize_per_tensor(xs(), s_host, 0, torch.qint8),
        "torch.quantize_per_tensor(x, s, 0, torch.qint8)", q)
    f4 = 4
    rows = []
    for name, fn, plain, lib, call, nbytes, nflops in (
            ("absmax", lambda: qk.absmax(xs()), lambda: qk.absmax_ref(xs()),
             lambda: torch.linalg.vector_norm(xs(), float("inf")),
             "torch.linalg.vector_norm(x, inf)", n * f4 + f4, 2 * n),
            ("quantize_2d", lambda: qk.quantize_2d(xs(), amax),
             lambda: qk.quantize_2d_ref(xs(), amax), per_tensor, call,
             n * f4 + n + 2 * f4, 4 * n),
            ("dequantize_2d", lambda: qk.dequantize_2d(qs(), s),
             lambda: qk.dequantize_2d_ref(qs(), s),
             lambda: torch.mul(qs(), s0d),
             "torch.mul(q, s): the same bits", n + n * f4 + f4, n)):
        b_ms, by = bound(nbytes, nflops)
        rows.append({"name": name, "ms": time_ms(fn),
                     "plain_ms": time_ms(plain), "bound_ms": b_ms,
                     "bound_by": by, "max_abs_err": 0.0,
                     "library_ms": time_ms(lib) if lib else None,
                     "library_call": call, "bytes": nbytes, "flops": nflops,
                     "n": n, **(pair if name != "absmax" else {}),
                     **({"library_int8_differ": differ}
                        if name == "quantize_2d" else {})})
    return rows


def quantized_yardstick(fn, call, want):
    """A deprecated quantized-tensor call as a yardstick, timed only: (fn,
    call, how many of its int8 values differ from ``want``); or, where the
    card's PyTorch refuses it, (None, its error in its own words, None)."""
    try:
        got = fn().int_repr()
    except (RuntimeError, NotImplementedError) as e:
        return None, f"{call} refused: {str(e).splitlines()[0]}", None
    return fn, call, int((got != want).sum())


def flash_flops(sq, skv, d, causal):
    """Operations of the two products over the scores the mask keeps
    (kv_idx <= q_idx on absolute indices): 2 * D each way per score."""
    kept = sum(min(i + 1, skv) for i in range(sq)) if causal else sq * skv
    return 4 * d * kept


def flash_phase(torch, dev, bound, bf16_peak, fp32_peak):
    """flash_attention_fwd of ``csrc/flash_attention.cu`` (bf16 wgmma, fp32
    3xTF32) against its plain version, bf16 within 2e-2 and fp32 within
    2e-5, at FLASH_SHAPES (D 32, 64, 128), FLASH_PADDED_SHAPES (D 16, 80,
    256, on padded widths) and FLASH_FAMILY_SHAPES, causal and not; then
    timed beside ``scaled_dot_product_attention`` at each shape, with the
    ratio to it and the share of the bound (operations at ``bf16_peak``,
    or in fp32 at ``fp32_peak``; bytes and operations of the true D).
    Returns the serve shape's bf16 causal row, the main path's, with the
    others under ``cases``."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(5)
    cases, errs = [], {}
    shapes = [(shape, None) for shape in FLASH_SHAPES + FLASH_PADDED_SHAPES]
    shapes += [(shape, arch) for arch, shape in FLASH_FAMILY_SHAPES.items()]
    for (bh, sq, skv, d), family in shapes:
        width = fa.SERVED_DIMS[d]
        base = [torch.randn((bh, s, d), generator=gen, device=dev)
                for s in (sq, skv, skv)]
        # the reference's chunks where they divide the sequences, else one
        chunk = 32 if sq != skv else min(128, sq)
        chunk = chunk if sq % chunk == 0 else sq
        kv_chunk = 128 if skv % 128 == 0 else skv
        for dtype in ("bfloat16", "float32"):
            q, k, v = (t.to(getattr(torch, dtype)) for t in base)
            for causal in (True, False):
                got = fa.flash_attention_fwd(q, k, v, causal=causal,
                                             q_chunk=chunk,
                                             kv_chunk=kv_chunk)
                want = fa.flash_attention_fwd_ref(q, k, v, causal)
                torch.cuda.synchronize()
                assert got.dtype == q.dtype and got.shape == q.shape
                err = (got.float() - want.float()).abs().max().item()
                tol = TOL_FLASH[dtype]
                assert torch.allclose(got.float(), want.float(), rtol=tol,
                                      atol=tol), (
                    f"flash_attention_fwd {dtype} causal={causal} "
                    f"({bh}, {sq}, {skv}, {d}) off its plain version by {err}")
                errs[dtype] = max(errs.get(dtype, 0.0), err)
                # the library call over (1, BH, S, D); is_causal keeps the
                # top-left triangle, kv_idx <= q_idx on absolute indices
                def sdpa(q=q, k=k, v=v, causal=causal):
                    return F.scaled_dot_product_attention(
                        q[None], k[None], v[None], is_causal=causal)
                lib_err = (sdpa()[0].float() - want.float()).abs().max()
                assert lib_err.item() <= 2 * tol, \
                    "the SDPA yardstick computes another function"
                el = q.element_size()
                nbytes = el * bh * d * (2 * sq + 2 * skv)
                nflops = bh * flash_flops(sq, skv, d, causal)
                peak = bf16_peak if dtype == "bfloat16" else fp32_peak
                b_ms, by = bound(nbytes, nflops, peak)
                # timed on q, k, v rotating over copies that exceed L2
                qs, ks, vs = cold(q), cold(k), cold(v)
                ms = time_ms(lambda: fa.flash_attention_fwd(
                    qs(), ks(), vs(), causal=causal, q_chunk=chunk,
                    kv_chunk=kv_chunk),
                    iters=10)
                lib_ms = time_ms(lambda: sdpa(qs(), ks(), vs()), iters=10)
                cases.append({
                    "name": "flash_attention_fwd", "dtype": dtype,
                    "causal": causal, "BH": bh, "Sq": sq, "Skv": skv, "D": d,
                    "padded_D": width, "family_serve_shape": family,
                    "ms": ms,
                    "plain_ms": time_ms(lambda: fa.flash_attention_fwd_ref(
                        qs(), ks(), vs(), causal), iters=10),
                    "bound_ms": b_ms, "bound_by": by, "max_abs_err": err,
                    "library_ms": lib_ms,
                    "library_call": "torch.nn.functional."
                                    "scaled_dot_product_attention",
                    "vs_library": ms / lib_ms, "bound_share": b_ms / ms,
                    "bytes": nbytes, "flops": nflops})
                print(f"flash D{width} {dtype} causal={causal} ({bh}, {sq}, "
                      f"{skv}, {d}){f' [{family}]' if family else ''}: "
                      f"{ms:.4f} ms, SDPA {lib_ms:.4f} ms "
                      f"({ms / lib_ms:.2f}x), bound {b_ms:.4f} ms ({by}), "
                      f"{b_ms / ms:.1%} of it; err {err:.2e}")
                print(json.dumps({"kernel": "flash_attention_fwd",
                                  **{k: v for k, v in cases[-1].items()
                                     if k != "name"}}))
        del base, q, k, v, got, want, qs, ks, vs
    print(f"flash_attention_fwd agrees with its plain version: bf16 err "
          f"{errs['bfloat16']:.3e} (tol {TOL_FLASH['bfloat16']}), fp32 err "
          f"{errs['float32']:.3e} (tol {TOL_FLASH['float32']}), "
          f"{len(cases)} cases")
    main_row = dict(cases[0])
    assert (main_row["dtype"], main_row["causal"]) == ("bfloat16", True)
    main_row["max_abs_err"] = max(errs.values())
    main_row["cases"] = [{k: c[k] for k in ("dtype", "causal", "BH", "Sq",
                                             "Skv", "D", "padded_D",
                                             "family_serve_shape", "ms",
                                             "plain_ms",
                                             "bound_ms", "library_ms",
                                             "vs_library", "bound_share",
                                             "max_abs_err")} for c in cases]
    return [main_row]


def _cuobjdump():
    from torch.utils.cpp_extension import CUDA_HOME
    found = [os.path.join(CUDA_HOME, "bin", "cuobjdump")] if CUDA_HOME else []
    found.append(shutil.which("cuobjdump"))
    try:
        import triton
        found.append(os.path.join(os.path.dirname(triton.__file__), "backends",
                                  "nvidia", "bin", "cuobjdump"))
    except ImportError:
        pass
    return next((c for c in found if c and os.path.isfile(c)), None)


def ptxas_report(log, route, label):
    """Print each kernel's registers, shared memory and spills from the
    ``-Xptxas -v`` log, and any wgmma serialisation it reports, for the
    kernels ``route`` names (a name or None)."""
    if log == "cached":
        print(f"{label}: built before this run, no ptxas report")
    name = None
    for line in log.splitlines():
        if "C7512" in line and route(line):
            print(f"ptxas {route(line)}: {line.split(':', 1)[1].strip()}")
        elif "Compiling entry function" in line:
            name = route(line)
        elif name and "spill stores" in line:
            print(f"ptxas {name}: {line.strip()}")
        elif name and "registers" in line:
            print(f"ptxas {name}: {line.split(':', 1)[1].strip()}")
            name = None


def sass_counts(lib, route):
    """Static instruction counts, opcode with its modifiers, of each kernel
    of the built library ``lib`` that ``route`` names (``cuobjdump -sass``;
    fails if ``cuobjdump`` is missing)."""
    tool = _cuobjdump()
    assert tool, ("cuobjdump not found (CUDA_HOME/bin, PATH, triton): the "
                  "kernels' SASS cannot be checked")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = route(line)
            if name:
                counts[name] = {}
            continue
        m = SASS_OP.search(line)
        if name and m:
            counts[name][m.group(1)] = counts[name].get(m.group(1), 0) + 1
    return counts


def flash_build_report(log, lib):
    """Each flash kernel's registers, shared memory and spills from
    ``-Xptxas -v`` (and any wgmma serialisation it reports), and its static
    instruction counts from ``cuobjdump -sass`` of the built library. Fails
    unless the library holds one kernel per type and padded width (and bf16
    from width 128 with 128-row q tiles too), every bf16 kernel holds HGMMA
    (wgmma) and UTMALDG (TMA loads), every fp32 kernel HMMA (the 3xTF32
    ``mma.sync``) and UTMALDG, and, where this run built the library, the
    report shows every kernel with zero spills and the launch registers
    its setmaxnreg counts assume; or if ``cuobjdump`` is missing."""
    def route(line):
        m = FLASH_KERNEL.search(line)
        return m and (("bf16" if m.group(1) != "f" else "fp32")
                      + f" D={m.group(2)} q{64 * int(m.group(3))}")
    ptxas_report(log, route, "flash kernels")
    counts = {}
    for name, ops in sass_counts(lib, route).items():
        counts[name] = {}
        for op, k in ops.items():
            base = op.split(".")[0]
            counts[name][base] = counts[name].get(base, 0) + k
    # bf16 and fp32 at every padded width, and bf16 from width 128 with
    # 128-row q tiles too
    from repro_torch.kernels.flash_attention import PADDED_WIDTHS
    assert len(counts) == 2 * len(PADDED_WIDTHS) + sum(
        w >= 128 for w in PADDED_WIDTHS), sorted(counts)
    for name, c in sorted(counts.items()):
        print(f"sass {name}: " + ", ".join(
            f"{op} {c.get(op, 0)}" for op in
            ("HGMMA", "HMMA", "UTMALDG", "LDS", "FFMA", "MUFU")))
        need = ("HGMMA", "UTMALDG") if name.startswith("bf16") else (
            "HMMA", "UTMALDG")
        assert all(c.get(op, 0) > 0 for op in need), (name, c)
    if log == "cached":
        print("flash kernels: spills not checked (library built before "
              "this run)")
    else:
        # spills, and the registers a thread has at launch: the consumers'
        # setmaxnreg count (232, or 104 at bf16 width 32 with two CTAs an
        # SM) takes what the producer gives up of exactly 168 (80)
        spills, regs, name = {}, {}, None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                name = route(line)
            elif name and "spill stores" in line:
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
                spills[name] = int(m.group(1)) + int(m.group(2))
            elif name and "Used" in line and "registers" in line:
                regs[name] = int(re.search(r"Used (\d+) registers",
                                           line).group(1))
                name = None
        assert set(spills) == set(regs) == set(counts), (
            sorted(spills), sorted(regs), sorted(counts))
        assert not any(spills.values()), spills
        assert all(r == (80 if n.startswith("bf16 D=32 ") else 168)
                   for n, r in regs.items()), regs
    print(f"flash kernels: HGMMA and UTMALDG in every bf16 kernel, HMMA and "
          f"UTMALDG in every fp32 kernel, {len(counts)} kernels"
          f"{'' if log == 'cached' else ', no spills, 168 (80) registers'} "
          f"({_cuobjdump()} -sass)")


def wide_access_report(log, lib, route, names, label):
    """The kernels ``route`` names: their registers, shared memory and
    spills from ``-Xptxas -v``, and their global and shared loads and
    stores from ``cuobjdump -sass``. Fails unless the library holds exactly
    the kernels ``names`` and each holds 128-bit global loads and stores
    (``LDG.E.128``, ``STG.E.128`` or their ``.EF`` and ``.CONSTANT``
    forms): a 16-byte streaming body."""
    ptxas_report(log, route, label)
    counts = sass_counts(lib, route)
    assert sorted(counts) == sorted(names), sorted(counts)
    for name, c in sorted(counts.items()):
        print(f"sass {name}: " + ", ".join(
            f"{op} {k}" for op, k in sorted(c.items())
            if op.startswith(("LDG", "STG", "LDS", "STS"))))
        for kind in ("LDG", "STG"):
            assert any(op.startswith(kind) and ".128" in op for op in c), (
                f"{name} holds no 128-bit {kind}: {c}")
    print(f"{label}: 128-bit global loads and stores (LDG/STG .128) in "
          + ", ".join(sorted(names)))


def int8_build_report(log, lib):
    """``wide_access_report`` of the int8 quantize and dequantize kernels
    (``csrc/quantize.cu``)."""
    def route(line):
        m = INT8_SWEEP.search(line)
        return m and m.group(1)
    wide_access_report(log, lib, route, ("quant_kernel", "dequant_kernel"),
                       "int8 kernels")


def leaf_build_report(log, lib):
    """``wide_access_report`` of the per-leaf elementwise kernels
    (``csrc/leaf.cu``: correct_apply on one block and on stacked blocks,
    outer_update), then the resident CTAs of 256 threads an SM of each
    from the CUDA occupancy query."""
    from repro_torch.kernels import heloco_correct as hk

    def route(line):
        m = LEAF_SWEEP.search(line)
        return m and m.group(1) + {None: "", "0": "[one block]",
                                   "1": "[stacked]"}[m.group(2)]
    names = ("correct_apply_kernel[one block]",
             "correct_apply_kernel[stacked]", "outer_update_kernel")
    wide_access_report(log, lib, route, names, "leaf kernels")
    print("leaf kernels, resident CTAs an SM: " + ", ".join(
        f"{k} {c}" for k, c in zip(names, hk.ctas_per_sm(0))))


def int8_path_phase(torch, kernels, specs, dev):
    """The per-tensor int8 entry points: ``ops.quantize_block`` and
    ``ops.dequantize_block`` on each leaf of a full-width state, with the
    counts set to 0 just before and read just after; each leaf bit for bit
    against ``kernels/ref.py``. Then the pass is timed: its device time
    (behind a hold that outlasts its dispatch) and its host time to a
    synchronised end, medians of 10. Returns the launches per kernel."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(6)
    state = {k: torch.randn(t.shape, generator=gen, device=dev)
             for k, t in specs.items()}

    def one_pass():
        out = {}
        for k, x in state.items():
            q, s, n = ops.quantize_block(x)
            out[k] = (q, s, n, ops.dequantize_block(q, s, tuple(x.shape)))
        return out

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = one_pass()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = dict.fromkeys(counts, 0)
    want.update(dict.fromkeys(INT8_KERNELS, len(specs)))
    assert counts == want, f"int8 path launched {counts}"
    for k, x in state.items():
        q, s, n, back = out[k]
        rq, rs = ref.ref_quantize(x)
        assert torch.equal(q, rq.reshape(-1)) and torch.equal(s, rs) and \
            n.item() == x.numel(), k
        assert torch.equal(back, ref.ref_dequantize(rq, rs)), k
    print(f"int8 path: quantize_block + dequantize_block over {len(specs)} "
          f"leaves, {counts['absmax']} absmax, {counts['quantize_2d']} "
          f"quantize_2d and {counts['dequantize_2d']} dequantize_2d launches, "
          "each leaf bit-identical to kernels/ref.py")
    device_ms = time_ms(one_pass, iters=10, warmup=1, hold=SERVE_HOLD_CYCLES)
    host_ms = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_pass()
        torch.cuda.synchronize()
        host_ms.append(1e3 * (time.perf_counter() - t0))
    print(json.dumps({"int8_path": "quantize_block + dequantize_block over "
                                   f"the {len(specs)} leaves, full width",
                      "device_ms": device_ms,
                      "host_ms": statistics.median(host_ms),
                      "launches": sum(counts.values())}))
    return {k: counts[k] for k in INT8_KERNELS}


def card_rates(torch, n, dev):
    """The card's own rates on n fp32 elements, timed as the kernels are
    (x rotating over 3 copies): a read (``x.sum()``), a write (a zero
    fill) and both (a copy); one JSON line."""
    xs = rotating(torch.randn(n, device=dev), 3)

    def copy():
        x = xs()
        return torch.empty_like(x).copy_(x)
    print(json.dumps({"card_rates_at_n": n,
                      "sum_ms": time_ms(lambda: xs().sum()),
                      "fill_ms": time_ms(lambda: torch.empty(
                          n, device=dev).zero_()),
                      "copy_ms": time_ms(copy)}))


def int8_only(torch, kernels, specs, dev, bound, log, lib):
    """``--only int8``: the int8 kernel phase (its checks and its times,
    one JSON line a kernel), the card's own rates on the same 51.5 MB
    (``card_rates``), the 43-leaf int8 pass, and last the int8 kernels'
    build report and SASS check. It measures the kernels of ``src/``
    beside this script: run from a copy of the repository whose kernel was
    edited, it times the edit."""
    for r in int8_kernel_phase(torch, specs, dev, bound):
        print(json.dumps(r))
    card_rates(torch, max(t.numel() for t in specs.values()), dev)
    int8_path_phase(torch, kernels, specs, dev)
    int8_build_report(log, lib)


def leaf_only(torch, kernels, specs, dev, bound, log, lib):
    """``--only leaf``: the per-leaf kernel phase (its checks, its times,
    one JSON line a kernel, and the 43-leaf correction pass), the card's
    own rates at the embedding's n (``card_rates``), the single-tensor
    pass, and last the leaf kernels' build report and SASS check. As
    ``int8_only``, it measures the kernels of ``src/`` beside this
    script."""
    for r in leaf_phase(torch, specs, dev, bound):
        print(json.dumps(r))
    card_rates(torch, max(t.numel() for t in specs.values()), dev)
    single_tensor_phase(torch, kernels, specs, dev)
    leaf_build_report(log, lib)


def families_only(torch, kernels, specs, dev, bound, log, lib):
    """``--only families``: the flash kernels' build report and SASS check,
    flash_attention_fwd's checks and times (``flash_phase``, every case),
    and the families phase (serving each family at full width, training
    granite-moe at 4 layers, xlstm-125m whole and zamba2-2.7b at 12)."""
    _, flops, bf16_flops, tf32_flops = peaks_for(
        torch.cuda.get_device_name(0))
    flash_build_report(log, lib)
    print(json.dumps({"flash_cases": flash_phase(
        torch, dev, bound, bf16_flops, max(flops, tf32_flops / 3))}))
    t0 = time.perf_counter()
    print(json.dumps({"families_launches": families_phase(torch, kernels,
                                                          dev)}))
    print(f"families phase: {time.perf_counter() - t0:.1f}s")


def telemetry_only(torch, kernels, specs, dev, bound, log, lib):
    """``--only telemetry``: what telemetry adds to a packed server's commit
    at full width, away from the inner rounds. For HeLoCo and FedBuff, one
    arrival at a time and fused flushes of K = 3: servers without and with
    telemetry in turns (off, on, on, off), each commit call timed on the
    host between synchronisations (median of TELEMETRY_REPS), and a block
    of TELEMETRY_REPS commit calls timed to one synchronisation at its end
    (the host may then run ahead of the card, unless a commit waits for
    its moments). Then the pieces: the single and K = 3 sweeps with and
    without the stats output in device time, and the host time of the
    moments' reduction and copy to the host."""
    from repro_torch.async_engine.server import Synchronizer
    from repro_torch.configs.base import OuterOptConfig
    from repro_torch.core import packing
    from repro_torch.kernels import packed as pk
    gen = torch.Generator(device=dev).manual_seed(5)
    params = {k: 0.02 * torch.randn(t.shape, generator=gen, device=dev)
              for k, t in specs.items()}
    deltas = [{k: 1e-3 * torch.randn(t.shape, generator=gen, device=dev)
               for k, t in specs.items()} for _ in range(4)]

    def commit(srv, i):
        """One commit call: an arrival, or a flush of commit_batch."""
        for j in range(srv.commit_batch):
            n = i * srv.commit_batch + j
            srv.buffer_arrival(deltas[n % 4], max(0, srv.t - 1), n % 4)
        assert srv.pending == 0

    for method, k in (("heloco", 1), ("fedbuff", 1), ("heloco", 3),
                      ("fedbuff", 3)):
        synced = {"off": [], "on": []}
        block = {"off": [], "on": []}
        for on in (False, True, True, False):
            srv = Synchronizer(params, OuterOptConfig(method=method), 4,
                               telemetry=on, commit_batch=k)
            for i in range(3):
                commit(srv, i)
            spans = []
            for i in range(TELEMETRY_REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                commit(srv, i)
                torch.cuda.synchronize()
                spans.append(1e3 * (time.perf_counter() - t0))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(TELEMETRY_REPS):
                commit(srv, i)
            torch.cuda.synchronize()
            key = "on" if on else "off"
            synced[key].append(statistics.median(spans) / k)
            block[key].append(1e3 * (time.perf_counter() - t0)
                              / (TELEMETRY_REPS * k))
            assert all((r.cos_align is not None) == on for r in srv.records)
            del srv
        print(json.dumps({"telemetry_server": method, "K": k,
                          "order": "off, on, on, off",
                          "ms_per_arrival_synced": synced,
                          "ms_per_arrival_back_to_back": block,
                          "reps": TELEMETRY_REPS}))
    # the pieces: the sweeps with and without their stats output
    layout = packing.build_layout(specs)
    row_block, _ = layout.device_tables(dev)
    r = layout.n_rows
    p, m, d = (torch.randn((r, 128), generator=gen, device=dev)
               for _ in range(3))
    d3 = torch.randn((3, r, 128), generator=gen, device=dev)
    cu = torch.rand(layout.n_blocks, generator=gen, device=dev)
    cv = torch.rand(layout.n_blocks, generator=gen, device=dev)
    pieces = {}
    for stats in (False, True):
        tag = "stats" if stats else "plain"
        pieces[f"packed_correct_outer_{tag}"] = time_ms(
            lambda: pk.packed_correct_outer(p, m, d, cu, cv, row_block,
                                            0.7, 0.9, 0.5, with_stats=stats))
        pieces[f"packed_multi_correct_outer_K3_{tag}"] = time_ms(
            lambda: pk.packed_multi_correct_outer(
                p, m, d3, cu.expand(3, -1).contiguous(),
                cv.expand(3, -1).contiguous(), row_block, 0.7, 0.9, 0.5,
                with_stats=stats))
    one = pk.packed_correct_outer(p, m, d, cu, cv, row_block, 0.7, 0.9, 0.5,
                                  with_stats=True)[-1]
    three = pk.packed_multi_correct_outer(
        p, m, d3, cu.expand(3, -1).contiguous(),
        cv.expand(3, -1).contiguous(), row_block, 0.7, 0.9, 0.5,
        with_stats=True)[-1]
    pieces["sum_R4_device"] = time_ms(lambda: one.sum(0))
    pieces["sum_K3R4_device"] = time_ms(lambda: three.sum(1))
    host = {"sum_R4_tolist": [], "sum_K3R4_cpu": []}
    for _ in range(TELEMETRY_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one.sum(0).tolist()
        t1 = time.perf_counter()
        three.sum(1).cpu()
        t2 = time.perf_counter()
        host["sum_R4_tolist"].append(1e3 * (t1 - t0))
        host["sum_K3R4_cpu"].append(1e3 * (t2 - t1))
    pieces.update({f"{k}_host_ms": statistics.median(v)
                   for k, v in host.items()})
    print(json.dumps({"telemetry_pieces_ms": pieces, "R": r}))


def plain_flash(q, k, v, *, causal=True, q_chunk=128, kv_chunk=128):
    """flash_attention_fwd's plain version under the wrapper's signature:
    what the serving checks' plain path attends with."""
    from repro_torch.kernels import flash_attention as fa
    return fa.flash_attention_fwd_ref(q, k, v, causal)


def reference_arithmetic_flash(q, k, v, *, causal=True, q_chunk=128,
                               kv_chunk=128):
    """The reference model's own prefill attention arithmetic
    (``repro/models/attention.py:_flash_chunk_fwd``): fp32 scores, the
    masked exp, p / l rounded to q's dtype before P V in q's dtype. A
    third path, exact in fp32 like the other two, whose distance from the
    plain path measures how far bf16 rounding alone moves a model's
    logits (``hold_to_plain``)."""
    import torch
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) \
        * float(np.float32(q.shape[-1] ** -0.5))
    if causal:
        rows = torch.arange(q.shape[1], device=q.device)[:, None]
        cols = torch.arange(k.shape[1], device=q.device)[None, :]
        s = s.masked_fill(cols > rows, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return torch.einsum("bqk,bkd->bqd",
                        (p / p.sum(-1, keepdim=True)).to(q.dtype), v)


class flash_path:
    """Within the block, prefill attention goes through the flash kernel
    (``path=None``), its plain version on the card (``"plain"``) or the
    reference model's arithmetic (``"reference"``)."""

    def __init__(self, path):
        self.path = path

    def __enter__(self):
        from repro_torch.models import attention as attn_lib
        self.kernel = attn_lib.flash_attention_fwd
        if self.path:
            attn_lib.flash_attention_fwd = {
                "plain": plain_flash,
                "reference": reference_arithmetic_flash}[self.path]

    def __exit__(self, *exc):
        from repro_torch.models import attention as attn_lib
        attn_lib.flash_attention_fwd = self.kernel


def serve_run(torch, kernels, model, params, batch, gen, plain=False):
    """One prefill of ``batch`` and ``gen`` greedy tokens through the
    launcher's steps (prefill only for an encoder), the launches of each
    read apart; ``plain``: prefill attention through the flash kernel's
    plain version."""
    from repro_torch.launch import serve
    with flash_path("plain" if plain else None):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        logits, caches, t_prefill = serve.prefill(model, params, batch, gen)
        at_prefill = kernels.launch_counts()
        kernels.reset_launch_counts()
        tokens, t_decode = (logits.argmax(-1)[:, None], None) \
            if model.cfg.encoder_only else serve.decode(
                model, params, logits, caches, serve.seq_len(batch), gen)
        at_decode = kernels.launch_counts()
    return {"logits": logits, "tokens": tokens, "at_prefill": at_prefill,
            "at_decode": at_decode, "prefill_ms": 1e3 * t_prefill,
            "decode_ms": None if t_decode is None else 1e3 * t_decode}


def teacher_forced(model, params, batch, tokens, path):
    """The logits of the prefill and of each decode step fed ``tokens``
    (the kernel path's greedy choices), on the kernel path (``path``
    None), the plain one or the reference arithmetic's (``flash_path``)."""
    from repro_torch.launch import serve
    with flash_path(path):
        s, gen = serve.seq_len(batch), tokens.shape[1]
        logits, caches = model.prefill(params, batch, s + gen)
        out = [logits]
        for i in range(gen - 1):
            logits, caches = model.decode(params, tokens[:, i], caches, s + i)
            out.append(logits)
    return out


def hold_to_plain(torch, model, params, batch, tokens, label, floor=False):
    """Both paths fed the kernel path's greedy ``tokens``, step by step: at
    the prefill and at every decode step their logits agree within
    TOL_LOGITS of their largest |value|, and each greedy token is the plain
    path's, or tied with it (within one step of the compute dtype at the
    top logit: random bf16 logits tie, and a tie may break either way).

    ``floor``: the band is the larger of TOL_LOGITS and FLOOR_FACTOR times
    the farthest the reference model's own attention arithmetic
    (``reference_arithmetic_flash``) puts the logits from the plain path's
    at any step, fed the same tokens. Through many random bf16 layers any
    two implementations exact in fp32 part by a few percent: one bf16
    rounding that flips where fp32 sums in another order is amplified
    layer by layer, and in an MoE a near-tie token changes experts
    (PERF.md §6, the families). A greedy token then counts as tied
    within twice the band, what the logits' band allows. Returns the
    largest
    difference and the band, both as shares of the largest |logit|, the
    tokens taken otherwise, and the reference arithmetic's largest share
    (None without ``floor``)."""
    forced, forced_plain = (teacher_forced(model, params, batch, tokens, p)
                            for p in (None, "plain"))
    band, ref_share = TOL_LOGITS, None
    if floor:
        ref_share = max(
            (lr.float() - lp.float()).abs().max().item()
            / lp.float().abs().max().item() for lr, lp in zip(
                teacher_forced(model, params, batch, tokens, "reference"),
                forced_plain))
        band = max(TOL_LOGITS, FLOOR_FACTOR * ref_share)
    errs, ties = [], 0
    for i, (lk, lp) in enumerate(zip(forced, forced_plain)):
        tok = tokens[:, i]
        assert torch.isfinite(lk).all() and torch.equal(
            lk.argmax(-1), tok), f"{label} step {i}: kernel path not repeatable"
        dtype = lk.dtype
        lk, lp = lk.float(), lp.float()
        err = (lk - lp).abs().max().item()
        scale = lp.abs().max().item()
        assert err <= band * scale, (
            f"{label} step {i}: kernel path's logits off the plain path's "
            f"by {err} (scale {scale}, band {band}, the reference "
            f"arithmetic's share {ref_share})")
        top = lp.max(-1).values
        step = torch.finfo(dtype).eps * torch.exp2(
            torch.floor(torch.log2(top.abs())))
        if floor:
            # logits within band * scale of each other put the kernel
            # path's choice at most twice that below the plain path's top
            step = torch.clamp_min(step, 2 * band * scale)
        chosen = lp.gather(1, tok[:, None])[:, 0]
        assert (chosen >= top - step).all(), (
            f"{label} step {i}: the kernel path's greedy tokens "
            f"{tok.tolist()} are not the plain path's "
            f"{lp.argmax(-1).tolist()}, nor tied with them")
        ties += int((lp.argmax(-1) != tok).sum())
        errs.append(err / scale)
    return max(errs), band, ties, ref_share


def serve_phase(torch, kernels, dev):
    """Full-width tinygpt-15m in its compute dtype: prefill of
    SERVE["batch"] prompts of SERVE["prompt"] tokens, SERVE["gen"] greedy
    tokens, then one prefill at SERVE["long_prompt"]; each with the counts
    set to 0 just before and read just after. Each prefill launches
    flash_attention_fwd once per layer and nothing else, decode nothing;
    logits finite. Then both paths, the kernel path and the plain path
    (the flash kernel's plain version), are fed the kernel path's greedy
    tokens and held to each other (``hold_to_plain``). Each run is timed
    SERVE["repeats"] times (medians). Returns flash_attention_fwd's
    launches and the prefills they served."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = get_config("tinygpt-15m")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), dev)
    prompts = {s: torch.randint(0, cfg.vocab_size, (SERVE["batch"], s),
                                generator=torch.Generator().manual_seed(s)
                                ).to(dev)
               for s in (SERVE["prompt"], SERVE["long_prompt"])}

    def run(prompt, gen, plain=False):
        return serve_run(torch, kernels, model, params, prompt, gen, plain)

    none = dict.fromkeys(kernels.launch_counts(), 0)
    one_prefill = {**none, "flash_attention_fwd": cfg.n_layers}
    launches = prefills = 0
    for s in prompts:                                # CUDA/cuBLAS warm-up
        run(prompts[s], 2)
        run(prompts[s], 2, plain=True)
    for s, gen in ((SERVE["prompt"], SERVE["gen"]),
                   (SERVE["long_prompt"], 1)):
        runs = [run(prompts[s], gen) for _ in range(SERVE["repeats"])]
        got = runs[0]
        for r in runs:
            assert r["at_prefill"] == one_prefill, \
                f"prefill {s} launched {r['at_prefill']}"
            assert r["at_decode"] == none, f"decode launched {r['at_decode']}"
            assert torch.equal(r["tokens"], got["tokens"]), \
                f"prompt {s}: greedy tokens not repeatable"
            launches += r["at_prefill"]["flash_attention_fwd"]
            prefills += 1
        logits = got["logits"]
        assert logits.dtype == getattr(torch, cfg.compute_dtype) and \
            torch.isfinite(logits).all(), f"prefill {s}: logits not finite"
        plains = [run(prompts[s], gen, plain=True)
                  for _ in range(SERVE["repeats"])]
        plain = plains[0]
        for r in plains:
            assert r["at_prefill"] == none == r["at_decode"], r
        err, _, ties, _ = hold_to_plain(torch, model, params, prompts[s],
                                        got["tokens"], f"prompt {s}")

        def med(rs, key):
            return statistics.median(r[key] for r in rs)

        # the device's share: the same prefill and one decode step timed
        # behind a hold that outlasts their dispatch (device time, no gaps)
        caches = model.prefill(params, prompts[s], s + gen)[1]
        device = {
            "prefill": time_ms(lambda: model.prefill(params, prompts[s],
                                                     s + gen),
                               iters=5, warmup=1, hold=SERVE_HOLD_CYCLES),
            "decode_step": time_ms(lambda: model.decode(
                params, got["tokens"][:, 0], caches, s), iters=5, warmup=1,
                hold=SERVE_HOLD_CYCLES)}

        row = {"prompt": s, "batch": SERVE["batch"], "gen": gen,
               "repeats": SERVE["repeats"],
               "prefill_ms": med(runs, "prefill_ms"),
               "plain_prefill_ms": med(plains, "prefill_ms"),
               "decode_ms_per_token": (med(runs, "decode_ms") / (gen - 1)
                                       if gen > 1 else None),
               "plain_decode_ms_per_token": (
                   med(plains, "decode_ms") / (gen - 1) if gen > 1 else None),
               "device_prefill_ms": device["prefill"],
               "device_decode_step_ms": device["decode_step"],
               "logits_max_diff_share": err, "band": TOL_LOGITS,
               "greedy_tokens": got["tokens"].numel(),
               "greedy_ties_taken_otherwise": ties,
               "free_running_tokens_equal": torch.equal(got["tokens"],
                                                        plain["tokens"]),
               "tokens": got["tokens"][:2].tolist()}
        print(json.dumps({"serve": f"tinygpt-15m full width, "
                                   f"{cfg.compute_dtype}", **row}))
    return launches, prefills


def flash_sites(cfg) -> int:
    """flash_attention_fwd's launches in one prefill: one an attention
    layer; a hybrid model's shared block at each of its n_super sites; none
    in an ssm model."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.shared_attn_every
    return 0 if cfg.family == "ssm" else cfg.n_layers


def families_phase(torch, kernels, dev):
    """Every model family at full width in its own compute dtype (bf16).
    (a) Serving: each FAMILIES arch (its depth cut where one is given)
    from a draw on the card, at SERVE's batch, prompt and greedy tokens
    (paligemma: 256 patch embeddings, then the prompt; hubert: frame
    features, a prefill only): with the counts set to 0 just before each
    and read just after, every prefill launches flash_attention_fwd
    ``flash_sites`` times (once a layer; zamba2 once at each shared-block
    site; xlstm never) and nothing else, decode nothing, logits finite,
    and where the prefill has the kernel both paths fed the kernel path's
    greedy tokens agree (``hold_to_plain``; xlstm has no kernel path and
    says so); prefill ms and decode ms a token (medians of
    FAMILY_REPEATS), peak device memory and init seconds printed; each
    model freed before the next.
    (b) Training: each FAMILY_TRAIN scenario on its arch at full width and
    the cut depth, through ``run_scenario``: the golden's arrivals, each
    applied arrival launching packed_row_stats and packed_correct_outer
    once and nothing else, finite evals, every tensor on the card.
    Returns per kernel (launches, prefills or arrivals they served)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import Model
    none = dict.fromkeys(kernels.launch_counts(), 0)
    launches = prefills = 0
    for arch, layers in FAMILIES:
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        model = Model(cfg)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        batch = serve.make_inputs(cfg, SERVE["batch"], SERVE["prompt"], 0,
                                  dev)
        gen = 1 if cfg.encoder_only else SERVE["gen"]
        sites = flash_sites(cfg)
        one_prefill = {**none, "flash_attention_fwd": sites}
        serve_run(torch, kernels, model, params, batch, 2)     # warm-up
        serve_run(torch, kernels, model, params, batch, 2, plain=True)
        runs = [serve_run(torch, kernels, model, params, batch, gen)
                for _ in range(FAMILY_REPEATS)]
        got = runs[0]
        for r in runs:
            assert r["at_prefill"] == one_prefill, \
                f"{arch}: prefill launched {r['at_prefill']}"
            assert r["at_decode"] == none, \
                f"{arch}: decode launched {r['at_decode']}"
            assert torch.equal(r["tokens"], got["tokens"]), \
                f"{arch}: greedy tokens not repeatable"
            if sites:
                launches += sites
                prefills += 1
        assert got["logits"].dtype == getattr(torch, cfg.compute_dtype) and \
            torch.isfinite(got["logits"]).all(), f"{arch}: logits not finite"
        err = band = ties = ref_share = None
        if sites:
            err, band, ties, ref_share = hold_to_plain(
                torch, model, params, batch, got["tokens"], arch, floor=True)
        else:
            print(f"{arch}: no kernel on its serving path (plain PyTorch "
                  "recurrences): nothing to hold to the plain path")
        decode = None if cfg.encoder_only else statistics.median(
            r["decode_ms"] for r in runs) / (gen - 1)
        prefill_ms = statistics.median(r["prefill_ms"] for r in runs)
        peak = torch.cuda.max_memory_allocated()
        print(json.dumps({
            "family": arch, "family_kind": cfg.family, "layers": cfg.n_layers,
            "depth_cut": f"{layers} of {get_config(arch).n_layers} layers"
                         if layers else None,
            "compute_dtype": cfg.compute_dtype, "head_dim": cfg.head_dim,
            "causal": cfg.causal,
            "params": sum(t.numel() for t in params.values()),
            "batch": SERVE["batch"], "sequence": serve.seq_len(batch),
            "gen": gen, "repeats": FAMILY_REPEATS, "init_s": init_s,
            "prefill_ms": prefill_ms, "decode_ms_per_token": decode,
            "peak_mem_bytes": peak, "flash_launches_per_prefill": sites,
            "logits_max_diff_share": err, "band": band,
            "reference_arithmetic_share": ref_share,
            "greedy_ties_taken_otherwise": ties,
            "tokens": got["tokens"][:2].tolist()}))
        print(f"{arch}: prefill {prefill_ms:.3f} ms (median of "
              f"{FAMILY_REPEATS})")
        if decode is not None:
            print(f"{arch}: decode {decode:.3f} ms a token")
        print(f"{arch}: peak {peak / 1e9:.2f} GB on the card")
        print(f"{arch}: init {init_s:.2f} s")
        del params, batch, runs, got
    gc.collect()
    torch.cuda.empty_cache()
    counts = dict.fromkeys(HELOCO, 0)
    arrivals = 0
    for name, arch, layers in FAMILY_TRAIN:
        run_counts, singles, _, _, _ = run_scenario(
            torch, kernels, name, {"arch": arch}, HELOCO, (), layers=layers)
        for k in HELOCO:
            counts[k] += run_counts[k]
        arrivals += singles
        gc.collect()
        torch.cuda.empty_cache()
    return {"flash_attention_fwd": (launches, prefills),
            **{k: (counts[k], arrivals) for k in HELOCO}}


# the dist phase: granite-moe trained through the dist steps at the cut
# depth of the families phase, with the dry-run plan's grad_accum; the
# exchange at full depth; prefill and decode on the serve phase's model
DIST_ARCH = "granite-moe-1b-a400m"
DIST_TRAIN_LAYERS = 4
DIST_BATCH = (4, 128)
DIST_INNER = dict(lr=1e-3, warmup_steps=1, total_steps=10)
# the microbatches of the grad_accum check route the same token groups as
# the whole batch only when a dispatch group is one microbatch's tokens or
# fewer: with the config's 2048-token groups a 512-token batch is one group
# and four 128-token microbatches are four, with other capacity drops
DIST_CHECK_GROUP = 128
TOL_DIST = 1e-5
# the bf16 pair's band: this many times bf16's own distance from fp32 on
# the grad_accum=1 step (loss, first moments), at least the fp32 pair's:
# two bf16 steps each that far from exact arithmetic are at most twice it
# apart (each leaf's first moments held to their own leaf's distance)
BF16_FACTOR = 2.0


def step_rule(torch, got, want, mu_want, lr, wd, what, band=None):
    """One AdamW step against another, given the first moments (0.1 g)
    held within ``band[leaf]`` of each leaf's largest |value| (None: 1e-4,
    the families' gradient band): the parameters within 5e-4 of each leaf's
    largest |value| except where the gradient is inside that band of zero
    (the first step is +-lr times a sign that the band does not fix: at
    most 2 lr (1 + wd |p|) there). Returns (largest parameter error share,
    elements excepted)."""
    worst, excepted = 0.0, 0
    for k, w in want.items():
        w, g, m = w.float(), got[k].float(), mu_want[k]
        scale = float(w.abs().max()) or 1.0
        diff = (g - w).abs()
        out = diff > 5e-4 * scale
        near_zero = m.abs() <= (1e-4 if band is None else band[k]) * float(
            m.abs().max())
        assert bool(near_zero[out].all()), f"{what}: {k} off its band"
        assert bool((diff[out] <= 2 * lr * (1 + wd * w[out].abs())
                     + 1e-7).all()), f"{what}: {k} past 2 lr"
        worst = max(worst, float(diff.max()) / scale)
        excepted += int(out.sum())
    return worst, excepted


def exchange_inputs(torch, model, dev):
    """Full-width inputs of the exchange, drawn on the card: the model's
    parameters, two workers' trees (the arriving pod 1 theta + 1e-3 noise,
    pod 0 theta - 5e-5 noise) and a momentum per leaf of a cosine near 1,
    -1 or 0.1 to the pseudo-gradient, so that blocks take every branch of
    Alg. 2."""
    params = model.init(torch.Generator(device=dev).manual_seed(2), dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    mom, wp = {}, {}
    for i, (k, p) in enumerate(params.items()):
        noise = torch.randn(p.shape, generator=gen, device=dev)
        wp[k] = torch.stack([p - 5e-5 * noise, p + 1e-3 * noise])
        a, b = ((1.0, 0.1), (-1.0, 0.1), (0.1, 1.0))[i % 3]
        mom[k] = 0.01 * (-a * noise + b * torch.randn(
            p.shape, generator=gen, device=dev))
        del noise
    return params, mom, wp


BRANCHES = ("keep", "anti", "weak", "degenerate")


def block_branches(torch, hk, delta, momentum, h, stacked_axes,
                   use_kernel=False):
    """Alg. 2's branch of every block, by path (an int8 (L,) tensor, an
    index into ``BRANCHES``): the cosine as the plain path computes it
    (``core.heloco``: normalized vectors, then their dot), or with
    ``use_kernel`` as the kernel path does (``block_stats``' sums, then
    ``branch_scalars``' cosine). It says whether the two paths took the
    same branch, which their outputs alone do not show."""
    out = {}
    for k, d in delta.items():
        blocks = math.prod(d.shape[:int(stacked_axes.get(k, 0))])
        u = d.float().reshape(blocks, -1)
        v = momentum[k].float().reshape(blocks, -1)
        if use_kernel:
            dot, uu, vv = hk.block_stats(u.contiguous(),
                                         v.contiguous()).unbind(1)
            nu, nv = torch.sqrt(uu), torch.sqrt(vv)
            c = dot / torch.clamp_min(nu * nv, h.eps * h.eps)
        else:
            nu = torch.linalg.vector_norm(u, dim=1)
            nv = torch.linalg.vector_norm(v, dim=1)
            c = ((u / torch.clamp_min(nu, h.eps)[:, None])
                 * (v / torch.clamp_min(nv, h.eps)[:, None])).sum(1)
        code = torch.where(c >= h.c_ok, 0, torch.where(c < 0.0, 1, 2))
        code = torch.where((nu < h.eps) | (nv < h.eps), 3, code)
        out[k] = code.to(torch.int8)
    return out




def live_cuda_storages(torch, n=5):
    """The largest CUDA storages that Python objects still reach, as (GB,
    shape, dtype) of a tensor on each: what earlier phases hold."""
    seen = {}
    for o in gc.get_objects():
        if isinstance(o, torch.Tensor) and o.is_cuda:
            st = o.untyped_storage()
            seen[st.data_ptr()] = (st.nbytes() / 1e9, list(o.shape),
                                   str(o.dtype))
    return sorted(seen.values(), reverse=True)[:n]


def dist_plan_cfg(cfg):
    """``cfg`` with the dry-run plan's activation placements: batch over
    data, heads over model, the sequence over model between blocks."""
    import dataclasses
    return dataclasses.replace(cfg, act_batch_axes=("data",),
                               act_model_axis="model", seq_parallel=True)


def dist_placed_train(torch, steps, shd, mesh, pspecs, state, batch, inner,
                      ga, run, cfgs):
    """(f) the placed train step on the one-card mesh against (b)'s
    unplaced runs ``run[(name, n)]``: bit for bit, fp32 and bf16 at
    grad_accum 1 and bf16 at ``ga``; then the bf16 step's seconds placed
    and unplaced, each the second call of its kind in turns."""
    out = {}
    for name, n in (("fp32", 1), ("bf16", 1), ("bf16", ga)):
        got, loss = steps.make_train_step(
            dist_plan_cfg(cfgs[name]), inner, grad_accum=n,
            param_pspecs=pspecs)(state, batch)
        want, wloss = run[name, n]
        assert all(shd.is_placed(v) for v in got.params.values())
        assert torch.equal(shd.gather(loss), wloss), f"(f) {name} loss"
        for k, v in want.params.items():
            assert torch.equal(shd.gather(got.params[k]), v), \
                f"(f) {name} grad_accum={n} parameter {k}"
            assert torch.equal(shd.gather(got.opt.mu[k]), want.opt.mu[k]), \
                f"(f) {name} grad_accum={n} first moment {k}"
        out[f"{name}_grad_accum_{n}"] = "bit-equal"
        del got
    secs = {"placed": [], "unplaced": []}
    placed = steps.make_train_step(dist_plan_cfg(cfgs["bf16"]), inner,
                                   param_pspecs=pspecs)
    plain = steps.make_train_step(cfgs["bf16"], inner)
    for _ in range(2):
        for kind, step in (("unplaced", plain), ("placed", placed)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, batch)
            torch.cuda.synchronize()
            secs[kind].append(time.perf_counter() - t0)
    print(json.dumps({"dist_placed_train": DIST_ARCH, "mesh":
                      mesh.axis_sizes, **out, "bf16_step_s": secs}))
    return out


def dist_placed_serve(torch, kernels, steps, shd, scfg, sparams, batch, n,
                      logits, logits2, caches, token, none, dev):
    """(f) tinygpt-15m's prefill and decode through the placed steps on the
    one-card mesh: bit-equal to (d)'s ``logits``, ``logits2`` and its
    caches after the decode, the same flash launches a prefill and none in
    decode. Returns the prefill's launches."""
    from repro_torch.launch.mesh import local_mesh, mesh_context
    cfg = dist_plan_cfg(scfg)
    with local_mesh(dev) as mesh, mesh_context(mesh):
        # the caller places the serving steps' inputs
        pp = shd.place_tree(sparams, shd.param_specs(
            sparams, axis_sizes=mesh.axis_sizes), mesh)
        pbatch, ptoken = (shd.place_tree(t, shd.batch_specs(t), mesh)
                          for t in (batch, token))
        pre = steps.make_prefill_step(cfg, cache_len=n)
        dec = steps.make_decode_step(cfg)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        plogits, pcaches = pre(pp, pbatch)
        torch.cuda.synchronize()
        got = kernels.launch_counts()
        assert got == {**none, "flash_attention_fwd": scfg.n_layers}, got
        assert torch.equal(shd.gather(plogits), logits), "(f) prefill"
        pcaches = shd.place_caches(pcaches, mesh, batch_sharded=True)
        kernels.reset_launch_counts()
        plogits2, pcaches = dec(pp, ptoken, pcaches, SERVE["prompt"])
        torch.cuda.synchronize()
        assert kernels.launch_counts() == none, "(f) decode launched"
        assert torch.equal(shd.gather(plogits2), logits2), "(f) decode"
        for k, v in shd.tree_leaves(caches).items():
            assert torch.equal(shd.gather(shd.tree_leaves(pcaches)[k]), v), \
                f"(f) cache {k}"
    print(json.dumps({"dist_placed_serve": "tinygpt-15m",
                      "prefill_launches": got["flash_attention_fwd"],
                      "prefill_bit_equal": True, "decode_bit_equal": True,
                      "caches_bit_equal": True}))
    return got["flash_attention_fwd"]


def dist_placed_exchange(torch, kernels, steps, shd, xcfg, h, none, dev):
    """(f) the exchange through the placed path on the one-card mesh
    (granite-moe at full width and depth, HeLoCo, arriving pod 1 of 2,
    then int8): block_stats, correct_apply and outer_update_2d (and the
    int8 kernels) once a leaf and nothing else, with the counts set to 0
    just before and read just after; its p', m' and look-ahead bit-equal
    leaf by leaf to (e)'s kernel path, run a leaf at a time. Returns the
    launches."""
    from repro_torch.launch.mesh import (local_mesh, make_production_mesh,
                                         mesh_context)
    from repro_torch.models import Model
    counts = {}
    for int8 in (False, True):
        params, mom, wp = exchange_inputs(torch, Model(xcfg), dev)
        stacked = shd.stacked_axes_tree(params)
        kw = dict(h=h, outer_lr=0.7, mu=0.9, arriving_pod=1,
                  stacked_axes=stacked, compress_int8=int8)
        with local_mesh(dev) as mesh, mesh_context(mesh):
            fn = steps.make_outer_exchange(
                xcfg, mesh, param_pspecs=shd.param_specs(
                    params, axis_sizes=mesh.axis_sizes), **kw)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            outs = fn(params, mom, wp)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            got = kernels.launch_counts()
        want = {**none, **dict.fromkeys(
            ("block_stats", "correct_apply", "outer_update_2d")
            + (("absmax", "quantize_2d", "dequantize_2d") if int8 else ()),
            len(params))}
        assert got == want, f"(f) exchange (int8={int8}) launched {got}"
        for k, v in got.items():
            counts[k] = counts.get(k, 0) + v
        kern = steps.make_outer_exchange(
            xcfg, make_production_mesh(multi_pod=True), **kw)
        for k in list(params):
            wants = kern({k: params[k]}, {k: mom[k]}, {k: wp[k]})
            for got_t, want_t in zip(outs, wants):
                assert torch.equal(shd.gather(got_t.pop(k)), want_t[k]), \
                    f"(f) exchange (int8={int8}) {k}"
            del wants
        print(json.dumps({"dist_placed_exchange": DIST_ARCH, "int8": int8,
                          "leaves": len(params),
                          "launches": {k: v for k, v in got.items() if v},
                          "exchange_s": secs, "bit_equal_to_e": True}))
        del params, mom, wp, outs
        gc.collect()
        torch.cuda.empty_cache()
    return counts


def dist_phase(torch, kernels, dev):
    """The dist path (``repro_torch.dist``) on the card, each part freed
    before the next; prints its seconds and peak device memory.
    (a) Sharding: ``param_specs`` of full-width granite-moe-1b-a400m and
    qwen2-7b from meta tensors on both production meshes, every placement
    dividing its dim, and the per-device parameter bytes.
    (b) Train step: granite-moe at full width and DIST_TRAIN_LAYERS
    layers, batch 4 x 128, inside a one-card mesh, unplaced: the plan's
    grad_accum=4 in the config's bf16; then,
    with DIST_CHECK_GROUP-token dispatch groups, grad_accum=4 held to
    grad_accum=1 on the same batch, in fp32 (loss within rtol 1e-5, first
    moments within 1e-4 of each leaf's largest |value|, the step under
    ``step_rule``) and in bf16 (the same with BF16_FACTOR times bf16's own
    distance from the fp32 grad_accum=1 step as the loss's rtol and each
    leaf's first-moment band, where larger).
    (c) Multi-pod step, placed (``param_pspecs``; each pod's step on the
    one-card mesh's (data, model) submesh, the state restacked as
    DTensors with ``pod`` ahead): two pods on the card: identical pods stay
    bit for bit identical, different batches diverge, pod 0 bit-equal to
    the unplaced single step on its slice.
    (d) Prefill and decode steps on full-width tinygpt-15m (bf16): bit-equal
    to ``Model.prefill`` and ``decode``, 4 flash_attention_fwd launches a
    prefill and nothing else, none in decode.
    (e) Outer exchange (HeLoCo, arriving pod 1 of 2, then with int8) on
    granite-moe at full width and depth, 1.33 B parameters: with the
    counts set to 0 just before each and read just after, block_stats,
    correct_apply and outer_update_2d once a leaf (and absmax, quantize_2d
    and dequantize_2d once a leaf with int8) and nothing else; then held
    leaf by leaf to the plain path on the card: p', m' and the look-ahead
    within TOL_DIST of each leaf's largest |value|, the same branch in
    every block, the int8 round trip bit for bit.
    (f) The placed steps (DTensor placements, ``local_map`` sites) on the
    one-card mesh with the dry-run plan's activation placements
    (``act_batch_axes``, ``act_model_axis``, ``seq_parallel``): the train
    step bit-equal to (b)'s unplaced one in fp32 and bf16 (loss, first
    moments, parameters), its seconds beside the unplaced step's (the
    host cost of DTensor dispatch); tinygpt-15m's prefill and decode
    bit-equal to (d)'s with the same flash_attention_fwd launches; the
    exchange bit-equal leaf by leaf to (e)'s kernel path with the same
    launches a leaf.
    (b), (d) and (e) run unplaced (whole tensors).
    Returns per kernel (launches, arrivals or prefills or leaves they
    served), as the kernels line counts each row."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import HeLoCoConfig, InnerOptConfig
    from repro_torch.dist import sharding as shd
    from repro_torch.dist import steps
    from repro_torch.kernels import heloco_correct as hk
    from repro_torch.launch import serve
    from repro_torch.launch.dryrun import plan_for
    from repro_torch.launch.mesh import (local_mesh, make_production_mesh,
                                         mesh_context)
    from repro_torch.configs import SHAPES
    from repro_torch.models import Model
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()   # earlier phases' tensors
    held_by = live_cuda_storages(torch) if held_before > 1e9 else []
    none = dict.fromkeys(kernels.launch_counts(), 0)

    # (a) sharding of two full-width trees, no allocation
    for arch in (DIST_ARCH, "qwen2-7b"):
        params = Model(get_config(arch)).param_specs()
        for multi in (False, True):
            mesh = make_production_mesh(multi_pod=multi)
            specs = shd.param_specs(params, axis_sizes=mesh.axis_sizes)
            per_dev = sum(math.prod(shd.shard_shape(
                x.shape, specs[k], mesh.axis_sizes, k)) * x.element_size()
                for k, x in params.items())
            kinds = {}
            for s in specs.values():
                key = "+".join(sorted({e if isinstance(e, str) else
                                       "/".join(e) for e in s if e})) \
                    or "replicated"
                kinds[key] = kinds.get(key, 0) + 1
            print(json.dumps({"dist_sharding": arch, "mesh": mesh.axis_sizes,
                              "leaves": len(specs), "placements": kinds,
                              "param_bytes_per_device": per_dev}))

    # (b) train steps at the cut depth
    cfg = dataclasses.replace(get_config(DIST_ARCH),
                              n_layers=DIST_TRAIN_LAYERS)
    ga = plan_for(DIST_ARCH, SHAPES["train_4k"])["grad_accum"]
    inner = InnerOptConfig(**DIST_INNER)
    gen = torch.Generator(device=dev).manual_seed(0)
    tok = torch.randint(0, cfg.vocab_size, (2,) + DIST_BATCH, generator=gen,
                        device=dev, dtype=torch.int32)
    batches = [{"tokens": t, "labels": torch.roll(t, -1, 1)} for t in tok]
    params = Model(cfg).init(torch.Generator(device=dev).manual_seed(1), dev)
    with local_mesh(dev) as mesh, mesh_context(mesh):
        pspecs = shd.param_specs(params, axis_sizes=mesh.axis_sizes)
        state = steps.init_train_state(params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bf16_state, bf16_loss = steps.make_train_step(
            cfg, inner, grad_accum=ga)(state, batches[0])
        torch.cuda.synchronize()
        bf16_s = time.perf_counter() - t0
        bf16_one = steps.make_train_step(cfg, inner)(state, batches[0])[1]
        assert torch.isfinite(bf16_loss) and all(
            bool(torch.isfinite(v).all()) for v in bf16_state.params.values())
        del bf16_state
        grouped = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, group_size=DIST_CHECK_GROUP))
        f32 = dataclasses.replace(grouped, compute_dtype="float32")
        run = {(name, n): steps.make_train_step(
                   c, inner, grad_accum=n)(state, batches[0])
               for name, c in (("fp32", f32), ("bf16", grouped))
               for n in (ga, 1)}

        def loss_share(a, b):
            return abs(float(a[1]) - float(b[1])) / abs(float(b[1]))

        def mu_share(a, b):
            """Per leaf: the first moments' largest difference as a share
            of the leaf's largest |value|."""
            return {k: float((a[0].opt.mu[k] - v).abs().max())
                    / (float(v.abs().max()) or 1.0)
                    for k, v in b[0].opt.mu.items()}

        own_loss = loss_share(run["bf16", 1], run["fp32", 1])
        own_mu = mu_share(run["bf16", 1], run["fp32", 1])
        held = {}
        for name, rtol, band in (
                ("fp32", 1e-5, dict.fromkeys(own_mu, 1e-4)),
                ("bf16", max(1e-5, BF16_FACTOR * own_loss),
                 {k: max(1e-4, BF16_FACTOR * v) for k, v in own_mu.items()})):
            acc, one = run[name, ga], run[name, 1]
            rel, mu_err = loss_share(acc, one), mu_share(acc, one)
            assert rel <= rtol, \
                f"{name} grad_accum={ga} loss off by {rel:.3e} ({rtol:.3e})"
            for k, e in mu_err.items():
                assert e <= band[k], f"{name} grad_accum={ga} first " \
                    f"moments of {k} {e:.3e} ({band[k]:.3e})"
            worst, excepted = step_rule(
                torch, acc[0].params, one[0].params, one[0].opt.mu, inner.lr,
                inner.weight_decay, f"{name} grad_accum", band)
            held[name] = {"loss": float(acc[1]),
                          "loss_grad_accum_1": float(one[1]),
                          "loss_rel_err": rel, "loss_rtol": rtol,
                          "mu_err_share": mu_err, "mu_band": band,
                          "param_err_share": worst,
                          "near_zero_gradient_elements_excepted": excepted}
        placed = dist_placed_train(torch, steps, shd, mesh, pspecs, state,
                                   batches[0], inner, ga, run,
                                   {"fp32": f32, "bf16": grouped})
        del run
        print(json.dumps({
            "dist_train": DIST_ARCH, "layers": f"{DIST_TRAIN_LAYERS} of "
            f"{get_config(DIST_ARCH).n_layers}", "batch": list(DIST_BATCH),
            "grad_accum": ga, "bf16_loss": float(bf16_loss),
            "bf16_loss_grad_accum_1": float(bf16_one),
            "bf16_step_s": bf16_s, "dispatch_group": DIST_CHECK_GROUP,
            "bf16_own_distance_from_fp32": {"loss": own_loss,
                                            "mu": own_mu}, **held}))

        # (c) two pods on the card, placed (pod ahead of each spec; the
        # state comes back as DTensors, gathered for the checks)
        multi = steps.make_multipod_train_step(cfg, inner, mesh,
                                               param_pspecs=pspecs)
        same = {k: torch.stack([v, v]) for k, v in batches[0].items()}
        diff = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
        ns, _ = multi(steps.stack_pods([state, state]), same)
        assert all(shd.is_placed(v) for v in ns.params.values())
        for k, v in shd.gather_tree(ns.params).items():
            assert torch.equal(v[0], v[1]), f"pods parted on {k}"
        del ns
        nd, losses = multi(steps.stack_pods([state, state]), diff)
        nd_params, losses = shd.gather_tree(nd.params), shd.gather(losses)
        del nd
        single, loss0 = steps.make_train_step(cfg, inner)(state, batches[0])
        parted = sum(not torch.equal(v[0], v[1])
                     for v in nd_params.values())
        assert parted, "pods with different batches stayed equal"
        assert torch.equal(losses[0], loss0)
        for k, v in single.params.items():
            assert torch.equal(nd_params[k][0], v), f"pod 0 != single: {k}"
        print(json.dumps({"dist_multipod": 2, "placed": True,
                          "losses": losses.tolist(),
                          "leaves_parted": parted,
                          "leaves": len(single.params),
                          "pod0_bit_equal_unplaced_single": True}))
        del nd_params, single, state, params, multi
    gc.collect()
    torch.cuda.empty_cache()

    # (d) prefill and decode steps on the serve phase's model
    scfg = get_config("tinygpt-15m")
    model = Model(scfg)
    sparams = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    batch = serve.make_inputs(scfg, SERVE["batch"], SERVE["prompt"], 0, dev)
    n = SERVE["prompt"] + 1
    pre = steps.make_prefill_step(scfg, cache_len=n)
    dec = steps.make_decode_step(scfg)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    logits, caches = pre(sparams, batch)
    torch.cuda.synchronize()
    at_prefill = kernels.launch_counts()
    want_logits, want_caches = model.prefill(sparams, batch["tokens"], n)
    assert at_prefill == {**none, "flash_attention_fwd": scfg.n_layers}, \
        at_prefill
    assert torch.equal(logits, want_logits)
    token = logits.argmax(-1)
    kernels.reset_launch_counts()
    logits2, _ = dec(sparams, token, caches, SERVE["prompt"])
    torch.cuda.synchronize()
    assert kernels.launch_counts() == none
    want2, _ = model.decode(sparams, token, want_caches, SERVE["prompt"])
    assert torch.equal(logits2, want2) and torch.isfinite(logits2).all()
    print(json.dumps({"dist_serve": "tinygpt-15m", "prefill_launches":
                      at_prefill["flash_attention_fwd"],
                      "prefill_bit_equal": True, "decode_bit_equal": True}))
    placed_prefill = dist_placed_serve(torch, kernels, steps, shd, scfg,
                                       sparams, batch, n, logits, logits2,
                                       caches, token, none, dev)
    del sparams, caches, want_caches, logits, logits2, want_logits, want2
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the exchange at full width and depth
    h = HeLoCoConfig()
    xcfg = get_config(DIST_ARCH)
    mesh = make_production_mesh(multi_pod=True)
    counts = {}
    for int8 in (False, True):
        params, mom, wp = exchange_inputs(torch, Model(xcfg), dev)
        stacked = shd.stacked_axes_tree(params)
        fn = steps.make_outer_exchange(xcfg, mesh, h=h, outer_lr=0.7, mu=0.9,
                                       arriving_pod=1, stacked_axes=stacked,
                                       compress_int8=int8)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        p2, m2, bar = fn(params, mom, wp)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = kernels.launch_counts()
        want = {**none, **dict.fromkeys(
            ("block_stats", "correct_apply", "outer_update_2d")
            + (("absmax", "quantize_2d", "dequantize_2d") if int8 else ()),
            len(params))}
        assert got == want, f"exchange (int8={int8}) launched {got}"
        for k, v in got.items():
            counts[k] = counts.get(k, 0) + v
        # the kernel path's outputs wait on the host (the look-ahead as
        # pod 0 of its broadcast) while the plain path runs leaf by leaf,
        # and the plain path reads only the arriving pod: keep that one
        assert all(x.shape[0] == 2 and x.stride(0) == 0
                   for x in bar.values()), "look-ahead not broadcast"
        outs = ({k: v.cpu() for k, v in p2.items()},
                {k: v.cpu() for k, v in m2.items()},
                {k: v[0].cpu() for k, v in bar.items()})
        del p2, m2, bar
        for k in wp:
            wp[k] = wp[k][1:].clone()
        plain = steps.make_outer_exchange(
            xcfg, mesh, h=h, outer_lr=0.7, mu=0.9, arriving_pod=0,
            stacked_axes=stacked, compress_int8=int8, use_kernel=False)
        worst = 0.0
        branches = {}
        for k in list(params):
            wants = plain({k: params[k]}, {k: mom[k]}, {k: wp[k]})
            for i, (got_t, want_t) in enumerate(zip(outs, wants)):
                g = got_t.pop(k).to(dev).float()
                w = (want_t[k][0] if i == 2 else want_t[k]).float()
                scale = float(w.abs().max()) or 1.0
                err = float((g - w).abs().max()) / scale
                assert err <= TOL_DIST, f"{k}: {err:.3e} of its scale"
                worst = max(worst, err)
            del wants, g, w
            delta = {k: params[k].float() - wp[k][0].float()}
            if int8:
                kq = steps.int8_roundtrip_leaf(delta[k], use_kernel=True)
                pq = steps.int8_roundtrip_leaf(delta[k])
                assert torch.equal(kq, pq), f"{k}: int8 round trip differs"
                delta = {k: pq}
                del kq
            kb = block_branches(torch, hk, delta, {k: mom[k]}, h, stacked,
                                use_kernel=True)[k]
            pb = block_branches(torch, hk, delta, {k: mom[k]}, h,
                                stacked)[k]
            assert torch.equal(kb, pb), f"{k}: a HeLoCo branch flipped"
            for c in kb.tolist():
                branches[BRANCHES[c]] = branches.get(BRANCHES[c], 0) + 1
            del delta
        n_leaves = len(params)
        print(json.dumps({"dist_exchange": DIST_ARCH, "int8": int8,
                          "params": sum(p.numel() for p in params.values()),
                          "leaves": n_leaves,
                          "launches": {k: v for k, v in got.items() if v},
                          "exchange_s": secs, "max_err_share": worst,
                          "branches": branches}))
        del params, mom, wp, outs
        gc.collect()
        torch.cuda.empty_cache()
    placed_counts = dist_placed_exchange(torch, kernels, steps, shd, xcfg,
                                         h, none, dev)
    for k, v in placed_counts.items():
        counts[k] = counts.get(k, 0) + v
    peak = torch.cuda.max_memory_allocated()
    secs = time.perf_counter() - t_phase
    print(f"dist phase: peak {peak / 1e9:.2f} GB, {secs:.1f} s")
    print(json.dumps({"dist_phase_s": secs, "peak_GB": peak / 1e9,
                      "held_by_earlier_phases_GB": held_before / 1e9,
                      "largest_held": held_by}))
    return {"block_stats": (counts["block_stats"], 4),
            "correct_apply": (counts["correct_apply"], 4),
            "outer_update_2d": (counts["outer_update_2d"], 4 * n_leaves),
            **{k: (counts[k], 2 * n_leaves)
               for k in ("absmax", "quantize_2d", "dequantize_2d")},
            "flash_attention_fwd": (at_prefill["flash_attention_fwd"]
                                    + placed_prefill, 2)}


def dist_only(torch, kernels, specs, dev, bound, log, lib):
    """``--only dist``: the dist phase alone (leaf.cu, quantize.cu and
    flash_attention.cu built)."""
    print(json.dumps({"dist_launches": dist_phase(torch, kernels, dev)}))


# the plan phase: the reference's training memory plan (attention in query
# chunks of the train_4k plan's q_chunk, remat checkpoints) at train_4k's
# sequence length, with granite-moe-1b-a400m's attention shapes (16 heads, 8
# kv heads, D 64) for the attention alone
PLAN_ARCH = "granite-moe-1b-a400m"
PLAN_SEQ = 4096
PLAN_BATCH = 4
# the cut depth of the engine's run at PLAN_SEQ (the families phase's), and
# the hybrid's: two super blocks, its batch and its plan's grad_accum
PLAN_ENGINE_LAYERS = 4
PLAN_HYBRID = ("zamba2-2.7b", 12, 8)
# the Function against the plain attend: the forward in fp32 within rtol
# TOL_PLAN_FWD (atol TOL_PLAN_ATOL for values near zero), in bf16 within one
# bf16 step of its largest |value|; dq, dk, dv in fp32 within TOL_PLAN_GRAD
# of each one's largest |value|, in bf16 within TOL_PLAN_BF16_GRAD (the
# CPU test's band: the two paths round to bf16 at other points); remat on
# against off, where not bit-equal, within TOL_PLAN_GRAD of each leaf's
# largest |value|
TOL_PLAN_FWD, TOL_PLAN_ATOL = 1e-5, 1e-6
TOL_PLAN_GRAD = 1e-4
TOL_PLAN_BF16_GRAD = 2e-2


def saved_bytes(torch, fn):
    """(fn(), the bytes of the distinct storages autograd saved for its
    backward, counted through ``saved_tensors_hooks``)."""
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, sum(seen.values())


def bf16_step(torch, x):
    """One bf16 step (unit in the last place) at ``x``'s largest |value|."""
    top = float(x.abs().max())
    return torch.finfo(torch.bfloat16).eps * 2.0 ** math.floor(
        math.log2(top)) if top else 0.0


def plan_phase(torch, kernels, dev, smi):
    """The reference's training memory plan on the card at train_4k's
    PLAN_SEQ tokens (``models.attention.flash_attention``: queries in
    chunks of the plan's q_chunk, only q, k, v, out and lse saved; remat
    checkpoints under ``cfg.remat``), each part freed before the next; the
    card's name and power limit (``smi``) beside every line.
    (a) Attention alone at PLAN_ARCH's shapes, batch 1: the Function
    against the plain ``attend(use_flash=False)`` in fp32 and bf16, causal,
    forward and dq, dk, dv (the TOL_PLAN bands); each path's saved bytes
    (``saved_tensors_hooks``), its peak device memory over what was
    allocated before it and its forward + backward ms (host clock to a
    synchronised end, the second of two calls).
    (b) ``dist.steps.make_train_step`` on PLAN_ARCH at full width and depth
    (24 layers), bf16, batch PLAN_BATCH x PLAN_SEQ, the train_4k plan's
    grad_accum and q_chunk, remat on, two steps inside a one-card mesh with
    the specs placed, then a third unplaced on their state made whole:
    loss and parameters finite; each step's seconds and the peak; beside it the attention's saved bytes of (a) at bf16 times
    the layers, with and without the plan.
    (c) ``paper_hetero_severe`` through the engine (``run_scenario``) with
    PLAN_ARCH at full width cut to PLAN_ENGINE_LAYERS layers and sequences
    of PLAN_SEQ tokens: the golden's arrivals, one packed_row_stats and one
    packed_correct_outer launch an applied arrival and nothing else, finite
    evals, ms an arrival and the peak.
    (d) PLAN_HYBRID: zamba2-2.7b cut to 12 of 54 layers (two super
    blocks), bf16, batch 8 x PLAN_SEQ with its plan's grad_accum, one
    ``make_train_step`` step with remat on, then one with it off: the loss
    and the gradients (as AdamW's first moments, (1 - b1) g from zero)
    bit-equal, else the largest difference printed and held within
    TOL_PLAN_GRAD of each leaf's largest |value|; both peaks and times.
    Returns packed_row_stats' and packed_correct_outer's (launches, applied
    arrivals) of (c)."""
    import dataclasses
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.configs.base import InnerOptConfig
    from repro_torch.dist import sharding as shd
    from repro_torch.dist import steps
    from repro_torch.launch.dryrun import plan_for
    from repro_torch.launch.mesh import local_mesh, mesh_context
    from repro_torch.models import Model
    from repro_torch.models import attention as attn_lib
    t_phase = time.perf_counter()
    card = {"card": smi}
    cfg = get_config(PLAN_ARCH)
    plan = plan_for(PLAN_ARCH, SHAPES["train_4k"])
    q_chunk = plan["q_chunk"]
    assert SHAPES["train_4k"].seq_len == PLAN_SEQ

    def fresh():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated()

    # (a) the attention alone
    shapes = ((1, PLAN_SEQ, cfg.n_heads, cfg.head_dim),
              (1, PLAN_SEQ, cfg.n_kv_heads, cfg.head_dim))
    attn = {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        gen = torch.Generator(device=dev).manual_seed(4)
        q, k, v = (torch.randn(sh, generator=gen, device=dev).to(dt)
                   for sh in (shapes[0], shapes[1], shapes[1]))
        do = torch.randn(shapes[0], generator=gen, device=dev).to(dt)
        res = {}
        # each path twice, the second kept: the first call warms the card
        for path, use_flash in (("flash", True), ("plain", False)) * 2:
            base = fresh()
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            t0 = time.perf_counter()
            out, nbytes = saved_bytes(torch, lambda: attn_lib.attend(
                *leaves, causal=cfg.causal, q_chunk=q_chunk,
                use_flash=use_flash))
            grads = torch.autograd.grad(out, leaves, do)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            res[path] = {"out": out.detach(), "grads": grads,
                         "saved_bytes": nbytes, "ms": ms,
                         "peak_bytes": torch.cuda.max_memory_allocated()
                         - base}
            del out, leaves
        got, want = res["flash"], res["plain"]
        if dtype == "float32":
            fwd_ok = torch.allclose(got["out"], want["out"],
                                    rtol=TOL_PLAN_FWD, atol=TOL_PLAN_ATOL)
            band = TOL_PLAN_GRAD
        else:
            fwd_ok = float((got["out"].float() - want["out"].float()).abs()
                           .max()) <= bf16_step(torch, want["out"].float())
            band = TOL_PLAN_BF16_GRAD
        fwd_err = float((got["out"].float() - want["out"].float()).abs()
                        .max())
        grad_share = {}
        for name, g, w in zip(("dq", "dk", "dv"), got["grads"],
                              want["grads"]):
            g, w = g.float(), w.float()
            grad_share[name] = float((g - w).abs().max()) / (
                float(w.abs().max()) or 1.0)
        line = {"plan_attention": PLAN_ARCH, "dtype": dtype,
                "shape": {"B": 1, "S": PLAN_SEQ, "H": cfg.n_heads,
                          "KV": cfg.n_kv_heads, "D": cfg.head_dim},
                "causal": cfg.causal, "q_chunk": q_chunk,
                "out_max_abs_err": fwd_err, "grad_err_share": grad_share,
                "grad_band": band,
                **{f"{p}_{k}": res[p][k] for p in res
                   for k in ("saved_bytes", "peak_bytes", "ms")}, **card}
        print(json.dumps(line))
        assert fwd_ok, f"plan attention {dtype}: forward off by {fwd_err}"
        for name, share in grad_share.items():
            assert share <= band, f"plan attention {dtype}: {name} " \
                f"{share:.3e} of its largest |value| ({band})"
        attn[dtype] = {p: res[p]["saved_bytes"] for p in res}
        del res, got, want, q, k, v, do

    # (b) a full-depth train step at train_4k's length
    base = fresh()
    ga = plan["grad_accum"]
    inner = InnerOptConfig(**DIST_INNER)
    assert cfg.remat and cfg.compute_dtype == "bfloat16"
    gen = torch.Generator(device=dev).manual_seed(5)
    tok = torch.randint(0, cfg.vocab_size, (PLAN_BATCH, PLAN_SEQ),
                        generator=gen, device=dev, dtype=torch.int32)
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    params = Model(cfg).init(torch.Generator(device=dev).manual_seed(6), dev)
    n_params = sum(p.numel() for p in params.values())
    step_s, losses = [], []
    with local_mesh(dev) as mesh, mesh_context(mesh):
        pspecs = shd.param_specs(params, axis_sizes=mesh.axis_sizes)
        step = steps.make_train_step(cfg, inner, grad_accum=ga,
                                     q_chunk=q_chunk, param_pspecs=pspecs)
        state = steps.init_train_state(params)
        del params
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(state, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(shd.gather(loss)))
        # a third step unplaced, on the placed steps' state made whole:
        # whether DTensor's host dispatch hides behind the device's work
        state = state._replace(
            params=shd.gather_tree(state.params),
            opt=state.opt._replace(mu=shd.gather_tree(state.opt.mu),
                                   nu=shd.gather_tree(state.opt.nu)))
        del step
        step = steps.make_train_step(cfg, inner, grad_accum=ga,
                                     q_chunk=q_chunk)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        torch.cuda.synchronize()
        unplaced_s = time.perf_counter() - t0
        losses.append(float(loss))
        finite = all(bool(torch.isfinite(v).all())
                     for v in state.params.values())
        del state, step
    peak = torch.cuda.max_memory_allocated()
    layers = cfg.n_layers
    print(json.dumps({
        "plan_train": PLAN_ARCH, "layers": layers, "params": n_params,
        "batch": [PLAN_BATCH, PLAN_SEQ], "grad_accum": ga,
        "q_chunk": q_chunk, "remat": cfg.remat, "dtype": cfg.compute_dtype,
        "losses": losses, "step_s": step_s,
        "unplaced_third_step_s": unplaced_s, "peak_bytes": peak,
        "held_before_bytes": base,
        "attention_saved_bytes_all_layers": {
            "with_plan": attn["bfloat16"]["flash"] * layers,
            "without_plan": attn["bfloat16"]["plain"] * layers}, **card}))
    print(f"plan train: {PLAN_ARCH} {layers} layers, {PLAN_BATCH} x "
          f"{PLAN_SEQ}, placed steps {step_s[0]:.2f} s, {step_s[1]:.2f} s, "
          f"unplaced {unplaced_s:.2f} s, peak "
          f"{peak / 1e9:.2f} GB; attention saved without the plan "
          f"{attn['bfloat16']['plain'] * layers / 1e9:.2f} GB over "
          f"{layers} layers, with it "
          f"{attn['bfloat16']['flash'] * layers / 1e9:.3f} GB ({smi})")
    assert finite and all(math.isfinite(x) for x in losses), losses
    del batch, tok

    # (c) the main path at train_4k's length
    fresh()
    counts, singles, _, means, server_ms = run_scenario(
        torch, kernels, "paper_hetero_severe",
        {"arch": PLAN_ARCH, "seq_len": PLAN_SEQ}, HELOCO, (),
        layers=PLAN_ENGINE_LAYERS)
    print(json.dumps({"plan_engine": PLAN_ARCH,
                      "layers": PLAN_ENGINE_LAYERS, "seq_len": PLAN_SEQ,
                      "applied": singles, "launches": {
                          k: v for k, v in counts.items() if v},
                      "eval_means": means, "server_ms": server_ms,
                      "peak_bytes": torch.cuda.max_memory_allocated(),
                      **card}))
    fresh()

    # (d) the hybrid, remat on against off
    arch, n_layers, hb = PLAN_HYBRID
    hcfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    hga = plan_for(arch, SHAPES["train_4k"])["grad_accum"]
    gen = torch.Generator(device=dev).manual_seed(7)
    tok = torch.randint(0, hcfg.vocab_size, (hb, PLAN_SEQ), generator=gen,
                        device=dev, dtype=torch.int32)
    hbatch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    hparams = Model(hcfg).init(torch.Generator(device=dev).manual_seed(8),
                               dev)
    runs = {}
    for remat in (True, False):
        base = fresh()
        c = dataclasses.replace(hcfg, remat=remat)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, loss = steps.make_train_step(c, inner, grad_accum=hga,
                                         q_chunk=q_chunk)(
            steps.init_train_state(hparams), hbatch)
        torch.cuda.synchronize()
        runs[remat] = {"s": time.perf_counter() - t0, "loss": loss,
                       "mu": st.opt.mu,
                       "peak_bytes": torch.cuda.max_memory_allocated()
                       - base}
        del st
    on, off = runs[True], runs[False]
    loss_equal = torch.equal(on["loss"], off["loss"])
    unequal, worst = [], 0.0
    for k, m in off["mu"].items():
        if not torch.equal(on["mu"][k], m):
            unequal.append(k)
            share = float((on["mu"][k] - m).abs().max()) / (
                float(m.abs().max()) or 1.0)
            worst = max(worst, share)
    loss_share = abs(float(on["loss"]) - float(off["loss"])) / abs(
        float(off["loss"]))
    print(json.dumps({
        "plan_hybrid": arch, "layers": f"{n_layers} of "
        f"{get_config(arch).n_layers}", "batch": [hb, PLAN_SEQ],
        "grad_accum": hga, "q_chunk": q_chunk, "dtype": hcfg.compute_dtype,
        "loss": float(on["loss"]), "loss_bit_equal": loss_equal,
        "loss_rel_err": loss_share,
        "grads_bit_equal": not unequal, "grad_leaves_unequal": len(unequal),
        "grad_leaves": len(off["mu"]), "grad_max_err_share": worst,
        "remat_on": {"step_s": on["s"], "peak_bytes": on["peak_bytes"]},
        "remat_off": {"step_s": off["s"], "peak_bytes": off["peak_bytes"]},
        **card}))
    assert loss_equal or loss_share <= TOL_PLAN_GRAD, loss_share
    assert worst <= TOL_PLAN_GRAD, f"{arch}: remat on against off " \
        f"{worst:.3e} of a leaf's largest |value|"
    del runs, on, off, hparams, hbatch, tok
    fresh()
    print(f"plan phase: {time.perf_counter() - t_phase:.1f} s ({smi})")
    return {k: (counts[k], singles) for k in HELOCO}


def plan_only(torch, kernels, specs, dev, bound, log, lib):
    """``--only plan``: the plan phase alone (packed.cu built)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"plan_launches": plan_phase(torch, kernels, dev,
                                                  smi)}))


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Smoke run of the port on one "
                                 "NVIDIA GPU.")
    ap.add_argument("--only", choices=tuple(ONLY),
                    help="run one phase: int8 builds quantize.cu, checks and "
                         "times the per-tensor int8 kernels (int8_only); "
                         "leaf builds leaf.cu, checks and times the per-leaf "
                         "kernels (leaf_only); telemetry builds packed.cu, "
                         "times a packed server's commits without and with "
                         "telemetry (telemetry_only); wallclock builds "
                         "packed.cu and runs the wall-clock phase "
                         "(wallclock_only); socket builds packed.cu and runs "
                         "the socket phase (socket_only); obs builds "
                         "packed.cu and runs the obs phase with its untraced "
                         "twins (obs_only); families builds flash_attention.cu "
                         "and packed.cu, checks and times the flash kernels "
                         "and runs the families phase (families_only); dist "
                         "builds leaf.cu, quantize.cu and flash_attention.cu "
                         "and runs the dist phase (dist_only); plan builds "
                         "packed.cu and runs the plan phase (plan_only)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT} holds no src/repro_torch: run the script "
              "from a checkout of the repository", file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.core import compression
    from repro_torch.core.packing import build_layout
    from repro_torch import kernels as all_kernels
    from repro_torch.kernels import _build
    from repro_torch.kernels import packed as pk
    from repro_torch.models import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    bw, flops, bf16_flops, tf32_flops = peaks_for(name)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}")

    t0 = time.perf_counter()
    logs = _build.build_all(ONLY[args.only][0] if args.only
                            else _build.SOURCES)
    for src, (secs, log) in logs.items():
        print(f"build {src}.cu: {secs:.1f}s")
        print(log.strip())
    print(f"build phase: {time.perf_counter() - t0:.1f}s")
    specs = Model(get_config("tinygpt-15m")).param_specs()
    assert len(specs) == N_LEAVES, len(specs)
    dev = torch.device("cuda")
    if args.only:
        (src, *_), run_only = ONLY[args.only]
        run_only(torch, all_kernels, specs, dev, bound_of(bw, flops),
                 logs[src][1], _build.target(src))
        print(smi)
        return 0
    flash_build_report(logs["flash_attention"][1],
                       _build.target("flash_attention"))
    int8_build_report(logs["quantize"][1], _build.target("quantize"))
    leaf_build_report(logs["leaf"][1], _build.target("leaf"))

    layout = build_layout(specs)
    assert (layout.n_rows, layout.n_blocks) == (125_128, 43), layout.n_rows
    rows = kernel_phase(torch, pk, compression, layout, specs, dev, bw, flops,
                        bf16_flops, tf32_flops)
    # the untraced runs the obs phase holds its traced ones to
    untraced = {}
    t0 = time.perf_counter()
    totals = slice_phase(torch, all_kernels, untraced)
    print(f"slice phase: {time.perf_counter() - t0:.1f}s")
    # outer_update_2d's path is the single-tensor entry point: launches per
    # leaf of one outer step
    totals["outer_update_2d"] = [
        single_tensor_phase(torch, all_kernels, specs, dev), N_LEAVES]
    t0 = time.perf_counter()
    telemetry_phase(torch, all_kernels)
    print(f"telemetry phase: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    for k, (launches, arrivals) in run_control_phase(torch,
                                                     all_kernels).items():
        totals[k][0] += launches
        totals[k][1] += arrivals
    print(f"run-control phase: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    for k, (launches, arrivals) in wallclock_phase(torch, all_kernels,
                                                   untraced).items():
        totals[k][0] += launches
        totals[k][1] += arrivals
    print(f"wall-clock phase: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    for k, (launches, arrivals) in socket_phase(torch, all_kernels,
                                                untraced).items():
        totals[k][0] += launches
        totals[k][1] += arrivals
    print(f"socket phase: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    for k, (launches, arrivals) in obs_phase(torch, all_kernels,
                                             untraced).items():
        totals[k][0] += launches
        totals[k][1] += arrivals
    print(f"obs phase: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    replay_phase(torch)
    print(f"replay phase: {time.perf_counter() - t0:.1f}s")
    # the int8 kernels' path is the per-tensor entry points: launches per
    # leaf of one quantize + dequantize pass
    for k, launches in int8_path_phase(torch, all_kernels, specs,
                                       dev).items():
        totals[k] = [launches, N_LEAVES]
    t0 = time.perf_counter()
    # flash_attention_fwd's path is serving: launches per prefill
    totals["flash_attention_fwd"] = list(serve_phase(torch, all_kernels, dev))
    print(f"serve phase: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    for k, (launches, served) in families_phase(torch, all_kernels,
                                                dev).items():
        totals[k][0] += launches
        totals[k][1] += served
    print(f"families phase: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    for k, (launches, served) in dist_phase(torch, all_kernels, dev).items():
        totals[k][0] += launches
        totals[k][1] += served
    print(f"dist phase: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    for k, (launches, served) in plan_phase(torch, all_kernels, dev,
                                            smi).items():
        totals[k][0] += launches
        totals[k][1] += served
    print(f"plan phase: {time.perf_counter() - t0:.1f}s")

    kernels = []
    for r in rows:
        launches, arrivals = totals[r["name"]]
        assert launches > 0, f"{r['name']} was not launched on its path"
        shape = {k: r[k] for k in ("R", "blocks", "n", "L", "BH", "Sq",
                                   "Skv", "D", "dtype") if k in r}
        print(json.dumps({"kernel": r["name"], "kernel_ms": r["ms"],
                          "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                          "bound_by": r["bound_by"], "bytes": r["bytes"],
                          "bandwidth_Bps": bw, "fp32_flops": flops,
                          "library_ms": r["library_ms"],
                          "library_call": r["library_call"],
                          "launches_per_arrival": launches / arrivals,
                          **shape}))
        pair = {k: r[k] for k in ("pair_ms", "library_pair_ms",
                                  "library_pair_call") if k in r}
        extra = {k: r[k] for k in ("sequential_ms", "K", "max_rel_err",
                                   "dtype", "causal", "BH", "Sq", "D",
                                   "cases", "library_int8_differ") if k in r}
        source = SOURCE.get(r["name"], "packed")
        kernels.append({
            "name": r["name"], "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}.cu",
            "replaces": REPLACES[r["name"]],
            "launches": launches, "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "library_call": r["library_call"],
            "launches_per_arrival": launches / arrivals, **pair, **extra})
    assert len(kernels) == len(REPLACES), [k["name"] for k in kernels]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


# --only: the sources each one-phase run builds (the first one's build
# report goes to the phase), and the phase
ONLY = {"int8": (("quantize",), int8_only), "leaf": (("leaf",), leaf_only),
        "telemetry": (("packed",), telemetry_only),
        "wallclock": (("packed",), wallclock_only),
        "socket": (("packed",), socket_only), "obs": (("packed",), obs_only),
        "families": (("flash_attention", "packed"), families_only),
        "dist": (("leaf", "quantize", "flash_attention"), dist_only),
        "plan": (("packed",), plan_only)}


if __name__ == "__main__":
    sys.exit(main())
