#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``minips_tpu_torch``).

Run from the root of a checkout, on a machine with one NVIDIA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``minips_tpu_torch/csrc`` and drives
the port's two training paths through the entry points a user calls: the
fused LR + MLP parameter-server step of ``minips_tpu_torch/apps/lrmlp.py``
at full width (B = 65536, 13 dense and 26 categorical fields, tables of
2^18 rows), and the decoder LM's dense step of
``minips_tpu_torch/apps/lm.py`` at ``bench_lm``'s full width (8 blocks of
width 2048, 32 heads of 64, vocab 2^14, B = 16, T = 1024, bf16 compute,
Adam, flash attention, head chunks of 128, remat in mode ``"dots"``), and
the rest of the LM family: every remat mode, ``apps/lm_example.py``,
KV-cached decoding and the one-device MoE LM, and the app's sequence,
tensor, pipeline and expert-parallel layouts. Phases, each of which
raises on failure:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles every kernel, all sources at once, and times it;
   requires no register spills in the bf16 flash kernels at head dims up
   to 64 (the LM's); then reads the built flash library's SASS
   (``cuobjdump``) and requires tensor-core instructions (``HGMMA``) in the
   bf16 K2, K3 and K4 kernels, and 128-bit global loads and no ``CALL``
   (a software division) in the row gather's D = 1 and D = 8 kernels;
3. kernels: the row gather against its plain PyTorch version on the card,
   bit-exact, at D 1, 2, 3, 4, 8, 9, 16, 64, 128 and 129, f32, bf16 and
   f16, N
   from 1 to 9 and the main path's, slot views that start 0 to 3 elements
   into their buffer, out-of-range, boundary and repeated slots, the
   step's [B, 26] slot shape, and the Wide&Deep app's pulls on their own
   inputs (both hashed tables' shapes and salts, a worker batch's
   [1024, 26] keys and a holdout chunk's [8192, 26]), and the LR sparse,
   MF and word2vec apps' pulls on theirs ([512, 14] into 2^16 x 1; [1024]
   and [8192] identity slots into 2^18 x 9 and 2^15 x 9; [1024] and
   [1024, 6] hashed slots into 2^14 x 64);
4. hash: the key hash on the card, bit-identical to its numpy twin;
5. LR + MLP path: 20 steps of both models, with finite and falling loss,
   the row gather's launch count, the same first 3 steps on the CPU port
   from the same weights, and the step time on the card;
6. pull: ``SparseTable.pull`` through the kernel at D = 8 and D = 128;
7. flash kernels: K2, K3 and K4 against their plain versions (f32 and
   bf16, causal and not, GQA, global offsets, ragged T, Tq and Tk not
   multiples of the bf16 kernels' 128-row tiles, causal keys that no query
   sees, D = 72, the full-width shape, q/k/v as the LM block's strided
   views of its fused activation, also at GQA kv_heads 8 and at head dim
   128), the gradients through the autograd op with a nonzero lse
   cotangent; keys that no query sees get dK = dV = 0 exactly, and two K4
   launches agree to the bit;
8. LM path: 10 steps at full width at remat ``"dots"``, with finite and
   falling loss, K2 launched twice per block per step (the forward and
   its recompute) and K3 and K4 once, step time, tokens/s and the
   profiler's idle share; the first 3 steps of a small LM on the card and
   on the CPU port from the same weights;
9. timings: every kernel's time at its main path's shapes beside its plain
   version's, one PyTorch call's and the least time the card could take,
   with the kernel's design (``wgmma`` or ``simt-vec``); the row gather
   also cold (L2 flushed before each launch, the time its bound is read
   against), at the D = 128 pull's shape, at MF's [1024] x 9 and
   word2vec's [1024, 6] x 64 pulls, and its host launch cost;
10. LM low-precision state: ``build_lm(opt_state=...)`` at ``"bf16"``
    (``adam_bf16``) and ``"int8"`` (``adam8``), 10 full-width steps each,
    with finite and falling loss, each flash kernel launched once per
    block per step, step time, tokens/s, ``opt_state_bytes`` and peak
    device memory, and the memory one update of the whole table takes
    above what was allocated before it (also at f32, in phase 8); one
    ``adam_bf16`` and one ``adam8`` update on the card
    against the CPU port on the same gradient and state (the first 4 M
    elements of the trained table's), stored state bit-identical and
    updates within 1e-6 relative; the first 3 losses of a small LM at each
    setting, card against CPU from the same weights;
11. Wide&Deep through the Engine: ``apps/wide_deep_example.py``'s ``run``
    at its defaults (tables of 2^18 rows, dim 8, batch 1024, 4 workers,
    ``criteo_like(16384)``) for 50 iterations with a 0.2 holdout, in spmd
    mode for Wide&Deep and DeepFM and in threaded mode under BSP, SSP with
    s = 2 and ASP: finite and falling loss, the row gather launched twice
    per worker step (plus two per holdout chunk), samples/s (both modes
    leave out the first two steps) and the holdout AUC; the loader's prefetch thread (pinned memory, copy stream)
    against the host batches; threaded BSP with 1 worker against the CPU
    port's first 3 losses from the same seed, and the device's idle share
    over a threaded BSP run;
12. LR and MLP apps: ``apps/lr_example.py``'s ``run`` at its defaults
    (dim 123, batch 512, 200 iterations, a 0.2 holdout) with dense data
    (spmd and threaded, 4 workers) and sparse (a 2^16 x 1 hashed table,
    the row gather once a step and once for the holdout), a checkpoint
    resume of the dense path (100 of 200 steps with a checkpoint every 50,
    restarted, against the uninterrupted run), and
    ``apps/mlp_example.py``'s at its defaults (spmd and threaded SSP s =
    4): finite and falling loss, launch counts, samples/s, holdout AUC or
    accuracy;
13. MF at MovieLens-20M's user and item counts: a ``ratings.csv`` of
    1,000,000 ratings of 138,493 users and 26,744 items written in the
    MovieLens-20M format, read by ``apps/mf_example.py``'s ``--data_file``
    in spmd and threaded ASP (4 workers) at its defaults (rank 8 + bias,
    D = 9 tables of 2^18 and 2^15 rows, sgd, batch 1024, 300 iterations, a
    0.1 holdout): finite losses, a lower loss on the first training
    batch after training than at the initial weights (300 steps see each
    user about twice: the step's loss is flat within its batch-to-batch
    spread), the row gather exactly twice per worker step (plus two per
    holdout chunk), samples/s, holdout RMSE, the first 3 spmd losses
    against the CPU port's;
14. word2vec: ``apps/word2vec_example.py``'s ``run`` at its defaults
    (vocab 10,000, D = 64 tables of 2^14 rows, batch 1024, 5 negatives,
    200 iterations) in spmd and threaded ASP (4 workers): finite and
    falling loss, the row gather exactly twice per worker step, samples/s,
    the first 3 spmd losses against the CPU port's; then the device's idle
    share on the LR sparse, MF and word2vec paths;
15. the sharded PS, in one rank spawned by ``parallel/mesh.py:run_ranks``
    that joins an NCCL process group of world size 1 (its ``FileStore``
    under ``build/``): the LR + MLP pair built with ``group=`` at full
    width beside the same pair built with ``group=None``, 20 steps each in
    PyTorch's deterministic mode (``index_add_``'s atomics sum in no fixed
    order otherwise): the row gather exactly twice a step, every loss and
    the final tables bit-identical to ``group=None``'s (at world size 1
    every collective is a copy and each owner's row update sees the same
    slots); then both pairs' step times, in turns, whose difference is
    the collectives' cost at world size 1;
16. in the same rank, the full-width LM through the group at
    ``comm="bfloat16"`` and ``"int8"``, 10 + 30 steps each: the int8
    codes and scales of the first pull bit-identical to the CPU port's
    ``_quantize_blocks`` on the same params, finite and falling loss, each
    flash kernel once per block per step, step time, tokens/s and peak
    memory (printed beside phase 8's float32 step), and a small LM's first
    3 losses through the group against the CPU port's with
    ``group=None`` at the same ``comm``;
17. the remat spectrum: ``build_lm`` at full width at remat off, on,
    ``"attn"``, ``"dots"``, ``"hybrid"`` and ``"hybrid_qkv"``, 10 steps
    each: K2-K4 launches per step as the JAX package counts them, step
    time, tokens/s and peak memory, the first 3 losses within 2e-3 of
    remat off's, and a small LM's first 3 losses card against CPU (1e-2)
    in each mode;
18. ``apps/lm_example.py``'s ``run`` at width 2048, depth 8, T 1024, B 16,
    flash, bf16, head chunks of 128, remat ``"dots"``, the app's vocab of
    256, 20 iterations each: MHA (32 heads of 64), GQA (8 kv heads), RoPE,
    head dim 128 (16 heads), and dropout 0.1 with adamw, 5 warm-up steps
    and clipping at 1.0: finite and falling loss, launch counts, tokens/s
    and peak memory; K2-K4 timed at the GQA and head-dim-128 shapes as in
    phase 9, with K4's registers and spills at D 128; dropout's gradients
    at ``"dots"`` equal to remat off's on one full-width batch with the
    same key; a small ``--generate 16`` run on the card equal to the CPU
    port's greedy tokens from the same weights;
19. decoding: ``models/decode.py``'s ``generate`` on phase 8's trained LM
    (B 8, a 512-token prompt, 256 new tokens, bf16 compute and cache):
    prefill ms, ms per token, tokens/s, the cache's bytes (a GQA model's,
    smaller by the group factor, beside it), the bound (bf16 weights plus
    the live cache per step over the memory rate) and the idle share; on a
    small model at f32, 16 greedy tokens equal to the argmax of
    ``transformer.apply`` on the growing sequence;
20. the MoE LM: ``init_moe_lm`` and ``apply_moe_dense`` at width 2048,
    depth 8, 32 heads, 8 experts of hidden 256, B 4, T 1024, capacity
    twice the even share, top-1 and top-2: finite forward and backward and
    their time, the routes kept; a binding capacity drops routes; a small
    MoE LM's logits and aux against the CPU port's within 1e-3;
21. the ring of sequence parallelism at n = 4 on one card: the LM's
    attention at full width (B 16, T 1024 in 4 shards of 256, 32 heads of
    64, bf16; then GQA kv 8), each rank's Q shard driven through
    ``ops/flash_attention.py``'s ``ring_step`` against the 4 source shards
    at the ring's global offsets, forward and backward: K2, K3 and K4
    launched 4 times per rank; the merged output and the gradients within
    phase 7's bf16 bound of ``flash_attention`` over the whole sequence;
    the ring's time beside the whole sequence's;
22. ``apps/lm_example.py``'s ``--layout sp`` at width 2048, depth 8, 32
    heads, T 1024, B 16, bf16, ``--attn flash`` (the ring) and
    ``a2a_flash``, beside ``--layout dp --attn flash``, 8 iterations each,
    in one rank spawned on an NCCL group of world size 1: K2-K4 once per
    block per step (a ring of one is one step), tokens/s, peak memory, the
    first 3 sp losses within 2e-3 of dp's;
23. in the same rank, ``--layout tp``, ``pp`` (4 microbatches) and ``ep``
    (8 experts of hidden 256) at width 2048, depth 8, T 1024, B 4 with
    plain attention, 5 iterations each: step time, tokens/s, peak memory,
    the first loss within 2e-3 of the one-device ``apply`` (for ep
    ``apply_moe_dense``) on the same weights and batch;
24. in one rank spawned on an NCCL group of world size 1: every app's
    spmd run through the group (``run(..., group)``) at phases 11-14's
    defaults and data (Wide&Deep and DeepFM at 2^18 slots, D 8, B 1024;
    LR dense and sparse; the MLP; MF on phase 13's ``ratings.csv``;
    word2vec): the first 3 losses bit-identical to ``group=None``'s, both
    in PyTorch's deterministic mode; K1 launched as phases 11-14 count
    it; samples/s beside ``group=None``'s;
25. in the same rank, Wide&Deep ``--exec threaded`` through
    ``Engine(group=)`` with 4 workers under SSP s = 2: no admitted pull
    more than 2 clocks ahead of the slowest worker, falling loss, K1
    twice per worker step, samples/s;
26. in the same rank, checkpoints under the group: ``lr_example``'s dense
    resume (100 of 200 steps, a checkpoint every 50, restarted) and
    ``lm_example --layout dp --attn flash`` at phase 18's width with one
    block (3 of 6 steps, restarted; deterministic mode): the resumed
    losses equal the uninterrupted run's, one step directory per save,
    K2-K4 launched in the resumed run as ``want_launches`` counts them.

27. the host control plane (``comm/``, ``consistency/gate.py``,
    ``obs/``) between 2 spawned processes on the one card, each stepping
    the LR + MLP pair at full width from seed 0, once on the shm bus
    (where the host is x86-64) and once on the native mailbox, each
    under reliable delivery and seeded chaos (``drop=0.01``): a heartbeat
    monitor, ``ClockGossip`` and the SSP gate at s = 2, 50 clocks as
    ``SSPTrainer.step`` runs them without the parameter exchange (step,
    publish the clock, wait at the gate; process 1 20 ms slower a step),
    then ``publish_clock(..., retired=True)``; no step admitted more than
    2 clocks ahead of the global minimum, no frame lost while chaos
    dropped some and the layer retransmitted, K1 twice a step in each
    process, finite and falling losses, ``obs/merge`` of the two traces
    (``MINIPS_TRACE``) estimating a clock offset from the heartbeats and
    linking the round trips' flows, ``obs/report`` charging gate-blocked
    time to the slow process; the median and p99 of 200 directed round
    trips (on that bus, and on a clean bus of the same backend without
    chaos and reliable delivery) and of the gate's wait per clock, the
    pair's step time, the gate's counts; then the peer-failure drill on the native bus:
    ``MINIPS_CHAOS_KILL`` kills process 1 at clock 30, and process 0's
    gate must raise ``PeerFailureError({1})`` within the heartbeat's
    timeout and a poll, with ``gate_peer_failure`` in its flight box.
28. the multi-process parameter server (``train/sharded_ps.py``): jobs
    of 2 processes launched by ``launch.run_local_job``, sharing the
    card, each rank printing its done line. 28a: ``wide_deep_example
    --exec multiproc`` at its defaults but 100 steps (BSP), then SSP s = 4
    with rank 1
    25 ms slower a step: no frame dropped, falling loss, AUC above 0.65,
    skew at most 1 (BSP) and 5 (SSP, with gate waits on rank 0),
    fingerprints within 1e-4, each rank holding half the tables' bytes;
    samples/s per process and in all, the pull leg's p50 and p99, bytes
    pushed a step. 28b: 3 steps of the BSP job on the card and on CPU
    ranks (``MINIPS_FORCE_CPU``), the two jobs side by side, both with a
    200 ms tax on every frame between the ranks so that no push beats a
    first pull: each rank's first loss within 1e-4. 28c: ``mf_example`` (ASP,
    150 steps) on phase 13's ``ratings.csv`` and ``word2vec_example``
    under SSP s = 2 at B 128 (100 steps),
    with the same contracts and MF's RMSE. 28d: ``sharded_ps_example``'s
    sparse LR under SSP: rank 1 killed at step 10, rank 0 exits 42 with
    the ``peer_failure`` event, and a relaunch resumes from the newest
    step both saved; 3 processes train and checkpoint, and pure restores
    on 3 and on 2 (resharded by ``ckpt/elastic.py``) give the same
    parameter sum; the two drills side by side. No kernel of K1-K4 lies
    on this path.
29. the armed placement and serving layers of the multi-process PS,
    through the same launcher on the card. 29a: ``sharded_ps_example``'s
    sparse LR (Adagrad) on 3 processes under SSP s = 2, every rank
    pulling a hot range in the second shard 4 extra times a step through
    most of the run, with the heat rebalancer (``MINIPS_REBALANCE``) and
    the serving plane's replicas (``MINIPS_SERVE``) armed: a plan
    adopted everywhere and blocks migrated with their Adagrad state,
    replicas serving rows, no stale read, no frame dropped, skew at most
    3, the ranks' weights bitwise equal. 29b: the closed loop of
    ``tests/test_control_plane.py`` on 4 slots (ranks 0-2 live, 3
    standby): rank 0, the lease holder, killed at step 8, rank 1 taking
    the lease at term 1, the storm shedding, rank 1's autoscaler
    admitting rank 3 and later draining it; the survivors finish every
    step bitwise equal, with blocks restored from the elastic checkpoint,
    and the time from the kill to the successor's lease is printed. 29c:
    28a's BSP Wide&Deep job with the rebalancer, the serving plane and
    elastic membership armed and idle, its samples/s beside 28a's.
    Every rank runs on ``cuda:0``. No kernel of K1-K4 lies on this path.
30. the in-mesh collective data plane (``train/mesh_plane.py``) in this
    process. 30a: ``sharded_ps_bench.main(["--plane", "mesh", ...])``
    with 3 logical ranks on ``[cuda:0] * 3`` at the bench's defaults
    (2^16 rows x 8, B 4096, 60 steps, sparse path, ASP) for sgd, adagrad
    and adam at float32 and adagrad at blk8, and adam at 2^21 rows x 16
    with the sparse deposit: rows/s per rank, waves, collective bytes per
    row moved, the wave's and gate's p50/p99, the host time of the
    device-clock admission, the deposit stage's and the card's peaks;
    the device idle share over 10 waves (``torch.profiler``); the card's
    states against the CPU port's on one seeded single-threaded schedule
    (bitwise at sgd/float32, else 1e-6); ``--mesh-bitwise-drill`` (the
    mesh against the port's zmq wire) bitwise. 30b: ``MeshAggregator``'s
    device tier on ``[cuda:0] * 2`` (float32, blk8) against the CPU port's
    (1e-6) and the host kernel (rows plus residual, 1e-4);
    ``--hier-bitwise-drill``; the push tree's ``agg=mesh`` in the
    lockstep (bitwise the flat wire) and in 3 launched
    ``sharded_ps_example`` trainers, on the one-device tier with no
    fallback. 30c: the same bench on the host wire, 2 launched processes
    with ``--compute jit`` on the card, beside 30a's rates. No kernel of
    K1-K4 lies on this path.
31. the collective consistency plane and multi-host (``comm/cluster.py``,
    ``train/ssp_trainer.py``, ``train/ssp_spmd.py``, ``train/cssp_ps.py``,
    ``ckpt/orbax_backend.py``), 3 launched jobs on ``cuda:0``. 31a:
    ``ssp_lr_example --model mlp --mode ssp --staleness 4`` (BASELINE.json
    config 2: the 784-wide MLP, B 256, 60 steps) on 3 processes:
    steps/s per process, gate waits, the skew bound s + 1, replica
    agreement within 1e-4, falling loss. 31b: ``multihost_example
    --model wd --mode ssp --staleness 4 --batch 1024`` on 2 processes (a
    gloo group: they share the card): K1's launches in each process
    (2 per step), the row-sparse union per sync and its bytes, the sync
    backend, equal fingerprints. 31c, beside 31b: ``--model lr --mode
    bsp`` on 2 processes against ``--oracle-hosts 2`` run in this
    process, losses and fingerprints within 1e-6 (bitwise reported).
    31d, in this process: ``--mode fused --model lm --sp-attn flash`` at
    world one, K2-K4 once per block per step. 31e, in this process:
    ``--mode fused`` LR with the sharded checkpoint drill on the DCP
    backend, and ``convert_checkpoint`` native -> orbax -> native of a
    dense and a sparse table on the card, bit-identical.
33. run right after phase 9: the row Adagrad kernel
    (``csrc/row_adagrad.cu``) at the benchmark's CTR emb push, 131072 x 26
    Zipf(1.05) slots into a 2^26 x 8 float32 table and its Adagrad state:
    two pushes through ``row_adagrad`` (sort-dedup at this size) bitwise
    equal to the plain version ``_row_adagrad_sorted_reference`` from the
    same table, in PyTorch's deterministic mode (the dedup's segment sum
    then sums in a fixed order), one launch a push; on one dedup of the
    push, medians of 30 launches between CUDA events behind a sleep kernel
    of the kernel (warm and with L2 flushed), the plain version's tail,
    its two ``index_add_`` alone (``library_ms``) and whole pushes both
    ways, beside the byte bound; then two steps of the LR + MLP pair at the
    CTR cell's batch and table size, one launch a step.
34. run right after phase 33: the Adam kernel (``csrc/adam_apply.cu``,
    ``adam``'s donated update on CUDA float32 tables): three steps on a
    slice of 2^24 + 3 elements one float into their buffers bitwise equal
    to the plain version (``update_`` then ``params.add_``), one launch a
    step; then, at the LM cells' table sizes (1,556,920,000 and
    2,526,624,512 parameters), one step of the kernel over the whole
    vectors checked bitwise against the plain version on copies of three
    slices of the same inputs (the head, the middle or the slice across
    element 2^31, and the tail), and medians of 30 launches beside the
    28-byte-a-parameter bound and the plain version's time. Its kernel
    row's ``launches`` are phase 8's LM steps, one a step.

Before it prints its result, and on every way out, the script stops and
reaps every process it started that still runs: the launcher's fork
server, multiprocessing's resource tracker, and any other child (it makes
itself their subreaper, so a child's orphans count as its own).

``python3 chip_smoke.py --ranks N`` runs phases 22-23 and then 24-26 on
N cards of one machine, one NCCL rank each: the LR + MLP pair at 65,536
rows per card and at 65,536 in all, Wide&Deep spmd and threaded (rank 0
driving N workers) and the ``lr_example`` resume, with samples/s in all
and per card beside one card's in the same call, and K1's launches on
every rank; then phase 28a's BSP job as N launched processes, one card
each, beside 2 processes sharing card 0, samples/s in all; then phase
30's plane with N ranks on the N cards (``torch.cuda.nccl``), sgd and
adam at the bench's defaults, its states and the aggregator's device tier
against the same ranks on card 0 within 1e-5; then phase 31's Wide&Deep
on the collective plane as N launched processes, one card each, through
NCCL: ``--mode fused`` held to the same job on one process (losses within
2e-3) and ``--mode bsp`` (replicas equal; the reference has no oracle for
it), K1 launched in every process.

The last two lines are a JSON object with every kernel's numbers (its
launches on each path beside them) and then ``{"ok": true, "device":
{...}}``. Without CUDA, or without the package
beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
B = 65536
CHAIN = 20
REPS = 5
CPU_STEPS = 3
# |loss(card) - loss(CPU)| bound over the first CPU_STEPS steps. The MLP
# multiplies in bf16 (8 bits of mantissa) and the card's and the CPU's GEMMs
# accumulate in different orders and round at different places; the row
# updates' index_add_ sums duplicate slots with atomics in no fixed order on
# the card. Each shifts a mean loss over 65536 samples by far less than this.
LOSS_TOL = 5e-3
TIMED_LAUNCHES = 30  # per kernel timing; the median is reported
SLEEP_CYCLES = 200_000_000  # ~0.1 s at H100 clocks: covers queueing them
PROFILED_STEPS = 3
# the LM at bench_lm's full width: B sequences of T tokens, 8 blocks of 2048
LM_B, LM_T, LM_DIM, LM_DEPTH = 16, 1024, 2048, 8
LM_CHAIN = 10
LM_REPS = 3
LM_PROFILED_STEPS = 2
# |loss(card) - loss(CPU)| bound over the small LM's first CPU_STEPS steps.
# Both run bf16 matmuls (8 bits of mantissa) rounding at the same points,
# but sum in other orders (cuBLAS and the kernels vs the CPU's GEMMs and
# the plain versions, whose forward tiles K at 256 rows, not 64), so a
# logit can differ by a rounding step of 2^-8; the mean cross-entropy over
# 512 tokens moves by far less than this.
LM_LOSS_TOL = 1e-2
# flash kernels against their plain versions: max |err| over
# max(1, max |plain|). float32: the same f32 arithmetic summed in another
# order. bf16: the rounding points are shared (p, ds, p^T, the outputs), so
# the f32 summation order can flip one of them by one bf16 step, 2^-8 of
# the value, at most 2^-7 of the largest value.
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
LSE_TOL = 1e-4  # lse is float32 on both sides
# peak rates of an H100 SXM (NVIDIA data sheet): dense bf16 tensor cores
BF16_FLOPS = 989e12
DESIGN = {"gather_rows": "simt-vec", "flash_forward": "wgmma",
          "flash_bwd_dq": "wgmma", "flash_bwd_dkv": "wgmma",
          "row_adagrad": "simt-vec", "adam_apply": "simt-vec-stream"}
# phase 34: the Adam kernel at the LM cells' table sizes (GPT-2 XL's and
# LFM2's held parameters), 28 bytes a parameter; its bitwise check runs on
# a slice this long, one float into its buffers (the kernel's scalar head),
# and at each size on copies of slices of ADAM_PART elements
ADAM_SIZES = {"gpt2_xl": 1_556_920_000, "lfm2_8b_a1b": 2_526_624_512}
ADAM_SLICE = (1 << 24) + 3
ADAM_PART = 1 << 22
ADAM_BYTES_PER_PARAM = 28
# phase 33: the benchmark's CTR cell, as its configuration and traffic
# files define it (2^26 x 8 emb rows under row Adagrad, B 131072 x 26
# fields of Zipf ids)
CTR_CONFIG = os.path.join(REPO, "benchmark", "configs",
                          "criteo1tb-lrmlp.json")
CTR_TRAFFIC = os.path.join(REPO, "benchmark", "traffic",
                           "zipf-b131072.json")
# the bf16 K2, K3 and K4 kernels, each of which must hold HGMMA
# instructions; those at head dims up to 64 (the LM's) must not spill
WGMMA_KERNELS = ("flash_fwd_wgmma_kernel<bf16,64>",
                 "flash_fwd_wgmma_kernel<bf16,128>",
                 "flash_bwd_dq_wgmma_kernel<bf16,64>",
                 "flash_bwd_dq_wgmma_kernel<bf16,128>",
                 "flash_bwd_dkv_wgmma_kernel<bf16,64>",
                 "flash_bwd_dkv_wgmma_kernel<bf16,128>")
# the gather's word types as they appear in its kernels' mangled names
GATHER_WORDS = {"h": "u8", "t": "u16", "j": "u32", "5uint2": "u64",
                "5uint4": "u128"}
# the gather instantiations of the main path's rows (D = 1 and D = 8 f32),
# at both index widths, each of which must load 128 bits at a time and call
# no routine (a software division would be a CALL)
GATHER_MAIN_KERNELS = ("gather_narrow_kernel<u32x1,",
                       "gather_rows_kernel<u128x2,")
# phase 3's gather cases: row widths, counts (and the main path's N),
# slot views that start this many elements into their buffer
GATHER_DIMS = (1, 2, 3, 4, 8, 9, 16, 64, 128, 129)
GATHER_SMALL_NS = (1, 3, 4, 5, 7, 8, 9)
GATHER_OFFSETS = (0, 1, 2, 3)
GATHER_COLD_FLUSH_BYTES = 256 << 20  # written before each cold launch
LAUNCH_CALLS = 200  # host calls timed for the gather's launch cost
# Device memory rate by card, bytes/s (NVIDIA data sheets); the H100 SXM's
# 3.35 TB/s unless the name says otherwise.
MEM_BW = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H200", 4.8e12),
          ("H100", 3.35e12))
LOWP_UPDATE_N = 4 << 20  # elements of the card-against-CPU update check
LOWP_UPDATE_RTOL = 1e-6
WD_ITERS = 50
WD_WORKERS = 4
WD_EVAL_FRAC = 0.2
WD_EVAL_CHUNK = 8192  # evaluate_auc's chunk: one gather per table each
WD_PROFILED_ITERS = 10
APP_PROFILED_ITERS = 50
# the single-process apps (phases 12-14), at their own defaults
APP_WORKERS = 4
LR_EVAL_FRAC = 0.2
RESUME_AT, RESUME_EVERY = 100, 50  # the LR dense checkpoint resume
# |loss(resumed) - loss(uninterrupted)|: the restored state is the saved
# one bit for bit and the data stream fast-forwards, so the same kernels
# see the same inputs
RESUME_TOL = 1e-6
# MF at MovieLens-20M's user and item counts (its README), the 20,000,263
# ratings cut to 1,000,000 for the run's time
ML20M_USERS, ML20M_ITEMS, ML20M_RATINGS = 138_493, 26_744, 20_000_263
MF_RATINGS = 1_000_000
MF_EVAL_FRAC = 0.1
# |loss(card) - loss(CPU)| over MF's and word2vec's first CPU_STEPS steps.
# Both are float32 throughout; the card's index_add_ sums a batch's
# duplicate rows (popular items, unigram^0.75 negatives) with atomics in
# no fixed order, and the batch-sized gradient scale (lr x B = 51) carries
# a rounding difference into the next step's rows: ~1e-6 after 3 steps.
APP_LOSS_TOL = 1e-4
# phases 15-16: the sharded PS through an NCCL group of world size 1, in a
# rank spawned by parallel/mesh.py:run_ranks (its FileStore under build/)
GROUP_TIMEOUT_S = 900.0
GROUP_COMMS = ("bfloat16", "int8")
# |loss(card, group, comm) - loss(CPU, group=None, comm)| over a small LM's
# first CPU_STEPS steps, set before the first run: the codec runs on both
# sides (the first pull's codes are the same bits), the rest is the small
# LM check's bf16 arithmetic, whose bound this keeps
COMM_LM_LOSS_TOL = LM_LOSS_TOL
# phase 17: every remat mode of the full-width LM, 10 steps each
REMAT_MODES = (False, True, "attn", "dots", "hybrid", "hybrid_qkv")
REMAT_STEPS = 10
# |loss(mode) - loss(remat off)| over the first 3 steps on the card: the
# same kernels on the same inputs, recomputed rather than saved
REMAT_LOSS_TOL = 2e-3
# phase 18: apps/lm_example.py's run at full width, 20 iterations a
# configuration; lr 1e-3 is bench_lm's at this width (the app's default
# 3e-3 is sized for its dim-64 default model)
APP_LM_ITERS = 20
APP_LM_LR = 1e-3
APP_LM_FLAGS = dict(dim=2048, depth=8, heads=32, seq_len=1024,
                    attn="flash", dtype="bfloat16", head_chunk=128,
                    remat=True, remat_mode="dots")
APP_LM_CONFIGS = {
    "mha": {}, "gqa_kv8": dict(kv_heads=8), "rope": dict(rope=True),
    "hd128": dict(heads=16),
    "dropout_adamw": dict(dropout=0.1, warmup_steps=5, clip_norm=1.0)}
# dropout under remat: the gradients at "dots" against remat off with the
# same key: the same masks and kernels, bit-identical expected; the bound
# is one bf16 rounding step of the largest gradient
DROPOUT_REMAT_TOL = 2.0 ** -8
APP_GEN_TOKENS = 16
# phase 19: decoding phase 8's trained LM, bf16 compute and cache
DEC_B, DEC_PROMPT, DEC_NEW = 8, 512, 256
DEC_PROFILED = 32  # new tokens of the profiled decode run
DEC_GQA_KV = 8
DEC_ORACLE_STEPS = 16
# phase 20: the MoE LM at init_moe_lm's and lm_example --experts' defaults
MOE_B, MOE_EXPERTS, MOE_HIDDEN, MOE_REPS = 4, 8, 256, 3
MOE_SMALL_TOL = 1e-3
# phase 21: an n-way ring's per-step kernel work on one card, the LM's
# attention at full width (B 16, T 1024 in RING_N shards, 32 heads of 64,
# bf16), MHA and GQA kv 8; held to phase 7's bf16 bound against flash
# attention over the whole sequence
RING_N, RING_GQA_KV = 4, 8
# phases 22-23: lm_example's parallel layouts at full width, in one rank
# spawned on an NCCL group of world size 1; |first losses(sp) - (dp)|
# (the same kernels: at n = 1 the ring is one step and its merge the
# identity) and |first loss - the one-device apply's| for tp, pp and ep
SP_ITERS = 8
PAR_B, PAR_ITERS, PAR_MICRO = 4, 5, 4
PAR_LOSS_TOL = 2e-3
# phases 24-26: the apps, the Engine and checkpoints through an NCCL group,
# in one spawned rank (n ranks under --ranks n); phase 25's SSP staleness;
# phase 26's LM at full width and one block, LM_CKPT_ITERS steps whole and
# half, resumed; the pair's one-card batch, bench_lrmlp's
WD_SSP = 2
LM_CKPT_DEPTH, LM_CKPT_ITERS = 1, 6
PAIR_ONE_CARD_BATCH = B
# phase 27: the host control plane between CP_PROCS processes on the one
# card, each stepping the LR + MLP pair at B; every bus under reliable
# delivery and seeded chaos, a heartbeat monitor (interval, timeout in s)
# and the SSP gate at s = CP_STALENESS; process 1 spends CP_SLOW_MS more
# host time a step, so that the gate blocks; CP_PINGS directed round trips
# timed before the clocks, on a clean bus of the same backend and then on
# the chaotic, reliable one; the drill kills process 1 at CP_KILL_CLOCK
CP_PROCS = 2
CP_CLOCKS = 50
CP_STALENESS = 2
CP_CHAOS = "2718:drop=0.01"
CP_HB_INTERVAL, CP_HB_TIMEOUT = 0.1, 1.0
CP_GATE_TIMEOUT = 60.0
CP_SLOW_MS = 20.0
CP_PINGS = 200
CP_KILL_CLOCK = 30
CP_WARM_STEPS = 2
# the drill's bound on the gate's block, from its start to the raise: the
# heartbeat's timeout, one poll of the gate (it consults the monitor after
# each wait of min(1 s, its timeout)), and 0.5 s for the rest of the killed
# process's last step and the scheduling of two threads
CP_DETECT_S = CP_HB_TIMEOUT + 1.0 + 0.5
CP_SPAWN_TIMEOUT = 300.0
# phase 28: the multi-process parameter server (train/sharded_ps.py) under
# the port's launcher, MP_PROCS processes sharing the one card; each job
# at its app's defaults unless a flag below says otherwise. 28a's SSP run:
# staleness, the slow rank and its extra host time a step
MP_PROCS = 2
MP_SSP, MP_SLOW_RANK, MP_SLOW_MS = 4, 1, 25.0
# steps of the Wide&Deep flagship (28a, 29c, --ranks N) and of 28c's MF
# and word2vec jobs: half the apps' defaults (200, 300, 200), to leave the
# script's time for phase 30
MP_ITERS, MP_MF_ITERS, MP_W2V_ITERS = 100, 150, 100
MP_JOB_TIMEOUT_S = 300.0
# 28b: |loss_first(card) - loss_first(CPU)| per rank. The first step's
# rows are the seeded initial tables in both runs; the deep tower's bf16
# GEMMs sum in other orders on the card and the CPU, which moves a mean
# loss over 1024 samples by far less than this. A rank's first pull races
# its peer's first push (a push to the pusher's own shard lands at once),
# so both runs put a fixed MP_TAX_MS on every frame between the ranks: a
# push then lands two taxed hops after the pulls of step 0
MP_FIRST_LOSS_TOL = 1e-4
MP_TAX_MS = 200
MP_TAX_ITERS = 3
# 28c: word2vec's SSP staleness (its default is 0, BSP's bound) and
# batch: at its default B 1024 each of the 2 processes pushes B x its mean
# gradient at lr 0.05, and the JAX package's job diverges there too (loss
# 4.159 -> 10.1 and 12.1 in a CPU run), so 28c takes the JAX package's
# multiproc smoke batch (tests/test_distributed_smoke.py)
MP_W2V_SSP, MP_W2V_BATCH = 2, 128
# 28d: sharded_ps_example's sparse LR under SSP; the kill drill (rank 1
# dies at step MP_KILL_AT, a checkpoint every MP_CKPT_EVERY) and the
# elastic drill (MP_ELASTIC_ITERS steps on 3 processes, restored on 3 and
# on 2); the pure restores' parameter sums agree within MP_ELASTIC_TOL
MP_KILL_AT, MP_CKPT_EVERY, MP_KILL_ITERS = 10, 4, 40
MP_RESUME_ITERS = 16
MP_ELASTIC_ITERS, MP_ELASTIC_EVERY = 20, 5
MP_ELASTIC_TOL = 1e-5
MP_FP_TOL = 1e-4  # replica agreement: fingerprints after finalize
# phase 29: the armed placement and serving layers (balance/, serve/)
# under the launcher on the one card. 29a: sharded_ps_example's sparse LR
# with Adagrad (a migrated block carries its accumulator) on PL_PROCS
# processes under SSP s = PL_SSP, a storm of PL_STORM_PULLS extra pulls a
# step of the hot range in the second shard; the rebalancer plans every
# 0.2 s past a max/mean heat of 1.2, and the serving plane replicates up
# to 8 hot blocks a tick onto 2 holders under 2 s leases
PL_PROCS, PL_SSP, PL_ITERS = 3, 2, 40
PL_STORM = ["--storm-from", "4", "--storm-until", "36", "--storm-pulls",
            "4", "--storm-keys", "64"]
PL_REBALANCE = ("interval=0.2,threshold=1.2,max_blocks=8,block=16,topk=32,"
                "min_heat=10")
PL_SERVE = "replicas=2,hot=8,interval=0,min_heat=2,lease=2.0"
# 29b: tests/test_control_plane.py's closed loop, its flags and env as
# they stand there (4 slots, rank 3 standby; rank 0 SIGKILLed at step 8)
CL_PROCS, CL_ITERS, CL_KILL_RANK = 4, 60, 0
CL_FLAGS = ["--model", "sparse", "--mode", "ssp", "--staleness", "2",
            "--iters", str(CL_ITERS), "--batch", "64",
            "--checkpoint-every", "5", "--slow-rank", "1", "--slow-ms", "15",
            "--storm-from", "14", "--storm-until", "34", "--storm-pulls",
            "12", "--storm-keys", "64"]
CL_ENV = {"MINIPS_ELASTIC": "live=0-2",
          "MINIPS_AUTOSCALE": "up_shed=4,up_after=2,down_after=4,cool=2",
          "MINIPS_SERVE": "rate=60,burst=8,min_heat=1e9",
          "MINIPS_CHAOS_KILL": f"7:rank={CL_KILL_RANK},step=8",
          "MINIPS_HEARTBEAT": "interval=0.1,timeout=6.0,stall=2.0"}
# 29c: 28a's BSP job with the layers armed and idle: the heat accounting
# and its reports run, but the planner's and the serving plane's
# thresholds sit above any heat the job makes (at the rebalancer's
# defaults 200 steps of it migrate blocks, and a rank then holds more
# than its half of the tables: not idle)
IDLE_ENV = {"MINIPS_REBALANCE": "min_heat=1e18",
            "MINIPS_SERVE": "replicas=1,min_heat=1e9",
            "MINIPS_ELASTIC": "1"}
# phase 30: the in-mesh collective data plane (train/mesh_plane.py) in this
# process. 30a: MESH_RANKS logical ranks on [cuda:0] * MESH_RANKS through
# ``sharded_ps_bench --plane mesh`` at the bench's defaults (2^16 rows x 8,
# B 4096, 60 steps after 10 warm-up, sparse path, ASP), one run per
# (updater, comm) of MESH_RUNS, then one at an embedding table's size:
# 2^21 rows x 16 with adam and the sparse deposit, MESH_BIG_ITERS steps
MESH_RANKS = 3
MESH_RUNS = (("sgd", "float32"), ("adagrad", "float32"),
             ("adam", "float32"), ("adagrad", "blk8"))
MESH_BIG_ROWS, MESH_BIG_DIM = 1 << 21, 16
MESH_BIG_ITERS, MESH_BIG_WARMUP = 30, 5
MESH_PROFILED_WAVES = 10
# the card's shard states against the CPU port's on one seeded
# single-threaded schedule (MESH_CMP_STEPS BSP steps at the bench's shape):
# bitwise at sgd/float32, else within MESH_STATE_TOL; on N distinct cards
# NCCL's ring sums in its own order, so N cards against one within
# MESH_CARDS_TOL
MESH_CMP_STEPS = 6
MESH_STATE_TOL = 1e-6
MESH_CARDS_TOL = 1e-5
# 30b: MeshAggregator's device tier on [cuda:0] * 2, MESH_AGG_REDUCES
# reduces of 2 slots x MESH_AGG_KEYS keys at the bench's table shape; the
# push tree's agg=mesh in MESH_TREE_PROCS launched sharded_ps_example
# trainers (tests/test_hybrid_plane.py's whole-host drill, no kill)
MESH_AGG_REDUCES, MESH_AGG_KEYS = 4, 4096
MESH_TREE_PROCS = 3
MESH_TREE_FLAGS = ["--model", "sparse", "--mode", "ssp", "--staleness", "2",
                   "--iters", "30", "--batch", "64"]
# phase 31: the collective consistency plane and multi-host on cuda:0.
# 31a: BASELINE.json config 2 at ssp_lr_example's defaults on CS_MLP_PROCS
# processes; the gate's skew is read before it waits, so its bound is s + 1
# (the JAX package's smoke, tests/test_distributed_smoke.py); replicas after
# finalize within CS_FP_TOL. 31b: the Wide&Deep CollectiveSSPPS at 28a's
# batch on CS_PROCS processes; 31c: the lr CollectiveSSP on CS_PROCS
# processes against --oracle-hosts in this process: the same kernels on the
# same shapes and gloo's sum of two deltas, so bitwise is expected and
# CS_ORACLE_TOL the bound checked. 31d: the LM with ring flash at world one;
# 31e: the sharded checkpoint drill and convert_checkpoint
CS_MLP_PROCS, CS_SSP = 3, 4
CS_PROCS, CS_WD_BATCH = 2, 1024
CS_FP_TOL = 1e-4
CS_ORACLE_TOL = 1e-6
CS_LM_ITERS, CS_LM_DEPTH = 30, 2  # multihost_example's lm defaults
# 31d's attention as (B, Tq, Tk, H, Hk, D, q_off, k_off): --batch 64,
# --seq-len 64, the fixed LM's 2 heads of 16 at world one; phase 7 holds
# K2-K4 to their plain versions there
CS_LM_CASE = (64, 64, 64, 2, 2, 16, 0, 0)
CS_FUSED_TOL = 2e-3  # --ranks N: N cards' fused wd against one process
# --ranks N: the bsp wd job on N cards (NCCL) against the same flags on N
# processes sharing card 0 (gloo): the losses within CS_BSP_TOL, the
# fingerprint within CS_BSP_FP_RTOL of its value. On the CPU, one rank's
# delta doubled in the row-sparse merge moves 4 ranks' losses by 4.7e-3 to
# 6.7e-3 and the fingerprint by 3.0e-4 of its value
CS_BSP_TOL, CS_BSP_FP_RTOL = 1e-3, 3e-5


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def kernel_name(mangled: str) -> str:
    """A kernel template's mangled name as ``flash_fwd_kernel<bf16,64>``
    (element type and head-dim instantiation) or
    ``gather_rows_kernel<u128x2,r4,i32>`` (word type, words per row (``N``
    at a runtime width), rows per thread, index width). The name is the
    identifier ending in ``_kernel`` that its length prefix delimits: the
    namespace before it may end in digits too."""
    tag = mangled.find("_kernelI")
    if tag < 0:
        return mangled
    end = tag + len("_kernel")
    start = next((i for i in range(end - 1, 0, -1)
                  if mangled[:i].endswith(str(end - i))), None)
    if start is None:
        return mangled
    base = mangled[start:end]
    if base.startswith("gather_"):
        wide = re.match(r"I(\d+\w+?|[a-z])Li(\d+)ELi(\d+)E([a-z])E",
                        mangled[end:])
        # the narrow kernel's rows are one 4-byte word: <rows, index>
        narrow = re.match(r"ILi(\d+)E([a-z])E", mangled[end:])
        if wide or narrow:
            word, words, rows, index = (wide.groups() if wide else
                                        ("j", "1", *narrow.groups()))
            return (f"{base}<{GATHER_WORDS.get(word, word)}x"
                    f"{words if words != '0' else 'N'},r{rows},"
                    f"{'i32' if index == 'i' else 'i64'}>")
    dmax = re.match(r"I\w*?Li(\d+)E", mangled[end:])
    if dmax:
        dtype = "f32" if mangled[end + 1] == "f" else "bf16"
        return f"{base}<{dtype},{dmax.group(1)}>"
    return f"{base}<{mangled[end + 1:mangled.find('E', end)]}>"


def ptxas_lines(log: str):
    """(kernel, line) for each registers-and-spills line of an ``-Xptxas
    -v`` log, and ("ptxas", line) for each performance warning (a wgmma
    serialized for want of registers, say), which names its kernel."""
    name = "?"
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name = kernel_name(entry.group(1))
        elif "registers" in line or "spill" in line:
            yield name, line.strip()
        elif "Performance Loss" in line:
            yield "ptxas", line.strip()


def spill_check(log: str) -> None:
    """Raise if a bf16 flash kernel at head dims up to 64 spills."""
    for name, line in ptxas_lines(log):
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if name in WGMMA_KERNELS and name.endswith(",64>") and spill:
            check(spill.group(1) == spill.group(2) == "0",
                  f"{name} spills registers: {line}")


def sass_by_kernel(build, library) -> dict:
    """Each kernel's SASS in a built library, by label (``cuobjdump
    --dump-sass``)."""
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run(
        [cuobjdump, "--dump-sass", str(library)],
        capture_output=True, text=True, timeout=300, check=True).stdout
    return {kernel_name(chunk.split("\n", 1)[0].strip()): chunk
            for chunk in sass.split("Function : ")[1:]}


def tensor_core_check(build) -> dict:
    """HGMMA (wgmma) instructions per kernel of the built flash library.
    Raises unless every bf16 K2, K3 and K4 kernel holds some."""
    counts = {name: chunk.count("HGMMA")
              for name, chunk in sass_by_kernel(
                  build, build.library_path("flash_attn")).items()
              if name.startswith("flash_")}
    for name in WGMMA_KERNELS:
        check(counts.get(name, 0) > 0,
              f"no HGMMA in {name}: the bf16 kernel does not use the tensor "
              f"cores (SASS counts {counts})")
    return counts


def gather_sass_check(build) -> dict:
    """128-bit global loads (``LDG.E.128`` in any suffixed form) and
    ``CALL``s (a software division routine would be one) per kernel of the
    built gather library. Raises unless the main path's instantiations
    (D = 1 and D = 8 f32) each hold a 128-bit load and no ``CALL``."""
    counts = {name: {"ldg128": len(re.findall(
                         r"\bLDG\.E[.A-Z0-9_]*?\.128\b", chunk)),
                     "call": len(re.findall(r"\bCALL\b", chunk))}
              for name, chunk in sass_by_kernel(
                  build, build.library_path("gather_rows")).items()}
    for prefix in GATHER_MAIN_KERNELS:
        found = {n: c for n, c in counts.items() if n.startswith(prefix)}
        check(len(found) == 2, f"expected {prefix}...> at both index widths "
              f"in the gather library, found {sorted(counts)}")
        for name, c in found.items():
            check(c["ldg128"] > 0 and c["call"] == 0,
                  f"{name}: {c['ldg128']} 128-bit loads and {c['call']} "
                  "calls in its SASS; the design needs >0 and 0")
    return counts


def time_ms(torch, fn, before=None) -> float:
    """Median over TIMED_LAUNCHES calls, each between two CUDA events,
    after warm-up. A sleep kernel first holds the stream while the host
    queues every call, so that the events bracket device time only and
    not the host's launch overhead (which exceeds a short kernel's time).
    ``before`` is queued ahead of each call, outside the events: a write of
    a tensor larger than L2 makes the call start with its data out of L2,
    which gives the cold time."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True))
          for _ in range(TIMED_LAUNCHES)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for s, e in ev:
        if before is not None:
            before()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def launch_cost_us(torch, fn) -> float:
    """Host time of one call of ``fn`` in microseconds, the mean of
    LAUNCH_CALLS calls queued while a sleep kernel holds the stream, so that
    no call waits for the card."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    for _ in range(LAUNCH_CALLS):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * host_s / LAUNCH_CALLS


def lm_views(make, B, T, H, Hk, D):
    """q, k, v as the LM block hands them to attention
    (``minips_tpu_torch/models/transformer.py``): strided views of one fused
    ``[B, T, 3, H*D]`` activation, or under GQA a q of its own and k, v
    views of a fused ``[B, T, 2, Hk*D]``."""
    if Hk == H:
        qkv = make(B, T, 3, H * D)
        return tuple(qkv[:, :, i].reshape(B, T, H, D) for i in range(3))
    kv = make(B, T, 2, Hk * D)
    return (make(B, T, H, D),) + tuple(
        kv[:, :, i].reshape(B, T, Hk, D) for i in range(2))


def flash_errors(torch, tfa, case, dtype, causal, seed,
                 views=False) -> tuple:
    """K2 forward and K3/K4 (through the autograd op, with nonzero output
    and lse cotangents) on one case, each against its plain version on the
    same inputs; with ``views`` q, k, v are the LM block's views of its fused
    activation (Tq = Tk). Raises on a mismatch, on nonzero dK or dV for
    keys that no query sees, or on two K4 launches that differ; returns
    each kernel's max |err| and that error over max(1, max |plain|), the
    quantity the tolerance bounds."""
    B, Tq, Tk, H, Hk, D, q_off, k_off = case
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, dt=dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    def leaf(*shape):
        return rnd(*shape).requires_grad_(True)

    if views:
        q, k, v = lm_views(leaf, B, Tq, H, Hk, D)
    else:
        q, k, v = leaf(B, Tq, H, D), leaf(B, Tk, Hk, D), leaf(B, Tk, Hk, D)
    g_out, g_lse = rnd(B, Tq, H, D), rnd(B, H, Tq, 1, dt=torch.float32)
    scale = D ** -0.5
    before = (tfa.flash_forward.launches, tfa.flash_bwd_dq.launches,
              tfa.flash_bwd_dkv.launches)
    out, lse = tfa.flash_with_lse(q, k, v, q_off, k_off, causal=causal)
    dq, dk, dv = torch.autograd.grad((out, lse), (q, k, v), (g_out, g_lse))
    torch.cuda.synchronize()
    after = (tfa.flash_forward.launches, tfa.flash_bwd_dq.launches,
             tfa.flash_bwd_dkv.launches)
    check(tuple(a - b for a, b in zip(after, before)) == (1, 1, 1),
          f"flash op did not launch K2, K3, K4 once each: {before} {after}")
    q, k, v, out, lse = (x.detach() for x in (q, k, v, out, lse))
    kw = dict(causal=causal, scale=scale)
    ref, rlse = tfa.flash_forward_reference(q, k, v, q_off, k_off, **kw)
    # the backward's inputs as the op formed them from the kernel's outputs
    dvec = ((g_out.float() * out.float()).sum(-1).transpose(1, 2)[..., None]
            - g_lse)
    rdq = tfa.flash_bwd_dq_reference(q, k, v, g_out, lse, dvec, q_off,
                                     k_off, **kw)
    rdk, rdv = tfa.flash_bwd_dkv_reference(q, k, v, g_out, lse, dvec, q_off,
                                           k_off, **kw)
    # K4 sums each kv head's q heads in a fixed order with no atomics: two
    # more launches on the same inputs agree to the bit
    again = [tfa.flash_bwd_dkv(q, k, v, g_out, lse, dvec, q_off, k_off, **kw)
             for _ in range(2)]
    check(all(torch.equal(a, b) for a, b in zip(*again)),
          f"two K4 launches on the same inputs differ: case {case} {dtype}")
    # keys from k_off + j > q_off + Tq - 1 on see no query under the causal
    # mask: exactly zero, as the TPU kernel and the plain version give
    unseen = min(max(q_off + Tq - k_off, 0), Tk) if causal else Tk
    check(bool((dk[:, unseen:] == 0).all() and (dv[:, unseen:] == 0).all()),
          f"flash_bwd_dkv: keys {unseen}.. that no query sees got nonzero "
          f"dK or dV: case {case} {dtype}")
    tol = FLASH_TOL[str(dtype).split(".")[-1]]
    errs, rels = {}, {}
    for kernel, pairs in (("flash_forward", ((out, ref),)),
                          ("flash_bwd_dq", ((dq, rdq),)),
                          ("flash_bwd_dkv", ((dk, rdk), (dv, rdv)))):
        worst = worst_rel = 0.0
        for got, want in pairs:
            check(got.shape == want.shape and got.dtype == want.dtype,
                  f"{kernel} shape/dtype {tuple(got.shape)} {got.dtype}")
            err = float((got.float() - want.float()).abs().max())
            scale_ref = max(1.0, float(want.float().abs().max()))
            check(err <= tol * scale_ref,
                  f"{kernel} differs from its plain version: case {case} "
                  f"{dtype} causal={causal}: max err {err} > {tol} x "
                  f"{scale_ref}")
            worst = max(worst, err)
            worst_rel = max(worst_rel, err / scale_ref)
        errs[kernel], rels[kernel] = worst, worst_rel
    lerr = float((lse - rlse).abs().max())
    check(lerr <= LSE_TOL, f"flash_forward lse differs by {lerr}: case "
          f"{case} {dtype} causal={causal}")
    return errs, rels


def attention_work(B, Tq, Tk, H, Hk, D, q_off, k_off, causal, item):
    """(live (q, k) pairs, bytes each of K2, K3, K4 must move): each input
    read once, each output written once."""
    import numpy as np

    qi = np.arange(Tq)[:, None] + q_off
    kj = np.arange(Tk)[None, :] + k_off
    pairs = B * H * int((qi >= kj).sum() if causal else Tq * Tk)
    qb, kb, rows = B * Tq * H * D * item, B * Tk * Hk * D * item, B * H * Tq * 4
    return pairs, {
        "flash_forward": 2 * qb + 2 * kb + rows,             # q, k, v; o, lse
        "flash_bwd_dq": 3 * qb + 2 * kb + 2 * rows,          # q, dO, k, v,
        "flash_bwd_dkv": 2 * qb + 4 * kb + 2 * rows}         # lse, dvec; out


FLASH_REPLACES = {"flash_forward": "minips_tpu/ops/flash_attention.py:190",
                  "flash_bwd_dq": "minips_tpu/ops/flash_attention.py:297",
                  "flash_bwd_dkv": "minips_tpu/ops/flash_attention.py:332"}


def flash_timings(torch, tfa, B, T, H, Hk, D, mem_bw) -> dict:
    """K2, K3 and K4 timed at one bf16 causal shape, q/k/v as the LM
    block's views of its fused activation (``lm_views``): each kernel's
    time, its plain version's, the library yardstick's (SDPA's forward for
    K2, its backward, dQ dK dV together, for K3 and K4, shared between
    them in proportion to the work) and the bound (bytes over the memory
    rate, or the live pairs' flops over the dense bf16 rate)."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)

    def make(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    q, k, v = lm_views(make, B, T, H, Hk, D)
    g_out = make(B, T, H, D)
    kw = dict(causal=True, scale=D ** -0.5)
    out, lse = tfa.flash_forward(q, k, v, **kw)
    dvec = (g_out.float() * out.float()).sum(-1).transpose(1, 2)[..., None]
    sq, sk, sv = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    gqa = {"enable_gqa": True} if Hk != H else {}

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            sq, sk, sv, is_causal=True, **gqa)

    s_out = sdpa()
    s_g = g_out.transpose(1, 2).contiguous()
    pairs, nbytes = attention_work(B, T, T, H, Hk, D, 0, 0, True, 2)
    flops = {"flash_forward": 4 * D * pairs, "flash_bwd_dq": 6 * D * pairs,
             "flash_bwd_dkv": 8 * D * pairs}
    runs = {
        "flash_forward": (lambda: tfa.flash_forward(q, k, v, **kw),
                          lambda: tfa.flash_forward_reference(q, k, v, **kw),
                          sdpa),
        "flash_bwd_dq": (lambda: tfa.flash_bwd_dq(q, k, v, g_out, lse, dvec,
                                                  **kw),
                         lambda: tfa.flash_bwd_dq_reference(
                             q, k, v, g_out, lse, dvec, **kw),
                         lambda: torch.autograd.grad(
                             s_out, (sq, sk, sv), s_g, retain_graph=True)),
        "flash_bwd_dkv": (lambda: tfa.flash_bwd_dkv(q, k, v, g_out, lse,
                                                    dvec, **kw),
                          lambda: tfa.flash_bwd_dkv_reference(
                              q, k, v, g_out, lse, dvec, **kw),
                          None),
    }
    # SDPA's backward computes dQ, dK and dV in one call; K3's share of it
    # is in proportion to the work, 6 D against K4's 8 D per pair
    share = {"flash_forward": 1.0, "flash_bwd_dq": 6 / 14,
             "flash_bwd_dkv": 8 / 14}
    rows, sdpa_bwd_ms = {}, None
    for name, (kernel_fn, plain_fn, lib_fn) in runs.items():
        ms = time_ms(torch, kernel_fn)
        plain = time_ms(torch, plain_fn)
        if lib_fn is not None:
            lib = time_ms(torch, lib_fn)
            if name == "flash_bwd_dq":
                sdpa_bwd_ms = lib
        else:
            lib = sdpa_bwd_ms
        t_bytes = 1e3 * nbytes[name] / mem_bw
        t_ops = 1e3 * flops[name] / BF16_FLOPS
        rows[name] = {
            "ms": ms, "plain_ms": plain, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib,
            "tflops": flops[name] / ms / 1e9,
            "library_share_ms": lib * share[name],
            "library_call": ("scaled_dot_product_attention(is_causal=True"
                             + (", enable_gqa=True" if gqa else "") + ") "
                             + ("forward" if name == "flash_forward" else
                                "backward, dQ dK dV together")),
            "shape": {"B": B, "T": T, "H": H, "Hk": Hk, "D": D,
                      "dtype": "bfloat16", "causal": True,
                      "live_pairs": pairs, "flops": flops[name],
                      "bytes": nbytes[name]}}
    return rows


def ctr_ids(torch, gen, dev, cfg: dict, mix: dict):
    """[batch, fields] ids as the CTR cell's traffic draws them
    (``benchmark/traffic.py``): field f's Zipf rank among its ids, by the
    inverse transform of the envelope x^-s on [1, count + 1), plus the ids
    of the fields before it."""
    counts = torch.tensor(cfg["field_ids"], dtype=torch.float64, device=dev)
    offsets = torch.cumsum(counts, 0).to(torch.int64) - counts.to(torch.int64)
    u = torch.rand((mix["batch"], counts.numel()), generator=gen, device=dev,
                   dtype=torch.float64)
    a = 1.0 - mix["zipf_exponent"]
    x = torch.pow(1.0 + u * (torch.pow(counts + 1.0, a) - 1.0), 1.0 / a)
    ranks = torch.minimum(x.floor().to(torch.int64) - 1,
                          counts.to(torch.int64) - 1).clamp(min=0)
    return ranks + offsets


def row_adagrad_phase(torch, dev, mem_bw) -> dict:
    """Phase 33: the row Adagrad kernel at the CTR cell's emb push. Its
    kernel row for the JSON result, launches by path included."""
    from minips_tpu_torch.apps.lrmlp import build_lrmlp
    from minips_tpu_torch.ops import sparse_update as su
    from minips_tpu_torch.tables.sparse import hash_to_slots

    with open(CTR_CONFIG) as f:
        cfg = json.load(f)
    with open(CTR_TRAFFIC) as f:
        mix = json.load(f)
    S, D = cfg["num_slots"], cfg["emb_dim"]
    lr, eps = cfg["table_updater"]["lr"], cfg["table_updater"]["eps"]
    gen = torch.Generator(dev).manual_seed(21)
    slots = hash_to_slots(ctr_ids(torch, gen, dev, cfg, mix), S,
                          cfg["salts"]["emb"]).reshape(-1)
    n = slots.numel()
    grads = torch.randn((n, D), generator=gen, device=dev)
    emb = 0.01 * torch.randn((S, D), generator=gen, device=dev)
    accum = torch.full((S, D), 0.1, device=dev)
    ref = emb.clone(), accum.clone()
    # the dedup's segment sum in a fixed order, so that both sides sum each
    # row's gradient alike; the row update itself has no atomics left
    before = su.row_adagrad_apply.launches
    torch.use_deterministic_algorithms(True)
    try:
        for _ in range(2):
            su.row_adagrad(emb, accum, slots, grads, lr, eps)
            su._row_adagrad_sorted_reference(*ref, slots, grads, lr, eps)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    launches = su.row_adagrad_apply.launches - before
    check(launches == 2, f"row_adagrad launched {launches} times in 2 pushes")
    check(torch.equal(emb, ref[0]) and torch.equal(accum, ref[1]),
          "row_adagrad: emb or accum differs from the plain version's bits")
    del ref

    rep, g_sum, _, k_dev = su._dedup_segment_sum(slots, grads)
    k = int(k_dev)
    g2 = g_sum * g_sum
    step = -lr * g_sum / ((accum[rep] + g2).sqrt() + eps)
    nbytes = k * (slots.element_size() + 5 * 4 * D)
    flush = torch.empty(GATHER_COLD_FLUSH_BYTES, dtype=torch.uint8,
                        device=dev)

    def kernel():
        su.row_adagrad_apply(emb, accum, rep, g_sum, k_dev, lr, eps)

    def plain():  # _row_adagrad_sorted_reference after its dedup
        acc_rows = accum[rep] + g_sum * g_sum
        accum.index_add_(0, rep, g_sum * g_sum)
        emb.index_add_(0, rep, -lr * g_sum / (acc_rows.sqrt() + eps))

    def library():  # the plain version's two row scatters alone
        accum.index_add_(0, rep, g2)
        emb.index_add_(0, rep, step)

    row = {
        "name": "row_adagrad", "route": "cuda",
        "source": "minips_tpu_torch/csrc/row_adagrad.cu",
        "replaces": "none: the JAX package leaves this update to XLA's "
                    "scatter",
        "launches": launches, "max_abs_err": 0.0, "N": n, "S": S, "D": D,
        "distinct_rows": k, "bytes": nbytes,
        "ms": time_ms(torch, kernel),
        "cold_ms": time_ms(torch, kernel, flush.zero_),
        "plain_ms": time_ms(torch, plain),
        "plain_cold_ms": time_ms(torch, plain, flush.zero_),
        "library_ms": time_ms(torch, library),
        "push_ms": time_ms(torch, lambda: su.row_adagrad(
            emb, accum, slots, grads, lr, eps)),
        "plain_push_ms": time_ms(torch, lambda: (
            su._row_adagrad_sorted_reference(emb, accum, slots, grads,
                                             lr, eps))),
        "bound_ms": 1e3 * nbytes / mem_bw, "bound_by": "bytes",
        "design": DESIGN["row_adagrad"],
    }
    row["bound_share_cold"] = row["bound_ms"] / row["cold_ms"]
    del emb, accum, slots, grads, rep, g_sum, g2, step, flush

    # the CTR cell's own path: the pair at its batch and table size, whose
    # MLP step pushes emb (sort-dedup) and LR step wide (dense-accumulate)
    pair = build_lrmlp(mix["batch"], dev, seed=0, num_slots=S)
    before = su.row_adagrad_apply.launches
    losses = [float(x) for pair_l in run_pair_steps(pair, 2)
              for x in pair_l]
    torch.cuda.synchronize()
    ctr = su.row_adagrad_apply.launches - before
    check(all(math.isfinite(x) for x in losses), f"CTR losses {losses}")
    check(ctr == 2, f"row_adagrad launched {ctr} times in 2 CTR steps")
    row["launches_by_path"] = {"ctr_push_x2": launches, "ctr_pair_steps_x2":
                               ctr}
    del pair
    torch.cuda.empty_cache()
    return row


def adam_apply_phase(torch, dev, mem_bw, lm_launches: int) -> dict:
    """Phase 34: the Adam kernel (``csrc/adam_apply.cu``) at the LM cells'
    table sizes, against its plain version, ``adam``'s ``update_`` then
    ``params.add_``. Its kernel row for the JSON result; ``lm_launches``,
    the launches of phase 8's LM steps, is the row's ``launches``."""
    from minips_tpu_torch.ops import adam_apply as aa
    from minips_tpu_torch.tables.updaters import _adam_count, make_updater

    lr = 1e-3
    tx = make_updater("adam", lr)
    gen = torch.Generator(dev).manual_seed(34)
    before = aa.adam_apply.launches

    def state(n, off=0):
        """g, params, mu, nu and the count as after some steps, each a view
        ``off`` floats into its own buffer."""
        out = [torch.randn(n + off, generator=gen, device=dev)[off:]
               for _ in range(3)]
        out.append(torch.rand(n + off, generator=gen, device=dev)[off:])
        g, p, m, v = out
        m.mul_(1e-2)
        v.mul_(1e-4)
        return g, p, [torch.tensor(9, dtype=torch.int32, device=dev), m, v]

    # bitwise: three steps on a slice, kernel against the plain version
    g, p, st = state(ADAM_SLICE, off=1)
    ref_p, ref_st = p.clone(), [x.clone() for x in st]
    for i in range(3):
        gi = g * (i + 1)
        p, st = tx.apply_(gi, st, p)
        updates, ref_st = tx.update_(gi.clone(), ref_st, ref_p)
        ref_p.add_(updates)
    torch.cuda.synchronize()
    check(aa.adam_apply.launches - before == 3, "adam_apply launched "
          f"{aa.adam_apply.launches - before} times in 3 steps")
    check(torch.equal(p, ref_p) and all(torch.equal(a, b)
                                        for a, b in zip(st, ref_st)),
          "adam_apply: params or moments differ from the plain update's "
          "bits")
    del g, p, st, ref_p, ref_st, updates, gi
    torch.cuda.empty_cache()

    row = {"name": "adam_apply", "route": "cuda",
           "source": "minips_tpu_torch/csrc/adam_apply.cu",
           "replaces": "none: the JAX package leaves Adam to XLA's fusion",
           "max_abs_err": 0.0, "bitwise_slice": ADAM_SLICE,
           "bound_by": "bytes", "design": DESIGN["adam_apply"], "sizes": {}}
    for name, n in ADAM_SIZES.items():
        g, p, st = state(n)
        # bitwise at full size: one kernel step over the whole vectors,
        # the plain version on copies of slices of the same inputs
        mid = (1 << 31) if n > (1 << 31) else n // 2
        starts = [0, mid - ADAM_PART // 2, n - ADAM_PART]
        parts = [[x[lo:lo + ADAM_PART].clone() for x in (g, p, st[1], st[2])]
                 for lo in starts]
        count0 = st[0].clone()
        p, st = tx.apply_(g, st, p)
        for lo, (gs, ps, ms, vs) in zip(starts, parts):
            updates, ref = tx.update_(gs, [count0.clone(), ms, vs], ps)
            ps.add_(updates)
            hi = lo + ADAM_PART
            check(torch.equal(p[lo:hi], ps) and torch.equal(st[1][lo:hi], ms)
                  and torch.equal(st[2][lo:hi], vs)
                  and torch.equal(st[0], ref[0]),
                  f"adam_apply at {name}: elements [{lo}, {hi}) differ from "
                  "the plain update's bits")
        del parts, gs, ps, ms, vs, updates, ref
        _, m, v = st
        _, bc1, bc2 = _adam_count(st[0], 0.9, 0.999, torch.float32)

        def kernel():
            aa.adam_apply(g, p, m, v, bc1, bc2, b1=0.9, b2=0.999, eps=1e-8,
                          lr=lr)

        def plain():  # the donated plain update: g is written over
            updates, _ = tx.update_(g, st, p)
            p.add_(updates)

        nbytes = ADAM_BYTES_PER_PARAM * n
        size = {"n": n, "bitwise_parts": [[lo, lo + ADAM_PART]
                                          for lo in starts],
                "bytes": nbytes, "ms": time_ms(torch, kernel),
                "bound_ms": 1e3 * nbytes / mem_bw}
        size["bound_share"] = size["bound_ms"] / size["ms"]
        # the plain update holds two more table-sized vectors
        if torch.cuda.mem_get_info()[0] > 2.2 * 4 * n:
            size["plain_ms"] = time_ms(torch, plain)
        else:
            size["plain_ms"] = "not measured: no room for its temporaries"
        row["sizes"][name] = size
        del g, p, st, m, v, bc1, bc2
        torch.cuda.empty_cache()
    row["launches"] = lm_launches
    row["launches_by_path"] = {
        "lm_steps_phase8": lm_launches, "phase34_bitwise_slice_x3": 3,
        "phase34_bitwise_full_size": len(ADAM_SIZES),
        "phase34_timed": aa.adam_apply.launches - before - 3
        - len(ADAM_SIZES)}
    for name, size in row["sizes"].items():
        check(size["bound_share"] <= 1.05, f"adam_apply at {name}: "
              f"{size['bound_share']:.3f} of the byte bound")
    return row


def update_peak_gb(torch, table) -> float:
    """Device memory that one optimizer update of the whole table takes
    above what was allocated before it: the update alone, outside the
    step, on a gradient of the table's size."""
    g = torch.full_like(table.params, 1e-3)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = table.tx.update(g, table.opt_state, table.params)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out, g
    return peak / 1e9


def device_time(torch, run, steps: int, step_ms: float) -> dict:
    """Where a step's device time goes: kernel intervals from the profiler
    over ``run()`` (``steps`` steps), beside the unprofiled step time (the
    profiler slows the host)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return device_breakdown(torch, prof, steps, step_ms)


def device_breakdown(torch, prof, steps: int, step_ms: float) -> dict:
    """``device_time``'s breakdown of a finished profile ``prof`` of
    ``steps`` steps: the CUDA intervals of its kernels, copies and fills
    by name. The program's spans come back on the device too, as user
    annotations that hold those kernels; like torch's own tables, it
    leaves them out."""
    by_name: dict = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not e.is_user_annotation):
            ms, calls = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3,
                               calls + 1)
    busy = sum(ms for ms, _ in by_name.values()) / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    # K1's own kernels, not PyTorch's index gathers or NCCL's all_gather
    gather_ms = sum(ms for n, (ms, _) in by_name.items()
                    if re.search(r"\bgather_(narrow|rows)_kernel\b", n))
    return {
        "device_busy_ms": busy if by_name else "not measured",
        "gather_rows_ms": gather_ms / steps if by_name else "not measured",
        "device_idle_share": (1 - busy / step_ms) if by_name
        else "not measured",
        "device_ops": sum(c for _, c in by_name.values()) / steps,
        "top": [{"name": n[:80], "ms": ms / steps, "calls": c / steps}
                for n, (ms, c) in top]}


def run_pair_steps(pair, steps):
    """``steps`` steps of both models of an LR + MLP pair on its two
    batches in turn; the losses as device scalars."""
    return [(pair.lr_step(pair.batches[i % 2]),
             pair.mlp_step(pair.batches[i % 2])) for i in range(steps)]


def run_lm_steps(model, steps):
    return [model.table.step_inplace(model.step, model.batches[i % 2])
            for i in range(steps)]


def grad_peak_gb(torch, lm) -> float:
    """Device memory that one forward and backward of the LM step's
    ``grad_fn`` takes above what was allocated before it, on the step's
    bf16 copy of the params and one batch: what the remat mode keeps for
    the backward, its recompute's transients and the gradients, without
    the update (which sets the whole step's peak in every mode but remat
    off)."""
    from minips_tpu_torch.tables.dense import cast_floating

    params = cast_floating(lm.table.pull(), torch.bfloat16)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = lm.grad_fn(params, lm.batches[0])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out, params
    return peak / 1e9

def want_launches(remat, depth: int, steps: int) -> dict:
    """K2, K3 and K4 launches in ``steps`` training steps of ``depth``
    blocks under a remat mode (``FLASH_LAUNCHES_PER_BLOCK``: the JAX
    package's count, K2 once more under any remat)."""
    from minips_tpu_torch.models.transformer import FLASH_LAUNCHES_PER_BLOCK

    return {name: n * depth * steps
            for name, n in FLASH_LAUNCHES_PER_BLOCK[remat].items()}


def state_bits(state) -> list:
    """A table state (``interop``'s numpy layout) as a flat list of bit
    patterns, for a comparison that tells -0.0 from 0.0."""
    import numpy as np

    if isinstance(state, dict):
        leaves = [state[k] for k in sorted(state)]
    else:
        leaves = [state[0], *state[1]]
    return [np.ascontiguousarray(x).view(np.uint8) for x in leaves]


def chain_seconds(torch, run) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def group_phases(group, dev, cfg) -> dict:
    """Phases 15 and 16, on the one rank of a process group of world size
    1 (NCCL on the card): the LR + MLP pair and the LM through the group.
    ``cfg`` holds the sizes (the card's full widths when run by ``main``).
    Returns the numbers for the parent to print; raises on a failed check.
    """
    import numpy as np
    import torch

    from minips_tpu_torch import interop
    from minips_tpu_torch.apps.lm import build_lm
    from minips_tpu_torch.apps.lrmlp import build_lrmlp
    from minips_tpu_torch.ops import flash_attention as tfa
    from minips_tpu_torch.ops.gather import gather_rows
    from minips_tpu_torch.ops.quantized_comm import _quantize_blocks

    card = cfg["card"]
    out = {}
    # --------------------------- 15. the LR + MLP pair through the group
    b, chain = cfg["batch"], cfg["chain"]
    alone = build_lrmlp(b, dev, seed=0)
    grouped = build_lrmlp(b, dev, seed=0, group=group)
    names = ("wide", "emb", "lin", "deep")

    def states(pair):
        return {k: state_bits(interop.sparse_to_numpy(getattr(pair, k))
                              if k in ("wide", "emb") else
                              interop.dense_to_numpy(getattr(pair, k)))
                for k in names}

    def same(a, b):
        return all(len(a[k]) == len(b[k]) and all(
            np.array_equal(x, y) for x, y in zip(a[k], b[k])) for k in names)

    check(same(states(alone), states(grouped)),
          "group pair: initial tables differ from the group=None pair's")
    # index_add_ sums duplicate slots with atomics in no fixed order on the
    # card: the bit-for-bit comparison runs both pairs in PyTorch's
    # deterministic mode (a sorted accumulation; the gather kernel is
    # deterministic as it is)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        losses_alone = [(float(x), float(y))
                        for x, y in run_pair_steps(alone, chain)]
        torch.cuda.synchronize()
        gather_rows.launches = 0
        losses_group = [(float(x), float(y))
                        for x, y in run_pair_steps(grouped, chain)]
        torch.cuda.synchronize()
        k1 = gather_rows.launches
    finally:
        torch.use_deterministic_algorithms(False)
    check(k1 == 2 * chain, f"group pair: gather_rows launched {k1} times "
          f"in {chain} steps, expected {2 * chain}")
    check(losses_group[:CPU_STEPS] == losses_alone[:CPU_STEPS],
          f"group pair: first {CPU_STEPS} losses {losses_group[:CPU_STEPS]} "
          f"differ from group=None's {losses_alone[:CPU_STEPS]}")
    check(all(math.isfinite(x) for p in losses_group for x in p)
          and losses_group[-1][0] < losses_group[0][0]
          and losses_group[-1][1] < losses_group[0][1],
          f"group pair: loss did not fall: {losses_group}")
    check(same(states(alone), states(grouped)),
          f"group pair: tables after {chain} steps differ from group=None's")
    # step time of both, in turns (alone, group, group, alone, ...)
    times = {"group_none": [], "group_ws1": []}
    for rep_ in range(cfg["reps"]):
        order = (("group_none", alone), ("group_ws1", grouped))
        for key, pair in (order if rep_ % 2 == 0 else order[::-1]):
            times[key].append(chain_seconds(
                torch, lambda: run_pair_steps(pair, chain)))
    med = {k: statistics.median(v) for k, v in times.items()}
    out["pair"] = {
        "card": card, "batch": b, "chain": chain, "reps": cfg["reps"],
        "gather_launches": k1, "gathers_per_step": k1 / chain,
        "losses_bit_identical": True, "tables_bit_identical": True,
        "loss_first": losses_group[0], "loss_last": losses_group[-1],
        "step_ms": {k: 1e3 * v / chain for k, v in med.items()},
        "samples_per_s": {k: b * chain / v for k, v in med.items()},
        "collective_ms_per_step": 1e3 * (med["group_ws1"]
                                         - med["group_none"]) / chain,
        "chain_s": times,
        # where the difference goes: device busy time against host time
        "device": {key: device_time(
            torch, lambda: run_pair_steps(pair, PROFILED_STEPS),
            PROFILED_STEPS, 1e3 * med[key] / chain)
            for key, pair in (("group_none", alone), ("group_ws1", grouped))}}
    print("group pair: " + json.dumps(out["pair"]), flush=True)
    del alone, grouped

    # ------------------ 16. the LM through the group at comm bf16 and int8
    flash = ("flash_forward", "flash_bwd_dq", "flash_bwd_dkv")
    lm_cfg = dict(dim=cfg["lm_dim"], depth=cfg["lm_depth"], device=dev,
                  seed=0)
    out["lm"] = {}
    for comm in GROUP_COMMS:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        lm = build_lm(cfg["lm_b"], cfg["lm_t"], comm=comm, group=group,
                      **lm_cfg)
        codes = None
        if comm == "int8":
            # the first pull's codes and scales: the card's against the CPU
            # port's _quantize_blocks on the same params
            q, sc = _quantize_blocks(lm.table.params)
            q_h, sc_h = _quantize_blocks(lm.table.params.cpu())
            check(torch.equal(q.cpu(), q_h) and torch.equal(
                sc.cpu().view(torch.int32), sc_h.view(torch.int32)),
                "int8 comm: the card's block codes or scales differ from "
                "the CPU port's")
            codes = {"elements": lm.table.params.numel(),
                     "blocks": int(sc.numel()), "bit_identical": True}
            del q, sc, q_h, sc_h
        torch.cuda.synchronize()
        for name in flash:
            getattr(tfa, name).launches = 0
        losses = [float(x) for x in run_lm_steps(lm, cfg["lm_chain"])]
        torch.cuda.synchronize()
        launches = {name: getattr(tfa, name).launches for name in flash}
        check(all(math.isfinite(x) for x in losses)
              and losses[-1] < losses[0],
              f"LM at comm {comm}: losses {losses}")
        want = want_launches(lm.remat, cfg["lm_depth"], cfg["lm_chain"])
        check(launches == want, f"LM at comm {comm}: flash launches "
              f"{launches}, expected {want}")
        chains = [chain_seconds(torch, lambda: run_lm_steps(
            lm, cfg["lm_chain"])) for _ in range(cfg["lm_reps"])]
        med = statistics.median(chains)
        out["lm"][comm] = {
            "card": card, "comm": comm, "batch": cfg["lm_b"],
            "seq": cfg["lm_t"], "chain": cfg["lm_chain"],
            "reps": cfg["lm_reps"],
            "step_ms": 1e3 * med / cfg["lm_chain"],
            "tokens_per_s": cfg["lm_b"] * cfg["lm_t"] * cfg["lm_chain"] / med,
            "chain_s": chains,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "losses": losses, "launches": launches, "first_pull": codes}
        del lm

        small = dict(dim=cfg["small_dim"], depth=2, vocab=1024, seed=0,
                     comm=comm)
        card_lm = build_lm(2, cfg["small_t"], device=dev, group=group,
                           **small)
        state = interop.dense_to_numpy(card_lm.table)
        card_l = [float(x) for x in run_lm_steps(card_lm, CPU_STEPS)]
        cpu_lm = build_lm(2, cfg["small_t"], device="cpu", **small)
        interop.load_dense(cpu_lm.table, *state)
        cpu_l = [float(x) for x in run_lm_steps(cpu_lm, CPU_STEPS)]
        diff = max(abs(a - b) for a, b in zip(card_l, cpu_l))
        check(diff <= COMM_LM_LOSS_TOL, f"small LM at comm {comm}: card "
              f"(group) and CPU (group=None) losses differ by {diff} > "
              f"{COMM_LM_LOSS_TOL}: card {card_l} cpu {cpu_l}")
        out["lm"][comm]["small_lm"] = {"card": card_l, "cpu": cpu_l,
                                       "max_abs_diff": diff,
                                       "tolerance": COMM_LM_LOSS_TOL}
        print(f"LM through the group at comm {comm}: "
              + json.dumps(out["lm"][comm]), flush=True)
        del card_lm, cpu_lm
    return out


def decode_phase(torch, dev, card, lm, mem_bw) -> dict:
    """Phase 19: ``decode.generate`` on the trained full-width LM (B =
    DEC_B, a DEC_PROMPT-token prompt of its batch, DEC_NEW new tokens, bf16
    compute and cache), and on a GQA model of the same width (random
    weights) for its cache; the bound is the bf16 weights plus the live
    cache per step over the memory rate; then greedy decoding on a small
    model at f32 against the argmax of ``transformer.apply`` on the growing
    sequence."""
    from minips_tpu_torch.models import decode as tdec
    from minips_tpu_torch.models import transformer as tfm

    trained = lm.table.pull()
    heads = lm.heads
    prompt = lm.batches[0]["tokens"][:DEC_B, :DEC_PROMPT]

    def cache_bytes(params):
        return sum(t.numel() * t.element_size()
                   for c in tdec.init_cache(params, DEC_B,
                                            DEC_PROMPT + DEC_NEW,
                                            heads=heads)
                   for t in c.values())

    def run(params, steps):
        return tdec.generate(params, prompt, steps, heads=heads)

    out = {"card": card, "batch": DEC_B, "prompt": DEC_PROMPT,
           "new_tokens": DEC_NEW, "compute": "bfloat16",
           "cache": "bfloat16"}
    run(trained, 4)  # warm-up
    prefill_s = statistics.median(
        chain_seconds(torch, lambda: run(trained, 1)) for _ in range(3))
    toks = []
    total_s = chain_seconds(torch, lambda: toks.append(run(trained, DEC_NEW)))
    toks = toks[0]
    check(tuple(toks.shape) == (DEC_B, DEC_NEW) and int(toks.min()) >= 0
          and int(toks.max()) < trained["tok_emb"].shape[0],
          f"decode: tokens of shape {tuple(toks.shape)} out of range")
    blocks = trained["blocks"]
    w_bytes = 2 * (sum(blk[k].numel() for blk in blocks
                       for k in ("qkv", "proj", "mlp_in", "mlp_out"))
                   + trained["tok_emb"].numel())
    hd = LM_DIM // heads
    live = [2 * 2 * DEC_B * (DEC_PROMPT + i + 1) * heads * hd * len(blocks)
            for i in range(DEC_NEW - 1)]
    bound_ms = 1e3 * (w_bytes + sum(live) / len(live)) / mem_bw
    step_ms = 1e3 * (total_s - prefill_s) / (DEC_NEW - 1)
    out.update({
        "prefill_ms": 1e3 * prefill_s, "ms_per_token": step_ms,
        "tokens_per_s": DEC_B * DEC_NEW / total_s, "total_ms": 1e3 * total_s,
        "cache_bytes": cache_bytes(trained),
        "bound_ms_per_token": bound_ms, "bound_bytes": {
            "bf16_weights": w_bytes, "live_cache_mean": sum(live) / len(live)},
        # the idle share over a shorter run: the profiler records every
        # one of the decode's ~100 K small kernels
        "device": {"new_tokens": DEC_PROFILED, **device_time(
            torch, lambda: run(trained, DEC_PROFILED), 1,
            1e3 * chain_seconds(torch, lambda: run(trained, DEC_PROFILED)))}})
    gen = torch.Generator(device=dev).manual_seed(5)
    gqa = tfm.init(gen, vocab=trained["tok_emb"].shape[0], dim=LM_DIM,
                   heads=heads, depth=len(blocks), max_len=LM_T,
                   kv_heads=DEC_GQA_KV, device=dev)
    out["gqa_cache_bytes"] = cache_bytes(gqa)
    check(out["cache_bytes"] == out["gqa_cache_bytes"] * heads // DEC_GQA_KV,
          f"GQA cache {out['gqa_cache_bytes']} is not the MHA cache "
          f"{out['cache_bytes']} over {heads // DEC_GQA_KV}")
    run(gqa, 4)
    gqa_s = chain_seconds(torch, lambda: run(gqa, DEC_NEW))
    out["gqa_tokens_per_s"] = DEC_B * DEC_NEW / gqa_s
    del gqa, trained

    small = tfm.init(torch.Generator(device=dev).manual_seed(6), vocab=1024,
                     dim=256, heads=4, depth=2, max_len=64, device=dev)
    seq = torch.randint(0, 1024, (2, 8), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(7))
    got = tdec.generate(small, seq, DEC_ORACLE_STEPS, heads=4,
                        compute_dtype=torch.float32,
                        cache_dtype=torch.float32)
    for i in range(DEC_ORACLE_STEPS):
        with torch.no_grad():
            logits = tfm.apply(small, seq, heads=4,
                               compute_dtype=torch.float32)
        tok = torch.argmax(logits[:, -1], dim=-1)
        check(torch.equal(tok, got[:, i]), f"greedy decode step {i} "
              "differs from the argmax of apply on the growing sequence")
        seq = torch.cat([seq, tok[:, None]], dim=1)
    out["oracle"] = {"steps": DEC_ORACLE_STEPS, "equal": True,
                     "model": "dim 256, depth 2, 4 heads, vocab 1024, f32"}
    return out


def remat_phase(torch, dev, card, tfa) -> dict:
    """Phase 17: ``build_lm`` at full width under every remat mode,
    REMAT_STEPS steps each: launches, step time (the median of LM_REPS
    chains of REMAT_STEPS), tokens/s and peak memory;
    the first 3 losses against remat off's on the card, and a small LM's
    card against the CPU port's. Returns each mode's launches."""
    from minips_tpu_torch import interop
    from minips_tpu_torch.apps.lm import build_lm

    flash = ("flash_forward", "flash_bwd_dq", "flash_bwd_dkv")
    paths, rows, base = {}, {}, None
    for mode in REMAT_MODES:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        lm = build_lm(LM_B, LM_T, dim=LM_DIM, depth=LM_DEPTH, device=dev,
                      seed=0, remat=mode)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for name in flash:
            getattr(tfa, name).launches = 0
        losses = [float(x) for x in run_lm_steps(lm, REMAT_STEPS)]
        torch.cuda.synchronize()
        launches = {name: getattr(tfa, name).launches for name in flash}
        peak = torch.cuda.max_memory_allocated() / 1e9
        want = want_launches(mode, LM_DEPTH, REMAT_STEPS)
        check(launches == want, f"remat {mode!r}: flash launches "
              f"{launches}, expected {want}")
        check(all(math.isfinite(x) for x in losses)
              and losses[-1] < losses[0], f"remat {mode!r}: losses {losses}")
        base = losses if base is None else base
        diff = max(abs(a - b) for a, b in zip(losses[:3], base[:3]))
        check(diff <= REMAT_LOSS_TOL, f"remat {mode!r}: first losses "
              f"{losses[:3]} differ from remat off's {base[:3]} by {diff}")
        chains = [chain_seconds(torch, lambda: run_lm_steps(lm, REMAT_STEPS))
                  for _ in range(LM_REPS)]
        chain = statistics.median(chains)
        paths[str(mode)] = launches
        rows[str(mode)] = {
            "card": card, "remat": mode, "steps": REMAT_STEPS,
            "reps": LM_REPS, "chain_s": chains,
            "step_ms": 1e3 * chain / REMAT_STEPS,
            "tokens_per_s": LM_B * LM_T * REMAT_STEPS / chain,
            "peak_mem_gb": peak, "grad_peak_gb": grad_peak_gb(torch, lm),
            "launches_per_step": {n: v / REMAT_STEPS
                                  for n, v in launches.items()},
            "first_losses": losses[:3], "max_abs_diff_vs_off": diff}
        print(f"remat {mode!r} at full width: " + json.dumps(rows[str(mode)]),
              flush=True)
        del lm
    small = dict(dim=256, depth=2, vocab=1024, seed=0)
    for mode in REMAT_MODES:
        card_lm = build_lm(2, 256, device=dev, remat=mode, **small)
        state = interop.dense_to_numpy(card_lm.table)
        card_l = [float(x) for x in run_lm_steps(card_lm, CPU_STEPS)]
        cpu_lm = build_lm(2, 256, device="cpu", remat=mode, **small)
        interop.load_dense(cpu_lm.table, *state)
        cpu_l = [float(x) for x in run_lm_steps(cpu_lm, CPU_STEPS)]
        diff = max(abs(a - b) for a, b in zip(card_l, cpu_l))
        check(diff <= LM_LOSS_TOL, f"small LM at remat {mode!r}: card "
              f"{card_l} and CPU {cpu_l} differ by {diff}")
        rows[str(mode)]["small_lm_card_vs_cpu"] = diff
        del card_lm, cpu_lm
    print("remat spectrum (phase 17), by mode [step peak GB, forward and "
          "backward's own GB, step ms, small LM card vs CPU]: "
          + json.dumps({m: [r["peak_mem_gb"], r["grad_peak_gb"],
                            r["step_ms"], r.get("small_lm_card_vs_cpu")]
                        for m, r in rows.items()}), flush=True)
    return paths


def lm_example_phase(torch, dev, card, tfa, mem_bw, ptxas_by_kernel):
    """Phase 18: ``apps/lm_example.py``'s ``run`` at full width in each of
    APP_LM_CONFIGS (finite and falling loss, launches, tokens/s, peak
    memory); K2-K4 timed at the GQA and D = 128 shapes with K4's registers
    and spills at D = 128; dropout's gradients at "dots" against remat
    off; a small ``--generate`` run on the card against the CPU port's
    decoding from the same weights. Returns (each configuration's
    launches, each kernel's timed shapes)."""
    import argparse

    from minips_tpu_torch.apps import lm_example as lmx
    from minips_tpu_torch.core import config as tcfg
    from minips_tpu_torch.models import decode as tdec
    from minips_tpu_torch.models import transformer as tfm
    from minips_tpu_torch.utils.metrics import MetricsLogger
    from minips_tpu_torch.utils.tree import tree_leaves, tree_map

    flash = ("flash_forward", "flash_bwd_dq", "flash_bwd_dkv")

    def app_run(iters, updater="adam", **flags):
        cfg = tcfg.Config(
            table=tcfg.TableConfig(name="lm", kind="dense", updater=updater,
                                   lr=APP_LM_LR),
            train=tcfg.TrainConfig(batch_size=LM_B, num_iters=iters,
                                   log_every=0, seed=0))
        return cfg, lmx.run(cfg, argparse.Namespace(device=dev, **flags),
                            MetricsLogger(None, verbose=False))

    paths = {}
    for name, extra in APP_LM_CONFIGS.items():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for k in flash:
            getattr(tfa, k).launches = 0
        updater = "adamw" if extra.get("dropout") else "adam"
        _, out = app_run(APP_LM_ITERS, updater, **{**APP_LM_FLAGS, **extra})
        torch.cuda.synchronize()
        launches = {k: getattr(tfa, k).launches for k in flash}
        losses = out["losses"]
        want = want_launches("dots", LM_DEPTH, APP_LM_ITERS)
        check(launches == want, f"lm_example {name}: flash launches "
              f"{launches}, expected {want}")
        # falling: the mean of the last quarter of the run below the first
        # quarter's (each step draws another batch of the stream)
        w = max(1, APP_LM_ITERS // 4)
        check(len(losses) == APP_LM_ITERS
              and all(math.isfinite(x) for x in losses)
              and sum(losses[-w:]) < sum(losses[:w]),
              f"lm_example {name}: losses {losses}")
        paths[name] = launches
        print(f"lm_example {name} at full width: " + json.dumps({
            "card": card, "flags": {**APP_LM_FLAGS, **extra},
            "updater": updater, "lr": APP_LM_LR, "iters": APP_LM_ITERS,
            "tokens_per_s": out["samples_per_sec"] * LM_T,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "params": out["table"].num_keys, "launches": launches,
            "loss_first_last": [losses[0], losses[-1]]}), flush=True)
        del out

    shapes = {k: [] for k in flash}
    for label, H, Hk, D in (("gqa_kv8", 32, 8, 64), ("hd128", 16, 16, 128)):
        for k, row in flash_timings(torch, tfa, LM_B, LM_T, H, Hk, D,
                                    mem_bw).items():
            row = {"config": label, "card": card, **row}
            if k == "flash_bwd_dkv" and D == 128:
                row["ptxas"] = ptxas_by_kernel.get(
                    "flash_bwd_dkv_wgmma_kernel<bf16,128>",
                    "not measured (the library was cached)")
            shapes[k].append(row)
            print(f"{k} at the {label} shape: " + json.dumps(row),
                  flush=True)

    # dropout under remat: the gradients at "dots" against remat off on one
    # full-width batch with the same key
    gen = torch.Generator(device=dev).manual_seed(3)
    params = tfm.init(gen, vocab=256, dim=LM_DIM, heads=32, depth=LM_DEPTH,
                      max_len=LM_T, device=dev)
    batch = {"tokens": torch.randint(0, 256, (LM_B, LM_T + 1), device=dev,
                                     generator=gen),
             "rng": torch.tensor([tfm.fold_in(tfm.prng_key(71), 0)])}
    kw = dict(heads=32, attn_impl="flash", head_chunk=128, dropout=0.1)
    l_off, g_off = tfm.grad_fn(params, batch, remat=False, **kw)
    l_dots, g_dots = tfm.grad_fn(params, batch, remat="dots", **kw)
    pairs = list(zip(tree_leaves(g_off), tree_leaves(g_dots)))
    err = max(float((b - a).abs().max()) for a, b in pairs)
    top = max(float(a.abs().max()) for a, _ in pairs)
    check(math.isfinite(float(l_off)) and err <= DROPOUT_REMAT_TOL * top,
          f"dropout under remat: gradients at dots differ from remat off "
          f"by {err} (largest {top})")
    print("dropout 0.1 under remat, full width, one batch: " + json.dumps({
        "card": card, "loss_off": float(l_off), "loss_dots": float(l_dots),
        "max_abs_grad_diff": err, "max_abs_grad": top,
        "bit_identical": all(torch.equal(a, b) for a, b in pairs)}),
        flush=True)
    del params, g_off, g_dots, pairs

    # a small --generate run on the card, at the app's defaults (f32), and
    # the CPU port's greedy decoding from the trained weights
    cfg, out = app_run(5, generate=APP_GEN_TOKENS)
    seq_len = 128
    prompt = torch.as_tensor(lmx._load_data(
        cfg, argparse.Namespace(), seq_len)["tokens"][:1, :8]).long()
    cpu_params = tree_map(lambda x: x.cpu(), out["table"].pull())
    cpu_toks = tdec.generate(cpu_params, prompt, APP_GEN_TOKENS,
                             heads=lmx.MODEL["heads"],
                             compute_dtype=torch.float32,
                             cache_dtype=torch.float32)[0].tolist()
    check(cpu_toks == out["generated"], f"--generate: card tokens "
          f"{out['generated']} differ from the CPU port's {cpu_toks}")
    print(f"lm_example --generate {APP_GEN_TOKENS} (card, f32) equals the "
          f"CPU port's greedy tokens from the same weights: "
          f"{out['generated']}", flush=True)
    return paths, shapes


def moe_phase(torch, dev, card) -> None:
    """Phase 20: ``init_moe_lm`` and ``apply_moe_dense`` at full width
    (k_top 1 and 2, capacity twice the even share): finite forward and
    backward, their time, the tokens dropped; a binding capacity drops
    tokens; a small MoE LM's logits and aux against the CPU port's."""
    from minips_tpu_torch.models import transformer as tfm
    from minips_tpu_torch.parallel import moe as tmoe
    from minips_tpu_torch.utils.tree import tree_leaves, tree_map
    from minips_tpu_torch.utils.tree import value_and_grad

    gen = torch.Generator(device=dev).manual_seed(8)
    params = tfm.init_moe_lm(gen, dim=LM_DIM, heads=LM_DIM // 64,
                             depth=LM_DEPTH, num_experts=MOE_EXPERTS,
                             expert_hidden=MOE_HIDDEN, device=dev)
    vocab = params["tok_emb"].shape[0]
    toks = torch.randint(0, vocab, (MOE_B, LM_T + 1), device=dev,
                         generator=gen)
    n = MOE_B * LM_T
    x = torch.randn((n, LM_DIM), device=dev, generator=gen)
    router = params["blocks"][0]["moe"]["router"]
    rows = {}
    for k_top in (1, 2):
        cap = 2 * k_top * n // MOE_EXPERTS

        def loss(p):
            logits, aux = tfm.apply_moe_dense(p, toks[:, :-1],
                                              heads=LM_DIM // 64,
                                              capacity=cap, k_top=k_top)
            return tfm.nll(logits, toks[:, 1:]) + 0.01 * aux

        val, grads = value_and_grad(loss, params)
        check(math.isfinite(float(val)) and all(
            bool(torch.isfinite(g).all()) for g in tree_leaves(grads)),
            f"MoE LM k_top {k_top}: non-finite loss or gradient")
        secs = statistics.median(chain_seconds(
            torch, lambda: value_and_grad(loss, params))
            for _ in range(MOE_REPS))
        kept = {}
        for label, c in (("capacity_2x", cap), ("binding", cap // 8)):
            disp = tmoe._dispatch_combine(x, router, MOE_EXPERTS, c,
                                          k_top)[0]
            kept[label] = int(disp.sum())
        check(kept["binding"] < k_top * n, f"MoE k_top {k_top}: capacity "
              f"{cap // 8} binds but kept all {k_top * n} routes")
        rows[k_top] = {"card": card, "capacity": cap, "loss": float(val),
                       "fwd_bwd_ms": 1e3 * secs,
                       "routes": k_top * n, "kept_routes": kept}
        del grads
    small = tfm.init_moe_lm(torch.Generator(device=dev).manual_seed(9),
                            dim=64, heads=4, depth=2, max_len=64,
                            num_experts=4, expert_hidden=32, device=dev)
    small_cpu = tree_map(lambda t: t.cpu(), small)
    stoks = torch.randint(0, 256, (2, 64), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(
                              10))
    for k_top, cap in ((1, 64), (2, 16)):
        kw = dict(heads=4, capacity=cap, k_top=k_top,
                  compute_dtype=torch.float32)
        with torch.no_grad():
            lg, aux = tfm.apply_moe_dense(small, stoks, **kw)
            lg_c, aux_c = tfm.apply_moe_dense(small_cpu, stoks.cpu(), **kw)
        diff = max(float((lg.cpu() - lg_c).abs().max()),
                   abs(float(aux) - float(aux_c)))
        check(diff <= MOE_SMALL_TOL, f"small MoE LM k_top {k_top}: card "
              f"and CPU differ by {diff}")
        rows[k_top][f"small_card_vs_cpu_cap{cap}"] = diff
    print(f"MoE LM (phase 20), B {MOE_B} T {LM_T} dim {LM_DIM} depth "
          f"{LM_DEPTH}, {MOE_EXPERTS} experts of {MOE_HIDDEN}, bf16: "
          + json.dumps(rows), flush=True)


# the bf16 flash kernels as the profiler names them on the card
FLASH_WGMMA = ("flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
               "flash_bwd_dkv_wgmma_kernel")


def flash_kernels_seen(torch, run) -> dict:
    """Calls of each flash kernel that the profiler saw on the card over
    ``run()``, by kernel name. The profiler can drop a region's first
    kernel events (13 and 15 of the 16 K2 launches opening the ring's
    region in two runs); small kernels queued first take most of that
    loss, and the launch counters hold the exact counts."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        warm = torch.zeros(1, device="cuda")
        for _ in range(16):
            warm.add_(1)
        torch.cuda.synchronize()
        run()
        torch.cuda.synchronize()
    seen: dict = {}
    for e in prof.events():
        m = re.search(r"flash_\w+_kernel", e.name)
        if e.device_type == torch.autograd.DeviceType.CUDA and m:
            seen[m.group(0)] = seen.get(m.group(0), 0) + 1
    return seen


def ring_phase(torch, dev, card, tfa) -> dict:
    """Phase 21: the RING_N steps of an RING_N-way ring driven through
    ``ring_step`` on one card, for each rank's Q shard against every
    source shard at the ring's global offsets, forward and backward: K2,
    K3 and K4 launched RING_N times per rank; the merged output and the
    gradients of q, k and v within phase 7's bf16 bound of
    ``flash_attention`` over the whole sequence; the ring's time (all
    ranks in turn) beside the whole sequence's. Returns the launches per
    rank and the rows printed."""
    flash = ("flash_forward", "flash_bwd_dq", "flash_bwd_dkv")
    H, D, t = LM_DIM // 64, 64, LM_T // RING_N
    bf16 = torch.bfloat16
    rows, per_rank = {}, None
    for label, hk in (("mha", H), (f"gqa_kv{RING_GQA_KV}", RING_GQA_KV)):
        gen = torch.Generator(device=dev).manual_seed(21)

        def rnd(*shape):
            return torch.randn(shape, device=dev, generator=gen).to(bf16)

        q = rnd(LM_B, LM_T, H, D).requires_grad_(True)
        k = rnd(LM_B, LM_T, hk, D).requires_grad_(True)
        v = rnd(LM_B, LM_T, hk, D).requires_grad_(True)
        dout = rnd(LM_B, LM_T, H, D)

        def whole():
            out = tfa.flash_attention(q, k, v, causal=True)
            return out, torch.autograd.grad(out, (q, k, v), dout)

        def ring(r):
            acc = lse = None
            q_r = q[:, r * t:(r + 1) * t]
            for step in range(RING_N):
                src = (r - step) % RING_N
                acc, lse = tfa.ring_step(
                    q_r, k[:, src * t:(src + 1) * t],
                    v[:, src * t:(src + 1) * t], r * t, src * t, acc, lse,
                    causal=True)
            out = acc.to(bf16)
            return out, torch.autograd.grad(out, (q, k, v),
                                            dout[:, r * t:(r + 1) * t])

        want, want_g = whole()
        outs, grads, launches = [], [torch.zeros_like(x, dtype=torch.float32)
                                     for x in (q, k, v)], []
        for r in range(RING_N):
            torch.cuda.synchronize()
            for name in flash:
                getattr(tfa, name).launches = 0
            out, g = ring(r)
            torch.cuda.synchronize()
            launches.append({n: getattr(tfa, n).launches for n in flash})
            check(launches[-1] == {n: RING_N for n in flash},
                  f"ring {label} rank {r}: launches {launches[-1]}, "
                  f"expected {RING_N} of each kernel")
            outs.append(out.detach())
            for total, gi in zip(grads, g):
                total += gi.float()
        errs = {}
        for key, got, ref in zip(("out", "dq", "dk", "dv"),
                                 [torch.cat(outs, dim=1)] + grads,
                                 (want,) + want_g):
            ref = ref.detach().float()
            errs[key] = float((got.float() - ref).abs().max()) / max(
                1.0, float(ref.abs().max()))
            check(errs[key] <= FLASH_TOL["bfloat16"],
                  f"ring {label}: {key} differs from whole-sequence flash "
                  f"by {errs[key]} of its largest value")
        ring_s = statistics.median(chain_seconds(torch, lambda: [
            ring(r) for r in range(RING_N)]) for _ in range(3))
        whole_s = statistics.median(chain_seconds(torch, whole)
                                    for _ in range(3))
        seen = flash_kernels_seen(torch, lambda: [ring(r)
                                                  for r in range(RING_N)])
        check(all(seen.get(k) for k in FLASH_WGMMA),
              f"ring {label}: the profiler saw flash kernels {seen}, "
              f"expected each of {FLASH_WGMMA}")
        per_rank = launches[0]
        rows[label] = {"card": card, "n": RING_N, "B": LM_B, "T": LM_T,
                       "shard": t, "heads": H, "kv_heads": hk,
                       "launches_per_rank": launches[0],
                       "err_over_largest": errs,
                       "bound": FLASH_TOL["bfloat16"],
                       "ring_fwd_bwd_ms_all_ranks": 1e3 * ring_s,
                       "whole_fwd_bwd_ms": 1e3 * whole_s,
                       "profiler_kernels_all_ranks": seen,
                       "ring_device": device_time(
                           torch, lambda: [ring(r) for r in range(RING_N)],
                           1, 1e3 * ring_s)}
        print(f"ring of {RING_N} on one card, {label} (phase 21): "
              + json.dumps(rows[label]), flush=True)
        del q, k, v, dout, want, want_g, outs, grads
    return per_rank


def parallel_phases(group, dev, cfg) -> dict:
    """Phases 22 and 23 on every rank of an NCCL group of n ranks, one card
    each (n = 1 in the default run): ``lm_example``'s layouts at full
    width. 22: ``--layout dp`` and ``sp`` (ring flash and a2a_flash) at B
    LM_B, the first 3 sp losses within PAR_LOSS_TOL of dp's, K2-K4 n
    times per block per step on the ring (once on dp and a2a_flash). 23:
    tp (a 2-way model axis where n is even), pp (n stages, PAR_MICRO
    microbatches) and ep (MOE_EXPERTS experts over the n ranks; at n > 1
    a capacity that drops no route) at B PAR_B with plain attention: the
    first loss within PAR_LOSS_TOL of the one-device ``apply``
    (``apply_moe_dense`` for ep) on the same weights and batch. Step time,
    tokens/s, peak memory. Rank 0 prints; returns the rows and each
    path's launches."""
    import argparse

    import torch

    from minips_tpu_torch.apps import lm_example as lmx
    from minips_tpu_torch.core import config as tcfg
    from minips_tpu_torch.data.loader import BatchIterator
    from minips_tpu_torch.models import transformer as tfm
    from minips_tpu_torch.ops import flash_attention as tfa
    from minips_tpu_torch.parallel.mesh import world
    from minips_tpu_torch.utils.metrics import MetricsLogger

    rank, n = world(group)
    where = ("an NCCL group of one" if n == 1
             else f"an NCCL group of {n} cards")
    flash = ("flash_forward", "flash_bwd_dq", "flash_bwd_dkv")
    width = dict(dim=cfg["dim"], depth=cfg["depth"], heads=cfg["heads"],
                 seq_len=cfg["t"])

    def app(batch, iters, **flags):
        conf = tcfg.Config(
            table=tcfg.TableConfig(name="lm", kind="dense", updater="adam",
                                   lr=APP_LM_LR),
            train=tcfg.TrainConfig(batch_size=batch, num_iters=iters,
                                   log_every=0, seed=0))
        args = argparse.Namespace(device=dev, **width, **flags)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for name in flash:
            getattr(tfa, name).launches = 0
        out = lmx.run(conf, args, MetricsLogger(None, verbose=False), group)
        torch.cuda.synchronize()
        losses = out["losses"]
        check(len(losses) == iters and all(math.isfinite(x) for x in losses),
              f"lm_example {flags}: losses {losses}")
        row = {"card": cfg["card"], "flags": {**width, **flags},
               "batch": batch, "iters": iters,
               "step_ms": 1e3 * batch / out["samples_per_sec"],
               "tokens_per_s": out["samples_per_sec"] * cfg["t"],
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "launches": {n: getattr(tfa, n).launches for n in flash},
               "first_losses": losses[:3]}
        return conf, args, row

    rows, paths = {}, {}
    # ----------------------- 22. dp against sp at full width, flash attn
    for name, flags in (("dp_flash", dict(layout="dp", attn="flash")),
                        ("sp_flash", dict(layout="sp", attn="flash")),
                        ("sp_a2a_flash", dict(layout="sp",
                                              attn="a2a_flash"))):
        _, _, row = app(cfg["b"], SP_ITERS, dtype="bfloat16", **flags)
        steps = n if name == "sp_flash" else 1  # ring steps per block
        want = {k: steps * cfg["depth"] * SP_ITERS for k in flash}
        check(row["launches"] == want, f"lm_example {name}: flash launches "
              f"{row['launches']}, expected {want}")
        row["launches_per_block_per_step"] = {
            k: v / (cfg["depth"] * SP_ITERS)
            for k, v in row["launches"].items()}
        if name != "dp_flash":
            # the profiler's kernel names over 3 more steps of the path
            seen = flash_kernels_seen(torch, lambda: app(
                cfg["b"], 3, dtype="bfloat16", **flags))
            check(all(seen.get(k) for k in FLASH_WGMMA),
                  f"lm_example {name}: the profiler saw flash kernels "
                  f"{seen}, expected each of {FLASH_WGMMA}")
            row["profiler_kernels_3_steps"] = seen
            diff = max(abs(a - b) for a, b in zip(
                row["first_losses"], rows["dp_flash"]["first_losses"]))
            check(diff <= PAR_LOSS_TOL, f"lm_example {name}: first losses "
                  f"{row['first_losses']} differ from dp's by {diff}")
            row["max_abs_diff_vs_dp"] = diff
        rows[name], paths[name] = row, row["launches"]
        if rank == 0:
            print(f"lm_example {name} through {where} (phase 22): "
                  + json.dumps(row), flush=True)
    # -------------------- 23. tp, pp and ep at full width, plain attention
    tokens = PAR_B * cfg["t"]
    # per source rank at n > 1, every token of a rank fits any one expert
    ep_cap = tokens // n if n > 1 else 0
    for name, flags in (("tp", dict(layout="tp", tp=2 if n % 2 == 0 else 1)),
                        ("pp", dict(layout="pp", tp=n,
                                    microbatches=PAR_MICRO)),
                        ("ep", dict(layout="ep", experts=MOE_EXPERTS,
                                    capacity=ep_cap))):
        conf, args, row = app(PAR_B, PAR_ITERS, **flags)
        model = lmx._model_cfg(args, cfg["t"])
        toks = torch.as_tensor(next(iter(BatchIterator(
            lmx._load_data(conf, args, cfg["t"]), PAR_B, seed=0)))["tokens"],
            device=dev).long()
        with torch.no_grad():
            if name == "ep":
                cap = (tokens if n > 1
                       else max(2 * tokens // MOE_EXPERTS, 4))
                params = lmx._init_moe_params(0, model, MOE_EXPERTS, dev)
                logits, aux = tfm.apply_moe_dense(
                    params, toks[:, :-1], heads=cfg["heads"], capacity=cap)
                ref = float(tfm.nll(logits, toks[:, 1:]) + 0.01 * aux)
            else:
                params = lmx._init_params(0, model, dev)
                ref = float(tfm.nll(tfm.apply(params, toks[:, :-1],
                                              heads=cfg["heads"]),
                                    toks[:, 1:]))
        del params
        diff = abs(row["first_losses"][0] - ref)
        check(diff <= PAR_LOSS_TOL, f"lm_example {name}: first loss "
              f"{row['first_losses'][0]} differs from the one-device "
              f"model's {ref} by {diff}")
        row.update(one_device_first_loss=ref, max_abs_diff=diff)
        rows[name], paths[name] = row, row["launches"]
        if rank == 0:
            print(f"lm_example {name} through {where} (phase 23): "
                  + json.dumps(row), flush=True)
    return {"rows": rows, "launches": paths}


def app_group_phases(group, dev, cfg) -> dict:
    """Phases 24-26 on every rank of an NCCL group of n ranks, one card
    each (n = 1 in the default run, n = ``--ranks`` on n cards):

    24. each app of ``cfg["spmd_apps"]`` (phases 11-14's flags and data)
        in spmd mode through the group: every rank steps on its rows of
        every global batch; K1 launched on every rank as phases 11-14
        count it; samples/s in all and per card beside the same run with
        ``group=None`` on rank 0 alone. At n = 1 the first losses also
        equal ``group=None``'s bit for bit, both in PyTorch's
        deterministic mode; at n > 1 they are held within LOSS_TOL. With
        ``cfg["pair_batches"]`` the LR + MLP pair through the group at
        each global batch, beside one card's at PAIR_ONE_CARD_BATCH.
    25. Wide&Deep threaded through ``Engine(group=)`` under SSP s =
        WD_SSP, rank 0 driving ``cfg["wd_workers"]`` workers while the
        other ranks serve their shards: no admitted pull more than s
        clocks ahead of the slowest worker, falling loss, K1 twice per
        worker step on every rank (its keys' owners), samples/s.
    26. ``lr_example``'s dense checkpoint resume through the group (rank 0
        writes, every rank restores): the resumed losses equal the
        uninterrupted run's, one step directory per save; with
        ``cfg["lm_ckpt"]`` also ``lm_example --layout dp --attn flash`` at
        full width and LM_CKPT_DEPTH blocks, in deterministic mode, with
        K2-K4 launched in the resumed run.

    Returns each rank's numbers; rank 0 prints."""
    import argparse
    import copy

    # cuBLAS picks one workspace per call, so that the deterministic runs
    # repeat their GEMMs bit for bit (read before this rank's first GEMM)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    from minips_tpu_torch import consistency
    from minips_tpu_torch.apps import lm_example as lmx
    from minips_tpu_torch.apps import lr_example as lrx
    from minips_tpu_torch.apps import mf_example as mfx
    from minips_tpu_torch.apps import mlp_example as mlpx
    from minips_tpu_torch.apps import wide_deep_example as wdx
    from minips_tpu_torch.apps import word2vec_example as w2vx
    from minips_tpu_torch.apps.lrmlp import build_lrmlp
    from minips_tpu_torch.core import config as tcfg
    from minips_tpu_torch.ops import flash_attention as tfa
    from minips_tpu_torch.ops.gather import gather_rows
    from minips_tpu_torch.parallel.mesh import barrier, world
    from minips_tpu_torch.utils.metrics import MetricsLogger

    rank, n = world(group)
    where = ("an NCCL group of one" if n == 1
             else f"an NCCL group of {n} cards")
    card = cfg["card"]
    out = {"rank": rank, "spmd": {}, "k1": {}}
    # over n > 1 cards, rank 0 alone through a group of one as well: the
    # one-card figures with the group layer's own cost, in this call
    solo = torch.distributed.new_group([0]) if n > 1 else None

    def say(msg):
        if rank == 0:
            print(msg, flush=True)

    def app_run(app, mode, grp, *, iters=None, workers=APP_WORKERS,
                train=None, **args):
        """One ``run`` of an app at its defaults through ``grp``; returns
        (result, K1 launches on this rank)."""
        conf = copy.deepcopy(app.DEFAULT)
        conf.train.log_every = 0
        conf.train.num_workers = workers
        if iters:
            conf.train.num_iters = iters
        for key, value in (train or {}).items():
            setattr(conf.train, key, value)
        torch.cuda.synchronize()
        gather_rows.launches = 0
        res = app.run(conf, argparse.Namespace(exec_mode=mode,
                                               device=str(dev), **args),
                      MetricsLogger(None, verbose=False), grp)
        torch.cuda.synchronize()
        return res, gather_rows.launches

    # ---------------------------------- 24. every app's spmd through the group
    wd_args = dict(eval_frac=WD_EVAL_FRAC, dtype="float32", data_file=None,
                   stream=False)
    wd_eval = 2 * math.ceil(int(16384 * WD_EVAL_FRAC) / WD_EVAL_CHUNK)
    lr_eval = math.ceil(int(8192 * LR_EVAL_FRAC) / WD_EVAL_CHUNK)
    mf_eval = 2 * math.ceil(int(MF_RATINGS * MF_EVAL_FRAC) / mfx.EVAL_CHUNK)
    # key: (app, flags, K1 launches a step, K1 launches for the holdout)
    spmd = {
        "wide_deep": (wdx, dict(model="widedeep", **wd_args), 2, wd_eval),
        "deepfm": (wdx, dict(model="deepfm", **wd_args), 2, wd_eval),
        "lr_dense": (lrx, dict(data="dense", eval_frac=LR_EVAL_FRAC), 0, 0),
        "lr_sparse": (lrx, dict(data="sparse", eval_frac=LR_EVAL_FRAC), 1,
                      lr_eval),
        "mlp": (mlpx, {}, 0, 0),
        "mf": (mfx, dict(data_file=cfg.get("ratings"),
                         eval_frac=MF_EVAL_FRAC), 2, mf_eval),
        "word2vec": (w2vx, {}, 2, 0)}
    for key in cfg["spmd_apps"]:
        app, flags, per_step, eval_k1 = spmd[key]
        iters = {wdx: WD_ITERS}.get(app)
        check_kw = dict(flags, eval_frac=0.0) if "eval_frac" in flags \
            else flags
        # the first losses, in deterministic mode (index_add_'s atomics
        # sum in no fixed order otherwise): rank 0 alone, then the group
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            alone = (app_run(app, "spmd", None, iters=CPU_STEPS,
                             **check_kw)[0]["losses"] if rank == 0
                     else None)
            grouped = app_run(app, "spmd", group, iters=CPU_STEPS,
                              **check_kw)[0]["losses"]
        finally:
            torch.use_deterministic_algorithms(False)
        if rank == 0:
            diff = max(abs(a - b) for a, b in zip(alone, grouped))
            check(grouped == alone if n == 1 else diff <= LOSS_TOL,
                  f"{key} spmd through {where}: first losses {grouped}, "
                  f"group=None's {alone}")
        # the rates at the app's defaults: one card alone, then the group
        one = (app_run(app, "spmd", None, iters=iters, **flags)[0]
               if rank == 0 else None)
        one_group = (app_run(app, "spmd", solo, iters=iters, **flags)[0]
                     if rank == 0 and solo is not None else None)
        res, k1 = app_run(app, "spmd", group, iters=iters, **flags)
        steps = len(res["losses"])
        check(steps == (iters or app.DEFAULT.train.num_iters)
              and all(math.isfinite(x) for x in res["losses"]),
              f"{key} spmd through {where}: losses {res['losses']}")
        want = per_step * steps + eval_k1
        check(k1 == want, f"{key} spmd through {where}: gather_rows "
              f"launched {k1} times on rank {rank}, expected {want} "
              f"({per_step} a step and {eval_k1} for the holdout)")
        row = {"card": card, "ranks": n, "steps": steps,
               "global_batch": app.DEFAULT.train.batch_size,
               "loss_first": res["losses"][0], "loss_last": res["losses"][-1],
               "gather_launches_rank": k1,
               "gathers_per_step": (k1 - eval_k1) / steps}
        if rank == 0:
            row.update(first_losses=grouped, first_losses_group_none=alone,
                       first_losses_bit_identical=grouped == alone,
                       samples_per_s=res["samples_per_sec"],
                       samples_per_s_per_gpu=res["samples_per_sec"] / n,
                       samples_per_s_group_none=one["samples_per_sec"],
                       per_gpu_over_one_card=res["samples_per_sec"] / n
                       / one["samples_per_sec"])
            if one_group is not None:
                row["samples_per_s_one_card_group"] = \
                    one_group["samples_per_sec"]
            for k in ("auc", "rmse", "accuracy"):
                if k in res:
                    row[k] = res[k]
        out["spmd"][key] = row
        out["k1"][f"{key}_spmd"] = k1
        say(f"{key} spmd through {where} (phase 24): " + json.dumps(row))
        del res, one, one_group

    # the LR + MLP pair through the group at each global batch, beside one
    # card's (rank 0 alone) at the primary metric's batch
    out["pair"] = {}
    if cfg.get("pair_batches"):
        one_s = {}
        if rank == 0:  # one card alone, and through a group of one
            for key, grp_ in (("none", None), ("group", solo)):
                pair = build_lrmlp(PAIR_ONE_CARD_BATCH, dev, seed=0,
                                   group=grp_)
                run_pair_steps(pair, 2)
                one_s[key] = statistics.median(chain_seconds(
                    torch, lambda: run_pair_steps(pair, CHAIN))
                    for _ in range(REPS))
                del pair
        for gb in cfg["pair_batches"]:
            pair = build_lrmlp(gb, dev, seed=0, group=group)
            losses = [(float(x), float(y)) for x, y in run_pair_steps(pair, 2)]
            torch.cuda.synchronize()
            gather_rows.launches = 0
            chains = [chain_seconds(torch, lambda: run_pair_steps(pair, CHAIN))
                      for _ in range(REPS)]
            k1 = gather_rows.launches
            check(k1 == 2 * CHAIN * REPS and all(
                math.isfinite(x) for p in losses for x in p),
                f"pair at {gb} through {where}: {k1} gathers on rank {rank} "
                f"in {CHAIN * REPS} steps, losses {losses}")
            med = statistics.median(chains)
            row = {"card": card, "ranks": n, "global_batch": gb,
                   "batch_per_card": gb // n, "chain": CHAIN, "reps": REPS,
                   "step_ms": 1e3 * med / CHAIN,
                   "samples_per_s": gb * CHAIN / med,
                   "samples_per_s_per_gpu": gb * CHAIN / med / n,
                   "gather_launches_rank": k1, "gathers_per_step": k1 / (
                       CHAIN * REPS), "chain_s": chains}
            if rank == 0:
                one_rate = {k: PAIR_ONE_CARD_BATCH * CHAIN / v
                            for k, v in one_s.items()}
                row.update(
                    one_card_batch=PAIR_ONE_CARD_BATCH,
                    one_card_samples_per_s=one_rate["none"],
                    one_card_group_samples_per_s=one_rate["group"],
                    one_card_step_ms={k: 1e3 * v / CHAIN
                                      for k, v in one_s.items()},
                    per_gpu_over_one_card=gb * CHAIN / med / n
                    / one_rate["none"])
            out["pair"][gb] = row
            out["k1"][f"lrmlp_{gb}"] = k1
            say(f"LR + MLP pair at a global batch of {gb} through {where} "
                "(phase 24): " + json.dumps(row))
            del pair

    # ---------------- 25. Wide&Deep threaded through Engine(group=), SSP
    gaps = []

    class Recording(consistency.SSP):
        def wait_until_admitted(self, worker, timeout=None):
            ok = super().wait_until_admitted(worker, timeout)
            with self._cond:
                gaps.append(self.tracker.clock_of(worker)
                            - self.tracker.min_clock)
            return ok

    workers = cfg["wd_workers"]
    conf = copy.deepcopy(wdx.DEFAULT)
    conf.table.consistency, conf.table.staleness = "ssp", WD_SSP
    conf.train.num_workers, conf.train.num_iters = workers, WD_ITERS
    conf.train.log_every = 0
    thr_args = argparse.Namespace(exec_mode="threaded", model="widedeep",
                                  device=str(dev), **wd_args)
    # over n > 1 cards, the same workers on rank 0's card alone first
    one_thr = (wdx.run(conf, thr_args, MetricsLogger(None, verbose=False))
               ["samples_per_sec"] if rank == 0 and n > 1 else None)
    orig = consistency.make_controller
    consistency.make_controller = (lambda kind, nw, staleness, sync_every:
                                   Recording(nw, staleness=staleness))
    try:
        torch.cuda.synchronize()
        gather_rows.launches = 0
        res = wdx.run(conf, thr_args, MetricsLogger(None, verbose=False),
                      group)
        torch.cuda.synchronize()
        k1 = gather_rows.launches
    finally:
        consistency.make_controller = orig
    losses = res["losses"]
    check(len(losses) == WD_ITERS and all(math.isfinite(x) for x in losses)
          and losses[-1] < losses[0],
          f"Wide&Deep threaded through {where}: losses {losses}")
    steps = WD_ITERS * workers
    check(k1 == 2 * steps + wd_eval, f"Wide&Deep threaded through {where}: "
          f"gather_rows launched {k1} times on rank {rank}, expected "
          f"{2 * steps + wd_eval}")
    if rank == 0:  # the gate lives on rank 0
        check(len(gaps) == 3 * steps and 0 <= min(gaps)
              and max(gaps) <= WD_SSP, f"Wide&Deep threaded SSP s={WD_SSP} "
              f"through {where}: {len(gaps)} admitted pulls, clock gaps "
              f"{min(gaps, default=None)}..{max(gaps, default=None)}")
    else:
        check(not gaps, f"rank {rank} admitted pulls; the gate is rank 0's")
    out["threaded"] = {
        "card": card, "ranks": n, "workers": workers, "staleness": WD_SSP,
        "iters": WD_ITERS, "loss_first": losses[0], "loss_last": losses[-1],
        "samples_per_s": res["samples_per_sec"],
        "samples_per_s_per_gpu": res["samples_per_sec"] / n,
        "holdout_auc": res["auc"], "gather_launches_rank": k1,
        "gathers_per_worker_step": (k1 - wd_eval) / steps,
        "admitted_pulls": len(gaps), "max_clock_gap": max(gaps, default=None),
        "samples_per_s_group_none": one_thr}
    out["k1"][f"wide_deep_threaded_ssp{WD_SSP}"] = k1
    say(f"Wide&Deep threaded SSP s={WD_SSP}, {workers} workers on rank 0, "
        f"through {where} (phase 25): " + json.dumps(out["threaded"]))
    del res

    # ------------------------------ 26. checkpoints under the group
    ck_dir = os.path.join(cfg["ckpt_root"], "lr_dense")
    if rank == 0:
        shutil.rmtree(ck_dir, ignore_errors=True)  # a killed run's leftovers
    barrier(group)
    lr_iters = lrx.DEFAULT.train.num_iters
    lr_flags = dict(data="dense", eval_frac=LR_EVAL_FRAC)
    whole = app_run(lrx, "spmd", group, **lr_flags)[0]
    ck = {"checkpoint_dir": ck_dir, "checkpoint_every": RESUME_EVERY}
    part = app_run(lrx, "spmd", group, iters=RESUME_AT, train=ck,
                   **lr_flags)[0]
    saved = sorted(os.listdir(ck_dir))
    resumed = app_run(lrx, "spmd", group, train=ck, **lr_flags)[0]
    saved_after = sorted(os.listdir(ck_dir))
    barrier(group)
    if rank == 0:
        shutil.rmtree(ck_dir)
    want_dirs = [f"step_{s:010d}" for s in
                 range(RESUME_EVERY, RESUME_AT + 1, RESUME_EVERY)]
    check(saved == want_dirs, f"LR dense through {where}: step directories "
          f"{saved} after {RESUME_AT} steps, expected {want_dirs}")
    check(part["losses"] + resumed["losses"] == whole["losses"]
          and resumed["auc"] == whole["auc"],
          f"LR dense resumed at step {RESUME_AT} through {where}: losses "
          "differ from the uninterrupted run's")
    out["resume"] = {"lr_dense": {
        "card": card, "ranks": n, "iters": lr_iters, "resumed_at": RESUME_AT,
        "every": RESUME_EVERY, "losses_equal": True,
        "step_dirs_after_part": saved, "step_dirs_after_resume": saved_after,
        "holdout_auc": resumed["auc"]}}
    say(f"lr_example dense checkpoint resume through {where} (phase 26): "
        + json.dumps(out["resume"]["lr_dense"]))

    if cfg.get("lm_ckpt"):
        flash = ("flash_forward", "flash_bwd_dq", "flash_bwd_dkv")
        lm_dir = os.path.join(cfg["ckpt_root"], "lm_dp")
        if rank == 0:
            shutil.rmtree(lm_dir, ignore_errors=True)
        barrier(group)
        half = LM_CKPT_ITERS // 2

        def lm_run(iters, ckpt):
            conf = tcfg.Config(
                table=tcfg.TableConfig(name="lm", kind="dense",
                                       updater="adam", lr=APP_LM_LR),
                train=tcfg.TrainConfig(batch_size=LM_B, num_iters=iters,
                                       log_every=0, seed=0,
                                       checkpoint_dir=lm_dir if ckpt
                                       else None,
                                       checkpoint_every=half if ckpt else 0))
            args = argparse.Namespace(device=dev, layout="dp",
                                      resume=ckpt, **dict(
                                          APP_LM_FLAGS, depth=LM_CKPT_DEPTH))
            torch.cuda.synchronize()
            for name in flash:
                getattr(tfa, name).launches = 0
            res = lmx.run(conf, args, MetricsLogger(None, verbose=False),
                          group)
            torch.cuda.synchronize()
            return res, {k: getattr(tfa, k).launches for k in flash}

        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            lm_whole, _ = lm_run(LM_CKPT_ITERS, False)
            lm_part, _ = lm_run(half, True)
            lm_saved = sorted(os.listdir(lm_dir))
            lm_resumed, lm_k = lm_run(LM_CKPT_ITERS, True)
        finally:
            torch.use_deterministic_algorithms(False)
        barrier(group)
        if rank == 0:
            shutil.rmtree(lm_dir)
        want = want_launches(APP_LM_FLAGS["remat_mode"], LM_CKPT_DEPTH,
                             LM_CKPT_ITERS - half)
        check(lm_saved == [f"step_{half:010d}"], f"lm_example dp through "
              f"{where}: step directories {lm_saved} after {half} steps")
        check(lm_resumed["start_step"] == half and lm_k == want,
              f"lm_example dp resumed through {where}: start step "
              f"{lm_resumed['start_step']}, flash launches {lm_k}, "
              f"expected {want}")
        check(lm_part["losses"] + lm_resumed["losses"] == lm_whole["losses"],
              f"lm_example dp resumed at step {half} through {where}: losses "
              f"{lm_part['losses'] + lm_resumed['losses']} differ from the "
              f"uninterrupted run's {lm_whole['losses']}")
        out["resume"]["lm_dp"] = {
            "card": card, "ranks": n, "flags": dict(APP_LM_FLAGS,
                                                    depth=LM_CKPT_DEPTH),
            "batch": LM_B, "iters": LM_CKPT_ITERS, "resumed_at": half,
            "losses_equal": True, "losses": lm_whole["losses"],
            "launches_resumed": lm_k}
        out["flash_resumed"] = lm_k
        say(f"lm_example dp (--attn flash) checkpoint resume through {where} "
            "(phase 26): " + json.dumps(out["resume"]["lm_dp"]))
    return out


def adopt_orphans() -> None:
    """Make this process the subreaper of its descendants (Linux's
    ``PR_SET_CHILD_SUBREAPER``): a process whose parent dies is re-parented
    here, not to init, so that ``stop_children`` finds it."""
    import ctypes

    libc = ctypes.CDLL(None, use_errno=True)
    check(libc.prctl(36, 1, 0, 0, 0) == 0,  # PR_SET_CHILD_SUBREAPER
          f"prctl(PR_SET_CHILD_SUBREAPER): errno {ctypes.get_errno()}")


def child_pids() -> list:
    """The pids whose parent is this process, zombies included."""
    me, out = os.getpid(), []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                stat = f.read()
        except OSError:  # exited while listed
            continue
        # "pid (comm) state ppid ...": comm may hold spaces and parentheses
        if int(stat[stat.rindex(")") + 2:].split()[1]) == me:
            out.append(int(name))
    return out


def stop_children() -> list:
    """Stop and reap every process this script started that still runs:
    the launcher's fork server and multiprocessing's resource tracker,
    each waited for (on its own each would outlive the script by its
    teardown), then any other child, and any orphan re-parented here,
    killed. Returns the pids it had to kill."""
    import signal

    launch = sys.modules.get("minips_tpu_torch.launch")
    if launch is not None:
        launch.stop_fork_server()
    from multiprocessing import resource_tracker

    resource_tracker._resource_tracker._stop()
    killed = []
    for _ in range(100):  # a killed child's own children come here next
        pids = child_pids()
        if not pids:
            break
        for pid in pids:
            try:
                os.kill(pid, signal.SIGKILL)  # a zombie is only reaped
                _, status = os.waitpid(pid, 0)
            except (ProcessLookupError, ChildProcessError):
                continue
            if os.waitstatus_to_exitcode(status) == -signal.SIGKILL:
                killed.append(pid)
    return killed


def free_ports(n: int) -> list:
    """``n`` loopback TCP ports the OS reports free, held open together
    while chosen so that they differ."""
    import socket

    socks = []
    try:
        for _ in range(n):
            sk = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            sk.bind(("127.0.0.1", 0))
            socks.append(sk)
        return [sk.getsockname()[1] for sk in socks]
    finally:
        for sk in socks:
            sk.close()


def p99(xs) -> float:
    """The 99th percentile of ``xs`` (linear between ranks)."""
    return statistics.quantiles(xs, n=100, method="inclusive")[98]


def control_plane_proc(rank: int, cfg: dict, results) -> None:
    """Process ``rank`` of phase 27, spawned: its environment, then
    ``control_plane_rank``; the result or the traceback goes back on
    ``results``."""
    import traceback

    os.environ.update(cfg["env"])
    sys.path.insert(0, REPO)
    try:
        results.put((rank, True, control_plane_rank(rank, cfg)))
    except BaseException:  # noqa: BLE001 - reported to the parent
        results.put((rank, False, traceback.format_exc()))


def control_plane_rank(rank: int, cfg: dict) -> dict:
    """One process of phase 27 on ``cuda:0``: the LR + MLP pair at full
    width from seed 0, a bus of ``cfg["backend"]`` under reliable delivery
    and CP_CHAOS, a heartbeat monitor, ``ClockGossip`` and the SSP gate;
    rank 0 times CP_PINGS directed round trips on it (a flow per ping in
    the trace), after as many on a clean bus of the same backend (no
    chaos, no reliable delivery); then the clocks as ``SSPTrainer.step``
    runs them without the parameter exchange: step, publish the clock, wait at the gate. At the
    end the process retires its clock and waits for its peers' and for
    every repair. When ``MINIPS_CHAOS_KILL`` kills a peer, the gate's
    ``PeerFailureError`` ends this process's run and is returned, never
    stepped past."""
    import threading

    import torch

    from minips_tpu_torch.apps.lrmlp import build_lrmlp
    from minips_tpu_torch.comm.bus import ClockGossip, make_bus
    from minips_tpu_torch.comm.chaos import install_chaos_kill
    from minips_tpu_torch.comm.heartbeat import HeartbeatMonitor
    from minips_tpu_torch.consistency.gate import (RETIRED_CLOCK,
                                                   PeerFailureError,
                                                   StalenessGate,
                                                   publish_clock)
    from minips_tpu_torch.obs import flight, tracer
    from minips_tpu_torch.ops.gather import gather_rows

    n = cfg["procs"]
    dev = torch.device("cuda", 0)
    trc = tracer.maybe_init(rank)
    flight.maybe_init(rank)
    pair = build_lrmlp(cfg["batch"], dev, seed=0)
    for i in range(CP_WARM_STEPS):  # CUDA and cuBLAS set-up off the clock
        pair.lr_step(pair.batches[i % 2])
        pair.mlp_step(pair.batches[i % 2])
    torch.cuda.synchronize()
    addrs = [f"tcp://127.0.0.1:{port}" for port in cfg["ports"]]

    def peers(ports):
        return [f"tcp://127.0.0.1:{p}" for i, p in enumerate(ports)
                if i != rank]

    # the same round trips first on a clean wire of the same backend (no
    # chaos, no reliable layer): what those two layers add to them
    clean = make_bus(addrs[n + rank], peers(cfg["ports"][n:]), my_id=rank,
                     backend=cfg["backend"], chaos="", reliable="")
    bus = make_bus(addrs[rank], peers(cfg["ports"][:n]), my_id=rank,
                   backend=cfg["backend"], chaos=CP_CHAOS, reliable="1")
    out = {"rank": rank, "backend": type(bus).__name__}

    def round_trips(bus, traced: bool):
        """Registers the handlers on ``bus`` (before it starts) and returns
        the run: CP_PINGS directed round trips from rank 0 to rank 1,
        whose handler answers each, with a flow per ping in the trace
        where ``traced``. Rank 0's run returns the times in us, rank 1's
        None once rank 0 is done."""
        pongs: dict = {}
        pong_cv = threading.Condition()
        pings_done = threading.Event()

        def on_ping(sender, payload):
            if traced and trc is not None:
                trc.flow("f", tracer.flow_id("ping", sender, payload["i"]),
                         "ping")
            bus.send(sender, "pong", {"i": payload["i"]})

        def on_pong(sender, payload):
            with pong_cv:
                pongs[payload["i"]] = time.perf_counter()
                pong_cv.notify_all()

        bus.on("ping", on_ping)
        bus.on("pong", on_pong)
        bus.on("pings_done", lambda s, p: pings_done.set())

        def run():
            if rank != 0:
                check(pings_done.wait(120.0), f"phase 27 {cfg['backend']}:"
                      " rank 0's pings never finished")
                return None
            rtt = []
            for i in range(CP_PINGS):
                if traced and trc is not None:
                    trc.flow("s", tracer.flow_id("ping", 0, i), "ping")
                t0 = time.perf_counter()
                bus.send(1, "ping", {"i": i})
                with pong_cv:
                    check(pong_cv.wait_for(lambda: i in pongs, 30.0),
                          f"phase 27 {cfg['backend']}: ping {i} unanswered")
                rtt.append((pongs[i] - t0) * 1e6)
            bus.publish("pings_done", {})
            return rtt

        return run

    clean_trips = round_trips(clean, traced=False)
    trips = round_trips(bus, traced=True)
    try:
        clean.start()
        clean.handshake(n, timeout=60.0)
        out["rtt_clean_us"] = clean_trips()
        bus.start()
        bus.handshake(n, timeout=60.0)
        gossip = ClockGossip(bus, n, workers_per_process=1)
        mon = HeartbeatMonitor(bus, list(range(n)), interval=CP_HB_INTERVAL,
                               timeout=CP_HB_TIMEOUT).start()
        gate = StalenessGate(gossip, CP_STALENESS, timeout=CP_GATE_TIMEOUT,
                             monitor=mon)
        kill = install_chaos_kill(rank, n)
        # ---- directed round trips under chaos and reliable delivery
        out["rtt_us"] = trips()
        # ---- the clocks
        torch.cuda.synchronize()
        gather_rows.launches = 0
        losses, step_ms, wait_ms, admitted = [], [], [], 0
        clock = 0
        try:
            for clock in range(1, CP_CLOCKS + 1):
                t0 = time.perf_counter()
                b = pair.batches[clock % 2]
                losses.append((pair.lr_step(b), pair.mlp_step(b)))
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                if rank == 1:
                    time.sleep(CP_SLOW_MS / 1e3)
                if kill is not None:
                    kill(clock)  # SIGKILL before the clock frame goes out
                gossip.publish_local([clock])
                t1 = time.perf_counter()
                gate.wait(clock)
                wait_ms.append((time.perf_counter() - t1) * 1e3)
                admitted = max(admitted, clock - gossip.global_min())
        except PeerFailureError as e:
            out["peer_failure"] = {
                "dead": sorted(e.dead), "clock": clock,
                "blocked_s": time.perf_counter() - t1}
        out.update(
            k1=gather_rows.launches, clocks=clock,
            losses=[(float(a), float(c)) for a, c in losses],
            step_ms=step_ms, gate_wait_ms=wait_ms,
            admitted_skew_max=admitted, gate_waits=gate.gate_waits,
            max_skew_seen=gate.max_skew_seen)
        if "peer_failure" not in out:
            publish_clock(gossip, clock, True)
            check(gossip.wait_global_min(RETIRED_CLOCK, timeout=30.0),
                  f"phase 27 {cfg['backend']}: peers never retired: "
                  f"{gossip.snapshot()}")
            deadline = time.monotonic() + 15.0
            while bus.reliable.outstanding_gaps() and \
                    time.monotonic() < deadline:
                time.sleep(0.01)
            out["dead_seen"] = sorted(mon.dead)
        mon.stop()
        out.update(frames_lost=bus.frames_lost,
                   frames_malformed=bus.frames_malformed,
                   reliable=bus.reliable.snapshot(),
                   chaos=bus.chaos.snapshot(), bytes_sent=bus.bytes_sent)
    finally:
        bus.close()
        clean.close()
        tracer.dump_now()
        flight.dump_now()
    return out


def spawn_control_plane(backend: str, kill: bool) -> list:
    """Phase 27's CP_PROCS processes, spawned, on one bus of ``backend``;
    their traces and flight boxes under ``build/chip_smoke_cp/``. Returns
    each process's result by rank (None for the one the drill kills). No
    child outlives the call; a leftover shm segment of a killed process is
    removed."""
    import glob
    import multiprocessing as mp
    import queue

    from minips_tpu_torch.comm import shm_bus

    tag = f"{backend}{'_drill' if kill else ''}"
    root = os.path.join(REPO, "build", "chip_smoke_cp", tag)
    shutil.rmtree(root, ignore_errors=True)
    run_id = f"chipsmoke{os.getpid()}{tag}"
    cfg = {"procs": CP_PROCS, "batch": B, "backend": backend,
           "ports": free_ports(2 * CP_PROCS),
           "env": {"MINIPS_TRACE": os.path.join(root, "trace"),
                   "MINIPS_FLIGHT": os.path.join(root, "flight"),
                   "MINIPS_RUN_ID": run_id, "MINIPS_HEARTBEAT": "",
                   "MINIPS_CHAOS_KILL": f"7:rank=1,step={CP_KILL_CLOCK}"
                   if kill else ""}}
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=control_plane_proc, args=(r, cfg, results),
                         daemon=True) for r in range(CP_PROCS)]
    for p in procs:
        p.start()
    want = {0} if kill else set(range(CP_PROCS))
    out: list = [None] * CP_PROCS
    deadline = time.monotonic() + CP_SPAWN_TIMEOUT
    try:
        while want:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                check(time.monotonic() < deadline, f"phase 27 {tag}: no "
                      f"result within {CP_SPAWN_TIMEOUT} s")
                for r in want:
                    check(procs[r].exitcode is None, f"phase 27 {tag}: "
                          f"process {r} exited with code "
                          f"{procs[r].exitcode} before returning")
                continue
            check(ok, f"phase 27 {tag}: process {rank} failed:\n{value}")
            out[rank] = value
            want.discard(rank)
        for p in procs:
            p.join(timeout=30.0)
        if kill:
            check(procs[1].exitcode == -9, f"phase 27 {tag}: process 1 "
                  f"ended with {procs[1].exitcode}, not by the drill's kill")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        results.close()
        for path in glob.glob(os.path.join(shm_bus._shm_dir(),
                                           f"minips_bus_{run_id}_*")):
            os.remove(path)
    for r in out:
        if r is not None:
            r["trace_dir"] = cfg["env"]["MINIPS_TRACE"]
            r["flight_dir"] = cfg["env"]["MINIPS_FLIGHT"]
    return out


def control_plane_phase(card: str) -> dict:
    """Phase 27: the host control plane between CP_PROCS processes that
    each step the LR + MLP pair on the card, once per bus backend (shm
    where the host is x86-64, and the native mailbox), then the
    peer-failure drill on the native bus. Checks, each of which raises:
    no step admitted more than CP_STALENESS clocks ahead of the global
    minimum; no frame lost under reliable delivery while chaos dropped
    some and the layer retransmitted; K1 twice per step in each process;
    finite and falling losses; ``obs/merge`` of the ranks' traces
    estimates a clock offset from the heartbeats and links a flow;
    ``obs/report`` charges gate-blocked time to a peer. The drill: rank
    0's gate raises ``PeerFailureError({1})`` within CP_DETECT_S of
    blocking and its flight box holds ``gate_peer_failure``. Returns each
    backend's numbers and K1's launches by process."""
    import platform

    from minips_tpu_torch.obs import flight, merge, report

    mach = platform.machine().lower()
    backends = ["native"]
    if mach in ("x86_64", "amd64"):
        backends.insert(0, "shm")
    else:
        print(f"control plane (phase 27): this host is {mach!r}, and the "
              "shm bus refuses hosts that are not x86-64 (its ring needs "
              "total store order): the native bus only", flush=True)
    rows, k1 = {}, {}
    for backend in backends:
        t0 = time.perf_counter()
        res = spawn_control_plane(backend, kill=False)
        took = time.perf_counter() - t0
        tag = f"phase 27 {backend}"
        for r in res:
            rk = r["rank"]
            check(r["clocks"] == CP_CLOCKS, f"{tag}: rank {rk} ran "
                  f"{r['clocks']} of {CP_CLOCKS} clocks")
            check(r["admitted_skew_max"] <= CP_STALENESS, f"{tag}: rank "
                  f"{rk} admitted a step {r['admitted_skew_max']} clocks "
                  f"ahead of the global minimum (s = {CP_STALENESS})")
            check(r["max_skew_seen"] <= CP_STALENESS + 1, f"{tag}: rank "
                  f"{rk} saw a skew of {r['max_skew_seen']} at its gate")
            check(r["frames_lost"] == 0 and r["frames_malformed"] == 0,
                  f"{tag}: rank {rk} lost {r['frames_lost']} and dropped "
                  f"{r['frames_malformed']} malformed frames")
            check(r["dead_seen"] == [], f"{tag}: rank {rk}'s monitor "
                  f"convicted {r['dead_seen']}")
            check(r["k1"] == 2 * CP_CLOCKS, f"{tag}: rank {rk} launched K1 "
                  f"{r['k1']} times in {CP_CLOCKS} steps, expected "
                  f"{2 * CP_CLOCKS}")
            losses = r["losses"]
            w = CP_CLOCKS // 4
            check(all(math.isfinite(x) for p in losses for x in p)
                  and all(sum(p[j] for p in losses[-w:])
                          < sum(p[j] for p in losses[:w]) for j in (0, 1)),
                  f"{tag}: rank {rk}'s losses did not fall: {losses}")
            k1[f"control_plane_{backend}_rank{rk}"] = r["k1"]
        dropped = sum(r["chaos"]["dropped"] for r in res)
        retrans = sum(r["reliable"]["retransmits_got"] for r in res)
        check(dropped > 0 and retrans > 0, f"{tag}: chaos dropped {dropped}"
              f" frames and {retrans} were retransmitted; both must be > 0")
        check(res[0]["gate_waits"] > 0, f"{tag}: rank 0's gate never "
              "blocked on the slower rank 1")
        doc, summary = merge.merge_traces([res[0]["trace_dir"]])
        check(summary["ranks"] == list(range(CP_PROCS))
              and not summary["unaligned_ranks"]
              and summary["flows_linked"] >= 1,
              f"{tag}: merge of the rank traces: {summary}")
        attr = report.attribute(doc)
        gate_us = {rk: {k: v for k, v in a["by"].items()
                        if k.startswith("gate ")} for rk, a in attr.items()}
        check(gate_us.get(0, {}).get("gate 1", 0) > 0, f"{tag}: report "
              f"charged no gate-blocked time of rank 0 to rank 1: {attr}")
        rtt, clean = res[0]["rtt_us"], res[0]["rtt_clean_us"]
        waits = [x for r in res for x in r["gate_wait_ms"]]
        steps = [x for r in res for x in r["step_ms"]]
        rows[backend] = {
            "bus": res[0]["backend"], "seconds": took,
            "rtt_us_p50": statistics.median(rtt), "rtt_us_p99": p99(rtt),
            "rtt_clean_us_p50": statistics.median(clean),
            "rtt_clean_us_p99": p99(clean),
            "gate_wait_ms_p50": statistics.median(waits),
            "gate_wait_ms_p99": p99(waits),
            "gate_wait_ms_p50_by_rank": [
                statistics.median(r["gate_wait_ms"]) for r in res],
            "gate_wait_ms_p99_by_rank": [p99(r["gate_wait_ms"])
                                         for r in res],
            "step_ms_p50": statistics.median(steps),
            "step_ms_p50_by_rank": [statistics.median(r["step_ms"])
                                    for r in res],
            "gate_waits": [r["gate_waits"] for r in res],
            "max_skew_seen": [r["max_skew_seen"] for r in res],
            "admitted_skew_max": [r["admitted_skew_max"] for r in res],
            "chaos_dropped": dropped, "retransmits_got": retrans,
            "frames_lost": [r["frames_lost"] for r in res],
            "k1": [r["k1"] for r in res],
            "loss_first_last": [[r["losses"][0], r["losses"][-1]]
                                for r in res],
            "merge": {k: summary[k] for k in (
                "events", "flows_linked", "clock_offsets_us")},
            "gate_blocked_us": gate_us}
        print(f"control plane on {backend} (phase 27, {CP_PROCS} processes "
              f"on one card, {CP_CLOCKS} clocks, s = {CP_STALENESS}, "
              f"chaos {CP_CHAOS!r} under reliable delivery; host times on "
              f"{card}): " + json.dumps(rows[backend]), flush=True)
    # ---- the peer-failure drill: process 1 killed at CP_KILL_CLOCK
    t0 = time.perf_counter()
    res = spawn_control_plane(backends[-1], kill=True)
    took = time.perf_counter() - t0
    head = res[0]
    pf = head.get("peer_failure")
    check(pf is not None, f"phase 27 drill: rank 0 ran {head['clocks']} "
          "clocks past process 1's kill without PeerFailureError")
    check(pf["dead"] == [1] and pf["blocked_s"] <= CP_DETECT_S,
          f"phase 27 drill: PeerFailureError({pf['dead']}) after "
          f"{pf['blocked_s']:.3f} s at the gate (want [1] within "
          f"{CP_DETECT_S} s)")
    check(head["k1"] == 2 * pf["clock"], f"phase 27 drill: K1 launched "
          f"{head['k1']} times in {pf['clock']} steps")
    boxes = flight.load_dumps([head["flight_dir"]])
    reasons = [e["kind"] for e in boxes.get(0, {}).get("reasons", [])]
    check("gate_peer_failure" in reasons, f"phase 27 drill: rank 0's "
          f"flight box holds {reasons}, not gate_peer_failure")
    drill = {"bus": head["backend"], "seconds": took, "killed_at":
             CP_KILL_CLOCK, "raised_at_clock": pf["clock"],
             "dead": pf["dead"], "blocked_s": pf["blocked_s"],
             "flight_reasons": reasons}
    print("control plane peer-failure drill (phase 27): " + json.dumps(drill),
          flush=True)
    k1[f"control_plane_{backends[-1]}_drill_rank0"] = head["k1"]
    return {"rows": rows, "drill": drill, "k1": k1}


def mp_job(n: int, module: str, flags: list, *, env: dict = None) -> list:
    """``n`` launched ranks of ``python -m minips_tpu_torch.apps.<module>``
    through the port's launcher (``launch.run_local_job``), each rank's
    done line harvested."""
    from minips_tpu_torch import launch

    argv = [sys.executable, "-m", f"minips_tpu_torch.apps.{module}"] + flags
    return launch.run_local_job(n, argv,
                                env_extra=dict(env or {}, PYTHONPATH=REPO),
                                timeout=MP_JOB_TIMEOUT_S)


def side_by_side(*jobs) -> list:
    """Each of ``jobs`` (no-argument callables) on a thread of its own, at
    once; their results in order. Only for jobs whose numbers are not
    rates: jobs that run together share the host's cores. A job's
    exception is raised here."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = [pool.submit(job) for job in jobs]
        return [f.result() for f in futures]


def mp_rates(res: list, batch: int) -> dict:
    """A multiproc job's numbers from its done lines: samples/s per process
    and in all (``batch`` x clock / wall_s), the pull and push legs' p50
    and p99 from ``wire_record``'s histograms, bytes pushed a step."""
    out = {"samples_per_s": [round(batch * r["clock"] / r["wall_s"], 1)
                             for r in res]}
    out["samples_per_s_all"] = round(sum(out["samples_per_s"]), 1)
    for leg, key in (("pull", "pull_latency_ms"), ("push_ack", "push_ack_ms")):
        h = [r["hist"][key] for r in res]
        out[f"{leg}_ms_p50_p99"] = [[x.get("p50_ms"), x.get("p99_ms")]
                                    for x in h]
    out["bytes_pushed_per_step"] = [round(r["bytes_pushed"] / r["clock"])
                                    for r in res]
    return out


def mp_contracts(tag: str, res: list, *, skew=None, auc: bool = True,
                 gate_rank=None) -> None:
    """The JAX package's multiproc contracts on every rank's done line
    (``tests/test_distributed_smoke.py``): no frame dropped, falling loss,
    AUC above 0.65, the skew bound (none under ASP), 1/N memory, replica
    agreement."""
    n = len(res)
    for r in res:
        rk = r["rank"]
        check(r["event"] == "done", f"{tag}: rank {rk}: {r}")
        check(r["frames_dropped"] == 0 and r["wire_frames_malformed"] == 0,
              f"{tag}: rank {rk} dropped frames: {r['frames_dropped']}, "
              f"malformed {r['wire_frames_malformed']}")
        check(math.isfinite(r["loss_last"])
              and r["loss_last"] < r["loss_first"], f"{tag}: rank {rk} "
              f"loss {r['loss_first']} -> {r['loss_last']}")
        if auc:
            check(r["auc"] > 0.65, f"{tag}: rank {rk} AUC {r['auc']}")
        check(skew is None or r["max_skew_seen"] <= skew, f"{tag}: rank "
              f"{rk} skew {r['max_skew_seen']} > {skew}")
        check(r["local_bytes"] * n <= r["table_bytes"] * 1.01 + 64 * n,
              f"{tag}: rank {rk} holds {r['local_bytes']} of "
              f"{r['table_bytes']} bytes")
    if gate_rank is not None:
        r = next(r for r in res if r["rank"] == gate_rank)
        check(r["gate_waits"] > 0, f"{tag}: the fast rank {gate_rank} "
              "never waited at the gate")
    fps = [r["param_fingerprint"] for r in res]
    check(max(fps) - min(fps) < MP_FP_TOL, f"{tag}: fingerprints {fps}")


def mp_kill_drill(ck: str) -> dict:
    """28d's kill drill: MP_PROCS ranks of sharded_ps_example, rank 1
    killed at step MP_KILL_AT, through the launcher's fault-drill path,
    which reports each rank's exit code (rank 0's: 42, with the
    peer_failure event)."""
    from minips_tpu_torch import launch

    base = ["--model", "sparse", "--mode", "ssp", "--checkpoint-dir", ck,
            "--checkpoint-every", str(MP_CKPT_EVERY)]
    t0 = time.perf_counter()
    rcs, events = launch.run_local_job_raw(
        MP_PROCS, [sys.executable, "-m",
                   "minips_tpu_torch.apps.sharded_ps_example", "--iters",
                   str(MP_KILL_ITERS), "--kill-at", str(MP_KILL_AT),
                   "--kill-rank", "1"] + base,
        env_extra={"PYTHONPATH": REPO}, timeout=MP_JOB_TIMEOUT_S,
        per_rank=True)
    last = events[0][-1] if events[0] else {}
    check(rcs[1] == 137 and rcs[0] == 42 and last.get("event")
          == "peer_failure" and last.get("dead") == [1],
          f"phase 28d kill: exit codes {rcs}, rank 0's last event {last}")
    kill_s = time.perf_counter() - t0
    res = mp_job(MP_PROCS, "sharded_ps_example",
                 ["--iters", str(MP_RESUME_ITERS)] + base)
    # rank 1 saved every MP_CKPT_EVERY steps up to its death
    want = (MP_KILL_AT // MP_CKPT_EVERY) * MP_CKPT_EVERY
    for r in res:
        check(r["event"] == "done" and r["resumed_from"] == want
              and r["clock"] == MP_RESUME_ITERS, f"phase 28d resume: {r}")
    sums = [r["param_sum"] for r in res]
    check(max(sums) - min(sums) < MP_FP_TOL, f"phase 28d resume: {sums}")
    return {"exit_codes": rcs, "peer_failure_at_clock": last["at_clock"],
            "resumed_from": want, "kill_job_s": round(kill_s, 1)}


def mp_elastic_drill(ck: str) -> dict:
    """28d's elastic drill (``tests/test_elastic.py``'s): 3 processes
    train MP_ELASTIC_ITERS steps with shard checkpoints; a pure restore
    on 3 and one on 2 (which reshards through ``ckpt/elastic.py``) report
    the same parameter sum."""
    base = ["--model", "sparse", "--mode", "ssp", "--batch", "128",
            "--iters", str(MP_ELASTIC_ITERS), "--checkpoint-dir", ck,
            "--checkpoint-every", str(MP_ELASTIC_EVERY)]
    res3 = mp_job(3, "sharded_ps_example", base)
    check(all(r["clock"] == MP_ELASTIC_ITERS for r in res3),
          f"phase 28d elastic: {res3}")
    same = mp_job(3, "sharded_ps_example", base)
    shrunk = mp_job(2, "sharded_ps_example", base)
    for r in same + shrunk:
        check(r["event"] == "done" and r["resumed_from"] == MP_ELASTIC_ITERS,
              f"phase 28d elastic restore: {r}")
    diff = abs(shrunk[0]["param_sum"] - same[0]["param_sum"])
    check(diff <= MP_ELASTIC_TOL, f"phase 28d elastic: the 2-process "
          f"restore's sum {shrunk[0]['param_sum']} against the 3-process "
          f"restore's {same[0]['param_sum']}")
    return {"trained_sum": res3[0]["param_sum"],
            "restored_3_sum": same[0]["param_sum"],
            "resharded_2_sum": shrunk[0]["param_sum"], "diff": diff}


def multiproc_phase(card: str, ratings: str) -> dict:
    """Phase 28: the multi-process parameter server between MP_PROCS
    launched processes that share the card (28a-28c) and its fault and
    checkpoint drills (28d). No kernel of K1-K4 lies on this path: the
    servers are numpy on the host and each rank's step is autograd on
    ``cuda:0``. Returns the numbers printed."""
    out = {}
    wd = ["--exec", "multiproc", "--num_iters", str(MP_ITERS)]
    b = 1024  # the apps' default batch
    # ---- 28a: Wide&Deep at BSP, then SSP with a straggler
    t0 = time.perf_counter()
    bsp = mp_job(MP_PROCS, "wide_deep_example", wd)
    for r in bsp:
        check(r["device"] == "cuda:0", f"phase 28a: rank {r['rank']} ran "
              f"on {r['device']}")
    mp_contracts("phase 28a BSP", bsp, skew=1)
    ssp = mp_job(MP_PROCS, "wide_deep_example", wd + [
        "--consistency", "ssp", "--staleness", str(MP_SSP), "--slow-rank",
        str(MP_SLOW_RANK), "--slow-ms", str(MP_SLOW_MS)])
    mp_contracts("phase 28a SSP", ssp, skew=MP_SSP + 1, gate_rank=0)
    out["28a"] = {"bsp": mp_rates(bsp, b), "ssp": mp_rates(ssp, b),
                  "ssp_gate_waits": [r["gate_waits"] for r in ssp],
                  "ssp_max_skew": [r["max_skew_seen"] for r in ssp],
                  "auc": [r["auc"] for r in bsp + ssp],
                  "s": round(time.perf_counter() - t0, 1)}
    print(f"multiproc Wide&Deep on {MP_PROCS} processes sharing {card} "
          "(phase 28a; samples/s = B x clock / wall_s; push_ack is empty: "
          "the app pushes synchronously): " + json.dumps(out["28a"]),
          flush=True)
    # ---- 28b: the card against the CPU, taxed links
    t0 = time.perf_counter()
    tax = {"MINIPS_CHAOS": f"1:slow#0-1={MP_TAX_MS}"}
    short = ["--exec", "multiproc", "--num_iters", str(MP_TAX_ITERS)]
    on_card, on_cpu = side_by_side(
        lambda: mp_job(MP_PROCS, "wide_deep_example", short, env=tax),
        lambda: mp_job(MP_PROCS, "wide_deep_example", short,
                       env=dict(tax, MINIPS_FORCE_CPU="1")))
    cpu_first = {r["rank"]: r["loss_first"] for r in on_cpu}
    diffs = {r["rank"]: abs(r["loss_first"] - cpu_first[r["rank"]])
             for r in on_card}
    check(all(r["device"] == "cpu" for r in on_cpu), "phase 28b: a CPU "
          f"rank ran on {[r['device'] for r in on_cpu]}")
    check(max(diffs.values()) <= MP_FIRST_LOSS_TOL, "phase 28b: first "
          f"losses card {[r['loss_first'] for r in on_card]} CPU "
          f"{cpu_first} differ by {diffs}")
    out["28b"] = {"first_loss_diff": diffs,
                  "s": round(time.perf_counter() - t0, 1)}
    print("multiproc Wide&Deep first losses, card against CPU ranks "
          f"(phase 28b, tolerance {MP_FIRST_LOSS_TOL}): "
          + json.dumps(out["28b"]), flush=True)
    # ---- 28c: MF (ASP) on phase 13's ratings.csv, word2vec under SSP
    t0 = time.perf_counter()
    mf = mp_job(MP_PROCS, "mf_example", ["--exec", "multiproc",
                                         "--num_iters", str(MP_MF_ITERS),
                                         "--data_file", ratings])
    mp_contracts("phase 28c MF", mf, auc=False)
    check(all(r["rmse"] is not None and math.isfinite(r["rmse"])
              for r in mf), f"phase 28c MF: RMSE {[r['rmse'] for r in mf]}")
    w2v = mp_job(MP_PROCS, "word2vec_example", [
        "--exec", "multiproc", "--num_iters", str(MP_W2V_ITERS),
        "--consistency", "ssp", "--staleness",
        str(MP_W2V_SSP), "--batch_size", str(MP_W2V_BATCH)])
    mp_contracts("phase 28c word2vec", w2v, skew=MP_W2V_SSP + 1, auc=False)
    out["28c"] = {"mf": dict(mp_rates(mf, b), rmse=[r["rmse"] for r in mf],
                             loss=[[r["loss_first"], r["loss_last"]]
                                   for r in mf]),
                  "word2vec": dict(mp_rates(w2v, MP_W2V_BATCH), loss=[
                      [r["loss_first"], r["loss_last"]] for r in w2v]),
                  "s": round(time.perf_counter() - t0, 1)}
    print(f"multiproc MF (ASP, {MF_RATINGS} ratings) and word2vec (SSP s = "
          f"{MP_W2V_SSP}, B {MP_W2V_BATCH}) on {MP_PROCS} processes (phase "
          "28c): "
          + json.dumps(out["28c"]), flush=True)
    # ---- 28d: the kill drill and the elastic drill
    t0 = time.perf_counter()
    root = os.path.join(REPO, "build", "chip_smoke_mp")
    shutil.rmtree(root, ignore_errors=True)
    kill, elastic = side_by_side(
        lambda: mp_kill_drill(os.path.join(root, "kill")),
        lambda: mp_elastic_drill(os.path.join(root, "elastic")))
    out["28d"] = {"kill": kill, "elastic": elastic,
                  "s": round(time.perf_counter() - t0, 1)}
    shutil.rmtree(root, ignore_errors=True)
    print("multiproc fault and checkpoint drills (phase 28d): "
          + json.dumps(out["28d"]), flush=True)
    print("K1-K4 on phase 28's path: none launched (the servers apply "
          "updates in numpy on the host; each rank's step is autograd "
          "through cuBLAS and PyTorch's own kernels)", flush=True)
    return out


def pl_serve_rows(r: dict) -> dict:
    """A done line's owner-served and replica-served pull rows, and the
    serving plane's sheds, backpressures and stale reads."""
    sv = r["serve"]
    rep = sv["replica"] or {}
    return {"owner_rows": sv["pull_rows"],
            "replica_rows": rep["replica_served_rows"]
            + rep["replica_local_rows"],
            "sheds": rep["shed_redirects"] + rep["shed_partial"],
            "backpressure": rep["backpressure"],
            "grants": rep["grants"], "revokes": rep["revokes"],
            "stale_reads": rep["stale_reads"]}


def timed_job_raw(n: int, module: str, flags: list, env: dict) -> tuple:
    """``launch.run_local_job_raw``'s drill path (every JSON line of every
    rank, failures tolerated, no rank killed for another's exit), with
    each rank's exit time on ``time.monotonic`` (the clock the flight
    recorder stamps its events with, shared by the host's processes).
    Returns (exit codes, events, exit times)."""
    import tempfile

    from minips_tpu_torch import launch

    argv = [sys.executable, "-m", f"minips_tpu_torch.apps.{module}"] + flags
    base = launch.find_free_base_port(n)
    hosts = ["localhost"] * n
    outs = [tempfile.NamedTemporaryFile("w+", delete=False) for _ in hosts]
    procs = []
    for rank in range(n):
        renv = launch.child_env(rank, hosts, base)
        renv.update(env, PYTHONPATH=REPO)
        procs.append(launch._spawn_rank(argv, renv, outs[rank]))
    exits = [None] * n
    deadline = time.monotonic() + MP_JOB_TIMEOUT_S
    while None in exits and time.monotonic() < deadline:
        for i, p in enumerate(procs):
            if exits[i] is None and p.poll() is not None:
                exits[i] = time.monotonic()
        time.sleep(0.01)
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=10)
    events = []
    for f in outs:
        f.seek(0)
        events.append([json.loads(ln) for ln in f.read().splitlines()
                       if ln.strip().startswith("{")])
        f.close()
        os.unlink(f.name)
    return [p.poll() for p in procs], events, exits


def placement_phase(card: str, wd_bsp: dict) -> dict:
    """Phase 29: the heat rebalancer, the serving plane, the coordinator
    lease, elastic membership and the autoscaler, armed in the port's
    ``ShardedPSTrainer`` and driven by launched jobs on the card (29a-29c;
    ``wd_bsp`` is 28a's BSP numbers, printed beside 29c's). No kernel of
    K1-K4 lies on this path. Returns the numbers printed."""
    from minips_tpu_torch.balance.redistribute import state_row_bytes

    out = {}
    root = os.path.join(REPO, "build", "chip_smoke_pl")
    shutil.rmtree(root, ignore_errors=True)
    # ---- 29a: migration and replicas under a storm
    t0 = time.perf_counter()
    res = mp_job(PL_PROCS, "sharded_ps_example", [
        "--model", "sparse", "--mode", "ssp", "--staleness", str(PL_SSP),
        "--updater", "adagrad", "--iters", str(PL_ITERS)] + PL_STORM,
        env={"MINIPS_REBALANCE": PL_REBALANCE, "MINIPS_SERVE": PL_SERVE})
    rb = [r["rebalance"] for r in res]
    rows = [pl_serve_rows(r) for r in res]
    for r in res:
        tag = f"phase 29a: rank {r['rank']}"
        check(r["event"] == "done" and r["clock"] == PL_ITERS
              and r["device"] == "cuda:0", f"{tag}: {r}")
        check(r["frames_dropped"] == 0 and r["wire_frames_lost"] == 0,
              f"{tag}: frames dropped {r['frames_dropped']}, lost "
              f"{r['wire_frames_lost']}")
        check(r["max_skew_seen"] <= PL_SSP + 1, f"{tag}: skew "
              f"{r['max_skew_seen']}")
        check(r["rebalance"]["epoch"] >= 1, f"{tag}: adopted no plan: "
              f"{r['rebalance']}")
        check(math.isfinite(r["loss_last"]), f"{tag}: loss {r['loss_last']}")
    check(sum(x["plans"] for x in rb) >= 1
          and sum(x["blocks_in"] for x in rb) >= 1,
          f"phase 29a: nothing migrated: {rb}")
    check(sum(x["replica_rows"] for x in rows) > 0,
          f"phase 29a: replicas served no row: {rows}")
    check(all(x["stale_reads"] == 0 for x in rows),
          f"phase 29a: stale reads {rows}")
    check(len({r["param_sum"] for r in res}) == 1
          and len({r["param_norm"] for r in res}) == 1,
          "phase 29a: the ranks' weights differ: "
          f"{[(r['param_sum'], r['param_norm']) for r in res]}")
    row_bytes = state_row_bytes(1, "adagrad")
    out["29a"] = {
        "wall_s": [r["wall_s"] for r in res],
        "samples_per_s": [round(256 * r["clock"] / r["wall_s"], 1)
                          for r in res],
        "plans": sum(x["plans"] for x in rb),
        "epoch": [x["epoch"] for x in rb],
        "blocks_moved": sum(x["blocks_in"] for x in rb),
        "rows_moved": sum(x["migrated_rows"] for x in rb),
        "bytes_moved": sum(x["migrated_rows"] for x in rb) * row_bytes,
        "serve": rows, "max_skew": [r["max_skew_seen"] for r in res],
        "s": round(time.perf_counter() - t0, 1)}
    print(f"rebalancer and replicas under a pull storm on {PL_PROCS} "
          f"processes sharing {card} (phase 29a; samples/s = B 256 x clock "
          "/ wall_s, bytes moved = rows moved x Adagrad's state bytes a "
          "row): " + json.dumps(out["29a"]), flush=True)
    # ---- 29b: the closed loop
    t0 = time.perf_counter()
    flight = os.path.join(root, "flight")
    rcs, events, exits = timed_job_raw(
        CL_PROCS, "sharded_ps_example",
        CL_FLAGS + ["--checkpoint-dir", os.path.join(root, "ck")],
        dict(CL_ENV, MINIPS_FLIGHT=flight))
    last = {r: (ev[-1] if ev else {}) for r, ev in enumerate(events)}
    dones = {r: d for r, d in last.items() if d.get("event") == "done"}
    check(set(dones) == {1, 2}, f"phase 29b: exit codes {rcs}, last "
          f"events {last}")
    check(last[3].get("event") == "drained", "phase 29b: the standby's "
          f"last event {last[3]}")
    for r, d in dones.items():
        m = d["membership"]
        check(d["clock"] == CL_ITERS and d["wire_frames_lost"] == 0
              and d["device"] == "cuda:0" and math.isfinite(d["loss_last"]),
              f"phase 29b: rank {r}: {d}")
        check(m["dead"] == [CL_KILL_RANK] and m["coord"] == 1
              and m["lease"]["term"] == 1 and m["left"] == [3],
              f"phase 29b: rank {r}'s membership {m}")
    check(last[3].get("device") == "cuda:0", f"phase 29b: rank 3 {last[3]}")
    check(sum(d["membership"]["blocks_restored"] for d in dones.values())
          >= 1, "phase 29b: no block restored")
    check(len({d["param_sum"] for d in dones.values()}) == 1,
          f"phase 29b: survivors differ: {[d['param_sum'] for d in dones.values()]}")
    auto = dones[1]["autoscale"] or {}
    check(auto.get("admits", 0) >= 1 and auto.get("drains", 0) >= 1,
          f"phase 29b: rank 1's autoscaler {auto}")
    # the lease moves at the first survivor's term advance (the others,
    # rank 1 among them, may learn the new term from its heartbeats
    # before their own verdicts); rank 1's own verdict is its hb_death
    advances, verdict = [], None
    for r in range(CL_PROCS):
        if r == CL_KILL_RANK:
            continue
        with open(os.path.join(flight, f"flight-rank{r}.json")) as f:
            box = json.load(f)
        for e in box["reasons"]:
            advances += [e["t_us"] / 1e6] if e["kind"] == "term_advance" \
                else []
            if r == 1 and e["kind"] == "hb_death" and verdict is None:
                verdict = e["t_us"] / 1e6
    kill_t = exits[CL_KILL_RANK]
    check(advances and verdict is not None and kill_t is not None,
          f"phase 29b: term advances {advances}, rank 1's verdict "
          f"{verdict}, kill exit {kill_t}")
    out["29b"] = {
        "exit_codes": rcs,
        "wall_s": {r: d["wall_s"] for r, d in dones.items()},
        "samples_per_s": {r: round(64 * d["clock"] / d["wall_s"], 1)
                          for r, d in dones.items()},
        "kill_to_lease_s": round(min(advances) - kill_t, 3),
        "kill_to_rank1_verdict_s": round(verdict - kill_t, 3),
        "membership": {k: dones[1]["membership"][k] for k in (
            "live", "dead", "left", "coord", "lease", "epoch",
            "blocks_restored", "joins", "leaves", "deaths")},
        "autoscale": {k: auto.get(k) for k in (
            "admits", "drains", "shed_rate_pre", "shed_rate_post",
            "p99_hot_ms", "p99_last_ms", "sheds_seen")},
        "serve": {r: pl_serve_rows(d) for r, d in dones.items()},
        "standby": {k: last[3].get(k) for k in ("event", "clock",
                                                 "resumed_from", "wall_s")},
        "s": round(time.perf_counter() - t0, 1)}
    print(f"closed loop on {CL_PROCS} slots of {card} (phase 29b; rank "
          f"{CL_KILL_RANK} killed, the lease to rank 1, the standby "
          "admitted and drained by rank 1's autoscaler; kill_to_lease_s "
          "from rank 0's exit to the first term_advance in a survivor's "
          "flight box, kill_to_rank1_verdict_s to rank 1's hb_death): "
          + json.dumps(out["29b"]), flush=True)
    # ---- 29c: the flagship with the layers armed and idle
    t0 = time.perf_counter()
    armed = mp_job(MP_PROCS, "wide_deep_example",
                   ["--exec", "multiproc", "--num_iters", str(MP_ITERS)],
                   env=IDLE_ENV)
    for r in armed:
        check(r["device"] == "cuda:0" and r["rebalance"] is not None
              and r["serve"]["replica"] is not None
              and r["membership"] is not None, f"phase 29c: rank "
              f"{r['rank']}: a layer did not arm, or ran off the card: "
              f"{r['device']}")
    mp_contracts("phase 29c BSP, layers armed", armed, skew=1)
    for r in armed:
        check(r["rebalance"]["blocks_in"] == 0 and r["rebalance"]["plans"]
              == 0 and r["serve"]["replica"]["grants"] == 0
              and r["membership"]["epoch"] == 0, f"phase 29c: rank "
              f"{r['rank']}'s layers did not stay idle: rebalance "
              f"{r['rebalance']}, grants {r['serve']['replica']['grants']}")
    out["29c"] = {"armed": mp_rates(armed, 1024),
                  "28a_bsp": {k: wd_bsp[k] for k in (
                      "samples_per_s", "samples_per_s_all")},
                  "blocks_moved": sum(r["rebalance"]["blocks_in"]
                                      for r in armed),
                  "grants": sum(r["serve"]["replica"]["grants"]
                                for r in armed),
                  "s": round(time.perf_counter() - t0, 1)}
    print(f"multiproc Wide&Deep BSP with the rebalancer, the serving plane "
          f"and membership armed, on {MP_PROCS} processes (phase 29c), "
          "beside 28a's BSP in this run: " + json.dumps(out["29c"]),
          flush=True)
    shutil.rmtree(root, ignore_errors=True)
    print("K1-K4 on phase 29's path: none launched (the servers, the "
          "migrations and the replicas run in numpy on the host; each "
          "rank's step is autograd through cuBLAS and PyTorch's own "
          "kernels)", flush=True)
    return out


def mesh_bench(torch, argv: list) -> dict:
    """One ``sharded_ps_bench.main(argv)`` run of the mesh plane in this
    process: its done line, and beside it the plane's wave and gate
    histograms, the host time of each device-clock admission
    (``MeshPlane._device_min``, a sync of the card), the deposit stage's
    peak host bytes and the card's peak allocation above what the process
    held when the run began."""
    from minips_tpu_torch.apps import sharded_ps_bench as bench
    from minips_tpu_torch.train import mesh_plane as mp

    planes, admits = [], []
    real_stats, real_min = mp.MeshPlane.stats, mp.MeshPlane._device_min

    def stats(self):
        planes.append(self)
        return real_stats(self)

    def device_min(self):
        t = time.perf_counter()
        v = real_min(self)
        admits.append(time.perf_counter() - t)
        return v

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    mp.MeshPlane.stats, mp.MeshPlane._device_min = stats, device_min
    try:
        rc, done = bench_line(bench, argv)
    finally:
        mp.MeshPlane.stats, mp.MeshPlane._device_min = real_stats, real_min
    check(rc == 0 and done["event"] == "done"
          and done["jax_backend"] == "cuda", f"phase 30 {argv}: rc {rc}, "
          f"{done}")
    st = real_stats(planes[-1])
    admits.sort()
    return {"rows_per_sec_ranks": done["rows_per_sec_ranks"],
            "rows_per_sec": done["rows_per_sec"],
            "waves": done["waves"], "wall_s": done["wall_s"],
            "collective_bytes_per_row_moved":
                done["collective_bytes_per_row_moved"],
            "wave_ms": st["hist"]["wave_ms"],
            "gate_ms": st["hist"]["gate_ms"],
            "admissions": len(admits),
            "admission_us_p50": (round(1e6 * admits[len(admits) // 2], 1)
                                 if admits else None),
            "admission_us_p99": (round(1e6 * admits[int(len(admits) * 0.99)],
                                       1) if admits else None),
            "peak_deposit_bytes": done["peak_deposit_bytes"],
            "peak_gb_above_start": round(
                (torch.cuda.max_memory_allocated() - base) / 1e9, 4)}


def mesh_schedule(devices, updater: str, comm: str, deposit: str,
                  rows: int = 1 << 16, dim: int = 8, batch: int = 4096,
                  steps: int = MESH_CMP_STEPS) -> dict:
    """One seeded single-threaded BSP schedule of the mesh plane on
    ``devices`` (every rank pulls, pushes with duplicate keys, then
    ticks); the finalized state over the padded table, on the host."""
    import threading

    import numpy as np

    from minips_tpu_torch.train import mesh_plane as mp

    n = len(devices)
    plane = mp.MeshPlane(n, staleness=0, comm=comm, deposit=deposit,
                         devices=devices)
    t = plane.add_table("t", rows, dim, updater=updater, lr=0.05)
    rng = np.random.default_rng(30)
    t.load_dense(rng.normal(size=(rows, dim)).astype(np.float32))
    for _ in range(steps):
        for r in range(n):
            keys = rng.integers(0, rows, size=batch)
            t.pull(r, keys)
            t.push(r, keys, rng.normal(size=(batch, dim)).astype(
                np.float32))
        for r in range(n):
            plane.tick(r, wait=False)
    ths = [threading.Thread(target=plane.finalize, args=(r,))
           for r in range(n)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=120.0)
    out = {k: np.asarray(getattr(t, k).cpu()) for k in
           ("_w", "_acc", "_m", "_v", "_steps") if getattr(t, k) is not None}
    out["mirror"] = t.pull_all(0).copy()
    return out


def state_gap(a: dict, b: dict) -> tuple:
    """(bitwise equal, max abs difference) over every state of two
    ``mesh_schedule`` results."""
    import numpy as np

    same = all(np.array_equal(a[k], b[k]) for k in a)
    gap = max(float(np.abs(a[k].astype(np.float64) - b[k]).max())
              for k in a)
    return same, gap


def agg_rounds(devices, comm: str, rows: int = 1 << 16, dim: int = 8):
    """MESH_AGG_REDUCES seeded reduces of ``MeshAggregator`` on
    ``devices`` (2 slots); each reduce's (keys, rows, residual keys,
    residual rows), the staged keys and rows, and the stats."""
    import numpy as np

    from minips_tpu_torch.train import mesh_plane as mp

    agg = mp.MeshAggregator(rows, dim, slots=len(devices), comm=comm,
                            devices=devices)
    rng = np.random.default_rng(31)
    outs = []
    for _ in range(MESH_AGG_REDUCES):
        staged = []
        for s in range(len(devices)):
            k = rng.integers(0, rows, size=MESH_AGG_KEYS)
            g = rng.normal(size=(MESH_AGG_KEYS, dim)).astype(np.float32)
            agg.deposit(s, k, g)
            staged.append((k, g))
        outs.append((agg.reduce(), staged))
    return outs, agg.stats()


def agg_gaps(card, other) -> dict:
    """One ``agg_rounds`` run against another on the same deposits
    (bitwise, max abs), and the first against THE host kernel
    (``sum_duplicate_keys`` over every staged row, f64 then f32 once):
    rows + residual is what the slots deposited, whatever the tier
    shipped."""
    import numpy as np

    from minips_tpu_torch.train.sharded_ps import sum_duplicate_keys

    gap = host = 0.0
    same = True
    for ((k, rows, rk, rr), staged), ((k2, rows2, rk2, rr2), _) in zip(
            card, other):
        same &= (np.array_equal(k, k2) and np.array_equal(rows, rows2)
                 and np.array_equal(rk, rk2) and np.array_equal(rr, rr2))
        gap = max(gap, float(np.abs(rows - rows2).max()))
        hk, hg, _ = sum_duplicate_keys(
            np.concatenate([s[0] for s in staged]),
            np.concatenate([s[1] for s in staged]), rows.shape[1])
        order = np.argsort(hk, kind="stable")
        hk, hg = hk[order], hg[order]
        check(np.array_equal(hk, k), "phase 30b: the aggregate's keys")
        full = rows.astype(np.float64)
        if rk.size:
            full[np.searchsorted(k, rk)] += rr
        host = max(host, float(np.abs(full - hg).max()))
    return {"bitwise": bool(same), "max_abs": gap,
            "max_abs_rows_plus_residual_vs_host_kernel": host}


def mesh_phase(torch, card: str) -> dict:
    """Phase 30: the in-mesh collective data plane in this process. 30a
    the plane on [cuda:0] * MESH_RANKS through ``sharded_ps_bench --plane
    mesh``, its device idle share over MESH_PROFILED_WAVES waves, the
    card's states against the CPU port's, ``--mesh-bitwise-drill``; 30b
    ``MeshAggregator``'s device tier on the card against the CPU port's
    and the host kernel, ``--hier-bitwise-drill``, and the push tree's
    ``agg=mesh`` on one card (the one-device tier); 30c two launched
    ``sharded_ps_bench`` processes with ``--compute jit`` on the card.
    No kernel of K1-K4 lies on this path (the wave is PyTorch's
    ``index_add_``, elementwise kernels and the copies). Returns the
    numbers printed."""
    import numpy as np

    from minips_tpu_torch.apps import sharded_ps_bench as bench
    from minips_tpu_torch.train import mesh_plane as mp

    tl = bench._lockstep()  # tests/torch_lockstep.py
    out = {}
    dev = torch.device("cuda", 0)
    one = ["--plane", "mesh", "--mesh-ranks", str(MESH_RANKS),
           "--mesh-devices", "cuda:0"]
    # ---- 30a: the plane at the bench's defaults, and at a table's size
    t0 = time.perf_counter()
    runs = {f"{u}_{c}": mesh_bench(torch, one + ["--updater", u,
                                                 "--mesh-comm", c])
            for u, c in MESH_RUNS}
    runs["adam_float32_2^21x16_sparse"] = mesh_bench(torch, one + [
        "--rows", str(MESH_BIG_ROWS), "--dim", str(MESH_BIG_DIM),
        "--updater", "adam", "--mesh-deposit", "sparse",
        "--iters", str(MESH_BIG_ITERS), "--warmup", str(MESH_BIG_WARMUP)])
    # the device's idle share over MESH_PROFILED_WAVES waves: every rank
    # pushes (the last push fires the wave), then every rank ticks
    plane = mp.MeshPlane(MESH_RANKS, staleness=0, devices=[dev] * MESH_RANKS)
    tab = plane.add_table("b", 1 << 16, 8, updater="adagrad")
    rng = np.random.default_rng(0)
    pushes = [(rng.integers(0, 1 << 16, size=4096),
               rng.normal(size=(4096, 8)).astype(np.float32))
              for _ in range(MESH_RANKS)]

    def waves(k):
        for _ in range(k):
            for r, (keys, g) in enumerate(pushes):
                tab.push(r, keys, g)
            for r in range(MESH_RANKS):
                plane.tick(r, wait=False)
        torch.cuda.synchronize()

    waves(3)
    t1 = time.perf_counter()
    waves(MESH_PROFILED_WAVES)
    wave_ms = 1e3 * (time.perf_counter() - t1) / MESH_PROFILED_WAVES
    prof = device_time(torch, lambda: waves(MESH_PROFILED_WAVES),
                       MESH_PROFILED_WAVES, wave_ms)
    out["30a"] = {"runs": runs, "profiled_wave_ms": round(wave_ms, 4),
                  "device_busy_ms_per_wave": prof["device_busy_ms"],
                  "device_idle_share": prof["device_idle_share"],
                  "device_ops_per_wave": prof["device_ops"],
                  "top": prof["top"][:5]}
    # the card against the CPU port, one seeded single-threaded schedule
    cmp = {}
    for upd, comm, dep in (("sgd", "float32", "dense"),
                           ("adagrad", "blk8", "dense"),
                           ("adam", "float32", "sparse")):
        a = mesh_schedule([dev] * MESH_RANKS, upd, comm, dep)
        b = mesh_schedule(["cpu"] * MESH_RANKS, upd, comm, dep)
        same, gap = state_gap(a, b)
        check(same if (upd, comm) == ("sgd", "float32")
              else gap <= MESH_STATE_TOL, f"phase 30a: {upd}/{comm}/{dep} "
              f"card against CPU: bitwise {same}, max abs {gap}")
        cmp[f"{upd}_{comm}_{dep}"] = {"bitwise": same, "max_abs": gap}
    out["30a"]["card_vs_cpu"] = cmp
    _, drill = bench_line(bench, ["--mesh-bitwise-drill", "--mesh-devices",
                                  "cuda:0"])
    check(drill["bitwise_equal"] is True and drill["rows_checked"] == 64,
          f"phase 30a: mesh bitwise drill {drill}")
    out["30a"]["mesh_bitwise_drill"] = drill
    out["30a"]["s"] = round(time.perf_counter() - t0, 1)
    print(f"mesh plane, {MESH_RANKS} ranks on {card} cuda:0 (phase 30a; "
          "per run rows/s per rank, waves, collective B per row moved, "
          "wave and gate ms, the device-clock admission's host us, peak "
          "deposit bytes and card GB; the profiled waves' idle share; the "
          "card's states against the CPU port's): "
          + json.dumps(out["30a"]), flush=True)
    # ---- 30b: the push tree's device reduce
    t0 = time.perf_counter()
    aggs = {}
    for comm in ("float32", "blk8"):
        card_run, st = agg_rounds([dev] * 2, comm)
        cpu_run, st_cpu = agg_rounds(["cpu"] * 2, comm)
        g = agg_gaps(card_run, cpu_run)
        check(st["backend"] == "mesh" and st == st_cpu
              and g["max_abs"] <= MESH_STATE_TOL
              and g["max_abs_rows_plus_residual_vs_host_kernel"] <= 1e-4,
              f"phase 30b: aggregator {comm}: {st} / {st_cpu}, {g}")
        aggs[comm] = dict(g, stats=st)
    _, hier = bench_line(bench, ["--hier-bitwise-drill"])
    check(hier["bitwise_equal"] is True, f"phase 30b: hier drill {hier}")
    flat, _ = tl.run_hier_lockstep("")
    st: dict = {}
    tree, lost = tl.run_hier_lockstep("group=2,agg=mesh", stats=st)
    backend = mp.MeshAggregator(96, 2, slots=2).stats()["backend"]
    check(all(np.array_equal(a, b) for a, b in zip(flat, tree))
          and lost == [0, 0, 0] and st["mesh_reduces"] > 0
          and st["mesh_agg_fallbacks"] == 0
          and backend == "host-degenerate", f"phase 30b: agg=mesh on one "
          f"card: {st}, lost {lost}, backend {backend}")
    # a trainer with agg=mesh: MESH_TREE_PROCS launched processes on the
    # card, host groups {0, 1} | {2}; rank 0 leads and reduces on the
    # one-device tier
    job = mp_job(MESH_TREE_PROCS, "sharded_ps_example", MESH_TREE_FLAGS,
                 env={"MINIPS_HIER": "group=2,agg=mesh"})
    hy = [r["hybrid"] for r in job]
    check(all(r["event"] == "done" and r["frames_dropped"] == 0
              for r in job) and all(h["backend_mesh"] == 0
                                    and h["mesh_agg_fallbacks"] == 0
                                    for h in hy)
          and hy[0]["mesh_reduces"] > 0
          and len({r["param_sum"] for r in job}) == 1,
          f"phase 30b: agg=mesh trainers: {hy}")
    out["30b"] = {"aggregator": aggs, "hier_bitwise_drill": hier,
                  "agg_mesh_lockstep": dict(st, backend=backend,
                                            bitwise_equal_flat=True),
                  "agg_mesh_trainers": hy,
                  "s": round(time.perf_counter() - t0, 1)}
    print(f"the push tree's device reduce on {card} (phase 30b; the "
          "aggregator's device tier against the CPU port's and the host "
          "kernel, the hier drill, agg=mesh in the lockstep and in "
          f"{MESH_TREE_PROCS} launched trainers): "
          + json.dumps(out["30b"]), flush=True)
    # ---- 30c: the wire bench, two launched processes on the card
    t0 = time.perf_counter()
    wire = mp_job(MP_PROCS, "sharded_ps_bench", ["--compute", "jit"])
    for r in wire:
        check(r["event"] == "done" and r["compute"] == "jit(cuda)"
              and r["frames_dropped"] == 0, f"phase 30c: {r}")
    out["30c"] = {"rows_per_sec": [r["rows_per_sec"] for r in wire],
                  "wire_bytes_per_row_moved": [
                      r["wire_bytes_per_row_moved"] for r in wire],
                  "mesh_30a_adagrad_float32_rows_per_sec":
                      runs["adagrad_float32"]["rows_per_sec"],
                  "mesh_30a_collective_bytes_per_row_moved":
                      runs["adagrad_float32"][
                          "collective_bytes_per_row_moved"],
                  "s": round(time.perf_counter() - t0, 1)}
    print(f"the wire bench, {MP_PROCS} launched processes with --compute "
          f"jit on {card} (phase 30c), beside 30a's adagrad/float32: "
          + json.dumps(out["30c"]), flush=True)
    print("K1-K4 on phase 30's path: none launched (a wave is PyTorch's "
          "index_add_, elementwise kernels and copies; the pulls read the "
          "host mirror)", flush=True)
    return out


def bench_line(bench, argv: list) -> tuple:
    """``sharded_ps_bench.main(argv)`` in this process: its exit code and
    the last JSON line it printed (a done line, or a drill's stamp)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench.main(argv)
    return rc, json.loads([ln for ln in buf.getvalue().splitlines()
                           if ln.startswith("{")][-1])


def mesh_cards(torch, n: int, card: str) -> dict:
    """``--ranks n``'s phase 30: the mesh plane with n ranks on n cards
    (``torch.cuda.nccl``), float32 sgd and adam at the bench's defaults,
    and its states and ``MeshAggregator``'s device tier against the same
    ranks on card 0 alone, within MESH_CARDS_TOL."""
    t0 = time.perf_counter()
    cards = [torch.device("cuda", i) for i in range(n)]
    runs = {u: mesh_bench(torch, ["--plane", "mesh", "--mesh-ranks", str(n),
                                  "--updater", u])
            for u in ("sgd", "adam")}
    gaps = {}
    for upd, dep in (("sgd", "dense"), ("adam", "sparse")):
        same, gap = state_gap(mesh_schedule(cards, upd, "float32", dep),
                              mesh_schedule([cards[0]] * n, upd,
                                            "float32", dep))
        check(gap <= MESH_CARDS_TOL, f"phase 30 on {n} cards: {upd} "
              f"states against one card: max abs {gap}")
        gaps[f"{upd}_{dep}"] = {"bitwise": same, "max_abs": gap}
    for comm in ("float32", "blk8"):
        spread, st = agg_rounds(cards, comm)
        one, _ = agg_rounds([cards[0]] * n, comm)
        g = agg_gaps(spread, one)
        check(st["backend"] == "mesh" and st["slots"] == n
              and g["max_abs"] <= MESH_CARDS_TOL
              and g["max_abs_rows_plus_residual_vs_host_kernel"] <= 1e-4,
              f"phase 30 on {n} cards: aggregator {comm}: {st}, {g}")
        gaps[f"aggregator_{comm}"] = g
    out = {"runs": runs, "against_one_card": gaps,
           "s": round(time.perf_counter() - t0, 1)}
    print(f"mesh plane, {n} ranks on {n} cards ({card}) through "
          "torch.cuda.nccl "
          "(phase 30; rows/s per rank and the rest as 30a; states and the "
          "aggregator against the same ranks on card 0): "
          + json.dumps(out), flush=True)
    return out


def cs_in_process(argv: list) -> dict:
    """``multihost_example.main(argv)`` in this process (world one, on
    ``cuda:0``), its done line parsed."""
    import contextlib
    import io

    from minips_tpu_torch.apps import multihost_example

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = multihost_example.main(argv)
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    check(rc == 0 and lines, f"multihost_example {argv}: rc {rc}, output "
          f"{buf.getvalue()[-2000:]}")
    return json.loads(lines[-1])


def cs_convert(torch, root: str) -> dict:
    """31e's ``convert_checkpoint``: a trained dense (adagrad) and sparse
    (adam) table on the card, native -> orbax (DCP) -> native, each leg
    restored into fresh tables; every state leaf bit-identical."""
    import numpy as np

    from minips_tpu_torch.ckpt import convert_checkpoint, make_checkpointer
    from minips_tpu_torch.tables.dense import DenseTable
    from minips_tpu_torch.tables.sparse import SparseTable

    dev = torch.device("cuda", 0)

    def tables():
        return {"d": DenseTable({"w": torch.zeros(1000, device=dev)},
                                updater="adagrad", lr=0.1, device=dev),
                "s": SparseTable(1 << 12, 8, updater="adam", lr=0.01,
                                 seed=3, device=dev)}

    live = tables()
    rng = np.random.default_rng(0)
    for _ in range(3):
        live["d"].push({"w": torch.as_tensor(
            rng.normal(size=1000).astype(np.float32), device=dev)})
        keys = rng.integers(0, 1 << 20, 256)
        live["s"].push(keys, torch.as_tensor(
            rng.normal(size=(256, 8)).astype(np.float32), device=dev))
    want = {k: t.state_dict() for k, t in live.items()}
    shutil.rmtree(root, ignore_errors=True)
    make_checkpointer(os.path.join(root, "native"), live,
                      backend="native").save(5)
    step = convert_checkpoint(os.path.join(root, "native"),
                              os.path.join(root, "dcp"), tables(),
                              src_backend="native", dst_backend="orbax")
    fresh = tables()
    make_checkpointer(os.path.join(root, "dcp"), fresh,
                      backend="orbax").restore()
    back = convert_checkpoint(os.path.join(root, "dcp"),
                              os.path.join(root, "native2"), tables(),
                              src_backend="orbax", dst_backend="native")
    again = tables()
    make_checkpointer(os.path.join(root, "native2"), again,
                      backend="native").restore()
    for got in (fresh, again):
        for name, t in got.items():
            have = t.state_dict()
            for key, leaf in want[name].items():
                a, b = have[key], leaf
                same = (all(np.array_equal(x, y) for x, y in zip(a, b))
                        if isinstance(a, list) else np.array_equal(a, b))
                check(same, f"phase 31e convert: {name}.{key} differs")
    shutil.rmtree(root, ignore_errors=True)
    return {"step": step, "back": back, "tables": sorted(want)}


def consistency_phase(torch, card: str) -> dict:
    """Phase 31: the collective consistency plane and multi-host on the
    card (module docstring). Returns the kernel launches of its paths."""
    out = {}
    # ---- 31a: BASELINE config 2 through SSPTrainer, 3 processes
    t0 = time.perf_counter()
    mlp = mp_job(CS_MLP_PROCS, "ssp_lr_example", [
        "--model", "mlp", "--mode", "ssp", "--staleness", str(CS_SSP)])
    for r in mlp:
        check(r["event"] == "done" and r["device"] == "cuda:0",
              f"phase 31a: rank {r.get('rank')}: {r}")
        check(r["max_skew_seen"] <= CS_SSP + 1, f"phase 31a: rank "
              f"{r['rank']} skew {r['max_skew_seen']} > {CS_SSP + 1}")
        check(math.isfinite(r["loss_last"])
              and r["loss_last"] < r["loss_first"], f"phase 31a: rank "
              f"{r['rank']} loss {r['loss_first']} -> {r['loss_last']}")
    for key in ("param_sum", "param_norm"):
        v = [r[key] for r in mlp]
        check(max(v) - min(v) < CS_FP_TOL, f"phase 31a: {key} {v}")
    out["31a"] = {
        "steps_per_s": [r["clock"] / r["wall_s"] for r in mlp],
        "gate_waits": [r["gate_waits"] for r in mlp],
        "max_skew": [r["max_skew_seen"] for r in mlp],
        "loss": [[r["loss_first"], r["loss_last"]] for r in mlp],
        "param_sum_spread": max(r["param_sum"] for r in mlp)
        - min(r["param_sum"] for r in mlp),
        "s": time.perf_counter() - t0}
    print(f"BASELINE config 2 (3-layer MLP, SSP s = {CS_SSP}) through "
          f"SSPTrainer on {CS_MLP_PROCS} processes sharing {card} "
          "(phase 31a; steps/s = clock / wall_s): " + json.dumps(out["31a"]),
          flush=True)
    # ---- 31b and 31c side by side (neither reports a rate)
    t0 = time.perf_counter()
    wd, lr = side_by_side(
        lambda: mp_job(CS_PROCS, "multihost_example", [
            "--model", "wd", "--mode", "ssp", "--staleness", str(CS_SSP),
            "--batch", str(CS_WD_BATCH)]),
        lambda: mp_job(CS_PROCS, "multihost_example",
                       ["--model", "lr", "--mode", "bsp"]))
    for r in wd:
        check(r["event"] == "done" and r["device"] == "cuda:0"
              and r["sync_backend"] == "gloo", f"phase 31b: {r}")
        k1 = r["kernel_launches"]["gather_rows"]
        check(k1 == 2 * len(r["losses"]), f"phase 31b: rank {r['rank']} "
              f"launched K1 {k1} times in {len(r['losses'])} steps")
        check(r["max_skew_seen"] <= CS_SSP + 1, f"phase 31b: {r}")
    fps = [r["param_fingerprint"] for r in wd]
    check(len(set(fps)) == 1, f"phase 31b: fingerprints {fps}")
    rounds = wd[0]["sync_rounds"]
    out["31b"] = {
        "k1_launches": [r["kernel_launches"]["gather_rows"] for r in wd],
        "sync_backend": wd[0]["sync_backend"], "sync_rounds": rounds,
        "union_rows_per_sync": wd[0]["union_rows"] / rounds,
        "row_merge_bytes_per_sync": wd[0]["row_merge_bytes"] / rounds,
        "union_wire_bytes_per_sync": wd[0]["union_wire_bytes"] / rounds,
        "sync_bytes_per_sync": wd[0]["sync_bytes"] / rounds,
        "sync_rows_max": wd[0]["sync_rows_max"],
        "num_slots": wd[0]["num_slots"],
        "fingerprints_equal": True, "fingerprint": fps[0],
        "gate_waits": [r["gate_waits"] for r in wd],
        "max_skew": [r["max_skew_seen"] for r in wd],
        "loss": [[r["loss_first"], r["loss_last"]] for r in wd]}
    oracle = cs_in_process(["--model", "lr", "--mode", "bsp",
                            "--oracle-hosts", str(CS_PROCS)])
    gaps, bitwise = [], True
    for r in lr:
        check(r["event"] == "done" and r["sync_hlo_has_all_reduce"]
              and r["sync_backend"] == "gloo", f"phase 31c: {r}")
        want = oracle["losses_per_host"][r["rank"]]
        gaps.append(max(abs(a - b) for a, b in zip(r["losses"], want)))
        fp = oracle["param_fingerprints"][r["rank"]]
        gaps.append(abs(r["param_fingerprint"] - fp))
        bitwise &= r["losses"] == want and r["param_fingerprint"] == fp
    check(max(gaps) <= CS_ORACLE_TOL, f"phase 31c: the 2-process run "
          f"against the oracle: gaps {gaps}")
    out["31c"] = {"max_gap": max(gaps), "bitwise": bitwise,
                  "sync_rounds": lr[0]["sync_rounds"],
                  "sync_bytes": lr[0]["sync_bytes"],
                  "loss": [[r["loss_first"], r["loss_last"]] for r in lr]}
    out["31bc_s"] = time.perf_counter() - t0
    print(f"Wide&Deep on the collective plane, SSP s = {CS_SSP}, B "
          f"{CS_WD_BATCH}, {CS_PROCS} processes sharing {card} (phase 31b): "
          + json.dumps(out["31b"]), flush=True)
    print(f"LR CollectiveSSP BSP on {CS_PROCS} processes against "
          f"--oracle-hosts {CS_PROCS} in this process (phase 31c, bound "
          f"{CS_ORACLE_TOL}): " + json.dumps(out["31c"]), flush=True)
    # ---- 31d: ring flash at world one, K2-K4 counted in this process
    from minips_tpu_torch.ops import flash_attention as tfa
    from minips_tpu_torch.ops.gather import gather_rows

    t0 = time.perf_counter()
    names = ("flash_forward", "flash_bwd_dq", "flash_bwd_dkv")
    for name in names:
        getattr(tfa, name).launches = 0
    lm = cs_in_process(["--mode", "fused", "--model", "lm", "--sp-attn",
                        "flash", "--iters", str(CS_LM_ITERS)])
    launches = {name: getattr(tfa, name).launches for name in names}
    for name in names:
        check(launches[name] == CS_LM_DEPTH * CS_LM_ITERS, "phase 31d: "
              f"{name} launched {launches[name]} times in {CS_LM_ITERS} "
              f"steps of {CS_LM_DEPTH} blocks")
    check(lm["device"] == "cuda:0" and all(map(math.isfinite, lm["losses"]))
          and lm["loss_last"] < lm["loss_first"], f"phase 31d: {lm}")
    out["31d"] = {"launches": launches, "loss": [lm["loss_first"],
                                                 lm["loss_last"]],
                  "step_ms": 1000 * lm["loop_s"] / CS_LM_ITERS,
                  "s": time.perf_counter() - t0}
    print(f"multihost_example --mode fused --model lm --sp-attn flash at "
          f"world one on {card} (phase 31d; step_ms = the training loop's "
          "time over its steps): " + json.dumps(out["31d"]),
          flush=True)
    # ---- 31e: the sharded checkpoint drill (DCP) and convert_checkpoint
    t0 = time.perf_counter()
    root = os.path.join(REPO, "build", "chip_smoke_dcp")
    shutil.rmtree(root, ignore_errors=True)
    k1 = gather_rows.launches
    drill = cs_in_process(["--mode", "fused", "--iters", "10",
                           "--checkpoint-dir", os.path.join(root, "mh"),
                           "--save-at", "5"])
    check(drill["ckpt_roundtrip_ok"] is True, f"phase 31e: {drill}")
    conv = cs_convert(torch, os.path.join(root, "conv"))
    check(gather_rows.launches == k1, "phase 31e: K1 launched off its path")
    out["31e"] = {"ckpt_roundtrip_ok": True, "convert": conv,
                  "s": time.perf_counter() - t0}
    shutil.rmtree(root, ignore_errors=True)
    print("the DCP checkpoint drill and convert_checkpoint on the card "
          "(phase 31e): " + json.dumps(out["31e"]), flush=True)
    return {"k1": {f"cssp_wd_ssp_rank{r['rank']}":
                   r["kernel_launches"]["gather_rows"] for r in wd},
            "flash": {name: {"multihost_lm_fused_flash_ws1": launches[name]}
                      for name in names}}


def consistency_cards(n: int) -> dict:
    """``--ranks n``'s phase 31: Wide&Deep on the collective plane as n
    launched processes, one card each, through NCCL: ``--mode fused``
    held to the same job on one process, and ``--mode bsp`` (replicas
    equal) held to the same job on n processes that share card 0 through
    gloo; K1 in every process."""
    t0 = time.perf_counter()
    wd = ["--model", "wd", "--batch", "1024"]
    fused = mp_job(n, "multihost_example", ["--mode", "fused"] + wd)
    one = mp_job(1, "multihost_example", ["--mode", "fused"] + wd)
    bsp = mp_job(n, "multihost_example", ["--mode", "bsp"] + wd)
    shared = mp_job(n, "multihost_example", ["--mode", "bsp"] + wd,
                    env={"CUDA_VISIBLE_DEVICES": "0"})
    spread = [f"cuda:{i}" for i in range(n)]
    for job, backend, devices in ((fused, "nccl", spread),
                                  (bsp, "nccl", spread),
                                  (shared, "gloo", ["cuda:0"] * n)):
        for r in job:
            check(r["event"] == "done" and r["sync_backend"] == backend
                  and r["kernel_launches"]["gather_rows"] > 0,
                  f"phase 31 on {n} cards: {r}")
        check(sorted(r["device"] for r in job) == devices, f"phase 31 on "
              f"{n} cards: devices {[r['device'] for r in job]}")
    gap = max(abs(a - b) for r in fused
              for a, b in zip(r["losses"], one[0]["losses"]))
    check(gap <= CS_FUSED_TOL, f"phase 31 fused wd on {n} cards against "
          f"one process: loss gap {gap}")
    fps = [r["param_fingerprint"] for r in bsp]
    check(len(set(fps)) == 1, f"phase 31 bsp wd on {n} cards: {fps}")
    by_rank = {r["rank"]: r for r in shared}
    bsp_gap = max(abs(a - b) for r in bsp for a, b in
                  zip(r["losses"], by_rank[r["rank"]]["losses"], strict=True))
    fp_one = shared[0]["param_fingerprint"]
    fp_gap = abs(fps[0] - fp_one) / abs(fp_one)
    check(bsp_gap <= CS_BSP_TOL and fp_gap <= CS_BSP_FP_RTOL, "phase 31 bsp "
          f"wd on {n} cards against {n} processes on card 0: loss gap "
          f"{bsp_gap} (bound {CS_BSP_TOL}), fingerprint {fps[0]} against "
          f"{fp_one}, {fp_gap} of it (bound {CS_BSP_FP_RTOL})")
    out = {"fused_loss_gap": gap,
           "bsp_loss_gap_to_shared_card": bsp_gap,
           "bsp_fingerprint_rel_gap_to_shared_card": fp_gap,
           "fused_k1": [r["kernel_launches"]["gather_rows"] for r in fused],
           "bsp_k1": [r["kernel_launches"]["gather_rows"] for r in bsp],
           "bsp_sync_bytes": bsp[0]["sync_bytes"],
           "bsp_union_rows_per_sync": bsp[0]["union_rows"]
           / bsp[0]["sync_rounds"],
           "s": time.perf_counter() - t0}
    print(f"Wide&Deep on the collective plane on {n} cards through NCCL "
          f"(phase 31; bsp against {n} processes on card 0 through gloo, "
          f"bounds {CS_BSP_TOL} and {CS_BSP_FP_RTOL}): " + json.dumps(out),
          flush=True)
    return out


def multiproc_cards(n: int) -> dict:
    """``--ranks n``'s phase 28a: Wide&Deep's BSP job as n launched
    processes, one card each, beside MP_PROCS processes that share card 0,
    in the same call; the contracts on both, samples/s in all."""
    t0 = time.perf_counter()
    wd = ["--exec", "multiproc", "--num_iters", str(MP_ITERS)]
    shared = mp_job(MP_PROCS, "wide_deep_example", wd,
                    env={"CUDA_VISIBLE_DEVICES": "0"})
    spread = mp_job(n, "wide_deep_example", wd)
    check(sorted(r["device"] for r in spread)
          == [f"cuda:{i}" for i in range(n)], "phase 28a on "
          f"{n} cards: devices {[r['device'] for r in spread]}")
    check(all(r["device"] == "cuda:0" for r in shared), "phase 28a on one "
          f"card: devices {[r['device'] for r in shared]}")
    mp_contracts(f"phase 28a BSP on {n} cards", spread, skew=1)
    mp_contracts("phase 28a BSP on one card", shared, skew=1)
    rates = {f"{n}_processes_{n}_cards": mp_rates(spread, 1024),
             f"{MP_PROCS}_processes_1_card": mp_rates(shared, 1024)}
    print(f"multiproc Wide&Deep BSP, samples/s in all (phase 28a, "
          f"{time.perf_counter() - t0:.1f} s): " + json.dumps(
              {k: v["samples_per_s_all"] for k, v in rates.items()})
          + "; in full: " + json.dumps(rates), flush=True)
    return rates


# phase 32: the profiling tooling (utils/profiling.py, trace_analysis.py,
# comm_analysis.py) over paths that launch K1-K4. 32a: TrainLoop's
# profile window of TL_ITERS steps of the Wide&Deep spmd step and of
# lm_example at phase 18's full width; each kernel's count in the trace's
# device table equal to its launch counter over the window's steps, and the
# table's busy time per step within TL_BUSY_TOL of device_time's over the
# same capture. 32b: CollectiveSSP syncs of a TL_SYNC_LEN-element LR delta
# through an NCCL group of one on each wire, the profiled traffic equal to
# SyncPlane.plan's. --ranks N: the sharded SparseTable's traffic
# invariants on N NCCL ranks (TL_SLOTS tables 64x apart, TL_BATCHES)
TL_ITERS, TL_WINDOW = 14, (10, 13)  # TrainLoop's default profile window
TL_BUSY_TOL = 0.10
TL_SYNC_LEN = 1 << 20
TL_SYNC_COMMS = ("float32", "bfloat16", "int8")
TL_SLOTS, TL_BATCHES = (1 << 16, 1 << 22), (3072, 4 * 3072)
K1_RE = r"\bgather_(narrow|rows)_kernel\b"
FLASH_RE = {"flash_forward": r"\bflash_fwd\w*_kernel\b",
            "flash_bwd_dq": r"\bflash_bwd_dq\w*_kernel\b",
            "flash_bwd_dkv": r"\bflash_bwd_dkv\w*_kernel\b"}
SYNC_KIND = {"all_reduce": "all-reduce", "all_to_all": "all-to-all",
             "all_gather": "all-gather"}


def watched_window(torch, run, counters):
    """``run()`` (an app's ``run`` whose TrainLoop has ``profile_dir``)
    with the loop's ``StepWindowProfiler`` watched: the launch counters
    and the host clock read as its window opens and as it closes.
    Returns (run's result, the window's profiler, its launches by kernel,
    its wall ms)."""
    from minips_tpu_torch.train import loop as tloop

    base = tloop.StepWindowProfiler
    seen: dict = {}

    class Watched(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen["window"] = self

        def on_step(self, step):
            if (step == self.start and self._ctx is None) or (
                    step == self.stop and self._ctx is not None):
                torch.cuda.synchronize()
                seen[step] = (counters(), time.perf_counter())
            super().on_step(step)

    tloop.StepWindowProfiler = Watched
    try:
        out = run()
    finally:
        tloop.StepWindowProfiler = base
    w = seen["window"]
    check(w.start in seen and w.stop in seen and w.profile is not None,
          f"phase 32a: the profile window [{w.start}, {w.stop}) did not "
          "open and close inside the run")
    (c0, t0), (c1, t1) = seen[w.start], seen[w.stop]
    return out, w, {k: c1[k] - c0[k] for k in c0}, 1e3 * (t1 - t0)


def unmatched_launches(path: str) -> list:
    """How many of the host's kernel launches, copies and fills in a
    capture have no device event (matched by correlation id), then the
    first and last 8 of them with their distance from the capture's
    edges."""
    import gzip

    with gzip.open(path, "rt") as f:
        ev = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    kept = {e.get("args", {}).get("correlation") for e in ev
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")}
    t0 = min(float(e["ts"]) for e in ev)
    t1 = max(float(e["ts"]) + float(e.get("dur", 0.0)) for e in ev)
    lost = [(e["name"], round(float(e["ts"]) - t0, 1),
             round(t1 - float(e["ts"]), 1)) for e in ev
            if e.get("cat") in ("cuda_runtime", "cuda_driver")
            and re.search("Launch|Memcpy|Memset", e["name"])
            and e.get("args", {}).get("correlation") not in kept]
    return [len(lost)] + lost[:8] + lost[-8:]


def window_tables(torch, tag, window, launches, patterns, wall_ms):
    """32a's checks on one profiled window: each kernel of ``patterns``
    in the trace's device table as often as its counter rose over the
    window, and the table's busy time within TL_BUSY_TOL of
    ``device_time``'s over the same capture."""
    from minips_tpu_torch.utils import trace_analysis as ta

    steps = window.stop - window.start
    out = ta.summarize(window.log_dir, top=10 ** 6)
    check(out.get("source") == "device", f"phase 32a {tag}: {out}")
    seen = {k: sum(o["count"] for o in out["ops"]
                   if re.search(pat, o["name"]))
            for k, pat in patterns.items()}
    for k, want in launches.items():
        check(want > 0 and seen[k] == want, f"phase 32a {tag}: {k} seen "
              f"{seen[k]} times in the trace's device table, launched "
              f"{want} times over the window's {steps} steps; the count "
              "of launches without a device event, then the first and last "
              "8 as (name, us from the capture's start, us to its end): "
              + json.dumps(unmatched_launches(out["trace_file"])))
    dev = device_breakdown(torch, window.profile, steps, wall_ms / steps)
    busy_ms = out["busy_us"] / 1e3 / steps
    gap = abs(busy_ms - dev["device_busy_ms"]) / dev["device_busy_ms"]
    check(gap <= TL_BUSY_TOL, f"phase 32a {tag}: the trace's busy time "
          f"{busy_ms} ms a step against device_time's "
          f"{dev['device_busy_ms']} ms over the same capture")
    row = {"steps": steps, "launches": launches, "seen": seen,
           "busy_ms_per_step": busy_ms,
           "device_time_busy_ms_per_step": dev["device_busy_ms"],
           "busy_gap": gap,
           "trace_top": [{"name": o["name"][:80],
                          "ms": o["total_us"] / 1e3 / steps,
                          "calls": o["count"] / steps}
                         for o in out["ops"][:8]],
           "device_time_top": dev["top"][:8],
           "trace_file": out["trace_file"]}
    return row


def tooling_phase(torch, dev, card: str) -> dict:
    """Phase 32: the profiling tooling on the card. 32a:
    ``--profile_dir`` over the Wide&Deep spmd app (K1, 2 a step) and
    ``lm_example`` at phase 18's full width (K2-K4), each window's device
    table against the launch counters and ``device_time``; 32b: a
    profiled ``CollectiveSSP`` sync through an NCCL group of one on each
    wire against ``SyncPlane.plan``; 32c: ``obs.merge --xla`` of phase
    27's rank traces with 32a's Wide&Deep capture."""
    import argparse
    import copy
    import glob

    import torch.distributed as dist

    from minips_tpu_torch.apps import lm_example as lmx
    from minips_tpu_torch.apps import wide_deep_example as wdx
    from minips_tpu_torch.core import config as tcfg
    from minips_tpu_torch.ops import flash_attention as tfa
    from minips_tpu_torch.ops.gather import gather_rows
    from minips_tpu_torch.utils.metrics import MetricsLogger

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import torch_comm_analysis_ranks as tranks

    root = os.path.join(REPO, "build", "chip_smoke_tooling")
    shutil.rmtree(root, ignore_errors=True)
    out: dict = {}
    # ---- 32a: Wide&Deep spmd, K1
    t0 = time.perf_counter()
    cfg = copy.deepcopy(wdx.DEFAULT)
    cfg.train.num_iters, cfg.train.log_every = TL_ITERS, 0
    wd_dir = os.path.join(root, "wide_deep")
    args = argparse.Namespace(
        exec_mode="spmd", model="widedeep", eval_frac=None,
        dtype="float32", device=str(dev), data_file=None, stream=False,
        profile_dir=wd_dir)
    res, win, launches, wall = watched_window(
        torch, lambda: wdx.run(cfg, args, MetricsLogger(None,
                                                        verbose=False)),
        lambda: {"gather_rows": gather_rows.launches})
    check(len(res["losses"]) == TL_ITERS
          and all(map(math.isfinite, res["losses"])), f"phase 32a: {res}")
    check(launches["gather_rows"] == 2 * (win.stop - win.start),
          f"phase 32a: Wide&Deep launched K1 {launches} times in "
          f"{win.stop - win.start} steps")
    out["32a_wide_deep"] = window_tables(torch, "Wide&Deep", win, launches,
                                         {"gather_rows": K1_RE}, wall)
    print(f"TrainLoop(profile_dir=...) over Wide&Deep spmd on {card} "
          f"(phase 32a, window {TL_WINDOW} of {TL_ITERS} steps; "
          "host times with the profiler on): "
          + json.dumps(out["32a_wide_deep"]), flush=True)
    # ---- 32a: lm_example at phase 18's full width, K2-K4
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    lm_dir = os.path.join(root, "lm")
    lcfg = tcfg.Config(
        table=tcfg.TableConfig(name="lm", kind="dense", updater="adam",
                               lr=APP_LM_LR),
        train=tcfg.TrainConfig(batch_size=LM_B, num_iters=TL_ITERS,
                               log_every=0, seed=0))
    largs = argparse.Namespace(device=dev, profile_dir=lm_dir,
                               **APP_LM_FLAGS)
    res, win, launches, wall = watched_window(
        torch, lambda: lmx.run(lcfg, largs, MetricsLogger(None,
                                                          verbose=False)),
        lambda: {k: getattr(tfa, k).launches for k in FLASH_RE})
    steps = win.stop - win.start
    want = want_launches("dots", LM_DEPTH, steps)
    check(launches == want, f"phase 32a: lm_example launched {launches} "
          f"in {steps} steps, expected {want}")
    check(all(map(math.isfinite, res["losses"])), f"phase 32a: {res}")
    del res
    out["32a_lm"] = window_tables(torch, "lm_example", win, launches,
                                  FLASH_RE, wall)
    print(f"TrainLoop(profile_dir=...) over lm_example at full width on "
          f"{card} (phase 32a, window {TL_WINDOW} of {TL_ITERS} "
          "steps; host times with the profiler on): "
          + json.dumps(out["32a_lm"]), flush=True)
    out["32a_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # ---- 32b: profiled CollectiveSSP syncs through an NCCL group of one
    t0 = time.perf_counter()
    check(not dist.is_initialized(), "phase 32b: a process group is "
          "already up in this process")
    store = os.path.join(root, "store")
    os.makedirs(root, exist_ok=True)
    dist.init_process_group("nccl", store=dist.FileStore(store, 1), rank=0,
                            world_size=1, device_id=dev)
    try:
        syncs = {}
        for comm in TL_SYNC_COMMS:
            r = tranks.cssp_sync_traffic(dist.group.WORLD, dev, comm,
                                         TL_SYNC_LEN, root)
            plan = [(SYNC_KIND[p["op"]], p["bytes"]) for p in r["plan"]]
            seen = [(o["kind"], o["bytes"]) for o in r["observed"]["ops"]]
            check(seen == plan and r["plan"][0]["backend"] == "nccl"
                  and r["bytes"] == r["observed"]["total_bytes"],
                  f"phase 32b {comm}: observed {seen}, planned {plan}, "
                  f"counted {r['bytes']} bytes")
            syncs[comm] = {"ops": r["observed"]["ops"],
                           "total_bytes": r["observed"]["total_bytes"]}
    finally:
        dist.destroy_process_group()
    out["32b"] = {"length": TL_SYNC_LEN, "syncs": syncs,
                  "s": time.perf_counter() - t0}
    print(f"profiled CollectiveSSP syncs through an NCCL group of one on "
          f"{card} (phase 32b), equal to SyncPlane.plan on each wire: "
          + json.dumps(out["32b"]), flush=True)
    # ---- 32c: obs.merge --xla of phase 27's rank traces and 32a's capture
    t0 = time.perf_counter()
    traces = sorted(d for d in glob.glob(os.path.join(
        REPO, "build", "chip_smoke_cp", "*", "trace"))
        if not d.endswith("_drill" + os.sep + "trace")
        and glob.glob(os.path.join(d, "trace-rank*.json")))
    check(bool(traces), "phase 32c: no rank trace of phase 27 left")
    merged = os.path.join(root, "merged_trace.json")
    proc = subprocess.run(
        [sys.executable, "-m", "minips_tpu_torch.obs.merge", traces[0],
         "--xla", wd_dir, "-o", merged], capture_output=True, text=True,
        timeout=300, cwd=REPO)
    summary = json.loads(proc.stdout.strip().splitlines()[-1]) \
        if proc.returncode == 0 and proc.stdout.strip() else {}
    check(summary.get("xla_events", 0) > 0 and summary.get("ranks"),
          f"phase 32c: merge --xla rc {proc.returncode}: "
          f"{proc.stdout[-500:]} {proc.stderr[-1500:]}")
    out["32c"] = {"rank_traces": traces[0], "ranks": summary["ranks"],
                  "events": summary["events"],
                  "xla_events": summary["xla_events"],
                  "flows_linked": summary["flows_linked"],
                  "s": time.perf_counter() - t0}
    print("obs.merge --xla of phase 27's rank traces with 32a's Wide&Deep "
          "capture (phase 32c): " + json.dumps(out["32c"]), flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return out


def tooling_cards(n: int) -> dict:
    """``--ranks n``'s phase 32: the range-sharded ``SparseTable``'s
    collective traffic on n NCCL ranks, one card each, read off profiled
    pulls and pushes: the group's bytes the same for tables 64x apart,
    linear in the batch, and no op with a table's or a shard's row count
    in its dims (``tests/test_torch_comm_analysis.py`` on gloo)."""
    from minips_tpu_torch.parallel.mesh import run_ranks

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import torch_comm_analysis_ranks as tranks

    t0 = time.perf_counter()
    root = os.path.join(REPO, "build", "chip_smoke_traffic")
    shutil.rmtree(root, ignore_errors=True)
    got = run_ranks(tranks.sparse_table_traffic, n, TL_SLOTS, TL_BATCHES,
                    root, timeout=GROUP_TIMEOUT_S,
                    store_dir=os.path.join(REPO, "build",
                                           "chip_smoke_store"))
    small, large = TL_SLOTS
    b1, b4 = TL_BATCHES
    rows = {}
    for leg in ("pull", "push"):
        tot = {key: sum(b for r in got for _, b, _ in r[leg][key])
               for key in got[0][leg]}
        check(tot[(small, b1)] == tot[(large, b1)] > 0,
              f"--ranks {n} phase 32: {leg} bytes grew with the table: "
              f"{tot[(small, b1)]} -> {tot[(large, b1)]}")
        check(3 * tot[(small, b1)] < tot[(small, b4)]
              <= 4 * tot[(small, b1)] + 1024 * n,
              f"--ranks {n} phase 32: {leg} bytes not linear in the "
              f"batch: {tot[(small, b1)]} -> {tot[(small, b4)]}")
        for r in got:
            for (slots, _), ops in r[leg].items():
                check(ops and all(
                    slots not in d and slots // n not in d
                    for _, _, dims in ops for d in dims),
                    f"--ranks {n} phase 32: a table-sized {leg} op: {ops}")
        rows[leg] = {f"{s}x{b}": v for (s, b), v in tot.items()}
    shutil.rmtree(root, ignore_errors=True)
    out = {"group_bytes": rows, "s": time.perf_counter() - t0}
    print(f"the sharded SparseTable's traffic on {n} NCCL ranks, one card "
          f"each (phase 32; group bytes by table slots x batch, profiled): "
          + json.dumps(out), flush=True)
    return out


def multi_card_main(torch, n: int) -> int:
    """``chip_smoke.py --ranks n``: phases 22-23 and the parameter server's
    phases 24-26 alone, on n cards of one machine, one rank each through
    NCCL (the ring's rotations, the layouts' and the tables' collectives
    between cards): each layout's step time, tokens/s and peak memory on
    rank 0, and its checks on every rank; then the LR + MLP pair at
    65,536 rows per card and at 65,536 in all, Wide&Deep spmd and threaded
    (rank 0 driving n workers) and the ``lr_example`` resume, with
    samples/s in all and per card beside one card's, measured in the same
    call, and K1's launches on every rank."""
    from minips_tpu_torch.ops import _build
    from minips_tpu_torch.parallel.mesh import run_ranks

    check(torch.cuda.device_count() >= n, f"--ranks {n}: only "
          f"{torch.cuda.device_count()} cards")
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    for line in cards[:n]:
        print(f"card: {line}", flush=True)
    t0 = time.perf_counter()
    _build.build_all(["gather_rows", "flash_attn", "row_adagrad",
                      "adam_apply"])
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    par = run_ranks(parallel_phases, n,
                    {"card": " | ".join(sorted(set(cards[:n]))), "b": LM_B,
                     "t": LM_T, "dim": LM_DIM, "depth": LM_DEPTH,
                     "heads": LM_DIM // 64},
                    timeout=GROUP_TIMEOUT_S,
                    store_dir=os.path.join(REPO, "build",
                                           "chip_smoke_store"))[0]
    print(f"lm_example layouts on {n} cards, by layout [step ms, tokens/s "
          f"of all cards, rank 0's peak GB] (phases 22-23, "
          f"{time.perf_counter() - t0:.1f} s): " + json.dumps(
              {k: [r["step_ms"], r["tokens_per_s"], r["peak_mem_gb"]]
               for k, r in par["rows"].items()}), flush=True)
    t0 = time.perf_counter()
    appg = run_ranks(app_group_phases, n, {
        "card": " | ".join(sorted(set(cards[:n]))), "wd_workers": n,
        "spmd_apps": ("wide_deep",), "pair_batches": (B * n, B),
        "ckpt_root": os.path.join(REPO, "build", "chip_smoke_ckpt_group")},
        timeout=GROUP_TIMEOUT_S,
        store_dir=os.path.join(REPO, "build", "chip_smoke_store"))
    head = appg[0]
    rates = {f"lrmlp_{gb}": [r["samples_per_s"], r["samples_per_s_per_gpu"],
                             r["one_card_samples_per_s"],
                             r["per_gpu_over_one_card"]]
             for gb, r in head["pair"].items()}
    rates.update({f"{k}_spmd": [r["samples_per_s"],
                                r["samples_per_s_per_gpu"],
                                r["samples_per_s_group_none"],
                                r["per_gpu_over_one_card"]]
                  for k, r in head["spmd"].items()})
    thr = head["threaded"]
    rates["wide_deep_threaded"] = [
        thr["samples_per_s"], thr["samples_per_s_per_gpu"],
        thr["samples_per_s_group_none"],
        thr["samples_per_s_per_gpu"] / thr["samples_per_s_group_none"]]
    print(f"parameter server on {n} cards, by path [samples/s in all, per "
          f"card, one card alone, per card over one card] (phases 24-26, "
          f"{time.perf_counter() - t0:.1f} s): " + json.dumps(rates),
          flush=True)
    print(f"K1 launches on each of the {n} ranks, by path: " + json.dumps(
        {k: [r["k1"][k] for r in appg] for k in head["k1"]}), flush=True)
    multiproc_cards(n)
    mesh_cards(torch, n, " | ".join(sorted(set(cards[:n]))))
    consistency_cards(n)
    tooling_cards(n)
    print("processes still running at the end, killed: "
          + json.dumps(stop_children()), flush=True)
    print(cards[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    import torch

    # ---------------------------------------------------------- 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on "
              "an NVIDIA card", file=sys.stderr)
        return 2
    adopt_orphans()
    sys.path.insert(0, REPO)
    if "--ranks" in sys.argv:
        return multi_card_main(
            torch, int(sys.argv[sys.argv.index("--ranks") + 1]))
    import numpy as np

    import argparse

    from minips_tpu_torch import interop
    from minips_tpu_torch.apps import lr_example as lrx
    from minips_tpu_torch.apps import mf_example as mfx
    from minips_tpu_torch.apps import wide_deep_example as wdx
    from minips_tpu_torch.apps import word2vec_example as w2vx
    from minips_tpu_torch.apps.common import holdout_split
    from minips_tpu_torch.data.movielens import read_ratings
    from minips_tpu_torch.models import mf as mf_model
    from minips_tpu_torch.apps.lm import build_lm
    from minips_tpu_torch.apps.lrmlp import build_lrmlp
    from minips_tpu_torch.data import synthetic
    from minips_tpu_torch.data.loader import (BatchIterator,
                                              prefetch_to_device)
    from minips_tpu_torch.ops import _build
    from minips_tpu_torch.ops.adam_apply import adam_apply
    from minips_tpu_torch.ops.gather import _launcher as gather_launcher
    from minips_tpu_torch.ops.gather import (gather_rows,
                                             gather_rows_reference)
    from minips_tpu_torch.tables.sparse import (SparseTable, hash_to_slots,
                                                hash_to_slots_np)

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = gpu_line()
    print(f"card: {card}", flush=True)
    mem_bw = next((bw for key, bw in MEM_BW if key in kind), 3.35e12)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"memory rate for bounds {mem_bw / 1e12} TB/s", flush=True)

    # ----------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    logs = _build.build_all(["gather_rows", "flash_attn", "row_adagrad",
                             "adam_apply"])
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.2f} s for {sorted(logs) or 'cached'}",
          flush=True)
    ptxas_by_kernel = {}
    for name, log in logs.items():
        for kernel, line in ptxas_lines(log):
            print(f"  ptxas {name} {kernel}: {line}")
            if kernel != "ptxas":
                ptxas_by_kernel.setdefault(kernel, []).append(line)
    if "flash_attn" in logs:
        spill_check(logs["flash_attn"])
    hgmma = tensor_core_check(_build)
    print("tensor cores: HGMMA instructions per flash kernel (SASS): "
          + json.dumps(hgmma), flush=True)
    print("gather: 128-bit global loads and calls per kernel (SASS): "
          + json.dumps(gather_sass_check(_build)), flush=True)

    # ------------------------------------- 3. kernels against plain versions
    rng = np.random.default_rng(0)
    S = 1 << 18
    n_main = B * 26
    max_err = 0.0
    bits = {4: torch.int32, 2: torch.int16}

    def compare(emb, slots):
        nonlocal max_err
        got = gather_rows(emb, slots)
        want = gather_rows_reference(emb, slots)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max()) \
            if want.numel() else 0.0
        max_err = max(max_err, err)
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"gather shape/dtype {tuple(got.shape)} {got.dtype}")
        as_bits = bits[emb.element_size()]
        check(torch.equal(got.view(as_bits), want.view(as_bits)),
              f"gather differs from its plain version: D={emb.shape[1]} "
              f"N={slots.numel()} {emb.dtype} storage offset "
              f"{slots.storage_offset()} max err {err}")

    def slot_view(n, off):
        """n slots as a view ``off`` elements into its buffer (the kernel
        copies the rows before the first 16-byte aligned slot one by one):
        random rows, with out-of-range and boundary slots inside the first
        two 4-slot groups and at the end, and a run of repeated rows."""
        vals = rng.integers(0, S, n)
        edge = [-4, S + 9, 0, S - 1, S - 1, 0, -1, S]
        vals[:min(n, 8)] = edge[:min(n, 8)]
        if n > 136:
            vals[8:72] = vals[72:136]
            vals[-3:] = (-7, S, S - 1)
        buf = torch.empty(n + off, dtype=torch.int32, device=dev)
        buf[off:] = torch.as_tensor(vals, dtype=torch.int32, device=dev)
        return buf[off:]

    cases = 0
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for d in GATHER_DIMS:
            emb = torch.randn((S, d), device=dev).to(dtype)
            for n in (*GATHER_SMALL_NS, n_main):
                for off in GATHER_OFFSETS:
                    compare(emb, slot_view(n, off))
                    cases += 1
    for d in (1, 8):  # [B, 26] field shapes, as the LR + MLP step has them
        compare(torch.randn((S, d), device=dev), torch.as_tensor(
            rng.integers(0, S, (B, 26)), dtype=torch.int32, device=dev))
        cases += 1
    # the Wide&Deep app's pulls on their own inputs: each hashed table's
    # shape and salt, a worker batch's [1024, 26] categorical keys and a
    # holdout chunk's [8192, 26], hashed as the table hashes them (a random
    # table of the same shape in place of the app's, whose wide rows start
    # at zero)
    _, wd_tables = wdx.build(wdx.DEFAULT, use_fm=False, device=dev)
    wd_data = synthetic.criteo_like(16384, seed=0)
    wd_bs = wdx.DEFAULT.train.batch_size
    wd_keys = (next(iter(BatchIterator(wd_data, wd_bs, seed=0)))["cat"],
               wd_data["cat"][:WD_EVAL_CHUNK])
    wd_cases = []
    for t in wd_tables[:2]:
        emb = torch.randn_like(t.emb)
        for keys in wd_keys:
            slots = t.slots_of(keys)
            compare(emb, slots)
            wd_cases.append((t.name, tuple(emb.shape), tuple(slots.shape)))
            cases += 1
    del wd_tables
    # the single-process apps' pulls on their own inputs, keyed as each
    # app's tables key them: LR sparse's [512, 14] feature ids into 2^16 x
    # 1; MF's identity-mapped user and item ids at MovieLens-20M's counts
    # ([1024] a step, [8192] a holdout chunk) into 2^18 x 9 and 2^15 x 9;
    # word2vec's [1024] centers and [1024, 1 + NEG] output keys (the
    # positive, then the negatives) into 2^14 x 64
    lr_data = synthetic.classification_sparse(8192, seed=0)
    ml_data = synthetic.movielens_like(MF_RATINGS, users=ML20M_USERS,
                                       items=ML20M_ITEMS, seed=0)
    mf_bs = mfx.DEFAULT.train.batch_size
    mf_batch = next(iter(BatchIterator(ml_data, mf_bs, seed=0)))
    mf_user_t, mf_item_t = mfx.make_tables(mfx.DEFAULT, ML20M_USERS,
                                           ML20M_ITEMS, dev)
    w2v_in, w2v_out = w2vx.make_tables(w2vx.DEFAULT, dev)
    w2v_b = next(w2vx.batch_gen(w2vx.DEFAULT, *w2vx.pairs(
        w2vx.DEFAULT, argparse.Namespace(data_file=None, subsample=0.0)), 0))
    w2v_out_keys = w2vx.out_keys(torch.as_tensor(w2v_b["pos"], device=dev),
                                 torch.as_tensor(w2v_b["neg"], device=dev))
    app_pulls = (
        ("lr_sparse", SparseTable(lrx.SPARSE_SLOTS, 1, device=dev),
         next(iter(BatchIterator(lr_data, lrx.DEFAULT.train.batch_size,
                                 seed=0)))["idx"]),
        ("mf_user", mf_user_t, mf_batch["user"]),
        ("mf_user", mf_user_t, ml_data["user"][:WD_EVAL_CHUNK]),
        ("mf_item", mf_item_t, mf_batch["item"]),
        ("mf_item", mf_item_t, ml_data["item"][:WD_EVAL_CHUNK]),
        ("w2v_in", w2v_in, w2v_b["center"]),
        ("w2v_out", w2v_out, w2v_out_keys))
    app_cases = []
    for name, t, keys in app_pulls:
        emb = torch.randn_like(t.emb)
        slots = t.slots_of(keys)
        compare(emb, slots)
        app_cases.append((name, tuple(emb.shape), tuple(slots.shape)))
        cases += 1
    # phase 9 times the gather at MF's step pull and word2vec's output pull
    app_timed = (("mf_user [1024] x 9", torch.randn_like(mf_user_t.emb),
                  mf_user_t.slots_of(mf_batch["user"])),
                 ("w2v_out [1024, 6] x 64", torch.randn_like(w2v_out.emb),
                  w2v_out.slots_of(w2v_out_keys)))
    del mf_user_t, mf_item_t, w2v_in, w2v_out, app_pulls
    print(f"gather_rows: {cases} cases bit-exact against the plain version "
          f"(D {GATHER_DIMS} x N {(*GATHER_SMALL_NS, n_main)} x slot views "
          f"{GATHER_OFFSETS} elements into their buffer x f32/bf16/f16; "
          "out-of-range and boundary slots inside 4-slot groups, repeated "
          f"rows; [{B}, 26] slots at D 1 and 8; the Wide&Deep pulls' hashed "
          f"keys, (table, rows, slots): {wd_cases}; the LR sparse, MF and "
          f"word2vec apps' pulls on their own keys: {app_cases})",
          flush=True)

    # ------------------------------------------------------------ 4. hash
    keys = np.concatenate([
        rng.integers(0, 1 << 31, 1 << 18),
        rng.integers(1 << 31, 1 << 32, 1 << 18),
        rng.integers(1 << 32, 1 << 62, 1 << 18),
        rng.integers(-(1 << 62), 0, 1 << 18)]).astype(np.int64)
    tkeys = torch.as_tensor(keys, device=dev)
    for salt in (0, 1, 2):
        got = hash_to_slots(tkeys, S, salt).cpu().numpy()
        check(got.dtype == np.int32, "hash slots must be int32")
        check(np.array_equal(got.astype(np.int64),
                             hash_to_slots_np(keys, S, salt)),
              f"hash differs from hash_to_slots_np at salt {salt}")
    print(f"hash: {keys.size} int64 keys (>= 2^31, >= 2^32, negative) "
          "bit-identical to hash_to_slots_np on the card", flush=True)

    # ------------------------------------------------------- 5. main path
    p = build_lrmlp(B, dev, seed=0)
    init = {
        "wide": interop.sparse_to_numpy(p.wide),
        "emb": interop.sparse_to_numpy(p.emb),
        "lin": interop.dense_to_numpy(p.lin),
        "deep": interop.dense_to_numpy(p.deep),
    }

    torch.cuda.synchronize()
    gather_rows.launches = 0
    losses = run_pair_steps(p, CHAIN)
    torch.cuda.synchronize()
    main_launches = {"gather_rows": gather_rows.launches}
    losses = [(float(a), float(b)) for a, b in losses]
    check(all(math.isfinite(x) for pair in losses for x in pair),
          f"non-finite loss: {losses}")
    check(losses[-1][0] < losses[0][0] and losses[-1][1] < losses[0][1],
          f"loss did not fall: first {losses[0]} last {losses[-1]}")
    check(main_launches["gather_rows"] == 2 * CHAIN,
          f"gather_rows launched {main_launches['gather_rows']} times in "
          f"{CHAIN} steps, expected {2 * CHAIN}")
    print(f"main path: {CHAIN} steps at B={B}; loss lr {losses[0][0]:.6f} "
          f"-> {losses[-1][0]:.6f}, mlp {losses[0][1]:.6f} -> "
          f"{losses[-1][1]:.6f}; launches {main_launches}", flush=True)

    cpu = build_lrmlp(B, "cpu", seed=0)
    interop.load_sparse(cpu.wide, init["wide"])
    interop.load_sparse(cpu.emb, init["emb"])
    interop.load_dense(cpu.lin, *init["lin"])
    interop.load_dense(cpu.deep, *init["deep"])
    cpu_losses = [(float(a), float(b)) for a, b in run_pair_steps(cpu, CPU_STEPS)]
    diff = max(abs(g - c) for gp, cp in zip(losses, cpu_losses)
               for g, c in zip(gp, cp))
    check(diff <= LOSS_TOL, f"card and CPU losses differ by {diff} > "
          f"{LOSS_TOL}: card {losses[:CPU_STEPS]} cpu {cpu_losses}")
    print(f"card vs CPU port, first {CPU_STEPS} steps from the same weights: "
          f"max |loss diff| {diff:.3e} (tolerance {LOSS_TOL})", flush=True)

    chain_s = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last = run_pair_steps(p, CHAIN)[-1]
        torch.cuda.synchronize()
        chain_s.append(time.perf_counter() - t0)
        check(all(math.isfinite(float(x)) for x in last), "non-finite loss")
    chain_med = statistics.median(chain_s)
    step = {"card": card, "batch": B, "chain": CHAIN, "reps": REPS,
            "step_ms": 1e3 * chain_med / CHAIN,
            "samples_per_s": B * CHAIN / chain_med,
            "chain_s": chain_s}
    print("step time on the card (LR + MLP pair, median of "
          f"{REPS} chains): " + json.dumps(step), flush=True)

    print("device time per step (torch.profiler): " + json.dumps(
        device_time(torch, lambda: run_pair_steps(p, PROFILED_STEPS),
                    PROFILED_STEPS, step["step_ms"])), flush=True)

    # ------------------------------------------------------------ 6. pull
    before = gather_rows.launches
    cats = p.batches[0]["cat"]
    rows = p.emb.pull(cats)
    want = gather_rows_reference(p.emb.emb, hash_to_slots(cats, S, 2))
    check(rows.shape == (B, 26, 8) and torch.equal(rows, want),
          "emb pull differs from emb[hash(keys)]")
    t128 = SparseTable(S, 128, name="wide128", seed=3, device=dev)
    k128 = torch.as_tensor(rng.integers(0, 1 << 40, B), device=dev)
    rows = t128.pull(k128)
    want = gather_rows_reference(t128.emb, hash_to_slots(k128, S, 0))
    check(rows.shape == (B, 128) and torch.equal(rows, want),
          "D=128 pull differs from emb[hash(keys)]")
    check(gather_rows.launches - before == 2,
          "pulls did not go through the gather kernel")
    print("pull: [65536, 26] keys at D=8 and 65536 keys at D=128 equal "
          "emb[hash(keys)], both through the kernel", flush=True)

    # ---------------------------------- 7. flash kernels vs plain versions
    from minips_tpu_torch.ops import flash_attention as tfa

    flash = ("flash_forward", "flash_bwd_dq", "flash_bwd_dkv")
    flash_err = dict.fromkeys(flash, 0.0)
    flash_rel = dict.fromkeys(flash, 0.0)

    def record(errs, rels):
        for name in flash:
            flash_err[name] = max(flash_err[name], errs[name])
            flash_rel[name] = max(flash_rel[name], rels[name])

    flash_cases = [  # (B, Tq, Tk, H, Hk, D, q_off, k_off)
        (2, 128, 128, 4, 4, 64, 0, 0),       # MHA
        (1, 256, 256, 8, 2, 64, 0, 0),       # GQA, g = 4
        (1, 128, 256, 4, 4, 64, 128, 0),     # global offsets, Tq != Tk
        (1, 64, 192, 4, 1, 128, 128, 64),    # offsets, MQA, D = 128
        (1, 100, 100, 8, 2, 40, 0, 0),       # ragged T, D = 40
        # Tq not a multiple of the bf16 K2/K3's 128-row Q tile: the second
        # warpgroup's rows end inside their tile
        (1, 192, 192, 8, 2, 64, 0, 0),       # GQA g = 4, D = 64
        (1, 192, 192, 8, 2, 128, 0, 0),      # GQA g = 4, D = 128
        # ragged Tq and Tk, offsets; the last 128-row K tile of the bf16 K4
        # ends inside its second warpgroup
        (2, 200, 328, 4, 2, 64, 128, 0),
        # Tk > Tq, no offset: under the causal mask K4's K tiles 1 and 2 see
        # no query (dK = dV = 0)
        (1, 128, 384, 8, 2, 64, 0, 0),
        (1, 130, 130, 2, 1, 72, 0, 0),       # D = 72: a second atom 8 wide
        # head dim 16: multihost_example's fixed LM (dim 32, 2 heads) at
        # its defaults, the shape phase 31d drives K2-K4 at
        CS_LM_CASE,
    ]
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (False, True):
            for case in flash_cases:
                record(*flash_errors(torch, tfa, case, dtype, causal,
                                     n_cases))
                n_cases += 1
    full = (LM_B, LM_T, LM_T, LM_DIM // 64, LM_DIM // 64, 64, 0, 0)
    record(*flash_errors(torch, tfa, full, torch.bfloat16, True, n_cases))
    # q/k/v as the LM block's views of its fused activation, read through
    # the bf16 kernels' tensor maps at the activation's strides
    view_cases = (full, (1, 192, 192, 8, 2, 64, 0, 0),
                  # the LM at GQA kv_heads 8 and at head dim 128
                  (LM_B, LM_T, LM_T, LM_DIM // 64, 8, 64, 0, 0),
                  (LM_B, LM_T, LM_T, LM_DIM // 128, LM_DIM // 128, 128,
                   0, 0),
                  CS_LM_CASE)  # phase 31d's LM at head dim 16
    for i, case in enumerate(view_cases):
        record(*flash_errors(torch, tfa, case, torch.bfloat16, True,
                             n_cases + 1 + i, views=True))
    n_cases += 1 + len(view_cases)
    print(f"flash kernels: {n_cases} cases against the plain versions "
          "(f32 and bf16, causal and not, MHA/GQA g=4/MQA, offsets, ragged "
          "T=100/130/200/328, Tq=192 and 200 against the 128-row Q tile, "
          "Tk=384 > Tq=128 causal, D 16/40/64/72/128, full width "
          f"{full} bf16 causal; bf16 causal q/k/v as views of the fused "
          f"activation at {list(view_cases)}), gradients with a nonzero lse "
          f"cotangent; max |err| {flash_err}, over max(1, max |value|) "
          f"{flash_rel}; tolerance {FLASH_TOL} of max(1, max |value|), lse "
          f"{LSE_TOL}; keys no query sees got dK = dV = 0 exactly; two more "
          "K4 launches bit-identical in every case", flush=True)

    # ------------------------------------------------------------ 8. LM path
    torch.cuda.reset_peak_memory_stats()
    lm = build_lm(LM_B, LM_T, dim=LM_DIM, depth=LM_DEPTH, device=dev, seed=0)

    torch.cuda.synchronize()
    gather_rows.launches = 0
    for name in flash:
        getattr(tfa, name).launches = 0
    adam_apply.launches = 0
    lm_losses = run_lm_steps(lm, LM_CHAIN)
    torch.cuda.synchronize()
    lm_launches = {name: getattr(tfa, name).launches for name in flash}
    lm_launches["gather_rows"] = gather_rows.launches
    lm_adam = adam_apply.launches
    check(lm_adam == LM_CHAIN, f"adam_apply launched {lm_adam} times in "
          f"{LM_CHAIN} LM steps")
    lm_losses = [float(x) for x in lm_losses]
    check(all(math.isfinite(x) for x in lm_losses),
          f"non-finite LM loss: {lm_losses}")
    check(lm_losses[-1] < lm_losses[0],
          f"LM loss did not fall: {lm_losses}")
    lm_want = want_launches(lm.remat, LM_DEPTH, LM_CHAIN)
    check({n: lm_launches[n] for n in flash} == lm_want,
          f"flash launches {lm_launches} in {LM_CHAIN} steps of {LM_DEPTH} "
          f"blocks at remat {lm.remat!r}, expected {lm_want}")
    print(f"LM path: {LM_CHAIN} steps at B={LM_B} T={LM_T} dim={LM_DIM} "
          f"depth={LM_DEPTH} heads={lm.heads} vocab={1 << 14}, bf16, "
          f"remat {lm.remat!r}, "
          f"{lm.table.num_keys} params; loss {lm_losses[0]:.6f} -> "
          f"{lm_losses[-1]:.6f} ({lm_losses}); launches {lm_launches}",
          flush=True)

    lm_chain_s = []
    for _ in range(LM_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last = run_lm_steps(lm, LM_CHAIN)[-1]
        torch.cuda.synchronize()
        lm_chain_s.append(time.perf_counter() - t0)
        check(math.isfinite(float(last)), "non-finite LM loss")
    lm_med = statistics.median(lm_chain_s)
    lm_step = {"card": card, "batch": LM_B, "seq": LM_T, "chain": LM_CHAIN,
               "reps": LM_REPS, "step_ms": 1e3 * lm_med / LM_CHAIN,
               "tokens_per_s": LM_B * LM_T * LM_CHAIN / lm_med,
               "chain_s": lm_chain_s,
               "opt_state_bytes": lm.opt_state_bytes,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "update_peak_gb": update_peak_gb(torch, lm.table)}
    print("LM step time on the card (median of "
          f"{LM_REPS} chains): " + json.dumps(lm_step), flush=True)
    print("LM device time per step (torch.profiler): " + json.dumps(
        device_time(torch, lambda: run_lm_steps(lm, LM_PROFILED_STEPS),
                    LM_PROFILED_STEPS, lm_step["step_ms"])), flush=True)

    # ---------------------------------- 19. decoding the trained LM (above)
    t0 = time.perf_counter()
    decoding = decode_phase(torch, dev, card, lm, mem_bw)
    phase_s = {"19": time.perf_counter() - t0}
    del lm

    small = dict(dim=256, depth=2, vocab=1024, seed=0)
    card_lm = build_lm(2, 256, device=dev, **small)
    state = interop.dense_to_numpy(card_lm.table)
    card_l = [float(x) for x in run_lm_steps(card_lm, CPU_STEPS)]
    cpu_lm = build_lm(2, 256, device="cpu", **small)
    interop.load_dense(cpu_lm.table, *state)
    cpu_l = [float(x) for x in run_lm_steps(cpu_lm, CPU_STEPS)]
    lm_diff = max(abs(a - b) for a, b in zip(card_l, cpu_l))
    check(lm_diff <= LM_LOSS_TOL, f"small LM: card and CPU losses differ by "
          f"{lm_diff} > {LM_LOSS_TOL}: card {card_l} cpu {cpu_l}")
    print(f"small LM (dim 256, depth 2, 4 heads, T 256, B 2, vocab 1024), "
          f"card vs CPU port, first {CPU_STEPS} steps from the same weights:"
          f" card {card_l} cpu {cpu_l}, max |loss diff| {lm_diff:.3e} "
          f"(tolerance {LM_LOSS_TOL})", flush=True)
    del card_lm, cpu_lm

    # ------------------------------------------------------------ 9. timings
    # K1 at the LR + MLP step's two gathers and at the D = 128 pull of
    # phase 6; warm (as in earlier runs) and cold (L2 flushed by a write of
    # GATHER_COLD_FLUSH_BYTES before each launch). The bound counts device
    # memory bytes, so its share is read from the cold time.
    flush = torch.empty(GATHER_COLD_FLUSH_BYTES, dtype=torch.uint8,
                        device=dev)
    shapes = []
    wide_slots = hash_to_slots(cats, S, 1).reshape(-1)
    for emb, slots, main, label in (
            (p.wide.emb, wide_slots, True, "the main path's (LR wide)"),
            (p.emb.emb, hash_to_slots(cats, S, 2).reshape(-1), True,
             "the main path's (MLP emb)"),
            (t128.emb, hash_to_slots(k128, S, 0), False,
             "the D=128 pull's"),
            *((emb, slots, False, f"the {name} app pull's")
              for name, emb, slots in app_timed)):
        n, d, item = slots.numel(), emb.shape[1], emb.element_size()
        flat = slots.reshape(-1)  # index_select takes one index dimension
        uniq = int(torch.unique(slots).numel())
        nbytes = n * 4 + uniq * d * item + n * d * item
        shape = {
            "D": d, "N": n, "main_path": main, "unique_rows": uniq,
            "shape": label, "slots_shape": list(slots.shape),
            "bytes": nbytes,
            "kernel_ms": time_ms(torch, lambda: gather_rows(emb, slots)),
            "cold_ms": time_ms(torch, lambda: gather_rows(emb, slots),
                               flush.zero_),
            "plain_ms": time_ms(torch,
                                lambda: gather_rows_reference(emb, slots)),
            "library_ms": time_ms(torch,
                                  lambda: torch.index_select(emb, 0, flat)),
            "library_cold_ms": time_ms(
                torch, lambda: torch.index_select(emb, 0, flat),
                flush.zero_),
            "bound_ms": 1e3 * nbytes / mem_bw,
        }
        # above 1 where L2 still holds part of the output when the kernel
        # ends (it is write-back): printed, not a gain. Biased low: the
        # flush leaves L2 full of dirty lines, whose write-back the launch
        # pays as it evicts them.
        shape["bound_share_cold"] = shape["bound_ms"] / shape["cold_ms"]
        shape["cold_after"] = (f"a write of {GATHER_COLD_FLUSH_BYTES >> 20} "
                               "MB (dirty lines in L2)")
        if main:  # a quarter of the rows, and 4 rows: the fixed cost
            quarter, four = slots[:n // 4], slots[:4]
            shape["quarter_n_cold_ms"] = time_ms(
                torch, lambda: gather_rows(emb, quarter), flush.zero_)
            shape["n4_ms"] = time_ms(torch, lambda: gather_rows(emb, four))
        shapes.append(shape)
        print(f"gather_rows at {label} shape: " + json.dumps(shape),
              flush=True)
    del flush, app_timed
    emb, slots = p.wide.emb, wide_slots
    rows_out = torch.empty((slots.numel(), 1), device=dev)
    launch_us = {
        "gather_rows_call_us": launch_cost_us(
            torch, lambda: gather_rows(emb, slots)),
        "ctypes_launch_us": launch_cost_us(torch, lambda: gather_launcher()(
            emb.data_ptr(), slots.data_ptr(), rows_out.data_ptr(),
            slots.numel(), S, 4, torch.cuda.current_stream().cuda_stream))}
    print("gather_rows launch cost on the host, D=1 main shape, stream held "
          "by a sleep kernel (the wrapper's call; the bare ctypes launch): "
          + json.dumps(launch_us), flush=True)
    main_shapes = [s for s in shapes if s["main_path"]]
    kernels = [{
        "name": "gather_rows", "route": "cuda",
        "source": "minips_tpu_torch/csrc/gather_rows.cu",
        "replaces": "minips_tpu/ops/pallas_kernels.py:69",
        "launches": main_launches["gather_rows"],
        "max_abs_err": max_err,
        # summed over one training step's two gathers (D=1 and D=8)
        **{k: sum(s[src] for s in main_shapes)
           for k, src in (("ms", "kernel_ms"), ("cold_ms", "cold_ms"),
                          ("plain_ms", "plain_ms"),
                          ("bound_ms", "bound_ms"),
                          ("library_ms", "library_ms"))},
        "bound_by": "bytes",
        "design": DESIGN["gather_rows"],
        "launch_us": launch_us,
        "shapes": shapes,
    }]

    # K2-K4 at the LM's shape: q, k, v strided views of one fused qkv
    # activation, as the block hands them over
    for name, row in flash_timings(torch, tfa, LM_B, LM_T, LM_DIM // 64,
                                   LM_DIM // 64, 64, mem_bw).items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": "minips_tpu_torch/csrc/flash_attn.cu",
            "replaces": FLASH_REPLACES[name],
            "launches": lm_launches[name],
            "max_abs_err": flash_err[name],
            **row, "design": DESIGN[name]})
        print(f"{name} at the LM's shape: " + json.dumps(kernels[-1]),
              flush=True)
    # ----------------------------- 33. the row Adagrad kernel at the CTR push
    t0 = time.perf_counter()
    row_adagrad = row_adagrad_phase(torch, dev, mem_bw)
    print(f"row_adagrad at the CTR push ({time.perf_counter() - t0:.1f} s): "
          + json.dumps(row_adagrad), flush=True)
    # ----------------------- 34. the Adam kernel at the LM cells' table sizes
    t0 = time.perf_counter()
    adam_row = adam_apply_phase(torch, dev, mem_bw, lm_adam)
    print(f"adam_apply at the LM tables ({time.perf_counter() - t0:.1f} s): "
          + json.dumps(adam_row), flush=True)
    # ------------------------------------------ 10. LM low-precision state
    from minips_tpu_torch.tables import updaters as tupd

    lm_paths = {"f32": dict(lm_launches,
                            opt_state_bytes=lm_step["opt_state_bytes"])}
    as_int = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    lowp = {}
    for opt, updater in (("bf16", "adam_bf16"), ("int8", "adam8")):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lm = build_lm(LM_B, LM_T, dim=LM_DIM, depth=LM_DEPTH, device=dev,
                      seed=0, opt_state=opt)
        torch.cuda.synchronize()
        for name in flash:
            getattr(tfa, name).launches = 0
        losses_o = [float(x) for x in run_lm_steps(lm, LM_CHAIN)]
        torch.cuda.synchronize()
        launches_o = {name: getattr(tfa, name).launches for name in flash}
        check(all(math.isfinite(x) for x in losses_o),
              f"non-finite LM loss at opt_state {opt}: {losses_o}")
        check(losses_o[-1] < losses_o[0],
              f"LM loss did not fall at opt_state {opt}: {losses_o}")
        check(launches_o == lm_want, f"flash launches {launches_o} in "
              f"{LM_CHAIN} steps at opt_state {opt}, expected {lm_want}")
        chain_o = []
        for _ in range(LM_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            last = run_lm_steps(lm, LM_CHAIN)[-1]
            torch.cuda.synchronize()
            chain_o.append(time.perf_counter() - t0)
            check(math.isfinite(float(last)), "non-finite LM loss")
        med = statistics.median(chain_o)
        # one update on the card against the CPU port on the same gradient
        # and state: the trained table's first LOWP_UPDATE_N elements
        tx = tupd.make_updater(updater, 1e-3)
        n_up = LOWP_UPDATE_N
        blk = {"bf16": n_up, "int8": n_up // 256}
        state = [x if x.dim() == 0 else
                 x[:n_up if x.numel() == lm.table.padded else blk[opt]]
                 for x in lm.table.opt_state]
        gen = torch.Generator(device=dev).manual_seed(7)
        g = torch.randn(n_up, generator=gen, device=dev) * 1e-3
        p_up = lm.table.params[:n_up]
        u_card, s_card = tx.update(g, state, p_up)
        u_cpu, s_cpu = tx.update(g.cpu(), [x.cpu() for x in state],
                                 p_up.cpu())
        for a, b in zip(s_card, s_cpu):
            a = a.cpu()
            check(a.dtype == b.dtype and torch.equal(
                a.view(as_int.get(a.dtype, a.dtype)),
                b.view(as_int.get(b.dtype, b.dtype))),
                f"{updater}: stored state differs between the card and the "
                "CPU port")
        rel = float(((u_card.cpu() - u_cpu).abs()
                     / u_cpu.abs().clamp(min=1e-30)).max())
        check(rel <= LOWP_UPDATE_RTOL, f"{updater}: card and CPU updates "
              f"differ by {rel} relative > {LOWP_UPDATE_RTOL}")
        lowp[opt] = {
            "card": card, "updater": updater, "batch": LM_B, "seq": LM_T,
            "chain": LM_CHAIN, "reps": LM_REPS,
            "step_ms": 1e3 * med / LM_CHAIN,
            "tokens_per_s": LM_B * LM_T * LM_CHAIN / med,
            "chain_s": chain_o,
            "opt_state_bytes": lm.opt_state_bytes,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "update_peak_gb": update_peak_gb(torch, lm.table),
            "losses": losses_o, "launches": launches_o,
            "update_check": {"elements": n_up, "state": "bit-identical",
                             "max_rel_err": rel}}
        lm_paths[opt] = dict(launches_o, opt_state_bytes=lm.opt_state_bytes)
        print(f"LM at opt_state {opt} ({updater}): " + json.dumps(lowp[opt]),
              flush=True)
        del lm, state, u_card, s_card, u_cpu, s_cpu, g

        card_lm = build_lm(2, 256, device=dev, opt_state=opt, **small)
        state = interop.dense_to_numpy(card_lm.table)
        card_l = [float(x) for x in run_lm_steps(card_lm, CPU_STEPS)]
        cpu_lm = build_lm(2, 256, device="cpu", opt_state=opt, **small)
        interop.load_dense(cpu_lm.table, *state)
        cpu_l = [float(x) for x in run_lm_steps(cpu_lm, CPU_STEPS)]
        lm_diff = max(abs(a - b) for a, b in zip(card_l, cpu_l))
        check(lm_diff <= LM_LOSS_TOL, f"small LM at opt_state {opt}: card "
              f"and CPU losses differ by {lm_diff} > {LM_LOSS_TOL}: card "
              f"{card_l} cpu {cpu_l}")
        print(f"small LM at opt_state {opt}, card vs CPU port, first "
              f"{CPU_STEPS} steps from the same weights: card {card_l} cpu "
              f"{cpu_l}, max |loss diff| {lm_diff:.3e} (tolerance "
              f"{LM_LOSS_TOL})", flush=True)
        del card_lm, cpu_lm

    # ------------------------------------- 11. Wide&Deep through the Engine
    import copy

    from minips_tpu_torch.utils.metrics import MetricsLogger

    def wd_run(mode, model, consistency, staleness, workers, iters,
               device=dev):
        cfg = copy.deepcopy(wdx.DEFAULT)
        cfg.table.consistency, cfg.table.staleness = consistency, staleness
        cfg.train.num_workers, cfg.train.num_iters = workers, iters
        cfg.train.log_every = 0
        args = argparse.Namespace(exec_mode=mode, model=model,
                                  eval_frac=WD_EVAL_FRAC, dtype="float32",
                                  device=str(device), data_file=None,
                                  stream=False)
        return wdx.run(cfg, args, MetricsLogger(None, verbose=False))

    n_hold = int(16384 * WD_EVAL_FRAC)
    eval_gathers = 2 * math.ceil(n_hold / WD_EVAL_CHUNK)
    wd = {}
    wd_launches = {}
    for mode, model, consistency, staleness, workers in (
            ("spmd", "widedeep", "bsp", 0, 1),
            ("spmd", "deepfm", "bsp", 0, 1),
            ("threaded", "widedeep", "bsp", 0, WD_WORKERS),
            ("threaded", "widedeep", "ssp", 2, WD_WORKERS),
            ("threaded", "widedeep", "asp", 0, WD_WORKERS)):
        key = (f"{mode}_{model}" if mode == "spmd"
               else f"{mode}_{consistency}{staleness or ''}")
        torch.cuda.synchronize()
        gather_rows.launches = 0
        out = wd_run(mode, model, consistency, staleness, workers, WD_ITERS)
        torch.cuda.synchronize()
        n_k1 = gather_rows.launches
        losses_w = out["losses"]
        check(len(losses_w) == WD_ITERS
              and all(math.isfinite(x) for x in losses_w),
              f"Wide&Deep {key}: losses {losses_w}")
        check(losses_w[-1] < losses_w[0],
              f"Wide&Deep {key}: loss did not fall: {losses_w}")
        steps = WD_ITERS * (workers if mode == "threaded" else 1)
        check(n_k1 == 2 * steps + eval_gathers,
              f"Wide&Deep {key}: gather_rows launched {n_k1} times, expected "
              f"2 per worker step ({2 * steps}) and {eval_gathers} for the "
              "holdout")
        wd[key] = {"mode": mode, "model": model, "consistency": consistency,
                   "staleness": staleness, "workers": workers,
                   "iters": WD_ITERS, "loss_first": losses_w[0],
                   "loss_last": losses_w[-1],
                   "samples_per_s": out["samples_per_sec"],
                   "holdout_auc": out["auc"], "gather_launches": n_k1,
                   "gathers_per_worker_step": (n_k1 - eval_gathers) / steps}
        wd_launches[f"wide_deep_{key}"] = n_k1
        print(f"Wide&Deep {key}: " + json.dumps(wd[key]), flush=True)
    del out

    # the loader's prefetch thread: batches pinned and copied on its copy
    # stream arrive on the card equal to the host batches
    host_b = [b for b, _ in zip(BatchIterator(wd_data, 1024, seed=0),
                                range(4))]
    got_b = list(prefetch_to_device(iter(host_b), dev))
    check(len(got_b) == 4 and all(
        v.device.type == "cuda" and torch.equal(v.cpu(), torch.as_tensor(h[k]))
        for g, h in zip(got_b, host_b) for k, v in g.items()),
        "prefetch_to_device: the card's batches differ from the host's")
    print("prefetch_to_device: 4 batches of 1024 rows copied from pinned "
          "memory on the copy stream, equal to the host batches", flush=True)

    card_w = wd_run("threaded", "widedeep", "bsp", 0, 1, CPU_STEPS)["losses"]
    cpu_w = wd_run("threaded", "widedeep", "bsp", 0, 1, CPU_STEPS,
                   device="cpu")["losses"]
    wd_diff = max(abs(a - b) for a, b in zip(card_w, cpu_w))
    check(wd_diff <= LOSS_TOL, f"Wide&Deep threaded BSP, 1 worker: card and "
          f"CPU losses differ by {wd_diff} > {LOSS_TOL}: card {card_w} cpu "
          f"{cpu_w}")
    print(f"Wide&Deep threaded BSP, 1 worker, card vs CPU port, first "
          f"{CPU_STEPS} steps from the same seed: card {card_w} cpu {cpu_w}, "
          f"max |loss diff| {wd_diff:.3e} (tolerance {LOSS_TOL})", flush=True)

    # the device's idle share over a whole threaded BSP run (tables built,
    # WD_PROFILED_ITERS rounds of WD_WORKERS workers, holdout scored): the
    # profiler's device busy time over the same run's unprofiled wall time
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wd_run("threaded", "widedeep", "bsp", 0, WD_WORKERS, WD_PROFILED_ITERS)
    torch.cuda.synchronize()
    run_ms = 1e3 * (time.perf_counter() - t0)
    wd_dev = device_time(torch, lambda: wd_run(
        "threaded", "widedeep", "bsp", 0, WD_WORKERS, WD_PROFILED_ITERS),
        1, run_ms)
    wd_dev["run_ms"] = run_ms
    wd_dev["rounds"] = WD_PROFILED_ITERS
    print("Wide&Deep threaded BSP device time over one whole run "
          "(torch.profiler): " + json.dumps(wd_dev), flush=True)

    # ------------------------------------------- 12. the LR and MLP apps
    from minips_tpu_torch.apps import mlp_example as mlpx

    def app_run(app, mode, *, iters=None, workers=APP_WORKERS, device=dev,
                train=None, **args):
        """One ``run`` of an app at its defaults (iterations, workers and
        ``train`` fields set as given); returns (result, K1 launches)."""
        cfg = copy.deepcopy(app.DEFAULT)
        cfg.train.log_every = 0
        cfg.train.num_workers = workers
        if iters:
            cfg.train.num_iters = iters
        for key, value in (train or {}).items():
            setattr(cfg.train, key, value)
        torch.cuda.synchronize()
        gather_rows.launches = 0
        out = app.run(cfg, argparse.Namespace(exec_mode=mode,
                                              device=str(device), **args),
                      MetricsLogger(None, verbose=False))
        torch.cuda.synchronize()
        return out, gather_rows.launches

    def falling(key, losses, n):
        check(len(losses) == n and all(math.isfinite(x) for x in losses),
              f"{key}: {len(losses)} losses, expected {n} finite: {losses}")
        check(losses[-1] < losses[0],
              f"{key}: loss did not fall: {losses[0]} -> {losses[-1]}")

    def profiled(app, mode, step_ms, **kw):
        """Device busy time per step over a whole run of APP_PROFILED_ITERS
        steps (set-up and holdout included), beside the unprofiled steady
        step time ``step_ms``: the idle share of the training steps."""
        return device_time(torch, lambda: app_run(
            app, mode, iters=APP_PROFILED_ITERS, **kw), APP_PROFILED_ITERS,
            step_ms)

    app_launches = {}
    apps = {}
    lr_eval_gathers = math.ceil(int(8192 * LR_EVAL_FRAC) / WD_EVAL_CHUNK)
    lr_iters = lrx.DEFAULT.train.num_iters
    for key, mode, data in (("lr_dense", "spmd", "dense"),
                            ("lr_sparse", "spmd", "sparse"),
                            ("lr_threaded", "threaded", "dense")):
        out, n_k1 = app_run(lrx, mode, data=data, eval_frac=LR_EVAL_FRAC)
        falling(key, out["losses"], lr_iters)
        steps = lr_iters * (APP_WORKERS if mode == "threaded" else 1)
        want = (steps + lr_eval_gathers) if data == "sparse" else 0
        check(n_k1 == want, f"{key}: gather_rows launched {n_k1} times, "
              f"expected {want} (1 a step and {lr_eval_gathers} for the "
              "holdout on the sparse path, none on the dense)")
        apps[key] = {"mode": mode, "data": data, "iters": lr_iters,
                     "workers": APP_WORKERS if mode == "threaded" else 1,
                     "batch": lrx.DEFAULT.train.batch_size,
                     "loss_first": out["losses"][0],
                     "loss_last": out["losses"][-1],
                     "samples_per_s": out["samples_per_sec"],
                     "holdout_auc": out["auc"], "gather_launches": n_k1}
        if key == "lr_dense":
            lr_whole = out["losses"]
        else:
            app_launches[key] = n_k1
        print(f"app {key}: " + json.dumps(apps[key]), flush=True)
    # checkpoint resume: RESUME_AT of the steps with a checkpoint every
    # RESUME_EVERY, then a restart from the newest, against the
    # uninterrupted run above
    ck_dir = os.path.join(REPO, "build", "chip_smoke_ckpt")
    shutil.rmtree(ck_dir, ignore_errors=True)  # a killed run's leftovers
    ck = {"checkpoint_dir": ck_dir, "checkpoint_every": RESUME_EVERY}
    part, _ = app_run(lrx, "spmd", iters=RESUME_AT, train=ck, data="dense",
                      eval_frac=LR_EVAL_FRAC)
    resumed, _ = app_run(lrx, "spmd", train=ck, data="dense",
                         eval_frac=LR_EVAL_FRAC)
    shutil.rmtree(ck_dir)
    check(len(resumed["losses"]) == lr_iters - RESUME_AT,
          f"resume ran {len(resumed['losses'])} steps, expected "
          f"{lr_iters - RESUME_AT}")
    resume_diff = max(abs(a - b) for a, b in zip(
        part["losses"] + resumed["losses"], lr_whole))
    check(resume_diff <= RESUME_TOL, f"LR dense resumed at step {RESUME_AT}: "
          f"losses differ from the uninterrupted run's by {resume_diff} > "
          f"{RESUME_TOL}")
    print(f"app lr_dense checkpoint resume: {RESUME_AT} of {lr_iters} steps "
          f"with a checkpoint every {RESUME_EVERY}, restarted from step "
          f"{RESUME_AT}; max |loss diff| against the uninterrupted run "
          f"{resume_diff:.3e} (tolerance {RESUME_TOL}); holdout AUC "
          f"{resumed['auc']}", flush=True)

    mlp_iters = mlpx.DEFAULT.train.num_iters
    for key, mode in (("mlp_spmd", "spmd"), ("mlp_threaded", "threaded")):
        out, n_k1 = app_run(mlpx, mode)
        falling(key, out["losses"], mlp_iters)
        check(n_k1 == 0, f"{key}: gather_rows launched {n_k1} times on a "
              "dense path")
        apps[key] = {"mode": mode, "iters": mlp_iters,
                     "workers": APP_WORKERS if mode == "threaded" else 1,
                     "batch": mlpx.DEFAULT.train.batch_size,
                     "loss_first": out["losses"][0],
                     "loss_last": out["losses"][-1],
                     "samples_per_s": out["samples_per_sec"],
                     "accuracy": out["accuracy"]}
        print(f"app {key}: " + json.dumps(apps[key]), flush=True)

    # ------------------------- 13. MF at MovieLens-20M's user and item counts
    ratings = os.path.join(REPO, "build", "chip_smoke_ratings.csv")
    os.makedirs(os.path.dirname(ratings), exist_ok=True)
    t0 = time.perf_counter()
    with open(ratings, "w") as f:
        f.write("userId,movieId,rating,timestamp\n")
        np.savetxt(f, np.column_stack([
            ml_data["user"] + 1, ml_data["item"] + 1, ml_data["rating"],
            1_000_000_000 + np.arange(MF_RATINGS)]), fmt="%d,%d,%.4f,%d")
    write_s = time.perf_counter() - t0
    print(f"MF data: {MF_RATINGS} ratings of movielens_like(users="
          f"{ML20M_USERS}, items={ML20M_ITEMS}) written as a MovieLens-20M "
          f"ratings.csv in {write_s:.2f} s (MovieLens-20M's {ML20M_RATINGS} "
          f"ratings cut to {MF_RATINGS} for time)", flush=True)
    mf_iters, mf_bs = mfx.DEFAULT.train.num_iters, mfx.DEFAULT.train.batch_size
    mf_eval_gathers = 2 * math.ceil(int(MF_RATINGS * MF_EVAL_FRAC)
                                    / mfx.EVAL_CHUNK)
    mf_args = dict(data_file=ratings, eval_frac=MF_EVAL_FRAC)
    # 300 steps of 1024 see each of the 138 K users about twice, and a
    # step's loss moves by more from batch to batch than training lowers
    # it: what training must lower is the loss of ratings it has seen, the
    # first training batch's (every worker's shard is one epoch in 219
    # steps), against the same batch's loss at the initial weights
    raw = read_ratings(ratings)
    mf_train, _ = holdout_split({k: raw[k] for k in ("user", "item",
                                                     "rating")},
                                MF_EVAL_FRAC, seed=mfx.DEFAULT.train.seed)
    seen = next(iter(BatchIterator(mf_train, mf_bs,
                                   seed=mfx.DEFAULT.train.seed)))

    @torch.no_grad()
    def seen_loss(user_t, item_t):
        return float(mf_model.loss(
            user_t.pull(seen["user"]), item_t.pull(seen["item"]),
            torch.as_tensor(seen["rating"], device=dev), mfx.MU, mfx.REG))

    seen_init = seen_loss(*mfx.make_tables(mfx.DEFAULT, raw["num_users"],
                                           raw["num_items"], dev))
    del raw, mf_train
    for key, mode in (("mf_spmd", "spmd"), ("mf_threaded_asp", "threaded")):
        t0 = time.perf_counter()
        out, n_k1 = app_run(mfx, mode, **mf_args)
        run_s = time.perf_counter() - t0
        losses = out["losses"]
        check(len(losses) == mf_iters and all(math.isfinite(x)
                                              for x in losses),
              f"{key}: {len(losses)} losses, expected {mf_iters} finite")
        seen_after = seen_loss(*out["tables"])
        check(seen_after < seen_init, f"{key}: the first training batch's "
              f"loss did not fall: {seen_init} at the initial weights, "
              f"{seen_after} after training")
        workers = APP_WORKERS if mode == "threaded" else 1
        steps = mf_iters * workers
        check(n_k1 == 2 * steps + mf_eval_gathers,
              f"{key}: gather_rows launched {n_k1} times, expected 2 per "
              f"worker step ({2 * steps}) and {mf_eval_gathers} for the "
              "holdout")
        user_t, item_t = out["tables"]
        check((user_t.num_slots, item_t.num_slots) == (1 << 18, 1 << 15)
              and user_t.dim == item_t.dim == 9,
              f"{key}: tables {user_t.num_slots} x {user_t.dim} and "
              f"{item_t.num_slots} x {item_t.dim}")
        check(math.isfinite(out["rmse"]), f"{key}: RMSE {out['rmse']}")
        apps[key] = {"mode": mode, "consistency": mfx.DEFAULT.table
                     .consistency, "iters": mf_iters, "workers": workers,
                     "batch": mf_bs, "ratings": MF_RATINGS,
                     "tables": [[user_t.num_slots, 9], [item_t.num_slots, 9]],
                     "loss_first": losses[0], "loss_last": losses[-1],
                     "loss_mean_first_30": statistics.fmean(losses[:30]),
                     "loss_mean_last_30": statistics.fmean(losses[-30:]),
                     "seen_batch_loss": [seen_init, seen_after],
                     "samples_per_s": out["samples_per_sec"],
                     "holdout_rmse": out["rmse"], "gather_launches": n_k1,
                     "gathers_per_worker_step":
                         (n_k1 - mf_eval_gathers) / steps,
                     "run_s": run_s}
        app_launches[key] = n_k1
        if mode == "spmd":
            mf_card = losses[:CPU_STEPS]
        del out, user_t, item_t
        print(f"app {key}: " + json.dumps(apps[key]), flush=True)
    mf_cpu = app_run(mfx, "spmd", iters=CPU_STEPS, device="cpu",
                     **mf_args)[0]["losses"]
    mf_diff = max(abs(a - b) for a, b in zip(mf_card, mf_cpu))
    check(mf_diff <= APP_LOSS_TOL, f"MF spmd: card and CPU losses differ by "
          f"{mf_diff} > {APP_LOSS_TOL}: card {mf_card} cpu {mf_cpu}")
    print(f"MF spmd, card vs CPU port, first {CPU_STEPS} steps from the same "
          f"seed: card {mf_card} cpu {mf_cpu}, max |loss diff| "
          f"{mf_diff:.3e} (tolerance {APP_LOSS_TOL})", flush=True)

    # --------------------------------------------------- 14. word2vec
    w2v_iters = w2vx.DEFAULT.train.num_iters
    w2v_bs = w2vx.DEFAULT.train.batch_size
    for key, mode in (("w2v_spmd", "spmd"), ("w2v_threaded_asp", "threaded")):
        out, n_k1 = app_run(w2vx, mode)
        falling(key, out["losses"], w2v_iters)
        workers = APP_WORKERS if mode == "threaded" else 1
        steps = w2v_iters * workers
        check(n_k1 == 2 * steps, f"{key}: gather_rows launched {n_k1} times, "
              f"expected 2 per worker step ({2 * steps})")
        apps[key] = {"mode": mode, "consistency": w2vx.DEFAULT.table
                     .consistency, "iters": w2v_iters, "workers": workers,
                     "batch": w2v_bs, "neg": w2vx.NEG,
                     "tables": [[w2vx.DEFAULT.table.num_slots,
                                 w2vx.DEFAULT.table.dim]] * 2,
                     "loss_first": out["losses"][0],
                     "loss_last": out["losses"][-1],
                     "samples_per_s": out["samples_per_sec"],
                     "gather_launches": n_k1,
                     "gathers_per_worker_step": n_k1 / steps}
        app_launches[key] = n_k1
        if mode == "spmd":
            w2v_card = out["losses"][:CPU_STEPS]
        del out
        print(f"app {key}: " + json.dumps(apps[key]), flush=True)
    w2v_cpu = app_run(w2vx, "spmd", iters=CPU_STEPS, device="cpu")[0][
        "losses"]
    w2v_diff = max(abs(a - b) for a, b in zip(w2v_card, w2v_cpu))
    check(w2v_diff <= APP_LOSS_TOL, f"word2vec spmd: card and CPU losses "
          f"differ by {w2v_diff} > {APP_LOSS_TOL}: card {w2v_card} cpu "
          f"{w2v_cpu}")
    print(f"word2vec spmd, card vs CPU port, first {CPU_STEPS} steps from the "
          f"same seed: card {w2v_card} cpu {w2v_cpu}, max |loss diff| "
          f"{w2v_diff:.3e} (tolerance {APP_LOSS_TOL})", flush=True)

    # the device's idle share on the apps' sparse paths: busy time per step
    # over a profiled run against the unprofiled steady step time
    for key, app, kw in (("lr_sparse", lrx, dict(data="sparse")),
                         ("mf_spmd", mfx, mf_args),
                         ("mf_threaded_asp", mfx, mf_args),
                         ("w2v_spmd", w2vx, {}),
                         ("w2v_threaded_asp", w2vx, {})):
        rate, mode = apps[key]["samples_per_s"], apps[key]["mode"]
        per_step = apps[key]["batch"] * apps[key]["workers"]
        apps[key]["device"] = dev_t = profiled(
            app, mode, 1e3 * per_step / rate, **kw)
        unit = "round of workers" if mode == "threaded" else "step"
        print(f"app {key} device time per {unit} (torch.profiler over "
              f"{APP_PROFILED_ITERS} iterations): " + json.dumps(dev_t),
              flush=True)

    # ------------- 15-16. the sharded PS through an NCCL group of one rank
    from minips_tpu_torch.parallel.mesh import run_ranks

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    group_cfg = {"card": card, "batch": B, "chain": CHAIN, "reps": REPS,
                 "lm_b": LM_B, "lm_t": LM_T, "lm_dim": LM_DIM,
                 "lm_depth": LM_DEPTH, "lm_chain": LM_CHAIN,
                 "lm_reps": LM_REPS, "small_dim": 256, "small_t": 256}
    t0 = time.perf_counter()
    grp = run_ranks(group_phases, 1, group_cfg, timeout=GROUP_TIMEOUT_S,
                    store_dir=os.path.join(REPO, "build",
                                           "chip_smoke_store"))[0]
    group_s = time.perf_counter() - t0
    print(f"sharded PS through an NCCL group of world size 1 (one spawned "
          f"rank, {group_s:.1f} s): the LR + MLP pair's step "
          + json.dumps({"phase 5 (group=None)": step["step_ms"],
                        **grp["pair"]["step_ms"]})
          + " ms; 20 steps bit-identical to group=None, 2 gathers a step",
          flush=True)
    print("LM step through the group, beside phase 8's f32 step: " + json.dumps(
        {"float32 (phase 8, group=None)": {
            k: lm_step[k] for k in ("step_ms", "tokens_per_s",
                                    "peak_mem_gb")},
         **{comm: {k: grp["lm"][comm][k] for k in (
             "step_ms", "tokens_per_s", "peak_mem_gb")}
            for comm in GROUP_COMMS}}), flush=True)

    # ---------------------------------- 17. the remat spectrum at full width
    t0 = time.perf_counter()
    remat_paths = remat_phase(torch, dev, card, tfa)
    phase_s["17"] = time.perf_counter() - t0
    # ------------------------------------ 18. lm_example at full width
    app_paths, shapes_18 = lm_example_phase(torch, dev, card, tfa, mem_bw,
                                            ptxas_by_kernel)
    for k in kernels[1:]:
        k["shapes"] = shapes_18[k["name"]]
    phase_s["18"] = time.perf_counter() - t0 - phase_s["17"]
    # ------------------------------------------------- 20. the MoE LM
    t0 = time.perf_counter()
    moe_phase(torch, dev, card)
    phase_s["20"] = time.perf_counter() - t0
    # -------------------------------- 21. a 4-way ring's steps on one card
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    ring_launches = ring_phase(torch, dev, card, tfa)
    phase_s["21"] = time.perf_counter() - t0
    # ---------- 22-23. lm_example's sp, tp, pp and ep through a group of one
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    par = run_ranks(parallel_phases, 1,
                    {"card": card, "b": LM_B, "t": LM_T, "dim": LM_DIM,
                     "depth": LM_DEPTH, "heads": LM_DIM // 64},
                    timeout=GROUP_TIMEOUT_S,
                    store_dir=os.path.join(REPO, "build",
                                           "chip_smoke_store"))[0]
    phase_s["22-23"] = time.perf_counter() - t0
    print("lm_example layouts through an NCCL group of one, by layout "
          "[step ms, tokens/s, peak GB] (phases 22-23): " + json.dumps(
              {k: [r["step_ms"], r["tokens_per_s"], r["peak_mem_gb"]]
               for k, r in par["rows"].items()}), flush=True)
    # ------ 24-26. the apps, the Engine and checkpoints through a group
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    appg = run_ranks(app_group_phases, 1, {
        "card": card, "ratings": ratings, "wd_workers": WD_WORKERS,
        "spmd_apps": ("wide_deep", "deepfm", "lr_dense", "lr_sparse", "mlp",
                      "mf", "word2vec"),
        "lm_ckpt": True,
        "ckpt_root": os.path.join(REPO, "build", "chip_smoke_ckpt_group")},
        timeout=GROUP_TIMEOUT_S,
        store_dir=os.path.join(REPO, "build", "chip_smoke_store"))[0]
    phase_s["24-26"] = time.perf_counter() - t0
    print("apps' spmd samples/s through an NCCL group of one beside "
          "group=None, by app [group, group=None] (phase 24): " + json.dumps(
              {k: [r["samples_per_s"], r["samples_per_s_group_none"]]
               for k, r in appg["spmd"].items()}), flush=True)
    # --------- 27. the host control plane between processes on the card
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    control = control_plane_phase(card)
    phase_s["27"] = time.perf_counter() - t0
    # --------- 28. the multi-process parameter server under the launcher
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mp = multiproc_phase(card, ratings)
    os.remove(ratings)
    phase_s["28"] = time.perf_counter() - t0
    # --------- 29. the placement and serving layers, armed, on the card
    t0 = time.perf_counter()
    placement_phase(card, mp["28a"]["bsp"])
    phase_s["29"] = time.perf_counter() - t0
    # --------- 30. the in-mesh collective data plane on the card
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mesh_phase(torch, card)
    phase_s["30"] = time.perf_counter() - t0
    # --------- 31. the collective consistency plane and multi-host
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    cons = consistency_phase(torch, card)
    phase_s["31"] = time.perf_counter() - t0
    # --------- 32. the profiling tooling over K1-K4's paths
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    tooling = tooling_phase(torch, dev, card)
    phase_s["32"] = time.perf_counter() - t0
    print("LM decoding (phase 19): " + json.dumps(decoding), flush=True)
    print("seconds taken by phases 17-32: " + json.dumps(phase_s),
          flush=True)

    kernels[0]["launches_by_path"] = dict(
        lrmlp=main_launches["gather_rows"], **wd_launches, **app_launches,
        lrmlp_group_ws1=grp["pair"]["gather_launches"],
        **{f"{k}_group_ws1": v for k, v in appg["k1"].items()},
        **control["k1"], **cons["k1"],
        wide_deep_spmd_profiled_window=tooling["32a_wide_deep"]["launches"][
            "gather_rows"])
    for k in kernels[1:]:
        k["launches_by_path"] = {f"lm_{opt}": v[k["name"]]
                                 for opt, v in lm_paths.items()}
        k["launches_by_path"].update({
            f"lm_comm_{comm}": grp["lm"][comm]["launches"][k["name"]]
            for comm in GROUP_COMMS})
        k["launches_by_path"].update({
            f"lm_remat_{mode}": v[k["name"]]
            for mode, v in remat_paths.items()})
        k["launches_by_path"].update({
            f"lm_example_{name}": v[k["name"]]
            for name, v in app_paths.items()})
        k["launches_by_path"][f"ring{RING_N}_per_rank"] = \
            ring_launches[k["name"]]
        k["launches_by_path"].update({
            f"lm_example_{name}_group_ws1": par["launches"][name][k["name"]]
            for name in ("dp_flash", "sp_flash", "sp_a2a_flash")})
        k["launches_by_path"]["lm_example_dp_flash_resumed_group_ws1"] = \
            appg["flash_resumed"][k["name"]]
        k["launches_by_path"].update(cons["flash"][k["name"]])
        k["launches_by_path"]["lm_example_profiled_window"] = \
            tooling["32a_lm"]["launches"][k["name"]]

    kernels.append(row_adagrad)  # K2-K4 above are kernels[1:4]
    kernels.append(adam_row)

    print("processes still running at the end, killed: "
          + json.dumps(stop_children()), flush=True)
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        left = stop_children()
        if left:
            print(f"chip_smoke: killed processes left running: {left}",
                  file=sys.stderr)
    sys.exit(rc)
