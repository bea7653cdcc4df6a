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
Adam, flash attention, head chunks of 128). Phases, each of which raises
on failure:

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
   views of its fused activation), the gradients through the autograd op
   with a nonzero lse cotangent; keys that no query sees get dK = dV = 0
   exactly, and two K4 launches agree to the bit;
8. LM path: 10 steps at full width, with finite and falling loss, each
   flash kernel launched once per block per step, step time, tokens/s and
   the profiler's idle share; the first 3 steps of a small LM on the card
   and on the CPU port from the same weights;
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
    ``group=None`` at the same ``comm``.

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
          "flash_bwd_dq": "wgmma", "flash_bwd_dkv": "wgmma"}
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
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
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
        want = cfg["lm_depth"] * cfg["lm_chain"]
        check(all(v == want for v in launches.values()),
              f"LM at comm {comm}: flash launches {launches}, expected "
              f"{want} each")
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


def main() -> int:
    import torch

    # ---------------------------------------------------------- 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on "
              "an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
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
    logs = _build.build_all(["gather_rows", "flash_attn"])
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.2f} s for {sorted(logs) or 'cached'}",
          flush=True)
    for name, log in logs.items():
        for kernel, line in ptxas_lines(log):
            print(f"  ptxas {name} {kernel}: {line}")
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
    ]
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (False, True):
            for case in flash_cases:
                record(*flash_errors(torch, tfa, case, dtype, causal,
                                     n_cases))
                n_cases += 1
    LM_B, LM_T, LM_DIM, LM_DEPTH = 16, 1024, 2048, 8
    full = (LM_B, LM_T, LM_T, LM_DIM // 64, LM_DIM // 64, 64, 0, 0)
    record(*flash_errors(torch, tfa, full, torch.bfloat16, True, n_cases))
    # q/k/v as the LM block's views of its fused activation, read through
    # the bf16 kernels' tensor maps at the activation's strides
    view_cases = (full, (1, 192, 192, 8, 2, 64, 0, 0))
    for i, case in enumerate(view_cases):
        record(*flash_errors(torch, tfa, case, torch.bfloat16, True,
                             n_cases + 1 + i, views=True))
    n_cases += 1 + len(view_cases)
    print(f"flash kernels: {n_cases} cases against the plain versions "
          "(f32 and bf16, causal and not, MHA/GQA g=4/MQA, offsets, ragged "
          "T=100/130/200/328, Tq=192 and 200 against the 128-row Q tile, "
          "Tk=384 > Tq=128 causal, D 40/64/72/128, full width "
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
    lm_losses = run_lm_steps(lm, LM_CHAIN)
    torch.cuda.synchronize()
    lm_launches = {name: getattr(tfa, name).launches for name in flash}
    lm_launches["gather_rows"] = gather_rows.launches
    lm_losses = [float(x) for x in lm_losses]
    check(all(math.isfinite(x) for x in lm_losses),
          f"non-finite LM loss: {lm_losses}")
    check(lm_losses[-1] < lm_losses[0],
          f"LM loss did not fall: {lm_losses}")
    for name in flash:
        check(lm_launches[name] == LM_DEPTH * LM_CHAIN,
              f"{name} launched {lm_launches[name]} times in {LM_CHAIN} "
              f"steps of {LM_DEPTH} blocks, expected {LM_DEPTH * LM_CHAIN}")
    print(f"LM path: {LM_CHAIN} steps at B={LM_B} T={LM_T} dim={LM_DIM} "
          f"depth={LM_DEPTH} heads={lm.heads} vocab={1 << 14}, bf16, "
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
    # activation, as the block hands them over; the library yardstick is
    # scaled_dot_product_attention (causal) on [B, H, T, D], forward for
    # K2 and its backward (dQ, dK, dV together) for K3 and K4
    B_, T_, H_, D_ = LM_B, LM_T, LM_DIM // 64, 64
    gen = torch.Generator(device=dev).manual_seed(1)
    qkv = torch.randn((B_, T_, 3, H_ * D_), generator=gen,
                      device=dev).to(torch.bfloat16)
    q, k, v = (qkv[:, :, i].reshape(B_, T_, H_, D_) for i in range(3))
    g_out = torch.randn((B_, T_, H_, D_), generator=gen,
                        device=dev).to(torch.bfloat16)
    kw = dict(causal=True, scale=D_ ** -0.5)
    out, lse = tfa.flash_forward(q, k, v, **kw)
    dvec = (g_out.float() * out.float()).sum(-1).transpose(1, 2)[..., None]
    sq, sk, sv = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    s_out = torch.nn.functional.scaled_dot_product_attention(
        sq, sk, sv, is_causal=True)
    s_g = g_out.transpose(1, 2).contiguous()
    pairs, nbytes = attention_work(B_, T_, T_, H_, H_, D_, 0, 0, True, 2)
    flops = {"flash_forward": 4 * D_ * pairs, "flash_bwd_dq": 6 * D_ * pairs,
             "flash_bwd_dkv": 8 * D_ * pairs}
    runs = {
        "flash_forward": (lambda: tfa.flash_forward(q, k, v, **kw),
                          lambda: tfa.flash_forward_reference(q, k, v, **kw),
                          lambda: torch.nn.functional
                          .scaled_dot_product_attention(sq, sk, sv,
                                                        is_causal=True)),
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
    replaces = {"flash_forward": "minips_tpu/ops/flash_attention.py:190",
                "flash_bwd_dq": "minips_tpu/ops/flash_attention.py:297",
                "flash_bwd_dkv": "minips_tpu/ops/flash_attention.py:332"}
    sdpa_bwd_ms = None
    for name in flash:
        kernel_fn, plain_fn, lib_fn = runs[name]
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
        # SDPA's backward computes dQ, dK and dV in one call; K3's share of
        # it is in proportion to the work, 6 D against K4's 8 D per pair
        share = {"flash_forward": 1.0, "flash_bwd_dq": 6 / 14,
                 "flash_bwd_dkv": 8 / 14}[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "minips_tpu_torch/csrc/flash_attn.cu",
            "replaces": replaces[name],
            "launches": lm_launches[name],
            "max_abs_err": flash_err[name],
            "ms": ms, "plain_ms": plain, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib,
            "design": DESIGN[name],
            "tflops": flops[name] / ms / 1e9,
            "library_share_ms": None if lib is None else lib * share,
            "library_call": ("scaled_dot_product_attention(is_causal=True) "
                             + ("forward" if name == "flash_forward" else
                                "backward, dQ dK dV together")),
            "shape": {"B": B_, "T": T_, "H": H_, "Hk": H_, "D": D_,
                      "dtype": "bfloat16", "causal": True,
                      "live_pairs": pairs, "flops": flops[name],
                      "bytes": nbytes[name]},
        })
        print(f"{name} at the LM's shape: " + json.dumps(kernels[-1]),
              flush=True)
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
        for name in flash:
            check(launches_o[name] == LM_DEPTH * LM_CHAIN,
                  f"{name} launched {launches_o[name]} times in {LM_CHAIN} "
                  f"steps at opt_state {opt}, expected "
                  f"{LM_DEPTH * LM_CHAIN}")
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
    os.remove(ratings)

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

    kernels[0]["launches_by_path"] = dict(
        lrmlp=main_launches["gather_rows"], **wd_launches, **app_launches,
        lrmlp_group_ws1=grp["pair"]["gather_launches"])
    for k in kernels[1:]:
        k["launches_by_path"] = {f"lm_{opt}": v[k["name"]]
                                 for opt, v in lm_paths.items()}
        k["launches_by_path"].update({
            f"lm_comm_{comm}": grp["lm"][comm]["launches"][k["name"]]
            for comm in GROUP_COMMS})

    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
