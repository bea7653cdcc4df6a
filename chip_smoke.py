#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``minips_tpu_torch``).

Run from the root of a checkout, on a machine with one NVIDIA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``minips_tpu_torch/csrc`` and drives
the port's main path — the fused LR + MLP parameter-server training step of
``minips_tpu_torch/apps/lrmlp.py`` at full width (B = 65536, 13 dense and
26 categorical fields, tables of 2^18 rows) — through the entry points a
user calls. Phases, each of which raises on failure:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles every kernel, all sources at once, and times it;
3. kernels: each kernel against its plain PyTorch version on the card
   (the row gather must be bit-exact), and their times beside the least
   time the card could take and one PyTorch call's time;
4. hash: the key hash on the card, bit-identical to its numpy twin;
5. main path: 20 steps of both models, with finite and falling loss, the
   kernels' launch counts, the same first 3 steps on the CPU port from the
   same weights, and the step time on the card;
6. pull: ``SparseTable.pull`` through the kernel at D = 8 and D = 128.

The last two lines are a JSON object with every kernel's numbers and then
``{"ok": true, "device": {...}}``. Without CUDA, or without the package
beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

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
# Device memory rate by card, bytes/s (NVIDIA data sheets); the H100 SXM's
# 3.35 TB/s unless the name says otherwise.
MEM_BW = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H200", 4.8e12),
          ("H100", 3.35e12))


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def time_ms(torch, fn) -> float:
    """Median over TIMED_LAUNCHES calls, each between two CUDA events,
    after warm-up. A sleep kernel first holds the stream while the host
    queues every call, so that the events bracket device time only and
    not the host's launch overhead (which exceeds a short kernel's time)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True))
          for _ in range(TIMED_LAUNCHES)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for s, e in ev:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def main() -> int:
    import torch

    # ---------------------------------------------------------- 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on "
              "an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from minips_tpu_torch import interop
    from minips_tpu_torch.apps.lrmlp import build_lrmlp
    from minips_tpu_torch.ops import _build
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
    logs = _build.build_all(["gather_rows"])
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.2f} s for {sorted(logs) or 'cached'}",
          flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # ------------------------------------- 3. kernels against plain versions
    rng = np.random.default_rng(0)
    S = 1 << 18
    n_main = B * 26
    max_err = 0.0

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
        check(torch.equal(got, want),
              f"gather differs from its plain version: D={emb.shape[1]} "
              f"N={slots.numel()} {emb.dtype} max err {err}")

    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for d in (1, 8, 128):
            emb = torch.randn((S, d), device=dev).to(dtype)
            big = rng.integers(0, S, n_main, dtype=np.int64)
            big[:64] = big[64:128]           # repeats
            big[128:132] = (0, S - 1, 0, S - 1)  # boundary rows
            compare(emb, torch.as_tensor(big, dtype=torch.int32, device=dev))
            for small in ([3, 3, 0, S - 1, 5, S - 1, 0], [S - 1],
                          [-4, S + 9, 0, S - 1, 2, 2, 7]):
                compare(emb, torch.tensor(small, dtype=torch.int32,
                                          device=dev))
            cases += 4
    print(f"gather_rows: {cases} cases bit-exact against the plain version "
          f"(D 1/8/128, N {n_main}/7/1, f32 and bf16, repeats, boundary and "
          f"out-of-range slots)", flush=True)

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

    def run_steps(pair, steps):
        out = []
        for i in range(steps):
            b = pair.batches[i % 2]
            out.append((pair.lr_step(b), pair.mlp_step(b)))
        return out

    torch.cuda.synchronize()
    gather_rows.launches = 0
    losses = run_steps(p, CHAIN)
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
    cpu_losses = [(float(a), float(b)) for a, b in run_steps(cpu, CPU_STEPS)]
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
        last = run_steps(p, CHAIN)[-1]
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

    # where a step's device time goes: kernel intervals from the profiler,
    # beside the unprofiled step time (the profiler slows the host)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_steps(p, PROFILED_STEPS)
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, calls = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3,
                               calls + 1)
    busy = sum(ms for ms, _ in by_name.values()) / PROFILED_STEPS
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    print("device time per step (torch.profiler): " + json.dumps({
        "device_busy_ms": busy if by_name else "not measured",
        "device_idle_share": (1 - busy / step["step_ms"]) if by_name
        else "not measured",
        "device_ops": sum(c for _, c in by_name.values()) / PROFILED_STEPS,
        "top": [{"name": n[:80], "ms": ms / PROFILED_STEPS,
                 "calls": c / PROFILED_STEPS} for n, (ms, c) in top]}),
        flush=True)

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

    # --------------------------------- kernel times at the main path's shapes
    shapes = []
    for table, salt in ((p.wide, 1), (p.emb, 2)):
        slots = hash_to_slots(cats, S, salt).reshape(-1)
        emb = table.emb
        d, item = emb.shape[1], emb.element_size()
        uniq = int(torch.unique(slots).numel())
        nbytes = slots.numel() * 4 + uniq * d * item + slots.numel() * d * item
        shapes.append({
            "D": d, "N": slots.numel(), "unique_rows": uniq,
            "bytes": nbytes,
            "kernel_ms": time_ms(torch, lambda: gather_rows(emb, slots)),
            "plain_ms": time_ms(torch,
                                lambda: gather_rows_reference(emb, slots)),
            "library_ms": time_ms(torch,
                                  lambda: torch.index_select(emb, 0, slots)),
            "bound_ms": 1e3 * nbytes / mem_bw,
        })
    for s in shapes:
        print("gather_rows at the main path's shape: " + json.dumps(s))
    kernels = [{
        "name": "gather_rows", "route": "cuda",
        "source": "minips_tpu_torch/csrc/gather_rows.cu",
        "replaces": "minips_tpu/ops/pallas_kernels.py:69",
        "launches": main_launches["gather_rows"],
        "max_abs_err": max_err,
        # one training step's two gathers (D=1 and D=8), summed
        "ms": sum(s["kernel_ms"] for s in shapes),
        **{k: sum(s[k] for s in shapes)
           for k in ("plain_ms", "bound_ms", "library_ms")},
        "bound_by": "bytes",
        "shapes": shapes,
    }]
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
