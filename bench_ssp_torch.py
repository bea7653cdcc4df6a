"""SSP vs BSP wall-clock under transient stalls, on the PyTorch port — the
counterpart of ``bench_ssp.py`` over ``minips_tpu_torch``.

BASELINE.json's secondary metric is "SSP wall-clock to target loss". This
script measures the mechanism it rewards: with per-rank transient stalls
injected, BSP pays the UNION of all ranks' stalls (every stall blocks
everyone at the next gate), while SSP (s <= 4) absorbs stalls inside its
slack window: the same final replicas, the same staleness bound, less
wall-clock. A constant-rate straggler would not show it (the gate bounds
the lead, so throughput is the straggler's rate in both modes); jitter is
the regime SSP is for.

Modes (the JSON keys are ``bench_ssp.py``'s):

- default (loopback): N real local processes of the port's
  ``apps/ssp_lr_example.py`` under the port's launcher, the bus and gate
  end to end, ``--model lr`` (64 features, the default) or ``mlp``
  (BASELINE.json config 2: 784-256-128-10 at B 256). Each rank's step runs
  on the card (``cuda:{local rank mod card count}``); ``--cpu`` pins the
  ranks to the CPU.
- ``--sharded`` / ``--collective``: the same comparison on
  ``sharded_ps_example`` (the key-range-sharded PS) or
  ``multihost_example`` (CollectiveSSP: the merge a collective every
  ``--sync-every`` steps; the two modes must land on identical losses, or
  the run exits 1).
- ``--chip-grounded``: the card's fused LR + MLP step time is measured
  (``apps/lrmlp.py``'s pair, CUDA events over a chain of steps, median of
  reps), then an event-driven simulation schedules N workers' steps with
  the same transient stalls under the gate rule. It refuses to run off
  CUDA: a CPU step time is never published as the card's.

Every mode but ``--chip-grounded`` also runs the job once under BSP with
no stalls: ``step_ms`` is that run's wall-clock over its steps, to read
beside the injected stalls (``stall_ms_per_step``: one rank's expected
stall a step, ``jitter_ms * jitter_prob``; ``bsp_stall_ms_per_step``: the
union over the ranks, what BSP pays). Where the stalls outweigh the step,
the speedup measures the gate absorbing sleeps more than the step's work.

Emits ONE JSON line:

    {"metric": "ssp_vs_bsp_wallclock_speedup ...", "value": <bsp_s/ssp_s>,
     ...}

Usage: python bench_ssp_torch.py [--n 3] [--iters 80] [--jitter-ms 40]
                                [--model lr|mlp]
       python bench_ssp_torch.py --chip-grounded [--iters 400]
"""

from __future__ import annotations

import argparse
import json
import sys


def run_job(n: int, iters: int, mode: str, staleness: int,
            jitter_ms: float, jitter_prob: float, timeout: float, *,
            app: str = "minips_tpu_torch.apps.ssp_lr_example",
            extra: list[str] = (), cpu: bool = False) -> list[dict]:
    from minips_tpu_torch import launch

    return launch.run_local_job(
        n,
        [sys.executable, "-m", app,
         "--iters", str(iters), "--mode", mode,
         "--staleness", str(staleness),
         "--jitter-ms", str(jitter_ms), "--jitter-prob", str(jitter_prob),
         *extra],
        base_port=None,
        env_extra={"MINIPS_FORCE_CPU": "1"} if cpu else {},
        timeout=timeout)


def measure_chip_step_ms(batch: int = 16384, chain: int = 20,
                         reps: int = 5) -> tuple[float, str]:
    """Median milliseconds of one fused LR + MLP step pair of the port on
    the card (``apps/lrmlp.py``; CUDA events around ``chain`` steps that
    alternate the pair's two batches). Raises without CUDA."""
    import statistics

    import torch

    from minips_tpu_torch.apps.lrmlp import build_lrmlp

    if not torch.cuda.is_available():
        raise SystemExit("--chip-grounded measures the card's step time "
                         "and CUDA is not available here; a CPU step "
                         "time is not published as the card's")
    dev = torch.device("cuda", 0)
    pair = build_lrmlp(batch, dev)

    def steps(k):
        for i in range(k):
            b = pair.batches[i % 2]
            pair.lr_step(b)
            pair.mlp_step(b)

    steps(3)  # warm-up: the kernel build and the first launches
    torch.cuda.synchronize(dev)
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        steps(chain)
        t1.record()
        torch.cuda.synchronize(dev)
        times.append(t0.elapsed_time(t1) / chain)
    return statistics.median(times), torch.cuda.get_device_name(0)


def simulate_schedule(n: int, iters: int, step_ms: float, staleness: int,
                      jitter_ms: float, jitter_prob: float,
                      seed: int = 0) -> float:
    """Event-driven wall-clock of N workers under the gate rule: worker i
    may START step k only when every worker has FINISHED step k-1-s
    (s=0: the BSP barrier). Per-(worker, step) transient stalls are the
    same Bernoulli jitter the loopback mode injects. Returns seconds."""
    import numpy as np

    rng = np.random.default_rng(seed)
    stall = (rng.random((n, iters)) < jitter_prob) * jitter_ms
    finish = np.zeros((n, iters + 1))  # finish[:, k] = end of step k
    for k in range(1, iters + 1):
        dep = k - 1 - staleness
        gate_open = finish[:, dep].max() if dep >= 1 else 0.0
        start = np.maximum(finish[:, k - 1], gate_open)
        finish[:, k] = start + step_ms + stall[:, k - 1]
    return float(finish[:, iters].max()) / 1000.0


def _compare(args, app: str, extra: list[str]) -> dict:
    walls, finals, losses, skews, devices = {}, {}, {}, {}, set()
    bare = run_job(args.n, args.iters, "bsp", 0, 0.0, 0.0, args.timeout,
                   app=app, extra=extra, cpu=args.cpu)
    step_ms = 1000.0 * max(r["wall_s"] for r in bare) / args.iters
    for mode, s in [("bsp", 0), ("ssp", args.staleness)]:
        rs = run_job(args.n, args.iters, mode, s, args.jitter_ms,
                     args.jitter_prob, args.timeout, app=app, extra=extra,
                     cpu=args.cpu)
        walls[mode] = max(r["wall_s"] for r in rs)  # job ends with slowest
        finals[mode] = max(r["loss_last"] for r in rs)
        skews[mode] = max(r["max_skew_seen"] for r in rs)
        losses[mode] = sorted((r["rank"], tuple(r.get("losses", ())))
                              for r in rs)
        devices.update(str(r.get("device")) for r in rs)
        print(f"# {mode}: wall={walls[mode]:.2f}s "
              f"loss_last={finals[mode]:.4f} max_skew={skews[mode]}",
              file=sys.stderr)
    return {"walls": walls, "finals": finals, "losses": losses,
            "skews": skews, "devices": sorted(devices), "step_ms": step_ms}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=3)
    ap.add_argument("--iters", type=int, default=80)
    ap.add_argument("--staleness", type=int, default=4)
    ap.add_argument("--jitter-ms", type=float, default=40.0)
    ap.add_argument("--jitter-prob", type=float, default=0.25)
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--sharded", action="store_true",
                    help="the gate comparison on the key-range-sharded "
                         "multi-process PS (sharded_ps_example, sparse "
                         "model) instead of the delta relay")
    ap.add_argument("--collective", action="store_true",
                    help="the gate comparison on the collective-sync "
                         "path (multihost_example: CollectiveSSP)")
    ap.add_argument("--sync-every", type=int, default=8,
                    help="--collective: local steps per merge")
    ap.add_argument("--sync-comm", default="float32",
                    choices=["float32", "bfloat16", "int8"],
                    help="--collective: wire format of the delta merge")
    ap.add_argument("--model", default="lr", choices=["lr", "mlp"],
                    help="the delta relay's model (ssp_lr_example --model)")
    ap.add_argument("--cpu", action="store_true",
                    help="pin the ranks to the CPU (MINIPS_FORCE_CPU)")
    ap.add_argument("--chip-grounded", action="store_true",
                    help="measure the card's step time, simulate the "
                         "N-worker schedule (module docstring)")
    args = ap.parse_args()
    if args.model != "lr" and (args.sharded or args.collective
                               or args.chip_grounded):
        ap.error("--model picks the delta relay's model; the other modes "
                 "run their own")

    if args.chip_grounded:
        step_ms, card = measure_chip_step_ms()
        walls = {
            mode: simulate_schedule(args.n, args.iters, step_ms, s,
                                    args.jitter_ms, args.jitter_prob)
            for mode, s in [("bsp", 0), ("ssp", args.staleness)]}
        print(json.dumps({
            "metric": "ssp_vs_bsp_wallclock_speedup (chip-grounded: "
                      "measured card step time x simulated N-worker "
                      f"schedule; {args.n} workers, jitter "
                      f"{args.jitter_ms}ms@p={args.jitter_prob})",
            "value": walls["bsp"] / walls["ssp"],
            "unit": "x",
            "step_ms": step_ms,
            "bsp_wall_s": walls["bsp"],
            "ssp_wall_s": walls["ssp"],
            "staleness": args.staleness,
            "grounding": ("card-measured step time of the fused LR + MLP "
                          "pair; schedule simulated"),
            "device": card,
        }))
        return 0

    if args.collective:
        out = _compare(args, "minips_tpu_torch.apps.multihost_example",
                       ["--sync-every", str(args.sync_every),
                        "--batch", str(16 * args.n),
                        "--sync-comm", args.sync_comm])
        identical = out["losses"]["bsp"] == out["losses"]["ssp"]
        if not identical:
            print("# ERROR: bsp/ssp loss streams differ — the gate must "
                  "not change math; the speedup below is not "
                  "trustworthy", file=sys.stderr)
        topo = (f"collective-sync CollectiveSSP, sync_every="
                f"{args.sync_every}")
    else:
        app = ("minips_tpu_torch.apps.sharded_ps_example" if args.sharded
               else "minips_tpu_torch.apps.ssp_lr_example")
        out = _compare(args, app, ["--model", "sparse"] if args.sharded
                       else ["--model", args.model])
        identical = None
        topo = ("sharded multiproc PS" if args.sharded
                else f"delta relay, {args.model}")
    walls, finals = out["walls"], out["finals"]
    print(json.dumps({
        "metric": "ssp_vs_bsp_wallclock_speedup (transient stalls, "
                  f"{topo}, {args.n} procs, jitter {args.jitter_ms}ms"
                  f"@p={args.jitter_prob})",
        "value": walls["bsp"] / walls["ssp"],
        "unit": "x",
        "bsp_wall_s": walls["bsp"],
        "ssp_wall_s": walls["ssp"],
        "step_ms": out["step_ms"],
        "stall_ms_per_step": args.jitter_ms * args.jitter_prob,
        "bsp_stall_ms_per_step":
            args.jitter_ms * (1.0 - (1.0 - args.jitter_prob) ** args.n),
        "bsp_loss": finals["bsp"],
        "ssp_loss": finals["ssp"],
        "bsp_max_skew": out["skews"]["bsp"],
        "ssp_max_skew": out["skews"]["ssp"],
        "losses_identical": identical,
        "staleness": args.staleness,
        "n_procs": args.n,
        "devices": out["devices"],
    }))
    return 1 if identical is False else 0


if __name__ == "__main__":
    sys.exit(main())
