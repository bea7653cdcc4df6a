"""A tiny copy of the benchmark for the CPU tests: the same files and
cells, the configurations and mixes cut to a size the CPU runs in seconds
(widths and depth cut too: a CPU test checks the harness and the
arithmetic, not the speed).

``python benchmark/tinytree.py --root DIR --workload W [--fault F]`` runs
one cell of the copy at ``DIR`` on the CPU (the program's plain kernel
versions), with a fault of ``faults.py`` planted when asked, and prints
the run's lines as ``run.py`` does.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

TINY_CONFIGS = {
    "criteo1tb-lrmlp": {"num_slots": 1 << 12,
                        "field_ids": [5000, 30, 3, 700] * 6 + [9, 2000]},
    "gpt2-xl": {"n_embd": 128, "n_head": 2, "n_layer": 2, "vocab_size": 256,
                "n_positions": 64, "n_ctx": 64, "head_chunk": 16},
}
TINY_MIXES = {"ctr_zipf": {"batch": 512, "pool": 4, "trace_steps": 2},
              "lm_uniform": {"seq": 64, "trace_steps": 1}}


def _rewrite(path: str, changes: dict) -> None:
    with open(path) as f:
        data = json.load(f)
    data.update(changes)
    with open(path, "w") as f:
        json.dump(data, f, indent=1)


def make(dest: str) -> str:
    """Write the tiny copy under ``dest`` (``BENCHMARK.json`` and
    ``benchmark/``); returns ``dest``."""
    shutil.copytree(HERE, os.path.join(dest, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dest)
    for name, changes in TINY_CONFIGS.items():
        _rewrite(os.path.join(dest, "benchmark", "configs", f"{name}.json"),
                 changes)
    tdir = os.path.join(dest, "benchmark", "traffic")
    for fname in os.listdir(tdir):
        with open(os.path.join(tdir, fname)) as f:
            kind = json.load(f)["kind"]
        _rewrite(os.path.join(tdir, fname), TINY_MIXES[kind])
    return dest


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one tiny cell on the CPU")
    ap.add_argument("--root", required=True)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 11)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    t0 = time.monotonic()
    sys.path[:0] = [args.root, REPO]
    from benchmark import faults, harness

    with (faults.FAULTS[args.fault]() if args.fault
          else contextlib.nullcontext()):
        harness.run(args.workload, args.seed, args.seconds,
                    bool(args.trace), t0=t0, device="cpu", root=args.root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
