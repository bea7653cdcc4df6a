"""The readings that the limits of ``correct`` are set from, on the card at
a cell's own size (or on the CPU at a tiny one, for the tests):

- ``program``: the program's first three steps against the reference,
  the same numbers a run compares, one seed at a time;
- ``control``: the reference computed one precision step down
  (``reference/common.py``) in the program's place, against the reference;
- ``half_batch``, ``state_unchanged``: the program with that fault planted
  (``faults.py``) against the reference.

Usage, from the root of a checkout::

    python3 benchmark/controls.py --workload <cell> --seeds 1,2,3 \\
        --modes program,control,half_batch

One JSON line a seed and mode on standard output. A run of ``run.py``
never runs this.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def readings(cell, seed: int, modes: list[str], device) -> list[dict]:
    """One line for each mode at ``seed``."""
    from benchmark import compare, faults, traffic

    fam, ref = cell.family(), cell.reference()
    out = {}
    for mode in modes:
        if mode == "control":
            continue
        t = time.monotonic()
        fault = faults.FAULTS.get(mode)
        with fault() if fault else contextlib.nullcontext():
            program = fam.Program(cell.config, cell.traffic, seed, device)
            out[mode] = (program.checked_steps(), time.monotonic() - t)
        program.free()
        del program
        _free(device)
    inputs = traffic.make(cell.traffic, cell.config, seed, device)[:3]
    t = time.monotonic()
    f32 = ref.readings(cell.config, inputs, seed, device)
    ref_s = time.monotonic() - t
    _free(device)
    if "control" in modes:
        t = time.monotonic()
        out["control"] = (ref.readings(cell.config, inputs, seed, device,
                                       precision="control"),
                          time.monotonic() - t)
    lines = []
    for mode in modes:
        got, secs = out[mode]
        nums = compare.numbers(got, f32)
        lines.append({"workload": cell.name, "seed": seed, "mode": mode,
                      **nums, "seconds": secs, "reference_s": ref_s,
                      "loss": got["loss"], "ref_loss": f32["loss"]})
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="limit readings of a cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="program,control,half_batch")
    ap.add_argument("--device", default=None,
                    help="default: the card (cuda:0)")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import spec

    device = torch.device(args.device or "cuda:0")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.load_cell(ROOT, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        for line in readings(cell, seed, args.modes.split(","), device):
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
