"""The benchmark of the PyTorch and CUDA port (``minips_tpu_torch``).

Run from the root of a checkout::

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cells, configurations, traffic mixes and metrics are named in
``BENCHMARK.json`` and found by name under ``benchmark/`` (``spec.py``). The
run needs the cell's CUDA devices and exits with a code other than 0,
printing no result, without them. Its last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``).
"""

import time

T0 = time.monotonic()  # set-up counts from here, before any import

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every cache the program or torch keeps, at a fixed path in the checkout
# (the port's own kernel cache is build/minips_tpu_torch/ beside it)
CACHE = os.path.join(ROOT, "build", "benchmark-cache")
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = os.path.join(CACHE, sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import harness

    try:
        harness.run(args.workload, args.seed, args.seconds,
                    bool(args.trace), t0=T0)
    except harness.NoDevice as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    except ImportError as e:
        print(f"no result: {e}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
