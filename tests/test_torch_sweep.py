"""``bench_sharded_ps_torch.py``, the port's copy of the sharded-PS sweep
script, against ``bench_sharded_ps.py`` on the CPU.

Two of its cheapest arm functions run in both scripts at ``quick=True``
(each drives three launched processes of its own package) and must
report the same keys with values of the same types; a whole ``--quick``
run must print the reference's top-level keys, stamp torch's device type
as its backend, and pass ``ci/bench_regression.py``'s prior-free
tripwires of the cache, chaos and transport sweeps, imported unchanged.
Both are loaded from their paths: they are root scripts.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_sweep_{name}", os.path.join(REPO, *name.split("/")) + ".py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _schema(x):
    """Keys and value types, recursively (ints and floats are both
    numbers: a rounded rate may land on either)."""
    if isinstance(x, dict):
        return {k: _schema(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_schema(v) for v in x]
    if isinstance(x, bool) or x is None:
        return type(x).__name__
    if isinstance(x, (int, float)):
        return "number"
    return type(x).__name__


def test_the_port_sweep_imports_no_jax():
    """Neither the script nor anything it imports at load time pulls in
    JAX or the JAX package."""
    code = ("import importlib.util, sys; spec = importlib.util."
            "spec_from_file_location('d', 'bench_sharded_ps_torch.py'); "
            "m = importlib.util.module_from_spec(spec); "
            "spec.loader.exec_module(m); "
            "bad = [k for k in sys.modules if k == 'jax' or k.startswith("
            "('jax.', 'minips_tpu.')) or k == 'minips_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]
    port = open(os.path.join(REPO, "bench_sharded_ps_torch.py")).read()
    assert "minips_tpu." not in port.replace("minips_tpu_torch.", "")
    assert "import jax" not in port


@pytest.mark.parametrize("arm", ["hier_arms", "fail_slow_arms"])
def test_arm_reports_the_reference_schema(arm):
    got = getattr(_load("bench_sharded_ps_torch"), arm)(quick=True)
    want = getattr(_load("bench_sharded_ps"), arm)(quick=True)
    assert _schema(got) == _schema(want)
    done = [v for v in got.values()
            if isinstance(v, dict) and "completed" in v]
    assert done and all(v["completed"] for v in done), got


@pytest.mark.slow
def test_quick_sweep_passes_the_prior_free_tripwires():
    """A whole ``--quick`` run: about six minutes on the CPU."""
    proc = subprocess.run(
        [sys.executable, "bench_sharded_ps_torch.py", "--quick"], cwd=REPO,
        capture_output=True, text=True, timeout=1800)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads([ln for ln in proc.stdout.splitlines()
                      if ln.startswith("{")][-1])
    ref_src = open(os.path.join(REPO, "bench_sharded_ps.py")).read()
    keys = ref_src[ref_src.index('"scaling_sparse_zmq": curve'):
                   ref_src.index('"mesh_plane_fused": mesh_grid')]
    for key in [ln.split('"')[1] for ln in keys.splitlines()
                if ln.strip().startswith('"')] + ["mesh_plane_fused"]:
        assert key in out, key
    assert out["jax_backend"] in ("cpu", "cuda")
    assert out["device_shape"] == "cpu:3"
    br = _load("ci/bench_regression")
    for gate in (br.cache_tripwires, br.chaos_tripwires,
                 br.transport_tripwires):
        assert gate(out) == [], gate.__name__
