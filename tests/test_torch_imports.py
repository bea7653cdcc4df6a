"""The port stands alone: no JAX, no ``minips_tpu``, and the card by default.

Each check runs in a fresh interpreter, since this test process has
imported both packages.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str, cwd: str = REPO) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks behaviour on a machine without CUDA")


def test_port_imports_neither_jax_nor_the_jax_package():
    r = _run(
        "import importlib, pkgutil, sys\n"
        "import minips_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    minips_tpu_torch.__path__, 'minips_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'optax',\n"
        "                                    'minips_tpu'))\n"
        "need = {'minips_tpu_torch.ops.flash_attention',\n"
        "        'minips_tpu_torch.models.transformer',\n"
        "        'minips_tpu_torch.apps.lm',\n"
        "        'minips_tpu_torch.parallel.ring_attention',\n"
        "        'minips_tpu_torch.core.config',\n"
        "        'minips_tpu_torch.core.engine',\n"
        "        'minips_tpu_torch.consistency.controllers',\n"
        "        'minips_tpu_torch.consistency.tracker',\n"
        "        'minips_tpu_torch.obs.hist',\n"
        "        'minips_tpu_torch.utils.timing',\n"
        "        'minips_tpu_torch.utils.metrics',\n"
        "        'minips_tpu_torch.utils.evaluation',\n"
        "        'minips_tpu_torch.train.loop',\n"
        "        'minips_tpu_torch.data.loader',\n"
        "        'minips_tpu_torch.apps.common',\n"
        "        'minips_tpu_torch.apps.wide_deep_example',\n"
        "        'minips_tpu_torch.apps.lr_example',\n"
        "        'minips_tpu_torch.apps.mlp_example',\n"
        "        'minips_tpu_torch.apps.mf_example',\n"
        "        'minips_tpu_torch.apps.word2vec_example',\n"
        "        'minips_tpu_torch.models.mf',\n"
        "        'minips_tpu_torch.models.word2vec',\n"
        "        'minips_tpu_torch.ckpt',\n"
        "        'minips_tpu_torch.ckpt.checkpoint',\n"
        "        'minips_tpu_torch.data.libsvm',\n"
        "        'minips_tpu_torch.data.movielens',\n"
        "        'minips_tpu_torch.data.mnist',\n"
        "        'minips_tpu_torch.data.text',\n"
        "        'minips_tpu_torch.data.criteo',\n"
        "        'minips_tpu_torch.data.native',\n"
        "        'minips_tpu_torch.utils.native_lib',\n"
        "        'minips_tpu_torch.ops.quantized_comm',\n"
        "        'minips_tpu_torch.parallel.mesh',\n"
        "        'minips_tpu_torch.parallel.partition',\n"
        "        'minips_tpu_torch.parallel.moe',\n"
        "        'minips_tpu_torch.models.decode',\n"
        "        'minips_tpu_torch.apps.lm_example',\n"
        "        'minips_tpu_torch.comm',\n"
        "        'minips_tpu_torch.comm.framing',\n"
        "        'minips_tpu_torch.comm.bus',\n"
        "        'minips_tpu_torch.comm.reliable',\n"
        "        'minips_tpu_torch.comm.chaos',\n"
        "        'minips_tpu_torch.comm.heartbeat',\n"
        "        'minips_tpu_torch.comm.native_bus',\n"
        "        'minips_tpu_torch.comm.shm_bus',\n"
        "        'minips_tpu_torch.consistency.gate',\n"
        "        'minips_tpu_torch.obs.tracer',\n"
        "        'minips_tpu_torch.obs.flight',\n"
        "        'minips_tpu_torch.obs.window',\n"
        "        'minips_tpu_torch.obs.slo',\n"
        "        'minips_tpu_torch.obs.slowness',\n"
        "        'minips_tpu_torch.obs.freshness',\n"
        "        'minips_tpu_torch.obs.merge',\n"
        "        'minips_tpu_torch.obs.report'}\n"
        "print(len(names), sorted(need - set(names)), bad)\n")
    assert r.returncode == 0, r.stderr
    count, rest = r.stdout.split(" ", 1)
    assert int(count) >= 75 and rest.strip() == "[] []", r.stdout


def test_importing_the_build_module_runs_nothing():
    # no nvcc, no build directory, no library load at import: the CPU tests
    # import every module on a machine without the CUDA toolkit
    r = _run(
        "import os, subprocess\n"
        "calls = []\n"
        "subprocess.Popen = lambda *a, **k: calls.append(a)\n"
        "from minips_tpu_torch.ops import _build, flash_attention, gather\n"
        "print(calls, _build.load.cache_info().currsize,\n"
        "      flash_attention._lib.cache_info().currsize)\n")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[] 0 0"


@pytest.mark.parametrize("entry", [
    "from minips_tpu_torch.parallel.mesh import resolve_device; "
    "resolve_device(None)",
    "from minips_tpu_torch.tables.sparse import SparseTable; "
    "SparseTable(16, 2)",
    "from minips_tpu_torch.tables.dense import DenseTable; "
    "import torch; DenseTable({'w': torch.zeros(2)})",
    "from minips_tpu_torch.apps.lrmlp import build_lrmlp; build_lrmlp(8)",
    "from minips_tpu_torch.apps.lm import build_lm; build_lm(2, 8, dim=64, "
    "depth=1, vocab=16)",
    "from minips_tpu_torch.core.engine import Engine; "
    "Engine().start_everything()",
    "from minips_tpu_torch.data.loader import prefetch_to_device; "
    "next(prefetch_to_device(iter([{}])))",
    "import sys; sys.argv = ['wd', '--num_iters', '1']; "
    "from minips_tpu_torch.apps.wide_deep_example import main; main()",
    "import sys; sys.argv = ['lr', '--num_iters', '1']; "
    "from minips_tpu_torch.apps.lr_example import main; main()",
    "import sys; sys.argv = ['mlp', '--num_iters', '1']; "
    "from minips_tpu_torch.apps.mlp_example import main; main()",
    "import sys; sys.argv = ['mf', '--num_iters', '1']; "
    "from minips_tpu_torch.apps.mf_example import main; main()",
    "import sys; sys.argv = ['w2v', '--num_iters', '1']; "
    "from minips_tpu_torch.apps.word2vec_example import main; main()",
    "import sys; sys.argv = ['lm', '--num_iters', '1']; "
    "from minips_tpu_torch.apps.lm_example import main; main()",
    "import torch; from minips_tpu_torch.models.transformer import "
    "init_moe_lm; init_moe_lm(torch.Generator())",
])
def test_entry_points_default_to_cuda_and_raise_without_it(entry):
    _no_cuda()
    r = _run(entry)
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr


def test_chip_smoke_fails_without_cuda(tmp_path):
    _no_cuda()
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    # and alone, without the package beside it
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and '"ok"' not in r.stdout
