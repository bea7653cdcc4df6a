"""CPU tests of the benchmark's harness: lookup by name, the contract's
names and limits, the result line, the traffic, the import rule, adding a
cell by files alone, and the faults that ``correct`` has to catch.

Run: ``python -m pytest benchmark/ -q`` (the tiny runs go through
``tinytree.py`` in subprocesses, so that each loads its own copy)."""

from __future__ import annotations

import ast
import hashlib
import json
import os
import re
import subprocess
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)

from benchmark import harness, roofline, spec, tinytree, traffic  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _bench() -> dict:
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def _cells():
    return [w["name"] for w in _bench()["workloads"]]


def _run_tiny(root, workload, *, trace=0, fault=None, seed=2 ** 31 + 11):
    cmd = [sys.executable, os.path.join(HERE, "tinytree.py"), "--root",
           str(root), "--workload", workload, "--trace", str(trace),
           "--seed", str(seed)]
    if fault:
        cmd += ["--fault", fault]
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    return json.loads(p.stdout.strip().splitlines()[-1]), p.stderr


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tinytree.make(str(tmp_path_factory.mktemp("tiny")))


# ---------------------------------------------------------------- lookup
@pytest.mark.parametrize("workload", _cells())
def test_every_piece_is_found_by_name(workload):
    cell = spec.load_cell(REPO, workload)
    assert cell.config["name"] == cell.workload["config"]
    assert hasattr(cell.family(), "Program")
    assert hasattr(cell.reference(), "readings")
    compared = [cell.limits[k] for k in ("loss_gap", "grad_gap", "delta_gap")
                if cell.limits[k]["limit"] is not None]
    assert compared
    for lim in compared:  # set between its two readings
        assert lim["lower"] < lim["limit"] < lim["upper"]
    reported = cell.metrics("end_to_end") + cell.metrics("per_layer")
    assert {m["name"] for m in cell.metrics("end_to_end")} >= {"setup_s"}
    assert len(cell.metrics("end_to_end")) >= 2
    assert cell.metrics("per_layer")
    for m in reported:
        assert callable(spec.metric_reader(m["name"]).read)


def test_metric_modules_declare_what_benchmark_json_says():
    bench = _bench()
    for m in bench["per_layer"]:
        mod = spec.metric_reader(m["name"])
        assert (mod.LAYER, mod.UNIT, mod.MOVES) == (
            m["layer"], m["unit"], m["moves"]), m["name"]
    for m in bench["end_to_end"]:
        assert spec.metric_reader(m["name"]).UNIT == m["unit"]


# -------------------------------------------------------------- contract
def test_names_units_and_sizes_keep_to_the_contract():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 << 10
    names = [c["name"] for c in bench["configs"]] + \
        [w["name"] for w in bench["workloads"]] + \
        [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
        with open(os.path.join(REPO, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    # a full check of 24 cells fits its time
    rs = bench["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


# ----------------------------------------------------------- the result
@pytest.mark.parametrize("workload", ["criteo1tb-lrmlp.zipf-b131072",
                                      "gpt2-xl.t1024-b16"])
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_and_agreement_with_the_reference(tiny, workload, trace):
    result, err = _run_tiny(tiny, workload, trace=trace)
    keys = RESULT_KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(result) == keys
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    cell = spec.load_cell(REPO, workload)
    want = {m["name"] for m in cell.metrics("per_layer" if trace
                                            else "end_to_end")}
    assert set(result["metrics"]) <= want
    if not trace:  # every end-to-end metric is read on any device
        assert set(result["metrics"]) == want
    lines = err.strip().splitlines()[-len(result["checks"]):]
    assert [ln.split(":")[0] for ln in lines] == \
        [f"check {k}" for k in result["checks"]]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
@pytest.mark.parametrize("workload", ["criteo1tb-lrmlp.zipf-b131072",
                                      "gpt2-xl.t1024-b16"])
def test_a_broken_step_is_not_correct(tiny, workload, fault):
    result, _ = _run_tiny(tiny, workload, fault=fault)
    assert result["correct"] is False


def test_refuses_without_the_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, os.path.join(HERE, "run.py"),
                        "--workload", _cells()[0], "--seed", "3",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout


# --------------------------------------------------------------- traffic
@pytest.mark.parametrize("workload", _cells())
def test_traffic_is_a_function_of_the_seed(tiny, workload):
    bench = _bench()
    w = {x["name"]: x for x in bench["workloads"]}[workload]
    cfile = {c["name"]: c["file"] for c in bench["configs"]}[w["config"]]
    with open(os.path.join(tiny, cfile)) as f:
        config = json.load(f)
    with open(os.path.join(tiny, "benchmark", "traffic",
                           f"{w['traffic']}.json")) as f:
        mix = json.load(f)
    seed = 2 ** 31 + 5
    a, b, c = (traffic.make(mix, config, s, "cpu")
               for s in (seed, seed, seed + 1))
    assert len(a) == mix["pool"]
    for x, y, z in zip(a, b, c):
        for k in x:
            assert torch.equal(x[k], y[k])
            assert x[k].shape == z[k].shape
        assert any(not torch.equal(x[k], z[k]) for k in x)


def test_zipf_ranks_stay_in_range_and_favour_the_head():
    n = torch.tensor([3.0, 40e6], dtype=torch.float64)
    u = torch.rand((100000, 2), dtype=torch.float64,
                   generator=torch.Generator().manual_seed(0))
    r = traffic.zipf_ranks(u, n, 1.05)
    assert int(r.min()) == 0
    assert int(r[:, 0].max()) == 2 and int(r[:, 1].max()) < 40e6
    top = (r[:, 1] == 0).double().mean()
    assert 0.02 < float(top) < 0.2  # rank 1 of 40M ids at s = 1.05


# ------------------------------------------------------------ roofline
def test_a_gather_reads_each_distinct_row_once():
    # 1000 keys naming 10 rows of 8 floats: the indices, 10 rows read,
    # 1000 rows written
    assert roofline.gather_bytes(1000, 10, 8) == 4000 + 10 * 32 + 1000 * 32
    assert roofline.gather_bytes(1000, 1000, 8) == 4000 + 2 * 1000 * 32


def test_the_peaks_are_the_cards_and_another_card_is_refused():
    assert roofline.has_peaks(roofline.CARD)
    assert not roofline.has_peaks("cpu")
    with pytest.raises(ValueError):
        roofline.has_peaks("NVIDIA H100 PCIe")
    assert roofline.least_seconds(989e12, 0) == 1.0
    assert roofline.least_seconds(0, 3.35e12) == 1.0


# ---------------------------------------------------------- import rule
def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module.split(".")[0]


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    for dirpath, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                found = set(_imports(os.path.join(dirpath, f)))
                assert not found & harness.FORBIDDEN, (f, found)
    # the references import nothing of the program either
    for f in os.listdir(os.path.join(HERE, "reference")):
        if f.endswith(".py"):
            found = set(_imports(os.path.join(HERE, "reference", f)))
            assert "minips_tpu_torch" not in found, f


def test_the_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "minips_tpu_torch_x", sys)
    assert "minips_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "minips_tpu.sub", sys)
    assert "minips_tpu" in harness.forbidden_modules()


def test_a_run_loads_no_forbidden_module(tiny):
    code = f"""
import runpy, sys
sys.argv = ["tinytree.py", "--root", {str(tiny)!r},
            "--workload", "gpt2-xl.t1024-b16"]
try:
    runpy.run_path({os.path.join(HERE, "tinytree.py")!r}, run_name="__main__")
except SystemExit as e:
    assert not e.code, e.code
print(sorted({{m.split(".")[0] for m in sys.modules}}
             & {{"jax", "jaxlib", "flax", "minips_tpu"}}))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


# ------------------------------------------------------ adding by files
def _digest(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            if "__pycache__" in dirpath:
                continue
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = hashlib.sha256(
                open(p, "rb").read()).hexdigest()
    return out


def test_a_cell_config_mix_and_metric_are_added_as_new_files(tmp_path):
    root = tinytree.make(str(tmp_path))
    before = _digest(os.path.join(root, "benchmark"))
    b = os.path.join(root, "benchmark")
    with open(os.path.join(b, "configs", "criteo1tb-lrmlp.json")) as f:
        config = json.load(f)
    config.update(name="toy-ctr", num_slots=1 << 13)
    with open(os.path.join(b, "configs", "toy-ctr.json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(b, "traffic", "zipf-b131072.json")) as f:
        mix = json.load(f)
    mix.update(batch=256, zipf_exponent=1.2)
    with open(os.path.join(b, "traffic", "zipf12-b256.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(b, "limits",
                           "criteo1tb-lrmlp.zipf-b131072.json")) as f:
        limits = f.read()
    with open(os.path.join(b, "limits", "toy-ctr.zipf12-b256.json"),
              "w") as f:
        f.write(limits)
    with open(os.path.join(b, "metrics", "steps.toy.py"), "w") as f:
        f.write("LAYER = 'step'\nUNIT = 'steps'\nMOVES = 'samples_per_s'\n"
                "def read(record):\n    return float(record.window.steps)\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "toy-ctr", "source": "a test",
                             "file": "benchmark/configs/toy-ctr.json",
                             "reduced": ["num_slots"], "why": "a test"})
    bench["workloads"].append({"name": "toy-ctr.zipf12-b256",
                               "config": "toy-ctr", "traffic": "zipf12-b256",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "steps.toy", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "step", "moves": "samples_per_s",
                               "workloads": ["toy-ctr.zipf12-b256"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    # a reference for the new configuration is its own new file too
    with open(os.path.join(b, "reference", "criteo1tb-lrmlp.py")) as f:
        ref = f.read()
    with open(os.path.join(b, "reference", "toy-ctr.py"), "w") as f:
        f.write(ref)
    after = _digest(b)
    assert all(after[k] == v for k, v in before.items())
    result, _ = _run_tiny(root, "toy-ctr.zipf12-b256", trace=1)
    assert result["correct"] is True, result["checks"]
    assert result["metrics"]["steps.toy"]["value"] == result["attempted"]
