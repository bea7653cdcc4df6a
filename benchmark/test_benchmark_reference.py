"""Tests of the plain references (``benchmark/reference/``): they agree with
the port at tiny sizes on the CPU, and their controls (one precision step
down) do not. The test marked ``cuda`` reads the controls at each cell's
own size on the card and needs it: ``python -m pytest
benchmark/test_benchmark_reference.py -q -m cuda`` there.
"""

from __future__ import annotations

import json
import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)

from benchmark import compare, spec, tinytree, traffic  # noqa: E402

CELLS = ("criteo1tb-lrmlp.zipf-b131072", "gpt2-xl.t1024-b16")
SEEDS = (2 ** 31 + 3, 7, 123456789)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tinytree.make(str(tmp_path_factory.mktemp("tinyref")))


def _tiny_cell(root, workload):
    """The cell as the tiny copy holds it (configuration and mix cut)."""
    cell = spec.load_cell(REPO, workload)
    with open(os.path.join(root, "benchmark", "configs",
                           f"{cell.config['name']}.json")) as f:
        cell.config = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic",
                           f"{cell.workload['traffic']}.json")) as f:
        cell.traffic = json.load(f)
    return cell


def test_the_key_hash_is_the_configurations():
    from minips_tpu_torch.tables.sparse import hash_to_slots

    common = spec.load_module(os.path.join(HERE, "reference", "common.py"),
                              "benchmark_reference_common")
    keys = torch.randint(0, 2 ** 40, (50000,),
                         generator=torch.Generator().manual_seed(0))
    keys[:4] = torch.tensor([0, 1, 2 ** 32 - 1, 2 ** 32 + 5])
    for slots, salt in ((1 << 26, 1), (1 << 26, 2), (1 << 10, 0)):
        assert torch.equal(common.slot_hash(keys, slots, salt),
                           hash_to_slots(keys, slots, salt).long())


def test_the_lm_reference_draws_the_programs_initial_weights(tiny):
    from minips_tpu_torch.apps.lm import build_lm

    cell = _tiny_cell(tiny, "gpt2-xl.t1024-b16")
    c = cell.config
    lm = build_lm(2, c["n_positions"], dim=c["n_embd"], depth=c["n_layer"],
                  vocab=c["vocab_size"], device="cpu", seed=99,
                  head_chunk=c["head_chunk"])
    prog = compare.flat(lm.table.unravel(lm.table.params))
    ref = cell.reference().init(c, 99, "cpu")
    assert set(prog) == set(ref)
    for k in ref:
        assert torch.equal(prog[k].reshape(ref[k].shape), ref[k]), k


@pytest.mark.parametrize("workload", CELLS)
def test_reference_agrees_with_the_port_and_the_control_does_not(tiny,
                                                                  workload):
    cell = _tiny_cell(tiny, workload)
    fam, ref = cell.family(), cell.reference()
    dev = torch.device("cpu")
    worst_prog = {k: 0.0 for k in compare.NUMBERS}
    worst_ctl = dict(worst_prog)
    for seed in SEEDS[:2]:
        program = fam.Program(cell.config, cell.traffic, seed, dev)
        got = program.checked_steps()
        inputs = program.check_inputs()
        program.free()
        f32 = ref.readings(cell.config, inputs, seed, dev)
        ctl = ref.readings(cell.config, inputs, seed, dev,
                           precision="control")
        for k, v in compare.numbers(got, f32).items():
            if k in worst_prog:
                worst_prog[k] = max(worst_prog[k], v)
        for k, v in compare.numbers(ctl, f32).items():
            if k in worst_ctl:
                worst_ctl[k] = max(worst_ctl[k], v)
    # the port's bf16 matmuls against float32: well inside the cell's limits
    for k, v in worst_prog.items():
        if cell.limits[k]["limit"] is not None:
            assert v < cell.limits[k]["limit"], (k, v)
    # one precision step down reads at least three times the port's
    assert any(worst_ctl[k] >= 3 * worst_prog[k] for k in worst_prog), \
        (worst_prog, worst_ctl)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w for w in
                                      spec.load_cell_names(REPO)])
def test_the_control_fails_the_cells_limits_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control runs at the cell's "
                    "own size")
    cell = spec.load_cell(REPO, workload)
    ref = cell.reference()
    dev = torch.device("cuda", 0)
    for seed in SEEDS:
        inputs = traffic.make(cell.traffic, cell.config, seed, dev)[:3]
        f32 = ref.readings(cell.config, inputs, seed, dev)
        ctl = ref.readings(cell.config, inputs, seed, dev,
                           precision="control")
        ok, checks = compare.judge(compare.numbers(ctl, f32), cell.limits)
        assert not ok, (seed, checks)
        del inputs
        torch.cuda.empty_cache()
