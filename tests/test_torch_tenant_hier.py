"""The port's tenancy (``tenant/``), hierarchical push tree
(``balance/hier.py``) and hedged-pull config (``serve/hedge.py``), held
against the JAX package's.

- Every drill of ``tests/test_tenant.py`` and ``tests/test_hier.py``
  runs on the port (``port_drills``): the parsers and their fuzzers, tid
  assignment and bind validation, the tenant stamp poisoning a
  half-armed fleet, heat reports carrying the stamp, per-tenant
  staleness and buckets, the hedge budget per table, the isolation and
  shared-bucket drills, the group and leader rules, the aggregate stamp,
  owner admission at the worst contributor, and the armed-idle bitwise
  drills. The leader-death drill stays slow as the reference marks it.
- Pure logic through both packages: the ``MINIPS_TENANT``,
  ``MINIPS_HIER`` and ``MINIPS_HEDGE`` parsers accept and refuse alike
  on their fuzzers' alphabets; ``host_of``, ``group_ranks`` and
  ``elect`` agree.
- Mixed fleets: the BSP lockstep with tenancy armed but idle, and the
  push tree (exact aggregation, armed idle, accounting only) with leader
  and member in different packages, leave every shard bit for bit as an
  all-reference fleet does.
"""

from __future__ import annotations

import numpy as np
import pytest

from minips_tpu.balance import hier as jhier
from minips_tpu.serve import hedge as jhedge
from minips_tpu.tenant import registry as jreg
from minips_tpu_torch.balance import hier
from minips_tpu_torch.serve import hedge
from minips_tpu_torch.tenant import registry as reg
from tests.torch_ref_drills import (assert_equal_tree, fleet, parse_alike,
                                    port_drills)

TENANT = port_drills("test_tenant.py")
globals().update(TENANT)
globals().update(port_drills("test_hier.py"))


def _fuzz(rng, vocab, vals, n=200, sep=","):
    return ["", "0", "1"] + [
        sep.join(f"{vocab[rng.integers(0, len(vocab))]}"
                 f"={vals[rng.integers(0, len(vals))]}"
                 for _ in range(int(rng.integers(0, 5))))
        for _ in range(n)]


def test_tenant_registry_parses_alike_on_the_fuzzer_alphabet():
    rng = np.random.default_rng(20260807)
    names = ["trn", "inf", "aux", "t_0", "9bad", "x y", "", "on"]
    knobs = ["updater", "wire", "s", "block", "rate", "burst",
             "replicas", "hedge", "zz", ""]
    vals = ["sgd", "adam", "f32", "int8", "1", "0", "2.5", "-1", "abc",
            "inf", "nan", ""]
    sig = TENANT["_sig"]
    for _ in range(250):
        entries = []
        for _e in range(int(rng.integers(0, 4))):
            if rng.random() < 0.2:
                entries.append(f"shared={vals[int(rng.integers(len(vals)))]}")
                continue
            kvs = ",".join(f"{knobs[int(rng.integers(len(knobs)))]}"
                           f"={vals[int(rng.integers(len(vals)))]}"
                           for _k in range(int(rng.integers(0, 3))))
            name = names[int(rng.integers(len(names)))]
            entries.append(name if not kvs else f"{name}:{kvs}")
        spec = ";".join(entries)
        parse_alike(lambda s: sig(reg.maybe_registry(s)),
                    lambda s: sig(jreg.maybe_registry(s)), spec)


def test_hier_and_hedge_parse_alike_on_the_fuzzer_alphabets():
    rng = np.random.default_rng(20260804)
    for spec in _fuzz(rng, ["group", "retain", "agg", "bogus"],
                      ["0", "1", "3", "2.5", "-1", "abc", "", "1e9", "0.5",
                       "local", "mesh"]):
        parse_alike(hier.HierConfig.parse, jhier.HierConfig.parse, spec)
    for spec in _fuzz(rng, ["delay_ms", "factor", "min_ms", "budget",
                            "bogus"],
                      ["0", "1", "3", "2.5", "-1", "abc", "", "1e9",
                       "0.5", "inf"]):
        parse_alike(hedge.HedgeConfig.parse, jhedge.HedgeConfig.parse,
                    spec)


def test_topology_rules_match_reference():
    rng = np.random.default_rng(20)
    for _ in range(300):
        g = int(rng.integers(1, 6))
        n = int(rng.integers(1, 12))
        r = int(rng.integers(0, n))
        assert hier.host_of(r, g) == jhier.host_of(r, g)
        assert hier.group_ranks(r, g, n) == jhier.group_ranks(r, g, n)
        ranks = [int(x) for x in rng.permutation(n)[:g]]
        ex = [int(x) for x in rng.choice(n, size=int(rng.integers(0, 3)))]
        assert hier.elect(ranks, excluded=ex) \
            == jhier.elect(ranks, excluded=ex)


def _weights_alike(run, kinds):
    want = run(fleet, ["ref"])
    got = run(fleet, kinds)
    assert_equal_tree(got, want)


@pytest.mark.parametrize("kinds", [["ref", "port"], ["port", "ref"]])
def test_mixed_fleet_tenant_idle_equals_reference_fleet(kinds):
    def run(mk, ks):
        st: dict = {}
        w, lost = mk("test_chaos_reliable.py", ks)["run_bsp_lockstep"](
            tenant="1", stats=st)
        assert lost == [0, 0] and st["tenant_tids"] == [1, 1]
        return w

    _weights_alike(run, kinds)


@pytest.mark.parametrize("spec", ["group=2", "1", "group=2,agg=0"])
@pytest.mark.parametrize("kinds", [["ref", "port"], ["port", "ref"]])
def test_mixed_fleet_push_tree_equals_reference_fleet(spec, kinds):
    def run(mk, ks):
        st: dict = {}
        w, lost = mk("test_hier.py", ks)["run_hier_lockstep"](spec,
                                                              stats=st)
        assert lost == [0, 0, 0]
        if spec == "group=2":
            assert st["contribs"] > 0 and st["agg_frames"] > 0
        return w

    _weights_alike(run, kinds)
