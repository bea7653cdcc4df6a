"""The port's read-mostly serving plane (``serve/plane.py``,
``serve/admission.py``), held against the JAX package's.

- Every non-slow drill of ``tests/test_serve.py`` runs on the port
  (``port_drills``): the spec, the token bucket, the SLO check, replicas
  promoting, serving within the bound and agreeing, admission shedding
  and backpressure, the partial shed, lease expiry, revocation at the
  rebalance fence, chaos, the armed-idle bitwise pin and the loopback
  self-shed.
- Pure logic through both packages: ``ServeConfig`` parses and refuses
  alike, and ``TokenBucket`` under one injected clock admits and denies
  the same calls.
- Mixed fleets: the deterministic drills leave every shard bit for bit
  as an all-reference fleet does; the free-running ones (replicas
  serving under SSP, lease expiry, revocation racing a migration) hold
  their own asserts on a mixed fleet: the bound, no stale read, and
  replicas agreeing bitwise after finalize.

The slow 3-process pull storm launches the port's
``apps/sharded_ps_bench`` and stays slow.
"""

from __future__ import annotations

import numpy as np
import pytest

from minips_tpu.serve import admission as jadm
from minips_tpu.serve import plane as jplane
from minips_tpu_torch.serve import admission as adm
from minips_tpu_torch.serve import plane
from tests.torch_ref_drills import (assert_mixed_equals_reference, fleet,
                                    parse_alike, port_drills)

globals().update(port_drills("test_serve.py"))

REF = "test_serve.py"


@pytest.mark.parametrize("spec", [
    "", "1", "replicas=2,hot=16,interval=0.5,min_heat=8,lease=3,rate=100,"
    "burst=7,retry_ms=5,decay=0.9,topk=64,slo_p99_ms=25", "interval=0",
    "explode=1", "replicas", "rate=abc", "replicas=0", "burst=0",
    "lease=-1", "rate=-2"])
def test_serve_config_parses_alike(spec):
    parse_alike(plane.ServeConfig.parse, jplane.ServeConfig.parse, spec)


@pytest.mark.parametrize("rate,burst", [(10.0, 5), (0.5, 1), (0.0, 1),
                                        (250.0, 32)])
def test_token_bucket_matches_reference(rate, burst):
    rng = np.random.default_rng(int(rate * 10) + burst)
    now = [0.0]
    bs = [m.TokenBucket(rate, burst, now_fn=lambda: now[0])
          for m in (adm, jadm)]
    for _ in range(400):
        now[0] += float(rng.exponential(0.05))
        n = float(rng.choice([1.0, 1.0, 2.0, 0.5]))
        assert bs[0].take(n) == bs[1].take(n)
    assert bs[0].snapshot() == bs[1].snapshot()
    for bad in ((-1.0, 5), (1.0, 0)):
        for m in (adm, jadm):
            with pytest.raises(ValueError):
                m.TokenBucket(*bad)


BITWISE = ["test_partial_shed_redirects_covered_half_only",
           "test_bsp_lockstep_serving_idle_is_bitwise_equal",
           "test_replica_pull_refused_when_not_held"]


@pytest.mark.parametrize("drill", BITWISE)
def test_mixed_fleet_equals_reference_fleet(drill):
    assert_mixed_equals_reference(REF, drill)


@pytest.mark.parametrize("drill,kinds", [
    ("test_replicas_promote_serve_and_agree", ["port", "ref"]),
    ("test_pull_serving_reads_respect_bound_value_level", ["ref", "port"]),
    ("test_lease_expiry_goes_dark_then_refuses", ["ref", "port"]),
    ("test_lease_expiry_goes_dark_then_refuses", ["port", "ref"]),
    ("test_revocation_rides_the_rebalance_fence", ["ref", "port"]),
])
def test_mixed_fleet_serves_within_the_bound(drill, kinds):
    fleet(REF, kinds)[drill]()
