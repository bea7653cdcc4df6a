"""The port's open-loop traffic driver (``apps/traffic_driver.py``),
freshness and SLO accounting, held against the JAX package's.

- Every drill of ``tests/test_traffic_obs.py`` runs on the port
  (``port_drills``): the ``MINIPS_TRAFFIC`` and ``MINIPS_SLO`` grammars
  and fuzzers, the rate curve and schedule, dispatch, the
  coordinated-omission unit drill, freshness and SLO trackers, the
  TRAFFIC-IDLE lockstep and the bench worker's storm-off done line (the
  port's ``apps/sharded_ps_bench``); its slow storm drill stays slow.
- Both packages on the same seeded specs: the parser accepts and refuses
  alike, the rate curve is the same function, and the schedules (arrival
  times, user draws, the keys of every request) are the same arrays.
"""

from __future__ import annotations

import numpy as np
import pytest

from minips_tpu.apps import traffic_driver as jtd
from minips_tpu_torch.apps import traffic_driver as td
from tests.torch_ref_drills import parse_alike, port_drills

globals().update(port_drills("test_traffic_obs.py"))

SPECS = ["", "0", "1", "rate=0", "rate=200,users=1000,alpha=1.2,seed=3,"
         "crowd=1+1x4", "rate=500,users=250000,alpha=1.3,batch=16,conc=8,"
         "ramp=2,period=20,crowd=4+2x8,seed=7", "rate=100,ramp=3,period=10",
         "rate=-1", "users=0", "crowd=4", "ramp=0.5", "bogus=1", "rate",
         "alpha=1.0"]


@pytest.mark.parametrize("spec", SPECS)
def test_traffic_config_parses_alike(spec):
    parse_alike(td.TrafficConfig.parse, jtd.TrafficConfig.parse, spec)


@pytest.mark.parametrize("spec,duration", [
    ("rate=200,users=1000,alpha=1.2,seed=3,crowd=1+1x4", 4.0),
    ("rate=300,users=1000000,batch=8,ramp=2,period=3,seed=11", 6.0),
    ("rate=50,users=37,alpha=2.0,batch=3,seed=5", 2.5),
    ("rate=0", 60.0)])
def test_schedules_match_the_jax_driver(spec, duration):
    rows = 4099
    port = td.TrafficDriver(td.TrafficConfig.parse(spec), lambda k: None,
                            rows, duration_s=duration)
    ref = jtd.TrafficDriver(jtd.TrafficConfig.parse(spec), lambda k: None,
                            rows, duration_s=duration)
    np.testing.assert_array_equal(port.arrivals, ref.arrivals)
    np.testing.assert_array_equal(port._users, ref._users)
    for i in range(0, len(port.arrivals), 7):
        np.testing.assert_array_equal(port._keys_for(i), ref._keys_for(i))
    for t in np.linspace(0.0, duration, 41):
        assert port.cfg.rate_at(float(t)) == ref.cfg.rate_at(float(t))
    assert port.record() == ref.record()
