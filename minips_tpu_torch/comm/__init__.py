from minips_tpu_torch.comm.bus import ControlBus  # noqa: F401
from minips_tpu_torch.comm.heartbeat import HeartbeatMonitor  # noqa: F401

# The optional bus layers (comm/chaos.py ChaosBus, comm/reliable.py
# ReliableChannel) are deliberately NOT re-exported here: make_bus
# imports them lazily only when MINIPS_CHAOS / MINIPS_RELIABLE arm
# them, and the plain bus path must not depend on their import.
