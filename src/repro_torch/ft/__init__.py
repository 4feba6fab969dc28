"""Fault tolerance: the training loop's checkpoint/restart recovery, the
serving fault injectors, the straggler monitor and the replica heartbeat
(port of ``repro.ft``)."""

from .recovery import FaultInjector, ResilientLoop
from .serving import (CRASH_KIND, FAULT_KINDS, FLEET_FAULT_KINDS,
                      FleetFaultInjector, InjectedCrash, InjectedFault,
                      PageCorruptionError, ServingFaultInjector)
from .straggler import ReplicaHeartbeat, StragglerMonitor

__all__ = ["FaultInjector", "ResilientLoop", "StragglerMonitor", "ReplicaHeartbeat", "ServingFaultInjector",
           "FleetFaultInjector", "InjectedFault", "InjectedCrash",
           "PageCorruptionError", "FAULT_KINDS", "CRASH_KIND",
           "FLEET_FAULT_KINDS"]
